"""End-to-end trainer with checkpoint/restart and elastic re-mesh (port
of ``repro.launch.train``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
      --device cpu
  # kill it, then resume (picks up the latest checkpoint; the data stream
  # is stateless-deterministic, so training continues where it stopped):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
      --resume --device cpu
  # full width on the card (any family: the attention families through
  # the flash-attention backward kernel):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --steps 8 --batch 8 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --steps 8 --batch 8 --seq 2048
  # sharded (ZeRO-1 over data, tensor parallel over model), one process
  # per device: gloo processes on the CPU, one GPU per process on the card
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch stablelm-3b --smoke --steps 4 \
      --batch 4 --seq 32 --mesh 2x2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --steps 3 --batch 8 --seq 2048 --mesh 1x1
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch mixtral-8x7b --smoke --steps 4 \
      --batch 4 --seq 32 --mesh 2x2 --device cpu

Same arguments, defaults and log lines as the reference, plus
``--device`` (default ``cuda``).  Weights are drawn from a
``torch.Generator`` seeded with ``seed`` on the device (other numbers
than the reference's ``PRNGKey(seed)``).  Checkpoints hold ``(params,
opt_state)`` in the reference's tree layout (``convert.model_tree``; the
optimizer's moments likewise) with ``extra = {"data_index", "loss"}``,
so either package resumes from the other's.  The step donates the old
optimizer state, as the reference's jitted step does.

With a mesh (``--mesh dpxtp``: a ``DeviceMesh`` over the default
process group, see ``launch.mesh``) the parameters and AdamW moments are
DTensors in the storage layout (``param_specs(..., "train")``), the step
computes in the ``"compute"`` layout (``train_step``'s ZeRO-1 path), each
batch is laid out by ``input_specs_sharding``, and a resume restores
every leaf into the storage layout of the mesh it resumes on, whatever
mesh wrote it.  Every rank draws the same weights and batches and keeps
its own shards.  Every family runs under a mesh (the MoE layer's
routing and dispatch on each device's own token groups, ``models.moe``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import load_model_tree, model_tree
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import rules
from repro_torch.sharding.api import mesh_context
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import stream
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_init
from repro_torch.train.train_step import (flatten, make_train_step, nest,
                                          optimizer_view)


def _opt_tree(opt: AdamWState) -> AdamWState:
    """The optimizer state in the reference's layout (nested moments)."""
    return AdamWState(step=opt.step, mu=nest(opt.mu), nu=nest(opt.nu))


def _state(params, opt_state: AdamWState):
    """What a checkpoint holds: (params, opt_state) as the reference's
    trees."""
    return model_tree(params), _opt_tree(opt_state)


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: str | None, resume: bool, ckpt_every: int = 20,
          accum: int = 1, mesh=None, log_every: int = 10, seed: int = 0,
          lr: float = 1e-3, *, device="cuda"):
    """Returns (params, opt_state, losses): the trained module, the
    optimizer state in the optimizer's flat layout, one float loss a
    step run."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg, remat=not smoke)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                          total_steps=steps)
    # The old optimizer state is donated, as the reference's jitted step
    # donates it: stablelm-3b's float32 moments are 22.4 GB, and held
    # twice at the step's end they would not fit one 80 GB card beside the
    # weights, their stacked copy and the gradients.
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = model.init(gen)
    shardings = None
    if mesh is not None:
        p_abs = rules.abstract_tree(params)
        storage = rules.named_shardings(
            rules.param_specs(p_abs, mesh, "train"), mesh)
        compute = rules.named_shardings(
            rules.param_specs(p_abs, mesh, "compute"), mesh)
        rules.distribute_module(params, mesh, storage)
        step_fn = make_train_step(model, opt_cfg, accum_steps=accum,
                                  compute_shardings=compute,
                                  storage_shardings=storage, donate=True)
        shardings = (storage, AdamWState(step=None, mu=storage, nu=storage))
    else:
        step_fn = make_train_step(model, opt_cfg, accum_steps=accum,
                                  donate=True)
    opt_state = adamw_init(optimizer_view(params))
    start = 0
    if resume and ckpt_dir and (last := ckpt.latest_step(ckpt_dir)) is not None:
        (tree, opt_tree), meta = ckpt.restore(ckpt_dir, last,
                                              _state(params, opt_state),
                                              shardings=shardings)
        load_model_tree(params, tree)
        opt_state = AdamWState(step=opt_tree.step, mu=flatten(opt_tree.mu),
                               nu=flatten(opt_tree.nu))
        start = meta["extra"]["data_index"]
        print(f"[train] resumed from step {last}")

    losses = []
    data = stream(cfg, batch, seq, seed=seed, start_index=start,
                  device=device)
    t0 = time.time()
    for i in range(start, steps):
        batch_i = next(data)
        if mesh is not None:
            batch_i = rules.distribute_tree(
                batch_i, mesh, rules.input_specs_sharding(batch_i, mesh))
        with mesh_context(mesh):
            params, opt_state, metrics = step_fn(params, opt_state, batch_i)
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % log_every == 0 or i == steps - 1:
            tokens = batch * seq * (i - start + 1)
            print(f"[train] step {i:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"tok/s {tokens / max(time.time() - t0, 1e-6):9.0f}",
                  flush=True)
        if ckpt_dir and ((i + 1) % ckpt_every == 0 or i == steps - 1):
            ckpt.save(ckpt_dir, i + 1, _state(params, opt_state),
                      extra={"data_index": i + 1, "loss": loss})
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="dpxtp, e.g. 2x2: one process per device "
                         "(torchrun); on the CPU gloo processes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    mesh = None
    if args.mesh:
        dp, tp = (int(x) for x in args.mesh.split("x"))
        mesh = make_test_mesh(data=dp, model=tp, device=args.device)
    try:
        train(args.arch, args.smoke, args.steps, args.batch, args.seq,
              args.ckpt_dir, args.resume, ckpt_every=args.ckpt_every,
              accum=args.accum, mesh=mesh, lr=args.lr, device=args.device)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

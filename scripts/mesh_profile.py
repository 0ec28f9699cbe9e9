"""One profiled training step of a model, unsharded and on a 1x1
``DeviceMesh``, on one card: where a mesh step's extra time goes.

Builds the kernels, trains ``--steps`` steps each way (the last one
under ``torch.profiler``) at full width with ``--layers`` layers, and
prints for each: the step's wall time on the host clock around a
synchronised step, the device's busy time (its kernels' summed
durations), the kernel count, the host's aten op count, and the host
functions that take most of the step.  From the repository root, on a
machine with one CUDA card:

    python3 scripts/mesh_profile.py --arch whisper-medium
    python3 scripts/mesh_profile.py --arch mixtral-8x7b --layers 2
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def _step_fn(model, params, mesh):
    from repro_torch.sharding import rules
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    if mesh is None:
        return make_train_step(model, opt, donate=True), None
    p_abs = rules.abstract_tree(params)
    storage = rules.named_shardings(rules.param_specs(p_abs, mesh, "train"),
                                    mesh)
    compute = rules.named_shardings(
        rules.param_specs(p_abs, mesh, "compute"), mesh)
    rules.distribute_module(params, mesh, storage)
    return make_train_step(model, opt, compute_shardings=compute,
                           storage_shardings=storage, donate=True), mesh


def profile(cfg, batch: int, seq: int, steps: int, mesh) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.models import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.api import mesh_context
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import optimizer_view

    model = build_model(cfg, remat=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    step, mesh = _step_fn(model, params, mesh)
    opt = adamw_init(optimizer_view(params))
    wall, prof = [], None
    for i in range(steps):
        data = synthetic_batch(cfg, batch, seq, 0, i, device="cuda")
        if mesh is not None:
            data = rules.distribute_tree(
                data, mesh, rules.input_specs_sharding(data, mesh))
        last = i == steps - 1
        if last:
            prof = torch_profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mesh_context(mesh):
            params, opt, _ = step(params, opt, data)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        if last:
            prof.__exit__(None, None, None)
    busy = kernels = aten = 0
    host = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += ev.time_range.elapsed_us()
            kernels += 1
        else:
            aten += ev.name.startswith("aten::")
            host[ev.name] = host.get(ev.name, 0.0) + ev.self_cpu_time_total
    del params, opt
    torch.cuda.empty_cache()
    top = sorted(host.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall=wall, busy=busy / 1e3, kernels=kernels, aten=aten,
                top=[(name, round(us / 1e3, 2)) for name, us in top])


def main(argv=None) -> int:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_test_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper-medium")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens (default 447 for encdec, else 2048 "
                         "positions)")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_profile: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    seq = args.seq or (447 if cfg.family == "encdec" else
                       2048 - (cfg.n_patches if cfg.family == "vlm" else 0))
    init_distributed("cuda", world_size=1, rank=0, store_path=os.path.join(
        tempfile.mkdtemp(prefix="mesh_profile_"), "store"))
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    try:
        mesh = make_test_mesh(1, 1, device="cuda")
        for name, m in (("unsharded", None), ("1x1 mesh", mesh)):
            r = profile(cfg, args.batch, seq, args.steps, m)
            print(f"[profile] {cfg.name} ({cfg.n_layers} layers) B={args.batch}"
                  f" S={seq} {name}: step ms {[round(t, 2) for t in r['wall']]}"
                  f" (host clock, the last profiled); device busy "
                  f"{r['busy']:.2f} ms in {r['kernels']} kernels; "
                  f"{r['aten']} aten ops on the host; top host self ms "
                  f"{r['top']}; {card}", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

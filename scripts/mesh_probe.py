"""Probe the port under a mesh with no JAX: on gloo ranks on the host
CPU, or on a fake process group.  For checking a model change on
another torch than the tests ran on (DTensor's rules differ between
versions).  From the repository root:

    # a sharded train step against the unsharded one (smoke configs in
    # float32, one gloo process per rank): loss and grad norm within
    # rtol 1e-5, every gradient within 1e-4 of its largest magnitude
    python3 scripts/mesh_probe.py train 2x2 mixtral-8x7b \\
        mixtral-8x7b:n_experts=3 --batch 8 --seq 1024
    # sharded prefill and 3 decode steps against the unsharded ones
    # (logits and every cache leaf within 1e-5)
    python3 scripts/mesh_probe.py serve 2x2 whisper-medium
    # dry-run cells of full configs with fields replaced, on a fake
    # (2, 2, 2) ("pod", "data", "model") mesh
    python3 scripts/mesh_probe.py dry zamba2-7b:n_layers=9 train_4k \\
        --accum 16

An ``ARCH:field=value,...`` replaces config fields.  Prints one
``PROBE`` line per case; exits 1 if a case failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _config(spec: str, smoke: bool):
    from repro_torch.configs import get_config, get_smoke_config

    arch, _, rest = spec.partition(":")
    fields = {}
    for item in filter(None, rest.split(",")):
        key, value = item.split("=")
        fields[key] = int(value) if value.lstrip("-").isdigit() else value
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if smoke:
        fields.setdefault("dtype", "float32")
    return dataclasses.replace(cfg, **fields)


def _cache_leaves(cache):
    for key in sorted(cache):
        if key == "len":
            continue
        value = cache[key]
        for i, t in enumerate(value if isinstance(value, tuple) else (value,)):
            yield f"{key}/{i}", t


def _train(cfg, model, fresh, mesh, batch: int, seq: int, close) -> None:
    from repro_torch.sharding import rules
    from repro_torch.sharding.api import mesh_context
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import (make_train_step,
                                              optimizer_view, sharded_grads,
                                              to_compute, value_and_grad)

    data = synthetic_batch(cfg, batch, seq, 0, 0, device="cpu")
    plain = fresh()
    loss0, _, grads0 = value_and_grad(model, plain, data)
    params = fresh()
    p_abs = rules.abstract_tree(params)
    storage = rules.named_shardings(rules.param_specs(p_abs, mesh, "train"),
                                    mesh)
    compute = rules.named_shardings(
        rules.param_specs(p_abs, mesh, "compute"), mesh)
    rules.distribute_module(params, mesh, storage)
    laid = rules.distribute_tree(data, mesh,
                                 rules.input_specs_sharding(data, mesh))
    with mesh_context(mesh):
        loss1, _, grads1 = sharded_grads(model, params,
                                         to_compute(params, compute), laid,
                                         storage)
    close(loss1, loss0, "loss", 1e-5)
    for key in grads0:
        close(grads1[key], grads0[key], "grad " + key, 1e-4)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    _, _, met0 = make_train_step(model, opt)(
        plain, adamw_init(optimizer_view(plain)), data)
    step = make_train_step(model, opt, compute_shardings=compute,
                           storage_shardings=storage)
    with mesh_context(mesh):
        _, _, met1 = step(params, adamw_init(optimizer_view(params)), laid)
    close(met1["grad_norm"], met0["grad_norm"], "grad norm", 1e-5)


def _serve(cfg, model, fresh, mesh, batch: int, seq: int, close) -> None:
    import numpy as np
    import torch

    from repro_torch.models.model import init_cache
    from repro_torch.sharding import rules
    from repro_torch.sharding.api import mesh_context

    rng = np.random.default_rng(1)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    inputs = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32))}
    if cfg.family == "encdec":
        inputs["frames"] = normal(batch, cfg.enc_seq, cfg.d_model)
    if cfg.family == "vlm":
        inputs["patches"] = normal(batch, cfg.n_patches, cfg.d_model)
    steps = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, 1)).astype(np.int32)) for _ in range(3)]

    def lay(tree):
        return rules.distribute_tree(tree, mesh,
                                     rules.input_specs_sharding(tree, mesh))

    plain = fresh()
    logits0, cache0 = model.prefill(plain, inputs)
    params = fresh()
    rules.distribute_module(params, mesh, rules.param_specs(
        rules.abstract_tree(params), mesh, "serve"))
    with mesh_context(mesh):
        logits1, cache1 = model.prefill(params, lay(inputs))
    close(logits1, logits0, "prefill logits", 1e-5)
    for (name, a), (_, b) in zip(_cache_leaves(cache1),
                                 _cache_leaves(cache0)):
        close(a, b, "prefill " + name, 1e-5)
    # decode from the prefill's caches, grown by 8 positions
    positions = int(cache0["len"])

    def grown(cache, laid: bool):
        out = init_cache(cfg, batch, positions + 8, filled=positions,
                         device="cpu")
        for (_, t), (_, src) in zip(_cache_leaves(out),
                                    _cache_leaves(cache)):
            src = src.full_tensor() if hasattr(src, "full_tensor") else src
            t[tuple(slice(0, n) for n in src.shape)].copy_(src)
        if laid:
            length = out.pop("len")
            out = lay(out)
            out["len"] = length
        return out

    c0, c1 = grown(cache0, False), grown(cache1, True)
    for i, tok in enumerate(steps):
        d0, c0 = model.decode(plain, c0, tok)
        with mesh_context(mesh):
            d1, c1 = model.decode(params, c1, lay({"tokens": tok})["tokens"])
        close(d1, d0, f"decode {i} logits", 1e-5)
    for (name, a), (_, b) in zip(_cache_leaves(c1), _cache_leaves(c0)):
        close(a, b, "cache " + name, 1e-5)


def _rank(args) -> int:
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    from repro_torch.models import build_model

    torch.set_num_threads(1)
    rank, world = int(os.environ["PROBE_RANK"]), int(os.environ["PROBE_WORLD"])
    init_distributed("cpu", world_size=world, rank=rank,
                     store_path=os.environ["PROBE_STORE"])
    dp, tp = (int(x) for x in args.mesh.split("x"))
    mesh = make_test_mesh(dp, tp, device="cpu")
    failed = 0
    for spec in args.cases:
        worst = [0.0, ""]

        def close(got, want, what, rel):
            got = got.full_tensor() if isinstance(got, DTensor) else got
            scale = max(float(want.abs().max()), 1e-30)
            err = float((got.float() - want.float()).abs().max()) / scale
            if err > worst[0]:
                worst[:] = [err, what]
            if err > rel:
                raise AssertionError(f"{what}: {err:.3g} of its largest "
                                     f"magnitude, over {rel}")

        t0 = time.perf_counter()
        try:
            cfg = _config(spec, smoke=True)
            model = build_model(cfg, remat=False)

            def fresh():
                gen = torch.Generator()
                gen.manual_seed(0)
                return model.init(gen)

            run = _train if args.mode == "train" else _serve
            run(cfg, model, fresh, mesh, args.batch, args.seq, close)
            line = (f"ok, worst {worst[0]:.3g} at {worst[1]}, "
                    f"{time.perf_counter() - t0:.1f} s")
        except Exception as e:  # report, go on with the next case
            failed += 1
            line = f"FAIL {type(e).__name__}: {str(e)[:400]}"
            if rank == 0:
                traceback.print_exc(limit=-8)
        if rank == 0:
            print(f"PROBE {args.mode} {spec} on {args.mesh} (B {args.batch}, "
                  f"S {args.seq}): {line}", flush=True)
    return 1 if failed else 0


def _dry(args) -> int:
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_distributed, make_test_mesh

    init_distributed("fake", world_size=8, rank=0)
    mesh = make_test_mesh(2, 2, 2, device="fake")
    out = Path(tempfile.mkdtemp(prefix="mesh_probe_"))
    failed = 0
    for spec, shape in zip(args.cases[::2], args.cases[1::2]):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(_config(spec, smoke=False), SHAPES[shape], mesh,
                              "p2x2x2", out, accum=args.accum)
        wall = time.perf_counter() - t0
        if rec["ok"]:
            line = (f"ok in {wall:.1f} s (accum {rec['accum']}, "
                    f"{rec['n_ops']} ops), peak "
                    f"{rec['memory']['peak_bytes_per_device'] / 2 ** 30:.2f}"
                    f" GiB")
        else:
            failed += 1
            line = f"FAIL {rec['error'][:400]}\n{rec['traceback']}"
        print(f"PROBE dry {spec} {shape}: {line}", flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("train", "serve", "dry"))
    ap.add_argument("mesh", help="dpxtp of the gloo mesh (train, serve); "
                                 "dry: the first case")
    ap.add_argument("cases", nargs="+",
                    help="ARCH[:field=value,...] (dry: each followed by a "
                         "shape name)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--accum", type=int, default=None)
    args = ap.parse_args(argv)
    if args.mode == "dry":
        args.cases = [args.mesh] + args.cases
        return _dry(args)
    if "PROBE_RANK" in os.environ:
        return _rank(args)
    dp, tp = (int(x) for x in args.mesh.split("x"))
    store = os.path.join(tempfile.mkdtemp(prefix="mesh_probe_"), "store")
    procs = [subprocess.Popen(
        [sys.executable, __file__] + argv,
        env=dict(os.environ, PROBE_RANK=str(r), PROBE_WORLD=str(dp * tp),
                 PROBE_STORE=store, OMP_NUM_THREADS="1"))
        for r in range(dp * tp)]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())

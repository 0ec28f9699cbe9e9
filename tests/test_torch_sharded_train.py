"""Sharded training on a ``DeviceMesh`` against unsharded training and the
JAX reference, in gloo processes on the CPU.

``run_ranks`` starts one Python process per rank; each starts its gloo
group from one ``FileStore`` (``launch.mesh.init_distributed``), so no
network is touched.  The tests:

  * one train step of the smoke configs of every family in float32 on
    a 2x2 mesh (ZeRO-1 storage over data, tensor parallel over
    model: ``train_step``'s sharded path), from the reference's init
    weights (``convert.model_params_from_numpy``), against the port's
    unsharded step and the reference's jitted step (``CASES``: the MoE
    layer with its experts on the model axis, llama4-scout, and with
    their FFN dim there, mixtral with 3 experts): the loss and the
    gradient norm within rtol 1e-5, every gradient leaf (the storage
    layout's, gathered) within 1e-4 of its largest magnitude (the
    ``ROADMAP.md`` standard), and every updated weight within that plus
    a tenth of the learning rate (Adam's first step moves each weight by
    about the learning rate whatever its gradient's size, so a gradient
    near zero that rounds differently moves it by another fraction).

``run_ranks`` and ``PRELUDE`` are shared with ``test_torch_elastic.py``
and ``test_torch_compression.py``.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.train.data import synthetic_batch as j_batch
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.train_step import make_train_step as j_make_train_step

SRC = str(Path(__file__).resolve().parent.parent / "src")
REL = 1e-4


def run_ranks(code: str, world: int, timeout: float = 240) -> list:
    """Run :data:`PRELUDE` and then ``code`` in ``world`` processes, each
    its own rank of one gloo group (``RANK`` and ``WORLD`` set).  Returns
    their stdouts; a failed rank fails the test with its stderr."""
    code = PRELUDE + textwrap.dedent(code)
    store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_ranks_"),
                         "store")
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=SRC, RANK_ID=str(r),
                   WORLD=str(world), STORE=store, OMP_NUM_THREADS="1")
        env.pop("RANK", None)
        env.pop("WORLD_SIZE", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, err[-4000:]
    return [out for _, out, _ in outs]


PRELUDE = """
import os, dataclasses, numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_distributed, make_test_mesh
RANK, WORLD = int(os.environ["RANK_ID"]), int(os.environ["WORLD"])
init_distributed("cpu", world_size=WORLD, rank=RANK,
                 store_path=os.environ["STORE"])
"""


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _close(got, want, what, atol=0.0):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale + atol, (what, err, scale)


OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
B, S = 4, 32


# case -> (config, fields replaced in both packages' smoke config).  The
# smoke configs' 4 experts divide the 2-way model axis (expert parallel,
# llama4-scout's layout); 3 experts do not, so mixtral's experts take
# the FFN dim on the model axis, as its 8 experts do on the 16-way axis.
CASES = {"stablelm-3b": ("stablelm-3b", {}),
         "mamba2-370m": ("mamba2-370m", {}),
         "zamba2-7b": ("zamba2-7b", {}),
         "whisper-medium": ("whisper-medium", {}),
         "llava-next-mistral-7b": ("llava-next-mistral-7b", {}),
         "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {}),
         "mixtral-8x7b-3-experts": ("mixtral-8x7b", {"n_experts": 3})}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_unsharded_and_reference(case, tmp_path):
    arch, fields = CASES[case]
    jc = dataclasses.replace(j_smoke(arch), dtype="float32", **fields)
    jm = j_build(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    np.savez(tmp_path / "params.npz", **_flat(jax.tree.map(np.asarray, jp)))
    jb = j_batch(jc, B, S, 0, 0)
    jstep = jax.jit(j_make_train_step(jm, JAdamWConfig(**OPT)))
    jnew, _, jmet = jstep(jp, j_adamw_init(jp), jb)
    want = _flat(jax.tree.map(np.asarray, jnew))
    jgrads = _flat(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jm.loss(p, jb)[0]))(jp)))

    run_ranks(f"""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.api import mesh_context
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import (make_train_step,
                                              optimizer_view, sharded_grads,
                                              to_compute, value_and_grad)
    cfg = dataclasses.replace(get_smoke_config("{arch}"), dtype="float32",
                              **{fields!r})
    model = build_model(cfg, remat=False)
    flat = dict(np.load("{tmp_path}/params.npz"))
    tree = {{}}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {{}})
        node[last] = v
    batch = synthetic_batch(cfg, {B}, {S}, 0, 0, device="cpu")
    opt = AdamWConfig(**{OPT!r})

    def full(tree):
        return {{k: (v.full_tensor() if hasattr(v, "full_tensor") else v
                    ).numpy() for k, v in tree.items()}}

    def save(name, params, met, grads):
        out = full(optimizer_view(params))
        out.update({{"grad/" + k: v for k, v in full(grads).items()}})
        out["__loss"] = np.asarray(float(met["loss"]))
        out["__gnorm"] = np.asarray(float(met["grad_norm"]))
        if RANK == 0:
            np.savez("{tmp_path}/" + name + ".npz", **out)

    plain = model_params_from_numpy(cfg, tree, device="cpu")
    _, _, grads = value_and_grad(model, plain, batch)
    step = make_train_step(model, opt)
    p, _, met = step(plain, adamw_init(optimizer_view(plain)), batch)
    save("unsharded", p, met, grads)

    mesh = make_test_mesh(2, 2, device="cpu")
    params = model_params_from_numpy(cfg, tree, device="cpu")
    p_abs = rules.abstract_tree(params)
    storage = rules.named_shardings(
        rules.param_specs(p_abs, mesh, "train"), mesh)
    compute = rules.named_shardings(
        rules.param_specs(p_abs, mesh, "compute"), mesh)
    rules.distribute_module(params, mesh, storage)
    step = make_train_step(model, opt, compute_shardings=compute,
                           storage_shardings=storage)
    b = rules.distribute_tree(batch, mesh,
                              rules.input_specs_sharding(batch, mesh))
    with mesh_context(mesh):
        _, _, grads = sharded_grads(model, params,
                                    to_compute(params, compute), b, storage)
        p, o, met = step(params, adamw_init(optimizer_view(params)), b)
    assert all(hasattr(t, "placements") for t in o.mu.values())
    save("sharded", p, met, grads)
    """, world=4)
    unsharded = dict(np.load(tmp_path / "unsharded.npz"))
    sharded = dict(np.load(tmp_path / "sharded.npz"))
    assert set(want) == {k for k in sharded
                         if not k.startswith(("__", "grad/"))}
    assert set(jgrads) == {k[5:] for k in sharded if k.startswith("grad/")}
    for k, w in jgrads.items():
        _close(sharded["grad/" + k], w, k)
        _close(sharded["grad/" + k], unsharded["grad/" + k], k)
    for name in ("__loss", "__gnorm"):
        ref = float(jmet["loss" if name == "__loss" else "grad_norm"])
        np.testing.assert_allclose(sharded[name], ref, rtol=1e-5)
        np.testing.assert_allclose(sharded[name], unsharded[name], rtol=1e-5)
    for k, w in want.items():
        _close(sharded[k], w, k, OPT["lr"] / 10)
        _close(sharded[k], unsharded[k], k, OPT["lr"] / 10)

"""Prefill and decode on a ``DeviceMesh`` against the JAX reference and
the unsharded model, in gloo processes
(``test_torch_sharded_train.run_ranks``).

The smoke configs in float32, from the reference's init weights
(``convert.model_params_from_numpy``): parameters in the ``"serve"``
layout, the batch and the decode cache laid out by
``input_specs_sharding``.  stablelm-3b, mamba2-370m, mixtral-8x7b (the
MoE layer's einsum dispatch, its 4 experts on the model axis),
zamba2-7b, whisper-medium and llava-next-mistral-7b on 2x2 (heads split
on the model axis, batch on data; whisper and llava at model level, with
their frames or patches); chatglm3-6b on 1x4, whose 2 kv heads do not
divide the model axis, so its cache is split along the sequence there
and each decode step's K/V is written by the one device holding that
position.  Inputs are made with numpy: the prompt (and whisper's frames
or llava's patches), a cache of 24 positions filled to 16 with normal
values, 3 decode tokens.  One more mixtral case prefills 4 x 2048
tokens, two MoE groups split on the data axis.

Held, for the prefill's last logits and every cache leaf, then 3 decode
steps' logits and the cache after them:

  * against the reference's jitted ``prefill`` and ``decode`` on the
    same inputs: within 1e-4 of each tensor's largest magnitude (the
    ``ROADMAP.md`` standard);
  * against the port's unsharded path: within 1e-5 of it (sums in other
    orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.models import init_cache as j_init_cache
from test_torch_sharded_train import _close, _flat, run_ranks

B, S, S_MAX, FILLED, STEPS = 4, 16, 24, 16, 3


def _leaves(cache):
    """Cache leaf name -> array (a tuple's items as ``name/i``)."""
    out = {}
    for k in sorted(cache):
        if k == "len":
            continue
        v = cache[k]
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            out[f"{k}/{i}"] = np.asarray(t)
    return out


def _reference(arch, tmp, prompt=S):
    """The reference's outputs on inputs made here (a prompt of
    ``prompt`` tokens), both saved."""
    jc = dataclasses.replace(j_smoke(arch), dtype="float32")
    jm = j_build(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    np.savez(tmp / "params.npz", **_flat(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab_size, (B, prompt)).astype(np.int32)
    steps = rng.integers(0, jc.vocab_size, (STEPS, B, 1)).astype(np.int32)
    extra = {}
    if jc.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (B, jc.enc_seq, jc.d_model)).astype(np.float32)
    if jc.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, jc.n_patches, jc.d_model)).astype(np.float32)
    cache = j_init_cache(jc, B, S_MAX, filled=FILLED)
    filled = {k: (rng.standard_normal(v.shape).astype(v.dtype)
                  if np.issubdtype(v.dtype, np.floating) else v)
              for k, v in _leaves(cache).items()}
    np.savez(tmp / "inputs.npz", tokens=tokens, steps=steps,
             **{"batch/" + k: v for k, v in extra.items()},
             **{"cache/" + k: v for k, v in filled.items()})

    def as_cache(leaves):
        out = {"len": jnp.asarray(FILLED, jnp.int32)}
        for k in cache:
            if k == "len":
                continue
            v = cache[k]
            n = len(v) if isinstance(v, tuple) else 0
            out[k] = (tuple(jnp.asarray(leaves[f"{k}/{i}"]) for i in range(n))
                      if n else jnp.asarray(leaves[f"{k}/0"]))
        return out

    want = {}
    logits, pcache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(tokens),
             **{k: jnp.asarray(v) for k, v in extra.items()}})
    want["prefill logits"] = np.asarray(logits)
    want.update({"prefill " + k: v for k, v in _leaves(pcache).items()})
    decode = jax.jit(jm.decode)
    c = as_cache(filled)
    for i in range(STEPS):
        logits, c = decode(jp, c, jnp.asarray(steps[i]))
        want[f"decode {i} logits"] = np.asarray(logits)
    want.update({"cache " + k: v for k, v in _leaves(c).items()})
    return want


@pytest.mark.parametrize("arch,mesh", [("stablelm-3b", (2, 2)),
                                       ("chatglm3-6b", (1, 4)),
                                       ("mamba2-370m", (2, 2)),
                                       ("mixtral-8x7b", (2, 2)),
                                       ("zamba2-7b", (2, 2)),
                                       ("whisper-medium", (2, 2)),
                                       ("llava-next-mistral-7b", (2, 2))])
def test_prefill_and_decode_on_a_mesh(arch, mesh, tmp_path):
    _check_on_mesh(arch, mesh, tmp_path, _reference(arch, tmp_path))


def test_moe_groups_split_on_data(tmp_path):
    """mixtral's prefill of 4 x 2048 tokens makes two groups of 4096,
    split on the data axis: the experts' weights, whose FFN dim the
    serving layout spreads over data, are gathered there for the
    products (``moe._experts``)."""
    _check_on_mesh("mixtral-8x7b", (2, 2), tmp_path,
                   _reference("mixtral-8x7b", tmp_path, prompt=2048))


def _check_on_mesh(arch, mesh, tmp_path, want):
    """The port's prefill and decode of ``arch`` on ``mesh`` against
    ``want`` and against its unsharded path, on the inputs saved by
    ``_reference``."""
    run_ranks(f"""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.models.model import init_cache
    from repro_torch.sharding import rules
    from repro_torch.sharding.api import mesh_context
    cfg = dataclasses.replace(get_smoke_config("{arch}"), dtype="float32")
    model = build_model(cfg, remat=False)
    flat = dict(np.load("{tmp_path}/params.npz"))
    tree = {{}}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {{}})
        node[last] = v
    inputs = dict(np.load("{tmp_path}/inputs.npz"))

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def close(got, want, what):
        got, want = full(got), full(want)
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max())
        assert err <= 1e-5 * scale, (what, err, scale)

    def leaves(cache):
        for k in sorted(cache):
            if k == "len":
                continue
            v = cache[k]
            for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                yield f"{{k}}/{{i}}", t

    def filled_cache():
        cache = init_cache(cfg, {B}, {S_MAX}, filled={FILLED}, device="cpu")
        for name, t in leaves(cache):
            t.copy_(torch.from_numpy(inputs["cache/" + name]))
        return cache

    batch = {{"tokens": torch.from_numpy(inputs["tokens"]),
             **{{k[6:]: torch.from_numpy(v) for k, v in inputs.items()
                if k.startswith("batch/")}}}}
    tokens = [torch.from_numpy(t) for t in inputs["steps"]]

    plain = model_params_from_numpy(cfg, tree, device="cpu")
    logits0, pcache0 = model.prefill(plain, batch)
    c0 = filled_cache()
    steps0 = []
    for tok in tokens:
        lg, c0 = model.decode(plain, c0, tok)
        steps0.append(lg)

    mesh = make_test_mesh(*{mesh!r}, device="cpu")
    params = model_params_from_numpy(cfg, tree, device="cpu")
    rules.distribute_module(params, mesh, rules.param_specs(
        rules.abstract_tree(params), mesh, "serve"))
    lay = lambda tree: rules.distribute_tree(
        tree, mesh, rules.input_specs_sharding(tree, mesh))
    got = {{}}
    with mesh_context(mesh):
        logits1, pcache1 = model.prefill(params, lay(batch))
        close(logits1, logits0, "prefill logits")
        got["prefill logits"] = full(logits1)
        for (name, a), (_, b) in zip(leaves(pcache1), leaves(pcache0)):
            close(a, b, "prefill " + name)
            got["prefill " + name] = full(a)
        c1 = filled_cache()
        length = c1.pop("len")
        c1 = lay(c1)
        c1["len"] = length
        for i, tok in enumerate(tokens):
            lg, c1 = model.decode(params, c1, lay({{"tokens": tok}})["tokens"])
            close(lg, steps0[i], f"decode {{i}} logits")
            got[f"decode {{i}} logits"] = full(lg)
    for (name, a), (_, b) in zip(leaves(c1), leaves(c0)):
        close(a, b, "cache " + name)
        got["cache " + name] = full(a)
    if RANK == 0:
        np.savez("{tmp_path}/sharded.npz",
                 **{{k: v.numpy() for k, v in got.items()}})
    """, world=mesh[0] * mesh[1])
    got = dict(np.load(tmp_path / "sharded.npz"))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
        _close(got[k], w, k)

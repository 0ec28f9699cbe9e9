"""The flash-attention backward's plain versions and its autograd wiring
against the JAX reference.

The same numpy inputs go to the port's ``attention_lse_ref`` and
``attention_bwd_ref`` and to ``jax.vjp`` of the JAX oracle
``repro.kernels.flash_attention.ref.attention_ref`` (its log-sum-exp
against ``jax.nn.logsumexp`` of the oracle's masked, scaled scores), over
causal, unmasked and window masks, G in {1, 4}, every head dim of
``HEAD_DIMS``, Sq != Sk and ragged lengths.  Tolerances: float32 within
1e-5 of each gradient's largest magnitude (sums in other orders);
bfloat16 inputs within 2e-2 of max(1, largest) (one bf16 rounding of the
outputs, and of o where D = rowsum(dO o) reads it).

``ops.FlashAttention`` then runs on the CPU with its two launchers
replaced by the plain versions, so everything but the CUDA code runs: the
saved tensors, the (B, S, H, hd) views, the GQA sums and the cross
attention's Sq != Sk.  It is held against ``jax.vjp`` of the oracle, and
through the dense and encdec smoke models' ``loss`` (every layer's
attention taken through the Function) against the jitted reference's
``jax.value_and_grad(loss)``, within 1e-4 of each leaf's largest, as
``tests/test_torch_loss.py`` holds the plain path.  The dispatch of
``ops.flash_attention`` uses CPU tensors that report themselves as CUDA
ones, and the backward's launcher runs with its library faked.  The
kernels themselves run only on the card, where ``chip_smoke.py`` phase x
holds them against the same plain versions.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models import build_model as j_build
from repro.train.data import synthetic_batch as j_batch
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 attention_bwd_ref,
                                                 attention_lse_ref,
                                                 flash_attention)
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.train.data import synthetic_batch
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(1)

# The package exports the adapter function under the module's own name.
fa_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

CASES = [
    # B, H, KV, Sq, Sk, hd, causal, window
    (1, 4, 4, 64, 64, 64, True, 0),       # G = 1, causal
    (2, 4, 1, 48, 48, 32, True, 0),       # G = 4
    (1, 4, 4, 37, 150, 64, False, 0),     # cross attention: unmasked, Sq < Sk
    (1, 8, 2, 37, 150, 80, True, 0),      # causal at Sq != Sk, G = 4
    (1, 4, 1, 100, 100, 112, True, 24),   # sliding window, ragged
    (1, 2, 2, 71, 71, 128, False, 0),     # unmasked, ragged
    (2, 4, 1, 33, 33, 80, False, 16),     # a window without the causal mask
    (1, 4, 4, 150, 37, 64, True, 0),      # more queries than keys
]
IDS = [f"B{c[0]}H{c[1]}KV{c[2]}Sq{c[3]}Sk{c[4]}hd{c[5]}"
       f"{'c' if c[6] else 'u'}w{c[7]}" for c in CASES]
# dtype -> (torch, jax, tolerance, floor of the scale it multiplies)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5, 0.0),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 1.0)}
GRAD_REL = 1e-4


def test_cases_cover_every_head_dim():
    assert {c[5] for c in CASES} == set(HEAD_DIMS)


def _inputs(case, seed):
    """q, o-shaped dO (B, H, Sq, hd) and k, v (B, KV, Sk, hd), float32."""
    B, H, KV, Sq, Sk, hd = case[:6]
    rng = np.random.default_rng(seed)
    shapes = [(B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd),
              (B, H, Sq, hd)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_vjp(qkv, do, causal, window, jdt):
    q, k, v = (jnp.asarray(x).astype(jdt) for x in qkv)
    o, vjp = jax.vjp(lambda a, b, c: j_ref(a, b, c, causal=causal,
                                           window=window), q, k, v)
    grads = vjp(jnp.asarray(do).astype(jdt))
    return np.asarray(o.astype(jnp.float32)), [
        np.asarray(g.astype(jnp.float32)) for g in grads]


def _jax_lse(q, k, causal, window):
    """jax.nn.logsumexp of the oracle's masked, scaled scores."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(B, KV, H // KV, Sq, hd) * (hd ** -0.5)
    s = jnp.einsum("bkgqd,bksd->bkgqs", qg, jnp.asarray(k))
    pos_q, pos_k = jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    m = jnp.ones((Sq, Sk), bool)
    if causal:
        m &= pos_k <= pos_q
    if window > 0:
        m &= pos_k > pos_q - window
    s = jnp.where(m, s, -1e30)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, Sq)


def _close(name, got, want, rel, floor=0.0):
    scale = max(floor, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: {err} vs {rel} x {scale}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case, dtype):
    tdt, jdt, tol, floor = DTYPES[dtype]
    causal, window = case[6], case[7]
    q, k, v, do = _inputs(case, seed=sum(case[:6]))
    want_o, want = _jax_vjp((q, k, v), do, causal, window, jdt)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    o, lse = attention_lse_ref(tq, tk, tv, causal=causal, window=window)
    assert o.dtype == tdt and lse.dtype == torch.float32
    _close("o", o.float().numpy(), want_o, tol, floor)
    got = attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                            window=window)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
        _close(name, g.float().numpy(), w, tol, floor)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_matches_jax_logsumexp(case):
    causal, window = case[6], case[7]
    q, k, v, _ = _inputs(case, seed=7)
    _, lse = attention_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=causal, window=window)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal, window),
                               rtol=1e-5, atol=1e-5)


def test_lse_of_a_row_without_keys_is_inf():
    """Causal with a window at Sq > Sk: rows past Sk - 1 + window see no
    key.  The kernel writes +inf there, so exp(s - lse) is 0."""
    q, k, v, _ = _inputs((1, 2, 2, 12, 4, 32), seed=3)
    _, lse = attention_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=True, window=3)
    assert torch.isinf(lse[..., 6:]).all() and torch.isfinite(
        lse[..., :6]).all()


# ---------------------------------------------------------------------------
# FlashAttention on the CPU, its launchers replaced by the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def plain_launchers(monkeypatch):
    """``ops``' two launchers as the plain versions, writing into the
    buffers the Function hands them; returns the call counts."""
    calls = {"fwd": 0, "fwd_lse": 0, "bwd": 0}

    def fwd(q, k, v, *, causal=True, window=0, out=None, lse=None):
        o, l = attention_lse_ref(q, k, v, causal=causal, window=window)
        out.copy_(o)
        calls["fwd"] += 1
        if lse is not None:
            lse.copy_(l)
            calls["fwd_lse"] += 1
        return out

    def bwd(q, k, v, o, lse, do, *, causal=True, window=0, dq=None,
            dk=None, dv=None):
        for buf, g in zip((dq, dk, dv), attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal, window=window)):
            buf.copy_(g)
        calls["bwd"] += 1
        return dq, dk, dv

    monkeypatch.setattr(ops, "flash_attention_bhsd", fwd)
    monkeypatch.setattr(ops, "flash_attention_bhsd_bwd", bwd)
    return calls


def _model_views(case, seed):
    """q (B, Sq, H, hd), k and v (B, Sk, KV, hd) as the model passes them:
    views of one fused projection where Sq == Sk, else q apart; the
    leaves whose .grad holds the gradients; dO (B, Sq, H, hd)."""
    B, H, KV, Sq, Sk, hd = case[:6]
    q, k, v, do = _inputs(case, seed)
    bshd = [np.ascontiguousarray(x.transpose(0, 2, 1, 3))
            for x in (q, k, v, do)]
    if Sq == Sk:
        fused = torch.from_numpy(np.concatenate(bshd[:3], axis=2))
        fused.requires_grad_()
        views = (fused[:, :, :H], fused[:, :, H:H + KV],
                 fused[:, :, H + KV:])
        leaves = [fused]
    else:
        leaves = [torch.from_numpy(x).requires_grad_() for x in bshd[:3]]
        views = tuple(leaves)
    return (q, k, v, do), views, leaves, torch.from_numpy(bshd[3])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_function_matches_jax_vjp(plain_launchers, case):
    causal, window = case[6], case[7]
    H, KV = case[1], case[2]
    (q, k, v, do), views, leaves, tdo = _model_views(case, seed=11)
    out = FlashAttention.apply(*views, causal, window)[0]
    assert out.shape == views[0].shape and out.requires_grad
    out.backward(tdo)
    assert plain_launchers == {"fwd": 1, "fwd_lse": 1, "bwd": 1}
    want_o, want = _jax_vjp((q, k, v), do, causal, window, jnp.float32)
    _close("o", out.detach().transpose(1, 2).numpy(), want_o, 1e-5)
    if len(leaves) == 1:
        g = leaves[0].grad
        got = (g[:, :, :H], g[:, :, H:H + KV], g[:, :, H + KV:])
    else:
        got = tuple(t.grad for t in leaves)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(name, g.transpose(1, 2).numpy(), w, 1e-5)


def _loss_both(arch, remat, monkeypatch):
    """The reference's and the port's loss and gradients on the same
    weights and batch, the port's attention through FlashAttention."""
    jc = dataclasses.replace(j_smoke(arch), dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jm, tm = j_build(jc, remat=remat), build_model(tc, remat=remat)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = model_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    jb = j_batch(jc, 2, 24, 0, 0)
    tb = synthetic_batch(tc, 2, 24, 0, 0, device="cpu")

    def through_function(q, k, v, *, causal=True, window=0, q_offset=0,
                         **_):
        assert q_offset == 0
        return FlashAttention.apply(q, k, v, causal, window)[0]

    monkeypatch.setattr(L, "chunked_attention", through_function)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    loss, _, grads = value_and_grad(tm, tp, tb)
    return (jl, jg), (loss, grads), tc


@pytest.mark.parametrize("arch,remat", [("stablelm-3b", False),
                                        ("stablelm-3b", True),
                                        ("whisper-medium", False)])
def test_loss_through_function_matches_reference(plain_launchers, arch,
                                                 remat, monkeypatch):
    """Every attention call of the dense and encdec smoke models through
    the Function: the loss and every gradient leaf against the jitted
    reference; one backward launch a call, and with remat two forwards."""
    (jl, jg), (loss, grads), cfg = _loss_both(arch, remat, monkeypatch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    leaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(leaves) == len(grads)
    for path, leaf in leaves:
        key = "/".join(p.key for p in path)
        want = np.asarray(leaf)
        got = grads[key].numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= GRAD_REL * scale, key
    # per layer: self attention; encdec: encoder self, decoder self, cross
    calls = cfg.n_layers * (3 if cfg.family == "encdec" else 1)
    assert plain_launchers["bwd"] == calls
    assert plain_launchers["fwd_lse"] == (2 if remat else 1) * calls


# ---------------------------------------------------------------------------
# the card's dispatch, without a card
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


def _card(shape, grad=False):
    t = torch.randn(shape).as_subclass(_OnCard)
    return t.requires_grad_() if grad else t


def test_card_under_grad_takes_the_function(monkeypatch):
    seen = []

    def apply(*args):
        seen.append(args)
        return "out", "lse"

    monkeypatch.setattr(ops.FlashAttention, "apply", apply)
    q, k = _card((1, 8, 4, 32), grad=True), _card((1, 8, 2, 32))
    assert flash_attention(q, k, k, causal=False, window=5) == "out"
    assert len(seen) == 1 and seen[0][0] is q and seen[0][3:] == (False, 5)
    # any one input requiring grad is enough
    assert flash_attention(k, q, k) == "out" and len(seen) == 2


@pytest.mark.parametrize("how", ["no_grad", "no_input_requires_grad"])
def test_card_without_grad_calls_the_forward_alone(monkeypatch, how):
    seen = []

    def fwd(q, k, v, *, causal=True, window=0, out=None, lse=None):
        seen.append((lse, causal, window))
        return out

    def apply(*args):
        raise AssertionError("the Function is for calls under grad")

    monkeypatch.setattr(ops, "flash_attention_bhsd", fwd)
    monkeypatch.setattr(ops.FlashAttention, "apply", apply)
    q = _card((1, 8, 4, 32), grad=how == "no_grad")
    if how == "no_grad":
        with torch.no_grad():
            out = flash_attention(q, q, q, window=3)
    else:
        out = flash_attention(q, q, q, window=3)
    assert out.shape == q.shape and seen == [(None, True, 3)]


def test_cpu_takes_attention_ref_under_autograd(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU tensor launched a kernel")

    monkeypatch.setattr(ops, "flash_attention_bhsd", no_kernel)
    monkeypatch.setattr(ops, "flash_attention_bhsd_bwd", no_kernel)
    monkeypatch.setattr(ops.FlashAttention, "apply", no_kernel)
    q = torch.randn(1, 8, 4, 32, requires_grad=True)
    out = flash_attention(q, q[:, :, :2], q[:, :, :2])
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape


# ---------------------------------------------------------------------------
# the backward's launcher, its library faked
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_bwd_lib(monkeypatch):
    calls = []

    def bwd(*args):
        calls.append(args)
        return 0

    class Lib:
        flash_attention_bwd = bwd

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fa_mod._build, "load", lambda name: Lib)
    monkeypatch.setattr(fa_mod, "_BWD_FN", None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    fa_mod.reset_launches()
    return calls


def _bshd(B, S, n, hd, dtype=torch.bfloat16):
    """A (B, S, n, hd) 'card' tensor seen as a (B, n, S, hd) view."""
    return torch.zeros((B, S, n, hd), dtype=dtype).as_subclass(
        _OnCard).transpose(1, 2)


def test_bwd_launcher_takes_cross_attention_views(fake_bwd_lib):
    """Whisper's cross attention (Sq 447 against Sk 1500, hd 64), every
    tensor a transposed (B, S, H, hd) view: the pointers, sizes and
    strides in the entry point's order, one count a call, and the delta
    scratch allocated by the launcher."""
    B, T, E, H, hd = 2, 447, 1500, 16, 64
    q, o, do, dq = (_bshd(B, T, H, hd) for _ in range(4))
    k, v, dk, dv = (_bshd(B, E, H, hd) for _ in range(4))
    lse = torch.zeros((B, H, T)).as_subclass(_OnCard)
    got = fa_mod.flash_attention_bhsd_bwd(q, k, v, o, lse, do, causal=False,
                                          dq=dq, dk=dk, dv=dv)
    assert all(a is b for a, b in zip(got, (dq, dk, dv)))
    assert fa_mod.BWD_LAUNCHES == 1
    assert fa_mod.LAUNCHES == 0 and len(fake_bwd_lib) == 1
    args = fake_bwd_lib[0]
    assert len(fa_mod._BWD_FN.argtypes) == len(args)
    assert args[4] == lse.data_ptr()
    # dtype, B, H, KV, Sq, Sk, hd, causal, window
    assert args[10:19] == (1, B, H, H, T, E, hd, 0, 0)
    strides = [args[19 + 3 * i:22 + 3 * i] for i in range(8)]
    for i, t in enumerate((q, k, v, o, do, dq, dk, dv)):
        assert strides[i] == t.stride()[:3]
    assert strides[0] == (T * H * hd, hd, H * hd)
    fa_mod.reset_launches()
    assert fa_mod.BWD_LAUNCHES == 0


def test_bwd_launcher_checks(fake_bwd_lib):
    q = _bshd(1, 16, 4, 64)
    lse = torch.zeros((1, 4, 16)).as_subclass(_OnCard)
    bufs = {name: _bshd(1, 16, 4, 64) for name in ("dq", "dk", "dv")}
    with pytest.raises(ValueError, match="lse"):
        fa_mod.flash_attention_bhsd_bwd(q, q, q, q, lse[..., :8], q, **bufs)
    with pytest.raises(ValueError, match="lse"):
        fa_mod.flash_attention_bhsd_bwd(q, q, q, q, lse.double(), q, **bufs)
    with pytest.raises(ValueError, match="do must be"):
        fa_mod.flash_attention_bhsd_bwd(q, q, q, q, lse, q[:, :, :8], **bufs)
    with pytest.raises(ValueError, match="dq must be"):
        fa_mod.flash_attention_bhsd_bwd(q, q, q, q, lse, q,
                                        **dict(bufs, dq=q[:, :2]))
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention_bhsd_bwd(q, q, q, q, lse, q)   # dq on the CPU
    wide = torch.zeros((1, 16, 4, 68), dtype=torch.bfloat16).as_subclass(
        _OnCard)
    with pytest.raises(ValueError, match="16 bytes"):
        fa_mod.flash_attention_bhsd_bwd(q, q, q, q, lse,
                                        wide[..., :64].transpose(1, 2),
                                        **bufs)
    with pytest.raises(ValueError, match="head dim"):
        x = _bshd(1, 16, 4, 48)
        fa_mod.flash_attention_bhsd_bwd(x, x, x, x, lse, x)
    none = _bshd(1, 0, 4, 64)   # no keys: the forward raises too
    with pytest.raises(ValueError, match="no keys"):
        fa_mod.flash_attention_bhsd_bwd(q, none, none, q, lse, q,
                                        dq=bufs["dq"], dk=none, dv=none)
    assert fa_mod.BWD_LAUNCHES == 0 and not fake_bwd_lib
    # float32 on the CUDA cores: no alignment rule beyond a unit hd stride
    wide = torch.zeros((1, 16, 4, 66)).as_subclass(_OnCard)
    x = wide[..., :64].transpose(1, 2)
    grads = [torch.empty((1, 4, 16, 64)).as_subclass(_OnCard)
             for _ in range(3)]
    fa_mod.flash_attention_bhsd_bwd(x, x, x, x, lse, x, dq=grads[0],
                                    dk=grads[1], dv=grads[2])
    assert fa_mod.BWD_LAUNCHES == 1 and fake_bwd_lib[0][10] == 0


def test_forward_passes_lse_before_the_stream(monkeypatch):
    calls = []

    class Lib:
        @staticmethod
        def flash_attention_fwd(*args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fa_mod._build, "load", lambda name: Lib)
    monkeypatch.setattr(fa_mod, "_FN", None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    q = _bshd(1, 16, 4, 64)
    lse = torch.zeros((1, 4, 16)).as_subclass(_OnCard)
    out = _bshd(1, 16, 4, 64)
    fa_mod.flash_attention_bhsd(q, q, q, out=out, lse=lse)
    fa_mod.flash_attention_bhsd(q, q, q, out=out)
    assert calls[0][-2] == lse.data_ptr() and calls[1][-2] is None
    with pytest.raises(ValueError, match="lse"):
        fa_mod.flash_attention_bhsd(q, q, q, out=out, lse=torch.zeros(
            (1, 16, 4)).as_subclass(_OnCard).transpose(1, 2))


def test_bwd_entry_point_argument_layout(fake_bwd_lib):
    """The entry point is declared as it is defined: q, k, v, o, lse, dO,
    dq, dk, dv and the delta scratch as pointers; dtype, B, H, KV, Sq,
    Sk, hd, causal, window as ints; the (b, h, s) strides of q, k, v, o,
    dO, dq, dk, dv as 64-bit ints; the stream."""
    import ctypes

    fn = fa_mod._bwd_fn()
    assert fn.argtypes == ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                           + [ctypes.c_longlong] * 24 + [ctypes.c_void_p])
    assert fn.restype is ctypes.c_int


def test_bwd_launcher_takes_gqa_views(fake_bwd_lib):
    """hd 128 over 8 kv heads (llava's and mixtral's attention) with a
    window, q and k, v from one fused (B, S, H + 2 KV, hd) projection as
    the model slices it: KV in the sizes, dk and dv of k's shape, and
    each view's own strides."""
    B, S, H, KV, hd = 2, 96, 32, 8, 128
    fused = torch.zeros((B, S, H + 2 * KV, hd), dtype=torch.bfloat16
                        ).as_subclass(_OnCard)
    q = fused[:, :, :H].transpose(1, 2)
    k = fused[:, :, H:H + KV].transpose(1, 2)
    v = fused[:, :, H + KV:].transpose(1, 2)
    o, do, dq = (_bshd(B, S, H, hd) for _ in range(3))
    dk, dv = _bshd(B, S, KV, hd), _bshd(B, S, KV, hd)
    lse = torch.zeros((B, H, S)).as_subclass(_OnCard)
    fa_mod.flash_attention_bhsd_bwd(q, k, v, o, lse, do, causal=True,
                                    window=40, dq=dq, dk=dk, dv=dv)
    args = fake_bwd_lib[0]
    assert args[10:19] == (1, B, H, KV, S, S, hd, 1, 40)
    assert args[1] == k.data_ptr() and args[2] == v.data_ptr()
    assert args[2] - args[1] == KV * hd * 2
    strides = [args[19 + 3 * i:22 + 3 * i] for i in range(8)]
    for got, t in zip(strides, (q, k, v, o, do, dq, dk, dv)):
        assert got == t.stride()[:3]
    assert strides[1] == ((H + 2 * KV) * S * hd, hd, (H + 2 * KV) * hd)
    assert strides[6] == (S * KV * hd, hd, KV * hd)
    assert fa_mod.BWD_LAUNCHES == 1


BWD_NAMES = ("q", "k", "v", "o", "do", "dq", "dk", "dv")


@pytest.mark.parametrize("name", BWD_NAMES)
def test_bwd_launcher_raises_on_a_misaligned_bf16_view(fake_bwd_lib,
                                                       name):
    """Each of the eight bf16 tensors the kernels read or write by TMA or
    store to must start on 16 bytes: one that starts 2 bytes later
    raises, and nothing launches."""
    B, S, H, hd = 1, 16, 4, 64
    ts = {n: _bshd(B, S, H, hd) for n in BWD_NAMES}
    off = torch.zeros((B * S * H * hd + 1,), dtype=torch.bfloat16
                      ).as_subclass(_OnCard)
    ts[name] = off[1:].view(B, S, H, hd).transpose(1, 2)
    assert ts[name].data_ptr() % 16 == 2
    lse = torch.zeros((B, H, S)).as_subclass(_OnCard)
    with pytest.raises(ValueError, match=f"bfloat16 {name} must start on "
                                         f"16 bytes"):
        fa_mod.flash_attention_bhsd_bwd(
            ts["q"], ts["k"], ts["v"], ts["o"], lse, ts["do"], dq=ts["dq"],
            dk=ts["dk"], dv=ts["dv"])
    assert fa_mod.BWD_LAUNCHES == 0 and not fake_bwd_lib


@pytest.mark.parametrize("name", ("q", "k", "dk"))
def test_bwd_launcher_raises_on_a_bf16_stride_off_eight(fake_bwd_lib, name):
    """A row stride that is not a multiple of 8 elements (16 bytes) is
    refused: a tensor map's strides must be."""
    B, S, H, hd = 1, 16, 4, 64
    ts = {n: _bshd(B, S, H, hd) for n in BWD_NAMES}
    wide = torch.zeros((B, S, H, hd + 4), dtype=torch.bfloat16
                       ).as_subclass(_OnCard)
    ts[name] = wide[..., :hd].transpose(1, 2)
    lse = torch.zeros((B, H, S)).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa_mod.flash_attention_bhsd_bwd(
            ts["q"], ts["k"], ts["v"], ts["o"], lse, ts["do"], dq=ts["dq"],
            dk=ts["dk"], dv=ts["dv"])
    assert not fake_bwd_lib


@pytest.mark.parametrize("hd", (16, 48, 96, 160, 256))
def test_bwd_launcher_raises_on_an_unsupported_head_dim(fake_bwd_lib, hd):
    x = _bshd(1, 16, 4, hd)
    lse = torch.zeros((1, 4, 16)).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="head dim"):
        fa_mod.flash_attention_bhsd_bwd(x, x, x, x, lse, x, dq=x, dk=x,
                                        dv=x)
    assert not fake_bwd_lib


@pytest.mark.parametrize("what", ("k_v_differ", "heads_do_not_group",
                                  "dk_shape", "dv_shape", "o_shape",
                                  "three_dims"))
def test_bwd_launcher_raises_on_mismatched_shapes(fake_bwd_lib, what):
    B, S, H, KV, hd = 1, 16, 6, 2, 64
    q, o, do, dq = (_bshd(B, S, H, hd) for _ in range(4))
    k, v, dk, dv = (_bshd(B, S, KV, hd) for _ in range(4))
    lse = torch.zeros((B, H, S)).as_subclass(_OnCard)
    if what == "k_v_differ":
        v = _bshd(B, S + 8, KV, hd)
    elif what == "heads_do_not_group":
        k, v, dk, dv = (_bshd(B, S, 4, hd) for _ in range(4))
    elif what == "dk_shape":
        dk = _bshd(B, S, H, hd)
    elif what == "dv_shape":
        dv = _bshd(B, S + 8, KV, hd)
    elif what == "o_shape":
        o = _bshd(B, S, KV, hd)
    else:
        q = q[0]
    with pytest.raises(ValueError):
        fa_mod.flash_attention_bhsd_bwd(q, k, v, o, lse, do, dq=dq, dk=dk,
                                        dv=dv)
    assert fa_mod.BWD_LAUNCHES == 0 and not fake_bwd_lib


def test_bwd_launcher_raises_on_a_failed_launch(monkeypatch, fake_bwd_lib):
    """A nonzero return (a CUDA error, or -2 for a tensor map the driver
    refused) raises and is not counted."""
    class Lib:
        @staticmethod
        def flash_attention_bwd(*args):
            return -2

    monkeypatch.setattr(fa_mod._build, "load", lambda name: Lib)
    monkeypatch.setattr(fa_mod, "_BWD_FN", None)
    x = _bshd(1, 16, 4, 64)
    lse = torch.zeros((1, 4, 16)).as_subclass(_OnCard)
    bufs = {n: _bshd(1, 16, 4, 64) for n in ("dq", "dk", "dv")}
    with pytest.raises(RuntimeError, match="CUDA error -2"):
        fa_mod.flash_attention_bhsd_bwd(x, x, x, x, lse, x, **bufs)
    assert fa_mod.BWD_LAUNCHES == 0

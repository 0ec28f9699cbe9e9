"""The flash-attention kernel's plain version against the JAX reference.

The same numpy inputs go to the port's ``flash_attention`` adapter (a CPU
tensor takes the plain version), the JAX oracle ``attention_ref`` and the
JAX Pallas kernel run in interpret mode, on the six shapes of
``tests/test_kernels_flash.py``, on ragged lengths, and with more or fewer
queries than keys (Sq != Sk: whisper's cross attention, unmasked, and the
causal mask, which aligns query 0 with key 0 in all three versions).
Tolerances are those of that file: 2e-5 in float32 (sum order), 2e-2 in
bfloat16 (one bf16 rounding of outputs of order 1).  The CUDA kernel
itself runs only on the card, where ``chip_smoke.py`` holds it against the
same plain version; here its launcher's checks and dispatch run with a
fake launch.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention_bhsd as j_flash_bhsd)
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, flash_attention_bhsd)

# The package exports the adapter function under the module's own name.
fa_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

CASES = [
    # B, H, KV, S, hd, causal, window
    (1, 4, 4, 128, 64, True, 0),
    (2, 4, 2, 256, 64, True, 0),      # GQA
    (1, 8, 1, 256, 128, True, 0),     # MQA
    (2, 2, 2, 128, 32, False, 0),     # bidirectional (encoder)
    (1, 4, 2, 512, 64, True, 128),    # sliding window
    (1, 2, 2, 256, 80, True, 0),      # stablelm head_dim
]
RAGGED = [
    (1, 4, 2, 37, 80, True, 0),
    (2, 2, 1, 1, 64, True, 0),
    (1, 2, 2, 100, 64, True, 24),
    (1, 2, 2, 71, 32, False, 0),
]
# Sq != Sk: B, H, KV, Sq, Sk, hd, causal.  Sk a multiple of the Pallas
# block (64), so the interpret-mode kernel runs too; Sq = 1 is one decoder
# token against the frames.
CROSS = [
    (1, 4, 4, 64, 256, 64, False),
    (2, 4, 2, 1, 128, 64, False),
    (1, 2, 2, 128, 64, 128, True),    # more queries than keys
    (1, 4, 1, 64, 192, 32, True),
]
# Ragged Sk (against attention_ref alone), whisper's 1500 frames among them.
CROSS_RAGGED = [
    (1, 4, 4, 37, 1500, 64, False),
    (2, 2, 2, 5, 150, 64, False),
    (1, 8, 2, 71, 100, 128, True),
    (1, 2, 2, 100, 37, 80, True),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(b, h, kv, s, hd, seed):
    """(B, H, S, hd) q and (B, KV, S, hd) k, v as float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, s, hd)).astype(np.float32)
            for n in (h, kv, kv)]


def _port(qkv, causal, window, tdt):
    """The model-layout adapter on CPU tensors, in (B, H, S, hd) layout."""
    q, k, v = (torch.from_numpy(x).to(tdt).transpose(1, 2) for x in qkv)
    out = flash_attention(q, k, v, causal=causal, window=window)
    return out.transpose(1, 2).float().numpy()


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                                - np.asarray(b, np.float32))))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", CASES)
def test_plain_matches_reference_and_interpret_kernel(B, H, KV, S, hd,
                                                      causal, window, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    qkv = _inputs(B, H, KV, S, hd, seed=S + hd)
    got = _port(qkv, causal, window, tdt)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in qkv)
    want = j_ref(jq, jk, jv, causal=causal, window=window)
    kern = j_flash_bhsd(jq, jk, jv, causal=causal, window=window,
                        block_q=64, block_k=64, interpret=True)
    assert _err(got, want) < tol
    assert _err(got, kern) < tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", RAGGED)
def test_plain_matches_reference_ragged(B, H, KV, S, hd, causal, window,
                                        dtype):
    tdt, jdt, tol = DTYPES[dtype]
    qkv = _inputs(B, H, KV, S, hd, seed=S)
    got = _port(qkv, causal, window, tdt)
    want = j_ref(*(jnp.asarray(x, jdt) for x in qkv), causal=causal,
                 window=window)
    assert _err(got, want) < tol


def _cross_inputs(b, h, kv, sq, sk, hd, seed):
    """(B, H, Sq, hd) q and (B, KV, Sk, hd) k, v as float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, hd), (b, kv, sk, hd), (b, kv, sk, hd))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal", CROSS)
def test_plain_matches_reference_and_interpret_kernel_sq_ne_sk(
        B, H, KV, Sq, Sk, hd, causal, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    qkv = _cross_inputs(B, H, KV, Sq, Sk, hd, seed=Sq + Sk)
    got = _port(qkv, causal, 0, tdt)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in qkv)
    want = j_ref(jq, jk, jv, causal=causal)
    kern = j_flash_bhsd(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                        interpret=True)
    assert got.shape == (B, H, Sq, hd)
    assert _err(got, want) < tol
    assert _err(got, kern) < tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal", CROSS_RAGGED)
def test_plain_matches_reference_ragged_sq_ne_sk(B, H, KV, Sq, Sk, hd,
                                                 causal, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    qkv = _cross_inputs(B, H, KV, Sq, Sk, hd, seed=Sk)
    got = _port(qkv, causal, 0, tdt)
    want = j_ref(*(jnp.asarray(x, jdt) for x in qkv), causal=causal)
    assert _err(got, want) < tol


def test_ref_keeps_dtype_and_layout():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 4, 2, 9, 32, seed=0))
    out = attention_ref(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 9, 32)
    # row 0 attends to key 0 alone under the causal mask
    assert torch.equal(out[0, :2, 0], v[0, 0, 0].expand(2, 32))


def test_launcher_takes_only_cuda_tensors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 8, 64, seed=1))
    fa_mod.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bhsd(q, k, v)
    assert fa_mod.LAUNCHES == 0


@pytest.mark.parametrize("shape_kv,match", [
    ((1, 3, 8, 64), "group"),          # 4 heads onto 3 kv heads
    ((1, 2, 8, 48), "k and v"),        # head dims differ
])
def test_launcher_rejects_bad_shapes(shape_kv, match):
    q = torch.zeros((1, 4, 8, 64))
    k = v = torch.zeros(shape_kv)
    with pytest.raises(ValueError, match=match):
        flash_attention_bhsd(q, k, v)


def test_launcher_rejects_unsupported_head_dim():
    assert 48 not in HEAD_DIMS and 80 in HEAD_DIMS
    x = torch.zeros((1, 2, 8, 48))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bhsd(x, x, x)


def test_adapter_refuses_other_devices():
    x = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(x, x, x)


# ---------------------------------------------------------------------------
# the card's dispatch, without a card
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def fake_launch(monkeypatch):
    """Replace the ctypes call (and the stream) with a recorder; the
    launcher's checks, allocation and count run as on the card."""
    calls = []

    def fn(*args):
        calls.append(args)
        return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fa_mod, "_fn", lambda: fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    fa_mod.reset_launches()
    return calls


def _serving_views(S, H, KV, hd, dtype=torch.bfloat16):
    """q, k, v and out as the serving path hands them on: (B, S, H, hd)
    tensors on the 'card', seen as (B, H, S, hd) transposed views."""
    q, k, v = (torch.from_numpy(x).to(dtype).transpose(1, 2).contiguous()
               .as_subclass(_OnCard) for x in _inputs(1, H, KV, S, hd, 0))
    out = torch.empty((1, S, H, hd), dtype=dtype).as_subclass(_OnCard)
    return [t.transpose(1, 2) for t in (q, k, v, out)]


@pytest.mark.parametrize("hd,H,KV", [(80, 32, 32), (112, 32, 32)])
def test_launcher_takes_serving_views(fake_launch, hd, H, KV):
    """stablelm-3b's (hd 80) and zamba2-7b's shared attention (hd 112)
    transposed bf16 views: 16-byte bases, strides of multiples of 8."""
    q, k, v, out = _serving_views(37, H, KV, hd)
    got = flash_attention_bhsd(q, k, v, out=out)
    assert got is out and fa_mod.LAUNCHES == 1 and len(fake_launch) == 1
    args = fake_launch[0]
    assert args[4:13] == (1, 1, H, KV, 37, 37, hd, 1, 0)
    # (b, h, s) strides of each view: the head stride is hd, 160 or 224 bytes
    assert args[13:16] == (37 * H * hd, hd, H * hd)
    assert args[22:25] == (37 * H * hd, hd, H * hd)


def test_launcher_takes_cross_attention_views(monkeypatch):
    """Whisper's cross attention as the decoder hands it on: q from the
    (B, T, H, hd) projection of T = 447 tokens, k and v from the
    (B, 1500, KV, hd) projections of the encoder's output, out a (B, T,
    H, hd) buffer, all bf16 transposed views; the library is faked at
    ``_build.load``, so the argument types, the handle and the count are
    the launcher's own."""
    calls = []

    def fwd(*args):
        calls.append(args)
        return 0

    class Lib:
        flash_attention_fwd = fwd

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fa_mod._build, "load", lambda name: Lib)
    monkeypatch.setattr(fa_mod, "_FN", None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    fa_mod.reset_launches()
    B, T, E, H, hd = 2, 447, 1500, 16, 64

    def view(s):
        t = torch.zeros((B, s, H, hd), dtype=torch.bfloat16)
        return t.as_subclass(_OnCard).transpose(1, 2)

    q, k, v, out = view(T), view(E), view(E), view(T)
    assert all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    got = flash_attention_bhsd(q, k, v, causal=False, out=out)
    assert got is out and fa_mod.LAUNCHES == 1 and len(calls) == 1
    args = calls[0]
    assert len(fwd.argtypes) == len(args)
    # dtype, B, H, KV, Sq, Sk, hd, causal, window
    assert args[4:13] == (1, B, H, H, T, E, hd, 0, 0)
    assert args[13:16] == (T * H * hd, hd, H * hd)        # q
    assert args[16:19] == args[19:22] == (E * H * hd, hd, H * hd)  # k, v
    assert args[22:25] == (T * H * hd, hd, H * hd)        # out


@pytest.mark.parametrize("what", ["base", "stride"])
def test_launcher_rejects_unaligned_bf16_views(fake_launch, what):
    """TMA reads bf16 tensors through maps whose base and strides must be
    multiples of 16 bytes; anything else raises, with no slower path."""
    if what == "base":   # k one element (2 bytes) into its storage
        q, k, v, out = _serving_views(16, 4, 4, 64)
        flat = torch.zeros(16 * 4 * 64 + 8,
                           dtype=torch.bfloat16).as_subclass(_OnCard)
        k = flat[1:1 + 16 * 4 * 64].view(1, 16, 4, 64).transpose(1, 2)
    else:                # a (B, S, H, 68) tensor cut to hd = 64
        wide = torch.zeros((1, 16, 4, 68),
                           dtype=torch.bfloat16).as_subclass(_OnCard)
        q = wide[..., :64].transpose(1, 2)
        k = v = q
        out = None
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_bhsd(q, k, v, out=out)
    assert fa_mod.LAUNCHES == 0 and not fake_launch


def test_launcher_float32_keeps_its_rule(fake_launch):
    """float32 runs on CUDA cores: no alignment rule beyond a unit hd
    stride."""
    wide = torch.zeros((1, 16, 4, 66)).as_subclass(_OnCard)
    q = wide[..., :64].transpose(1, 2)
    out = torch.empty((1, 4, 16, 64)).as_subclass(_OnCard)
    flash_attention_bhsd(q, q, q, out=out)
    assert fa_mod.LAUNCHES == 1 and fake_launch[0][4] == 0

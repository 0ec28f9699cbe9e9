"""The SSD scan's backward: its plain version and its launcher.

``ssd_scan_bwd_ref`` (the formulas of the CUDA backward kernel, in plain
PyTorch) is held against autograd through ``ssd_three_pass`` (the same
chunk split) and against ``jax.vjp`` of the reference's ``ssd_chunked``
(its chunk halves until it divides S) and ``ssd_ref`` (the sequential
recurrence), at S a multiple of the chunk and ragged.  a = dt * A and
A = -exp(A_log) are outside the kernel, so its (da, ddt) become the
reference's (ddt + da A, sum of da dt A) over dt and A_log.  Tolerances,
of each gradient's largest magnitude (for A_log's, a sum over every
position whose terms cancel, of the largest sum of its terms' magnitudes):
1e-4 against the chunked forms (float32 sums in other orders; measured
within 4e-5), and the forward tests' 5e-4 * max(1, chunk / 64) against
the sequential recurrence (another algorithm).

``ssd_scan_bwd_split`` (the bf16 CUDA path's split: local states, the
passes over the chunks, key tiles by head group with per-pair shares of
dC and dacum, then the sums) is held against ``ssd_scan_bwd_ref`` and
``jax.vjp`` of ``ssd_chunked`` at the same 1e-4, and its hi + lo bf16
products against float32 products (see ``HILO_REL``).

The CUDA kernel runs only on the card (``chip_smoke.py`` phase v).  Here
``SSDScan`` and the launcher run on CPU tensors that report themselves
as CUDA ones, with the ctypes calls replaced by recorders: the launch
counts, the scratch, the raises outside the accepted shapes and the
gradients' dtypes.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import (split_hi_lo, ssd_scan_bwd_ref,
                                              ssd_scan_bwd_split,
                                              ssd_three_pass)

torch.set_num_threads(1)
launcher = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
ref_module = importlib.import_module("repro_torch.kernels.ssd_scan.ref")

# Bt, S, H, P, N, chunk: tests/test_kernels_ssd.py's cases, and ragged S.
CASES = [
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 32, 64),
    (2, 64, 8, 16, 8, 16),
    (1, 128, 1, 128, 64, 128),
]
RAGGED = [(1, 37, 2, 16, 8, 16), (2, 100, 3, 32, 16, 64)]
REL = 1e-4


def _inputs(Bt, S, H, P, N, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    B = rng.standard_normal((Bt, S, N)).astype(np.float32)
    C = rng.standard_normal((Bt, S, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(np.float32)
    A_log = np.log(rng.uniform(1.0, 8.0, H)).astype(np.float32)
    dy = rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    return x, B, C, dt, A_log, dy


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_grads(x, B, C, dt, A_log, dy, chunk, bwd=ssd_scan_bwd_ref):
    """The gradients of ``bwd`` (ssd_scan_bwd_ref's contract) over (x, B,
    C, dt, A_log), and the largest sum of magnitudes of A_log's terms (its
    tolerance's scale)."""
    A = -torch.exp(_t(A_log))
    dtt = _t(dt)
    dx, dB, dC, da, ddt = bwd(_t(x), _t(B), _t(C), dtt * A, dtt, _t(dy),
                              chunk)
    terms = da * dtt * A
    return ((dx, dB, dC, ddt + da * A, terms.sum(dim=(0, 1))),
            float(terms.abs().sum(dim=(0, 1)).max()))


def _close(ref, want, rel):
    got, a_scale = ref
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        scale = a_scale if i == 4 else np.abs(w).max()
        assert np.abs(g - w).max() <= rel * scale, (i, np.abs(g - w).max(),
                                                    scale)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES + RAGGED)
def test_bwd_ref_matches_autograd_through_three_pass(Bt, S, H, P, N, chunk):
    x, B, C, dt, A_log, dy = _inputs(Bt, S, H, P, N)
    ins = [_t(a).requires_grad_() for a in (x, B, C, dt, A_log)]
    y, _ = ssd_three_pass(*ins, chunk)
    want = torch.autograd.grad(y, ins, _t(dy))
    _close(_ref_grads(x, B, C, dt, A_log, dy, chunk), want, REL)


def _jax_vjp(fn, x, B, C, dt, A_log, dy):
    (y, state), vjp = jax.vjp(fn, *map(jnp.asarray, (x, B, C, dt, A_log)))
    return vjp((jnp.asarray(dy), jnp.zeros_like(state)))


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES + RAGGED)
def test_bwd_ref_matches_reference_vjp_of_ssd_chunked(Bt, S, H, P, N,
                                                      chunk):
    x, B, C, dt, A_log, dy = _inputs(Bt, S, H, P, N)
    want = _jax_vjp(jax.jit(lambda *a: j_ssd_chunked(*a, chunk)),
                    x, B, C, dt, A_log, dy)
    _close(_ref_grads(x, B, C, dt, A_log, dy, chunk), want, REL)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", [CASES[0], CASES[2],
                                              RAGGED[0]])
def test_bwd_ref_matches_reference_vjp_of_sequential_recurrence(
        Bt, S, H, P, N, chunk):
    x, B, C, dt, A_log, dy = _inputs(Bt, S, H, P, N)
    want = _jax_vjp(jax.jit(j_ssd_ref), x, B, C, dt, A_log, dy)
    _close(_ref_grads(x, B, C, dt, A_log, dy, chunk), want,
           5e-4 * max(1.0, chunk / 64))


def test_bwd_ref_padded_rows_change_nothing():
    """The ragged last chunk's zero-padded rows (dt = a = 0) give the
    real rows the gradients of an unpadded split: S = 40 in chunks of 16
    against chunks of 8, which divide it."""
    x, B, C, dt, A_log, dy = _inputs(1, 40, 2, 16, 8)
    _close(_ref_grads(x, B, C, dt, A_log, dy, 16),
           _ref_grads(x, B, C, dt, A_log, dy, 8)[0], REL)


# ---------------------------------------------------------------------------
# the bf16 kernels' split: local states, passes, key tiles by head group
# ---------------------------------------------------------------------------

def _split(tile, hilo=False):
    """ssd_scan_bwd_split with the launcher's head groups."""
    def bwd(x, B, C, a, dt, dy, chunk):
        gh = launcher.bwd_heads_per_block(x.shape[2], x.shape[3])
        return ssd_scan_bwd_split(x, B, C, a, dt, dy, chunk, gh, tile=tile,
                                  hilo=hilo)
    return bwd


@pytest.mark.parametrize("tile", [64, 8])
@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES + RAGGED)
def test_split_matches_bwd_ref(Bt, S, H, P, N, chunk, tile):
    """The split (at the kernels' 64-row tiles, and at 8-row tiles, which
    give each chunk several key and query tiles) against the formulas."""
    x, B, C, dt, A_log, dy = _inputs(Bt, S, H, P, N)
    _close(_ref_grads(x, B, C, dt, A_log, dy, chunk, _split(tile)),
           _ref_grads(x, B, C, dt, A_log, dy, chunk)[0], REL)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES + RAGGED)
def test_split_matches_reference_vjp_of_ssd_chunked(Bt, S, H, P, N, chunk):
    x, B, C, dt, A_log, dy = _inputs(Bt, S, H, P, N)
    want = _jax_vjp(jax.jit(lambda *a: j_ssd_chunked(*a, chunk)),
                    x, B, C, dt, A_log, dy)
    _close(_ref_grads(x, B, C, dt, A_log, dy, chunk, _split(16)), want, REL)


def test_hi_lo_pair_keeps_16_bits():
    """hi + lo of a float32 value is within 2^-17 of it (each bf16
    rounding keeps 8 bits, the second of the first's remainder)."""
    rng = np.random.default_rng(5)
    v = _t((rng.standard_normal(100_000)
            * 10.0 ** rng.uniform(-3, 3, 100_000)).astype(np.float32))
    hi, lo = split_hi_lo(v)
    assert hi.to(torch.bfloat16).float().equal(hi)
    assert lo.to(torch.bfloat16).float().equal(lo)
    assert ((hi + lo - v).abs() <= 2.0 ** -17 * v.abs()).all()


# The hi + lo products (float32 sums) against float32 products, on the
# bf16-valued inputs the kernels take: measured within 1.1e-5 of the
# scale; held to 1e-3, a twentieth of phase v's bf16 tolerance of 2e-2.
HILO_REL = 1e-3


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES + RAGGED)
def test_hi_lo_products_stay_well_inside_the_bf16_tolerance(Bt, S, H, P, N,
                                                            chunk):
    x, B, C, dt, A_log, dy = (
        a.astype(np.float32) if i in (3, 4) else np.asarray(
            _t(a).to(torch.bfloat16).float())
        for i, a in enumerate(_inputs(Bt, S, H, P, N)))
    _close(_ref_grads(x, B, C, dt, A_log, dy, chunk, _split(16, hilo=True)),
           _ref_grads(x, B, C, dt, A_log, dy, chunk, _split(16))[0],
           HILO_REL)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk",
                         [c for c in CASES + RAGGED if c[1] > c[5]])
def test_the_lo_half_carries_da_and_ddt(Bt, S, H, P, N, chunk,
                                        monkeypatch):
    """With the lo halves cut (hi alone: plain bf16 products), da and ddt
    move at least ten times as far from the float32 products as with the
    pairs: what chip_smoke.py's SSD_BWD_HILO_TOL on the bf16 path's da
    and ddt is there to catch (scripts/ssd_bwd_lo_cut.py cuts them in the
    kernels).  At S > chunk: within a chunk da and ddt take G and dyx,
    products of the bf16 inputs, and meet the computed operands only
    through the states that chunks pass on."""
    x, B, C, dt, A_log, dy = _inputs(Bt, S, H, P, N)
    x, B, C, dy = (_t(v).to(torch.bfloat16).float() for v in (x, B, C, dy))
    dt = _t(dt)
    a = dt * -torch.exp(_t(A_log))
    gh = launcher.bwd_heads_per_block(H, P)

    def da_ddt(hilo):
        return ssd_scan_bwd_split(x, B, C, a, dt, dy, chunk, gh, tile=16,
                                  hilo=hilo)[3:]

    want = da_ddt(False)

    def err(got):
        return max(float((g - w).abs().max()) / max(1.0, float(
            w.abs().max())) for g, w in zip(got, want))

    pair = err(da_ddt(True))
    monkeypatch.setattr(ref_module, "split_hi_lo", lambda v, on=True: (
        v.to(torch.bfloat16).float(),) if on else (v,))
    hi = err(da_ddt(True))
    assert hi > 0 and hi >= 10 * pair, (hi, pair)


# ---------------------------------------------------------------------------
# the card's dispatch, with the ctypes calls recorded
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def fake_launch(monkeypatch):
    """Both C entry points replaced by recorders (the outputs keep the
    launcher's torch.empty contents); the checks, allocations and counts
    run as on the card."""
    calls = {"fwd": [], "bwd": []}

    def recorder(kind):
        def fn(*args):
            calls[kind].append(args)
            return 0
        return fn

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(launcher, "_fn", lambda: recorder("fwd"))
    monkeypatch.setattr(launcher, "_bwd_fn", lambda: recorder("bwd"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    launcher.reset_launches()
    return calls


def _xbc_views(S, H, P, N, dtype):
    """x, B and C as the model slices them out of one xBC tensor, on the
    'card', and dt, A_log."""
    x, B, C, dt, A_log, _ = _inputs(1, S, H, P, N)
    xbc = np.concatenate([x.reshape(1, S, -1), B, C], axis=-1)
    tx = _t(xbc).as_subclass(_OnCard).to(dtype)
    d = H * P
    return (tx[..., :d].reshape(1, S, H, P), tx[..., d:d + N],
            tx[..., d + N:], _t(dt).as_subclass(_OnCard), _t(A_log))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_goes_through_the_backward_kernel(fake_launch, monkeypatch,
                                               dtype):
    """Under grad, ssd_scan on card tensors runs SSDScan: one forward
    launch, and backward one launch of the backward kernel with fresh
    gradients in the inputs' dtypes and its float32 scratch."""
    S, H, P, N, chunk = 100, 2, 32, 16, 64
    made = []
    empty = torch.empty

    def recording(*args, **kw):
        t = empty(*args, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(launcher.torch, "empty", recording)
    xh, Bm, Cm, dt, A_log = _xbc_views(S, H, P, N, dtype)
    xh.requires_grad_()
    dt.requires_grad_()
    A_log.requires_grad_()
    y = ops.ssd_scan(xh, Bm, Cm, dt, A_log, chunk)
    assert launcher.LAUNCHES == 1 and launcher.BWD_LAUNCHES == 0
    assert y.grad_fn is not None and y.dtype == dtype
    made.clear()
    gx, gdt, gA = torch.autograd.grad(y.float().sum(), (xh, dt, A_log))
    assert launcher.LAUNCHES == 1 and launcher.BWD_LAUNCHES == 1
    args = fake_launch["bwd"][0]
    gh = launcher.bwd_heads_per_block(H, P)
    assert gh == 1
    assert args[11:19] == (int(dtype == torch.bfloat16), 1, S, H, P, N,
                           chunk, gh)
    row = H * P + 2 * N
    assert args[19:26] == (S * row, row, P, S * row, row, S * row, row)
    shapes = launcher.bwd_scratch_shapes(1, S, H, P, N, chunk, dtype)
    nc, q_pad, f32 = 2, 64, torch.float32
    if dtype == torch.float32:
        assert shapes == {
            "s_in": ((1, nc, H, P, N), f32), "d_out": ((1, nc, H, P, N), f32),
            "acum": ((1, nc, H, q_pad), f32), "sd": ((1, nc, H), f32),
            "db_h": ((1, S, H, N), f32), "dc_h": ((1, S, H, N), f32),
            "dac": ((1, S, H), f32), "u": ((1, S, H), f32)}
    else:   # one 64-row tile a chunk: one pair; two groups of one head
        bf = torch.bfloat16
        assert shapes == {
            "sloc": ((1, nc, H, P, N), f32), "dloc": ((1, nc, H, P, N), f32),
            "acum": ((1, nc, H, q_pad), f32),
            "s_hl": ((1, nc, H, 2, P, N), bf),
            "d_hl": ((1, nc, H, 2, P, N), bf),
            "sd": ((1, nc, H, 1), f32), "db_part": ((1, S, 2, N), f32),
            "dc_part": ((1, nc, 2, 1, 64, N), f32),
            "rowpart": ((1, nc, H, 1, 64), f32),
            "dac": ((1, S, H), f32), "u": ((1, S, H), f32)}
    assert args[27] == len(shapes)
    scratch = {t.data_ptr(): t for t in made}
    for ptr, (shape, kind) in zip(list(args[26]), shapes.values()):
        assert tuple(scratch[ptr].shape) == shape
        assert scratch[ptr].dtype == kind
    outs = [scratch[ptr] for ptr in args[6:11]]
    assert [t.dtype for t in outs] == [dtype] * 3 + [torch.float32] * 2
    assert [tuple(t.shape) for t in outs] == [(1, S, H, P), (1, S, N),
                                              (1, S, N), (1, S, H),
                                              (1, S, H)]
    assert gx.dtype == dtype and gdt.dtype == torch.float32
    assert gA.shape == (H,)


def test_no_grad_path_is_unchanged(fake_launch):
    xh, Bm, Cm, dt, A_log = _xbc_views(64, 2, 16, 8, torch.float32)
    with torch.no_grad():
        ops.ssd_scan(xh.requires_grad_(), Bm, Cm, dt, A_log, 32)
    y = ops.ssd_scan(xh.detach(), Bm, Cm, dt, A_log, 32)
    assert y.grad_fn is None
    assert launcher.LAUNCHES == 2 and launcher.BWD_LAUNCHES == 0
    assert not fake_launch["bwd"]


def test_final_state_gradient_raises(fake_launch):
    xh, Bm, Cm, dt, A_log = _xbc_views(64, 2, 16, 8, torch.float32)
    xh.requires_grad_()
    y, state = ops.ssd_scan(xh, Bm, Cm, dt, A_log, 32, return_state=True)
    with pytest.raises(NotImplementedError, match="final state"):
        torch.autograd.grad(state.sum(), xh)
    # y alone differentiates
    torch.autograd.grad(y.float().sum(), xh)
    assert launcher.BWD_LAUNCHES == 1


@pytest.mark.parametrize("P,N,dtype,chunk,match", [
    (48, 16, torch.float32, 64, "head dim 48"),
    (64, 256, torch.float32, 64, "state dim 256"),
    (64, 16, torch.float16, 64, "dtype must be float32 or bfloat16"),
    (64, 16, torch.float32, 2048, "chunk 2048"),
])
def test_bwd_raises_outside_the_accepted_shapes(fake_launch, P, N, dtype,
                                                chunk, match):
    x, B, C, dt, A_log, dy = _inputs(1, 8, 2, P, N)
    tx, tb, tc, tdy = (_t(a).as_subclass(_OnCard).to(dtype)
                       for a in (x, B, C, dy))
    tdt = _t(dt).as_subclass(_OnCard)
    with pytest.raises(ValueError, match=match):
        launcher.ssd_scan_chunked_bwd(tx, tb, tc, tdt * -1.0, tdt, tdy,
                                      chunk)
    assert launcher.BWD_LAUNCHES == 0 and not fake_launch["bwd"]


def test_bwd_takes_any_dy_strides(fake_launch):
    """dy from autograd may have any strides: the launcher passes a
    contiguous copy."""
    xh, Bm, Cm, dt, A_log = _xbc_views(40, 2, 16, 8, torch.float32)
    dy = _t(np.zeros((1, 2, 40, 16), np.float32)).as_subclass(
        _OnCard).transpose(1, 2)
    assert not dy.is_contiguous()
    launcher.ssd_scan_chunked_bwd(xh, Bm, Cm, dt * -1.0, dt, dy, 16)
    assert launcher.BWD_LAUNCHES == 1
    with pytest.raises(ValueError, match="dy must be"):
        launcher.ssd_scan_chunked_bwd(xh, Bm, Cm, dt * -1.0, dt,
                                      dy.to(torch.bfloat16), 16)


def test_an_edited_header_builds_anew(tmp_path, monkeypatch):
    """Both SSD sources include csrc/ssd_tc.cuh; a library's name hashes
    the headers beside its source, so editing one builds anew."""
    from repro_torch.kernels import _build
    real = _build.sources()
    assert real["ssd_scan"].parent == real["ssd_scan_bwd"].parent
    assert (real["ssd_scan"].parent / "ssd_tc.cuh").exists()
    csrc = tmp_path / "k" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "a.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    assert list(_build.sources()) == ["a"]
    first = _build.library_path("a")
    assert _build.library_path("a") == first
    (csrc / "h.cuh").write_text("// two\n")
    assert _build.library_path("a") != first

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
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_three_pass

torch.set_num_threads(1)
launcher = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

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


def _ref_grads(x, B, C, dt, A_log, dy, chunk):
    """ssd_scan_bwd_ref's gradients over (x, B, C, dt, A_log), and the
    largest sum of magnitudes of A_log's terms (its tolerance's scale)."""
    A = -torch.exp(_t(A_log))
    dtt = _t(dt)
    dx, dB, dC, da, ddt = ssd_scan_bwd_ref(_t(x), _t(B), _t(C), dtt * A, dtt,
                                           _t(dy), chunk)
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
    assert args[11:18] == (int(dtype == torch.bfloat16), 1, S, H, P, N,
                           chunk)
    row = H * P + 2 * N
    assert args[18:25] == (S * row, row, P, S * row, row, S * row, row)
    shapes = launcher.bwd_scratch_shapes(1, S, H, P, N, chunk)
    nc, q_pad = 2, 64
    assert shapes == {"s_in": (1, nc, H, P, N), "d_out": (1, nc, H, P, N),
                      "acum": (1, nc, H, q_pad), "sd": (1, nc, H),
                      "db_h": (1, S, H, N), "dc_h": (1, S, H, N),
                      "dac": (1, S, H), "u": (1, S, H)}
    scratch = {t.data_ptr(): t for t in made}
    for ptr, shape in zip(args[25:33], shapes.values()):
        assert tuple(scratch[ptr].shape) == shape
        assert scratch[ptr].dtype == torch.float32
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

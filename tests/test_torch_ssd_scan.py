"""The port's SSD scan (plain versions and adapter) against the JAX reference.

Inputs are made with numpy and fed to both packages.  The CUDA kernel runs
only on the card (``chip_smoke.py`` phase k); here its adapter's CPU
branch, its launcher's checks and dispatch (with a fake launch), and the
padded-tail identity its chunking relies on are held against the
reference.  Tolerances: the two sequential recurrences (``ssd_ref``) and
the two chunked forms (``ssd_chunked``) do the same float32 operations in
other sum orders, within 1e-5 of the largest output; the adapter against
the interpret-mode Pallas kernel is held to the JAX test's
``5e-4 * max(1, chunk / 64)``, and bf16 inputs to its 0.15.  The padded
tail runs other chunk lengths than the reference at the ragged length
(which halves its chunk to 1 token at S = 37 or 255), so it sums in
another order over up to ``chunk`` terms: held to chunk * 2^-23 of the
largest output.  The plain three-pass split (chunk states, state passing,
chunk scan: the algebra of the CUDA bf16 path) is held to 1e-5 of the
largest output against both chunked forms, and to the JAX test's
``5e-4 * max(1, chunk / 64)`` of it against the sequential recurrences
(another algorithm: decays as differences of cumulative sums, not
products) and, absolutely, against the interpret-mode kernel.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_three_pass
from repro_torch.models.ssm import ssd_chunked

torch.set_num_threads(1)
# The launcher module (the package exports the adapter under its name).
launcher = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

# The cases of tests/test_kernels_ssd.py: Bt, S, H, P, N, chunk.
CASES = [
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 32, 64),
    (2, 64, 8, 16, 8, 16),
    (1, 128, 1, 128, 64, 128),
]
# Ragged lengths: the reference's ssd_chunked halves its chunk until it
# divides S (37: 1-token chunks).
RAGGED = [(1, 37, 2, 16, 8, 16), (2, 100, 3, 32, 16, 64)]
REL = 1e-5


def _inputs(Bt, S, H, P, N, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    B = rng.standard_normal((Bt, S, N)).astype(np.float32)
    C = rng.standard_normal((Bt, S, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(np.float32)
    A_log = np.log(rng.uniform(1.0, 8.0, H)).astype(np.float32)
    return x, B, C, dt, A_log


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    return err / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES + RAGGED)
def test_ssd_ref_matches_reference(Bt, S, H, P, N, chunk):
    args = _inputs(Bt, S, H, P, N)
    y, st = ssd_ref(*map(_t, args))
    jy, jst = j_ssd_ref(*map(_j, args))
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (Bt, S, H, P) and tuple(st.shape) == (Bt, H, P,
                                                                   N)
    assert _rel(y, jy) < REL and _rel(st, jst) < REL


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES + RAGGED)
def test_ssd_chunked_matches_reference(Bt, S, H, P, N, chunk):
    args = _inputs(Bt, S, H, P, N)
    y, st = ssd_chunked(*map(_t, args), chunk)
    jy, jst = j_ssd_chunked(*map(_j, args), chunk)
    assert _rel(y, jy) < REL and _rel(st, jst) < REL


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES)
def test_adapter_on_cpu_matches_interpret_kernel(Bt, S, H, P, N, chunk):
    args = _inputs(Bt, S, H, P, N)
    y = ops.ssd_scan(*map(_t, args), chunk=chunk)
    jy = j_ssd_scan(*map(_j, args), chunk=chunk, interpret=True)
    assert y.dtype == torch.float32
    assert np.abs(y.numpy() - np.asarray(jy)).max() < 5e-4 * max(
        1.0, chunk / 64.0)
    y2, st = ops.ssd_scan(*map(_t, args), chunk=chunk, return_state=True)
    assert torch.equal(y2, y) and tuple(st.shape) == (Bt, H, P, N)


def test_bf16_inputs():
    x, B, C, dt, A_log = _inputs(1, 64, 2, 16, 8)
    bf = [_t(v, torch.bfloat16) for v in (x, B, C)]
    y = ops.ssd_scan(*bf, _t(dt), _t(A_log), chunk=32)
    assert y.dtype == torch.bfloat16
    jy_ref, _ = j_ssd_ref(*(_j(v, jnp.bfloat16) for v in (x, B, C)),
                          _j(dt), _j(A_log))
    assert np.abs(y.float().numpy() - np.asarray(jy_ref)).max() < 0.15
    jy = j_ssd_scan(*(_j(v, jnp.bfloat16) for v in (x, B, C)), _j(dt),
                    _j(A_log), chunk=32, interpret=True)
    assert np.abs(y.float().numpy()
                  - np.asarray(jy, np.float32)).max() < 0.15


@pytest.mark.parametrize("S,chunk", [(37, 16), (100, 64), (255, 256),
                                     (257, 256)])
def test_padded_tail_identity(S, chunk):
    """Zero-padding the inputs to a chunk multiple (dt = 0, so a = 0:
    decay 1, no input) changes neither y nor the final state: the CUDA
    kernel keeps the chunk length and pads the ragged last chunk."""
    x, B, C, dt, A_log = _inputs(1, S, 2, 16, 8, seed=S)
    pad = -S % chunk
    padded = [np.concatenate([v, np.zeros((1, pad) + v.shape[2:],
                                          np.float32)], axis=1)
              for v in (x, B, C, dt)]
    y, st = ssd_chunked(*map(_t, padded), _t(A_log), chunk)
    jy, jst = j_ssd_chunked(*map(_j, (x, B, C, dt, A_log)), chunk)
    assert y.shape[1] == S + pad and (S + pad) % chunk == 0
    tol = chunk * 2.0 ** -23
    assert _rel(y[:, :S], jy) < tol and _rel(st, jst) < tol


# ---------------------------------------------------------------------------
# the CUDA bf16 path's three passes, in plain PyTorch
# ---------------------------------------------------------------------------

def _kernel_tol(chunk):
    return 5e-4 * max(1.0, chunk / 64.0)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES + RAGGED)
def test_three_pass_matches_chunked_forms(Bt, S, H, P, N, chunk):
    args = _inputs(Bt, S, H, P, N)
    y, st = ssd_three_pass(*map(_t, args), chunk)
    assert tuple(y.shape) == (Bt, S, H, P) and tuple(st.shape) == (Bt, H, P,
                                                                   N)
    jy, jst = j_ssd_chunked(*map(_j, args), chunk)
    assert _rel(y, jy) < REL and _rel(st, jst) < REL
    py, pst = ssd_chunked(*map(_t, args), chunk)
    assert _rel(y, py) < REL and _rel(st, pst) < REL


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES + RAGGED)
def test_three_pass_matches_sequential_recurrence(Bt, S, H, P, N, chunk):
    args = _inputs(Bt, S, H, P, N)
    y, st = ssd_three_pass(*map(_t, args), chunk)
    for want_y, want_st in (ssd_ref(*map(_t, args)),
                            j_ssd_ref(*map(_j, args))):
        assert _rel(y, want_y) < _kernel_tol(chunk)
        assert _rel(st, want_st) < _kernel_tol(chunk)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", CASES)
def test_three_pass_matches_interpret_kernel(Bt, S, H, P, N, chunk):
    args = _inputs(Bt, S, H, P, N)
    y, _ = ssd_three_pass(*map(_t, args), chunk)
    jy = j_ssd_scan(*map(_j, args), chunk=chunk, interpret=True)
    assert np.abs(y.numpy() - np.asarray(jy)).max() < _kernel_tol(chunk)


# ---------------------------------------------------------------------------
# the card's dispatch, without a card
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


def _card(*arrays):
    return [_t(a).as_subclass(_OnCard) for a in arrays]


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

    monkeypatch.setattr(launcher, "_fn", lambda: fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    launcher.reset_launches()
    return calls


@pytest.mark.parametrize("S,return_state", [(37, True), (512, False)])
def test_card_tensors_launch_the_kernel(fake_launch, S, return_state):
    x, B, C, dt, A_log = _inputs(1, S, 2, 64, 16)
    xbc = np.concatenate([x.reshape(1, S, -1), B, C], axis=-1)
    tx, = _card(xbc)
    # x, B and C as the model slices them out of one xBC tensor
    xh = tx[..., :128].reshape(1, S, 2, 64)
    out = ops.ssd_scan(xh, tx[..., 128:144], tx[..., 144:], *_card(dt),
                       _t(A_log), chunk=256, return_state=return_state)
    assert launcher.LAUNCHES == 1 and len(fake_launch) == 1
    args = fake_launch[0]
    assert args[7:14] == (0, 1, S, 2, 64, 16, 256)   # dtype Bt S H P N Q
    assert args[14:21] == (S * 160, 160, 64, S * 160, 160, S * 160, 160)
    assert (args[6] is not None) == return_state
    y = out[0] if return_state else out
    assert tuple(y.shape) == (1, S, 2, 64) and y.dtype == torch.float32


@pytest.mark.parametrize("P,N,dtype,match", [
    (48, 16, torch.float32, "head dim 48"),
    (64, 256, torch.float32, "state dim 256"),
    (64, 16, torch.float16, "dtype must be float32 or bfloat16"),
])
def test_card_tensors_raise_for_unsupported_shapes(fake_launch, P, N, dtype,
                                                   match):
    x, B, C, dt, A_log = _inputs(1, 8, 2, P, N)
    tx, tb, tc, tdt = (t.to(dtype) if i < 3 else t
                       for i, t in enumerate(_card(x, B, C, dt)))
    with pytest.raises(ValueError, match=match):
        ops.ssd_scan(tx, tb, tc, tdt, _t(A_log))
    assert launcher.LAUNCHES == 0 and not fake_launch


def _xbc_views(S, H, P, N, width_pad=0, dtype=torch.bfloat16):
    """x, B and C as the model slices them out of one (1, S, H P + 2 N)
    xBC tensor on the 'card' (plus ``width_pad`` unused columns)."""
    x, B, C, dt, A_log = _inputs(1, S, H, P, N)
    xbc = np.concatenate([x.reshape(1, S, -1), B, C,
                          np.zeros((1, S, width_pad), np.float32)], axis=-1)
    tx, = _card(xbc)
    tx = tx.to(dtype)
    d = H * P
    return (tx[..., :d].reshape(1, S, H, P), tx[..., d:d + N],
            tx[..., d + N:d + 2 * N], *_card(dt), _t(A_log))


@pytest.mark.parametrize("S,chunk", [(37, 256), (512, 256), (300, 100)])
def test_card_bf16_allocates_scratch_and_counts_calls(fake_launch,
                                                      monkeypatch, S, chunk):
    """The bf16 path's three kernels run over float32 scratch that the
    launcher allocates: the chunks' states (Bt, nc, H, P, N) and decays
    (Bt, nc, H, q_pad); one call counts one launch."""
    H, P, N = 2, 64, 16
    made = []
    empty = torch.empty

    def recording(*args, **kw):
        t = empty(*args, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(launcher.torch, "empty", recording)
    views = _xbc_views(S, H, P, N)
    y, state = ops.ssd_scan(*views, chunk=chunk, return_state=True)
    nc = -(-S // chunk)
    q_pad = -(-chunk // 64) * 64
    assert launcher.scratch_shapes(1, S, H, P, N, chunk) == (
        (1, nc, H, P, N), (1, nc, H, q_pad))
    args = fake_launch[0]
    assert args[7:14] == (1, 1, S, H, P, N, chunk)   # bf16 Bt S H P N Q
    states, acum = (t for t in made if t.dtype == torch.float32
                    and t.dim() in (4, 5) and t.shape[1] == nc
                    and t.data_ptr() in (args[21], args[22]))
    assert tuple(states.shape) == (1, nc, H, P, N) and args[21] == (
        states.data_ptr())
    assert tuple(acum.shape) == (1, nc, H, q_pad) and args[22] == (
        acum.data_ptr())
    assert y.dtype == torch.bfloat16 and tuple(state.shape) == (1, H, P, N)
    assert launcher.LAUNCHES == 1
    ops.ssd_scan(*views, chunk=chunk)
    assert launcher.LAUNCHES == 2 and len(fake_launch) == 2
    assert fake_launch[1][21] is not None and fake_launch[1][6] is None


def test_card_float32_takes_no_scratch(fake_launch):
    views = _xbc_views(64, 2, 16, 8, dtype=torch.float32)
    ops.ssd_scan(*views, chunk=32)
    assert fake_launch[0][7] == 0 and fake_launch[0][21:23] == (None, None)


@pytest.mark.parametrize("what", ["offset", "stride"])
def test_card_bf16_views_must_be_16_byte_aligned(fake_launch, what):
    """The bf16 kernels copy 16-byte pieces: a view that starts off a
    16-byte boundary, or whose row stride is not a multiple of 8 elements,
    raises before any launch."""
    H, P, N = 2, 16, 8
    if what == "stride":   # an xBC row of 49 elements
        views = _xbc_views(40, H, P, N, width_pad=1)
    else:                  # B one element (2 bytes) off its boundary
        views = list(_xbc_views(40, H, P, N, width_pad=8))
        base = views[1]
        views[1] = base.as_strided(base.shape, base.stride(),
                                   base.storage_offset() + 1)
    with pytest.raises(ValueError, match="16 bytes"):
        ops.ssd_scan(*views, chunk=16)
    assert launcher.LAUNCHES == 0 and not fake_launch

"""The port's batched flex_score picks against the JAX reference, bit for bit.

The same numpy inputs go through the reference's batched argmax and top-K
as its jitted code runs them (``pick_node_batch_ref`` and
``pick_node_batch_topk_ref`` under ``jax.jit``) and through its
interpret-mode Pallas kernels with the cross-tile merge of ``ops.py``
(``flex_pick_node_batch``/``flex_pick_node_batch_topk`` with
``interpret=True``), and through the port's plain versions and
dispatching wrappers on CPU tensors.  Indices, score bits and
any_feasible must be equal.

Each node count N runs four (Q, K) pairs, (1, 1), (7, 4), (8, 8) and
(33, N + 3), over six kinds of queue.  The interpret-mode kernels, which
compile per shape and unroll one peel per slot, run at Q = 33 with
K = min(8, N + 3).

The reference's two batched paths disagree with each other in one place:
XLA contracts ``w_load * max + w_src * src_frac`` into one fused
multiply-add in both, but in the interpret-mode kernel it fuses the
``w_src * src_frac`` product instead of the ``w_load * max`` one at some
shapes (N = 513 and 1000 here), so with per-task weights other than +-1
("weights") some scores differ in the last bit.  The port contracts as
the jitted ``pick_node_batch_ref`` (the path the reference's wavefront
admission runs off the TPU) and the per-task kernel do; against the
interpret-mode kernel the "weights" case holds indices and feasibility,
the others score bits as well.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them bit-equal
to the plain versions on the card.  The wrappers' checks and the dispatch
by device are tested here.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.flex_score import ops as jax_ops
from repro.kernels.flex_score.ref import pick_node_batch_ref as jax_batch_ref
from repro.kernels.flex_score.ref import \
    pick_node_batch_topk_ref as jax_topk_ref
from repro_torch.kernels.flex_score import flex_score as fs
from repro_torch.kernels.flex_score.ops import (flex_pick_node_batch,
                                                flex_pick_node_batch_topk)
from repro_torch.kernels.flex_score.ref import (NEG_INF, pick_node_batch_ref,
                                                pick_node_batch_topk_ref,
                                                pick_node_ref)

SIZES = [1, 5, 100, 512, 513, 1000]
CASES = ["random", "ties", "infeasible", "cap_below_one", "best_fit",
         "weights"]
INTERPRET_Q = 33

_jax_batch = jax.jit(jax_batch_ref)
_jax_topk = jax.jit(jax_topk_ref, static_argnames="k")

# The tensors here are tiny: one intra-op thread is fastest, and keeps
# PyTorch's pool from contending with XLA's in the same process.
torch.set_num_threads(1)


def _pairs(n):
    return [(1, 1), (7, 4), (8, 8), (INTERPRET_Q, n + 3)]


def _inputs(n, q, case, seed):
    """est, reserved (N, 2); src_frac (Q, N); r (Q, 2); penalty, cap,
    w_load, w_src (Q,); all float32."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    est = f32(rng.random((n, 2)) * 0.8)
    res = f32(rng.random((n, 2)) * 0.1)
    src = f32(rng.random((q, n)))
    r = f32(rng.random((q, 2)) * 0.2)
    penalty = f32(1.0 + rng.random(q))
    cap, w_load, w_src = f32(np.ones(q)), f32(np.ones(q)), f32(
        np.full(q, 0.25))
    if case == "ties":
        # quarter steps and one penalty: many nodes share a score exactly
        est = f32(np.floor(est * 5) / 4)
        res = np.zeros_like(res)
        src = f32(np.floor(src * 2) / 2)
        penalty = f32(np.ones(q))
    elif case == "infeasible":
        r = f32(r + 2.0)
    elif case == "cap_below_one":
        cap = f32(np.full(q, 0.6))
    elif case == "best_fit":
        w_load, w_src = f32(np.full(q, -1.0)), f32(np.zeros(q))
    elif case == "weights":
        w_load = f32(0.5 + rng.random(q))
        w_src = f32(rng.random(q))
    return est, res, src, r, penalty, cap, w_load, w_src


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _assert_same(got, want, score_bits=True):
    """(idx, score, any) triples, the first as torch, the second as JAX."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if score_bits:
        np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32


def _port(fn, arrays, **kw):
    est, res, src, r, penalty, cap, w_load, w_src = map(torch.from_numpy,
                                                        arrays)
    if fn is pick_node_batch_ref or fn is pick_node_batch_topk_ref:
        return fn(est, res, src, r, penalty, w_load, w_src, cap, **kw)
    return fn(est, res, src, r, penalty, w_load=w_load, w_src=w_src,
              cap=cap, **kw)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_batch_pick_bit_equal_to_jax(n, case):
    for seed, (q, _) in enumerate(_pairs(n)):
        arrays = _inputs(n, q, case, seed)
        est, res, src, r, penalty, cap, w_load, w_src = arrays
        want = _jax_batch(est, res, src, r, penalty, w_load, w_src, cap)
        got_ref = _port(pick_node_batch_ref, arrays)
        got_ops = _port(flex_pick_node_batch, arrays)
        for got in (got_ref, got_ops):
            _assert_same(got, want)
        if q == INTERPRET_Q:
            _assert_same(got_ref, jax_ops.flex_pick_node_batch(
                est, res, src, r, penalty, w_load=w_load, w_src=w_src,
                cap=cap, interpret=True), score_bits=case != "weights")
        # each row is the per-task decision
        t = [torch.from_numpy(a) for a in arrays]
        for row in range(q):
            idx, best, ok = pick_node_ref(t[0], t[1], t[2][row], t[3][row],
                                          t[4][row], t[6][row], t[7][row],
                                          cap=t[5][row])
            assert int(idx) == int(got_ref[0][row])
            assert _bits(best.numpy()) == _bits(got_ref[1][row].numpy())
            assert bool(ok) == bool(got_ref[2][row])
        if case == "infeasible":
            assert (got_ref[0] == -1).all() and not got_ref[2].any()
            assert (got_ref[1] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_batch_topk_bit_equal_to_jax(n, case):
    for seed, (q, k) in enumerate(_pairs(n)):
        arrays = _inputs(n, q, case, seed)
        est, res, src, r, penalty, cap, w_load, w_src = arrays
        want = _jax_topk(est, res, src, r, penalty, w_load, w_src, cap, k=k)
        got_ref = _port(pick_node_batch_topk_ref, arrays, k=k)
        got_ops = _port(flex_pick_node_batch_topk, arrays, k=k)
        for got in (got_ref, got_ops):
            assert got[0].shape == (q, k) and got[1].shape == (q, k)
            _assert_same(got, want)
        if q == INTERPRET_Q:
            k_int = min(8, n + 3)
            _assert_same(
                _port(pick_node_batch_topk_ref, arrays, k=k_int),
                jax_ops.flex_pick_node_batch_topk(
                    est, res, src, r, penalty, w_load=w_load, w_src=w_src,
                    cap=cap, k=k_int, interpret=True),
                score_bits=case != "weights")
        # K = 1 is the batched argmax; every row is sorted (score desc,
        # node asc) and its empty slots are (-1, NEG_INF)
        one = _port(pick_node_batch_topk_ref, arrays, k=1)
        pick = _port(pick_node_batch_ref, arrays)
        assert torch.equal(one[0][:, 0], pick[0])
        assert torch.equal(one[1][:, 0], pick[1])
        idx, score = got_ref[0], got_ref[1]
        empty = idx < 0
        assert (score[empty] == np.float32(NEG_INF)).all()
        assert (score[~empty] > NEG_INF / 2).all()
        later = score[:, 1:]
        assert (later <= score[:, :-1]).all()
        tie = (later == score[:, :-1]) & ~empty[:, 1:]
        assert (idx[:, 1:][tie] > idx[:, :-1][tie]).all()
        if k > n:
            assert (idx[:, n:] == -1).all()


def test_topk_orders_ties_by_index_and_pads_past_n():
    # nodes 1, 2 and 4 tie; node 3 is better; node 0 does not fit
    est = torch.tensor([[0.95, 0.0], [0.5, 0.0], [0.5, 0.1],
                        [0.25, 0.0], [0.5, 0.5]])
    res = torch.zeros(5, 2)
    src = torch.zeros(1, 5)
    one = lambda v: torch.tensor([v])
    idx, score, ok = pick_node_batch_topk_ref(
        est, res, src, torch.full((1, 2), 0.1), one(1.0), one(1.0),
        one(0.25), one(1.0), k=7)
    assert idx.tolist() == [[3, 1, 2, 4, -1, -1, -1]]
    assert score[0, :4].tolist() == [-0.25, -0.5, -0.5, -0.5]
    assert (score[0, 4:] == np.float32(NEG_INF)).all() and bool(ok[0])


def test_batch_wrappers_reject_cpu_tensors():
    # The CUDA wrappers never compute on the CPU: they raise before they
    # build or launch anything, and count no launch.
    before = (fs.BATCH_LAUNCHES, fs.TOPK_LAUNCHES)
    args = (torch.zeros(4, 2), torch.zeros(4, 2), torch.zeros(3, 4),
            torch.zeros(3, 6))
    with pytest.raises(ValueError, match="must be on"):
        fs.flex_score_batch_pick(*args)
    with pytest.raises(ValueError, match="must be on"):
        fs.flex_score_batch_topk(*args, 8)
    with pytest.raises(ValueError, match="k must be"):
        fs.flex_score_batch_topk(*args, 0)
    assert (fs.BATCH_LAUNCHES, fs.TOPK_LAUNCHES) == before


def test_batch_dispatch_checks_shapes_and_devices():
    est = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="src_frac"):
        flex_pick_node_batch(est, est, torch.zeros(4, 3), torch.zeros(3, 2),
                             1.0, w_load=1.0, w_src=0.25, cap=1.0)
    meta = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flex_pick_node_batch_topk(meta, meta, torch.zeros(3, 4, device="meta"),
                                  torch.zeros(3, 2, device="meta"), 1.0,
                                  w_load=1.0, w_src=0.25, cap=1.0, k=2)


def test_cpu_dispatch_broadcasts_scalars_without_launching():
    before = (fs.BATCH_LAUNCHES, fs.TOPK_LAUNCHES)
    gen = torch.Generator().manual_seed(0)
    est = torch.rand(50, 2, generator=gen)
    src = torch.rand(6, 50, generator=gen)
    r = torch.full((6, 2), 0.1)
    got = flex_pick_node_batch_topk(est, torch.zeros(50, 2), src, r, 1.2,
                                    w_load=1.0, w_src=0.25, cap=1.0, k=3)
    full = lambda v: torch.full((6,), v)
    want = pick_node_batch_topk_ref(est, torch.zeros(50, 2), src, r,
                                    full(1.2), full(1.0), full(0.25),
                                    full(1.0), 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (fs.BATCH_LAUNCHES, fs.TOPK_LAUNCHES) == before

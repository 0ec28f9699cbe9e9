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
                                                pick_node_batch_split,
                                                pick_node_batch_topk_ref,
                                                pick_node_batch_topk_split,
                                                pick_node_ref)

SIZES = [1, 5, 100, 512, 513, 1000]
CASES = ["random", "ties", "infeasible", "cap_below_one", "best_fit",
         "weights", "fault_offset"]
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
    elif case == "fault_offset":
        # the simulator's fault offsets on the reserved rows (about 30%
        # down or draining at DRAIN_LOAD, 20% flapped to half capacity)
        # and flex-brownout's per-task caps (production 1, batch below)
        kind = rng.random(n)
        res = f32(res + np.where(kind < 0.3, 1e6,
                                 np.where(kind < 0.5, 1 - 0.5, 0))[:, None])
        cap = f32(np.where(rng.random(q) < 0.5, 1.0, 0.7))
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
        if case == "fault_offset":
            # a node at DRAIN_LOAD never wins
            drained = torch.from_numpy(res[:, 0] >= 1e6)
            picked = got_ref[0][got_ref[0] >= 0].long()
            assert not drained[picked].any()


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


# ---------------------------------------------------------------------------
# The CUDA kernels' split-and-merge algebra (``pick_node_batch_split`` and
# ``pick_node_batch_topk_split``): per-chunk partials merged by (score desc,
# node asc), the top-K in passes of ``pass_slots`` slots.  Held bit-equal
# to the plain versions and to the reference, jitted and interpret-mode.
# ---------------------------------------------------------------------------

# name -> (N, Q, K, input case, chunk sizes besides the launcher's plan)
SPLIT_CASES = {
    # quarter-step scores: equal scores on both sides of chunk boundaries
    "ties_across_chunks": (64, 7, 8, "ties", (4, 8, 12)),
    # cap < 1 leaves a chunk of 4 or 8 nodes fewer than K feasible ones
    "chunks_short_of_k": (100, 7, 8, "cap_below_one", (4, 8)),
    "k_over_n": (5, 7, 12, "random", (4,)),
    "k_40_two_passes": (100, 7, 40, "ties", (4, 12, 52)),
    "n_mod_4": (513, INTERPRET_Q, 8, "weights", (4, 12)),
    "n_2_replicas": (2, 7, 8, "random", (4,)),
    # DRAIN_LOAD rows on both sides of the chunk boundaries
    "fault_offset_rows": (100, 7, 8, "fault_offset", (4, 8)),
}


def _split_chunks(n, q, extra):
    return sorted({fs.batch_plan(n, q)[0], *extra})


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_pick_bit_equal(name):
    n, q, _, case, extra = SPLIT_CASES[name]
    arrays = _inputs(n, q, case, seed=7)
    est, res, src, r, penalty, cap, w_load, w_src = arrays
    want = _jax_batch(est, res, src, r, penalty, w_load, w_src, cap)
    plain = _port(pick_node_batch_ref, arrays)
    for chunk in _split_chunks(n, q, extra):
        got = _port(pick_node_batch_split, arrays, chunk=chunk)
        _assert_same(got, want)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    if q == INTERPRET_Q:
        _assert_same(plain, jax_ops.flex_pick_node_batch(
            est, res, src, r, penalty, w_load=w_load, w_src=w_src, cap=cap,
            interpret=True), score_bits=case != "weights")


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_topk_bit_equal(name):
    n, q, k, case, extra = SPLIT_CASES[name]
    arrays = _inputs(n, q, case, seed=8)
    est, res, src, r, penalty, cap, w_load, w_src = arrays
    want = _jax_topk(est, res, src, r, penalty, w_load, w_src, cap, k=k)
    plain = _port(pick_node_batch_topk_ref, arrays, k=k)
    for chunk in _split_chunks(n, q, extra):
        # the kernels' passes of 32 slots, and passes of 3 to stress the
        # "strictly after the last pair written" rule
        for slots in (32, 3):
            got = _port(pick_node_batch_topk_split, arrays, k=k, chunk=chunk,
                        pass_slots=slots)
            _assert_same(got, want)
            for a, b in zip(got, plain):
                assert torch.equal(a, b)
    if q == INTERPRET_Q:
        _assert_same(plain, jax_ops.flex_pick_node_batch_topk(
            est, res, src, r, penalty, w_load=w_load, w_src=w_src, cap=cap,
            k=k, interpret=True), score_bits=case != "weights")
    if name == "ties_across_chunks":
        # the case is what it says: some row's top K holds equal scores on
        # both sides of a boundary of 4-node chunks
        idx, score = plain[0].numpy(), plain[1].numpy()
        straddles = [
            (i, j) for row in range(q) for i in range(k) for j in range(i)
            if idx[row, i] >= 0 and score[row, i] == score[row, j]
            and idx[row, i] // 4 != idx[row, j] // 4]
        assert straddles
    if name == "chunks_short_of_k":
        # rows with K feasible nodes, whose 8-node chunks hold fewer
        full = _port(pick_node_batch_topk_ref, arrays, k=n)[0].numpy()
        feasible = np.zeros((q, n), bool)
        for row in range(q):
            feasible[row, full[row][full[row] >= 0]] = True
        per_chunk = np.stack([feasible[:, lo:lo + 8].sum(1)
                              for lo in range(0, n, 8)], axis=1)
        rows = feasible.sum(1) >= k
        assert rows.any() and ((per_chunk[rows] > 0)
                               & (per_chunk[rows] < k)).any()


# ---------------------------------------------------------------------------
# The launchers on "card" tensors, with the ctypes calls faked: the plan,
# the scratch, the handles, the counts and the raises.
# ---------------------------------------------------------------------------

# (Q, N) -> (chunk, splits, blocks): split only where Q cannot fill the
# card, each chunk a multiple of 4 nodes and at least 256 (32 at most).
PLANS = {
    (1, 2): (4, 1, 1), (1, 4000): (252, 16, 2), (1, 4097): (244, 17, 3),
    (1, 100000): (3128, 32, 4),
    (33, 2): (4, 1, 5), (33, 4000): (252, 16, 66), (33, 4097): (244, 17, 71),
    (33, 100000): (3128, 32, 132),
    (64, 2): (4, 1, 8), (64, 4000): (252, 16, 128),
    (64, 4097): (244, 17, 136), (64, 100000): (3128, 32, 256),
    (4096, 2): (4, 1, 512), (4096, 4000): (4000, 1, 512),
    (4096, 4097): (4100, 1, 512), (4096, 100000): (100000, 1, 512),
}


@pytest.mark.parametrize("q,n", sorted(PLANS))
def test_batch_plan(q, n):
    chunk, splits, blocks = fs.batch_plan(n, q)
    assert (chunk, splits, blocks) == PLANS[q, n]
    assert chunk % 4 == 0 and (splits - 1) * chunk < n <= splits * chunk
    assert blocks == -(-q * splits // fs.WARPS)
    assert splits == 1 or q * splits <= fs.FILL_WARPS + q
    assert splits <= fs.MAX_SPLITS


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


class _FakeBatchLib:
    """Stands in for the built library: records each call and each lookup
    of an entry point."""

    def __init__(self, max_r=16):
        self.calls, self.lookups = [], []
        self._max_r = max_r

    def _record(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn

    def __getattr__(self, name):
        if not name.startswith("flex_score_batch"):
            raise AttributeError(name)
        self.lookups.append(name)
        if name == "flex_score_batch_max_r":
            return lambda: self._max_r
        if name == "flex_score_batch_pass_slots":
            return lambda: 32
        return self._record(name)


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeBatchLib()

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fs._build, "load", lambda name: lib)
    monkeypatch.setattr(fs, "_BATCH", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    fs.reset_launches()
    return lib


def _card_inputs(n, q, r=2):
    gen = torch.Generator().manual_seed(n + q)
    make = lambda *shape: torch.rand(shape, generator=gen).as_subclass(
        _OnCard)
    return make(n, r), make(n, r), make(q, n), make(q, r + 4)


def _recording_empty(monkeypatch):
    made = []
    empty = torch.empty

    def recording(*args, **kw):
        t = empty(*args, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(fs.torch, "empty", recording)
    return made


@pytest.mark.parametrize("n,q", [(2, 3), (4097, 2), (300, 4096)])
def test_card_pick_passes_the_plan_and_scratch(fake_lib, monkeypatch, n, q):
    made = _recording_empty(monkeypatch)
    idx, score = fs.flex_score_batch_pick(*_card_inputs(n, q))
    chunk, splits, _ = fs.batch_plan(n, q)
    (name, args), = fake_lib.calls
    assert name == "flex_score_batch_pick"
    assert args[4:8] == (n, 2, q, chunk)        # n r q chunk
    part_s, part_i = args[8:10]
    if splits == 1:
        assert part_s is None and part_i is None
    else:
        s, i = (next(t for t in made if t.data_ptr() == p)
                for p in (part_s, part_i))
        assert tuple(s.shape) == tuple(i.shape) == (q, splits, 1)
        assert s.dtype == torch.float32 and i.dtype == torch.int32
    assert args[10:12] == (score.data_ptr(), idx.data_ptr())
    assert tuple(idx.shape) == (q,) and fs.BATCH_LAUNCHES == 1


@pytest.mark.parametrize("k", [1, 8, 32, 33, 40, 65])
def test_card_topk_scratch_and_count_per_pass(fake_lib, monkeypatch, k):
    made = _recording_empty(monkeypatch)
    n, q = 4000, 33
    idx, score = fs.flex_score_batch_topk(*_card_inputs(n, q), k)
    chunk, splits, _ = fs.batch_plan(n, q)
    (name, args), = fake_lib.calls   # one C call runs every pass
    assert name == "flex_score_batch_topk"
    assert args[4:9] == (n, 2, q, k, chunk)
    s, i = (next(t for t in made if t.data_ptr() == p) for p in args[9:11])
    assert tuple(s.shape) == tuple(i.shape) == (q, splits, min(k, 32))
    assert args[11:13] == (score.data_ptr(), idx.data_ptr())
    assert tuple(idx.shape) == (q, k)
    assert fs.TOPK_LAUNCHES == -(-k // 32) and fs.BATCH_LAUNCHES == 0


def test_card_handles_are_looked_up_once(fake_lib):
    inputs = _card_inputs(100, 5)
    for _ in range(3):
        fs.flex_score_batch_pick(*inputs)
        fs.flex_score_batch_topk(*inputs, 8)
    assert sorted(fake_lib.lookups) == sorted([
        "flex_score_batch_pick", "flex_score_batch_topk",
        "flex_score_batch_max_r", "flex_score_batch_pass_slots"])
    assert len(fake_lib.calls) == 6
    assert (fs.BATCH_LAUNCHES, fs.TOPK_LAUNCHES) == (3, 3)


def test_card_rejects_too_many_resources_and_mixed_devices(fake_lib):
    est, res, src, mat = _card_inputs(64, 4, r=17)
    with pytest.raises(ValueError, match="at most 16 resources"):
        fs.flex_score_batch_pick(est, res, src, mat)
    with pytest.raises(ValueError, match="at most 16 resources"):
        fs.flex_score_batch_topk(est, res, src, mat, 8)
    est, res, src, mat = _card_inputs(64, 4)
    with pytest.raises(ValueError, match="src_frac must be on"):
        fs.flex_score_batch_pick(est, res, src.as_subclass(torch.Tensor), mat)
    with pytest.raises(ValueError, match="task_mat must be on"):
        fs.flex_score_batch_topk(est, res, src, mat.as_subclass(torch.Tensor),
                                 8)
    assert not fake_lib.calls
    assert (fs.BATCH_LAUNCHES, fs.TOPK_LAUNCHES) == (0, 0)

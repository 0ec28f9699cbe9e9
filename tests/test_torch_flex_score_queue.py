"""The port's queue admission (``admit_queue_ref``, the queue kernel's plain
version) against the JAX reference, bit for bit.

The same numpy node state and queue go through the reference's sequential
scan, ``repro.api.admission.admit_queue(use_kernel=True, interpret=True)``
jitted (a ``lax.scan`` over ``admit_one`` with the interpret-mode Pallas
pick in its body), and through the port's ``admit_queue_ref`` fed by the
policy's ``queue_kernel_rows`` hook.  Placements and all five
``NodeState`` leaves must be bit-equal.

The CUDA queue kernel cannot run here; ``chip_smoke.py`` holds it
bit-equal to ``admit_queue_ref`` on the card.  What surrounds it (the
hook, dispatch by device, the launcher's plan, checks and raises) is
tested here, the launcher on "card" tensors with the library faked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import admission as j_adm
from repro.api import get_policy as j_get_policy
from repro.core.types import FlexParams as JFlexParams
from repro.core.types import NodeState as JNodeState
from repro_torch.api import admission, get_policy, policy_prepare_params
from repro_torch.core.types import NUM_SRC_BUCKETS, FlexParams, NodeState
from repro_torch.kernels.flex_score import flex_score as fs
from repro_torch.kernels.flex_score import ops
from repro_torch.kernels.flex_score.ref import admit_queue_ref, src_share

HOOKED = ["flex-f", "flex-l", "best-fit-usage", "flex-priority", "reclaim"]
CASES = ["random", "tied", "infeasible"]

# The tensors here are tiny: one intra-op thread is fastest, and keeps
# PyTorch's pool from contending with XLA's in the same process.
torch.set_num_threads(1)


def _state(n, r, case, seed):
    rng = np.random.default_rng(seed)
    s = dict(
        est_usage=(rng.random((n, r)) * 0.5).astype(np.float32),
        reserved=(rng.random((n, r)) * 0.1).astype(np.float32),
        requested=(rng.random((n, r)) * 0.9).astype(np.float32),
        n_tasks=rng.integers(0, 6, n).astype(np.int32),
        src_count=rng.integers(0, 3, (n, NUM_SRC_BUCKETS)).astype(np.int32))
    if case == "tied":
        # quarter steps and no history: many nodes share a score exactly
        s["est_usage"] = (np.floor(s["est_usage"] * 8) / 8).astype(np.float32)
        s["reserved"] = np.zeros_like(s["reserved"])
        s["n_tasks"] = np.zeros_like(s["n_tasks"])
        s["src_count"] = np.zeros_like(s["src_count"])
    return s


def _queue(q, r, case, seed):
    rng = np.random.default_rng(seed + 1)
    reqs = (rng.random((q, r)) * 0.2).astype(np.float32)
    if case == "tied":
        reqs = (np.floor(reqs * 20) / 40).astype(np.float32)
    if case == "infeasible":
        reqs = reqs + np.float32(2.0)           # fits nowhere
    srcs = rng.integers(0, 8, q).astype(np.int32)   # few sources: repeats
    prios = rng.integers(0, 3, q).astype(np.int32)  # mixed classes
    valid = rng.random(q) < 0.8
    return reqs, srcs, prios, valid


def _params(name):
    jpol, tpol = j_get_policy(name), get_policy(name)
    jp = jpol.prepare_params(JFlexParams.default())
    return jpol, tpol, jp, policy_prepare_params(
        tpol, FlexParams.default(device="cpu"))


_JAX_ADMIT = {}


def _jax_admit(name):
    fn = _JAX_ADMIT.get(name)
    if fn is None:
        jpol, _, jp, _ = _params(name)
        fn = _JAX_ADMIT[name] = jax.jit(lambda node, *xs: j_adm.admit_queue(
            jpol, node, *xs, jp, use_kernel=True, interpret=True))
    return fn


def _port_admit(name, state, reqs, srcs, prios, valid, penalty):
    """The hook's rows through admit_queue_ref, on a copy of ``state``."""
    _, tpol, _, tp = _params(name)
    node = NodeState(**{k: torch.from_numpy(v.copy())
                        for k, v in state.items()})
    tasks = admission.TaskView(*map(torch.from_numpy, (reqs, srcs, prios)))
    ctx = admission.PolicyContext(node=node, penalty=torch.tensor(penalty),
                                  params=tp)
    rows = tpol.queue_kernel_rows(ctx, tasks)
    placements = admit_queue_ref(node.est_usage, node.reserved,
                                 node.requested, node.n_tasks,
                                 node.src_count, rows, tasks.src,
                                 torch.from_numpy(valid))
    return node, placements


def _assert_bit_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("q", [0, 1, 33])
@pytest.mark.parametrize("n", [7, 64, 513])
@pytest.mark.parametrize("name", HOOKED)
def test_admit_queue_ref_bit_equal_to_jax_scan(name, n, q, r):
    penalty = np.float32(1.25)
    placed = 0
    for k, case in enumerate(CASES):
        state = _state(n, r, case, seed=n + 10 * q + k)
        queue = _queue(q, r, case, seed=n + 10 * q + k)
        j_node, j_pl = _jax_admit(name)(
            JNodeState(**{f: jnp.asarray(v) for f, v in state.items()}),
            *queue, penalty)
        t_node, t_pl = _port_admit(name, state, *queue, penalty)
        _assert_bit_equal(t_pl.numpy(), j_pl, f"{case}: placements")
        for field in NodeState._fields:
            _assert_bit_equal(getattr(t_node, field).numpy(),
                              getattr(j_node, field), f"{case}: {field}")
        if case == "infeasible":
            assert (t_pl.numpy() == -1).all()
        placed += int((t_pl >= 0).sum())
    if q == 33:
        assert placed > 0


@pytest.mark.parametrize("n", [64, 513])
@pytest.mark.parametrize("name", HOOKED + ["flex-brownout", "migrate"])
def test_admit_queue_ref_on_fault_offset_rows(name, n):
    """The simulator's fault offsets on the node table (about 30% of the
    rows at DRAIN_LOAD, 20% flapped to half capacity) and, for
    flex-brownout, per-task caps (production 1, batch below 1 at this
    penalty): bit-equal to the reference's scan, a drained row keeps its
    reserved value exactly and takes no task."""
    rng = np.random.default_rng(n)
    state = _state(n, 2, "random", seed=n)
    kind = rng.random(n)
    offset = np.where(kind < 0.3, np.float32(admission.DRAIN_LOAD),
                      np.where(kind < 0.5, np.float32(1 - 0.5),
                               np.float32(0))).astype(np.float32)
    state["reserved"] = state["reserved"] + offset[:, None]
    queue = _queue(33, 2, "random", seed=n)
    penalty = np.float32(1.8)
    j_node, j_pl = _jax_admit(name)(
        JNodeState(**{f: jnp.asarray(v) for f, v in state.items()}),
        *queue, penalty)
    t_node, t_pl = _port_admit(name, state, *queue, penalty)
    _assert_bit_equal(t_pl.numpy(), j_pl, "placements")
    for field in NodeState._fields:
        _assert_bit_equal(getattr(t_node, field).numpy(),
                          getattr(j_node, field), field)
    drained = kind < 0.3
    placed = t_pl.numpy()[t_pl.numpy() >= 0]
    assert len(placed) > 0 and not drained[placed].any()
    np.testing.assert_array_equal(t_node.reserved.numpy()[drained],
                                  state["reserved"][drained])


def _random_node(n, seed):
    gen = torch.Generator().manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen)
    return NodeState(u(n, 2) * 0.5, u(n, 2) * 0.1, u(n, 2) * 0.9,
                     (u(n) * 8).to(torch.int32),
                     (u(n, NUM_SRC_BUCKETS) * 3).to(torch.int32)), u


@pytest.mark.parametrize("name", HOOKED)
def test_queue_rows_and_src_share_equal_kernel_inputs(name):
    # The hook's row q and the queue kernel's src_frac equal the policy's
    # kernel_inputs for task q, field for field, so the two cannot drift.
    _, tpol, _, tp = _params(name)
    for seed in range(3):
        node, u = _random_node(50, seed)
        q = 17
        reqs = u(q, 2) * 0.2
        srcs = (u(q) * NUM_SRC_BUCKETS).to(torch.int32)
        prios = (u(q) * 3).to(torch.int32)
        ctx = admission.PolicyContext(node=node, penalty=1.0 + u(),
                                      params=tp)
        rows = tpol.queue_kernel_rows(ctx, admission.TaskView(reqs, srcs,
                                                              prios))
        assert rows.dtype == torch.float32 and rows.shape == (q, 6)
        assert rows.is_contiguous()
        for k in range(q):
            ki = tpol.kernel_inputs(ctx, admission.TaskView(reqs[k], srcs[k],
                                                            prios[k]))
            assert ki.est_usage is node.est_usage
            assert ki.reserved is node.reserved
            want = torch.stack([reqs[k, 0], reqs[k, 1], ki.penalty, ki.cap,
                                ki.w_load, ki.w_src]).to(torch.float32)
            _assert_bit_equal(rows[k].numpy(), want.numpy(), f"row {k}")
            _assert_bit_equal(
                src_share(node.n_tasks, node.src_count, srcs[k]).numpy(),
                ki.src_frac.numpy(), f"src_frac {k}")


def _admit_one_loop(policy, node, reqs, srcs, prios, valid, penalty, params):
    node = NodeState(*(x.clone() for x in node))
    out = []
    for k in range(reqs.shape[0]):
        ctx = admission.PolicyContext(node=node, penalty=penalty,
                                      params=params)
        node, idx = admission.admit_one(
            policy, ctx, admission.TaskView(reqs[k], srcs[k], prios[k]),
            valid[k], use_kernel=True)
        out.append(idx)
    return node, torch.stack(out)


@pytest.mark.parametrize("name", HOOKED)
def test_cpu_admit_queue_runs_plain_queue_and_equals_admit_one_loop(
        name, monkeypatch):
    calls = []
    plain = ops.admit_queue_ref

    def counting(*args):
        calls.append(args[5].shape[0])
        return plain(*args)

    monkeypatch.setattr(ops, "admit_queue_ref", counting)
    _, tpol, _, tp = _params(name)
    node, u = _random_node(40, 7)
    q = 30
    reqs, srcs = u(q, 2) * 0.2, (u(q) * 8).to(torch.int32)
    prios, valid = (u(q) * 3).to(torch.int32), u(q) < 0.8
    penalty = torch.tensor(1.3)
    fs.reset_launches()
    admission.reset_decisions()
    got_node, got = admission.admit_queue(tpol, node, reqs, srcs, prios,
                                          valid, penalty, tp,
                                          use_kernel=True)
    assert calls == [q]
    assert (admission.DECISIONS, admission.QUEUES) == (q, 1)
    assert fs.LAUNCHES == fs.QUEUE_LAUNCHES == 0
    want_node, want = _admit_one_loop(tpol, node, reqs, srcs, prios, valid,
                                      penalty, tp)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert (got >= 0).any() and (got < 0).any()
    for field in NodeState._fields:
        _assert_bit_equal(getattr(got_node, field).numpy(),
                          getattr(want_node, field).numpy(), field)
    # the caller's node state is not modified
    assert not torch.equal(node.reserved, got_node.reserved)
    _, empty = admission.admit_queue(tpol, node, reqs[:0], srcs[:0],
                                     prios[:0], valid[:0], penalty, tp,
                                     use_kernel=True)
    assert empty.shape == (0,) and admission.QUEUES == 1


def test_policies_without_the_hook_keep_their_paths(monkeypatch):
    monkeypatch.setattr(ops, "admit_queue_ref", None)   # must not be taken
    node, u = _random_node(20, 3)
    reqs, srcs = u(5, 2) * 0.2, (u(5) * 8).to(torch.int32)
    prios = torch.zeros(5, dtype=torch.int32)
    valid = torch.ones(5, dtype=torch.bool)
    tp = FlexParams.default(device="cpu")
    for name in ("least-fit", "oversub"):
        _, pl = admission.admit_queue(get_policy(name), node, reqs, srcs,
                                      prios, valid, torch.tensor(1.0), tp,
                                      use_kernel=True)
        assert pl.shape == (5,)
    _, pl = admission.admit_queue(get_policy("flex-f"), node, reqs, srcs,
                                  prios, valid, torch.tensor(1.0), tp)
    assert pl.shape == (5,)      # use_kernel=False: the plain hooks


# ---------------------------------------------------------------------------
# The launcher on "card" tensors, with the ctypes calls faked.
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


class _FakeAdmitLib:
    def __init__(self, ret=0):
        self.calls, self.lookups, self.ret = [], [], ret

    def __getattr__(self, name):
        if not name.startswith("flex_score_admit"):
            raise AttributeError(name)
        self.lookups.append(name)
        if name == "flex_score_admit_cluster":
            return lambda: fs.ADMIT_CLUSTER
        if name == "flex_score_admit_max_r":
            return lambda: fs.ADMIT_MAX_R

        def fn(*args):
            self.calls.append(args)
            return self.ret
        return fn


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeAdmitLib()

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fs._build, "load", lambda name: lib)
    monkeypatch.setattr(fs, "_ADMIT", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    fs.reset_launches()
    return lib


def _card_args(n, q, r=2):
    gen = torch.Generator().manual_seed(n + q)
    card = lambda t: t.as_subclass(_OnCard)
    f = lambda *shape: card(torch.rand(shape, generator=gen))
    i = lambda *shape: card(torch.zeros(shape, dtype=torch.int32))
    return [f(n, r), f(n, r), f(n, r), i(n), i(n, NUM_SRC_BUCKETS),
            f(q, r + 4), i(q), card(torch.ones(q, dtype=torch.bool))]


# N -> (rows, src_count on chip, shared memory per CTA) at R = 2: 276 bytes
# a node with src_count, 20 without, beside 640 of the kernel's own.
PLANS = {1: (1, True, 916), 7: (1, True, 916), 4000: (250, True, 69640),
         4097: (257, True, 71572), 13424: (839, True, 232204),
         13425: (840, False, 17440), 100000: (6250, False, 125640),
         185440: (11590, False, 232440)}


@pytest.mark.parametrize("n", sorted(PLANS))
def test_admit_plan(n):
    rows, on_chip, smem = fs.admit_plan(n, 2)
    assert (rows, on_chip, smem) == PLANS[n]
    assert (rows - 1) * fs.ADMIT_CLUSTER < n <= rows * fs.ADMIT_CLUSTER
    assert smem <= fs.ADMIT_SMEM


def test_admit_plan_raises_past_the_limit():
    with pytest.raises(ValueError, match="at most 185440 nodes at R = 2"):
        fs.admit_plan(185441, 2)
    with pytest.raises(ValueError, match="at most 54528 nodes at R = 8"):
        fs.admit_plan(54529, 8)
    assert fs.admit_plan(54528, 8)[1] is False
    assert fs.admit_plan(309072, 1) == (19317, False, 640 + 19317 * 12)


@pytest.mark.parametrize("n,q", [(7, 1), (4000, 33), (100000, 4096)])
def test_card_launch_passes_the_plan_and_counts_once(fake_lib, n, q):
    args = _card_args(n, q)
    placements = fs.flex_score_admit(*args)
    (call,) = fake_lib.calls
    rows, on_chip, smem = fs.admit_plan(n, 2)
    assert call[:8] == tuple(t.data_ptr() for t in args)
    assert call[8:14] == (n, 2, q, rows, int(on_chip), smem)
    assert call[14] == placements.data_ptr()
    assert placements.dtype == torch.int32 and placements.shape == (q,)
    assert fs.QUEUE_LAUNCHES == 1 and fs.LAUNCHES == 0
    fs.flex_score_admit(*args)
    assert sorted(set(fake_lib.lookups)) == [
        "flex_score_admit", "flex_score_admit_cluster",
        "flex_score_admit_max_r"]
    assert len(fake_lib.lookups) == 3 and fs.QUEUE_LAUNCHES == 2


def test_card_empty_queue_launches_nothing(fake_lib):
    placements = fs.flex_score_admit(*_card_args(64, 0))
    assert placements.shape == (0,) and not fake_lib.calls
    assert fs.QUEUE_LAUNCHES == 0


def test_card_launcher_raises_on_what_the_kernel_does_not_take(fake_lib):
    args = _card_args(64, 5)
    with pytest.raises(ValueError, match="must be on"):
        fs.flex_score_admit(*[a.as_subclass(torch.Tensor) for a in args])
    for k, bad in ((1, args[1].double()), (3, args[3].long()),
                   (7, args[7].to(torch.uint8)), (6, args[6].float())):
        wrong = list(args)
        wrong[k] = bad.as_subclass(_OnCard)
        with pytest.raises(ValueError, match="must be torch"):
            fs.flex_score_admit(*wrong)
    for k, shape in ((4, (64, 32)), (5, (5, 5)), (6, (4,)), (2, (63, 2))):
        wrong = list(args)
        wrong[k] = torch.zeros(shape, dtype=args[k].dtype).as_subclass(
            _OnCard)
        with pytest.raises(ValueError, match="must have shape"):
            fs.flex_score_admit(*wrong)
    with pytest.raises(ValueError, match="at most 8 resources, got 9"):
        fs.flex_score_admit(*_card_args(64, 5, r=9))
    with pytest.raises(ValueError, match="at most 185440 nodes"):
        fs.flex_score_admit(*_card_args(185441, 1))
    assert not fake_lib.calls and fs.QUEUE_LAUNCHES == 0


def test_card_launcher_raises_when_the_cluster_cannot_run(fake_lib):
    fake_lib.ret = -2
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        fs.flex_score_admit(*_card_args(4000, 3))
    fake_lib.ret = 98
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        fs.flex_score_admit(*_card_args(4000, 3))
    assert fs.QUEUE_LAUNCHES == 0


def test_hooked_policy_on_the_card_launches_or_raises(monkeypatch):
    # On a CUDA tensor a hooked policy's admit_queue(use_kernel=True) goes
    # to the queue kernel and raises with it: it never takes the plain
    # queue or the per-decision loop.
    monkeypatch.setattr(ops, "_device_kind", lambda caller, est: "cuda")
    monkeypatch.setattr(ops, "admit_queue_ref", None)
    monkeypatch.setattr(admission, "admit_one", None)
    launched = []

    def kernel(*args):
        launched.append(args[5].shape)
        raise RuntimeError("flex_score_admit: unbuildable")

    monkeypatch.setattr(ops, "flex_score_admit", kernel)
    node, u = _random_node(30, 1)
    tp = FlexParams.default(device="cpu")
    with pytest.raises(RuntimeError, match="unbuildable"):
        admission.admit_queue(get_policy("flex-priority"), node,
                              u(4, 2) * 0.2, torch.zeros(4, dtype=torch.int32),
                              torch.ones(4, dtype=torch.int32),
                              torch.ones(4, dtype=torch.bool),
                              torch.tensor(1.1), tp, use_kernel=True)
    assert launched == [(4, 6)]

"""The port's wavefront admission against the JAX reference.

``admit_queue_wavefront`` of both packages on identical node tables and
queues: placements, the final node state and the (rounds, sweeps) counts
must be equal, and the placements and node state must equal the port's
own sequential scan.  The knob grid is ``topk`` in {0, 1, 4, 8} x
``dedup_buckets`` in {0, 64}, plus ``tie_margin = 1e-2``; the queues are
mixed (some entries invalid), duplicate-heavy and all-unique, the
adversarial single hot node, and all-infeasible.  The JAX side takes its
batched reference einsums (``interpret=False``), which
``tests/test_torch_flex_score_batch.py`` holds bit-equal to the port's
plain versions.  Queues stay at Q <= 64, so the duplicate-heavy queue
takes the dedup branch with ``dedup_buckets = 16``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import admission as j_adm
from repro.api import get_policy as j_get_policy
from repro.core import schedulers as j_sched
from repro.core.types import FlexParams as JFlexParams
from repro.core.types import NodeState as JNodeState
from repro_torch.api import (admission, admit_queue_wavefront, get_policy,
                             policy_prepare_params)
from repro_torch.convert import node_state_from_numpy
from repro_torch.core import schedule_queue
from repro_torch.core.types import FlexParams

HOOKED = ["flex-f", "flex-l", "best-fit-usage", "flex-priority"]

# The tensors here are tiny: one intra-op thread is fastest, and keeps
# PyTorch's pool from contending with XLA's in the same process.
torch.set_num_threads(1)


def _node_arrays(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        est_usage=(rng.random((n, 2)) * 0.7).astype(np.float32),
        reserved=(rng.random((n, 2)) * 0.05).astype(np.float32),
        requested=(rng.random((n, 2)) * 0.9).astype(np.float32),
        n_tasks=rng.integers(0, 5, n).astype(np.int32),
        src_count=rng.integers(0, 3, (n, 64)).astype(np.int32))


def _queue(q, seed, kind="mixed"):
    """(requests (Q, 2), srcs, priorities, valid) as numpy."""
    rng = np.random.default_rng(seed)
    reqs = (rng.random((q, 2)) * 0.15).astype(np.float32)
    srcs = rng.integers(0, 64, q).astype(np.int32)
    prios = rng.integers(0, 3, q).astype(np.int32)
    valid = np.ones(q, bool)
    if kind == "mixed":
        valid = rng.random(q) < 0.9
    elif kind == "dup_heavy":           # 4 shapes x 3 sources: 12 rows
        reqs = reqs[:4][np.arange(q) % 4]
        srcs = ((np.arange(q) // 4) % 3).astype(np.int32)
        prios = np.zeros(q, np.int32)
    return reqs, srcs, prios, valid


def _params(name):
    jp, tp = JFlexParams.default(), FlexParams.default(device="cpu")
    prep = getattr(j_get_policy(name), "prepare_params", None)
    return (prep(jp) if prep else jp), policy_prepare_params(get_policy(name),
                                                             tp)


def _run_both(name, arrays, queue, penalty=1.2, **knobs):
    """(JAX result, port result, port sequential result); each result is
    (node, placements, rounds, sweeps) as numpy / ints."""
    jp, tp = _params(name)
    jnode = JNodeState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    j_node, j_pl, j_r, j_s = j_adm.admit_queue_wavefront(
        j_get_policy(name), jnode, *queue, jnp.float32(penalty), jp,
        with_rounds=True, **knobs)
    tnode = node_state_from_numpy(arrays, device="cpu")
    tq = [torch.from_numpy(a) for a in queue]
    t_node, t_pl, t_r, t_s = admit_queue_wavefront(
        get_policy(name), tnode, *tq, torch.tensor(penalty), tp,
        with_rounds=True, **knobs)
    s_node, s_pl = admission.admit_queue(get_policy(name), tnode, *tq,
                                         torch.tensor(penalty), tp)
    # the caller's node state is not modified
    np.testing.assert_array_equal(tnode.reserved.numpy(), arrays["reserved"])
    return ((j_node, np.asarray(j_pl), int(j_r), int(j_s)),
            (t_node, t_pl.numpy(), t_r, t_s), (s_node, s_pl.numpy()))


def _assert_equal(j, t, s):
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[1], s[1])
    for field in JNodeState._fields:
        want = np.asarray(getattr(j[0], field))
        np.testing.assert_array_equal(getattr(t[0], field).numpy(), want,
                                      err_msg=field)
        np.testing.assert_array_equal(getattr(s[0], field).numpy(), want,
                                      err_msg=field)
    assert (t[2], t[3]) == (j[2], j[3]), "rounds, sweeps"


@pytest.mark.parametrize("dedup", [0, 64])
@pytest.mark.parametrize("topk", [0, 1, 4, 8])
def test_knob_grid_matches_reference(topk, dedup):
    for seed in range(2):
        j, t, s = _run_both("flex-f", _node_arrays(513, seed),
                            _queue(48, seed + 50), topk=topk,
                            dedup_buckets=dedup)
        _assert_equal(j, t, s)
        assert (t[1] >= 0).any() and (t[1] < 0).any()
        if topk == 0:
            assert t[2] == t[3]


@pytest.mark.parametrize("topk", [0, 8])
def test_wide_tie_margin_matches_reference(topk):
    j, t, s = _run_both("flex-f", _node_arrays(100, 3), _queue(48, 4),
                        topk=topk, tie_margin=1e-2)
    _assert_equal(j, t, s)


@pytest.mark.parametrize("kind", ["dup_heavy", "unique"])
def test_dedup_regimes_match_reference(kind):
    # 12 distinct rows fit 16 buckets: every sweep takes the dedup branch.
    # 48 distinct rows do not: every sweep falls back to full width.
    admission.reset_decisions()
    j, t, s = _run_both("flex-f", _node_arrays(100, 7), _queue(48, 2, kind),
                        topk=8, dedup_buckets=16)
    _assert_equal(j, t, s)
    assert admission.SWEEPS == t[3] > 0
    assert admission.DEDUP_SWEEPS == (t[3] if kind == "dup_heavy" else 0)


@pytest.mark.parametrize("name", HOOKED)
@pytest.mark.parametrize("n", [5, 100, 513])
def test_policies_match_reference(name, n):
    j, t, s = _run_both(name, _node_arrays(n, n), _queue(48, n + 1))
    _assert_equal(j, t, s)


@pytest.mark.parametrize("name", HOOKED)
@pytest.mark.parametrize("topk", [0, 8])
def test_adversarial_single_hot_node(name, topk):
    # Every task from one source, one node far emptier than the rest: all
    # pending tasks pick it, and the decisions must still be the
    # sequential scan's, commit order included.
    n, q = 33, 24
    est = np.full((n, 2), 0.55, np.float32)
    est[7] = 0.0
    arrays = dict(est_usage=est, reserved=np.zeros((n, 2), np.float32),
                  requested=np.zeros((n, 2), np.float32),
                  n_tasks=np.full(n, 2, np.int32),
                  src_count=np.zeros((n, 64), np.int32))
    queue = (np.full((q, 2), 0.12, np.float32), np.full(q, 3, np.int32),
             np.zeros(q, np.int32), np.ones(q, bool))
    j, t, s = _run_both(name, arrays, queue, penalty=1.0, topk=topk)
    _assert_equal(j, t, s)
    placed = int((t[1] >= 0).sum())
    assert placed > 0
    if topk == 0:
        assert t[2] >= placed and t[3] == t[2]
    else:
        assert t[3] < t[2] and t[3] <= placed // 4 + 1


@pytest.mark.parametrize("topk,rounds", [(0, 1), (8, 0)])
def test_all_infeasible_finalizes_in_one_sweep(topk, rounds):
    n, q = 70, 16
    arrays = dict(est_usage=np.full((n, 2), 0.99, np.float32),
                  reserved=np.zeros((n, 2), np.float32),
                  requested=np.zeros((n, 2), np.float32),
                  n_tasks=np.zeros(n, np.int32),
                  src_count=np.zeros((n, 64), np.int32))
    queue = (np.full((q, 2), 0.5, np.float32), np.zeros(q, np.int32),
             np.zeros(q, np.int32), np.ones(q, bool))
    j, t, s = _run_both("flex-f", arrays, queue, penalty=1.0, topk=topk)
    _assert_equal(j, t, s)
    assert (t[1] == -1).all() and (t[2], t[3]) == (rounds, 1)


def test_empty_queue_sweeps_nothing():
    tnode = node_state_from_numpy(_node_arrays(10, 0), device="cpu")
    reqs, srcs, prios, valid = (torch.from_numpy(a)
                                for a in _queue(0, 0, "unique"))
    node, pl, rounds, sweeps = admit_queue_wavefront(
        get_policy("flex-f"), tnode, reqs, srcs, prios, valid,
        torch.tensor(1.2), FlexParams.default(device="cpu"),
        with_rounds=True)
    assert pl.shape == (0,) and (rounds, sweeps) == (0, 0)
    assert torch.equal(node.reserved, tnode.reserved)


def test_batch_mode_dispatch_and_fallback():
    tnode = node_state_from_numpy(_node_arrays(40, 1), device="cpu")
    tq = [torch.from_numpy(a) for a in _queue(32, 5)]
    tp = FlexParams.default(device="cpu")
    for name in ("flex-f", "least-fit"):
        admission.reset_decisions()
        seq = admission.admit_queue(get_policy(name), tnode, *tq,
                                    torch.tensor(1.2), tp)
        wav = admission.admit_queue(get_policy(name), tnode, *tq,
                                    torch.tensor(1.2), tp, batch_mode=True)
        assert torch.equal(seq[1], wav[1])
        assert admission.DECISIONS == 64
        # least-fit has no kernel hook: batch_mode keeps the scan
        assert (admission.SWEEPS > 0) == (name == "flex-f")


def test_schedule_queue_batch_mode_matches_reference():
    arrays = _node_arrays(100, 9)
    reqs, srcs, prios, valid = _queue(40, 10)
    jp, tp = _params("flex-f")
    jnode = JNodeState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tnode = node_state_from_numpy(arrays, device="cpu")
    _, want = j_sched.schedule_queue(jnode, reqs, srcs, valid,
                                     jnp.float32(1.3), jp, "flex-f",
                                     batch_mode=True)
    for batch_mode in (True, False):
        _, got = schedule_queue(tnode, torch.from_numpy(reqs),
                                torch.from_numpy(srcs),
                                torch.from_numpy(valid), torch.tensor(1.3),
                                tp, "flex-f", batch_mode=batch_mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_queue_admitter_matches_admit_queue():
    tnode = node_state_from_numpy(_node_arrays(60, 2), device="cpu")
    tq = [torch.from_numpy(a) for a in _queue(24, 3)]
    pol = get_policy("flex-l")
    admit = admission.make_queue_admitter(
        pol, FlexParams.default(device="cpu"), batch_mode=True, topk=4)
    again = admission.make_queue_admitter(
        pol, FlexParams.default(alpha=0.9, device="cpu"), batch_mode=True,
        topk=4)
    assert admission._shared_queue_admitter.cache_info().hits >= 1
    got = admit(tnode, *tq, torch.tensor(1.1))
    want = admission.admit_queue(
        pol, tnode, *tq, torch.tensor(1.1),
        policy_prepare_params(pol, FlexParams.default(device="cpu")),
        batch_mode=True, topk=4)
    assert torch.equal(got[1], want[1])
    assert torch.equal(again(tnode, *tq, torch.tensor(1.1))[1], want[1])


def test_task_dependent_node_leaves_raise():
    # The wavefront scores every task against ONE node table: a hook that
    # derives est_usage from the task cannot take it.
    @dataclasses.dataclass(frozen=True)
    class TaskScaled(type(get_policy("flex-f"))):
        def kernel_inputs(self, ctx, task):
            ki = super().kernel_inputs(ctx, task)
            return ki._replace(est_usage=ki.est_usage + task.request)

    tnode = node_state_from_numpy(_node_arrays(10, 0), device="cpu")
    tq = [torch.from_numpy(a) for a in _queue(4, 0)]
    with pytest.raises(ValueError, match="out_dim"):
        admit_queue_wavefront(TaskScaled(), tnode, *tq, torch.tensor(1.0),
                              FlexParams.default(device="cpu"))

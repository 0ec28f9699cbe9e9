"""The port's legacy scheduler layer against the JAX reference.

``node_scores``, ``place_task`` and ``schedule_queue`` over the shared
admission core, and the phase-1 single-resource FIFO and LRF schedulers
(Algorithms 1-2), on the same numpy inputs.  Scores must be bit-equal and
decisions equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedulers as j_sched
from repro.core.types import FlexParams as JFlexParams
from repro.core.types import NodeState as JNodeState
from repro.core.types import SchedulerKind as JKind
from repro_torch.convert import node_state_from_numpy
from repro_torch.core import (SchedulerKind, fifo_scheduler, lrf_scheduler,
                              node_scores, place_task, schedule_queue)
from repro_torch.core.types import FlexParams

torch.set_num_threads(1)


def _node(n, seed):
    rng = np.random.default_rng(seed)
    arrays = dict(
        est_usage=(rng.random((n, 2)) * 0.7).astype(np.float32),
        reserved=(rng.random((n, 2)) * 0.1).astype(np.float32),
        requested=(rng.random((n, 2)) * 0.9).astype(np.float32),
        n_tasks=rng.integers(0, 5, n).astype(np.int32),
        src_count=rng.integers(0, 3, (n, 64)).astype(np.int32))
    return (JNodeState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            node_state_from_numpy(arrays, device="cpu"), arrays)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", ["least-fit", "oversub", "flex-f",
                                  "best-fit-usage", SchedulerKind.FLEX_L])
def test_node_scores_and_place_task_match(kind):
    jnode, tnode, arrays = _node(50, 1)
    jkind = JKind(int(kind)) if isinstance(kind, SchedulerKind) else kind
    theta = 2.0 if kind == "oversub" else 1.0
    jp = JFlexParams.default(theta=theta)
    tp = FlexParams.default(theta=theta, device="cpu")
    r = np.float32([0.1, 0.05])
    want = jax.jit(lambda n, p: j_sched.node_scores(
        n, r, jnp.int32(5), p, jp, jkind))(jnode, jnp.float32(1.3))
    src = torch.tensor(5, dtype=torch.int32)
    got = node_scores(tnode, torch.from_numpy(r), src, torch.tensor(1.3), tp,
                      kind)
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for valid in (True, False):
        j_ns, j_idx = jax.jit(lambda n: j_sched.place_task(
            n, r, jnp.int32(5), jnp.bool_(valid), jnp.float32(1.3), jp,
            jkind))(jnode)
        t_ns, t_idx = place_task(tnode, torch.from_numpy(r), src,
                                 torch.tensor(valid), torch.tensor(1.3), tp,
                                 kind)
        assert int(t_idx) == int(j_idx)
        np.testing.assert_array_equal(t_ns.reserved.numpy(),
                                      np.asarray(j_ns.reserved))
    # the caller's state is not modified
    np.testing.assert_array_equal(tnode.reserved.numpy(), arrays["reserved"])


def test_schedule_queue_defaults_to_batch_priority():
    jnode, tnode, _ = _node(30, 2)
    rng = np.random.default_rng(3)
    reqs = (rng.random((20, 2)) * 0.2).astype(np.float32)
    srcs = rng.integers(0, 64, 20).astype(np.int32)
    valid = rng.random(20) < 0.9
    jp = JFlexParams.default()
    _, want = jax.jit(lambda n: j_sched.schedule_queue(
        n, reqs, srcs, valid, jnp.float32(1.2), jp, "flex-priority"))(jnode)
    _, got = schedule_queue(tnode, *map(torch.from_numpy,
                                        (reqs, srcs, valid)),
                            torch.tensor(1.2),
                            FlexParams.default(device="cpu"),
                            "flex-priority", use_kernel=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("capacity", [float("inf"), 1.0])
def test_phase1_schedulers_match(capacity):
    rng = np.random.default_rng(4)
    loads = (rng.random(7) * 0.5).astype(np.float32)
    loads[2] = loads[5]                       # a tie: the lower index wins
    reqs = (rng.random(25) * 0.4).astype(np.float32)
    reqs[3] = reqs[9]                         # equal requests: stable sort
    for j_fn, t_fn in ((j_sched.fifo_scheduler, fifo_scheduler),
                       (j_sched.lrf_scheduler, lrf_scheduler)):
        j_loads, j_assign = j_fn(jnp.asarray(loads), jnp.asarray(reqs),
                                 capacity)
        t_loads, t_assign = t_fn(torch.from_numpy(loads),
                                 torch.from_numpy(reqs), capacity)
        np.testing.assert_array_equal(t_assign.numpy(), np.asarray(j_assign))
        np.testing.assert_array_equal(_bits(t_loads.numpy()),
                                      _bits(j_loads))
        assert t_assign.dtype == torch.int32
        if capacity == 1.0:
            assert (t_assign < 0).any()
    empty = fifo_scheduler(torch.from_numpy(loads), torch.zeros(0))
    assert empty[1].shape == (0,) and torch.equal(empty[0],
                                                  torch.from_numpy(loads))

"""The port's admission core and policies against the JAX reference.

One ``pick_node`` decision and one admitted queue, for every ported
policy, with the same node table and tasks on both sides.  The JAX side
runs jitted (hooked policies through the interpret-mode kernel); the port
runs both ``use_kernel`` settings.  Decisions must be equal.
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
from repro_torch.api import (admission, get_policy, list_policies,
                             policy_prepare_params, policy_supports_kernel,
                             resolve_policy)
from repro_torch.convert import node_state_from_numpy
from repro_torch.core.types import FlexParams, SchedulerKind

HOOKED = ["flex-f", "flex-l", "best-fit-usage", "flex-priority", "reclaim",
          "migrate", "flex-brownout"]
PLAIN = ["least-fit", "oversub"]

# The tensors here are tiny: one intra-op thread is fastest, and keeps
# PyTorch's pool from contending with XLA's in the same process.
torch.set_num_threads(1)


def _node_arrays(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        est_usage=(rng.random((n, 2)) * 0.7).astype(np.float32),
        reserved=(rng.random((n, 2)) * 0.1).astype(np.float32),
        requested=(rng.random((n, 2)) * 0.9).astype(np.float32),
        n_tasks=rng.integers(0, 5, n).astype(np.int32),
        src_count=rng.integers(0, 3, (n, 64)).astype(np.int32))


def _queue(q, seed):
    rng = np.random.default_rng(seed)
    reqs = (rng.random((q, 2)) * 0.15).astype(np.float32)
    reqs[::4, 1] = reqs[0, 1]          # equal memory requests: stable order
    return (reqs, rng.integers(0, 64, q).astype(np.int32),
            rng.integers(0, 3, q).astype(np.int32), rng.random(q) < 0.85)


def _both_params(name):
    jp = JFlexParams.default(theta=2.0 if name == "oversub" else 1.0)
    tp = FlexParams.default(theta=2.0 if name == "oversub" else 1.0,
                            device="cpu")
    jpol, tpol = j_get_policy(name), get_policy(name)
    prep = getattr(jpol, "prepare_params", None)
    return (prep(jp) if prep else jp), policy_prepare_params(tpol, tp)


@pytest.mark.parametrize("name", HOOKED + PLAIN)
@pytest.mark.parametrize("n", [5, 100, 513])
def test_pick_node_matches(name, n):
    arrays = _node_arrays(n, n)
    jnode = JNodeState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tnode = node_state_from_numpy(arrays, device="cpu")
    jp, tp = _both_params(name)
    jpol, tpol = j_get_policy(name), get_policy(name)
    hooked = name in HOOKED

    @jax.jit
    def j_pick(req, src, prio, pen):
        ctx = j_adm.PolicyContext(node=jnode, penalty=pen, params=jp)
        return j_adm.pick_node(jpol, ctx, j_adm.TaskView(req, src, prio),
                               use_kernel=hooked, interpret=hooked)

    rng = np.random.default_rng(n + 1)
    for k in range(6):
        req = (rng.random(2) * (0.6 if k == 5 else 0.2)).astype(np.float32)
        src, prio = np.int32(rng.integers(0, 64)), np.int32(k % 3)
        pen = np.float32(1.0 + rng.random())
        want = j_pick(req, src, prio, pen)
        ctx = admission.PolicyContext(node=tnode, penalty=torch.tensor(pen),
                                      params=tp)
        task = admission.TaskView(torch.from_numpy(req), torch.tensor(src),
                                  torch.tensor(prio))
        for use_kernel in (False, True):
            idx, ok = admission.pick_node(tpol, ctx, task,
                                          use_kernel=use_kernel)
            assert idx.dtype == torch.int32
            assert int(idx) == int(want[0]) and bool(ok) == bool(want[1])


@pytest.mark.parametrize("name", HOOKED + PLAIN)
def test_admit_queue_matches(name):
    n, q = 70, 40
    arrays = _node_arrays(n, 2)
    jnode = JNodeState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tnode = node_state_from_numpy(arrays, device="cpu")
    reqs, srcs, prios, valid = _queue(q, 3)
    jp, tp = _both_params(name)
    hooked = name in HOOKED
    jpol, tpol = j_get_policy(name), get_policy(name)
    jfn = jax.jit(lambda node, *xs: j_adm.admit_queue(
        jpol, node, *xs, jp, use_kernel=hooked, interpret=hooked))
    j_node, j_pl = jfn(jnode, reqs, srcs, prios, valid, jnp.float32(1.2))
    for use_kernel in (False, True):
        admission.reset_decisions()
        t_node, t_pl = admission.admit_queue(
            tpol, tnode, *map(torch.from_numpy, (reqs, srcs, prios, valid)),
            torch.tensor(1.2), tp, use_kernel=use_kernel)
        assert admission.DECISIONS == q
        np.testing.assert_array_equal(t_pl.numpy(), np.asarray(j_pl))
        for field in t_node._fields:
            np.testing.assert_array_equal(
                getattr(t_node, field).numpy(),
                np.asarray(getattr(j_node, field)), err_msg=field)
    # the caller's node state is not modified
    np.testing.assert_array_equal(tnode.reserved.numpy(), arrays["reserved"])
    assert (t_pl >= 0).any() and (t_pl < 0).any()


@pytest.mark.parametrize("name", ["flex-l", "flex-priority"])
def test_queue_order_matches(name):
    reqs, _, prios, valid = _queue(64, 4)
    want = jax.jit(j_get_policy(name).queue_order)(reqs, prios, valid)
    got = get_policy(name).queue_order(*map(torch.from_numpy,
                                            (reqs, prios, valid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_registry_and_capabilities():
    assert list_policies() == sorted(HOOKED + PLAIN)
    for name in HOOKED:
        assert policy_supports_kernel(get_policy(name))
    for name in PLAIN:
        assert not policy_supports_kernel(get_policy(name))
    assert resolve_policy(SchedulerKind.FLEX_L).name == "flex-l"
    pol = get_policy("flex-f")
    assert resolve_policy(pol) is pol
    with pytest.raises(KeyError, match="registered"):
        get_policy("no-such-policy")
    assert admission.DRAIN_LOAD == j_adm.DRAIN_LOAD


def test_batch_mode_admits_in_wavefront_rounds():
    node = node_state_from_numpy(_node_arrays(8, 0), device="cpu")
    reqs, srcs, prios, valid = map(torch.from_numpy, _queue(4, 0))
    tp = FlexParams.default(device="cpu")
    for name in ("flex-f", "least-fit"):
        admission.reset_decisions()
        _, seq = admission.admit_queue(get_policy(name), node, reqs, srcs,
                                       prios, valid, torch.tensor(1.0), tp)
        _, pl = admission.admit_queue(get_policy(name), node, reqs, srcs,
                                      prios, valid, torch.tensor(1.0), tp,
                                      batch_mode=True)
        assert pl.shape == (4,) and torch.equal(pl, seq)
        # the kernel-hooked policy sweeps; least-fit keeps the scan
        assert (admission.SWEEPS > 0) == (name == "flex-f")


def test_primitives_match():
    rng = np.random.default_rng(9)
    load = rng.random((30, 2)).astype(np.float32)
    r = rng.random(2).astype(np.float32) * 0.3
    t = torch.from_numpy(load)
    np.testing.assert_array_equal(
        admission.fits(t, torch.from_numpy(r), 1.0).numpy(),
        np.asarray(j_adm.fits(load, r, 1.0)))
    np.testing.assert_array_equal(
        admission.least_loaded_score(t, 2.0).numpy(),
        np.asarray(j_adm.least_loaded_score(load, 2.0)))
    np.testing.assert_array_equal(
        admission.usage_load(t, t, torch.tensor(1.3)).numpy(),
        np.asarray(jax.jit(j_adm.usage_load)(load, load, 1.3)))
    feas = load[:, 0] < 0.5
    np.testing.assert_array_equal(
        admission.mask_infeasible(t[:, 1], torch.from_numpy(feas)).numpy(),
        np.asarray(j_adm.mask_infeasible(load[:, 1], feas)))

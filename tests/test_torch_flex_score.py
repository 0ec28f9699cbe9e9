"""The port's flex_score pick against the JAX reference, bit for bit.

The same numpy inputs go through JAX's interpret-mode Pallas kernel
(``flex_pick_node(..., interpret=True)``), JAX's ``pick_node_ref`` as the
reference's jitted code runs it, and the port's plain version and
dispatching wrapper on CPU tensors.  Index, score and any_feasible must be
bit-equal.  (XLA fuses ``penalty * est + reserved`` into one rounding
under jit; the port rounds there once too.  The eager JAX oracle rounds
twice and is not the reference the simulator runs.)

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it bit-equal to
the plain version on the card.  What surrounds it (task packing, the
wrapper's checks, dispatch by device) is tested here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flex_score.ops import flex_pick_node as jax_pick
from repro.kernels.flex_score.ref import pick_node_ref as jax_ref
from repro_torch.kernels.flex_score import flex_score as fs
from repro_torch.kernels.flex_score.ops import flex_pick_node, pack_task
from repro_torch.kernels.flex_score.ref import NEG_INF, pick_node_ref

SIZES = [1, 5, 100, 512, 513, 1000]
CASES = ["random", "ties", "infeasible", "cap_below_one", "best_fit",
         "weights"]

_jax_ref_jit = jax.jit(jax_ref)

# The tensors here are tiny: one intra-op thread is fastest, and keeps
# PyTorch's pool from contending with XLA's in the same process.
torch.set_num_threads(1)


def _inputs(n, case, seed):
    rng = np.random.default_rng(seed)
    est = (rng.random((n, 2)) * 0.8).astype(np.float32)
    res = (rng.random((n, 2)) * 0.1).astype(np.float32)
    src = rng.random(n).astype(np.float32)
    r = (rng.random(2) * 0.2).astype(np.float32)
    penalty = np.float32(1.0 + rng.random())
    cap, w_load, w_src = np.float32(1.0), np.float32(1.0), np.float32(0.25)
    if case == "ties":
        # quarter steps: many nodes share a score exactly
        est = np.floor(est * 5) / 4
        res = np.zeros_like(res)
        src = np.floor(src * 2) / 2
        penalty = np.float32(1.0)
    elif case == "infeasible":
        r = r + np.float32(2.0)
    elif case == "cap_below_one":
        cap = np.float32(0.6)
    elif case == "best_fit":
        w_load, w_src = np.float32(-1.0), np.float32(0.0)
    elif case == "weights":
        w_load = np.float32(0.5 + rng.random())
        w_src = np.float32(rng.random())
    return (est.astype(np.float32), res.astype(np.float32),
            src.astype(np.float32), r, penalty, cap, w_load, w_src)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_pick_bit_equal_to_jax(n, case):
    for seed in range(3):
        est, res, src, r, penalty, cap, w_load, w_src = _inputs(n, case, seed)
        j_k = jax_pick(est, res, src, r, penalty, w_load=w_load,
                       w_src=w_src, cap=cap, interpret=True)
        j_r = _jax_ref_jit(est, res, src, r, penalty, w_load, w_src, cap)
        t = [torch.from_numpy(a) for a in (est, res, src, r)]
        scal = [torch.tensor(x) for x in (penalty, w_load, w_src, cap)]
        p_ref = pick_node_ref(*t, scal[0], scal[1], scal[2], cap=scal[3])
        p_ops = flex_pick_node(*t, scal[0], w_load=float(w_load),
                               w_src=float(w_src), cap=float(cap))
        for got in (p_ref, p_ops):
            for want in (j_k, j_r):
                assert int(got[0]) == int(want[0])
                assert _bits(got[1].numpy()) == _bits(want[1])
                assert bool(got[2]) == bool(want[2])
        if case == "infeasible":
            assert int(p_ref[0]) == -1 and not bool(p_ref[2])
            assert float(p_ref[1]) == np.float32(NEG_INF)


def test_ties_go_to_lowest_index():
    est = torch.zeros(7, 2)
    est[3] = 0.5
    idx, score, ok = pick_node_ref(est, torch.zeros(7, 2), torch.zeros(7),
                                   torch.full((2,), 0.1), 1.0, 1.0, 0.25)
    assert int(idx) == 0 and bool(ok)
    est[0] = 0.9
    idx, _, _ = pick_node_ref(est, torch.zeros(7, 2), torch.zeros(7),
                              torch.full((2,), 0.05), 1.0, 1.0, 0.25)
    assert int(idx) == 1


def test_neg_inf_shared_with_reference():
    from repro.kernels.flex_score.flex_score import NEG_INF as JAX_NEG_INF
    from repro_torch.api.admission import NEG_INF as ADM_NEG_INF
    assert NEG_INF == JAX_NEG_INF == ADM_NEG_INF


def test_pack_task_layout():
    task = pack_task(torch.tensor([0.1, 0.2]), torch.tensor(1.5), 0.9,
                     torch.tensor(-1.0), 0.0, "cpu")
    assert task.dtype == torch.float32 and task.shape == (6,)
    np.testing.assert_array_equal(
        task.numpy(), np.float32([0.1, 0.2, 1.5, 0.9, -1.0, 0.0]))


def test_kernel_wrapper_rejects_cpu_tensors():
    # The CUDA wrapper never computes on the CPU: it raises before it
    # builds or launches anything, and counts no launch.
    before = fs.LAUNCHES
    with pytest.raises(ValueError, match="must be on"):
        fs.flex_score_pick(torch.zeros(4, 2), torch.zeros(4, 2),
                           torch.zeros(4), torch.zeros(6))
    assert fs.LAUNCHES == before


def test_dispatch_raises_on_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        flex_pick_node(torch.zeros(4, 2, device="meta"),
                       torch.zeros(4, 2, device="meta"),
                       torch.zeros(4, device="meta"),
                       torch.zeros(2, device="meta"), 1.0)


def test_cpu_dispatch_takes_plain_version_without_launching():
    before = fs.LAUNCHES
    est = torch.rand(50, 2, generator=torch.Generator().manual_seed(0))
    got = flex_pick_node(est, torch.zeros(50, 2), torch.zeros(50),
                         torch.full((2,), 0.1), 1.2)
    want = pick_node_ref(est, torch.zeros(50, 2), torch.zeros(50),
                         torch.full((2,), 0.1), 1.2, 1.0, 0.25)
    assert int(got[0]) == int(want[0]) and fs.LAUNCHES == before


def test_build_names_the_hopper_target_and_no_contraction():
    from repro_torch.kernels import _build
    assert set(_build.sources()) == {"flex_score"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    path = _build.library_path("flex_score")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parent.name == "build"
    assert path == _build.library_path("flex_score")   # keyed, stable


def test_jax_side_stays_on_cpu():
    assert jax.default_backend() == "cpu"
    assert jnp.zeros(1).dtype == jnp.float32

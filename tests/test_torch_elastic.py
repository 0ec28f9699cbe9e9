"""Sharded training through ``launch.train.train`` in gloo processes
(``test_torch_sharded_train.run_ranks``):

  * on a 1x1 mesh (one rank) the losses, grad norms, weights and AdamW
    moments of every family's smoke config are bit-equal to the
    unsharded run's: every redistribution is a no-op there and the local
    ops are the unsharded ones;
  * the reference's elastic restart (``test_elastic_restart_across_
    meshes``): 2 steps of the stablelm-3b smoke config on 2x2 with a
    checkpoint, resumed on 4x1 for the 2 remaining steps, the losses
    near an unsharded run's (a bf16 config: rtol 2e-2).
"""
import pytest

from test_torch_sharded_train import run_ranks


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-370m",
                                  "mixtral-8x7b", "zamba2-7b",
                                  "whisper-medium", "llava-next-mistral-7b"])
def test_one_by_one_mesh_is_bit_equal_to_unsharded(arch):
    out = run_ranks(f"""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.train import train
    p0, o0, l0 = train("{arch}", True, 3, 4, 32, None, False, log_every=1,
                       device="cpu")
    p1, o1, l1 = train("{arch}", True, 3, 4, 32, None, False, log_every=1,
                       device="cpu", mesh=make_test_mesh(1, 1, device="cpu"))
    assert l0 == l1, (l0, l1)
    for (n, a), (_, b) in zip(p0.named_parameters(),
                              p1.named_parameters()):
        assert isinstance(b, DTensor) and torch.equal(a, b.to_local()), n
    for k in o0.mu:
        assert torch.equal(o0.mu[k], o1.mu[k].to_local()), k
    print("OK", l1)
    """, world=1)
    gn = [ln.split("gnorm")[1].split()[0] for ln in out[0].splitlines()
          if ln.startswith("[train]")]
    assert len(gn) == 6 and gn[:3] == gn[3:] and "OK" in out[0]


def test_elastic_restart_across_meshes(tmp_path):
    """A checkpoint written on a 2x2 mesh resumes on 4x1."""
    out = run_ranks(f"""
    from repro_torch.launch.train import train
    d = "{tmp_path}/ck"
    _, _, first = train("stablelm-3b", True, 2, 4, 32, d, False,
                        ckpt_every=2, mesh=make_test_mesh(2, 2, device="cpu"),
                        log_every=100, device="cpu")
    _, _, losses = train("stablelm-3b", True, 4, 4, 32, d, True,
                         ckpt_every=2,
                         mesh=make_test_mesh(4, 1, device="cpu"),
                         log_every=100, device="cpu")
    assert len(first) == 2 and len(losses) == 2   # resumed at step 2
    if RANK == 0:
        _, _, plain = train("stablelm-3b", True, 4, 4, 32, None, False,
                            log_every=100, device="cpu")
        np.testing.assert_allclose(first + losses, plain, rtol=2e-2)
        print("OK", first + losses, plain)
    """, world=4)
    assert "resumed from step 2" in out[0] and "OK" in out[0]

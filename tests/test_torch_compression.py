"""The int8 gradient all-reduce with error feedback against the JAX
reference.

The reference runs in a subprocess with 8 host devices
(``--xla_force_host_platform_device_count=8``), the port in 8 gloo
processes (``test_torch_sharded_train.run_ranks``), on the same float32
gradients: one copy held by every rank (the reference's test), and a
different gradient on each rank (through the reference's ``shard_map``
body with a sharded input).  Held:

  * the phase-1 payload (each rank's int8 chunks and scale, from the
    port's ``_quantize`` on that rank's gradient) equal to the
    reference's ``_quantize`` jitted on it;
  * the phase-2 payload (the reduced chunk, quantized) equal to the
    reference's: both recovered from each output's own chunk and its
    largest value (``_implied_q``);
  * the output within 1e-6 of its largest value of the reference's (its
    phase-2 scale can differ by one rounding where XLA sums in another
    order), bit-equal when every rank holds the same gradient;
  * the reference's own bounds: error under 3 x the int8 scale, and with
    error feedback the accumulated sync within rel 0.02 of the true sum
    after 8 steps; the final error-feedback residual bit-equal.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

import repro.train.compression as J
from test_torch_sharded_train import SRC, run_ranks

N_DEV, N = 8, 4096


def _reference(tmp):
    code = f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from jax.experimental.shard_map import shard_map
        import repro.train.compression as C
        mesh = jax.make_mesh((8,), ("data",),
                             axis_types=(jax.sharding.AxisType.Auto,))
        same = jnp.asarray(np.load("{tmp}/same.npy"))
        np.save("{tmp}/ref_same.npy", np.asarray(
            C.compressed_allreduce(same, mesh)))
        e, acc = jnp.zeros_like(same), []
        for i in range(8):
            s, e = C.ef_compress_step(same, e, mesh)
            acc.append(np.asarray(s))
        np.save("{tmp}/ref_ef.npy", np.stack(acc))
        np.save("{tmp}/ref_err.npy", np.asarray(e))

        # the reference's exchange body on each device's own gradient
        n = 8

        def per_device(g):
            g = g.reshape(n, -1)
            q, scale = C._quantize(g)
            qs = jax.lax.all_to_all(q[None], "data", split_axis=1,
                                    concat_axis=0, tiled=False)[:, 0]
            scales = jax.lax.all_gather(scale, "data")
            chunk = jnp.sum(qs.astype(jnp.float32) * scales[:, None],
                            axis=0) / n
            q2, s2 = C._quantize(chunk)
            qall = jax.lax.all_gather(q2, "data")
            sall = jax.lax.all_gather(s2, "data")
            return (qall.astype(jnp.float32) * sall[:, None]).reshape(-1)[None]

        diff = np.load("{tmp}/diff.npy")
        x = jax.device_put(jnp.asarray(diff.reshape(-1)),
                           NamedSharding(mesh, P("data")))
        fn = shard_map(per_device, mesh=mesh, in_specs=P("data"),
                       out_specs=P("data"), check_rep=False)
        np.save("{tmp}/ref_diff.npy", np.asarray(fn(x)).reshape(8, -1))
    """
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]


def _port(tmp):
    run_ranks(f"""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.compression import (_quantize,
                                               compressed_allreduce,
                                               ef_compress_step)
    mesh = make_mesh((WORLD,), ("data",), device="cpu")
    for name, g in (("same", np.load("{tmp}/same.npy")),
                    ("diff", np.load("{tmp}/diff.npy")[RANK])):
        g = torch.from_numpy(g)
        out = compressed_allreduce(g, mesh)
        q1, s1 = _quantize(g.reshape(WORLD, -1))
        np.savez(f"{tmp}/port_{{name}}_{{RANK}}.npz", out=out.numpy(),
                 q1=q1.numpy(), s1=s1.numpy())
    same = torch.from_numpy(np.load("{tmp}/same.npy"))
    e, acc = torch.zeros_like(same), []
    for i in range(8):
        s, e = ef_compress_step(same, e, mesh)
        acc.append(s.numpy())
    if RANK == 0:
        np.save("{tmp}/port_ef.npy", np.stack(acc))
        np.save("{tmp}/port_err.npy", e.numpy())
    """, world=N_DEV)


def _implied_q(out_chunk):
    """The int8 values an output chunk carries (its largest is +-127
    times the chunk's scale)."""
    scale = np.abs(out_chunk).max() / 127
    return np.rint(out_chunk / scale).astype(np.int8)


def test_compressed_allreduce_and_error_feedback(tmp_path):
    rng = np.random.default_rng(0)
    same = rng.standard_normal(N).astype(np.float32)
    diff = (rng.standard_normal((N_DEV, N))
            * rng.uniform(0.1, 10, (N_DEV, 1))).astype(np.float32)
    np.save(tmp_path / "same.npy", same)
    np.save(tmp_path / "diff.npy", diff)
    _reference(tmp_path)
    _port(tmp_path)
    quantize = jax.jit(J._quantize)
    m = N // N_DEV
    for name, grads, ref in (
            ("same", [same] * N_DEV,
             [np.load(tmp_path / "ref_same.npy")] * N_DEV),
            ("diff", list(diff), list(np.load(tmp_path / "ref_diff.npy")))):
        for r in range(N_DEV):
            got = dict(np.load(tmp_path / f"port_{name}_{r}.npz"))
            q1, s1 = quantize(jnp.asarray(grads[r].reshape(N_DEV, -1)))
            np.testing.assert_array_equal(got["q1"], np.asarray(q1))
            assert got["s1"] == np.asarray(s1)
            np.testing.assert_array_equal(
                _implied_q(got["out"][r * m:(r + 1) * m]),
                _implied_q(ref[r][r * m:(r + 1) * m]))
            err = np.abs(got["out"] - ref[r]).max()
            assert err <= 1e-6 * np.abs(ref[r]).max(), (name, r, err)
            if name == "same":
                np.testing.assert_array_equal(got["out"], ref[r])
                scale = np.abs(same).max() / 127
                assert np.abs(got["out"] - same).max() < 3 * scale
        # every rank ends with the same mean
        outs = [np.load(tmp_path / f"port_{name}_{r}.npz")["out"]
                for r in range(N_DEV)]
        assert all(np.array_equal(o, outs[0]) for o in outs)
    np.testing.assert_array_equal(np.load(tmp_path / "port_err.npy"),
                                  np.load(tmp_path / "ref_err.npy"))
    for which in ("port", "ref"):
        acc = np.load(tmp_path / f"{which}_ef.npy").sum(axis=0)
        rel = np.linalg.norm(acc - 8 * same) / np.linalg.norm(8 * same)
        assert rel < 0.02, (which, rel)

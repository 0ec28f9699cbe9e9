"""The port's real-model serving driver against the JAX reference.

Both backends serve a smoke model in float32 (stablelm-3b, mixtral-8x7b,
mamba2-370m and zamba2-7b: the dense, moe, ssm and hybrid families, and
stablelm-3b behind an engine with a crash burst and live migration) with
the same weights
(the reference's ``model.init``, carried across), behind engines whose
``decode_fn`` runs the backend's decode and reports a constant step time
(real wall times would feed the straggler inflation and make the runs
diverge).  The greedy tokens must be equal at every step, and every
cache leaf (K/V; conv windows, SSM states and the hybrid's shared K/V)
equal within 1e-4 (float32 sum order), over a run long enough for the
replica's shared ``len`` to pass ``max_seq``: the backend writes every
slot's new K/V at that shared position, clamped to ``max_seq - 1``.  The
slot bookkeeping (``slot_of`` and the free lists) must be equal too.  A
live migration moves a request between the engine's replicas and tells
the backend nothing, as in the reference: the request keeps its old
slot number on the new replica, where another resident may hold it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as j_serve
from repro.faults import FaultConfig as JFaultConfig
from repro.migration import MigrationConfig as JMigrationConfig
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.faults import FaultConfig
from repro_torch.launch import serve
from repro_torch.migration import MigrationConfig
from repro_torch.serving import EngineConfig, ServeEngine

torch.set_num_threads(1)

ARCH = "stablelm-3b"


def _leaves(cache):
    out = {}
    for key, v in cache.items():
        if isinstance(v, tuple):
            out.update({f"{key}.{i}": x for i, x in enumerate(v)})
        elif key != "len":
            out[key] = v
    return out


# A crash burst on replica 0 at step 3, announced 2 steps ahead, and the
# migration that moves its residents to replica 1 (which has the room).
_FAULTS = dict(burst_slot=3, burst_frac=0.5, crash_duration=4, warn_slots=2)
_MIGRATION = dict(bandwidth=4, pool_size=4, migrate_cost=1)


def _engines(monkeypatch, max_seq, arch=ARCH, slots=4, budget=200,
             requests=10, faulted=False):
    j_cfg = dataclasses.replace(j_serve.get_smoke_config(arch),
                                dtype="float32")
    monkeypatch.setattr(j_serve, "get_smoke_config", lambda arch: j_cfg)
    jb = j_serve.RealModelBackend(arch, 2, slots, max_seq=max_seq)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tb = serve.RealModelBackend(arch, 2, slots, max_seq=max_seq, cfg=cfg,
                                device="cpu")
    tb.params = model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jb.params), device="cpu")
    kw = dict(n_replicas=2, kv_budget_tokens=budget,
              max_active_per_replica=slots)
    jkw, tkw = dict(kw), dict(kw)
    if faulted:
        jkw.update(faults=JFaultConfig(**_FAULTS),
                   migration=JMigrationConfig(**_MIGRATION))
        tkw.update(faults=FaultConfig(**_FAULTS),
                   migration=MigrationConfig(**_MIGRATION))
    engines = []
    for backend, eng, workload in (
            (jb, JServeEngine(JEngineConfig(**jkw)), j_serve.make_workload),
            (tb, ServeEngine(EngineConfig(**tkw), device="cpu"),
             serve.make_workload)):
        eng.decode_fn = (lambda b: lambda i, reqs: (b.decode_fn(i, reqs),
                                                    1.0)[1])(backend)
        eng.on_admit = backend.on_admit
        eng.on_evict = backend.on_evict
        for req in workload(requests):
            eng.submit(req)
        engines.append((backend, eng))
    return engines


def _same_backends(jb, tb, step):
    for r in range(2):
        assert np.array_equal(np.asarray(jb.tokens[r]),
                              tb.tokens[r].numpy()), (step, r)
        assert int(tb.caches[r]["len"]) == int(jb.caches[r]["len"])
        want, got = _leaves(jb.caches[r]), _leaves(tb.caches[r])
        assert set(got) == set(want)
        for key in want:
            err = np.abs(np.asarray(want[key]) - got[key].numpy()).max()
            assert err < 1e-4, (step, r, key, err)
    assert jb.slot_of == tb.slot_of and jb.free == tb.free, step


@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x7b", "mamba2-370m",
                                  "zamba2-7b"])
def test_backend_matches_reference(monkeypatch, arch):
    (jb, je), (tb, te) = _engines(monkeypatch, max_seq=32, arch=arch)
    for step in range(40):
        je.step()
        te.step()
        _same_backends(jb, tb, step)
    # the shared len ran past max_seq on a replica that decoded every step
    assert max(int(c["len"]) for c in tb.caches) > 32
    assert (te.stats.admitted, te.stats.finished) == (je.stats.admitted,
                                                      je.stats.finished)


def _shared_slots(engine, backend):
    """(replica, slot) pairs that two residents of one replica both hold."""
    out = []
    for i, reqs in engine.active.items():
        slots = [backend.slot_of[r.rid] for r in reqs
                 if r.rid in backend.slot_of]
        out += [(i, s) for s in set(slots) if slots.count(s) > 1]
    return out


def test_backend_under_faults_and_migration_matches_reference(monkeypatch):
    """2 replicas x 8 slots, 8 requests: the burst announces replica 0's
    crash at step 3 and the drain pass moves its residents to replica 1.
    Tokens, caches, slot_of and the free lists stay equal to the
    reference's every step; and the moved requests keep replica 0's slot
    numbers, which replica 1's own residents hold too."""
    (jb, je), (tb, te) = _engines(monkeypatch, max_seq=32, slots=8,
                                  budget=600, requests=8, faulted=True)
    shared = []
    for step in range(40):
        je.step()
        te.step()
        _same_backends(jb, tb, step)
        assert _shared_slots(te, tb) == _shared_slots(je, jb)
        shared += _shared_slots(te, tb)
    assert te.stats.migrations == je.stats.migrations > 0
    assert (te.stats.admitted, te.stats.finished, te.stats.fault_evictions) \
        == (je.stats.admitted, je.stats.finished, je.stats.fault_evictions)
    assert shared and all(i == 1 for i, _ in shared)


def test_slots_free_only_on_eviction():
    """Finished requests keep their slot (the reference's bookkeeping):
    once a replica's slots are used, admissions run no prefill."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    b = serve.RealModelBackend(ARCH, 1, 2, max_seq=64, cfg=cfg, device="cpu")
    eng = ServeEngine(EngineConfig(n_replicas=1, kv_budget_tokens=400,
                                   max_active_per_replica=2),
                      decode_fn=b.decode_fn, device="cpu")
    eng.on_admit, eng.on_evict = b.on_admit, b.on_evict
    for req in serve.make_workload(6):
        eng.submit(req)
    stats = eng.run(80)
    assert stats.finished > 2 and stats.evicted_events == 0
    assert b.prefills == 2 and b.free == [[]]


def test_make_workload_matches_reference():
    fields = ("rid", "prompt_len", "max_tokens", "true_tokens")
    got = [tuple(getattr(r, f) for f in fields)
           for r in serve.make_workload(50, seed=3)]
    want = [tuple(getattr(r, f) for f in fields)
            for r in j_serve.make_workload(50, seed=3)]
    assert got == want
    long = serve.make_workload(32, prompt=(512, 2049), true=(16, 65))
    assert all(512 <= r.prompt_len <= 2048 and 16 <= r.true_tokens <= 64
               and 1.5 * r.true_tokens - 1 <= r.max_tokens
               <= 4 * r.true_tokens for r in long)


@pytest.mark.parametrize("extra", [[], ["--stream", "burst", "--rate", "1"]])
def test_main_runs_on_cpu(extra, capsys):
    stats = serve.main(["--device", "cpu", "--requests", "6", "--steps",
                        "12", "--replicas", "1", "--slots", "4", "--budget",
                        "256", *extra])
    out = capsys.readouterr().out
    assert "policy=flex replicas=1 budget=256tok" in out
    assert "tokens/s" in out and stats.steps == 12

"""The port's sharding rules, constraints and launch specs against the
JAX reference.

Specs: ``param_specs`` in the three modes and ``input_specs_sharding`` on
the train, prefill and decode inputs of every config, on the 16x16,
2x16x16, 2x2, 4x1 and 1x1 meshes, exactly equal to the reference's
``PartitionSpec``s.  The reference builds ``NamedSharding``s, which need
real devices, so its module's ``NamedSharding`` is monkeypatched to
record the spec, and both packages get one mocked mesh (``axis_names``
and a ``shape`` mapping), as ``tests/test_sharding_rules.py`` sketches.
The port's rules run on its own model's tree (``rules.abstract_tree`` of
a module drawn under a ``FakeTensorMode``), whose shapes must equal the
reference's ``eval_shape`` tree.  ``constrain``'s specs at the models'
call sites against the reference's ``with_sharding_constraint`` specs;
``placements``.  ``launch.specs``: ``param_count``, ``input_specs``,
``accum_steps_for`` (dp 1, 16, 32) and ``model_flops`` exactly equal for
every config and applicable shape; ``roofline_terms`` equal to the
reference's with its constants set to the port's; ``report.render``'s
rows equal to the reference's on the same records.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

import repro.launch.report as j_report
import repro.launch.roofline as j_roof
import repro.sharding.api as j_api
import repro.sharding.rules as j_rules
from repro.configs import get_config as j_get
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import applicable_shapes as j_applicable
from repro.launch import specs as j_specs
from repro.models import build_model as j_build
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, applicable_shapes
from repro_torch.launch import report, roofline, specs
from repro_torch.models.model import build_model
from repro_torch.sharding import api, rules

torch.set_num_threads(1)


class FakeMesh:
    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.size = int(np.prod(sizes))


MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x2": (("data", "model"), (2, 2)),
    "4x1": (("data", "model"), (4, 1)),
    "1x1": (("data", "model"), (1, 1)),
}


class _Recorded:
    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def record_specs(monkeypatch):
    monkeypatch.setattr(j_rules, "NamedSharding", _Recorded)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    jm = j_build(j_get(arch))
    j_tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    t_tree = rules.abstract_tree(specs.abstract_params(
        build_model(get_config(arch))))
    return j_tree, t_tree


def _flat_ref(tree):
    """{path: leaf} of a reference tree of recorded specs or shapes."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, _Recorded))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = leaf.spec if isinstance(leaf, _Recorded) else leaf
    return out


def _flat_port(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_port(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, rules.Spec):
        for i, v in enumerate(tree):
            out.update(_flat_port(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_tree_is_the_reference_tree(arch):
    j_tree, t_tree = _trees(arch)
    want = {k: tuple(v.shape) for k, v in _flat_ref(j_tree).items()}
    got = {k: v.shape for k, v in _flat_port(t_tree).items()}
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, record_specs):
    fm = FakeMesh(*MESHES[mesh])
    j_tree, t_tree = _trees(arch)
    for mode in ("train", "compute", "serve"):
        want = _flat_ref(j_rules.param_specs(j_tree, fm, mode))
        got = _flat_port(rules.param_specs(t_tree, fm, mode))
        assert got == want, mode


def _inputs(arch, shape_name):
    j_in = j_specs.input_specs(j_get(arch), J_SHAPES[shape_name])
    t_in = specs.input_specs(get_config(arch), SHAPES[shape_name])
    return j_in, t_in


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_sharding_match_reference(arch, mesh, record_specs):
    fm = FakeMesh(*MESHES[mesh])
    for shape in applicable_shapes(get_config(arch)):
        j_in, t_in = _inputs(arch, shape.name)
        want = _flat_ref(j_rules.input_specs_sharding(j_in, fm))
        got = _flat_port(rules.input_specs_sharding(t_in, fm))
        assert got == want, shape.name


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_param_count_accum_and_flops(arch):
    jc, tc = j_get(arch), get_config(arch)
    assert [s.name for s in applicable_shapes(tc)] == \
        [s.name for s in j_applicable(jc)]
    total, active = specs.param_count(build_model(tc))
    assert (total, active) == j_specs.param_count(j_build(jc))
    for shape in applicable_shapes(tc):
        j_in, t_in = _inputs(arch, shape.name)
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in _flat_ref(j_in).items()}
        got = {k: (v.shape, _dtype_name(v.dtype))
               for k, v in _flat_port(t_in).items()}
        assert got == want, shape.name
        js = J_SHAPES[shape.name]
        for dp in (1, 16, 32):
            assert specs.accum_steps_for(tc, shape, dp) == \
                j_specs.accum_steps_for(jc, js, dp)
        assert specs.model_flops(tc, shape, total, active) == \
            j_specs.model_flops(jc, js, total, active)


def test_mixed_axes_entries_normalize_like_partition_spec():
    fm = FakeMesh(("data", "model"), (2, 4))
    t = {"moe": {"wg": rules._Abstract((3, 6, 16, 64)),    # 6 experts:
                 "wd": rules._Abstract((3, 6, 64, 16))}}    # no EP on 4
    got = rules.param_specs(t, fm, "train")
    assert got["moe"]["wg"] == (None, None, None, ("model", "data"))
    assert got["moe"]["wd"] == (None, None, ("model", "data"), None)
    fm1 = FakeMesh(("data", "model"), (4, 2))
    got = rules.param_specs({"moe": {"wg": rules._Abstract((3, 2, 16, 64))}},
                            fm1, "train")
    assert got["moe"]["wg"] == (None, "model", None, "data")


# ---------------------------------------------------------------------------
# constrain at the models' call sites
# ---------------------------------------------------------------------------

CONSTRAIN_CASES = [   # (logical axes, shape) at the reference's sites
    (("batch", None, None), (256, 4096, 2560)),   # embedding, encdec input
    (("batch", None, None), (6, 4096, 2560)),     # batch not divisible
    (("batch", None, None), (512, 8, 4096)),      # moe xt, xe_flat, ye
    (("batch", None, None, None), (512, 8, 2, 4096)),   # gathered
    ((None, "expert", None, None), (512, 16, 8, 4096)),  # llama4's experts
    ((None, "expert", None, None), (512, 8, 8, 4096)),   # mixtral's
    (("model", "data"), (32, 48)),
]


def _ref_constraint_spec(monkeypatch, fm, logical, shape, shard_batch):
    seen = []
    monkeypatch.setattr(j_api, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    x = jax.ShapeDtypeStruct(shape, np.float32)
    with j_api.mesh_context(fm, shard_batch=shard_batch):
        out = j_api.constrain(x, *logical)
    return seen[0] if seen else None if out is x else "?"


@pytest.mark.parametrize("shard_batch", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_constrain_specs_match_reference(monkeypatch, mesh, shard_batch):
    fm = FakeMesh(*MESHES[mesh])
    for logical, shape in CONSTRAIN_CASES:
        want = _ref_constraint_spec(monkeypatch, fm, logical, shape,
                                    shard_batch)
        with api.mesh_context(fm, shard_batch=shard_batch):
            got = api.logical_spec(fm, shape, *logical)
        assert got == want, (logical, shape)


def test_constrain_is_the_identity_without_a_mesh_or_a_shardable_dim():
    x = torch.zeros(6, 4, 8)
    assert api.constrain(x, "batch", None, None) is x
    fm = FakeMesh(("data", "model"), (4, 4))
    with api.mesh_context(fm):
        assert api.constrain(x, "batch", None, None) is x   # 6 % 4
        assert api.current_mesh() is fm
    assert api.current_mesh() is None


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        ndim = 3

        @staticmethod
        def size(i):
            return (2, 1, 4)[i]

    m = Mesh()
    assert rules.placements((("pod", "data"), None, "model"), m) == \
        [Shard(0), Replicate(), Shard(2)]
    assert rules.placements((None, "data"), m) == [Replicate()] * 3
    assert rules.placements((("model", "pod"),), m) == \
        [Shard(0), Replicate(), Shard(0)]


# ---------------------------------------------------------------------------
# roofline terms and the report
# ---------------------------------------------------------------------------

def test_roofline_terms_match_reference(monkeypatch):
    monkeypatch.setattr(j_roof, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(j_roof, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(j_roof, "ICI_BW", roofline.COLL_BW)
    rng = np.random.default_rng(0)
    for _ in range(50):
        f, b, c = (float(v) for v in 10.0 ** rng.uniform(6, 16, 3))
        mf, n = float(10.0 ** rng.uniform(12, 20)), int(rng.choice([1, 4,
                                                                    256]))
        assert roofline.roofline_terms(f, b, c, mf, n) == \
            j_roof.roofline_terms(f, b, c, mf, n)


def test_report_rows_match_reference(tmp_path):
    recs = [
        {"arch": "stablelm-3b", "shape": "train_4k", "mesh": "pod16x16",
         "ok": True, "memory": {"peak_bytes_per_device": 3 * 2**30 + 7},
         "roofline": {"t_compute_s": 0.123456, "t_memory_s": 0.0456,
                      "t_collective_s": 1.5e-3, "dominant": "compute",
                      "mfu_upper_bound": 0.41234, "useful_flops_ratio":
                      0.8765}},
        {"arch": "granite-34b", "shape": "prefill_32k",
         "mesh": "pods2x16x16", "ok": False,
         "error": "NotImplementedError: " + "x" * 100},
        {"arch": "mamba2-370m", "shape": "decode_32k",
         "mesh": "pods2x16x16", "ok": True,
         "memory": {"peak_bytes_per_device": 12345678},
         "roofline": {"t_compute_s": 3e-7, "t_memory_s": 2e-4,
                      "t_collective_s": 2e-3, "dominant": "collective",
                      "mfu_upper_bound": 1.6e-4, "useful_flops_ratio":
                      0.97}},
    ]
    for r in recs:
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json"
         ).write_text(json.dumps(r))

    def rows(text):
        return [ln for ln in text.splitlines()
                if ln.startswith("| ") and not ln.startswith("| arch")]

    got, want = report.render(str(tmp_path)), j_report.render(str(tmp_path))
    assert rows(got) == rows(want) and len(rows(got)) == 3
    assert "256 GPUs" in got and "512 GPUs, 2 pods" in got

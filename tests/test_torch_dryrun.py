"""The port's dry run (``launch.dryrun``, ``launch.roofline``) on fake
process groups, each test in a subprocess (a process has one default
group).

  * The analyzer's ground truth, the case of ``tests/test_dryrun_small.py``:
    7 layers of ``tanh(h @ w)``, x (128, 256) split on ``data`` and w
    (7, 256, 256) on ``model`` of a fake 2x4 mesh.  Each device runs a
    (64, 256) @ (256, 64) product a layer: exactly 7 * 2 * 64 * 64 * 256
    flops.  Every layer after the first takes an input split on
    ``model``, which DTensor all-gathers (4 x (64, 64) float32, 64 KiB
    gathered) before its product: 6 all-gathers of 65,536 bytes, and no
    other collective.
  * The kernels' stand-ins on ``meta`` tensors: flash attention (causal,
    a window, unmasked; GQA) and the SSD scan (a ragged last chunk, with
    and without the final state), forward and backward, are each
    recorded as one op with the kernel's flops (recounted here from the
    bounds' rules) and its inputs read and outputs written once; the
    stablelm-3b and mamba2-370m smoke losses and their gradients on
    ``meta`` weights run one stand-in forward and one backward a layer
    and no plain attention or scan.
  * ``build_cell`` and ``run_cell`` on a fake (2, 2, 2) ``("pod",
    "data", "model")`` mesh: mamba2-370m's decode_32k and train_4k cells
    record ``ok`` with flops > 0 and the reference's record keys; so do
    the decode_32k and prefill_32k cells of mixtral-8x7b, zamba2-7b,
    whisper-medium and llava-next-mistral-7b, and whisper-medium's
    train_4k; a cell whose build raises (an unknown family) records its
    error and the CLI exits 1.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention.ops import (
    flash_attention_stand_in)
from repro_torch.kernels.ssd_scan.ops import ssd_scan_stand_in
from repro_torch.launch import roofline

SRC = str(Path(__file__).resolve().parent.parent / "src")


def _run(code: str, timeout: float = 300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


def _ok(code: str) -> str:
    out = _run(code)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_analyzer_ground_truth():
    out = _ok("""
        import json, torch
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch import roofline
        from repro_torch.launch.mesh import init_distributed, make_test_mesh
        init_distributed("fake", world_size=8, rank=0)
        mesh = make_test_mesh(2, 4, device="fake")
        x = DTensor.from_local(torch.empty(64, 256, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        ws = DTensor.from_local(torch.empty(7, 256, 64, device="meta"),
                                mesh, [Replicate(), Shard(2)],
                                run_check=False)
        rec = roofline.OpRecorder()
        rec.hold((x, ws))
        with rec:
            h = x
            for i in range(7):
                h = torch.tanh(h @ ws[i])
            h.sum()
        an = roofline.analyze(rec.records)
        gathers = [c for name, f, b, kind, c in rec.records
                   if kind == "all-gather"]
        print(json.dumps(dict(an, gathers=gathers)))
    """)
    an = json.loads(out.strip().splitlines()[-1])
    assert an["flops"] == 7 * 2 * 64 * 64 * 256
    # layers 2..7 read an input split on "model": one gather each
    assert an["gathers"] == [4 * 64 * 64 * 4] * 6
    assert an["collectives"] == {"all-gather": 6 * 65536.0}
    assert an["collective_bytes"] == 6 * 65536.0
    assert an["bytes"] > 0


def _nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=True)


def _by_name(rec):
    out = {}
    for name, f, b, _, _ in rec.records:
        out.setdefault(name, []).append((f, b))
    return out


@pytest.mark.parametrize("causal,window,sq,sk", [(True, 0, 256, 256),
                                                 (True, 40, 256, 256),
                                                 (False, 0, 96, 200)])
def test_flash_attention_stand_in_is_charged_as_the_kernel(causal, window,
                                                           sq, sk):
    B, H, KV, hd = 2, 4, 2, 32
    q, k, v = _meta(B, sq, H, hd), _meta(B, sk, KV, hd), _meta(B, sk, KV, hd)
    rec = roofline.OpRecorder()
    with rec:
        out = flash_attention_stand_in(q, k, v, causal=causal,
                                       window=window)
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    pairs = 0
    for r in range(sq):
        hi = min(r + 1, sk) if causal else sk
        lo = max(r - window + 1, 0) if window else 0
        pairs += max(hi - lo, 0)
    lse = B * H * sq * 4
    ops = _by_name(rec)
    assert ops["flash_attention"] == [(4 * hd * H * B * pairs,
                                       _nb(q, k, v, out) + lse)]
    assert ops["flash_attention_bwd"] == [(10 * hd * H * B * pairs,
                                           2 * _nb(q, k, v) + 2 * _nb(out)
                                           + lse)]
    assert not set(ops) & {"bmm", "mm", "_softmax", "exp"}


@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_scan_stand_in_is_charged_as_the_kernel(return_state):
    Bt, S, H, P, N, Q = 2, 300, 4, 16, 32, 128
    x, Bm, Cm = _meta(Bt, S, H, P), _meta(Bt, S, N), _meta(Bt, S, N)
    dt = _meta(Bt, S, H, dtype=torch.float32)
    A_log = _meta(H, dtype=torch.float32)
    rec = roofline.OpRecorder()
    with rec:
        out = ssd_scan_stand_in(x, Bm, Cm, dt, A_log, Q,
                                return_state=return_state)
        y = out[0] if return_state else out
        torch.autograd.grad(y, (x, Bm, Cm, dt, A_log), torch.empty_like(y))
    fwd = bwd = 0
    for r in (128, 128, 44):
        fwd += Bt * r * (r + 1) * N + Bt * H * (r * (r + 1) * P
                                                + 4 * r * N * P)
        bwd += Bt * r * (r + 1) * N + Bt * H * (
            r * (r + 1) * (2 * P + 2 * N) + 10 * r * P * N)
    f32 = Bt * S * H * 4            # a, dt, da, ddt: each this size
    state = Bt * H * P * N * 4 if return_state else 0
    ops = _by_name(rec)
    assert ops["ssd_scan"] == [(fwd, 2 * _nb(x) + _nb(Bm, Cm) + 2 * f32
                                + state)]
    assert ops["ssd_scan_bwd"] == [(bwd, 3 * _nb(x) + 2 * _nb(Bm, Cm)
                                    + 4 * f32)]


@pytest.mark.parametrize("arch,kernel", [("stablelm-3b", "flash_attention"),
                                         ("mamba2-370m", "ssd_scan")])
def test_model_on_meta_runs_the_stand_ins(arch, kernel):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.specs import abstract_params
    from repro_torch.models import build_model
    from repro_torch.train.train_step import value_and_grad

    cfg = get_smoke_config(arch)
    model = build_model(cfg, remat=False)
    params = abstract_params(model)
    batch = {k: torch.empty((2, 64), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    rec = roofline.OpRecorder()
    with rec:
        value_and_grad(model, params, batch)
    ops = _by_name(rec)
    assert len(ops[kernel]) == len(ops[kernel + "_bwd"]) == cfg.n_layers
    assert all(f > 0 and b > 0 for f, b in ops[kernel] + ops[kernel + "_bwd"])


CELLS = """
    import dataclasses, json
    from pathlib import Path
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    init_distributed("fake", world_size=8, rank=0)
    mesh = make_test_mesh(2, 2, 2, device="fake")
    for arch, shape in {cells}:
        cfg = dataclasses.replace(get_config(arch), **{fields!r})
        rec = dryrun.run_cell(cfg, SHAPES[shape], mesh, "p2x2x2",
                              Path({out!r}))
        rec.pop("traceback", None)
        print(json.dumps(rec))
"""


def _cells(cells, tmp_path, **fields):
    """``run_cell`` records of (arch, shape) cells, each config with
    ``fields`` replaced."""
    out = _ok(CELLS.format(cells=cells, out=str(tmp_path), fields=fields))
    return [json.loads(ln) for ln in out.strip().splitlines()
            if ln.startswith("{")]


def test_mamba2_cells_on_a_fake_three_axis_mesh(tmp_path):
    recs = _cells([("mamba2-370m", "decode_32k"),
                   ("mamba2-370m", "train_4k")], tmp_path)
    assert [r["shape"] for r in recs] == ["decode_32k", "train_4k"]
    for r in recs:
        assert r["ok"], r.get("error")
        assert r["n_chips"] == 8 and r["hlo"]["flops"] > 0
        assert set(r["roofline"]) >= {"t_compute_s", "t_memory_s",
                                      "t_collective_s", "dominant",
                                      "mfu_upper_bound"}
        assert r["memory"]["peak_bytes_per_device"] >= \
            r["memory"]["argument_bytes"] > 0
        saved = json.loads((tmp_path / f"mamba2-370m__{r['shape']}__p2x2x2"
                            ".json").read_text())
        assert saved["hlo"] == r["hlo"]
    train = recs[1]
    assert train["accum"] > 1 and train["hlo"]["collectives"]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-7b",
                                  "whisper-medium", "llava-next-mistral-7b"])
def test_serving_cells_of_every_family(arch, tmp_path):
    """The moe, hybrid, encdec and vlm families' decode_32k and
    prefill_32k cells at full size, as the dense and ssm ones."""
    recs = _cells([(arch, "decode_32k"), (arch, "prefill_32k")], tmp_path)
    assert [r["shape"] for r in recs] == ["decode_32k", "prefill_32k"]
    for r in recs:
        assert r["ok"], r.get("error")
        assert r["hlo"]["flops"] > 0 and r["hlo"]["collectives"]
        assert r["memory"]["peak_bytes_per_device"] >= \
            r["memory"]["argument_bytes"] > 0


def test_whisper_train_cell(tmp_path):
    """whisper-medium's train_4k cell: the encoder over 1500 frames and
    the cross attention at Sq != Sk, trained on meta DTensors."""
    rec, = _cells([("whisper-medium", "train_4k")], tmp_path)
    assert rec["ok"], rec.get("error")
    assert rec["accum"] >= 1 and rec["hlo"]["flops"] > 0
    assert rec["memory"]["peak_bytes_per_device"] >= \
        rec["memory"]["argument_bytes"] > 0


def test_unported_family_is_recorded_and_fails_the_cli(tmp_path):
    # every family runs under a mesh; a cell whose build raises (an
    # unknown family) is recorded as failed, and fails the CLI
    recs = _cells([("whisper-medium", "decode_32k")], tmp_path,
                  family="rnn")
    assert not recs[0]["ok"]
    assert recs[0]["error"].startswith("ValueError: whisper-medium: "
                                       "unknown model family 'rnn'")
    cli = _run(f"""
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        dryrun.get_config = lambda arch: dataclasses.replace(
            get_config(arch), family="rnn")
        dryrun.main(["--arch", "whisper-medium", "--shape", "decode_32k",
                     "--single-pod-only", "--out", {str(tmp_path)!r}])
    """)
    assert cli.returncode == 1, cli.stderr[-2000:]
    assert "[FAIL] whisper-medium" in cli.stdout
    assert "dry-run complete: 0 ok, 1 failed" in cli.stdout

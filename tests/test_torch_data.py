"""The port's synthetic data stream against the JAX reference's.

``repro_torch.train.synthetic_batch`` makes the reference's numpy draws in
the reference's order, so every leaf (tokens, labels, and the encdec's
``frames`` or the vlm's ``patches``) must be bit-identical, for each
family that has extra inputs and a dense one, over several (seed, index)
pairs; ``stream`` must resume bit-exactly from any start index.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.train.data import stream as j_stream
from repro.train.data import synthetic_batch as j_batch
from repro_torch.configs import get_smoke_config
from repro_torch.train import stream, synthetic_batch

ARCHS = ["stablelm-3b", "whisper-medium", "llava-next-mistral-7b"]
KEYS = {"stablelm-3b": {"tokens", "labels"},
        "whisper-medium": {"tokens", "labels", "frames"},
        "llava-next-mistral-7b": {"tokens", "labels", "patches"}}


def _same(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key]
        assert g.device.type == "cpu"
        assert g.numpy().dtype == w.dtype, key
        np.testing.assert_array_equal(g.numpy(), w, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,index", [(0, 0), (0, 7), (3, 1), (11, 40)])
def test_batch_bit_identical(arch, seed, index):
    got = synthetic_batch(get_smoke_config(arch), 3, 17, seed, index,
                          device="cpu")
    _same(got, j_batch(j_smoke(arch), 3, 17, seed, index))
    assert set(got) == KEYS[arch]


def test_frames_and_patches_shapes():
    w = get_smoke_config("whisper-medium")
    frames = synthetic_batch(w, 2, 5, 0, 0, device="cpu")["frames"]
    assert frames.shape == (2, w.enc_seq, w.d_model)
    assert frames.dtype == torch.float32
    v = get_smoke_config("llava-next-mistral-7b")
    patches = synthetic_batch(v, 2, 5, 0, 0, device="cpu")["patches"]
    assert patches.shape == (2, v.n_patches, v.d_model)


def test_labels_are_next_tokens_with_a_repeated_half():
    b = synthetic_batch(get_smoke_config("stablelm-3b"), 2, 20, 1, 2,
                        device="cpu")
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    full = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
    half = 21 // 2
    assert torch.equal(full[:, half:2 * half], full[:, :half])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("start", [0, 5])
def test_stream_resumes_bit_exactly(arch, start):
    cfg = get_smoke_config(arch)
    got = list(itertools.islice(
        stream(cfg, 2, 9, seed=4, start_index=start, device="cpu"), 3))
    want = list(itertools.islice(
        j_stream(j_smoke(arch), 2, 9, seed=4, start_index=start), 3))
    for g, w in zip(got, want):
        _same(g, w)
    # a restart at start + 2 sees the third batch again
    again = next(stream(cfg, 2, 9, seed=4, start_index=start + 2,
                        device="cpu"))
    for key in got[2]:
        assert torch.equal(again[key], got[2][key])

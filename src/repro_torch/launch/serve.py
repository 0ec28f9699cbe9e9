"""Real-model serving driver: Flex admission over live KV caches.

Port of ``repro.launch.serve``.  Each replica is a slot-batched decode
instance of the model (dense, moe, ssm or hybrid): a cache with ``slots``
sequences.  On admission the engine's hook runs a single-request prefill
(on the card, attention through the flash-attention kernel and the Mamba2
scan through the SSD scan kernel) and writes it into the replica's slot
("KV surgery"); every engine step runs one decode per non-empty replica.
Flex decides which replica takes each request.

  PYTHONPATH=src python -m repro_torch.launch.serve --policy flex --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --policy reserve
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b
  PYTHONPATH=src python -m repro_torch.launch.serve --stream burst --rate 2 \\
      --steps 200 --mode wavefront
  # add --device cpu to run on the CPU

The backend keeps the reference's cache semantics exactly: a replica's
single ``len`` counts its decode steps from 0 (prefill surgery leaves it
alone), every slot's new K/V is written at that shared position (clamped
to ``max_seq - 1``), and a slot is freed only on eviction, so a replica
stops prefilling once its slots have all been used.  An evicted request's
slot goes to the last replica's free list (the engine sets its replica to
-1 first), and a live migration tells the backend nothing: the moved
request keeps its old slot number on the new replica.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model, init_cache
from repro_torch.serving.engine import (ADMISSION_MODES, EngineConfig,
                                        Request, ServeEngine)
from repro_torch.serving.stream import RequestStream, StreamConfig
from repro_torch.traces.generator import ARRIVAL_PATTERNS


class RealModelBackend:
    """Slot-batched decode backend for one model across R replicas.

    ``cfg`` defaults to the arch's smoke config, as in the reference;
    weights are random, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``.  ``prefills`` counts the prefills run.
    """

    def __init__(self, arch: str, n_replicas: int, slots: int,
                 max_seq: int, seed: int = 0, *,
                 cfg: Optional[ModelConfig] = None, device="cuda"):
        self.cfg = cfg if cfg is not None else get_smoke_config(arch)
        self.device = torch.device(device)
        self.model = build_model(self.cfg)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = self.model.init(gen)
        self.slots = slots
        self.max_seq = max_seq
        self.caches = [init_cache(self.cfg, slots, max_seq,
                                  device=self.device)
                       for _ in range(n_replicas)]
        self.tokens = [torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)
                       for _ in range(n_replicas)]
        self.slot_of: Dict[int, int] = {}          # rid -> slot
        self.free: List[List[int]] = [list(range(slots))
                                      for _ in range(n_replicas)]
        self.prefills = 0

    # ---- engine hooks ----
    def on_admit(self, req: Request):
        r = req.replica
        if not self.free[r]:
            return
        slot = self.free[r].pop()
        self.slot_of[req.rid] = slot
        prompt = torch.from_numpy(np.random.default_rng(req.rid).integers(
            0, self.cfg.vocab_size, (1, req.prompt_len)).astype(np.int32))
        logits, cache1 = self.model.prefill(
            self.params, {"tokens": prompt.to(self.device)})
        self.prefills += 1
        write_prefill(self.caches[r], cache1, slot)
        self.tokens[r][slot, 0] = torch.argmax(logits[0]).to(torch.int32)

    def on_evict(self, req: Request):
        slot = self.slot_of.pop(req.rid, None)
        if slot is not None:
            self.free[req.replica].append(slot)

    def decode_fn(self, replica: int, reqs) -> float:
        """One decode step of the replica; returns its wall time (the card
        is synchronized, so the straggler EMA sees the real step)."""
        t0 = time.time()
        logits, self.caches[replica] = self.model.decode(
            self.params, self.caches[replica], self.tokens[replica])
        self.tokens[replica] = torch.argmax(logits, dim=-1).to(
            torch.int32)[:, None]
        for r in reqs:
            if r.done and r.rid in self.slot_of:
                self.free[replica].append(self.slot_of.pop(r.rid))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time() - t0


def write_prefill(cache: Dict, prefill_cache: Dict, slot: int) -> None:
    """KV surgery: write a prefill's cache (batch b) into slots ``slot`` to
    ``slot + b - 1`` of a decode cache, over every leaf but ``len``.  K/V
    (and the hybrid's shared K/V pair) are zero-padded along the sequence
    to the decode cache's length; conv windows and SSM states are copied
    as they are."""
    for key, src in prefill_cache.items():
        if key == "len":
            continue
        if key in ("conv", "state"):
            cache[key][:, slot:slot + src.shape[1]] = src
            continue
        for s, d in zip(src if isinstance(src, tuple) else (src,),
                        cache[key] if isinstance(src, tuple)
                        else (cache[key],)):
            b, S = s.shape[1], s.shape[2]
            d[:, slot:slot + b, :S] = s
            d[:, slot:slot + b, S:] = 0


def make_workload(n: int, seed: int = 0, *, prompt=(8, 24), true=(4, 40)):
    """Requests that over-declare max_tokens, like Google-trace users.

    ``prompt`` and ``true`` are the half-open ranges of prompt lengths
    and true generation lengths (the reference's by default).
    """
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = int(rng.integers(*true))
        declared = int(t * rng.uniform(1.5, 4.0))   # ~45% usage/request
        out.append(Request(rid=i, prompt_len=int(rng.integers(*prompt)),
                           max_tokens=declared, true_tokens=t))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--policy", default="flex",
                    help="'flex'/'reserve' or any repro_torch.api.registry "
                         "policy name (flex-priority, best-fit-usage, ...)")
    ap.add_argument("--mode", choices=ADMISSION_MODES, default="wavefront",
                    help="admission execution mode (EngineConfig"
                         ".admission_mode)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--budget", type=int, default=512)
    ap.add_argument("--stream", choices=ARRIVAL_PATTERNS, default=None,
                    help="drive open-loop from this arrival pattern instead "
                         "of a pre-filled queue")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="mean arrivals per engine step (with --stream)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the node table live")
    args = ap.parse_args(argv)

    backend = RealModelBackend(args.arch, args.replicas, args.slots,
                               max_seq=256, device=args.device)
    cfg = EngineConfig(
        n_replicas=args.replicas, kv_budget_tokens=args.budget,
        policy=args.policy,
        max_active_per_replica=args.slots,
        admission_mode=args.mode)
    eng = ServeEngine(cfg, decode_fn=backend.decode_fn, device=args.device)
    eng.on_admit = backend.on_admit
    eng.on_evict = backend.on_evict

    t0 = time.time()
    if args.stream:
        # Open-loop: arrivals pushed at --rate per step; sized for the
        # smoke model's short sequences.
        stream = RequestStream(
            StreamConfig(pattern=args.stream, mean_rate=args.rate,
                         prompt_mean=12, max_tokens_mean=24),
            horizon=args.steps)
        stats = stream.drive(eng, steps=args.steps)
        args.requests = stream.submitted
    else:
        for req in make_workload(args.requests):
            eng.submit(req)
        stats = eng.run(args.steps)
    wall = time.time() - t0
    print(f"policy={args.policy} replicas={args.replicas} "
          f"budget={args.budget}tok")
    print(f"finished {stats.finished}/{args.requests} admitted "
          f"{stats.admitted} evict_events {stats.evicted_events}")
    print(f"mean util {np.mean(stats.util_series):.3f} "
          f"final QoS {stats.qos_series[-1]:.4f} "
          f"final P {stats.penalty_series[-1]:.3f}")
    print(f"tokens/s {stats.tokens_generated / wall:.1f} (real decode steps)")
    return stats


if __name__ == "__main__":
    main()

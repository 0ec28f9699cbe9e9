#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (or a few):

  1. device: the card's name and power limit; build every CUDA kernel
     from this checkout's sources, timed, with each kernel's registers,
     shared memory and spills as ptxas reports them (the SSD backward,
     the slowest source, builds while phases 2 to k run).
  2. kernels against plain: the flex_score pick kernel and its plain
     PyTorch version on the same CUDA tensors, bit for bit, at
     N in {4000, 4097, 100000} (random, tied, all-infeasible, cap < 1 and
     best-fit tasks; random, tied and faulted tables, the last with the
     simulator's fault offsets: about 30% of the rows at DRAIN_LOAD, 20%
     flapped to half capacity); times per decision at N = 4000 beside
     the bound.
     Then the queue kernel (``flex_score_admit``) against
     ``admit_queue_ref``: placements and every node-state leaf bit for
     bit, at N in {4000, 4097, 100000} (src_count on chip, and gathered
     from global memory) x Q in {1, 33, 1024}, on random, tied and
     faulted tables (the faulted ones with flex-brownout's per-task caps),
     with the same five kinds of task and about 15% of the entries invalid;
     times per call at N = 4000 and 100000, Q = 4096 (graph replay and
     eager), per decision beside the bounds and the pick kernel's.
     Then both kernels' run axis (B independent runs, each with its own
     tables and tasks, in one launch): at B = 3 (queue lengths 0, 33 and
     1024, the valid masks different) against their plain versions and
     against B single launches, bit for bit, at N = 4000 and 100000
     (4097 for the pick); timed at B = 4, N = 4000 (Q = 4096) beside 4
     single calls, eager and replayed.
  3. the slice end to end: ``Experiment(ts, cfg, "flex-f")`` at the
     paper's cluster scale (4000 nodes), through the kernels for 24 slots
     and through the policy's plain hooks for the first 2; the queue
     kernel must launch once per non-empty slot queue and the pick kernel
     never, and the placements must be identical.
  4. small run against the CPU: the same replayed-noise flex-f run on the
     card and on the CPU (which the tests hold against the JAX reference),
     and a flex-brownout run with a crash burst, degradation, migration,
     the guard, reclamation, backoff and a replayed jitter table.
  5. profile: one queue at N = 4000 admitted by the ``admit_one`` loop
     (one pick launch a decision), the queue kernel and the plain hooks,
     bit-equal; where a decision's time goes (host clock, and the device's
     kernel time from torch.profiler); then where a slot of phase 3's
     queue-kernel run goes (its first 3 slots under the profiler).

Wavefront admission (the batched kernels), in order after phase 2 and
after phase 3:

  a. the batched argmax and top-K kernels against their plain PyTorch
     versions, bit for bit, at N in {2, 4000, 4097, 100000} x Q in {1,
     33, 64, 4096} x K in {1, 8} (and one K = 40, which takes two
     passes), on random, tied and faulted tables (as in phase 2) with a
     fifth of the tasks fitting nowhere, and at R = 3 and on a table off 16 bytes (the
     instance with R read at run time); times per sweep at N = 4000,
     Q = 4096 and Q = 64 (graph replay and eager) beside the bound, the
     achieved GB/s and the earlier design's time.  Then their run axis:
     B = 3 runs of their own tables and 1024 tasks, N = 4000 and 4097 (the
     instance that reads the table as scalars), against the plain
     versions and B single launches, bit for bit; timed at B = 4, N =
     4000, Q = 4096 beside 4 single calls, eager and replayed.
  b. the wavefront study: phase 3's configuration with
     ``admission_mode="wavefront"``, its first 3 slots; placements and
     admit slots must equal those slots of phase 3's queue-kernel run,
     and the top-K kernel must launch once per sweep.
  c. the ``wavefront_topk=0`` loop, 2 slots deep (cut from 4 when phases
     p and q came), against the first 3
     slots of phase 3's sequential run: the batched argmax kernel on a
     path.
  d. one dedup-heavy queue (64 distinct shapes, Q = 4096, N = 4000)
     through the score-bucket dedup, against the sequential scan.
  e. the small replayed-noise wavefront run on the card against the CPU.
  f. profile: where one full-width wavefront queue's time goes.

A study's seeds and sweep points as one simulation, after phase 5's
profile:

  6. phase 3's cluster and trace through ``Experiment.run(seeds=[0, 1],
     sweep=[FlexParams.default(), FlexParams.default(alpha=0.95,
     w_src=0.5)])``, 4 runs in one slot loop: (i) sequential with the
     queue kernel, 24 slots: run (default, seed 0) equal to phase 3's on
     every leaf, the other three equal to 3-slot single runs on their
     first 3 slots, one ``flex_score_admit`` launch a slot for all 4
     runs; decisions/s over the runs beside phase 3's, ms a slot, and,
     over 3 profiled slots, the device's busy time, idle share and the
     segment sums' share; (ii) wavefront (``topk=8``), 1 slot (cut from
     phase b's depth to fit the time limit): run 0 making phase b's
     decisions and metrics of that slot, runs (0, 1), (1, 0) and (1, 1)
     equal to 1-slot single runs on every leaf; rounds and sweeps (the
     four runs' sums), top-K launches per batched round, host ms per
     batched round beside phase f's; (iii) the plain hooks, 1 slot (cut
     from phase 3's 2): run 0 making phase 3's plain run's decisions and
     metrics of that slot; host µs per decision step (one step decides in
     all 4 runs).

Headroom reclamation and the predictive estimators, after phase f:

  n. phase 3's trace and cluster under flex-f with the ``quantile``
     estimator and reclamation (a pool of 4096), 27 slots (24 and 3
     past the last arrivals, when the pass can first place a task under
     flex-f): the queue kernel once per non-empty primary queue, the
     top-K kernel once per reclaim sweep, tasks reclaimed, placements in
     range; the first 2 slots through the plain hooks with the same
     placements, admit slots and reclaim counts; logged beside phase 3's
     ``current`` run; the quantile refresh timed; a small least-fit
     reclamation run on the card against the CPU.
  o. ``train_usage_predictor`` on the card at the reference's defaults
     (the loss must fall), its checkpoint reloaded (estimates equal to
     the trained predictor's), timed per training step and per refresh;
     then phase n's study with the trained estimator (the top-K kernel
     must launch).

Faults, degradation, migration and the guard, after phase o, on phase
3's trace and cluster through ``repro_torch.core.run`` with an explicit
fault schedule (the benches' geometries cut to 24 slots):

  p. flex-f with retry backoff 2 and jitter 2 under
     ``crash_burst(24, 4000, slot=6, frac=0.4, duration=8,
     warn_slots=3)``: (i) the fault-recovery bench's graceful
     degradation, (ii) the same with its migration (bandwidth 256, a pool
     of 1024); the queue kernel once per non-empty primary queue, the
     top-K kernel once per migration sweep, tasks fault-evicted and (ii)
     migrated; decisions/s, ms a slot and the migration pass's ms a slot;
     ``analysis.fault_recovery`` of both and (ii)'s retention against
     (i)'s; the first 7 slots of (ii) on the plain path equal to the
     kernel path's: placements, admit slots and every counter.
  q. flex-f with ``ewma``, reclamation (a pool of 4096) and the guard
     bench's ``GuardConfig`` (its threshold and cooldown cut to this
     cluster and horizon, ``GUARD``) under ``usage_surge(24, 4000,
     start=4, ramp=6, hold=4, peak_mult=2.0)``: the breaker first trips
     on the ramp, the reclaim pool is not admitted while it is OPEN and
     the deferral grows, the half-open probe after the surge passes at
     most ``probe_reclaim`` candidates a slot through the top-K kernel;
     the trip statistic per slot; the first 7 slots on both paths equal.

The serving path (launch/serve.py over ServeEngine) at stablelm-3b's full
width, after phase a and after phase f:

  g. the flash-attention kernel against its plain version, on the six
     shapes of tests/test_kernels_flash.py, stablelm-3b's prefill
     shapes (B = 1, H = KV = 32, hd = 80, causal, S up to 4096) and
     mixtral-8x7b's (H = 32 over KV = 8, hd = 128, window 4096, S up to
     5000), whisper-medium's (H = KV = 16, hd = 64, unmasked: the encoder
     at S = 1500, B = 1 and 8, and the decoder's cross attention, Sq in
     {1, 37, 447} against Sk = 1500 frames, B = 8) and
     llava-next-mistral-7b's (H = 32 over KV = 8, hd = 128, causal, S in
     {577, 1576, 2048}), and on
     one full-width attention layer's (B, S, H, hd) projections through
     ``chunked_attention`` as the serving path calls it, in f32 (max abs
     error within 2e-5) and bf16 (2e-2, and each element within one bf16
     rounding step of the plain value); times at S = 2048 and 4096 (eager,
     and replayed from a CUDA graph) beside the earlier design's, the
     bound, the plain version and ``scaled_dot_product_attention`` (timed
     only, as a yardstick), and the same at whisper's cross shape (B = 8,
     Sq = 447, Sk = 1500) and encoder shape (B = 8, S = 1500).
  h. the slice end to end: ``RealModelBackend`` with the full config in
     bf16 (random weights), 2 replicas x 8 slots, flex in wavefront mode
     and then reserve over 32 requests with 512-2048-token prompts and a
     KV budget that binds; the flash kernel must launch 32 times per
     prefill, flex must evict and admit at least as many requests as
     reserve, and each run's decisions must equal the same engine's on
     the CPU.
  i. prefill against decode on the card (full width, bf16, a 128-token
     prompt), and a small f32 smoke-config run against the CPU port.
  j. profile: where one full-width prefill (2048 tokens) and one decode
     step of a full replica spend their time.

The Mamba2 serving path (the ssm and hybrid families), after phase g and
after phase j:

  k. the SSD scan kernel against its plain versions (``ssd_ref`` and
     ``ssd_chunked``) on the same CUDA tensors, y and final state: the
     cases of tests/test_kernels_ssd.py, ragged S in {1, 37, 255, 257,
     1000} and both full configs' prefill shapes (B = 1, S up to 4096,
     Q = 256), in f32 (within 5e-4 max(1, Q / 64) of the largest plain
     value) and bf16 (each y element within one bf16 rounding step of the
     plain value plus that), and through ``ssm_apply`` on one full-width
     layer's projections; times at S = 2048 and 4096 (eager, and replayed
     from a CUDA graph) beside the earlier design's, the bound and the
     plain versions (no library call computes the scan).
  l. mamba2-370m at full width in bf16 behind ``RealModelBackend``, flex
     then reserve over phase h's workload and budget: 48 SSD launches per
     prefill, decisions equal to the CPU replay's and to phase h's.
  m. zamba2-7b at full width in bf16 under flex (81 SSD and 9 flash
     launches per prefill, phase h's decisions); prefill(S) + decode
     against prefill(S + 1) for both full configs (the kernel's final
     state and the conv tail); both smoke configs in f32 on the card
     against the CPU port; a profile of a 2048-token mamba2-370m prefill
     and a full decode step.

The serving engine's faults and the MoE family, after phase m:

  r. phase h's model and settings on 4 replicas x 8 slots, 64 requests of
     its workload, at most 80 steps, flex in wavefront mode: (i) a crash
     burst on a quarter of the replicas (step 20, 24 steps down), storms
     and the brownout; (ii) the same announced 4 steps ahead, with live
     migration; (iii) (ii) with the drift guard (threshold 0.07, cooldown
     12).  Each run's placements, eviction, crash-eviction and migration
     streams, every EngineStats counter and the breaker's states equal the
     same engine's on the CPU step by step; (i) evicts on the crash and
     browns out, (ii) migrates, (iii) trips and reaches HALF_OPEN; the
     top-K kernel launches once per admission and migration sweep, flash
     32 times per prefill; the backend's slots are logged after each run.
  s. mixtral-8x7b at its published widths (d_model 4096, 32 heads of 128
     over 8 KV heads, 8 experts top-2, d_ff 14336, window 4096), 16 of its
     32 layers (the 32 are 93 GB in bf16, more than the card holds; the
     16 are 46.9 GB), bf16, random weights, behind ``RealModelBackend``
     over phase h's workload, flex then reserve: 16 flash launches per
     prefill, decisions equal to the CPU replay's and to phase h's;
     prefills/s, decode tokens/s, ms per replica decode step beside the
     weights' bound, a 2048-token prefill's device time split between
     the experts, the dispatch einsums, the routing and attention, the
     prefill time at 2047 (odd: one-token groups) and 2048 tokens, peak
     memory; then a 2-layer full-width prefill through the kernel against
     the plain attention, last logits within phase i's bf16 tolerance.

The encoder-decoder and VLM families, at model level (the serving
backend, as the reference's, prefills from tokens alone and cannot feed
them frames or patches), after phase s:

  t. whisper-medium at its published widths (24 encoder and 24 decoder
     layers, d_model 1024, 16 heads of 64, d_ff 4096, 1500 frames, vocab
     51,865), bf16, random weights drawn on the card: a prefill of
     ``synthetic_batch(cfg, 8, 447, 0, 0)`` (447 tokens and one decode
     step fill whisper's 448-token context) and 32 greedy decode steps
     (72 flash launches per prefill: encoder self, decoder self and
     cross attention in each layer); prefill(447) plus the first decode
     step against prefill(448), the cross K/V from the prefill; a
     2-encoder/2-decoder-layer full-width prefill through the kernel
     against the plain attention; the smoke config in f32 on the card
     against the CPU port; prefill ms, ms per decode step, decode
     tokens/s and peak memory.
  u. llava-next-mistral-7b at its published widths (32 layers, d_model
     4096, 32 heads of 128 over 8 KV heads, d_ff 14336, vocab 32,000,
     576 patches), bf16: prefills of ``synthetic_batch(cfg, 4, 1472, 0,
     0)`` (S = 2048 with the patches) and of a ragged batch of 1000
     tokens (S = 1576), 32 decode steps after the first (32 flash
     launches per prefill), and phase t's checks and numbers.

Training (the ssm family), phase v after phase k and phase w after u:

  v. the SSD scan's backward kernel (``ssd_scan_bwd.cu``) against its
     plain version ``ssd_scan_bwd_ref`` on the same CUDA tensors, dx, dB,
     dC, da and ddt: phase k's test cases and ragged S, mamba2-370m's
     training shape (B = 8, S = 2048, H = 32, P = 64, N = 128; also with
     x, B and C as views of one xBC tensor, as ssm_apply passes them) and
     zamba2-7b's (B = 1, S = 2048, H = 112, P = 64, N = 64), Q = 256, in
     f32 (within 1e-4 of max(1, each gradient's largest plain magnitude))
     and bf16 (2e-2; its float32 outputs da and ddt 2e-4), each case
     twice and bit-equal; times at both training shapes (eager, and
     replayed from a CUDA graph) beside the bound, the earlier (float32
     CUDA-core) design's times, the plain version (autograd through
     ``ssd_three_pass``, its backward alone) and ``ssd_scan_bwd_ref``; a
     profiled call at each shape, each of the bf16 path's four kernels'
     time, and the call's rate over the bound's operations.
  w. ``launch.train.train`` on mamba2-370m at its published widths (48
     layers, d_model 1024), bf16, random weights, batch 8 x 2048 tokens,
     8 steps with per-layer recomputation and checkpoints every 4, then a
     resume from the step-4 checkpoint to step 8: finite losses, the last
     below the first, the resumed losses within 1e-3 of the
     uninterrupted run's (bit-equality logged), 48 backward and 96
     forward SSD launches a step; ms per step (CUDA events), tokens/s,
     peak memory, a profiled step (kernels, idle share, the backward's
     share and each of its kernels'); the smoke config in f32 on the
     card against the CPU port from the same weights, three steps'
     losses and gradients; then the same for the smoke configs of the
     five attention families (stablelm-3b, whisper-medium, mixtral-8x7b,
     zamba2-7b, llava-next-mistral-7b: dense, encdec, moe, hybrid, vlm),
     through the flash kernels' float32 forward and backward on the card
     against the CPU's plain attention.

Training the attention families, phase x after phase v and phase y after
phase w:

  x. the flash-attention backward kernel (``flash_attention_bwd.cu``)
     against its plain version ``attention_bwd_ref`` on the same CUDA
     tensors, dq, dk and dv, with the forward's row log-sum-exp against
     ``attention_lse_ref``: stablelm-3b's training shape (B 8, H = KV =
     32, S 2048, hd 80, causal), whisper-medium's encoder (B 8, H 16,
     S 1500, hd 64, unmasked), decoder self attention (S 447, causal)
     and cross attention (Sq 447, Sk 1500), llava's and mixtral's hd 128
     over 8 kv heads at S 2048 (and with a window of 1024), chatglm3-6b's
     2 kv heads, zamba2-7b's hd 112, hd 32, ragged S in {1, 37, 129,
     1000} and causal at Sq != Sk; f32 within 1e-4 and bf16 within 2e-2
     of max(1, each gradient's largest plain magnitude), lse within 1e-4
     of max(1, its largest), each case's forward (o and lse, which a
     recomputation under checkpoint must reproduce) and backward twice
     and bit-equal; times at
     stablelm-3b's and whisper's encoder and cross shapes (eager, and
     replayed from a CUDA graph) beside the bound (10 hd flops a live
     pair at the bf16 peak), ``attention_bwd_ref``, the backward of
     ``scaled_dot_product_attention`` alone (eager, and replayed as its
     forward and backward less its forward) and the forward with and
     without lse; each of the three kernels' time in a profiled call,
     and the two wgmma kernels' rates over the products they issue
     (8 and 6 hd flops a live pair).
  y. ``launch.train.train`` on stablelm-3b at its published widths (32
     layers, d_model 2560, hd 80, vocab 50,304), bf16, random weights,
     B 8 x S 2048, 8 steps with checkpoints every 4 and a resume from
     step 4, and on whisper-medium (24 + 24 layers, 1500 frames, B 8 x
     447 tokens), 4 steps with a resume from step 2: finite losses, the
     last below the first, the resumed losses within 1e-3 of the
     uninterrupted run's (bit-equality logged), flash launches a step of
     2 forward (forward and recomputation) and 1 backward per attention
     call (stablelm-3b 64 and 32; whisper-medium 144 and 72: encoder
     self, decoder self and cross attention in each layer); ms per step
     (CUDA events), tokens/s, peak memory and a profiled step (the
     flash forward's and backward's shares of the device time, the idle
     share); then mixtral-8x7b (2 of 32 layers), zamba2-7b (18 of 81,
     two calls of the shared attention block) and llava-next-mistral-7b
     (8 of 32, 576 patches, S 2048) at full width, B 8, two steps each
     through ``launch.train.train``: finite losses and gradient norms,
     ms per step, peak memory, the launch counts.

Sharded training, after phase y:

  z. an ``nccl`` group of one rank (from a ``FileStore`` under build/)
     and a 1x1 ``DeviceMesh``; ``launch.train.train`` on stablelm-3b
     (32 layers, B 8 x S 2048) and mamba2-370m (B 8 x S 2048) at full
     width, 5 steps each, unsharded and then with ``mesh=``; then phase
     y's whisper-medium, mixtral-8x7b, zamba2-7b and llava-next-
     mistral-7b runs again with ``mesh=`` and the same settings: the
     parameters and AdamW moments are DTensors in the ZeRO-1 storage
     layout and the step runs ``train_step``'s sharded path, the kernels
     under ``local_map``, the MoE layer's routing on each device's own
     token groups.  Losses and gradient norms must be bit-equal to the
     unsharded run's, each run must launch every kernel as often as the
     model's code says (``_launches_per_step``: 2 forward and 1 backward
     flash launches an attention call, the same SSD launches a Mamba2
     layer), and the peak memory above the start must agree within 1%;
     ms per step beside the unsharded run's.  ``compressed_allreduce``
     and ``ef_compress_step`` on a CUDA tensor over the one-rank data
     axis (within 3 x the int8 scale; error feedback within rel 0.02
     after 8 steps).  The group is destroyed; then, with nothing else on
     the host, three dry runs run there together in subprocesses with no
     GPU visible (a fake process group): ``launch.dryrun``'s mamba2-370m
     and mixtral-8x7b train_4k cells on pod16x16, timed, and
     stablelm-3b's B 8 x S 2048 train step on a 1x1 mesh, whose
     ``t_compute``, ``t_memory`` and peak bytes are logged beside the
     measured step.

Then the kernels' JSON line, and last ``{"ok": true, "device": ...}``.
Any failure raises and the script exits non-zero.  Without a GPU it exits
1 before doing anything.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

SMALL = dict(n_nodes=16, n_slots=12, arrivals_per_slot=64, retry_capacity=32)
# The paper's cluster: 4000 nodes, 24 h of 5-minute slots.  The horizon is
# cut from 288 slots to 24 to fit the run's time limit.
FULL = dict(n_nodes=4000, n_slots=24, arrivals_per_slot=4096,
            retry_capacity=1024)
PAPER_SLOTS = 288
OFFERED_LOAD = 1.6
# Depth of phase 3's (and phase n's) plain-path run, cut to fit the time
# limit (from 8 slots to 4 when the Mamba2 phases came, to 2 when phases x
# and y did: ~7.5 s a slot): it is held against the kernel run's first
# PLAIN_SLOTS slots.
PLAIN_SLOTS = 2
# Depth of phase b's wavefront study, cut from 24 slots to 12 when the
# serving phases joined the run, and to 3 when phases x and y (training
# the attention families, ~100 s) did, to keep the run inside its time
# limit on a slow host (967 s on one card with b at 6 slots, ~11 s a
# slot): it is held against the sequential run's first WAVE_SLOTS slots,
# and its top-K launches once per sweep.
WAVE_SLOTS = 3
# Depth of phase c's wavefront_topk=0 loop, cut from 4 slots to 2 with
# phase b (~7 s a slot).
TOPK0_SLOTS = 2
# Depths of phase 6's wavefront (~22 s a slot for 4 runs, ~12 s for each
# single run it is held to) and plain-hook (~14 s a slot) studies of 4
# runs, cut from phase b's and phase 3's depths to 1 slot to fit the time
# limit: run (0, 0) is held to phase b's and phase 3's plain run's
# decisions of that slot, and the wavefront's other runs to single runs
# that deep on every leaf.
STUDY_WAVE_SLOTS = 1
STUDY_PLAIN_SLOTS = 1
# Depth of phases n and o, raised from 24 and 12 slots to 27.  Under
# flex-f the reclaim cap (1 - 0.1 P) is tighter than primary admission's
# (1), so the pass places a pooled task only once the primary queue stops
# filling the cluster, after the trace's last arrivals (slot 23); and
# under a current-like estimate (phase o) the pool stays empty for the
# first dozen slots or more, and an empty pool launches no sweep.
RECLAIM_SLOTS = 27
# Depth of the plain-path runs of phases p and q: their first 7 slots hold
# the drain (slots 3-5), the crash's onset (slot 6) and the breaker's trip
# (slot 5).  Cut from 8 when phases x and y came (~9.6 s a plain slot).
FAULT_SLOTS = 7
# Phase a's sizes, and the width of the synthetic queues of phases a, d, f
# (the study's compacted queues hold about 4,100-5,100 tasks a slot; 64 is
# the dedup's bucket count, 2 the serving engine's replica count).
BATCH_NS = (2, 4000, 4097, 100000)
BATCH_QS = (1, 33, 64, 4096)
QUEUE = 4096
DEDUP_Q = 64
# The earlier (warp per task, table tiles through shared memory) design's
# sweep times at N = 4000, Q = 4096 (K = 8), graph replay, from PERF.md's
# kernel table: its run P2 (NVIDIA H100 80GB HBM3, 700.00 W); logged
# beside this run's.
BATCH_EARLIER_US = {"flex_score_batch_pick": 65.375,
                    "flex_score_batch_topk": 129.599}
# The queue kernel's sizes in phase 2: N = 4000 and 4097 hold src_count on
# chip, N = 100000 gathers it from global memory (admit_plan).
QUEUE_NS = (4000, 4097, 100000)
# Q 4096 was cut to 1024 for the bit-equality cases when phases x and y
# came (the plain admit_queue_ref takes ~4 s a 4,096-task queue; phase 3
# holds the kernel on the study's own 4,100-5,100-task queues); the times
# stay at QUEUE.
QUEUE_QS = (1, 33, 1024)
# The pick kernel's time per decision at N = 4000 (graph replay), the
# design the queue kernel replaces on the sequential path, and its bytes
# bound per decision: PERF.md's kernel table, row 1 (PR 14's run P2,
# NVIDIA H100 80GB HBM3, 700.00 W); logged beside this run's.
PICK_EARLIER_US = 3.353
PICK_BOUND_US = 0.0239


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------

def _tables(n: int, gen: torch.Generator, dev, tied: bool):
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    est, res, src = u(n, 2) * 0.8, u(n, 2) * 0.1, u(n)
    if tied:   # few distinct values: many rows share a score exactly
        est, res, src = (torch.floor(x * 4) / 4 for x in (est * 1.25,
                                                          res * 10, src))
        res = res / 8
    return est.contiguous(), res.contiguous(), src.contiguous()


def _fault_offset(n: int, gen: torch.Generator, dev):
    """(N,) offsets of the simulator's fault masking
    (``admission.fault_load_offset``): about 30% of the rows down or
    draining at DRAIN_LOAD, 20% flapped to half capacity, the rest 0."""
    from repro_torch.api.admission import DRAIN_LOAD

    kind = torch.rand(n, generator=gen, device=dev)
    return torch.where(kind < 0.3, DRAIN_LOAD,
                       torch.where(kind < 0.5, 1.0 - 0.5, 0.0))


def _check_drained(what: str, offset, placements, reserved_in,
                   reserved_out) -> None:
    """No task landed on a DRAIN_LOAD row, and those rows kept their
    reserved values exactly."""
    from repro_torch.api.admission import DRAIN_LOAD

    drained = offset == DRAIN_LOAD
    picked = placements[placements >= 0].long()
    if drained[picked].any():
        raise AssertionError(f"{what}: a task landed on a drained node")
    if reserved_out is not None and not torch.equal(
            reserved_out[drained], reserved_in[drained]):
        raise AssertionError(f"{what}: a drained row's reserved changed")


def _tasks(count: int, gen: torch.Generator, dev):
    """(r, penalty, cap, w_load, w_src) rows; every fifth kind forced."""
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    out = []
    for k in range(count):
        r = u(2) * 0.2
        penalty, cap, w_load, w_src = 1.0 + u(1)[0], 1.0, 1.0, 0.25
        kind = k % 5
        if kind == 1:
            r = r + 2.0                      # fits nowhere
        elif kind == 2:
            cap = 0.5                        # cap < 1
        elif kind == 3:
            w_load, w_src = -1.0, 0.0        # best fit
        elif kind == 4:
            w_load, w_src = 0.5 + u(1)[0], u(1)[0]
        out.append((r, penalty, cap, w_load, w_src))
    return out


def _median_ms(fn, reps: int, inner: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls of
    ``fn`` replayed from a CUDA graph, per call: device time without the
    Python launch path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _event_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``reps`` eager calls of ``fn``, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _eager_ms(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def _bits_equal(a, b) -> bool:
    """Equal dtype, shape and bits."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _runs_vs_single(what, batched, singles) -> None:
    """Each run's outputs (``batched``, leading with B) equal its single
    launch's (``singles[b]``), bit for bit."""
    for b, one in enumerate(singles):
        for k, (x, y) in enumerate(zip(batched, one)):
            if not _bits_equal(x[b], y):
                raise AssertionError(f"{what}: run {b}'s output {k} differs "
                                     f"from its single launch")


def _log_run_axis_times(name, what, batched, singles) -> dict:
    """Times (ms) of one launch for B runs and of B single launches,
    replayed from a CUDA graph and eager; logged, and returned."""
    t = dict(replayed=_median_ms(batched, reps=10, inner=2),
             eager=_event_ms(batched, reps=10),
             single_replayed=_median_ms(singles, reps=10, inner=2),
             single_eager=_event_ms(singles, reps=10))
    log(f"[runs] {name} {what}: {t['replayed']:.4f} ms replayed, "
        f"{t['eager']:.4f} ms eager for one launch of 4 runs; 4 single "
        f"launches {t['single_replayed']:.4f} / {t['single_eager']:.4f} ms "
        f"({t['single_replayed'] / t['replayed']:.2f}x / "
        f"{t['single_eager'] / t['eager']:.2f}x)")
    return t


def pick_run_axis(dev) -> None:
    """Phase 2 (run axis): the pick kernel deciding in B runs at once."""
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.kernels.flex_score.ops import pack_task
    from repro_torch.kernels.flex_score.ref import pick_node_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for n in (4000, 4097):
        tables = [_tables(n, gen, dev, tied=b == 1) for b in range(3)]
        est, res, src = (torch.stack(x).contiguous() for x in zip(*tables))
        for k, rows in enumerate(zip(*(_tasks(20, gen, dev)
                                       for _ in range(3)))):
            vec = torch.stack([pack_task(*row, dev) for row in rows])
            got = fs.flex_score_pick(est, res, src, vec)
            r = vec[:, :2]
            want = pick_node_ref(est, res, src, r, vec[:, 2], vec[:, 4],
                                 vec[:, 5], cap=vec[:, 3])[:2]
            if not all(_bits_equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"flex_score_pick run axis N={n} task "
                                     f"{k}: differs from the plain version")
            _runs_vs_single(f"flex_score_pick run axis N={n}", got, [
                [x[0] for x in fs.flex_score_pick(est[b], res[b], src[b],
                                                  vec[b])]
                for b in range(3)])
        log(f"[runs] flex_score_pick N={n}: B = 3 runs (one table tied), "
            f"20 tasks each, one launch bit-equal to the plain version and "
            f"to 3 single launches")
    n, runs = FULL["n_nodes"], 4
    tables = [_tables(n, gen, dev, tied=False) for _ in range(runs)]
    est, res, src = (torch.stack(x).contiguous() for x in zip(*tables))
    vec = torch.stack([pack_task(torch.full((2,), 0.05, device=dev),
                                 1.1 + 0.1 * b, 1.0, 1.0, 0.25, dev)
                       for b in range(runs)])
    _log_run_axis_times(
        "flex_score_pick", f"N={n}",
        lambda: fs.flex_score_pick(est, res, src, vec),
        lambda: [fs.flex_score_pick(est[b], res[b], src[b], vec[b])
                 for b in range(runs)])


def kernel_vs_plain(dev) -> dict:
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.kernels.flex_score.ops import pack_task
    from repro_torch.kernels.flex_score.ref import pick_node_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = 0.0
    for n in (4000, 4097, 100000):
        for tied in (False, True, "faulted"):
            est, res, src = _tables(n, gen, dev, tied is True)
            if tied == "faulted":
                offset = _fault_offset(n, gen, dev)
                res = (res + offset[:, None]).contiguous()
            k_idx, k_score, p_idx, p_score = [], [], [], []
            for r, penalty, cap, w_load, w_src in _tasks(100, gen, dev):
                task = pack_task(r, penalty, cap, w_load, w_src, dev)
                i, s = fs.flex_score_pick(est, res, src, task)
                k_idx.append(i[0])
                k_score.append(s[0])
                pi, ps, _ = pick_node_ref(est, res, src, r, penalty, w_load,
                                          w_src, cap=cap)
                p_idx.append(pi)
                p_score.append(ps)
            torch.cuda.synchronize()
            k_idx, p_idx = torch.stack(k_idx), torch.stack(p_idx)
            k_score, p_score = torch.stack(k_score), torch.stack(p_score)
            if not torch.equal(k_idx, p_idx):
                bad = (k_idx != p_idx).nonzero()[:5].flatten().tolist()
                raise AssertionError(
                    f"flex_score N={n} tied={tied}: kernel and plain pick "
                    f"different nodes at tasks {bad}")
            if not torch.equal(k_score.view(torch.int32),
                               p_score.view(torch.int32)):
                raise AssertionError(
                    f"flex_score N={n} tied={tied}: scores differ in bits")
            worst = max(worst, float((k_score - p_score).abs().max()))
            if tied == "faulted":
                _check_drained(f"flex_score N={n} faulted", offset, k_idx,
                               None, None)
            log(f"[kernel] flex_score N={n} tied={tied}: 100 tasks, index "
                f"and score bit-equal to the plain version "
                f"({int((k_idx < 0).sum())} with no feasible node)")

    n = FULL["n_nodes"]
    est, res, src = _tables(n, gen, dev, tied=False)
    r = torch.full((2,), 0.05, device=dev)
    penalty = torch.full((), 1.3, device=dev)
    task = pack_task(r, penalty, 1.0, 1.0, 0.25, dev)
    kernel = lambda: fs.flex_score_pick(est, res, src, task)
    plain = lambda: pick_node_ref(est, res, src, r, penalty, 1.0, 0.25)
    ms = _median_ms(kernel, reps=20, inner=100)
    plain_ms = _median_ms(plain, reps=20, inner=100)
    eager_ms = _eager_ms(kernel, 2000)
    n_bytes = (2 * n * 2 + n + 6) * 4 + 8   # est, reserved, src, task; out
    n_flops = 9 * n            # 2 fma + 2 add per load pair, max, fma, mul
    bound_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops = n_flops / FP32_FLOPS * 1e3
    log(f"[kernel] flex_score N={n}: {ms * 1e3:.3f} us per decision "
        f"(graph replay), plain {plain_ms * 1e3:.3f} us, eager call "
        f"{eager_ms * 1e3:.3f} us; bound {max(bound_bytes, bound_ops) * 1e6:.1f}"
        f" ns ({n_bytes} B at 3.35 TB/s)")
    pick_run_axis(dev)
    return dict(name="flex_score_pick", route="cuda",
                source="src/repro_torch/kernels/flex_score/csrc/flex_score.cu",
                replaces="src/repro/kernels/flex_score/flex_score.py:40",
                launches=0, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                library_ms=None)


def _queue_state(n: int, gen: torch.Generator, dev, tied: bool):
    """[est, reserved, requested, n_tasks, src_count] of ``n`` nodes; tied:
    quarter steps and no history, so that many nodes score alike."""
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    est, res, req = u(n, 2) * 0.5, u(n, 2) * 0.1, u(n, 2) * 0.9
    n_tasks, src_count = (u(n) * 8).int(), (u(n, 64) * 2).int()
    if tied:
        est = torch.floor(est * 8) / 8
        res, n_tasks, src_count = (torch.zeros_like(x) for x in (
            res, n_tasks, src_count))
    return [est, res, req, n_tasks, src_count]


def _queue_bound(n: int, q: int):
    """(bound ms, what bounds it) of one queue-kernel call at R = 2: est,
    reserved, requested, n_tasks and src_count read once (284 N bytes) and
    the last four written once (276 N), the task rows, sources and valid
    flags read (33 Q with the placements written); 4 R + 6 float32
    operations per (task, node)."""
    by_bytes = (560 * n + 33 * q) / HBM_BYTES_PER_S * 1e3
    by_ops = 14 * q * n / FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def queue_kernel_vs_plain(dev, pick: dict) -> dict:
    """The queue kernel against admit_queue_ref; ``pick`` is the pick
    kernel's entry of the kernels' line (its time is logged beside)."""
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.kernels.flex_score.ops import _task_mat
    from repro_torch.kernels.flex_score.ref import admit_queue_ref

    def as_bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    worst = 0.0
    for n in QUEUE_NS:
        rows_per_cta, on_chip, smem = fs.admit_plan(n, 2)
        for tied in (False, True, "faulted"):
            state = _queue_state(n, gen, dev, tied is True)
            if tied == "faulted":
                offset = _fault_offset(n, gen, dev)
                state[1] = (state[1] + offset[:, None]).contiguous()
            for q in QUEUE_QS:
                mat = _task_mat(*_task_rows(q, gen, dev,
                                            brownout=tied == "faulted"))
                srcs = (torch.rand(q, generator=gen, device=dev)
                        * (8 if tied else 64)).int()
                valid = torch.rand(q, generator=gen, device=dev) < 0.85
                got, want = ([x.clone() for x in state] for _ in range(2))
                k_pl = fs.flex_score_admit(*got, mat, srcs, valid)
                p_pl = admit_queue_ref(*want, mat, srcs, valid)
                torch.cuda.synchronize()
                what = f"flex_score_admit N={n} Q={q} tied={tied}"
                if not torch.equal(k_pl, p_pl):
                    bad = (k_pl != p_pl).nonzero()[:5].flatten().tolist()
                    raise AssertionError(f"{what}: kernel and plain place "
                                         f"differently at tasks {bad}")
                for name, a, b in zip(("est_usage", "reserved", "requested",
                                       "n_tasks", "src_count"), got, want):
                    if not torch.equal(as_bits(a), as_bits(b)):
                        raise AssertionError(f"{what}: {name} differs")
                    if a.dtype == torch.float32:
                        worst = max(worst, float((a - b).abs().max()))
                if tied == "faulted":
                    _check_drained(what, offset, k_pl, state[1], got[1])
                log(f"[queue] {what}: placements and every node-state leaf "
                    f"bit-equal to admit_queue_ref ({int((k_pl >= 0).sum())}"
                    f" placed, {int((~valid).sum())} invalid; {rows_per_cta}"
                    f" rows a CTA, src_count "
                    f"{'on chip' if on_chip else 'in global memory'}, "
                    f"{smem} B of shared memory)")

    out = None
    q = QUEUE
    for n in (FULL["n_nodes"], QUEUE_NS[-1]):
        state = _queue_state(n, gen, dev, tied=False)
        mat = _task_mat(*_task_rows(q, gen, dev))
        srcs = (torch.rand(q, generator=gen, device=dev) * 64).int()
        valid = torch.rand(q, generator=gen, device=dev) < 0.85
        # Each timed call admits the queue into the state the call before
        # left: the work of a decision (a pass over the table, the
        # exchange, a commit) does not depend on the data.
        kernel = lambda: fs.flex_score_admit(*state, mat, srcs, valid)
        ms = _median_ms(kernel, reps=10, inner=2)
        eager = _event_ms(kernel, reps=10)
        bound_ms, bound_by = _queue_bound(n, q)
        log(f"[queue] flex_score_admit N={n} Q={q}: {ms:.4f} ms per call "
            f"(graph replay), {eager:.4f} ms eager = {ms * 1e3 / q:.4f} / "
            f"{eager * 1e3 / q:.4f} us per decision; bound "
            f"{bound_ms * 1e3:.3f} us per call ({bound_by}), "
            f"{bound_ms / ms:.5f} of it replayed")
        if n != FULL["n_nodes"]:
            continue
        plain = lambda: admit_queue_ref(*[x.clone() for x in state], mat,
                                        srcs, valid)
        plain_ms = _event_ms(plain, reps=1)
        log(f"[queue] flex_score_admit N={n} Q={q}: per decision "
            f"{ms * 1e3 / q:.4f} us replayed against the pick kernel's "
            f"{pick['ms'] * 1e3:.4f} us in this run (earlier design, "
            f"{PICK_EARLIER_US} us in PERF.md's run P2) and its bytes bound "
            f"of {PICK_BOUND_US} us; plain {plain_ms:.1f} ms per call")
        queue_run_axis(dev, gen)
        out = dict(name="flex_score_admit", route="cuda",
                   source="src/repro_torch/kernels/flex_score/csrc/"
                          "flex_score_admit.cu",
                   replaces="src/repro/kernels/flex_score/flex_score.py:40",
                   launches=0, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return out


def queue_run_axis(dev, gen) -> None:
    """Phase 2 (run axis): the queue kernel admitting B runs' queues in
    one launch, a cluster a run."""
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.kernels.flex_score.ops import _task_mat
    from repro_torch.kernels.flex_score.ref import admit_queue_ref

    lens = (0, 33, 1024)
    q = max(lens)
    for n in (FULL["n_nodes"], QUEUE_NS[-1]):
        states = [_queue_state(n, gen, dev, tied=b == 1) for b in range(3)]
        state = [torch.stack(x).contiguous() for x in zip(*states)]
        mat = torch.stack([_task_mat(*_task_rows(q, gen, dev))
                           for _ in lens]).contiguous()
        srcs = (torch.rand((3, q), generator=gen, device=dev) * 64).int()
        pos = torch.arange(q, device=dev)
        valid = torch.stack([
            pos < lens[0],
            pos < lens[1],
            torch.rand(q, generator=gen, device=dev) < 0.85]).contiguous()
        got, want = ([x.clone() for x in state] for _ in range(2))
        k_pl = fs.flex_score_admit(*got, mat, srcs, valid)
        p_pl = admit_queue_ref(*want, mat, srcs, valid)
        what = f"flex_score_admit run axis N={n} lens {lens}"
        if not torch.equal(k_pl, p_pl):
            raise AssertionError(f"{what}: placements differ from the plain "
                                 f"version")
        for name, x, y in zip(("est_usage", "reserved", "requested",
                               "n_tasks", "src_count"), got, want):
            if not _bits_equal(x, y):
                raise AssertionError(f"{what}: {name} differs from the plain "
                                     f"version")
        singles = []
        for b, length in enumerate(lens):
            one = [x[b].clone() for x in state]
            pl = fs.flex_score_admit(*one, mat[b, :length].contiguous(),
                                     srcs[b, :length].contiguous(),
                                     valid[b, :length].contiguous())
            singles.append([torch.cat([pl, pl.new_full((q - length,), -1)])]
                           + one)
        _runs_vs_single(what, [k_pl] + got, singles)
        log(f"[runs] {what}: one launch of 3 clusters bit-equal to the "
            f"plain version and to 3 single launches (placements and every "
            f"node-state leaf; {[int((k_pl[b] >= 0).sum()) for b in range(3)]}"
            f" placed)")
    n, q, runs = FULL["n_nodes"], QUEUE, 4
    states = [_queue_state(n, gen, dev, tied=False) for _ in range(runs)]
    state = [torch.stack(x).contiguous() for x in zip(*states)]
    mat = torch.stack([_task_mat(*_task_rows(q, gen, dev))
                       for _ in range(runs)]).contiguous()
    srcs = (torch.rand((runs, q), generator=gen, device=dev) * 64).int()
    valid = torch.rand((runs, q), generator=gen, device=dev) < 0.85
    views = [[x[b] for x in state] for b in range(runs)]
    t = _log_run_axis_times(
        "flex_score_admit", f"N={n} Q={q}",
        lambda: fs.flex_score_admit(*state, mat, srcs, valid),
        lambda: [fs.flex_score_admit(*views[b], mat[b], srcs[b], valid[b])
                 for b in range(runs)])
    log(f"[runs] flex_score_admit N={n} Q={q}: "
        f"{t['replayed'] * 1e3 / (runs * q):.4f} us per decision over the "
        f"4 runs replayed (one run's: "
        f"{t['single_replayed'] * 1e3 / (runs * q):.4f})")


# ---------------------------------------------------------------------------
# phase a: the batched kernels against plain
# ---------------------------------------------------------------------------

def _task_rows(q: int, gen: torch.Generator, dev, brownout: bool = False):
    """(r (Q, 2), penalty, cap, w_load, w_src (Q,)) in _tasks' five kinds,
    row by row; with ``brownout``, flex-brownout's per-task caps instead
    (production 1, batch ``clip(1 - 0.25 (P - 1), 0.2, 1)``)."""
    from repro_torch.core.numerics import fma

    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    kind = torch.arange(q, device=dev) % 5
    r = u(q, 2) * 0.2 + (kind == 1)[:, None] * 2.0      # fits nowhere
    penalty = 1.0 + u(q)
    cap = torch.where(kind == 2, 0.5, 1.0)               # cap < 1
    if brownout:
        batch_cap = torch.clamp(fma(-0.25, penalty - 1.0, 1.0), 0.2, 1.0)
        cap = torch.where(u(q) < 0.5, 1.0, batch_cap)
    w_load = torch.where(kind == 3, -1.0,                # best fit
                         torch.where(kind == 4, 0.5 + u(q), 1.0))
    w_src = torch.where(kind == 3, 0.0, torch.where(kind == 4, u(q), 0.25))
    return r, penalty, cap, w_load, w_src


def _plain_rows(fn, src, rows, *args, chunk: int = 256):
    """A plain batched version over ``chunk`` task rows at a time (its
    (Q, N, R) float64 intermediates would not fit at once at N = 100000),
    concatenated."""
    outs = []
    for lo in range(0, src.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        outs.append(fn(*args, src[sl], *(x[sl] for x in rows)))
    return [torch.cat(parts) for parts in zip(*outs)]


def _batch_bound(n: int, q: int, out_bytes: int):
    """(bound ms, what bounds it) of one sweep: est, reserved, src_frac and
    the task rows read once, the outputs written once; 4 R + 5 float32
    operations per task and node (R = 2)."""
    n_bytes = (2 * n * 2 + q * n + q * 6) * 4 + out_bytes
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = 13 * q * n / FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def batch_kernels_vs_plain(dev) -> list:
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.kernels.flex_score.ops import _task_mat
    from repro_torch.kernels.flex_score.ref import (pick_node_batch_ref,
                                                    pick_node_batch_topk_ref)

    def plain_pick(est, res, src, r, p, c, wl, ws):
        return pick_node_batch_ref(est, res, src, r, p, wl, ws, c)[:2]

    def plain_topk(k):
        def fn(est, res, src, r, p, c, wl, ws):
            return pick_node_batch_topk_ref(est, res, src, r, p, wl, ws, c,
                                            k)[:2]
        return fn

    def same(name, got, want):
        (gi, gs), (wi, ws) = got, want
        if not torch.equal(gi, wi):
            bad = (gi != wi).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: kernel and plain pick different "
                                 f"nodes at {bad}")
        if not torch.equal(gs.view(torch.int32), ws.view(torch.int32)):
            raise AssertionError(f"{name}: scores differ in bits")
        return float((gs - ws).abs().max()) if gs.numel() else 0.0

    worst = {"pick": 0.0, "topk": 0.0}

    def check(what, est, res, src, rows, ks):
        mat = _task_mat(*rows)
        got = fs.flex_score_batch_pick(est, res, src, mat)
        want = _plain_rows(plain_pick, src, rows, est, res)
        worst["pick"] = max(worst["pick"], same(f"batch_pick {what}", got,
                                                want))
        col0 = got[0]
        for k in ks:
            got = fs.flex_score_batch_topk(est, res, src, mat, k)
            want = _plain_rows(plain_topk(k), src, rows, est, res)
            worst["topk"] = max(worst["topk"], same(
                f"batch_topk {what} K={k}", got, want))
            if not torch.equal(got[0][:, 0], col0):
                raise AssertionError(f"batch_topk {what} K={k}: column 0 "
                                     f"is not the batched argmax")
        torch.cuda.synchronize()
        chunk, splits, blocks = fs.batch_plan(src.shape[1], src.shape[0])
        log(f"[batch] {what}: argmax and top-K (K in {ks}) bit-equal to "
            f"the plain versions ({int((col0 < 0).sum())} tasks fit "
            f"nowhere; {splits} chunk(s) of {chunk} nodes, {blocks} blocks)")
        return torch.cat([col0, got[0].flatten()])

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for n in BATCH_NS:
        for tied in (False, True, "faulted"):
            est, res, _ = _tables(n, gen, dev, tied is True)
            if tied == "faulted":
                offset = _fault_offset(n, gen, dev)
                res = (res + offset[:, None]).contiguous()
            for q in BATCH_QS:
                src = torch.rand((q, n), generator=gen, device=dev)
                if tied is True:
                    src = torch.floor(src * 4) / 4
                ks = (1, 8, 40) if (n, q) == (4097, 33) else (1, 8)
                picks = check(f"N={n} Q={q} tied={tied}", est, res, src,
                              _task_rows(q, gen, dev,
                                         brownout=tied == "faulted"), ks)
                if tied == "faulted":
                    _check_drained(f"batch N={n} Q={q} faulted", offset,
                                   picks.flatten(), None, None)
            del src
    # The kernels' instance with R read at run time: three resources, and
    # two on a table that does not start on 16 bytes.
    n, q = 4097, 33
    src = torch.rand((q, n), generator=gen, device=dev)
    rows = _task_rows(q, gen, dev)
    est3 = torch.rand((n, 3), generator=gen, device=dev) * 0.8
    res3 = torch.rand((n, 3), generator=gen, device=dev) * 0.1
    r3 = torch.cat([rows[0], rows[0][:, :1]], dim=1)
    check(f"N={n} Q={q} R=3", est3, res3, src, (r3, *rows[1:]), (1, 8, 40))
    est, res, _ = _tables(n, gen, dev, tied=False)
    off = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(n, 2)
    est_off, res_off = off(est), off(res)
    assert est_off.data_ptr() % 16 == 4 and res_off.data_ptr() % 16 == 4
    check(f"N={n} Q={q} R=2 table off 16 bytes", est_off, res_off, src,
          rows, (1, 8, 40))

    batch_run_axis(dev, gen)
    n, k = FULL["n_nodes"], 8
    out = []
    for q in (QUEUE, DEDUP_Q):
        est, res, _ = _tables(n, gen, dev, tied=False)
        src = torch.rand((q, n), generator=gen, device=dev)
        rows = _task_rows(q, gen, dev)
        mat = _task_mat(*rows)
        for name, kernel, plain, out_bytes in (
                ("flex_score_batch_pick",
                 lambda: fs.flex_score_batch_pick(est, res, src, mat),
                 lambda: pick_node_batch_ref(est, res, src, rows[0], rows[1],
                                             rows[3], rows[4], rows[2]),
                 q * 8),
                ("flex_score_batch_topk",
                 lambda: fs.flex_score_batch_topk(est, res, src, mat, k),
                 lambda: pick_node_batch_topk_ref(est, res, src, rows[0],
                                                  rows[1], rows[3], rows[4],
                                                  rows[2], k),
                 q * k * 8)):
            ms = _median_ms(kernel, reps=20, inner=20)
            eager = _event_ms(kernel, reps=10)
            bound_ms, bound_by = _batch_bound(n, q, out_bytes)
            n_bytes = bound_ms * HBM_BYTES_PER_S / 1e3
            shape = f"N={n} Q={q}{f' K={k}' if 'topk' in name else ''}"
            earlier = (f"; earlier design {BATCH_EARLIER_US[name]:.3f} us "
                       f"(run P2)" if q == QUEUE else "")
            log(f"[batch] {name} {shape}: {ms * 1e3:.3f} us per sweep "
                f"(graph replay), {eager * 1e3:.3f} us eager; "
                f"{n_bytes / ms / 1e6:.1f} GB/s replayed; bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by}), {bound_ms / ms:.3f} "
                f"of it replayed, {bound_ms / eager:.3f} eager{earlier}")
            if q != QUEUE:
                continue
            plain_ms = _event_ms(plain, reps=5)
            log(f"[batch] {name} {shape}: plain {plain_ms * 1e3:.1f} us")
            out.append(dict(
                name=name, route="cuda",
                source="src/repro_torch/kernels/flex_score/csrc/"
                       "flex_score_batch.cu",
                replaces=("src/repro/kernels/flex_score/flex_score.py:69"
                          if name.endswith("pick") else
                          "src/repro/kernels/flex_score/flex_score.py:114"),
                launches=0,
                max_abs_err=worst["pick" if name.endswith("pick")
                                  else "topk"],
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None))
        del src
    return out


def batch_run_axis(dev, gen) -> None:
    """Phase a (run axis): both sweeps scoring B runs' queues against
    their own tables in one launch."""
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.kernels.flex_score.ops import _task_mat
    from repro_torch.kernels.flex_score.ref import (pick_node_batch_ref,
                                                    pick_node_batch_topk_ref)

    runs, q = 3, 1024
    for n in (FULL["n_nodes"], 4097):
        tables = [_tables(n, gen, dev, tied=b == 1) for b in range(runs)]
        est, res = (torch.stack(x).contiguous() for x in list(zip(*tables))[:2])
        src = torch.rand((runs, q, n), generator=gen, device=dev)
        rows = [_task_rows(q, gen, dev) for _ in range(runs)]
        mat = torch.stack([_task_mat(*r) for r in rows]).contiguous()
        what = f"N={n} B={runs} Q={q}"
        for k in (None, 1, 8):
            if k is None:
                got = fs.flex_score_batch_pick(est, res, src, mat)
                plain = lambda b: _plain_rows(
                    lambda e, rs, s_, r, p, c, wl, ws: pick_node_batch_ref(
                        e, rs, s_, r, p, wl, ws, c)[:2],
                    src[b], rows[b], est[b], res[b])
                single = lambda b: fs.flex_score_batch_pick(
                    est[b], res[b], src[b], mat[b])
                name = "flex_score_batch_pick"
            else:
                got = fs.flex_score_batch_topk(est, res, src, mat, k)
                plain = lambda b, k=k: _plain_rows(
                    lambda e, rs, s_, r, p, c, wl, ws: pick_node_batch_topk_ref(
                        e, rs, s_, r, p, wl, ws, c, k)[:2],
                    src[b], rows[b], est[b], res[b])
                single = lambda b, k=k: fs.flex_score_batch_topk(
                    est[b], res[b], src[b], mat[b], k)
                name = f"flex_score_batch_topk K={k}"
            _runs_vs_single(f"{name} run axis {what} vs plain", got,
                            [plain(b) for b in range(runs)])
            _runs_vs_single(f"{name} run axis {what}", got,
                            [single(b) for b in range(runs)])
        log(f"[runs] batched sweeps {what}: the argmax and top-K (K in "
            f"1, 8) of one launch bit-equal to the plain versions and to "
            f"{runs} single launches (plan {fs.batch_plan(n, q, runs)})")
        del src
    n, q, runs, k = FULL["n_nodes"], QUEUE, 4, 8
    tables = [_tables(n, gen, dev, tied=False) for _ in range(runs)]
    est, res = (torch.stack(x).contiguous() for x in list(zip(*tables))[:2])
    src = torch.rand((runs, q, n), generator=gen, device=dev)
    mat = torch.stack([_task_mat(*_task_rows(q, gen, dev))
                       for _ in range(runs)]).contiguous()
    _log_run_axis_times(
        "flex_score_batch_pick", f"N={n} Q={q}",
        lambda: fs.flex_score_batch_pick(est, res, src, mat),
        lambda: [fs.flex_score_batch_pick(est[b], res[b], src[b], mat[b])
                 for b in range(runs)])
    _log_run_axis_times(
        "flex_score_batch_topk", f"N={n} Q={q} K={k}",
        lambda: fs.flex_score_batch_topk(est, res, src, mat, k),
        lambda: [fs.flex_score_batch_topk(est[b], res[b], src[b], mat[b], k)
                 for b in range(runs)])
    del src


# ---------------------------------------------------------------------------
# phases 3 and 4: the slice, and a small run against the CPU
# ---------------------------------------------------------------------------

def _check_result(res, cfg, n_tasks: int) -> None:
    m = res.metrics
    for name in ("usage", "requested", "usage_std", "usage_mean",
                 "est_usage"):
        x = getattr(m, name)
        if x.shape != (cfg.n_slots, 2) or not torch.isfinite(x).all():
            raise AssertionError(f"metrics.{name}: shape {tuple(x.shape)} "
                                 f"or non-finite values")
    for name in ("qos", "penalty", "n_running", "n_rejected"):
        if getattr(m, name).shape != (cfg.n_slots,):
            raise AssertionError(f"metrics.{name} has the wrong shape")
    if not (torch.isfinite(m.qos).all() and torch.isfinite(m.penalty).all()):
        raise AssertionError("non-finite qos or penalty")
    for name in ("placement", "admit_slot", "qos_ok_slots", "active_slots"):
        if getattr(res, name).shape != (n_tasks,):
            raise AssertionError(f"{name} has the wrong shape")
    pl = res.placement
    if int(pl.min()) < -1 or int(pl.max()) >= cfg.n_nodes:
        raise AssertionError("placement out of range")


# The integer and state series of a run, compared exactly.
COUNTERS = ("n_running", "n_rejected", "n_reclaimed", "n_fault_evicted",
            "n_degrade_evicted", "degraded", "n_migrated",
            "n_migration_failed", "guard_tripped", "n_guard_deferred")


def small_run_against_cpu(dev, mode: str = "sequential",
                          policy: str = "flex-f", schedule=None, **cfg_kw):
    """The same replayed-noise run on the card and on the CPU; returns the
    card's result.  ``schedule(device)`` gives a fault schedule; a
    retry-jitter table is replayed when the config asks for jitter."""
    import numpy as np

    from repro_torch.convert import noise_table_from_numpy
    from repro_torch.core import SimConfig, run
    from repro_torch.traces import generate_calibrated

    cfg = SimConfig(**SMALL, use_kernel=True, admission_mode=mode, **cfg_kw)
    out = {}
    for device in (dev, torch.device("cpu")):
        ts = generate_calibrated(0, cfg.n_nodes, cfg.n_slots, OFFERED_LOAD,
                                 device=device)
        rng = np.random.default_rng(0)
        table = rng.standard_normal(
            (cfg.n_slots, ts.num_tasks)).astype(np.float32)
        jitter = (rng.integers(0, cfg.retry_jitter + 1, ts.num_tasks)
                  if cfg.retry_jitter else None)
        out[device.type] = run(
            ts, cfg, policy, device=device,
            noise=noise_table_from_numpy(table, jitter=jitter,
                                         device=device),
            fault_schedule=None if schedule is None else schedule(device))
    gpu, cpu = out["cuda"], out["cpu"]
    _check_result(gpu, cfg, gpu.placement.shape[0])
    for name in ("placement", "admit_slot", "qos_ok_slots", "active_slots"):
        if not torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"small run: {name} differs GPU vs CPU")
    for name in COUNTERS + ("guard_err_q",):
        if not torch.equal(getattr(gpu.metrics, name).cpu(),
                           getattr(cpu.metrics, name)):
            raise AssertionError(f"small run: metrics.{name} differs")
    for name in ("usage", "requested", "qos", "penalty", "est_usage"):
        a, b = getattr(gpu.metrics, name).cpu(), getattr(cpu.metrics, name)
        if not torch.allclose(a, b, rtol=1e-6, atol=1e-6):
            raise AssertionError(f"small run: metrics.{name} differs")
    m = gpu.metrics
    log(f"[small] {policy} {mode} N={cfg.n_nodes} S={cfg.n_slots} "
        f"{json.dumps(cfg_kw, sort_keys=True, default=repr)}, replayed "
        f"noise: GPU placements and counters equal the CPU port's "
        f"({int((gpu.placement >= 0).sum())} admitted, "
        f"{int(m.n_reclaimed[-1])} of them reclaimed; "
        f"{int(m.n_fault_evicted[-1])} fault-evicted, "
        f"{int(m.n_degrade_evicted[-1])} shed, {int(m.n_migrated[-1])} "
        f"migrated, {int(m.n_migration_failed[-1])} failed; breaker "
        f"{m.guard_tripped.tolist()})")
    return gpu


def small_faults_against_cpu(dev):
    """Phase 4's run with faults: flex-brownout under a crash burst with a
    drain warning, graceful degradation, migration, the guard,
    reclamation, backoff and jitter, on the card and on the CPU."""
    from repro_torch.faults import FaultConfig, crash_burst
    from repro_torch.guard import GuardConfig
    from repro_torch.migration import MigrationConfig

    n, n_slots = SMALL["n_nodes"], SMALL["n_slots"]
    res = small_run_against_cpu(
        dev, "sequential", "flex-brownout",
        schedule=lambda device: crash_burst(n_slots, n, slot=3, frac=0.4,
                                            duration=4, warn_slots=2,
                                            device=device),
        faults=FaultConfig(degrade=True, qos_window=4, degrade_evict=8),
        migration=MigrationConfig(bandwidth=8, pool_size=16),
        guard=GuardConfig(window=4, trip_threshold=0.2, cooldown=3,
                          probe_slots=2, probe_reclaim=4),
        estimator="ewma", reclamation=True, reclaim_pool=64,
        retry_backoff=2, retry_jitter=2)
    m = res.metrics
    if not (int(m.n_fault_evicted[-1]) and int(m.n_migrated[-1])
            and (m.guard_tripped == 1).any()):
        raise AssertionError("the small fault run evicted, migrated or "
                             "tripped nothing")


def _same_decisions(what: str, res, ref, n_slots=None) -> None:
    """``res``'s placements and admit slots equal ``ref``'s; with
    ``n_slots``, ``res`` ran only the first ``n_slots`` slots of ``ref``'s
    run, so it must hold exactly ``ref``'s decisions of those slots."""
    pl, sl = ref.placement, ref.admit_slot
    if n_slots is not None:
        early = (sl >= 0) & (sl < n_slots)
        pl, sl = torch.where(early, pl, -1), torch.where(early, sl, -1)
    for name, want in (("placement", pl), ("admit_slot", sl)):
        got = getattr(res, name)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {name} differs from the "
                                 f"sequential run in "
                                 f"{int((got != want).sum())} tasks")


def slice_end_to_end(dev):
    """Phase 3; returns (the queue kernel's launches in the kernel run, the
    trace, the kernel run's result, its decisions/s, the plain path's
    result).  The plain path runs the first PLAIN_SLOTS slots."""
    from repro_torch.api import Experiment, admission
    from repro_torch.core import SimConfig
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.traces import analysis, generate_calibrated

    cfg = SimConfig(**FULL, use_kernel=True)
    t0 = time.perf_counter()
    ts = generate_calibrated(0, cfg.n_nodes, cfg.n_slots, OFFERED_LOAD,
                             device=dev)
    log(f"[slice] trace: {ts.num_tasks} tasks over {cfg.n_slots} slots, "
        f"offered load {OFFERED_LOAD} ({time.perf_counter() - t0:.2f} s); "
        f"horizon cut from {PAPER_SLOTS} to {cfg.n_slots} slots to fit the "
        f"time limit")
    runs, rates = {}, {}
    for use_kernel in (True, False):
        run_cfg = cfg._replace(use_kernel=use_kernel)
        if not use_kernel:
            run_cfg = run_cfg._replace(n_slots=PLAIN_SLOTS)
        exp = Experiment(ts, run_cfg, "flex-f", device=dev)
        torch.cuda.synchronize()
        fs.reset_launches()
        admission.reset_decisions()
        t0 = time.perf_counter()
        res = exp.run(seeds=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = _counts()
        _check_result(res, run_cfg, ts.num_tasks)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            summary = analysis.summarize(ts, res, 0.99)
        runs[use_kernel] = (res, c)
        rates[use_kernel] = c["decisions"] / wall
        log(f"[slice] flex-f use_kernel={use_kernel}, {run_cfg.n_slots} "
            f"slots: {c['decisions']} decisions in {wall:.2f} s = "
            f"{c['decisions'] / wall:.1f} decisions/s "
            f"({wall * 1e6 / c['decisions']:.2f} us each); {c['queue']} "
            f"flex_score_admit launches for {c['queues']} non-empty slot "
            f"queues, {c['pick']} flex_score_pick launches")
        log(f"[slice] summary use_kernel={use_kernel}: "
            + json.dumps(summary, sort_keys=True))
    res_k, c = runs[True]
    if c["decisions"] == 0 or c["queues"] == 0 or c["queue"] != c["queues"]:
        raise AssertionError(f"flex_score_admit launched {c['queue']} times "
                             f"for {c['queues']} non-empty slot queues")
    if c["pick"] or c["batch"] or c["topk"]:
        raise AssertionError("the queue-kernel run launched another kernel")
    if any(runs[False][1][k] for k in ("queue", "pick", "batch", "topk")):
        raise AssertionError("the plain path launched a kernel")
    _same_decisions("use_kernel=False", runs[False][0], res_k, PLAIN_SLOTS)
    log(f"[slice] the plain path's placements and admit slots equal the "
        f"kernel run's first {PLAIN_SLOTS} slots")
    return ({"flex_score_admit": c["queue"]}, ts, res_k, rates[True],
            runs[False][0])


# ---------------------------------------------------------------------------
# phases b-f: wavefront admission
# ---------------------------------------------------------------------------

def _counts() -> dict:
    from repro_torch.api import admission
    from repro_torch.kernels.flex_score import flex_score as fs
    return dict(pick=fs.LAUNCHES, queue=fs.QUEUE_LAUNCHES,
                batch=fs.BATCH_LAUNCHES, topk=fs.TOPK_LAUNCHES,
                decisions=admission.DECISIONS, queues=admission.QUEUES,
                rounds=admission.ROUNDS, sweeps=admission.SWEEPS,
                dedup_sweeps=admission.DEDUP_SWEEPS)


def _reset_counts() -> None:
    from repro_torch.api import admission
    from repro_torch.kernels.flex_score import flex_score as fs
    torch.cuda.synchronize()
    fs.reset_launches()
    admission.reset_decisions()


def _timed_run(exp):
    _reset_counts()
    t0 = time.perf_counter()
    res = exp.run(seeds=0)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _counts()


def wavefront_study(dev, ts, res_seq):
    """Phase b; returns (the top-K kernel's launches, the run's result)."""
    from repro_torch.api import Experiment
    from repro_torch.core import SimConfig
    from repro_torch.traces import analysis

    cfg = SimConfig(**FULL, admission_mode="wavefront")._replace(
        n_slots=WAVE_SLOTS)
    exp = Experiment(ts, cfg, "flex-f", device=dev)
    torch.cuda.reset_peak_memory_stats()
    res, wall, c = _timed_run(exp)
    peak = torch.cuda.max_memory_allocated()
    _check_result(res, cfg, ts.num_tasks)
    log(f"[wave] flex-f wavefront N={cfg.n_nodes} S={cfg.n_slots} "
        f"(topk={cfg.wavefront_topk}, dedup_buckets={cfg.dedup_buckets}): "
        f"{c['decisions']} decisions in {wall:.2f} s = "
        f"{c['decisions'] / wall:.1f} decisions/s; {c['rounds']} rounds and "
        f"{c['sweeps']} sweeps ({c['rounds'] / cfg.n_slots:.1f} and "
        f"{c['sweeps'] / cfg.n_slots:.1f} per slot, {c['dedup_sweeps']} "
        f"deduplicated); {c['topk']} top-K launches; peak memory "
        f"{peak / 2**20:.1f} MiB")
    if c["sweeps"] == 0 or c["topk"] != c["sweeps"]:
        raise AssertionError(f"top-K kernel launched {c['topk']} times for "
                             f"{c['sweeps']} sweeps")
    if c["pick"] or c["queue"] or c["batch"]:
        raise AssertionError("the wavefront study launched another kernel")
    _same_decisions("wavefront study", res, res_seq, WAVE_SLOTS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        summary = analysis.summarize(ts, res, 0.99)
    log("[wave] summary: " + json.dumps(summary, sort_keys=True))
    log(f"[wave] placements and admit slots identical to the sequential "
        f"queue-kernel run's first {WAVE_SLOTS} slots")
    return c["topk"], res


def topk0_loop(dev, ts, res_seq, n_slots: int = TOPK0_SLOTS) -> int:
    """Phase c; returns the batched argmax kernel's launches.  The run's
    decisions must be those of the sequential kernel run's first
    ``n_slots`` slots, which a sequential run of that depth makes."""
    from repro_torch.api import Experiment
    from repro_torch.core import SimConfig

    cfg = SimConfig(**FULL)._replace(n_slots=n_slots,
                                     admission_mode="wavefront",
                                     wavefront_topk=0)
    res, wall, c = _timed_run(Experiment(ts, cfg, "flex-f", device=dev))
    log(f"[topk0] flex-f wavefront_topk=0 N={cfg.n_nodes} S={n_slots}: "
        f"{c['decisions']} decisions in {wall:.2f} s = "
        f"{c['decisions'] / wall:.1f} decisions/s; {c['rounds']} rounds, "
        f"{c['sweeps']} sweeps, {c['batch']} argmax launches")
    if c["sweeps"] == 0 or not c["batch"] == c["sweeps"] == c["rounds"]:
        raise AssertionError("the topk=0 loop must launch the argmax kernel "
                             "once per round")
    if c["topk"] or c["pick"] or c["queue"]:
        raise AssertionError("the topk=0 loop launched another kernel")
    _same_decisions("wavefront_topk=0", res, res_seq, n_slots)
    log(f"[topk0] placements and admit slots equal the sequential kernel "
        f"run's first {n_slots} slots")
    return c["batch"]


def _node_table(n: int, seed: int, dev):
    from repro_torch.core.types import NodeState

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    node = NodeState.zeros(n, device=dev)._replace(
        est_usage=u(n, 2) * 0.5, requested=u(n, 2) * 0.9,
        n_tasks=(u(n) * 8).to(torch.int32),
        src_count=(u(n, 64) * 2).to(torch.int32))
    return node, u


def dedup_queue(dev, shapes: int = 64) -> None:
    """Phase d: a queue of ``shapes`` distinct (request, source) rows."""
    q = QUEUE
    from repro_torch.api import admission, get_policy
    from repro_torch.core.types import FlexParams

    node, u = _node_table(FULL["n_nodes"], 3, dev)
    j = torch.arange(q, device=dev) % shapes
    reqs = (u(shapes, 2) * 0.1)[j]
    srcs = j.to(torch.int32)
    prios = torch.zeros(q, dtype=torch.int32, device=dev)
    valid = torch.ones(q, dtype=torch.bool, device=dev)
    params = FlexParams.default(device=dev)
    penalty = torch.full((), 1.2, device=dev)
    policy = get_policy("flex-f")
    out = {}
    for batch_mode in (False, True):
        _reset_counts()
        t0 = time.perf_counter()
        out[batch_mode] = admission.admit_queue(
            policy, node, reqs, srcs, prios, valid, penalty, params,
            use_kernel=True, batch_mode=batch_mode)
        torch.cuda.synchronize()
        out[batch_mode] += (time.perf_counter() - t0, _counts())
    (ns_s, pl_s, t_s, c_s), (ns_w, pl_w, t_w, c) = out[False], out[True]
    if c_s["queue"] != 1 or c_s["pick"]:
        raise AssertionError("the sequential dedup queue did not go through "
                             "one launch of the queue kernel")
    log(f"[dedup] flex-f Q={q} ({shapes} distinct rows) N={FULL['n_nodes']}: "
        f"sequential (queue kernel) {t_s * 1e3:.2f} ms, wavefront "
        f"{t_w:.2f} s; {c['rounds']} "
        f"rounds, {c['sweeps']} sweeps, {c['dedup_sweeps']} deduplicated; "
        f"{int((pl_w >= 0).sum())} placed")
    if c["sweeps"] == 0 or c["dedup_sweeps"] != c["sweeps"]:
        raise AssertionError("the dedup-heavy queue did not take the dedup "
                             "branch on every sweep")
    if not torch.equal(pl_s, pl_w):
        raise AssertionError("dedup queue: placements differ from the "
                             "sequential scan")
    for name in ns_s._fields:
        if not torch.equal(getattr(ns_s, name), getattr(ns_w, name)):
            raise AssertionError(f"dedup queue: node {name} differs")


class _Kernel(NamedTuple):
    key: str
    count: int
    self_device_time_total: float   # us, as in key_averages


def _device_kernels(prof) -> list:
    """The profiled run's device activity (kernels, copies, fills) by
    name, summed straight from the raw events: the same sums as the CUDA
    rows of ``prof.key_averages()``, which first builds a Python object
    and a call tree for every host and device event, and so takes most
    of phase f's time (330,000 kernels)."""
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            count, ns = totals.get(e.name(), (0, 0))
            totals[e.name()] = (count + 1, ns + e.duration_ns())
    return [_Kernel(name, count, ns / 1e3)
            for name, (count, ns) in totals.items()]


def profile_wavefront(dev) -> float:
    """Phase f: one full-width queue of distinct tasks, untraced on the
    host clock, then under torch.profiler.  Returns the untraced ms per
    round."""
    q = QUEUE
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import admission, get_policy
    from repro_torch.core.types import FlexParams

    n = FULL["n_nodes"]
    node, u = _node_table(n, 4, dev)
    reqs = u(q, 2) * 0.1
    srcs = (u(q) * 64).to(torch.int32)
    prios = torch.zeros(q, dtype=torch.int32, device=dev)
    valid = torch.ones(q, dtype=torch.bool, device=dev)
    params = FlexParams.default(device=dev)
    penalty = torch.full((), 1.2, device=dev)
    policy = get_policy("flex-f")
    admit = lambda: admission.admit_queue(
        policy, node, reqs, srcs, prios, valid, penalty, params,
        batch_mode=True)
    admit()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    admit()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    c = _counts()
    peak = torch.cuda.max_memory_allocated()
    # Device activity only: with the host's operator events recorded as
    # well, the traced run takes about twenty times the untraced one.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        admit()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"[wprofile] flex-f wavefront Q={q} N={n}: {wall_ms:.1f} ms "
        f"untraced, {c['rounds']} rounds, {c['sweeps']} sweeps "
        f"({wall_ms / c['rounds']:.3f} ms per round); peak memory "
        f"{peak / 2**20:.1f} MiB")
    if busy_ms == 0:
        log("[wprofile] device time not visible to the profiler")
        return wall_ms / c["rounds"]
    log(f"[wprofile] device busy {busy_ms:.2f} ms in {launches} kernels "
        f"({launches / c['rounds']:.1f} per round), idle share "
        f"{1 - busy_ms / wall_ms:.4f}")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:8] + [e for e in ranked[8:] if "flex_batch" in e.key]:
        log(f"[wprofile]   {e.key[:60]}: {e.count} calls, "
            f"{e.self_device_time_total / 1e3:.3f} ms")
    return wall_ms / c["rounds"]


def profile_decisions(dev, decisions: int = 512) -> int:
    """Phase 5: one queue at N = 4000 admitted three ways, the ``admit_one``
    loop (a pick launch a decision), the queue kernel (``admit_queue``,
    one launch) and the policy's plain hooks; all three bit-equal.  Each
    is timed untraced on the host clock, then traced by torch.profiler for
    the device's kernel time and the kernels launched per decision.
    Returns the pick kernel's launches in the ``admit_one`` loop's
    untraced run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import admission, get_policy
    from repro_torch.core.types import FlexParams, NodeState
    from repro_torch.kernels.flex_score import flex_score as fs

    n = FULL["n_nodes"]
    node, u = _node_table(n, 1, dev)
    reqs = u(decisions, 2) * 0.1
    srcs = (u(decisions) * 64).to(torch.int32)
    prios = (u(decisions) * 3).to(torch.int32)
    valid = torch.ones(decisions, dtype=torch.bool, device=dev)
    params = FlexParams.default(device=dev)
    penalty = torch.full((), 1.2, device=dev)
    policy = get_policy("flex-f")

    def admit_one_loop():
        ns = NodeState(*(x.clone() for x in node))
        out = []
        for k in range(decisions):
            ctx = admission.PolicyContext(node=ns, penalty=penalty,
                                          params=params)
            ns, idx = admission.admit_one(
                policy, ctx, admission.TaskView(reqs[k], srcs[k], prios[k]),
                valid[k], use_kernel=True)
            out.append(idx)
        return ns, torch.stack(out)

    paths = {
        "admit_one loop": admit_one_loop,
        "queue kernel": lambda: admission.admit_queue(
            policy, node, reqs, srcs, prios, valid, penalty, params,
            use_kernel=True),
        "plain hooks": lambda: admission.admit_queue(
            policy, node, reqs, srcs, prios, valid, penalty, params),
    }
    results, pick_launches = {}, 0
    for name, admit in paths.items():
        # The queue kernel's path is a few hundred microseconds: profiled
        # over more calls.
        reps = 8 if name == "queue kernel" else 1
        admit()
        _reset_counts()
        t0 = time.perf_counter()
        results[name] = admit()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / decisions
        c = _counts()
        if name == "admit_one loop":
            pick_launches = c["pick"]
            if c["pick"] != decisions or c["queue"]:
                raise AssertionError(f"the admit_one loop launched the pick "
                                     f"kernel {c['pick']} times for "
                                     f"{decisions} decisions")
        elif name == "queue kernel" and (c["queue"] != 1 or c["pick"]):
            raise AssertionError("the queue did not go through one launch of "
                                 "the queue kernel")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                admit()
            torch.cuda.synchronize()
        kernels = _device_kernels(prof)
        per = decisions * reps
        busy_us = sum(e.self_device_time_total for e in kernels) / per
        count = sum(e.count for e in kernels) / per
        if busy_us == 0:
            span_us = _event_ms(admit, reps=5) * 1e3 / decisions
            log(f"[profile] {name}: {wall_us:.3f} us per decision; device "
                f"time not visible to the profiler; {span_us:.3f} us per "
                f"decision between CUDA events around the call")
            continue
        log(f"[profile] flex-f N={n}, {decisions} decisions, {name}: "
            f"{wall_us:.3f} us per decision untraced; device busy "
            f"{busy_us:.3f} us per decision in {count:.4f} kernels (idle "
            f"share {1 - busy_us / wall_us:.4f})")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        for e in top:
            log(f"[profile]   {e.key[:60]}: {e.count / per:.4f} per "
                f"decision, {e.self_device_time_total / e.count:.2f} us each")
    (ns_ref, pl_ref) = results["admit_one loop"]
    for name in ("queue kernel", "plain hooks"):
        ns, pl = results[name]
        if not torch.equal(pl, pl_ref):
            raise AssertionError(f"phase 5: the {name}'s placements differ "
                                 f"from the admit_one loop's")
        for field in ns._fields:
            a, b = getattr(ns, field), getattr(ns_ref, field)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"phase 5: the {name}'s {field} differs "
                                     f"from the admit_one loop's")
    log(f"[profile] the three paths' placements and node states are "
        f"bit-equal ({int((pl_ref >= 0).sum())} of {decisions} placed)")
    return pick_launches


def profile_study(dev, ts, n_slots: int = 3) -> None:
    """Phase 5 (study): where a slot of phase 3's queue-kernel run goes, its
    first ``n_slots`` slots timed untraced, then under torch.profiler: the
    device's busy time and its largest kernels, and the host's wait at
    the slot's one sync."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Experiment
    from repro_torch.core import SimConfig

    cfg = SimConfig(**FULL, use_kernel=True)._replace(n_slots=n_slots)
    exp = Experiment(ts, cfg, "flex-f", device=dev)
    exp.run(seeds=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp.run(seeds=0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_slots
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exp.run(seeds=0)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_slots
    sync_ms = sum(e.self_cpu_time_total for e in events
                  if e.key == "cudaStreamSynchronize") / 1e3 / n_slots
    log(f"[study] flex-f sequential (queue kernel) N={cfg.n_nodes}, first "
        f"{n_slots} slots: {wall_ms:.2f} ms per slot untraced; device busy "
        f"{busy_ms:.2f} ms per slot in "
        f"{sum(e.count for e in kernels) / n_slots:.1f} kernels (idle share "
        f"{1 - busy_ms / wall_ms:.4f}); the host waits {sync_ms:.2f} ms per "
        f"slot at its syncs")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"[study]   {e.key[:60]}: {e.count / n_slots:.1f} per slot, "
            f"{e.self_device_time_total / 1e3 / n_slots:.3f} ms per slot")


# ---------------------------------------------------------------------------
# phase 6: a study's seeds and sweep points as one simulation
# ---------------------------------------------------------------------------

# The four runs of phase 6: two sweep points x two seeds; run (0, 0) is
# phase 3's (and phase b's) run.
STUDY_SEEDS = [0, 1]


def _study_sweep(dev):
    from repro_torch.core.types import FlexParams
    return [FlexParams.default(device=dev),
            FlexParams.default(alpha=0.95, w_src=0.5, device=dev)]


def _run_of(res, p: int, s: int):
    """Run (sweep point p, seed s) of a (P, S, ...) result."""
    from repro_torch.core.simulator import _index
    return _index(res, lambda x: x[p, s])


def _same_run(what: str, got, want) -> None:
    """Every leaf of ``got`` equals ``want``'s, bit for bit."""
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if name == "metrics":
            for field in a._fields:
                if not _bits_equal(getattr(a, field), getattr(b, field)):
                    raise AssertionError(f"{what}: metrics.{field} differs")
        elif not _bits_equal(a, b):
            raise AssertionError(f"{what}: {name} differs")


def _same_first_slots(what: str, got, want, n_slots: int) -> None:
    """``got`` ran the first ``n_slots`` slots of ``want``'s run: it holds
    ``want``'s decisions of those slots and its metrics of them, bit for
    bit."""
    _same_decisions(what, got, want, n_slots)
    for field in got.metrics._fields:
        if not _bits_equal(getattr(got.metrics, field),
                           getattr(want.metrics, field)[:n_slots]):
            raise AssertionError(f"{what}: metrics.{field} differs")


@contextlib.contextmanager
def _counting(module, name: str, calls: list):
    """``module.name`` counting its calls into ``calls`` while inside."""
    orig = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _study_run(exp, dev):
    """One batched run of phase 6's four: (result, wall s, counters)."""
    _reset_counts()
    t0 = time.perf_counter()
    res = exp.run(seeds=STUDY_SEEDS, sweep=_study_sweep(dev))
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _counts()


def _others_against_singles(what, ts, cfg, res, n_slots, dev,
                            runs=((0, 1), (1, 0), (1, 1))) -> None:
    """Runs ``runs`` of ``res`` (sweep point, seed) hold on their first
    ``n_slots`` slots the decisions of single runs that deep; where
    ``res`` is that deep too, every leaf."""
    from repro_torch.api import Experiment

    short = Experiment(ts, cfg._replace(n_slots=n_slots), "flex-f",
                       device=dev)
    sweep = _study_sweep(dev)
    for p, s in runs:
        one = _run_of(short.run(seeds=[s], sweep=[sweep[p]]), 0, 0)
        if cfg.n_slots == n_slots:
            _same_run(f"{what} run ({p}, {s})", _run_of(res, p, s), one)
        else:
            _same_decisions(f"{what} run ({p}, {s})", one,
                            _run_of(res, p, s), n_slots)


def batched_study(dev, ts, res_seq, seq_rate, res_plain, res_wave,
                  round_ms) -> dict:
    """Phase 6; returns the queue kernel's and the top-K kernel's
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Experiment, admission
    from repro_torch.core import SimConfig

    runs = len(STUDY_SEEDS) * len(_study_sweep(dev))
    launches = {}

    # (i) sequential, the queue kernel, phase 3's depth
    cfg = SimConfig(**FULL, use_kernel=True)
    exp = Experiment(ts, cfg, "flex-f", device=dev)
    res, wall, c = _study_run(exp, dev)
    _check_result(_run_of(res, 0, 0), cfg, ts.num_tasks)
    _same_run("phase 6 sequential run (0, 0) against phase 3",
              _run_of(res, 0, 0), res_seq)
    _others_against_singles("phase 6 sequential", ts, cfg, res, 3, dev)
    if c["queue"] != cfg.n_slots or c["queues"] != runs * cfg.n_slots:
        raise AssertionError(f"phase 6: {c['queue']} flex_score_admit "
                             f"launches for {c['queues']} non-empty queues "
                             f"of {runs} runs in {cfg.n_slots} slots (every "
                             f"slot has arrivals: one launch a slot)")
    if c["pick"] or c["batch"] or c["topk"]:
        raise AssertionError("phase 6's sequential study launched another "
                             "kernel")
    launches["flex_score_admit"] = c["queue"]
    rate = c["decisions"] / wall
    log(f"[runs] sequential, {runs} runs x {cfg.n_slots} slots in one "
        f"simulation: {c['decisions']} decisions in {wall:.2f} s = "
        f"{rate:.1f} decisions/s over the runs (phase 3, one run: "
        f"{seq_rate:.1f}; {rate / seq_rate:.2f}x); {wall * 1e3 / cfg.n_slots:.2f}"
        f" ms a slot; {c['queue']} flex_score_admit launches for "
        f"{c['queues']} non-empty queues; run (0, 0) equal to phase 3's on "
        f"every leaf, runs (0, 1), (1, 0), (1, 1) to 3-slot single runs")
    # (the 24-slot run above warmed every shape of these 3 slots)
    short = Experiment(ts, cfg._replace(n_slots=3), "flex-f", device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        short.run(seeds=STUDY_SEEDS, sweep=_study_sweep(dev))
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / 3
    kernels = _device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    sums = sum(e.self_device_time_total for e in kernels
               if "indexing_backward" in e.key) / 1e3 / 3
    if busy:
        log(f"[runs] sequential, 3 slots profiled: {traced_ms:.2f} ms a slot "
            f"traced, device busy {busy:.2f} ms a slot in "
            f"{sum(e.count for e in kernels) / 3:.1f} kernels (idle share "
            f"{max(0.0, 1 - busy / traced_ms):.4f}); the segment sums "
            f"(index_add_'s deterministic kernels) {sums:.2f} ms, "
            f"{sums / busy:.4f} of it")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]:
            log(f"[runs]   {e.key[:60]}: {e.count / 3:.1f} a slot, "
                f"{e.self_device_time_total / 1e3 / 3:.3f} ms a slot")
    else:
        log("[runs] device time not visible to the profiler")
    res = exp = None

    # (ii) wavefront, STUDY_WAVE_SLOTS deep
    cfg = SimConfig(**FULL, admission_mode="wavefront")._replace(
        n_slots=STUDY_WAVE_SLOTS)
    exp = Experiment(ts, cfg, "flex-f", device=dev)
    batched_rounds = []
    with _counting(admission, "_first_unsafe", batched_rounds):
        res, wall, c = _study_run(exp, dev)
    _same_first_slots("phase 6 wavefront run (0, 0) against phase b",
                      _run_of(res, 0, 0), res_wave, STUDY_WAVE_SLOTS)
    _others_against_singles("phase 6 wavefront", ts, cfg, res,
                            STUDY_WAVE_SLOTS, dev)
    if c["sweeps"] == 0 or not 0 < c["topk"] < c["sweeps"]:
        raise AssertionError(f"phase 6 wavefront: {c['topk']} top-K launches "
                             f"for {c['sweeps']} sweeps of {runs} runs")
    if c["pick"] or c["queue"] or c["batch"]:
        raise AssertionError("phase 6's wavefront study launched another "
                             "kernel")
    launches["flex_score_batch_topk"] = c["topk"]
    n_rounds = len(batched_rounds)
    log(f"[runs] wavefront, {runs} runs x {cfg.n_slots} slots: "
        f"{c['decisions']} decisions in {wall:.2f} s = "
        f"{c['decisions'] / wall:.1f} decisions/s; rounds {c['rounds']} and "
        f"sweeps {c['sweeps']} (the runs' sums, as the loop counts them) in "
        f"{n_rounds} batched rounds and {c['topk']} top-K launches "
        f"({c['topk'] / n_rounds:.3f} a batched round); "
        f"{wall * 1e3 / n_rounds:.3f} ms of host time a batched round "
        f"(phase f, one run: {round_ms:.3f}); run (0, 0) makes phase b's "
        f"decisions and metrics of its first {STUDY_WAVE_SLOTS} slot(s), "
        f"runs (0, 1), "
        f"(1, 0) and (1, 1) equal single runs on every leaf")
    res = exp = None

    # (iii) the plain hooks, STUDY_PLAIN_SLOTS deep
    cfg = SimConfig(**FULL)._replace(n_slots=STUDY_PLAIN_SLOTS)
    exp = Experiment(ts, cfg, "flex-f", device=dev)
    steps = []
    with _counting(admission, "admit_one", steps):
        res, wall, c = _study_run(exp, dev)
    _same_first_slots("phase 6 plain run (0, 0) against phase 3's plain run",
                      _run_of(res, 0, 0), res_plain, STUDY_PLAIN_SLOTS)
    if any(c[k] for k in ("pick", "queue", "batch", "topk")):
        raise AssertionError("phase 6's plain path launched a kernel")
    log(f"[runs] plain hooks, {runs} runs x {cfg.n_slots} slots: "
        f"{c['decisions']} decisions in {wall:.2f} s = "
        f"{c['decisions'] / wall:.1f} decisions/s; {len(steps)} decision "
        f"steps, each deciding in all {runs} runs: "
        f"{wall * 1e6 / len(steps):.1f} us of host time a step; run (0, 0) "
        f"makes phase 3's plain run's decisions and metrics of its first "
        f"{STUDY_PLAIN_SLOTS} slot(s)")
    return launches


# ---------------------------------------------------------------------------
# phases n and o: headroom reclamation and the predictive estimators
# ---------------------------------------------------------------------------

def _reclaim_config(n_slots: int):
    from repro_torch.core import SimConfig
    return SimConfig(**FULL, use_kernel=True, estimator="quantile",
                     reclamation=True,
                     reclaim_pool=FULL["arrivals_per_slot"])._replace(
                         n_slots=n_slots)


def _timed_passes(go):
    """Run ``go()`` (one study) with every migrate and reclaim pass timed
    on the host clock (synchronised before and after, which the run's
    wall time includes).  Returns (result, wall s, counts,
    [(pass, entries, s)...] in call order)."""
    from repro_torch.api import ReclaimPolicy, admission

    passes = []
    admit = admission.admit_queue

    def timed_admit(policy, node, requests, *args, **kw):
        if not isinstance(policy, ReclaimPolicy):   # migrate too
            return admit(policy, node, requests, *args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = admit(policy, node, requests, *args, **kw)
        torch.cuda.synchronize()
        passes.append((policy.name, requests.shape[-2],
                       time.perf_counter() - t0))
        return out

    admission.admit_queue = timed_admit
    try:
        _reset_counts()
        t0 = time.perf_counter()
        res = go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        admission.admit_queue = admit
    return res, wall, _counts(), passes


def _check_pass_launches(what: str, c: dict, passes,
                         sweeps: bool = True) -> int:
    """Primary queues through the queue kernel, the migrate and reclaim
    passes through the top-K kernel (at least once with ``sweeps``);
    returns the primary queues."""
    primary = c["queues"] - sum(q > 0 for _, q, _ in passes)
    if primary == 0 or c["queue"] != primary:
        raise AssertionError(f"{what}: flex_score_admit launched "
                             f"{c['queue']} times for {primary} non-empty "
                             f"primary queues")
    if (sweeps and c["sweeps"] == 0) or c["topk"] != c["sweeps"]:
        raise AssertionError(f"{what}: flex_score_batch_topk launched "
                             f"{c['topk']} times for {c['sweeps']} sweeps")
    if c["pick"] or c["batch"]:
        raise AssertionError(f"{what}: another kernel launched")
    return primary


def _refresh_ms(est, n: int, dev) -> float:
    """CUDA-event time of one refresh at N nodes, the window full."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = est.init_state(n, device=dev)
    for _ in range(getattr(est, "window", 1) + 1):
        usage = torch.rand((n, 2), generator=gen, device=dev)
        state = est.refresh(state, usage, None)
    return _event_ms(lambda: est.refresh(state, usage, None), 20)


def reclaim_end_to_end(dev, ts, res_seq, seq_rate) -> dict:
    """Phase n; returns the kernel run's launches by kernel name."""
    from repro_torch.api import Experiment
    from repro_torch.estimators import QuantileWindowEstimator
    from repro_torch.traces import analysis

    cfg = _reclaim_config(RECLAIM_SLOTS)
    exp = Experiment(ts, cfg, "flex-f", device=dev)
    res, wall, c, passes = _timed_passes(lambda: exp.run(seeds=0))
    _check_result(res, cfg, ts.num_tasks)
    primary = _check_pass_launches("phase n", c, passes)
    passes = [(q, t) for _, q, t in passes]
    m = res.metrics
    reclaimed = int(m.n_reclaimed[-1])
    if reclaimed <= 0:
        raise AssertionError(f"phase n reclaimed nothing in {cfg.n_slots} "
                             f"slots")
    n_pool = sum(q for q, _ in passes)
    log(f"[reclaim] flex-f + quantile + reclamation N={cfg.n_nodes} "
        f"S={cfg.n_slots} (pool {cfg.reclaim_pool}): {c['decisions']} "
        f"decisions ({c['decisions'] - n_pool} primary, {n_pool} in the "
        f"reclaim pass) in {wall:.2f} s = {c['decisions'] / wall:.1f} "
        f"decisions/s, {(c['decisions'] - n_pool) / wall:.1f} primary "
        f"(phase 3: {seq_rate:.1f}); {c['queue']} flex_score_admit launches "
        f"for {primary} primary queues, {c['topk']} flex_score_batch_topk "
        f"launches for {c['sweeps']} sweeps")
    log(f"[reclaim] the reclaim pass: {sum(t for _, t in passes) * 1e3 / cfg.n_slots:.2f} "
        f"ms, {c['rounds'] / cfg.n_slots:.2f} rounds, "
        f"{c['sweeps'] / cfg.n_slots:.2f} sweeps and "
        f"{n_pool / cfg.n_slots:.1f} pooled tasks per slot; per slot "
        f"(entries, ms): "
        + ", ".join(f"({q}, {t * 1e3:.1f})" for q, t in passes))
    early = FULL["n_slots"]     # phase 3's depth
    in_early = (res.admit_slot >= 0) & (res.admit_slot < early)
    for name, r, admitted in (
            ("phase 3 (current)", res_seq, int((res_seq.placement >= 0)
                                               .sum())),
            ("phase n (quantile + reclamation)", res, int(in_early.sum()))):
        log(f"[reclaim] first {early} slots, {name}: {admitted} admitted, "
            f"{int(r.metrics.n_reclaimed[early - 1])} reclaimed, QoS "
            f"violated in {float((r.metrics.qos[:early] < 0.99).float().mean()):.4f} "
            f"of slots, mean CPU usage "
            f"{float(r.metrics.usage[:early, 0].mean()):.4f}")
    log(f"[reclaim] all {cfg.n_slots} slots: "
        f"{int((res.placement >= 0).sum())} admitted, {reclaimed} "
        f"reclaimed; n_reclaimed per slot {m.n_reclaimed.tolist()}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        summary = analysis.summarize(ts, res, 0.99)
    log("[reclaim] summary: " + json.dumps(summary, sort_keys=True))

    exp = Experiment(ts, cfg._replace(use_kernel=False, n_slots=PLAIN_SLOTS),
                     "flex-f", device=dev)
    res_p, wall_p, c_p, _ = _timed_passes(lambda: exp.run(seeds=0))
    if c_p["queue"] or c_p["pick"]:
        raise AssertionError("phase n's plain path launched a pick kernel")
    _same_decisions("phase n use_kernel=False", res_p, res, PLAIN_SLOTS)
    if not torch.equal(res_p.metrics.n_reclaimed,
                       m.n_reclaimed[:PLAIN_SLOTS]):
        raise AssertionError("phase n: n_reclaimed differs on the plain "
                             "path")
    log(f"[reclaim] the plain path ({PLAIN_SLOTS} slots, {wall_p:.2f} s): "
        f"placements, admit slots and n_reclaimed equal the kernel run's")

    ms = _refresh_ms(QuantileWindowEstimator(), cfg.n_nodes, dev)
    log(f"[reclaim] quantile refresh (W = 12, N = {cfg.n_nodes}, R = 2): "
        f"{ms:.4f} ms (CUDA events, eager)")
    small = small_run_against_cpu(
        dev, "sequential", "least-fit", estimator="quantile",
        reclamation=True, reclaim_pool=SMALL["arrivals_per_slot"])
    if int(small.metrics.n_reclaimed[-1]) <= 0:
        raise AssertionError("the small reclamation run reclaimed nothing")
    return {"flex_score_admit": c["queue"],
            "flex_score_batch_topk": c["topk"]}


def learned_end_to_end(dev, ts) -> dict:
    """Phase o; returns the study's launches by kernel name."""
    import tempfile

    from repro_torch.api import Experiment
    from repro_torch.estimators import (LearnedUsageEstimator,
                                        make_dataset, train_usage_predictor)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        params, losses = train_usage_predictor(ts, device=dev,
                                               ckpt_dir=ckpt_dir)
        restored = LearnedUsageEstimator.from_checkpoint(ckpt_dir)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"training did not reduce the loss: "
                             f"{losses[0]} -> {losses[-1]}")
    # timed again, warm: 200 steps after the dataset is built
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_usage_predictor(ts, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    white = torch.randn((min(ts.num_tasks, 512), 64), device=dev)
    t0 = time.perf_counter()
    make_dataset(ts, 64, 12, white)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    log(f"[learned] trained at the reference's defaults (window 12, hidden "
        f"8, 64-slot series of 512 tasks, 200 steps of 1024): loss "
        f"{losses[0]:.6g} -> {losses[-1]:.6g}; {train_s:.3f} s, of it "
        f"{data_s:.3f} s building the dataset: "
        f"{(train_s - data_s) * 1e3 / 200:.3f} ms per training step")

    in_memory = LearnedUsageEstimator.from_params(params, 12, 8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n = FULL["n_nodes"]
    states = [e.init_state(n, device=dev) for e in (restored, in_memory)]
    for slot in range(16):
        usage = torch.rand((n, 2), generator=gen, device=dev)
        states = [e.refresh(st, usage, None)
                  for e, st in zip((restored, in_memory), states)]
        if not torch.equal(states[0].est, states[1].est):
            raise AssertionError(f"the checkpoint's estimates differ from "
                                 f"the trained ones at slot {slot}")
    ms = _refresh_ms(restored, n, dev)
    log(f"[learned] the checkpoint's estimates equal the trained "
        f"predictor's (16 slots, N = {n}); refresh {ms:.4f} ms (CUDA "
        f"events, eager)")

    cfg = _reclaim_config(RECLAIM_SLOTS)
    exp = Experiment(ts, cfg, "flex-f", device=dev, estimator=restored)
    res, wall, c, passes = _timed_passes(lambda: exp.run(seeds=0))
    _check_result(res, cfg, ts.num_tasks)
    _check_pass_launches("phase o", c, passes)
    log(f"[learned] flex-f + trained learned + reclamation N={n} "
        f"S={cfg.n_slots}: {c['decisions']} decisions in {wall:.2f} s = "
        f"{c['decisions'] / wall:.1f} decisions/s; "
        f"{int((res.placement >= 0).sum())} admitted, "
        f"{int(res.metrics.n_reclaimed[-1])} reclaimed; {c['queue']} "
        f"flex_score_admit and {c['topk']} flex_score_batch_topk launches "
        f"({c['sweeps']} sweeps)")
    return {"flex_score_admit": c["queue"],
            "flex_score_batch_topk": c["topk"]}


# ---------------------------------------------------------------------------
# phases p and q: faults, degradation, migration and the guard
# ---------------------------------------------------------------------------

# Counters that grow when a placed task leaves its node (evicted or
# migrated), which changes its final placement and admit slot.
MOVES = ("n_fault_evicted", "n_degrade_evicted", "n_migrated",
         "n_migration_failed")


def _early_slots(what: str, dev, ts, cfg, sched, full) -> None:
    """Phases p and q's check of their first FAULT_SLOTS slots: the plain
    path run to that depth against the full kernel run, every counter
    series on the slots they share, and the placements and admit slots as
    ``_same_decisions`` compares them.  Where the full run evicts or
    migrates after those slots, a task placed early may end elsewhere, so
    the placements are held against a kernel run of the same depth."""
    from repro_torch.core import run

    cfg = cfg._replace(n_slots=FAULT_SLOTS)
    plain, wall_p, c_p, _ = _timed_passes(lambda: run(
        ts, cfg._replace(use_kernel=False), "flex-f", device=dev,
        fault_schedule=sched))
    if c_p["queue"] or c_p["pick"]:
        raise AssertionError(f"{what}: the plain path launched a pick "
                             f"kernel")
    for name in COUNTERS + ("qos", "penalty", "guard_err_q"):
        a = getattr(plain.metrics, name)
        if not torch.equal(a, getattr(full.metrics, name)[:a.shape[0]]):
            raise AssertionError(f"{what}: metrics.{name} of the first "
                                 f"{FAULT_SLOTS} slots differs between the "
                                 f"plain path and the kernel run")
    later = [name for name in MOVES
             if getattr(full.metrics, name).numel()
             and int(getattr(full.metrics, name)[-1])
             != int(getattr(full.metrics, name)[FAULT_SLOTS - 1])]
    if later:
        kernel, wall_k, _, _ = _timed_passes(
            lambda: run(ts, cfg, "flex-f", device=dev, fault_schedule=sched))
        for name in ("placement", "admit_slot", "qos_ok_slots",
                     "active_slots"):
            if not torch.equal(getattr(plain, name), getattr(kernel, name)):
                raise AssertionError(f"{what}: {name} differs between the "
                                     f"plain and the kernel path")
        against = (f"a kernel run of the same depth ({wall_k:.2f} s; the "
                   f"full run's {', '.join(later)} grow later)")
    else:
        _same_decisions(what, plain, full, FAULT_SLOTS)
        against = "the full kernel run"
    log(f"[{what}] the first {FAULT_SLOTS} slots: the plain path "
        f"({wall_p:.2f} s) makes the full kernel run's counters, and the "
        f"placements and admit slots of {against}")


def _fault_config(migrate: bool):
    """Phase p's runs: flex-f with backoff and jitter under the bench's
    graceful degradation (benchmarks/bench_fault_recovery.py
    ``_GRACEFUL``); (ii) adds its warning and ``_MIGRATION``."""
    from repro_torch.core import SimConfig
    from repro_torch.faults import FaultConfig
    from repro_torch.migration import MigrationConfig

    graceful = FaultConfig(degrade=True, qos_window=8, degrade_evict=16,
                           degrade_spare_production=True)
    cfg = SimConfig(**FULL, use_kernel=True, retry_backoff=2, retry_jitter=2,
                    faults=graceful)
    if migrate:
        cfg = cfg._replace(faults=graceful._replace(warn_slots=3),
                           migration=MigrationConfig(
                               bandwidth=256, pool_size=1024,
                               migrate_cost=1))
    return cfg


def fault_end_to_end(dev, ts, seq_rate) -> dict:
    """Phase p; returns both runs' launches by kernel name."""
    from repro_torch.core import run
    from repro_torch.faults import crash_burst
    from repro_torch.traces import analysis

    n, n_slots = FULL["n_nodes"], FULL["n_slots"]
    sched = crash_burst(n_slots, n, slot=6, frac=0.4, duration=8,
                        warn_slots=3, device=dev)
    launches = {"flex_score_admit": 0, "flex_score_batch_topk": 0}
    recovery = {}
    for name, migrate in (("(i) graceful", False),
                          ("(ii) graceful + migration", True)):
        cfg = _fault_config(migrate)
        res, wall, c, passes = _timed_passes(
            lambda: run(ts, cfg, "flex-f", device=dev, fault_schedule=sched))
        _check_result(res, cfg, ts.num_tasks)
        primary = _check_pass_launches(f"phase p {name}", c, passes,
                                       sweeps=migrate)
        m = res.metrics
        if not migrate and int(m.n_fault_evicted[-1]) <= 0:
            raise AssertionError(f"phase p {name}: the crash evicted "
                                 f"nothing")
        mig = [(q, t) for kind, q, t in passes if kind == "migrate"]
        if migrate and int(m.n_migrated[-1]) <= 0:
            raise AssertionError(f"phase p {name}: nothing migrated")
        n_mig = sum(q for q, _ in mig)
        log(f"[fault] flex-f {name} N={n} S={n_slots}, crash_burst(slot=6, "
            f"frac=0.4, duration=8, warn_slots=3), backoff 2, jitter 2: "
            f"{c['decisions']} decisions ({c['decisions'] - n_mig} primary) "
            f"in {wall:.2f} s = {c['decisions'] / wall:.1f} decisions/s "
            f"(phase 3: {seq_rate:.1f}), {wall * 1e3 / n_slots:.1f} ms a "
            f"slot; {c['queue']} flex_score_admit launches for {primary} "
            f"primary queues, {c['topk']} flex_score_batch_topk launches "
            f"for {c['sweeps']} sweeps")
        if migrate:
            log(f"[fault] the migration pass: "
                f"{sum(t for _, t in mig) * 1e3 / n_slots:.2f} ms a slot "
                f"on average over {n_slots} slots, {n_mig} attempts; per "
                f"pass (entries, ms): "
                + ", ".join(f"({q}, {t * 1e3:.1f})" for q, t in mig))
        log(f"[fault] {name} per slot: fault-evicted "
            f"{m.n_fault_evicted.tolist()}, shed "
            f"{m.n_degrade_evicted.tolist()}, migrated "
            f"{m.n_migrated.tolist()}, migration failed "
            f"{m.n_migration_failed.tolist()}, QoS "
            f"{[round(x, 4) for x in m.qos.tolist()]}")
        recovery[name] = analysis.fault_recovery(res, 0.99)
        log(f"[fault] fault_recovery {name}: "
            + json.dumps(recovery[name], sort_keys=True))
        for k in launches:
            launches[k] += c["queue" if k == "flex_score_admit" else "topk"]
        full = res
    retained = [r["retained_task_slots"] for r in recovery.values()]
    log(f"[fault] retained task-slots (ii) / (i): {retained[1]} / "
        f"{retained[0]} = {retained[1] / max(retained[0], 1):.4f}")
    _early_slots("fault", dev, ts, _fault_config(True), sched, full)
    return launches


# The guard bench's config (benchmarks/bench_guard.py ``_GUARD``), cut to
# the paper's cluster and the 24-slot horizon.  The bench's threshold,
# 0.118, sits between the steady-state and the mid-ramp drift of its
# 512-node cluster; at 4000 nodes (H100, 700 W) the drift reaches 0.1329
# while the cluster fills, before the ramp (slot 3), and 0.2453 mid-ramp
# (slot 7), so the phase trips at 0.19, between the two.  The bench's
# cooldown, 48 slots, covers its up-ramp, hold and down-ramp (16 + 16 +
# 16); the phase's surge is cut to 6 + 4 + 6 and the cooldown with it to
# 16, so the half-open probe lands on the slots after the surge.
GUARD = dict(window=8, err_quantile=0.9, trip_threshold=0.19, cooldown=16,
             probe_slots=8, probe_reclaim=8, open_blend=1.0, guard_scale=1.0)


def guard_end_to_end(dev, ts) -> dict:
    """Phase q; returns the run's launches by kernel name."""
    from repro_torch.core import SimConfig, run
    from repro_torch.faults import usage_surge
    from repro_torch.guard import HALF_OPEN, OPEN, GuardConfig
    from repro_torch.traces import analysis

    n, n_slots = FULL["n_nodes"], FULL["n_slots"]
    start, ramp, hold = 4, 6, 4
    sched = usage_surge(n_slots, n, start=start, ramp=ramp, hold=hold,
                        peak_mult=2.0, device=dev)
    cfg = SimConfig(**FULL, use_kernel=True, estimator="ewma",
                    reclamation=True, reclaim_pool=FULL["arrivals_per_slot"],
                    guard=GuardConfig(**GUARD))
    res, wall, c, passes = _timed_passes(
        lambda: run(ts, cfg, "flex-f", device=dev, fault_schedule=sched))
    _check_result(res, cfg, ts.num_tasks)
    primary = _check_pass_launches("phase q", c, passes)
    m = res.metrics
    rep = analysis.guard_report(res)
    states = m.guard_tripped.tolist()
    deferred = m.n_guard_deferred.tolist()
    err_q = m.guard_err_q.tolist()
    after = start + 2 * ramp + hold     # the first slot after the surge
    log(f"[guard] flex-f + ewma + reclamation (pool {cfg.reclaim_pool}) + "
        f"guard N={n} S={n_slots}, usage_surge(start={start}, ramp={ramp}, "
        f"hold={hold}, peak 2.0): {c['decisions']} decisions in "
        f"{wall:.2f} s, {wall * 1e3 / n_slots:.1f} ms a slot; {c['queue']} "
        f"flex_score_admit launches for {primary} primary queues, "
        f"{c['topk']} flex_score_batch_topk launches for {c['sweeps']} "
        f"sweeps")
    log(f"[guard] breaker per slot {states}; trip statistic per slot "
        f"{[round(x, 4) for x in err_q]} (before the ramp, slot "
        f"{start - 1}: {err_q[start - 1]:.4f}; mid-ramp, slot "
        f"{start + ramp // 2}: {err_q[start + ramp // 2]:.4f}; after the "
        f"surge, slots {after}-{n_slots - 1}: at most "
        f"{max(err_q[after:]):.4f}; threshold {GUARD['trip_threshold']}); "
        f"deferred {deferred}")
    log("[guard] guard_report: " + json.dumps(rep, sort_keys=True))
    opened = [s for s, st in enumerate(states) if st == OPEN]
    half = [s for s, st in enumerate(states) if st == HALF_OPEN]
    if rep["guard_trips"] < 1 or not start <= opened[0] < start + ramp:
        raise AssertionError(f"phase q: the breaker did not first trip on "
                             f"the ramp (slots {start}-{start + ramp - 1})")
    reclaim = [q for kind, q, _ in passes if kind == "reclaim"]
    if len(reclaim) != n_slots:
        raise AssertionError("phase q: not one reclaim pass a slot")
    if any(reclaim[s] for s in opened):
        raise AssertionError("phase q: the reclaim pool was admitted while "
                             "the breaker was OPEN")
    before = deferred[opened[0] - 1]
    if deferred[opened[-1]] <= before:
        raise AssertionError("phase q: nothing deferred while OPEN")
    probe = [reclaim[s] for s in half]
    if not probe or max(probe) > GUARD["probe_reclaim"] or not any(probe):
        raise AssertionError(f"phase q: the half-open probe admitted "
                             f"{probe} candidates a slot (at most "
                             f"{GUARD['probe_reclaim']}, some)")
    log(f"[guard] OPEN over slots {opened[0]}-{opened[-1]}, HALF_OPEN over "
        f"{half[0]}-{half[-1]}; the probe passed {probe} candidates a slot")
    _early_slots("guard", dev, ts, cfg, sched, res)
    return {"flex_score_admit": c["queue"],
            "flex_score_batch_topk": c["topk"]}


# ---------------------------------------------------------------------------
# phase g: the flash-attention kernel against plain
# ---------------------------------------------------------------------------

# The six shapes of tests/test_kernels_flash.py: (B, H, KV, S, hd, causal,
# window).
FLASH_TEST_CASES = ((1, 4, 4, 128, 64, True, 0), (2, 4, 2, 256, 64, True, 0),
                    (1, 8, 1, 256, 128, True, 0), (2, 2, 2, 128, 32, False, 0),
                    (1, 4, 2, 512, 64, True, 128), (1, 2, 2, 256, 80, True, 0))
# stablelm-3b's single-request prefill: B = 1, H = KV = 32, hd = 80, causal.
FLASH_PREFILL_S = (1, 37, 512, 1000, 2048, 4096)
# mixtral-8x7b's (phase s): B = 1, H = 32 over KV = 8, hd = 128, causal,
# a window of 4096 (which a prompt past 4096 tokens reaches).
FLASH_MOE_S = (37, 1329, 2048, 5000)
FLASH_TIMED_S = (2048, 4096)
# Sq != Sk and the unmasked encoder, at the shapes phases t and u give the
# kernel: (B, H, KV, Sq, Sk, hd, causal).  whisper-medium's encoder (S =
# 1500 frames) and its decoder's cross attention (Sq = the prompt, Sk =
# 1500), H = KV = 16, hd = 64, unmasked; llava-next-mistral-7b's causal
# prefill over 576 patches plus the prompt, H = 32 over KV = 8, hd = 128.
FLASH_WHISPER = ([(b, 16, 16, 1500, 1500, 64, False) for b in (1, 8)]
                 + [(8, 16, 16, sq, 1500, 64, False) for sq in (1, 37, 447)])
FLASH_LLAVA = [(1, 32, 8, 577, 577, 128, True)] + [
    (4, 32, 8, s, s, 128, True) for s in (1576, 2048)]
# Timed, beside the bound and SDPA: the cross and encoder shapes of phase t.
FLASH_TIMED_CROSS = ((8, 16, 16, 447, 1500, 64, False),
                     (8, 16, 16, 1500, 1500, 64, False))
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The earlier (mma.sync) design's times at the timed shapes, from PERF.md's
# kernel table: its run P2 at S = 2048, its run H at S = 4096 (NVIDIA H100
# 80GB HBM3, 700.00 W); logged beside this run's times.
FLASH_EARLIER_MS = {2048: ("run P2", 0.4855), 4096: ("run H", 1.3564)}
# A bf16 case is also held, element by element, to one bf16 rounding step
# of the plain value plus the float32 arithmetic's error before it: both
# sides accumulate in float32 (the kernel carries P as two bf16 halves,
# which leaves 2^-18 of it, times |v| <= 5) and round once to bf16, and
# a rounding step is at most 2^-7 (1 + 2^-8) of the plain value.  Late in
# a long row the outputs are near 0.05 and this bound near 5e-4, where
# 2e-2 alone would pass a kernel that mishandled a late K/V tile.
BF16_STEP = 2.0 ** -7 * (1 + 2.0 ** -8)
BF16_F32_ERR = 1e-4
BF16_FLOPS = 989e12


def _flash_bound(b: int, h: int, kv: int, s: int, hd: int, elt: int,
                 sk: int = 0, causal: bool = True):
    """(bound ms, what bounds it) of one call of Sq = ``s`` queries over
    ``sk`` keys (default ``s``): 4 hd flops for each unmasked (query, key)
    pair per head (S (S + 1) / 2 under the causal mask, Sq Sk without)
    over the bf16 tensor-core peak; q, k, v read and o written once over
    3.35 TB/s."""
    sk = sk or s
    pairs = (sum(min(i + 1, sk) for i in range(s)) if causal else s * sk)
    flops = 4 * hd * h * b * pairs
    n_bytes = (2 * b * h * s * hd + 2 * b * kv * sk * hd) * elt
    by_ops = flops / BF16_FLOPS * 1e3
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def _flash_check(name: str, got, want, worst: dict) -> None:
    """Hold one kernel result against the plain version's."""
    diff = (got.float() - want.float()).abs()
    err, tol = float(diff.max()), FLASH_TOL[got.dtype]
    worst[got.dtype] = max(worst[got.dtype], err)
    if not err <= tol:
        raise AssertionError(f"flash {name}: max abs error {err} above "
                             f"{tol}")
    msg = f"max abs error {err:.3g} (tolerance {tol:.3g})"
    if got.dtype == torch.bfloat16:
        step = BF16_STEP * want.float().abs() + BF16_F32_ERR
        used = float((diff / step).max())
        if not used <= 1.0:
            raise AssertionError(f"flash {name}: an element is off by "
                                 f"{used:.3f} x (one bf16 rounding step "
                                 f"+ {BF16_F32_ERR})")
        msg += (f"; at most {used:.3f} of one bf16 rounding step + "
                f"{BF16_F32_ERR} per element")
    log(f"[flash] {name}: {msg}")


def flash_vs_plain(dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bhsd)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[flash] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = (list(FLASH_TEST_CASES)
             + [(1, 32, 32, s, 80, True, 0) for s in FLASH_PREFILL_S]
             + [(1, 32, 8, s, 128, True, 4096) for s in FLASH_MOE_S])
    cases = ([(b, h, kv, s, s, hd, causal, window)
              for b, h, kv, s, hd, causal, window in cases]
             + [(*c, 0) for c in FLASH_WHISPER + FLASH_LLAVA])
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b, h, kv, sq, sk, hd, causal, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, n, s, hd), generator=gen, device=dev
                                   ).to(dtype)
                       for n, s in ((h, sq), (kv, sk), (kv, sk)))
            got = flash_attention_bhsd(q, k, v, causal=causal, window=window)
            want = attention_ref(q, k, v, causal=causal, window=window)
            shape = f"S={sq}" if sq == sk else f"Sq={sq} Sk={sk}"
            _flash_check(f"B={b} H={h} KV={kv} {shape} hd={hd} causal="
                         f"{causal} window={window} {str(dtype)[6:]}",
                         got, want, worst)
            del q, k, v, got, want
    # As the serving path calls it: q, k, v from one full-width attention
    # layer's projections and partial RoPE, (B, S, H, hd) tensors that
    # chunked_attention hands on as transposed views, with a strided
    # output.
    cfg = _full_config()
    attn = M._attn_init(cfg, gen)
    for dtype in (torch.float32, torch.bfloat16):
        p = {key: w.to(dtype) for key, w in attn.items()}
        for s in FLASH_PREFILL_S:
            x = torch.randn((1, s, cfg.d_model), generator=gen,
                            device=dev).to(dtype)
            q, k, v = M._qkv(cfg, p, x)
            pos = torch.arange(s, device=dev)
            q = L.rope(q, pos, cfg.rope_theta, cfg.rope_frac)
            k = L.rope(k, pos, cfg.rope_theta, cfg.rope_frac)
            got = L.chunked_attention(q, k, v, causal=True,
                                      window=cfg.window)
            want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 window=cfg.window).transpose(1, 2)
            _flash_check(f"{cfg.name} layer, chunked_attention on (1, {s}, "
                         f"{cfg.n_heads}, {cfg.head_dim_}) views "
                         f"{str(dtype)[6:]}", got, want, worst)
        del p
    timed = {}
    for s in FLASH_TIMED_S:
        q, k, v = (torch.randn((1, 32, s, 80), generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
        ms = _event_ms(lambda: flash_attention_bhsd(q, k, v), reps=10)
        plain_ms = _event_ms(lambda: attention_ref(q, k, v), reps=5)
        lib_ms = _event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=10)
        # Device time alone: 20 launches replayed from a CUDA graph.
        graph_ms = _median_ms(lambda: flash_attention_bhsd(q, k, v), reps=5,
                              inner=20)
        lib_graph_ms = _median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=5, inner=20)
        bound_ms, bound_by = _flash_bound(1, 32, 32, s, 80, 2)
        timed[s] = (ms, plain_ms, lib_ms, bound_ms, bound_by)
        run, earlier = FLASH_EARLIER_MS[s]
        log(f"[flash] B=1 H=32 hd=80 S={s} causal bf16: kernel {ms:.4f} ms "
            f"(graph replay {graph_ms:.4f} ms; the earlier design "
            f"{earlier:.4f} ms in {run}), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {lib_ms:.4f} ms (graph replay "
            f"{lib_graph_ms:.4f} ms); bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.4f} of it")
    for b, h, kv, sq, sk, hd, causal in FLASH_TIMED_CROSS:
        q = torch.randn((b, h, sq, hd), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.randn((b, kv, sk, hd), generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        run = lambda: flash_attention_bhsd(q, k, v, causal=causal)
        lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                     is_causal=causal)
        t_ms, t_graph = _event_ms(run, reps=10), _median_ms(run, 5, 20)
        t_plain = _event_ms(lambda: attention_ref(q, k, v, causal=causal),
                            reps=5)
        t_lib, t_lib_graph = _event_ms(lib, reps=10), _median_ms(lib, 5, 20)
        b_ms, b_by = _flash_bound(b, h, kv, sq, hd, 2, sk, causal)
        log(f"[flash] B={b} H={h} hd={hd} Sq={sq} Sk={sk} causal={causal} "
            f"bf16: kernel {t_ms:.4f} ms (graph replay {t_graph:.4f} ms), "
            f"plain {t_plain:.4f} ms, scaled_dot_product_attention "
            f"{t_lib:.4f} ms (graph replay {t_lib_graph:.4f} ms); bound "
            f"{b_ms:.4f} ms ({b_by}), {b_ms / t_ms:.4f} of it eager, "
            f"{b_ms / t_graph:.4f} replayed")
        del q, k, v
    ms, plain_ms, lib_ms, bound_ms, bound_by = timed[FLASH_TIMED_S[0]]
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/"
                         "flash_attention.py:27",
                launches=0, max_abs_err=max(worst.values()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phase k: the SSD scan kernel against plain
# ---------------------------------------------------------------------------

# The four cases of tests/test_kernels_ssd.py: (Bt, S, H, P, N, chunk).
SSD_TEST_CASES = ((2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64),
                  (2, 64, 8, 16, 8, 16), (1, 128, 1, 128, 64, 128))
# The full configs' single-request prefill shapes: (name, H, P, N), Q = 256.
SSD_FULL = (("mamba2-370m", 32, 64, 128), ("zamba2-7b", 112, 64, 64))
SSD_RAGGED_S = (1, 37, 255, 257, 1000)     # at mamba2-370m's shape
SSD_PREFILL_S = (512, 1337, 2048, 4096)
SSD_TIMED_S = (2048, 4096)
SSD_LAYER_S = (37, 2048)
SSD_CHUNK = 256
# The earlier (one block per (b, h), CUDA-core) design's times at the timed
# shapes, from PERF.md's kernel table: its run P2 (NVIDIA H100 80GB HBM3,
# 700.00 W); logged beside this run's times.
SSD_EARLIER_MS = {("mamba2-370m", 2048): 3.0432, ("mamba2-370m", 4096): 6.3754,
                  ("zamba2-7b", 2048): 2.5286, ("zamba2-7b", 4096): 4.9790}
# float32: the kernel sums the chunk's dual form in another order than the
# sequential recurrence (ssd_ref) and than ssd_chunked's einsums; the JAX
# test's bound, 5e-4 * max(1, Q / 64), taken relative to the largest plain
# output (max |y| is 10-60 here).
SSD_F32_REL = 5e-4
# bfloat16: y is rounded once from float32 sums, so each element is held to
# one bf16 rounding step of the plain float32 value plus the float32 sums'
# own error (SSD_F32_REL of the largest output); the state stays float32.
TF32_FLOPS = 494.7e12


def _peak_flops(elt: int) -> float:
    """The dense tensor-core peak for inputs of ``elt`` bytes: bf16's, or
    float32's through TF32."""
    return BF16_FLOPS if elt == 2 else TF32_FLOPS


def _ssd_inputs(b, s, h, p, n, gen, dev, dtype=torch.float32):
    """The JAX test's distributions: x, B, C normal; dt = softplus(normal);
    A = U[1, 8]."""
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x, B, C = r(b, s, h, p).to(dtype), r(b, s, n).to(dtype), r(b, s, n).to(
        dtype)
    dt = torch.nn.functional.softplus(r(b, s, h))
    A_log = torch.log(1 + 7 * torch.rand((h,), generator=gen, device=dev))
    return x, B, C, dt, A_log


def _ssd_bound(b: int, s: int, h: int, p: int, n: int, q: int, elt: int):
    """(bound ms, what bounds it) of one call.  Operations, at the
    tensor-core peak for the inputs' type (``_peak_flops``): per chunk of
    r rows the causal half of C B^T, r (r + 1) N, once for all heads (they
    share one (B, C) group), and per head the causal half of the scores
    times x, r (r + 1) P, and the two state products, 4 r N P.  Bytes, at
    3.35 TB/s: x, B, C, a, dt read and y, the state written once."""
    shared = per_head = 0
    for c0 in range(0, s, q):
        r = min(q, s - c0)
        shared += r * (r + 1) * n
        per_head += r * (r + 1) * p + 4 * r * n * p
    flops = b * shared + b * h * per_head
    n_bytes = (2 * b * s * h * p + 2 * b * s * n) * elt + 2 * b * s * h * 4 \
        + b * h * p * n * 4
    by_ops = flops / _peak_flops(elt) * 1e3
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def _ssd_check(name: str, got, want, q: int, worst: dict) -> None:
    """Hold the kernel's (y, state) against a plain version's: float32
    values within SSD_F32_REL * max(1, Q / 64) of the largest plain value,
    bf16 elements each within one rounding step of their plain value plus
    that bound."""
    tol = SSD_F32_REL * max(1.0, q / 64)
    msgs = []
    for what, g, w in (("y", got[0], want[0]), ("state", got[1], want[1])):
        w = w.float()
        scale = max(1.0, float(w.abs().max()))
        diff = (g.float() - w).abs()
        worst[g.dtype] = max(worst[g.dtype], float(diff.max()))
        if g.dtype == torch.bfloat16:
            used = float((diff / (BF16_STEP * w.abs() + tol * scale)).max())
            if not used <= 1.0:
                raise AssertionError(
                    f"ssd {name}: a {what} element is off by {used:.3f} x "
                    f"(one bf16 rounding step + {tol:.3g} x {scale:.3g})")
            msgs.append(f"{what} max abs error {float(diff.max()):.3g}, at "
                        f"most {used:.3f} of one bf16 step + {tol:.3g} of "
                        f"max |plain| {scale:.3g}")
            continue
        rel = float(diff.max()) / scale
        if not rel <= tol:
            raise AssertionError(f"ssd {name}: {what} max abs error "
                                 f"{float(diff.max())} is {rel:.3g} of the "
                                 f"largest plain value {scale:.3g}, above "
                                 f"{tol:.3g}")
        msgs.append(f"{what} {rel:.3g} of max |plain| {scale:.3g}")
    log(f"[ssd] {name}: " + "; ".join(msgs) + f" (tolerance {tol:.3g})")


def ssd_vs_plain(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.models import ssm as SSM

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    h0, p0, n0 = SSD_FULL[0][1:]
    cases = ([(f"test case {c}", *c) for c in SSD_TEST_CASES]
             + [(f"mamba2-370m shape, ragged S={s}", 1, s, h0, p0, n0,
                 SSD_CHUNK) for s in SSD_RAGGED_S]
             + [(f"{name} prefill S={s}", 1, s, h, p, n, SSD_CHUNK)
                for name, h, p, n in SSD_FULL for s in SSD_PREFILL_S])
    for label, b, s, h, p, n, q in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(b, s, h, p, n, gen, dev, dtype)
            got = ssd_scan(*args, q, return_state=True)
            tag = f"{label} {str(dtype)[6:]}"
            _ssd_check(f"{tag} vs ssd_ref", got, ssd_ref(*args), q, worst)
            _ssd_check(f"{tag} vs ssd_chunked", got,
                       SSM.ssd_chunked(*args, q), q, worst)
    # As the serving path calls it: one full-width layer's projections,
    # x, B and C as strided views of its xBC, through ssm_apply.
    for name, *_ in SSD_FULL:
        cfg = get_config(name)
        p = SSM.ssm_init(cfg, gen)
        seen = []

        def recording(*args, **kw):
            out = ssd_scan(*args, **kw)
            seen.append((args, out))
            return out

        SSM.ssd_scan = recording
        try:
            for s in SSD_LAYER_S:
                x = torch.randn((1, s, cfg.d_model), generator=gen,
                                device=dev).to(torch.bfloat16)
                SSM.ssm_apply(cfg, p, x, with_cache=True)
        finally:
            SSM.ssd_scan = ssd_scan
        for args, got in seen:
            xh, Bm = args[0], args[1]
            if xh.is_contiguous() or Bm.is_contiguous():
                raise AssertionError("ssm_apply passed copies, not views "
                                     "of xBC")
            _ssd_check(f"{name} layer through ssm_apply, x {tuple(xh.shape)}"
                       f" bf16 views", got, ssd_ref(*args[:5]), args[5],
                       worst)
        del p
    timed = {}
    for name, h, p, n in SSD_FULL:
        for s in SSD_TIMED_S:
            args = _ssd_inputs(1, s, h, p, n, gen, dev, torch.bfloat16)
            ms = _event_ms(lambda: ssd_scan(*args, SSD_CHUNK,
                                            return_state=True), reps=10)
            plain_ms = _event_ms(lambda: ssd_ref(*args), reps=3)
            chunked_ms = _event_ms(lambda: SSM.ssd_chunked(*args, SSD_CHUNK),
                                   reps=10)
            # Device time alone (the three kernels and the adapter's
            # element-wise ops): 20 calls replayed from a CUDA graph.
            graph_ms = _median_ms(lambda: ssd_scan(*args, SSD_CHUNK,
                                                   return_state=True),
                                  reps=5, inner=20)
            bound_ms, bound_by = _ssd_bound(1, s, h, p, n, SSD_CHUNK, 2)
            timed[(name, s)] = (ms, plain_ms, bound_ms, bound_by)
            log(f"[ssd] {name} B=1 H={h} P={p} N={n} S={s} Q={SSD_CHUNK} "
                f"bf16: kernel {ms:.4f} ms (graph replay {graph_ms:.4f} ms; "
                f"the earlier design {SSD_EARLIER_MS[(name, s)]:.4f} ms in "
                f"run P2), plain (ssd_ref) {plain_ms:.4f} ms, ssd_chunked "
                f"{chunked_ms:.4f} ms (kernel / ssd_chunked "
                f"{ms / chunked_ms:.4f}), library: none; bound "
                f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.4f} of it")
    ms, plain_ms, bound_ms, bound_by = timed[(SSD_FULL[0][0],
                                              SSD_TIMED_S[0])]
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/ssd_scan.py:26",
                launches=0, max_abs_err=max(worst.values()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# ---------------------------------------------------------------------------
# phase v: the SSD scan's backward kernel against plain
# ---------------------------------------------------------------------------

# The training shapes: mamba2-370m at phase w's batch, zamba2-7b at one
# sequence; (name, Bt, S, H, P, N), Q = 256.
SSD_BWD_FULL = (("mamba2-370m", 8, 2048, 32, 64, 128),
                ("zamba2-7b", 1, 2048, 112, 64, 64))
# float32: the kernel sums in another order than ssd_scan_bwd_ref's
# einsums; each gradient within 1e-4 of max(1, its largest plain
# magnitude) (the floor of 1 as in _ssd_check: da is exactly 0 at S = 1).
# bfloat16: dx, dB and dC are rounded once to bf16 from float32 sums (one
# rounding step is 2^-8 of the value); held to the kernels' 2e-2 of the
# same scale.
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bfloat16's float32 outputs da and ddt, held tighter: every product the
# kernels feed from float32 values takes them as hi + lo bf16 pairs (about
# 16 bits), so these sums stay near float32's error.  Phase v's readings
# reach 6.06e-5 of the same scale; with the lo halves cut out (plain bf16
# products; scripts/ssd_bwd_lo_cut.py) seven of the twelve bf16 cases
# read 2.3e-4 to 1.85e-3 (NVIDIA H100 80GB HBM3, 700.00 W).
SSD_BWD_HILO_TOL = 2e-4
GRAD_NAMES = ("dx", "dB", "dC", "da", "ddt")
# The earlier design's times at the training shapes (float32 CUDA cores:
# a per-(b, h) state walk, per-(tile, chunk, head) rows with G and dyx
# recomputed on both sides, per-head dB and dC to scratch), eager, from
# PERF.md's kernel table: its run F22c (NVIDIA H100 80GB HBM3, 700.00 W);
# logged beside this run's times.
SSD_BWD_EARLIER_MS = {"mamba2-370m": 14.4352, "zamba2-7b": 5.4847}


def _ssd_bwd_inputs(b, s, h, p, n, gen, dev, dtype):
    """_ssd_inputs' distributions, a = dt * A, and dy normal."""
    x, B, C, dt, A_log = _ssd_inputs(b, s, h, p, n, gen, dev, dtype)
    a = dt * -torch.exp(A_log)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    return x, B, C, a, dt, dy


def _ssd_bwd_flops(b: int, s: int, h: int, p: int, n: int, q: int) -> int:
    """The operations one backward call needs: per chunk of r rows the
    causal half of C B^T, r (r + 1) N, once for all heads, and per head
    the causal halves of dy x^T and of the products for dx, dB and dC, r
    (r + 1) (2 P + 2 N), and five (P, N) products over the rows (the
    states entering and the gradients leaving the chunk, dy^T S, D B and
    x^T D), 10 r P N."""
    shared = per_head = 0
    for c0 in range(0, s, q):
        r = min(q, s - c0)
        shared += r * (r + 1) * n
        per_head += r * (r + 1) * (2 * p + 2 * n) + 10 * r * p * n
    return b * shared + b * h * per_head


def _ssd_bwd_bound(b: int, s: int, h: int, p: int, n: int, q: int,
                   elt: int):
    """(bound ms, what bounds it) of one backward call.  Operations
    (``_ssd_bwd_flops``), at the tensor-core peak for the inputs' type (as
    ``_ssd_bound``).  Bytes, at 3.35 TB/s: x, dy, B, C read and dx, dB, dC
    written once in the input dtype, a and dt read and da and ddt written
    once in float32."""
    flops = _ssd_bwd_flops(b, s, h, p, n, q)
    n_bytes = (3 * b * s * h * p + 4 * b * s * n) * elt + 4 * b * s * h * 4
    by_ops = flops / _peak_flops(elt) * 1e3
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def _ssd_bwd_kernels(args, q: int) -> dict:
    """One profiled call of the backward: device ms by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    launcher = importlib.import_module("repro_torch.kernels.ssd_scan"
                                       ".ssd_scan")
    launcher.ssd_scan_chunked_bwd(*args, q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        launcher.ssd_scan_chunked_bwd(*args, q)
        torch.cuda.synchronize()
    return {name: ms for name, (_, ms) in _port_kernel_ms(
        _device_kernels(prof), PORT_KERNELS["ssd_scan_bwd"]).items()}


def _ssd_bwd_check(name: str, got, want, dtype, worst: dict) -> None:
    msgs = []
    for what, g, w in zip(GRAD_NAMES, got, want):
        tol = (SSD_BWD_HILO_TOL if dtype == torch.bfloat16
               and what in ("da", "ddt") else SSD_BWD_TOL[dtype])
        scale = max(float(w.abs().max()), 1.0)
        diff = float((g.float() - w).abs().max())
        worst[g.dtype] = max(worst[g.dtype], diff)
        if not diff <= tol * scale:
            raise AssertionError(f"ssd_bwd {name}: {what} max abs error "
                                 f"{diff} is {diff / scale:.3g} of max(1, "
                                 f"largest plain value) {scale:.3g}, above "
                                 f"{tol:.3g}")
        msgs.append(f"{what} {diff / scale:.2e}")
    log(f"[ssd_bwd] {name}: " + ", ".join(msgs) + f" of max(1, max "
        f"|plain|) (tolerance {SSD_BWD_TOL[dtype]:.3g}"
        + (f", da and ddt {SSD_BWD_HILO_TOL:.3g})" if dtype == torch.bfloat16
           else ")"))


def ssd_bwd_vs_plain(dev) -> dict:
    """Phase v: the backward kernel against ``ssd_scan_bwd_ref``, twice
    bit-equal; times at the training shapes."""
    from repro_torch.kernels.ssd_scan.ref import (ssd_scan_bwd_ref,
                                                  ssd_three_pass)
    launcher = importlib.import_module("repro_torch.kernels.ssd_scan"
                                       ".ssd_scan")

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    h0, p0, n0 = SSD_FULL[0][1:]
    cases = ([(f"test case {c}", *c) for c in SSD_TEST_CASES]
             + [(f"mamba2-370m shape, ragged S={s}", 1, s, h0, p0, n0,
                 SSD_CHUNK) for s in SSD_RAGGED_S]
             + [(f"{name} B={b} S={s}", b, s, h, p, n, SSD_CHUNK)
                for name, b, s, h, p, n in SSD_BWD_FULL])

    def case(label, args, q):
        got = launcher.ssd_scan_chunked_bwd(*args, q)
        again = launcher.ssd_scan_chunked_bwd(*args, q)
        torch.cuda.synchronize()
        for what, g1, g2 in zip(GRAD_NAMES, got, again):
            if not torch.equal(g1, g2):
                raise AssertionError(f"ssd_bwd {label}: {what} differs "
                                     f"between two calls")
        dtype = args[0].dtype
        _ssd_bwd_check(f"{label} {str(dtype)[6:]}", got,
                       ssd_scan_bwd_ref(*args, q), dtype, worst)

    for label, b, s, h, p, n, q in cases:
        for dtype in (torch.float32, torch.bfloat16):
            case(label, _ssd_bwd_inputs(b, s, h, p, n, gen, dev, dtype), q)
    # As the training path feeds it: x, B and C as views of one xBC
    # tensor, sliced as ssm_apply slices them.
    name, b, s, h, p, n = SSD_BWD_FULL[0]
    for dtype in (torch.float32, torch.bfloat16):
        x, B, C, a, dt, dy = _ssd_bwd_inputs(b, s, h, p, n, gen, dev, dtype)
        xBC = torch.cat([x.reshape(b, s, h * p), B, C], dim=-1)
        del x, B, C
        views = (xBC[..., :h * p].reshape(b, s, h, p),
                 xBC[..., h * p:h * p + n], xBC[..., h * p + n:])
        if any(v.is_contiguous() for v in views):
            raise AssertionError("ssd_bwd: x, B and C are not strided views")
        case(f"{name} B={b} S={s}, x, B, C views of xBC", (*views, a, dt, dy),
             SSD_CHUNK)
        del xBC, views, a, dt, dy
    gc.collect()
    torch.cuda.empty_cache()
    timed = {}
    for name, b, s, h, p, n in SSD_BWD_FULL:
        args = _ssd_bwd_inputs(b, s, h, p, n, gen, dev, torch.bfloat16)
        ms = _event_ms(lambda: launcher.ssd_scan_chunked_bwd(
            *args, SSD_CHUNK), reps=10)
        graph_ms = _median_ms(lambda: launcher.ssd_scan_chunked_bwd(
            *args, SSD_CHUNK), reps=5, inner=20)
        ref_ms = _event_ms(lambda: ssd_scan_bwd_ref(*args, SSD_CHUNK),
                           reps=3)
        # The plain version: autograd through ssd_three_pass, the backward
        # alone (the graph is kept between calls).
        x, B, C, a, dt, dy = (t.detach().clone().requires_grad_(
            t.is_floating_point()) for t in args)
        A_log = torch.log(1 + 7 * torch.rand((h,), generator=gen,
                                             device=dev)).requires_grad_()
        y, _ = ssd_three_pass(x, B, C, dt, A_log, SSD_CHUNK)
        ins = (x, B, C, dt, A_log)
        plain_ms = _event_ms(lambda: torch.autograd.grad(
            y, ins, dy.float(), retain_graph=True), reps=3)
        del y, ins, x, B, C, a, dt, dy
        bound_ms, bound_by = _ssd_bwd_bound(b, s, h, p, n, SSD_CHUNK, 2)
        timed[name] = (ms, plain_ms, bound_ms, bound_by)
        log(f"[ssd_bwd] {name} B={b} H={h} P={p} N={n} S={s} Q={SSD_CHUNK}"
            f" bf16: kernel {ms:.4f} ms eager (graph replay "
            f"{graph_ms:.4f} ms; the earlier design "
            f"{SSD_BWD_EARLIER_MS[name]:.4f} ms eager in run F22c), plain "
            f"(autograd through ssd_three_pass, backward alone) "
            f"{plain_ms:.4f} ms, ssd_scan_bwd_ref {ref_ms:.4f} ms, library: "
            f"none; bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.4f}"
            f" of it")
        parts = _ssd_bwd_kernels(args, SSD_CHUNK)
        rate = _ssd_bwd_flops(b, s, h, p, n, SSD_CHUNK) / (ms * 1e-3) / 1e12
        log(f"[ssd_bwd] {name} profiled call: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
            + f"; eager, the call does the bound's operations at {rate:.1f}"
            f" TFLOP/s, {rate * 1e12 / BF16_FLOPS:.4f} of the dense bf16 "
            f"peak")
        del args
        gc.collect()
        torch.cuda.empty_cache()
    ms, plain_ms, bound_ms, bound_by = timed[SSD_BWD_FULL[0][0]]
    return dict(name="ssd_scan_bwd", route="cuda",
                source="src/repro_torch/kernels/ssd_scan/csrc/"
                       "ssd_scan_bwd.cu",
                replaces="src/repro/kernels/ssd_scan/ssd_scan.py:26",
                launches=0, max_abs_err=max(worst.values()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# ---------------------------------------------------------------------------
# phases h and i: the serving slice at stablelm-3b's full width
# ---------------------------------------------------------------------------

ARCH = "stablelm-3b"
# launch/serve.py's default shape (2 replicas x 8 slots) at full width; the
# cache holds the longest prompt plus its longest declared generation.
SERVE = dict(n_replicas=2, slots=8, max_seq=2560)
SERVE_REQUESTS, SERVE_STEPS = 32, 200
SERVE_PROMPT, SERVE_TRUE = (512, 2049), (16, 65)   # half-open ranges
# Per-replica KV budget.  The workload's declared footprints (prompt +
# max_tokens) average 1,433 tokens, so about 6 fit against 8 slots: the
# budget, not the slots, holds requests back.  Prompts dominate the
# footprints, so usage stays close to the declared size and flex has
# little room to overcommit: replaying this engine on the CPU over budgets
# from 3,000 to 9,000 tokens in steps of 50, flex evicted once at 5 of the
# 121 budgets and never more.  This is the shortest of them (132 flex
# steps, 138 reserve).
SERVE_BUDGET = 8500
# The step time the engine sees from each decode (the EMA's initial
# value): both replicas decode the same (slots, max_seq) batch on one
# card, so their wall times differ only by host jitter, and a constant
# keeps straggler inflation off and the decisions replayable on the CPU.
SERVE_STEP_TIME = 1.0
# The prompt of phase i's prefill-against-decode check, cut from 512 to
# 128 tokens when phases x and y came (a decode step at 1 slot is ~66 ms).
PREFILL_DECODE_S = 128
# bf16 keeps 8 significant bits: a logit of order 4 carries an ulp of 1/32,
# and prefill and decode round at different places in each of 32 layers.
PREFILL_DECODE_TOL = 0.25
SMOKE_TOL = 1e-4


def _full_config():
    from repro_torch.configs import get_config
    return get_config(ARCH)


def _serve(policy: str, dev, decode, on_admit, on_evict, *,
           replicas: int = SERVE["n_replicas"],
           requests: int = SERVE_REQUESTS, engine_kw=None) -> dict:
    """Run ``requests`` requests of the phase-h workload through a
    ServeEngine of ``replicas`` replicas on ``dev`` (``engine_kw``: more
    EngineConfig fields, as faults, migration and guard); returns the
    engine and its decisions step by step.  ``decode(replica, reqs)``
    runs the replica's decode; the engine sees SERVE_STEP_TIME."""
    from repro_torch.api import admission
    from repro_torch.launch.serve import make_workload
    from repro_torch.serving import EngineConfig, ServeEngine

    def decode_fn(replica, reqs):
        decode(replica, reqs)
        return SERVE_STEP_TIME

    eng = ServeEngine(EngineConfig(
        n_replicas=replicas, kv_budget_tokens=SERVE_BUDGET,
        policy=policy, max_active_per_replica=SERVE["slots"],
        **(engine_kw or {})), decode_fn=decode_fn, device=dev)
    out = dict(eng=eng, requests=requests, placed=[], evicted=[],
               admitted=[], resident=[], moved=[], counters=[], held_back=0,
               migration_sweeps=0)

    def admit(req):
        out["placed"].append((eng.stats.steps, req.rid, req.replica))
        on_admit(req)

    def evict(req):
        # the counters tell an overflow eviction from a crash's
        out["evicted"].append((eng.stats.steps, req.rid,
                               eng.stats.evicted_events,
                               eng.stats.fault_evictions))
        on_evict(req)

    eng.on_admit, eng.on_evict = admit, evict
    admit_pending = eng.admit_pending

    def admit_and_look():
        n = admit_pending()
        # the budget held a request back while a replica had a free slot
        if eng.queue and min(map(len, eng.active.values())) < SERVE["slots"]:
            out["held_back"] += 1
        return n

    eng.admit_pending = admit_and_look
    if eng.cfg.migration is not None:
        try_migrate = eng._try_migrate

        def migrate(cands, extra_off=None):
            sweeps = admission.SWEEPS
            moved = try_migrate(cands, extra_off)
            out["migration_sweeps"] += admission.SWEEPS - sweeps
            out["moved"] += [(eng.stats.steps, r.rid, r.replica)
                             for r in moved]
            return moved

        eng._try_migrate = migrate
    for req in make_workload(requests, prompt=SERVE_PROMPT,
                             true=SERVE_TRUE):
        eng.submit(req)
    return out


def _serve_steps(run: dict, steps: int = SERVE_STEPS) -> None:
    """Step the engine until every request finished, at most ``steps``
    times; records each step's counters and breaker state."""
    import dataclasses

    eng = run["eng"]
    for _ in range(steps):
        eng.step()
        run["admitted"].append(eng.stats.admitted)
        run["resident"].append(sum(len(a) for a in eng.active.values()))
        counters = dataclasses.asdict(eng.stats)
        del counters["admit_latency_s"]            # wall clock
        guard = ((eng._g_state, eng._g_timer, eng._g_err_q)
                 if eng.cfg.guard is not None else None)
        run["counters"].append((counters, guard))
        if eng.stats.finished == run["requests"]:
            break


def _kernel_launches() -> dict:
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    return {"flash_attention": fa.LAUNCHES, "ssd_scan": ss.LAUNCHES}


def _reset_kernel_launches() -> None:
    _reset_counts()
    for name in ("flash_attention.flash_attention", "ssd_scan.ssd_scan"):
        importlib.import_module(f"repro_torch.kernels.{name}"
                                ).reset_launches()


def _per_prefill(cfg) -> dict:
    """The model kernels' launches in one prefill of ``cfg``."""
    from repro_torch.models.model import n_shared_invocations
    if cfg.family in ("dense", "moe", "vlm"):
        return {"flash_attention": cfg.n_layers, "ssd_scan": 0}
    if cfg.family == "encdec":   # encoder self, decoder self and cross
        return {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers,
                "ssd_scan": 0}
    return {"flash_attention": n_shared_invocations(cfg),
            "ssd_scan": cfg.n_layers}


def _serve_model(dev, cfg, policies, *, replicas=SERVE["n_replicas"],
                 requests=SERVE_REQUESTS, steps=SERVE_STEPS, engine_kw=None,
                 tag=None, probe=None) -> dict:
    """``RealModelBackend`` with ``cfg`` (random weights, seed 0) behind the
    engine, over the phase-h workload (or ``requests`` of it on
    ``replicas`` replicas for at most ``steps`` steps, with more
    EngineConfig fields in ``engine_kw``), once per policy.  Checks each
    run against the same engine on the CPU, calls ``probe(backend, run)``
    after each, and returns policy -> its decisions, counters and kernel
    launches."""
    from repro_torch.launch.serve import RealModelBackend

    tag = tag or f"[serve {cfg.name}]"
    serve_kw = dict(replicas=replicas, requests=requests,
                    engine_kw=engine_kw)
    log(f"{tag} full width: {cfg.n_layers} layers ({cfg.family}), d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_padded}, {cfg.dtype}; random "
        f"weights (seed 0); {replicas} replicas x {SERVE['slots']} slots, "
        f"max_seq {SERVE['max_seq']}, kv budget {SERVE_BUDGET} tokens per "
        f"replica, step time seen by the engine {SERVE_STEP_TIME}; "
        f"{requests} requests, at most {steps} steps"
        + (f"; {engine_kw}" if engine_kw else ""))
    per_prefill = _per_prefill(cfg)
    runs = {}
    for policy in policies:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        backend = RealModelBackend(cfg.name, replicas, SERVE["slots"],
                                   SERVE["max_seq"], seed=0, cfg=cfg,
                                   device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in backend.params.parameters())
        setup = time.perf_counter() - t0
        times = {"prefill": 0.0, "decode": 0.0}
        calls = {"prefill": 0, "decode": 0}

        def timed_hook(fn, name):
            def hook(*args):
                t = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                times[name] += time.perf_counter() - t
                calls[name] += 1
            return hook

        run = _serve(policy, dev, timed_hook(backend.decode_fn, "decode"),
                     timed_hook(backend.on_admit, "prefill"),
                     backend.on_evict, **serve_kw)
        _reset_kernel_launches()
        t0 = time.perf_counter()
        _serve_steps(run, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c, launches = _counts(), _kernel_launches()
        eng = run["eng"]
        st = eng.stats
        peak = torch.cuda.max_memory_allocated()
        log(f"{tag} {policy} ({eng.policy.name}, wavefront): "
            f"{st.steps} steps in {wall:.2f} s; finished {st.finished}/"
            f"{requests}, admitted {st.admitted}, evictions "
            f"{st.evicted_events} {run['evicted']} (step, rid, overflow "
            f"and crash evictions so far); budget held a request back "
            f"beside a free slot in {run['held_back']} steps; resident per "
            f"step mean {statistics.fmean(run['resident']):.2f}, peak "
            f"{max(run['resident'])}; mean util "
            f"{statistics.fmean(st.util_series):.4f}, final QoS "
            f"{st.qos_series[-1]:.4f}, final P {st.penalty_series[-1]:.4f}")
        log(f"{tag} {policy}: {st.tokens_generated} tokens in "
            f"{times['decode']:.3f} s of decode ({calls['decode']} replica "
            f"steps, {times['decode'] * 1e3 / max(calls['decode'], 1):.2f} "
            f"ms each) = {st.tokens_generated / times['decode']:.1f} decode "
            f"tokens/s; {backend.prefills} prefills for {st.admitted} "
            f"admissions of {requests} requests in {times['prefill']:.3f} s"
            f" = {backend.prefills / max(times['prefill'], 1e-9):.2f} "
            f"prefills/s; set-up {setup:.2f} s ({n_params / 1e9:.3f} B "
            f"parameters); peak memory {peak / 2**30:.2f} GiB")
        log(f"{tag} {policy}: launches " + ", ".join(
            f"{k} {v} (= {per_prefill[k]} x {backend.prefills} prefills)"
            for k, v in launches.items())
            + f", flex_score_batch_topk {c['topk']}; admission decisions "
            f"{c['decisions']}, rounds {c['rounds']}, sweeps {c['sweeps']} "
            f"({run['migration_sweeps']} of them migration sweeps)")
        if backend.prefills == 0 or any(
                launches[k] != per_prefill[k] * backend.prefills
                for k in launches):
            raise AssertionError(f"{policy}: launches {launches} for "
                                 f"{backend.prefills} prefills, expected "
                                 f"{per_prefill} per prefill")
        if c["pick"] or c["batch"]:
            raise AssertionError(f"{policy}: the serving run launched a "
                                 f"flex_score kernel outside its path")
        if policy == "flex" and (c["topk"] == 0 or c["topk"] != c["sweeps"]):
            raise AssertionError(f"flex: {c['topk']} top-K launches for "
                                 f"{c['sweeps']} sweeps")
        for r in range(replicas):
            toks = backend.tokens[r]
            if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
                raise AssertionError(f"{policy}: replica {r} decoded a "
                                     f"token outside the vocabulary")
        if not all(math.isfinite(x) for x in st.penalty_series):
            raise AssertionError(f"{policy}: non-finite penalty")
        if run["held_back"] == 0:
            raise AssertionError(f"{policy}: the KV budget never bound")
        # The same engine on the CPU, with no model behind it: decisions
        # do not depend on what the model computes.
        cpu = _serve(policy, torch.device("cpu"), lambda *a: None,
                     lambda req: None, lambda req: None, **serve_kw)
        _serve_steps(cpu, steps)
        for key in ("placed", "evicted", "admitted", "moved", "counters"):
            if cpu[key] != run[key]:
                raise AssertionError(f"{policy}: {key} on the card differ "
                                     f"from the CPU engine's")
        log(f"{tag} {policy}: placements, evictions, migrations, "
            f"admissions, every EngineStats counter and the breaker's "
            f"states equal the CPU engine's, step by step "
            f"({len(run['placed'])} placements, {len(run['moved'])} "
            f"migrations)")
        if probe is not None:
            probe(backend, run)
        runs[policy] = dict(placed=run["placed"], evicted=run["evicted"],
                            admitted=run["admitted"], moved=run["moved"],
                            counters=run["counters"],
                            evicted_events=st.evicted_events,
                            launches=dict(launches, topk=c["topk"]))
        del backend, eng, run
        gc.collect()   # the engine's wrapped hooks form reference cycles
    return runs


def _same_serving_decisions(what: str, runs: dict, ref: dict) -> None:
    for policy, run in runs.items():
        for key in ("placed", "evicted", "admitted"):
            if run[key] != ref[policy][key]:
                raise AssertionError(f"{what} {policy}: {key} differ from "
                                     f"phase h's")
        log(f"[serve] {what} {policy}: placements, evictions and admissions "
            f"equal phase h's (stablelm-3b): the engine does not see the "
            f"model")


def serve_end_to_end(dev):
    """Phase h; returns (the flash kernel's launches in the flex run, the
    runs' decisions)."""
    runs = _serve_model(dev, _full_config(), ("flex", "reserve"))
    k = min(len(runs["flex"]["admitted"]), len(runs["reserve"]["admitted"]))
    flex, reserve = (runs[p]["admitted"][k - 1] for p in ("flex", "reserve"))
    log(f"[serve] admitted after {k} steps: flex {flex}, reserve {reserve}")
    if runs["flex"]["evicted_events"] == 0:
        raise AssertionError("flex never evicted: the budget does not bind")
    if flex < reserve:
        raise AssertionError(f"flex admitted {flex} requests in {k} steps, "
                             f"fewer than reserve's {reserve}")
    return runs["flex"]["launches"]["flash_attention"], runs


def serve_mamba2(dev, ref_runs) -> int:
    """Phase l: mamba2-370m at full width, flex then reserve; returns the
    SSD kernel's launches in the flex run."""
    from repro_torch.configs import get_config

    runs = _serve_model(dev, get_config("mamba2-370m"), ("flex", "reserve"))
    _same_serving_decisions("mamba2-370m", runs, ref_runs)
    return runs["flex"]["launches"]["ssd_scan"]


def prefill_vs_decode(dev) -> None:
    """Phase i: full width in bf16, then the smoke config in f32 against
    the CPU port."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model, init_cache

    cfg = _full_config()
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_DECODE_S),
                         generator=gen, device=dev)
    t0 = time.perf_counter()
    logits_p, _ = model.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    cache = init_cache(cfg, 1, PREFILL_DECODE_S, device=dev)
    t0 = time.perf_counter()
    for t in range(PREFILL_DECODE_S):
        logits_d, cache = model.decode(params, cache, toks[:, t:t + 1])
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    real = slice(0, cfg.vocab_size)
    lp, ld = logits_p[:, real].float(), logits_d[:, real].float()
    err = float((lp - ld).abs().max())
    log(f"[pvd] {cfg.name} bf16, {PREFILL_DECODE_S}-token prompt: prefill "
        f"{t_prefill * 1e3:.1f} ms, {PREFILL_DECODE_S} decode steps "
        f"{t_decode:.2f} s; last logits max abs difference {err:.4f} "
        f"(tolerance {PREFILL_DECODE_TOL}; max |logit| "
        f"{float(lp.abs().max()):.3f}); argmax equal: "
        f"{bool(lp.argmax() == ld.argmax())}")
    if not (torch.isfinite(lp).all() and err <= PREFILL_DECODE_TOL):
        raise AssertionError(f"prefill and decode disagree by {err}")
    del params, cache
    _smoke_against_cpu(dev, ARCH)


def _decode_cache(cfg, prefill_cache, batch: int, max_seq: int, dev):
    """A decode cache of ``max_seq`` positions holding a prefill's cache
    (the serving path's KV surgery), ``len`` the prompt length."""
    from repro_torch.launch.serve import write_prefill
    from repro_torch.models import init_cache

    cache = init_cache(cfg, batch, max_seq, device=dev)
    write_prefill(cache, prefill_cache, 0)
    cache["len"] = prefill_cache["len"].clone()
    return cache


def _smoke_against_cpu(dev, arch: str) -> None:
    """The smoke config in f32: a 45-token prefill (with the encdec's
    frames or the vlm's patches from ``synthetic_batch``) and 6 decode
    steps from its cache, on the card against the CPU port."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import synthetic_batch

    small = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(small)
    params = model.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, small.vocab_size, (2, 51),
                         generator=torch.Generator().manual_seed(3))
    extra = {k: v for k, v in synthetic_batch(small, 2, 45, 3, 0,
                                              device="cpu").items()
             if k in ("frames", "patches")}
    logits = []
    for device in (dev, torch.device("cpu")):
        p = params.to(device)
        batch = {k: v.to(device) for k, v in extra.items()}
        lp, c = model.prefill(p, dict(batch, tokens=toks[:, :45].to(device)))
        cache = _decode_cache(small, c, 2, int(c["len"]) + 11, device)
        steps = [lp]
        for t in range(45, 51):
            ld, cache = model.decode(p, cache, toks[:, t:t + 1].to(device))
            steps.append(ld)
        logits.append(torch.stack(steps).cpu())
    err = float((logits[0] - logits[1]).abs().max())
    log(f"[pvd] {small.name} f32 prefill (45 tokens) and 6 decode steps "
        f"from its cache: card against the CPU port, max abs difference "
        f"{err:.3g} (tolerance {SMOKE_TOL})")
    if not err <= SMOKE_TOL:
        raise AssertionError(f"{small.name}: card and CPU differ by {err}")


# Kernel names of the port's prefill kernels, and of the bf16 SSD and
# flash-attention backwards', in a profiler trace.
PORT_KERNELS = {"flash_attention": ("flash_fwd_",),
                "flash_attention_bwd": ("bwd_delta", "dkv_wgmma", "dq_wgmma"),
                "ssd_scan": ("chunk_state", "state_pass", "chunk_scan",
                             "ssd_fwd"),
                "ssd_scan_bwd": ("ssd_bwd_states", "ssd_bwd_pass",
                                 "ssd_bwd_chunk", "ssd_bwd_finish")}


def profile_serving(dev, cfg=None) -> None:
    """Phase j (and m): where one full-width prefill of 2048 tokens and one
    decode step of a full replica (8 slots, max_seq 2560) spend their time:
    the host clock untraced, then the device's kernel time under
    torch.profiler."""
    from repro_torch.models import build_model, init_cache

    cfg = cfg or _full_config()
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    params = model.init(gen)
    s = FLASH_TIMED_S[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                           device=dev)
    cache = init_cache(cfg, SERVE["slots"], SERVE["max_seq"], filled=s - 1,
                       device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE["slots"], 1),
                           generator=gen, device=dev)
    _profile(cfg, f"prefill of {s} tokens",
             lambda: model.prefill(params, {"tokens": prompt}))
    _profile(cfg, f"decode step of {SERVE['slots']} slots at position "
                  f"{s - 1}", lambda: model.decode(params, cache, tokens))


def _profile(cfg, name: str, fn) -> None:
    """One call of ``fn`` after a warm-up: the host clock untraced, then
    the device's kernel time under torch.profiler, its idle share, the
    top kernels and the port kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        log(f"[sprofile] {name}: {wall_ms:.2f} ms untraced; device time "
            f"not visible to the profiler")
        return
    log(f"[sprofile] {cfg.name} {name}: {wall_ms:.2f} ms untraced; "
        f"device busy {busy_ms:.2f} ms in "
        f"{sum(e.count for e in kernels)} kernels, idle share "
        f"{1 - busy_ms / wall_ms:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"[sprofile]   {e.key[:60]}: {e.count} calls, "
            f"{e.self_device_time_total / 1e3:.3f} ms")
    # The port's own kernels: flash attention, the SSD scan's passes and
    # its backward's, each group together and each kernel.
    for port, names in PORT_KERNELS.items():
        mine = [e for e in kernels if any(n in e.key for n in names)]
        if mine:
            ms = sum(e.self_device_time_total for e in mine) / 1e3
            log(f"[sprofile]   {port} (port): {sum(e.count for e in mine)}"
                f" kernels, {ms:.3f} ms, {ms / busy_ms:.4f} of the "
                f"device time")
        if len(names) > 1:
            for name, (count, ms) in _port_kernel_ms(mine, names).items():
                log(f"[sprofile]     {name}: {count} kernels, {ms:.3f} ms, "
                    f"{ms / busy_ms:.4f} of the device time")


def _port_kernel_ms(events, names) -> dict:
    """name -> (launches, device ms) of the profiled CUDA ``events`` whose
    kernel name holds it, for each of ``names`` that ran."""
    out = {}
    for name in names:
        each = [e for e in events if name in e.key]
        if each:
            out[name] = (sum(e.count for e in each),
                         sum(e.self_device_time_total for e in each) / 1e3)
    return out


# ---------------------------------------------------------------------------
# phase m: zamba2-7b, and the final state
# ---------------------------------------------------------------------------

STATE_CHECK_S = 512
# bf16: prefill (the SSD kernel's chunked form, rounded to bf16 once per
# layer output) and decode (the recurrence from the kernel's final state
# and the conv tail) round at different places in each of 48 or 81 layers;
# the same bound as phase i's prefill-against-decode check.
STATE_CHECK_TOL = PREFILL_DECODE_TOL


def serve_zamba2(dev, ref_runs) -> dict:
    """Phase m's serving run: zamba2-7b at full width under flex; returns
    its kernel launches."""
    from repro_torch.configs import get_config

    runs = _serve_model(dev, get_config("zamba2-7b"), ("flex",))
    _same_serving_decisions("zamba2-7b", runs, ref_runs)
    return runs["flex"]["launches"]


def final_state_check(dev) -> None:
    """prefill(tokens[:S]) then decode(tokens[S]) against the last logits
    of prefill(tokens[:S + 1]), for both full configs in bf16: reads the
    SSD kernel's final state, the conv tail and the shared K/V."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    s = STATE_CHECK_S
    for name in ("mamba2-370m", "zamba2-7b"):
        cfg = get_config(name)
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        params = model.init(gen)
        toks = torch.randint(0, cfg.vocab_size, (1, s + 1), generator=gen,
                             device=dev)
        _, c = model.prefill(params, {"tokens": toks[:, :s]})
        cache = _decode_cache(cfg, c, 1, s + 1, dev)
        del c
        got, _ = model.decode(params, cache, toks[:, s:s + 1])
        want, _ = model.prefill(params, {"tokens": toks})
        real = slice(0, cfg.vocab_size)
        got, want = got[:, real].float(), want[:, real].float()
        err = float((got - want).abs().max())
        top2 = torch.topk(want[0], 2).values
        same = bool(got.argmax() == want.argmax())
        log(f"[state] {name} bf16: prefill({s}) + decode against "
            f"prefill({s + 1}): last logits max abs difference {err:.4f} "
            f"(tolerance {STATE_CHECK_TOL}; max |logit| "
            f"{float(want.abs().max()):.3f}, top-2 gap "
            f"{float(top2[0] - top2[1]):.4f}); argmax equal: {same}")
        if not (torch.isfinite(got).all() and err <= STATE_CHECK_TOL
                and same):
            raise AssertionError(f"{name}: prefill + decode and the longer "
                                 f"prefill disagree (max {err}, argmax "
                                 f"equal {same})")
        del params, cache, model
        gc.collect()
        torch.cuda.empty_cache()
    for arch in ("mamba2-370m", "zamba2-7b"):
        _smoke_against_cpu(dev, arch)


# ---------------------------------------------------------------------------
# phase r: the serving engine under faults, migration and the guard
# ---------------------------------------------------------------------------

# Phase h's model and settings on 4 replicas x 8 slots (about 6.7 GB of
# cache a replica), 64 requests of its workload, at most 80 steps (cut
# from 120 when phases x and y came: the burst, the migrations and the
# breaker's trip, probe and close all fall before step 45).
FAULT_SERVE = dict(replicas=4, requests=64, steps=80)
# A burst crashes a quarter of the replicas (replica 0) for 24 steps, with
# straggler storms and the brownout.  The burst lands at step 20, not 12:
# the workload's requests generate 16 tokens or more, so none finishes
# before step 16, and until one does no replica has room to take a moved
# request; replaying this engine on the CPU, a burst at step 12 with 4
# steps of warning moved none, at step 20 it moves 2.
FAULT_BURST = dict(burst_slot=20, burst_frac=0.25, crash_duration=24,
                   storm_rate=0.02, degrade=True)
FAULT_WARN = 4
FAULT_MIGRATION = dict(bandwidth=8, pool_size=16, migrate_cost=2)
# Run (iii)'s guard, chosen on the CPU replay: the drift statistic stays
# near 0.001 until the first requests finish (step 16), reaches 0.067 over
# the warning steps and 0.105 once the crash lands; a threshold of 0.07
# trips there (step 24), after the drain pass has had its chance, and a
# cooldown of 12 steps leaves the half-open probe (steps 36-43) and the
# close inside the run.  The defaults (0.15, 24) never trip here.
FAULT_GUARD = dict(trip_threshold=0.07, cooldown=12)


def _fault_engine_runs():
    from repro_torch.faults import FaultConfig
    from repro_torch.guard import GuardConfig
    from repro_torch.migration import MigrationConfig

    faults = FaultConfig(**FAULT_BURST)
    warned = faults._replace(warn_slots=FAULT_WARN)
    mig = MigrationConfig(**FAULT_MIGRATION)
    return (("(i)", dict(faults=faults)),
            ("(ii)", dict(faults=warned, migration=mig)),
            ("(iii)", dict(faults=warned, migration=mig,
                           guard=GuardConfig(**FAULT_GUARD))))


def _slot_bookkeeping(tag: str):
    """A probe that logs the backend's slots after a run: a migration
    tells the backend nothing, so a moved request keeps its old slot
    number on its new replica, where a request placed there may hold the
    same number."""
    def probe(backend, run):
        placed = {rid: rep for _, rid, rep in run["placed"]}
        moves = []
        for step, rid, to in run["moved"]:
            slot = backend.slot_of.get(rid)
            also = [r for r, rep in placed.items() if rep == to
                    and r != rid and backend.slot_of.get(r) == slot]
            moves.append((step, rid, to, slot, also))
        log(f"{tag} backend slots after the run: free lists "
            f"{backend.free}; {len(backend.slot_of)} requests hold a slot; "
            f"moves (step, rid, to replica, the slot it keeps, requests "
            f"placed on that replica with the same slot): {moves}")
    return probe


def serve_faults(dev) -> dict:
    """Phase r: stablelm-3b at full width behind an engine with a crash
    burst, storms and the brownout, then with migration, then with the
    guard too; returns the flash and top-K kernels' launches."""
    cfg = _full_config()
    total = {"flash_attention": 0, "flex_score_batch_topk": 0}
    for name, kw in _fault_engine_runs():
        tag = f"[serve faults {name}]"
        runs = _serve_model(dev, cfg, ("flex",), tag=tag, engine_kw=kw,
                            probe=_slot_bookkeeping(tag), **FAULT_SERVE)
        run = runs["flex"]
        last = run["counters"][-1][0]
        states = "".join(str(g[0]) for _, g in run["counters"]
                         if g is not None)
        log(f"{tag} " + ", ".join(
            f"{k} {last[k]}" for k in (
                "evicted_events", "fault_evictions", "brownout_steps",
                "brownout_deferred", "migrations", "migration_failed",
                "guard_trips", "guard_open_steps", "guard_deferred"))
            + f"; migrations {run['moved']} (step, rid, to)"
            + (f"; breaker per step {states}" if states else ""))
        if name == "(i)" and not (last["fault_evictions"] > 0
                                  and last["brownout_steps"] > 0):
            raise AssertionError(f"phase r {name}: no crash eviction or no "
                                 f"brownout")
        if name == "(ii)" and last["migrations"] == 0:
            raise AssertionError(f"phase r {name}: nothing migrated")
        if name == "(iii)" and not (last["guard_trips"] >= 1
                                    and "2" in states):
            raise AssertionError(f"phase r {name}: the breaker did not trip "
                                 f"and reach HALF_OPEN ({states})")
        total["flash_attention"] += run["launches"]["flash_attention"]
        total["flex_score_batch_topk"] += run["launches"]["topk"]
    return total


# ---------------------------------------------------------------------------
# phase s: mixtral-8x7b at full width, 16 of its 32 layers
# ---------------------------------------------------------------------------

MOE_ARCH = "mixtral-8x7b"
# 32 layers at full width are 46.7 B parameters, 93 GB in bf16, more than
# one 80 GB card: the phase keeps 16 (23.5 B parameters, 46.9 GB).
MOE_LAYERS = 16
MOE_SPLIT_S = 2048              # a power of two: groups of 2048, cap 640
MOE_ODD_S = 2047                # odd: one-token groups, cap 2
MOE_CHECK_LAYERS = 2
MOE_CHECK_S = 2048


def _moe_config(n_layers: int = MOE_LAYERS):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=n_layers)


def _decode_bound_ms(params, slots: int) -> float:
    """Bytes one decode step of a replica must read, weights only: every
    parameter but the embedding table, of which ``slots`` rows, over
    3.35 TB/s."""
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    emb = params.tok_emb
    n_bytes -= (emb.shape[0] - slots) * emb.shape[1] * emb.element_size()
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _moe_prefill_split(model, params, s: int, dev) -> dict:
    """One prefill of ``s`` tokens with CUDA events around attention, the
    routing, the experts and each MoE block: ms of each on the device's
    timeline; the dispatch einsums are the MoE blocks less the routing and
    the experts."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    spans = []
    originals = {(L, "chunked_attention"): "attention",
                 (MOE, "_route"): "routing", (MOE, "_experts"): "experts",
                 (MOE, "moe_apply_einsum"): "moe"}

    def spanned(fn, name):
        def wrapper(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.append((name, start, end))
            return out
        return wrapper

    saved = {key: getattr(*key) for key in originals}
    toks = torch.randint(0, model.cfg.vocab_size, (1, s), device=dev)
    model.prefill(params, {"tokens": toks})               # warm-up
    try:
        for (mod, attr), name in originals.items():
            setattr(mod, attr, spanned(saved[(mod, attr)], name))
        total = spanned(lambda: model.prefill(params, {"tokens": toks}),
                        "prefill")
        total()
        torch.cuda.synchronize()
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    ms = {}
    for name, start, end in spans:
        ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
    ms["dispatch"] = ms["moe"] - ms["routing"] - ms["experts"]
    return ms


def _moe_probe(dev):
    def probe(backend, run):
        if run["eng"].cfg.policy != "flex":
            return
        model, params = backend.model, backend.params
        bound = _decode_bound_ms(params, SERVE["slots"])
        log(f"[serve moe] decode bound: {bound:.2f} ms a replica step (the "
            f"weights one step reads at 3.35 TB/s; the KV cache not "
            f"counted)")
        ms = _moe_prefill_split(model, params, MOE_SPLIT_S, dev)
        log(f"[serve moe] prefill of {MOE_SPLIT_S} tokens, CUDA-event "
            f"spans: {ms['prefill']:.2f} ms in all; experts "
            f"{ms['experts']:.2f}, dispatch einsums {ms['dispatch']:.2f}, "
            f"routing {ms['routing']:.2f}, attention (flash) "
            f"{ms['attention']:.2f}, the rest "
            f"{ms['prefill'] - ms['moe'] - ms['attention']:.2f} ms")
        for s in (MOE_ODD_S, MOE_SPLIT_S):
            toks = torch.randint(0, model.cfg.vocab_size, (1, s),
                                 device=dev)
            t = _event_ms(lambda: model.prefill(params, {"tokens": toks}),
                          reps=3)
            log(f"[serve moe] prefill of {s} tokens: {t:.2f} ms (median of "
                f"3, CUDA events)")
    return probe


def _against_plain_attention(dev, cfg, make_batch, tag: str,
                             what: str) -> None:
    """A full-width prefill of ``cfg`` (random weights drawn first from a
    generator seeded 4, then ``make_batch(generator)``) through the flash
    kernel, against the same prefill with the plain attention: last
    logits within phase i's bf16 tolerance, and the kernel launched as
    often as ``_per_prefill`` says."""
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    params = model.init(gen)
    batch = make_batch(gen)
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    before = fa.LAUNCHES
    got, _ = model.prefill(params, batch)
    launched = fa.LAUNCHES - before
    chunked = L.chunked_attention
    L.chunked_attention = lambda q, k, v, causal=True, window=0: \
        L.naive_attention(q, k, v, causal=causal, window=window)
    try:
        want, _ = model.prefill(params, batch)
    finally:
        L.chunked_attention = chunked
    real = slice(0, cfg.vocab_size)
    got, want = got[:, real].float(), want[:, real].float()
    err = float((got - want).abs().max())
    expected = _per_prefill(cfg)["flash_attention"]
    log(f"{tag} {what}, flash kernel ({launched} launches) against the "
        f"plain attention: last logits max abs difference {err:.4f} "
        f"(tolerance {PREFILL_DECODE_TOL}; max |logit| "
        f"{float(want.abs().max()):.3f}); argmax equal: "
        f"{bool((got.argmax(-1) == want.argmax(-1)).all())}")
    if not (torch.isfinite(got).all() and err <= PREFILL_DECODE_TOL
            and launched == expected):
        raise AssertionError(f"{cfg.name}: the kernel path ({launched} "
                             f"launches, {expected} expected) and the plain "
                             f"attention disagree by {err}")


def moe_against_plain_attention(dev) -> None:
    """A 2-layer full-width mixtral prefill through the flash kernel,
    against the same prefill with the plain attention."""
    cfg = _moe_config(MOE_CHECK_LAYERS)
    _against_plain_attention(
        dev, cfg, lambda gen: {"tokens": torch.randint(
            0, cfg.vocab_size, (1, MOE_CHECK_S), generator=gen,
            device=dev)},
        "[serve moe]", f"{MOE_CHECK_LAYERS}-layer full-width prefill of "
                       f"{MOE_CHECK_S} tokens")


def serve_mixtral(dev, ref_runs) -> dict:
    """Phase s: mixtral-8x7b at full width (16 of 32 layers) behind the
    engine, flex then reserve; returns the flash kernel's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve moe] {MOE_ARCH}: {MOE_LAYERS} of its 32 layers (depth cut "
        f"to fit one 80 GB card: 46.9 GB of bf16 weights), every width as "
        f"published; allocated before the phase "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    runs = _serve_model(dev, _moe_config(), ("flex", "reserve"),
                        probe=_moe_probe(dev))
    _same_serving_decisions(MOE_ARCH, runs, ref_runs)
    gc.collect()
    torch.cuda.empty_cache()
    moe_against_plain_attention(dev)
    return {"flash_attention": sum(r["launches"]["flash_attention"]
                                   for r in runs.values())}


# ---------------------------------------------------------------------------
# phases t and u: whisper-medium and llava-next-mistral-7b at full width
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-medium"
# whisper's decoder context is 448 tokens: a 447-token prompt and one decode
# step fill it.
ENCDEC_BATCH, ENCDEC_T = 8, (447,)
VLM_ARCH = "llava-next-mistral-7b"
# 576 patches in front: S = 2048, and a ragged batch at S = 1576.
VLM_BATCH, VLM_T = 4, (1472, 1000)
MODEL_DECODE_STEPS = 32
MODEL_CHECK_LAYERS = 2


def _model_inputs(cfg, batch: int, seq: int, index: int, dev) -> dict:
    """``synthetic_batch``'s inputs (seed 0) without the labels."""
    from repro_torch.train import synthetic_batch

    out = synthetic_batch(cfg, batch, seq, 0, index, device=dev)
    del out["labels"]
    return out


def _model_phase(dev, arch: str, batch: int, seqs, tag: str) -> int:
    """``arch`` at its published widths in bf16, random weights drawn on
    the card (seed 0), fed by ``synthetic_batch``: a prefill of each prompt
    length in ``seqs`` (index i for the i-th), the first followed by
    MODEL_DECODE_STEPS greedy decode steps.  Checks the flash launches of
    each prefill against ``_per_prefill``; prefill(T) plus the first decode
    step against prefill(T + 1) (the encdec's cross K/V from the prefill);
    a MODEL_CHECK_LAYERS-layer full-width prefill through the kernel
    against the plain attention; the smoke config in f32 on the card
    against the CPU port.  Logs prefill ms, ms per decode step, decode
    tokens/s and peak memory.  Returns the flash launches of the prefills
    and decode steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"{tag} {cfg.name} ({cfg.family}) at full width: {cfg.n_layers} "
        f"layers" + (f" and {cfg.n_enc_layers} encoder layers over "
                     f"{cfg.enc_seq} frames" if cfg.family == "encdec"
                     else "")
        + (f", {cfg.n_patches} patches" if cfg.family == "vlm" else "")
        + f", d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim_} over {cfg.n_kv_heads} KV heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_padded}; {cfg.dtype}, "
          f"{n_bytes / 1e9:.2f} GB of random weights (seed 0)")
    inputs = [_model_inputs(cfg, batch, s, i, dev)
              for i, s in enumerate(seqs)]
    want = _per_prefill(cfg)["flash_attention"]

    # The main path: counts set to 0 just before, read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_launches()
    per_prefill, prefill_s = [], []
    for i, b in enumerate(inputs):
        before = _kernel_launches()["flash_attention"]
        t0 = time.perf_counter()
        logits, c = model.prefill(params, b)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        per_prefill.append(_kernel_launches()["flash_attention"] - before)
        if not torch.isfinite(logits.float()).all():
            raise AssertionError(f"{cfg.name}: prefill logits not finite")
        if i:
            del c
            continue
        S = int(c["len"])
        cache = _decode_cache(cfg, c, batch, S + MODEL_DECODE_STEPS, dev)
        del c
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        t0 = time.perf_counter()
        for step in range(MODEL_DECODE_STEPS):
            ld, cache = model.decode(params, cache, tok)
            if step == 0:
                first = (tok, ld)
            tok = ld.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if not torch.isfinite(ld.float()).all():
            raise AssertionError(f"{cfg.name}: decode logits not finite")
    launches = _kernel_launches()["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    lens = [b["tokens"].shape[1] for b in inputs]
    if cfg.family == "vlm":
        lens = [n + cfg.n_patches for n in lens]
    log(f"{tag} flash launches per prefill {per_prefill} ({want} expected: "
        + ("encoder self, decoder self and cross attention per layer"
           if cfg.family == "encdec" else "one per layer")
        + f"), {launches} in all")
    if per_prefill != [want] * len(inputs) or launches != want * len(inputs):
        raise AssertionError(f"{cfg.name}: flash launched {per_prefill} "
                             f"times per prefill, {want} expected")
    ev_ms = [_event_ms(lambda b=b: model.prefill(params, b), reps=3)
             for b in inputs]
    for s, wall, ev in zip(lens, prefill_s, ev_ms):
        log(f"{tag} prefill of B={batch} x S={s}: {ev:.2f} ms (CUDA events, "
            f"median of 3 after a warm-up), the first {wall * 1e3:.2f} ms "
            f"(host clock, cold)")
    log(f"{tag} {MODEL_DECODE_STEPS} greedy decode steps of B={batch} from "
        f"S={lens[0]}: {decode_s * 1e3 / MODEL_DECODE_STEPS:.2f} ms a step, "
        f"{batch * MODEL_DECODE_STEPS / decode_s:.1f} decode tokens/s; peak "
        f"memory {peak:.2f} GiB")
    _profile(cfg, f"prefill of B={batch} x S={lens[0]}",
             lambda: model.prefill(params, inputs[0]))
    # decode writes at the cache's last position, clamped, from here on
    _profile(cfg, f"decode step of B={batch} at S="
                  f"{lens[0] + MODEL_DECODE_STEPS}",
             lambda: model.decode(params, cache, tok))
    del cache

    # prefill(T) and one decode step against prefill(T + 1)
    tok, got = first
    longer = dict(inputs[0], tokens=torch.cat([inputs[0]["tokens"], tok], 1))
    want_l, _ = model.prefill(params, longer)
    real = slice(0, cfg.vocab_size)
    got, want_l = got[:, real].float(), want_l[:, real].float()
    err = float((got - want_l).abs().max())
    log(f"{tag} prefill(S={lens[0]}) + one decode step against "
        f"prefill(S={lens[0] + 1}): last logits max abs difference "
        f"{err:.4f} (tolerance {PREFILL_DECODE_TOL}; max |logit| "
        f"{float(want_l.abs().max()):.3f}); argmax equal in "
        f"{int((got.argmax(-1) == want_l.argmax(-1)).sum())} of {batch} rows")
    if not (torch.isfinite(got).all() and err <= PREFILL_DECODE_TOL):
        raise AssertionError(f"{cfg.name}: prefill and decode disagree by "
                             f"{err}")
    del params, inputs, first, got, want_l, longer
    gc.collect()
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, n_layers=MODEL_CHECK_LAYERS,
                                n_enc_layers=min(cfg.n_enc_layers,
                                                 MODEL_CHECK_LAYERS))
    _against_plain_attention(
        dev, small, lambda gen: _model_inputs(small, batch, seqs[0], 0, dev),
        tag, f"{MODEL_CHECK_LAYERS}-layer full-width prefill of B={batch} x "
             f"S={lens[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    _smoke_against_cpu(dev, arch)
    return launches


def encdec_end_to_end(dev) -> int:
    """Phase t: whisper-medium; returns the flash launches."""
    return _model_phase(dev, ENCDEC_ARCH, ENCDEC_BATCH, ENCDEC_T,
                        "[encdec]")


def vlm_end_to_end(dev) -> int:
    """Phase u: llava-next-mistral-7b; returns the flash launches."""
    return _model_phase(dev, VLM_ARCH, VLM_BATCH, VLM_T, "[vlm]")


# ---------------------------------------------------------------------------
# phase w: training mamba2-370m at full width through launch/train.py
# ---------------------------------------------------------------------------

TRAIN_ARCH = "mamba2-370m"
TRAIN = dict(steps=8, batch=8, seq=2048, ckpt_every=4)
TRAIN_RESUME_AT = 4
# The resumed run's losses against the uninterrupted run's: the two start
# from the same checkpoint bits, but the embedding's backward (index_put_
# with accumulate=True) adds a repeated token's rows with float32 atomics
# in a run-dependent order, so a bf16 weight can round the other way; the
# losses are held to a relative 1e-3 and their bit-equality is logged.
TRAIN_RESUME_RTOL = 1e-3
TRAIN_SMOKE = dict(batch=2, seq=64, steps=3)
# The smoke config in float32, card (the SSD kernels, forward and
# backward) against the CPU port (autograd through ssd_chunked), from the
# same weights: sums in other orders, and three AdamW steps on top, whose
# update m / sqrt(v) amplifies a difference in a near-zero gradient.
TRAIN_SMOKE_LOSS_RTOL = 1e-4
TRAIN_SMOKE_GRAD_REL = 1e-3
# The families with attention (dense, encdec, moe, hybrid, vlm), held the
# same way after mamba2-370m.
TRAIN_SMOKE_ATTENTION = ("stablelm-3b", "whisper-medium", "mixtral-8x7b",
                         "zamba2-7b", "llava-next-mistral-7b")


def _train_smoke_against_cpu(dev, arch: str = TRAIN_ARCH) -> None:
    """``arch``'s smoke config in float32 on the card and on the CPU port
    from the same weights: three steps' losses and gradients."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, adamw_init, make_train_step,
                                   optimizer_view, synthetic_batch,
                                   value_and_grad)

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, remat=False)
    cpu = torch.device("cpu")
    runs = {}
    for d in (cpu, dev):
        gen = torch.Generator()
        gen.manual_seed(5)
        params = model.init(gen).to(d)    # the same weights on both
        runs[d.type] = [params, adamw_init(optimizer_view(params))]
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5,
                                              total_steps=10))
    worst_loss = worst_grad = 0.0
    for i in range(TRAIN_SMOKE["steps"]):
        out = {}
        for d in (cpu, dev):
            batch = synthetic_batch(cfg, TRAIN_SMOKE["batch"],
                                    TRAIN_SMOKE["seq"], 0, i, device=d)
            params, opt = runs[d.type]
            out[d.type] = value_and_grad(model, params, batch)
            runs[d.type][:2] = step(params, opt, batch)[:2]
        (lc, _, gc_), (lg, _, gg) = out["cpu"], out[dev.type]
        rel = abs(float(lg) - float(lc)) / abs(float(lc))
        worst_loss = max(worst_loss, rel)
        if not rel <= TRAIN_SMOKE_LOSS_RTOL:
            raise AssertionError(f"train smoke step {i}: card loss "
                                 f"{float(lg)} vs CPU {float(lc)}")
        for k, g in gc_.items():
            scale = float(g.abs().max())
            err = float((gg[k].cpu() - g).abs().max())
            worst_grad = max(worst_grad, err / max(scale, 1e-30))
            if not err <= TRAIN_SMOKE_GRAD_REL * scale:
                raise AssertionError(f"train smoke step {i}: gradient {k} "
                                     f"off by {err} of max {scale}")
    log(f"[train] smoke {arch} f32, {TRAIN_SMOKE['steps']} steps at "
        f"B={TRAIN_SMOKE['batch']} S={TRAIN_SMOKE['seq']}, card vs CPU: "
        f"losses within {worst_loss:.3g} (rtol {TRAIN_SMOKE_LOSS_RTOL}), "
        f"gradients within {worst_grad:.3g} of each leaf's largest "
        f"(limit {TRAIN_SMOKE_GRAD_REL})")


def train_end_to_end(dev) -> int:
    """Phase w: ``launch.train.train`` on mamba2-370m at full width, 8
    steps with checkpoints every 4, then a resume from the step-4
    checkpoint to step 8; returns the backward kernel's launches on that
    path."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, adamw_init, make_train_step,
                                   optimizer_view, synthetic_batch)

    ssd = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    cfg = get_config(TRAIN_ARCH)
    n_layers, steps = cfg.n_layers, TRAIN["steps"]
    tmp = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    try:
        kw = dict(smoke=False, batch=TRAIN["batch"], seq=TRAIN["seq"],
                  ckpt_every=TRAIN["ckpt_every"], log_every=1,
                  device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ssd.reset_launches()
        t0 = time.perf_counter()
        params, _, losses = train(TRAIN_ARCH, steps=steps,
                                  ckpt_dir=str(tmp / "a"), resume=False,
                                  **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = ssd.LAUNCHES, ssd.BWD_LAUNCHES
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train: a loss is not finite: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train: the last loss {losses[-1]} is not "
                                 f"below the first {losses[0]}")
        if bwd != n_layers * steps or fwd != 2 * n_layers * steps:
            raise AssertionError(
                f"train: {fwd} forward and {bwd} backward SSD launches in "
                f"{steps} steps, expected {2 * n_layers * steps} (the "
                f"forward and its recomputation) and {n_layers * steps}")
        log(f"[train] {TRAIN_ARCH} full width ({n_layers} layers, d_model "
            f"{cfg.d_model}, H {cfg.ssm_heads} P {cfg.ssm_head_dim} N "
            f"{cfg.ssm_state}, chunk {cfg.ssd_chunk}), B={TRAIN['batch']} "
            f"S={TRAIN['seq']}, {steps} steps through launch/train.py: "
            f"losses {[round(x, 4) for x in losses]}; {wall:.2f} s with "
            f"init and checkpoints; peak memory {peak:.2f} GiB; SSD "
            f"launches forward {fwd} (forward + recomputation), backward "
            f"{bwd}")

        # Resume from the step-4 checkpoint (keep=3 left steps 4 and 8),
        # moved, not copied: the whole run keeps its disk writes under
        # 45 GiB.
        (tmp / "b").mkdir()
        name = f"step_{TRAIN_RESUME_AT:08d}"
        shutil.move(str(tmp / "a" / name), str(tmp / "b" / name))
        ssd.reset_launches()
        resumed, _, res_losses = train(TRAIN_ARCH, steps=steps,
                                       ckpt_dir=str(tmp / "b"), resume=True,
                                       **kw)
        bwd_resumed = ssd.BWD_LAUNCHES
        if bwd_resumed != n_layers * (steps - TRAIN_RESUME_AT):
            raise AssertionError(f"train: {bwd_resumed} backward SSD "
                                 f"launches in the resumed run")
        want = losses[TRAIN_RESUME_AT:]
        worst = max(abs(a - b) / abs(b) for a, b in zip(res_losses, want))
        if len(res_losses) != len(want) or not worst <= TRAIN_RESUME_RTOL:
            raise AssertionError(f"train: resumed losses {res_losses} vs "
                                 f"{want}")
        same = sum(torch.equal(p, q) for p, q in zip(
            params.parameters(), resumed.parameters()))
        n_params = len(list(params.parameters()))
        log(f"[train] resumed from step {TRAIN_RESUME_AT}: losses "
            f"{[round(x, 4) for x in res_losses]}, within {worst:.3g} of the "
            f"uninterrupted run's (rtol {TRAIN_RESUME_RTOL}); losses "
            f"bit-equal: {res_losses == want}; {same} of {n_params} "
            f"parameter tensors bit-equal at step {steps}")
        del resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # One step's time, tokens/s and where it goes.
    model = build_model(cfg, remat=True)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5,
                                              total_steps=100))
    state = [params, adamw_init(optimizer_view(params))]
    batch = synthetic_batch(cfg, TRAIN["batch"], TRAIN["seq"], 0, steps,
                            device=dev)

    def one_step():
        state[:2] = step(state[0], state[1], batch)[:2]

    ms = _event_ms(one_step, reps=1)
    tokens = TRAIN["batch"] * TRAIN["seq"]
    log(f"[train] one full-width step: {ms:.2f} ms (CUDA events), "
        f"{tokens / ms * 1e3:.0f} tokens/s")
    _profile(cfg, f"training step B={TRAIN['batch']} S={TRAIN['seq']}",
             one_step)
    del state, params, batch
    gc.collect()
    torch.cuda.empty_cache()

    _train_smoke_against_cpu(dev)
    # The attention families, their flash attention forward and backward
    # on the card's float32 kernels against the CPU's plain attention.
    for arch in TRAIN_SMOKE_ATTENTION:
        _train_smoke_against_cpu(dev, arch)
    return bwd + bwd_resumed


# ---------------------------------------------------------------------------
# phase x: the flash-attention backward kernel against plain
# ---------------------------------------------------------------------------

# (label, B, H, KV, Sq, Sk, hd, causal, window): the training shapes of
# phase y's models (stablelm-3b at its batch; whisper-medium's encoder,
# decoder self and cross attention; llava's and mixtral's hd 128 over 8
# kv heads, with mixtral's window cut to 1024, since 4096 never binds at
# S 2048), chatglm3-6b's 2 kv heads (G = 16), zamba2-7b's hd 112, hd 32,
# ragged S, and causal at Sq != Sk (query 0 with key 0).
FLASH_BWD_CASES = (
    ("stablelm-3b", 8, 32, 32, 2048, 2048, 80, True, 0),
    ("whisper-medium encoder", 8, 16, 16, 1500, 1500, 64, False, 0),
    ("whisper-medium decoder self", 8, 16, 16, 447, 447, 64, True, 0),
    ("whisper-medium cross", 8, 16, 16, 447, 1500, 64, False, 0),
    ("llava/mixtral", 2, 32, 8, 2048, 2048, 128, True, 0),
    ("mixtral, window 1024", 2, 32, 8, 2048, 2048, 128, True, 1024),
    ("chatglm3-6b", 1, 32, 2, 2048, 2048, 128, True, 0),
    ("zamba2-7b", 1, 32, 32, 2048, 2048, 112, True, 0),
    ("hd 32", 2, 8, 8, 512, 512, 32, True, 0),
    *((f"ragged S={s}", 1, 8, 2, s, s, 80, True, 0)
      for s in (1, 37, 129, 1000)),
    ("causal Sq > Sk", 1, 4, 4, 300, 129, 64, True, 0),
    ("causal Sq < Sk, window 40", 1, 4, 2, 129, 300, 64, True, 40),
)
# Timed, beside the bound, the plain version and SDPA's backward.
FLASH_BWD_TIMED = ("stablelm-3b", "whisper-medium encoder",
                   "whisper-medium cross")
# Each gradient within tol x max(1, its largest plain magnitude); the
# forward's lse within FLASH_LSE_TOL of max(1, its largest).  bf16: P and
# dS enter the tensor-core products rounded once to bf16, and the
# gradients are rounded once on the way out.
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_LSE_TOL = 1e-4
FLASH_BWD_GRADS = ("dq", "dk", "dv")


def _attn_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head."""
    total = 0
    for r in range(sq):
        hi = min(r + 1, sk) if causal else sk
        lo = max(r - window + 1, 0) if window > 0 else 0
        total += max(hi - lo, 0)
    return total


def _flash_bwd_bound(b, h, kv, sq, sk, hd, causal, window, elt: int):
    """(bound ms, what bounds it) of one backward call: S, dP, dV, dK and
    dQ, 2 hd flops each per unmasked pair, at the bf16 peak; q, o, dO, dq
    and k, v, dk, dv once, and lse, over 3.35 TB/s."""
    flops = 10 * hd * h * b * _attn_pairs(sq, sk, causal, window)
    n_bytes = (4 * b * h * sq * hd + 4 * b * kv * sk * hd) * elt + 4 * b * h * sq
    by_ops = flops / BF16_FLOPS * 1e3
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def _bshd_views(b, h, s, hd, gen, dev, dtype, random=True):
    """A (B, S, H, hd) tensor, the model's layout, as a (B, H, S, hd)
    view."""
    shape = (b, s, h, hd)
    t = (torch.randn(shape, generator=gen, device=dev).to(dtype) if random
         else torch.empty(shape, dtype=dtype, device=dev))
    return t.transpose(1, 2)


def flash_bwd_vs_plain(dev) -> dict:
    """Phase x: the backward kernel (and the forward's lse) against
    ``attention_bwd_ref`` (``attention_lse_ref``) on the same CUDA
    tensors, each case twice bit-equal; times at the training shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)
    fa = importlib.import_module("repro_torch.kernels.flash_attention"
                                 ".flash_attention")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_rel = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_lse = 0.0
    for label, b, h, kv, sq, sk, hd, causal, window in FLASH_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = (f"{label} (B={b} H={h} KV={kv} Sq={sq} Sk={sk} hd={hd} "
                    f"causal={causal} window={window}) {str(dtype)[6:]}")
            q, do = (_bshd_views(b, h, sq, hd, gen, dev, dtype)
                     for _ in range(2))
            k, v = (_bshd_views(b, kv, sk, hd, gen, dev, dtype)
                    for _ in range(2))
            o = _bshd_views(b, h, sq, hd, gen, dev, dtype, random=False)
            lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
            mask = dict(causal=causal, window=window)
            fa.flash_attention_bhsd(q, k, v, out=o, lse=lse, **mask)
            # A recomputation under checkpoint must give the saved bits.
            o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
            fa.flash_attention_bhsd(q, k, v, out=o2, lse=lse2, **mask)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(f"flash_bwd {name}: the forward's o "
                                     f"or lse differs between two calls")
            del o2, lse2
            want_o, want_lse = attention_lse_ref(q, k, v, **mask)
            err_o = float((o.float() - want_o.float()).abs().max())
            if not err_o <= FLASH_TOL[dtype]:
                raise AssertionError(f"flash_bwd {name}: the forward's "
                                     f"output off by {err_o}")
            err_lse = float((lse - want_lse).abs().max())
            scale = max(1.0, float(want_lse.abs().max()))
            worst_lse = max(worst_lse, err_lse / scale)
            if not (torch.isfinite(lse).all() and err_lse <= FLASH_LSE_TOL
                    * scale):
                raise AssertionError(f"flash_bwd {name}: lse off by "
                                     f"{err_lse} of {scale}")
            del want_o, want_lse

            def bwd():
                bufs = [_bshd_views(b, n, s, hd, gen, dev, dtype, False)
                        for n, s in ((h, sq), (kv, sk), (kv, sk))]
                return fa.flash_attention_bhsd_bwd(
                    q, k, v, o, lse, do, dq=bufs[0], dk=bufs[1], dv=bufs[2],
                    **mask)

            got, again = bwd(), bwd()
            torch.cuda.synchronize()
            for what, g1, g2 in zip(FLASH_BWD_GRADS, got, again):
                if not torch.equal(g1, g2):
                    raise AssertionError(f"flash_bwd {name}: {what} differs "
                                         f"between two calls")
            del again
            want = attention_bwd_ref(q, k, v, o, lse, do, **mask)
            parts = []
            for what, g, w in zip(FLASH_BWD_GRADS, got, want):
                err = float((g.float() - w.float()).abs().max())
                scale = max(1.0, float(w.float().abs().max()))
                worst[dtype] = max(worst[dtype], err)
                worst_rel[dtype] = max(worst_rel[dtype], err / scale)
                if not err <= FLASH_BWD_TOL[dtype] * scale:
                    raise AssertionError(
                        f"flash_bwd {name}: {what} off by {err}, above "
                        f"{FLASH_BWD_TOL[dtype]} x {scale:.4g}")
                parts.append(f"{what} {err:.3g} of {scale:.4g}")
            log(f"[flash_bwd] {name}: max abs error " + ", ".join(parts)
                + f"; lse {err_lse:.3g}, o {err_o:.3g}; forward (o, lse) and "
                "backward each bit-equal over two calls")
            del q, k, v, do, o, lse, got, want
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[flash_bwd] worst error over max(1, |plain|): f32 "
        f"{worst_rel[torch.float32]:.3g} (tolerance "
        f"{FLASH_BWD_TOL[torch.float32]}), bf16 "
        f"{worst_rel[torch.bfloat16]:.3g} ({FLASH_BWD_TOL[torch.bfloat16]});"
        f" lse {worst_lse:.3g} ({FLASH_LSE_TOL})")

    timed = {}
    cases = {c[0]: c[1:] for c in FLASH_BWD_CASES}
    for label in FLASH_BWD_TIMED:
        b, h, kv, sq, sk, hd, causal, window = cases[label]
        mask = dict(causal=causal, window=window)
        dt = torch.bfloat16
        q, do = (_bshd_views(b, h, sq, hd, gen, dev, dt) for _ in range(2))
        k, v = (_bshd_views(b, kv, sk, hd, gen, dev, dt) for _ in range(2))
        o = _bshd_views(b, h, sq, hd, gen, dev, dt, random=False)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        grads = [_bshd_views(b, n, s, hd, gen, dev, dt, False)
                 for n, s in ((h, sq), (kv, sk), (kv, sk))]
        fwd = lambda: fa.flash_attention_bhsd(q, k, v, out=o, **mask)
        fwd_lse = lambda: fa.flash_attention_bhsd(q, k, v, out=o, lse=lse,
                                                  **mask)
        fwd_lse()
        run = lambda: fa.flash_attention_bhsd_bwd(
            q, k, v, o, lse, do, dq=grads[0], dk=grads[1], dv=grads[2],
            **mask)
        ms, graph_ms = _event_ms(run, reps=10), _median_ms(run, 5, 10)
        f_ms, f_graph = _event_ms(fwd, reps=10), _median_ms(fwd, 5, 20)
        fl_ms, fl_graph = (_event_ms(fwd_lse, reps=10),
                           _median_ms(fwd_lse, 5, 20))
        plain_ms = _event_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                       **mask), reps=3)
        # SDPA's backward alone, on (B, H, S, hd) copies (its graph kept
        # between calls), for the library column; and replayed from a
        # CUDA graph, as its forward and backward less its forward.
        qs, ks, vs = (t.contiguous().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        dos = do.contiguous()
        lib_ms = _event_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), dos, retain_graph=True), reps=10)
        del out
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=causal)
        lib_both = _median_ms(lambda: torch.autograd.grad(
            sdpa(), (qs, ks, vs), dos), 5, 10)
        lib_fwd = _median_ms(sdpa, 5, 10)
        lib_graph = lib_both - lib_fwd
        del qs, ks, vs, dos
        bound_ms, bound_by = _flash_bwd_bound(b, h, kv, sq, sk, hd, causal,
                                              window, 2)
        timed[label] = (ms, plain_ms, bound_ms, bound_by, lib_ms)
        log(f"[flash_bwd] {label} B={b} H={h} KV={kv} Sq={sq} Sk={sk} "
            f"hd={hd} causal={causal} bf16: backward kernel {ms:.4f} ms "
            f"eager (graph replay {graph_ms:.4f} ms), plain "
            f"(attention_bwd_ref) {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention's backward {lib_ms:.4f} ms eager"
            f" ({lib_graph:.4f} replayed: {lib_both:.4f} forward and "
            f"backward less {lib_fwd:.4f} forward); kernel over SDPA "
            f"{ms / lib_ms:.4f} eager, {graph_ms / lib_graph:.4f} replayed;"
            f" bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.4f} of"
            f" it eager, {bound_ms / graph_ms:.4f} replayed; the forward "
            f"(row 4) {f_ms:.4f} ms eager, {f_graph:.4f} replayed without "
            f"lse, {fl_ms:.4f} / {fl_graph:.4f} with it")
        parts = _flash_bwd_kernels(run)
        pairs = b * h * _attn_pairs(sq, sk, causal, window)
        issued = {"dkv_wgmma": 8 * hd * pairs, "dq_wgmma": 6 * hd * pairs}
        log(f"[flash_bwd] {label} profiled call: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
            + "; rates over the issued products: "
            + ", ".join(f"{k} {issued[k] / parts[k] / 1e9:.1f} TFLOP/s"
                        for k in issued if k in parts)
            + f"; the call {14 * hd * pairs / graph_ms / 1e9:.1f} TFLOP/s "
            f"replayed ({14 * hd * pairs / 1e9:.1f} GFLOP issued, "
            f"{10 * hd * pairs / 1e9:.1f} in the bound)")
        del q, k, v, do, o, lse, grads
        gc.collect()
        torch.cuda.empty_cache()
    ms, plain_ms, bound_ms, bound_by, lib_ms = timed[FLASH_BWD_TIMED[0]]
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention/"
                         "flash_attention.py:27",
                launches=0, max_abs_err=max(worst.values()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms)


def _flash_bwd_kernels(run) -> dict:
    """Device ms of each of the backward's three kernels in one profiled
    call."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = PORT_KERNELS["flash_attention_bwd"]
    return {name: ms for name, (_, ms) in _port_kernel_ms(
        _device_kernels(prof), names).items()}


# ---------------------------------------------------------------------------
# phase y: the attention families trained at full width
# ---------------------------------------------------------------------------

# (arch, batch, tokens, steps, checkpoint every, resume from, the depth
# of the resume check): every layer at the published widths through
# launch/train.py.  A checkpoint holds the bf16 weights and AdamW's two
# float32 moments: 28 GB at stablelm-3b's 32 layers, 7.6 GB at whisper-
# medium's 24 + 24.  The uninterrupted run and the resumed one write three
# (steps 4 and 8, and 8 again), and the whole run keeps its disk writes
# under 45 GiB (phase w's are 11 GB), so the full depth trains without
# checkpoints and the resume check runs at the same widths and batch with
# 2 layers (2 + 2 for whisper): 4.2 and 1.2 GB a checkpoint.
TRAIN_FULL = (("stablelm-3b", 8, 2048, 8, 4, 4, dict(n_layers=2)),
              ("whisper-medium", 8, 447, 4, 2, 2,
               dict(n_layers=2, n_enc_layers=2)))
# Full width with fewer layers, so that the weights, their gradients and
# AdamW's float32 moments fit one 80 GB card: (arch, layers kept, batch,
# tokens), TRAIN_CUT_STEPS steps each through the train step.  mixtral-
# 8x7b keeps 2 of 32 layers (3.2 B parameters, ~51 GB with moments and
# gradients), zamba2-7b 18 of 81 (two calls of the shared attention
# block), llava-next-mistral-7b 8 of 32 with its 576 patches (S 2048).
TRAIN_CUT = (("mixtral-8x7b", 2, 8, 2048),
             ("zamba2-7b", 18, 8, 2048),
             ("llava-next-mistral-7b", 8, 8, 1472))
TRAIN_CUT_STEPS = 2


def _attention_calls(cfg) -> int:
    """Flash calls in one forward of ``loss``: a layer's self attention;
    whisper's encoder self, decoder self and cross attention; the hybrid's
    shared block where it runs."""
    from repro_torch.models.model import n_shared_invocations

    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return n_shared_invocations(cfg)
    return cfg.n_layers


def _check_flash_launches(what: str, fwd: int, bwd: int, calls: int,
                          steps: int) -> None:
    """Under per-layer recomputation each attention forward runs twice a
    step (forward and recomputed) and its backward once."""
    if fwd != 2 * calls * steps or bwd != calls * steps:
        raise AssertionError(
            f"{what}: {fwd} forward and {bwd} backward flash launches in "
            f"{steps} steps, expected {2 * calls * steps} and "
            f"{calls * steps} ({calls} attention calls a forward)")


def _check_losses(what: str, losses) -> None:
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the last loss {losses[-1]} is not "
                             f"below the first {losses[0]}")


@contextlib.contextmanager
def _trainer_config(**fields):
    """``launch.train.train`` builds its config with these fields
    replaced (a depth cut) while the block runs."""
    import dataclasses

    lt = importlib.import_module("repro_torch.launch.train")
    orig = lt.get_config
    lt.get_config = lambda arch: dataclasses.replace(orig(arch), **fields)
    try:
        yield
    finally:
        lt.get_config = orig


def _train_full(dev, arch, batch, seq, steps, every, resume_at,
                cut) -> tuple:
    """``launch.train.train`` on ``arch`` at full width and depth for
    ``steps`` steps (:func:`_timed_train`), then at the depth ``cut``
    with checkpoints every ``every`` and a resume from step
    ``resume_at``; returns (the full model, flash forward launches,
    backward launches, the full-depth run)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    fa = importlib.import_module("repro_torch.kernels.flash_attention"
                                 ".flash_attention")
    cfg = get_config(arch)
    calls = _attention_calls(cfg)
    kw = dict(smoke=False, batch=batch, seq=seq, log_every=1, device=dev)
    run = _timed_train(arch, batch, seq, steps, None, dev, keep=True)
    params, losses, wall = run.pop("params"), run["losses"], run["wall"]
    fwd = run["launches"]["flash_attention"]
    bwd = run["launches"]["flash_attention_bwd"]
    peak = run["peak"]
    _check_losses(f"train {arch}", losses)
    _check_flash_launches(f"train {arch}", fwd, bwd, calls, steps)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[train] {arch} full width ({cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_seq} "
           f"frames" if cfg.family == "encdec" else "")
        + f", d_model {cfg.d_model}, H {cfg.n_heads} KV {cfg.n_kv_heads} "
        f"hd {cfg.head_dim_}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} "
        f"B parameters), bf16, B={batch} S={seq}, {steps} steps through "
        f"launch/train.py: losses {[round(x, 4) for x in losses]}; "
        f"{wall:.2f} s with init; peak memory {peak:.2f} GiB; flash "
        f"launches forward {fwd} (forward + recomputation), backward {bwd}")

    # Checkpoints and the resume at the depth cut (disk: see TRAIN_FULL).
    small = dataclasses.replace(cfg, **cut)
    small_calls = _attention_calls(small)
    tmp = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    try:
        with _trainer_config(**cut):
            fa.reset_launches()
            kw["ckpt_every"] = every
            ref, _, ref_losses = train(arch, steps=steps,
                                       ckpt_dir=str(tmp / "a"),
                                       resume=False, **kw)
            f_a, b_a = fa.LAUNCHES, fa.BWD_LAUNCHES
            _check_losses(f"train {arch} at {cut}", ref_losses)
            _check_flash_launches(f"train {arch} at {cut}", f_a, b_a,
                                  small_calls, steps)
            (tmp / "b").mkdir()
            name = f"step_{resume_at:08d}"
            shutil.move(str(tmp / "a" / name), str(tmp / "b" / name))
            shutil.rmtree(tmp / "a")
            fa.reset_launches()
            resumed, _, res_losses = train(arch, steps=steps,
                                           ckpt_dir=str(tmp / "b"),
                                           resume=True, **kw)
            f_r, b_r = fa.LAUNCHES, fa.BWD_LAUNCHES
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _check_flash_launches(f"train {arch} at {cut}, resumed", f_r, b_r,
                          small_calls, steps - resume_at)
    want = ref_losses[resume_at:]
    worst = max(abs(a - b) / abs(b) for a, b in zip(res_losses, want))
    if len(res_losses) != len(want) or not worst <= TRAIN_RESUME_RTOL:
        raise AssertionError(f"train {arch}: resumed losses {res_losses} vs "
                             f"{want}")
    same = sum(torch.equal(p, q) for p, q in zip(ref.parameters(),
                                                 resumed.parameters()))
    n_small = sum(p.numel() for p in ref.parameters())
    log(f"[train] {arch} at {cut} (same widths and batch; "
        f"{n_small / 1e9:.3f} B parameters), {steps} steps with checkpoints "
        f"every {every}: losses {[round(x, 4) for x in ref_losses]}; "
        f"resumed from step {resume_at}: losses "
        f"{[round(x, 4) for x in res_losses]}, within {worst:.3g} of the "
        f"uninterrupted run's (rtol {TRAIN_RESUME_RTOL}); losses bit-equal: "
        f"{res_losses == want}; {same} of {len(list(ref.parameters()))} "
        f"parameter tensors bit-equal at step {steps}")
    del ref, resumed
    gc.collect()
    torch.cuda.empty_cache()
    return params, fwd + f_a + f_r, bwd + b_a + b_r, run


def _train_step_numbers(dev, cfg, params, batch, seq, index) -> None:
    """One step's time (CUDA events), tokens/s and a profiled step."""
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, adamw_init, make_train_step,
                                   optimizer_view, synthetic_batch)

    model = build_model(cfg, remat=True)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5,
                                              total_steps=100), donate=True)
    state = [params, adamw_init(optimizer_view(params))]
    data = synthetic_batch(cfg, batch, seq, 0, index, device=dev)

    def one_step():
        state[:2] = step(state[0], state[1], data)[:2]

    ms = _event_ms(one_step, reps=1)
    tokens = batch * seq
    log(f"[train] {cfg.name} one full-width step: {ms:.2f} ms (CUDA events)"
        f", {tokens / ms * 1e3:.0f} tokens/s ({tokens} tokens a step)")
    _profile(cfg, f"training step B={batch} S={seq}", one_step)
    state.clear()


def _train_cut(dev, arch, layers, batch, seq) -> dict:
    """``arch`` at full width with ``layers`` layers: TRAIN_CUT_STEPS
    steps through ``launch.train.train`` (:func:`_timed_train`);
    returns the run."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    calls = _attention_calls(cfg)
    with _trainer_config(n_layers=layers):
        run = _timed_train(arch, batch, seq, TRAIN_CUT_STEPS, None, dev)
    losses, norms = run["losses"], run["gnorms"]
    fwd = run["launches"]["flash_attention"]
    bwd = run["launches"]["flash_attention_bwd"]
    # A finite global norm means every gradient element is finite.
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train {arch} ({layers} layers): losses "
                             f"{losses}, gradient norms {norms}")
    _check_flash_launches(f"train {arch} ({layers} layers)", fwd, bwd,
                          calls, TRAIN_CUT_STEPS)
    positions = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
    log(f"[train] {arch} full width (d_model {cfg.d_model}, H {cfg.n_heads} "
        f"KV {cfg.n_kv_heads} hd {cfg.head_dim_}), {layers} of "
        f"{full.n_layers} layers (cut so that weights, gradients and AdamW's "
        f"moments fit one card; {run['n_params'] / 1e9:.3f} B parameters), "
        f"bf16, B={batch} S={positions}: {TRAIN_CUT_STEPS} steps through "
        f"launch/train.py, losses {[round(x, 4) for x in losses]}, gradient "
        f"norms {[round(x, 4) for x in norms]} (finite); ms per step "
        f"{[round(t, 2) for t in run['times']]} (host clock around a "
        f"synchronised step; the first warms up); peak memory "
        f"{run['peak']:.2f} GiB; flash launches forward {fwd}, backward "
        f"{bwd} ({calls} attention calls a forward)")
    return run


def train_attention_families(dev) -> tuple:
    """Phase y: stablelm-3b and whisper-medium through launch/train.py at
    full width with a resume, their step times and profiles; mixtral-8x7b,
    zamba2-7b and llava-next-mistral-7b at full width with fewer layers.
    Returns (flash forward launches, backward launches, {arch: the
    unsharded run phase z repeats on a mesh, for MESH_TRAIN_Y})."""
    fwd = bwd = 0
    runs = {}
    for arch, batch, seq, steps, every, resume_at, cut in TRAIN_FULL:
        params, f, b, run = _train_full(dev, arch, batch, seq, steps, every,
                                        resume_at, cut)
        fwd, bwd = fwd + f, bwd + b
        runs[arch] = dict(run, setting=(batch, seq, steps, None))
        from repro_torch.configs import get_config
        _train_step_numbers(dev, get_config(arch), params, batch, seq, steps)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for arch, layers, batch, seq in TRAIN_CUT:
        run = _train_cut(dev, arch, layers, batch, seq)
        fwd += run["launches"]["flash_attention"]
        bwd += run["launches"]["flash_attention_bwd"]
        runs[arch] = dict(run, setting=(batch, seq, TRAIN_CUT_STEPS, layers))
    return fwd, bwd, {a: runs[a] for a in MESH_TRAIN_Y}


# ---------------------------------------------------------------------------
# phase z: sharded training on a DeviceMesh
# ---------------------------------------------------------------------------

# (arch, batch, seq, steps): trained unsharded and on a 1x1 DeviceMesh
# in phase z, full width and depth.
MESH_TRAIN = (("stablelm-3b", 8, 2048, 5), ("mamba2-370m", 8, 2048, 5))
# Trained unsharded in phase y (TRAIN_FULL's full-depth whisper-medium
# run, B 8 x 447 over 1500 frames, 4 steps; TRAIN_CUT's depths, 2 steps
# at 2048 positions) and on the 1x1 mesh in phase z with the same
# settings, so that each model trains unsharded once.
MESH_TRAIN_Y = ("whisper-medium", "mixtral-8x7b", "zamba2-7b",
                "llava-next-mistral-7b")
DRYRUN_TIMEOUT_S = 400
DRYRUN_1X1 = """
import json, sys
from pathlib import Path
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_distributed, make_test_mesh
init_distributed("fake", world_size=1, rank=0)
rec = dryrun.run_cell(get_config("stablelm-3b"),
                      ShapeSpec("train_b8_s2048", 2048, 8, "train"),
                      make_test_mesh(1, 1, device="fake"), "1x1",
                      Path(sys.argv[1]))
sys.exit(0 if rec["ok"] else 1)
"""


def _dry_runs(out: Path) -> list:
    """The three dry runs of phase z, started together as host
    subprocesses with no GPU visible, after the card's timed runs;
    returns [(name, process, start time)]."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    cells = [("mamba2-370m train_4k pod16x16",
              [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               "mamba2-370m", "--shape", "train_4k", "--single-pod-only",
               "--out", str(out)]),
             ("mixtral-8x7b train_4k pod16x16",
              [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               "mixtral-8x7b", "--shape", "train_4k", "--single-pod-only",
               "--out", str(out)]),
             ("stablelm-3b B8 S2048 1x1",
              [sys.executable, "-c", DRYRUN_1X1, str(out)])]
    return [(name, subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
             time.perf_counter()) for name, cmd in cells]


def _timed_train(arch, batch, seq, steps, mesh, dev, keep=False) -> dict:
    """``launch.train.train`` with each step timed on the host clock
    around a synchronised step; returns losses, grad norms, the step
    times (ms), their median (the first step left out), the wall time
    with init (s), the bytes allocated at the start and the peak (GiB),
    the kernel launches and, with ``keep``, the trained module."""
    lt = importlib.import_module("repro_torch.launch.train")
    orig = lt.make_train_step
    times, gnorms = [], []

    def make(*args, **kw):
        step = orig(*args, **kw)

        def timed_step(params, opt_state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            gnorms.append(float(out[2]["grad_norm"]))
            return out

        return timed_step

    fa = importlib.import_module("repro_torch.kernels.flash_attention"
                                 ".flash_attention")
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    fa.reset_launches()
    ssd.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    lt.make_train_step = make
    t0 = time.perf_counter()
    try:
        params, opt, losses = lt.train(arch, False, steps, batch, seq, None,
                                       False, log_every=1, mesh=mesh,
                                       device=dev)
    finally:
        lt.make_train_step = orig
    torch.cuda.synchronize()
    run = dict(losses=losses, gnorms=gnorms, times=times,
               ms=statistics.median(times[1:]),
               wall=time.perf_counter() - t0, base=base,
               peak=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches={"flash_attention": fa.LAUNCHES,
                         "flash_attention_bwd": fa.BWD_LAUNCHES,
                         "ssd_scan": ssd.LAUNCHES,
                         "ssd_scan_bwd": ssd.BWD_LAUNCHES},
               n_params=sum(p.numel() for p in params.parameters()))
    if keep:
        run["params"] = params
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return run


def _launches_per_step(cfg) -> dict:
    """Kernel launches a training step, from the model's code: under
    per-layer recomputation every forward call runs twice (forward and
    recomputed) and its backward once; a Mamba2 layer makes one SSD call,
    an attention call (``_attention_calls``) one flash call."""
    from repro_torch.models.model import MAMBA

    attn = 0 if cfg.family == "ssm" else _attention_calls(cfg)
    ssd = cfg.n_layers if cfg.family in MAMBA else 0
    return {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
            "ssd_scan": 2 * ssd, "ssd_scan_bwd": ssd}


def _same_as_unsharded(arch, cfg, plain, sharded, steps) -> None:
    """The 1x1 mesh's run against the unsharded one: losses and grad
    norms bit-equal, each kernel's launches those of the code, peak
    memory above the start's bytes within 1%."""
    want = {k: v * steps for k, v in _launches_per_step(cfg).items()}
    for name, run in (("unsharded", plain), ("1x1 mesh", sharded)):
        if run["launches"] != want:
            raise AssertionError(f"phase z {arch} {name}: launches "
                                 f"{run['launches']}, expected {want}")
    if not all(math.isfinite(x) for x in sharded["losses"]
               + sharded["gnorms"]):
        raise AssertionError(f"phase z {arch}: not finite: {sharded}")
    if (sharded["losses"] != plain["losses"]
            or sharded["gnorms"] != plain["gnorms"]):
        raise AssertionError(
            f"phase z {arch}: the 1x1 mesh's losses {sharded['losses']} / "
            f"grad norms {sharded['gnorms']} differ from the unsharded "
            f"{plain['losses']} / {plain['gnorms']}")
    grown = [r["peak"] - r["base"] for r in (plain, sharded)]
    if abs(grown[1] - grown[0]) > 0.01 * grown[0]:
        raise AssertionError(f"phase z {arch}: peak memory over the start "
                             f"{grown[1]:.3f} GiB on the mesh, "
                             f"{grown[0]:.3f} unsharded")


def _compression_on_card(mesh, dev) -> None:
    from repro_torch.train.compression import (compressed_allreduce,
                                               ef_compress_step)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = torch.randn(1 << 20, generator=gen, device=dev)
    out = compressed_allreduce(g, mesh, "data")
    err = float((out - g).abs().max())
    scale = float(g.abs().max()) / 127
    e, acc, ref = torch.zeros_like(g), torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(8):
        s, e = ef_compress_step(g, e, mesh, "data")
        acc, ref = acc + s, ref + g
    rel = float(torch.linalg.norm(acc - ref) / torch.linalg.norm(ref))
    if not (err < 3 * scale and rel < 0.02 and out.device == g.device):
        raise AssertionError(f"phase z compression: error {err} (scale "
                             f"{scale}), error feedback rel {rel}")
    log(f"[mesh] compressed_allreduce on the card (1,048,576 float32, int8 "
        f"wire, a data axis of one rank): max error {err:.4g} < 3 x scale "
        f"{scale:.4g}; ef_compress_step over 8 steps: rel {rel:.3g} < 0.02")


def train_on_mesh(dev, y_runs) -> dict:
    """Phase z: sharded training on a 1x1 DeviceMesh against unsharded
    training (MESH_TRAIN here; MESH_TRAIN_Y against phase y's runs
    ``y_runs``), compression on the card, three dry runs on the host.
    Returns the kernels' launches of the sharded runs."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_test_mesh

    tmp = Path(tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build"))
    dry = []
    init_distributed("cuda", world_size=1, rank=0,
                     store_path=str(tmp / "store"))
    launches = {}
    steps = {}
    try:
        mesh = make_test_mesh(1, 1, device="cuda")
        todo = [(arch, (batch, seq, n, None), None)
                for arch, batch, seq, n in MESH_TRAIN]
        todo += [(arch, y_runs[arch]["setting"], y_runs[arch])
                 for arch in MESH_TRAIN_Y]
        for arch, (batch, seq, n, layers), plain in todo:
            cut = {} if layers is None else {"n_layers": layers}
            cfg = dataclasses.replace(get_config(arch), **cut)
            with _trainer_config(**cut):
                if plain is None:
                    plain = _timed_train(arch, batch, seq, n, None, dev)
                sharded = _timed_train(arch, batch, seq, n, mesh, dev)
            _same_as_unsharded(arch, cfg, plain, sharded, n)
            for name, count in sharded["launches"].items():
                launches[name] = launches.get(name, 0) + count
            steps[arch] = sharded
            per_step = {k: v for k, v in _launches_per_step(cfg).items()
                        if v}
            depth = (f"{cfg.n_layers} layers" if layers is None else
                     f"{layers} of {get_config(arch).n_layers} layers")
            if cfg.family == "encdec":
                depth += f" + {cfg.n_enc_layers} encoder layers"
            positions = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
            log(f"[mesh] {arch} full width ({depth}, "
                f"{sharded['n_params'] / 1e9:.3f} B parameters), bf16, "
                f"B={batch} S={positions}, {n} steps through launch/train.py "
                f"on a 1x1 DeviceMesh (nccl): losses "
                f"{[round(x, 4) for x in sharded['losses']]} and grad norms "
                f"{[round(x, 4) for x in sharded['gnorms']]}, bit-equal to "
                f"the unsharded run's"
                + (" (phase y)" if arch in MESH_TRAIN_Y else "")
                + f"; launches a step {per_step} in both; "
                f"{sharded['ms']:.2f} ms a step (unsharded "
                f"{plain['ms']:.2f} ms; median of steps 2-{n}, host clock "
                f"around a synchronised step); peak memory "
                f"{sharded['peak']:.2f} GiB, {sharded['peak'] - sharded['base']:.3f} "
                f"over the start (unsharded {plain['peak']:.2f}, "
                f"{plain['peak'] - plain['base']:.3f}); {card_line()}")
            plain = sharded = None
        _compression_on_card(mesh, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    try:
        # after the timed runs, so that nothing else shares the host then
        dry = _dry_runs(tmp / "dryrun")
        for name, proc, t0 in dry:
            out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"phase z dry run {name} failed: "
                                     f"{out[-3000:]}")
            log(f"[mesh] dry run {name}: {wall:.1f} s in a host subprocess "
                f"(the three started together after the card's runs)")
        for f in sorted((tmp / "dryrun").glob("*.json")):
            rec = json.loads(f.read_text())
            r, m = rec["roofline"], rec["memory"]
            line = (f"[mesh] dry-run record {f.name}: {rec['n_chips']} "
                    f"GPUs, accum {rec['accum']}, {rec['n_ops']} ops, run "
                    f"{rec['run_s']} s; per GPU {rec['hlo']['flops']:.4g} "
                    f"flops, {rec['hlo']['bytes']:.4g} bytes, collectives "
                    f"{rec['hlo']['collectives']}; t_compute "
                    f"{r['t_compute_s'] * 1e3:.2f} ms, t_memory "
                    f"{r['t_memory_s'] * 1e3:.2f} ms, t_collective "
                    f"{r['t_collective_s'] * 1e3:.2f} ms ({r['dominant']}); "
                    f"peak {m['peak_bytes_per_device'] / 2 ** 30:.2f} GiB")
            if rec["arch"] == "stablelm-3b":
                st = steps["stablelm-3b"]
                line += (f"; measured on the card: {st['ms']:.2f} ms a step, "
                         f"peak {st['peak']:.2f} GiB")
            log(line)
    finally:
        for _, proc, _ in dry:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _log_build(logs: dict, t0: float) -> None:
    """The built kernels, the time since t0, and each kernel function's
    registers, shared memory and spills as ptxas reports them, with any
    warning that it serialised wgmma products."""
    log(f"[device] built {sorted(logs)} in {time.perf_counter() - t0:.2f} "
        f"s")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "smem" in line or (
                    "Performance Loss" in line) or (
                    "spill" in line and " 0 bytes spill stores" not in line):
                log(f"[device]   {name}: {entry}: {line.strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    # Plain versions on the card in real float32 (PyTorch's default,
    # pinned here): phases g and i hold kernels and runs against them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; python "
        f"{sys.version.split()[0]}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")
    log(f"[device] nvidia-smi: {card}")
    t0 = time.perf_counter()
    # The two backward kernels, the slowest sources, build while phases
    # 2-k run: phases v and x are the first to launch them.
    late, late_logs = ["ssd_scan_bwd", "flash_attention_bwd"], {}
    late_build = threading.Thread(
        target=lambda: late_logs.update(_build.build_all(late)))
    late_build.start()
    _log_build(_build.build_all([n for n in _build.sources()
                                 if n not in late]), t0)

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(dev, *args)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    pick = timed("2", kernel_vs_plain)
    kernels = [pick, timed("2 (queue kernel)", queue_kernel_vs_plain, pick),
               *timed("a", batch_kernels_vs_plain),
               timed("g", flash_vs_plain),
               timed("k", ssd_vs_plain)]
    late_build.join()
    if set(late_logs) != set(late):
        raise RuntimeError(f"building {late} failed (its error is above)")
    _log_build(late_logs, t0)
    kernels.append(timed("v", ssd_bwd_vs_plain))
    kernels.append(timed("x", flash_bwd_vs_plain))
    launches, ts, res_seq, seq_rate, res_plain = timed("3",
                                                       slice_end_to_end)
    launches["flex_score_batch_topk"], res_wave = timed(
        "b", wavefront_study, ts, res_seq)
    launches["flex_score_batch_pick"] = timed("c", topk0_loop, ts,
                                              res_seq)
    timed("d", dedup_queue)
    timed("4", small_run_against_cpu, "sequential")
    timed("4 (faults)", small_faults_against_cpu)
    timed("e", small_run_against_cpu, "wavefront")
    launches["flex_score_pick"] = timed("5", profile_decisions)
    timed("5 (study)", profile_study, ts)
    round_ms = timed("f", profile_wavefront)
    study = timed("6", batched_study, ts, res_seq, seq_rate, res_plain,
                  res_wave, round_ms)
    res_plain = res_wave = None
    log(f"[launches] phase 6: flex_score_admit {study['flex_score_admit']}, "
        f"flex_score_batch_topk {study['flex_score_batch_topk']}")
    for name, count in study.items():
        launches[name] += count
    recl = timed("n", reclaim_end_to_end, ts, res_seq, seq_rate)
    learned = timed("o", learned_end_to_end, ts)
    faults = timed("p", fault_end_to_end, ts, seq_rate)
    guard = timed("q", guard_end_to_end, ts)
    for phase, c in (("n", recl), ("o", learned), ("p", faults),
                     ("q", guard)):
        log(f"[launches] phase {phase}: flex_score_admit "
            f"{c['flex_score_admit']}, flex_score_batch_topk "
            f"{c['flex_score_batch_topk']}")
        for name, count in c.items():
            launches[name] += count
    launches["flash_attention"], serve_runs = timed("h", serve_end_to_end)
    timed("i", prefill_vs_decode)
    timed("j", profile_serving)
    launches["ssd_scan"] = timed("l", serve_mamba2, serve_runs)
    zamba = timed("m", serve_zamba2, serve_runs)
    timed("m (final state)", final_state_check)
    timed("m (profile)", profile_serving, get_config("mamba2-370m"))
    log(f"[serve] launches on the SSM path: ssd_scan {launches['ssd_scan']}"
        f" (mamba2-370m, flex), ssd_scan {zamba['ssd_scan']} and "
        f"flash_attention {zamba['flash_attention']} (zamba2-7b, flex)")
    faulted = timed("r", serve_faults)
    moe = timed("s", serve_mixtral, serve_runs)
    log(f"[launches] phase r: flash_attention "
        f"{faulted['flash_attention']}, flex_score_batch_topk "
        f"{faulted['flex_score_batch_topk']}; phase s: flash_attention "
        f"{moe['flash_attention']}")
    launches["flash_attention"] += (faulted["flash_attention"]
                                    + moe["flash_attention"])
    encdec = timed("t", encdec_end_to_end)
    vlm = timed("u", vlm_end_to_end)
    log(f"[launches] phase t: flash_attention {encdec}; phase u: "
        f"flash_attention {vlm}")
    launches["flash_attention"] += encdec + vlm
    launches["ssd_scan_bwd"] = timed("w", train_end_to_end)
    log(f"[launches] phase w: ssd_scan_bwd {launches['ssd_scan_bwd']}")
    fwd_y, launches["flash_attention_bwd"], y_runs = timed(
        "y", train_attention_families)
    log(f"[launches] phase y: flash_attention {fwd_y}, flash_attention_bwd "
        f"{launches['flash_attention_bwd']}")
    launches["flash_attention"] += fwd_y
    mesh_launches = timed("z", train_on_mesh, y_runs)
    log(f"[launches] phase z: {mesh_launches}")
    for name, count in mesh_launches.items():
        launches[name] += count
    launches["flex_score_batch_topk"] += faulted["flex_score_batch_topk"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on the path")

    log(f"[time] all phases and the build: "
        f"{time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

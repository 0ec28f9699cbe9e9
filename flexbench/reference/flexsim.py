"""Plain reference of a Flex study, held against the program's outputs.

A study is a slot loop over a cluster: each slot the running tasks draw
demand (AR(1) around their mean, clipped at their peak), a weighted fair
share allocator gives each node's capacity to its tasks, the cluster QoS
drives the penalty controller, the estimator refreshes the load estimate,
and a queue of retries and new arrivals is admitted one task at a time:
a node is feasible when ``P * L-hat + reserved + r <= cap`` on every
resource, and the feasible node with the best score ``-(w_load *
max_R(load) + w_src * same-source share)`` wins.  With reclamation the
tasks dropped for good join a pool that a second pass re-admits against
``cap = 1 - margin * P`` (paper §4, Alg. 3; the reclamation as docs/api.md
"Headroom reclamation" documents it).

The check follows the program's decisions, as a served model's tokens are
checked against a reference run over the tokens it served: the running
set of every slot comes from the program's placements and admit slots,
and every decision is judged on the state the earlier ones left.  What is
judged, each stage from the program's own output of the stage before it:

* ``decision_gap``: the widest gap of a decision.  A placed task's gap is
  how far its node's score lies below the best score of the nodes clearly
  inside their caps, or how far the node is over its cap; a refused
  task's gap is the slack of the node that it fits best (0 when it fits
  nowhere).  A node within ``BAND`` of its cap, where rounding decides
  the filter, counts either way;
* ``series_gap``: the widest absolute gap of the per-slot QoS, penalty
  (the controller's step from the program's QoS), mean usage, requests,
  estimate and usage spread;
* ``count_mismatch``: integers that differ: running tasks, cumulative
  rejections and reclaimed tasks per slot, each task's active slots, and
  any placement that no queue of its admit slot accounts for;
* ``qos_ok_mismatch``: tasks whose count of slots with QoS met differs.

Nothing here imports the program: every input comes from the benchmark
(the trace arrays, the demand noise, the configuration), and the
program's outputs are read only to be judged.

The control is this reference in bfloat16 put in the program's place: at
every position of the same trajectory it decides by itself, and its
decisions, series and counts are judged as the program's are.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

R = 2
SRC_BUCKETS = 64
WFS_EPS = 1e-9       # the allocator's tolerance (paper §3)
QOS_EPS = 1e-6       # q_j = 1 iff alloc + eps >= min(demand, request)
NEG = float("-inf")
# Half-width of the band around a node's cap that rounding decides: the
# program fuses P * L-hat + reserved into one rounding, sums usage in
# another order and scales its ulps by P (up to 16).
BAND = 1e-5

# Decisions judged at once: (chunk, N, R) tensors of the state each
# decision saw.
CHUNK = 256


class Study(NamedTuple):
    """One run of a study as the benchmark set it up."""

    trace: dict          # name -> numpy array (the trace's struct of arrays)
    noise: torch.Tensor  # (S, T) float32 demand noise
    cluster: dict        # n_nodes, n_slots, arrivals_per_slot, ...
    params: dict         # qos_target, alpha, beta, p_init, ...


class Outputs(NamedTuple):
    """What the program returned for one run (numpy arrays)."""

    placement: np.ndarray     # (T,) node or -1
    admit_slot: np.ndarray    # (T,) slot or -1
    qos_ok_slots: np.ndarray  # (T,)
    active_slots: np.ndarray  # (T,)
    qos: np.ndarray           # (S,)
    penalty: np.ndarray       # (S,)
    usage: np.ndarray         # (S, R)
    requested: np.ndarray     # (S, R)
    est_usage: np.ndarray     # (S, R)
    usage_std: np.ndarray     # (S, R)
    n_running: np.ndarray     # (S,)
    n_rejected: np.ndarray    # (S,)
    n_reclaimed: np.ndarray   # (S,)


def arrival_rows(arrival: np.ndarray, n_slots: int, width: int) -> list:
    """Each slot's arriving tasks in index order, at most ``width``."""
    return [np.flatnonzero(arrival == s)[:width] for s in range(n_slots)]


def _seg_sum(x, seg, n):
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, x)


def _fill(cap_node, w, caps, seg, mask, n, iters):
    """Weighted progressive filling of ``caps`` into ``cap_node``."""
    caps = torch.clamp(caps, min=0) * mask[:, None]
    w = torch.clamp(w, min=WFS_EPS) * mask
    fits = (_seg_sum(caps, seg, n) <= cap_node + WFS_EPS)[seg]
    alloc = torch.where(fits, caps, torch.zeros_like(caps))
    left = cap_node - _seg_sum(alloc, seg, n)
    for _ in range(iters):
        need = caps - alloc
        unsat = (need > WFS_EPS) & ~fits
        w_eff = torch.where(unsat, w[:, None], torch.zeros_like(caps))
        w_node = _seg_sum(w_eff, seg, n)
        share = left[seg] * w_eff / torch.clamp(w_node[seg], min=WFS_EPS)
        give = torch.minimum(torch.clamp(share, min=0), need) * unsat
        alloc = alloc + give
        left = left - _seg_sum(give, seg, n)
    return alloc


def allocate(demand, request, seg, active, n, iters):
    """Weighted fair share (paper §3): every task first gets up to its
    request, then the remaining capacity goes to the excess demand, both
    by water-filling weighted by the task's largest request."""
    mask = active.to(demand.dtype)
    w = torch.clamp(request.max(dim=-1).values, min=WFS_EPS)
    one = torch.ones((n, R), dtype=demand.dtype, device=demand.device)
    a1 = _fill(one, w, torch.minimum(demand, request), seg, mask, n, iters)
    a2 = _fill(one - _seg_sum(a1, seg, n), w, demand - a1, seg, mask, n,
               iters)
    alloc = (a1 + a2) * mask[:, None]
    return alloc, _seg_sum(alloc, seg, n)


def penalty_step(p, prev_q, q, prm):
    """One step of the estimation-penalty controller (Alg. 3)."""
    if q >= prm["qos_target"]:
        p = max(p * prm["alpha"], prm["p_min"])
    elif q < prev_q:
        p = p + prm["beta"] * (p - 1.0)
    return min(max(p, prm["p_min"]), prm["p_max"])


class _State:
    """One precision's view of the cluster along the forced trajectory."""

    def __init__(self, st: Study, dt, dev):
        c = st.cluster
        self.dt, self.dev, self.n = dt, dev, c["n_nodes"]
        t = st.trace
        f = lambda k: torch.as_tensor(t[k], device=dev).to(dt)
        self.request, self.mean = f("request"), f("mean_usage")
        self.std, self.peak, self.rho = f("std_usage"), f("peak_usage"), \
            f("ar_rho")
        self.innov = torch.sqrt(torch.clamp(1 - self.rho * self.rho, min=0))
        self.ar = torch.zeros_like(self.rho)
        self.est_kind = c["estimator"]
        self.window, self.q = c.get("estimator_window"), c.get("estimator_q")
        self.ring = None
        self.qos_ok = torch.zeros(len(self.rho), dtype=torch.int64,
                                  device=dev)

    def slot(self, s, st: Study, active, seg):
        """Demand, allocation, QoS and the estimate of slot ``s``."""
        c = st.cluster
        white = st.noise[s].to(self.dev).to(self.dt)
        self.ar = self.rho * self.ar + self.innov * white
        demand = torch.minimum(
            torch.clamp(self.std * self.ar[:, None] + self.mean, min=0),
            self.peak) * c["demand_scale"]
        demand = torch.clamp(demand, max=1.0)
        alloc, usage = allocate(demand, self.request, seg, active, self.n,
                                c["wfs_iters"])
        ok = (alloc + QOS_EPS >= torch.minimum(demand,
                                               self.request)).all(dim=-1)
        ok = ok & active
        self.qos_ok += ok.to(torch.int64)
        n_act = int(active.sum())
        qos = float(ok.sum()) / n_act if n_act else 1.0
        self.usage = usage
        self.est = self._estimate(s, usage)
        return qos

    def _estimate(self, s, usage):
        if self.est_kind == "current":
            return usage
        if self.est_kind == "quantile":
            # the q-quantile of the last ``window`` samples; the first
            # sample fills the whole window
            w, q = self.window, self.q
            if self.ring is None:
                self.ring = usage.expand((w,) + tuple(usage.shape)).clone()
            else:
                self.ring[s % w] = usage
            ordered = torch.sort(self.ring, dim=0).values
            pos = q * (w - 1)
            lo = int(np.floor(pos))
            frac = pos - lo
            return ordered[lo] + frac * (ordered[lo + 1] - ordered[lo])
        raise ValueError(f"no reference for estimator {self.est_kind!r}")

    def start_queue(self, active, seg, n_tasks, src_count):
        self.reserved = torch.zeros((self.n, R), dtype=self.dt,
                                    device=self.dev)
        self.requested = _seg_sum(self.request * active[:, None].to(self.dt),
                                  seg, self.n)
        self.n_tasks = n_tasks.clone()
        self.src_count = src_count.clone()

    def scores(self, ids, src, choice, p, cap, prm):
        """Load, feasibility and score of every node for each decision of
        a chunk, on the state the chunk's earlier (forced) decisions left;
        commits the chunk."""
        dt, n = self.dt, self.n
        c = len(ids)
        r = self.request[ids]                                  # (C, R)
        placed = choice >= 0
        node = torch.clamp(choice, min=0)
        one = torch.zeros((c, n), dtype=torch.int64, device=self.dev)
        one[torch.arange(c, device=self.dev), node] = placed.to(torch.int64)
        inc = torch.cumsum(one[:, :, None].to(dt) * r[:, None, :], dim=0)
        before = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
        reserved = self.reserved[None] + before                # (C, N, R)
        cnt = torch.cumsum(one, dim=0) - one
        n_tasks = self.n_tasks[None] + cnt
        same_src = (src[None, :] == src[:, None]) & torch.tril(
            torch.ones((c, c), dtype=torch.bool, device=self.dev), -1)
        same = self.src_count[:, src].T + (
            same_src.to(torch.float64) @ one.to(torch.float64)).to(
            torch.int64)
        share = same.to(dt) / torch.clamp(n_tasks, min=1).to(dt)
        load = p * self.est[None] + reserved
        over = (load + r[:, None, :] - cap).max(dim=-1).values  # (C, N)
        inner = prm["w_load"] * load.max(dim=-1).values \
            + prm["w_src"] * share
        # commit the chunk
        self.reserved = self.reserved + inc[-1]
        self.requested = self.requested + inc[-1]
        self.n_tasks = self.n_tasks + one.sum(dim=0)
        self.src_count = self.src_count.index_put(
            (node[placed], src[placed]),
            torch.ones(int(placed.sum()), dtype=torch.int64,
                       device=self.dev), accumulate=True)
        return over, -inner

    def decide(self, over, score):
        """This precision's own decision at each position: the best
        feasible node, or -1."""
        masked = torch.where(over <= 0, score, torch.full_like(score, NEG))
        best = masked.argmax(dim=-1)
        return torch.where((over <= 0).any(dim=-1), best,
                           torch.full_like(best, -1))


def _gaps(over, score, choice):
    """Each decision's gap, judged by the judge's (over, score).

    A node within ``BAND`` of its cap may go either way: rounding decides
    its filter (a fused multiply-add one ulp over the cap where the judge
    lands on it), so it is neither owed to a task nor held against one.
    A placed task's gap is how far its node's score lies below the best
    score of the nodes clearly inside their caps, or how far its node is
    over the cap beyond the band; a refused task's gap is the slack of
    the node it fits best, where that exceeds the band.
    """
    clear = over < -BAND
    best = torch.where(clear, score, torch.full_like(score, NEG)).max(
        dim=-1).values.double()
    node = torch.clamp(choice, min=0)[:, None]
    chosen_score = score.gather(1, node)[:, 0].double()
    chosen_over = over.gather(1, node)[:, 0].double()
    zero = torch.zeros_like(chosen_score)
    placed = choice >= 0
    score_gap = torch.where(placed & clear.any(dim=-1),
                            torch.clamp(best - chosen_score, min=0), zero)
    excess = torch.where(placed & (chosen_over > BAND), chosen_over, zero)
    slack = -over.min(dim=-1).values.double()
    missed = torch.where(~placed & (slack > BAND), slack, zero)
    return torch.maximum(torch.maximum(score_gap, excess), missed)


def _queue(states, st, ids, choice, p, cap, prm, gaps, dev, where):
    """Judge a queue (task ids in order, the program's choices) on every
    state; returns the controls' own admit flags, one array each (the
    judge's place holds none).  ``where`` names the queue in the record
    of the worst decision."""
    own = [[] for _ in states]
    srcs = torch.as_tensor(st.trace["src"], device=dev).to(torch.int64)
    for k0 in range(0, len(ids), CHUNK):
        idx = torch.as_tensor(ids[k0:k0 + CHUNK], device=dev)
        ch = torch.as_tensor(choice[k0:k0 + CHUNK], device=dev)
        outs = [s.scores(idx, srcs[idx], ch, p, cap, prm) for s in states]
        judge_over, judge_score = outs[0]
        g = _gaps(judge_over, judge_score, ch)
        i = int(g.argmax())
        if float(g[i]) > max(gaps["program"]):
            gaps["worst"] = _record(where, k0 + i, int(idx[i]), int(ch[i]),
                                    judge_over[i], judge_score[i], g[i])
        gaps["program"].append(float(g[i]))
        for i, (s, (over, score)) in enumerate(zip(states, outs)):
            if i > 0:
                mine = s.decide(over, score)
                own[i].append((mine >= 0).cpu().numpy())
                gaps["control"].append(float(_gaps(judge_over, judge_score,
                                                   mine).max()))
    return [np.concatenate(o) if o else np.zeros(0, bool) for o in own]


def _record(where, pos, task, choice, over, score, gap) -> dict:
    """What the judge saw at one decision."""
    clear = over < -BAND
    best = int(torch.where(clear, score, torch.full_like(score, NEG))
               .argmax())
    node = max(choice, 0)
    return dict(where=where, position=pos, task=task, choice=choice,
                gap=float(gap), best=best if bool(clear.any()) else -1,
                best_score=float(score[best]), best_over=float(over[best]),
                chosen_score=float(score[node]),
                chosen_over=float(over[node]),
                least_over=float(over.min()))


class _Book:
    """The queue bookkeeping of one precision: retries, attempts, the
    reclaim pool and the cumulative counts."""

    def __init__(self, n_tasks):
        self.retry = np.zeros(0, np.int64)
        self.pool = np.zeros(0, np.int64)
        self.attempts = np.zeros(n_tasks, np.int64)
        self.rejected = 0
        self.reclaimed = 0


def _after_queue(book, queue, placed, c):
    """Retries, drops and the pool after the primary queue; returns the
    pool the reclaim pass admits (empty without reclamation)."""
    failed = queue[~placed]
    book.attempts[failed] += 1
    keep = book.attempts[failed] <= c["max_retries"]
    eligible, exhausted = failed[keep], failed[~keep]
    qr = c["retry_capacity"]
    book.retry = eligible[:qr]
    overflow = eligible[qr:]
    if not c["reclamation"]:
        book.rejected += len(exhausted) + len(overflow)
        return book.pool
    # dropped tasks join the pool in queue order
    dropped = np.isin(queue, np.concatenate([exhausted, overflow]))
    merged = np.concatenate([book.pool, queue[dropped]])
    book.pool = merged[:c["reclaim_pool"]]
    book.rejected += len(merged) - len(book.pool)
    return book.pool


def check(st: Study, out: Outputs, device="cpu", control: bool = False):
    """Judge one run of the program (``out``) on ``st``.

    Returns ``(numbers, work)``: ``numbers`` holds the program's
    readings (and, with ``control``, the bfloat16 control's under
    ``"control"``); ``work`` the length of every primary queue and
    reclaim pass, which the roofline metrics count.
    """
    dev = torch.device(device)
    c, prm = st.cluster, st.params
    n, n_slots = c["n_nodes"], c["n_slots"]
    t = st.trace
    T = len(t["arrival"])
    rows = arrival_rows(t["arrival"], n_slots, c["arrivals_per_slot"])
    place = np.asarray(out.placement, np.int64)
    admit = np.asarray(out.admit_slot, np.int64)
    dur = np.asarray(t["duration"], np.int64)
    dts = [torch.float32] + ([torch.bfloat16] if control else [])
    states = [_State(st, dt, dev) for dt in dts]
    books = [_Book(T) for _ in dts]
    judge_book = books[0]
    gaps = {"program": [0.0], "control": [0.0], "worst": None}
    series = {"program": [0.0], "control": [0.0]}
    counts = {"program": 0, "control": 0}
    seen = np.zeros(T, bool)     # placements some queue accounted for
    work = {"queues": [], "reclaim": [], "worst": None}
    src = torch.as_tensor(t["src"], device=dev).to(torch.int64)
    placed_t = torch.as_tensor(place, device=dev)
    admit_t = torch.as_tensor(admit, device=dev)
    dur_t = torch.as_tensor(dur, device=dev)
    active_cnt = torch.zeros(T, dtype=torch.int64, device=dev)
    p_prev, q_prev = prm["p_init"], 1.0

    for s in range(n_slots):
        active = (placed_t >= 0) & (admit_t < s) & (s <= admit_t + dur_t)
        active_cnt += active.to(torch.int64)
        seg = torch.where(active, placed_t, torch.zeros_like(placed_t))
        act_i = active.to(torch.int64)
        n_tasks = _seg_sum(act_i, seg, n)
        src_count = _seg_sum(act_i, seg * SRC_BUCKETS + src,
                             n * SRC_BUCKETS).view(n, SRC_BUCKETS)
        qos = [stt.slot(s, st, active, seg) for stt in states]

        # the controller's step from the program's own QoS and penalty
        p_ref = penalty_step(p_prev, q_prev, float(out.qos[s]), prm)
        p_ctl = float(torch.tensor(p_ref, dtype=torch.bfloat16))
        p = float(out.penalty[s])
        p_prev, q_prev = p, float(out.qos[s])

        for stt in states:
            stt.start_queue(active, seg, n_tasks, src_count)
        queue = np.concatenate([judge_book.retry, rows[s]]).astype(np.int64)
        choice = np.where(admit[queue] == s, place[queue], -1)
        seen[queue[choice >= 0]] = True
        work["queues"].append(len(queue))
        own = _queue(states, st, queue, choice, p, 1.0, prm, gaps, dev,
                     f"slot {s} primary")
        placed = choice >= 0
        pools = [_after_queue(b, queue, placed if i == 0 else own[i], c)
                 for i, b in enumerate(books)]
        if c["reclamation"]:
            pool = pools[0]
            # forced along the program: the judge's pool is the trajectory
            for b in books[1:]:
                b.pool = pool
            r_choice = np.where(admit[pool] == s, place[pool], -1)
            seen[pool[r_choice >= 0]] = True
            work["reclaim"].append(len(pool))
            cap = max(1.0 - c["reclaim_margin"] * p, 0.0)
            r_own = _queue(states, st, pool, r_choice, p, cap, prm, gaps,
                           dev, f"slot {s} reclaim")
            for i, b in enumerate(books):
                ok = (r_choice >= 0) if i == 0 else r_own[i]
                b.reclaimed += int(ok.sum())
                b.pool = pool[r_choice < 0]
        # every precision starts the next slot from the program's path
        for b in books[1:]:
            b.retry, b.attempts = judge_book.retry, judge_book.attempts.copy()
        ref_counts = (int(active.sum()), judge_book.rejected,
                      judge_book.reclaimed)
        prog_counts = (int(out.n_running[s]), int(out.n_rejected[s]),
                       int(out.n_reclaimed[s]))
        counts["program"] += sum(a != b for a, b in zip(ref_counts,
                                                        prog_counts))
        for b in books[1:]:
            counts["control"] += int(b.rejected != judge_book.rejected) \
                + int(b.reclaimed != judge_book.reclaimed)
            b.rejected, b.reclaimed = judge_book.rejected, \
                judge_book.reclaimed

        figs = [_figures(stt) for stt in states]
        prog = np.concatenate([[out.qos[s], out.penalty[s]], out.usage[s],
                               out.requested[s], out.est_usage[s],
                               out.usage_std[s]]).astype(np.float64)
        judge = np.concatenate([[qos[0], p_ref], figs[0]])
        series["program"].append(float(np.abs(judge - prog).max()))
        if control:
            ctl = np.concatenate([[qos[1], p_ctl], figs[1]])
            series["control"].append(float(np.abs(judge - ctl).max()))

    # structural: every placement accounted for, in range
    bad = ((place >= 0) != (admit >= 0)) | ((place >= 0) & ~seen) \
        | (place >= n) | (admit >= n_slots)
    counts["program"] += int(bad.sum())
    counts["program"] += int((active_cnt.cpu().numpy()
                              != np.asarray(out.active_slots)).sum())
    qos_ok = [stt.qos_ok.cpu().numpy() for stt in states]
    numbers = {
        "decision_gap": max(gaps["program"]),
        "series_gap": max(series["program"]),
        "count_mismatch": counts["program"],
        "qos_ok_mismatch": int((qos_ok[0]
                                != np.asarray(out.qos_ok_slots)).sum()),
    }
    if control:
        numbers["control"] = {
            "decision_gap": max(gaps["control"]),
            "series_gap": max(series["control"]),
            "count_mismatch": counts["control"],
            "qos_ok_mismatch": int((qos_ok[0] != qos_ok[1]).sum()),
        }
    work["worst"] = gaps["worst"]
    return numbers, work


def _figures(stt: _State) -> np.ndarray:
    """Mean usage, requests held, estimate and usage spread over nodes."""
    f = lambda x: x.double().mean(dim=0)
    usage = f(stt.usage)
    held = f(stt.requested + stt.reserved)
    spread = torch.sqrt(((stt.usage.double() - usage) ** 2).mean(dim=0))
    return torch.cat([usage, held, f(stt.est), spread]).cpu().numpy()

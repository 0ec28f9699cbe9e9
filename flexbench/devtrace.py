"""What the benchmark reads from a ``torch.profiler`` trace.

The profiler records the host's operators and the device's activity
(kernels, copies, fills) on one clock.  From its raw events this module
takes the device intervals, their union (the device's busy time), the
device operations that took the most time, and the longest stretches in
which the device was idle, each named by what the host was doing then.
The raw events are summed directly: ``key_averages`` builds a call tree
over every event first, which takes minutes on a study's trace.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

# Longest name kept in a breakdown entry.
NAME_CHARS = 120


class Event(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


def events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) of a finished ``torch.profiler``
    profile, each sorted by start."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = Event(e.name(), int(e.start_ns()), int(e.duration_ns()))
        (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
    dev.sort(key=lambda e: e.start_ns)
    host.sort(key=lambda e: e.start_ns)
    return dev, host


def merged(dev: List[Event]) -> List[Tuple[int, int]]:
    """The union of the device intervals, as disjoint (start, end) pairs
    in order."""
    out: List[Tuple[int, int]] = []
    for e in dev:
        s, t = e.start_ns, e.start_ns + e.dur_ns
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def busy_ns(dev: List[Event]) -> int:
    """Nanoseconds in which some operation ran on the device."""
    return sum(t - s for s, t in merged(dev))


def is_kernel(e: Event) -> bool:
    """A kernel launch, not a copy or a fill."""
    return not e.name.startswith(("Memcpy", "Memset"))


def top_ops(dev: List[Event], k: int = 10) -> list:
    """[name, seconds] of the ``k`` device operations that took the most
    time, summed over their calls."""
    totals = {}
    for e in dev:
        totals[e.name] = totals.get(e.name, 0) + e.dur_ns
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:NAME_CHARS], ns / 1e9] for name, ns in ranked]


def idle_gaps(dev: List[Event], host: List[Event], k: int = 10) -> list:
    """[label, seconds] of the ``k`` longest stretches with nothing on the
    device, from the first host event to the last event; each labelled by
    the host operation that overlaps it the most."""
    spans = merged(dev)
    if not host and not spans:
        return []
    first = min([e.start_ns for e in host] + [s for s, _ in spans])
    last = max([e.start_ns + e.dur_ns for e in host] + [t for _, t in spans])
    gaps, at = [], first
    for s, t in spans:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if last > at:
        gaps.append((at, last))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, t in gaps[:k]:
        overlap = lambda e: min(t, e.start_ns + e.dur_ns) - max(s, e.start_ns)
        busiest = max(host, key=overlap, default=None)
        label = (busiest.name if busiest is not None and overlap(busiest) > 0
                 else "host: no operator")
        out.append([label[:NAME_CHARS], (t - s) / 1e9])
    return out

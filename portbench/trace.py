"""The traced run's reading of ``torch.profiler``: device activity
intervals, the benchmark's own spans around the calls into the engine and
the model, the device's busy time and the breakdown of the device's time
and of its idle gaps."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]               # ns

BATCH_SPAN = "portbench.batch"
PREFILL_SPAN = "portbench.prefill"
DECODE_SPAN = "portbench.decode_step"
SHORT_GAP_NS = 10_000                    # gaps below this are pooled
LOOKBACK = 64                            # host events searched a gap


@dataclass
class Kernel:
    start: int
    end: int
    name: str


@dataclass
class Trace:
    kernels: List[Kernel]                         # device activity, sorted
    host: List[Tuple[int, int, str]]              # host events, by start
    batches: List[dict] = field(default_factory=list)
    start: int = 0
    end: int = 0

    def kernels_in(self, lo: int, hi: int) -> List[Kernel]:
        return [k for k in self.kernels if lo <= k.start and k.end <= hi]


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def _is_annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    if f is not None:
        return bool(f())
    f = getattr(e, "activity_type", None)
    return f is not None and "annotation" in str(f())


def from_profiler(prof) -> Trace:
    """Device activity (kernels, copies, sets) and host operators and
    ranges of a finished ``torch.profiler.profile``.  The ranges the
    profiler projects onto the device's timeline are not device activity;
    the CUDA runtime's calls are left out of the host's."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    # a range projected onto the device's timeline bears its host name
    ranges = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
    kernels, host = [], []
    for e in events:
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not _is_annotation(e) and name not in ranges:
                kernels.append(Kernel(start, end, name))
        elif not name.startswith("cu"):
            host.append((start, end, name))
    kernels.sort(key=lambda k: k.start)
    host.sort()
    t = Trace(kernels, host)
    spans = [h for h in host if h[2] == BATCH_SPAN]
    decode = [h for h in host if h[2] == DECODE_SPAN]
    for lo, hi, _ in spans:
        steps = [d for d in decode if lo <= d[0] <= hi]
        t.batches.append({"start": lo, "end": hi,
                          "decode": (steps[0][0], hi) if steps else None})
    if spans:
        t.start, t.end = spans[0][0], spans[-1][1]
    return t


def union(kernels: Sequence[Kernel]) -> List[Interval]:
    out: List[List[int]] = []
    for k in kernels:
        if out and k.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], k.end)
        else:
            out.append([k.start, k.end])
    return [(a, b) for a, b in out]


def busy_ns(merged: Sequence[Interval], lo: int, hi: int) -> int:
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in merged
               if b > lo and a < hi)


def gaps(merged: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    out, at = [], lo
    for a, b in merged:
        if b <= lo or a >= hi:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def _host_at(host_starts: List[int], host, t: int) -> str:
    """The innermost host event open at ``t`` (the latest started one that
    has not ended), searched among the last ``LOOKBACK`` started."""
    i = bisect.bisect_right(host_starts, t) - 1
    for j in range(i, max(-1, i - LOOKBACK), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "host, between operators"


def breakdown(t: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle gaps of the
    traced window summed by what the host was doing (gaps under 10 us
    pooled), each as [name, seconds]."""
    by_op: Dict[str, int] = defaultdict(int)
    for k in t.kernels:
        if t.start <= k.start and k.end <= t.end:
            by_op[k.name[:120]] += k.end - k.start
    merged = union(t.kernels)
    starts = [h[0] for h in t.host]
    by_host: Dict[str, int] = defaultdict(int)
    for a, b in gaps(merged, t.start, t.end):
        if b - a < SHORT_GAP_NS:
            by_host["short gaps (< 10 us)"] += b - a
        else:
            by_host[_host_at(starts, t.host, (a + b) // 2)] += b - a
    pick = lambda d: [[n, v / 1e9] for n, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": pick(by_op), "idle_gaps": pick(by_host)}

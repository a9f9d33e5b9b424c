"""Interval arithmetic over the program's own spans and ranges, for the
readers of ``metrics/``: the host ranges of one name in a profiled trace
(``torch.profiler`` ranges the port opens, ``obs.tracing``), and how
much of a set of intervals (the device's idle gaps) they cover.  Gaps
are placed by containment in the ranges, however long before the
gap a range opened (``trace.py``'s breakdown looks back 64 host events)."""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]               # ns
Host = Sequence[Tuple[int, int, str]]    # (start, end, name), ns


def named(host: Host, name: str, lo: Optional[int] = None,
          hi: Optional[int] = None) -> List[Interval]:
    """The host ranges called ``name`` that overlap [lo, hi] (one that
    opened before ``lo`` included: the engine opens ``model.decode_step``
    just before the harness's ``decode_step`` range, which starts a
    batch's decode phase)."""
    return [(s, e) for s, e, n in host if n == name
            and (lo is None or e > lo) and (hi is None or s < hi)]


def covered_ns(intervals: Sequence[Interval],
               cover: Sequence[Interval]) -> int:
    """The length of ``intervals`` (disjoint) that ``cover`` covers.
    ``cover`` is disjoint and in order, as the ranges of one name that
    ``named`` gives: the engine closes each span before it opens the
    next."""
    total = j = 0
    for a, b in sorted(intervals):
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total


def by_innermost(intervals: Sequence[Interval], host: Host,
                 names: Sequence[str]) -> Dict[str, int]:
    """The length of ``intervals`` (disjoint) under each of ``names``, put
    down to the innermost range of those names that contains it (the
    latest opened); what none contains goes under ``"outside"``."""
    keep = set(names)
    ranges = sorted((s, e, n) for s, e, n in host if n in keep)
    gaps = sorted(intervals)
    cuts = sorted({t for s, e, _ in ranges for t in (s, e)}
                  | {t for a, b in gaps for t in (a, b)})
    out: Dict[str, int] = {}
    heap: list = []                      # (-start, end, name) of open ranges
    i = g = 0
    for lo, hi in zip(cuts, cuts[1:]):
        while i < len(ranges) and ranges[i][0] <= lo:
            s, e, n = ranges[i]
            heapq.heappush(heap, (-s, e, n))
            i += 1
        while heap and heap[0][1] <= lo:
            heapq.heappop(heap)
        while g < len(gaps) and gaps[g][1] <= lo:
            g += 1
        if g < len(gaps) and gaps[g][0] <= lo:
            key = heap[0][2] if heap else "outside"
            out[key] = out.get(key, 0) + hi - lo
    return out

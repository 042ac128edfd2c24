"""The traced part of a window, read from ``torch.profiler``'s records: every
operation that ran on the device (kernels, copies, sets) and the harness's
own host annotations (``bench.*``).

The window runs from the start of the first annotated request to the end of
the last; the device is busy on the union of its operations' intervals
inside it. Idle gaps are named by the innermost host annotation that covers
their middle. The device's busy time inside the requests' own ranges is
kept apart, for an idle share that leaves out the time between requests.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

REQUEST = "bench.request"


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{what}_us")() * 1000)


@dataclass
class Trace:
    window_s: float
    busy_s: float
    requests: int  # annotated requests inside the window
    kernels: Dict[str, float]  # device op name -> seconds inside the window
    gaps: Dict[str, float] = field(default_factory=dict)  # host annotation -> idle seconds
    request_s: float = 0.0  # the requests' ranges, summed
    request_busy_s: float = 0.0  # the device busy inside them

    def seconds_of(self, *needles: str) -> float:
        return sum(s for name, s in self.kernels.items() if any(n in name for n in needles))

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


def read(prof) -> Trace:
    """A stopped ``torch.profiler.profile`` -> Trace."""
    from torch.autograd import DeviceType

    device, host, host_names = [], [], set()
    events = prof.profiler.kineto_results.events()
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            host_names.add(e.name())
    for e in events:
        start, end = _ns(e, "start"), _ns(e, "end")
        if e.device_type() == DeviceType.CUDA:
            # a host range shows on the device's timeline too, under its own name: not an operation
            if e.name() not in host_names:
                device.append((start, end, e.name()))
        elif e.name().startswith("bench."):
            host.append((start, end, e.name()))
    reqs = [(s, t) for s, t, n in host if n == REQUEST]
    if not reqs or not device:
        raise RuntimeError(f"the trace holds {len(reqs)} requests and {len(device)} device operations")
    w0, w1 = min(s for s, _ in reqs), max(t for _, t in reqs)
    kernels: Dict[str, float] = defaultdict(float)
    spans: List[Tuple[int, int]] = []
    for s, t, name in device:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            kernels[name] += (t - s) * 1e-9
            spans.append((s, t))
    spans.sort()
    busy, gaps_at, merged = 0, [], []
    cur_s = cur_t = None
    edge = w0
    for s, t in spans:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                merged.append((cur_s, cur_t))
            if s > edge:
                gaps_at.append((edge, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
        edge = max(edge, cur_t)
    if cur_t is not None:
        busy += cur_t - cur_s
        merged.append((cur_s, cur_t))
    if w1 > edge:
        gaps_at.append((edge, w1))
    gaps: Dict[str, float] = defaultdict(float)
    for s, t in gaps_at:
        mid = (s + t) // 2
        covering = [(hs, ht, n) for hs, ht, n in host if hs <= mid <= ht]
        label = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "outside bench annotations"
        gaps[label] += (t - s) * 1e-9
    inside = sum(1 for s, t in reqs if s >= w0 and t <= w1)
    req_busy, j = 0, 0
    for s, t in sorted(reqs):  # requests do not overlap; nor do the merged busy intervals
        while j < len(merged) and merged[j][1] <= s:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < t:
            req_busy += min(t, merged[k][1]) - max(s, merged[k][0])
            k += 1
    return Trace((w1 - w0) * 1e-9, busy * 1e-9, inside, dict(kernels), dict(gaps),
                 sum(t - s for s, t in reqs) * 1e-9, req_busy * 1e-9)

"""The reduction of a profile to busy time, idle gaps and the busy time
inside the requests' own ranges, on a made-up timeline."""

import pytest
from torch.autograd import DeviceType

from bench_port.harness import trace as tracing


class _Event:
    def __init__(self, name, start, end, on_device):
        self._n, self._s, self._e, self._d = name, start, end, on_device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda _: events})()})()


def test_busy_inside_requests_leaves_the_waits_out():
    ms = 1_000_000
    events = [
        _Event(tracing.REQUEST, 0, 4 * ms, False), _Event("bench.wait", 4 * ms, 10 * ms, False),
        _Event(tracing.REQUEST, 10 * ms, 14 * ms, False),
        _Event("conv", 1 * ms, 3 * ms, True), _Event("gemm", 2 * ms, 3 * ms, True),  # overlapping: 2 ms busy
        _Event("conv", 11 * ms, 14 * ms, True),
    ]
    t = tracing.read(_Prof(events))
    assert t.window_s == pytest.approx(14e-3) and t.busy_s == pytest.approx(5e-3)
    assert t.request_s == pytest.approx(8e-3) and t.request_busy_s == pytest.approx(5e-3)
    assert t.requests == 2
    assert t.gaps["bench.wait"] == pytest.approx(8e-3)  # from the end of the first's work to the second's
    assert t.gaps[tracing.REQUEST] == pytest.approx(1e-3)
    assert t.seconds_of("conv") == pytest.approx(5e-3)

"""Share of the traced frames' own request time in which no operation ran
on the device, in percent: 1 - the device's busy time inside the frames'
request ranges (from handing a frame in to its detections on the host)
over the sum of those ranges, both from the same trace. The open loop's
waits between frames are left out, so the share does not follow the
offered load: it is the host's and the replay's part of a frame's service.
A faster device raises it, as it raises every idle share; `request_ms.camera`
shows the service time itself."""


def read(run):
    if run.trace is None or run.trace.request_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.request_busy_s / run.trace.request_s)

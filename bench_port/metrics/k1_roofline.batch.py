"""K1's share of its roofline, in percent: the least time of a traced
request's K1 work (the yardstick's count on the request's own shapes) over
K1's device time per traced request (its kernels inside the replays)."""

K1 = ("cgm_kernel", "cgm_slice_kernel")


def read(run):
    if run.trace is None or getattr(run, "k1_s", None) is None or not run.trace.requests:
        return None
    seconds = run.trace.seconds_of(*K1) / run.trace.requests
    return 100.0 * run.k1_s / seconds if seconds > 0 else None

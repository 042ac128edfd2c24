"""K2's share of its roofline, in percent: the least time of a traced
request's NMS work (the yardstick's count on the valid boxes of each call,
as the reference's decode and ROI stage give them for the same frames)
over K2's device time per traced request (its kernels inside the replays)."""

K2 = ("nms_rank_kernel", "nms_mask_kernel", "nms_sweep_kernel", "nms_sweep_wide_kernel")


def read(run):
    if run.trace is None or getattr(run, "k2_s", None) is None or not run.trace.requests:
        return None
    seconds = run.trace.seconds_of(*K2) / run.trace.requests
    return 100.0 * run.k2_s / seconds if seconds > 0 else None

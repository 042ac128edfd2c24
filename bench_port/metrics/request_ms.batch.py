"""Median host time of one batch request, from handing its frames to the
entry point to its detections on the host, over the window's untraced
requests."""

import statistics


def read(run):
    if run.kind != "closed_batches":
        return None
    return statistics.median((r.done - r.send) * 1e3 for r in run.requests if not r.traced)

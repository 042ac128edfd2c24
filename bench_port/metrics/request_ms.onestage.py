"""Median host time of one request of the one-stage CenterNet, from
handing its frames to the entry point to its detections on the host, over
the window's untraced requests."""

import statistics


def read(run):
    untraced = [(r.done - r.send) * 1e3 for r in run.requests if not r.traced]
    return statistics.median(untraced) if untraced else None

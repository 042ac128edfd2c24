"""Median host time of one camera frame's request, from handing the frame
to the entry point to its detections on the host, with no schedule wait,
over the window's untraced frames."""

import statistics


def read(run):
    if run.kind != "camera_stream":
        return None
    return statistics.median((r.done - r.send) * 1e3 for r in run.requests if not r.traced)

"""The whole request's share of the card's peak, in percent: the model's
FLOPs per image (counted on the reference) times the traced window's images
per second, over the dense tensor-core peak of the configuration's stated
precision."""


def read(run):
    if run.trace is None or not getattr(run, "flops_per_image", None) or run.trace.window_s <= 0:
        return None
    images = sum(r.images for r in run.requests if r.traced)
    return 100.0 * run.flops_per_image * images / run.trace.window_s / run.peak_flops

"""The deformable blocks' share of their roofline, in percent: the least
time of a request's deformable blocks (``counts/dcn.py`` on each offset
conv's and deformable conv's own shapes, as the reference records them for
the same frames) over the median device time of the program's `decoder`
stage (``stage_ms.decoder.onestage``), which holds all 16 blocks and the
upsampling and adds between them. A program without the stage gives no
sample, and the reader None."""

from bench_port.harness import spans


def read(run):
    ms = spans.median_ms("decoder")
    if getattr(run, "dcn_s", None) is None or not ms:
        return None
    return 100.0 * run.dcn_s / (ms * 1e-3)

"""Median device time of the `decoder` stage inside one request's replay of
the one-stage CenterNet, in ms, over the traced requests: the program's
stamps of the card's clock, captured into the CUDA graph, at the stage's end
and at the last stamp before it (the previous stage's end, or the body's
start). A program without the stage gives no sample, and the reader None.

Read under the profiler: the program's spans are on only while a profiler
records, so these are the traced requests, and the time carries what CUPTI
adds inside the replay; compare a stage between two commits' traced runs,
not with untraced time."""

from bench_port.harness import spans


def read(run):
    return spans.median_ms("decoder")

"""The port's stage spans (``utils.profiling``): ``stage`` ranges, stamps of
the card's clock captured into a pinned function's CUDA graph, their
harvest into the registry, and ``PinnedFn``'s counters.

On the CPU the model is a stub (nothing here builds a detector), and the
card's clock is a fake whose stamps the test sets. The tests marked
``card`` build the small-budget finetune_vovnet on the card and skip
elsewhere; run them there with
``python -m pytest --noconftest tests/test_torch_spans.py`` (the suite's
conftest imports JAX, which the card's machine does not have)."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.overrides import TorchFunctionMode

from faster_orefsdet_tpu_torch.config import get_config
from faster_orefsdet_tpu_torch.pipelines import graphs
from faster_orefsdet_tpu_torch.pipelines import inference as tinf
from faster_orefsdet_tpu_torch.pipelines.support_cache import SupportCache
from faster_orefsdet_tpu_torch.structures.instances import Detections
from faster_orefsdet_tpu_torch.utils import profiling

import torch_budget  # noqa: F401 (the suite's torch thread budget)

QUERY_STAGES = {"features", "correlate", "proposal_head", "decode_proposals", "roi_stage", "roi_inference"}
K = 6  # proposals a row in the stub


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


class FakeClock:
    """A clock whose stamps (ns) and completion the test sets."""

    def __init__(self, slots=8):
        self.slots, self.ns, self.done = slots, [0] * slots, True

    def mark(self, index):
        pass

    def publish(self, n):
        pass

    def ended(self):
        return self.done

    def read(self):
        return self.ns


class StubModel:
    """What the query path calls of a detector, on tiny tensors."""

    levels = ("p3", "p4", "p5")

    def __init__(self, cfg):
        self.cfg = cfg

    def parameters(self):
        yield torch.zeros(1)

    def features(self, images):
        return {lv: images[:, :2, :4, :4] * 1.0 for lv in self.levels}

    def correlate(self, feats, kernels, per_class=False):
        return feats

    def proposal_head(self, pos):
        return [pos["p3"]], [pos["p3"]]

    def roi_stage(self, feats, boxes, support_8, support_4, stage):
        return SimpleNamespace(deltas=torch.zeros_like(boxes), scores=torch.zeros(*boxes.shape[:2], 2))


def _proposals(agn_hms, bbox_regs, cfg, canvas_hw, image_hw, nms_budget=None):
    rows = image_hw.shape[0]
    boxes = torch.tensor([0.0, 0.0, 8.0, 8.0]) + torch.arange(K, dtype=torch.float32)[:, None]
    return SimpleNamespace(boxes=boxes.expand(rows, K, 4).clone(), valid=torch.ones(rows, K, dtype=torch.bool),
                           scores=torch.ones(rows, K))


def _detections(stage_outputs, boxes, valid, image_hw, cfg, proposal_scores=None):
    return Detections(boxes, proposal_scores, torch.zeros(valid.shape, dtype=torch.int32), valid)


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setattr(tinf, "make_detector", lambda cfg, params, device: StubModel(cfg))
    monkeypatch.setattr(tinf, "cache_kernels", lambda model, cache: {})
    monkeypatch.setattr(tinf, "decode_proposals", _proposals)
    monkeypatch.setattr(tinf, "roi_inference", _detections)
    cfg = get_config("finetune_vovnet")
    return cfg.replace(input=dataclasses.replace(cfg.input, min_size_test=24, max_size_test=32))


def _cache(classes=0):
    shape = (lambda s: (classes, s, s, 2)) if classes else (lambda s: (s, s, 2))
    return SupportCache(*(torch.zeros(shape(s)) for s in (4, 2, 1, 7, 4)))


def _recording():
    """A torch profiler of the host alone: the autograd profiler without
    Kineto, whose first start here costs milliseconds where Kineto's costs
    seconds; ``stage`` sees both as a profiler that records."""
    return torch.autograd.profiler.profile(use_kineto=False)


def _profiled_names(fn):
    with _recording() as prof:
        fn()
    return {e.name for e in prof.function_events}


def test_stage_opens_its_range_only_under_a_profiler():
    assert profiling.stage("features") is profiling.host_range("x") is profiling._NULL
    with _recording() as prof:
        with profiling.stage("features"):
            torch.ones(2) * 2
        with profiling.host_range("pack_detections"):
            pass
    names = [e.name for e in prof.function_events]
    assert "features" in names and "pack_detections" in names


@pytest.mark.parametrize("path", ["raw_frames", "multiclass"])
def test_cpu_profile_names_the_stages(stubbed, path):
    """The eager profile of the pinned raw-frame body shows the six query
    stages and `preprocess`; the multiclass path the six."""
    if path == "raw_frames":
        fn, _ = tinf.build_pinned_serving_fn(stubbed, {}, _cache(), (30, 40), device="cpu")
        frames = torch.randint(0, 255, (2, 3, 30, 40), dtype=torch.uint8)
        names = _profiled_names(lambda: tinf.pack_detections(fn(frames)))
        assert names >= QUERY_STAGES | {"preprocess", "pack_detections"}
    else:
        images = torch.zeros(1, 3, 32, 32)
        names = _profiled_names(lambda: tinf.query_path_multiclass(StubModel(stubbed), _cache(classes=3), images,
                                                                    torch.tensor([[32.0, 30.0]]), kernels={}))
        assert names >= QUERY_STAGES and "preprocess" not in names


class OpLog(TorchFunctionMode):
    """The torch operations a block calls (a torch function mode: a dispatch
    mode's first use here imports torch._dynamo, two seconds)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not str(func).startswith("profiler."):  # a profiler range is an op of the `profiler` namespace
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _body(x):
    with profiling.stage("features"):
        y = x * 2
    with profiling.stage("roi_stage"):
        return y.sum()


@pytest.mark.parametrize("mode", ["off", "profiler", "capturing"])
def test_stage_adds_no_aten_op(mode):
    """A body's ops are the same whether its stages are off, profiler ranges
    or stamps in a capture, so the pinned bodies stay capture-safe."""
    x = torch.ones(3)
    with OpLog() as plain:
        (x * 2).sum()
    spans = profiling.GraphSpans("cuda:0", "f32[3]", FakeClock())
    with OpLog() as staged:
        if mode == "profiler":
            with _recording():
                _body(x)
        elif mode == "capturing":
            with spans.capturing():
                _body(x)
        else:
            _body(x)
    assert staged.ops == plain.ops
    if mode == "capturing":
        assert [m[0] for m in spans.marks] == ["replay", "features", "roi_stage"]
        assert spans.used == 4 and profiling.stage("x") is profiling._NULL


def _captured():
    """A GraphSpans as a capture of _body leaves it, its slots (the body's
    start, each stage's end, the body's end) stamped at 0, 2, 7 and 10 ms:
    replay 10, features 2, roi_stage 5."""
    spans = profiling.GraphSpans("cuda:0", "f32[3]", FakeClock())
    with spans.capturing():
        _body(torch.ones(3))
    assert spans.marks == [("replay", 0, 3), ("features", 0, 1), ("roi_stage", 1, 2)]
    spans.clock.ns[:4] = [0, 2_000_000, 7_000_000, 10_000_000]
    return spans


def test_harvest_records_ended_replays_and_counts_missed_ones():
    spans = _captured()
    spans.collect(overwrite=True)  # nothing pending
    spans.launched(7)
    spans.collect(overwrite=True)
    assert profiling.stage_samples() == [
        {"device": "cuda:0", "signature": "f32[3]", "call": 7, "ms": {"replay": 10.0, "features": 2.0, "roi_stage": 5.0}}]
    spans.clock.done = False  # the replay of call 8 has not ended
    spans.launched(8)
    assert len(profiling.stage_samples()) == 1 and spans.pending == 8  # stays pending: no wait, no miss
    spans.collect(overwrite=True)  # the next replay would overwrite it
    assert profiling.span_counters() == {"samples": 1, "missed": 1} and spans.pending is None
    spans.clock.done = True
    spans.launched(9)
    assert [s["call"] for s in profiling.stage_samples()] == [7, 9]  # read when asked, once it has ended
    profiling.reset_spans()
    assert profiling.stage_samples() == [] and profiling.span_counters() == {"samples": 0, "missed": 0}


def test_registry_is_bounded():
    spans = _captured()
    n = profiling.MAX_SAMPLES + 3
    for call in range(n):
        spans.launched(call)
        spans.collect(overwrite=True)
    samples = profiling.stage_samples()
    assert len(samples) == profiling.MAX_SAMPLES and samples[0]["call"] == 3
    assert profiling.span_counters()["samples"] == n


def test_a_capture_refuses_more_stages_than_its_slots():
    spans = profiling.GraphSpans("cuda:0", "f32[3]", FakeClock(slots=3))
    with pytest.raises(RuntimeError, match="more than 1 stages"):
        with spans.capturing():
            _body(torch.ones(3))
    assert profiling.stage("x") is profiling._NULL


def test_stages_do_not_nest_in_a_capture():
    spans = profiling.GraphSpans("cuda:0", "f32[3]", FakeClock())
    with pytest.raises(RuntimeError, match="do not nest"):
        with spans.capturing():
            with profiling.stage("roi_stage"):
                _body(torch.ones(3))
    assert profiling.stage("x") is profiling._NULL and not spans.in_stage


def test_registry_counts_every_replay_of_many_threads():
    """Threads (more than cores) each open spans() and harvest their own
    graph's replays: no count is lost and every block closes."""
    import sys
    import threading

    n_threads, n_calls = 16, 50

    def worker():
        spans = _captured()
        for call in range(n_calls):
            with profiling.spans():
                spans.launched(call)
                spans.collect(overwrite=True)
                profiling.stage_samples()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert profiling.span_counters() == {"samples": n_threads * n_calls, "missed": 0}
    assert not profiling.spans_forced()


def test_spans_block_turns_spans_on():
    assert not profiling.spans_forced()
    with profiling.spans():
        with profiling.spans():
            assert profiling.spans_forced()
        assert profiling.spans_forced()
    assert not profiling.spans_forced()


def test_pinned_counters_on_the_cpu_path():
    fn = graphs.PinnedFn(lambda x: x * 2, "cpu")
    assert torch.equal(fn(torch.ones(2)), torch.full((2,), 2.0))
    fn(torch.ones(3))
    assert (fn.calls, fn.captures, fn.evictions, len(fn.graphs)) == (2, 0, 0, 0)


def test_pinned_graph_lookup_counts_captures_and_evictions(monkeypatch):
    """The lookup a card call makes, with a fake capture: the least recently
    used graph goes past MAX_GRAPHS, its ended replay harvested; a found
    graph's last replay is harvested before its inputs are copied in."""
    fn = graphs.PinnedFn(lambda x: x, "cpu")
    monkeypatch.setattr(fn, "_capture", lambda key, inputs: graphs._Graph(
        None, None, tuple(torch.zeros_like(x) for x in inputs), None, None, {"cgm": 0, "nms": 0}, _captured()))
    keys = [((n,), torch.float32) for n in range(1, graphs.MAX_GRAPHS + 2)]
    first = fn._graph(keys[0], (torch.ones(1),), host=False, timed=False)
    first.spans.launched(1)
    for key in keys[1:]:
        fn._graph(key, (torch.ones(key[0]),), host=False, timed=False)
    assert (fn.captures, fn.evictions, len(fn.graphs)) == (graphs.MAX_GRAPHS + 1, 1, graphs.MAX_GRAPHS)
    assert keys[0] not in fn.graphs and [s["call"] for s in profiling.stage_samples()] == [1]
    g = fn.graphs[keys[1]]
    g.spans.launched(2)
    assert fn._graph(keys[1], (torch.full((2,), 5.0),), host=False, timed=True) is g
    assert torch.equal(g.inputs[0], torch.full((2,), 5.0)) and g.spans.pending is None
    assert [s["call"] for s in profiling.stage_samples()] == [1, 2] and next(reversed(fn.graphs)) == keys[1]


def test_an_untimed_replay_leaves_a_pending_replay_pending(monkeypatch):
    """The graph that serves does not touch its twin's stamps: a pending
    timed replay that has not ended stays pending through untimed calls,
    and counts as missed only when the twin would replay again."""
    fn = graphs.PinnedFn(lambda x: x, "cpu")
    monkeypatch.setattr(fn, "_capture", lambda key, inputs: graphs._Graph(
        None, None, tuple(torch.zeros_like(x) for x in inputs), None, None, {"cgm": 0, "nms": 0}, _captured()))
    key = ((1,), torch.float32)
    g = fn._graph(key, (torch.ones(1),), host=False, timed=True)
    g.spans.clock.done = False
    g.spans.launched(1)
    fn._graph(key, (torch.ones(1),), host=False, timed=False)
    assert g.spans.pending == 1 and profiling.span_counters() == {"samples": 0, "missed": 0}
    fn._graph(key, (torch.ones(1),), host=False, timed=True)
    assert g.spans.pending is None and profiling.span_counters() == {"samples": 0, "missed": 1}


def test_signature_names_shapes_and_dtypes():
    assert graphs._signature((((8, 3, 480, 640), torch.uint8),)) == "uint8[8, 3, 480, 640]"


# ---- on the card


def _small_serving(device):
    """The small-budget finetune_vovnet's pinned raw-frame function on the
    card (120x160 frames), and frames near the pixel mean."""
    from faster_orefsdet_tpu_torch.utils.params import init_params

    cfg = get_config("finetune_vovnet")
    cfg = cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=128, post_nms_topk_test=32),
        roi=dataclasses.replace(cfg.roi, detections_per_image=24),
        input=dataclasses.replace(cfg.input, min_size_test=96, max_size_test=160))
    g = np.random.default_rng(0)
    cache = SupportCache(*(torch.from_numpy((0.5 * g.standard_normal((s, s, 128))).astype(np.float32)).to(device)
                           for s in (32, 16, 8, 8, 4)))
    fn, _ = tinf.build_pinned_serving_fn(cfg, init_params(cfg, seed=1), cache, (120, 160), device=device)
    mean = np.asarray(cfg.input.pixel_mean, np.float32)
    u8 = np.clip(np.rint(mean + 8.0 * g.standard_normal((2, 120, 160, 3))), 0, 255).astype(np.uint8)
    return fn, torch.from_numpy(u8).permute(0, 3, 1, 2).contiguous().pin_memory()


@pytest.mark.card
def test_stages_tile_the_replay(card):
    fn, frames = _small_serving(card)
    fn(frames)
    with profiling.spans():
        for _ in range(5):
            tinf.pack_detections(fn(frames)).cpu()  # read back: each replay has ended before the next
    torch.cuda.synchronize()
    samples = profiling.stage_samples()
    assert len(samples) == 5 and profiling.span_counters()["missed"] == 0
    for s in samples:
        ms = s["ms"]
        assert set(ms) == QUERY_STAGES | {"replay", "preprocess"}
        staged = sum(v for k, v in ms.items() if k != "replay")
        assert 0.97 * ms["replay"] <= staged <= ms["replay"], ms


@pytest.mark.card
def test_served_outputs_equal_with_spans_on_and_off(card):
    fn, frames = _small_serving(card)
    # each answer read back, as a server does: each replay has ended before the next
    off = tinf.pack_detections(fn(frames)).cpu()
    with profiling.spans():
        on = tinf.pack_detections(fn(frames)).cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = tinf.pack_detections(fn(frames)).cpu()
    again = tinf.pack_detections(fn(frames)).cpu()
    assert torch.equal(off, on) and torch.equal(off, traced) and torch.equal(off, again)
    assert len(profiling.stage_samples()) == 2 and profiling.span_counters() == {"samples": 2, "missed": 0}
    assert (fn.calls, fn.captures, fn.evictions) == (4, 1, 0)

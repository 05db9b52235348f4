"""The port's tracer (``utils/trace.py``): off it records nothing and opens no
profiler range; on it keeps the span tree, units, self times, spans that
ended in an exception, a bounded buffer and each thread's own nesting; under
torch.profiler it records in the active cycle only, as ``gc.*`` ranges
around the ops they hold; and the edit loop, the render and the trainer
produce the spans and counters of the benchmark's layers. CPU only: the
device spans' CUDA events are read on the card."""

import threading

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu_torch.cameras import look_at, make_camera
from gaussctrl_exp_tpu_torch.diffusion.attention import BasicTransformerBlock
from gaussctrl_exp_tpu_torch.diffusion.pipeline import EditConfig, GaussCtrlEditPipeline
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import init_random_models
from gaussctrl_exp_tpu_torch.engine.trainer import TrainConfig, Trainer
from gaussctrl_exp_tpu_torch.models.densify import DensifyConfig
from gaussctrl_exp_tpu_torch.models.gaussians import init_random
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model
from gaussctrl_exp_tpu_torch.utils import trace
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 32  # image size
VIEWS = 4


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset(trace.CAPACITY)
    yield
    trace.disable()
    trace.reset(trace.CAPACITY)


class Views:
    """Cameras on an arc, their images, and a write-back buffer: what the
    edit loop and the trainer read of a datamanager."""

    def __init__(self, n=VIEWS):
        self.n, self.width, self.height = n, S, S
        self.images = [np.full((S, S, 3), 0.5, np.float32) for _ in range(n)]
        self.written = []
        self._k = 0

    def __len__(self):
        return self.n

    def camera(self, i):
        ang = 0.3 * i
        eye = np.array([4 * np.sin(ang), -4 * np.cos(ang), 1.0])
        return make_camera(look_at(eye, np.zeros(3)), 35.0, 35.0, S / 2, S / 2, S, S, device="cpu")

    def write_back(self, i, img):
        self.written.append(i)
        self.images[i] = img

    def next_train(self):
        self._k += 1
        return (self._k - 1) % self.n, self.images[(self._k - 1) % self.n]

    def image(self, i):
        return self.images[i]

    def eval_indices(self):
        return list(range(self.n))


def _tokenize(texts, max_len=77):
    ids = np.zeros((len(texts), max_len), np.int64)
    for i, t in enumerate(texts):
        toks = [49406] + [len(w) * 97 % 49000 for w in t.split()][: max_len - 2] + [49407]
        ids[i, : len(toks)] = toks
    return ids


def _gaussians():
    return init_random(64, capacity=64, sh_degree=1, seed=0, device="cpu")


def _tree(spans):
    """{id: span} and the names of each span's direct children, in the order they ended."""
    by_id = {s.id: s for s in spans}
    kids: dict = {s.id: [] for s in spans}
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s.name)
    return by_id, kids


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: calls.append(a) or real(*a, **k))
    assert not trace.recording()
    assert trace.span("a") is trace.span("b", unit=3, sync=True)  # one shared no-op context
    with trace.span("a", unit=1):
        with trace.span("b"):
            trace.count("c")
    with torch.no_grad():
        render_model(_gaussians(), Views().camera(0), 30_000, SplatModelConfig(sh_degree=1))
    assert trace.records() == [] and trace.counters() == {} and calls == []


def test_on_records_the_tree_units_self_time_and_exceptions():
    trace.enable()
    with trace.span("outer", unit=7):
        with trace.span("inner", unit=0, sync=True):
            sum(range(20_000))
        with trace.span("inner", unit=1, sync=True):
            sum(range(20_000))
        trace.count("things", 2)
        trace.count("things")
    with pytest.raises(KeyError):
        with trace.span("outer", unit=8):
            raise KeyError("the window ends here")
    spans = trace.records()
    assert [s.name for s in spans] == ["inner", "inner", "outer", "outer"]
    inner0, inner1, outer, failed = spans
    assert inner0.parent == inner1.parent == outer.id and outer.parent is None and failed.parent is None
    assert [inner0.unit, inner1.unit, outer.unit, failed.unit] == [0, 1, 7, 8]
    assert inner0.sync and not outer.sync and failed.error and not outer.error
    assert outer.start_ns <= inner0.start_ns <= inner0.end_ns <= inner1.start_ns <= inner1.end_ns <= outer.end_ns
    assert trace.counters() == {"things": 3}
    s = trace.summary()
    # the failed span is counted apart and left out of the means
    assert s["outer"]["count"] == 1 and s["outer"]["errors"] == 1
    assert s["outer"]["host_ms_mean"] == pytest.approx(outer.host_ms)
    assert s["outer"]["self_ms_mean"] == pytest.approx(outer.host_ms - inner0.host_ms - inner1.host_ms)
    assert s["inner"]["count"] == 2 and s["inner"]["host_ms_p95"] == max(inner0.host_ms, inner1.host_ms)
    assert s["inner"]["device_ms_mean"] is None and inner0.device_ms is None  # no CUDA device


def test_buffer_keeps_the_newest_and_counts_the_dropped(tmp_path):
    trace.reset(capacity=5)
    trace.enable()
    for i in range(12):
        with trace.span("s", unit=i):
            pass
    assert [s.unit for s in trace.records()] == list(range(7, 12)) and trace.dropped() == 7
    trace.dump(tmp_path / "spans.jsonl")
    import json

    lines = [json.loads(x) for x in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert [x["unit"] for x in lines] == list(range(7, 12)) and set(lines[0]) >= {"name", "parent", "host_ms"}
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_threads_nest_their_own_spans():
    trace.enable()
    barrier = threading.Barrier(2)

    def work(tag):
        for i in range(50):
            with trace.span(f"{tag}.outer", unit=i):
                barrier.wait(timeout=30)
                with trace.span(f"{tag}.inner", unit=i):
                    trace.count("n")

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    by_id, _ = _tree(trace.records())
    inner = [s for s in by_id.values() if s.name.endswith(".inner")]
    assert len(inner) == 100 and trace.counters() == {"n": 100}
    for s in inner:
        parent = by_id[s.parent]
        assert parent.name == s.name.replace("inner", "outer") and parent.unit == s.unit
        assert parent.thread == s.thread


def test_profiler_active_cycle_only_and_gc_ranges_around_the_ops():
    from torch.profiler import ProfilerActivity, profile, schedule

    def work(tag):
        with trace.span(tag):
            torch.ones(64).add_(1.0)

    # as benchmark/trace.py's profile: a warm-up cycle, then the active one to the end
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        work("warm")  # the warm-up cycle: the tracer stays off
        assert not trace.recording()
        prof.step()
        assert trace.recording()
        work("active")
    assert not trace.recording()
    assert [s.name for s in trace.records()] == ["active"]
    events = prof.events()
    ranges = [e for e in events if e.name.startswith(trace.PREFIX)]
    assert [e.name for e in ranges] == ["gc.active"]
    rng = ranges[0].time_range
    inside = [e for e in events if e.name == "aten::add_" and rng.start <= e.time_range.start <= rng.end]
    assert inside


def test_profiler_alone_records_no_device_events():
    from torch.profiler import ProfilerActivity, profile

    # the profiler times the device itself: a device span under it is only
    # a range (no CUDA call is made, so this runs without a card)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("dev", device=torch.device("cuda")):
            torch.ones(8).add_(1.0)
    (s,) = trace.records()
    assert s.name == "dev" and s.events is None and s.device_ms is None


def test_device_ops_leave_out_the_tracers_range_marks():
    from types import SimpleNamespace

    from gaussctrl_exp_tpu_torch.utils.timing import WINDOW, device_ops

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, device=cuda, mark=False):
        return SimpleNamespace(name=name, device_type=device, is_user_annotation=mark)

    kernel, copy = ev("blend_fwd_kernel"), ev("Memcpy DtoH (Device -> Pageable)")
    events = [kernel, copy, ev("aten::add_", cpu), ev(trace.PREFIX + "render.frame", cpu),
              ev(trace.PREFIX + "render.frame", mark=True), ev(trace.PREFIX + "sd.eps"),  # a mark either way
              ev("user_range", mark=True), ev(WINDOW), ev("ProfilerStep#1")]
    assert device_ops(events) == [kernel, copy]


def test_render_model_spans_and_frames():
    trace.enable()
    with torch.no_grad():
        for i in range(2):
            render_model(_gaussians(), Views().camera(i), 30_000, SplatModelConfig(sh_degree=1))
    spans = trace.records()
    by_id, kids = _tree(spans)
    frames = [s for s in spans if s.name == "render.frame"]
    assert len(frames) == 2 and trace.counters() == {"render.frames": 2}
    for f in frames:
        assert kids[f.id] == ["render.sh", "render.project", "render.bin", "render.blend"]
        (binned,) = [s for s in spans if s.name == "render.bin" and s.parent == f.id]
        assert kids[binned.id] == ["render.bin.sync"]
    assert all(s.sync == (s.name == "render.bin.sync") for s in spans)


def test_edit_loop_spans_and_counters():
    models = init_random_models(1, "cpu", **TINY)
    cfg = EditConfig(edit_prompt="a bear statue", reverse_prompt="a bear", num_inference_steps=2, chunk_size=2,
                     latent_size=S // 8)
    pipe = GaussCtrlEditPipeline(cfg, models=models, tokenizer=_tokenize, device="cpu")
    dm = Views()
    trace.enable()
    pipe.render_reverse(_gaussians(), dm, SplatModelConfig(sh_degree=1))
    pipe.edit_images(dm)
    spans = trace.records()
    by_id, kids = _tree(spans)
    views = [s for s in spans if s.name == "invert.view"]
    assert [s.unit for s in views] == list(range(VIEWS))
    for v in views:
        assert kids[v.id] == ["render.frame", "invert.to_host", "sd.encode", "sd.invert", "invert.z0_to_host"]
    (inv,) = [s for s in spans if s.name == "sd.invert" and s.parent == views[0].id]
    assert kids[inv.id] == ["sd.eps"] * 2
    chunks = [s for s in spans if s.name == "edit.chunk"]
    assert [s.unit for s in chunks] == [0, 1]
    for c in chunks:
        assert kids[c.id] == ["edit.prepare", "sd.generate", "sd.decode", "edit.to_host", "edit.write_back"]
    eps = [s for s in spans if s.name == "sd.eps"]
    assert len(eps) == 2 * VIEWS + 2 * 2 and all(kids[e.id] == ["sd.controlnet", "sd.unet"] for e in eps)
    texts = [s for s in spans if s.name == "sd.text"]
    assert len(texts) == 3 and all(s.parent is None for s in texts)  # the reverse, edit and negative prompts
    assert {s.name for s in spans if s.sync} == {"invert.to_host", "invert.z0_to_host", "edit.to_host",
                                                 "render.bin.sync"}
    # CPU calls: no CUDA graph, and AttnAlign's self-attentions (one a transformer block in each of the
    # generation's 2 chunks × 2 steps) composed of five calls
    blocks = sum(isinstance(m, BasicTransformerBlock) for net in (models.unet, models.controlnet)
                 for m in net.modules())
    assert trace.counters() == {"invert.views": VIEWS, "edit.chunks": 2, "render.frames": VIEWS,
                                "sd.eps.eager": 2 * VIEWS + 2 * 2, "attn.align.split": 2 * 2 * blocks}
    assert sorted(dm.written) == list(range(VIEWS))


def test_a_chunk_that_ends_the_window_is_an_error_span_after_its_count():
    """A datamanager hook that raises (the benchmark ends its window so)
    leaves the chunk counted and its span marked as ended in an exception."""

    class Stop(Exception):
        pass

    class Ending(Views):
        def write_back(self, i, img):
            super().write_back(i, img)
            if i == 1:
                raise Stop

    models = init_random_models(1, "cpu", **TINY)
    cfg = EditConfig(num_inference_steps=1, chunk_size=2, latent_size=S // 8)
    pipe = GaussCtrlEditPipeline(cfg, models=models, tokenizer=_tokenize, device="cpu")
    pipe.z0 = {i: np.zeros((S // 8, S // 8, 4), np.float32) for i in range(VIEWS)}
    pipe.disparity = {i: np.ones((S, S, 3), np.float32) for i in range(VIEWS)}
    trace.enable()
    with pytest.raises(Stop):
        pipe.edit_images(Ending())
    (chunk,) = [s for s in trace.records() if s.name == "edit.chunk"]
    assert chunk.error and trace.counters()["edit.chunks"] == 1
    assert trace.summary()["edit.chunk"] == dict(count=0, errors=1, host_ms_mean=None, host_ms_p95=None,
                                                 self_ms_mean=None, device_ms_mean=None)


def test_trainer_spans():
    dm = Views(2)
    cfg = TrainConfig(use_lpips=False, model=SplatModelConfig(sh_degree=1),
                      densify=DensifyConfig(warmup_length=1, refine_every=2, reset_alpha_every=4))
    trainer = Trainer(_gaussians(), dm, cfg)
    trace.enable()
    trainer.train(6, log_every=3)
    spans = trace.records()
    by_id, kids = _tree(spans)
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.unit for s in steps] == list(range(6))
    stages = ["train.render", "train.loss", "train.backward", "train.optimizer", "train.stats"]
    # step 2 (unit 1) resets the opacities, step 6 (unit 5) refines: in-cycle position 6 > 2 views + 2
    for s in steps:
        extra = {1: ["train.reset_opacity"], 5: ["train.refine"]}.get(s.unit, [])
        assert kids[s.id] == stages + extra, s.unit
    logs = [s for s in spans if s.name == "train.log"]
    assert [s.unit for s in logs] == [1, 3, 6] and all(s.sync and s.parent is None for s in logs)
    assert trace.counters() == {"render.frames": 6}

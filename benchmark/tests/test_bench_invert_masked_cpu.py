"""The cell ``edit.invert_masked`` at tiny widths on the CPU, the harness's
look for a card skipped: a sound program is correct; the program broken
underneath the timed path is not (SAM's relative-position bias dropped, its
windows transposed, another view's mask kept, no box on every other view);
the bf16 control (SAM and CLIP computed in bf16 in the program's place)
reads at least three times what the program does; and the cell's readers of
the inversion step read what ``edit.invert``'s do."""

from __future__ import annotations

import contextlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, program_trace
from benchmark.counts import sam as sam_counts
from benchmark.runners import edit_invert_masked

from .test_bench_cells_cpu import SEED, tiny_sd, tiny_splat


def tiny_seg() -> dict:
    """The configuration at tiny widths: SAM's 10 × 10 grid in windows of 4
    (padded to 12) and one global block; CLIP's 8 × 8 patch grid."""
    c = json.loads((harness.BENCH / "configs" / "langsam-sam-vit-h.json").read_text())
    c["sam"].update(img_size=80, patch_size=8, encoder_dim=32, encoder_depth=2, encoder_heads=2,
                    encoder_global_attn=[1], window_size=4, prompt_dim=32, decoder_mlp_dim=256)
    c["clip"]["vision"].update(hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                               image_size=56, patch_size=7)
    c["clip"]["text"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2)
    c["clip"]["projection_dim"] = 24
    return c


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cell(seconds: float = 1.0, controls=(), keep=None):
    tr = dict(json.loads((harness.BENCH / "traffic" / "invert_masked.json").read_text()), num_inference_steps=2)
    cell = harness.Cell("edit.invert_masked", {}, tiny_seg(), tr, [], [])
    ctx = dict(cell=cell, seed=SEED, device=torch.device("cpu"), spans=None)
    mod = edit_invert_masked
    with contextlib.redirect_stdout(None), pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "load_json", lambda kind, name: tiny_sd() if name == tr["edit_config"] else tiny_splat())
        st = mod.setup(ctx)
        res = mod.window(st, seconds)
        mod.release(st)
        checks = mod.check(st)
        got = mod.readings(st, controls) if controls else None
    if keep is not None:
        keep.update(st)
    return res, checks, got


def test_sound_program_is_correct():
    st: dict = {}
    res, checks, _ = run_cell(keep=st)
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert harness.judge(checks), checks
    # SAM ran on every view, so the sampled views compare its logits
    assert all(len(k["boxes"]) for k in st["kept_seg"].values())
    assert {n for n, _, _ in checks} == set(st["tr"]["limits"])


def test_bf16_control_reads_three_times_the_program():
    _, _, got = run_cell(controls=("bf16", "tf32"))
    assert any(got["bf16"][k] >= 3 * got["program"][k] for k in got["program"]), got
    # TF32 exists on the card alone: here the control is the float32 reference itself
    assert got["tf32"] == dict.fromkeys(got["program"], 0.0)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def _faults():
    """(fault name, a context that breaks the program underneath the timed path)."""
    from gaussctrl_exp_tpu_torch.segmentation import grounding, lang_sam, sam

    def patched(obj, attr, make):
        @contextlib.contextmanager
        def ctx():
            orig = getattr(obj, attr)
            setattr(obj, attr, make(orig))
            try:
                yield
            finally:
                setattr(obj, attr, orig)

        return ctx

    def no_rel_pos(orig):  # the decomposed relative-position bias left out
        return lambda table, q_size, k_size: torch.zeros_like(orig(table, q_size, k_size))

    def transposed_windows(orig):  # each window's tokens attended with rows and columns swapped
        def f(self, x):
            if x.shape[0] == 1:  # the global block's one grid
                return orig(self, x)
            return orig(self, x.transpose(1, 2)).transpose(1, 2)
        return f

    def stale_mask(orig):  # each view handed the previous view's mask
        def as_mask_provider(self):
            provide, last = orig(self), []

            def f(rgb, text):
                last.append(provide(rgb, text))
                return last[-2] if len(last) > 1 else last[-1]
            return f
        return as_mask_provider

    def no_box_every_other(orig):  # the grounding finds nothing on every other view, so SAM is skipped there
        calls = []

        def f(self, image, text):
            calls.append(None)
            boxes, phrases, scores = orig(self, image, text)
            if len(calls) % 2 == 0:
                return np.zeros((0, 4), np.float32), [], np.zeros(0, np.float32)
            return boxes, phrases, scores
        return f

    return [
        ("relative-position bias dropped", patched(sam, "_rel_pos_bias", no_rel_pos)),
        ("windows transposed", patched(sam.ViTAttention, "forward", transposed_windows)),
        ("another view's mask kept", patched(lang_sam.LangSAM, "as_mask_provider", stale_mask)),
        ("no box on every other view", patched(grounding.ClipPatchBoxProvider, "__call__", no_box_every_other)),
    ]


@pytest.mark.parametrize("index", range(4), ids=[f[0] for f in _faults()])
def test_a_broken_program_is_not_correct(index):
    _, fault = _faults()[index]
    with fault():
        _, checks, _ = run_cell()
    assert not harness.judge(checks), checks


@pytest.mark.parametrize("counters", [
    {"sd.eps.graph_replay": 40, "seg.images": 2},
    {"sd.eps.graph_replay": 30, "sd.eps.eager": 10, "sd.eps.graph_capture": 1},
    {"seg.images": 2},  # a program that counts neither
])
def test_inversion_step_readers_read_as_edit_invert(monkeypatch, counters):
    buffer = SimpleNamespace(records=lambda: [], counters=lambda: dict(counters))
    monkeypatch.setattr(program_trace, "_tracer", lambda: buffer)
    spans = SimpleNamespace(ms=lambda name: [14.0, 16.0] if name == "unet_step" else [])
    run = dict(profile=dict(launches={}), spans=spans, counts=None, window=None, state=None)
    for metric in ("eps_graph_share", "unet_step_ms"):
        want = harness.metric_reader(f"{metric}.invert").read(run)
        assert harness.metric_reader(f"{metric}.invert_masked").read(run) == want
    assert harness.metric_reader("unet_step_ms.invert_masked").read(run) == 15.0


def test_sam_h_encode_count_and_floor():
    """The counter's operations of SAM-H's encode against a count by hand:
    28 windowed blocks whose projections run on the 4,900 tokens of the
    padded grid (25 windows of 196) and whose MLPs on the 4,096, 4 global
    blocks, the patch embedding and the neck; its floor at 3×TF32."""
    cfg = json.loads((harness.BENCH / "configs" / "langsam-sam-vit-h.json").read_text())["sam"]
    d, hd, heads, mlp, T, Tp = 1280, 80, 16, 5120, 4096, 4900
    windowed = (2 * Tp * d * 4 * d + 25 * heads * (4 * 196 * 196 * hd + 4 * 196 * 14 * hd)
                + 4 * T * d * mlp)
    glob = 2 * T * d * 4 * d + heads * (4 * T * T * hd + 4 * T * 64 * hd) + 4 * T * d * mlp
    ops = 28 * windowed + 4 * glob + 2 * T * d * (768 + 256) + 2 * T * 256 * 256 * 9
    assert sam_counts.encode_ops(cfg) == ops == 5_961_082_830_848
    assert sam_counts.encode_bound_s(cfg) == pytest.approx(ops / (494.7e12 / 3))

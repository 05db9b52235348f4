"""Each cell's unit of work and comparison at tiny widths on the CPU, the
harness's look for a card skipped: a sound program is correct; the program
broken underneath the timed path is not, once for each fault the cell can
have; and each control (the reference in a lower precision in the
program's place) reads at least three times what the program does.

The full-size readings that the limits come from are taken on the card
(``python3 -m benchmark.controls``, PERF.md); ``test_controls_on_card``
repeats them there at the cell's own size."""

from __future__ import annotations

import contextlib
import json

import pytest
import torch

from benchmark import harness
from benchmark.runners import edit_generate, edit_invert, splat_render, splat_train

SEED = 2**31 + 11  # past 32 signed bits, as the checks' seeds are


def _json(kind, name):
    return json.loads((harness.BENCH / kind / f"{name}.json").read_text())


def tiny_sd() -> dict:
    c = _json("configs", "sd15-cn-depth")
    c["unet"].update(block_out_channels=[32, 64], layers_per_block=1, attention_head_dim=2, cross_attention_dim=32,
                     sample_size=8)
    c["controlnet"]["conditioning_embedding_out_channels"] = [4, 4, 4, 8]
    c["vae"]["block_out_channels"] = [32, 32, 32, 32]
    c["text_encoder"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4)
    c["image_size"] = 64
    return c


def tiny_splat() -> dict:
    c = _json("configs", "splatfacto-bear")
    c.update(num_gaussians=3000, capacity=3000, image_size=64, focal=70.0, num_views=8)
    return c


CELLS = {
    "edit.generate": (edit_generate, tiny_sd, "generate", dict(views=10, num_inference_steps=2)),
    "edit.invert": (edit_invert, tiny_sd, "invert", dict(num_inference_steps=2)),
    # the kept window steps start one step into the window, at the first refine step
    "splat.train": (splat_train, lambda: dict(tiny_splat(), start_step=30095), "train", dict(judged_refines=1)),
    "splat.render": (splat_render, tiny_splat, "render", {}),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cell(name: str, seconds: float = 0.5, controls=(), keep=None):
    mod, config, traffic, over = CELLS[name]
    tr = dict(_json("traffic", traffic), **over)
    cell = harness.Cell(name, {}, config(), tr, [], [])
    ctx = dict(cell=cell, seed=SEED, device=torch.device("cpu"), spans=None)
    with contextlib.redirect_stdout(None), pytest.MonkeyPatch.context() as mp:
        mp.setattr(edit_invert, "load_json", lambda kind, name: tiny_splat())  # the inversion's scene, tiny
        st = mod.setup(ctx)
        res = mod.window(st, seconds)
        mod.release(st)
        checks = mod.check(st)
        got = mod.readings(st, controls) if controls else None
    if keep is not None:
        keep.update(st)
    return res, checks, got


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_program_is_correct(name):
    res, checks, _ = run_cell(name)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert harness.judge(checks), checks


def test_train_judges_steps_of_the_window():
    """The kept steps run inside the window and across the trainer's cull."""
    st: dict = {}
    _, checks, _ = run_cell("splat.train", seconds=5.0, keep=st)
    assert st["judged_in_window"] and harness.judge(checks), checks
    judged = st["judged"]
    assert [judged["step"] + k for k in range(3)] == [30099, 30100, 30101]
    assert {n for n, _, _ in checks} >= {"loss_gap.window", "grad_gap.window", "change_gap.window"}


@pytest.mark.parametrize("name,control", [("edit.generate", "fp8"), ("edit.invert", "fp8"),
                                          ("splat.train", "bf16"), ("splat.render", "bf16")])
def test_control_reads_three_times_the_program(name, control):
    _, _, got = run_cell(name, controls=(control,))
    assert any(got[control][k] >= 3 * got["program"][k] for k in got["program"]), got


def _faults():
    """(cell, fault name, a context that breaks the program underneath the timed path)."""
    from gaussctrl_exp_tpu_torch.diffusion import schedulers, sd_pipeline
    from gaussctrl_exp_tpu_torch.engine import optimizers
    from gaussctrl_exp_tpu_torch.ops import renderer, ssim

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

    def alter_images(orig):  # a view's image altered where it is produced
        def f(self, latents):
            out = orig(self, latents).clone()
            out[-1] = 1.0 - out[-1]
            return out
        return f

    def half_batch(orig):  # the CFG batch's conditional half left out
        def f(self, latents, ctx_cond, ctx_uncond, hint, *a, **k):
            return orig(self, latents, ctx_uncond, ctx_uncond, hint, *a, **k)
        return f

    def frozen_step(orig):  # an inversion step that returns its state unchanged
        return lambda self, eps, t, sample: sample

    def alter_tile(orig):  # a frame's tile altered where it is produced
        def f(*a, **k):
            out = orig(*a, **k)
            out.img[:16, :16] = 1.0 - out.img[:16, :16]
            return out
        return f

    def no_update(orig):  # a training step that leaves its state unchanged
        return lambda self, closure=None: None

    def half_rows(orig):  # half of the frame's pixels left out of L1, the mean taken over the rest
        return lambda a, b: orig(a[: a.shape[0] // 2], b[: b.shape[0] // 2])

    return [
        ("edit.generate", "answer altered", patched(sd_pipeline.SDControlNetPipeline, "latent_to_image", alter_images)),
        ("edit.generate", "half the batch left out", patched(sd_pipeline.SDControlNetPipeline, "generate", half_batch)),
        ("edit.invert", "state unchanged", patched(schedulers.DDIMInverseScheduler, "step", frozen_step)),
        ("splat.render", "answer altered", patched(renderer, "rasterize_tiles", alter_tile)),
        ("splat.train", "state unchanged", patched(optimizers.ScheduledAdam, "step", no_update)),
        ("splat.train", "half the batch left out", patched(ssim, "l1", half_rows)),
    ]


@pytest.mark.parametrize("index", range(6))
def test_a_broken_program_is_not_correct(index):
    name, _, fault = _faults()[index]
    with fault():
        _, checks, _ = run_cell(name)
    assert not harness.judge(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name,config,traffic,control", [
    ("edit.generate", "sd15-cn-depth", "generate", "fp8"), ("splat.train", "splatfacto-bear", "train", "bf16"),
    ("edit.invert", "sd15-cn-depth", "invert", "fp8"), ("splat.render", "splatfacto-bear", "render", "bf16")])
def test_controls_on_card(name, config, traffic, control):
    """At the cell's own size on the card: the control fails a limit that the
    program meets. The cell is built from its files, so a cell kept out of
    BENCHMARK.json (splat.train, PERF.md) is checked too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = harness.Cell(name, {}, _json("configs", config), _json("traffic", traffic), [], [])
    mod = harness.runner(cell.traffic["runner"])
    ctx = dict(cell=cell, seed=SEED, device=torch.device("cuda", 0), spans=None)
    with contextlib.redirect_stdout(None):
        st = mod.setup(ctx)
        mod.window(st, 3.0)
        mod.release(st)
        got = mod.readings(st, (control,))
    limits = cell.traffic["limits"]
    assert all(got["program"][k] <= lim for k, lim in limits.items()), got
    assert any(got[control][k] > lim for k, lim in limits.items()), got

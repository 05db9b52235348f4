"""The cell ``mvgen.sample`` at tiny widths on the CPU, the harness's look
for a card skipped: the window, the check and the result's keys; a sound
program is correct; the program broken underneath the timed path is not (the
cross-view term skipped, a tap table shifted by one token, another call's
latents kept); the fault control (the reference with mix = 1, the cross-view
term left out) and the bf16 control read past a limit; and the traced
window's readers read what the program's spans hold."""

from __future__ import annotations

import contextlib
import json

import pytest
import torch

from benchmark import harness
from benchmark.runners import mvgen_sample

from .test_bench_cells_cpu import SEED, tiny_splat

# the tiny sampling's readings sit well below these (a few 1e-6 of ε, a
# few 1e-5 of the latents): they stand for the card's limits here
LIMITS = dict(lat_mean_abs=1e-3, lat_max_abs=1e-2, eps_max_rel=1e-4, taps_differ=0.0, pairs_differ=0.0)


def tiny_mvgen() -> dict:
    c = json.loads((harness.BENCH / "configs" / "mvgen-depth-sd15.json").read_text())
    c["unet"].update(block_out_channels=[32, 64], layers_per_block=1, attention_head_dim=2, cross_attention_dim=16,
                     sample_size=8)
    c["generator"].update(latent_size=8, num_steps=3)
    c["image_size"] = 64
    return c


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cell(seconds: float = 0.5, controls=(), keep=None, spans=None, broken=None):
    tr = dict(json.loads((harness.BENCH / "traffic" / "mvgen_sample.json").read_text()), limits=LIMITS,
              views=3, profile_steps=2)
    cell = harness.Cell("mvgen.sample", {}, tiny_mvgen(), tr, [], [])
    ctx = dict(cell=cell, seed=SEED, device=torch.device("cpu"), spans=spans)
    mod = mvgen_sample
    with contextlib.redirect_stdout(None), pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "load_json", lambda kind, name: tiny_splat())
        if broken is not None:
            broken(mp)
        st = mod.setup(ctx)
        res = mod.window(st, seconds)
        extra = {}
        if spans is not None:
            extra = mod.counts(st, None)
        mod.release(st)
        checks = mod.check(st)
        got = mod.readings(st, controls) if controls else None
    if keep is not None:
        keep.update(st, counts=extra)
    return res, checks, got


def test_window_check_and_result_keys():
    st: dict = {}
    res, checks, _ = run_cell(keep=st)
    assert res["attempted"] == 3 * len(st["calls"]) >= 3 and res["failed"] == 0
    assert set(res["metrics"]) == {"edit_views_per_s"} and res["metrics"]["edit_views_per_s"] > 0
    assert {n for n, _, _ in checks} == set(LIMITS)
    assert harness.judge(checks), checks
    rec = st["calls"][0]
    assert sorted(rec["eps"]) == st["check_steps"] and len(rec["tables"]) == 2  # grids 8² and 4²


def _skip_cross_view(mp):
    import gaussctrl_exp_tpu_torch.diffusion.mv_generator as mv

    make = mv.make_multires_epipolar_processor
    mp.setattr(mv, "make_multires_epipolar_processor", lambda tables, **k: make(tables, **dict(k, mix=1.0)))


def _shift_taps(mp):
    import gaussctrl_exp_tpu_torch.diffusion.mv_generator as mv

    build = mv.build_correspondence_tables

    def shifted(*a):
        idx, w = build(*a)
        return (idx + 1).clamp(max=idx.shape[2] - 1), w

    mp.setattr(mv, "build_correspondence_tables", shifted)


def _other_call(mp):
    keep = mvgen_sample._call

    def swapped(st, steps=None):
        rec = keep(st, steps)
        if steps is None and st["calls"]:
            rec["lat"] = st["calls"][-1]["lat"]
        return rec

    mp.setattr(mvgen_sample, "_call", swapped)


@pytest.mark.parametrize("broken", [_skip_cross_view, _shift_taps, _other_call],
                         ids=["cross_view_skipped", "taps_shifted", "other_call_latents"])
def test_broken_program_is_not_correct(broken):
    _, checks, _ = run_cell(seconds=0.5 if broken is not _other_call else 3.0, broken=broken)
    assert not harness.judge(checks), checks


def test_fault_and_bf16_controls_read_past_a_limit():
    _, _, got = run_cell(controls=("mix1", "bf16", "tf32"))
    for m in ("mix1", "bf16"):
        assert any(got[m][k] > LIMITS[k] for k in LIMITS), (m, got)
    # TF32 exists on the card alone: here the control is the float32 reference itself
    assert got["tf32"]["lat_max_abs"] == 0.0
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_traced_window_readers():
    st: dict = {}
    run_cell(spans=object(), keep=st)
    run = dict(state=st, counts=st["counts"], profile=None)
    got = {m: harness.metric_reader(f"{m}.mvgen_sample").read(run) for m in ("prepare_ms", "mfu")}
    # the CPU's device spans time nothing: only the host's and the counted readers read
    assert got["prepare_ms"] > 0 and st["counts"]["peak_s"] > 0
    for m in ("unet_step_ms", "epipolar_ms", "epipolar_roofline"):
        assert harness.metric_reader(f"{m}.mvgen_sample").read(run) is None

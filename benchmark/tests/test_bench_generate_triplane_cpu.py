"""The cell ``edit.generate_triplane`` at tiny widths on the CPU, the
harness's look for a card skipped: the window, the check and the result's
keys; a sound program is correct; the program broken underneath the timed
path is not (the triplane term skipped, the plane index shifted by one
cell); the fault control (the reference with mix = 1, the term left out)
and the fp8 control read past a limit; and the traced window's readers read
what the program's spans hold, and None without them."""

from __future__ import annotations

import contextlib
import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program_trace
from benchmark.runners import edit_generate_triplane as cell_mod

from .test_bench_cells_cpu import SEED, tiny_sd, tiny_splat

# The tiny stack computes in float32 here: in bf16 its rounding (~0.005,
# ~0.04, ~0.013) is as large as a plane index one cell off (~0.004, ~0.03,
# ~0.016), while in float32 it matches the reference to rounding. The term
# left out reads ~0.03, ~0.29, ~0.14, the fp8 control ~0.05, ~0.45, ~0.17.
# These limits stand for the card's
LIMITS = dict(img_mean_abs=1e-4, img_max_abs=1e-3, eps_max_rel=1e-3)
READERS = ("unet_step_ms", "triplane_ms", "triplane_roofline", "mfu")


def tiny_triplane() -> dict:
    c = dict(tiny_sd(), compute_dtype="float32")
    c["triplane"] = dict(json.loads((harness.BENCH / "configs" / "sd15-cn-depth-triplane.json").read_text())["triplane"],
                         plane_res=8)
    return c


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cell(seconds: float = 0.5, controls=(), keep=None, spans=None, broken=None):
    tr = dict(json.loads((harness.BENCH / "traffic" / "generate_triplane.json").read_text()), limits=LIMITS,
              num_inference_steps=2)
    cell = harness.Cell("edit.generate_triplane", {}, tiny_triplane(), tr, [], [])
    ctx = dict(cell=cell, seed=SEED, device=torch.device("cpu"), spans=spans)
    with contextlib.redirect_stdout(None), pytest.MonkeyPatch.context() as mp:
        mp.setattr(cell_mod, "load_json", lambda kind, name: tiny_splat())
        if broken is not None:
            broken(mp)
        st = cell_mod.setup(ctx)
        res = cell_mod.window(st, seconds)
        extra = cell_mod.counts(st, None) if spans is not None else {}
        cell_mod.release(st)
        checks = cell_mod.check(st)
        got = cell_mod.readings(st, controls) if controls else None
    if keep is not None:
        keep.update(st, counts=extra)
    return res, checks, got


def test_window_check_and_result_keys():
    st: dict = {}
    res, checks, _ = run_cell(keep=st)
    assert res["attempted"] >= 5 and res["failed"] == 0
    assert set(res["metrics"]) == {"edit_views_per_s"} and res["metrics"]["edit_views_per_s"] > 0
    assert {n for n, _, _ in checks} == set(LIMITS)
    assert harness.judge(checks), checks
    assert st["check_steps"] == [0, 1] and all(sorted(r["eps"]) == [0, 1] for r in st["recs"].values())
    assert st["depths"].shape == (8, 64, 64) and float(st["depths"].min()) > 0


def _skip_term(mp):
    import gaussctrl_exp_tpu_torch.diffusion.pipeline as pl

    make = pl.make_triplane_processor
    mp.setattr(pl, "make_triplane_processor", lambda pts, **k: make(pts, **dict(k, mix=1.0)))


def _shift_plane_index(mp):
    import gaussctrl_exp_tpu_torch.diffusion.triplane_attention as tri

    cell = tri.plane_cell

    def shifted(uv, res):  # every token pooled one cell along u
        return cell((uv + torch.tensor([1.0 / res, 0.0])).clamp(max=1.0 - 1e-6), res)

    mp.setattr(tri, "plane_cell", shifted)


@pytest.mark.parametrize("broken", [_skip_term, _shift_plane_index], ids=["term_skipped", "plane_index_shifted"])
def test_broken_program_is_not_correct(broken):
    _, checks, _ = run_cell(broken=broken)
    assert not harness.judge(checks), checks


def test_fault_and_fp8_controls_read_past_a_limit():
    _, _, got = run_cell(controls=("mix1", "shift1", "fp8"))
    for m in ("mix1", "shift1", "fp8"):
        assert any(got[m][k] > LIMITS[k] for k in LIMITS), (m, got)
    assert all(got["program"][k] <= LIMITS[k] for k in LIMITS), got


def test_traced_window_readers(monkeypatch):
    st: dict = {}
    run_cell(spans=object(), keep=st)
    run = dict(state=st, counts=st["counts"], profile=None)
    # the CPU's device spans time nothing: the span readers read None, the counted one reads
    assert st["span_readings"] == {}
    got = {m: harness.metric_reader(f"{m}.generate_triplane").read(run) for m in READERS}
    assert got["mfu"] > 0 and st["counts"]["triplane_layer_floor_s"] > 0
    assert all(got[m] is None for m in READERS if m != "mfu")

    # spans as a card's window holds them: 2 ε calls of 30 ms, 4 triplane terms of 5 ms
    def span(name, ms, error=False):
        return SimpleNamespace(name=name, device_ms=ms, error=error)

    spans = [span("sd.eps", 30.0), span("sd.eps", 30.0), span("sd.eps", 99.0, error=True)]
    spans += [span("attn.triplane", 5.0) for _ in range(4)] + [span("attn.triplane.planes", 2.0)]
    monkeypatch.setattr(program_trace, "window", lambda: (spans, {}))
    run["state"] = dict(st, span_readings=cell_mod._span_readings())
    got = {m: harness.metric_reader(f"{m}.generate_triplane").read(run) for m in READERS}
    assert got["unet_step_ms"] == 30.0 and got["triplane_ms"] == 10.0
    assert got["triplane_roofline"] == pytest.approx(100.0 * st["counts"]["triplane_layer_floor_s"] * 4 / 0.020)
    # a program without the tracer, or without the span, reads None
    monkeypatch.setattr(program_trace, "window", lambda: None)
    assert cell_mod._span_readings() == {}
    monkeypatch.setattr(program_trace, "window", lambda: (spans[:3], {}))
    run["state"] = dict(st, span_readings=cell_mod._span_readings())
    assert harness.metric_reader("triplane_ms.generate_triplane").read(run) is None
    assert harness.metric_reader("triplane_roofline.generate_triplane").read(run) is None
    assert harness.metric_reader("unet_step_ms.generate_triplane").read(run) == 30.0

"""The viewer's frame: ``render_model`` at the eval step under ``no_grad``,
the frame copied to the host and clipped, as the viewer's ``/render`` and
the render CLI make it; one caller, closed loop.

Frames follow a random walk over the scene's cameras drawn from the seed.
Each frame is timed on the host clock from the call to the frame on the
host; ``frame_ms_p95`` is the 95th percentile of every frame in the window.
The check renders frames drawn from the seed with the plain reference in
float32 and compares the program's frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..common import abs_gaps, check_from, check_sample, sub_seed, worst_gaps
from ..counts.splat import frame_ops
from ..reference import splat as ref
from ..reference.precision import tf32_off
from . import _splat


def path(n_views: int, length: int, seed: int) -> np.ndarray:
    """Camera indices of a random walk (a step of −1, 0 or +1 around the ring)."""
    rng = np.random.default_rng(sub_seed(seed, "path"))
    return (rng.integers(n_views) + np.cumsum(rng.integers(-1, 2, length))) % n_views


def setup(ctx: dict) -> dict:
    cfg, tr = ctx["cell"].config, ctx["cell"].traffic
    st = dict(ctx=ctx, tr=tr, step=cfg["start_step"], images={}, starts=[], **_splat.build(ctx, cfg))
    st["path"] = path(len(st["cams"]), tr["path_frames"], ctx["seed"])
    st["k"] = 0
    for i in range(len(st["cams"])):  # warm-up: every camera once
        frame(st, i)
    return st


def frame(st: dict, i: int) -> np.ndarray:
    from gaussctrl_exp_tpu_torch.models.splat_model import render_model

    spans = st["ctx"]["spans"]
    if spans is not None:
        st["starts"].append(spans.event())
    with torch.no_grad():
        out = render_model(st["gs"], st["pcams"][i], st["step"], st["mcfg"])
    img = np.clip(out.rgb.cpu().numpy(), 0, 1)
    st["images"][i] = img
    return img


def _frames(st: dict, deadline: float | None = None, count: int | None = None) -> tuple[list, float]:
    lat, t0 = [], time.perf_counter()
    n = 0
    while (deadline is None or time.perf_counter() < deadline) and (count is None or n < count):
        i = int(st["path"][st["k"] % len(st["path"])])
        t = time.perf_counter()
        frame(st, i)
        lat.append(time.perf_counter() - t)
        st.setdefault("shown", []).append(i)
        st["k"] += 1
        n += 1
    return lat, time.perf_counter() - t0


def window(st: dict, seconds: float) -> dict:
    spans = st["ctx"]["spans"]
    st["shown"] = []
    if spans is None:
        lat, dt = _frames(st, deadline=time.perf_counter() + seconds)
    else:
        spans.reset()
        with _splat.blend_span(spans, st["starts"]):
            lat, dt = _frames(st, deadline=time.perf_counter() + seconds)
    st["window_s"], st["window_frames"] = dt, list(st["shown"])
    return dict(attempted=len(lat), failed=0, elapsed_s=dt,
                metrics=dict(frame_ms_p95=float(np.percentile(np.asarray(lat) * 1e3, 95))))


def profiled(st: dict) -> None:
    st["shown"] = []
    _frames(st, count=st["tr"]["profile_frames"])
    st["profiled_frames"] = list(st["shown"])


def counts(st: dict, prof: dict) -> dict:
    work = {i: _splat.frame_work(st["g"], st["cams"][i], st["step"], C=4)
            for i in set(st["window_frames"]) | set(st["profiled_frames"])}
    ops = sum(frame_ops(work[i]["visible"]) + work[i]["fwd_ops"] for i in st["window_frames"])
    b1 = sum(work[i]["fwd_bound_s"] for i in st["profiled_frames"])
    return dict(ops=ops, window_s=st["window_s"], peak="f32", b1_bound_s=b1, b1_kernel=_splat.B1)


def release(st: dict) -> None:
    st["gs"] = st["pcams"] = None


def reference_frame(st: dict, i: int, mode: str = "fp32") -> torch.Tensor:
    """The reference's frame ``i``; ``mode`` "bf16" computes it in bfloat16."""
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mode]
    with torch.no_grad():
        bg = torch.ones(3, device=st["g"]["means"].device)
        out = ref.render(st["g"], st["cams"][i], st["step"], bg, depth=False, dtype=dtype)
    return torch.clamp(out["rgb"].float(), 0, 1)


def readings(st: dict, controls=()) -> dict[str, dict]:
    tf32_off()
    return worst_gaps(check_sample(st["ctx"]["seed"], st["images"], st["tr"]["check_frames"]),
                      lambda i: st["images"][i], lambda i, m: reference_frame(st, i, m), abs_gaps("frame"), controls)


def check(st: dict) -> list[tuple[str, float, float]]:
    return check_from(readings(st), st["tr"]["limits"], "frames_compared")

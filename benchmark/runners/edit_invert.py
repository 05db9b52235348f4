"""GaussCtrl's inversion: ``GaussCtrlEditPipeline.render_reverse`` over the
scene's views, as ``gctpu-train``'s edit phase runs it before generating.

For each view: render it through ``render_model`` (kernel B1), copy the
frame and depth to the host, build the disparity hint, VAE-encode the frame
and run the DDIM inversion at B = 1 under the reverse prompt and the depth
ControlNet, with no cross-view processor and no masks; the view's ``z0`` is
kept. Set-up makes the SD weights and the splat scene from the seed and
warms up with one view. The window calls ``render_reverse`` again and
again; a view counts once its ``z0`` is on the host, and the datamanager
ends the window when the next view's camera is asked for past the deadline.

The check inverts views drawn from the seed with the plain reference in
float32 (its own render, disparity, encode and inversion) and compares the
``z0`` the timed path kept.
"""

from __future__ import annotations

import time

import torch

from ..common import StopWindow, abs_gaps, check_from, check_sample, worst_gaps
from ..counts import sd as sd_counts
from ..harness import load_json
from ..reference import sd as ref
from ..reference import splat as ref_splat
from ..reference.precision import precision, tf32_off
from . import _edit, _splat


class Cameras:
    """The datamanager ``render_reverse`` reads: the cameras, and the end of
    the window at the first view started past the deadline."""

    def __init__(self, pcams):
        self.pcams = pcams
        self.deadline, self.stop_after = float("inf"), None
        self.started, self.done, self.t_end = 0, 0, None

    def __len__(self):
        return len(self.pcams)

    def camera(self, i: int):
        # the views before this one are done: their z0 is on the host
        self.done = self.started
        now = time.perf_counter()
        if now >= self.deadline or (self.stop_after is not None and self.done >= self.stop_after):
            self.t_end = now
            raise StopWindow
        self.started += 1
        return self.pcams[i]


def setup(ctx: dict) -> dict:
    tr = ctx["cell"].traffic
    e = _edit.build(ctx)
    sc = _splat.build(ctx, load_json("configs", tr["scene"]))
    cams = Cameras(sc["pcams"])
    st = dict(ctx=ctx, tr=tr, edit=e, scene=sc, cams=cams)
    if ctx["spans"] is not None:
        _wrap(st)
    _run(st, stop_after=1)  # warm-up: one view, every shape of the cell
    return st


def _wrap(st: dict) -> None:
    """Traced runs: CUDA events around each inversion step and each encode,
    on the pipeline instance."""
    spans, sd = st["ctx"]["spans"], st["edit"].pipe.pipe
    eps, enc = sd._eps, sd.image_to_latent

    def eps_w(*a, **k):
        with spans.cuda("unet_step"):
            return eps(*a, **k)

    def enc_w(*a, **k):
        with spans.cuda("vae_encode"):
            return enc(*a, **k)

    sd._eps, sd.image_to_latent = eps_w, enc_w


def _run(st: dict, seconds: float | None = None, stop_after: int | None = None) -> tuple[int, float]:
    c, sc = st["cams"], st["scene"]
    c.stop_after, done = stop_after, 0
    t0 = time.perf_counter()
    c.deadline = t0 + seconds if seconds is not None else float("inf")
    while True:
        c.started = c.done = 0
        try:
            st["edit"].pipe.render_reverse(sc["gs"], c, sc["mcfg"])
            done += len(c)
            if stop_after is not None:
                c.stop_after = stop_after - done
        except StopWindow:
            return done + c.done, c.t_end - t0


def window(st: dict, seconds: float) -> dict:
    if st["ctx"]["spans"] is not None:
        st["ctx"]["spans"].reset()
    n, dt = _run(st, seconds=seconds)
    st["window_views"], st["window_s"] = n, dt
    return dict(attempted=n, failed=0, elapsed_s=dt, metrics=dict(invert_views_per_s=n / dt))


def profiled(st: dict) -> None:
    _run(st, stop_after=st["tr"]["profile_views"])


def counts(st: dict, prof: dict) -> dict:
    tr, mc = st["tr"], st["edit"].mcfg
    ops, _ = sd_counts.eps(mc, 1, attn_align=False)
    view_ops = tr["num_inference_steps"] * ops + sd_counts.encode_ops(mc, 1)
    return dict(ops=view_ops * st["window_views"], window_s=st["window_s"], peak="bf16")


def release(st: dict) -> None:
    st["kept"] = dict(st["edit"].pipe.z0)
    _edit.release(st["edit"])
    st["scene"]["gs"] = st["scene"]["pcams"] = None


def disparity(depth: torch.Tensor) -> torch.Tensor:
    """(H, W) depth → (H, W, 3) disparity normalised to a maximum of 1."""
    d = 1.0 / (depth + 1e-5)
    return (d / torch.clamp(d.max(), min=1e-12))[..., None].expand(*d.shape, 3)


def reference_z0(st: dict, i: int, mode: str = "fp32") -> torch.Tensor:
    """The reference's ``z0`` (h, w, 4) of view ``i``."""
    tr, e, sc = st["tr"], st["edit"], st["scene"]
    W = e.weights
    dtype = torch.float32
    with torch.no_grad(), precision(mode):
        bg = torch.ones(3, device=sc["g"]["means"].device)
        out = ref_splat.render(sc["g"], sc["cams"][i], tr["render_step"], bg, depth=True, dtype=dtype)
        rgb = torch.clamp(out["rgb"], 0, 1)
        hint = disparity(out["depth"]).permute(2, 0, 1)[None]
        lat = ref.vae_encode(ref.Params(W["vae"]), e.mcfg, (rgb * 2 - 1).permute(2, 0, 1)[None])
        ctx = _edit.text_states(e, e.prompts["reverse"])
        z = ref.invert(ref.Params(W["unet"]), ref.Params(W["controlnet"]), e.mcfg, lat, ctx, hint,
                       tr["num_inference_steps"], tr["controlnet_scale"])
    return z[0].permute(1, 2, 0)


def readings(st: dict, controls=()) -> dict[str, dict]:
    tf32_off()
    return worst_gaps(check_sample(st["ctx"]["seed"], st["kept"], st["tr"]["check_views"]), lambda i: st["kept"][i],
                      lambda i, m: reference_z0(st, i, m), abs_gaps("z0"), controls)


def check(st: dict) -> list[tuple[str, float, float]]:
    return check_from(readings(st), st["tr"]["limits"], "views_compared")

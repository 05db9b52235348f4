"""GaussCtrl's generation: ``GaussCtrlEditPipeline.edit_images`` over the
scene's views, as ``gctpu-train``'s edit phase runs it.

Set-up makes the SD stack's weights and every view's inverted latent ``z0``
and disparity hint from the seed, so that no inversion runs here, and warms
up with one chunk. The window calls ``edit_images`` again and again: chunks
of ``chunk_size`` views after the reference views, CFG doubling the batch,
``num_inference_steps`` DDIM steps and a VAE decode each, every view written
back to the benchmark's datamanager. A view counts at its write-back; the
datamanager ends the window at the first chunk's end past the deadline.

The check regenerates chunks drawn from the seed with the plain reference
in float32 and compares the images the timed path wrote back.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..common import StopWindow, abs_gaps, check_from, check_sample, generator, reference_views, worst_gaps
from ..counts import sd as sd_counts
from ..counts.attention import attention_bound_s
from ..reference import sd as ref
from ..reference.precision import precision, tf32_off
from . import _edit

B3 = "gctorch_attn_fwd_b3"


class Views:
    """The datamanager ``edit_images`` writes back to: keeps the last image
    of each view and ends the loop at a chunk's end once asked to."""

    def __init__(self, n: int, chunk: int, spans=None):
        self.n, self.chunk, self.spans = n, chunk, spans
        self.images: dict[int, np.ndarray] = {}
        self.deadline, self.stop_after = float("inf"), None
        self.written, self.t_end = 0, None
        self.t_chunk = None

    def __len__(self):
        return self.n

    def write_back(self, i: int, img: np.ndarray) -> None:
        self.images[i] = img
        self.written += 1
        if (i + 1) % self.chunk and i != self.n - 1:
            return
        now = time.perf_counter()
        if self.spans is not None and self.t_chunk is not None:
            self.spans.host_s["chunk_wall"].append(now - self.t_chunk)
        self.t_chunk = now
        if now >= self.deadline or (self.stop_after is not None and self.written >= self.stop_after):
            self.t_end = now
            raise StopWindow


def make_inputs(n: int, mcfg: dict, seed: int, device):
    """Per-view latents ``z0`` (V, h, w, 4) and disparity hints (V, H, W, 3):
    unit-normal latents (an inverted latent is close to noise), and smooth
    depths 0.25-1.25 upsampled from 8 × 8, turned into normalised disparity."""
    g = generator(seed, "edit.inputs", device)
    h, s = mcfg["latent"], mcfg["image"]
    z0 = torch.randn((n, h, h, 4), generator=g, device=device)
    depth = F.interpolate(torch.rand((n, 1, 8, 8), generator=g, device=device) + 0.25, size=(s, s),
                          mode="bilinear", align_corners=False)
    disp = 1.0 / (depth + 1e-5)
    disp = (disp / disp.amax((2, 3), keepdim=True)).permute(0, 2, 3, 1).expand(n, s, s, 3).contiguous()
    return z0, disp


def setup(ctx: dict) -> dict:
    tr = ctx["cell"].traffic
    e = _edit.build(ctx)
    z0, disp = make_inputs(tr["views"], e.mcfg, ctx["seed"], ctx["device"])
    e.pipe.z0 = {i: z0[i].cpu().numpy() for i in range(tr["views"])}
    e.pipe.disparity = {i: disp[i].cpu().numpy() for i in range(tr["views"])}
    views = Views(tr["views"], tr["chunk_size"], ctx["spans"])
    st = dict(ctx=ctx, tr=tr, edit=e, z0=z0, disp=disp, views=views)
    if ctx["spans"] is not None:
        _wrap(st)
    _run(st, stop_after=tr["chunk_size"])  # warm-up: one chunk, every shape of the cell
    return st


def _wrap(st: dict) -> None:
    """Traced runs: CUDA events around each denoising step and around each
    chunk's denoising loop and decode, on the pipeline instance."""
    spans, sd = st["ctx"]["spans"], st["edit"].pipe.pipe
    eps, gen, dec = sd._eps, sd.generate, sd.latent_to_image
    starts = []

    def eps_w(*a, **k):
        with spans.cuda("unet_step"):
            return eps(*a, **k)

    def gen_w(*a, **k):
        starts.append(spans.event())
        return gen(*a, **k)

    def dec_w(*a, **k):
        out = dec(*a, **k)
        spans.pair("chunk_device", starts.pop(), spans.event())
        return out

    sd._eps, sd.generate, sd.latent_to_image = eps_w, gen_w, dec_w


def _run(st: dict, seconds: float | None = None, stop_after: int | None = None) -> tuple[int, float]:
    v = st["views"]
    v.written, v.stop_after = 0, stop_after
    t0 = time.perf_counter()
    v.deadline = t0 + seconds if seconds is not None else float("inf")
    v.t_chunk = t0
    while True:
        try:
            st["edit"].pipe.edit_images(v)
        except StopWindow:
            break
    return v.written, v.t_end - t0


def window(st: dict, seconds: float) -> dict:
    if st["ctx"]["spans"] is not None:
        st["ctx"]["spans"].reset()
    n, dt = _run(st, seconds=seconds)
    st["window_views"], st["window_s"] = n, dt
    return dict(attempted=n, failed=0, elapsed_s=dt, metrics=dict(edit_views_per_s=n / dt))


def profiled(st: dict) -> None:
    _run(st, stop_after=st["tr"]["chunk_size"] * st["tr"]["profile_chunks"])


def counts(st: dict, prof: dict) -> dict:
    tr, mc = st["tr"], st["edit"].mcfg
    B = 2 * (tr["ref_view_num"] + tr["chunk_size"])
    ops, shapes = sd_counts.eps(mc, B, attn_align=True, coeff=tr["attn_align_coeff"])
    chunk_ops = tr["num_inference_steps"] * ops + sd_counts.decode_ops(mc, B // 2)
    chunks = st["window_views"] / tr["chunk_size"]
    b3_bound = sum(attention_bound_s(s) for s in shapes) * tr["num_inference_steps"] * tr["profile_chunks"]
    return dict(ops=chunk_ops * chunks, window_s=st["window_s"], b3_bound_s=b3_bound, b3_kernel=B3,
                peak="bf16")


def release(st: dict) -> None:
    _edit.release(st["edit"])


def reference_chunk(st: dict, c: int, mode: str = "fp32") -> torch.Tensor:
    """The reference's images (5, H, W, 3) of chunk ``c``."""
    tr, e = st["tr"], st["edit"]
    refs = reference_views(tr["views"], tr["ref_view_num"], tr["ref_view_seed"])
    chunk = list(range(c * tr["chunk_size"], min((c + 1) * tr["chunk_size"], tr["views"])))
    idx = torch.tensor(refs + chunk, device=st["z0"].device)
    z = st["z0"][idx].permute(0, 3, 1, 2)
    hint = st["disp"][idx].permute(0, 3, 1, 2)
    W = e.weights
    with torch.no_grad(), precision(mode):
        ctx_c = _edit.text_states(e, e.prompts["edit"]).expand(len(idx), -1, -1)
        ctx_u = _edit.text_states(e, e.prompts["negative"]).expand(len(idx), -1, -1)
        lat = ref.generate(ref.Params(W["unet"]), ref.Params(W["controlnet"]), e.mcfg, z, ctx_c, ctx_u, hint,
                           tr["guidance_scale"], tr["num_inference_steps"], tr["controlnet_scale"],
                           ref.attn_align(tr["attn_align_coeff"], tr["ref_view_num"]))
        img = ref.vae_decode(ref.Params(W["vae"]), e.mcfg, lat[len(refs):])
    return img.permute(0, 2, 3, 1)


def program_chunk(st: dict, c: int) -> torch.Tensor:
    tr, v = st["tr"], st["views"]
    views = range(c * tr["chunk_size"], min((c + 1) * tr["chunk_size"], tr["views"]))
    return torch.as_tensor(np.stack([v.images[i] for i in views]), device=st["z0"].device)


def readings(st: dict, controls=()) -> dict[str, dict]:
    tf32_off()
    tr = st["tr"]
    done = {i // tr["chunk_size"] for i in st["views"].images}
    return worst_gaps(check_sample(st["ctx"]["seed"], done, tr["check_chunks"]), lambda c: program_chunk(st, c),
                      lambda c, m: reference_chunk(st, c, m), abs_gaps("img"), controls)


def check(st: dict) -> list[tuple[str, float, float]]:
    return check_from(readings(st), st["tr"]["limits"], "chunks_compared")

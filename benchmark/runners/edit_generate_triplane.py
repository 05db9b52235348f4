"""GaussCtrl's generation with the fork's TriPlane cross-view processor:
``GaussCtrlEditPipeline.edit_images`` with ``attn_processor="triplane"``
over the scene's views, as ``gctpu-train``'s edit phase runs it.

Set-up makes the SD stack's weights from the seed, builds the splat scene
and its ring of cameras, renders every view's depth through
``render_model`` at the eval step, turns each into its hint with the
program's ``depth_to_disparity``, draws every view's inverted latent ``z0``
from the seed (``edit.generate``'s inputs: no inversion runs here), sets the
configuration's triplane settings on the pipeline, and warms up with one
chunk. The window calls ``edit_images`` again and again: per chunk of
``chunk_size`` views after the reference views, the geometry (the chunk's
depths back-projected to world points on the latent grid) built on the
host, CFG doubling the batch, ``num_inference_steps`` DDIM steps whose 7
self-attentions at the grid mix in the triplane term, and a VAE decode;
every view is written back to the benchmark's datamanager, which reads the
cameras. A view counts at its write-back; the datamanager ends the window at
the first chunk's end past the deadline.

The timed path keeps, per chunk and without a host sync, the UNet's
CFG-doubled input and its ε at the steps ``check_steps`` drawn from the
seed. The check draws one chunk from the seed and regenerates it with the
plain reference in float32 with TF32 off from the same ``z0``, hints,
depths, cameras, weights and text states, its own world points and planes
(``reference/triplane.py``): the images the timed path wrote back, and ε at
the kept steps from the program's own input there.

Traced runs turn the program's tracer on over the window (its device spans
then record CUDA events) and keep what its spans read, then profile one
chunk.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics

import numpy as np
import torch

from .. import program_trace
from ..common import check_from, check_sample, reference_views, sub_seed
from ..counts import sd as sd_counts
from ..counts import triplane as tri_counts
from ..counts.attention import attention_ops
from ..harness import load_json
from ..reference import sd as ref
from ..reference import triplane as ref_tri
from ..reference.precision import precision, tf32_off
from . import _edit, _splat
from . import edit_generate as eg

FAULTS = ("mix1", "shift1")  # the controls of a program's faults, computed in float32


class SceneViews(eg.Views):
    """``edit_generate``'s datamanager with the scene's cameras."""

    def __init__(self, pcams, chunk: int):
        super().__init__(len(pcams), chunk)
        self.pcams = pcams

    def camera(self, i: int):
        return self.pcams[i]


def grid(st: dict) -> int:
    """The geometry's token grid: the latent grid over ``geom_res_divisor``."""
    return st["edit"].mcfg["latent"] // st["tp"]["geom_res_divisor"]


def setup(ctx: dict) -> dict:
    from gaussctrl_exp_tpu_torch.diffusion.pipeline import depth_to_disparity
    from gaussctrl_exp_tpu_torch.models.splat_model import render_model

    cell, seed, dev = ctx["cell"], ctx["seed"], ctx["device"]
    tr, tp = cell.traffic, cell.config["triplane"]
    e = _edit.build(ctx)
    e.pipe.cfg = dataclasses.replace(e.pipe.cfg, attn_processor="triplane", triplane_mix=tp["mix"],
                                     triplane_bbox_length=tp["bbox_length"], triplane_plane_res=tp["plane_res"],
                                     geom_res_divisor=tp["geom_res_divisor"])
    sc = _splat.build(ctx, load_json("configs", tr["scene"]))
    V = len(sc["pcams"])
    with torch.no_grad():
        depths = torch.stack([render_model(sc["gs"], c, tr["render_step"], sc["mcfg"]).depth[..., 0].float()
                              for c in sc["pcams"]])
    depth_np = depths.cpu().numpy()
    disp_np = np.stack([depth_to_disparity(d) for d in depth_np])
    z0, _ = eg.make_inputs(V, e.mcfg, seed, dev)
    e.pipe.z0 = {i: z0[i].cpu().numpy() for i in range(V)}
    e.pipe.depths = {i: depth_np[i] for i in range(V)}
    e.pipe.disparity = {i: disp_np[i] for i in range(V)}
    rng = np.random.default_rng(sub_seed(seed, "check_steps"))
    steps = tr["num_inference_steps"]
    st = dict(ctx=ctx, tr=dict(tr, views=V), tp=tp, edit=e, scene=sc, z0=z0, depths=depths,
              disp=torch.as_tensor(disp_np, device=dev), views=SceneViews(sc["pcams"], tr["chunk_size"]),
              check_steps=sorted(int(i) for i in rng.choice(steps, size=tr["check_steps"], replace=False)),
              timesteps=list(reversed(ref.ddim_timesteps(steps))), recs={}, rec=None)
    _keep(st)
    eg._run(st, stop_after=tr["chunk_size"])  # warm-up: one chunk, every shape of the cell
    return st


def _keep(st: dict) -> None:
    """Wrap the program's pipeline instance so that each chunk keeps, in
    ``st["recs"][chunk]``, the ε calls' CFG-doubled input and output at the
    check steps, left on the device."""
    pipe = st["edit"].pipe
    geometry, eps = pipe._chunk_geometry, pipe.pipe._eps
    cs = st["tr"]["chunk_size"]

    def geometry_kept(datamanager, views):
        c = views[-1] // cs  # the chunk's views follow the references
        st["rec"] = st["recs"][c] = dict(step=0, eps={})
        return geometry(datamanager, views)

    def eps_kept(latents, t, ctx, hint, cond_scale, processor=None):
        out = eps(latents, t, ctx, hint, cond_scale, processor)
        rec = st["rec"]
        if rec["step"] in st["check_steps"]:
            rec["eps"][rec["step"]] = (latents, out, st["timesteps"][rec["step"]])
        rec["step"] += 1
        return out

    pipe._chunk_geometry, pipe.pipe._eps = geometry_kept, eps_kept


def _span_readings() -> dict:
    """What the program's spans of the window read: device ms of ``sd.eps`` a
    step, and of ``attn.triplane`` in all and a step; empty where the
    program has none."""
    w = program_trace.window()
    if w is None:
        return {}

    def device_ms(name):
        return [s.device_ms for s in w[0] if s.name == name and not s.error and s.device_ms is not None]

    eps, tri = device_ms("sd.eps"), device_ms("attn.triplane")
    out = {}
    if eps:
        out["unet_step_ms"] = statistics.fmean(eps)
    if eps and tri:
        out.update(triplane_s=sum(tri) / 1e3, triplane_spans=len(tri), triplane_ms_per_step=sum(tri) / len(eps))
    return out


def window(st: dict, seconds: float) -> dict:
    tracer = program_trace._tracer() if st["ctx"]["spans"] is not None else None
    if tracer is not None:
        tracer.reset()
        tracer.enable()
    n, dt = eg._run(st, seconds=seconds)
    if tracer is not None:
        st["span_readings"] = _span_readings()
        tracer.disable()
        tracer.reset()
    st["window_views"], st["window_s"] = n, dt
    return dict(attempted=n, failed=0, elapsed_s=dt, metrics=dict(edit_views_per_s=n / dt))


def profiled(st: dict) -> None:
    eg.profiled(st)


def counts(st: dict, prof: dict) -> dict:
    """The window's counted operations (the plain processor's ε, the 7 extra
    attentions to the features, the decode) at the bf16 peak, and the
    triplane term's floor for one mixing layer."""
    tr, mc = st["tr"], st["edit"].mcfg
    V = tr["ref_view_num"] + tr["chunk_size"]
    B, g = 2 * V, grid(st)
    ops, _ = sd_counts.eps(mc, B, attn_align=False)
    mixing = tri_counts.layers(mc, g)
    ops += sum(attention_ops((B, mc["heads"], S, S, C // mc["heads"])) for S, C in mixing)
    chunk_ops = tr["num_inference_steps"] * ops + sd_counts.decode_ops(mc, V)
    floor = tri_counts.step_bound_s(mc, B, V, g, st["tp"]["plane_res"]) / len(mixing)
    return dict(ops=chunk_ops * st["window_views"] / tr["chunk_size"], window_s=st["window_s"], peak="bf16",
                triplane_layer_floor_s=floor)


def release(st: dict) -> None:
    _edit.release(st["edit"])
    st["scene"]["gs"] = None
    gc.collect()


def _cams(st: dict, views: list[int]) -> list[dict]:
    """The reference's cameras: pose and intrinsics as the program holds them."""
    return [dict(c2w=c.c2w, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy) for c in (st["scene"]["pcams"][i] for i in views)]


@torch.no_grad()
def reference_chunk(st: dict, c: int, mode: str = "fp32") -> dict:
    """The reference's images (5, H, W, 3) of chunk ``c`` and its ε at the
    chunk's kept steps from the program's input there, computed in ``mode``:
    ``fp32``, a mode of ``precision``; or a fault's, in float32: ``mix1``, the
    triplane term left out (mix = 1), ``shift1``, every token pooled one
    plane cell off."""
    tr, tp, e = st["tr"], st["tp"], st["edit"]
    refs = reference_views(tr["views"], tr["ref_view_num"], tr["ref_view_seed"])
    chunk = list(range(c * tr["chunk_size"], min((c + 1) * tr["chunk_size"], tr["views"])))
    idx = torch.tensor(refs + chunk, device=st["z0"].device)
    z = st["z0"][idx].permute(0, 3, 1, 2)
    hint = st["disp"][idx].permute(0, 3, 1, 2)
    pts = ref_tri.world_points(st["depths"][idx], _cams(st, refs + chunk), grid(st))
    proc = ref_tri.processor(pts, 1.0 if mode == "mix1" else tp["mix"], tp["bbox_length"], tp["plane_res"],
                             shift=int(mode == "shift1"))
    Pu, Pc, W = ref.Params(e.weights["unet"]), ref.Params(e.weights["controlnet"]), e.weights
    with precision("fp32" if mode in FAULTS else mode):
        ctx_c = _edit.text_states(e, e.prompts["edit"]).expand(len(idx), -1, -1)
        ctx_u = _edit.text_states(e, e.prompts["negative"]).expand(len(idx), -1, -1)
        lat = ref.generate(Pu, Pc, e.mcfg, z, ctx_c, ctx_u, hint, tr["guidance_scale"], tr["num_inference_steps"],
                           tr["controlnet_scale"], proc)
        img = ref.vae_decode(ref.Params(W["vae"]), e.mcfg, lat[len(refs):])
        ctx2, hint2 = torch.cat([ctx_u, ctx_c]), torch.cat([hint, hint])
        eps = {k: ref.eps_fn(Pu, Pc, e.mcfg, x.permute(0, 3, 1, 2).float(), t, ctx2, hint2, tr["controlnet_scale"],
                             proc).float() for k, (x, _, t) in st["recs"][c]["eps"].items()}
    return dict(img=img.permute(0, 2, 3, 1), eps=eps)


def program_chunk(st: dict, c: int) -> dict:
    return dict(img=eg.program_chunk(st, c),
                eps={k: out.permute(0, 3, 1, 2).float() for k, (_, out, _) in st["recs"][c]["eps"].items()})


def gaps(out: dict, want: dict) -> dict:
    d = (out["img"].float() - want["img"].float()).abs()
    rel = max(float((out["eps"][k] - e).abs().max() / e.abs().max()) for k, e in want["eps"].items())
    return dict(img_mean_abs=float(d.mean()), img_max_abs=float(d.max()), eps_max_rel=rel)


def readings(st: dict, controls=()) -> dict[str, dict]:
    tf32_off()
    cs = st["tr"]["chunk_size"]
    done = {i // cs for i in st["views"].images}
    if not done:
        return {}
    c = check_sample(st["ctx"]["seed"], done, 1)[0]
    want = reference_chunk(st, c)
    got = dict(program=gaps(program_chunk(st, c), want))
    got.update((m, gaps(reference_chunk(st, c, m), want)) for m in controls)
    return got


def check(st: dict) -> list[tuple[str, float, float]]:
    return check_from(readings(st), st["tr"]["limits"], "chunks_compared")

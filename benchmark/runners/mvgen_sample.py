"""The depth-conditioned multi-view generator's sampling:
``init_depth_generator`` at the configuration's widths, then
``DepthGenerator.sample`` on the rendered depths of a few consecutive views
of the splat scene.

Set-up builds the scene and the cameras, the UNet's float32 weights and the
text states (the prompt's and the empty prompt's, 77 × cross_dim, one for
every view) from the seed, loads the weights into the program's generator,
and warms up with a call of ``warmup_steps`` steps (every shape a full call
uses). A call draws the first of its ``views`` consecutive cameras of the
ring from the seed and the call's number, renders their depths through
``render_model`` at the eval step, and samples them: ``prepare`` (the depths
on the host, the epipolar tables at every attention grid, the pair mask, the
depth latents), then the configuration's DDIM steps at CFG batch 2 × views
from noise drawn from the seed, and a synchronize. The window runs calls in
a closed loop, one caller, and ends at the end of the first call past the
deadline; a view counts when its call ends.

The timed path keeps, per call and without a host sync, what the check
compares: the depths, the tables and pair mask ``prepare`` built, the final
latents, and at the steps ``check_steps`` drawn from the seed the UNet's
CFG-doubled input and its ε. The check draws one call from the seed and
recomputes it with the plain reference in float32 with TF32 off from the
same depths, cameras, noise, text states and weights: its own tables and
pair mask (taps compared outside rounding ties, whose taps the reference
takes from the program, as it does the mask of a pair whose overlap lies at
the threshold), the final latents of every view after the whole sampling,
and ε at the kept steps from the program's own input (no divergence carried
over from the steps before).

Traced runs turn the program's tracer on over the window (its device spans
then record CUDA events) and keep what its spans and counters read, then
profile one call of ``profile_steps`` steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

from .. import program_trace
from ..common import check_from, check_sample, generator, make_weights, sub_seed, sync
from ..counts import epipolar as epi_counts
from ..counts import mvgen as mv_counts
from ..counts.attention import attention_ops
from ..counts.peaks import PEAK_F32_OPS_S
from ..harness import load_json
from ..reference import mvgen as ref
from ..reference.precision import precision, tf32_off
from ..reference.sd import Params
from . import _splat

B3_F32 = "gctorch_attn_fwd_b3_f32"


def build_generator(cfg: dict, weights: dict, device):
    """The program's ``init_depth_generator`` at the configuration's widths
    and settings, given ``weights``."""
    from gaussctrl_exp_tpu_torch.diffusion.mv_generator import MVGeneratorConfig, init_depth_generator

    u, g = cfg["unet"], cfg["generator"]
    gen = init_depth_generator(0, latent=g["latent_size"], block_out=tuple(u["block_out_channels"]),
                               heads=u["attention_head_dim"], cross_dim=u["cross_attention_dim"],
                               layers_per_block=u["layers_per_block"], cfg=MVGeneratorConfig(**g),
                               dtype=getattr(torch, cfg["compute_dtype"]), device=device)
    gen.unet.load_state_dict(weights, strict=True)
    return gen


def setup(ctx: dict) -> dict:
    cell, seed, dev = ctx["cell"], ctx["seed"], ctx["device"]
    tr, cfg = cell.traffic, cell.config
    tf32_off()  # the configuration's precision: full float32 products
    mc = ref.model_cfg(cfg)
    sc = _splat.build(ctx, load_json("configs", tr["scene"]))
    W = make_weights(ref.param_spec(mc), seed, "weights.unet", dev)
    g = generator(seed, "text", dev)
    text = {k: torch.randn((77, mc["cross_dim"]), generator=g, device=dev) for k in ("uncond", "cond")}
    rng = np.random.default_rng(sub_seed(seed, "check_steps"))
    st = dict(ctx=ctx, tr=tr, cfg=cfg, mc=mc, scene=sc, weights=W, gen=build_generator(cfg, W, dev), text=text,
              check_steps=sorted(int(i) for i in rng.choice(mc["steps"], size=tr["check_steps"], replace=False)),
              n_calls=0, calls=[], rec=None)
    _keep(st)
    _call(st, steps=tr["warmup_steps"])  # warm-up: every shape of a call
    return st


def _keep(st: dict) -> None:
    """Wrap the program's generator so that each call keeps, in ``st["rec"]``,
    the tables and pair mask its ``prepare`` built and the ε of the kept
    steps with its input, all left on the device."""
    import gaussctrl_exp_tpu_torch.diffusion.mv_generator as mv

    gen, build = st["gen"], mv.build_correspondence_tables
    prepare, eps = gen.prepare, gen._eps

    def build_kept(depths, cameras, feat_hw, sigma):
        idx, w = build(depths, cameras, feat_hw, sigma)
        st["rec"]["tables"][feat_hw * feat_hw] = (idx, w)
        return idx, w

    def prepare_kept(depths, cameras):
        out = prepare(depths, cameras)
        st["rec"]["pair_mask"] = np.asarray(out[2])
        return out

    def eps_kept(latents, depth_lat, t, ctx, processor):
        out = eps(latents, depth_lat, t, ctx, processor)
        rec = st["rec"]
        if rec["full"] and rec["step"] in st["check_steps"]:
            rec["eps"][rec["step"]] = (latents, out, int(gen.scheduler.timesteps[rec["step"]]))
        rec["step"] += 1
        return out

    mv.build_correspondence_tables = build_kept
    gen.prepare, gen._eps = prepare_kept, eps_kept
    st["unpatch"] = lambda: setattr(mv, "build_correspondence_tables", build)


def _views(st: dict, k: int) -> list[int]:
    n, V = len(st["scene"]["pcams"]), st["tr"]["views"]
    first = int(np.random.default_rng(sub_seed(st["ctx"]["seed"], f"views.{k}")).integers(n))
    return [(first + j) % n for j in range(V)]


def _noise(st: dict, k: int) -> torch.Generator:
    return generator(st["ctx"]["seed"], f"noise.{k}", st["ctx"]["device"])


def _call(st: dict, steps: int | None = None) -> dict:
    """One sampling call (``steps`` DDIM steps, the configuration's if None) → its record."""
    from gaussctrl_exp_tpu_torch.models.splat_model import render_model

    gen, sc, text, tr = st["gen"], st["scene"], st["text"], st["tr"]
    k, views = st["n_calls"], _views(st, st["n_calls"])
    st["n_calls"] += 1
    rec = st["rec"] = dict(k=k, views=views, tables={}, eps={}, step=0, full=steps is None)
    full = gen.cfg
    if steps is not None:
        gen.cfg = dataclasses.replace(full, num_steps=steps)
    try:
        with torch.no_grad():
            depths = [render_model(sc["gs"], sc["pcams"][i], tr["render_step"], sc["mcfg"]).depth for i in views]
        V = len(views)
        lat = gen.sample(text["cond"].expand(V, -1, -1), text["uncond"].expand(V, -1, -1), depths,
                         [sc["pcams"][i] for i in views], generator=_noise(st, k))
        sync(st["ctx"]["device"])
    finally:
        gen.cfg = full
    H, W_ = depths[0].shape[:2]
    rec.update(lat=lat, depths=torch.stack([d.reshape(H, W_) for d in depths]))
    return rec


def _span_readings() -> dict:
    """What the program's spans and counters of the window read: device ms of
    ``mvgen.eps`` a step, of ``attn.epipolar`` in all, host ms of
    ``mvgen.prepare`` a call, the steps; empty where the program has none."""
    w = program_trace.window()
    if w is None:
        return {}
    spans, counters = w

    def of(name, attr):
        vals = [getattr(s, attr) for s in spans if s.name == name and not s.error]
        return [v for v in vals if v is not None]

    eps, epi, prep = of("mvgen.eps", "device_ms"), of("attn.epipolar", "device_ms"), of("mvgen.prepare", "host_ms")
    out = {}
    if eps:
        out["unet_step_ms"] = float(np.mean(eps))
    if epi and counters.get("mvgen.steps"):
        out.update(epipolar_s=sum(epi) / 1e3, epipolar_ms_per_step=sum(epi) / counters["mvgen.steps"])
    if prep:
        out["prepare_ms"] = float(np.mean(prep))
    return out


def _pairs(rec: dict) -> int:
    """Ordered pairs the call's pair mask kept (of views × (views − 1))."""
    pm = rec["pair_mask"] * (1.0 - np.eye(len(rec["views"])))
    return int((pm != 0).sum())


def window(st: dict, seconds: float) -> dict:
    tracer = program_trace._tracer() if st["ctx"]["spans"] is not None else None
    if tracer is not None:
        tracer.reset()
        tracer.enable()
    st["calls"] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        st["calls"].append(_call(st))
        if time.perf_counter() >= deadline:
            break
    dt = time.perf_counter() - t0
    if tracer is not None:
        st["span_readings"] = _span_readings()
        tracer.disable()
        tracer.reset()
    V = st["tr"]["views"]
    n = V * len(st["calls"])
    st["window_views"], st["window_s"] = n, dt
    for rec in st["calls"]:
        p = _pairs(rec)
        print(f"mvgen: call {rec['k']} views {rec['views']}: pair mask kept {p} of {V * (V - 1)} ordered pairs, "
              f"{2 * p} attended pairs a layer, {2 * p * len(epi_counts.layers(st['mc']))} a step", file=sys.stderr)
    return dict(attempted=n, failed=0, elapsed_s=dt, metrics=dict(edit_views_per_s=n / dt))


def profiled(st: dict) -> None:
    _call(st, steps=st["tr"]["profile_steps"])


def counts(st: dict, prof: dict) -> dict:
    """The window's counted work at each part's own peak (the UNet's float32
    products and the epipolar term at float32's, attention at 3×TF32's), the
    epipolar term's floor over the window, and the profiled call's B3 bound."""
    mc = st["mc"]
    unet_ops, shapes = mv_counts.eps(mc, st["tr"]["views"])
    step_s = unet_ops / PEAK_F32_OPS_S + sum(attention_ops(s) for s in shapes) / mv_counts.PEAK_F32_EXACT_OPS_S
    peak_s = epi_s = 0.0
    for rec in st["calls"]:
        pairs = 2 * _pairs(rec)
        peak_s += mc["steps"] * (step_s + epi_counts.step_ops(mc, pairs) / PEAK_F32_OPS_S)
        epi_s += mc["steps"] * epi_counts.step_bound_s(mc, pairs)
    return dict(peak_s=peak_s, window_s=st["window_s"], epipolar_floor_s=epi_s, b3_kernel=B3_F32,
                b3_bound_s=st["tr"]["profile_steps"] * mv_counts.attention_bound_s(shapes))


def release(st: dict) -> None:
    st["unpatch"]()
    st["gen"] = st["scene"]["gs"] = None


def _cams(st: dict, views: list[int]) -> list[dict]:
    """The reference's cameras: pose and intrinsics as the program holds them."""
    out = []
    for i in views:
        c = st["scene"]["pcams"][i]
        out.append(dict(c2w=c.c2w, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy))
    return out


@contextlib.contextmanager
def _mode(mode: str):
    """The reference computed as a control asks: ``fp32``; a mode of
    ``precision``; ``tf32``, float32 with TF32 in matmuls and cuDNN (the
    card's single-pass tensor-core float32); ``mix1``, float32 with the
    cross-view term left out (mix = 1)."""
    if mode == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            tf32_off()
        return
    with precision("fp32" if mode == "mix1" else mode):
        yield


def reference_inputs(st: dict, rec: dict) -> dict:
    """The reference's tables and pair mask for call ``rec``, its own but
    where a tap's hit lies at a rounding tie, or a pair's overlap at the
    threshold: there the program's. With the taps and mask entries that
    differ elsewhere."""
    mc, m = st["mc"], st["tr"]["margins"]
    prep = ref.prepare(mc, rec["depths"], _cams(st, rec["views"]), margin=m["tap_px"])
    differ = total = 0
    for S, (idx, w) in prep["tables"].items():
        p_idx, p_w = rec["tables"][S]
        tie = prep["ties"][S][..., None].expand_as(idx)
        differ += int(((idx != p_idx) & ~tie).sum())
        total += idx.numel()
        prep["tables"][S] = (torch.where(tie, p_idx, idx), torch.where(tie, p_w, w))
    pm_prog = torch.as_tensor(rec["pair_mask"], device=prep["ratio"].device).float()
    pm_prog = pm_prog * (1.0 - torch.eye(len(rec["views"]), device=pm_prog.device))
    near = (prep["ratio"] - mc["min_overlap"]).abs() < m["overlap"]
    pairs_differ = int(((prep["pair_mask"] != pm_prog) & ~near).sum())
    prep["pair_mask"] = torch.where(near, pm_prog, prep["pair_mask"])
    return dict(prep, taps_differ=differ / total, pairs_differ=float(pairs_differ))


@torch.no_grad()
def reference_call(st: dict, rec: dict, inputs: dict, mode: str = "fp32") -> dict:
    """The reference's final latents (V, 4, L, L) of call ``rec`` and its ε at
    the kept steps from the program's input there, computed in ``mode``."""
    mc, text, V = st["mc"], st["text"], len(rec["views"])
    P = Params(st["weights"])
    L = mc["latent"]
    noise = torch.randn((V, L, L, 4), generator=_noise(st, rec["k"]), device=inputs["depth_lat"].device)
    ctx_c, ctx_u = text["cond"].expand(V, -1, -1), text["uncond"].expand(V, -1, -1)
    with _mode(mode):
        proc = ref.processor(inputs["tables"], inputs["pair_mask"], 1.0 if mode == "mix1" else mc["mix"])
        lat = ref.sample(P, mc, noise.permute(0, 3, 1, 2), inputs["depth_lat"], ctx_c, ctx_u, proc)
        eps = {i: ref.eps(P, mc, x.permute(0, 3, 1, 2).float(), inputs["depth_lat"], t, torch.cat([ctx_u, ctx_c]),
                          proc) for i, (x, _, t) in rec["eps"].items()}
    return dict(lat=lat, eps=eps)


def gaps(out: dict, want: dict) -> dict:
    d = (out["lat"].float() - want["lat"]).abs()
    rel = max(float((out["eps"][i].float() - e).abs().max() / e.abs().max()) for i, e in want["eps"].items())
    return dict(lat_mean_abs=float(d.mean()), lat_max_abs=float(d.max()), eps_max_rel=rel)


def readings(st: dict, controls=()) -> dict[str, dict]:
    tf32_off()
    if not st["calls"]:
        return {}
    rec = st["calls"][check_sample(st["ctx"]["seed"], range(len(st["calls"])), 1)[0]]
    inputs = reference_inputs(st, rec)
    want = reference_call(st, rec, inputs)
    prog = dict(lat=rec["lat"].permute(0, 3, 1, 2), eps={i: e.permute(0, 3, 1, 2) for i, (_, e, _) in rec["eps"].items()})
    got = dict(program=dict(gaps(prog, want), taps_differ=inputs["taps_differ"], pairs_differ=inputs["pairs_differ"]))
    for m in controls:
        got[m] = dict(gaps(reference_call(st, rec, inputs, m), want), taps_differ=0.0, pairs_differ=0.0)
    print(f"mvgen: checked call {rec['k']} views {rec['views']} at steps {sorted(rec['eps'])}", file=sys.stderr)
    return got


def check(st: dict) -> list[tuple[str, float, float]]:
    return check_from(readings(st), st["tr"]["limits"], "calls_compared")

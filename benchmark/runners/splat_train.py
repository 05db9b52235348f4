"""The edited scene's fine-tune: the program's ``Trainer`` as ``gctpu-train``
runs it after the edit, from the step the pretrained checkpoint ends at.

Set-up builds one ``Trainer`` on the scene from the seed, with a datamanager
of the 40 views whose targets (the edited images) come from the seed and
are drawn in a seeded order without replacement per epoch, and patch LPIPS
with VGG weights from the seed. It drives that trainer through its first
three steps, keeping each step's loss, the first step's gradient (from
Adam's first moment) and the parameters after the third step; they are
also the warm-up. The window then calls ``Trainer.train`` step after step.
Inside the window, three steps drawn from the seed are kept the same way:
the one that ends at the first, second or third refine step of the window
(where the trainer culls) and the two after it, with the state they start
from (parameters, Adam's moments and count, the alive mask, the
generator). The check follows both sets of three steps with the plain
reference (render, L1 + SSIM + patch LPIPS with the same background and
patches, autograd, Adam, the cull) from their starts, and compares the
losses, each parameter group's gradient norm and its change over the three
steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..common import generator, load_module, make_weights, sub_seed, sync
from ..counts.splat import loss_ops, step_ops
from ..reference import splat as ref
from ..reference.precision import tf32_off
from . import _splat

GROUPS = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")
KEPT = 3  # steps kept for the check: from the seed, and inside the window


class TrainViews:
    """The trainer's datamanager: views in a seeded order, each epoch a new
    permutation; targets are device tensors."""

    def __init__(self, cams, images, seed: int):
        self.cams, self.images = cams, images
        self.width, self.height = cams[0].width, cams[0].height
        self._rng = np.random.default_rng(sub_seed(seed, "views"))
        self._order: list[int] = []
        self.drawn: list[int] = []

    def __len__(self):
        return len(self.cams)

    def next_train(self):
        if not self._order:
            self._order = list(self._rng.permutation(len(self.cams)))
        i = int(self._order.pop())
        self.drawn.append(i)
        return i, self.images[i]

    def camera(self, i):
        return self.cams[i]

    def image(self, i):
        return self.images[i]

    def eval_indices(self, max_views: int = 8):
        return list(range(min(len(self.cams), max_views)))


def make_targets(n: int, size: int, seed: int, device) -> torch.Tensor:
    """(n, size, size, 3) smooth images in [0, 1]: 16 × 16 noise upsampled."""
    low = torch.rand((n, 3, 16, 16), generator=generator(seed, "targets", device), device=device)
    return F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False).permute(0, 2, 3, 1).contiguous()


def train_config(cfg: dict, seed: int):
    from gaussctrl_exp_tpu_torch.engine.trainer import TrainConfig
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig

    return TrainConfig(ssim_lambda=cfg["ssim_lambda"], use_lpips=cfg["use_lpips"], patch_size=cfg["patch_size"],
                       lpips_patches=cfg["lpips_patches"], seed=sub_seed(seed, "trainer"),
                       model=SplatModelConfig(sh_degree=cfg["sh_degree"], sh_degree_interval=cfg["sh_degree_interval"]))


def setup(ctx: dict) -> dict:
    from gaussctrl_exp_tpu_torch.engine.trainer import Trainer
    from gaussctrl_exp_tpu_torch.ops.lpips import LPIPS

    cfg, tr, seed, dev = ctx["cell"].config, ctx["cell"].traffic, ctx["seed"], ctx["device"]
    st = dict(ctx=ctx, tr=tr, starts=[], **_splat.build(ctx, cfg))
    st["targets"] = make_targets(len(st["cams"]), cfg["image_size"], seed, dev)
    st["lpips_w"] = make_weights(ref.lpips_spec(), seed, "weights.lpips", dev)
    lp = load_module(LPIPS, st["lpips_w"], device=dev)
    dm = TrainViews(st["pcams"], st["targets"], seed)
    tcfg = train_config(cfg, seed)
    trainer = Trainer(st["gs"], dm, tcfg, lpips=lp)
    trainer.step = trainer.state.step = cfg["start_step"]
    st.update(dm=dm, trainer=trainer, tcfg=tcfg, lpips=lp, start=cfg["start_step"])

    # the first steps, through the window's own call; they warm up every kernel
    st["first"] = _keep(st, KEPT)
    # the kept window steps: from the one that ends at the window's first,
    # second or third refine step (drawn from the seed) on
    every = ref.REFINE_EVERY
    st["judge_at"] = (st["start"] // every + 1 + sub_seed(seed, "judged") % tr["judged_refines"]) * every - 1
    if ctx["spans"] is not None:
        _wrap(st)
    return st


def _keep(st: dict, n: int) -> dict:
    """``n`` steps through the window's own call, kept for the check: the
    state they start from (parameters, Adam's moments and count, the alive
    mask, the generator, the step), each step's loss, the first step's
    gradient as Adam took it (from its first moment before and after) and
    the parameters after the last step."""
    from gaussctrl_exp_tpu_torch.engine.optimizers import group_state

    trainer = st["trainer"]
    s, opt = trainer.state, trainer.state.optimizer

    def params():
        return {g: getattr(s.params, g).detach().clone() for g in GROUPS}

    def moments(key):
        return {g: group_state(opt, g)[key].clone() for g in GROUPS}

    kept = dict(start=params(), m=moments("exp_avg"), v=moments("exp_avg_sq"), alive=s.alive.clone(),
                gen=s.generator.get_state(), count=int(group_state(opt, "means")["step"]), step=trainer.step,
                first=len(st["dm"].drawn))
    orig, losses = trainer.train_step, []

    def keep_loss(*a, **k):
        out = orig(*a, **k)
        losses.append(out["main_loss"].detach().clone())
        return out

    trainer.train_step = keep_loss
    try:
        trainer.train(1)
        kept["grad1"] = {g: (group_state(opt, g)["exp_avg"] - ref.ADAM_B1 * kept["m"][g]) / (1.0 - ref.ADAM_B1)
                         for g in GROUPS}
        trainer.train(n - 1)
    finally:
        trainer.train_step = orig
    kept.update(after=params(), losses=torch.stack(losses), views=list(st["dm"].drawn[kept["first"]:]))
    return kept


def _wrap(st: dict) -> None:
    """Traced runs: the trainer's step rebuilt with the program's stage
    callback, recording a CUDA event at the step's start and at each
    stage's end, on the trainer instance."""
    from gaussctrl_exp_tpu_torch.engine.trainer import make_train_step

    spans, trainer = st["ctx"]["spans"], st["trainer"]
    marks: dict = {}
    step = make_train_step(st["tcfg"], lpips=st["lpips"], on_stage=lambda name: marks.__setitem__(name, spans.event()))

    def traced(*a, **k):
        st["starts"].append(spans.event())
        out = step(*a, **k)
        spans.pair("loss", marks["render"], marks["loss"])
        spans.pair("optimizer", marks["backward"], marks["optimizer"])
        return out

    trainer.train_step = traced


def _steps(st: dict, deadline: float | None = None, count: int | None = None) -> tuple[int, float]:
    """Steps until ``deadline`` or ``count``; the step at ``judge_at`` and
    the two after it are kept for the check as they run."""
    trainer, n = st["trainer"], 0
    t0 = time.perf_counter()
    while (deadline is None or time.perf_counter() < deadline) and (count is None or n < count):
        if trainer.step == st["judge_at"]:
            st["judged"] = _keep(st, KEPT)
            n += KEPT
        else:
            trainer.train(1)
            n += 1
    sync(st["ctx"]["device"])
    return n, time.perf_counter() - t0


def window(st: dict, seconds: float) -> dict:
    spans = st["ctx"]["spans"]
    first = len(st["dm"].drawn)
    if spans is None:
        n, dt = _steps(st, deadline=time.perf_counter() + seconds)
    else:
        spans.reset()
        with _splat.blend_span(spans, st["starts"]):
            n, dt = _steps(st, deadline=time.perf_counter() + seconds)
    st["window_s"], st["window_views"] = dt, st["dm"].drawn[first:]
    st["judged_in_window"] = "judged" in st
    while "judged" not in st:  # a window too short to reach the kept steps: they follow it, untimed
        _steps(st, count=1)
    return dict(attempted=n, failed=0, elapsed_s=dt, metrics=dict(train_steps_per_s=n / dt))


def profiled(st: dict) -> None:
    st["profile_state"] = {n: getattr(st["trainer"].state.params, n).detach().clone() for n in GROUPS}
    st["profile_state"]["alive"] = st["trainer"].state.alive.clone()
    first = len(st["dm"].drawn)
    _steps(st, count=st["tr"]["profile_steps"])
    st["profile_views"] = st["dm"].drawn[first:]


def counts(st: dict, prof: dict) -> dict:
    cfg, g, step = st["cfg"], st["profile_state"], st["trainer"].step
    views = set(st["window_views"]) | set(st["profile_views"])
    work = {i: _splat.frame_work(g, st["cams"][i], step, C=3) for i in views}
    S = cfg["image_size"]
    loss = loss_ops(S, S, cfg["lpips_patches"], cfg["patch_size"])
    ops = sum(step_ops(work[i]["visible"], cfg["capacity"], work[i]["fwd_ops"], work[i]["bwd_ops"], loss)
              for i in st["window_views"])
    return dict(ops=ops, window_s=st["window_s"], peak="f32",
                b1_bound_s=sum(work[i]["fwd_bound_s"] for i in st["profile_views"]), b1_kernel=_splat.B1,
                b2_bound_s=sum(work[i]["bwd_bound_s"] for i in st["profile_views"]), b2_kernel=_splat.B2)


def release(st: dict) -> None:
    st["trainer"] = st["lpips"] = st["gs"] = st["pcams"] = None


def reference_steps(st: dict, start: dict, dtype=torch.float32, half_rows: bool = False):
    """The reference's steps over ``start["views"]`` from ``start`` (the
    parameters, Adam's moments and count, the alive mask, the generator's
    state and the step; no moments or generator: fresh ones) →
    (losses, the first gradient by group, the parameters after the last
    step by group). The trainer's cull runs where its step is a refine
    step. With ``half_rows``, the fault of a batch half left out: L1 over
    the frame's top half only."""
    cfg = st["cfg"]
    dev = start["alive"].device
    p = {n: start["start"][n].to(dtype).clone().requires_grad_() for n in GROUPS}
    m = {n: torch.zeros_like(p[n]) if start["m"] is None else start["m"][n].to(dtype).clone() for n in GROUPS}
    v = {n: torch.zeros_like(p[n]) if start["v"] is None else start["v"][n].to(dtype).clone() for n in GROUPS}
    alive = start["alive"].clone()
    gen = torch.Generator(device=dev)
    if start["gen"] is None:
        gen.manual_seed(st["tcfg"].seed)
    else:
        gen.set_state(start["gen"])
    S, ps, n_p = cfg["image_size"], cfg["patch_size"], cfg["lpips_patches"]
    Wl = {k: t.to(dtype) for k, t in st["lpips_w"].items()}
    losses, grad1 = [], None
    for k, view in enumerate(start["views"]):
        step, count = start["step"] + k, start["count"] + k
        bg = torch.rand(3, generator=gen, device=dev)
        out = ref.render(dict(p, alive=alive), st["cams"][view], step, bg, depth=False, dtype=dtype)
        rgb, gt = out["rgb"], st["targets"][view].to(dtype)
        lam = cfg["ssim_lambda"]
        rows = S // 2 if half_rows else S
        loss = (1 - lam) * (rgb[:rows] - gt[:rows]).abs().mean() + lam * (1 - ref.ssim(rgb, gt))
        ys = torch.randint(0, S - ps + 1, (n_p,), generator=gen, device=dev)
        xs = torch.randint(0, S - ps + 1, (n_p,), generator=gen, device=dev)
        r = torch.arange(ps, device=dev)
        iy, ix = (ys[:, None] + r)[:, :, None], (xs[:, None] + r)[:, None, :]
        loss = loss + ref.lpips(Wl, rgb[iy, ix], gt[iy, ix]).mean()
        grads = torch.autograd.grad(loss, [p[n] for n in GROUPS], allow_unused=True)
        losses.append(loss.detach().float())
        with torch.no_grad():
            for n, gr in zip(GROUPS, grads):
                gr = torch.zeros_like(p[n]) if gr is None else gr
                if k == 0:
                    grad1 = dict(grad1 or {}, **{n: gr.float()})
                new, m[n], v[n] = ref.adam(p[n], gr, m[n], v[n], count, ref.lr(n, count))
                p[n].copy_(new)
            if ref.is_refine_step(step + 1):
                alive = ref.cull(p, alive, gen)
    return torch.stack(losses), grad1, {n: p[n].detach().float() for n in GROUPS}


def gaps(losses, grad1, after, want) -> dict:
    """Relative gaps: the worst step's loss; by group, the gap of the first
    gradient's norm and of the change's norm over the kept steps, each
    against the reference's norm of that group or of the median group,
    whichever is larger. Groups whose reference gradient is under a
    thousandth of the median group's are left out of the change."""
    w_loss, w_grad, w_after, start = want
    gn = {n: float(w_grad[n].norm()) for n in GROUPS}
    med_g = float(np.median(list(gn.values())))
    dn = {n: float((w_after[n] - start[n]).norm()) for n in GROUPS}
    moved = [n for n in GROUPS if gn[n] >= 1e-3 * med_g]
    med_d = float(np.median([dn[n] for n in moved]))
    loss_gap = float(((losses.float() - w_loss.float()).abs() / w_loss.float().abs()).max())
    grad_gap = max(abs(float(grad1[n].norm()) - gn[n]) / max(gn[n], med_g) for n in GROUPS)
    change_gap = max(abs(float((after[n] - start[n]).norm()) - dn[n]) / max(dn[n], med_d) for n in moved)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)


def kept_sets(st: dict) -> list[tuple[str, dict, dict]]:
    """(suffix of the compared numbers, the program's kept steps, the start
    the reference follows them from): the first steps from the seed's own
    scene and fresh optimizer, and the window's steps from the program's
    state where they began."""
    g, first = st["g"], st["first"]
    seeded = dict(start={n: g[n] for n in GROUPS}, m=None, v=None, alive=g["alive"], gen=None, count=0,
                  step=st["start"], views=first["views"])
    return [("", first, seeded), (".window", st["judged"], st["judged"])]


def readings(st: dict, controls=()) -> dict[str, dict]:
    tf32_off()
    got: dict[str, dict] = {}
    for suffix, kept, start in kept_sets(st):
        base = {n: start["start"][n].float() for n in GROUPS}
        want = (*reference_steps(st, start), base)
        runs = dict(program=(kept["losses"], kept["grad1"], kept["after"]))
        for mode in controls:  # "bf16": the control; "half_rows": a fault planted in the reference
            args = dict(half_rows=True) if mode == "half_rows" else dict(dtype={"bf16": torch.bfloat16}[mode])
            runs[mode] = reference_steps(st, start, **args)
        for who, (losses, grad1, after) in runs.items():
            got.setdefault(who, {}).update({k + suffix: v for k, v in gaps(losses, grad1, after, want).items()})
    return got


def check(st: dict) -> list[tuple[str, float, float]]:
    got = readings(st)["program"]
    return [(k, got[k], lim) for k, lim in st["tr"]["limits"].items()]

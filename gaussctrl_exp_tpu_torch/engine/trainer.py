"""Training engine: the train step and the host loop with the refine cadence.

Port of ``gaussctrl_exp_tpu/engine/trainer.py``. One step renders the
sampled view (kernel B1 on the card), takes the splatfacto loss
``(1−λ)·L1 + λ·(1−SSIM)`` (plus the patch-LPIPS term when weights are
attached), back-propagates (kernel B2 on the card), applies the per-group
Adam update and accumulates the densify statistics. ``Trainer.train`` fires
densify/prune and the opacity reset at splatfacto's cadence.

PyTorch runs eagerly, so the state is mutable: parameters are leaf tensors
that the optimizer, ``refine`` and ``reset_opacity`` update in place, and a
step advances ``TrainState.step`` and its generator. The JAX package's
capacity rebucket has no counterpart: the port's binning sizes the
intersection list exactly.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch

from ..cameras import Camera
from ..models.camera_opt import apply_pose_delta
from ..models.densify import DensifyConfig, DensifyStats, accumulate_stats, refine, reset_opacity
from ..models.gaussians import PARAM_NAMES, GaussianParams, GaussianState
from ..models.splat_model import SplatModelConfig, render_model
from ..ops.ssim import psnr, splatfacto_loss, ssim
from .optimizers import MultiStepAdam, ScheduledAdam, exp_decay, make_gaussian_optimizer


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    ssim_lambda: float = 0.2
    max_steps: int = 30_000
    densify: DensifyConfig = DensifyConfig()
    model: SplatModelConfig = SplatModelConfig()
    seed: int = 42
    # patch LPIPS term: on by default; it needs pretrained VGG weights passed
    # as ``lpips=`` (ops.lpips.load_lpips), and without them the step warns
    # and trains with L1 + SSIM only
    use_lpips: bool = True
    patch_size: int = 32
    lpips_loss_mult: float = 1.0
    lpips_patches: int = 8  # random patches sampled per step
    # camera pose optimization: lr 1e-3 → 5e-5, gradients averaged over 100 steps
    camera_opt: bool = False
    camera_opt_lr: float = 1e-3
    camera_opt_lr_final: float = 5e-5
    camera_opt_accum: int = 100


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and updates, in place."""

    params: GaussianParams  # leaf tensors that require grad
    alive: torch.Tensor  # (C,) bool
    optimizer: ScheduledAdam
    stats: DensifyStats
    step: int
    generator: torch.Generator  # background, LPIPS patches, split offsets
    cam_deltas: Optional[torch.Tensor] = None  # (V, 6) pose adjustments
    cam_optimizer: Optional[MultiStepAdam] = None


def init_train_state(gs: GaussianState, cfg: TrainConfig, num_views: int = 0) -> TrainState:
    """A fresh state on ``gs``'s device; the parameters are copied, so
    training leaves ``gs`` as it was."""
    dev = gs.alive.device
    params = GaussianParams(
        **{n: getattr(gs.params, n).detach().clone().requires_grad_() for n in PARAM_NAMES}
    )
    cam_deltas = cam_opt = None
    if cfg.camera_opt and num_views > 0:
        cam_deltas = torch.zeros((num_views, 6), device=dev, requires_grad=True)
        sched = exp_decay(cfg.camera_opt_lr, cfg.camera_opt_lr_final, cfg.max_steps)
        cam_opt = MultiStepAdam(cam_deltas, sched, cfg.camera_opt_accum)
    return TrainState(
        params=params,
        alive=gs.alive.clone(),
        optimizer=make_gaussian_optimizer(params, max_steps=cfg.max_steps),
        stats=DensifyStats.zero(params.capacity, dev),
        step=0,
        generator=torch.Generator(device=dev).manual_seed(cfg.seed),
        cam_deltas=cam_deltas,
        cam_optimizer=cam_opt,
    )


def sample_patches(generator: torch.Generator, a: torch.Tensor, b: torch.Tensor,
                   patch_size: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """n random aligned (patch_size, patch_size, 3) crops of both images."""
    H, W, _ = a.shape
    dev = generator.device
    ys = torch.randint(0, H - patch_size + 1, (n,), generator=generator, device=dev).to(a.device)
    xs = torch.randint(0, W - patch_size + 1, (n,), generator=generator, device=dev).to(a.device)
    r = torch.arange(patch_size, device=a.device)
    iy, ix = (ys[:, None] + r)[:, :, None], (xs[:, None] + r)[:, None, :]
    return a[iy, ix], b[iy, ix]


def make_train_step(cfg: TrainConfig, lpips: Optional[torch.nn.Module] = None,
                    on_stage: Optional[Callable[[str], None]] = None):
    """``lpips``: an optional ``ops.lpips.LPIPS`` (``load_lpips`` at
    deployment, ``lpips_random`` in tests) that enables the patch-LPIPS term
    when ``cfg.use_lpips``. ``on_stage``: an optional callback, called with
    the name of each stage as it ends ("render", "loss", "backward",
    "optimizer", "stats"); ``chip_smoke.py`` records CUDA events there.
    Returns ``train_step(state, camera, gt, view_idx)``, which updates
    ``state`` in place and returns the step's metrics as 0-d tensors
    (``n_isects`` as an int)."""
    mark = on_stage or (lambda name: None)
    if cfg.use_lpips and lpips is None:
        warnings.warn(
            "use_lpips=True (the reference default) but no VGG/LPIPS weights "
            "were attached — training proceeds with L1+SSIM only. Pass "
            "lpips=ops.lpips.load_lpips(...) to enable the patch-LPIPS term.",
            stacklevel=2,
        )

    def train_step(state: TrainState, camera: Camera, gt: torch.Tensor, view_idx: int = 0) -> dict:
        params = state.params
        use_cam = cfg.camera_opt and state.cam_deltas is not None
        cam = apply_pose_delta(camera, state.cam_deltas[view_idx]) if use_cam else camera
        xys_offset = torch.zeros((params.capacity, 2), device=params.means.device, requires_grad=True)
        state.optimizer.zero_grad(set_to_none=True)
        if use_cam:
            state.cam_deltas.grad = None

        out = render_model(GaussianState(params, state.alive), cam, state.step, cfg.model,
                           training=True, generator=state.generator, xys_offset=xys_offset)
        mark("render")
        loss, metrics = splatfacto_loss(out.rgb, gt, cfg.ssim_lambda)
        if cfg.use_lpips and lpips is not None:
            pp, gp = sample_patches(state.generator, out.rgb, gt, cfg.patch_size, cfg.lpips_patches)
            lp = lpips(pp, gp).mean()
            loss = loss + cfg.lpips_loss_mult * lp
            metrics = dict(metrics, lpips=lp, main_loss=loss)
        mark("loss")
        loss.backward()
        mark("backward")

        # a group outside the graph (features_rest at sh_degree 0) still takes
        # an Adam update with a zero gradient, as optax does
        total_sq = 0.0
        for name in PARAM_NAMES:
            p = getattr(params, name)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            sq = (p.grad * p.grad).sum()
            metrics[f"Gradients/{name}"] = torch.sqrt(sq)
            total_sq = total_sq + sq
        metrics["Gradients/Total"] = torch.sqrt(total_sq)
        state.optimizer.step()
        if use_cam:
            state.cam_optimizer.step()
        mark("optimizer")

        img_max_dim = float(max(camera.width, camera.height))
        accumulate_stats(state.stats, xys_offset.grad, out.render.proj.radii, img_max_dim)
        mark("stats")
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["n_isects"] = out.render.bins.n_isects
        return metrics

    return train_step


def make_refine_step(cfg: TrainConfig, img_max_dim: float):
    def refine_step(state: TrainState) -> dict:
        return refine(GaussianState(state.params, state.alive), state.optimizer, state.stats,
                      state.step, cfg.densify, img_max_dim, generator=state.generator)

    return refine_step


def make_reset_opacity_step(cfg: TrainConfig):
    def reset_step(state: TrainState) -> None:
        reset_opacity(GaussianState(state.params, state.alive), state.optimizer, cfg.densify)

    return reset_step


class Trainer:
    """Host loop: sample views, step, refine at splatfacto's cadence.

    ``datamanager`` serves ``__len__``, ``next_train() -> (index, image)``,
    ``camera(i)``, ``image(i)``, ``eval_indices()``, ``width`` and
    ``height``; its cameras are on the device of ``gs``."""

    def __init__(self, gs: GaussianState, datamanager, cfg: TrainConfig = TrainConfig(),
                 lpips: Optional[torch.nn.Module] = None):
        self.cfg = cfg
        self.dm = datamanager
        self.lpips = lpips
        self.state = init_train_state(gs, cfg, num_views=len(datamanager))
        self.train_step = make_train_step(cfg, lpips=lpips)
        self.refine_step = make_refine_step(cfg, float(max(self.dm.width, self.dm.height)))
        self.reset_opacity_step = make_reset_opacity_step(cfg)
        self.step = 0
        self.history: list[dict] = []

    def _image(self, img) -> torch.Tensor:
        return torch.as_tensor(img, dtype=torch.float32, device=self.state.alive.device)

    def train(self, num_steps: int, log_every: int = 50, callback=None) -> TrainState:
        d = self.cfg.densify
        for _ in range(num_steps):
            view_idx, gt = self.dm.next_train()
            camera = self.dm.camera(view_idx)
            metrics = self.train_step(self.state, camera, self._image(gt), int(view_idx))
            self.step += 1

            # splatfacto's refinement_after cadence: densify only once every
            # image has been seen since the last opacity reset (in-cycle
            # position > num_train_data + refine_every); cull-only after
            # stop_split_at when continue_cull_post_densification; opacity
            # reset one refine-cycle after each reset_interval boundary
            if self.step > d.warmup_length and self.step % d.refine_every == 0:
                reset_interval = d.reset_alpha_every * d.refine_every
                pos = self.step % reset_interval
                do_densify = self.step < d.stop_split_at and pos > len(self.dm) + d.refine_every
                if do_densify:
                    self.refine_step(self.state)
                elif self.step >= d.stop_split_at and d.continue_cull_post_densification:
                    self.refine_step(self.state)  # cull-only
                if self.step < d.stop_split_at and pos == d.refine_every:
                    self.reset_opacity_step(self.state)

            if self.step % log_every == 0 or self.step == 1:
                names = [k for k, v in metrics.items() if torch.is_tensor(v)]
                values = torch.stack([metrics[k].float() for k in names] + [self.state.alive.sum().float()])
                values = values.tolist()  # one device sync
                m = dict(zip(names, values))
                m["n_isects"] = metrics["n_isects"]
                m["step"] = self.step
                m["n_alive"] = int(values[-1])
                dev = self.state.alive.device
                if dev.type == "cuda":
                    m["Device Memory (MB)"] = round(torch.cuda.memory_allocated(dev) / 2**20, 1)
                self.history.append(m)
                if callback:
                    callback(m)
        return self.state

    @torch.no_grad()
    def evaluate(self, view_indices=None) -> dict:
        """Mean PSNR / SSIM (+ LPIPS when weights are attached) over the
        eval views, rendered at the current step."""
        indices = list(view_indices if view_indices is not None else self.dm.eval_indices())
        gs = GaussianState(self.state.params, self.state.alive)
        acc: dict[str, float] = {}
        for idx in indices:
            gt = self._image(self.dm.image(idx))
            out = render_model(gs, self.dm.camera(idx), self.state.step, self.cfg.model)
            rgb = torch.clamp(out.rgb, 0.0, 1.0)
            m = {"eval_psnr": psnr(rgb, gt), "eval_ssim": ssim(rgb, gt)}
            if self.lpips is not None:
                m["eval_lpips"] = self.lpips(rgb[None], gt[None]).mean()
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + float(v)
        return {k: v / max(len(indices), 1) for k, v in acc.items()}

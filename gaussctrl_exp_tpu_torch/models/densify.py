"""Densify / prune / opacity reset at fixed capacity, with the alive mask.

Port of ``gaussctrl_exp_tpu/models/densify.py`` (splatfacto's refinement):

  * accumulate: per-step norms of the screen-space gradient, visibility
    counts, max 2D radii;
  * refine: high-grad & large → SPLIT into two children with scale/1.6 and
    random offsets in the gaussian's own frame (child 1 in the parent's slot,
    child 2 in a dead slot); high-grad & small → DUPLICATE into a dead slot;
    cull low-opacity and, after the first opacity-reset period, too-big
    gaussians; zero the Adam moments of every slot that received a gaussian;
  * reset_opacity: clamp opacities to logit(2·cull_alpha_thresh) and zero
    the opacity group's moments.

The tensors keep their capacity, as in the JAX package: new gaussians go
into dead slots chosen by a stable argsort of the alive mask, and demand past
the dead slots is dropped and reported. Parameters, the alive mask and the
optimizer's ``exp_avg`` / ``exp_avg_sq`` are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.quat import quat_to_rotmat
from .gaussians import PARAM_NAMES, GaussianState


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    warmup_length: int = 500
    refine_every: int = 100
    densify_grad_thresh: float = 0.0002
    densify_size_thresh: float = 0.01
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    reset_alpha_every: int = 30  # × refine_every
    stop_split_at: int = 15_000
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4_000
    split_scale_div: float = 1.6
    continue_cull_post_densification: bool = True  # splatfacto default


@dataclasses.dataclass
class DensifyStats:
    xys_grad_sum: torch.Tensor  # (C,) accumulated ||dL/dxy||
    vis_count: torch.Tensor  # (C,) int32
    max_radii2d: torch.Tensor  # (C,) max radius / max(H, W)

    @staticmethod
    def zero(capacity: int, device: str | torch.device = "cpu") -> "DensifyStats":
        return DensifyStats(
            xys_grad_sum=torch.zeros(capacity, device=device),
            vis_count=torch.zeros(capacity, dtype=torch.int32, device=device),
            max_radii2d=torch.zeros(capacity, device=device),
        )


def stats_from_numpy(xys_grad_sum, vis_count, max_radii2d, device="cpu") -> DensifyStats:
    """The JAX package's ``DensifyStats`` fields as numpy → the port's."""
    return DensifyStats(
        xys_grad_sum=torch.as_tensor(xys_grad_sum, dtype=torch.float32, device=device),
        vis_count=torch.as_tensor(vis_count, dtype=torch.int32, device=device),
        max_radii2d=torch.as_tensor(max_radii2d, dtype=torch.float32, device=device),
    )


@torch.no_grad()
def accumulate_stats(
    stats: DensifyStats, xys_grad: torch.Tensor, radii: torch.Tensor, img_max_dim: float
) -> DensifyStats:
    """Adds one step's statistics into ``stats`` in place and returns it."""
    visible = radii > 0
    norms = torch.linalg.norm(xys_grad, dim=-1)
    stats.xys_grad_sum += torch.where(visible, norms, 0.0)
    stats.vis_count += visible.to(torch.int32)
    torch.maximum(stats.max_radii2d, torch.where(visible, radii.float() / img_max_dim, 0.0),
                  out=stats.max_radii2d)
    return stats


def _adam_states(optimizer: torch.optim.Optimizer, capacity: int):
    """Every moment tensor of ``optimizer`` whose leading dim is the capacity."""
    for state in optimizer.state.values():
        for key in ("exp_avg", "exp_avg_sq"):
            t = state.get(key)
            if t is not None and t.ndim >= 1 and t.shape[0] == capacity:
                yield t


def _scatter_rows(leaf: torch.Tensor, dest: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """leaf[dest[i]] = values[i] for dest[i] < C (dest == C drops into padding)."""
    C = leaf.shape[0]
    padded = torch.cat([leaf, torch.zeros_like(leaf[:1])], dim=0)
    padded[dest] = values
    return padded[:C]


@torch.no_grad()
def refine(
    state: GaussianState,
    optimizer: torch.optim.Optimizer,
    stats: DensifyStats,
    step: int,
    cfg: DensifyConfig,
    img_max_dim: float,
    generator: Optional[torch.Generator] = None,
    noise: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> dict:
    """One refinement pass, in place on ``state``, the optimizer's moments and
    ``stats`` (zeroed). The split offsets are ``noise = (n1, n2)``, two (C, 3)
    standard normal draws, when given, else drawn from ``generator``.
    Returns the counts ``n_split``, ``n_dup``, ``n_cull``, ``n_dropped``,
    ``n_alive`` as 0-d tensors."""
    params = state.params
    alive = state.alive
    C = params.capacity
    dev = alive.device

    avg_grad = stats.xys_grad_sum / torch.clamp(stats.vis_count, min=1) * 0.5 * img_max_dim
    seen = stats.vis_count > 0
    high_grad = (avg_grad > cfg.densify_grad_thresh) & alive & seen
    scale_max = torch.exp(params.scales).amax(dim=-1)

    do_densify = step < cfg.stop_split_at
    screen_active = step < cfg.stop_screen_size_at

    split_m = scale_max > cfg.densify_size_thresh
    if screen_active:
        split_m = split_m | (stats.max_radii2d > cfg.split_screen_size)
    split_m = split_m & high_grad & do_densify
    dup_m = (scale_max <= cfg.densify_size_thresh) & high_grad & do_densify

    # cull decided on pre-densify values (split parents are replaced, not culled)
    opac = torch.sigmoid(params.opacities[:, 0])
    cull_m = (opac < cfg.cull_alpha_thresh) & alive
    toobig = scale_max > cfg.cull_scale_thresh
    if screen_active:
        toobig = toobig | (stats.max_radii2d > cfg.cull_screen_size)
    if step > cfg.refine_every * cfg.reset_alpha_every:
        cull_m = cull_m | (toobig & alive)
    cull_m = cull_m & ~split_m & ~dup_m  # slots being reused/kept by densify

    # children
    if noise is None:
        gen_dev = generator.device if generator is not None else dev
        noise = tuple(torch.randn((C, 3), generator=generator, device=gen_dev).to(dev) for _ in range(2))
    sc = torch.exp(params.scales)
    rot = quat_to_rotmat(params.quats)  # normalizes internally
    off1 = torch.einsum("nij,nj->ni", rot, noise[0].to(sc) * sc)
    off2 = torch.einsum("nij,nj->ni", rot, noise[1].to(sc) * sc)
    child_scales = torch.log(sc / cfg.split_scale_div)

    # one NEW gaussian per split (child 2) or dup (copy): allocate dead slots
    cand_m = split_m | dup_m
    order = torch.argsort(alive.to(torch.int32), stable=True)  # dead slots first, index order
    num_dead = C - alive.sum()
    cand_rank = torch.cumsum(cand_m.to(torch.int64), 0) - 1
    can_place = cand_m & (cand_rank < num_dead)
    dest = torch.where(can_place, order[torch.clamp(cand_rank, 0, C - 1)], C)

    split_c = split_m[:, None]
    src = {name: getattr(params, name) for name in PARAM_NAMES}
    src["means"] = torch.where(split_c, params.means + off2, params.means)
    src["scales"] = torch.where(split_c, child_scales, params.scales)
    # in-place child 1 for splits, then the new slots
    params.means.copy_(torch.where(split_c, params.means + off1, params.means))
    params.scales.copy_(torch.where(split_c, child_scales, params.scales))
    for name in PARAM_NAMES:
        leaf = getattr(params, name)
        leaf.copy_(_scatter_rows(leaf, dest, src[name]))

    ones = torch.ones(C, dtype=torch.bool, device=dev)
    new_alive = _scatter_rows(alive & ~cull_m, dest, ones)  # dest slots become alive
    alive.copy_(new_alive)

    # zero Adam moments at: new slots, in-place split children
    touched = _scatter_rows(torch.zeros(C, dtype=torch.bool, device=dev), dest, ones) | split_m
    for t in _adam_states(optimizer, C):
        t[touched] = 0.0

    stats.xys_grad_sum.zero_()
    stats.vis_count.zero_()
    stats.max_radii2d.zero_()
    return {
        "n_split": split_m.sum(),
        "n_dup": dup_m.sum(),
        "n_cull": cull_m.sum(),
        "n_dropped": (cand_m & ~can_place).sum(),
        "n_alive": new_alive.sum(),
    }


@torch.no_grad()
def reset_opacity(state: GaussianState, optimizer: torch.optim.Optimizer, cfg: DensifyConfig) -> None:
    """Clamp opacities to logit(2·cull_alpha_thresh) and zero the opacity
    group's moments, in place."""
    reset_val = cfg.cull_alpha_thresh * 2.0
    logit = torch.log(torch.tensor(reset_val / (1.0 - reset_val), dtype=torch.float32))
    op = state.params.opacities
    torch.minimum(op, logit.to(op.device), out=op)
    st = optimizer.state.get(op, {})
    for key in ("exp_avg", "exp_avg_sq"):
        if key in st:
            st[key].zero_()

"""Sharded rendering and training over a (data, model) grid of ranks.

Port of ``gaussctrl_exp_tpu/parallel/sharded.py`` on ``torch.distributed``:
one process per rank, each holding its shard, where the JAX package runs
``shard_map`` over a device mesh. Per rank (d, m):

  * the gaussians are sharded over ``model`` on the leading axis and
    replicated over ``data``; each ``data`` group renders one camera;
  * the rank projects and shades its own gaussians for its camera, giving
    the compact payload (xy, conic, colour, opacity, depth, and the integer
    tile box, tile count, radius and mask);
  * the payload is all-gathered over ``model`` (floats with autograd, the
    integer fields without);
  * the rank bins and blends its horizontal band of H / model rows (a
    multiple of the 16-px tile): kernel B1 on the card, behind
    ``BlendFunction`` so that the backward is kernel B2;
  * the loss is band-local with a 10-row halo (band b+1's top rows sent to
    band b, zeros to the last band), its L1 and SSIM sums reduced over
    ``model``, and its mean taken over ``data``.

The collectives are the port's own ``torch.autograd.Function``s, so that the
gradients equal the same math on a 1×1 mesh: every rank seeds the same loss
cotangent, so the sums' backward passes it through unchanged (an all-reduce
whose backward all-reduces again would scale every gradient by the group
size); the all-gather's backward leaves each rank the sum over ``model`` of
its own rows' gradients (a reduce-scatter on NCCL; on gloo, which has
none, an all-reduce and a slice); the halo is a send to the band before
and a receive from the band after, as JAX's ``ppermute``, and its backward
returns each band's halo gradient to the band it came from; and the parameters' entry sums their
gradients over ``data``, where they are replicated.

The JAX config's fields that size its TPU layout (``impl``,
``pallas_interpret``, ``isect_capacity_per_device``, ``max_per_tile``) have
no counterpart: the port's binning sizes its intersection list exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..cameras import Camera, camera_matrices
from ..models.gaussians import PARAM_NAMES, GaussianParams
from ..ops.binning import TileBins, bin_gaussians
from ..ops.blend_cuda import rasterize_tiles
from ..ops.projection import BLOCK, ProjectedGaussians, project_gaussians
from ..ops.sh import eval_sh
from ..ops.ssim import ssim_map

HALO = 10  # SSIM's 11-row window reaches 10 rows into the next band
FLOAT_FIELDS = (("xys", 2), ("conics", 3), ("colors", 3), ("opacs", 1), ("depths", 1))
INT_FIELDS = (("tile_bbox", 4), ("num_tiles_hit", 1), ("radii", 1), ("mask", 1))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a grid of ranks: each axis's size, this rank's
    index along it, and the process group of the ranks that share every
    other index (None for an axis of size 1 outside any process group)."""

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    device: torch.device


def grid_mesh(axis_names: tuple, sizes: tuple, device="cuda") -> Mesh:
    """A mesh over every rank of the default process group, through
    ``init_device_mesh``; a mesh of one rank needs no process group."""
    device = torch.device(device)
    if all(n == 1 for n in sizes) and not dist.is_initialized():
        return Mesh(tuple(axis_names), dict.fromkeys(axis_names, 1), dict.fromkeys(axis_names, 0),
                    dict.fromkeys(axis_names), device)
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"a {sizes} mesh needs torch.distributed initialised "
                           "(parallel.distributed.initialize_distributed)")
    if dist.get_world_size() != int(torch.tensor(sizes).prod()):
        raise ValueError(f"a {sizes} mesh needs {int(torch.tensor(sizes).prod())} ranks, "
                         f"have {dist.get_world_size()}")
    dm = init_device_mesh(device.type, tuple(sizes), mesh_dim_names=tuple(axis_names))
    return Mesh(tuple(axis_names), dict(zip(axis_names, sizes)),
                {a: dm.get_local_rank(a) for a in axis_names}, {a: dm.get_group(a) for a in axis_names}, device)


def make_mesh(data: int, model: int, device="cuda") -> Mesh:
    """The (data, model) mesh; rank r sits at (r // model, r % model)."""
    return grid_mesh(("data", "model"), (data, model), device)


@dataclasses.dataclass(frozen=True)
class ShardedRenderConfig:
    height: int = 512
    width: int = 512
    sh_degree: int = 3
    ssim_lambda: float = 0.2


# ---------------------------------------------------------------- collectives


class _AllGather(torch.autograd.Function):
    """Concatenate every rank's rows; backward: the sum over ranks of the
    gradient of this rank's rows (a reduce-scatter on NCCL; gloo has none,
    so there an all-reduce and this rank's slice)."""

    @staticmethod
    def forward(ctx, x, group):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if dist.get_backend(ctx.group) == "nccl":
            out = g.new_empty((ctx.rows, *g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, group=ctx.group)
            return out, None
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.rows : (ctx.rank + 1) * ctx.rows], None


class _Sum(torch.autograd.Function):
    """The sum over ranks of a value whose result every rank holds alike:
    the backward passes the (replicated) cotangent through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Mean(torch.autograd.Function):
    """The mean over ranks, replicated: the backward divides by their count."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Replicated(torch.autograd.Function):
    """A tensor every rank of the group holds alike: forward the identity,
    backward the sum of its gradients over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _shift(x: torch.Tensor, group, down: bool) -> torch.Tensor:
    """Point to point along the group: each rank sends ``x`` to the rank
    before it (``down``) or after it and returns what it receives from the
    other side; a rank with no neighbour there receives zeros."""
    n, b = dist.get_world_size(group), dist.get_rank(group)
    src, dst = (b + 1, b - 1) if down else (b - 1, b + 1)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops) if ops else []:
        req.wait()
    return out


class _HaloUp(torch.autograd.Function):
    """Rank b receives rank b+1's rows (the last rank zeros); backward: rank
    b's rows get the gradient of the halo rank b−1 received."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, down=True)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, down=False), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllGather.apply(x, group)


def all_gather_rows_nograd(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Sum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Mean.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Replicated.apply(x, group)


def halo_from_next(x: torch.Tensor, group) -> torch.Tensor:
    return torch.zeros_like(x) if group is None else _HaloUp.apply(x, group)


# ---------------------------------------------------------------- render


def project_local(params: GaussianParams, alive: torch.Tensor, cam: Camera, step: int,
                  cfg: ShardedRenderConfig) -> dict:
    """Project and shade this rank's gaussians for one camera: the payload
    (float fields differentiable, integer fields not)."""
    viewmat, _, fullmat = camera_matrices(cam)
    opacs = torch.sigmoid(params.opacities[:, 0])
    proj = project_gaussians(params.means, torch.exp(params.scales), 1.0, params.quats, viewmat, fullmat,
                             cam.fx, cam.fy, cam.cx, cam.cy, cfg.height, cfg.width, extra_mask=alive,
                             opacities=opacs)
    coeffs = torch.cat([params.features_dc[:, None, :], params.features_rest], dim=1)
    viewdirs = params.means.detach() - cam.c2w[:3, 3]
    viewdirs = viewdirs / torch.clamp(torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
    rgb = eval_sh(min(int(step) // 1000, cfg.sh_degree), viewdirs, coeffs) + 0.5
    colors = torch.maximum(rgb, rgb.new_zeros(()))  # a tie passes half the gradient, as jnp.maximum
    return dict(xys=proj.xys, conics=proj.conics, colors=colors, opacs=opacs, depths=proj.depths,
                tile_bbox=proj.tile_bbox, num_tiles_hit=proj.num_tiles_hit, radii=proj.radii, mask=proj.mask)


def gather_payload(payload: dict, group) -> dict:
    """All-gather the payload over ``group``: the float fields as one
    (N, 10) tensor with autograd, the integer fields as one without."""
    floats = torch.cat([payload[k].reshape(payload[k].shape[0], w) for k, w in FLOAT_FIELDS], dim=1)
    ints = torch.cat([payload[k].reshape(payload[k].shape[0], w).to(torch.int32) for k, w in INT_FIELDS], dim=1)
    floats, ints = all_gather_rows(floats, group), all_gather_rows_nograd(ints, group)
    out, i = {}, 0
    for k, w in FLOAT_FIELDS:
        out[k] = floats[:, i : i + w] if w > 1 else floats[:, i]
        i += w
    i = 0
    for k, w in INT_FIELDS:
        out[k] = ints[:, i : i + w] if w > 1 else ints[:, i]
        i += w
    out["mask"] = out["mask"].bool()
    return out


def band_payload(payload: dict, band: int, n_bands: int, cfg: ShardedRenderConfig) -> dict:
    """The full payload re-binned into band ``band``'s local frame: tile
    boxes clipped to its tile rows and shifted to start at 0, gaussians that
    miss it masked, centres shifted up by the band's first row."""
    Hb = cfg.height // n_bands
    ty0, ty1 = band * (Hb // BLOCK), (band + 1) * (Hb // BLOCK)
    bb = payload["tile_bbox"]
    y0 = torch.clamp(bb[:, 1], ty0, ty1) - ty0
    y1 = torch.clamp(bb[:, 3], ty0, ty1) - ty0
    in_band = (y1 > y0) & payload["mask"]
    bbox = torch.where(in_band[:, None], torch.stack([bb[:, 0], y0, bb[:, 2], y1], dim=-1), 0)
    area = (bbox[:, 2] - bbox[:, 0]) * (bbox[:, 3] - bbox[:, 1])
    shift = torch.tensor([0.0, float(band * Hb)], dtype=payload["xys"].dtype, device=bb.device)
    return dict(payload, tile_bbox=bbox.to(torch.int32), num_tiles_hit=torch.where(in_band, area, 0).to(torch.int32),
                mask=in_band, radii=torch.where(in_band, payload["radii"], 0), xys=payload["xys"] - shift)


def band_blend(payload: dict, n_bands: int, cfg: ShardedRenderConfig) -> tuple[torch.Tensor, torch.Tensor, TileBins]:
    """Bin and blend one band from its re-binned payload (``band_payload``):
    (band image (Hb, W, 4), band final transmittance (Hb, W), its bins).
    Kernel B1 on the card (B2 behind it when autograd records), the plain
    blend on the CPU."""
    Hb, W = cfg.height // n_bands, cfg.width
    proj = ProjectedGaussians(xys=payload["xys"], depths=payload["depths"], radii=payload["radii"],
                              conics=payload["conics"], num_tiles_hit=payload["num_tiles_hit"], cov3d=None,
                              mask=payload["mask"], tile_bbox=payload["tile_bbox"])
    bins = bin_gaussians(proj, (W + BLOCK - 1) // BLOCK, Hb // BLOCK)
    chan = torch.cat([payload["colors"], payload["depths"][:, None]], dim=-1)
    out = rasterize_tiles(payload["xys"].contiguous(), payload["conics"].contiguous(), chan,
                          payload["opacs"].contiguous(), bins, Hb, W)
    return out.img, out.final_T, bins


def make_sharded_render_loss(mesh: Mesh, cfg: ShardedRenderConfig) -> Callable:
    """``loss_fn(params, alive, camera_arrays, gt, step)``: ``params`` and
    ``alive`` are this rank's shard (``shard_params``); ``camera_arrays`` is
    (c2w (data, 3, 4), fx, fy, cx, cy (data,)) and ``gt`` (data, H, W, 3),
    of which the rank takes its data group's entry. Returns the loss, the
    same on every rank, differentiable with respect to the shard.
    ``loss_fn.last`` keeps the rank's band bins of the last call."""
    n_model = mesh.shape["model"]
    H, W = cfg.height, cfg.width
    if H % n_model or (H // n_model) % BLOCK:
        raise ValueError(f"band height {H}/{n_model} must be a multiple of {BLOCK}")
    Hb = H // n_model
    g_model, g_data = mesh.groups["model"], mesh.groups["data"]

    def loss_fn(params: GaussianParams, alive: torch.Tensor, camera_arrays, gt: torch.Tensor, step: int):
        band, d = mesh.coords["model"], mesh.coords["data"]
        params = GaussianParams(**{n: replicated(getattr(params, n), g_data) for n in PARAM_NAMES})
        c2w, fx, fy, cx, cy = camera_arrays
        cam = Camera(c2w=c2w[d], fx=fx[d], fy=fy[d], cx=cx[d], cy=cy[d], width=W, height=H)
        payload = gather_payload(project_local(params, alive, cam, step, cfg), g_model)
        img, _, bins = band_blend(band_payload(payload, band, n_model, cfg), n_model, cfg)
        loss_fn.last = bins
        band_rgb = torch.minimum(img[..., :3], img.new_ones(()))  # black background

        # band-local loss: each band computes the SSIM rows that start in it,
        # with its lower neighbour's first HALO rows
        pred_pad = torch.cat([band_rgb, halo_from_next(band_rgb[:HALO], g_model)], dim=0)
        gt_pad = torch.nn.functional.pad(gt[d], (0, 0, 0, 0, 0, HALO))
        gt_band = gt_pad[band * Hb : band * Hb + Hb + HALO]
        l1_sum = (band_rgb - gt_band[:Hb]).abs().sum()
        smap = ssim_map(pred_pad, gt_band)  # (Hb, W − 10, 3)
        row_valid = (band * Hb + torch.arange(Hb, device=smap.device)) < (H - HALO)
        ssim_sum = torch.where(row_valid[:, None, None], smap, 0.0).sum()
        ssim_cnt = row_valid.sum().to(smap.dtype) * smap.shape[1] * smap.shape[2]

        l1 = psum(l1_sum, g_model) / (H * W * 3)
        ssim_val = psum(ssim_sum, g_model) / psum(ssim_cnt, g_model)
        loss_local = (1 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * (1 - ssim_val)
        return pmean(loss_local, g_data)

    loss_fn.last = None
    return loss_fn


def make_sharded_train_step(mesh: Mesh, cfg: ShardedRenderConfig, optimizer: torch.optim.Optimizer) -> Callable:
    """``step_fn(params, alive, camera_arrays, gt, step) -> loss``: one step
    of ``optimizer`` (a torch optimizer over this rank's shard, in place of
    the JAX package's optax one) on the sharded loss; the shard is updated
    in place. ``step_fn.loss_fn`` is the loss it differentiates."""
    loss_fn = make_sharded_render_loss(mesh, cfg)

    def step_fn(params: GaussianParams, alive: torch.Tensor, camera_arrays, gt: torch.Tensor, step: int):
        optimizer.zero_grad(set_to_none=False)
        loss = loss_fn(params, alive, camera_arrays, gt, step)
        loss.backward()
        for n in PARAM_NAMES:  # a group outside the graph still steps, on a zero gradient
            p = getattr(params, n)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    step_fn.loss_fn = loss_fn
    return step_fn


def shard_params(params: GaussianParams, alive: torch.Tensor, mesh: Mesh) -> tuple[GaussianParams, torch.Tensor]:
    """This rank's shard on ``mesh.device``: the capacity padded with zeros
    (not alive) to a multiple of ``model``, then the rank's contiguous
    slice of it, as leaf tensors that require grad."""
    n_model, m = mesh.shape["model"], mesh.coords["model"]
    C = params.capacity
    pad = (-C) % n_model
    rows = (C + pad) // n_model

    def local(x):
        x = torch.cat([x.detach(), x.new_zeros((pad, *x.shape[1:]))]) if pad else x.detach()
        return x[m * rows : (m + 1) * rows].to(mesh.device).clone()

    shard = GaussianParams(**{n: local(getattr(params, n)).requires_grad_() for n in PARAM_NAMES})
    return shard, local(alive)

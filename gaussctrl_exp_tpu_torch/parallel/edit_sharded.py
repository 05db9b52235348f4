"""The edit denoise with its views sharded over ranks: only the four
reference views' K/V cross ranks.

Port of ``gaussctrl_exp_tpu/parallel/edit_sharded.py`` on
``torch.distributed``. Every rank denoises its V / n views; its CFG batch
is laid out (unet_chunk_size, Vl, …) as the unsharded processor's. In each
self-attention, the AttnAlign references (global views 0..3) are rebuilt on
every rank: each rank places its own views' K/V into the four reference
slots with a one-hot einsum (zeros elsewhere), and a sum over the view group
completes them. Then come the same five ``_sdpa`` calls as
``diffusion.attention.make_cross_view_processor`` (self, then one per
reference view), which go to kernel B3 on the card. The one-hot products
and the sum of zeros are exact, so a rank's output is the unsharded
processor's on its views. No gradient flows here: the generation runs under
``torch.no_grad``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..diffusion.attention import Processor, _sdpa
from .sharded import Mesh, grid_mesh


def make_view_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A one-axis ("views",) mesh over ``n_devices`` ranks (all by default)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return grid_mesh(("views",), (n,), device)


def sharded_cross_view_processor(self_attn_coeff: float, num_ref_views: int = 4, unet_chunk_size: int = 2,
                                 mesh: Mesh | None = None) -> Processor:
    """AttnAlign for a view-sharded batch: the math of
    ``make_cross_view_processor``, the reference K/V rebuilt by a one-hot
    einsum and a sum over ``mesh``'s view group."""
    group = mesh.groups["views"] if mesh is not None else None
    rank = mesh.coords["views"] if mesh is not None else 0

    def processor(q, k, v, is_cross: bool) -> torch.Tensor:
        if is_cross:
            return _sdpa(q, k, v)
        Bl, H, S, D = q.shape
        Vl = Bl // unet_chunk_size  # this rank's views
        kg = k.reshape(unet_chunk_size, Vl, H, S, D)
        vg = v.reshape(unet_chunk_size, Vl, H, S, D)
        gidx = rank * Vl + torch.arange(Vl, device=k.device)
        onehot = (torch.arange(num_ref_views, device=k.device)[:, None] == gidx[None, :]).to(k.dtype)
        refs_k = torch.einsum("rv,cvhsd->crhsd", onehot, kg).contiguous()  # NCCL reduces contiguous tensors
        refs_v = torch.einsum("rv,cvhsd->crhsd", onehot, vg).contiguous()
        if group is not None:
            dist.all_reduce(refs_k, group=group)
            dist.all_reduce(refs_v, group=group)
        out_self = _sdpa(q, k, v)
        ref_outs = []
        for r in range(num_ref_views):
            k_r = refs_k[:, r : r + 1].expand(kg.shape).reshape(Bl, H, S, D)
            v_r = refs_v[:, r : r + 1].expand(vg.shape).reshape(Bl, H, S, D)
            ref_outs.append(_sdpa(q, k_r, v_r))
        out_ref = torch.stack(ref_outs).mean(0)
        return self_attn_coeff * out_self + (1.0 - self_attn_coeff) * out_ref

    return processor


def make_sharded_generate(mesh: Mesh, pipe, self_attn_coeff: float = 0.6, num_ref_views: int = 4):
    """CFG generation of this rank's views: ``run(latents, ctx_cond,
    ctx_uncond, hint, guidance_scale, num_steps)`` takes this rank's slices
    (``shard_views``) of (V, …) inputs whose first ``num_ref_views`` views
    are the references, and returns this rank's generated latents. The
    models are every rank's own full copy."""
    proc = sharded_cross_view_processor(self_attn_coeff, num_ref_views, mesh=mesh)

    def run(latents, ctx_cond, ctx_uncond, hint, guidance_scale: float, num_steps: int) -> torch.Tensor:
        return pipe.generate(latents, ctx_cond, ctx_uncond, hint, guidance_scale, num_steps=num_steps,
                             processor=proc)

    return run


def shard_views(mesh: Mesh, *arrays) -> tuple:
    """This rank's contiguous slice of each (V, …) array, on the mesh's
    device; V must divide among the ranks."""
    n, r = mesh.shape["views"], mesh.coords["views"]
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        if a.shape[0] % n:
            raise ValueError(f"{a.shape[0]} views do not divide among {n} ranks")
        Vl = a.shape[0] // n
        out.append(a[r * Vl : (r + 1) * Vl].to(mesh.device))
    return tuple(out)

"""One rank of the port's multi-process parallel tests (gloo on the CPU).

Usage: python tests/torch_parallel_worker.py <job> <rank> <world> <dir>

The process group meets through a FileStore in ``<dir>`` (no TCP port, so
concurrent test workers cannot clash). Inputs come from ``<dir>/inputs.npz``
(and, for the edit job, ``<dir>/models.pt``); each rank writes
``<dir>/<job>_rank<r>.npz``. Jobs:

  sharded  the collectives' gradients on a 1×4 model group; the sharded
           loss and gradients on a 2×2 mesh and a 1×4 mesh (camera 0), with
           every band's bins; one Adam step on the 2×2 mesh
  edit     the view-sharded AttnAlign processor on random q, k, v, and the
           view-sharded generation on the tiny SD stack
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from gaussctrl_exp_tpu_torch.models.gaussians import PARAM_NAMES, GaussianParams  # noqa: E402
from gaussctrl_exp_tpu_torch.parallel import sharded as S  # noqa: E402
from gaussctrl_exp_tpu_torch.parallel.distributed import initialize_distributed, make_global_mesh  # noqa: E402


def collective_grads(rank: int, world: int) -> dict:
    """Each Function on a group of ``world`` ranks, fed rank-seeded inputs
    and weights: out[name] is the forward, out[name + "_grad"] the input's
    gradient."""
    group = dist.group.WORLD
    g = torch.Generator().manual_seed(100 + rank)
    out = {}
    for name, fn, shape in [("gather", S.all_gather_rows, (3, 2)), ("halo", S.halo_from_next, (2, 3)),
                            ("sum", S.psum, (4,)), ("mean", S.pmean, (4,)), ("replicated", S.replicated, (4,))]:
        x = torch.randn(shape, generator=torch.Generator().manual_seed(7 if name == "replicated" else rank))
        x.requires_grad_()
        y = fn(x, group)
        w = torch.randn(y.shape, generator=g)
        if name in ("sum", "mean"):  # a replicated scalar loss: every rank seeds the same cotangent
            y = fn((x * w).sum(), group)
            y.backward()
        else:
            (y * w).sum().backward()
        out[name], out[name + "_w"], out[name + "_grad"] = y.detach().numpy(), w.numpy(), x.grad.numpy()
    return out


def sharded_job(rank: int, world: int, d: Path) -> dict:
    inp = np.load(d / "inputs.npz")
    out = collective_grads(rank, world)
    cfg = S.ShardedRenderConfig(height=int(inp["H"]), width=int(inp["W"]), sh_degree=int(inp["sh_degree"]))
    params = GaussianParams(**{n: torch.tensor(inp[n]) for n in PARAM_NAMES})
    alive = torch.as_tensor(inp["alive"])
    cams = tuple(torch.as_tensor(inp[k]) for k in ("c2w", "fx", "fy", "cx", "cy"))
    gt = torch.as_tensor(inp["gt"])
    for tag, (data, model) in (("2x2", (2, 2)), ("1x4", (1, 4))):
        mesh = make_global_mesh(data, model, device="cpu")
        cam_d = cams if data == 2 else tuple(c[:1] for c in cams)
        shard, al = S.shard_params(params, alive, mesh)
        loss_fn = S.make_sharded_render_loss(mesh, cfg)
        loss = loss_fn(shard, al, cam_d, gt[:data], int(inp["step"]))
        loss.backward()
        out[f"{tag}_loss"] = loss.detach().numpy()
        out[f"{tag}_coords"] = np.array([mesh.coords["data"], mesh.coords["model"]])
        bins = loss_fn.last
        out[f"{tag}_n_isects"], out[f"{tag}_tile_cnt_max"] = bins.n_isects, int(bins.tile_cnt.max())
        for n in PARAM_NAMES:
            out[f"{tag}_grad_{n}"] = getattr(shard, n).grad.numpy()
        if tag == "2x2":
            shard, al = S.shard_params(params, alive, mesh)
            opt = torch.optim.Adam([getattr(shard, n) for n in PARAM_NAMES], lr=float(inp["lr"]))
            step_fn = S.make_sharded_train_step(mesh, cfg, opt)
            out["adam_loss"] = step_fn(shard, al, cam_d, gt[:data], int(inp["step"])).numpy()
            for n in PARAM_NAMES:
                out[f"adam_{n}"] = getattr(shard, n).detach().numpy()
    return out


def edit_job(rank: int, world: int, d: Path) -> dict:
    from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDControlNetPipeline
    from gaussctrl_exp_tpu_torch.parallel.edit_sharded import (
        make_sharded_generate,
        make_view_mesh,
        shard_views,
        sharded_cross_view_processor,
    )

    inp = np.load(d / "inputs.npz")
    mesh = make_view_mesh(device="cpu")
    q, k, v = shard_views(mesh, *(torch.as_tensor(inp[n]) for n in ("q", "k", "v")))  # (V, 2, H, S, D)
    Vl, H, Sq, D = q.shape[0], *q.shape[2:]

    def local(x):  # (Vl, 2, …) → the CFG batch (2·Vl, …), laid out (2, Vl, …)
        return x.transpose(0, 1).reshape(2 * Vl, H, Sq, D)

    with torch.no_grad():
        got = sharded_cross_view_processor(0.6, mesh=mesh)(local(q), local(k), local(v), False)
    out = {"proc": got.reshape(2, Vl, H, Sq, D).transpose(0, 1).numpy()}
    pipe = SDControlNetPipeline(torch.load(d / "models.pt", weights_only=False))
    lat, cc, cu, hint = shard_views(mesh, *(torch.as_tensor(inp[n]) for n in ("lat", "ctx_c", "ctx_u", "hint")))
    run = make_sharded_generate(mesh, pipe, self_attn_coeff=0.6)
    out["gen"] = run(lat, cc, cu, hint, float(inp["guidance"]), int(inp["steps"])).numpy()
    return out


def main():
    job, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    os.environ.update(GCTPU_COORDINATOR=f"file://{d / 'store'}", GCTPU_NUM_PROCESSES=str(world),
                      GCTPU_PROCESS_ID=str(rank))
    assert initialize_distributed(device="cpu") == (world > 1)
    assert initialize_distributed(device="cpu") == (world > 1)  # idempotent
    out = {"sharded": sharded_job, "edit": edit_job}[job](rank, world, d)
    np.savez(d / f"{job}_rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

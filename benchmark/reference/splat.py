"""Plain reference of the splat path: camera matrices, EWA projection (gsplat
v0.1.2's ``project_gaussians``), spherical harmonics, tile binning, the
front-to-back tile blend, the training loss (L1, SSIM, patch LPIPS) and Adam.

Written from the published descriptions (gsplat v0.1.2, 3D Gaussian
Splatting, nerfstudio's splatfacto, LPIPS over VGG16, optax's Adam). The
blend is tensor algebra over each tile's depth-sorted list: a pixel takes a
gaussian when its alpha ≥ 1/255 and the transmittance after it stays above
1e-4; autograd differentiates it, with alpha's clamp at 0.999 passed through
as gsplat's backward does. Everything computes in ``dtype`` (float32 for the
reference, bfloat16 for the control) with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 16
NEAR, FAR = 0.001, 1000.0
MIN_ALPHA, ALPHA_MAX, T_EPS = 1.0 / 255.0, 0.999, 1e-4
EMPTY_DEPTH = 1000.0
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


# ------------------------------------------------------------------ cameras
def camera_matrices(cam: dict, dtype=torch.float32, device="cpu"):
    """(viewmat, fullmat) of a camera {c2w (3, 4) OpenGL, fx, fy, cx, cy, W, H}:
    the y and z axes flipped to +z forward, and the splatfacto projection."""
    c2w = torch.as_tensor(np.asarray(cam["c2w"], np.float64), device=device)
    R = c2w[:3, :3] @ torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=torch.float64, device=device))
    view = torch.eye(4, dtype=torch.float64, device=device)
    view[:3, :3] = R.T
    view[:3, 3] = -R.T @ c2w[:3, 3]
    r = NEAR * cam["W"] / (2.0 * cam["fx"])  # near · tan(fovx / 2)
    t = NEAR * cam["H"] / (2.0 * cam["fy"])
    proj = torch.tensor([[NEAR / r, 0, 0, 0], [0, NEAR / t, 0, 0],
                         [0, 0, (FAR + NEAR) / (FAR - NEAR), -FAR * NEAR / (FAR - NEAR)], [0, 0, 1, 0]],
                        dtype=torch.float64, device=device)
    return view.to(dtype), (proj @ view).to(dtype)


# --------------------------------------------------------------- projection
def quat_rotmat(qt):
    qt = qt / torch.clamp(qt.norm(dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = qt.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def project(means, scales, quats, cam, dtype=torch.float32, clip=0.01):
    """→ dict(xys (N, 2), depth (N,), conic (N, 3), rect (N, 4) tile range
    [x0, y0, x1, y1), visible (N,))."""
    dev = means.device
    view, full = camera_matrices(cam, dtype, dev)
    fx, fy, cx, cy, W, H = (cam[k] for k in ("fx", "fy", "cx", "cy", "W", "H"))
    pv = means @ view[:3, :3].T + view[:3, 3]
    z = pv[:, 2]
    front = z > clip
    zs = torch.where(front, z, torch.ones_like(z))
    Rm = quat_rotmat(quats)
    M = Rm * scales[:, None, :]
    cov3 = M @ M.transpose(1, 2)
    lx, ly = 1.3 * 0.5 * W / fx, 1.3 * 0.5 * H / fy
    tx = torch.clamp(pv[:, 0] / zs, -lx, lx) * zs
    ty = torch.clamp(pv[:, 1] / zs, -ly, ly) * zs
    J = torch.zeros((means.shape[0], 2, 3), dtype=dtype, device=dev)
    J[:, 0, 0] = fx / zs
    J[:, 0, 2] = -fx * tx / (zs * zs)
    J[:, 1, 1] = fy / zs
    J[:, 1, 2] = -fy * ty / (zs * zs)
    T = J @ view[:3, :3]
    cov2 = T @ cov3 @ T.transpose(1, 2)
    a, b, c = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det != 0
    dets = torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c / dets, -b / dets, a / dets], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    ph = means @ full[:3, :3].T + full[:3, 3]
    w = 1.0 / (means @ full[3, :3] + full[3, 3] + 1e-6)
    xys = torch.stack([0.5 * W * ph[:, 0] * w + cx - 0.5, 0.5 * H * ph[:, 1] * w + cy - 0.5], -1)
    nx, ny = (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK

    def tile(v, n):  # truncated toward zero, clamped to [0, n]
        return torch.clamp(torch.clamp(v, -1.0, n + 1.0).to(torch.int64), 0, n)

    rect = torch.stack([tile((xys[:, 0] - radius) / BLOCK, nx), tile((xys[:, 1] - radius) / BLOCK, ny),
                        tile((xys[:, 0] + radius) / BLOCK + 1.0, nx), tile((xys[:, 1] + radius) / BLOCK + 1.0, ny)], -1)
    area = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
    return dict(xys=xys, depth=z, conic=conic, rect=rect, visible=front & ok & (area > 0))


# -------------------------------------------------------- spherical harmonics
def sh_colors(coeffs, dirs, degree):
    """(N, 16, 3) coefficients at unit directions (N, 3), bands up to
    ``degree`` → colour + 0.5, floored at 0."""
    x, y, z = dirs.unbind(-1)
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                  SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z, SH_C3[2] * y * (4 * zz - xx - yy),
                  SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    B = torch.stack(basis, -1)
    rgb = (B[..., None] * coeffs[:, : B.shape[-1]]).sum(1)
    return torch.clamp_min(rgb + 0.5, 0.0)


# ------------------------------------------------------------------ binning
def bin_tiles(p: dict, W: int, H: int):
    """Tile lists: the visible gaussians whose tile range holds each tile, by
    increasing depth (ties by index) → (ids, starts, counts) over tiles."""
    nx, ny = (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK
    vis = torch.nonzero(p["visible"]).squeeze(1)
    vis = vis[torch.sort(p["depth"][vis].float(), stable=True).indices]
    r = p["rect"][vis]
    w = r[:, 2] - r[:, 0]
    n = w * (r[:, 3] - r[:, 1])
    rank = torch.repeat_interleave(torch.arange(vis.numel(), device=vis.device), n)
    k = torch.arange(rank.numel(), device=vis.device) - (torch.cumsum(n, 0) - n)[rank]
    tile = (r[rank, 1] + k // w[rank]) * nx + r[rank, 0] + k % w[rank]
    key = tile * (vis.numel() + 1) + rank
    order = torch.sort(key).indices
    ids = vis[rank[order]]
    counts = torch.bincount(tile, minlength=nx * ny)
    return ids, torch.cumsum(counts, 0) - counts, counts


class _PassClamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.clamp(x, max=ALPHA_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


def tile_alphas(xys, conic, opac, ids, valid, px, py):
    """Alphas of tile lists ``ids`` (B, K) at pixels (B, P) → (B, P, K), 0 where skipped."""
    d = xys[ids]
    dx = d[:, None, :, 0] - px[:, :, None]
    dy = d[:, None, :, 1] - py[:, :, None]
    cn = conic[ids]
    sig = 0.5 * (cn[:, None, :, 0] * dx * dx + cn[:, None, :, 2] * dy * dy) + cn[:, None, :, 1] * dx * dy
    alpha = _PassClamp.apply(opac[ids][:, None, :] * torch.exp(-sig))
    keep = (sig >= 0) & (alpha >= MIN_ALPHA) & valid[:, None, :]
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def blend(xys, conic, opac, feats, bins, W, H, batch_elems: int = 1 << 23):
    """Front-to-back composite of ``feats`` (N, C) → (img (H, W, C), T (H, W))."""
    ids, starts, counts = bins
    nx, ny = (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK
    P = BLOCK * BLOCK
    C = feats.shape[1]
    dev, dt = feats.device, feats.dtype
    cnt = counts.tolist()
    img_t, T_t, tiles = [], [], []
    lin = torch.arange(P, device=dev)
    t0 = 0
    while t0 < nx * ny:
        t1, K = t0 + 1, cnt[t0]
        while t1 < nx * ny and (t1 + 1 - t0) * max(K, cnt[t1]) * P <= batch_elems:
            K = max(K, cnt[t1])
            t1 += 1
        tid = torch.arange(t0, t1, device=dev)
        px = ((tid % nx)[:, None] * BLOCK + lin % BLOCK).to(dt)
        py = ((tid // nx)[:, None] * BLOCK + lin // BLOCK).to(dt)
        if K == 0:
            img_t.append(torch.zeros((t1 - t0, P, C), dtype=dt, device=dev))
            T_t.append(torch.ones((t1 - t0, P), dtype=dt, device=dev))
        else:
            ks = torch.arange(K, device=dev)
            valid = ks[None] < counts[t0:t1, None]
            g = ids[torch.where(valid, starts[t0:t1, None] + ks[None], 0)]
            a = tile_alphas(xys, conic, opac, g, valid, px, py)
            Tafter = torch.cumprod(1.0 - a, -1)
            take = (Tafter > T_EPS) & (a > 0)
            wgt = torch.where(take, a * Tafter / (1.0 - a), torch.zeros_like(a))
            img_t.append(torch.bmm(wgt, feats[g]))
            T_t.append(torch.where(take, Tafter, torch.ones_like(Tafter)).amin(-1))
        tiles.append(tid)
        t0 = t1
    img = torch.cat(img_t).reshape(ny, nx, BLOCK, BLOCK, C).permute(0, 2, 1, 3, 4).reshape(ny * BLOCK, nx * BLOCK, C)
    T = torch.cat(T_t).reshape(ny, nx, BLOCK, BLOCK).permute(0, 2, 1, 3).reshape(ny * BLOCK, nx * BLOCK)
    return img[:H, :W], T[:H, :W]


def render(g: dict, cam: dict, step: int, background, depth: bool = True, dtype=torch.float32,
           sh_interval: int = 1000, sh_degree: int = 3):
    """Splatfacto's render of gaussians ``g`` (raw parameters: means, scales
    (log), quats, features_dc, features_rest, opacities (logit), alive) →
    dict(rgb (H, W, 3), alpha (H, W), depth (H, W) or None, bins, proj)."""
    cast = {k: v.to(dtype) if v.is_floating_point() else v for k, v in g.items()}
    means, scales = cast["means"], torch.exp(cast["scales"])
    opac = torch.sigmoid(cast["opacities"][:, 0])
    p = project(means, scales, cast["quats"], cam, dtype)
    p["visible"] = p["visible"] & g["alive"]
    campos = torch.as_tensor(np.asarray(cam["c2w"], np.float64)[:3, 3], dtype=dtype, device=means.device)
    dirs = means.detach() - campos
    dirs = dirs / torch.clamp(dirs.norm(dim=-1, keepdim=True), min=1e-12)
    coeffs = torch.cat([cast["features_dc"][:, None], cast["features_rest"]], 1)
    rgbs = sh_colors(coeffs, dirs, min(int(step) // sh_interval, sh_degree))
    feats = torch.cat([rgbs, p["depth"][:, None]], 1) if depth else rgbs
    W, H = cam["W"], cam["H"]
    bins = bin_tiles(p, W, H)
    img, T = blend(p["xys"], p["conic"], opac, feats, bins, W, H)
    rgb = torch.minimum(img[..., :3] + T[..., None] * background.to(dtype), torch.ones((), dtype=dtype,
                                                                                        device=img.device))
    alpha = 1.0 - T
    d = None
    if depth:
        cov = alpha > 0
        d = torch.where(cov, img[..., 3] / torch.where(cov, alpha, torch.ones_like(alpha)), EMPTY_DEPTH)
    return dict(rgb=rgb, alpha=alpha, depth=d, bins=bins, proj=p, opac=opac)


# ---------------------------------------------------------------- the loss
def ssim(a, b, size: int = 11, sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Mean SSIM of (H, W, C) images in [0, 1] over the valid windows."""
    x = np.arange(size) - (size - 1) / 2
    g1 = np.exp(-(x**2) / (2 * sigma**2))
    g1 /= g1.sum()
    k = torch.as_tensor(np.outer(g1, g1), dtype=a.dtype, device=a.device)
    C = a.shape[-1]
    kern = k[None, None].expand(C, 1, size, size)

    def filt(t):
        return F.conv2d(t.permute(2, 0, 1)[None], kern, groups=C)[0]

    ma, mb = filt(a), filt(b)
    va, vb, cab = filt(a * a) - ma * ma, filt(b * b) - mb * mb, filt(a * b) - ma * mb
    c1, c2 = k1**2, k2**2
    return (((2 * ma * mb + c1) * (2 * cab + c2)) / ((ma * ma + mb * mb + c1) * (va + vb + c2))).mean()


VGG_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def lpips_spec() -> dict:
    """LPIPS-VGG16's parameters: name → (shape, initialiser)."""
    spec, ci, cin = {}, 0, 3
    for widths in VGG_BLOCKS:
        for w in widths:
            spec[f"vgg.convs.conv_{ci}.weight"] = ((w, cin, 3, 3), ("normal", math.sqrt(2.0 / (9 * cin))))
            spec[f"vgg.convs.conv_{ci}.bias"] = ((w,), ("zero",))
            cin, ci = w, ci + 1
    for li, widths in enumerate(VGG_BLOCKS):
        spec[f"lins.{li}.weight"] = ((1, widths[-1], 1, 1), ("normal", 1.0 / widths[-1]))
    return spec


def lpips(Wt: dict, a, b):
    """LPIPS distance of (B, H, W, 3) images in [0, 1] → (B,)."""
    dt = a.dtype
    shift = torch.tensor(LPIPS_SHIFT, dtype=dt, device=a.device)[None, :, None, None]
    scale = torch.tensor(LPIPS_SCALE, dtype=dt, device=a.device)[None, :, None, None]

    def feats(x):
        x = ((x.permute(0, 3, 1, 2) * 2 - 1) - shift) / scale
        out, ci = [], 0
        for bi, widths in enumerate(VGG_BLOCKS):
            for _ in widths:
                x = F.relu(F.conv2d(x, Wt[f"vgg.convs.conv_{ci}.weight"].to(dt), Wt[f"vgg.convs.conv_{ci}.bias"].to(dt),
                                    padding=1))
                ci += 1
            out.append(x)
            if bi < len(VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2)
        return out

    total = 0.0
    for li, (fa, fb) in enumerate(zip(feats(a), feats(b))):
        fa = fa / torch.clamp(fa.norm(dim=1, keepdim=True), min=1e-10)
        fb = fb / torch.clamp(fb.norm(dim=1, keepdim=True), min=1e-10)
        total = total + F.conv2d((fa - fb) ** 2, Wt[f"lins.{li}.weight"].to(dt)).mean((1, 2, 3))
    return total


# ------------------------------------------------------------------- Adam
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
LRS = dict(means=None, scales=5e-3, quats=1e-3, features_dc=2.5e-3, features_rest=2.5e-3 / 20, opacities=5e-2)


def lr(name: str, count: int, max_steps: int = 30_000) -> float:
    """Splatfacto's rates; the means' decays exponentially 1.6e-4 → 1.6e-6."""
    if name != "means":
        return LRS[name]
    return 1.6e-4 * (1.6e-6 / 1.6e-4) ** min(count / max_steps, 1.0)


def adam(p, g, m, v, count, rate):
    """One optax Adam update k = ``count`` (bias corrections with k + 1) →
    (p, m, v)."""
    m = ADAM_B1 * m + (1 - ADAM_B1) * g
    v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
    mh = m / (1 - ADAM_B1 ** (count + 1))
    vh = v / (1 - ADAM_B2 ** (count + 1))
    return p - rate * mh / (torch.sqrt(vh) + ADAM_EPS), m, v


# splatfacto's refinement past ``stop_split_at`` (15,000) and after the first
# opacity-reset period (3,000 steps): every ``REFINE_EVERY`` steps past the
# warm-up it culls and densifies nothing
REFINE_EVERY, REFINE_WARMUP = 100, 500
CULL_ALPHA, CULL_SCALE = 0.1, 0.5


def is_refine_step(step: int) -> bool:
    """Whether the trainer refines once its step count reaches ``step``."""
    return step > REFINE_WARMUP and step % REFINE_EVERY == 0


def cull(p: dict, alive: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The alive mask after a cull-only refine: gaussians under the opacity
    threshold or larger than the scale threshold die. The refine draws its
    (unused) split offsets, two (C, 3) normals, from ``gen`` all the same."""
    opac = torch.sigmoid(p["opacities"][:, 0].float())
    big = torch.exp(p["scales"].float()).amax(dim=-1)
    C = alive.shape[0]
    for _ in range(2):
        torch.randn((C, 3), generator=gen, device=gen.device)
    return alive & ~((opac < CULL_ALPHA) | (big > CULL_SCALE))

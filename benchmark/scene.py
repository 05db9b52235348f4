"""The splat scene and its cameras, made from the seed on the device.

A trained splatfacto scene after densification: ``num_gaussians`` small
anisotropic splats (log scales around log 0.008), opacities between 0.12 and
0.99 (a trained scene has been culled below 0.1), colours uniform, the
higher SH bands small. Four fifths of them form a central object, one fifth
a wider shell that fills the frame's background. Cameras sit on a ring of
radius 4 around the object at a range of heights and look at its centre,
with the configuration's intrinsics and image size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import generator, sub_seed


def make_gaussians(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    n, cap = cfg["num_gaussians"], cfg["capacity"]
    K = (cfg["sh_degree"] + 1) ** 2
    gen = generator(seed, "scene", device)
    z = torch.randn((cap, 3 + 3 + 4 + 3 * (K - 1)), generator=gen, device=device)
    u = torch.rand((cap, 4), generator=gen, device=device)
    core = torch.arange(cap, device=device) < (4 * n) // 5
    spread = torch.where(core[:, None], torch.tensor([0.5, 0.5, 0.4], device=device),
                         torch.tensor([1.6, 1.6, 1.0], device=device))
    sh_c0 = 0.28209479177387814
    g = dict(
        means=z[:, 0:3] * spread,
        scales=math.log(0.008) + 0.6 * z[:, 3:6],
        quats=z[:, 6:10],
        features_dc=(u[:, 0:3] - 0.5) / sh_c0,
        features_rest=0.05 * z[:, 10:].reshape(cap, K - 1, 3),
        opacities=torch.logit(0.12 + 0.87 * u[:, 3:4]),
    )
    g = {k: v.contiguous() for k, v in g.items()}
    g["alive"] = torch.arange(cap, device=device) < n
    return g


def make_cameras(cfg: dict, seed: int) -> list[dict]:
    """``num_views`` cameras {c2w (3, 4) OpenGL, fx, fy, cx, cy, W, H} on a
    ring, heights drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, "cameras"))
    V, S = cfg["num_views"], cfg["image_size"]
    cams = []
    for i in range(V):
        ang = 2 * math.pi * i / V
        eye = np.array([4.0 * math.sin(ang), -4.0 * math.cos(ang), rng.uniform(-0.5, 1.5)])
        cams.append(dict(c2w=look_at(eye, np.zeros(3)), fx=cfg["focal"], fy=cfg["focal"], cx=S / 2, cy=S / 2,
                         W=S, H=S))
    return cams


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL camera-to-world (3, 4): the camera looks down its −z axis."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    f = (target - eye) / np.linalg.norm(target - eye)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    return np.concatenate([np.stack([r, u, -f], 1), eye[:, None]], 1).astype(np.float32)


def port_camera(cam: dict, device):
    """The camera as the program takes it."""
    from gaussctrl_exp_tpu_torch.cameras import make_camera

    return make_camera(cam["c2w"], cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["W"], cam["H"], device=device)


def port_state(g: dict):
    """The gaussians as the program takes them (its own copies)."""
    from gaussctrl_exp_tpu_torch.models.gaussians import PARAM_NAMES, GaussianParams, GaussianState

    return GaussianState(GaussianParams(**{n: g[n].clone() for n in PARAM_NAMES}), g["alive"].clone())

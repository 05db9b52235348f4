"""Float32 operations of a splat frame and of a training step, for ``mfu``.

Per gaussian that the projection keeps, counted from the reference's
formulas: the projection (quaternion to rotation 40, Σ3D 45, the view
transform 15, the clamped Jacobian and T = J·W 24, Σ2D 24, conic, radius
and determinant 16, the centre through the full matrix 20, the tile range
16: 200) and SH at degree 3 (directions 9, 16 basis values 45, 16 × 3
multiply-adds 96, the clamp 3: 153). A backward pass is counted as twice
its forward. The blend's operations come from ``blend.py``. SSIM and LPIPS
are counted by ``FlopCounterMode`` on the reference at the step's shapes
(their products and convolutions; forward and, for the rendered side, a
backward of twice the forward). Adam: 12 operations per parameter.
Nearly none of this runs on the tensor cores, so the share is taken of the
float32 peak.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import splat as ref

PROJECT_OPS = 200
SH3_OPS = 153
ADAM_OPS = 12
PARAMS_PER_GAUSSIAN = 3 + 3 + 4 + 3 + 45 + 1


def frame_ops(visible: int) -> int:
    """Projection and SH of one frame, forward."""
    return (PROJECT_OPS + SH3_OPS) * visible


def loss_ops(H: int, W: int, patches: int, patch: int) -> int:
    """SSIM of the frame and patch LPIPS, forward and backward."""
    lp = ref.lpips_spec()
    Wt = {k: torch.empty(s, device="meta") for k, (s, _) in lp.items()}
    with FlopCounterMode(display=False) as fc:
        ref.ssim(torch.empty((H, W, 3), device="meta"), torch.empty((H, W, 3), device="meta"))
        a = torch.empty((patches, patch, patch, 3), device="meta")
        ref.lpips(Wt, a, a)
    # forward of both LPIPS branches and SSIM, plus the rendered side's backward
    return 2 * fc.get_total_flops() + 10 * H * W * 3


def step_ops(visible: int, capacity: int, blend_fwd: int, blend_bwd: int, loss: int) -> int:
    """A training step: projection and SH forward and backward, the blend
    both ways, the loss (``loss_ops``) and Adam over every slot."""
    return 3 * frame_ops(visible) + blend_fwd + blend_bwd + loss + ADAM_OPS * PARAMS_PER_GAUSSIAN * capacity

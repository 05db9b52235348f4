"""gaussctrl_exp_tpu_torch — the PyTorch + CUDA port of ``gaussctrl_exp_tpu``.

The JAX package beside this one is the reference; this package reproduces
its outputs with plain PyTorch tensor code and, where the JAX package runs a
Pallas kernel, a CUDA C++ kernel written for Hopper (``csrc/``).

Layout (each module names its JAX counterpart):
  cameras.py   — camera model and view/projection matrices
  ops/         — projection, SH, binning, blend and attention (plain versions
                 + CUDA kernels), renderer, losses
  models/      — Gaussian parameters, the splat model's render, densify
  engine/      — trainer, optimizers, splatfacto checkpoint import/export
  diffusion/   — the SD1.x edit stack, the experimental cross-view
                 processors, the depth generator and inpainting
  experimental/ — the 3D noise mask
  cli/         — the ``camera-path`` render entry point

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card they raise instead of falling back.
"""

__version__ = "0.1.0"

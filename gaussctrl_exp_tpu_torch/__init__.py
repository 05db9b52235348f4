"""gaussctrl_exp_tpu_torch — the PyTorch + CUDA port of ``gaussctrl_exp_tpu``.

The JAX package beside this one is the reference; this package reproduces
its outputs with plain PyTorch tensor code and, where the JAX package runs a
Pallas kernel, a CUDA C++ kernel written for Hopper (``csrc/``).

Layout (each module names its JAX counterpart):
  cameras.py   — camera model and view/projection matrices
  configs.py   — the ``gaussctrl`` method's configuration (flags of cli/train.py)
  data/        — ``transforms.json`` parsing, the image cache (undistorted,
                 4×10 view subset), the seed point cloud
  native/      — the loader's C++ (PLY reader, JPEG decode and encode, GIF
                 LZW, undistort remap), built with g++ at first use
  ops/         — projection, SH, binning, blend and attention (plain versions
                 + CUDA kernels), renderer, losses
  models/      — Gaussian parameters, the splat model's render, densify
  engine/      — trainer, optimizers, training checkpoints, splatfacto
                 checkpoint import/export, the event writer
  diffusion/   — the SD1.x edit stack, the experimental cross-view
                 processors, the depth generator and inpainting
  experimental/ — the 3D noise mask
  segmentation/ — SAM, the CLIP grounder and Lang-SAM
  parallel/    — sharded render, training and edit generation on
                 ``torch.distributed``
  utils/       — PNG, GIF, resizes, spherical video metadata, timing
  cli/         — ``train`` (load a scene, init, optional edit, train, the
                 live viewer), ``render`` (``dataset``, ``camera-path``,
                 ``interpolate``, ``spiral``) and ``viewer``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card they raise instead of falling back.
"""

__version__ = "0.1.0"

"""Segmentation stack: SAM (PyTorch) + pluggable box providers.

Port of ``gaussctrl_exp_tpu/segmentation/``, the replacement for the
reference's vendored Lang-SAM: box-prompted SAM masks with the text→box
stage pluggable (CLIP patch grounding, precomputed boxes, the whole frame,
or any callable). Plain PyTorch throughout: no kernel of the port runs here.
"""

from .sam import SAM, SAMConfig  # noqa: F401
from .lang_sam import LangSAM, BoxProvider  # noqa: F401

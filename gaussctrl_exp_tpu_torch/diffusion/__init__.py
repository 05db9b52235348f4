"""The GaussCtrl edit stack: SD1.x UNet + depth ControlNet + VAE + CLIP text
tower, DDIM inversion and generation, and the AttnAlign cross-view
attention, whose every attention call on the card runs kernel B3."""

from .attention import default_processor, make_cross_view_processor
from .pipeline import EditConfig, GaussCtrlEditPipeline, depth_to_disparity, select_reference_views
from .schedulers import DDIMInverseScheduler, DDIMScheduler, SchedulerConfig
from .sd_pipeline import SDControlNetPipeline, SDModels, init_random_models

__all__ = [
    "default_processor",
    "make_cross_view_processor",
    "EditConfig",
    "GaussCtrlEditPipeline",
    "depth_to_disparity",
    "select_reference_views",
    "DDIMInverseScheduler",
    "DDIMScheduler",
    "SchedulerConfig",
    "SDControlNetPipeline",
    "SDModels",
    "init_random_models",
]

"""The GaussCtrl edit stack: SD1.x UNet + depth ControlNet + VAE + CLIP text
tower, DDIM inversion and generation, the AttnAlign cross-view attention and
the experimental triplane and correspondence processors, the depth-
conditioned multi-view generator and inpainting. On the card every attention
call runs kernel B3, and its backward B4 and B5."""

from .attention import default_processor, make_cross_view_processor
from .inpaint import InpaintConfig, SDInpaintPipeline, mask_to_latent
from .mv_generator import DepthGenerator, MVGeneratorConfig, init_depth_generator, inverse_depth_latent
from .pipeline import EditConfig, GaussCtrlEditPipeline, depth_to_disparity, select_reference_views
from .schedulers import DDIMInverseScheduler, DDIMScheduler, SchedulerConfig
from .sd_pipeline import SDControlNetPipeline, SDModels, init_random_models

__all__ = [
    "default_processor",
    "make_cross_view_processor",
    "InpaintConfig",
    "SDInpaintPipeline",
    "mask_to_latent",
    "DepthGenerator",
    "MVGeneratorConfig",
    "init_depth_generator",
    "inverse_depth_latent",
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

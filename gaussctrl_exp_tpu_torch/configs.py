"""Top-level method configuration: the ``gaussctrl`` method spec.

Port of ``gaussctrl_exp_tpu/configs.py``, after the reference's registered
method (gc_config.py:40-92): the trainer's schedule (1000-iteration cap,
save every 250, eval image every 100), the GaussCtrl pipeline knobs
(render_rate 500, guidance 5, 20 inference steps, chunk 5, 4 reference
views, SD-1.x checkpoint path), the datamanager's 4×10 view subsetting and
the dataparser's defaults, over the port's ``TrainConfig`` and
``DataManagerConfig``. ``device`` picks the card (``cuda``, the default)
or the CPU's plain path.

The port's ``RenderConfig`` has no ``impl``, ``isect_capacity``,
``aligned_capacity``, ``max_per_tile`` or ``tile_chunk``: they size the JAX
package's TPU layout, and the port sizes its intersection list exactly, so
``--train.model.render.impl`` and its siblings are unknown flags here.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from .data.datamanager import DataManagerConfig
from .engine.trainer import TrainConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """GaussCtrl edit-pipeline knobs (ad_pipeline.py:52-77)."""

    render_rate: int = 500
    edit_prompt: str = ""
    reverse_prompt: str = ""
    langsam_obj: str = ""
    guidance_scale: float = 5.0
    num_inference_steps: int = 20
    chunk_size: int = 5
    ref_view_num: int = 4
    diffusion_ckpt: str = "CompVis/stable-diffusion-v1-4"
    # sidecar persistence/resume; "" = scene data dir (the reference keeps
    # depth_npy/z_0/mask_npy/unedited inside the scene folder)
    sidecar_dir: str = ""
    resume_sidecars: bool = True
    # live Lang-SAM masks of langsam_obj: a local SAM checkpoint
    # (segment_anything's .pth) and, for text → box grounding, a local CLIP
    # checkpoint (transformers' layout; without it the box is the whole
    # frame). Without langsam_obj and sam_ckpt, masks come from mask_npy/
    sam_ckpt: str = ""
    clip_ckpt: str = ""


@dataclasses.dataclass(frozen=True)
class GaussCtrlConfig:
    """`gaussctrl` method: trainer schedule + pipeline + data (gc_config.py)."""

    data: Path = Path("data/bear")
    load_checkpoint: str = ""
    output_dir: Path = Path("outputs")
    experiment_name: str = "gaussctrl"
    max_num_iterations: int = 1000
    steps_per_save: int = 250
    steps_per_eval_image: int = 100
    save_only_latest_checkpoint: bool = True
    seed: int = 42
    capacity: int = 1 << 17
    viewer_port: int = 0  # >0: serve the live viewer during training
    # record the program's spans and counters (utils/trace.py) through the
    # run, written to logs/spans.jsonl and logs/trace_summary.json at its end
    trace: bool = False
    device: str = "cuda"
    pipeline: PipelineConfig = PipelineConfig()
    train: TrainConfig = TrainConfig()
    datamanager: DataManagerConfig = dataclasses.field(default_factory=DataManagerConfig)

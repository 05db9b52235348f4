"""The GaussCtrl edit pipeline: render_reverse → edit_images → write-back.

Port of ``gaussctrl_exp_tpu/diffusion/pipeline.py``:

  render_reverse: for every training camera, render RGB and depth through the
    port's ``render_model`` (kernel B1 on the card), build the disparity hint,
    VAE-encode the render and run the DDIM inversion conditioned on the
    reverse prompt and the depth ControlNet at guidance 0 → per-view ``z0``;
    optionally an object mask from a mask provider; optionally persist and
    resume the per-view sidecars.

  edit_images: pick 4 deterministic-random reference views (seed 13789),
    install the cross-view processor, regenerate chunks of ``chunk_size``
    views after the 4 reference views from their inverted latents with the
    edit prompt at CFG ``guidance_scale``, drop the reference outputs,
    composite the edited foreground over the unedited render with the mask,
    and write the images back into the datamanager.

The cross-view processor is ``EditConfig.attn_processor``: "attn_align"
(the paper's AttnAlign), or one of the experimental ones, "triplane"
(``triplane_attention.py``) and "correspondence" (the epipolar processor of
``correspondence.py``), whose geometry is built per chunk from the depths
``render_reverse`` cached. As in the JAX package, one processor goes to both
the UNet and the ControlNet, and ``self_attn_coeff_controlnet`` is not read
(ROADMAP §C). Caches are numpy arrays in the JAX package's shapes: ``z0``
(h, w, 4), ``disparity`` (H, W, 3), ``depths`` (H, W).
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import trace
from .attention import make_cross_view_processor
from .correspondence import build_correspondence_tables, make_multires_epipolar_processor
from .geometry import depth_to_world_points, scaled_camera
from .sd_pipeline import SDControlNetPipeline, SDModels, encode_prompt_ids
from .sd_pipeline import tokenize as models_tokenize
from .triplane_attention import make_triplane_processor

ADDED_PROMPT = "best quality, extremely detailed"
NEGATIVE_PROMPT = (
    "longbody, lowres, bad anatomy, bad hands, missing fingers, extra digit, "
    "fewer digits, cropped, worst quality, low quality"
)
REF_VIEW_SEED = 13789
EVAL_STEP = 30_000  # the step render_reverse renders at (full SH degree)


@dataclasses.dataclass
class EditConfig:
    edit_prompt: str = ""
    reverse_prompt: str = ""
    langsam_obj: str = ""
    guidance_scale: float = 5.0
    num_inference_steps: int = 20
    chunk_size: int = 5
    ref_view_num: int = 4
    diffusion_ckpt: str = ""
    self_attn_coeff_unet: float = 0.6
    self_attn_coeff_controlnet: float = 0.0  # not read, as in the JAX package
    controlnet_conditioning_scale: float = 1.0
    latent_size: int = 64  # 512² images → 64² latents
    attn_processor: str = "attn_align"  # "attn_align" | "triplane" | "correspondence"
    triplane_mix: float = 0.5
    triplane_bbox_length: float = 8.0
    triplane_plane_res: int = 32
    geom_res_divisor: int = 1  # geometry token grid = latent_size // this
    corr_mix: float = 0.5
    corr_sigma: float = 0.1
    sidecar_dir: str = ""  # "" = don't persist/resume
    resume_sidecars: bool = True  # False forces a recompute


def depth_to_disparity(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth → (H, W, 3) normalised disparity hint."""
    disparity = 1.0 / (np.asarray(depth, np.float32) + 1e-5)
    disparity = disparity / max(float(disparity.max()), 1e-12)
    return np.repeat(disparity[..., None], 3, axis=-1)


def select_reference_views(view_num: int, ref_view_num: int = 4) -> list[int]:
    """Deterministic-random anchor sampling, one per quarter of the views."""
    anchors = [(view_num * i) // ref_view_num for i in range(ref_view_num)] + [view_num]
    rng = random.Random(REF_VIEW_SEED)
    return [rng.randint(anchor, anchors[i + 1]) for i, anchor in enumerate(anchors[:-1])]


class GaussCtrlEditPipeline:
    """Host-orchestrated edit loop; the models run on their own device."""

    def __init__(
        self,
        cfg: EditConfig,
        models: Optional[SDModels] = None,
        mask_provider: Optional[Callable[[np.ndarray, str], np.ndarray]] = None,
        tokenizer: Optional[Callable[[list], np.ndarray]] = None,
        device: str | torch.device = "cuda",
    ):
        """``models`` default to ``load_sd_models(cfg.diffusion_ckpt,
        device)``. ``tokenizer`` defaults to the checkpoint's CLIP BPE
        tokenizer, or the salted hash placeholder when there is none."""
        self.cfg = cfg
        if models is None:
            from .convert import load_sd_models

            models = load_sd_models(cfg.diffusion_ckpt, device)
        self.models = models
        self.device = models.device
        self.pipe = SDControlNetPipeline(models)
        self.mask_provider = mask_provider
        self.tokenize = tokenizer or (lambda texts: models_tokenize(self.models, texts))
        # per-view caches; callers may preload self.masks
        self.z0: dict[int, np.ndarray] = {}
        self.disparity: dict[int, np.ndarray] = {}
        self.depths: dict[int, np.ndarray] = {}
        self.masks: dict[int, np.ndarray] = {}
        self.unedited: dict[int, np.ndarray] = {}
        self.n_inversions = 0  # views rendered and inverted by this object
        self.n_resumed = 0  # views loaded from sidecars

    # ------------------------------------------------------------------
    @staticmethod
    def _sidecar_paths(datamanager, local_i: int, root) -> dict:
        """<root>/{depth_npy,z_0,mask_npy,unedited}/frame_{global+1:05d}.npy,
        numbered by the datamanager's global view index where it has one."""
        gi = local_i
        vi = getattr(datamanager, "view_indices", None)
        if vi is not None:
            gi = int(vi[local_i])
        root = Path(root)
        stem = f"frame_{gi + 1:05d}"
        return {
            "depth": root / "depth_npy" / f"{stem}.npy",
            "z0": root / "z_0" / f"{stem}.npy",
            "mask": root / "mask_npy" / f"{stem}.npy",
            "unedited": root / "unedited" / f"{stem}.npy",
        }

    def _try_resume_sidecars(self, datamanager, idx: int, root) -> bool:
        sp = self._sidecar_paths(datamanager, idx, root)
        if not (sp["z0"].exists() and sp["depth"].exists() and sp["unedited"].exists()):
            return False
        depth = np.load(sp["depth"])
        self.depths[idx] = depth
        self.disparity[idx] = depth_to_disparity(depth)
        self.z0[idx] = np.load(sp["z0"])
        self.unedited[idx] = np.load(sp["unedited"])
        if sp["mask"].exists():
            self.masks[idx] = np.load(sp["mask"]).astype(np.float32)
        self.n_resumed += 1
        return True

    def _write_sidecars(self, datamanager, idx: int, root, depth: np.ndarray) -> None:
        sp = self._sidecar_paths(datamanager, idx, root)
        for p in sp.values():
            p.parent.mkdir(parents=True, exist_ok=True)
        np.save(sp["depth"], np.asarray(depth, np.float32))
        np.save(sp["z0"], self.z0[idx])
        np.save(sp["unedited"], self.unedited[idx])
        if idx in self.masks:
            np.save(sp["mask"], self.masks[idx])

    # ------------------------------------------------------------------
    def _encode(self, texts: list[str]) -> torch.Tensor:
        with trace.span("sd.text"):
            return encode_prompt_ids(self.models, self.tokenize(texts))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def render_reverse(self, gs, datamanager, model_cfg, sidecar_root=None,
                       force_recompute: bool = False) -> None:
        """Render and invert every training view. With a sidecar root
        (argument or ``cfg.sidecar_dir``), views whose depth/z_0/unedited
        sidecars exist are resumed from disk with no render and no inversion,
        and newly computed views are persisted."""
        from ..models.gaussians import GaussianState
        from ..models.splat_model import render_model

        cfgp = self.cfg
        root = sidecar_root or (cfgp.sidecar_dir or None)
        resume = root is not None and cfgp.resume_sidecars and not force_recompute
        rev_ctx = self._encode([f"{cfgp.reverse_prompt}, {ADDED_PROMPT}"])

        for idx in range(len(datamanager)):
            if resume and self._try_resume_sidecars(datamanager, idx, root):
                print(f"[render_reverse] view {idx+1}/{len(datamanager)} (sidecar)", end="\r")
                continue
            with trace.span("invert.view", unit=idx):
                camera = datamanager.camera(idx)
                with torch.no_grad():
                    out = render_model(GaussianState(gs.params, gs.alive), camera, EVAL_STEP, model_cfg)
                with trace.span("invert.to_host", unit=idx, sync=True):
                    rgb = np.clip(out.rgb.float().cpu().numpy(), 0, 1)
                    depth = out.depth[..., 0].float().cpu().numpy()
                disparity = depth_to_disparity(depth)
                latents = self.pipe.image_to_latent(self._tensor(rgb)[None])
                z0 = self.pipe.invert(latents, rev_ctx, self._tensor(disparity)[None],
                                      cfgp.num_inference_steps, cfgp.controlnet_conditioning_scale)
                with trace.span("invert.z0_to_host", unit=idx, sync=True):
                    self.z0[idx] = z0[0].cpu().numpy()
                trace.count("invert.views")
                self.unedited[idx] = rgb
                self.depths[idx] = depth
                self.disparity[idx] = disparity
                self.n_inversions += 1
                if self.mask_provider is not None and cfgp.langsam_obj:
                    with trace.span("invert.mask", unit=idx):
                        self.masks[idx] = np.asarray(self.mask_provider(rgb, cfgp.langsam_obj), np.float32)
                if root is not None:
                    with trace.span("invert.sidecars", unit=idx):
                        self._write_sidecars(datamanager, idx, root, depth)
            print(f"[render_reverse] view {idx+1}/{len(datamanager)}", end="\r")
        print()

    # ------------------------------------------------------------------
    def _chunk_geometry(self, datamanager, views: list[int]):
        """Geometry of one chunk for the experimental processors, from the
        depths ``render_reverse`` cached, strided to the feature grid:
        correspondence tables (V, V, S, 9) for "correspondence", world points
        (V, S, 3) for "triplane"; None for "attn_align". The host span
        ``edit.geometry`` holds the build."""
        cfgp = self.cfg
        if cfgp.attn_processor == "attn_align":
            return None
        with trace.span("edit.geometry", unit=len(views)):
            fh = max(cfgp.latent_size // max(cfgp.geom_res_divisor, 1), 1)
            depths = [self._tensor(self.depths[i]) for i in views]
            cams = [datamanager.camera(i) for i in views]
            if cfgp.attn_processor == "correspondence":
                return build_correspondence_tables(depths, cams, fh, cfgp.corr_sigma)
            # triplane: back-project the strided depths to (V, S, 3) world points
            pts = []
            for d, c in zip(depths, cams):
                stride = max(d.shape[0] // fh, 1)
                ds = d[stride // 2 :: stride, stride // 2 :: stride][:fh, :fh]
                pts.append(depth_to_world_points(ds, scaled_camera(c, stride, fh)).reshape(-1, 3))
            return torch.stack(pts)

    def _make_processor(self, geom=None):
        cfgp = self.cfg
        if cfgp.attn_processor == "attn_align":
            return make_cross_view_processor(cfgp.self_attn_coeff_unet, cfgp.ref_view_num)
        if cfgp.attn_processor == "triplane":
            return make_triplane_processor(geom, mix=cfgp.triplane_mix, bbox_length=cfgp.triplane_bbox_length,
                                           plane_res=cfgp.triplane_plane_res)
        if cfgp.attn_processor == "correspondence":
            nbr_idx, nbr_w = geom
            return make_multires_epipolar_processor({nbr_idx.shape[2]: (nbr_idx, nbr_w)}, mix=cfgp.corr_mix)
        raise ValueError(f"unknown attn_processor {cfgp.attn_processor!r}")

    def edit_images(self, datamanager) -> None:
        """Chunked cross-view-consistent regeneration and write-back. Every
        view is edited once, in order; each chunk goes after the 4 reference
        views, whose own outputs are dropped."""
        cfgp = self.cfg
        if cfgp.attn_processor not in ("attn_align", "triplane", "correspondence"):
            raise ValueError(f"unknown attn_processor {cfgp.attn_processor!r}")
        V = len(datamanager)
        ref_indices = select_reference_views(V, cfgp.ref_view_num)
        pos_ctx = self._encode([f"{cfgp.edit_prompt}, {ADDED_PROMPT}"])
        neg_ctx = self._encode([NEGATIVE_PROMPT])
        ref_z0 = np.stack([self.z0[i] for i in ref_indices])
        ref_disp = np.stack([self.disparity[i] for i in ref_indices])

        for c0 in range(0, V, cfgp.chunk_size):
            chunk = list(range(c0, min(c0 + cfgp.chunk_size, V)))
            ci = c0 // cfgp.chunk_size
            with trace.span("edit.chunk", unit=ci):
                with trace.span("edit.prepare", unit=ci):
                    z0 = self._tensor(np.concatenate([ref_z0, np.stack([self.z0[i] for i in chunk])]))
                    hint = self._tensor(np.concatenate([ref_disp, np.stack([self.disparity[i] for i in chunk])]))
                    B = z0.shape[0]
                    processor = self._make_processor(self._chunk_geometry(datamanager, ref_indices + chunk))
                latents = self.pipe.generate(
                    z0, pos_ctx.expand(B, -1, -1), neg_ctx.expand(B, -1, -1), hint,
                    cfgp.guidance_scale, cfgp.num_inference_steps,
                    cfgp.controlnet_conditioning_scale, processor=processor,
                )
                images = self.pipe.latent_to_image(latents)
                with trace.span("edit.to_host", unit=ci, sync=True):
                    images = images.float().cpu().numpy()[len(ref_indices):]
                trace.count("edit.chunks")
                with trace.span("edit.write_back", unit=ci):
                    for bi, view in enumerate(chunk):
                        edited = images[bi]
                        if view in self.masks:
                            m = self.masks[view][..., None]
                            edited = edited * m + self.unedited[view] * (1 - m)
                        datamanager.write_back(view, edited)
            print(f"[edit_images] {min(c0 + cfgp.chunk_size, V)}/{V} views", end="\r")
        print()

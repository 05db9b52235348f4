"""GaussCtrl's inversion with LangSAM masks: ``render_reverse`` over the
scene's views with the mask provider ``gctpu-train`` builds when a script
sets ``--pipeline.langsam-obj`` (``cli/train.py``): ``LangSAM(SAM, CLIP
grounder).as_mask_provider()``.

For each view, after ``edit_invert``'s render, encode and inversion: CLIP
ViT-L/14's patch embeddings of the frame at 224², the boxes where they match
the object's text, SAM ViT-H's encode of the frame at 1024² prompted with
every box, and the union of the masks at the frame's size on the host. SAM
and CLIP are built in memory from weights drawn from the seed (as the SD
stack is) and run in full float32, with TF32 off in cuDNN too (torch's
default, which the CLI keeps, leaves it on there). A view counts once its
mask is on the host.

The timed path keeps, per view and without a host sync, what the check
compares: the CLIP patch embeddings, the boxes, SAM's low-res logits (a
device clone) and the mask. The check holds them to the plain reference in
float32 with TF32 off: on every finished view, the reference's patch
embeddings and boxes from the program's frame; on views drawn from the seed
among all of them, SAM's logits from the reference's own preprocessing and
encode prompted by the program's boxes, the mask where the reference's
union logit lies beyond a margin (none where the program found no box), and
the view's ``z0`` against ``edit_invert``'s reference at that cell's limits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys

import numpy as np
import torch

from ..common import abs_gaps, check_from, check_sample, load_module, make_weights, tokenize
from ..counts import sam as sam_counts
from ..counts import sd as sd_counts
from ..counts.peaks import PEAK_BF16_OPS_S
from ..harness import load_json
from ..reference import clip as ref_clip
from ..reference import sam as ref_sam
from ..reference.precision import precision, tf32_off
from ..reference.sd import Params
from . import _edit, _splat
from .edit_invert import Cameras, _run, reference_z0
from .edit_invert import _wrap as _wrap_sd


def setup(ctx: dict) -> dict:
    cell, seed, dev = ctx["cell"], ctx["seed"], ctx["device"]
    tr, cfg = cell.traffic, cell.config
    tf32_off()  # the configuration's precision: SAM's and CLIP's products in full float32
    e = _edit.build(dict(ctx, cell=dataclasses.replace(cell, config=load_json("configs", tr["edit_config"]))))
    sc = _splat.build(ctx, load_json("configs", tr["scene"]))
    W = {part: make_weights(spec(cfg[part]), seed, f"weights.{part}", dev)
         for part, spec in (("sam", ref_sam.param_spec), ("clip", ref_clip.param_spec))}
    st = dict(ctx=ctx, tr=tr, cfg=cfg, edit=e, scene=sc, cams=Cameras(sc["pcams"]), seg_weights=W,
              ls=lang_sam(cfg, W), kept_seg={}, tally=dict(views=0, sam=0, boxes=0))
    e.pipe.cfg = dataclasses.replace(e.pipe.cfg, langsam_obj=tr["langsam_obj"])
    e.pipe.mask_provider = _keeping(st, st["ls"].as_mask_provider())
    if ctx["spans"] is not None:
        _wrap(st)
    _run(st, stop_after=1)  # warm-up: one view
    return st


def lang_sam(cfg: dict, W: dict):
    """The CLI's ``LangSAM(SAM, clip_grounder(...))`` on the weights ``W``."""
    from gaussctrl_exp_tpu_torch.diffusion.text_encoder import CLIPTextConfig
    from gaussctrl_exp_tpu_torch.segmentation.clip_vision import CLIPModel, CLIPVisionConfig
    from gaussctrl_exp_tpu_torch.segmentation.grounding import clip_grounder
    from gaussctrl_exp_tpu_torch.segmentation.lang_sam import LangSAM
    from gaussctrl_exp_tpu_torch.segmentation.sam import SAM, SAMConfig

    s, c = cfg["sam"], cfg["clip"]
    scfg = SAMConfig(**{f: tuple(s[f]) if f == "encoder_global_attn" else s[f] for f in SAMConfig.__dataclass_fields__})
    sam = load_module(lambda: SAM(scfg), W["sam"])
    clip = load_module(lambda: CLIPModel(CLIPTextConfig(**c["text"]), CLIPVisionConfig(**c["vision"]),
                                         c["projection_dim"], eos_token_id=2), W["clip"])
    return LangSAM(sam, clip_grounder(clip, tokenize, **cfg["grounding"]))


def _keeping(st: dict, provide):
    """The mask provider ``provide``, keeping each view's patch embeddings,
    boxes and low-res logits (a device clone) from inside its call, and
    tallying the images SAM encoded and the boxes it decoded."""
    ls, cams, kept, tally = st["ls"], st["cams"], st["kept_seg"], st["tally"]
    grounder, low_res_logits = ls.box_provider, ls.low_res_logits
    embed_patches = grounder.embed_patches
    rec: dict = {}

    def embed_kept(image):
        rec["patches"] = embed_patches(image)
        return rec["patches"]

    def logits_kept(image, boxes):
        low_res, scale = low_res_logits(image, boxes)
        rec.update(boxes=boxes, logits=low_res.clone())
        return low_res, scale

    def provide_kept(rgb, text):
        rec.clear()
        mask = provide(rgb, text)
        boxes = rec.get("boxes", np.zeros((0, 4), np.float32))
        kept[cams.started - 1] = dict(patches=rec["patches"], boxes=boxes, logits=rec.get("logits"))
        tally["views"] += 1
        tally["sam"] += int(len(boxes) > 0)
        tally["boxes"] += len(boxes)
        return mask

    grounder.embed_patches, ls.low_res_logits = embed_kept, logits_kept
    return provide_kept


def _wrap(st: dict) -> None:
    """Traced runs: CUDA events around each inversion step and VAE encode
    (``edit_invert``'s), and around each SAM encode on the SAM instance."""
    _wrap_sd(st)
    spans, sam = st["ctx"]["spans"], st["ls"].sam
    encode = sam.encode_image

    def encode_w(*a, **k):
        with spans.cuda("sam_encode"):
            return encode(*a, **k)

    sam.encode_image = encode_w


def window(st: dict, seconds: float) -> dict:
    if st["ctx"]["spans"] is not None:
        st["ctx"]["spans"].reset()
    st["tally"].update(views=0, sam=0, boxes=0)
    n, dt = _run(st, seconds=seconds)
    st["window_views"], st["window_s"], st["window_tally"] = n, dt, dict(st["tally"])
    t = st["window_tally"]
    print(f"seg: {t['views']} views, {t['views'] - t['sam']} with no box, {t['boxes']} boxes", file=sys.stderr)
    return dict(attempted=n, failed=0, elapsed_s=dt, metrics=dict(invert_views_per_s=n / dt))


def profiled(st: dict) -> None:
    _run(st, stop_after=st["tr"]["profile_views"])


def counts(st: dict, prof: dict) -> dict:
    """The window's work at each part's own peak: the SD stack's at bf16's,
    SAM's and CLIP's at the exact float32 rate (3×TF32); SAM's encode floor."""
    tr, mc, cfg, t = st["tr"], st["edit"].mcfg, st["cfg"], st["window_tally"]
    sd_ops = tr["num_inference_steps"] * sd_counts.eps(mc, 1, attn_align=False)[0] + sd_counts.encode_ops(mc, 1)
    seg_ops = (t["sam"] * sam_counts.encode_ops(cfg["sam"]) + t["boxes"] * sam_counts.decode_ops(cfg["sam"])
               + t["views"] * sam_counts.clip_image_ops(cfg["clip"]))
    peak_s = st["window_views"] * sd_ops / PEAK_BF16_OPS_S + seg_ops / sam_counts.PEAK_F32_EXACT_OPS_S
    return dict(peak_s=peak_s, window_s=st["window_s"], sam_bound_s=sam_counts.encode_bound_s(cfg["sam"]))


def release(st: dict) -> None:
    p = st["edit"].pipe
    st["masks"], st["frames"], st["kept"] = dict(p.masks), dict(p.unedited), dict(p.z0)
    _edit.release(st["edit"])
    st["ls"] = st["scene"]["gs"] = st["scene"]["pcams"] = None


@contextlib.contextmanager
def _mode(mode: str):
    """The reference's products in ``mode``: a mode of ``precision``, or
    ``tf32``, float32 with TF32 in matmuls and cuDNN (the card's single-pass
    tensor-core float32)."""
    if mode != "tf32":
        with precision(mode):
            yield
        return
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        tf32_off()


def _frame(st: dict, i: int) -> torch.Tensor:
    dev = st["seg_weights"]["sam"]["image_encoder.pos_embed"].device
    return ref_sam.to_uint8(torch.as_tensor(st["frames"][i], device=dev))


@torch.no_grad()
def reference_ground(st: dict, i: int, mode: str = "fp32") -> dict:
    """The reference's CLIP patch embeddings and boxes of view ``i``'s frame."""
    cfg, tr, P = st["cfg"], st["tr"], Params(st["seg_weights"]["clip"])
    c, img = cfg["clip"], _frame(st, i)
    with _mode(mode):
        patches = ref_clip.patch_embeddings(P, c, ref_clip.pixels(img, c["vision"]["image_size"]))[0]
        text = ref_clip.text_features(P, c, torch.as_tensor(tokenize([tr["langsam_obj"]]), device=img.device))[0]
        heat = ref_clip.heat_map(patches, text).cpu().numpy()
    return dict(patches=patches, boxes=ref_clip.boxes(heat, img.shape[:2], margin=tr["margins"]["heat_rel"],
                                                      **cfg["grounding"]))


@torch.no_grad()
def reference_sam(st: dict, i: int, boxes: np.ndarray, mode: str = "fp32") -> dict:
    """SAM's low-res logits of view ``i``'s frame prompted by ``boxes``, and
    their union upscaled to the frame (None where there are no boxes)."""
    if not len(boxes):
        return dict(logits=None, union=None)
    s, img, P = st["cfg"]["sam"], _frame(st, i), Params(st["seg_weights"]["sam"])
    with _mode(mode):
        x, scale = ref_sam.preprocess(img, s["img_size"])
        logits, _ = ref_sam.decode(P, s, ref_sam.encode(P, s, x), torch.as_tensor(boxes, device=img.device) * scale)
        union = ref_sam.upscale(logits, scale, img.shape[:2], s["img_size"])[:, 0].amax(0)
    return dict(logits=logits, union=union)


def _z0(st: dict, i: int, mode: str = "fp32") -> torch.Tensor:
    """``edit_invert``'s reference ``z0`` of view ``i``, its products in ``mode``."""
    with _mode(mode):
        return reference_z0(st, i, "fp32" if mode == "tf32" else mode)


def _same_boxes(a: np.ndarray, b: np.ndarray) -> bool:
    """The same boxes, in any order."""
    a, b = (np.asarray(x, np.float32).reshape(-1, 4) for x in (a, b))
    return a.shape == b.shape and np.array_equal(a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])])


def ground_gaps(patches, boxes: np.ndarray, ref: dict) -> dict:
    """One view's grounding numbers: its patch embeddings' largest gap over
    the reference's largest entry, and whether its boxes differ where no
    heat-map cell lies near the threshold."""
    r = ref["patches"]
    g = torch.as_tensor(patches, device=r.device).float()
    return dict(clip_patch_max_rel=float((g - r).abs().max() / r.abs().max()),
                boxes_differ=0.0 if ref["boxes"]["near"] else float(not _same_boxes(boxes, ref["boxes"]["boxes"])))


def sam_gaps(logits, mask, ref: dict, mask_margin: float) -> dict:
    """One view's SAM numbers: its low-res logits and its mask against the
    reference's ``ref`` prompted by the same boxes."""
    if ref["logits"] is None:  # no box prompted: no mask
        m = torch.as_tensor(mask) > 0
        return dict(sam_logit_mean_rel=0.0, sam_logit_max_rel=0.0, mask_differ_share=float(m.float().mean()))
    want, u = ref["logits"], ref["union"]
    d, top = (logits.float() - want).abs(), want.abs().max()
    mask = torch.as_tensor(mask, device=u.device) > 0
    sure = u.abs() > mask_margin * u.abs().max()
    return dict(sam_logit_mean_rel=float(d.mean() / top), sam_logit_max_rel=float(d.max() / top),
                mask_differ_share=float(((mask != (u > 0)) & sure).sum() / sure.sum().clamp(min=1)))


def readings(st: dict, controls=()) -> dict[str, dict]:
    tf32_off()
    worst: dict[str, dict] = {}

    def keep(who, values):
        w = worst.setdefault(who, {})
        for k, v in values.items():
            w[k] = max(w.get(k, 0.0), v)

    tr, kept = st["tr"], st["kept_seg"]
    have = sorted(i for i in kept if i in st["masks"] and i in st["kept"])
    for i in have:  # grounding on every finished view
        ref = reference_ground(st, i)
        keep("program", ground_gaps(kept[i]["patches"], kept[i]["boxes"], ref))
        for m in controls:
            low = reference_ground(st, i, m)
            keep(m, ground_gaps(low["patches"], low["boxes"]["boxes"], ref))
    z0 = abs_gaps("z0")
    for i in check_sample(st["ctx"]["seed"], have, tr["check_views"]):  # SAM, the mask and z0 on sampled views
        boxes = kept[i]["boxes"]
        ref = reference_sam(st, i, boxes)
        want = _z0(st, i)
        keep("program", sam_gaps(kept[i]["logits"], st["masks"][i], ref, tr["margins"]["mask_logit_rel"]))
        keep("program", z0(torch.as_tensor(st["kept"][i], device=want.device), want))
        for m in controls:
            low = reference_sam(st, i, boxes, m)
            mask = low["union"] > 0 if low["union"] is not None else np.zeros(st["masks"][i].shape, bool)
            keep(m, sam_gaps(low["logits"], mask, ref, tr["margins"]["mask_logit_rel"]))
            keep(m, z0(_z0(st, i, m), want))
    return worst


def check(st: dict) -> list[tuple[str, float, float]]:
    return check_from(readings(st), st["tr"]["limits"], "views_compared")

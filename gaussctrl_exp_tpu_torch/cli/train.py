"""Train / edit-finetune a 3DGS scene (≈ ``ns-train gaussctrl``).

Port of ``gaussctrl_exp_tpu/cli/train.py``. Flow (the reference's
gc_trainer.py:58-255):
  1. load the scene (transforms.json + images + seed ply), cache and
     undistort its images, 4×10 view subsetting;
  2. import a splatfacto checkpoint (``--load-checkpoint``), else initialise
     the gaussians from the seed cloud, else 50,000 random ones;
  3. with ``--pipeline.edit-prompt``, run the GaussCtrl edit phase
     (render_reverse → edit_images) with the SD weights of
     ``--pipeline.diffusion-ckpt``, and write the edited images back into
     the datamanager. Masks come from live Lang-SAM when
     ``--pipeline.langsam-obj`` and ``--pipeline.sam-ckpt`` are both set
     (boxes from the CLIP grounder of ``--pipeline.clip-ckpt``, else the
     whole frame), else from the scene's ``mask_npy/`` sidecars;
  4. train for min(render_rate, max_num_iterations) steps in blocks of
     ``steps_per_eval_image``, each followed by an eval image, its depth,
     ``Trainer.evaluate`` and, at the save cadence, a checkpoint; then the
     final checkpoint and ``history.json``.

Usage:
  python -m gaussctrl_exp_tpu_torch.cli.train --data data/bear \\
      [--load-checkpoint step-000029999.ckpt] [--device cuda] [--viewer-port 7007]

``--viewer-port`` attaches the live viewer (``cli/viewer.py``) to the
trainer before the first step; ``run`` returns the trainer, whose
``viewer`` is the server (None without the flag), still serving.
``--trace`` records the program's spans and counters (``utils/trace.py``)
through the run and writes them to ``logs/spans.jsonl`` and
``logs/trace_summary.json`` under the experiment's directory.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main(argv=None):
    from ..configs import GaussCtrlConfig
    from ..utils.cliconf import parse_config

    cfg, _ = parse_config(GaussCtrlConfig, argv, description=__doc__)
    return run(cfg)


def run(cfg):
    if not cfg.trace:
        return _run(cfg)
    from ..utils import trace

    trace.reset()
    trace.enable()
    try:
        trainer = _run(cfg)
    finally:
        trace.disable()
    logs = Path(cfg.output_dir) / cfg.experiment_name / "logs"
    trace.dump(logs / "spans.jsonl")
    summary = dict(spans=trace.summary(), counters=trace.counters(), dropped=trace.dropped())
    (logs / "trace_summary.json").write_text(json.dumps(summary, indent=1))
    print(f"[trace] {sum(s['count'] + s['errors'] for s in summary['spans'].values())} spans in {logs}")
    return trainer


def _run(cfg):
    from ..data.datamanager import DataManager
    from ..device import resolve_device
    from ..engine.checkpoint import import_splatfacto_checkpoint, save_checkpoint
    from ..engine.trainer import Trainer
    from ..engine.writer import EventWriter
    from ..models.gaussians import GaussianState, init_from_points, init_random
    from ..models.splat_model import render_model
    from ..utils.colormaps import apply_depth_colormap

    device = resolve_device(cfg.device)

    t0 = time.time()
    dm_cfg = dataclasses.replace(
        cfg.datamanager, dataparser=dataclasses.replace(cfg.datamanager.dataparser, data=Path(cfg.data)))
    dm = DataManager(dm_cfg, device=device)
    print(f"[data] {len(dm)} train views @ {dm.width}x{dm.height} ({time.time()-t0:.1f}s)")

    if cfg.load_checkpoint:
        gs, start_step = import_splatfacto_checkpoint(cfg.load_checkpoint, capacity=cfg.capacity, device=device)
        print(f"[init] splatfacto checkpoint: {int(gs.alive.sum())} gaussians @ step {start_step}")
    elif dm.parsed.points_xyz is not None:
        gs = init_from_points(dm.parsed.points_xyz, dm.parsed.points_rgb, capacity=cfg.capacity, device=device)
        print(f"[init] seed ply: {dm.parsed.points_xyz.shape[0]} points, capacity {cfg.capacity}")
    else:
        gs = init_random(50_000, capacity=cfg.capacity, device=device)
        print("[init] random init (no seed points)")

    # --- optional GaussCtrl edit phase
    if cfg.pipeline.edit_prompt:
        from ..diffusion.pipeline import EditConfig, GaussCtrlEditPipeline

        p = cfg.pipeline
        # mask source, in the reference's preference order: live Lang-SAM
        # (SAM + text->box grounding) when checkpoints are configured, else
        # precomputed mask_npy/ sidecars, else no masking (README.md:110-116)
        mask_provider = None
        if p.langsam_obj and p.sam_ckpt:
            from ..segmentation.convert import load_sam
            from ..segmentation.lang_sam import LangSAM

            box_provider = None
            if p.clip_ckpt:
                from ..segmentation.grounding import load_clip_grounder

                box_provider = load_clip_grounder(p.clip_ckpt, device=device)
            mask_provider = LangSAM(load_sam(p.sam_ckpt, device=device), box_provider=box_provider).as_mask_provider()
        pipe = GaussCtrlEditPipeline(
            EditConfig(
                edit_prompt=p.edit_prompt,
                reverse_prompt=p.reverse_prompt,
                langsam_obj=p.langsam_obj,
                guidance_scale=p.guidance_scale,
                num_inference_steps=p.num_inference_steps,
                chunk_size=p.chunk_size,
                ref_view_num=p.ref_view_num,
                diffusion_ckpt=p.diffusion_ckpt,
                sidecar_dir=p.sidecar_dir or str(cfg.data),
                resume_sidecars=p.resume_sidecars,
            ),
            mask_provider=mask_provider,
            device=device,
        )
        if mask_provider is None:
            pipe.masks.update(dm.load_masks())  # precomputed mask_npy/ sidecars
        pipe.render_reverse(gs, dm, cfg.train.model)
        if pipe.n_resumed:
            print(f"[render_reverse] resumed {pipe.n_resumed} views from sidecars, "
                  f"{pipe.n_inversions} inverted")
        pipe.edit_images(dm)

    out_dir = Path(cfg.output_dir) / cfg.experiment_name
    out_dir.mkdir(parents=True, exist_ok=True)
    writer = EventWriter(out_dir / "logs")
    writer.put_config(cfg)

    trainer = Trainer(gs, dm, cfg.train)
    num_steps = min(cfg.pipeline.render_rate, cfg.max_num_iterations)
    trainer.viewer = None
    if cfg.viewer_port:
        from .viewer import attach_live_viewer

        trainer.viewer = attach_live_viewer(trainer, dm, cfg.train.model, cfg.viewer_port)

    def callback(m):
        m = dict(m)
        writer.put_scalars(m.pop("step"), m)

    for start in range(0, num_steps, cfg.steps_per_eval_image):
        n = min(cfg.steps_per_eval_image, num_steps - start)
        trainer.train(n, log_every=50, callback=callback)
        # eval image + eval-split metrics (gc_trainer.py:226-232)
        st = trainer.state
        with torch.no_grad():
            out = render_model(GaussianState(st.params, st.alive), dm.camera(0), st.step, cfg.train.model)
        writer.put_image(trainer.step, "eval", np.clip(out.rgb.cpu().numpy(), 0, 1))
        if out.depth is not None:
            dimg = apply_depth_colormap(out.depth.cpu().numpy(), out.alpha.cpu().numpy())
            writer.put_image(trainer.step, "eval_depth", dimg)
        writer.put_scalars(trainer.step, trainer.evaluate())
        if trainer.step % cfg.steps_per_save < cfg.steps_per_eval_image:
            save_checkpoint(out_dir / "ckpts", trainer.state, trainer.step, cfg.save_only_latest_checkpoint)

    save_checkpoint(out_dir / "ckpts", trainer.state, trainer.step, cfg.save_only_latest_checkpoint)
    (out_dir / "history.json").write_text(json.dumps(trainer.history, indent=1))
    writer.close()
    print(f"[done] {trainer.step} steps, outputs in {out_dir}")
    return trainer


def entrypoint():
    main(sys.argv[1:])


if __name__ == "__main__":
    entrypoint()

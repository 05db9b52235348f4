"""PyTorch port vs the JAX package: checkpoints, the training CLI and the
render CLI's ``dataset`` subcommand.

The scene is the 3-view, 64² mini scene of tests/test_cli_integration.py,
written to a temporary directory from the same seed. The JAX ``run`` (about
40 s on the CPU) runs once per module.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gaussctrl_exp_tpu.cameras import look_at as jlook_at
from gaussctrl_exp_tpu.cli import render as jrender_cli
from gaussctrl_exp_tpu.cli import train as jtrain_cli
from gaussctrl_exp_tpu.configs import GaussCtrlConfig as JGaussCtrlConfig
from gaussctrl_exp_tpu.data import datamanager as jdm
from gaussctrl_exp_tpu.engine import checkpoint as jckpt
from gaussctrl_exp_tpu.engine import trainer as jtr
from gaussctrl_exp_tpu.models.gaussians import init_random as jinit_random
from gaussctrl_exp_tpu.segmentation import lang_sam as jlang_sam
from gaussctrl_exp_tpu.segmentation import sam as jsam
from gaussctrl_exp_tpu.utils.cliconf import parse_config as jparse_config
from gaussctrl_exp_tpu_torch.cli import render as render_cli
from gaussctrl_exp_tpu_torch.cli import train as train_cli
from gaussctrl_exp_tpu_torch.configs import GaussCtrlConfig
from gaussctrl_exp_tpu_torch.data import datamanager as tdm
from gaussctrl_exp_tpu_torch.data.dataparser import DataParserConfig
from gaussctrl_exp_tpu_torch.diffusion import convert as tconvert
from gaussctrl_exp_tpu_torch.diffusion.pipeline import GaussCtrlEditPipeline
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import init_random_models
from gaussctrl_exp_tpu_torch.engine import checkpoint as ckpt
from gaussctrl_exp_tpu_torch.engine import trainer as ttr
from gaussctrl_exp_tpu_torch.engine.optimizers import group_state
from gaussctrl_exp_tpu_torch.models.densify import DensifyConfig
from gaussctrl_exp_tpu_torch.models.gaussians import PARAM_NAMES, GaussianState, init_from_points
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig
from gaussctrl_exp_tpu_torch.segmentation import grounding as tgrounding
from gaussctrl_exp_tpu_torch.utils.cliconf import parse_config
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY
from torch_seg_tiny import CLI as SEG_CLI
from torch_seg_tiny import jax_clip_grounder, jax_langsam_logits, jax_sam_params, write_sam_pth, write_tiny_clip

pytestmark = pytest.mark.usefixtures("one_torch_thread")

METRIC_RTOL = 1e-4  # step-1 metrics, as tests/test_torch_train.py
DEPTH_RTOL = 1e-4  # depth, as tests/test_torch_render.py
# the TPU layout's counters, which the port's exactly sized binning has not
TPU_KEYS = {"n_aligned", "n_extra"}
COMMON = ["--max-num-iterations", "4", "--pipeline.render-rate", "4", "--steps-per-eval-image", "2",
          "--capacity", "64", "--train.model.background-color", "white", "--train.use-lpips", "False"]
JAX_RENDER = ["--train.model.render.impl", "jnp", "--train.model.render.isect-capacity", "4096",
              "--train.model.render.max-per-tile", "128"]


@pytest.fixture(scope="module")
def mini_scene(tmp_path_factory):
    """tests/test_cli_integration.py's scene: 3 views, 64x64, with a seed ply."""
    root = tmp_path_factory.mktemp("scene")
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    frames = []
    for i, ang in enumerate([0.0, 0.4, -0.4]):
        eye = np.array([4.0 * np.sin(ang), -4.0 * np.cos(ang), 1.0])
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :4] = jlook_at(eye, np.zeros(3))
        img = (rng.uniform(0, 255, (64, 64, 3))).astype(np.uint8)
        name = f"images/frame_{i+1:05d}.jpg"
        Image.fromarray(img).save(root / name)
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    n = 50
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    with open(root / "sparse_pc.ply", "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\nend_header\n")
        rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("r", "u1"), ("g", "u1"), ("b", "u1")])
        rec["x"], rec["y"], rec["z"] = xyz.T
        rec["r"], rec["g"], rec["b"] = rgb.T
        f.write(rec.tobytes())
    meta = {"w": 64, "h": 64, "fl_x": 70.0, "fl_y": 70.0, "cx": 32.0, "cy": 32.0,
            "camera_model": "OPENCV", "ply_file_path": "sparse_pc.ply", "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def _recorded_run(run, cfg, trainer_cls, dm_cls):
    """Run ``run(cfg)``, recording the gaussians the Trainer starts from and
    the views ``next_train`` serves."""
    seen = {"views": []}
    init, next_train = trainer_cls.__init__, dm_cls.next_train

    def rec_init(self, gs, *a, **k):
        seen["gs"] = gs
        init(self, gs, *a, **k)

    def rec_next(self):
        i, img = next_train(self)
        seen["views"].append(int(i))
        return i, img

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_cls, "__init__", rec_init)
        mp.setattr(dm_cls, "next_train", rec_next)
        trainer = run(cfg)
    return trainer, seen


@pytest.fixture(scope="module")
def runs(mini_scene, tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    base = ["--data", str(mini_scene), "--experiment-name", "mini", *COMMON]
    jcfg, _ = jparse_config(JGaussCtrlConfig, base + JAX_RENDER + ["--output-dir", str(out / "jax")])
    tcfg, _ = parse_config(GaussCtrlConfig, base + ["--output-dir", str(out / "port"), "--device", "cpu"])
    jax_trainer, jax_seen = _recorded_run(jtrain_cli.run, jcfg, jtr.Trainer, jdm.DataManager)
    trainer, seen = _recorded_run(train_cli.run, tcfg, ttr.Trainer, tdm.DataManager)
    return dict(out=out, jax=(jax_trainer, jax_seen), port=(trainer, seen))


def _events(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_run_matches_jax(runs):
    jax_trainer, jax_seen = runs["jax"]
    trainer, seen = runs["port"]
    assert trainer.step == jax_trainer.step == 4
    for n in PARAM_NAMES:  # the knn distances: a KD-tree there, brute force here
        np.testing.assert_allclose(getattr(seen["gs"].params, n).numpy(),
                                   np.asarray(getattr(jax_seen["gs"].params, n)), rtol=1e-5, atol=1e-6, err_msg=n)
    np.testing.assert_array_equal(seen["gs"].alive.numpy(), np.asarray(jax_seen["gs"].alive))
    assert seen["views"] == jax_seen["views"] and len(seen["views"]) == 4

    h, jh = trainer.history[0], jax_trainer.history[0]
    assert h["step"] == 1
    for k in ("l1", "ssim", "psnr", "main_loss"):
        np.testing.assert_allclose(h[k], jh[k], rtol=METRIC_RTOL, err_msg=k)

    out, jout = runs["out"] / "port" / "mini", runs["out"] / "jax" / "mini"
    ev, jev = _events(out / "logs" / "events.jsonl"), _events(jout / "logs" / "events.jsonl")
    assert {k for e in ev for k in e} == {k for e in jev for k in e} - TPU_KEYS
    assert [e["step"] for e in ev] == [e["step"] for e in jev]
    assert any("eval_psnr" in e for e in ev) and any("Gradients/Total" in e for e in ev)
    for pattern in ("eval_0*.png", "eval_depth_*.png"):
        assert len(list((out / "logs").glob(pattern))) == len(list((jout / "logs").glob(pattern))) == 2
    assert [p.name for p in (out / "ckpts").glob("step-*")] == ["step-000000004"]
    assert (out / "history.json").exists() and (out / "logs" / "config.json").exists()
    assert json.loads((out / "logs" / "config.json").read_text())["device"] == "cpu"

    # the final checkpoint holds the trainer's state
    gs, step = ckpt.load_gaussians(out / "ckpts", "cpu")
    assert step == 4
    for n in PARAM_NAMES:
        assert torch.equal(getattr(gs.params, n), getattr(trainer.state.params, n).detach())


def test_render_dataset_from_a_training_checkpoint(runs, mini_scene, tmp_path):
    """``render dataset`` reads the directory training wrote."""
    scene = tmp_path / "scene"
    shutil.copytree(mini_scene, scene)
    ckpts = runs["out"] / "port" / "mini" / "ckpts"
    frames = render_cli.main(["dataset", "--data", str(scene), "--ckpt", str(ckpts),
                              "--out", str(tmp_path / "r"), "--device", "cpu"])
    assert len(frames) == 3 and len(list((tmp_path / "r").glob("frame_*.png"))) == 3
    depths = sorted((scene / "depth_npy").glob("frame_*.npy"))
    assert [p.name for p in depths] == [f"frame_{i:05d}.npy" for i in (1, 2, 3)]
    assert np.load(depths[0]).shape == (64, 64) and np.isfinite(np.load(depths[0])).all()


def test_render_dataset_depth_matches_jax(mini_scene, tmp_path):
    """On a splatfacto checkpoint, the port's depth_npy/ equals the JAX CLI's."""
    gs = jinit_random(32, capacity=32, sh_degree=1, seed=0)
    jckpt.export_splatfacto_checkpoint(gs, tmp_path / "m.ckpt", step=10)
    scene = tmp_path / "scene"
    shutil.copytree(mini_scene, scene)
    jrender_cli.main(["dataset", "--data", str(scene), "--ckpt", str(tmp_path / "m.ckpt"), "--out", str(tmp_path / "j")])
    want = [np.load(p) for p in sorted((scene / "depth_npy").glob("*.npy"))]
    shutil.rmtree(scene / "depth_npy")
    render_cli.main(["dataset", "--data", str(scene), "--ckpt", str(tmp_path / "m.ckpt"),
                     "--out", str(tmp_path / "t"), "--device", "cpu"])
    got = [np.load(p) for p in sorted((scene / "depth_npy").glob("*.npy"))]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (64, 64)
        assert np.isfinite(w).all() and w.std() > 0
        np.testing.assert_allclose(g, w, rtol=DEPTH_RTOL)


# ---------------------------------------------------------------- checkpoints


def _dm(scene) -> tdm.DataManager:
    return tdm.DataManager(tdm.DataManagerConfig(dataparser=DataParserConfig(data=scene)), device="cpu")


# random background (the generator), an opacity reset at step 2, a densify
# at 6 (3 views: in-cycle position 6 > 3 + 2) and camera deltas updated every
# 3 steps: a resumed run reads every part of the state
RESUME_CFG = ttr.TrainConfig(model=SplatModelConfig(sh_degree_interval=2),
                             densify=DensifyConfig(warmup_length=1, refine_every=2, reset_alpha_every=4),
                             use_lpips=False, camera_opt=True, camera_opt_accum=3)


def _gaussians(dm) -> GaussianState:
    return init_from_points(dm.parsed.points_xyz, dm.parsed.points_rgb, capacity=64, device="cpu")


def _assert_states_equal(a, b):
    for n in PARAM_NAMES:
        assert torch.equal(getattr(a.params, n), getattr(b.params, n)), n
        sa, sb = group_state(a.optimizer, n), group_state(b.optimizer, n)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), (n, k)
    assert torch.equal(a.alive, b.alive) and a.step == b.step
    for f in ("xys_grad_sum", "vis_count", "max_radii2d"):
        assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), f
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.cam_deltas, b.cam_deltas)
    assert torch.equal(a.cam_optimizer.acc, b.cam_optimizer.acc)
    assert a.cam_optimizer.mini_step == b.cam_optimizer.mini_step


def test_checkpoint_round_trip_and_keep_only_latest(mini_scene, tmp_path):
    dm = _dm(mini_scene)
    trainer = ttr.Trainer(_gaussians(dm), dm, RESUME_CFG)
    trainer.train(4, log_every=1)
    ckpt.save_checkpoint(tmp_path / "ckpts", trainer.state, 2, keep_only_latest=False)
    ckpt.save_checkpoint(tmp_path / "ckpts", trainer.state, 4, keep_only_latest=False)
    assert len(list((tmp_path / "ckpts").glob("step-*"))) == 2
    d = ckpt.save_checkpoint(tmp_path / "ckpts", trainer.state, trainer.step, keep_only_latest=True)
    assert [p.name for p in (tmp_path / "ckpts").iterdir()] == [d.name] == ["step-000000004"]

    fresh = ttr.init_train_state(_gaussians(dm), RESUME_CFG, num_views=len(dm))
    state, step = ckpt.load_checkpoint(tmp_path / "ckpts", fresh, "cpu")
    assert step == 4 and state is fresh
    _assert_states_equal(state, trainer.state)
    state2, _ = ckpt.load_checkpoint(d, ttr.init_train_state(_gaussians(dm), RESUME_CFG, num_views=len(dm)), "cpu")
    _assert_states_equal(state2, trainer.state)


def test_resumed_training_equals_straight_training(mini_scene, tmp_path):
    """4 steps, save, load into a fresh state, 4 more = 8 steps straight,
    bit for bit on the CPU (the datamanager carries its own sampling)."""
    dm = _dm(mini_scene)
    first = ttr.Trainer(_gaussians(dm), dm, RESUME_CFG)
    first.train(4, log_every=1)
    ckpt.save_checkpoint(tmp_path / "c", first.state, first.step)
    resumed = ttr.Trainer(_gaussians(dm), dm, RESUME_CFG)
    resumed.state, resumed.step = ckpt.load_checkpoint(tmp_path / "c", resumed.state, "cpu")
    resumed.train(4, log_every=1)

    straight = ttr.Trainer(_gaussians(_dm(mini_scene)), _dm(mini_scene), RESUME_CFG)
    refines, resets = [], []
    refine, reset = straight.refine_step, straight.reset_opacity_step
    straight.refine_step = lambda st: (refines.append(straight.step), refine(st))[1]
    straight.reset_opacity_step = lambda st: (resets.append(straight.step), reset(st))[1]
    straight.train(8, log_every=1)
    assert refines == [6] and resets == [2]
    assert resumed.step == straight.step == 8
    _assert_states_equal(resumed.state, straight.state)
    assert resumed.history == straight.history[4:]


def test_orbax_checkpoint_is_refused(tmp_path):
    """The JAX package's checkpoints are orbax; the port says so."""
    gs = jinit_random(8, capacity=8, sh_degree=1, seed=0)
    jckpt.save_checkpoint(tmp_path / "ckpts", jtr.init_train_state(gs, jtr.TrainConfig()), 3)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_gaussians(tmp_path / "ckpts", "cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.load_gaussians(tmp_path, "cpu")


# ---------------------------------------------------------------- edit branch


def test_edit_branch_uses_the_mask_sidecars_and_writes_back(mini_scene, tmp_path, monkeypatch):
    scene = tmp_path / "scene"
    shutil.copytree(mini_scene, scene)
    (scene / "mask_npy").mkdir()
    rng = np.random.default_rng(2)
    masks = {i: (rng.uniform(size=(64, 64)) > 0.5).astype(np.float32) for i in range(3)}
    for i, m in masks.items():
        np.save(scene / "mask_npy" / f"frame_{i + 1:05d}.npy", m)
    loaded = []
    monkeypatch.setattr(tconvert, "load_sd_models",
                        lambda root, device="cuda", **k: loaded.append(root) or init_random_models(0, device, **TINY))
    seen = {}
    edit_images = GaussCtrlEditPipeline.edit_images

    def rec_edit(self, dm):
        seen["masks"] = {k: v.copy() for k, v in self.masks.items()}
        seen["unedited"] = dm.images.copy()
        edit_images(self, dm)

    written = {}
    write_back = tdm.DataManager.write_back

    def rec_write(self, i, image):
        written[i] = np.asarray(image, np.float32).copy()
        write_back(self, i, image)

    init = ttr.Trainer.__init__

    def rec_init(self, gs, dm, *a, **k):
        seen["train_images"] = dm.images.copy()
        init(self, gs, dm, *a, **k)

    monkeypatch.setattr(GaussCtrlEditPipeline, "edit_images", rec_edit)
    monkeypatch.setattr(tdm.DataManager, "write_back", rec_write)
    monkeypatch.setattr(ttr.Trainer, "__init__", rec_init)
    cfg, _ = parse_config(GaussCtrlConfig, [
        "--data", str(scene), "--output-dir", str(tmp_path / "out"), "--device", "cpu",
        "--max-num-iterations", "1", "--pipeline.render-rate", "1", "--steps-per-eval-image", "1",
        "--capacity", "64", "--train.use-lpips", "False", "--pipeline.edit-prompt", "a bronze statue",
        "--pipeline.reverse-prompt", "a photo", "--pipeline.num-inference-steps", "2",
        "--pipeline.chunk-size", "2", "--pipeline.ref-view-num", "2", "--pipeline.diffusion-ckpt", "sd-tiny"])
    trainer = train_cli.run(cfg)
    assert loaded == ["sd-tiny"] and trainer.step == 1
    assert sorted(seen["masks"]) == [0, 1, 2]
    for i, m in masks.items():
        np.testing.assert_array_equal(seen["masks"][i], m)
    assert sorted(written) == [0, 1, 2]
    for i in range(3):  # the edited images, written back before training
        np.testing.assert_array_equal(seen["train_images"][i], written[i])
        assert not np.array_equal(written[i], seen["unedited"][i])
    # the edit loop's sidecars, numbered by view, in the scene directory
    assert len(list((scene / "z_0").glob("frame_*.npy"))) == 3


# ---------------------------------------------------------------- live segmentation

EDIT_ARGS = ["--max-num-iterations", "1", "--pipeline.render-rate", "1", "--steps-per-eval-image", "1",
             "--capacity", "64", "--train.use-lpips", "False", "--pipeline.edit-prompt", "a bronze statue",
             "--pipeline.reverse-prompt", "a photo", "--pipeline.num-inference-steps", "2",
             "--pipeline.chunk-size", "2", "--pipeline.ref-view-num", "2", "--pipeline.diffusion-ckpt", "sd-tiny"]
# a mask may differ from the JAX LangSAM's only where every box's JAX logit
# is within this share of the largest magnitude of 0 (tests/test_torch_segmentation.py)
MASK_MARGIN = 1e-4


@pytest.fixture(scope="module")
def seg_ckpts(tmp_path_factory):
    """A tiny SAM .pth (segment_anything's keys) and a tiny CLIP directory."""
    root = tmp_path_factory.mktemp("seg")
    params = jax_sam_params(SEG_CLI, seed=3)
    return params, write_sam_pth(root / "sam.pth", params), write_tiny_clip(root / "clip")


def _scene_with_mask_sidecars(mini_scene, tmp_path):
    scene = tmp_path / "scene"
    shutil.copytree(mini_scene, scene)
    (scene / "mask_npy").mkdir()
    rng = np.random.default_rng(2)
    masks = {i: (rng.uniform(size=(64, 64)) > 0.5).astype(np.float32) for i in range(3)}
    for i, m in masks.items():
        np.save(scene / "mask_npy" / f"frame_{i + 1:05d}.npy", m)
    return scene, masks


def _edit_run(scene, tmp_path, monkeypatch, extra):
    """``cli.train.run`` with the edit phase on the tiny SD stack; records
    the pipeline's masks and renders at ``edit_images``, the written-back
    images and the datamanager's ``load_masks`` calls."""
    monkeypatch.setattr(tconvert, "load_sd_models", lambda root, device="cuda", **k: init_random_models(0, device, **TINY))
    seen = {"load_masks": 0, "written": {}}
    edit_images, write_back, load_masks = GaussCtrlEditPipeline.edit_images, tdm.DataManager.write_back, \
        tdm.DataManager.load_masks

    def rec_edit(self, dm):
        seen.update(masks={k: v.copy() for k, v in self.masks.items()}, provider=self.mask_provider,
                    unedited={k: v.copy() for k, v in self.unedited.items()})
        edit_images(self, dm)

    def rec_write(self, i, image):
        seen["written"][i] = np.asarray(image, np.float32).copy()
        write_back(self, i, image)

    def rec_load_masks(self):
        seen["load_masks"] += 1
        return load_masks(self)

    monkeypatch.setattr(GaussCtrlEditPipeline, "edit_images", rec_edit)
    monkeypatch.setattr(tdm.DataManager, "write_back", rec_write)
    monkeypatch.setattr(tdm.DataManager, "load_masks", rec_load_masks)
    cfg, _ = parse_config(GaussCtrlConfig, ["--data", str(scene), "--output-dir", str(tmp_path / "out"),
                                            "--device", "cpu", *EDIT_ARGS, *extra])
    assert train_cli.run(cfg).step == 1
    return seen


def test_edit_branch_with_live_segmentation_matches_jax_langsam(mini_scene, seg_ckpts, tmp_path, monkeypatch):
    """``--pipeline.langsam-obj`` with ``--pipeline.sam-ckpt`` and
    ``--pipeline.clip-ckpt``: the masks handed to edit_images are the JAX
    LangSAM's (CLIP grounding, SAM) on the same renders, the mask_npy/
    sidecars are not read, and each written-back image is its render where
    the mask is 0."""
    params, sam_pth, clip_dir = seg_ckpts
    scene, sidecars = _scene_with_mask_sidecars(mini_scene, tmp_path)
    seen = _edit_run(scene, tmp_path, monkeypatch, ["--pipeline.langsam-obj", "bear", "--pipeline.sam-ckpt",
                                                    str(sam_pth), "--pipeline.clip-ckpt", str(clip_dir)])
    assert seen["load_masks"] == 0 and seen["provider"] is not None
    ref = jlang_sam.LangSAM(params, jsam.SAMConfig(**SEG_CLI), box_provider=jax_clip_grounder(clip_dir))
    port_boxes = tgrounding.load_clip_grounder(str(clip_dir), device="cpu")
    assert sorted(seen["masks"]) == sorted(seen["unedited"]) == [0, 1, 2]
    for i, rgb in seen["unedited"].items():
        got = seen["masks"][i]
        assert got.dtype == np.float32 and got.shape == (64, 64) and set(np.unique(got)) <= {0.0, 1.0}
        img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        boxes, logits = jax_langsam_logits(ref, img, "bear")
        np.testing.assert_array_equal(port_boxes(img, "bear")[0], boxes)
        away = np.abs(logits).min(axis=0) > MASK_MARGIN * np.abs(logits).max()
        np.testing.assert_array_equal(got[away], ref.as_mask_provider()(rgb, "bear")[away])
        assert away.mean() > 0.99 and not np.array_equal(got, sidecars[i])
        keep = got == 0
        np.testing.assert_array_equal(seen["written"][i][keep], rgb[keep])
        # the pipeline persists the live masks as the scene's sidecars
        np.testing.assert_array_equal(np.load(scene / "mask_npy" / f"frame_{i + 1:05d}.npy"), got)
    assert any(0 < m.mean() < 1 for m in seen["masks"].values())


def test_sam_ckpt_without_langsam_obj_reads_the_mask_sidecars(mini_scene, seg_ckpts, tmp_path, monkeypatch):
    """As the JAX package: a provider needs both the object and the SAM
    checkpoint; without the object the masks are the mask_npy/ sidecars."""
    _, sam_pth, clip_dir = seg_ckpts
    scene, sidecars = _scene_with_mask_sidecars(mini_scene, tmp_path)
    monkeypatch.setattr("gaussctrl_exp_tpu_torch.segmentation.convert.load_sam",
                        lambda *a, **k: pytest.fail("load_sam called without --pipeline.langsam-obj"))
    seen = _edit_run(scene, tmp_path, monkeypatch, ["--pipeline.sam-ckpt", str(sam_pth),
                                                    "--pipeline.clip-ckpt", str(clip_dir)])
    assert seen["load_masks"] == 1 and seen["provider"] is None
    assert sorted(seen["masks"]) == [0, 1, 2]
    for i, m in sidecars.items():
        np.testing.assert_array_equal(seen["masks"][i], m)


@pytest.mark.parametrize("flag", [["--viewer-port", "1"]])
def test_unported_branches_raise(mini_scene, tmp_path, flag):
    cfg, _ = parse_config(GaussCtrlConfig, ["--data", str(mini_scene), "--output-dir", str(tmp_path),
                                            "--device", "cpu", *flag])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_cli.run(cfg)


def test_train_cli_refuses_a_missing_card(mini_scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so cuda is not refused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--data", str(mini_scene), "--output-dir", str(tmp_path)])


# ---------------------------------------------------------------- writer


class _FakeSummaryWriter:
    def __init__(self, log_dir):
        self.calls = [("init", Path(log_dir).name)]

    def add_scalar(self, *a):
        self.calls.append(("scalar", *a))

    def add_image(self, name, img, step, dataformats):
        self.calls.append(("image", name, img.shape, step, dataformats))

    def close(self):
        self.calls.append(("close",))


def test_event_writer_and_profiler(tmp_path, monkeypatch):
    import sys
    import types

    from gaussctrl_exp_tpu_torch.engine.writer import EventWriter, Profiler
    from gaussctrl_exp_tpu_torch.utils.png import read_png

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(SummaryWriter=_FakeSummaryWriter))
    w = EventWriter(tmp_path / "logs", use_tensorboard=True, quiet=True)
    w.put_config(GaussCtrlConfig())
    w.put_scalars(3, {"l1": torch.tensor(0.5), "psnr": 20.0})
    img = np.linspace(0, 1, 4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)
    w.put_image(3, "eval", img)
    tb = w._tb
    w.close()
    assert json.loads((tmp_path / "logs" / "config.json").read_text())["capacity"] == 1 << 17
    (rec,) = _events(tmp_path / "logs" / "events.jsonl")
    assert rec["step"] == 3 and rec["l1"] == 0.5 and rec["psnr"] == 20.0
    np.testing.assert_array_equal(read_png(tmp_path / "logs" / "eval_000003.png"), (img * 255).astype(np.uint8))
    assert tb.calls == [("init", "tb"), ("scalar", "l1", 0.5, 3), ("scalar", "psnr", 20.0, 3),
                        ("image", "eval", (4, 5, 3), 3, "HWC"), ("close",)]
    # without TensorBoard installed: JSONL and the console only
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = EventWriter(tmp_path / "logs2", use_tensorboard=True, quiet=True)
    assert w._tb is None
    w.put_scalars(1, {"l1": 1.0})
    w.close()

    prof = Profiler(tmp_path / "logs", enabled=True)
    prof.start()
    with prof.annotate("step"):
        torch.ones(8).sum()
    prof.stop()
    assert '"step"' in (tmp_path / "logs" / "profile" / "trace.json").read_text()

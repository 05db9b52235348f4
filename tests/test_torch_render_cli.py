"""PyTorch port vs the JAX package: the rest of ``gctpu-render``
(``interpolate``, ``spiral``, stereo camera paths, ``--fmt jpg``, video
output and the nearest-camera probe).

The camera builders (``path_cameras`` for every camera type, ``offset_eye``,
``rotmat_to_quat``, ``interp_poses``, the spiral and interpolation cameras
the subcommands build) equal the JAX functions' exactly (the same numpy and
float32 arithmetic). The probe's appended column equals the JAX probe's bit
for bit on a PNG scene (Pillow reads and resizes in both packages) with and
without the occlusion check, on a scene whose nearest view
a wall of gaussians hides. Whole frames from the CLIs are held to the JAX
CLI's within 1 of 255 (the renders agree to ~1e-5, so a value near a
quantisation step can round the other way). Torch on one thread.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gaussctrl_exp_tpu.cameras import make_camera as jmake_camera
from gaussctrl_exp_tpu.cli import render as jcli
from gaussctrl_exp_tpu.data.dataparser import DataParserConfig as JParserConfig
from gaussctrl_exp_tpu.data.dataparser import load_scene as jload_scene
from gaussctrl_exp_tpu_torch.cameras import look_at
from gaussctrl_exp_tpu_torch.cli import render as cli
from gaussctrl_exp_tpu_torch.data.dataparser import DataParserConfig, load_scene
from gaussctrl_exp_tpu_torch.engine.checkpoint import import_splatfacto_checkpoint
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model
from torch_data_scenes import write_scene
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FRAME_MAX_DIFF = 1  # of 255
CTYPES = ["perspective", "fisheye", "equirectangular", "omni-directional-stereo", "omni_directional_stereo",
          "omnidirectional", "ODS", "vr180", "VR180"]


def _params(n, seed, center=(0.0, 0.0, 0.0), spread=0.3, log_scale=-3.0, opacity=2.0):
    rng = np.random.default_rng(seed)
    return dict(
        means=(np.asarray(center) + rng.normal(size=(n, 3)) * spread).astype(np.float32),
        scales=np.full((n, 3), log_scale, np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 0.2,
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        features_dc=rng.normal(size=(n, 3)).astype(np.float32),
        features_rest=(rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        opacities=np.full((n, 1), opacity, np.float32),
    )


def _write_ckpt(path, arrays):
    sd = {f"_model.gauss_params.{k}": torch.as_tensor(v) for k, v in arrays.items()}
    torch.save({"step": 29_999, "pipeline": sd}, str(path))


def _path_json(path: Path, c2ws, ctype="perspective", H=24, W=32):
    frames = [{"camera_to_world": np.concatenate([np.asarray(c, np.float32)[:3, :4], [[0, 0, 0, 1]]]).reshape(-1)
               .tolist(), "fov": 50.0 + i} for i, c in enumerate(c2ws)]
    path.write_text(json.dumps({"render_height": H, "render_width": W, "camera_type": ctype, "camera_path": frames}))
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 4-view 32×24 PNG scene, its parse, and a checkpoint (a blob at the
    origin) in the parsed frame."""
    root = write_scene(tmp_path_factory.mktemp("scene") / "s", n=4, w=32, h=24, fmt="png")
    parsed = load_scene(DataParserConfig(data=root))
    ckpt = root.parent / "blob.ckpt"
    _write_ckpt(ckpt, _params(200, 0))
    return root, parsed, ckpt


def _same_camera(a, b):
    np.testing.assert_array_equal(a.c2w.cpu().numpy(), np.asarray(b.c2w))
    for k in ("fx", "fy", "cx", "cy"):
        assert np.float32(getattr(a, k)) == np.float32(getattr(b, k)), k
    assert (a.width, a.height) == (int(b.width), int(b.height))


@pytest.mark.parametrize("ctype", CTYPES)
def test_path_cameras_match_jax_for_every_camera_type(tmp_path, ctype):
    c2ws = [np.concatenate([look_at([3.0 * np.sin(a), -3.0, 0.5], np.zeros(3)), [[0, 0, 0, 1]]]) for a in (0.0, 0.3)]
    p = _path_json(tmp_path / "p.json", c2ws, ctype)
    for ds in (1, 2):
        jcams, jstereo = jcli._path_cameras(p, ds)
        cams = cli.path_cameras(p, ds, device="cpu")
        assert cli.path_stereo(p) == jstereo
        assert len(cams) == len(jcams) == 2
        for a, b in zip(cams, jcams):
            _same_camera(a, b)


def test_offset_eye_and_rotmat_to_quat_match_jax():
    rng = np.random.default_rng(0)
    cam = cli.make_camera(look_at([1.0, -3.0, 0.7], [0.1, 0.2, 0.0]), 40.0, 41.0, 16.0, 12.0, 32, 24, device="cpu")
    jcam = jmake_camera(np.asarray(cam.c2w), 40.0, 41.0, 16.0, 12.0, 32, 24)
    for off in (-0.032, 0.032, 0.5):
        _same_camera(cli.offset_eye(cam, off), jcli._offset_eye(jcam, off))
    rots = [np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(20)]
    rots = [r * np.sign(np.linalg.det(r)) for r in rots]
    rots += [np.diag(d).astype(np.float64) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]  # trace ≤ 0
    for R in rots:
        np.testing.assert_array_equal(cli.rotmat_to_quat(R), jcli._rotmat_to_quat(R))
        np.testing.assert_array_equal(cli.rotmat_to_quat(R.astype(np.float32)),
                                      jcli._rotmat_to_quat(R.astype(np.float32)))


def test_interp_poses_match_jax(world):
    _, parsed, _ = world
    c2ws = list(np.asarray(parsed.cameras.c2w))
    for steps in (1, 3, 10):
        got, want = cli.interp_poses(c2ws, steps), jcli._interp_poses(c2ws, steps)
        assert len(got) == len(want) == steps * (len(c2ws) - 1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _captured_cameras(monkeypatch, argv):
    """The cameras (and options) each CLI hands its renderer, without rendering."""
    seen = {}
    monkeypatch.setattr(jcli, "_load_state", lambda args: None)
    monkeypatch.setattr(jcli, "_render_cameras", lambda gs, cams, *a, **k: seen.update(jax=(cams, k)))
    monkeypatch.setattr(cli, "load_state", lambda ckpt, device: None)
    monkeypatch.setattr(cli, "render_cameras", lambda st, cams, *a, **k: seen.update(port=(cams, k)))
    jcli.main(argv)
    cli.main(argv + ["--device", "cpu"])
    return seen


@pytest.mark.parametrize("sub", [["spiral", "--frames", "5"], ["interpolate", "--steps", "3"],
                                 ["spiral", "--frames", "4", "--downscale-factor", "2"]])
def test_subcommand_cameras_match_jax(world, tmp_path, monkeypatch, sub):
    root, _, ckpt = world
    seen = _captured_cameras(monkeypatch, [sub[0], "--data", str(root), "--ckpt", str(ckpt),
                                           "--out", str(tmp_path / "o"), "--fps", "7", *sub[1:]])
    (cams, kw), (jcams, jkw) = seen["port"], seen["jax"]
    assert len(cams) == len(jcams) > 0
    for a, b in zip(cams, jcams):
        _same_camera(a, b)
    assert kw["video"] and jkw["video"] and kw["fps"] == jkw["fps"] == 7


@pytest.mark.parametrize("ctype,stereo", [("omni-directional-stereo", "ods"), ("vr180", "vr180")])
def test_camera_path_options_match_jax(world, tmp_path, monkeypatch, ctype, stereo):
    root, _, ckpt = world
    p = _path_json(tmp_path / "p.json", [np.eye(4)[:3] + np.array([[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 3.0]])],
                   ctype)
    seen = _captured_cameras(monkeypatch, ["camera-path", "--camera-path", str(p), "--ckpt", str(ckpt), "--out",
                                           str(tmp_path / "o"), "--ipd", "0.1"])
    (cams, kw), (jcams, jkw) = seen["port"], seen["jax"]
    _same_camera(cams[0], jcams[0])
    assert kw["stereo"] == jkw["stereo"] == stereo and kw["ipd"] == jkw["ipd"] == 0.1
    with pytest.raises(SystemExit, match="requires --data"):
        cli.main(["camera-path", "--camera-path", str(p), "--ckpt", str(ckpt), "--out", str(tmp_path / "o"),
                  "--render-nearest-camera", "--device", "cpu"])


def test_nearest_camera_probe_matches_jax(world, tmp_path):
    """A wall of gaussians between the path camera and its nearest view (and
    nothing else in the scene): without the check the probe picks that view,
    with it the next nearest, and the appended column is the JAX probe's
    bit for bit either way."""
    root, parsed, _ = world
    c2w0 = np.asarray(parsed.cameras.c2w[0], np.float64)
    p0 = c2w0[:3, 3]
    pos = p0 + 0.1 * c2w0[:3, 0]
    path_c2w = np.concatenate([c2w0[:, :3], pos[:, None]], axis=1).astype(np.float32)
    wall = _params(60, 1, center=(pos + p0) / 2, spread=0.004, log_scale=-5.0, opacity=6.0)
    _write_ckpt(tmp_path / "wall.ckpt", wall)
    state, _ = import_splatfacto_checkpoint(tmp_path / "wall.ckpt", device="cpu")
    jstate = jcli._load_state(type("A", (), {"ckpt": str(tmp_path / "wall.ckpt")})())
    render_jit = jcli._make_render_jit()
    cam = cli.make_camera(path_c2w, 30.0, 30.0, 16.0, 12.0, 32, 24, device="cpu")
    jcam = jmake_camera(path_c2w, 30.0, 30.0, 16.0, 12.0, 32, 24)
    cfg = SplatModelConfig(background_color="white")
    picks = {}
    for check in (False, True):
        probe = cli.NearestCameraProbe(parsed, check)
        jprobe = jcli.NearestCameraProbe(jload_scene(JParserConfig(data=root)), check)
        picks[check] = probe.nearest_index(state, cam, cfg)
        got = probe.lookup(state, cam, 24, cfg)
        np.testing.assert_array_equal(got, jprobe.lookup(jstate, render_jit, jcam, 24))
        assert got.shape == (24, 32, 3)
        assert (probe.probes > 0) == check
    assert picks[False] == 0 and picks[True] != 0
    np.testing.assert_array_equal(probe.lookup(state, cam, 48, cfg),
                                  np.asarray(Image.open(parsed.image_filenames[picks[True]]).resize((64, 48))))


def _frames(d: Path, fmt="png"):
    files = sorted(d.glob(f"frame_*.{fmt}"))
    return [np.asarray(Image.open(p).convert("RGB")) for p in files]


@pytest.mark.parametrize("argv", [["spiral", "--frames", "3"], ["interpolate", "--steps", "2"]])
def test_subcommand_frames_match_jax_cli(world, tmp_path, argv):
    root, _, ckpt = world
    common = ["--data", str(root), "--ckpt", str(ckpt), "--fps", "5", "--outputs", "rgb", "depth"]
    jcli.main([argv[0], *common, "--out", str(tmp_path / "j"), *argv[1:]])
    frames = cli.main([argv[0], *common, "--out", str(tmp_path / "t"), "--device", "cpu", *argv[1:]])
    want = _frames(tmp_path / "j")
    assert len(frames) == len(want) == {"spiral": 3, "interpolate": 6}[argv[0]]
    for got, f, w in zip(_frames(tmp_path / "t"), frames, want):
        np.testing.assert_array_equal(got, f)
        assert got.shape == w.shape == (24, 64, 3)
        assert np.abs(got.astype(int) - w).max() <= FRAME_MAX_DIFF
    gif = Image.open(tmp_path / "t" / "render.gif")
    assert gif.n_frames == len(frames) and gif.info["duration"] == 200


@pytest.mark.parametrize("ctype,shape", [("omni-directional-stereo", (48, 32, 3)), ("vr180", (24, 64, 3))])
def test_stereo_camera_path_frames_match_jax_cli(world, tmp_path, ctype, shape):
    root, parsed, ckpt = world
    p = _path_json(tmp_path / "p.json", list(np.asarray(parsed.cameras.c2w[:2])), ctype)
    common = ["camera-path", "--camera-path", str(p), "--ckpt", str(ckpt), "--fps", "4", "--ipd", "0.05"]
    jcli.main(common + ["--out", str(tmp_path / "j")])
    frames = cli.main(common + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    state, _ = import_splatfacto_checkpoint(ckpt, device="cpu")
    cams = cli.path_cameras(p, device="cpu")
    for got, f, w, cam in zip(_frames(tmp_path / "t"), frames, _frames(tmp_path / "j"), cams):
        assert got.shape == w.shape == shape
        np.testing.assert_array_equal(got, f)
        assert np.abs(got.astype(int) - w).max() <= FRAME_MAX_DIFF
        with torch.no_grad():  # the left eye is the camera shifted −ipd/2 along its right axis
            left = render_model(state, cli.offset_eye(cam, -0.025), cli.EVAL_STEP, SplatModelConfig(
                background_color="white")).rgb
        np.testing.assert_array_equal(f[:24, :32], (left.clamp(0, 1).numpy() * 255).astype(np.uint8))
    assert (tmp_path / "t" / "render.gif").exists()


def test_fmt_jpg_frames(world, tmp_path):
    """``--fmt jpg``: each frame a JPEG at Pillow's default quality (75), the
    bytes of the JAX CLI's frame on the same scene and Pillow's encode of
    the frame the port returns."""
    import io

    root, _, ckpt = world
    common = ["spiral", "--data", str(root), "--ckpt", str(ckpt), "--frames", "2", "--fmt", "jpg"]
    jcli.main(common + ["--out", str(tmp_path / "j")])
    frames = cli.main(common + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    got, want = (sorted((tmp_path / d).glob("frame_*.jpg")) for d in ("t", "j"))
    assert len(got) == len(want) == 2 and not list((tmp_path / "t").glob("*.png"))
    for g, w, f in zip(got, want, frames):
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, "JPEG")
        assert g.read_bytes() == w.read_bytes() == buf.getvalue()

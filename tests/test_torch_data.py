"""PyTorch port vs the JAX package: the scene loader.

``native/`` (the port's own g++ builds of the PLY reader and the image
library), ``data/undistort.py``, ``data/ply.py``, ``data/dataparser.py``,
``data/datamanager.py`` (its Pillow reads and resizes too), the PNG of
``engine/writer.py``, ``utils/cliconf.py`` and ``configs.py``. Scenes are
written to ``tmp_path`` from seeds (``tests/torch_data_scenes.py``). Everything before the cameras is numpy
or the same C++ source, so the port must equal the JAX package bit for bit.
"""

import dataclasses
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gaussctrl_exp_tpu.cameras import camera_matrices as jcamera_matrices
from gaussctrl_exp_tpu.configs import GaussCtrlConfig as JGaussCtrlConfig
from gaussctrl_exp_tpu.data import datamanager as jdm
from gaussctrl_exp_tpu.data import dataparser as jdp
from gaussctrl_exp_tpu.data import ply as jply
from gaussctrl_exp_tpu.data import undistort as jund
from gaussctrl_exp_tpu.engine.writer import EventWriter as JEventWriter
from gaussctrl_exp_tpu.utils.cliconf import parse_config as jparse_config
from gaussctrl_exp_tpu_torch import native
from gaussctrl_exp_tpu_torch.cameras import camera_matrices
from gaussctrl_exp_tpu_torch.configs import GaussCtrlConfig
from gaussctrl_exp_tpu_torch.data import datamanager as tdm
from gaussctrl_exp_tpu_torch.data import dataparser as tdp
from gaussctrl_exp_tpu_torch.data import ply as tply
from gaussctrl_exp_tpu_torch.data import undistort as tund
from gaussctrl_exp_tpu_torch.engine.writer import EventWriter
from gaussctrl_exp_tpu_torch.utils.cliconf import parse_config
from torch_data_scenes import OPENCV, PLY_FORMATS, write_ply, write_scene
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "cv2", "gaussctrl_exp_tpu")


# ---------------------------------------------------------------- native/


def test_native_libraries_build_into_the_port(tmp_path, monkeypatch):
    """Each library is built from the port's own copy of its source, keyed by
    the source's hash, into gaussctrl_exp_tpu_torch/_build/ (here a fresh
    directory in its place); the JAX package's native/ gets nothing."""
    port_native = REPO / "gaussctrl_exp_tpu_torch" / "native"
    jax_native = REPO / "gaussctrl_exp_tpu" / "native"
    assert native.BUILD_DIR == REPO / "gaussctrl_exp_tpu_torch" / "_build"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    for name, get in (("plyio", native.get_plyio), ("imageio", native.get_imageio)):
        assert (port_native / f"{name}.cpp").exists()
        lib = native.library_path(name)
        assert lib.parent == tmp_path / "_build" and not lib.exists()
        get()
        assert lib.exists()
        assert not (jax_native / lib.name).exists()
    assert sorted(p.suffix for p in (tmp_path / "_build").iterdir()) == [".so", ".so"]


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "plyio.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_DIR", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*plyio.cpp"):
        native.build("plyio")


# ---------------------------------------------------------------- undistort


DISTORTIONS = [
    (0.02, -0.004, 0.0, 0.0, 0.001, -0.0007),
    (-0.08, 0.01, 0.002, 0.0, 0.0, 0.0),
    (0.05, 0.02, -0.01, 0.01, -0.002, 0.003),
]


@pytest.mark.parametrize("dist6", DISTORTIONS)
def test_undistort_geometry_matches_jax(dist6):
    K = np.array([[300.0, 0, 161.3], [0, 302.0, 118.9], [0, 0, 1]])
    newK, roi = tund.optimal_new_K(K, np.array(dist6), 320, 240)
    jK, jroi = jund.optimal_new_K(K, np.array(dist6), 320, 240)
    np.testing.assert_array_equal(newK, jK)
    assert roi == jroi
    pts = np.random.default_rng(0).uniform(0, 320, (50, 2))
    np.testing.assert_array_equal(tund.undistort_points(pts, K, dist6), jund.undistort_points(pts, K, dist6))
    xy = np.random.default_rng(1).uniform(-0.5, 0.5, (50, 2))
    np.testing.assert_array_equal(tund.distort_points(xy, dist6), jund.distort_points(xy, dist6))


# ---------------------------------------------------------------- PLY


@pytest.mark.parametrize("fmt", PLY_FORMATS)
def test_ply_readers_agree_with_jax(tmp_path, fmt):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(25, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (25, 3)).astype(np.uint8)
    path = tmp_path / "pc.ply"
    write_ply(path, xyz, rgb, fmt)
    got_native = tply.read_ply_points_native(path)
    got_numpy = tply.read_ply_points_numpy(path)
    assert got_native is not None
    for (got, want) in ((tply.read_ply_points(path), jply.read_ply_points(path)),
                        (got_native, jply.read_ply_points(path)),
                        (got_numpy, jply.read_ply_points_numpy(path))):
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got_native[0], got_numpy[0])
    np.testing.assert_allclose(got_native[0], xyz, atol=1e-6 if fmt == "ascii" else 0)
    if fmt == "no_rgb":
        assert got_native[1] is None and got_numpy[1] is None
    elif fmt == "float_rgb":
        # both packages: the native reader casts the float colours as they
        # stand, the numpy parser scales [0, 1] by 255
        np.testing.assert_array_equal(got_native[1], (rgb / 255.0).astype(np.float32).astype(np.uint8))
        np.testing.assert_array_equal(got_numpy[1], ((rgb / 255.0).astype(np.float32) * 255.0).astype(np.uint8))
    else:
        np.testing.assert_array_equal(got_native[1], rgb)
        np.testing.assert_array_equal(got_numpy[1], rgb)


def test_ply_garbage_is_refused_by_both_packages(tmp_path):
    path = tmp_path / "bad.ply"
    path.write_bytes(b"not a ply file\x00\x01")
    assert tply.read_ply_points_native(path) is None
    with pytest.raises(ValueError, match="not a PLY"):
        tply.read_ply_points(path)
    with pytest.raises(ValueError, match="not a PLY"):
        jply.read_ply_points(path)


# ---------------------------------------------------------------- PNG (Pillow in both packages)


def _filter_rows(px: np.ndarray, ftypes) -> bytes:
    """PNG-filter (H, W, bpp) uint8 rows with the given filter type per row."""
    h, w, bpp = px.shape
    cur = px.astype(np.int32)
    out = []
    for r in range(h):
        x = cur[r]
        up = cur[r - 1] if r else np.zeros_like(x)
        a = np.concatenate([np.zeros((1, bpp), np.int32), x[:-1]])
        c = np.concatenate([np.zeros((1, bpp), np.int32), up[:-1]])
        t = ftypes[r % len(ftypes)]
        if t == 0:
            pred = 0
        elif t == 1:
            pred = a
        elif t == 2:
            pred = up
        elif t == 3:
            pred = (a + up) >> 1
        else:
            p = a + up - c
            pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
        out.append(bytes([t]) + ((x - pred) & 255).astype(np.uint8).tobytes())
    return b"".join(out)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png(path, px, ctype, ftypes, palette=None, depth=8, interlace=0):
    h, w = px.shape[:2]
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    passes = [px[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if interlace else [px]
    body += _chunk(b"IDAT", zlib.compress(b"".join(_filter_rows(p, ftypes) for p in passes if p.size), 9))
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b""))


CTYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("ftypes", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("ctype", sorted(CTYPES))
def test_load_image_matches_jax_on_png_filters(tmp_path, ctype, ftypes):
    rng = np.random.default_rng(ctype * 10 + len(ftypes))
    h, w = 19, 23
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        px = rng.integers(0, 40, (h, w, 1)).astype(np.uint8)
    else:
        px = rng.integers(0, 256, (h, w, CTYPES[ctype])).astype(np.uint8)
    path = tmp_path / "t.png"
    _png(path, px, ctype, ftypes, palette)
    got = tdm._load_image(path)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, jdm._load_image(path))


@pytest.mark.parametrize("mode", ["L", "LA", "P", "RGB", "RGBA"])
def test_load_image_matches_jax_on_what_pil_writes(tmp_path, mode):
    """PIL chooses the row filters itself (adaptively for 8-bit non-palette)."""
    from torch_data_scenes import smooth_image

    img = Image.fromarray(smooth_image(np.random.default_rng(5), 37, 41))
    img = img.quantize(64) if mode == "P" else img.convert(mode)
    img.save(tmp_path / "t.png")
    np.testing.assert_array_equal(tdm._load_image(tmp_path / "t.png"), jdm._load_image(tmp_path / "t.png"))


def test_event_writer_png_round_trips(tmp_path):
    """The eval image's PNG reads back as the quantised frame, and its bytes
    are the JAX writer's."""
    img = np.random.default_rng(0).uniform(0, 1, (17, 29, 3)).astype(np.float32)
    for cls, sub in ((EventWriter, "port"), (JEventWriter, "jax")):
        w = cls(tmp_path / sub, quiet=True)
        w.put_image(3, "eval", img)
        w.close()
    got = tmp_path / "port" / "eval_000003.png"
    np.testing.assert_array_equal(np.asarray(Image.open(got)), (img * 255).astype(np.uint8))
    assert got.read_bytes() == (tmp_path / "jax" / "eval_000003.png").read_bytes()


def test_load_image_and_fit_to_match_jax_where_the_reader_refused(tmp_path):
    """Interlaced, 16-bit and one-bit PNGs load as the JAX package loads them,
    a file Pillow cannot identify raises as it raises there, and a
    non-integer downscale is the JAX package's LANCZOS."""
    rng = np.random.default_rng(7)
    _png(tmp_path / "interlaced.png", rng.integers(0, 256, (9, 11, 3)).astype(np.uint8), 2, (0,), interlace=1)
    Image.fromarray(rng.integers(0, 65536, (9, 11)).astype(np.uint16)).save(tmp_path / "sixteen.png")
    Image.fromarray(rng.integers(0, 2, (9, 11)).astype(bool)).save(tmp_path / "onebit.png")
    (tmp_path / "notpng.png").write_bytes(b"GIF89a")
    for name in ("interlaced.png", "sixteen.png", "onebit.png"):
        got = tdm._load_image(tmp_path / name)
        assert got.shape == (9, 11, 3), name
        np.testing.assert_array_equal(got, jdm._load_image(tmp_path / name), err_msg=name)
    errors = []
    for mod in (tdm, jdm):
        with pytest.raises(OSError, match="notpng.png") as e:
            mod._load_image(tmp_path / "notpng.png")
        errors.append(e.type)
    assert errors[0] is errors[1]
    img = tdm._load_image(tmp_path / "interlaced.png")
    for H, W in ((4, 5), (13, 17), (9, 11), (3, 11)):
        got = tdm._fit_to(img, H, W)
        assert got.dtype == np.float32 and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, jdm._fit_to(img, H, W))


# ---------------------------------------------------------------- dataparser


def _assert_outputs_equal(got, want):
    assert got.image_filenames == want.image_filenames
    for f in dataclasses.fields(want.cameras):
        g, w = getattr(got.cameras, f.name), getattr(want.cameras, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
    np.testing.assert_array_equal(got.dataparser_transform, want.dataparser_transform)
    assert got.dataparser_transform.dtype == want.dataparser_transform.dtype
    assert got.dataparser_scale == want.dataparser_scale
    for name in ("points_xyz", "points_rgb", "indices"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("depth_filenames", "z0_filenames", "mask_filenames", "unedited_filenames"):
        assert getattr(got, name) == getattr(want, name), name


FILENAMES = [f"{kind}_{i:03d}.jpg" for i, kind in enumerate(["train", "eval", "train", "test", "train", "train"])]
SCENES = {
    # case: (write_scene kwargs, DataParserConfig kwargs, splits)
    "global": ({}, {}, ("train",)),
    "per_frame_opencv": (dict(per_frame=True, distortion=OPENCV), {}, ("train",)),
    "global_opencv": (dict(distortion=dict(OPENCV, k3=0.0005)), {}, ("train",)),
    "fraction": (dict(n=9), dict(train_split_fraction=0.75), ("train", "val")),
    "interval": (dict(n=10), dict(eval_mode="interval", eval_interval=3), ("train", "val")),
    "filename": (dict(names=FILENAMES), dict(eval_mode="filename"), ("train", "val")),
    "all": (dict(n=5), dict(eval_mode="all"), ("train", "val")),
    "explicit_lists": (dict(n=6, split_lists={
        "train_filenames": [f"images/frame_{i:05d}.jpg" for i in (1, 2, 4, 6)],
        "val_filenames": [f"images/frame_{i:05d}.jpg" for i in (3, 5)],
        "test_filenames": ["images/frame_00005.jpg"]}), {}, ("train", "val", "test")),
    "no_orient_no_centre": ({}, dict(orientation_method="none", center_method="none"), ("train",)),
    "no_autoscale_half": ({}, dict(auto_scale_poses=False, scale_factor=0.5), ("train",)),
    "ds2_folder": (dict(image_scale=2, ds_folder=2), dict(downscale_factor=2), ("train",)),
    "ds2_no_folder": (dict(image_scale=2), dict(downscale_factor=2), ("train",)),
    "ply_ascii": (dict(ply="ascii"), {}, ("train",)),
    "ply_big_endian": (dict(ply="binary_big_endian"), {}, ("train",)),
    "ply_float_rgb": (dict(ply="float_rgb"), {}, ("train",)),
    "ply_no_rgb": (dict(ply="no_rgb"), {}, ("train",)),
    "ply_applied_scale": (dict(applied_scale=0.37), {}, ("train",)),
    "no_ply": (dict(ply=None), {}, ("train",)),
    "sidecars": (dict(sidecars=True), dict(train_split_fraction=0.75), ("train", "val")),
    "sidecars_no_masks": (dict(sidecars=True), dict(load_mask=False), ("train",)),
}


@pytest.mark.parametrize("case", sorted(SCENES))
def test_load_scene_matches_jax(tmp_path, case):
    scene_kw, cfg_kw, splits = SCENES[case]
    root = write_scene(tmp_path / "scene", **scene_kw)
    for split in splits:
        got = tdp.load_scene(tdp.DataParserConfig(data=root, **cfg_kw), split)
        want = jdp.load_scene(jdp.DataParserConfig(data=root, **cfg_kw), split)
        _assert_outputs_equal(got, want)
        assert len(got.image_filenames) > 0
    if case == "ds2_folder":
        assert all(p.parent.name == "images_2" for p in got.image_filenames)
    if case == "sidecars":
        assert got.mask_filenames is not None and got.depth_filenames is not None


def test_split_lists_missing_key_raises_as_jax(tmp_path):
    root = write_scene(tmp_path / "s", split_lists={"train_filenames": ["images/frame_00001.jpg"]})
    for mod in (tdp, jdp):
        with pytest.raises(RuntimeError, match="val_filenames"):
            mod.load_scene(mod.DataParserConfig(data=root), "val")


# ---------------------------------------------------------------- DataManager


DM_SCENES = {
    "jpeg_opencv": (dict(fmt="jpg", distortion=OPENCV, sidecars=True), {}),
    "png": (dict(fmt="png", image_scale=2, sidecars=True), dict(downscale_factor=2)),
    "png_opencv": (dict(fmt="png", per_frame=True, distortion=OPENCV), {}),
    "jpeg_96_views": (dict(n=96, sidecars=True), {}),
}


@pytest.mark.parametrize("case", sorted(DM_SCENES))
def test_datamanager_matches_jax(tmp_path, case):
    scene_kw, parser_kw = DM_SCENES[case]
    root = write_scene(tmp_path / "scene", **scene_kw)
    got = tdm.DataManager(tdm.DataManagerConfig(dataparser=tdp.DataParserConfig(data=root, **parser_kw), seed=3),
                          device="cpu")
    want = jdm.DataManager(jdm.DataManagerConfig(dataparser=jdp.DataParserConfig(data=root, **parser_kw), seed=3))

    assert got.images.dtype == np.float32 and got.images.shape == want.images.shape
    np.testing.assert_array_equal(got.images, want.images)
    for name in ("fx", "fy", "cx", "cy", "c2w"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.width, got.height) == (want.width, want.height)
    assert got.view_indices == want.view_indices
    assert len(got) == (40 if case == "jpeg_96_views" else len(want.parsed.image_filenames))
    n = len(got)
    assert [got.next_train()[0] for _ in range(2 * n)] == [want.next_train()[0] for _ in range(2 * n)]
    assert got.eval_indices() == want.eval_indices()
    if "opencv" in case:  # the undistortion moved the intrinsics and cropped to the ROI
        assert got.width < 32 * scene_kw.get("image_scale", 1) or got.height < 24

    for i in range(n):
        cam, jcam = got.camera(i), want.camera(i)
        assert cam.c2w.device.type == "cpu" and (cam.width, cam.height) == (jcam.width, jcam.height)
        for m, jm in zip(camera_matrices(cam), jcamera_matrices(jcam)):
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    stacked, jstacked = got.cameras_stacked(), want.cameras_stacked()
    for name in ("c2w", "fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(stacked, name).numpy(), np.asarray(getattr(jstacked, name)))

    edited = np.full(got.images.shape[1:], 0.25, np.float32)
    got.write_back(1, edited)
    want.write_back(1, edited)
    np.testing.assert_array_equal(got.image(1), want.image(1))
    got.reset_images()
    want.reset_images()
    np.testing.assert_array_equal(got.images, want.images)

    masks, jmasks = got.load_masks(), want.load_masks()
    assert sorted(masks) == sorted(jmasks) and (len(masks) == n) == scene_kw.get("sidecars", False)
    for k in masks:
        np.testing.assert_array_equal(masks[k], jmasks[k])


def test_png_images_are_their_bytes_over_255(tmp_path):
    root = write_scene(tmp_path / "s", fmt="png", n=3)
    dm = tdm.DataManager(tdm.DataManagerConfig(dataparser=tdp.DataParserConfig(data=root)), device="cpu")
    for i, path in enumerate(dm.parsed.image_filenames):
        np.testing.assert_array_equal(dm.images[i], np.asarray(Image.open(path), np.float32) / 255.0)


def test_datamanager_raises_and_names_the_file(tmp_path):
    """A non-integer resize and a JPEG the native decoder refuses
    (progressive) load as the JAX package loads them; a file Pillow cannot
    read raises with the file's name, as it raises there."""
    def managers(root):
        return (tdm.DataManager(tdm.DataManagerConfig(dataparser=tdp.DataParserConfig(data=root)), device="cpu"),
                jdm.DataManager(jdm.DataManagerConfig(dataparser=jdp.DataParserConfig(data=root))))

    root = write_scene(tmp_path / "odd", fmt="png", n=2)
    meta = json.loads((root / "transforms.json").read_text())
    meta["w"], meta["h"] = 21, 16  # 32×24 images, not an integer multiple
    (root / "transforms.json").write_text(json.dumps(meta))
    got, want = managers(root)
    assert got.images.shape == (2, 16, 21, 3)
    np.testing.assert_array_equal(got.images, want.images)

    root = write_scene(tmp_path / "prog", fmt="jpg", n=2)
    Image.open(root / "images" / "frame_00002.jpg").save(root / "images" / "frame_00002.jpg", progressive=True)
    got, want = managers(root)
    np.testing.assert_array_equal(got.images, want.images)

    (root / "images" / "frame_00002.jpg").write_bytes(b"not an image")
    for mod, kw in ((tdm, dict(device="cpu")), (jdm, {})):
        with pytest.raises(OSError, match="frame_00002.jpg"):
            mod.DataManager(mod.DataManagerConfig(dataparser=mod.DataParserConfig(data=root)), **kw)


def test_datamanager_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so cuda is not refused")
    root = write_scene(tmp_path / "s", n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdm.DataManager(tdm.DataManagerConfig(dataparser=tdp.DataParserConfig(data=root)))


# ---------------------------------------------------------------- flags


def _shared_fields(a, b, prefix=""):
    """(dotted name, port value, JAX value) of every leaf field both trees have."""
    out = []
    names = {f.name for f in dataclasses.fields(b)}
    for f in dataclasses.fields(a):
        if f.name not in names:
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va) and dataclasses.is_dataclass(vb):
            out += _shared_fields(va, vb, f"{prefix}{f.name}.")
        else:
            out.append((prefix + f.name, va, vb))
    return out


def test_flags_parse_as_jax():
    argv = ["--data", "scenes/bear", "--max-num-iterations", "60", "--steps-per-eval-image", "30",
            "--pipeline.edit-prompt", "a bronze bear", "--pipeline.guidance-scale", "7.5",
            "--train.model.background-color", "white", "--train.use-lpips", "False",
            "--train.densify.refine-every", "50", "--datamanager.dataparser.downscale-factor", "4",
            "--datamanager.subset-num", "2", "--save-only-latest-checkpoint", "false",
            "--train.model.render.clip-thresh", "0.02"]
    got, _ = parse_config(GaussCtrlConfig, argv)
    want, _ = jparse_config(JGaussCtrlConfig, argv)
    shared = _shared_fields(got, want)
    assert len(shared) > 60
    for name, g, w in shared:
        assert g == w, name
    assert got.device == "cuda"
    assert got.datamanager.dataparser.downscale_factor == 4 and got.train.use_lpips is False
    assert parse_config(GaussCtrlConfig, ["--device", "cpu"])[0].device == "cpu"


@pytest.mark.parametrize("flag", ["--train.model.render.impl", "--train.model.render.isect-capacity",
                                  "--train.model.render.max-per-tile", "--train.model.render.tile-chunk",
                                  "--train.model.render.aligned-capacity"])
def test_tpu_render_flags_are_rejected(flag):
    jparse_config(JGaussCtrlConfig, [flag, "4096" if "impl" not in flag else "jnp"])
    with pytest.raises(SystemExit, match="unknown arguments"):
        parse_config(GaussCtrlConfig, [flag, "4096"])


# ---------------------------------------------------------------- imports


def test_port_data_and_cli_import_no_jax_pil_cv2_orbax_or_flax():
    """In a fresh interpreter, importing the data path and the training CLI
    loads nothing of JAX, PIL, OpenCV, orbax, Flax or the JAX package."""
    modules = ["gaussctrl_exp_tpu_torch.cli.train", "gaussctrl_exp_tpu_torch.cli.render",
               "gaussctrl_exp_tpu_torch.data", "gaussctrl_exp_tpu_torch.configs",
               "gaussctrl_exp_tpu_torch.engine.checkpoint", "gaussctrl_exp_tpu_torch.engine.writer",
               "gaussctrl_exp_tpu_torch.engine.trainer", "gaussctrl_exp_tpu_torch.native",
               "gaussctrl_exp_tpu_torch.utils.cliconf",
               "gaussctrl_exp_tpu_torch.cli.viewer", "gaussctrl_exp_tpu_torch.parallel",
               "gaussctrl_exp_tpu_torch.parallel.distributed", "gaussctrl_exp_tpu_torch.parallel.edit_sharded",
               "gaussctrl_exp_tpu_torch.utils.video"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout

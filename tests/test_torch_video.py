"""The port's image and video writers against the JAX package: the render
CLI's JPEG frames, GIF and nearest-camera resize, the viewer's JPEG (Pillow
in both packages, so the same bytes and pixels), and ``utils/video.py`` (its
own copy).

The JPEG cases drive the CLI's frame loop and the viewer's ``/render`` with
the renders stubbed out, so both packages encode the same frame. The GIF
cases hide ``imageio`` and ``ffmpeg`` from both packages, since the JAX
package tries them first.
"""

import io
import os
import stat
import struct
import sys
import threading
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import gaussctrl_exp_tpu.models.splat_model as jsplat
from gaussctrl_exp_tpu.cli import render as jcli
from gaussctrl_exp_tpu.cli import viewer as jviewer
from gaussctrl_exp_tpu.utils import video as jvideo
from gaussctrl_exp_tpu_torch.cli import render as cli
from gaussctrl_exp_tpu_torch.cli import viewer
from gaussctrl_exp_tpu_torch.utils import video


def smooth(h, w, seed=0, noise=5.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = 127 + 100 * np.sin(6 * xx[..., None] + 4 * yy[..., None] + np.arange(3) + seed)
    return np.clip(base + rng.normal(0, noise, (h, w, 3)), 0, 255).astype(np.uint8)


def cli_jpegs(tmp_path, monkeypatch, frame) -> tuple[bytes, bytes]:
    """``frame`` written as ``--fmt jpg`` by the port's CLI and by the JAX
    CLI's frame loop, the renders stubbed: (port bytes, JAX bytes)."""
    monkeypatch.setattr(cli, "render_model", lambda *a: None)
    monkeypatch.setattr(cli, "frame_from_outputs", lambda *a: frame)
    monkeypatch.setattr(jcli, "_make_render_jit", lambda cfg=None: lambda *a: None)
    monkeypatch.setattr(jcli, "_frame_from_outputs", lambda *a, **k: frame)
    cli.render_cameras(None, [None], tmp_path / "port", fmt="jpg")
    jcli._render_cameras(SimpleNamespace(params=None, alive=None), [None], tmp_path / "jax", "jpg", False)
    return tuple((tmp_path / d / "frame_00001.jpg").read_bytes() for d in ("port", "jax"))


def viewer_jpegs(monkeypatch, frame) -> tuple[bytes, bytes]:
    """``/render`` of the port's viewer and of the JAX viewer, each render
    stubbed to give ``frame`` / 255 as its rgb: (port body, JAX body)."""
    rgb = frame.astype(np.float32) / 255.0
    monkeypatch.setattr(viewer, "render_model", lambda *a: SimpleNamespace(rgb=torch.as_tensor(rgb), depth=None))
    monkeypatch.setattr(jsplat, "render_model", lambda *a: SimpleNamespace(rgb=rgb, depth=None))
    monkeypatch.setattr(jax, "jit", lambda f: f)
    servers = [viewer.serve(state_fn=lambda: (None, 0, None), port=0, size=16, device="cpu"),
               jviewer.serve(state_fn=lambda: (None, None, 0, None), port=0, size=16)]
    for h in servers:
        threading.Thread(target=h.serve_forever, daemon=True).start()
    try:
        bodies = []
        for h in servers:
            with urllib.request.urlopen(f"http://localhost:{h.server_address[1]}/render?az=0.3", timeout=60) as r:
                assert r.headers.get("Content-Type") == "image/jpeg"
                bodies.append(r.read())
        return tuple(bodies)
    finally:
        for h in servers:
            h.shutdown()
            h.server_close()


@pytest.mark.parametrize("quality", [75, 90])
@pytest.mark.parametrize("shape", [(77, 101), (512, 512), (16, 16), (9, 33)])
def test_jpeg_bytes_equal_jax(tmp_path, monkeypatch, quality, shape):
    """Quality 75 is the CLI's ``--fmt jpg`` (Pillow's default), 90 the
    viewer's ``/render``."""
    img = smooth(*shape)
    got, want = cli_jpegs(tmp_path, monkeypatch, img) if quality == 75 else viewer_jpegs(monkeypatch, img)
    assert got == want
    im = Image.open(io.BytesIO(got))
    assert im.format == "JPEG" and im.size == (shape[1], shape[0]) and im.mode == "RGB"


def test_jpeg_bytes_equal_jax_on_a_grey_frame(tmp_path, monkeypatch):
    """A frame of one grey level, through both the CLI and the viewer."""
    img = np.full((24, 40, 3), 128, np.uint8)
    for got, want in (cli_jpegs(tmp_path, monkeypatch, img), viewer_jpegs(monkeypatch, img)):
        assert got == want


def gif_pair(tmp_path, monkeypatch, frames, fps) -> tuple[Path, Path]:
    """``render.gif`` of the port's ``write_video`` and of the JAX
    package's ``_write_video``, with ``imageio`` and ``ffmpeg`` hidden."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setitem(sys.modules, "imageio", None)
    out = []
    for name, fn in (("port", cli.write_video), ("jax", jcli._write_video)):
        (tmp_path / name).mkdir()
        out.append(fn(tmp_path / name, frames, fps))
    assert [p.name for p in out] == ["render.gif", "render.gif"]
    return out[0], out[1]


@pytest.mark.parametrize("fps", [24, 2, 30])
def test_write_video_gif_equals_jax(tmp_path, monkeypatch, fps):
    frames = [smooth(512, 512, seed=i, noise=3.0) for i in range(3)]
    rng = np.random.default_rng(1)
    frames.append((rng.integers(0, 4, (512, 512, 3)) * 60).astype(np.uint8))  # 64 colours
    got, want = gif_pair(tmp_path, monkeypatch, frames, fps)
    assert got.read_bytes() == want.read_bytes()
    im = Image.open(got)
    assert im.n_frames == len(frames) and im.size == (512, 512) and im.info["loop"] == 0
    im.seek(3)
    np.testing.assert_array_equal(np.asarray(im.convert("RGB")), frames[3])


def test_write_video_gif_equals_jax_on_small_frames(tmp_path, monkeypatch):
    """Small frames of more than 256 colours (Pillow quantises them)."""
    frames = [smooth(40, 24, seed=i) for i in range(2)]
    assert all(len(np.unique(f.reshape(-1, 3), axis=0)) > 256 for f in frames)
    got, want = gif_pair(tmp_path, monkeypatch, frames, 10)
    assert got.read_bytes() == want.read_bytes()
    assert Image.open(got).n_frames == 2


def test_write_video_gif_equals_jax_on_long_runs(tmp_path, monkeypatch):
    """Runs long enough to fill the LZW table several times."""
    rng = np.random.default_rng(2)
    idx = np.repeat(rng.integers(0, 6, 40_000), rng.integers(1, 9, 40_000))[: 300 * 301]
    pal = (np.arange(6)[:, None] * 40 + np.array([0, 10, 20])).astype(np.uint8)
    frame = pal[idx.reshape(300, 301)]
    got, want = gif_pair(tmp_path, monkeypatch, [frame], 25)
    assert got.read_bytes() == want.read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(got).convert("RGB")), frame)


def _mini_mp4(path: Path) -> bytes:
    def box(tag, payload):
        return struct.pack(">I4s", 8 + len(payload), tag) + payload

    trak = box(b"trak", box(b"tkhd", b"\x00" * 84))
    data = box(b"ftyp", b"isom\x00\x00\x02\x00isomiso2") + box(b"mdat", b"\x00" * 64) + \
        box(b"moov", box(b"mvhd", b"\x00" * 100) + trak)
    path.write_bytes(data)
    return data


@pytest.mark.parametrize("mode", [None, "top-bottom", "left-right"])
def test_spherical_metadata_round_trip_matches_jax(tmp_path, mode):
    a, b = tmp_path / "a.mp4", tmp_path / "b.mp4"
    _mini_mp4(a), _mini_mp4(b)
    assert video.read_spherical_metadata(a) is None
    video.insert_spherical_metadata(a, stereo_mode=mode)
    jvideo.insert_spherical_metadata(b, stereo_mode=mode)
    assert a.read_bytes() == b.read_bytes()
    xml = video.read_spherical_metadata(a)
    assert b"equirectangular" in xml and (mode is None or mode.encode() in xml)
    assert xml == jvideo.read_spherical_metadata(b)


def test_stack_stereo_matches_jax():
    rng = np.random.default_rng(0)
    left, right = (rng.integers(0, 256, (4, 6, 3)).astype(np.uint8) for _ in range(2))
    for mode in ("ods", "vr180"):
        np.testing.assert_array_equal(video.stack_stereo(left, right, mode), jvideo.stack_stereo(left, right, mode))
    with pytest.raises(ValueError):
        video.stack_stereo(left, right, "mono")


@pytest.mark.parametrize("src,size", [((64, 64), (64, 32)), ((77, 101), (33, 25)), ((40, 50), (130, 90)),
                                      ((100, 100), (37, 100)), ((64, 48), (85, 64)), ((30, 40), (40, 30))])
def test_nearest_camera_resize_equals_jax(tmp_path, src, size):
    """The probe's train view, read and resized to the frame's height
    (Pillow's default bicubic), as the JAX probe gives it."""
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "view.png")
    parsed = SimpleNamespace(image_filenames=[tmp_path / "view.png"], cameras=SimpleNamespace(c2w=np.eye(4)[None, :3]))
    height = size[1]
    got = cli.NearestCameraProbe(parsed, False).lookup(None, SimpleNamespace(c2w=torch.eye(4)), height, None)
    want = jcli.NearestCameraProbe(parsed, False).lookup(None, None, SimpleNamespace(c2w=np.eye(4)), height)
    assert got.dtype == np.uint8 and got.shape == (height, int(round(src[1] * height / src[0])), 3)
    np.testing.assert_array_equal(got, want)


def test_write_video_gif_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    frames = [smooth(32, 48, seed=i) for i in range(3)]
    p = cli.write_video(tmp_path, frames, fps=24)
    assert p == tmp_path / "render.gif" and Image.open(p).n_frames == 3


def test_write_video_runs_ffmpeg_from_the_png_frames(tmp_path, monkeypatch):
    """With an ``ffmpeg`` on the path, its mp4 from frame_%05d.png; a
    failing ffmpeg gives the GIF."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "argv.txt"
    fake = bindir / "ffmpeg"
    fake.write_text(f'#!/bin/sh\necho "$@" > {log}\n'
                    'for a; do last="$a"; done\n'
                    f'cp {tmp_path / "tpl.mp4"} "$last"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    _mini_mp4(tmp_path / "tpl.mp4")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    out = tmp_path / "out"
    out.mkdir()
    p = cli.write_video(out, [smooth(16, 16)], fps=12)
    assert p == out / "render.mp4" and p.exists()
    assert log.read_text().split() == ["-y", "-framerate", "12", "-i", str(out / "frame_%05d.png"), "-pix_fmt",
                                       "yuv420p", str(p)]
    fake.write_text("#!/bin/sh\nexit 1\n")
    assert cli.write_video(out, [smooth(16, 16)], fps=12) == out / "render.gif"

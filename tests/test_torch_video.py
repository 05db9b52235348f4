"""The port's image and video writers against PIL and the JAX package:
``utils/video.py`` (its own copy), the native JPEG encoder, ``utils/gif.py``,
``cli/render.write_video`` and ``utils/resize.pil_bicubic_uint8``.

Tolerances, each against the source image:
  * JPEG (quality 75 and 90, 4:2:0): decoded by PIL, a PSNR no more than
    0.5 dB under that of PIL's own encode of the same image, decoded by PIL
    (measured −0.06 to +0.57 dB); decoded by the port's decoder, no more
    than 0.5 dB under PIL's encode decoded by the port's decoder (measured
    −0.07 to +0.55 dB); at 512², PSNR ≥ 30 dB either way. The quantisation
    tables equal PIL's exactly.
  * GIF, decoded by PIL: a frame of ≤ 256 colours exactly; a smooth 512²
    frame with noise PSNR ≥ 35 dB (measured 39.8); a 40×24 noisy frame of
    more than 256 colours PSNR ≥ 35 dB (measured 38.8-38.9; PIL's own save
    38.4-38.5).
  * ``pil_bicubic_uint8`` equals PIL bit for bit.
"""

import io
import os
import stat
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gaussctrl_exp_tpu.utils import video as jvideo
from gaussctrl_exp_tpu_torch import native
from gaussctrl_exp_tpu_torch.cli import render as cli
from gaussctrl_exp_tpu_torch.utils import gif, video
from gaussctrl_exp_tpu_torch.utils.resize import pil_bicubic_uint8

JPEG_MIN_PSNR, JPEG_PIL_MARGIN = 30.0, 0.5  # the floor at 512²
GIF_MIN_PSNR = 35.0


def psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def smooth(h, w, seed=0, noise=5.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = 127 + 100 * np.sin(6 * xx[..., None] + 4 * yy[..., None] + np.arange(3) + seed)
    return np.clip(base + rng.normal(0, noise, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [75, 90])
@pytest.mark.parametrize("shape", [(77, 101), (512, 512), (16, 16), (9, 33)])
def test_jpeg_encoder_decodes_within_psnr(quality, shape):
    img = smooth(*shape)
    data = native.encode_jpeg(img, quality)
    pil = Image.open(io.BytesIO(data))
    assert pil.format == "JPEG" and pil.size == (shape[1], shape[0]) and pil.mode == "RGB"
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    ref = Image.open(io.BytesIO(buf.getvalue()))
    assert {k: list(v) for k, v in pil.quantization.items()} == {k: list(v) for k, v in ref.quantization.items()}
    by_pil, by_port = psnr(np.asarray(pil.convert("RGB")), img), psnr(native.decode_jpeg(data), img)
    assert by_pil >= psnr(np.asarray(ref), img) - JPEG_PIL_MARGIN
    assert by_port >= psnr(native.decode_jpeg(buf.getvalue()), img) - JPEG_PIL_MARGIN
    if shape == (512, 512):
        assert min(by_pil, by_port) >= JPEG_MIN_PSNR


def test_jpeg_encoder_refuses_bad_input():
    with pytest.raises(ValueError):
        native.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        native.encode_jpeg(np.zeros((4, 4, 3), np.uint8), quality=0)
    with pytest.raises(ValueError, match="baseline JPEG"):
        native.decode_jpeg(b"not a jpeg")


@pytest.mark.parametrize("fps", [24, 2, 30])
def test_gif_matches_pil_timing_and_frames(tmp_path, fps):
    frames = [smooth(512, 512, seed=i, noise=3.0) for i in range(3)]
    rng = np.random.default_rng(1)
    frames.append((rng.integers(0, 4, (512, 512, 3)) * 60).astype(np.uint8))  # 64 colours
    gif.write_gif(tmp_path / "a.gif", frames, duration_ms=int(1000 / fps), loop=0)
    Image.fromarray(frames[0]).save(tmp_path / "pil.gif", save_all=True, duration=int(1000 / fps), loop=0,
                                    append_images=[Image.fromarray(f) for f in frames[1:]])
    im, ref = Image.open(tmp_path / "a.gif"), Image.open(tmp_path / "pil.gif")
    assert im.n_frames == len(frames) and im.size == (512, 512)
    assert im.info["duration"] == ref.info["duration"] == int(int(1000 / fps) / 10) * 10
    assert im.info["loop"] == ref.info["loop"] == 0
    for i, f in enumerate(frames):
        im.seek(i)
        got = np.asarray(im.convert("RGB"))
        if i == 3:
            np.testing.assert_array_equal(got, f)
        else:
            assert psnr(got, f) >= GIF_MIN_PSNR


def test_gif_loop_count_and_small_frames(tmp_path):
    """A finite loop count, and small frames of more than 256 colours (the
    median cut on a few hundred distinct colours)."""
    frames = [smooth(40, 24, seed=i) for i in range(2)]
    assert all(len(np.unique(f.reshape(-1, 3), axis=0)) > 256 for f in frames)
    gif.write_gif(tmp_path / "f.gif", frames, duration_ms=100, loop=3)
    im = Image.open(tmp_path / "f.gif")
    assert im.info["loop"] == 3 and im.info["duration"] == 100 and im.n_frames == 2
    for i, f in enumerate(frames):
        im.seek(i)
        assert psnr(np.asarray(im.convert("RGB")), f) >= GIF_MIN_PSNR


def test_lzw_round_trip_through_pil_on_long_runs(tmp_path):
    """Runs long enough to fill the 4096-entry table several times (the
    clear code and 12-bit codes)."""
    rng = np.random.default_rng(2)
    idx = np.repeat(rng.integers(0, 6, 40_000), rng.integers(1, 9, 40_000))[: 300 * 301]
    pal = (np.arange(6)[:, None] * 40 + np.array([0, 10, 20])).astype(np.uint8)
    frame = pal[idx.reshape(300, 301)]
    gif.write_gif(tmp_path / "l.gif", [frame], duration_ms=40)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "l.gif").convert("RGB")), frame)


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
def test_pil_bicubic_matches_pil(src, size):
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pil_bicubic_uint8(img, size), np.asarray(Image.fromarray(img).resize(size)))
    np.testing.assert_array_equal(pil_bicubic_uint8(img[..., 0], size),
                                  np.asarray(Image.fromarray(img[..., 0]).resize(size)))


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

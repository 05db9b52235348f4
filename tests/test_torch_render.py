"""PyTorch port vs the JAX package: the model render, checkpoints and the CLI.

Also checks that the port imports nothing of JAX or the JAX package.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussctrl_exp_tpu.cameras import look_at as jlook_at
from gaussctrl_exp_tpu.cameras import make_camera as jmake_camera
from gaussctrl_exp_tpu.engine.checkpoint import import_splatfacto_checkpoint as jimport
from gaussctrl_exp_tpu.models.gaussians import GaussianParams as JParams
from gaussctrl_exp_tpu.models.gaussians import GaussianState as JState
from gaussctrl_exp_tpu.models.gaussians import init_random as jinit_random
from gaussctrl_exp_tpu.models.splat_model import SplatModelConfig as JModelConfig
from gaussctrl_exp_tpu.models.splat_model import render_model as jrender_model
from gaussctrl_exp_tpu.ops.renderer import RenderConfig as JRenderConfig
from gaussctrl_exp_tpu_torch.cameras import look_at, make_camera
from gaussctrl_exp_tpu_torch.cli import render as cli
from gaussctrl_exp_tpu_torch.engine.checkpoint import (
    export_splatfacto_checkpoint,
    import_splatfacto_checkpoint,
)
from gaussctrl_exp_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianState,
    init_random,
    params_from_numpy,
)
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
# rgb and alpha: float32 on both sides, same math, sums in another order
ATOL = 1e-5
# depth is the depth channel divided by alpha, so its error scales with depth
DEPTH_RTOL = 1e-4


def _params_np(n=200, seed=0, sh_degree=3):
    """Splatfacto-style parameters (log scales, logit opacities) from a seed."""
    rng = np.random.default_rng(seed)
    K = (sh_degree + 1) ** 2
    opac = rng.uniform(0.3, 0.95, size=(n, 1))
    return dict(
        means=rng.normal(size=(n, 3)).astype(np.float32),
        scales=(rng.normal(size=(n, 3)) * 0.5 - 2.6).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        features_dc=rng.normal(size=(n, 3)).astype(np.float32) * 0.8,
        features_rest=(rng.normal(size=(n, K - 1, 3)) * 0.2).astype(np.float32),
        opacities=np.log(opac / (1 - opac)).astype(np.float32),
    )


_jrender = jax.jit(jrender_model, static_argnums=(3,), static_argnames=("training",))


def _jax_render(arrays, alive, c2w, f, H, W, step, training=False, background=None):
    cam = jmake_camera(c2w, f, f, W / 2, H / 2, W, H)
    cfg = JModelConfig(background_color="white",
                       render=JRenderConfig(impl="jnp", isect_capacity=1 << 13))
    state = JState(JParams(**{k: jnp.asarray(v) for k, v in arrays.items()}), jnp.asarray(alive))
    bg = None if background is None else jnp.asarray(background)
    return _jrender(state, cam, step, cfg, training=training, background_override=bg)


@pytest.mark.parametrize("step", [30_000, 1_500])  # full SH degree, and degree 1
def test_render_model_matches_jax(step):
    arrays = _params_np()
    alive = np.ones(200, bool)
    alive[7] = False
    H, W, f = 64, 64, 80.0
    c2w = jlook_at([0.5, -4.0, 0.8], np.zeros(3))
    want = _jax_render(arrays, alive, c2w, f, H, W, step)
    assert int(want.render.bins.n_isects) <= 1 << 13
    assert int(want.render.bins.tile_cnt.max()) <= 512  # the oracle's per-tile cap does not bind

    state = GaussianState(params_from_numpy(arrays, "cpu"), torch.as_tensor(alive))
    cam = make_camera(c2w, f, f, W / 2, H / 2, W, H, device="cpu")
    got = render_model(state, cam, step, SplatModelConfig(background_color="white"))

    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), atol=ATOL)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), atol=ATOL)
    d_got, d_want = got.depth.numpy(), np.asarray(want.depth)
    empty = np.asarray(want.alpha) == 0.0
    assert empty.any() and (~empty).any()
    np.testing.assert_array_equal(d_got[empty], 1000.0)
    np.testing.assert_array_equal(d_want[empty], 1000.0)
    np.testing.assert_allclose(d_got, d_want, rtol=DEPTH_RTOL)
    for name in ("mat_view", "mat_proj", "mat_c2w"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_render_model_training_drops_depth():
    arrays = _params_np(n=60)
    state = GaussianState(params_from_numpy(arrays, "cpu"), torch.ones(60, dtype=torch.bool))
    cam = make_camera(look_at([0.0, -4.0, 0.0], np.zeros(3)), 40.0, 40.0, 16, 16, 32, 32, device="cpu")
    bg = torch.tensor([0.2, 0.4, 0.6])
    got = render_model(state, cam, 30_000, SplatModelConfig(), training=True, background_override=bg)
    want = _jax_render(arrays, np.ones(60, bool), np.asarray(cam.c2w), 40.0, 32, 32, 30_000,
                       training=True, background=bg.numpy())
    assert got.depth is None and want.depth is None
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), atol=ATOL)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), atol=ATOL)
    gen = torch.Generator().manual_seed(3)
    out = render_model(state, cam, 30_000, SplatModelConfig(), training=True, generator=gen)
    assert out.rgb.shape == (32, 32, 3)


def test_init_random_matches_jax():
    got = init_random(50, capacity=64, seed=3, device="cpu")
    want = jinit_random(50, capacity=64, seed=3)
    for name in PARAM_NAMES:
        np.testing.assert_allclose(getattr(got.params, name).numpy(), np.asarray(getattr(want.params, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))


def _write_ckpt(path, arrays, step=29_999):
    sd = {f"_model.gauss_params.{k}": torch.as_tensor(v) for k, v in arrays.items()}
    torch.save({"step": step, "pipeline": sd}, str(path))


def test_checkpoint_round_trip(tmp_path):
    arrays = _params_np(n=40)
    _write_ckpt(tmp_path / "in.ckpt", arrays)
    state, step = import_splatfacto_checkpoint(tmp_path / "in.ckpt", capacity=48, device="cpu")
    jstate, jstep = jimport(tmp_path / "in.ckpt", capacity=48)
    assert step == jstep == 29_999
    for name in PARAM_NAMES:  # padding included: scales and opacity −10, the rest 0
        np.testing.assert_array_equal(getattr(state.params, name).numpy(),
                                      np.asarray(getattr(jstate.params, name)), err_msg=name)
    np.testing.assert_array_equal(state.alive.numpy(), np.asarray(jstate.alive))

    export_splatfacto_checkpoint(state, tmp_path / "out.ckpt", step=7)
    back, step2 = import_splatfacto_checkpoint(tmp_path / "out.ckpt", device="cpu")
    assert step2 == 7 and back.params.capacity == 40
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(back.params, name).numpy(), arrays[name], err_msg=name)
    with pytest.raises(ValueError):
        import_splatfacto_checkpoint(tmp_path / "in.ckpt", capacity=10, device="cpu")


def _camera_path(path, n, H, W):
    frames = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        c2w = look_at([4.0 * np.sin(ang), -4.0 * np.cos(ang), 0.5], np.zeros(3))
        frames.append({"camera_to_world": np.concatenate([c2w, [[0, 0, 0, 1]]]).reshape(-1).tolist(),
                       "fov": 50.0})
    path.write_text(json.dumps({"render_height": H, "render_width": W, "camera_path": frames}))


def test_camera_path_cli_cpu(tmp_path):
    arrays = _params_np(n=120)
    _write_ckpt(tmp_path / "m.ckpt", arrays)
    _camera_path(tmp_path / "path.json", 2, 32, 48)
    frames = cli.main(["camera-path", "--ckpt", str(tmp_path / "m.ckpt"),
                       "--camera-path", str(tmp_path / "path.json"), "--out", str(tmp_path / "out"),
                       "--outputs", "rgb", "depth", "accumulation", "--device", "cpu"])
    pngs = sorted((tmp_path / "out").glob("frame_*.png"))
    assert [p.name for p in pngs] == ["frame_00001.png", "frame_00002.png"]
    for p, frame in zip(pngs, frames):
        img = np.asarray(Image.open(p))
        assert img.shape == (32, 3 * 48, 3)
        np.testing.assert_array_equal(img, frame)
    acc = frames[0][:, 2 * 48:, 0]
    assert 0 < (acc > 0).mean() < 1  # some pixels covered, some background

    # the frame's rgb panel is the model's render, quantized
    state, _ = import_splatfacto_checkpoint(tmp_path / "m.ckpt", device="cpu")
    cams = cli.path_cameras(tmp_path / "path.json", device="cpu")
    with torch.no_grad():
        out = render_model(state, cams[0], cli.EVAL_STEP, SplatModelConfig(background_color="white"))
    np.testing.assert_array_equal(frames[0][:, :48], (out.rgb.clamp(0, 1).numpy() * 255).astype(np.uint8))


def test_cuda_refused_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so cuda is not refused")
    _write_ckpt(tmp_path / "m.ckpt", _params_np(n=8))
    _camera_path(tmp_path / "path.json", 1, 16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["camera-path", "--ckpt", str(tmp_path / "m.ckpt"),
                  "--camera-path", str(tmp_path / "path.json"), "--out", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import_splatfacto_checkpoint(tmp_path / "m.ckpt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_random(8)
    assert not (tmp_path / "o").exists()


def test_png_round_trip(tmp_path, monkeypatch):
    """The CLI's PNG frame reads back as the frame, in the bytes of the JAX
    CLI's save call (its render stubbed to give the frame)."""
    img = np.random.default_rng(0).integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    monkeypatch.setattr(cli, "render_model", lambda *a: None)
    monkeypatch.setattr(cli, "frame_from_outputs", lambda *a: img)
    cli.render_cameras(None, [None], tmp_path / "out")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / "frame_00001.png")), img)
    Image.fromarray(img).save(tmp_path / "want.png")
    assert (tmp_path / "out" / "frame_00001.png").read_bytes() == (tmp_path / "want.png").read_bytes()


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gaussctrl_exp_tpu")


def test_port_imports_no_jax():
    files = sorted((REPO / "gaussctrl_exp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad

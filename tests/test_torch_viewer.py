"""The port's viewer (``cli/viewer.py``): its routes on port 0, a live attach
to a CPU ``Trainer`` (the step advances, the image changes, reset restores
the unedited images), renders read from ``Trainer.snapshot`` while the
trainer runs on another thread, and ``cli.train --viewer-port``.

A ``/render`` JPEG is held to the scene's render at the page's orbit pose:
its bytes are Pillow's quality-90 encode of that render (the JAX viewer's
call), and it is within 30 dB of the JAX viewer's response on the same
checkpoint (two renderers, which agree to ~1e-5 before quantisation).
Torch on one thread.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from gaussctrl_exp_tpu.cli import viewer as jviewer
from gaussctrl_exp_tpu.models.gaussians import GaussianParams as JParams
from gaussctrl_exp_tpu.models.gaussians import GaussianState as JState
from gaussctrl_exp_tpu.models.splat_model import SplatModelConfig as JModelConfig
from gaussctrl_exp_tpu.ops.renderer import RenderConfig as JRenderConfig
from gaussctrl_exp_tpu_torch.cli import viewer
from gaussctrl_exp_tpu_torch.engine.trainer import TrainConfig, Trainer
from gaussctrl_exp_tpu_torch.models.densify import DensifyConfig
from gaussctrl_exp_tpu_torch.models.gaussians import PARAM_NAMES, GaussianState, params_from_numpy
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model
from gaussctrl_exp_tpu_torch.utils import trace
from test_torch_train import FakeDataManager
from test_torch_render_cli import _params
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 48
JAX_MIN_DB = 30.0


def _get(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}", timeout=60) as r:
        return r.read(), r.headers.get("Content-Type")


def _post(port, path):
    req = urllib.request.Request(f"http://localhost:{port}{path}", method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _psnr(a, b):
    return 10 * np.log10(255.0**2 / max(np.mean((a.astype(np.float64) - b) ** 2), 1e-12))


def _state(arrays):
    return GaussianState(params_from_numpy(arrays, "cpu"), torch.ones(len(arrays["means"]), dtype=torch.bool))


def test_static_viewer_routes_match_the_render_and_the_jax_viewer():
    arrays = _params(150, 3, spread=0.5, log_scale=-2.5)
    cfg = SplatModelConfig(background_color="white")
    state = _state(arrays)
    httpd = viewer.serve(state, cfg, port=0, size=SIZE, device="cpu")
    port = httpd.server_address[1]
    trace.reset()
    trace.enable()
    jcfg = JModelConfig(background_color="white", render=JRenderConfig(impl="jnp", isect_capacity=1 << 14))
    import jax.numpy as jnp

    jstate = JState(JParams(**{k: jnp.asarray(v) for k, v in arrays.items()}), jnp.ones(150, bool))
    jhttpd = jviewer.serve(jstate, jcfg, port=0, size=SIZE)
    threads = [threading.Thread(target=h.serve_forever, daemon=True) for h in (httpd, jhttpd)]
    for t in threads:
        t.start()
    try:
        page, kind = _get(port, "/")
        assert kind == "text/html" and b"Reset to unedited" in page and page == jviewer._PAGE.encode()
        assert json.loads(_get(port, "/status")[0]) == {"live": False, "step": 0, "loss": None}
        for q, depth in (("az=0.4&el=0.3&r=3.5", False), ("az=-1.1&el=0.6&r=2.8&depth=1", True)):
            body, kind = _get(port, f"/render?{q}")
            assert kind == "image/jpeg"
            got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
            assert got.shape == (SIZE, SIZE, 3)
            want = np.asarray(Image.open(io.BytesIO(_get(jhttpd.server_address[1], f"/render?{q}")[0])))
            assert _psnr(got, want) >= JAX_MIN_DB
            if not depth:
                az, el, r = 0.4, 0.3, 3.5
                with torch.no_grad():
                    out = render_model(state, viewer.orbit_camera(az, el, r, np.zeros(3), SIZE, "cpu"),
                                       viewer.RENDER_STEP, cfg)
                ref = (np.clip(out.rgb.numpy(), 0, 1) * 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(ref).save(buf, "JPEG", quality=90)
                assert body == buf.getvalue()
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(port, "/nothing")
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _post(port, "/reset")  # no on_reset in a checkpoint view
        # each /render request is a span around the render, the copy to the host and the encode
        spans = trace.records()
        requests = [r for r in spans if r.name == "viewer.request"]
        assert len(requests) == 2 and not any(r.error for r in requests)
        for req in requests:
            kids = [r for r in spans if r.parent == req.id]
            assert [r.name for r in kids] == ["render.frame", "viewer.to_host", "viewer.encode"]
            assert kids[1].sync and sum(r.host_ms for r in kids) <= req.host_ms
    finally:
        trace.disable()
        trace.reset()
        httpd.shutdown()
        jhttpd.shutdown()


def _scene():
    """tests/test_torch_train.py's kind of scene: 4 views of a few gaussians at 48²."""
    rng = np.random.default_rng(11)
    true = _state(_params(40, 1, spread=0.6, log_scale=-2.1, opacity=2.0))
    cams = [viewer.orbit_camera(a, 0.2, 3.5, np.zeros(3), SIZE, "cpu") for a in (0.0, 0.5, -0.5, 1.0)]
    with torch.no_grad():
        images = [render_model(true, c, 30_000, SplatModelConfig(background_color="white")).rgb.numpy()
                  for c in cams]
    images = [np.clip(im + rng.normal(0, 0.01, im.shape), 0, 1).astype(np.float32) for im in images]
    return cams, images


def _trainer(densify=DensifyConfig(warmup_length=10_000)):
    cams, images = _scene()
    dm = FakeDataManager(cams, images)
    dm.unedited = [im.copy() for im in images]
    resets = []

    def reset_images():
        resets.append(1)
        for i, im in enumerate(dm.unedited):
            dm.images[i] = im.copy()

    dm.reset_images = reset_images
    dm.images[0] = np.zeros_like(dm.images[0])  # an edit's write-back, for reset to undo
    cfg = TrainConfig(model=SplatModelConfig(sh_degree=0, background_color="white"), densify=densify,
                      use_lpips=False)
    return Trainer(_state(_params(40, 5, spread=0.8, log_scale=-2.0, opacity=0.0)), dm, cfg), dm, resets


def test_live_viewer_attach():
    trainer, dm, resets = _trainer()
    httpd = viewer.attach_live_viewer(trainer, dm, trainer.cfg.model, port=0, size=SIZE)
    port = httpd.server_address[1]
    try:
        st = json.loads(_get(port, "/status")[0])
        assert st == {"live": True, "step": 0, "loss": None}
        before = _get(port, "/render?az=0&el=0.3&r=3.5")[0]
        trainer.train(3, log_every=1)
        st = json.loads(_get(port, "/status")[0])
        assert st["step"] == 3 and st["loss"] == pytest.approx(trainer.history[-1]["main_loss"])
        after = _get(port, "/render?az=0&el=0.3&r=3.5")[0]
        assert before != after, "the render did not change as the scene trained"
        assert _post(port, "/reset") == b"ok" and resets == [1]
        np.testing.assert_array_equal(dm.images[0], dm.unedited[0])
        assert _get(port, "/render?az=0&el=0.3&r=3.5&depth=1")[0]
    finally:
        httpd.shutdown()


def _copy(state):
    return {n: getattr(state.params, n).detach().clone() for n in PARAM_NAMES} | {"alive": state.alive.clone()}


def test_snapshot_is_consistent_and_records_no_graph_while_training():
    """Renders from the viewer's thread while the trainer steps and
    densifies on this one: every snapshot the viewer took equals the state
    at the step boundary it reports, is a detached copy, and every image
    decodes. ``/status`` takes no snapshot: one per render."""
    trainer, dm, _ = _trainer(DensifyConfig(warmup_length=2, refine_every=3, reset_alpha_every=100,
                                            stop_split_at=1000))
    refines, taken = [], []
    real_refine, real_snapshot = trainer.refine_step, trainer.snapshot
    trainer.refine_step = lambda st: refines.append(trainer.step) or real_refine(st)

    def snapshot():
        snap = real_snapshot()
        taken.append(snap)
        return snap

    trainer.snapshot = snapshot
    boundaries = {0: _copy(trainer.state)}  # the state after each step, before the next begins
    httpd = viewer.attach_live_viewer(trainer, dm, trainer.cfg.model, port=0, size=SIZE)
    port, bodies, errors = httpd.server_address[1], [], []

    def poll():
        try:
            while len(bodies) < 8:
                bodies.append(_get(port, "/render?az=0.2&el=0.3&r=3.5")[0])
                _get(port, "/status")
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    t = threading.Thread(target=poll)
    t.start()
    trainer.train(12, log_every=1, callback=lambda m: boundaries.update({m["step"]: _copy(trainer.state)}))
    t.join(timeout=120)
    httpd.shutdown()
    assert not errors and not t.is_alive() and refines == [9, 12]
    for b in bodies:
        assert np.asarray(Image.open(io.BytesIO(b))).shape == (SIZE, SIZE, 3)
    assert len(taken) == len(bodies) == 8
    for snap, step, _ in taken:
        want = boundaries[step]
        for n in PARAM_NAMES:
            a = getattr(snap.params, n)
            assert not a.requires_grad and a.grad_fn is None and torch.equal(a, want[n]), (step, n)
        assert torch.equal(snap.alive, want["alive"])
    snap, step, loss = real_snapshot()
    assert step == 12 and loss == trainer.history[-1]["main_loss"]
    assert all(getattr(snap.params, n).data_ptr() != getattr(trainer.state.params, n).data_ptr() for n in PARAM_NAMES)
    assert trainer.lock.acquire(blocking=False)  # released after the last step
    trainer.lock.release()

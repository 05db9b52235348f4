"""``gctpu-torch-viewer``: a small HTTP scene viewer (≈ ``ns-viewer``).

Port of ``gaussctrl_exp_tpu/cli/viewer.py``: the same orbit-controls page
and routes. ``/`` serves the page, ``/status`` the step and last loss,
``/render?az&el&r&depth`` a JPEG (quality 90) of the scene from an orbit
pose, rgb or the depth colormap, and ``POST /reset`` restores the
unedited train images. It serves a checkpoint, or attaches LIVE to a
running ``Trainer`` (the reference's gc_trainer.py:96-144).

The port's training state changes in place, and a render runs on the
server's request thread. So a live render reads ``Trainer.snapshot()``: a
copy of the gaussians taken under the trainer's lock, which the trainer
holds through each step and its densify or opacity reset; the copy is
never half updated. The render runs under ``torch.no_grad()`` on that
thread (grad mode is per thread), so a request records no graph. On the
card it goes through kernel B1 like every render; there is no other path.

Usage:
  python -m gaussctrl_exp_tpu_torch.cli.viewer --ckpt outputs/.../ckpts [--port 7007] [--device cuda]
  python -m gaussctrl_exp_tpu_torch.cli.train ... --viewer-port 7007   # live, in-train
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..cameras import look_at, make_camera
from ..device import resolve_device
from ..models.gaussians import GaussianState
from ..models.splat_model import SplatModelConfig, render_model
from ..utils import trace
from ..utils.colormaps import apply_depth_colormap

RENDER_STEP = 30_000  # full SH degree
JPEG_QUALITY = 90  # as the JAX viewer encodes /render

_PAGE = """<!doctype html><html><head><title>gctpu viewer</title><style>
body{margin:0;background:#111;color:#eee;font-family:sans-serif}
#c{display:block;margin:auto;cursor:grab}
#hud{position:fixed;top:8px;left:8px;font-size:13px}
#reset{position:fixed;top:8px;right:8px}
</style></head><body>
<div id=hud>drag: orbit &nbsp; wheel: zoom &nbsp; key d: depth<br><span id=st></span></div>
<button id=reset onclick="fetch('/reset',{method:'POST'}).then(()=>refresh())">Reset to unedited</button>
<img id=c width=512 height=512>
<script>
let az=0, el=0.3, r=3.5, depth=false, busy=false, dirty=true, laststep=-1;
const img=document.getElementById('c');
function refresh(){ if(busy) {dirty=true; return;} busy=true; dirty=false;
  img.src=`/render?az=${az.toFixed(3)}&el=${el.toFixed(3)}&r=${r.toFixed(3)}&depth=${depth?1:0}&t=${Date.now()}`;
}
img.onload=()=>{busy=false; if(dirty) refresh();};
img.onerror=()=>{busy=false;};
let drag=false,lx=0,ly=0;
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return; az+=(e.clientX-lx)*0.01; el+=(e.clientY-ly)*0.01;
  el=Math.max(-1.4,Math.min(1.4,el)); lx=e.clientX;ly=e.clientY; refresh();};
window.onwheel=e=>{r*=Math.exp(e.deltaY*0.001); refresh();};
window.onkeydown=e=>{if(e.key=='d'){depth=!depth; refresh();}};
setInterval(()=>{fetch('/status').then(r=>r.json()).then(s=>{
  document.getElementById('st').textContent =
    s.live ? `step ${s.step}  loss ${(s.loss??0).toFixed(4)}` : 'checkpoint view';
  if(s.live && s.step!=laststep){laststep=s.step; refresh();}
});}, 1000);
refresh();
</script></body></html>"""

StateFn = Callable[[], tuple]  # () -> (GaussianState, step, loss or None)
StatusFn = Callable[[], tuple]  # () -> (step, loss or None)


def orbit_camera(az: float, el: float, r: float, center: np.ndarray, size: int, device):
    """The page's orbit pose: ``r`` from ``center`` at azimuth ``az`` and
    elevation ``el``, looking at it, focal 1.05 · size."""
    eye = center + r * np.array([np.cos(el) * np.sin(az), -np.cos(el) * np.cos(az), np.sin(el)])
    return make_camera(look_at(eye, center), size * 1.05, size * 1.05, size / 2, size / 2, size, size, device=device)


def serve(state: Optional[GaussianState] = None, model_cfg: Optional[SplatModelConfig] = None, port: int = 7007,
          size: int = 512, center=None, radius: float = 3.5, state_fn: Optional[StateFn] = None,
          on_reset: Optional[Callable[[], None]] = None, device="cuda",
          status_fn: Optional[StatusFn] = None) -> ThreadingHTTPServer:
    """The viewer's HTTP server, not yet serving (call ``serve_forever``).

    Static mode: pass ``state``, a ``GaussianState`` on ``device``. Live
    mode: pass ``state_fn``, a zero-argument callable returning a consistent
    (GaussianState, step, loss or None), read on every request
    (``Trainer.snapshot``), and optionally ``on_reset`` and ``status_fn``, a
    cheap (step, loss or None) for ``/status`` (``Trainer.status``; without
    it ``/status`` reads ``state_fn``). ``port`` 0 takes a
    free port (``server_address[1]``). A ``/render`` request is the span
    "viewer.request" (``utils/trace.py``) around the render, the copy to
    the host and colormap ("viewer.to_host", where it waits for the device)
    and the JPEG encode ("viewer.encode").
    """
    from PIL import Image

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = model_cfg or SplatModelConfig(background_color="white")
    center = np.zeros(3) if center is None else np.asarray(center, np.float64)
    live = state_fn is not None
    if not live:
        if state is None:
            raise ValueError("serve needs a state or a state_fn")
        if state.alive.device != device:
            raise ValueError(f"the state is on {state.alive.device}, the viewer on {device}")
        state_fn = lambda: (state, 0, None)  # noqa: E731
    if status_fn is None:
        status_fn = lambda: state_fn()[1:]  # noqa: E731
    lock = threading.Lock()  # one render at a time

    def render_jpeg(az: float, el: float, r: float, want_depth: bool) -> bytes:
        with trace.span("viewer.request"), lock, torch.no_grad():
            st, _, _ = state_fn()
            out = render_model(st, orbit_camera(az, el, r, center, size, device), RENDER_STEP, cfg)
            with trace.span("viewer.to_host", sync=True):
                if want_depth and out.depth is not None:
                    img = apply_depth_colormap(out.depth.cpu().numpy(), out.alpha.cpu().numpy())
                else:
                    img = np.clip(out.rgb.cpu().numpy(), 0, 1)
                img = (img * 255).astype(np.uint8)
            with trace.span("viewer.encode"):
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "JPEG", quality=JPEG_QUALITY)
                return buf.getvalue()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes = b"", kind: Optional[str] = None):
            self.send_response(code)
            if kind:
                self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if urlparse(self.path).path == "/reset" and on_reset is not None:
                on_reset()
                self._send(200, b"ok")
            else:
                self._send(404)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif u.path == "/status":
                step, loss = status_fn()
                body = {"live": live, "step": int(step), "loss": None if loss is None else float(loss)}
                self._send(200, json.dumps(body).encode(), "application/json")
            elif u.path == "/render":
                q = parse_qs(u.query)
                body = render_jpeg(float(q.get("az", [0])[0]), float(q.get("el", [0.3])[0]),
                                   float(q.get("r", [radius])[0]), q.get("depth", ["0"])[0] == "1")
                self._send(200, body, "image/jpeg")
            else:
                self._send(404)

    httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    httpd.daemon_threads = True
    print(f"viewer at http://localhost:{httpd.server_address[1]}/")
    return httpd


def attach_live_viewer(trainer, datamanager, model_cfg: SplatModelConfig, port: int,
                       size: int = 512) -> ThreadingHTTPServer:
    """Start the viewer on a daemon thread, attached to a running trainer:
    it renders ``trainer.snapshot()`` as the scene trains, ``/status``
    reports ``trainer.status()`` (no copy), ``/reset`` restores the
    unedited train images (gc_trainer.py:136-144). Returns the server
    (``shutdown()`` stops it)."""

    httpd = serve(model_cfg=model_cfg, port=port, size=size, state_fn=lambda: trainer.snapshot(),
                  on_reset=datamanager.reset_images, device=trainer.state.alive.device,
                  status_fn=lambda: trainer.status())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv=None):
    from .render import load_state

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="splatfacto .ckpt, or a training checkpoint directory")
    p.add_argument("--port", type=int, default=7007)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    httpd = serve(load_state(args.ckpt, device), SplatModelConfig(background_color="white"), args.port, args.size,
                  device=device)
    httpd.serve_forever()


def entrypoint():
    main(sys.argv[1:])


if __name__ == "__main__":
    entrypoint()

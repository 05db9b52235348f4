"""Training checkpoints and splatfacto checkpoint import/export.

Port of ``gaussctrl_exp_tpu/engine/checkpoint.py``, after the reference's
checkpointing (gc_trainer.py:146-174):

  * ``save_checkpoint`` writes a :class:`TrainState` (parameters, alive mask,
    every Adam group's moments and count, densify statistics, step,
    generator state, camera deltas and their optimizer) with ``torch.save``
    into ``<dir>/step-{step:09d}/state.pt``, the JAX layout's naming, and
    with ``keep_only_latest`` prunes every other ``step-*``;
    ``load_checkpoint`` restores the latest ``step-*`` (or the one named)
    with ``weights_only=True``. The JAX package writes orbax, which the port
    cannot read: such a directory raises.
  * the splatfacto importer maps nerfstudio's ``_model.gauss_params.{means,
    scales,quats,features_dc,features_rest,opacities}`` tensors into a
    fixed-capacity :class:`GaussianState`; slots past the checkpoint's
    gaussians are padded with scales −10 and opacity logit −10 and marked
    dead in the alive mask.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.densify import DensifyStats
from ..models.gaussians import PARAM_NAMES, GaussianParams, GaussianState, params_from_numpy
from .optimizers import group_state

STATE_FILE = "state.pt"
# what orbax's PyTreeCheckpointer leaves in a step directory
_ORBAX_FILES = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "_sharding", "checkpoint")
_ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _adam_blob(state: dict) -> dict:
    return {k: _cpu(state[k]) for k in _ADAM_KEYS}


def save_checkpoint(path: str | Path, state, step: int, keep_only_latest: bool = True) -> Path:
    """Write ``state`` (a ``TrainState``) to ``<path>/step-{step:09d}/``;
    returns that directory."""
    path = Path(path).absolute()
    ckpt_dir = path / f"step-{step:09d}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    blob = {
        "step": int(state.step),
        "params": {n: _cpu(getattr(state.params, n)) for n in PARAM_NAMES},
        "alive": _cpu(state.alive),
        "adam": {n: _adam_blob(group_state(state.optimizer, n)) for n in PARAM_NAMES},
        "stats": {f: _cpu(getattr(state.stats, f)) for f in ("xys_grad_sum", "vis_count", "max_radii2d")},
        "generator": state.generator.get_state(),
        "generator_device": state.generator.device.type,
    }
    if state.cam_deltas is not None:
        cam_opt = state.cam_optimizer
        blob["cam_deltas"] = _cpu(state.cam_deltas)
        blob["cam_adam"] = _adam_blob(cam_opt.adam.state[cam_opt.param])
        blob["cam_acc"] = _cpu(cam_opt.acc)
        blob["cam_mini_step"] = int(cam_opt.mini_step)
    tmp = ckpt_dir / f"{STATE_FILE}.{os.getpid()}.tmp"
    torch.save(blob, str(tmp))
    os.replace(tmp, ckpt_dir / STATE_FILE)
    if keep_only_latest:
        for d in path.iterdir():
            if d.is_dir() and d.name.startswith("step-") and d != ckpt_dir:
                shutil.rmtree(d)
    return ckpt_dir


def checkpoint_dir(path: str | Path) -> Path:
    """``path`` if it names a ``step-*`` directory, else its latest ``step-*``."""
    path = Path(path).absolute()
    if path.is_dir() and not path.name.startswith("step-"):
        steps = sorted(d for d in path.iterdir() if d.is_dir() and d.name.startswith("step-"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = steps[-1]
    return path


def read_checkpoint(path: str | Path) -> tuple[dict, int]:
    """The saved blob (CPU tensors) of the checkpoint ``path`` resolves to,
    and its step."""
    ckpt_dir = checkpoint_dir(path)
    f = ckpt_dir / STATE_FILE
    if not f.exists():
        if any((ckpt_dir / name).exists() for name in _ORBAX_FILES):
            raise ValueError(f"{ckpt_dir} was written by orbax (the JAX package's checkpoints); "
                             f"the port reads only its own torch checkpoints ({STATE_FILE})")
        raise FileNotFoundError(f"{ckpt_dir} holds no {STATE_FILE}")
    blob = torch.load(str(f), map_location="cpu", weights_only=True)
    return blob, int(ckpt_dir.name.split("-")[-1])


def _restore_adam(state: dict, saved: dict, device) -> None:
    state["step"] = saved["step"].clone()  # stays on the CPU, as torch's Adam keeps it
    state["exp_avg"] = saved["exp_avg"].to(device)
    state["exp_avg_sq"] = saved["exp_avg_sq"].to(device)


def load_checkpoint(path: str | Path, example_state, device: str | torch.device = "cuda"):
    """Restore the latest checkpoint under ``path`` (or the ``step-*``
    directory it names) into ``example_state``, a ``TrainState`` made as the
    saved one was (same optimizer settings, camera optimization or not):
    its tensors take the checkpoint's values and shapes on ``device``, in
    place, so its optimizer keeps its parameters. Returns (state, step)."""
    device = resolve_device(device)
    blob, step = read_checkpoint(path)
    st = example_state
    for name in PARAM_NAMES:
        p = getattr(st.params, name)
        p.data = blob["params"][name].to(device)
        p.grad = None
        _restore_adam(group_state(st.optimizer, name), blob["adam"][name], device)
    st.alive = blob["alive"].to(device)
    st.stats = DensifyStats(**{f: t.to(device) for f, t in blob["stats"].items()})
    st.step = int(blob["step"])
    if blob["generator_device"] != device.type:
        raise ValueError(f"the checkpoint's generator ran on {blob['generator_device']}; "
                         f"it cannot seed one on {device.type}")
    st.generator = torch.Generator(device=device)
    st.generator.set_state(blob["generator"])
    if ("cam_deltas" in blob) != (st.cam_deltas is not None):
        raise ValueError("the checkpoint and the example state differ in camera optimization")
    if st.cam_deltas is not None:
        cam_opt = st.cam_optimizer
        st.cam_deltas.data = blob["cam_deltas"].to(device)
        st.cam_deltas.grad = None
        _restore_adam(cam_opt.adam.state[cam_opt.param], blob["cam_adam"], device)
        cam_opt.acc = blob["cam_acc"].to(device)
        cam_opt.mini_step = int(blob["cam_mini_step"])
    return st, step


def load_gaussians(path: str | Path, device: str | torch.device = "cuda") -> tuple[GaussianState, int]:
    """The gaussians (parameters and alive mask) of a training checkpoint,
    on ``device``, and its step."""
    device = resolve_device(device)
    blob, step = read_checkpoint(path)
    params = GaussianParams(**{n: blob["params"][n].to(device) for n in PARAM_NAMES})
    return GaussianState(params, blob["alive"].to(device)), step

_PREFIXES = ("_model.gauss_params.", "model.gauss_params.", "gauss_params.", "")
_PAD = {"scales": -10.0, "opacities": -10.0}


def import_splatfacto_checkpoint(
    ckpt_path: str | Path,
    capacity: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> tuple[GaussianState, int]:
    """Load a splatfacto torch checkpoint ({"step", "pipeline": state_dict},
    or the bare state_dict) into a GaussianState on ``device``."""
    device = resolve_device(device)
    raw = torch.load(str(ckpt_path), map_location="cpu", weights_only=True)
    step = int(raw.get("step", 0)) if isinstance(raw, dict) else 0
    sd = raw.get("pipeline", raw) if isinstance(raw, dict) else raw

    def find(name):
        for prefix in _PREFIXES:
            if prefix + name in sd:
                return sd[prefix + name].detach().cpu().numpy().astype(np.float32)
        raise KeyError(f"cannot find {name} in checkpoint (keys: {list(sd)[:8]}…)")

    arrays = {name: find(name) for name in PARAM_NAMES}
    n = arrays["means"].shape[0]
    arrays["opacities"] = arrays["opacities"].reshape(n, 1)
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < checkpoint gaussians {n}")
    for name, x in arrays.items():
        pad = np.full((cap - n,) + x.shape[1:], _PAD.get(name, 0.0), np.float32)
        arrays[name] = np.concatenate([x, pad], axis=0)
    alive = torch.arange(cap, device=device) < n
    return GaussianState(params_from_numpy(arrays, device), alive), step


def export_splatfacto_checkpoint(state: GaussianState, path: str | Path, step: int = 0) -> None:
    """Write the alive gaussians as a splatfacto-compatible torch checkpoint."""
    idx = torch.nonzero(state.alive.cpu()).reshape(-1)
    sd = {
        f"_model.gauss_params.{name}": getattr(state.params, name).detach().cpu()[idx].clone()
        for name in PARAM_NAMES
    }
    torch.save({"step": step, "pipeline": sd}, str(path))

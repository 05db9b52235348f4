"""Metrics/event writer and profiler hooks.

Port of ``gaussctrl_exp_tpu/engine/writer.py``, after the reference's
observability surface (gc_trainer.py:120-134, 212-232): per-step scalars,
periodic eval images, the config dump and the profiler. Backends: the
console and JSON lines always, TensorBoard through
``torch.utils.tensorboard`` when asked for and installed, and a
``torch.profiler`` Chrome trace in place of ``jax.profiler``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np


class EventWriter:
    """Console + JSONL scalar writer with optional TensorBoard."""

    def __init__(self, log_dir: str | Path, use_tensorboard: bool = False, quiet: bool = False):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "events.jsonl", "a")
        self._t0 = time.time()
        self.quiet = quiet
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard not installed: JSONL and console only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(str(self.log_dir / "tb"))

    def put_config(self, config) -> None:
        blob = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else repr(config)
        (self.log_dir / "config.json").write_text(json.dumps(blob, default=str, indent=1))

    def put_scalars(self, step: int, scalars: dict) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 2)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        if not self.quiet:
            body = "  ".join(f"{k} {float(v):.4f}" for k, v in scalars.items())
            print(f"step {step:6d}  {body}")

    def put_image(self, step: int, name: str, image) -> None:
        from PIL import Image

        img8 = (np.clip(np.asarray(image), 0, 1) * 255).astype("uint8")
        Image.fromarray(img8).save(self.log_dir / f"{name}_{step:06d}.png")
        if self._tb is not None:
            self._tb.add_image(name, img8, step, dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Profiler:
    """``torch.profiler`` wrapper: ``start``/``stop`` around a window writes
    a Chrome trace to ``<log_dir>/profile/trace.json``, which holds the
    program's spans as ``gc.<name>`` ranges (``utils/trace.py``)."""

    def __init__(self, log_dir: str | Path, enabled: bool = False):
        self.log_dir = Path(log_dir) / "profile"
        self.enabled = enabled
        self._prof = None

    def start(self) -> None:
        if self.enabled and self._prof is None:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(self.log_dir / "trace.json"))
            self._prof = None

"""DDIM forward and inverse schedulers (Stable-Diffusion 1.x configuration).

Port of ``gaussctrl_exp_tpu/diffusion/schedulers.py``: scaled-linear betas
0.00085 → 0.012 over 1000 train steps, steps_offset 1,
``set_alpha_to_one=False``, ε-prediction, η = 0. Timesteps are numpy, as in
the JAX package; the per-step coefficients are float32 scalars computed with
numpy in the JAX package's order, and ``step`` works on float32 tensors (a
bf16 ε is upcast first, as JAX's promotion does).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"


def _alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_timesteps) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps)
    else:
        raise ValueError(cfg.beta_schedule)
    return np.cumprod(1.0 - betas).astype(np.float32)


def _sqrt(x) -> float:
    return float(np.sqrt(np.float32(x)))


def _sqrt_1m(x) -> float:
    return float(np.sqrt(np.float32(1.0) - np.float32(x)))


class DDIMScheduler:
    """Denoising (reverse-time) DDIM."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.alphas_cumprod = _alphas_cumprod(cfg)
        self.final_alpha_cumprod = np.float32(1.0) if cfg.set_alpha_to_one else self.alphas_cumprod[0]
        self.timesteps: np.ndarray | None = None

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """diffusers' 'leading' spacing + steps_offset (the SD default)."""
        step = self.cfg.num_train_timesteps // num_inference_steps
        t = (np.arange(0, num_inference_steps) * step).round()[::-1].astype(np.int64)
        t = t + self.cfg.steps_offset
        self.num_inference_steps = num_inference_steps
        self.timesteps = t  # descending, e.g. [951, 901, …, 1]
        return t

    def step(self, model_eps: torch.Tensor, timestep: int, sample: torch.Tensor) -> torch.Tensor:
        """One deterministic DDIM update x_t → x_{t-Δ} (η = 0, ε-prediction)."""
        step = self.cfg.num_train_timesteps // self.num_inference_steps
        prev_t = int(timestep) - step
        a_t = self.alphas_cumprod[int(timestep)]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        eps = model_eps.float()
        x0 = (sample - _sqrt_1m(a_t) * eps) / _sqrt(a_t)
        return _sqrt(a_prev) * x0 + _sqrt_1m(a_prev) * eps

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor, timestep: int) -> torch.Tensor:
        a = self.alphas_cumprod[int(timestep)]
        return _sqrt(a) * sample + _sqrt_1m(a) * noise


class DDIMInverseScheduler:
    """Inversion (forward-time) DDIM: image latent → noise latent. Timesteps
    run ascending and each step maps x_t → x_{t+Δ} with the ε predicted at t."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.alphas_cumprod = _alphas_cumprod(cfg)
        self.initial_alpha_cumprod = np.float32(1.0)
        self.timesteps: np.ndarray | None = None

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        step = self.cfg.num_train_timesteps // num_inference_steps
        t = (np.arange(0, num_inference_steps) * step).round().astype(np.int64)
        t = t + self.cfg.steps_offset
        self.num_inference_steps = num_inference_steps
        self.timesteps = t  # ascending, e.g. [1, 51, …, 951]
        return t

    def step(self, model_eps: torch.Tensor, timestep: int, sample: torch.Tensor) -> torch.Tensor:
        step = self.cfg.num_train_timesteps // self.num_inference_steps
        prev_t = int(timestep) - step  # the "source" time of this sample
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.initial_alpha_cumprod
        a_t = self.alphas_cumprod[int(timestep)]
        eps = model_eps.float()
        x0 = (sample - _sqrt_1m(a_prev) * eps) / _sqrt(a_prev)
        return _sqrt(a_t) * x0 + _sqrt_1m(a_t) * eps

"""Per-group Adam mirroring the splatfacto training recipe.

Port of ``gaussctrl_exp_tpu/engine/optimizers.py`` and the camera optimizer
of ``engine/trainer.py``: one Adam over the six gaussian groups (means
1.6e-4 → 1.6e-6 over 30k steps, features_dc 2.5e-3, features_rest
2.5e-3/20, opacities 5e-2, scales 5e-3, quats 1e-3, eps 1e-15), and the
camera deltas' Adam (1e-3 → 5e-5) behind a mean over ``every_k`` steps.

Step semantics follow optax: update k (counted from 0) uses ``lr(k)``, and
the bias correction uses k + 1 (torch's Adam increments its step first).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.gaussians import PARAM_NAMES, GaussianParams

ADAM_EPS = 1e-15
MAX_SCHED_STEPS = 30_000

Schedule = Callable[[int], float]


def exp_decay(lr_init: float, lr_final: float, max_steps: int = MAX_SCHED_STEPS) -> Schedule:
    """nerfstudio ExponentialDecayScheduler: lr_init·(lr_final/lr_init)^(t/T),
    clamped at T; in float32, as the JAX schedule computes it."""

    def schedule(count: int) -> float:
        t = np.minimum(np.float32(count) / np.float32(max_steps), np.float32(1.0))
        return float(np.float32(lr_init) * np.float32(lr_final / lr_init) ** t)

    return schedule


class ScheduledAdam(torch.optim.Adam):
    """Adam whose param groups may carry an ``lr_schedule``: before update k
    the group's lr is set to ``lr_schedule(k)``, k read from the step count
    in the optimizer's state (created up front by ``init_adam_state``)."""

    def step(self, closure=None):
        for group in self.param_groups:
            if group.get("lr_schedule") is not None:
                group["lr"] = group["lr_schedule"](int(self.state[group["params"][0]]["step"]))
        return super().step(closure)


def make_gaussian_optimizer(
    params: GaussianParams,
    lr_means: float = 1.6e-4,
    lr_means_final: float = 1.6e-6,
    lr_features_dc: float = 2.5e-3,
    lr_features_rest: float = 2.5e-3 / 20,
    lr_opacity: float = 5e-2,
    lr_scaling: float = 5e-3,
    lr_rotation: float = 1e-3,
    max_steps: int = MAX_SCHED_STEPS,
) -> ScheduledAdam:
    """One Adam over the six groups of ``params`` (leaf tensors), each group
    named after its parameter."""
    means_sched = exp_decay(lr_means, lr_means_final, max_steps)
    lrs = dict(features_dc=lr_features_dc, features_rest=lr_features_rest,
               opacities=lr_opacity, scales=lr_scaling, quats=lr_rotation)
    groups = [
        dict(params=[getattr(params, name)], name=name,
             lr=means_sched(0) if name == "means" else lrs[name],
             lr_schedule=means_sched if name == "means" else None)
        for name in PARAM_NAMES
    ]
    opt = ScheduledAdam(groups, eps=ADAM_EPS)
    init_adam_state(opt)
    return opt


def init_adam_state(opt: torch.optim.Adam) -> None:
    """Create every parameter's Adam state (step 0, zero moments) now, as
    ``optax.adam(...).init`` does, so the moment surgery of densify can run
    before the first update. Mirrors torch's own lazy initialization."""
    for group in opt.param_groups:
        for p in group["params"]:
            if not opt.state.get(p):
                opt.state[p] = {
                    "step": torch.tensor(0.0, dtype=torch.float32),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }


def group_state(opt: torch.optim.Optimizer, name: str) -> dict:
    """The Adam state of the group called ``name``."""
    for group in opt.param_groups:
        if group.get("name") == name:
            return opt.state[group["params"][0]]
    raise KeyError(name)


class MultiStepAdam:
    """Adam behind a mean over ``every_k`` gradients, as
    ``optax.MultiSteps(optax.adam(schedule, eps), every_k)``: each call adds
    ``param.grad`` into the running mean; every k-th call applies one Adam
    update with that mean (update j uses ``schedule(j)``) and resets it."""

    def __init__(self, param: torch.Tensor, schedule: Schedule, every_k: int, eps: float = ADAM_EPS):
        self.param = param
        self.every_k = every_k
        self.mini_step = 0
        self.acc = torch.zeros_like(param)
        self.adam = ScheduledAdam([dict(params=[param], lr=schedule(0), lr_schedule=schedule)], eps=eps)
        init_adam_state(self.adam)

    def step(self) -> bool:
        """Returns True when this call applied an update."""
        grad = self.param.grad if self.param.grad is not None else torch.zeros_like(self.param)
        self.acc += (grad - self.acc) / (self.mini_step + 1)  # Welford mean, as optax
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        self.param.grad = self.acc.clone()
        self.adam.step()
        self.param.grad = grad
        self.acc.zero_()
        self.mini_step = 0
        return True


def adam_state_from_optax(opt_state, params: GaussianParams) -> dict:
    """The JAX package's ``multi_transform`` Adam state, with its arrays as
    numpy (``jax.device_get``), → per-parameter torch Adam state
    ``{param: {"step", "exp_avg", "exp_avg_sq"}}`` for ``optimizer.state``.

    Reads ``opt_state.inner_states[name].inner_state[0]`` (``count``, ``mu``,
    ``nu``) for each group by attribute, so nothing of optax is imported."""
    out = {}
    for name in PARAM_NAMES:
        adam = opt_state.inner_states[name].inner_state[0]
        p = getattr(params, name)
        out[p] = {
            "step": torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.asarray(getattr(adam.mu, name), np.float32), device=p.device),
            "exp_avg_sq": torch.as_tensor(np.asarray(getattr(adam.nu, name), np.float32), device=p.device),
        }
    return out

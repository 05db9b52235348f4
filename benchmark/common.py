"""What every runner shares: seeds, weights made from the seed on the device,
loading them into the measured program's modules, the prompt tokenizer, and
the exception that closes a window from inside the program's loop."""

from __future__ import annotations

import hashlib
import zlib

import numpy as np
import torch


class StopWindow(Exception):
    """Raised from a datamanager hook to end the program's loop at a unit's end."""


def sync(device) -> None:
    """Wait for the device's queue (a CPU run has none)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the part ``tag`` of a run with ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def make_weights(spec: dict, seed: int, tag: str, device) -> dict[str, torch.Tensor]:
    """float32 weights for ``spec`` ({name: (shape, initialiser)}), drawn on
    ``device`` in one call: a unit normal clipped to ±2 standard deviations,
    scaled per tensor; ones and zeros where the initialiser says so."""
    numel = {n: int(np.prod(s)) for n, (s, init) in spec.items()}
    n_rand = sum(numel[n] for n, (_, init) in spec.items() if init[0] == "normal")
    buf = torch.randn(n_rand, generator=generator(seed, tag, device), device=device).clamp_(-2.0, 2.0)
    out, off = {}, 0
    for name, (shape, init) in spec.items():
        if init[0] == "normal":
            out[name] = buf[off : off + numel[name]].view(shape).mul_(init[1])
            off += numel[name]
        elif init[0] == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def load_module(ctor, weights: dict, dtype: torch.dtype | None = None, device=None):
    """The program's module built by ``ctor`` and given ``weights`` (strict:
    every name and shape must match), then cast to ``dtype`` but for its
    norms, as the program loads a checkpoint. Built on the meta device and
    handed the tensors themselves; with ``device``, built there and the
    weights copied in (a module with buffers of its own)."""
    with torch.device(device or "meta"):
        module = ctor()
    module.load_state_dict(weights, strict=True, assign=device is None)
    if dtype is not None:
        from gaussctrl_exp_tpu_torch.diffusion.layers import cast_keeping_norms

        module = cast_keeping_norms(module, dtype)
    return module.requires_grad_(False).eval()


def tokenize(texts, max_len: int = 77) -> np.ndarray:
    """A deterministic stand-in for CLIP's BPE tokenizer: one id per word
    from CRC-32, between CLIP's start and end ids, zero padded."""
    ids = np.zeros((len(texts), max_len), np.int64)
    for i, t in enumerate(texts):
        toks = [49406] + [zlib.crc32(w.encode()) % 49000 for w in t.lower().split()][: max_len - 2] + [49407]
        ids[i, : len(toks)] = toks
    return ids


def reference_views(view_num: int, ref_view_num: int, seed: int) -> list[int]:
    """GaussCtrl's reference views: one drawn from each quarter of the views
    by Python's ``random`` seeded with ``seed`` (randint, ends included)."""
    import random

    anchors = [(view_num * i) // ref_view_num for i in range(ref_view_num)] + [view_num]
    rng = random.Random(seed)
    return [rng.randint(a, anchors[i + 1]) for i, a in enumerate(anchors[:-1])]


def abs_gaps(prefix: str):
    """``gaps(out, want)`` → the mean and the largest |out − want|, named
    ``<prefix>_mean_abs`` and ``<prefix>_max_abs``."""
    def gaps(out: torch.Tensor, want: torch.Tensor) -> dict:
        d = (out.float() - want.float()).abs()
        return {f"{prefix}_mean_abs": float(d.mean()), f"{prefix}_max_abs": float(d.max())}

    return gaps


def check_sample(seed: int, have, n: int) -> list[int]:
    """``n`` of the indices ``have`` (all, if fewer), drawn from the seed."""
    have = sorted(have)
    rng = np.random.default_rng(sub_seed(seed, "check"))
    return [int(i) for i in rng.choice(have, size=min(n, len(have)), replace=False)]


def worst_gaps(samples, program, reference, gaps, controls=()) -> dict[str, dict]:
    """The compared numbers of the program ("program") and of the reference
    computed in each precision of ``controls`` in the program's place, each
    the worst over ``samples``. ``program(s)`` is what the timed path produced
    for sample ``s``; ``reference(s, mode)`` is the reference's, "fp32" being
    the one both are judged against."""
    worst: dict[str, dict] = {}
    for s in samples:
        want = reference(s, "fp32")
        outs = dict(program=torch.as_tensor(program(s), device=want.device))
        outs.update((m, reference(s, m)) for m in controls)
        for who, out in outs.items():
            for k, v in gaps(out, want).items():
                worst.setdefault(who, {})[k] = max(worst.get(who, {}).get(k, 0.0), v)
    return worst


def check_from(got: dict[str, dict], limits: dict, empty: str) -> list[tuple[str, float, float]]:
    """The program's numbers beside their limits; with nothing compared, the
    number ``empty`` that fails."""
    got = got.get("program")
    if not got:
        return [(empty, float("inf"), 0.0)]
    return [(k, got[k], lim) for k, lim in limits.items()]

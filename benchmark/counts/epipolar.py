"""The epipolar cross-view term's work (``correspondence.py``'s processor),
counted from shapes: the floor is fixed by the work, not by how a program
gathers it.

For each attended ordered pair (a row (g, a) of a CFG group and a partner b
the pair mask keeps), at a grid of S tokens and width C = heads × D, float32:
a's queries, b's keys and b's values each read once (3 · S · C), the pair's
table read once (S · 9 taps, an index and a weight each, 4 bytes apiece: the
grid's S ≤ 4,096 tokens need no wider index) and the pair's output written
once (S · C). Operations: the 9 logits and the weighted sum of 9 values, a
multiply-add per channel each (2 · 2 · S · 9 · C); the softmax, the log of
the weights and the mean over partners are not counted, as the edit stack's
counts leave out elementwise work.
"""

from __future__ import annotations

from .peaks import PEAK_F32_OPS_S, roofline_s

TAPS = 9


def pair_bytes(S: int, C: int) -> int:
    return 4 * (4 * S * C + 2 * S * TAPS)


def pair_ops(S: int, C: int) -> int:
    return 4 * S * TAPS * C


def layers(cfg: dict) -> list[tuple[int, int]]:
    """(S, C) of each self-attention that mixes the epipolar term, in the
    UNet's order: the down blocks' (but the last's), the mid block's, the up
    blocks' (but the first's)."""
    bo, lpb, L = cfg["block_out"], cfg["layers_per_block"], cfg["latent"]
    n = len(bo)
    down = [((L >> i) ** 2, bo[i]) for i in range(n - 1) for _ in range(lpb)]
    mid = [((L >> (n - 1)) ** 2, bo[-1])]
    up = [((L >> (n - 1 - bi)) ** 2, c) for bi, c in enumerate(reversed(bo)) if bi > 0 for _ in range(lpb + 1)]
    return down + mid + up


def step_bytes(cfg: dict, pairs: int) -> int:
    """Bytes of one ε call whose layers each attend ``pairs`` ordered pairs
    (over both CFG groups)."""
    return pairs * sum(pair_bytes(S, C) for S, C in layers(cfg))


def step_ops(cfg: dict, pairs: int) -> int:
    return pairs * sum(pair_ops(S, C) for S, C in layers(cfg))


def step_bound_s(cfg: dict, pairs: int) -> float:
    return roofline_s(step_ops(cfg, pairs), step_bytes(cfg, pairs), PEAK_F32_OPS_S)

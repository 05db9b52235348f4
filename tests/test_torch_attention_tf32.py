"""The arithmetic of kernels B4 and B5 in fp32 (``csrc/flash_attn_bwd.cu``),
emulated on the CPU: 3×TF32 products, and the m16n8k8 fragment relabelling
that feeds the score products' C fragments to the gradient products.

The emulation lives here, not in the package. ``cvt.rna.tf32.f32`` rounds
an fp32 value to TF32 (10 mantissa bits) to nearest, ties away from zero:
on the bit pattern, add half of the dropped 13 bits' weight to the magnitude
and clear them. An operand x is split into hi = tf32(x) and lo = tf32(x −
hi); a product a·b is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with fp32 sums (the
products of two TF32 values are exact in fp32). The backward formulas run
through it, in fp32, at the depth generator's widths, and are held against
float64 autograd through ``sdpa_plain``: 3×TF32 lands within 1e-6 relative
L2, a tenth of the card's limit of 1e-5 (``chip_smoke.py``
``BWD_F32_REL_L2``); one pass (a_hi·b_hi) misses that limit, which is why the
kernels take three. Torch runs on one thread.

These tests record why the kernels take three passes and how their fragments
are relabelled; they do not run the kernels. The card tests
(``tests/test_torch_kernels.py``, ``test_flash_backward_f32_*``) guard the
kernels themselves, and only they see what the tensor cores do beyond this
emulation (their truncated fp32 sums, for one).
"""

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu_torch.ops.attention_cuda import sdpa_plain
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_3XTF32 = 1e-6  # measured 4.2e-7 to 5.6e-7 (fp32 products: 3.5e-7 to 4.6e-7; one pass ~5e-4)
REL_CARD = 1e-5  # the card's limit for the fp32 backward


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on fp32 ``x`` (finite values): the low 13 mantissa
    bits rounded to nearest, ties away from zero, then cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3×TF32: the two small terms first, then hi·hi, in fp32."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def backward(q, k, v, dout, mm):
    """(dq, dk, dv) as B4 and B5 compute them, every product through ``mm``,
    from the forward's output and log-sum-exp in fp32."""
    scale = q.shape[-1] ** -0.5
    s = q @ k.transpose(-1, -2)
    lse = torch.logsumexp(s * scale, dim=-1, keepdim=True)
    out = sdpa_plain(q, k, v)
    delta = (dout * out).sum(-1, keepdim=True)
    p = torch.exp(mm(q, k.transpose(-1, -2)) * scale - lse)
    dp = mm(dout, v.transpose(-1, -2))
    ds = p * (dp - delta)
    return mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale, mm(p.transpose(-1, -2), dout)


def _inputs(shape, seed):
    B, H, S, T, D = shape
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=s).astype(np.float32))
            for s in ((B, H, S, D), (B, H, T, D), (B, H, T, D), (B, H, S, D))]


def _reference(q, k, v, dout):
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(sdpa_plain(*leaves), leaves, dout.double())


def _rel(got, want) -> float:
    return float((got.double() - want).norm() / want.norm())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # exactly representable in TF32
    x = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -20, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1.0, one, one, 1.0, -one, 1.0 + 2.0 ** -9, 0.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    hi, lo = split(torch.tensor([np.pi], dtype=torch.float32))
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert abs(float(hi) + float(lo) - float(np.float32(np.pi))) <= 2.0 ** -21 * np.pi


@pytest.mark.parametrize("shape", [(1, 2, 256, 256, 40), (1, 2, 256, 77, 40), (1, 2, 64, 64, 160)])
def test_3xtf32_backward_is_fp32_accurate(shape):
    q, k, v, dout = _inputs(shape, sum(shape))
    want = _reference(q, k, v, dout)
    for name, g, w in zip(("dq", "dk", "dv"), backward(q, k, v, dout, mm3), want):
        assert _rel(g, w) <= REL_3XTF32, (name, _rel(g, w))
        assert _rel(g, w) <= REL_CARD / 10


@pytest.mark.parametrize("shape", [(1, 2, 256, 256, 40), (1, 2, 256, 77, 40), (1, 2, 64, 64, 160)])
def test_one_pass_tf32_misses_the_fp32_limit(shape):
    q, k, v, dout = _inputs(shape, sum(shape))
    want = _reference(q, k, v, dout)
    rels = [_rel(g, w) for g, w in zip(backward(q, k, v, dout, mm1), want)]
    assert min(rels) > REL_CARD, rels


# m16n8k8 with TF32 operands, lane l = 4·g + tq (PTX ISA, "Matrix fragments
# for mma.m16n8k8"): C register j holds (row g + 8·(j >> 1), column
# 2·tq + (j & 1)); A register i holds (row g + 8·(i & 1), column tq +
# 4·(i >> 1)); B register i holds (row tq + 4·i, column g).
LANES = np.arange(32)
G, TQ = LANES >> 2, LANES & 3


def c_fragment():
    return {(lane, j): (G[lane] + 8 * (j >> 1), 2 * TQ[lane] + (j & 1)) for lane in LANES for j in range(4)}


def a_fragment():
    return {(lane, i): (G[lane] + 8 * (i & 1), TQ[lane] + 4 * (i >> 1)) for lane in LANES for i in range(4)}


def b_fragment():
    return {(lane, i): (TQ[lane] + 4 * i, G[lane]) for lane in LANES for i in range(2)}


# the kernels' relabelling: A register i takes C register A_FROM_C[i]; k-slot
# tq is column (query in B4, key in B5) 2·tq and slot tq + 4 is 2·tq + 1, and
# B register i is read from row 2·tq + i
A_FROM_C = (0, 2, 1, 3)


def slot_column(slot):
    return 2 * (slot % 4) + slot // 4


def test_fragment_index_map_covers_each_pair_once():
    c, a, b = c_fragment(), a_fragment(), b_fragment()
    assert sorted(c.values()) == [(r, n) for r in range(16) for n in range(8)]
    assert sorted(a.values()) == [(r, s) for r in range(16) for s in range(8)]
    assert sorted(slot_column(s) for s in range(8)) == list(range(8))
    for lane in LANES:
        for i in range(4):
            row, slot = a[(lane, i)]
            c_row, c_col = c[(lane, A_FROM_C[i])]
            assert row == c_row and slot_column(slot) == c_col
        for i in range(2):
            slot, n = b[(lane, i)]
            assert slot_column(slot) == 2 * TQ[lane] + i and n == G[lane]
    # the contraction D[r][n] = Σ_slot A[r][slot]·B[slot][n]: every (row,
    # column) of the score tile meets every column n of the operand exactly once
    seen = np.zeros((16, 8, 8), dtype=int)
    for (row, slot) in a.values():
        for n in range(8):
            seen[row, slot_column(slot), n] += 1
    assert (seen == 1).all()


def test_relabelled_fragments_multiply_as_the_matrices():
    """Random P (16 keys × 8 queries, as the score product's C fragments) and
    dO (8 queries × 8 dims, row-major), put into registers as the kernel does:
    the product of the A and B fragments is P·dO."""
    rng = np.random.default_rng(0)
    p, do = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))
    c, a, b = c_fragment(), a_fragment(), b_fragment()
    regs_c = {key: p[rc] for key, rc in c.items()}
    a_mat, b_mat = np.full((16, 8), np.nan), np.full((8, 8), np.nan)
    for lane in LANES:
        for i in range(4):
            a_mat[a[(lane, i)]] = regs_c[(lane, A_FROM_C[i])]
        for i in range(2):
            b_mat[b[(lane, i)]] = do[2 * TQ[lane] + i, G[lane]]  # row-major tile: row 2·tq + i, column g
    assert not np.isnan(a_mat).any() and not np.isnan(b_mat).any()
    np.testing.assert_allclose(a_mat @ b_mat, p @ do, rtol=1e-13, atol=1e-13)

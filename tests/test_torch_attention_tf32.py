"""The arithmetic of kernels B3, B4 and B5 in fp32 (``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu``, ``csrc/tf32_mma.cuh``), emulated on the CPU:
3×TF32 products, B3's online softmax over ring tiles, and the m16n8k8
fragment relabelling that feeds the score products' C fragments to the
products over keys or queries (P·V in B3, the gradient products in B4 and
B5: the same map).

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
kernels take three. B3's forward, emulated tile by tile as the kernel runs
it, is held the same way against float64 ``sdpa_plain`` and
``torch.logsumexp``. Torch runs on one thread.

These tests record why the kernels take three passes and how their fragments
are relabelled; they do not run the kernels. The card tests
(``tests/test_torch_kernels.py``, ``test_flash_attn_f32_*`` and
``test_flash_backward_f32_*``) guard the kernels themselves, and only they
see what the tensor cores do beyond this emulation (their truncated fp32
sums, for one).
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


# ------------------------------------------------------------ B3 forward

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
RESCALE = 8.0  # log2 growth of a row's max that moves the running max
WARP_ROWS = 16  # query rows a warp: the rescale decision is the warp's
SHAPES = [(1, 2, 256, 256, 40), (1, 2, 256, 77, 40), (1, 2, 64, 64, 160), (1, 2, 100, 130, 80)]


def ring_rows(d: int) -> int:
    """Keys a ring tile (``f32_ring_rows`` in ``csrc/tf32_mma.cuh``)."""
    return 32 if d <= 48 else 16 if d <= 96 else 8


def forward(q, k, v, mm):
    """(out, lse, rescales) as B3 computes them in fp32, one ring tile of
    keys at a time: the raw scores Q·Kᵀ through ``mm``; the running max m of
    each row in raw-score units, moved for all 16 rows of a warp where one
    row's max grew by more than 2^8 (then l and the output are rescaled by
    2^((m_old − m)·scale·log2 e)); p = 2^(fma(s, scale·log2 e, −m·scale·log2
    e)); the tile's P·V through ``mm`` in a fresh accumulator, added to the
    output; at the end out / l and lse = (m·scale·log2 e + log2 l)·ln 2.
    Queries are padded to whole warps with zero rows, as the kernel runs
    them. ``rescales``: the tiles on which a warp moved its max."""
    B, H, S, D = q.shape
    T = k.shape[2]
    sp = -(-S // WARP_ROWS) * WARP_ROWS
    q = torch.cat([q, q.new_zeros(B, H, sp - S, D)], 2)
    sl2 = torch.tensor(D ** -0.5 * LOG2E, dtype=torch.float32)
    m = torch.full((B, H, sp, 1), -torch.inf)
    l, acc, rescales = torch.zeros(B, H, sp, 1), torch.zeros(B, H, sp, D), 0
    bn = ring_rows(D)
    for k0 in range(0, T, bn):
        s = mm(q, k[:, :, k0:k0 + bn].transpose(-1, -2))  # keys past T: absent, p = 0
        mx = s.amax(-1, keepdim=True)
        grow = ((mx - m) * sl2 > RESCALE).view(B, H, sp // WARP_ROWS, WARP_ROWS).any(-1)
        grow = grow.repeat_interleave(WARP_ROWS, -1)[..., None]
        if grow.any():
            mn = torch.maximum(m, mx)
            c = torch.exp2((m - mn) * sl2)
            m, l, acc = torch.where(grow, mn, m), torch.where(grow, l * c, l), torch.where(grow, acc * c, acc)
            rescales += int(grow.any())
        # one FFMA: the product and the sum rounded once
        p = torch.exp2((s.double() * sl2.double() - (m * sl2).double()).float())
        l = l + p.sum(-1, keepdim=True)
        acc = acc + mm(p, v[:, :, k0:k0 + bn])
    out = acc / l
    lse = (m * sl2 + torch.log2(l)) * LN2
    return out[:, :, :S], lse[:, :, :S, 0], rescales


def _forward_reference(q, k, v):
    q, k, v = q.double(), k.double(), v.double()
    lse = torch.logsumexp(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1)
    return sdpa_plain(q, k, v), lse


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_forward_is_fp32_accurate(shape):
    """3×TF32 products, the ring-tile online softmax with the 2^8 lazy
    rescale and a fresh P·V accumulator per tile: the output within 1e-6
    relative L2 of float64 and the log-sum-exp within 1e-6, a tenth of the
    card's limits (1e-5 for both). The shapes end on a ragged tile where T
    is not a multiple of the ring's keys (77 at 32, 130 at 16)."""
    q, k, v = _inputs(shape, sum(shape))[:3]
    out, lse, _ = forward(q, k, v, mm3)
    want, want_lse = _forward_reference(q, k, v)
    assert out.dtype == torch.float32 and _rel(out, want) <= REL_3XTF32, _rel(out, want)
    assert float((lse.double() - want_lse).abs().max()) <= REL_3XTF32
    assert _rel(out, want) <= REL_CARD / 10


@pytest.mark.parametrize("shape", SHAPES)
def test_one_pass_tf32_forward_misses_the_fp32_limit(shape):
    q, k, v = _inputs(shape, sum(shape))[:3]
    out, lse, _ = forward(q, k, v, mm1)
    want, want_lse = _forward_reference(q, k, v)
    assert _rel(out, want) > REL_CARD, _rel(out, want)


@pytest.mark.parametrize("growth, rescales", [(0.5, 1), (4.0, 2)])
def test_lazy_rescale_moves_the_max_only_on_growth(growth, rescales):
    """Keys whose scores grow along T (by up to 1.5 and 10 in log2 units):
    with growth under 2^8 the first tile's max is kept to the end (one
    rescale, the first tile's), a steeper one moves it once more. Either way
    the output lands within 1e-6 relative L2 of float64 and the log-sum-exp
    (here 7-11) within 1e-6 of its size."""
    B, H, S, T, D = 1, 2, 48, 160, 40
    q, k, v = _inputs((B, H, S, T, D), 7)[:3]
    q = q.abs() / 4
    k = (k.abs() * torch.linspace(1.0, 1.0 + growth, T)[:, None]).contiguous()
    out, lse, n = forward(q, k, v, mm3)
    want, want_lse = _forward_reference(q, k, v)
    assert n == rescales
    assert _rel(out, want) <= REL_3XTF32, _rel(out, want)
    assert float(((lse.double() - want_lse) / want_lse).abs().max()) <= REL_3XTF32


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

"""Kernel E1's side of the epipolar processor on the CPU
(``ops/epipolar_cuda.py``, ``diffusion/correspondence.py``): the tables and
the partner plan it is built with hold exactly the tables and the pair mask
they came from; E1's arithmetic on them (the 9-way softmax with the
log-weights, each partner's pair-mask weight folded into the probabilities,
the divisor and the mix), emulated in float32 torch, gives what the plain
composition gives; a warp's lanes hold every head at the generator's
widths; and on the CPU the processor takes the plain composition, counted
``attn.epipolar.split``. E1 itself runs on the card only
(``tests/test_torch_kernels.py``)."""

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu_torch.diffusion import correspondence as corr
from gaussctrl_exp_tpu_torch.diffusion.attention import _sdpa
from gaussctrl_exp_tpu_torch.ops import epipolar_cuda
from gaussctrl_exp_tpu_torch.utils import trace
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

V = 4
PAIR_MASKS = {
    "every_pair": np.ones((V, V), np.float32),
    # non-unit weights, view 3 isolated, view 2 with a single partner
    "partial": np.array([[1, 0.5, 0, 2], [1, 1, 0.25, 0], [0, 3, 1, 0], [0, 0, 0, 1]], np.float32),
    "none": np.zeros((V, V), np.float32),
}


def _tables(S, seed=0):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, S, (V, V, S, 9), generator=g)
    w = torch.rand((V, V, S, 9), generator=g)
    w[w < 0.2] = 0.0  # dead taps: log(1e-12)
    return idx, w


def _pm(name):
    return PAIR_MASKS[name] * (1.0 - np.eye(V))


def test_converted_tables_hold_the_tables():
    idx, w = _tables(64)
    c_idx, c_logw = epipolar_cuda.convert_tables(idx, w)
    assert c_idx.dtype == torch.int32 and c_logw.dtype == torch.float32
    assert c_idx.is_contiguous() and c_logw.is_contiguous() and c_idx.shape == c_logw.shape == idx.shape
    assert torch.equal(c_idx.long(), idx)
    assert torch.equal(c_logw, torch.log(torch.clamp(w, min=1e-12)))


@pytest.mark.parametrize("name", list(PAIR_MASKS))
def test_partner_plan_holds_the_pair_mask(name):
    pm = _pm(name)
    partners, weights = epipolar_cuda.partner_plan(pm, "cpu")
    assert partners.dtype == torch.int32 and weights.dtype == torch.float32
    assert partners.shape == weights.shape == (V, V + 1)
    rebuilt = np.zeros((V, V), np.float32)
    for a in range(V):
        n = int(partners[a, 0])
        bs = partners[a, 1 : 1 + n].numpy()
        assert list(bs) == sorted(np.flatnonzero(pm[a]))  # every partner, in order
        rebuilt[a, bs] = weights[a, 1 : 1 + n].numpy()
        assert float(weights[a, 0]) == np.float32(max(pm[a].sum(), 1.0))
        assert not partners[a, 1 + n :].any() and not weights[a, 1 + n :].any()
    assert np.array_equal(rebuilt, pm.astype(np.float32))


def _e1_emulated(q, k, v, out_self, idx, logw, partners, weights, mix):
    """E1's arithmetic in float32 torch on the converted tables and the plan:
    per partner the 9 logits with their log-weights, the softmax, and the
    value rows weighted by pm[a, b] · p into one sum; then the divisor and
    the mix (a row with no partner mixes its self-attention with itself)."""
    B, H, S, D = q.shape
    out = torch.empty_like(out_self)
    for bi in range(B):
        g, a = divmod(bi, V)
        n = int(partners[a, 0])
        acc = torch.zeros((H, S, D))
        for j in range(n):
            b, w = int(partners[a, 1 + j]), weights[a, 1 + j]
            rows = idx[a, b].long()  # (S, 9)
            kg, vg = k[g * V + b][:, rows], v[g * V + b][:, rows]  # (H, S, 9, D)
            logits = (q[bi][:, :, None, :] * kg).sum(-1) * D ** -0.5 + logw[a, b]
            acc = acc + ((w * torch.softmax(logits, -1))[..., None] * vg).sum(2)
        x = acc / weights[a, 0] if n else out_self[bi]
        out[bi] = mix * out_self[bi] + (1.0 - mix) * x
    return out


@pytest.mark.parametrize("name", list(PAIR_MASKS))
def test_e1_arithmetic_on_the_plan_is_the_plain_composition(name):
    B, H, S, D, mix = 2 * V, 2, 64, 8, 0.5
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((B, H, S, D), generator=g) for _ in range(3))
    idx, w = _tables(S, 1)
    pm = _pm(name)
    out_self = _sdpa(q, k, v)
    want = corr.epipolar_mix_plain(q, k, v, out_self, idx, w, pm, mix)
    got = _e1_emulated(q, k, v, out_self, *epipolar_cuda.convert_tables(idx, w),
                       *epipolar_cuda.partner_plan(pm, "cpu"), mix)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    alone = [bi for bi in range(B) if not pm[bi % V].any()]
    assert torch.equal(got[alone], want[alone]) and torch.equal(got[alone], out_self[alone])


@pytest.mark.parametrize("dtype,want", [(torch.float32, (3, 5, 10)), (torch.bfloat16, (2, 3, 5))])
def test_a_warp_holds_every_head_at_the_generators_widths(dtype, want):
    """SD 1.x's 8 heads of 40, 80 and 160 channels: 4 lanes a head, each
    lane holding at most ``MAX_VECTORS`` 16-byte vectors of its head."""
    assert epipolar_cuda.lanes_per_head(8) == 4
    assert tuple(epipolar_cuda.vectors_per_lane(8, D, dtype) for D in (40, 80, 160)) == want
    assert max(want) <= epipolar_cuda.MAX_VECTORS
    assert [epipolar_cuda.lanes_per_head(H) for H in (1, 2, 3, 5, 16, 32)] == [32, 16, 8, 4, 2, 1]


def test_the_cpu_processor_takes_the_plain_composition():
    S = 64
    tables = {S: _tables(S, 2)}
    pm = PAIR_MASKS["partial"]
    proc = corr.make_multires_epipolar_processor(tables, mix=0.4, pair_mask=pm)
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((2 * V, 2, S, 8), generator=g) for _ in range(3))
    assert not epipolar_cuda.takes(q, k, v)
    trace.reset(trace.CAPACITY)
    trace.enable()
    try:
        got = proc(q, k, v, False)
        counters = trace.counters()
    finally:
        trace.disable()
        trace.reset(trace.CAPACITY)
    want = corr.epipolar_mix_plain(q, k, v, _sdpa(q, k, v), *tables[S], _pm("partial"), 0.4)
    assert torch.equal(got, want)
    pairs = int((_pm("partial") != 0).sum())
    assert counters == {"attn.epipolar.split": 1, "attn.epipolar.pairs": 2 * pairs, "attn.epipolar.isolated": 2}

"""What the blend kernels B1 and B2 rest on, on the CPU: the per-tile pair
profile (``ops/blend.tile_pairs``) against a serial walk; the footprint box
of ``csrc/blend_common.cuh`` and its plain mirror (``ops/blend.footprint_box``):
the same constants, and no pixel outside a box can take its gaussian; the
exponential skip (it never drops a pair the exact alpha test takes); and B2's
butterfly, mirrored lane by lane (every field's total lands on exactly one
lane, at the stated shuffle count). No JAX."""

import re

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu_torch.ops import blend, cuda_build
from gaussctrl_exp_tpu_torch.ops.blend import MIN_ALPHA, T_EPS, count_pairs, footprint_box, tile_pairs
from gaussctrl_exp_tpu_torch.ops.projection import BLOCK
from torch_blend_scenes import screen_scene
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _serial_pairs(args, bins, H, W):
    """(walked, evaluated, composited) per tile: every pixel of the tile
    (past the image edge too) walks the list in order, carrying the
    transmittance as the plain version's cumprod does on the CPU (float32
    factors, a float64 product, each step rounded to float32 for the stop
    test); a walked pair is evaluated where the gaussian's box meets the
    pixel's two rows of the tile, all sixteen columns."""
    xys, conics, _, opacs = args
    box = footprint_box(xys, conics, opacs).numpy()
    tiles_x = (W + BLOCK - 1) // BLOCK
    wa = np.zeros(bins.tile_cnt.numel(), np.int64)
    ev, co = np.zeros_like(wa), np.zeros_like(wa)
    lin = torch.arange(BLOCK * BLOCK)
    for tile in range(bins.tile_cnt.numel()):
        start, cnt = int(bins.tile_start[tile]), int(bins.tile_cnt[tile])
        if cnt == 0:
            continue
        g = bins.gid[start:start + cnt].long()
        px = (tile % tiles_x * BLOCK + lin % BLOCK).float()[:, None]
        py = (tile // tiles_x * BLOCK + lin // BLOCK).float()[:, None]
        dx, dy = xys[g, 0][None] - px, xys[g, 1][None] - py
        sigma = 0.5 * (conics[g, 0][None] * dx * dx + conics[g, 2][None] * dy * dy) + conics[g, 1][None] * dx * dy
        alpha = torch.clamp(opacs[g][None] * torch.exp(-sigma), max=0.999)
        takes = ((sigma >= 0) & (alpha >= np.float32(MIN_ALPHA))).numpy()
        one_m = (1.0 - alpha).double().numpy()
        x0 = tile % tiles_x * BLOCK
        y0 = (py.numpy()[:, 0] // 2) * 2  # the pixel's pair of rows
        b = box[g.numpy()]
        meets = ~((b[None, :, 1] < x0) | (b[None, :, 0] > x0 + BLOCK - 1)
                  | (b[None, :, 3] < y0[:, None]) | (b[None, :, 2] > y0[:, None] + 1))
        T = np.ones(BLOCK * BLOCK)
        walking = np.ones(BLOCK * BLOCK, bool)
        for k in range(cnt):
            wa[tile] += walking.sum()
            ev[tile] += (walking & meets[:, k]).sum()
            step = walking & takes[:, k]
            assert not (step & ~meets[:, k]).any()  # the box holds every pair the test takes
            next_T = T * one_m[:, k]
            stop = step & (next_T.astype(np.float32) <= np.float32(T_EPS))
            co[tile] += (step & ~stop).sum()
            T = np.where(step & ~stop, next_T, T)
            walking &= ~stop
    return wa, ev, co


SCENES = {
    "mixed, 44×60": dict(n=150, H=44, W=60),
    "to the list's end": dict(n=300, H=40, W=40, opacity=(0.01, 0.05)),
    "early stops": dict(n=300, H=40, W=40, opacity=(0.9, 0.99)),
    "zero opacity": dict(n=150, H=40, W=56, opacity=(0.0, 0.0)),
    "a front stops every pixel": dict(n=200, H=40, W=40, front=(3, 0.97)),
    # 1 - rho² down to 5e-4: thin gaussians, some past the box's cutoff
    "thin, near-degenerate": dict(n=200, H=40, W=56, sd=(1.0, 4.0), rho=(-0.99975, 0.99975)),
}


@pytest.mark.parametrize("scene", SCENES)
def test_tile_pairs_matches_a_serial_walk(scene):
    args, bins, H, W = screen_scene("cpu", **SCENES[scene])
    want = _serial_pairs(args, bins, H, W)
    got = tile_pairs(args[0], args[1], args[3], bins, H, W)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == bins.tile_cnt.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert count_pairs(args[0], args[1], args[3], bins, H, W) == tuple(int(w.sum()) for w in want)
    walked, evaluated, composited = got
    assert bool((evaluated <= walked).all()) and bool((composited <= evaluated).all())
    if scene == "zero opacity":  # every box is empty
        assert torch.equal(walked, 256 * bins.tile_cnt.long()) and int(evaluated.sum()) == 0
    else:  # the boxes pass over some of the walked pairs, not all
        assert 0 < int(composited.sum()) < int(evaluated.sum()) < int(walked.sum())


def _header_constant(name: str) -> float:
    src = (cuda_build.SOURCES["blend_fwd"].parent / "blend_common.cuh").read_text()
    return float(re.search(rf"constexpr float {name} = ([0-9.e+-]+)f;", src).group(1))


BOX_CONSTANTS = {"kSkipMargin": "SKIP_MARGIN", "kBoxDet": "BOX_DET", "kBoxLevelScale": "BOX_LEVEL_SCALE",
                 "kBoxLevelPad": "BOX_LEVEL_PAD", "kBoxWiden": "BOX_WIDEN", "kBoxPad": "BOX_PAD"}


@pytest.mark.parametrize("name", BOX_CONSTANTS)
def test_the_plain_footprint_box_has_the_kernels_constants(name):
    assert np.float32(_header_constant(name)) == np.float32(getattr(blend, BOX_CONSTANTS[name]))


def _fma(p, q, r):
    """p * q + r rounded once to float32 (through float64, where the
    product of two float32 is exact)."""
    return (p.astype(np.float64) * q.astype(np.float64) + r).astype(np.float32)


def _fused_box(x, y, a, b, c, skip, det):
    """The box as the kernel draws it where the compiler fuses every product
    it may into the sum that follows, from the given det."""
    f32 = np.float32
    level = f32(2) * _fma(np.full_like(skip, _header_constant("kBoxLevelScale")), skip,
                          f32(_header_constant("kBoxLevelPad")))
    widen, pad = np.full_like(x, _header_constant("kBoxWiden")), f32(_header_constant("kBoxPad"))
    ex = _fma(np.sqrt(level * c / det), widen, pad)
    ey = _fma(np.sqrt(level * a / det), widen, pad)
    return np.stack([x - ex, x + ex, y - ey, y + ey], -1)


def _sigma(x, y, a, b, c, px, py):
    """sigma as the kernels round it (blend_common.cuh pair_alpha), float32."""
    dx, dy = x - px, y - py
    return np.float32(0.5) * ((a * dx) * dx + (c * dy) * dy) + (b * dx) * dy


def test_no_pixel_outside_the_footprint_box_takes_its_gaussian():
    """Gaussians of 0.3-30 px, 1 - rho² from 1 to just over the box's cutoff
    (1e-3) and just under it, centres up to 1e4 px from the origin, opacities
    1e-8 to 1. The pixels tested are the integer ones just outside each edge
    of the box, on the row (column) where sigma is least along that column
    (row) and two either side. Every one has sigma > skip as the kernels
    round it, for the box as the plain mirror draws it and as the kernel
    draws it with the products fused (det fused either way); past the cutoff
    the box is everything, and at opacity under 1/255 nothing."""
    f32 = np.float32
    rng = np.random.default_rng(0)
    m = 30_000
    cut = np.sqrt(1 - _header_constant("kBoxDet"))
    rho = np.concatenate([rng.uniform(-1, 1, m) * cut,
                          rng.choice([-1, 1], m) * cut * (1 - 10 ** rng.uniform(-7, -2, m)),
                          rng.choice([-1, 1], m // 10) * np.sqrt(1 - 1e-3 * rng.uniform(0.5, 0.999, m // 10))])
    n = rho.size
    s1, s2 = 10 ** rng.uniform(np.log10(0.3), np.log10(30), (2, n))
    det = (s1 * s2) ** 2 * (1 - rho**2)
    a, b, c = (s2**2 / det).astype(f32), (-rho * s1 * s2 / det).astype(f32), (s1**2 / det).astype(f32)
    x = np.where(rng.uniform(size=n) < 0.5, rng.uniform(-1e4, 1e4, n), rng.uniform(-50, 50, n)).astype(f32)
    y = rng.uniform(-1e4, 1e4, n).astype(f32)
    o = np.where(rng.uniform(size=n) < 0.5, 10 ** rng.uniform(-8, 0, n), rng.uniform(0, 1, n)).astype(f32)
    t = lambda *v: torch.as_tensor(np.stack(v, -1))
    plain = footprint_box(t(x, y), t(a, b, c), torch.as_tensor(o)).numpy()
    margin = f32(_header_constant("kSkipMargin"))
    skip = np.maximum(np.log(f32(255) * o) + margin, np.log(torch.as_tensor(255 * o).numpy()) + margin)
    skip = np.nextafter(skip.astype(f32), f32(np.inf))  # an ulp for the card's logf
    boxes = {"plain": plain}
    for name, d in (("a c fused", _fma(a, c, -(b * b))), ("b b fused", _fma(-b, b, a * c))):
        with np.errstate(invalid="ignore"):  # NaN where no box is drawn
            box = _fused_box(x, y, a, b, c, skip, d)
        drawn = (d >= f32(_header_constant("kBoxDet")) * a * c) & (skip >= 0)
        boxes[name] = np.where(drawn[:, None], box, plain)

    past = np.abs(rho) > cut
    assert past.sum() > 1000 and (plain[past & (skip >= 0)] == [-np.inf, np.inf, -np.inf, np.inf]).all()
    assert (plain[skip < 0] == [np.inf, -np.inf, np.inf, -np.inf]).all()
    finite = np.isfinite(plain).all(-1)
    assert finite.sum() > 30_000 and (finite == ~past & (skip >= 0)).all()
    offs = np.arange(-2, 3, dtype=f32)
    for name, box in boxes.items():
        g = np.isfinite(box).all(-1)
        x0, x1, y0, y1 = box[g].T
        xg, yg, ag, bg, cg, sk = x[g], y[g], a[g], b[g], c[g], skip[g]
        checked = 0
        for px in (np.ceil(x0) - 1, np.floor(x1) + 1):  # the columns just outside
            py = np.round(yg + bg / cg * (xg - px))[:, None] + offs  # sigma's least along the column
            sig = _sigma(xg[:, None], yg[:, None], ag[:, None], bg[:, None], cg[:, None], px[:, None].astype(f32),
                         py.astype(f32))
            assert (sig > sk[:, None]).all(), name
            checked += sig.size
        for py in (np.ceil(y0) - 1, np.floor(y1) + 1):  # the rows just outside
            px = np.round(xg + bg / ag * (yg - py))[:, None] + offs
            sig = _sigma(xg[:, None], yg[:, None], ag[:, None], bg[:, None], cg[:, None], px.astype(f32),
                         py[:, None].astype(f32))
            assert (sig > sk[:, None]).all(), name
            checked += sig.size
        assert checked > 700_000


def test_the_exponential_skip_drops_no_pair_the_alpha_test_takes():
    """A pair with sigma > log(255 * o) + kSkipMargin (all in float32, as
    the kernels stage it) has o * exp(-sigma) < 1/255 after rounding, for
    opacities from 1e-8 to 1 and sigma from just past the threshold to 40;
    and the margin is narrow: at sigma = threshold - 2 * margin the pair
    passes wherever 255 * o > 1.1."""
    margin = np.float32(_header_constant("kSkipMargin"))
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(0, 1, 100_000), 10 ** rng.uniform(-8, 0, 100_000),
                        [1.0, 0.999, 1 / 255, 1.01 / 255]]).astype(np.float32)
    skip = (np.log(np.float32(255) * o) + margin).astype(np.float32)
    one_min = np.float32(MIN_ALPHA)
    for sigma in (np.nextafter(skip, np.float32(np.inf)), skip + rng.uniform(0, 0.05, o.size).astype(np.float32),
                  rng.uniform(0, 40, o.size).astype(np.float32)):
        past = sigma > skip
        alpha = np.minimum(np.float32(0.999), o * np.exp(-sigma, dtype=np.float32))
        assert past.any() and not (alpha[past] >= one_min).any()
    near = (skip - 2 * margin).astype(np.float32)
    wide = (np.float32(255) * o > 1.1) & (near >= 0)
    assert (np.minimum(np.float32(0.999), o[wide] * np.exp(-near[wide], dtype=np.float32)) >= one_min).all()


def _scatter_sum(v, n, m):
    """blend_bwd.cu's scatter_sum<N, M> over 32 lanes (v: 32 lanes × 32)."""
    if m == 0:
        return v
    lanes = np.arange(32)
    new = v.copy()
    if n == 1:
        new[:, 0] = v[:, 0] + v[lanes ^ m, 0]
        return _scatter_sum(new, 1, m // 2)
    h = (n + 1) // 2
    upper = (lanes & m) != 0
    for i in range(h):
        lo = v[:, i]
        hi = v[:, i + h] if i + h < n else np.zeros(32)
        send = np.where(upper, lo, hi)
        new[:, i] = np.where(upper, hi, lo) + send[lanes ^ m]
    return _scatter_sum(new, h, m // 2)


def _scatter_field(n, m, lane):
    """blend_bwd.cu's scatter_field<N, M>."""
    if m == 0:
        return 0 if n == 1 else -1
    if n == 1:
        return -1 if lane & m else _scatter_field(1, m // 2, lane)
    h = (n + 1) // 2
    if lane & m:
        f = _scatter_field(h, m // 2, lane)
        return -1 if f < 0 or h + f >= n else h + f
    return _scatter_field(h, m // 2, lane)


def _shuffles(n, m):
    if m == 0:
        return 0
    return 1 + _shuffles(1, m // 2) if n == 1 else (n + 1) // 2 + _shuffles((n + 1) // 2, m // 2)


@pytest.mark.parametrize("C", range(1, 9))
def test_the_butterfly_leaves_each_field_total_on_one_lane(C):
    F = 6 + C
    rng = np.random.default_rng(C)
    v = np.zeros((32, 32))
    v[:, :F] = rng.integers(-1000, 1000, (32, F))  # integers: the sums are exact in any order
    out = _scatter_sum(v, F, 16)
    fields = [_scatter_field(F, 16, lane) for lane in range(32)]
    owners = {f: lane for lane, f in enumerate(fields) if f >= 0}
    assert sorted(owners) == list(range(F)) and sum(f >= 0 for f in fields) == F
    for f, lane in owners.items():
        assert out[lane, 0] == v[:, f].sum()
    # the shuffle count the kernel's comment states: 12 at F = 9 or 10, against 5F for a tree per field
    assert _shuffles(F, 16) == {7: 9, 8: 9, 9: 12, 10: 12, 11: 13, 12: 13, 13: 15, 14: 15}[F]

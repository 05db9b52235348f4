"""PyTorch port vs the JAX package: the geometry, the epipolar
(correspondence) processors and the triplane processor of the multi-view
attention experiments, on the scenes of tests/test_mv_attention.py.

Inputs come from numpy seeds and go through both packages in float32. Stated
tolerances: integer tables equal; tap weights exp(−|z − d|/σ) within 2e-5
relative + 1e-6 absolute (z and d near 4 carry ~1 ulp, 5e-7, of rounding
each, and 1/σ = 10 multiplies it in the exponent; measured ≤ 9.7e-6
relative); points, projections and
attention outputs ≤ 1e-5 relative L2 (the same float32 arithmetic in another
order); the triplane processor ≤ 1e-5 (``segment_sum`` and ``index_add_``
add in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.cameras import look_at as jlook_at
from gaussctrl_exp_tpu.cameras import make_camera as jmake_camera
from gaussctrl_exp_tpu.diffusion import correspondence as jcorr
from gaussctrl_exp_tpu.diffusion import geometry as jgeo
from gaussctrl_exp_tpu.diffusion import triplane_attention as jtri
from gaussctrl_exp_tpu.diffusion.attention import _sdpa as j_sdpa
from gaussctrl_exp_tpu_torch.cameras import look_at, make_camera
from gaussctrl_exp_tpu_torch.diffusion import correspondence as corr
from gaussctrl_exp_tpu_torch.diffusion import geometry as geo
from gaussctrl_exp_tpu_torch.diffusion import triplane_attention as tri
from gaussctrl_exp_tpu_torch.diffusion.attention import _sdpa
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import rel_l2

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-5
EYES = [[0.0, -4.0, 0.0], [1.0, -3.8, 0.3], [0.5, -3.9, 0.2], [-1.2, -3.7, 0.5]]


def _cams(eyes, H=32, W=32, f=40.0):
    """The same cameras in both packages."""
    j = [jmake_camera(jlook_at(np.array(e), np.zeros(3)), f, f, W / 2, H / 2, W, H) for e in eyes]
    t = [make_camera(look_at(np.array(e), np.zeros(3)), f, f, W / 2, H / 2, W, H, device="cpu") for e in eyes]
    return j, t


def _depths(n, seed, H=32, W=32):
    """Smooth depth maps around 4: a plane tilted per view plus a bump."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32) / H
    return [(4.0 + rng.uniform(-0.3, 0.3) * (xs - 0.5) + rng.uniform(-0.3, 0.3) * (ys - 0.5)
             + 0.2 * np.exp(-((xs - 0.5) ** 2 + (ys - 0.5) ** 2) * 8)).astype(np.float32) for _ in range(n)]


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


class TestGeometry:
    def test_points_and_projection_match_jax(self):
        (ja, jb), (ta, tb) = _cams(EYES[:2])
        depth = _depths(1, 0)[0]
        jp = jgeo.depth_to_world_points(jnp.asarray(depth), ja)
        tp = geo.depth_to_world_points(_t(depth), ta)
        assert tp.shape == (32, 32, 3) and rel_l2(tp, jp) <= REL
        jxy, jz = jgeo.project_points(jp, jb)
        txy, tz = geo.project_points(tp, tb)
        assert rel_l2(txy, jxy) <= REL and rel_l2(tz, jz) <= REL

    def test_unproject_project_roundtrip(self):
        _, (cam,) = _cams(EYES[:1])
        xy, z = geo.project_points(geo.depth_to_world_points(torch.full((32, 32), 4.0), cam), cam)
        py, px = torch.meshgrid(torch.arange(32.0), torch.arange(32.0), indexing="ij")
        torch.testing.assert_close(xy[..., 0], px, atol=1e-3, rtol=0)
        torch.testing.assert_close(xy[..., 1], py, atol=1e-3, rtol=0)
        torch.testing.assert_close(z, torch.full_like(z, 4.0), rtol=1e-5, atol=0)

    def test_bilinear_sample_matches_jax(self):
        rng = np.random.default_rng(1)
        grid = rng.normal(size=(6, 5, 3)).astype(np.float32)
        xy = rng.uniform(-2.0, 7.0, size=(40, 2)).astype(np.float32)  # inside, edges and outside
        want = np.asarray(jgeo.bilinear_sample(jnp.asarray(grid), jnp.asarray(xy)))
        np.testing.assert_allclose(geo.bilinear_sample(_t(grid), _t(xy)).numpy(), want, atol=1e-6, rtol=0)
        v = geo.bilinear_sample(torch.arange(16.0).reshape(4, 4, 1), torch.tensor([[1.5, 1.5], [-5.0, -5.0]]))
        torch.testing.assert_close(v, torch.tensor([[7.5], [0.0]]))


class TestCorrespondence:
    @pytest.mark.parametrize("feat_hw", [8, 16])
    def test_tables_match_jax(self, feat_hw):
        jc, tc = _cams(EYES[:3])
        depths = _depths(3, 2)
        jidx, jw = jcorr.build_correspondence_tables([jnp.asarray(d) for d in depths], jc, feat_hw)
        tidx, tw = corr.build_correspondence_tables([_t(d) for d in depths], tc, feat_hw)
        assert tidx.shape == (3, 3, feat_hw * feat_hw, 9)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=2e-5)
        assert float(tw.max()) > 0.5  # the views see the same surface
        np.testing.assert_array_equal(corr.overlap_ratio(tw).numpy(), np.asarray(jcorr.overlap_ratio(jw)))

    def test_self_view_identity(self):
        _, (cam,) = _cams(EYES[:1])
        idx, w = corr.build_correspondence_tables([torch.full((32, 32), 4.0)], [cam], feat_hw=8)
        np.testing.assert_array_equal(idx[0, 0, :, 4].numpy(), np.arange(64))
        assert float(w[0, 0, :, 4].min()) > 0.9

    def test_epipolar_attention_matches_jax(self):
        rng = np.random.default_rng(2)
        q, k, v = (rng.normal(size=(2, 64, 8)).astype(np.float32) for _ in range(3))
        idx = rng.integers(0, 64, (64, 9))
        w = rng.uniform(0.0, 1.0, (64, 9)).astype(np.float32)
        w[:, 0] = 0.0  # a dead tap
        want = jcorr.epipolar_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(idx, jnp.int32), jnp.asarray(w))
        got = corr.epipolar_attention(_t(q), _t(k), _t(v), torch.as_tensor(idx), _t(w))
        assert got.shape == (2, 64, 8) and rel_l2(got, want) <= REL

    def _qkv(self, B, S, seed):
        rng = np.random.default_rng(seed)
        return [rng.normal(size=(B, 2, S, 8)).astype(np.float32) for _ in range(3)]

    def test_epipolar_processor_matches_jax(self):
        jc, tc = _cams(EYES[:2])
        depths = _depths(2, 3)
        jt = jcorr.build_correspondence_tables([jnp.asarray(d) for d in depths], jc, 8)
        tt = corr.build_correspondence_tables([_t(d) for d in depths], tc, 8)
        q, k, v = self._qkv(4, 64, 3)  # 2 CFG groups × 2 views
        want = jcorr.make_epipolar_processor(*jt, mix=0.4)(*map(jnp.asarray, (q, k, v)), False)
        got = corr.make_epipolar_processor(*tt, mix=0.4)(_t(q), _t(k), _t(v), False)
        assert rel_l2(got, want) <= REL
        # cross-attention and other lengths pass through to plain attention
        torch.testing.assert_close(corr.make_epipolar_processor(*tt)(_t(q), _t(k), _t(v), True),
                                   _sdpa(_t(q), _t(k), _t(v)), rtol=0, atol=0)

    @pytest.mark.parametrize("pair_mask", [None, "partial", "none"])
    def test_multires_processor_matches_jax(self, pair_mask):
        jc, tc = _cams(EYES[:3])
        depths = _depths(3, 4)
        jtab, ttab = {}, {}
        for s in (8, 4):
            jtab[s * s] = jcorr.build_correspondence_tables([jnp.asarray(d) for d in depths], jc, s)
            ttab[s * s] = corr.build_correspondence_tables([_t(d) for d in depths], tc, s)
        pm = {None: None, "partial": np.array([[1, 1, 0], [1, 1, 0], [0, 0, 1]], np.float32),
              "none": np.zeros((3, 3), np.float32)}[pair_mask]
        jproc = jcorr.make_multires_epipolar_processor(jtab, mix=0.3, pair_mask=pm)
        tproc = corr.make_multires_epipolar_processor(ttab, mix=0.3, pair_mask=pm)
        for S, seed in ((64, 5), (16, 6), (4, 7)):  # two tables, and a length with none
            q, k, v = self._qkv(6, S, seed)
            got = tproc(_t(q), _t(k), _t(v), False)
            assert rel_l2(got, jproc(*map(jnp.asarray, (q, k, v)), False)) <= REL
        if pair_mask == "none":  # every pair masked: pure self-attention
            torch.testing.assert_close(got, _sdpa(_t(q), _t(k), _t(v)))


class TestTriplane:
    def test_scatter_and_sample_match_jax(self):
        rng = np.random.default_rng(0)
        feats = rng.normal(size=(300, 6)).astype(np.float32)
        uv = rng.uniform(0, 1, (300, 2)).astype(np.float32)
        jplane = jtri.scatter_mean_plane(jnp.asarray(feats), jnp.asarray(uv), 8)
        tplane = tri.scatter_mean_plane(_t(feats), _t(uv), 8)
        assert tplane.shape == (64, 6) and rel_l2(tplane, jplane) <= 1e-6
        assert rel_l2(tri.sample_plane(tplane, _t(uv), 8), jtri.sample_plane(jplane, jnp.asarray(uv), 8)) <= 1e-6
        ones = tri.scatter_mean_plane(torch.ones(100, 4), _t(uv[:100]), 8)
        occ = ones.sum(-1) > 0
        torch.testing.assert_close(ones[occ], torch.ones_like(ones[occ]))

    def test_processor_matches_jax(self):
        V, S, Hh, D = 2, 64, 2, 8
        rng = np.random.default_rng(1)
        pts = rng.normal(size=(V, S, 3)).astype(np.float32)
        q, k, v = (rng.normal(size=(2 * V, Hh, S, D)).astype(np.float32) for _ in range(3))
        jq = [jnp.asarray(x) for x in (q, k, v)]
        for mix in (0.5, 1.0):
            want = jtri.make_triplane_processor(jnp.asarray(pts), mix=mix, plane_res=8)(*jq, False)
            got = tri.make_triplane_processor(_t(pts), mix=mix, plane_res=8)(_t(q), _t(k), _t(v), False)
            assert got.shape == q.shape and rel_l2(got, want) <= REL
        # mix 1 is plain self-attention; another sequence length passes through
        proc = tri.make_triplane_processor(_t(pts), mix=1.0, plane_res=8)
        torch.testing.assert_close(proc(_t(q), _t(k), _t(v), False), _sdpa(_t(q), _t(k), _t(v)), atol=1e-6, rtol=0)
        half = [_t(x[:, :, : S // 2]) for x in (q, k, v)]
        torch.testing.assert_close(proc(*half, False), _sdpa(*half), rtol=0, atol=0)
        np.testing.assert_allclose(np.asarray(j_sdpa(*jq)), _sdpa(_t(q), _t(k), _t(v)).numpy(), atol=1e-6)

"""PyTorch port vs the JAX package: the blend-forward ablations (kernel B1v)
and the backward micro-benchmark (B2c).

The plain version of every mode of ``ops/blend_variants.py`` is held against
the variant script's own Pallas kernels (``make_fwd_kernel(mode)`` and
``make_pair_kernel()`` of ``scripts/bench_blend_variants.py``) in interpret
mode, launched with the script's grid specs (copied here from its lines
211-240) over the JAX binning's aligned stream; the port's chunk table is
held against that binning's chunk metadata; and the port of
``scripts/bench_bwd_micro.py`` against ``blend_pallas._blend_core_fwd`` +
``_blend_core_bwd`` in interpret mode on the script's fixed cotangents. The
script files are loaded as they are, with ``sys.argv`` set to a small size.

The script gathers its depth-ordered field pack by gaussian id (its lines
206-208, written when the aligned stream carried depth ranks), so its own
runs blend a permutation of the scene. The kernels here are fed the pack as
``blend_pallas.py:380-385`` builds it, in gaussian order.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from conftest import make_test_scene
from gaussctrl_exp_tpu.cameras import camera_matrices, look_at, make_camera
from gaussctrl_exp_tpu.ops import blend_pallas as BP
from gaussctrl_exp_tpu.ops.binning import bin_gaussians
from gaussctrl_exp_tpu.ops.projection import BLOCK, project_gaussians
from gaussctrl_exp_tpu_torch.ops import blend_variants as V
from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians as tbin
from gaussctrl_exp_tpu_torch.ops.blend import T_EPS, rasterize_tiles_plain
from gaussctrl_exp_tpu_torch.ops.projection import ProjectedGaussians
from gaussctrl_exp_tpu_torch.scripts import bench_bwd_micro as micro
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
# The two sides round the transmittance differently (a cumsum here, a matmul
# against a triangular matrix there; a cumprod here, a lane-shift scan
# there): ~1e-6 relative at most. Each scene asserts that no stop decision
# lies within V.STOP_BAND (1e-4 relative) of T_EPS, so both take the same
# decisions and 1e-5 holds on every defined tile, with equal done flags. The
# dense scene's seed (5) was picked for that margin: about one stopping
# pixel in a thousand lies in the band.
ATOL = 1e-5
SCRIPT_N, SCRIPT_S = 300, 64


def _load_script(name: str, *argv):
    """``scripts/<name>.py`` as a module, run with ``sys.argv[1:] = argv``."""
    saved = sys.argv
    sys.argv = [f"{name}.py"] + [str(a) for a in argv]
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_script_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


@pytest.fixture(scope="module")
def script():
    return _load_script("bench_blend_variants", SCRIPT_N, SCRIPT_S)


def _jax_variant(script, mode, scene):
    """Mode ``mode`` of the script's kernels in interpret mode, with the grid
    specs of its lines 211-240."""
    bins, (xys, conics, colors, opacs) = scene["bj"], scene["args"]
    n_chan = colors.shape[1]
    tiles_x = (scene["W"] + BLOCK - 1) // BLOCK
    num_tiles = tiles_x * ((scene["H"] + BLOCK - 1) // BLOCK)
    nc = int(bins.aligned_capacity) // BP.CHUNK
    packed = BP._pack_fields(*(jnp.asarray(a) for a in (xys, conics, colors, opacs)))
    fr = jnp.pad(packed, ((0, 0), (0, 1)))
    vals = jnp.pad(fr[:, bins.aligned_gid], ((0, BP.NFIELD - packed.shape[0]), (0, 0)))
    if mode == "pair":
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3,
            grid=(nc // 2,),
            in_specs=[
                pl.BlockSpec((BP.NFIELD, 2 * BP.CHUNK), lambda c, ct, cb, cc_: (0, c),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(
                (1, BP.P, 16), lambda c, ct, cb, cc_: (ct[2 * c], 0, 0),
                memory_space=pltpu.VMEM,
            ),
            scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        )
        kern = script.make_pair_kernel()
    else:
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3,
            grid=(nc,),
            in_specs=[
                pl.BlockSpec((BP.NFIELD, BP.CHUNK), lambda c, ct, cb, cc_: (0, c),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(
                (1, BP.P, 16), lambda c, ct, cb, cc_: (ct[c], 0, 0),
                memory_space=pltpu.VMEM,
            ),
            scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        )
        kern = script.make_fwd_kernel(mode)
    out = pl.pallas_call(
        functools.partial(kern, tiles_x=tiles_x, n_chan=n_chan),
        out_shape=jax.ShapeDtypeStruct((num_tiles, BP.P, 16), jnp.float32),
        grid_spec=grid_spec,
        interpret=True,
    )(bins.chunk_tile, bins.chunk_base, bins.chunk_cnt, vals)
    return np.asarray(out)


def _scene(means, scales, quats, colors, opacs, cam, H, W, capacity):
    """JAX projection (as the script calls it: no opacities) and binning at
    ``capacity``; the port's binning of the same projection."""
    vm, _, fm = camera_matrices(cam)
    pj = project_gaussians(jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats), vm, fm,
                           cam.fx, cam.fy, cam.cx, cam.cy, H, W)
    tx, ty = (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK
    bj = jax.jit(bin_gaussians, static_argnums=(1, 2, 3))(pj, tx, ty, capacity)
    assert int(bj.n_isects) <= capacity
    pt = ProjectedGaussians(**{k: torch.as_tensor(np.array(v)) for k, v in pj._asdict().items()})
    args = tuple(np.array(a, np.float32) for a in (pj.xys, pj.conics, colors, opacs))
    return dict(args=args, bj=bj, bt=tbin(pt, tx, ty), H=H, W=W, capacity=capacity)


def _camera(H, W, f=80.0):
    return make_camera(look_at(np.array([0.0, -4.0, 0.0]), np.zeros(3)), f, f, W / 2, H / 2, W, H)


_SCENES = {}


def _get_scene(name, script):
    """The script's own scene at (300, 64) and its capacity (1 << 18); a
    dense one at C = 3 whose tiles hold several chunks; a sparse 64×144 one
    with empty tiles."""
    if name not in _SCENES:
        if name == "script":
            s = script
            _SCENES[name] = _scene(s.means, s.scales, s.quats, s.colors, s.opacs, s.cam, s.S, s.S, s.CAP)
        elif name == "dense C=3":
            means, scales, quats, colors, opacs = make_test_scene(np.random.default_rng(5), n=700, spread=0.5)
            _SCENES[name] = _scene(means, scales, quats, colors, opacs, _camera(64, 64), 64, 64, 1 << 14)
        else:
            means, scales, quats, colors, opacs = make_test_scene(np.random.default_rng(2), n=40)
            colors = np.concatenate([colors, opacs[:, None]], -1)
            _SCENES[name] = _scene(means, scales, quats, colors, opacs, _camera(64, 144), 64, 144, 1 << 12)
    return _SCENES[name]


SCENE_NAMES = ["script", "dense C=3", "empty tiles"]


def _torch_args(scene):
    return tuple(torch.as_tensor(a) for a in scene["args"])


def _plain_run(mode, scene):
    return V.variant_plain_run(mode, *_torch_args(scene), scene["bt"], scene["H"], scene["W"], scene["capacity"])


def _table(scene):
    tx = (scene["W"] + BLOCK - 1) // BLOCK
    ty = (scene["H"] + BLOCK - 1) // BLOCK
    return V.chunk_table(scene["bt"].tile_cnt, tx, ty, int(scene["bj"].aligned_capacity))


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_chunk_table_matches_jax_binning(script, name):
    scene = _get_scene(name, script)
    bj, table = scene["bj"], _table(scene)
    assert V.aligned_capacity(scene["capacity"], table.num_tiles) == int(bj.aligned_capacity)
    np.testing.assert_array_equal(scene["bt"].tile_cnt.numpy(), np.asarray(bj.tile_cnt))
    for field in ("chunk_tile", "chunk_base", "chunk_cnt"):
        got = getattr(table, field)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(bj, field)), err_msg=field)


@pytest.mark.parametrize("mode", V.MODES)
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_plain_matches_script_kernel(script, name, mode):
    scene = _get_scene(name, script)
    want = _jax_variant(script, mode, scene)
    run = _plain_run(mode, scene)
    got = run.out.numpy()
    C = scene["args"][2].shape[1]
    defined = V.defined_tiles(mode, _table(scene)).numpy()
    # the TPU kernel leaves exactly the tiles it never initialises undefined
    np.testing.assert_array_equal(np.isfinite(want).all(axis=(1, 2)), defined)
    assert defined.any()
    # margin: no stop decision within rounding of T_EPS on either side
    assert not bool(run.band[torch.as_tensor(defined)].any())
    np.testing.assert_allclose(got[defined][..., :C], want[defined][..., :C], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[defined][..., V.COL_T], want[defined][..., V.COL_T], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[defined][..., V.COL_DONE], want[defined][..., V.COL_DONE])
    np.testing.assert_array_equal(want[defined][..., C:V.COL_T], 0.0)
    np.testing.assert_array_equal(got[..., C:V.COL_T], 0.0)
    np.testing.assert_array_equal(got[..., V.COL_DONE + 1:], 0.0)
    # the port writes the init where the TPU kernel's output is undefined
    init = np.zeros((V.P, V.NCOL), np.float32)
    init[:, V.COL_T] = 1.0
    np.testing.assert_array_equal(got[~defined], np.broadcast_to(init, got[~defined].shape))
    if mode not in ("empty", "pair"):  # every tile with intersections holds real work
        assert defined[scene["bt"].tile_cnt.numpy() > 0].all()
    if mode == "empty":
        assert run.pairs == 0 and run.chunks == 0
    else:
        assert run.pairs > 0 and float(got[defined][..., V.COL_T].min()) < 0.9


def test_scenes_cover_what_the_modes_depend_on(script):
    """The dense scene has tiles of several chunks (so ``nomatmul`` and the
    chunk boundaries matter); the sparse one has empty tiles that own a
    padding chunk (initialised) and empty tiles that own none (undefined);
    ``pair`` leaves some tile with intersections undefined and folds a
    chunk of another tile into some owner."""
    dense, sparse = _get_scene("dense C=3", script), _get_scene("empty tiles", script)
    assert int(dense["bt"].tile_cnt.max()) > 2 * V.CHUNK
    table = _table(sparse)
    empty = sparse["bt"].tile_cnt == 0
    defined = V.defined_tiles("base", table)
    assert bool((empty & defined).any()) and bool((empty & ~defined).any())
    for scene in (_get_scene("script", script), dense):
        t = _table(scene)
        pair_defined = V.defined_tiles("pair", t)
        assert bool((~pair_defined & (scene["bt"].tile_cnt > 0)).any())
        seqs = V._sequences("pair", t, scene["bt"].tile_cnt.tolist())
        assert any(src != owner for owner, items in seqs for src, _ in items)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_scan_matches_base(script, name):
    """``scan`` is exact: the same function as ``base`` up to rounding."""
    scene = _get_scene(name, script)
    base, scan = _plain_run("base", scene).out, _plain_run("scan", scene).out
    torch.testing.assert_close(scan, base, rtol=0, atol=ATOL)
    torch.testing.assert_close(scan[..., V.COL_DONE], base[..., V.COL_DONE], rtol=0, atol=0)


def test_base_matches_the_blend(script):
    """``base`` carries T between chunks as B1 does: its image and
    transmittance are the plain blend's."""
    scene = _get_scene("dense C=3", script)
    H, W = scene["H"], scene["W"]
    img, T = V.tiles_to_image(_plain_run("base", scene).out, H, W, 3)
    want = rasterize_tiles_plain(*_torch_args(scene), scene["bt"], H, W)
    torch.testing.assert_close(img, want.img, rtol=0, atol=ATOL)
    torch.testing.assert_close(T, want.final_T, rtol=0, atol=ATOL)


def test_wrapper_takes_the_plain_version_on_the_cpu(script):
    scene = _get_scene("script", script)
    args, H, W = _torch_args(scene), scene["H"], scene["W"]
    before = dict(V.launches)
    got = V.blend_variant("nomatmul", *args, scene["bt"], H, W)
    assert V.launches == before
    torch.testing.assert_close(got, V.blend_variant_plain("nomatmul", *args, scene["bt"], H, W), rtol=0, atol=0)


def test_wrapper_refuses(script):
    scene = _get_scene("script", script)
    args, H, W = _torch_args(scene), scene["H"], scene["W"]
    with pytest.raises(ValueError):
        V.blend_variant("fast", *args, scene["bt"], H, W)
    with pytest.raises(ValueError):  # no kernel for this device, and no fallback
        V.blend_variant("base", *(a.to("meta") for a in args), scene["bt"], H, W)
    with pytest.raises(ValueError):  # more intersections than the capacity
        V.blend_variant("pair", *args, scene["bt"], H, W, capacity=scene["bt"].n_isects - 1)


def test_bwd_micro_matches_jax_backward():
    """The port of bench_bwd_micro (projection + binning + blend forward +
    blend backward on the fixed cotangents) against the JAX package's
    ``_blend_core_fwd`` + ``_blend_core_bwd`` in interpret mode. Gaussian 0
    is visible, so the dropped gradient of ROADMAP §C 1 (which needs the
    leading gaussians culled) does not enter."""
    N, S, cap = 300, 64, 1 << 12
    jm = _load_script("bench_bwd_micro", N, S, cap)
    p = project_gaussians(jm.means, jm.scales, 1.0, jm.quats, jm.vm, jm.fm, jm.cam.fx, jm.cam.fy, jm.cam.cx,
                          jm.cam.cy, S, S)
    bins = jax.jit(bin_gaussians, static_argnums=(1, 2, 3))(p, jm.TX, jm.TY, cap)
    assert int(bins.n_isects) <= cap
    assert int(bins.nt_orig[0]) > 0
    _, res = BP._blend_core_fwd(p.xys, p.conics, jm.colors, jm.opacs, BP._bins_tuple(bins), S, S, cap,
                                bins.aligned_capacity, True)
    want = BP._blend_core_bwd(S, S, cap, bins.aligned_capacity, True, res, (jm.g_img_c, jm.g_T_c))[:4]

    sc = micro.make_scene(N, S, "cpu")
    np.testing.assert_array_equal(sc.means.numpy(), np.asarray(jm.means))
    np.testing.assert_array_equal(sc.g_img.numpy(), np.asarray(jm.g_img_c))
    np.testing.assert_array_equal(sc.g_T.numpy(), np.asarray(jm.g_T_c))
    _, _, fwd = micro.forward_core(sc)
    # margin: no pixel stops within rounding of T_EPS (the two round T apart)
    assert float(((fwd.final_T - T_EPS).abs() / T_EPS).min()) > V.STOP_BAND
    got = micro.backward_core(sc)
    for name, g, w in zip(("xys", "conics", "colors", "opacs"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale, err_msg=name)


def test_the_scripts_time_only_the_card():
    """The ported scripts measure the card: with no card their timing and
    their entry points refuse, and never time the CPU in its place."""
    from gaussctrl_exp_tpu_torch.scripts import bench_blend_variants
    from gaussctrl_exp_tpu_torch.utils.timing import kernel_time_ms, slope_time_ms

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        slope_time_ms(lambda: None, 1, 2, 1)
    with pytest.raises(RuntimeError):
        kernel_time_ms(lambda: None, "variant_kernel")
    for main in (bench_blend_variants.main, micro.main):
        with pytest.raises(RuntimeError):
            main(["300", "64"])

"""PyTorch port vs the JAX package: the whole GaussCtrl edit loop.

``render_reverse`` + ``edit_images`` on a tiny synthetic scene (6 views at
64², 2 DDIM steps, chunks of 2, one masked view) with the JAX package's tiny
SD stack and a tiny CLIP tower, the port carrying the same weights; both use
the same BPE tokenizer on its test vocabulary. The renders, the inverted
latents ``z0`` and the written-back images are compared: relative L2 ≤ 1e-4
(the float32 loop of render → VAE → 2-step inversion → 2-step CFG
generation → VAE; measured: renders 1e-7, disparities 7e-7, z0 ≤ 1.5e-5,
images ≤ 2.3e-5). Also the sidecar resume, and the edit with each of
the experimental cross-view processors ("correspondence", "triplane") from
the same inverted latents, against the JAX pipeline at the same 1e-4.
"""

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.cameras import look_at as jlook_at
from gaussctrl_exp_tpu.cameras import make_camera as jmake_camera
from gaussctrl_exp_tpu.diffusion import pipeline as jpl
from gaussctrl_exp_tpu.diffusion.tokenizer import CLIPTokenizer as JTokenizer
from gaussctrl_exp_tpu.diffusion.tokenizer import make_test_vocab
from gaussctrl_exp_tpu.models.gaussians import init_random as jinit_random
from gaussctrl_exp_tpu.models.splat_model import SplatModelConfig as JModelConfig
from gaussctrl_exp_tpu.ops.renderer import RenderConfig as JRenderConfig
from gaussctrl_exp_tpu_torch.cameras import look_at, make_camera
from gaussctrl_exp_tpu_torch.diffusion import pipeline as tpl
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import init_random_models
from gaussctrl_exp_tpu_torch.diffusion.tokenizer import CLIPTokenizer
from gaussctrl_exp_tpu_torch.models.gaussians import GaussianState, params_from_numpy
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY, jax_tiny, port_tiny, rel_l2

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_LOOP = 1e-4
V, H, W = 6, 64, 64
MASKED = 3


class DM:
    """Cameras on an arc and a write-back buffer, as tests/test_diffusion.py's."""

    def __init__(self, make, look, n=V, view_indices=None):
        self.make, self.look, self.n = make, look, n
        self.images = np.zeros((n, H, W, 3), np.float32)
        self.width, self.height = W, H
        self.writes = []
        if view_indices is not None:
            self.view_indices = view_indices

    def __len__(self):
        return self.n

    def camera(self, i):
        ang = 0.3 * i
        eye = np.array([4 * np.sin(ang), -4 * np.cos(ang), 1.0])
        return self.make(self.look(eye, np.zeros(3)), 70.0, 70.0, W / 2, H / 2, W, H)

    def write_back(self, i, img):
        self.writes.append(i)
        self.images[i] = img


def _port_dm(**kw):
    return DM(lambda *a: make_camera(*a, device="cpu"), look_at, **kw)


def _cfg(module, **kw):
    return module.EditConfig(edit_prompt="a bear statue", reverse_prompt="a bear", num_inference_steps=2,
                             chunk_size=2, guidance_scale=5.0, **kw)


def _scene():
    gs = jinit_random(64, capacity=64, sh_degree=1, seed=0)
    arrays = {k: np.array(v) for k, v in gs.params._asdict().items()}
    return gs, GaussianState(params_from_numpy(arrays, "cpu"), torch.as_tensor(np.array(gs.alive)))


def test_edit_loop_matches_jax():
    jm = jax_tiny(0)
    vocab, merges = make_test_vocab()
    jgs, tgs = _scene()
    mask = (np.random.default_rng(5).uniform(size=(H, W)) > 0.5).astype(np.float32)

    jpipe = jpl.GaussCtrlEditPipeline(_cfg(jpl, latent_size=8), models=jm, tokenizer=JTokenizer(vocab, merges))
    jdm = DM(jmake_camera, jlook_at)
    jpipe.render_reverse(jgs, jdm, JModelConfig(sh_degree=1, background_color="white", render=JRenderConfig(
        impl="jnp", isect_capacity=1 << 12, max_per_tile=128)))
    jpipe.masks[MASKED] = mask
    jpipe.edit_images(jdm)

    tpipe = tpl.GaussCtrlEditPipeline(_cfg(tpl), models=port_tiny(jm), tokenizer=CLIPTokenizer(vocab, merges))
    tdm = _port_dm()
    tpipe.render_reverse(tgs, tdm, SplatModelConfig(sh_degree=1, background_color="white"))
    tpipe.masks[MASKED] = mask
    tpipe.edit_images(tdm)

    assert tpipe.n_inversions == V and sorted(tdm.writes) == list(range(V))
    for i in range(V):
        assert tpipe.z0[i].shape == (8, 8, 4) and tpipe.z0[i].dtype == np.float32
        assert tpipe.disparity[i].shape == (H, W, 3)
        assert rel_l2(tpipe.unedited[i], jpipe.unedited[i]) <= 1e-5
        assert rel_l2(tpipe.disparity[i], jpipe.disparity[i]) <= 1e-5
        assert rel_l2(tpipe.z0[i], np.asarray(jpipe.z0[i])) <= REL_LOOP
        assert rel_l2(tdm.images[i], jdm.images[i]) <= REL_LOOP
    assert tdm.images.min() >= 0.0 and tdm.images.max() <= 1.0
    # the masked view keeps its unedited render where the mask is 0
    keep = mask == 0
    np.testing.assert_array_equal(tdm.images[MASKED][keep], tpipe.unedited[MASKED][keep])


@pytest.fixture(scope="module")
def tiny_models():
    return init_random_models(1, "cpu", **TINY)


def test_sidecar_resume(tiny_models, tmp_path):
    """A second render_reverse resumes every view from the sidecars with no
    inversion; global frame numbers follow the datamanager's view indices."""
    _, gs = _scene()
    mcfg = SplatModelConfig(sh_degree=1, background_color="white")

    def make_pipe():
        return tpl.GaussCtrlEditPipeline(_cfg(tpl, sidecar_dir=str(tmp_path)), models=tiny_models,
                                         tokenizer=CLIPTokenizer(*make_test_vocab()))

    dm = _port_dm(n=3, view_indices=[0, 2, 4])
    p1 = make_pipe()
    p1.masks[1] = np.ones((H, W), np.float32)
    p1.render_reverse(gs, dm, mcfg)
    assert p1.n_inversions == 3 and p1.n_resumed == 0
    assert (tmp_path / "z_0" / "frame_00003.npy").exists()  # global index 2
    assert (tmp_path / "mask_npy" / "frame_00003.npy").exists()
    p2 = make_pipe()
    p2.render_reverse(gs, dm, mcfg)
    assert p2.n_inversions == 0 and p2.n_resumed == 3
    for i in range(3):
        np.testing.assert_array_equal(p2.z0[i], p1.z0[i])
        np.testing.assert_array_equal(p2.unedited[i], p1.unedited[i])
        np.testing.assert_allclose(p2.disparity[i], p1.disparity[i], atol=1e-6)
    assert list(p2.masks) == [1]
    p3 = make_pipe()
    p3.render_reverse(gs, dm, mcfg, force_recompute=True)
    assert p3.n_inversions == 3 and p3.n_resumed == 0


@pytest.mark.parametrize("proc", ["triplane", "correspondence"])
def test_unported_processors_raise(tiny_models, proc):
    """The experimental processors are ported now: each builds from a
    chunk's geometry, and only an unknown name raises."""
    pipe = tpl.GaussCtrlEditPipeline(_cfg(tpl, attn_processor=proc, latent_size=8), models=tiny_models,
                                     tokenizer=CLIPTokenizer(*make_test_vocab()))
    dm = _port_dm()
    pipe.depths = {i: np.full((H, W), 4.0 + 0.1 * i, np.float32) for i in range(V)}
    geom = pipe._chunk_geometry(dm, [0, 2, 4])
    if proc == "triplane":
        assert geom.shape == (3, 64, 3)
    else:
        assert geom[0].shape == geom[1].shape == (3, 3, 64, 9)
    assert callable(pipe._make_processor(geom))
    bad = tpl.GaussCtrlEditPipeline(_cfg(tpl, attn_processor="bogus"), models=tiny_models,
                                    tokenizer=CLIPTokenizer(*make_test_vocab()))
    with pytest.raises(ValueError, match="bogus"):
        bad.edit_images(dm)


@pytest.fixture(scope="module")
def inverted():
    """render_reverse in both packages once: their pipelines' caches."""
    jm = jax_tiny(0)
    vocab, merges = make_test_vocab()
    jgs, tgs = _scene()
    jpipe = jpl.GaussCtrlEditPipeline(_cfg(jpl, latent_size=8), models=jm, tokenizer=JTokenizer(vocab, merges))
    jpipe.render_reverse(jgs, DM(jmake_camera, jlook_at), JModelConfig(
        sh_degree=1, background_color="white",
        render=JRenderConfig(impl="jnp", isect_capacity=1 << 12, max_per_tile=128)))
    tpipe = tpl.GaussCtrlEditPipeline(_cfg(tpl), models=port_tiny(jm), tokenizer=CLIPTokenizer(vocab, merges))
    tpipe.render_reverse(tgs, _port_dm(), SplatModelConfig(sh_degree=1, background_color="white"))
    return jpipe, tpipe


@pytest.mark.parametrize("proc", ["correspondence", "triplane"])
def test_experimental_processors_match_jax(inverted, proc):
    """edit_images with an experimental processor, whose geometry comes from
    the cached depths, in both packages from the same inverted latents."""
    jbase, tbase = inverted
    mask = (np.random.default_rng(6).uniform(size=(H, W)) > 0.5).astype(np.float32)
    kw = dict(attn_processor=proc, latent_size=8, triplane_plane_res=8)
    jpipe = jpl.GaussCtrlEditPipeline(_cfg(jpl, **kw), models=jbase.models, tokenizer=jbase.tokenize)
    tpipe = tpl.GaussCtrlEditPipeline(_cfg(tpl, **kw), models=tbase.models, tokenizer=tbase.tokenize)
    for dst, src in ((jpipe, jbase), (tpipe, tbase)):
        for name in ("z0", "disparity", "depths", "unedited"):
            setattr(dst, name, dict(getattr(src, name)))
        dst.masks[MASKED] = mask
    jdm, tdm = DM(jmake_camera, jlook_at), _port_dm()
    jpipe.edit_images(jdm)
    tpipe.edit_images(tdm)
    assert sorted(tdm.writes) == list(range(V))
    for i in range(V):
        assert rel_l2(tdm.images[i], jdm.images[i]) <= REL_LOOP
    assert tdm.images.min() >= 0.0 and tdm.images.max() <= 1.0
    # the processor changed the edit: it is not AttnAlign's
    ref = tpl.GaussCtrlEditPipeline(_cfg(tpl), models=tbase.models, tokenizer=tbase.tokenize)
    for name in ("z0", "disparity", "depths", "unedited"):
        setattr(ref, name, dict(getattr(tbase, name)))
    ref_dm = _port_dm()
    ref.edit_images(ref_dm)
    assert float(np.abs(ref_dm.images - tdm.images).max()) > 1e-4


@pytest.mark.parametrize("n", [6, 7, 40])
def test_reference_views_and_disparity_match_jax(n):
    assert tpl.select_reference_views(n, 4) == jpl.select_reference_views(n, 4)
    d = np.random.default_rng(n).uniform(0.5, 5.0, (9, 7)).astype(np.float32)
    d[0, 0] = 1000.0
    np.testing.assert_array_equal(tpl.depth_to_disparity(d), jpl.depth_to_disparity(d))

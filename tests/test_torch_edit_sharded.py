"""PyTorch port vs the JAX package: ``parallel/edit_sharded.py`` (the edit
denoise with its views sharded over ranks).

Four gloo ranks in spawned processes (``tests/torch_parallel_worker.py``,
FileStore in ``tmp_path``, a join deadline) run the port's view-sharded
AttnAlign processor on random q, k, v and its sharded CFG generation on the
tiny SD stack (the JAX package's ``TINY`` weights carried over), 8 views of
which the first 4 are the references, spread over ranks 0 and 1. They are
held against the port's unsharded ``make_cross_view_processor`` and
generation in this process, and against the JAX package's
``sharded_cross_view_processor`` and ``make_sharded_generate`` on 4 virtual
CPU devices. Float32, torch on one thread. Tolerances: the processor 2e-6
absolute against the port (the one-hot sums are exact; only the batch
differs) and rtol 2e-5, atol 2e-6 against JAX (as the JAX package's own
test); the generation rtol 5e-4, atol 5e-5 against either (as the JAX
package's own sharded-generation test).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.diffusion.sd_pipeline import SDControlNetPipeline as JPipeline
from gaussctrl_exp_tpu.diffusion.sd_pipeline import init_random_models as jinit_random_models
from gaussctrl_exp_tpu.parallel import edit_sharded as jes
from gaussctrl_exp_tpu_torch.diffusion import params as P
from gaussctrl_exp_tpu_torch.diffusion.attention import make_cross_view_processor
from gaussctrl_exp_tpu_torch.diffusion.controlnet import ControlNet
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDControlNetPipeline, SDModels
from gaussctrl_exp_tpu_torch.diffusion.unet import UNet2DCondition
from gaussctrl_exp_tpu_torch.diffusion.vae import AutoencoderKL
from gaussctrl_exp_tpu_torch.parallel.edit_sharded import shard_views
from gaussctrl_exp_tpu_torch.parallel.sharded import Mesh
from test_torch_parallel import run_workers
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY, load

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RANKS, V, LAT, STEPS, GUIDANCE = 4, 8, 8, 1, 5.0
HEADS, SEQ, DIM = 2, 16, 8
PROC_EXACT, PROC_RTOL, PROC_ATOL = 2e-6, 2e-5, 2e-6
GEN_RTOL, GEN_ATOL = 5e-4, 5e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs, the JAX tiny stack, the port's modules with its weights, and
    the four ranks' outputs."""
    jm = jinit_random_models(jax.random.PRNGKey(0), latent=LAT, **TINY)
    kw = dict(block_out=TINY["block_out"], layers_per_block=TINY["layers_per_block"], heads=TINY["heads"],
              cross_dim=TINY["cross_dim"], temb_dim=TINY["block_out"][-1])
    models = SDModels(
        unet=load(UNet2DCondition(**kw), P.unet_params_from_flax(jax.device_get(jm.unet_params))),
        controlnet=load(ControlNet(**kw), P.controlnet_params_from_flax(jax.device_get(jm.controlnet_params))),
        vae=load(AutoencoderKL(TINY["vae_block_out"]), P.vae_params_from_flax(jax.device_get(jm.vae_params))),
    )
    rng = np.random.default_rng(0)
    inp = dict(
        q=rng.normal(size=(V, 2, HEADS, SEQ, DIM)), k=rng.normal(size=(V, 2, HEADS, SEQ, DIM)),
        v=rng.normal(size=(V, 2, HEADS, SEQ, DIM)), lat=rng.normal(size=(V, LAT, LAT, 4)),
        ctx_c=rng.normal(size=(V, 77, 32)), ctx_u=rng.normal(size=(V, 77, 32)),
        hint=rng.uniform(0, 1, (V, LAT * 8, LAT * 8, 3)))
    inp = {k: a.astype(np.float32) for k, a in inp.items()}
    d = tmp_path_factory.mktemp("edit")
    np.savez(d / "inputs.npz", guidance=GUIDANCE, steps=STEPS, **inp)
    torch.save(models, d / "models.pt")
    return jm, models, inp, run_workers("edit", RANKS, d)


def cfg_batch(x):  # (V, 2, …) → (2V, …), laid out (2, V, …)
    return x.swapaxes(0, 1).reshape(2 * V, *x.shape[2:])


def test_sharded_processor_matches_unsharded_and_jax(setup):
    _, _, inp, ranks = setup
    got = np.concatenate([r["proc"] for r in ranks])  # (V, 2, H, S, D)
    q, k, v = (torch.as_tensor(cfg_batch(inp[n])) for n in ("q", "k", "v"))
    with torch.no_grad():
        want = make_cross_view_processor(0.6)(q, k, v, False).numpy()
    np.testing.assert_allclose(cfg_batch(got), want, atol=PROC_EXACT)

    from jax import shard_map
    from jax.sharding import PartitionSpec as PSpec

    def body(qs, ks, vs):
        Vl = qs.shape[0]
        loc = [x.transpose(1, 0, 2, 3, 4).reshape(2 * Vl, HEADS, SEQ, DIM) for x in (qs, ks, vs)]
        out = jes.sharded_cross_view_processor(0.6)(*loc, False)
        return out.reshape(2, Vl, HEADS, SEQ, DIM).transpose(1, 0, 2, 3, 4)

    mesh = jes.make_view_mesh(RANKS)
    jout = jax.jit(shard_map(body, mesh=mesh, in_specs=(PSpec("views"),) * 3, out_specs=PSpec("views"),
                             check_vma=False))(*(jnp.asarray(inp[n]) for n in ("q", "k", "v")))
    np.testing.assert_allclose(got, np.asarray(jout), rtol=PROC_RTOL, atol=PROC_ATOL)


def test_sharded_generate_matches_unsharded_and_jax(setup):
    jm, models, inp, ranks = setup
    got = np.concatenate([r["gen"] for r in ranks])  # (V, LAT, LAT, 4)
    t = {n: torch.as_tensor(inp[n]) for n in ("lat", "ctx_c", "ctx_u", "hint")}
    want = SDControlNetPipeline(models).generate(t["lat"], t["ctx_c"], t["ctx_u"], t["hint"], GUIDANCE,
                                                 num_steps=STEPS, processor=make_cross_view_processor(0.6)).numpy()
    np.testing.assert_allclose(got, want, rtol=GEN_RTOL, atol=GEN_ATOL)

    pipe = JPipeline(jm)
    mesh = jes.make_view_mesh(RANKS)
    args = jes.shard_views(mesh, *(jnp.asarray(inp[n]) for n in ("lat", "ctx_c", "ctx_u", "hint")))
    run = jax.jit(jes.make_sharded_generate(mesh, pipe, self_attn_coeff=0.6), static_argnums=(4, 5))
    jout = run(*args, GUIDANCE, STEPS, pipe.params)
    np.testing.assert_allclose(got, np.asarray(jout), rtol=GEN_RTOL, atol=GEN_ATOL)


def test_shard_views_takes_the_ranks_slice():
    x = torch.arange(8 * 3).reshape(8, 3)
    for r in range(4):
        mesh = Mesh(("views",), {"views": 4}, {"views": r}, {"views": None}, torch.device("cpu"))
        (got,) = shard_views(mesh, x)
        assert torch.equal(got, x[2 * r : 2 * r + 2])
    with pytest.raises(ValueError, match="divide"):
        shard_views(mesh, x[:7])

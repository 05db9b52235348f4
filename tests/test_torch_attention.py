"""PyTorch port vs the JAX package: attention and the transformer blocks.

``sdpa_plain`` against the JAX package's ``_sdpa`` (its math path: on the CPU
``_use_flash`` is false), the cross-view ("AttnAlign") processor in the CFG
batch order, and ``Attention``, ``FeedForward``, ``BasicTransformerBlock``
and ``Transformer2D`` with Flax's weights carried by ``diffusion/params.py``.
Inputs come from numpy seeds; everything is float32 on the CPU, with torch
on one thread. Tolerance: relative L2 ≤ 1e-5 (the same float32 math with sums
in another order; measured 9e-8 to 3e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.diffusion import attention as jatt
from gaussctrl_exp_tpu_torch.diffusion import attention as tatt
from gaussctrl_exp_tpu_torch.diffusion.params import state_dict_from_flax
from gaussctrl_exp_tpu_torch.ops import attention_cuda
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import load, rel_l2, to_t

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-5


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B,H,S,T,D", [(2, 3, 50, 50, 40), (2, 8, 64, 77, 40), (3, 2, 33, 77, 16)])
def test_sdpa_plain_matches_jax(B, H, S, T, D):
    q, k, v = _arrays((B, H, S, D), (B, H, T, D), (B, H, T, D), seed=S + T)
    want = np.asarray(jatt._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    before = attention_cuda.launches
    got = tatt._sdpa(to_t(q), to_t(k), to_t(v))
    assert attention_cuda.launches == before  # a CPU tensor never reaches B3
    assert rel_l2(got, want) <= REL


@pytest.mark.parametrize("D", [40, 80, 160])
@pytest.mark.parametrize("cross", [False, True])
def test_sdpa_gradient_matches_jax_vjp(D, cross):
    """The gradient that B4 and B5 compute on the card, here through their
    plain version: autograd through ``sdpa_plain`` against ``jax.vjp`` of the
    JAX package's ``_sdpa`` (its XLA path on the CPU), on the same inputs and
    cotangent, fp32, relative L2 ≤ 1e-5 per gradient."""
    B, H, S = 2, 2, 48
    T = 77 if cross else S
    q, k, v, dout = _arrays((B, H, S, D), (B, H, T, D), (B, H, T, D), (B, H, S, D), seed=D + T)
    _, vjp = jax.vjp(jatt._sdpa, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    leaves = [to_t(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(attention_cuda.sdpa_plain(*leaves), leaves, to_t(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert rel_l2(g, np.asarray(w)) <= REL, name


def test_flash_attn_refuses_cpu_tensors():
    q, k, v = (to_t(a) for a in _arrays((1, 2, 16, 40), (1, 2, 16, 40), (1, 2, 16, 40)))
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.flash_attn(q, k, v)


@pytest.mark.parametrize("views", [5, 6])
@pytest.mark.parametrize("is_cross", [False, True])
def test_cross_view_processor_matches_jax(views, is_cross):
    """Coefficient 0.6, 4 reference views, the batch laid out [uncond; cond]
    × views (unet_chunk_size 2)."""
    B, H, S, D = 2 * views, 2, 24, 16
    T = 77 if is_cross else S
    q, k, v = _arrays((B, H, S, D), (B, H, T, D), (B, H, T, D), seed=views)
    want = np.asarray(jatt.make_cross_view_processor(0.6, 4)(jnp.asarray(q), jnp.asarray(k),
                                                              jnp.asarray(v), is_cross))
    got = tatt.make_cross_view_processor(0.6, 4)(to_t(q), to_t(k), to_t(v), is_cross)
    assert rel_l2(got, want) <= REL
    if not is_cross:  # the references matter: coefficient 1 is plain self-attention
        plain = tatt.default_processor(to_t(q), to_t(k), to_t(v), False)
        assert rel_l2(plain, want) > 1e-2


@pytest.mark.parametrize("views,n_ref", [(5, 4), (9, 4), (7, 1), (3, 3)])
@pytest.mark.parametrize("coeff", [0.6, 0.0, 1.0])
@pytest.mark.parametrize("groups", [1, 2])
def test_align_attn_plain_matches_processor(views, n_ref, coeff, groups):
    """B3a's plain version (one fp32 sum in the kernel's order, each view's
    pass over its own reference keys folded into its self pass) against the
    processor's five-call composition on the CPU, every view of every CFG
    group."""
    B, H, S, D = groups * views, 2, 24, 16
    q, k, v = (to_t(a) for a in _arrays((B, H, S, D), (B, H, S, D), (B, H, S, D), seed=views + n_ref))
    want = tatt.make_cross_view_processor(coeff, n_ref, groups)(q, k, v, False)
    got = attention_cuda.align_attn_plain(q, k, v, coeff, n_ref, groups)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert rel_l2(got, want.numpy()) <= REL
    if coeff == 1.0:  # the reference passes weigh 0: the self pass alone, bit for bit
        assert torch.equal(got, attention_cuda.sdpa_plain(q, k, v))


@pytest.mark.parametrize("groups", [1, 2])
def test_align_duplicate_pass_is_the_self_pass(groups):
    """A reference view's pass over its own keys and values (broadcast over
    its group) is its self pass, bit for bit: B3a leaves it out and gives its
    weight to the self pass."""
    views, n_ref, H, S, D = 6, 4, 2, 40, 16
    B = groups * views
    q, k, v = (to_t(a) for a in _arrays((B, H, S, D), (B, H, S, D), (B, H, S, D), seed=3))
    own = attention_cuda.sdpa_plain(q, k, v)
    kg, vg = k.reshape(groups, views, H, S, D), v.reshape(groups, views, H, S, D)
    for r in range(n_ref):
        k_r = kg[:, r : r + 1].expand(kg.shape).reshape(B, H, S, D)
        v_r = vg[:, r : r + 1].expand(vg.shape).reshape(B, H, S, D)
        ref = attention_cuda.sdpa_plain(q, k_r, v_r)
        idx = [g * views + r for g in range(groups)]
        assert torch.equal(ref[idx], own[idx])
        others = [b for b in range(B) if b not in idx]
        assert not torch.equal(ref[others], own[others])


@pytest.mark.parametrize("case", ["cpu", "groups", "n_ref", "cross"])
def test_flash_attn_align_refuses(case):
    """B3a takes CUDA tensors of a self-attention whose batch is whole CFG
    groups with at most V references; anything else raises before a launch."""
    shapes = dict(q=(10, 2, 16, 40), kv=(10, 2, 16, 40), n_ref=4, groups=2)
    if case == "groups":
        shapes["q"] = shapes["kv"] = (9, 2, 16, 40)
    elif case == "n_ref":
        shapes["n_ref"] = 6  # 5 views a group
    elif case == "cross":
        shapes["kv"] = (10, 2, 77, 40)
    q, k, v = (to_t(a) for a in _arrays(shapes["q"], shapes["kv"], shapes["kv"]))
    launches = attention_cuda.align_launches
    with pytest.raises(ValueError, match="CUDA" if case == "cpu" else "flash_attn_align"):
        attention_cuda.flash_attn_align(q, k, v, 0.6, shapes["n_ref"], shapes["groups"])
    assert attention_cuda.align_launches == launches


def test_cross_view_processor_counts_split_on_the_cpu():
    """On CPU tensors AttnAlign's self-attention is the five-call
    composition, counted ``attn.align.split``; a cross-attention counts
    nothing."""
    from gaussctrl_exp_tpu_torch.utils import trace

    q, k, v = (to_t(a) for a in _arrays((10, 2, 24, 16), (10, 2, 24, 16), (10, 2, 24, 16), seed=8))
    ctx = to_t(_arrays((10, 2, 77, 16), seed=9)[0])
    proc = tatt.make_cross_view_processor(0.6, 4)
    trace.reset(trace.CAPACITY)
    trace.enable()
    try:
        proc(q, k, v, False)
        proc(q, ctx, ctx, True)
        proc(q, k, v, False)
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset(trace.CAPACITY)
    assert counts == {"attn.align.split": 2}


def _flax(module, *args, seed=0, **kw):
    params = module.init(jax.random.PRNGKey(seed), *args, **kw)["params"]
    return params, np.asarray(module.apply({"params": params}, *args, **kw))


@pytest.mark.parametrize("cross", [False, True])
def test_attention_module_matches_jax(cross):
    x, ctx = _arrays((2, 20, 32), (2, 77, 24), seed=3)
    jmod = jatt.Attention(32, heads=2, dim_head=16, cross_attention_dim=24 if cross else None)
    context = jnp.asarray(ctx) if cross else None
    params, want = _flax(jmod, jnp.asarray(x), context)
    tmod = load(tatt.Attention(32, heads=2, dim_head=16, cross_attention_dim=24 if cross else None),
                state_dict_from_flax(params))
    got = tmod(to_t(x), to_t(ctx) if cross else None)
    assert rel_l2(got, want) <= REL


def test_feedforward_uses_tanh_gelu():
    (x,) = _arrays((2, 10, 32), seed=4)
    params, want = _flax(jatt.FeedForward(32), jnp.asarray(x))
    tmod = load(tatt.FeedForward(32), state_dict_from_flax(params))
    assert rel_l2(tmod(to_t(x)), want) <= REL
    # jax.nn.gelu's default is the tanh approximation; the exact GELU differs
    h, gate = tmod.proj(to_t(x)).chunk(2, dim=-1)
    exact = tmod.out(h * torch.nn.functional.gelu(gate))
    assert rel_l2(exact, want) > 1e-5


def test_transformer_block_matches_jax():
    x, ctx = _arrays((4, 24, 32), (4, 77, 32), seed=5)
    proc_j = jatt.make_cross_view_processor(0.6, 1)
    jmod = jatt.BasicTransformerBlock(32, 2, 16, 32)
    params, want = _flax(jmod, jnp.asarray(x), jnp.asarray(ctx), proc_j)
    tmod = load(tatt.BasicTransformerBlock(32, 2, 16, 32), state_dict_from_flax(params))
    got = tmod(to_t(x), to_t(ctx), tatt.make_cross_view_processor(0.6, 1))
    assert rel_l2(got, want) <= REL


def test_transformer2d_matches_jax():
    """NHWC in JAX, NCHW in the port; GroupNorm ε = 1e-6, LayerNorm ε = 1e-6."""
    x, ctx = _arrays((2, 6, 5, 64), (2, 77, 32), seed=6)
    x = x * 3.0 + 1.0  # a mean and a scale for the norms to remove
    params, want = _flax(jatt.Transformer2D(64, 2, 32, cross_attention_dim=32), jnp.asarray(x), jnp.asarray(ctx))
    tmod = load(tatt.Transformer2D(64, 2, 32, cross_attention_dim=32), state_dict_from_flax(params))
    got = tmod(to_t(x).permute(0, 3, 1, 2), to_t(ctx)).permute(0, 2, 3, 1)
    assert rel_l2(got, want) <= REL

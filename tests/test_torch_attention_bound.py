"""The attention kernels' bounds (``utils/timing.attention_bound`` for B3,
``attention_bwd_bound`` for B4 and B5): the arithmetic at the edit path's
and the depth generator's shapes, on the CPU."""

import pytest
import torch

from gaussctrl_exp_tpu_torch.utils.timing import attention_bound, attention_bwd_bound

MAIN = (18, 8, 4096, 4096, 40)  # B3 at 64²: SD1.x self-attention over the CFG batch of 18


def test_main_shape_is_bound_by_the_exponentials():
    """At (18, 8, 4096, 4096, 40) bf16: 4·B·H·S·T·D = 3.866e11 operations at
    989 TFLOP/s are 0.39085 ms; B·H·S·T = 2.416e9 exponentials at 16 per SM
    per clock on 132 SMs at 1.83 GHz are 0.6251 ms, more than the products."""
    b = attention_bound(MAIN, torch.bfloat16, 1.83e9)
    assert b["ops_ms"] == pytest.approx(0.39085, abs=5e-6)
    assert b["exp_ms"] == pytest.approx(0.6251, abs=5e-5)
    assert b["bytes_ms"] == pytest.approx(2 * 18 * 8 * 40 * 4 * 4096 / 3.35e12 * 1e3, rel=1e-12)
    assert b["bound_ms"] == b["ops_ms"] and b["bound_by"] == "operations"
    assert b["exp_ms"] > b["ops_ms"]


def test_exponentials_scale_with_the_clock_and_not_with_d():
    slow = attention_bound(MAIN, torch.bfloat16, 0.915e9)
    assert slow["exp_ms"] == pytest.approx(2 * 0.6251, abs=1e-4)
    wide = attention_bound((18, 8, 4096, 4096, 80), torch.bfloat16, 1.83e9)
    assert wide["exp_ms"] == pytest.approx(0.6251, abs=5e-5) and wide["ops_ms"] == pytest.approx(2 * 0.39085, abs=1e-5)


def test_at_32_squared_the_products_bound_it():
    """(18, 8, 1024, 1024, 80): 0.04886 ms of products against 0.039 ms of
    exponentials at 1.83 GHz."""
    b = attention_bound((18, 8, 1024, 1024, 80), torch.bfloat16, 1.83e9)
    assert b["ops_ms"] == pytest.approx(0.04886, abs=5e-6)
    assert b["exp_ms"] == pytest.approx(0.03907, abs=5e-6)
    assert b["exp_ms"] < b["ops_ms"]


def test_fp32_uses_the_fp32_peak_and_four_bytes():
    b = attention_bound((4, 8, 4096, 4096, 40), torch.float32)
    assert b["clock_hz"] == 1.98e9
    assert b["ops_ms"] == pytest.approx(4 * 4 * 8 * 4096 * 4096 * 40 / 67e12 * 1e3, rel=1e-12)
    assert b["bytes_ms"] == pytest.approx(4 * 4 * 8 * 40 * 4 * 4096 / 3.35e12 * 1e3, rel=1e-12)
    assert b["bound_by"] == "operations"


def test_a_short_cross_attention_can_be_bound_by_bytes():
    b = attention_bound((18, 8, 4096, 1, 40), torch.bfloat16, 1.83e9)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"]


def test_the_products_follow_the_clock_as_the_exponentials_do():
    """At 1980 MHz the tensor cores' peak is 989 TFLOP/s × 1.98 / 1.83, so
    the products take 0.39085 × 1.83 / 1.98 ms; the bytes do not move."""
    rated, fast = attention_bound(MAIN, torch.bfloat16), attention_bound(MAIN, torch.bfloat16, 1.98e9)
    assert rated["clock_hz"] == 1.83e9 and rated == attention_bound(MAIN, torch.bfloat16, 1.83e9)
    assert fast["ops_ms"] == pytest.approx(0.39085 * 1.83 / 1.98, abs=5e-6)
    assert fast["exp_ms"] / rated["exp_ms"] == pytest.approx(fast["ops_ms"] / rated["ops_ms"], rel=1e-12)
    assert fast["bytes_ms"] == rated["bytes_ms"]


def test_device_timing_needs_the_card():
    """With no card the device timings refuse; they never time the CPU in
    the card's place."""
    from gaussctrl_exp_tpu_torch.utils.timing import device_ops_ms, device_window, kernel_time_ms

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        device_ops_ms(lambda: None)
    with pytest.raises(RuntimeError):
        kernel_time_ms(lambda: None, "gctorch_attn_fwd_b3")
    with pytest.raises(RuntimeError):
        device_window(lambda: None)


@pytest.mark.parametrize("first, second, calls, bad", [
    ({"b3": 10}, {"b3": 10}, 10, {}),
    ({"b3": 10, "fill": 20}, {"b3": 10, "fill": 20}, 10, {}),  # an op run twice a call
    ({"b3": 10}, {"b3": 8}, 10, {"b3": (10, 8)}),  # 2 of 10 records dropped
    ({"b3": 8}, {"b3": 8}, 10, {"b3": (8, 8)}),  # the same 2 dropped twice
    ({"b3": 10, "fill": 8}, {"b3": 10, "fill": 8}, 10, {"fill": (8, 8)}),  # twice a call, 8 of 20 kept
    ({"b3": 10}, {"b3": 10, "copy": 1}, 10, {"copy": (0, 1)}),
    ({"b3": 1, "fill": 1}, {"b3": 1}, 1, {"fill": (1, 0)}),
    ({}, {}, 10, {"(no device record)": (0, 0)}),  # both windows lost everything
])
def test_a_window_must_keep_every_record(first, second, calls, bad):
    """Two windows of ``calls`` calls must hold the same records, op by op,
    a whole number per call: a dropped record shows, whatever the op's
    instances per call."""
    from collections import Counter

    from gaussctrl_exp_tpu_torch.utils.timing import record_mismatch

    assert record_mismatch(Counter(first), Counter(second), calls) == bad


# ------------------------------------------- the backward kernels B4 and B5

GEN = (4, 8, 4096, 4096, 40)  # the depth generator's self-attention at 64², fp32


@pytest.mark.parametrize("kernel, fp32, bf16, tf32x3", [
    ("B4", 2.5642, 0.17371, 1.04184),  # 8·B·H·S·T·D = 1.718e11 operations
    ("B5", 1.92312, 0.13028, 0.78138),  # 6·B·H·S·T·D = 1.288e11
])
def test_backward_bounds_at_the_generator_shape(kernel, fp32, bf16, tf32x3):
    """At (4, 8, 4096, 4096, 40): the operations at the fp32 FMA peak (67
    TFLOP/s at 1.98 GHz), at the bf16 tensor-core peak (989 at 1.83 GHz) and
    as 3×TF32 (494.7 / 3 at 1.83 GHz); fp32 is bound by the last."""
    b = attention_bwd_bound(GEN, torch.float32, kernel)
    assert b["fp32_ms"] == pytest.approx(fp32, abs=5e-5)
    assert b["bf16_ms"] == pytest.approx(bf16, abs=5e-6)
    assert b["tf32x3_ms"] == pytest.approx(tf32x3, abs=5e-6)
    assert b["bound_ms"] == b["tf32x3_ms"] and b["bound_by"] == "operations"
    assert attention_bwd_bound(GEN, torch.bfloat16, kernel)["bound_ms"] == pytest.approx(bf16, abs=5e-6)


def test_backward_exponentials_and_bytes():
    """One exponential per score, B·H·S·T = 5.37e8, at 16 per SM per clock
    on 132 SMs at 1.83 GHz: 0.13891 ms for each kernel. B4 reads q, k, v, dO,
    lse and delta and writes dK and dV; B5 writes dQ."""
    for kernel in ("B4", "B5"):
        assert attention_bwd_bound(GEN, torch.float32, kernel)["exp_ms"] == pytest.approx(0.13891, abs=5e-6)
    B, H, S, T, D = GEN
    read = 4 * B * H * D * (2 * S + 2 * T) + 8 * B * H * S
    b4, b5 = (attention_bwd_bound(GEN, torch.float32, k)["bytes_ms"] for k in ("B4", "B5"))
    assert b4 == pytest.approx((read + 4 * B * H * T * D * 2) / 3.35e12 * 1e3, rel=1e-12)
    assert b5 == pytest.approx((read + 4 * B * H * S * D) / 3.35e12 * 1e3, rel=1e-12)
    short = attention_bwd_bound((4, 8, 4096, 1, 40), torch.bfloat16, "B5")
    assert short["bound_by"] == "bytes" and short["bound_ms"] == short["bytes_ms"]


def test_backward_bounds_follow_the_clock():
    """At a clock every rate scales from the clock it is rated at, the
    exponentials with it; the bytes do not move."""
    rated = attention_bwd_bound(GEN, torch.float32, "B4")
    fast = attention_bwd_bound(GEN, torch.float32, "B4", 1.98e9)
    assert rated["clock_hz"] == 1.83e9 and fast["clock_hz"] == 1.98e9
    assert fast["fp32_ms"] == pytest.approx(rated["fp32_ms"], rel=1e-12)  # fp32 is rated at 1.98 GHz
    assert fast["tf32x3_ms"] == pytest.approx(1.04184 * 1.83 / 1.98, abs=5e-6)
    assert fast["bf16_ms"] == pytest.approx(0.17371 * 1.83 / 1.98, abs=5e-6)
    assert fast["exp_ms"] == pytest.approx(0.13891 * 1.83 / 1.98, abs=5e-6)
    assert fast["bytes_ms"] == rated["bytes_ms"]
    slow = attention_bwd_bound(GEN, torch.float32, "B5", 0.99e9)
    assert slow["fp32_ms"] == pytest.approx(2 * 1.92312, abs=1e-4)


def test_backward_bound_names_its_kernel():
    with pytest.raises(ValueError):
        attention_bwd_bound(GEN, torch.float32, "B3")


def test_fp32_forward_is_bound_by_3xtf32():
    """B3 runs its fp32 products as 3×TF32: at (4, 8, 4096, 4096, 40) the
    4·B·H·S·T·D = 8.59e10 operations at a third of 494.7 TFLOP/s (1.83 GHz)
    take 0.52092 ms, its ``bound_ms``; at 1980 MHz 0.52092 × 1.83 / 1.98.
    ``ops_ms`` stays the fp32 FMA figure (67 TFLOP/s at 1.98 GHz)."""
    rated = attention_bound(GEN, torch.float32)
    assert rated["tf32x3_ms"] == pytest.approx(0.52092, abs=5e-6)
    assert rated["ops_ms"] == pytest.approx(1.28208, abs=5e-6)
    assert rated["bound_ms"] == rated["tf32x3_ms"] and rated["bound_by"] == "operations"
    fast = attention_bound(GEN, torch.float32, 1.98e9)
    assert fast["tf32x3_ms"] == pytest.approx(0.52092 * 1.83 / 1.98, abs=5e-6)
    assert fast["bound_ms"] == fast["tf32x3_ms"] and fast["ops_ms"] == rated["ops_ms"]
    short = attention_bound((4, 8, 4096, 1, 40), torch.float32)
    assert short["bound_by"] == "bytes" and short["bound_ms"] == short["bytes_ms"]
    bf16 = attention_bound(MAIN, torch.bfloat16)
    assert bf16["bound_ms"] == bf16["ops_ms"]


def test_bf16_dq_is_held_by_its_exponentials_more_than_its_products():
    """bf16 B5 at (4, 8, 4096, 4096, 40): its 6·B·H·S·T·D = 1.288e11
    operations take 0.13028 ms at 989 TFLOP/s, under the 0.13891 ms its one
    exponential a score takes on the special-function unit (16 per SM per
    clock, 132 SMs, 1.83 GHz). ``bound_ms`` stays the operations (the
    exponentials are reported apart: a polynomial exponential on the FMA
    pipe could go under them); B4's 8 products stay above its exponentials."""
    b5 = attention_bwd_bound(GEN, torch.bfloat16, "B5")
    assert b5["exp_ms"] > b5["bf16_ms"]
    assert b5["exp_ms"] == pytest.approx(0.13891, abs=5e-6) and b5["bf16_ms"] == pytest.approx(0.13028, abs=5e-6)
    assert b5["bound_ms"] == b5["bf16_ms"] and b5["bound_by"] == "operations"
    b4 = attention_bwd_bound(GEN, torch.bfloat16, "B4")
    assert b4["bf16_ms"] > b4["exp_ms"] and b4["bound_ms"] == b4["bf16_ms"]

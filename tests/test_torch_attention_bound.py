"""The attention kernels' bounds (``utils/timing.attention_bound``): the
arithmetic at the edit path's shapes, on the CPU."""

import pytest
import torch

from gaussctrl_exp_tpu_torch.utils.timing import attention_bound

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

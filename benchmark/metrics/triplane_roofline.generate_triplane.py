"""The triplane term's floor (``counts/triplane.py``: per mixing layer the
attention to the features at the bf16 peak, or its bytes at HBM's rate,
the larger) times the window's ``attn.triplane`` spans, over their device
time (%). A program without the span reads None."""


def read(run):
    r = run["state"].get("span_readings", {})
    if not r.get("triplane_s"):
        return None
    return 100.0 * run["counts"]["triplane_layer_floor_s"] * r["triplane_spans"] / r["triplane_s"]

"""The epipolar term's floor over the window (``counts/epipolar.py``: for
each attended pair, a's queries and b's keys and values read once, the
pair's table read and its output written, float32 at HBM's rate) over the
device time of the window's ``attn.epipolar`` spans (%)."""


def read(run):
    s = run["state"].get("span_readings", {}).get("epipolar_s")
    return 100.0 * run["counts"]["epipolar_floor_s"] / s if s else None

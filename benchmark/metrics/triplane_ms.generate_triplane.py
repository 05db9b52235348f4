"""Device time of the triplane cross-view term (the program's spans
``attn.triplane``: the planes pooled and resampled, the queries' attention
to the features and the mix, in every mixing self-attention) per step of the
window (ms). A program without the span reads None."""


def read(run):
    return run["state"].get("span_readings", {}).get("triplane_ms_per_step")

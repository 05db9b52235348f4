"""The whole window's counted operations (the ε calls with the plain
processor, the 7 attentions to the triplane features a step, the decodes)
over its length times the card's bf16 peak (%)."""

from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run)

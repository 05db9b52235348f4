"""The whole window's counted operations over its length times the card's peak (%)."""

from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run)

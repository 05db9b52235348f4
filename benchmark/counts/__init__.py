"""Frozen operation and byte counts, and the card's peaks: the yardstick that
rooflines and ``mfu`` shares are read against. Counted from shapes and from
the benchmark's own reference, never from the program's intermediates."""

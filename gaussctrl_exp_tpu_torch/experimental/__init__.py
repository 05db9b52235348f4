"""Experimental side modules of the port (``noise_mask.py``)."""

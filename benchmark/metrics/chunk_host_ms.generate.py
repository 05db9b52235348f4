"""Host time of a chunk outside its denoising loop and decode: the chunk's
wall on the host clock less the device interval from the loop's start to
the decode's end (CUDA events), mean over the window's chunks (ms)."""

import statistics


def read(run):
    walls, dev = run["spans"].host_s.get("chunk_wall", []), run["spans"].ms("chunk_device")
    n = min(len(walls), len(dev))
    if not n:
        return None
    return statistics.fmean(1e3 * w - d for w, d in zip(walls[:n], dev[:n]))

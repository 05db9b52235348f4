"""Readings that the limits of ``correct`` are set from, one process per cell:

    python3 -m benchmark.controls --workload <name> --seeds 1,2,3 --seconds 5 --controls fp8

For each seed: the cell's set-up, a short window at the cell's own load, the
program's state freed, then the compared numbers of the program against the
float32 reference (the lower readings) and of the reference computed in each
lower precision in the program's place (the controls: the upper readings).
One JSON line per seed. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmark import run as _run  # noqa: F401  (fixes the cache directories first)
from benchmark import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--controls", default="")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(a.workload)
    mod = harness.runner(cell.traffic["runner"])
    controls = [m for m in a.controls.split(",") if m]
    for seed in (int(s) for s in a.seeds.split(",")):
        ctx = dict(cell=cell, seed=seed, device=torch.device("cuda", 0), spans=None)
        with contextlib.redirect_stdout(sys.stderr):
            st = mod.setup(ctx)
            res = mod.window(st, a.seconds)
            mod.release(st)
            torch.cuda.empty_cache()
            got = mod.readings(st, controls)
        print(json.dumps(dict(workload=a.workload, seed=seed, attempted=res["attempted"], **got)), flush=True)
        del st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

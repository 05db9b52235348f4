"""One measured run of one cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets the program up from the seed (weights, scene, inputs) and warms up the
cell's shapes, then runs the cell's unit of work for ``--seconds``. With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` the same window runs with the benchmark's spans, a short
window after it runs under torch.profiler, and the result carries the
cell's per-layer metrics, the device's busy time and a breakdown. Then the
program's state is freed and the plain reference checks what the timed path
produced. The last line of standard output is one JSON object; the compared
numbers and their limits end standard error. Needs as many CUDA devices as
the cell asks for; without them it prints no result and exits with 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(_ROOT / ".bench_cache" / _sub)
# where the program and the benchmark keep what they build
_CACHES = (_ROOT / ".bench_cache", _ROOT / "gaussctrl_exp_tpu_torch" / "_build")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def _process_age_s() -> float:
    """Seconds since this process started (from /proc where there is one)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), time.perf_counter() - _T0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def _start_s() -> float:
    """``time.perf_counter()`` at this process's start."""
    return time.perf_counter() - _process_age_s()


_START = _start_s()


def built_files() -> int:
    """Files in the build and kernel caches: a set-up that adds some compiled."""
    return sum(1 for d in _CACHES if d.is_dir() for p in d.rglob("*") if p.is_file())


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, count: int) -> dict:
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=count,
                memory_peak_bytes=max(torch.cuda.max_memory_allocated(i) for i in range(count)))


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    try:
        cell = harness.find_cell(args.workload)
        mod = harness.runner(cell.traffic["runner"])
    except (harness.CellError, FileNotFoundError, KeyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell.name} needs {chips} CUDA device(s); found {n}", file=sys.stderr)
        return 3
    from benchmark.trace import Spans, profile

    spans = Spans() if args.trace else None
    ctx = dict(cell=cell, seed=args.seed, device=torch.device("cuda", 0), spans=spans)
    # the program's progress lines go to stderr: stdout ends with the result alone
    built = [built_files()]
    with contextlib.redirect_stdout(sys.stderr):
        state = mod.setup(ctx)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - _START
        built.append(built_files())
        res = mod.window(state, args.seconds)
        built.append(built_files())
        prof = counts = None
        if args.trace:
            prof = profile(lambda: mod.profiled(state))
            counts = mod.counts(state, prof)
        torch.cuda.synchronize()
        device = device_info(torch, chips)
        mod.release(state)
        torch.cuda.empty_cache()
        checks = mod.check(state)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: the process holds forbidden modules: {found}", file=sys.stderr)
        return 4

    if args.trace:
        run = dict(spans=spans, window=res, profile=prof, counts=counts, state=state)
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    else:
        values = dict(res["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    correct = harness.judge(checks)
    out = dict(correct=correct, attempted=int(res["attempted"]), failed=int(res["failed"]), metrics=metrics,
               device=device)
    if args.trace:
        out["breakdown"] = dict(device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
    # a set-up that built is a checkout's first run, whose setup_s holds the compile
    out["built_files"] = dict(setup=built[1] - built[0], window=built[2] - built[1])
    print(f"setup_s {setup_s!r}: built {built[1] - built[0]} files in set-up, {built[2] - built[1]} in the window",
          file=sys.stderr)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

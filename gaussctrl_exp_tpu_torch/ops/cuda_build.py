"""Build and load the port's CUDA kernels (B1 to B5 and B1v).

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
plain-C shared library, keyed by a hash of the source, the headers it
includes and its flags, under ``gaussctrl_exp_tpu_torch/_build/``, and
loaded with ``ctypes``. ``build()``
starts one ``nvcc`` per source that has no library yet, all together, and
waits for them; nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "blend_fwd": _PKG / "csrc" / "blend_fwd.cu",
    "blend_bwd": _PKG / "csrc" / "blend_bwd.cu",
    "flash_attn_fwd": _PKG / "csrc" / "flash_attn_fwd.cu",
    "flash_attn_bwd": _PKG / "csrc" / "flash_attn_bwd.cu",
    "blend_variants": _PKG / "csrc" / "blend_variants.cu",
}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# the blend variants (B1v) keep the plain version's roundings by forbidding
# fused multiply-adds in the whole file; B1 and B2 write the roundings that
# must match (sigma, alpha, T) with intrinsics that never fuse
# (csrc/blend_common.cuh) and let the rest fuse. The builds of B1 to B5
# print their registers and spills (ptxas -v) into their logs
PTXAS_VERBOSE = "-Xptxas=-v"
EXTRA_FLAGS = {
    "blend_fwd": [PTXAS_VERBOSE],
    "blend_bwd": [PTXAS_VERBOSE],
    "flash_attn_fwd": [PTXAS_VERBOSE],
    "flash_attn_bwd": [PTXAS_VERBOSE],
    "blend_variants": ["-fmad=false"],
}

logs: dict[str, str] = {}  # nvcc's output for each source built by this process
_libs: dict[str, ctypes.CDLL] = {}


def flags(name: str) -> list[str]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found; the port's kernels are built from source with nvcc")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def included(path: Path) -> list[Path]:
    """``path`` and every file it includes as ``#include "..."`` (relative
    to the including file), followed recursively, each once, in the order
    they are first met."""
    seen: list[Path] = []
    todo = [path.resolve()]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        todo += [(p.parent / m.decode()).resolve() for m in _INCLUDE.findall(p.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    """The library of source ``name``, keyed by the bytes of the source and of
    every header it includes, and by its flags: an edited header gives
    another library."""
    h = hashlib.sha256()
    for p in included(SOURCES[name]):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every kernel source (or those of ``names``) that has no
    library for its hash yet, one ``nvcc`` per source, all started together;
    returns their libraries."""
    names = list(SOURCES) if names is None else list(names)
    jobs = []
    for name in names:
        source, lib = SOURCES[name], library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(f".{os.getpid()}.log"), "w+")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(source)]
        jobs.append((name, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, lib, log))
    failed = []
    for name, proc, tmp, lib, log in jobs:
        rc = proc.wait()
        log.seek(0)
        logs[name] = log.read()
        log.close()
        os.unlink(log.name)
        if rc != 0:
            failed.append(f"nvcc failed ({rc}) for {lib.name}:\n{logs[name]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """The library of kernel ``name`` (built if needed), with its entry
    point ``gctorch_<name>`` typed by ``argtypes`` and returning an int."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, f"gctorch_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]

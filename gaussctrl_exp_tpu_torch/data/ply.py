"""PLY point-cloud reader: the native C++ reader, then a numpy parser.

Port of ``gaussctrl_exp_tpu/data/ply.py``. ``read_ply_points`` tries the
native reader (``native/plyio.cpp``) and hands a file it refuses to the
numpy parser, in the JAX file's order: the numpy parser reads ascii and
binary little/big-endian files with float/uchar vertex properties.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..native import get_plyio

_PLY_DTYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def read_ply_points(path: str | Path) -> tuple[np.ndarray, np.ndarray | None]:
    """Vertex positions (N, 3) float32 and colours (N, 3) uint8 (or None).

    The native reader first; a file it refuses goes to the numpy parser,
    which raises if it cannot read it either."""
    native = read_ply_points_native(path)
    if native is not None:
        return native
    return read_ply_points_numpy(path)


def read_ply_points_native(path: str | Path):
    """The native reader's (xyz, rgb), or None when it refuses the file.

    As in the JAX package, float colours are cast to uint8 as they stand
    (0..1 becomes 0 or 1); the numpy parser scales them by 255."""
    lib = get_plyio()
    h = lib.ply_open(str(path).encode())
    if not h:
        return None
    try:
        n = lib.ply_num_vertices(h)
        xyz = np.empty((n, 3), np.float32)
        rgb = np.empty((n, 3), np.uint8) if lib.ply_has_rgb(h) else None
        rc = lib.ply_read(
            h,
            xyz.ctypes.data_as(ctypes.c_void_p),
            rgb.ctypes.data_as(ctypes.c_void_p) if rgb is not None else None,
        )
        return (xyz, rgb) if rc == 0 else None
    finally:
        lib.ply_close(h)


def read_ply_points_numpy(path: str | Path) -> tuple[np.ndarray, np.ndarray | None]:
    """The numpy parser."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError(f"{path}: list properties not supported in vertex element")
                props.append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        names = [p[0] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex, ndmin=2)
            cols = {name: data[:, i] for i, (name, _) in enumerate(props)}
        else:
            endian = "<" if "little" in (fmt or "") else ">"
            dtype = np.dtype([(name, endian + d) for name, d in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype, count=n_vertex)
            cols = {name: raw[name] for name in names}

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float32)
    rgb = None
    if all(k in cols for k in ("red", "green", "blue")):
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=-1)
        if rgb.dtype != np.uint8:
            # float colors in [0,1] or already 0-255
            rgb = (rgb * 255.0).astype(np.uint8) if rgb.max() <= 1.0 else rgb.astype(np.uint8)
    return xyz, rgb

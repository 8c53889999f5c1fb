"""ctypes bindings for the native mesh runtime (csrc/meshops.cpp).

Builds csrc/libmeshops.so from csrc/meshops.cpp on first use (single g++
translation unit, ~1s; rebuilt when the source is newer); every entry point
has a pure-numpy fallback of identical semantics, so the native library is
an accelerator, not a dependency.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
)
_SRC_PATH = os.path.join(_CSRC, "meshops.cpp")
_LIB_PATH = os.path.join(_CSRC, "libmeshops.so")
_lock = threading.Lock()
_lib = None
_tried = False

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build() -> None:
    """Compile to a name private to this process, then move it into place:
    concurrent processes (parallel test workers) never load a half-written
    library. No -march=native: the checkout may move between hosts."""
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp,
             _SRC_PATH],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("IIFEA_NO_NATIVE"):
            return None
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
            try:
                _build()
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.mesh_build_facets.restype = ctypes.c_void_p
        lib.mesh_build_facets.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int]
        lib.facets_count.restype = ctypes.c_int64
        lib.facets_count.argtypes = [ctypes.c_void_p]
        lib.facets_fill.restype = None
        lib.facets_fill.argtypes = [ctypes.c_void_p, _i32p, _i32p, _i32p]
        lib.facets_free.restype = None
        lib.facets_free.argtypes = [ctypes.c_void_p]
        lib.mesh_number_edges.restype = ctypes.c_int64
        lib.mesh_number_edges.argtypes = [
            _i32p, ctypes.c_int64, ctypes.c_int, _i32p, ctypes.c_int,
            ctypes.c_int32, _i32p,
        ]
        lib.exop_count.restype = ctypes.c_int64
        lib.exop_count.argtypes = [ctypes.c_char_p]
        lib.exop_parse.restype = ctypes.c_int64
        lib.exop_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _i64p, _i64p, _f64p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_facets(cells: np.ndarray, dim: int):
    """Returns (facets, facet_cells, facet_local) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    h = lib.mesh_build_facets(cells, cells.shape[0], dim)
    try:
        n = lib.facets_count(h)
        facets = np.empty((n, dim), np.int32)
        fcells = np.empty((n, 2), np.int32)
        flocal = np.empty((n, 2), np.int32)
        lib.facets_fill(h, facets, fcells, flocal)
        return facets, fcells, flocal
    finally:
        lib.facets_free(h)


def number_edges(cells: np.ndarray, edge_pairs: np.ndarray, n_verts: int):
    """Returns (edge_ids (n_cells, n_edges) offset by n_verts, n_unique)."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    pairs = np.ascontiguousarray(edge_pairs, dtype=np.int32)
    out = np.empty((cells.shape[0], pairs.shape[0]), np.int32)
    n = lib.mesh_number_edges(
        cells, cells.shape[0], cells.shape[1], pairs, pairs.shape[0],
        np.int32(n_verts), out,
    )
    return out, int(n)


def read_exop(path: str):
    """Returns (nnz, 3) float64 triples or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = lib.exop_count(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    fg = np.empty(n, np.int64)
    bg = np.empty(n, np.int64)
    w = np.empty(n, np.float64)
    got = lib.exop_parse(path.encode(), n, fg, bg, w)
    if got != n:
        raise IOError(f"short read parsing {path}: {got}/{n}")
    out = np.empty((n, 3), np.float64)
    out[:, 0] = fg
    out[:, 1] = bg
    out[:, 2] = w
    return out

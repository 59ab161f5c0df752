"""The port's native host library: ``native/graph_native.cpp`` through ctypes.

The library compiles with ``g++ -O3 -march=native -fopenmp -shared -fPIC``
at first use into ``build/native/<key>/libgraph_native.so`` at the
repository root. The key hashes the source, the flags, ``g++ --version`` and
the CPU that ``-march=native`` resolves to, so a changed source, compiler or
host builds anew and an unchanged one loads what is there. The build writes
to a temporary name in the key's directory and moves it into place with
``os.replace``: processes that build at once each load a whole library.

A build or load that fails raises, with the compiler's output. Nothing here
falls back to NumPy: the callers keep their NumPy form of each pass, and a
caller reaches it only by asking for it (``native=False``).

Every function of the source is bound (argument and return types), whether
or not a caller uses it yet; the wrappers below serve the passes the port
runs natively.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "native" / "graph_native.cpp"
BUILD_ROOT = _PACKAGE.parent / "build" / "native"
LIB_NAME = "libgraph_native.so"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_N = ctypes.c_int64
_F = ctypes.c_double

#: ``name -> (restype, argtypes)`` of every ``extern "C"`` function of the source.
SIGNATURES = {
    "rmat_generate": (None, [ctypes.c_int, _N, ctypes.c_uint64, _F, _F, _F, _N, _N,
                             _I64, _I64, _I64]),
    "dedup_edges": (_N, [_N, _N, _I64, _I64, _I64]),
    "dimacs_parse": (_N, [ctypes.c_char_p, _I64, _I64, _I64, _I64, _N]),
    "build_rank_csr": (None, [_N, _N, _I64, _I64, _I64, _I64, _I64, _I64]),
    "first_rank": (None, [_N, _N, _I64, _I64, _I32]),
    "first_rank64": (None, [_N, _N, _I64, _I64, _I64]),
    "first_rank_i32": (None, [_N, _N, _I32, _I32, _I32]),
    "first_rank_i32e64": (None, [_N, _N, _I32, _I32, _I64]),
    "first_cross_rank": (None, [_N, _N, _I32, _I32, _I32, _I32]),
    "rank_endpoints_i32": (None, [_N, _N, _I64, _I64, _I64, _I32, _I32]),
    "rank_endpoints_i32_planes": (None, [_N, _N, _I64, _I64, _I64, _I32, _I32, _U8]),
    "kruskal_msf_solve": (_N, [_N, _N, _I64, _I64, _I64, _I64, _I64, _I64]),
    "kruskal_msf": (None, [_N, _N, _I64, _I64, _I64, _I64, _I64]),
    "rank_order_counting": (ctypes.c_int, [_N, _I64, _N, _N, _I64]),
    "build_csr": (None, [_N, _N, _I64, _I64, _I64, _I64, _I64, _I64]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found: the native host library builds from "
            f"{SOURCE.name} at first use and needs a C++ compiler with OpenMP"
        )
    return found


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout


def cache_key() -> str:
    cxx = _compiler()
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_run([cxx, "--version"]).encode())
    target = _run([cxx, "-march=native", "-Q", "--help=target"])
    h.update("".join(line for line in target.splitlines() if "-march=" in line).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / cache_key() / LIB_NAME


def build_library() -> Path:
    """Compile the library unless this key's build exists; return its path."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=".build-", suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([_compiler(), *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_I64)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_I32)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _check(ok: bool, what: str) -> None:
    """Refuse sizes the C loop would read or write past."""
    if not ok:
        raise ValueError(f"native host library: {what}")


def rmat_edges(
    scale: int, edge_factor: int, *, seed: int, a: float, b: float, c: float,
    weight_low: int, weight_high: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """RMAT samples, each edge seeded on its own (so the graph does not
    depend on the thread count), then canonical ``u < v``, loops dropped and
    parallel edges cut to their minimum weight: ``(u, v, w, n)``."""
    lib = get_lib()
    n = 1 << scale
    m = int(edge_factor) << scale
    u, v, w = (np.empty(m, dtype=np.int64) for _ in range(3))
    lib.rmat_generate(scale, m, seed, a, b, c, weight_low, weight_high,
                      _p64(u), _p64(v), _p64(w))
    kept = int(lib.dedup_edges(m, n, _p64(u), _p64(v), _p64(w)))
    return u[:kept].copy(), v[:kept].copy(), w[:kept].copy(), n


def rank_order_counting(w: np.ndarray) -> Optional[np.ndarray]:
    """Edge ids by ``(weight, edge id)`` from a stable counting sort of
    integer weights; ``None`` when their range exceeds 2^22 values."""
    lib = get_lib()
    w = _i64(w)
    order = np.empty(w.shape[0], dtype=np.int64)
    ok = lib.rank_order_counting(w.shape[0], _p64(w), int(w.min()), int(w.max()), _p64(order))
    return order if ok else None


def rank_endpoints_i32(order: np.ndarray, u: np.ndarray, v: np.ndarray,
                       size_pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(u[order], v[order])`` as int32, zero-padded to ``size_pad``, in
    one parallel pass."""
    lib = get_lib()
    order, u, v = _i64(order), _i64(u), _i64(v)
    _check(u.shape == v.shape and order.shape[0] <= min(u.shape[0], size_pad),
           "rank_endpoints_i32 needs len(u) == len(v) >= len(order) <= size_pad")
    ra = np.empty(size_pad, dtype=np.int32)
    rb = np.empty(size_pad, dtype=np.int32)
    lib.rank_endpoints_i32(order.shape[0], size_pad, _p64(order), _p64(u), _p64(v),
                           _p32(ra), _p32(rb))
    return ra, rb


def first_rank_i32(num_nodes: int, ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """Each vertex's minimum incident rank over the unpadded rank endpoints
    (INT32_MAX for an isolated vertex)."""
    lib = get_lib()
    ra, rb = _i32(ra), _i32(rb)
    _check(ra.shape == rb.shape, "first_rank_i32 needs len(ra) == len(rb)")
    out = np.empty(num_nodes, dtype=np.int32)
    lib.first_rank_i32(num_nodes, ra.shape[0], _p32(ra), _p32(rb), _p32(out))
    return out


def first_cross_rank(num_nodes: int, ra: np.ndarray, rb: np.ndarray,
                     parent1: np.ndarray) -> np.ndarray:
    """Each level-1 fragment's minimum rank among the edges that leave it,
    with the relabel ``parent1[ra]`` fused in (INT32_MAX where none)."""
    lib = get_lib()
    ra, rb, parent1 = _i32(ra), _i32(rb), _i32(parent1)
    _check(ra.shape == rb.shape and parent1.shape == (num_nodes,),
           "first_cross_rank needs len(ra) == len(rb) and len(parent1) == num_nodes")
    out = np.empty(num_nodes, dtype=np.int32)
    lib.first_cross_rank(num_nodes, ra.shape[0], _p32(ra), _p32(rb), _p32(parent1), _p32(out))
    return out

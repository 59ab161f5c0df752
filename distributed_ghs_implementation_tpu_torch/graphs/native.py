"""The port's native host library: ``native/graph_native.cpp`` through ctypes.

The library compiles with ``g++ -O3 -march=native -fopenmp -shared -fPIC``
at first use into ``build/native/<key>/libgraph_native.so`` at the
repository root. The key hashes the source, the flags, ``g++ --version`` and
the CPU that ``-march=native`` resolves to, so a changed source, compiler or
host builds anew and an unchanged one loads what is there. The build writes
to a temporary name in the key's directory and moves it into place with
``os.replace``: processes that build at once each load a whole library.
An entry is loaded only if its manifest vouches for it
(``utils/compile_cache.py``, which can also move the cache out of the
checkout); any other entry is rebuilt.

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
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from distributed_ghs_implementation_tpu_torch.ops._build import KernelBuildError
from distributed_ghs_implementation_tpu_torch.utils import compile_cache

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
    """Compile the library unless a verified build of this key exists;
    return its path."""
    out = library_path()
    if compile_cache.lookup("native", out.parent.name, out):
        return out
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=".build-", suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([_compiler(), *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr}")
        compile_cache.commit("native", out.parent.name, Path(tmp), out,
                             time.perf_counter() - t0)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call; raises
    :class:`KernelBuildError` if it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build_library()))
                for name, (restype, argtypes) in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
            except Exception as e:
                raise KernelBuildError(
                    f"the native host library could not be built or loaded: {e}"
                ) from e
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


def dimacs_parse(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """A DIMACS ``.gr`` file's arcs as they stand (1-indexed ids made
    0-indexed, both directions kept): ``(u, v, w, n)``. Two passes of the C
    parser, one to count the arcs and one to fill arrays of that size."""
    lib = get_lib()
    n_out = np.zeros(1, dtype=np.int64)
    count = int(lib.dimacs_parse(os.fsencode(path), _p64(n_out), None, None, None, 0))
    if count < 0:
        raise FileNotFoundError(path)
    u, v, w = (np.empty(count, dtype=np.int64) for _ in range(3))
    wrote = int(lib.dimacs_parse(os.fsencode(path), _p64(n_out), _p64(u), _p64(v), _p64(w),
                                 count))
    return u[:wrote], v[:wrote], w[:wrote], int(n_out[0])


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


def rank_endpoints_i32_planes(order: np.ndarray, u: np.ndarray, v: np.ndarray,
                              size_pad: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`rank_endpoints_i32` and the 24-bit wire buffer in one pass:
    ``(ra, rb, planes)``, where ``planes[k * size_pad + r]`` is byte ``k`` of
    ``ra[r]`` for ``k < 3`` and byte ``k - 3`` of ``rb[r]`` for ``k >= 3``
    (``models.rank_solver.stage_pair_packed24``). The caller keeps every
    endpoint id below 2^24 (a graph of at most 2^24 vertices): the pass
    keeps three bytes of each."""
    lib = get_lib()
    order, u, v = _i64(order), _i64(u), _i64(v)
    _check(u.shape == v.shape and order.shape[0] <= min(u.shape[0], size_pad),
           "rank_endpoints_i32_planes needs len(u) == len(v) >= len(order) <= size_pad")
    ra = np.empty(size_pad, dtype=np.int32)
    rb = np.empty(size_pad, dtype=np.int32)
    planes = np.empty(6 * size_pad, dtype=np.uint8)
    lib.rank_endpoints_i32_planes(order.shape[0], size_pad, _p64(order), _p64(u), _p64(v),
                                  _p32(ra), _p32(rb), planes.ctypes.data_as(_U8))
    return ra, rb, planes


def _endpoints64(num_nodes: int, ra, rb, what: str) -> Tuple[np.ndarray, np.ndarray]:
    ra, rb = _i64(ra), _i64(rb)
    _check(ra.shape == rb.shape, f"{what} needs len(ra) == len(rb)")
    _check(ra.size == 0 or (0 <= min(ra.min(), rb.min()) and max(ra.max(), rb.max()) < num_nodes),
           f"{what} needs every endpoint in [0, num_nodes)")
    return ra, rb


def first_rank(num_nodes: int, ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """Each vertex's minimum incident rank over int64 rank endpoints, int32
    (INT32_MAX for an isolated vertex): Borůvka's level 1 on the host."""
    lib = get_lib()
    ra, rb = _endpoints64(num_nodes, ra, rb, "first_rank")
    out = np.empty(num_nodes, dtype=np.int32)
    lib.first_rank(num_nodes, ra.shape[0], _p64(ra), _p64(rb), _p32(out))
    return out


def first_rank64(num_nodes: int, ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """:func:`first_rank` with int64 ranks and an INT64_MAX sentinel, for
    rank spaces past 2^31."""
    lib = get_lib()
    ra, rb = _endpoints64(num_nodes, ra, rb, "first_rank64")
    out = np.empty(num_nodes, dtype=np.int64)
    lib.first_rank64(num_nodes, ra.shape[0], _p64(ra), _p64(rb), _p64(out))
    return out


def first_rank_i32(num_nodes: int, ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """Each vertex's minimum incident rank over the unpadded rank endpoints
    (INT32_MAX for an isolated vertex)."""
    lib = get_lib()
    ra, rb = _i32(ra), _i32(rb)
    _check(ra.shape == rb.shape, "first_rank_i32 needs len(ra) == len(rb)")
    out = np.empty(num_nodes, dtype=np.int32)
    lib.first_rank_i32(num_nodes, ra.shape[0], _p32(ra), _p32(rb), _p32(out))
    return out


def first_rank_i32_out64(num_nodes: int, ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """:func:`first_rank_i32` with int64 ranks and an INT64_MAX sentinel for
    an isolated vertex (the sharded ``rank64`` path's rank space)."""
    lib = get_lib()
    ra, rb = _i32(ra), _i32(rb)
    _check(ra.shape == rb.shape, "first_rank_i32_out64 needs len(ra) == len(rb)")
    out = np.empty(num_nodes, dtype=np.int64)
    lib.first_rank_i32e64(num_nodes, ra.shape[0], _p32(ra), _p32(rb), _p64(out))
    return out


def build_rank_csr(num_nodes: int, u: np.ndarray, v: np.ndarray,
                   rank_of_edge: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The directed slots (each edge from both ends) in CSR order, each row
    sorted by rank: ``(indptr[n + 1], adj_dst[2m], adj_rank[2m])``, int64. A
    counting pass and one sort a row, the rows in parallel."""
    lib = get_lib()
    u, v, rank_of_edge = _i64(u), _i64(v), _i64(rank_of_edge)
    m = u.shape[0]
    _check(v.shape == (m,) and rank_of_edge.shape == (m,),
           "build_rank_csr needs len(u) == len(v) == len(rank_of_edge)")
    _check(m == 0 or (0 <= min(u.min(), v.min()) and max(u.max(), v.max()) < num_nodes),
           "build_rank_csr needs every endpoint in [0, num_nodes)")
    indptr = np.empty(num_nodes + 1, dtype=np.int64)
    adj_dst = np.empty(2 * m, dtype=np.int64)
    adj_rank = np.empty(2 * m, dtype=np.int64)
    lib.build_rank_csr(num_nodes, m, _p64(u), _p64(v), _p64(rank_of_edge), _p64(indptr),
                       _p64(adj_dst), _p64(adj_rank))
    return indptr, adj_dst, adj_rank


def build_csr(num_nodes: int, u: np.ndarray, v: np.ndarray,
              w: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The directed slots (each edge from both ends) in CSR order, each row
    in edge order: ``(indptr[n + 1], adj_dst[2m], adj_w[2m])``, int64 (the
    weights must be integers). One counting sort."""
    lib = get_lib()
    u, v, w = _i64(u), _i64(v), _i64(w)
    m = u.shape[0]
    _check(v.shape == (m,) and w.shape == (m,), "build_csr needs len(u) == len(v) == len(w)")
    _check(m == 0 or (0 <= min(u.min(), v.min()) and max(u.max(), v.max()) < num_nodes),
           "build_csr needs every endpoint in [0, num_nodes)")
    indptr = np.empty(num_nodes + 1, dtype=np.int64)
    adj_dst = np.empty(2 * m, dtype=np.int64)
    adj_w = np.empty(2 * m, dtype=np.int64)
    lib.build_csr(num_nodes, m, _p64(u), _p64(v), _p64(w), _p64(indptr), _p64(adj_dst),
                  _p64(adj_w))
    return indptr, adj_dst, adj_w


def kruskal_msf(num_nodes: int, order: np.ndarray, u: np.ndarray, v: np.ndarray,
                w: np.ndarray) -> Tuple[int, int]:
    """Kruskal over the precomputed rank order, weight only:
    ``(total_weight, edge_count)`` of the minimum spanning forest, one
    union-find pass sharing :func:`kruskal_msf_solve_native`'s loop.
    Integer weights. The pass checks the order it is handed, since the
    solver under test ranks by the same order: it raises ``ValueError``
    when ``order`` is not a weight-nondecreasing permutation of the edges."""
    lib = get_lib()
    order, u, v, w = _i64(order), _i64(u), _i64(v), _i64(w)
    _check(u.shape == v.shape == w.shape and order.shape[0] <= u.shape[0],
           "kruskal_msf needs len(u) == len(v) == len(w) >= len(order)")
    _check(min(u.min(initial=0), v.min(initial=0)) >= 0
           and max(u.max(initial=-1), v.max(initial=-1)) < num_nodes,
           "kruskal_msf needs every endpoint in [0, num_nodes)")
    out = np.zeros(2, dtype=np.int64)
    lib.kruskal_msf(num_nodes, order.shape[0], _p64(order), _p64(u), _p64(v), _p64(w),
                    _p64(out))
    if out[1] < 0:
        raise ValueError("rank order is not a non-decreasing permutation of the edges")
    return int(out[0]), int(out[1])


def kruskal_msf_solve_native(num_nodes: int, order: np.ndarray, u: np.ndarray, v: np.ndarray,
                             w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Kruskal over the precomputed rank order, one union-find pass:
    ``(edge_ids, labels)``, the forest's edges in rank order and each
    vertex's component label. Integer weights. Raises ``ValueError`` when
    ``order`` is not a weight-nondecreasing permutation of the edges, as the
    JAX package's wrapper does."""
    lib = get_lib()
    order, u, v, w = _i64(order), _i64(u), _i64(v), _i64(w)
    _check(u.shape == v.shape == w.shape and order.shape[0] <= u.shape[0],
           "kruskal_msf_solve needs len(u) == len(v) == len(w) >= len(order)")
    _check(min(u.min(initial=0), v.min(initial=0)) >= 0
           and max(u.max(initial=-1), v.max(initial=-1)) < num_nodes,
           "kruskal_msf_solve needs every endpoint in [0, num_nodes)")
    out_edges = np.empty(max(num_nodes, 1), dtype=np.int64)
    labels = np.empty(max(num_nodes, 1), dtype=np.int64)
    count = int(lib.kruskal_msf_solve(num_nodes, order.shape[0], _p64(order), _p64(u), _p64(v),
                                      _p64(w), _p64(out_edges), _p64(labels)))
    if count < 0:
        raise ValueError("rank order is not a non-decreasing permutation of the edges")
    return out_edges[:count], labels[:num_nodes]

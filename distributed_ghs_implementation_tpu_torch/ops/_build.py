"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. Each source
compiles in its own ``nvcc`` process, all started together, and one more
``nvcc`` links the objects. The library is cached under ``build/kernels/<key>/``
at the repository root, keyed by a hash of the sources and the flags, so a
change to any source rebuilds it and an unchanged tree loads it as it is.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PACKAGE / "csrc").glob("*.cu")))
BUILD_ROOT = _PACKAGE.parent / "build" / "kernels"
LIB_NAME = "libghs_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (restype is a cudaError_t as int for every launcher)
    "ghs_gather_key": (ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P),
    "ghs_hook_compress": (
        ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P,
    ),
    "ghs_probe": (ctypes.c_int, _P, _P, _P, ctypes.c_longlong, _P),
    "ghs_ell_row_min": (
        ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P,
    ),
    "ghs_gather": (ctypes.c_int, _P, _P, _P, ctypes.c_longlong, _P),
}


DEFAULT_CUDA_HOME = "/usr/local/cuda"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build from csrc/ at first use and "
        "need the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)"
    )


def cache_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / cache_key() / LIB_NAME


def build_library() -> Path:
    """Compile the kernels unless the cached library for these sources
    exists; return its path. The compiler's report (registers, spills) is
    kept beside it in ``build.log``."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, log) for src, p, log in zip(SOURCES, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError(
                "nvcc failed:\n" + "\n".join(f"--- {name}\n{log}" for name, log in failed)
            )
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out.parent / "build.log").write_text("".join(logs) + link.stdout)
        os.replace(tmp_lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry's signature."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.ghs_error_string.argtypes = [ctypes.c_int]
    lib.ghs_error_string.restype = ctypes.c_char_p
    return lib

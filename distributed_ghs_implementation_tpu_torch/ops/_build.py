"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into one
CPython extension module, ``_ghs_kernels``: the ``.cu`` files hold the
kernels and their ``ghs_*`` launchers with a plain C interface, and
``bindings.cpp`` gives each launcher a Python entry point, built against
``Python.h`` alone (no PyTorch header, so the build takes seconds). Each
source compiles in its own ``nvcc`` process, all started together, and one
more ``nvcc`` links the objects. The module is cached under
``build/kernels/<key>/`` at the repository root, keyed by a hash of the
sources, the headers they share, the flags and the interpreter's extension
suffix, so a change to any of them rebuilds it and an unchanged tree loads
it as it is. An entry is loaded only if its manifest vouches for it
(``utils/compile_cache.py``, which can also move the cache out of the
checkout); any other entry is rebuilt. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import time
from pathlib import Path

from distributed_ghs_implementation_tpu_torch.utils import compile_cache

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PACKAGE / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PACKAGE / "csrc").glob("*.cuh")))
BINDING = _PACKAGE / "csrc" / "bindings.cpp"
BUILD_ROOT = _PACKAGE.parent / "build" / "kernels"
MODULE_NAME = "_ghs_kernels"
LIB_NAME = MODULE_NAME + importlib.machinery.EXTENSION_SUFFIXES[0]
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


DEFAULT_CUDA_HOME = "/usr/local/cuda"


class KernelBuildError(RuntimeError):
    """A kernel or native library that could not be built or loaded, for
    whatever cause (no compiler, a compile error, a directory that cannot
    be written, a full disk, a library the loader refuses). The cause is
    chained. A supervised solve treats it as fatal, an ``OSError`` cause
    included: no retry or slower rung can build what did not build."""


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


def _python_include() -> str:
    include = sysconfig.get_paths()["include"]
    if not (Path(include) / "Python.h").is_file():
        raise RuntimeError(
            f"Python.h not found in {include}: the kernels' Python binding "
            "(csrc/bindings.cpp) builds against this interpreter's headers"
        )
    return include


def cache_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + (LIB_NAME,)).encode())
    for src in SOURCES + HEADERS + (BINDING,):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / cache_key() / LIB_NAME


def build_library() -> Path:
    """Compile the kernels unless a verified cached library for these
    sources exists; return its path. The compiler's report (registers,
    spills) is kept beside it in ``build.log``."""
    out = library_path()
    if compile_cache.lookup("kernels", out.parent.name, out):
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    include = _python_include()
    sources = SOURCES + (BINDING,)
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, f"-I{include}", "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, log) for src, p, log in zip(sources, procs, logs) if p.returncode]
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
        compile_cache.commit("kernels", out.parent.name, tmp_lib, out, time.perf_counter() - t0)
    return out


def load_library():
    """Build if needed and import the extension module: one function per
    launcher (``probe``, ``gather``, ...) taking Python ints and returning
    the launch's CUDA error code, and ``error_string(code)``. Any failure
    raises :class:`KernelBuildError`."""
    try:
        spec = importlib.util.spec_from_file_location(MODULE_NAME, build_library())
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    except Exception as e:
        raise KernelBuildError(f"the CUDA kernel library could not be built or loaded: {e}") from e
    return module

"""The port's persistent build cache: restarts reuse the libraries it built.

The port compiles two libraries at first use, each into a directory named
by a key that hashes everything its build reads:

* the CUDA kernels (``nvcc``, ``ops/_build.py``) into ``<root>/kernels/<key>/``;
* the native host library (``g++``, ``graphs/native.py``) into
  ``<root>/native/<key>/``.

The root defaults to ``build/`` at the repository root, so an unchanged
checkout loads what it built before. :func:`enable_persistent_cache` moves
both to one directory that outlives the checkout (the analog of the JAX
package's persistent XLA cache, ``utils/compile_cache.py`` there): the
workers of a host, or a process that restarts, then load in the time of a
file read and a self-check. Call it before the first solve: a library this
process has loaded stays loaded. The default directory honours the JAX
package's names, ``$GHS_COMPILE_CACHE_DIR`` then ``$GHS_TPU_COMPILE_CACHE``,
else ``~/.cache/ghs-torch``.

Every entry carries a manifest written before the library moves into place:
the package, the library's kind, its key and the library's sha256. A load
trusts an entry only if its manifest names this package, kind and key and
the file hashes to it; any other entry (another package's or key's, torn,
bit-rotted) is counted and rebuilt, never loaded. A build that fails still
raises ``KernelBuildError``. On the event bus (``compile.*``):

* ``compile.persistent.hit``: a load found a verified entry;
* ``compile.persistent.miss``: a load had to build;
* ``compile.persistent.corrupt`` / ``compile.persistent.foreign``: an entry
  that failed its check (each also counts a miss, as it is rebuilt);
* histogram ``compile.backend_s``: the seconds of an ``nvcc`` or ``g++``
  build.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Optional

from distributed_ghs_implementation_tpu_torch.obs.events import BUS

MANIFEST = "manifest.json"
MANIFEST_SCHEMA = "ghs-build-cache-v1"
PACKAGE = "distributed_ghs_implementation_tpu_torch"

#: The repository's ``build/``: where both roots sit unless relocated.
DEFAULT_ROOT = Path(__file__).resolve().parent.parent.parent / "build"

_state = {"dir": None}
_lock = threading.Lock()


def default_cache_dir() -> str:
    """Where :func:`enable_persistent_cache` puts the cache by default."""
    return (
        os.environ.get("GHS_COMPILE_CACHE_DIR")
        or os.environ.get("GHS_TPU_COMPILE_CACHE")
        or os.path.join(os.path.expanduser("~"), ".cache", "ghs-torch")
    )


def _set_roots(root: Path) -> None:
    from distributed_ghs_implementation_tpu_torch.graphs import native
    from distributed_ghs_implementation_tpu_torch.ops import _build

    _build.BUILD_ROOT = root / "kernels"
    native.BUILD_ROOT = root / "native"


def enable_persistent_cache(cache_dir: Optional[str] = None) -> str:
    """Build and load both libraries under ``cache_dir`` (default
    :func:`default_cache_dir`); returns the absolute directory. Idempotent;
    a second call with another directory moves the cache there."""
    path = Path(os.path.abspath(cache_dir or default_cache_dir()))
    path.mkdir(parents=True, exist_ok=True)
    with _lock:
        _set_roots(path)
        _state["dir"] = str(path)
    BUS.instant("compile.cache.enabled", cat="compile", dir=str(path))
    return str(path)


def disable_persistent_cache() -> None:
    """Back to the repository's ``build/`` (tests restore global state)."""
    with _lock:
        _set_roots(DEFAULT_ROOT)
        _state["dir"] = None


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _manifest(kind: str, key: str, library: Path, digest: str) -> dict:
    return {
        "schema": MANIFEST_SCHEMA,
        "package": PACKAGE,
        "kind": kind,
        "key": key,
        "library": library.name,
        "sha256": digest,
    }


def _rejection(kind: str, key: str, library: Path) -> Optional[str]:
    """Why the entry at ``library`` must not be loaded (``"corrupt"`` or
    ``"foreign"``), or ``None`` if it may."""
    try:
        with open(library.parent / MANIFEST) as f:
            found = json.load(f)
    except (OSError, ValueError):
        return "corrupt"
    if not isinstance(found, dict) or found.get("schema") != MANIFEST_SCHEMA:
        return "corrupt"
    want = _manifest(kind, key, library, found.get("sha256"))
    if any(found.get(k) != want[k] for k in ("package", "kind", "key", "library")):
        return "foreign"
    try:
        return None if _sha256(library) == found.get("sha256") else "corrupt"
    except OSError:
        return "corrupt"


def lookup(kind: str, key: str, library: Path) -> bool:
    """May the load use the entry at ``library``? Counts the load as a hit,
    or as a miss (plus ``corrupt`` or ``foreign`` for an entry that failed
    its check): the caller then builds."""
    if library.is_file():
        why = _rejection(kind, key, library)
        if why is None:
            BUS.count("compile.persistent.hit")
            return True
        BUS.count(f"compile.persistent.{why}")
        BUS.instant("compile.persistent.rejected", cat="compile", kind=kind,
                    path=str(library), why=why)
    BUS.count("compile.persistent.miss")
    return False


def commit(kind: str, key: str, built: Path, library: Path, seconds: float) -> None:
    """Move a finished build into place: the manifest first (written to a
    temporary name and renamed), then the library, so a reader never trusts
    a library that has no manifest of its own. Records the build's
    ``seconds`` as ``compile.backend_s``."""
    doc = _manifest(kind, key, library, _sha256(built))
    fd, tmp = tempfile.mkstemp(dir=library.parent, prefix=".manifest-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, library.parent / MANIFEST)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    os.replace(built, library)
    BUS.record("compile.backend_s", seconds)


def cache_stats() -> dict:
    """Disk-side view: whether the cache was moved, where, and the entries
    (key directories that hold a manifest) and bytes under both roots."""
    from distributed_ghs_implementation_tpu_torch.graphs import native
    from distributed_ghs_implementation_tpu_torch.ops import _build

    stats = {"enabled": _state["dir"] is not None, "dir": _state["dir"], "entries": 0,
             "bytes": 0}
    for root in (_build.BUILD_ROOT, native.BUILD_ROOT):
        if not root.is_dir():
            continue
        for entry in root.iterdir():
            if not (entry / MANIFEST).is_file():
                continue
            stats["entries"] += 1
            stats["bytes"] += sum(p.stat().st_size for p in entry.iterdir() if p.is_file())
    return stats

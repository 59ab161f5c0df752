"""The ``ghs-tuning-v1`` TuningRecord: persisted measured winners.

The port's counterpart of the JAX package's ``tune/record.py``, with its
schema: bucket keys ``NxMxLANESxMODE``, canonical JSON (sorted keys, fixed
indent, no timestamps) written atomically with an fsync and a ``.sha256``
sidecar (``utils/integrity.py``), and verification on load. What differs is
what an entry installs and what a record is measured on:

* an entry's winner is the device's kernel label (``"cuda"`` or
  ``"torch"``) and a ``config``, a ``kernels.LaunchConfig`` (K1's form,
  K3's tile), where the JAX package stores ``pallas``/``xla`` and a
  ``KernelGeometry``;
* the fingerprint names the card, the NVIDIA software version on it, the
  CUDA version and the torch version (on the CPU: the machine and the
  torch version). A record the JAX package wrote carries its own
  fingerprint, so it is stale here.

Loads land on the event bus as ``tune.record.hit`` / ``miss`` / ``stale``
(a corrupt file is quarantined, ``tune.record.quarantined``, and counts as
stale): a miss or stale record installs nothing, and the solvers keep their
default launches. A malformed file raises :class:`TuningRecordError`.
:func:`install_record` writes each bucket's winning config into the table
in ``ops/kernels.py`` that the bucket's solver reads at each solve.
"""

from __future__ import annotations

import functools
import json
import os
import platform
import re
import subprocess
import tempfile
from typing import Dict, Optional, Tuple

import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.models.boruvka import kernel_label
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import kernels
from distributed_ghs_implementation_tpu_torch.tune import space as space_mod
from distributed_ghs_implementation_tpu_torch.utils import integrity
from distributed_ghs_implementation_tpu_torch.utils.compile_cache import default_cache_dir

RECORD_SCHEMA = "ghs-tuning-v1"

Bucket = Tuple[int, int, int, str]  # (n_pad, m_pad, lanes, mode)


class TuningRecordError(ValueError):
    """A record file that cannot be used (bad schema, bad entry): raised
    only for malformed files; a stale but well-formed record degrades to
    ``None`` (the default launches), never an error."""


def bucket_key_str(bucket: Bucket) -> str:
    n, m, lanes, mode = bucket
    return f"{int(n)}x{int(m)}x{int(lanes)}x{mode}"


def parse_bucket_key(key: str) -> Bucket:
    parts = key.split("x")
    if len(parts) != 4:
        raise TuningRecordError(f"bad tuning bucket key {key!r}; expected NxMxLANESxMODE")
    try:
        n, m, lanes = int(parts[0]), int(parts[1]), int(parts[2])
    except ValueError as ex:
        raise TuningRecordError(f"bad tuning bucket key {key!r}: {ex}") from None
    if n < 1 or m < 1 or lanes < 0:
        raise TuningRecordError(f"bad tuning bucket key {key!r}: sizes must be positive")
    if parts[3] not in space_mod.VALID_MODES:
        raise TuningRecordError(
            f"bad tuning bucket key {key!r}: unknown mode {parts[3]!r} "
            f"(expected one of {space_mod.VALID_MODES})"
        )
    return (n, m, lanes, parts[3])


@functools.lru_cache(maxsize=None)
def _nvidia_version() -> str:
    """The NVIDIA software version on the card, as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def fingerprint(device=None) -> str:
    """The identity a record is keyed by: on the card its name, the NVIDIA
    software version, the CUDA version torch was built with and the torch
    version; on the CPU the machine and the torch version. Safe as a file
    name."""
    device = resolve_device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        parts = ["cuda", torch.cuda.get_device_name(index), "nv", _nvidia_version(),
                 "cuda", str(torch.version.cuda), "torch", torch.__version__]
    else:
        parts = ["cpu", platform.machine(), "torch", torch.__version__]
    return re.sub(r"[^A-Za-z0-9._+-]+", "-", "-".join(parts))


def new_record(entries: Dict[Bucket, dict], *, pinned: bool, device=None) -> dict:
    """A record around measured ``entries`` (bucket -> ``{"kernel",
    "source", "config", ...}``), with what it was measured on embedded for
    the staleness checks."""
    device = resolve_device(device)
    return {
        "schema": RECORD_SCHEMA,
        "fingerprint": fingerprint(device),
        "backend": device.type,
        "torch_version": torch.__version__,
        "pinned": bool(pinned),
        "entries": {bucket_key_str(b): entries[b] for b in sorted(entries)},
    }


def default_record_path(directory: Optional[str] = None, *, device=None) -> str:
    """``<dir>/tuning-<fingerprint>.json``; ``dir`` defaults to
    ``$GHS_TUNE_DIR`` or a ``ghs-tune`` sibling of the build cache's
    directory, as in the JAX package."""
    d = directory or os.environ.get("GHS_TUNE_DIR")
    if not d:
        d = os.path.join(os.path.dirname(default_cache_dir()), "ghs-tune")
    return os.path.join(d, f"tuning-{fingerprint(device)}.json")


def save_record(record: dict, path: str) -> str:
    """Atomically persist a record and its sha256 sidecar; returns
    ``path``. Canonical serialization: a deterministic search gives a
    byte-identical file."""
    if record.get("schema") != RECORD_SCHEMA:
        raise TuningRecordError(f"refusing to save record with schema {record.get('schema')!r}")
    payload = json.dumps(record, indent=2, sort_keys=True) + "\n"
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tuning-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    integrity.write_sidecar(path)
    return path


def _stale(path: str, why: str) -> None:
    BUS.count("tune.record.stale")
    BUS.instant("tune.record.stale_detail", cat="tune", path=path, why=why)


def _check_entry(path: str, key: str, entry, label: str) -> None:
    bucket = parse_bucket_key(key)
    if not isinstance(entry, dict) or entry.get("kernel") != label:
        raise TuningRecordError(f"{path}: entry {key!r} has no {label} winner (got {entry!r})")
    try:
        config = kernels.LaunchConfig.from_json(entry.get("config"))
    except ValueError as ex:
        raise TuningRecordError(f"{path}: entry {key!r}: {ex}") from None
    if not space_mod.candidate_valid(config, *bucket):
        raise TuningRecordError(
            f"{path}: entry {key!r}: config {config.to_json()} is not valid for its bucket"
        )


def load_record(path: str, *, device=None) -> Optional[dict]:
    """Load and verify a record for ``device`` (``None`` = CUDA); ``None``
    on a miss or a stale record, :class:`TuningRecordError` on a malformed
    file.

    Order: existence (``tune.record.miss``), sidecar integrity (a corrupt
    record is quarantined), schema and bucket keys, staleness (fingerprint,
    backend, torch version: ``tune.record.stale``), then each entry's
    winner. Staleness comes before the winners, so another package's or
    machine's well-formed record is stale, not malformed. A fresh record
    counts ``tune.record.hit``.
    """
    device = resolve_device(device)
    if not os.path.exists(path):
        BUS.count("tune.record.miss")
        return None
    try:
        integrity.check_file(path)
    except integrity.IntegrityError as ex:
        integrity.quarantine(
            path, reason=f"tuning record failed integrity: {ex}",
            counter="tune.record.quarantined",
        )
        _stale(path, "integrity")
        return None
    with open(path) as f:
        try:
            record = json.load(f)
        except json.JSONDecodeError as ex:
            raise TuningRecordError(f"{path}: not JSON: {ex}") from None
    if not isinstance(record, dict) or record.get("schema") != RECORD_SCHEMA:
        raise TuningRecordError(
            f"{path}: bad tuning record schema "
            f"{record.get('schema') if isinstance(record, dict) else None!r} "
            f"(expected {RECORD_SCHEMA})"
        )
    entries = record.get("entries")
    if not isinstance(entries, dict):
        raise TuningRecordError(f"{path}: record has no entries mapping")
    for key in entries:
        parse_bucket_key(key)
    for field, want in (("fingerprint", fingerprint(device)), ("backend", device.type),
                        ("torch_version", torch.__version__)):
        if record.get(field) != want:
            _stale(path, field)
            return None
    for key, entry in entries.items():
        _check_entry(path, key, entry, kernel_label(device))
    BUS.count("tune.record.hit")
    return record


def winners(record: dict) -> Dict[Bucket, kernels.LaunchConfig]:
    """``bucket -> LaunchConfig`` of a (validated) record."""
    return {
        parse_bucket_key(key): kernels.LaunchConfig.from_json(entry["config"])
        for key, entry in record.get("entries", {}).items()
    }


def install_record(record: dict, *, path: Optional[str] = None) -> int:
    """Make a loaded record load-bearing: install each bucket's winning
    config into ``kernels``' tuned table, which that bucket's solver reads
    at each solve (lane stacks, the single-card flat solve, the ELL solve).
    Replaces what was installed. Returns the number of installed buckets."""
    mapping = winners(record)
    kernels.set_tuned_configs(
        mapping,
        source={
            "fingerprint": record.get("fingerprint"),
            "path": path,
            "pinned": bool(record.get("pinned")),
        },
    )
    return len(mapping)


def load_and_install(path: str, *, device=None) -> int:
    """:func:`load_record` then :func:`install_record`; returns 0 (and
    installs nothing) on a miss or a stale record."""
    record = load_record(path, device=device)
    if record is None:
        return 0
    return install_record(record, path=path)

"""Checkpoint and resume at chunk boundaries, with crash-consistent saves.

The solver's whole state is three arrays, ``fragment[n]`` (the vertex
partition), ``mst_ranks[m]`` (the forest mask over ranks) and ``level``, so
a checkpoint is one npz and a resume is a Borůvka solve from that partition.
The file format is the JAX package's: the npz keys ``fragment`` (int32),
``mst_ranks`` (bool), ``level`` and ``fingerprint``, the ``.bak``
generation and the ``.sha256`` sidecar. A checkpoint written by either
package resumes in the other.

Every save is a temporary file and a rename, and the previous checkpoint
survives as ``<path>.bak``. Resume goes through
:func:`load_checkpoint_resilient` (the primary, then ``.bak``, then a fresh
solve), so a file torn by a crash mid-write (simulated with the
``checkpoint.save`` fault site of ``utils.resilience.FAULTS``) costs at most
one checkpoint interval. A checkpoint of a *different* graph still refuses
loudly (:class:`CheckpointMismatch`).

The solver hands its hooks live tensors that it goes on updating in place
(on the card or on the CPU), so a save copies them to host memory at the
moment it is made.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device
from distributed_ghs_implementation_tpu_torch.graphs.edgelist import Graph
from distributed_ghs_implementation_tpu_torch.utils.locking import fsync_dir
from distributed_ghs_implementation_tpu_torch.utils.resilience import FAULTS, InjectedFault


class CheckpointMismatch(ValueError):
    """The checkpoint was written for a different graph (fingerprint guard)."""


def graph_fingerprint(graph: Graph) -> np.ndarray:
    """Identity of a graph as int64 words: ``[n, m, sha256/4...]``, from
    :meth:`Graph.digest` (equal to the JAX package's on the same graph);
    ``n`` and ``m`` lead so that a mismatch error stays readable. Guards
    resume against a checkpoint of another graph, whose padded shapes may
    well collide with this one's."""
    return np.concatenate(
        [
            np.asarray([graph.num_nodes, graph.num_edges], dtype=np.int64),
            graph.digest_words(),
        ]
    )


def atomic_write_npz(
    path: str,
    arrays: dict,
    *,
    retain_previous: bool = True,
    fault_site: str = "checkpoint.save",
) -> str:
    """Crash-consistent npz write: temporary file + rename, one ``.bak``
    generation.

    ``retain_previous`` rotates an existing ``path`` to ``path + ".bak"``
    first, so the last good generation survives a write that a crash (or
    the armed ``fault_site``) leaves torn. The temporary file is fsynced
    before the rename and the parent directory after it, so the new entry
    is durable when the call returns.

    Every write records a ``<path>.sha256`` sidecar (``utils/integrity.py``)
    so that loads refuse bit-rotted or torn bytes before deserializing
    them. The OLD sidecar rotates to ``.bak`` (or is unlinked) before the
    data rename and the NEW one lands after it: a crash in between leaves
    the new data file without a sidecar, which loads treat as
    "unverified", never as a mismatch against a stale hash.
    """
    from distributed_ghs_implementation_tpu_torch.utils.integrity import (
        sha256_file,
        sidecar_path,
        write_sidecar,
    )

    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **{k: np.asarray(v) for k, v in arrays.items()})
            f.flush()
            os.fsync(f.fileno())
        digest = sha256_file(tmp)
        if retain_previous and os.path.exists(path):
            import zipfile

            if zipfile.is_zipfile(path):
                os.replace(path, path + ".bak")
                try:
                    os.replace(
                        sidecar_path(path), sidecar_path(path + ".bak")
                    )
                except OSError:
                    # The rotated primary had no sidecar (a crash landed
                    # between its data rename and sidecar write): an older
                    # .bak sidecar now describes bytes that are gone, and
                    # left behind it would quarantine the good .bak.
                    with contextlib.suppress(OSError):
                        os.unlink(sidecar_path(path + ".bak"))
            else:
                # The primary is torn (the save this one follows crashed
                # mid-write): rotating it would clobber the last good
                # generation. Drop it and keep the loadable .bak.
                os.unlink(path)
                with contextlib.suppress(OSError):
                    os.unlink(sidecar_path(path))
        else:
            # A stale sidecar must never outlive the data file it described.
            with contextlib.suppress(OSError):
                os.unlink(sidecar_path(path))
        armed = FAULTS.pop(fault_site)
        if armed is not None:
            if armed.kind == "torn":
                # A crash on a non-atomic filesystem: the destination ends
                # up holding a truncated npz.
                with open(tmp, "rb") as f:
                    blob = f.read()
                with open(path, "wb") as f:
                    f.write(blob[: max(1, len(blob) // 2)])
            raise InjectedFault(f"injected fault at {fault_site} ({armed.kind})")
        os.replace(tmp, path)
        write_sidecar(path, digest)
        fsync_dir(d)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _host_copy(a) -> np.ndarray:
    """``a`` in host memory, copied now if it is a tensor: the solve goes on
    updating its tensors in place after the hook returns."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True).numpy()
    return np.asarray(a)


def save_checkpoint(
    path: str,
    fragment,
    mst_ranks,
    level: int,
    *,
    fingerprint=None,
    retain_previous: bool = True,
) -> str:
    """Atomic npz write of the solver state (see :func:`atomic_write_npz`).
    Tensors are copied to host memory at the call; a tensor mask (the
    port's uint8 0/1) is stored as bool, as the JAX package stores it."""
    mask = _host_copy(mst_ranks)
    if isinstance(mst_ranks, torch.Tensor):
        mask = mask.astype(bool)
    arrays = dict(
        fragment=_host_copy(fragment),
        mst_ranks=mask,
        level=np.asarray(level),
    )
    if fingerprint is not None:
        arrays["fingerprint"] = np.asarray(fingerprint)
    return atomic_write_npz(path, arrays, retain_previous=retain_previous)


def load_checkpoint(
    path: str, *, expect_fingerprint=None
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Load solver state; refuses a checkpoint whose fingerprint mismatches."""
    with np.load(path) as data:
        if expect_fingerprint is not None:
            stored = data.get("fingerprint")
            if stored is None or not np.array_equal(stored, expect_fingerprint):
                raise CheckpointMismatch(
                    f"checkpoint {path} was written for a different graph "
                    f"(fingerprint {None if stored is None else stored.tolist()} "
                    f"!= expected {np.asarray(expect_fingerprint).tolist()})"
                )
        # Materialize before the NpzFile closes (arrays decompress on access).
        return (
            np.asarray(data["fragment"]),
            np.asarray(data["mst_ranks"]),
            int(data["level"]),
        )


def load_checkpoint_resilient(
    path: str, *, expect_fingerprint=None
) -> Tuple[Optional[Tuple[np.ndarray, np.ndarray, int]], Optional[str], List[Tuple[str, str]]]:
    """Load ``path``, falling back to ``path + ".bak"``, then to ``None``.

    Returns ``(state_or_None, source_path_or_None, notes)`` where ``notes``
    records why each skipped candidate was rejected. Corruption (a
    truncated zip, missing keys, IO errors, a checksum mismatch) falls
    through; :class:`CheckpointMismatch` re-raises, because a wrong-graph
    resume is a caller bug, not a recoverable fault.
    """
    from distributed_ghs_implementation_tpu_torch.utils.integrity import (
        IntegrityError,
        check_file,
    )

    notes: List[Tuple[str, str]] = []
    for candidate in (path, path + ".bak"):
        if not os.path.exists(candidate):
            notes.append((candidate, "missing"))
            continue
        try:
            # Checksum first: bit-rotted bytes are rejected before np.load
            # parses them.
            check_file(candidate)
            state = load_checkpoint(candidate, expect_fingerprint=expect_fingerprint)
        except CheckpointMismatch:
            raise
        except IntegrityError as e:
            notes.append((candidate, f"IntegrityError: {e}"))
            continue
        except Exception as e:  # torn/corrupt/unreadable: try the next generation
            notes.append((candidate, f"{type(e).__name__}: {e}"))
            continue
        return state, candidate, notes
    return None, None, notes


def _warn_skipped_generations(state, notes) -> None:
    """Surface a degraded resume: corrupt generations must not be silent."""
    skipped = [(p, why) for p, why in notes if why != "missing"]
    if not skipped:
        return
    import warnings

    trail = "; ".join(f"{p}: {why}" for p, why in skipped)
    tail = "resuming from the previous generation" if state is not None else (
        "no loadable generation — solving from scratch"
    )
    warnings.warn(f"checkpoint recovery: {trail} — {tail}", RuntimeWarning)


def solve_graph_checkpointed(
    graph: Graph,
    checkpoint_path: str,
    *,
    every: int = 1,
    resume: bool = True,
    strategy: str = "auto",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Checkpointing solve on ``device`` (``None`` = CUDA); resumes from
    ``checkpoint_path`` when a loadable checkpoint of this graph is there.
    Same return contract as ``models.boruvka.solve_graph``.

    ``strategy``: ``"stepped"`` saves after every ``every``-th level;
    ``"rank"`` runs the production routing (``make_production_solver``)
    with its chunk hook and saves at every ``every``-th chunk boundary (the
    vertex partition is replayed through any shrink of the fragment space);
    ``"auto"`` takes ``rank`` at ``ELL_AUTO_EDGE_THRESHOLD`` edges and
    above. The final state is always saved. A resume of the rank route goes
    through ``solve_rank_resume``, which is exact from any saved partition.
    """
    device = resolve_device(device)
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        return np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0

    fp = graph_fingerprint(graph)
    initial_state = None
    if resume:
        initial_state, _source, notes = load_checkpoint_resilient(
            checkpoint_path, expect_fingerprint=fp
        )
        _warn_skipped_generations(initial_state, notes)

    from distributed_ghs_implementation_tpu_torch.models import boruvka

    if strategy == "auto":
        strategy = (
            "rank" if graph.num_edges >= boruvka.ELL_AUTO_EDGE_THRESHOLD else "stepped"
        )

    if strategy == "rank":
        from distributed_ghs_implementation_tpu_torch.models.rank_solver import (
            _pick_family,
            make_production_solver,
            prepare_rank_arrays_full,
            solve_rank_resume,
        )

        chunks_seen = [0]

        def on_chunk(level, fragment, mst_ranks, count):
            # `every` counts chunk boundaries here (levels on the stepped
            # path); the final state is saved below either way.
            chunks_seen[0] += 1
            if chunks_seen[0] % every == 0 or count == 0:
                save_checkpoint(
                    checkpoint_path, fragment, mst_ranks, level, fingerprint=fp
                )

        if initial_state is not None:
            vmin0, ra, rb, _parent1 = prepare_rank_arrays_full(graph, device=device)
            mst_ranks, fragment, levels = solve_rank_resume(
                vmin0, ra, rb, initial_state, family=_pick_family(graph),
                on_chunk=on_chunk,
            )
        else:
            mst_ranks, fragment, levels = make_production_solver(graph, device=device)(
                on_chunk=on_chunk
            )
    elif strategy == "stepped":
        args = boruvka.prepare_device_arrays(graph, device=device)

        def on_level(level, fragment, mst_ranks, has, count, dt):
            if level % every == 0 or not has:
                save_checkpoint(
                    checkpoint_path, fragment, mst_ranks, level, fingerprint=fp
                )

        if initial_state is not None:
            initial_state = boruvka.state_from_numpy(*initial_state, device=device)
        mst_ranks, fragment, levels = boruvka.solve_arrays_stepped(
            *args, stepped_levels=None, initial_state=initial_state,
            on_level=on_level,
        )
    else:
        raise ValueError(f"unknown strategy {strategy!r}; expected auto|rank|stepped")
    save_checkpoint(checkpoint_path, fragment, mst_ranks, levels, fingerprint=fp)

    return boruvka.harvest(graph, mst_ranks, fragment, levels)


def solve_graph_checkpointed_sharded(
    graph: Graph,
    checkpoint_path: str,
    *,
    mesh=None,
    every: int = 1,
    resume: bool = True,
    filtered: bool | None = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Checkpointing solve on a mesh (``parallel/rank_sharded.py``;
    ``mesh=None`` is ``parallel.mesh.edge_mesh`` on ``device``, ``None`` =
    CUDA). Same contract as :func:`solve_graph_checkpointed`.

    Saves fire at the sharded solver's chunk boundaries; the whole rank
    mask is gathered (a collective and a host copy) only at the boundaries
    that are saved, a decision taken from the chunk counter, the same in
    every process; only the primary writes. The resume decision and state
    come from the primary (``multihost.broadcast_resume_state``), so a disk
    the processes do not share cannot split them. The file format is the
    single-card solve's and the JAX package's (the vertex partition and the
    whole rank mask), so a checkpoint of either package, sharded or not,
    resumes here and the other way round. The solver's last hook (``count
    == 0``) saves the converged state.
    """
    from distributed_ghs_implementation_tpu_torch.parallel import multihost
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh
    from distributed_ghs_implementation_tpu_torch.parallel.rank_sharded import (
        solve_graph_rank_sharded,
    )

    if mesh is None:
        mesh = edge_mesh(device=device)
    n = graph.num_nodes
    if n == 0 or graph.num_edges == 0:
        return np.zeros(0, dtype=np.int64), np.arange(n, dtype=np.int32), 0

    fp = graph_fingerprint(graph)
    primary = multihost.is_primary()
    initial_state = None
    if resume and primary:
        try:
            # Torn generations fall back (.bak, then fresh) on the primary
            # alone; only a checkpoint of another graph still raises.
            initial_state, _source, notes = load_checkpoint_resilient(
                checkpoint_path, expect_fingerprint=fp
            )
            _warn_skipped_generations(initial_state, notes)
        except Exception:
            # Tell every process to abort before re-raising: a failure on
            # the primary alone would leave the others in the broadcast.
            multihost.broadcast_resume_state(None, error=True)
            raise
    initial_state = multihost.broadcast_resume_state(initial_state)

    chunks_seen = [0]

    def on_chunk(level, fragment, mask_fn, count):
        chunks_seen[0] += 1
        if chunks_seen[0] % every == 0 or count == 0:
            full_mask = mask_fn()  # a collective: every process takes part
            if primary:
                save_checkpoint(checkpoint_path, fragment, full_mask, level, fingerprint=fp)

    return solve_graph_rank_sharded(
        graph, mesh=mesh, filtered=filtered, on_chunk=on_chunk, initial_state=initial_state,
    )

"""The port's mesh: shards within one process, processes over
``torch.distributed``.

The JAX package's mesh is single-controller: one process drives every
local device of a 1-D ``jax.sharding.Mesh`` (``edge_mesh()`` over
``jax.devices()``), and only ``jax.distributed`` spans processes. The port
keeps both layers:

* **Shards within one process.** An :class:`EdgeMesh` holds ``local_shards``
  shards, each with its own device, as JAX holds its local devices. Several
  shards may share one device: all of them on ``cuda:0`` on a one-card
  machine, all of them on the CPU in the tests (the counterpart of JAX's
  8-device CPU dryrun). NCCL refuses two ranks on one card, so one process
  per shard could not put more than one shard on a card.
* **Processes over ``torch.distributed``.** A process group spans the
  processes (``parallel/multihost.py``), as ``jax.distributed`` does: NCCL
  across cards, gloo on the CPU. Every process holds as many shards; the
  global shard index of local shard ``j`` is ``first_shard + j``, so the
  shard blocks of the rank space stay contiguous in process order.

Sharded state is a list with one tensor a local shard. Replicated state
(the n-sized ``fragment``, ``vmin0`` and the level state) is a list with one
tensor a distinct local device (``rep_devices``), not one a shard: JAX runs
the same update on every device, so a level runs it once a device, and K1
launches once a device.

The collectives are the ones the JAX programs use, over those lists:
:meth:`pmin` / :meth:`psum` (sharded parts in, replicated result out), the tiled :meth:`all_gather` (concatenated in global shard
order) and :meth:`axis_index`. The local combine folds the shards of each
device with ``torch.minimum`` (or ``+``) into a fresh
tensor; shards on other devices are brought to the first device by explicit
copies; across processes ``dist.all_reduce`` / ``dist.all_gather`` then
runs over the group.

**Gloo and CUDA tensors.** Gloo's CUDA support is partial in general, but
the collectives the mesh uses (``all_reduce`` with MIN, SUM and MAX,
``all_gather``, ``broadcast``) take CUDA int32 tensors in the torch the
card's machine runs (2.11, probed there with two processes on one card),
so a gloo group gets the CUDA tensors as they are, as an NCCL group does.
The stats of :meth:`EdgeMesh.host_reduce` travel as host tensors under
gloo.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.device import resolve_device

EDGE_AXIS = "edges"

_OPS = {"min": torch.minimum, "sum": torch.add}


def _dist():
    import torch.distributed as dist

    return dist


def _reduce_op(op: str):
    dist = _dist()
    return {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


def _normalize(dev: torch.device) -> torch.device:
    """``cuda`` without an index means the current card; two names of one
    device must compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def default_group():
    """The default process group when ``torch.distributed`` has been
    brought up (``multihost.initialize``), else ``None``."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


class EdgeMesh:
    """A 1-D mesh of edge shards: the local shards' devices and the process
    group the mesh spans (``None`` for one process).

    Attributes:
      devices: the device of each local shard, in shard order.
      local_shards: the number of shards this process holds.
      size: the number of shards in all processes (JAX's mesh size).
      first_shard: the global index of this process's first shard.
      process_index, process_count: this process's rank and the group's
        size (0 and 1 without a group).
      rep_devices: the distinct local devices, in order of first use: each
        holds one copy of the replicated state.
      rep_of_shard: the index into ``rep_devices`` of each local shard.
    """

    def __init__(self, devices: Sequence, *, group=None):
        devices = tuple(_normalize(resolve_device(d)) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices = devices
        self.local_shards = len(devices)
        self.group = group
        if group is None:
            self.process_index, self.process_count, self.backend = 0, 1, None
        else:
            dist = _dist()
            self.process_index = dist.get_rank(group)
            self.process_count = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
        rep: List[torch.device] = []
        for d in devices:
            if d not in rep:
                rep.append(d)
        self.rep_devices = tuple(rep)
        self.rep_of_shard = tuple(rep.index(d) for d in devices)
        self.size = self.local_shards * self.process_count
        self.first_shard = self.process_index * self.local_shards
        if group is not None:
            lo, hi = self.host_reduce([[self.local_shards] * 2], ("min", "max"))
            if lo != hi:
                raise ValueError(
                    f"every process of the group must hold as many shards: {lo} to {hi}")

    def _key(self):
        return (self.devices, self.size, self.first_shard, self.backend)

    def __eq__(self, other) -> bool:
        """Two meshes over the same shard layout are equal, as two JAX
        meshes over the same devices are (the lane's ledger of program
        shapes keys on the mesh)."""
        return isinstance(other, EdgeMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"EdgeMesh(size={self.size}, local={[str(d) for d in self.devices]}, "
                f"process={self.process_index}/{self.process_count})")

    @property
    def kind(self) -> str:
        """``cuda`` or ``cpu``: the device type of the local shards."""
        return self.devices[0].type

    # -- layout ----------------------------------------------------------
    def axis_index(self, j: int) -> int:
        """The global shard index of local shard ``j``
        (``lax.axis_index``)."""
        return self.first_shard + j

    def shard_host(self, a: np.ndarray, dtype=torch.int32) -> List[torch.Tensor]:
        """Block-shard a host array over the mesh: global shard ``k`` owns
        rows ``[k * w, (k + 1) * w)``, ``w = len(a) / size``; each local
        shard gets its own copy on its device."""
        a = np.asarray(a)
        if a.shape[0] % self.size:
            raise ValueError(f"{a.shape[0]} rows do not divide over {self.size} shards")
        w = a.shape[0] // self.size
        return [_to(a[self.axis_index(j) * w:(self.axis_index(j) + 1) * w], dtype, d)
                for j, d in enumerate(self.devices)]

    def replicate_host(self, a: np.ndarray) -> List[torch.Tensor]:
        """One int32 copy of a host array on each distinct local device."""
        return [_to(np.asarray(a), torch.int32, d) for d in self.rep_devices]

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """One copy of ``t`` on each distinct local device (``t`` itself
        where it already lies)."""
        return [t if _normalize(t.device) == d else t.to(d) for d in self.rep_devices]

    def shard_rep(self, rep: List[torch.Tensor], j: int) -> torch.Tensor:
        """Local shard ``j``'s copy of replicated state."""
        return rep[self.rep_of_shard[j]]

    # -- collectives -----------------------------------------------------
    def _combine(self, parts: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
        fold = _OPS[op]
        home = self.rep_devices[0]
        acc = None
        for i, dev in enumerate(self.rep_devices):
            mine = [p for j, p in enumerate(parts) if self.rep_of_shard[j] == i]
            part = mine[0].clone()
            for p in mine[1:]:
                fold(part, p, out=part)
            if acc is None:
                acc = part
            else:
                fold(acc, part.to(home), out=acc)
        if self.group is not None:
            self._all_reduce(acc, op)
        return self.replicate(acc)

    def pmin(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Elementwise minimum over every shard's part (``lax.pmin``)."""
        return self._combine(parts, "min")

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Elementwise sum over every shard's part (``lax.psum``)."""
        return self._combine(parts, "sum")

    def all_gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Tiled ``all_gather``: every shard's part concatenated in global
        shard order, replicated. Every part has the same length."""
        home = self.rep_devices[0]
        local = torch.cat([p.to(home) for p in parts])
        if self.group is not None:
            local = self._all_gather(local)
        return self.replicate(local)

    def host_reduce(self, rows, ops: Sequence[str]) -> List[int]:
        """Per-shard rows of scalars (0-d tensors or ints) reduced column
        by column with ``ops`` (``sum``, ``max``, ``min``) over every shard
        of every process, as host ints: the psum/pmax of a program's stats.
        One host read a shard."""
        vals = [[int(x) for x in _ints(row)] for row in rows]
        out = []
        for c, op in enumerate(ops):
            col = [v[c] for v in vals]
            out.append(sum(col) if op == "sum" else (max(col) if op == "max" else min(col)))
        if self.group is not None:
            for op in dict.fromkeys(ops):  # one order in every process
                idx = [c for c, o in enumerate(ops) if o == op]
                t = torch.tensor([out[c] for c in idx], dtype=torch.int64,
                                 device=self._comm_device())
                _dist().all_reduce(t, _reduce_op(op), group=self.group)
                for c, v in zip(idx, t.tolist()):
                    out[c] = int(v)
        return out

    def _comm_device(self) -> torch.device:
        return self.rep_devices[0] if self.backend == "nccl" else torch.device("cpu")

    def _all_reduce(self, t: torch.Tensor, op: str) -> None:
        _dist().all_reduce(t, _reduce_op(op), group=self.group)

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        out = [torch.empty_like(t) for _ in range(self.process_count)]
        _dist().all_gather(out, t, group=self.group)
        return torch.cat(out)


def _ints(row) -> list:
    tensors = [x for x in row if isinstance(x, torch.Tensor)]
    if not tensors:
        return list(row)
    dev = tensors[0].device
    stacked = torch.stack([x.long().to(dev) if isinstance(x, torch.Tensor)
                           else torch.tensor(int(x), device=dev) for x in row])
    return stacked.tolist()


def _to(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """A copy of a host array on ``device``; to the card from pinned memory
    with ``non_blocking``, so host work after it overlaps the copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype != dtype:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def edge_mesh(devices: Optional[Sequence] = None, num_shards: Optional[int] = None, *,
              device=None, group=None) -> EdgeMesh:
    """A mesh of edge shards (JAX ``parallel.mesh.edge_mesh``).

    With no arguments: one shard per visible CUDA device, as JAX's default
    mesh is over ``jax.devices()``; without CUDA it raises unless
    ``device="cpu"``. ``num_shards`` puts that many shards round-robin over
    the devices (``num_shards=4`` on a one-card machine: four shards on
    ``cuda:0``; ``device="cpu", num_shards=8``: the tests' counterpart of
    JAX's 8-device CPU mesh). ``devices`` names the shards' devices
    outright (``num_shards`` then does not apply). ``device`` may also
    name one card (``"cuda:1"``).

    ``group`` is the process group the mesh spans; by default the default
    group when ``torch.distributed`` is up (``multihost.initialize``). Under
    an NCCL group each process's default devices are its own card only.
    """
    if group is None:
        group = default_group()
    if devices is None:
        dev = _normalize(resolve_device(device))
        if dev.type == "cpu":
            pool = [dev]
        elif (device is not None and torch.device(device).index is not None) or (
                group is not None and str(_dist().get_backend(group)) == "nccl"):
            pool = [dev]
        else:
            pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        count = num_shards if num_shards is not None else len(pool)
        devices = [pool[i % len(pool)] for i in range(count)]
    return EdgeMesh(devices, group=group)

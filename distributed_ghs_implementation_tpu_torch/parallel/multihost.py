"""Several processes: ``torch.distributed`` under the mesh (the JAX
package's ``parallel/multihost.py``).

After :func:`initialize` the default process group spans every process,
and :func:`parallel.mesh.edge_mesh` builds meshes over it: each process
holds its own shards, and the combines run over the group (NCCL when each
process has its own card, gloo otherwise). The same
``solve_graph_sharded`` code runs unchanged. Launch with ``torchrun``
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) or with the
names the JAX package's launcher exports (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def _env_int(*names) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    init_method: Optional[str] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Bring up the default process group (idempotent).

    With no arguments it reads torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE``, or the JAX launcher's
    ``JAX_COORDINATOR_ADDRESS`` (``host:port``), ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``. ``init_method`` overrides the address (for example
    ``file://`` a path, for processes that share a disk). ``backend``
    defaults to NCCL when ``device`` (``None`` = CUDA; ``"cpu"`` for the
    CPU) is a card and there is one card a process, else gloo. Under NCCL
    each process takes card ``LOCAL_RANK`` (default: its rank modulo the
    cards).
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    from distributed_ghs_implementation_tpu_torch.device import resolve_device
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS

    dev = resolve_device(device)
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs the process count and this process's id "
                         "(arguments, torchrun's WORLD_SIZE/RANK or JAX_NUM_PROCESSES/"
                         "JAX_PROCESS_ID)")
    if init_method is None:
        coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
        if coordinator_address is not None:
            init_method = f"tcp://{coordinator_address}"
        elif "MASTER_ADDR" in os.environ:
            init_method = "env://"  # torchrun's store, wherever its agent keeps it
        else:
            raise ValueError("initialize needs a coordinator address or an init_method")
    if backend is None:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        backend = "nccl" if cards >= num_processes else "gloo"
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else process_id % torch.cuda.device_count())
    with BUS.span("parallel.multihost.initialize", cat="parallel") as span:
        dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                                rank=process_id)
        span.set(process_index=dist.get_rank(), process_count=dist.get_world_size(),
                 backend=backend)


def is_primary() -> bool:
    """True in the process that writes artifacts: rank 0, or the only
    process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_resume_state(state, error: bool = False):
    """The primary's checkpoint state to every process (``None`` stays
    ``None``).

    Only the primary saves checkpoints, so on a disk the processes do not
    share only it sees the file; the primary's view decides, so that no
    process diverges in the collectives that follow. ``error=True`` (the
    primary, before re-raising a load failure) broadcasts an abort instead,
    and every other process raises too. One process returns ``state``
    unchanged (``None`` with ``error``).
    """
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None if error else state
    from distributed_ghs_implementation_tpu_torch.obs.events import BUS

    BUS.instant("parallel.multihost.broadcast_resume", cat="parallel", error=error,
                has_state=state is not None)
    primary = dist.get_rank() == 0
    if primary and error:
        payload = ("error",)
    elif primary and state is not None:
        payload = ("state", np.asarray(state[0], dtype=np.int32),
                   np.asarray(state[1], dtype=bool), int(state[2]))
    else:
        payload = ("none",)
    box = [payload if primary else None]
    dist.broadcast_object_list(box, src=0)
    payload = box[0]
    if payload[0] == "error":
        if primary:
            return None  # the primary re-raises the original load error
        raise RuntimeError("checkpoint load failed on the primary process; aborting")
    if payload[0] == "none":
        return None
    return payload[1], payload[2], payload[3]

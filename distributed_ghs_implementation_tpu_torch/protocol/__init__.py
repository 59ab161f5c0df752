"""The GHS message protocol, as one state machine with pluggable transport.

This is the message-level view of the algorithm the reference implements twice
— once per backend (``ghs_implementation.py:118-413`` for
threads, ``ghs_implementation_mpi.py:117-757`` for MPI), a duplication
SURVEY.md §2 flags as the design smell to fix. Here the protocol lives in
:class:`~distributed_ghs_implementation_tpu_torch.protocol.node.GHSNode` once, and
transports deliver messages. The bundled
:class:`~distributed_ghs_implementation_tpu_torch.protocol.transport.SimTransport`
is a deterministic discrete-event queue: unlike the reference's thread/MPI
runtimes, identical runs deliver identical message orders, so protocol
behavior is testable and the liveness heuristics the reference needs (requeue
caps, idle termination, stuck-root retries — its source of wrong MSTs) do not
exist.

The batched Borůvka kernel (``models/boruvka.py``) is the production path;
this backend exists for protocol parity, testing, and teaching.

A copy of the JAX package's ``protocol/``: pure Python over NumPy, with the
port's own event bus (``obs.events.BUS``) and ``Graph``. It runs no kernel
and touches no device; ``api.minimum_spanning_forest(backend="protocol")``
still applies the device rule to it, as it does to ``"host"``.
"""

from distributed_ghs_implementation_tpu_torch.protocol.faults import (
    FaultSpec,
    FaultyTransport,
    ReliableTransport,
)
from distributed_ghs_implementation_tpu_torch.protocol.messages import (
    EdgeState,
    Message,
    MessageType,
    NodeState,
)
from distributed_ghs_implementation_tpu_torch.protocol.node import GHSNode
from distributed_ghs_implementation_tpu_torch.protocol.runner import (
    run_protocol,
    solve_graph_protocol,
)
from distributed_ghs_implementation_tpu_torch.protocol.transport import SimTransport

__all__ = [
    "EdgeState",
    "FaultSpec",
    "FaultyTransport",
    "GHSNode",
    "Message",
    "MessageType",
    "NodeState",
    "ReliableTransport",
    "SimTransport",
    "run_protocol",
    "solve_graph_protocol",
]

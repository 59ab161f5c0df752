"""The port's horizontal serving fleet: digest-routed worker processes with
failover, on the port's ``MSTService``.

Port of the JAX package's ``fleet/``: N worker processes
(``fleet/worker.py``), each a full ``serve.service.MSTService`` on its own
device, behind a consistent-hash router (``fleet/router.py``) with
health-checked failover, re-queue of accepted requests, restart with
backoff, admission control and graceful drain. Workers speak
length-prefixed frames and B-frames (``fleet/framing.py``) over subprocess
pipes or TCP sockets (``fleet/transport.py``: coalesced pipelined writes,
dial-in hello registration, ``--listen`` workers a router dials, the chaos
layer), with a durable accepted-work journal (``fleet/journal.py``) and an
obs-driven autoscaler (``fleet/autoscaler.py``). The wire format, the hello
and the journal records are the JAX package's, so a router of either
package drives a worker of the other.

Spawned workers run on CUDA unless ``FleetConfig(device="cpu")``; a worker
that cannot have its device exits before its hello and the router's
``start()`` raises. The router itself touches no device.
"""

from distributed_ghs_implementation_tpu_torch.fleet.autoscaler import (
    Autoscaler,
    ElasticPolicy,
)
from distributed_ghs_implementation_tpu_torch.fleet.hashing import HashRing
from distributed_ghs_implementation_tpu_torch.fleet.journal import (
    RouterJournal,
)
from distributed_ghs_implementation_tpu_torch.fleet.router import (
    FleetConfig,
    FleetRouter,
)
from distributed_ghs_implementation_tpu_torch.fleet.transport import (
    PROTO_VERSION,
    ChaosState,
    ChaosTransport,
    HelloError,
    PipeTransport,
    SocketTransport,
    Transport,
    build_hello,
    check_hello,
)

__all__ = [
    "Autoscaler",
    "ElasticPolicy",
    "FleetConfig",
    "FleetRouter",
    "HashRing",
    "RouterJournal",
    "PROTO_VERSION",
    "ChaosState",
    "ChaosTransport",
    "HelloError",
    "PipeTransport",
    "SocketTransport",
    "Transport",
    "build_hello",
    "check_hello",
]

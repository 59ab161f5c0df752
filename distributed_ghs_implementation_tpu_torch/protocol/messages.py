"""Protocol vocabulary: message kinds, node states, edge states.

Mirrors the reference's enums (``ghs_implementation.py:17-43``;
MPI variant adds TERMINATE at ``ghs_implementation_mpi.py:14-22``, which a
deterministic simulator does not need — quiescence is detectable exactly).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class MessageType(enum.Enum):
    CONNECT = "connect"
    INITIATE = "initiate"
    TEST = "test"
    ACCEPT = "accept"
    REJECT = "reject"
    REPORT = "report"
    CHANGE_ROOT = "change_root"


class NodeState(enum.Enum):
    """``SLEEPING/FIND/FOUND`` per the protocol (``ghs_implementation.py:33-37``)."""

    SLEEPING = "sleeping"
    FIND = "find"
    FOUND = "found"


class EdgeState(enum.Enum):
    """``BASIC/BRANCH/REJECTED`` per the protocol (``ghs_implementation.py:27-31``)."""

    BASIC = "basic"
    BRANCH = "branch"
    REJECTED = "rejected"


@dataclasses.dataclass(frozen=True)
class Message:
    """A protocol message on the wire.

    ``level``/``fragment``/``weight`` cover every payload the seven message
    kinds need (the reference ships ad-hoc dicts,
    ``ghs_implementation_mpi.py:99``). ``fragment`` and ``weight`` carry edge
    *ranks* (see ``protocol/node.py`` on why ranks, not raw weights).
    """

    type: MessageType
    sender: int
    level: int = 0
    fragment: int = 0
    weight: Optional[int] = None  # None encodes "infinity" in REPORT

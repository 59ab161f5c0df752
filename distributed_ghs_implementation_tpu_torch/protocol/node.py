"""The GHS node state machine — the protocol, implemented once.

Faithful to the classic Gallager–Humblet–Spira algorithm, which is what the
reference's two hand-rolled variants approximate
(``ghs_implementation.py:118-413``,
``ghs_implementation_mpi.py:117-757``). Differences that make this variant
exact and deterministic where the reference is neither:

* **Edges are identified by rank, not raw weight.** GHS requires distinct
  edge weights; the reference uses raw ``randint(1, 10)`` weights where ties
  break that assumption (one source of its wrong MSTs). Here every edge
  carries its global rank in the sort by ``(weight, edge id)`` — the same
  total order the batched kernel uses — so fragments are named by core-edge
  rank exactly as in the original paper.
* **Deferral is a transport concern.** Handlers return ``False`` when the
  protocol says "process this later" (CONNECT onto a BASIC edge at equal
  level, TEST from a higher level, REPORT racing the local find); the
  transport requeues. No requeue caps, no forced merges
  (contrast ``ghs_implementation.py:88-100,176-185``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from distributed_ghs_implementation_tpu_torch.protocol.messages import (
    EdgeState,
    Message,
    MessageType,
    NodeState,
)

INF = None  # REPORT weight for "no outgoing edge found"


def _lt(a: Optional[int], b: Optional[int]) -> bool:
    """Rank comparison where None is +infinity."""
    if a is None:
        return False
    if b is None:
        return True
    return a < b


@dataclasses.dataclass
class _Edge:
    neighbor: int
    rank: int  # global (weight, edge id) rank — the protocol's "weight"
    state: EdgeState = EdgeState.BASIC


class GHSNode:
    """One vertex's protocol endpoint.

    ``send(dest, message)`` is injected by the transport; ``on_halt`` fires
    when this node's fragment root detects completion (best weight = inf).
    """

    def __init__(
        self,
        node_id: int,
        neighbors: Dict[int, int],  # neighbor id -> edge rank
        send: Callable[[int, Message], None],
        on_halt: Callable[[int], None] = lambda _nid: None,
    ):
        self.id = node_id
        self.edges: Dict[int, _Edge] = {
            nbr: _Edge(neighbor=nbr, rank=rank) for nbr, rank in neighbors.items()
        }
        self._send = send
        self._on_halt = on_halt

        self.state = NodeState.SLEEPING
        self.level = 0
        self.fragment = 0  # rank of the fragment's core edge
        self.find_count = 0
        self.best_edge: Optional[int] = None  # neighbor id toward best MOE
        self.best_weight: Optional[int] = INF
        self.test_edge: Optional[int] = None
        self.in_branch: Optional[int] = None  # neighbor id toward fragment root
        self.halted = False
        self.messages_processed = 0

    # ------------------------------------------------------------------
    def branch_neighbors(self) -> List[int]:
        return [e.neighbor for e in self.edges.values() if e.state == EdgeState.BRANCH]

    def wakeup(self) -> None:
        """Spontaneous start (``ghs_implementation.py:118-137``): the minimum
        adjacent edge becomes BRANCH and CONNECT(0) crosses it."""
        if self.state != NodeState.SLEEPING:
            return
        if not self.edges:
            # Isolated vertex: a one-node fragment is already complete.
            self.state = NodeState.FOUND
            self.halted = True
            self._on_halt(self.id)
            return
        m = min(self.edges.values(), key=lambda e: e.rank)
        m.state = EdgeState.BRANCH
        self.level = 0
        self.state = NodeState.FOUND
        self.find_count = 0
        self._send(m.neighbor, Message(MessageType.CONNECT, self.id, level=0))

    # ------------------------------------------------------------------
    def handle(self, msg: Message) -> bool:
        """Process one message; returns False if it must be requeued."""
        if self.state == NodeState.SLEEPING:
            self.wakeup()
        handler = {
            MessageType.CONNECT: self._on_connect,
            MessageType.INITIATE: self._on_initiate,
            MessageType.TEST: self._on_test,
            MessageType.ACCEPT: self._on_accept,
            MessageType.REJECT: self._on_reject,
            MessageType.REPORT: self._on_report,
            MessageType.CHANGE_ROOT: self._on_change_root,
        }[msg.type]
        ok = handler(msg)
        if ok:
            self.messages_processed += 1
        return ok

    # ------------------------------------------------------------------
    def _on_connect(self, msg: Message) -> bool:
        """Absorb (lower level) or merge (equal level over the core edge) —
        ``ghs_implementation.py:155-199``, minus its forced-merge fallbacks."""
        edge = self.edges[msg.sender]
        if msg.level < self.level:
            # Absorb the lower-level fragment at our level.
            edge.state = EdgeState.BRANCH
            self._send(
                msg.sender,
                Message(
                    MessageType.INITIATE,
                    self.id,
                    level=self.level,
                    fragment=self.fragment,
                    weight=0 if self.state == NodeState.FIND else 1,
                ),
            )
            if self.state == NodeState.FIND:
                self.find_count += 1
            return True
        if edge.state == EdgeState.BASIC:
            return False  # equal level but our CONNECT hasn't crossed yet: defer
        # Merge: both fragments chose this edge; its rank names the new fragment.
        self._send(
            msg.sender,
            Message(
                MessageType.INITIATE,
                self.id,
                level=self.level + 1,
                fragment=edge.rank,
                weight=0,  # new root search starts in FIND
            ),
        )
        return True

    def _on_initiate(self, msg: Message) -> bool:
        """Adopt (level, fragment, state), broadcast down branches, start the
        MOE search — ``ghs_implementation.py:201-233``."""
        self.level = msg.level
        self.fragment = msg.fragment
        self.state = NodeState.FIND if msg.weight == 0 else NodeState.FOUND
        self.in_branch = msg.sender
        self.best_edge = None
        self.best_weight = INF
        self.test_edge = None
        for e in self.edges.values():
            if e.neighbor != msg.sender and e.state == EdgeState.BRANCH:
                self._send(
                    e.neighbor,
                    Message(
                        MessageType.INITIATE,
                        self.id,
                        level=msg.level,
                        fragment=msg.fragment,
                        weight=msg.weight,
                    ),
                )
                if self.state == NodeState.FIND:
                    self.find_count += 1
        if self.state == NodeState.FIND:
            self._test()
        return True

    def _test(self) -> None:
        """Probe the minimum BASIC edge — ``ghs_implementation.py:235-254``."""
        basic = [e for e in self.edges.values() if e.state == EdgeState.BASIC]
        if basic:
            e = min(basic, key=lambda e: e.rank)
            self.test_edge = e.neighbor
            self._send(
                e.neighbor,
                Message(
                    MessageType.TEST, self.id, level=self.level, fragment=self.fragment
                ),
            )
        else:
            self.test_edge = None
            self._report()

    def _on_test(self, msg: Message) -> bool:
        """ACCEPT (different fragment) / REJECT (same) —
        ``ghs_implementation.py:256-281``."""
        if msg.level > self.level:
            return False  # their level is ahead of ours: defer
        if msg.fragment != self.fragment:
            self._send(msg.sender, Message(MessageType.ACCEPT, self.id))
            return True
        edge = self.edges[msg.sender]
        if edge.state == EdgeState.BASIC:
            edge.state = EdgeState.REJECTED
        if self.test_edge != msg.sender:
            self._send(msg.sender, Message(MessageType.REJECT, self.id))
        else:
            self._test()  # we were testing the same edge: move on, no REJECT needed
        return True

    def _on_accept(self, msg: Message) -> bool:
        edge = self.edges[msg.sender]
        self.test_edge = None
        if _lt(edge.rank, self.best_weight):
            self.best_edge = msg.sender
            self.best_weight = edge.rank
        self._report()
        return True

    def _on_reject(self, msg: Message) -> bool:
        edge = self.edges[msg.sender]
        if edge.state == EdgeState.BASIC:
            edge.state = EdgeState.REJECTED
        self._test()
        return True

    def _report(self) -> None:
        """Convergecast the best weight up ``in_branch`` once all children
        reported and the local probe finished — ``ghs_implementation.py:303-320``."""
        if self.find_count == 0 and self.test_edge is None:
            self.state = NodeState.FOUND
            self._send(
                self.in_branch,
                Message(MessageType.REPORT, self.id, weight=self.best_weight),
            )

    def _on_report(self, msg: Message) -> bool:
        if msg.sender != self.in_branch:
            # A child's report.
            self.find_count -= 1
            if _lt(msg.weight, self.best_weight):
                self.best_weight = msg.weight
                self.best_edge = msg.sender
            self._report()
            return True
        # Report from the other core half (we are one of the two roots).
        if self.state == NodeState.FIND:
            return False  # our own find is still running: defer
        if _lt(self.best_weight, msg.weight):
            # Our half holds the better edge: the root moves to our side.
            self._change_root()
            return True
        if msg.weight is None and self.best_weight is None:
            # Both halves found nothing: the fragment spans its component.
            self.halted = True
            self._on_halt(self.id)
            return True
        return True

    def _change_root(self) -> None:
        """Walk toward the MOE; at its endpoint, CONNECT across —
        ``ghs_implementation.py:355-387``."""
        edge = self.edges[self.best_edge]
        if edge.state == EdgeState.BRANCH:
            self._send(self.best_edge, Message(MessageType.CHANGE_ROOT, self.id))
        else:
            self._send(
                self.best_edge, Message(MessageType.CONNECT, self.id, level=self.level)
            )
            edge.state = EdgeState.BRANCH

    def _on_change_root(self, msg: Message) -> bool:
        self._change_root()
        return True

"""High-rate graph mutation: windowed batched maintenance, a durable
update log with snapshot+replay recovery, and MST-change subscription
sessions. Port of the JAX package's ``stream/``, on one explicit device
(``device=None`` means CUDA).

Three pillars, one per module:

* :mod:`stream.window` — coalesce an update window (last-write-wins per
  edge) and apply the whole window in two batched passes built on the
  solver's own ``fragment_moe`` / ``hook_and_compress`` primitives (K2 and
  K1 on the card), instead of ``serve/dynamic.py``'s
  one-exchange-rule-per-update walk.
* :mod:`stream.log` — persist every committed window through the
  checkpoint layer (snapshot every K windows + JSONL delta log with
  torn-tail skip and ``.bak`` generation fallback), so a restarted process
  replays to the current digest without a single fresh solve. Snapshots
  carry the port's ``package`` field: neither package recovers the
  other's stream.
* :mod:`stream.session` — long-lived subscribed graphs: a digest-chained
  stream per seed graph, MST-change notifications (edges entered/left the
  forest, weight delta) per committed window, pull-based ``poll`` with
  gapless/duplicate-free sequence numbers that survive a restart via log
  replay.
"""

from distributed_ghs_implementation_tpu_torch.stream.log import UpdateLog
from distributed_ghs_implementation_tpu_torch.stream.session import (
    StreamManager,
    StreamSession,
)
from distributed_ghs_implementation_tpu_torch.stream.window import (
    WindowedMST,
    coalesce,
    random_update_stream,
)

__all__ = [
    "UpdateLog",
    "StreamManager",
    "StreamSession",
    "WindowedMST",
    "coalesce",
    "random_update_stream",
]

"""Offline launch-config tuner: measured per-bucket launch configs.

The port's counterpart of the JAX package's ``tune/``. The hand kernels have
launch parameters that do not change a solve's result: K1's form (block,
grid, or picked by size) and K3's tile. Their defaults came from sweeps on
one card; this package replaces the guess with a measurement per solver
bucket:

* :mod:`tune.space`: the valid candidates of a bucket (the device's kernel
  label and a ``kernels.LaunchConfig``), with hard validity guards;
* :mod:`tune.measure`: the seeded search: parity against the default
  config before any time counts, CUDA-event medians, failed candidates
  scored dead; on the CPU (and with ``dry=True``) the default config is
  pinned, so those records are byte-reproducible;
* :mod:`tune.record`: the persisted ``ghs-tuning-v1`` record, its
  integrity sidecar, its staleness checks (card, NVIDIA software, CUDA,
  torch).

Installing a record (``record.install_record``, or a warmup plan's
``tuning``) writes each bucket's winner into the table in
``ops/kernels.py`` that the bucket's solver reads.
"""

from distributed_ghs_implementation_tpu_torch.tune.measure import search
from distributed_ghs_implementation_tpu_torch.tune.record import (
    RECORD_SCHEMA,
    default_record_path,
    install_record,
    load_and_install,
    load_record,
    save_record,
)
from distributed_ghs_implementation_tpu_torch.tune.space import (
    Candidate,
    enumerate_candidates,
    raw_space_size,
)

__all__ = [
    "Candidate",
    "RECORD_SCHEMA",
    "default_record_path",
    "enumerate_candidates",
    "install_record",
    "load_and_install",
    "load_record",
    "raw_space_size",
    "save_record",
    "search",
]

"""One process of the port's multi-process test (``test_torch_multihost.py``).

Usage: python torch_multihost_child.py <init_file> <num_processes> <process_id> <outdir>

Brings up a gloo group over a file store through ``parallel.multihost``
(``WORLD_SIZE`` and ``RANK`` as torchrun exports them), builds a mesh of 2
CPU shards in this process (``2 * num_processes`` in all), solves the
dryrun fixtures through every strategy a group takes, a checkpointed
sharded solve and its resume, and the primary's broadcasts, and writes what
it saw to ``<outdir>/proc<id>.json``. Imports neither JAX nor the JAX
package.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def _out(result):
    ids, frag, levels = result
    return [ids.tolist(), frag.tolist(), int(levels)]


def main() -> int:
    init_file, num_processes, process_id, outdir = sys.argv[1:5]
    os.environ["WORLD_SIZE"] = num_processes
    os.environ["RANK"] = process_id

    import numpy as np
    import torch.distributed as dist

    from distributed_ghs_implementation_tpu_torch.graphs import edgelist, generators
    from distributed_ghs_implementation_tpu_torch.parallel import multihost
    from distributed_ghs_implementation_tpu_torch.parallel.mesh import edge_mesh
    from distributed_ghs_implementation_tpu_torch.parallel.rank_sharded import (
        solve_graph_rank_sharded,
    )
    from distributed_ghs_implementation_tpu_torch.parallel.sharded import solve_graph_sharded
    from distributed_ghs_implementation_tpu_torch.utils import checkpoint
    from torch_inputs import DECK

    multihost.initialize(init_method=f"file://{init_file}", device="cpu")
    multihost.initialize()  # a second call changes nothing
    mesh = edge_mesh(num_shards=2, device="cpu")
    record = {
        "process_index": mesh.process_index, "process_count": mesh.process_count,
        "size": mesh.size, "first_shard": mesh.first_shard, "backend": mesh.backend,
        "is_primary": multihost.is_primary(), "solves": {},
    }
    for name in ("er48", "rmat12"):
        g = DECK[name](generators)
        out = record["solves"][name] = {}
        for strategy in ("ell", "rank", "auto"):
            out[strategy] = _out(solve_graph_sharded(g, mesh=mesh, strategy=strategy))
        out["filtered"] = _out(solve_graph_rank_sharded(g, mesh=mesh, filtered=True))
        out["rank64"] = _out(solve_graph_rank_sharded(g, mesh=mesh, rank64=True))
        try:
            solve_graph_sharded(g, mesh=mesh, strategy="flat")
            out["flat_refused"] = False
        except ValueError:
            out["flat_refused"] = True
        path = os.path.join(outdir, f"ckpt-{name}.npz")
        out["ckpt"] = _out(checkpoint.solve_graph_checkpointed_sharded(g, path, mesh=mesh))
        out["ckpt_resume"] = _out(checkpoint.solve_graph_checkpointed_sharded(g, path, mesh=mesh))
    state = (np.arange(5, dtype=np.int32), np.array([True, False, True]), 7)
    got = multihost.broadcast_resume_state(state if multihost.is_primary() else None)
    record["broadcast"] = [got[0].tolist(), got[1].tolist(), got[2]]
    record["broadcast_none"] = multihost.broadcast_resume_state(None) is None
    if multihost.is_primary():
        record["abort"] = multihost.broadcast_resume_state(None, error=True) is None
    else:
        try:
            multihost.broadcast_resume_state(None)
            record["abort"] = False
        except RuntimeError:
            record["abort"] = True
    empty = edgelist.Graph.from_edges(4, [])
    record["empty"] = _out(solve_graph_sharded(empty, mesh=mesh, strategy="rank"))
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(outdir, f"proc{process_id}.json"), "w") as f:
        json.dump(record, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

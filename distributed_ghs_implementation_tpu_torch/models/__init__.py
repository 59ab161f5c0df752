"""MST solvers: ``boruvka`` (the flat, stepped and ELL solves and
``solve_graph``) and ``rank_solver`` (the rank-space solver of large
graphs), as in the JAX package's ``models/``."""

from distributed_ghs_implementation_tpu_torch.models.boruvka import (
    BoruvkaState,
    boruvka_level,
    boruvka_solve,
    solve_graph,
)

__all__ = ["BoruvkaState", "boruvka_level", "boruvka_solve", "solve_graph"]

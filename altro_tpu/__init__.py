"""altro_tpu: batched constrained trajectory optimization in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the ALTRO
("Augmented Lagrangian TRajectory Optimizer") C++ reference solver:
augmented-Lagrangian iLQR with a TVLQR Riccati backward pass, closed-loop
forward rollout with a strong-Wolfe cubic line search on an analytically
differentiated merit function, and conic constraint handling
(equality / inequality / second-order cone) via projected-dual
augmented-Lagrangian penalties.

Design is accelerator-first:
  * struct-of-arrays pytrees over the knot-point axis (vmap, not loops)
  * `lax.scan` Riccati recursion and rollouts (parallel-scan variant in
    `altro_tpu.tvlqr`)
  * bounded `lax.while_loop` line search / solver loop with per-lane status
  * whole solves are pure jittable functions of a solver-state pytree, so
    thousands of MPC scenarios batch with `vmap` and shard over a device
    mesh with `shard_map`.
"""

from altro_tpu.cones import (
    Cone,
    cone_is_linear,
    dual_cone,
    project,
    project_hessian,
    project_jacobian,
)
from altro_tpu.tvlqr import TVLQRGains, tvlqr_backward, tvlqr_forward
from altro_tpu.problem import (
    ConstraintSpec,
    Cost,
    DiagonalCost,
    GenericCost,
    Problem,
    QuadraticCost,
    lqr_cost_from_reference,
)
from altro_tpu.options import SolverOptions, Verbosity
from altro_tpu.status import AltroError, ErrorCode, LineSearchCode, SolveStatus
from altro_tpu.solver import (
    SolveStats,
    SolverState,
    init_state,
    merit_function,
    open_loop_rollout,
    solve,
    total_cost,
)
from altro_tpu.api import ALL_INDICES, ALTROSolver, LAST_INDEX
from altro_tpu.diff import implicit_solve
from altro_tpu.implicit import implicit_dynamics, implicit_midpoint_residual
from altro_tpu.checkpoint import load_state, save_state
from altro_tpu.rescue import (
    rescue_options,
    solve_tiled_with_rescue,
    vmap_solve_with_rescue,
)
from altro_tpu.export import (
    call_exported,
    export_mpc_server,
    load_exported,
    save_exported,
)
from altro_tpu import al, checkpoint, export, io, linesearch, models, mpc, ops, parallel, profiling

__version__ = "0.1.0"

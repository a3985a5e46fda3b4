"""Solver options.

Frozen dataclass mirroring the reference `AltroOptions`
(/root/reference/src/altro/solver/solver_options.hpp:16-39), extended with
the knobs the batched redesign needs (adaptive Quu regularization schedule —
the reference's unused `reg` hook at solver.cpp:363 made real — and the
parallel-scan Riccati switch).

All fields are Python scalars treated as jit-time constants: re-jitting on
an options change is intended (options define the program, state defines
the data).
"""

from __future__ import annotations

import dataclasses
import enum


class Verbosity(enum.IntEnum):
    SILENT = 0
    OUTER = 1
    INNER = 2
    LINE_SEARCH = 3


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    # Outer/inner fused loop (reference defaults, solver_options.hpp:16-39)
    iterations_max: int = 200
    # tol_cost / tol_cost_intermediate are declared but never used by
    # the reference (solver_options.hpp:20-21 have no read sites); here
    # the intended cost-decrease stopping criterion is real, gated by
    # enable_cost_tolerance (off by default to preserve the reference's
    # exact iteration-count behavior): stop with SUCCESS when the merit
    # decrease of an accepted step falls below tol_cost while primal
    # feasibility is within tolerance.
    tol_cost: float = 1e-4
    tol_cost_intermediate: float = 1e-4
    enable_cost_tolerance: bool = False
    tol_primal_feasibility: float = 1e-4
    tol_stationarity: float = 1e-4
    # Relative stationarity criterion (no reference analog; off by
    # default so iteration-count oracles are bit-exact). When > 0 the
    # stationarity test becomes
    #   stat < max(tol_stationarity, tol_stationarity_rel * scale),
    # scale = max(|lx|, |lu|, |y|)_inf at the candidate — the standard
    # relative-KKT form. Motivation: the max-norm KKT residual
    # lx + A'y⁺ - y cancels quantities of magnitude `scale`, so in f32
    # it has a roundoff floor ~ eps_f32 * scale * O(sqrt(N)); an absolute
    # tolerance below that floor makes well-solved large-scale lanes
    # (e.g. the quadrotor, scale ~ 20) report MAX_ITERATIONS forever.
    tol_stationarity_rel: float = 0.0
    tol_meritfun_gradient: float = 1e-8
    max_solve_time: float = float("inf")

    # Divergence guards: the reference DECLARES max_state_value /
    # max_input_value (solver_options.hpp:28-29) but never reads them
    # (they are even left uninitialized), and SolveStatus declares
    # MaxObjectiveExceeded / StateOutOfBounds / InputOutOfBounds
    # (typedefs.hpp:22-24) that nothing assigns. Here the intent is
    # real: when finite, a candidate trajectory whose state / input
    # max-abs exceeds the bound stops that lane with
    # STATE_OUT_OF_BOUNDS / INPUT_OUT_OF_BOUNDS, and an accepted merit
    # value above max_objective_value (or non-finite) stops it as
    # MAX_OBJECTIVE_EXCEEDED. Defaults inf = statically compiled out.
    max_state_value: float = float("inf")
    max_input_value: float = float("inf")
    max_objective_value: float = float("inf")

    # Augmented Lagrangian penalty schedule
    penalty_initial: float = 1.0
    penalty_scaling: float = 10.0
    penalty_max: float = 1e8
    # Warm-start the penalty from the carried SolverState.rho instead of
    # resetting to penalty_initial every solve (the reference resets,
    # solver.cpp:425-430, which forces each warm-started MPC resolve to
    # re-escalate rho through dual-update rounds whenever a constraint is
    # active — the source of the multi-iteration tail in receding-horizon
    # loops). Carried rho is decayed by penalty_warm_start_decay each
    # resolve so it can relax when constraints go inactive, and clipped to
    # [penalty_initial, penalty_max].
    penalty_warm_start: bool = False
    penalty_warm_start_decay: float = 1.0

    # Line search (reference linesearch.hpp:40-47, 55-56)
    use_backtracking_linesearch: bool = False
    ls_max_iters: int = 25
    ls_alpha_max: float = 2.0
    ls_beta_increase: float = 1.5
    ls_beta_decrease: float = 0.5
    ls_min_interval_size: float = 1e-6
    ls_try_cubic_first: bool = True
    ls_c1: float = 1e-4  # Armijo sufficient-decrease
    ls_c2: float = 0.9  # strong-Wolfe curvature
    # Line-search failure RECOVERY: instead of aborting the solve when no
    # trial step passes (the reference's behavior, solver.cpp:264-268 —
    # which it never exercises: its f64 merit comparisons don't hit the
    # roundoff non-descent our f32 warm-started lanes do at stiff ticks,
    # docs/PERF.md), keep iterating with the alpha = 0 payload and a
    # geometrically escalated regularization for the next backward pass
    # (the classic iLQR forward-pass-failure response). A lane that never
    # recovers within iterations_max still reports LINE_SEARCH_FAILED;
    # one that recovers and converges reports SUCCESS. Off by default to
    # preserve reference abort semantics; the bench enables it.
    ls_failure_recovery: bool = False
    # Max line-search failures tolerated per solve under recovery before
    # the lane stops as LINE_SEARCH_FAILED. Bounds the extra while_loop
    # trips a grinding lane imposes on its whole vmapped/tiled batch
    # (measured: unlimited recovery cost -23% batch throughput for
    # +0.4% success on the headline workload; docs/PERF.md round 4).
    ls_recovery_max_fails: int = 2
    # Widened final-step acceptance: when NO grid trial passes Armijo
    # but the best trial still DECREASED the merit value, take that
    # trial's trajectory instead of freezing at alpha = 0 — the failing
    # lane keeps making progress, so recovery iterations actually move
    # toward convergence instead of only reshaping the merit landscape.
    # The iteration still counts as a line-search failure (status,
    # recovery cap, reg escalation). Grid searches only; off by default.
    ls_best_decrease_fallback: bool = False
    # Evaluate the whole backtracking trial grid {1, b, b^2, ...} in ONE
    # batched merit evaluation and select the first passing step, instead
    # of sequential trials (requires use_backtracking_linesearch). Under
    # vmap a sequential line search makes every lane pay the straggler
    # lane's trial count in sequential merit rollouts; the parallel grid
    # bounds the sequential depth at one rollout. Same accepted step as
    # the sequential mode with ls_try_cubic_first=False.
    parallel_linesearch: bool = False
    ls_parallel_width: int = 8
    # Phase-split the parallel line search: grid trials run a
    # rollout-only merit evaluation (dynamics + AL cost, no per-step
    # Jacobian/gradient work), and the expansion payload (A, B, lx, lu,
    # dphi) is reconstructed only at the accepted step as a knot-parallel
    # vmap plus a linear-sensitivity scan. Same accepted steps; pays the
    # expansion work once instead of ls_parallel_width times, and off the
    # sequential chain — the win grows with dynamics/Jacobian cost
    # (requires parallel_linesearch).
    ls_phase_split: bool = False
    # Armijo-only acceptance for the phase-split parallel line search:
    # drop the strong-Wolfe curvature test on the first trial (and with it
    # the exact-dphi payload completion). The accepted step's directional
    # derivative is what the curvature test — and nothing else on the
    # solve path — consumes: the next iteration's dphi(0) comes from the
    # backward pass's expected-decrease identity, so skipping it removes
    # the two remaining sequential sensitivity scans per solver iteration
    # (the trial-0 completion and the accepted-step completion; see
    # docs/PERF.md). SolveStats.dphi reports NaN in this mode. Armijo-only
    # backtracking is the standard globalization for AL-iLQR; the
    # difference from the default is only that a full step satisfying
    # Armijo but not curvature is accepted instead of shortened. Requires
    # ls_phase_split (or rti_mode, where it skips the payload's dphi
    # reconstruction outright).
    ls_armijo_only: bool = False
    # Relative Armijo slack: accept phi <= phi0 + c1*a*dphi0 + slack*|phi0|.
    # At f32, merit differences near convergence sit at the roundoff level
    # of phi0, so the exact Armijo test rejects every step and the resolve
    # ends LINE_SEARCH_FAILED; a slack of a few f32 ULPs (~1e-6) accepts
    # those numerically-converged steps (Hager & Zhang's approximate
    # Wolfe conditions address the same failure mode). 0 = exact
    # (reference parity).
    ls_armijo_slack: float = 0.0

    # Adaptive Quu regularization (new: reference hardwires reg = 0 and
    # aborts the whole solve on Cholesky failure, solver.cpp:363,373-377)
    reg_initial: float = 0.0
    reg_min: float = 1e-8
    reg_scaling: float = 10.0
    reg_max_retries: int = 12

    # Execution strategy (options define the algorithm; the platform,
    # not an option, chooses kernels — tile_solver.select_kernels)
    parallel_riccati: bool = False  # lax.associative_scan backward pass
    # Two-level span cap for parallel_riccati: 0 = pure associative
    # suffix scan (O(log N) depth; f64-recommended at long horizons),
    # L > 0 = parallel within chunks of L knots + a serial composition
    # across the N/L chunk-condensed elements (depth N/L + log2 L).
    # Capping the span keeps every (I + C J)^-1 composition
    # well-conditioned, which is what makes the parallel backward
    # f32-usable at long horizons (accuracy ladder:
    # tests/test_parallel_riccati.py; docs/PERF.md round 4).
    parallel_riccati_chunk: int = 0
    # Grid line-search trials carry only (phi, state trajectory); the
    # accepted trial's payload (u, y, convals, zproj) is rebuilt
    # knot-parallel after selection instead of being materialized for
    # every trial (width x fewer stacked outputs; identical values).
    # Requires ls_phase_split.
    ls_grid_x_only: bool = True
    # Diagonal expansion fast path (the reference's is_diag,
    # tvlqr.cpp:85-89,125-128, extended to the AL Hessian): when the cost
    # is diagonal and every constraint declares diag_hessian
    # (al.diag_expansion_eligible), store the AL Hessian as [.., n]
    # diagonals instead of dense [.., n, n] stacks — never materializing
    # the dense Hessians — and run the diagonal Riccati step. DEFAULT ON
    # (round 3); applies on the default scan path and the tile-resident
    # path. The parallel Riccati keeps dense operands (its ABI is dense)
    # and silently ignores this flag. Ineligible problems are
    # unaffected.
    diag_expansion: bool = True
    # Exact (full-Newton) AL Hessians via autodiff through the AL cost,
    # instead of the Gauss-Newton form the reference hardwires
    # (knotpoint_data.cpp:549-570): includes the constraint-curvature
    # term sum_e lambda_e * nabla^2 c_e that GN drops (verified against
    # finite differences to 8e-11, tests/test_al_formulas.py). Measured
    # on the nonconvex-obstacle MPC workload: WORSE than GN (72.2% vs
    # 86.2% resolve success, +60% iterations — with positive
    # multipliers on a concave constraint the curvature term
    # de-conditions Quu, the classic regime where Gauss-Newton beats
    # full Newton away from the solution; docs/PERF.md round 5). Kept
    # as an option for convex-curvature constraints where GN
    # underestimates; can be indefinite — pair with the adaptive Quu
    # regularization retry. Dense-path solves only (disables the
    # diagonal fast path); no reference analog. Off by default
    # (GN = reference parity AND the measured-better choice here).
    exact_al_hessian: bool = False
    throw_errors: bool = True  # host API raises on failed solve
    # Re-symmetrize the Riccati cost-to-go each step: recommended for
    # long horizons (N >~ 100) in f32, where roundoff asymmetry compounds
    # into line-search failures; the per-step transposes cost backward
    # throughput at small n, hence opt-in. Only alters the XLA scan: the
    # tiled GPU kernel computes P via the Cholesky-identity form
    # P = Qxx - Qux'K - reg*K'K, symmetric by construction, so it
    # accepts and ignores this flag.
    symmetrize_ctg: bool = False

    # Real-time iteration mode (beyond the reference): run EXACTLY
    # iterations_max iterations with a full step (alpha = 1), skipping the
    # line search — the standard real-time MPC scheme for warm-started
    # resolves where each tick gets one (or a few) Newton-like iterations.
    # Use with iterations_max=1 for classic RTI.
    rti_mode: bool = False

    # Host callback fired after every solver iteration with
    # (iteration, phi, stationarity, feasibility, alpha, rho) — the
    # reference's declared-but-unimplemented SetCallback
    # (altro_solver.hpp:404). Runs via jax.debug.callback (async, may
    # reorder across lanes; for monitoring, not control flow).
    iteration_callback: object = None

    verbose: Verbosity = Verbosity.SILENT

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)

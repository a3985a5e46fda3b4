"""Benchmark: batched warm-started Scotty-MPC resolves (solves/s per card).

The BASELINE.json north-star workload: a fleet of receding-horizon
bicycle MPC controllers tracking the Scotty path (horizon N=30,
steering-angle bounds, warm-started resolves with sliding references) —
the exact loop of the reference's TrackingMPC test
(/root/reference/test/bicycle_test.cpp:266-360), but with B scenario
lanes per card and the whole closed-loop simulation fused into a single
jitted lax.scan over ticks.

Runs as ONE process on the first visible GPU and prints one JSON line:
  {"metric": ..., "value": ..., "unit": "solves/s", "vs_baseline": ...,
   "platform": "gpu", "device_kind": ..., "gpu": "<name>, <power limit>",
   ...}

With no GPU it exits non-zero, unless the CPU is asked for explicitly
(ALTRO_BENCH_PLATFORM=cpu; a CPU number is never a device number).
The run enforces hard accuracy gates (tracking error, success rate,
mean iterations), so a fast-but-wrong configuration exits non-zero
instead of printing a happy number.

vs_baseline is against the single-threaded C++ reference estimate in
BASELINE.md (1000 warm-started resolves/s; the reference cannot be built
in this image — see BASELINE.md for the derivation).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

BASELINE_SOLVES_PER_S = 1000.0  # single-threaded C++ reference estimate (BASELINE.md)

# Hard accuracy gates: the bench FAILS (exit code 3) when the measured
# run violates these, so a fast-but-wrong config cannot produce a green
# JSON. Values chosen against a known-good f32 run (closed-loop error
# 0.4855, success 98.78%, mean iterations 1.44) and the reference
# artifact (/root/reference/test/scotty_mpc.json: error 0.485).
GATE_MAX_TRACKING_ERR = 0.5
# The default two-tier-rescue headline must convert >= 99.5% of
# resolves; with the rescue disabled (ALTRO_BENCH_RESCUE=0) the
# no-rescue gate applies.
GATE_MIN_SUCCESS = 0.995  # full-solver mode with the default lane rescue
GATE_MIN_SUCCESS_NO_RESCUE = 0.985
GATE_MAX_MEAN_ITERS = 2.0

EXIT_NO_DEVICE = 2  # no GPU and the CPU was not asked for
EXIT_GATE_FAILURE = 3  # accuracy gates failed


def gpu_info():
    """`name, power.limit` of the first card as nvidia-smi reports it, or
    None where there is no nvidia-smi (the CPU)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def device_report():
    """What every result is labelled with: the device as JAX reports it,
    the JAX version, XLA flags, matmul precision and the card."""
    import jax

    d = jax.devices()
    return {
        "platform": d[0].platform,
        "device_kind": d[0].device_kind,
        "device_count": len(d),
        "jax_version": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "matmul_precision": str(jax.config.jax_default_matmul_precision),
        "gpu": gpu_info(),
    }


def headline_problem(N=30):
    """The Scotty bicycle tracking problem and its reference path."""
    import jax.numpy as jnp
    import numpy as np

    from altro_tpu.cones import Cone
    from altro_tpu.io.scotty import load_scotty, synthetic_scotty
    from altro_tpu.models.bicycle import bicycle_continuous
    from altro_tpu.models.integrators import midpoint
    from altro_tpu.models.tile_steps import bicycle_cols, midpoint_cols
    from altro_tpu.problem import ConstraintSpec, Problem, lqr_cost_from_reference

    dtype = jnp.float32
    n, m = 4, 2
    try:
        ref = load_scotty()
    except FileNotFoundError:
        ref = synthetic_scotty(N=500)
    h = float(np.float32(ref.tf / ref.N))
    Qd = np.full(n, 1e-2)
    Rd = np.full(m, 1e-3)
    cost0 = lqr_cost_from_reference(
        jnp.asarray(np.tile(Qd, (N + 1, 1)), dtype),
        jnp.asarray(np.tile(Rd, (N + 1, 1)), dtype),
        jnp.asarray(ref.x[: N + 1], dtype),
        jnp.asarray(ref.u[: N + 1], dtype),
    )
    delta_max = 60 * np.pi / 180.0
    steering = ConstraintSpec(
        fn=lambda x, u, k: jnp.stack([x[3] - delta_max, -delta_max - x[3]]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
        label="steering bound", diag_hessian=True,  # rows are +-e3
        affine=True,
    )
    problem = Problem(
        N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()),
        dynamics_jac=None, constraints=(steering,), cost=cost0,
        h=jnp.full(N, h, dtype), x0=jnp.asarray(ref.x[0], dtype),
        # column-form step: lets solve_tiled run the line-search trial
        # grid as one GPU kernel (ops/pallas_rollout_tiled.py)
        dynamics_cols=midpoint_cols(bicycle_cols()),
    )
    return problem, ref, h, Qd, Rd


def headline_options():
    """(opts, opts_rescue or None, rti) from the ALTRO_BENCH_* knobs."""
    from altro_tpu.options import SolverOptions

    env = os.environ.get
    rti = env("ALTRO_BENCH_RTI") == "1"
    par_ls = env("ALTRO_BENCH_PAR_LS", "1") == "1"
    phase_split = par_ls and env("ALTRO_BENCH_PHASE_SPLIT", "1") == "1"
    opts = SolverOptions(
        iterations_max=1 if rti else int(env("ALTRO_BENCH_ITERS", "10")),
        use_backtracking_linesearch=True,
        tol_stationarity=1e-3,
        tol_primal_feasibility=1e-3,
        throw_errors=False,
        rti_mode=rti,
        penalty_warm_start=env("ALTRO_BENCH_WARM_RHO", "1") == "1",
        penalty_warm_start_decay=float(env("ALTRO_BENCH_WARM_RHO_DECAY", "1.0")),
        parallel_linesearch=par_ls,
        ls_phase_split=phase_split,
        ls_try_cubic_first=not par_ls,
        ls_parallel_width=int(env("ALTRO_BENCH_PAR_LS_WIDTH", "8")),
        # One grid block only: deeper backtracks would make EVERY tick
        # pay extra sequential merit evaluations whenever any of the B
        # lanes exhausts block 0; the ~1% of lane-ticks that do are
        # better served by failing fast (per-lane isolation).
        ls_max_iters=int(env("ALTRO_BENCH_LS_ITERS", "8" if par_ls else "25")),
        # Armijo slack (SolverOptions.ls_armijo_slack): exact Armijo by
        # default — the residual failures here are genuine non-descent
        # at stiff conic knots, not roundoff ties.
        ls_armijo_slack=float(env("ALTRO_BENCH_ARMIJO_SLACK", "0.0")),
        # Line-search failure recovery in the primary solve: off — the
        # rescue tier below recovers failed lanes at lower cost.
        ls_failure_recovery=env("ALTRO_BENCH_LS_RECOVERY", "0") == "1",
        ls_recovery_max_fails=int(env("ALTRO_BENCH_LS_RECOVERY_CAP", "2")),
        # widened final-step acceptance: failing lanes carry the best
        # merit-decreasing trial instead of freezing at alpha = 0
        ls_best_decrease_fallback=env("ALTRO_BENCH_LS_FALLBACK", "1") == "1",
        # Armijo-only acceptance (SolverOptions.ls_armijo_only): skips
        # the strong-Wolfe curvature test and its dphi-completion scans.
        ls_armijo_only=(rti or phase_split)
        and env("ALTRO_BENCH_ARMIJO_ONLY", "0" if rti else "1") == "1",
        # Grid trials carry (phi, states) only; accepted payload rebuilt
        # knot-parallel post-selection (SolverOptions.ls_grid_x_only).
        ls_grid_x_only=env("ALTRO_BENCH_GRID_X_ONLY", "1") == "1",
    )
    # Two-tier failed-lane rescue: after the standard-budget resolve,
    # lanes whose status != SUCCESS are re-solved from their carried
    # state at a bigger budget (unlimited recovery, best-decrease
    # fallback), gated per tick on a scalar any-lane-failed predicate
    # (lax.cond), so ticks without failures pay nothing. Rescued lanes
    # carry the rescued state forward, which also stops failure
    # cascades. Reference oracle being chased: 200/200 resolves converge
    # (bicycle_test.cpp:302-337) at an 80-iteration f64 budget.
    rescue = (not rti) and env("ALTRO_BENCH_RESCUE", "1") == "1"
    opts_rescue = None
    if rescue:
        opts_rescue = opts.replace(
            iterations_max=int(env("ALTRO_BENCH_RESCUE_ITERS", "10")),
            # extra iterations (dual/penalty reshaping) beat extra grid
            # depth per iteration on the Scotty tail
            ls_max_iters=int(env("ALTRO_BENCH_RESCUE_LS_ITERS", "8")),
            ls_failure_recovery=True,
            # 0 = unlimited: grinding recovery iterations are productive
            ls_recovery_max_fails=int(env("ALTRO_BENCH_RESCUE_CAP", "0")),
            ls_best_decrease_fallback=True,
            penalty_warm_start=True,
            # > 1 over-penalizes rescued lanes and destabilizes the loop
            penalty_warm_start_decay=float(
                env("ALTRO_BENCH_RESCUE_RHO_BOOST", "1")),
        )
    return opts, opts_rescue, rti


def make_closed_loop(B, NSIM, opts, opts_rescue):
    """(run, x_true0, states0, tiled): the jitted B-lane closed loop over
    NSIM ticks, and its inputs. The tile-resident solve runs whenever it
    supports the options and B is a whole number of 1024-lane tiles;
    otherwise vmap(solve)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from altro_tpu import tile_solver as tsv
    from altro_tpu.ops.tile_iter import tile_vmap
    from altro_tpu.ops.tiles import BATCH_TILE
    from altro_tpu.parallel.batch import batch_init_state
    from altro_tpu.rescue import solve_tiled_with_rescue, vmap_solve_with_rescue
    from altro_tpu.solver import solve

    dtype = jnp.float32
    problem, ref, h, Qd, Rd = headline_problem()
    N, n = problem.N, problem.n
    dyn = problem.dynamics

    # Sliding tracking windows (shared across lanes), precomputed on host
    xw = np.stack([ref.x[t : t + N + 1] for t in range(NSIM + 1)])  # [NSIM+1, N+1, n]
    qs = jnp.asarray(-(Qd[None, None, :] * xw), dtype)
    cs_ = 0.5 * np.sum(Qd[None, None, :] * xw * xw, axis=2)
    cs_[:, :N] += 0.5 * float(ref.u[0] @ (Rd * ref.u[0]))
    cs = jnp.asarray(cs_, dtype)
    xw0 = jnp.asarray(xw[:, 0], dtype)  # [NSIM+1, n]

    # Per-lane perturbed initial conditions
    x_true0 = jnp.asarray(ref.x[0], dtype)[None, :] + 0.02 * jax.random.normal(
        jax.random.PRNGKey(0), (B, n), dtype)
    states0 = dataclasses.replace(
        batch_init_state(problem, B),
        u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], dtype), (B, N, 1)),
        x=jnp.tile(jnp.asarray(ref.x[: N + 1], dtype), (B, 1, 1)),
    )

    def prob_at(t, x0):
        cost = dataclasses.replace(problem.cost, q=qs[t], c=cs[t])
        return dataclasses.replace(problem, x0=x0, cost=cost)

    tiled = B % BATCH_TILE == 0 and tsv.supported_options(opts)
    if tiled:
        # Tile-resident closed loop: the solver state lives in lane-tile
        # layout for the whole scan; the sliding cost windows stay
        # shared (unbatched) across lanes.
        prob_axes = dataclasses.replace(
            problem,
            cost=dataclasses.replace(
                problem.cost, Q=False, R=False, q=False, r=False, c=False),
            h=False, x0=True, A=False, B=False, f_aff=False,
            constraints=tuple(dataclasses.replace(s_, active=False)
                              for s_ in problem.constraints),
        )
        dyn_t = tile_vmap(lambda xk, uk: dyn(xk, uk, jnp.asarray(h, dtype), 0),
                          (True, True))

        def tick(carry, t):
            x_true, st = carry
            prob_t = prob_at(t, x_true)
            if opts_rescue is not None:
                st, stats = solve_tiled_with_rescue(
                    prob_t, prob_axes, st, opts, opts_rescue)
            else:
                st, stats = tsv.solve_tiled(prob_t, prob_axes, st, opts)
            x_true = dyn_t(x_true, st.u[:, 0])
            st = tsv.shift_trajectory_tiled(st)
            diff = x_true - xw0[t + 1][None, :, None, None]
            err = jnp.sqrt(jnp.sum(diff * diff, axis=1))
            return (x_true, st), (stats.iterations, err, stats.status)

        @jax.jit
        def run(x_true, states):
            carry = (tsv.batch_to_tiles(x_true), tsv.state_to_tiles(states))
            (x_t, st), outs = jax.lax.scan(tick, carry, jnp.arange(NSIM))
            return (tsv.tiles_to_batch(x_t), tsv.state_from_tiles(st)) + outs
    else:
        from altro_tpu.mpc import shift_trajectory

        def tick(carry, t):
            x_true, states = carry
            prob_t = prob_at(t, problem.x0)
            if opts_rescue is not None:
                states, stats = vmap_solve_with_rescue(
                    prob_t, x_true, states, opts, opts_rescue)
            else:
                states, stats = jax.vmap(
                    lambda x0, st: solve(dataclasses.replace(prob_t, x0=x0),
                                         st, opts))(x_true, states)
            x_true = jax.vmap(
                lambda x, u: dyn(x, u, jnp.asarray(h, dtype), 0)
            )(x_true, states.u[:, 0])
            states = jax.vmap(shift_trajectory)(states)
            err = jnp.linalg.norm(x_true - xw0[t + 1][None, :], axis=1)
            return (x_true, states), (stats.iterations, err, stats.status)

        @jax.jit
        def run(x_true, states):
            (x_true, states), outs = jax.lax.scan(
                tick, (x_true, states), jnp.arange(NSIM))
            return (x_true, states) + outs

    return run, x_true0, states0, tiled


def run_headline(B, NSIM):
    """Compile, then time one full closed-loop run; returns the result
    dict (gates included) without the device report."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    opts, opts_rescue, rti = headline_options()
    run, x_true0, states0, tiled = make_closed_loop(B, NSIM, opts, opts_rescue)

    t0 = time.perf_counter()
    jax.block_until_ready(run(x_true0, states0))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, iters, errs, statuses = jax.block_until_ready(run(x_true0, states0))
    elapsed = time.perf_counter() - t0

    dump = os.environ.get("ALTRO_BENCH_DUMP")
    if dump:
        # per-lane-tick arrays for offline analysis, [NSIM, B] in lane
        # order in both layouts
        np.savez_compressed(
            dump,
            iterations=np.asarray(iters).reshape(NSIM, -1),
            tracking_error=np.asarray(errs).reshape(NSIM, -1),
            status=np.asarray(statuses).reshape(NSIM, -1),
        )

    solves_per_s = B * NSIM / elapsed
    mean_iters = float(jnp.mean(iters))
    mean_err = float(jnp.mean(errs))
    success = float(jnp.mean(statuses == 0))

    # Hard accuracy gates (RTI mode has no convergence contract —
    # success is reported as null and not gated).
    gate_failures = []
    if mean_err > GATE_MAX_TRACKING_ERR:
        gate_failures.append(
            f"mean_tracking_error {mean_err:.4f} > {GATE_MAX_TRACKING_ERR}")
    if mean_iters > GATE_MAX_MEAN_ITERS:
        gate_failures.append(
            f"mean_iterations {mean_iters:.3f} > {GATE_MAX_MEAN_ITERS}")
    min_success = (GATE_MIN_SUCCESS if opts_rescue is not None
                   else GATE_MIN_SUCCESS_NO_RESCUE)
    if not rti and success < min_success:
        gate_failures.append(f"success_rate {success:.4f} < {min_success}")

    result = {
        "metric": "scotty_mpc_rti_resolves_per_s_per_chip" if rti
        else "scotty_mpc_warm_resolves_per_s_per_chip",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / BASELINE_SOLVES_PER_S,
        "batch": B,
        "ticks": NSIM,
        "horizon": 30,
        "tiled": tiled,
        "per_tick_ms": elapsed / NSIM * 1e3,
        "compile_s": compile_s,
        "mean_iterations": mean_iters,
        "mean_tracking_error": mean_err,
        "success_rate": None if rti else success,
        "gates_passed": not gate_failures,
        "rescue": None if opts_rescue is None else {
            "iters": opts_rescue.iterations_max,
            "cap": opts_rescue.ls_recovery_max_fails},
    }
    if gate_failures:
        result["error"] = "accuracy gates failed: " + "; ".join(gate_failures)
    return result


def main() -> int:
    import jax

    from altro_tpu.compile_cache import enable_compile_cache

    cpu_requested = os.environ.get("ALTRO_BENCH_PLATFORM") == "cpu"
    if cpu_requested:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    report = device_report()
    if report["platform"] != "gpu" and not cpu_requested:
        print(json.dumps({"error": "no GPU found (set ALTRO_BENCH_PLATFORM=cpu "
                          "to run on the CPU)", **report}))
        return EXIT_NO_DEVICE

    B = int(os.environ.get("ALTRO_BENCH_BATCH", "2048"))
    NSIM = int(os.environ.get("ALTRO_BENCH_TICKS", "200"))
    result = run_headline(B, NSIM)
    result.update(report)
    print(json.dumps(result))
    return 0 if result["gates_passed"] else EXIT_GATE_FAILURE


if __name__ == "__main__":
    sys.exit(main())

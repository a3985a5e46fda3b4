"""Per-phase profile of the batched quadrotor resolve (n=12, m=4).

Times each solver phase with the fused-scan methodology: a jitted
lax.scan over REPS applications with data dependencies, so per-dispatch
host overhead amortizes away. Runs on the GPU; ALTRO_BENCH_PLATFORM=cpu
runs it on the CPU (a CPU time is not a device time).

Usage: python scripts/profile_quadrotor.py  [B]  (default 1024)
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

def main():
    import jax

    from altro_tpu.compile_cache import enable_compile_cache

    if os.environ.get("ALTRO_BENCH_PLATFORM") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    platform = jax.devices()[0].platform
    import jax.numpy as jnp
    import numpy as np

    from altro_tpu.models.integrators import rk4
    from altro_tpu.models.quadrotor import quadrotor_continuous
    from altro_tpu.options import SolverOptions
    from altro_tpu.parallel.batch import batch_init_state, vmap_solve
    from altro_tpu.problem import Problem, lqr_cost_from_reference
    from altro_tpu import solver as S

    dtype = jnp.float32
    N, n, m = 30, 12, 4
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    REPS = 50
    hover = 0.5 * 9.81 / 4.0
    xf = np.zeros(n)
    xf[:3] = [1.0, 0.0, 1.0]
    Qd = np.tile(
        np.concatenate([np.full(3, 1.0), np.full(3, 0.1), np.full(6, 0.1)]), (N + 1, 1)
    )
    Qd[N] *= 10
    problem = Problem(
        N=N, n=n, m=m, dynamics=rk4(quadrotor_continuous()), dynamics_jac=None,
        constraints=(),
        cost=lqr_cost_from_reference(
            jnp.asarray(Qd, dtype), jnp.full((N + 1, m), 1e-2, dtype),
            jnp.asarray(np.tile(xf, (N + 1, 1)), dtype),
            jnp.full((N + 1, m), hover, dtype),
        ),
        h=jnp.full(N, 0.05, dtype), x0=jnp.zeros(n, dtype),
    )
    opts = SolverOptions(
        iterations_max=15, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, use_backtracking_linesearch=True,
        parallel_linesearch=True, ls_phase_split=True, ls_try_cubic_first=False,
        ls_max_iters=8,
    )

    key = jax.random.PRNGKey(1)
    x0s = 0.05 * jax.random.normal(key, (B, n), dtype)
    states = batch_init_state(problem, B)
    states = dataclasses.replace(states, u=jnp.full((B, N, m), hover, dtype))
    runner = vmap_solve(problem, opts)
    states, st0 = jax.block_until_ready(runner(x0s, states))
    print(json.dumps({
        "phase": "warm_state", "mean_iters": float(jnp.mean(st0.iterations)),
        "success": float(jnp.mean(st0.status == 0)),
    }))

    xs, us, zs, rhos = states.x, states.u, states.z, states.rho

    def timed(name, make_step, init):
        @jax.jit
        def run(init):
            return jax.lax.scan(make_step, init, None, length=REPS)

        out = jax.block_until_ready(run(init))
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(init))
        dt = (time.perf_counter() - t0) / REPS * 1e3
        print(json.dumps({"phase": name, "ms_per_call": round(dt, 4),
                          "platform": platform, "B": B}))
        return dt

    # 1. full warm resolve
    def full_step(carry, _):
        s, x0 = carry
        s2, stats = jax.vmap(lambda x0_, st: S.solve(
            dataclasses.replace(problem, x0=x0_), st, opts))(x0, s)
        return (s2, x0 + 1e-6 * stats.iterations[:, None].astype(dtype)), None

    timed("full_resolve", full_step, (states, x0s))

    # 2. dynamics expansions (jacfwd through RK4), knot-parallel
    def dyn_step(carry, _):
        x, u = carry
        A, Bm = jax.vmap(lambda xx, uu: S.dynamics_expansions(problem, xx, uu))(x, u)
        dep = 1e-12 * (A.sum((1, 2, 3)) + Bm.sum((1, 2, 3)))
        return (x + dep[:, None, None], u), None

    timed("dynamics_expansions", dyn_step, (xs, us))

    # 3. cost expansions + AL
    def cost_step(carry, _):
        x, u = carry
        lx, lu, lxx, luu, lux, alc = jax.vmap(
            lambda xx, uu, zz: S._cost_expansions_and_cost(problem, xx, uu, zz, rhos[0])
        )(x, u, zs)
        return (x + 1e-9 * lx, u + 1e-9 * lu), None

    timed("cost_expansions_al", cost_step, (xs, us))

    # 4. backward pass (adaptive reg scan)
    A, Bm = jax.vmap(lambda xx, uu: S.dynamics_expansions(problem, xx, uu))(xs, us)
    lx, lu, lxx, luu, lux, _ = jax.vmap(
        lambda xx, uu, zz: S._cost_expansions_and_cost(problem, xx, uu, zz, rhos[0])
    )(xs, us, zs)

    def bwd_step(carry, _):
        lx_ = carry
        gains, _reg = jax.vmap(lambda a, b, hxx, huu, hux, gx, gu: S.backward_adaptive(
            opts, a, b, hxx, huu, hux, gx, gu, jnp.asarray(0.0, dtype)))(
            A, Bm, lxx, luu, lux, lx_, lu)
        return lx_ + 1e-9 * gains.p, None

    try:
        timed("backward_pass", bwd_step, lx)
    except Exception as e:
        print("backward profile skipped:", repr(e))

    # 5. light merit rollout (dynamics-only, one alpha grid of width 8)
    K, d, P, p = states.K, states.d, states.P, states.p

    def light_step(carry, _):
        x, u = carry
        alphas = jnp.asarray(
            [1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625, 0.0078125], dtype)

        def one(xx, uu, kk, dd, pp_, ppv, zz, x0_):
            def one_alpha(a):
                out = S.merit_rollout_light(
                    problem, xx, uu, kk, dd, pp_, ppv, zz, rhos[0], a, x0_)
                return out.phi

            return jax.vmap(one_alpha)(alphas)

        phis = jax.vmap(one)(x, u, K, d, P, p, zs, x0s)
        return (x + 1e-9 * phis.mean(1)[:, None, None], u), None

    try:
        timed("light_merit_grid8", light_step, (xs, us))
    except Exception as e:
        print("light merit profile skipped:", repr(e))


if __name__ == "__main__":
    main()

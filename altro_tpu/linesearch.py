"""Strong-Wolfe cubic line search as a bounded `lax.while_loop`.

Batched redesign of the reference line-search module
(/root/reference/src/linesearch/linesearch.cpp:37-412 and
cubicspline.c:18-246). The reference's data-dependent control flow
(bracketing loop, zoom loop, one-shot cubic interpolation, simple
backtracking fallback) becomes a single `lax.while_loop` state machine in
which every iteration performs exactly one merit evaluation; the mode
switch is traced with `lax.switch`, so whole solves stay jittable and
batchable (under vmap the loop masks per-lane until all lanes finish).

The bracketing/zoom logic, tolerances, and iteration accounting replicate
the reference exactly — the end-to-end iteration-count oracles
(double integrator 3/5/9, pendulum <= 10) depend on it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from altro_tpu.status import LineSearchCode

__all__ = [
    "LineSearchOptions",
    "LineSearchResult",
    "wolfe_line_search",
    "parallel_backtracking_search",
    "parallel_backtracking_search_split",
    "cubic_fit",
    "cubic_argmin",
]

_TOL = 1e-6  # cubicspline.c LINESEARCH_TOL


# ---------------------------------------------------------------------------
# Cubic interpolation (branchless port of the intent of cubicspline.c)
# ---------------------------------------------------------------------------


def cubic_fit(x1, y1, d1, x2, y2, d2):
    """Fit y = a + b t + c t^2 + d t^3, t = x - x1, from 2 points + slopes.

    Returns ((x0, a, b, c, d), valid). Parity: cubicspline.c:18-42.
    """
    delta = x2 - x1
    same = jnp.abs(delta) < _TOL
    ds = jnp.where(same, 1.0, delta)
    a = y1
    b = d1
    c = 3.0 * (y2 - y1) / (ds * ds) - (d2 + 2.0 * d1) / ds
    d = (d2 + d1) / (ds * ds) - 2.0 * (y2 - y1) / (ds * ds * ds)
    return (x1, a, b, c, d), jnp.logical_not(same)


def cubic_argmin(spline):
    """Closed-form argmin with curvature classification.

    Returns (x_min, found) where found=False covers all the reference's
    failure codes (constant/linear/positive-quadratic/saddle/no-minimum,
    cubicspline.c:111-181) — the line search treats them identically.
    """
    x0, a, b, c, d = spline
    is_quadratic = jnp.abs(d) < _TOL
    is_linear = jnp.logical_and(is_quadratic, jnp.abs(c) < _TOL)

    # Quadratic path
    c_safe = jnp.where(jnp.abs(c) < _TOL, 1.0, c)
    quad_min = -b / (2.0 * c_safe) + x0
    quad_found = jnp.logical_and(is_quadratic, jnp.logical_and(jnp.logical_not(is_linear), c > 0))

    # Cubic path: roots of 3d t^2 + 2c t + b = 0
    qa, qb, qc = 3.0 * d, 2.0 * c, b
    qa_safe = jnp.where(jnp.abs(qa) < _TOL, 1.0, qa)
    s2 = qb * qb - 4.0 * qa * qc
    s2_zero = jnp.abs(s2) < _TOL
    s = jnp.where(s2_zero, 0.0, jnp.sqrt(jnp.maximum(s2, 0.0)))
    roots_ok = jnp.logical_or(s2_zero, s2 >= 0.0)
    t1 = (-qb + s) / (2.0 * qa_safe)
    t2 = (-qb - s) / (2.0 * qa_safe)
    curv1 = 2.0 * c + 6.0 * d * t1
    curv2 = 2.0 * c + 6.0 * d * t2
    pick1 = jnp.logical_and(curv1 > 0, curv2 < 0)
    pick2 = jnp.logical_and(curv1 < 0, curv2 > 0)
    cubic_min = jnp.where(pick1, t1, t2) + x0
    cubic_found = jnp.logical_and(
        jnp.logical_not(is_quadratic),
        jnp.logical_and(roots_ok, jnp.logical_or(pick1, pick2)),
    )

    found = jnp.logical_or(quad_found, cubic_found)
    x_min = jnp.where(is_quadratic, quad_min, cubic_min)
    return x_min, found


# ---------------------------------------------------------------------------
# Line search
# ---------------------------------------------------------------------------


class LineSearchOptions(NamedTuple):
    c1: float = 1e-4
    c2: float = 0.9
    max_iters: int = 25
    alpha_max: float = 2.0
    beta_increase: float = 1.5
    beta_decrease: float = 0.5
    min_interval_size: float = 1e-6
    try_cubic_first: bool = True
    use_backtracking: bool = False
    # Relative Armijo slack (see SolverOptions.ls_armijo_slack): accept
    # phi <= phi0 + c1*a*dphi0 + armijo_slack*|phi0|. 0 = exact Armijo.
    armijo_slack: float = 0.0
    # Per-trial trace via jax.debug.print (Verbosity.LINE_SEARCH; the
    # reference's CubicLineSearch verbose mode, linesearch.cpp:70-73).
    verbose: bool = False


class LineSearchResult(NamedTuple):
    alpha: jnp.ndarray
    phi: jnp.ndarray
    dphi: jnp.ndarray
    code: jnp.ndarray  # int32 LineSearchCode
    n_iters: jnp.ndarray  # merit evaluations performed
    aux: object = ()  # payload of the last FULL merit evaluation
    aux_alpha: jnp.ndarray = jnp.nan  # alpha of that evaluation


# modes
_BRACKET, _CUBIC, _ZOOM, _BACKTRACK, _DONE = range(5)


class _State(NamedTuple):
    mode: jnp.ndarray
    alpha_next: jnp.ndarray  # trial step evaluated at loop top
    aux: object  # payload of the last full merit evaluation
    aux_alpha: jnp.ndarray  # alpha of that evaluation
    small_window: jnp.ndarray  # zoom: this trial is the tiny-window midpoint
    n_iters: jnp.ndarray
    iter: jnp.ndarray  # bracket-loop counter
    zoom_iter: jnp.ndarray
    btr_iter: jnp.ndarray
    # last bracket evaluation (restored after a failed cubic try)
    alpha: jnp.ndarray
    phi: jnp.ndarray
    dphi: jnp.ndarray
    fnd: jnp.ndarray  # function_not_decreasing at that evaluation
    # previous bracket point
    alpha_prev: jnp.ndarray
    phi_prev: jnp.ndarray
    dphi_prev: jnp.ndarray
    # zoom window
    alo: jnp.ndarray
    ahi: jnp.ndarray
    phi_lo: jnp.ndarray
    phi_hi: jnp.ndarray
    dphi_lo: jnp.ndarray
    dphi_hi: jnp.ndarray
    hit_max_alpha: jnp.ndarray
    # result
    code: jnp.ndarray
    res_alpha: jnp.ndarray
    res_phi: jnp.ndarray
    res_dphi: jnp.ndarray


def wolfe_line_search(
    merit_full: Callable,
    merit_value: Callable,
    phi0,
    dphi0,
    alpha0=1.0,
    opts: LineSearchOptions = LineSearchOptions(),
    aux0=None,
) -> LineSearchResult:
    """Run the line search on merit function phi(alpha).

    merit_full(alpha) -> (phi, dphi) or (phi, dphi, aux);
    merit_value(alpha) -> phi (used by the backtracking fallback, which
    needs no derivative — linesearch.cpp:385-412).

    When merit_full returns a third element (any pytree), pass a
    structurally matching `aux0`; the payload of the LAST full evaluation
    is carried and returned (`result.aux`, valid at `result.aux_alpha`) —
    lets the caller reuse the trajectory data of the accepted step
    instead of re-evaluating the merit function.
    """
    dtype = jnp.asarray(phi0).dtype
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.result_type(float)
    phi0 = jnp.asarray(phi0, dtype)
    dphi0 = jnp.asarray(dphi0, dtype)
    alpha0 = jnp.asarray(alpha0, dtype)
    c1 = jnp.asarray(opts.c1, dtype)
    c2 = jnp.asarray(opts.c2, dtype)
    z = jnp.asarray(0.0, dtype)
    i0 = jnp.asarray(0, jnp.int32)

    has_aux = aux0 is not None
    aux_init = aux0 if has_aux else ()

    def mk_state(**kw):
        base = dict(
            mode=jnp.asarray(_BRACKET, jnp.int32),
            alpha_next=alpha0,
            aux=aux_init,
            aux_alpha=jnp.asarray(jnp.nan, dtype),
            small_window=jnp.asarray(False),
            n_iters=i0,
            iter=i0,
            zoom_iter=i0,
            btr_iter=i0,
            alpha=alpha0,
            phi=phi0,
            dphi=dphi0,
            fnd=jnp.asarray(False),
            alpha_prev=z,
            phi_prev=phi0,
            dphi_prev=dphi0,
            alo=z,
            ahi=z,
            phi_lo=phi0,
            phi_hi=phi0,
            dphi_lo=dphi0,
            dphi_hi=dphi0,
            hit_max_alpha=jnp.asarray(False),
            code=jnp.asarray(int(LineSearchCode.NO_ERROR), jnp.int32),
            res_alpha=z,
            res_phi=phi0,
            res_dphi=dphi0,
        )
        base.update(kw)
        return _State(**base)

    def done(s, code, alpha, phi, dphi):
        return s._replace(
            mode=jnp.asarray(_DONE, jnp.int32),
            code=jnp.asarray(int(code), jnp.int32) if isinstance(code, LineSearchCode) else code,
            res_alpha=alpha,
            res_phi=phi,
            res_dphi=dphi,
        )

    def armijo(alpha, phi):
        return phi <= phi0 + c1 * alpha * dphi0 + opts.armijo_slack * jnp.abs(phi0)

    def wolfe(dphi):
        return jnp.abs(dphi) <= -c2 * dphi0

    def enter_zoom(s, alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi):
        """Transition into the zoom stage. Parity: linesearch.cpp:233-303."""
        nonfinite = jnp.logical_not(
            jnp.logical_and(jnp.isfinite(alo), jnp.isfinite(ahi))
        )
        zoom_iter = s.n_iters + 1
        over = zoom_iter >= opts.max_iters
        trial, small = _zoom_trial(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi)
        s = s._replace(
            mode=jnp.asarray(_ZOOM, jnp.int32),
            alo=alo,
            ahi=ahi,
            phi_lo=phi_lo,
            phi_hi=phi_hi,
            dphi_lo=dphi_lo,
            dphi_hi=dphi_hi,
            zoom_iter=zoom_iter,
            alpha_next=trial,
            small_window=small,
        )
        s = jax.lax.cond(
            over,
            lambda s: done(s, LineSearchCode.MAX_ITERATIONS, alo, phi_lo, dphi_lo),
            lambda s: s,
            s,
        )
        return jax.lax.cond(
            nonfinite,
            lambda s: done(s, LineSearchCode.GOT_NONFINITE_STEP_SIZE, z, s.phi, s.dphi),
            lambda s: s,
            s,
        )

    def _zoom_trial(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi):
        """Next zoom trial: cubic argmin, else midpoint; tiny window -> midpoint."""
        small = jnp.abs(alo - ahi) < opts.min_interval_size
        spline, fit_ok = cubic_fit(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi)
        amin, found = cubic_argmin(spline)
        use_cubic = jnp.logical_and(fit_ok, jnp.logical_and(found, jnp.isfinite(amin)))
        mid = 0.5 * (alo + ahi)
        trial = jnp.where(small, mid, jnp.where(use_cubic, amin, mid))
        return trial, small

    def post_check(s, alpha, phi, dphi, fnd):
        """Bracket-stage logic after the Wolfe test fails.

        Parity: linesearch.cpp:137-213 (backtracking fallback, the two
        zoom entries, interval expansion with alpha_max handling).
        """

        def to_backtrack(s):
            return s._replace(
                mode=jnp.asarray(_BACKTRACK, jnp.int32),
                alpha_next=alpha0 * opts.beta_decrease,
                btr_iter=jnp.asarray(1, jnp.int32),
            )

        def zoom_a(s):  # alo = previous point, ahi = current
            return enter_zoom(s, s.alpha_prev, s.phi_prev, s.dphi_prev, alpha, phi, dphi)

        def zoom_c(s):  # "bowl": alo = current, ahi = previous
            return enter_zoom(s, alpha, phi, dphi, s.alpha_prev, s.phi_prev, s.dphi_prev)

        def expand(s):
            new_alpha = alpha * opts.beta_increase
            over = new_alpha > opts.alpha_max
            new_alpha = jnp.minimum(new_alpha, opts.alpha_max)
            stop = jnp.logical_and(over, s.hit_max_alpha)
            s = s._replace(
                alpha_prev=alpha,
                phi_prev=phi,
                dphi_prev=dphi,
                alpha_next=new_alpha,
                hit_max_alpha=jnp.logical_or(s.hit_max_alpha, over),
                iter=s.iter + 1,
            )
            s = jax.lax.cond(
                stop,
                lambda s: done(s, LineSearchCode.HIT_MAX_STEPSIZE, new_alpha, phi, dphi),
                lambda s: s,
                s,
            )
            # Bracket loop exhausted -> return current alpha, code NO_ERROR
            return jax.lax.cond(
                s.iter >= opts.max_iters,
                lambda s: done(s, s.code, new_alpha, phi, dphi),
                lambda s: s,
                s,
            )

        suff = armijo(alpha, phi)
        zoom_case_a = jnp.logical_or(
            jnp.logical_not(suff), jnp.logical_and(s.iter > 0, fnd)
        )
        zoom_case_c = dphi >= 0

        if opts.use_backtracking:
            return to_backtrack(s)
        branch = jnp.where(zoom_case_a, 0, jnp.where(zoom_case_c, 1, 2))
        return jax.lax.switch(branch, [zoom_a, zoom_c, expand], s)

    # ----------------------------------------------------------------- modes

    def bracket_step(s, phi_t, dphi_t):
        alpha = s.alpha_next
        s = s._replace(n_iters=s.n_iters + 1)
        suff = armijo(alpha, phi_t)
        fnd = phi_t >= s.phi_prev
        ok = jnp.logical_and(suff, wolfe(dphi_t))

        def on_ok(s):
            return done(s, LineSearchCode.MINIMUM_FOUND, alpha, phi_t, dphi_t)

        def on_fail(s):
            # One-shot cubic interpolation on the first interval
            spline, fit_ok = cubic_fit(z, phi0, dphi0, alpha, phi_t, dphi_t)
            amin, found = cubic_argmin(spline)
            try_cubic = jnp.logical_and(
                jnp.asarray(opts.try_cubic_first and True),
                jnp.logical_and(
                    s.iter == 0,
                    jnp.logical_and(fit_ok, jnp.logical_and(found, jnp.isfinite(amin))),
                ),
            )

            def to_cubic(s):
                return s._replace(
                    mode=jnp.asarray(_CUBIC, jnp.int32),
                    alpha_next=amin,
                    iter=s.iter + 1,
                    alpha=alpha,
                    phi=phi_t,
                    dphi=dphi_t,
                    fnd=fnd,
                )

            return jax.lax.cond(
                try_cubic,
                to_cubic,
                lambda s: post_check(s, alpha, phi_t, dphi_t, fnd),
                s,
            )

        return jax.lax.cond(ok, on_ok, on_fail, s._replace(alpha=alpha, phi=phi_t, dphi=dphi_t, fnd=fnd))

    def cubic_step(s, phi_t, dphi_t):
        alpha_c = s.alpha_next
        s = s._replace(n_iters=s.n_iters + 1)
        ok = jnp.logical_and(armijo(alpha_c, phi_t), wolfe(dphi_t))
        return jax.lax.cond(
            ok,
            lambda s: done(s, LineSearchCode.MINIMUM_FOUND, alpha_c, phi_t, dphi_t),
            # Discard the cubic trial; continue with the saved first trial.
            lambda s: post_check(s, s.alpha, s.phi, s.dphi, s.fnd),
            s,
        )

    def zoom_step(s, phi_t, dphi_t):
        alpha = s.alpha_next
        s = s._replace(n_iters=s.n_iters + 1)
        suff = armijo(alpha, phi_t)
        curv = wolfe(dphi_t)

        def on_small(s):
            code = jnp.where(
                jnp.logical_and(suff, curv),
                int(LineSearchCode.MINIMUM_FOUND),
                int(LineSearchCode.WINDOW_TOO_SMALL),
            ).astype(jnp.int32)
            return done(s, code, alpha, phi_t, dphi_t)

        def on_normal(s):
            def on_ok(s):
                return done(s, LineSearchCode.MINIMUM_FOUND, alpha, phi_t, dphi_t)

            def on_update(s):
                higher = phi_t > s.phi_lo
                shrink_hi = jnp.logical_or(jnp.logical_not(suff), higher)

                def adj_hi(s):
                    return s._replace(ahi=alpha, phi_hi=phi_t, dphi_hi=dphi_t)

                def adj_lo(s):
                    reset_ahi = dphi_t * (s.ahi - s.alo) <= 0
                    ahi = jnp.where(reset_ahi, s.alo, s.ahi)
                    phi_hi = jnp.where(reset_ahi, s.phi_lo, s.phi_hi)
                    dphi_hi = jnp.where(reset_ahi, s.dphi_lo, s.dphi_hi)
                    return s._replace(
                        ahi=ahi,
                        phi_hi=phi_hi,
                        dphi_hi=dphi_hi,
                        alo=alpha,
                        phi_lo=phi_t,
                        dphi_lo=dphi_t,
                    )

                s = jax.lax.cond(shrink_hi, adj_hi, adj_lo, s)
                s = s._replace(zoom_iter=s.zoom_iter + 1)
                trial, small = _zoom_trial(
                    s.alo, s.phi_lo, s.dphi_lo, s.ahi, s.phi_hi, s.dphi_hi
                )
                s = s._replace(alpha_next=trial, small_window=small)
                return jax.lax.cond(
                    s.zoom_iter >= opts.max_iters,
                    lambda s: done(s, LineSearchCode.MAX_ITERATIONS, alpha, phi_t, dphi_t),
                    lambda s: s,
                    s,
                )

            return jax.lax.cond(jnp.logical_and(suff, curv), on_ok, on_update, s)

        return jax.lax.cond(s.small_window, on_small, on_normal, s)

    def backtrack_step(s, phi_t, dphi_t):
        alpha = s.alpha_next
        s = s._replace(n_iters=s.n_iters + 1)
        suff = armijo(alpha, phi_t)

        def on_ok(s):
            return done(s, LineSearchCode.MINIMUM_FOUND, alpha, phi_t, dphi_t)

        def on_shrink(s):
            new_alpha = alpha * opts.beta_decrease
            s = s._replace(alpha_next=new_alpha, btr_iter=s.btr_iter + 1)
            return jax.lax.cond(
                s.btr_iter >= opts.max_iters,
                lambda s: done(s, s.code, new_alpha, phi_t, s.res_dphi),
                lambda s: s,
                s,
            )

        return jax.lax.cond(suff, on_ok, on_shrink, s)

    # ------------------------------------------------------------------ loop

    def cond(s):
        return s.mode != _DONE

    def body(s):
        # One merit evaluation per loop iteration. Always evaluated WITH
        # the derivative: under vmap both branches of a value/full cond
        # would execute anyway (batched predicates become selects), so a
        # single full evaluation is strictly cheaper in the batched
        # regime — and it keeps the aux payload valid for every mode,
        # including backtracking. phi values (and hence the search path)
        # are identical to the reference's value-only backtracking evals.
        out = merit_full(s.alpha_next)
        if has_aux:
            phi_t, dphi_t, aux_t = out
        else:
            (phi_t, dphi_t), aux_t = out[:2], ()
        phi_t = jnp.asarray(phi_t, dtype)
        dphi_t = jnp.asarray(dphi_t, dtype)
        if opts.verbose:  # linesearch.cpp:70-73 trial trace
            jax.debug.print(
                "    ls trial {i}: alpha = {a:.6}, phi = {p:.8}, dphi = {d:.6}",
                i=s.n_iters, a=s.alpha_next, p=phi_t, d=dphi_t,
            )
        s = s._replace(aux=aux_t, aux_alpha=s.alpha_next)
        return jax.lax.switch(
            s.mode,
            [bracket_step, cubic_step, zoom_step, backtrack_step],
            s,
            phi_t,
            dphi_t,
        )

    if opts.verbose:  # linesearch.cpp:70-73 start banner
        jax.debug.print(
            "  Starting Cubic Line Search with phi0 = {p0:.8}, dphi0 = {d0:.6}",
            p0=phi0, d0=dphi0,
        )
    init = mk_state()
    # Not a descent direction: return alpha = 0 (linesearch.cpp:49-52)
    init = jax.lax.cond(
        dphi0 >= 0,
        lambda s: done(s, LineSearchCode.NOT_DESCENT_DIRECTION, z, phi0, dphi0),
        lambda s: s,
        init,
    )
    final = jax.lax.while_loop(cond, body, init)
    return LineSearchResult(
        alpha=final.res_alpha,
        phi=final.res_phi,
        dphi=final.res_dphi,
        code=final.code,
        n_iters=final.n_iters,
        aux=final.aux,
        aux_alpha=final.aux_alpha,
    )


def parallel_backtracking_search(
    merit_full: Callable,
    phi0,
    dphi0,
    alpha0=1.0,
    opts: LineSearchOptions = LineSearchOptions(),
    aux0=None,
    width: int = 8,
) -> LineSearchResult:
    """Backtracking line search with ALL trial steps evaluated at once.

    Batched redesign of the sequential backtracking mode
    (linesearch.cpp:385-412): instead of trying alpha0, alpha0*beta,
    alpha0*beta^2, ... one merit rollout at a time, evaluate the whole
    geometric trial grid in a single batched (vmap-over-alpha) merit
    evaluation and select the first passing step. Why it matters under
    batching: a vmapped `lax.while_loop` runs until EVERY lane's
    predicate clears, so with B lanes in lockstep one straggler lane
    needing k trials makes all B lanes pay k sequential merit rollouts.
    Here the sequential depth is exactly one merit rollout regardless of
    k (the grid dimension rides the batch/vector axis, where the device
    has slack at these model sizes).

    Accepted-step parity with the sequential mode (ls_try_cubic_first
    False): alpha0 is accepted on Armijo+strong-Wolfe (bracket_step
    semantics); otherwise the first alpha0*beta^k (k >= 1) satisfying
    Armijo is taken. The grid is evaluated in BLOCKS of `width`: one
    batched evaluation covers {beta^0..beta^(width-1)}; only if no trial
    in the block passes does a second block {beta^width..} run
    (lax.while_loop), up to opts.max_iters total trials — so the deep
    backtracks that stiff-penalty knots occasionally need (a
    warm-started rho of 1e3+ puts the acceptable step below beta^7)
    still succeed, at 1/width the sequential depth. If all max_iters
    trials fail, the search returns the same not-found code the
    sequential loop returns on exhaustion. n_iters reports the count of
    merit evaluations the sequential search would have performed (1+k).
    """
    dtype = jnp.asarray(phi0).dtype
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.result_type(float)
    phi0 = jnp.asarray(phi0, dtype)
    dphi0 = jnp.asarray(dphi0, dtype)
    alpha0 = jnp.asarray(alpha0, dtype)
    beta = jnp.asarray(opts.beta_decrease, dtype)
    c1 = jnp.asarray(opts.c1, dtype)
    c2 = jnp.asarray(opts.c2, dtype)
    n_blocks = max(1, -(-int(opts.max_iters) // width))  # ceil

    has_aux = aux0 is not None

    def eval_one(a):
        out = merit_full(a)
        if has_aux:
            phi_t, dphi_t, aux_t = out
        else:
            (phi_t, dphi_t), aux_t = out[:2], ()
        return jnp.asarray(phi_t, dtype), jnp.asarray(dphi_t, dtype), aux_t

    def eval_block(block):
        """Evaluate trials k = block*width .. block*width+width-1; return
        (found, k_global, alpha, phi, dphi, aux) for the first passing."""
        ks = block * width + jnp.arange(width)
        alphas = alpha0 * beta ** ks.astype(dtype)
        phis, dphis, auxs = jax.vmap(eval_one)(alphas)
        armijo = phis <= phi0 + c1 * alphas * dphi0 + jnp.asarray(
            opts.armijo_slack, dtype
        ) * jnp.abs(phi0)
        if opts.verbose:  # batched analog of the per-trial trace
            jax.debug.print(
                "    ls grid block {b}: alphas = {a}, phis = {p} (phi0 = {p0:.8})",
                b=block, a=alphas, p=phis, p0=phi0,
            )
        # Global first trial (k = 0) uses bracket_step semantics:
        # Armijo AND strong Wolfe.
        wolfe_first = jnp.abs(dphis[0]) <= -c2 * dphi0
        passes = jnp.where(
            ks == 0, jnp.logical_and(armijo, wolfe_first), armijo
        )
        found = jnp.any(passes)
        idx = jnp.argmax(passes)  # first passing index in block
        aux = jax.tree.map(lambda a: a[idx], auxs) if has_aux else ()
        return found, ks[idx], alphas[idx], phis[idx], dphis[idx], aux

    found0, k0, a0_, p0_, d0_, aux_first = eval_block(jnp.asarray(0, jnp.int32))

    if n_blocks == 1:
        found, k_acc, alpha_acc, phi_acc, dphi_acc, aux_acc = (
            found0, k0, a0_, p0_, d0_, aux_first,
        )
    else:
        def cond(c):
            found, block = c[0], c[1]
            return jnp.logical_and(jnp.logical_not(found), block < n_blocks)

        def body(c):
            _, block = c[0], c[1]
            f, k, a, p, d, aux = eval_block(block)
            return (f, block + 1, k, a, p, d, aux)

        init = (found0, jnp.asarray(1, jnp.int32), k0, a0_, p0_, d0_, aux_first)
        found, _, k_acc, alpha_acc, phi_acc, dphi_acc, aux_acc = jax.lax.while_loop(
            cond, body, init
        )

    # Not a descent direction: alpha = 0 (linesearch.cpp:49-52)
    not_descent = dphi0 >= 0
    ok = jnp.logical_and(found, jnp.logical_not(not_descent))

    alpha = jnp.where(ok, alpha_acc, jnp.where(not_descent, 0.0, alpha_acc))
    code = jnp.where(
        not_descent,
        int(LineSearchCode.NOT_DESCENT_DIRECTION),
        jnp.where(ok, int(LineSearchCode.MINIMUM_FOUND), int(LineSearchCode.NO_ERROR)),
    ).astype(jnp.int32)
    return LineSearchResult(
        alpha=jnp.where(not_descent, 0.0, alpha),
        phi=phi_acc,
        dphi=dphi_acc,
        code=code,
        n_iters=jnp.where(ok, k_acc + 1, opts.max_iters).astype(jnp.int32),
        aux=aux_acc,
        aux_alpha=jnp.where(ok, alpha_acc, jnp.asarray(jnp.nan, dtype)),
    )


def parallel_backtracking_search_split(
    merit_value: Callable,
    complete: Callable,
    phi0,
    dphi0,
    alpha0=1.0,
    opts: LineSearchOptions = LineSearchOptions(),
    width: int = 8,
    armijo_only: bool = False,
    reconstruct: Optional[Callable] = None,
    best_decrease_fallback: bool = False,
) -> LineSearchResult:
    """Phase-split variant of `parallel_backtracking_search`.

    The grid trials are evaluated with a rollout-only merit function
    (`merit_value(alpha) -> (phi, light_payload)`) that carries no
    per-step expansion work; the full expansion payload is reconstructed
    AFTER selection by `complete(light_payload) -> (dphi, full_payload)`,
    which is knot-parallel (one vmap over the knot axis plus a cheap
    linear-sensitivity scan). With an expensive-dynamics model the grid
    rollout thus costs ~the dynamics alone, and the Jacobian/AL-gradient
    work is paid once (at the accepted step) instead of `width` times
    inside the sequential rollout.

    Accepted-step parity with `parallel_backtracking_search`: the first
    trial (alpha0) is accepted on Armijo + strong Wolfe — its dphi comes
    from completing trial 0's payload (the same forward-sensitivity
    recurrence the fused rollout evaluates, so the same value up to
    summation order) — and later trials on Armijo alone. Deep blocks
    beyond the first are Armijo-only (k >= width > 0), so they stay
    rollout-only.

    armijo_only=True (SolverOptions.ls_armijo_only) accepts trial 0 on
    Armijo alone and completes the accepted payload without its dphi
    sensitivity scan (result.dphi = NaN) — removing both sequential
    completion scans; only stats consume the accepted-step dphi.

    reconstruct (optional): when given, `merit_value(alpha)` returns
    (phi, carrier) where the carrier is a MINIMAL payload (e.g. just the
    rolled-out state trajectory), and the selected trial's light payload
    is rebuilt knot-parallel by `reconstruct(carrier, alpha, phi)` AFTER
    selection. The grid then materializes width x [N+1, n] states instead
    of width x the full (x, u, y, convals, zproj) stacks — everything but
    phi and x is a per-knot pure function of the state trajectory.
    """
    dtype = jnp.asarray(phi0).dtype
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.result_type(float)
    phi0 = jnp.asarray(phi0, dtype)
    dphi0 = jnp.asarray(dphi0, dtype)
    alpha0 = jnp.asarray(alpha0, dtype)
    beta = jnp.asarray(opts.beta_decrease, dtype)
    c1 = jnp.asarray(opts.c1, dtype)
    c2 = jnp.asarray(opts.c2, dtype)
    slack = jnp.asarray(opts.armijo_slack, dtype)
    n_blocks = max(1, -(-int(opts.max_iters) // width))  # ceil

    def eval_one(a):
        phi_t, light = merit_value(a)
        return jnp.asarray(phi_t, dtype), light

    def eval_grid(alphas):
        return jax.vmap(eval_one)(alphas)

    def armijo_mask(alphas, phis):
        return phis <= phi0 + c1 * alphas * dphi0 + slack * jnp.abs(phi0)

    # ---- block 0: needs trial 0's dphi for the strong-Wolfe test -------
    # (unless armijo_only, which skips that completion entirely)
    ks0 = jnp.arange(width)
    alphas0 = alpha0 * beta ** ks0.astype(dtype)
    phis0, lights0 = eval_grid(alphas0)
    armijo0 = armijo_mask(alphas0, phis0)
    if opts.verbose:  # batched analog of the per-trial trace
        jax.debug.print(
            "    ls grid block 0: alphas = {a}, phis = {p} (phi0 = {p0:.8})",
            a=alphas0, p=phis0, p0=phi0,
        )
    if armijo_only:
        passes0 = armijo0
    else:
        light_first = jax.tree.map(lambda a: a[0], lights0)
        if reconstruct is not None:
            light_first = reconstruct(light_first, alphas0[0], phis0[0])
        dphi_first, _ = complete(light_first)
        wolfe_first = jnp.abs(dphi_first) <= -c2 * dphi0
        passes0 = jnp.where(
            ks0 == 0, jnp.logical_and(armijo0, wolfe_first), armijo0
        )
    found0 = jnp.any(passes0)
    idx0 = jnp.argmax(passes0)
    sel0 = (
        found0,
        ks0[idx0],
        alphas0[idx0],
        phis0[idx0],
        jax.tree.map(lambda a: a[idx0], lights0),
    )
    if best_decrease_fallback:
        bidx0 = jnp.argmin(phis0)
        best0 = (
            ks0[bidx0],
            alphas0[bidx0],
            phis0[bidx0],
            jax.tree.map(lambda a: a[bidx0], lights0),
        )
    else:
        # the best-trial carry is only materialized when the fallback is
        # on — it adds an argmin + light-tree gather per block to the
        # hot default path otherwise
        best0 = ()

    # ---- deeper blocks: Armijo-only, rollout-only -----------------------
    if n_blocks == 1:
        found, k_acc, alpha_acc, phi_acc, light_acc = sel0
        if best_decrease_fallback:
            bk, balpha, bphi, blight = best0
    else:

        def cond(c):
            return jnp.logical_and(jnp.logical_not(c[0]), c[1] < n_blocks)

        def body(c):
            block_c = c[1]
            ks = block_c * width + jnp.arange(width)
            alphas = alpha0 * beta ** ks.astype(dtype)
            phis, lights = eval_grid(alphas)
            passes = armijo_mask(alphas, phis)
            if opts.verbose:
                jax.debug.print(
                    "    ls grid block {b}: alphas = {a}, phis = {p}",
                    b=block_c, a=alphas, p=phis,
                )
            f = jnp.any(passes)
            idx = jnp.argmax(passes)
            out = (
                f,
                block_c + 1,
                ks[idx],
                alphas[idx],
                phis[idx],
                jax.tree.map(lambda a: a[idx], lights),
            )
            if best_decrease_fallback:
                bk, balpha, bphi, blight = c[6:]
                bi = jnp.argmin(phis)
                take_best = phis[bi] < bphi
                out = out + (
                    jnp.where(take_best, ks[bi], bk),
                    jnp.where(take_best, alphas[bi], balpha),
                    jnp.where(take_best, phis[bi], bphi),
                    jax.tree.map(
                        lambda n_, o: jnp.where(take_best, n_[bi], o),
                        lights, blight),
                )
            return out

        # carry: (found, block, k, alpha, phi, light[, bk, balpha, bphi,
        # blight]) — the running BEST-merit trial rides alongside only
        # when the best-decrease fallback needs it
        init = (sel0[0], jnp.asarray(1, jnp.int32), sel0[1], sel0[2],
                sel0[3], sel0[4]) + best0
        out = jax.lax.while_loop(cond, body, init)
        found, _, k_acc, alpha_acc, phi_acc, light_acc = out[:6]
        if best_decrease_fallback:
            bk, balpha, bphi, blight = out[6:]

    not_descent = dphi0 >= 0
    ok = jnp.logical_and(found, jnp.logical_not(not_descent))
    if best_decrease_fallback:
        fb = jnp.logical_and(jnp.logical_not(ok), bphi < phi0)
        k_acc = jnp.where(fb, bk, k_acc)
        alpha_acc = jnp.where(fb, balpha, alpha_acc)
        phi_acc = jnp.where(fb, bphi, phi_acc)
        light_acc = jax.tree.map(
            lambda b, a: jnp.where(fb, b, a), blight, light_acc)
    else:
        fb = jnp.zeros_like(ok)

    # Complete the accepted step's payload (once, knot-parallel).
    if reconstruct is not None:
        light_acc = reconstruct(light_acc, alpha_acc, phi_acc)
    dphi_acc, aux_acc = complete(light_acc, with_dphi=not armijo_only)

    code = jnp.where(
        ok,
        int(LineSearchCode.MINIMUM_FOUND),
        jnp.where(
            fb,
            int(LineSearchCode.BEST_DECREASE),
            jnp.where(
                not_descent,
                int(LineSearchCode.NOT_DESCENT_DIRECTION),
                int(LineSearchCode.NO_ERROR),
            ),
        ),
    ).astype(jnp.int32)
    take = jnp.logical_or(ok, fb)
    return LineSearchResult(
        alpha=jnp.where(take, alpha_acc, 0.0),
        phi=phi_acc,
        dphi=dphi_acc,
        code=code,
        n_iters=jnp.where(ok, k_acc + 1, opts.max_iters).astype(jnp.int32),
        aux=aux_acc,
        aux_alpha=jnp.where(take, alpha_acc, jnp.asarray(jnp.nan, dtype)),
    )

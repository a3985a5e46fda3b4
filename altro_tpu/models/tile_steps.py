"""Column-form dynamics steps for the tiled trial-rollout GPU kernel.

The tiled rollout kernel (ops/pallas_rollout_tiled.py) runs the
line-search trial grid of a batched solve inside one program per block
of lanes, with each state/input component a separate lane vector. It
needs the model dynamics evaluated on such per-component operands; the
physics is written here in COLUMN form: `f(x_cols, u_cols)` where
x_cols / u_cols are tuples of broadcast-compatible arrays (one per
state/input component) returning a tuple of components. Discrete steps
take `(x_cols, u_cols, h)` with h broadcast-compatible. Compose
continuous column dynamics with `midpoint_cols` / `rk4_cols`.

Writing rules: only elementwise jnp ops and transcendentals the Pallas
Triton lowering supports (sin, cos, tan, sqrt, rsqrt, ...); no
reductions, gathers or reshapes — each component is one lane vector.

The protocol: `Problem.dynamics_cols` holds the column step, equal (to
f32 roundoff) to `problem.dynamics(x, u, h, k)` component-wise —
tests/test_pallas_rollout_tiled.py checks each zoo step against the
per-lane dynamics under vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "midpoint_cols",
    "rk4_cols",
    "bicycle_cols",
    "double_integrator_cols",
    "pendulum_cols",
    "quadrotor_cols",
]


def midpoint_cols(f):
    """Explicit midpoint on column tuples (== models.integrators.midpoint,
    integrators.py / reference test_utils.cpp midpoint discretization)."""

    def step(x, u, h):
        fx = f(x, u)
        xm = tuple(xi + 0.5 * h * fi for xi, fi in zip(x, fx))
        fm = f(xm, u)
        return tuple(xi + h * fi for xi, fi in zip(x, fm))

    return step


def rk4_cols(f):
    """Classic RK4 on column tuples (== models.integrators.rk4)."""

    def step(x, u, h):
        k1 = f(x, u)
        k2 = f(tuple(xi + 0.5 * h * ki for xi, ki in zip(x, k1)), u)
        k3 = f(tuple(xi + 0.5 * h * ki for xi, ki in zip(x, k2)), u)
        k4 = f(tuple(xi + h * ki for xi, ki in zip(x, k3)), u)
        return tuple(
            xi + (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
            for xi, a, b, c, d in zip(x, k1, k2, k3, k4)
        )

    return step


def bicycle_cols(frame="cog", length=2.7, rear=1.5):
    """Column form of models.bicycle.bicycle_continuous (all 3 frames)."""

    def f(x, u):
        v, delta_dot = u[0], u[1]
        theta, delta = x[2], x[3]
        if frame in ("cog", "CENTER_OF_GRAVITY"):
            # beta = atan(rear*delta / length) — not needed: only
            # cos(beta)/sin(beta) appear, which the triangle identity
            # gives EXACTLY (and with cheaper ops than atan + cos/sin):
            #   cos(beta) = L / hyp,  sin(beta) = rear*delta / hyp,
            #   hyp = sqrt(L^2 + (rear*delta)^2);
            # cos/sin(theta + beta) expand by the angle-sum formulas.
            rd = rear * delta
            inv_hyp = jax.lax.rsqrt(length * length + rd * rd)
            cosb = length * inv_hyp
            sinb = rd * inv_hyp
            ct, st = jnp.cos(theta), jnp.sin(theta)
            cos_ang = ct * cosb - st * sinb
            sin_ang = st * cosb + ct * sinb
            omega = v * cosb * jnp.tan(delta) / length
        elif frame in ("rear", "REAR"):
            omega = v * jnp.tan(delta) / length
            cos_ang, sin_ang = jnp.cos(theta), jnp.sin(theta)
        else:  # front
            omega = v * jnp.sin(delta) / length
            ang = theta + delta
            cos_ang, sin_ang = jnp.cos(ang), jnp.sin(ang)
        return (v * cos_ang, v * sin_ang, omega, delta_dot)

    return f


def double_integrator_cols(dim=2):
    """Column form of models.double_integrator.double_integrator_dynamics —
    that model is an EXACT DISCRETE step, so this returns a
    step(x, u, h) directly (no integrator composition):
    pos' = pos + vel h + u h^2/2;  vel' = vel + u h."""

    def step(x, u, h):
        b = 0.5 * h * h
        cols = []
        for i in range(dim):
            cols.append(x[i] + x[dim + i] * h + u[i] * b)
        for i in range(dim):
            cols.append(x[dim + i] + u[i] * h)
        return tuple(cols)

    return step


def pendulum_cols(mass=1.0, length=0.5, b=0.1, g=9.81):
    """Column form of models.pendulum.pendulum_continuous."""

    def f(x, u):
        theta, omega = x[0], x[1]
        tau = u[0]
        alpha = (tau - b * omega) / (mass * length * length) - (
            g / length
        ) * jnp.sin(theta)
        return (omega, alpha)

    return f


def quadrotor_cols(mass=0.5, gravity=9.81, arm=0.1750, kf=1.0, km=0.0245,
                   inertia=(0.0023, 0.0023, 0.004)):
    """Column form of models.quadrotor.quadrotor_continuous (n=12:
    [pos(3), rpy(3), vel(3), omega(3)], u = 4 rotor thrusts) — the same
    scalar-form expressions on component columns."""
    Jx, Jy, Jz = inertia

    def f(x, u):
        r, p, y = x[3], x[4], x[5]
        vx, vy, vz = x[6], x[7], x[8]
        wx, wy, wz = x[9], x[10], x[11]
        w0, w1, w2, w3 = (kf * u[i] for i in range(4))

        cr, sr = jnp.cos(r), jnp.sin(r)
        cp, sp = jnp.cos(p), jnp.sin(p)
        cy, sy = jnp.cos(y), jnp.sin(y)

        T = (w0 + w1 + w2 + w3) / mass
        ax = (cy * sp * cr + sy * sr) * T
        ay = (sy * sp * cr - cy * sr) * T
        az = cp * cr * T - gravity

        tx = arm * (w1 - w3)
        ty = arm * (w2 - w0)
        tz = km * (w0 - w1 + w2 - w3)
        wdx = (tx - (wy * Jz * wz - wz * Jy * wy)) / Jx
        wdy = (ty - (wz * Jx * wx - wx * Jz * wz)) / Jy
        wdz = (tz - (wx * Jy * wy - wy * Jx * wx)) / Jz

        tp = sp / cp
        rd = wx + sr * tp * wy + cr * tp * wz
        pd = cr * wy - sr * wz
        yd = (sr * wy + cr * wz) / cp

        return (vx, vy, vz, rd, pd, yd, ax, ay, az, wdx, wdy, wdz)

    return f

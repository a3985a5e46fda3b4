"""Planar-attitude 3D quadrotor (extra model; BASELINE.json's configs name
a quadrotor even though the reference's "scotty" fixture is a bicycle
path — see SURVEY §2.2).

State [pos(3), rpy(3), vel(3), omega(3)] with Euler roll-pitch-yaw
attitude; input = 4 rotor thrusts. Small-angle-free formulation using the
ZYX rotation matrix.

Design note: the model is written in SCALAR form — unpack the state into
scalar components, compute each derivative as a scalar expression, stack
once at the end — rather than composing [3, 3] rotation/rate matrices.
Under `vmap`, matrix-form intermediates become [B, 3, 3] arrays with
tiny trailing dims; the scalar form keeps every intermediate a dense
[B] array, and it is also what the column-form step of the tiled rollout
kernel needs (models/tile_steps.quadrotor_cols).

`quadrotor_jacobians` additionally provides the analytic continuous-time
(df/dx, df/du) in the same scalar form — an independent correctness
oracle for the model (tests/test_models_extra.py) and the right form for
host/native (CPU) solvers. The batched solver uses `jax.jacfwd` of the
scalar-form model, whose tangent axis fuses into the stage evaluations
instead of chaining batched 12x12 products through RK4.
"""

from __future__ import annotations

import jax.numpy as jnp


def quadrotor_continuous(mass=0.5, gravity=9.81, arm=0.1750, kf=1.0, km=0.0245,
                         inertia=(0.0023, 0.0023, 0.004)):
    Jx, Jy, Jz = inertia

    def f(x, u):
        # [pos(0:3), rpy(3:6), vel(6:9), omega(9:12)]
        r, p, y = x[3], x[4], x[5]
        vx, vy, vz = x[6], x[7], x[8]
        wx, wy, wz = x[9], x[10], x[11]
        w0, w1, w2, w3 = kf * u[0], kf * u[1], kf * u[2], kf * u[3]

        cr, sr = jnp.cos(r), jnp.sin(r)
        cp, sp = jnp.cos(p), jnp.sin(p)
        cy, sy = jnp.cos(y), jnp.sin(y)

        # acc = [0,0,-g] + R_zyx @ [0,0,T] / mass  (third column of R)
        T = (w0 + w1 + w2 + w3) / mass
        ax = (cy * sp * cr + sy * sr) * T
        ay = (sy * sp * cr - cy * sr) * T
        az = cp * cr * T - gravity

        # torque - omega x (J omega), J diagonal
        tx = arm * (w1 - w3)
        ty = arm * (w2 - w0)
        tz = km * (w0 - w1 + w2 - w3)
        wdx = (tx - (wy * Jz * wz - wz * Jy * wy)) / Jx
        wdy = (ty - (wz * Jx * wx - wx * Jz * wz)) / Jy
        wdz = (tz - (wx * Jy * wy - wy * Jx * wx)) / Jz

        # rpy_dot = E(r, p) @ omega (ZYX Euler rate matrix)
        tp = sp / cp
        rd = wx + sr * tp * wy + cr * tp * wz
        pd = cr * wy - sr * wz
        yd = (sr * wy + cr * wz) / cp

        return jnp.stack([vx, vy, vz, rd, pd, yd, ax, ay, az, wdx, wdy, wdz])

    return f


def quadrotor_jacobians(mass=0.5, gravity=9.81, arm=0.1750, kf=1.0, km=0.0245,
                        inertia=(0.0023, 0.0023, 0.004)):
    """Analytic continuous-time Jacobians (df/dx [12,12], df/du [12,4]) of
    `quadrotor_continuous` with the same parameters, in scalar form.

    Equal to jax.jacfwd of the model to roundoff; avoids the autodiff
    tangent axis (16 lanes of 128 used) in hot batched expansions.
    """
    Jx, Jy, Jz = inertia

    def jac(x, u):
        dt = x.dtype
        r, p, y = x[3], x[4], x[5]
        wx, wy, wz = x[9], x[10], x[11]
        w0, w1, w2, w3 = kf * u[0], kf * u[1], kf * u[2], kf * u[3]

        cr, sr = jnp.cos(r), jnp.sin(r)
        cp, sp = jnp.cos(p), jnp.sin(p)
        cy, sy = jnp.cos(y), jnp.sin(y)
        z = jnp.zeros_like(r)
        one = jnp.ones_like(r)

        T = (w0 + w1 + w2 + w3) / mass
        Tu = kf / mass  # dT/du_i

        # Rows 0..2: d(vel)/d(vel) = I
        # Rows 3..5: rpy_dot = [wx + sr tp wy + cr tp wz,
        #                       cr wy - sr wz,
        #                       (sr wy + cr wz) / cp]
        tp = sp / cp
        sec2 = 1.0 / (cp * cp)
        rd_r = (cr * tp) * wy + (-sr * tp) * wz
        rd_p = (sr * wy + cr * wz) * sec2
        pd_r = -sr * wy - cr * wz
        yd_r = (cr * wy - sr * wz) / cp
        yd_p = (sr * wy + cr * wz) * sp * sec2

        # Rows 6..8: acc
        ax_r = (-cy * sp * sr + sy * cr) * T
        ax_p = (cy * cp * cr) * T
        ax_y = (-sy * sp * cr + cy * sr) * T
        ay_r = (-sy * sp * sr - cy * cr) * T
        ay_p = (sy * cp * cr) * T
        ay_y = (cy * sp * cr + sy * sr) * T
        az_r = -cp * sr * T
        az_p = -sp * cr * T
        ax_u = (cy * sp * cr + sy * sr) * Tu
        ay_u = (sy * sp * cr - cy * sr) * Tu
        az_u = cp * cr * Tu

        # Rows 9..11: omega_dot
        wdx_wy = -(Jz - Jy) * wz / Jx
        wdx_wz = -(Jz - Jy) * wy / Jx
        wdy_wx = -(Jx - Jz) * wz / Jy
        wdy_wz = -(Jx - Jz) * wx / Jy
        wdz_wx = -(Jy - Jx) * wy / Jz
        wdz_wy = -(Jy - Jx) * wx / Jz

        def row(cols):
            out = [z] * 12
            for i, v in cols.items():
                out[i] = v
            return out

        A = [
            row({6: one}),
            row({7: one}),
            row({8: one}),
            row({3: rd_r, 4: rd_p, 9: one, 10: sr * tp, 11: cr * tp}),
            row({3: pd_r, 10: cr, 11: -sr}),
            row({3: yd_r, 4: yd_p, 10: sr / cp, 11: cr / cp}),
            row({3: ax_r, 4: ax_p, 5: ax_y}),
            row({3: ay_r, 4: ay_p, 5: ay_y}),
            row({3: az_r, 4: az_p}),
            row({10: wdx_wy, 11: wdx_wz}),
            row({9: wdy_wx, 11: wdy_wz}),
            row({9: wdz_wx, 10: wdz_wy}),
        ]

        zu = [z] * 4
        au = kf * arm
        B = [
            zu, zu, zu, zu, zu, zu,
            [ax_u, ax_u, ax_u, ax_u],
            [ay_u, ay_u, ay_u, ay_u],
            [az_u, az_u, az_u, az_u],
            [z, au / Jx * one, z, -au / Jx * one],
            [-au / Jy * one, z, au / Jy * one, z],
            [km * kf / Jz * one, -km * kf / Jz * one, km * kf / Jz * one,
             -km * kf / Jz * one],
        ]
        A = jnp.stack([jnp.stack(rw) for rw in A]).astype(dt)
        Bm = jnp.stack([jnp.stack(rw) for rw in B]).astype(dt)
        return A, Bm

    return jac

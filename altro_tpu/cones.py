"""Conic projections, Jacobians, and Hessian-vector Jacobians.

Batched re-design of the reference cone module
(/root/reference/src/altro/solver/cones.cpp:13-202): instead of the
reference's 3-way branch on the SOC region, every projection here is a
branchless `jnp.where` composition so it vmaps over knot points and batch
lanes and stays fusable under jit.

Supported cones (parity with reference `ConstraintType`,
/root/reference/src/altro/solver/typedefs.hpp:55):

  * ZERO            ("EQUALITY"):    K = {0}
  * IDENTITY        (free cone):     K = R^p
  * NEGATIVE_ORTHANT ("INEQUALITY"): K = {x : x <= 0}
  * SECOND_ORDER    : K = {(v, s) : ||v|| <= s}, s the LAST component

`project_hessian(cone, x, b)` is the Jacobian of x -> dP(x)^T b, the term
the Gauss-Newton AL Hessian needs for nonlinear cones
(/root/reference/src/altro/solver/cones.cpp:79-123).
"""

from __future__ import annotations

import enum

import jax.numpy as jnp

__all__ = [
    "Cone",
    "dual_cone",
    "cone_is_linear",
    "project",
    "project_jacobian",
    "project_hessian",
]


class Cone(enum.Enum):
    """Constraint cone tag. Static (Python-level) — not traced."""

    ZERO = "zero"  # equality constraints: c(x,u) = 0
    IDENTITY = "identity"  # free
    NEGATIVE_ORTHANT = "negative_orthant"  # inequality constraints: c(x,u) <= 0
    SECOND_ORDER = "second_order"  # ||c[:-1]|| <= c[-1]

    # Aliases matching the reference naming
    EQUALITY = "zero"
    INEQUALITY = "negative_orthant"


def dual_cone(cone: Cone) -> Cone:
    """Cone the estimated duals are projected into.

    Parity: /root/reference/src/altro/solver/cones.hpp:13-30.
    """
    return {
        Cone.ZERO: Cone.IDENTITY,
        Cone.IDENTITY: Cone.ZERO,
        Cone.NEGATIVE_ORTHANT: Cone.NEGATIVE_ORTHANT,
        Cone.SECOND_ORDER: Cone.SECOND_ORDER,
    }[cone]


def cone_is_linear(cone: Cone) -> bool:
    """True when the projection is piecewise linear (Hessian term vanishes).

    Parity: /root/reference/src/altro/solver/cones.hpp:32-49.
    """
    return cone is not Cone.SECOND_ORDER


def _soc_split(x: jnp.ndarray):
    v = x[:-1]
    s = x[-1]
    a = jnp.sqrt(jnp.sum(v * v))
    # Safe magnitude for the "outside the cone" formulas: when a == 0 the
    # point is either in the cone (s >= 0) or below it (s < 0), so the
    # outside branch is masked out and the placeholder 1.0 never leaks.
    a_safe = jnp.where(a > 0.0, a, 1.0)
    below = a <= -s
    inside = jnp.logical_and(jnp.logical_not(below), a <= s)
    outside = jnp.logical_not(jnp.logical_or(below, inside))
    return v, s, a, a_safe, below, inside, outside


def _soc_project(x: jnp.ndarray) -> jnp.ndarray:
    v, s, a, a_safe, below, inside, outside = _soc_split(x)
    c = 0.5 * (1.0 + s / a_safe)
    px_out = jnp.concatenate([c * v, (c * a)[None]])
    return jnp.where(below, 0.0, jnp.where(inside, x, px_out))


def _soc_project_jacobian(x: jnp.ndarray) -> jnp.ndarray:
    p = x.shape[0]
    v, s, a, a_safe, below, inside, outside = _soc_split(x)
    c = 0.5 * (1.0 + s / a_safe)
    eye_v = jnp.eye(p - 1, dtype=x.dtype)

    dv_dv = c * eye_v - (0.5 * s / a_safe**3) * jnp.outer(v, v)
    dv_ds = 0.5 * v / a_safe
    ds_dv = (-0.5 * s / a_safe**2 + c / a_safe) * v
    ds_ds = jnp.asarray(0.5, dtype=x.dtype)

    top = jnp.concatenate([dv_dv, dv_ds[:, None]], axis=1)
    bot = jnp.concatenate([ds_dv, ds_ds[None]])[None, :]
    jac_out = jnp.concatenate([top, bot], axis=0)

    eye = jnp.eye(p, dtype=x.dtype)
    return jnp.where(below, 0.0, jnp.where(inside, eye, jac_out))


def _soc_project_hessian(x: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Jacobian of x -> dP(x)^T b for the SOC (zero when in/below the cone).

    Vectorized form of the elementwise construction at
    /root/reference/src/altro/solver/cones.cpp:79-123; the v-v block is the
    symmetric combination

      [ -s/a^3 (h v^T + v h^T) ... ]  with  h = (I - vv^T/a^2) b_v
    """
    p = x.shape[0]
    v, s, a, a_safe, below, inside, outside = _soc_split(x)
    b_v = b[:-1]
    b_s = b[-1]
    vbv = jnp.sum(v * b_v)

    h = b_v - v * (vbv / a_safe**2)  # (I - vv^T/a^2) b_v
    eye_v = jnp.eye(p - 1, dtype=x.dtype)
    vvT = jnp.outer(v, v)

    block = (
        (-s / a_safe**3) * (jnp.outer(h, v) + jnp.outer(v, h))
        + (s * vbv / a_safe**5) * vvT
        - (s * vbv / a_safe**3) * eye_v
        + (b_s / a_safe) * (eye_v - vvT / a_safe**2)
    ) * 0.5
    border = h / (2.0 * a_safe)

    top = jnp.concatenate([block, border[:, None]], axis=1)
    bot = jnp.concatenate([border, jnp.zeros((1,), dtype=x.dtype)])[None, :]
    hess_out = jnp.concatenate([top, bot], axis=0)

    return jnp.where(outside, hess_out, 0.0)


def project(cone: Cone, x: jnp.ndarray) -> jnp.ndarray:
    """Projection P_K(x) onto the cone. x: [p]."""
    if cone is Cone.ZERO:
        return jnp.zeros_like(x)
    if cone is Cone.IDENTITY:
        return x
    if cone is Cone.NEGATIVE_ORTHANT:
        return jnp.minimum(x, 0.0)
    if cone is Cone.SECOND_ORDER:
        return _soc_project(x)
    raise ValueError(f"unknown cone {cone}")


def project_jacobian(cone: Cone, x: jnp.ndarray) -> jnp.ndarray:
    """Jacobian dP_K(x): [p, p]."""
    p = x.shape[0]
    if cone is Cone.ZERO:
        return jnp.zeros((p, p), dtype=x.dtype)
    if cone is Cone.IDENTITY:
        return jnp.eye(p, dtype=x.dtype)
    if cone is Cone.NEGATIVE_ORTHANT:
        return jnp.diag(jnp.where(x <= 0.0, 1.0, 0.0).astype(x.dtype))
    if cone is Cone.SECOND_ORDER:
        return _soc_project_jacobian(x)
    raise ValueError(f"unknown cone {cone}")


def project_hessian(cone: Cone, x: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Jacobian of x -> dP_K(x)^T b: [p, p]. Zero for all linear cones."""
    p = x.shape[0]
    if cone in (Cone.ZERO, Cone.IDENTITY, Cone.NEGATIVE_ORTHANT):
        return jnp.zeros((p, p), dtype=x.dtype)
    if cone is Cone.SECOND_ORDER:
        return _soc_project_hessian(x, b)
    raise ValueError(f"unknown cone {cone}")

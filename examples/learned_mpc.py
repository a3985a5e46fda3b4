"""Learning cost weights THROUGH the solver (differentiable MPC).

`altro_tpu.implicit_solve` makes problem -> (x*, u*) reverse-mode
differentiable by implicit differentiation of the solver's fixed point
(one extra TVLQR pass per backward — see altro_tpu/diff.py). Here we
tune a controller's diagonal cost weights by plain gradient descent on a
TASK loss that is different from the controller's own objective: the
task charges much more for terminal error than the initial controller
cost does, so the learned weights tighten the controller.

This capability has no analog in the reference (its problem data live
behind raw-pointer callbacks, typedefs.hpp:31-53).

    python examples/learned_mpc.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

from altro_tpu.diff import implicit_solve
from altro_tpu.models.double_integrator import double_integrator_dynamics
from altro_tpu.options import SolverOptions
from altro_tpu.problem import DiagonalCost, Problem


def build_problem(log_weights, N=20, h=0.1, dtype=jnp.float64):
    """Controller cost from learnable log-weights [log qx, log qv, log r]."""
    n, m = 4, 2
    qx, qv, r_w = jnp.exp(log_weights[0]), jnp.exp(log_weights[1]), jnp.exp(log_weights[2])
    Qrow = jnp.stack([qx, qx, qv, qv])
    Q = jnp.tile(Qrow, (N + 1, 1))
    R = jnp.tile(jnp.stack([r_w, r_w]), (N + 1, 1))
    return Problem(
        N=N, n=n, m=m,
        dynamics=double_integrator_dynamics(), dynamics_jac=None,
        constraints=(),
        cost=DiagonalCost(Q=Q, R=R, q=jnp.zeros((N + 1, n), dtype),
                          r=jnp.zeros((N + 1, m), dtype), c=jnp.zeros((N + 1,), dtype)),
        h=jnp.full((N,), h, dtype),
        x0=jnp.asarray([2.0, -1.5, 0.0, 0.0], dtype),
    )


def task_loss(log_weights):
    """What we actually care about: terminal accuracy + mild effort."""
    x, u = implicit_solve(build_problem(log_weights))
    return 100.0 * jnp.sum(x[-1] ** 2) + 0.05 * jnp.sum(u**2)


def main():
    import optax

    theta = jnp.log(jnp.asarray([1.0, 1.0, 1.0]))
    loss_and_grad = jax.jit(jax.value_and_grad(task_loss))
    opt = optax.adam(0.1)
    opt_state = opt.init(theta)
    print("step  task-loss   weights (qx, qv, r)")
    for step in range(40):
        loss, g = loss_and_grad(theta)
        if step % 5 == 0 or step == 39:
            w = np.exp(np.asarray(theta))
            print(f"{step:4d}  {float(loss):9.4f}   {w.round(4)}")
        updates, opt_state = opt.update(g, opt_state)
        theta = optax.apply_updates(theta, updates)
    final = float(loss_and_grad(theta)[0])
    initial = float(task_loss(jnp.log(jnp.asarray([1.0, 1.0, 1.0]))))
    print(f"task loss {initial:.4f} -> {final:.4f} "
          f"({100 * (1 - final / initial):.1f}% better) by descending through the solver")


if __name__ == "__main__":
    main()

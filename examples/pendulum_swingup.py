"""Pendulum swing-up: the canonical single-solve example.

Mirrors the reference's pendulum test problem
(/root/reference/test/pendulum_test.cpp) through the stateful API.

    python examples/pendulum_swingup.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from altro_tpu import ALTROSolver, Cone, SolverOptions, Verbosity
from altro_tpu.models import midpoint, pendulum_continuous


def main():
    N, n, m = 50, 2, 1
    tf = 3.0
    xf = np.array([np.pi, 0.0])

    solver = ALTROSolver(N)
    solver.set_dimension(n, m)
    solver.set_time_step(tf / N)
    solver.set_explicit_dynamics(midpoint(pendulum_continuous()))
    solver.set_lqr_cost(np.full(n, 1e-2), np.full(m, 1e-3), xf, np.zeros(m), 0, N)
    solver.set_lqr_cost(np.ones(n), np.full(m, 1e-3), xf, np.zeros(m), N)
    solver.set_initial_state(np.zeros(n))
    solver.set_options(SolverOptions(iterations_max=20, verbose=Verbosity.INNER))
    solver.initialize()
    solver.set_input([0.1])

    status = solver.solve()
    print(f"status       = {status.name}")
    print(f"iterations   = {solver.get_iterations()}")
    print(f"objective    = {solver.get_final_objective():.6f}")
    print(f"solve time   = {solver.get_solve_time_ms():.1f} ms (includes compile)")
    print(f"terminal x   = {solver.get_state(N)}  (target {xf})")


if __name__ == "__main__":
    main()

"""True multi-process distributed smoke test on the CPU backend.

Launches NPROC processes, each with 4 virtual CPU devices, connected via
jax.distributed.initialize over localhost — the same mechanism a real
multi-host deployment uses (coordinator + a global mesh). Each process
holds its shard of a batched tracking solve; process 0 checks the
cross-process reduced aggregate stats.

Usage: python scripts/test_multihost.py            (parent; spawns workers)
"""

import os
import subprocess
import sys

NPROC = 2
PORT = 9976


def worker(pid: int):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}", num_processes=NPROC, process_id=pid
    )
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    from test_solver_double_integrator import NX, goal_constraint, make_problem

    from altro_tpu.options import SolverOptions
    from altro_tpu.parallel.batch import batch_init_state
    from altro_tpu.parallel.mesh import make_mesh, sharded_tracking_solver

    assert jax.device_count() == 4 * NPROC, jax.device_count()
    assert jax.process_count() == NPROC

    problem = make_problem([1.0, 2.0, 0.0, 0.0], (goal_constraint(np.zeros(NX)),))
    opts = SolverOptions(penalty_scaling=100.0)
    B = 8  # one lane per global device
    mesh = make_mesh()  # all global devices
    runner = sharded_tracking_solver(problem, mesh, opts)

    # Build global arrays from host-local shards
    from jax.sharding import NamedSharding, PartitionSpec as P

    def make_global(arr_fn, shape):
        sharding = NamedSharding(mesh, P("batch"))
        return jax.make_array_from_callback(
            shape, sharding, lambda idx: np.asarray(arr_fn()[idx])
        )

    base = np.asarray([1.0, 2.0, 0.0, 0.0])
    x0_np = base[None, :] + np.linspace(-0.5, 0.5, B)[:, None] * np.array([1.0, -1.0, 0, 0])
    x0 = make_global(lambda: x0_np, (B, NX))
    q_np = np.zeros((B, problem.N + 1, NX))
    c_np = np.zeros((B, problem.N + 1))
    q = make_global(lambda: q_np, q_np.shape)
    c = make_global(lambda: c_np, c_np.shape)
    states_local = batch_init_state(problem, B)
    states = jax.tree.map(
        lambda a: make_global(lambda a=a: np.asarray(a), a.shape), states_local
    )

    u0, out_states, stats, agg = runner(x0, q, c, states)
    num_success = int(agg["num_success"])
    if pid == 0:
        assert num_success == B, f"expected {B} successes, got {num_success}"
        print(f"MULTIHOST_OK processes={NPROC} devices={jax.device_count()} successes={num_success}")


def main():
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]))
        return
    procs = [
        subprocess.Popen([sys.executable, __file__, "--worker", str(i)])
        for i in range(NPROC)
    ]
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        raise SystemExit(f"worker failures: {codes}")
    print("multihost smoke test passed")


if __name__ == "__main__":
    main()

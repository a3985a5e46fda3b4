"""chip_smoke.py and bench.py on the CPU: their phase functions at tiny
sizes (kernels in the Pallas interpreter, exports lowered for the CPU),
with the device assertion left out — and the device assertion itself,
which must refuse the CPU."""

import json
import subprocess
import sys

import jax
import pytest

import bench
import chip_smoke


def test_device_phase_refuses_the_cpu():
    with pytest.raises(AssertionError, match="no GPU"):
        chip_smoke.phase_device()


def test_relerr_is_normwise():
    assert chip_smoke.relerr([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert chip_smoke.relerr([1.0, 2.1], [1.0, 2.0]) == pytest.approx(0.05)


def test_kernel_parity_phase_interpreted():
    rows = chip_smoke.phase_kernel_parity(
        backward_cases=[(1024, 4, 2, True), (1024, 4, 2, False),
                        (1024, 12, 4, True)],
        rollout_cases=[(1024, 4, 2)], N=3, interpret=True)
    assert [r["impl"] for r in rows] == [
        "pallas-triton", "pallas-triton", "xla-twin", "pallas-triton"]
    for r in rows:
        assert max(r["max_rel_err"].values()) <= chip_smoke.KERNEL_RTOL


def test_single_solve_phase_small():
    """Facade + functional pendulum swing-up, the Scotty long-horizon
    solve (cut to N=100) and the exported single-controller server."""
    chip_smoke.phase_single_solve(N_pendulum=50, N_long=100,
                                  platforms=("cpu",))


def test_multi_phase_on_virtual_devices():
    """The four-card path on this process's virtual CPU devices."""
    assert len(jax.devices()) >= 4
    chip_smoke.phase_multi(lanes_per_card=2, ticks=2, N_horizon=15)


def test_gpu_info_is_none_without_a_card():
    assert bench.gpu_info() is None


def test_bench_refuses_to_run_without_a_gpu(tmp_path):
    """No GPU and no explicit CPU request: exit 2, no result."""
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    res = subprocess.run([sys.executable, "bench.py"], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == bench.EXIT_NO_DEVICE
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "error" in out and out["platform"] == "cpu"
    assert "value" not in out


def test_bench_headline_small_on_cpu():
    """bench.run_headline through the vmap path at a tiny batch: gates
    computed, result keys present."""
    r = bench.run_headline(B=8, NSIM=2)
    assert r["gates_passed"], r.get("error")
    assert r["tiled"] is False and r["batch"] == 8
    assert r["per_tick_ms"] > 0 and r["success_rate"] == 1.0

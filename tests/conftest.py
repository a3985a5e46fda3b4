"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

The correctness suite mirrors the reference's float64 golden values, so it
runs in x64 mode on the CPU backend. Sharding tests use the 8 virtual CPU
devices.

Tests marked `gpu` compile kernels for the card and need one: they skip
here with a reason, and run on a machine with a GPU with

    ALTRO_GPU_TESTS=1 python -m pytest tests/gpu -q -n 0

(one process: a JAX process reserves most of the card's memory). With
ALTRO_GPU_TESTS=1 the session keeps JAX's default (GPU) backend in f32.
"""

import os

import pytest

os.environ.setdefault("ALTRO_SCAN_UNROLL", "1")  # fast compiles; perf-neutral for correctness

GPU_MODE = os.environ.get("ALTRO_GPU_TESTS") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not GPU_MODE and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

from altro_tpu.compile_cache import enable_compile_cache

if not GPU_MODE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
# Persistent compile cache: repeat suite runs skip XLA compilation.
enable_compile_cache(min_compile_time_secs=0.5)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless a GPU backs this session, and the
    CPU suite in a GPU session — decided per test, never while modules
    are collected."""
    if request.node.get_closest_marker("gpu") is None:
        if GPU_MODE:
            pytest.skip("ALTRO_GPU_TESTS=1 runs only the gpu-marked subset")
        return
    if not GPU_MODE or jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run ALTRO_GPU_TESTS=1 pytest tests/gpu -n 0 "
                    "on a machine with one")


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Route solve_tiled's kernel choice to the GPU kernels run in the
    Pallas interpreter, so the CPU exercises the kernel path end to end."""
    import functools

    from altro_tpu import tile_solver
    from altro_tpu.ops.pallas_riccati import riccati_backward_pallas_tiled
    from altro_tpu.ops.pallas_rollout_tiled import rollout_grid_pallas_tiled

    kernels = tile_solver.TiledKernels(
        functools.partial(riccati_backward_pallas_tiled, interpret=True),
        functools.partial(rollout_grid_pallas_tiled, interpret=True),
    )
    monkeypatch.setattr(tile_solver, "select_kernels",
                        lambda platform, dtype, n: kernels)
    return kernels


_last_module = [None]


def pytest_runtest_logstart(nodeid, location):
    """Bound vm map usage (vm.max_map_count default 65530).

    Every XLA-CPU executable JIT-maps ~hundreds of anonymous segment
    triples (measured: one jitted `solve` ~600 maps, device count nearly
    irrelevant), and jax holds every compiled executable for the process
    lifetime — an unbounded full-suite run climbs past the 65530 map
    limit and the NEXT LLVM JIT mmap fails, segfaulting the interpreter
    (observed repeatedly at ~65.2k maps, both in
    backend_compile_and_load and in the persistent-cache executable-
    deserialization path, while the same tests pass in isolation).

    Two mechanisms keep usage structurally bounded:
      * proactive hygiene: at each test-MODULE boundary with >25k maps,
        drop the executable caches (jax.clear_caches + gc: 6058 -> 530
        maps, measured). Executables are rarely shared across modules,
        so this costs almost nothing and keeps the count far from the
        limit;
      * emergency guard at 40k maps mid-module (should never fire with
        the module-boundary hygiene in place).

    ALTRO_TRACE_MAPS=1 additionally logs the per-test map count (plus a
    CLEAR marker at each cache drop).
    """
    import gc
    import os

    with open("/proc/self/maps") as f:
        n = sum(1 for _ in f)
    module = nodeid.split("::", 1)[0]
    module_boundary = module != _last_module[0]
    _last_module[0] = module
    cleared = ""
    if (module_boundary and n > 25000) or n > 40000:
        import jax

        jax.clear_caches()
        gc.collect()
        cleared = "\tCLEAR-module" if module_boundary else "\tCLEAR-EMERGENCY"
    if os.environ.get("ALTRO_TRACE_MAPS") == "1":
        with open("/tmp/altro_maps.log", "a") as f:
            f.write(f"{n}\t{nodeid}{cleared}\n")

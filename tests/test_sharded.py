"""Sharded (multi-device) engine vs the single-device engine, on the
8-virtual-CPU-device mesh — the formalized equivalent of the reference's
empirical MPI validation (SURVEY.md section 4 'Implication for the build').
"""

import jax
import numpy as np
import pytest

from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.parallel import sharded


@pytest.fixture
def cfg8():
    # nx divisible by 8 devices, each shard >= 2 rows
    return LatticeConfig(nx=32, ny=48, dtype=np.float64)


@pytest.fixture
def walls8(cfg8):
    w = geometry.channel(cfg8.nx, cfg8.ny)
    w[10:20, 12:15] = True
    return w


def test_mesh_uses_all_devices():
    mesh = sharded.make_mesh()
    assert mesh.devices.size == 8


@pytest.mark.parametrize("backend", ["sharded", "sharded-sync"])
def test_sharded_matches_unsharded_bitwise(cfg8, walls8, backend):
    """Row-decomposed run must equal the single-device run bitwise —
    halo exchange is semantically invisible."""
    ref = Simulation(cfg8, walls8, backend="xla").run(10).state()
    out = Simulation(cfg8, walls8, backend=backend).run(10).state()
    np.testing.assert_array_equal(out, ref)


def test_overlap_equals_sync(cfg8, walls8):
    a = Simulation(cfg8, walls8, backend="sharded").run(7).state()
    b = Simulation(cfg8, walls8, backend="sharded-sync").run(7).state()
    np.testing.assert_array_equal(a, b)


def test_sharded_tracks_golden(cfg8, walls8):
    """End-to-end: sharded f64 vs the NumPy oracle (ulp-level, jit FMA)."""
    sim = Simulation(cfg8, walls8, backend="sharded")
    sim.run(20)
    ref = golden.run(golden.initial_state(cfg8), walls8, cfg8, 20)
    np.testing.assert_allclose(sim.state(), ref, rtol=1e-13, atol=1e-18)


def test_sharded_f32(cfg8, walls8):
    cfg = LatticeConfig(nx=cfg8.nx, ny=cfg8.ny, dtype=np.float32)
    ref = Simulation(cfg, walls8, backend="xla").run(10).state()
    out = Simulation(cfg, walls8, backend="sharded").run(10).state()
    np.testing.assert_array_equal(out, ref)


def test_sharded_small_mesh(cfg8, walls8):
    """2-device mesh (uneven vs 8) also matches."""
    mesh = sharded.make_mesh(2)
    run = sharded.make_backend(mesh)
    import jax.numpy as jnp
    from latticeboltzmann_tpu.models.engine import initial_state

    f = jnp.asarray(initial_state(cfg8))
    out = run(f, jnp.asarray(walls8), cfg8, 6)
    ref = Simulation(cfg8, walls8, backend="xla").run(6).state()
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_halo_exchange_communicates_across_boundary(cfg8):
    """A packet crossing a shard boundary must arrive intact: empty box,
    huge tau (no collision), f2 (+x) packet at the last row of shard 0."""
    cfg = LatticeConfig(nx=32, ny=48, dtype=np.float64, tau=1e12, accel=0.0)
    walls = geometry.empty(cfg.nx, cfg.ny)
    from latticeboltzmann_tpu.models.engine import initial_state
    import jax.numpy as jnp

    f = initial_state(cfg)
    shard_rows = cfg.nx // 8
    f[2, shard_rows - 1, 5] += 1.0  # last row of device 0
    sim = Simulation(cfg, walls, backend="sharded", f0=f)
    sim.run(1)
    out = sim.state()
    # the packet moved +x into device 1's first row
    assert out[2, shard_rows, 5] > 1.0


def test_dryrun_multichip_inline():
    """The driver's multi-chip gate, inline: under the conftest's 8
    virtual CPU devices dryrun_multichip must run in-process and pass
    (it re-execs itself in a forced-CPU subprocess only when the ambient
    backend can't provide the mesh)."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dryrun_multichip_driver_subprocess():
    """The EXACT driver-gate path: a fresh process WITHOUT the conftest's
    forced-CPU env calls dryrun_multichip(8), which must re-exec itself
    under __graft_entry__.forced_cpu_env. Round 4 shipped a regression
    precisely because no test ran this path: the suite passed under
    conftest's flags (which carried --xla_cpu_max_isa=AVX) while the
    dryrun subprocess env missed that flag and the ds64 leg's
    df64.check_backend correctly rejected the FMA-contracting backend."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {
        "PATH": "/usr/bin:/bin:/usr/local/bin",
        "HOME": "/root",
        # the suite's persistent compilation cache (conftest sets the
        # same dir in-process); forced_cpu_env passes it through to the
        # nested dryrun subprocess, keeping this test fast when warm
        "JAX_COMPILATION_CACHE_DIR": str(repo / ".jax_cache"),
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0.5",
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "-1",
        "TF_CPP_MIN_LOG_LEVEL": os.environ.get("TF_CPP_MIN_LOG_LEVEL", "3"),
        # deliberately NO JAX_PLATFORMS / XLA_FLAGS: the driver's ambient
        # env doesn't force CPU either — dryrun_multichip must do it
    }
    code = "import __graft_entry__ as g; g.dryrun_multichip(8); print('DRYRUN_OK')"
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env, cwd=str(repo), capture_output=True, text=True, timeout=1500,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DRYRUN_OK" in proc.stdout


def test_sharded_bf16_matches_unsharded(cfg8, walls8):
    """bf16 storage through the sharded XLA backend: computes in f32
    per the mixed-precision contract (ops.collide expects compute-dtype
    inputs — raw bf16 operands would promote the scan carry to f32 and
    fail to trace, and would skip the storage-precision rounding)."""
    import jax.numpy as jnp

    cfg = LatticeConfig(nx=cfg8.nx, ny=cfg8.ny, dtype=jnp.bfloat16)
    ref = Simulation(cfg, walls8, backend="xla").run(10).state()
    out = Simulation(cfg, walls8, backend="sharded").run(10).state()
    np.testing.assert_array_equal(
        np.asarray(out, np.float32), np.asarray(ref, np.float32)
    )

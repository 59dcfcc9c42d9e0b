"""XLA engine vs golden NumPy oracle.

Numerics contract (SURVEY.md 2.3): the golden model reproduces the
reference's serial double build exactly. The JAX ops evaluated *eagerly*
are bitwise identical to the golden model at float64 — proving the math
is the same operation-for-operation. Under jit, XLA/LLVM contracts
multiply-add chains into FMAs (a 1-ulp effect), so jitted float64 runs
are compared at tight ulp-level tolerances, and float32 runs at
accumulation tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.ops import stream_collide as ops


def _golden_run(cfg64, walls, n):
    f = golden.initial_state(cfg64)
    return golden.run(f, walls, cfg64, n)


def test_f64_bitwise_parity_eager(small_cfg, small_walls):
    """Eager (un-jitted) JAX ops must match the golden model bitwise:
    identical association order, no contraction."""
    wj = jnp.asarray(small_walls)
    f = jnp.asarray(golden.initial_state(small_cfg))
    g = golden.initial_state(small_cfg)
    for _ in range(5):
        f = ops.step(f, wj, small_cfg)
        g = golden.step(g, small_walls, small_cfg)
    np.testing.assert_array_equal(np.asarray(f), g)


def test_f64_substeps_bitwise(small_cfg, small_walls):
    wj = jnp.asarray(small_walls)
    g0 = golden.initial_state(small_cfg)
    g1 = golden.apply_source(g0, small_walls, small_cfg)
    x1 = np.asarray(ops.apply_source(jnp.asarray(g0), wj, small_cfg))
    np.testing.assert_array_equal(x1, g1)
    gp = golden.pull(g1)
    xp = np.asarray(ops.pull(jnp.asarray(g1)))
    np.testing.assert_array_equal(xp, gp)
    gc = golden.collide(gp, small_cfg)
    xc = np.asarray(ops.collide(jnp.asarray(gp), small_cfg))
    np.testing.assert_array_equal(xc, gc)


@pytest.mark.parametrize("n_steps", [1, 50])
def test_f64_jitted_ulp_parity(small_cfg, small_walls, n_steps):
    """Jitted runs may differ from the oracle only by FMA-contraction
    noise: tiny relative error even after many steps."""
    sim = Simulation(small_cfg, small_walls, backend="xla")
    sim.run(n_steps)
    ref = _golden_run(small_cfg, small_walls, n_steps)
    np.testing.assert_allclose(sim.state(), ref, rtol=1e-13, atol=1e-18)


def test_f64_parity_empty_and_cylinder_geometries():
    for geo in ("empty", "cylinder"):
        cfg = LatticeConfig(nx=20, ny=36, dtype=np.float64)
        walls = geometry.build(geo, cfg.nx, cfg.ny)
        sim = Simulation(cfg, walls, backend="xla")
        sim.run(8)
        ref = _golden_run(cfg, walls, 8)
        np.testing.assert_allclose(sim.state(), ref, rtol=1e-13, atol=1e-18)


def test_f32_tracks_golden(small_cfg, small_walls):
    cfg32 = LatticeConfig(nx=small_cfg.nx, ny=small_cfg.ny, dtype=np.float32)
    sim = Simulation(cfg32, small_walls, backend="xla")
    sim.run(50)
    ref = _golden_run(small_cfg, small_walls, 50)
    np.testing.assert_allclose(sim.state(), ref, rtol=0, atol=5e-5)


def test_reynolds_parity(small_cfg, small_walls):
    sim = Simulation(small_cfg, small_walls, backend="xla")
    sim.run(40)
    ref_f = _golden_run(small_cfg, small_walls, 40)
    re_ref = golden.reynolds(ref_f, small_walls, small_cfg)
    assert abs(sim.reynolds() - re_ref) < 1e-11


def test_macroscopic_parity(small_cfg, small_walls):
    sim = Simulation(small_cfg, small_walls, backend="xla")
    sim.run(20)
    rho_g, ux_g, uy_g = golden.macroscopic(_golden_run(small_cfg, small_walls, 20))
    rho, ux, uy = sim.macroscopic()
    np.testing.assert_allclose(rho, rho_g, rtol=1e-13)
    np.testing.assert_allclose(ux, ux_g, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(uy, uy_g, rtol=1e-10, atol=1e-14)


def test_forcing_guard_engages():
    """Drive with a huge accel so the non-negativity guard must freeze the
    source column (all-or-nothing, src/latticeboltzmann.c:500-513)."""
    cfg = LatticeConfig(nx=10, ny=12, dtype=np.float64, accel=10.0)
    walls = geometry.channel(cfg.nx, cfg.ny)
    f0 = golden.initial_state(cfg)
    f_x = np.asarray(ops.apply_source(jnp.asarray(f0), jnp.asarray(walls), cfg))
    f_g = golden.apply_source(f0, walls, cfg)
    np.testing.assert_array_equal(f_x, f_g)
    # the guard must have blocked the update entirely (f3 would go negative)
    np.testing.assert_array_equal(f_x, f0)


def test_invariants_under_xla(small_cfg, small_walls):
    cfg32 = LatticeConfig(nx=small_cfg.nx, ny=small_cfg.ny, dtype=np.float32)
    sim = Simulation(cfg32, small_walls, backend="xla")
    sim.run(100)
    f = sim.state()
    assert np.isfinite(f).all()
    assert (f >= 0).all()


def test_odd_ny_remainder_shapes():
    """Non-multiple-of-anything shapes (the reference's NYVECMAX scalar
    cleanup territory, src/latticeboltzmann.c:74-76) must work and match."""
    cfg = LatticeConfig(nx=13, ny=37, dtype=np.float64)
    walls = geometry.channel(cfg.nx, cfg.ny)
    sim = Simulation(cfg, walls, backend="xla")
    sim.run(6)
    ref = _golden_run(cfg, walls, 6)
    np.testing.assert_allclose(sim.state(), ref, rtol=1e-13, atol=1e-18)


def test_bf16_storage_computes_in_f32():
    """bf16 is a STORAGE precision on every backend: the XLA engine must
    compute in f32 and round back, like the Pallas kernel. A pure-bf16
    engine measured 68% mass drift and max|u| 0.49 within 900 steps on
    a 64x2400 channel — bf16 cannot carry the relaxation's
    near-cancellations. Regression: mass stays conserved to bf16
    resolution and the flow stays subsonic-scale over a few hundred
    steps, and a column beyond the kinetic front keeps EXACT opposite-
    pair symmetry: the rounded rest state settles to a fixed point of
    round(relax(.)) whose symmetric pairs stay bitwise equal, so u_y
    there is exactly 0.0 — the explanation of a 4000x16000 bf16 run's
    Re = 0.0 at ny/2 (its probe column sees only a sub-quantum kinetic
    precursor; bench_suite also reports a reached column's Reynolds)."""
    cfg = LatticeConfig(nx=16, ny=700, dtype=jnp.bfloat16)
    walls = geometry.channel(cfg.nx, cfg.ny)
    sim = Simulation(cfg, walls, backend="xla")
    sim.run(250)
    f = np.asarray(sim.state(), np.float64)
    rho = f.sum(axis=0)
    assert np.isfinite(f).all() and (f >= 0).all()
    assert abs(rho.mean() / cfg.initial_density - 1) < 0.01
    u = np.abs(f[1] + f[5] + f[8] - f[3] - f[6] - f[7]) / rho
    assert u.max() < 0.2
    # beyond the kinetic front from BOTH ends (the wrap carries the
    # column-0 signal backward too): columns (250, 450) are unreached
    far = f[:, :, 300:440]
    uy_far = far[1] + far[5] + far[8] - far[3] - far[6] - far[7]
    np.testing.assert_array_equal(uy_far, np.zeros_like(uy_far))
    assert float(sim.reynolds(350)) == 0.0

"""Free-slip (specular reflection) boundary condition.

The reference names a "reflect" BC as a concept but never implements it
(src/latticeboltzmann.c:21); this framework provides it as slip_x/slip_y
masks. Tests: reflection-table algebra, golden<->XLA parity, mass
conservation, the physical slip invariant (uniform tangential flow past a
slip wall is undisturbed), and that a slip channel develops a flat (plug)
profile where a bounce-back channel develops a sheared one.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu.core.spec import E, NSPEEDS, REFLECT_X, REFLECT_Y, W
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.ops import stream_collide as xla_ops


def test_reflect_tables_are_involutions_mirroring_e():
    for table, axis in ((REFLECT_X, 0), (REFLECT_Y, 1)):
        assert (table[table] == np.arange(NSPEEDS)).all()
        mirrored = E.copy()
        mirrored[:, axis] = -mirrored[:, axis]
        assert (E[table] == mirrored).all()
        # specular reflection maps speeds of equal weight
        assert (W[table] == W).all()


def _equilibrium_uniform_flow(cfg, rho, u_x, u_y):
    """feq for a uniform (rho, u) flow, golden association order."""
    f = np.empty((NSPEEDS, cfg.nx, cfg.ny), dtype=np.float64)
    u = [0.0, u_y, u_x, -u_y, -u_x, u_x + u_y, u_x - u_y, -u_x - u_y, -u_x + u_y]
    uu = u_x * u_x + u_y * u_y
    for s in range(NSPEEDS):
        f[s] = W[s] * rho * (1.0 + 3.0 * u[s] + 4.5 * u[s] * u[s] - 1.5 * uu)
    return f


def test_uniform_tangential_flow_preserved_by_slip_wall():
    """A uniform u_y flow parallel to slip walls at i=0, NX-1 must be a
    fixed point: specular reflection preserves tangential momentum, so
    the wall is invisible to the flow (unlike bounce-back)."""
    cfg = LatticeConfig(nx=10, ny=16, dtype=np.float64, accel=0.0)
    walls = geometry.empty(cfg.nx, cfg.ny)
    slip_x = geometry.channel(cfg.nx, cfg.ny)
    f = _equilibrium_uniform_flow(cfg, rho=0.1, u_x=0.0, u_y=0.05)
    f2 = golden.run(f, walls, cfg, 5, slip_x=slip_x)
    fluid = ~slip_x
    _, _, uy = golden.macroscopic(f2)
    np.testing.assert_allclose(uy[fluid], 0.05, rtol=0, atol=1e-13)
    # bounce-back walls, by contrast, shear the near-wall flow
    f3 = golden.run(f.copy(), slip_x, cfg, 5)
    _, _, uy3 = golden.macroscopic(f3)
    assert abs(uy3[1] - 0.05).max() > 1e-4


def test_slip_conserves_mass():
    cfg = LatticeConfig(nx=12, ny=20, dtype=np.float64, accel=0.0)
    walls = geometry.empty(cfg.nx, cfg.ny)
    walls[5:7, 8:10] = True
    slip_x = geometry.channel(cfg.nx, cfg.ny)
    rng = np.random.default_rng(0)
    f = golden.initial_state(cfg) * (1.0 + 0.01 * rng.random((NSPEEDS, cfg.nx, cfg.ny)))
    total0 = f.sum()
    f = golden.run(f, walls, cfg, 10, slip_x=slip_x)
    np.testing.assert_allclose(f.sum(), total0, rtol=1e-13)


def test_golden_vs_xla_slip_parity(small_cfg):
    """XLA slip path matches the golden model at float64 to ~ULP level.
    (Not bitwise: inserting the slip selects shifts XLA's CPU fusion
    boundaries and with them FMA contraction, unlike the slip-free graph
    which is pinned bitwise in test_xla_parity.py.)"""
    cfg = small_cfg
    walls = geometry.empty(cfg.nx, cfg.ny)
    walls[8:14, 10:13] = True
    slip_x = geometry.channel(cfg.nx, cfg.ny)
    slip_y = geometry.empty(cfg.nx, cfg.ny)
    slip_y[:, 20] = True
    slip_y &= ~(walls | slip_x)
    f = golden.initial_state(cfg)
    ref = golden.run(f.copy(), walls, cfg, 8, slip_x=slip_x, slip_y=slip_y)
    got = xla_ops.run_steps(
        jnp.asarray(f), jnp.asarray(walls), cfg, 8,
        jnp.asarray(slip_x), jnp.asarray(slip_y),
    )
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-13)


def test_slip_channel_develops_plug_flow():
    """Forced channel with slip walls: interior u_y profile stays flat
    (free-slip = no wall drag); with bounce-back the same profile is
    sheared toward zero at the walls."""
    cfg = LatticeConfig(nx=16, ny=32, dtype=np.float64)
    edges = geometry.channel(cfg.nx, cfg.ny)
    nowalls = geometry.empty(cfg.nx, cfg.ny)

    slip_sim = Simulation(cfg, nowalls, backend="xla", slip_x=edges)
    slip_sim.run(300)
    _, _, uy_slip = slip_sim.macroscopic()

    bb_sim = Simulation(cfg, edges, backend="xla")
    bb_sim.run(300)
    _, _, uy_bb = bb_sim.macroscopic()

    j = cfg.ny // 2
    prof_slip = uy_slip[1:-1, j]
    prof_bb = uy_bb[1:-1, j]
    assert prof_slip.mean() > 0  # flow developed
    # plug flow: small relative spread (startup transients leave ~2%);
    # bounce-back: strongly sheared toward zero at the walls (>100%)
    spread_slip = np.ptp(prof_slip) / prof_slip.mean()
    spread_bb = np.ptp(prof_bb) / prof_bb.mean()
    assert spread_slip < 0.05
    assert spread_bb > 0.5
    assert spread_slip < spread_bb / 10


def _slip_scene(nx, ny, dtype):
    """Mixed scene exercising all three solid classes at once."""
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
    walls = geometry.empty(nx, ny)
    walls[nx // 3 : nx // 3 + 4, ny // 4 : ny // 4 + 3] = True
    slip_x = geometry.channel(nx, ny)
    slip_y = geometry.empty(nx, ny)
    slip_y[:, 2 * ny // 3] = True
    slip_y &= ~(walls | slip_x)
    return cfg, walls, slip_x, slip_y


@pytest.mark.parametrize("backend", ["pallas-interpret", "sharded", "sharded-sync"])
def test_slip_backend_parity(backend):
    """Free-slip on every backend matches the xla path on a scene with
    bounce-back walls + slip_x channel edges + a slip_y column (solid
    classes wall / slip_x / slip_y in one run)."""
    cfg, walls, slip_x, slip_y = _slip_scene(64, 128, np.float32)
    ref = Simulation(cfg, walls, backend="xla", slip_x=slip_x, slip_y=slip_y)
    ref.run(6)
    got = Simulation(cfg, walls, backend=backend, slip_x=slip_x, slip_y=slip_y)
    got.run(6)
    np.testing.assert_allclose(got.state(), ref.state(), rtol=1e-5, atol=1e-7)
    # and the slip wall actually behaves as slip (plug, not sheared):
    # compare against a bounce-back run of the same backend
    bb = Simulation(cfg, walls | np.asarray(slip_x), backend=backend)
    bb.run(6)
    assert np.abs(got.state() - bb.state()).max() > 1e-6


def test_slip_golden_vs_pallas_kernel_f64_semantics():
    """The kernel's slip selects agree with the golden model: run the
    interpret kernel at f32 against a float64 golden run rounded to f32
    — catches class-code mix-ups that tolerance-vs-xla might mask."""
    cfg, walls, slip_x, slip_y = _slip_scene(32, 64, np.float32)
    cfg64 = LatticeConfig(nx=cfg.nx, ny=cfg.ny, dtype=np.float64)
    f0 = golden.initial_state(cfg64)
    ref = golden.run(f0.copy(), walls, cfg64, 6, slip_x=slip_x, slip_y=slip_y)
    sim = Simulation(cfg, walls, backend="pallas-interpret",
                     slip_x=slip_x, slip_y=slip_y,
                     f0=f0.astype(np.float32))
    sim.run(6)
    np.testing.assert_allclose(sim.state(), ref.astype(np.float32), rtol=1e-4, atol=1e-7)


def test_slip_rejected_on_unsupported_backends():
    cfg = LatticeConfig(nx=16, ny=32, dtype=np.float32)
    edges = geometry.channel(cfg.nx, cfg.ny)
    from latticeboltzmann_tpu.models import engine

    engine.register_backend("bogus-for-test", lambda *a, **k: None)
    try:
        with pytest.raises(NotImplementedError):
            Simulation(cfg, backend="bogus-for-test", slip_x=edges)
    finally:
        engine._BACKENDS.pop("bogus-for-test")

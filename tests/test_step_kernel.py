"""The Pallas step kernel (ops/step_kernel.py) in interpret mode.

The kernel computes the XLA engine's own expression (collide_planes,
source_ok, source_delta), and the suite caps XLA:CPU at AVX so neither
program contracts into FMA (conftest.py): the two agree bitwise. Shapes
are odd on purpose, with small tiles, so every run crosses tile edges,
partial tail tiles and the periodic wrap.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu.core.spec import NSPEEDS
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.models.engine import initial_state
from latticeboltzmann_tpu.ops import step_kernel as sk
from latticeboltzmann_tpu.ops import stream_collide as xla_ops

DTYPES = {"f32": np.float32, "bf16": jnp.bfloat16, "f64": np.float64}
GEOMETRIES = ["empty", "channel", "barrier", "cylinder"]
# (nx, ny, block): multiple of the tile, odd on both axes, one row tile
SHAPES = [(16, 32, (8, 16)), (13, 37, (4, 16)), (11, 29, (16, 8))]


def _both(cfg, walls, n, block, **slip):
    f0 = jnp.asarray(initial_state(cfg))
    k = sk.run_steps(jnp.array(f0), jnp.asarray(walls), cfg, n, block=block,
                     interpret=True, **slip)
    x = xla_ops.run_steps(jnp.array(f0), jnp.asarray(walls), cfg, n, **slip)
    return np.asarray(k), np.asarray(x)


@pytest.mark.parametrize("nx,ny,block", SHAPES, ids=["tiled", "odd", "tall-tile"])
@pytest.mark.parametrize("precision", sorted(DTYPES))
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_kernel_matches_xla_bitwise(geom, precision, nx, ny, block):
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=DTYPES[precision])
    k, x = _both(cfg, geometry.build(geom, nx, ny), 12, block)
    np.testing.assert_array_equal(k.astype(np.float64), x.astype(np.float64))


@pytest.mark.parametrize("nx,ny,block", SHAPES[:2], ids=["tiled", "odd"])
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_kernel_f64_matches_golden(geom, nx, ny, block):
    """float64 kernel vs the NumPy oracle (serial-double semantics)."""
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float64)
    walls = geometry.build(geom, nx, ny)
    k, _ = _both(cfg, walls, 20, block)
    ref = golden.run(golden.initial_state(cfg), walls, cfg, 20)
    np.testing.assert_allclose(k, ref, rtol=1e-13, atol=1e-18)


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("scene", ["periodic", "walls", "slip"])
def test_kernel_conserves_mass(scene, precision):
    """Without forcing, pull streaming, BGK, bounce-back and specular
    reflection all conserve the total of f."""
    cfg = LatticeConfig(nx=13, ny=37, dtype=DTYPES[precision], accel=0.0)
    walls = geometry.empty(cfg.nx, cfg.ny)
    slip = {}
    if scene == "walls":
        walls = geometry.channel_with_barrier(cfg.nx, cfg.ny)
    if scene == "slip":
        walls[5:7, 8:10] = True
        slip = {"slip_x": jnp.asarray(geometry.channel(cfg.nx, cfg.ny))}
    rng = np.random.default_rng(0)
    f0 = initial_state(cfg) * (1.0 + 0.05 * rng.random((NSPEEDS, cfg.nx, cfg.ny)))
    f0 = f0.astype(DTYPES[precision])
    out = sk.run_steps(jnp.asarray(f0), jnp.asarray(walls), cfg, 10,
                       block=(4, 16), interpret=True, **slip)
    rtol = 1e-12 if precision == "f64" else 1e-5
    np.testing.assert_allclose(np.asarray(out).sum(dtype=np.float64),
                               f0.sum(dtype=np.float64), rtol=rtol)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_kernel_forcing_guard(precision):
    """Rows whose column-0 decrements would go non-positive are not
    forced; the kernel and the XLA engine pick the same rows."""
    cfg = LatticeConfig(nx=13, ny=37, dtype=DTYPES[precision])
    walls = geometry.channel(cfg.nx, cfg.ny)
    f0 = initial_state(cfg).astype(np.float64)
    f0[[3, 6, 7], 2:6, 0] *= 0.01  # guard fails on rows 2-5
    f0 = jnp.asarray(f0.astype(DTYPES[precision]))
    cls = sk.class_plane(jnp.asarray(walls))
    k = np.asarray(sk.step(f0, cls, cfg, block=(4, 16), interpret=True))
    x = np.asarray(xla_ops.step(f0, jnp.asarray(walls), cfg))
    np.testing.assert_array_equal(k.astype(np.float64), x.astype(np.float64))
    # the guard really engaged: forced rows are the fluid rows 1 and 6-11
    forced = np.asarray(xla_ops.apply_source(f0, jnp.asarray(walls), cfg))
    changed = forced[1, :, 0] != np.asarray(f0)[1, :, 0]
    assert changed.tolist() == [False, True] + [False] * 4 + [True] * 6 + [False]


@pytest.mark.parametrize("precision", sorted(DTYPES))
def test_simulation_pallas_interpret_facade(precision):
    """Simulation on 'pallas-interpret': run, state, moments and Reynolds
    agree with the 'xla' backend bitwise."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=DTYPES[precision])
    walls = geometry.channel_with_barrier(cfg.nx, cfg.ny)
    a = Simulation(cfg, walls, backend="pallas-interpret").run(5).run(3)
    b = Simulation(cfg, walls, backend="xla").run(8)
    assert a.steps_done == 8
    np.testing.assert_array_equal(np.asarray(a.state(), np.float64),
                                  np.asarray(b.state(), np.float64))
    assert a.reynolds() == b.reynolds()
    for u, v in zip(a.macroscopic(), b.macroscopic()):
        np.testing.assert_array_equal(u, v)

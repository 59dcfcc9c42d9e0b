"""The compiled step kernel on a GPU card (skips elsewhere).

Run on a card with `LBM_TEST_GPU=1 python -m pytest tests/ -m gpu`.
chip_smoke.py holds the same comparisons at the full 800x4000 width.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu.models.engine import resolve_backend

pytestmark = pytest.mark.gpu

# max |kernel - xla| over the state: f32 may differ only by the two
# compilers' FMA contraction; bf16 by a few storage roundings
TOL = {"f32": 1e-6, "bf16": 2e-3}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_compiled_kernel_matches_xla(gpu, precision):
    dtype = np.float32 if precision == "f32" else jnp.bfloat16
    cfg = LatticeConfig(nx=400, ny=2000, dtype=dtype)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    k = Simulation(cfg, walls, backend="pallas").run(200).state().astype(np.float64)
    x = Simulation(cfg, walls, backend="xla").run(200).state().astype(np.float64)
    assert np.isfinite(k).all() and (k >= 0).all()
    assert np.abs(k - x).max() <= TOL[precision]


def test_compiled_kernel_tails_and_slip(gpu):
    """Odd NX and NY (partial tiles on both axes) with all three solid
    classes."""
    cfg = LatticeConfig(nx=123, ny=1457, dtype=np.float32)
    walls = geometry.empty(cfg.nx, cfg.ny)
    walls[40:50, 300:305] = True
    slip_x = geometry.channel(cfg.nx, cfg.ny)
    slip_y = geometry.empty(cfg.nx, cfg.ny)
    slip_y[:, 1000] = True
    slip_y &= ~(walls | slip_x)
    kw = dict(slip_x=slip_x, slip_y=slip_y)
    k = Simulation(cfg, walls, backend="pallas", **kw).run(100).state()
    x = Simulation(cfg, walls, backend="xla", **kw).run(100).state()
    assert np.abs(k - x).max() <= TOL["f32"]


def test_auto_is_the_kernel_on_gpu(gpu):
    assert resolve_backend("auto") == "pallas"

"""On-device probe time series (Simulation.run_probed).

The reference's only observability during a run is the per-1000-step
stdout report and offline CSV dumps (src/latticeboltzmann.c:610-662);
run_probed provides time-resolved (rho, u_x, u_y) at chosen sites with
all sampling on device. Tests: series matches a step-by-step golden
recomputation, probing leaves the trajectory itself untouched, and the
chunked path (non-xla backends / every>1) agrees with the fused path.
"""

import numpy as np
import pytest

from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu.models import golden


PROBES = np.array([[5, 7], [12, 30], [1, 0]], dtype=np.int32)


def _golden_series(cfg, walls, n_steps, probes):
    f = golden.initial_state(cfg)
    rows = []
    for _ in range(n_steps):
        f = golden.step(f, walls, cfg)
        rho, ux, uy = golden.macroscopic(f)
        rows.append(
            np.stack(
                [rho[probes[:, 0], probes[:, 1]],
                 ux[probes[:, 0], probes[:, 1]],
                 uy[probes[:, 0], probes[:, 1]]],
                axis=-1,
            )
        )
    return f, np.stack(rows)


def test_probed_series_matches_golden(small_cfg, small_walls):
    sim = Simulation(small_cfg, small_walls, backend="xla")
    series = sim.run_probed(6, PROBES)
    f_ref, series_ref = _golden_series(small_cfg, small_walls, 6, PROBES)
    assert series.shape == (6, 3, 3)
    np.testing.assert_allclose(series, series_ref, rtol=0, atol=1e-13)
    # probing must not perturb the trajectory
    np.testing.assert_allclose(sim.state(), f_ref, rtol=0, atol=1e-13)
    assert sim.steps_done == 6


def test_probed_equals_unprobed_state(small_cfg, small_walls):
    a = Simulation(small_cfg, small_walls, backend="xla")
    a.run_probed(5, PROBES)
    b = Simulation(small_cfg, small_walls, backend="xla")
    b.run(5)
    np.testing.assert_array_equal(a.state(), b.state())


def test_chunked_probing_matches_fused(small_cfg, small_walls):
    """every=2 chunked path (used by non-xla backends) samples the same
    states as every other row of the fused per-step series."""
    fused = Simulation(small_cfg, small_walls, backend="xla")
    series1 = fused.run_probed(8, PROBES)
    chunked = Simulation(small_cfg, small_walls, backend="xla")
    series2 = chunked.run_probed(8, PROBES, every=2)
    assert series2.shape == (4, 3, 3)
    np.testing.assert_allclose(series2, series1[1::2], rtol=0, atol=1e-13)


def test_probing_on_pallas_backend(small_walls):
    """The chunked path works on the Pallas kernel (interpret mode on CPU)
    and agrees with the xla backend to f32 tolerance."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float32)
    pal = Simulation(cfg, small_walls, backend="pallas-interpret")
    series_p = pal.run_probed(4, PROBES, every=2)
    ref = Simulation(cfg, small_walls, backend="xla")
    series_x = ref.run_probed(4, PROBES, every=2)
    np.testing.assert_allclose(series_p, series_x, rtol=1e-5, atol=1e-7)


def test_probe_validation(small_cfg, small_walls):
    sim = Simulation(small_cfg, small_walls, backend="xla")
    with pytest.raises(ValueError):
        sim.run_probed(5, PROBES, every=2)  # 5 % 2 != 0
    with pytest.raises(ValueError):
        sim.run_probed(4, np.array([1, 2, 3]))  # bad shape


def test_pallas_fused_probes_every_1(small_walls):
    """run_probed(every=1) on the pallas backend (per-step chunks of the
    step kernel) matches the xla fused per-step series."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float32)
    pal = Simulation(cfg, small_walls, backend="pallas-interpret")
    series_p = pal.run_probed(6, PROBES)
    assert series_p.shape == (6, 3, 3)
    assert pal.steps_done == 6
    ref = Simulation(cfg, small_walls, backend="xla")
    series_x = ref.run_probed(6, PROBES)
    # the kernel computes the XLA engine's expression, and the suite caps
    # XLA:CPU at AVX (no FMA contraction; conftest.py): equal bitwise
    np.testing.assert_array_equal(series_p, series_x)
    np.testing.assert_array_equal(pal.state(), ref.state())


def test_pallas_fused_probes_every_8(small_walls):
    """An even `every` on the pallas backend: the series equals every 8th
    row of the per-step series."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float32)
    a = Simulation(cfg, small_walls, backend="pallas-interpret")
    s8 = a.run_probed(16, PROBES, every=8)
    b = Simulation(cfg, small_walls, backend="pallas-interpret")
    s1 = b.run_probed(16, PROBES)
    assert s8.shape == (2, 3, 3)
    np.testing.assert_allclose(s8, s1[7::8], rtol=0, atol=1e-7)


def test_pallas_fused_probes_odd_every(small_walls):
    """An odd `every` on the pallas backend still matches."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float32)
    a = Simulation(cfg, small_walls, backend="pallas-interpret")
    s3 = a.run_probed(6, PROBES, every=3)
    b = Simulation(cfg, small_walls, backend="pallas-interpret")
    s1 = b.run_probed(6, PROBES)
    np.testing.assert_allclose(s3, s1[2::3], rtol=0, atol=1e-7)


def test_sharded_pallas_fused_probes():
    """Probes on the sharded backend (chunks, device-side gather) match
    the xla per-step series and final state bitwise."""
    cfg = LatticeConfig(nx=64, ny=40, dtype=np.float32)
    walls = geometry.channel(cfg.nx, cfg.ny)
    walls[20:30, 10:13] = True
    sh = Simulation(cfg, walls, backend="sharded")
    s = sh.run_probed(8, PROBES, every=2)
    ref = Simulation(cfg, walls, backend="xla")
    s1 = ref.run_probed(8, PROBES)
    assert s.shape == (4, 3, 3)
    np.testing.assert_array_equal(s, s1[1::2])
    np.testing.assert_array_equal(sh.state(), ref.state())


def test_sharded_pallas_fused_probes_odd_every():
    """Odd `every` on the sharded backend."""
    cfg = LatticeConfig(nx=64, ny=40, dtype=np.float32)
    walls = geometry.channel(cfg.nx, cfg.ny)
    sh = Simulation(cfg, walls, backend="sharded")
    s = sh.run_probed(6, PROBES, every=3)
    ref = Simulation(cfg, walls, backend="xla")
    s1 = ref.run_probed(6, PROBES)
    np.testing.assert_array_equal(s, s1[2::3])


def test_probe_moments_accumulate_f32_for_bf16():
    """bf16 probe gathers must accumulate moments in float32 (the same
    signal-loss guard reynolds() has): sub-quantum u_y asymmetries in
    bf16-stored distributions survive the reduction."""
    import jax.numpy as jnp

    from latticeboltzmann_tpu.core.spec import W
    from latticeboltzmann_tpu.ops.stream_collide import probe_moments

    cols64 = np.broadcast_to(0.1 * W[:, None], (9, 4)).copy()
    cols64[1] += 1e-4  # tiny +y excess
    cols16 = jnp.asarray(cols64, jnp.bfloat16)
    out = probe_moments(cols16)
    assert out.dtype == jnp.float32
    # reference: the same bf16-quantized values reduced in float64
    ref_cols = np.asarray(cols16, np.float64)
    rho = ref_cols.sum(axis=0)
    u_y = (ref_cols[5] + ref_cols[1] + ref_cols[8]
           - (ref_cols[6] + ref_cols[3] + ref_cols[7])) / rho
    np.testing.assert_allclose(np.asarray(out)[:, 2], u_y, rtol=1e-5)
    assert (np.asarray(out)[:, 2] > 0).all()  # the signal survived

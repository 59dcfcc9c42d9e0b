"""Double-single (f32-pair) arithmetic and DP-class engine tests.

Validates ops/df64.py's error-free transforms against numpy float64 and
the ds engine (ops/ds_engine.py) against the golden serial-double model
— the DP-class accuracy contract of docs/NUMERICS.md. These run on XLA
CPU; chip_smoke.py re-checks the transforms (df64.check_backend) and the
engine against golden on the GPU (IEEE f32 round-to-nearest is the only
hardware assumption)."""

import numpy as np
import pytest

from latticeboltzmann_tpu import geometry
from latticeboltzmann_tpu.core.spec import LatticeConfig
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.ops import df64, ds_engine


def _rand(rng, n=4096, scale=1.0):
    return (rng.normal(size=n) * scale).astype(np.float32)


def test_two_sum_exact():
    """TwoSum is an error-free transform: s + e == a + b in exact
    arithmetic (verifiable in f64 since s, e are f32)."""
    rng = np.random.default_rng(0)
    a, b = _rand(rng), _rand(rng, scale=1e-6)
    s, e = df64.two_sum(a, b)
    s, e = np.asarray(s, np.float64), np.asarray(e, np.float64)
    np.testing.assert_array_equal(s + e, a.astype(np.float64) + b.astype(np.float64))


def test_two_prod_exact():
    """TwoProd: p + e == a * b exactly (a 24x24-bit product fits f64)."""
    rng = np.random.default_rng(1)
    a, b = _rand(rng), _rand(rng)
    p, e = df64.two_prod(a, b)
    p, e = np.asarray(p, np.float64), np.asarray(e, np.float64)
    np.testing.assert_array_equal(p + e, a.astype(np.float64) * b.astype(np.float64))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_ds_ops_match_f64(op):
    """Pair ops track float64 to ~2^-45 relative to the OPERAND scale
    (under catastrophic cancellation the ~2^-48-of-|x| input-pair
    quantization necessarily dominates the tiny result — the same
    absolute-error floor f64 itself has at 2^-53; mul/div have no
    cancellation so their bound is relative to the result too)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=8192) * np.exp(rng.uniform(-8, 8, size=8192))
    y = rng.normal(size=8192) * np.exp(rng.uniform(-8, 8, size=8192))
    a, b = df64.from_f64(x), df64.from_f64(y)
    got = df64.to_f64(getattr(df64, op)(a, b))
    want = getattr(np, {"add": "add", "sub": "subtract", "mul": "multiply",
                        "div": "divide"}[op])(x, y)
    if op in ("add", "sub"):
        scale = np.maximum(np.abs(x), np.abs(y))
    else:
        scale = np.abs(want)
    rel = np.abs(got - want) / np.maximum(scale, 1e-300)
    assert rel.max() < 2.0**-45, f"{op}: max rel {rel.max():.3e}"


def test_ds_recip_matches_f64():
    rng = np.random.default_rng(3)
    x = rng.normal(size=4096) * np.exp(rng.uniform(-6, 6, size=4096))
    got = df64.to_f64(df64.recip(df64.from_f64(x)))
    rel = np.abs(got - 1.0 / x) * np.abs(x)
    assert rel.max() < 2.0**-45


def test_ds_sum_chain_precision():
    """A 9-term sequential pair sum (the density moment) keeps ~2^-45
    relative accuracy even with cancellation-prone terms."""
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=1024) for _ in range(9)]
    acc = df64.from_f64(xs[0])
    for x in xs[1:]:
        acc = df64.add(acc, df64.from_f64(x))
    want = xs[0].copy()
    for x in xs[1:]:
        want = want + x
    err = np.abs(df64.to_f64(acc) - want)
    scale = np.max(np.abs(xs), axis=0)
    assert (err / scale).max() < 2.0**-44


def test_gt_zero_pair_sign():
    a = df64.DS(np.float32([1.0, -1.0, 0.0, 0.0, 0.0]),
                np.float32([-2e-8, 2e-8, 1e-12, -1e-12, 0.0]))
    np.testing.assert_array_equal(
        np.asarray(df64.gt_zero(a)), [True, False, True, False, False]
    )


def test_backend_preserves_one_rounding_semantics():
    """The suite environment (XLA:CPU capped at --xla_cpu_max_isa=AVX,
    conftest.py) must give strict one-rounding f32 under jit — the
    property every ds transform stands on. If this fails, the host
    compiled with FMA contraction and every ds result above is
    meaningless."""
    assert df64.check_backend(), (
        "jitted f32 mul+add is not two-rounding IEEE on this backend; "
        "is --xla_cpu_max_isa=AVX in XLA_FLAGS (tests/conftest.py)?"
    )


def test_ds_engine_refuses_contracting_backend(monkeypatch):
    """ds_engine.run_steps must fail loudly, not degrade silently, on a
    backend that contracts mul+add into FMA (the hazard is real: stock
    XLA:CPU on an AVX2 host does exactly this)."""
    monkeypatch.setitem(df64._BACKEND_OK, "cpu", False)
    cfg, walls = _scene()
    with pytest.raises(RuntimeError, match="FMA contraction"):
        ds_engine.run_steps(
            ds_engine.initial_state(cfg), np.asarray(walls), cfg, 1
        )


def _scene(nx=16, ny=40):
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float64)
    walls = geometry.channel_with_barrier(
        nx, ny, barrier_rows=(5, 9), barrier_cols=(10, 13)
    )
    return cfg, walls


def test_ds_engine_matches_golden_f64():
    """The full ds step chain vs the golden serial-double model: after
    300 steps on a barrier scene the state agrees to ~1e-12 relative —
    DP-class by any observable standard (f32 diverges at ~1e-4 by then).
    This is the accuracy half of the DP-column claim."""
    cfg, walls = _scene()
    n = 300
    f_gold = golden.run(golden.initial_state(cfg), walls, cfg, n)
    f_ds = ds_engine.run_steps(
        ds_engine.initial_state(cfg), np.asarray(walls), cfg, n
    )
    got = ds_engine.state_f64(f_ds)
    err = np.abs(got - f_gold) / np.maximum(np.abs(f_gold), 1e-30)
    assert err.max() < 1e-11, f"max rel {err.max():.3e}"

    re_gold = golden.reynolds(f_gold, walls, cfg)
    re_ds = ds_engine.reynolds(f_ds, walls, cfg)
    assert abs(re_ds - re_gold) <= 1e-9 * abs(re_gold)


def test_ds_engine_forcing_guard_matches_golden():
    """The all-or-nothing f>0 forcing guard evaluated at pair precision
    must make the same decisions as the golden f64 model (a flipped
    guard would inject O(accel) divergence instantly)."""
    cfg, walls = _scene()
    f64_state = golden.initial_state(cfg)
    # drive some sites near the guard threshold
    f64_state[6, :, 0] = np.float64(cfg.accel) * np.float64(golden.W[5]) * np.concatenate(
        [np.linspace(0.5, 2.0, cfg.nx // 2), np.full(cfg.nx - cfg.nx // 2, 10.0)]
    )
    want = golden.apply_source(f64_state, walls, cfg)
    got = ds_engine.state_f64(
        ds_engine.apply_source(df64.from_f64(f64_state), np.asarray(walls), cfg)
    )
    changed_w = want != f64_state
    changed_g = np.abs(got - f64_state) > 1e-13
    np.testing.assert_array_equal(changed_g, changed_w)


def test_ds_simulation_facade():
    """The Simulation facade runs the ds backend end-to-end: state() is
    float64, reynolds/macroscopic use the golden association order."""
    from latticeboltzmann_tpu.models.engine import Simulation

    cfg, walls = _scene()
    sim = Simulation(cfg, walls, backend="xla-ds64")
    sim.run(60)
    st = sim.state()
    assert st.dtype == np.float64
    ref = golden.run(golden.initial_state(cfg), walls, cfg, 60)
    err = np.abs(st - ref) / np.maximum(np.abs(ref), 1e-30)
    assert err.max() < 1e-12
    assert np.isfinite(sim.reynolds())
    rho, ux, uy = sim.macroscopic()
    assert rho.dtype == np.float64 and np.isfinite(rho).all()
    assert sim.steps_done == 60 and sim.mlups > 0

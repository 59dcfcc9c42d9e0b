"""Double-single ("df64") arithmetic: ~49-bit-mantissa reals as
unevaluated sums of two float32s, built from error-free transforms
(Dekker/Knuth TwoSum/TwoProd/Split — the classic double-float technique
of Dekker 1971 and the dsfun/QD libraries, as used for extended
precision on GPUs).

It answers the reference's double-precision builds
(src/prec_double_*.h) on hardware whose f64 rate is low: a (hi, lo)
pair of f32s carries 2x24 mantissa bits, a relative precision of
~2^-48 ~ 3.6e-15 (vs f64's 1.1e-16; both far beyond the ~1e-9
observable-accuracy target docs/NUMERICS.md sets for DP-class physics). The exponent range is f32's — fine for LBM state
(values in [1e-3, 1]).

Correctness relies on IEEE-754 round-to-nearest f32 add/sub/mul with
exactly ONE rounding per op. That is a real hazard, not a given:
XLA:CPU's LLVM codegen contracts mul+add chains into FMA on FMA-capable
hosts (AVX2+), which silently collapses TwoSum's postcondition from
exact to f32-accurate — and no HLO-level device (optimization_barrier,
bitcast round-trips, reduce_precision) blocks the contraction; only
compiling without an FMA ISA does (tests pin --xla_cpu_max_isa=AVX).
`check_backend()` probes the live backend for this failure mode under
jit, and ds_engine refuses to run on a backend that fails it;
tests/test_ds.py validates every op against numpy float64 on CPU and
chip_smoke.py re-checks the probe and the engine on the GPU.

A ds number is a DS(hi, lo) NamedTuple of same-shape arrays with
|lo| <= ulp(hi)/2 (normalized). All ops are elementwise and jit-safe.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class DS(NamedTuple):
    """An unevaluated f32 sum hi + lo (|lo| <= ulp(hi)/2)."""

    hi: jax.Array
    lo: jax.Array


# --- host-side conversions -------------------------------------------------


def from_f64(x) -> DS:
    """Split float64 host values into a normalized (hi, lo) pair:
    hi = f32(x), lo = f32(x - f64(hi)). Exact when |x - hi| is
    representable (always, for the magnitudes LBM uses)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DS(jnp.asarray(hi), jnp.asarray(lo))


def to_f64(a: DS) -> np.ndarray:
    """Recombine on host at full float64."""
    return np.asarray(a.hi, np.float64) + np.asarray(a.lo, np.float64)


def const(x: float) -> DS:
    """A ds scalar constant from an exact float64 value, opaque to the
    compiler.

    The (hi, lo) pair is wrapped in `lax.optimization_barrier` so XLA
    never sees it as a literal: the HLO algebraic simplifier applies the
    float-unsafe cancellation ``sub(add(x, c), c) -> x`` when ``c`` is a
    compile-time constant, which deletes TwoSum's ``v = s - a`` and
    silently zeroes the error term of any ds op with a constant operand
    (observed on XLA:CPU; the rewrite lives in the shared HLO pipeline,
    so every backend is assumed hostile). Behind the barrier the pair is an
    ordinary runtime value and the rewrite cannot fire. Cost: two scalar
    barriers per constant — nothing against the elementwise math.
    """
    v = np.float64(x)
    hi = np.float32(v)
    lo = np.float32(v - np.float64(hi))
    bhi, blo = jax.lax.optimization_barrier((jnp.asarray(hi), jnp.asarray(lo)))
    return DS(bhi, blo)


def zeros_like(a: DS) -> DS:
    return DS(jnp.zeros_like(a.hi), jnp.zeros_like(a.lo))


# --- error-free transforms ---------------------------------------------------


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b). 6 flops,
    branch-free, no magnitude precondition."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """Dekker FastTwoSum: requires |a| >= |b| (or a == 0). 3 flops."""
    s = a + b
    e = b - (s - a)
    return s, e


# 2^12 + 1: splits a 24-bit mantissa into two 12-bit halves whose
# products are exact in f32 (Dekker's split constant for single).
_SPLIT = np.float32(4097.0)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly, p = fl(a * b). 17 flops
    (no FMA dependence — exactness comes from the 12-bit splits)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# --- ds arithmetic -----------------------------------------------------------


def add(a: DS, b: DS) -> DS:
    """Full ds addition (Dekker add2 with both error terms): relative
    error ~2^-47. ~20 flops."""
    sh, se = two_sum(a.hi, b.hi)
    th, te = two_sum(a.lo, b.lo)
    se = se + th
    sh, se = quick_two_sum(sh, se)
    se = se + te
    return DS(*quick_two_sum(sh, se))


def sub(a: DS, b: DS) -> DS:
    return add(a, DS(-b.hi, -b.lo))


def add_f(a: DS, b) -> DS:
    """ds + f32. ~11 flops."""
    sh, se = two_sum(a.hi, b)
    se = se + a.lo
    return DS(*quick_two_sum(sh, se))


def mul(a: DS, b: DS) -> DS:
    """Full ds multiplication: p = a.hi*b.hi exactly (TwoProd) plus the
    cross terms; relative error ~2^-46. ~26 flops."""
    ph, pe = two_prod(a.hi, b.hi)
    pe = pe + (a.hi * b.lo + a.lo * b.hi)
    return DS(*quick_two_sum(ph, pe))


def mul_f(a: DS, b) -> DS:
    """ds * f32 (b exact). ~22 flops."""
    ph, pe = two_prod(a.hi, b)
    pe = pe + a.lo * b
    return DS(*quick_two_sum(ph, pe))


def div(a: DS, b: DS) -> DS:
    """Long-division ds divide (two refinement steps): relative error
    ~2^-46. ~3 f32 divides + ~90 flops."""
    q1 = a.hi / b.hi
    r = sub(a, mul_f(b, q1))
    q2 = r.hi / b.hi
    r = sub(r, mul_f(b, q2))
    q3 = r.hi / b.hi
    qh, ql = quick_two_sum(q1, q2)
    return add_f(DS(qh, ql), q3)


def recip(b: DS, one: DS | None = None) -> DS:
    """1 / b — div with the a=1 residuals simplified away. `one` is the
    caller's const(1.0), built once per program."""
    q1 = np.float32(1.0) / b.hi
    r = sub(const(1.0) if one is None else one, mul_f(b, q1))
    q2 = r.hi / b.hi
    r = sub(r, mul_f(b, q2))
    q3 = r.hi / b.hi
    qh, ql = quick_two_sum(q1, q2)
    return add_f(DS(qh, ql), q3)


def neg(a: DS) -> DS:
    return DS(-a.hi, -a.lo)


def where(c, a: DS, b: DS) -> DS:
    return DS(jnp.where(c, a.hi, b.hi), jnp.where(c, a.lo, b.lo))


def gt_zero(a: DS):
    """a > 0. A normalized pair's sign is carried by hi unless hi == 0,
    where lo decides."""
    return (a.hi > 0) | ((a.hi == 0) & (a.lo > 0))


# --- backend validation ------------------------------------------------------


_BACKEND_OK: dict[str, bool] = {}


def check_backend(raise_on_fail: bool = False) -> bool:
    """Probe the current jax backend for strict one-rounding f32
    semantics under jit — the property every error-free transform here
    stands on.

    Two probes, both jitted, both verified against host float64 over
    256 inputs; cached per backend:

    1. FMA contraction: ``two_sum(h, a * a)`` (a multiply feeding the
       TwoSum adds, the exact shape FMA contraction targets: a
       contracted backend computes s = fma(a, a, h) = fl(h + a·b_exact),
       one rounding, while TwoSum's error term is derived assuming
       s = fl(h + fl(a·a)), two roundings). ~28% of random inputs are
       contraction-sensitive, so a miss is ~1e-39.
    2. Constant cancellation: ``sub(const(1.0), u)`` with |u| ~ 1e-3
       must track float64 to ~2^-45. This is the HLO simplifier's
       ``sub(add(x, c), c) -> x`` rewrite that const()'s
       optimization_barrier exists to block — if a backend ever sees
       through the barrier (or a future pass adds a new cancellation),
       this fails loudly instead of letting ds results silently
       degrade to f32.

    Returns True if the backend is safe; with raise_on_fail, raises
    RuntimeError naming the remediation (on XLA:CPU, set
    --xla_cpu_max_isa=AVX or lower in XLA_FLAGS to compile without FMA).
    """
    key = jax.default_backend()
    if key not in _BACKEND_OK:
        rng = np.random.RandomState(0)
        h = rng.standard_normal(256).astype(np.float32)
        a = rng.standard_normal(256).astype(np.float32)
        s, e = jax.jit(lambda h, a: two_sum(h, a * a))(h, a)
        p = a * a  # numpy: one rounding for the mul
        want = np.float64(h) + np.float64(p)
        fma_ok = bool(
            np.array_equal(np.float64(np.asarray(s)) + np.float64(np.asarray(e)), want)
        )
        u = np.abs(rng.standard_normal(256)).astype(np.float64) * 1e-3
        got = to_f64(jax.jit(lambda u: sub(const(1.0), u))(from_f64(u)))
        cancel_ok = bool(np.abs(got - (1.0 - u)).max() < 2.0**-45)
        _BACKEND_OK[key] = fma_ok and cancel_ok
    if raise_on_fail and not _BACKEND_OK[key]:
        raise RuntimeError(
            f"jax backend {key!r} does not preserve one-rounding f32 "
            "semantics under jit (FMA contraction detected): the "
            "double-single (ds) engine's error-free transforms would "
            "silently degrade to plain f32 accuracy. On XLA:CPU, add "
            "--xla_cpu_max_isa=AVX (or lower) to XLA_FLAGS to compile "
            "without FMA; on other backends there is no known "
            "remediation — use the emulated-f64 'xla' backend instead."
        )
    return _BACKEND_OK[key]

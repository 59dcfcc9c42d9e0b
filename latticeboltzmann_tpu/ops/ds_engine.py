"""Double-single (f32-pair) DP-class engine — an answer to the
reference's double-precision builds and benchmark columns
(src/prec_double_avx.h, README.md:66-90 DP rows) for hardware whose f64
rate is low. It carries every distribution as an unevaluated f32 pair
(ops/df64.py) and runs the whole fused stream+collide in compensated
f32-pair arithmetic: ~2^-48 relative precision per operation (vs f64's
2^-53), which docs/NUMERICS.md shows is indistinguishable from f64 on
every physics observable the reference reports. It moves the same 144
B/site as native f64; whether it earns its place beside the f64 engines
is open (ROADMAP debt D2).

Semantics mirror the golden model (models/golden.py =
src/latticeboltzmann.c:216-302 serial double semantics): pull-scheme
streaming, strict moment association order, BGK relaxation through
1/tau, masked bounce-back, j=0 forcing with the all-or-nothing f>0
guard evaluated at pair precision.

State is a df64.DS of two (9, NX, NY) float32 arrays. Conversions to
and from float64 happen on the host only (df64.from_f64 / to_f64).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import E, NSPEEDS, OPPOSITE, W, LatticeConfig
from . import df64
from .df64 import DS


def initial_state(cfg: LatticeConfig) -> DS:
    """Rest equilibrium split from exact float64 host values
    (src/latticeboltzmann.c:583-591) — the lo components carry the part
    of rho*w_s below f32 resolution, so a ds run starts bitwise-aligned
    (to ~2^-48) with the golden f64 state."""
    f = np.empty((NSPEEDS, cfg.nx, cfg.ny), dtype=np.float64)
    rho = np.float64(cfg.initial_density)
    for s in range(NSPEEDS):
        f[s] = rho * np.float64(W[s])
    return df64.from_f64(f)


def _consts(cfg: LatticeConfig) -> dict:
    """Physics constants as ds scalars, split from exact float64.
    Derived values (3/csq etc.) are computed in f64 BEFORE splitting, so
    each constant is a ~2^-48-exact image of the golden model's double
    value. (Golden computes 3*u/csq as two ops; folding to (3/csq)*u
    differs by <=1 ulp64 — far below the pair precision.)"""
    mk = df64.const
    csq = np.float64(cfg.csq)
    return dict(
        one=mk(1.0),
        itau=mk(1.0 / np.float64(cfg.tau)),
        c3=mk(3.0 / csq),
        c45=mk(4.5 / (csq * csq)),
        c15=mk(1.5 / csq),
        w0=mk(W[0]),
        w14=mk(W[1]),
        w58=mk(W[5]),
        a14=mk(np.float64(cfg.accel) * np.float64(W[1])),
        a58=mk(np.float64(cfg.accel) * np.float64(W[5])),
    )


def apply_source(f: DS, walls: jax.Array, cfg: LatticeConfig, C: dict | None = None) -> DS:
    """Channel forcing on column j=0 (src/latticeboltzmann.c:489-518)
    at pair precision, including the all-or-nothing f>0 guard — the
    guard decisions match the golden f64 model's except within ~2^-48
    of the threshold (docs/NUMERICS.md quantifies the observable)."""
    C = _consts(cfg) if C is None else C
    col = DS(f.hi[:, :, 0], f.lo[:, :, 0])  # (9, NX) pairs

    def sp(s):
        return DS(col.hi[s], col.lo[s])

    ok = (
        (~walls[:, 0])
        & df64.gt_zero(df64.sub(sp(6), C["a58"]))
        & df64.gt_zero(df64.sub(sp(3), C["a14"]))
        & df64.gt_zero(df64.sub(sp(7), C["a58"]))
    )
    new = {
        6: df64.sub(sp(6), C["a58"]),
        3: df64.sub(sp(3), C["a14"]),
        7: df64.sub(sp(7), C["a58"]),
        5: df64.add(sp(5), C["a58"]),
        1: df64.add(sp(1), C["a14"]),
        8: df64.add(sp(8), C["a58"]),
    }
    hi, lo = f.hi, f.lo
    for s, v in new.items():
        sel = df64.where(ok, v, sp(s))
        hi = hi.at[s, :, 0].set(sel.hi)
        lo = lo.at[s, :, 0].set(sel.lo)
    return DS(hi, lo)


def pull(f: DS) -> DS:
    """Periodic pull gather (src/latticeboltzmann.c:230-243): pure data
    movement, applied to both pair components."""

    def roll(x):
        return jnp.stack(
            [
                jnp.roll(x[s], shift=(int(E[s, 0]), int(E[s, 1])), axis=(0, 1))
                for s in range(NSPEEDS)
            ]
        )

    return DS(roll(f.hi), roll(f.lo))


def collide_planes(p: list[DS], C: dict) -> list[DS]:
    """BGK collision on nine pulled ds planes -> nine relaxed ds planes.

    Association order
    follows the golden model (src/latticeboltzmann.c:258-296): strict
    left-to-right density sum, ((a+b)+c) - ((d+e)+g) velocity
    numerators, feq accumulated as ((1 + 3u) + 4.5u^2) - 1.5|u|^2.
    The +/- speed pairs share their common subterms — in ds arithmetic
    each shared term is ~26 f32 ops."""
    A, S, M = df64.add, df64.sub, df64.mul

    density = p[0]
    for s in range(1, NSPEEDS):
        density = A(density, p[s])

    num_x = S(A(A(p[6], p[2]), p[5]), A(A(p[7], p[4]), p[8]))
    num_y = S(A(A(p[5], p[1]), p[8]), A(A(p[6], p[3]), p[7]))
    irho = df64.recip(density, one=C["one"])
    u_x = M(num_x, irho)
    u_y = M(num_y, irho)
    uterm = M(C["c15"], A(M(u_x, u_x), M(u_y, u_y)))  # 1.5|u|^2/csq

    itau = C["itau"]
    wd14 = M(C["w14"], density)
    wd58 = M(C["w58"], density)

    out = [None] * NSPEEDS
    # speed 0: feq = w0 * rho * (1 - uterm)
    feq0 = M(M(C["w0"], density), S(C["one"], uterm))
    out[0] = A(p[0], M(itau, S(feq0, p[0])))

    # +/- pairs (sp pulls along +e, sn along -e): u_sn = -u_sp, so the
    # pair shares t3 = 3u/csq, t45 = 4.5u^2/csq^2 and w*rho
    for sp_, sn, v, wd in (
        (1, 3, u_y, wd14),
        (2, 4, u_x, wd14),
        (5, 7, A(u_x, u_y), wd58),
        (6, 8, S(u_x, u_y), wd58),
    ):
        t3 = M(C["c3"], v)
        t45 = M(C["c45"], M(v, v))
        base = S(A(df64.add_f(t3, np.float32(1.0)), t45), uterm)
        base_n = S(A(df64.add_f(df64.neg(t3), np.float32(1.0)), t45), uterm)
        feq_p = M(wd, base)
        feq_n = M(wd, base_n)
        out[sp_] = A(p[sp_], M(itau, S(feq_p, p[sp_])))
        out[sn] = A(p[sn], M(itau, S(feq_n, p[sn])))
    return out


def stream_collide(f: DS, walls: jax.Array, cfg: LatticeConfig, C: dict | None = None) -> DS:
    """One fused step: pull, collide at pair precision, masked
    bounce-back (wall f0 passthrough, like the golden model)."""
    C = _consts(cfg) if C is None else C
    pulled = pull(f)
    planes = [DS(pulled.hi[s], pulled.lo[s]) for s in range(NSPEEDS)]
    relaxed = collide_planes(planes, C)
    out_hi, out_lo = [], []
    for s in range(NSPEEDS):
        o = int(OPPOSITE[s])
        sel = df64.where(walls, DS(pulled.hi[o], pulled.lo[o]), relaxed[s])
        out_hi.append(sel.hi)
        out_lo.append(sel.lo)
    return DS(jnp.stack(out_hi), jnp.stack(out_lo))


def step(f: DS, walls: jax.Array, cfg: LatticeConfig, C: dict | None = None) -> DS:
    """ApplySource then StreamCollide (src/latticeboltzmann.c:192-198)."""
    C = _consts(cfg) if C is None else C
    return stream_collide(apply_source(f, walls, cfg, C), walls, cfg, C)


@partial(jax.jit, static_argnames=("cfg", "n_steps"), donate_argnums=(0,))
def _run_steps_jit(f: DS, walls: jax.Array, cfg: LatticeConfig, n_steps: int) -> DS:
    C = _consts(cfg)

    def body(carry, _):
        return step(carry, walls, cfg, C), None

    out, _ = jax.lax.scan(body, f, length=n_steps)
    return out


def run_steps(f: DS, walls: jax.Array, cfg: LatticeConfig, n_steps: int) -> DS:
    """n_steps under one jit(scan), zero host round-trips — the ds
    twin of ops/stream_collide.run_steps. Refuses to run on a backend
    whose jitted f32 ops are not one-rounding IEEE (FMA contraction
    would silently collapse the pair arithmetic to f32 accuracy —
    df64.check_backend)."""
    df64.check_backend(raise_on_fail=True)
    return _run_steps_jit(f, walls, cfg, n_steps)


# --- host-side diagnostics (f64 recombine, golden association order) --------


def state_f64(f: DS) -> np.ndarray:
    return df64.to_f64(f)


def macroscopic(f: DS):
    from ..models import golden

    return golden.macroscopic(state_f64(f))


def reynolds(f: DS, walls, cfg: LatticeConfig) -> float:
    from ..models import golden

    return golden.reynolds(state_f64(f), np.asarray(walls, bool), cfg)

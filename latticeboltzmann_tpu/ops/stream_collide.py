"""Fused stream+collide and forcing as pure-XLA jittable ops.

This is the portable compute path: nine `jnp.roll` pulls, BGK
collision, and a branchless masked bounce-back — the array re-design of
the reference's scalar/vector kernels (src/latticeboltzmann.c:216-485).
Association order of the arithmetic matches the reference's scalar kernel
exactly so that float64 runs are bitwise-comparable to the golden model.

The Pallas step kernel (ops/step_kernel.py) is the GPU performance path
and calls this module's collision and forcing expressions; this module
is the semantics anchor and the engine of every other platform.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import E, NSPEEDS, OPPOSITE, REFLECT_X, REFLECT_Y, W, LatticeConfig


def _compute_dtype(cfg: LatticeConfig):
    """bfloat16 is a STORAGE precision (halved HBM traffic); all
    collision arithmetic runs in float32, exactly as the Pallas kernel
    does (ops/step_kernel.py casts loaded bf16 tiles to f32). A pure-
    bf16 engine is not a usable simulation: measured 68% mass drift and
    max|u| 0.49 in 900 steps on a 64x2400 channel (vs 2.5e-6 / 0.017
    for f32) — bf16's ~3 decimal digits cannot carry the relaxation's
    near-cancellations. f32/f64 compute at their own precision."""
    return jnp.float32 if jnp.dtype(cfg.dtype) == jnp.dtype(jnp.bfloat16) else cfg.dtype


def source_delta(cfg: LatticeConfig) -> np.ndarray:
    """Per-speed forcing increments in the compute dtype: +y speeds
    (5,1,8) gain accel*w, -y speeds (6,3,7) lose it
    (src/latticeboltzmann.c:489-518)."""
    dt = np.dtype(_compute_dtype(cfg))
    a14 = np.asarray(cfg.accel, dt) * np.asarray(W[1], dt)
    a58 = np.asarray(cfg.accel, dt) * np.asarray(W[5], dt)
    delta = np.zeros((NSPEEDS,), dtype=dt)
    delta[[5, 8]] = a58
    delta[1] = a14
    delta[[6, 7]] = -a58
    delta[3] = -a14
    return delta


def source_ok(f3, f6, f7, solid, cfg: LatticeConfig):
    """Forcing guard: a fluid site whose three decremented speeds all
    stay > 0 (src/latticeboltzmann.c:496-499). Inputs in the compute
    dtype; shared with the Pallas kernel so both test identically."""
    delta = source_delta(cfg)
    a14, a58 = -delta[3], -delta[6]
    zero = np.zeros((), delta.dtype)
    return (~solid) & (f6 - a58 > zero) & (f3 - a14 > zero) & (f7 - a58 > zero)


def apply_source(f: jax.Array, walls: jax.Array, cfg: LatticeConfig) -> jax.Array:
    """Channel forcing on column j=0 (src/latticeboltzmann.c:489-518).

    walls: (NX, NY) bool. Adds accel*w to speeds (5,1,8), subtracts from
    (6,3,7) on fluid sites where all three decrements stay > 0.

    Guard and increments run in the compute dtype (f32 for bf16
    storage, like the Pallas kernel's forcing); the updated column is
    rounded back to the storage dtype.
    """
    dt = np.dtype(_compute_dtype(cfg))
    col = f[:, :, 0].astype(dt)  # (9, NX)
    ok = source_ok(col[3], col[6], col[7], walls[:, 0], cfg)
    new_col = jnp.where(ok[None, :], col + jnp.asarray(source_delta(cfg))[:, None], col)
    return f.at[:, :, 0].set(new_col.astype(f.dtype))


def pull(f: jax.Array) -> jax.Array:
    """Periodic pull gather: pulled_s(i,j) = f_s(i-e_x, j-e_y)
    (src/latticeboltzmann.c:230-243)."""
    planes = [
        jnp.roll(f[s], shift=(int(E[s, 0]), int(E[s, 1])), axis=(0, 1))
        for s in range(NSPEEDS)
    ]
    return jnp.stack(planes)


def collide_planes(ft: list, cfg: LatticeConfig) -> list:
    """BGK collision on a list of nine planes, scalar-kernel association
    order (src/latticeboltzmann.c:258-296). The planes must already be
    in the compute dtype. The Pallas step kernel calls this on its tiles,
    so both engines relax with the same expression."""
    dt = np.dtype(_compute_dtype(cfg))
    one = dt.type(1.0)
    three = dt.type(3.0)
    threeotwo = dt.type(1.5)
    nineotwo = dt.type(4.5)
    csq = dt.type(cfg.csq)
    itau = one / dt.type(cfg.tau)
    w = [dt.type(W[s]) for s in range(NSPEEDS)]

    density = ft[0]
    for s in range(1, NSPEEDS):
        density = density + ft[s]

    u_x = ((ft[6] + ft[2]) + ft[5] - ((ft[7] + ft[4]) + ft[8])) / density
    u_y = ((ft[5] + ft[1]) + ft[8] - ((ft[6] + ft[3]) + ft[7])) / density
    u_dot_u = u_x * u_x + u_y * u_y

    u = [None, u_y, u_x, -u_y, -u_x, u_x + u_y, u_x - u_y, -u_x - u_y, -u_x + u_y]

    uterm = threeotwo * u_dot_u / csq
    fequ0 = w[0] * density * (one - uterm)
    out = [ft[0] + itau * (fequ0 - ft[0])]
    for s in range(1, NSPEEDS):
        fequ = w[s] * density * (
            one + three * u[s] / csq + nineotwo * u[s] * u[s] / csq / csq - uterm
        )
        out.append(ft[s] + itau * (fequ - ft[s]))
    return out


def collide(pulled: jax.Array, cfg: LatticeConfig) -> jax.Array:
    """BGK collision on a stacked (9, ...) array (see collide_planes).
    `pulled` must already be in the compute dtype (stream_collide casts
    bf16 storage up to f32)."""
    return jnp.stack(collide_planes([pulled[s] for s in range(NSPEEDS)], cfg))


def stream_collide(
    f: jax.Array,
    walls: jax.Array,
    cfg: LatticeConfig,
    slip_x: jax.Array | None = None,
    slip_y: jax.Array | None = None,
) -> jax.Array:
    """One fused step on the full lattice: pull, BGK relax on fluid,
    bounce-back swap on walls, wall f0 passthrough
    (src/latticeboltzmann.c:216-302).

    slip_x / slip_y: optional masks of free-slip (specular-reflection)
    solid sites with wall plane normal to x / y — the "reflect" BC the
    reference names but never implements (src/latticeboltzmann.c:21).
    Precedence on overlap: walls > slip_x > slip_y. All selects are
    branchless, so the slip paths cost two extra vectorized wheres.

    With bf16 storage the whole step computes in f32 and rounds back on
    return (the Pallas kernel's mixed-precision contract). Bounce-back
    stays exact: the selected pulled values are bf16-representable, so
    the final cast is an identity on them.
    """
    pulled = pull(f).astype(_compute_dtype(cfg))
    out = collide(pulled, cfg)
    if slip_y is not None:
        out = jnp.where(slip_y[None, :, :], pulled[np.asarray(REFLECT_Y)], out)
    if slip_x is not None:
        out = jnp.where(slip_x[None, :, :], pulled[np.asarray(REFLECT_X)], out)
    out = jnp.where(walls[None, :, :], pulled[np.asarray(OPPOSITE)], out)
    return out.astype(f.dtype)


def step(
    f: jax.Array,
    walls: jax.Array,
    cfg: LatticeConfig,
    slip_x: jax.Array | None = None,
    slip_y: jax.Array | None = None,
) -> jax.Array:
    """One timestep: ApplySource then StreamCollide
    (src/latticeboltzmann.c:192-198). Slip sites are solid for the
    forcing too, so the source skips them like walls."""
    solid = walls
    if slip_x is not None:
        solid = solid | slip_x
    if slip_y is not None:
        solid = solid | slip_y
    return stream_collide(apply_source(f, solid, cfg), walls, cfg, slip_x, slip_y)


@partial(jax.jit, static_argnames=("cfg", "n_steps"), donate_argnums=(0,))
def run_steps(
    f: jax.Array,
    walls: jax.Array,
    cfg: LatticeConfig,
    n_steps: int,
    slip_x: jax.Array | None = None,
    slip_y: jax.Array | None = None,
) -> jax.Array:
    """n_steps timesteps under one jit(scan) — zero host round-trips,
    the counterpart of the reference's two-steps-per-call loop
    (src/latticeboltzmann.c:148-164)."""

    def body(carry, _):
        return step(carry, walls, cfg, slip_x, slip_y), None

    out, _ = jax.lax.scan(body, f, length=n_steps)
    return out


def probe_moments(cols: jax.Array) -> jax.Array:
    """(rho, u_x, u_y) from gathered per-site distribution columns
    (9, P) -> (P, 3). Shared by the local and sharded probe gathers so
    their association order (and hence bitwise results) agree.

    Accumulates in at least float32: with bf16 storage the 9-term
    density sum and the u_y difference would otherwise round at ~3
    decimal digits and read exactly 0.0 for sub-quantum flows — the
    same signal-loss reynolds() guards against (its f32-reduction fix,
    docs/NUMERICS.md)."""
    cols = cols.astype(jnp.promote_types(cols.dtype, jnp.float32))
    density = cols[0]
    for s in range(1, NSPEEDS):
        density = density + cols[s]
    u_x = ((cols[6] + cols[2]) + cols[5] - ((cols[7] + cols[4]) + cols[8])) / density
    u_y = ((cols[5] + cols[1]) + cols[8] - ((cols[6] + cols[3]) + cols[7])) / density
    return jnp.stack([density, u_x, u_y], axis=-1)


def probe_values(f: jax.Array, probes: jax.Array) -> jax.Array:
    """(rho, u_x, u_y) at probe sites. probes: (P, 2) int32 of (i, j).
    Returns (P, 3). Nine point-gathers + moments — cheap enough to run
    every step inside the scan."""
    return probe_moments(f[:, probes[:, 0], probes[:, 1]])


@partial(jax.jit, static_argnames=("cfg", "n_steps"), donate_argnums=(0,))
def run_steps_probed(
    f: jax.Array,
    walls: jax.Array,
    cfg: LatticeConfig,
    n_steps: int,
    probes: jax.Array,
    slip_x: jax.Array | None = None,
    slip_y: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """run_steps plus a per-step observable stream: after each step the
    scan emits (rho, u_x, u_y) at the probe sites, accumulated on device
    into a (n_steps, P, 3) series — the time-resolved equivalent of the
    reference's offline PrintLattice dumps (src/latticeboltzmann.c:610-639)
    with zero host round-trips during the run."""

    def body(carry, _):
        nf = step(carry, walls, cfg, slip_x, slip_y)
        return nf, probe_values(nf, probes)

    return jax.lax.scan(body, f, length=n_steps)


def macroscopic(f: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """On-device rho, u_x, u_y extraction (src/latticeboltzmann.c:620-631)."""
    density = f[0]
    for s in range(1, NSPEEDS):
        density = density + f[s]
    u_x = ((f[6] + f[2]) + f[5] - ((f[7] + f[4]) + f[8])) / density
    u_y = ((f[5] + f[1]) + f[8] - ((f[6] + f[3]) + f[7])) / density
    return density, u_x, u_y


def reynolds(
    f: jax.Array, walls: jax.Array, cfg: LatticeConfig, col: int | None = None
) -> jax.Array:
    """Reynolds number over a column, default the central one
    (src/latticeboltzmann.c:522-547). `col` overrides the probe column
    — at very wide lattices the flow physically cannot reach ny/2
    within a short run (momentum spreads at ~the lattice sound speed),
    so validation probes a developed column instead.

    Accumulates in at least float32 regardless of the storage dtype so
    the reduction itself never loses the signal. Note the bf16
    4000x16000 row still reads exactly 0.0 at ny/2 even in f32: the
    *stored state* at an unreached column is bitwise rest equilibrium
    at bf16 resolution (u_y ~ 1e-6 rounds into the 8-bit mantissa of
    f ~ 0.04), so zero is the true value of the stored field there —
    probe a developed column instead (bench_suite does)."""
    j = int(cfg.ny / 2.0) if col is None else col
    dt = jnp.promote_types(f.dtype, jnp.float32)
    col_f = f[:, :, j].astype(dt)
    fluid = ~walls[:, j]
    density = col_f[0]
    for s in range(1, NSPEEDS):
        density = density + col_f[s]
    u_y = ((col_f[5] + col_f[1]) + col_f[8] - ((col_f[6] + col_f[3]) + col_f[7])) / density
    total = jnp.sum(jnp.where(fluid, u_y, jnp.zeros((), dt)))
    n = jnp.sum(fluid).astype(dt)
    visc = jnp.asarray(cfg.viscosity, dt)
    return total / n * jnp.asarray(10.0, dt) / visc

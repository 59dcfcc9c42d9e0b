"""One D2Q9 timestep as a single Pallas kernel on the Triton route.

Each program of a 2-D grid owns a (rows x cols) tile of the lattice and
reads each of the nine planes once through a gather of pull offsets:
pulled_s(i, j) = f_s(i - e_x, j - e_y), with the periodic wrap folded
into the row and column indices. The column-0 forcing of
`stream_collide.apply_source` is applied to the pulled values whose
source column is 0, then BGK relaxes fluid sites and a per-site class
plane selects bounce-back or free-slip reflection. One step reads 9
planes plus the class plane and writes 9 planes; nothing else touches
device memory.

Tail tiles clamp their indices to the last row or column and mask the
store, so any NX and NY work with power-of-two tiles. The arithmetic is
`stream_collide.collide_planes`, the XLA engine's own expression.
Storage may be float32, float64 or bfloat16; bfloat16 computes in
float32 and rounds on store, as the XLA engine does.

`interpret=True` runs the same kernel through the Pallas interpreter,
which is how the CPU tests reach it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.spec import E, NSPEEDS, OPPOSITE, REFLECT_X, REFLECT_Y, LatticeConfig
from . import stream_collide as xla_ops

# per-site classes of the class plane; precedence wall > slip_x > slip_y
FLUID, WALL, SLIP_X, SLIP_Y = 0, 1, 2, 3

# (rows, cols) of one program's tile, and warps per program: the
# fastest of a sweep on an H100 at 800x4000 and 4000x16000 f32 (PERF.md)
DEFAULT_BLOCK = (1, 1024)
NUM_WARPS = 8


def class_plane(walls, slip_x=None, slip_y=None) -> jax.Array:
    """int8 (NX, NY) site classes from the boolean masks."""
    cls = jnp.full(walls.shape, FLUID, jnp.int8)
    if slip_y is not None:
        cls = jnp.where(slip_y, jnp.int8(SLIP_Y), cls)
    if slip_x is not None:
        cls = jnp.where(slip_x, jnp.int8(SLIP_X), cls)
    return jnp.where(walls, jnp.int8(WALL), cls)


def block_shape(nx: int, ny: int, block: tuple[int, int] | None = None) -> tuple[int, int]:
    """Tile shape for an (nx, ny) lattice: `block` (default DEFAULT_BLOCK),
    each side cut to the lattice's next power of two so a small lattice
    is one tile."""
    br, bc = DEFAULT_BLOCK if block is None else block
    for b in (br, bc):
        if b < 1 or b & (b - 1):
            raise ValueError(f"block sides must be powers of two, got {(br, bc)}")
    return min(br, pl.next_power_of_2(nx)), min(bc, pl.next_power_of_2(ny))


def grid_shape(nx: int, ny: int, block: tuple[int, int]) -> tuple[int, int]:
    """Programs along rows and columns; the last of each may be partial."""
    return pl.cdiv(nx, block[0]), pl.cdiv(ny, block[1])


def _wrapped(idx, n: int) -> dict:
    """Source index of a pull along one axis for each lattice offset e:
    idx - e with periodic wrap (idx is already inside [0, n))."""
    return {
        0: idx,
        1: jnp.where(idx == 0, n - 1, idx - 1),
        -1: jnp.where(idx == n - 1, 0, idx + 1),
    }


def _kernel(f_ref, cls_ref, o_ref, *, cfg: LatticeConfig, block: tuple[int, int]):
    nx, ny = cfg.nx, cfg.ny
    plane = nx * ny
    br, bc = block
    dt = xla_ops._compute_dtype(cfg)
    storage = o_ref.dtype

    i = pl.program_id(0) * br + jnp.arange(br, dtype=jnp.int32)
    j = pl.program_id(1) * bc + jnp.arange(bc, dtype=jnp.int32)
    inside = (i < nx)[:, None] & (j < ny)[None, :]
    i = jnp.minimum(i, nx - 1)
    j = jnp.minimum(j, ny - 1)
    rows = _wrapped(i, nx)
    cols = _wrapped(j, ny)

    # forcing guard of the source rows' column 0, one vector per e_x
    ok = {}
    for ex in (-1, 0, 1):
        r0 = rows[ex] * ny
        f3, f6, f7 = (f_ref[s * plane + r0].astype(dt) for s in (3, 6, 7))
        ok[ex] = xla_ops.source_ok(f3, f6, f7, cls_ref[r0] != FLUID, cfg)

    delta = xla_ops.source_delta(cfg)
    pulled = []
    for s in range(NSPEEDS):
        ex, ey = int(E[s, 0]), int(E[s, 1])
        v = f_ref[s * plane + rows[ex][:, None] * ny + cols[ey][None, :]].astype(dt)
        if delta[s]:
            forced = (v + delta[s]).astype(storage).astype(dt)
            v = jnp.where((cols[ey] == 0)[None, :] & ok[ex][:, None], forced, v)
        pulled.append(v)

    out = xla_ops.collide_planes(pulled, cfg)
    site = i[:, None] * ny + j[None, :]
    cls = cls_ref[site]
    for s in range(NSPEEDS):
        o = jnp.where(cls == SLIP_Y, pulled[REFLECT_Y[s]], out[s])
        o = jnp.where(cls == SLIP_X, pulled[REFLECT_X[s]], o)
        o = jnp.where(cls == WALL, pulled[OPPOSITE[s]], o)
        # masked lanes aim past the state: the card skips them, and the
        # interpreter's scatter drops them instead of landing on the
        # clamped duplicate of a real site
        dest = jnp.where(inside, s * plane + site, NSPEEDS * plane)
        plgpu.store(o_ref.at[dest], o.astype(storage), mask=inside)


def step(
    f: jax.Array,
    cls: jax.Array,
    cfg: LatticeConfig,
    *,
    block: tuple[int, int] | None = None,
    interpret: bool = False,
) -> jax.Array:
    """One timestep (forcing, pull, collide, bounce) of (9, NX, NY) `f`
    with the int8 class plane `cls` (see class_plane)."""
    nx, ny = cfg.nx, cfg.ny
    if f.shape != (NSPEEDS, nx, ny):
        raise ValueError(f"state shape {f.shape} != {(NSPEEDS, nx, ny)}")
    if NSPEEDS * nx * ny >= 2**31:
        raise ValueError(f"{nx}x{ny} exceeds the kernel's int32 offsets")
    blk = block_shape(nx, ny, block)
    out = pl.pallas_call(
        partial(_kernel, cfg=cfg, block=blk),
        out_shape=jax.ShapeDtypeStruct((NSPEEDS * nx * ny,), f.dtype),
        grid=grid_shape(nx, ny, blk),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="lbm_d2q9_step",
    )(f.reshape(-1), cls.reshape(-1))
    return out.reshape(NSPEEDS, nx, ny)


@partial(
    jax.jit, static_argnames=("cfg", "n_steps", "block", "interpret"), donate_argnums=(0,)
)
def run_steps(
    f: jax.Array,
    walls: jax.Array,
    cfg: LatticeConfig,
    n_steps: int,
    slip_x: jax.Array | None = None,
    slip_y: jax.Array | None = None,
    *,
    block: tuple[int, int] | None = None,
    interpret: bool = False,
) -> jax.Array:
    """n_steps kernel launches under one jit(scan); same signature and
    results as stream_collide.run_steps."""
    cls = class_plane(walls, slip_x, slip_y)

    def body(carry, _):
        return step(carry, cls, cfg, block=block, interpret=interpret), None

    out, _ = jax.lax.scan(body, f, length=n_steps)
    return out

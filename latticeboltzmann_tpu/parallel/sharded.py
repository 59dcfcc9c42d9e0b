"""Multi-device lattice sharding — the re-design of the
reference's MPI row decomposition (README.md:44-57, mpi-runtimes.dat).

The lattice's x (row) axis is sharded over a 1-D device mesh with
`shard_map`. The pull-scheme stream needs each shard's neighbor boundary
rows, so each step exchanges one row of the three up-moving speed planes
(2,5,6 — e_x=+1) downward and one row of the three down-moving planes
(4,7,8 — e_x=-1) upward via `jax.lax.ppermute` (NCCL on GPUs) — the equivalent of
the reference's MPI_Isend/Irecv halo exchange of boundary rows.

Two compute schedules, mirroring the reference's two MPI modes:

- overlap=False: exchange halos, then compute the whole padded block
  (the reference's "exchange, then compute" mode).
- overlap=True: the step is expressed so interior rows (no halo
  dependency) are computable while the ppermute is in flight, exactly
  like the reference's interior/boundary split (img/comms-overlap.png);
  XLA's latency-hiding scheduler overlaps the collective with the
  interior work because there is no data dependency.

Both schedules compute bit-identical results (tests assert this), and
match the unsharded engine.

The whole n-step loop runs as `lax.scan` *inside* one shard_map region:
per step the only communication is the two neighbor ppermutes; there are
zero host round-trips and zero resharding collectives.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.spec import E, NSPEEDS, REFLECT_X, REFLECT_Y, LatticeConfig
from ..ops import stream_collide as ops

# Speeds that pull from the row above (e_x=+1) / below (e_x=-1).
UP_SPEEDS = (2, 5, 6)
DOWN_SPEEDS = (4, 7, 8)

AXIS = "x"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the lattice's x axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def _exchange_halos(f_local: jax.Array):
    """Neighbor boundary-row exchange (reference: README.md:45 — exchange
    before Stream). Returns (top_halo, bot_halo):

    - top_halo: (3, 1, NY) rows of speeds 2,5,6 from the *upper* neighbor's
      last row (global row r0-1), needed to pull at local row 0.
    - bot_halo: (3, 1, NY) rows of speeds 4,7,8 from the *lower* neighbor's
      first row (global row r0+L), needed to pull at local row L-1.
    """
    n = jax.lax.axis_size(AXIS)
    down = [(i, (i + 1) % n) for i in range(n)]  # send toward larger x
    up = [(i, (i - 1) % n) for i in range(n)]    # send toward smaller x
    send_down = f_local[np.asarray(UP_SPEEDS), -1:, :]   # my last row -> next dev
    send_up = f_local[np.asarray(DOWN_SPEEDS), :1, :]    # my first row -> prev dev
    top_halo = jax.lax.ppermute(send_down, AXIS, down)
    bot_halo = jax.lax.ppermute(send_up, AXIS, up)
    return top_halo, bot_halo


def _pull_padded(f_local, top_halo, bot_halo):
    """Pull gather on the local block given halo rows. y wraps locally
    (y is unsharded); x uses halo rows instead of a wrap."""
    L = f_local.shape[1]
    pulled = []
    for s in range(NSPEEDS):
        ex, ey = int(E[s, 0]), int(E[s, 1])
        plane = jnp.roll(f_local[s], ey, axis=1) if ey else f_local[s]
        if ex == 0:
            pulled.append(plane)
        elif ex == 1:
            halo = top_halo[UP_SPEEDS.index(s)]
            halo = jnp.roll(halo, ey, axis=1) if ey else halo
            pulled.append(jnp.concatenate([halo, plane[:-1]], axis=0))
        else:
            halo = bot_halo[DOWN_SPEEDS.index(s)]
            halo = jnp.roll(halo, ey, axis=1) if ey else halo
            pulled.append(jnp.concatenate([plane[1:], halo], axis=0))
    return jnp.stack(pulled)


def _finish(pulled, walls_local, cfg, slip_x_l=None, slip_y_l=None):
    """Collide + masked bounce-back (and optional free-slip specular
    reflection) on already-pulled distributions. Precedence walls >
    slip_x > slip_y, matching ops.stream_collide — including its
    mixed-precision contract: with bf16 storage the arithmetic runs in
    f32 and rounds back on return (ops.collide expects compute-dtype
    inputs; feeding it raw bf16 would also promote the scan carry)."""
    storage = pulled.dtype
    pulled = pulled.astype(ops._compute_dtype(cfg))
    relaxed = ops.collide(pulled, cfg)
    if slip_y_l is not None:
        relaxed = jnp.where(slip_y_l[None, :, :], pulled[np.asarray(REFLECT_Y)], relaxed)
    if slip_x_l is not None:
        relaxed = jnp.where(slip_x_l[None, :, :], pulled[np.asarray(REFLECT_X)], relaxed)
    bounced = pulled[np.asarray(ops.OPPOSITE)]
    return jnp.where(walls_local[None, :, :], bounced, relaxed).astype(storage)


def _step_local(f_local, walls_local, cfg: LatticeConfig, overlap: bool,
                slip_x_l=None, slip_y_l=None):
    """One timestep on a local row block: forcing, halo exchange, fused
    stream+collide. With overlap=True the interior rows' compute has no
    dependency on the ppermute results, so XLA can hide the collective —
    the reference's Isend/compute-interior/Waitall/compute-boundary
    schedule (README.md:45-51) expressed dataflow-style."""
    solid = walls_local
    if slip_x_l is not None:
        solid = solid | slip_x_l
    if slip_y_l is not None:
        solid = solid | slip_y_l
    f_local = ops.apply_source(f_local, solid, cfg)
    top_halo, bot_halo = _exchange_halos(f_local)

    def finish(pulled, sl):
        return _finish(
            pulled, walls_local[sl], cfg,
            None if slip_x_l is None else slip_x_l[sl],
            None if slip_y_l is None else slip_y_l[sl],
        )

    if not overlap:
        pulled = _pull_padded(f_local, top_halo, bot_halo)
        return finish(pulled, slice(None))

    # Interior rows [1, L-1): pure local pull (rows 0..L-1 suffice).
    interior = ops.pull(f_local)[:, 1:-1, :]
    # jnp-roll-based pull wraps x locally; rows 1..L-2 never read the
    # wrapped rows, so the interior slice equals the true pull.
    out_interior = finish(interior, slice(1, -1))

    # Boundary rows 0 and L-1: need the halos.
    pulled_all = _pull_padded(f_local, top_halo, bot_halo)
    out_top = finish(pulled_all[:, :1, :], slice(None, 1))
    out_bot = finish(pulled_all[:, -1:, :], slice(-1, None))
    return jnp.concatenate([out_top, out_interior, out_bot], axis=1)


def make_run_steps(mesh: Mesh, cfg: LatticeConfig, *, overlap: bool = True,
                   slip: bool = False):
    """Build a jitted (f, walls, n_steps) -> f over the mesh. f is
    (9, NX, NY) sharded on axis 1; walls (NX, NY) sharded on axis 0.
    With slip=True the signature becomes
    (f, walls, slip_x, slip_y, n_steps) -> f (masks sharded like walls)."""

    fspec = P(None, AXIS, None)
    wspec = P(AXIS, None)

    if slip:
        def sharded_loop_slip(f_local, walls_local, sx_l, sy_l, n_steps):
            def body(carry, _):
                return _step_local(carry, walls_local, cfg, overlap, sx_l, sy_l), None

            out, _ = jax.lax.scan(body, f_local, length=n_steps)
            return out

        @partial(jax.jit, static_argnames=("n_steps",), donate_argnums=(0,))
        def run_steps_slip(f, walls, slip_x, slip_y, n_steps: int):
            shmapped = jax.shard_map(
                partial(sharded_loop_slip, n_steps=n_steps),
                mesh=mesh,
                in_specs=(fspec, wspec, wspec, wspec),
                out_specs=fspec,
            )
            return shmapped(f, walls, slip_x, slip_y)

        return run_steps_slip

    def sharded_loop(f_local, walls_local, n_steps):
        def body(carry, _):
            return _step_local(carry, walls_local, cfg, overlap), None

        out, _ = jax.lax.scan(body, f_local, length=n_steps)
        return out

    @partial(jax.jit, static_argnames=("n_steps",), donate_argnums=(0,))
    def run_steps(f, walls, n_steps: int):
        shmapped = jax.shard_map(
            partial(sharded_loop, n_steps=n_steps),
            mesh=mesh,
            in_specs=(fspec, wspec),
            out_specs=fspec,
        )
        return shmapped(f, walls)

    return run_steps


def shard_state(mesh: Mesh, f, walls):
    """Place global arrays with the row-decomposed sharding."""
    f = jax.device_put(f, NamedSharding(mesh, P(None, AXIS, None)))
    walls = jax.device_put(walls, NamedSharding(mesh, P(AXIS, None)))
    return f, walls


def make_backend(mesh: Mesh | None = None, *, overlap: bool = True):
    """Adapt to the Simulation backend signature
    run(f, walls, cfg, n_steps). Caches the per-(mesh, cfg, overlap)
    compiled runner."""
    cache: dict = {}

    def run(f, walls, cfg, n_steps, slip_x=None, slip_y=None):
        m = mesh if mesh is not None else make_mesh()
        slip = slip_x is not None or slip_y is not None
        key = (m, cfg, overlap, slip)
        if key not in cache:
            cache[key] = make_run_steps(m, cfg, overlap=overlap, slip=slip)
        f, walls = shard_state(m, f, walls)
        if slip:
            wsharding = NamedSharding(m, P(AXIS, None))
            sx = jnp.zeros(walls.shape, bool) if slip_x is None else jnp.asarray(slip_x, bool)
            sy = jnp.zeros(walls.shape, bool) if slip_y is None else jnp.asarray(slip_y, bool)
            sx = jax.device_put(sx, wsharding)
            sy = jax.device_put(sy, wsharding)
            return cache[key](f, walls, sx, sy, n_steps)
        return cache[key](f, walls, n_steps)

    return run

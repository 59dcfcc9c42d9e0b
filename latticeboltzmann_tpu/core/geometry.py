"""Wall-geometry builders.

Walls are a boolean (NX, NY) mask; True = solid (bounce-back) site.
The default scene reproduces the reference's InitializeArrays geometry
(src/latticeboltzmann.c:567-578): solid top/bottom rows plus a 200x5
barrier block, giving the channel-with-plate wake scene of img/flow.gif.
"""

from __future__ import annotations

import numpy as np


def empty(nx: int, ny: int) -> np.ndarray:
    """Fully periodic fluid box, no walls."""
    return np.zeros((nx, ny), dtype=bool)


def channel(nx: int, ny: int) -> np.ndarray:
    """Channel: solid rows at i=0 and i=NX-1 (src/latticeboltzmann.c:575-578)."""
    walls = empty(nx, ny)
    walls[0, :] = True
    walls[nx - 1, :] = True
    return walls


def channel_with_barrier(
    nx: int,
    ny: int,
    *,
    barrier_rows: tuple[int, int] | None = None,
    barrier_cols: tuple[int, int] | None = None,
) -> np.ndarray:
    """The reference's default scene (src/latticeboltzmann.c:567-578):
    channel walls plus a flat plate at rows [20, 220) x cols [100, 105),
    scaled proportionally for other lattice sizes.
    """
    walls = channel(nx, ny)
    if barrier_rows is None:
        barrier_rows = (round(nx * 20 / 400), round(nx * 220 / 400))
    if barrier_cols is None:
        barrier_cols = (round(ny * 100 / 2000), round(ny * 105 / 2000))
    r0, r1 = barrier_rows
    c0, c1 = barrier_cols
    walls[r0:r1, c0:c1] = True
    return walls


def reference_barrier(nx: int = 400, ny: int = 2000) -> np.ndarray:
    """Exact reference geometry: barrier at rows [20,220) x cols [100,105),
    independent of lattice size (src/latticeboltzmann.c:567-573). Requires
    nx >= 220, ny >= 105."""
    return channel_with_barrier(nx, ny, barrier_rows=(20, 220), barrier_cols=(100, 105))


def channel_with_cylinder(
    nx: int,
    ny: int,
    *,
    center: tuple[float, float] | None = None,
    radius: float | None = None,
) -> np.ndarray:
    """Channel with a circular obstacle — the 'cylinder wake' benchmark scene
    (BASELINE.json config 3). Defaults: center at (NX/2, NY/8), radius NX/9.
    """
    walls = channel(nx, ny)
    if center is None:
        center = (nx / 2.0, ny / 8.0)
    if radius is None:
        radius = nx / 9.0
    ci, cj = center
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    walls |= (ii - ci) ** 2 + (jj - cj) ** 2 <= radius**2
    return walls


BUILDERS = {
    "empty": empty,
    "channel": channel,
    "barrier": channel_with_barrier,
    "reference": reference_barrier,
    "cylinder": channel_with_cylinder,
}


def build(name: str, nx: int, ny: int, **kwargs) -> np.ndarray:
    try:
        fn = BUILDERS[name]
    except KeyError:
        raise ValueError(f"unknown geometry {name!r}; options: {sorted(BUILDERS)}")
    return fn(nx, ny, **kwargs)

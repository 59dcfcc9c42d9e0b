"""The step kernel's tiling: tile and grid helpers for shapes that are
not multiples of the tile, packets that cross tile edges and the
periodic wrap, the class plane, and the lowering of the kernel to
Triton for the GPU (which this CPU-only host can do without a card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from latticeboltzmann_tpu import LatticeConfig, geometry
from latticeboltzmann_tpu.core.spec import E, NSPEEDS
from latticeboltzmann_tpu.models.engine import initial_state
from latticeboltzmann_tpu.ops import step_kernel as sk
from latticeboltzmann_tpu.ops import stream_collide as xla_ops


@pytest.mark.parametrize(
    "nx,ny,block,want",
    [
        (800, 4000, None, sk.DEFAULT_BLOCK),
        (13, 37, (4, 16), (4, 16)),
        (3, 5, (8, 256), (4, 8)),
        (2, 2, (8, 8), (2, 2)),
        (800, 4000, (16, 64), (16, 64)),
        (5, 1000, (1, 1024), (1, 1024)),
    ],
)
def test_block_shape(nx, ny, block, want):
    assert sk.block_shape(nx, ny, block) == want


@pytest.mark.parametrize("block", [(3, 16), (8, 0), (8, 100)])
def test_block_shape_rejects_non_powers_of_two(block):
    with pytest.raises(ValueError, match="powers of two"):
        sk.block_shape(64, 64, block)


@pytest.mark.parametrize(
    "nx,ny,block,want",
    [
        (800, 4000, (1, 1024), (800, 4)),
        (13, 37, (4, 16), (4, 3)),
        (16, 32, (8, 16), (2, 2)),
        (2, 2, (2, 2), (1, 1)),
    ],
)
def test_grid_covers_lattice(nx, ny, block, want):
    grid = sk.grid_shape(nx, ny, block)
    assert grid == want
    # the last tile of each axis holds the lattice's last site
    for n, g, b in zip((nx, ny), grid, block):
        assert (g - 1) * b < n <= g * b


def test_class_plane_precedence():
    walls = np.array([[1, 0, 0, 0]], bool)
    slip_x = np.array([[1, 1, 0, 0]], bool)
    slip_y = np.array([[1, 1, 1, 0]], bool)
    cls = np.asarray(sk.class_plane(jnp.asarray(walls), jnp.asarray(slip_x), jnp.asarray(slip_y)))
    assert cls.dtype == np.int8
    assert cls.tolist() == [[sk.WALL, sk.SLIP_X, sk.SLIP_Y, sk.FLUID]]
    assert np.asarray(sk.class_plane(jnp.asarray(walls))).tolist() == [[sk.WALL, 0, 0, 0]]


def test_step_rejects_wrong_state_shape():
    cfg = LatticeConfig(nx=8, ny=16, dtype=np.float32)
    cls = sk.class_plane(jnp.zeros((8, 16), bool))
    with pytest.raises(ValueError, match="state shape"):
        sk.step(jnp.zeros((9, 16, 8), np.float32), cls, cfg, interpret=True)


def test_step_rejects_lattice_beyond_int32_offsets():
    cfg = LatticeConfig(nx=16000, ny=16000, dtype=np.float32)
    f = jax.ShapeDtypeStruct((NSPEEDS, 16000, 16000), np.float32)
    cls = jax.ShapeDtypeStruct((16000, 16000), np.int8)
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(lambda f, c: sk.step(f, c, cfg), f, cls)


# 13x37 with 4x16 tiles: row tiles [0,4) [4,8) [8,12) [12]; column tiles
# [0,16) [16,32) [32,37). Sites on tile corners, and the two lattice
# corners, from which a move wraps.
PACKET_SITES = {"tile-corner": (3, 15), "last-site": (12, 36), "first-site": (0, 0)}


@pytest.mark.parametrize("site", sorted(PACKET_SITES))
@pytest.mark.parametrize("s", range(1, NSPEEDS))
def test_packet_advects_across_tile_edges(s, site):
    """A unit packet in speed s moves to (i + e_x, j + e_y), wrapped, in
    one step. tau is huge and there is no forcing, so the collision
    leaves it (almost) alone."""
    cfg = LatticeConfig(nx=13, ny=37, dtype=np.float64, tau=1e12, accel=0.0)
    i, j = PACKET_SITES[site]
    f0 = initial_state(cfg)
    f0[s, i, j] += 1.0
    cls = sk.class_plane(jnp.zeros((cfg.nx, cfg.ny), bool))
    out = np.asarray(sk.step(jnp.asarray(f0), cls, cfg, block=(4, 16), interpret=True))
    want = initial_state(cfg)
    want[s, (i + E[s, 0]) % cfg.nx, (j + E[s, 1]) % cfg.ny] += 1.0
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("block", [(1, 64), (2, 8), (8, 8), (16, 64)])
def test_results_do_not_depend_on_tiling(block):
    cfg = LatticeConfig(nx=13, ny=37, dtype=np.float32)
    walls = jnp.asarray(geometry.channel_with_barrier(cfg.nx, cfg.ny))
    f0 = jnp.asarray(initial_state(cfg))
    got = sk.run_steps(jnp.array(f0), walls, cfg, 6, block=block, interpret=True)
    ref = xla_ops.run_steps(jnp.array(f0), walls, cfg, 6)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("precision", ["f32", "bf16", "f64"])
def test_kernel_lowers_to_triton_for_cuda(precision):
    """The compiled path, as far as a host without a card can take it:
    the kernel lowers through Pallas's Triton route for the GPU."""
    dtype = {"f32": np.float32, "bf16": jnp.bfloat16, "f64": np.float64}[precision]
    cfg = LatticeConfig(nx=24, ny=40, dtype=dtype)
    f = jax.ShapeDtypeStruct((NSPEEDS, cfg.nx, cfg.ny), dtype)
    walls = jax.ShapeDtypeStruct((cfg.nx, cfg.ny), bool)
    lowered = sk.run_steps.trace(f, walls, cfg, 2).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text and "lbm_d2q9_step" in text

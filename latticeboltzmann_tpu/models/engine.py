"""Simulation facade — the framework's main user-facing API.

Wraps a functional backend (XLA roll-based, fused Pallas, or sharded
multi-device) behind the stateful run/diagnose surface that the reference's
main() exposes (src/latticeboltzmann.c:127-182): initialize, advance n
steps, report Reynolds/MLUPS, dump fields.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry
from ..core.spec import LatticeConfig, W, NSPEEDS
from ..ops import stream_collide as xla_ops

# backend name -> run_steps(f, walls, cfg, n_steps) -> f
_BACKENDS: dict[str, Callable] = {}


def register_backend(name: str, run_steps: Callable) -> None:
    _BACKENDS[name] = run_steps


register_backend("xla", xla_ops.run_steps)


def _register_ds():
    from ..ops import ds_engine

    # DP-class compensated f32-pair engine (ops/ds_engine.py)
    register_backend("xla-ds64", lambda f, w, cfg, n, **kw: ds_engine.run_steps(f, w, cfg, n))


_register_ds()

# backends whose state is a df64.DS pair (logical precision ~2^-48;
# cfg.dtype is float64 — the *host-side* precision of state()/f0)
_DS_BACKENDS = {"xla-ds64"}

# backends that accept slip_x/slip_y kwargs (free-slip specular walls)
_SLIP_BACKENDS = {"xla", "pallas", "pallas-interpret", "sharded", "sharded-sync"}


def _register_pallas():
    from ..ops import step_kernel

    # one fused step kernel per timestep (Pallas, Triton route); the
    # interpreter twin runs the same kernel on any backend, for tests
    register_backend("pallas", step_kernel.run_steps)
    register_backend(
        "pallas-interpret",
        lambda f, w, cfg, n, **kw: step_kernel.run_steps(f, w, cfg, n, interpret=True, **kw),
    )


_register_pallas()


def _register_sharded():
    from ..parallel import sharded

    # overlapped halo exchange (reference's fast MPI mode) and the
    # synchronous exchange-then-compute mode (its baseline mode)
    register_backend("sharded", sharded.make_backend(overlap=True))
    register_backend("sharded-sync", sharded.make_backend(overlap=False))


_register_sharded()


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


# the single-device engine measured fastest end to end on the GPU
# (PERF.md); "auto" takes it there and the XLA engine on other platforms
GPU_BACKEND = "pallas"


def resolve_backend(name: str) -> str:
    """Map "auto" to a registered backend for the default JAX platform."""
    if name != "auto":
        return name
    return GPU_BACKEND if jax.default_backend() == "gpu" else "xla"


def initial_state(cfg: LatticeConfig) -> np.ndarray:
    """Rest-equilibrium initial fill (src/latticeboltzmann.c:583-591)."""
    f = np.empty((NSPEEDS, cfg.nx, cfg.ny), dtype=np.dtype(cfg.dtype))
    rho = np.asarray(cfg.initial_density, dtype=np.dtype(cfg.dtype))
    for s in range(NSPEEDS):
        f[s] = rho * np.asarray(W[s], dtype=np.dtype(cfg.dtype))
    return f


class Simulation:
    """A running lattice. `backend` selects the compute path:

    - "xla":    portable jnp.roll-based fused step (ops/stream_collide.py)
    - "pallas": one fused Pallas kernel per step (ops/step_kernel.py)
    - "sharded": multi-device row-decomposed path (parallel/sharded.py),
      the equivalent of the reference's MPI mode (README.md:44-57)
    """

    def __init__(
        self,
        cfg: LatticeConfig,
        walls: np.ndarray | None = None,
        *,
        backend: str = "xla",
        f0: np.ndarray | None = None,
        slip_x: np.ndarray | None = None,
        slip_y: np.ndarray | None = None,
    ):
        self.cfg = cfg
        if walls is None:
            walls = geometry.channel_with_barrier(cfg.nx, cfg.ny)
        if walls.shape != (cfg.nx, cfg.ny):
            raise ValueError(f"walls shape {walls.shape} != lattice {(cfg.nx, cfg.ny)}")
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {available_backends()}")
        if (slip_x is not None or slip_y is not None) and backend not in _SLIP_BACKENDS:
            raise NotImplementedError(
                f"free-slip boundaries are not implemented on the {backend!r} "
                f"backend; supported: {sorted(_SLIP_BACKENDS)}"
            )
        self.backend = backend
        self._run_steps = _BACKENDS[backend]
        self.walls_np = np.asarray(walls, dtype=bool)
        self.walls = jnp.asarray(self.walls_np)
        self.slip_x = None if slip_x is None else jnp.asarray(slip_x, bool)
        self.slip_y = None if slip_y is None else jnp.asarray(slip_y, bool)
        if backend in _DS_BACKENDS:
            from ..ops import df64, ds_engine

            if np.dtype(cfg.dtype) != np.dtype(np.float64):
                raise ValueError(
                    "ds backends carry DP-class state; construct the "
                    "LatticeConfig with dtype=np.float64 (the host-side "
                    "precision of state()/f0)"
                )
            self.f = (
                ds_engine.initial_state(cfg)
                if f0 is None
                else df64.from_f64(np.asarray(f0, np.float64))
            )
        else:
            f_init = initial_state(cfg) if f0 is None else np.asarray(f0, np.dtype(cfg.dtype))
            self.f = jnp.asarray(f_init)
        self.steps_done = 0
        self.elapsed = 0.0

    def _slip_kwargs(self) -> dict:
        if self.slip_x is None and self.slip_y is None:
            return {}
        return {"slip_x": self.slip_x, "slip_y": self.slip_y}

    def run(self, n_steps: int, *, block: bool = True) -> "Simulation":
        """Advance n_steps on device. The first call per configuration
        includes jit compilation in `elapsed`; benchmarks warm up first
        (bench.py) or use the CLI --warmup flag. The backends donate the
        state buffer, so an array read from `f` before run() is consumed."""
        t0 = time.perf_counter()
        self.f = self._run_steps(
            self.f, self.walls, self.cfg, n_steps, **self._slip_kwargs()
        )
        if block:
            jax.block_until_ready(self.f)
        self.elapsed += time.perf_counter() - t0
        self.steps_done += n_steps
        return self

    def run_probed(
        self, n_steps: int, probes: np.ndarray, *, every: int = 1, block: bool = True
    ) -> np.ndarray:
        """Advance n_steps while recording (rho, u_x, u_y) at probe sites
        every `every` steps. probes: (P, 2) int (i, j) sites. Returns the
        series as (n_steps // every, P, 3).

        On the 'xla' backend with every == 1 the whole run is a single
        jit(scan) with the probe gather fused into each step. Other
        backends run in `every`-step chunks with a device-side probe
        gather between chunks (host-side for the ds pair state); the
        series is fetched once at the end.
        """
        if n_steps % every:
            raise ValueError(f"n_steps={n_steps} not divisible by every={every}")
        probes = jnp.asarray(np.asarray(probes), jnp.int32)
        if probes.ndim != 2 or probes.shape[1] != 2:
            raise ValueError(f"probes must be (P, 2) (i, j) sites, got {probes.shape}")
        if every == 1 and self.backend == "xla":
            t0 = time.perf_counter()
            self.f, series = xla_ops.run_steps_probed(
                self.f, self.walls, self.cfg, n_steps, probes, self.slip_x, self.slip_y
            )
            if block:
                jax.block_until_ready(series)
            self.elapsed += time.perf_counter() - t0
            self.steps_done += n_steps
        elif self.backend in _DS_BACKENDS:
            # host-side f64 probe gather between chunks (diagnostic-rate
            # path; the ds state recombines on host at full precision)
            chunks = []
            for _ in range(n_steps // every):
                self.run(every, block=False)
                chunks.append(self.probe_values(probes))
            return np.stack(chunks)
        else:
            chunks = []
            for _ in range(n_steps // every):
                self.run(every, block=False)
                chunks.append(xla_ops.probe_values(self.f, probes))
            series = jnp.stack(chunks)
        return np.asarray(series)

    def probe_values(self, probes) -> np.ndarray:
        """(rho, u_x, u_y) at (P, 2) probe sites from the CURRENT state —
        the one-shot sampler behind the CLI's --probe on every backend
        (the reference's PrintLattice-style site diagnostics work in
        every precision build, src/latticeboltzmann.c:610-639). ds
        backends recombine the f32 pair to f64 on host first; the others
        gather on device."""
        probes_np = np.asarray(probes)
        if probes_np.ndim != 2 or probes_np.shape[1] != 2:
            raise ValueError(f"probes must be (P, 2) (i, j) sites, got {probes_np.shape}")
        if self.backend in _DS_BACKENDS:
            st = self.state()
            cols = st[:, probes_np[:, 0], probes_np[:, 1]]
            return np.asarray(xla_ops.probe_moments(jnp.asarray(cols)))
        return np.asarray(xla_ops.probe_values(self.f, jnp.asarray(probes_np, jnp.int32)))

    def state(self) -> np.ndarray:
        """Current state as a host array — float64 for ds backends (the
        pair recombined), the storage dtype otherwise."""
        if self.backend in _DS_BACKENDS:
            from ..ops import ds_engine

            return ds_engine.state_f64(self.f)
        return np.asarray(self.f)

    def macroscopic(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.backend in _DS_BACKENDS:
            from ..ops import ds_engine

            return ds_engine.macroscopic(self.f)
        rho, ux, uy = xla_ops.macroscopic(self.f)
        return np.asarray(rho), np.asarray(ux), np.asarray(uy)

    def speed_squared(self) -> np.ndarray:
        """|u|^2 field, the quantity PrintLattice dumps
        (src/latticeboltzmann.c:631-633)."""
        _, ux, uy = self.macroscopic()
        return np.asarray(ux * ux + uy * uy)

    def reynolds(self, col: int | None = None) -> float:
        """Reynolds number at a column (default ny/2, the reference's
        regression scalar, src/latticeboltzmann.c:522-547)."""
        if self.backend in _DS_BACKENDS:
            from ..models import golden

            st = self.state()
            if col is None:
                return golden.reynolds(st, self.walls_np, self.cfg)
            # column override: golden probes ny/2; reuse the xla reducer
            # on the recombined f64 state for other columns
            return float(
                xla_ops.reynolds(jnp.asarray(st), self.walls, self.cfg, col)
            )
        return float(xla_ops.reynolds(self.f, self.walls, self.cfg, col))

    @property
    def mlups(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.cfg.sites * self.steps_done / self.elapsed / 1e6

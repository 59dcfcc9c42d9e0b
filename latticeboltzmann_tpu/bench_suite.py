"""Benchmark suite — the five BASELINE.json configs, bf16-storage
variants and the SP/DP precision-table completion rows, after the
reference's benchmark-table methodology (README.md:66-90,
runtimes.dat / mpi-runtimes.dat): end-to-end runtime for N timesteps,
MLUPS derived as NX*NY*steps/runtime/1e6.

Every row runs through `Simulation.run`: one warm-up run of the full
step count (compilation), then timed runs ended by block_until_ready,
all recorded. Rows run only on a GPU; one JSON line per row.

Usage:  python -m latticeboltzmann_tpu.bench_suite [--steps 10000]
        [--quick] [--only 1,2,3]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


# (name, nx, ny, precision, geometry, backend, baseline_runtime_s, baseline_hw)
# "auto" is the single-device engine measured fastest on the GPU
# (models/engine.resolve_backend).
CONFIGS = [
    ("400x2000 f64 (serial C workload)", 400, 2000, "f64", "reference", "xla",
     110.31, "i5-2500K AVX 2T (README.md:70)"),
    ("400x4000 f32", 400, 4000, "f32", "reference", "auto",
     7.49, "AMD R9 280X OpenCL SP (README.md:80)"),
    ("800x4000 f32 cylinder wake + rho/u extraction", 800, 4000, "f32", "cylinder", "auto",
     14.38, "AMD R9 280X OpenCL SP (README.md:90)"),
    ("800x4000 f32 row-sharded (MPI-equivalent)", 800, 4000, "f32", "reference", "sharded",
     14.87, "13x2 Opteron 6128 MPI overlap (README.md:88)"),
    ("4000x16000 f32 large-domain", 4000, 16000, "f32", "reference", "auto",
     None, "no reference datapoint at this size"),
    ("4000x16000 bf16-storage mixed precision", 4000, 16000, "bf16", "reference", "auto",
     None, "no reference datapoint at this size"),
    ("800x4000 bf16-storage (headline scene)", 800, 4000, "bf16", "reference", "auto",
     14.38, "AMD R9 280X OpenCL SP (README.md:90)"),
    # precision-table completion: the reference publishes SP and DP at
    # each of its three lattice sizes (README.md:66-90); these three
    # rows fill the combinations the configs above don't cover
    ("400x2000 f32 (reference default scene)", 400, 2000, "f32", "reference", "auto",
     4.21, "AMD R9 280X OpenCL SP (README.md:73)"),
    ("400x4000 f64", 400, 4000, "f64", "reference", "xla",
     13.76, "AMD R9 280X OpenCL DP (README.md:80)"),
    ("800x4000 f64", 800, 4000, "f64", "reference", "xla",
     27.44, "AMD R9 280X OpenCL DP (README.md:90)"),
]


def timed_runs(sim, steps: int, runs: int) -> list[float]:
    """One untimed run of `steps` (compiles that program), then `runs`
    timed runs of it; wall seconds of each, every run blocked."""
    sim.run(steps)
    times = []
    for _ in range(runs):
        sim.elapsed = 0.0
        sim.steps_done = 0
        sim.run(steps)
        times.append(sim.elapsed)
    return times


def run_config(name, nx, ny, precision, geo, backend, steps, runs=2):
    import jax
    import numpy as np

    from . import geometry
    from .core.spec import LatticeConfig, bytes_per_site_update
    from .models.engine import Simulation, resolve_backend

    backend = resolve_backend(backend)
    x64 = jax.config.jax_enable_x64
    if precision == "f64":
        jax.config.update("jax_enable_x64", True)
        dtype = np.float64
    elif precision == "bf16":
        import jax.numpy as jnp

        dtype = jnp.bfloat16
    else:
        dtype = np.float32

    try:
        cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
        walls = geometry.build(geo, nx, ny)
        sim = Simulation(cfg, walls, backend=backend)
        times = timed_runs(sim, steps, runs)
        re = sim.reynolds()
        # physics validation: the run must show actual developed flow,
        # not just finite numbers. At very wide lattices the reference's
        # ny/2 probe column is physically unreachable within the run
        # (momentum spreads at ~the lattice sound speed: 10k steps cover
        # ~5.8k columns), so probe a column the flow has reached; the
        # output records both values.
        re_dev = re
        dev_col = None
        if abs(re) < 1e-3 and ny > 2 * steps // 3:
            dev_col = min(1000, ny // 4, max(16, steps // 3))
            re_dev = sim.reynolds(dev_col)
        # on-device macroscopic extraction is part of config 3's contract
        rho, ux, uy = sim.macroscopic()
        ok = bool(
            np.isfinite(rho).all() and np.isfinite(re) and abs(re_dev) > 1e-9
        )
    finally:
        jax.config.update("jax_enable_x64", x64)
    mlups = nx * ny * steps / min(times) / 1e6
    out = {
        "config": name,
        "lattice": f"{nx}x{ny}",
        "precision": precision,
        "backend": backend,
        "steps": steps,
        "runtime_s": min(times),
        "runs_s": times,
        "mlups": mlups,
        "achieved_GBps": mlups * bytes_per_site_update(dtype) / 1e3,
        "reynolds": float(re),
        "sane": ok,
    }
    if dev_col is not None:
        out["reynolds_developed_col"] = dev_col
        out["reynolds_developed"] = float(re_dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--quick", action="store_true", help="1000 steps per config")
    ap.add_argument("--only", default=None,
                    help="comma-separated 1-based config indices, e.g. 1,2,3")
    args = ap.parse_args(argv)
    steps = 1000 if args.quick else args.steps

    from .utils import compile_cache, device

    try:
        dev = {**device.require_gpu(), "nvidia_smi": device.nvidia_smi()}
    except RuntimeError as e:
        print(f"bench_suite: {e}", file=sys.stderr)
        return 2
    compile_cache.enable()

    if args.only is None:
        todo = CONFIGS
    else:
        todo = [CONFIGS[int(i) - 1] for i in args.only.split(",")]
    for name, nx, ny, prec, geo, backend, base_rt, base_hw in todo:
        t0 = time.time()
        r = run_config(name, nx, ny, prec, geo, backend, steps)
        r["wall_total_s"] = time.time() - t0
        r["device"] = dev
        if base_rt is not None:
            base_mlups = nx * ny * 10000 / base_rt / 1e6
            r["baseline_mlups"] = base_mlups
            r["speedup_vs_baseline"] = r["mlups"] / base_mlups
            r["baseline_hw"] = base_hw
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

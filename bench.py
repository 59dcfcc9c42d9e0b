"""Headline benchmark: 800x4000 float32 channel flow, 10,000 timesteps —
the reference's north-star row (README.md:90, R9 280X SP: 14.38 s =
2225.3 MLUPS) — on one GPU, through `Simulation.run`.

One warm-up run of the full step count compiles the program; then
`--runs` timed runs, each ended by `block_until_ready`. MLUPS is
NX*NY*steps over the best wall time; GB/s is that rate times the
single-pass traffic model (core/spec.bytes_per_site_update). Prints ONE
JSON line naming the device (platform, device_kind, count, nvidia-smi
name and power limit). Without a GPU it prints no result and exits 2.

Usage: python bench.py [--backend auto|xla|pallas] [--steps N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

BASELINE_MLUPS = 2225.3  # R9 280X OpenCL SP, 800x4000 (README.md:90)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--nx", type=int, default=800)
    ap.add_argument("--ny", type=int, default=4000)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)

    from latticeboltzmann_tpu.utils import compile_cache, device

    try:
        dev = device.require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    compile_cache.enable()

    from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu.bench_suite import timed_runs
    from latticeboltzmann_tpu.core.spec import bytes_per_site_update
    from latticeboltzmann_tpu.models.engine import resolve_backend

    backend = resolve_backend(args.backend)
    cfg = LatticeConfig(nx=args.nx, ny=args.ny, dtype=np.float32)
    # the reference's exact scene: barrier at rows [20,220) x cols
    # [100,105) independent of lattice size (src/latticeboltzmann.c:
    # 567-573) — its published 800x4000 numbers ran this geometry
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    sim = Simulation(cfg, walls, backend=backend)
    times = timed_runs(sim, args.steps, args.runs)
    best = min(times)
    mlups = cfg.sites * args.steps / best / 1e6

    # correctness guard: the run must be numerically sane (the reference
    # hard-faults on NaN via feenableexcept, src/latticeboltzmann.c:129)
    re = sim.reynolds()
    f = sim.state()
    ok = bool(np.isfinite(f).all() and (f >= 0).all() and np.isfinite(re))

    result = {
        "metric": f"MLUPS_{args.nx}x{args.ny}_f32_{backend}",
        "value": mlups,
        "unit": "MLUPS",
        "vs_baseline": mlups / BASELINE_MLUPS,
        "achieved_GBps": mlups * bytes_per_site_update(cfg.dtype) / 1e3,
        "runtime_s": best,
        "runs_s": times,
        "steps": args.steps,
        "reynolds": float(re),
        "finite_and_positive": ok,
        "device": {**dev, "nvidia_smi": device.nvidia_smi()},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

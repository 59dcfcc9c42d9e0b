"""Command-line runner — the reference's main() as a real CLI.

Every compile-time #define of the reference (src/latticeboltzmann.c:
36-65: NX, NY, TAU, CSQ, NTIMESTEPS, PRINTSTATSEVERY, SAVELATTICE[EVERY],
ACCEL, INITIALDENSITY, precision-header choice) is a runtime flag here;
jit specialization on the frozen LatticeConfig recovers the
compile-time-constant performance. Extras over the reference:
checkpoint/resume, backend selection, movie rendering, and profiler
traces.

Usage:
    python -m latticeboltzmann_tpu [--nx 400 --ny 2000 ...]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

PRECISIONS = {"f32": np.float32, "f64": np.float64, "bf16": "bfloat16"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="latticeboltzmann_tpu",
        description="D2Q9 lattice-Boltzmann (BGK) channel flow in JAX",
    )
    p.add_argument("--nx", type=int, default=400)
    p.add_argument("--ny", type=int, default=2000)
    p.add_argument("--tau", type=float, default=0.7)
    p.add_argument("--csq", type=float, default=1.0)
    p.add_argument("--accel", type=float, default=0.005)
    p.add_argument("--density", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--precision", choices=sorted(PRECISIONS), default="f32")
    p.add_argument("--backend", default="auto",
                   help="auto|xla|pallas|pallas-interpret|sharded|sharded-sync"
                        "|xla-ds64 (pair-DP; use with --precision f64). "
                        "auto takes the engine measured fastest on a GPU "
                        "(models/engine.py) and xla elsewhere")
    p.add_argument("--geometry", default="barrier",
                   help="empty|channel|barrier|reference|cylinder")
    p.add_argument("--print-stats-every", type=int, default=1000)
    p.add_argument("--save-lattice-every", type=int, default=0,
                   help="snapshot |u|^2 CSV every N steps (0 = off)")
    p.add_argument("--snapshot-dir", default="data")
    p.add_argument("--movie", default=None,
                   help="render snapshots to this gif after the run")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--checkpoint-format", choices=("raw", "orbax"), default="raw")
    p.add_argument("--probe", action="append", default=None, metavar="I,J",
                   help="record (rho,u_x,u_y) at site i,j every "
                        "--probe-every steps (repeatable)")
    p.add_argument("--probe-every", type=int, default=100)
    p.add_argument("--probe-out", default="probes.csv")
    p.add_argument("--resume", default=None,
                   help="path to a .lbmckpt directory (or 'latest')")
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace of the run here")
    p.add_argument("--debug-nans", action="store_true",
                   help="abort on NaN/inf like the reference's "
                        "feenableexcept trap (src/latticeboltzmann.c:129)")
    p.add_argument("--warmup", type=int, default=8,
                   help="steps run once before timing starts to absorb "
                        "jit compilation (state is reset afterwards); "
                        "0 disables")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from . import geometry
    from .core.spec import LatticeConfig
    from .models.engine import Simulation, resolve_backend
    from .utils import checkpoint, compile_cache, stats, viz

    compile_cache.enable()

    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    if args.precision == "f64":
        jax.config.update("jax_enable_x64", True)
    dtype = PRECISIONS[args.precision]
    if dtype == "bfloat16":
        import jax.numpy as jnp

        dtype = jnp.bfloat16

    start_step = 0
    if args.resume:
        path = args.resume
        if path == "latest":
            path = checkpoint.latest(args.checkpoint_dir)
            if path is None:
                print(f"no checkpoint found in {args.checkpoint_dir}", file=sys.stderr)
                return 2
        start_step, f0, walls, cfg = checkpoint.load(path)
        print(f"resumed from {path} at step {start_step}")
        sim = Simulation(cfg, walls, backend=resolve_backend(args.backend), f0=f0)
    else:
        cfg = LatticeConfig(
            nx=args.nx, ny=args.ny, tau=args.tau, csq=args.csq,
            accel=args.accel, initial_density=args.density, dtype=dtype,
        )
        walls = geometry.build(args.geometry, cfg.nx, cfg.ny)
        sim = Simulation(cfg, walls, backend=resolve_backend(args.backend))

    # size from the config actually used (on --resume the checkpoint's
    # dtype wins over --precision)
    mb = cfg.nx * cfg.ny * 9 * np.dtype(cfg.dtype).itemsize / 1024 / 1024
    precision = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}.get(
        np.dtype(cfg.dtype).name, str(np.dtype(cfg.dtype))
    )
    print(f"Lattice Size: {cfg.nx}x{cfg.ny} ({mb:.2f} MB) "
          f"backend={sim.backend} precision={precision}")

    profile_cm = None
    if args.profile_dir:
        profile_cm = jax.profiler.trace(args.profile_dir)
        profile_cm.__enter__()

    if args.warmup:
        # absorb kernel compilation outside the timed run, then restore
        # the state (the reference has no compile phase to exclude).
        # copy first: the backends donate their input buffer. Go through
        # sim.run so the warmed program is the one the timed run uses.
        # tree_map (not jnp.array) so the ds
        # backends' DS pair state copies leaf-wise instead of silently
        # stacking into one (2, 9, nx, ny) array.
        import jax.numpy as jnp

        f_before = jax.tree.map(lambda x: jnp.array(x, copy=True), sim.f)
        sim.run(args.warmup)
        sim.f = f_before
        sim.steps_done = 0
        sim.elapsed = 0.0

    probes = None
    probe_rows = []
    if args.probe:
        import jax.numpy as jnp

        probes = jnp.asarray(
            np.array([[int(v) for v in p.split(",")] for p in args.probe]), jnp.int32
        )

    reporter = stats.RunStats(cfg, total_steps=args.steps)
    # chunked run: stats/snapshots/checkpoints/probes between on-device
    # scans — the loop structure of main() (src/latticeboltzmann.c:148-164).
    # Each event fires at multiples of its own interval: every chunk runs
    # to the earliest upcoming due step, so mixed intervals (e.g.
    # --print-stats-every 300 --checkpoint-every 1000) and resumes from
    # unaligned steps never skip an event.
    intervals = [e for e in (args.print_stats_every, args.save_lattice_every,
                             args.checkpoint_every,
                             args.probe_every if probes is not None else 0)
                 if e]
    end = start_step + args.steps
    step = start_step
    t0 = time.perf_counter()
    while step < end:
        due = [((step // e) + 1) * e for e in intervals]
        n = min(due + [end]) - step
        sim.run(n)
        step += n
        if args.print_stats_every and step % args.print_stats_every == 0:
            reporter.report(step - start_step)
        if args.save_lattice_every and step % args.save_lattice_every == 0:
            # backend-aware extraction (ds backends carry a pair state
            # that viz.speed_squared cannot index; round-4 verdict #3)
            viz.save_snapshot_field(args.snapshot_dir, step, sim.speed_squared())
        if args.checkpoint_every and step % args.checkpoint_every == 0:
            checkpoint.save(args.checkpoint_dir, step, sim.state(), sim.walls_np, cfg,
                            format=args.checkpoint_format)
        if probes is not None and step % args.probe_every == 0:
            probe_rows.append((step, sim.probe_values(probes)))

    runtime = time.perf_counter() - t0
    if profile_cm:
        profile_cm.__exit__(None, None, None)

    stats.final_report(cfg, runtime, sim.reynolds())
    print(f"MLUPS: {sim.mlups:.1f}")

    if probe_rows:
        with open(args.probe_out, "w") as fp:
            fp.write("step,i,j,rho,u_x,u_y\n")
            sites = np.asarray(probes)
            for s, vals in probe_rows:
                for (pi, pj), (rho, ux, uy) in zip(sites, np.asarray(vals)):
                    fp.write(f"{s},{pi},{pj},{float(rho)!r},{float(ux)!r},{float(uy)!r}\n")
        print(f"probe series written to {args.probe_out}")

    if args.movie:
        out = viz.render_movie(args.snapshot_dir, args.movie)
        print(f"movie written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

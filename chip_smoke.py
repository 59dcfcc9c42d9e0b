"""Smoke run of the D2Q9 engine on one GPU, in one process.

Phases (each failure propagates, and the script then exits nonzero with
no result line):

  a. device:   platform, device_kind, count, nvidia-smi name and power
               limit, JAX version, XLA_FLAGS, compile-cache directory;
  b. served:   the CLI (cli.main) at 800x4000 f32 on the reference scene,
               with stats, one |u|^2 snapshot, one probe and one raw
               checkpoint; the final Re is finite and f >= 0;
  c. parity:   the compiled step kernel ('pallas') against the XLA engine
               at 800x4000 in f32 and bf16 storage, and both against the
               float64 golden model at 400x2000;
  e. measure:  MLUPS and GB/s of 'pallas' and 'xla' through
               Simulation.run at 800x4000 and 4000x16000 f32 — the
               measurement behind GPU_BACKEND (models/engine.py);
  d. f64:      'xla' and 'pallas' in float64 against golden, and
               'xla-ds64' behind df64.check_backend.

With --multi it runs only phase a and

  f. sharded:  'sharded' and 'sharded-sync' on every visible card at
               800x4000 f32 against the single-card 'xla' engine.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU it prints no result and exits 2.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import re
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent

# the step kernel's backend, and the sizes: the reference's headline
# lattice, the golden-model lattice, and the measured lattices (the
# headline and the large bandwidth case) with their step counts
KERNEL = "pallas"
SCENE = (800, 4000)
GOLDEN = (400, 2000)
GOLDEN_STEPS = 300
SERVED_STEPS = 2000
PARITY_STEPS = 1000
MEASURE_STEPS = {SCENE: 10000, (4000, 16000): 200}

# Tolerances, max |a - b| over the whole state (f is O(0.05) here).
# No step contains a matrix product, so TF32 never enters.
# kernel vs XLA, f32: both compute collide_planes' expression; only the
# compilers' FMA contraction and association can differ.
TOL_KERNEL_F32 = 1e-6
# kernel vs XLA, bf16 storage: a different rounding of one stored value
# is one bf16 ulp (2.4e-4 at 0.047) and can spread; allow ~8 ulps.
TOL_KERNEL_BF16 = 2e-3
# f32 vs float64 golden after 300 steps: f32 rounding of ~124 ops per
# site update accumulates (2e-7 measured on the CPU backend).
TOL_GOLDEN_F32 = 1e-6
# bf16 storage vs golden: each store rounds to 8 significant bits
# (1.3e-3 measured on the CPU backend after 300 steps).
TOL_GOLDEN_BF16 = 5e-3
# float64 engines vs golden: max relative error.
TOL_GOLDEN_F64_REL = 1e-12


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(dev: dict) -> None:
    import jax

    from latticeboltzmann_tpu.utils import compile_cache, device

    log(f"[a] device: {dev}")
    log(f"[a] nvidia-smi: {device.nvidia_smi()}")
    log(f"[a] jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {compile_cache.cache_dir()}")


def phase_served() -> None:
    from latticeboltzmann_tpu import cli
    from latticeboltzmann_tpu.utils import checkpoint

    steps = SERVED_STEPS
    nx, ny = SCENE
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([
                "--nx", str(nx), "--ny", str(ny), "--steps", str(steps),
                "--precision", "f32", "--geometry", "reference",
                "--print-stats-every", str(steps // 4),
                "--save-lattice-every", str(steps),
                "--snapshot-dir", str(tmp / "data"),
                "--probe", f"{nx // 2},{ny // 2}", "--probe-every", str(steps // 2),
                "--probe-out", str(tmp / "probes.csv"),
                "--checkpoint-every", str(steps), "--checkpoint-format", "raw",
                "--checkpoint-dir", str(tmp / "ck"),
            ])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        log("\n".join("[b] " + ln for ln in text.splitlines()))
        assert rc == 0, f"cli.main returned {rc}"
        m = re.search(r"Re ([-+0-9.eE]+)", text)
        assert m, "no final Re line"
        re_final = float(m.group(1))
        assert np.isfinite(re_final), f"final Re {re_final}"
        assert (tmp / "data" / f"{steps}.csv").exists(), "no snapshot"
        assert len((tmp / "probes.csv").read_text().splitlines()) == 3, "probe series"
        step, f, _, _ = checkpoint.load(tmp / "ck" / f"{steps}.lbmckpt")
        assert step == steps
        assert np.isfinite(f).all() and (f >= 0).all(), "checkpointed state not finite and >= 0"
    log(f"[b] served run ok: Re {re_final!r}, {wall:.1f} s wall including compilation")


def _run(backend, cfg, walls, steps):
    from latticeboltzmann_tpu import Simulation

    return Simulation(cfg, walls, backend=backend).run(steps).state().astype(np.float64)


def _max_diff(a, b) -> float:
    return float(np.abs(a - b).max())


def _check(label: str, diff: float, tol: float) -> None:
    log(f"{label}: max |diff| {diff!r} (tolerance {tol!r})")
    assert diff <= tol, f"{label}: {diff!r} > {tol!r}"


def _golden_ref():
    from latticeboltzmann_tpu import LatticeConfig, geometry
    from latticeboltzmann_tpu.models import golden

    (nx, ny), steps = GOLDEN, GOLDEN_STEPS
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float64)
    walls = geometry.reference_barrier(nx, ny)
    t0 = time.perf_counter()
    ref = golden.run(golden.initial_state(cfg), walls, cfg, steps)
    log(f"[c] golden {nx}x{ny} x {steps} steps on the host: {time.perf_counter() - t0:.1f} s")
    return walls, ref


def phase_parity(golden_ref) -> None:
    import jax.numpy as jnp

    from latticeboltzmann_tpu import LatticeConfig, geometry

    nx, ny = SCENE
    walls = geometry.reference_barrier(nx, ny)
    for name, dtype, tol in (("f32", np.float32, TOL_KERNEL_F32),
                             ("bf16", jnp.bfloat16, TOL_KERNEL_BF16)):
        cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
        k = _run(KERNEL, cfg, walls, PARITY_STEPS)
        x = _run("xla", cfg, walls, PARITY_STEPS)
        assert np.isfinite(k).all() and (k >= 0).all()
        _check(f"[c] {KERNEL} vs xla {nx}x{ny} {name} x {PARITY_STEPS} steps",
               _max_diff(k, x), tol)

    gwalls, ref = golden_ref
    for name, dtype, tol in (("f32", np.float32, TOL_GOLDEN_F32),
                             ("bf16", jnp.bfloat16, TOL_GOLDEN_BF16)):
        cfg = LatticeConfig(nx=ref.shape[1], ny=ref.shape[2], dtype=dtype)
        for backend in (KERNEL, "xla"):
            got = _run(backend, cfg, gwalls, GOLDEN_STEPS)
            _check(f"[c] {backend} {name} vs golden {cfg.nx}x{cfg.ny} x {GOLDEN_STEPS} steps",
                   _max_diff(got, ref), tol)


def phase_measure() -> None:
    import jax

    from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu.bench_suite import timed_runs
    from latticeboltzmann_tpu.core.spec import bytes_per_site_update

    for (nx, ny), steps in MEASURE_STEPS.items():
        cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float32)
        walls = geometry.reference_barrier(nx, ny)
        for backend in (KERNEL, "xla"):
            sim = Simulation(cfg, walls, backend=backend)
            times = timed_runs(sim, steps, 3)
            mlups = cfg.sites * steps / min(times) / 1e6
            log("[e] " + json.dumps({
                "lattice": f"{nx}x{ny}", "dtype": "f32", "backend": backend,
                "steps": steps, "best_s": min(times), "runs_s": times, "mlups": mlups,
                "achieved_GBps": mlups * bytes_per_site_update(cfg.dtype) / 1e3,
            }))
            del sim
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[e] peak device bytes in use: {stats.get('peak_bytes_in_use')}")


def phase_f64(golden_ref) -> None:
    import jax

    from latticeboltzmann_tpu import LatticeConfig
    from latticeboltzmann_tpu.ops import df64

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        gwalls, ref = golden_ref
        cfg = LatticeConfig(nx=ref.shape[1], ny=ref.shape[2], dtype=np.float64)
        scale = np.maximum(np.abs(ref), 1e-30)
        for backend in ("xla", KERNEL):
            got = _run(backend, cfg, gwalls, GOLDEN_STEPS)
            _check(f"[d] {backend} f64 vs golden (relative)",
                   float((np.abs(got - ref) / scale).max()), TOL_GOLDEN_F64_REL)
        ok = df64.check_backend()
        log(f"[d] df64.check_backend: {ok}")
        assert ok, "this backend contracts or cancels: xla-ds64 is invalid here"
        got = _run("xla-ds64", cfg, gwalls, GOLDEN_STEPS)
        _check("[d] xla-ds64 vs golden (relative)",
               float((np.abs(got - ref) / scale).max()), TOL_GOLDEN_F64_REL)
    finally:
        jax.config.update("jax_enable_x64", x64)


def phase_sharded(n_devices: int) -> None:
    from latticeboltzmann_tpu import LatticeConfig, geometry

    nx, ny = SCENE
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float32)
    walls = geometry.reference_barrier(nx, ny)
    ref = _run("xla", cfg, walls, PARITY_STEPS)
    for backend in ("sharded", "sharded-sync"):
        t0 = time.perf_counter()
        got = _run(backend, cfg, walls, PARITY_STEPS)
        log(f"[f] {backend} on {n_devices} cards: {time.perf_counter() - t0:.1f} s "
            f"for {PARITY_STEPS} steps including compilation")
        # the same XLA step, split into row blocks: only the compilers'
        # fusion of each program can differ
        _check(f"[f] {backend} vs single-card xla {nx}x{ny} f32 x {PARITY_STEPS} steps",
               _max_diff(got, ref), TOL_KERNEL_F32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded backends on every visible card")
    args = ap.parse_args(argv)
    try:
        from latticeboltzmann_tpu.utils import compile_cache, device
    except ImportError as e:
        print(f"chip_smoke: the engine package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    try:
        dev = device.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    compile_cache.enable()

    phase_device(dev)
    if args.multi:
        assert dev["count"] > 1, "--multi needs more than one card"
        phase_sharded(dev["count"])
    else:
        golden_ref = _golden_ref()
        phase_served()
        phase_parity(golden_ref)
        phase_measure()
        phase_f64(golden_ref)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Precision-tier accuracy measurement on the headline scene.

The reference's SP build stores float32 (~7 decimal digits); this
framework's bf16-storage config rounds each stored distribution to ~3
digits per pass (compute stays f32). Is bf16-storage SP-class on the
physics OBSERVABLES the reference reports, or a distinct tier? And
where do f32 and the ds64 pair sit against the f64 anchor? This script
measures, on the 800x4000 reference scene (bench.py's headline):

1. short-horizon trajectory tracking (500 / 2000 steps, before the
   wake turns chaotic): max relative state error and Reynolds at a
   flow-reached column vs the float64 'xla' backend (bitwise the
   golden serial-double model, tests/test_xla_parity.py);
2. conservation at 10,000 steps: total-mass drift relative to the
   initial mass (exactly conserved by the physics; forcing injects
   momentum, not mass);
3. a statistical wake observable at 10,000 steps: the time-mean and
   std of |u|^2 at three wake probes over the last 2,000 steps
   (instantaneous values are chaotic — NUMERICS.md "Why jit is not
   bitwise" — but the developed wake's statistics are the
   cross-precision comparable).

Usage: python scripts/numerics_tiers.py [--steps 10000] [--out json]
Prints one JSON document; the measured table lives in docs/NUMERICS.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--nx", type=int, default=800)
    ap.add_argument("--ny", type=int, default=4000)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry

    nx, ny = args.nx, args.ny
    walls = geometry.reference_barrier(nx, ny)
    # wake probes: downstream of the barrier (rows [20,220) x cols
    # [100,105) at reference scale), mid-wake heights
    probes = np.array([[60, 200], [120, 300], [180, 450]])
    h1, h2 = 500, 2000
    col2 = 600  # flow-reached by step 2000 (~0.58 cols/step)
    tail = 2000

    def run_tier(backend, dtype, probe_run=True):
        cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
        sim = Simulation(cfg, walls, backend=backend)
        mass0 = float(np.sum(np.asarray(sim.state(), np.float64)))
        sim.run(h1)
        st1 = np.asarray(sim.state(), np.float64)
        sim.run(h2 - h1)
        st2 = np.asarray(sim.state(), np.float64)
        re2 = float(sim.reynolds(col2))
        if probe_run:
            series = sim.run_probed(args.steps - h2, probes, every=4)
            # |u|^2 at each probe from the (rho, ux, uy) moment rows
            u2 = (series[:, 1, :] ** 2 + series[:, 2, :] ** 2)
            ntail = tail // 4
            wake_mean = np.mean(u2[-ntail:], axis=0)
            wake_std = np.std(u2[-ntail:], axis=0)
        else:
            sim.run(args.steps - h2)
            wake_mean = wake_std = None
        mass = float(np.sum(np.asarray(sim.state(), np.float64)))
        return dict(
            st1=st1, st2=st2, re2=re2,
            mass_drift_rel=(mass - mass0) / mass0,
            wake_mean=wake_mean, wake_std=wake_std,
        )

    tiers = {}
    tiers["f32"] = run_tier("pallas", np.float32)
    tiers["bf16"] = run_tier("pallas", jnp.bfloat16)
    tiers["ds64"] = run_tier("xla-ds64", np.float64, probe_run=False)
    jax.config.update("jax_enable_x64", True)
    try:
        tiers["f64"] = run_tier("xla", np.float64)
    finally:
        jax.config.update("jax_enable_x64", False)

    anchor = tiers["f64"]

    def rel_state(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    out = {"scene": f"{nx}x{ny} reference barrier", "steps": args.steps,
           "probes": probes.tolist(), "tiers": {}}
    for name, t in tiers.items():
        row = {
            "state_rel_err_500": rel_state(t["st1"], anchor["st1"]),
            "state_rel_err_2000": rel_state(t["st2"], anchor["st2"]),
            "reynolds_2000_col600": t["re2"],
            "reynolds_rel_err_2000": abs(t["re2"] - anchor["re2"])
            / max(abs(anchor["re2"]), 1e-30),
            "mass_drift_rel_10k": t["mass_drift_rel"],
        }
        if t["wake_mean"] is not None:
            row["wake_u2_mean"] = [float(x) for x in t["wake_mean"]]
            row["wake_u2_std"] = [float(x) for x in t["wake_std"]]
        out["tiers"][name] = row
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

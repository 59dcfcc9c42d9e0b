"""DP-class validation of the double-single backends at reference scale.

Runs the reference's default scene (400x2000 barrier,
src/latticeboltzmann.c:40-47/567-573) for N steps on the ds engine
AND on the float64 'xla' backend — which is
bitwise the golden serial-double model (tests/test_xla_parity.py) and
therefore a tractable stand-in for golden at sizes where the NumPy
oracle would take hours — then compares:

- the Reynolds regression scalar (the reference's own validation
  metric, src/latticeboltzmann.c:522-547): DP-class target <= 1e-9
  relative;
- full-state max relative error;
- total mass drift (sum f) of each path vs the initial mass.

Usage: python scripts/validate_ds.py [--steps 2000] [--nx 400] [--ny 2000]
Prints one JSON line; exits nonzero if the Reynolds criterion fails.
The measured numbers are recorded in docs/NUMERICS.md.
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
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=2000)
    ap.add_argument("--backend", default="xla-ds64", help="ds backend under test")
    args = ap.parse_args()

    import jax

    from latticeboltzmann_tpu import LatticeConfig, Simulation, geometry

    cfg = LatticeConfig(nx=args.nx, ny=args.ny, dtype=np.float64)
    walls = geometry.channel_with_barrier(cfg.nx, cfg.ny)

    ds = Simulation(cfg, walls, backend=args.backend)
    mass0 = float(np.sum(ds.state()))
    ds.run(args.steps)
    st_ds = ds.state()
    re_ds = ds.reynolds()

    # float64 reference (bitwise the golden serial-double model)
    jax.config.update("jax_enable_x64", True)
    try:
        ref = Simulation(cfg, walls, backend="xla")
        ref.run(args.steps)
        st_64 = ref.state()
        re_64 = ref.reynolds()
    finally:
        jax.config.update("jax_enable_x64", False)

    state_rel = float(
        np.max(np.abs(st_ds - st_64) / np.maximum(np.abs(st_64), 1e-30))
    )
    re_rel = abs(re_ds - re_64) / max(abs(re_64), 1e-30)
    out = {
        "scene": f"{args.nx}x{args.ny} channel_with_barrier",
        "steps": args.steps,
        "backend": args.backend,
        "reynolds_ds": re_ds,
        "reynolds_f64": re_64,
        "reynolds_rel_err": float(re_rel),
        "reynolds_pass_1e-9": bool(re_rel <= 1e-9),
        "state_max_rel_err": state_rel,
        "mass_drift_ds": float(np.sum(st_ds)) - mass0,
        "mass_drift_f64": float(np.sum(st_64)) - mass0,
    }
    print(json.dumps(out))
    return 0 if re_rel <= 1e-9 else 1


if __name__ == "__main__":
    sys.exit(main())

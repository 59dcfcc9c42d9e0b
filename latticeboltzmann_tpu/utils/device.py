"""The device a measurement ran on, and the refusal to measure without
a GPU: a timing taken on the CPU backend says nothing about the card."""

from __future__ import annotations

import subprocess

import jax


def nvidia_smi() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them. The
    power limit bounds the clocks under load, so it goes beside every
    number."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    if out.returncode:
        return f"unavailable (nvidia-smi rc={out.returncode})"
    return out.stdout.strip()


def describe(devices=None) -> dict:
    """Platform, device_kind and count as JAX reports them."""
    devices = jax.devices() if devices is None else devices
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def require_gpu(devices=None) -> dict:
    """describe(), or RuntimeError when JAX's first device is no GPU."""
    info = describe(devices)
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {info['platform']!r} "
            f"({info['kind']}); this measurement runs only on a GPU"
        )
    return info

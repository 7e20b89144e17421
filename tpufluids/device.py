"""The accelerator a measurement ran on.

Every number ``bench.py`` and ``chip_smoke.py`` print names the device:
JAX's platform, device kind and device count, and the card's name and
power limit as ``nvidia-smi`` reports them (a card set below its
maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess


def nvidia_smi_name_power() -> str:
    """``name, power.limit`` of each card, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def describe() -> dict:
    """{"platform", "kind", "count"} as JAX reports the devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """describe(), or RuntimeError when JAX found no GPU: a measurement
    never falls back to the CPU."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {dev['platform']}")
    return dev

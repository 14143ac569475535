"""The device a measurement runs on, for entry points that must not fall
back to the CPU (``bench.py``, ``chip_smoke.py``)."""
from __future__ import annotations

import subprocess
import sys

__all__ = ["card_info", "device_record", "require_gpu"]


def require_gpu():
    """``jax.devices()``, or exit with status 2 (and print nothing on
    standard output) when the first device is not a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write(
            f"needs a GPU; JAX found {devices[0].platform!r} devices only\n")
        raise SystemExit(2)
    return devices


def card_info() -> str:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reports
    them, read in a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_record(devices, card: str) -> dict:
    """What every result line names: platform, kind, count and the card."""
    name, _, limit = card.partition(",")
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "card": name.strip(), "power_limit": limit.strip()}

"""Which device a measurement ran on.

Every benchmark result names the JAX device it ran on (platform, kind and
count) and, on an NVIDIA card, the card's name and power limit as
``nvidia-smi`` reports them — a card capped below its maximum power runs
slower under load, so a time means nothing without its limit. The
``nvidia-smi`` query runs in a child process that does not import JAX.
"""

from __future__ import annotations

import shutil
import subprocess

NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def device_info() -> dict:
    """{platform, kind, count} of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def nvidia_smi_line():
    """``name, power.limit`` of each card, as nvidia-smi prints them, or
    None when ``nvidia-smi`` is absent (a CPU run)."""
    if shutil.which(NVIDIA_SMI_QUERY[0]) is None:
        return None
    return subprocess.run(
        NVIDIA_SMI_QUERY, check=True, capture_output=True, text=True,
        timeout=60,
    ).stdout.strip()


def card_info() -> dict:
    """{"name", "power_limit"} of the first card (None values on a CPU)."""
    line = nvidia_smi_line()
    if not line:
        return {"name": None, "power_limit": None}
    name, power_limit = (x.strip() for x in line.splitlines()[0].split(",", 1))
    return {"name": name, "power_limit": power_limit}


def require_gpu(cpu_rehearsal: bool = False) -> dict:
    """The device info, after checking that JAX runs on a GPU. With
    ``cpu_rehearsal`` a CPU run is allowed (and named as such in every
    result); no other fallback exists."""
    info = device_info()
    if info["platform"] != "gpu" and not (
        cpu_rehearsal and info["platform"] == "cpu"
    ):
        raise SystemExit(
            f"no GPU: JAX runs on {info['platform']} ({info['kind']}); "
            "pass --cpu-rehearsal for a CPU rehearsal run"
        )
    return info

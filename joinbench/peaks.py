"""The yardstick's rates: the card's data-sheet memory rate by name, and the
card's name and power limit as `nvidia-smi` reads them.

A frozen copy of the port's table (`utils/timing.DEFAULT_HBM_GBPS`), kept
here so that a change to the program cannot move the benchmark's rooflines.
"""

from __future__ import annotations

import subprocess
from typing import Optional

# Device memory rate in GB/s by name, NVIDIA's data sheets; matched as a
# case-insensitive substring of `torch.cuda.get_device_name`.
HBM_GBPS = {
    "H100 80GB HBM3": 3350.0,   # the SXM part's name as the driver gives it
    "H100 SXM": 3350.0,
    "H100 PCIe": 2000.0,
    "H100 NVL": 3900.0,
}


def hbm_gbps(device_name: str) -> Optional[float]:
    """The table's memory rate for a card's name, None when it has none."""
    for key, gbps in HBM_GBPS.items():
        if key.lower() in device_name.lower():
            return gbps
    return None


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or the
    reason it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc.__class__.__name__}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi printed nothing"

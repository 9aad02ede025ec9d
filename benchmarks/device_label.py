"""The device label every measured number carries: the default device
as JAX reports it, and the card's name and power limit as ``nvidia-smi``
reports them."""

import jax


def card_line():
    """The first card's ``name, power.limit`` as ``nvidia-smi`` reports
    them, or ``None`` where there is no ``nvidia-smi``.  A card set
    below its maximum power runs slower under load, so every device
    number is reported beside this line."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def device_label() -> dict:
    """The default device as JAX reports it, plus the ``nvidia-smi``
    card line: the label every measured number carries."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_line()}

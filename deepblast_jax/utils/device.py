"""What the program runs on: the GPU check and the card's name and power
limit, which every device measurement reports beside its numbers."""

from __future__ import annotations

import subprocess
import sys

__all__ = ["card", "device_info", "require_gpu"]


def card():
    """``name, power.limit`` of the card as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def device_info():
    """The device as JAX reports it."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def require_gpu(what):
    """Exit with status 2 unless JAX's first device is a GPU: ``what`` is
    a device measurement and no other platform stands in for it."""
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"{what} needs a GPU; JAX found {platform!r}",
              file=sys.stderr)
        raise SystemExit(2)

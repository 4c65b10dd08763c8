"""
Which accelerator a measurement runs on.

Measurements name the device they ran on and refuse to run without a GPU:
they never fall back to the CPU.
"""

import subprocess


def require_gpu():
    """JAX's devices; RuntimeError unless the default backend is a GPU."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            "No GPU: JAX's default backend is "
            f"{devices[0].platform!r}; this measurement runs on a GPU only.")
    return devices


def device_info():
    """The device as JAX reports it: platform, kind and count."""
    import jax
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def card_name_and_power_limit():
    """``name, power.limit`` of each card, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()

"""Which accelerator a measurement ran on.

Speed numbers are only meaningful next to the card that produced them and
its power limit (a card set below its maximum runs slower under load), so
every measuring entry point refuses to run without a GPU and reports both.
"""

import subprocess


def require_gpu(program):
    """JAX's default device; raises SystemExit unless it is a GPU."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"{program} needs an NVIDIA GPU; JAX's default device is "
            f"{device.platform} ({device.device_kind})"
        )
    return device


def describe_devices():
    """``{"platform", "kind", "count"}`` of JAX's default devices."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_name_and_power_limit():
    """``nvidia-smi``'s ``name, power.limit`` line for each card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()

"""stage_roofline (%): the K1 / K1c stage launches' bound over their device
time, summed over the traced window's stages (yardstick.sweep_stages_ms,
each stage at its dims, mu and parity)."""

import re

STAGE = re.compile(r"stage(_chains)?_kernel")


def read(ctx):
    device_ms = ctx["trace"].device_ms(STAGE)
    if not device_ms:
        return None
    y = ctx["yardstick"]
    bound = ctx["sweeps"] * y.sweep_stages_ms(ctx["cfg"], ctx["chains"])
    return 100.0 * bound / device_ms

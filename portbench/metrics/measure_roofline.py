"""measure_roofline (%): the measurement launches' bound (K3 / K4, K3c /
K4c, their second passes included) over their device time, for the traced
window's measurements."""

import re

MEASURE = re.compile(r"plane_sums|polyakov_sums|finish_sums")


def read(ctx):
    device_ms = ctx["trace"].device_ms(MEASURE)
    if not device_ms or not ctx["measurements"]:
        return None
    y = ctx["yardstick"]
    bound = ctx["measurements"] * y.measure_ms(ctx["cfg"], ctx["chains"])
    return 100.0 * bound / device_ms

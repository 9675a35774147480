"""device_idle_share (%): 1 - the union of the device events' intervals
over the traced window's wall time."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_ms / tr.window_ms)

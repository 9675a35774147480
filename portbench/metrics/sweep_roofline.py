"""sweep_roofline (%): the bound of the traced window's work (its sweeps'
stages, reunitarizations and measurements) over the window's wall time.
It counts the same work whatever kernels implement it."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device or not ctx["sweeps"]:
        return None
    y, cfg, c = ctx["yardstick"], ctx["cfg"], ctx["chains"]
    bound = (ctx["sweeps"] * y.sweep_stages_ms(cfg, c)
             + ctx["reunits"] * y.reunit_ms(cfg, c)
             + ctx["measurements"] * y.measure_ms(cfg, c))
    return 100.0 * bound / tr.window_ms

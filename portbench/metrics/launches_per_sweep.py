"""launches_per_sweep (launches): device kernels, copies and memsets in the
traced window per sweep."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device or not ctx["sweeps"]:
        return None
    return tr.count() / ctx["sweeps"]

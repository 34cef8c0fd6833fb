"""device_idle_pct: the share of the traced window in which no operation
ran on the card (1 - the union of the device's intervals over the
window)."""


def read(run):
    p = run.profile
    if p is None or not p.busy or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)

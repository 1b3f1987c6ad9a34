"""``device_idle_pct.train``: the share of the traced training window in
which no operation ran on the device, in % (``portbench/tracing.py``)."""


def read(view):
    if "steps" not in view.work or not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)

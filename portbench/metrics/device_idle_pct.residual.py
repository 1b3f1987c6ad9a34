"""``device_idle_pct.residual``: the share of the traced window of residual
calls in which no operation ran on the device, in %
(``portbench/tracing.py``)."""


def read(view):
    if "calls" not in view.work or not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)

"""``k2_host_us``: the host's time in one call of the K2 residual entry, in
us: the program's ``residual#k2`` spans (the whole of
``ops/kernels.py::fused_residual_continuity``: the checks, the plan, the
launch) over the traced window's calls. The serving path pays this a call.
Nothing where the program records no such span."""


def read(view):
    calls = view.work.get("calls")
    try:
        from pinn_depthestimation_tpu_torch.tracing import summary
    except ImportError:  # a program without spans of its own
        return None
    s = summary().get("residual#k2")
    if not calls or s is None:
        return None
    return 1e6 * s["total_s"] / calls

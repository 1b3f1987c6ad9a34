"""``trainer_init_s``: the Trainer's construction, in s: the program's
set-up span ``trainer#init`` (the data loaded and batched to the device,
the loss and value-and-grad functions built, the optimizer made), the last
one recorded. Nothing where the program records no such span."""


def read(view):
    if "steps" not in view.work:
        return None
    try:
        from pinn_depthestimation_tpu_torch.tracing import spans
    except ImportError:  # a program without spans of its own
        return None
    inits = [s for s in spans() if s.name == "trainer#init"]
    if not inits:
        return None
    return (inits[-1].end_ns - inits[-1].start_ns) * 1e-9

"""``adam_fused_pct.train``: how often a training step's Adam update ran as
the port's one hand-written kernel, in %: the launches of
``csrc/adam_step.cu``'s kernel in the traced window, matched by name, over
the window's steps. Nothing when the window has no steps or the trace holds
no such kernel (a program that updates through torch's own Adam)."""

KERNEL = r"::adam_kernel\("


def read(view):
    steps = view.work.get("steps")
    launches = view.ops(KERNEL)
    if not steps or not launches:
        return None
    return 100.0 * len(launches) / steps

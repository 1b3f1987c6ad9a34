"""``graphed_pct.train``: the share of the traced window's training steps
that were replays of the step's CUDA graph, in %: the program's count
``step#replay`` over the window (read by the driver into ``replays``) over
the window's steps. Nothing where the driver reads no such count."""


def read(view):
    steps, replays = view.work.get("steps"), view.work.get("replays")
    if not steps or replays is None:
        return None
    return 100.0 * replays / steps

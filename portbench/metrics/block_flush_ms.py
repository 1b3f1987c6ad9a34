"""``block_flush_ms``: the host's time to flush one block of Adam steps, in
ms: the program's ``trainer#record`` spans (``Trainer._record``: the log
rows, their echo, the checkpoint saves) over the blocks of the traced
window (its ``trainer#block`` spans). Nothing where the program records
no such span."""


def read(view):
    if "steps" not in view.work:
        return None
    try:
        from pinn_depthestimation_tpu_torch.tracing import summary
    except ImportError:  # a program without spans of its own
        return None
    spans = summary()
    record, blocks = spans.get("trainer#record"), spans.get("trainer#block")
    if record is None or blocks is None:
        return None
    return 1e3 * record["total_s"] / blocks["count"]

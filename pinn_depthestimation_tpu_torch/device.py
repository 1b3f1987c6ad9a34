"""Where the port's entry points run.

Entry points (``Predictor``, the CLI, the bench) take ``device="cuda"`` by
default and run on the CPU only when the caller asks for it. A CUDA request
on a machine without a CUDA device raises: nothing carries on quietly on
the CPU, so no CPU number can pass for a device number.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent. ``None`` means the default, ``"cuda"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch finds no CUDA device; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(dev)!r}")
    return dev

"""log.txt-compatible metrics logging + run-directory management.

Keeps the reference's observable log contract so existing tooling
(``plots.plot_log``, reference ``plots.py:142-176``) parses our runs
unchanged:

* run directory named ``<log_root>/<YYYYmmdd_HHMM>`` (reference
  ``train.py:39-43``);
* ``log.txt`` with header ``Epoch, Fidelity Loss, Residual Loss, Total Loss``
  and one ``%.5e``-formatted row per loss evaluation (reference
  ``train.py:162-173``).

Unlike the reference — which reopens the file and forces a device->host sync
*every iteration* inside the hot loop — rows are appended in buffered batches:
the training loop keeps each chunk's loss history in a device buffer and
flushes it once per chunk. (A copy of the JAX package's module, which
imports nothing of JAX.)
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable

LOG_HEADER = "Epoch, Fidelity Loss, Residual Loss, Total Loss\n"


def make_run_dir(log_root: str, name: str | None = None) -> str:
    """Create ``<log_root>/<YYYYmmdd_HHMM>`` (reference ``train.py:39-43``)."""
    if name is None:
        name = datetime.datetime.now().strftime("%Y%m%d_%H%M")
    path = os.path.join(log_root, name)
    os.makedirs(path, exist_ok=True)
    return path


class LossLog:
    """Buffered writer for the reference ``log.txt`` schema."""

    def __init__(self, run_dir: str, filename: str = "log.txt"):
        self.path = os.path.join(run_dir, filename)
        if not os.path.exists(self.path) or os.stat(self.path).st_size == 0:
            with open(self.path, "w") as f:
                f.write(LOG_HEADER)

    def append(self, rows: Iterable[tuple[int, float, float, float]]) -> None:
        """``rows``: (epoch, fidelity, residual, total) tuples."""
        lines = [
            f"{epoch}, {fid:.5e}, {res:.5e}, {total:.5e}\n"
            for epoch, fid, res, total in rows
        ]
        if lines:
            with open(self.path, "a") as f:
                f.writelines(lines)

    @staticmethod
    def echo(epoch: int, fid: float, res: float, total: float) -> None:
        """Stdout echo in the reference's format (reference ``train.py:177``)."""
        print(
            f"Epoch {epoch}, Fidelity Loss: {fid:.5e}, "
            f"Residual Loss: {res:.5e}, Total Loss: {total:.5e}"
        )


def read_log(run_dir: str, filename: str = "log.txt"):
    """Parse a log.txt back into (epochs, fid, res, total) lists — the same
    format ``plots.plot_log`` consumes (reference ``plots.py:150-158``)."""
    epochs, fids, ress, totals = [], [], [], []
    with open(os.path.join(run_dir, filename)) as f:
        next(f)
        for line in f:
            a, b, c, d = line.split(", ")
            epochs.append(int(a))
            fids.append(float(b))
            ress.append(float(c))
            totals.append(float(d))
    return epochs, fids, ress, totals

"""Device mesh: data-parallel sharding of the collocation batches.

Counterpart of the JAX package's ``parallel/mesh.py``. The reference is
single-process, single-device and full-batch (reference ``train.py:25-32``).
The port scales the same way the JAX package does, within one step and
over points:

* parameters: one master copy on the mesh's first device; each evaluation
  copies it to every shard's device (:func:`replicate`), so autograd carries
  each shard's gradient back to the master copy;
* fidelity and collocation batches split along their leading (points) axis
  into one shard per ``data`` index (:func:`shard_batch`);
* every loss is a ratio of masked sums, so summing each shard's sufficient
  statistics and combining once gives the full-batch loss (the JAX package's
  ``psum``): each optimizer step still sees the global batch.

One process drives the whole mesh, as the JAX package's single controller
does: each shard lives on its device and every kernel launches there, and
the L-BFGS loop, the log and the checkpoints act on the one master copy.
Mesh axes are ``('data', 'model')``, as in the JAX package, but the port
has no model parallelism (a width-20 MLP has nothing to split): the model
axis is 1 and :func:`make_mesh` refuses any other size rather than leave
cards idle. Batches that do not divide the data-axis size are padded and
masked, and the losses renormalize by the mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """The data axis's devices, one shard on each (a device may repeat)."""

    data_devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.data_devices), "model": 1}

    @property
    def first_device(self) -> torch.device:
        """Where the master parameters, the optimizer and the loss live."""
        return self.data_devices[0]


def make_mesh(n_data: int | None = None, n_model: int = 1, *, devices=None) -> Mesh:
    """Build a ``('data', 'model')`` mesh over ``devices``: by default every
    visible CUDA device; the CPU only when the caller passes it (a device
    may repeat, so ``["cpu"] * 8`` is an 8-shard mesh in one CPU process,
    as the JAX tests run 8 virtual CPU devices).

    ``n_data=None`` puts every device on the data axis. ``n_model`` must be
    1: the port shards data only."""
    if n_model != 1:
        raise ValueError(f"model={n_model}: the port has no model parallelism "
                         "(parallel.model must be 1)")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"mesh devices must be CUDA devices or the CPU, got {str(d)!r}")
    if n_data is None:
        n_data = len(devices)
    if n_data > len(devices) or n_data < 1:
        raise ValueError(f"mesh {n_data}x1 needs {n_data} devices, have {len(devices)}")
    return Mesh(data_devices=tuple(devices[:n_data]))


def replicate(params: Mapping[str, torch.Tensor], mesh: Mesh) -> list[dict[str, torch.Tensor]]:
    """One copy of ``params`` per data shard, on the shard's device. The
    copies are differentiable: a gradient through a copy reaches
    ``params``."""
    return [{k: v.to(dev) for k, v in params.items()} for dev in mesh.data_devices]


def pad_to_multiple(arr: np.ndarray, multiple: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the leading axis to a multiple; returns ``(padded, valid_mask)``.

    Padding repeats the first row (not zeros) so padded rows stay in-domain
    and cannot generate inf/nan that would poison masked means through
    ``0 * inf``.
    """
    n = arr.shape[0]
    if n == 0:
        raise ValueError("cannot shard an empty batch — no data rows survived loading")
    rem = (-n) % multiple
    mask = np.ones(n + rem, dtype=np.float32)
    if rem:
        pad = np.broadcast_to(arr[:1], (rem,) + arr.shape[1:])
        arr = np.concatenate([arr, pad], axis=0)
        mask[n:] = 0.0
    return arr, mask


def shard_batch(batch: Mapping[str, np.ndarray], mesh: Mesh) -> list[dict[str, torch.Tensor]]:
    """Pad, mask and split every array of a batch dict: one dict per data
    shard, its rows on the shard's device.

    Arrays named ``<prefix>_*`` gain a companion ``<prefix>_mask`` entry
    (one per distinct prefix), as in the JAX package; the shards'
    concatenation equals the JAX package's global sharded arrays."""
    devices = mesh.data_devices
    n_data = len(devices)
    padded: dict[str, np.ndarray] = {}
    masks: dict[str, np.ndarray] = {}
    for name, arr in batch.items():
        padded[name], mask = pad_to_multiple(np.asarray(arr), n_data)
        masks[f"{name.split('_')[0]}_mask"] = mask
    padded.update(masks)
    shards = []
    for i, dev in enumerate(devices):
        shard = {}
        for name, arr in padded.items():
            rows = arr.shape[0] // n_data
            part = np.ascontiguousarray(arr[i * rows:(i + 1) * rows])
            shard[name] = torch.as_tensor(part).to(dev)
        shards.append(shard)
    return shards

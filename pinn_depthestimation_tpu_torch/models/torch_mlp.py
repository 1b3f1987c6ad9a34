"""``nn.Module`` surface over the functional MLP core.

Counterpart of the JAX package's ``models/flax_mlp.py``: the module holds
the six parameters of the functional layout as ``nn.Parameter``s and its
forward is :func:`~pinn_depthestimation_tpu_torch.models.mlp.mlp_apply`,
so the two surfaces cannot drift.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from pinn_depthestimation_tpu_torch.models.mlp import (
    PARAM_KEYS,
    MLPSpec,
    init_mlp_params,
    mlp_apply,
    mlp_apply_with_tangents,
)


class PinnMLP(nn.Module):
    """``PinnMLP(spec, ...)(x)`` == ``mlp_apply(module.param_dict(), x, spec)``."""

    def __init__(
        self,
        spec: MLPSpec,
        *,
        device: str | torch.device,
        generator: torch.Generator | None = None,
        params: Mapping[str, torch.Tensor] | None = None,
    ):
        """Weights come from ``params`` when given, else from
        :func:`init_mlp_params` with ``generator`` (a CPU generator)."""
        super().__init__()
        self.spec = spec
        if params is None:
            if generator is None:
                raise ValueError("PinnMLP needs either params or a generator")
            params = init_mlp_params(generator, spec, device=device)
        for key in PARAM_KEYS:
            self.register_parameter(
                key, nn.Parameter(params[key].detach().to(device, torch.float32).clone())
            )

    def param_dict(self) -> dict[str, torch.Tensor]:
        return {key: getattr(self, key) for key in PARAM_KEYS}

    def forward(self, x: torch.Tensor, *, dropout_generator: torch.Generator | None = None):
        generator = dropout_generator if self.training else None
        return mlp_apply(self.param_dict(), x, self.spec, dropout_generator=generator)

    def apply_with_tangents(self, x: torch.Tensor, tangents):
        return mlp_apply_with_tangents(self.param_dict(), x, tangents, self.spec)

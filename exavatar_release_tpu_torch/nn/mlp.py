"""Linear -> GroupNorm(4) -> ReLU stacks (counterpart of
exavatar_release_tpu/nn/mlp.py): no activation after the last layer unless
``relu_final``.

Weights are ``nn.Linear``'s (C_out, C_in); the JAX package keeps (C_in,
C_out), so ``avatar/convert.py`` transposes on import. The initial draw is
the torch default range (uniform in ±1/sqrt(fan_in) for weights and biases),
taken from an explicit CPU ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(
        self,
        feat_dims: Sequence[int],
        relu_final: bool = True,
        use_gn: bool = False,
        num_groups: int = 4,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        n = len(feat_dims) - 1
        self.relu_final = relu_final
        self.linears = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, feat_dims[i], feat_dims[i + 1], device=device)
            for i in range(n)
        )
        # one GroupNorm per activated layer when use_gn, else Identity
        self.norms = nn.ModuleList(
            nn.GroupNorm(num_groups, feat_dims[i + 1], device=device)
            if use_gn and (i < n - 1 or relu_final) else nn.Identity()
            for i in range(n)
        )
        with torch.no_grad():
            for lin in self.linears:
                bound = 1.0 / math.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    # drawn on the CPU: the same weights on every device
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.linears)
        for i, (lin, norm) in enumerate(zip(self.linears, self.norms)):
            x = lin(x)
            if i < n - 1 or self.relu_final:
                x = torch.relu(norm(x))
        return x

"""MoE user-facing layer (port of ``deepspeed_tpu/moe/layer.py``).

``MoE`` wraps an expert module with gating and dispatch (``MOELayer``) and
optionally the PR-MoE "residual" variant: ``use_residual=True`` runs one
dense expert beside the mixture and mixes the two with a learned 2-way
coefficient.
"""

from typing import Callable, Optional

import torch
from torch import nn

from deepspeed_tpu_torch.moe.sharded_moe import MOELayer


class MoE(nn.Module):
    """Drop-in MoE block: ``forward(hidden_states)`` returns ``(output,
    l_aux, exp_counts)``. ``expert_factory`` is a zero-argument callable
    building one expert module. With ``ep_size`` > 1 the experts are split
    over the installed topology's ``ep`` axis, which must have that size
    (``MOELayer``); ``a2a_wire_bits`` is the precision of the "gmm" mode's
    expert-parallel wire."""

    def __init__(self, hidden_size, expert_factory: Callable[[], nn.Module],
                 num_experts=1, ep_size=1, k=1, capacity_factor=1.0,
                 eval_capacity_factor=1.0, min_capacity=4, use_residual=False,
                 noisy_gate_policy: Optional[str] = None, drop_tokens=True,
                 dispatch_mode="indices", a2a_wire_bits=None, device=None):
        super().__init__()
        self.deepspeed_moe = MOELayer(
            expert_factory, num_experts, k, capacity_factor, eval_capacity_factor,
            min_capacity, noisy_gate_policy, drop_tokens,
            dispatch_mode=dispatch_mode, model_dim=hidden_size, ep_size=ep_size,
            a2a_wire_bits=a2a_wire_bits, device=device)
        self.use_residual = use_residual
        if use_residual:
            self.mlp = expert_factory()
            self.coefficient = nn.Linear(hidden_size, 2, device=device)

    def forward(self, hidden_states, train=True, generator=None):
        out, l_aux, exp_counts = self.deepspeed_moe(hidden_states, train, generator)
        if self.use_residual:
            res = self.mlp(hidden_states)
            coef = torch.softmax(self.coefficient(hidden_states), dim=-1)
            out = out * coef[..., 0:1] + res * coef[..., 1:2]
        return out, l_aux, exp_counts

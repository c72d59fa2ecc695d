"""The 1-bit optimizer family (port of ``deepspeed_tpu/ops/onebit.py``).

OneBitAdam, ZeroOneAdam and OneBitLamb, as the JAX package states them:
each is a local transform of gradients that arrive already averaged over
the data-parallel world (the engine's reduction), applying the compression
operator with error feedback to the momentum:

- warmup (``count <= freeze_step``): exact Adam / LAMB, both moments
  updated;
- compression (``count > freeze_step``): the variance is frozen, the new
  momentum plus the error buffer is sign-compressed over its whole JAX leaf
  (``runtime/comm/compressed.sign_compress``: scale ``|m + e| /
  sqrt(numel)``, zeros to +1, zeroed where the frozen variance is 0), the
  compressed value replaces the momentum and the residual becomes the error;
- OneBitAdam's update ``lr (m / bc1) / (sqrt(v / bc2) + eps) + lr wd p``;
  ZeroOneAdam's variance refreshes at steps ``16 (2^k - 1)`` (every step up
  to 16) until ``var_freeze_step`` and its update has no variance bias
  correction; OneBitLamb scales its direction (plus ``wd p``) by the JAX
  leaf's trust ratio clipped to ``[min_coeff, max_coeff]`` and frozen at
  its last warmup value.

The leaf-wide norms run over ``JaxLeaf``s (``ops/adam.py``), so they are
the JAX leaf's under stacking and ZeRO sharding. The wire-level collective
is ``runtime/comm/compressed.compressed_allreduce``.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adam import LeafOptimizer, trust_ratio
from deepspeed_tpu_torch.runtime.comm.compressed import sign_compress


def _compress(leaf, m_new, errors, v_new):
    """``sign_compress`` of ``m_new + errors`` over the JAX leaf (its norm
    and size; mask ``v_new > 0``): ``(m_eff, new_errors)``."""
    norm = leaf.norm(torch._foreach_add(m_new, errors))
    out = [sign_compress(m, e, mask=v > 0, norm=norm, numel=leaf.numel)[:2]
           for m, e, v in zip(m_new, errors, v_new)]
    return [o[0] for o in out], [o[1] for o in out]


class _OneBit(LeafOptimizer):
    state_names = ("mu", "nu", "error")

    def _moments(self, leaf, grads, states, group, t, update_var, frozen):
        """New momentum (compressed once ``frozen``) and variance, written
        into the state; returns ``(m_eff, nu)``."""
        b1, b2 = group["betas"]
        mus, nus, errs = states["mu"], states["nu"], states["error"]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1 - b1)
        if update_var:
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
        if frozen:
            m_eff, new_err = _compress(leaf, mus, errs, nus)
            torch._foreach_copy_(mus, m_eff)
            torch._foreach_copy_(errs, new_err)
        return mus, nus

    def _adam_update(self, params, mus, nus, group, bc1, bc2):
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        den = torch._foreach_div(nus, bc2) if bc2 != 1.0 else [v.clone() for v in nus]
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(mus, bc1)
        torch._foreach_div_(u, den)
        if wd:
            torch._foreach_add_(u, params, alpha=wd)
        torch._foreach_add_(params, u, alpha=-lr)


class OneBitAdam(_OneBit):
    """1-bit Adam (JAX ``onebit_adam``)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, freeze_step=100, layout=None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, freeze_step=freeze_step),
                         layout)

    def update_leaf(self, leaf, params, grads, states, group, t):
        frozen = t > group["freeze_step"]
        mus, nus = self._moments(leaf, grads, states, group, t, not frozen, frozen)
        b1, b2 = group["betas"]
        self._adam_update(params, mus, nus, group, _bc(b1, t), _bc(b2, t))


class ZeroOneAdam(_OneBit):
    """0/1 Adam (JAX ``zero_one_adam``): the local-step knobs are accepted
    and unused, as there."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, var_freeze_step=100, var_update_scaler=16,
                 layout=None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      var_freeze_step=var_freeze_step,
                                      var_update_scaler=var_update_scaler), layout)

    def update_leaf(self, leaf, params, grads, states, group, t):
        frozen = t > group["var_freeze_step"]
        scaler = group["var_update_scaler"]
        c = np.float32(t)
        k = np.floor(np.log2(c / np.float32(scaler) + np.float32(1.0)))
        next_pt = np.float32(scaler) * (np.float32(2.0) ** k - np.float32(1.0))
        do_var = ((not frozen) and abs(c - next_pt) < 0.5) or t <= scaler
        mus, nus = self._moments(leaf, grads, states, group, t, do_var, frozen)
        self._adam_update(params, mus, nus, group, _bc(group["betas"][0], t), 1.0)


class OneBitLamb(_OneBit):
    """1-bit LAMB (JAX ``onebit_lamb``)."""

    state_names = ("mu", "nu", "error", "scaling")

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, freeze_step=100, min_coeff=0.01, max_coeff=10.0,
                 layout=None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, freeze_step=freeze_step,
                                      min_coeff=min_coeff, max_coeff=max_coeff), layout)

    def new_state(self, name, p):
        if name == "scaling":       # one coefficient per leaf, on each member
            return torch.ones(1, dtype=torch.float32, device=p.device)
        return super().new_state(name, p)

    def update_leaf(self, leaf, params, grads, states, group, t):
        frozen = t > group["freeze_step"]
        mus, nus = self._moments(leaf, grads, states, group, t, not frozen, frozen)
        b1, b2 = group["betas"]
        den = torch._foreach_div(nus, _bc(b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        step_dir = torch._foreach_div(mus, _bc(b1, t))
        torch._foreach_div_(step_dir, den)
        del den
        if group["weight_decay"]:
            torch._foreach_add_(step_dir, params, alpha=group["weight_decay"])
        scaling = states["scaling"]
        if not frozen:
            ratio = trust_ratio(leaf, params, step_dir, group["min_coeff"],
                                group["max_coeff"])
            for s in scaling:
                s.copy_(ratio)
        torch._foreach_mul_(step_dir, scaling[0].squeeze())
        torch._foreach_add_(params, step_dir, alpha=-group["lr"])


def _bc(beta, t):
    return 1 - beta ** t


def build(key, params, model_params, lr, layout=None):
    """The 1-bit optimizer ``key`` names, with JAX ``build_optimizer``'s defaults."""
    betas = tuple(params.get("betas", (0.9, 0.999)))
    common = dict(lr=lr, betas=betas, eps=params.get("eps", 1e-8),
                  weight_decay=params.get("weight_decay", 0.0), layout=layout)
    if key == "onebitadam":
        return OneBitAdam(model_params, freeze_step=params.get("freeze_step", 100), **common)
    if key == "zerooneadam":
        return ZeroOneAdam(model_params, var_freeze_step=params.get("var_freeze_step", 100),
                           var_update_scaler=params.get("var_update_scaler", 16), **common)
    return OneBitLamb(model_params, freeze_step=params.get("freeze_step", 100),
                      min_coeff=params.get("min_coeff", 0.01),
                      max_coeff=params.get("max_coeff", 10.0), **common)

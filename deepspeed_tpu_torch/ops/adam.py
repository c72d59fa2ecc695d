"""Optimizers (port of ``deepspeed_tpu/ops/adam.py``).

``build_optimizer`` maps the DeepSpeed optimizer names onto ``Adam``, a
``torch.optim.Optimizer`` that applies optax's update rule (the JAX package
builds ``optax.adamw`` / ``optax.adam``), so both packages take the same
steps from the same gradients:

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t += 1
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    p -= lr (u + wd p)                     # adamw, and adam with adam_w_mode
    g += wd p before the moments           # adam with adam_w_mode=False (L2)

The update runs over the fp32 master parameters with ``torch._foreach_*``
ops, a handful of kernels per chunk of parameters. The chunks hold at most
as many elements as the largest parameter (``_chunks``), so the update's
two fp32 temporaries (``mu_hat`` and ``denom``) never exceed that
parameter's pair, instead of two copies of the whole model; each element's
arithmetic is unchanged. Other optimizer names raise
``NotImplementedError``.
"""

import torch

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"


def _common(params):
    lr = params.get("lr", 1e-3)
    betas = params.get("betas", (0.9, 0.999))
    eps = params.get("eps", 1e-8)
    wd = params.get("weight_decay", 0.0)
    return lr, tuple(betas), eps, wd


class Adam(torch.optim.Optimizer):
    """Adam / AdamW with optax's arithmetic. ``decoupled`` adds ``wd * p`` to
    the update (AdamW); otherwise ``wd * p`` is added to the gradient (L2)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, decoupled=True):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      decoupled=decoupled))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
            t = self.state[params[0]]["step"] + 1
            for p in params:
                self.state[p]["step"] = t
            for lo, hi in _chunks(params):
                self._update(params[lo:hi], grads[lo:hi], group, t)
        return loss

    def _update(self, params, grads, group, t):
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        if wd and not group["decoupled"]:
            grads = torch._foreach_add(grads, params, alpha=wd)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(mus, 1 - b1 ** t)
        denom = torch._foreach_div(nus, 1 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(mu_hat, denom)
        if wd and group["decoupled"]:
            torch._foreach_add_(mu_hat, params, alpha=wd)
        torch._foreach_add_(params, mu_hat, alpha=-lr)


def _chunks(params):
    """``(lo, hi)`` index ranges over ``params``, in order, each holding at
    most as many elements as the largest parameter (a larger one alone)."""
    budget = max(p.numel() for p in params)
    lo, size = 0, 0
    for i, p in enumerate(params):
        if size and size + p.numel() > budget:
            yield lo, i
            lo, size = i, 0
        size += p.numel()
    yield lo, len(params)


def build_optimizer(name, params=None, model_params=()):
    """``(optimizer, base_lr)`` for a DeepSpeed optimizer config section over
    ``model_params``. "Adam" means decoupled AdamW unless ``adam_w_mode`` is
    False, as in the reference (ADAM_W_MODE_DEFAULT = True)."""
    params = dict(params or {})
    key = (name or "adamw").lower()
    lr, betas, eps, wd = _common(params)
    if key == ADAM_OPTIMIZER:
        decoupled = bool(params.get("adam_w_mode", True))
    elif key == ADAMW_OPTIMIZER:
        decoupled = True
    else:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to deepspeed_tpu_torch yet "
            f"(supported: adam, adamw): ROADMAP A1")
    return Adam(model_params, lr=lr, betas=betas, eps=eps, weight_decay=wd,
                decoupled=decoupled), lr


def set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)

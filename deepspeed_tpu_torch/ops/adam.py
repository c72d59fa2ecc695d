"""Optimizers (port of ``deepspeed_tpu/ops/adam.py``).

``build_optimizer`` maps every DeepSpeed optimizer name the JAX package's
``build_optimizer`` takes onto a ``torch.optim.Optimizer`` that applies the
optax law the JAX package builds, so both packages take the same steps
from the same gradients:

- ``adam`` / ``adamw``: optax ``adamw`` (``adam`` with ``adam_w_mode=False``
  adds ``wd * p`` to the gradient first, optax ``add_decayed_weights``)::

      mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t += 1
      u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps);  p -= lr (u + wd p)

- ``lamb``: optax ``lamb`` with eps 1e-8 (JAX ``build_optimizer``'s ``_common``, not
  optax's 1e-6): Adam's ``u`` plus ``wd p``, scaled by the trust ratio
  ``|p| / |u|`` of the whole JAX leaf (1 where either norm is 0);
- ``lion``: optax ``lion`` with betas (0.9, 0.99) and weight decay 0 by
  default: ``p -= lr (sign((1 - b1) g + b1 m) + wd p)``, then
  ``m = (1 - b2) g + b2 m``;
- ``sgd``: ``add_decayed_weights`` then optax ``sgd`` (momentum 0.0 still
  keeps optax's trace): ``g += wd p; m = g + mom m; p -= lr (nesterov ? g +
  mom m : m)``;
- ``adagrad``: ``add_decayed_weights`` then optax ``adagrad`` (accumulator
  from 0.1, eps 1e-10): ``s += g^2; p -= lr g rsqrt(s + eps)`` (0 where
  ``s`` is 0);
- ``muon``: optax ``contrib.muon``: on each 2-D JAX leaf Nesterov momentum
  (beta 0.95) orthogonalised by 5 quintic Newton-Schulz steps and scaled by
  ``sqrt(max(1, fan_out / fan_in))``; every other leaf takes Nesterov AdamW
  (optax's ``adamw(nesterov=True)``, weight decay 0);
- ``onebitadam``, ``zerooneadam``, ``onebitlamb``: ``ops/onebit.py``.

Unknown names raise ``ValueError``, as in the JAX package.

**Leaf-wide arithmetic.** LAMB's trust ratio, the 1-bit family's sign
compression scale and Muon's "2-D or not" rule and its orthogonalisation
read a whole JAX leaf. The engine's masters are one tensor per parameter
and layer, each maybe a ZeRO shard, while the JAX twin stacks a scanned
model's layers into one ``[layers, ...]`` leaf and GSPMD hands its
optimizer whole leaves. An optimizer here therefore runs over
``JaxLeaf``s: the masters that make one JAX leaf, with the means to sum
their squares over the ranks that hold pieces of it, and to gather and cut
the whole leaf in the JAX orientation (a Flax Dense kernel is ``[in, out]``,
an ``nn.Linear`` weight ``[out, in]``). Without a layout (``layout=None``)
each parameter is its own whole leaf. Elementwise laws run with
``torch._foreach_*`` ops over a leaf's members.
"""

import math

import torch

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
LION_OPTIMIZER = "lion"
MUON_OPTIMIZER = "muon"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"

# state names of each optimizer's per-parameter tensors (``tensor_fragment``
# and the engine's checkpoints read them); "exp_avg" / "exp_avg_sq" are
# ``mu`` / ``nu``
STATE_ALIASES = {"exp_avg": "mu", "exp_avg_sq": "nu"}


def _common(params):
    lr = params.get("lr", 1e-3)
    betas = params.get("betas", (0.9, 0.999))
    eps = params.get("eps", 1e-8)
    wd = params.get("weight_decay", 0.0)
    return lr, tuple(betas), eps, wd


class JaxLeaf:
    """One leaf of the JAX twin's parameter tree as the port holds it:
    ``params``, the masters it is made of (one per stacked layer, in layer
    order; a single one otherwise). The default is a whole tensor that is
    its own leaf; the engine's subclass (``runtime/engine.py``
    ``_ShardedLeaf``) knows the shards and the stacking.

    - ``sumsq(tensors)``: the fp32 0-d sum of squares of the JAX leaf whose
      pieces ``tensors`` (one per member, in this rank's layout) are;
    - ``numel``: the JAX leaf's element count;
    - ``jax_shape``: its shape in the JAX tree;
    - ``gather(tensors)`` / ``cut(full)``: the whole leaf in the JAX layout,
      and back to this rank's pieces."""

    def __init__(self, param):
        self.params = [param]
        self.jax_shape = tuple(param.shape)
        self.numel = param.numel()

    def sumsq(self, tensors):
        return torch.stack([t.float().pow(2).sum() for t in tensors]).sum()

    def norm(self, tensors):
        return torch.sqrt(self.sumsq(tensors))

    def gather(self, tensors):
        return tensors[0]

    def cut(self, full):
        return [full]


class LeafOptimizer(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` stepping whole JAX leaves (module
    docstring). Subclasses give ``state_names`` (the per-parameter tensor
    state, zeros at first unless ``new_state`` makes it otherwise) and
    ``update_leaf(leaf, params, grads, states, group, t)``, where
    ``states[name]`` lists the members' tensors. ``t`` is the step count
    after this step."""

    state_names = ()

    def __init__(self, params, defaults, layout=None):
        super().__init__(params, defaults)
        self.set_layout(layout)

    def set_layout(self, layout):
        """``layout``: the ``JaxLeaf``s the parameters form (None: each its
        own whole leaf)."""
        self._leaf_of = {}
        for leaf in layout or ():
            for p in leaf.params:
                self._leaf_of[id(p)] = leaf

    def init_state(self, p):
        """Make ``p``'s state (step 0) if it has none; returns it."""
        st = self.state[p]
        if not st:
            st["step"] = 0
            for name in self.state_names:
                st[name] = self.new_state(name, p)
        return st

    def new_state(self, name, p):
        """State ``name`` of ``p`` at step 0."""
        return torch.zeros_like(p, memory_format=torch.preserve_format)

    def _leaves(self, params):
        """The leaves of ``params`` in order of first appearance, each with
        the members among ``params``."""
        order, members = [], {}
        for p in params:
            leaf = self._leaf_of.get(id(p))
            if leaf is None:
                leaf = self._leaf_of[id(p)] = JaxLeaf(p)
            if id(leaf) not in members:
                order.append(leaf)
                members[id(leaf)] = []
            members[id(leaf)].append(p)
        return [(leaf, members[id(leaf)]) for leaf in order]

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            t = self.init_state(params[0])["step"] + 1
            for p in params:
                self.init_state(p)["step"] = t
            for leaf, members in self._leaves(params):
                grads = [p.grad if p.grad.dtype == torch.float32 else p.grad.float()
                         for p in members]
                states = {n: [self.state[p][n] for p in members] for n in self.state_names}
                self.update_leaf(leaf, members, grads, states, group, t)
        return loss

    def update_leaf(self, leaf, params, grads, states, group, t):
        raise NotImplementedError


def _adam_direction(grads, mus, nus, b1, b2, eps, t, nesterov=False):
    """Update the moments in place and return the Adam direction (new
    tensors): ``mu_hat / (sqrt(nu_hat) + eps)``, Nesterov's ``mu_hat`` with
    ``nesterov`` (optax ``scale_by_adam``)."""
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, grads, alpha=1 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
    if nesterov:
        mu_hat = torch._foreach_div(mus, (1 - b1 ** (t + 1)) / b1)
        torch._foreach_add_(mu_hat, torch._foreach_div(grads, 1 - b1 ** t), alpha=1 - b1)
    else:
        mu_hat = torch._foreach_div(mus, 1 - b1 ** t)
    denom = torch._foreach_div(nus, 1 - b2 ** t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(mu_hat, denom)
    return mu_hat


class Adam(LeafOptimizer):
    """Adam / AdamW with optax's arithmetic. ``decoupled`` adds ``wd * p`` to
    the update (AdamW); otherwise ``wd * p`` is added to the gradient (L2).
    The update runs over chunks of at most the largest leaf's elements
    (``_chunks``), so its two fp32 temporaries never exceed that leaf's
    pair."""

    state_names = ("mu", "nu")

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, decoupled=True, layout=None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, decoupled=decoupled),
                         layout)

    @torch.no_grad()
    def step(self, closure=None):
        # Adam's law is elementwise: every parameter in chunks, leaves aside
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            t = self.init_state(params[0])["step"] + 1
            for p in params:
                self.init_state(p)["step"] = t
            for lo, hi in _chunks(params):
                ps = params[lo:hi]
                self._update(ps, [p.grad for p in ps], group, t)
        return loss

    def _update(self, params, grads, group, t):
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        if wd and not group["decoupled"]:
            grads = torch._foreach_add(grads, params, alpha=wd)
        u = _adam_direction(grads, mus, nus, b1, b2, eps, t)
        if wd and group["decoupled"]:
            torch._foreach_add_(u, params, alpha=wd)
        torch._foreach_add_(params, u, alpha=-lr)


class Lamb(LeafOptimizer):
    """optax ``lamb``: Adam's direction plus ``wd p``, times the JAX leaf's
    trust ratio ``|p| / |u|``."""

    state_names = ("mu", "nu")

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, layout=None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay), layout)

    def update_leaf(self, leaf, params, grads, states, group, t):
        b1, b2 = group["betas"]
        u = _adam_direction(grads, states["mu"], states["nu"], b1, b2, group["eps"], t)
        if group["weight_decay"]:
            torch._foreach_add_(u, params, alpha=group["weight_decay"])
        ratio = trust_ratio(leaf, params, u)
        torch._foreach_mul_(u, ratio)
        torch._foreach_add_(params, u, alpha=-group["lr"])


def trust_ratio(leaf, params, updates, lo=None, hi=None):
    """``|p| / |u|`` over the JAX leaf (a 0-d tensor), 1 where either norm
    is 0 (optax ``scale_by_trust_ratio``); clipped to ``[lo, hi]`` when
    given (1-bit LAMB)."""
    pn, un = leaf.norm(params), leaf.norm(updates)
    ratio = pn / un
    if lo is not None:
        ratio = torch.clamp(ratio, lo, hi)
    return torch.where((pn > 0) & (un > 0), ratio, torch.ones_like(ratio))


class Lion(LeafOptimizer):
    """optax ``lion``."""

    state_names = ("mu",)

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.99), weight_decay=0.0, layout=None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      weight_decay=weight_decay), layout)

    def update_leaf(self, leaf, params, grads, states, group, t):
        b1, b2 = group["betas"]
        mus = states["mu"]
        c = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(c, mus, alpha=b1)
        torch._foreach_sign_(c)
        if group["weight_decay"]:
            torch._foreach_add_(c, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, c, alpha=-group["lr"])
        torch._foreach_mul_(mus, b2)
        torch._foreach_add_(mus, grads, alpha=1 - b2)


class SGD(LeafOptimizer):
    """``add_decayed_weights`` then optax ``sgd`` (its trace, kept at
    momentum 0.0 as JAX's ``build_optimizer`` passes it)."""

    state_names = ("trace",)

    def __init__(self, params, lr=1e-3, momentum=0.0, nesterov=False,
                 weight_decay=0.0, layout=None):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov,
                                      weight_decay=weight_decay), layout)

    def update_leaf(self, leaf, params, grads, states, group, t):
        mom = group["momentum"]
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
        traces = states["trace"]
        torch._foreach_mul_(traces, mom)
        torch._foreach_add_(traces, grads)
        u = traces
        if group["nesterov"]:
            u = torch._foreach_add(grads, traces, alpha=mom)
        torch._foreach_add_(params, u, alpha=-group["lr"])


class Adagrad(LeafOptimizer):
    """``add_decayed_weights`` then optax ``adagrad`` (``scale_by_rss``)."""

    state_names = ("sum_of_squares",)

    def __init__(self, params, lr=1e-3, eps=1e-10, weight_decay=0.0,
                 initial_accumulator_value=0.1, layout=None):
        super().__init__(params, dict(lr=lr, eps=eps, weight_decay=weight_decay,
                                      initial_accumulator_value=initial_accumulator_value),
                         layout)

    def new_state(self, name, p):
        value = self.param_groups[0]["initial_accumulator_value"]
        return torch.full_like(p, value, memory_format=torch.preserve_format)

    def update_leaf(self, leaf, params, grads, states, group, t):
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
        sums = states["sum_of_squares"]
        torch._foreach_addcmul_(sums, grads, grads)
        for p, g, s in zip(params, grads, sums):
            inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
            p.add_(inv * g, alpha=-group["lr"])


NS_COEFFS = (3.4445, -4.7750, 2.0315)


def orthogonalize(x, steps=5, eps=1e-8, coeffs=NS_COEFFS):
    """optax ``orthogonalize_via_newton_schulz`` of a matrix ``x``: the
    wide orientation, ``x / (|x|_F + eps)``, then ``steps`` quintic
    iterations ``a = x x^T; x = c0 x + (c1 a + c2 a a) x``."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.norm(x) + eps)
    c0, c1, c2 = coeffs
    for _ in range(steps):
        a = x @ x.T
        b = c1 * a + c2 * (a @ a)
        x = c0 * x + b @ x
    return x.T if transposed else x


class Muon(LeafOptimizer):
    """optax ``contrib.muon`` with its defaults (module docstring). A leaf
    whose JAX shape is 2-D is orthogonalised whole (gathered over the ZeRO
    group, stacked layers stacked, in the Flax ``[in, out]`` orientation),
    every other leaf takes Nesterov AdamW."""

    state_names = ("mu", "nu")

    def __init__(self, params, lr=1e-3, beta=0.95, ns_steps=5, eps=1e-8,
                 adam_betas=(0.9, 0.999), layout=None):
        super().__init__(params, dict(lr=lr, beta=beta, ns_steps=ns_steps, eps=eps,
                                      adam_betas=tuple(adam_betas)), layout)

    def update_leaf(self, leaf, params, grads, states, group, t):
        lr, eps = group["lr"], group["eps"]
        if len(leaf.jax_shape) != 2:
            b1, b2 = group["adam_betas"]
            u = _adam_direction(grads, states["mu"], states["nu"], b1, b2, eps, t,
                                nesterov=True)
            torch._foreach_add_(params, u, alpha=-lr)
            return
        beta = group["beta"]
        mus = states["mu"]
        torch._foreach_mul_(mus, beta)
        torch._foreach_add_(mus, grads, alpha=1 - beta)
        mu_hat = torch._foreach_div(mus, (1 - beta ** (t + 1)) / beta)
        torch._foreach_add_(mu_hat, torch._foreach_div(grads, 1 - beta ** t), alpha=1 - beta)
        fan_in, fan_out = leaf.jax_shape
        full = orthogonalize(leaf.gather(mu_hat), group["ns_steps"], eps)
        full = full * math.sqrt(max(1.0, fan_out / fan_in))
        torch._foreach_add_(params, leaf.cut(full), alpha=-lr)


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


def build_optimizer(name, params=None, model_params=(), layout=None):
    """``(optimizer, base_lr)`` for a DeepSpeed optimizer config section over
    ``model_params`` (``layout``: their ``JaxLeaf``s). "Adam" means
    decoupled AdamW unless ``adam_w_mode`` is False, as in the reference
    (ADAM_W_MODE_DEFAULT = True)."""
    params = dict(params or {})
    key = (name or "adamw").lower()
    lr, betas, eps, wd = _common(params)
    kw = dict(lr=lr, layout=layout)
    if key in (ONEBIT_ADAM_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER):
        from deepspeed_tpu_torch.ops import onebit
        return onebit.build(key, params, model_params, **kw), lr
    if key == ADAM_OPTIMIZER:
        opt = Adam(model_params, betas=betas, eps=eps, weight_decay=wd,
                   decoupled=bool(params.get("adam_w_mode", True)), **kw)
    elif key == ADAMW_OPTIMIZER:
        opt = Adam(model_params, betas=betas, eps=eps, weight_decay=wd, **kw)
    elif key == LAMB_OPTIMIZER:
        opt = Lamb(model_params, betas=betas, eps=eps, weight_decay=wd, **kw)
    elif key == LION_OPTIMIZER:
        opt = Lion(model_params, betas=tuple(params.get("betas", (0.9, 0.99))),
                   weight_decay=wd, **kw)
    elif key == SGD_OPTIMIZER:
        opt = SGD(model_params, momentum=params.get("momentum", 0.0),
                  nesterov=params.get("nesterov", False), weight_decay=wd, **kw)
    elif key == ADAGRAD_OPTIMIZER:
        opt = Adagrad(model_params, eps=params.get("eps", 1e-10), weight_decay=wd, **kw)
    elif key == MUON_OPTIMIZER:
        opt = Muon(model_params, **kw)
    else:
        raise ValueError(f"Unknown optimizer type {name!r}")
    return opt, lr


def set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)

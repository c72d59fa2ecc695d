"""MoE parameter-group utilities (port of ``deepspeed_tpu/moe/utils.py``).

The JAX package works on flax key paths; here the same rules apply to
``named_parameters`` names: for the optimizer's parameter groups a
parameter is an expert (MoE) parameter when its name holds ``experts`` or
``deepspeed_moe``. Each of those functions takes an ``nn.Module`` or
``(name, tensor)`` pairs (a dict of them, or ``named_parameters()``).
``moe_param_specs`` is the expert-parallel layout, and the one place that
decides which leaves are expert slices: the stacked experts of every
``MOELayer``, cut along dim 0 over ``ep`` (expert ``e`` on ep rank
``e // (E / ep)``); ``expert_slice`` takes a rank's slice of a whole stack.
"""

from torch import nn

from deepspeed_tpu_torch.moe.sharded_moe import MOELayer


def _named(params):
    if isinstance(params, nn.Module):
        params = params.named_parameters()
    return list(dict(params).items())


def is_moe_param(name):
    """Whether the parameter called ``name`` belongs to the experts."""
    return "deepspeed_moe" in name or "experts" in name


def moe_param_specs(module, ep_size=None):
    """``{name: ("ep",) or None}`` for every parameter of ``module``: the
    JAX spec tree of ``moe_param_specs`` (``moe/utils.py:24``). ``("ep",)``
    marks the parameters of each ``MOELayer``'s ``experts`` (the stacked
    expert kernels), whose dim 0 (the expert axis) is cut over ``ep``; the
    engine's ZeRO then cuts another dimension over the data axes less
    ``ep``. With ``ep_size`` (the topology's ``ep`` axis), every
    ``MOELayer`` must have been built with it."""
    experts = set()
    for m in module.modules():
        if isinstance(m, MOELayer):
            if ep_size is not None and m.ep_size != ep_size:
                raise ValueError(f"MOELayer(ep_size={m.ep_size}) does not match the "
                                 f"topology's ep axis ({ep_size}): set "
                                 f"expert_parallel_size to the layers' ep_size")
            experts.update(id(p) for p in m.experts.parameters())
    return {name: ("ep",) if id(p) in experts else None
            for name, p in module.named_parameters()}


def expert_slice(full, ep_size, ep_rank):
    """Rank ``ep_rank``'s contiguous slice ``[E / ep_size, ...]`` of a whole
    expert stack ``full`` [E, ...]."""
    n = full.shape[0] // ep_size
    return full[ep_rank * n:(ep_rank + 1) * n]


def split_params_into_different_moe_groups_for_optimizer(params):
    """(expert names, dense names), in parameter order."""
    moe, dense = [], []
    for name, _ in _named(params):
        (moe if is_moe_param(name) else dense).append(name)
    return moe, dense


def has_moe_layers(params):
    """(whether any expert parameter exists, how many there are)."""
    n = sum(1 for name, _ in _named(params) if is_moe_param(name))
    return n > 0, n


def split_params_into_shared_and_expert_params(params):
    """Two ``{name: tensor}`` dicts: (shared, expert)."""
    shared, expert = {}, {}
    for name, p in _named(params):
        (expert if is_moe_param(name) else shared)[name] = p
    return shared, expert


def is_moe_param_group(param_group):
    """Whether an optimizer group dict is tagged ``{'moe': True}``."""
    return bool(param_group.get("moe", False))


def configure_moe_param_groups(params):
    """Optimizer groups with the experts split out, by sorted name:
    ``[{'params': [...], 'moe': False}, {'params': [...], 'moe': True,
    'name': 'ep_group'}]`` (the second only when experts exist)."""
    shared, expert = split_params_into_shared_and_expert_params(params)
    groups = [{"params": sorted(shared), "moe": False}]
    if expert:
        groups.append({"params": sorted(expert), "moe": True, "name": "ep_group"})
    return groups

"""MoE parameter-group utilities (port of ``deepspeed_tpu/moe/utils.py``).

The JAX package works on flax key paths; here the same rules apply to
``named_parameters`` names: a parameter is an expert (MoE) parameter when
its name holds ``experts`` or ``deepspeed_moe``. Each function takes an
``nn.Module`` or ``(name, tensor)`` pairs (a dict of them, or
``named_parameters()``). ``moe_param_specs`` (the expert-parallel sharding) waits for expert
parallelism (ROADMAP A9).
"""

from torch import nn


def _named(params):
    if isinstance(params, nn.Module):
        params = params.named_parameters()
    return list(dict(params).items())


def is_moe_param(name):
    """Whether the parameter called ``name`` belongs to the experts."""
    return "deepspeed_moe" in name or "experts" in name


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

"""Tensor fragment API (port of ``deepspeed_tpu/utils/tensor_fragment.py``;
the reference's ``utils/tensor_fragment.py:123``).

Under ZeRO a parameter's fp32 master, its optimizer state and its gradient
accumulator are cut over the ranks of its placement group (the ZeRO
group, the expert-data group of an expert slice; an expert slice is also
one ``ep`` rank's part of its stack). The ``safe_get_full_*`` accessors
gather the whole value over those groups (every rank of the group calls
them) and return an fp32 tensor on the CPU; the ``safe_set_full_*``
accessors take a whole value and write only this rank's piece; the
``safe_get_local_*`` accessors return this rank's piece as stored (a flat
chunk, or the whole tensor where it is not cut). Parameters are addressed
by name (``engine.module.named_parameters()``).

Optimizer state names: ``exp_avg`` / ``exp_avg_sq`` (Adam's, Lamb's,
Muon's and the 1-bit family's ``mu`` / ``nu``) and each optimizer's own
(``trace``, ``sum_of_squares``, ``error``, ``scaling``, ``mu``, ``nu``);
an absent one reads None and sets False, as in the JAX package. The full
gradient is the accumulated gradient of the global batch (the JAX engine's
``grad_acc``): the accumulators reduced over the data-parallel world and
divided by it, between backward and the boundary step.
"""

import torch

from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.moe.utils import expert_slice
from deepspeed_tpu_torch.ops.adam import STATE_ALIASES
from deepspeed_tpu_torch.runtime.zero.partition import gather_full, shard_of


def _leaf(engine, key):
    for leaf in engine._leaves:
        if leaf.name == key:
            return leaf
    return None


def param_names(engine):
    """Every addressable parameter name."""
    return [leaf.name for leaf in engine._leaves]


def _ep(engine):
    topo = engine.topology
    return topo.get_group("ep"), topo.ep_size, \
        topo.get_axis_rank("ep") if topo.ep_size > 1 else 0


def _full(engine, leaf, piece, dim):
    """The whole value of ``leaf`` whose piece along ``dim`` this is."""
    t = piece.detach().float()
    if dim is not None:
        t = gather_full(t, dim, leaf.shape, leaf.place.group)
    t = t.reshape(leaf.shape)
    if leaf.place.expert:
        group, _, _ = _ep(engine)
        t = dist.all_gather(t.contiguous(), group=group)
    return t.cpu().clone()


def _piece(engine, leaf, value, dim):
    """This rank's piece of the whole ``value`` of ``leaf``."""
    t = torch.as_tensor(value, dtype=torch.float32).to(leaf.master.device)
    if leaf.place.expert:
        _, size, rank = _ep(engine)
        t = expert_slice(t, size, rank)
    t = t.reshape(leaf.shape)
    return t if dim is None else shard_of(t, dim, leaf.place.world, leaf.place.index)


def _state(engine, leaf, state_name):
    st = engine.optimizer.state.get(leaf.master, {})
    t = st.get(STATE_ALIASES.get(state_name, state_name))
    return t if isinstance(t, torch.Tensor) else None


def safe_get_full_fp32_param(engine, key):
    """The gathered fp32 master of parameter ``key`` (None if unknown)."""
    leaf = _leaf(engine, key)
    return None if leaf is None else _full(engine, leaf, leaf.master, leaf.master_dim)


def safe_set_full_fp32_param(engine, key, value):
    """Write this rank's piece of the whole fp32 ``value`` into the master;
    the working copy follows at the next optimizer step, as in the
    reference's master / working split."""
    leaf = _leaf(engine, key)
    if leaf is None:
        return False
    with torch.no_grad():
        leaf.master.copy_(_piece(engine, leaf, value, leaf.master_dim)
                          .reshape(leaf.master.shape))
    return True


def safe_get_full_optimizer_state(engine, key, state_name):
    """The gathered optimizer state ``state_name`` of parameter ``key``
    (None where the optimizer keeps none by that name)."""
    leaf = _leaf(engine, key)
    t = None if leaf is None else _state(engine, leaf, state_name)
    if t is None:
        return None
    if t.numel() != leaf.master.numel():     # a per-leaf scalar (1-bit LAMB's scaling)
        return t.detach().float().cpu().clone()
    return _full(engine, leaf, t, leaf.master_dim)


def safe_set_full_optimizer_state(engine, key, value, state_name):
    """Write this rank's piece of the whole ``value`` into the optimizer
    state ``state_name``; False where there is none by that name."""
    leaf = _leaf(engine, key)
    t = None if leaf is None else _state(engine, leaf, state_name)
    if t is None:
        return False
    with torch.no_grad():
        if t.numel() != leaf.master.numel():
            t.copy_(torch.as_tensor(value, dtype=t.dtype).reshape(t.shape))
        else:
            t.copy_(_piece(engine, leaf, value, leaf.master_dim).reshape(t.shape))
    return True


def safe_get_full_grad(engine, key):
    """The accumulated gradient of the global batch for parameter ``key``
    (module docstring); every rank of the data-parallel world calls it."""
    leaf = _leaf(engine, key)
    if leaf is None:
        return None
    acc = leaf.acc.detach().float()
    if leaf.acc.shape == torch.Size(leaf.shape):     # local and unreduced
        acc = acc.clone()
        if leaf.place.world > 1:
            dist.all_reduce(acc, group=leaf.place.group)
        if leaf.place.replica_world > 1:
            dist.all_reduce(acc, group=leaf.place.replica_group)
        full = _full(engine, leaf, acc, None)
    else:                                            # reduce-scattered chunk
        full = _full(engine, leaf, acc, leaf.grad_dim)
    return full / engine.dp_world


def safe_get_local_fp32_param(engine, key):
    """This rank's piece of the fp32 master."""
    leaf = _leaf(engine, key)
    return None if leaf is None else leaf.master.detach().float().cpu().clone()


def safe_get_local_grad(engine, key):
    """This rank's gradient accumulator, as stored."""
    leaf = _leaf(engine, key)
    return None if leaf is None else leaf.acc.detach().float().cpu().clone()


def safe_get_local_optimizer_state(engine, key, state_name):
    """This rank's piece of the optimizer state ``state_name``."""
    leaf = _leaf(engine, key)
    t = None if leaf is None else _state(engine, leaf, state_name)
    return None if t is None else t.detach().float().cpu().clone()

"""The JAX twin's leaves over the engine's masters, for the optimizers'
leaf-wide arithmetic (``ops/adam.py``: LAMB's and 1-bit LAMB's trust
ratios, the 1-bit family's compression scale, Muon's "2-D or not" rule and
its orthogonalisation).

The JAX engine's optimizer sees whole leaves: GSPMD sums a norm over the
shards and gathers a matrix for a product. The port's masters are one
tensor per parameter, each this rank's ZeRO chunk (flat, in the
partitioner's layout) or whole, and the JAX twin of a model with
``jax_stacked_layers()`` stacks its layers into one ``[layers, ...]``
leaf. ``build_layout`` groups the engine's leaves as
``runtime/zero/qwz.jax_leaves`` names them (the stacked layers of one
parameter together, in layer order) into ``ShardedLeaf``s, which sum
squares over the ranks holding pieces of the leaf (the ZeRO group of a
sharded master, and ``ep`` for an expert slice; a whole master, held by
every rank, counts once) and gather / cut the whole leaf in the JAX
orientation (an ``nn.Linear`` weight ``[out, in]`` is a Flax kernel
``[in, out]`` transposed).
"""

import math

import torch

from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.moe.utils import expert_slice
from deepspeed_tpu_torch.ops.adam import JaxLeaf
from deepspeed_tpu_torch.runtime.zero import qwz
from deepspeed_tpu_torch.runtime.zero.partition import gather_full, shard_of


class ShardedLeaf(JaxLeaf):
    """One JAX leaf made of the engine leaves ``members`` (``_Leaf``s with
    the same shape and placement)."""

    def __init__(self, members, jax_shape, transposed, stacked, ep_group, ep_size,
                 ep_rank):
        m0 = members[0]
        self.members = members
        self.params = [m.master for m in members]
        self.jax_shape = tuple(jax_shape)
        self.numel = math.prod(self.jax_shape)
        self.transposed, self.stacked = transposed, stacked
        self.shape, self.dim, self.place = m0.shape, m0.master_dim, m0.place
        self.ep = (ep_group, ep_size, ep_rank) if m0.place.expert else None

    def sumsq(self, tensors):
        s = torch.stack([t.float().pow(2).sum() for t in tensors]).sum()
        if self.dim is not None:
            dist.all_reduce(s, group=self.place.group)
        if self.ep is not None:
            dist.all_reduce(s, group=self.ep[0])
        return s

    def _whole(self, t):
        if self.dim is not None:
            t = gather_full(t, self.dim, self.shape, self.place.group)
        else:
            t = t.reshape(self.shape)
        if self.ep is not None:
            t = dist.all_gather(t.contiguous(), group=self.ep[0])
        return t

    def gather(self, tensors):
        parts = [self._whole(t) for t in tensors]
        full = torch.stack(parts) if self.stacked else parts[0]
        return full.transpose(-1, -2) if self.transposed else full

    def cut(self, full):
        if self.transposed:
            full = full.transpose(-1, -2)
        parts = list(full.unbind(0)) if self.stacked else [full]
        out = []
        for t, master in zip(parts, self.params):
            if self.ep is not None:
                t = expert_slice(t, self.ep[1], self.ep[2])
            if self.dim is not None:
                t = shard_of(t.contiguous(), self.dim, self.place.world, self.place.index)
            out.append(t.reshape(master.shape))
        return out


def build_layout(leaves, module, topology):
    """The ``ShardedLeaf``s the engine's ``leaves`` form for ``module``."""
    twins = qwz.jax_leaves(module)
    prefix, _ = getattr(module, "jax_stacked_layers", lambda: (None, 1))()
    ep = topology.ep_size
    ep_group = topology.get_group("ep") if ep > 1 else None
    ep_rank = topology.get_axis_rank("ep") if ep > 1 else 0
    groups = {}
    for leaf in leaves:
        key = leaf.name
        if prefix is not None and key.startswith(prefix):
            key = (prefix, key[len(prefix):].partition(".")[2])
        groups.setdefault(key, []).append(leaf)
    out = []
    for key, members in groups.items():
        axis, jshape = twins[members[0].name]
        transposed = len(members[0].shape) == 2 and axis == 0
        out.append(ShardedLeaf(members, jshape, transposed, isinstance(key, tuple),
                               ep_group, ep, ep_rank))
    return out

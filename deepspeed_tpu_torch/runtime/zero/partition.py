"""ZeRO partitioning over ranks (port of ``deepspeed_tpu/runtime/zero/partition.py``).

The JAX package states ZeRO as a sharding rule per parameter leaf and lets
GSPMD emit the collectives; the port keeps the rule and does the
collectives itself. The rule is ``_leaf_spec_with_zero``'s
(``partition.py:36-70``): a leaf is cut along its largest dimension that the
ZeRO world divides (the first of equal ones), and rank ``i`` of the world
holds chunk ``i``; a scalar, a leaf with no such dimension, or one smaller
than the threshold stays whole on every rank.

Stage semantics (``partition.py:9-15``):
  0: master/opt whole, grads whole           (plain data parallelism)
  1: master/opt sharded                      (optimizer-state partitioning)
  2: + gradient accumulator sharded          (gradient partitioning)
  3: + working (bf16) parameters sharded     (parameter partitioning)

``stage3_param_persistence_threshold`` applies to the working parameters
only: smaller leaves stay whole ("persisted"); the optimizer state of every
leaf is sharded. Under hpZ (``zero_hpz_partition_size``) the working
shards span the inner ``dp`` group only. Under MiCS (``mics_shard_size``)
every shard spans ``dp`` and is replicated across ``dpr``: a placement then
names the ``dpr`` group as ``replica_group``, across which the gradients
(reduce-scattered or summed inside ``dp``) are all-reduced, so they still
sum over the whole data-parallel world (JAX ``mics.py:11-14``).

Under expert parallelism (an ``ep`` axis > 1) an expert leaf on a rank is
its slice of the expert stack, already cut on dim 0 over ``ep``
(``moe/utils.moe_param_specs``): as in ``_leaf_spec_with_zero``, whose
axes exclude those the leaf's spec uses, its state is cut over the ZeRO
axes less ``ep`` (the expert-data-parallel group) along its largest other
dimension.

A shard is stored flat, in the element order of ``full.movedim(dim, 0)``:
for dim 0 (most Llama leaves) it is a contiguous view of the full tensor's
rows, and gathering the shards of a group with one all-gather lays out
the moved full tensor, which ``movedim(0, dim)`` puts back.
"""

from typing import Any, NamedTuple

import numpy as np

from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.utils.logging import logger


def zero_shard_dim(shape, world, threshold=0, used=()):
    """The dimension a leaf of ``shape`` is cut along over ``world`` ranks,
    or None when it stays whole. Dimensions in ``used`` are already cut by
    the model's own layout and are not chosen."""
    shape = tuple(int(n) for n in shape)
    if world <= 1 or not shape or int(np.prod(shape)) < max(threshold, 1):
        return None
    best, best_size = None, 0
    for d, n in enumerate(shape):
        if d not in used and n % world == 0 and n > best_size:
            best, best_size = d, n
    return best


def moved_shape(shape, dim):
    shape = tuple(shape)
    return (shape[dim],) + shape[:dim] + shape[dim + 1:]


def shard_of(full, dim, world, index):
    """Rank ``index``'s flat shard of ``full`` cut along ``dim`` into
    ``world`` chunks (a view when ``dim`` is 0 and ``full`` contiguous)."""
    moved = full.movedim(dim, 0)
    c = moved.shape[0] // world
    return moved[index * c:(index + 1) * c].reshape(-1)


def gather_full(shard, dim, shape, group, out=None):
    """All-gather the flat shards of ``group`` into a tensor of ``shape``
    (into ``out`` when given). Every rank of the group calls it."""
    if out is not None and dim == 0 and out.is_contiguous():
        dist.all_gather(shard, group=group, out=out.view(-1))
        return out
    full = dist.all_gather(shard, group=group).view(moved_shape(shape, dim)).movedim(0, dim)
    if out is None:
        return full.contiguous()
    out.copy_(full)
    return out


class Placement(NamedTuple):
    """The groups a leaf's state is cut over: (group, world, this rank's
    index) for the master, moments and gradients, and for the stage-3
    working shards. ``used``: the dimensions the leaf's model-parallel spec
    already cuts over ``ep`` (an expert slice), which ZeRO does not cut."""
    group: Any
    world: int
    index: int
    param_group: Any
    param_world: int
    param_index: int
    used: tuple = ()
    replica_group: Any = None
    replica_world: int = 1

    @property
    def expert(self):
        """Whether the leaf is this rank's slice of an expert stack."""
        return bool(self.used)


class ZeroPartitioner:
    """Which dimension each leaf is cut along, per state component, and the
    groups the cuts span."""

    def __init__(self, topology, zero_config):
        self.topology = topology
        self.stage = zero_config.stage
        self.threshold = zero_config.stage3_param_persistence_threshold
        # master, moments and gradients: the whole ZeRO world; working params: under hpZ
        # the inner group only (reference secondary tensors)
        self.zero_group, self.zero_world, self.zero_index = \
            topology.axes_group(topology.zero_axes)
        self.param_group, self.param_world, self.param_index = \
            topology.axes_group(topology.param_zero_axes)
        mics = topology.zero_hierarchy == "mics"
        replica = (topology.get_group("dpr"), topology.dpr_size) if mics else (None, 1)
        self.dense = Placement(self.zero_group, self.zero_world, self.zero_index,
                               self.param_group, self.param_world, self.param_index,
                               (), *replica)
        if topology.ep_size > 1:
            self._expert = Placement(*topology.axes_group(topology.expert_zero_axes),
                                     *topology.axes_group(topology.expert_param_zero_axes),
                                     (), *replica)

    def placement(self, spec):
        """The placement of a leaf whose model-parallel spec is ``spec``
        (``moe/utils.moe_param_specs``: ``("ep",)`` for an expert leaf, None
        for a dense one). Under an ``ep`` axis > 1 an expert leaf's state
        spans the ZeRO axes less ``ep``, on a dimension its spec leaves
        whole; otherwise every leaf is dense."""
        used = tuple(d for d, axis in enumerate(spec or ()) if axis == "ep")
        if not used or self.topology.ep_size == 1:
            return self.dense
        return self._expert._replace(used=used)

    def master_dim(self, shape, place=None):
        """fp32 master + optimizer moments: sharded from stage 1 up, with no
        threshold."""
        place = place or self.dense
        return zero_shard_dim(shape, place.world, used=place.used) \
            if self.stage >= 1 else None

    def grad_dim(self, shape, place=None):
        """Gradient accumulator: sharded from stage 2 up."""
        place = place or self.dense
        return zero_shard_dim(shape, place.world, used=place.used) \
            if self.stage >= 2 else None

    def param_dim(self, shape, place=None):
        """Working parameters: sharded at stage 3, leaves under the
        persistence threshold whole."""
        place = place or self.dense
        if self.stage < 3:
            return None
        return zero_shard_dim(shape, place.param_world, self.threshold,
                              used=place.used)

    def describe(self, shapes):
        n = sum(self.master_dim(s) is not None for s in shapes)
        logger.info(f"ZeRO stage {self.stage}: sharding {n}/{len(shapes)} leaves over "
                    f"{self.zero_world} ranks")


def free_storage(t):
    """Free ``t``'s storage, keeping its shape (stage 3 at rest)."""
    t.untyped_storage().resize_(0)


def alloc_storage(t):
    """Give a tensor freed by ``free_storage`` its bytes back
    (uninitialised)."""
    t.untyped_storage().resize_(t.numel() * t.element_size())


def is_resident(t):
    return t.untyped_storage().nbytes() > 0


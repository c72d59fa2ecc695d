"""MiCS and hpZ: hierarchical ZeRO partitioning (port of
``deepspeed_tpu/runtime/zero/mics.py``; reference ``runtime/zero/mics.py``
and ``zero_hpz_partition_size``).

The data-parallel world splits into ``dpr`` (replica groups) x ``dp``
(shard groups) in the rank grid (``parallel/topology.py``), and the
partitioner (``zero/partition.py``) picks which state shards over which
factor:

- **MiCS** (``mics_shard_size``): master, optimizer state and gradients
  shard over ``dp`` only and are replicated across ``dpr``. A gradient is
  reduce-scattered inside its shard group and all-reduced across ``dpr``,
  so the sum still spans the whole data-parallel world.
- **hpZ** (``zero_hpz_partition_size``): optimizer state shards over the
  whole world, while the stage-3 working parameters (the reference's
  secondary tensor) shard only over ``dp``, so every per-use all-gather
  stays inside a shard group.

The config keys are the reference's::

    {"zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}}
    {"zero_optimization": {"stage": 3, "mics_shard_size": 2}}

``deepspeed_tpu_torch.initialize`` reads them and builds the grid; the two
constructors below build one directly.
"""

from deepspeed_tpu_torch.parallel.topology import MeshTopology


def mics_topology(shard_size, devices=None, **axes):
    """A MiCS grid: shard groups of ``shard_size`` ranks, replicated across
    the rest of the data-parallel world."""
    return MeshTopology(devices=devices, zero_shard_size=shard_size,
                        zero_hierarchy="mics", **axes)


def hpz_topology(partition_size, devices=None, **axes):
    """A ZeRO++ hpZ grid: secondary parameter partitions of
    ``partition_size`` ranks."""
    return MeshTopology(devices=devices, zero_shard_size=partition_size,
                        zero_hierarchy="hpz", **axes)

"""The rank grid (port of ``deepspeed_tpu/parallel/topology.py``).

The JAX package lays every parallelism form on the named axes of one device
mesh; here the same axes order a grid of ``torch.distributed`` ranks, and
each axis slice (the ranks that differ only in that axis's coordinate) gets
a process group. Canonical axis order, outermost to innermost:

    ("pp", "dpr", "dp", "ep", "sp", "tp")

``dp`` is the ZeRO shard axis. ``dpr`` splits the data-parallel world
hierarchically (``zero_hpz_partition_size`` or ``mics_shard_size``): ``dp``
becomes the inner group of that size and ``dpr`` the groups across it.
Under hpZ the ZeRO world is ``(dpr, dp)`` in that order, so rank
``dpr_idx * dp + dp_idx`` holds chunk ``dpr_idx * dp + dp_idx`` of a leaf:
the "axes-major" order of the JAX package's ``batch_spec`` and qgZ chunks;
the stage-3 working shards span ``dp`` only. Under MiCS every ZeRO shard
spans ``dp`` and is replicated across ``dpr`` (``zero_axes``); gradients
still reduce over the whole data-parallel world (``data_axes``). ``ep`` is the expert-parallel
axis: rank ``ep_idx`` of an ``ep`` group holds experts ``ep_idx * E/ep``
to ``(ep_idx + 1) * E/ep - 1``, and an expert leaf's ZeRO state is cut over
the data axes less ``ep`` (``expert_zero_axes``). ``tp`` is the
tensor-parallel axis of serving: the ranks of a ``tp`` slice hold one
model's weights split in the Megatron pattern (``parallel/
tensor_parallel.py``); training over it raises in the training engine,
naming ROADMAP A12. ``pp`` and ``sp`` raise here, naming theirs.
"""

import numpy as np
import torch.distributed

from deepspeed_tpu_torch.comm import comm as dist

AXIS_ORDER = ("pp", "dpr", "dp", "ep", "sp", "tp")
DATA_AXES = ("dpr", "dp", "ep", "sp")     # the JAX package's batch_spec order
_UNPORTED = {"pp": "A12 (pipeline parallelism)", "sp": "A12 (sequence parallelism)"}


class MeshTopology:

    def __init__(self, pp=1, dp=-1, ep=1, sp=1, tp=1, devices=None,
                 zero_shard_size=None, zero_hierarchy=None):
        """``devices`` is the list of global ranks the grid covers (default
        every rank of the process group, or the one process when there is
        none). ``zero_shard_size`` splits the data-parallel world: ``dp``
        becomes the shard group of that size and ``dpr`` the replica groups
        across it; ``zero_hierarchy`` records why ("mics": all ZeRO state
        confined to the shard group; "hpz": only the stage-3 working
        parameters use the smaller group)."""
        if devices is None:
            devices = list(range(dist.get_world_size()))
        n = len(devices)
        fixed = pp * ep * sp * tp
        if dp == -1:
            assert n % fixed == 0, (
                f"device count {n} not divisible by pp*ep*sp*tp={fixed}")
            dp = n // fixed
        assert pp * dp * ep * sp * tp == n, (
            f"mesh {pp}x{dp}x{ep}x{sp}x{tp} != device count {n}")
        dpr = 1
        if zero_shard_size and zero_shard_size > 0:
            assert zero_shard_size <= dp, (
                f"zero shard size {zero_shard_size} exceeds the data-parallel "
                f"world {dp} (reference mics_shard_size/zero_hpz_partition_size "
                f"must divide the DP world)")
            assert dp % zero_shard_size == 0, (
                f"dp={dp} not divisible by zero shard size {zero_shard_size}")
            assert zero_hierarchy in ("mics", "hpz"), \
                "zero_shard_size requires zero_hierarchy of 'mics' or 'hpz'"
            dpr = dp // zero_shard_size
            dp = zero_shard_size
        self.zero_hierarchy = zero_hierarchy if dpr > 1 else None
        self.pp_size, self.dp_size, self.ep_size, self.sp_size, self.tp_size = pp, dp, ep, sp, tp
        self.dpr_size = dpr
        self._sizes = dict(pp=pp, dpr=dpr, dp=dp, ep=ep, sp=sp, tp=tp)
        for axis, item in _UNPORTED.items():
            if self._sizes[axis] > 1:
                raise NotImplementedError(
                    f"a {axis} axis of size {self._sizes[axis]} is not ported to "
                    f"deepspeed_tpu_torch yet: ROADMAP {item}")
        self.ranks = np.asarray(devices).reshape([self._sizes[a] for a in AXIS_ORDER])
        self.rank = dist.get_rank()
        devices = [int(r) for r in devices]
        if self.rank not in devices:
            raise ValueError(f"rank {self.rank} is not in the grid's ranks {devices}")
        self.grid_rank = devices.index(self.rank)   # this rank's place in the grid
        self._groups = self._build_groups()
        self._axes_groups = {}

    def _slice_group(self, axes):
        """The group of this rank's slice along ``axes`` (live axes, in
        AXIS_ORDER): one ``new_group`` per slice, created in the same order
        on every rank (``new_group`` is collective). A slice spanning the
        whole world is the default group (None). Members are listed
        axes-major, which is also their global-rank order."""
        world = dist.get_world_size()
        dims = [AXIS_ORDER.index(a) for a in axes]
        size = int(np.prod([self._sizes[a] for a in axes]))
        moved = np.moveaxis(self.ranks, dims, list(range(-len(dims), 0)))
        mine = None
        for ranks in moved.reshape(-1, size).tolist():
            group = None if len(ranks) == world else \
                torch.distributed.new_group(ranks=ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def _build_groups(self):
        """One process group per slice of each axis longer than 1."""
        return {axis: self._slice_group((axis,)) for axis in AXIS_ORDER
                if self._sizes[axis] > 1}

    @property
    def axis_names(self):
        return AXIS_ORDER

    def get_dim(self, axis):
        return self._sizes[axis]

    def get_group(self, axis):
        """The process group of this rank's slice along ``axis`` (None: the
        whole world, or an axis of size 1, where collectives are no-ops)."""
        return self._groups.get(axis)

    def get_axis_rank(self, axis):
        return self.get_coord(self.grid_rank)[axis]

    @property
    def data_axes(self):
        """Axes of the data-parallel world: the batch is split over them and
        every gradient is reduced over them."""
        return DATA_AXES

    @property
    def zero_axes(self):
        """Axes over which ZeRO partitions master/optimizer state and
        gradients: the data-parallel world, or under MiCS the shard group
        only (replicated across ``dpr``; the reference ``runtime/zero/
        mics.py``)."""
        if self.zero_hierarchy == "mics":
            return ("dp", "ep", "sp")
        return DATA_AXES

    @property
    def param_zero_axes(self):
        """Axes of the stage-3 working (bf16) parameter shards: under hpZ
        and MiCS only the inner ``dp`` group (the reference's secondary
        partition)."""
        if self.zero_hierarchy in ("hpz", "mics"):
            return ("dp", "ep", "sp")
        return self.zero_axes

    @property
    def expert_zero_axes(self):
        """ZeRO axes of an expert leaf, whose dim 0 is already cut over
        ``ep`` (the JAX partitioner drops the axes a leaf's spec uses):
        the reference's expert-data-parallel group."""
        return tuple(a for a in self.zero_axes if a != "ep")

    @property
    def expert_param_zero_axes(self):
        return tuple(a for a in self.param_zero_axes if a != "ep")

    def axes_group(self, axes):
        """(process group, size, this rank's index) of the ranks that differ
        only along ``axes`` (those of size > 1), indexed axes-major. The
        group of a set of more than one live axis is made on first use, so
        every rank asks for the same sets in the same order."""
        live = tuple(a for a in AXIS_ORDER if a in axes and self._sizes[a] > 1)
        if not live:
            return None, 1, 0
        size = int(np.prod([self._sizes[a] for a in live]))
        coord = self.get_coord(self.grid_rank)
        index = 0
        for a in live:
            index = index * self._sizes[a] + coord[a]
        if len(live) == 1:
            return self.get_group(live[0]), size, index
        if live not in self._axes_groups:
            self._axes_groups[live] = self._slice_group(live)
        return self._axes_groups[live], size, index

    @property
    def data_parallel_size(self):
        return self.dpr_size * self.dp_size * self.ep_size * self.sp_size

    # --- coordinate math, mirroring ProcessTopology (topology.py:12) ---
    def world_size(self):
        return int(np.prod([self._sizes[a] for a in AXIS_ORDER]))

    def get_rank(self, **coords):
        """Flat rank from axis coordinates (reference ``ProcessTopology.get_rank``)."""
        full = [coords.get(a, 0) for a in AXIS_ORDER]
        dims = [self._sizes[a] for a in AXIS_ORDER]
        rank = 0
        for c, d in zip(full, dims):
            rank = rank * d + c
        return rank

    def get_coord(self, rank):
        dims = [self._sizes[a] for a in AXIS_ORDER]
        coords = {}
        for a, d in zip(reversed(AXIS_ORDER), reversed(dims)):
            coords[a] = rank % d
            rank //= d
        return {a: coords[a] for a in AXIS_ORDER}

    def __repr__(self):
        shown = [a for a in AXIS_ORDER if a != "dpr" or self.dpr_size > 1]
        return ("MeshTopology(" +
                ", ".join(f"{a}={self._sizes[a]}" for a in shown) + ")")


def build_topology(config=None, devices=None, ep_size=1):
    """Build a MeshTopology from a DeepSpeedConfig-like object (or
    defaults); ``ep_size`` is the ``ep`` axis where the config names none."""
    pp = sp = tp = 1
    ep = ep_size
    zero_shard_size = zero_hierarchy = None
    if config is not None:
        pp = getattr(config, "pipeline_stages", 1) or 1
        ep = getattr(config, "expert_parallel_size", 1) or 1
        if ep == 1:
            ep = ep_size
        sp = getattr(config, "sequence_parallel_size", 1) or 1
        tp = getattr(config, "tensor_parallel_size", 1) or 1
        zc = getattr(config, "zero_config", None)
        if zc is not None:
            if getattr(zc, "mics_shard_size", -1) and zc.mics_shard_size > 0:
                zero_shard_size, zero_hierarchy = zc.mics_shard_size, "mics"
            elif getattr(zc, "zero_hpz_partition_size", 1) and \
                    zc.zero_hpz_partition_size > 1:
                zero_shard_size, zero_hierarchy = zc.zero_hpz_partition_size, "hpz"
    return MeshTopology(pp=pp, dp=-1, ep=ep, sp=sp, tp=tp, devices=devices,
                        zero_shard_size=zero_shard_size,
                        zero_hierarchy=zero_hierarchy)

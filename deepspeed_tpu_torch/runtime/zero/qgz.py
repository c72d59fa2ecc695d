"""qgZ: ZeRO++ quantized gradient reduction (port of ``deepspeed_tpu/runtime/zero/qgz.py``).

Reference: ``zero_quantized_gradients`` routes the gradient reduction
through a quantized all-to-all (``runtime/zero/stage3.py:1249`` →
``runtime/comm/coalesced_collectives.py:81``): int4 within the node, int8
across nodes.

As in the JAX package, each rank accumulates its **local** (unreduced)
gradients over the micro-steps in full-size buffers, and at the
gradient-accumulation boundary ``QgzPlan.reduce`` exchanges each leaf along
its ZeRO shard dimension: int4 blocks all-to-all'd over ``dp`` and reduced,
then int8 over ``dpr`` when the world is split hierarchically
(``zero_hpz_partition_size``), which lands on every rank its chunk of the
sum in axes-major order (``dpr_idx * dp + dp_idx``). A leaf with no
shardable dimension is all-reduced in fp32.

The leaves are sent together: one coalesced all-to-all of ints and one of
scales per stage (``exchange_reduce_coalesced``) for each run of leaves of
up to ``COALESCE_BYTES`` of fp32 payload (a call's transient buffers are a
few times its payload; a larger leaf goes alone). ``reduce(...,
buckets=k)`` (the overlap schedule's grad buckets, JAX ``qgz.py:246-330``)
splits the leaves into ``k`` contiguous byte-balanced groups
(``_bucketize``), and ``reduce_bucket`` exchanges one bucket alone, which
the engine starts as soon as backward has folded the bucket's last leaf.
Each leaf keeps its own groups and peer order, so every result is bitwise
the same whatever the buckets and runs.
"""

import torch

from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import (exchange_reduce_coalesced,
                                                                    record_exchange)
from deepspeed_tpu_torch.runtime.zero.partition import moved_shape, zero_shard_dim


# the fp32 payload one coalesced exchange call takes at most (a larger
# leaf goes alone)
COALESCE_BYTES = 512 << 20


class QgzPlan:
    """The groups, bit widths and per-leaf exchange of qgZ."""

    def __init__(self, topology, group_size=2048, intra_bits=4, inter_bits=8):
        self.topology = topology
        self.group_size = group_size
        self.intra_bits = intra_bits
        self.inter_bits = inter_bits
        # hierarchy: dp is the inner (fast) group, dpr the outer
        axes = tuple(a for a in ("dpr", "dp") if topology.get_dim(a) > 1)
        for a in ("ep", "sp"):
            if topology.get_dim(a) > 1:
                raise ValueError(
                    f"zero_quantized_gradients currently supports dp/dpr ZeRO "
                    f"axes only (got {a} size {topology.get_dim(a)} in the "
                    f"ZeRO world)")
        if not axes:
            raise ValueError("zero_quantized_gradients requires a data-parallel "
                             "world > 1")
        self.axes = axes                      # chunk-major order
        self.sizes = {a: topology.get_dim(a) for a in axes}
        self.world = 1
        for a in axes:
            self.world *= self.sizes[a]
        self.groups = {a: topology.get_group(a) for a in axes}
        self.world_group, _, self.world_index = topology.axes_group(axes)
        self.dp_index = topology.get_axis_rank("dp")

    def _zero_dim(self, shape):
        """The dim a leaf of ``shape`` is exchanged along (over ``axes``), or
        None when it stays whole and is all-reduced (the partitioner's
        stage >= 2 gradient rule, threshold 0)."""
        return zero_shard_dim(shape, self.world)

    def _exchange(self, local, d, want_error=False):
        """This rank's chunk of the sum of ``local`` along dim ``d``, flat in
        the element order of ``movedim(d, 0)`` (the engine's shard layout),
        and with ``want_error`` the quantization residual in ``local``'s
        coordinates."""
        return self._exchange_many([(local, d)], want_error)[0]

    def _exchange_many(self, items, want_error=False):
        """``_exchange`` of every ``(local, d)`` of ``items`` (shardable
        leaves), each stage's payloads over one coalesced call."""
        moved = [local.movedim(d, 0) for local, d in items]
        if self.axes == ("dpr", "dp"):
            R, D = self.sizes["dpr"], self.sizes["dp"]
            # stage 1 (inner group): dp-peer i receives slab chunks[:, i]
            slabs = [mv.reshape(R, D, -1).transpose(0, 1).reshape(D, -1) for mv in moved]
            s1 = exchange_reduce_coalesced(slabs, self.groups["dp"], self.intra_bits,
                                           self.group_size, return_error=want_error)
            partials = [x[0] if want_error else x for x in s1]       # [R*m] each
            # stage 2 (outer group): dpr-peer r receives row r of the partial
            s2 = exchange_reduce_coalesced([p.reshape(R, -1) for p in partials],
                                           self.groups["dpr"], self.inter_bits,
                                           self.group_size, return_error=want_error)
            out = []
            for j, mv in enumerate(moved):
                if not want_error:
                    out.append(s2[j])
                    continue
                m = mv.numel() // (R * D)
                # e1 back to chunk coordinates; e2, an error on the partial
                # sum only this rank held, lands at this rank's own dp column
                e1 = s1[j][1].reshape(D, R, m).transpose(0, 1)      # [R, D, m]
                hot = torch.nn.functional.one_hot(
                    torch.tensor(self.dp_index), D).to(e1)[None, :, None]
                err = (e1 + s2[j][1][:, None, :] * hot).reshape(mv.shape)
                out.append((s2[j][0], err.movedim(0, items[j][1])))
            return out
        (axis,) = self.axes
        n = self.sizes[axis]
        bits = self.intra_bits if axis == "dp" else self.inter_bits
        s1 = exchange_reduce_coalesced([mv.reshape(n, -1) for mv in moved],
                                       self.groups[axis], bits, self.group_size,
                                       return_error=want_error)
        if not want_error:
            return s1
        return [(got, err.reshape(mv.shape).movedim(0, d))
                for (got, err), mv, (_, d) in zip(s1, moved, items)]

    def _reduce_leaf(self, local, d, want_error=False):
        """The JAX ``_reduce_leaf``: this rank's chunk of the summed leaf
        (shape of ``local`` with dim ``d`` cut by the world), and with
        ``want_error`` the residual in ``local``'s coordinates."""
        moved_shape = local.movedim(d, 0).shape
        chunk_shape = (moved_shape[0] // self.world,) + tuple(moved_shape[1:])
        got = self._exchange(local, d, want_error)
        out, err = got if want_error else (got, None)
        out = out.reshape(chunk_shape).movedim(0, d)
        return (out, err) if want_error else out

    def shard_group_chunk(self, chunk, shape, dim, shard_dim, shard_world):
        """Under MiCS (the master cut over the ``dp`` group only, along
        ``shard_dim``): this rank's ``dp`` chunk of the summed leaf, flat in
        the ``movedim(shard_dim, 0)`` order, from ``chunk``, the world chunk
        along ``dim`` that ``reduce`` left here. Each rank sends every peer
        only what of its chunk lies in the peer's ``dp`` chunk (one fp32
        all-to-all over the world), so a rank receives ``1 / dp`` of the
        leaf; ``WIRE_BYTES`` counts it as "mics_grad_redistribute"."""
        W, D, c = self.world, shard_world, self.world_index
        R = W // D
        if shard_dim == dim:      # chunk c lies whole in dp chunk c // R
            sends = [chunk if c // R == k % D else chunk.new_empty(0) for k in range(W)]
            recv = [chunk.numel() if k // R == self.dp_index else 0 for k in range(W)]
        else:
            piece = list(moved_shape(shape, dim))
            piece[0] //= W
            mine = chunk.view(piece).movedim(0, dim)      # leaf layout, dim cut
            parts = mine.chunk(D, dim=shard_dim)
            sends = [parts[k % D].reshape(-1) for k in range(W)]
            recv = [sends[0].numel()] * W
        got = dist.all_to_all_single(torch.cat(sends), self.world_group,
                                     output_split_sizes=recv,
                                     input_split_sizes=[t.numel() for t in sends])
        nbytes = (sum(recv) - recv[c]) * got.element_size()
        record_exchange("mics_grad_redistribute", nbytes, nbytes)
        if shard_dim == dim:
            return got
        cut = list(shape)
        cut[dim] //= W
        cut[shard_dim] //= D
        pieces = [x.view(cut) for x in got.split(recv)]
        return torch.cat(pieces, dim=dim).movedim(shard_dim, 0).reshape(-1)

    @staticmethod
    def _bucketize(sizes, buckets):
        """Contiguous leaf-index groups with roughly equal byte load: the
        grad-bucket split the overlap schedule exchanges independently.
        Deterministic (leaf order), never empty, always exactly
        ``min(buckets, len(sizes))`` groups."""
        k = max(1, min(int(buckets), len(sizes)))
        total = float(sum(sizes)) or 1.0
        groups, cur, acc = [], [], 0.0
        for j, s in enumerate(sizes):
            cur.append(j)
            acc += s
            remaining_leaves = len(sizes) - j - 1
            remaining_groups = k - len(groups) - 1
            if (len(groups) < k - 1
                    and (acc >= total * (len(groups) + 1) / k
                         or remaining_leaves == remaining_groups)
                    and remaining_leaves >= remaining_groups):
                groups.append(cur)
                cur = []
        if cur:
            groups.append(cur)
        return groups

    def buckets_of(self, acc, buckets):
        """The leaf-index groups ``reduce(acc, buckets=buckets)`` exchanges."""
        return self._bucketize([a.numel() * a.element_size() for a in acc], buckets)

    def reduce_bucket(self, acc, residual=None, return_residual=False):
        """``reduce`` of the leaves ``acc`` (one bucket): the shardable
        leaves go over coalesced calls of up to ``COALESCE_BYTES`` each."""
        grads, errs = [None] * len(acc), [None] * len(acc)

        def local(j):
            x = acc[j].float()
            return x if residual is None else x + residual[j]

        batches = []
        for j, leaf in enumerate(acc):
            d = self._zero_dim(leaf.shape)
            if d is None:
                x = local(j)
                grads[j] = dist.all_reduce(x.clone() if x is leaf else x,
                                           group=self.world_group)
                errs[j] = torch.zeros_like(x) if return_residual else None
                continue
            nbytes = leaf.numel() * 4
            if batches and load + nbytes <= COALESCE_BYTES:
                batches[-1].append((j, d))
                load += nbytes
            else:
                batches.append([(j, d)])
                load = nbytes
        for batch in batches:
            got = self._exchange_many([(local(j), d) for j, d in batch],
                                      want_error=return_residual)
            for (j, _), g in zip(batch, got):
                if return_residual:
                    grads[j], errs[j] = g
                else:
                    grads[j] = g
        return (grads, errs) if return_residual else grads

    def reduce(self, acc, residual=None, return_residual=False, buckets=1):
        """Local accumulated gradients (a list of full-size tensors) -> this
        rank's summed gradients: for a shardable leaf its chunk, flat in the
        ``movedim(dim, 0)`` order; for the others the whole fp32 sum.

        ``residual`` (error feedback) is the previous step's quantization
        error, one tensor per leaf, folded into the leaf before it is
        quantized; ``return_residual=True`` returns ``(grads, residual')``
        with this step's error (zeros for all-reduced leaves, which are
        never quantized). ``buckets`` > 1 exchanges ``_bucketize``'s groups
        one after another; the results are bitwise those of 1."""
        if return_residual and residual is None:
            raise ValueError("return_residual=True needs the previous "
                             "residual (pass zeros on the first step)")
        grads, errs = [None] * len(acc), [None] * len(acc)
        for idxs in self.buckets_of(acc, buckets):
            got = self.reduce_bucket([acc[j] for j in idxs],
                                     None if residual is None else [residual[j] for j in idxs],
                                     return_residual)
            got, got_err = got if return_residual else (got, [None] * len(idxs))
            for j, g, e in zip(idxs, got, got_err):
                grads[j], errs[j] = g, e
        return (grads, errs) if return_residual else grads

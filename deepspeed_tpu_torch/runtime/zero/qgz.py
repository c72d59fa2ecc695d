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
shardable dimension is all-reduced in fp32. The leaves go one after
another, in order; the overlap schedule, and the JAX package's ``buckets``
that feed it, wait for ROADMAP A10.
"""

import torch

from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import exchange_reduce
from deepspeed_tpu_torch.runtime.zero.partition import zero_shard_dim


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
        self.world_group = topology.axes_group(axes)[0]
        self.dp_index = topology.get_axis_rank("dp")

    def _zero_dim(self, shape):
        """(dim, axes) a leaf of ``shape`` is exchanged along, or (None,
        None) when it stays whole and is all-reduced (the partitioner's
        stage >= 2 gradient rule, threshold 0)."""
        d = zero_shard_dim(shape, self.world)
        return (d, self.axes) if d is not None else (None, None)

    def _exchange(self, local, d, axes, want_error=False):
        """This rank's chunk of the sum of ``local`` along dim ``d``, flat in
        the element order of ``movedim(d, 0)`` (the engine's shard layout),
        and with ``want_error`` the quantization residual in ``local``'s
        coordinates."""
        moved = local.movedim(d, 0)
        err = None
        if axes == ("dpr", "dp"):
            R, D = self.sizes["dpr"], self.sizes["dp"]
            chunks = moved.reshape(R, D, -1)                    # [R, D, m]
            m = chunks.shape[2]
            # stage 1 (inner group): dp-peer i receives slab chunks[:, i]
            slabs = chunks.transpose(0, 1).reshape(D, -1)       # [D, R*m]
            s1 = exchange_reduce(slabs, self.groups["dp"], self.intra_bits,
                                 self.group_size, return_error=want_error)
            partial = s1[0] if want_error else s1               # [R*m]
            # stage 2 (outer group): dpr-peer r receives row r of the partial
            s2 = exchange_reduce(partial.reshape(R, m), self.groups["dpr"],
                                 self.inter_bits, self.group_size,
                                 return_error=want_error)       # [m]
            out = s2[0] if want_error else s2
            if want_error:
                # e1 back to chunk coordinates; e2, an error on the partial
                # sum only this rank held, lands at this rank's own dp column
                e1 = s1[1].reshape(D, R, m).transpose(0, 1)     # [R, D, m]
                hot = torch.nn.functional.one_hot(
                    torch.tensor(self.dp_index), D).to(e1)[None, :, None]
                err = (e1 + s2[1][:, None, :] * hot).reshape(moved.shape)
        else:
            (axis,) = axes
            n = self.sizes[axis]
            bits = self.intra_bits if axis == "dp" else self.inter_bits
            s1 = exchange_reduce(moved.reshape(n, -1), self.groups[axis], bits,
                                 self.group_size, return_error=want_error)
            out = s1[0] if want_error else s1
            if want_error:
                err = s1[1].reshape(moved.shape)
        if want_error:
            return out, err.movedim(0, d)
        return out

    def _reduce_leaf(self, local, d, axes, want_error=False):
        """The JAX ``_reduce_leaf``: this rank's chunk of the summed leaf
        (shape of ``local`` with dim ``d`` cut by the world), and with
        ``want_error`` the residual in ``local``'s coordinates."""
        moved_shape = local.movedim(d, 0).shape
        chunk_shape = (moved_shape[0] // self.world,) + tuple(moved_shape[1:])
        got = self._exchange(local, d, axes, want_error)
        out, err = got if want_error else (got, None)
        out = out.reshape(chunk_shape).movedim(0, d)
        return (out, err) if want_error else out

    def reduce(self, acc, residual=None, return_residual=False):
        """Local accumulated gradients (a list of full-size tensors) -> this
        rank's summed gradients: for a shardable leaf its chunk, flat in the
        ``movedim(dim, 0)`` order; for the others the whole fp32 sum.

        ``residual`` (error feedback) is the previous step's quantization
        error, one tensor per leaf, folded into the leaf before it is
        quantized; ``return_residual=True`` returns ``(grads, residual')``
        with this step's error (zeros for all-reduced leaves, which are
        never quantized)."""
        if return_residual and residual is None:
            raise ValueError("return_residual=True needs the previous "
                             "residual (pass zeros on the first step)")
        grads, errs = [], []
        for j, leaf in enumerate(acc):
            local = leaf.float()
            if residual is not None:
                local = local + residual[j]
            d, axes = self._zero_dim(local.shape)
            if d is None:
                grads.append(dist.all_reduce(local.clone() if local is leaf else local,
                                             group=self.world_group))
                errs.append(torch.zeros_like(local) if return_residual else None)
            elif return_residual:
                g, e = self._exchange(local, d, axes, want_error=True)
                grads.append(g)
                errs.append(e)
            else:
                grads.append(self._exchange(local, d, axes))
        return (grads, errs) if return_residual else grads

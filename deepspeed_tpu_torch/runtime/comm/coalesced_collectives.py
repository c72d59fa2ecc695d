"""Coalesced and quantized collectives: the ZeRO++ exchanges.

Port of ``deepspeed_tpu/runtime/comm/coalesced_collectives.py`` over
``torch.distributed`` process groups (the JAX functions take a mesh axis
name; these take the group of that axis, ``None`` for the whole world):

- ``reduce_scatter_coalesced``: each tensor flattened, padded to the
  group's size and reduce-scattered; every rank keeps its slice of each;
- ``quantized_all_gather`` (qwZ's wire format): the shard is quantized,
  gathered as ints + scales and dequantized row by row;
- ``exchange_reduce`` (qgZ): row j of ``blocks`` goes to peer j as ints +
  scales over one all-to-all and the received rows are dequantized and
  summed in one kernel pass; ``return_error`` also returns this rank's
  quantization residual, the error-feedback carry;
- ``expert_all_to_all``: the MoE dispatch / combine exchange of per-peer
  blocks, in the payload's dtype or (``bits`` 8 / 4) as ints + scales.

The quantize / dequantize halves are the ``ops/quant_collective`` kernels.
``WIRE_BYTES`` counts what each exchange put on the wire beside the fp32
bytes it stands for, in all and per op under ``"ops"``, as plain counters:
the comms telemetry waits for ROADMAP A15.
"""

import torch

from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.ops.quant_collective import (block_dequantize,
                                                      block_dequantize_reduce,
                                                      block_quantize, wire_nbytes)

# cumulative bytes of this process's recorded exchanges: "logical" is the
# fp32 payload they stand for, "wire" what crossed (packed ints plus fp32
# group scales, or the payload in its own dtype); "ops" splits both by op
WIRE_BYTES = {"logical": 0, "wire": 0, "ops": {}}


def _record_wire(logical_numel, wire, op=None):
    WIRE_BYTES["logical"] += int(logical_numel) * 4
    WIRE_BYTES["wire"] += int(wire)
    if op is not None:
        per = WIRE_BYTES["ops"].setdefault(op, {"logical": 0, "wire": 0})
        per["logical"] += int(logical_numel) * 4
        per["wire"] += int(wire)


def reset_wire_bytes():
    WIRE_BYTES.update(logical=0, wire=0, ops={})


def reduce_scatter_coalesced(tensors, group=None):
    """Reduce-scatter of a list of tensors over ``group`` (reference :31):
    each is flattened and zero-padded to a multiple of the group's size;
    every rank gets back its 1/world slice of each sum."""
    world = dist.get_world_size(group)
    out = []
    for t in tensors:
        flat = t.reshape(-1)
        pad = (-flat.shape[0]) % world
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        out.append(dist.reduce_scatter(flat, group=group))
    return out


def quantized_all_gather(x, group=None, num_bits=8, group_size=2048,
                         dtype=torch.float32):
    """qwZ: all-gather with an int8 wire format. Gathers ``x`` (this rank's
    shard) from every rank of ``group`` along dim 0; only the ints and the
    fp32 group scales cross the wire."""
    world = dist.get_world_size(group)
    flat = x.reshape(-1)
    q, scale = block_quantize(flat, num_bits=num_bits, group_size=group_size)
    _record_wire(flat.shape[0], wire_nbytes(flat.shape[0], num_bits, group_size))
    qg = dist.all_gather(q, group=group, tiled=False)        # [world, wire]
    sg = dist.all_gather(scale, group=group, tiled=False)    # [world, groups]
    full = block_dequantize(qg, sg, num_bits=num_bits, group_size=group_size,
                            out_len=flat.shape[0], dtype=dtype)
    return full.reshape((world * x.shape[0],) + tuple(x.shape[1:]))


def exchange_reduce(blocks, group, bits, group_size=2048, return_error=False):
    """Quantized all-to-all + fused dequantize-reduce: the qgZ exchange.

    ``blocks`` [peers, m]: row j is this rank's payload for peer j of
    ``group``. Each row is quantized to ``bits``, row j is sent to peer j,
    and what arrives is dequantized and summed in peer order: returns this
    rank's [m] partial sum over the group. ``return_error=True`` also
    returns ``blocks - dequantize(quantize(blocks))`` [peers, m], computed
    from this rank's own outgoing payload without more communication."""
    P, m = blocks.shape
    if P != dist.get_world_size(group):
        raise ValueError(f"exchange_reduce: {P} rows for a group of "
                         f"{dist.get_world_size(group)} ranks")
    q, s = block_quantize(blocks, num_bits=bits, group_size=group_size)
    _record_wire(blocks.numel(), P * wire_nbytes(m, bits, group_size))
    qx = dist.all_to_all_single(q, group=group)
    sx = dist.all_to_all_single(s, group=group)
    out = block_dequantize_reduce(qx, sx, num_bits=bits, group_size=group_size,
                                  out_len=m)
    if return_error:
        err = blocks - block_dequantize(q, s, num_bits=bits, group_size=group_size,
                                        out_len=m)
        return out, err
    return out


def expert_all_to_all(x, group=None, bits=None, group_size=2048, op="a2a_dispatch"):
    """MoE expert dispatch / combine all-to-all of per-peer payload blocks
    (reference :115).

    ``x`` [peers, ...]: block j is this rank's payload for peer j of
    ``group``; returns [peers, ...] where block j is what peer j sent here.
    ``bits`` None keeps the payload's dtype on the wire and is
    differentiable (its backward is the same exchange). ``bits`` 8 / 4 sends
    each block as ints + fp32 group scales (``block_quantize`` and
    ``block_dequantize``) and is forward-only, as in the JAX package: round
    to nearest has no useful gradient, so a payload that needs one raises.
    ``WIRE_BYTES`` records the exchange under ``op``."""
    P = x.shape[0]
    if bits is None:
        _record_wire(x.numel(), x.numel() * x.element_size(), op)
        return dist.all_to_all(x, group=group)
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(f"expert_all_to_all with bits={bits} is forward-only (round "
                         f"to nearest has no gradient): train with bits=None")
    blocks = x.reshape(P, -1)
    m = blocks.shape[1]
    q, s = block_quantize(blocks, num_bits=bits, group_size=group_size)
    _record_wire(x.numel(), P * wire_nbytes(m, bits, group_size), op)
    qx = dist.all_to_all_single(q, group=group)
    sx = dist.all_to_all_single(s, group=group)
    out = block_dequantize(qx, sx, num_bits=bits, group_size=group_size, out_len=m)
    return out.reshape(x.shape).to(x.dtype)

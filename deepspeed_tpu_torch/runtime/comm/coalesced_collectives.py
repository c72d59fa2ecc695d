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
- ``exchange_reduce_coalesced``: ``exchange_reduce`` of several payloads
  (a grad bucket's leaves) over one all-to-all of ints and one of scales:
  each payload keeps its own groups, so every result is bitwise the one
  ``exchange_reduce`` gives it alone;
- ``expert_all_to_all``: the MoE dispatch / combine exchange of per-peer
  blocks, in the payload's dtype or (``bits`` 8 / 4) as ints + scales;
- the hierarchical quantized collectives (reference :81 and :115, JAX
  ``:150-202``): ``moe_hierarchical_a2a`` (the expert all-to-all over an
  intra group in full precision, then over an inter group quantized) and
  ``all_to_all_quant_reduce`` (qgZ's two-stage reduction of one tensor).

The quantize / dequantize halves are the ``ops/quant_collective`` kernels.
``WIRE_BYTES`` counts what each exchange put on the wire beside the bytes
it stands for (the fp32 payload, unless the caller says otherwise), in all
and per op under ``"ops"``, as plain counters: the comms telemetry waits for
ROADMAP A15.
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


def _record_wire(logical_numel, wire, op=None, logical_bytes=None):
    """Count one exchange: ``logical_numel`` fp32 elements (or
    ``logical_bytes``) stood for by ``wire`` bytes."""
    logical = int(logical_numel) * 4 if logical_bytes is None else int(logical_bytes)
    WIRE_BYTES["logical"] += logical
    WIRE_BYTES["wire"] += int(wire)
    if op is not None:
        per = WIRE_BYTES["ops"].setdefault(op, {"logical": 0, "wire": 0})
        per["logical"] += logical
        per["wire"] += int(wire)


def record_exchange(op, logical_bytes, wire_bytes):
    """Count an exchange made outside this module (qwZ's gathers, hpZ's
    primary exchange) under ``op``."""
    _record_wire(0, wire_bytes, op, logical_bytes=logical_bytes)


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
    return exchange_reduce_coalesced([blocks], group, bits, group_size, return_error)[0]


def exchange_reduce_coalesced(blocks_list, group, bits, group_size=2048,
                              return_error=False):
    """``exchange_reduce`` of every ``[peers, m_j]`` payload of
    ``blocks_list`` over one all-to-all of their ints and one of their
    scales. Each payload is quantized and dequantize-reduced on its own
    (its groups never straddle another's), so result j, and its error, is
    bitwise ``exchange_reduce(blocks_list[j], ...)``'s; only the number of
    collective calls changes (two per call instead of two per payload)."""
    if not blocks_list:
        return []
    P = blocks_list[0].shape[0]
    if P != dist.get_world_size(group):
        raise ValueError(f"exchange_reduce: {P} rows for a group of "
                         f"{dist.get_world_size(group)} ranks")
    qs, ss = [], []
    for blocks in blocks_list:
        q, s = block_quantize(blocks, num_bits=bits, group_size=group_size)
        _record_wire(blocks.numel(), P * wire_nbytes(blocks.shape[1], bits, group_size))
        qs.append(q)
        ss.append(s)
    q_widths, s_widths = [q.shape[1] for q in qs], [s.shape[1] for s in ss]
    qx = dist.all_to_all_single(torch.cat(qs, dim=1) if len(qs) > 1 else qs[0],
                                group=group)
    sx = dist.all_to_all_single(torch.cat(ss, dim=1) if len(ss) > 1 else ss[0],
                                group=group)
    out = []
    for j, (qj, sj) in enumerate(zip(qx.split(q_widths, dim=1), sx.split(s_widths, dim=1))):
        m = blocks_list[j].shape[1]
        got = block_dequantize_reduce(qj, sj, num_bits=bits, group_size=group_size,
                                      out_len=m)
        if return_error:
            err = blocks_list[j] - block_dequantize(qs[j], ss[j], num_bits=bits,
                                                    group_size=group_size, out_len=m)
            got = (got, err)
        out.append(got)
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


def moe_hierarchical_a2a(x, intra_group=None, inter_group=None, inter_bits=8,
                         group_size=2048, op="a2a_dispatch"):
    """The expert all-to-all over a two-level expert world.

    ``x`` [inter, intra, ...]: block (a, b) is this rank's payload for the
    peer at index ``a`` of ``inter_group`` and ``b`` of ``intra_group``.
    Returns [inter, intra, ...] where block (a, b) holds what that peer
    sent here. Stage 1 exchanges in the payload's dtype over the intra
    group; stage 2 exchanges ``inter_bits`` ints + scales over the inter
    group (``inter_bits`` None keeps full precision there too). Rows are
    moved, never reduced: expert tokens arrive whole."""
    # stage 1: lead with the intra destination -> [intra_src, inter_dest, ...]
    y = expert_all_to_all(x.transpose(0, 1).contiguous(), intra_group, bits=None,
                          group_size=group_size, op=op)
    # stage 2: lead with the inter destination -> [inter_src, intra_src, ...]
    return expert_all_to_all(y.transpose(0, 1).contiguous(), inter_group, bits=inter_bits,
                             group_size=group_size, op=op)


def all_to_all_quant_reduce(x, intra_group=None, inter_group=None, intra_bits=4,
                            inter_bits=8, group_size=2048, dtype=torch.float32):
    """qgZ's hierarchical quantized reduction of one tensor (reference :81).

    ``x`` is this rank's full-size gradient; returns this rank's flat
    1/world shard of the sum over every rank (world = intra x inter, the
    tensor zero-padded to a multiple of it). Stage 1 sends ``intra_bits``
    blocks over ``intra_group`` and dequantize-reduces them; stage 2 (with
    an ``inter_group``) repeats at ``inter_bits`` over it. The shard this
    rank holds is chunk ``intra_index * inter + inter_index``."""
    intra = dist.get_world_size(intra_group)
    inter = dist.get_world_size(inter_group) if inter_group is not None else 1
    world = intra * inter
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % world
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    shard = flat.shape[0] // world
    partial = exchange_reduce(flat.reshape(intra, inter * shard), intra_group,
                              intra_bits, group_size)
    if inter == 1:
        return partial.to(dtype)
    return exchange_reduce(partial.reshape(inter, shard), inter_group, inter_bits,
                           group_size).to(dtype)

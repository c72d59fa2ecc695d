"""qwZ: ZeRO++ quantized weights (the engine side of JAX ``runtime/engine.py:
768-805`` and ``:1078-1102``).

The stage-3 working copy of every floating leaf of two or more dimensions
and at least ``stage3_param_persistence_threshold`` elements is held at rest
as int8 plus fp32 scales: ``quantize_lastdim`` of the working-precision leaf
in the JAX layout (groups of ``min(256, d)`` along the JAX leaf's last axis,
scale ``amax / 127`` or 1 for an all-zero group, round half to even of
``x / scale``). A Flax Dense kernel is ``[in, out]`` where an ``nn.Linear``
weight is ``[out, in]``, so a Linear's groups run along its dim 0
(``jax_leaves``); every function here takes the port's shape and cut with
that ``axis`` and works in the "q layout", the leaf with ``axis`` moved
last. The int8 values stay in the port's layout, the scales are the JAX
engine's ``[*q_shape[:-1], G]``, whole on every rank, and ``q`` is cut like
the leaf, as in the JAX package. The quantize is
``ops/quant_collective.block_quantize`` (kernel row 5) on the q layout's
rows, widened to fp32 first (exact), and the dequantize ``block_dequantize``
(row 6, one peer) in fp32, cast once to the working dtype: bitwise
``quantize_lastdim`` / ``dequantize_lastdim`` of the JAX leaf.

A rank holds its master chunk, cut along the leaf's shard dimension. Its
groups are whole when that dimension is not the q layout's last one, or
when the last axis's chunk is a multiple of the group; those chunks are
quantized where they lie (``route`` "chunk"). A chunk that cuts the last
axis mid-group (Llama-2-7B's gate/up ``[11008, 4096]`` at world 4, cut
along the 11008 outputs the JAX groups run along: 10.75 groups a rank)
cannot be: its rows are first exchanged so that each rank holds whole rows
of a row block (one all-to-all of the working dtype), quantized there, and
the ints sent back to the column layout ("rows"). A leaf whose rows do not
divide over the group is gathered whole in the working dtype and quantized
on every rank ("whole"). Every route gives the same bits.
"""

import math

import torch
from torch import nn

from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.ops.quant_collective import block_dequantize, block_quantize
from deepspeed_tpu_torch.runtime.zero.partition import gather_full, moved_shape, shard_of

GROUP = 256


def should_quantize(shape, dtype, threshold):
    """JAX ``_should_quantize`` of a leaf of the JAX ``shape``: two or more
    dimensions, floating, and at least ``threshold`` elements."""
    return (len(shape) >= 2 and dtype.is_floating_point
            and math.prod(shape) >= threshold)


def jax_leaves(module):
    """``{name: (axis, JAX shape)}`` for each parameter of ``module``: the
    axis that is its JAX twin's last, along which qwZ groups it, and the
    twin's shape, which decides whether it is quantized. An ``nn.Linear``
    weight ``[out, in]`` is a Flax Dense kernel ``[in, out]`` transposed:
    dim 0. Every other leaf keeps the JAX layout (embeddings, the router,
    the stacked experts, and ``lm_head``, a plain ``[V, D]`` param in every
    JAX model): its last. A model whose JAX twin stacks its layers
    (``scan_layers``) says so by ``jax_stacked_layers()`` -> (name prefix,
    layers): each such leaf is one ``[layers, ...]`` leaf there, so a
    layer's norm is a 2-D leaf and the threshold reads the stack's size."""
    prefix, layers = getattr(module, "jax_stacked_layers", lambda: (None, 1))()
    out = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            dense = (isinstance(mod, nn.Linear) and pname == "weight"
                     and not name.endswith("lm_head.weight"))
            shape = tuple(p.shape)[::-1] if dense else tuple(p.shape)
            if prefix is not None and name.startswith(prefix):
                shape = (layers,) + shape
            out[name] = (0 if dense else p.dim() - 1, shape)
    return out


def qlayout(shape, dim, axis):
    """(shape, cut dimension) of the q layout of a leaf of ``shape`` cut
    along ``dim`` (or None) whose groups run along ``axis``. Only a 2-D
    leaf groups along another axis than its last; its flat chunk is the
    same tensor in both layouts (``moved_shape`` agrees)."""
    shape = tuple(shape)
    if axis % len(shape) == len(shape) - 1:
        return shape, dim
    if len(shape) != 2:
        raise ValueError(f"qwZ groups a leaf of {len(shape)} dimensions along its last axis")
    return (shape[1], shape[0]), None if dim is None else 1 - dim


def group_of(d):
    """(group size, groups) of a last axis of ``d`` elements."""
    gs = min(GROUP, d)
    return gs, -(-d // gs)


def scale_shape(shape, axis=-1):
    """The JAX scales' shape of a leaf of ``shape`` grouped along ``axis``."""
    qs, _ = qlayout(shape, None, axis)
    return tuple(qs[:-1]) + (group_of(qs[-1])[1],)


def quantize_rows(rows, gs):
    """[R, w] -> (q int8 [R, w], scale fp32 [R, ceil(w / gs)]) in groups of
    ``gs``: kernel row 5 on a CUDA tensor, its plain version on the CPU."""
    w = rows.shape[1]
    q, s = block_quantize(rows.float(), num_bits=8, group_size=gs)
    if q.shape[1] != w:
        q = q[:, :w].contiguous()
    return q, s


def dequantize_rows(q, scale, gs, dtype):
    """[R, w] int8 + [R, G] scales -> [R, w] of ``dtype``: kernel row 6 (one
    peer) in fp32, then one cast."""
    R, w = q.shape
    G = scale.shape[1]
    if G * gs != w:
        q = torch.nn.functional.pad(q, (0, G * gs - w))
    return block_dequantize(q, scale, num_bits=8, group_size=gs, out_len=w).to(dtype)


def quantize_leaf(x, axis=-1):
    """``quantize_lastdim`` of a whole leaf ``x`` along ``axis``: (q int8 in
    ``x``'s layout, the JAX scales)."""
    xq = x.movedim(axis, -1)
    d = xq.shape[-1]
    q, s = quantize_rows(xq.reshape(-1, d), group_of(d)[0])
    return q.view(xq.shape).movedim(-1, axis), s.view(scale_shape(x.shape, axis))


def dequantize_leaf(q, scale, dtype, out=None, axis=-1):
    """``dequantize_lastdim`` along ``axis`` of a whole leaf ``q`` (its
    shape) with its JAX scales, into ``out`` when given."""
    qq = q.movedim(axis, -1)
    d = qq.shape[-1]
    full = dequantize_rows(qq.reshape(-1, d), scale.reshape(-1, scale.shape[-1]),
                           group_of(d)[0], dtype).view(qq.shape)
    if out is None:
        return full.movedim(-1, axis)
    out.movedim(axis, -1).copy_(full)
    return out


def route(shape, dim, world, axis=-1):
    """How a leaf cut along ``dim`` over ``world`` ranks and grouped along
    ``axis`` is quantized: "chunk", "rows" or "whole" (module docstring)."""
    shape, dim = qlayout(shape, dim, axis)
    d = shape[-1]
    gs, _ = group_of(d)
    if world == 1 or dim != len(shape) - 1 or (d // world) % gs == 0:
        return "chunk"
    if math.prod(shape[:-1]) % world == 0:
        return "rows"
    return "whole"


def _local(chunk, dim, shape, group, world):
    """This rank's quantized part of the leaf of q-layout ``shape`` whose
    flat chunk (``movedim(dim, 0)`` order, working dtype) is ``chunk``:
    (route, q, scale), q and scale in the chunk's moved layout ("chunk"),
    a row block [R / world, d] and its [R / world, G] scales ("rows"), or
    the whole leaf's ("whole")."""
    d = shape[-1]
    gs, G = group_of(d)
    how = route(shape, dim, world)
    ms = moved_shape(shape, dim)
    if how == "chunk":
        part = (ms[0] // world,) + ms[1:]
        if dim != len(shape) - 1:
            q, s = quantize_rows(chunk.reshape(-1, d), gs)
            return how, q.view(part), s.view(part[:-1] + (G,))
        R = math.prod(shape[:-1])
        q, s = quantize_rows(chunk.view(part[0], R).t(), gs)     # [R, d / world]
        return how, q.t().reshape(part), s.t().reshape((G // world,) + part[1:])
    R = math.prod(shape[:-1])
    w = d // world
    if how == "rows":
        cols = chunk.view(w, R).t()                               # [R, w]: my columns
        blocks = cols.reshape(world, R // world, w)               # row block j -> rank j
        got = dist.all_to_all_single(blocks, group=group)         # [src, R / world, w]
        rows = got.transpose(0, 1).reshape(R // world, d)         # whole rows
        q, s = quantize_rows(rows, gs)
        return how, q, s
    full = gather_full(chunk, dim, shape, group)
    q, s = quantize_rows(full.reshape(-1, d), gs)
    return how, q.view(shape), s.view(scale_shape(shape))


def requantize_chunk(chunk, dim, shape, group, world, index, axis=-1):
    """qwZ's working copy from this rank's working-precision chunk of the
    leaf of ``shape`` cut along ``dim``: (the int8 chunk, flat in the
    chunk's layout, the leaf's whole JAX scales)."""
    shape, dim = qlayout(shape, dim, axis)
    how, q, s = _local(chunk, dim, shape, group, world)
    S = scale_shape(shape)
    if how == "chunk":
        return q.reshape(-1), gather_full(s.reshape(-1), dim, S, group)
    if how == "rows":
        R, d = math.prod(shape[:-1]), shape[-1]
        w = d // world
        # column block j of my rows goes back to rank j
        back = dist.all_to_all_single(q.view(R // world, world, w).transpose(0, 1),
                                      group=group)                # [row block, R/world, w]
        return (back.reshape(R, w).t().reshape(-1),
                dist.all_gather(s, group=group).view(S))
    return shard_of(q, dim, world, index).clone(), s


def quantized_full(chunk, dim, shape, group, world, axis=-1):
    """hpZ's primary exchange: the whole leaf's int8 ``q`` (in the layout of
    ``shape``) and JAX scales on every rank of ``group`` from each rank's
    working-precision chunk, the ints and scales crossing the wire.
    Returns (q, scale, wire bytes this rank received)."""
    shape, dim = qlayout(shape, dim, axis)
    how, q, s = _local(chunk, dim, shape, group, world)
    S = scale_shape(shape)
    numel = math.prod(shape)
    if how == "whole":
        return q.movedim(-1, axis), s, numel * chunk.element_size() * (world - 1) // world
    if how == "chunk":
        qf = gather_full(q.reshape(-1), dim, shape, group)
        sf = gather_full(s.reshape(-1), dim, S, group)
        relayout = 0
    else:
        R, d = math.prod(shape[:-1]), shape[-1]
        qf = dist.all_gather(q, group=group).view(shape)
        sf = dist.all_gather(s, group=group).view(S)
        relayout = (R // world) * (d // world) * (world - 1) * chunk.element_size()
    wire = (numel + math.prod(S) * 4) * (world - 1) // world + relayout
    return qf.movedim(-1, axis), sf, wire

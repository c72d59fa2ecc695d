"""Tensor-parallel serving primitives: the collectives GSPMD inserts for the
JAX package's ``param_specs`` (``deepspeed_tpu/models/llama.py:350``,
``mixtral.py:207``), written out over a ``torch.distributed`` group.

The weights follow the Megatron pattern. q/k/v, gate/up and the expert
``w1``/``w3`` are split by output columns, so each rank computes its share
of the heads or of the FFN width with no exchange. o, down and the expert
``w2`` are split by input rows, so each rank holds a partial sum of the
layer's output, and ``row_reduce`` all-reduces it (in the activation dtype,
as GSPMD and Megatron do). The embedding and ``lm_head`` are split over the
vocabulary: ``vocab_embed`` looks up the ids this rank holds and
all-reduces (exact: every other rank adds zeros), and ``gather_vocab``
concatenates the ranks' logits. ``tp_slice`` / ``TP_SPLITS`` say which
dimension of each parameter is split; ``from_seed``, ``params_from_flax``
and the HF loader cut the same slices.

Each primitive counts its collectives in plain integer attributes
(``calls``, ``bytes``), as the kernel wrappers count launches, so a caller
can read the exchanges a forward makes. A group of one rank makes no call
and counts nothing.
"""

import dataclasses
from typing import Any, Tuple

import torch
import torch.distributed

from deepspeed_tpu_torch.comm import comm as dist

# Split dimension of each parameter under ``tp``, by the end of its name
# (the port's [out, in] nn.Linear layout, and the JAX layout [E, in, out]
# of the stacked experts); a name matching none is replicated.
TP_SPLITS = (
    ("embed_tokens.weight", 0), ("lm_head.weight", 0),
    ("q_proj.weight", 0), ("k_proj.weight", 0), ("v_proj.weight", 0),
    ("q_proj.bias", 0), ("k_proj.bias", 0), ("v_proj.bias", 0),
    ("o_proj.weight", 1), ("gate_proj.weight", 0), ("up_proj.weight", 0),
    ("down_proj.weight", 1),
    ("experts.w1", 2), ("experts.w3", 2), ("experts.w2", 1),
)


def split_dim(name):
    """The dimension of parameter ``name`` that is split over ``tp``, or
    None when every rank holds it whole (norms, the router, a row-split
    layer's bias, which is added once after the reduce)."""
    for suffix, dim in TP_SPLITS:
        if name.endswith(suffix):
            return dim
    return None


def tp_slice(full, dim, tp_size, tp_rank):
    """Rank ``tp_rank``'s contiguous share of ``full`` along ``dim`` (a view)."""
    if dim is None or tp_size == 1:
        return full
    n = full.shape[dim] // tp_size
    return full.narrow(dim, tp_rank * n, n)


def slice_state_dict(sd, specs, tp_size, tp_rank):
    """Rank ``tp_rank``'s slices of a whole state dict, by ``specs``
    (``{name: split dimension or None}``, a model's ``param_specs``). Each
    split tensor's slice is a copy, so dropping the whole state dict frees
    the whole tensors; a replicated tensor is passed on as it is."""
    def cut(k, v):
        if not torch.is_tensor(v) or specs.get(k) is None or tp_size == 1:
            return v
        return tp_slice(v, specs[k], tp_size, tp_rank).clone(
            memory_format=torch.contiguous_format)
    return {k: cut(k, v) for k, v in sd.items()}


def check_divisible(config, tp_size, family="llama"):
    """Raise ``NotImplementedError`` naming "A5 part 2" for a model this
    slice cannot split over ``tp_size`` ranks."""
    if tp_size == 1:
        return
    why = []
    if family not in ("llama", "mixtral"):
        raise NotImplementedError(
            f"tensor-parallel serving of the {family} family (its param_specs) is not "
            "ported to deepspeed_tpu_torch yet; see ROADMAP.md queue A5 part 2")
    H, KV, V = (config.num_attention_heads, config.num_key_value_heads,
                config.vocab_size)
    if H % tp_size:
        why.append(f"num_attention_heads {H} not divisible by tp_size {tp_size}")
    if KV % tp_size:
        why.append(f"num_key_value_heads {KV} not divisible by tp_size {tp_size} "
                   "(KV heads replicated across ranks)")
    if V % tp_size:
        why.append(f"vocab_size {V} not divisible by tp_size {tp_size}")
    F = getattr(config, "intermediate_size", 0)
    if F % tp_size:
        why.append(f"intermediate_size {F} not divisible by tp_size {tp_size}")
    if why:
        raise NotImplementedError(
            f"tensor-parallel serving at tp_size {tp_size}: {'; '.join(why)} is not "
            "ported to deepspeed_tpu_torch yet; see ROADMAP.md queue A5 part 2")


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place in a ``tp`` group: the process group (None: the
    whole world), its size, this rank's index in it, and the global ranks
    of its members in index order. The default is one rank: no exchange."""
    group: Any = None
    size: int = 1
    rank: int = 0
    ranks: Tuple[int, ...] = (0,)

    @classmethod
    def from_topology(cls, topology):
        """The ``tp`` slice of a ``MeshTopology`` that holds this rank."""
        size = topology.tp_size
        if size == 1:
            return cls()
        coord = topology.get_coord(topology.grid_rank)
        ranks = tuple(int(topology.ranks.flat[topology.get_rank(**dict(coord, tp=i))])
                      for i in range(size))
        return cls(topology.get_group("tp"), size, coord["tp"], ranks)

    @property
    def controller(self):
        """The global rank of tp rank 0, which schedules and samples."""
        return self.ranks[0]


def _count(fn, tensor, calls=1):
    fn.calls += calls
    fn.bytes += tensor.numel() * tensor.element_size()


def row_reduce(x, tp):
    """Sum a row-parallel product's partial outputs over the ``tp`` group,
    in place, in ``x``'s dtype (returns ``x``)."""
    if tp.size == 1:
        return x
    x = x.contiguous()
    _count(row_reduce, x)
    dist.all_reduce(x, group=tp.group)
    return x


row_reduce.calls = 0
row_reduce.bytes = 0


def vocab_embed(weight, ids, tp):
    """Embedding rows of ``ids`` from this rank's vocabulary slice
    ``weight`` [V/tp, D]: ids outside the slice read zeros, and the sum over
    the group is the whole table's lookup."""
    if tp.size == 1:
        return torch.nn.functional.embedding(ids, weight)
    n = weight.shape[0]
    local = ids - tp.rank * n
    inside = (local >= 0) & (local < n)
    x = torch.nn.functional.embedding(local.clamp(0, n - 1), weight) \
        * inside[..., None].to(weight.dtype)
    _count(vocab_embed, x)
    dist.all_reduce(x, group=tp.group)
    return x


vocab_embed.calls = 0
vocab_embed.bytes = 0


def gather_vocab(logits, tp):
    """Concatenate the ranks' vocabulary slices of ``logits`` [..., V/tp]
    into [..., V] on every rank of the group."""
    if tp.size == 1:
        return logits
    _count(gather_vocab, logits)
    parts = dist.all_gather(logits.movedim(-1, 0).contiguous(), group=tp.group)
    return parts.movedim(0, -1).contiguous()


gather_vocab.calls = 0
gather_vocab.bytes = 0


def broadcast_from_controller(tensor, tp):
    """Every rank of the group takes tp rank 0's ``tensor``, in place (the
    single controller's batch and sampled tokens)."""
    if tp.size == 1:
        return tensor
    _count(broadcast_from_controller, tensor)
    torch.distributed.broadcast(tensor, src=tp.controller, group=tp.group)
    return tensor


broadcast_from_controller.calls = 0
broadcast_from_controller.bytes = 0

PRIMITIVES = (row_reduce, vocab_embed, gather_vocab, broadcast_from_controller)


def reset_counts():
    for fn in PRIMITIVES:
        fn.calls = fn.bytes = 0


def counts():
    """{primitive name: {"calls": n, "bytes": b}} since the last reset."""
    return {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes} for fn in PRIMITIVES}

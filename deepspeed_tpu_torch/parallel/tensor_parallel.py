"""Tensor-parallel serving primitives: the collectives GSPMD inserts for the
JAX package's ``param_specs`` (``deepspeed_tpu/models/llama.py:350``,
``mixtral.py:207``, ``opt.py:212``, ``parallel_block.py:259``), written out
over a ``torch.distributed`` group, and ``TPPlan``, the cut of each
parameter among the ranks.

The weights follow the Megatron pattern. q/k/v (Falcon's fused
``query_key_value``), gate/up, ``fc1`` and the expert ``w1``/``w3`` are
split by output columns, so each rank computes its share of the heads or of
the FFN width with no exchange. o, ``out_proj``, ``dense``, down, ``fc2``
and the expert ``w2`` are split by input rows, so each rank holds a partial
sum of the layer's output, and ``row_reduce`` all-reduces it (in the
activation dtype, as GSPMD and Megatron do); their biases are added once,
after the reduce. The embedding and ``lm_head`` (and its bias) are split
over the vocabulary: ``vocab_embed`` looks up the ids this rank holds and
all-reduces (exact: every other rank adds zeros), and ``gather_vocab``
concatenates the ranks' logits.

The JAX mesh cuts a split dimension into equal column ranges and refuses
one whose element count ``tp`` does not divide (``jax.device_put`` raises
``ValueError``); where it divides, a cut may fall inside a head. The port
cuts in whole units instead (``TPPlan``): query heads for the attention
projections, FFN columns for the MLP, quantization groups for an int8
column-split linear. Where ``tp`` does not divide the units the earlier
ranks take one more (Falcon-7B's 71 query heads at tp 2: 36 and 35). A
rank's query heads may map to KV heads it would not hold under an even
cut: it holds copies of those (k and v weights and its own KV pool), so
Falcon-7B's one KV head sits on both ranks. The values each rank computes
are the whole model's, so the results are the JAX package's to rounding.
``from_seed``, ``params_from_flax``, ``slice_state_dict`` and the HF loader
all cut through the plan.

Each primitive counts its collectives in plain integer attributes
(``calls``, ``bytes``), as the kernel wrappers count launches, so a caller
can read the exchanges a forward makes. A group of one rank makes no call
and counts nothing.
"""

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.distributed

from deepspeed_tpu_torch.comm import comm as dist

# Split of each parameter under ``tp``, by the end of its name: the
# dimension (the port's [out, in] nn.Linear layout, and the JAX layout
# [E, in, out] of the stacked experts) and the ``TPPlan`` spans its cut
# follows. A name matching none is replicated (norms, the router, learned
# positions, a row-split layer's bias).
TP_SPLITS = (
    ("embed_tokens.weight", 0, "vocab"), ("lm_head.weight", 0, "vocab"),
    ("lm_head.bias", 0, "vocab"),
    ("q_proj.weight", 0, "q"), ("q_proj.bias", 0, "q"),
    ("k_proj.weight", 0, "kv"), ("k_proj.bias", 0, "kv"),
    ("v_proj.weight", 0, "kv"), ("v_proj.bias", 0, "kv"),
    ("query_key_value.weight", 0, "qkv"), ("query_key_value.bias", 0, "qkv"),
    ("o_proj.weight", 1, "q"), ("out_proj.weight", 1, "q"), ("dense.weight", 1, "q"),
    ("gate_proj.weight", 0, "ffn"), ("up_proj.weight", 0, "ffn"),
    ("fc1.weight", 0, "ffn"), ("fc1.bias", 0, "ffn"),
    ("down_proj.weight", 1, "ffn"), ("fc2.weight", 1, "ffn"),
    ("experts.w1", 2, "ffn"), ("experts.w3", 2, "ffn"), ("experts.w2", 1, "ffn"),
)


def split_of(name):
    """``(dimension, span kind)`` of parameter ``name`` under ``tp``, or
    None when every rank holds it whole."""
    for suffix, dim, kind in TP_SPLITS:
        if name.endswith(suffix):
            return dim, kind
    return None


def split_dim(name):
    """The dimension of parameter ``name`` that is split over ``tp``, or
    None when every rank holds it whole (norms, the router, a row-split
    layer's bias, which is added once after the reduce)."""
    split = split_of(name)
    return None if split is None else split[0]


def unit_ranges(units, tp_size):
    """``[start, end)`` unit ranges of ``units`` whole units over
    ``tp_size`` ranks: equal where ``tp_size`` divides them, else the
    earlier ranks take one more."""
    base, extra = divmod(units, tp_size)
    bounds = [r * base + min(r, extra) for r in range(tp_size + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def _merge(spans):
    """Adjacent ``[start, end)`` spans joined."""
    out = []
    for a, b in spans:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def take_spans(full, dim, spans):
    """The ``[start, end)`` element spans of ``full`` along ``dim``,
    concatenated (a view when there is one span)."""
    if len(spans) == 1:
        a, b = spans[0]
        return full.narrow(dim, a, b - a)
    return torch.cat([full.narrow(dim, a, b - a) for a, b in spans], dim)


def _kv_slots(q0, q1, rep):
    """The global KV heads a rank holding query heads ``[q0, q1)`` keeps,
    in slot order, so that its local query head j reads slot ``j // (its
    query heads / its slots)`` as the paged kernel reads them: the KV
    heads those query heads map to, or, where the range cuts a KV group
    and spans more than one, one slot per query head."""
    lo, hi = q0 // rep, (q1 - 1) // rep + 1
    if hi - lo == 1 or (q0 % rep == 0 and q1 % rep == 0):
        return list(range(lo, hi))
    return [h // rep for h in range(q0, q1)]


class TPPlan:
    """One rank's cut of a model over ``tp_size`` ranks (module docstring).

    ``config`` is a Llama, Mixtral, OPT or Falcon/Phi config.
    ``group_size`` (v1 serving with int8 weights): the quantization group,
    so that every column-split linear is cut in whole groups of the whole
    tensor's quantization (the JAX v1 engine quantizes whole tensors).

    Raises ``ValueError`` where the JAX mesh refuses the split (a split
    dimension whose element count ``tp_size`` does not divide), naming the
    tensor, its size and ``tp_size``; ``NotImplementedError`` naming ROADMAP
    A5 part 3 where a rank would get no whole unit or a cut would split a
    quantization group."""

    def __init__(self, config, tp_size=1, tp_rank=0, group_size=None):
        self.size, self.rank = int(tp_size), int(tp_rank)
        H, KV, Dh, V = (config.num_attention_heads, config.num_key_value_heads,
                        config.head_dim, config.vocab_size)
        F = getattr(config, "intermediate_size", None) or config.ffn_dim
        fused = getattr(config, "fused_qkv", False)
        if self.size == 1:
            q, slots, f, v = (0, H), list(range(KV)), (0, F), (0, V)
        else:
            widths = [("the vocabulary (embed_tokens, lm_head rows)", V),
                      ("the query heads' width (q_proj, o_proj)", H * Dh),
                      ("the FFN width (gate/up/fc1 columns, down/fc2 rows)", F)]
            widths += [("the fused query_key_value width", (H + 2 * KV) * Dh)] if fused \
                else [("the KV heads' width (k_proj, v_proj)", KV * Dh)]
            for what, n in widths:
                if n % self.size:
                    raise ValueError(
                        f"{what} of {n} elements is not divisible by tp_size {self.size}: "
                        "the JAX mesh refuses this split (jax.device_put) and so does "
                        "the port")
            head_unit, ffn_unit = 1, 1
            if group_size:
                head_unit = math.lcm(Dh, min(group_size, H * Dh)) // Dh
                ffn_unit = min(group_size, F)
                if H % head_unit or F % ffn_unit:
                    self._unported(f"groups of {group_size} that do not tile the query "
                                   f"heads ({H} x {Dh}) or the FFN width ({F}) whole")
            self._need_units(H // head_unit, "query-head units")
            self._need_units(F // ffn_unit, "FFN units")
            q0, q1 = unit_ranges(H // head_unit, self.size)[self.rank]
            q = (q0 * head_unit, q1 * head_unit)
            slots = _kv_slots(q[0], q[1], H // KV)
            f0, f1 = unit_ranges(F // ffn_unit, self.size)[self.rank]
            f = (f0 * ffn_unit, f1 * ffn_unit)
            v = (self.rank * V // self.size, (self.rank + 1) * V // self.size)
        kv = _merge([(s * Dh, (s + 1) * Dh) for s in slots])
        if self.size > 1 and group_size:
            gk = min(group_size, KV * Dh)
            if any(e % gk for span in kv for e in span):
                self._unported(f"KV heads {slots} that cut k/v's groups of {gk}")
        self.heads, self.kv_heads = q[1] - q[0], len(slots)
        self.ffn, self.vocab = f[1] - f[0], v[1] - v[0]
        self.spans = {
            "vocab": [v], "q": [(q[0] * Dh, q[1] * Dh)], "kv": kv, "ffn": [f],
            "qkv": _merge([(q[0] * Dh, q[1] * Dh)] + [(H * Dh + a, H * Dh + b)
                                                     for a, b in kv]
                          + [((H + KV) * Dh + a, (H + KV) * Dh + b) for a, b in kv])}

    def _need_units(self, units, what):
        if units < self.size:
            self._unported(f"{units} {what} for {self.size} ranks (a rank would hold none)")

    def _unported(self, what):
        raise NotImplementedError(
            f"tensor-parallel serving at tp_size {self.size} with {what} is not ported to "
            "deepspeed_tpu_torch yet; see ROADMAP.md queue A5 part 3")

    def spans_of(self, name):
        """``(dimension, [start, end) element spans)`` of parameter
        ``name`` on this rank, or None for a replicated one."""
        split = split_of(name)
        if split is None or self.size == 1:
            return None
        return split[0], self.spans[split[1]]

    def cut(self, name, full):
        """This rank's part of the whole tensor ``full`` of parameter
        ``name`` (a view where it is one span; ``full`` itself when
        replicated)."""
        spans = self.spans_of(name)
        return full if spans is None else take_spans(full, *spans)


def slice_state_dict(sd, plan):
    """``plan``'s rank's parts of a whole state dict. Each split tensor's
    part is a copy, so dropping the whole state dict frees the whole
    tensors; a replicated tensor is passed on as it is."""
    def cut(k, v):
        if not torch.is_tensor(v) or plan.spans_of(k) is None:
            return v
        return plan.cut(k, v).clone(memory_format=torch.contiguous_format)
    return {k: cut(k, v) for k, v in sd.items()}


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

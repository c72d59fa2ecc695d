"""Llama model family (port of ``deepspeed_tpu/models/llama.py``).

``LlamaConfig`` with its presets, the interleaved-pair rotary embedding,
RMSNorm, and ``LlamaForCausalLM``: an ``nn.Module`` whose ``forward(batch)``
is the JAX model's training forward (RMSNorm in fp32, interleaved rotary,
``mha`` flash attention, SwiGLU MLP, the fused chunked CE head) and whose
weights the ragged serving forward (``inference/v2/model_implementations/
llama.py``) also runs. Parameter names follow the HuggingFace layout
(``layers.0.self_attn.q_proj.weight``, ...) and linear weights are
``nn.Linear``'s ``[out, in]``. With ``use_cache`` the forward is the JAX
model's KV-cached path (a fixed ``max_position_embeddings`` window per
layer in a ``KVCache`` the caller holds, plain tensor code there too), which
the v1 engine's ``generate`` runs. ``params_from_flax`` converts the JAX
package's scan-stacked flax tree (parameters or their gradients) into this
module's state dict.

With ``tp_size`` > 1 (tensor-parallel serving) the module holds rank
``tp_rank``'s share of the weights, split as the JAX model's
``param_specs`` splits them (``param_specs`` here) and cut by its
``TPPlan`` (``model.plan``, ``parallel/tensor_parallel.py``): whole query
heads (uneven where tp does not divide them) with the KV heads they read,
the MLP width, and the vocabulary of the embedding and ``lm_head``. Its
forward then exchanges over ``model.tp``: the row-split o and down products
are all-reduced, the embedding is looked up from the vocabulary slices and
the logits gathered. ``from_seed`` and ``params_from_flax`` cut each rank's
parts from the whole tensors.
"""

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.models.losses import lm_head_next_token_loss
from deepspeed_tpu_torch.ops.flash_attention import NEG_INF, mha
from deepspeed_tpu_torch.parallel.tensor_parallel import (TensorParallel, TPPlan,
                                                          gather_vocab, row_reduce,
                                                          slice_state_dict, split_dim,
                                                          vocab_embed)
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    attention_bias: bool = False      # qkv bias (Qwen2-family)
    attention_out_bias: bool = False  # o_proj bias too (InternLM-family)
    sliding_window: Any = None        # local-window attention (Mistral-family)
    head_dim: Any = None              # None derives hidden_size // num_attention_heads
    remat: bool = True                # recompute layers in backward per the
    #                                   activation_checkpointing policy
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.hidden_size // self.num_attention_heads)

    @staticmethod
    def tiny(**kw):
        return LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, max_position_embeddings=128, **kw)

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw):
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_hidden_layers=40, num_attention_heads=40,
                           num_key_value_heads=40, **kw)

    @staticmethod
    def llama2_70b(**kw):
        return LlamaConfig(hidden_size=8192, intermediate_size=28672,
                           num_hidden_layers=80, num_attention_heads=64,
                           num_key_value_heads=8, **kw)

    def num_parameters(self):
        c = self
        qo = c.num_attention_heads * c.head_dim
        per_layer = (c.hidden_size * qo  # q
                     + 2 * c.hidden_size * c.num_key_value_heads * c.head_dim  # k,v
                     + qo * c.hidden_size  # o
                     + 3 * c.hidden_size * c.intermediate_size  # gate,up,down
                     + 2 * c.hidden_size)  # norms
        return (c.vocab_size * c.hidden_size * 2  # embed + lm_head
                + c.num_hidden_layers * per_layer + c.hidden_size)


def rms_norm(x, weight, eps):
    """RMSNorm in fp32 with an fp32 scale, cast back to ``x``'s dtype."""
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (norm * weight).to(x.dtype)


class RMSNorm(nn.Module):

    def __init__(self, dim, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                              device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def rotary_embed(x, positions, theta=10000.0):
    """Rotary position embeddings on INTERLEAVED pairs (``x[..., ::2]``,
    ``x[..., 1::2]``), as the JAX package rotates — not HF's rotate-half.
    x: [B, T, H, Dh]; positions: [B, T]."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    angles = positions[..., None].float() * freqs  # [B, T, dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.stack([rx1, rx2], dim=-1).reshape(x.shape).to(x.dtype)


def row_linear(x, linear, tp):
    """A row-split ``nn.Linear`` (or int8 ``QuantizedLinear``, by its
    ``product``): this rank's partial product, summed over the ``tp`` group,
    then the bias once."""
    if tp.size == 1:
        return linear(x)
    product = getattr(linear, "product", None)
    y = row_reduce(product(x) if product else torch.nn.functional.linear(x, linear.weight),
                   tp)
    return y if linear.bias is None else y + linear.bias


class LlamaAttention(nn.Module):
    """q/k/v/o projections of one tensor-parallel rank's query heads and the
    KV heads they read (``plan``, a ``TPPlan``; all of them without one)."""

    def __init__(self, cfg, device=None, plan=None):
        super().__init__()
        plan = plan or TPPlan(cfg)
        H, KV, Dh, D = plan.heads, plan.kv_heads, cfg.head_dim, cfg.hidden_size
        kw = dict(device=device, dtype=cfg.dtype)
        self.q_proj = nn.Linear(D, H * Dh, bias=cfg.attention_bias, **kw)
        self.k_proj = nn.Linear(D, KV * Dh, bias=cfg.attention_bias, **kw)
        self.v_proj = nn.Linear(D, KV * Dh, bias=cfg.attention_bias, **kw)
        self.o_proj = nn.Linear(H * Dh, D, bias=cfg.attention_out_bias, **kw)
        self.num_heads, self.num_kv_heads = H, KV
        self.config = cfg
        self.tp = TensorParallel()

    def forward(self, x, positions, attention=mha, kv=None):
        """``kv``: this layer's ``(keys, values, index)`` of a ``KVCache``;
        with it the cached path runs instead of ``attention``."""
        cfg = self.config
        B, T, _ = x.shape
        H, KV, Dh = self.num_heads, self.num_kv_heads, cfg.head_dim
        q = rotary_embed(self.q_proj(x).view(B, T, H, Dh), positions, cfg.rope_theta)
        k = rotary_embed(self.k_proj(x).view(B, T, KV, Dh), positions, cfg.rope_theta)
        v = self.v_proj(x).view(B, T, KV, Dh)
        if kv is not None:
            out = cached_attention(q, k, v, *kv, window=cfg.sliding_window)
        else:
            # GQA k/v pass un-repeated; a sliding window goes to the kernel
            out = attention(q, k, v, causal=True, window=cfg.sliding_window or None)
        return row_linear(out.reshape(B, T, H * Dh), self.o_proj, self.tp)


def cached_attention(q, k, v, keys, values, index, window=None):
    """Attention of ``q`` [B, T, H, Dh] over a fixed-window cache, the JAX
    model's ``use_cache`` path (plain tensor code there too): ``k``, ``v``
    [B, T, KV, Dh] are written into ``keys``/``values`` [B, KV, L, Dh] at
    ``index``; position j of the window is visible to query i iff
    ``j <= index + i`` (and ``j > index + i - window``), masked with
    ``NEG_INF``. GQA runs against the unrepeated cache: the logits in q's
    dtype, then fp32 with the softmax, probabilities cast back to q's dtype
    for the product with the values. The cache keeps each (row, KV head)'s
    window contiguous, so both products read it in place (the JAX layout
    [B, L, KV, Dh] would make them copy it whole, every layer and step)."""
    B, T, H, Dh = q.shape
    KV, L = keys.shape[1], keys.shape[2]
    if index + T > L:
        raise ValueError(f"cache window {L} cannot take {T} more positions at {index}")
    if H == 0:
        return q                 # a tp rank's empty share: no heads
    keys[:, :, index:index + T] = k.transpose(1, 2).to(keys.dtype)
    values[:, :, index:index + T] = v.transpose(1, 2).to(values.dtype)
    key_pos = torch.arange(L, device=q.device)[None, :]
    qry_pos = index + torch.arange(T, device=q.device)[:, None]
    visible = key_pos <= qry_pos
    if window:
        visible = visible & (key_pos > qry_pos - window)
    bias = torch.where(visible, 0.0, NEG_INF)
    rep = H // KV
    qg = q.reshape(B, T, KV, rep, Dh).permute(0, 2, 3, 1, 4).reshape(B, KV, rep * T, Dh)
    logits = (qg @ keys.transpose(2, 3)).float() * (1.0 / Dh ** 0.5)
    probs = torch.softmax(logits.view(B, KV, rep, T, L) + bias, dim=-1).to(q.dtype)
    out = probs.view(B, KV, rep * T, L) @ values             # [B, KV, rep * T, Dh]
    return out.view(B, KV, rep, T, Dh).permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh)


class LlamaMLP(nn.Module):

    def __init__(self, cfg, device=None, plan=None):
        super().__init__()
        D, F = cfg.hidden_size, (plan or TPPlan(cfg)).ffn
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        self.gate_proj = nn.Linear(D, F, **kw)
        self.up_proj = nn.Linear(D, F, **kw)
        self.down_proj = nn.Linear(F, D, **kw)
        self.tp = TensorParallel()

    def forward(self, x):
        return row_linear(torch.nn.functional.silu(self.gate_proj(x)) * self.up_proj(x),
                          self.down_proj, self.tp)


class LlamaDecoderLayer(nn.Module):

    def __init__(self, cfg, device=None, plan=None):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, device, plan)
        self.mlp = LlamaMLP(cfg, device, plan)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, device)

    def forward(self, x, positions, attention=mha, kv=None):
        x = x + self.self_attn(self.input_layernorm(x), positions, attention, kv)
        return x + self.mlp(self.post_attention_layernorm(x))


class KVCache:
    """The fixed-window KV cache a caller holds for ``LlamaForCausalLM``'s
    cached forward (the JAX model's "cache" collection): per layer keys and
    values [B, KV, max_position_embeddings, Dh], zeros at first, and the
    next position to write, shared by every layer. ``num_kv_heads``: the
    KV heads this rank holds (default all of them)."""

    def __init__(self, config, batch, dtype, device, num_kv_heads=None):
        shape = (batch, config.num_key_value_heads if num_kv_heads is None else num_kv_heads,
                 config.max_position_embeddings, config.head_dim)
        self.keys = [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(config.num_hidden_layers)]
        self.values = [torch.zeros_like(k) for k in self.keys]
        self.index = 0


class LlamaForCausalLM(nn.Module):
    """Weights of a Llama-family causal LM. Norm scales are fp32, every
    other weight is ``config.dtype`` (the JAX package casts to that dtype at
    each use; storing it cast gives the same values). ``tp_size`` > 1 keeps
    rank ``tp_rank``'s share of the weights of a tensor-parallel group
    (module docstring); the forward exchanges over ``tp``
    (``set_tensor_parallel``), by default the whole world of ``tp_size``
    ranks. ``quant_group_size``: cut the column-split linears in whole
    quantization groups of that size (v1 serving with int8 weights,
    ``TPPlan``)."""

    def __init__(self, config: LlamaConfig, device=None, tp_size=1, tp_rank=0,
                 quant_group_size=None):
        super().__init__()
        self.config = config
        self.plan = plan = TPPlan(config, tp_size, tp_rank, quant_group_size)
        kw = dict(device=device, dtype=config.dtype)
        self.embed_tokens = nn.Embedding(plan.vocab, config.hidden_size, **kw)
        self.layers = nn.ModuleList(LlamaDecoderLayer(config, device, plan)
                                    for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)
        self.lm_head = nn.Linear(config.hidden_size, plan.vocab, bias=False, **kw)
        self.tp_size = tp_size
        self.set_tensor_parallel(TensorParallel(size=tp_size, rank=tp_rank,
                                                ranks=tuple(range(tp_size))))

    def set_tensor_parallel(self, tp):
        """Exchange over ``tp`` (a ``TensorParallel`` of ``tp_size`` ranks,
        whose ``rank`` is the one this module holds the share of) in every
        layer's forward."""
        set_tensor_parallel(self, tp)

    def param_specs(self):
        """``{name: split dimension or None}`` over ``tp``: the JAX model's
        ``param_specs`` (``models/llama.py:350``) in this module's layout.
        q/k/v and gate/up are column-split (dim 0 of ``[out, in]``), o and
        down row-split (dim 1), the embedding and ``lm_head`` split over the
        vocabulary (dim 0); norms and a row-split layer's bias are
        replicated."""
        return {name: split_dim(name) for name, _ in self.named_parameters()}

    def streaming_plan(self):
        """The streaming protocol (JAX ``streaming_plan``): the decoder
        layers, in order, are the blocks whose gathers the overlap schedule
        starts ahead of their use."""
        return {"num_blocks": len(self.layers)}

    def jax_stacked_layers(self):
        """The JAX twin stacks its decoder layers (``scan_layers=True``, the
        layout ``params_from_flax`` reads): each ``layers.{i}`` leaf is one
        ``[L, ...]`` leaf there, which qwZ's threshold and grouping read
        (``runtime/zero/qwz.jax_leaves``)."""
        return "layers.", len(self.layers)

    def forward(self, batch, positions=None, attention=mha, use_cache=False, cache=None):
        """The JAX model's ``__call__``: ``batch`` is a dict with
        ``input_ids`` [B, T] and optional ``labels`` [B, T], or the ids
        alone. Returns the next-token loss when there are labels, else the
        logits [B, T, V]. In training each decoder layer runs under the
        configured activation-checkpointing policy (``config.remat``).
        ``attention`` replaces ``mha`` (a plain version, for comparisons).
        With ``use_cache`` the layers attend through ``cache`` (a
        ``KVCache``), which advances by T, and ``(logits, cache)`` is
        returned. A tensor-parallel module returns the whole vocabulary's
        logits; its loss is ROADMAP A12."""
        cfg = self.config
        if isinstance(batch, dict):
            input_ids, labels = batch["input_ids"], batch.get("labels")
        else:
            input_ids, labels = batch, None
        if labels is not None and not use_cache and self.tp_size > 1:
            raise NotImplementedError(
                "the next-token loss of a tensor-parallel Llama (its lm_head holds one "
                "vocabulary slice; training over a tp axis) is not ported to "
                "deepspeed_tpu_torch yet: ROADMAP A12")
        input_ids = input_ids.long()
        B, T = input_ids.shape
        x = vocab_embed(self.embed_tokens.weight, input_ids, self.tp)
        if positions is None:
            positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
        if use_cache:
            if cache is None:
                raise ValueError("use_cache needs the KVCache the caller holds")
            for layer, keys, values in zip(self.layers, cache.keys, cache.values):
                x = layer(x, positions, attention, kv=(keys, values, cache.index))
            cache.index += T
        else:
            for layer in self.layers:
                if cfg.remat:
                    x = checkpointing.checkpoint(layer, x, positions, attention)
                else:
                    x = layer(x, positions, attention)
        x = self.norm(x)
        if labels is None or use_cache:
            logits = gather_vocab(self.lm_head(x), self.tp)
            return (logits, cache) if use_cache else logits
        return lm_head_next_token_loss(x, self.lm_head.weight, labels)

    @classmethod
    def from_seed(cls, config: LlamaConfig, seed: int, device=None,
                  std: float = 0.02, tp_size=1, tp_rank=0):
        """Random weights drawn on ``device`` (default ``"cuda"``, which
        raises without a GPU) from ``torch.Generator(seed)``: N(0, std) for
        every matrix, zeros for biases, ones for norm scales (the flax
        initializers' shapes; the draws differ from JAX's). With
        ``tp_size`` > 1 each split tensor is drawn whole and rank
        ``tp_rank``'s part kept, so every rank's weights are those of the
        one-rank model."""
        model = cls(config, device="meta", tp_size=tp_size, tp_rank=tp_rank)
        return draw_from_seed(model, seed, device, std, tp_parts(model))


def llama_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs/token ~ 6N + 12 L D T: the attention term counts every
    (query, key) pair, not the causal half."""
    return 6 * cfg.num_parameters() + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq_len


def set_tensor_parallel(model, tp):
    """Point every submodule's ``tp`` (and the model's) at ``tp``, which
    must have the ``tp_size`` the model was built with and name the rank it
    holds the share of."""
    if tp.size != model.tp_size or tp.rank != model.plan.rank:
        raise ValueError(f"tp rank {tp.rank} of {tp.size} for a model holding rank "
                         f"{model.plan.rank}'s share of tp_size {model.tp_size}")
    for m in model.modules():
        if hasattr(m, "tp"):
            m.tp = tp
    model.tp = tp


def tp_parts(model):
    """``{name: (whole shape, cut)}`` for each parameter ``model`` holds one
    tensor-parallel part of (its ``plan``): the ``parts`` argument of
    ``draw_from_seed``."""
    if model.tp_size == 1:
        return {}
    whole = dict(type(model)(model.config, device="meta").named_parameters())
    return {name: (whole[name].shape, functools.partial(model.plan.cut, name))
            for name, dim in model.param_specs().items() if dim is not None}


def draw_from_seed(model, seed, device, std, parts):
    """Materialise ``model`` (built on the meta device) on ``device`` with
    seeded random weights: N(0, std) for every matrix, zeros for biases,
    ones for norm scales, each drawn from one ``torch.Generator(seed)`` in
    parameter order. ``parts`` maps the name of a parameter that holds one
    part of a whole tensor (its ``tp`` or ``ep`` part) to ``(whole shape,
    cut)``: that tensor is drawn whole and ``cut(whole)`` kept, so every
    rank's weights are the one-rank model's, with at most one whole tensor
    alive at a time. The model then serves as the rank its plan holds."""
    device = resolve_device(device)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            elif name in parts:
                shape, cut = parts[name]
                full = torch.empty(shape, dtype=p.dtype, device=device)
                p.copy_(cut(full.normal_(0.0, std, generator=gen)))
                del full
            else:
                p.normal_(0.0, std, generator=gen)
    return model.requires_grad_(False)


def params_from_flax(tree, plan=None):
    """The JAX package's ``LlamaForCausalLM`` (``scan_layers=True``) param
    tree, as numpy arrays, -> a state dict for this ``LlamaForCausalLM``.
    The same mapping converts a gradient tree of the same structure.

    Flax kernels are ``[in, out]`` stacked ``[L, in, out]`` over layers;
    ``nn.Linear`` weights are ``[out, in]``, so each is unstacked and
    transposed. ``lm_head`` is ``[V, D]`` in both. Values are copied as
    fp32; ``load_state_dict`` casts them to the module's dtype. With
    ``plan`` (a ``TPPlan``), its rank's parts, for a model built with that
    plan (``model.plan``)."""
    blk = tree["layers"]["block"]
    L = np.asarray(blk["input_layernorm"]["scale"]).shape[0]
    sd = {"embed_tokens.weight": tree["embed_tokens"],
          "lm_head.weight": tree["lm_head"],
          "norm.weight": tree["norm"]["scale"]}
    for i in range(L):
        pre = f"layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[pre + norm + ".weight"] = np.asarray(blk[norm]["scale"])[i]
        for group, names in (("self_attn", ("q_proj", "k_proj", "v_proj",
                                            "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for n in names:
                leaf = blk[group][n]
                sd[f"{pre}{group}.{n}.weight"] = \
                    np.asarray(leaf["kernel"])[i].T
                if "bias" in leaf:
                    sd[f"{pre}{group}.{n}.bias"] = np.asarray(leaf["bias"])[i]
    sd = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    return sd if plan is None else slice_state_dict(sd, plan)

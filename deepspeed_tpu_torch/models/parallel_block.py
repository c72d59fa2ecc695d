"""Parallel-residual decoder families: Falcon and Phi (port of
``deepspeed_tpu/models/parallel_block.py``).

Both use the parallel residual ``x + attn(ln(x)) + mlp(ln(x))`` with one
shared input LayerNorm, and differ in:

- Falcon: no linear biases, a fused MQA/GQA ``query_key_value``
  projection, full rotary, an exact-GELU MLP, an optionally tied head;
- Phi: biases everywhere (the head's too), separate q/k/v and ``dense``,
  partial rotary (only the leading ``rotary_dim`` of each head rotates), a
  tanh-GELU MLP.

``ParallelBlockForCausalLM`` is an ``nn.Module`` whose ``forward(batch)`` is
the JAX model's training forward: LayerNorm in fp32 with fp32 scale and
bias, interleaved-pair rotary on the rotated slice, ``mha`` flash attention,
the biased head's dense loss or the fused chunked CE head. Parameter names
follow the JAX tree (``layers.0.query_key_value.weight``, ...), linear
weights are ``nn.Linear``'s ``[out, in]``; the ragged serving forward
(``inference/v2/model_implementations/parallel_block.py``) runs the same
weights. ``falcon.py`` and ``phi.py`` hold the family presets.
``params_from_flax`` converts the JAX package's tree into this module's
state dict. Of the ZeRO-Infinity streaming protocol it has
``streaming_plan`` (the layers the overlap schedule prefetches); the rest
waits for ROADMAP A14.

With ``tp_size`` > 1 (tensor-parallel serving, the JAX model's
``param_specs``, ``models/parallel_block.py:259``) the module holds rank
``tp_rank``'s share, cut by its ``TPPlan`` (``parallel/tensor_parallel.py``):
its query heads (Falcon-7B's 71 at tp 2: 36 and 35) with copies of the KV
heads they read, Falcon's fused ``query_key_value`` rows cut to those q
heads plus those k and v heads, Phi's q/k/v and their biases; ``fc1`` and
its bias by FFN columns; ``dense`` and ``fc2`` by input rows (their biases
whole, added once after the reduce); the embedding, ``lm_head`` and its
bias by vocabulary. Such a module serves through the ragged forward and the
KV-cached forward, which exchange over ``model.tp``; its training forward
is ROADMAP A12.

With ``use_cache`` the forward is the JAX ``ParallelBlock``'s KV-cached
path (``models/parallel_block.py:127-142``), which the v1 engine's
``generate`` runs: each layer writes its k and v into a fixed
``max_position_embeddings`` window of a ``llama.KVCache`` the caller holds
and attends through ``llama.cached_attention``, the Llama model's cached
path (the JAX ``use_cache`` paths of the two families are the same
arithmetic: ``NEG_INF`` mask, ``H // KV`` grouped products with the logits
in q's dtype, then fp32, probabilities rounded to q's dtype). The JAX
package computes this attention outside any Pallas kernel, so plain tensor
code is its port. The cache holds each (row, KV head)'s window
contiguously, ``[B, KV, L, Dh]``, where the JAX cache is ``[B, L, KV,
Dh]``: the same values, read in place by both products. Under tensor
parallelism the two row-split products, ``dense`` and ``fc2``, are summed
on the rank and all-reduced once a layer, as in the ragged forward.
"""

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.llama import (cached_attention, draw_from_seed,
                                              rotary_embed, set_tensor_parallel, tp_parts)
from deepspeed_tpu_torch.models.losses import lm_head_next_token_loss, next_token_loss
from deepspeed_tpu_torch.ops.flash_attention import mha
from deepspeed_tpu_torch.parallel.tensor_parallel import (TensorParallel, TPPlan,
                                                          gather_vocab, row_reduce,
                                                          slice_state_dict, split_dim,
                                                          vocab_embed)
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing


@dataclasses.dataclass(frozen=True)
class ParallelBlockConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    intermediate_size: int = 18176
    num_hidden_layers: int = 32
    num_attention_heads: int = 71
    num_key_value_heads: int = 1          # MQA (falcon-7b) by default
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0               # phi/neox/gptj: partial rotary fraction
    use_bias: bool = False                # phi/neox: True
    qkv_bias: Any = None                  # gptj: False while mlp has biases
    dense_bias: Any = None                # (None -> use_bias)
    mlp_bias: Any = None
    fused_qkv: bool = True                # falcon/neox layout; phi/gptj: False
    dual_layernorm: bool = False          # neox: mlp reads its own LN of x
    gelu_exact: bool = True               # falcon/neox: erf; phi/gptj tanh
    lm_head_bias: bool = False            # phi/gptj: True (falcon: never)
    tie_lm_head: bool = False
    remat: bool = True
    dtype: torch.dtype = torch.bfloat16
    # serving-module pins of the JAX config; the port's engine takes its
    # pins from RaggedInferenceEngineConfig.modules
    serve_modules: Any = None

    def _bias(self, which):
        v = getattr(self, which)
        return self.use_bias if v is None else bool(v)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self):
        rd = int(self.head_dim * self.rotary_pct)
        return rd - rd % 2


def partial_rotary(x, positions, theta, rotary_dim):
    """Rotate only the leading ``rotary_dim`` of each head (phi-style)."""
    if rotary_dim >= x.shape[-1]:
        return rotary_embed(x, positions, theta)
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    return torch.cat([rotary_embed(rot, positions, theta), rest], dim=-1)


def layer_norm(x, weight, bias, eps):
    """LayerNorm in fp32 with fp32 scale and bias, cast back to ``x``'s
    dtype (the JAX ``_LN`` and ``_layernorm``)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


class LayerNorm(nn.Module):

    def __init__(self, dim, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def gelu(x, exact):
    return F.gelu(x, approximate="none" if exact else "tanh")


class ParallelBlock(nn.Module):
    """One parallel-residual layer holding one tensor-parallel rank's query
    heads, the KV heads they read and its FFN columns (``plan``, a
    ``TPPlan``; all of them without one)."""

    def __init__(self, cfg, device=None, plan=None):
        super().__init__()
        plan = plan or TPPlan(cfg)
        H, KV, Dh, D = plan.heads, plan.kv_heads, cfg.head_dim, cfg.hidden_size
        self.num_heads, self.num_kv_heads = H, KV
        kw = dict(device=device, dtype=cfg.dtype)
        self.input_layernorm = LayerNorm(D, cfg.layer_norm_eps, device)
        if cfg.dual_layernorm:
            self.post_attention_layernorm = LayerNorm(D, cfg.layer_norm_eps, device)
        qb = cfg._bias("qkv_bias")
        if cfg.fused_qkv:
            self.query_key_value = nn.Linear(D, (H + 2 * KV) * Dh, bias=qb, **kw)
        else:
            self.q_proj = nn.Linear(D, H * Dh, bias=qb, **kw)
            self.k_proj = nn.Linear(D, KV * Dh, bias=qb, **kw)
            self.v_proj = nn.Linear(D, KV * Dh, bias=qb, **kw)
        self.dense = nn.Linear(H * Dh, D, bias=cfg._bias("dense_bias"), **kw)
        mb = cfg._bias("mlp_bias")
        self.fc1 = nn.Linear(D, plan.ffn, bias=mb, **kw)
        self.fc2 = nn.Linear(plan.ffn, D, bias=mb, **kw)
        self.config = cfg
        self.tp = TensorParallel()

    def qkv(self, h):
        """q [.., H, Dh], k and v [.., KV, Dh] of the normed input ``h``
        [.., D], before rotary."""
        cfg = self.config
        H, KV, Dh = self.num_heads, self.num_kv_heads, cfg.head_dim
        lead = h.shape[:-1]
        if cfg.fused_qkv:
            qkv = self.query_key_value(h)
            return (qkv[..., :H * Dh].reshape(*lead, H, Dh),
                    qkv[..., H * Dh:(H + KV) * Dh].reshape(*lead, KV, Dh),
                    qkv[..., (H + KV) * Dh:].reshape(*lead, KV, Dh))
        return (self.q_proj(h).view(*lead, H, Dh), self.k_proj(h).view(*lead, KV, Dh),
                self.v_proj(h).view(*lead, KV, Dh))

    def forward(self, x, positions, attention=mha, kv=None):
        """``kv``: this layer's ``(keys, values, index)`` of a ``KVCache``;
        with it the cached path runs instead of ``attention``."""
        cfg = self.config
        B, T, _ = x.shape
        h = self.input_layernorm(x)
        # neox-style dual LN: the MLP branch normalizes x independently
        hm = self.post_attention_layernorm(x) if cfg.dual_layernorm else h
        q, k, v = self.qkv(h)
        q = partial_rotary(q, positions, cfg.rope_theta, cfg.rotary_dim)
        k = partial_rotary(k, positions, cfg.rope_theta, cfg.rotary_dim)
        if kv is not None:
            attn = cached_attention(q, k, v, *kv).reshape(B, T, -1)
        else:
            attn = attention(q, k, v, causal=True).reshape(B, T, -1)
        act = gelu(self.fc1(hm), cfg.gelu_exact)
        if self.tp.size == 1:
            return x + self.dense(attn) + self.fc2(act)
        x = x + row_reduce(_partial(self.dense, attn) + _partial(self.fc2, act), self.tp)
        for b in (self.dense.bias, self.fc2.bias):
            if b is not None:
                x = x + b
        return x


def _partial(linear, x):
    """A row-split linear's partial product on this rank, without its bias
    (an ``nn.Linear`` or an int8 ``QuantizedLinear``)."""
    product = getattr(linear, "product", None)
    return product(x) if product else F.linear(x, linear.weight)


class ParallelBlockForCausalLM(nn.Module):
    """Weights of a Falcon/Phi causal LM. LayerNorm scales and biases are
    fp32, every other weight is ``config.dtype`` (the JAX package casts to
    that dtype at each use; storing it cast gives the same values). With
    ``tie_lm_head`` the head is the embedding and there is no ``lm_head``;
    with ``lm_head_bias`` (untied) the head has a bias. ``tp_size`` > 1
    keeps rank ``tp_rank``'s share (module docstring); ``quant_group_size``
    cuts it in whole quantization groups where they tile (v1 serving with
    int8 weights, ``TPPlan``)."""

    def __init__(self, config: ParallelBlockConfig, device=None, tp_size=1, tp_rank=0,
                 quant_group_size=None):
        super().__init__()
        self.config = config
        self.plan = plan = TPPlan(config, tp_size, tp_rank, quant_group_size)
        kw = dict(device=device, dtype=config.dtype)
        self.embed_tokens = nn.Embedding(plan.vocab, config.hidden_size, **kw)
        self.layers = nn.ModuleList(ParallelBlock(config, device, plan)
                                    for _ in range(config.num_hidden_layers))
        self.final_layernorm = LayerNorm(config.hidden_size, config.layer_norm_eps, device)
        if not config.tie_lm_head:
            self.lm_head = nn.Linear(config.hidden_size, plan.vocab,
                                     bias=config.lm_head_bias, **kw)
        self.tp_size = tp_size
        self.set_tensor_parallel(TensorParallel(size=tp_size, rank=tp_rank,
                                                ranks=tuple(range(tp_size))))

    def set_tensor_parallel(self, tp):
        """The ``tp`` group the serving forward exchanges over (see
        ``LlamaForCausalLM.set_tensor_parallel``)."""
        set_tensor_parallel(self, tp)

    def param_specs(self):
        """``{name: split dimension or None}`` over ``tp``: the JAX model's
        ``param_specs`` (``models/parallel_block.py:259``) in this module's
        layout (module docstring)."""
        return {name: split_dim(name) for name, _ in self.named_parameters()}

    def head(self):
        """(weight [V, D] (None for an int8 ``lm_head``), bias [V] or None)
        of the output head."""
        if self.config.tie_lm_head:
            return self.embed_tokens.weight, None
        return getattr(self.lm_head, "weight", None), self.lm_head.bias

    def streaming_plan(self):
        """The streaming protocol (JAX ``streaming_plan``): the decoder
        layers, in order, are the blocks whose gathers the overlap schedule
        starts ahead of their use."""
        return {"num_blocks": len(self.layers)}

    def forward(self, batch, positions=None, attention=mha, use_cache=False, cache=None):
        """The JAX model's ``__call__``: ``batch`` is a dict with
        ``input_ids`` [B, T] and optional ``labels`` [B, T], or the ids
        alone. Returns the next-token loss when there are labels, else the
        logits [B, T, V]; a biased head takes the dense logits for its loss
        (the fused CE has no bias slot). In training each block runs under
        the configured activation-checkpointing policy (``config.remat``).
        ``attention`` replaces ``mha`` (a plain version, for comparisons).
        With ``use_cache`` the layers attend through ``cache`` (a
        ``llama.KVCache``), which advances by T, and ``(logits, cache)`` is
        returned (module docstring). A tensor-parallel module serves this
        path and the logits forward, returning the whole vocabulary's
        logits; its loss is ROADMAP A12."""
        cfg = self.config
        if isinstance(batch, dict):
            input_ids, labels = batch["input_ids"], batch.get("labels")
        else:
            input_ids, labels = batch, None
        if self.tp_size > 1 and labels is not None and not use_cache:
            raise NotImplementedError(
                "the loss of a tensor-parallel Falcon/Phi (training, tp axis) is not "
                "ported to deepspeed_tpu_torch yet: ROADMAP A12")
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
        x = self.final_layernorm(x)
        head, hb = self.head()
        if labels is None or hb is not None or use_cache:
            logits = self._logits(x, head, hb)
            if labels is None or use_cache:
                return (logits, cache) if use_cache else logits
            return next_token_loss(logits, labels)
        return lm_head_next_token_loss(x, head, labels)

    def _logits(self, x, head, hb):
        """``x @ head.T (+ bias)`` in x's dtype, gathered over the
        vocabulary slices; an int8 ``lm_head`` (v1 quantization) through its
        product."""
        product = None if self.config.tie_lm_head else getattr(self.lm_head, "product", None)
        logits = product(x) if product else x @ head.to(x.dtype).T
        if hb is not None:
            logits = logits + hb.to(x.dtype)
        return gather_vocab(logits, self.tp)

    @classmethod
    def from_seed(cls, config, seed: int, device=None, std: float = 0.02, tp_size=1,
                  tp_rank=0):
        """Random weights drawn on ``device`` (default ``"cuda"``, which
        raises without a GPU) from ``torch.Generator(seed)``: N(0, std) for
        every matrix and embedding, zeros for biases, ones for norm scales.
        With ``tp_size`` > 1 each split tensor is drawn whole and rank
        ``tp_rank``'s part kept."""
        return seeded(cls, config, seed, device, std, tp_size, tp_rank)


def seeded(cls, config, seed, device=None, std=0.02, tp_size=1, tp_rank=0):
    """``cls(config, tp_size=..., tp_rank=...)`` built on the meta device,
    then its weights drawn on ``device`` from ``torch.Generator(seed)`` in
    parameter order (``llama.draw_from_seed``): ones for norm scales (names
    ending ``norm.weight``), zeros for biases, N(0, std) for the rest, each
    split tensor drawn whole and the rank's part kept."""
    model = cls(config, device="meta", tp_size=tp_size, tp_rank=tp_rank)
    return draw_from_seed(model, seed, device, std, tp_parts(model))


def params_from_flax(tree, plan=None):
    """The JAX package's ``ParallelBlockForCausalLM`` param tree
    (``layers_{i}`` subtrees), as numpy arrays, -> a state dict for this
    ``ParallelBlockForCausalLM``. Kernels ``[in, out]`` are transposed into
    ``nn.Linear``'s ``[out, in]``; ``lm_head`` is ``[V, D]`` in both and
    ``lm_head_bias`` becomes ``lm_head.bias``. Values are copied as fp32;
    ``load_state_dict`` casts them to the module's dtype. With ``plan`` (a
    ``TPPlan``, ``model.plan``), its rank's parts."""
    sd = {"embed_tokens.weight": tree["embed_tokens"],
          "final_layernorm.weight": tree["final_layernorm"]["scale"],
          "final_layernorm.bias": tree["final_layernorm"]["bias"]}
    if "lm_head" in tree:
        sd["lm_head.weight"] = tree["lm_head"]
    if "lm_head_bias" in tree:
        sd["lm_head.bias"] = tree["lm_head_bias"]
    L = sum(1 for k in tree if k.startswith("layers_"))
    for i in range(L):
        lp, pre = tree[f"layers_{i}"], f"layers.{i}."
        for name, leaf in lp.items():
            if "scale" in leaf:
                sd[f"{pre}{name}.weight"] = leaf["scale"]
                sd[f"{pre}{name}.bias"] = leaf["bias"]
                continue
            sd[f"{pre}{name}.weight"] = np.asarray(leaf["kernel"]).T
            if "bias" in leaf:
                sd[f"{pre}{name}.bias"] = leaf["bias"]
    sd = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    return sd if plan is None else slice_state_dict(sd, plan)

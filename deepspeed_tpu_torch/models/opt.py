"""OPT model family (port of ``deepspeed_tpu/models/opt.py``).

Learned positional embeddings with OPT's +2 offset, biased projections, a
ReLU FFN, pre-LayerNorm sequential residuals, an untied final LayerNorm and
the head tied to the token embedding. ``OPTForCausalLM`` is an
``nn.Module`` whose ``forward(batch)`` is the JAX model's training forward
(LayerNorm in fp32, ``mha`` flash attention, the fused chunked CE head on
the tied embedding). Parameter names follow the HuggingFace layout under
``model.decoder`` (``layers.0.self_attn.q_proj.weight``, ...), linear
weights are ``nn.Linear``'s ``[out, in]``; the ragged serving forward
(``inference/v2/model_implementations/opt.py``) runs the same weights.
``params_from_flax`` converts the JAX package's scan-stacked tree. The
Of the ZeRO-Infinity streaming protocol it has ``streaming_plan`` (the
layers the overlap schedule prefetches); the rest waits for ROADMAP A14.

With ``tp_size`` > 1 (tensor-parallel serving, the JAX model's
``param_specs``, ``models/opt.py:212``) the module holds rank ``tp_rank``'s
share, cut by its ``TPPlan``: q/k/v and ``fc1`` by output columns with
their biases, ``out_proj`` and ``fc2`` by input rows (their biases whole,
added once after the reduce), the tied embedding by vocabulary (so the
logits are gathered), the learned positions whole. Such a module serves
through the ragged forward; its training forward is ROADMAP A12.
"""

import dataclasses
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.llama import set_tensor_parallel
from deepspeed_tpu_torch.models.losses import lm_head_next_token_loss
from deepspeed_tpu_torch.models.parallel_block import LayerNorm, seeded
from deepspeed_tpu_torch.ops.flash_attention import mha
from deepspeed_tpu_torch.parallel.tensor_parallel import (TensorParallel, TPPlan,
                                                          slice_state_dict, split_dim)
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    remat: bool = True
    dtype: torch.dtype = torch.bfloat16

    POSITION_OFFSET: ClassVar[int] = 2  # OPT reserves positions 0/1 (HF modeling_opt)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self):
        """OPT has no GQA: every query head has its own kv head."""
        return self.num_attention_heads

    @staticmethod
    def tiny(**kw):
        return OPTConfig(vocab_size=512, hidden_size=64, ffn_dim=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         max_position_embeddings=128, **kw)

    @staticmethod
    def opt_125m(**kw):
        return OPTConfig(**kw)

    @staticmethod
    def opt_1_3b(**kw):
        return OPTConfig(hidden_size=2048, ffn_dim=8192, num_hidden_layers=24,
                         num_attention_heads=32, **kw)

    @staticmethod
    def opt_13b(**kw):
        return OPTConfig(hidden_size=5120, ffn_dim=20480, num_hidden_layers=40,
                         num_attention_heads=40, **kw)

    @staticmethod
    def opt_30b(**kw):
        return OPTConfig(hidden_size=7168, ffn_dim=28672, num_hidden_layers=48,
                         num_attention_heads=56, **kw)


class OPTAttention(nn.Module):
    """Biased q/k/v/out projections of one tensor-parallel rank's heads
    (``plan``, a ``TPPlan``; all of them without one)."""

    def __init__(self, cfg, device=None, plan=None):
        super().__init__()
        D, W = cfg.hidden_size, (plan or TPPlan(cfg)).heads * cfg.head_dim
        kw = dict(bias=True, device=device, dtype=cfg.dtype)
        self.q_proj = nn.Linear(D, W, **kw)
        self.k_proj = nn.Linear(D, W, **kw)
        self.v_proj = nn.Linear(D, W, **kw)
        self.out_proj = nn.Linear(W, D, **kw)
        self.num_heads = W // cfg.head_dim
        self.config = cfg
        self.tp = TensorParallel()

    def forward(self, x, attention=mha):
        cfg = self.config
        B, T, D = x.shape
        H, Dh = self.num_heads, cfg.head_dim
        q = self.q_proj(x).view(B, T, H, Dh)
        k = self.k_proj(x).view(B, T, H, Dh)
        v = self.v_proj(x).view(B, T, H, Dh)
        return self.out_proj(attention(q, k, v, causal=True).reshape(B, T, D))


class OPTDecoderLayer(nn.Module):

    def __init__(self, cfg, device=None, plan=None):
        super().__init__()
        D, F = cfg.hidden_size, (plan or TPPlan(cfg)).ffn
        kw = dict(device=device, dtype=cfg.dtype)
        self.self_attn = OPTAttention(cfg, device, plan)
        self.self_attn_layer_norm = LayerNorm(D, cfg.layer_norm_epsilon, device)
        self.final_layer_norm = LayerNorm(D, cfg.layer_norm_epsilon, device)
        self.fc1 = nn.Linear(D, F, **kw)
        self.fc2 = nn.Linear(F, D, **kw)
        self.config = cfg

    def forward(self, x, attention=mha):
        x = x + self.self_attn(self.self_attn_layer_norm(x), attention)
        h = self.fc2(F.relu(self.fc1(self.final_layer_norm(x))))
        return x + F.dropout(h, self.config.dropout, self.training)


class OPTForCausalLM(nn.Module):
    """Weights of an OPT causal LM. LayerNorm scales and biases are fp32,
    every other weight is ``config.dtype``. The head is the token
    embedding. ``tp_size`` > 1 keeps rank ``tp_rank``'s share (module
    docstring)."""

    def __init__(self, config: OPTConfig, device=None, tp_size=1, tp_rank=0):
        super().__init__()
        self.config = config
        self.plan = plan = TPPlan(config, tp_size, tp_rank)
        kw = dict(device=device, dtype=config.dtype)
        self.embed_tokens = nn.Embedding(plan.vocab, config.hidden_size, **kw)
        self.embed_positions = nn.Embedding(
            config.max_position_embeddings + config.POSITION_OFFSET, config.hidden_size, **kw)
        self.layers = nn.ModuleList(OPTDecoderLayer(config, device, plan)
                                    for _ in range(config.num_hidden_layers))
        self.final_layer_norm = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                                          device)
        self.tp_size = tp_size
        self.set_tensor_parallel(TensorParallel(size=tp_size, rank=tp_rank,
                                                ranks=tuple(range(tp_size))))

    def set_tensor_parallel(self, tp):
        """The ``tp`` group the serving forward exchanges over (see
        ``LlamaForCausalLM.set_tensor_parallel``)."""
        set_tensor_parallel(self, tp)

    def param_specs(self):
        """``{name: split dimension or None}`` over ``tp``: the JAX model's
        ``param_specs`` (``models/opt.py:212``) in this module's layout
        (module docstring)."""
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

    def forward(self, batch, attention=mha):
        """The JAX model's ``__call__``: ``batch`` is a dict with
        ``input_ids`` [B, T] and optional ``labels`` [B, T], or the ids
        alone. Returns the next-token loss when there are labels, else the
        logits [B, T, V]. In training each layer runs under the configured
        activation-checkpointing policy (``config.remat``). ``attention``
        replaces ``mha`` (a plain version, for comparisons)."""
        if self.tp_size > 1:
            raise NotImplementedError(
                "the forward of a tensor-parallel OPT (training, tp axis) is not ported "
                "to deepspeed_tpu_torch yet: ROADMAP A12; it serves through the ragged "
                "engine")
        cfg = self.config
        if isinstance(batch, dict):
            input_ids, labels = batch["input_ids"], batch.get("labels")
        else:
            input_ids, labels = batch, None
        input_ids = input_ids.long()
        T = input_ids.shape[1]
        off = cfg.POSITION_OFFSET
        x = self.embed_tokens(input_ids) + self.embed_positions.weight[None, off:off + T]
        x = F.dropout(x, cfg.dropout, self.training)
        for layer in self.layers:
            if cfg.remat:
                x = checkpointing.checkpoint(layer, x, attention)
            else:
                x = layer(x, attention)
        x = self.final_layer_norm(x)
        if labels is None:
            return x @ self.embed_tokens.weight.to(x.dtype).T
        return lm_head_next_token_loss(x, self.embed_tokens.weight, labels)

    @classmethod
    def from_seed(cls, config, seed: int, device=None, std: float = 0.02, tp_size=1,
                  tp_rank=0):
        """Random weights drawn on ``device`` (default ``"cuda"``, which
        raises without a GPU) from ``torch.Generator(seed)``: N(0, std) for
        every matrix and embedding, zeros for biases, ones for norm scales.
        With ``tp_size`` > 1 each split tensor is drawn whole and rank
        ``tp_rank``'s part kept."""
        return seeded(cls, config, seed, device, std, tp_size, tp_rank)


def _take(tree, i):
    """Layer ``i`` of a scan-stacked subtree."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_flax(tree, plan=None):
    """The JAX package's ``OPTForCausalLM`` param tree (``scan_layers``:
    layers stacked under ``layers/block``; or ``layers_{i}`` subtrees), as
    numpy arrays, -> a state dict for this ``OPTForCausalLM``. Kernels
    ``[in, out]`` are transposed into ``nn.Linear``'s ``[out, in]``. Values
    are copied as fp32; ``load_state_dict`` casts them to the module's
    dtype. With ``plan`` (a ``TPPlan``, ``model.plan``), its rank's
    parts."""
    sd = {"embed_tokens.weight": tree["embed_tokens"],
          "embed_positions.weight": tree["embed_positions"],
          "final_layer_norm.weight": tree["final_layer_norm"]["scale"],
          "final_layer_norm.bias": tree["final_layer_norm"]["bias"]}
    if "layers" in tree:
        blk = tree["layers"]["block"]
        L = np.asarray(blk["fc1"]["bias"]).shape[0]
        layer = lambda i: _take(blk, i)
    else:
        L = sum(1 for k in tree if k.startswith("layers_"))
        layer = lambda i: tree[f"layers_{i}"]
    for i in range(L):
        lp, pre = layer(i), f"layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}self_attn.{n}.weight"] = np.asarray(lp["self_attn"][n]["kernel"]).T
            sd[f"{pre}self_attn.{n}.bias"] = lp["self_attn"][n]["bias"]
        for n in ("fc1", "fc2"):
            sd[f"{pre}{n}.weight"] = np.asarray(lp[n]["kernel"]).T
            sd[f"{pre}{n}.bias"] = lp[n]["bias"]
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{pre}{n}.weight"] = lp[n]["scale"]
            sd[f"{pre}{n}.bias"] = lp[n]["bias"]
    sd = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    return sd if plan is None else slice_state_dict(sd, plan)

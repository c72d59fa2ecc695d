"""Mixtral (sparse MoE) model family (port of ``deepspeed_tpu/models/mixtral.py``).

``MixtralConfig`` with its presets, and ``MixtralForCausalLM``: an
``nn.Module`` whose ``forward(batch)`` is the JAX model's training forward
(per layer ``x + attn(norm(x))`` then ``x + MOELayer(norm(x))``, under
activation checkpointing when ``config.remat``; the fused chunked CE head
plus ``router_aux_loss_coef`` times the layers' mean router aux loss) and
whose weights the ragged serving forward
(``inference/v2/model_implementations/mixtral.py``) also runs. Each layer is
the Llama backbone's attention (the port's ``LlamaAttention`` and
``RMSNorm``) with a top-k-of-E ``MOELayer`` (``deepspeed_tpu_torch/moe``)
dispatching by ``config.moe_backend``: ``block_sparse_moe.gate.wg`` is the
router weight [D, E], ``block_sparse_moe.experts.{w1, w3}`` [E, D, F] and
``block_sparse_moe.experts.w2`` [E, F, D] are the stacked expert kernels,
the same parameters under the same names for training and serving.
Router and experts keep the JAX layout (``x @ w``), so ``params_from_flax``
carries them across without a transpose; the attention projections are
``nn.Linear``'s ``[out, in]`` as in the port's Llama. With ``ep_size`` > 1
(expert parallelism) each layer holds rank ``ep_rank``'s contiguous slice
of the expert stacks, ``[E / ep_size, ...]`` (the JAX ``param_specs``'
``"ep"`` on the expert axis); ``from_seed`` and ``params_from_flax`` cut
the same slice from the whole stacks. With ``tp_size`` > 1
(tensor-parallel serving) rank ``tp_rank`` holds the attention's share of
the heads as the port's Llama does, the vocabulary slice of the embedding
and ``lm_head``, and its share of every expert's FFN width (``w1``/``w3``
[E, D, F'], ``w2`` [E, F', D]: the JAX ``param_specs``' ``"tp"``), all cut
by its ``TPPlan``; the router and the norms are replicated. The JAX package
serves no model with ``ep`` and ``tp`` together (its serving meshes have no
``ep`` axis beside ``tp``), so both at once belong to tensor-parallel
training (ROADMAP A12). The tensor-parallel
forward is the ragged serving forward's. Of the ZeRO-Infinity streaming
protocol it has ``streaming_plan`` (the layers the overlap schedule
prefetches); the rest waits for ROADMAP A14.
"""

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.llama import (LlamaAttention, LlamaConfig, RMSNorm,
                                              draw_from_seed, draw_parameter,
                                              set_tensor_parallel,
                                              tp_parts)
from deepspeed_tpu_torch.models.losses import lm_head_next_token_loss
from deepspeed_tpu_torch.moe.sharded_moe import MOELayer
from deepspeed_tpu_torch.moe.utils import expert_slice, moe_param_specs
from deepspeed_tpu_torch.ops.flash_attention import mha
from deepspeed_tpu_torch.ops.grouped_gemm import grouped_matmul
from deepspeed_tpu_torch.parallel.tensor_parallel import (TensorParallel, TPPlan,
                                                          slice_state_dict, split_dim)
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02
    capacity_factor: float = 2.0
    # training dispatch: "indices" (routed gather/scatter, default) |
    # "einsum" (GShard oracle) | "gmm" (grouped-GEMM kernels, capacity-free)
    moe_backend: str = "indices"
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6
    remat: bool = True
    dtype: torch.dtype = torch.bfloat16
    sliding_window: Any = None        # local-window attention
    head_dim: Any = None              # None derives hidden_size // num_attention_heads

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.hidden_size // self.num_attention_heads)

    @staticmethod
    def tiny(**kw):
        return MixtralConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                             num_hidden_layers=2, num_attention_heads=4,
                             num_key_value_heads=2, num_local_experts=4,
                             max_position_embeddings=128, **kw)

    @staticmethod
    def mixtral_8x7b(**kw):
        return MixtralConfig(**kw)

    def as_llama(self):
        return LlamaConfig(vocab_size=self.vocab_size, hidden_size=self.hidden_size,
                           intermediate_size=self.intermediate_size,
                           num_hidden_layers=self.num_hidden_layers,
                           num_attention_heads=self.num_attention_heads,
                           num_key_value_heads=self.num_key_value_heads,
                           max_position_embeddings=self.max_position_embeddings,
                           rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
                           sliding_window=self.sliding_window,
                           head_dim=self.head_dim, remat=self.remat,
                           dtype=self.dtype)

    def num_parameters(self):
        c = self
        qo = c.num_attention_heads * c.head_dim
        per_layer = (c.hidden_size * qo  # q
                     + 2 * c.hidden_size * c.num_key_value_heads * c.head_dim  # k,v
                     + qo * c.hidden_size  # o
                     + c.hidden_size * c.num_local_experts  # router
                     + 3 * c.num_local_experts * c.hidden_size
                     * c.intermediate_size  # w1, w3, w2
                     + 2 * c.hidden_size)  # norms
        return (c.vocab_size * c.hidden_size * 2  # embed + lm_head
                + c.num_hidden_layers * per_layer + c.hidden_size)


class MixtralExpertMLP(nn.Module):
    """One expert ``silu(x @ w1) * (x @ w3) @ w2`` with JAX-layout kernels
    w1/w3 [D, F] and w2 [F, D] in ``config.dtype``. ``GMM_COMPAT`` and
    ``gmm_shapes`` are the grouped-GEMM contract of ``MOELayer``'s "gmm"
    dispatch (kernels listed gate, up, down)."""

    GMM_COMPAT = ("w1", "w3", "w2")

    def __init__(self, cfg, device=None):
        super().__init__()
        self.config = cfg
        D, F = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=cfg.dtype)
        self.w1 = nn.Parameter(torch.empty(D, F, **kw))
        self.w3 = nn.Parameter(torch.empty(D, F, **kw))
        self.w2 = nn.Parameter(torch.empty(F, D, **kw))

    def gmm_shapes(self, d_model):
        f = self.config.intermediate_size
        return {"w1": (d_model, f), "w3": (d_model, f), "w2": (f, d_model)}

    def forward(self, x):
        dt = self.config.dtype
        x = x.to(dt)
        return (torch.nn.functional.silu(x @ self.w1.to(dt)) * (x @ self.w3.to(dt))) \
            @ self.w2.to(dt)


class MixtralDecoderLayer(nn.Module):

    def __init__(self, cfg, device=None, ep_size=1, plan=None):
        super().__init__()
        plan = plan or TPPlan(cfg)
        self.self_attn = LlamaAttention(cfg.as_llama(), device, plan)
        expert_cfg = dataclasses.replace(cfg, intermediate_size=plan.ffn)
        self.block_sparse_moe = MOELayer(
            lambda: MixtralExpertMLP(expert_cfg, device), cfg.num_local_experts,
            k=cfg.num_experts_per_tok, capacity_factor=cfg.capacity_factor,
            eval_capacity_factor=cfg.capacity_factor, dispatch_mode=cfg.moe_backend,
            model_dim=cfg.hidden_size, ep_size=ep_size, device=device,
            gate_dtype=cfg.dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, device)

    def forward(self, x, positions, attention=mha, matmul=grouped_matmul):
        """The JAX ``MixtralBlock``: returns (x, the layer's router aux loss)."""
        x = x + self.self_attn(self.input_layernorm(x), positions, attention)
        moe_out, l_aux, _ = self.block_sparse_moe(
            self.post_attention_layernorm(x), train=self.training, matmul=matmul)
        return x + moe_out, l_aux


class MixtralForCausalLM(nn.Module):
    """Weights of a Mixtral causal LM. Norm scales are fp32, every other
    weight is ``config.dtype`` (the JAX package casts to that dtype at each
    use; storing it cast gives the same values). ``ep_size`` > 1 keeps one
    expert-parallel rank's slice of each expert stack, ``tp_size`` > 1 one
    tensor-parallel rank's share of the weights (module docstring)."""

    def __init__(self, config: MixtralConfig, device=None, ep_size=1, tp_size=1,
                 tp_rank=0):
        super().__init__()
        if ep_size > 1 and tp_size > 1:
            raise NotImplementedError(
                "expert and tensor parallelism together are tensor-parallel training: "
                "the JAX package serves no model with both (its serving meshes are "
                "('tp',) and ('dp', 'tp')); not ported to deepspeed_tpu_torch yet, see "
                "ROADMAP.md queue A12")
        self.config = config
        self.ep_size = ep_size
        self.plan = plan = TPPlan(config, tp_size, tp_rank)
        kw = dict(device=device, dtype=config.dtype)
        self.embed_tokens = nn.Embedding(plan.vocab, config.hidden_size, **kw)
        self.layers = nn.ModuleList(MixtralDecoderLayer(config, device, ep_size, plan)
                                    for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)
        self.lm_head = nn.Linear(config.hidden_size, plan.vocab, bias=False, **kw)
        self.tp_size = tp_size
        self.set_tensor_parallel(TensorParallel(size=tp_size, rank=tp_rank,
                                                ranks=tuple(range(tp_size))))

    def set_tensor_parallel(self, tp):
        """The ``tp`` group the serving forward exchanges over (see
        ``LlamaForCausalLM.set_tensor_parallel``)."""
        set_tensor_parallel(self, tp)

    def param_specs(self):
        """``{name: split dimension or None}`` over ``tp``: the JAX model's
        ``param_specs`` (``models/mixtral.py:207``) in this module's layout.
        Attention as the port's Llama; expert ``w1``/``w3`` [E, D, F] split
        on dim 2 and ``w2`` [E, F, D] on dim 1; the embedding and
        ``lm_head`` over the vocabulary; the router and norms replicated."""
        return {name: split_dim(name) for name, _ in self.named_parameters()}

    def init_parameter(self, name, tensor, generator):
        """Draw parameter ``name`` in place by ``from_seed``'s law (what
        ``zero.Init`` materialises with; an expert leaf as its whole
        stack)."""
        draw_parameter(name, tensor, generator)

    def streaming_plan(self):
        """The streaming protocol (JAX ``streaming_plan``): the decoder
        layers, in order, are the blocks whose gathers the overlap schedule
        starts ahead of their use."""
        return {"num_blocks": len(self.layers)}

    def forward(self, batch, positions=None, attention=mha, matmul=grouped_matmul):
        """The JAX model's ``__call__``: ``batch`` is a dict with
        ``input_ids`` [B, T] and optional ``labels`` [B, T], or the ids
        alone. Returns the next-token loss plus ``router_aux_loss_coef``
        times the mean of the layers' router aux losses when there are
        labels, else the logits [B, T, V]. In training each decoder layer
        runs under the configured activation-checkpointing policy
        (``config.remat``). ``attention`` replaces ``mha`` and ``matmul``
        the grouped product of the "gmm" dispatch (plain versions, for
        comparisons). A tensor-parallel module serves through the ragged
        forward only: its training forward is ROADMAP A12."""
        if self.tp_size > 1:
            raise NotImplementedError(
                "the forward of a tensor-parallel Mixtral (training, tp axis) is not "
                "ported to deepspeed_tpu_torch yet: ROADMAP A12; it serves through "
                "the ragged engine")
        cfg = self.config
        if isinstance(batch, dict):
            input_ids, labels = batch["input_ids"], batch.get("labels")
        else:
            input_ids, labels = batch, None
        input_ids = input_ids.long()
        B, T = input_ids.shape
        x = self.embed_tokens(input_ids)
        if positions is None:
            positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
        total_aux = 0.0
        for layer in self.layers:
            if cfg.remat:
                x, l_aux = checkpointing.checkpoint(layer, x, positions, attention,
                                                    matmul)
            else:
                x, l_aux = layer(x, positions, attention, matmul)
            total_aux = total_aux + l_aux
        x = self.norm(x)
        if labels is None:
            return x @ self.lm_head.weight.to(x.dtype).T
        lm_loss = lm_head_next_token_loss(x, self.lm_head.weight, labels)
        return lm_loss + cfg.router_aux_loss_coef * total_aux / cfg.num_hidden_layers

    @classmethod
    def from_seed(cls, config: MixtralConfig, seed: int, device=None,
                  std: float = 0.02, ep_size=1, ep_rank=0, tp_size=1, tp_rank=0):
        """Random weights drawn on ``device`` (default ``"cuda"``, which
        raises without a GPU) from ``torch.Generator(seed)``: N(0, std) for
        every matrix, zeros for biases, ones for norm scales (the flax
        initializers' shapes; the draws differ from JAX's). With ``ep_size``
        (``tp_size``) > 1 each expert stack (split tensor) is drawn whole and
        rank ``ep_rank``'s (``tp_rank``'s) part kept, so every rank's
        weights are those of the one-rank model."""
        model = cls(config, device="meta", ep_size=ep_size, tp_size=tp_size,
                    tp_rank=tp_rank)
        if ep_size > 1:
            whole = dict(cls(config, device="meta").named_parameters())
            parts = {name: (whole[name].shape, functools.partial(
                expert_slice, ep_size=ep_size, ep_rank=ep_rank))
                for name, spec in moe_param_specs(model).items() if spec}
        else:
            parts = tp_parts(model)
        return draw_from_seed(model, seed, device, std, parts)


def params_from_flax(tree, ep_size=1, ep_rank=0, plan=None):
    """The JAX package's ``MixtralForCausalLM`` param tree (``layers_{i}``
    subtrees), as numpy arrays, -> a state dict for this
    ``MixtralForCausalLM``. Attention kernels ``[in, out]`` are transposed
    into ``nn.Linear``'s ``[out, in]``; the router ``wg`` [D, E] and the
    stacked experts ``MixtralExpertMLP_0/w{1,2,3}/kernel`` [E, in, out] keep
    their layout, cut to rank ``ep_rank``'s slice ``[E / ep_size, in, out]``
    for a model built with ``ep_size``, and to ``plan``'s rank's parts (a
    ``TPPlan``, ``model.plan``) for a model built with that plan. Values are copied
    as fp32; ``load_state_dict`` casts them to the module's dtype."""
    sd = {"embed_tokens.weight": tree["embed_tokens"],
          "lm_head.weight": tree["lm_head"],
          "norm.weight": tree["norm"]["scale"]}
    L = sum(1 for k in tree if k.startswith("layers_"))
    for i in range(L):
        lp, pre = tree[f"layers_{i}"], f"layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[pre + norm + ".weight"] = lp[norm]["scale"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            leaf = lp["self_attn"][n]
            sd[f"{pre}self_attn.{n}.weight"] = np.asarray(leaf["kernel"]).T
            if "bias" in leaf:
                sd[f"{pre}self_attn.{n}.bias"] = leaf["bias"]
        moe = lp["block_sparse_moe"]
        sd[pre + "block_sparse_moe.gate.wg"] = moe["gate"]["wg"]
        experts = moe["experts"]["MixtralExpertMLP_0"]
        for n in ("w1", "w2", "w3"):
            sd[f"{pre}block_sparse_moe.experts.{n}"] = expert_slice(
                np.asarray(experts[n]["kernel"]), ep_size, ep_rank)
    sd = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    return sd if plan is None else slice_state_dict(sd, plan)

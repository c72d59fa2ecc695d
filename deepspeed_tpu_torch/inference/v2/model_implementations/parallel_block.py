"""Ragged (paged-KV) forward for the parallel-residual families, Falcon and
Phi (port of ``deepspeed_tpu/inference/v2/model_implementations/
parallel_block.py``).

Runs the weights of ``deepspeed_tpu_torch.models.parallel_block.
ParallelBlockForCausalLM`` over a padded ``[S, Q]`` ragged batch: per layer
the shared input LayerNorm in fp32, the fused (Falcon) or split (Phi) q/k/v
projections, partial rotary, the in-place scatter of the new K/V into the
paged pools and the paged-attention call the Llama trunk makes, then
``x + dense(attn) + fc2(gelu(fc1(h)))``; the final LayerNorm and the tied
or biased head on each sequence's last real token. As in the JAX forward,
a ``dual_layernorm`` config's second norm is not read here.

Under tensor parallelism (a model built with ``tp_size`` > 1) each rank
runs its query heads over the KV heads it holds (Falcon-7B at tp 2: 36 or
35 heads on one KV head) and its FFN columns. The two row-split products,
``dense`` and ``fc2``, are summed on the rank and all-reduced once a layer
(one reduce where GSPMD's program has two), then both biases are added: at
bf16 the rank's two partial products round to bf16 before their sum and
the sum again before the reduce, where one rank's whole ``x + dense + fc2``
rounds each product once; the results are held like the Llama forward's
row reduces. The embedding is looked up from the vocabulary slices and the
head's logits slices (and its bias's) gathered, all over ``model.tp``.
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.model_implementations.llama import _scatter_kv
from deepspeed_tpu_torch.models.parallel_block import gelu, layer_norm, partial_rotary
from deepspeed_tpu_torch.ops.paged_attention import paged_mha
from deepspeed_tpu_torch.parallel.tensor_parallel import (gather_vocab, row_reduce,
                                                          vocab_embed)


def _layernorm(x, ln, eps):
    return layer_norm(x, ln.weight, ln.bias, eps)


@torch.no_grad()
def ragged_forward(model, kv_cache, tokens, q_len, seen, block_tables,
                   attention=paged_mha):
    """One ragged Falcon/Phi forward step over ``model`` (a
    ``ParallelBlockForCausalLM``): the arguments and the pools' in-place
    update are ``llama.ragged_forward``'s. Returns last-token logits [S, V]
    in fp32."""
    cfg, tp = model.config, model.tp
    S, Q = tokens.shape
    H = model.plan.heads
    positions = seen.long()[:, None] + torch.arange(Q, device=tokens.device)

    x = vocab_embed(model.embed_tokens.weight, tokens.long(), tp)   # [S, Q, D]
    for i, layer in enumerate(model.layers):
        h = _layernorm(x, layer.input_layernorm, cfg.layer_norm_eps)
        q, k, v = layer.qkv(h)
        q = partial_rotary(q, positions, cfg.rope_theta, cfg.rotary_dim)
        k = partial_rotary(k, positions, cfg.rope_theta, cfg.rotary_dim)
        kp, vp, ks, vs = kv_cache.layer(i)
        _scatter_kv(kp, vp, ks, vs, k, v, block_tables, seen, q_len)
        out = attention(q, kp, vp, block_tables, seen, q_len, k_scale=ks, v_scale=vs)
        act = gelu(F.linear(h, layer.fc1.weight, layer.fc1.bias), cfg.gelu_exact)
        out = out.reshape(S, Q, H * cfg.head_dim)
        if tp.size == 1:
            x = x + F.linear(out, layer.dense.weight, layer.dense.bias) \
                + F.linear(act, layer.fc2.weight, layer.fc2.bias)
            continue
        x = x + row_reduce(F.linear(out, layer.dense.weight)
                           + F.linear(act, layer.fc2.weight), tp)
        for b in (layer.dense.bias, layer.fc2.bias):
            if b is not None:
                x = x + b
    x = _layernorm(x, model.final_layernorm, cfg.layer_norm_eps)
    last = x[torch.arange(S, device=x.device), (q_len.long() - 1).clamp(min=0)]
    head, hb = model.head()
    return gather_vocab(F.linear(last, head, hb), tp).float()

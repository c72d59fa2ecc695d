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
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.model_implementations.llama import _scatter_kv
from deepspeed_tpu_torch.models.parallel_block import gelu, layer_norm, partial_rotary
from deepspeed_tpu_torch.ops.paged_attention import paged_mha


def _layernorm(x, ln, eps):
    return layer_norm(x, ln.weight, ln.bias, eps)


@torch.no_grad()
def ragged_forward(model, kv_cache, tokens, q_len, seen, block_tables,
                   attention=paged_mha):
    """One ragged Falcon/Phi forward step over ``model`` (a
    ``ParallelBlockForCausalLM``): the arguments and the pools' in-place
    update are ``llama.ragged_forward``'s. Returns last-token logits [S, V]
    in fp32."""
    cfg = model.config
    S, Q = tokens.shape
    H = cfg.num_attention_heads
    positions = seen.long()[:, None] + torch.arange(Q, device=tokens.device)

    x = model.embed_tokens.weight[tokens.long()]                 # [S, Q, D]
    for i, layer in enumerate(model.layers):
        h = _layernorm(x, layer.input_layernorm, cfg.layer_norm_eps)
        q, k, v = layer.qkv(h)
        q = partial_rotary(q, positions, cfg.rope_theta, cfg.rotary_dim)
        k = partial_rotary(k, positions, cfg.rope_theta, cfg.rotary_dim)
        kp, vp, ks, vs = kv_cache.layer(i)
        _scatter_kv(kp, vp, ks, vs, k, v, block_tables, seen, q_len)
        out = attention(q, kp, vp, block_tables, seen, q_len, k_scale=ks, v_scale=vs)
        attn_out = F.linear(out.reshape(S, Q, H * cfg.head_dim), layer.dense.weight,
                            layer.dense.bias)
        mlp_out = F.linear(gelu(F.linear(h, layer.fc1.weight, layer.fc1.bias),
                                cfg.gelu_exact), layer.fc2.weight, layer.fc2.bias)
        x = x + attn_out + mlp_out
    x = _layernorm(x, model.final_layernorm, cfg.layer_norm_eps)
    last = x[torch.arange(S, device=x.device), (q_len.long() - 1).clamp(min=0)]
    head, hb = model.head()
    return F.linear(last, head, hb).float()

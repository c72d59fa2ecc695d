"""Ragged (paged-KV) OPT forward (port of
``deepspeed_tpu/inference/v2/model_implementations/opt.py``).

Runs the weights of ``deepspeed_tpu_torch.models.opt.OPTForCausalLM`` over a
padded ``[S, Q]`` ragged batch: learned positional embeddings at ``seen +
qi + 2`` (no rotary), per layer the pre-LayerNorm biased q/k/v projections,
the in-place scatter of the new K/V into the paged pools and the
paged-attention call the Llama trunk makes, ``out_proj``, then the second
LayerNorm and the ReLU FFN; the final LayerNorm and the head tied to the
token embedding on each sequence's last real token.

Under tensor parallelism (a model built with ``tp_size`` > 1) each rank
runs its heads and FFN columns: the embedding is looked up from the
vocabulary slices (``vocab_embed``; the learned positions are whole),
``out_proj`` and ``fc2`` are all-reduced before their biases
(``row_linear``), and the tied head's logits slices are gathered
(``gather_vocab``), all over ``model.tp``.
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.model_implementations.llama import _scatter_kv
from deepspeed_tpu_torch.inference.v2.model_implementations.parallel_block import _layernorm
from deepspeed_tpu_torch.models.llama import row_linear
from deepspeed_tpu_torch.ops.paged_attention import paged_mha
from deepspeed_tpu_torch.parallel.tensor_parallel import gather_vocab, vocab_embed


@torch.no_grad()
def ragged_forward(model, kv_cache, tokens, q_len, seen, block_tables,
                   attention=paged_mha):
    """One ragged OPT forward step over ``model`` (an ``OPTForCausalLM``):
    the arguments and the pools' in-place update are
    ``llama.ragged_forward``'s. Returns last-token logits [S, V] in fp32."""
    cfg, tp = model.config, model.tp
    S, Q = tokens.shape
    H, Dh, eps = model.plan.heads, cfg.head_dim, cfg.layer_norm_epsilon
    positions = seen.long()[:, None] + torch.arange(Q, device=tokens.device)

    # padded token slots may run past the table; they clamp to its last
    # row, as the JAX gather clamps
    pos_emb = model.embed_positions.weight
    x = (vocab_embed(model.embed_tokens.weight, tokens.long(), tp)
         + pos_emb[(positions + cfg.POSITION_OFFSET).clamp(max=pos_emb.shape[0] - 1)])
    for i, layer in enumerate(model.layers):
        at = layer.self_attn
        h = _layernorm(x, layer.self_attn_layer_norm, eps)
        q = F.linear(h, at.q_proj.weight, at.q_proj.bias).view(S, Q, H, Dh)
        k = F.linear(h, at.k_proj.weight, at.k_proj.bias).view(S, Q, H, Dh)
        v = F.linear(h, at.v_proj.weight, at.v_proj.bias).view(S, Q, H, Dh)
        kp, vp, ks, vs = kv_cache.layer(i)
        _scatter_kv(kp, vp, ks, vs, k, v, block_tables, seen, q_len)
        out = attention(q, kp, vp, block_tables, seen, q_len, k_scale=ks, v_scale=vs)
        x = x + row_linear(out.reshape(S, Q, H * Dh), at.out_proj, tp)
        h = _layernorm(x, layer.final_layer_norm, eps)
        x = x + row_linear(F.relu(F.linear(h, layer.fc1.weight, layer.fc1.bias)),
                           layer.fc2, tp)
    x = _layernorm(x, model.final_layer_norm, cfg.layer_norm_epsilon)
    last = x[torch.arange(S, device=x.device), (q_len.long() - 1).clamp(min=0)]
    return gather_vocab(F.linear(last, model.embed_tokens.weight), tp).float()

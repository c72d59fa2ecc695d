"""Ragged (paged-KV) Mixtral forward (port of
``deepspeed_tpu/inference/v2/model_implementations/mixtral.py``).

Runs the weights of ``deepspeed_tpu_torch.models.mixtral.MixtralForCausalLM``
over a padded ``[S, Q]`` ragged batch. Attention is the Llama forward's
(RMSNorm, q/k/v projections, interleaved rotary, in-place scatter of the new
K/V into the paged pools, paged attention, o projection); the MLP is the
expert FFN: the top-k router, then the kernel route (``moe_ffn_gmm``:
scatter by expert, three grouped products, gather) or the GShard einsum
dispatch at lossless capacity ``C = T``, the JAX package's own oracle.
Padded ``[S, Q]`` token slots go through the router and the experts as in
the JAX forward, so the two agree row for row. Under tensor parallelism
each rank runs its heads as the Llama forward does and its share ``F / tp``
of every expert's width; the router, replicated, reads the all-reduced
hidden state, so every rank routes alike, and the expert FFN's output is
all-reduced once after ``w2``.
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.model_implementations.llama import attention_block
from deepspeed_tpu_torch.models.llama import rms_norm
from deepspeed_tpu_torch.ops.grouped_gemm import moe_ffn_gmm, topk_router
from deepspeed_tpu_torch.ops.paged_attention import paged_mha
from deepspeed_tpu_torch.parallel.tensor_parallel import (gather_vocab, row_reduce,
                                                          vocab_embed)


def moe_ffn_einsum(x, top_vals, top_idx, w1, w2, w3, *, n_experts, dtype):
    """GShard dense dispatch-combine over stacked expert weights with
    lossless capacity ``C = T`` (the JAX ``_moe_ffn`` einsum branch): a
    [T, E, C] dispatch tensor gathers tokens per expert, batched products
    run every expert over its C slots, the weighted transpose combines.
    O(T^2 E) memory; the oracle, and the plain version on any device."""
    T, D = x.shape
    E, k, C = n_experts, top_idx.shape[-1], T
    onehot = F.one_hot(top_idx, E).float()                       # [T, k, E]
    flat = onehot.reshape(T * k, E)
    pos = torch.cumsum(flat, 0) * flat - flat                    # [T*k, E]
    keep = (pos < C).float() * flat
    pos_oh = F.one_hot(pos.long(), C).float()                    # [T*k, E, C]
    disp = (keep[..., None] * pos_oh).reshape(T, k, E, C)
    dispatch = disp.sum(1)                                       # [T, E, C]
    combine = (disp * top_vals[..., None, None]).sum(1)
    xe = torch.einsum("tec,td->ecd", dispatch, x.float()).to(dtype)
    h = F.silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3)            # [E, C, F]
    out_e = torch.bmm(h, w2)                                     # [E, C, D]
    return torch.einsum("tec,ecd->td", combine, out_e.float()).to(dtype)


def _moe_ffn(x, gate_wg, w1, w2, w3, *, k, dtype, moe=moe_ffn_gmm, route=None):
    """Expert FFN over a flat token batch x [T, D] -> [T, D]: route with
    ``topk_router`` (or take ``route``, a (top_vals, top_idx) pair), then
    ``moe``: ``moe_ffn_gmm`` (the kernel route) or ``moe_ffn_einsum``.
    Returns (output, (top_vals, top_idx))."""
    top_vals, top_idx = route if route is not None else topk_router(x, gate_wg, k)
    out = moe(x, top_vals, top_idx, w1, w2, w3, n_experts=gate_wg.shape[1],
              dtype=dtype)
    return out, (top_vals, top_idx)


@torch.no_grad()
def ragged_forward(model, kv_cache, tokens, q_len, seen, block_tables,
                   attention=paged_mha, moe=moe_ffn_gmm, routes=None):
    """One ragged forward step over ``model`` (a ``MixtralForCausalLM``).

    ``tokens`` [S, Q], ``q_len``/``seen`` [S] and ``block_tables`` [S, MB]
    are int32 tensors on the model's device; ``kv_cache`` is the engine's
    ``BlockedKVCache``, whose pools this call updates in place.
    ``attention`` has ``paged_mha``'s signature, ``moe`` ``moe_ffn_gmm``'s:
    the kernels by default, or plain versions. ``routes``, for comparisons:
    an empty list collects each layer's (top_vals, top_idx); a list with
    one pair per layer makes each layer use its pair instead of routing.
    Returns last-token logits [S, V] in fp32."""
    cfg, tp = model.config, model.tp
    S, Q = tokens.shape
    positions = seen.long()[:, None] + torch.arange(Q, device=tokens.device)
    replay = bool(routes)

    x = vocab_embed(model.embed_tokens.weight, tokens.long(), tp)   # [S, Q, D]
    for i, layer in enumerate(model.layers):
        x = attention_block(layer, x, i, kv_cache, positions, block_tables, seen,
                            q_len, attention, tp)
        smoe = layer.block_sparse_moe
        h = rms_norm(x, layer.post_attention_layernorm.weight, cfg.rms_norm_eps)
        y, route = _moe_ffn(h.reshape(S * Q, -1), smoe.gate.wg,
                            smoe.experts.w1, smoe.experts.w2, smoe.experts.w3,
                            k=cfg.num_experts_per_tok, dtype=cfg.dtype, moe=moe,
                            route=routes[i] if replay else None)
        if routes is not None and not replay:
            routes.append(route)
        x = x + row_reduce(y.view(S, Q, -1), tp)
    x = rms_norm(x, model.norm.weight, cfg.rms_norm_eps)
    last = x[torch.arange(S, device=x.device), (q_len.long() - 1).clamp(min=0)]
    return gather_vocab(F.linear(last, model.lm_head.weight), tp).float()

"""Causal-LM losses (port of ``deepspeed_tpu/models/losses.py``).

``next_token_loss`` / ``cross_entropy`` take the logsumexp in fp32.
``fused_linear_cross_entropy`` computes the per-token loss of
softmax(x @ head.T) chunk by chunk over the vocabulary with an online
logsumexp, so the [N, V] logits never exist whole; it is an autograd
Function whose backward recomputes each chunk's logits. The chunk products
are ``torch.matmul`` (the JAX package leaves them to XLA), with the JAX
package's rounding points: chunk logits in x's dtype, widened to fp32; the
backward's products in fp32 with dx carried in fp32 across chunks and dW
rounded to the head's dtype once.
"""

import torch

FUSED_CE_MIN_VOCAB = 16384


def next_token_loss(logits, labels, ignore_index=None):
    """Predict labels[:, 1:] from logits[:, :-1]. logits [B, T, V], labels [B, T]."""
    return cross_entropy(logits[:, :-1], labels[:, 1:], ignore_index=ignore_index)


def _masked_mean(nll, targets, ignore_index):
    if ignore_index is None:
        return nll.mean()
    mask = (targets != ignore_index).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy(logits, targets, ignore_index=None):
    """Unshifted CE over the last axis."""
    targets = targets.long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    # an ignored target may be out of range; any valid index does
    idx = targets.clamp(0, logits.shape[-1] - 1) if ignore_index is not None else targets
    tgt = torch.gather(logits, -1, idx[..., None])[..., 0]
    return _masked_mean(lse - tgt.float(), targets, ignore_index)


class _FusedLinearCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, head, labels, chunk):
        N = x.shape[0]
        V = head.shape[0]
        m = torch.full((N,), float("-inf"), dtype=torch.float32, device=x.device)
        l = torch.zeros(N, dtype=torch.float32, device=x.device)
        tgt = torch.zeros(N, dtype=torch.float32, device=x.device)
        for start in range(0, V, chunk):
            logits = (x @ head[start:start + chunk].T).float()   # [N, <=chunk]
            m_new = torch.maximum(m, logits.amax(-1))
            l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
            rel = labels - start
            in_chunk = (rel >= 0) & (rel < logits.shape[1])
            got = torch.gather(logits, 1, rel.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
            tgt = tgt + torch.where(in_chunk, got, 0.0)
        lse = m + torch.log(l)
        ctx.save_for_backward(x, head, labels, lse)
        ctx.chunk = chunk
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x, head, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        g32 = g.float()
        x32 = x.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty_like(head)
        rows = torch.arange(x.shape[0], device=x.device)
        for start in range(0, head.shape[0], chunk):
            w = head[start:start + chunk]
            dl = torch.exp((x @ w.T).float() - lse[:, None])       # softmax chunk
            rel = labels - start
            in_chunk = (rel >= 0) & (rel < w.shape[0])
            # p - onehot, by integer indices (a boolean index would read its
            # count back to the host); rows outside the chunk subtract 0
            dl[rows, rel.clamp(0, w.shape[0] - 1)] -= in_chunk.to(dl.dtype)
            dl *= g32[:, None]
            dx += dl @ w.float()
            dw[start:start + chunk] = (dl.T @ x32).to(head.dtype)
        return dx.to(x.dtype), dw, None, None


def fused_linear_cross_entropy(x, head, labels, chunk=8192):
    """Per-token nll [N] (fp32) of softmax(x @ head.T) without materializing
    the logits. x [N, D]; head [V, D]; labels [N] int."""
    return _FusedLinearCrossEntropy.apply(x, head, labels.long(), int(chunk))


def lm_head_next_token_loss(x, head, labels, ignore_index=None, chunk=8192):
    """Causal-LM loss from hidden states x [B, T, D] and lm_head weights
    [V, D]: the fused chunked path for vocabularies of at least
    ``FUSED_CE_MIN_VOCAB``, the plain product below."""
    D = x.shape[-1]
    V = head.shape[0]
    if V < FUSED_CE_MIN_VOCAB:
        logits = x @ head.to(x.dtype).T
        return next_token_loss(logits, labels, ignore_index=ignore_index)
    xs = x[:, :-1].reshape(-1, D)
    ys = labels[:, 1:].reshape(-1).long()
    nll = fused_linear_cross_entropy(xs, head.to(x.dtype), ys, chunk)
    return _masked_mean(nll, ys, ignore_index)

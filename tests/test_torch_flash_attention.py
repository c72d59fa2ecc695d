"""The port's flash attention (``deepspeed_tpu_torch/ops/flash_attention.py``)
against the JAX package's Pallas ``flash_mha`` run in interpret mode, as
``tests/test_pallas_flash_attention.py`` runs it.

On CPU tensors the three kernel wrappers run their plain PyTorch versions,
so these cases hold the plain versions — the oracles the CUDA kernels are
compared with on the card (``tests/test_torch_gpu_kernels.py``,
``chip_smoke.py``) — to the TPU kernels' forward (out and lse) and to
``jax.vjp`` through their custom VJP (dq, dk, dv): causal, GQA, a sliding
window, segment ids, an additive bias, rectangular Tq < Tk, and a length
that is not a multiple of 128 (the JAX ``mha`` pads it; the port's kernels
mask the ragged edge themselves).

Tolerance: inputs are fp32 and both sides compute in fp32, differing only in
summation order (tiles of 128 online vs one dense softmax), so 2e-5
absolute on values of magnitude ~1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.flash_attention import _pad_seq_to_lanes
from deepspeed_tpu.ops.pallas.flash_attention import flash_mha as jax_flash_mha
from deepspeed_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5

CASES = {
    "causal": dict(),
    "gqa": dict(H=4, KV=2),
    "window": dict(window=40),
    "segments": dict(segments=True),
    "bias": dict(bias=True, causal=False),
    "rect": dict(Tq=128, Tk=256),
    "padded": dict(Tq=100, Tk=100, H=2, KV=1),
}


def make_case(B=1, Tq=128, Tk=128, H=2, KV=2, Dh=32, segments=False,
              bias=False, seed=0):
    rng = np.random.default_rng(seed)
    x = dict(q=rng.standard_normal((B, Tq, H, Dh)),
             k=rng.standard_normal((B, Tk, KV, Dh)),
             v=rng.standard_normal((B, Tk, KV, Dh)),
             g=rng.standard_normal((B, Tq, H, Dh)))
    x = {n: a.astype(np.float32) for n, a in x.items()}
    if bias:
        x["bias"] = rng.standard_normal((1, H, Tq, Tk)).astype(np.float32)
    if segments:
        x["seg"] = np.sort(rng.integers(0, 3, (B, Tq)), axis=1).astype(np.int32)
    return x


def run_jax(x, causal=True, window=None):
    """(out, dq, dk, dv) through the Pallas kernels in interpret mode; a
    length that is not a multiple of 128 is padded the way the JAX ``mha``
    pads it for its kernel."""
    seg = None if "seg" not in x else (jnp.asarray(x["seg"]),) * 2
    bias = None if "bias" not in x else jnp.asarray(x["bias"])
    T = x["q"].shape[1]

    def f(q, k, v):
        qp, kp, vp, bp, sp, _ = (q, k, v, bias, seg, T)
        if T % 128:
            qp, kp, vp, bp, sp, _ = _pad_seq_to_lanes(q, k, v, bias, seg, causal)
        out = jax_flash_mha(qp, kp, vp, bias=bp, causal=causal, window=window,
                            segment_ids=sp, interpret=True)
        return out[:, :T]

    out, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in "qkv"))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(x["g"])))]


def run_port(x, causal=True, window=None):
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    leaves = [t[n].clone().requires_grad_() for n in "qkv"]
    seg = None if "seg" not in t else (t["seg"], t["seg"])
    out = fa.mha(*leaves, bias=t.get("bias"), causal=causal, window=window,
                 segment_ids=seg)
    out.backward(t["g"])
    return [out.detach().numpy()] + [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_match_pallas_kernels(name):
    spec = dict(CASES[name])
    causal = spec.pop("causal", True)
    window = spec.pop("window", None)
    x = make_case(**spec)
    want = run_jax(x, causal, window)
    got = run_port(x, causal, window)
    for label, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=label)


def test_forward_lse_matches_pallas_kernel():
    """The forward's second output: lse = m + log(l) per (b, h, q) row."""
    from deepspeed_tpu.ops.pallas.flash_attention import _fwd
    x = make_case(H=4, KV=2)
    _, lse = _fwd(*(jnp.asarray(x[n]) for n in "qkv"), None, None, True,
                  32 ** -0.5, None, True)
    _, got = fa.flash_mha_fwd(*(torch.from_numpy(x[n]) for n in "qkv"))
    np.testing.assert_allclose(got.numpy(), np.asarray(lse), atol=ATOL, rtol=0)


def test_autograd_function_matches_dense_autograd():
    """flash_mha's Function (plain forward, dq, dk/dv) against autograd
    through the dense ``mha_reference``, with segments and a window."""
    x = make_case(B=2, Tq=96, Tk=96, H=4, KV=2, Dh=16, segments=True)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    grads = []
    for fn in (fa.mha, fa.mha_reference):
        leaves = [t[n].clone().requires_grad_() for n in "qkv"]
        out = fn(*leaves, causal=True, window=50,
                 segment_ids=(t["seg"], t["seg"]))
        out.backward(t["g"])
        grads.append([out.detach()] + [leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    x = make_case()
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    fa.reset_launch_counts()
    fa.mha(q, k, v)
    assert fa.flash_mha_fwd.launches == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fa.flash_mha_fwd(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("kw,window,match", [
    (dict(Dh=320), None, "head dim"),
    (dict(H=3, KV=2), None, "multiple"),
    (dict(), 0, "window"),
])
def test_unsupported_shapes_raise(kw, window, match):
    x = make_case(**kw)
    with pytest.raises(ValueError, match=match):
        fa.mha(*(torch.from_numpy(x[n]) for n in "qkv"), window=window)


def online_softmax_forward(s_all, v, block_k):
    """One head, causal, written tile by tile as the TPU kernel runs, from
    the fp32 logits ``s_all`` [T, T]: m the running maximum, alpha =
    exp(m_prev - m_cur) every tile, p = exp(s - m_cur) summed into l
    unrounded and rounded to bf16 before p.v. numpy fp32; exp and the bf16
    rounding through torch, so that p is the plain version's wherever the
    tiles agree. -> (out fp32, lse, sum_j p_j |v_j| / l: the output's
    magnitude without cancellation)."""
    T = s_all.shape[0]
    s_all = np.where(np.arange(T)[None, :] <= np.arange(T)[:, None], s_all,
                     np.float32(fa.NEG_INF)).astype(np.float32)
    exp = lambda x: torch.from_numpy(x).exp().numpy()
    m = np.full(T, fa.NEG_INF, np.float32)
    l = np.zeros(T, np.float32)
    acc = np.zeros((T, v.shape[1]), np.float32)
    acc_abs = np.zeros_like(acc)
    for t0 in range(0, T, block_k):
        s = s_all[:, t0:t0 + block_k]
        m_cur = np.maximum(m, s.max(1))
        alpha = exp(m - m_cur)
        p = exp(s - m_cur[:, None])
        l = alpha * l + p.sum(1)
        p16 = torch.from_numpy(p).to(torch.bfloat16).float().numpy()
        acc = acc * alpha[:, None] + p16 @ v[t0:t0 + block_k]
        acc_abs = acc_abs * alpha[:, None] + p16 @ np.abs(v[t0:t0 + block_k])
        m = m_cur
    l_safe = np.where(l == 0, 1, l)[:, None]
    return acc / l_safe, m + np.log(np.maximum(l, 1e-30)), acc_abs / l_safe


@pytest.mark.parametrize("dh", sorted({w for dt, w in fa.FWD_BLOCK_K
                                       if dt == torch.bfloat16}))
def test_plain_bf16_forward_rounds_p_on_the_kernel_tiles(dh):
    """The plain bf16 forward rounds p against the running maximum of the
    kernel's key tiles (``fwd_block_k``: 128 keys up to head width 128, 64
    at 256): it equals the tile-by-tile loop above at that tile width to one
    bf16 rounding of the output (2^-7 of each element, plus 2^-16 of its
    magnitude without cancellation for the fp32 summation order of elements
    near 0; the loop takes the plain version's logits, so that only the
    rounding points are compared). Keys grow along the sequence, so the
    running maximum moves from tile to tile: at another tile width the
    loop reads 20-90x this bound. lse, fp32, to 1e-5."""
    T, H = 300, 2
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((3, 1, T, H, dh)).astype(np.float32)
    x[1] *= np.linspace(0.2, 2.5, T, dtype=np.float32)[None, :, None, None]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in x)
    out, lse = fa.flash_mha_fwd_reference(q, k, v, causal=True)
    logits = (torch.einsum("qhd,khd->hqk", q[0].float(), k[0].float())
              * dh ** -0.5).numpy()
    block_k = fa.fwd_block_k(torch.bfloat16, dh)
    for h in range(H):
        want, want_lse, magnitude = online_softmax_forward(
            logits[h], v[0, :, h].float().numpy(), block_k)
        got = out[0, :, h].float().numpy()
        np.testing.assert_array_less(np.abs(got - want),
                                     2 ** -7 * np.abs(want) + 2 ** -16 * magnitude)
        np.testing.assert_allclose(lse[0, h].numpy(), want_lse, atol=1e-5, rtol=0)

"""Where the flash kernels round p and ds: the checks' helpers, shared by
``tests/test_torch_gpu_kernels.py`` and ``chip_smoke.py``.

The forward rounds p = exp(s - m) to v's dtype against the running maximum m
of its key tiles, and dq rounds ds = p (dp - delta) scale to k's dtype
(``ops/flash_attention.py``); dk/dv rounds neither: its tensor-core kernel
splits p and ds into a 16-bit hi and lo part and multiplies both. Three
helpers hold the kernels to those rounding points:

- ``flip_slack`` bounds what the tensor-core kernels may differ from the
  plain versions on random data: they sum q.k and dO.v in another order, so
  a p or ds lying close enough to a rounding boundary may round the other
  way. Every other p and ds must round as the plain version rounds it.
- ``fwd_probe`` and ``dq_probe`` build inputs on which every logit and every
  product is exact in any summation order and the output cancels (to the
  fp32 rounding of a rescale) unless p (ds) rounds exactly where the plain
  version rounds it;
  ``fwd_rounding_faults`` and ``dq_rounding_faults`` are the plain versions
  with the rounding moved, which such a probe must reject.
- ``dkv_probe`` builds inputs on which dV and dK are exact multiples of
  2^-12 that cancel to 0 if p or ds is rounded once to the input dtype;
  ``dkv_rounding_faults`` are the plain dk/dv with p or ds rounded once
  (the single-pass products of a tensor-core port without the split), and
  ``dkv_split_product`` is the plain dk/dv with the kernel's split products.

The block-sparse forward rounds p to v's dtype against the running maximum
after each whole layout block; ``sparse_flip_slack``, ``sparse_probe`` and
``sparse_rounding_faults`` are its counterparts of the forward's helpers.

Paged attention's tensor-core kernel rounds p to v's dtype before P.V, as
the TPU kernel does (``paged_mha_kernel_form``), against the running maximum
of its 64-key tiles and of its key split, where the TPU kernel takes its
pages in order; ``paged_flip_slack``, ``paged_probe`` and
``paged_rounding_faults`` hold it there.

Imports torch and the port only, not JAX.
"""

import math
from unittest import mock

import torch

from deepspeed_tpu_torch.ops import flash_attention as fa

U32 = 2.0 ** -24   # unit roundoff of fp32


def spacing(x, dtype):
    """One spacing of ``dtype`` at |x|: eps 2^floor(log2 |x|), at least the
    subnormal spacing."""
    fi = torch.finfo(dtype)
    return torch.clamp(fi.eps * torch.exp2(torch.floor(torch.log2(x.abs()))),
                       min=fi.smallest_normal * fi.eps)


def boundary_slack(x, dtype, tol):
    """One spacing of ``dtype`` at x where x, changed by at most ``tol``,
    could round to another value of ``dtype``; else 0."""
    r = x.to(dtype).float()
    a, ra = x.abs(), r.abs()
    step = spacing(ra, dtype)
    below = torch.where(torch.frexp(ra).mantissa == 0.5, step / 4, step / 2)
    dist = torch.minimum(a - (ra - below), ra + step / 2 - a)
    return torch.where(dist <= tol, step, 0.0)


def flip_slack(q, k, v, dout, lse, delta, bias=None, segment_ids=None,
               causal=True, softmax_scale=None, window=None):
    """(forward, dq), fp32 [B, Tq, H, Dh]: how far the tensor-core kernels'
    out and dq may lie from the plain versions' because a rounding of p or
    ds went the other way.

    A logit of the kernel differs from the plain one by at most
    3 Dh u scale sum_d |q_d k_d| + 4 u |s| (u = 2^-24: a recursive fp32 sum
    errs by at most Dh u times its terms' magnitudes, a truncating
    tensor-core sum by twice that; the rest is the scale and the bias), dP
    likewise by 3 Dh u sum_d |dO_d v_d|, and the kernel's exp by 2^-21 plus
    4 u |x| of its argument. A p (forward: also the tile maximum's logit) or
    ds whose plain fp32 value lies that close to a rounding boundary of the
    working dtype may round the other way; one spacing of it moves the
    output by at most spacing * |v_jd| / l_i (dq: spacing * |k_jd|). Every
    other p and ds must round exactly as in the plain version."""
    B, Tq, H, Dh = q.shape
    Tk, rep = k.shape[1], H // k.shape[2]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    bk = fa.fwd_block_k(q.dtype, Dh)
    n = -(-Tk // bk)
    fwd = torch.empty(q.shape, device=q.device)
    dq = torch.empty(q.shape, device=q.device)
    for b in range(B):
        s = fa._masked_logits(q, k, b, bias, causal, scale, window, segment_ids)
        qf, do = q[b].float(), dout[b].float()
        kf = k[b].float().repeat_interleave(rep, dim=1)
        vf = v[b].float().repeat_interleave(rep, dim=1)
        qk = torch.einsum("qhd,khd->hqk", qf.abs(), kf.abs())
        tol_s = torch.where(s > fa.NEG_INF / 2,
                            3 * Dh * U32 * scale * qk + 4 * U32 * s.abs(), 0.0)
        del qk
        # forward: p = exp(s - m_t), m_t the running maximum of the key tiles
        tiles = torch.nn.functional.pad(s, (0, n * bk - Tk), value=float("-inf"))
        running = torch.clamp(torch.cummax(tiles.view(H, Tq, n, bk).amax(-1), -1).values,
                              min=fa.NEG_INF)
        del tiles
        m_t = running.repeat_interleave(bk, dim=-1)[..., :Tk]
        rescale = torch.exp(m_t - running[..., -1:])
        p = torch.exp(s - m_t)
        l = (p * rescale).sum(-1, keepdim=True)
        rel = (tol_s + tol_s.amax(-1, keepdim=True) + 2.0 ** -21
               + 4 * U32 * (s - m_t).abs())
        w = boundary_slack(p, v.dtype, p * rel) * rescale / torch.where(l == 0, 1.0, l)
        fwd[b] = torch.einsum("hqk,khd->qhd", w, vf.abs())
        del m_t, rescale, rel, w
        # dq: ds = p (dp - delta) scale, p = exp(s - lse), dp = dO.v
        p = torch.exp(s - lse[b][..., None])
        ds = p * (torch.einsum("qhd,khd->hqk", do, vf) - delta[b][..., None]) * scale
        tol = (ds.abs() * (tol_s + 2.0 ** -21 + 8 * U32 * (s.abs() + lse[b][..., None].abs()))
               + p * scale * 3 * Dh * U32 * torch.einsum("qhd,khd->hqk", do.abs(), vf.abs()))
        dq[b] = torch.einsum("hqk,khd->qhd", boundary_slack(ds, k.dtype, tol), kf.abs())
    return fwd, dq


# ---------------------------------------------------------------------------
# rounding-point probes
# ---------------------------------------------------------------------------

PROBE_TQ, PROBE_TK, PROBE_H = 64, 256, 2
PROBE_STEP = 0.375   # the second 64-key tile's maximum logit over the first's
PROBE_V = 2.0 ** -8  # v (dq: k) in every 8th column: an output that does not cancel


def _fraction(x, dtype):
    """Where positive fp32 x lies between its two neighbours in ``dtype``,
    0 at the lower, 1 at the upper: above 0.5 it rounds up."""
    r = x.to(dtype)
    bits = r.view(torch.int16).int()
    lo = torch.where(r.float() > x, bits - 1, bits)
    lo_v, hi_v = (t.short().view(dtype).float() for t in (lo, lo + 1))
    return (x - lo_v) / (hi_v - lo_v)


def _up_and_down(x, cands, dtype):
    """The candidates whose x rounds up, and those whose x rounds down, each
    at least a tenth of a spacing from the midpoint and from the values."""
    f = _fraction(x, dtype)
    return cands[(f > 0.6) & (f < 0.9)], cands[(f > 0.1) & (f < 0.4)]


def _probe_keys(dtype, dh, tile_max, seed):
    """(c, v) of PROBE_TK probe keys: logits c and values v [PROBE_TK, dh]
    (see ``fwd_probe``), p rounded against ``tile_max`` (PROBE_STEP where the
    kernel's rounding tile spans keys 0-127, 0 where it spans 0-63)."""
    gen = torch.Generator().manual_seed(seed)
    other_max = PROBE_STEP - tile_max
    eps = torch.finfo(dtype).eps
    rnd = lambda x: x.to(dtype).float()
    cands = torch.unique(torch.linspace(-4, -0.25, 4096).to(dtype)).float()
    up, down = _up_and_down(torch.exp(cands - tile_max), cands, dtype)
    c, v = torch.full((PROBE_TK,), -8.0), torch.zeros(PROBE_TK, dh)
    c[0], c[64] = 0.0, PROBE_STEP
    j = 1
    while j < 63:
        a = up[torch.randint(len(up), (1,), generator=gen)]
        b = down[torch.randint(len(down), (1,), generator=gen)]
        pa, pb = rnd(torch.exp(a - tile_max)), rnd(torch.exp(b - tile_max))
        moved = (rnd(torch.exp(a - other_max)) * pb - rnd(torch.exp(b - other_max)) * pa
                 ) * math.exp(other_max - tile_max)
        if moved < -0.25 * eps * pa * pb:   # rounding on the other tile moves it
            c[j], c[j + 1] = a, b
            v[j], v[j + 1] = pb, -pa
            j += 2
    v[:, ::8] = PROBE_V
    return c, v


def fwd_probe(dtype, dh, device, seed=0):
    """((q, k, v), kwargs) on which out cancels in all but every 8th column
    unless p rounds where the plain forward rounds it.

    scale 1, q = e_0, k_j = c_j e_0, so s_j = c_j exactly. Key 0 has c = 0,
    key 64 c = PROBE_STEP, keys 1-62 pairs (a, b): with p rounded against
    the maximum of the forward's key tile (fwd_block_k: 128 keys see
    PROBE_STEP, 64 keys see 0) p_a rounds up and p_b down, and v_a = p_b,
    v_b = -p_a (rounded), so each pair adds exactly 0, in any order (up to
    the fp32 rescale by exp(m_t - m) where the tile is 64 keys); left
    unrounded, or rounded against the other tile's maximum, every pair adds
    a term of the same sign. The other keys have c = -8 and v = 0 there."""
    tile_max = PROBE_STEP if fa.fwd_block_k(dtype, dh) == 128 else 0.0
    c, v = _probe_keys(dtype, dh, tile_max, seed)
    q = torch.zeros(1, PROBE_TQ, PROBE_H, dh)
    q[..., 0] = 1
    k = torch.zeros(1, PROBE_TK, 1, dh)
    k[0, :, 0, 0] = c
    v = v[None, :, None]
    return (tuple(t.to(dtype).to(device) for t in (q, k, v)),
            dict(causal=False, softmax_scale=1.0))


def dq_probe(dtype, dh, device, seed=0):
    """((q, k, v, dO, lse, delta), kwargs) on which dq cancels to 0 in
    column 1 unless ds rounds where the plain dq rounds it.

    scale 1, q = e_0, k_j = w_j e_1 + PROBE_V e_2, so s_j = 0 exactly;
    lse = 0.5 and delta = 0, so p = exp(-0.5); v_j = r_j e_0 and dO = e_0,
    so dp_j = r_j exactly and ds_j = p r_j. Pairs of keys (a, b): ds_a
    rounds up and ds_b down, and w_a = ds_b, w_b = -ds_a (rounded), so each
    pair adds exactly 0 to dq's column 1; left unrounded, every pair adds a
    term of the same sign."""
    gen = torch.Generator().manual_seed(seed)
    lse_value = 0.5
    p = torch.exp(torch.tensor(-lse_value))
    rnd = lambda x: x.to(dtype).float()
    cands = torch.unique(torch.linspace(0.5, 2.0, 4096).to(dtype)).float()
    up, down = _up_and_down(p * cands, cands, dtype)
    r, w = torch.zeros(PROBE_TK), torch.zeros(PROBE_TK)
    for j in range(0, PROBE_TK, 2):
        a = up[torch.randint(len(up), (1,), generator=gen)]
        b = down[torch.randint(len(down), (1,), generator=gen)]
        r[j], r[j + 1] = a, b
        w[j], w[j + 1] = rnd(p * b), -rnd(p * a)
    q = torch.zeros(1, PROBE_TQ, PROBE_H, dh)
    q[..., 0] = 1
    k = torch.zeros(1, PROBE_TK, 1, dh)
    k[0, :, 0, 1] = w
    k[..., 2] = PROBE_V
    v = torch.zeros(1, PROBE_TK, 1, dh)
    v[0, :, 0, 0] = r
    dout = torch.zeros(1, PROBE_TQ, PROBE_H, dh)
    dout[..., 0] = 1
    lse = torch.full((1, PROBE_H, PROBE_TQ), lse_value, device=device)
    delta = torch.zeros(1, PROBE_H, PROBE_TQ, device=device)
    return (tuple(t.to(dtype).to(device) for t in (q, k, v, dout)) + (lse, delta),
            dict(causal=False, softmax_scale=1.0))


def fwd_rounding_faults(q, k, v, **kw):
    """{fault: out} of the plain forward with p rounded elsewhere: not at all
    (v read as fp32), or against the running maximum of the other tile
    width (64 keys where the kernel takes 128, 128 where it takes 64)."""
    dh = q.shape[-1]
    other = 64 if fa.fwd_block_k(q.dtype, dh) == 128 else 128
    unrounded = fa.flash_mha_fwd_reference(q, k, v.float(), **kw)[0]
    with mock.patch.dict(fa.FWD_BLOCK_K, {(q.dtype, fa.staged_width(dh)): other}):
        tiles = fa.flash_mha_fwd_reference(q, k, v, **kw)[0]
    return {"p_unrounded": unrounded, f"p_on_{other}_key_tiles": tiles}


def dq_rounding_faults(q, k, v, dout, lse, delta, **kw):
    """{fault: dq} of the plain dq with ds left unrounded (k read as fp32)."""
    return {"ds_unrounded": fa.flash_mha_bwd_dq_reference(q, k.float(), v, dout,
                                                          lse, delta, **kw)}


DKV_STEP = 2.0 ** -12   # exp(DKV_STEP) is 1 + DKV_STEP exactly in fp32


def dkv_probe(dtype, dh, device):
    """((q, k, v, dO, lse, delta), kwargs) on which dV's column 0 and dK's
    column 1 are -(H / KV) * PROBE_TQ / 4 * 2^-12 exactly, and 0 if p (dV) or
    ds (dK) is rounded once to ``dtype``.

    scale 1 and k = v = 0, so s = 0 and dp = 0 for every (query, key): p =
    exp(-lse) and ds = -p delta, the same for every key. The query rows come
    in groups of four:
      - a p pair: lse 0 and -2^-12, so p = 1 and exp(2^-12) = 1 + 2^-12 (in
        fp32 exactly: the series' next term, 2^-25, is under half a
        spacing); dO = +e_0 and -e_0; q = 0 and delta = 0, so ds = 0. Each
        pair adds 1 - (1 + 2^-12) to dV[:, 0] and nothing to dK.
      - a ds pair: lse 0 (p = 1), dO = 0, delta = -1 and -(1 + 2^-12), so
        ds = 1 and 1 + 2^-12; q = +e_1 and -e_1. Each pair adds
        1 - (1 + 2^-12) to dK[:, 1] and nothing to dV.
    1 + 2^-12 rounds to 1 in bf16 and fp16, so a product that takes p or ds
    rounded once cancels each pair to 0; the split into hi = 1 and
    lo = 2^-12 carries it exactly, and every sum is of powers of two."""
    q = torch.zeros(1, PROBE_TQ, PROBE_H, dh)
    dout = torch.zeros(1, PROBE_TQ, PROBE_H, dh)
    lse = torch.zeros(1, PROBE_H, PROBE_TQ)
    delta = torch.zeros(1, PROBE_H, PROBE_TQ)
    for r in range(0, PROBE_TQ, 4):
        lse[0, :, r + 1] = -DKV_STEP
        dout[0, r, :, 0], dout[0, r + 1, :, 0] = 1.0, -1.0
        delta[0, :, r + 2], delta[0, :, r + 3] = -1.0, -(1.0 + DKV_STEP)
        q[0, r + 2, :, 1], q[0, r + 3, :, 1] = 1.0, -1.0
    k = torch.zeros(1, PROBE_TK, 1, dh)
    v = torch.zeros(1, PROBE_TK, 1, dh)
    return (tuple(t.to(dtype).to(device) for t in (q, k, v, dout))
            + (lse.to(device), delta.to(device)),
            dict(causal=False, softmax_scale=1.0))


def dkv_probe_value(dh):
    """(dk, dv) of ``dkv_probe`` exactly, fp32 [1, PROBE_TK, 1, dh]."""
    x = -PROBE_H * (PROBE_TQ // 4) * DKV_STEP
    dk, dv = torch.zeros(2, 1, PROBE_TK, 1, dh)
    dk[..., 1] = x
    dv[..., 0] = x
    return dk, dv


def _dkv_with(q, k, v, dout, lse, delta, p_as, ds_as, bias=None, segment_ids=None,
              causal=True, softmax_scale=None, window=None):
    """The plain dk/dv with p and ds passed through ``p_as`` and ``ds_as``
    before their products with dO and Q."""
    B, Tq, H, Dh = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    rep = H // KV
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        s = fa._masked_logits(q, k, b, bias, causal, scale, window, segment_ids)
        p = torch.exp(s - lse[b][..., None])
        do = dout[b].float()
        vf = v[b].float().repeat_interleave(rep, dim=1)
        ds = p * (torch.einsum("qhd,khd->hqk", do, vf) - delta[b][..., None]) * scale
        dv_h = torch.einsum("hqk,qhd->khd", p_as(p), do)
        dk_h = torch.einsum("hqk,qhd->khd", ds_as(ds), q[b].float())
        dv[b] = dv_h.reshape(Tk, KV, rep, Dh).sum(2).to(v.dtype)
        dk[b] = dk_h.reshape(Tk, KV, rep, Dh).sum(2).to(k.dtype)
    return dk, dv


# The dk/dv kernel's fp16 ds scale (kDsExp0 and ds_exp_limit in
# csrc/flash_attention.cu): ds is split times 2^e, one e per key row of dK,
# starting at DS_EXP0 (ds of unscaled gradients, about 1e-6, in fp16's normal
# range) and lowered, query tile by query tile, to the largest e that keeps
# the tile's max |ds| in the row times 2^e under 2^DS_EXP_CAP (hi finite);
# dK is scaled back exactly before its rounding. bf16 is split as is.
DS_EXP0, DS_EXP_CAP, DS_EXP_MIN = 10, 15, -100
DKV_QUERY_TILE = 64      # queries per item of the kernel's ring (BQ)


def ds_split_exponents(ds, kv_heads):
    """The kernel's exponent e for every entry of fp32 ds [H, Tq, Tk] (one
    batch row): per key and kv head, the running minimum over the kernel's
    items, query head of the group by query head, each in query tiles of
    DKV_QUERY_TILE, of DS_EXP0 and DS_EXP_CAP - 1 - floor(log2 max |ds|)
    over the tile's queries."""
    H, Tq, Tk = ds.shape
    nt = -(-Tq // DKV_QUERY_TILE)
    a = torch.nn.functional.pad(ds.abs(), (0, 0, 0, nt * DKV_QUERY_TILE - Tq))
    m = a.view(kv_heads, H // kv_heads, nt, DKV_QUERY_TILE, Tk).amax(3)
    log2m = torch.frexp(m).exponent - 1
    lim = torch.where(m > 0, (DS_EXP_CAP - 1 - log2m).clamp(min=DS_EXP_MIN), DS_EXP0)
    e = torch.cummin(lim.clamp(max=DS_EXP0).flatten(1, 2), dim=1).values
    e = e.view(kv_heads, H // kv_heads, nt, 1, Tk).expand(-1, -1, -1, DKV_QUERY_TILE, -1)
    return e.reshape(H, nt * DKV_QUERY_TILE, Tk)[:, :Tq]


def dkv_split_product(q, k, v, dout, lse, delta, ds_scale=None, **kw):
    """(dk, dv) by the tensor-core kernel's arithmetic: p and ds split into
    hi = round(x) and lo = round(x - hi) in q's dtype, and hi and lo each
    multiplied (exactly, in fp32) with dO and Q; fp16 ds split times 2^e by
    the kernel's rule (``ds_split_exponents``), or times ``ds_scale`` where
    given, a power of two undone exactly after the product."""

    def split(x, s=1.0):
        hi = (x * s).to(q.dtype).float()
        return (hi + (x * s - hi).to(q.dtype).float()) / s

    def split_ds(ds):
        if ds_scale is not None:
            return split(ds, ds_scale)
        if q.dtype != torch.float16:
            return split(ds)
        return split(ds, torch.exp2(ds_split_exponents(ds, k.shape[2]).float()))
    return _dkv_with(q, k, v, dout, lse, delta, split, split_ds, **kw)


def max_abs_ds(q, k, v, dout, lse, delta, **kw):
    """max |ds| of the plain dk/dv, ds = p (dp - delta) scale in fp32."""
    seen = []
    _dkv_with(q, k, v, dout, lse, delta, lambda p: p,
              lambda ds: seen.append(ds.abs().max()) or ds, **kw)
    return max(seen).item()


def dkv_rounding_faults(q, k, v, dout, lse, delta, **kw):
    """{fault: (dk, dv)} of the plain dk/dv with p, or ds, rounded once to
    q's dtype before its product: what a tensor-core port without the split
    would compute."""
    once = lambda x: x.to(q.dtype).float()
    keep = lambda x: x
    return {"p_rounded_once": _dkv_with(q, k, v, dout, lse, delta, once, keep, **kw),
            "ds_rounded_once": _dkv_with(q, k, v, dout, lse, delta, keep, once, **kw)}


# ---------------------------------------------------------------------------
# block-sparse forward (ops/block_sparse_attention.py)
# ---------------------------------------------------------------------------
#
# The block-sparse kernels round p to v's dtype against the running maximum
# after each whole layout block, as the TPU kernel does.


def sparse_probe(dtype, dh, block, device, seed=0):
    """(q, k, v, cols, counts, block, causal, scale) on which every output
    row cancels in all but every 8th column unless p rounds where the plain
    version rounds it: ``fwd_probe``'s keys with every query block enabling
    every key block (non-causal, scale 1) over PROBE_TK positions, so the
    first rounding tile is the first layout block (keys 0-63 at block 64,
    whose maximum is 0; 0-127 at block 128, whose maximum is PROBE_STEP)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    c, v = _probe_keys(dtype, dh, PROBE_STEP if block == 128 else 0.0, seed)
    S, H = PROBE_TK, PROBE_H
    q = torch.zeros(1, H, S, dh)
    q[..., 0] = 1
    k = torch.zeros(1, H, S, dh)
    k[..., 0] = c
    v = v[None, None].expand(1, H, S, dh).contiguous()
    cols, counts = bsa.compact_layout(torch.ones(H, S // block, S // block).numpy(),
                                      False, block)
    return (*(t.to(dtype).to(device) for t in (q, k, v)),
            torch.from_numpy(cols).to(device), torch.from_numpy(counts).to(device),
            block, False, 1.0)


def sparse_rounding_faults(q, k, v, cols, counts, block, causal, scale):
    """{fault: out} of the plain block-sparse forward with p rounded
    elsewhere: not at all (v read as fp32), or against the running maximum
    of the other block size's tiles (128 keys where the layout's block is
    64, 64 where it is 128). Needs a layout that enables every block, as
    ``sparse_probe``'s does, so that the other block size computes the same
    function."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    other = 128 if block == 64 else 64
    nq = q.shape[2] // other
    ocols, ocounts = bsa.compact_layout(torch.ones(q.shape[1], nq, nq).numpy(), causal, other)
    to = lambda a: torch.from_numpy(a).to(q.device)
    return {"p_unrounded": bsa.sparse_mha_fwd_reference(q, k, v.float(), cols, counts, block,
                                                        causal, scale).to(q.dtype),
            f"p_on_{other}_key_tiles": bsa.sparse_mha_fwd_reference(
                q, k, v, to(ocols), to(ocounts), other, causal, scale)}


def sparse_flip_slack(q, k, v, cols, counts, block, causal, scale):
    """fp32 [B, H, S, D]: how far the tensor-core block-sparse kernel's
    output may lie from the plain version's because a rounding of p went the
    other way (``flip_slack``'s terms, slot by slot of the compacted lists):
    a logit differs by at most 3 D u scale sum_d |q_d k_d| + 4 u |s|, the
    block's maximum likewise, and exp by 2^-21 + 4 u |x|; a p whose plain
    fp32 value lies that close to a rounding boundary of v's dtype may move
    the output by one spacing times |v| exp(m_j - m) / l, with m_j the
    running maximum after its block and m, l the row's final ones."""
    from deepspeed_tpu_torch.ops.block_sparse_attention import NEG_INF
    B, H, S, D = q.shape
    nq, C = S // block, cols.shape[-1]
    cols = cols.to(device=q.device, dtype=torch.long)
    counts = counts.to(device=q.device, dtype=torch.long)
    qb = q.reshape(B, H, nq, block, D).float()
    kb, vb = (t.reshape(B, H, nq, block, D) for t in (k, v))
    heads = torch.arange(H, device=q.device)[:, None]
    offs = torch.arange(block, device=q.device)
    qpos = (torch.arange(nq, device=q.device)[:, None] * block + offs)[None, :, :, None]

    def slot(j):
        idx = cols[:, :, j]
        kj = kb[:, heads, idx].float()
        s = torch.einsum("bhnqd,bhnkd->bhnqk", qb, kj) * scale
        tol = 3 * D * U32 * scale * torch.einsum("bhnqd,bhnkd->bhnqk", qb.abs(), kj.abs())
        if causal:
            kpos = (idx[..., None] * block + offs)[:, :, None, :]
            seen = qpos >= kpos
            s = torch.where(seen, s, NEG_INF)
            tol = torch.where(seen, tol + 4 * U32 * s.abs(), 0.0)
        else:
            tol = tol + 4 * U32 * s.abs()
        return s, tol, (j < counts)[None, :, :, None, None], idx

    # one pass in the online softmax's form: slack carried against the
    # running maximum and rescaled by alpha as it moves, divided by the
    # final l at the end
    m = torch.full((B, H, nq, block, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    slack = torch.zeros(B, H, nq, block, D, device=q.device)
    for j in range(C):
        s, tol, live, idx = slot(j)
        m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        rel = tol + tol.amax(-1, keepdim=True) + 2.0 ** -21 + 4 * U32 * (s - m_cur).abs()
        w = boundary_slack(p, v.dtype, p * rel)
        sl = slack * alpha + torch.einsum("bhnqk,bhnkd->bhnqd", w, vb[:, heads, idx].float().abs())
        l_cur = alpha * l + p.sum(-1, keepdim=True)
        m, l, slack = (torch.where(live, a, b) for a, b in ((m_cur, m), (l_cur, l), (sl, slack)))
    slack = slack / torch.where(l == 0, 1.0, l)
    return slack.reshape(B, H, S, D)


# ---------------------------------------------------------------------------
# paged attention (ops/paged_attention.py)
# ---------------------------------------------------------------------------


def paged_flip_slack(q, k_pool, v_pool, block_tables, seen, q_len, *, softmax_scale=None,
                     window=None):
    """fp32 [S, Q, H, Dh]: how far an output of p rounded to v's dtype may
    lie from ``paged_mha_reference``'s (p in fp32): one spacing of p in v's
    dtype times |v| / l, summed over the row's visible keys, with p =
    exp(s - m) and l against the row's final maximum m.

    A kernel that rounds p' = exp(s - m') against a maximum m' <= m (a page's
    or tile's running maximum, or a key split's) and rescales by r =
    exp(m' - m) moves each term by at most half a spacing of p' times r;
    half a spacing of p' is at most eps p' / 2, so that times r is eps p / 2,
    under one spacing of p. So the slack admits any maximum and any order of
    pages, tiles and splits; q.k summed in another order moves p by a few
    fp32 units, far inside it. A page read in place of another moves the
    output by whole terms p v / l, which the slack does not cover."""
    from deepspeed_tpu_torch.ops.paged_attention import NEG_INF
    S, Q, H, Dh = q.shape
    _, KV, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    rep = H // KV
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    bt = block_tables.long()
    keys = k_pool[bt].float().permute(0, 2, 1, 3, 4).reshape(S, KV, MB * bs, Dh)
    vals = v_pool[bt].float().abs().permute(0, 2, 1, 3, 4).reshape(S, KV, MB * bs, Dh)
    qg = q.float().reshape(S, Q, KV, rep, Dh)
    logits = torch.einsum("sqkrd,sktd->skrqt", qg, keys) * scale
    del keys
    kpos = torch.arange(MB * bs, device=q.device)
    tok = torch.arange(Q, device=q.device)
    qpos = seen.long()[:, None] + tok[None, :]
    visible = kpos[None, None, :] <= qpos[:, :, None]
    if window:
        visible &= kpos[None, None, :] > (qpos - window)[:, :, None]
    visible = visible[:, None, None]
    logits = torch.where(visible, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    del logits
    l = p.sum(-1, keepdim=True)
    w = torch.where(visible, spacing(p, v_pool.dtype), 0.0) / torch.where(l == 0, 1.0, l)
    del p
    slack = torch.einsum("skrqt,sktd->sqkrd", w, vals).reshape(S, Q, H, Dh)
    live = tok[None, :] < q_len.long()[:, None]
    return torch.where(live[:, :, None, None], slack, 0.0)


def paged_probe(dtype, dh, bs, device, Q=1, rep=2, seed=0):
    """((q, k_pool, v_pool, block_tables, seen, q_len), kwargs): one
    sequence of PROBE_TK keys in shuffled pages of ``bs`` keys, one kv head
    shared by ``rep`` query heads, Q query tokens seeing PROBE_TK - Q + 1 ..
    PROBE_TK keys, on which the output cancels in all but every 8th column
    unless p rounds once to ``dtype`` before P.V.

    scale 1, q = e_0, k_j = c_j e_0, so s_j = c_j exactly. The first key of
    every 64 keys has c = 0, the logits' maximum, so that every page, tile
    and key split takes its p against 0 from its first key on. Pairs of
    keys (a, b), both seen by every row, have p_a = exp(a) rounding up and
    p_b = exp(b) rounding down in ``dtype`` (at least a tenth of a spacing
    from the midpoint) and v_a = p_b, v_b = -p_a (rounded): each pair adds
    exactly 0 with p rounded so, in any order; with p unrounded the pairs
    add terms of one sign, rounded to the other 16-bit type terms that do
    not cancel. The other keys have c = -8 and v = 0 there."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda x: x.to(dtype).float()
    cands = torch.unique(torch.linspace(-1.0, -0.25, 4096).to(dtype)).float()
    up, down = _up_and_down(torch.exp(cands), cands, dtype)
    c, v = torch.full((PROBE_TK,), -8.0), torch.zeros(PROBE_TK, dh)
    c[::64] = 0.0
    last = PROBE_TK - Q          # the last key every row sees
    for j in range(PROBE_TK - 1):
        if j % 64 in range(1, 63, 2) and j + 1 <= last:
            a = up[torch.randint(len(up), (1,), generator=gen)]
            b = down[torch.randint(len(down), (1,), generator=gen)]
            c[j], c[j + 1] = a, b
            v[j], v[j + 1] = rnd(torch.exp(b)), -rnd(torch.exp(a))
    v[:, ::8] = PROBE_V
    n_pages = PROBE_TK // bs
    pages = torch.randperm(n_pages, generator=gen)
    k_pool = torch.zeros(n_pages + 1, 1, bs, dh)
    v_pool = torch.zeros(n_pages + 1, 1, bs, dh)
    for i in range(n_pages):
        k_pool[pages[i], 0, :, 0] = c[i * bs:(i + 1) * bs]
        v_pool[pages[i], 0] = v[i * bs:(i + 1) * bs]
    q = torch.zeros(1, Q, rep, dh)
    q[..., 0] = 1
    i32 = dict(dtype=torch.int32, device=device)
    return ((q.to(dtype).to(device), k_pool.to(dtype).to(device), v_pool.to(dtype).to(device),
             pages[None].to(**i32), torch.tensor([last], **i32), torch.tensor([Q], **i32)),
            dict(softmax_scale=1.0))


def paged_rounding_faults(q, k_pool, v_pool, block_tables, seen, q_len, **kw):
    """{fault: out} of the plain paged attention with p rounded elsewhere:
    not at all (``paged_mha_reference``), or to the other 16-bit type."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    other = torch.float16 if v_pool.dtype == torch.bfloat16 else torch.bfloat16
    args = (q, k_pool, v_pool, block_tables, seen, q_len)
    return {"p_unrounded": pa.paged_mha_reference(*args, **kw),
            f"p_in_{str(other).split('.')[1]}": pa._paged_form(
                *args, None, None, kw.get("softmax_scale"), kw.get("window"),
                lambda p, v: p.to(other).float())}

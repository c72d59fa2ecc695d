"""The port's grouped-GEMM MoE expert FFN against the JAX package's, on the CPU.

The same inputs, drawn from a numpy seed, go through the JAX functions and
their counterparts in ``deepspeed_tpu_torch``: ``topk_router`` (top-k
indices must be equal, ties to the lower expert), ``moe_ffn_gmm`` (whose
grouped products on CPU tensors run the kernel's plain version) against the
JAX ``moe_ffn_gmm`` with the megablox kernel in interpret mode and against
the JAX einsum dispatch (``_moe_ffn(..., force_einsum=True)``), and the
port's einsum row against the JAX einsum path. Balanced, skewed (the
fixture of ``tests/test_grouped_gemm_moe.py``) and empty-expert routing,
T in {16, 40}, E = 4, k in {1, 2}. The backward's plain versions (dx,
dW) are held to megablox ``gmm(..., transpose_rhs=True)`` and ``tgmm`` in
interpret mode, to megablox's own custom VJP under ``jax.grad``, and to
torch autograd of the plain forward. ``moe_ffn_gmm_rows`` (kernel row 9b,
the expert-parallel receiving shard's per-row FFN) on the plain versions
against the JAX ``moe_ffn_gmm_rows`` in interpret mode, output and every
gradient, with the zero sentinel rows of the receive buffer: id ``E`` in
the port (sorted past the last group and skipped), the last expert's id
in the JAX shard (``sharded_moe.py:539``).

Tolerances. fp32: both sides compute the same products in fp32 and differ
only in summation order, ~1e-7 here, held to 1e-5 relative and absolute.
bf16: each grouped product accumulates in fp32 and rounds once, so the two
sides' products differ by single roundings of bf16 values; held to one
output rounding of the same form as the GPU kernel checks, 2^-7 (|ref| +
rms(ref)), where the rms term covers elements near 0. The whole bf16 FFN
also carries the JAX side's bf16 ``silu`` roundings (see its test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2.model_implementations.mixtral import (
    _moe_ffn as jax_moe_ffn)
from deepspeed_tpu.ops.pallas.grouped_gemm import moe_ffn_gmm as jax_moe_ffn_gmm
from deepspeed_tpu.ops.pallas.grouped_gemm import moe_ffn_gmm_rows as jax_moe_ffn_gmm_rows
from deepspeed_tpu.ops.pallas.grouped_gemm import topk_router as jax_topk_router
from deepspeed_tpu_torch.inference.v2.model_implementations.mixtral import (
    _moe_ffn, moe_ffn_einsum)
from deepspeed_tpu_torch.ops.grouped_gemm import (grouped_matmul,
                                                  grouped_matmul_dw,
                                                  grouped_matmul_dw_reference,
                                                  grouped_matmul_dx,
                                                  grouped_matmul_dx_reference,
                                                  grouped_matmul_reference,
                                                  is_supported, moe_ffn_gmm,
                                                  moe_ffn_gmm_rows, moe_scatter,
                                                  topk_router,
                                                  unsupported_reason)

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL = 2 ** -7


def make_case(T=16, D=128, F=256, E=4, seed=0, routing="balanced"):
    """x [T, D], router [D, E], w1/w3 [E, D, F], w2 [E, F, D] as fp32 numpy.
    ``skewed``: positive tokens and +5 on router column 0 send (nearly)
    every token to expert 0; ``empty``: -5 on column E-1 leaves expert E-1
    with no token."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    gate = (0.3 * rng.standard_normal((D, E))).astype(np.float32)
    w1, w3 = (0.05 * rng.standard_normal((2, E, D, F))).astype(np.float32)
    w2 = (0.05 * rng.standard_normal((E, F, D))).astype(np.float32)
    if routing == "skewed":
        x, gate[:, 0] = np.abs(x), gate[:, 0] + 5.0
    elif routing == "empty":
        x, gate[:, E - 1] = np.abs(x), gate[:, E - 1] - 5.0
    return x, gate, w1, w2, w3


def torch_args(case, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in case]


def jax_route(x, gate, k):
    tv, ti = jax_topk_router(jnp.asarray(x), jnp.asarray(gate), k)
    return np.asarray(tv), np.asarray(ti)


def jax_gmm(case, tv, ti, dtype=jnp.float32):
    x, gate, w1, w2, w3 = (jnp.asarray(a, dtype) for a in case)
    return np.asarray(jax_moe_ffn_gmm(x, jnp.asarray(tv), jnp.asarray(ti), w1,
                                      w2, w3, n_experts=gate.shape[1],
                                      dtype=dtype, interpret=True)
                      .astype(jnp.float32))


def jax_einsum(case, k):
    x, gate, w1, w2, w3 = (jnp.asarray(a) for a in case)
    return np.asarray(jax_moe_ffn(x, gate, w1, w2, w3, k=k, dtype=jnp.float32,
                                  force_einsum=True))


def port_gmm(case, tv, ti, dtype=torch.float32):
    x, gate, w1, w2, w3 = torch_args(case, dtype)
    return moe_ffn_gmm(x, torch.tensor(tv), torch.tensor(ti).long(),
                       w1, w2, w3, n_experts=gate.shape[1],
                       dtype=dtype).float().numpy()


CASES = [(T, k, r) for r in ("balanced", "skewed", "empty")
         for T in (16, 40) for k in (1, 2)]
CASE_IDS = [f"{r}-T{T}-k{k}" for T, k, r in CASES]


@pytest.mark.parametrize("T,k,routing", CASES, ids=CASE_IDS)
def test_router_matches_jax(T, k, routing):
    case = make_case(T=T, routing=routing, seed=T + k)
    tv, ti = jax_route(case[0], case[1], k)
    ours_v, ours_i = topk_router(*torch_args(case[:2]), k)
    np.testing.assert_array_equal(ours_i.numpy(), ti)
    np.testing.assert_allclose(ours_v.numpy(), tv, **FP32_TOL)
    if routing == "empty":
        assert (ti != case[1].shape[1] - 1).all()
    if routing == "skewed":
        assert (ti[:, 0] == 0).sum() >= T - 2


def test_router_ties_go_to_lower_expert():
    """Equal probabilities keep index order, as ``jax.lax.top_k`` does: zero
    tokens give uniform routing, and two equal router columns tie."""
    x = np.zeros((3, 8), np.float32)
    x[2] = 1.0
    gate = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    gate[:, 4] = gate[:, 1] = 3.0
    for k in (1, 2, 3):
        tv, ti = jax_route(x, gate, k)
        ours_v, ours_i = topk_router(*torch_args((x, gate)), k)
        np.testing.assert_array_equal(ours_i.numpy(), ti)
        np.testing.assert_allclose(ours_v.numpy(), tv, **FP32_TOL)
    assert ours_i[0].tolist() == [0, 1, 2] and ours_i[2, :2].tolist() == [1, 4]


@pytest.mark.parametrize("T,k,routing", CASES, ids=CASE_IDS)
def test_moe_ffn_gmm_matches_jax_interpret_and_einsum(T, k, routing):
    """Same routing into both grouped paths (the JAX router's output), and
    the whole FFN with each package's own router against the JAX einsum
    oracle."""
    case = make_case(T=T, routing=routing, seed=T + k)
    tv, ti = jax_route(case[0], case[1], k)
    ours = port_gmm(case, tv, ti)
    np.testing.assert_allclose(ours, jax_gmm(case, tv, ti), **FP32_TOL)
    x, gate, w1, w2, w3 = torch_args(case)
    full, (_, idx) = _moe_ffn(x, gate, w1, w2, w3, k=k, dtype=torch.float32)
    np.testing.assert_array_equal(idx.numpy(), ti)
    np.testing.assert_allclose(full.numpy(), jax_einsum(case, k), **FP32_TOL)


def one_rounding_ratio(ours, ref, rtol):
    """Largest |ours - ref| / (rtol (|ref| + rms(ref))): at most 1 passes."""
    bound = rtol * (np.abs(ref) + np.sqrt((ref ** 2).mean()))
    return float((np.abs(ours - ref) / bound).max())


@pytest.mark.parametrize("T,k", [(16, 2), (40, 1), (40, 2)])
def test_grouped_products_bf16_within_one_rounding(T, k):
    """Each grouped product of the bf16 FFN, on rows sorted by the port's
    ``moe_scatter``, against megablox ``gmm`` (interpret mode, fp32
    accumulation, ``.astype(bf16)``): x @ w1 and x @ w3 (K=D, N=F), and
    h @ w2 (K=F, N=D) on the JAX side's own h."""
    from jax.experimental.pallas.ops.tpu.megablox import gmm
    case = make_case(T=T, seed=100 + T + k)
    _, ti = jax_route(case[0], case[1], k)
    x, _, w1, w2, w3 = torch_args(case, torch.bfloat16)
    E = w1.shape[0]
    order, offsets = moe_scatter(torch.tensor(ti).long(), E)
    xs = x[order // k]
    pad = (-xs.shape[0]) % 128                 # megablox's row tile
    sizes = np.diff(offsets.numpy()).astype(np.int32)
    sizes[-1] += pad

    def jax_product(lhs, w):
        lhs = jnp.asarray(lhs.float().numpy(), jnp.bfloat16)
        lhs = jnp.concatenate([lhs, jnp.zeros((pad, lhs.shape[1]), lhs.dtype)])
        out = gmm(lhs, jnp.asarray(w.float().numpy(), jnp.bfloat16),
                  jnp.asarray(sizes), preferred_element_type=jnp.float32,
                  tiling=(128, 128, 128), interpret=True).astype(jnp.bfloat16)
        return np.asarray(out.astype(jnp.float32))[:lhs.shape[0] - pad]

    a, b = jax_product(xs, w1), jax_product(xs, w3)
    h = jax.nn.silu(jnp.asarray(a, jnp.bfloat16)) * jnp.asarray(b, jnp.bfloat16)
    h = torch.tensor(np.asarray(h.astype(jnp.float32))).bfloat16()
    for lhs, w, ref in ((xs, w1, a), (xs, w3, b), (h, w2, jax_product(h, w2))):
        ours = grouped_matmul(lhs, w, offsets).float().numpy()
        assert one_rounding_ratio(ours, ref, BF16_RTOL) <= 1


@pytest.mark.parametrize("T,k", [(16, 2), (40, 1), (40, 2)])
def test_moe_ffn_gmm_bf16_matches_jax(T, k):
    """The whole bf16 FFN. Beyond the products' single roundings, XLA on
    the CPU computes a bf16 ``silu`` as x / (1 + exp(-x)) rounding each of
    its four steps to bf16, where the port's ``F.silu`` rounds once; those
    roundings (up to 2^-7 relative each) reach the output through h @ w2.
    Held to four roundings, 2^-5 (|ref| + rms(ref)); observed ~1.6x one."""
    case = make_case(T=T, seed=100 + T + k)
    tv, ti = jax_route(case[0], case[1], k)
    ref = jax_gmm(case, tv, ti, jnp.bfloat16)
    ours = port_gmm(case, tv, ti, torch.bfloat16)
    assert one_rounding_ratio(ours, ref, 4 * BF16_RTOL) <= 1


@pytest.mark.parametrize("T,k,routing", [(16, 2, "balanced"), (40, 1, "skewed"),
                                         (40, 2, "empty")])
def test_einsum_row_matches_jax_einsum(T, k, routing):
    case = make_case(T=T, routing=routing, seed=7 * T + k)
    x, gate, w1, w2, w3 = torch_args(case)
    out, _ = _moe_ffn(x, gate, w1, w2, w3, k=k, dtype=torch.float32,
                      moe=moe_ffn_einsum)
    np.testing.assert_allclose(out.numpy(), jax_einsum(case, k), **FP32_TOL)
    tv, ti = topk_router(x, gate, k)
    direct = moe_ffn_einsum(x, tv, ti, w1, w2, w3, n_experts=gate.shape[1],
                            dtype=torch.float32)
    torch.testing.assert_close(direct, out, rtol=0, atol=0)


def test_moe_scatter_sorts_stably_with_device_offsets():
    top_idx = torch.tensor([[2, 0], [0, 3], [2, 1], [3, 0]])
    order, offsets = moe_scatter(top_idx, n_experts=5)
    assert order.tolist() == [1, 2, 7, 5, 0, 4, 3, 6]
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [0, 3, 4, 6, 8, 8]          # expert 4 empty


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_grouped_matmul_cpu_runs_plain_version(dtype):
    """On CPU tensors the wrapper is the plain version and launches nothing;
    the plain version is a per-group product in fp32, cast once, over empty
    groups, one group holding every row, and widths that are no tile
    multiple. Against fp64 products each element is within one rounding to
    the dtype (fp32: the summation order, far below it)."""
    rtol = {torch.float32: 2 ** -20, torch.bfloat16: 2 ** -7,
            torch.float16: 2 ** -10}[dtype]
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.standard_normal((37, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 24, 40)).astype(np.float32))
    xs, w = xs.to(dtype), w.to(dtype)
    for offs in ([0, 0, 11, 11, 30, 37], [0, 37, 37, 37, 37, 37],
                 [0, 0, 0, 0, 0, 37]):
        offsets = torch.tensor(offs, dtype=torch.int32)
        before = grouped_matmul.launches
        out = grouped_matmul(xs, w, offsets)
        assert grouped_matmul.launches == before
        torch.testing.assert_close(out, grouped_matmul_reference(xs, w, offsets),
                                   rtol=0, atol=0)
        for e in range(5):
            lo, hi = offs[e], offs[e + 1]
            want = (xs[lo:hi].double() @ w[e].double()).to(dtype)
            torch.testing.assert_close(out[lo:hi], want, rtol=rtol, atol=1e-5)


def test_grouped_matmul_refuses_other_devices():
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        grouped_matmul(meta, torch.empty(2, 8, 8, device="meta"),
                       torch.empty(3, dtype=torch.int32, device="meta"))


def test_is_supported_states_the_kernel_limits():
    assert is_supported(4096, 14336)            # Mixtral-8x7B
    assert is_supported(64, 128)                # MixtralConfig.tiny
    assert is_supported(200, 72)                # no tile multiple needed
    assert not is_supported(4100, 14336)
    assert not is_supported(64, 0)
    assert "multiple of 8" in unsupported_reason(4096, 14340)


# ---------------------------------------------------------------------------
# backward: dx (gmm with transpose_rhs) and dW (tgmm)
# ---------------------------------------------------------------------------

BWD_GROUPS = {
    # name: group sizes (E = 4), R = their sum
    "balanced": [40, 40, 40, 40],
    "empty_expert": [70, 0, 50, 40],
    "one_group": [0, 0, 130, 0],
}


def bwd_case(sizes, K=128, N=256, seed=0):
    rng = np.random.default_rng(seed)
    R, E = sum(sizes), len(sizes)
    xs = rng.standard_normal((R, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * K ** -0.5).astype(np.float32)
    dy = rng.standard_normal((R, N)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return xs, w, dy, offsets


def megablox_backward(xs, w, dy, sizes, dtype):
    """megablox gmm(transpose_rhs=True) and tgmm in interpret mode, fp32
    accumulation cast to ``dtype``, rows padded to the 128-row tile into the
    last group as the JAX wrapper pads them."""
    # the module, not the package's custom-VJP ``gmm`` of the same name
    from jax.experimental.pallas.ops.tpu.megablox.gmm import gmm as mb_gmm
    from jax.experimental.pallas.ops.tpu.megablox.gmm import tgmm
    R = xs.shape[0]
    pad = (-R) % 128
    gs = np.asarray(sizes, np.int32).copy()
    gs[-1] += pad
    padded = lambda a: jnp.concatenate([jnp.asarray(a, dtype),
                                        jnp.zeros((pad, a.shape[1]), dtype)])
    dx = mb_gmm(padded(dy), jnp.asarray(w, dtype), jnp.asarray(gs), dtype,
                (128, 128, 128), transpose_rhs=True, interpret=True)
    dw = tgmm(padded(xs).swapaxes(0, 1), padded(dy), jnp.asarray(gs), dtype,
              (128, 128, 128), interpret=True)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return f32(dx)[:R], f32(dw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(BWD_GROUPS))
def test_backward_plain_versions_match_megablox_interpret(name, dtype):
    """fp32: summation order only (1e-5). bf16: megablox multiplies the bf16
    inputs exactly in fp32 and rounds once, as the plain versions do, so the
    two differ by at most one rounding: the one-rounding bound 2^-7 (|ref| +
    rms(ref)). An expert with no rows gets a dW of exactly zero."""
    sizes = BWD_GROUPS[name]
    xs, w, dy, offsets = bwd_case(sizes, seed=len(name))
    want_dx, want_dw = megablox_backward(xs, w, dy, sizes, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    xt, wt, dyt = (torch.from_numpy(a).to(tdt) for a in (xs, w, dy))
    off = torch.from_numpy(offsets)
    dx = grouped_matmul_dx(dyt, wt, off)
    dw = grouped_matmul_dw(xt, dyt, off)
    torch.testing.assert_close(dx, grouped_matmul_dx_reference(dyt, wt, off),
                               rtol=0, atol=0)
    assert dx.dtype == dw.dtype == tdt and dw.shape == (len(sizes), 128, 256)
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), want_dx, **FP32_TOL)
        np.testing.assert_allclose(dw.numpy(), want_dw, **FP32_TOL)
    else:
        assert one_rounding_ratio(dx.float().numpy(), want_dx, BF16_RTOL) <= 1
        assert one_rounding_ratio(dw.float().numpy(), want_dw, BF16_RTOL) <= 1
    for e, n in enumerate(sizes):
        if n == 0:
            assert torch.count_nonzero(dw[e]) == 0 and not want_dw[e].any()


@pytest.mark.parametrize("name", list(BWD_GROUPS))
def test_grouped_matmul_vjp_matches_megablox_and_autograd(name):
    """The autograd backward of ``grouped_matmul`` (fp32, CPU: the dx and dW
    plain versions) against megablox's custom VJP under ``jax.grad`` (interpret
    mode) and against torch autograd of the plain forward."""
    from jax.experimental.pallas.ops.tpu.megablox import gmm
    sizes = BWD_GROUPS[name]
    xs, w, dy, offsets = bwd_case(sizes, seed=10 + len(name))
    R, pad = xs.shape[0], (-xs.shape[0]) % 128
    gs = np.asarray(sizes, np.int32).copy()
    gs[-1] += pad

    def jloss(a, b):
        a = jnp.concatenate([a, jnp.zeros((pad, a.shape[1]), a.dtype)])
        out = gmm(a, b, jnp.asarray(gs), preferred_element_type=jnp.float32,
                  tiling=(128, 128, 128), interpret=True)[:R]
        return jnp.sum(out * dy)

    want_dx, want_dw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xs), jnp.asarray(w))
    off = torch.from_numpy(offsets)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xs, w)]
    grouped_matmul(*leaves, off).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(want_dx), **FP32_TOL)
    np.testing.assert_allclose(leaves[1].grad.numpy(), np.asarray(want_dw), **FP32_TOL)
    plain = [torch.from_numpy(a).requires_grad_() for a in (xs, w)]
    grouped_matmul_reference(*plain, off).backward(torch.from_numpy(dy))
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def test_fp16_product_under_autograd_raises_like_megablox():
    xs = torch.zeros(4, 8, dtype=torch.float16, requires_grad=True)
    w = torch.zeros(2, 8, 8, dtype=torch.float16)
    off = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        grouped_matmul(xs, w, off)
    with torch.no_grad():                    # serving keeps fp16
        assert grouped_matmul(xs, w, off).dtype == torch.float16


# rows of an ep receive buffer: per peer block, the real rows' local expert
# ids, then zero sentinel rows (id E); "one_empty": no real row for expert 1
ROWS_CASES = {"balanced": ([[0, 1, 1, 0, 1], [1, 0, 0]], 8),
              "one_empty": ([[0, 0, 0], [0, 0]], 6),
              "all_sentinel_peer": ([[1, 0, 1, 1, 0, 0, 1], []], 7)}


def rows_case(blocks, R, D=128, F=256, E=2, seed=0):
    """x_rows [ep * R, D] (zero past each block's real rows), the port's
    row ids (sentinel E), the JAX shard's (sentinel folded into E - 1), the
    weights, and an output gradient that is zero on the sentinel rows, as
    the combine's gather leaves it."""
    rng = np.random.default_rng(seed)
    x = np.zeros((len(blocks) * R, D), np.float32)
    ids = np.full(len(blocks) * R, E, np.int64)
    for b, block in enumerate(blocks):
        x[b * R:b * R + len(block)] = rng.standard_normal((len(block), D))
        ids[b * R:b * R + len(block)] = block
    w1, w3 = (0.05 * rng.standard_normal((2, E, D, F))).astype(np.float32)
    w2 = (0.05 * rng.standard_normal((E, F, D))).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32) * (ids < E)[:, None]
    return x, ids, np.minimum(ids, E - 1).astype(np.int32), w1, w2, w3, dy


@pytest.mark.parametrize("name", list(ROWS_CASES))
def test_moe_ffn_gmm_rows_matches_jax_with_sentinels(name):
    """Output and the gradients of x, w1, w2, w3 (fp32, summation order
    only: 1e-5); sentinel rows give 0 and a zero input gradient."""
    blocks, R = ROWS_CASES[name]
    x, ids, jids, w1, w2, w3, dy = rows_case(blocks, R, seed=len(name))
    E = w1.shape[0]

    def jloss(x_, a, b, c):
        y = jax_moe_ffn_gmm_rows(x_, jnp.asarray(jids), a, b, c, n_experts=E,
                                 dtype=jnp.float32, interpret=True)
        return jnp.sum(y * dy), y

    (_, want), want_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                               has_aux=True)(
        *(jnp.asarray(a) for a in (x, w1, w2, w3)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w2, w3)]
    got = moe_ffn_gmm_rows(leaves[0], torch.from_numpy(ids), leaves[1], leaves[2],
                           leaves[3], n_experts=E, dtype=torch.float32)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FP32_TOL)
    sentinel = ids == E
    assert not got.detach().numpy()[sentinel].any()
    assert not leaves[0].grad.numpy()[sentinel].any()
    for leaf, w in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **FP32_TOL)
    if name == "one_empty":
        assert not leaves[1].grad[1].any() and not np.asarray(want_grads[1])[1].any()

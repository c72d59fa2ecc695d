"""The port's paged attention (``deepspeed_tpu_torch/ops/paged_attention.py``)
against the JAX package's Pallas kernel, run in interpret mode, and its dense
twin ``_paged_attention_dense``.

On CPU tensors ``paged_mha`` runs the kernel's plain PyTorch version, so
these cases hold that plain version — the oracle the CUDA kernel is compared
with on the card (``tests/test_torch_gpu_kernels.py``, ``chip_smoke.py``) —
to the reference semantics: decode and chunked prefill (Q in {1, 8, 16}),
GQA and MHA, a sliding window, int8 pools with per-token scales, seen=0
first tokens and q_len=0 padding rows. Mirrors
``tests/test_paged_attention_kernel.py``.

Tolerance: inputs are fp32 and both sides compute in fp32; they differ only
in summation order (online softmax over blocks vs one softmax), so 2e-5
absolute on outputs of magnitude ~1 (as the JAX kernel tests use 2e-4 for
their own kernel-vs-dense check, tightened here because nothing is bf16).

At bf16 inputs the TPU kernel rounds p to v's dtype before P.V; the port's
tensor-core kernel does too, and ``paged_mha_kernel_form`` is its plain
version at that rounding point, page by page as the TPU kernel visits them.
It is held to the Pallas kernel in interpret mode at one bf16 rounding of
the output (2^-7 |pallas| + 2e-5), with at least 99.9% of the live outputs
bitwise equal; the fp32-p plain version misses that bound (one p rounding
moves an output by about one bf16 unit). On ``paged_probe``
(``tests/flash_rounding.py``) the Pallas kernel itself cancels where p is
rounded once to v's dtype.
"""

import numpy as np
import pytest
import torch
from flash_rounding import paged_probe, paged_rounding_faults

import jax.numpy as jnp

from deepspeed_tpu.inference.v2.model_implementations.llama import (
    _paged_attention_dense)
from deepspeed_tpu.ops.pallas.paged_attention import paged_mha as jax_paged_mha
from deepspeed_tpu_torch.ops.paged_attention import (
    _check_cuda_args, is_supported, paged_mha, paged_mha_kernel_form,
    paged_mha_reference, unsupported_reason)

ATOL = 2e-5


def make_case(S=3, Q=1, H=4, KV=2, Dh=16, bs=8, MB=4, seed=0, int8=False,
              seen=None, q_len=None):
    """numpy inputs: distinct blocks per sequence (the last pool block is
    the trash block), ragged seen, optional int8 pages with fp32 scales."""
    rng = np.random.default_rng(seed)
    NB = S * MB + 1
    q = rng.standard_normal((S, Q, H, Dh)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (NB, KV, bs, Dh)).astype(np.int8)
        v = rng.integers(-127, 128, (NB, KV, bs, Dh)).astype(np.int8)
        ks = rng.uniform(0.005, 0.015, (NB, KV, 1, bs)).astype(np.float32)
        vs = rng.uniform(0.005, 0.015, (NB, KV, 1, bs)).astype(np.float32)
    else:
        k = rng.standard_normal((NB, KV, bs, Dh)).astype(np.float32)
        v = rng.standard_normal((NB, KV, bs, Dh)).astype(np.float32)
        ks = vs = None
    bt = rng.permutation(NB - 1)[:S * MB].reshape(S, MB).astype(np.int32)
    if seen is None:
        seen = rng.integers(0, MB * bs - Q, size=S)
    seen = np.asarray(seen, np.int32)
    q_len = np.full((S,), Q, np.int32) if q_len is None \
        else np.asarray(q_len, np.int32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, bt=bt, seen=seen, q_len=q_len)


def run_port(c, window=None, fn=paged_mha):
    t = {n: (torch.from_numpy(x) if x is not None else None)
         for n, x in c.items()}
    out = fn(t["q"], t["k"], t["v"], t["bt"], t["seen"], t["q_len"],
             k_scale=t["ks"], v_scale=t["vs"], window=window)
    return out.numpy()


def run_jax_kernel(c, window=None):
    j = {n: (jnp.asarray(x) if x is not None else None) for n, x in c.items()}
    return np.asarray(jax_paged_mha(j["q"], j["k"], j["v"], j["bt"],
                                    j["seen"], j["q_len"], k_scale=j["ks"],
                                    v_scale=j["vs"], window=window,
                                    interpret=True))


def run_jax_dense(c, window=None):
    j = {n: (jnp.asarray(x) if x is not None else None) for n, x in c.items()}
    kp = j["k"] if c["ks"] is None else (j["k"], j["ks"])
    vp = j["v"] if c["vs"] is None else (j["v"], j["vs"])
    return np.asarray(_paged_attention_dense(j["q"], kp, vp, j["bt"],
                                             j["seen"], c["k"].shape[2],
                                             window=window))


def live(c):
    Q = c["q"].shape[1]
    return np.arange(Q)[None, :] < c["q_len"][:, None]


def assert_matches_reference(c, window=None):
    ours = run_port(c, window)
    m = live(c)
    np.testing.assert_allclose(ours[m], run_jax_kernel(c, window)[m],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours[m], run_jax_dense(c, window)[m],
                               atol=ATOL, rtol=0)
    # rows past q_len are padding: the port defines them as zero
    assert not ours[~m].any()


@pytest.mark.parametrize("Q", [1, 8, 16])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_matches_jax_kernel_and_dense(Q, H, KV):
    assert_matches_reference(make_case(Q=Q, H=H, KV=KV, seed=Q + KV))


@pytest.mark.parametrize("window", [8, 20])
def test_sliding_window(window):
    assert_matches_reference(make_case(S=3, Q=8, seed=7), window=window)


@pytest.mark.parametrize("Q", [1, 8])
def test_int8_pools(Q):
    assert_matches_reference(make_case(Q=Q, int8=True, seed=11))


def test_zero_seen_first_tokens_and_padded_rows():
    c = make_case(S=4, Q=8, seed=3, seen=[0, 0, 9, 0], q_len=[8, 1, 3, 0])
    assert_matches_reference(c)
    out = run_port(c)
    assert not out[3].any()                  # q_len = 0: the whole row is 0


def test_head_dim_64_gqa_window():
    assert_matches_reference(make_case(S=2, Q=8, H=8, KV=2, Dh=64, bs=16,
                                       seed=5), window=24)


def test_cpu_wrapper_is_the_plain_version():
    c = make_case(Q=8, seed=1)
    launches = paged_mha.launches
    np.testing.assert_array_equal(run_port(c),
                                  run_port(c, fn=paged_mha_reference))
    assert paged_mha.launches == launches    # nothing launched on the CPU


def test_bf16_plain_version_close_to_fp32():
    """The plain version keeps fp32 arithmetic for bf16 inputs: the only
    error is the bf16 rounding of inputs and output (~3 bf16 ulps here)."""
    c = make_case(Q=8, seed=2)
    t = {n: (torch.from_numpy(x) if x is not None else None)
         for n, x in c.items()}
    args = [t["q"].bfloat16(), t["k"].bfloat16(), t["v"].bfloat16(),
            t["bt"], t["seen"], t["q_len"]]
    out = paged_mha_reference(*args)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), run_port(c), atol=3e-2)


def test_supported_shapes():
    assert is_supported((2, 1, 32, 128), (8, 32, 64, 128))
    assert is_supported((2, 1, 32, 128), (8, 8, 64, 128))       # GQA
    assert is_supported((2, 1, 8, 256), (8, 2, 16, 256))
    assert "multiple of KV" in unsupported_reason((2, 1, 8, 64), (8, 3, 16, 64))
    assert "head dim" in unsupported_reason((2, 1, 8, 512), (8, 2, 16, 512))
    assert "head dim" in unsupported_reason((2, 1, 8, 40), (8, 2, 16, 40))


def test_other_devices_raise():
    c = make_case()
    t = [torch.from_numpy(c[n]).to("meta") for n in
         ("q", "k", "v", "bt", "seen", "q_len")]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        paged_mha(*t)


def test_kernel_argument_checks():
    """What the CUDA kernel cannot take raises before any launch (checked
    here on CPU tensors; the checks are device-independent)."""
    c = make_case(Q=8)
    t = {n: (torch.from_numpy(x) if x is not None else None)
         for n, x in c.items()}
    base = [t["q"], t["k"], t["v"], t["bt"], t["seen"], t["q_len"]]

    def check(args, ks=None, vs=None):
        _check_cuda_args(*args, ks, vs)

    check(base)
    with pytest.raises(TypeError, match="int32"):
        check(base[:3] + [t["bt"].long()] + base[4:])
    with pytest.raises(ValueError, match="contiguous"):
        check([t["q"].transpose(0, 1)] + base[1:])
    with pytest.raises(TypeError, match="pools must be"):
        check([t["q"].half()] + base[1:])
    with pytest.raises(ValueError, match="together"):
        check(base, ks=torch.ones(1))
    ci = make_case(Q=8, int8=True)
    ti = {n: torch.from_numpy(x) for n, x in ci.items()}
    int8_args = [ti["q"], ti["k"], ti["v"], ti["bt"], ti["seen"], ti["q_len"]]
    check(int8_args, ti["ks"], ti["vs"])
    with pytest.raises(ValueError, match="k_scale must be float32"):
        check(int8_args, ti["ks"].double(), ti["vs"])
    with pytest.raises(ValueError, match="cannot take"):
        check([t["q"][..., :8].contiguous()] + base[1:])


# -- the TPU kernel's 16-bit rounding point ---------------------------------

BF16_RTOL = 2 ** -7


def jax_16bit(t, dtype):
    """A CPU tensor as a JAX array of ``dtype`` (int8 kept)."""
    if t.dtype == torch.int8:
        return jnp.asarray(t.numpy())
    return jnp.asarray(t.float().numpy()).astype(dtype)


def pallas_16bit(args, kw, dtype):
    q, k, v, bt, seen, q_len = args
    ks, vs = kw.get("k_scale"), kw.get("v_scale")
    out = jax_paged_mha(jax_16bit(q, dtype), jax_16bit(k, dtype), jax_16bit(v, dtype),
                        jnp.asarray(bt.numpy()), jnp.asarray(seen.numpy()),
                        jnp.asarray(q_len.numpy()),
                        k_scale=None if ks is None else jnp.asarray(ks.numpy()),
                        v_scale=None if vs is None else jnp.asarray(vs.numpy()),
                        softmax_scale=kw.get("softmax_scale"), window=kw.get("window"),
                        interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("Q,H,KV,window,int8", [
    (1, 4, 4, None, False), (1, 8, 2, None, False), (16, 4, 4, None, False),
    (16, 8, 2, None, False), (8, 8, 2, 20, False), (1, 8, 2, None, True),
    (8, 4, 4, None, True)],
    ids=["decode_mha", "decode_gqa", "chunk_mha", "chunk_gqa", "window", "decode_int8",
         "chunk_int8"])
def test_kernel_form_matches_pallas_at_bf16(Q, H, KV, window, int8):
    """bf16 q (and fp pools): the kernel form and the Pallas kernel round p
    at the same point and visit the pages in the same order, so they agree
    bit for bit but for a rare p that fp32 sums in another order round the
    other way; the fp32-p plain version misses the bound."""
    c = make_case(S=3, Q=Q, H=H, KV=KV, Dh=64, bs=16, MB=8, seed=Q + H, int8=int8)
    t = {n: (torch.from_numpy(x) if x is not None else None) for n, x in c.items()}
    to16 = lambda x: x if x.dtype == torch.int8 else x.bfloat16()
    args = (t["q"].bfloat16(), to16(t["k"]), to16(t["v"]), t["bt"], t["seen"], t["q_len"])
    kw = dict(k_scale=t["ks"], v_scale=t["vs"], window=window)
    want = pallas_16bit(args, kw, jnp.bfloat16)
    got = paged_mha_kernel_form(*args, **kw)
    assert got.dtype == torch.bfloat16
    m = torch.from_numpy(live(c))[:, :, None, None].expand(want.shape)
    bound = ATOL + BF16_RTOL * want.abs()
    assert ((got.float() - want).abs() / bound)[m].max() <= 1
    assert (got.float() == want)[m].float().mean() >= 0.999
    assert not got.float()[~m].any()
    plain = paged_mha_reference(*args, **kw).float()
    if int8:     # int8 pools keep p in fp32 in both
        assert torch.equal(plain, got.float())
    else:
        assert ((plain - want).abs() / bound)[m].max() > 4


@pytest.mark.parametrize("Q,H,KV,window", [
    (1, 4, 4, None), (8, 8, 2, None), (16, 4, 4, 20)],
    ids=["decode_mha", "chunk_gqa", "window"])
def test_kernel_form_matches_pallas_at_bf16_width_80(Q, H, KV, window):
    """Phi-2's head width (80), which the SIMT route serves: the kernel
    form, which both routes are held to, rounds p where the Pallas kernel
    does at this width too. They agree bit for bit but for a rare p that
    fp32 sums in another order round the other way (3 of ~4000 outputs in
    the window case, which move past the bound alone: the bound adds
    ``paged_flip_slack``, as the GPU tests' does for such flips); the
    fp32-p plain version misses the bound fourfold."""
    from flash_rounding import paged_flip_slack
    c = make_case(S=3, Q=Q, H=H, KV=KV, Dh=80, bs=16, MB=8, seed=Q + H + 80)
    t = {n: (torch.from_numpy(x) if x is not None else None) for n, x in c.items()}
    args = (t["q"].bfloat16(), t["k"].bfloat16(), t["v"].bfloat16(), t["bt"], t["seen"],
            t["q_len"])
    kw = dict(window=window)
    want = pallas_16bit(args, kw, jnp.bfloat16)
    got = paged_mha_kernel_form(*args, **kw)
    m = torch.from_numpy(live(c))[:, :, None, None].expand(want.shape)
    bound = ATOL + BF16_RTOL * want.abs()
    slack = paged_flip_slack(*args, **kw)
    assert ((got.float() - want).abs() / (bound + slack))[m].max() <= 1
    assert (got.float() == want)[m].float().mean() >= 0.999
    plain = paged_mha_reference(*args, **kw).float()
    assert ((plain - want).abs() / bound)[m].max() > 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("bs,Q,rep", [(16, 1, 2), (64, 8, 4)])
def test_pallas_kernel_rounds_p_where_the_probe_pins_it(dtype, bs, Q, rep):
    """On paged_probe the Pallas kernel equals the kernel form with no slack
    (its outputs cancel where p is rounded once to v's dtype), and the plain
    versions with p unrounded or in the other 16-bit type miss it."""
    args, kw = paged_probe(dtype, 64, bs, "cpu", Q=Q, rep=rep)
    form = paged_mha_kernel_form(*args, **kw).float()
    assert not form[..., 1:8].any()
    rtol = {torch.bfloat16: BF16_RTOL, torch.float16: 2 ** -10}[dtype]
    bound = ATOL + rtol * form.abs()
    want = pallas_16bit(args, kw, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16)
    assert ((want - form).abs() / bound).max() <= 1
    for fault, bad in paged_rounding_faults(*args, **kw).items():
        assert ((bad.float() - want).abs() / bound).max() > 4, fault

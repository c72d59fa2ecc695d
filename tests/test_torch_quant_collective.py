"""The port's groupwise quantize / dequantize-reduce (the qgZ wire ops)
against the JAX package's, on the CPU.

On CPU tensors the port's wrappers run their plain versions; these are held
to the JAX package's jnp twins (``_quantize_rows_ref``,
``_dequantize_rows_ref``) and to its Pallas kernels in interpret mode (on
shapes they tile: group-rows a multiple of 8, groups of 2048), with the same
numpy fp32 inputs. The wire format is bit-identical: ints and scales are
compared exactly. The dequantized sums are compared exactly too: both sides
multiply each int by its scale and add the peers in order from zero, one
IEEE rounding each, except where noted below. The cases of
``tests/test_quantized_collectives.py:42-105`` (non-divisible tail,
half-split packing, peer sum, ``wire_nbytes``) and the round-trip bounds of
``tests/test_zeropp.py:26-56`` follow.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import quant_collective as jq
from deepspeed_tpu_torch.ops import quant_collective as tq


def rows(seed, shape, special=True):
    """Normal rows, with an all-zero group-row, values of very different
    magnitudes and exact ties of round-half-to-even (x/scale = k + 0.5)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if special:
        x[1] = 0.0
        x[2] *= 1e-30
        x[3, :8] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -3.5, 6.5]   # amax 7 -> scale 1 (int4)
        x[4, :4] = [127.0, 0.5, -2.5, 126.5]                     # amax 127 -> scale 1 (int8)
    return x


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_rows_matches_jax_ref(bits):
    x = rows(0, (16, 2048))
    q, s = tq._quantize_rows_ref(torch.from_numpy(x), bits)
    qj, sj = jq._quantize_rows_ref(jnp.asarray(x), bits)
    assert q.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert tuple(q.shape) == (16, 2048 if bits == 8 else 1024)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert s[1] == 1.0                    # an all-zero group has scale 1


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_rows_matches_jax_ref(bits):
    x = rows(1, (16, 2048))
    qj, sj = jq._quantize_rows_ref(jnp.asarray(x), bits)
    got = tq._dequantize_rows_ref(torch.tensor(np.asarray(qj)), torch.tensor(np.asarray(sj)),
                                  bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq._dequantize_rows_ref(qj, sj, bits)))


def sum_bound(q, s, bits):
    """Per element, what two ways of rounding the same P products and P sums
    can differ by: each of the 2P roundings of either moves it by at most
    eps/2 times the sum over peers of |int * scale|, so 2P eps times that
    sum."""
    P, G = s.shape
    per = torch.stack([tq._dequantize_rows_ref(q[p].reshape(G, -1), s[p], bits).abs()
                       for p in range(P)])
    return (2 * P * torch.finfo(torch.float32).eps * per.sum(0)).reshape(-1)


# The Pallas kernels in interpret mode are compiled by XLA's CPU backend,
# which rewrites ``amax / qmax`` as a product with the reciprocal of the
# constant (a scale one ulp off, in a few int4 groups) and contracts the
# kernel's ``acc += vals * scale`` into a fused multiply-add. The jnp twins
# run eagerly, one IEEE rounding per operation, as the port's plain versions
# and CUDA kernels do (``__fdiv_rn``, ``__fmul_rn``, ``__fadd_rn``). So the
# port is held exactly to the jnp twins, and to the interpret-mode kernels
# with exact ints, scales within one ulp, and sums within the difference of
# those roundings.

@pytest.mark.parametrize("bits", [8, 4])
def test_block_ops_match_pallas_interpret(bits):
    """[8, 4096]: 16 group-rows of 2048, which the Pallas kernels tile."""
    x = rows(2, (8, 4096))
    q, s = tq.block_quantize(torch.from_numpy(x), num_bits=bits, group_size=2048)
    qk, sk = jq.block_quantize(jnp.asarray(x), num_bits=bits, group_size=2048,
                               interpret=True)
    qj, sj = jq.block_quantize(jnp.asarray(x), num_bits=bits, group_size=2048,
                               interpret=False)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qk))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(sk), maxulp=1)
    # dequantize (the reduce kernel with one peer) of the same wire
    deq = tq.block_dequantize(q, s, num_bits=bits, group_size=2048, out_len=4000)
    deq_k = jq.block_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                num_bits=bits, group_size=2048, out_len=4000,
                                interpret=True)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(deq_k))


@pytest.mark.parametrize("bits", [8, 4])
def test_peer_sum_matches_pallas_interpret_on_tiled_peers(bits):
    """4 peers of 8 groups each (each peer's [8, 2048] tiles the Pallas
    grid): the fused dequantize + sum of one wire."""
    x = rows(3, (4, 8 * 2048), special=False)
    q, s = tq.block_quantize(torch.from_numpy(x), num_bits=bits, group_size=2048)
    got = tq.block_dequantize_reduce(q, s, num_bits=bits, group_size=2048)
    wire = (jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    twin = jq.block_dequantize_reduce(*wire, num_bits=bits, group_size=2048, interpret=False)
    kern = jq.block_dequantize_reduce(*wire, num_bits=bits, group_size=2048, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(twin))
    diff = (got - torch.tensor(np.asarray(kern))).abs()
    assert bool((diff <= sum_bound(q, s, bits)).all())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("P", [3, 8])
def test_peer_sum_matches_pallas_interpret_at_3_and_8_peers(P, bits):
    """3 and 8 peers of 8 groups each (the CUDA kernel's peer counts are a
    template argument, 1 to 8): the fused dequantize + sum of one wire,
    with a ragged ``out_len``."""
    x = rows(7 + P, (P, 8 * 2048), special=False)
    q, s = tq.block_quantize(torch.from_numpy(x), num_bits=bits, group_size=2048)
    got = tq.block_dequantize_reduce(q, s, num_bits=bits, group_size=2048)
    wire = (jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    twin = jq.block_dequantize_reduce(*wire, num_bits=bits, group_size=2048, interpret=False)
    kern = jq.block_dequantize_reduce(*wire, num_bits=bits, group_size=2048, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(twin))
    diff = (got - torch.tensor(np.asarray(kern))).abs()
    assert bool((diff <= sum_bound(q, s, bits)).all())
    cut = tq.block_dequantize_reduce(q, s, num_bits=bits, group_size=2048, out_len=7 * 2048 + 36)
    np.testing.assert_array_equal(cut.numpy(), np.asarray(jq.block_dequantize_reduce(
        *wire, num_bits=bits, group_size=2048, out_len=7 * 2048 + 36, interpret=False)))


@pytest.mark.parametrize("bits", [8, 4])
def test_group_4096_matches_jax(bits):
    """Groups of 4096 (16 KB of fp32, the CUDA stream kernels' largest
    stage): the wire of 8 group-rows and the sum of 4 peers of 8 groups
    each (shapes the Pallas kernels tile) against the jnp twins exactly and
    the interpret-mode kernels as above; 3 peers of a ragged row of
    3 x 4096 + 512 against the twins."""
    x = rows(8, (8, 4096))
    q, s = tq.block_quantize(torch.from_numpy(x), num_bits=bits, group_size=4096)
    qj, sj = jq.block_quantize(jnp.asarray(x), num_bits=bits, group_size=4096,
                               interpret=False)
    qk, sk = jq.block_quantize(jnp.asarray(x), num_bits=bits, group_size=4096,
                               interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qk))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(sk), maxulp=1)
    x = rows(11, (4, 8 * 4096), special=False)
    q, s = tq.block_quantize(torch.from_numpy(x), num_bits=bits, group_size=4096)
    got = tq.block_dequantize_reduce(q, s, num_bits=bits, group_size=4096)
    wire = (jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.block_dequantize_reduce(
        *wire, num_bits=bits, group_size=4096, interpret=False)))
    kern = jq.block_dequantize_reduce(*wire, num_bits=bits, group_size=4096, interpret=True)
    diff = (got - torch.tensor(np.asarray(kern))).abs()
    assert bool((diff <= sum_bound(q, s, bits)).all())
    ragged = rows(9, (3, 3 * 4096 + 512), special=False)
    q, s = tq.block_quantize(torch.from_numpy(ragged), num_bits=bits, group_size=4096)
    qj, sj = jq.block_quantize(jnp.asarray(ragged), num_bits=bits, group_size=4096)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    got = tq.block_dequantize_reduce(q, s, num_bits=bits, group_size=4096,
                                     out_len=ragged.shape[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.block_dequantize_reduce(
        qj, sj, num_bits=bits, group_size=4096, out_len=ragged.shape[1])))


@pytest.mark.parametrize("interpret", [False, True])
def test_bf16_input_at_8_bits_matches_jax(interpret):
    """bf16 payload rows on the int8 wire (the expert-parallel dispatch's
    format): the port's wire from bf16 against the JAX package's from the
    same bf16 values, and each row read back (``block_dequantize``) exactly
    against the twin of the same wire. The jnp twins give the same ints and
    scales; the Pallas kernels in interpret mode scales within one ulp (see
    above), and the ints the port's arithmetic gives with those scales."""
    xb = torch.from_numpy(rows(10, (8, 2 * 2048 + 8))).bfloat16()
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    q, s = tq.block_quantize(xb, num_bits=8)
    qj, sj = jq.block_quantize(xj, num_bits=8, interpret=interpret)
    if interpret:
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(sj), maxulp=1)
        padded, _, _ = tq._prep_rows(xb, 2048)
        scales = torch.tensor(np.asarray(sj)).reshape(-1, 1)
        want = torch.clamp(torch.round(padded / scales), -127, 127).to(torch.int8)
        np.testing.assert_array_equal(np.asarray(qj), want.reshape(q.shape).numpy())
    else:
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    back = tq.block_dequantize(q, s, num_bits=8, out_len=xb.shape[1], dtype=torch.bfloat16)
    want = jq.block_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), num_bits=8,
                               out_len=xb.shape[1], dtype=jnp.bfloat16, interpret=False)
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("bits", [8, 4])
def test_block_quantize_roundtrip_nondivisible_tail(bits):
    """M=5000 with group 512: 10 groups per row, a 120-element padded tail;
    the same wire as the JAX package's."""
    x = rows(4, (16, 5000), special=False)
    q, s = tq.block_quantize(torch.from_numpy(x), num_bits=bits, group_size=512)
    assert q.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert tuple(q.shape) == ((16, 5120) if bits == 8 else (16, 2560))
    assert tuple(s.shape) == (16, 10)
    qj, sj = jq.block_quantize(jnp.asarray(x), num_bits=bits, group_size=512)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    back = tq.block_dequantize(q, s, num_bits=bits, group_size=512, out_len=5000)
    assert tuple(back.shape) == x.shape
    # symmetric round-to-nearest: error <= scale/2 per group
    bound = s.max().item() * (0.51 if bits == 8 else 0.6)
    assert (back - torch.from_numpy(x)).abs().max().item() <= bound + 1e-6


def test_int4_half_split_packing():
    """Byte j carries element j in the low nibble and element j + gs/2 in
    the high nibble."""
    vals = (np.arange(256) % 15 - 7).astype(np.float32)  # amax 7 -> scale 1
    q, s = tq.block_quantize(torch.from_numpy(vals), num_bits=4, group_size=256)
    assert s[0].item() == 1.0
    iv = vals.astype(np.int64)
    expected = ((iv[:128] & 0xF) | ((iv[128:] & 0xF) << 4)).astype(np.uint8)
    np.testing.assert_array_equal(q.numpy(), expected)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_reduce_sums_peers(bits):
    x = rows(5, (4, 1000), special=False)                 # 4 peers
    q, s = tq.block_quantize(torch.from_numpy(x), num_bits=bits, group_size=256)
    out = tq.block_dequantize_reduce(q, s, num_bits=bits, group_size=256, out_len=1000)
    per_peer = tq.block_dequantize(q, s, num_bits=bits, group_size=256, out_len=1000)
    # the peers in order from zero, one rounding per sum: exact
    want = torch.zeros(1000)
    for p in range(4):
        want = want + per_peer[p]
    assert torch.equal(out, want)
    # and it approximates the fp32 sum within the quantization budget
    np.testing.assert_allclose(out.numpy(), x.sum(axis=0), atol=(0.1 if bits == 8 else 1.0))
    qj, sj = jq.block_quantize(jnp.asarray(x), num_bits=bits, group_size=256)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jq.block_dequantize_reduce(
        qj, sj, num_bits=bits, group_size=256, out_len=1000)))


@pytest.mark.parametrize("bits,rtol", [(8, 1e-2), (4, 2e-1)])
def test_quantize_roundtrip(bits, rtol):
    """The round trip of ``tests/test_zeropp.py``'s quantizer case: every
    error within half a step of its group's scale (0.6 for int4)."""
    x = np.random.default_rng(0).normal(size=(333, 17)).astype(np.float32).reshape(-1)
    q, s = tq.block_quantize(torch.from_numpy(x), num_bits=bits, group_size=256)
    assert q.numel() == ((x.size + 255) // 256 * 256) // (2 if bits == 4 else 1)
    back = tq.block_dequantize(q[None], s[None], num_bits=bits, group_size=256,
                               out_len=x.size)[0]
    err = (back - torch.from_numpy(x)).abs().max().item()
    assert err <= s.max().item() * (0.5 if bits == 8 else 0.6) + 1e-6
    assert err <= rtol * float(np.abs(x).max()) * (7 if bits == 4 else 1)


def test_bf16_input_is_upcast():
    x = torch.from_numpy(rows(6, (3, 3000), special=False)).bfloat16()
    for bits in (8, 4):
        q, s = tq.block_quantize(x, num_bits=bits)
        q32, s32 = tq.block_quantize(x.float(), num_bits=bits)
        assert torch.equal(q, q32) and torch.equal(s, s32)


def test_wire_nbytes():
    assert tq.wire_nbytes(2048, 8, 2048) == 2048 + 4          # 1 group
    assert tq.wire_nbytes(2048, 4, 2048) == 1024 + 4          # packed half
    assert tq.wire_nbytes(2049, 8, 2048) == 2 * 2048 + 8      # padded tail
    assert tq.wire_nbytes(100, 4, 2048) == 1024 + 4
    for n, bits in ((11_272_192, 4), (1024, 4), (5000, 8)):
        assert tq.wire_nbytes(n, bits) == jq.wire_nbytes(n, bits)


def test_cpu_tensors_launch_no_kernel_and_odd_groups_raise():
    before = (tq.block_quantize.launches, tq.block_dequantize_reduce.launches)
    q, s = tq.block_quantize(torch.ones(2, 100), num_bits=4, group_size=64)
    tq.block_dequantize_reduce(q, s, num_bits=4, group_size=64)
    assert (tq.block_quantize.launches, tq.block_dequantize_reduce.launches) == before
    with pytest.raises(ValueError, match="even group_size"):
        tq.block_quantize(torch.ones(10), num_bits=4, group_size=7)
    with pytest.raises(ValueError, match="8 or 4"):
        tq.block_quantize(torch.ones(10), num_bits=2)

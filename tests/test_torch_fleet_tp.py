"""Tensor-parallel replicas in a ``ReplicaGroup`` and a ``PrefillDecodeFleet``,
idle v1 ranks, empty ``TPPlan`` shares and quantization groups a cut does
not tile, against the JAX package on the CPU.

The weights are drawn with numpy into the flax trees' shapes. The port's
side runs once per module: a fixture starts 3 processes of
``tests/test_torch_fleet_tp_worker.py`` (suite "w3") and 4 more (suite
"w4"), two gloo worlds with ``file://`` rendezvous under the test's
temporary directory, one thread each, a timeout on the whole run. The port
lays tp-2 replicas over the first 2 processes of its world (process r holds
tp rank r of every replica; the third process of "w3" is idle there), and
the JAX package places each replica on 2 of its virtual CPU devices. Both
run the same weights and inputs:

- a 1 + 1 fleet at tp 2 driven by hand on one pre-drawn token stream
  (prefill round, handoff, decode rounds), with the device codec (fp
  pools), the wire codec on int8 pools (lossless) and on fp pools
  (quantized at the wire): every round's logits against the JAX fleet's to
  2e-5 (``V2_ATOL``; the tp-2 streams of either package differ from their
  tp-1 streams at near-ties, ROADMAP §C, so a pre-drawn stream is held
  instead of greedy tokens); each rank's shipped rows against its source
  rows, and against its heads of the tp-1 wire round trip of the whole
  pages; the transport's counts against the JAX transport's;
- a 2-replica ``ReplicaGroup`` at tp 2 on the same rounds against JAX's;
- the scheduler-driven fleet at tp 2 against a one-replica group at tp 2
  (greedy streams bit-exact), a scale-up onto the spare slot and a lost
  decode replica, whose followers build and drop their shares;
- a v1 grid (1, 2) in the world of 3: the same logits and tokens on every
  rank, bitwise, the idle rank holding no weights (mirrors
  ``tests/test_inference.py::test_replica_clamping``), and the port's tp-1
  engine to ``V1_TOL`` (the v1 engine's own JAX parity at tp is
  ``tests/test_torch_tensor_parallel.py``'s);
- an HF directory loaded by ``init_inference`` at tp 2 with 8-bit weights:
  bitwise the whole model's quantized at tp 2;
- 2 query heads at tp 4 (ranks 2 and 3 hold empty shares): v2 rounds
  against JAX ``build_replica(tp_size=4)`` to 2e-5, and v1 logits
  (unquantized and 8-bit) against the port's tp-1 engine.

``cut_quantized`` (a padded last group at 8 bits, wrapped 4-, 6- and 12-bit
groups) is held in this process: a rank's part dequantizes to the same bits
as the whole tensor's slice.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2.fleet.disagg import KVPageTransport as JaxTransport
from deepspeed_tpu.inference.v2.replica_group import build_replica as jax_build_replica
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.inference.quantization.quantization import (QuantizedParameter,
                                                                     QuantizedPart,
                                                                     cut_quantized)
from chip_smoke import shipped_rows_equal
from deepspeed_tpu_torch.inference.v2.fleet import wire
from deepspeed_tpu_torch.parallel.tensor_parallel import take_spans

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_fleet_tp_worker.py")
SUITES = {"w3": 3, "w4": 4}
RUN_TIMEOUT_S = 240
V1_TOL = dict(atol=2e-4, rtol=2e-3)
V2_ATOL = 2e-5
H2 = dict(num_attention_heads=2, num_key_value_heads=2)
PREFILL = (11, 17, 5)           # the fleet's prompt lengths
ENG = {"state_manager": {"max_ragged_sequence_count": 9, "max_ragged_batch_size": 64,
                         "max_context": 96, "num_kv_blocks": 96},
       "kv_cache": {"block_size": 8, "cache_dtype": "fp32"}}


def jcfg(**kw):
    cfg = JaxLlamaConfig.tiny(scan_layers=True, remat=False, dtype=jnp.float32)
    return dataclasses.replace(cfg, head_dim=None, **kw) if kw else cfg


def numpy_params(model, seed):
    """The flax tree's shapes (``jax.eval_shape``, no compile) filled from
    numpy: N(0, 0.02) for every matrix, ones for norm scales."""
    ids = np.zeros((1, 8), np.int32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), {"input_ids": ids}))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if "scale" in jax.tree_util.keystr(path):
            return np.ones(leaf.shape, np.float32)
        return (0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


def flax_params(cfg):
    return numpy_params(JaxLlama(cfg), 0)


def make_inputs():
    rng = np.random.default_rng(20)

    def toks(n):
        return rng.integers(0, 512, n).astype(np.int32)

    prefill = [(u, toks(n)) for u, n in zip((1, 2, 3), PREFILL)]
    decode = [[(u, toks(1)) for u in (1, 2, 3)] for _ in range(4)]
    rounds = [[(1, toks(11)), (2, toks(17)), (3, toks(5)), (4, toks(9))]] + \
        [[(u, toks(1)) for u in (1, 2, 3, 4)] for _ in range(3)]
    return {"llama_params": flax_params(jcfg()), "h2_params": flax_params(jcfg(**H2)),
            "h2_cfg": H2, "fleet_rounds": [prefill] + decode, "rounds": rounds,
            "served": {u: toks(n) for u, n in ((0, 13), (1, 30), (2, 7))},
            "v1_ids": rng.integers(0, 512, (4, 8)).astype(np.int32)}


def port_v1_logits(inp, params, cfg, quant=False):
    """The port's v1 engine alone (tp 1) on the worker's weights."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as port_llama
    config = port_llama.LlamaConfig.tiny(dtype=torch.float32)
    if cfg:
        config = dataclasses.replace(config, head_dim=None, **cfg)
    model = port_llama.LlamaForCausalLM(config)
    model.load_state_dict(port_llama.params_from_flax(inp[params]))
    conf = {"dtype": "fp32"}
    if quant:
        conf["quant"] = {"enabled": True, "bits": 8, "group_size": 16}
    eng = deepspeed_tpu_torch.init_inference(model.requires_grad_(False), config=conf,
                                             device="cpu")
    return eng(inp["v1_ids"]).numpy()


def eng_config(kv_dtype="fp"):
    return dict(ENG, state_manager=dict(ENG["state_manager"], kv_dtype=kv_dtype))


def jput(mesh, engine, batch):
    with mesh:
        return np.asarray(engine.put([u for u, _ in batch],
                                     [np.asarray(t, np.int32) for _, t in batch]))


def jax_runs(inp):
    """The JAX side: a tp-2 replica on 2 of the virtual devices for each
    pool dtype (the fleet's device codec and int8 wire leg are exact, so the
    monolithic replica's rounds are theirs; the group's replicas run their
    halves of the rounds on it under other uids), the JAX fleet's lossy
    bf16-pool wire leg, and the engines at tp 4."""
    devices = jax.devices()
    model = JaxLlama(jcfg())
    out = {}
    rounds = inp["fleet_rounds"]
    for key, kv in (("fleet_device_fp", "fp"), ("fleet_wire_int8", "int8")):
        m, s = jax_build_replica(model, inp["llama_params"], devices[:2], tp_size=2,
                                 engine_config=eng_config(kv), token_budget=48)
        codec = "device" if kv == "fp" else "wire"
        out[key] = {"logits": [jput(m, s.engine, batch) for batch in rounds],
                    "page_wire_cost": JaxTransport(codec=codec).page_wire_cost(s.engine)}
        if kv == "fp":
            out["group_rounds"] = [
                [jput(m, s.engine, [(u + 10 * (r + 1), t) for i, (u, t) in enumerate(batch)
                                    if i % 2 == r]) for batch in inp["rounds"]]
                for r in range(2)]
    (pm, ps), (dm, ds) = [jax_build_replica(model, inp["llama_params"], devices[i:i + 2],
                                            tp_size=2, engine_config=eng_config("fp"),
                                            token_budget=48) for i in (0, 2)]
    logits = [jput(pm, ps.engine, rounds[0])]
    transport = JaxTransport(codec="wire")
    transport.ship_many([u for u, _ in rounds[0]], ps.engine, ds.engine)
    logits += [jput(dm, ds.engine, batch) for batch in rounds[1:]]
    out["fleet_wire_fp"] = {"logits": logits, "stats": transport.stats(),
                            "page_wire_cost": transport.page_wire_cost(ps.engine)}
    h2 = JaxLlama(jcfg(**H2))
    m, s = jax_build_replica(h2, inp["h2_params"], devices[:4], tp_size=4, engine_config=ENG,
                             token_budget=48)
    out["h2_v2"] = [jput(m, s.engine, batch) for batch in inp["rounds"]]
    # the v1 engines at tp: the port's tp 1 logits (the v1 engine's
    # parity with the JAX engine is tests/test_torch_inference.py's, its tp
    # parity tests/test_torch_tensor_parallel.py's)
    out["v1_tp1"] = port_v1_logits(inp, "llama_params", {})
    out["h2_v1_tp1"] = port_v1_logits(inp, "h2_params", H2)
    out["h2_v1_int8_tp1"] = port_v1_logits(inp, "h2_params", H2, quant=True)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX results, {suite: [each rank's results]}, seconds): the port's
    ranks run while the JAX engines run here."""
    tmp = tmp_path_factory.mktemp("fleet_tp")
    inp = make_inputs()
    inputs = tmp / "inputs.pt"
    torch.save(inp, inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for suite, world in SUITES.items():
        (tmp / suite).mkdir()
        procs[suite] = [
            subprocess.Popen([sys.executable, WORKER, suite, str(r), str(world),
                              str(tmp / f"rdv_{suite}"), str(inputs),
                              str(tmp / suite / f"out{r}.pt")],
                             stdout=open(tmp / suite / f"log{r}.txt", "w"),
                             stderr=subprocess.STDOUT, env=env)
            for r in range(world)]
    start = time.perf_counter()
    want = jax_runs(inp)
    for suite, ps in procs.items():
        for r, p in enumerate(ps):
            left = RUN_TIMEOUT_S - (time.perf_counter() - start)
            try:
                rc = p.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                pytest.fail(f"{suite} rank {r} timed out")
            assert rc == 0, (tmp / suite / f"log{r}.txt").read_text()[-4000:]
    got = {s: [torch.load(tmp / s / f"out{r}.pt", weights_only=False) for r in range(w)]
           for s, w in SUITES.items()}
    return want, got


FLEETS = ["fleet_device_fp", "fleet_wire_int8", "fleet_wire_fp"]


@pytest.mark.parametrize("key", FLEETS)
def test_fleet_logits_round_by_round_match_jax(run, key):
    want, got = run
    mine = got["w3"][0][key]
    assert len(mine["logits"]) == len(want[key]["logits"]) == 5
    for a, b in zip(mine["logits"], want[key]["logits"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=V2_ATOL)


@pytest.mark.parametrize("key", FLEETS)
def test_fleet_counts_what_the_jax_fleet_counts(run, key):
    """Whole pages, every KV head once (the JAX pools are replicated over
    the submesh): each page's wire cost as the JAX transport prices it, and
    the shipped bytes of that many whole pages; against the JAX fleet's own
    ship on the bf16 wire leg, pages and handoffs too (a wire frame's
    headers are rank 0's). The latency covers the follower's leg."""
    want, got = run
    mine, theirs = got["w3"][0][key], want[key]
    assert mine["page_wire_cost"] == theirs["page_wire_cost"]
    st = mine["stats"]
    assert st["pages_shipped"] == st["pages_bound"] == sum(-(-n // 8) for n in PREFILL)
    page = mine["page_wire_cost"] if key == "fleet_wire_int8" else \
        2 * 2 * 2 * 8 * 16 * 4                 # K and V, 2 layers, 2 heads, 8 x 16 fp32
    assert st["bytes_shipped"] == st["pages_shipped"] * page
    if key == "fleet_device_fp":
        assert st["wire_bytes_shipped"] == st["bytes_shipped"]
    if key == "fleet_wire_fp":
        # the JAX transfer pads its gathered rows to a power of two; the
        # port ships the real rows
        jst = theirs["stats"]
        for k in ("handoffs", "transfers", "pages_shipped", "pages_bound"):
            assert st[k] == jst[k], k
        padded = 1 << (st["pages_shipped"] - 1).bit_length()
        assert st["bytes_shipped"] * padded == jst["bytes_shipped"] * st["pages_shipped"]
    assert st["copied_kv_bytes"] == 0      # 2 KV heads, one a rank
    # the handoff's latency waits for the follower's leg, which it reports
    assert 0 < st["follower_legs_s"] <= st["total_s"]


def _heads(spans, head_dim):
    return [a // head_dim + i for a, b in spans for i in range((b - a) // head_dim)]


def _valid(run):
    """The shipped rows' token counts (the prompts' blocks of 8; the decode
    rounds write past them afterwards)."""
    return [min(8, n - 8 * j) for n in PREFILL for j in range(-(-n // 8))]


@pytest.mark.parametrize("key", FLEETS)
def test_each_rank_ships_its_own_heads(run, key):
    """Each rank's destination rows: its source rows bit for bit (device
    codec; int8 pools over the wire), or, on the lossy wire leg, its heads
    of the tp-1 wire round trip of the whole pages (one group per token
    row over head_dim, so a rank's frame is its heads of the tp-1 frame)."""
    _, got = run
    ranks = got["w3"][:2]
    valid = _valid(run)
    assert all("dst_rows" in r[key] for r in ranks) and "dst_rows" not in got["w3"][2][key]
    if key != "fleet_wire_fp":
        for r in ranks:
            for a, b in zip(r[key]["src_rows"], r[key]["dst_rows"]):
                for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                    assert shipped_rows_equal(x, y, valid)
        return
    hd = ranks[0][key]["src_rows"][0].shape[-1]
    slots = [_heads(r[key]["kv_slots"], hd) for r in ranks]
    whole = []
    for part in (0, 1):
        L, n, _, bs, _ = ranks[0][key]["src_rows"][part].shape
        full = torch.zeros(L, n, 2, bs, hd)
        for r, s in zip(ranks, slots):
            full[:, :, s] = r[key]["src_rows"][part]
        whole.append(full)
    frame = wire.encode_handle({"n": whole[0].shape[1], "k": whole[0], "v": whole[1],
                                "seqs": []})
    back = wire.decode_frame(frame, "cpu")
    for r, s in zip(ranks, slots):
        for part, name in ((0, "k"), (1, "v")):
            assert shipped_rows_equal(r[key]["dst_rows"][part], back[name][:, :, s], valid)


def test_replica_group_rounds_match_jax(run):
    want, got = run
    for mine, theirs in zip(got["w3"][0]["group_rounds"], want["group_rounds"]):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a, b, rtol=0, atol=V2_ATOL)
    assert got["w3"][1]["group_rounds"] is None and got["w3"][2]["group_rounds"] is None


def test_served_fleet_equals_the_monolithic_tp2_replica(run):
    """Greedy streams bit-exact against a one-replica group at tp 2 on the
    same ranks; no page leaks; after a scale-up and a lost decode replica
    the streams are the same and the follower holds the prefill share and
    the new replica's (the lost one's dropped)."""
    _, got = run
    served = got["w3"][0]["served"]
    assert served["fleet"] == served["group"] and served["census"] == 0
    assert served["after_loss"] == served["group"]
    assert served["scaled_to"] == 1
    assert got["w3"][1]["served"]["follower_tags"] == [0, 2]
    assert got["w3"][2]["served"]["follower_tags"] == []


def test_idle_v1_rank_returns_the_grid_results(run):
    """World 3, grid (1, 2): logits and tokens bitwise the same on all three
    ranks, the idle one holding no weights; the logits are the JAX tp-2
    engine's (``test_replica_clamping``: the grid is within the world)."""
    want, got = run
    ranks = got["w3"]
    assert [r["idle_grid"] for r in ranks] == [{"dp": 1, "tp": 2}] * 3
    assert [r["idle"] for r in ranks] == [False, False, True]
    assert ranks[2]["idle_weights"] == 0 and ranks[0]["idle_weights"] > 0
    for key in ("idle_logits", "idle_greedy", "idle_sampled"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key])
    np.testing.assert_allclose(ranks[0]["idle_logits"], want["v1_tp1"], **V1_TOL)


def test_hf_directory_quantized_at_tp(run):
    """``init_inference`` of an HF directory at tp 2 with 8-bit weights: the
    same codes, scales and logits as the whole model quantized at tp 2, and
    each rank holds its share's bytes only (no part a view of a whole
    tensor), loaded or cut from the whole model."""
    _, got = run
    for r in got["w3"]:
        np.testing.assert_array_equal(r["hfq_loaded"], r["hfq_whole"])
    for r in got["w3"][:2]:
        assert r["hfq_same_bits"]
        for held, share in r["hfq_held"]:
            assert held == share
        assert set(r["hfq_impls"].values()) == {"dense_dequant"}   # fp32 serving


def test_empty_tp_shares_match_jax(run):
    """2 query heads at tp 4: ranks 2 and 3 hold no heads and no KV pool
    heads; v2 rounds and v1 logits (unquantized and 8-bit) against the JAX
    engines at tp 4."""
    want, got = run
    ranks = got["w4"]
    assert ranks[0]["plan"] == [(1, 1), (1, 1), (0, 0), (0, 0)]
    assert [r["pool_heads"] for r in ranks] == [1, 1, 0, 0]
    for a, b in zip(ranks[0]["v2"], want["h2_v2"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=V2_ATOL)
    for r in ranks:
        np.testing.assert_allclose(r["v1"], want["h2_v1_tp1"], **V1_TOL)
        np.testing.assert_allclose(r["v1_int8"], want["h2_v1_int8_tp1"], **V1_TOL)
        np.testing.assert_array_equal(r["v1_greedy"], ranks[0]["v1_greedy"])


@pytest.mark.parametrize("bits,shape", [(8, (24, 40)), (4, (6, 20)), (6, (6, 20)),
                                        (12, (6, 20))])
def test_cut_quantized_keeps_the_whole_tensors_bits(bits, shape):
    """A padded last group (8 bits, N 40 in groups of 16) and flat groups
    that wrap rows (4, 6, 12 bits, 20 columns in groups of 16): every
    rank's part of a 2- and 3-way cut, along either dimension, dequantizes
    to the same bits as the whole tensor's slice."""
    w = torch.randn(*shape, generator=torch.Generator().manual_seed(bits))
    qp = QuantizedParameter.from_tensor(w, bits, 16)
    whole = qp.dequantized(torch.float32)
    for dim in (0, 1):
        n = shape[dim]
        for cuts in ([(0, n // 2), (n // 2, n)], [(0, 1), (1, n - 1), (n - 1, n)]):
            for span in cuts:
                part = cut_quantized(qp, dim, [span])
                assert torch.equal(part.dequantized(torch.float32),
                                   take_spans(whole, dim, [span]))
    assert isinstance(cut_quantized(qp, 1, [(0, 3)]), QuantizedPart)


class _Plan:
    """A ``TPPlan`` stand-in: one weight's ``(dim, spans)``."""

    def __init__(self, spans):
        self.spans = spans

    def spans_of(self, name):
        return self.spans


@pytest.mark.parametrize("name,shape,spans", [
    ("mlp.up_proj", (40, 12), (0, [(0, 16), (16, 32)])),   # out split in whole groups
    ("self_attn.k_proj", (40, 12), (0, [(8, 12)])),        # a KV head inside a group
    ("self_attn.k_proj", (40, 12), (0, [(8, 12), (24, 28)])),
    ("mlp.up_proj", (40, 12), (0, [(32, 40)])),            # the padded last group
    ("mlp.up_proj", (40, 12), (0, [])),                    # an empty share
    ("mlp.down_proj", (12, 40), (1, [(5, 20)])),           # in split: rows of [K, N]
    ("lm_head", (24, 40), (0, [(12, 24)])),                # raw, vocab rows
    ("lm_head", (24, 40), (1, [(3, 21)])),                 # raw, inside its groups
    ("mlp.up_proj", (40, 12), None),                       # replicated
])
def test_quantized_part_is_the_whole_tensors_cut(name, shape, spans, monkeypatch):
    """``quantized_part`` at 8 bits quantizes only the groups a rank's part
    falls in, in blocks of rows (here of 2 or 3 rows); its codes and scales
    are still those of the whole tensor quantized (``from_tensor``) and cut
    (``cut_quantized``), bit for bit."""
    from deepspeed_tpu_torch.inference.quantization import quantization
    from deepspeed_tpu_torch.inference.quantization.quantization import (RAW_WEIGHTS,
                                                                         quantized_part)
    w = torch.randn(*shape, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    raw = name in RAW_WEIGHTS
    whole = QuantizedParameter.from_tensor(w if raw else w.T.contiguous(), 8, 16)
    want = whole if spans is None else cut_quantized(whole, spans[0] if raw else 1 - spans[0],
                                                     spans[1])
    monkeypatch.setattr(quantization, "LASTDIM_CHUNK", 100)
    got = quantized_part(name, w, _Plan(spans), group_size=16, impl="dense_dequant").qp
    assert type(got) is type(want) and got.shape == want.shape
    if isinstance(want, QuantizedPart):
        assert torch.equal(got.q, want.q)
    else:
        assert torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)
    assert torch.equal(got.dequantized(torch.float32), want.dequantized(torch.float32))

"""The overlap schedule and the overlap report of the port against the JAX
package: the mirror of ``tests/test_overlap_schedule.py`` and
``tests/test_overlap.py``.

- The planner (``runtime/zero/overlap_schedule.py``): every case on the
  same inventories (given seconds), the port's timelines, exposures,
  rankings and reports equal to the JAX package's.
- ``QgzPlan._bucketize``, ``moe_chunked_scan`` against a direct loop, the
  config's defaults.
- The engine under ``overlap.schedule`` on 4 gloo ranks (one launch of
  ``tests/test_torch_overlap_worker.py`` for the module): 10 optimizer
  steps of ZeRO-3 + qgZ with prefetch and grad buckets equal (``==``) to
  the unscheduled run, in fp32 and in the bf16 ZeRO++ composition (qwZ +
  hpZ 2 + qgZ); a model without the streaming protocol warns, prefetches
  nothing and still takes the bucketed exchange, equal to its unscheduled
  run.
- The overlap report (``telemetry/overlap.py``): every case of
  ``tests/test_overlap.py`` on the same intervals, equal to the JAX
  module's, a ``torch.profiler`` trace of a CPU step read back, a
  synthetic CUDA trace with NCCL kernels, and ``attach_overlap`` riding
  ``summary()["overlap"]`` under the port's schema.

The JAX file's perf-gate cases (its checked-in baselines and
``scripts/perf_gate.py``), its chip-free autotuner cases and the
roofline of ``comm_roofline_seconds`` are JAX tooling: in the port they
wait for ROADMAP A15 (``fill_comm_seconds`` and ``analytic_report`` raise
naming it, held here).
"""

import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.runtime.zero import overlap_schedule as josched
from deepspeed_tpu.runtime.zero.qgz import QgzPlan as JaxQgzPlan
from deepspeed_tpu.telemetry import overlap as jov
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.models.llama import params_from_flax
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.zero import overlap_schedule as osched
from deepspeed_tpu_torch.runtime.zero.qgz import QgzPlan
from deepspeed_tpu_torch.telemetry import overlap as ov

WORLD, MICRO, GAS, T, STEPS = 4, 2, 2, 16, 10
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_overlap_worker.py")
RUN_TIMEOUT_S = 150
SCHEMA = os.path.join(os.path.dirname(ov.__file__), "summary.schema.json")

COMPUTE_S = 1e-3
COMM_OPS = [
    {"op": "all_gather", "axis": "dp", "bytes": 1 << 22, "seconds": 2e-4},
    {"op": "reduce_scatter", "axis": "dp", "bytes": 1 << 22, "seconds": 3e-4},
    {"op": "all_reduce", "axis": "dp", "bytes": 4096, "seconds": 5e-6},
]
MOE_COMPUTE_S = 6e-4
MOE_COMM_OPS = [
    {"op": "a2a_dispatch", "axis": "ep", "bytes": 1 << 21, "seconds": 2e-4},
    {"op": "a2a_combine", "axis": "ep", "bytes": 1 << 21, "seconds": 2e-4},
]


def serialized_exposed(compute_s=COMPUTE_S, comm_ops=COMM_OPS):
    att = ov.attribute(ov.analytic_intervals(compute_s, comm_ops))
    return att["totals"]["exposed_comm_s"]


def jplan(plan):
    """The JAX planner's plan with the same fields (``to_dict`` rounds the
    forward fraction)."""
    return josched.OverlapPlan(plan.prefetch_depth, plan.grad_buckets, plan.n_layers,
                               plan.fwd_fraction, plan.latency_s, plan.a2a_chunks)


# ---------------------------------------------------------------------------
# the planner, on given seconds, against the JAX package's
# ---------------------------------------------------------------------------

def test_overlap_plan_validates():
    with pytest.raises(ValueError, match="prefetch_depth"):
        osched.OverlapPlan(prefetch_depth=-1)
    with pytest.raises(ValueError, match="grad_buckets"):
        osched.OverlapPlan(grad_buckets=0)
    with pytest.raises(ValueError, match="n_layers"):
        osched.OverlapPlan(n_layers=0)
    with pytest.raises(ValueError, match="fwd_fraction"):
        osched.OverlapPlan(fwd_fraction=1.5)
    plan = osched.OverlapPlan(prefetch_depth=2, grad_buckets=4, n_layers=12)
    assert osched.OverlapPlan.from_dict(plan.to_dict()).to_dict() == plan.to_dict()
    assert plan.to_dict() == josched.OverlapPlan(prefetch_depth=2, grad_buckets=4,
                                                 n_layers=12).to_dict()


@pytest.mark.parametrize("depth,buckets", [(0, 1), (1, 1), (1, 4), (2, 2), (3, 8)])
def test_scheduled_timeline_equals_jax(depth, buckets):
    """The scheduled timeline and its exposure equal the JAX planner's."""
    plan = osched.OverlapPlan(prefetch_depth=depth, grad_buckets=buckets, n_layers=8)
    got = osched.scheduled_intervals(COMPUTE_S, COMM_OPS, plan)
    want = josched.scheduled_intervals(COMPUTE_S, COMM_OPS, jplan(plan))
    assert got == want
    assert osched.plan_exposure(COMPUTE_S, COMM_OPS, plan) == \
        josched.plan_exposure(COMPUTE_S, COMM_OPS, jplan(plan))


def test_scheduled_strictly_below_serialized():
    ser = serialized_exposed()
    plan = osched.OverlapPlan(prefetch_depth=1, grad_buckets=4, n_layers=8)
    sched = osched.plan_exposure(COMPUTE_S, COMM_OPS, plan)
    assert sched < ser and sched <= 0.7 * ser


def test_scheduled_timeline_conserves_comm():
    plan = osched.OverlapPlan(prefetch_depth=1, grad_buckets=4, n_layers=8)
    per_device = osched.scheduled_intervals(COMPUTE_S, COMM_OPS, plan)
    ivs = next(iter(per_device.values()))
    comm_total = sum(iv["end"] - iv["start"] for iv in ivs if iv["kind"] == "comm")
    orig = sum(s["seconds"] for s in COMM_OPS)
    extra_calls = plan.n_layers + plan.grad_buckets
    assert orig - 1e-12 <= comm_total <= orig + extra_calls * plan.latency_s + 1e-12
    assert not ov.validate_report(ov.overlap_report(per_device, mode="analytic"))


def test_depth_zero_is_serialized_fill():
    d0, d1 = (osched.plan_exposure(COMPUTE_S, COMM_OPS, osched.OverlapPlan(
        prefetch_depth=d, grad_buckets=1, n_layers=8)) for d in (0, 1))
    assert d1 <= d0


def test_candidate_plans_hint_seeding():
    gather_hint = [{"op": "all_gather", "axis": "dp", "potential_saving_s": 1e-4}]
    reduce_hint = [{"op": "reduce_scatter", "axis": "dp", "potential_saving_s": 1e-4}]
    for hints in (gather_hint, reduce_hint, None):
        for n in (8, 2):
            got = [p.to_dict() for p in osched.candidate_plans(hints, n_layers=n)]
            assert got == [p.to_dict() for p in josched.candidate_plans(hints, n_layers=n)]
    assert osched.candidate_plans(gather_hint)[0].prefetch_depth == max(osched.DEFAULT_DEPTHS)
    assert osched.candidate_plans(reduce_hint)[0].grad_buckets == max(osched.DEFAULT_BUCKETS)
    assert max(p.prefetch_depth for p in osched.candidate_plans(None, n_layers=2)) <= 1


def test_best_plan_minimizes_exposure():
    plan, exposed, ranking = osched.best_plan(COMPUTE_S, COMM_OPS, n_layers=8)
    jplan_, jexposed, jranking = josched.best_plan(COMPUTE_S, COMM_OPS, n_layers=8)
    assert (plan.to_dict(), exposed, ranking) == (jplan_.to_dict(), jexposed, jranking)
    assert exposed == min(r["exposed_comm_s"] for r in ranking)
    assert exposed <= serialized_exposed()


def test_scheduled_report_and_validate_schedule():
    plan = osched.OverlapPlan(prefetch_depth=1, grad_buckets=4, n_layers=8)
    rep = osched.scheduled_report({}, COMM_OPS, plan, compute_s=COMPUTE_S)
    want = josched.scheduled_report({}, COMM_OPS, jplan(plan), compute_s=COMPUTE_S,
                                    device_kind=None)
    assert rep == want
    assert not ov.validate_report(rep)
    sched = rep["schedule"]
    assert not osched.validate_schedule(sched)
    ser = sched["serialized_exposed_comm_s"]
    assert rep["exposed_comm_s"] < ser
    assert sched["exposed_reduction_fraction"] == pytest.approx(
        (ser - rep["exposed_comm_s"]) / ser, abs=1e-5)
    assert osched.validate_schedule({})
    assert osched.validate_schedule(dict(sched, comm_ops=[]))
    assert osched.validate_schedule(dict(sched, compute_s=float("nan")))


def test_unpriced_inventories_wait_for_the_autotuner():
    """Seconds pass through; pricing an entry without them, or a step
    without ``compute_s``, is the roofline of ROADMAP A15."""
    assert osched.fill_comm_seconds(COMM_OPS) == COMM_OPS
    with pytest.raises(NotImplementedError, match="A15"):
        osched.fill_comm_seconds([{"op": "all_gather", "bytes": 1 << 20}])
    plan = osched.OverlapPlan()
    with pytest.raises(NotImplementedError, match="A15"):
        osched.scheduled_report({"flops": 1e9}, COMM_OPS, plan)
    with pytest.raises(NotImplementedError, match="A15"):
        ov.analytic_report({"flops": 1e9}, COMM_OPS)
    rep = ov.analytic_report({}, COMM_OPS, compute_s=COMPUTE_S)
    assert rep["exposed_fraction"] == pytest.approx(1.0)


def test_moe_op_classes_do_not_fall_into_bucket():
    for op in ("a2a_dispatch", "a2a_combine", "all_to_all", "all_gather", "exchange", "x"):
        assert osched._op_class(op) == josched._op_class(op)
    assert osched._op_class("a2a_dispatch") == "moe_dispatch"
    assert osched._op_class("all_to_all") == "bucket"
    ivs = next(iter(osched.scheduled_intervals(MOE_COMPUTE_S, MOE_COMM_OPS,
                                               osched.OverlapPlan(n_layers=4)).values()))
    assert any(iv["kind"] == "comm" for iv in ivs)


def test_moe_chunking_against_jax():
    """a2a_chunks 1 is the serialized worst case; more chunks never expose
    more, 4 hide 30%; each exposure equals the JAX planner's."""
    ser = serialized_exposed(MOE_COMPUTE_S, MOE_COMM_OPS)
    prev = float("inf")
    for a in (1, 2, 4, 8):
        plan = osched.OverlapPlan(a2a_chunks=a)
        e = osched.moe_plan_exposure(MOE_COMPUTE_S, MOE_COMM_OPS, plan)
        assert e == josched.moe_plan_exposure(MOE_COMPUTE_S, MOE_COMM_OPS, jplan(plan))
        assert e <= prev + 1e-12
        prev = e
        if a == 1:
            assert e == pytest.approx(ser, rel=1e-6)
        if a == 4:
            assert e <= 0.7 * ser


def test_moe_plan_roundtrip_and_legacy_default():
    with pytest.raises(ValueError, match="a2a_chunks"):
        osched.OverlapPlan(a2a_chunks=0)
    plan = osched.OverlapPlan(a2a_chunks=4)
    legacy = plan.to_dict()
    legacy.pop("a2a_chunks")
    assert osched.OverlapPlan.from_dict(legacy).a2a_chunks == 1


def test_best_moe_a2a_chunks_ranking_carries_base_plan():
    base = osched.OverlapPlan(prefetch_depth=2, grad_buckets=4)
    plan, exposed, ranking = osched.best_moe_a2a_chunks(MOE_COMPUTE_S, MOE_COMM_OPS,
                                                        base_plan=base)
    jp, je, jr = josched.best_moe_a2a_chunks(MOE_COMPUTE_S, MOE_COMM_OPS,
                                             base_plan=jplan(base))
    assert (plan.to_dict(), exposed, ranking) == (jp.to_dict(), je, jr)
    assert plan.prefetch_depth == 2 and plan.grad_buckets == 4


def test_moe_scheduled_report_and_validate_schedule():
    plan = osched.OverlapPlan(a2a_chunks=4)
    rep = osched.moe_scheduled_report({}, MOE_COMM_OPS, plan, compute_s=MOE_COMPUTE_S)
    assert rep == josched.moe_scheduled_report({}, MOE_COMM_OPS, jplan(plan),
                                               compute_s=MOE_COMPUTE_S, device_kind=None)
    sched = rep["schedule"]
    assert not ov.validate_report(rep) and not osched.validate_schedule(sched)
    assert rep["exposed_comm_s"] < sched["serialized_exposed_comm_s"]
    assert osched.validate_schedule(dict(sched, a2a_chunks=0))
    assert osched.validate_schedule(dict(sched, a2a_chunks=True))


@pytest.mark.parametrize("sizes,k", [
    ([100, 1, 1, 100, 1, 1, 100, 1], 3), ([1.0, 2.0], 8), ([1.0, 100.0, 1.0], 3),
    ([5.0], 1), ([4, 4, 4, 4, 4, 4], 4), ([1, 2, 3, 4, 5, 6, 7, 8, 9], 2)])
def test_bucketize_equals_jax(sizes, k):
    groups = QgzPlan._bucketize(sizes, k)
    assert groups == JaxQgzPlan._bucketize(sizes, k)
    assert len(groups) == min(k, len(sizes))
    assert [j for g in groups for j in g] == list(range(len(sizes)))


def test_moe_chunked_scan_matches_direct():
    n_chunks, rows, d = 4, 8, 16
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(n_chunks, rows, d, generator=g)
    w = torch.randn(d, d, generator=g, requires_grad=True)
    calls = []

    def dispatch(c):
        calls.append(c)
        return xs[c]

    def expert_fn(r, c):
        return torch.tanh(r @ w) * (1.0 + 0.1 * c)

    want = torch.stack([expert_fn(xs[c], c) for c in range(n_chunks)])
    for depth in (0, 1, 2):
        calls.clear()
        got = osched.moe_chunked_scan(expert_fn, dispatch, n_chunks, depth=depth)
        assert torch.equal(got, want), depth
        assert sorted(calls) == list(range(n_chunks))
        if depth:
            assert calls[:depth + 1] == list(range(depth + 1))   # issued ahead of use
    y = osched.moe_chunked_scan(lambda r, c: torch.tanh(r @ w), dispatch, n_chunks)
    (y ** 2).sum().backward()
    assert torch.isfinite(w.grad).all()


def test_overlap_config_defaults():
    cfg = DeepSpeedConfig({"train_batch_size": 8})
    assert (cfg.overlap_config.schedule, cfg.overlap_config.prefetch_depth,
            cfg.overlap_config.grad_buckets) == (False, 1, 2)
    cfg = DeepSpeedConfig({"train_batch_size": 8, "overlap": {
        "schedule": True, "prefetch_depth": 2, "grad_buckets": 4}})
    assert (cfg.overlap_config.schedule, cfg.overlap_config.prefetch_depth,
            cfg.overlap_config.grad_buckets) == (True, 2, 4)
    cfg.check_supported()


# ---------------------------------------------------------------------------
# the engine under the schedule: 4 gloo ranks
# ---------------------------------------------------------------------------

LLAMA_DIMS = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=T)
SCHEDULE = {"schedule": True, "prefetch_depth": 1, "grad_buckets": 2}


def engine_config(stage=3, bf16=False, overlap=None, **zero):
    cfg = {"train_batch_size": GAS * MICRO * WORLD, "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "zero_optimization": dict({"stage": stage, "zero_quantized_gradients": True,
                                      "stage3_param_persistence_threshold": 0}, **zero)}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    if overlap:
        cfg["overlap"] = overlap
    return cfg


ZPP = dict(bf16=True, zero_hpz_partition_size=2, zero_quantized_weights=True)
CASES = {
    "qgz3": dict(model="llama", config=engine_config()),
    "qgz3_schedule": dict(model="llama", config=engine_config(overlap=SCHEDULE)),
    "qgz3_schedule_d2": dict(model="llama", config=engine_config(overlap=dict(
        SCHEDULE, prefetch_depth=2, grad_buckets=3))),
    "zpp": dict(model="llama", config=engine_config(**ZPP)),
    "zpp_schedule": dict(model="llama", config=engine_config(overlap=SCHEDULE, **ZPP)),
    "fallback_base": dict(model="masked", config=engine_config(stage=2)),
    "fallback": dict(model="masked", config=engine_config(
        stage=2, overlap={"schedule": True, "grad_buckets": 3})),
}


def make_inputs():
    from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(STEPS * GAS):
        ids = rng.integers(0, LLAMA_DIMS["vocab_size"], (MICRO * WORLD, T)).astype(np.int32)
        batches.append({"input_ids": ids, "labels": ids})
    model = JaxLlama(JaxLlamaConfig(**LLAMA_DIMS, dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]["input_ids"]))["params"]
    masked = [{"input_ids": rng.integers(0, 64, (MICRO * WORLD, T)).astype(np.int32),
               "labels": rng.integers(0, 64, (MICRO * WORLD, T)).astype(np.int32)}
              for _ in range(8 * GAS)]
    g = torch.Generator().manual_seed(3)
    return {"cases": CASES, "micro": MICRO, "llama_dims": LLAMA_DIMS,
            "llama_params": params_from_flax(jax.tree.map(np.asarray, params)),
            "llama_batches": batches, "masked_dims": (64, 32),
            "masked_params": {"embed": torch.randn(64, 32, generator=g) * 0.5,
                              "w1": torch.randn(32, 32, generator=g) * 0.5,
                              "b1": torch.randn(32, generator=g) * 0.5,
                              "head": torch.randn(32, 64, generator=g) * 0.5},
            "masked_batches": masked}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_overlap")
    torch.save(make_inputs(), d / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    logs = [open(d / f"log{r}.txt", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), str(d / "rdzv"),
                               str(d / "inputs.pt"), str(d / f"out{r}.pt")],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    deadline = time.monotonic() + RUN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD} gloo ranks did not finish in {RUN_TIMEOUT_S}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode:
            pytest.fail(f"rank {r} exited {p.returncode}:\n"
                        f"{(d / f'log{r}.txt').read_text()[-4000:]}")
    return [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("base,scheduled", [("qgz3", "qgz3_schedule"),
                                            ("qgz3", "qgz3_schedule_d2"),
                                            ("zpp", "zpp_schedule")])
def test_engine_scheduled_loss_parity(run, base, scheduled):
    """JAX ``test_engine_scheduled_loss_parity``: prefetch and buckets only
    move work, so 10 optimizer steps of the scheduled run equal (``==``)
    the unscheduled run's losses and final masters, on a live trajectory;
    the schedule prefetched on every micro-step and left nothing gathered
    after backward."""
    for rank in run:
        a, b = rank[base], rank[scheduled]
        assert a["losses"] == b["losses"]
        assert len(set(a["losses"])) > 1 and all(np.isfinite(a["losses"]))
        for name, m in a["master"].items():
            assert torch.equal(m, b["master"][name]), name
        depth = b["prefetch_depth"]
        assert depth >= 1 and a["prefetch_depth"] == 0
        # forward: the root's hook starts depth units, each layer's the next;
        # backward: each recomputed layer starts the one below it
        per_micro = (b["units"] - 1) + (b["units"] - 2)
        assert b["prefetched_units"] == per_micro * STEPS * GAS
        assert b["resident_after_backward"] == a["resident_after_backward"] == \
            [0] * (STEPS * GAS)
        assert len(b["buckets"]) == (3 if scheduled.endswith("d2") else 2)


def test_engine_fallback_without_streaming_protocol(run):
    """JAX ``test_engine_fallback_without_streaming_protocol``: a model with
    no ``streaming_plan`` logs the JAX package's warning and prefetches
    nothing; the bucketed exchange still applies and is exact."""
    for rank in run:
        base, fb = rank["fallback_base"], rank["fallback"]
        assert fb["losses"] == base["losses"]
        assert fb["prefetch_depth"] == 0 and fb["prefetched_units"] == 0
        assert len(fb["buckets"]) == 3
        assert any("param prefetch disabled" in w for w in fb["warnings"])


# ---------------------------------------------------------------------------
# the overlap report (mirror of tests/test_overlap.py)
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    telemetry.configure(enabled=False, jsonl_path="", chrome_trace_path="")
    yield
    telemetry.close()
    telemetry.reset()
    telemetry.configure(enabled=False, jsonl_path="", chrome_trace_path="")


def _dev(*ivs):
    return {"d0": list(ivs)}


def _compute(mod, start, end, name="matmul", device="d0", stream=0):
    return mod.make_interval(name, start, end, kind="compute", device=device, stream=stream)


def _comm(mod, start, end, op="all_reduce", axis="dp", nbytes=1 << 20, device="d0",
          stream=0, **kw):
    return mod.make_interval(f"comm:{op}", start, end, kind="comm", op=op, axis=axis,
                             nbytes=nbytes, device=device, stream=stream, **kw)


def both(build):
    """``build(module)`` with the port's module and with the JAX package's:
    the two must be equal."""
    got, want = build(ov), build(jov)
    assert got == want
    return got


def test_segment_algebra():
    union = [(0, 2), (3, 4)]
    assert ov.merge_segments([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
    assert ov.segments_length(union) == 3
    assert ov.overlap_length(1, 3.5, union) == pytest.approx(1.5)
    for a, b in ((1, 3.5), (5, 6), (0.5, 1.5)):
        assert ov.subtract_segments(a, b, union) == jov.subtract_segments(a, b, union)
    assert ov.subtract_segments(1, 3.5, union) == [(2, 3)]


@pytest.mark.parametrize("name,want", [
    ("all-reduce-start.1", "all_reduce"), ("fusion.all_gather.3", "all_gather"),
    ("reduce-scatter.2", "reduce_scatter"), ("all-to-all.7", "all_to_all"),
    ("collective-permute-done", "collective_permute"),
    ("comm:all_to_all_quant", "all_to_all_quant"), ("fusion.123", None),
    ("loop_convert_fusion", None),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "all_gather"),
    ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "reduce_scatter"),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "all_reduce"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", "all_to_all"),
    ("ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "broadcast"),
    ("flash_fwd_wgmma", None), ("quantize_warp", None)])
def test_classify_op_spellings(name, want):
    """The JAX package's spellings keep their classes (checked against its
    module); NCCL's kernel names are the collectives they run."""
    assert ov.classify_op(name) == want
    if not name.startswith("nccl"):
        assert jov.classify_op(name) == want


@pytest.mark.parametrize("case", ["overlapped", "serialized", "partial", "island",
                                  "multi_stream", "comm_vs_comm", "gap", "multi_device"])
def test_attribution_equals_jax(case):
    """Every attribution case of ``tests/test_overlap.py``: the port's
    attribution and report equal the JAX module's, and hold its numbers."""
    cases = {
        "overlapped": lambda m: _dev(_compute(m, 0.0, 10.0), _comm(m, 2.0, 5.0)),
        "serialized": lambda m: _dev(_compute(m, 0.0, 4.0), _comm(m, 4.0, 7.0)),
        "partial": lambda m: _dev(_compute(m, 0.0, 3.0), _comm(m, 2.0, 6.0)),
        "island": lambda m: _dev(_compute(m, 0.0, 3.0), _compute(m, 4.0, 5.0),
                                 _comm(m, 2.0, 6.0)),
        "multi_stream": lambda m: _dev(_compute(m, 0.0, 10.0, stream=0),
                                       _comm(m, 8.0, 12.0, stream=1)),
        "comm_vs_comm": lambda m: _dev(_comm(m, 0.0, 4.0, op="all_gather"),
                                       _comm(m, 2.0, 6.0, op="reduce_scatter")),
        "gap": lambda m: _dev(_compute(m, 0.0, 1.0), _comm(m, 2.0, 3.0)),
        "multi_device": lambda m: {
            "d0": [_compute(m, 0.0, 2.0), _comm(m, 2.0, 3.0)],
            "d1": [_compute(m, 0.0, 2.0, device="d1"), _comm(m, 0.5, 1.5, device="d1")]},
    }
    att = both(lambda m: m.attribute(cases[case](m)))
    rep = both(lambda m: m.overlap_report(cases[case](m)))
    tot = att["totals"]
    want = {"overlapped": (0.0, 3.0), "serialized": (3.0, 0.0), "partial": (3.0, 1.0),
            "island": (2.0, 2.0), "multi_stream": (2.0, 2.0), "comm_vs_comm": (8.0, 0.0),
            "gap": (1.0, 0.0), "multi_device": (1.0, 1.0)}[case]
    assert (tot["exposed_comm_s"], tot["overlapped_comm_s"]) == pytest.approx(want)
    assert not ov.validate_report(rep)
    if case == "overlapped":
        assert rep["advice"] == [] and rep["overlap_fraction"] == pytest.approx(1.0)
    if case == "island":
        assert att["comm_intervals"][0]["exposed_segments"] == [(3.0, 4.0), (5.0, 6.0)]
    if case == "gap":
        assert tot["gap_s"] == pytest.approx(1.0) and tot["step_s"] == pytest.approx(3.0)


def test_critical_path_equals_jax():
    chain = both(lambda m: m.critical_path(_dev(
        _compute(m, 0.0, 4.0), _comm(m, 4.0, 7.0, op="all_gather"),
        _compute(m, 7.0, 9.0, name="matmul2"))))
    assert [o["name"] for o in chain["ops"]] == ["matmul", "comm:all_gather", "matmul2"]
    assert (chain["length_s"], chain["exposed_comm_s"]) == pytest.approx((9.0, 3.0))
    hidden = both(lambda m: m.critical_path(_dev(_compute(m, 0.0, 10.0),
                                                 _comm(m, 1.0, 3.0))))
    assert [o["name"] for o in hidden["ops"]] == ["matmul"]
    last = both(lambda m: m.critical_path({"d0": [_compute(m, 0.0, 2.0)],
                                           "d1": [_compute(m, 0.0, 5.0, device="d1")]}))
    assert last["device"] == "d1"
    assert ov.critical_path({}) == jov.critical_path({})


def test_rollup_joins_comm_stats_wire_bytes():
    stats = {("all_to_all_quant", "dp"): [2, 999, 0.01, 1.0, 1.0, 555]}
    nested = {"all_to_all_quant": {"dp": {"count": 2, "bytes": 999, "wire_bytes": 555}}}
    for s in (stats, nested):
        rep = both(lambda m: m.overlap_report(
            _dev(_compute(m, 0.0, 1.0), _comm(m, 1.0, 2.0, op="all_to_all_quant", nbytes=0)),
            comm_stats=s))
        assert rep["collectives"][0]["bytes"] == 999
        assert rep["collectives"][0]["wire_bytes"] == 555


def test_advisor_names_adjacent_compute():
    rep = both(lambda m: m.overlap_report(_dev(_compute(m, 0.0, 4.0), _comm(m, 4.0, 7.0))))
    a = rep["advice"][0]
    assert (a["op"], a["axis"]) == ("all_reduce", "dp")
    assert a["potential_saving_s"] == pytest.approx(3.0) and "prefetch" in a["hint"]
    assert both(lambda m: m.overlap_report(_dev(_comm(m, 0.0, 3.0))))["advice"] == []


def _chrome_events():
    return [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:TPU:0 (pf)"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "python main thread"}},
        {"ph": "X", "name": "fusion.1", "pid": 1, "tid": 0, "ts": 0, "dur": 1000},
        {"ph": "X", "name": "all-reduce-start.2", "pid": 1, "tid": 1, "ts": 500,
         "dur": 1000, "args": {"axis": "dp", "bytes": 4096}},
        {"ph": "X", "name": "python_dispatch", "pid": 2, "tid": 0, "ts": 0, "dur": 50000},
        {"ph": "C", "name": "counter", "pid": 1, "ts": 0, "args": {"v": 1}},
        {"ph": "i", "name": "marker", "pid": 1, "ts": 10},
    ]


def test_intervals_from_trace_device_filter_and_units():
    per = both(lambda m: m.intervals_from_trace(_chrome_events()))
    assert list(per) == ["/device:TPU:0 (pf)"]
    rep = ov.overlap_report(per)
    assert (rep["compute_s"], rep["comm_s"], rep["exposed_comm_s"]) == \
        pytest.approx((1e-3, 1e-3, 0.5e-3))
    c = rep["collectives"][0]
    assert (c["op"], c["axis"], c["bytes"]) == ("all_reduce", "dp", 4096)
    assert both(lambda m: m.intervals_from_trace(
        [{"ph": "X", "name": "op", "pid": 7, "tid": 0, "ts": 0, "dur": 100}])) == \
        {"pid:7": [ov.make_interval("op", 0.0, 1e-4, device="pid:7")]}


def test_intervals_from_torch_profiler_cuda_events():
    """A ``torch.profiler`` trace's shape: host lanes (``cpu_op``,
    ``cuda_runtime``) drop out; the kernels form one timeline per card from
    ``args.device`` and ``args.stream``; an NCCL all-gather on stream 30
    half under a GEMM on stream 7 is half exposed."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 4242, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 1,
         "ts": 0, "dur": 5000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242,
         "tid": 1, "ts": 1, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16bf16_bf16f32", "pid": 0,
         "tid": 7, "ts": 100, "dur": 1000, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel",
         "name": "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
         "pid": 0, "tid": 30, "ts": 600, "dur": 1000, "args": {"device": 0, "stream": 30}},
        {"ph": "X", "cat": "kernel", "name": "quantize_warp", "pid": 1, "tid": 7,
         "ts": 0, "dur": 10, "args": {"device": 1, "stream": 7}},
    ]
    per = ov.intervals_from_trace(events)
    assert sorted(per) == ["cuda:0", "cuda:1"]
    assert {iv["stream"] for iv in per["cuda:0"]} == {7, 30}
    rep = ov.overlap_report({"cuda:0": per["cuda:0"]})
    assert rep["comm_s"] == pytest.approx(1e-3)
    assert rep["exposed_comm_s"] == pytest.approx(0.5e-3)
    assert rep["collectives"][0]["op"] == "all_gather"


def test_profile_train_busy_is_union_over_streams():
    """``profile_train``'s device busy time is the union of the card's
    intervals: the NCCL all-gather half under the GEMM adds only its
    exposed half (1.5 ms busy, where the summed kernels read 2 ms), and the
    other card's kernel nothing."""
    from deepspeed_tpu_torch.tools.profile_train import overlap_summary
    events = [
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16bf16_bf16f32", "pid": 0,
         "tid": 7, "ts": 100, "dur": 1000, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel",
         "name": "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
         "pid": 0, "tid": 30, "ts": 600, "dur": 1000, "args": {"device": 0, "stream": 30}},
        {"ph": "X", "cat": "kernel", "name": "quantize_warp", "pid": 1, "tid": 7,
         "ts": 1700, "dur": 10, "args": {"device": 1, "stream": 7}},
    ]

    class Trace:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    got = overlap_summary(Trace(), 0)
    assert got["busy_s"] == pytest.approx(1.5e-3)
    assert got["step_s"] == pytest.approx(1.5e-3) and got["gap_s"] == pytest.approx(0.0)
    assert got["classes"]["all_gather"]["exposed_s"] == pytest.approx(0.5e-3)


def test_torch_profiler_trace_read_back(tmp_path):
    """A ``torch.profiler`` capture of a CPU step, exported as a Chrome
    trace, loads and folds into a timeline with compute and no comm."""
    w = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.tanh(torch.randn(32, 64) @ w).sum()
    path = tmp_path / "step.pt.trace.json"
    prof.export_chrome_trace(str(path))
    events = ov.load_trace_events(str(tmp_path))
    per = ov.intervals_from_trace(events)
    rep = ov.overlap_report(per)
    assert rep["compute_s"] > 0 and rep["comm_s"] == 0.0
    assert not ov.validate_report(rep)


def test_load_trace_events_file_gz_and_dir(tmp_path):
    events = _chrome_events()
    plain = tmp_path / "t.json"
    plain.write_text(json.dumps({"traceEvents": events}))
    assert len(ov.load_trace_events(str(plain))) == len(events)
    gz = tmp_path / "t2.json.gz"
    with gzip.open(gz, "wt") as f:
        json.dump(events, f)
    assert len(ov.load_trace_events(str(gz))) == len(events)
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    assert len(ov.load_trace_events(str(tmp_path))) == len(events)
    with pytest.raises(FileNotFoundError):
        ov.load_trace_events(str(tmp_path / "plugins" / "profile" / "empty"))


def test_intervals_from_jsonl_records():
    records = [{"kind": "span", "name": "fwd", "ts": 1.0, "value": 1.0},
               {"name": "comm/all_reduce", "ts": 1.5, "value": 4096,
                "tags": {"axis": "dp", "seconds": 1.0}},
               {"kind": "gauge", "name": "loss", "ts": 1.6, "value": 2.5}]
    att = both(lambda m: m.attribute(m.intervals_from_jsonl_records(records, host="h0")))
    assert att["totals"]["exposed_comm_s"] == pytest.approx(0.5)


def test_analytic_schedule_fully_exposed():
    ops = [{"op": "all_gather", "axis": "dp", "bytes": 1 << 20, "seconds": 2e-4, "count": 2},
           {"op": "all_reduce", "axis": "dp", "bytes": 4096, "seconds": 1e-4}]
    rep = both(lambda m: m.overlap_report(m.analytic_intervals(1e-3, ops), mode="analytic"))
    assert rep["exposed_comm_s"] == pytest.approx(5e-4)
    assert rep["exposed_fraction"] == pytest.approx(1.0)
    assert len(rep["critical_path"]["ops"]) == 4 and ov.validate_report(rep) == []
    assert ov.format_report(rep) == jov.format_report(rep)


def test_validate_report_catches_malformed():
    rep = ov.overlap_report(_dev(_compute(ov, 0.0, 1.0), _comm(ov, 0.5, 2.0)))
    assert ov.validate_report(rep) == []
    for key, value, needle in (("exposed_comm_s", rep["comm_s"] + 1.0, "exposed_comm_s"),
                               ("overlap_fraction", float("nan"), "overlap_fraction"),
                               ("mode", "vibes", "mode")):
        bad = json.loads(json.dumps(rep))
        bad[key] = value
        assert any(needle in e for e in ov.validate_report(bad))
        assert ov.validate_report(bad) == jov.validate_report(bad)
    bad = json.loads(json.dumps(rep))
    del bad["critical_path"]
    assert any("critical_path" in e for e in ov.validate_report(bad))
    assert ov.validate_report("nope")


def test_attach_overlap_rides_summary_and_schema():
    """``attach_overlap`` -> ``summary()["overlap"]`` under the port's
    schema; a malformed report raises; a reset drops it; disabled
    telemetry returns None."""
    jsonschema = pytest.importorskip("jsonschema")
    rep = ov.overlap_report(_dev(_compute(ov, 0.0, 4.0), _comm(ov, 4.0, 7.0)))
    assert telemetry.attach_overlap(rep) is None
    telemetry.configure(enabled=True)
    assert telemetry.attach_overlap(rep) is rep
    s = telemetry.summary()
    assert s["overlap"]["exposed_comm_s"] == pytest.approx(3.0)
    with open(SCHEMA) as f:
        jsonschema.validate(s, json.load(f))
    with pytest.raises(ValueError):
        telemetry.attach_overlap({"mode": "trace"})
    telemetry.reset()
    telemetry.configure(enabled=True)
    assert "overlap" not in telemetry.summary()

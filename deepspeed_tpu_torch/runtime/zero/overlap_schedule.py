"""The overlap schedule's planner and its plain runtime pieces (port of
``deepspeed_tpu/runtime/zero/overlap_schedule.py``).

**Analytic scheduler.** :func:`scheduled_intervals` builds the two-resource
timeline a prefetch-depth-D / K-bucket step implies: one compute stream (L
forward layer slabs, then backward), one serialized collective stream.
Parameter all-gathers split per layer; gather ``i`` may issue when layer
``i - D``'s compute starts (D buffers in flight) and layer ``i``'s compute
waits on it. Grad exchanges split into K buckets; bucket ``b`` may issue the
moment its slice of backward completes. Smaller chunks pay the per-call
latency again, so more buckets is not free. The exposure algebra of
``telemetry/overlap.py`` scores the timeline.

**Planner.** :func:`candidate_plans` turns ``telemetry.overlap.advise()``
hints into seed candidates, :func:`plan_exposure` scores a (depth, buckets)
plan, :func:`best_plan` and :func:`best_moe_a2a_chunks` sweep them. Every
inventory entry must carry its ``seconds``: :func:`fill_comm_seconds`
passes such entries and raises ``NotImplementedError`` for one without,
whose price needs a roofline and a measured per-op profile store of the
device (ROADMAP A15, the autotuner, with an H100 device key). The port
keeps no device table.

**Runtime.** The JAX package's ``scheduled_scan`` (a layer scan whose carry
holds the next D gathered blocks) is, in the port, the training engine's
prefetch on its stage-3 gather units (``runtime/engine.py``): each unit's
forward pre-hook waits on its own gather and starts the next D units'
as asynchronous collectives. :func:`moe_chunked_scan` is the MoE twin as a
plain loop: chunk ``c + D``'s dispatch is issued before chunk ``c``'s
expert function runs.
"""

import math

# the per-call launch/sync floor that makes many small collectives cost
# more than one big one (the JAX package's value)
DEFAULT_LATENCY_S = 1e-6

# op-name classes the scheduler knows how to move. Everything else (grad-norm
# all_reduce, ...) stays serialized after backward — exposed. The MoE expert
# all-to-all gets its own pair of classes: dispatch can lead the expert GEMM
# it feeds, combine trails it — a different dependence shape from either the
# param prefetch or the grad buckets (see :func:`moe_scheduled_intervals`).
_PREFETCH_OPS = ("all_gather", "gather")
_BUCKET_OPS = ("reduce_scatter", "psum_scatter", "all_to_all", "exchange")
_MOE_DISPATCH_OPS = ("a2a_dispatch",)
_MOE_COMBINE_OPS = ("a2a_combine",)


def _ov():
    from deepspeed_tpu_torch.telemetry import overlap
    return overlap


def _op_class(op):
    name = str(op or "").lower()
    # moe classes first: "a2a_*" must not fall through to the generic
    # "all_to_all"/"exchange" bucket class
    if any(k in name for k in _MOE_DISPATCH_OPS):
        return "moe_dispatch"
    if any(k in name for k in _MOE_COMBINE_OPS):
        return "moe_combine"
    if any(k in name for k in _PREFETCH_OPS):
        return "prefetch"
    if any(k in name for k in _BUCKET_OPS):
        return "bucket"
    return "tail"


class OverlapPlan:
    """One schedule decision: how deep the param prefetch pipeline runs and
    how many grad buckets the boundary exchange splits into. ``n_layers`` and
    ``fwd_fraction`` shape the analytic timeline only."""

    def __init__(self, prefetch_depth=1, grad_buckets=2, n_layers=8,
                 fwd_fraction=1.0 / 3.0, latency_s=DEFAULT_LATENCY_S,
                 a2a_chunks=1):
        if prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, got {prefetch_depth}")
        if grad_buckets < 1:
            raise ValueError(f"grad_buckets must be >= 1, got {grad_buckets}")
        if n_layers < 1:
            raise ValueError(f"n_layers must be >= 1, got {n_layers}")
        if not 0.0 < fwd_fraction < 1.0:
            raise ValueError(f"fwd_fraction must be in (0, 1), got {fwd_fraction}")
        if a2a_chunks < 1:
            raise ValueError(f"a2a_chunks must be >= 1, got {a2a_chunks}")
        self.prefetch_depth = int(prefetch_depth)
        self.grad_buckets = int(grad_buckets)
        self.n_layers = int(n_layers)
        self.fwd_fraction = float(fwd_fraction)
        self.latency_s = float(latency_s)
        self.a2a_chunks = int(a2a_chunks)

    def to_dict(self):
        return {"prefetch_depth": self.prefetch_depth,
                "grad_buckets": self.grad_buckets,
                "n_layers": self.n_layers,
                "fwd_fraction": round(self.fwd_fraction, 6),
                "latency_s": self.latency_s,
                "a2a_chunks": self.a2a_chunks}

    @classmethod
    def from_dict(cls, d):
        return cls(prefetch_depth=d.get("prefetch_depth", 1),
                   grad_buckets=d.get("grad_buckets", 2),
                   n_layers=d.get("n_layers", 8),
                   fwd_fraction=d.get("fwd_fraction", 1.0 / 3.0),
                   latency_s=d.get("latency_s", DEFAULT_LATENCY_S),
                   a2a_chunks=d.get("a2a_chunks", 1))

    def __repr__(self):
        return (f"OverlapPlan(depth={self.prefetch_depth}, "
                f"buckets={self.grad_buckets}, layers={self.n_layers}, "
                f"a2a_chunks={self.a2a_chunks})")


def _split_spec(spec, m, latency_s):
    """One comm-op inventory entry split into ``m`` equal chunks. The
    bandwidth share divides evenly; every chunk pays the per-call latency
    floor again — splitting is never free."""
    m = max(int(m), 1)
    count = max(int(spec.get("count", 1)), 1)
    total_s = float(spec["seconds"]) * count
    bw_s = max(total_s - latency_s * count, 0.0)
    chunk_s = bw_s / m + latency_s
    nbytes = int(spec.get("bytes", 0) or 0)
    wire = spec.get("wire_bytes")
    out = []
    for k in range(m):
        out.append({"op": spec["op"], "axis": spec.get("axis"),
                    "bytes": nbytes // m,
                    "wire_bytes": (int(wire) // m if wire is not None else None),
                    "count": 1, "seconds": chunk_s})
    return out


def scheduled_intervals(compute_s, comm_ops, plan, device="analytic:0"):
    """The per-device timeline a scheduled step implies — the analytic-mode
    counterpart of ``overlap.analytic_intervals``'s serialized worst case.

    Two resources: the compute stream runs ``n_layers`` forward slabs then the
    backward block; the collective stream serializes chunks (collectives never
    hide each other — same rule the attribution uses). Data dependencies:
    layer ``i``'s forward waits on param-gather chunk ``i``; gather ``i`` may
    issue once layer ``i - depth``'s compute starts (``depth`` buffers in
    flight; depth 0 = issue at the consuming layer's boundary, fully
    serialized fill). Grad bucket ``b`` may issue once backward has retired
    ``(b+1)/K`` of its work; tail ops (grad-norm all_reduce, anything
    unclassified) wait for backward *and* every bucket.

    ``comm_ops`` entries need ``seconds`` (use :func:`fill_comm_seconds`).
    Comm totals are conserved up to the per-chunk latency floor, so serialized
    and scheduled reports stay byte-comparable."""
    ov = _ov()
    L, D, K = plan.n_layers, plan.prefetch_depth, plan.grad_buckets
    lat = plan.latency_s

    gathers, buckets, tail = [], [], []
    for spec in comm_ops:
        # unknown classes (incl. moe dispatch/combine in a non-moe timeline)
        # stay serialized at the tail — exposed, never silently dropped
        cls = _op_class(spec.get("op"))
        {"prefetch": gathers, "bucket": buckets}.get(cls, tail).append(spec)

    # split each class across its pipeline stages
    gather_chunks = [[] for _ in range(L)]
    for spec in gathers:
        for i, c in enumerate(_split_spec(spec, L, lat)):
            gather_chunks[i].append(c)
    bucket_chunks = [[] for _ in range(K)]
    for spec in buckets:
        for b, c in enumerate(_split_spec(spec, K, lat)):
            bucket_chunks[b].append(c)

    compute_s = float(compute_s)
    fwd_s = compute_s * plan.fwd_fraction
    bwd_s = compute_s - fwd_s
    fwd_slab = fwd_s / L

    ivs = []
    comm_free = 0.0

    def issue(chunks, ready, tag):
        """Serialize ``chunks`` onto the collective stream, not before
        ``ready``; returns when the last lands."""
        nonlocal comm_free
        done = ready
        for c in chunks:
            start = max(ready, comm_free)
            end = start + float(c["seconds"])
            ivs.append(ov.make_interval(
                f"comm:{c['op']}/{tag}", start, end, kind="comm",
                device=device, op=c["op"], axis=c.get("axis"),
                nbytes=c.get("bytes", 0), wire_bytes=c.get("wire_bytes")))
            comm_free = done = end
        return done

    # forward: gather i issues at layer (i - D)'s compute start; layer i's
    # compute waits on gather i and the previous layer
    start_c = [0.0] * L
    end_c = [0.0] * L
    for i in range(L):
        if D == 0:
            ready = end_c[i - 1] if i > 0 else 0.0
        else:
            ready = start_c[i - D] if i >= D else 0.0
        g_done = issue(gather_chunks[i], ready, f"prefetch{i:02d}")
        start_c[i] = max(end_c[i - 1] if i > 0 else 0.0, g_done)
        end_c[i] = start_c[i] + fwd_slab
        if fwd_slab > 0:
            ivs.append(ov.make_interval(f"compute/fwd{i:02d}", start_c[i],
                                        end_c[i], kind="compute",
                                        device=device))

    # backward: one slab per bucket window so bucket readiness lands on a
    # compute boundary; bucket b issues as soon as its window retires
    t0b = end_c[L - 1] if L else 0.0
    last_bucket_done = t0b
    for b in range(K):
        s = t0b + bwd_s * b / K
        e = t0b + bwd_s * (b + 1) / K
        if bwd_s > 0:
            ivs.append(ov.make_interval(f"compute/bwd{b:02d}", s, e,
                                        kind="compute", device=device))
        done = issue(bucket_chunks[b], e, f"bucket{b:02d}")
        last_bucket_done = max(last_bucket_done, done)

    # tail: grad-norm all_reduce and anything unclassified needs every grad
    # bucket — serialized after backward and the last exchange
    ready = max(t0b + bwd_s, last_bucket_done)
    for spec in tail:
        secs = float(spec["seconds"])
        for _ in range(max(int(spec.get("count", 1)), 1)):
            issue([dict(spec, seconds=secs, count=1)], ready, "tail")
            ready = comm_free
    return {device: ivs}


def fill_comm_seconds(comm_ops, device_kind=None, axis_sizes=None):
    """The inventory with every entry's per-call ``seconds``: entries that
    carry them pass (copied); one without raises ``NotImplementedError``,
    as pricing it needs the device's roofline and measured profile store
    (ROADMAP A15)."""
    specs = []
    for spec in comm_ops:
        if "seconds" not in spec:
            raise NotImplementedError(
                f"fill_comm_seconds: {spec.get('op')!r} carries no seconds; pricing it "
                f"needs a device roofline and profile store, which are not ported to "
                f"deepspeed_tpu_torch yet: ROADMAP A15 (the autotuner)")
        specs.append(dict(spec))
    return specs


def plan_exposure(compute_s, comm_ops, plan, device="analytic:0"):
    """Exposed-comm seconds of one plan on one inventory (the planner's
    scoring primitive — attribution algebra, no report assembly)."""
    per_device = scheduled_intervals(compute_s, comm_ops, plan, device=device)
    att = _ov().attribute(per_device)
    return att["totals"]["exposed_comm_s"]


def moe_scheduled_intervals(compute_s, comm_ops, plan, device="analytic:0"):
    """The MoE-step timeline ``plan.a2a_chunks`` implies — the expert-parallel
    counterpart of :func:`scheduled_intervals`.

    ``compute_s`` is the expert GEMM block; the dispatch all-to-all feeds it
    and the combine all-to-all drains it, so with one chunk the step is fully
    serialized: dispatch, then experts, then combine — the worst case.
    Splitting into ``A = a2a_chunks`` chunks
    pipelines them: every dispatch chunk is ready at step start (routing
    precedes expert compute) and issues immediately on the serialized
    collective stream; expert chunk ``c`` waits on dispatch chunk ``c`` and
    its predecessor; combine chunk ``c`` issues the moment expert chunk ``c``
    retires. Steady-state dispatch hides under the previous expert chunk and
    combine under the next — only the fill (first dispatch) and drain (last
    combine) stay exposed. Per-chunk latency is re-paid on every split
    (:func:`_split_spec`), so more chunks is not free — the planner's
    trade-off. Unclassified ops serialize at the tail as ever."""
    ov = _ov()
    A = plan.a2a_chunks
    lat = plan.latency_s

    dispatch, combine, tail = [], [], []
    for spec in comm_ops:
        cls = _op_class(spec.get("op"))
        {"moe_dispatch": dispatch,
         "moe_combine": combine}.get(cls, tail).append(spec)

    disp_chunks = [[] for _ in range(A)]
    for spec in dispatch:
        for c, ch in enumerate(_split_spec(spec, A, lat)):
            disp_chunks[c].append(ch)
    comb_chunks = [[] for _ in range(A)]
    for spec in combine:
        for c, ch in enumerate(_split_spec(spec, A, lat)):
            comb_chunks[c].append(ch)

    compute_s = float(compute_s)
    slab = compute_s / A

    ivs = []
    comm_free = 0.0

    def issue(chunks, ready, tag):
        nonlocal comm_free
        done = ready
        for c in chunks:
            start = max(ready, comm_free)
            end = start + float(c["seconds"])
            ivs.append(ov.make_interval(
                f"comm:{c['op']}/{tag}", start, end, kind="comm",
                device=device, op=c["op"], axis=c.get("axis"),
                nbytes=c.get("bytes", 0), wire_bytes=c.get("wire_bytes")))
            comm_free = done = end
        return done

    # all dispatch chunks are ready at t=0 — queue them ahead of any combine
    # so a trailing combine never blocks the next chunk's dispatch
    d_done = [issue(disp_chunks[c], 0.0, f"dispatch{c:02d}")
              for c in range(A)]

    prev_end = 0.0
    last_done = 0.0
    for c in range(A):
        start = max(prev_end, d_done[c])
        end = start + slab
        if slab > 0:
            ivs.append(ov.make_interval(f"compute/expert{c:02d}", start, end,
                                        kind="compute", device=device))
        prev_end = end
        done = issue(comb_chunks[c], end, f"combine{c:02d}")
        last_done = max(last_done, done, end)

    ready = last_done
    for spec in tail:
        secs = float(spec["seconds"])
        for _ in range(max(int(spec.get("count", 1)), 1)):
            issue([dict(spec, seconds=secs, count=1)], ready, "tail")
            ready = comm_free
    return {device: ivs}


def moe_plan_exposure(compute_s, comm_ops, plan, device="analytic:0"):
    """Exposed-comm seconds of one plan on an MoE inventory — the a2a_chunks
    scoring primitive."""
    per_device = moe_scheduled_intervals(compute_s, comm_ops, plan,
                                         device=device)
    att = _ov().attribute(per_device)
    return att["totals"]["exposed_comm_s"]


def _report(cost, comm_ops, plan, device_kind, axis_sizes, top_k, compute_s, intervals):
    ov = _ov()
    if compute_s is None:
        raise NotImplementedError(
            "an overlap report needs compute_s: a roofline of the step's cost is not "
            "ported to deepspeed_tpu_torch yet: ROADMAP A15 (the autotuner)")
    specs = fill_comm_seconds(comm_ops, device_kind=device_kind, axis_sizes=axis_sizes)
    serialized = ov.attribute(ov.analytic_intervals(compute_s, specs))
    ser_exposed = serialized["totals"]["exposed_comm_s"]
    per_device = intervals(compute_s, specs, plan)
    report = ov.overlap_report(per_device, mode="analytic", top_k=top_k,
                               device_kind=device_kind)
    exposed = report["exposed_comm_s"]
    reduction = ((ser_exposed - exposed) / ser_exposed
                 if ser_exposed > 0 else 0.0)
    report["schedule"] = dict(
        plan.to_dict(),
        compute_s=round(float(compute_s), 9),
        comm_ops=[{k: v for k, v in s.items()} for s in specs],
        serialized_exposed_comm_s=round(ser_exposed, 9),
        exposed_reduction_fraction=round(reduction, 6),
    )
    return report


def scheduled_report(cost, comm_ops, plan, device_kind=None, axis_sizes=None, top_k=10,
                     compute_s=None):
    """The overlap report of the scheduled program on given seconds, with
    the serialized worst case it starts from in ``report["schedule"]``.
    ``compute_s`` is required (``cost`` is the JAX signature's compiled-cost
    dict, read by nothing here)."""
    return _report(cost, comm_ops, plan, device_kind, axis_sizes, top_k, compute_s,
                   scheduled_intervals)


def moe_scheduled_report(cost, comm_ops, plan, device_kind=None, axis_sizes=None,
                         top_k=10, compute_s=None):
    """:func:`scheduled_report` for the MoE step, on
    :func:`moe_scheduled_intervals`."""
    return _report(cost, comm_ops, plan, device_kind, axis_sizes, top_k, compute_s,
                   moe_scheduled_intervals)


def validate_schedule(sched):
    """Structural check of a report's ``schedule`` block (the fields a
    schedule can be re-derived from). Returns a list of error strings."""
    errs = []
    if not isinstance(sched, dict):
        return ["schedule block is not a dict"]
    for k in ("prefetch_depth", "grad_buckets", "n_layers"):
        v = sched.get(k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append(f"schedule.{k} missing or invalid (got {v!r})")
    # optional (older plans omit it; from_dict defaults to 1)
    v = sched.get("a2a_chunks", 1)
    if not isinstance(v, int) or isinstance(v, bool) or v < 1:
        errs.append(f"schedule.a2a_chunks invalid (got {v!r})")
    for k in ("compute_s", "serialized_exposed_comm_s", "fwd_fraction"):
        v = sched.get(k)
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not math.isfinite(v) or v < 0:
            errs.append(f"schedule.{k} missing or non-finite (got {v!r})")
    ops = sched.get("comm_ops")
    if not isinstance(ops, list) or not ops:
        errs.append("schedule.comm_ops missing or empty")
        return errs
    for spec in ops:
        if not isinstance(spec, dict) or "op" not in spec:
            errs.append(f"malformed comm_ops entry {spec!r}")
            continue
        s = spec.get("seconds")
        if not isinstance(s, (int, float)) or not math.isfinite(s) or s < 0:
            errs.append(f"comm_ops[{spec['op']}].seconds invalid ({s!r})")
    return errs


# ---------------------------------------------------------------------------
# planner: advisor hints -> candidate plans -> scored sweep dimension
# ---------------------------------------------------------------------------

DEFAULT_DEPTHS = (0, 1, 2)
DEFAULT_BUCKETS = (1, 2, 4)
DEFAULT_A2A_CHUNKS = (1, 2, 4)


def candidate_plans(hints=None, n_layers=8, depths=DEFAULT_DEPTHS,
                    buckets=DEFAULT_BUCKETS, fwd_fraction=1.0 / 3.0):
    """(depth, buckets) candidates for the sweep, advisor-seeded.

    ``hints``: ``telemetry.overlap.advise()`` rows. A hint naming a
    gather-class op with saving potential promotes the deepest prefetch
    candidates to the front; a reduce-class hint promotes the highest bucket
    counts — the sweep tries what the measured exposure says matters before
    falling back to the full ladder. Depth is capped at ``n_layers - 1``
    (you cannot hold more lookahead than there are layers left)."""
    depths = sorted({min(int(d), max(n_layers - 1, 0)) for d in depths})
    buckets = sorted({max(1, min(int(b), n_layers)) for b in buckets})
    want_depth = want_buckets = False
    for h in hints or []:
        if float(h.get("potential_saving_s", 0) or 0) <= 0:
            continue
        cls = _op_class(h.get("op"))
        want_depth |= cls == "prefetch"
        want_buckets |= cls == "bucket"

    d_order = sorted(depths, reverse=want_depth)
    b_order = sorted(buckets, reverse=want_buckets)
    out, seen = [], set()
    for d in d_order:
        for b in b_order:
            if (d, b) not in seen:
                seen.add((d, b))
                out.append(OverlapPlan(prefetch_depth=d, grad_buckets=b,
                                       n_layers=n_layers,
                                       fwd_fraction=fwd_fraction))
    return out


def best_plan(compute_s, comm_ops, hints=None, n_layers=8,
              depths=DEFAULT_DEPTHS, buckets=DEFAULT_BUCKETS):
    """Sweep the candidates on one inventory; returns
    ``(plan, exposed_s, ranking)`` with the ranking listing every candidate's
    exposure (ties broken toward the shallower/cheaper plan — fewer live
    buffers, fewer launches)."""
    ranking = []
    for plan in candidate_plans(hints, n_layers=n_layers, depths=depths,
                                buckets=buckets):
        exposed = plan_exposure(compute_s, comm_ops, plan)
        ranking.append({"prefetch_depth": plan.prefetch_depth,
                        "grad_buckets": plan.grad_buckets,
                        "exposed_comm_s": round(exposed, 9)})
    if not ranking:
        raise ValueError("no overlap candidates to rank")
    ranking.sort(key=lambda r: (r["exposed_comm_s"], r["prefetch_depth"],
                                r["grad_buckets"]))
    top = ranking[0]
    plan = OverlapPlan(prefetch_depth=top["prefetch_depth"],
                       grad_buckets=top["grad_buckets"], n_layers=n_layers)
    return plan, top["exposed_comm_s"], ranking


def best_moe_a2a_chunks(compute_s, comm_ops, base_plan=None,
                        chunks=DEFAULT_A2A_CHUNKS):
    """Sweep ``a2a_chunks`` on an MoE inventory (dispatch/combine a2a ops vs
    the expert GEMM block); returns ``(plan, exposed_s, ranking)`` like
    :func:`best_plan`. ``base_plan`` carries the non-moe dimensions (depth,
    buckets) the main sweep already decided — chunk count is co-decided on
    top, not instead."""
    base = base_plan if base_plan is not None else OverlapPlan()
    ranking = []
    for a in sorted({max(1, int(a)) for a in chunks}):
        plan = OverlapPlan(prefetch_depth=base.prefetch_depth,
                           grad_buckets=base.grad_buckets,
                           n_layers=base.n_layers,
                           fwd_fraction=base.fwd_fraction,
                           latency_s=base.latency_s, a2a_chunks=a)
        exposed = moe_plan_exposure(compute_s, comm_ops, plan)
        ranking.append({"a2a_chunks": a,
                        "exposed_comm_s": round(exposed, 9)})
    if not ranking:
        raise ValueError("no a2a_chunks candidates to rank")
    # ties break toward fewer chunks — fewer launches, less latency re-paid
    ranking.sort(key=lambda r: (r["exposed_comm_s"], r["a2a_chunks"]))
    top = ranking[0]
    plan = OverlapPlan(prefetch_depth=base.prefetch_depth,
                       grad_buckets=base.grad_buckets,
                       n_layers=base.n_layers,
                       fwd_fraction=base.fwd_fraction,
                       latency_s=base.latency_s,
                       a2a_chunks=top["a2a_chunks"])
    return plan, top["exposed_comm_s"], ranking


# ---------------------------------------------------------------------------
# runtime: the chunked expert loop
# ---------------------------------------------------------------------------

def moe_chunked_scan(expert_fn, dispatch, n_chunks, depth=1):
    """The chunked-expert loop, the MoE twin of the engine's prefetch.

    ``dispatch(c)`` performs chunk ``c``'s dispatch all-to-all and returns
    the exchanged rows; ``expert_fn(rows, c)`` runs the experts on them (and
    typically the combine) and returns the chunk's output. With ``depth`` D
    >= 1 the loop issues ``dispatch(c + D)`` before ``expert_fn`` consumes
    chunk ``c`` (a dispatch that starts an asynchronous exchange then runs
    under the chunk's compute); depth 0 dispatches each chunk at its use.
    Returns the outputs stacked ``[n_chunks, ...]`` in chunk order."""
    import torch
    n_chunks = int(n_chunks)
    depth = max(int(depth), 0)
    if depth == 0:
        return torch.stack([expert_fn(dispatch(c), c) for c in range(n_chunks)])
    depth = min(depth, max(n_chunks - 1, 1))
    buf = [dispatch(min(k, n_chunks - 1)) for k in range(depth)]
    ys = []
    for c in range(n_chunks):
        # the lookahead dispatch first; tail iterations dispatch nothing
        nxt = dispatch(c + depth) if c + depth < n_chunks else None
        ys.append(expert_fn(buf.pop(0), c))
        buf.append(nxt)
    return torch.stack(ys)

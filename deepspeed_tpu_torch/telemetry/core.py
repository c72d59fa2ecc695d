"""Process-global telemetry pipeline, serving part (port of
``deepspeed_tpu/telemetry/core.py``).

One object owns the measurement streams of the serving path:

- **spans** (``span("serving/forward")``): wall-clock phases. A span may
  carry a torch tensor ``token``; with ``sample_sync`` on, the span's end
  synchronises the token's CUDA stream so the interval covers the device
  work, not just the asynchronous launch.
- **metrics** (``record(name, value, kind, **tags)``) and **counters**
  (``count(name, **tags)``): scalar samples and monotone per-tag counts.
- **serving stream** (``record_hist`` / ``serving_event`` /
  ``serving_gauge`` / ``record_request_phase`` / ``record_request_flow``):
  per-request latencies (TTFT, TPOT, e2e, queue wait) land in fixed-bucket
  log2 histograms with p50/p95/p99 extraction; scheduler and KV gauges
  keep last + peak and a Chrome counter track; each request gets its own
  Chrome-trace lane (a synthetic tid named ``request/<uid>``) and a flow
  chain across its lifecycle hops.
- **time series** (``record_series``): fixed-window rings
  (``telemetry/timeseries.py``); gauges and histograms feed theirs
  implicitly.
- **SLO classes** (``set_slo_classes`` / ``slo_observe``): per-class
  attainment counters, burn-rate and error-budget gauges.
- **fleet stream** (``fleet_event`` / ``fleet_gauge`` / ``record_handoff``):
  the serving fleet's router outcomes, its queue / shed gauges and the
  prefill->decode KV page handoffs (pages, device bytes, wire bytes,
  latency), in ``summary()["fleet"]``.

Exporters: a Chrome-trace JSON file (``chrome://tracing`` / Perfetto) and a
JSON-lines metrics file; every JSON-lines record is stamped with
``(host, pid, run_id)``.

Disabled (the default) every entry point is a constant-time no-op: no
clock read, no device synchronisation, no file I/O, no allocation beyond
the guard check.

The JAX package's comm, dispatch, compile, memory, MoE and goodput-ledger
streams and the flight recorder are not part of this module (ROADMAP A15);
an overlap report (``telemetry/overlap.py``) rides ``summary()["overlap"]``
once ``attach_overlap`` has taken it.

This module imports only the standard library at module scope; torch is
imported inside the enabled-only span end.
"""

import atexit
import json
import math
import os
import socket
import threading
import time

# injectable clocks: tests pin time by monkeypatching these module aliases
_now = time.perf_counter
_now_wall = time.time

#: fixed-bucket histogram geometry: bucket 0 holds values <= HIST_MIN (1us),
#: bucket i holds (HIST_MIN*2^(i-1), HIST_MIN*2^i], the last bucket is the
#: overflow (>~2400s). Log2 spacing bounds the per-sample cost to one
#: ``math.log2`` and keeps relative quantile error within one octave, while
#: observed min/max clamping keeps reported percentiles exact at the
#: distribution edges.
HIST_BUCKETS = 44
HIST_MIN = 1e-6


def _hist_bucket(v):
    if v <= HIST_MIN:
        return 0
    return min(1 + int(math.log2(v / HIST_MIN)), HIST_BUCKETS - 1)


def _hist_bounds(i):
    lo = 0.0 if i == 0 else HIST_MIN * 2.0 ** (i - 1)
    return lo, HIST_MIN * 2.0 ** i


def _hist_quantile(h, q):
    """Quantile by cumulative bucket walk + linear interpolation inside the
    landing bucket, clamped to the observed [min, max] (so a single-valued
    histogram reports that exact value, and p50 <= p95 <= p99 always holds:
    the walk is monotone in q and the clamp is order-preserving)."""
    target = q * h["count"]
    cum = 0
    for i, c in enumerate(h["counts"]):
        if c == 0:
            continue
        if cum + c >= target:
            lo, hi = _hist_bounds(i)
            v = lo + (hi - lo) * (target - cum) / c
            return min(max(v, h["min"]), h["max"])
        cum += c
    return h["max"]


# --- atexit export hook: registered at most once per process ---------------
_ATEXIT_LOCK = threading.Lock()
_ATEXIT_REGISTERED = False
_ATEXIT_INSTANCES = []


def _register_atexit(instance):
    global _ATEXIT_REGISTERED
    with _ATEXIT_LOCK:
        if instance not in _ATEXIT_INSTANCES:
            _ATEXIT_INSTANCES.append(instance)
        if not _ATEXIT_REGISTERED:
            atexit.register(_atexit_export_all)
            _ATEXIT_REGISTERED = True


def _atexit_export_all():
    for inst in list(_ATEXIT_INSTANCES):
        inst._atexit_export()


def _sync(token):
    """Wait for the device work behind ``token`` (a torch tensor) to finish:
    its CUDA stream is synchronised; CPU tensors and other objects are
    already done."""
    device = getattr(token, "device", None)
    if device is None or device.type != "cuda":
        return
    import torch
    torch.cuda.current_stream(device).synchronize()


class _NullSpan:
    """Shared no-op span for the disabled fast path."""

    __slots__ = ("token",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, token=None):
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    """A live scoped measurement: a context manager (``with
    telemetry.span("x") as sp: ...; sp.token = out``) or an explicit
    ``span_begin``/``end`` pair."""

    __slots__ = ("_tm", "name", "tags", "token", "_t0")

    def __init__(self, tm, name, tags):
        self._tm = tm
        self.name = name
        self.tags = tags
        self.token = None
        self._t0 = _now()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end(self.token)
        return False

    def end(self, token=None):
        tm = self._tm
        if tm is None:
            return 0.0
        self._tm = None  # ending twice records once
        if token is None:
            token = self.token
        if token is not None and tm.sample_sync:
            _sync(token)
        dt = _now() - self._t0
        tm._end_span(self.name, self._t0, dt, self.tags)
        return dt


class Telemetry:
    """The process-global telemetry pipeline (one instance per process, the
    module-level singleton of ``deepspeed_tpu_torch/telemetry/__init__.py``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.enabled = False
        self._reset_state()
        # exporter wiring (survives reset() so a reset mid-run keeps sinks)
        self.sample_sync = True
        self.jsonl_path = None
        self.chrome_trace_path = None
        self._jsonl_fh = None
        try:
            self.host = socket.gethostname()
        except Exception:
            self.host = "localhost"
        self.run_id = f"{os.getpid()}-{int(_now_wall())}"
        # SLO class targets ({name: {"ttft_target_s", "tpot_target_s",
        # "attainment_target"}}): configuration like the sinks, so reset()
        # keeps them; set_slo_classes replaces the whole set
        self.slo_classes = {}

    def _reset_state(self):
        self._epoch = _now()
        self.trace_events = []    # chrome-trace event dicts
        self.metrics = []         # every record() sample, in order
        self.counters = {}        # name -> {tag_key: int}
        self.span_stats = {}      # name -> [count, total_s]
        self.hist_stats = {}      # name -> {counts, count, sum, min, max}
        self.serving_counters = {}  # lifecycle event -> count
        self.serving_gauges = {}  # name -> [last, peak]
        self._request_lanes = {}  # uid -> synthetic chrome tid
        self.series = {}          # name -> SeriesRing
        self.slo_stats = {}       # class -> metric -> [attained, violations]
        self._flow_ids = {}       # uid -> chrome flow id
        # fleet stream (router admission + prefill/decode handoffs)
        self.fleet_counters = {}  # admission outcome -> count
        self.fleet_gauges = {}    # name -> [last, peak]
        self.fleet_handoff = {"count": 0, "pages_shipped": 0,
                              "pages_bound": 0, "bytes": 0,
                              "wire_bytes": 0, "total_s": 0.0}
        # device-timeline overlap report (telemetry/overlap.py), attached
        # by attach_overlap(); rides summary()["overlap"]
        self.overlap_report = None

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def configure(self, enabled=None, jsonl_path=None, chrome_trace_path=None,
                  sample_sync=None):
        """Set what is given: on/off, the JSON-lines and Chrome-trace paths
        ("" disables that exporter) and whether a span's end synchronises
        its token's stream. Unset arguments keep their values."""
        with self._lock:
            if sample_sync is not None:
                self.sample_sync = bool(sample_sync)
            if jsonl_path is not None:
                if self._jsonl_fh is not None and jsonl_path != self.jsonl_path:
                    try:
                        self._jsonl_fh.close()
                    except Exception:
                        pass
                    self._jsonl_fh = None
                self.jsonl_path = jsonl_path or None
            if chrome_trace_path is not None:
                self.chrome_trace_path = chrome_trace_path or None
                if self.chrome_trace_path:
                    _register_atexit(self)
            if enabled is not None:
                self.enabled = bool(enabled)

    def _atexit_export(self):
        if self.enabled and self.chrome_trace_path and self.trace_events:
            try:
                self.export_chrome_trace()
            except Exception:
                pass

    def reset(self):
        """Drop every accumulated measurement (sink config stays)."""
        with self._lock:
            self._reset_state()

    def close(self):
        with self._lock:
            if self._jsonl_fh is not None:
                try:
                    self._jsonl_fh.close()
                except Exception:
                    pass
                self._jsonl_fh = None

    # ------------------------------------------------------------------
    # spans, metrics, counters
    # ------------------------------------------------------------------
    def span(self, name, **tags):
        """Scoped wall-clock measurement; ``_NULL_SPAN`` when disabled so the
        off path never allocates or syncs."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, tags or None)

    span_begin = span  # same object, explicit begin/end idiom

    def _end_span(self, name, t0, dt, tags):
        with self._lock:
            st = self.span_stats.get(name)
            if st is None:
                st = self.span_stats[name] = [0, 0.0]
            st[0] += 1
            st[1] += dt
            ev = {"name": name, "ph": "X", "cat": "span",
                  "ts": round((t0 - self._epoch) * 1e6, 3),
                  "dur": round(dt * 1e6, 3),
                  "pid": os.getpid(), "tid": threading.get_ident() & 0xffff}
            if tags:
                ev["args"] = tags
            self.trace_events.append(ev)
            self._emit_jsonl({"name": name, "kind": "span", "value": dt,
                              "unit": "s", "tags": tags or {}})

    def record(self, name, value, kind="gauge", **tags):
        """Record one scalar sample. ``kind``: "gauge" | "counter" | "bytes"
        | "seconds" (free-form strings are kept verbatim)."""
        if not self.enabled:
            return
        with self._lock:
            if kind == "counter":
                per = self.counters.setdefault(name, {})
                key = tuple(sorted(tags.items()))
                per[key] = per.get(key, 0) + value
            self.metrics.append({"name": name, "kind": kind, "value": value,
                                 "tags": tags or {}})
            self._emit_jsonl({"name": name, "kind": kind, "value": value,
                              "tags": tags or {}})

    def count(self, name, n=1, **tags):
        self.record(name, n, kind="counter", **tags)

    # ------------------------------------------------------------------
    # serving stream
    # ------------------------------------------------------------------
    def record_hist(self, name, value, **tags):
        """One sample into the fixed-bucket log2 histogram ``name`` (values
        in seconds for latency histograms). Feeds ``hist_percentiles``,
        ``summary()["serving"]["histograms"]`` and the histogram's ring
        series."""
        if not self.enabled:
            return
        v = max(float(value), 0.0)
        with self._lock:
            self._record_hist_locked(name, v)
            self._record_series_locked(name, _now() - self._epoch, v)
            self._emit_jsonl({"name": name, "kind": "hist", "value": v,
                              "tags": tags or {}})

    def _record_hist_locked(self, name, v):
        h = self.hist_stats.get(name)
        if h is None:
            h = self.hist_stats[name] = {
                "counts": [0] * HIST_BUCKETS, "count": 0, "sum": 0.0,
                "min": float("inf"), "max": 0.0}
        h["counts"][_hist_bucket(v)] += 1
        h["count"] += 1
        h["sum"] += v
        if v < h["min"]:
            h["min"] = v
        if v > h["max"]:
            h["max"] = v

    def hist_percentiles(self, name, qs=(0.5, 0.95, 0.99)):
        """Percentiles of histogram ``name`` as a tuple aligned with ``qs``,
        or None when the histogram has no samples."""
        with self._lock:
            h = self.hist_stats.get(name)
            if not h or not h["count"]:
                return None
            return tuple(_hist_quantile(h, q) for q in qs)

    def _record_series_locked(self, name, rel_ts, v):
        ring = self.series.get(name)
        if ring is None:
            from deepspeed_tpu_torch.telemetry.timeseries import SeriesRing
            ring = self.series[name] = SeriesRing()
        ring.record(rel_ts, v)

    def record_series(self, name, value, **tags):
        """One sample into the fixed-window ring time series ``name``."""
        if not self.enabled:
            return
        v = float(value)
        with self._lock:
            self._record_series_locked(name, _now() - self._epoch, v)
            self._emit_jsonl({"name": name, "kind": "series", "value": v,
                              "tags": tags or {}})

    def series_windows(self, name):
        """Live windows of series ``name`` (oldest first), or None when the
        series does not exist or telemetry is disabled."""
        if not self.enabled:
            return None
        with self._lock:
            ring = self.series.get(name)
            return None if ring is None else ring.windows()

    # ------------------------------------------------------------------
    # SLO classes
    # ------------------------------------------------------------------
    def set_slo_classes(self, classes):
        """Install per-class latency targets
        (``{name: {"ttft_target_s": .., "tpot_target_s": ..,
        "attainment_target": 0.99}}``). Survives ``reset()``."""
        cleaned = {}
        for name, spec in (classes or {}).items():
            spec = dict(spec or {})
            cleaned[str(name)] = {
                "ttft_target_s": (float(spec["ttft_target_s"])
                                  if spec.get("ttft_target_s") is not None
                                  else None),
                "tpot_target_s": (float(spec["tpot_target_s"])
                                  if spec.get("tpot_target_s") is not None
                                  else None),
                "attainment_target": float(
                    spec.get("attainment_target") or 0.99)}
        with self._lock:
            self.slo_classes = cleaned

    @staticmethod
    def _gauge_locked(gauges, name, v):
        g = gauges.get(name)
        if g is None:
            gauges[name] = [v, v]
        else:
            g[0] = v
            if v > g[1]:
                g[1] = v

    def slo_observe(self, slo_class, metric, value, n=1):
        """Record one latency observation against class ``slo_class``'s
        ``metric`` target ("ttft" | "tpot"): the per-class histogram
        (``serving/<metric>_s/<class>``), the attainment counters
        (``attained + violations == requests``), the request/violation ring
        series, and the rolling burn-rate / error-budget gauges (burn rate
        1.0 = violating at exactly the budgeted rate). Unknown classes and
        classes without a target for ``metric`` only get the histogram."""
        if not self.enabled or not slo_class:
            return
        v = max(float(value), 0.0)
        rel = _now() - self._epoch
        with self._lock:
            self._record_hist_locked(f"serving/{metric}_s/{slo_class}", v)
            cls = self.slo_classes.get(slo_class)
            target = (cls or {}).get(f"{metric}_target_s")
            if target is None:
                return
            per = self.slo_stats.get(slo_class)
            if per is None:
                per = self.slo_stats[slo_class] = {}
            st = per.get(metric)
            if st is None:
                st = per[metric] = [0, 0]
            ok = v <= target
            st[0 if ok else 1] += n
            # one JSONL line per observation, so that per-class attainment
            # can be rebuilt from the raw stream
            self._emit_jsonl({"name": f"slo/{slo_class}/{metric}",
                              "kind": "slo", "value": v,
                              "tags": {"slo_class": slo_class,
                                       "metric": metric, "n": n,
                                       "attained": bool(ok),
                                       "target_s": target}})
            req_name = f"slo/{slo_class}/{metric}_requests"
            viol_name = f"slo/{slo_class}/{metric}_violations"
            self._record_series_locked(req_name, rel, float(n))
            if not ok:
                self._record_series_locked(viol_name, rel, float(n))
            budget = max(1.0 - cls["attainment_target"], 1e-9)
            req_ring = self.series[req_name]
            viol_ring = self.series.get(viol_name)
            # rolling burn rate: violation fraction over the live windows,
            # over the budgeted violation fraction
            win_req = sum(w["count"] for w in req_ring.windows())
            win_viol = (sum(w["count"] for w in viol_ring.windows())
                        if viol_ring is not None else 0)
            burn = (win_viol / win_req / budget) if win_req else 0.0
            # lifetime error budget (total_count survives ring eviction)
            life_viol = viol_ring.total_count if viol_ring is not None else 0
            consumed = ((life_viol / req_ring.total_count / budget)
                        if req_ring.total_count else 0.0)
            self._gauge_locked(self.serving_gauges,
                               f"slo/{slo_class}/{metric}_burn_rate", burn)
            self._gauge_locked(
                self.serving_gauges,
                f"slo/{slo_class}/{metric}_error_budget_remaining",
                max(1.0 - consumed, 0.0))

    def slo_snapshot(self):
        """Per-class attainment snapshot (the live ``summary()["slo"]``
        section); {} when disabled or nothing observed."""
        if not self.enabled:
            return {}
        with self._lock:
            return self._slo_summary()

    def _slo_summary(self):
        # caller holds self._lock
        out = {}
        for cls, per in sorted(self.slo_stats.items()):
            spec = self.slo_classes.get(cls) or {}
            entry = {"targets": {k: spec.get(k) for k in
                                 ("ttft_target_s", "tpot_target_s")},
                     "attainment_target": spec.get("attainment_target"),
                     "metrics": {}}
            for metric, (ok, viol) in sorted(per.items()):
                total = ok + viol
                entry["metrics"][metric] = {
                    "requests": total, "attained": ok, "violations": viol,
                    "attainment": round(ok / total, 6) if total else 1.0}
            out[cls] = entry
        return out

    def serving_event(self, event, n=1, **tags):
        """Count one request-lifecycle event ("submitted", "finished",
        "evicted", "preempted", "resumed", ...), surfaced in
        ``summary()["serving"]["requests"]``."""
        if not self.enabled:
            return
        with self._lock:
            self.serving_counters[event] = \
                self.serving_counters.get(event, 0) + n
            self._emit_jsonl({"name": f"serving/req/{event}",
                              "kind": "counter", "value": n,
                              "tags": tags or {}})

    def serving_gauge(self, name, value, **tags):
        """Record a scheduler/KV gauge sample: keeps last + peak, emits a
        Chrome counter track ("C" event) and a JSONL line. Host-side values
        only — callers never synchronise the device to produce one."""
        if not self.enabled:
            return
        v = float(value)
        with self._lock:
            rel = _now() - self._epoch
            self._gauge_locked(self.serving_gauges, name, v)
            self._record_series_locked(name, rel, v)
            self.trace_events.append(
                {"name": name, "ph": "C", "cat": "serving",
                 "ts": round(rel * 1e6, 3),
                 "pid": os.getpid(), "args": {"value": v}})
            self._emit_jsonl({"name": name, "kind": "gauge", "value": v,
                              "tags": tags or {}})

    # ------------------------------------------------------------------
    # fleet stream
    # ------------------------------------------------------------------
    def fleet_event(self, event, n=1, **tags):
        """Count one fleet outcome ("admitted", "queued", "rejected",
        "affinity_hit", "handoff_retry", "replica_lost", ...), surfaced in
        ``summary()["fleet"]["events"]``."""
        if not self.enabled:
            return
        with self._lock:
            self.fleet_counters[event] = self.fleet_counters.get(event, 0) + n
            self._emit_jsonl({"name": f"fleet/req/{event}", "kind": "counter",
                              "value": n, "tags": tags or {}})

    def fleet_gauge(self, name, value, **tags):
        """Fleet-level gauge (router queue depth, shed rate, live replicas):
        keeps last + peak, emits a Chrome counter track and a JSONL line.
        Host-side values only, like ``serving_gauge``."""
        if not self.enabled:
            return
        v = float(value)
        with self._lock:
            rel = _now() - self._epoch
            self._gauge_locked(self.fleet_gauges, name, v)
            self._record_series_locked(name, rel, v)
            self.trace_events.append(
                {"name": name, "ph": "C", "cat": "fleet",
                 "ts": round(rel * 1e6, 3),
                 "pid": os.getpid(), "args": {"value": v}})
            self._emit_jsonl({"name": name, "kind": "gauge", "value": v,
                              "tags": tags or {}})

    def record_handoff(self, uid, pages, nbytes, seconds, src="prefill",
                       dst="decode", bound=None, wire_nbytes=None):
        """One prefill->decode KV page handoff: adds pages, bytes and
        latency to ``summary()["fleet"]["handoff"]`` (whose accounting
        identity is ``pages_shipped == pages_bound``), records a
        ``fleet/handoff_s`` histogram sample, and drops a "handoff" slice
        on the request's Chrome-trace lane between its prefill and decode
        phases. ``nbytes`` is the device page footprint; ``wire_nbytes``
        what crosses (or would cross) a link: the serialized frame's bytes
        on the wire codec."""
        if not self.enabled:
            return
        seconds = float(seconds)
        t_end = _now()
        wire = int(nbytes if wire_nbytes is None else wire_nbytes)
        with self._lock:
            h = self.fleet_handoff
            h["count"] += 1
            h["pages_shipped"] += int(pages)
            h["pages_bound"] += int(pages if bound is None else bound)
            h["bytes"] += int(nbytes)
            h["wire_bytes"] += wire
            h["total_s"] += seconds
            self._emit_jsonl({"name": "fleet/handoff", "kind": "seconds",
                              "value": seconds,
                              "tags": {"uid": uid, "pages": int(pages),
                                       "bytes": int(nbytes), "wire_bytes": wire,
                                       "src": src, "dst": dst}})
        self.record_hist("fleet/handoff_s", seconds)
        self.record_request_phase(uid, "handoff", t_end - seconds, seconds,
                                  pages=int(pages), bytes=int(nbytes),
                                  src=src, dst=dst)
        self.record_request_flow(uid, "handoff", pages=int(pages))

    def _fleet_summary(self):
        # caller holds self._lock
        h = self.fleet_handoff
        gauges = {name: {"last": round(g[0], 6), "peak": round(g[1], 6)}
                  for name, g in sorted(self.fleet_gauges.items())}
        return {"events": {k: int(v) for k, v in sorted(self.fleet_counters.items())},
                "gauges": gauges,
                "handoff": {"count": int(h["count"]),
                            "pages_shipped": int(h["pages_shipped"]),
                            "pages_bound": int(h["pages_bound"]),
                            "bytes": int(h["bytes"]),
                            "wire_bytes": int(h["wire_bytes"]),
                            "total_s": round(h["total_s"], 6)}}

    def gauge_value(self, name):
        """Last recorded value of serving gauge ``name`` (None when disabled
        or never recorded): the O(1) read through which the scheduler's
        preemption precedence reads the live burn-rate gauges."""
        if not self.enabled:
            return None
        with self._lock:
            g = self.serving_gauges.get(name)
            return g[0] if g is not None else None

    def slo_class_targets(self):
        """The installed per-class SLO targets (``set_slo_classes`` shape);
        {} when none configured."""
        with self._lock:
            return dict(self.slo_classes)

    def record_request_phase(self, uid, phase, t0, dur=None, **args):
        """One lifecycle phase of request ``uid`` on its own Chrome-trace
        lane (a synthetic tid named ``request/<uid>``). ``dur`` seconds
        makes a complete ("X") slice anchored at perf_counter time ``t0``;
        ``dur`` None makes an instant ("i") marker."""
        if not self.enabled:
            return
        with self._lock:
            tid = self._request_lanes.get(uid)
            if tid is None:
                # lanes sort after the real-thread tids (0xffff mask above)
                tid = 0x10000 + (len(self._request_lanes) & 0xFFFF)
                self._request_lanes[uid] = tid
                self.trace_events.append(
                    {"name": "thread_name", "ph": "M", "pid": os.getpid(),
                     "tid": tid, "args": {"name": f"request/{uid}"}})
            ev = {"name": f"req/{phase}", "cat": "serving",
                  "ts": round((t0 - self._epoch) * 1e6, 3),
                  "pid": os.getpid(), "tid": tid,
                  "args": {"uid": uid, **args}}
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 3)
            self.trace_events.append(ev)
            self._emit_jsonl({"name": f"serving/phase/{phase}",
                              "kind": "span", "value": dur or 0.0,
                              "tags": {"uid": uid, **args}})

    def record_request_flow(self, uid, point, end=False, **args):
        """One hop of request ``uid``'s causal chain as a Chrome flow event:
        the first call for a uid opens the chain (ph "s"), later calls step
        it (ph "t"), ``end=True`` terminates it (ph "f"). Every hop of a
        uid shares one flow id, derived from the uid."""
        if not self.enabled:
            return
        with self._lock:
            rel = _now() - self._epoch
            fid = self._flow_ids.get(uid)
            if fid is None:
                ph = "s"
                fid = self._flow_ids[uid] = int(uid)
            else:
                ph = "f" if end else "t"
            ev = {"name": "reqflow", "cat": "serving", "ph": ph, "id": fid,
                  "ts": round(rel * 1e6, 3), "pid": os.getpid(),
                  "tid": self._request_lanes.get(uid, 0),
                  "args": {"uid": uid, "point": point, **args}}
            if ph == "f":
                ev["bp"] = "e"
            self.trace_events.append(ev)
            self._emit_jsonl({"name": f"serving/flow/{point}",
                              "kind": "flow", "value": fid,
                              "tags": {"uid": uid, "flow_phase": ph,
                                       **args}})

    def _serving_summary(self):
        # caller holds self._lock
        hists = {}
        for name, h in sorted(self.hist_stats.items()):
            if h["count"]:
                p50, p95, p99 = (_hist_quantile(h, q)
                                 for q in (0.5, 0.95, 0.99))
                entry = {"count": h["count"],
                         "mean_s": round(h["sum"] / h["count"], 6),
                         "min_s": round(h["min"], 6),
                         "max_s": round(h["max"], 6),
                         "p50_s": round(p50, 6), "p95_s": round(p95, 6),
                         "p99_s": round(p99, 6)}
            else:
                entry = {"count": 0, "mean_s": 0.0, "min_s": 0.0,
                         "max_s": 0.0, "p50_s": 0.0, "p95_s": 0.0,
                         "p99_s": 0.0}
            hists[name] = entry
        gauges = {name: {"last": round(g[0], 6), "peak": round(g[1], 6)}
                  for name, g in sorted(self.serving_gauges.items())}
        return {"requests": {k: int(v) for k, v in
                             sorted(self.serving_counters.items())},
                "histograms": hists, "gauges": gauges}

    # ------------------------------------------------------------------
    # exporters
    # ------------------------------------------------------------------
    def _emit_jsonl(self, obj):
        # callers hold self._lock
        if not self.jsonl_path:
            return
        if self._jsonl_fh is None:
            d = os.path.dirname(self.jsonl_path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._jsonl_fh = open(self.jsonl_path, "a")
        obj["ts"] = round(_now() - self._epoch, 6)
        obj["host"] = self.host
        obj["pid"] = os.getpid()
        obj["run_id"] = self.run_id
        self._jsonl_fh.write(json.dumps(obj) + "\n")
        self._jsonl_fh.flush()

    def export_chrome_trace(self, path=None):
        """Write the accumulated events as a Chrome-trace file (the
        ``{"traceEvents": [...]}`` form; load in ``chrome://tracing`` or
        https://ui.perfetto.dev). Returns the path written."""
        path = path or self.chrome_trace_path
        if not path:
            raise ValueError("no chrome_trace_path configured")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with self._lock:
            meta = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
                     "args": {"name": f"{self.host}:{os.getpid()}"}}]
            doc = {"traceEvents": meta + list(self.trace_events),
                   "displayTimeUnit": "ms",
                   "otherData": {"producer": "deepspeed_tpu_torch.telemetry",
                                 "host": self.host,
                                 "run_id": self.run_id}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def attach_overlap(self, report):
        """Attach an overlap report (``telemetry/overlap.py``: from a
        profiler trace or on given seconds) so it rides
        ``summary()["overlap"]``. Raises ``ValueError`` on a malformed
        report. Returns the report, or None when telemetry is disabled."""
        if not self.enabled:
            return None
        from deepspeed_tpu_torch.telemetry import overlap as _overlap
        errs = _overlap.validate_report(report)
        if errs:
            raise ValueError("invalid overlap report: " + "; ".join(errs))
        with self._lock:
            self.overlap_report = report
            self.record("overlap/exposed_comm_s", report["exposed_comm_s"],
                        kind="gauge", mode=report["mode"],
                        overlap_fraction=report["overlap_fraction"])
        return report

    def summary(self):
        """One JSON-able dict aggregating every stream (schema:
        ``deepspeed_tpu_torch/telemetry/summary.schema.json``)."""
        if not self.enabled:
            return {"enabled": False}
        with self._lock:
            spans = {name: {"count": c, "total_s": round(tot, 6),
                            "mean_s": round(tot / c, 6) if c else 0.0}
                     for name, (c, tot) in sorted(self.span_stats.items())}
            counters = {name: {",".join(f"{k}={v}" for k, v in key) or "_": n
                               for key, n in per.items()}
                        for name, per in sorted(self.counters.items())}
            out = {"enabled": True, "spans": spans, "counters": counters,
                   "serving": self._serving_summary(),
                   "fleet": self._fleet_summary(),
                   "timeseries": {name: ring.summary() for name, ring
                                  in sorted(self.series.items())},
                   "slo": self._slo_summary()}
            if self.overlap_report is not None:
                out["overlap"] = self.overlap_report
            return out

"""Serving telemetry (port of ``deepspeed_tpu/telemetry/__init__.py``):
spans, counters, request-lifecycle histograms and gauges, per-request
Chrome-trace lanes and flows, ring time series and SLO classes.

Module-level functions delegate to one process-global :class:`Telemetry`
pipeline, so the scheduler, the engine and the KV cache feed the same
sinks::

    from deepspeed_tpu_torch import telemetry

    telemetry.configure(enabled=True, jsonl_path="metrics.jsonl",
                        chrome_trace_path="trace.json")
    ...  # serve through SplitFuseScheduler
    print(telemetry.summary()["serving"]["histograms"]["serving/ttft_s"])
    telemetry.export_chrome_trace()

Disabled (the default), every call here is a constant-time no-op: no clock
read, no device synchronisation, no file I/O.

``attach_overlap(report)`` makes a device-timeline overlap report
(``telemetry/overlap.py``) ride ``summary()["overlap"]``.

What waits raises ``NotImplementedError`` naming its ``ROADMAP.md`` item:
the comm, dispatch, compile, memory, MoE and goodput-ledger streams and the
flight recorder (A15).
"""

from deepspeed_tpu_torch.telemetry.core import Telemetry, _NULL_SPAN  # noqa: F401

_GLOBAL = Telemetry()


def get_telemetry():
    """The process-global pipeline object."""
    return _GLOBAL


def enabled():
    return _GLOBAL.enabled


def configure(**kwargs):
    """Configure the global pipeline (see :meth:`Telemetry.configure`)."""
    _GLOBAL.configure(**kwargs)


def record(name, value, kind="gauge", **tags):
    _GLOBAL.record(name, value, kind=kind, **tags)


def count(name, n=1, **tags):
    _GLOBAL.count(name, n=n, **tags)


def span(name, **tags):
    return _GLOBAL.span(name, **tags)


def span_begin(name, **tags):
    return _GLOBAL.span_begin(name, **tags)


def record_hist(name, value, **tags):
    """One sample into a fixed-bucket log2 histogram (serving latencies)."""
    _GLOBAL.record_hist(name, value, **tags)


def hist_percentiles(name, qs=(0.5, 0.95, 0.99)):
    """Percentile tuple for histogram ``name`` (None when empty)."""
    return _GLOBAL.hist_percentiles(name, qs=qs)


def serving_event(event, n=1, **tags):
    """Count one request-lifecycle event (submitted/finished/evicted/...)."""
    _GLOBAL.serving_event(event, n=n, **tags)


def serving_gauge(name, value, **tags):
    """Record a scheduler/KV gauge sample (last + peak + counter track)."""
    _GLOBAL.serving_gauge(name, value, **tags)


def gauge_value(name):
    """Last value of serving gauge ``name`` (None when disabled/absent)."""
    return _GLOBAL.gauge_value(name)


def slo_class_targets():
    """Installed per-class SLO targets ({} when none configured)."""
    return _GLOBAL.slo_class_targets()


def record_request_phase(uid, phase, t0, dur=None, **args):
    """One request-lifecycle phase on the request's Chrome-trace lane."""
    _GLOBAL.record_request_phase(uid, phase, t0, dur=dur, **args)


def record_request_flow(uid, point, end=False, **args):
    """One hop of a request's flow chain (Chrome flow event: the first call
    opens with ph "s", later ones step "t", ``end=True`` "f")."""
    _GLOBAL.record_request_flow(uid, point, end=end, **args)


def record_series(name, value, **tags):
    """One sample into the fixed-window ring time series ``name``."""
    _GLOBAL.record_series(name, value, **tags)


def series_windows(name):
    """Live windows of series ``name`` (None when absent/disabled)."""
    return _GLOBAL.series_windows(name)


def set_slo_classes(classes):
    """Install per-class SLO latency targets (survives ``reset()``)."""
    _GLOBAL.set_slo_classes(classes)


def slo_observe(slo_class, metric, value, n=1):
    """One latency observation against an SLO class target ("ttft"/"tpot"):
    per-class histogram, attainment counters, burn-rate gauges."""
    _GLOBAL.slo_observe(slo_class, metric, value, n=n)


def slo_snapshot():
    """Live per-class attainment snapshot ({} when disabled)."""
    return _GLOBAL.slo_snapshot()


def fleet_event(event, n=1, **tags):
    """Count one fleet outcome (admitted/queued/rejected/affinity_hit/...)."""
    _GLOBAL.fleet_event(event, n=n, **tags)


def fleet_gauge(name, value, **tags):
    """Record a fleet-level gauge (queue depth, shed rate, live replicas)."""
    _GLOBAL.fleet_gauge(name, value, **tags)


def record_handoff(uid, pages, nbytes, seconds, src="prefill", dst="decode",
                   bound=None, wire_nbytes=None):
    """One prefill->decode KV page handoff (see ``Telemetry.record_handoff``)."""
    _GLOBAL.record_handoff(uid, pages, nbytes, seconds, src=src, dst=dst,
                           bound=bound, wire_nbytes=wire_nbytes)


def summary():
    return _GLOBAL.summary()


def export_chrome_trace(path=None):
    return _GLOBAL.export_chrome_trace(path)


def reset():
    _GLOBAL.reset()


def close():
    _GLOBAL.close()


def attach_overlap(report):
    """Attach an overlap report (``telemetry/overlap.py``) so it rides
    ``summary()["overlap"]``; None when telemetry is disabled."""
    return _GLOBAL.attach_overlap(report)


def _waits(name, item):
    def unported(*args, **kwargs):
        raise NotImplementedError(
            f"telemetry.{name} is not ported to deepspeed_tpu_torch yet; "
            f"see ROADMAP.md queue {item}")
    unported.__name__ = name
    unported.__doc__ = f"Not ported yet (ROADMAP.md queue {item})."
    return unported


_PLATFORM = "A15 (platform)"
for _name, _item in (
        ("record_comm", _PLATFORM), ("record_dispatch", _PLATFORM),
        ("record_compile", _PLATFORM), ("record_memory", _PLATFORM),
        ("sample_memory", _PLATFORM), ("maybe_oom_postmortem", _PLATFORM),
        ("oom_postmortem", _PLATFORM), ("set_model_flops", _PLATFORM),
        ("ledger_add", _PLATFORM), ("ledger_step", _PLATFORM),
        ("monitor_events", _PLATFORM), ("moe_gauge", _PLATFORM),
        ("record_moe_step", _PLATFORM), ("flight_record", _PLATFORM),
        ("flush_postmortem", _PLATFORM), ("format_summary", _PLATFORM),
        ("log_summary", _PLATFORM)):
    globals()[_name] = _waits(_name, _item)
del _name, _item

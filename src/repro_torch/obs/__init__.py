"""repro_torch.obs: the port's observability layer for the drivers and the
service.

The standard library and numpy only at import (the trace module imports
torch inside its device sync):

  * :mod:`repro_torch.obs.trace`   hierarchical spans with a ``sync`` knob
    (the current CUDA stream of each declared output is synchronized at
    span exit, so device time lands in the span that incurred it), a
    process-global recorder that is a no-op when disabled, and Chrome
    trace-event JSON export, one lane per phase;
  * :mod:`repro_torch.obs.metrics` counters, gauges and streaming
    histograms behind a named registry, exported as a JSONL snapshot that
    the reference's registry reads too;
  * :mod:`repro_torch.obs.shardprof` measured per-shard, per-ring-step
    profiles of the serial ring's builds and fixpoints, comparable with the
    planner's predicted ``PlanStats`` (the
    ``partition.predicted_vs_measured_*`` gauges);
  * :mod:`repro_torch.obs.slo`     per-query-class latency budgets with a
    rolling-window p99, breach counters and a breach callback;
  * :mod:`repro_torch.obs.flight`  an always-on bounded ring of recent
    spans, dumped to Perfetto-loadable JSON on an engine exception, an SLO
    breach or an admission stall (importing this package installs its span
    listener);
  * :mod:`repro_torch.obs.report`  the self-contained HTML report of a run
    (tiles, phase breakdown, shard skew, admission, kernel tuning, SLO),
    byte-identical to the reference's for the same inputs.

The launchers expose tracing and metrics with ``--trace OUT.json`` and
``--metrics OUT.jsonl`` (``launch/common.observe``).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     counter, gauge, histogram, load_jsonl, registry)
from repro_torch.obs.trace import (PHASES, Recorder, Span, add_span_listener,
                                   get_recorder, remove_span_listener, span, traced,
                                   tracing_enabled)
# importing flight installs the always-on span listener (bounded ring)
from repro_torch.obs.flight import FlightRecorder, get_flight_recorder
from repro_torch.obs.slo import SLOConfig, SLOWatchdog
from repro_torch.obs.shardprof import MeasuredProfile, ShardProfiler, last_profile, profiles

__all__ = [
    "PHASES", "Recorder", "Span", "get_recorder", "span", "traced",
    "tracing_enabled", "add_span_listener", "remove_span_listener",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "counter", "gauge",
    "histogram", "load_jsonl", "registry",
    "FlightRecorder", "get_flight_recorder",
    "SLOConfig", "SLOWatchdog",
    "MeasuredProfile", "ShardProfiler", "last_profile", "profiles",
]

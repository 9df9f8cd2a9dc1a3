"""repro_torch.obs — serving observability (port of ``repro/obs``):
structured tracing with Perfetto export (trace), a typed metrics registry
with Prometheus exposition (registry), and the sampled step timer and the
torch.profiler window (profile)."""
from .profile import NULL_TIMER, NullStepTimer, StepTimer, profile_trace
from .registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus,
)
from .trace import (
    NULL_TRACER,
    TRACE_SCHEMA_VERSION,
    NullTracer,
    TraceRecord,
    Tracer,
    get_tracer,
    records_to_perfetto,
    set_tracer,
)

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TIMER",
    "NULL_TRACER",
    "NullStepTimer",
    "NullTracer",
    "StepTimer",
    "TRACE_SCHEMA_VERSION",
    "TraceRecord",
    "Tracer",
    "get_tracer",
    "parse_prometheus",
    "profile_trace",
    "records_to_perfetto",
    "set_tracer",
]

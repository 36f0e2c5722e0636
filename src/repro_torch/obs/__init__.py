"""Observability modules of the port (verbatim copies from the JAX
package): the metrics registry, the SLO burn-rate meter, the lifecycle
span tracer, its exporters and the flight recorder."""
from repro_torch.obs.burnrate import BurnRateMeter
from repro_torch.obs.export import (build_batch_spans, build_request_spans,
                                    chrome_trace, write_chrome_trace,
                                    write_request_csv)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import (EV_BATCH, EV_DETAIL, EV_ENDPOINT, EV_KIND,
                                   EV_REQ, EV_SIZE, EV_T, EV_VALUE, SPAN_KINDS,
                                   Tracer, serialize_events)

__all__ = [
    "BurnRateMeter",
    "Counter",
    "EV_BATCH",
    "EV_DETAIL",
    "EV_ENDPOINT",
    "EV_KIND",
    "EV_REQ",
    "EV_SIZE",
    "EV_T",
    "EV_VALUE",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SPAN_KINDS",
    "Tracer",
    "build_batch_spans",
    "build_request_spans",
    "chrome_trace",
    "serialize_events",
    "write_chrome_trace",
    "write_request_csv",
]

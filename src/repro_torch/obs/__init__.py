"""Observability modules the copied control plane imports: the metrics
registry, the SLO burn-rate meter and the lifecycle span tracer (verbatim
copies from the JAX package). The exporters and the flight recorder are
not copied yet."""
from repro_torch.obs.burnrate import BurnRateMeter  # noqa: F401
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import SPAN_KINDS, Tracer  # noqa: F401

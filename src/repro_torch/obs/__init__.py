"""Observability modules the copied control plane imports: the metrics
registry and the SLO burn-rate meter (verbatim copies from the JAX
package). Tracing and exporters are not copied yet."""
from repro_torch.obs.burnrate import BurnRateMeter  # noqa: F401
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401

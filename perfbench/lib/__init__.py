"""The benchmark's machinery: spec loading, traffic, weights, the live run,
tracing, the yardstick (peaks and kernel cost formulas) and the check."""

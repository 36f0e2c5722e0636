"""Sim↔real calibration bridge: measured batch latencies → simulator models.

Closes the loop :class:`~repro.serverless.latency.MeasuredLatency` was
designed for. A live source — an
:class:`~repro.runtime.server.AsyncProxyServer` run (its
``bucket_samples``), a real :class:`~repro.serving.engine.InferenceEngine`
profile, or a ``bench_batch_scaling.py`` CSV — yields per-bucket batch
latencies; :class:`Calibration` fits them into
:class:`~repro.serverless.latency.AffineLatency` /
:class:`~repro.serverless.latency.MeasuredLatency` parameters and
round-trips through a JSON document the simulator can load, so simulated
studies run against *measured* service-time curves instead of assumed
ones (the validation methodology of LazyBatching / HarmonyBatch).

Calibration JSON format (versioned; documented in README "Live runtime"):

.. code-block:: json

    {
      "version": 1,
      "source": "live:ep",
      "buckets": [
        {"bucket": 1, "n": 42, "mean_s": 0.021, "p95_s": 0.030},
        {"bucket": 4, "n": 17, "mean_s": 0.034, "p95_s": 0.047}
      ],
      "affine": {"a": 0.018, "c": 0.004},
      "noise_cv": 0.11
    }
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serverless.latency import AffineLatency, LatencyModel, MeasuredLatency

CALIBRATION_VERSION = 1


@dataclasses.dataclass
class BucketStat:
    """Summary of one bucket's measured batch latencies."""

    bucket: int
    n: int
    mean_s: float
    p95_s: Optional[float] = None


@dataclasses.dataclass
class Calibration:
    """Fitted per-bucket latency profile, serializable to/from JSON."""

    source: str
    buckets: List[BucketStat]
    affine_a: float
    affine_c: float
    noise_cv: float

    # ------------------------------------------------------------- builders
    @classmethod
    def from_samples(cls, samples: Dict[int, Sequence[float]],
                     source: str = "live") -> "Calibration":
        """Fit raw per-bucket samples (bucket → measured seconds list).

        Per-bucket means and the pooled noise CV come from the one
        canonical fit, :meth:`MeasuredLatency.from_samples`; this adds the
        per-bucket sample counts / P95s and the affine fit on top.
        """
        fitted = MeasuredLatency.from_samples(samples)
        means = dict(fitted.points)
        stats: List[BucketStat] = []
        for b, vals in sorted(samples.items()):
            arr = np.asarray([float(v) for v in vals], dtype=np.float64)
            if not len(arr):
                continue
            stats.append(BucketStat(
                bucket=int(b), n=int(len(arr)), mean_s=means[int(b)],
                p95_s=float(np.percentile(arr, 95)),
            ))
        affine = AffineLatency.fit([(s.bucket, s.mean_s) for s in stats])
        return cls(source=source, buckets=stats, affine_a=affine.a,
                   affine_c=affine.c, noise_cv=fitted.noise_cv)

    @classmethod
    def from_batch_scaling_csv(cls, path: str, workload: str) -> "Calibration":
        """Load one workload's curve from ``bench_batch_scaling.py`` output
        (columns ``workload, batch_size, rt_ms``)."""
        import csv

        samples: Dict[int, List[float]] = {}
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                if row["workload"] != workload:
                    continue
                samples.setdefault(int(row["batch_size"]), []).append(
                    float(row["rt_ms"]) / 1000.0
                )
        if not samples:
            raise ValueError(f"no rows for workload {workload!r} in {path}")
        return cls.from_samples(samples, source=f"bench:{workload}")

    # --------------------------------------------------------------- models
    def points(self) -> List[Tuple[int, float]]:
        return [(s.bucket, s.mean_s) for s in self.buckets]

    def measured_model(self, noise_cv: Optional[float] = None) -> MeasuredLatency:
        """The fitted piecewise-linear model the simulator should load."""
        return MeasuredLatency(
            points=self.points(),
            noise_cv=self.noise_cv if noise_cv is None else noise_cv,
            name=f"calibrated:{self.source}",
        )

    def affine_model(self, noise_cv: Optional[float] = None) -> AffineLatency:
        """The fitted affine model (the paper's primary s(b) = a + c·b)."""
        return AffineLatency(
            a=self.affine_a, c=self.affine_c,
            noise_cv=self.noise_cv if noise_cv is None else noise_cv,
            name=f"calibrated:{self.source}",
        )

    # ----------------------------------------------------------------- JSON
    def to_json(self) -> dict:
        return {
            "version": CALIBRATION_VERSION,
            "source": self.source,
            "buckets": [dataclasses.asdict(s) for s in self.buckets],
            "affine": {"a": self.affine_a, "c": self.affine_c},
            "noise_cv": self.noise_cv,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "Calibration":
        if doc.get("version") != CALIBRATION_VERSION:
            raise ValueError(
                f"unsupported calibration version {doc.get('version')!r}"
            )
        return cls(
            source=doc["source"],
            buckets=[BucketStat(**s) for s in doc["buckets"]],
            affine_a=float(doc["affine"]["a"]),
            affine_c=float(doc["affine"]["c"]),
            noise_cv=float(doc["noise_cv"]),
        )

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "Calibration":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # ----------------------------------------------------------- round-trip
    def roundtrip_errors(self, model: Optional[LatencyModel] = None, *,
                         seed: int = 0, reps: int = 400) -> Dict[int, float]:
        """Relative error, per bucket, of the fitted model's *simulated*
        mean batch latency against the measured mean.

        Draws ``reps`` samples per bucket through ``model.sample`` — the
        exact call the simulated platform makes — so the check covers the
        noise model as well as the mean curve (measure → fit → simulate).
        """
        model = model if model is not None else self.measured_model()
        rng = np.random.default_rng(seed)
        errors: Dict[int, float] = {}
        for s in self.buckets:
            sim_mean = float(np.mean(
                [model.sample(s.bucket, rng) for _ in range(reps)]
            ))
            errors[s.bucket] = abs(sim_mean - s.mean_s) / max(s.mean_s, 1e-12)
        return errors

    def verify_roundtrip(self, rtol: float = 0.10, **kw) -> Dict[int, float]:
        """Assert the measure→fit→simulate round-trip reproduces measured
        means within ``rtol`` on every bucket; returns per-bucket errors."""
        errors = self.roundtrip_errors(**kw)
        bad = {b: e for b, e in errors.items() if e > rtol}
        if bad:
            raise AssertionError(
                f"calibration round-trip outside {rtol:.0%}: {bad}"
            )
        return errors


def measure_engine(engine, *, prompt_len: int = 16,
                   gen_len: Optional[int] = None, repeats: int = 3,
                   seed: int = 0) -> Calibration:
    """Profile a real :class:`InferenceEngine` across its batch buckets.

    The live-hardware entry point of the bridge (requires JAX; not used by
    tests). Runs ``repeats`` generations per compiled bucket and fits the
    measured wall seconds.
    """
    rng = np.random.default_rng(seed)
    samples: Dict[int, List[float]] = {}
    for bucket in engine.ecfg.batch_buckets:
        for _ in range(repeats):
            prompts = rng.integers(
                0, engine.cfg.vocab_size, size=(bucket, prompt_len)
            ).astype(np.int32)
            _, timing = engine.generate(prompts, gen_len=gen_len)
            samples.setdefault(bucket, []).append(float(timing["latency_s"]))
    return Calibration.from_samples(samples, source=f"engine:{engine.cfg.name}")

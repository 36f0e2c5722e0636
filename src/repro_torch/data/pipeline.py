"""Token data pipeline for the training examples.

Deterministic, restartable synthetic LM data (byte-level corpus rolled into
fixed-length windows) — self-contained (no downloads) while exercising the
real pipeline machinery: sharded batches, prefetch, checkpointable iterator
state (step counter → exact resume after preemption).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer

_DEFAULT_TEXT = (
    "MLProxy is an adaptive reverse proxy supporting efficient machine "
    "learning serving on serverless platforms. Batching requests reduces "
    "the per-inference overhead; an SLA-aware controller keeps the tail "
    "latency within the service level objective while the AIMD optimizer "
    "grows the batch size whenever the platform has headroom. "
) * 512


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    vocab_size: int = 256
    seed: int = 0
    text: Optional[str] = None


class TokenDataset:
    """Checkpointable synthetic LM dataset.

    ``state()``/``restore()`` capture the iterator position so a preempted
    training job resumes on the exact batch it would have seen.
    """

    def __init__(self, config: DataConfig) -> None:
        self.config = config
        tok = ByteTokenizer(vocab_size=config.vocab_size)
        corpus = tok.encode(config.text or _DEFAULT_TEXT)
        # roll a long corpus; wrap-around indexing makes it infinite
        self._corpus = np.asarray(corpus, dtype=np.int32)
        if len(self._corpus) < config.seq_len + 1:
            reps = (config.seq_len + 1) // max(len(self._corpus), 1) + 1
            self._corpus = np.tile(self._corpus, reps)
        self._step = 0
        self._rng = np.random.default_rng(config.seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.config
        n = len(self._corpus) - cfg.seq_len - 1
        # deterministic offsets derived from (seed, step) — restartable
        rng = np.random.default_rng((cfg.seed, self._step))
        starts = rng.integers(0, n, size=cfg.global_batch)
        idx = starts[:, None] + np.arange(cfg.seq_len + 1)[None, :]
        window = self._corpus[idx]
        self._step += 1
        return {
            "tokens": window[:, :-1].astype(np.int32),
            "labels": window[:, :-1].astype(np.int32),  # next-token via shift in loss
        }

    # ------------------------------------------------------ fault tolerance
    def state(self) -> dict:
        return {"step": self._step, "seed": self.config.seed}

    def restore(self, state: dict) -> None:
        if state["seed"] != self.config.seed:
            raise ValueError("restoring dataset with a different seed")
        self._step = int(state["step"])

    @property
    def step(self) -> int:
        return self._step

"""PyTorch inference engine — the data plane MLProxy fronts on the card.

Same public surface as the JAX package's ``serving/engine.py``
(``next_bucket``, ``EngineConfig``, ``InferenceEngine``, ``ReplicaPool``,
``compile_count``, ``cache_allocs``, ``stats``, the ``warmup()`` timings
and the ``generate()`` timing keys), so later slices can plug it into the
simulator and the live runtime through the same duck-typed seams.

Batches still pad to (batch bucket, prompt bucket) slots: the proxy's
monitor keys its latency windows by the padded bucket size, and the
per-bucket KV pool is what the kernels read.

* **Compiled programs as CUDA graphs** (on the card, with ``fused_decode``
  and ``cache_pool`` on, the defaults): the JAX engine runs a batch as two
  compiled programs, prefill per (bucket, plen) and the whole greedy loop
  per (bucket, steps). Here each of those keys is one captured CUDA graph:
  ``generate()`` copies the padded prompt into the prefill graph's static
  token buffer, replays it, copies its first token into the loop graph's
  static input, replays that, and reads the tokens back once. A key is
  captured at its first use, right after an eager run of the same key
  (which loads every kernel and sizes every workspace the capture
  records); ``warmup()`` runs each key twice, so it pays the capture as
  the JAX engine pays its compile there. ``compile_count`` counts the
  same keys as before. A graph is bound to the pooled cache of its
  bucket, which never moves and is updated in place. A batch with a fresh
  cache (``cache_pool=False``, or a pool miss, which also drops the
  bucket's graphs) runs eagerly: that is not a fallback, since a graph
  would read the wrong tensors. A capture runs on the engine's own stream
  and waits for no other (not ``torch.cuda.graph``, which synchronises the
  whole device on entry); the engine's graphs share one memory pool, never
  another engine's. A capture or replay that fails raises: nothing goes
  back to the eager loop. The xLSTM cache reset stays eager, at checkout.
* **Fused decode** (``EngineConfig.fused_decode``, default on): the greedy
  loop keeps every token on the device and reads them back once, with the
  final ``.cpu()``; no host sync per step. ``fused_decode=False`` is the
  per-token reference loop, which brings each token to the host and runs
  eagerly on the card too. Both give the same tokens (greedy argmax over
  the same logits). Off the card the fused loop runs eagerly.
* **Gen-length bucketing** (``EngineConfig.gen_buckets``): a requested
  length rounds up to the next step bucket; extra tokens are computed and
  sliced off (greedy decoding is prefix-stable).
* **Persistent KV pool** (``EngineConfig.cache_pool``, default on): each
  batch bucket has one statically allocated cache, checked out per call.
  Prefill writes each layer's K/V into it in place and resets its length;
  decode writes at the length and masks positions past it, so the stale
  rows of an earlier batch are never attended. (JAX donates the cache to
  the compiled program; here the updates are in place.)
* **Recurrent state in the pool** (the xLSTM family): prefill *reads* the
  state it is given (the mLSTM conv prefix, the sLSTM carry), so the
  argument above does not hold for it. A pooled recurrent cache is put back
  to ``init_cache``'s values, in place, at every checkout: a batch gets the
  tokens a fresh cache gives it. (The JAX engine hands the previous batch's
  state to the next prefill; its reference here is ``cache_pool=False``.)
* **Hybrid state in the pool** (the Zamba2 family): its cache holds SSM
  state and conv prefixes too, but prefill reads none of it — it starts
  each Mamba block from a zero state and overwrites the state, the K/V
  rows of the prompt and the length in place. So a pooled hybrid cache is
  reused as is, like a KV cache, with no reset. (The JAX hybrid prefill
  reads the cache's state, so its pooled engine leaks it too; the
  reference is again ``cache_pool=False``.)
* **RoPE tables** are computed once per engine, on its device, for the
  families that use them, at the model's ``max_seq_len`` as the JAX
  model's decode builds them: a request with plen + gen_len - 1 >
  ``max_len`` decodes past the cache's end, and gets the JAX engine's
  tokens (the model clamps the cache write onto the last row, as
  ``dynamic_update_slice`` does).
* **One CUDA stream per engine**: on the card each engine (each replica
  of a pool) runs ``generate()`` and ``warmup()`` on a stream of its own
  and synchronises only that stream, so one replica's measured latency —
  what the Smart Monitor learns from — holds its own work and not the
  other replicas'. The weights and RoPE tables are made on the default
  stream; the engine's stream waits for them once, when it is created.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import rope_frequencies
from repro_torch.models.model import Model


def next_bucket(n: int, buckets: Sequence[int], clamp: bool = False) -> int:
    """Smallest bucket holding ``n`` requests.

    ``clamp=True`` returns the largest bucket for oversized ``n`` instead
    of raising — for *estimation* paths that must stay total. Execution
    paths keep the strict default and chunk oversized batches instead (see
    ``serving/batcher.py``).
    """
    for b in buckets:
        if n <= b:
            return b
    if clamp:
        return buckets[-1]
    raise ValueError(f"batch {n} exceeds largest bucket {buckets[-1]}")


#: The sanctioned wall clock for real-measurement code (this module and
#: its adapters). Everything that *models* time takes an injected clock.
wall_clock = time.monotonic  # reprolint: disable=wallclock


@dataclasses.dataclass
class EngineConfig:
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    prompt_buckets: Tuple[int, ...] = (16, 32, 64, 128)
    max_len: int = 160  # prompt bucket + generation budget
    gen_len: int = 8
    greedy: bool = True
    #: Keep the decode loop's tokens on the device until the end (no host
    #: sync per step). Off = the per-token reference loop (same tokens).
    fused_decode: bool = True
    #: Step buckets for the fused loop: a requested gen_len rounds up to
    #: the next bucket (extra tokens are computed then sliced off). None =
    #: run exactly the requested length.
    gen_buckets: Optional[Tuple[int, ...]] = None
    #: Reuse KV caches across batches via a per-bucket pool instead of
    #: allocating + zero-filling per generate() call.
    cache_pool: bool = True


@dataclasses.dataclass
class CapturedGraph:
    """One key's compiled program on the card: a CUDA graph, its static
    input and output (replay reads ``inp`` and overwrites ``out``), the
    pooled cache it reads and writes, and the kernel launches (by wrapper
    name) that one replay makes."""
    graph: Any
    inp: torch.Tensor
    out: torch.Tensor
    cache: Any
    launches: Dict[str, int]


#: Families the engine does not serve: as in the JAX engine, which hands
#: ``prefill`` a token array, the encoder-decoder's frames have no way in.
UNSERVED_FAMILIES = ("encdec",)


class InferenceEngine:
    """Single-replica engine: bucketed prefill + greedy decode on one device."""

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Optional[Any] = None, seed: int = 0,
                 device="cuda"):
        if cfg.family in UNSERVED_FAMILIES:
            raise NotImplementedError(
                f"the engine prefills token prompts; family {cfg.family!r} also needs "
                "encoder frames (drive it through Model.prefill with {'frames', 'tokens'})")
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.device = torch.device(device)
        self.model = Model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        self.params = params
        self.rope = (rope_frequencies(cfg.hd, cfg.max_seq_len, cfg.rope_theta,
                                      device=self.device)
                     if self.model.uses_rope else None)
        #: this engine's CUDA stream (None off the card); it waits once for
        #: the weights and tables made on the default stream
        self.stream: Optional[torch.cuda.Stream] = None
        #: the memory pool every graph of this engine captures into (None
        #: off the card, where nothing is captured)
        self.graph_pool = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            self.graph_pool = torch.cuda.graph_pool_handle()
        #: captured programs by key: ("prefill", bucket, plen) and
        #: ("fused", bucket, steps)
        self.graphs: Dict[Tuple, CapturedGraph] = {}
        #: graph replays (a prefill and a loop each count one)
        self.graph_replays = 0
        # First use of each shape key: (bucket, plen) for prefill, bucket
        # for the per-token step, (bucket, steps) for the fused loop — the
        # keys the JAX engine compiles a program for. On the card the
        # prefill and fused keys each capture one CUDA graph.
        self._seen: set = set()
        self._kv_pool: Dict[int, Any] = {}
        self.compile_count = 0
        #: KV-cache allocations (pool misses); with the pool on, this
        #: saturates at one per bucket instead of growing per batch.
        self.cache_allocs = 0
        #: Every prefill and decode step run, warmup included: on the card
        #: each one launches its kernel once per attention layer (or shared
        #: block application) and, for prefill, once per mLSTM or Mamba
        #: layer.
        self.prefill_calls = 0
        self.decode_steps = 0
        self.stats: Dict[str, float] = {"batches": 0, "requests": 0, "tokens": 0}
        self._in_warmup = False

    # ----------------------------------------------------------- shape keys
    def _first_use(self, key) -> None:
        if key not in self._seen:
            self._seen.add(key)
            self.compile_count += 1

    # ------------------------------------------------------------ kv cache
    def _checkout_cache(self, bucket: int):
        cache = self._kv_pool.pop(bucket, None) if self.ecfg.cache_pool else None
        if cache is None:
            cache = self.model.init_cache(bucket, self.ecfg.max_len, device=self.device)
            self.cache_allocs += 1
            # a new cache for the bucket (the last one was lost to an
            # exception mid-batch): its graphs would hold the old one alive
            self.graphs = {k: g for k, g in self.graphs.items() if k[1] != bucket}
        elif self.model.recurrent:
            self.model.reset_cache(cache)
        return cache

    def _return_cache(self, bucket: int, cache) -> None:
        if self.ecfg.cache_pool:
            self._kv_pool[bucket] = cache

    def _gen_steps(self, gen_len: int, plen: int) -> int:
        """Total generated tokens the decode loop produces for ``gen_len``.

        Rounds up to ``gen_buckets``, clamped so decode never writes past
        ``max_len``, and never below the requested length.
        """
        steps = gen_len
        if self.ecfg.gen_buckets:
            steps = next_bucket(gen_len, self.ecfg.gen_buckets, clamp=True)
        return max(gen_len, min(steps, self.ecfg.max_len - plen + 1))

    def _on_stream(self):
        """Context that makes this engine's stream the current one."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _sync(self) -> None:
        """Wait for this engine's own work only (never the whole device)."""
        if self.stream is not None:
            self.stream.synchronize()

    def warmup(self, plen: Optional[int] = None) -> Dict[Tuple[int, int], float]:
        """Run every (batch bucket, prompt bucket) pair twice (what a replica
        does at startup) — or just the pairs of one prompt bucket when
        ``plen`` is given — at the default ``gen_len``, filling the KV pool.
        On the card the first run of a key captures its graph, the second
        replays it. Returns the second run's wall seconds per ``(bucket,
        plen)``.

        Warmup traffic is synthetic: serving ``stats`` are not touched.
        """
        plens = ([next_bucket(plen, self.ecfg.prompt_buckets, clamp=True)]
                 if plen is not None else list(self.ecfg.prompt_buckets))
        timings: Dict[Tuple[int, int], float] = {}
        self._in_warmup = True
        try:
            for b in self.ecfg.batch_buckets:
                for p in plens:
                    prompts = np.zeros((b, p), np.int32)
                    self.generate(prompts)  # cold: first use of each shape
                    _, timing = self.generate(prompts)
                    timings[(b, p)] = timing["latency_s"]
        finally:
            self._in_warmup = False
        return timings

    # ------------------------------------------------------------------ api
    def generate(self, prompts: np.ndarray, gen_len: Optional[int] = None,
                 ) -> Tuple[np.ndarray, Dict[str, float]]:
        """Greedy-decode ``gen_len`` tokens for a batch of prompts, on this
        engine's stream.

        prompts: (n, plen) int32, n ≤ largest bucket. Returns (tokens
        (n, gen_len), timing dict with wall seconds + bucket metadata).
        """
        with self._on_stream():
            return self._generate(prompts, gen_len)

    def _prefill(self, tokens: torch.Tensor, cache) -> torch.Tensor:
        """Prefill ``tokens`` into ``cache`` → the first greedy token (B, 1) int32."""
        logits, _ = self.model.prefill(self.params, tokens, cache, rope=self.rope)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

    def _loop(self, first: torch.Tensor, cache, steps: int) -> torch.Tensor:
        """The fused greedy loop from ``first`` → (B, steps) int32 tokens,
        all on the device."""
        out = torch.empty((first.shape[0], steps), dtype=torch.int32, device=self.device)
        out[:, :1] = first
        for i in range(1, steps):
            logits, _ = self.model.decode_step(self.params, out[:, i - 1:i], cache,
                                               rope=self.rope)
            out[:, i] = torch.argmax(logits[:, -1], dim=-1)
        return out

    def _capture(self, fn, inp: torch.Tensor, cache) -> CapturedGraph:
        """Capture ``fn(inp)`` as a CUDA graph on this engine's stream, into
        its pool. ``thread_local`` capture refuses an unsafe call from this
        thread only, so another replica's thread keeps working; the kernel
        wrappers record their launches on this thread and count nothing."""
        graph = torch.cuda.CUDAGraph()
        with kernel_ops.recording() as launches:
            graph.capture_begin(pool=self.graph_pool, capture_error_mode="thread_local")
            try:
                out = fn(inp)
            finally:
                graph.capture_end()
        return CapturedGraph(graph, inp, out, cache, dict(launches))

    def _replay(self, g: CapturedGraph) -> torch.Tensor:
        g.graph.replay()
        kernel_ops.add_launches(g.launches)
        self.graph_replays += 1
        return g.out

    def _run(self, key: Tuple, inp: torch.Tensor, cache, fn) -> torch.Tensor:
        """``fn(inp)`` for one key (``inp`` on the host or the device): its
        graph replayed if it has one bound to ``cache``, after one copy of
        ``inp`` into the graph's static input; else an eager run, then (when
        this engine captures) the key's capture, bound to ``cache``."""
        g = self.graphs.get(key)
        if g is not None and g.cache is cache:
            g.inp.copy_(inp)
            return self._replay(g)
        inp = inp.to(self.device)
        out = fn(inp)
        if self.graph_pool is not None and self.ecfg.fused_decode and self.ecfg.cache_pool:
            self.graphs[key] = self._capture(fn, inp.clone(), cache)
        return out

    @torch.inference_mode()
    def _generate(self, prompts: np.ndarray, gen_len: Optional[int],
                  ) -> Tuple[np.ndarray, Dict[str, float]]:
        gen_len = gen_len if gen_len is not None else self.ecfg.gen_len
        n, plen_raw = prompts.shape
        bucket = next_bucket(n, self.ecfg.batch_buckets)
        plen = next_bucket(plen_raw, self.ecfg.prompt_buckets)
        self._sync()
        t0 = time.perf_counter()  # reprolint: disable=wallclock
        padded = np.zeros((bucket, plen), np.int32)
        padded[:n, plen - plen_raw:] = prompts  # left-pad into the bucket

        cache = self._checkout_cache(bucket)
        key = ("prefill", bucket, plen)
        self._first_use(key)
        first = self._run(key, torch.from_numpy(padded), cache,
                          lambda t: self._prefill(t, cache))
        self.prefill_calls += 1
        if self.ecfg.fused_decode and gen_len > 1:
            steps = self._gen_steps(gen_len, plen)
            key = ("fused", bucket, steps)
            self._first_use(key)
            out = self._run(key, first, cache, lambda f: self._loop(f, cache, steps))
            self.decode_steps += steps - 1
            result = out[:, :gen_len].cpu().numpy()
        else:
            self._first_use(("decode", bucket))
            toks = [first.cpu().numpy()]
            cur = first
            for _ in range(gen_len - 1):
                logits, cache = self.model.decode_step(self.params, cur, cache,
                                                       rope=self.rope)
                cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
                toks.append(cur.cpu().numpy())
            self.decode_steps += gen_len - 1
            result = np.concatenate(toks, axis=1)
        result = result[:n]
        self._return_cache(bucket, cache)
        self._sync()
        dt = time.perf_counter() - t0  # reprolint: disable=wallclock
        if not self._in_warmup:
            self.stats["batches"] += 1
            self.stats["requests"] += n
            self.stats["tokens"] += n * gen_len
        return result, {
            "latency_s": dt, "bucket": bucket, "prompt_bucket": plen,
            "padding_waste": (bucket - n) / bucket,
        }


class ReplicaPool:
    """Elastic pool of engine replicas with failover (fault-tolerance shim).

    Replicas share weights (one copy on the device) but have independent
    KV pools and health state. ``fail(i)`` marks a replica down (its
    in-flight work is retried elsewhere); ``scale_to`` adds/removes
    replicas. Dispatch prefers an *idle* healthy replica over strict
    rotation; each replica is guarded by its own lock (its KV pool is not
    thread-safe).
    """

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 n_replicas: int = 1, seed: int = 0, device="cuda",
                 params: Optional[Any] = None):
        self._template = InferenceEngine(cfg, engine_cfg, params=params,
                                         seed=seed, device=device)
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.device = self._template.device
        self.replicas: List[Optional[InferenceEngine]] = []
        self.healthy: List[bool] = []
        self._locks: List[threading.Lock] = []
        self._rr = 0
        self.retries = 0
        self.scale_to(n_replicas)

    def scale_to(self, n: int) -> None:
        """Grow or shrink the pool to exactly ``n`` replicas (shrinking
        removes the tail replicas outright)."""
        if n < 0:
            raise ValueError(f"replica count must be >= 0, got {n}")
        if n < len(self.replicas):
            del self.replicas[n:]
            del self.healthy[n:]
            del self._locks[n:]
            self._rr = self._rr % len(self.replicas) if self.replicas else 0
        while len(self.replicas) < n:
            eng = InferenceEngine(self.cfg, self.engine_cfg,
                                  params=self._template.params, device=self.device)
            self.replicas.append(eng)
            self.healthy.append(True)
            self._locks.append(threading.Lock())

    @property
    def n_healthy(self) -> int:
        return sum(self.healthy)

    def fail(self, index: int) -> None:
        self.healthy[index] = False

    def recover(self, index: int) -> None:
        self.healthy[index] = True

    def warmup(self, plen: Optional[int] = None) -> Dict[Tuple[int, int], float]:
        """Warm every replica; returns the first replica's timings."""
        timings: Dict[Tuple[int, int], float] = {}
        for i, eng in enumerate(self.replicas):
            t = eng.warmup(plen)
            if i == 0:
                timings = t
        return timings

    def _acquire_replica(self) -> Tuple[Optional[int], Optional[threading.Lock]]:
        """Pick a healthy replica and acquire its lock: an idle one in
        round-robin order first, else block on the round-robin-next healthy
        one. Returns (None, None) when no replica is healthy."""
        n = len(self.replicas)
        start = self._rr
        for off in range(1, n + 1):
            idx = (start + off) % n
            if not self.healthy[idx]:
                continue
            if self._locks[idx].acquire(blocking=False):
                self._rr = idx
                return idx, self._locks[idx]
        for off in range(1, n + 1):
            idx = (start + off) % n
            if self.healthy[idx]:
                self._rr = idx
                self._locks[idx].acquire()
                return idx, self._locks[idx]
        return None, None

    def generate(self, prompts: np.ndarray, gen_len: Optional[int] = None):
        """Idle-preferring round-robin dispatch with failover (at-least-once)."""
        if not self.replicas:
            raise RuntimeError("no healthy replicas")
        attempts = 0
        while attempts <= len(self.replicas):
            idx, lock = self._acquire_replica()
            if idx is None:
                attempts += 1
                continue
            try:
                out, timing = self.replicas[idx].generate(prompts, gen_len)
                timing["replica"] = idx
                return out, timing
            except RuntimeError:
                self.fail(idx)
                self.retries += 1
                attempts += 1
            finally:
                lock.release()
        raise RuntimeError("no healthy replicas")

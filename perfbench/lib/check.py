"""What decides ``correct``: the proxy's accounting of every request due in
the window, and the served tokens of a sample of them against the plain
float32 reference.

The tokens are judged by the widest logit gap: run the reference once
over each sampled prompt followed by the tokens it was served, and at each
served position take how far the served token's logit lies below the
reference's best. Greedy bfloat16 serving picks another token than float32
only where the two best lie within rounding of each other, so the gap stays
small; a wrong cache, a lost state or a token from another prompt puts it
far off. The control is the same reference computed with fp8 (e4m3) weight
and activation products, the step below the configuration's bfloat16: at
the same positions it reads the gap of the token that fp8 ranks first.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.lib import traffic

FP8_MAX = 448.0  # float8_e4m3fn


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, scaled by its largest magnitude along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A weight product in fp8: activations per row, weights per output
    column, products summed in float32."""
    return _fp8(x, -1) @ _fp8(w, 0)


@contextlib.contextmanager
def strict_float32():
    """Float32 products in float32, not TF32, while the reference runs."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def logit_gaps(ref, model: Dict, params: Dict, prompts: np.ndarray, served: np.ndarray,
               device, rows: int, control: bool = False
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Per sampled request, the widest gap below the reference's best logit
    of the served tokens, and (``control``) of the tokens the fp8 reference
    ranks first at the same positions. prompts (n, P), served (n, G)."""
    n, p = prompts.shape
    seqs = np.concatenate([prompts, served[:, :-1]], axis=1)
    gaps, ctrl = [], []
    with strict_float32(), torch.no_grad():
        for r0 in range(0, n, rows):
            toks = torch.as_tensor(seqs[r0:r0 + rows], dtype=torch.long, device=device)
            want = torch.as_tensor(served[r0:r0 + rows], dtype=torch.long, device=device)
            lg = ref.logits(model, params, toks, p - 1)  # (rows, G, V)
            best = lg.max(dim=-1).values
            gaps.append((best - lg.gather(-1, want[..., None])[..., 0]).amax(-1))
            if control:
                low = ref.logits(model, params, toks, p - 1, mm=fp8_mm)
                pick = low.argmax(dim=-1, keepdim=True)
                ctrl.append((best - lg.gather(-1, pick)[..., 0]).amax(-1))
            del lg
    gap = torch.cat(gaps).cpu().numpy()
    return gap, (torch.cat(ctrl).cpu().numpy() if control else None)


def sample(record, n: int) -> List:
    """``n`` completed counted requests, drawn from the run's seed."""
    done = [r for r in record.counted() if r.failure is None]
    rng = np.random.default_rng([traffic.seed_key(record.seed), 3])
    pick = rng.choice(len(done), size=min(n, len(done)), replace=False)
    return [done[i] for i in sorted(pick)]


def accounting(record, vocab: int) -> Dict[str, int]:
    """Counts of accounting faults over the window's requests; each must be 0."""
    mix = record.mix
    index_of = {r.req_id: r.index for r in record.requests if r.req_id is not None}
    seen: Dict[int, int] = {}
    wrong_prompt = wrong_tokens = 0
    rows_of: Dict[int, np.ndarray] = {}
    for b in record.batches:
        for row, rid in enumerate(b.req_ids):
            seen[rid] = seen.get(rid, 0) + 1
            rows_of[rid] = b.out[row]
            want = traffic.prompt(traffic.seed_key(record.seed), index_of[rid],
                                  mix["prompt_len"], vocab)
            if not np.array_equal(b.prompts[row], want):
                wrong_prompt += 1
    unfinished = served_not_once = 0
    for r in record.counted():
        if r.failure == "unfinished":
            unfinished += 1
            continue
        if r.failure is not None:
            continue  # failed and counted as failed: +inf in the tails
        if seen.get(r.req_id, 0) != 1:
            served_not_once += 1
            continue
        toks = r.tokens
        if (toks is None or toks.shape != (mix["gen_len"],) or toks.min() < 0
                or toks.max() >= vocab or not np.array_equal(toks, rows_of[r.req_id])):
            wrong_tokens += 1
    cons = record.conservation
    return {"unfinished": unfinished, "lost": int(cons["lost"]),
            "duplicate_completions": int(cons["duplicate_completions"]),
            "served_not_once": served_not_once, "wrong_prompt": wrong_prompt,
            "wrong_tokens": wrong_tokens}


def tokens_of(record, requests) -> Tuple[np.ndarray, np.ndarray]:
    """(prompts, served tokens) of ``requests``, as arrays."""
    seed, mix, vocab = traffic.seed_key(record.seed), record.mix, record.model["vocab_size"]
    prompts = np.stack([traffic.prompt(seed, r.index, mix["prompt_len"], vocab)
                        for r in requests])
    return prompts, np.stack([r.tokens for r in requests])

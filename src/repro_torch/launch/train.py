"""Training entry point: data pipeline → train step → checkpoint/restart.

The counterpart of the JAX package's ``launch/train.py``. A step is
``Model.loss`` (the kernels' plain versions, as JAX trains on its plain
path) → backward → ``cosine_schedule`` → ``adamw.apply_updates``. Params
come from ``torch.Generator(device).manual_seed(seed)``: ``jax.random``
init cannot be reproduced, so a run matches JAX's only from params carried
across with ``convert.from_jax``. Checkpoints are the JAX package's layout
(``{"params", "opt"}`` plus the data iterator's state and the arch), so
either package resumes the other's.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --device cpu --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --full-size  # on the card

Reduced configs by default, as JAX's ``main``; ``--device`` defaults to
``cuda`` and raises where there is no card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.utils.tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    seed: int = 0
    warmup_steps: int = 20
    optimizer: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    total_steps: int, warmup: int):
    """Build the (params, opt_state, batch) → (params, opt_state, metrics)
    step; ``metrics`` holds the device scalars ``loss`` and ``grad_norm``."""
    model = Model(cfg)

    def train_step(params, opt_state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
        flat = leaves(params)
        trained = [p for p in flat if p.requires_grad]
        loss = model.loss(params, batch)
        grads = iter(torch.autograd.grad(loss, trained, allow_unused=True))
        grads = unflatten(params, [next(grads) if p.requires_grad else None for p in flat])
        with torch.no_grad():
            params = tree_map(torch.Tensor.detach, params)
            lr_scale = adamw.cosine_schedule(opt_state.step, warmup=warmup, total=total_steps)
            params, opt_state, metrics = adamw.apply_updates(
                opt_cfg, params, grads, opt_state, lr_scale=lr_scale)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch from :class:`TokenDataset` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(cfg: ModelConfig, tcfg: TrainConfig,
          data_cfg: Optional[DataConfig] = None, device="cuda") -> Dict[str, Any]:
    """Run a training job on ``device``; returns final metrics and params."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    data_cfg = data_cfg or DataConfig(
        seq_len=min(cfg.max_seq_len, 128), global_batch=8,
        vocab_size=cfg.vocab_size, seed=tcfg.seed)
    dataset = TokenDataset(data_cfg)
    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(tcfg.seed))
    opt_state = adamw.init_state(tcfg.optimizer, params)

    start_step = 0
    if tcfg.checkpoint_dir:
        restored = ckpt.restore_latest(tcfg.checkpoint_dir,
                                       {"params": params, "opt": opt_state})
        if restored is not None:
            start_step, tree, meta = restored
            params, opt_state = tree["params"], tree["opt"]
            dataset.restore(meta["data"])
            print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, tcfg.optimizer, tcfg.steps, tcfg.warmup_steps)
    losses = []
    t0 = time.perf_counter()  # reprolint: disable=wallclock
    for step in range(start_step, tcfg.steps):
        batch = batch_to(next(dataset), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % tcfg.log_every == 0 or step == tcfg.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0  # reprolint: disable=wallclock
            print(f"[train] step {step+1}/{tcfg.steps} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt/(step-start_step+1)*1000:.0f} ms/step)")
        if tcfg.checkpoint_dir and (step + 1) % tcfg.checkpoint_every == 0:
            ckpt.save_checkpoint(
                tcfg.checkpoint_dir, step + 1,
                {"params": params, "opt": opt_state},
                metadata={"data": dataset.state(), "arch": cfg.name})
            ckpt.prune_checkpoints(tcfg.checkpoint_dir, tcfg.keep_checkpoints)
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "params": params,
        "opt": opt_state,
        "steps": tcfg.steps,
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--full-size", action="store_true",
                   help="use the full config (needs the card)")
    args = p.parse_args()
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    tcfg = TrainConfig(steps=args.steps, checkpoint_dir=args.checkpoint_dir)
    data_cfg = DataConfig(seq_len=args.seq_len, global_batch=args.batch,
                          vocab_size=cfg.vocab_size)
    out = train(cfg, tcfg, data_cfg, device=args.device)
    print(f"[train] done: loss {out['first_loss']:.4f} → {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()

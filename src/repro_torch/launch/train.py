"""Training launcher: --arch <id> [--smoke] with checkpoint and restart.

Port of ``repro.launch.train`` for one device (the reference's
``NULL_LAYOUT``): the model from a seeded ``torch.Generator``, the train
step, deterministic batches (``data.tokens.batch_at_step``), a
checkpoint after every 50th step and at the end, and a resume from the
latest checkpoint in ``ckpt_dir``.

    python -m repro_torch.launch.train --arch gemma3-4b --smoke --steps 50
    python -m repro_torch.launch.train --arch gemma3-4b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
from repro_torch.device import resolve_device
from repro_torch.optim import OptConfig
from repro_torch.train.train_step import (
    TrainHParams,
    load_state_tree,
    make_train_state,
    make_train_step,
    state_tree,
)


def run(arch: str | ModelConfig, *, smoke: bool = False, steps: int = 50, seq_len: int = 128,
        batch: int = 8, ckpt_dir: str | None = None, lr: float = 3e-4, log_every: int = 10,
        hp: TrainHParams | None = None, device=None) -> list[float]:
    """Train ``arch`` (an id, or a ``ModelConfig`` as it is) for ``steps``
    steps on ``device`` (``None``: the card); returns each step's loss.

    A smoke config runs in float32, as the reference's launcher runs it.
    ``hp`` defaults to the reference's: AdamW at ``lr``, warmup a tenth
    of ``steps``, cosine to ``steps``; an ``hp`` whose ``total_steps`` is
    past ``steps`` cuts a run short of its schedule, to be resumed by a
    run to ``total_steps``.  With ``ckpt_dir`` a run resumes from its
    latest checkpoint, saves after every 50th step (as step + 1) and at
    the end."""
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        if smoke:
            cfg = dataclasses.replace(cfg, dtype="float32")
    dev = resolve_device(device)
    hp = hp or TrainHParams(peak_lr=lr, warmup=max(steps // 10, 1), total_steps=steps,
                            opt=OptConfig(name="adamw"))
    state = make_train_state(cfg, hp, torch.Generator(dev).manual_seed(0), device=dev)
    step_fn = make_train_step(cfg, hp)

    ckpt = Checkpointer(CheckpointConfig(directory=ckpt_dir)) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        state = load_state_tree(state, ckpt.restore(state_tree(state)))
        start = int(state.step)
        print(f"resumed from step {start}")

    ds = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch, seed=0)
    losses = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        state, metrics = step_fn(state, batch_at_step(ds, step))
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({time.perf_counter() - t0:.1f}s)", flush=True)
        if ckpt and step and step % 50 == 0:
            ckpt.save(step + 1, state_tree(state))
    if ckpt:
        ckpt.save(steps, state_tree(state), blocking=True)
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    losses = run(args.arch, smoke=args.smoke, steps=args.steps, seq_len=args.seq_len,
                 batch=args.batch, ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"final loss: {losses[-1]:.4f} (first: {losses[0]:.4f})")


if __name__ == "__main__":
    main()

"""End-to-end example on the PyTorch/CUDA port: train a ~100M-param LM
for a few hundred steps.

The port's counterpart of ``examples/train_lm.py``: the same config
(the deepseek-coder family scaled to ~100M params), the production train
step, the deterministic token stream, and asynchronous checkpointing
with restart.  Runs on the card unless ``--device cpu`` is given.

    python examples/torch_train_lm.py [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointConfig, Checkpointer  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data.tokens import TokenStreamConfig, batch_at_step  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainHParams,
    load_state_tree,
    make_train_state,
    make_train_step,
    state_tree,
)

# ~100M params: 12L x 512 with a 32k vocab
CFG = ModelConfig(
    name="repro-110m", family="dense", n_layers=12, d_model=512, n_heads=8,
    n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32_768, act="silu",
    dtype="float32",
)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq_len: int, ckpt_dir: str,
          device) -> list[float]:
    """Train ``cfg`` to ``steps`` from the latest checkpoint in ``ckpt_dir``
    (or from a seeded init); returns this run's losses (none when the
    checkpoint is already at ``steps``).  A save at loop index ``step``
    holds ``step + 1`` updates, as the reference's does; a resume starts
    from the restored state's own counter."""
    hp = TrainHParams(peak_lr=3e-4, warmup=20, total_steps=steps,
                      opt=OptConfig(name="adamw", weight_decay=0.01))
    state = make_train_state(cfg, hp, torch.Generator(device).manual_seed(0), device=device)
    ckpt = Checkpointer(CheckpointConfig(directory=ckpt_dir, keep=2))
    if ckpt.latest_step() is not None:
        state = load_state_tree(state, ckpt.restore(state_tree(state)))
        print(f"resumed at step {int(state.step)}")

    step_fn = make_train_step(cfg, hp)
    ds = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch, seed=0)
    t0 = time.perf_counter()
    losses = []
    start_step = int(state.step)
    if start_step >= steps:
        print(f"already trained to step {start_step}; nothing to do")
        return losses
    for step in range(start_step, steps):
        state, metrics = step_fn(state, batch_at_step(ds, step))
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  gnorm "
                  f"{float(metrics['grad_norm']):7.2f}  lr {float(metrics['lr']):.2e}",
                  flush=True)
        if step and step % 100 == 0:
            ckpt.save(step, state_tree(state))  # async
    ckpt.save(steps, state_tree(state), blocking=True)
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} in {time.perf_counter()-t0:.0f}s")
    assert losses[-1] < losses[0], "loss did not improve"
    return losses


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt", default="results/ckpt_train_lm")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"params: {CFG.param_count()/1e6:.1f}M")
    return train(CFG, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                 ckpt_dir=args.ckpt, device=dev)


if __name__ == "__main__":
    main()

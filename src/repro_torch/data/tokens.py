"""LM token pipeline: synthetic corpus, packing, deterministic sharded batches.

A numpy-only copy of ``repro.data.tokens``.  Streams are pure functions
of (seed, step): a restart replays the exact batch sequence with no
loader state to checkpoint.  The synthetic corpus is a Zipf-distributed
Markov-ish token source — enough structure for loss curves to move.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


def _zipf_probs(vocab: int, alpha: float):
    w = 1.0 / np.arange(1, vocab + 1) ** alpha
    return w / w.sum()


def batch_at_step(cfg: TokenStreamConfig, step: int):
    """Deterministic batch for `step`: {'tokens', 'targets'} (B, T) int32."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    p = _zipf_probs(min(cfg.vocab_size, 65536), cfg.zipf_alpha)
    base = rng.choice(len(p), size=(cfg.global_batch, cfg.seq_len + 1), p=p)
    # inject local structure: every 8th token repeats its predecessor
    base[:, 1::8] = base[:, 0:-1:8]
    base = base % cfg.vocab_size
    return {
        "tokens": base[:, :-1].astype(np.int32),
        "targets": base[:, 1:].astype(np.int32),
    }


def stream(cfg: TokenStreamConfig, start_step: int = 0):
    step = start_step
    while True:
        yield step, batch_at_step(cfg, step)
        step += 1

#!/usr/bin/env python3
"""What one-device decode costs a step on the card.

Times ``make_serve_step`` of gemma3-4b at full width (random weights from
``torch.Generator("cuda").manual_seed(0)``, float32 masters, the config's
activations) with bf16 caches, at ``chip_smoke.py``'s lm phase's decode
shape: B = 8, a cache of 2,112 slots, 64 steps.  Each step is
timed on the host clock after a sync; the first warms up.  Prints one JSON
line with the card's name and power limit and the steps' p50, p99 and
mean ms.

It imports the ``src/`` beside it, so a copy of another tree's ``src/`` with
this script under its ``scripts/`` times that tree's decode step.  Needs
one CUDA card:

    python3 scripts/torch_decode_step.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve import make_serve_step  # noqa: E402

ARCH, BATCH, LENGTH, STEPS = "gemma3-4b", 8, 2112, 64  # chip_smoke.py's LM_ARCH, LM_DECODE


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_step: no CUDA device is available", file=sys.stderr)
        return 2
    cfg = get_config(ARCH)
    model = zoo.init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    step = make_serve_step(cfg)
    caches = model.init_caches(BATCH, LENGTH, torch.bfloat16)
    tok = torch.randint(0, cfg.vocab_size, (BATCH, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1)).cuda()
    lat = []
    for pos in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(model, caches, tok, pos)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        caches, tok = res["caches"], res["next_tokens"]
    if not bool(torch.isfinite(res["logits"]).all()):
        print("torch_decode_step: logits not finite", file=sys.stderr)
        return 1
    ms = np.asarray(lat[1:]) * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, "arch": cfg.name, "batch": BATCH, "length": LENGTH, "steps": STEPS,
        "p50_ms": float(np.percentile(ms, 50)),
        "p99_ms": float(np.percentile(ms, 99)), "mean_ms": float(ms.mean())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Per-arch smoke on the PyTorch/CUDA port: reduced config, train loss +
one decode step, no NaNs (the counterpart of ``scripts/smoke_models.py``).
Runs on the card unless ``--device cpu`` is given.

    python scripts/torch_smoke_models.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.models.transformer import lm_loss  # noqa: E402

SHAPE = ShapeConfig("smoke", 32, 2, "train")


def smoke_arch(arch: str, device) -> dict:
    """One arch's smoke config in float32 from a seeded init: the train
    loss, its gradients' global norm by autograd, and one decode step from
    fresh caches; raises unless all are finite.  Returns the loss, the
    norm and the parameter count."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = zoo.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             zoo.make_concrete_batch(cfg, SHAPE).items()}
    params = [p for p in model.parameters() if p.is_floating_point()]
    for p in params:
        p.requires_grad_(True)
    loss = lm_loss(model, batch)
    assert torch.isfinite(loss), f"{arch}: loss not finite: {loss}"
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads if g is not None))
    assert torch.isfinite(gnorm), f"{arch}: grad norm not finite"
    with torch.no_grad():
        caches = model.init_caches(2, 32, torch.float32)
        tok = torch.zeros((2, 1), dtype=torch.int32, device=device)
        logits, caches = model.forward_decode(tok, caches, 0)
    assert bool(torch.isfinite(logits).all()), f"{arch}: decode logits not finite"
    n_params = sum(p.numel() for p in model.parameters())
    return dict(arch=arch, loss=float(loss.detach()), gnorm=float(gnorm), params=n_params)


def run(archs, device) -> tuple[bool, list[dict]]:
    """Smoke each arch in turn, printing OK or FAIL a line and ALL OK or
    FAILURES last; returns whether all passed and the passing rows."""
    ok, rows = True, []
    for arch in archs:
        t0 = time.perf_counter()
        try:
            r = smoke_arch(arch, device)
            rows.append(r)
            print(f"OK   {arch:28s} loss={r['loss']:7.3f} gnorm={r['gnorm']:9.3f} "
                  f"params={r['params']:,} ({time.perf_counter()-t0:.1f}s)")
        except Exception as e:  # report every arch, then fail the run
            ok = False
            print(f"FAIL {arch}: {e}")
            traceback.print_exc()
    print("ALL OK" if ok else "FAILURES")
    return ok, rows


def main(argv=None) -> tuple[bool, list[dict]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(ARCH_IDS, resolve_device(args.device))


if __name__ == "__main__":
    main()

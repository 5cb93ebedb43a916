"""Gradient compression: int8 blockwise quantisation with error feedback.

Port of ``repro.distributed.compression``.  Quantising a reduced
gradient to int8 codes plus one float32 scale a block of 1,024 cuts the
bytes a reduction moves about 4x against float32; the error-feedback
buffer re-injects the quantisation residual at the next round.

``compressed_psum(x, group)`` is the reference's ``shard_map`` primitive
over a process group (``launch.mesh.Mesh.group(axis)``) instead of a
named axis: the codes widened to int32 and all-reduced, the scales
all-reduced, the count from the group's size, the result dequantised
with the mean scale.  Neither package wires it into the train step.

The arithmetic is the reference's: ``scale = max |block| / 127``,
codes ``round(block / max(scale, 1e-12))`` (half to even) clipped to
+-127.  Every quotient that is rounded to a code divides by a tensor: on
the card, a division by a Python number multiplies by its reciprocal and
lands an ulp off at times, so the card, the CPU and XLA would disagree.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

BLOCK = 1024


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise symmetric int8 of ``x`` flattened and zero-padded to whole
    blocks: (codes int8 (nb, BLOCK), scales float32 (nb,), n = x.numel())."""
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    blocks = F.pad(flat, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale[:, None], 1e-12)), -127, 127)
    return q.to(torch.int8), scale, n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int, shape) -> torch.Tensor:
    """float32 ``codes * scale`` a block, the padding dropped, as ``shape``."""
    return (q.float() * scale[:, None]).reshape(-1)[:n].reshape(shape)


def int8_sums(x: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """The all-reduced parts of ``compressed_psum``: (the int32 sum of every
    rank's codes, the sum of every rank's scales, the group's size, n)."""
    q, scale, n = quantize_int8(x)
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, group=group)
    s_sum = scale.clone()
    dist.all_reduce(s_sum, group=group)
    return q_sum, s_sum, dist.get_world_size(group), n


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-reduce of ``x`` over ``group`` (``None``: the world).

    Each rank quantises its ``x``; the int32 sum of the codes and the sum
    of the scales are all-reduced (``int8_sums``), and the code sum is
    dequantised with the mean scale ``sum(scales) / size``.  The codes
    are 1 byte an element and the scales 4 bytes a block, against 4 bytes
    an element in float32; a sum of codes needs more than 8 bits, so the
    all-reduce itself moves the int32 widening, 4 bytes an element, as
    the reference's psum does."""
    q_sum, s_sum, k, n = int8_sums(x, group)
    # the mean scale on the int32 sum equals sum_i q_i * s_mean; the residual
    # belongs to error feedback, not to the model
    return dequantize_int8(q_sum, s_sum / torch.full_like(s_sum, float(k)), n, x.shape)


class EFState(NamedTuple):
    residual: Any  # a dict of float32 tensors matching the gradients


def ef_init(grads_like: dict) -> EFState:
    return EFState(residual={k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                             for k, g in grads_like.items()})


def ef_compress_decompress(grads: dict, state: EFState) -> tuple[dict, EFState]:
    """Error-feedback round trip, one process: each gradient plus its
    residual is quantised and dequantised; returns (the dequantised
    gradients, the new residuals ``x - dequantised``)."""
    deq, res = {}, {}
    for k, g in grads.items():
        x = g.float() + state.residual[k]
        q, s, n = quantize_int8(x)
        deq[k] = dequantize_int8(q, s, n, x.shape)
        res[k] = x - deq[k]
    return deq, EFState(residual=res)

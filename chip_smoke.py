#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's paths — build an index, save and load it, run gated
filtered search on the memory tier and off the index file on the disk
tier (synchronous and pipelined), with and without a hot-record cache,
and the brute-force PQ scan — at SIFT1M scale through the hand-written
CUDA kernels, serves retrieval-augmented generation with gemma3-4b at
full width over that index, runs the MoE, RG-LRU and xLSTM layer kinds
(recurrentgemma-9b, xlstm-350m, dbrx-132b) at full width, decodes with
w8a16 weights and the int8 KV cache (on one device and on a mesh), plans
every kind of cell on the production meshes as one rank's traced step
(the dry run), trains (the reference's training
example on its config, and gemma3-4b at full width; that config
ZeRO-sharded over gloo ranks sharing the card), and holds every kernel
against its plain PyTorch version on the card.  Phases,
each printing its own lines:

  1. device: the card's name and power limit (``nvidia-smi``), torch and
     CUDA versions; TF32 off for matrix products and convolutions, and
     bf16 products reduced in float32;
  2. kernels against their plain versions at the paths' shapes (ADC both
     entries on both routes and at their edges, the scan on both routes,
     L2 tree bit for bit and expanded within tolerance, the re-rank bit
     for bit on its edge cases at D = 7, 16, 128, 960 and on both routes,
     the fused round bit for bit on all 11 fields in all five modes,
     adversarial rounds and the merge's edges included, the brute-force
     scan over 1,000,000 codes, and the top-k merge on its three routes
     on random, duplicate-heavy and edge keys, bit for bit);
  build. ``GateANNEngine.build`` on the card at N = 100,000 (R = 64,
     L_build = 64, alpha = 1.2, two passes, 10 labels, the norm range),
     its seconds by part (beam search, prune, reverse edges, PQ); saved,
     loaded and searched bit-identically; gate recall@10 and I/O on that
     Vamana graph beside the 48 + 16 graph of phase 3 over the same data;
  3. a 1M x 128 index (BigANN-like data, 10 uniform labels, a norm range
     attribute, a degree-64 graph of 48 exact neighbours + 16 random
     links — not the port's Vamana graph, a cut the run prints — PQ with
     32 chunks) written with the port's writer and loaded with
     ``GateANNEngine.load`` on the card; the file system it lies on is
     printed, and a tmpfs temporary directory is replaced by ``build/``;
  4. 1,024 queries in batches of 256 on the memory tier: gate unfused,
     gate fused and post, with recall@10 against filtered ground truth
     computed on the card, each round's stage B one re-rank launch; then
     one batch with K + W past the re-rank kernel's limit (the standalone
     L2 kernel and the plain merge), its first 10 results equal to K = 10;
  dist. distributed search (``core/distributed_search.py``) on the same
     index and queries: ``spawn_local`` starts 4 ranks on the one card, a
     (data = 1, model = 4) mesh over gloo on CUDA tensors; each rank reads
     the replicated sections (PQ, the first r_max adjacency columns,
     labels) and only its own quarter of the records; gate and post at
     L = 64, W = 8, K = 10 with ``n_hops`` = phase 4's most rounds and a
     ring that never wraps; ids, distances, n_ios and n_tunnels equal
     phase 4's unfused gate and post bit for bit, and so do a (2, 2) mesh
     and a 1-rank nccl world; batch p50/p99, QPS, the all_reduce's share
     of a batch, collective bytes a round and each rank's device bytes;
     one nccl batch a mode under torch.profiler, the device time of the
     ring, the fetch, the ADC and the re-rank apart;
  5. the same queries off the index file (``store_tier="disk"``), the page
     cache dropped before each: gate at depth 1, gate unfused and fused at
     depth 4 and post at depth 4, each equal to the memory tier bit for
     bit, its reads reconciled with its n_ios;
  host. the same queries on the host tier (``store_tier="host"``: the
     1M records, 768 MB, in pinned host memory, gathered on the host and
     uploaded through ``PinnedStaging``): gate unfused and fused and post,
     each equal to the memory tier bit for bit; QPS, batch p50/p99, one
     gate batch profiled with its host-to-device bytes a round;
  cache. the cache tiers on the 1M index at budgets of 1% and 10% of the
     records: memory tier (``visit_freq``) gate unfused and fused, disk
     tier (``bfs`` through the lazy view) gate at depths 1 and 4, and an
     adaptive cache over the 4 batches; each run equal to the uncached
     one, n_ios + n_cache_hits equal to its n_ios, n_ios falling with the
     budget, records_read == sum(n_ios);
  serve. retrieval serving on the 1M index as ``benchmarks/serve_bench.py``
     deploys it: the disk tier under an adaptive cache of 1% of the
     records (``refresh_every`` 4), gate at L = 50, W = 8, depth 2, buckets
     8/16/32, behind a ``ServeFrontend`` of 4 tenants (labels 0-3),
     ``max_batch`` 32, a 2 ms batch window, ``retry_then_degrade``; 8
     closed-loop client threads send the 1,024 queries, tenants drawn
     Zipf(1.1) from a seed.  Then the memory tier, unfused and fused; then
     the disk tier again under injected transient EIO.  Every request is
     served, equal bit for bit to a direct search; the registry's
     disk.records_read == io_counters == search.ios{tier=disk} == served +
     padding reads, drift 0.  Last, one gate batch with telemetry off and
     on: the same kernel launches, off equal to the bare loop's;
  lm. the LM serving path (``repro_torch.models``, ``repro_torch.serve``)
     with gemma3-4b at full width (34 layers, 3,879,907,840 params, bf16
     activations over float32 masters, random init from a seeded
     ``torch.Generator("cuda")``): ``make_prefill_step`` at B = 8,
     T = 2,048 (seconds and tokens/s beside the operations bound);
     ``make_serve_step`` at B = 8 with bf16 caches of 2,112 for 64 steps
     (p50/p99 beside the bf16 weights' byte bound, and the bytes the
     per-call casts from the float32 masters move); ``RAGServer.generate``
     (the model's depth cut to 12 layers, printed as a CUT, for the run's
     time) of 8 labelled requests on the 1M index (gate L = 64, W = 8, K = 10,
     32-token passages and prompts, 16 new tokens), its retrieved ids equal
     to a direct search bit for bit and its launches counted under
     ``rag_generate``; then (a) the float32 model's cached decode against
     its full forward (B = 2, T = 48, within 2e-3) and (b) the card against
     the CPU at full width cut to 6 layers (logits within 1e-4, greedy
     tokens equal up to the first near tie);
  lm_kinds. the MoE, RG-LRU and xLSTM layer kinds through the same entry
     points, bf16 activations over float32 masters from a seeded
     ``torch.Generator("cuda")``, each model freed before the next:
     recurrentgemma-9b at full width with its depth cut from 38 to 12
     layers for the run's time (3,674,509,312 params: the reference's
     tree, above its ``param_count()``; a CUT), xlstm-350m at full width
     with its depth cut from 24 to 12 layers likewise (297,880,600; a
     CUT), dbrx-132b at full width with
     its depth cut from 40 to 2 layers (7,751,301,120 params, 31.0 GB);
     each: prefill B = 8, T = 2,048 beside its operations bound (xlstm's
     T cut only if its eager sLSTM scan would pass 30 s, estimated at
     T = 64; the scan's device launches a step profiled at T = 32 and 64),
     decode B = 8 with bf16 caches of 2,112 for 64 steps (p50 /
     p99 beside the byte bound, one step profiled; dbrx's decode capacity
     and dropped token-expert pairs); ``RAGServer.generate`` over
     recurrentgemma-9b (its depth cut to 12 layers, a CUT) as in the lm phase, its ids equal to a direct
     search and its launches under ``rag_generate_hybrid``; (a) float32
     decode against the full forward (B = 2, T = 48; dbrx at a capacity
     that drops nothing), (b) card against CPU at 1-3 layers (prefill and
     decode within 1e-4), (c) the four new configs' smoke models (llama4
     only there) card against CPU; the phase's peak memory and seconds;
  lm_variants. gemma3-4b at full width, its depth cut to 12 layers (a
     CUT, for the run's time), decoding (B = 8, caches
     of 2,112, 64 steps, ``make_serve_step``) four ways, each model freed
     before the next: bf16 as the lm phase; w8a16 (``quantize_model`` on
     the card, layer by layer); the int8 KV cache (``REPRO_KV_INT8=1``);
     both.  Each: p50 / p99, the bytes a step by count beside the bf16
     byte bound and a bound at 1 byte a quantised weight, one step
     profiled (kernel ms, launches, busy share), device bytes.  Then each
     against the float32 model's cached decode at 6 layers within the
     reference tests' bound (err < 0.08 scale + 0.5, argmax agreement
     > 0.85), and the quantised ones card against CPU at 2 layers;
  train. (a) the reference's training example: ``examples/train_lm.py``'s
     config (12 x 512, vocab 32,768, float32, 80,753,152 params) through
     ``launch.train.run`` for 300 steps, B = 8, T = 256, AdamW (weight
     decay 0.01, warmup 20), checkpointing into the run's temporary
     directory; the loss falls; a run resumed from a copy of that run's
     own step-201 checkpoint ends equal to the unbroken run bit for bit
     (losses and the step-300 checkpoint) under
     ``torch.use_deterministic_algorithms``, set for this part only; the
     save seconds and the file system; (b) gemma3-4b at
     full width, its depth cut to 12 of 34 layers for the run's time (a
     CUT), bf16 over float32 masters, Adafactor, B = 1,
     T = 4,096 (TRAIN_4K's sequence, its global batch cut to 1), remat a
     unit, 5 steps: seconds a step beside the operations bound, tokens/s,
     peak memory, each step's loss, grad norm and lr, one step profiled;
     (c) one train step card against CPU: gemma3-4b at full width cut to
     2 layers (B = 1, T = 128) and the smoke configs of four layer kinds;
  dist_train. ZeRO-sharded training (``repro_torch.distributed``,
     ``make_train_step`` with a ``train`` layout on a live mesh) on the one
     card: (a) ``quantize_int8`` of 80,753,152 seeded values card == CPU
     bit for bit, ``compressed_psum`` over the ``data`` group of a (2, 2)
     gloo mesh and a 1-rank nccl world == one process's plain sum, the
     bytes a reduction moves as int8 codes plus scales against float32;
     (b) the train phase's (a) config at full width (B = 8, T = 256,
     AdamW) for 20 steps on a (2, 2) gloo mesh (4 spawned ranks) and 3 on
     a 1-rank nccl world, each step's loss within rtol 2e-4 of one
     device's from the same init and batches, the step-20 params within
     the summed lrs' bound; per rank the state bytes held, peak memory,
     ms a step, the collectives' share of an instrumented step and a
     ``StepWatchdog``'s readings; (c) the step-20 checkpoint restored on
     one device (== every rank's blocks bit for bit) and on a (1, 4) mesh
     (``shardings=``), 2 steps there within rtol 2e-4 of one device's;
     (d) per-rank bytes of the train state of gemma3-4b and
     llama4-maverick on the production meshes, from specs alone
     (``launch.dryrun.spec_bytes``);
  dist_serve. The serving layouts executed on a mesh: one ``spawn_local``
     of 4 gloo ranks sharing the card, run as (1, 4) and then (2, 2)
     (``Mesh.reshape``), each rank's parameters drawn a leaf at a time
     from the one-device init's generator: gemma3-4b (at full width, its
     depth cut to 12 of 34 layers in the whole phase: a CUT, printed)
     ``decode`` on (1, 4) (B = 8, bf16 caches of 2,112 holding one
     device's 64-token prompt, each rank its blocks of them, then 16
     greedy steps; a CUT, printed: the prompt is not teacher-forced on the
     mesh) and its float32 twin (a 4-token prompt, 4 greedy steps),
     ``RAGServer(..., layout=)`` ``generate`` in float32 over a
     20,000-vector engine (each rank its own, loaded from one file;
     prompts cut to 2 hits of 4 tokens and 4 tokens, printed), dbrx-132b (2 of 40 layers) and
     xlstm-350m (12 of 24 layers, a CUT) in float32 and recurrentgemma-9b
     (12 of 38 layers, a CUT) in bf16 ``decode`` (16 steps each), gemma3-4b with w8a16 weights
     at the lm_variants depth (12 layers) in float32 ``decode`` (a 2-token
     prompt, 3 greedy steps, against the lm_variants phase's one-device
     run within 1e-4 of the largest logit; the codes and scales a rank
     holds beside the same weights in float32); then on (2, 2) gemma3-4b
     ``long`` (B = 1, LONG_500K's 524,288
     slots filled with seeded K/V, 8 steps), gemma3-4b ``prefill`` (B = 8,
     T = 2,048, ZeRO-stored parameters gathered a layer at a time) and
     xlstm-350m ``prefill`` (12 layers, B = 8, T = 512).  Each run replays the tokens
     one device was fed in the lm and lm_kinds phases (their saved
     references): logits within the bar of one device's (3e-2 of the
     largest in bf16, the LM tests' bar; 1e-4 in float32, the lm phases'
     full-width bar; or twice one device's own distance under another
     summation order, the larger),
     greedy tokens equal at every step whose one-device top-2 gap exceeds
     the bar, prefill K/V blocks held likewise, dbrx's routed and dropped
     pairs equal, ``generate``'s tokens equal up to each row's first
     close step; per run the ms a step, the collectives' share of an
     instrumented step and their bytes by kind, state bytes and peak
     memory a rank.  ``python3 chip_smoke.py --only dist_serve`` runs it
     alone with its references (no result line);
  dryrun. ``launch.dryrun``: (a) in spawned children on the CPU, each on a
     90 s deadline, cells of every kind planned on the meta device on
     both production meshes (16 x 16, 2 x 16 x 16) in a fake world of
     their size: train (xlstm-350m, ``dp_only``; its sequence cut to 16,
     a CUT: the eager sLSTM scan is slow to trace), prefill, decode,
     w8a16 decode and long, and the retrieve step in both modes (48
     all-reduces of the reference's hop a step); (b) in another child at
     once, rank 0 of 16 x 16 on the card in the same fake world, on
     uninitialised blocks: gemma3-4b ``decode_32k`` (bf16 and w8a16),
     ``prefill_32k``, ``long_500k`` and the retrieve step (gate), each
     with its collectives equal to the meta plan's by kind, count and
     bytes and its peak at least the plan's argument bytes (peak GiB
     against the card's 80 GB, seconds: one rank, collectives skipped).
     ``python3 chip_smoke.py --only dryrun`` runs it alone;
  6. the brute-force PQ scan: every code scored by ``pq.adc_lookup``,
     filtered, top-10 by two levels of ``kernels.ops.topk_merge``;
  7. card vs CPU on a 20,000-vector index in all five modes;
  cli. the reference's command-line surface, ported: each of
     ``examples/torch_*.py`` and ``scripts/torch_*.py`` through its
     ``main`` on the card at the reference's sizes — convert_index (build,
     inspect, verify, shard + verify, merge + verify; the merged file
     searches as the built one bit for bit), obs_report (``--prom`` ==
     the live registry's text), quickstart (gate's reads below post's,
     the disk tier's ids the memory tier's, reads + hits conserved across
     cache budgets), filtered_search_demo (every family predicate-clean,
     DRAM growing with R_max), rag_serve (tokens (4, 8), every passage
     of category 3, the cache refreshed), train_lm (40 steps, then
     resumed at 40 to 60, the loss falling in each), smoke_models (ALL
     OK), smoke_core and diag_recall; each searching one's launches under
     a ``cli_<name>`` path.  ``python3 chip_smoke.py --only cli`` runs it
     alone;
  8. one JSON line of a round's stage B as the re-rank kernel and as the
     parent design (the standalone L2 kernel and the plain merge):
     launches, device and host microseconds, measured after phase 4's
     warm-up batch, before any profiler session; then one of per-kernel
     launches by path, times and bounds;
  9. the last line, ``{"ok": true, "device": {...}}``.

Any mismatch raises and the script exits non-zero.  It needs a CUDA
device; without one it exits with code 2 and prints no result.

    python3 chip_smoke.py            # the full run (N = 1,000,000)
    python3 chip_smoke.py --n 200000 # a smaller index (the cut is printed)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

from repro_torch import obs  # noqa: E402
from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig, recall_at_k  # noqa: E402
from repro_torch.core import frontier as fr  # noqa: E402
from repro_torch.core import graph as graphm  # noqa: E402
from repro_torch.core import pq as pqm  # noqa: E402
from repro_torch.data import make_bigann_like, make_queries, uniform_labels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_traversal as ftk  # noqa: E402
from repro_torch.kernels import l2_dist as l2k  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import pq_lookup as pqk  # noqa: E402
from repro_torch.kernels import topk_merge as tkk  # noqa: E402
from repro_torch.launch import AbstractMesh, abstract_production_mesh, spawn_local  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.checkpoint import CheckpointConfig, Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import flatten_with_paths  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum, dequantize_int8, quantize_int8)
from repro_torch.distributed.fault_tolerance import StepWatchdog  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ONE, NamedSharding, make_layout, named_shardings)
from repro_torch.models.convert import reference_axes, reference_leaves  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import LONG_500K, TRAIN_4K, ModelConfig  # noqa: E402
from repro_torch.data.tokens import TokenStreamConfig, batch_at_step  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.models.layers import Linear, quantize_model  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import TrainHParams, make_train_state, make_train_step  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    load_state_tree, make_train_state_specs, state_tree)
from repro_torch.serve import RAGRequest, RAGServer, ServeFrontend, TenantSpec  # noqa: E402
from repro_torch.serve import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.serve.decode import cache_blocks  # noqa: E402
from repro_torch.store.adaptive import AdaptiveRecordCache  # noqa: E402
from repro_torch.store.cache import record_nbytes  # noqa: E402
from repro_torch.store.disk import DiskRecordStore  # noqa: E402
from repro_torch.store.faults import FaultPlan  # noqa: E402
from repro_torch.store.format import write_index  # noqa: E402
# the re-rank's edge cases and its route's edge, as the card tests make them
from test_torch_cuda import RERANK_CASES, first_split, rerank_inputs  # noqa: E402
# a smoke-config LM on the card against the CPU, and one train step, as the
# card tests hold them
from test_torch_cuda import lm_smoke_card_vs_cpu, train_step_card_vs_cpu  # noqa: E402
# a batch's device launches, and the loop without the engine's telemetry hooks
from test_torch_cuda import bare_search, device_launches  # noqa: E402

MODES = ("gate", "post", "early", "pre_naive", "unfiltered")
# H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate
SPIN_CYCLES_PER_S = 1.98e9  # H100 SXM boost clock: cycles for torch.cuda._sleep
DIM, DEGREE, EXACT_NBRS, PQ_CHUNKS, R_MAX = 128, 64, 48, 32, 32
BATCH, N_QUERIES, N_LABELS = 256, 1024, 10
SEARCH = dict(search_l=64, beam_width=8, result_k=10)
DEPTH = 4  # the pipelined loop's depth on the disk tier
BUILD_N, BUILD_L, ALPHA = 100_000, 64, 1.2  # the build phase: its N, L_build and alpha
CACHE_FRACTIONS = (0.01, 0.10)  # the cache phase's budgets, as shares of the records
SCAN_BATCH, SCAN_CHUNK = 64, 1000  # brute-force scan: queries a batch, top-k chunk width
# the serve phase: benchmarks/serve_bench.py::make_frontend's deployment
SERVE = dict(mode="gate", search_l=50, beam_width=8, result_k=10)
SERVE_DEPTH, SERVE_BUCKETS, SERVE_CACHE_FRACTION = 2, (8, 16, 32), 0.01
SERVE_TENANTS, SERVE_CLIENTS, SERVE_ALPHA, SERVE_EIO = 4, 8, 1.1, 0.005
# the dist phase: the ring buffer's size (B x cap int32 = 64 MiB a rank) and
# the deadline of one mesh's run, process start and file reads included
DIST_CAP, DIST_TIMEOUT_S = 65_536, 300
# the lm phase: the model, prefill (B, T), decode (B, cache length, steps),
# generate's requests and token counts, invariant (a)'s (B, T) and (b)'s
# prompt and new tokens
LM_ARCH, LM_PREFILL, LM_DECODE = "gemma3-4b", (8, 2048), (8, 2112, 64)
LM_REQUESTS, LM_PASSAGE, LM_PROMPT, LM_NEW = 8, 32, 32, 16
# the depth generate runs at over the 1M index (lm, lm_kinds) and the lm_variants
# decodes run at: cut so that the whole smoke, the dist_serve phase included,
# stays within its time (PERF.md, PR 23)
LM_GENERATE_DEPTH = {"gemma3-4b": 12, "recurrentgemma-9b": 12}
LM_VARIANTS_DEPTH = 12
LM_PARITY_BT, LM_CPU_PROMPT, LM_CPU_NEW = (2, 48), 16, 16
# the lm_kinds phase: each config with its depth cut (None: full depth) and
# the parameter count of the reference's init_model tree at that depth
# (tests/test_torch_models.py holds the port's to it; param_count() leaves
# out the RG-LRU's gate linears and counts the xLSTM blocks by a formula of
# its own); the model that serves generate; (b)'s depth a config and its
# prefill T, prompt and new tokens; the smoke configs of (c); the seconds
# past which the sLSTM's prefill T is cut
LM_KINDS = (("recurrentgemma-9b", 12, 3_674_509_312), ("xlstm-350m", 12, 297_880_600),
            ("dbrx-132b", 2, 7_751_301_120))
LM_KINDS_GENERATE = "recurrentgemma-9b"
LM_KINDS_CPU_LAYERS = {"recurrentgemma-9b": 3, "xlstm-350m": 2, "dbrx-132b": 1}
LM_KINDS_CPU = (8, 4, 16)  # (b): prompt, new tokens, prefill T
LM_KINDS_SMOKE = ("recurrentgemma-9b", "xlstm-350m", "dbrx-132b", "llama4-maverick-400b-a17b")
LM_KINDS_PREFILL_CAP_S = 30.0
# the lm_variants phase: each decode run's (w8a16 weights, int8 KV cache);
# the check against the float32 model's cached decode (layers, B, T) and the
# reference tests' bound (err < rel * scale + abs, argmax agreement above);
# card against CPU (layers, prompt, new tokens)
LM_VARIANTS = {"bf16": (False, False), "w8a16": (True, False), "int8_kv": (False, True),
               "w8a16+int8_kv": (True, True)}
LM_VARIANTS_CHECK, LM_VARIANTS_BOUND = (6, 2, 16), (0.08, 0.5, 0.85)
LM_VARIANTS_CPU = (2, 8, 8)
# the train phase: (a) examples/train_lm.py's config and hyperparameters (its
# "~100M" is param_count()'s 80,753,152), resumed from the unbroken run's own
# checkpoint at TRAIN_LM_STOP (the launcher saves after step 200 as 201);
# (b) a full-width model: arch, B, T (TRAIN_4K's sequence), steps;
# (c) card against CPU: the full-width model's depth and (B, T), and the smoke
# configs of the four layer kinds
TRAIN_LM_CFG = ModelConfig(name="repro-110m", family="dense", n_layers=12, d_model=512,
                           n_heads=8, n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32_768,
                           act="silu", dtype="float32")
TRAIN_LM_PARAMS, TRAIN_LM_STOP = 80_753_152, 201
TRAIN_LM = dict(steps=300, batch=8, seq_len=256)
TRAIN_LM_HP = TrainHParams(peak_lr=3e-4, warmup=20, total_steps=300,
                           opt=OptConfig(name="adamw", weight_decay=0.01))
TRAIN_BIG = ("gemma3-4b", 1, TRAIN_4K.seq_len, 5)
TRAIN_BIG_DEPTH = 12  # (b)'s layers (of 34), cut for the whole smoke's time (PERF.md)
TRAIN_CPU = (2, 1, 128)
TRAIN_SMOKE = ("gemma3-4b", "recurrentgemma-9b", "xlstm-350m", "dbrx-132b")
# the dist_train phase: the train phase's (a) config sharded over (2, 2) gloo
# ranks for DIST_TRAIN_STEPS, a 1-rank nccl world, and the step-20 checkpoint
# resumed on a (1, 4) mesh; the compression inputs' seed; the watchdog's limit;
# the archs planned at full width on the production meshes
DIST_TRAIN_STEPS, DIST_TRAIN_NCCL_STEPS, DIST_TRAIN_RESUMED_STEPS = 20, 3, 2
DIST_TRAIN_SEED, DIST_TRAIN_STEP_LIMIT_S = 7, 30.0
DIST_TRAIN_COMPRESS_N = TRAIN_LM_PARAMS
DIST_TRAIN_PLAN_ARCHS = ("gemma3-4b", "llama4-maverick-400b-a17b")
# the dist_serve phase: gemma3-4b decode on (1, 4) (B, prompt, new tokens, bf16
# cache length); long on (2, 2) (steps, LONG_500K's cache length; B = 1); the
# kinds' decode on (1, 4) (B, prompt, new tokens: 16 steps); xlstm-350m prefill on
# (2, 2) (B, T); RAGServer.generate under gemma3-4b's decode layout on (1, 4) over
# an engine of DIST_SERVE_RAG["n"] seeded vectors; the bf16 bar (of the largest
# logit); the long caches' K/V seeded in chunks of DIST_SERVE_CHUNK slots
DIST_SERVE_DECODE = (8, 64, 16, 2112)
DIST_SERVE_LONG = (8, LONG_500K.seq_len)
# each kind's depth (None: full; lm_kinds' depth, for the whole smoke's time)
# and activation dtype (None: the config's):
# dbrx-132b and xlstm-350m decode in float32, where bf16 order noise neither
# moves the MoE's routing nor is carried up by the sLSTM's exponential gates
# past what tells a fault from noise (PERF.md)
DIST_SERVE_KINDS = {"dbrx-132b": (2, "float32"), "recurrentgemma-9b": (12, None),
                    "xlstm-350m": (12, "float32")}
# the depth gemma3-4b runs at in the dist_serve phase (its layers the full model's
# first), cut with recurrentgemma-9b's above so that the whole smoke, the dryrun
# phase included, stays within its time (PERF.md)
DIST_SERVE_GEMMA_DEPTH = 12
DIST_SERVE_KINDS_DECODE = (8, 8, 9)
DIST_SERVE_XLSTM_PREFILL = (8, 512)
DIST_SERVE_RAG = dict(n=20_000, requests=8, k=2, passage=4, prompt=4, new=8)
DIST_SERVE_F32 = (8, 2, 3)  # gemma3-4b's float32 twin: B, prompt, new tokens
# of the largest: bf16 the LM tests' bar; float32 at full width the card-vs-CPU
# bar of the lm phases' (b) (the tests' 2e-5 is for the smoke configs' widths)
DIST_SERVE_BAR = {"bfloat16": 3e-2, "float32": 1e-4}
DIST_SERVE_CHUNK, DIST_SERVE_TIMEOUT_S = 4096, 600
# gemma3-4b w8a16 decode on (1, 4) in float32 at the lm_variants depth: B, prompt,
# new tokens (one device's run saved by the lm_variants phase)
DIST_SERVE_W8 = (8, 2, 3)
# the dryrun phase: (a) the cells planned on the meta device on each production
# mesh (arch, shape, w8a16), in two children a mesh, the retrieval cell in both
# modes beside them: xlstm-350m's train cell (dp_only) at a cut sequence (its
# eager sLSTM scan costs about 0.4 s a step to trace on the CPU: PERF.md); (b)
# the cells run on the card (16 x 16, rank 0); the deadline of each child
DRYRUN_TRAIN_T = 16
DRYRUN_META = (("xlstm-350m", "train_4k", False), ("gemma3-4b", "prefill_32k", False)), \
              (("gemma3-4b", "decode_32k", False), ("gemma3-4b", "decode_32k", True),
               ("gemma3-4b", "long_500k", False))
DRYRUN_META_3D_PREFILL = "internvl2-2b"  # the 2 x 16 x 16 mesh's prefill cell (the faster trace)
DRYRUN_CARD = (("gemma3-4b", "decode_32k", False), ("gemma3-4b", "decode_32k", True),
               ("gemma3-4b", "prefill_32k", False), ("gemma3-4b", "long_500k", False))
DRYRUN_TIMEOUT_S, CARD_BYTES = 90, 80e9
REPO = Path(__file__).resolve().parent


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    require(a.shape == b.shape and a.dtype == b.dtype, f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    require(bool(torch.equal(a, b)), f"{what}: not bit-identical "
            f"({int((a != b).sum())} of {a.numel()} differ)")


# ---------------------------------------------------------------- phase 2
def check_adc(dev, n, rng) -> None:
    """Both entries on both routes (the LUT read from global memory when a
    query has fewer rows than K, else staged in shared memory) at the
    loop's shapes and at the edges, bit for bit."""
    b, m, c, k = BATCH, 8 * (DEGREE + R_MAX), PQ_CHUNKS, 256
    table = torch.from_numpy(rng.integers(0, k, (n, c)).astype(np.int32)).to(dev)
    routes = set()
    # (what, B, M, C, K, share of live ids, tensors 4 bytes off 16-byte alignment)
    for what, bb, mm, cc, kk, live, off in (
            ("loop round", b, m, c, k, 0.3, False), ("all ids live", b, m, c, k, 1.0, False),
            ("entry M=1", b, 1, c, k, 1.0, False), ("M=1500, two tiles", 64, 1500, c, k, 0.5, False),
            ("B=1", 1, m, c, k, 0.7, False), ("ids all -1", b, m, c, k, 0.0, False),
            ("C=6 K=16", 40, 300, 6, 16, 0.8, False), ("C=6 K=16 M=7", 40, 7, 6, 16, 0.8, False),
            ("4-byte offset", b, m, c, k, 0.5, True), ("4-byte offset M=1", b, 1, c, k, 1.0, True)):
        lut = torch.from_numpy((rng.random((bb, cc, kk)) * 1000).astype(np.float32)).to(dev)
        tab = table if (cc, kk) == (c, k) else torch.from_numpy(
            rng.integers(0, kk, (50_000, cc)).astype(np.int32)).to(dev)
        ids = rng.integers(0, tab.shape[0], (bb, mm)).astype(np.int32)
        ids[rng.random((bb, mm)) >= live] = -1
        ids = torch.from_numpy(ids).to(dev)
        codes = torch.from_numpy(rng.integers(0, kk, (bb, mm, cc)).astype(np.int32)).to(dev)
        want_ids = pqk.adc_ids_ref(lut, tab, ids)
        want_g = pqk.pq_lookup_gathered_ref(lut, codes)
        if off:
            lut, tab, codes = at_offset(lut), at_offset(tab), at_offset(codes)
            require(all(t.data_ptr() % 16 == 4 for t in (lut, tab, codes)), f"{what}: aligned")
        route = pqk.adc_route(mm, kk)
        same(pqk.adc_ids(lut, tab, ids), want_ids, f"adc_ids {what} ({route})")
        same(pqk.pq_lookup_gathered(lut, codes), want_g, f"pq_lookup_gathered {what} ({route})")
        routes.add(route)
    require(routes == set(pqk.ADC_ROUTES), f"ADC routes checked: {routes}")
    log("kernels", f"ADC bit-identical, gathered and by id over {n} codes, on both routes "
        f"({', '.join(sorted(routes))}): the loop's round ({b},{m},{c}) 30% and 100% live, "
        "M=1, M=1500 (two tiles a query), B=1, every id -1, C=6 K=16 (scalar loads) and "
        "codes and LUT 4 bytes off 16-byte alignment (scalar loads, no TMA)")


def check_l2(dev, rng) -> None:
    for d in (DIM, 24, 7):
        q = torch.from_numpy((rng.random((BATCH, d)) * 255).astype(np.float32)).to(dev)
        rows = torch.from_numpy((rng.random((BATCH, 8, d)) * 255).astype(np.float32)).to(dev)
        same(l2k.l2_dist(q, rows, tree=True), l2k.l2_tree_ref(q, rows), f"l2 tree D={d}")
        err = (l2k.l2_dist(q, rows, tree=False) - l2k.l2_expanded_ref(q, rows)).abs()
        tol = l2k.expanded_tolerance(q, rows)
        require(bool((err <= tol).all()), f"l2 expanded D={d}: max err {float(err.max())}")
        log("kernels", f"L2 D={d}: tree bit-identical; expanded max |err| {float(err.max()):.6g} "
            f"within 2*D*eps*(|x|^2+|q|^2) (max bound {float(tol.max()):.6g})")


def same_rerank(got, want, what: str) -> None:
    same(got[0], want[0], f"{what} ids")
    same(got[1].view(torch.int32), want[1].view(torch.int32), f"{what} dists' bits")
    same(got[2], want[2], f"{what} n_degraded")


def split_k(w: int, d: int) -> int:
    """The least K that the re-rank's route (the library's) sends, with W
    rows of D, to the standalone L2 kernel and the plain merge."""
    return first_split(lambda k: l2k.rerank_route(k, w, d), 1, 1 << 20)


def check_rerank(dev) -> None:
    """The re-rank kernel bit for bit on its edge cases at the loop's B, W
    and K and at D = 7, 16, 128 and 960: the tree with 16-byte-aligned
    tensors (shuffles where D is a power of two) and 4 bytes off (the
    shared-memory tree), the expanded form against the standalone kernel
    and the plain merge; then both routes at the route's edge in K + W
    (the last K it gives the kernel, and one more)."""
    n = 0
    for d in (7, 16, DIM, 960):
        for case in RERANK_CASES:
            args = [torch.from_numpy(a).to(dev) for a in rerank_inputs(n, case, d, b=BATCH)]
            want = l2k.rerank_ref(*args)
            same_rerank(l2k.rerank(*args), want, f"rerank {case} D={d}")
            off = [at_offset(args[0]), at_offset(args[1])]
            require(all(t.data_ptr() % 16 == 4 for t in off), "rerank: 16-byte aligned")
            same_rerank(l2k.rerank(*off, *args[2:]), want, f"rerank {case} D={d} 4 bytes off")
            split = l2k.rerank_composed(functools.partial(l2k.l2_dist, tree=False), *args)
            same_rerank(l2k.rerank(*args, tree=False), split, f"rerank expanded {case} D={d}")
            n += 3
    routes, edges = set(), {w: split_k(w, DIM) for w in (8, 1000)}
    for k, w in ((edges[8] - 1, 8), (edges[8], 8), (edges[1000] - 1, 1000), (edges[1000], 1000)):
        args = [torch.from_numpy(a).to(dev) for a in rerank_inputs(n, "repeats", DIM, b=64, w=w, k=k)]
        route = l2k.rerank_route(k, w, DIM)
        before = dict(_build.LAUNCHES)
        same_rerank(l2k.rerank(*args), l2k.rerank_ref(*args), f"rerank K={k} W={w} ({route})")
        ran = {name for name in ("rerank", "l2_dist") if _build.LAUNCHES[name] > before.get(name, 0)}
        require(ran == {{"fused": "rerank", "split": "l2_dist"}[route]}, f"rerank K={k} W={w}: {ran}")
        routes.add(route)
        n += 1
    require(routes == set(l2k.ROUTES), f"rerank routes checked: {routes}")
    log("kernels", f"re-rank bit-identical (ids, dists' bits, n_degraded): {n} rounds, cases "
        f"{', '.join(RERANK_CASES)} at B={BATCH} W=8 K=10, D in (7, 16, {DIM}, 960), tree aligned "
        "and 4 bytes off, expanded vs the standalone kernel + the plain merge; K+W="
        f"{edges[8] + 7} on the kernel and one more on the standalone L2 kernel + the plain "
        "merge (W=8 and W=1000)")


def round_inputs(rng, dev, b, l, m, c, k, n_ids, *, dup_ids=False, all_filtered=False):
    """A plausible mid-search round (the cases of the reference's
    fused-kernel tests), as device tensors."""
    fid = np.stack([rng.choice(n_ids, size=l, replace=False) for _ in range(b)]).astype(np.int32)
    fid[:, l - 2:] = -1
    fd = np.where(fid >= 0, rng.random((b, l)) * 4, np.float32(3.4e38)).astype(np.float32)
    fexp = (rng.random((b, l)) < 0.3) & (fid >= 0)
    fpas = rng.random((b, l)) < 0.5
    nid = rng.integers(-1, n_ids, size=(b, m)).astype(np.int32)
    if dup_ids and m >= 2:
        nid[:, 1] = nid[:, 0]
        nid[:, m - 1] = fid[:, 0]
    nc = rng.integers(0, k, size=(b, m, c)).astype(np.int32)
    npas = np.zeros((b, m), bool) if all_filtered else rng.random((b, m)) < 0.5
    lut = (rng.random((b, c, k)) * 2).astype(np.float32)
    entry = fid[:, 0].copy()
    return tuple(torch.from_numpy(x).to(dev) for x in (fid, fd, fexp, fpas, nid, nc, npas, lut, entry))


def edge_round(rng, dev, case: str, b: int, l: int, m: int, c: int, k: int, n_ids: int):
    """A round at an edge of the merge (unsorted frontier): ``mostly_dead``
    half the frontier empty and most candidates -1 or copies of frontier
    ids, so fewer than L keys are finite; ``ties`` integer LUT entries and
    frontier distances; ``neg_zero`` a LUT of mostly 0.0 and frontier
    distances of -0.0 and +0.0; ``wide`` a plain round at L = 256."""
    fid, fd, fexp, fpas, nid, nc, npas, lut, entry = (
        t.cpu().numpy() for t in round_inputs(rng, "cpu", b, l, m, c, k, n_ids))
    if case == "mostly_dead":
        fid[:, l // 2:] = -1
        fd = np.where(fid >= 0, fd, np.float32(3.4e38)).astype(np.float32)
        fexp &= fid >= 0
        copies = np.take_along_axis(fid, rng.integers(0, 3, size=(b, m)), 1)
        nid = np.where(rng.random((b, m)) < 0.5, -1, copies).astype(np.int32)
        nid[:, 0] = n_ids - 1
    elif case == "ties":
        lut = rng.integers(0, 3, size=(b, c, k)).astype(np.float32)
        fd = np.where(fid >= 0, rng.integers(0, 3 * c, size=(b, l)), np.float32(3.4e38)).astype(np.float32)
    elif case == "neg_zero":
        lut = np.where(rng.random((b, c, k)) < 0.97, 0.0, 1.0).astype(np.float32)
        zeros = np.where(rng.random((b, l)) < 0.5, np.float32(-0.0), np.float32(0.0))
        fd = np.where(fid >= 0, zeros, np.float32(3.4e38)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (fid, fd, fexp, fpas, nid, nc, npas, lut, entry))


def check_fused(dev, rng) -> None:
    main_m = 8 * (DEGREE + R_MAX)
    shapes = {"main": (BATCH, 64, 8, PQ_CHUNKS, 256, 50_000), "small": (2, 8, 2, 4, 16, 50)}
    n_checked = 0
    for label, (b, l, w, c, k, n_ids) in shapes.items():
        for case in ("plain", "dup_ids", "all_filtered", "m_zero", "m_odd"):
            m = {"m_zero": 0, "m_odd": 6 if label == "small" else main_m - 1}.get(
                case, 8 if label == "small" else main_m)
            state = round_inputs(rng, dev, b, l, m, c, k, n_ids, dup_ids=case == "dup_ids",
                                 all_filtered=case == "all_filtered")
            for mode in MODES:
                got = ftk.fused_traversal_round(*state, mode=mode, width=w)
                want = ftk.fused_traversal_round_ref(*state, mode=mode, width=w)
                for f in got._fields:
                    same(getattr(got, f), getattr(want, f), f"fused {label} {case} {mode} {f}")
                n_checked += 1
            # the search loop's entry: code rows gathered by id inside the kernel
            table = torch.from_numpy(rng.integers(0, k, (n_ids, c)).astype(np.int32)).to(dev)
            by_id = state[:5] + (table,) + state[6:]
            got = ftk.fused_traversal_round(*by_id, mode="gate", width=w, gathered=False)
            want = ftk.fused_traversal_round_ref(*by_id, mode="gate", width=w, gathered=False)
            for f in got._fields:
                same(getattr(got, f), getattr(want, f), f"fused by-id {label} {case} {f}")
    # the merge's edges at the loop's shapes, all five modes, gathered and by id
    for case, l in (("wide", 256), ("mostly_dead", 64), ("ties", 64), ("neg_zero", 64)):
        state = edge_round(rng, dev, case, BATCH, l, main_m, PQ_CHUNKS, 256, 50_000)
        table = torch.from_numpy(rng.integers(0, 256, (50_000, PQ_CHUNKS)).astype(np.int32)).to(dev)
        for mode in MODES:
            for gathered in (True, False):
                args = state if gathered else state[:5] + (table,) + state[6:]
                got = ftk.fused_traversal_round(*args, mode=mode, width=8, gathered=gathered)
                want = ftk.fused_traversal_round_ref(*args, mode=mode, width=8, gathered=gathered)
                for f in got._fields:
                    g, h = getattr(got, f), getattr(want, f)
                    if g.dtype == torch.float32:
                        g, h = g.view(torch.int32), h.view(torch.int32)
                    same(g, h, f"fused {case} L={l} {mode} gathered={gathered} {f}")
                n_checked += 1
        if case == "mostly_dead":
            n_dead = int((got.frontier_ids < 0).sum(1).min())
            require(n_dead > 0, "mostly_dead: no dead slot reached the frontier")
    # the other load paths: scalar code loads (C = 6, or code rows 4 bytes
    # off a 16-byte boundary) and a LUT copied without cp.async (4 bytes off)
    for path, c, k in (("C=6", 6, 16), ("4-byte offset", PQ_CHUNKS, 256)):
        state = list(edge_round(rng, dev, "ties", BATCH, 64, main_m, c, k, 50_000))
        table = torch.from_numpy(rng.integers(0, k, (50_000, c)).astype(np.int32)).to(dev)
        if c == PQ_CHUNKS:
            state[5], state[7], table = at_offset(state[5]), at_offset(state[7]), at_offset(table)
            require(all(t.data_ptr() % 16 == 4 for t in (state[5], state[7], table)),
                    "4-byte offset: the tensors are 16-byte aligned")
        for mode in MODES:
            for gathered, codes in ((True, state[5]), (False, table)):
                args = state[:5] + [codes] + state[6:]
                got = ftk.fused_traversal_round(*args, mode=mode, width=8, gathered=gathered)
                want = ftk.fused_traversal_round_ref(*args, mode=mode, width=8, gathered=gathered)
                for f in got._fields:
                    same(getattr(got, f), getattr(want, f), f"fused {path} {mode} {gathered} {f}")
                n_checked += 1
    log("kernels", f"fused round bit-identical on all 11 fields: {n_checked} (shape, case, mode, "
        "entry) rounds incl. duplicate ids, all filtered, M=0, M not a power of two, L=256, "
        "mostly dead (fewer than L finite keys), quantised and signed-zero distances, C=6 and "
        "a LUT and codes 4 bytes off 16-byte alignment (scalar loads, no cp.async); by-id entry too")


def at_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element (4 bytes)
    past a 16-byte boundary."""
    out = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def check_scan(dev, n, rng) -> None:
    """Both routes (codes packed to bytes in registers when K <= 256 and
    C <= 32, else unpacked) at the path's shape and at the edges."""
    routes = set()
    # (what, B, N, C, K, tensors 4 bytes off 16-byte alignment)
    for what, b, nn, c, k, off in (
            ("path", SCAN_BATCH, n, PQ_CHUNKS, 256, False), ("C=6 K=16", 3, 5000, 6, 16, False),
            ("K=16", 5, 3000, PQ_CHUNKS, 16, False), ("B=1", 1, 10_007, PQ_CHUNKS, 256, False),
            ("B=65", 65, 30_001, PQ_CHUNKS, 256, False), ("N=300 < tile", 4, 300, PQ_CHUNKS, 256, False),
            ("4-byte offset", 4, 10_007, PQ_CHUNKS, 256, True), ("K=512", 4, 3000, 8, 512, False)):
        lut = torch.from_numpy((rng.random((b, c, k)) * 1000).astype(np.float32)).to(dev)
        codes = torch.from_numpy(rng.integers(0, k, (nn, c)).astype(np.int32)).to(dev)
        want = pqk.pq_scan_ref(lut, codes)
        if off:
            lut, codes = at_offset(lut), at_offset(codes)
        route = pqk.scan_route(c, k)
        same(pqk.pq_scan(lut, codes), want, f"pq_scan {what} ({route})")
        routes.add(route)
    require(routes == set(pqk.SCAN_ROUTES), f"scan routes checked: {routes}")
    log("kernels", f"pq_scan bit-identical on both routes ({', '.join(sorted(routes))}): "
        f"({SCAN_BATCH},{PQ_CHUNKS},256) LUTs over {n} codes, C=6 K=16, K=16, B=1, B=65, "
        "N=300 (below one tile), tensors 4 bytes off 16-byte alignment, K=512")


def topk_keys(rng, b, m, dup: bool):
    """Random tie-free keys, or duplicate-heavy ones: 10 distinct
    distances and ids repeated, so whole (dist, id) keys repeat."""
    if dup:
        d = rng.integers(0, 10, (b, m)).astype(np.float32)
        i = rng.integers(0, m // 4, (b, m)).astype(np.int32)
    else:
        d = rng.permutation(b * m).reshape(b, m).astype(np.float32) / (b * m)
        i = rng.integers(0, 1 << 30, (b, m)).astype(np.int32)
    return d, i


def topk_edge_keys(rng, b, m):
    """Rows at the contract's edges, a kind a row: half the keys at +inf
    (they sort after the pads); most keys at the pads' 3.4e38 with ids up
    to 2**31 - 1; -0.0, +0.0 and 1.0 under four ids; three finite keys and
    the rest +inf; a descending row."""
    d = rng.normal(size=(b, m)).astype(np.float32)
    i = rng.integers(-1 << 30, 1 << 30, (b, m)).astype(np.int32)
    kind = np.arange(b) % 5
    u = rng.random((b, m))
    d[(kind == 0)[:, None] & (u < 0.5)] = np.inf
    at_pad = (kind == 1)[:, None] & (u < 0.8)
    d[at_pad] = np.float32(3.4e38)
    i[at_pad & (rng.random((b, m)) < 0.2)] = tkk.PAD_ID
    zeros = np.array([-0.0, 0.0, 1.0], np.float32)[rng.integers(0, 3, (b, m))]
    d[kind == 2] = zeros[kind == 2]
    i[kind == 2] = rng.integers(0, 4, (int((kind == 2).sum()), m))
    d[kind == 3] = np.inf
    d[kind == 3, :3] = 1.0
    d[kind == 4] = -np.sort(d[kind == 4], axis=1)
    return d, i


def check_topk(dev, rng) -> None:
    """Every route at its edges: B = 256 rows take the block's selection for
    k <= 64 and 4,096 rows the warp's for k <= 32; k = 2,048 the network."""
    n_checked, routes = 0, set()
    for b, ks in ((BATCH, (10, 32, 33, 64, 2048)), (4096, (10, 32))):
        for m in (5, 8 * (DEGREE + R_MAX), 1000, 10_000):
            for keys in ("random", "dup", "edges"):
                x = topk_edge_keys(rng, b, m) if keys == "edges" else topk_keys(rng, b, m, keys == "dup")
                d, i = (torch.from_numpy(a).to(dev) for a in x)
                for k in ks:
                    got, want = tkk.topk_merge(d, i, k), tkk.topk_merge_ref(d, i, k)
                    what = f"topk_merge B={b} M={m} k={k} {keys} route={tkk.route(b, m, k)}"
                    same(got[0].view(torch.int32), want[0].view(torch.int32), f"{what} dists")
                    same(got[1], want[1], f"{what} ids")
                    routes.add(tkk.route(b, m, k))
                    n_checked += 1
    require(routes == set(tkk.ROUTES), f"topk_merge routes checked: {routes}")
    log("kernels", f"topk_merge bit-identical (dists' bits included): {n_checked} cases, B in "
        f"({BATCH}, 4096), M in (5, 768, 1000, 10000), k in (10, 32, 33, 64, 2048) on all three "
        "routes, random, duplicate-heavy and edge keys (+inf, 3.4e38 ties, -0.0/+0.0)")


# ---------------------------------------------------------------- phase 3
def fs_type(path: str) -> str:
    """The file system type of the mount holding ``path`` (/proc/mounts)."""
    path, best, kind = os.path.realpath(path), "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1].replace("\\040", " ")
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return kind


def index_dir() -> str:
    """Where the index file goes: the temporary directory, unless it is a
    tmpfs (whose reads are page-cache reads, not SSD reads); then the
    git-ignored ``build/`` beside the repository."""
    tmp = tempfile.gettempdir()
    kind = fs_type(tmp)
    log("index", f"temporary directory {tmp} is on {kind}")
    if kind != "tmpfs":
        return tmp
    log("index", "tmpfs: its reads would be page-cache reads, not SSD reads; "
        "the index goes under build/ instead")
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    log("index", f"{build} is on {fs_type(str(build))}")
    return str(build)


def knn_graph(x: torch.Tensor, gen: torch.Generator, block: int = 1024) -> torch.Tensor:
    """(N, DEGREE) int32: EXACT_NBRS exact neighbours in ascending distance
    (self excluded), then DEGREE - EXACT_NBRS seeded random ids."""
    n = x.shape[0]
    xx = (x * x).sum(1)
    out = torch.empty((n, DEGREE), dtype=torch.int32, device=x.device)
    for s in range(0, n, block):
        blk = x[s:s + block]
        d = (blk @ x.T).mul_(-2.0).add_(xx[None]).add_(xx[s:s + block, None])
        ids = torch.topk(d, EXACT_NBRS + 1, dim=1, largest=False, sorted=True).indices
        own = torch.arange(s, s + blk.shape[0], device=x.device)[:, None]
        keep = torch.sort((ids == own).int(), dim=1, stable=True).indices[:, :EXACT_NBRS]
        out[s:s + block, :EXACT_NBRS] = ids.gather(1, keep).int()
    out[:, EXACT_NBRS:] = torch.randint(0, n, (n, DEGREE - EXACT_NBRS), generator=gen,
                                        device=x.device, dtype=torch.int32)
    return out


def build_index(path: str, n: int, dev, seed: int = 0) -> dict:
    t0 = time.perf_counter()
    x_np = make_bigann_like(n, DIM, seed=seed)
    labels = uniform_labels(n, N_LABELS, seed=seed)
    norms = np.linalg.norm(x_np, axis=1).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nbrs = knn_graph(x, gen)
    medoid = int(torch.argmin(((x - x.mean(0, keepdim=True)) ** 2).sum(1)))
    sample = x[torch.randperm(n, generator=gen, device=dev)[:65536]]
    codec = pqm.train_pq(sample, n_chunks=PQ_CHUNKS, n_centroids=256, generator=gen)
    codes = pqm.encode_pq(codec, x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # the build's geometry beside the served fields, as the reference saves it
    cfg = dataclasses.asdict(EngineConfig(degree=DEGREE, pq_chunks=PQ_CHUNKS, r_max=R_MAX))
    write_index(path, vectors=x_np, neighbors=nbrs.cpu().numpy(),
                pq_books=codec.books.cpu().numpy(), pq_codes=codes.cpu().numpy(),
                medoid=medoid, config=cfg,
                filters={"label": labels, "range": norms})
    t2 = time.perf_counter()
    return {"x": x, "x_np": x_np, "labels": labels, "build_s": t1 - t0, "write_s": t2 - t1,
            "file_bytes": os.path.getsize(path)}


def ground_truth(x: torch.Tensor, labels: torch.Tensor, q: torch.Tensor, target: torch.Tensor,
                 k: int = 10) -> np.ndarray:
    """Exact filtered top-k in float64 on the card; -1 where fewer match."""
    xd, qd = x.double(), q.double()
    d = (qd * qd).sum(1)[:, None] - 2.0 * (qd @ xd.T) + (xd * xd).sum(1)[None]
    d = torch.where(labels[None] == target[:, None], d, float("inf"))
    dist, ids = torch.topk(d, k, dim=1, largest=False)
    return torch.where(torch.isfinite(dist), ids, -1).cpu().numpy()


# ------------------------------------------------------------ the build phase
def stats_summary(run) -> dict:
    ids, dists, st, lat, _ = run
    n_q = ids.shape[0]
    return {**{f"mean_{f}": float(st[f].float().mean())
               for f in ("n_ios", "n_tunnels", "n_hops", "n_cache_hits")},
            "qps": n_q / float(lat.sum()), "p50_batch_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_batch_ms": float(np.percentile(lat, 99) * 1e3)}


def build_phase(tmp: str, dev, card: str, cap, n: int) -> dict:
    """``GateANNEngine.build`` on the card at N = ``n`` (BigANN-like, D = 128,
    R = 64, L_build = 64, alpha = 1.2, two passes, 10 labels and the norm
    range; PQ trained on every vector), timed by part; saved, loaded and
    searched bit-identically to the built engine; then the gate search's
    recall and I/O on this Vamana graph beside the smoke's 48 + 16 graph
    over the same vectors and the same PQ."""
    x_np = make_bigann_like(n, DIM, seed=5)
    labels = uniform_labels(n, N_LABELS, seed=5)
    norms = np.linalg.norm(x_np, axis=1).astype(np.float32)
    cfg = EngineConfig(degree=DEGREE, build_l=BUILD_L, alpha=ALPHA, pq_chunks=PQ_CHUNKS,
                       r_max=R_MAX)
    parts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = GateANNEngine.build(x_np, config=cfg, labels=labels, attributes=norms, timings=parts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    graph_s = sum(parts[k] for k in ("beam_search", "prune", "reverse_edges"))
    log("build", f"GateANNEngine.build on {eng.device}: N={n:,} D={DIM} R={DEGREE} "
        f"L_build={BUILD_L} alpha={ALPHA} two passes, C={PQ_CHUNKS}: {build_s:.1f} s "
        f"(graph {graph_s:.1f} s: beam search {parts['beam_search']:.1f} s, prune "
        f"{parts['prune']:.1f} s, reverse edges {parts['reverse_edges']:.1f} s; PQ on all "
        f"{n:,} vectors {parts['pq']:.1f} s) on {card}")
    path = os.path.join(tmp, "build.gann")
    t0 = time.perf_counter()
    eng.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = GateANNEngine.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = torch.from_numpy(x_np).to(dev)
    q = torch.from_numpy(make_queries(x_np, N_QUERIES, seed=1)).to(dev)
    targets = torch.from_numpy(
        np.random.default_rng(2).integers(0, N_LABELS, N_QUERIES).astype(np.int32)).to(dev)
    gt = ground_truth(x, torch.from_numpy(labels).to(dev), q, targets)
    search = SearchConfig(mode="gate", **SEARCH)
    runs = {"build_vamana_gate": run_search(eng, q, targets, search)}
    same_run(run_search(loaded, q, targets, search), runs["build_vamana_gate"],
             "loaded index vs built engine")
    log("build", f"saved ({os.path.getsize(path) / 2**20:.1f} MiB) in {save_s:.1f} s, loaded in "
        f"{load_s:.1f} s; the loaded index searches bit-identically to the built engine "
        "(ids, dists, six stats)")
    knn = knn_graph(x, torch.Generator(device=dev).manual_seed(5))
    knn_eng = GateANNEngine.from_arrays(
        x_np, knn.cpu().numpy(), eng.codec.books.cpu().numpy(), eng.codes.cpu().numpy(),
        graphm.find_medoid(x), {"label": labels, "range": norms}, cfg)
    runs["build_knn_gate"] = run_search(knn_eng, q, targets, search)
    summary = {"n": n, "build_s": build_s, "graph_s": graph_s, "parts_s": parts,
               "save_s": save_s, "load_s": load_s}
    for name, run in runs.items():
        cap.launches[name] = run[4]
        require_launches(cap, name, ("pq_lookup", "rerank"),
                         ("fused_traversal", "l2_dist", "plain_merges"))
        summary[name] = {"recall@10": recall_at_k(run[0], gt, 10), **stats_summary(run)}
        r = summary[name]
        log("build", f"{name} ({'Vamana' if 'vamana' in name else '48 exact + 16 random links'}"
            f", N={n:,}): recall@10 {r['recall@10']:.4f}  mean n_ios {r['mean_n_ios']:.2f} "
            f"n_tunnels {r['mean_n_tunnels']:.2f} n_hops {r['mean_n_hops']:.2f}  QPS "
            f"{r['qps']:.1f} on {card}")
    print(json.dumps({"build": summary, "card": card}), flush=True)
    del eng, loaded, knn_eng, x
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------- phase 4
class Capture:
    """Records (clones of) the inputs of one mid-search call of each
    kernel wrapper, so phase 8 times the kernels on real calls."""

    def __init__(self, at_call: int = 6):
        self.at_call, self.calls, self.args = at_call, {}, {}
        self.saved = []
        # the ids of every adc_ids call in one gate-unfused batch (distinct
        # id sets, for the round-robin timing), recorded while phase says so
        self.phase, self.adc_rounds = None, []
        self.launches = {}  # path -> its kernel launches, each counted from 0
        self.stage_b = None  # a round's stage B, re-rank against the parent design
        # the scan path: its third batch's scan, first-level merge (under
        # "topk_merge") and second-level merge (under "topk_merge_2")
        self.at = {"pq_scan": (3,), "topk_merge": (5, 6)}

    def wrap(self, module, fn_name: str, key: str):
        real = getattr(module, fn_name)

        def recorder(*args, **kwargs):
            self.calls[key] = self.calls.get(key, 0) + 1
            if key == "pq_lookup" and self.phase == "gate_unfused":
                self.adc_rounds.append(args[2].clone())
            at = self.at.get(key, (self.at_call,))
            if self.calls[key] in at:
                clone = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
                n = at.index(self.calls[key])
                self.args[key if n == 0 else f"{key}_{n + 1}"] = (clone, dict(kwargs))
            return real(*args, **kwargs)

        self.saved.append((module, fn_name, real))
        setattr(module, fn_name, recorder)

    def __enter__(self):
        self.wrap(pqk, "adc_ids", "pq_lookup")
        self.wrap(l2k, "rerank", "rerank")
        self.wrap(ftk, "fused_traversal_round", "fused_traversal")
        self.wrap(pqk, "pq_scan", "pq_scan")
        self.wrap(kops, "topk_merge", "topk_merge")
        return self

    def __exit__(self, *exc):
        for module, fn_name, real in self.saved:
            setattr(module, fn_name, real)
        self.saved.clear()


PLAIN_MERGES = [0]  # calls of the plain result-list merge, frontier.results_insert


def watch_plain_merges() -> None:
    """Count every call of ``frontier.results_insert``: the card's search
    paths take it only where K + W is past the re-rank kernel's limits."""
    real = fr.results_insert

    def counted(*args, **kwargs):
        PLAIN_MERGES[0] += 1
        return real(*args, **kwargs)

    fr.results_insert = counted


def run_search(eng, queries, targets, cfg):
    """All queries in batches; returns ids, dists, stats, batch latencies
    and the kernel launches of this run alone, with its calls of the
    plain merge under "plain_merges"."""
    ids, dists, stats, lat = [], [], [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    PLAIN_MERGES[0] = 0
    for s in range(0, queries.shape[0], BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.search(queries[s:s + BATCH], filter_kind="label",
                         filter_params=targets[s:s + BATCH], search_config=cfg)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        ids.append(out.ids)
        dists.append(out.dists)
        stats.append(out.stats)
    launches = {**_build.LAUNCHES, "plain_merges": PLAIN_MERGES[0]}
    cat = {f: torch.cat([getattr(st, f) for st in stats]) for f in stats[0]._fields}
    return torch.cat(ids), torch.cat(dists), cat, np.asarray(lat), launches


def require_launches(cap: Capture, path: str, kernels: tuple, absent: tuple = ()) -> None:
    for name in kernels:
        require(cap.launches[path].get(name, 0) > 0, f"{path}: kernel {name} was not launched")
    for name in absent:
        require(cap.launches[path].get(name, 0) == 0, f"{path}: kernel {name} ran")


def same_run(a, b, what: str) -> None:
    """Two runs' ids, dists and all six SearchStats bit-identical."""
    same(a[0], b[0], f"{what} ids")
    same(a[1], b[1], f"{what} dists")
    for f in b[2]:
        same(a[2][f], b[2][f], f"{what} stats.{f}")


def search_phase(eng, q, targets, gt, card: str, cap: Capture) -> dict:
    configs = {
        "gate_unfused": SearchConfig(mode="gate", **SEARCH),
        "gate_fused": SearchConfig(mode="gate", use_fused_kernel=True, **SEARCH),
        "post": SearchConfig(mode="post", **SEARCH),
    }
    with cap:  # warm-up batch, untimed: loads the kernels, records real rounds
        for name, cfg in configs.items():
            cap.phase = name
            eng.search(q[:BATCH], filter_kind="label", filter_params=targets[:BATCH],
                       search_config=cfg)
        cap.phase = None
    torch.cuda.synchronize()
    # a round's stage B, re-rank kernel against the parent design, before
    # any profiler session (CUPTI's callbacks slow later host calls)
    cap.stage_b = stage_b_line(cap, card)

    # each path's launches are counted from 0 just before it and read just after
    runs = {name: run_search(eng, q, targets, cfg) for name, cfg in configs.items()}
    cap.launches.update({name: run[4] for name, run in runs.items()})
    for path in ("gate_unfused", "post"):
        require_launches(cap, path, ("pq_lookup", "rerank"),
                         ("fused_traversal", "l2_dist", "plain_merges"))
    require_launches(cap, "gate_fused", ("pq_lookup", "rerank", "fused_traversal"),
                     ("l2_dist", "plain_merges"))
    n_batches = N_QUERIES // BATCH
    for path in configs:
        counts = cap.launches[path]
        log("search", f"{path}: launches {json.dumps(counts)} over {n_batches} batches "
            f"({', '.join(f'{k} {v / n_batches:g}' for k, v in counts.items())} a batch)")

    same_run(runs["gate_fused"], runs["gate_unfused"], "gate fused vs unfused")
    log("search", "gate fused == gate unfused: ids, dists and all six SearchStats counters")
    # the re-rank's other route: K + W past the kernel's limit takes the
    # standalone L2 kernel and the plain merge; the first 10 results and
    # the stats are the K = 10 run's (the result list is write-only state)
    wide = dataclasses.replace(configs["gate_unfused"],
                               result_k=split_k(SEARCH["beam_width"], DIM))
    require(l2k.rerank_route(wide.result_k, wide.beam_width, DIM) == "split", "wide run: route")
    run = run_search(eng, q[:BATCH], targets[:BATCH], wide)
    cap.launches["gate_unfused_split"] = run[4]
    require_launches(cap, "gate_unfused_split", ("pq_lookup", "l2_dist", "plain_merges"),
                     ("rerank", "fused_traversal"))
    base = runs["gate_unfused"]
    same(run[0][:, :10], base[0][:BATCH], "split route ids")
    same(run[1][:, :10], base[1][:BATCH], "split route dists")
    for f in base[2]:
        same(run[2][f], base[2][f][:BATCH], f"split route stats.{f}")
    log("search", f"gate unfused at K={wide.result_k} (K+W one past the re-rank kernel's "
        f"{wide.result_k + SEARCH['beam_width'] - 1}): launches {json.dumps(run[4])}; its first 10 results and stats "
        "== the K=10 run's")
    summary = {}
    for name, (ids, dists, st, lat, _) in runs.items():
        require(bool(torch.isfinite(dists[ids >= 0]).all()), f"{name}: non-finite distances")
        rec = recall_at_k(ids, gt, 10)
        means = {f: float(st[f].float().mean()) for f in ("n_ios", "n_tunnels", "n_hops", "n_exact")}
        summary[name] = {"recall@10": rec, **means, "qps": N_QUERIES / float(lat.sum()),
                         "p50_batch_ms": float(np.percentile(lat, 50) * 1e3),
                         "p99_batch_ms": float(np.percentile(lat, 99) * 1e3)}
        log("search", f"{name}: recall@10 {rec:.4f}  mean n_ios {means['n_ios']:.2f} "
            f"n_tunnels {means['n_tunnels']:.2f} n_hops {means['n_hops']:.2f}  "
            f"QPS {summary[name]['qps']:.1f}  batch latency p50 "
            f"{summary[name]['p50_batch_ms']:.2f} ms p99 {summary[name]['p99_batch_ms']:.2f} ms "
            f"({N_QUERIES // BATCH} batches of {BATCH}) on {card}")
    require(summary["gate_unfused"]["n_ios"] < summary["post"]["n_ios"],
            "gate's mean n_ios is not below post's")
    # a garbage detector, not a quality bar: at L = 64 and 10% selectivity
    # this synthetic data's low relative contrast keeps recall modest
    require(summary["gate_unfused"]["recall@10"] > 0.1, "gate recall@10 below 0.1")
    log("search", f"gate mean n_ios {summary['gate_unfused']['n_ios']:.2f} < post "
        f"{summary['post']['n_ios']:.2f}")
    # off the main path: the same queries at a wider frontier, to show how
    # far recall at L = 64 is from what the graph can reach
    ids, _, st, lat, _ = run_search(eng, q, targets, SearchConfig(mode="gate", search_l=256,
                                                               beam_width=8, result_k=10))
    summary["gate_L256"] = {"recall@10": recall_at_k(ids, gt, 10),
                            "n_ios": float(st["n_ios"].float().mean()),
                            "n_hops": float(st["n_hops"].float().mean()),
                            "qps": N_QUERIES / float(lat.sum())}
    log("search", f"gate unfused at L=256: recall@10 {summary['gate_L256']['recall@10']:.4f} "
        f"mean n_ios {summary['gate_L256']['n_ios']:.2f} n_hops {summary['gate_L256']['n_hops']:.2f} "
        f"QPS {summary['gate_L256']['qps']:.1f} on {card}")
    for name in ("gate_unfused", "gate_fused"):
        summary[name]["profile"] = profile_batch(
            lambda: eng.search(q[:BATCH], filter_kind="label", filter_params=targets[:BATCH],
                               search_config=configs[name]), summary[name]["p50_batch_ms"])
        log("profile", f"{name}, one batch of {BATCH} under torch.profiler on {card}: "
            + json.dumps(summary[name]["profile"]))
    print(json.dumps({"search": summary, "card": card}), flush=True)
    return {name: run[:3] for name, run in runs.items()}


# ------------------------------------------------------------- the dist phase
def timed_collectives() -> list:
    """Wrap ``torch.distributed.all_reduce`` to add its host-clock seconds
    (the card drained before and after) and its calls to the returned
    list; for one instrumented batch, not the timed ones."""
    real = torch.distributed.all_reduce
    spent = [0.0, 0]

    def timed(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    torch.distributed.all_reduce = timed
    return spent


def labelled(owner, name: str, label: str):
    """Wrap ``owner.name`` in a ``record_function`` range ``label``;
    returns the unwrapped function."""
    real = getattr(owner, name)

    def run(*args, **kwargs):
        with torch.profiler.record_function(label):
            return real(*args, **kwargs)

    setattr(owner, name, run)
    return real


def dist_rank(mesh, path: str, inputs: str, n_hops: int, profile: bool = False) -> dict:
    """One rank of the dist phase: the replicated sections and only this
    rank's record rows onto the card, then the queries of ``inputs`` in
    batches of BATCH, gate then post, each batch's rows split over
    ``data``.  Returns, per mode, the outputs of the rows this rank
    served, each batch's latency and the mode's kernel launches (counted
    from 0 just before its timed batches) with its plain merges; then one
    batch more with each all_reduce timed alone; with ``profile``, last,
    one batch a mode under ``torch.profiler`` with the step's parts in
    ranges of their own."""
    from repro_torch.core import distributed_search as tds
    from repro_torch.store import ShardedRecordStore, read_index

    torch.set_num_threads(1)
    watch_plain_merges()
    dev, shard = mesh.device, mesh.index("model")
    t0 = time.perf_counter()
    idx = read_index(path)
    books = torch.tensor(idx.pq_books(), device=dev)
    codec = pqm.PQCodec(books, int(books.shape[0]), int(books.shape[1]))
    codes = torch.tensor(idx.pq_codes(), device=dev)
    nbr_store = torch.tensor(np.ascontiguousarray(idx.neighbors()[:, :R_MAX]), device=dev)
    labels = torch.tensor(idx.filter_array("label"), device=dev)
    entry = torch.tensor(idx.header.medoid, dtype=torch.int32, device=dev)
    vecs, graph, rows = tds.load_shard_records(path, shard, n_shards=mesh.size("model"))
    rec_vecs, rec_graph = torch.tensor(vecs, device=dev), torch.tensor(graph, device=dev)
    del vecs, graph
    data = np.load(inputs)
    q_all = torch.tensor(data["q"], device=dev)
    t_all = torch.tensor(data["targets"], device=dev)
    torch.cuda.synchronize()
    out = {"load_s": time.perf_counter() - t0, "coords": mesh.coords,
           "device_bytes": {"records": rec_vecs.nbytes + rec_graph.nbytes, "codes": codes.nbytes,
                            "neighbor_store": nbr_store.nbytes, "labels": labels.nbytes}}
    bs = tds.batch_slice(mesh, BATCH)

    def batch(step, s):
        q = q_all[s:s + BATCH][bs].contiguous()
        return step(q, pqm.build_lut(codec, q), codes, nbr_store, labels, rec_vecs, rec_graph,
                    entry, t_all[s:s + BATCH][bs].contiguous())

    for mode in ("gate", "post"):
        cfg = tds.DistSearchConfig(mode=mode, **SEARCH, n_hops=n_hops, visited_cap=DIST_CAP)
        step = tds.make_retrieve_step(mesh, cfg, rows_per_shard=rows)
        batch(step, 0)  # warm-up, untimed
        torch.cuda.synchronize()
        _build.reset_launches()
        PLAIN_MERGES[0] = 0
        res, lat = [], []
        for s in range(0, q_all.shape[0], BATCH):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = batch(step, s)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
            res.append({k: v.cpu().numpy() for k, v in r.items()})
        out[mode] = {k: np.concatenate([r[k] for r in res]) for k in res[0]}
        out[mode]["lat"] = np.asarray(lat)
        out[mode]["launches"] = {**_build.LAUNCHES, "plain_merges": PLAIN_MERGES[0]}
        real = torch.distributed.all_reduce
        spent = timed_collectives()
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch(step, 0)
            torch.cuda.synchronize()
            out[mode]["instrumented"] = {"batch_s": time.perf_counter() - t1,
                                         "all_reduce_s": spent[0], "all_reduce_calls": spent[1]}
        finally:
            torch.distributed.all_reduce = real
    if profile:  # last: CUPTI's callbacks slow later host calls
        parts = ((tds, "ring_membership"), (tds, "push_visited"), (ShardedRecordStore, "fetch"),
                 (pqk, "adc_ids"), (l2k, "rerank"))
        reals = [labelled(o, n, n) for o, n in parts]
        try:
            for mode in ("gate", "post"):
                cfg = tds.DistSearchConfig(mode=mode, **SEARCH, n_hops=n_hops,
                                           visited_cap=DIST_CAP)
                step = tds.make_retrieve_step(mesh, cfg, rows_per_shard=rows)
                out[mode]["profile"] = profile_batch(
                    lambda: batch(step, 0), float(np.percentile(out[mode]["lat"], 50) * 1e3),
                    parts=tuple(n for _, n in parts))
        finally:
            for (o, n), real in zip(parts, reals):
                setattr(o, n, real)
    out["rows"] = np.concatenate([np.arange(s + bs.start, s + bs.stop)
                                  for s in range(0, q_all.shape[0], BATCH)])
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


def dist_merge(ranks: list, mode: str, n: int) -> dict:
    """A mode's outputs over all queries, each row from the ranks that
    served it, after checking that those ranks agree bit for bit."""
    merged = {}
    for r in ranks:
        for k in ("ids", "dists", "n_ios", "n_tunnels"):
            v = r[mode][k]
            if k not in merged:
                merged[k] = np.zeros((n, *v.shape[1:]), v.dtype)
                merged[k + "_seen"] = np.zeros(n, bool)
            seen = merged[k + "_seen"][r["rows"]]
            require(np.array_equal(merged[k][r["rows"]][seen].view(np.int32),
                                   v[seen].view(np.int32)),
                    f"dist {mode}: ranks serving the same rows disagree on {k}")
            merged[k][r["rows"]] = v
            merged[k + "_seen"][r["rows"]] = True
    for k in ("ids", "dists", "n_ios", "n_tunnels"):
        require(bool(merged.pop(k + "_seen").all()), f"dist {mode}: rows without an answer")
    return merged


def dist_phase(tmp: str, path: str, q, targets, mem_runs: dict, card: str, cap: Capture) -> None:
    """Distributed search on the one card: 4 gloo ranks with the records
    split over ``model`` (each reads only its own rows of the index file),
    equal bit for bit to phase 4's unfused gate and post; a (2, 2) mesh
    and a 1-rank nccl world equal to it."""
    rounds = {m: int(mem_runs[name][2]["n_hops"].max())
              for m, name in (("gate", "gate_unfused"), ("post", "post"))}
    n_hops = max(rounds.values())
    m = SEARCH["beam_width"] * (DEGREE + R_MAX)
    require(1 + n_hops * m <= DIST_CAP, "dist: the ring could wrap")
    log("dist", f"n_hops {n_hops} (phase 4's rounds a batch at most: gate {rounds['gate']}, "
        f"post {rounds['post']}); visited_cap {DIST_CAP:,} ({BATCH * DIST_CAP * 4 / 2**20:.0f} "
        f"MiB a rank at B={BATCH}) >= 1 + n_hops * M = {1 + n_hops * m:,}: the ring never wraps")
    inputs = os.path.join(tmp, "dist_queries.npz")
    np.savez(inputs, q=q.cpu().numpy(), targets=targets.cpu().numpy())
    n = q.shape[0]
    summary = {}
    for name, shape, backend in (("dist_1x4", (1, 4), "gloo"), ("dist_2x2", (2, 2), "gloo"),
                                 ("dist_nccl_1x1", (1, 1), "nccl")):
        t0 = time.perf_counter()
        ranks = spawn_local(dist_rank, shape, backend=backend, device="cuda:0",
                            timeout_s=DIST_TIMEOUT_S,
                            args=(path, inputs, n_hops, backend == "nccl"))
        wall = time.perf_counter() - t0
        cap.launches[name] = {}
        for r in ranks:
            for mode in ("gate", "post"):
                for k, v in r[mode]["launches"].items():
                    cap.launches[name][k] = cap.launches[name].get(k, 0) + v
        require_launches(cap, name, ("pq_lookup", "rerank"),
                         ("fused_traversal", "l2_dist", "plain_merges"))
        for mode, base in (("gate", "gate_unfused"), ("post", "post")):
            got, want = dist_merge(ranks, mode, n), mem_runs[base]
            for i, k in enumerate(("ids", "dists")):
                same(torch.from_numpy(got[k]), want[i].cpu(), f"{name} {mode} {k} vs phase 4")
            for k in ("n_ios", "n_tunnels"):
                same(torch.from_numpy(got[k]), want[2][k].cpu(), f"{name} {mode} {k} vs phase 4")
        lat = ranks[0]["gate"]["lat"], ranks[0]["post"]["lat"]
        row = {"mesh": dict(zip(("data", "model"), shape)), "backend": backend,
               "spawn_to_join_s": wall, "load_s": max(r["load_s"] for r in ranks),
               "launches": cap.launches[name],
               "max_memory_allocated_per_rank": [r["max_memory_allocated"] for r in ranks],
               "device_bytes_rank0": ranks[0]["device_bytes"]}
        for mode, la in zip(("gate", "post"), lat):
            inst = ranks[0][mode]["instrumented"]
            row[mode] = {"p50_batch_ms": float(np.percentile(la, 50) * 1e3),
                         "p99_batch_ms": float(np.percentile(la, 99) * 1e3),
                         "ms_a_round": float(np.percentile(la, 50) * 1e3) / n_hops,
                         "qps": n / float(la.sum()),
                         "mean_n_ios": float(dist_merge(ranks, mode, n)["n_ios"].mean()),
                         "all_reduce_share": inst["all_reduce_s"] / inst["batch_s"],
                         "all_reduce_ms": inst["all_reduce_s"] / inst["all_reduce_calls"] * 1e3}
        b_rank = BATCH // shape[0]
        row["collective_bytes_a_round"] = b_rank * SEARCH["beam_width"] * (DIM + DEGREE) * 4
        summary[name] = row
        log("dist", f"{name} ({backend}, data={shape[0]} model={shape[1]}): gate and post == "
            f"phase 4's unfused gate and post (ids, dists, n_ios, n_tunnels, bit for bit); "
            f"launches {json.dumps(row['launches'])} over both modes' {2 * n // BATCH} batches, "
            f"all ranks; spawn to join {wall:.1f} s, loads {row['load_s']:.1f} s on {card}")
        for mode in ("gate", "post"):
            r = row[mode]
            log("dist", f"{name} {mode}: batch p50 {r['p50_batch_ms']:.1f} ms p99 "
                f"{r['p99_batch_ms']:.1f} ms ({r['ms_a_round']:.2f} ms a round), QPS "
                f"{r['qps']:.1f}, mean n_ios {r['mean_n_ios']:.2f}; rank 0's instrumented batch: "
                f"all_reduce {r['all_reduce_share']:.1%} of its host clock, "
                f"{r['all_reduce_ms']:.2f} ms a call; {row['collective_bytes_a_round']:,} collective "
                f"bytes a round a rank (B={b_rank} W={SEARCH['beam_width']} D+R={DIM + DEGREE}) "
                f"on {card}")
        for mode in ("gate", "post") if backend == "nccl" else ():
            row[mode]["profile"] = ranks[0][mode]["profile"]
            log("profile", f"{name} {mode}, one batch of {BATCH} under torch.profiler on {card}: "
                + json.dumps(row[mode]["profile"]))
        log("dist", f"{name} device bytes a rank: {json.dumps(row['device_bytes_rank0'])} "
            f"(rank 0); max allocated {[f'{b / 2**20:.0f} MiB' for b in row['max_memory_allocated_per_rank']]}")
    require(summary["dist_1x4"]["gate"]["mean_n_ios"] < summary["dist_1x4"]["post"]["mean_n_ios"],
            "dist: gate's mean n_ios is not below post's")
    log("dist", "the (2, 2) mesh and the 1-rank nccl world == the (1, 4) mesh == phase 4")
    print(json.dumps({"dist": summary, "n_hops": n_hops, "phase4_rounds": rounds,
                      "visited_cap": DIST_CAP, "card": card}), flush=True)


# ---------------------------------------------------------------- phase 5
def ssd_phase(path: str, q, targets, mem_runs: dict, card: str, cap: Capture) -> None:
    """The memory tier's queries served off the index file, each
    configuration from a dropped page cache."""
    # max_gap_sectors=0: one read per run of adjacent records, no bridged
    # gaps (an unbounded bridge reads the whole span between a round's
    # records, gigabytes at N = 1M)
    eng = GateANNEngine.load(path, store_tier="disk", max_gap_sectors=0)
    store = eng.measured_store()
    log("ssd", f"disk tier: {store.n:,} records of {store.sector_bytes} B in {store.n_shards} "
        f"segment(s), io_mode {store.io_mode}, max_gap_sectors {store.max_gap_sectors}, "
        f"{store.reader_threads} reader threads; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    configs = {  # name -> (config, the memory-tier run it must equal)
        "disk_gate_d1": (SearchConfig(mode="gate", **SEARCH), "gate_unfused"),
        f"disk_gate_d{DEPTH}": (SearchConfig(mode="gate", pipeline_depth=DEPTH, **SEARCH),
                                "gate_unfused"),
        f"disk_gate_fused_d{DEPTH}": (SearchConfig(mode="gate", use_fused_kernel=True,
                                                   pipeline_depth=DEPTH, **SEARCH), "gate_fused"),
        f"disk_post_d{DEPTH}": (SearchConfig(mode="post", pipeline_depth=DEPTH, **SEARCH), "post"),
    }
    summary, runs = {}, {}
    for name, (cfg, mem_name) in configs.items():
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)  # DONTNEED leaves dirty pages: a cold run must start clean
        finally:
            os.close(fd)
        store.reset_io_counters()
        store.drop_page_cache()
        dropped = store.io_counters()["warm_errors"] == 0
        log("ssd", f"{name}: file synced, page cache dropped: {'every drop worked' if dropped else 'A DROP FAILED'}")
        store.reset_io_counters()
        run = run_search(eng, q, targets, cfg)
        torch.cuda.synchronize()
        io = store.io_counters()
        runs[name] = run
        cap.launches[name] = run[4]
        ids, dists, st, lat, _ = run
        same_run(run, mem_runs[mem_name], f"{name} vs memory tier {mem_name}")
        n_ios = int(st["n_ios"].sum())
        require(io["records_read"] == n_ios, f"{name}: records_read {io['records_read']} != sum(n_ios) {n_ios}")
        require(io["abandoned_tokens"] == 0, f"{name}: {io['abandoned_tokens']} abandoned tokens")
        if cfg.pipeline_depth > 1:
            require(io["overlapped_rounds"] > 0, f"{name}: no round overlapped another's read")
        fused = cfg.use_fused_kernel
        require_launches(cap, name, ("pq_lookup", "rerank") + (("fused_traversal",) if fused else ()),
                         ("l2_dist", "plain_merges") + (() if fused else ("fused_traversal",)))
        summary[name] = {
            "qps": N_QUERIES / float(lat.sum()), "p50_batch_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_batch_ms": float(np.percentile(lat, 99) * 1e3),
            **{f"mean_{f}": float(st[f].float().mean()) for f in ("n_ios", "n_tunnels", "n_hops")},
            "page_cache_dropped": dropped, "launches": run[4],
            **{k: io[k] for k in ("records_read", "bytes_read", "unique_sectors_read", "syscalls",
                                  "gap_sectors_read", "read_rounds", "inflight_depth_max",
                                  "overlapped_rounds", "abandoned_tokens")},
        }
        r = summary[name]
        log("ssd", f"{name}: QPS {r['qps']:.1f}  batch p50 {r['p50_batch_ms']:.2f} ms p99 "
            f"{r['p99_batch_ms']:.2f} ms  mean n_ios {r['mean_n_ios']:.2f} n_tunnels "
            f"{r['mean_n_tunnels']:.2f} n_hops {r['mean_n_hops']:.2f}  bytes_read {io['bytes_read']} "
            f"syscalls {io['syscalls']} gap_sectors_read {io['gap_sectors_read']} "
            f"inflight_depth_max {io['inflight_depth_max']} overlapped_rounds "
            f"{io['overlapped_rounds']}  launches {json.dumps(run[4])} on {card}")
    same_run(runs[f"disk_gate_d{DEPTH}"], runs["disk_gate_d1"], f"disk gate depth {DEPTH} vs depth 1")
    log("ssd", f"every disk run == its memory-tier run (ids, dists, six stats); depth {DEPTH} == "
        "depth 1; records_read == sum(n_ios); no abandoned token")
    d1, d4 = summary["disk_gate_d1"], summary[f"disk_gate_d{DEPTH}"]
    log("ssd", f"gate depth {DEPTH} over depth 1: {d4['qps'] / d1['qps']:.3f}x QPS; gate mean n_ios "
        f"{d4['mean_n_ios']:.2f} vs post {summary[f'disk_post_d{DEPTH}']['mean_n_ios']:.2f} "
        f"({d4['mean_n_ios'] / summary[f'disk_post_d{DEPTH}']['mean_n_ios']:.3f}x)")
    summary["read_probe"] = read_probe(store, card)
    for name in ("disk_gate_d1", f"disk_gate_d{DEPTH}"):
        host_profile(eng, q[:BATCH], targets[:BATCH], configs[name][0], name)
    # off the path: depth 4 with one reader thread instead of four
    one = dataclasses.replace(eng, record_store=DiskRecordStore.open(
        path, device=eng.device, max_gap_sectors=0, reader_threads=1))
    lat = run_search(one, q, targets, configs[f"disk_gate_d{DEPTH}"][0])[3]
    one.record_store.close()
    summary[f"disk_gate_d{DEPTH}"]["one_reader_warm_qps"] = N_QUERIES / float(lat.sum())
    log("ssd", f"disk_gate_d{DEPTH} with 1 reader thread, page cache not dropped: QPS "
        f"{N_QUERIES / float(lat.sum()):.1f} on {card}")
    # off the path: the gate runs again without dropping the page cache
    for name in ("disk_gate_d1", f"disk_gate_d{DEPTH}"):
        lat = run_search(eng, q, targets, configs[name][0])[3]
        summary[name]["warm_qps"] = N_QUERIES / float(lat.sum())
        log("ssd", f"{name} again, page cache not dropped: QPS {summary[name]['warm_qps']:.1f} "
            f"(cold {summary[name]['qps']:.1f}) on {card}")
    for name, (cfg, _) in configs.items():  # warm page cache now: kernel time over the cold p50
        summary[name]["profile"] = profile_batch(
            lambda: eng.search(q[:BATCH], filter_kind="label", filter_params=targets[:BATCH],
                               search_config=cfg), summary[name]["p50_batch_ms"])
        log("profile", f"{name}, one batch of {BATCH} under torch.profiler on {card}: "
            + json.dumps(summary[name]["profile"]))
    print(json.dumps({"ssd": summary, "card": card}), flush=True)
    store.close()


def host_profile(eng, q, targets, cfg, name: str, top: int = 14) -> None:
    """Off the path: where the host's time goes in one batch (cProfile; on
    Python 3.12 it sees the reader threads too)."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    eng.search(q, filter_kind="label", filter_params=targets, search_config=cfg)
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(top)
    lines = [ln for ln in text.getvalue().splitlines() if ln.strip()]
    start = next(i for i, ln in enumerate(lines) if "function calls" in ln)
    for ln in lines[start:]:
        log("hostprof", f"{name}: {ln.strip()[:150]}")


def read_probe(store, card: str) -> dict:
    """Off the path: this host's record reads alone, 2,048 distinct records
    as 8 beams of 256, one beam after another and 4 at a time, from a
    dropped and from a warm page cache (µs per record)."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(4)
    sets = torch.from_numpy(rng.choice(store.n, size=(2, 8, 1, 256), replace=False).astype(np.int32))
    out = {}
    with ThreadPoolExecutor(max_workers=4) as pool:
        for cache in ("cold", "warm"):
            for threads, beams in ((1, sets[0]), (4, sets[1])):
                if cache == "cold":
                    store.drop_page_cache()
                t0 = time.perf_counter()
                if threads == 1:
                    for beam in beams:
                        store.fetch(beam)
                else:
                    list(pool.map(store.fetch, beams))
                torch.cuda.synchronize()
                out[f"{cache}_{threads}_thread_us_per_record"] = (
                    (time.perf_counter() - t0) / beams.numel() * 1e6)
    store.reset_io_counters()
    log("ssd", "read probe, 2,048 records (8 beams of 256, max_gap_sectors 0), us per record: "
        + ", ".join(f"{k.replace('_us_per_record', '')} {v:.1f}" for k, v in out.items())
        + f" on {card}")
    return out


# ------------------------------------------------------------ the cache phase
def same_cached(run, base, what: str) -> None:
    """A cached run against the uncached one: ids and dists bit-identical,
    the traversal's stats equal, n_ios + n_cache_hits == the uncached n_ios
    per query."""
    same(run[0], base[0], f"{what} ids")
    same(run[1], base[1], f"{what} dists")
    for f in ("n_tunnels", "n_exact", "n_hops", "n_degraded"):
        same(run[2][f], base[2][f], f"{what} stats.{f}")
    same(run[2]["n_ios"] + run[2]["n_cache_hits"], base[2]["n_ios"],
         f"{what} n_ios + n_cache_hits")


def cache_phase(eng, path: str, q, targets, mem_runs: dict, card: str, cap) -> dict:
    """The cache tiers on the 1M index.  Budgets of 0, 1% and 10% of the
    records (of ``record_nbytes(128, 64)`` = 4,096 B each): the memory tier
    with the ``visit_freq`` hot set, gate unfused and fused; the disk tier,
    whose lazy vectors take the ``bfs`` hot set, gate at depths 1 and 4
    from a dropped page cache; an adaptive cache on the memory tier over
    the 4 batches with ``refresh_every`` = 1.  Every run equals the uncached
    one bit for bit, n_ios + n_cache_hits equals its n_ios, n_ios does not
    grow with the budget, and on disk records_read == sum(n_ios)."""
    n = int(eng.codes.shape[0])
    per = record_nbytes(DIM, DEGREE)
    budgets = {f"{round(f * 100)}pct": int(n * f) * per for f in CACHE_FRACTIONS}
    summary = {"record_bytes": per,
               "budgets": {k: {"records": b // per, "bytes": b} for k, b in budgets.items()}}
    mem_cfgs = {"gate_unfused": SearchConfig(mode="gate", **SEARCH),
                "gate_fused": SearchConfig(mode="gate", use_fused_kernel=True, **SEARCH)}
    disk_cfgs = {f"disk_gate_d{d}": SearchConfig(mode="gate", pipeline_depth=d, **SEARCH)
                 for d in (1, DEPTH)}
    ios = {name: [int(mem_runs[base][2]["n_ios"].sum())] for name, base in
           [*((k, k) for k in mem_cfgs), *((k, "gate_unfused") for k in disk_cfgs)]}

    def record(name, run, cfg, sel_s, store, extra=None):
        cap.launches[name] = run[4]
        fused = cfg.use_fused_kernel
        require_launches(cap, name, ("pq_lookup", "rerank") + (("fused_traversal",) if fused else ()),
                         ("l2_dist", "plain_merges") + (() if fused else ("fused_traversal",)))
        r = summary[name] = {"hot_set_s": sel_s, "cached_records": store.n_cached,
                             "device_bytes": store.device_bytes(), **stats_summary(run),
                             **(extra or {})}
        log("cache", f"{name}: hot set {r['hot_set_s']:.2f} s, {r['cached_records']:,} records, "
            f"{r['device_bytes'] / 2**20:.1f} MiB on the device; QPS {r['qps']:.1f}  batch p50 "
            f"{r['p50_batch_ms']:.2f} ms p99 {r['p99_batch_ms']:.2f} ms  mean n_ios "
            f"{r['mean_n_ios']:.2f} n_cache_hits {r['mean_n_cache_hits']:.2f}  launches "
            f"{json.dumps(run[4])} on {card}")

    for bname, budget in budgets.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cached = eng.with_cache(budget)  # visit_freq over the device vectors
        torch.cuda.synchronize()
        sel_s = time.perf_counter() - t0
        for cname, cfg in mem_cfgs.items():
            name = f"cache_mem_{cname}_{bname}"
            run = run_search(cached, q, targets, cfg)
            same_cached(run, mem_runs[cname], name)
            ios[cname].append(int(run[2]["n_ios"].sum()))
            record(name, run, cfg, sel_s, cached.record_store, {"policy": "visit_freq"})
        del cached
    deng = GateANNEngine.load(path, store_tier="disk", max_gap_sectors=0)
    dstore = deng.measured_store()
    for bname, budget in budgets.items():
        t0 = time.perf_counter()
        cached = deng.with_cache(budget)  # the lazy view: the BFS order, rows read off the file
        torch.cuda.synchronize()
        sel_s = time.perf_counter() - t0
        for cname, cfg in disk_cfgs.items():
            name = f"cache_{cname}_{bname}"
            dstore.drop_page_cache()
            dstore.reset_io_counters()
            run = run_search(cached, q, targets, cfg)
            torch.cuda.synchronize()
            io = dstore.io_counters()
            same_cached(run, mem_runs["gate_unfused"], name)
            n_ios = int(run[2]["n_ios"].sum())
            require(io["records_read"] == n_ios,
                    f"{name}: records_read {io['records_read']} != sum(n_ios) {n_ios}")
            require(io["abandoned_tokens"] == 0, f"{name}: abandoned tokens")
            ios[cname].append(n_ios)
            record(name, run, cfg, sel_s, cached.record_store,
                   {"policy": "bfs", "records_read": io["records_read"],
                    "page_cache_dropped": io["warm_errors"] == 0})
        del cached
    dstore.close()
    for name, seq in ios.items():
        require(all(a >= b for a, b in zip(seq, seq[1:])),
                f"{name}: n_ios grew with the budget: {seq}")
    summary["sum_n_ios_by_budget"] = {name: dict(zip(["0pct", *budgets], seq))
                                      for name, seq in ios.items()}
    log("cache", "every cached run == its uncached run (ids, dists, traversal stats); "
        "n_ios + n_cache_hits == the uncached n_ios; sum(n_ios) at budgets 0/1%/10%: "
        + json.dumps(summary["sum_n_ios_by_budget"]))
    # the adaptive cache: refreshed before each batch after the first
    budget = budgets[f"{round(CACHE_FRACTIONS[-1] * 100)}pct"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adaptive = eng.with_cache(budget, policy="adaptive", refresh_every=1)
    torch.cuda.synchronize()
    sel_s = time.perf_counter() - t0
    run = run_search(adaptive, q, targets, mem_cfgs["gate_unfused"])
    same_cached(run, mem_runs["gate_unfused"], "adaptive")
    store = adaptive.record_store
    require(isinstance(store, AdaptiveRecordCache) and store.n_refreshes == N_QUERIES // BATCH - 1,
            f"adaptive: {store.n_refreshes} refreshes")
    hits = run[2]["n_cache_hits"].reshape(-1, BATCH).sum(1).tolist()
    record("cache_adaptive_gate_unfused", run, mem_cfgs["gate_unfused"], sel_s, store,
           {"policy": "adaptive", "refreshes": store.n_refreshes,
            "partitions": len(store.partitions), "hits_by_batch": hits})
    print(json.dumps({"cache": summary, "card": card}), flush=True)
    del adaptive
    torch.cuda.empty_cache()
    return summary


# ------------------------------------------------------------ the serve phase
def drive_clients(srv, q_np: np.ndarray, tenants: np.ndarray):
    """``SERVE_CLIENTS`` closed-loop client threads, each with one request
    in flight, take the schedule in order; returns the served ids, each
    request's latency (submit to result) and the wall time."""
    import threading

    n = tenants.shape[0]
    ids = np.full((n, SERVE["result_k"]), -2, np.int32)
    lat = np.zeros(n)
    errs, lock, cursor = [], threading.Lock(), [0]

    def client():
        while True:
            with lock:
                i = cursor[0]
                if i >= n:
                    return
                cursor[0] += 1
            t0 = time.perf_counter()
            try:
                h = srv.submit(f"t{tenants[i]}", q_np[i], timeout=30.0)
                ids[i] = h.result(timeout=120.0)
            except Exception as e:  # noqa: BLE001 — every failure is reported below
                with lock:
                    errs.append((i, repr(e)))
                continue
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, name=f"serve-client-{k}", daemon=True)
               for k in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600.0)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a serve client hung")
    require(not errs, f"{len(errs)} requests failed, first {errs[:3]}")
    return ids, lat, wall


def serve_run(name: str, engine, cfg, q_np, tenants, cap, card: str) -> dict:
    """One front end over ``engine``: the schedule through it, its launches
    counted from 0, its report and timings."""
    rag = RAGServer(engine=engine, cfg=None, params=None,
                    passage_tokens=np.zeros((int(engine.codes.shape[0]), 4), np.int32),
                    search_config=cfg, bucket_sizes=SERVE_BUCKETS)
    specs = [TenantSpec(f"t{i}", "label", np.int32(i)) for i in range(SERVE_TENANTS)]
    torch.cuda.synchronize()
    _build.reset_launches()
    PLAIN_MERGES[0] = 0
    with ServeFrontend(rag, specs, max_batch=32, batch_window_s=0.002,
                       fault_policy="retry_then_degrade") as srv:
        ids, lat, wall = drive_clients(srv, q_np, tenants)
        rep = srv.io_report()
    cap.launches[name] = {**_build.LAUNCHES, "plain_merges": PLAIN_MERGES[0]}
    fused = cfg.use_fused_kernel
    require_launches(cap, name, ("pq_lookup", "rerank") + (("fused_traversal",) if fused else ()),
                     ("l2_dist", "plain_merges") + (() if fused else ("fused_traversal",)))
    n = tenants.shape[0]
    require(rep["completed"] == n and rep["failed"] == 0 and rep["rejected"] == 0
            and rep["deadline_shed"] == 0, f"{name}: not every request served: {rep}")
    out = {"qps": n / wall, "wall_s": wall, "p50_ms": float(np.percentile(lat, 50) * 1e3),
           "p99_ms": float(np.percentile(lat, 99) * 1e3),
           "spans_mean_ms": {k: v * 1e3 for k, v in rep["spans_mean_s"].items()},
           "mean_batch_size": rep["mean_batch_size"], "batches": rep["batches"],
           "padded_rows": rep.get("padded_rows", 0), "launches": cap.launches[name],
           **{k: rep[k] for k in ("slow_tier_reads", "cache_hits", "cache_hit_rate")}}
    for k in ("measured_slow_reads", "reconcile_drift", "cache_refreshes", "cache_partitions"):
        if k in rep:
            out[k] = rep[k]
    sp = out["spans_mean_ms"]
    log("serve", f"{name}: {n} requests by {SERVE_CLIENTS} clients: served QPS {out['qps']:.1f}, "
        f"request latency p50 {out['p50_ms']:.2f} ms p99 {out['p99_ms']:.2f} ms; mean spans "
        f"queue_wait {sp['queue_wait']:.2f} ms batch_form {sp['batch_form']:.3f} ms search "
        f"{sp['search']:.2f} ms; mean_batch_size {out['mean_batch_size']:.2f} over "
        f"{out['batches']} batches; slow-tier reads {out['slow_tier_reads']} cache hits "
        f"{out['cache_hits']}; launches {json.dumps(out['launches'])} on {card}")
    return {"ids": ids, "rag": rag, "summary": out}


def telemetry_batch(eng, q, targets, card: str, cap, reps: int = 7) -> dict:
    """One gate batch on the memory tier with telemetry off and on (the
    registry and the process tracer): the same kernel launches; off, the
    same device launches as the bare loop; both p50s, in turns."""
    cfg = SearchConfig(mode="gate", **SEARCH)
    kw = dict(filter_kind="label", filter_params=targets, search_config=cfg)
    on_reg = obs.MetricsRegistry(enabled=True)

    def search(on: bool):
        if not on:
            return eng.search(q, **kw)
        with obs.use_registry(on_reg):
            obs.trace.enable()
            try:
                return eng.search(q, **kw)
            finally:
                obs.trace.disable()

    launches, lat = {}, {False: [], True: []}
    for on in (False, True):
        _build.reset_launches()
        search(on)
        torch.cuda.synchronize()
        launches[on] = dict(_build.LAUNCHES)
        cap.launches["serve_telemetry_" + ("on" if on else "off")] = launches[on]
    require(launches[False] == launches[True],
            f"telemetry on changed the kernel launches: {launches[False]} vs {launches[True]}")
    # each count is the most of 3 profiles in turns: the profiler can drop a
    # run's events (one bare-loop profile once counted 17 launches fewer than
    # the same loop in the same process), never add any; beside it, every
    # device event by name, those of no measured time too, and the names
    # whose counts differ between the bare loop and telemetry off
    runs = {"off": lambda: search(False), "on": lambda: search(True),
            "bare_loop": lambda: bare_search(eng, q, "label", targets, cfg)}
    seen = {k: [] for k in runs}
    by_name = {k: [] for k in runs}
    for _ in range(3):
        for k, run in runs.items():
            timed, names = device_launches(run)
            seen[k].append(timed)
            by_name[k].append(names)
    dev = {k: max(v) for k, v in seen.items()}
    differ = []
    for i, (off, bare) in enumerate(zip(by_name["off"], by_name["bare_loop"])):
        d = {n: [off.get(n, 0), bare.get(n, 0)] for n in sorted(set(off) | set(bare))
             if off.get(n, 0) != bare.get(n, 0)}
        differ.append(d)
        log("serve", f"telemetry, profile {i + 1} of 3: device events by name, telemetry off vs the "
            f"bare loop: {sum(off.values())} vs {sum(bare.values())} (of measured time: "
            f"{seen['off'][i]} vs {seen['bare_loop'][i]}); names whose counts differ [off, bare]: "
            f"{json.dumps(d) if d else 'none'} on {card}")
    require(dev["off"] == dev["bare_loop"],
            f"telemetry off launches {dev['off']} on the device, the bare loop {dev['bare_loop']} "
            f"(profiles {seen})")
    for k in range(reps):  # off, on, on, off, ...
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search(on)
            torch.cuda.synchronize()
            lat[on].append(time.perf_counter() - t0)
    obs.trace.default_tracer().reset()
    out = {"kernel_launches": launches[False], "device_launches": dev, "device_profiles": seen,
           "names_differ_off_vs_bare": differ,
           "p50_off_ms": float(np.median(lat[False]) * 1e3),
           "p50_on_ms": float(np.median(lat[True]) * 1e3), "pairs": reps,
           "engine_search_spans": on_reg.histogram("trace.span_seconds", span="engine.search").count}
    log("serve", f"telemetry, one gate batch of {q.shape[0]} on the memory tier: kernel launches "
        f"off == on {json.dumps(launches[False])}; device launches off {dev['off']} == the bare "
        f"loop's {dev['bare_loop']}, on {dev['on']}; p50 off {out['p50_off_ms']:.2f} ms, on "
        f"{out['p50_on_ms']:.2f} ms ({reps} pairs in turns) on {card}")
    return out


def serve_phase(eng, path: str, q, targets, card: str, cap) -> dict:
    """Retrieval serving on the 1M index (the module docstring's serve
    step).  The direct reference is a fresh uncached disk engine's search
    of each tenant's queries; each served run must equal it bit for bit."""
    n = int(eng.codes.shape[0])
    q_np = q.cpu().numpy()
    probs = np.arange(1, SERVE_TENANTS + 1, dtype=np.float64) ** -SERVE_ALPHA
    tenants = np.random.default_rng(7).choice(SERVE_TENANTS, size=q_np.shape[0],
                                              p=probs / probs.sum())
    disk_cfg = SearchConfig(pipeline_depth=SERVE_DEPTH, **SERVE)
    budget = int(n * SERVE_CACHE_FRACTION) * record_nbytes(DIM, DEGREE)
    summary = {"tenant_requests": np.bincount(tenants, minlength=SERVE_TENANTS).tolist(),
               "cache_records": budget // record_nbytes(DIM, DEGREE)}
    log("serve", f"{SERVE_TENANTS} tenants (labels 0-{SERVE_TENANTS - 1}), requests by tenant "
        f"{summary['tenant_requests']} (Zipf {SERVE_ALPHA}); {SERVE}, depth {SERVE_DEPTH}, buckets "
        f"{SERVE_BUCKETS}; adaptive cache of {summary['cache_records']:,} records, refresh_every 4")

    # the direct reference: a fresh uncached disk engine, each tenant's queries
    fresh = GateANNEngine.load(path, store_tier="disk", max_gap_sectors=0)
    direct = np.full((q_np.shape[0], SERVE["result_k"]), -2, np.int32)
    lat = []
    for t in range(SERVE_TENANTS):
        rows = np.flatnonzero(tenants == t)
        for s in range(0, rows.size, BATCH):
            idx = rows[s:s + BATCH]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fresh.search(q_np[idx], filter_kind="label",
                               filter_params=np.full(idx.size, t, np.int32), search_config=disk_cfg)
            direct[idx] = out.ids.cpu().numpy()
            lat.append(time.perf_counter() - t0)
    fresh.measured_store().close()
    summary["direct_disk"] = {"qps": q_np.shape[0] / sum(lat), "batches": len(lat),
                              "p99_batch_ms": float(np.percentile(lat, 99) * 1e3)}
    log("serve", f"direct disk-tier search (no cache, depth {SERVE_DEPTH}, each tenant's queries in "
        f"batches of up to {BATCH}): QPS {summary['direct_disk']['qps']:.1f}, batch p99 "
        f"{summary['direct_disk']['p99_batch_ms']:.2f} ms over {len(lat)} batches on {card}")

    def disk_engine(faults=None):
        return GateANNEngine.load(path, store_tier="disk", max_gap_sectors=0,
                                  cache_budget_bytes=budget, cache_policy="adaptive",
                                  refresh_every=4, faults=faults)

    runs = {}
    for name, faults in (("serve_disk", None),
                         ("serve_disk_faults", FaultPlan(seed=11, p_eio=SERVE_EIO))):
        reg = obs.MetricsRegistry(enabled=True)
        with obs.use_registry(reg):  # the store captures it at load; the search reads it per call
            deng = disk_engine(faults)
            run = serve_run(name, deng, disk_cfg, q_np, tenants, cap, card)
        store, rag = deng.measured_store(), run["rag"]
        io = store.io_counters()
        same(torch.from_numpy(run["ids"]), torch.from_numpy(direct), f"{name}: served vs direct")
        reads = {"registry disk.records_read": reg.family_total("disk.records_read"),
                 "io_counters records_read": io["records_read"],
                 "registry search.ios{tier=disk}": reg.family_total("search.ios", tier="disk"),
                 "served + padding reads": rag.served_ios + rag.padding_ios}
        require(len(set(reads.values())) == 1, f"{name}: reads do not reconcile: {reads}")
        require(rag.reconcile_drift == 0 and io["abandoned_tokens"] == 0,
                f"{name}: drift {rag.reconcile_drift}, abandoned {io['abandoned_tokens']}")
        require(reg.family_total("disk.retried_ios") == io["retried_ios"],
                f"{name}: registry retried_ios {reg.family_total('disk.retried_ios')} vs "
                f"{io['retried_ios']}")
        run["summary"].update(records_read=io["records_read"], retried_ios=io["retried_ios"],
                              degraded_records=io["degraded_records"],
                              fault_counters=store.fault_counters())
        if faults is not None:
            require(io["retried_ios"] > 0, f"{name}: no read was retried")
            same(torch.from_numpy(run["ids"]), torch.from_numpy(runs["serve_disk"]["ids"]),
                 f"{name}: served vs the fault-free run")
        log("serve", f"{name}: every request served == direct search bit for bit; reads "
            f"{json.dumps(reads)}; drift 0; retried_ios {io['retried_ios']} (registry == store), "
            f"degraded {io['degraded_records']}, faults {json.dumps(store.fault_counters())}")
        store.close()
        runs[name] = run
        del deng
    for name, fused in (("serve_mem_unfused", False), ("serve_mem_fused", True)):
        runs[name] = serve_run(name, eng, SearchConfig(use_fused_kernel=fused, **SERVE),
                               q_np, tenants, cap, card)
        same(torch.from_numpy(runs[name]["ids"]), torch.from_numpy(direct),
             f"{name}: served vs direct")
        log("serve", f"{name}: every request served == direct search bit for bit")
    summary.update({name: run["summary"] for name, run in runs.items()})
    summary["telemetry"] = telemetry_batch(eng, q[:BATCH], targets[:BATCH], card, cap)
    print(json.dumps({"serve": summary, "card": card}), flush=True)
    return summary


# --------------------------------------------------------------- the lm phase
def lm_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def lm_decode(model, prompts: torch.Tensor, new: int, cache_dtype):
    """Teacher-forced prompt, then ``new`` greedy tokens fed back, one
    ``forward_decode`` a position (``RAGServer.generate``'s loop without
    the retrieval); returns the tokens and every step's last logits."""
    b, p_len = prompts.shape
    caches = model.init_caches(b, p_len + new, cache_dtype)
    tok, toks, steps = prompts[:, :1], [], []
    for t in range(p_len + new - 1):
        logits, caches = model.forward_decode(tok, caches, t)
        steps.append(logits[:, 0])
        if t + 1 < p_len:
            tok = prompts[:, t + 1:t + 2]
        else:
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
            toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), torch.stack(steps, dim=1)


def lm_decode_vs_forward(phase: str, cfg, dev, card: str, what: str) -> dict:
    """(a) the cached decode against the full forward of the float32
    model of ``cfg`` at full width: every position's logits of a
    teacher-forced decode of LM_PARITY_BT tokens against the full
    forward's, within rtol = atol = 2e-3."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    model = zoo.init_params(f32, torch.Generator("cuda").manual_seed(0), device=dev)
    b, t = LM_PARITY_BT
    toks = torch.from_numpy(batch_at_step(TokenStreamConfig(cfg.vocab_size, t, b, seed=2), 0)
                            ["tokens"]).to(dev)
    hidden, _ = model.forward_hidden(toks)
    with torch.inference_mode():
        full = model.logits(hidden)
    _, dec = lm_decode(model, toks, 1, torch.float32)  # the prompt's logits, step by step
    err = float((dec - full[:, :t]).abs().max())
    require(bool(torch.allclose(dec, full[:, :t], rtol=2e-3, atol=2e-3)),
            f"{phase} (a) {cfg.name}: decode vs full forward max |err| {err}")
    log(phase, f"(a) {cfg.name} float32 at full width ({cfg.n_layers} layers), B={b} T={t}: "
        f"teacher-forced forward_decode == the full forward's logits at every position within "
        f"rtol = atol = 2e-3 (max |err| {err:.3g}; {what}) on {card}")
    del model, hidden, full, dec
    torch.cuda.empty_cache()
    return {"a_decode_vs_forward_max_abs_err": err}


def lm_card_vs_cpu(phase: str, cut, dev, card: str, prompt: int, new: int,
                   prefill_t: int = 0, prepare=None, what: str = "") -> dict:
    """(b) the card against the CPU on the float32 model ``cut`` (a config
    at full width with its depth cut): the weights drawn on the card and
    copied to the CPU, then ``prepare(model)`` on both when given (w8a16
    quantisation); a prefill of (2, ``prefill_t``) tokens when given
    (logits within rtol = atol = 1e-4), then a ``prompt``-token prompt
    and ``new`` greedy tokens through decode (logits within 1e-4, tokens
    equal up to the first step where the CPU's top-2 logits are within
    1e-3)."""
    on_card = zoo.init_params(cut, torch.Generator("cuda").manual_seed(0), device=dev)
    on_cpu = Transformer(cut, device="cpu")
    with torch.no_grad():
        for pc, pg in zip(on_cpu.parameters(), on_card.parameters()):
            pc.copy_(pg)
    if prepare is not None:
        prepare(on_card)
        prepare(on_cpu)
    out = {}
    t0 = time.perf_counter()
    if prefill_t:
        toks = batch_at_step(TokenStreamConfig(cut.vocab_size, prefill_t, 2, seed=4), 0)["tokens"]
        c_pre, _ = on_cpu.forward_prefill(torch.from_numpy(toks))
        g_pre, _ = on_card.forward_prefill(torch.from_numpy(toks).to(dev))
        err = float((g_pre.cpu() - c_pre).abs().max())
        require(bool(torch.allclose(g_pre.cpu(), c_pre, rtol=1e-4, atol=1e-4)),
                f"{phase} (b) {cut.name}: card vs CPU prefill logits max |err| {err}")
        out["b_prefill_max_abs_err"] = err
    prompts = batch_at_step(TokenStreamConfig(cut.vocab_size, prompt, 2, seed=3), 0)["tokens"]
    c_tok, c_log = lm_decode(on_cpu, torch.from_numpy(prompts), new, torch.float32)
    cpu_s = time.perf_counter() - t0
    g_tok, g_log = lm_decode(on_card, torch.from_numpy(prompts).to(dev), new, torch.float32)
    g_tok, g_log = g_tok.cpu(), g_log.cpu()
    top2 = torch.topk(c_log[:, prompt - 1:], 2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).min(dim=0).values  # the closest row a step
    close_step = next((i for i, g in enumerate(gaps.tolist()) if g < 1e-3), None)
    # tokens up to that step must be equal; logits up to and with it (the
    # inputs are the same until a token differs)
    upto = new if close_step is None else close_step
    same(g_tok[:, :upto], c_tok[:, :upto], f"{phase} (b) {cut.name}: card vs CPU greedy tokens")
    n_log = prompt - 1 + min(upto + 1, new)
    err = float((g_log[:, :n_log] - c_log[:, :n_log]).abs().max())
    require(bool(torch.allclose(g_log[:, :n_log], c_log[:, :n_log], rtol=1e-4, atol=1e-4)),
            f"{phase} (b) {cut.name}: card vs CPU logits max |err| {err}")
    out.update(b_card_vs_cpu_max_abs_err=err, b_tokens_equal_steps=upto, b_close_step=close_step,
               b_min_top2_gap=float(gaps.min()), b_cpu_s=cpu_s)
    pre = (f"prefill B=2 T={prefill_t} logits within rtol = atol = 1e-4 (max |err| "
           f"{out['b_prefill_max_abs_err']:.3g}); " if prefill_t else "")
    log(phase, f"(b) {cut.name}{f' {what}' if what else ''}: card == CPU at full width, "
        f"{cut.n_layers} layers, float32: {pre}"
        f"B=2, a {prompt}-token prompt then {new} greedy tokens: logits within rtol = atol = "
        f"1e-4 (max |err| {err:.3g}), tokens equal for {upto} steps; first step with the CPU's "
        f"top-2 gap under 1e-3: {close_step} (smallest gap {float(gaps.min()):.3g}); the CPU "
        f"took {cpu_s:.1f} s; on {card}")
    del on_card
    torch.cuda.empty_cache()
    return out


def lm_invariants(cfg, dev, card: str) -> dict:
    """(a) the decode path against the full forward at full width in
    float32; (b) the card against the CPU at full width, depth cut to one
    pattern unit, float32."""
    out = lm_decode_vs_forward("lm", cfg, dev, card, "T < window 1024, so this holds the "
                               "global/local split")
    cut = dataclasses.replace(cfg, dtype="float32", n_layers=len(cfg.pattern_unit))
    log("lm", f"CUT: (b) runs {cfg.name} at full width with the depth cut from {cfg.n_layers} to "
        f"{cut.n_layers} layers (one pattern unit, {cut.param_count():,} params, "
        f"{cut.param_count() * 4 / 1e9:.1f} GB in float32) so that the CPU run takes seconds")
    out.update(lm_card_vs_cpu("lm", cut, dev, card, LM_CPU_PROMPT, LM_CPU_NEW))
    return out


def lm_ops(cfg, n_params: int, b: int, t: int) -> dict:
    """The operations of a full-sequence forward of (b, t) tokens, for its
    bound: the products of every weight a token uses (the routed experts'
    k of E; the embedding gather none) at the bf16 rate; the attention
    scores and PV products, the mLSTM's (T, T) products and the sLSTM's
    recurrent products in float32."""
    d, v = cfg.d_model, cfg.vocab_size
    kinds = cfg.layer_kinds
    idle = kinds.count("moe") * (cfg.n_experts - cfg.moe_top_k) * 3 * d * cfg.moe_d_ff
    lin = 2 * b * t * (n_params - v * d * (1 if cfg.tie_embeddings else 2) - idle)
    attn = (kinds.count("attn") + kinds.count("moe")) * 4 * b * cfg.n_heads * t * t * cfg.head_dim
    mlstm = kinds.count("mlstm") * 2 * b * cfg.n_heads * t * t * (cfg.head_dim + 2 * d // cfg.n_heads)
    dh = d // cfg.n_heads
    slstm = kinds.count("slstm") * 2 * b * t * cfg.n_heads * dh * 4 * dh
    f32 = attn + mlstm + slstm
    return {"linear_ops": lin, "float32_ops": f32,
            "bound_s": lin / BF16_OPS_PER_S + f32 / FP32_OPS_PER_S}


def lm_prefill_run(phase: str, model, cfg, n_params: int, b: int, t: int, card: str,
                   warm_t: int | None = None) -> tuple:
    """``make_prefill_step`` at (b, t), timed after one warm-up call (at
    ``warm_t`` tokens when given, else the same batch).  Returns (the
    readings, the batch)."""
    batch = batch_at_step(TokenStreamConfig(cfg.vocab_size, t, b, seed=0), 0)
    prefill = make_prefill_step(cfg)
    warm = {"tokens": batch["tokens"][:, :warm_t]} if warm_t else batch
    for run in (warm, batch):  # the first call warms cuBLAS up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prefill(model, run)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    logits, kv = res["logits"], res["caches"]
    n_attn = sum(k in ("attn", "moe") for k in cfg.layer_kinds)
    require(logits.shape == (b, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
            f"{phase} prefill: logits {tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())}")
    require(len(kv) == n_attn and all(k.shape == (b, t, cfg.n_kv_heads, cfg.head_dim)
                                      and k.dtype == torch.bfloat16 for k, _ in kv),
            f"{phase} prefill: caches")
    ops = lm_ops(cfg, n_params, b, t)
    out = {"B": b, "T": t, "s": secs, "tokens_per_s": b * t / secs, **ops}
    log(phase, f"{cfg.name} prefill B={b} T={t} (make_prefill_step): {secs:.3f} s, "
        f"{b * t / secs:,.0f} tokens/s; bound {ops['bound_s']:.3f} s = "
        f"{ops['linear_ops'] / 1e12:.1f} TFLOP of products over 989 TFLOP/s bf16 + "
        f"{ops['float32_ops'] / 1e12:.2f} TFLOP of attention / mLSTM / sLSTM products in "
        f"float32 over 67 TFLOP/s; KV of {n_attn} attention layers "
        f"{sum(k.numel() + v.numel() for k, v in kv) * 2 / 1e9:.2f} GB, on {card}")
    return out, batch


def lm_decode_run(phase: str, model, cfg, n_params: int, first: np.ndarray, card: str,
                  on_step=None) -> dict:
    """``make_serve_step`` at LM_DECODE's (B, cache length, steps) with
    bf16 caches, each step timed; one more step profiled.  ``on_step`` is
    called after the timed steps with (step, caches, tokens, pos)."""
    b, length, n_steps = LM_DECODE
    step = make_serve_step(cfg)
    caches = model.init_caches(b, length, torch.bfloat16)
    tok = torch.from_numpy(first[:b, :1]).to(model.device)
    lat = []
    for pos in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(model, caches, tok, pos)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        caches, tok = res["caches"], res["next_tokens"]
    require(bool(torch.isfinite(res["logits"]).all()), f"{phase} decode: logits not finite")
    bf16_weights = n_params * 2
    # what each step's per-call casts move: a linear reads its float32 master,
    # writes the bf16 copy and the product reads it back (4 + 2 + 2 bytes a
    # param); the unembedding is cast to bf16 and back to float32 for the
    # float32-output product (4 + 2 + 2 + 4 + 4)
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    cast_bytes = 8 * (n_params - embed) + 16 * cfg.vocab_size * cfg.d_model
    lat_ms = np.asarray(lat[1:]) * 1e3  # the first step warms up
    d = {"B": b, "cache_len": length, "steps": n_steps,
         "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
         "bound_ms": bf16_weights / HBM_BYTES_PER_S * 1e3, "cast_bytes_per_step": cast_bytes,
         "cast_bound_ms": cast_bytes / HBM_BYTES_PER_S * 1e3}
    if on_step is not None:
        on_step(step, caches, tok, n_steps)
    d["profile"] = profile_batch(lambda: step(model, caches, tok, n_steps + 1), d["p50_ms"], top=6)
    require(d["profile"]["device_busy_ms"] > 0, f"{phase} decode: the profiler saw no device time")
    log(phase, f"{cfg.name} decode step profiled: device busy {d['profile']['device_busy_ms']:.2f} "
        f"ms of the p50 (share {d['profile']['device_busy_share']:.3f}), "
        f"{d['profile']['device_launches']} launches; top kernels "
        f"{json.dumps(d['profile']['top_kernels_ms_calls'])} on {card}")
    log(phase, f"{cfg.name} decode B={b}, bf16 caches of {length} (make_serve_step), {n_steps} "
        f"steps: p50 {d['p50_ms']:.2f} ms p99 {d['p99_ms']:.2f} ms a step; byte bound "
        f"{d['bound_ms']:.2f} ms ({bf16_weights / 1e9:.2f} GB of bf16 weights over 3.35 TB/s); "
        f"the per-call casts from the float32 masters move {cast_bytes / 1e9:.1f} GB a step "
        f"({d['cast_bound_ms']:.2f} ms at 3.35 TB/s) on {card}")
    return d


def lm_generate(phase: str, path: str, eng, q, targets, cfg, card: str, cap: Capture) -> dict:
    """``RAGServer.generate`` of LM_REQUESTS labelled requests on the 1M
    index: its retrieved ids and stats equal a direct search bit for bit;
    its kernel launches counted under ``path``; one decode step (float32
    caches) profiled.  The model is ``cfg``'s at full width with its depth
    cut to LM_GENERATE_DEPTH, drawn from the phase's seed (so its layers
    are the full model's first)."""
    dev = eng.device
    depth = LM_GENERATE_DEPTH[cfg.name]
    log(phase, f"CUT: generate runs {cfg.name} at full width with its depth cut from "
        f"{cfg.n_layers} to {depth} layers, for the whole smoke's time (PERF.md)")
    cfg = dataclasses.replace(cfg, n_layers=depth)
    model = zoo.init_params(cfg, torch.Generator("cuda").manual_seed(0), device=dev)
    n = int(eng.codes.shape[0])
    passages = np.random.default_rng(5).integers(0, cfg.vocab_size, (n, LM_PASSAGE)).astype(np.int32)
    search = SearchConfig(mode="gate", **SEARCH)
    srv = RAGServer(engine=eng, cfg=cfg, params=model, passage_tokens=passages,
                    search_config=search)
    rng = np.random.default_rng(6)
    q_np, t_np = q[:LM_REQUESTS].cpu().numpy(), targets[:LM_REQUESTS].cpu().numpy()
    reqs = [RAGRequest(query_vec=q_np[i], prompt_tokens=rng.integers(0, cfg.vocab_size, LM_PROMPT)
                       .astype(np.int32), filter_kind="label", filter_params=t_np[i])
            for i in range(LM_REQUESTS)]
    seen, retrieve = {}, srv.retrieve

    def timed_retrieve(requests):
        t0 = time.perf_counter()
        ids, stats = retrieve(requests)
        seen.update(ids=ids, ms=(time.perf_counter() - t0) * 1e3)
        return ids, stats

    srv.retrieve = timed_retrieve
    torch.cuda.synchronize()
    _build.reset_launches()
    PLAIN_MERGES[0] = 0
    t0 = time.perf_counter()
    toks, stats = srv.generate(reqs, max_new_tokens=LM_NEW)
    total_s = time.perf_counter() - t0
    # the wrapper holds srv's bound method: a cycle through srv that would
    # keep the model alive after this function until the garbage collector runs
    del srv.retrieve
    cap.launches[path] = {**_build.LAUNCHES, "plain_merges": PLAIN_MERGES[0]}
    require_launches(cap, path, ("pq_lookup", "rerank"), ("l2_dist", "plain_merges", "fused_traversal"))
    require(toks.shape == (LM_REQUESTS, LM_NEW) and toks.dtype == np.int32
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size, f"{phase} generate: {toks}")
    direct = eng.search(q[:LM_REQUESTS], filter_kind="label", filter_params=targets[:LM_REQUESTS],
                        search_config=search)
    same(torch.from_numpy(seen["ids"]), direct.ids[:, :search.result_k].cpu(),
         f"{phase} generate: retrieved vs direct search ids")
    for f in direct.stats._fields:
        same(getattr(stats, f), getattr(direct.stats, f).cpu(), f"{phase} generate: {f} vs direct")
    p_len = LM_PASSAGE * search.result_k + LM_PROMPT
    n_dec = p_len + LM_NEW - 1
    decode_ms = (total_s * 1e3 - seen["ms"]) / n_dec
    g = {"requests": LM_REQUESTS, "prompt_len": p_len, "new": LM_NEW, "decode_steps": n_dec,
         "retrieve_ms": seen["ms"], "decode_ms_per_step": decode_ms, "total_s": total_s,
         "launches": cap.launches[path]}
    log(phase, f"{cfg.name} RAGServer.generate, {LM_REQUESTS} requests (gate L={SEARCH['search_l']} "
        f"W={SEARCH['beam_width']} K={search.result_k}, a label filter each, {LM_PASSAGE}-token "
        f"passages, {LM_PROMPT}-token prompts, {LM_NEW} new tokens): retrieved ids == a direct "
        f"engine.search bit for bit; retrieve {seen['ms']:.1f} ms, {n_dec} decode steps at "
        f"{decode_ms:.2f} ms a step (float32 caches: float32 from the first attention layer on), "
        f"{total_s:.2f} s in all; launches {json.dumps(cap.launches[path])} on {card}")
    f32_caches = model.init_caches(LM_REQUESTS, p_len + LM_NEW, torch.float32)
    g["profile"] = profile_batch(
        lambda: model.forward_decode(torch.from_numpy(toks[:, :1]).to(dev), f32_caches, p_len),
        decode_ms, top=6)
    require(g["profile"]["device_busy_ms"] > 0, f"{phase} generate: the profiler saw no device time")
    log(phase, f"{cfg.name} generate's decode step (float32 caches) profiled: device busy "
        f"{g['profile']['device_busy_ms']:.2f} ms of {decode_ms:.2f} ms (share "
        f"{g['profile']['device_busy_share']:.3f}), {g['profile']['device_launches']} launches; "
        f"top kernels {json.dumps(g['profile']['top_kernels_ms_calls'])} on {card}")
    return g


def lm_init(phase: str, cfg, dev, card: str, want_params: int | None = None):
    """The model of ``cfg`` on the card from ``torch.Generator("cuda")``
    seeded 0; its parameter count checked against ``want_params`` (default
    ``cfg.param_count()``)."""
    t0 = time.perf_counter()
    model = zoo.init_params(cfg, torch.Generator("cuda").manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    want = cfg.param_count() if want_params is None else want_params
    require(n_params == want, f"{phase} {cfg.name}: {n_params:,} params, {want:,} expected")
    out = {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers, "params": n_params,
           "param_count": cfg.param_count(), "device_bytes": lm_bytes(model), "init_s": init_s}
    log(phase, f"{cfg.name} at full width ({cfg.n_layers} layers {'/'.join(cfg.pattern_unit)}, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, vocab "
        f"{cfg.vocab_size:,}), {cfg.dtype} activations over float32 masters, random init from "
        f"torch.Generator('cuda').manual_seed(0): {n_params:,} params (param_count() "
        f"{cfg.param_count():,}), {out['device_bytes'] / 1e9:.2f} GB on the card, in {init_s:.1f} s")
    return model, n_params, out


def lm_phase(eng, q, targets, card: str, cap: Capture, ref_dir: str) -> dict:
    """The LM serving path at full width (the module docstring's lm step);
    the dist_serve phase's gemma3-4b references saved under ``ref_dir``."""
    dev = eng.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model, n_params, out = lm_init("lm", cfg, dev, card)
    out["prefill"], batch = lm_prefill_run("lm", model, cfg, n_params, *LM_PREFILL, card)
    out["decode"] = lm_decode_run("lm", model, cfg, n_params, batch["tokens"], card)
    out["generate"] = lm_generate("lm", "rag_generate", eng, q, targets, cfg, card, cap)
    with first_layers(model, DIST_SERVE_GEMMA_DEPTH):
        out.update(dist_serve_refs_gemma(model, model.cfg, ref_dir, card))
    del model
    torch.cuda.empty_cache()

    out.update(lm_invariants(cfg, dev, card))
    out["peak_allocated_gb"] = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    log("lm", f"phase {out['phase_s']:.1f} s; peak device memory allocated {out['peak_allocated_gb']:.2f}"
        f" GB above the {base_bytes / 1e9:.2f} GB held before the phase, on {card}")
    print(json.dumps({"lm": out, "card": card}), flush=True)
    return out


# ---------------------------------------------------------- the lm_kinds phase
@contextlib.contextmanager
def routings(model):
    """While the block runs, every MoE layer's ``route_logits`` appends its
    ``Routing`` to the yielded list."""
    seen, moes = [], [layer.moe for layer in model.layers if getattr(layer, "moe", None) is not None]
    for moe in moes:
        def route(logits, real=moe.route_logits):
            seen.append(real(logits))
            return seen[-1]
        moe.route_logits = route
    try:
        yield seen
    finally:
        for moe in moes:
            del moe.route_logits


def moe_drops(model, run) -> dict:
    """``run()`` with every MoE layer's routing kept: its capacity, the
    token-expert pairs routed and those dropped past capacity."""
    with routings(model) as seen:
        run()
    return {"capacity": seen[0].capacity, "layers": len(seen),
            "pairs": sum(r.kept.numel() for r in seen),
            "dropped": sum(int((~r.kept).sum()) for r in seen)}


def kept_pairs(seen: list) -> list:
    """Each routing's kept pairs: its experts, -1 where a pair drops."""
    return [torch.where(r.kept, r.experts, -1).cpu() for r in seen]


def lm_kinds_prefill_t(model, cfg, card: str) -> tuple[int, dict]:
    """Prefill's T for ``cfg`` and, for a config with sLSTM layers, its scan's
    launches: LM_PREFILL's T, cut when the eager scan (time linear in T)
    would take more than LM_KINDS_PREFILL_CAP_S, estimated from a prefill
    at T = 64; the device launches a scan step, from the profiled launches
    of prefills at T = 32 and 64 (the rest of the forward launches as many
    kernels at any T)."""
    b, t = LM_PREFILL
    if "slstm" not in cfg.layer_kinds:
        return t, {}
    step = make_prefill_step(cfg)

    def tokens(n):
        return {"tokens": batch_at_step(TokenStreamConfig(cfg.vocab_size, n, b, seed=0), 0)["tokens"]}

    for _ in range(2):  # the second call, after cuBLAS's warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, tokens(64))
        torch.cuda.synchronize()
        s64 = time.perf_counter() - t0
    n_slstm = cfg.layer_kinds.count("slstm")
    l32, l64 = (device_launches(lambda n=n: step(model, tokens(n)))[0] for n in (32, 64))
    require(l64 > l32 > 0, f"lm_kinds {cfg.name}: prefill launches at T = 32 / 64: {l32} / {l64}")
    per_step = (l64 - l32) / (32 * n_slstm)
    est = s64 * t / 64
    out = {"slstm_steps": n_slstm * t, "slstm_launches_per_step": per_step,
           "slstm_launches": round(per_step * n_slstm * t), "launches_t64": l64}
    log("lm_kinds", f"{cfg.name}: the sLSTM scan runs {n_slstm} layers x T eager steps "
        f"({n_slstm * t:,} steps at T = {t}) of {per_step:.1f} device launches each "
        f"(profiled prefills at T = 32 and 64: {l32:,} and {l64:,} launches), so "
        f"{out['slstm_launches']:,} launches at T = {t}; prefill at T = 64 took {s64:.3f} s, "
        f"so T = {t} would take about {est:.1f} s on {card}")
    if est <= LM_KINDS_PREFILL_CAP_S:
        return t, out
    cut = max(64, int(LM_KINDS_PREFILL_CAP_S / s64 * 64) // 64 * 64)
    log("lm_kinds", f"CUT: {cfg.name} prefill T cut from {t} to {cut} (the estimate passes "
        f"{LM_KINDS_PREFILL_CAP_S:.0f} s)")
    out["slstm_steps"] = n_slstm * cut
    out["slstm_launches"] = round(per_step * n_slstm * cut)
    return cut, out


def lm_kinds_model(arch: str, depth, want: int, eng, q, targets, card: str, cap: Capture,
                   ref_dir: str) -> dict:
    """One config of the lm_kinds phase at full width (depth cut to
    ``depth`` layers when given): prefill, decode, ``generate`` for the
    hybrid model, the dist_serve phase's references, then invariants (a)
    and (b)."""
    dev = eng.device
    cfg = get_config(arch)
    if depth:
        whole = cfg.param_count() * 4 / 1e9
        why = (f"all {cfg.n_layers} would hold {whole:.0f} GB, past one card" if whole > 80
               else "for the whole smoke's time (PERF.md)")
        log("lm_kinds", f"CUT: {arch} runs at full width with its depth cut from {cfg.n_layers} to "
            f"{depth} layers ({want * 4 / 1e9:.2f} GB of float32 masters; {why})")
        cfg = dataclasses.replace(cfg, n_layers=depth)
    model, n_params, out = lm_init("lm_kinds", cfg, dev, card, want)
    if n_params != cfg.param_count():
        log("lm_kinds", f"{arch}: {n_params:,} params = the reference's init_model tree; its "
            f"param_count() formula gives {cfg.param_count():,} "
            f"({n_params - cfg.param_count():+,})")
    b, _ = LM_PREFILL
    t, scan = lm_kinds_prefill_t(model, cfg, card)
    out["prefill"], batch = lm_prefill_run("lm_kinds", model, cfg, n_params, b, t, card, warm_t=64)
    out["prefill"].update(scan)
    drops = {}

    def count_drops(step, caches, tok, pos):
        if "moe" in cfg.layer_kinds:
            drops.update(moe_drops(model, lambda: step(model, caches, tok, pos)))

    out["decode"] = lm_decode_run("lm_kinds", model, cfg, n_params, batch["tokens"], card, count_drops)
    if drops:
        out["decode"]["moe"] = drops
        log("lm_kinds", f"{arch} decode MoE: the whole batch is one group, so B = {LM_DECODE[0]}, "
            f"k = {cfg.moe_top_k}, E = {cfg.n_experts} give capacity {drops['capacity']} an expert; "
            f"one step routed {drops['pairs']} token-expert pairs over {drops['layers']} layers "
            f"and dropped {drops['dropped']} past capacity; every expert's products run over its "
            f"{drops['capacity']} slots, so each step reads every expert's weights, on {card}")
    if arch == LM_KINDS_GENERATE:
        out["generate"] = lm_generate("lm_kinds", "rag_generate_hybrid", eng, q, targets, cfg,
                                      card, cap)
    if arch in DIST_SERVE_KINDS:
        out.update(dist_serve_refs_kind(model, cfg, ref_dir, card))
    del model, batch
    torch.cuda.empty_cache()
    a_cfg, what = cfg, "T < the window, so this holds the windowed layers whole"
    if "moe" in cfg.layer_kinds:
        # capacity = the group's size in both groupings: nothing drops, where
        # the reference's decode (the batch a group, capacity 1 at B = 2)
        # drops other pairs than its full forward (a sequence a group)
        a_cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
        what = (f"capacity_factor {a_cfg.capacity_factor:g} so that no pair drops in either "
                "grouping")
    elif "rglru" not in cfg.layer_kinds:
        what = "the mLSTM's parallel form against its recurrent one, the sLSTM's scan against its steps"
    out.update(lm_decode_vs_forward("lm_kinds", a_cfg, dev, card, what))
    n_cut = LM_KINDS_CPU_LAYERS[arch]
    cut = dataclasses.replace(cfg, dtype="float32", n_layers=n_cut)
    log("lm_kinds", f"CUT: (b) runs {arch} at full width with the depth cut to {n_cut} layers "
        f"({'/'.join(cut.layer_kinds)}) so that the CPU run takes seconds")
    out.update(lm_card_vs_cpu("lm_kinds", cut, dev, card, *LM_KINDS_CPU))
    return out


def lm_kinds_smoke(dev, card: str) -> dict:
    """(c) the smoke configs of the layer kinds, card against CPU (float32)."""
    out = {}
    for arch in LM_KINDS_SMOKE:
        out[arch] = lm_smoke_card_vs_cpu(dev, arch)
        log("lm_kinds", f"(c) {arch} smoke config, float32: card == CPU (prefill logits and KV, "
            f"16 greedy decode steps: tokens equal, logits within rtol 1e-5 and atol 1e-5 of the "
            f"largest magnitude; max |err| {out[arch]:.3g}) on {card}")
    return out


def lm_kinds_phase(eng, q, targets, card: str, cap: Capture, ref_dir: str) -> dict:
    """The MoE, RG-LRU and xLSTM layer kinds at full width (the module
    docstring's lm_kinds step)."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()
    out = {arch: lm_kinds_model(arch, depth, want, eng, q, targets, card, cap, ref_dir)
           for arch, depth, want in LM_KINDS}
    out["smoke_card_vs_cpu_max_abs_err"] = lm_kinds_smoke(eng.device, card)
    out["peak_allocated_gb"] = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    log("lm_kinds", f"phase {out['phase_s']:.1f} s; peak device memory allocated "
        f"{out['peak_allocated_gb']:.2f} GB above the {base_bytes / 1e9:.2f} GB held before the "
        f"phase, on {card}")
    print(json.dumps({"lm_kinds": out, "card": card}), flush=True)
    return out


# ------------------------------------------------------- the lm_variants phase
@contextlib.contextmanager
def kv_int8(on: bool):
    """``REPRO_KV_INT8`` set to ``on`` while caches are made, then restored."""
    old = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_KV_INT8"]
        else:
            os.environ["REPRO_KV_INT8"] = old


def tensor_bytes(model) -> int:
    """The model's parameters and buffers (the w8a16 codes and scales)."""
    return sum(t.numel() * t.element_size() for t in (*model.parameters(), *model.buffers()))


def variant_bytes(model, cfg, b: int, length: int, kv8: bool) -> dict:
    """A decode step's bytes by count, beside two bounds.  Moved: a float32
    linear's master is read, cast to bf16 and read by the product (4 + 2 +
    2 bytes a weight); a w8a16 linear's codes are read, written as bf16,
    read and written by the scale multiply and read by the product (1 + 2
    + 2 + 2 + 2); the unembedding is cast to bf16 and to float32 for its
    float32-output product (4 + 2 + 2 + 4 + 4); a bf16 cache element is
    read once (2), an int8 one dequantised as the codes are (1 + 2 + 2 + 2
    + 2).  Bounds: every weight in bf16 and the bf16 cache, each read
    once; and every linear weight at 1 byte (with its float32 scales), the
    rest in bf16, the cache at 1 byte (with its float32 scales) when int8."""
    lin_f = lin_q = scales = 0
    for m in model.modules():
        if isinstance(m, Linear):
            if m.w is None:
                lin_q += m.w_q.numel()
                scales += m.w_s.numel()
            else:
                lin_f += m.w.numel()
    n_weights = sum(p.numel() for p in model.parameters()) + lin_q
    vd = cfg.vocab_size * cfg.d_model
    other = n_weights - lin_f - lin_q  # the embeddings and the norms
    kv_elems = sum(2 * b * (min(w, length) if w else length) * cfg.n_kv_heads * cfg.head_dim
                   for kind, w in zip(cfg.layer_kinds, cfg.layer_windows) if kind in ("attn", "moe"))
    kv_scales = kv_elems // cfg.head_dim
    moved = 8 * lin_f + 9 * lin_q + 16 * vd + (9 if kv8 else 2) * kv_elems
    bf16 = 2 * n_weights + 2 * kv_elems
    one = (lin_f + lin_q) + 4 * scales + 2 * other + (kv_elems + 4 * kv_scales if kv8 else 2 * kv_elems)
    return {"moved_bytes": moved, "moved_ms": moved / HBM_BYTES_PER_S * 1e3,
            "bound_bf16_ms": bf16 / HBM_BYTES_PER_S * 1e3,
            "bound_1byte_ms": one / HBM_BYTES_PER_S * 1e3, "kv_elements": kv_elems,
            "linear_weights": lin_f + lin_q}


def variant_model(cfg, dev, w8: bool):
    """``cfg``'s model from ``torch.Generator(dev)`` seeded 0, quantised
    layer by layer when ``w8``."""
    model = zoo.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    return quantize_model(model) if w8 else model


def variant_decode(name: str, w8: bool, kv8: bool, cfg, n_params: int, card: str) -> dict:
    """One decode run of gemma3-4b at full width (LM_DECODE: B = 8, caches
    of 2,112 asked for in bf16, 64 steps) with the variant on: p50 / p99,
    bytes a step by count beside the bounds, one step profiled, device
    bytes."""
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = variant_model(cfg, dev, w8)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    n = sum(p.numel() for p in model.parameters()) + sum(
        m.w_q.numel() for m in model.modules() if isinstance(m, Linear) and m.w is None)
    require(n == n_params, f"lm_variants {name}: {n:,} weights, {n_params:,} expected")
    b, length, n_steps = LM_DECODE
    step = make_serve_step(cfg)
    with kv_int8(kv8):
        caches = model.init_caches(b, length, torch.bfloat16)
    require(("k_q" in caches[0]) == kv8, f"lm_variants {name}: cache keys {sorted(caches[0])}")
    tok = torch.from_numpy(batch_at_step(TokenStreamConfig(cfg.vocab_size, 1, b, seed=0), 0)
                           ["tokens"]).to(dev)
    lat = []
    for pos in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(model, caches, tok, pos)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        tok = res["next_tokens"]
    require(bool(torch.isfinite(res["logits"]).all()), f"lm_variants {name}: logits not finite")
    lat_ms = np.asarray(lat[1:]) * 1e3  # the first step warms up
    d = {"w8a16": w8, "int8_kv": kv8, "build_s": build_s, "device_bytes": tensor_bytes(model),
         "cache_bytes": sum(t.numel() * t.element_size() for c in caches for t in c.values()),
         "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
         **variant_bytes(model, cfg, b, length, kv8)}
    d["profile"] = profile_batch(lambda: step(model, caches, tok, n_steps), d["p50_ms"], top=6)
    require(d["profile"]["device_busy_ms"] > 0, f"lm_variants {name}: the profiler saw no device time")
    log("lm_variants", f"{cfg.name} {name} decode B={b}, caches of {length} ({'int8 + float32 scales' if kv8 else 'bf16'}), "
        f"{n_steps} steps: p50 {d['p50_ms']:.2f} ms p99 {d['p99_ms']:.2f} ms; by count a step moves "
        f"{d['moved_bytes'] / 1e9:.1f} GB ({d['moved_ms']:.2f} ms at 3.35 TB/s); bounds: bf16 "
        f"weights and cache {d['bound_bf16_ms']:.2f} ms, 1 byte a linear weight{' and a cache element' if kv8 else ''} "
        f"{d['bound_1byte_ms']:.2f} ms; weights on the card {d['device_bytes'] / 1e9:.2f} GB"
        f"{f' (quantised in {build_s:.1f} s with the init)' if w8 else ''}, caches "
        f"{d['cache_bytes'] / 1e9:.2f} GB; one step profiled: {d['profile']['device_busy_ms']:.2f} "
        f"ms of kernels, {d['profile']['device_launches']} launches, busy "
        f"{d['profile']['device_busy_share']:.3f}; top {json.dumps(d['profile']['top_kernels_ms_calls'])} "
        f"on {card}")
    del model, caches, res, step
    torch.cuda.empty_cache()
    return d


def variant_checks(cfg, card: str) -> dict:
    """Each variant against the float32 model's cached decode at full width
    cut to LM_VARIANTS_CHECK's depth (the reference tests' bound), then the
    quantised variants card against CPU at LM_VARIANTS_CPU's depth."""
    dev = torch.device("cuda")
    layers, b, t = LM_VARIANTS_CHECK
    cut = dataclasses.replace(cfg, dtype="float32", n_layers=layers)
    log("lm_variants", f"CUT: the checks run {cfg.name} at full width with the depth cut from "
        f"{cfg.n_layers} to {layers} layers (float32 reference) and to {LM_VARIANTS_CPU[0]} (card "
        "against CPU)")
    toks = torch.from_numpy(batch_at_step(TokenStreamConfig(cfg.vocab_size, t, b, seed=2), 0)
                            ["tokens"]).to(dev)
    _, want = lm_decode(variant_model(cut, dev, False), toks, 1, torch.float32)
    rel, abs_, agree_min = LM_VARIANTS_BOUND
    scale = float(want.abs().max())
    out = {}
    for name, (w8, kv8) in LM_VARIANTS.items():
        vcfg = cut if name != "bf16" else dataclasses.replace(cut, dtype="bfloat16")
        model = variant_model(vcfg, dev, w8)
        with kv_int8(kv8):
            _, got = lm_decode(model, toks, 1, torch.bfloat16 if name == "bf16" else torch.float32)
        err = float((got.float() - want).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        require(err < rel * scale + abs_ and agree > agree_min,
                f"lm_variants {name}: decode vs the float32 model max |err| {err} (scale {scale}), "
                f"argmax agreement {agree}")
        out[name] = {"max_abs_err": err, "argmax_agreement": agree}
        del model
    torch.cuda.empty_cache()
    log("lm_variants", f"each variant's decode (B={b}, T={t}, teacher-forced) against the float32 "
        f"model's cached decode at {layers} layers: max |err| < {rel} x {scale:.3g} + {abs_} and "
        f"argmax agreement > {agree_min} (the reference tests' bound): "
        f"{json.dumps(out)} on {card}")
    n_cpu, prompt, new = LM_VARIANTS_CPU
    small = dataclasses.replace(cfg, dtype="float32", n_layers=n_cpu)
    for name, (w8, kv8) in LM_VARIANTS.items():
        if not (w8 or kv8):
            continue  # the bf16 run's card-vs-CPU check is the lm phase's (b)
        if kv8:
            out[name].update(int8_kv_card_vs_cpu(small, dev, card, prompt + new, w8, name))
            continue
        got = lm_card_vs_cpu("lm_variants", small, dev, card, prompt, new,
                             prepare=quantize_model, what=name)
        out[name]["card_vs_cpu_max_abs_err"] = got["b_card_vs_cpu_max_abs_err"]
    return out


def int8_kv_card_vs_cpu(cut, dev, card: str, t: int, w8: bool, name: str) -> dict:
    """The int8 KV cache, card against CPU on the float32 model ``cut``
    (weights drawn on the card, copied; quantised on both when ``w8``):
    ``t`` teacher-forced decode steps at B = 2.  A code is a rounding of
    K / scale, so float32 noise upstream can move one by 1 where the
    quotient sits at a tie; until the first step whose caches' codes
    differ, the logits agree within rtol = atol = 1e-4, and a differing
    code differs by 1."""
    on_card = zoo.init_params(cut, torch.Generator("cuda").manual_seed(0), device=dev)
    on_cpu = Transformer(cut, device="cpu")
    with torch.no_grad():
        for pc, pg in zip(on_cpu.parameters(), on_card.parameters()):
            pc.copy_(pg)
    if w8:
        quantize_model(on_card)
        quantize_model(on_cpu)
    toks = batch_at_step(TokenStreamConfig(cut.vocab_size, t, 2, seed=3), 0)["tokens"]
    with kv_int8(True):
        caches = {"card": on_card.init_caches(2, t, torch.float32),
                  "cpu": on_cpu.init_caches(2, t, torch.float32)}
    err, first_flip, flips = 0.0, None, 0
    for pos in range(t):
        tok = torch.from_numpy(toks[:, pos:pos + 1])
        g, _ = on_card.forward_decode(tok.to(dev), caches["card"], pos)
        c, _ = on_cpu.forward_decode(tok, caches["cpu"], pos)
        step_flips = 0  # this step's codes included: its logits read them
        for gc, cc in zip(caches["card"], caches["cpu"]):
            for key in ("k_q", "v_q"):
                d = (gc[key].cpu().int() - cc[key].int()).abs()
                require(int(d.max()) <= 1, f"lm_variants {name}: a {key} code differs by {int(d.max())}")
                step_flips += int(d.sum())
        if step_flips and first_flip is None:
            first_flip = pos
        flips = max(flips, step_flips)
        if first_flip is None:
            err = max(err, float((g.cpu() - c).abs().max()))
            require(bool(torch.allclose(g.cpu(), c, rtol=1e-4, atol=1e-4)),
                    f"lm_variants {name}: card vs CPU logits at step {pos}, max |err| {err}")
    log("lm_variants", f"(b) {cut.name} {name}: card == CPU at full width, {cut.n_layers} layers, "
        f"float32, B=2, {t} teacher-forced steps: logits within rtol = atol = 1e-4 (max |err| "
        f"{err:.3g}) up to the first step whose int8 codes differ ({first_flip}; then {flips} of "
        f"the caches' codes differ, each by 1: a rounding at a tie under float32 noise) on {card}")
    del on_card
    torch.cuda.empty_cache()
    return {"card_vs_cpu_max_abs_err": err, "first_code_flip_step": first_flip,
            "codes_differing": flips}


def lm_variants_phase(card: str, ref_dir: str) -> dict:
    """The serving variants at full width (the module docstring's
    lm_variants step), and the dist_serve phase's w8a16 reference."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=LM_VARIANTS_DEPTH)
    log("lm_variants", f"CUT: the decodes run {full.name} at full width with its depth cut from "
        f"{full.n_layers} to {cfg.n_layers} layers, for the whole smoke's time (PERF.md)")
    n_params = cfg.param_count()
    out = {name: variant_decode(name, w8, kv8, cfg, n_params, card)
           for name, (w8, kv8) in LM_VARIANTS.items()}
    out["checks"] = variant_checks(full, card)
    out.update(dist_serve_refs_w8a16(ref_dir, card))
    out["peak_allocated_gb"] = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    log("lm_variants", f"phase {out['phase_s']:.1f} s; peak device memory allocated "
        f"{out['peak_allocated_gb']:.2f} GB above the {base_bytes / 1e9:.2f} GB held before the "
        f"phase, on {card}")
    print(json.dumps({"lm_variants": out, "card": card}), flush=True)
    return out


# ------------------------------------------------------------- the train phase
def checkpoint_writes() -> tuple[list, object]:
    """Wraps ``Checkpointer._write`` to record (step, seconds) of every
    write, the background ones too; returns the list and the undo."""
    writes, real = [], Checkpointer._write

    def timed(self, step, leaves):
        t0 = time.perf_counter()
        real(self, step, leaves)
        writes.append((step, time.perf_counter() - t0))

    Checkpointer._write = timed
    return writes, lambda: setattr(Checkpointer, "_write", real)


def train_example(tmp: str, card: str) -> dict:
    """(a) The reference's training example: examples/train_lm.py's config
    through ``launch.train.run`` for 300 steps, then resumed from a copy of
    that run's own mid-run checkpoint to the end, under
    ``torch.use_deterministic_algorithms``."""
    cfg = TRAIN_LM_CFG
    n = sum(p.numel() for p in Transformer(cfg, device="meta").parameters())
    require(n == TRAIN_LM_PARAMS == cfg.param_count(), f"train (a): {n:,} params")
    dirs = {k: os.path.join(tmp, f"train_{k}") for k in ("whole", "cut")}
    kw = dict(hp=TRAIN_LM_HP, log_every=100, **TRAIN_LM)
    writes, undo = checkpoint_writes()
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        whole = launch_train.run(cfg, ckpt_dir=dirs["whole"], **kw)
        whole_s = time.perf_counter() - t0
        # the launcher saves after step 50k as step 50k + 1; keep=3 leaves
        # the resume point TRAIN_LM_STOP among the unbroken run's checkpoints
        kept = Checkpointer(CheckpointConfig(dirs["whole"])).all_steps()
        require(TRAIN_LM_STOP in kept, f"train (a): the unbroken run kept {kept}")
        os.makedirs(dirs["cut"])
        shutil.copytree(os.path.join(dirs["whole"], f"step_{TRAIN_LM_STOP:010d}"),
                        os.path.join(dirs["cut"], f"step_{TRAIN_LM_STOP:010d}"))
        t0 = time.perf_counter()
        rest = launch_train.run(cfg, ckpt_dir=dirs["cut"], **kw)
        rest_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        undo()
    steps = TRAIN_LM["steps"]
    require(len(whole) == steps and whole[-1] < whole[0],
            f"train (a): the loss did not fall: {whole[0]} -> {whole[-1]}")
    require(len(rest) == steps - TRAIN_LM_STOP,
            f"train (a): resumed at {TRAIN_LM_STOP} for {len(rest)} steps")
    if rest != whole[TRAIN_LM_STOP:]:
        at = next(i for i, (x, y) in enumerate(zip(rest, whole[TRAIN_LM_STOP:])) if x != y)
        raise AssertionError(f"train (a): the resumed run's loss at step {TRAIN_LM_STOP + at} "
                             f"differs from the unbroken run's: {rest[at]} vs "
                             f"{whole[TRAIN_LM_STOP + at]}")
    final = {k: Checkpointer(CheckpointConfig(d)).latest_step() for k, d in dirs.items()}
    require(final == {"whole": steps, "cut": steps}, f"train (a): final checkpoints {final}")
    a, b = (os.path.join(d, f"step_{steps:010d}") for d in dirs.values())
    files = sorted(f for f in os.listdir(a) if f.endswith(".npy"))
    require(files == sorted(f for f in os.listdir(b) if f.endswith(".npy")), "train (a): files")
    for f in files:
        same(torch.from_numpy(np.load(os.path.join(a, f))), torch.from_numpy(np.load(os.path.join(b, f))),
             f"train (a): final checkpoint {f}, resumed vs unbroken")
    ckpt_bytes = sum(os.path.getsize(os.path.join(a, f)) for f in files)
    save_s = [s for _, s in writes]
    # one more step from the final checkpoint, profiled
    state = make_train_state(cfg, TRAIN_LM_HP, torch.Generator("cuda").manual_seed(0))
    state = load_state_tree(state, Checkpointer(CheckpointConfig(dirs["whole"])).restore(
        state_tree(state)))
    step = make_train_step(cfg, TRAIN_LM_HP)
    batch = batch_at_step(TokenStreamConfig(cfg.vocab_size, TRAIN_LM["seq_len"], TRAIN_LM["batch"]),
                          steps)
    step(state, batch)  # warm
    prof = profile_batch(lambda: step(state, batch), whole_s / steps * 1e3, top=6)
    del state, step
    out = {"params": n, "steps": steps, "first_loss": whole[0], "last_loss": whole[-1],
           "losses_every_50": whole[::50], "s_per_step": whole_s / steps, "run_s": whole_s,
           "tokens_per_s": steps * TRAIN_LM["batch"] * TRAIN_LM["seq_len"] / whole_s,
           "resumed_at": TRAIN_LM_STOP, "resume_equal": "bit for bit (deterministic algorithms)",
           "resumed_run_s": rest_s, "kept_checkpoints": kept,
           "checkpoint_bytes": ckpt_bytes, "checkpoint_writes": len(writes),
           "save_s_median": float(np.median(save_s)), "save_s_max": max(save_s),
           "fs": fs_type(tmp), "profile": prof}
    log("train", f"(a) examples/train_lm.py's config ({cfg.n_layers} x {cfg.d_model}, vocab "
        f"{cfg.vocab_size:,}, float32, {n:,} params = param_count()) through launch.train.run, "
        f"B={TRAIN_LM['batch']} T={TRAIN_LM['seq_len']}, AdamW (weight decay "
        f"{TRAIN_LM_HP.opt.weight_decay}, warmup {TRAIN_LM_HP.warmup}), {steps} steps in "
        f"{whole_s:.1f} s ({out['s_per_step'] * 1e3:.1f} ms a step with the loss read back each "
        f"step and the saves, {out['tokens_per_s']:,.0f} tokens/s): loss {whole[0]:.4f} -> "
        f"{whole[-1]:.4f} (every 50 steps {[round(x, 4) for x in whole[::50]]}); resumed from a "
        f"copy of the unbroken run's own step-{TRAIN_LM_STOP} checkpoint (it kept {kept}; no "
        f"second run to {TRAIN_LM_STOP}) in {rest_s:.1f} s: the last {steps - TRAIN_LM_STOP} "
        f"losses and the step-{steps} checkpoint equal the unbroken run's bit for bit under "
        f"torch.use_deterministic_algorithms(True); {len(writes)} checkpoint "
        f"writes of {ckpt_bytes / 1e9:.2f} GB, median {out['save_s_median']:.2f} s, most "
        f"{out['save_s_max']:.2f} s, to {out['fs']} ({tmp}); one step profiled: "
        f"{prof['device_busy_ms']:.1f} ms of kernels, {prof['device_launches']} launches, busy "
        f"{prof['device_busy_share']:.3f} of a step; top {json.dumps(prof['top_kernels_ms_calls'])} "
        f"on {card}")
    return out


def train_full_width(card: str) -> dict:
    """(b) gemma3-4b at full width, its depth cut to TRAIN_BIG_DEPTH: bf16
    activations over float32 masters, Adafactor, per-unit remat,
    TRAIN_BIG's (B, T) for its steps."""
    arch, b, t, n_steps = TRAIN_BIG
    cfg = get_config(arch)
    log("train", f"CUT: (b) {arch} trains at TRAIN_4K's sequence ({t}) with its global batch cut "
        f"from {TRAIN_4K.global_batch} to {b} (one card), for {n_steps} steps, its depth cut from "
        f"{cfg.n_layers} to {TRAIN_BIG_DEPTH} layers for the whole smoke's time")
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_BIG_DEPTH)
    hp = TrainHParams(peak_lr=3e-4, warmup=max(n_steps // 10, 1), total_steps=n_steps,
                      opt=OptConfig(name="adafactor"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(cfg, hp, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in state.params.parameters())
    require(n == cfg.param_count(), f"train (b): {n:,} params")
    step = make_train_step(cfg, hp)
    ds = TokenStreamConfig(cfg.vocab_size, t, b, seed=0)
    rows = []
    for i in range(n_steps):
        batch = batch_at_step(ds, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rows.append({"s": time.perf_counter() - t0, **{k: float(v) for k, v in m.items()}})
        require(all(np.isfinite(v) for v in rows[-1].values()), f"train (b) step {i}: {rows[-1]}")
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    s_step = float(np.median([r["s"] for r in rows[1:]]))  # the first step warms up
    ops = lm_ops(cfg, n, b, t)
    fwd = ops["linear_ops"] + ops["float32_ops"] + 2 * b * t * cfg.d_model * cfg.vocab_size
    bound_s = 4 * fwd / BF16_OPS_PER_S  # forward, recompute, backward (2x)
    prof = profile_batch(lambda: step(state, batch_at_step(ds, n_steps)), s_step * 1e3, top=8)
    out = {"arch": arch, "params": n, "B": b, "T": t, "opt": "adafactor", "init_s": init_s,
           "steps": rows, "s_per_step": s_step, "bound_s": bound_s, "forward_ops": fwd,
           "tokens_per_s": b * t / s_step, "peak_allocated_gb": peak, "profile": prof}
    log("train", f"(b) {arch} at full width, {cfg.n_layers} layers ({n:,} params), bf16 over float32 masters, "
        f"Adafactor, B={b} T={t}, remat a unit: {s_step:.3f} s a step (median of steps 2-{n_steps}) "
        f"against the operations bound {bound_s:.3f} s ({fwd / 1e12:.1f} TFLOP forward x 4 with "
        f"the recompute and the backward, at 989 TFLOP/s), {out['tokens_per_s']:,.0f} tokens/s; "
        f"steps (s, loss, grad norm, lr): "
        f"{[(round(r['s'], 3), round(r['loss'], 4), round(r['grad_norm'], 3), r['lr']) for r in rows]}; "
        f"peak {peak:.2f} GB above the {base / 1e9:.2f} GB held before; one step profiled: "
        f"{prof['device_busy_ms']:.1f} ms of kernels, {prof['device_launches']} launches, busy "
        f"{prof['device_busy_share']:.3f}; top {json.dumps(prof['top_kernels_ms_calls'])} on {card}")
    del state, step
    torch.cuda.empty_cache()
    return out


def train_phase(tmp: str, card: str) -> dict:
    """Training on one device (the module docstring's train step)."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()
    out = {"example": train_example(tmp, card), "full_width": train_full_width(card), "card_vs_cpu": {}}
    n_cpu, b, t = TRAIN_CPU
    arch = TRAIN_BIG[0]
    cut = dataclasses.replace(get_config(arch), dtype="float32", n_layers=n_cpu)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    out["card_vs_cpu"][f"{arch} ({n_cpu} layers)"] = train_step_card_vs_cpu(dev, cut, b, t, seed=0)
    for a in TRAIN_SMOKE:
        out["card_vs_cpu"][f"{a} smoke"] = train_step_card_vs_cpu(
            dev, dataclasses.replace(get_smoke_config(a), dtype="float32"), 2, 32, seed=1)
    log("train", f"(c) one Adafactor step, card == CPU (float32, TF32 off; loss and grad norm "
        f"within 1e-4, each updated leaf within 1e-4 of its largest magnitude): {arch} at full "
        f"width cut to {n_cpu} layers, B={b} T={t}, and the smoke configs of "
        f"{', '.join(TRAIN_SMOKE)} (B=2 T=32): {json.dumps(out['card_vs_cpu'])}; "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    out["peak_allocated_gb"] = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    log("train", f"phase {out['phase_s']:.1f} s; peak device memory allocated "
        f"{out['peak_allocated_gb']:.2f} GB above the {base_bytes / 1e9:.2f} GB held before the "
        f"phase, on {card}")
    print(json.dumps({"train": out, "card": card}), flush=True)
    return out


# ------------------------------------------------------- the dist_train phase
def timed_dist() -> dict:
    """Wrap ``torch.distributed``'s ``all_gather``, ``reduce_scatter`` and
    ``all_reduce`` to add each call's host-clock seconds (the card drained
    before and after) to the returned dict; for one instrumented step,
    not the timed ones."""
    spent = {"s": 0.0, "calls": 0}
    for name in ("all_gather", "reduce_scatter", "all_reduce"):
        real = getattr(torch.distributed, name)

        def timed(*args, _real=real, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(*args, **kwargs)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1
            return out

        setattr(torch.distributed, name, timed)
    return spent


def state_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in flatten_with_paths(tree).values()
               if isinstance(t, torch.Tensor))


def dist_train_specs(layout):
    meta = Transformer(TRAIN_LM_CFG, device="meta")
    return make_train_state_specs(reference_leaves(meta), reference_axes(meta), layout,
                                  TRAIN_LM_HP.opt.name)


def dist_compress_rank(mesh) -> dict:
    """(a) ``compressed_psum`` over this rank's ``data`` group (the world on
    a 1-rank mesh) against this process's plain computation of the same
    sum: every member's input drawn again from its seed, quantised, the
    codes summed in int32 and the scales in rank order."""
    dev = mesh.device
    draw = lambda r: torch.randn(DIST_TRAIN_COMPRESS_N, generator=torch.Generator(dev).manual_seed(
        DIST_TRAIN_SEED + r), device=dev)
    axis = "data" if mesh.size("data") > 1 else "model"
    group = mesh.group(axis)
    got = compressed_psum(draw(mesh.rank), group)
    line = list(mesh.coords)  # this rank's line along axis: the group's ranks
    line[mesh.axis_names.index(axis)] = slice(None)
    members = np.arange(math.prod(mesh.shape)).reshape(mesh.shape)[tuple(line)].tolist()
    q_sum, s_sum = None, None
    for r in members:
        q, s, n = quantize_int8(draw(r))
        q_sum = q.to(torch.int32) if q_sum is None else q_sum + q.to(torch.int32)
        s_sum = s if s_sum is None else s_sum + s
    want = dequantize_int8(q_sum, s_sum / torch.full_like(s_sum, float(len(members))), n,
                           got.shape)
    same(got, want, f"dist_train (a): compressed_psum over {axis} of {members} vs plain")
    return {"axis": axis, "members": members, "n": n}


def dist_train_rank(mesh, tmp: str, steps: int, save: bool, restore_step: int | None) -> dict:
    """(b)/(c) One rank of the sharded train step on examples/train_lm.py's
    config: ``steps`` steps from the seeded init (or from ``restore_step``'s
    checkpoint, re-sharded onto this mesh), each under a ``StepWatchdog``;
    the step-``steps`` checkpoint when ``save``; each step's loss, grad norm
    and lr, ms a step, state bytes held, peak memory, and the collectives'
    share of one more, instrumented step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank}
    if restore_step is None and (mesh.size("data") > 1 or math.prod(mesh.shape) == 1):
        out["compress"] = dist_compress_rank(mesh)
    cfg, hp = TRAIN_LM_CFG, TRAIN_LM_HP
    layout = make_layout("train", mesh)
    specs = dist_train_specs(layout)
    shardings = named_shardings(mesh, specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(cfg, hp, torch.Generator(mesh.device).manual_seed(0), layout=layout)
    ckpt = Checkpointer(CheckpointConfig(os.path.join(tmp, "dist_train_ckpt"), keep=2))
    start = 0
    if restore_step is not None:
        state = ckpt.restore(state, step=restore_step, shardings=shardings)
        start = int(state.step)
    out["state_bytes"] = state_bytes(state)
    step = make_train_step(cfg, hp, layout=layout, grad_specs=specs.params)
    ds = TokenStreamConfig(cfg.vocab_size, TRAIN_LM["seq_len"], TRAIN_LM["batch"])
    wd = StepWatchdog(limit_s=DIST_TRAIN_STEP_LIMIT_S)
    rows = []
    for i in range(start, start + steps):
        t0 = time.perf_counter()
        with wd:
            state, m = step(state, batch_at_step(ds, i))
            torch.cuda.synchronize()
        rows.append({"s": time.perf_counter() - t0, **{k: float(v) for k, v in m.items()}})
    out["rows"] = rows
    out["watchdog"] = {"p50_s": wd.p50, "adaptive_limit_s": wd.adaptive_limit(), "trips": wd.trips,
                       "limit_s": wd.limit_s}
    if save:
        ckpt.save(start + steps, state, shardings=shardings, blocking=True)
        out["shard_sha256"] = {k: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                               for k, t in state.params.items()}
    spent = timed_dist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch_at_step(ds, start + steps))
    torch.cuda.synchronize()
    out["instrumented"] = {"step_s": time.perf_counter() - t0, **spent}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def params_close(got: dict, want: dict, lr_sum: float, what: str) -> dict:
    """Params after several steps from two runs (leaf path -> tensor):
    ``assert_step_close``'s bound (tests/test_torch_train.py) with the
    step's lr replaced by the sum of the steps' lrs, since each step may
    move an element apart by up to 2.2 lr where float32 noise tips Adam's
    normalised step: every element within 1e-6 of its leaf's scale plus
    2.2 x that sum, and the share past 1e-6 scale + that sum / 100
    reported."""
    apart, n, worst = 0, 0, 0.0
    for k, w in want.items():
        d = (got[k].double().cpu() - w.double().cpu()).abs()
        scale = float(w.abs().max())
        require(float(d.max()) <= 1e-6 * scale + 2.2 * lr_sum,
                f"{what}: {k} apart by {float(d.max())} (scale {scale}, lr sum {lr_sum})")
        apart += int((d > 1e-6 * scale + 1e-2 * lr_sum).sum())
        n += d.numel()
        worst = max(worst, float(d.max()) / lr_sum)
    return {"apart": apart, "elements": n, "apart_share": apart / n, "max_abs_over_lr_sum": worst}


def losses_close(got: list, want: list, what: str) -> float:
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    require(len(got) == len(want) and rel <= 2e-4, f"{what}: losses {got} vs {want} "
            f"(max relative {rel:.2e}, rtol 2e-4)")
    return rel


def dist_train_phase(tmp: str, card: str) -> dict:
    """Sharded training on the one card (the module docstring's dist_train)."""
    t_phase = time.perf_counter()
    cfg, hp = TRAIN_LM_CFG, TRAIN_LM_HP
    out = {}
    # (a) quantize_int8 on the card == the CPU, at the 12 x 512 model's gradient size
    x = torch.from_numpy(np.random.default_rng(DIST_TRAIN_SEED).standard_normal(
        TRAIN_LM_PARAMS, dtype=np.float32))
    got, want = quantize_int8(x.cuda()), quantize_int8(x)
    require(got[2] == want[2] == TRAIN_LM_PARAMS, f"dist_train (a): n {got[2]} / {want[2]}")
    same(got[0].cpu(), want[0], "dist_train (a): int8 codes, card vs CPU")
    same(got[1].cpu(), want[1], "dist_train (a): scales, card vs CPU")
    nb = got[1].numel()
    wire = {"int8_codes_plus_scales": TRAIN_LM_PARAMS + 4 * nb, "float32": 4 * TRAIN_LM_PARAMS,
            "int32_widened_plus_scales": 4 * TRAIN_LM_PARAMS + 4 * nb}
    out["compress"] = {"n": TRAIN_LM_PARAMS, "blocks": nb, "bytes": wire}
    log("dist_train", f"(a) quantize_int8 of {TRAIN_LM_PARAMS:,} seeded float32 values (the "
        f"12 x 512 model's gradient size): card == CPU bit for bit (codes, {nb:,} scales, n); a "
        f"reduction's payload {wire['int8_codes_plus_scales'] / 1e6:.1f} MB as int8 codes plus "
        f"scales against {wire['float32'] / 1e6:.1f} MB as float32 "
        f"({wire['float32'] / wire['int8_codes_plus_scales']:.2f}x less); compressed_psum's "
        f"all-reduce moves the codes widened to int32, {wire['int32_widened_plus_scales'] / 1e6:.1f} "
        f"MB, as the reference's psum does, on {card}")
    del x, got, want
    # the single-device reference run: the same init, the same batches
    ds = TokenStreamConfig(cfg.vocab_size, TRAIN_LM["seq_len"], TRAIN_LM["batch"])
    t0 = time.perf_counter()
    single = make_train_state(cfg, hp, torch.Generator("cuda").manual_seed(0))
    one_bytes = state_bytes(state_tree(single))
    step = make_train_step(cfg, hp)
    ref = []
    for i in range(DIST_TRAIN_STEPS):
        single, m = step(single, batch_at_step(ds, i))
        ref.append({k: float(v) for k, v in m.items()})
    single_s = time.perf_counter() - t0
    ref_params = {k: v.clone() for k, v in state_tree(single).params.items()}
    del single, step
    torch.cuda.empty_cache()
    # (b) the (2, 2) gloo mesh, 20 steps, the step-20 checkpoint
    runs = {}
    for name, shape, backend, steps, save, restore in (
            ("gloo_2x2", (2, 2), "gloo", DIST_TRAIN_STEPS, True, None),
            ("nccl_1x1", (1, 1), "nccl", DIST_TRAIN_NCCL_STEPS, False, None),
            ("gloo_1x4_restored", (1, 4), "gloo", DIST_TRAIN_RESUMED_STEPS, False, DIST_TRAIN_STEPS)):
        t0 = time.perf_counter()
        ranks = spawn_local(dist_train_rank, shape, backend=backend, device="cuda:0",
                            timeout_s=DIST_TIMEOUT_S, args=(tmp, steps, save, restore))
        runs[name] = {"ranks": ranks, "wall_s": time.perf_counter() - t0, "shape": shape,
                      "backend": backend}
        for r in ranks[1:]:
            require([x["loss"] for x in r["rows"]] == [x["loss"] for x in ranks[0]["rows"]],
                    f"dist_train {name}: ranks report different losses")
    # (c) elastic restore: the (2, 2) run's step-20 checkpoint on one device
    ck = Checkpointer(CheckpointConfig(os.path.join(tmp, "dist_train_ckpt"), keep=2))
    one = make_train_state(cfg, hp, torch.Generator("cuda").manual_seed(0))
    one = load_state_tree(one, ck.restore(state_tree(one), step=DIST_TRAIN_STEPS))
    leaves = {k: v.clone() for k, v in state_tree(one).params.items()}
    mesh22 = AbstractMesh(("data", "model"), (2, 2))
    specs22 = dist_train_specs(make_layout("train", mesh22))
    for r in runs["gloo_2x2"]["ranks"]:
        for k, sha in r["shard_sha256"].items():
            block = leaves[k][NamedSharding(mesh22, specs22.params[k]).block(
                tuple(leaves[k].shape), r["rank"])]
            require(hashlib.sha256(block.contiguous().cpu().numpy().tobytes()).hexdigest() == sha,
                    f"dist_train (c): rank {r['rank']}'s block of {k} != the one-device restore")
    step = make_train_step(cfg, hp)
    resumed = []
    for i in range(DIST_TRAIN_STEPS, DIST_TRAIN_STEPS + DIST_TRAIN_RESUMED_STEPS):
        one, m = step(one, batch_at_step(ds, i))
        resumed.append(float(m["loss"]))
    del one, step
    torch.cuda.empty_cache()
    # the checks
    ref_loss = [x["loss"] for x in ref]
    r22 = runs["gloo_2x2"]["ranks"]
    rel = {"gloo_2x2": losses_close([x["loss"] for x in r22[0]["rows"]], ref_loss,
                                    "dist_train (b) (2, 2) vs one device"),
           "nccl_1x1": losses_close([x["loss"] for x in runs["nccl_1x1"]["ranks"][0]["rows"]],
                                    ref_loss[:DIST_TRAIN_NCCL_STEPS],
                                    "dist_train (b) nccl vs one device"),
           "gloo_1x4_restored": losses_close(
               [x["loss"] for x in runs["gloo_1x4_restored"]["ranks"][0]["rows"]], resumed,
               "dist_train (c) (1, 4) restored vs one device restored")}
    close = params_close(leaves, ref_params, sum(x["lr"] for x in ref),
                         "dist_train (b) the (2, 2) run's step-20 params vs one device's")
    for a, b in zip(r22[0]["rows"], ref):
        require(a["lr"] == b["lr"], f"dist_train (b): lr {a['lr']} vs {b['lr']}")
    for r in runs["gloo_2x2"]["ranks"] + runs["nccl_1x1"]["ranks"]:
        c = r.get("compress")
        if c is not None:
            log("dist_train", f"(a) rank {r['rank']}: compressed_psum over {c['axis']} (ranks "
                f"{c['members']}) of {c['n']:,} values == one process's plain sum bit for bit "
                f"(int32 code sums, scales, output)")
    # per rank
    for name, run in runs.items():
        for r in run["ranks"]:
            s_step = float(np.median([x["s"] for x in r["rows"][1:]])) if len(r["rows"]) > 1 else r["rows"][0]["s"]
            r["ms_a_step"] = s_step * 1e3
            inst = r["instrumented"]
            r["collective_share"] = inst["s"] / inst["step_s"]
            log("dist_train", f"{name} ({run['backend']}, mesh {run['shape']}) rank {r['rank']}: "
                f"state {r['state_bytes'] / 1e6:.1f} MB held against {one_bytes / 1e6:.1f} MB on "
                f"one device ({r['state_bytes'] / one_bytes:.3f}); peak {r['peak_bytes'] / 2**30:.2f} "
                f"GiB; {r['ms_a_step']:.1f} ms a step (median of steps 2-{len(r['rows'])}); "
                f"collectives {r['collective_share']:.1%} of an instrumented step "
                f"({inst['s'] * 1e3:.1f} of {inst['step_s'] * 1e3:.1f} ms, {inst['calls']} calls); "
                f"watchdog p50 {r['watchdog']['p50_s'] * 1e3:.1f} ms, adaptive_limit "
                f"{r['watchdog']['adaptive_limit_s']:.1f} s, trips {r['watchdog']['trips']} on {card}")
    out["runs"] = {name: {"mesh": list(run["shape"]), "backend": run["backend"],
                          "wall_s": run["wall_s"],
                          "losses": [x["loss"] for x in run["ranks"][0]["rows"]],
                          "ranks": [{k: r[k] for k in ("rank", "state_bytes", "peak_bytes",
                                                       "ms_a_step", "collective_share",
                                                       "watchdog", "instrumented")}
                                    for r in run["ranks"]]}
                   for name, run in runs.items()}
    out.update({"single_losses": ref_loss, "single_s": single_s, "one_device_state_bytes": one_bytes,
                "loss_max_rel": rel, "params_step20": close, "resumed_single": resumed})
    log("dist_train", f"(b) examples/train_lm.py's config ({TRAIN_LM_PARAMS:,} params, float32, "
        f"TF32 off), B={TRAIN_LM['batch']} T={TRAIN_LM['seq_len']}, AdamW, REPRO_GRAD_SHARD="
        f"{os.environ.get('REPRO_GRAD_SHARD', '1')}: {DIST_TRAIN_STEPS} steps on a (2, 2) gloo mesh "
        f"(4 ranks sharing the card) within {rel['gloo_2x2']:.2e} relative of one device's "
        f"losses (rtol 2e-4; {[round(x, 4) for x in ref_loss[::5]]} every 5 steps), "
        f"{DIST_TRAIN_NCCL_STEPS} on a 1-rank nccl world within {rel['nccl_1x1']:.2e}; the step-"
        f"{DIST_TRAIN_STEPS} params (the checkpoint, gathered) within the bound of each step's lr "
        f"summed: {json.dumps(close)}; one device's {DIST_TRAIN_STEPS} steps "
        f"{single_s:.1f} s on {card}")
    log("dist_train", f"(c) the (2, 2) run's step-{DIST_TRAIN_STEPS} checkpoint restored on one "
        f"device == every rank's blocks bit for bit; restored on a (1, 4) mesh (shardings=): "
        f"{DIST_TRAIN_RESUMED_STEPS} steps within {rel['gloo_1x4_restored']:.2e} relative of one "
        f"device's {DIST_TRAIN_RESUMED_STEPS} steps from the same checkpoint on {card}")
    # (d) plans at full width, shapes only: launch.dryrun's argument bytes of the state
    out["plans"] = {}
    for arch in DIST_TRAIN_PLAN_ARCHS:
        for mp in (False, True):
            mesh = abstract_production_mesh(multi_pod=mp)
            items = dryrun.train_state_items(get_config(arch), make_layout("train", mesh,
                                                                           multi_pod=mp), "adamw")
            whole = dryrun.spec_bytes(AbstractMesh(mesh.axis_names, (1,) * len(mesh.shape)), items)
            p = {"mesh": list(mesh.shape), "ranks": math.prod(mesh.shape),
                 "params": sum(math.prod(sh) for sh, dt, _ in items if dt.is_floating_point) // 3,
                 "bytes_per_rank": int(dryrun.spec_bytes(mesh, items).max()),
                 "bytes_whole": int(whole[0])}
            out["plans"][f"{arch} {'x'.join(map(str, p['mesh']))}"] = p
            log("dist_train", f"(d) {arch} ({p['params']:,} params) train state (float32 masters "
                f"+ AdamW moments) under make_train_state_specs on {p['mesh']}: "
                f"{p['bytes_per_rank'] / 1e9:.2f} GB a rank of {p['bytes_whole'] / 1e9:.1f} GB "
                f"({p['ranks']} ranks; launch.dryrun.spec_bytes, from specs alone; the step also "
                f"holds the gathered compute tree, {p['params'] * 4 / 1e9:.1f} GB, and gradients)")
    out["phase_s"] = time.perf_counter() - t_phase
    log("dist_train", f"phase {out['phase_s']:.1f} s (spawn to join: "
        f"{json.dumps({k: round(v['wall_s'], 1) for k, v in runs.items()})}) on {card}")
    print(json.dumps({"dist_train": out, "card": card}), flush=True)
    return out


# ------------------------------------------------------- the dist_serve phase
def order_noise(model, run):
    """``run()`` with every ``Linear`` of ``model`` taking its product as a
    float32 product of the rounded operands, rounded once (the split
    products' path, on one rank), and every ``torch.bmm`` (the MoE
    experts') likewise: the same function summed in another order, so
    its distance from the plain run is one device's own sensitivity to
    summation order."""
    linears = [m for m in model.modules() if isinstance(m, Linear)]
    bmm = torch.bmm
    for m in linears:
        m.reduce = ONE
    torch.bmm = lambda a, b: bmm(a.float(), b.float()).to(torch.promote_types(a.dtype, b.dtype))
    try:
        return run()
    finally:
        torch.bmm = bmm
        for m in linears:
            m.reduce = None


def replay(model, cfg, fed: torch.Tensor, first: int, pos0: int, caches: list) -> torch.Tensor:
    """The fed tokens through ``make_serve_step`` from ``pos0``: the logits
    of the steps from ``first`` on (steps, B, V)."""
    step, out = make_serve_step(cfg), []
    for t in range(fed.shape[1]):
        r = step(model, caches, fed[:, t:t + 1], pos0 + t)
        if t >= first:
            out.append(r["logits"][:, 0].cpu())
    return torch.stack(out)


def serve_decode_ref(model, cfg, b: int, prompt: int, new: int, length: int, seed: int,
                     cache_dtype=torch.bfloat16, handover: str | None = None) -> dict:
    """One device's decode for the dist_serve phase: a seeded (b, prompt)
    prompt teacher-forced, then ``new`` greedy tokens fed back, into caches
    of ``length``.  Returns the tokens fed at each step from ``first`` on
    (the ranks replay them from position ``pos0``), the greedy steps'
    logits (new, b, V) float32 and tokens, the pairs each MoE routing
    dropped, and ``noise``: the largest distance of the greedy steps'
    replay under ``order_noise``.  With ``handover`` (a path), the caches
    as they stand before the last prompt token are saved there and the
    ranks start from their blocks of them (``cache_blocks``), replaying
    the greedy steps alone."""
    toks = torch.from_numpy(batch_at_step(TokenStreamConfig(cfg.vocab_size, prompt, b, seed=seed),
                                          0)["tokens"]).to(model.device)
    step = make_serve_step(cfg)
    caches = model.init_caches(b, length, cache_dtype)
    tok, fed, logits, nexts, saved = toks[:, :1], [], [], [], None
    with routings(model) as seen:
        for t in range(prompt + new - 1):
            if t + 1 == prompt:
                saved = [{k: v.clone() for k, v in c.items()} for c in caches]
                if handover:
                    del seen[:]  # the ranks route the greedy steps alone
            fed.append(tok)
            r = step(model, caches, tok, t)
            if t + 1 >= prompt:
                logits.append(r["logits"][:, 0].cpu())
                nexts.append(r["next_tokens"][:, 0].cpu())
            tok = toks[:, t + 1:t + 2] if t + 1 < prompt else r["next_tokens"]
    drops = kept_pairs(seen)
    first = prompt - 1
    fed, logits = torch.cat(fed, dim=1), torch.stack(logits)
    if handover:
        torch.save([{k: v.cpu() for k, v in c.items()} for c in saved], handover)
    noise = order_noise(model, lambda: replay(model, cfg, fed[:, first:], 0, first, saved))
    return {"fed": (fed[:, first:] if handover else fed).cpu(), "first": 0 if handover else first,
            "pos0": first if handover else 0, "logits": logits, "tokens": torch.stack(nexts),
            "drops": drops, "dtype": cfg.dtype, "cache_dtype": cache_dtype,
            "noise": float((noise - logits).abs().max()), "handover": handover}


def fill_long(caches: list, cfg, shard, n_filled: int, length: int) -> None:
    """Every attention cache as if positions 0..n_filled-1 had been decoded
    into caches of ``length``: each slot's position, and K/V drawn in
    chunks of DIST_SERVE_CHUNK slots seeded by (layer, chunk), so one
    device's caches and a rank's blocks (``shard``, or None) hold the same
    values."""
    ch = DIST_SERVE_CHUNK
    for i, (kind, window) in enumerate(zip(cfg.layer_kinds, cfg.layer_windows)):
        if kind not in ("attn", "moe"):
            continue
        c = caches[i]
        dev, n_local = c["pos"].device, c["pos"].shape[0]
        total = min(window, length) if window else length
        start = shard.cache.index * n_local if shard is not None else 0
        stop = min(start + n_local, total)
        if stop <= start:
            continue
        slots = torch.arange(start, stop, device=dev)
        pos = slots + total * torch.div(n_filled - 1 - slots, total, rounding_mode="floor")
        c["pos"][:stop - start] = torch.where(pos >= 0, pos, -1).to(torch.int32)
        b = c["k"].shape[0]
        for chunk in range(start // ch, (stop - 1) // ch + 1):
            g = torch.Generator(dev).manual_seed(1_000_003 * i + chunk)
            kv = torch.randn((2, b, ch) + tuple(c["k"].shape[2:]), generator=g, device=dev)
            lo, hi = max(start, chunk * ch), min(stop, (chunk + 1) * ch)
            for j, name in enumerate(("k", "v")):
                c[name][:, lo - start:hi - start] = kv[j][:, lo - chunk * ch:hi - chunk * ch].to(
                    c[name].dtype)


def serve_long_ref(model, cfg, steps: int, length: int) -> dict:
    """One device's ``long`` reference: B = 1, bf16 caches of ``length``
    filled as decoded to ``length - steps`` (``fill_long``), then ``steps``
    greedy steps from a seeded token."""
    caches = model.init_caches(1, length, torch.bfloat16)
    fill_long(caches, cfg, None, length - steps, length)
    step = make_serve_step(cfg)
    tok = torch.from_numpy(np.random.default_rng(23).integers(0, cfg.vocab_size, (1, 1))
                           .astype(np.int32)).to(model.device)
    fed, logits, nexts = [], [], []
    for t in range(steps):
        fed.append(tok)
        r = step(model, caches, tok, length - steps + t)
        logits.append(r["logits"][:, 0].cpu())
        nexts.append(r["next_tokens"][:, 0].cpu())
        tok = r["next_tokens"]
    fed, logits = torch.cat(fed, dim=1), torch.stack(logits)
    fill_long(caches, cfg, None, length - steps, length)  # the decoded slots emptied again
    noise = order_noise(model, lambda: replay(model, cfg, fed, 0, length - steps, caches))
    del caches
    return {"fed": fed.cpu(), "first": 0, "pos0": length - steps, "logits": logits,
            "tokens": torch.stack(nexts), "drops": [], "dtype": cfg.dtype,
            "cache_dtype": torch.bfloat16, "noise": float((noise - logits).abs().max()),
            "handover": None}


def serve_rag_engine(ref_dir: str):
    """The dist_serve generate's engine: DIST_SERVE_RAG["n"] seeded vectors
    built on the card (R = 32, L_build = 32: its recall is not under
    test), saved and loaded back; with its requests' queries and labels."""
    n = DIST_SERVE_RAG["n"]
    x = make_bigann_like(n, DIM, seed=31)
    labels = uniform_labels(n, N_LABELS, seed=31)
    path = os.path.join(ref_dir, "rag.gann")
    if not os.path.exists(path):
        GateANNEngine.build(x, config=EngineConfig(degree=32, build_l=32, alpha=ALPHA,
                                                   pq_chunks=PQ_CHUNKS, r_max=R_MAX),
                            labels=labels).save(path)
    q = make_queries(x, DIST_SERVE_RAG["requests"], seed=32)
    targets = np.random.default_rng(33).integers(0, N_LABELS, len(q)).astype(np.int32)
    return GateANNEngine.load(path), q, targets


def serve_rag_server(eng, cfg, model, q, targets, layout=None):
    """The generate's server and requests (gate, K = DIST_SERVE_RAG["k"],
    a label filter each, seeded passages and prompts)."""
    rag = DIST_SERVE_RAG
    n = int(eng.codes.shape[0])
    passages = np.random.default_rng(34).integers(0, cfg.vocab_size, (n, rag["passage"])).astype(np.int32)
    search = SearchConfig(mode="gate", search_l=SEARCH["search_l"], beam_width=SEARCH["beam_width"],
                          result_k=rag["k"])
    kw = {} if layout is None else {"layout": layout}
    srv = RAGServer(eng, cfg, model, passages, search, **kw)
    rng = np.random.default_rng(35)
    reqs = [RAGRequest(query_vec=q[i], prompt_tokens=rng.integers(0, cfg.vocab_size, rag["prompt"])
                       .astype(np.int32), filter_kind="label", filter_params=targets[i])
            for i in range(len(q))]
    return srv, reqs


def serve_generate_ref(model, cfg, ref_dir: str) -> dict:
    """One device's ``generate`` over the phase's engine: its tokens, and
    for each greedy step and row whether one device's top-2 gap is within
    the bar (``serve_bar``: the order noise from a replay of the same
    sequence under ``order_noise``)."""
    new = DIST_SERVE_RAG["new"]
    eng, q, targets = serve_rag_engine(ref_dir)
    srv, reqs = serve_rag_server(eng, cfg, model, q, targets)
    seen, decode = [], model.forward_decode

    def recorded(tokens, caches, pos):
        logits, caches = decode(tokens, caches, pos)
        seen.append(logits[:, 0].cpu())
        return logits, caches

    model.forward_decode = recorded
    try:
        toks, _ = srv.generate(reqs, max_new_tokens=new)
    finally:
        del model.forward_decode
    ids, _ = srv.retrieve(reqs)
    prompts = torch.from_numpy(srv.build_prompts(reqs, ids))
    p_len = prompts.shape[1]
    logits = torch.stack(seen[p_len - 1:])  # the greedy steps (new, B, V)
    fed = torch.cat([prompts, torch.from_numpy(toks[:, :-1])], dim=1).to(model.device)
    noisy = order_noise(model, lambda: replay(model, cfg, fed, p_len - 1, 0, model.init_caches(
        fed.shape[0], p_len + new, torch.float32)))
    scale = float(logits.abs().max())
    bar = serve_bar(scale, float((noisy - logits).abs().max()), cfg.dtype)
    top2 = torch.topk(logits, 2, dim=-1).values
    return {"tokens": torch.from_numpy(toks), "close": ((top2[..., 0] - top2[..., 1]) <= bar).T,
            "bar": bar, "scale": scale}


@contextlib.contextmanager
def first_layers(model, n: int):
    """``model`` cut to its first ``n`` layers, its config too, while the
    block runs: the model of ``n`` layers drawn from the same seed (the
    layers are drawn after the embeddings)."""
    layers, cfg = model.layers, model.cfg
    if n >= len(layers):
        yield model
        return
    model.layers = torch.nn.ModuleList(list(layers)[:n])
    model.cfg = dataclasses.replace(cfg, n_layers=n)
    try:
        yield model
    finally:
        model.layers, model.cfg = layers, cfg


def dist_serve_refs_gemma(model, cfg, ref_dir: str, card: str) -> dict:
    """The lm phase's part of the dist_serve phase: one device's gemma3-4b
    decode, long and prefill references and ``generate`` over the phase's
    engine, saved under ``ref_dir`` for the ranks."""
    parts, t0 = {}, time.perf_counter()

    def part(name, fn):
        t = time.perf_counter()
        fn()
        parts[name] = time.perf_counter() - t

    b, prompt, new, length = DIST_SERVE_DECODE
    part("decode", lambda: torch.save(serve_decode_ref(
        model, cfg, b, prompt, new, length, seed=21,
        handover=os.path.join(ref_dir, "gemma3-4b_caches.pt")),
        os.path.join(ref_dir, "gemma3-4b_decode.pt")))
    # the float32 twin: the same weights with float32 activations and caches
    model.cfg = f32 = dataclasses.replace(cfg, dtype="float32")
    try:
        fb, fp, fn = DIST_SERVE_F32
        part("decode_float32", lambda: torch.save(serve_decode_ref(
            model, f32, fb, fp, fn, length, seed=25, cache_dtype=torch.float32),
            os.path.join(ref_dir, "gemma3-4b_decode_f32.pt")))
    finally:
        model.cfg = cfg
    batch = batch_at_step(TokenStreamConfig(cfg.vocab_size, LM_PREFILL[1], LM_PREFILL[0], seed=0), 0)
    part("prefill", lambda: torch.save(serve_prefill_ref(model, cfg, batch),
                                       os.path.join(ref_dir, "gemma3-4b_prefill.pt")))
    # generate in float32 (its caches are float32 anyway), where its tokens
    # are not parted by bf16 order noise (PERF.md)
    model.cfg = f32
    try:
        part("generate", lambda: torch.save(serve_generate_ref(model, f32, ref_dir),
                                            os.path.join(ref_dir, "rag.pt")))
    finally:
        model.cfg = cfg
    torch.cuda.empty_cache()
    steps, length = DIST_SERVE_LONG
    part("long", lambda: torch.save(serve_long_ref(model, cfg, steps, length),
                                    os.path.join(ref_dir, "gemma3-4b_long.pt")))
    torch.cuda.empty_cache()
    s = time.perf_counter() - t0
    log("lm", f"dist_serve references of {cfg.name} on one device (decode B={b} {prompt}+{new}, "
        f"prefill B={LM_PREFILL[0]} T={LM_PREFILL[1]}, generate over N={DIST_SERVE_RAG['n']:,}, long "
        f"{steps} steps over {length:,} slots; each with its order-noise replay, the files written "
        f"to the run's temporary directory) in {s:.1f} s "
        f"({json.dumps({k: round(v, 1) for k, v in parts.items()})}) on {card}")
    return {"dist_serve_refs_s": s, "dist_serve_refs_parts_s": parts}


def serve_prefill_ref(model, cfg, batch: dict) -> dict:
    """One device's prefill of ``batch``: its logits and K/V on the host,
    and the largest distances of the same prefill under ``order_noise``."""
    prefill = make_prefill_step(cfg)
    res = prefill(model, batch)
    out = {"tokens": torch.from_numpy(batch["tokens"]), "logits": res["logits"].cpu(),
           "kv": [(k.cpu(), v.cpu()) for k, v in res["caches"]], "dtype": cfg.dtype}
    del res
    noisy = order_noise(model, lambda: prefill(model, batch))
    out["noise"] = float((noisy["logits"].cpu() - out["logits"]).abs().max())
    out["kv_noise"] = max([0.0] + [float((a.cpu().float() - b.float()).abs().max())
                                   for kv, ref in zip(noisy["caches"], out["kv"])
                                   for a, b in zip(kv, ref)])
    return out


def serve_kind_cfg(arch: str):
    """A kind's config in the dist_serve phase: its depth cut and its
    activation dtype by DIST_SERVE_KINDS."""
    depth, dtype = DIST_SERVE_KINDS[arch]
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=depth or cfg.n_layers, dtype=dtype or cfg.dtype)


def dist_serve_refs_kind(model, cfg, ref_dir: str, card: str) -> dict:
    """The lm_kinds phase's part of the dist_serve phase for one config:
    one device's decode (and for xlstm-350m prefill) references, in the
    activation dtype DIST_SERVE_KINDS gives (the same weights)."""
    t0 = time.perf_counter()
    b, prompt, new = DIST_SERVE_KINDS_DECODE
    name, own, cfg = cfg.name, model.cfg, serve_kind_cfg(cfg.name)
    with first_layers(model, cfg.n_layers):
        cut, model.cfg = model.cfg, cfg
        try:
            torch.save(serve_decode_ref(model, cfg, b, prompt, new, prompt + new, seed=22,
                                        cache_dtype=model.dtype),
                       os.path.join(ref_dir, f"{name}_decode.pt"))
        finally:
            model.cfg = cut
    if name == "xlstm-350m":
        pb, pt = DIST_SERVE_XLSTM_PREFILL
        batch = batch_at_step(TokenStreamConfig(own.vocab_size, pt, pb, seed=24), 0)
        torch.save(serve_prefill_ref(model, own, batch), os.path.join(ref_dir, f"{name}_prefill.pt"))
    s = time.perf_counter() - t0
    log("lm_kinds", f"dist_serve references of {name} on one device in {s:.1f} s on {card}")
    return {"dist_serve_refs_s": s}


@contextlib.contextmanager
def metered_collectives():
    """While the block runs, ``torch.distributed``'s ``all_reduce``,
    ``all_gather`` and ``reduce_scatter`` add each call's host-clock
    seconds (the card drained before and after) and its payload's bytes
    (all_reduce its tensor; all_gather its outputs; reduce_scatter its
    inputs) by kind to the yielded dict."""
    meter = {"s": 0.0, "calls": {}, "bytes": {}}
    saved = {}

    def payload(name, args):
        ts = args[0] if name == "all_reduce" else (args[0] if name == "all_gather" else args[1])
        ts = [ts] if isinstance(ts, torch.Tensor) else ts
        return sum(t.numel() * t.element_size() for t in ts)

    for name in ("all_reduce", "all_gather", "reduce_scatter"):
        real = saved[name] = getattr(torch.distributed, name)

        def metered(*args, _real=real, _name=name, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(*args, **kwargs)
            torch.cuda.synchronize()
            meter["s"] += time.perf_counter() - t0
            meter["calls"][_name] = meter["calls"].get(_name, 0) + 1
            meter["bytes"][_name] = meter["bytes"].get(_name, 0) + payload(_name, args)
            return out

        setattr(torch.distributed, name, metered)
    try:
        yield meter
    finally:
        for name, real in saved.items():
            setattr(torch.distributed, name, real)


def tree_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def serve_bar(scale: float, noise: float, dtype: str) -> float:
    """The bar a rank's output is held to: the LM tests' bar for the dtype
    (of the largest magnitude), or twice one device's own distance under
    a change of summation order (``order_noise``), the larger: at full
    depth in bf16 the latter passes the former (PERF.md, PR 23)."""
    return max(DIST_SERVE_BAR[dtype] * scale, 2.0 * noise)


def logits_held(got: torch.Tensor, ref: dict, rows: slice, what: str) -> dict:
    """The rank's greedy steps' logits (steps, rows, V) against one
    device's, within ``serve_bar``; its argmax equal to one device's token
    at every step whose one-device top-2 gap exceeds the bar (the others
    counted)."""
    want = ref["logits"][:, rows].to(got.device)
    scale = float(want.abs().max())
    bar = serve_bar(scale, ref["noise"], ref["dtype"])
    err = float((got - want).abs().max())
    require(err <= bar, f"{what}: logits max |err| {err} at scale {scale}, bar {bar}")
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > bar
    agree = torch.argmax(got, dim=-1).cpu() == ref["tokens"][:, rows]
    require(bool(agree[clear.cpu()].all()), f"{what}: a greedy token differs at a step whose "
            "one-device top-2 gap exceeds the bar")
    return {"max_abs_err": err, "scale": scale, "bar": bar, "noise": ref["noise"],
            "token_steps": int(agree.numel()), "tokens_equal": int(agree.sum()),
            "close_steps": int((~clear).sum()),
            "close_and_differ": int((~agree & ~clear.cpu()).sum())}


def serve_replay(mesh, kind: str, cfg, ref: dict, length: int, model=None, fill=None,
                 w8a16: bool = False) -> dict:
    """One rank's decode under ``kind``: the tokens one device was fed,
    replayed on this rank's rows into caches of ``length`` (filled by
    ``fill(caches, shard)`` first when given), each step timed on the host
    clock after a sync; its greedy steps' logits and tokens held to one
    device's (``logits_held``); the MoE's dropped pairs each step; then
    the last step again with its collectives metered.  With ``w8a16`` the
    rank's linears are drawn whole, quantised, then cut.  Returns the
    readings and the model (for the next run on the same layout)."""
    dev = mesh.device
    layout = make_layout(kind, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if model is None:
        model = zoo.init_params(cfg, torch.Generator(dev).manual_seed(0), layout=layout,
                                w8a16=w8a16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fed = ref["fed"]
    b = fed.shape[0]
    rows = model.shard.batch.block(b)
    if ref["handover"]:  # this rank's blocks of one device's caches after the prompt
        caches = [{k: v.to(dev) for k, v in c.items()} for c in cache_blocks(
            cfg, torch.load(ref["handover"], mmap=True), layout)]
    else:
        caches = model.init_caches(b, length, ref["cache_dtype"])
    if fill is not None:
        fill(caches, model.shard)
    step = make_serve_step(cfg, layout=layout)
    fed = fed[rows].to(dev)
    lat, logits = [], []
    with routings(model) as seen:
        for t in range(fed.shape[1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = step(model, caches, fed[:, t:t + 1], ref["pos0"] + t)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if t >= ref["first"]:
                logits.append(r["logits"][:, 0])
    drops = kept_pairs(seen)
    out = logits_held(torch.stack(logits), ref, rows, f"dist_serve {cfg.name} {kind} {mesh.shape}")
    if ref["drops"]:
        require(len(drops) == len(ref["drops"]) and all(
            torch.equal(a, b) for a, b in zip(drops, ref["drops"])),
            f"dist_serve {cfg.name}: the routed and dropped pairs differ from one device's")
        out["drops"] = {"routings": len(drops), "pairs": sum(d.numel() for d in drops),
                        "dropped": sum(int((d < 0).sum()) for d in drops)}
    t = fed.shape[1] - 1
    with metered_collectives() as meter:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, caches, fed[:, t:t + 1], ref["pos0"] + t)
        torch.cuda.synchronize()
        inst = time.perf_counter() - t0
    out.update(init_s=init_s, steps=len(lat), ms_step=float(np.median(lat[1:])) * 1e3,
               ms_first=lat[0] * 1e3, instrumented_ms=inst * 1e3,
               collective_share=meter["s"] / inst, collective_calls=meter["calls"],
               collective_bytes=meter["bytes"],
               param_bytes=tree_bytes(model.parameters()),
               cache_bytes=tree_bytes(v for c in caches for v in c.values()),
               peak_bytes=torch.cuda.max_memory_allocated())
    del caches
    return out, model


def serve_prefill(mesh, cfg, ref: dict) -> dict:
    """One rank's prefill under the (2, 2) ``prefill`` layout: ZeRO-stored
    parameters drawn a leaf at a time, one step on the whole batch of
    ``ref`` (timed once, after a sync), its rows' logits held to one
    device's, its (rows, sequence) K/V blocks likewise."""
    dev = mesh.device
    layout = make_layout("prefill", mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = zoo.init_params(cfg, torch.Generator(dev).manual_seed(0), layout=layout)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stored = tree_bytes(params.blocks.values())
    step = make_prefill_step(cfg, layout=layout)
    tokens = ref["tokens"].numpy()
    with metered_collectives() as meter:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    b, t = tokens.shape
    rows, seq = params.shard.batch.block(b), params.shard.seq.block(t)
    want = ref["logits"][rows].to(dev)
    scale = float(want.abs().max())
    err = float((res["logits"] - want).abs().max())
    bar = serve_bar(scale, ref["noise"], ref["dtype"])
    require(err <= bar, f"dist_serve {cfg.name} prefill: logits max |err| {err}, bar {bar}")
    kv_err, kv_scale = 0.0, 0.0
    require(len(res["caches"]) == len(ref["kv"]), f"dist_serve {cfg.name} prefill: caches")
    for (k, v), (wk, wv) in zip(res["caches"], ref["kv"]):
        for g, w in ((k, wk), (v, wv)):
            w = w[rows, seq].to(dev).float()
            kv_err = max(kv_err, float((g.float() - w).abs().max()))
            kv_scale = max(kv_scale, float(w.abs().max()))
    kv_bar = serve_bar(max(kv_scale, 1.0), ref["kv_noise"], ref["dtype"])
    require(kv_err <= kv_bar, f"dist_serve {cfg.name} prefill: K/V blocks max |err| {kv_err} at "
            f"scale {kv_scale}, bar {kv_bar}")
    return {"init_s": init_s, "s": secs, "B": b, "T": t, "logits_max_abs_err": err,
            "logits_scale": scale, "logits_bar": bar, "noise": ref["noise"],
            "kv_max_abs_err": kv_err, "kv_scale": kv_scale, "kv_bar": kv_bar,
            "kv_noise": ref["kv_noise"],
            "gathered_bytes": params.gathered_bytes, "stored_bytes": stored,
            "collective_share": meter["s"] / secs, "collective_calls": meter["calls"],
            "collective_bytes": meter["bytes"], "peak_bytes": torch.cuda.max_memory_allocated()}


def serve_generate(mesh, cfg, model, ref_dir: str) -> dict:
    """``RAGServer(..., layout=decode)`` on this rank: its own engine loaded
    from the phase's index file, the tokens equal to one device's
    ``generate``; its kernel launches counted from 0."""
    eng, q, targets = serve_rag_engine(ref_dir)
    srv, reqs = serve_rag_server(eng, cfg, model, q, targets, make_layout("decode", mesh))
    ref = torch.load(os.path.join(ref_dir, "rag.pt"))
    want = ref["tokens"].numpy()
    torch.cuda.synchronize()
    _build.reset_launches()
    PLAIN_MERGES[0] = 0
    t0 = time.perf_counter()
    toks, _ = srv.generate(reqs, max_new_tokens=DIST_SERVE_RAG["new"])
    secs = time.perf_counter() - t0
    launches = {**_build.LAUNCHES, "plain_merges": PLAIN_MERGES[0]}
    # each row's tokens equal one device's up to its first step whose
    # one-device top-2 gap is within the bar (after it the rows may part)
    held = 0
    for r, close in enumerate(ref["close"].numpy()):
        upto = int(np.argmax(close)) if close.any() else len(close)
        require(np.array_equal(toks[r, :upto], want[r, :upto]),
                f"dist_serve generate: row {r} {toks[r].tolist()} vs one device's "
                f"{want[r].tolist()} before its first close step {upto}")
        held += upto
    return {"s": secs, "launches": launches, "requests": len(reqs), "tokens_held": held,
            "tokens_equal": int((toks == want).sum()), "tokens": int(want.size),
            "bar": ref["bar"], "scale": ref["scale"],
            "prompt_len": DIST_SERVE_RAG["k"] * DIST_SERVE_RAG["passage"] + DIST_SERVE_RAG["prompt"],
            "new": DIST_SERVE_RAG["new"]}


def dist_serve_rank(mesh, ref_dir: str) -> dict:
    """One rank of the dist_serve phase: (1, 4) gemma3-4b decode and
    ``generate``, the kinds' decode; then (2, 2) gemma3-4b long and prefill
    and xlstm-350m prefill.  Every check is made here, against one
    device's files under ``ref_dir``; the readings come back."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    watch_plain_merges()
    load = lambda name, **kw: torch.load(os.path.join(ref_dir, name), **kw)  # noqa: E731
    out = {"rank": mesh.rank}
    t_rank = time.perf_counter()

    def done(name):
        if mesh.rank == 0:
            r = out[name]
            log("dist_serve", f"rank 0: {name} at {time.perf_counter() - t_rank:.1f} s: "
                + ", ".join(f"{k} {r[k]:.4g}" for k in ("ms_step", "s", "max_abs_err", "bar",
                                                          "logits_max_abs_err", "logits_bar")
                            if k in r))
    gemma = dataclasses.replace(get_config(LM_ARCH), n_layers=DIST_SERVE_GEMMA_DEPTH)
    b, prompt, new, length = DIST_SERVE_DECODE
    out["gemma3-4b decode"], model = serve_replay(mesh, "decode", gemma,
                                                  load("gemma3-4b_decode.pt"), length)
    done("gemma3-4b decode")
    # the float32 twin on the same blocks: float32 activations and caches
    model.cfg = f32 = dataclasses.replace(gemma, dtype="float32")
    out["gemma3-4b decode float32"], _ = serve_replay(mesh, "decode", f32,
                                                      load("gemma3-4b_decode_f32.pt"), length, model)
    done("gemma3-4b decode float32")
    out["generate"] = serve_generate(mesh, f32, model, ref_dir)
    done("generate")
    model.cfg = gemma
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # w8a16 weights under the decode layout, float32, at the lm_variants depth
    w8 = dataclasses.replace(gemma, n_layers=LM_VARIANTS_DEPTH, dtype="float32")
    out["gemma3-4b w8a16 decode float32"], model = serve_replay(
        mesh, "decode", w8, load("gemma3-4b_w8a16_decode_f32.pt"), length, w8a16=True)
    out["gemma3-4b w8a16 decode float32"].update(w8_held(model))
    done("gemma3-4b w8a16 decode float32")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for arch in DIST_SERVE_KINDS:
        cfg = serve_kind_cfg(arch)
        out[f"{arch} decode"], model = serve_replay(mesh, "decode", cfg, load(f"{arch}_decode.pt"),
                                                    sum(DIST_SERVE_KINDS_DECODE[1:]))
        done(f"{arch} decode")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    mesh22 = mesh.reshape((2, 2))
    steps, length = DIST_SERVE_LONG
    out["gemma3-4b long"], model = serve_replay(
        mesh22, "long", gemma, load("gemma3-4b_long.pt"), length,
        fill=lambda caches, shard: fill_long(caches, gemma, shard, length - steps, length))
    done("gemma3-4b long")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["gemma3-4b prefill"] = serve_prefill(mesh22, gemma, load("gemma3-4b_prefill.pt", mmap=True))
    done("gemma3-4b prefill")
    gc.collect()
    torch.cuda.empty_cache()
    xlstm = dataclasses.replace(get_config("xlstm-350m"),
                                n_layers=DIST_SERVE_KINDS["xlstm-350m"][0])
    out["xlstm-350m prefill"] = serve_prefill(mesh22, xlstm, load("xlstm-350m_prefill.pt"))
    done("xlstm-350m prefill")
    return out


def dist_serve_phase(ref_dir: str, card: str, cap: Capture) -> dict:
    """The serving layouts executed on a mesh of 4 gloo ranks sharing the
    card (the module docstring's dist_serve), against one device's runs
    saved by the lm and lm_kinds phases under ``ref_dir``."""
    t_phase = time.perf_counter()
    b, prompt, new, length = DIST_SERVE_DECODE
    rag = DIST_SERVE_RAG
    log("dist_serve", f"CUT: the phase runs gemma3-4b at full width with its depth cut from "
        f"{get_config(LM_ARCH).n_layers} to {DIST_SERVE_GEMMA_DEPTH} layers, and "
        f"recurrentgemma-9b's decode from {get_config('recurrentgemma-9b').n_layers} to "
        f"{DIST_SERVE_KINDS['recurrentgemma-9b'][0]}, xlstm-350m's decode and prefill from "
        f"{get_config('xlstm-350m').n_layers} to {DIST_SERVE_KINDS['xlstm-350m'][0]}, for the "
        "whole smoke's time (PERF.md)")
    log("dist_serve", f"CUT: gemma3-4b decode's {prompt}-token prompt is teacher-forced on one "
        f"device and each rank starts from its blocks of those caches (cache_blocks); the {new} "
        "greedy steps run sharded (each step costs about 200 collectives, 6-8 ms each with 4 "
        "processes sharing the card: PERF.md)")
    log("dist_serve", f"CUT: generate's prompts are {rag['k']} hits of {rag['passage']}-token "
        f"passages and {rag['prompt']} tokens (4 hits of 16 and 8 asked for), {rag['new']} new "
        "tokens: it teacher-forces the prompt through the sharded decode")
    ranks = spawn_local(dist_serve_rank, (1, 4), backend="gloo", device="cuda:0",
                        timeout_s=DIST_SERVE_TIMEOUT_S, args=(ref_dir,))
    wall = time.perf_counter() - t_phase
    cap.launches["dist_serve_generate"] = {}
    for r in ranks:
        for k, v in r["generate"]["launches"].items():
            cap.launches["dist_serve_generate"][k] = cap.launches["dist_serve_generate"].get(k, 0) + v
    require_launches(cap, "dist_serve_generate", ("pq_lookup", "rerank"),
                     ("fused_traversal", "l2_dist", "plain_merges"))
    runs = {}
    for name in [k for k in ranks[0] if k not in ("rank", "generate")]:
        rows = [r[name] for r in ranks]
        runs[name] = {"ranks": rows}
        r0 = rows[0]
        mesh = "(2, 2)" if ("long" in name or "prefill" in name) else "(1, 4)"
        if "prefill" in name:
            log("dist_serve", f"{name} on {mesh} (B={r0['B']} T={r0['T']}, ZeRO-stored parameters "
                f"gathered a layer at a time): {max(r['s'] for r in rows):.2f} s a step (one call, "
                f"the slowest rank); logits within {max(r['logits_max_abs_err'] for r in rows):.3g} "
                f"of one device's (scale {r0['logits_scale']:.3g}; one device's own distance under "
                f"another summation order {r0['noise']:.3g}; bar {r0['logits_bar']:.3g}), K/V "
                f"blocks within {max(r['kv_max_abs_err'] for r in rows):.3g} (scale "
                f"{r0['kv_scale']:.3g}, order noise {r0['kv_noise']:.3g}, bar {r0['kv_bar']:.3g}); "
                f"a rank stores "
                f"{r0['stored_bytes'] / 1e9:.2f} GB and gathers {r0['gathered_bytes'] / 1e9:.2f} GB; "
                f"collectives {max(r['collective_share'] for r in rows):.1%} of the step "
                f"({json.dumps(r0['collective_calls'])} calls, bytes {json.dumps(r0['collective_bytes'])}"
                f"); peak {max(r['peak_bytes'] for r in rows) / 2**30:.2f} GiB a rank; drawn in "
                f"{max(r['init_s'] for r in rows):.1f} s on {card}")
            continue
        log("dist_serve", f"{name} on {mesh}: {max(r['ms_step'] for r in rows):.1f} ms a step "
            f"(median of {r0['steps'] - 1}, the slowest rank; first {r0['ms_first']:.0f} ms); "
            f"greedy logits within {max(r['max_abs_err'] for r in rows):.3g} of one device's "
            f"(scale {r0['scale']:.3g}; one device's own distance under another summation "
            f"order {r0['noise']:.3g}; bar {r0['bar']:.3g}), tokens equal at "
            f"{min(r['tokens_equal'] for r in rows)} of {r0['token_steps']} row-steps "
            f"({max(r['close_and_differ'] for r in rows)} differ, all at steps whose one-device "
            f"top-2 gap is under the bar: {max(r['close_steps'] for r in rows)} such); "
            f"collectives {max(r['collective_share'] for r in rows):.1%} of an instrumented step "
            f"({r0['instrumented_ms']:.1f} ms; calls {json.dumps(r0['collective_calls'])}, bytes "
            f"{json.dumps(r0['collective_bytes'])}); a rank holds {r0['param_bytes'] / 1e9:.2f} GB "
            f"of parameters and {r0['cache_bytes'] / 1e9:.3f} GB of caches, peak "
            f"{max(r['peak_bytes'] for r in rows) / 2**30:.2f} GiB; drawn in "
            f"{max(r['init_s'] for r in rows):.1f} s"
            + (f"; MoE drops {json.dumps(r0['drops'])} == one device's" if "drops" in r0 else "")
            + f" on {card}")
    w8 = [r["gemma3-4b w8a16 decode float32"] for r in ranks]
    log("dist_serve", f"gemma3-4b w8a16 decode on (1, 4) ({LM_VARIANTS_DEPTH} layers, float32, "
        f"against the lm_variants phase's one-device w8a16 run): a rank holds "
        f"{w8[0]['codes_bytes'] / 1e9:.3f} GB of int8 codes and {w8[0]['scales_bytes'] / 1e6:.3f} MB "
        f"of float32 scales, {(w8[0]['codes_bytes'] + w8[0]['scales_bytes']) / w8[0]['float32_bytes']:.3f} "
        f"of the same weights in float32 ({w8[0]['float32_bytes'] / 1e9:.3f} GB); "
        f"{max(r['ms_step'] for r in w8):.1f} ms a step; collectives a step "
        f"{json.dumps(w8[0]['collective_calls'])}, bytes {json.dumps(w8[0]['collective_bytes'])} "
        f"on {card}")
    g = ranks[0]["generate"]
    runs["generate"] = {"ranks": [r["generate"] for r in ranks], "launches": cap.launches["dist_serve_generate"]}
    log("dist_serve", f"RAGServer(..., layout=decode) on (1, 4), float32 activations, "
        f"{g['requests']} requests over "
        f"N={DIST_SERVE_RAG['n']:,} (each rank its own engine loaded from one file; prompts of "
        f"{g['prompt_len']} tokens, {g['new']} new): {g['tokens_equal']} of {g['tokens']} "
        f"tokens equal one device's generate, every one of the {g['tokens_held']} before a row's "
        f"first step whose one-device top-2 gap is within the bar ({g['bar']:.3g} at logits of "
        f"{g['scale']:.3g}); "
        f"{max(r['generate']['s'] for r in ranks):.1f} s; launches "
        f"{json.dumps(cap.launches['dist_serve_generate'])} on {card}")
    out = {"runs": runs, "spawn_to_join_s": wall, "phase_s": time.perf_counter() - t_phase}
    log("dist_serve", f"phase {out['phase_s']:.1f} s (one spawn of 4 ranks: (1, 4), then (2, 2)) "
        f"on {card}")
    print(json.dumps({"dist_serve": out, "card": card}), flush=True)
    return out


def w8_held(model) -> dict:
    """A rank's w8a16 linears: its code and scale bytes (a stacked leaf's
    rows of scales counted once) beside the same weights in float32."""
    codes, scales, seen = 0, 0, set()
    for m in model.modules():
        if isinstance(m, Linear) and m.w is None:
            codes += m.w_q.numel()
            if id(m.w_s) not in seen:
                seen.add(id(m.w_s))
                scales += m.w_s.numel() * m.w_s.element_size()
    return {"codes_bytes": codes, "scales_bytes": scales, "float32_bytes": 4 * codes}


def dist_serve_refs_w8a16(ref_dir: str, card: str) -> dict:
    """The lm_variants phase's part of the dist_serve phase: one device's
    float32 decode of gemma3-4b at the lm_variants depth with w8a16
    weights (``init_params(..., w8a16=True)``), saved for the ranks."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_VARIANTS_DEPTH, dtype="float32")
    model = zoo.init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda", w8a16=True)
    b, prompt, new = DIST_SERVE_W8
    torch.save(serve_decode_ref(model, cfg, b, prompt, new, DIST_SERVE_DECODE[3], seed=29,
                                cache_dtype=torch.float32),
               os.path.join(ref_dir, "gemma3-4b_w8a16_decode_f32.pt"))
    del model
    torch.cuda.empty_cache()
    s = time.perf_counter() - t0
    log("lm_variants", f"dist_serve reference: {cfg.name} w8a16 at {cfg.n_layers} layers, float32, "
        f"decode B={b} {prompt}+{new} on one device, saved in {s:.1f} s on {card}")
    return {"dist_serve_ref_s": s}


def dist_serve_references(ref_dir: str, card: str) -> None:
    """The dist_serve phase's one-device references without the lm and
    lm_kinds phases (the phase run alone): each model drawn, its
    references saved, freed."""
    dev = torch.device("cuda")
    gemma = dataclasses.replace(get_config(LM_ARCH), n_layers=DIST_SERVE_GEMMA_DEPTH)
    model = zoo.init_params(gemma, torch.Generator("cuda").manual_seed(0), device=dev)
    dist_serve_refs_gemma(model, gemma, ref_dir, card)
    del model
    torch.cuda.empty_cache()
    for arch, (depth, _) in DIST_SERVE_KINDS.items():
        cfg = get_config(arch)
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        model = zoo.init_params(cfg, torch.Generator("cuda").manual_seed(0), device=dev)
        dist_serve_refs_kind(model, cfg, ref_dir, card)
        del model
        torch.cuda.empty_cache()
    dist_serve_refs_w8a16(ref_dir, card)


# ------------------------------------------------------------- the dryrun phase
def dryrun_cells(cells: tuple, multi_pod: bool, device: str, retrieval: tuple) -> dict:
    """In a spawned child (a fake world of the production mesh's size, this
    process rank 0): each cell's ``launch.dryrun.plan_cell`` report on
    ``device``, then ``plan_retrieval`` in each of ``retrieval``'s
    modes."""
    torch.set_num_threads(2)
    out = {}
    for arch, shape, w8 in cells:
        if shape == "train_4k":  # the CUT of DRYRUN_TRAIN_T
            shape = dataclasses.replace(TRAIN_4K, name=f"train_4k_t{DRYRUN_TRAIN_T}",
                                        seq_len=DRYRUN_TRAIN_T)
        rep = dryrun.plan_cell(arch, shape, multi_pod=multi_pod, device=device, w8a16=w8)
        out[f"{arch} {rep['shape']}" + (" w8a16" if w8 else "")] = rep
    for mode in retrieval:
        out[f"retrieval {mode}"] = dryrun.plan_retrieval(multi_pod=multi_pod, mode=mode,
                                                         device=device)
    return out


def dryrun_phase(card: str) -> dict:
    """``launch.dryrun``: (a) cells of every kind planned on the meta
    device on both production meshes, (b) one rank of gemma3-4b's serving
    cells and the retrieval cell run on the card in the same fake world,
    each held to its meta plan: the same collectives by kind, count and
    bytes, and a peak at least the plan's argument bytes.  Every child
    runs at once, each on its deadline."""
    import concurrent.futures

    t_phase = time.perf_counter()
    log("dryrun", f"CUT: xlstm-350m's train_4k cell is planned at T = {DRYRUN_TRAIN_T} (global "
        f"batch 256 kept): its eager sLSTM scan costs about 0.4 s a step to trace on the CPU "
        f"(the full cell: python -m repro_torch.launch.dryrun; PERF.md)")
    first, second = DRYRUN_META
    first_3d = (first[0], (DRYRUN_META_3D_PREFILL,) + first[1][1:])
    jobs = [("16x16", (first, False, "meta", ())), ("16x16", (second, False, "meta", ("gate", "post"))),
            ("2x16x16", (first_3d, True, "meta", ())),
            ("2x16x16", (second, True, "meta", ("gate", "post"))),
            ("card", (DRYRUN_CARD, False, "cuda", ("gate",)))]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = [(k, pool.submit(dryrun.in_child, dryrun_cells, *v, timeout_s=DRYRUN_TIMEOUT_S))
                for k, v in jobs]
        got: dict = {}
        for k, f in futs:
            got.setdefault(k, {}).update(f.result())
    wall = time.perf_counter() - t_phase
    for mesh in ("16x16", "2x16x16"):
        for name, r in got[mesh].items():
            coll = {k: f"{r['collective_counts'][k]} x / {v / 1e6:.3f} MB"
                    for k, v in r["collective_bytes_per_device"].items()}
            log("dryrun", f"(a) {name} on {mesh} ({r.get('layout', 'retrieve')}"
                f"{' ' + r['variant'] if r.get('variant', 'default') != 'default' else ''}, meta): "
                f"arguments {r['argument_size_in_bytes'] / 2**30:.3f} GiB a rank (largest; "
                f"smallest {r['argument_size_in_bytes_min'] / 2**30:.3f}), "
                f"{r['flops_per_device']:.4g} flops, {r['hbm_bytes_per_device'] / 1e9:.4g} GB unfused "
                f"HBM bytes, collectives {json.dumps(coll)}; traced in {r['trace_s']:.1f} s")
    b, w, d = 256 // 16, 8, 128 + 96  # a hop's fetch: (rows, W, D + R) float32 over 16 ranks
    for mesh, rows in (("16x16", b), ("2x16x16", b // 2)):
        r = got[mesh]["retrieval gate"]
        want = 48 * 2 * rows * w * d * 4 * 15 / 16
        require(r["collective_counts"] == {"all-reduce": 48} and r["collective_bytes_total"] == want,
                f"dryrun (a) retrieval on {mesh}: {r['collective_counts']} "
                f"{r['collective_bytes_total']} (48 all-reduces of {want / 48:.0f} B expected)")
    for name, c in got["card"].items():
        m = got["16x16"][name]
        require(c["collective_counts"] == m["collective_counts"]
                and c["collective_bytes_per_device"] == m["collective_bytes_per_device"],
                f"dryrun (b) {name}: the card's collectives {c['collective_counts']} differ from "
                f"the meta plan's {m['collective_counts']}")
        require(c["peak_bytes"] >= c["argument_size_in_bytes_rank"] == m["argument_size_in_bytes_rank"],
                f"dryrun (b) {name}: peak {c['peak_bytes']} below the plan's argument bytes "
                f"{c['argument_size_in_bytes_rank']}")
        log("dryrun", f"(b) {name} rank 0 of 16 x 16 on the card: peak {c['peak_bytes'] / 2**30:.2f} "
            f"GiB of the card's {CARD_BYTES / 1e9:.0f} GB ({c['peak_bytes'] / CARD_BYTES:.1%}; the "
            f"plan's arguments {c['argument_size_in_bytes_rank'] / 2**30:.2f} GiB), step "
            f"{c['step_s']:.2f} s ({c['step_note']}); collectives == the meta plan's "
            f"{json.dumps(c['collective_counts'])} on {card}")
    out = {"meta": {k: got[k] for k in ("16x16", "2x16x16")}, "card": got["card"],
           "phase_s": time.perf_counter() - t_phase, "children_wall_s": wall}
    log("dryrun", f"phase {out['phase_s']:.1f} s ({len(jobs)} children at once, each on a "
        f"{DRYRUN_TIMEOUT_S} s deadline) on {card}")
    print(json.dumps({"dryrun": out, "card": card}), flush=True)
    return out


# ---------------------------------------------------------------- phase 6
def scan_topk(lut, codes, labels, targets, k: int = 10):
    """Brute-force filtered PQ search: every code scored, non-matching
    labels sent to the pad distance, then the top-k of each chunk of
    SCAN_CHUNK codes and the top-k of those."""
    d = pqm.adc_lookup(lut, codes)
    d = torch.where(labels[None] == targets[:, None], d, tkk.PAD_DIST)
    b, n = d.shape
    chunks = n // SCAN_CHUNK
    cd, ci = kops.topk_merge(d[:, : chunks * SCAN_CHUNK].reshape(-1, SCAN_CHUNK).contiguous(),
                             torch.arange(chunks * SCAN_CHUNK, dtype=torch.int32, device=d.device)
                             .repeat(b).reshape(-1, SCAN_CHUNK), k)
    cd, ci = cd.reshape(b, -1), ci.reshape(b, -1)
    if chunks * SCAN_CHUNK < n:  # the ragged tail joins the second level as it is
        cd = torch.cat([cd, d[:, chunks * SCAN_CHUNK:]], dim=1)
        ci = torch.cat([ci, torch.arange(chunks * SCAN_CHUNK, n, dtype=torch.int32,
                                         device=d.device).expand(b, -1)], dim=1)
    return kops.topk_merge(cd.contiguous(), ci.contiguous(), k)


def scan_phase(eng, q, targets, gt, card: str, cap: Capture) -> None:
    """The brute-force PQ baseline through ``pq.adc_lookup`` and
    ``kernels.ops.topk_merge`` on the engine's PQ codes."""
    labels = eng.filters["label"].labels
    lut = pqm.build_lut(eng.codec, q)
    torch.cuda.synchronize()
    _build.reset_launches()
    ids, lat = [], []
    with cap:  # records the scan's and the merge's inputs for the kernels line
        for s in range(0, q.shape[0], SCAN_BATCH):
            t0 = time.perf_counter()
            _, got = scan_topk(lut[s:s + SCAN_BATCH].contiguous(), eng.codes, labels,
                               targets[s:s + SCAN_BATCH])
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            ids.append(got)
    cap.launches["pq_scan_topk"] = dict(_build.LAUNCHES)
    require_launches(cap, "pq_scan_topk", ("pq_scan", "topk_merge"),
                     ("pq_lookup", "l2_dist", "rerank", "fused_traversal"))
    ids = torch.cat(ids)
    # the same function from the plain versions on the card, for one batch
    b0 = slice(0, SCAN_BATCH)
    d = pqk.pq_scan_ref(lut[b0], eng.codes)
    d = torch.where(labels[None] == targets[b0, None], d, tkk.PAD_DIST)
    want = tkk.topk_merge_ref(d, torch.arange(d.shape[1], dtype=torch.int32, device=d.device)
                              .expand(SCAN_BATCH, -1).contiguous(), 10)[1]
    same(ids[b0], want, "scan path vs plain versions")
    rec = recall_at_k(ids, gt, 10)
    lat = np.asarray(lat)
    log("scan", f"brute-force PQ scan of {eng.codes.shape[0]:,} codes + two-level topk_merge: "
        f"recall@10 {rec:.4f} (PQ distances only), {q.shape[0] / float(lat.sum()):.1f} QPS, "
        f"batch of {SCAN_BATCH} p50 {np.percentile(lat, 50) * 1e3:.2f} ms; launches "
        f"{json.dumps(cap.launches['pq_scan_topk'])}; first batch == plain versions on {card}")


def profile_batch(run, p50_ms: float, top: int = 8, parts: tuple = ()) -> dict:
    """Where one batch's time goes, from ``torch.profiler``: summed kernel
    time on the card and the kernels with the most device time, for one
    call of ``run()``.  The busy share divides the kernel time by the
    path's unprofiled p50 batch latency ``p50_ms``; the profiled wall time
    is inflated by the profiler's own host cost, so the share of it is
    reported apart.  ``parts`` names ``record_function`` ranges that
    ``run`` opens: the device time of the kernels each launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel, per_part = {}, {}  # kernels whose names share their first 60 characters are summed
    for e in prof.key_averages():
        if e.key in parts:  # a range, not a kernel: its host event holds its kernels' time
            if e.device_type == torch.autograd.DeviceType.CPU:
                per_part[e.key] = [round(e.device_time_total / 1e3, 4), e.count]
            continue
        us = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:  # kernels, not host ops
            ms, n = per_kernel.get(e.key[:60], (0.0, 0))
            per_kernel[e.key[:60]] = (ms + us / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms, "unprofiled_p50_ms": p50_ms,
           "device_launches": sum(n for _, n in per_kernel.values()),
           "device_busy_share": busy_ms / p50_ms if busy_ms else None,
           "busy_share_of_profiled_wall": busy_ms / wall_ms if busy_ms else None,
           "top_kernels_ms_calls": {k: [round(ms, 4), n] for k, (ms, n) in ranked}}
    if parts:
        out["parts_device_ms_calls"] = per_part
    return out


# ------------------------------------------------------------ the host tier
def host_phase(path: str, q, targets, mem_runs: dict, card: str, cap: Capture) -> dict:
    """The memory tier's queries on the host tier (``store_tier="host"``:
    the records in pinned host memory, gathered on the host and uploaded
    through ``PinnedStaging``), each run equal to the memory tier bit for
    bit; one gate batch profiled, with the bytes it moved host to device."""
    from repro_torch.store import HostOffloadRecordStore
    from repro_torch.store.staging import PinnedStaging

    t0 = time.perf_counter()
    eng = GateANNEngine.load(path, store_tier="host")
    load_s = time.perf_counter() - t0
    store = eng.record_store
    require(isinstance(store, HostOffloadRecordStore), f"host tier: {type(store).__name__}")
    require(store.vectors.is_pinned() and store.neighbors.is_pinned(),
            "host tier: the records are not in pinned memory")
    pinned = store.vectors.nbytes + store.neighbors.nbytes
    log("host", f"host tier: {store.vectors.shape[0]:,} records, {pinned / 2**20:.0f} MiB pinned "
        f"(vectors {tuple(store.vectors.shape)} f32, neighbours {tuple(store.neighbors.shape)} "
        f"i32), loaded in {load_s:.1f} s")
    configs = {  # name -> (config, the memory-tier run it must equal)
        "host_gate_unfused": (SearchConfig(mode="gate", **SEARCH), "gate_unfused"),
        "host_gate_fused": (SearchConfig(mode="gate", use_fused_kernel=True, **SEARCH),
                            "gate_fused"),
        "host_post": (SearchConfig(mode="post", **SEARCH), "post"),
    }
    summary = {"load_s": load_s, "pinned_bytes": pinned}
    for name, (cfg, mem_name) in configs.items():
        eng.search(q[:BATCH], filter_kind="label", filter_params=targets[:BATCH],
                   search_config=cfg)  # warm-up, untimed
        run = run_search(eng, q, targets, cfg)
        cap.launches[name] = run[4]
        same_run(run, mem_runs[mem_name], f"{name} vs memory tier {mem_name}")
        fused = cfg.use_fused_kernel
        require_launches(cap, name, ("pq_lookup", "rerank") + (("fused_traversal",) if fused else ()),
                         ("l2_dist", "plain_merges") + (() if fused else ("fused_traversal",)))
        lat, st = run[3], run[2]
        summary[name] = {"qps": N_QUERIES / float(lat.sum()),
                         "p50_batch_ms": float(np.percentile(lat, 50) * 1e3),
                         "p99_batch_ms": float(np.percentile(lat, 99) * 1e3),
                         "mean_n_ios": float(st["n_ios"].float().mean()), "launches": run[4]}
        r = summary[name]
        log("host", f"{name}: QPS {r['qps']:.1f}  batch p50 {r['p50_batch_ms']:.2f} ms p99 "
            f"{r['p99_batch_ms']:.2f} ms  mean n_ios {r['mean_n_ios']:.2f}  launches "
            f"{json.dumps(run[4])}; == memory tier {mem_name} (ids, dists, six stats) on {card}")
    # one gate batch: the bytes its fetches upload, and its rounds
    uploads, real_upload = [0, 0], PinnedStaging.upload

    def counted(self, buf):
        uploads[0] += buf.numel() * buf.element_size()
        uploads[1] += 1
        return real_upload(self, buf)

    cfg = configs["host_gate_unfused"][0]
    PinnedStaging.upload = counted
    try:
        out = eng.search(q[:BATCH], filter_kind="label", filter_params=targets[:BATCH],
                         search_config=cfg)
        torch.cuda.synchronize()
    finally:
        PinnedStaging.upload = real_upload
    rounds = int(out.stats.n_hops.max())
    gate = summary["host_gate_unfused"]
    gate["h2d_bytes_batch"], gate["h2d_copies_batch"], gate["rounds_batch"] = uploads[0], uploads[1], rounds
    gate["h2d_bytes_round"] = uploads[0] / rounds
    gate["profile"] = profile_batch(
        lambda: eng.search(q[:BATCH], filter_kind="label", filter_params=targets[:BATCH],
                           search_config=cfg), gate["p50_batch_ms"])
    prof = gate["profile"]
    log("host", f"host_gate_unfused, one batch of {BATCH}: {uploads[0]:,} B host to device in "
        f"{uploads[1]} copies over {rounds} rounds ({gate['h2d_bytes_round']:,.0f} B a round: "
        f"a round's W = {SEARCH['beam_width']} records a query, {DIM} f32 + {DEGREE} i32 each); "
        f"profiled: {prof['device_busy_ms']:.2f} ms of kernels, {prof['device_launches']} launches, "
        f"busy {prof['device_busy_share']:.3f} of the unprofiled p50 {gate['p50_batch_ms']:.2f} ms "
        f"on {card}")
    log("profile", f"host_gate_unfused, one batch of {BATCH} under torch.profiler on {card}: "
        + json.dumps(prof))
    print(json.dumps({"host": summary, "card": card}), flush=True)
    del eng, store
    gc.collect()
    return summary


# -------------------------------------------------------------- the cli phase
CLI_ENTRIES = {  # name -> the port's entry point, beside the reference's
    "convert_index": "scripts/torch_convert_index.py",
    "quickstart": "examples/torch_quickstart.py",
    "filtered_search_demo": "examples/torch_filtered_search_demo.py",
    "rag_serve": "examples/torch_rag_serve.py",
    "train_lm": "examples/torch_train_lm.py",
    "obs_report": "scripts/torch_obs_report.py",
    "smoke_core": "scripts/torch_smoke_core.py",
    "diag_recall": "scripts/torch_diag_recall.py",
    "smoke_models": "scripts/torch_smoke_models.py",
}


def load_entry(name: str):
    """An entry point as a module, loaded by path (its ``main`` does not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"cli_{name}", REPO / CLI_ENTRIES[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Tee(io.TextIOBase):
    """Standard output passed through and kept."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text: str) -> int:
        self.out.write(text)
        self.kept.write(text)
        return len(text)

    def flush(self) -> None:
        self.out.flush()


@contextlib.contextmanager
def counted_path(cap: Capture, path: str):
    """The kernel launches inside the block, counted from 0 under
    ``cap.launches[path]`` with its plain merges; ``pq_lookup`` and
    ``rerank`` must have launched and the plain merge not."""
    torch.cuda.synchronize()
    _build.reset_launches()
    PLAIN_MERGES[0] = 0
    yield
    torch.cuda.synchronize()
    cap.launches[path] = {**_build.LAUNCHES, "plain_merges": PLAIN_MERGES[0]}
    require_launches(cap, path, ("pq_lookup", "rerank"), ("plain_merges",))


def run_entry(mod, argv: list, cap: Capture | None = None, path: str | None = None):
    """``mod.main(argv)`` on the card: its result and what it printed;
    with ``path``, its launches counted there (``counted_path``)."""
    tee = Tee(sys.stdout)
    with counted_path(cap, path) if path else contextlib.nullcontext():
        with contextlib.redirect_stdout(tee):
            out = mod.main(argv)
    return out, tee.kept.getvalue()


def cli_convert_index(tmp: str, card: str, cap: Capture) -> dict:
    """build from .npy files at the quickstart's N, inspect, verify; shard
    into 4 and verify; merge and verify; the merged file searches as the
    original bit for bit."""
    from repro_torch.store import read_header

    mod = load_entry("convert_index")
    n, dim = 8_000, 32
    corpus, labels = make_bigann_like(n, dim, seed=0), uniform_labels(n, 10, seed=0)
    files = {k: os.path.join(tmp, f"{k}.npy") for k in ("corpus", "labels")}
    np.save(files["corpus"], corpus)
    np.save(files["labels"], labels)
    idx = {k: os.path.join(tmp, f"cli_{k}.gann") for k in ("built", "sharded", "merged")}
    out = {}

    t0 = time.perf_counter()
    with counted_path(cap, "cli_convert_index"):
        rc, text = run_entry(mod, ["build", "--corpus", files["corpus"], "--labels",
                                   files["labels"], "--out", idx["built"]])
        require(rc == 0 and text == read_header(idx["built"]).describe() + "\n",
                "convert_index build: its inspect text")
        rc, text = run_entry(mod, ["inspect", "--index", idx["built"]])
        require(rc == 0 and text.startswith("GateANN index v"), "convert_index inspect")
        for name, argv in (("built", None),
                           ("sharded", ["shard", "--index", idx["built"], "--out", idx["sharded"],
                                        "--shards", "4"]),
                           ("merged", ["merge", "--index", idx["sharded"], "--out", idx["merged"]])):
            if argv:
                rc, text = run_entry(mod, argv)
                require(rc == 0, f"convert_index {argv[0]}: rc {rc}")
            rc, text = run_entry(mod, ["verify", "--index", idx[name]])
            require(rc == 0 and text.rstrip().endswith("verify: OK"),
                    f"convert_index verify of the {name} file: rc {rc}")
            out[f"verify_{name}"] = text.strip().splitlines()
        require(read_header(idx["sharded"]).n_shards == 4, "convert_index shard: not 4 segments")
    out["s"] = time.perf_counter() - t0
    # the merged file's gate results equal the original's bit for bit
    q = torch.from_numpy(make_queries(corpus, 64, seed=1)).cuda()
    tgt = torch.from_numpy(np.random.default_rng(2).integers(0, 10, 64).astype(np.int32)).cuda()
    cfg = SearchConfig(mode="gate", **SEARCH)
    runs = [run_search(GateANNEngine.load(idx[k]), q, tgt, cfg) for k in ("built", "merged")]
    same_run(runs[1], runs[0], "convert_index merged vs built, gate")
    out["index"] = idx["built"]
    log("cli", f"convert_index: build (N={n:,} D={dim}, the flags' defaults), inspect, verify, "
        f"shard --shards 4 + verify, merge + verify: every rc 0 and verify OK; the merged file's "
        f"gate results == the built file's bit for bit (ids, dists, six stats); "
        f"{out['s']:.1f} s on {card}")
    return out


def cli_obs_report(index: str, tmp: str, card: str) -> dict:
    """An artifact written after one disk-tier gate search with telemetry
    on, rendered; ``--prom`` equals the live registry's exposition text
    byte for byte."""
    mod = load_entry("obs_report")
    path = os.path.join(tmp, "cli_obs.json")
    reg = obs.MetricsRegistry(enabled=True)
    tracer = obs.trace.default_tracer()
    with obs.use_registry(reg):
        eng = GateANNEngine.load(index, store_tier="disk")
        q = make_queries(make_bigann_like(8_000, 32, seed=0), 32, seed=1)
        tracer.enable()
        try:
            out = eng.search(q, filter_kind="label", filter_params=np.zeros(32, np.int32),
                             search_config=SearchConfig(mode="gate", search_l=100, beam_width=8))
            out.ids.cpu()
            obs.export.write_obs_json(path)
        finally:
            tracer.disable()
            tracer.reset()
        eng.measured_store().close()
    t0 = time.perf_counter()
    _, text = run_entry(mod, [path])
    _, section = run_entry(mod, [path, "--section", "process"])
    _, prom = run_entry(mod, [path, "--prom"])
    s = time.perf_counter() - t0
    for part in ("spans (trace.span_seconds)", "engine.search", "per-query breakdown",
                 "I/O counters", "disk.records_read", "per-mode search split"):
        require(part in text, f"obs_report: no {part!r} in the report")
    require(section == text, "obs_report --section process: not the whole report")
    require(prom == obs.export.to_prometheus(reg), "obs_report --prom != the live registry's text")
    log("cli", f"obs_report: the report of one disk-tier gate search ({len(text.splitlines())} "
        f"lines), --section, and --prom == to_prometheus() of the live registry byte for byte "
        f"({len(prom):,} B); {s:.2f} s on {card}")
    return {"s": s, "report_lines": len(text.splitlines()), "prom_bytes": len(prom)}


def cli_train_lm(tmp: str, card: str) -> dict:
    """``--steps 40``, then ``--steps 60`` on the same directory: the loss
    falls in each and the second run resumes at 40."""
    t0 = time.perf_counter()
    mod = load_entry("train_lm")
    ckpt = os.path.join(tmp, "cli_train_lm")
    first, _ = run_entry(mod, ["--steps", "40", "--ckpt", ckpt])
    rest, text = run_entry(mod, ["--steps", "60", "--ckpt", ckpt])
    require(len(first) == 40 and first[-1] < first[0], "train_lm --steps 40: the loss did not fall")
    require("resumed at step 40" in text and len(rest) == 20 and rest[-1] < rest[0],
            "train_lm --steps 60: not resumed at 40, or the loss did not fall")
    out = {"s": time.perf_counter() - t0, "losses_40": [first[0], first[-1]],
           "losses_60": [rest[0], rest[-1]]}
    log("cli", f"train_lm: --steps 40 loss {first[0]:.4f} -> {first[-1]:.4f}; --steps 60 resumed "
        f"at 40, loss {rest[0]:.4f} -> {rest[-1]:.4f}; {out['s']:.1f} s on {card}")
    return out


def cli_phase(tmp: str, card: str, cap: Capture) -> dict:
    """Each entry point of the reference's command-line surface, ported,
    through its ``main`` on the card at the reference's sizes."""
    t_phase = time.perf_counter()
    summary = {"convert_index": cli_convert_index(tmp, card, cap)}
    summary["obs_report"] = cli_obs_report(summary["convert_index"].pop("index"), tmp, card)

    t0 = time.perf_counter()
    res, _ = run_entry(load_entry("quickstart"), [], cap, "cli_quickstart")
    modes = {r["mode"]: r for r in res["modes"]}
    require(modes["gate"]["ios"] < modes["post"]["ios"], "quickstart: gate's ios/q not below post's")
    require(all(r["match"] for r in res["disk"]), "quickstart: a disk mode's ids != memory's")
    for r in res["cache"]:
        require(np.array_equal(r["n_ios"] + r["n_cache_hits"], res["cache"][0]["n_ios"]),
                f"quickstart: {r['records']} cached records: n_ios + n_cache_hits != uncached n_ios")
    summary["quickstart"] = {"s": time.perf_counter() - t0,
                             **{m: {k: r[k] for k in ("recall", "ios", "tunnels")}
                                for m, r in modes.items()}}
    log("cli", f"quickstart: gate ios/q {modes['gate']['ios']:.1f} < post {modes['post']['ios']:.1f}; "
        "ids==mem True for post and gate off the file; n_ios + n_cache_hits == the uncached n_ios "
        f"at 0/256/1,024 records; {summary['quickstart']['s']:.1f} s on {card}")

    t0 = time.perf_counter()
    res, _ = run_entry(load_entry("filtered_search_demo"), [], cap, "cli_filtered_search_demo")
    require(all(r["clean"] for r in res["families"]), "demo: a family is not predicate-clean")
    dram = [r["dram_bytes"] for r in res["rmax"]]
    require(all(a < b for a, b in zip(dram, dram[1:])), f"demo: DRAM bytes {dram} do not grow")
    summary["filtered_search_demo"] = {"s": time.perf_counter() - t0, "dram_bytes": dram}
    log("cli", f"filtered_search_demo: all {len(res['families'])} families predicate-clean=True; "
        f"R_max DRAM bytes {dram} grow with R_max; {summary['filtered_search_demo']['s']:.1f} s "
        f"on {card}")

    t0 = time.perf_counter()
    res, _ = run_entry(load_entry("rag_serve"), [], cap, "cli_rag_serve")
    require(tuple(res["tokens"].shape) == (4, 8), f"rag_serve: tokens {res['tokens'].shape}")
    hit = res["ids"][res["ids"] >= 0]
    require(hit.size > 0 and bool((res["labels"][hit] == 3).all()),
            "rag_serve: a retrieved passage is not of category 3")
    require(res["report_after"]["cache_refreshes"] > 0, "rag_serve: the cache never refreshed")
    summary["rag_serve"] = {"s": time.perf_counter() - t0, "report_after": res["report_after"]}
    log("cli", f"rag_serve: tokens (4, 8); all {hit.size} retrieved passages of category 3; "
        f"after the second retrieve {json.dumps(res['report_after'])}; "
        f"{summary['rag_serve']['s']:.1f} s on {card}")

    summary["train_lm"] = cli_train_lm(tmp, card)

    t0 = time.perf_counter()
    mod = load_entry("smoke_models")
    (ok, rows), text = run_entry(mod, [])
    require(ok and len(rows) == len(mod.ARCH_IDS)
            and text.rstrip().endswith("ALL OK"), "smoke_models: not ALL OK")
    summary["smoke_models"] = {"s": time.perf_counter() - t0, "archs": len(rows)}
    for name in ("smoke_core", "diag_recall"):
        t0 = time.perf_counter()
        rows, _ = run_entry(load_entry(name), [], cap, f"cli_{name}")
        require(len(rows) == 4, f"{name}: {len(rows)} rows")
        summary[name] = {"s": time.perf_counter() - t0}
    log("cli", f"smoke_models ALL OK over {summary['smoke_models']['archs']} archs "
        f"({summary['smoke_models']['s']:.1f} s); smoke_core ({summary['smoke_core']['s']:.1f} s) and "
        f"diag_recall ({summary['diag_recall']['s']:.1f} s) ran to completion on {card}")
    summary["phase_s"] = time.perf_counter() - t_phase
    paths = {k: v for k, v in cap.launches.items() if k.startswith("cli_")}
    log("cli", f"launches by path: {json.dumps(paths)}; phase {summary['phase_s']:.1f} s on {card}")
    print(json.dumps({"cli": summary, "card": card}), flush=True)
    return summary


# ---------------------------------------------------------------- phase 7
def parity_phase(tmp: str, dev, n: int = 20_000) -> None:
    path = os.path.join(tmp, "parity.gann")
    index = build_index(path, n, dev, seed=3)
    q = make_queries(index["x_np"], 64, seed=1)
    targets = np.random.default_rng(2).integers(0, N_LABELS, 64).astype(np.int32)
    on_card = GateANNEngine.load(path)
    on_cpu = GateANNEngine.load(path, device="cpu")
    for mode in MODES:
        kind, params = (None, None) if mode == "unfiltered" else ("label", targets)
        for fused in (False, True):
            cfg = SearchConfig(mode=mode, use_fused_kernel=fused, **SEARCH)
            a = on_card.search(q, filter_kind=kind, filter_params=params, search_config=cfg)
            b = on_cpu.search(q, filter_kind=kind, filter_params=params, search_config=cfg)
            same(a.ids.cpu(), b.ids, f"card vs cpu ids {mode} fused={fused}")
            same(a.dists.cpu(), b.dists, f"card vs cpu dists {mode} fused={fused}")
            for f in a.stats._fields:
                same(getattr(a.stats, f).cpu(), getattr(b.stats, f), f"card vs cpu {f} {mode}")
    log("parity", f"card == CPU (plain versions) on N={n}: ids, dists and stats bit-identical "
        "in all five modes, unfused and fused")


# ---------------------------------------------------------------- phase 8
def time_ms(fn, reps: int = 50) -> float:
    """Device time per call, by CUDA events around ``reps`` calls.

    A spin kernel holds the card while the host queues the timed calls, so
    the calls run back to back and the events measure the device, not the
    host's launch rate (a wrapper's host cost is tens of microseconds, as
    long as the kernels themselves)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (1.5 * reps * host_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def stage_b_line(cap: Capture, card: str, reps: int = 50, calls: int = 20) -> dict:
    """The captured round's stage B as the re-rank kernel and as the parent
    design (the standalone L2 kernel, then isinf, where and the plain
    merge, as ``retire`` did before the re-rank): the host's time from the
    call to its return (median of ``reps`` calls, each from an idle card,
    the two in turns), the device launches and their summed kernel time a
    call from ``torch.profiler`` over ``calls`` calls (kernels that start
    with the profiler can be missed: over many calls that stays below one
    launch a call), and the device time a call by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    args, kw = cap.args["rerank"]
    fns = {"rerank": lambda: l2k.rerank(*args, **kw),
           "parent_design": lambda: l2k.rerank_composed(
               functools.partial(l2k.l2_dist, tree=True), *args)}
    host = {name: [] for name in fns}
    for _ in range(reps + 5):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host[name].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    out = {}
    for name, fn in fns.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        seen = sum(e.count for e in dev)
        out[name] = {"launches": round(seen / calls), "launches_seen": seen, "calls": calls,
                     "device_us": sum(e.self_device_time_total for e in dev) / calls,
                     "device_us_events": time_ms(fn) * 1e3,
                     "host_us": float(np.median(host[name][5:]) * 1e6)}
        c = out[name]
        log("retire", f"one round's stage B, {name}: {c['launches']} device launches "
            f"({seen} seen in {calls} calls), {c['device_us']:.2f} us of kernels "
            f"({c['device_us_events']:.2f} us by CUDA events), {c['host_us']:.1f} us on the host "
            f"(call to return, median) [B={args[1].shape[0]} W={args[1].shape[1]} "
            f"K={args[4].shape[1]} D={args[1].shape[2]}] on {card}")
    return out


def by_path(cap: Capture, kernel: str) -> dict:
    """A kernel's launches in each main-path run, each counted from 0."""
    return {path: counts.get(kernel, 0) for path, counts in cap.launches.items()}


def total(cap: Capture, kernel: str) -> int:
    return sum(by_path(cap, kernel).values())


def kernel_line(cap: Capture) -> list[dict]:
    rows = []
    # ADC, the search loop's entry: lut (B,C,K), codes (N,C), ids (B,M)
    (lut, codes, ids), _ = cap.args["pq_lookup"]
    b, c, k = lut.shape
    m = ids.shape[1]
    n_valid = int((ids >= 0).sum())
    err = float((pqk.adc_ids(lut, codes, ids) - pqk.adc_ids_ref(lut, codes, ids)).abs().max())
    bnd = bound(lut.numel() * 4 + ids.numel() * 4 + n_valid * c * 4 + b * m * 4, n_valid * c)
    # one batch's rounds in turn (distinct id sets: their code rows are not
    # all in L2 from the call before), and the loop's entry call (M = 1)
    rounds = [r for r in cap.adc_rounds if r.shape[1] == m]
    entry = next(r for r in cap.adc_rounds if r.shape[1] == 1)
    turn = iter(range(1 << 30))
    ms_rounds = time_ms(lambda: pqk.adc_ids(lut, codes, rounds[next(turn) % len(rounds)]),
                        reps=len(rounds))
    # the library yardstick: F.embedding_bag(mode="sum") over flat indices
    # b*C*K + c*K + code (built beforehand, timed apart; ids < 0 not sent to +INF)
    offs = (torch.arange(b, device=lut.device, dtype=torch.int32)[:, None, None] * (c * k)
            + torch.arange(c, device=lut.device, dtype=torch.int32)[None, None, :] * k)
    flat = lambda: (offs + codes[ids.clamp(min=0).long()]).reshape(-1, c)  # noqa: E731
    idx, table = flat(), lut.reshape(-1, 1)
    rows.append(dict(name="pq_lookup.adc_ids", route="cuda", source="src/repro_torch/csrc/pq_lookup.cu",
                     replaces="src/repro/kernels/pq_lookup.py:81", launches=total(cap, "pq_lookup"),
                     launches_by_path=by_path(cap, "pq_lookup"),
                     max_abs_err=err, ms=time_ms(lambda: pqk.adc_ids(lut, codes, ids)),
                     kernel_route=pqk.adc_route(m, k),
                     ms_round_robin=ms_rounds, round_robin_rounds=len(rounds),
                     ms_entry=time_ms(lambda: pqk.adc_ids(lut, codes, entry)),
                     entry_route=pqk.adc_route(1, k),
                     plain_ms=time_ms(lambda: pqk.adc_ids_ref(lut, codes, ids)),
                     bound_ms=bnd[0], bound_by=bnd[1],
                     library_ms=time_ms(lambda: F.embedding_bag(idx, table, mode="sum")),
                     library_index_ms=time_ms(flat),
                     library_note="F.embedding_bag(mode='sum') on flat indices b*C*K + c*K + code, "
                                  "built beforehand (library_index_ms); ids < 0 not sent to +INF",
                     shape=f"B={b} M={m} C={c} K={k} valid_ids={n_valid}"))
    del idx, flat
    # the re-rank, the main path's stage B (tree form, use_kernel=False), on
    # the captured round
    args, kw = cap.args["rerank"]
    q, vecs, sel, rm, rids = args[:5]
    b, w, d = vecs.shape
    k = rids.shape[1]
    got, want = l2k.rerank(*args, **kw), l2k.rerank_ref(*args, **kw)
    same_rerank(got, want, "rerank on the captured round")
    err = max(float((g.double() - h.double()).abs().max()) for g, h in zip(got, want))
    # bytes: the queries with a row in the result mask and those rows, with
    # their ids (no other query, row or id is needed), the whole mask, the
    # result list in and out, n_degraded in and out; operations: sub, mul
    # and add a scored element, the kill's and the rank's compares
    n_rm, n_q, n = int(rm.sum()), int(rm.any(1).sum()), k + w
    bnd = bound(n_q * d * 4 + n_rm * (d * 4 + 4) + b * w + 2 * b * k * 8 + 2 * b * 4,
                3 * n_rm * d + b * (n * (n - 1) // 2 + n * n))
    rows.append(dict(name="l2_dist.rerank", route="cuda", source="src/repro_torch/csrc/l2_dist.cu",
                     replaces="src/repro/kernels/l2_dist.py:34", launches=total(cap, "rerank"),
                     launches_by_path=by_path(cap, "rerank"), max_abs_err=err,
                     ms=time_ms(lambda: l2k.rerank(*args, **kw)),
                     plain_ms=time_ms(lambda: l2k.rerank_ref(*args, **kw)),
                     bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                     library_note="no one PyTorch call computes it: distances, the +-inf check, "
                                  "a dedup by id and a stable merge by distance",
                     kernel_route=l2k.rerank_route(k, w, d),
                     shape=f"B={b} W={w} K={k} D={d} scored_rows={n_rm} queries_scoring={n_q}"))
    # exact L2 alone, tree form, on the same round's rows (the re-rank's
    # other route; the standalone port of the TPU kernel)
    err = float((l2k.l2_dist(q, vecs) - l2k.l2_tree_ref(q, vecs)).abs().max())
    bnd = bound((q.numel() + vecs.numel() + b * w) * 4, 3 * b * w * d)
    rows.append(dict(name="l2_dist.tree", route="cuda", source="src/repro_torch/csrc/l2_dist.cu",
                     replaces="src/repro/kernels/l2_dist.py:34", launches=total(cap, "l2_dist"),
                     launches_by_path=by_path(cap, "l2_dist"),
                     max_abs_err=err, ms=time_ms(lambda: l2k.l2_dist(q, vecs)),
                     plain_ms=time_ms(lambda: l2k.l2_tree_ref(q, vecs)),
                     bound_ms=bnd[0], bound_by=bnd[1],
                     library_ms=time_ms(lambda: torch.cdist(q[:, None], vecs).square()),
                     shape=f"B={b} W={w} D={d}"))
    # fused round, the search loop's entry (code rows gathered by id)
    args, kw = cap.args["fused_traversal"]
    fids, new_ids, lut = args[0], args[4], args[7]
    b, l = fids.shape
    m, c = new_ids.shape[1], lut.shape[1]
    got = ftk.fused_traversal_round(*args, **kw)
    want = ftk.fused_traversal_round_ref(*args, **kw)
    err = max(float((g.float() - h.float()).abs().max()) for g, h in zip(got, want))
    p = 1 << (l + m - 1).bit_length()
    logp = p.bit_length() - 1
    n_valid = int((new_ids >= 0).sum())
    w = kw["width"]
    nbytes = (b * l * 10 + b * m * 5 + n_valid * c * 4 + lut.numel() * 4 + b * 4
              + b * l * 10 + b * w * 13)
    bnd = bound(nbytes, n_valid * c + b * (p // 2) * logp * (logp + 1) // 2)
    rows.append(dict(name="fused_traversal_round", route="cuda",
                     source="src/repro_torch/csrc/fused_traversal.cu",
                     replaces="src/repro/kernels/fused_traversal.py:277",
                     launches=total(cap, "fused_traversal"),
                     launches_by_path=by_path(cap, "fused_traversal"), max_abs_err=err,
                     ms=time_ms(lambda: ftk.fused_traversal_round(*args, **kw)),
                     plain_ms=time_ms(lambda: ftk.fused_traversal_round_ref(*args, **kw)),
                     bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                     shape=f"B={b} L={l} M={m} C={c} W={w} P={p} valid_new={n_valid}"))
    # brute-force scan: lut (B,C,K), the (N,C) code table
    (lut, codes), _ = cap.args["pq_scan"]
    b, c, k = lut.shape
    n = codes.shape[0]
    err = float((pqk.pq_scan(lut, codes) - pqk.pq_scan_ref(lut, codes)).abs().max())
    bnd = bound(lut.numel() * 4 + codes.numel() * 4 + b * n * 4, b * n * c)
    # the shared-memory lookups' floor: one 4-byte lookup a lane, 32 lanes a
    # cycle on each SM, no bank conflicts
    sms = torch.cuda.get_device_properties(lut.device).multi_processor_count
    lookup_ms = b * n * c / (sms * 32 * SPIN_CYCLES_PER_S) * 1e3
    # beside it, the floor with this table's bank conflicts: a warp's lanes
    # take 32 consecutive rows, and a lookup instruction takes as many
    # cycles as the most distinct words its lanes read from one of the 32
    # banks (lanes on one code share a word; bank = code % 32 when K % 32 == 0)
    ways, warps = 0.0, n // 32
    for w0 in range(0, warps, 4096):
        w1 = min(warps, w0 + 4096)
        key = (torch.arange((w1 - w0) * c, device=codes.device).view(w1 - w0, 1, c) * k
               + codes[w0 * 32:w1 * 32].view(w1 - w0, 32, c).long())
        seen = torch.bincount(key.flatten(), minlength=(w1 - w0) * c * k).view(-1, k // 32, 32) > 0
        ways += float(seen.sum(1).max(1).values.double().sum())
    ways /= warps * c
    # the library yardstick on (B*N, C) int32 flat indices, all of N where
    # they fit in half the free device memory, else the first rows
    free = torch.cuda.mem_get_info(lut.device)[0]
    n_lib = min(n, int(free // 2 // (b * c * 4 + b * 4)))
    offs = (torch.arange(b, device=lut.device, dtype=torch.int32)[:, None, None] * (c * k)
            + torch.arange(c, device=lut.device, dtype=torch.int32)[None, None, :] * k)
    flat = lambda: (offs + codes[None, :n_lib]).reshape(-1, c)  # noqa: E731
    idx, table = flat(), lut.reshape(-1, 1)
    lib_out = F.embedding_bag(idx, table, mode="sum").reshape(b, n_lib)
    lib_err = float((lib_out - pqk.pq_scan_ref(lut, codes[:n_lib])).abs().max())
    del lib_out
    rows.append(dict(name="pq_scan", route="cuda", source="src/repro_torch/csrc/pq_lookup.cu",
                     replaces="src/repro/kernels/pq_lookup.py:125", launches=total(cap, "pq_scan"),
                     launches_by_path=by_path(cap, "pq_scan"), max_abs_err=err,
                     kernel_route=pqk.scan_route(c, k),
                     ms=time_ms(lambda: pqk.pq_scan(lut, codes), reps=20),
                     plain_ms=time_ms(lambda: pqk.pq_scan_ref(lut, codes), reps=5),
                     bound_ms=bnd[0], bound_by=bnd[1], bound_lookup_ms=lookup_ms,
                     lookup_bank_ways=ways, bound_lookup_conflict_ms=lookup_ms * ways,
                     library_ms=time_ms(lambda: F.embedding_bag(idx, table, mode="sum"), reps=3),
                     library_index_ms=time_ms(flat, reps=3), library_rows=n_lib,
                     library_max_abs_err=lib_err,
                     library_note=f"F.embedding_bag(mode='sum') on (B*{n_lib}, C) int32 flat "
                                  "indices b*C*K + c*K + code, built beforehand (library_index_ms)",
                     shape=f"B={b} N={n} C={c} K={k}"))
    del idx, flat
    # top-k merge at the scan path's first-level shape (and, beside it, the
    # second level's), timed on tie-free keys of that shape so that
    # torch.topk computes the same function, and on the path's own keys
    levels = []
    for n_level, key in enumerate(("topk_merge", "topk_merge_2")):
        (d_cap, i_cap, k), _ = cap.args[key]
        b, m = d_cap.shape
        p = tkk.padded_width(m)
        kk = min(k, p)
        rng = np.random.default_rng(9 + n_level)
        d, i = (torch.from_numpy(x).to(d_cap.device) for x in topk_keys(rng, b, m, dup=False))
        got, want = tkk.topk_merge(d_cap, i_cap, k), tkk.topk_merge_ref(d_cap, i_cap, k)
        err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        lib = torch.topk(d, min(k, m), dim=1, largest=False)
        require(bool(torch.equal(lib.values, tkk.topk_merge(d, i, k)[0][:, : min(k, m)])),
                "torch.topk disagrees with topk_merge on tie-free keys")
        # the least the function must move: every distance once, the id of
        # every key at or below its row's k-th distance (only those can be
        # in the output), the output; one compare a key
        kth = lib.values[:, -1:]
        n_ids = int((d <= kth).sum())
        bnd = bound(b * m * 4 + n_ids * 4 + b * kk * 8, b * m)
        logp = p.bit_length() - 1  # PR 12's formula: 8 bytes a key, the network's compares
        pr12 = bound(b * m * 8 + b * kk * 8, b * (p // 2) * logp * (logp + 1) // 2)
        levels.append(dict(max_abs_err=err, ms=time_ms(lambda: tkk.topk_merge(d, i, k), reps=20),
                           plain_ms=time_ms(lambda: tkk.topk_merge_ref(d, i, k), reps=5),
                           bound_ms=bnd[0], bound_by=bnd[1], bound_ids_read=n_ids,
                           bound_ms_pr12_formula=pr12[0],
                           library_ms=time_ms(lambda: torch.topk(d, min(k, m), dim=1, largest=False),
                                              reps=20),
                           kernel_route=tkk.route(b, m, k),
                           ms_path_keys=time_ms(lambda: tkk.topk_merge(d_cap, i_cap, k), reps=20),
                           library_ms_path_keys=time_ms(
                               lambda: torch.topk(d_cap, min(k, m), dim=1, largest=False), reps=20),
                           path_keys_at_3_4e38=float((d_cap == tkk.PAD_DIST).float().mean()),
                           shape=f"B={b} M={m} k={k} P={p} (timed on tie-free keys of this shape; "
                                 "*_path_keys: on the scan path's own keys)"))
    first, second = levels
    # off the path: each route at a loop-sized shape, and the warp's on more rows
    routes = {}
    rng = np.random.default_rng(11)
    loop_m = 8 * (DEGREE + R_MAX)
    for b, m, k in ((BATCH, loop_m, 10), (BATCH, loop_m, 64), (4096, loop_m, 10), (BATCH, 1000, 2048)):
        d, i = (torch.from_numpy(x).to(d_cap.device) for x in topk_keys(rng, b, m, dup=False))
        routes[f"B={b} M={m} k={k}"] = dict(
            kernel_route=tkk.route(b, m, k), ms=time_ms(lambda: tkk.topk_merge(d, i, k), reps=50),
            library_ms=time_ms(lambda: torch.topk(d, min(k, m), dim=1, largest=False), reps=50))
    rows.append(dict(name="topk_merge", route="cuda", source="src/repro_torch/csrc/topk_merge.cu",
                     replaces="src/repro/kernels/topk_merge.py:68",
                     launches=total(cap, "topk_merge"),
                     launches_by_path=by_path(cap, "topk_merge"), **first,
                     max_abs_err_second_level=second.pop("max_abs_err"), second_level=second,
                     other_shapes=routes))
    for r in rows:
        require(r["max_abs_err"] == 0.0 and r.get("max_abs_err_second_level", 0.0) == 0.0,
                f"{r['name']}: kernel differs from its plain version")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="index size (SIFT1M: 1,000,000)")
    ap.add_argument("--only", choices=("dist_serve", "dryrun", "cli"),
                    help="run one phase alone, its one-device references included (no result line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def elapsed(phase: str) -> None:
        log("time", f"{phase} done, {time.perf_counter() - t_start:.1f} s into the run")

    # cuBLAS's deterministic workspace, set before the first product: the
    # train phase's resume check runs under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    print(smi, flush=True)
    log("device", f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        "matmul.allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    t0 = time.perf_counter()
    _build.build_all()
    log("kernels", f"built {', '.join(_build.SOURCES)} for sm_90a in {time.perf_counter() - t0:.1f} s")
    watch_plain_merges()
    if args.only == "dryrun":
        dryrun_phase(card)
        log("done", f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.only == "cli":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=index_dir()) as tmp:
            cli_phase(tmp, card, Capture())
        log("done", f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.only == "dist_serve":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=index_dir()) as tmp:
            t0 = time.perf_counter()
            dist_serve_references(tmp, card)
            log("dist_serve", f"one device's references in {time.perf_counter() - t0:.1f} s")
            dist_serve_phase(tmp, card, Capture())
        log("done", f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    rng = np.random.default_rng(0)
    check_adc(dev, args.n, rng)
    check_l2(dev, rng)
    check_rerank(dev)
    check_fused(dev, rng)
    check_scan(dev, args.n, rng)
    check_topk(dev, rng)
    elapsed("kernels")

    cap = Capture()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=index_dir()) as tmp:
        built = build_phase(tmp, dev, card, cap, min(BUILD_N, args.n))
        elapsed("build")
        # phase 3 keeps the 48 + 16 graph: a Vamana graph at 1M builds within
        # the run's time, but its gate recall@10 at SEARCH falls below this
        # smoke's garbage detector (PERF.md, Findings)
        log("index", f"CUT: the {args.n:,} index keeps 48 exact + 16 random links, not the "
            f"port's Vamana graph (the build phase's {built['graph_s']:.1f} s at "
            f"N={built['n']:,} scale linearly to {built['graph_s'] * args.n / built['n']:.0f} s "
            "at this N; see PERF.md for why phase 4 does not search it)")
        if args.n != 1_000_000:
            log("index", f"N cut from 1,000,000 to {args.n:,} (--n)")
        path = os.path.join(tmp, "sift1m_like.gann")
        index = build_index(path, args.n, dev)
        elapsed("index")
        t0 = time.perf_counter()
        eng = GateANNEngine.load(path)
        torch.cuda.synchronize()
        log("index", f"N={args.n:,} D={DIM} R={DEGREE} C={PQ_CHUNKS} r_max={R_MAX}: built in "
            f"{index['build_s']:.1f} s, written ({index['file_bytes'] / 2**30:.2f} GiB) to "
            f"{fs_type(path)} in {index['write_s']:.1f} s, loaded on {eng.device} in "
            f"{time.perf_counter() - t0:.1f} s; device memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        x = index["x"]
        q = torch.from_numpy(make_queries(index["x_np"], N_QUERIES, seed=1)).to(dev)
        targets = torch.from_numpy(
            np.random.default_rng(2).integers(0, N_LABELS, N_QUERIES).astype(np.int32)).to(dev)
        gt = ground_truth(x, torch.from_numpy(index["labels"]).to(dev), q, targets)
        del index, x
        mem_runs = search_phase(eng, q, targets, gt, card, cap)
        elapsed("search")
        dist_phase(tmp, path, q, targets, mem_runs, card, cap)
        elapsed("dist")
        ssd_phase(path, q, targets, mem_runs, card, cap)
        elapsed("ssd")
        host_phase(path, q, targets, mem_runs, card, cap)
        elapsed("host")
        cache_phase(eng, path, q, targets, mem_runs, card, cap)
        elapsed("cache")
        serve_phase(eng, path, q, targets, card, cap)
        elapsed("serve")
        ref_dir = os.path.join(tmp, "dist_serve")
        os.makedirs(ref_dir)
        lm_phase(eng, q, targets, card, cap, ref_dir)
        elapsed("lm")
        lm_kinds_phase(eng, q, targets, card, cap, ref_dir)
        elapsed("lm_kinds")
        lm_variants_phase(card, ref_dir)
        elapsed("lm_variants")
        train_phase(tmp, card)
        elapsed("train")
        dist_train_phase(tmp, card)
        elapsed("dist_train")
        dist_serve_phase(ref_dir, card, cap)
        elapsed("dist_serve")
        dryrun_phase(card)
        elapsed("dryrun")
        scan_phase(eng, q, targets, gt, card, cap)
        elapsed("scan")
        del eng, mem_runs
        torch.cuda.empty_cache()
        parity_phase(tmp, dev)
        elapsed("parity")
        cli_phase(tmp, card, cap)
        elapsed("cli")

    rows = kernel_line(cap)
    for r in rows:
        log("kernels", f"{r['name']}: {r['ms'] * 1e3:.1f} us/launch (plain {r['plain_ms'] * 1e3:.1f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}) x {r['launches']} launches "
            f"{json.dumps(r['launches_by_path'])} "
            f"[{r['shape']}] on {card}")
        if "ms_round_robin" in r:
            log("kernels", f"{r['name']} ({r['kernel_route']} route): one batch's "
                f"{r['round_robin_rounds']} rounds in turn {r['ms_round_robin'] * 1e3:.1f} us/launch; "
                f"the loop's entry (M=1, {r['entry_route']} route) {r['ms_entry'] * 1e3:.1f} us; "
                f"F.embedding_bag {r['library_ms'] * 1e3:.1f} us + its index build "
                f"{r['library_index_ms'] * 1e3:.1f} us on {card}")
        if "bound_lookup_ms" in r:
            log("kernels", f"{r['name']} ({r['kernel_route']} route): shared-memory lookup floor "
                f"{r['bound_lookup_ms'] * 1e3:.2f} us ({r['bound_lookup_conflict_ms'] * 1e3:.2f} us at "
                f"this table's {r['lookup_bank_ways']:.3f}-way bank conflicts) beside the byte bound "
                f"{r['bound_ms'] * 1e3:.2f} us; F.embedding_bag over {r['library_rows']} rows "
                f"{r['library_ms'] * 1e3:.1f} us + its index build {r['library_index_ms'] * 1e3:.1f} us "
                f"(max |err| {r['library_max_abs_err']:g}) on {card}")
        if "second_level" in r:
            sl = r["second_level"]
            for name, lv in (("first level", r), ("second level", sl)):
                log("kernels", f"{r['name']} {name} ({lv['kernel_route']}): {lv['ms'] * 1e3:.1f} "
                    f"us/launch (plain {lv['plain_ms'] * 1e3:.1f} us, torch.topk "
                    f"{lv['library_ms'] * 1e3:.1f} us, bound {lv['bound_ms'] * 1e3:.2f} us by "
                    f"{lv['bound_by']}, PR 12's formula {lv['bound_ms_pr12_formula'] * 1e3:.2f} us); "
                    f"on the path's keys ({lv['path_keys_at_3_4e38']:.1%} at 3.4e38) "
                    f"{lv['ms_path_keys'] * 1e3:.1f} us, torch.topk "
                    f"{lv['library_ms_path_keys'] * 1e3:.1f} us [{lv['shape']}] on {card}")
            for shape, o in r["other_shapes"].items():
                log("kernels", f"{r['name']} {o['kernel_route']} route: {o['ms'] * 1e3:.1f} us/launch "
                    f"(torch.topk {o['library_ms'] * 1e3:.1f} us) [{shape}] on {card}")
    print(json.dumps({"retire": cap.stage_b, "card": card}), flush=True)
    log("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

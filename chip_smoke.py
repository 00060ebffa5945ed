#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100, ``sm_90a``). Run from the repository
root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. environment and build: the card's name and power limit, then every
   kernel of ``src/repro_torch/csrc`` compiled, one nvcc each, started
   together;
2. flash attention vs plain: the kernel against ``attention_plain`` on
   the reference's kernel-test cases (fp32 at 2e-5, bf16 at 2e-2), on
   cases of the wgmma path's edges, on the Qwen3-8B prefill shape and on
   its training shape (batch 2, seq 4096), each with the path it took
   (bf16 must take ``wgmma``, fp32 ``simt``; dh 16 and 32 run as 64); at
   the training shape also per 128-row q tile, against two controls (a
   KV tile dropped, the causal edge one key late in the last tile) that
   the tile bound must catch; then kernel / plain / SDPA times at both
   shapes, warm and with L2 flushed; the same kernel-test cases at head
   dims 80 and 112, which the kernel reads unpadded (bf16 must take
   ``wgmma``; fp32 ``simt``; a head dim with an instance of its own is
   never padded on the host), two padded head dims (48 runs as 64, 96
   as 112), and at the hubert-xlarge (dh 80) and kimi-k2 (dh 112)
   shapes the per-tile check with its controls and kernel / plain / SDPA
   times; then the prefill shapes of Jamba-1.5-Large, Kimi-K2 and
   Gemma-2-9B (dh 256, softcap 50; SDPA runs without the softcap, which
   it does not take) checked per q tile and timed the same way; and
   Gemma-2's shape once more with q scaled so that the logits reach
   where the softcap binds, per q tile against a third control, the
   softcap left out; then Kimi-K2-Instruct's MLA prefill (64 heads,
   q / k of 192, v of 128 zero-padded to 192, at YaRN's softmax scale,
   prompts of 1,905 and 4,000) as the model hands it to K3: the output's
   v columns within TOLS and per q tile against plain, its padded
   columns exactly zero, and two controls (the scale without YaRN's
   mscale^2, causal off) past the tile bound, then timed;
3. payload pack / unpack vs plain, byte for byte (tolerance 0): the
   reference's kernel-test sizes, unaligned serialization sizes, 8
   endpoint rows of the default payload and of the Qwen3-8B payload,
   and framing's ``backend="kernel"`` against ``backend="numpy"``; then
   kernel / plain / library (``torch.cat``, ``split``) times at both row
   shapes;
4. the RWKV-6 WKV scan vs plain: the kernel against
   ``rwkv6_scan_plain`` and the sequential ``rwkv6_ref`` on the
   reference's kernel-test cases and under strong decay (atol/rtol
   1e-4, outputs finite), at the RWKV-6 1.6B prefill shape, and through
   the model's strided ``(B, S, H, hs)`` entry against the folded plain
   result, then kernel / plain times there and the kernel with the
   layout's fold copies against the strided kernel without them;
4b. the MoE decode's routed-expert GLU FFN (``[moe_decode]``, K5):
   the kernel against ``moe_decode_plain`` at one token of Mixtral-8x7B
   (top-2 of 8 experts 4096 x 14336), of Granite-4.0-H-Small (top-10
   of 72 experts 4096 x 768) and of Kimi-K2-Instruct's expert share
   (top-8 of 384 experts 7168 x 2048, 8 held, at offsets 0 and 16, half
   the ids held and half not) in bf16, within K5_TOL, which two controls
   (one assignment's expert changed, the activation left out) must
   exceed; in the share, rows routed to experts not held exactly zero
   and those held not, which a control (an id moved into the held
   range) must break; then kernel / plain / dense (the three batched
   products over every expert held) times there beside the routed
   experts' byte bound;
4c. the Mamba-2 chunked SSD scan (``[ssd_scan]``, K6): the kernel
   against ``ssd_scan_plain`` at Granite-4.0-H-Small's mixer (128 heads
   of 64, d_state 128) over prompts of 128, 1,905 and 4,000 tokens, and
   at Jamba-1.5-Large's (256 heads, d_state 16) over [serve]'s batch of
   4 x 512, with a non-zero state, y and the final state within SSD_TOL
   of their scale, which two controls (the state dropped at every chunk,
   every decay doubled) must exceed; then kernel / plain times there
   beside the operations' bound;
5. serve Qwen3-8B at full width (36 layers, random weights from seed 0)
   through the port's serve entry point, ``--batch 4 --prompt-len 512
   --new-tokens 32 --requests 3``: over the loopback streaming RPC, with
   ``--unary`` and with ``--no-rpc``. Greedy tokens must agree across the
   three, and the flash kernel must have launched 36 times per prefill,
   every launch on its wgmma path; then (``[cluster]``) the direct
   path's engine, its weights reused, served over a 2 ps x 2 worker
   cluster transport for 2 rounds in which each worker streams one
   request of those prompts in the same flush, under round_robin and
   scheduler_least_loaded: every worker's tokens must equal the direct
   path's, with 36 wgmma flash launches a prefill and the dispatch
   counts per link the policy gives;
5b. temperature sampling (``[sample]``), JAX's key chain and Gumbel-max
   in the port (``core/prng.py``): the chain from seed 0, 8 splits deep,
   against constants that a CPU test derives from ``jax.random``, each
   split hashed on the card against the host's; the noise at (4,
   151936), Qwen3-8B's vocabulary, on the card against the CPU's (random
   bits equal, bf16 within one ulp, fp32 within 2e-6); 65,536 draws of
   16-way fp32 logits against softmax(logits / T) by chi-square; the
   sampler's ms and kernel launches a draw beside [serve]'s decode step,
   and beside torch's own sampler (fp32 softmax and ``torch.multinomial``)
   on the same logits, in turns; then Qwen3-8B served whole through the
   serve CLI at ``--temperature 0.8`` the three ways: tokens identical,
   some unlike [serve]'s greedy ones, 36 wgmma flash launches a prefill;
6. end to end, kernel vs plain: last-position logits of the same
   prompts with the flash kernel on and off (bf16, Qwen3-8B), two
   controls (the kernel with a window that drops keys, and with the
   causal mask off) that the bound must catch, and a reduced model in
   fp32;
7. serve RWKV-6 1.6B at full width (24 layers, random weights from seed
   0) the same three ways: greedy tokens must agree, and the WKV kernel
   must have launched 24 times per prefill;
8. end to end for RWKV-6, WKV kernel vs plain chunked path: bf16
   logits within a bound that two wrong WKVs patched in (the state reset
   at every chunk boundary; cum in place of cum_{t-1}) must exceed, and
   a reduced model in fp32;
8b. serve the MoE and Mamba models at full width, each cut in depth to
   what one card holds (``MOE_SERVE``): Mixtral-8x7B (8 of 32 layers),
   Jamba-1.5-Large (5 of 72: positions 0-4 of its period, 4 Mamba and 1
   attention layer, MoE at 1 and 3) and Kimi-K2 (1 of 61), the same
   three ways: greedy tokens must agree, K3 must launch once an
   attention layer a prefill, all on wgmma, K6 once a Mamba layer a
   prefill, and K4 never; K5 must be
   called once a MoE layer a decode step run outside a graph replay
   where the decode's T*k < E (Jamba's 8 of 16, Kimi-K2's 32 of 384;
   Mixtral's 8 = E keeps the dispatch), and never elsewhere; then Gemma-2-9B
   at full width and depth (42 layers, dh 256, softcaps, a window of 4096
   on alternate layers), the same three ways, 42 wgmma K3 launches a
   prefill;
9. training (``[train]``): Qwen3-8B at full width cut to 4 layers
   (bf16 compute, fp32 masters, AdamW, remat, seq 4096, batch 2) takes 4
   steps through the port's ``Trainer``, with the flash kernel launched
   twice a layer a step (forward and remat's recompute), all on wgmma;
   its first step's loss, gradient norm and one ``wq`` gradient with the
   kernel on and off, and a control (the kernel's output rows shifted by
   one position) that each of the three bounds must catch;
   hubert-xlarge at full width and depth (48 layers, dh 80, about 1 B
   parameters) the same way for 2 steps at seq 4096, batch 1, all 96
   flash launches a step on wgmma (dh 80 read unpadded), the control held
   by the ``wq`` bound; Mixtral-8x7B at full width cut to 1 layer (seq
   4096, batch 2, AdamW) the same way for 4 steps, with the (token,
   expert) assignments that flip between kernel and plain counted and
   the router's aux loss printed beside the cross-entropy; the reduced
   Qwen3-8B, Mixtral and Jamba (one period) in fp32,
   3 steps on the card against the CPU; the train CLI with checkpoints
   and a ``Trainer`` whose step 3 fails until it restarts from
   ``step_2`` and lands on the unfaulted losses; RWKV-6 1.6B at full
   width through the train CLI (no WKV kernel launch: it has no
   backward); the ``examples/torch_train_ps_mode.py --tiny`` run;
9b. training over a device mesh (``[mesh]``): the same Qwen3-8B with
   ``--ps-mode`` (fsdp on) through a 1 x 1 (data, model) mesh on NCCL at
   world size 1 for 3 steps, 8 wgmma K3 launches a step through the
   per-shard entry; its step 0 against the no-mesh kernel step within
   the [train] bounds (bit-identical expected, and said), ms a step
   beside [train]'s; then Mixtral-8x7B cut to 1 layer with
   ``expert_sharding="ep"`` for one step (the per-shard MoE body); then
   RWKV-6 1.6B at full width cut to 2 layers (seq 1024, batch 2, the
   plain chunked scan) over the mesh for 2 steps, step 0 against the
   no-mesh step within the [train] bounds (a ``wr`` gradient in place of
   ``wq``), ms a step beside a no-mesh Trainer's, no K3 or K4 launch.
   Earlier, after [serve]'s RWKV-6 and Jamba phases, the recurrent
   mixers are served over the 1 x 1 mesh (``phase_mesh_serve``): RWKV-6
   1.6B whole and Jamba's cut (positions 0-4, the config's fsdp), on the
   serve CLI's weights, [serve]'s request-0 prompts, prefill then 31
   greedy decode steps with no mesh and over the mesh: tokens equal to
   [serve]'s and the no-mesh run's, last-position logits within the
   end-to-end bound (RWKV-6's 8.5e-2, Qwen3-8B's 5e-2 for Jamba), 24 K4
   launches a prefill through ``rwkv6_scan_shard`` (RWKV-6) and 1 wgmma
   K3 launch (Jamba), ms a request and a decode step and the peak
   beside the no-mesh run's;
9c. the roofline (``[roofline]``): ``launch/roofline.py``'s counts, on
   fake tensors with no mesh, of the Qwen3-8B prefill at [serve]'s
   shape and of the [train] step, on the plain paths (the program the
   counters see), beside the device ms measured on CUDA events for each
   on the plain path and with K3 (the prefill timed on [serve]'s engine
   after [cluster], the step after [train]'s); compute and memory
   terms, the dominant one, the model's FLOPs, the share of the plain
   program's time that its bound is, and K3's speed-up over plain;
9d. the dry run's peak memory against the card's (``[memory]``):
   ``launch/dryrun.py``'s count on fake tensors of the plain Qwen3-8B
   [train] step (4 layers, seq 4096, batch 2, K3 off, the program the
   dry run counts), with no mesh in this process and with fsdp on a fake
   1 x 1 mesh in a child process (a fake group cannot share a process
   with NCCL), each beside the card's peak over one call of the same
   plain step: [train]'s no-mesh one (``step_breakdown``) and one over
   [mesh]'s 1 x 1 NCCL mesh; the two within 15 % of each other, and the
   count the dry run gave before it kept to the stand-ins' device
   printed beside them;
10. the TF-gRPC-Bench suite through ``repro_torch.launch.bench_comm``:
   p2p_latency, p2p_bandwidth and ps_throughput in both modes with the
   default payload and with ``--arch qwen3-8b``, and fully_connected on
   the collective transport. Serialized runs must launch the pack
   kernel (and unpack, where the family unpacks), non-serialized runs
   neither; then (``[sweep]``) two ``--sweep`` runs, p2p_latency over
   mode x payload and the ring on Qwen3-8B rows over mode x
   stream_chunks, with the same gates cell by cell and no cell in
   error, and one serialized cell under the profiler for the suite's
   device busy share; then (``[workload]``) a recorded Poisson workload
   and its replay, which must give identical rows (host only by design);
11. the channels on the card against the same channels on CPU rows,
    byte for byte (the CPU tests hold those equal to the JAX package),
    and ``--check-baseline benchmarks/BENCH_fabric.json``;
12. a JSON line of kernel numbers, then the result line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import logging
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "qwen3-8b"
BATCH, PROMPT_LEN, NEW_TOKENS, REQUESTS = 4, 512, 32, 3
SERVE_ARGS = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
              str(PROMPT_LEN), "--new-tokens", str(NEW_TOKENS),
              "--requests", str(REQUESTS)]
# the cases of tests/test_kernels.py: B, S, H, KV, dh, causal, window, cap
FA_CASES = [
    (2, 128, 4, 2, 64, True, None, None),
    (1, 256, 4, 4, 64, True, 64, None),
    (2, 128, 8, 2, 32, True, None, 50.0),
    (1, 192, 4, 1, 128, True, None, None),
    (2, 64, 4, 2, 64, False, None, None),
    (1, 320, 6, 2, 64, True, 128, 30.0),
]
# the wgmma path's edges, bf16: a ragged length (not a multiple of the
# 128-row tile), G = 1 / 4 / 8 q heads a kv head, non-causal, window with
# softcap; then the head dims whose last 64-column block is partial (80,
# 112) and dh 256's 64-key tiles
FA_WG_CASES = [
    (1, 200, 8, 2, 128, True, None, None),
    (2, 200, 4, 4, 64, True, None, None),
    (1, 256, 8, 1, 128, True, None, None),
    (1, 200, 8, 8, 128, False, None, None),
    (1, 320, 4, 1, 128, True, 100, 20.0),
    (1, 200, 8, 8, 80, True, None, None),
    (2, 130, 8, 1, 112, False, 48, 30.0),
    (1, 200, 8, 1, 256, True, None, 50.0),
    (2, 130, 8, 8, 256, False, 100, None),
]
# hubert-xlarge's 80 and kimi-k2-1t-a32b's 112, instances of their own
# read unpadded (bf16 on wgmma, fp32 on SIMT), on the cases above; then
# two head dims without an instance, run as the next one on zero-padded
# inputs (48 as 64, 96 as 112)
FA_NEW_HEAD_DIMS = (80, 112)
FA_PADDED_CASES = [(1, 100, 4, 2, 48, True, None, None),
                   (1, 90, 4, 2, 96, False, None, None)]
# the shapes the new head dims meet: hubert-xlarge's attention in training
# (16 heads of 80, kv 16, non-causal, seq 4096) and kimi-k2's (64 heads of
# 112 over 8 kv heads, causal), batch 1
FA_HEAD_DIM_SHAPES = {"hubert-xlarge": (1, 4096, 16, 16, 80, False),
                      "kimi-k2-1t-a32b": (1, 4096, 64, 8, 112, True)}
# Kimi-K2-Instruct's MLA prefill as ``models/attention.py`` hands it to
# K3 (batch, prompts, heads, q / k dim, v dim): 64 heads of q and k at
# 192 (128 nope + 64 rope), v of 128 zero-padded to 192 (K3 runs it as
# its 256 instance), at the softmax scale 192^-0.5 (0.1 ln 32 + 1)^2 of
# YaRN; the serve cell's mean prompt and its longest
FA_MLA_SHAPE = (1, (1905, 4000), 64, 192, 128)
MLA_MSCALE = 0.1 * math.log(32.0) + 1.0
# K3's prefill shapes in the other served models (batch 4, prompt 512,
# causal) that Qwen3-8B's does not cover (Mixtral's is Qwen3-8B's: 32
# heads of 128 over 8, its window of 4096 binds nowhere in 512): Jamba's
# 64 heads of 128 over 8, Kimi-K2's 64 of 112 over 8, and Gemma-2-9B's 16
# of 256 over 8 with its attention softcap of 50 (its window of 4096 on
# alternate layers binds nowhere in 512 either); the last number is the
# softcap. Each is also checked per q tile (TILE_REL_TOL).
FA_PREFILL_SHAPES = {
    "jamba-1.5-large-398b": (BATCH, PROMPT_LEN, 64, 8, 128, None),
    "kimi-k2-1t-a32b": (BATCH, PROMPT_LEN, 64, 8, 112, None),
    "gemma2-9b": (BATCH, PROMPT_LEN, 16, 8, 256, 50.0)}
# Qwen3-8B's attention (q heads, kv heads, head dim), at [serve]'s
# prefill and [train]'s step
QWEN3_HEADS = (32, 8, 128)
# Gemma-2's prefill shape again with q scaled by SOFTCAP_Q_SCALE: the
# scaled logits q k / sqrt(dh) spread to about +-30 and past 100, where
# the softcap of 50 binds (at randn inputs they stay near +-1, where 50
# tanh(x / 50) is x to 1e-4 and a kernel without the softcap passes).
# There an error d in tanh moves a logit by 50 d: the tile bound must
# catch the softcap left out, and would catch a rough tanh
SOFTCAP_Q_SCALE = 30.0
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K3 at the Qwen3-8B training shape and at the head-dim shapes above,
# against plain, per (batch, head, 128-row q tile): mean|kernel - plain|
# / mean|plain|. An element of o is a mean over up to 4096 keys (about
# 1/64 of |v| at the last rows), so an absolute bound set by the first
# rows says nothing of the last; a tile's own scale does. Both round o
# to bf16 and differ by a few units in its last place (2^-8 relative).
# Controls must exceed the bound: one KV tile of TILE_DROP keys (the
# smaller of the kernel's KV tiles) dropped, for the rows after it where
# causal and for every row where not, and, where causal, the causal
# edge one key late in the last q tile only.
TILE = 128
TILE_DROP = 64
TILE_REL_TOL = 5e-3
# H100 SXM data sheet: HBM3 bytes/s and dense tensor-core bf16 FLOP/s
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12
# End-to-end logits, kernel vs plain, bf16, as max|diff| / max|plain|.
# Both paths compute the same function and round differently: the plain
# path softmaxes in fp32 and rounds the normalized probabilities to bf16
# before P @ V; the kernel rounds the unnormalized exp(s - m_running) to
# bf16, rescales its accumulator when the running max moves, divides by
# the fp32 sum at the end, and sums both products in another order. Each
# layer's attention output thus differs by a few bf16 units in the last
# place, and 36 residual layers carry that into the logits. The limit
# lies between what sound runs read and what the controls below read;
# the script fails if a control does not exceed it.
E2E_REL_TOL = 5e-2
# Controls: the kernel on the same prompts with one thing wrong, through
# the model's own attention options. "window" drops the first KV tile
# (64 keys) of the last position, and fewer keys of the 63 positions
# before it; "causal off" lets every position see the whole prompt.
E2E_CONTROLS = {"window S - 64": {"sliding_window": PROMPT_LEN - 64},
                "causal off": {"causal": False}}
# The reduced model in fp32: the kernel and the plain path are both fp32
# throughout, so they differ only in summation order.
E2E_FP32_TOL = 1e-4
KERNEL_SOURCES = ("flash_attention", "payload_pack", "rwkv6_scan",
                  "moe_decode", "ssd_scan")
# [cluster]: Qwen3-8B on a 2 ps x 2 worker cluster, 2 rounds; in each,
# each worker streams one of the serve CLI's request prompts (by index)
# in the same flush. Per policy, the dispatch counts per link it must
# give: round_robin cycles each worker's own shards (ps0 in round 0, ps1
# in round 1); scheduler_least_loaded sees no reported load when both
# workers dispatch (before the flush that serves them), so ties go to
# ps0.
CLUSTER_ROUNDS = ({"worker0": 0, "worker1": 1}, {"worker0": 2, "worker1": 0})
CLUSTER_POLICIES = {
    "round_robin": {f"worker{w}->ps{p}": 1 for w in (0, 1) for p in (0, 1)},
    "scheduler_least_loaded": {"worker0->ps0": 2, "worker1->ps0": 2}}
# RWKV-6: the served model, its WKV kernel-test cases (tests/test_kernels.py:
# BH, S, hs, chunk, with_u) at the reference's 1e-4, and the prefill shape
# (batch x 32 heads, prompt, head size 64, the time mix's chunk 16)
RWKV_ARCH = "rwkv6-1.6b"
RWKV_SERVE_ARGS = ["--arch", RWKV_ARCH] + SERVE_ARGS[2:]
WKV_CASES = [(4, 128, 64, 32, True), (2, 64, 32, 16, False),
             (3, 96, 64, 32, True), (1, 250, 64, 64, True)]
WKV_TOL = 1e-4
WKV_MAIN = (BATCH * 32, PROMPT_LEN, 64, 16)
FP32_FLOPS = 67e12         # H100 SXM data sheet, fp32 outside tensor cores
# End-to-end RWKV-6 logits, WKV kernel vs the plain chunked path, bf16, as
# max|diff| / max|plain|. Both compute the WKV in fp32 and differ only in
# summation order (about 1e-6 of y); the difference reaches the logits
# where it flips a bf16 rounding of the time mix's output or of the bf16
# residual stream, and 24 recurrent layers with squared-relu channel mixes
# carry those flips further than Qwen3-8B's 36 attention layers do: a
# sound run reads 0.0663 (where Qwen3-8B reads 0.0171). The wrong WKVs read
# 0.100 (cum in place of cum_{t-1}: a decay of 0.87-0.9975 a step applied
# once too often) and 1.41 (the state reset at every chunk). The limit
# lies between; the script fails if a control does not exceed it.
RWKV_E2E_REL_TOL = 8.5e-2
# The MoE and Mamba models served at full width (bf16 weights from seed
# 0), each cut in depth to what one 80 GB card holds beside its
# activations: (arch, layers kept, attention layers among them = K3
# launches a prefill). Mixtral: 8 of 32 layers, 11.9 B parameters.
# Jamba: positions 0-4 of its 8-layer period (a whole period is 45.1 B
# parameters, 90 GB), 24.0 B. Kimi-K2: 1 of 61 layers, 384 experts,
# 19.4 B. The depth is cut where the serve CLI builds its config
# (``phase_serve``); the CLI has no depth flag, as the reference's has
# none.
MOE_SERVE = (("mixtral-8x7b", 8, 8), ("jamba-1.5-large-398b", 5, 1),
             ("kimi-k2-1t-a32b", 1, 1))
# [moe_decode]: K5 at one decode token of the serve cells' models, bf16,
# as (k, d, f, experts held, router width): Mixtral-8x7B's top-2 of 8
# experts 4096 x 14336, Granite-4.0-H-Small's top-10 of 72 experts 4096
# x 768 and Kimi-K2-Instruct's top-8 of 384 experts 7168 x 2048, of which
# the card holds 8 (at each offset of K5_SHARE_OFFSETS: half the ids
# held, half not, whose rows must be exactly zero). Kernel vs
# plain within K5_TOL (atol and rtol, as the card tests hold it; outputs
# near 1): both accumulate in fp32 and round at the same points, so they
# differ by a bf16 rounding flip at most. The controls, one assignment's
# expert changed and the activation left out, must exceed it.
K5_SHAPES = {"mixtral-8x7b": (2, 4096, 14336, 8, 8),
             "granite-4.0-h-small": (10, 4096, 768, 72, 72),
             "kimi-k2-instruct": (8, 7168, 2048, 8, 384)}
K5_SHARE_OFFSETS = (0, 16)
K5_TOL = 2e-2
# [ssd_scan]: K6 at the mixers of the models that prefill through it,
# (batch, heads, d_state) with heads of 64, over one prompt of each
# length: Granite-4.0-H-Small's (128 heads, d_state 128) at 128, the
# serve cell's mean 1,905 and its longest 4,000; Jamba-1.5-Large's (256
# heads, d_state 16: another instance of the kernel) at [serve]'s batch
# 4 of 512. Kernel and plain are both fp32; they differ in the order of
# sums, the cumulative sum's rounding and ex2.approx, about 1e-6 of the
# outputs' scale. SSD_TOL of that scale holds y and the final state; the
# controls (the state dropped at every chunk boundary, every decay
# applied twice) must exceed it on y.
SSD_CASES = {"granite-4.0-h-small": (1, 128, 128, (128, 1905, 4000)),
             "jamba-1.5-large-398b": (4, 256, 16, (512,))}
SSD_TOL = 1e-4
# Gemma-2-9B served whole (42 layers of 16 q / 8 kv heads of 256, softcap
# 50, a window of 4096 on alternate layers, GeGLU, tied embeddings over a
# 256,000-token vocabulary, final logit softcap 30): 9.2 B parameters,
# 18.5 GB in bf16, so nothing is cut. K3 launches once a layer a prefill,
# at dh 256 on wgmma.
GEMMA_ARCH, GEMMA_LAYERS = "gemma2-9b", 42
# [sample]: Qwen3-8B served whole at this temperature through the serve
# CLI, which samples with JAX's key chain and Gumbel-max
# (``core/prng.py``). SAMPLE_CHAIN is that chain's draw keys from seed 0,
# 8 splits deep (``key, sub = split(key)``; tests/test_torch_sampling.py
# derives them from ``jax.random``). The noise on the card is held
# against the port's own on the CPU at (BATCH, Qwen3's vocabulary):
# random bits equal, bf16 Gumbel noise equal or one bf16 ulp apart, fp32
# within SAMPLE_F32_TOL (the two devices' fp32 ``log`` may round apart).
# SAMPLE_DRAWS draws of one key from fixed 16-way fp32 logits must pass
# a chi-square test against softmax(logits / T): 15 degrees of freedom,
# bound at p = 0.001.
SAMPLE_TEMPERATURE = 0.8
SAMPLE_CHAIN = ((928981903, 3453687069), (1353695780, 2116000888),
                (3531307783, 465290248), (1539457558, 118255239),
                (4274742258, 3380111416), (1093704277, 2843913905),
                (3905300018, 1047965080), (3381965182, 2262451415))
SAMPLE_VOCAB = 151936
SAMPLE_F32_TOL = 2e-6
SAMPLE_DRAWS, SAMPLE_WAYS, SAMPLE_CHI2_BOUND = 65536, 16, 37.697
# payload pack / unpack: the reference's kernel-test sizes (aligned, and
# lists drawn as its hypothesis property draws them), the unaligned
# sizes serialization hands the kernels, and the endpoint rows of the
# suite (the CLI's 8)
PP_ALIGNED = (128, 512, 1024, 128)
PP_UNALIGNED = (10, 1, 300, 4097, 77)
ROWS = 8
SUITE = [("p2p_latency", []), ("p2p_bandwidth", []),
         ("ps_throughput", ["--num-ps", "2", "--num-workers", "3"])]
SUITE_TIMES = ["--warmup", "0.2", "--duration", "1"]
# [sweep]: the paper's S/M/L generator across modes, and Qwen3-8B's rows
# (58,818,560 B a row) on the ring, measured on the card, 8 cells
SWEEPS = {
    "p2p_latency mode x payload": ["--benchmark", "p2p_latency", "--sweep",
                                   "mode,payload"],
    "ring collective Qwen3-8B mode x stream_chunks": [
        "--benchmark", "ring", "--transport", "collective", "--num-workers",
        "4", "--arch", ARCH, "--sweep", "mode,stream_chunks"]}
SWEEP_TIMES = ["--warmup", "0.2", "--duration", "0.5"]
# [workload]: a seeded Poisson trace (the generator's flags) served on 1
# ps x 2 workers (the serving flags, which the replay passes too)
WORKLOAD_GEN = ["--workload", "poisson", "--rate", "200", "--duration-s",
                "2"]
WORKLOAD_SERVE = ["--num-workers", "2"]
# Training at full width: Qwen3-8B cut to TRAIN_LAYERS of its 36 layers
# (every width kept, as the reference's examples/train_ps_mode.py cuts a
# config with dataclasses.replace), bf16 compute, fp32 masters, AdamW,
# remat nothing_saveable, host_batch data
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 4096, 2, 4
# The first step, flash kernel on against off, on the same params and
# batch: the loss and the global gradient norm relative to plain's, one
# layer's wq gradient as max|diff| / max|plain|. The two differ by the
# bf16 rounding of each layer's attention output (see E2E_REL_TOL),
# carried through 4 layers forward and back. Each limit lies between a
# sound run's reading and the control's (the kernel's output rows
# shifted by one position), which must break every one of them: loss
# 5.25e-6 / 5.27e-4, grad norm 5.89e-6 / 2.95e-3, wq 0.0068 / 0.245
# (NVIDIA H100 80GB HBM3, 700 W).
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_WQ_TOL = 5e-5, 1.5e-4, 5e-2
TRAIN_WQ_LAYER = 1
# hubert-xlarge at full width and depth, seq 4096, batch 1, 2 steps. Its
# attention is non-causal over random frames, so every row of its output
# is close to the mean of v, and shifting the rows by one moves the loss
# and the gradient norm about as much as the kernel's own bf16 rounding
# does: loss 2.99e-5 sound / 3.31e-5 control, grad norm 9.76e-6 /
# 5.18e-5 (NVIDIA H100 80GB HBM3, 700 W; the same digits with dh 80
# zero-padded to 128 and read unpadded). Only the wq gradient tells the
# two apart (0.00368 / 0.0866), so the control is held by the wq bound
# alone, which lies between; the loss and grad-norm bounds hold the sound
# run, 3x or more above every sound reading.
HUBERT_ARCH, HUBERT_STEPS = "hubert-xlarge", 2
HUBERT_BOUNDS = (1e-4, 2.5e-4, 2e-2)
HUBERT_CONTROL_BREAKS = (2,)
# Mixtral-8x7B at full width cut to 1 layer, seq 4096, batch 2, 4 steps
# (two layers' AdamW state would not fit beside the activations). Its
# router is discontinuous: where kernel and plain differ by a bf16
# rounding, a token whose top two experts nearly tie can route
# differently, so the step-0 readings carry the flips beside the
# rounding; the script counts them.
MIXTRAL_ARCH, MIXTRAL_LAYERS, MIXTRAL_STEPS = "mixtral-8x7b", 1, 4
MIXTRAL_BOUNDS = (TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_WQ_TOL)
# the reduced model in fp32, card against CPU: both fp32 throughout, so
# they differ in summation order only
TRAIN_FP32_TOL = 1e-4
# the checkpoint restart against the unfaulted run, both on the card:
# the embedding's backward adds with atomics, in an order that changes
# from run to run, so the two agree to rounding and not bit for bit
TRAIN_RESTART_TOL = 1e-5
TRAIN_SMALL = ["--seq-len", "128", "--global-batch", "4"]
# the reduced models trained in fp32 on the card against the CPU: the
# dense one, and the MoE and Mamba layers under autograd (reduced Jamba
# is one whole period: 7 Mamba layers, 1 attention layer, 4 MoE FFNs)
TRAIN_SMALL_ARCHS = (ARCH, MIXTRAL_ARCH, "jamba-1.5-large-398b")
# Training over a device mesh (``[mesh]``): the [train] phase's Qwen3-8B
# (4 layers, seq 4096, batch 2, AdamW, remat) with --ps-mode (fsdp on)
# through a 1 x 1 (data, model) mesh on NCCL at world size 1, MESH_STEPS
# steps; its step 0 against the no-mesh kernel step within the [train]
# bounds (world-size-1 collectives copy, so equal bits are expected and
# the line says whether they came); then Mixtral-8x7B cut to 1 layer
# with expert_sharding "ep" for one step, the per-shard MoE body and
# K3's per-shard entry on the card
MESH_STEPS, MESH_MIXTRAL_STEPS = 3, 1
# The recurrent mixers over the 1 x 1 mesh (``[mesh]``): RWKV-6 1.6B
# whole and Jamba's [serve] cut served ([serve]'s request-0 prompts,
# prefill then greedy decode, with no mesh and over the mesh, the
# config's fsdp: Jamba's MoE experts, 19 GB in bf16, gathered at use on
# the one rank), then RWKV-6 trained at full width cut to 2 layers, seq
# 1024, batch 2, through the plain chunked scan (K4 has no backward)
RWKV_LAYERS, JAMBA_ARCH = 24, "jamba-1.5-large-398b"
RWKV_MESH_LAYERS, RWKV_MESH_SEQ, RWKV_MESH_STEPS = 2, 1024, 3
# The dry run's peak against the card's (``[memory]``): the plain [train]
# step of Qwen3-8B (K3 off, as the dry run counts it), with no mesh and
# over the 1 x 1 mesh with fsdp; each count within MEMORY_REL_TOL of the
# card's peak over one call of that step. The card's peaks are kept here
# by the phases that run the step ([train]'s ``step_breakdown``, [mesh]),
# keyed (model, layers, mesh).
MEMORY_REL_TOL = 0.15
PLAIN_PEAKS: dict = {}
# device kernels by kind, for [profile] (first match wins): the port's own
# kernels, cuBLAS / CUTLASS products, PyTorch's indexed gathers and
# scatters (the collective transport's row permutations, embeddings),
# then its elementwise and reduction kernels
# (matched against the lower-cased kernel name)
KERNEL_KINDS = (("K3", ("fa_fwd",)), ("K4", ("rwkv6_scan",)),
                ("K6", ("ssd_scan",)),
                ("K1/K2", ("pp_kernel",)),
                ("gemm", ("nvjet", "gemm", "gemv", "xmma", "cutlass",
                          "sm90_")),
                ("index", ("indexselect", "index_elementwise", "gather",
                           "scatter")),
                ("softmax", ("softmax",)), ("reduce", ("reduce",)),
                ("elementwise", ("elementwise",)))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def valid_pairs(sq: int, skv: int, causal: bool, window) -> int:
    q = torch.arange(sq)[:, None]
    k = torch.arange(skv)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        ok &= q >= k
    if window is not None:
        ok &= (q - k) < window
    return int(ok.sum())


def attention_bound(q, k, v, causal, window):
    """(ms, what bounds it): each input read once and the output written
    once over HBM bandwidth, against the two products' FLOPs over the
    bf16 tensor-core peak (for this run's mask)."""
    B, Sq, H, dh = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * H * dh * valid_pairs(Sq, k.shape[1], causal, window)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def gpu_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn`` with L2 cold: each call
    sits between its own pair of events, after a 128 MiB write that
    evicts the 50 MB L2, and a sleep kernel first keeps the card busy
    until the host has queued every call, so host overhead between
    calls is not counted."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def demangled(symbol: str) -> str:
    """A kernel's mangled entry name as ``name<template args>``, through
    c++filt where the machine has it."""
    import shutil
    filt = shutil.which("c++filt")
    if filt:
        out = subprocess.run([filt, symbol], capture_output=True,
                             text=True).stdout.strip()
        out = out.replace("(anonymous namespace)::", "").split("(")[0]
        return out.removeprefix("void ") or symbol
    return symbol


def phase_build(name: str) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.build, KERNEL_SOURCES))
    print(f"[build] {', '.join(KERNEL_SOURCES)} -> sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          + ", ".join(f"{k} {_build.build_seconds[k]:.2f} s"
                      for k in KERNEL_SOURCES) + ")")
    for src in KERNEL_SOURCES:
        kernel = "?"
        for line in _build.build_log.get(src, "").splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line):
                print(f"[build] {src} {demangled(kernel)}: {line.strip()}")
    # K4 takes every exponential as ex2.approx: one MUFU.EX2 each in SASS
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build.build("rwkv6_scan"))],
                              capture_output=True, text=True).stdout
        print(f"[build] rwkv6_scan SASS: {sass.count('MUFU.EX2')} MUFU.EX2, "
              f"{sass.count('CALL')} calls")


@contextlib.contextmanager
def counting_pads():
    """K3's host pad (``ops.padded``) counting its calls, in ``n[0]`` of
    the list it yields, while the block runs; restored after it."""
    from repro_torch.kernels.flash_attention import ops
    n, host_pad = [0], ops.padded

    def counted(*args):
        n[0] += 1
        return host_pad(*args)
    ops.padded = counted
    try:
        yield n
    finally:
        ops.padded = host_pad


def k3_times(name: str, label: str, q, k, v, causal=True,
             cap=None) -> dict:
    """K3 / plain / SDPA at one shape, warm and L2 flushed, with the
    bound. SDPA takes no softcap: where ``cap`` is set it runs without
    it."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    calls = {"kernel": lambda: flash_attention(q, k, v, causal, None, cap),
             "plain": lambda: attention_plain(q, k, v, causal, None, cap),
             "sdpa": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=True)}
    before = dict(flash_attention.launches_by_path)
    warm = {key: cuda_ms(fn) for key, fn in calls.items()}
    cold = {key: gpu_ms(fn) for key, fn in calls.items()}
    bound_ms, bound_by = attention_bound(q, k, v, causal, None)
    # the path off the launch counters, which every version of the
    # package keeps (tools/bench_k3.py times another commit's through here)
    kpath = "+".join(p for p, n in flash_attention.launches_by_path.items()
                     if n != before[p])
    for how, t in (("warm", warm), ("L2 flushed", cold)):
        print(f"[kernel] {label} q{tuple(q.shape)} kv {k.shape[2]} "
              f"bf16 {'causal' if causal else 'non-causal'}"
              f"{f' softcap {cap}' if cap else ''} on "
              f"{name}, {how}: kernel ({kpath}) {t['kernel']:.4f} ms, "
              f"attention_plain {t['plain']:.4f} ms, SDPA"
              f"{' (no softcap)' if cap else ''} "
              f"{t['sdpa']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})")
    return {"path": kpath, "ms": warm["kernel"], "plain_ms": warm["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": warm["sdpa"], "ms_l2_flushed": cold["kernel"],
            "plain_ms_l2_flushed": cold["plain"],
            "library_ms_l2_flushed": cold["sdpa"],
            "library": f"SDPA{' without softcap' if cap else ''}"}


def phase_kernel(name: str) -> dict:
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention,
                                                     kernel_path, ops)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S, H, KV, dh, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for shape in ((B, S, H, dh), (B, S, KV, dh),
                              (B, S, KV, dh))]

    def strided(B, S, H, KV, dh, dtype):
        # head slices of one fused (B, S, H + 2 KV, dh) projection
        qkv = torch.randn((B, S, H + 2 * KV, dh), device="cuda",
                          generator=gen).to(dtype)
        return [qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]]

    def saturated(B, S, H, KV, dh, dtype):
        # the logits where the softcap binds (SOFTCAP_Q_SCALE)
        q, k, v = inputs(B, S, H, KV, dh, torch.float32)
        return [(t * s).to(dtype) for t, s in
                ((q, SOFTCAP_Q_SCALE), (k, 1.0), (v, 1.0))]

    def compare(case, dtype, make=inputs):
        B, S, H, KV, dh, causal, window, cap = case
        q, k, v = make(B, S, H, KV, dh, dtype)
        before = dict(flash_attention.launches_by_path)
        # host pads: a head dim with an instance of its own (80 and 112
        # among them) must reach the kernel unpadded
        with counting_pads() as pads:
            out = flash_attention(q, k, v, causal, window, cap)
            torch.cuda.synchronize()
        ran = [p for p, n in flash_attention.launches_by_path.items()
               if n != before[p]]
        padded = pads[0] > 0
        ref = attention_plain(q, k, v, causal, window, cap)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOLS[dtype]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        want = kernel_path(dtype)
        print(f"[kernel] {str(dtype)[6:]:8s} B={B} S={S} H={H} KV={KV} "
              f"dh={dh} causal={causal} window={window} softcap={cap}"
              f"{'' if make is inputs else ' ' + make.__name__}: path "
              f"{'+'.join(ran) or 'none'}"
              f"{f' (padded to {ops.padded_head_dim(dh)})' if padded else ''}"
              f" max_abs_err={err:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
        if ran != [want]:
            raise AssertionError(f"flash kernel ran {ran} on {case} "
                                 f"{dtype}, not {want}")
        if padded != (ops.padded_head_dim(dh) != dh):
            raise AssertionError(f"dh {dh} {'was' if padded else 'was not'}"
                                 f" padded on the host")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with "
                                 f"attention_plain on {case} {dtype}")
        return err, (q, k, v)

    for dtype in (torch.float32, torch.bfloat16):
        for case in FA_CASES:
            compare(case, dtype)
    for case in FA_WG_CASES:
        compare(case, torch.bfloat16)
        compare(case, torch.bfloat16, make=strided)
    new_err = 0.0
    for dh in FA_NEW_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for case in FA_CASES:
                e, _ = compare(case[:4] + (dh,) + case[5:], dtype)
                new_err = max(new_err, e)
    for dtype in (torch.float32, torch.bfloat16):
        for case in FA_PADDED_CASES:
            compare(case, dtype)
    main_case = (BATCH, PROMPT_LEN, *QWEN3_HEADS, True, None, None)
    compare(main_case, torch.bfloat16, make=strided)
    err, (q, k, v) = compare(main_case, torch.bfloat16)
    serving = k3_times(name, "Qwen3-8B prefill", q, k, v)
    del q, k, v
    train_case = (TRAIN_BATCH, TRAIN_SEQ, *QWEN3_HEADS, True, None, None)
    train_err, (q, k, v) = compare(train_case, torch.bfloat16)
    tile_err = tile_check(name, "Qwen3-8B training",
                          flash_attention(q, k, v, True), q, k, v, True)
    training = {"shape": f"q{tuple(q.shape)} bf16 causal",
                "max_abs_err": train_err, "tile_rel_err": tile_err,
                **k3_times(name, "Qwen3-8B training", q, k, v)}
    del q, k, v
    torch.cuda.empty_cache()
    head_dims = {}
    for arch, (B, S, H, KV, dh, causal) in FA_HEAD_DIM_SHAPES.items():
        e, (q, k, v) = compare((B, S, H, KV, dh, causal, None, None),
                               torch.bfloat16)
        tile = tile_check(name, arch, flash_attention(q, k, v, causal),
                          q, k, v, causal)
        head_dims[arch] = {
            "shape": f"q{tuple(q.shape)} kv {KV} bf16 "
                     f"{'causal' if causal else 'non-causal'}",
            "max_abs_err": e, "tile_rel_err": tile,
            **k3_times(name, arch, q, k, v, causal)}
        del q, k, v
        torch.cuda.empty_cache()
    prefill_shapes = {}
    for arch, (B, S, H, KV, dh, cap) in FA_PREFILL_SHAPES.items():
        e, (q, k, v) = compare((B, S, H, KV, dh, True, None, cap),
                               torch.bfloat16)
        tile = tile_check(name, f"{arch} prefill",
                          flash_attention(q, k, v, True, None, cap),
                          q, k, v, True, cap)
        prefill_shapes[arch] = {
            "shape": f"q{tuple(q.shape)} kv {KV} bf16 causal"
                     f"{f' softcap {cap}' if cap else ''}",
            "max_abs_err": e, "tile_rel_err": tile,
            **k3_times(name, f"{arch} prefill", q, k, v, True, cap)}
        del q, k, v
        torch.cuda.empty_cache()
    B, S, H, KV, dh, cap = FA_PREFILL_SHAPES["gemma2-9b"]
    label = "gemma2-9b prefill past the softcap"
    e, (q, k, v) = compare((B, S, H, KV, dh, True, None, cap),
                           torch.bfloat16, make=saturated)
    tile = tile_check(name, label, flash_attention(q, k, v, True, None, cap),
                      q, k, v, True, cap, softcap_control=True)
    softcap_binding = {"shape": f"q{tuple(q.shape)} x {SOFTCAP_Q_SCALE} kv "
                                f"{KV} bf16 causal softcap {cap}",
                       "max_abs_err": e, "tile_rel_err": tile}
    del q, k, v
    torch.cuda.empty_cache()
    mla_prefill = mla_check(name)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces":
                "src/repro/kernels/flash_attention/flash_attention.py:77",
            "max_abs_err": max(err, train_err), **serving,
            "training_shape": training, "head_dims": head_dims,
            "prefill_shapes": prefill_shapes,
            "softcap_binding": softcap_binding,
            "mla_prefill": mla_prefill,
            "head_dims_80_112_max_abs_err": new_err}


def mla_check(name: str) -> dict:
    """K3 at Kimi-K2-Instruct's MLA prefill (FA_MLA_SHAPE) as the model
    calls it: q and k of 192, v of 128 zero-padded to 192, YaRN's scale.
    The bf16 path must run on zero-padded inputs (192 has no instance);
    the output's v columns must lie within TOLS of plain and within
    TILE_REL_TOL per q tile (the whole tiles), its padded columns must
    be exactly zero, and the controls (the scale without YaRN's mscale^2,
    causal off) must exceed the tile bound. Then kernel / plain / SDPA
    times (SDPA and the bound at the padded v)."""
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention,
                                                     kernel_path)
    B, lens, H, dh, dv = FA_MLA_SHAPE
    scale = dh ** -0.5 * MLA_MSCALE ** 2
    tol = TOLS[torch.bfloat16]
    gen = torch.Generator(device="cuda").manual_seed(1)
    entries = {}
    for S in lens:
        q, k = (torch.randn((B, S, H, dh), device="cuda", generator=gen)
                .bfloat16() for _ in range(2))
        v = torch.randn((B, S, H, dv), device="cuda", generator=gen)
        vp = torch.nn.functional.pad(v.bfloat16(), (0, dh - dv))
        before = dict(flash_attention.launches_by_path)
        with counting_pads() as pads:
            full = flash_attention(q, k, vp, True, None, None, scale)
            torch.cuda.synchronize()
        ran = [p for p, n in flash_attention.launches_by_path.items()
               if n != before[p]]
        pad_max = full[..., dv:].abs().max().item()
        n = S // TILE * TILE

        def cols(t):
            return t[:, :n, :, :dv].contiguous()
        out = full[..., :dv]
        ref = attention_plain(q, k, vp, True, None, None, scale)[..., :dv]
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        sound, at = tile_rel(cols(full), cols(ref))
        past = {}
        for what, (causal, sc) in {"scale without mscale^2":
                                   (True, dh ** -0.5),
                                   "causal off": (False, scale)}.items():
            wrong = attention_plain(q, k, vp, causal, None, None, sc)
            past[what] = tile_rel(cols(wrong), cols(ref))[0]
            del wrong
        label = f"kimi-k2-instruct MLA prefill S={S}"
        print(f"[kernel] {label} q{tuple(q.shape)} v {dv} padded to {dh}, "
              f"scale {scale:.6f}, bf16 causal: path {'+'.join(ran)}"
              f"{' (padded on the host)' if pads[0] else ''}, "
              f"max_abs_err={err:.3g} tol={tol} {'ok' if ok else 'FAIL'}, "
              f"padded columns max |o| {pad_max}, per q tile max "
              f"{sound:.3g} at {at} (bound {TILE_REL_TOL}); controls: "
              + ", ".join(f"{c} {r:.3g} ("
                          f"{'caught' if r > TILE_REL_TOL else 'NOT caught'})"
                          for c, r in past.items()) + f" on {name}")
        if ran != [kernel_path(torch.bfloat16)] or not pads[0]:
            raise AssertionError(f"{label}: ran {ran}, padded "
                                 f"{bool(pads[0])}")
        if pad_max != 0:
            raise AssertionError(f"{label}: the padded v columns read "
                                 f"{pad_max}, not zero")
        if not ok or sound > TILE_REL_TOL:
            raise AssertionError(f"{label}: kernel vs plain {err:.3g}, "
                                 f"tile {sound:.3g}")
        missed = [c for c, r in past.items() if r <= TILE_REL_TOL]
        if missed:
            raise AssertionError(f"{label}: the tile bound misses {missed}")
        entries[str(S)] = {"shape": f"q{tuple(q.shape)} v {dv} padded to "
                                    f"{dh} bf16 causal",
                           "max_abs_err": err, "tile_rel_err": sound,
                           **k3_times(name, label, q, k, vp)}
        del q, k, v, vp, full, ref
        torch.cuda.empty_cache()
    return entries


def tile_rel(out: torch.Tensor, ref: torch.Tensor):
    """Per (batch, q tile, head) of (B, S, H, dh) outputs: mean|out - ref|
    / mean|ref| over the tile's rows and head dims. Returns (the largest,
    its (batch, tile, head))."""
    B, S, H, dh = ref.shape

    def tiles(t):
        return t.view(B, S // TILE, TILE, H, dh).mean((2, 4))
    r = tiles((out.float() - ref.float()).abs()) / tiles(ref.float().abs())
    i = int(r.argmax())
    return r.max().item(), tuple(int(x) for x in
                                 torch.unravel_index(torch.tensor(i),
                                                     r.shape))


def tile_check(name: str, label: str, out, q, k, v, causal: bool,
               softcap=None, softcap_control=False) -> float:
    """K3's output ``out`` on q, k, v against plain per q tile
    (TILE_REL_TOL), and the controls the bound must catch, computed under
    a wrong mask (by SDPA, or where a softcap is given by the plain
    formula, since SDPA takes none): the KV tile of TILE_DROP keys from
    S-1024 (from S/2 where S < 2048) dropped, for the rows after it where
    causal, for every row where not, and, where causal, the last q tile
    seeing one key past the causal edge; with ``softcap_control`` also
    the softcap left out (by SDPA)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_plain
    S, G = q.shape[1], q.shape[2] // k.shape[2]
    ref = attention_plain(q, k, v, causal, None, softcap)
    sound, at = tile_rel(out, ref)
    i = torch.arange(S, device=q.device)
    allowed = i[:, None] >= i[None, :] if causal else \
        torch.ones(S, S, dtype=torch.bool, device=q.device)
    lo = S - min(1024, S // 2)
    hi = lo + TILE_DROP
    dropped = (i[None, :] >= lo) & (i[None, :] < hi)
    masks = {f"keys {lo}-{hi - 1} dropped"
             f"{f' from row {hi} on' if causal else ''}":
                 allowed & ~(dropped & (i[:, None] >= hi) if causal
                             else dropped)}
    if causal:
        masks[f"rows from {S - TILE} on seeing key i+1"] = allowed | (
            (i[None, :] == i[:, None] + 1) & (i[:, None] >= S - TILE))
    masks = {what: (mask, softcap) for what, mask in masks.items()}
    if softcap_control:
        masks["softcap left out"] = (allowed, None)
    qt, kt, vt = (t.transpose(1, 2) for t in
                  (q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))

    def masked(mask, cap):
        if cap is None:
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)
        s = qt.float() @ kt.float().transpose(-1, -2) / q.shape[-1] ** 0.5
        s = (torch.tanh(s / cap) * cap).masked_fill(~mask, -1e30)
        return (torch.softmax(s, -1).to(vt.dtype) @ vt).to(q.dtype)
    controls = {}
    for what, (mask, cap) in masks.items():
        wrong = masked(mask, cap)
        controls[what] = tile_rel(wrong.transpose(1, 2), ref)
        del wrong
    del ref, qt, kt, vt
    print(f"[kernel] {label} q{tuple(q.shape)} kv {k.shape[2]} bf16 "
          f"{'causal' if causal else 'non-causal'}, per (batch, q tile of "
          f"{TILE}, head) mean|kernel - plain| / mean|plain|: max "
          f"{sound:.3g} at {at} (bound {TILE_REL_TOL}) on {name}")
    for what, (r, where) in controls.items():
        print(f"[kernel] {label} control, {what}: {r:.3g} at {where} "
              f"({'caught' if r > TILE_REL_TOL else 'NOT caught'})")
    if sound > TILE_REL_TOL:
        raise AssertionError(f"flash kernel at the {label} shape: tile "
                             f"error {sound} beyond {TILE_REL_TOL}")
    missed = [c for c, (r, _) in controls.items() if r <= TILE_REL_TOL]
    if missed:
        raise AssertionError(f"{label}: the tile bound misses the controls "
                             f"{missed}")
    return sound


def wkv_bound(BH: int, S: int, hs: int, chunk: int):
    """(ms, what bounds it) of one K4 launch: r, k, v, log_w and s0 read
    once, y and the final state written once, over HBM bandwidth, against
    the fp32 operations of the chunked form over the fp32 rate: per chunk
    the inclusive cumsum, the Lc(Lc-1)/2 causal pairs of A (two
    subtractions, an exp, two multiplies and an add per channel), the
    decay factors of r and k (a subtraction, an exp and a multiply each),
    A v over those pairs, r S, the state's decay and k^T v."""
    nbytes = 4 * (5 * BH * S * hs + 2 * BH * hs * hs)
    pairs = chunk * (chunk - 1) // 2
    per_chunk = (chunk * hs + 6 * pairs * hs + 6 * chunk * hs
                 + 2 * pairs * hs + 2 * chunk * hs * hs
                 + hs + hs * hs + 2 * chunk * hs * hs)
    flops = BH * (S // chunk) * per_chunk
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def phase_wkv(name: str) -> dict:
    """K4 against ``rwkv6_scan_plain`` and the sequential ``rwkv6_ref``
    (atol/rtol 1e-4), then its time at the RWKV-6 prefill shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.rwkv6_scan import (rwkv6_ref, rwkv6_scan,
                                                rwkv6_scan_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(BH, S, hs, with_u):
        return (randn(BH, S, hs), randn(BH, S, hs) * 0.5, randn(BH, S, hs),
                -torch.exp(randn(BH, S, hs) - 1.0), randn(BH, hs, hs) * 0.1,
                randn(BH, hs) * 0.5 if with_u else None)

    def plain(r, k, v, lw, s0, u, chunk):
        """The wrapper's padding and bonus term around the plain scan."""
        S = r.shape[1]
        chunk = min(chunk, max(8, S))
        pad = (-S) % chunk
        y, sT = rwkv6_scan_plain(*(F.pad(t, (0, 0, 0, pad))
                                   for t in (r, k, v, lw)), s0, chunk=chunk)
        y = y[:, :S]
        if u is not None:
            y = y + (r * k * u[:, None, :]).sum(-1, keepdim=True) * v
        return y, sT

    def compare(label, args, chunk, oracles):
        y, sT = rwkv6_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        err = 0.0
        finite = bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
        ok = finite
        for oname, (yo, so) in oracles.items():
            e = max((y - yo).abs().max().item(), (sT - so).abs().max().item())
            good = (torch.allclose(y, yo, atol=WKV_TOL, rtol=WKV_TOL)
                    and torch.allclose(sT, so, atol=WKV_TOL, rtol=WKV_TOL))
            print(f"[wkv] {label} vs {oname}: max_abs_err={e:.3g} "
                  f"tol={WKV_TOL} finite={finite} "
                  f"{'ok' if good and finite else 'FAIL'}")
            err, ok = max(err, e), ok and good
        if not ok:
            raise AssertionError(f"rwkv6_scan kernel disagrees on {label}")
        return err

    for BH, S, hs, chunk, with_u in WKV_CASES:
        args = inputs(BH, S, hs, with_u)
        compare(f"BH={BH} S={S} hs={hs} chunk={chunk} u={with_u}", args,
                chunk, {"plain": plain(*args, chunk),
                        "rwkv6_ref": rwkv6_ref(*args)})
    ones = torch.ones(2, 64, 32, device="cuda")
    strong = (ones, ones, ones, torch.full_like(ones, -30.0),
              torch.zeros(2, 32, 32, device="cuda"), None)
    compare("strong decay log_w=-30 chunk=16", strong, 16,
            {"plain": plain(*strong, 16)})
    BH, S, hs, chunk = WKV_MAIN
    args = inputs(BH, S, hs, True)
    err = compare(f"RWKV-6 1.6B prefill BH={BH} S={S} hs={hs} "
                  f"chunk={chunk} u=True", args, chunk,
                  {"plain": plain(*args, chunk)})

    # the model's layout: (B, S, H, hs) head slices of one fused
    # projection, read through strides, against the folded plain scan
    B, H = BATCH, BH // BATCH
    fused = randn(B, S, 4 * H, hs)
    r4, k4, v4, w4 = (fused[:, :, j * H:(j + 1) * H] for j in range(4))
    k4, w4 = k4 * 0.5, -torch.exp(w4 - 1.0)     # k4, w4 now contiguous
    s04 = randn(B, H, hs, hs) * 0.1
    u4 = randn(H, hs) * 0.5

    def fold(t):
        return t.transpose(1, 2).reshape(BH, S, hs)
    y4, sT4 = rwkv6_scan(r4, k4, v4, w4, s04, u4, chunk=chunk)
    torch.cuda.synchronize()
    yp, sTp = plain(*map(fold, (r4, k4, v4, w4)), s04.reshape(BH, hs, hs),
                    u4.repeat(B, 1), chunk)
    e4 = max((fold(y4) - yp).abs().max().item(),
             (sT4.reshape(BH, hs, hs) - sTp).abs().max().item())
    ok4 = (torch.allclose(fold(y4), yp, atol=WKV_TOL, rtol=WKV_TOL)
           and torch.allclose(sT4.reshape(BH, hs, hs), sTp, atol=WKV_TOL,
                              rtol=WKV_TOL))
    print(f"[wkv] RWKV-6 1.6B prefill, (B, S, H, hs) = {tuple(r4.shape)} "
          f"strided entry vs folded plain: max_abs_err={e4:.3g} "
          f"tol={WKV_TOL} {'ok' if ok4 else 'FAIL'}")
    if not ok4:
        raise AssertionError("rwkv6_scan's strided entry disagrees")
    err = max(err, e4)

    r, k, v, lw, s0, _ = args
    ms = gpu_ms(lambda: rwkv6_scan(r, k, v, lw, s0, chunk=chunk))
    plain_ms = gpu_ms(lambda: rwkv6_scan_plain(r, k, v, lw, s0, chunk=chunk))
    bound_ms, bound_by, nbytes, flops = wkv_bound(BH, S, hs, chunk)
    print(f"[wkv] RWKV-6 1.6B prefill ({BH}, {S}, {hs}) fp32 chunk {chunk} "
          f"on {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library none, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes} B, {flops / 1e9:.3f} GFLOP)")
    # the time mix's layout handling: the four fold copies, the kernel and
    # y's transpose back (as before the strided entry), against the kernel
    # reading and writing (B, S, H, hs) itself
    r4, v4 = r4.contiguous(), v4.contiguous()
    folded_ms = gpu_ms(lambda: rwkv6_scan(
        *map(fold, (r4, k4, v4, w4)), s04.reshape(BH, hs, hs),
        chunk=chunk)[0].reshape(B, H, S, hs).transpose(1, 2).contiguous())
    strided_ms = gpu_ms(lambda: rwkv6_scan(r4, k4, v4, w4, s04, chunk=chunk))
    print(f"[wkv] RWKV-6 1.6B time mix's scan with its layout on {name}: "
          f"fold copies + kernel + transpose {folded_ms:.4f} ms, strided "
          f"kernel {strided_ms:.4f} ms")
    return {"name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:65",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "folded_ms": folded_ms,
            "strided_ms": strided_ms}


def phase_moe_decode(name: str) -> dict:
    """K5 against ``moe_decode_plain`` at K5_SHAPES, with its two
    controls; in an expert share (fewer experts held than the router's)
    at each of K5_SHARE_OFFSETS, with half the ids on experts not held,
    whose rows must be exactly zero (and a control, one of them moved
    into the held range, must break that). Then kernel / plain / dense
    times (L2 flushed) beside the routed experts' byte bound. Returns the
    ``kernels`` line's entry: Mixtral's shape at the top level, the
    others under their names."""
    from repro_torch.kernels.moe_decode import moe_decode_ffn, \
        moe_decode_plain

    def off(out, ref) -> float:
        """The largest |out - ref| past K5_TOL (1 + |ref|): <= 0 within."""
        out, ref = out.float(), ref.float()
        return ((out - ref).abs() - K5_TOL * (1 + ref.abs())).max().item()

    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = {}
    for shape, (k, d, f, E, routed) in K5_SHAPES.items():
        ws = [(torch.randn(sz, device="cuda", generator=gen) * n ** -0.5)
              .bfloat16() for sz, n in (((E, d, f), d), ((E, d, f), d),
                                        ((E, f, d), f))]
        x = torch.randn(1, d, device="cuda", generator=gen).bfloat16()
        rows = x.expand(k, d)              # one token's row for its k slots
        if routed == E:
            cases = [(0, torch.randperm(E, device="cuda", generator=gen)[:k])]
        else:
            cases = []
            for e0 in K5_SHARE_OFFSETS:
                held = e0 + torch.randperm(E, device="cuda",
                                           generator=gen)[:k // 2]
                others = torch.cat([torch.arange(0, e0, device="cuda"),
                                    torch.arange(e0 + E, routed,
                                                 device="cuda")])
                away = others[torch.randperm(len(others), device="cuda",
                                             generator=gen)[:k - k // 2]]
                ids = torch.cat([held, away])
                cases.append((e0, ids[torch.randperm(k, device="cuda",
                                                     generator=gen)]))
        for e0, ids in cases:
            is_held = (ids >= e0) & (ids < e0 + E)
            rel = (ids - e0).clamp(0, E - 1)
            label = shape if routed == E else f"{shape} offset {e0}"
            before = moe_decode_ffn.launches
            out = moe_decode_ffn(rows, ids, *ws, "silu", e0)
            torch.cuda.synchronize()
            if moe_decode_ffn.launches != before + 1:
                raise AssertionError(f"[moe_decode] {label}: the kernel "
                                     f"was not launched")
            ref = moe_decode_plain(rows, ids, *ws, "silu", e0)
            first = int(is_held.nonzero()[0])
            wrong = ids.clone()
            wrong[first] = e0 + (int(rel[first]) + 1) % E
            r = rows[:, None, :]
            bare = torch.bmm(torch.bmm(r, ws[0][rel])
                             * torch.bmm(r, ws[1][rel]), ws[2][rel])[:, 0]
            controls = {
                "an expert changed": moe_decode_plain(rows, wrong, *ws,
                                                      "silu", e0),
                "no activation": torch.where(is_held[:, None], bare, 0)}
            err = (out.float() - ref.float()).abs().max().item()
            past = {c: off(out, v) for c, v in controls.items()}
            print(f"[moe_decode] {label} one token, top-{k} of {routed} "
                  f"experts ({E} held from {e0}) {d} x {f} bf16: "
                  f"max|kernel - plain| {err:.3e} (past K5_TOL: "
                  f"{off(out, ref):.3e}); controls past it: "
                  + ", ".join(f"{c} {v:.3e}" for c, v in past.items()))
            if off(out, ref) > 0:
                raise AssertionError(f"[moe_decode] {label}: kernel vs "
                                     f"plain {err:.3e} past K5_TOL")
            if any(v <= 0 for v in past.values()):
                raise AssertionError(f"[moe_decode] {label}: a control "
                                     f"stays within K5_TOL: {past}")
            if routed != E:
                away = ~is_held
                zero = out[away].abs().max().item()
                live = out[is_held].float().abs().amax(1).min().item()
                moved = ids.clone()
                moved[int(away.nonzero()[0])] = e0
                ctl = moe_decode_plain(rows, moved, *ws, "silu", e0)
                ctl_zero = ctl[away].abs().max().item()
                print(f"[moe_decode] {label}: ids {ids.tolist()}, rows of "
                      f"experts not held max |out| {zero} (must be 0), "
                      f"rows held min max|out| {live:.3e}; control (an id "
                      f"moved into the held range): those rows max |out| "
                      f"{ctl_zero:.3e} "
                      f"({'caught' if ctl_zero > 0 else 'NOT caught'})")
                if zero != 0 or live == 0:
                    raise AssertionError(f"[moe_decode] {label}: rows not "
                                         f"held {zero}, held {live}")
                if ctl_zero == 0:
                    raise AssertionError(f"[moe_decode] {label}: the "
                                         f"zero-row check misses the "
                                         f"control")
                del ctl
            del out, ref, controls, bare
        e0, ids = cases[0]
        n_held = int(((ids >= e0) & (ids < e0 + E)).sum())
        buf = torch.zeros(E, 1, d, device="cuda", dtype=torch.bfloat16)
        buf[(ids - e0)[(ids >= e0) & (ids < e0 + E)], 0] = x[0]

        def dense():
            inner = torch.nn.functional.silu(torch.bmm(buf, ws[0])) \
                * torch.bmm(buf, ws[1])
            return torch.bmm(inner, ws[2])

        ms = gpu_ms(lambda: moe_decode_ffn(rows, ids, *ws, "silu", e0))
        plain_ms = gpu_ms(lambda: moe_decode_plain(rows, ids, *ws, "silu",
                                                   e0))
        dense_ms = gpu_ms(dense)
        nbytes = n_held * 3 * d * f * 2
        bound_ms = nbytes / HBM_BPS * 1e3
        print(f"[moe_decode] {shape} on {name}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, dense (all {E} experts held, "
              f"{E * 3 * d * f * 2 / 1e6:.1f} MB) {dense_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms (bytes: {n_held} experts, "
              f"{nbytes / 1e6:.1f} MB at {HBM_BPS / 1e12} TB/s; the kernel "
              f"at {100 * bound_ms / ms:.1f} %)")
        entries[shape] = {"shape": f"top-{k} of {routed} experts ({E} held) "
                                   f"{d} x {f} bf16, one token",
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": "bytes",
                          "library_ms": dense_ms}
        del ws, buf
        torch.cuda.empty_cache()
    return {"name": "moe_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_decode.cu",
            "replaces": None, **entries["mixtral-8x7b"],
            **{s: e for s, e in entries.items() if s != "mixtral-8x7b"}}


def ssd_work(Bn: int, S: int, H: int, P: int, N: int, L: int = 64
             ) -> tuple:
    """(FLOPs, bytes) that one K6 call over Bn prompts of S tokens needs:
    per prompt, head and chunk of lc tokens the causal intra-chunk
    product (lc (lc + 1) / 2 pairs times P), the state's update and the
    inter-chunk read (lc P N each), and per prompt and chunk C.B over its
    causal pairs (shared by the heads); x, B, C, the log decays and the
    state read once, y and the final state written once, in fp32."""
    macs = 0
    for t0 in range(0, S, L):
        lc = min(L, S - t0)
        pairs = lc * (lc + 1) // 2
        macs += H * (pairs * P + 2 * lc * P * N) + pairs * N
    return 2 * Bn * macs, 4 * Bn * (2 * S * H * P + 2 * S * N + S * H
                                    + 2 * H * P * N)


def phase_ssd(name: str) -> dict:
    """K6 against ``ssd_scan_plain`` for each case of SSD_CASES and each
    of its lengths, with its two controls, then kernel / plain times (L2
    flushed) beside its bound. Returns the ``kernels`` line's entry:
    Granite's mean prompt at the top level, its other lengths under
    ``S <n>``, the other models' under ``<arch> S <n>``."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    P = 64
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    def off(out, ref) -> float:
        """The largest |out - ref| past SSD_TOL of ref's scale (and of
        |ref|): <= 0 within."""
        tol = SSD_TOL * (ref.abs().max() + ref.abs())
        return ((out - ref).abs() - tol).max().item()

    entries = {}
    for arch, (Bn, H, N, lengths) in SSD_CASES.items():
        for S in lengths:
            where = f"{arch} S {S}, batch {Bn}"
            args = (rn(Bn, S, H, P) * 0.1, rn(Bn, S, N), rn(Bn, S, N),
                    -0.5 * torch.rand((Bn, S, H), device="cuda",
                                      generator=gen),
                    rn(Bn, H, P, N) * 0.3)
            before = ssd_scan.launches
            y, h = ssd_scan(*args)
            torch.cuda.synchronize()
            if ssd_scan.launches != before + 1:
                raise AssertionError(f"[ssd_scan] {where}: the kernel was "
                                     f"not launched")
            yp, hp = ssd_scan_plain(*args)
            xh, Bm, Cm, log_a, h0 = args
            controls = {
                "state dropped at each chunk": torch.cat([ssd_scan_plain(
                    *(t[:, c:c + 64] for t in args[:4]), h0)[0]
                    for c in range(0, S, 64)], dim=1),
                "decays doubled": ssd_scan_plain(xh, Bm, Cm, 2 * log_a,
                                                 h0)[0]}
            err = max((y - yp).abs().max().item(),
                      (h - hp).abs().max().item())
            past = {c: off(v, yp) for c, v in controls.items()}
            print(f"[ssd_scan] {where}, {H} heads of {P}, d_state {N}, "
                  f"fp32: max|kernel - plain| {err:.3e} (y past SSD_TOL "
                  f"{off(y, yp):.3e}, state {off(h, hp):.3e}; y scale "
                  f"{yp.abs().max().item():.3g}); controls past it: "
                  + ", ".join(f"{c} {v:.3e}" for c, v in past.items()))
            if off(y, yp) > 0 or off(h, hp) > 0:
                raise AssertionError(f"[ssd_scan] {where}: kernel vs plain "
                                     f"{err:.3e} past SSD_TOL")
            if any(v <= 0 for v in past.values()):
                raise AssertionError(f"[ssd_scan] {where}: a control stays "
                                     f"within SSD_TOL: {past}")
            ms = gpu_ms(lambda: ssd_scan(*args))
            plain_ms = gpu_ms(lambda: ssd_scan_plain(*args), iters=5)
            flops, nbytes = ssd_work(Bn, S, H, P, N)
            t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
            bound_ms = max(t_ops, t_bytes)
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            print(f"[ssd_scan] {where} on {name}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {flops / 1e9:.2f} GFLOP at "
                  f"{FP32_FLOPS / 1e12:.0f} TFLOP/s fp32, "
                  f"{nbytes / 1e6:.1f} MB at {HBM_BPS / 1e12} TB/s); the "
                  f"kernel at {100 * bound_ms / ms:.1f} % of it")
            label = (f"S {S}" if arch == "granite-4.0-h-small"
                     else f"{arch} S {S}")
            entries[label] = {
                "shape": f"xh ({Bn}, {S}, {H}, {P}), d_state {N}, fp32",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}
            del args, y, h, yp, hp, controls
            torch.cuda.empty_cache()
    main = entries.pop("S 1905")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu", "replaces": None,
            **main, **entries}


def _frames():
    """The frames of tests/test_torch_package.py, zero-size buffers
    included."""
    import numpy as np

    from repro_torch.rpc import framing as fr
    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8)
            for n in (0, 1, 127, 128, 129, 1000, 0)]
    return [fr.make_frame(7, "Serve/generate", bufs, serialized=True),
            fr.make_frame(8, "Serve/generate", bufs, serialized=False),
            fr.make_frame(9, "Serve/generate", [], serialized=True),
            fr.stream_chunk(10, "Serve/generate_stream", bufs[:3], seq=3,
                            end=True, serialized=True),
            fr.make_frame(11, "x", bufs[1:4], serialized=True, reply=True,
                          budget_us=1234),
            fr.make_frame(12, "x", bufs[2:6], serialized=True)]


def suite_payloads():
    """(label, endpoint rows) of the suite's two payloads on the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.tfgrpc_bench import BenchConfig
    from repro_torch.core import channels as ch
    from repro_torch.core.payload import from_arch, generate_spec
    mesh = ch.make_net_mesh(ROWS, device="cuda")
    return [("default", ch.device_payload(mesh, generate_spec(BenchConfig()))),
            ("qwen3-8b", ch.device_payload(mesh, from_arch(
                get_config(ARCH))))]


def phase_pack(name: str) -> list:
    """K1 / K2 against their plain versions (bytes equal), then their
    times at the suite's two row shapes; returns their kernel entries."""
    import numpy as np

    from repro_torch.core import serialization
    from repro_torch.kernels.payload_pack import (pack, pack_plain, unpack,
                                                  unpack_plain)
    from repro_torch.rpc import framing as fr
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rows(sizes, r):
        return [torch.randint(0, 256, (r, s), generator=gen, device="cuda",
                              dtype=torch.uint8) for s in sizes]

    def diff(a, b):
        return (a.int() - b.int()).abs().max().item() if a.numel() else 0

    def check(label, bufs, pad):
        sizes = [b.shape[-1] for b in bufs]
        padded = [s + (-s) % 128 for s in sizes] if pad else sizes
        packed, _ = pack(bufs, pad=pad)
        outs = unpack(packed, sizes, pad=pad)
        torch.cuda.synchronize()
        e1 = diff(packed, pack_plain(bufs, padded))
        e2 = max(max(diff(a, b), diff(a, c)) for a, b, c in zip(
            outs, unpack_plain(packed, sizes, padded), bufs))
        print(f"[pack] {label}: {len(bufs)} buffers x {bufs[0].shape[0]} "
              f"rows, {packed.shape[-1]} B/row, pad={pad}: pack "
              f"max_abs_err {e1}, unpack max_abs_err {e2} (tolerance 0) "
              f"{'ok' if e1 == e2 == 0 else 'FAIL'}")
        if e1 or e2:
            raise AssertionError(f"payload_pack disagrees with plain on "
                                 f"{label}")
        return max(e1, e2)

    err = check("reference aligned sizes", rows(PP_ALIGNED, 1), True)
    rng = np.random.default_rng(0)
    for i in range(8):         # tests/test_kernels.py's property sizes
        sizes = rng.integers(1, 4097, rng.integers(1, 9)).tolist()
        err = max(err, check(f"reference property sizes {i}",
                             rows(sizes, 1), True))
    bufs = rows(PP_UNALIGNED, 4)
    err = max(err, check("unaligned serialization sizes", bufs, False))
    packed, meta = serialization.pack(bufs)
    if not (torch.equal(packed, torch.cat(bufs, -1)) and all(
            torch.equal(a, b)
            for a, b in zip(serialization.unpack(packed, meta), bufs))):
        raise AssertionError("serialization on the card is not the "
                             "concatenation")
    payloads = suite_payloads()
    for label, bufs in payloads:
        err = max(err, check(f"{label} payload", bufs, False))
        err = max(err, check(f"{label} payload", bufs, True))
    for frame in _frames():
        kw, nw = (fr.encode(frame, backend=b) for b in ("kernel", "numpy"))
        for wire in (kw, nw):
            back = fr.decode(wire, backend="kernel")
            if not (len(kw) == len(nw) and all(
                    np.array_equal(a, b) for a, b in zip(kw, nw))
                    and all(np.array_equal(a, b)
                            for a, b in zip(back.bufs, frame.bufs))):
                raise AssertionError(f"framing backend='kernel' differs "
                                     f"from numpy on frame {frame.call_id}")
    print(f"[pack] framing backend='kernel' wire bytes equal "
          f"backend='numpy' both ways on {len(_frames())} frames")

    entries = {}
    for label, bufs in payloads:
        sizes = [b.shape[-1] for b in bufs]
        packed, _ = pack(bufs, pad=False)
        nbytes = 2 * packed.numel()            # read once, written once
        bound = nbytes / HBM_BPS * 1e3
        t = {"payload_pack": (
            gpu_ms(lambda: pack(bufs, pad=False)),
            gpu_ms(lambda: pack_plain(bufs, sizes)),
            gpu_ms(lambda: torch.cat(bufs, dim=-1))),
            "payload_unpack": (
            gpu_ms(lambda: unpack(packed, sizes, pad=False)),
            gpu_ms(lambda: unpack_plain(packed, sizes, sizes)),
            gpu_ms(lambda: [p.contiguous()
                            for p in torch.split(packed, sizes, -1)]))}
        shape = f"{ROWS} x {packed.shape[-1]} B ({label} payload)"
        for k, (ms, plain_ms, lib_ms) in t.items():
            print(f"[pack] {k} {shape} on {name}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
                  f"{HBM_BPS / 1e12} TB/s)")
            entries.setdefault(k, {})[label] = {
                "shape": shape, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bound}
        del packed
    del payloads
    torch.cuda.empty_cache()
    out = []
    for k, line in (("payload_pack", 60), ("payload_unpack", 93)):
        main = entries[k]["qwen3-8b"]
        out.append({"name": k, "route": "cuda",
                    "source": "src/repro_torch/csrc/payload_pack.cu",
                    "replaces": f"src/repro/kernels/payload_pack/"
                                f"payload_pack.py:{line}",
                    "max_abs_err": err, **main, "bound_by": "bytes",
                    "default_payload": entries[k]["default"]})
    return out


def phase_suite(name: str) -> dict:
    """The main path of K1/K2: the paper's three families and
    fully_connected through the bench CLI, each with the launch counts
    set to 0 just before it and read just after; returns the launches
    summed over the phase."""
    from repro_torch.kernels.payload_pack import ops as pp
    from repro_torch.launch import bench_comm
    runs = [(fam, extra + payload + ["--mode", mode])
            for payload in ([], ["--arch", ARCH])
            for fam, extra in SUITE
            for mode in ("non_serialized", "serialized")]
    runs += [("fully_connected", ["--transport", "collective",
                                  "--num-workers", "4", "--mode", mode])
             for mode in ("non_serialized", "serialized")]
    total = {"payload_pack": 0, "payload_unpack": 0}
    for fam, args in runs:
        pp.pack.launches = pp.unpack.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rows = bench_comm.main(["--benchmark", fam] + args + SUITE_TIMES)
        k1, k2 = pp.pack.launches, pp.unpack.launches
        total["payload_pack"] += k1
        total["payload_unpack"] += k2
        row = rows[0]
        mode = args[args.index("--mode") + 1]
        serialized = mode == "serialized"
        label = f"{fam} {mode}{' --arch ' + ARCH if '--arch' in args else ''}"
        print(f"[suite] {label}: {row['metric']} = {row['value']:.6g}, "
              f"mean {row['mean_us']:.1f} us over {row['n_iters']} iters, "
              f"pack launches {k1}, unpack launches {k2} on {name}")
        if "device         : " + torch.cuda.get_device_name() not in \
                log.getvalue():
            raise AssertionError(f"{label}: the run did not name the card")
        if not row["value"] > 0:
            raise AssertionError(f"{label}: {row['metric']} = "
                                 f"{row['value']}")
        if not serialized and (k1 or k2):
            raise AssertionError(f"{label}: non-serialized run launched "
                                 f"pack {k1} / unpack {k2} times")
        if serialized:
            want_k2 = 0 if fam == "p2p_bandwidth" else k1
            if k1 < row["n_iters"] or k2 != want_k2:
                raise AssertionError(f"{label}: pack {k1}, unpack {k2} "
                                     f"launches for {row['n_iters']} "
                                     f"timed iterations")
    return total


def phase_sweep(name: str) -> dict:
    """``bench_comm --sweep`` on the card: SWEEPS, each cell one bench run
    with the pack / unpack counts set to 0 just before it and read just
    after (by wrapping ``core.bench.run``, which the sweep looks
    up at every cell). No cell may report an error; serialized cells must
    launch K1 at least once an iteration (and K2 as often, where the
    family unpacks), other cells neither. Then one serialized Qwen3-8B
    cell under torch.profiler: the suite's device busy share and an
    iteration's device time by kernel kind. Returns the launches summed
    over the phase."""
    from repro_torch.configs.tfgrpc_bench import BenchConfig
    from repro_torch.core import bench
    from repro_torch.core.payload import from_arch
    from repro_torch.configs import get_config
    from repro_torch.kernels.payload_pack import ops as pp
    from repro_torch.launch import bench_comm
    total = {"payload_pack": 0, "payload_unpack": 0}
    counts = []
    run = bench.run

    def counted(cfg, device="cuda"):
        pp.pack.launches = pp.unpack.launches = 0
        try:
            return run(cfg, device)
        finally:
            counts.append((pp.pack.launches, pp.unpack.launches))

    bench.run = counted
    try:
        for label, argv in SWEEPS.items():
            del counts[:]
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rows = bench_comm.main(argv + SWEEP_TIMES)
            dt = time.perf_counter() - t0
            print(f"[sweep] {label}: {len(rows)} cells in {dt:.1f} s on "
                  f"{name}")
            if len(counts) != len(rows):
                raise AssertionError(f"[sweep] {label}: {len(counts)} runs "
                                     f"for {len(rows)} rows")
            for row, (k1, k2) in zip(rows, counts):
                cell = ", ".join(f"{c}={row[c]}" for c in
                                 ("mode", "payload", "stream_chunks")
                                 if c in row)
                if "error" in row:
                    raise AssertionError(f"[sweep] {label} {cell}: "
                                         f"{row['error']}")
                total["payload_pack"] += k1
                total["payload_unpack"] += k2
                print(f"[sweep] {label} {cell}: {row['metric']} = "
                      f"{row['value']:.6g}, mean {row['mean_us']:.1f} us "
                      f"over {row['n_iters']} iters, pack launches {k1}, "
                      f"unpack launches {k2}")
                if row["mode"] == "serialized":
                    want_k2 = 0 if row["benchmark"] == "p2p_bandwidth" \
                        else k1
                    if k1 < row["n_iters"] or k2 != want_k2:
                        raise AssertionError(
                            f"[sweep] {label} {cell}: pack {k1}, unpack "
                            f"{k2} for {row['n_iters']} timed iterations")
                elif k1 or k2:
                    raise AssertionError(f"[sweep] {label} {cell}: "
                                         f"non-serialized cell launched "
                                         f"pack {k1} / unpack {k2}")
    finally:
        bench.run = run

    # the suite's device busy share: one serialized Qwen3-8B cell
    cfg = BenchConfig(benchmark="ring", transport="collective",
                      num_workers=4, stream_chunks=4, mode="serialized",
                      payload_spec=from_arch(get_config(ARCH)),
                      warmup_s=0.0, duration_s=0.3)
    prof = {}
    st = profiled(name, "suite: ring collective serialized Qwen3-8B rows, "
                  "4 workers, 4 chunks", lambda: bench.run(cfg, "cuda"),
                  stats=prof)
    if prof:
        iters = st.n_iters + 1              # and the untimed first call
        print(f"[sweep] device busy {100 * prof['busy_ms'] / prof['wall_ms']:.1f}"
              f" % of the run's wall time; one iteration's device time by "
              f"kind ({iters} iterations): "
              + ", ".join(f"{k} {v / iters:.4f} ms" for k, v in sorted(
                  prof["kinds"].items(), key=lambda kv: -kv[1]))
              + f"; mean {1e3 * st.mean_s:.4f} ms an iteration on the host "
              f"clock")
    return total


def phase_workload(name: str) -> None:
    """``bench_comm --workload``: a seeded Poisson trace recorded with
    --trace-out, then replayed with --workload trace; the two rows must be
    identical and every request resolved. Host only by design, as in the
    reference: the synthetic engine runs no model on the device."""
    import tempfile
    from repro_torch.launch import bench_comm
    with tempfile.TemporaryDirectory() as tmp:
        trace = f"{tmp}/trace.json"
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            first = bench_comm.main(WORKLOAD_GEN + WORKLOAD_SERVE
                                    + ["--trace-out", trace])
            t1 = time.perf_counter()
            again = bench_comm.main(["--workload", "trace", "--trace-in",
                                     trace] + WORKLOAD_SERVE)
        t2 = time.perf_counter()
    slo = first[0]["slo"]
    print(f"[workload] {' '.join(WORKLOAD_GEN + WORKLOAD_SERVE)}: "
          f"{first[0]['events']} "
          f"events; ok {slo['completed_ok']}, errors {slo['errors']}, "
          f"deadline_exceeded {slo['deadline_exceeded']}, shed {slo['shed']}"
          f"; ttft p50 {1e3 * slo['ttft_s']['p50']:.3f} / p99 "
          f"{1e3 * slo['ttft_s']['p99']:.3f} ms, e2e p99 "
          f"{1e3 * slo['e2e_s']['p99']:.3f} ms (modeled clock); "
          f"{t1 - t0:.2f} s, replay {t2 - t1:.2f} s on the host: host only "
          f"by design (the synthetic engine runs no model; nothing on "
          f"{name})")
    if again != first:
        raise AssertionError("[workload] the replayed trace's row differs")
    if slo["completed_ok"] + slo["errors"] + slo["deadline_exceeded"] \
            != slo["offered"] or slo["offered"] != first[0]["events"]:
        raise AssertionError(f"[workload] unresolved requests: {slo}")
    print("[workload] --trace-out then --workload trace --trace-in: rows "
          "identical")


def phase_chain(name: str) -> None:
    """Channels on the card equal the same channels on CPU rows, byte
    for byte, then the committed modeled baseline checks clean."""
    from repro_torch.core import channels as ch
    from repro_torch.launch import bench_comm
    n, sizes = 4, (10, 300, 1024, 5000)
    gen = torch.Generator().manual_seed(1)
    host = [torch.randint(0, 255, (n, s), generator=gen, dtype=torch.uint8)
            for s in sizes]
    cases = {"echo": ("p2p_echo_fn", (), {}),
             "send": ("p2p_send_fn", (), {}),
             "ps_1x3": ("ps_round_fn", (1, 3), {}),
             "fc_4": ("fully_connected_fn", (4,), {}),
             "ring_4x2": ("ring_fn", (4,), {"n_chunks": 2}),
             "incast_3x2": ("permute_rounds_fn",
                            (ch.incast_schedule(3, n_chunks=2),), {})}
    checked = 0
    for label, (fname, args, kw) in cases.items():
        for ser in (False, True):
            outs = []
            for device in ("cuda", "cpu"):
                mesh = ch.make_net_mesh(n, device=device)
                fn = getattr(ch, fname)(mesh, len(host), *args,
                                        serialized=ser, **kw)
                outs.append([o.cpu() for o in fn(*[h.to(device)
                                                   for h in host])])
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"{label} serialized={ser}: card and "
                                     f"CPU rows differ")
            checked += 1
    outs = [[o.cpu() for o in ch.fsdp_pull_push_fn(
        ch.make_net_mesh(n, device=d), len(host))(*[h.to(d) for h in host])]
        for d in ("cuda", "cpu")]
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("fsdp_pull_push: card and CPU rows differ")
    print(f"[chain] {checked + 1} channel runs: card rows equal CPU rows "
          f"byte for byte on {name}")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        bench_comm.main(["--check-baseline",
                         str(ROOT / "benchmarks" / "BENCH_fabric.json")])
    print(f"[chain] {log.getvalue().strip()}")


@contextlib.contextmanager
def cut_depth(arch: str, layers):
    """The serve CLI's config of ``arch`` at full width with its first
    ``layers`` layers (all of them where None): the CLI builds its
    config from ``get_config`` and has no depth flag."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    if layers is None:
        yield get_config(arch).model.num_layers
        return
    full = get_config(arch)
    cut = full.replace(model=dataclasses.replace(full.model,
                                                 num_layers=layers))
    saved = serve.get_config
    serve.get_config = lambda a: cut if a == arch else saved(a)
    try:
        yield full.model.num_layers
    finally:
        serve.get_config = saved


def phase_serve(name: str, args: list, kernel, layers: int,
                depth=None) -> dict:
    """One main path: the serve CLI with ``args`` over streaming RPC,
    unary RPC and direct calls, with every kernel's count set to 0 just
    before and read just after; the model cut to its first ``depth``
    layers where given (``cut_depth``). Returns ``kernel``'s launches,
    which must be ``layers`` per prefill ("launches"), the direct path's
    engine ("engine", its weights reused by [cluster]) and its tokens
    ("direct", one (BATCH, NEW_TOKENS) array a request), the direct
    path's ms a decode step ("decode_ms"), K5's calls ("k5"): one a
    MoE layer each decode step the model runs (eager, or the warm-up and
    the capture of a slot's graph, whose replays rerun the captured
    launches) where the decode's BATCH * top-k is under the experts, and
    none elsewhere; and K6's calls ("k6"), one a Mamba layer a prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_decode import moe_decode_ffn
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.optim.optimizer import tree_leaves
    arch = args[args.index("--arch") + 1]
    vocab = get_config(arch).model.vocab_size
    modes = (("rpc/stream", []), ("rpc/unary", ["--unary"]),
             ("direct", ["--no-rpc"]))
    outputs, prefills, kept = {}, 0, None
    counted = (flash_attention, rwkv6_scan)
    for fn in counted + (moe_decode_ffn, ssd_scan):
        fn.launches = 0
    steps = dict.fromkeys(("eager_decodes", "graph_captures",
                           "graph_replays"), 0)
    flash_attention.launches_by_path = dict.fromkeys(
        flash_attention.launches_by_path, 0)
    for label, extra in modes:
        kept = None       # one model on the card at a time
        _free()
        torch.cuda.reset_peak_memory_stats()
        with cut_depth(arch, depth) as full_depth:
            res = serve.main(args + extra)
        eng = res["engine"]
        if label == "rpc/stream":
            n = sum(t.numel() for t in tree_leaves(eng.params))
            print(f"[serve] {arch} at full width "
                  + (f"cut to {depth} of {full_depth} layers"
                     if depth is not None else f"and depth ({full_depth} "
                                               f"layers)")
                  + f": {n} parameters (counted from the tensors), "
                  f"{eng.acfg.train.compute_dtype}")
        ops = eng.op_seconds
        n_pre = len(ops["prefill"])
        prefills += n_pre
        if any(s.stats()["preempted"] for s in eng.schedulers.values()):
            raise AssertionError("a request was preempted: rebuild "
                                 "prefills would not be counted")
        total_s = sum(res["seconds"])
        toks = sum(o.size for o in res["outputs"])
        print(f"[serve] {arch} {label}: "
              f"{1e3 * total_s / REQUESTS:.1f} ms/request, "
              f"prefill {1e3 * sum(ops['prefill']) / n_pre:.1f} ms, "
              f"decode {1e3 * sum(ops['decode']) / len(ops['decode']):.2f} "
              f"ms/token-step, {toks / total_s:.1f} tok/s, "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"on {name}")
        outputs[label] = res["outputs"]
        decode_ms = 1e3 * sum(ops["decode"]) / len(ops["decode"])
        for c in steps:
            steps[c] += eng.counters[c]
        mcfg = eng.acfg.model
        kept = eng
        del res, eng, ops
        _free()        # the engine and its schedulers refer to each other
    launches = {fn.__name__: fn.launches for fn in counted}
    for label, outs in outputs.items():
        if len(outs) != REQUESTS:
            raise AssertionError(f"{label}: {len(outs)} replies")
        for out in outs:
            if out.shape != (BATCH, NEW_TOKENS) or out.min() < 0 \
                    or out.max() >= vocab:
                raise AssertionError(f"{label}: bad tokens {out.shape}")
        for a, b in zip(outs, outputs["direct"]):
            if not (a == b).all():
                raise AssertionError(f"{label} tokens differ from direct")
    how = (f"sampled (T {args[args.index('--temperature') + 1]})"
           if "--temperature" in args else "greedy")
    print(f"[serve] {arch} {how} tokens identical across stream / unary / "
          f"direct; request 0 row 0: {outputs['direct'][0][0][:8].tolist()}")
    if launches[kernel.__name__] != layers * prefills or any(
            n for k, n in launches.items() if k != kernel.__name__):
        raise AssertionError(f"launches {launches} for {prefills} prefills "
                             f"of {layers} layers")
    by_path = dict(flash_attention.launches_by_path)
    if by_path["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"flash kernel launches by path {by_path}: "
                             f"not all on the wgmma path")
    print(f"[serve] {arch} {kernel.__name__} launches "
          f"{launches[kernel.__name__]} = {layers} x {prefills} prefills "
          f"(all launches: {launches}; flash by path: {by_path})")
    moe_layers = sum(mcfg.moe_at(i) for i in range(mcfg.num_layers))
    routed = mcfg.moe is not None and \
        BATCH * mcfg.moe.top_k < mcfg.moe.num_experts
    run = steps["eager_decodes"] + 2 * steps["graph_captures"]
    want = moe_layers * run if routed else 0
    if moe_decode_ffn.launches != want or (routed and not want):
        raise AssertionError(f"[serve] {arch}: K5 calls "
                             f"{moe_decode_ffn.launches}, {want} expected "
                             f"({moe_layers} MoE layers, decode steps "
                             f"{steps}, routed {routed})")
    if mcfg.moe is not None:
        print(f"[serve] {arch} K5 calls {moe_decode_ffn.launches} = "
              + (f"{moe_layers} MoE layers x {run} decode steps run "
                 f"outside a replay (decode T*k {BATCH * mcfg.moe.top_k} < "
                 f"E {mcfg.moe.num_experts})" if routed else
                 f"0 (decode T*k {BATCH * mcfg.moe.top_k} >= E "
                 f"{mcfg.moe.num_experts}: the dispatch)")
              + f"; decode steps {steps}")
    mamba_layers = sum(
        mcfg.layer_pattern[i % mcfg.pattern_period] == "mamba"
        for i in range(mcfg.num_layers))
    if ssd_scan.launches != mamba_layers * prefills:
        raise AssertionError(f"[serve] {arch}: K6 calls {ssd_scan.launches}"
                             f", {mamba_layers} Mamba layers x {prefills} "
                             f"prefills expected")
    if mamba_layers:
        print(f"[serve] {arch} K6 calls {ssd_scan.launches} = "
              f"{mamba_layers} Mamba layers x {prefills} prefills")
    return {"launches": launches[kernel.__name__], "engine": kept,
            "direct": outputs["direct"], "decode_ms": decode_ms,
            "k5": moe_decode_ffn.launches, "k6": ssd_scan.launches}


def phase_sample(name: str, greedy: list, decode_ms: float) -> int:
    """Temperature sampling, JAX's key chain and Gumbel-max
    (``core/prng.py``): the chain from seed 0 against SAMPLE_CHAIN and
    its hash on the card against the host's; the noise at (BATCH,
    SAMPLE_VOCAB) on the card against the CPU's; a chi-square test of
    SAMPLE_DRAWS draws; the sampler's ms and kernel launches a draw
    beside [serve]'s decode step, and its ms in turns with torch's own
    sampler (fp32 softmax and ``torch.multinomial``) on the same logits;
    then the main path, Qwen3-8B served whole at SAMPLE_TEMPERATURE three
    ways (``phase_serve``): tokens identical, some unlike [serve]'s
    greedy ones (``greedy``), 36 wgmma K3 launches a prefill. Returns
    K3's launches."""
    from repro_torch.core import prng
    from repro_torch.kernels.flash_attention import flash_attention
    dev = torch.device("cuda")
    key, subs = prng.prng_key(0), []
    for _ in SAMPLE_CHAIN:
        counters = torch.arange(2, dtype=torch.int64, device=dev)
        a, b = prng.threefry2x32(key[0], key[1], counters >> 32, counters)
        on_card = tuple(zip(a.tolist(), b.tolist()))
        key, sub = prng.split(key)
        if on_card != (key, sub):
            raise AssertionError(f"[sample] split on the card {on_card}, "
                                 f"on the host {(key, sub)}")
        subs.append(sub)
    if tuple(subs) != SAMPLE_CHAIN:
        raise AssertionError(f"[sample] key chain {subs} is not JAX's "
                             f"{SAMPLE_CHAIN}")
    print(f"[sample] key chain from seed 0, {len(subs)} splits: equals "
          f"JAX's (SAMPLE_CHAIN); each split hashed on the card equals "
          f"the host's")

    shape = (BATCH, SAMPLE_VOCAB)
    for width in (8, 32):
        if not torch.equal(prng.random_bits(subs[0], width, shape,
                                            dev).cpu(),
                           prng.random_bits(subs[0], width, shape)):
            raise AssertionError(f"[sample] {width}-bit random bits on "
                                 f"the card differ from the CPU's")
    ulps = prng.bf16_ulps(prng.gumbel(subs[0], shape, torch.bfloat16, dev),
                     prng.gumbel(subs[0], shape, torch.bfloat16))
    f32 = (prng.gumbel(subs[0], shape, torch.float32, dev).cpu()
           - prng.gumbel(subs[0], shape, torch.float32)).abs()
    print(f"[sample] noise at {shape}, card vs CPU: 8- and 32-bit random "
          f"bits equal; bf16 Gumbel {int((ulps > 0).sum())} of "
          f"{ulps.numel()} values apart, at most {ulps.max().item():.0f} "
          f"ulp (bound 1); fp32 Gumbel max|diff| {f32.max().item():.3g} "
          f"(bound {SAMPLE_F32_TOL:g}), {int((f32 > 0).sum())} values "
          f"apart")
    if ulps.max().item() > 1 or f32.max().item() > SAMPLE_F32_TOL:
        raise AssertionError("[sample] noise on the card is not the CPU's")

    logits = (torch.randn(SAMPLE_WAYS, generator=torch.Generator()
                          .manual_seed(0)) * 1.5).to(dev)
    chi2 = {}
    for dtype in (torch.float32, torch.bfloat16):
        lg = logits.to(dtype) / torch.tensor(SAMPLE_TEMPERATURE, dtype=dtype,
                                             device=dev)
        draws = prng.categorical(subs[1], lg.expand(SAMPLE_DRAWS, -1))
        seen = torch.bincount(draws, minlength=SAMPLE_WAYS).double()
        want = SAMPLE_DRAWS * torch.softmax(lg.double(), -1)
        chi2[dtype] = ((seen - want) ** 2 / want).sum().item()
    print(f"[sample] {SAMPLE_DRAWS} draws of 16-way fp32 logits at T "
          f"{SAMPLE_TEMPERATURE}: chi-square {chi2[torch.float32]:.2f} "
          f"(15 dof, bound {SAMPLE_CHI2_BOUND} at p = 0.001); in bf16, as "
          f"the reference draws at full width (7 random mantissa bits a "
          f"value), {chi2[torch.bfloat16]:.1f} (not a gate)")
    if not chi2[torch.float32] < SAMPLE_CHI2_BOUND:
        raise AssertionError("[sample] fp32 draws fail the chi-square test")

    vocab = torch.randn(shape, device=dev, dtype=torch.bfloat16)
    temp = torch.tensor(SAMPLE_TEMPERATURE, dtype=torch.bfloat16, device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)

    def draw():
        return prng.categorical(subs[2], vocab / temp)

    def multinomial():
        probs = torch.softmax(vocab.float() / SAMPLE_TEMPERATURE, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    ms = cuda_ms(draw)
    stats = {}
    profiled(name, f"sampler draw at {shape} bf16", draw, stats=stats)
    print(f"[sample] sampler: {ms:.3f} ms a draw at {shape} bf16 (events "
          f"over 20 draws), {stats.get('launches', 'not measured')} kernel "
          f"launches a draw (the division by T included); [serve]'s decode "
          f"step {decode_ms:.2f} ms, so {100 * ms / decode_ms:.1f} % of it, "
          f"on {name}")
    turns = [cuda_ms(fn) for fn in (draw, multinomial, multinomial, draw)]
    more = (turns[0] + turns[3] - turns[1] - turns[2]) / 2
    print(f"[sample] in turns on the same logits, ms a draw: JAX's chain "
          f"and Gumbel-max {turns[0]:.4f}, fp32 softmax and "
          f"torch.multinomial {turns[1]:.4f}, {turns[2]:.4f}, JAX's chain "
          f"{turns[3]:.4f}: {more:.4f} ms a draw more than multinomial, "
          f"on {name}")

    served = phase_serve(name, SERVE_ARGS + ["--temperature",
                                             str(SAMPLE_TEMPERATURE)],
                         flash_attention, 36)
    same = sum(int((a == b).sum()) for a, b in zip(served["direct"], greedy))
    total = sum(a.size for a in greedy)
    print(f"[sample] Qwen3-8B at T {SAMPLE_TEMPERATURE}: {total - same} of "
          f"{total} tokens differ from [serve]'s greedy ones")
    if same == total:
        raise AssertionError("[sample] sampled tokens equal the greedy ones")
    launches = served["launches"]
    del served
    _free()
    return launches


def phase_cluster(name: str, served: dict) -> int:
    """Cluster serving of Qwen3-8B at full width, on the weights [serve]
    drew: a ``ps_worker_cluster(2, 2)`` on RDMA, 2 rounds in which each
    worker streams one request (the serve CLI's prompts, batch 4) in the
    same flush, under each of CLUSTER_POLICIES. Every worker's greedy
    tokens must equal the direct path's for its prompts, K3 must launch
    36 times a prefill, all on wgmma (the counts set to 0 just before
    each policy's rounds and read just after), and the dispatch counts
    per link must be the policy's. Returns K3's launches."""
    import numpy as np

    from repro_torch import rpc as rpclib
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serve.engine import ServeEngine, decode_token_chunk
    kept = served["engine"]
    layers = kept.acfg.model.num_layers
    rng = np.random.default_rng(0)         # the serve CLI's prompts
    vocab = kept.acfg.model.vocab_size
    prompts = [rng.integers(0, vocab, (BATCH, PROMPT_LEN), dtype=np.int32)
               for _ in range(REQUESTS)]
    total = 0
    for policy, want_links in CLUSTER_POLICIES.items():
        cluster = rpclib.ps_worker_cluster(2, 2, ps_network="rdma_edr")
        metrics = rpclib.MetricsInterceptor(per_endpoint=True,
                                            endpoint_name=cluster.name_of)
        eng = ServeEngine(kept.acfg, kept.params, kept.cfg)
        fabric, stubs = eng.serve_cluster(
            cluster, policy=policy, client_interceptors=[metrics],
            server_interceptors=[metrics])
        flash_attention.launches = 0
        flash_attention.launches_by_path = dict.fromkeys(
            flash_attention.launches_by_path, 0)
        for rnd, picks in enumerate(CLUSTER_ROUNDS):
            t0 = time.perf_counter()
            calls = {w: stubs[w].generate_stream(prompts[i])
                     for w, i in picks.items()}
            fabric.flush()              # both workers' requests, one loop
            outs = {w: np.stack([decode_token_chunk(c) for c in h.result()],
                                axis=1) for w, h in calls.items()}
            dt = time.perf_counter() - t0
            toks = sum(o.size for o in outs.values())
            print(f"[cluster] Qwen3-8B {policy} round {rnd}: "
                  f"{1e3 * dt:.1f} ms ({toks / dt:.1f} tok/s aggregate, "
                  f"{len(outs)} workers x batch {BATCH} x {NEW_TOKENS} "
                  f"tokens), modeled clock {1e3 * fabric.now():.3f} ms on "
                  f"{name}")
            for w, i in picks.items():
                if outs[w].shape != (BATCH, NEW_TOKENS) or not (
                        outs[w] == served["direct"][i]).all():
                    raise AssertionError(f"[cluster] {policy} round {rnd} "
                                         f"{w}: tokens differ from the "
                                         f"direct path's")
        prefills = len(eng.op_seconds["prefill"])
        by_path = dict(flash_attention.launches_by_path)
        links = {k.split("@")[1]: v["calls"]
                 for k, v in metrics.snapshot().items()
                 if k.startswith("Serve/generate_stream@")}
        print(f"[cluster] Qwen3-8B {policy}: greedy tokens of every worker "
              f"equal the direct path's; dispatch per link {links}; flash "
              f"launches {flash_attention.launches} = {layers} x {prefills} "
              f"prefills (by path {by_path})")
        if prefills != sum(len(p) for p in CLUSTER_ROUNDS) or \
                flash_attention.launches != layers * prefills or \
                by_path["wgmma"] != flash_attention.launches:
            raise AssertionError(f"[cluster] {policy}: flash launches "
                                 f"{by_path} for {prefills} prefills")
        if links != want_links:
            raise AssertionError(f"[cluster] {policy}: dispatch per link "
                                 f"{links}, the policy says {want_links}")
        total += flash_attention.launches
        del eng, fabric, stubs
        gc.collect()
        torch.cuda.empty_cache()
    return total


def profile_steps(name: str, acfg, params, tokens, n_decode: int = 8):
    """Device busy share of one prefill and of greedy decode steps at the
    serving shape (torch.profiler's CUDA kernel times over host wall
    time), and the kernels that take most of the device time."""
    from repro_torch.launch import steps

    prefill = steps.make_prefill_step(acfg, max_seq=PROMPT_LEN + n_decode)
    decode = steps.make_decode_step(acfg, BATCH)

    def run():
        states, logits = prefill(params, {"tokens": tokens})
        for _ in range(n_decode):
            tok = logits[:, -1].argmax(-1)[:, None]
            states, logits = decode(params, states, tok)
        torch.cuda.synchronize()

    run()                                            # warm-up
    for label, fn in (("prefill", lambda: prefill(params,
                                                  {"tokens": tokens})),
                      (f"prefill + {n_decode} decode steps", run)):
        profiled(name, f"{acfg.model.name} {label}", fn)


def profiled(name: str, label: str, fn, top_n: int = 4,
             stats: dict = None):
    """Run ``fn`` once under torch.profiler and print its device busy
    share (CUDA kernel time over host wall time) and the kernels that
    take most of the device time; returns what ``fn`` returns. ``stats``,
    where given, receives wall_ms, busy_ms, launches and the device ms
    by kernel kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only: the kernels themselves, not the aten ops
    # that launched them (whose device time would count twice)
    avgs = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA
            and a.self_device_time_total > 0]
    busy_ms = sum(a.self_device_time_total for a in avgs) / 1e3
    if not avgs:
        print(f"[profile] {label}: wall {wall_ms:.1f} ms; device time not "
              f"measured (the profiler saw no CUDA kernels)")
        return out
    top = sorted(avgs, key=lambda a: -a.self_device_time_total)[:top_n]
    kinds = {}
    for a in avgs:
        kind = next((k for k, words in KERNEL_KINDS if any(
            w in a.key.lower() for w in words)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + a.self_device_time_total / 1e3
    if stats is not None:
        stats.update(wall_ms=wall_ms, busy_ms=busy_ms, kinds=kinds,
                     launches=sum(a.count for a in avgs))
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(a.count for a in avgs)} kernel launches; by kind: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
              kinds.items(), key=lambda kv: -kv[1]))
          + "; top: "
          + "; ".join(f"{a.key[:48]} {a.self_device_time_total / 1e3:.2f}"
                      f" ms x{a.count}" for a in top)
          + f" on {name}")
    return out


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| (Euclidean norms)."""
    return ((a - b).norm() / b.norm()).item()


def e2e_check(name: str, arch: str, last_logits, controls: dict,
              bound: float) -> None:
    """End to end, kernel vs plain: last-position logits of the CLI's
    first prompts at full width in bf16 (``last_logits(acfg, params,
    tokens, kernel)``) within ``bound`` of max|plain|; each control (label
    -> function of (acfg, params, tokens) giving a deliberately wrong
    path's logits) must exceed it. Then the reduced model in fp32."""
    import numpy as np

    from repro_torch.launch import serve
    rng = np.random.default_rng(0)       # the CLI's first prompts
    acfg, params = serve.init_model(arch, reduced=False, device="cuda")
    tokens = torch.as_tensor(rng.integers(0, acfg.model.vocab_size,
                                          (BATCH, PROMPT_LEN),
                                          dtype=np.int32), device="cuda")
    kern = last_logits(acfg, params, tokens, True)
    plain = last_logits(acfg, params, tokens, False)
    readings = {}
    for label, wrong_logits in controls.items():
        wrong = wrong_logits(acfg, params, tokens)
        readings[label] = rel(wrong, plain), rms(wrong, plain)
    profile_steps(name, acfg, params, tokens)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    what = acfg.model.name
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        raise AssertionError(f"{what}: non-finite logits")
    sound = rel(kern, plain)
    cos = torch.nn.functional.cosine_similarity(kern, plain, dim=-1)
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"[e2e] {what} bf16 last-position logits, kernel vs plain: "
          f"max|diff|/max|plain| = {sound:.4g} (bound {bound}; "
          f"|diff|/|plain| {rms(kern, plain):.4g}), min cosine "
          f"{cos.min().item():.6f}, argmax agreement {agree:.2f} on {name}")
    for label, (r, r2) in readings.items():
        print(f"[e2e] control ({what}), {label}, vs plain: "
              f"max|diff|/max|plain| = {r:.4g} (|diff|/|plain| {r2:.4g}) "
              f"({'caught' if r > bound else 'NOT caught'})")
    if sound > bound:
        raise AssertionError(f"{what}: end-to-end logits differ by "
                             f"{sound:.3g}")
    missed = [label for label, (r, _) in readings.items() if r <= bound]
    if missed:
        raise AssertionError(f"{what}: the end-to-end bound {bound} does "
                             f"not catch the controls {missed}")

    acfg, params = serve.init_model(arch, reduced=True, device="cuda")
    small = torch.as_tensor(rng.integers(0, acfg.model.vocab_size, (2, 40),
                                         dtype=np.int32), device="cuda")
    kern = last_logits(acfg, params, small, True)
    plain = last_logits(acfg, params, small, False)
    err = (kern - plain).abs().max().item()
    print(f"[e2e] reduced {what} fp32 (prompt 40), kernel vs plain: "
          f"max_abs_err {err:.3g} (bound {E2E_FP32_TOL})")
    if not torch.allclose(kern, plain, atol=E2E_FP32_TOL,
                          rtol=E2E_FP32_TOL):
        raise AssertionError(f"reduced {what} logits differ by {err:.3g}")


def phase_e2e(name: str) -> None:
    """Qwen3-8B with the flash kernel on and off; the controls run the
    kernel with attention options that drop or add keys."""
    import dataclasses

    from repro_torch.launch import steps

    def last_logits(acfg, params, tokens, flash, **attention):
        m = acfg.model
        if attention:
            m = dataclasses.replace(m, attention=dataclasses.replace(
                m.attention, **attention))
        cfg = acfg.replace(model=m, train=dataclasses.replace(
            acfg.train, use_flash_kernel=flash))
        _, logits = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
        return logits[:, -1].float()

    def control(kw):
        return lambda acfg, params, tokens: last_logits(acfg, params, tokens,
                                                        True, **kw)
    e2e_check(name, ARCH, last_logits,
              {f"the kernel with {label}": control(kw)
               for label, kw in E2E_CONTROLS.items()}, E2E_REL_TOL)


def _wkv_reset_each_chunk(r, k, v, log_w, s0, u=None, *, chunk=64):
    """Control: K4 with the state reset to zero at every chunk boundary
    (each chunk scanned as a row of its own). Takes and returns the time
    mix's (B, S, H, hs) layout."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    B, S, H, hs = r.shape
    n = S // chunk

    def fold(t):
        return t.transpose(1, 2).reshape(B * H * n, chunk, hs)
    y, sT = rwkv6_scan(fold(r), fold(k), fold(v), fold(log_w),
                       s0.new_zeros(B * H * n, hs, hs),
                       None if u is None else
                       u.repeat(B, 1).repeat_interleave(n, 0),
                       chunk=chunk)
    return (y.reshape(B, H, S, hs).transpose(1, 2),
            sT.reshape(B, H, n, hs, hs)[:, :, -1])


def _wkv_decay_early(r, k, v, log_w, s0, u=None, *, chunk=64):
    """Control: K4 reading each state after its own step's decay (cum in
    place of cum_{t-1}: r * w_t reads S_{t-1})."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    return rwkv6_scan(r * torch.exp(log_w), k, v, log_w, s0, u, chunk=chunk)


@contextlib.contextmanager
def wkv_patched(fn):
    """The RWKV-6 time mix calls ``fn`` in place of its scan
    (``rwkv6_scan_shard``, which takes ``rwkv6_scan``'s arguments)."""
    from repro_torch.models import ssm
    saved = ssm.rwkv6_scan_shard
    ssm.rwkv6_scan_shard = fn
    try:
        yield
    finally:
        ssm.rwkv6_scan_shard = saved


def phase_e2e_rwkv(name: str) -> None:
    """RWKV-6 1.6B with the WKV kernel on and off (the plain chunked
    path); the controls patch a wrong WKV into the time mix."""
    import dataclasses

    from repro_torch.launch import steps

    def last_logits(acfg, params, tokens, kernel):
        cfg = acfg.replace(train=dataclasses.replace(
            acfg.train, use_rwkv_kernel=kernel))
        _, logits = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
        return logits[:, -1].float()

    def control(fn):
        def wrong_logits(acfg, params, tokens):
            with wkv_patched(fn):
                return last_logits(acfg, params, tokens, True)
        return wrong_logits
    e2e_check(name, RWKV_ARCH, last_logits,
              {"the state reset at every chunk":
               control(_wkv_reset_each_chunk),
               "cum in place of cum_{t-1}": control(_wkv_decay_early)},
              RWKV_E2E_REL_TOL)


def train_shape(seq: int, batch: int):
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec("train", seq_len=seq, global_batch=batch, kind="train")


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def routing_flips(kern: list, plain: list, moe) -> tuple:
    """The (token, expert) assignments that one run makes and the other
    does not, over the MoE layers' forward calls (each a (T*k,) tensor
    of expert ids in (token, slot) order), and the assignments in all."""
    flips = total = 0
    for a, b in zip(kern, plain):
        rows = torch.arange(a.numel(), device=a.device) // moe.top_k
        made = []
        for ids in (a, b):
            m = torch.zeros(a.numel() // moe.top_k, moe.num_experts,
                            dtype=torch.bool, device=a.device)
            m[rows, ids] = True
            made.append(m)
        flips += int((made[0] & ~made[1]).sum())
        total += a.numel()
    return flips, total


def phase_train(name: str, arch: str, layers, batch_size: int, n_steps: int,
                bounds: tuple, breaks: tuple = (0, 1, 2),
                wq_layer: int = TRAIN_WQ_LAYER) -> int:
    """``arch`` at full width (cut to ``layers`` layers where not None),
    seq TRAIN_SEQ, through the train CLI's config (bf16 compute, fp32
    masters, the config's optimizer, remat):
    the first step with the flash kernel on and off within ``bounds``
    (loss, gradient norm, layer ``wq_layer``'s ``wq`` gradient), and the
    control (the kernel's output rows shifted by one position), which
    must break the bounds indexed by ``breaks``; for an MoE model also
    the (token, expert) assignments that differ between kernel and
    plain, and the router's aux loss beside the cross-entropy; then
    ``n_steps`` steps of
    the port's Trainer, the main path, with the launch counts set to 0
    just before and read just after: K3 must launch twice a layer a step
    (forward and remat's recompute), all on wgmma; then one more step's
    breakdown (``step_breakdown``). Returns (K3's launches on the main
    path, the mean ms of steps 1 on, that step's ms on CUDA events with
    K3 and plain)."""
    import dataclasses

    from repro_torch.data.pipeline import device_batch, host_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.launch import steps
    from repro_torch.launch.train import train_config
    from repro_torch.optim import optimizer as O
    from repro_torch.train.trainer import Trainer, TrainerConfig

    acfg = train_config(arch, reduced=False, device="cuda")
    if layers is not None:
        acfg = acfg.replace(model=dataclasses.replace(acfg.model,
                                                      num_layers=layers))
    what = f"{acfg.model.name} {acfg.model.num_layers} layers"
    seq, path = TRAIN_SEQ, "wgmma"
    shape = train_shape(seq, batch_size)
    n_params = acfg.model.num_params()
    trainer = Trainer(acfg, shape, TrainerConfig(total_steps=n_steps,
                                                 log_every=0), device="cuda")
    params, opt, _ = trainer.init_state(0)
    batch = device_batch(host_batch(acfg, shape, 0, trainer.dcfg), "cuda")

    # an MoE model's routing: each MoE layer's expert ids, forward only
    # (remat's recompute routes the same tokens again)
    import repro_torch.models.moe as moe_lib
    routed, dispatch = [], moe_lib._dispatch_indices
    n_moe = sum(map(acfg.model.moe_at, range(acfg.model.num_layers)))

    def recording(expert_idx, *args):
        if len(routed) < n_moe:
            routed.append(expert_idx.clone())
        return dispatch(expert_idx, *args)

    def first_step(flash: bool):
        cfg = acfg.replace(train=dataclasses.replace(
            acfg.train, use_flash_kernel=flash))
        routed.clear()
        metrics, grads = steps.loss_and_grads(steps.make_loss_fn(cfg),
                                              params, batch)
        out = (float(metrics["ce"] + metrics["aux"]),
               float(O.global_norm(grads)),
               grads["layers"][wq_layer]["mixer"]["wq"].float(),
               float(metrics["ce"]), float(metrics["aux"]), list(routed))
        del grads
        _free()
        return out

    moe_lib._dispatch_indices = recording
    try:
        kern, plain = first_step(True), first_step(False)
    finally:
        moe_lib._dispatch_indices = dispatch
    if acfg.model.moe is not None:
        flips, total = routing_flips(kern[5], plain[5], acfg.model.moe)
        print(f"[train] {what} step 0 routing, kernel vs plain: {flips} of "
              f"{total} (token, expert) assignments differ over "
              f"{len(kern[5])} MoE layers; ce {kern[3]:.6f} / "
              f"{plain[3]:.6f}, router aux loss {kern[4]:.6g} / "
              f"{plain[4]:.6g} on {name}")
        if not (kern[4] > 0 and plain[4] > 0):
            raise AssertionError(f"{what}: router aux loss {kern[4]}, "
                                 f"{plain[4]}")

    # the control: attention_forward looks flash_attention up on the
    # package at every call, so patching it there reaches the model
    import repro_torch.kernels.flash_attention as fa
    saved = fa.flash_attention
    fa.flash_attention = lambda q, k, v, *args: torch.roll(
        saved(q, k, v, *args), 1, dims=1)
    try:
        wrong = first_step(True)
    finally:
        fa.flash_attention = saved

    def readings(r):
        return (abs(r[0] - plain[0]) / abs(plain[0]),
                abs(r[1] - plain[1]) / abs(plain[1]), rel(r[2], plain[2]))
    sound, control = readings(kern), readings(wrong)
    print(f"[train] {what} at full width ({n_params} params), seq {seq}, "
          f"batch {batch_size}, step 0 kernel vs plain: loss {kern[0]:.6f} "
          f"/ {plain[0]:.6f} (rel {sound[0]:.3g}, bound {bounds[0]}), grad "
          f"norm {kern[1]:.6g} / {plain[1]:.6g} (rel {sound[1]:.3g}, bound "
          f"{bounds[1]}), layer {wq_layer} wq grad "
          f"max|diff|/max|plain| {sound[2]:.3g} (bound {bounds[2]}) on "
          f"{name}")
    caught = all(control[i] > bounds[i] for i in breaks)
    names = ", ".join(("loss", "grad norm", "wq")[i] for i in breaks)
    print(f"[train] {what} control, the kernel's output rows shifted by one "
          f"position, vs plain: loss rel {control[0]:.3g}, grad norm rel "
          f"{control[1]:.3g}, wq grad {control[2]:.3g} "
          f"({'caught' if caught else 'NOT caught'} by the {names} "
          f"bound{'s' if len(breaks) > 1 else ''})")
    if any(r > b for r, b in zip(sound, bounds)):
        raise AssertionError(f"{what} training step 0, kernel vs plain: "
                             f"{sound} beyond {bounds}")
    if not caught:
        raise AssertionError(f"{what}: the {names} bounds of {bounds} do "
                             f"not each catch the shifted kernel output "
                             f"{control}")
    # the train step is functional: params and opt held here would stay
    # alive beside every step's own, so the Trainer draws them again
    del kern, plain, wrong, params, opt, batch
    _free()

    # the main path: the Trainer's steps, launches counted per step
    per_step = []
    trainer.fault_hook = lambda step: per_step.append(
        dict(flash_attention.launches_by_path))
    flash_attention.launches = rwkv6_scan.launches = 0
    flash_attention.launches_by_path = dict.fromkeys(
        flash_attention.launches_by_path, 0)
    torch.cuda.reset_peak_memory_stats()
    params, opt = trainer.train(seed=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, by_path = flash_attention.launches, \
        dict(flash_attention.launches_by_path)
    per_step.append(by_path)
    step_launches = [{p: b[p] - a[p] for p in b if b[p] - a[p]}
                     for a, b in zip(per_step, per_step[1:])]
    losses = [r.loss for r in trainer.history]
    for r, n in zip(trainer.history, step_launches):
        print(f"[train] {what} step {r.step}: {1e3 * r.wall_s:.1f} ms, loss "
              f"{r.loss:.6f}, flash launches by path {n} on {name}")
    tokens = seq * batch_size
    steady = [r.wall_s for r in trainer.history[1:]]
    print(f"[train] {what}: steps 1-{n_steps - 1} mean "
          f"{1e3 * sum(steady) / len(steady):.1f} ms "
          f"({tokens * len(steady) / sum(steady):.0f} tok/s), "
          f"max_memory_allocated {peak:.2f} GiB, flash launches {launches} "
          f"(by path {by_path}), WKV launches {rwkv6_scan.launches} on "
          f"{name}")
    if not all(torch.isfinite(torch.tensor(losses))) or \
            len(losses) != n_steps:
        raise AssertionError(f"{what} training losses {losses}")
    want = 2 * acfg.model.num_layers
    if any(n != {path: want} for n in step_launches) or \
            rwkv6_scan.launches:
        raise AssertionError(f"{what}: flash launches per step "
                             f"{step_launches}, not {want} on {path} "
                             f"(forward and remat's recompute of each "
                             f"layer)")
    device_ms = step_breakdown(name, acfg, shape, trainer, params, opt,
                               n_steps)
    del params, opt, trainer
    _free()
    return launches, 1e3 * sum(steady) / len(steady), device_ms


def phase_mesh(name: str, arch: str, layers: int, n_steps: int,
               train_ms, *, seq: int = TRAIN_SEQ, grad: str = "wq",
               flash_per_layer: int = 2, plain_peak: bool = False,
               **parallel) -> dict:
    """``arch`` at full width cut to ``layers`` layers, trained with
    ``--ps-mode`` (and the ``parallel`` knobs) at ``seq`` through a
    1 x 1 NCCL mesh: step 0's loss, gradient norm and layer
    ``TRAIN_WQ_LAYER``'s ``grad`` gradient (layer 0's when there is one
    layer) against the no-mesh kernel step on the same params and batch,
    within the [train] bounds, then ``n_steps`` Trainer steps with K3
    counted per step (``flash_per_layer`` a layer, all wgmma) and K4 not
    at all (it has no backward), ms a step beside ``train_ms`` (the
    no-mesh step's; where None, a no-mesh Trainer's same steps, run
    first) and the peak. With ``plain_peak``, before the Trainer's steps,
    one call of the plain train step (K3 off, the program the dry run
    counts) on fresh state over the mesh, its card peak kept in
    ``PLAIN_PEAKS`` for [memory]. Returns K3's and K4's launches on the
    main path."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.data.pipeline import device_batch, host_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.launch.train import train_config
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O
    from repro_torch.parallel.sharding import full, make_ctx
    from repro_torch.train.trainer import Trainer, TrainerConfig

    # DTensor warns at every redistribute that sums over two mesh dims
    # (sequential all-reduces); on a 1 x 1 mesh they are copies
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    mesh_lib.init_single("cuda")
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device="cuda")
        acfg = train_config(arch, reduced=False, device="cuda", ps_mode=True)
        acfg = acfg.replace(
            model=dataclasses.replace(acfg.model, num_layers=layers),
            parallel=dataclasses.replace(acfg.parallel, **parallel))
        ctx = make_ctx(acfg, mesh)
        what = (f"{acfg.model.name} {layers} layers over a 1x1 mesh "
                f"(fsdp, {ctx.expert_sharding if acfg.model.moe else 'dense'})")
        shape = train_shape(seq, TRAIN_BATCH)
        wq_layer = min(TRAIN_WQ_LAYER, layers - 1)
        trainer = Trainer(acfg, shape, TrainerConfig(total_steps=n_steps,
                                                     log_every=0),
                          device="cuda", ctx=ctx)
        host = host_batch(acfg, shape, 0, trainer.dcfg)

        def first_step(c, params):
            metrics, grads = steps.loss_and_grads(
                steps.make_loss_fn(acfg, c), params,
                device_batch(host, "cuda", c))
            out = (float(metrics["ce"] + metrics["aux"]),
                   float(O.global_norm(grads)),
                   full(grads["layers"][wq_layer]["mixer"][grad]).float())
            del grads
            _free()
            return out

        def no_mesh_steps():
            one = Trainer(acfg, shape, TrainerConfig(total_steps=n_steps,
                                                     log_every=0),
                          device="cuda")
            torch.cuda.reset_peak_memory_stats()
            one.train(seed=0)
            walls = [r.wall_s for r in one.history[1:]] or \
                [r.wall_s for r in one.history]
            peak = torch.cuda.max_memory_allocated() / 2**30
            del one
            _free()
            print(f"[mesh] {acfg.model.name} {layers} layers with no mesh: "
                  f"{1e3 * sum(walls) / len(walls):.1f} ms a step, "
                  f"max_memory_allocated {peak:.2f} GiB on {name}")
            return 1e3 * sum(walls) / len(walls)
        if train_ms is None:
            train_ms = no_mesh_steps()

        gen = torch.Generator(device="cuda").manual_seed(0)
        params = M.init_params(acfg, device="cuda", generator=gen)
        plain = first_step(make_ctx(acfg, None), params)
        meshed = first_step(ctx, M.distribute_params(ctx, acfg, params))
        del params
        _free()
        got = (abs(meshed[0] - plain[0]) / abs(plain[0]),
               abs(meshed[1] - plain[1]) / abs(plain[1]),
               rel(meshed[2], plain[2]))
        same = (meshed[0] == plain[0] and meshed[1] == plain[1]
                and bool(torch.equal(meshed[2], plain[2])))
        bounds = (TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_WQ_TOL)
        print(f"[mesh] {what}, step 0 vs the no-mesh kernel step: loss "
              f"{meshed[0]:.6f} / {plain[0]:.6f} (rel {got[0]:.3g}), grad "
              f"norm {meshed[1]:.6g} / {plain[1]:.6g} (rel {got[1]:.3g}), "
              f"layer {wq_layer} {grad} grad {got[2]:.3g}, bounds {bounds}; "
              f"{'bit-identical' if same else 'NOT bit-identical'} on "
              f"{name}")
        if any(g > b for g, b in zip(got, bounds)):
            raise AssertionError(f"{what} step 0 vs no mesh: {got} beyond "
                                 f"{bounds}")
        if plain_peak:
            step = steps.make_train_step(acfg.replace(
                train=dataclasses.replace(acfg.train,
                                          use_flash_kernel=False)), ctx)
            params, opt, _ = trainer.init_state(0)
            batch = device_batch(host, "cuda", ctx)
            base = step_base(params, opt, batch)
            out = step(params, opt, batch)
            torch.cuda.synchronize()
            PLAIN_PEAKS[(arch, layers, "1x1")] = \
                torch.cuda.max_memory_allocated() - base
            del params, opt, batch, out
            _free()

        per_step = []
        trainer.fault_hook = lambda step: per_step.append(
            dict(flash_attention.launches_by_path))
        flash_attention.launches = rwkv6_scan.launches = 0
        flash_attention.launches_by_path = dict.fromkeys(
            flash_attention.launches_by_path, 0)
        torch.cuda.reset_peak_memory_stats()
        trainer.train(seed=0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches, wkv = flash_attention.launches, rwkv6_scan.launches
        per_step.append(dict(flash_attention.launches_by_path))
        step_launches = [{p: b[p] - a[p] for p in b if b[p] - a[p]}
                         for a, b in zip(per_step, per_step[1:])]
        losses = [r.loss for r in trainer.history]
        for r, n in zip(trainer.history, step_launches):
            print(f"[mesh] {what} step {r.step}: {1e3 * r.wall_s:.1f} ms, "
                  f"loss {r.loss:.6f}, flash launches by path {n} on {name}")
        steady = [r.wall_s for r in trainer.history[1:]] or \
            [r.wall_s for r in trainer.history]
        ms = 1e3 * sum(steady) / len(steady)
        beside = (f", [train]'s no-mesh step {train_ms:.1f} ms "
                  f"({100 * (ms / train_ms - 1):+.1f} %)" if train_ms
                  else "")
        print(f"[mesh] {what}: {ms:.1f} ms a step{beside}, "
              f"max_memory_allocated {peak:.2f} GiB, flash launches "
              f"{launches}, WKV launches {wkv} on {name}")
        want = flash_per_layer * layers
        if len(losses) != n_steps or not all(
                torch.isfinite(torch.tensor(losses))) or any(
                n != ({"wgmma": want} if want else {})
                for n in step_launches) or wkv:
            raise AssertionError(f"{what}: losses {losses}, flash launches "
                                 f"per step {step_launches}, not {want} on "
                                 f"wgmma; WKV launches {wkv}")
        del trainer
        _free()
        return {"K3": launches, "K4": wkv}
    finally:
        dist.destroy_process_group()


def phase_mesh_serve(name: str, arch: str, depth, served, kernel,
                     per_prefill: int, logits_tol: float,
                     **parallel) -> dict:
    """``arch`` served over a 1 x 1 NCCL mesh: the serve CLI's weights
    (seed 0, at full width, cut to ``depth`` layers where given), with
    the config's parallel knobs and ``parallel``; [serve]'s request-0
    prompts prefilled, then NEW_TOKENS - 1 greedy decode steps, first
    with no mesh and then over the mesh, on the same tensors (a 1 x 1
    mesh's placements copy nothing), each after one untimed prefill and
    decode step that warm it. The mesh run is the main path: its
    kernel counts are set to 0 just before it and read just after, and
    ``kernel`` must launch ``per_prefill`` times (and only once a layer
    on wgmma for K3), the other kernel never, and K6 once a Mamba
    layer. Its greedy tokens must equal [serve]'s direct tokens
    (``served``) and the no-mesh run's,
    its last-position prefill logits lie within ``logits_tol`` (max|diff|
    / max|no mesh|). Prints ms a request, ms a decode step and the peak
    beside the no-mesh run's. Returns K3's, K4's and K6's launches."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve, steps
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import NO_MESH, full, make_ctx

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    _free()
    mesh_lib.init_single("cuda")
    try:
        with cut_depth(arch, depth):
            acfg, params = serve.init_model(arch, reduced=False,
                                            device="cuda")
        acfg = acfg.replace(parallel=dataclasses.replace(acfg.parallel,
                                                         **parallel))
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device="cuda")
        ctx = make_ctx(acfg, mesh)
        what = (f"{acfg.model.name} {acfg.model.num_layers} layers over a "
                f"1x1 mesh (fsdp {'on' if ctx.fsdp else 'off'})")
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, acfg.model.vocab_size, (BATCH, PROMPT_LEN), dtype=np.int32),
            device="cuda")
        max_seq = PROMPT_LEN + NEW_TOKENS + 8       # the serve CLI's
        runs = {}
        for label, c in (("no mesh", NO_MESH), ("mesh", ctx)):
            p = M.distribute_params(c, acfg, params)
            prefill = steps.make_prefill_step(acfg, max_seq, c)
            decode = steps.make_decode_step(acfg, BATCH, c)
            # warm: the first collectives start NCCL's communicators
            decode(p, prefill(p, {"tokens": prompts})[0], prompts[:, :1])
            if label == "mesh":
                flash_attention.launches = rwkv6_scan.launches = 0
                ssd_scan.launches = 0
                flash_attention.launches_by_path = dict.fromkeys(
                    flash_attention.launches_by_path, 0)
            _free()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, logits = prefill(p, {"tokens": prompts})
            last = full(logits)[:, -1].float()
            toks = [last.argmax(-1).to(torch.int32)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(NEW_TOKENS - 1):
                states, logits = decode(p, states, toks[-1][:, None])
                toks.append(full(logits)[:, -1].argmax(-1).to(torch.int32))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            runs[label] = {
                "tokens": torch.stack(toks, 1).cpu().numpy(), "last": last,
                "request_ms": 1e3 * (t2 - t0), "prefill_ms": 1e3 * (t1 - t0),
                "decode_ms": 1e3 * (t2 - t1) / (NEW_TOKENS - 1),
                "peak": torch.cuda.max_memory_allocated() / 2**30}
            if label == "mesh":
                launches = {"K3": flash_attention.launches,
                            "K4": rwkv6_scan.launches,
                            "K6": ssd_scan.launches,
                            "K3 by path": dict(
                                flash_attention.launches_by_path)}
            del p, states, logits
        del params
        _free()
        one, on = runs["no mesh"], runs["mesh"]
        for key, unit in (("request_ms", "ms a request"),
                          ("prefill_ms", "ms a prefill"),
                          ("decode_ms", "ms a decode step"),
                          ("peak", "GiB peak")):
            print(f"[mesh] {what}: {on[key]:.2f} {unit}, no mesh "
                  f"{one[key]:.2f} ({100 * (on[key] / one[key] - 1):+.1f} "
                  f"%) on {name}")
        err = rel(on["last"], one["last"])
        same = bool(torch.equal(on["last"], one["last"]))
        print(f"[mesh] {what}: last-position prefill logits vs no mesh "
              f"max|diff|/max|no mesh| {err:.3g} (bound {logits_tol}; "
              f"{'bit-identical' if same else 'NOT bit-identical'}); "
              f"launches {launches}; request 0 row 0: "
              f"{on['tokens'][0][:8].tolist()}")
        if not torch.isfinite(on["last"]).all() or err > logits_tol:
            raise AssertionError(f"{what}: logits vs no mesh {err}")
        direct = served[0]
        if not ((on["tokens"] == one["tokens"]).all()
                and (on["tokens"] == direct).all()):
            raise AssertionError(f"{what}: greedy tokens differ from the "
                                 f"no-mesh run or [serve]'s")
        other = "K4" if kernel == "K3" else "K3"
        mcfg = acfg.model
        mamba_layers = sum(
            mcfg.layer_pattern[i % mcfg.pattern_period] == "mamba"
            for i in range(mcfg.num_layers))
        if launches["K6"] != mamba_layers:
            raise AssertionError(f"{what}: K6 calls {launches['K6']}, not "
                                 f"{mamba_layers} (one a Mamba layer)")
        if launches[kernel] != per_prefill or launches[other] or (
                kernel == "K3"
                and launches["K3 by path"]["wgmma"] != per_prefill):
            raise AssertionError(f"{what}: launches {launches}, not "
                                 f"{per_prefill} of {kernel} a prefill")
        print(f"[mesh] {what}: greedy tokens equal the no-mesh run's and "
              f"[serve]'s; {kernel} launches {launches[kernel]} = "
              f"{per_prefill} x 1 prefill")
        return {"K3": launches["K3"], "K4": launches["K4"],
                "K6": launches["K6"]}
    finally:
        dist.destroy_process_group()


def prefill_device_ms(name: str, engine) -> tuple:
    """A Qwen3-8B prefill of [serve]'s shape on its direct engine's
    weights, warm, on CUDA events, the mean of 3: with K3 (as served)
    and on the plain path (the program ``[roofline]`` counts). Returns
    (K3 ms, plain ms)."""
    import dataclasses

    import numpy as np

    from repro_torch.launch import steps
    acfg = engine.acfg
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, acfg.model.vocab_size, (BATCH, PROMPT_LEN), dtype=np.int32),
        device="cuda")
    out = []
    for flash in (True, False):
        cfg = acfg.replace(train=dataclasses.replace(
            acfg.train, use_flash_kernel=flash))
        prefill = steps.make_prefill_step(cfg, PROMPT_LEN + NEW_TOKENS + 8)
        out.append(cuda_ms(lambda: prefill(engine.params,
                                           {"tokens": tokens}),
                           iters=3, warmup=1))
    print(f"[roofline] {acfg.model.name} prefill (batch {BATCH}, prompt "
          f"{PROMPT_LEN}) on CUDA events: {out[0]:.2f} ms with K3, "
          f"{out[1]:.2f} ms plain on {name}")
    return tuple(out)


def phase_roofline(name: str, prefill_ms: tuple, train_ms: tuple) -> None:
    """The port's roofline (``launch/roofline.py``, counted on fake
    tensors on the host: the plain paths, no mesh, no process group) of
    the Qwen3-8B prefill at [serve]'s shape and of the train step at
    [train]'s (4 layers, seq 4096, batch 2): compute and memory terms,
    the dominant one and the model's FLOPs. The counted program is the
    plain one (K3 is a ctypes launch that no counter sees; the plain
    attention writes its fp32 scores), so the share of the bound is
    taken of the plain program's device ms, measured on CUDA events in
    this run (``prefill_ms`` / ``train_ms``: (K3 ms, plain ms)). The K3
    program's ms stands beside it, a different program with no count of
    its own: its ratio to the plain one is printed, not a share."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import train_config
    from repro_torch.parallel.sharding import NO_MESH
    serve_cfg = get_config(ARCH)     # served in bf16 weights, as the CLI
    serve_cfg = serve_cfg.replace(train=dataclasses.replace(
        serve_cfg.train, param_dtype=serve_cfg.train.compute_dtype))
    train_cfg = train_config(ARCH, reduced=False, device="cuda")
    train_cfg = train_cfg.replace(model=dataclasses.replace(
        train_cfg.model, num_layers=TRAIN_LAYERS))
    for label, acfg, shape, (k3_ms, ms) in (
            ("prefill", serve_cfg, ShapeSpec("prefill", PROMPT_LEN, BATCH,
                                             "prefill"), prefill_ms),
            ("train step", train_cfg, train_shape(TRAIN_SEQ, TRAIN_BATCH),
             train_ms)):
        t0 = time.perf_counter()
        rf = dryrun.roofline(NO_MESH, acfg, shape, "none")
        bound_ms = 1e3 * max(rf.compute_s, rf.memory_s)
        print(f"[roofline] {acfg.model.name} {acfg.model.num_layers} layers "
              f"{label} (batch {shape.global_batch}, seq {shape.seq_len}), "
              f"the plain program: {rf.flops_per_device:.4g} FLOP, "
              f"{rf.bytes_per_device:.4g} bytes (eager, unfused), compute_s "
              f"{rf.compute_s:.4g}, memory_s {rf.memory_s:.4g}, dominant "
              f"{rf.dominant}, model_flops {rf.model_flops:.4g}; measured "
              f"{ms:.2f} ms plain on {name}: the bound {bound_ms:.2f} ms is "
              f"{100 * bound_ms / ms:.1f} % of it, compute alone "
              f"{100 * 1e3 * rf.compute_s / ms:.1f} %; with K3 {k3_ms:.2f} "
              f"ms, {ms / k3_ms:.3f}x faster than plain (counted in "
              f"{time.perf_counter() - t0:.1f} s)")
        if not (rf.flops_per_device > 0 and rf.bytes_per_device > 0
                and rf.model_flops > 0 and ms > 0 and k3_ms > 0):
            raise AssertionError(f"[roofline] {label}: {rf.to_dict()}")


def arg_bytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees`` (a
    DTensor's: its local shard's)."""
    from torch.utils._pytree import tree_leaves
    seen = {}
    for t in tree_leaves(trees):
        if isinstance(t, torch.Tensor):
            st = getattr(t, "_local_tensor", t).untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def step_base(params, opt, batch) -> int:
    """Resets the card's peak and returns what is allocated besides a
    step's arguments: the card's peak over the step is then
    ``max_memory_allocated()`` less this, the arguments counted in, as
    the dry run counts them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() - arg_bytes(params, opt, batch)


def _like_with_stand_in(like):
    """``optimizer._like`` as it was before the dry run kept to the
    stand-ins' device: a ``meta`` stand-in at the global shape, made
    only to read its stride."""
    def old(t, ref, placements=None, shape=None):
        if hasattr(ref, "device_mesh"):
            torch.empty(tuple(ref.shape) if shape is None else tuple(shape),
                        device="meta").stride()
        return like(t, ref, placements, shape)
    return old


def dry_count(mesh: bool) -> dict:
    """The dry run's count (``launch/dryrun.py``: fake tensors on the
    host, ``MemTracker``) of the plain [train] step, Qwen3-8B 4 layers,
    seq 4096, batch 2: with no mesh, or with fsdp on a fake 1 x 1 mesh
    (which must be the process's only group). ``peak`` is what the dry
    run reports, the peak of the stand-ins' device; ``old`` what it
    reported before: the same step with ``optimizer._like`` making its
    ``meta`` stand-in, every device's peak summed."""
    import dataclasses

    from repro_torch.launch import dryrun
    from repro_torch.launch.train import train_config
    from repro_torch.optim import optimizer as O
    from repro_torch.parallel.sharding import NO_MESH, make_ctx
    acfg = train_config(ARCH, reduced=False, device="cuda", ps_mode=mesh)
    acfg = acfg.replace(model=dataclasses.replace(acfg.model,
                                                  num_layers=TRAIN_LAYERS))
    ctx = NO_MESH
    if mesh:
        from repro_torch.launch.mesh import make_test_mesh
        logging.getLogger("torch.distributed.tensor._redistribute"
                          ).setLevel(logging.ERROR)
        ctx = make_ctx(acfg, make_test_mesh(1, 1, fake=True))
    shape = train_shape(TRAIN_SEQ, TRAIN_BATCH)
    t0 = time.perf_counter()
    ma = dryrun.dry_run(ctx, acfg, shape)["memory_analysis"]
    like = O._like
    O._like = _like_with_stand_in(like)
    try:
        was = dryrun.dry_run(ctx, acfg, shape)["memory_analysis"]
    finally:
        O._like = like
    return {"peak": ma["peak_memory_in_bytes"],
            "args": ma["argument_size_in_bytes"],
            "other_devices": ma["other_devices"],
            "old": was["peak_memory_in_bytes"] + sum(
                d["Total"] for d in was["other_devices"].values()),
            "s": time.perf_counter() - t0}


def phase_memory(name: str) -> None:
    """The dry run's peak of the plain Qwen3-8B [train] step beside the
    card's peak over one call of that step (``PLAIN_PEAKS``), with no
    mesh (counted here) and over the 1 x 1 mesh with fsdp (counted on a
    fake mesh in a child process): both in GiB, their ratio and the old
    count; fails where a pair differs by more than MEMORY_REL_TOL of the
    card's."""
    child = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dry-count-1x1"],
        env=dict(os.environ, PYTHONPATH=str(SRC)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        counts = {"none": dry_count(False)}
        out, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    if child.returncode:
        raise AssertionError(f"[memory] the 1x1 count: rc "
                             f"{child.returncode}: {err[-2000:]}")
    counts["1x1"] = json.loads(out.strip().splitlines()[-1])
    gib, bad = 2**30, []
    for mesh, label in (("none", "no mesh"), ("1x1", "the 1x1 mesh, fsdp")):
        c = counts[mesh]
        card_b = PLAIN_PEAKS[(ARCH, TRAIN_LAYERS, mesh)]
        ratio = c["peak"] / card_b
        print(f"[memory] Qwen3-8B {TRAIN_LAYERS} layers plain train step "
              f"(seq {TRAIN_SEQ}, batch {TRAIN_BATCH}, K3 off), {label}: "
              f"dry run {c['peak']} B = {c['peak'] / gib:.3f} GiB (CPU "
              f"count, arguments {c['args'] / gib:.3f} GiB, other devices "
              f"{c['other_devices']}; counted in {c['s']:.1f} s), card "
              f"{card_b} B = {card_b / gib:.3f} GiB, dry run / card "
              f"{ratio:.5f} (bound {MEMORY_REL_TOL}); the old count, meta "
              f"summed in, {c['old']} B = {c['old'] / gib:.3f} GiB "
              f"({c['old'] / card_b:.5f} of the card's) on {name}")
        if abs(c["peak"] - card_b) > MEMORY_REL_TOL * card_b:
            bad.append((label, c["peak"], card_b))
    if bad:
        raise AssertionError(f"[memory] the dry run's peak against the "
                             f"card's beyond {MEMORY_REL_TOL}: {bad}")


def step_breakdown(name: str, acfg, shape, trainer, params, opt,
                   step: int) -> tuple:
    """One more step outside the counted run (data of ``step``): its two
    halves on CUDA events, the same step on the plain path (K3 off), with
    the card's peak over it kept in ``PLAIN_PEAKS`` (``step_base``), then
    the whole step under the profiler. Returns the step's ms on the
    events: (as configured, plain)."""
    import dataclasses

    from repro_torch.data.pipeline import device_batch, host_batch
    from repro_torch.launch import steps
    from repro_torch.optim import optimizer as O
    what = f"{acfg.model.name} {acfg.model.num_layers} layers"
    batch = device_batch(host_batch(acfg, shape, step, trainer.dcfg), "cuda")
    total = []
    for flash in (acfg.train.use_flash_kernel, False):
        cfg = acfg.replace(train=dataclasses.replace(
            acfg.train, use_flash_kernel=flash))
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        base = step_base(params, opt, batch)
        events[0].record()
        metrics, grads = steps.loss_and_grads(steps.make_loss_fn(cfg),
                                              params, batch)
        events[1].record()
        with torch.no_grad():
            updated = O.apply_updates(cfg.train, params, grads, opt)
        events[2].record()
        torch.cuda.synchronize()
        if not flash:
            PLAIN_PEAKS[(acfg.model.name, acfg.model.num_layers, "none")] = \
                torch.cuda.max_memory_allocated() - base
        total.append(events[0].elapsed_time(events[2]))
        print(f"[train] {what}, one step's halves on CUDA events"
              f"{'' if flash else ', plain'}: loss and gradients "
              f"{events[0].elapsed_time(events[1]):.1f} ms (ce "
              f"{float(metrics['ce']):.6f}, aux {float(metrics['aux']):.6g}"
              f"), {acfg.train.optimizer} update "
              f"{events[1].elapsed_time(events[2]):.1f} ms on {name}")
        del grads, updated
        _free()
    profiled(name, f"{what} one train step",
             lambda: trainer.step_fn(params, opt, batch)[2]["loss"], top_n=6)
    return tuple(total)


def phase_train_small(name: str) -> None:
    """The reduced model in fp32 on the card against the CPU; the train
    CLI with checkpoints, and a Trainer that fails at step 3 until it
    restarts from step_2; RWKV-6 1.6B through the CLI; the example."""
    import runpy
    import tempfile

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import init_params
    from repro_torch.optim import optimizer as O
    from repro_torch.train.trainer import Trainer, TrainerConfig

    # card against CPU, fp32, the same params
    shape = train_shape(128, 2)
    gen = torch.Generator().manual_seed(0)
    for arch in TRAIN_SMALL_ARCHS:
        losses = {}
        for device in ("cpu", "cuda"):
            acfg = train_cli.train_config(arch, reduced=True, device=device)
            params = init_params(acfg, device="cpu",
                                 generator=gen.manual_seed(0))
            params = O.tree_map(lambda t: t.to(device), params)
            tr = Trainer(acfg, shape, TrainerConfig(total_steps=3,
                                                    log_every=0),
                         device=device)
            tr.train(params=params,
                     opt=O.init_opt_state(acfg.train, params,
                                          period=acfg.model.pattern_period),
                     start_step=0)
            losses[device] = torch.tensor([r.loss for r in tr.history],
                                          dtype=torch.float64)
        err = (losses["cuda"] - losses["cpu"]).abs().max().item()
        print(f"[train] reduced {arch} fp32 "
              f"({acfg.model.num_layers} layers, {acfg.train.optimizer}), "
              f"3 steps, card vs CPU losses {losses['cuda'].tolist()} / "
              f"{losses['cpu'].tolist()}: max_abs_err {err:.3g} (bound "
              f"{TRAIN_FP32_TOL}) on {name}")
        if not torch.allclose(losses["cuda"], losses["cpu"],
                              atol=TRAIN_FP32_TOL, rtol=TRAIN_FP32_TOL):
            raise AssertionError(f"reduced {arch} training, card vs CPU: "
                                 f"{err:.3g}")

    # faults and checkpoints on the card
    with tempfile.TemporaryDirectory() as tmp:
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            clean = train_cli.main(["--arch", ARCH, "--reduced", "--steps",
                                    "6", "--ckpt-dir", f"{tmp}/clean",
                                    "--ckpt-every", "2"] + TRAIN_SMALL)
        print(f"[train] train CLI --reduced --steps 6 --ckpt-every 2 "
              f"{' '.join(TRAIN_SMALL)}: {log.getvalue().strip()} "
              f"(checkpoints {sorted(os.listdir(f'{tmp}/clean'))})")
        calls = []

        def fault(step):
            if step == 3 and len(calls) <= tcfg.max_step_retries:
                calls.append(step)
                raise RuntimeError("injected node failure")
        tcfg = TrainerConfig(total_steps=6, ckpt_dir=f"{tmp}/faulted",
                             ckpt_every=2, log_every=0)
        acfg = train_cli.train_config(ARCH, reduced=True, device="cuda")
        faulted = Trainer(acfg, train_shape(128, 4), tcfg, fault_hook=fault,
                          device="cuda")
        faulted.train()
    steps_run = [r.step for r in faulted.history]
    got = {r.step: r.loss for r in faulted.history}   # the rerun wins
    want = {r.step: r.loss for r in clean.history}
    err = max(abs(got[s] - want[s]) for s in want)
    print(f"[train] step 3 failed {len(calls)} times (max_step_retries "
          f"{tcfg.max_step_retries}), steps run {steps_run}: restarted from "
          f"step_2; losses against the unfaulted run max_abs_err {err:.3g} "
          f"(bound {TRAIN_RESTART_TOL}) on {name}")
    if steps_run != [0, 1, 2, 2, 3, 4, 5] or \
            len(calls) != tcfg.max_step_retries + 1:
        raise AssertionError(f"no restart from step_2: {steps_run}")
    if err > TRAIN_RESTART_TOL:
        raise AssertionError(f"restarted losses differ by {err:.3g}")

    # RWKV-6 1.6B at full width and depth through the CLI: no WKV launch
    flash_attention.launches = rwkv6_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tr = train_cli.main(["--arch", RWKV_ARCH, "--steps", "2",
                             "--seq-len", "1024", "--global-batch", "2"])
    print(f"[train] {RWKV_ARCH} through the train CLI, seq 1024, batch 2: "
          f"{log.getvalue().strip()}; step ms "
          f"{[round(1e3 * r.wall_s, 1) for r in tr.history]}, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, WKV "
          f"launches {rwkv6_scan.launches} on {name}")
    if rwkv6_scan.launches or flash_attention.launches or not all(
            torch.isfinite(torch.tensor([r.loss for r in tr.history]))):
        raise AssertionError(f"{RWKV_ARCH} training: WKV launches "
                             f"{rwkv6_scan.launches}, losses "
                             f"{[r.loss for r in tr.history]}")
    del tr
    _free()

    example = runpy.run_path(str(ROOT / "examples" / "torch_train_ps_mode.py"),
                             run_name="example")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tr, tr2 = example["main"](["--tiny"])
    print(f"[train] examples/torch_train_ps_mode.py --tiny: "
          + "; ".join(log.getvalue().strip().splitlines()) + f" on {name}")
    if not (len(tr.history) == 6 and tr2.history[0].step == 6):
        raise AssertionError("the example did not train and resume")
    _free()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc" / "flash_attention.cu").is_file():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name = card()
    print(f"[env] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    phase_build(name)
    kernel = phase_kernel(name)
    wkv = phase_wkv(name)
    packs = phase_pack(name)
    k5 = phase_moe_decode(name)
    k6 = phase_ssd(name)
    k5_by_path, k6_by_path = {}, {}
    served = phase_serve(name, SERVE_ARGS, flash_attention, 36)
    by_path = {"serve": served["launches"],
               "cluster": phase_cluster(name, served)}
    prefill_ms = prefill_device_ms(name, served["engine"])
    greedy, decode_ms = served["direct"], served["decode_ms"]
    del served
    _free()
    by_path["serve_sample"] = phase_sample(name, greedy, decode_ms)
    phase_e2e(name)
    served = phase_serve(name, RWKV_SERVE_ARGS, rwkv6_scan, 24)
    wkv_by_path = {"serve": served["launches"]}
    rwkv_tokens = served["direct"]
    del served
    phase_e2e_rwkv(name)
    on_mesh = phase_mesh_serve(name, RWKV_ARCH, None, rwkv_tokens, "K4",
                               RWKV_LAYERS, RWKV_E2E_REL_TOL)
    by_path["serve_mesh_rwkv"] = on_mesh["K3"]
    wkv_by_path["serve_mesh_rwkv"] = on_mesh["K4"]
    _free()
    for arch, depth, attn_layers in MOE_SERVE:
        served = phase_serve(name, ["--arch", arch] + SERVE_ARGS[2:],
                             flash_attention, attn_layers, depth)
        by_path[f"serve_{arch.split('-')[0]}"] = served["launches"]
        k5_by_path[f"serve_{arch.split('-')[0]}"] = served["k5"]
        if served["k6"]:
            k6_by_path[f"serve_{arch.split('-')[0]}"] = served["k6"]
        if arch == JAMBA_ARCH:
            jamba = (depth, attn_layers, served["direct"])
        del served
        _free()
    served = phase_serve(name, ["--arch", GEMMA_ARCH] + SERVE_ARGS[2:],
                         flash_attention, GEMMA_LAYERS)
    by_path["serve_gemma2"] = served["launches"]
    del served
    _free()
    on_mesh = phase_mesh_serve(name, JAMBA_ARCH, jamba[0], jamba[2], "K3",
                               jamba[1], E2E_REL_TOL)
    by_path["serve_mesh_jamba"] = on_mesh["K3"]
    wkv_by_path["serve_mesh_jamba"] = on_mesh["K4"]
    k6_by_path["serve_mesh_jamba"] = on_mesh["K6"]
    by_path["train"], train_ms, train_device_ms = phase_train(
        name, ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_STEPS,
        (TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_WQ_TOL))
    by_path["train_hubert"], _, _ = phase_train(
        name, HUBERT_ARCH, None, 1, HUBERT_STEPS, HUBERT_BOUNDS,
        HUBERT_CONTROL_BREAKS)
    by_path["train_mixtral"], mixtral_ms, _ = phase_train(
        name, MIXTRAL_ARCH, MIXTRAL_LAYERS, TRAIN_BATCH, MIXTRAL_STEPS,
        MIXTRAL_BOUNDS, wq_layer=0)
    by_path["train_mesh"] = phase_mesh(name, ARCH, TRAIN_LAYERS, MESH_STEPS,
                                       train_ms, plain_peak=True)["K3"]
    by_path["train_mesh_mixtral"] = phase_mesh(
        name, MIXTRAL_ARCH, MIXTRAL_LAYERS, MESH_MIXTRAL_STEPS, mixtral_ms,
        expert_sharding="ep")["K3"]
    on_mesh = phase_mesh(name, RWKV_ARCH, RWKV_MESH_LAYERS, RWKV_MESH_STEPS,
                         None, seq=RWKV_MESH_SEQ, grad="wr",
                         flash_per_layer=0)
    by_path["train_mesh_rwkv"] = on_mesh["K3"]
    wkv_by_path["train_mesh_rwkv"] = on_mesh["K4"]
    phase_roofline(name, prefill_ms, train_device_ms)
    phase_memory(name)
    kernel["launches_by_main_path"] = by_path
    kernel["launches"] = sum(by_path.values())
    wkv["launches_by_main_path"] = wkv_by_path
    wkv["launches"] = sum(wkv_by_path.values())
    k5["launches_by_main_path"] = k5_by_path
    k5["launches"] = sum(k5_by_path.values())
    k6["launches_by_main_path"] = k6_by_path
    k6["launches"] = sum(k6_by_path.values())
    phase_train_small(name)
    launches = phase_suite(name)
    swept = phase_sweep(name)
    for entry in packs:
        entry["launches"] = launches[entry["name"]] + swept[entry["name"]]
        entry["launches_by_main_path"] = {"suite": launches[entry["name"]],
                                          "sweep": swept[entry["name"]]}
    phase_workload(name)
    phase_chain(name)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(name)
    print(json.dumps({"kernels": [kernel] + packs + [wkv, k5, k6]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--dry-count-1x1"]:     # [memory]'s child process
        sys.path.insert(0, str(SRC))
        print(json.dumps(dry_count(True)))
        sys.exit(0)
    sys.exit(main())

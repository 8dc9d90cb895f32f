#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``autodist_tpu_torch/kernel/csrc``
(at first use, into a git-ignored directory) and drives the port's
paths: serving the pipelined LM at the serve bench's width (vocab 32768,
hidden 1024, 16 heads of 64, mlp 4096, 8 layers, max_len 1024),
training BERT-base masked-LM through ``AutoDist`` + ``AllReduce``,
the data-parallel strategy zoo on BERT (every builder of the collective
lowering, the compressors and accumulation, the default
``AutoDist(rs)``), Megatron tensor-parallel training of the pipelined
LM through
``Pipeline(tensor_parallel=2, vocab_parallel=True)`` at one pipe device
and on ``bench.py quant``'s 4-device mesh (the cross-process pipe
schedule over a pipe axis of 2, interleaved, with the Megatron stages
inside and the vocabulary sharded over the model axis), expert-parallel
training of the MoE LM through ``ExpertParallel`` on an expert axis of
2, serving at tensor parallel 2, and sequence-parallel training of the
causal LM through ``SequenceParallel`` on a seq axis of 2 (ring
attention over K1/K2a/K2b):

1. each kernel against its plain PyTorch version, fp32 (atol = rtol =
   1e-5) and bf16 (atol = rtol = 1e-2), timed with CUDA events beside
   the plain version, one PyTorch library call and the card's bound,
   each time with its achieved TFLOP/s:
   K5-K7 at the serving shapes, and again at the serve mix's occupancy
   (K5, K6: lengths 1-192; K7: 32 slots whose 64-row chunks start at 0),
   there also at a tensor-parallel rank's 8 heads (phase 10), and
   with one slot of 1024 keys (K7: a chunk at 960); K1, K2a
   and K2b at BERT-base's q/k/v ``[16, 512, 12, 64]`` and at ragged
   lengths 100 and 17, causal and not, and in bf16 at the ring chunk of
   phase 12, ``[8, 1024, 16, 64]``, full and causal (with the K2
   pair there); the registers, spills and static
   shared memory of K1, K2a, K2b (bf16), K5, K6 and K7 (both dtypes: K7's
   tensor-core and CUDA-core instances) from
   ``nvcc -Xptxas -v``; the K2 pair (the whole autograd backward
   through K2a and K2b, and its delta and casts alone) against SDPA's
   backward; K3 bit for bit (levels and scale) at the ring's chunk of
   2^21 elements, at the vocab-parallel prologue's 2^22, at 1, 1000,
   2^20 + 3 and 2^23 + 5 (more than the grid
   holds in registers), on exact ties (halves at scale 1), on all-zero
   chunks, with a NaN in local, and with
   q_in and local off a 16-byte boundary, each call one device kernel
   (``torch.profiler``), timed beside a plain copy of the same bytes;
   K4 at the two row-parallel shapes of phase 7, at a ragged 100 x 72 x
   40 and (bf16) at 100 x 70 x 38, whose unaligned rows the wrapper
   stages for TMA (counted); K8 bit for bit (arrived, levels and scale)
   at the MoE window's chunks of 2^21 and 2^20 elements and at 1, 1000,
   2^20 + 3 and 2^23 + 5, in the warm-up (scale_in 0, also on exact
   ties), a hop, the last
   hop (all-zero nxt), with a NaN in nxt, off a 16-byte boundary and
   writing arrived into a row of a wider output, each call one device
   kernel; the registers of K3's and K8's kernels;
2. fp32 parity: 4 requests through ``ContinuousBatcher`` on the dense
   and on the paged + chunked engine, each stream equal token for token
   to a greedy full recompute by ``sequential_logits`` (a divergence
   counts as a tie only where the reference's top two logits are within
   1e-4);
3. bf16 serving of the bench mix on both engines, each twice: with
   every decode window one CUDA-graph replay (the main path: one
   capture in the warm-up, then a replay a window, asserted) and with
   the window body launched from the host (``decode_graph=False``),
   the two routes' streams equal token for token; the kernels' launch
   counters held to the attention calls the engines made (and K7's
   CUDA-core instance to none: the serve path is bf16 over blocks of
   16), a profiled window's device time on each route, the flash
   decode kernel's included, and on the paged engine a profiled
   prefill chunk of 16 prompts with K7's device time a chunk;
4. fp32 training parity: a 2-layer BERT at full width, 3 AdamW steps
   with the flash attention and with the einsum attention on the same
   weights and batches, every loss within 1e-4 relative;
5. the bench's BERT-base training window in bf16 (``bench.py`` ``_bench``
   on one card: batch 16, seq 512, 76 masked, adamw(1e-4, weight decay
   0.01, bf16 first moments), ``AllReduce(chunk_size=256)``), with the
   flash and with the einsum attention, each on two routes: a warm
   30-step ``run_steps`` window (its capture) and a timed one, each one
   CUDA-graph replay (the main path; one capture and two replays
   asserted), then a warm and a timed loop of 30 ``step`` calls; K1,
   K2a and K2b held to 12 x 30 launches each on either route;
   examples/s, step time, MFU, peak memory (the capture's included),
   the capture's seconds, the profiler's busy share and launches per
   step;
6. fp32 tensor- and pipeline-parallel parity: the pipelined LM at full
   width cut to 2 layers, seq 128, 3 Adam steps, against one process at
   T = 1 (1e-4 relative): composed fp32 on T = 2 ranks at pipe 1, on a
   pipe axis of 2 (GPipe, 2 ranks) and on pipe 2 x model 2 (4 ranks);
   at pipe 1 and at pipe 2 x model 2 the fused collective matmul against
   the composed one (1e-5), the quantized ring against the composed
   int8 program (2e-2), and ``vocab_parallel`` against the full-vocab
   head (1e-5);
7. the slice's window in bf16 (``bench.py quant`` on an accelerator: 4
   layers, max_len 512, batch 16, ``num_microbatches=2``,
   ``adam(1e-3)``, ``vocab_parallel=True`` as ``bench.py:342`` runs
   it) for the composed fp32, composed int8 (the bare ``"int8"`` string
   of ``bench.py:342``: ``tp_psum``, ``vocab_stats`` and the ``grad``
   slot's ``int8_ef``), ``quant_ring`` (the same string and the fused
   ring) and ``collective_matmul`` programs, at pipe 1
   (``virtual_stages=4``, 2 ranks) and on ``bench.py quant``'s 4-device
   mesh, pipe 2 x model 2 (``virtual_stages=2``, 4 ranks), there also
   fp32 with the full-vocab head: tokens/s, step ms, peak memory per
   rank (the last pipe coordinate's held below the full head's),
   the profiler's busy share and K3's device time per step, the K3 and
   K4 launches of every rank held to 66 and 32 per step at pipe 1 and
   34 (pipe rank 0: the prologue's lookup ring) or 32 and 16 at pipe 2
   (a bubble tick runs no stage), no K4 operand staged and no K3 hop
   off the vector path; over gloo the lowering stages through host
   memory, and ``run_steps`` is asserted to keep its host loop (no
   capture);
8. fp32 MoE parity: the MoE LM at full width (vocab 32768, hidden 1024,
   16 heads, expert hidden 4096, 8 experts) cut to 1 layer, seq 128,
   batch 8, capacity factor 4.0 (no token is dropped, so sharded and
   dense routing agree), 3 Adam steps: the composed fp32, composed int8
   and ``a2a_ring`` programs on an expert axis of 2 against the dense
   one-process model through ``AllReduce``, every nll within 5e-3
   (``adam(1e-4)``);
9. the MoE window in bf16 (``bench.py moe`` on an accelerator: 2
   layers, max_len 512, capacity factor 2.0, 2 rows per rank,
   ``adam(1e-3)``, nothing cut) for the composed int8 and ``a2a_ring``
   programs: a warm window of 20 steps, then a timed one; tokens/s,
   step ms, peak memory per rank, the profiler's busy share and K8's
   device time per step, and K8 held to 16 launches a step (2 layers x dispatch and
   combine x forward and backward x 2 hops), none off the vector path,
   and ``run_steps`` on the host loop as in phase 7;
10. serving at tensor parallel 2 with the vocabulary sharded, on the
   serve mix's model cut to 4 layers (8 of the 16 heads a rank): fp32 streams
   of 3 requests on the dense and the paged + chunked engine equal the
   one-process engine's (a divergence counts as a tie where the
   recompute's top two logits are within 1e-4), then the bf16 serve mix
   on both: tokens/s, TTFT, inter-token latency, peak memory per rank,
   K5-K7 held to the attention calls; over gloo the decode windows run
   the host loop (asserted);
11. fp32 sequence-parallel parity: ``TransformerLM`` at full width cut
   to 2 layers, global seq 256, batch 4, 3 Adam steps on a seq axis of
   2 with the flash ring, the einsum ring and the flash ring under
   ``remat``, every loss within 1e-4 relative of one process running
   ``flash_attention`` causal over the whole sequence (remat against no
   remat: 1e-6);
12. the sequence-parallel window in bf16 (``bench.py:442-446``'s model,
   nothing cut: 4 layers, max_len 2048; batch 8 of 2048 tokens,
   ``adamw(3e-4)`` as ``examples/long_context.py`` trains it, the flash
   ring on ``{"seq": 2}``): a warm window of 10 steps, then a timed
   one; tokens/s (the slowest rank), step ms, peak memory per rank, each
   rank's busy share and K1/K2a/K2b device time a step, K1, K2a and K2b
   held to 4 x (index + 1) launches a rank and step (a causal ring skips
   the chunks after the rank's own); then the long-context rows, batch 1
   of 8192 tokens (the positional table grown to 8192 rows), remat off
   and on (K1 doubled under remat), beside one process at the whole
   sequence; over gloo ``run_steps`` keeps its host loop (asserted);
13. fp32 parity of the data-parallel strategy zoo: BERT at full width
   cut to 2 layers (seq 128, batch 4 a rank, flash, dropout 0), 3
   ``adamw(1e-4, eps=1e-4, weight_decay=0.01)`` steps (an eps that keeps
   the k bias's zero gradient's noise from whole steps) of every
   builder of the JAX golden list,
   ``GradAccumulation(AllReduce(), 2)`` and ``AllReduce`` with each of
   the seven compressors, on 2 ranks over gloo (and over NCCL, one rank
   a card, where there are cards): ``get_params`` has the logical
   shapes; compressor-free builders' losses and parameters within 1e-5
   relative (per tensor, of its largest value floored at 1e-3) of
   ``AllReduce``'s; a compressed run's loss at step k within ``eps x k``
   of it relative (``eps`` the wire's unit: fp16 2^-11, bf16 2^-8, int8
   2/127; PowerSGD 1: a rank-2 wire bounds nothing, so its first loss and
   finite losses are what is held); the stored bytes a
   rank of PS (optimizer state) and PartitionedPS (both) at ``1/n`` of
   AllReduce's, printed;
14. the zoo on the bench's BERT-base window (bf16, batch 16, seq 512, 76
   masked, ``adamw(1e-4, 0.01, mu bf16)``, flash, nothing cut): on one
   card on the graph route, ``AutoDist(rs)`` with no builder
   (``PSLoadBalancing``), ``PartitionedPS``, ``AllReduce(256)`` with
   ``bf16_ef``, ``int8_ring``, ``int8_ef`` and ``powersgd:2``,
   ``GradAccumulation(AllReduce(256), 2)`` and ``AllReduce(256)``, each a
   warm and a timed 30-step window (one capture, two replays, K1/K2a/K2b
   held to 12 x 30 launches, twice that under accumulation): examples/s,
   step ms, MFU, peak memory, stored bytes, capture seconds; then
   ``PS``, ``PartitionedPS`` and ``AllReduce`` at data 2 on 2 ranks over
   gloo (3 steps, host loop): per-rank peak memory and stored bytes;
   with 2 or more cards every row again over NCCL at data = the cards,
   each row's parameters within 0.1 of one card's update (L2 over the
   tree) on the same batches;
15. fp32 parity of ZeRO, compressors, accumulation and remat in the
   pipeline, sequence and expert lowerings, four jobs at once on card
   0: the pipelined LM at full width cut to 2 layers (1 at pipe 1; seq
   128, batch 8, 2 ``adam(1e-3, eps=0.1)``
   steps: an eps that keeps the k bias's zero gradient's noise from
   whole steps) on data 2 x pipe 2 and on data 2 x model 2 with
   ``vocab_parallel`` (4 ranks each): ZeRO-1, 2 and 3, the
   ``zero_min_bytes`` mix of ZeRO-3 and ``bf16_ef``, ZeRO-3 with the
   ``zero3_gather`` slot at bf16, ``bf16_ef``, the ``"int8"`` string
   (on the vocab mesh every slot of it but ``vocab_stats``, whose int8
   sum rounds a confident token's sum-exp to 0 at this fp32 width, in
   both packages), ``GradAccumulation(..., 2)`` and ``remat``, and on
   the vocab mesh the
   ``quant_ring`` program under remat (K3 held to the recomputed
   forward rings: 26 a step on 1 layer), each against the plain
   program of its mesh by phase 13's rule (1e-5 per tensor and loss for
   exact wires; a narrowed wire's loss at step k within its unit x k);
   the causal LM's ZeRO-3 with the flash ring on seq 2 (phase 11's
   model; K1/K2a/K2b held to the ring's calls) and the MoE LM's ZeRO-1
   with ``a2a_ring`` on expert 2 (phase 8's; K8 held to 8 a step), each
   against its plain program; every row's stored bytes a rank checked
   variable by variable against what ZeRO promises (optimizer state at
   ``1/n``, at stage 3 the parameter too, a degraded variable whole, as
   its record says) and printed;
16. the bf16 windows under ZeRO: the pipelined LM at ``bench.py
   quant``'s width, 4 layers, batch 16 of 512, on data 2 x pipe 2,
   plain, ZeRO-1, ZeRO-3, ``GradAccumulation 2`` and ``remat``, and
   phase 12's sequence window on seq 2 (cut to 2 layers) plain and
   under ZeRO-3 (K1/K2a/K2b held to the ring's calls), each a warm and
   a timed window of 2 steps: step
   ms, peak memory and stored bytes a rank beside the plain row's, the
   ZeRO-3 rows' parameters at most 0.51 and ZeRO-1's optimizer state at
   most 0.51 of the plain row's (asserted); 4 and 2 ranks over gloo on
   card 0, and over NCCL on the graph route, one rank a card, where the
   machine has the cards (captures asserted);
17. one ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

Phases 2, 4, 6 (at T = 1), 8 (the dense model) and 11 (one process)
run one process on the card, so their windows replay CUDA graphs too.
Phases 6 to 16 run 2 or 4 processes (``torch.multiprocessing`` spawn;
phase 15 four such jobs at once) on card 0, joined in a gloo group: NCCL refuses two ranks on one device, so each transfer is
staged through host memory while the kernels, the model and the
optimizer stay on the card.  Their numbers are labelled so, and say
nothing about multi-GPU speed.  Where the machine has at least 2 cards,
phases 7 (pipe 1, and a pipe axis of 2 in fp32), 9 and 10 run again
over NCCL, one rank per card (phase 10 on the graph route: one capture,
then a replay a window, asserted) and 12 (seq 2, on the graph route,
asserted), and with 4 cards phase 7's pipe 2 x model 2 and phase 12 at
seq 4 too; each prints apart.  Every rank joins and leaves the job through
``autodist_tpu_torch.testing`` (a barrier before the groups go).

Any failed check raises, in any rank, and the script exits non-zero;
without a CUDA device it exits 2 and prints no result.  ``--phases 7,9``
(a comma-separated list) runs only those phases and prints no kernels
line.  Each phase prints its seconds.  Imports torch, numpy and
``autodist_tpu_torch`` only.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

import autodist_tpu_torch as port
from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel import a2a_ring as ar
from autodist_tpu_torch.kernel import build
from autodist_tpu_torch.kernel import collective_matmul as cm
from autodist_tpu_torch.kernel import flash_decode as fd
from autodist_tpu_torch.kernel import flash_prefill as fp
from autodist_tpu_torch.kernel import quant_ring as qr
from autodist_tpu_torch.kernel.common import flatten_with_names
from autodist_tpu_torch.models import bert, moe_transformer
from autodist_tpu_torch.models.pipeline_lm import (make_pipeline_lm_trainable,
                                                   sequential_logits)
from autodist_tpu_torch.parallel import ring_attention as ra
from autodist_tpu_torch.parallel.sequence import global_positions
from autodist_tpu_torch.strategy.parallel_builders import Pipeline
from autodist_tpu_torch.resource import H100
from autodist_tpu_torch.serving import FINISH_REASONS, kv_cache

fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

# Published H100 SXM rates (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = H100.hbm_gbps * 1e9
PEAK_FLOPS = {torch.bfloat16: H100.peak_bf16_tflops * 1e12,
              torch.float32: H100.peak_fp32_tflops * 1e12}

VOCAB, HIDDEN, LAYERS, HEADS, MLP, MAX_LEN = 32768, 1024, 8, 16, 4096, 1024
HEAD_DIM = HIDDEN // HEADS
BLOCK_LEN, NUM_BLOCKS, CHUNK = 16, 512, 64
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # atol = rtol

KERNELS = {
    "flash_decode": dict(
        wrapper=fd.flash_decode_attention,
        source="autodist_tpu_torch/kernel/csrc/flash_decode.cu",
        replaces="autodist_tpu/kernel/pallas/flash_decode.py:45"),
    "flash_decode_paged": dict(
        wrapper=fd.flash_decode_attention_paged,
        source="autodist_tpu_torch/kernel/csrc/flash_decode.cu",
        replaces="autodist_tpu/kernel/pallas/flash_decode.py:148"),
    "flash_prefill_paged": dict(
        wrapper=fp.flash_prefill_attention_paged,
        source="autodist_tpu_torch/kernel/csrc/flash_prefill.cu",
        replaces="autodist_tpu/kernel/pallas/flash_prefill.py:48"),
    "flash_attention_fwd": dict(
        wrapper=fa.flash_attention_fwd,
        source="autodist_tpu_torch/kernel/csrc/flash_attention.cu",
        replaces="autodist_tpu/ops/flash_attention.py:145"),
    "flash_attention_bwd_dq": dict(
        wrapper=fa.flash_attention_bwd_dq,
        source="autodist_tpu_torch/kernel/csrc/flash_attention.cu",
        replaces="autodist_tpu/ops/flash_attention.py:246"),
    "flash_attention_bwd_dkv": dict(
        wrapper=fa.flash_attention_bwd_dkv,
        source="autodist_tpu_torch/kernel/csrc/flash_attention.cu",
        replaces="autodist_tpu/ops/flash_attention.py:288"),
}
KERNELS.update({
    "quant_ring_hop": dict(
        wrapper=qr.fused_hop,
        source="autodist_tpu_torch/kernel/csrc/quant_ring.cu",
        replaces="autodist_tpu/kernel/pallas/quant_ring.py:48"),
    "collective_matmul_hop": dict(
        wrapper=cm.fused_matmul_add,
        source="autodist_tpu_torch/kernel/csrc/collective_matmul.cu",
        replaces="autodist_tpu/kernel/pallas/collective_matmul.py:35"),
    "a2a_ring_hop": dict(
        wrapper=ar.fused_hop,
        source="autodist_tpu_torch/kernel/csrc/a2a_ring.cu",
        replaces="autodist_tpu/kernel/pallas/a2a_ring.py:52"),
})
SERVING_KERNELS = ("flash_decode", "flash_decode_paged", "flash_prefill_paged")
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")
# K2a and K2b share one library call, SDPA's backward (the K2 pair).
PAIR = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
TP_KERNELS = ("quant_ring_hop", "collective_matmul_hop")
MOE_KERNELS = ("a2a_ring_hop",)

# BERT-base (bench.py _bench on an accelerator).
BERT_BATCH, BERT_SEQ, BERT_MASKED, BERT_STEPS = 16, 512, 76, 30

# The tensor-parallel window (bench.py quant on an accelerator): at one
# pipe device, and on bench.py quant's 4-device mesh, pipe 2 x model 2
# (V = 2 chunks a pipe rank).
TP, TP_LAYERS, TP_SEQ, TP_BATCH, TP_MICRO, TP_STEPS = 2, 4, 512, 16, 2, 5
PIPE = 2
TP_MESH = {"data": 1, "pipe": 1, "model": TP}
QUANT_MESH = {"data": 1, "pipe": PIPE, "model": TP}
# K3's chunk on that path: one [8, 512, 1024] boundary over 2 ranks.
RING_CHUNK = TP_BATCH // TP_MICRO * TP_SEQ * HIDDEN // TP
# K4's shapes there: [M, K] @ [K, C] per hop, M = 8 x 512 rows, C = the
# 1024 features over 2 ranks; K = 512 (out projection), 2048 (mlp wo).
MATMUL_SHAPES = ((4096, 512, 512), (4096, 2048, 512))
# K3's chunk at the vocab-parallel prologue's lookup sum (pipe rank 0):
# the [16, 512, 1024] fp32 lookup of the whole batch over 2 ranks.
PROLOGUE_CHUNK = TP_BATCH * TP_SEQ * HIDDEN // TP
# Phase 6's programs.
TP_PROGRAMS = {
    "fp32": {},
    "int8": dict(collective_precision={"tp_psum": "int8"}),
    "quant_ring": dict(collective_precision={"tp_psum": "int8"},
                       kernel=("quant_ring",)),
    "matmul": dict(comm_overlap="matmul"),
    "collective_matmul": dict(comm_overlap="matmul",
                              kernel=("collective_matmul",)),
    "fp32 vocab": dict(vocab_parallel=True),
}
# Phase 7's: bench.py quant's programs, each with vocab_parallel and
# the bare "int8" string as bench.py:342 passes them (every slot
# narrowed: tp_psum, vocab_stats and the grad slot's int8_ef over the
# data axis of 1), and at pipe 2 x model 2 the fp32 program with the
# full-vocab head beside them.
VOCAB_PARALLEL = dict(vocab_parallel=True)
WINDOW_PROGRAMS = {
    "fp32": VOCAB_PARALLEL,
    "int8": dict(VOCAB_PARALLEL, collective_precision="int8"),
    "quant_ring": dict(VOCAB_PARALLEL, collective_precision="int8",
                       kernel=("quant_ring",)),
    "collective_matmul": dict(VOCAB_PARALLEL,
                              **TP_PROGRAMS["collective_matmul"]),
    "fp32 full head": {},
}
# The MoE window (bench.py moe on an accelerator) on an expert axis of 2.
EXPERT, MOE_LAYERS, MOE_SEQ, MOE_ROWS, MOE_STEPS = 2, 2, 512, 2, 20
MOE_EXPERTS, MOE_HIDDEN = 8, 4096
# K8's chunk there: each rank's [8, 512, 1024] dispatch and [4, 1024,
# 1024] combine payloads split in two, [4, 512, 1024]; 512 is the
# capacity ceil(2 x 1024 tokens x 2.0 / 8 experts).
MOE_CAPACITY = 2 * MOE_ROWS * MOE_SEQ * 2 // MOE_EXPERTS
A2A_CHUNK = MOE_EXPERTS // EXPERT * MOE_CAPACITY * HIDDEN
MOE_PROGRAMS = {
    "fp32": {},
    "int8": dict(collective_precision={"moe_a2a": "int8"}),
    "a2a_ring": dict(collective_precision={"moe_a2a": "int8"},
                     kernel=("a2a_ring",)),
}
# Per step of phase 9: a warm-up hop and one hop per peer for every
# dispatch and combine, forward and backward, in every layer.
MOE_WANT = {"a2a_ring": {"a2a_ring_hop": EXPERT * 2 * 2 * MOE_LAYERS}}
# The sequence-parallel window: bench.py:442-446's model (4 layers,
# max_len 2048) trained as examples/long_context.py trains it
# (adamw(3e-4), batch 8), the flash ring causal on a seq axis of 2: a
# ring chunk is [8, 1024, 16, 64].  The long-context rows: batch 1 of
# 8192 tokens, the positional table grown to 8192 rows.
SEQ, SEQ_LAYERS, SEQ_LEN, SEQ_BATCH, SEQ_STEPS = 2, 4, 2048, 8, 10
LONG_LEN, LONG_STEPS = 8192, 3
RING_CHUNK_SHAPE = (SEQ_BATCH, SEQ_LEN // SEQ, HEADS)
RINGS = {"flash": ra.make_ring_flash_attention_fn,
         "einsum": ra.make_ring_attention_fn}


def seq_want(index, layers, remat=False):
    """K1, K2a and K2b per step on seq rank ``index`` under the causal
    flash ring: one chunk call a ring step that is not skipped (the
    diagonal and the ``index`` chunks before it) a layer; remat runs
    each forward again in the backward."""
    calls = layers * (index + 1)
    return {"flash_attention_fwd": calls * (2 if remat else 1),
            "flash_attention_bwd_dq": calls,
            "flash_attention_bwd_dkv": calls}


def tp_want(program, layers, first):
    """Per step of phase 7 in a rank that holds ``layers`` layers: K3
    opens and hops once per ring at T = 2, four rings per layer and
    microbatch (two forward sums, two backward), and on pipe rank 0
    (``first``) one more ring for the vocab-parallel prologue's lookup
    sum (its backward is the identity); K4 runs T times per row-parallel
    boundary, two per layer and microbatch, forward only.  A bubble tick
    runs no stage, so the pipe schedule adds none."""
    return {"quant_ring": {"quant_ring_hop": 2 * 4 * layers * TP_MICRO
                           + (TP if first else 0)},
            "collective_matmul": {
                "collective_matmul_hop": TP * 2 * layers * TP_MICRO},
            }.get(program, {})


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def reset_launches():
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    fp.flash_prefill_attention_paged.cuda_core_launches = 0


def launches():
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def cfg_of(dtype, layers=LAYERS):
    return port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=layers,
        num_heads=HEADS, mlp_dim=MLP, max_len=MAX_LEN, dtype=dtype,
        dropout_rate=0.0, attention_dropout_rate=0.0)


# --------------------------------------------------------------------- #
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------- #
def edge_values(n, hi, rng):
    """0, 15, 16, 17, 1023 (block and tile edges), then random."""
    vals = [0, 15, 16, 17, MAX_LEN - 1]
    return np.array(vals + list(rng.randint(0, hi, n - len(vals))), np.int32)


def tail_filled_table(spans, rng):
    """Block table rows as ``reserve_slot`` lays them out: each slot's
    blocks drawn from one shuffled pool, the row tail-filled with its
    last block."""
    mb = MAX_LEN // BLOCK_LEN
    free = list(rng.permutation(NUM_BLOCKS))
    table = np.zeros((len(spans), mb), np.int32)
    for i, span in enumerate(spans):
        n = kv_cache.blocks_for(max(int(span), 1), BLOCK_LEN)
        blocks = [free.pop() for _ in range(n)]
        table[i, :] = blocks[-1]
        table[i, :n] = blocks
    return table


def decode_cases(dtype, randn, dense_lengths, paged_lengths, pools, rng,
                 heads=HEADS):
    """(name, args, kwargs, bytes, flops) of K5 over dense lanes and K6
    over ``pools`` (a table drawn from ``rng``) at the given lengths, of
    ``heads`` heads (a tensor-parallel rank's: 16 / T);
    the bytes count each visible key's K and V row, q, out, the lengths
    and the used table entries once."""
    dev = "cuda"
    esize = torch.empty((), dtype=dtype).element_size()
    cases = []
    for name, lengths in (("flash_decode", dense_lengths),
                          ("flash_decode_paged", paged_lengths)):
        B = len(lengths)
        n_vis = np.minimum(lengths.astype(np.int64) + 1, MAX_LEN)
        q = randn(B, 1, heads, HEAD_DIM)
        nbytes = (2 * n_vis.sum() * heads * HEAD_DIM * esize
                  + 2 * B * heads * HEAD_DIM * esize + B * 4)
        if name == "flash_decode":
            args = (q, randn(B, heads, MAX_LEN, HEAD_DIM),
                    randn(B, heads, MAX_LEN, HEAD_DIM),
                    torch.as_tensor(lengths, device=dev))
            kw = {}
        else:
            table = tail_filled_table(n_vis, rng)
            args = (q, *pools, torch.as_tensor(lengths, device=dev),
                    torch.as_tensor(table, device=dev))
            kw = {"block_len": BLOCK_LEN}
            nbytes += 4 * sum(kv_cache.blocks_for(n, BLOCK_LEN)
                              for n in n_vis)
        cases.append((name, args, kw, nbytes,
                      4 * HEAD_DIM * heads * n_vis.sum()))
    return cases


def serve_mix_lengths(rng):
    """K5's and K6's lengths at the serve mix's occupancy: phase 3's
    requests (1-64 prompt tokens, 128 new) reach lengths 1-192; the
    dense engine's 8 slots are all busy, the paged engine's 32 hold the
    16 requests and 16 idle slots at length 0."""
    return (rng.randint(1, 193, 8).astype(np.int32),
            np.concatenate([rng.randint(1, 193, 16),
                            np.zeros(16, np.int64)]).astype(np.int32))


def kernel_cases(dtype, gen, rng):
    """(name, args, kwargs, bytes, flops) at the serving shapes."""
    dev = "cuda"
    esize = torch.empty((), dtype=dtype).element_size()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    mb = MAX_LEN // BLOCK_LEN
    # K5: 8 slots over dense lanes; K6: 32 slots over the 512-block pool.
    k_pool = randn(NUM_BLOCKS, HEADS, BLOCK_LEN, HEAD_DIM)
    v_pool = randn(NUM_BLOCKS, HEADS, BLOCK_LEN, HEAD_DIM)
    cases = decode_cases(dtype, randn, edge_values(8, MAX_LEN, rng),
                         edge_values(32, 200, rng), (k_pool, v_pool), rng)
    # K7: a 64-row chunk for each of 32 slots over the same pool.
    cases.append(prefill_case(dtype, randn, edge_values(32, 150, rng),
                              (k_pool, v_pool), rng))
    return cases


def prefill_case(dtype, randn, starts, pools, rng, heads=HEADS):
    """(name, args, kwargs, bytes, flops) of K7: a ``CHUNK``-row chunk a
    slot starting at ``starts`` over ``pools`` (a table drawn from
    ``rng``); the bytes count each visible key's K and V row, q, out,
    the starts and the used table entries once, the flops each row's
    visible keys."""
    dev = "cuda"
    esize = torch.empty((), dtype=dtype).element_size()
    B, extent = len(starts), MAX_LEN // BLOCK_LEN * BLOCK_LEN
    n_keys = np.minimum(starts.astype(np.int64) + CHUNK, extent)
    table = tail_filled_table(n_keys, rng)
    args = (randn(B, CHUNK, heads, HEAD_DIM), *pools,
            torch.as_tensor(starts, device=dev),
            torch.as_tensor(table, device=dev))
    rows = np.minimum(starts[:, None].astype(np.int64) + np.arange(CHUNK) + 1,
                      extent)
    kv_bytes = 2 * n_keys.sum() * heads * HEAD_DIM * esize
    tab_bytes = 4 * sum(kv_cache.blocks_for(n, BLOCK_LEN) for n in n_keys)
    return ("flash_prefill_paged", args, {"block_len": BLOCK_LEN},
            kv_bytes + 2 * B * CHUNK * heads * HEAD_DIM * esize + B * 4
            + tab_bytes, 4 * HEAD_DIM * heads * rows.sum())


def library_call(name, args, block_len=None):
    """One PyTorch call computing the same function (timed as a
    yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    if name == "flash_decode":
        q, k, v, lengths = args
        rows = lengths[:, None]                        # one query row
    else:
        q, k_pool, v_pool, idx, table = args
        k = kv_cache.gather_blocks(k_pool, table)
        v = kv_cache.gather_blocks(v_pool, table)
        C = q.shape[1]
        rows = idx[:, None] + torch.arange(C, device=q.device)
    pos = torch.arange(k.shape[2], device=q.device)
    mask = (pos[None, None, :] <= rows[:, :, None])[:, None]  # [B,1,C,T]
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                         attn_mask=mask)
    return out.transpose(1, 2)


def time_ms(fn, reps=30):
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events
    around the call only.  The 50 MB L2 is flushed before each call by
    reading 64 MB (the serving loop reaches each layer's cache cold; a
    read leaves no dirty lines to write back inside the timed call).  A
    spin kernel holds the card while the host enqueues every call, so
    the events time the device and not the host's launch overhead."""
    flush = torch.ones(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(300_000_000)            # ~0.2 s at H100 clocks
    for e0, e1 in events:
        flush.sum()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / reps


def tflop_rate(flops, ms):
    """Achieved TFLOP/s of ``flops`` in ``ms``."""
    return flops / ms / 1e9


def timings(rec, flops):
    """The kernel's, the plain version's and the library call's times,
    each with its achieved TFLOP/s, and the bound."""
    def at(ms):
        return f"{ms:.4f} ms ({tflop_rate(flops, ms):.1f} TFLOP/s)"

    lib = "none" if rec["library_ms"] is None else at(rec["library_ms"])
    return (f"kernel {at(rec['ms'])}, plain {at(rec['plain_ms'])}, library "
            f"{lib}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def check_and_time(name, args, kw, nbytes, flops, dtype):
    """One K5-K7 case: the kernel against its plain version within the
    dtype's tolerance, then the kernel, the plain version and the
    library call timed; returns the record."""
    tol = TOLERANCE[dtype]
    wrapper = KERNELS[name]["wrapper"]
    plain = {"flash_decode": fd.flash_decode_attention_plain,
             "flash_decode_paged": fd.flash_decode_attention_paged_plain,
             "flash_prefill_paged":
                 fp.flash_prefill_attention_paged_plain}[name]
    got = wrapper(*args, dtype=dtype, **kw)
    ref = plain(*args, dtype=dtype, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    max_err = float(err.max())
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    check(bool((err <= tol + tol * ref.float().abs()).all()),
          f"{name} {dtype}: max |kernel - plain| = {max_err} "
          f"exceeds atol = rtol = {tol}")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {
        "max_abs_err": max_err,
        "ms": time_ms(lambda: wrapper(*args, dtype=dtype, **kw)),
        "plain_ms": time_ms(lambda: plain(*args, dtype=dtype, **kw)),
        "library_ms": time_ms(lambda: library_call(name, args)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def phase_kernels(record):
    """Kernel vs plain at both dtypes, into the per-kernel record; K5-K7
    also at the serve mix's occupancy (K7: 32 chunks at 0) and with one
    slot of ``MAX_LEN`` keys (K7: its last chunk) (``record[(name,
    dtype, "serve_mix" or "one_slot")]``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    mix_gen = torch.Generator(device="cuda").manual_seed(2)
    mix_rng = np.random.RandomState(2)
    pre_gen = torch.Generator(device="cuda").manual_seed(3)
    pre_rng = np.random.RandomState(3)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOLERANCE[dtype]
        for name, args, kw, nbytes, flops in kernel_cases(dtype, gen, rng):
            rec = check_and_time(name, args, kw, nbytes, flops, dtype)
            print(f"phase 1 {name} {str(dtype)[6:]}: max_abs_err "
                  f"{rec['max_abs_err']:.3e} (tol {tol}), "
                  f"{timings(rec, flops)}", flush=True)
            record[(name, dtype)] = rec

        def randn(*shape):
            return torch.randn(shape, generator=mix_gen,
                               device="cuda").to(dtype)

        def pre_randn(*shape):
            return torch.randn(shape, generator=pre_gen,
                               device="cuda").to(dtype)

        one_slot = np.array([MAX_LEN - 1], np.int32)
        # The serve mix's occupancy at 16 heads and, for phase 10's
        # tensor-parallel ranks, at 16 / T.
        for label, lengths, starts, heads in (
                ("serve_mix", serve_mix_lengths(mix_rng),
                 np.zeros(32, np.int32), HEADS),
                ("one_slot", (one_slot, one_slot),
                 np.array([MAX_LEN - CHUNK], np.int32), HEADS),
                ("tp2", serve_mix_lengths(mix_rng), np.zeros(32, np.int32),
                 HEADS // TP)):
            pools = (randn(NUM_BLOCKS, heads, BLOCK_LEN, HEAD_DIM),
                     randn(NUM_BLOCKS, heads, BLOCK_LEN, HEAD_DIM))
            cases = decode_cases(dtype, randn, *lengths, pools, mix_rng,
                                 heads)
            cases.append(prefill_case(dtype, pre_randn, starts, pools,
                                      pre_rng, heads))
            for name, args, kw, nbytes, flops in cases:
                rec = check_and_time(name, args, kw, nbytes, flops, dtype)
                what = "starts" if name == "flash_prefill_paged" \
                    else "lengths"
                print(f"phase 1 {name} {str(dtype)[6:]} {label} [B="
                      f"{args[0].shape[0]}, heads {heads}, {what} "
                      f"{args[3].min().item()}-"
                      f"{args[3].max().item()}]: max_abs_err "
                      f"{rec['max_abs_err']:.3e} (tol {tol}), "
                      f"{timings(rec, flops)}", flush=True)
                record[(name, dtype, label)] = rec
        del pools


def attention_bytes_flops(name, B, L, H, D, esize, causal):
    """Bytes each input is read and each output written once, and the
    flops of the products (halved when causal), for K1, K2a and K2b."""
    qkv = 3 * B * L * H * D * esize
    rows = B * L * H * 4                       # one fp32 statistic per row
    tri = 0.5 if causal else 1.0
    if name == "flash_attention_fwd":           # q, k, v -> out, lse
        return qkv + B * L * H * D * esize + rows, 4 * B * H * L * L * D * tri
    grads = B * L * H * D * 4 * (1 if name == "flash_attention_bwd_dq" else 2)
    return (qkv + B * L * H * D * esize + 2 * rows + grads,
            (6 if name == "flash_attention_bwd_dq" else 8)
            * B * H * L * L * D * tri)


def attention_library(name, q, k, v, g, causal):
    """``scaled_dot_product_attention`` computing the same function:
    its forward for K1; for K2a and K2b, which no PyTorch call computes
    apart, its autograd backward (dq, dk and dv together, with its own
    delta pass; the forward is run once outside the timed call), the
    yardstick of the pair."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    if name == "flash_attention_fwd":
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                       retain_graph=True)


def backward_pair(q, k, v, g, causal, dtype, library_ms):
    """The K2 pair: the port's whole backward as training runs it,
    ``torch.autograd.grad`` through ``flash_attention`` (delta, K2a, K2b
    and the casts of dq, dk, dv to the input dtype; the forward runs
    once outside the timed call), against SDPA's autograd backward, with
    the bound of K2a's and K2b's bytes and flops together; and the part
    outside the two kernels (delta and the casts), timed and counted
    alone."""
    B, L, H, D = q.shape
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*x, causal=causal)
    whole = lambda: torch.autograd.grad(out, x, g,      # noqa: E731
                                        retain_graph=True)
    o = out.detach()
    grads = [torch.empty(q.shape, dtype=torch.float32, device=q.device)
             for _ in range(3)]

    def outside():
        return ((g.float() * o.float()).sum(-1),
                *(t.to(dtype) for t in grads))

    esize = torch.empty((), dtype=dtype).element_size()
    nbytes, flops = map(sum, zip(*(
        attention_bytes_flops(name, B, L, H, D, esize, causal)
        for name in PAIR)))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    rec = {"ms": time_ms(whole), "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "outside_ms": time_ms(outside)}
    for key, fn in (("launches", whole), ("outside_launches", outside)):
        prof = device_profile(fn)
        rec[key] = "not measured" if prof is None else round(prof[2])
    return rec, flops


def in_launches(n):
    """``in N launches``, or that the profiler saw none."""
    return (f"in {n} launches" if isinstance(n, int)
            else "(launches not measured: the profiler saw no device time)")


# The kernels whose registers, spills and static shared memory phase 1
# prints, by source: record name -> a fragment of the mangled entry name
# (bf16 instances, and K5's, K6's and K7's fp32 ones; K3's and K8's
# vector one-tile paths, the main path's).
PTXAS_KERNELS = {
    "flash_attention.cu": {
        "flash_attention_fwd": "16fwd_wgmma_kernelE",
        "flash_attention_bwd_dq": "15dq_wgmma_kernelE",
        "flash_attention_bwd_dkv": "16dkv_wgmma_kernelE"},
    "flash_decode.cu": {
        "flash_decode": "13decode_kernelI13__nv_bfloat16Li64ELb0E",
        "flash_decode_paged": "13decode_kernelI13__nv_bfloat16Li64ELb1E",
        "flash_decode fp32": "13decode_kernelIfLi64ELb0E",
        "flash_decode_paged fp32": "13decode_kernelIfLi64ELb1E"},
    "flash_prefill.cu": {
        "flash_prefill_paged": "20prefill_wgmma_kernelE",
        "flash_prefill_paged fp32": "14prefill_kernelIfLi64EE"},
    "quant_ring.cu": {"quant_ring_hop": "quant_ring_hop_kernelILb1ELb0E"},
    "a2a_ring.cu": {"a2a_ring_hop": "a2a_ring_hop_kernelILb1ELb0E"},
}


def ptxas_registers():
    """Registers, spill-store bytes and static shared-memory bytes a
    thread block of each kernel of ``PTXAS_KERNELS`` takes, from ``nvcc
    -Xptxas -v`` on its source with the build's flags (the sources
    compiled in parallel)."""
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {src: subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(build.CSRC_DIR / src), "-o", os.path.join(tmp, src + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in PTXAS_KERNELS}
        outs = {src: p.communicate()[0] for src, p in procs.items()}
    for src, kernels in PTXAS_KERNELS.items():
        check(procs[src].returncode == 0, f"nvcc -Xptxas -v {src}: "
              f"{outs[src][-2000:]}")
        name = None
        for line in outs[src].splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            if entry:
                name = next((n for n, frag in kernels.items()
                             if frag in entry.group(1)), None)
            elif name and spill:
                found.setdefault(name, {})["spill_bytes"] = int(spill.group(1))
            elif name and regs:
                found[name]["registers"] = int(regs.group(1))
                found[name]["static_smem_bytes"] = (
                    int(smem.group(1)) if smem else 0)
        print(f"phase 1 ptxas {src}: " + "; ".join(
            f"{n} {found[n]['registers']} registers, "
            f"{found[n]['spill_bytes']} bytes spill stores, "
            f"{found[n]['static_smem_bytes']} bytes static shared memory"
            for n in kernels if n in found), flush=True)
    want = {n for kernels in PTXAS_KERNELS.values() for n in kernels}
    check(set(found) == want,
          f"ptxas reported {sorted(found)}, expected {sorted(want)}")
    return found


def attention_shape(gen, dtype, B, L, H, causal, timed):
    """K1, K2a and K2b against their plain versions at ``[B, L, H, 64]``
    (q, k and v slices of one [B, L, 3, H, D] projection, as the model
    hands them over) within the dtype's tolerance; with ``timed`` each
    kernel, its plain version and the library call timed, and the K2
    pair.  Prints a line a kernel; returns ``({name: rec}, pair rec)``
    (empty and ``None`` untimed)."""
    D, tol = HEAD_DIM, TOLERANCE[dtype]
    esize = torch.empty((), dtype=dtype).element_size()
    qkv = torch.randn((B, L, 3, H, D), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    g = torch.randn((B, L, H, D), generator=gen, device="cuda").to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = (g.float() * out.float()).sum(-1)
    kw = dict(causal=causal, scale=1.0 / math.sqrt(D))
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, **kw),
            lambda: fa.flash_attention_fwd_plain(q, k, v, **kw)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw),
            lambda: fa.flash_attention_bwd_dq_plain(
                q, k, v, g, lse, delta, **kw)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw),
            lambda: fa.flash_attention_bwd_dkv_plain(
                q, k, v, g, lse, delta, **kw)),
    }
    if timed:
        pair_library = time_ms(attention_library(
            "flash_attention_bwd_dq", q, k, v, g, causal))
    recs, pair = {}, None
    for name, (kernel, plain) in calls.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        max_err = 0.0
        for a, b in zip(got, ref):
            err = (a.float() - b.float()).abs()
            max_err = max(max_err, float(err.max()))
            check(bool(torch.isfinite(a).all()), f"{name}: non-finite")
            check(bool((err <= tol + tol * b.float().abs()).all()),
                  f"{name} {dtype} [{B},{L},{H},{D}] causal={causal}: max "
                  f"|kernel - plain| = {max_err} exceeds atol = rtol = "
                  f"{tol}")
        del got, ref
        line = (f"phase 1 {name} {str(dtype)[6:]} [{B},{L},{H},{D}] "
                f"causal={causal}: max_abs_err {max_err:.3e} (tol {tol})")
        if timed:
            nbytes, flops = attention_bytes_flops(name, B, L, H, D, esize,
                                                  causal)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS[dtype]
            recs[name] = {
                "max_abs_err": max_err,
                "ms": time_ms(kernel),
                "plain_ms": time_ms(plain),
                "library_ms": (pair_library if name in PAIR else time_ms(
                    attention_library(name, q, k, v, g, causal))),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            line += ", " + timings(recs[name], flops)
        print(line, flush=True)
    if timed:
        pair, flops = backward_pair(q, k, v, g, causal, dtype, pair_library)
        print(f"phase 1 K2 pair {str(dtype)[6:]} [{B},{L},{H},{D}] "
              f"causal={causal}: the port's backward {pair['ms']:.4f} ms "
              f"{in_launches(pair['launches'])} "
              f"({tflop_rate(flops, pair['ms']):.1f} TFLOP/s), of which "
              f"delta and casts {pair['outside_ms']:.4f} ms "
              f"{in_launches(pair['outside_launches'])}; SDPA backward "
              f"{pair['library_ms']:.4f} ms; bound {pair['bound_ms']:.4f} "
              f"ms ({pair['bound_by']})", flush=True)
    del qkv, q, k, v, g, out, lse, delta, calls
    torch.cuda.empty_cache()
    return recs, pair


def phase_attention_kernels(record):
    """K1, K2a and K2b against their plain versions at BERT-base shapes
    and at ragged lengths, causal and not, both dtypes, timed at
    BERT-base (the non-causal record is the training path's); and in
    bf16 at the ring chunk of phase 12, ``[8, 1024, 16, 64]``, full and
    causal (the ring's two kinds of step), timed (``record[(name, bf16,
    "ring_chunk" or "ring_chunk_causal")]``)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        for B, L in ((BERT_BATCH, BERT_SEQ), (4, 100), (4, 17)):
            for causal in (False, True):
                recs, pair = attention_shape(gen, dtype, B, L, 12, causal,
                                             timed=L == BERT_SEQ)
                if recs and not causal:
                    for name, rec in recs.items():
                        record[(name, dtype)] = rec
                    record[("K2 pair", dtype)] = pair
    for causal in (False, True):
        recs, pair = attention_shape(gen, torch.bfloat16, *RING_CHUNK_SHAPE,
                                     causal, timed=True)
        label = "ring_chunk_causal" if causal else "ring_chunk"
        for name, rec in recs.items():
            record[(name, torch.bfloat16, label)] = rec
        record[("K2 pair", torch.bfloat16, label)] = pair


def misaligned(q_in, x):
    """``q_in`` 4 bytes into a wire (a view ``wire[4:]``) and ``x`` at
    an odd element offset: neither on a 16-byte boundary."""
    wire = torch.empty(q_in.numel() + 4, dtype=torch.int8, device="cuda")
    wire[4:] = q_in
    odd = torch.empty(x.numel() + 1, device="cuda")
    odd[1:] = x
    return wire[4:], odd[1:]


def hop_cases(n, gen):
    """K3's and K8's cases at ``n`` elements, ``{name: (q_in, scale_in,
    x, vector)}``: ``x`` is K3's ``local`` or K8's ``nxt``, ``vector``
    whether every array is 16-byte aligned (the kernel's vector path)."""
    x = torch.randn(n, generator=gen, device="cuda") * 3
    q_in = torch.randint(-127, 128, (n,), generator=gen, device="cuda",
                         dtype=torch.int8)
    s_in = torch.full((1,), 0.0173, device="cuda")
    zero_q, zero_s = torch.zeros_like(q_in), torch.zeros(1, device="cuda")
    nan = x.clone()
    nan[n // 2] = float("nan")
    odd_q, odd_x = misaligned(q_in, x)
    # Halves up to max |x| = 127: scale 1, every quotient a tie.
    ties = torch.randint(-254, 255, (n,), generator=gen, device="cuda") / 2
    ties[0] = 127.0
    return {"open": (zero_q, zero_s, x, True),
            "ties": (zero_q, zero_s, ties, True),
            "hop": (q_in, s_in, x, True),
            "zero": (zero_q, zero_s, torch.zeros_like(x), True),
            "last": (q_in, s_in, torch.zeros_like(x), True),
            "nan": (q_in, s_in, nan, True),
            "misaligned": (odd_q, s_in, odd_x, False)}


def device_ops(fn, tries=3):
    """The names of the device operations (kernels, copies, memsets)
    one ``fn()`` ran, from ``torch.profiler``.  The profiler now and then
    records no device event at all in a session (a run of the whole
    script on an H100 saw it once among dozens of sessions, for a hop
    whose launch was counted and whose bytes were checked): such an
    empty record is taken again, up to ``tries`` sessions; the first
    record with any device event is returned as it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
        if ops:
            break
    return ops


def check_hop(name, n, case, wrapper, plain, args, vector, out=None):
    """One K3 or K8 case: the kernel's outputs equal the plain
    version's byte for byte, the launch is counted (and in
    ``unaligned`` unless ``vector``), and the call is one device kernel,
    no memset or copy.  Returns the printed line."""
    before = (wrapper.launches, wrapper.unaligned)
    kw = {} if out is None else {"out": out}
    got, want = wrapper(*args, **kw), plain(*args)
    torch.cuda.synchronize()
    check((wrapper.launches, wrapper.unaligned)
          == (before[0] + 1, before[1] + (not vector)),
          f"{name} n={n} {case}: launches and unaligned went from {before} "
          f"to {(wrapper.launches, wrapper.unaligned)}")
    diff = [int((a.reshape(-1).view(torch.uint8)
                 != b.reshape(-1).view(torch.uint8)).sum())
            for a, b in zip(got, want)]
    check(diff == [0] * len(want), f"{name} n={n} {case}: bytes differ in "
          f"the outputs: {diff}; scale {float(got[-1])} vs "
          f"{float(want[-1])}")
    ops = device_ops(lambda: wrapper(*args, **kw))
    check(len(ops) == 1 and "ring_hop_kernel" in ops[0],
          f"{name} n={n} {case}: device operations {ops}, expected one "
          f"hop kernel")
    kernel = re.search(r"\w+_hop_kernel<[^>]*>", ops[0]).group(0)
    return (f"phase 1 {name} n={n} {case}: bit-exact, "
            f"{'vector' if vector else 'element-wise'} path, "
            f"{len(ops)} device operation a call ({kernel})")


def time_hop(n, wrapper, plain, args, nbytes):
    """K3's or K8's record at the main path's chunk: the kernel, the
    plain version and a plain copy of the same bytes (``nbytes`` / 2
    read and written: the event-timing floor beside the bound) timed by
    ``time_ms``.  A multiply, a divide, a round and a compare an
    element."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * n / PEAK_FLOPS[torch.float32]
    rec = {"max_abs_err": 0.0,
           "ms": time_ms(lambda: wrapper(*args)),
           "plain_ms": time_ms(lambda: plain(*args)),
           "library_ms": None,
           "copy_ms": time_ms(lambda: dst.copy_(src)),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return rec, (timings(rec, 4 * n) + f", copy of the same bytes "
                 f"{rec['copy_ms']:.4f} ms")


# Beyond what a grid holds in registers (2^21 elements on an H100): tiles.
HOP_LARGE = 2 ** 23 + 5


def phase_tp_kernels(record):
    """K3 bit for bit against its plain version (levels and scale), one
    device kernel a call, at the main path's chunk, at edge sizes and
    past what the grid holds in registers, aligned and not; K4 within
    tolerance; both timed at the shapes of phase 7."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for C in (RING_CHUNK, PROLOGUE_CHUNK, 1, 1000, 2 ** 20 + 3, HOP_LARGE):
        for case, (*args, vector) in hop_cases(C, gen).items():
            line = check_hop("quant_ring_hop", C, case, qr.fused_hop,
                             qr.fused_hop_plain, args, vector)
            if C == RING_CHUNK and case == "hop":
                # Read q_in and local, write q_out: 6 bytes an element.
                rec, times = time_hop(C, qr.fused_hop, qr.fused_hop_plain,
                                      args, 6 * C + 8)
                record[("quant_ring_hop", torch.float32)] = rec
                line += ", " + times
            print(line, flush=True)
    # bf16 at the main path's shapes, at a ragged one, at one whose rows
    # are not 16-byte aligned (the wrapper stages it for TMA) and at an
    # odd C (the one-element epilogue; k's slice is staged).
    cases = [(torch.bfloat16, M, K, C) for M, K, C in MATMUL_SHAPES] + [
        (torch.bfloat16, 100, 72, 40), (torch.bfloat16, 100, 70, 38),
        (torch.bfloat16, 100, 72, 37), (torch.float32, 100, 72, 40)] + [
        (torch.float32, M, K, C) for M, K, C in MATMUL_SHAPES]
    for dtype, M, K, C in cases:
        tol = TOLERANCE[dtype]
        esize = torch.empty((), dtype=dtype).element_size()
        carry = torch.randn(M, C, generator=gen, device="cuda").to(dtype)
        x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        # k: this rank's chunk of the row-parallel kernel, a column slice
        # of the [K, 2C] shard as the ring reads it.
        wide = (torch.randn(K, TP * C, generator=gen, device="cuda")
                / math.sqrt(K)).to(dtype)
        k = wide[:, C:]
        staged = cm.fused_matmul_add.staged
        got = cm.fused_matmul_add(carry, x, k)
        ref = cm.fused_matmul_add_plain(carry, x, k)
        torch.cuda.synchronize()
        staged = cm.fused_matmul_add.staged - staged
        check(staged == (dtype == torch.bfloat16
                         and (K % 8 != 0 or C % 8 != 0)),
              f"collective_matmul_hop {dtype} {M}x{K}x{C}: staged {staged}")
        err = (got.float() - ref.float()).abs()
        max_err = float(err.max())
        check(bool(torch.isfinite(got).all()), "collective_matmul: non-finite")
        check(bool((err <= tol + tol * ref.float().abs()).all()),
              f"collective_matmul_hop {dtype} {M}x{K}x{C}: max |kernel - "
              f"plain| = {max_err} exceeds atol = rtol = {tol}")
        line = (f"phase 1 collective_matmul_hop {str(dtype)[6:]} "
                f"[{M},{K}]@[{K},{C}]: max_abs_err {max_err:.3e} (tol {tol})")
        if M == 4096:
            t_bytes = (M * K + K * C + 2 * M * C) * esize / HBM_BYTES_PER_S
            t_ops = 2 * M * K * C / PEAK_FLOPS[dtype]
            rec = {"max_abs_err": max_err,
                   "ms": time_ms(lambda: cm.fused_matmul_add(carry, x, k)),
                   "plain_ms": time_ms(
                       lambda: cm.fused_matmul_add_plain(carry, x, k)),
                   "library_ms": time_ms(lambda: torch.addmm(carry, x, k)),
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            # mlp wo (K = 2048) is the kernel's record, the out
            # projection (K = 512) rides beside it.
            record[("collective_matmul_hop", dtype) if K == 2048 else
                   ("collective_matmul_hop", dtype, K)] = rec
            line += ", " + timings(rec, 2 * M * K * C) + " (library: addmm)"
        else:
            line += f", staged {staged}"
        print(line, flush=True)
    del carry, x, wide, k, got, ref
    torch.cuda.empty_cache()


def phase_a2a_kernels(record):
    """K8 bit for bit against its plain version (arrived, levels and
    scale), one device kernel a call, at the MoE window's chunks, at
    edge sizes and past what the grid holds in registers, aligned and
    not, and writing arrived into a row of the ring's output; timed at
    the MoE window's chunk."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for L in (A2A_CHUNK, A2A_CHUNK // 2, 1, 1000, 2 ** 20 + 3, HOP_LARGE):
        cases = hop_cases(L, gen)
        rows = torch.empty(2, L, device="cuda")
        for case, (*args, vector) in list(cases.items()) + [
                ("out", (*cases["hop"][:3], L % 4 == 0))]:
            line = check_hop("a2a_ring_hop", L, case, ar.fused_hop,
                             ar.fused_hop_plain, args, vector,
                             out=rows[1] if case == "out" else None)
            if L == A2A_CHUNK and case == "hop":
                # Read q_in and nxt, write arrived and q_out: 10 bytes an
                # element.
                rec, times = time_hop(L, ar.fused_hop, ar.fused_hop_plain,
                                      args, 10 * L + 8)
                record[("a2a_ring_hop", torch.float32)] = rec
                line += ", " + times
            print(line, flush=True)
    del cases, rows
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 2: fp32 parity against the greedy full recompute
# --------------------------------------------------------------------- #
def count_calls(engine):
    """Wrap the engine so the phase can count decode windows and
    prefill chunks (the attention calls it made)."""
    calls = {"windows": 0, "chunks": 0}
    decode_window, prefill = engine.decode_window, engine.prefill

    def counted_window(active):
        calls["windows"] += 1
        return decode_window(active)

    def counted_prefill(*a, **kw):
        out = prefill(*a, **kw)
        calls["chunks"] += engine.last_prefill_chunks
        return out

    engine.decode_window, engine.prefill = counted_window, counted_prefill
    return calls


ENGINES = {
    "dense": dict(num_slots=8, decode_steps=16, prefill_len=64),
    "paged": dict(num_slots=32, decode_steps=16, prefill_len=64,
                  kv_layout="paged", kv_block_len=BLOCK_LEN,
                  kv_num_blocks=NUM_BLOCKS, prefill_chunk=CHUNK),
}


def phase_parity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_of(torch.float32)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    rng = np.random.RandomState(1)
    ties = 0
    for layout, max_prompt in (("dense", 64), ("paged", 200)):
        engine = port.serve(cfg, params=params, device="cuda",
                            **ENGINES[layout])
        batcher = port.ContinuousBatcher(engine)
        prompts = [rng.randint(0, VOCAB, int(n)).tolist()
                   for n in [1, max_prompt] + list(
                       rng.randint(1, max_prompt + 1, 2))]
        rids = [batcher.submit(p, max_new_tokens=40) for p in prompts]
        done = batcher.run()
        compared = 0
        for p, rid in zip(prompts, rids):
            gen = done[rid].tokens
            seq = torch.as_tensor([p + gen[:-1]], device="cuda")
            logits = sequential_logits(cfg, params, seq)[0, len(p) - 1:]
            want = logits.argmax(-1).tolist()
            for i, tok in enumerate(gen):
                if tok == want[i]:
                    compared += 1
                    continue
                top2 = logits[i].topk(2).values
                gap = float(top2[0] - top2[1])
                check(gap < 1e-4, f"{layout} {rid}: token {i} is {tok}, "
                      f"the recompute gives {want[i]} (top-2 gap {gap})")
                ties += 1
                break
        check(engine.block_accounting()[1] == 0, "blocks leaked")
        print(f"phase 2 {layout}: {compared} tokens equal to the greedy "
              f"recompute over {len(prompts)} requests", flush=True)
    print(f"phase 2 ties: {ties}", flush=True)
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 3: bf16 serving of the bench mix
# --------------------------------------------------------------------- #
PROFILED = "chip_smoke.profiled_window"


def profile_summary(intervals, span, k=1, watch=None):
    """Per-step summary of a profiled window of ``k`` steps.

    ``intervals``: ``(name, start_us, end_us)`` of every device launch
    (kernels, copies, memsets); ``span``: the window's ``(start_us,
    end_us)``.  Each interval is clipped to the window, and one that lies
    wholly outside it is left out.  Returns, every field divided by
    ``k``: the window's wall ms, its device-busy ms (the union of the
    intervals, so launches that overlap on several streams count once),
    the launches, the device-to-host copies, and the six names with the
    most device time as ``"name xN t ms"``, followed by every other name
    that contains ``watch``; ``None`` when no device time lies in the
    window."""
    start, end = span
    clipped = [(name, max(lo, start), min(hi, end))
               for name, lo, hi in intervals if lo <= end and hi >= start]
    busy_us, covered = 0.0, start
    for _, lo, hi in sorted(clipped, key=lambda c: c[1:]):
        lo = max(lo, covered)
        if hi > lo:
            busy_us += hi - lo
            covered = hi
    if not busy_us:
        return None
    by_name = {}
    for name, lo, hi in clipped:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + hi - lo)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = ranked[:6] + [kv for kv in ranked[6:] if watch and watch in kv[0]]
    d2h = sum(n for name, (n, _) in by_name.items()
              if name.startswith("Memcpy DtoH"))
    return ((end - start) / 1e3 / k, busy_us / 1e3 / k, len(clipped) / k,
            d2h / k, "; ".join(f"{name[:60]} x{n / k:g} {us / 1e3 / k:.3f} ms"
                               for name, (n, us) in top))


def device_profile(run, k=1, watch=None):
    """Run ``run()`` (``k`` steps) once under ``torch.profiler`` and
    return ``profile_summary`` of its device launches, per step.
    Annotation ranges (``nccl:*``, which repeat their kernels' time) are
    left out, so busy time never exceeds the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(PROFILED):
            run()
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == PROFILED and e.device_type == DeviceType.CPU)
    return profile_summary(
        [(e.name, e.time_range.start, e.time_range.end) for e in events
         if e.device_type == DeviceType.CUDA and not e.is_user_annotation],
        (span.start, span.end), k, watch)


def profile_window(engine, n_active, label):
    """Where one decode window's time goes: its host wall time (timed
    without the profiler), then ``device_profile`` of a second window.
    Prints "not measured" where the profiler records no device time.
    Returns the flash decode kernel's entries of the window's top."""
    active = np.zeros(engine.num_slots, bool)
    active[:n_active] = True
    engine.decode_window(active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode_window(active)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(lambda: engine.decode_window(active),
                          watch="decode_kernel")
    if prof is None:
        print(f"phase 3 {label} window profile: device time not measured")
        return "not measured"
    prof_ms, busy_ms, n_launch, d2h, top = prof
    print(f"phase 3 {label} window profile: wall {wall_ms:.2f} ms; profiled "
          f"window {prof_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({busy_ms / prof_ms:.1%}), {n_launch:.0f} kernel launches, "
          f"{d2h:.0f} device-to-host copies; top: {top}", flush=True)
    decode = "; ".join(t for t in top.split("; ") if "decode_kernel" in t)
    print(f"phase 3 {label} window profile: flash decode kernel "
          f"{decode or 'not launched'} a window", flush=True)
    return decode or "not launched"


def profile_chunk(engine, rng, decode):
    """Where one prefill chunk's time goes on the paged engine: 16
    prompts of 1-64 tokens (one chunk) admitted at once, ``engine.
    prefill`` under ``device_profile``; K7's device time a chunk printed
    beside the flash decode kernel's a window (``decode``)."""
    B = engine.num_slots
    prompts = np.zeros((B, engine.max_prompt_tokens), np.int64)
    p_lens = np.zeros(B, np.int32)
    admit = np.zeros(B, bool)
    for i in range(16):
        p_lens[i] = rng.randint(1, CHUNK + 1)
        prompts[i, :p_lens[i]] = rng.randint(0, VOCAB, p_lens[i])
        engine.reserve_slot(i, int(p_lens[i]), 128)
        admit[i] = True
    prof = device_profile(lambda: engine.prefill(prompts, p_lens, admit),
                          watch="prefill")
    check(engine.last_prefill_chunks == 1, "the profiled prefill took "
          f"{engine.last_prefill_chunks} chunks")
    engine.release_all_slots()
    if prof is None:
        print("phase 3 chunk profile: device time not measured")
        return
    prof_ms, busy_ms, n_launch, _, top = prof
    k7 = "; ".join(t for t in top.split("; ") if "prefill" in t)
    print(f"phase 3 chunk profile: profiled chunk {prof_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms ({busy_ms / prof_ms:.1%}), "
          f"{n_launch:.0f} kernel launches; K7 {k7 or 'not launched'} a "
          f"chunk, beside the flash decode kernel {decode} a window",
          flush=True)


def serve_mix(engine, rng):
    """Two warm-up requests in turn, then the serve mix (16 requests of
    1-64 prompt tokens and 128 new ones) timed through
    ``ContinuousBatcher``, with the launch counters set to 0 just before
    it.  The first warm-up's window captures the decode graph, and the
    capture empties the allocator's cache; the second warms the prefill
    after it.  Returns (seconds, completions, the engine's calls, the
    launches, the graph replays)."""
    batcher = port.ContinuousBatcher(engine)
    for warm in (rng, np.random.RandomState(1)):        # warm-up
        batcher.submit(warm.randint(0, VOCAB, 4).tolist(), max_new_tokens=16)
        batcher.run()
    calls = count_calls(engine)
    replays = engine.replays
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [batcher.submit(
        rng.randint(0, VOCAB, int(rng.randint(1, 65))).tolist(),
        max_new_tokens=128) for _ in range(16)]
    done = batcher.run()
    wall = time.perf_counter() - t0
    return (wall, [done[r] for r in rids], calls, launches(),
            engine.replays - replays)


def phase_serve():
    """The bench mix on the dense and the paged engine, each with its
    decode windows replaying one CUDA graph (the main path) and again
    with the window body launched from the host; the two routes' streams
    must be equal token for token."""
    cfg = cfg_of(torch.bfloat16)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    counts = {}
    for layout in ("dense", "paged"):
        streams = {}
        for route in ("graph", "body"):
            label = f"{layout} {route}"
            engine = port.serve(cfg, params=params, device="cuda",
                                decode_graph=route == "graph",
                                **ENGINES[layout])
            wall, comps, calls, got, replays = serve_mix(
                engine, np.random.RandomState(0))
            check(all(c.finish_reason in FINISH_REASONS for c in comps),
                  "invalid finish reason")
            check(all(0 <= t < VOCAB for c in comps for t in c.tokens),
                  "token outside the vocabulary")
            free, used, total = engine.block_accounting()
            check(used == 0 and free == total, f"blocks leaked: {free, used}")
            if route == "graph":
                check(engine.captures == 1 and replays == calls["windows"]
                      and replays > 0,
                      f"{label}: {engine.captures} captures and {replays} "
                      f"replays for {calls['windows']} windows (one capture "
                      f"in the warm-up, then a replay a window)")
            else:
                check(engine.captures == engine.replays == 0,
                      f"{label}: the uncaptured route captured")
            per_window = LAYERS * engine.decode_steps
            want = dict.fromkeys(KERNELS, 0)
            if layout == "dense":
                want["flash_decode"] = per_window * calls["windows"]
            else:
                want["flash_decode_paged"] = per_window * calls["windows"]
                want["flash_prefill_paged"] = LAYERS * calls["chunks"]
            check(got == want, f"{label}: launches {got}, attention calls "
                  f"{want}")
            cuda_core = fp.flash_prefill_attention_paged.cuda_core_launches
            check(cuda_core == 0, f"{label}: K7's CUDA-core instance ran "
                  f"{cuda_core} times on the bf16 serve path")
            check(all(n > 0 for n in want.values() if n != 0)
                  and sum(n > 0 for n in got.values()) == (
                      1 if layout == "dense" else 2),
                  f"{label}: a kernel of the path was never launched: {got}")
            tokens = sum(len(c.tokens) for c in comps)
            itl = [ms for c in comps for ms in c.inter_token_ms]
            ttft = sorted(c.ttft_s * 1e3 for c in comps)
            print(f"phase 3 {label} bf16: {tokens} tokens in {wall:.3f} s = "
                  f"{tokens / wall:.1f} tokens/s, TTFT p50 "
                  f"{ttft[len(ttft) // 2]:.2f} ms, inter-token p50 "
                  f"{np.percentile(itl, 50):.3f} ms p99 "
                  f"{np.percentile(itl, 99):.3f} ms, windows "
                  f"{calls['windows']}, chunks {calls['chunks']}, graph "
                  f"replays {replays}, captures {engine.captures} "
                  f"({engine.capture_seconds:.2f} s), launches {got}",
                  flush=True)
            streams[route] = [c.tokens for c in comps]
            if route == "graph":
                counts.update({k: v for k, v in got.items() if v})
            decode = profile_window(engine, min(16, engine.num_slots), label)
            if layout == "paged" and route == "graph":
                counts["flash_prefill_paged cuda_core"] = cuda_core
                profile_chunk(engine, np.random.RandomState(1), decode)
            engine.close()
            del engine
            torch.cuda.empty_cache()
        check(streams["graph"] == streams["body"],
              f"{layout}: the replayed windows' streams differ from the "
              f"uncaptured body's")
        print(f"phase 3 {layout}: the graph route's {len(streams['graph'])} "
              f"streams equal the uncaptured body's token for token",
              flush=True)
    return counts


# --------------------------------------------------------------------- #
# phases 4 and 5: BERT masked-LM training through AutoDist + AllReduce
# --------------------------------------------------------------------- #
def bert_window(cfg, steps, seed0=0):
    """``steps`` distinct synthetic MLM batches without ``input_mask``
    (unpadded, as the bench feeds them), stacked ``[steps, ...]``."""
    batches = []
    for i in range(steps):
        b = bert.synthetic_mlm_batch(seed0 + i, BERT_BATCH, BERT_SEQ,
                                     BERT_MASKED, cfg.vocab_size)
        b.pop("input_mask")
        batches.append(b)
    return port.stack_steps(batches)


def bert_runner(cfg, optimizer):
    trainable = bert.make_mlm_trainable(
        cfg, optimizer, torch.Generator(device="cuda").manual_seed(0),
        with_input_mask=False)
    return port.AutoDist({}, port.AllReduce(chunk_size=256)).build(trainable)


def phase_training_parity():
    """fp32: flash and einsum attention train a 2-layer full-width BERT
    alike over 3 AdamW steps (same generator seed, so the same weights;
    same batches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses = {}
    for name, fn in (("flash", fa.make_attention_fn(False)),
                     ("einsum", None)):
        cfg = port.TransformerConfig(
            num_layers=2, dtype=torch.float32, dropout_rate=0.0,
            attention_dropout_rate=0.0, attention_fn=fn)
        runner = bert_runner(cfg, port.optim.adamw(1e-4, weight_decay=0.01))
        losses[name] = runner.run_steps(bert_window(cfg, 3, seed0=100))[
            "loss"].tolist()
        runner.close()
        torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(losses["flash"], losses["einsum"])):
        check(math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b),
              f"step {i}: flash loss {a} vs einsum loss {b} differ by more "
              f"than 1e-4 relative")
    print(f"phase 4 fp32 2-layer BERT, 3 AdamW steps: flash losses "
          f"{losses['flash']}, einsum losses {losses['einsum']}", flush=True)


def window_steps(window, k=None):
    """The first ``k`` steps (all by default) of a placed window, one
    batch each; each keeps the placed type, so the runner does not split
    it again."""
    k = len(next(iter(window.values()))) if k is None else k
    return [type(window)({key: t[i] for key, t in window.items()})
            for i in range(k)]


def profile_steps(runner, window, k=3, watch=None, loop=False):
    """``device_profile`` of ``k`` warm steps, per step, every kernel
    whose name holds ``watch`` listed: one ``run_steps`` window, or with
    ``loop`` ``k`` ``step`` calls.  ``window`` is placed
    (``runner.place_steps``)."""
    if loop:
        steps = window_steps(window, k)
        run = lambda: [runner.step(b) for b in steps]      # noqa: E731
    else:
        part = type(window)({key: t[:k] for key, t in window.items()})
        run = lambda: runner.run_steps(part)               # noqa: E731
    run()
    torch.cuda.synchronize()
    return device_profile(run, k, watch)


def timed_window(runner, window, loop=False):
    """A warm window, then a timed one (host clock around a window that
    ends in a host read of the last loss): one ``run_steps`` call, or
    with ``loop`` a ``step`` call a step.  The warm window is the whole
    window where ``run_steps`` captures a graph, one step on a host
    loop (a loop has nothing to capture; its one-time costs fall in its
    first step).  The launch counters are set to 0 just before the timed
    window, the peak memory before the warm one (so a graph's capture
    counts).  Returns (seconds, metrics)."""
    fence = lambda m: float(m["loss"].reshape(-1)[-1])  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    if loop:
        steps = window_steps(window)
        fence(runner.step(steps[0]))

        def run():
            out = [runner.step(b) for b in steps]
            return {key: torch.stack([m[key] for m in out])
                    for key in out[0]}
    else:
        run = lambda: runner.run_steps(window)          # noqa: E731
        fence(run() if runner.lowered.capturable else runner.run_steps(
            type(window)({k: v[:1] for k, v in window.items()})))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metrics = run()
    fence(metrics)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, metrics


def train_route(cfg, opt, label, route):
    """One BERT-base training window on one route: ``"graph"`` (each
    ``run_steps`` call one CUDA-graph replay: the main path) or
    ``"loop"`` (a ``step`` call a step).  Checks the losses, the route's
    captures and replays and the attention kernels' launches; prints
    examples/s, step ms, MFU, peak memory, capture seconds and the
    profiler's busy share.  Returns the launches."""
    flops = bert.mlm_model_flops_per_example(cfg, BERT_SEQ, BERT_MASKED)
    chip = port.ResourceSpec({}).chip
    runner = bert_runner(cfg, opt)
    check(runner.lowered.capturable, f"{label}: one card's lowering is "
          f"not capturable")
    window = runner.place_steps(bert_window(cfg, BERT_STEPS))
    dt, metrics = timed_window(runner, window, loop=route == "loop")
    got = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = metrics["loss"].float()
    check(bool(torch.isfinite(losses).all()),
          f"{label} {route}: non-finite loss: {losses}")
    want = dict.fromkeys(KERNELS, 0)
    if cfg.attention_fn is not None:
        want.update(dict.fromkeys(TRAINING_KERNELS,
                                  cfg.num_layers * BERT_STEPS))
    check(got == want, f"{label} {route}: training launches {got}, "
          f"expected {want}")
    graphs = (1, 2) if route == "graph" else (0, 0)
    check((runner.captures, runner.replays) == graphs,
          f"{label} {route}: {runner.captures} captures and "
          f"{runner.replays} replays, expected {graphs}")
    rate = BERT_STEPS * BERT_BATCH / dt
    print(f"phase 5 {label} bf16 {route}: {BERT_STEPS} steps in {dt:.3f} s "
          f"= {rate:.2f} examples/s, step {dt / BERT_STEPS * 1e3:.2f} ms, "
          f"MFU {rate * flops / (chip.peak_bf16_tflops * 1e12):.4f}, peak "
          f"memory {peak_gb:.2f} GB of {chip.hbm_gb:g}, graph captures "
          f"{runner.captures} ({runner.capture_seconds:.2f} s), replays "
          f"{runner.replays}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"launches {got}", flush=True)
    prof = profile_steps(runner, window, loop=route == "loop")
    if prof is None:
        print(f"phase 5 {label} {route} step profile: device time not "
              f"measured", flush=True)
    else:
        prof_ms, busy, n_launch, _, top = prof
        print(f"phase 5 {label} {route} step profile: device busy "
              f"{busy:.2f} ms of the profiled step's {prof_ms:.2f} ms "
              f"({busy / prof_ms:.1%}), {n_launch:.0f} kernel launches per "
              f"step; top per step: {top}", flush=True)
    runner.close()
    del runner, window
    torch.cuda.empty_cache()
    return got


def phase_train():
    """bf16 BERT-base: the bench's training window through the flash
    kernels, then through the einsum attention, each replayed as one
    CUDA graph a window and as a loop of ``step`` calls."""
    opt = port.optim.adamw(1e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    counts = {}
    for label, fn in (("flash", fa.make_attention_fn(False)),
                      ("einsum", None)):
        cfg = bert.bert_base(dropout_rate=0.0, attention_dropout_rate=0.0,
                             attention_fn=fn)
        for route in ("graph", "loop"):
            got = train_route(cfg, opt, label, route)
            if label == "flash" and route == "graph":
                counts = {name: got[name] for name in TRAINING_KERNELS}
    return counts


# --------------------------------------------------------------------- #
# phases 6 and 7: tensor- and pipeline-parallel training of the pipelined LM
# --------------------------------------------------------------------- #
def tp_runner(job, program, mesh):
    """AutoDist + Pipeline on the pipelined LM at full width, depth
    ``job["layers"]``, over ``mesh`` (``virtual_stages`` the layers a
    pipe rank holds, ``tensor_parallel`` the model axis) with a program
    of phase 6 (``TP_PROGRAMS``) or of phase 7's window
    (``WINDOW_PROGRAMS``); weights from seed 0 on the card (every rank
    draws the same tree and keeps its chunks' shard)."""
    programs = WINDOW_PROGRAMS if job["kind"] == "window" else TP_PROGRAMS
    cfg = port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=job["layers"],
        num_heads=HEADS, mlp_dim=MLP, max_len=job["seq"], dtype=job["dtype"],
        dropout_rate=0.0, attention_dropout_rate=0.0)
    trainable = make_pipeline_lm_trainable(
        cfg, port.optim.adam(1e-3), torch.Generator(device="cuda").manual_seed(0))
    builder = Pipeline(num_microbatches=TP_MICRO,
                       virtual_stages=job["layers"] // mesh.get("pipe", 1),
                       tensor_parallel=mesh.get("model", 1),
                       **programs[program])
    return port.AutoDist({"mesh": mesh}, builder).build(trainable)


def mesh_label(mesh):
    return " x ".join(f"{ax} {n}" for ax, n in mesh.items() if n > 1)


def tp_window(job, steps, seed0=0):
    """``steps`` next-token batches ``{"x", "y"}`` from a numpy seed,
    stacked ``[steps, B, L]``."""
    batches = []
    for i in range(steps):
        r = np.random.RandomState(seed0 + i)
        batches.append({k: r.randint(0, VOCAB, (job["batch"], job["seq"]))
                        .astype(np.int32) for k in ("x", "y")})
    return port.stack_steps(batches)


def tp_parity(job):
    """Phase 6 in one rank: 3 steps of each program; the losses."""
    out = {}
    for program in job["programs"]:
        runner = tp_runner(job, program, job["mesh"])
        out[program] = runner.run_steps(tp_window(job, 3, seed0=100))[
            "loss"].tolist()
        runner.close()
        torch.cuda.empty_cache()
    return out


def check_route(runner, job, program):
    """Over gloo the step stages every exchange through host memory, so
    ``run_steps`` keeps the host loop (no capture); over NCCL it replays
    one CUDA graph."""
    staged = job["backend"] == "gloo"
    check(runner.lowered.host_staged == staged
          and runner.lowered.capturable == (not staged),
          f"{program} over {job['backend']}: host_staged "
          f"{runner.lowered.host_staged}, capturable "
          f"{runner.lowered.capturable}")
    if staged:
        check(runner.captures == runner.replays == 0,
              f"{program}: the gloo loop captured {runner.captures} graphs")
    return "loop" if staged else f"graph ({runner.captures} captures)"


def tp_window_programs(job):
    """Phase 7 in one rank: per program a warm window, a timed one with
    the launch counters, then a profiled one."""
    out = {}
    layers = job["layers"] // job["mesh"].get("pipe", 1)
    for program in job["programs"]:
        torch.cuda.reset_peak_memory_stats()
        runner = tp_runner(job, program, job["mesh"])
        pipe = runner.lowered.mesh.axis("pipe").index
        window = runner.place_steps(tp_window(job, TP_STEPS))
        cm.fused_matmul_add.staged = qr.fused_hop.unaligned = 0
        dt, metrics = timed_window(runner, window)
        route = check_route(runner, job, program)
        got = {name: launches()[name] for name in TP_KERNELS}
        check(cm.fused_matmul_add.staged == 0,
              f"{program}: K4 staged {cm.fused_matmul_add.staged} operands "
              f"(the main path's are TMA-ready)")
        check(qr.fused_hop.unaligned == 0,
              f"{program}: {qr.fused_hop.unaligned} K3 hops took the "
              f"element-wise path (the main path's arrays are aligned)")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = metrics["loss"].float()
        check(bool(torch.isfinite(losses).all()),
              f"{program}: non-finite loss {losses}")
        want = dict.fromkeys(TP_KERNELS, 0)
        want.update({k: n * TP_STEPS
                     for k, n in tp_want(program, layers, pipe == 0).items()})
        check(got == want, f"{program} on {job['mesh']}: launches {got}, "
                           f"expected {want}")
        prof = profile_steps(runner, window, k=2, watch="ring_hop_kernel")
        out[program] = {"seconds": dt, "launches": got, "peak_gb": peak_gb,
                        "pipe": pipe,
                        "loss": [float(losses[0]), float(losses[-1])],
                        "profile": prof, "route": route}
        runner.close()
        del runner, window
        torch.cuda.empty_cache()
    return out


def rank_worker(rank, world, backend, store, job, out_dir):
    """One rank of a spawned phase; writes its result as JSON.  It joins
    and leaves the job through ``autodist_tpu_torch.testing``; a failure
    raises here and ``mp.spawn`` stops the other ranks."""
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    testing.init_rank(rank, world, store, backend)
    job = dict(job, backend=backend)
    run = {"parity": tp_parity, "window": tp_window_programs,
           "moe_parity": moe_parity, "moe_window": moe_window_programs,
           "serve": tp_serve, "seq_parity": seq_parity,
           "seq_window": seq_window_rows, "zoo_parity": zoo_parity,
           "zoo_window": zoo_window_rows,
           "zero_pipe_parity": zero_pipe_parity,
           "zero_seq_parity": zero_seq_parity,
           "zero_moe_parity": zero_moe_parity,
           "zero_window": zero_window_rows}
    result = run[job["kind"]](job)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    testing.end_rank()


def spawn_ranks(job, world, backend="gloo"):
    """Run ``job`` in ``world`` spawned ranks; every rank's result.  A
    failure in any rank stops the others and raises here."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_worker, args=(world, backend,
                                    os.path.join(tmp, "store"), job, tmp),
                 nprocs=world, join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                results.append(json.load(f))
    return results


def spawn_together(jobs):
    """Run several ``(job, world)`` jobs at once over gloo, each in its
    own spawned ranks and process group; every job's ranks' results, in
    order.  A failure in any rank stops every rank of every job and
    raises here."""
    with tempfile.TemporaryDirectory() as tmp:
        started = []
        try:
            for i, (job, world) in enumerate(jobs):
                out = os.path.join(tmp, str(i))
                os.mkdir(out)
                started.append((mp.spawn(
                    rank_worker, args=(world, "gloo",
                                       os.path.join(out, "store"), job, out),
                    nprocs=world, join=False), out, world))
            for ctx, _, _ in started:
                while not ctx.join():
                    pass
        except BaseException:
            for ctx, _, _ in started:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.terminate()
            raise
        results = []
        for _, out, world in started:
            ranks = []
            for rank in range(world):
                with open(os.path.join(out, f"rank{rank}.json")) as f:
                    ranks.append(json.load(f))
            results.append(ranks)
    return results


def phase_tp_parity():
    """fp32 on the card against one process at T = 1: T = 2 ranks at
    pipe 1, a pipe axis of 2 at V = 1 (2 ranks), and pipe 2 x model 2 at
    V = 1 (4 ranks); each kernel program against its composed sibling,
    at pipe 1 and at pipe 2 x model 2."""
    job = {"kind": "parity", "layers": 2, "seq": 128, "batch": 8,
           "dtype": torch.float32}
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = tp_runner(job, "fp32", {"data": 1, "pipe": 1})
    one = runner.run_steps(tp_window(job, 3, seed0=100))["loss"].tolist()
    runner.close()
    torch.cuda.empty_cache()
    runs = ((TP_MESH, list(TP_PROGRAMS)), ({"data": 1, "pipe": PIPE},
                                           ["fp32"]),
            (QUANT_MESH, list(TP_PROGRAMS)))
    # The three jobs at once: parity, not time, is read here.
    results = spawn_together([
        (dict(job, mesh=mesh, programs=programs),
         math.prod(mesh.values())) for mesh, programs in runs])
    for (mesh, programs), ranks in zip(runs, results):
        world = math.prod(mesh.values())
        got = ranks[0]
        for rank in ranks[1:]:
            for program, losses in rank.items():
                check(all(abs(a - b) <= 1e-5 * abs(b)
                          for a, b in zip(losses, got[program])),
                      f"{program} on {mesh}: the ranks' losses differ: "
                      f"{ranks}")
        pairs = [("fp32", one, 1e-4, "T = 1")]
        if "fp32 vocab" in got:
            pairs.append(("fp32 vocab", got["fp32"], 1e-5,
                          "the full-vocab head"))
        if "matmul" in got:
            pairs += [("collective_matmul", got["matmul"], 1e-5,
                       "composed matmul"),
                      ("quant_ring", got["int8"], 2e-2, "composed int8")]
        for program, ref, tol, what in pairs:
            for i, (a, b) in enumerate(zip(got[program], ref)):
                check(math.isfinite(a) and abs(a - b) <= tol * abs(b),
                      f"{mesh_label(mesh)}, step {i}: {program} loss {a} vs "
                      f"{what} {b} differ by more than {tol} relative")
        print(f"phase 6 fp32 2-layer pipelined LM, seq 128, batch 8, 3 Adam "
              f"steps, {mesh_label(mesh)} ({world} ranks on one card over "
              f"gloo, V = {job['layers'] // mesh['pipe']}): T = 1 losses "
              f"{one}; " + "; ".join(f"{p} {got[p]}" for p in programs),
              flush=True)


def phase_tp_window():
    """bf16 window of the four programs at pipe 1 (T ranks) and on
    bench.py quant's mesh, pipe 2 x model 2 (4 ranks), on card 0 over
    gloo; over NCCL, one rank per card, where the machine has the
    cards (2: pipe 1 and a pipe axis of 2, fp32; 4: pipe 2 x model 2)."""
    job = {"kind": "window", "layers": TP_LAYERS, "seq": TP_SEQ,
           "batch": TP_BATCH, "dtype": torch.bfloat16}
    programs = ["fp32", "int8", "quant_ring", "collective_matmul"]
    quant = programs + ["fp32 full head"]
    pipe_only = {"data": 1, "pipe": PIPE}
    runs = [("gloo", TP_MESH, programs), ("gloo", QUANT_MESH, quant)]
    cards = torch.cuda.device_count()
    if cards >= TP:
        runs += [("nccl", TP_MESH, programs), ("nccl", pipe_only, ["fp32"])]
    if cards >= math.prod(QUANT_MESH.values()):
        runs.append(("nccl", QUANT_MESH, quant))
    counts = {}
    tokens = TP_STEPS * TP_BATCH * TP_SEQ
    for backend, mesh, progs in runs:
        world = math.prod(mesh.values())
        label = (f"{mesh_label(mesh)}, {world} ranks on one card, gloo, "
                 f"transfers through host" if backend == "gloo" else
                 f"{mesh_label(mesh)}, {world} ranks on {world} cards, NCCL")
        ranks = spawn_ranks(dict(job, mesh=mesh, programs=progs), world,
                            backend)
        for program in progs:
            r0 = ranks[0][program]
            dt = max(r[program]["seconds"] for r in ranks)
            peaks = ", ".join(f"{r[program]['peak_gb']:.2f}" for r in ranks)
            per_step = {k: n / TP_STEPS for k, n in r0["launches"].items()}
            line = (f"phase 7 {program} bf16 [{label}, run_steps route "
                    f"{r0['route']}]: {TP_STEPS} steps in "
                    f"{dt:.3f} s = {tokens / dt:.1f} tokens/s, step "
                    f"{dt / TP_STEPS * 1e3:.2f} ms, peak memory per rank "
                    f"{peaks} GB, loss {r0['loss'][0]:.4f} -> "
                    f"{r0['loss'][1]:.4f}, launches per step and rank "
                    f"{per_step}")
            if r0["profile"] is None:
                line += "; rank 0 profile: device time not measured"
            else:
                prof_ms, busy, n_launch, _, top = r0["profile"]
                line += (f"; rank 0 profile: device busy {busy:.2f} ms of "
                         f"the profiled step's {prof_ms:.2f} ms "
                         f"({busy / prof_ms:.1%}), {n_launch:.0f} kernel "
                         f"launches per step; top per step: {top}")
            print(line, flush=True)
            if backend == "gloo":
                for name, n in r0["launches"].items():
                    counts[name] = counts.get(name, 0) + n
        if "fp32 full head" in progs:
            # The last pipe coordinate holds the loss head: the
            # vocab-parallel head's peak must sit below the full one's.
            last = [(r["fp32"]["peak_gb"], r["fp32 full head"]["peak_gb"])
                    for r in ranks if r["fp32"]["pipe"] == PIPE - 1]
            check(all(vp < full for vp, full in last),
                  f"{label}: the last pipe coordinate's peak memory with "
                  f"vocab_parallel {last} is not below the full head's")
            print(f"phase 7 [{label}] last pipe coordinate's peak memory "
                  f"per rank: vocab_parallel " + ", ".join(
                      f"{vp:.2f}" for vp, _ in last) + " GB, full-vocab "
                  "head " + ", ".join(f"{full:.2f}" for _, full in last)
                  + " GB", flush=True)
    return counts


# --------------------------------------------------------------------- #
# phase 10: tensor-parallel serving
# --------------------------------------------------------------------- #
# The serve mix's model at tensor parallel 2, the vocabulary sharded:
# each rank holds 8 of the 16 heads and half of the table; cut to 4 of
# its 8 layers to keep the whole script near its earlier run time.
SERVE_TP_LAYERS = 4
SERVE_TP_NEW = 24          # new tokens a request of the fp32 parity


def tp_serve_prompts(rng):
    """Phase 10's fp32 requests by layout: one of the longest prompt the
    engine takes, one random, one of a single token."""
    return {layout: [rng.randint(0, VOCAB, int(n)).tolist()
                     for n in (longest, rng.randint(1, longest + 1), 1)]
            for layout, longest in (("dense", 64), ("paged", 200))}


def tp_serve_mix(engine, layers, backend, label):
    """The bf16 serve mix on one tensor-parallel engine (``serve_mix``:
    the launch counters set to 0 just before it), held to the attention
    calls it made and to its route: gloo ranks keep the host loop, NCCL
    ranks capture one decode graph and replay it a window."""
    wall, comps, calls, got, replays = serve_mix(engine,
                                                 np.random.RandomState(0))
    check(all(c.finish_reason in FINISH_REASONS for c in comps),
          "invalid finish reason")
    check(all(0 <= t < VOCAB for c in comps for t in c.tokens),
          "token outside the vocabulary")
    free, used, total = engine.block_accounting()
    check(used == 0 and free == total, f"blocks leaked: {free, used}")
    if backend == "nccl":
        check(engine.captures == 1 and replays == calls["windows"] > 0,
              f"{label}: {engine.captures} captures and {replays} replays "
              f"for {calls['windows']} windows")
    else:
        check(engine.captures == engine.replays == 0,
              f"{label}: the gloo group captured a decode graph")
    want = dict.fromkeys(KERNELS, 0)
    if engine.kv_layout == "dense":
        want["flash_decode"] = layers * engine.decode_steps * calls["windows"]
    else:
        want["flash_decode_paged"] = (layers * engine.decode_steps
                                      * calls["windows"])
        want["flash_prefill_paged"] = layers * calls["chunks"]
    check(got == want, f"{label}: launches {got}, attention calls {want}")
    cuda_core = fp.flash_prefill_attention_paged.cuda_core_launches
    check(cuda_core == 0, f"{label}: K7's CUDA-core instance ran")
    itl = [ms for c in comps for ms in c.inter_token_ms]
    return {"wall": wall, "tokens": sum(len(c.tokens) for c in comps),
            "ttft_p50": sorted(c.ttft_s * 1e3 for c in comps)[len(comps) // 2],
            "itl": [float(np.percentile(itl, 50)),
                    float(np.percentile(itl, 99))],
            "windows": calls["windows"], "chunks": calls["chunks"],
            "replays": replays, "captures": engine.captures,
            "launches": got, "streams": [c.tokens for c in comps],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def tp_serve(job):
    """Phase 10 in one rank of the tensor-parallel group: the fp32
    streams of ``job["prompts"]`` on the dense and the paged + chunked
    engine, then the bf16 serve mix on each (``tp_serve_mix``)."""
    out = {"streams": {}, "mix": {}}
    for dtype, seed in ((torch.float32, 1), (torch.bfloat16, 0)):
        cfg = cfg_of(dtype, job["layers"])
        params = port.init_pipeline_lm_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        for layout in ENGINES:
            torch.cuda.reset_peak_memory_stats()
            engine = port.serve(cfg, params=params, device="cuda",
                                tensor_parallel=TP, vocab_parallel=True,
                                **ENGINES[layout])
            if dtype == torch.float32:
                batcher = port.ContinuousBatcher(engine)
                rids = [batcher.submit(p, max_new_tokens=SERVE_TP_NEW)
                        for p in job["prompts"][layout]]
                done = batcher.run()
                out["streams"][layout] = [done[r].tokens for r in rids]
            else:
                out["mix"][layout] = tp_serve_mix(
                    engine, job["layers"], job["backend"],
                    f"{layout} on {job['backend']}")
            engine.close()
            del engine
        del params
        torch.cuda.empty_cache()
    return out


def phase_tp_serve():
    """Serving at tensor parallel 2 with the vocabulary sharded: 2 ranks
    on card 0 over gloo, and again over NCCL one rank a card where the
    machine has 2 cards.  The fp32 streams equal the one-process
    engine's (a divergence counts as a tie where the recompute's top two
    logits are within 1e-4); the bf16 serve mix's numbers and counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    layers = SERVE_TP_LAYERS
    cfg = cfg_of(torch.float32, layers)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    prompts = tp_serve_prompts(np.random.RandomState(1))
    want = {}
    for layout in ENGINES:
        engine = port.serve(cfg, params=params, device="cuda",
                            **ENGINES[layout])
        batcher = port.ContinuousBatcher(engine)
        rids = [batcher.submit(p, max_new_tokens=SERVE_TP_NEW)
                for p in prompts[layout]]
        done = batcher.run()
        want[layout] = [done[r].tokens for r in rids]
        engine.close()
    runs = [("gloo", f"{TP} ranks on one card, gloo, transfers through "
                     "host")]
    if torch.cuda.device_count() >= TP:
        runs.append(("nccl", f"{TP} ranks on {TP} cards, NCCL"))
    counts = {}
    for backend, label in runs:
        ranks = spawn_ranks({"kind": "serve", "layers": layers,
                             "prompts": prompts}, TP, backend)
        for r in ranks[1:]:
            check(r["streams"] == ranks[0]["streams"] and all(
                r["mix"][lay]["streams"] == ranks[0]["mix"][lay]["streams"]
                for lay in ENGINES), f"{label}: the ranks' streams differ")
        ties = 0
        for layout in ENGINES:
            for p, got, ref in zip(prompts[layout],
                                   ranks[0]["streams"][layout],
                                   want[layout]):
                if got == ref:
                    continue
                i = next(i for i, (a, b) in enumerate(zip(got, ref))
                         if a != b)
                seq = torch.as_tensor([p + ref[:i]], device="cuda")
                top2 = sequential_logits(cfg, params, seq)[0, -1].topk(2)
                gap = float(top2.values[0] - top2.values[1])
                check(gap < 1e-4, f"{label} {layout}: token {i} is "
                      f"{got[i]}, tensor parallel 1 gives {ref[i]} (top-2 "
                      f"gap {gap})")
                ties += 1
        print(f"phase 10 fp32 {layers}-layer pipelined LM [{label}]: "
              f"{sum(len(w) for w in want.values())} requests of "
              f"{SERVE_TP_NEW} tokens, dense and paged + chunked, equal "
              f"to tensor parallel 1 token for token (ties: {ties})",
              flush=True)
        for layout in ENGINES:
            m = ranks[0]["mix"][layout]
            peaks = ", ".join(f"{r['mix'][layout]['peak_gb']:.2f}"
                              for r in ranks)
            print(f"phase 10 {layout} bf16 [{label}, decode "
                  f"{'graph' if m['captures'] else 'host loop'}]: "
                  f"{m['tokens']} tokens in {m['wall']:.3f} s = "
                  f"{m['tokens'] / m['wall']:.1f} tokens/s, TTFT p50 "
                  f"{m['ttft_p50']:.2f} ms, inter-token p50 "
                  f"{m['itl'][0]:.3f} ms p99 {m['itl'][1]:.3f} ms, windows "
                  f"{m['windows']}, chunks {m['chunks']}, graph replays "
                  f"{m['replays']}, captures {m['captures']}, peak memory "
                  f"per rank {peaks} GB, rank 0 launches "
                  f"{ {k: v for k, v in m['launches'].items() if v} }",
                  flush=True)
            if backend == "gloo":
                for name, n in m["launches"].items():
                    counts[name] = counts.get(name, 0) + n
    del params
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------- #
# phases 8 and 9: expert-parallel training of the MoE LM
# --------------------------------------------------------------------- #
def moe_cfg(job):
    return moe_transformer.MoeConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=job["layers"],
        num_heads=HEADS, expert_hidden=MOE_HIDDEN, num_experts=MOE_EXPERTS,
        capacity_factor=job["capacity"], max_len=job["seq"],
        dtype=job["dtype"])


def moe_runner(job, program, expert_sharded=True, extra=None):
    """AutoDist + ExpertParallel on the MoE LM (weights from seed 0 on
    the card, the same in every rank), with ``extra`` builder keywords
    beside the program's, or with ``expert_sharded=False`` the dense
    model through ``AllReduce`` on one process."""
    cfg = moe_cfg(job)
    trainable = port.make_moe_lm_trainable(
        cfg, port.optim.adam(job["lr"]),
        torch.Generator(device="cuda").manual_seed(0),
        batch_size=job["batch"], seq_len=job["seq"],
        expert_sharded=expert_sharded)
    if not expert_sharded:
        return port.AutoDist({}, port.AllReduce()).build(trainable)
    return port.AutoDist({"mesh": {"expert": EXPERT}}, port.ExpertParallel(
        num_experts=MOE_EXPERTS, capacity_factor=job["capacity"],
        **MOE_PROGRAMS[program], **(extra or {}))).build(trainable)


def moe_window(job, steps, seed0=0):
    """``steps`` next-token batches ``{"x", "y" = x shifted}`` from a
    numpy seed, stacked ``[steps, B, L]``."""
    batches = []
    for i in range(steps):
        x = np.random.RandomState(seed0 + i).randint(
            0, VOCAB, (job["batch"], job["seq"])).astype(np.int32)
        batches.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return port.stack_steps(batches)


def moe_parity(job):
    """Phase 8 in one rank: 3 steps of each program; the nlls and
    losses."""
    out = {}
    for program in job["programs"]:
        runner = moe_runner(job, program)
        m = runner.run_steps(moe_window(job, 3, seed0=200))
        out[program] = {k: m[k].tolist() for k in ("nll", "loss")}
        runner.close()
        torch.cuda.empty_cache()
    return out


def moe_window_programs(job):
    """Phase 9 in one rank: per program a warm window, a timed one with
    the launch counters, then a profiled one."""
    out = {}
    for program in job["programs"]:
        runner = moe_runner(job, program)
        window = runner.place_steps(moe_window(job, MOE_STEPS))
        ar.fused_hop.unaligned = 0
        dt, metrics = timed_window(runner, window)
        got = launches()
        route = check_route(runner, job, program)
        check(ar.fused_hop.unaligned == 0,
              f"{program}: {ar.fused_hop.unaligned} K8 hops took the "
              f"element-wise path (the main path's arrays are aligned)")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = metrics["loss"].float()
        check(bool(torch.isfinite(losses).all()),
              f"{program}: non-finite loss {losses}")
        want = dict.fromkeys(KERNELS, 0)
        want.update({k: n * MOE_STEPS
                     for k, n in MOE_WANT.get(program, {}).items()})
        check(got == want, f"{program}: launches {got}, expected {want}")
        prof = profile_steps(runner, window, k=2, watch="ring_hop_kernel")
        out[program] = {"seconds": dt, "launches": got, "peak_gb": peak_gb,
                        "loss": [float(losses[0]), float(losses[-1])],
                        "profile": prof, "route": route}
        runner.close()
        del runner, window
        torch.cuda.empty_cache()
    return out


def phase_moe_parity():
    """fp32 on the card: each program on an expert axis of 2 against the
    dense one-process model, nll within the JAX golden's 5e-3."""
    # adam(1e-4): the sharded model averages the aux loss per shard, a
    # slightly different objective, and at 1e-3 the two trajectories of
    # this full-width model part by 4.2e-3 in nll by step 3 (H100).
    job = {"kind": "moe_parity", "layers": 1, "seq": 128, "batch": 8,
           "capacity": 4.0, "dtype": torch.float32, "lr": 1e-4,
           "programs": list(MOE_PROGRAMS)}
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = moe_runner(job, None, expert_sharded=False)
    dense = runner.run_steps(moe_window(job, 3, seed0=200))["nll"].tolist()
    runner.close()
    torch.cuda.empty_cache()
    ranks = spawn_ranks(job, EXPERT)
    got = ranks[0]
    for program in job["programs"]:
        check(all(abs(a - b) <= 1e-6 * abs(b) for k in ("nll", "loss")
                  for a, b in zip(ranks[1][program][k], got[program][k])),
              f"{program}: the ranks' metrics differ: {ranks}")
        r = got[program]
        check(all(math.isfinite(x) for x in r["loss"] + r["nll"]),
              f"{program}: non-finite loss {r}")
        for i, (a, b) in enumerate(zip(r["nll"], dense)):
            check(abs(a - b) <= 5e-3, f"step {i}: {program} nll {a} vs "
                  f"dense {b} differ by more than 5e-3")
    print(f"phase 8 fp32 1-layer MoE LM, seq 128, batch 8, capacity 4.0, "
          f"3 Adam steps, expert axis 2 on one card over gloo: dense nll "
          f"{dense}; " + "; ".join(f"{p} {got[p]['nll']}"
                                   for p in job["programs"]), flush=True)


def phase_moe_window():
    """bf16 window of the composed int8 and a2a_ring programs: 2 ranks on
    card 0 over gloo, and over NCCL one rank per card where the machine
    has 2 cards."""
    job = {"kind": "moe_window", "layers": MOE_LAYERS, "seq": MOE_SEQ,
           "batch": MOE_ROWS * EXPERT, "capacity": 2.0, "lr": 1e-3,
           "dtype": torch.bfloat16, "programs": ["int8", "a2a_ring"]}
    counts = {}
    runs = [("gloo", f"{EXPERT} ranks on one card, gloo, transfers through "
                     f"host")]
    if torch.cuda.device_count() >= EXPERT:
        runs.append(("nccl", f"{EXPERT} ranks on {EXPERT} cards, NCCL"))
    tokens = MOE_STEPS * job["batch"] * MOE_SEQ
    for backend, label in runs:
        ranks = spawn_ranks(job, EXPERT, backend)
        for program in job["programs"]:
            r0 = ranks[0][program]
            dt = max(r[program]["seconds"] for r in ranks)
            peaks = ", ".join(f"{r[program]['peak_gb']:.2f}" for r in ranks)
            per_step = {k: n / MOE_STEPS for k, n in r0["launches"].items()
                        if n}
            line = (f"phase 9 {program} bf16 [{label}, run_steps route "
                    f"{r0['route']}]: {MOE_STEPS} steps "
                    f"in {dt:.3f} s = {tokens / dt:.1f} tokens/s, step "
                    f"{dt / MOE_STEPS * 1e3:.2f} ms, peak memory per rank "
                    f"{peaks} GB, loss {r0['loss'][0]:.4f} -> "
                    f"{r0['loss'][1]:.4f}, launches per step {per_step}")
            if r0["profile"] is None:
                line += "; rank 0 profile: device time not measured"
            else:
                prof_ms, busy, n_launch, _, top = r0["profile"]
                line += (f"; rank 0 profile: device busy {busy:.2f} ms of "
                         f"the profiled step's {prof_ms:.2f} ms "
                         f"({busy / prof_ms:.1%}), {n_launch:.0f} kernel "
                         f"launches per step; top per step: {top}")
            print(line, flush=True)
            if backend == "gloo":
                for name in MOE_KERNELS:
                    counts[name] = counts.get(name, 0) + r0["launches"][name]
    return counts


# --------------------------------------------------------------------- #
# phases 11 and 12: sequence-parallel training of the causal LM
# --------------------------------------------------------------------- #
def lm_runner(job, ring=None, remat=False, builder_kw=None):
    """``TransformerLM`` at full width, depth ``job["layers"]``, weights
    from seed 0 on the card (the same in every rank): with ``ring`` (a
    key of ``RINGS``) the causal ring and ``global_positions`` through
    ``AutoDist`` + ``SequenceParallel(**builder_kw)`` on
    ``job["mesh"]``; without, the whole sequence through
    ``flash_attention`` causal on one process (``AllReduce``)."""
    fn, pos = ((RINGS[ring](causal=True), global_positions) if ring
               else (fa.make_attention_fn(True), None))
    cfg = port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=job["layers"],
        num_heads=HEADS, mlp_dim=MLP, max_len=job["max_len"],
        dtype=job["dtype"], dropout_rate=0.0, attention_dropout_rate=0.0,
        remat=remat, attention_fn=fn, position_fn=pos)
    name, lr = job["opt"]
    trainable = port.make_lm_trainable(
        cfg, getattr(port.optim, name)(lr),
        torch.Generator(device="cuda").manual_seed(0))
    if ring is None:
        return port.AutoDist({}, port.AllReduce()).build(trainable)
    return port.AutoDist({"mesh": job["mesh"]}, port.SequenceParallel(
        **(builder_kw or {}))).build(trainable)


def lm_window(job, steps, seed0=0):
    """``steps`` next-token batches ``{"x", "y" = x shifted}`` of
    ``job["batch"]`` sequences of ``job["seq"]`` tokens from a numpy
    seed, stacked ``[steps, B, L]``."""
    batches = []
    for i in range(steps):
        x = np.random.RandomState(seed0 + i).randint(
            0, VOCAB, (job["batch"], job["seq"])).astype(np.int32)
        batches.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return port.stack_steps(batches)


def seq_parity(job):
    """Phase 11 in one rank: 3 steps of each program; the losses."""
    out = {}
    for program in job["programs"]:
        runner = lm_runner(job, program.split()[0], "remat" in program)
        out[program] = runner.run_steps(lm_window(job, 3, seed0=300))[
            "loss"].tolist()
        runner.close()
        torch.cuda.empty_cache()
    return out


def phase_seq_parity():
    """fp32 on the card: the flash ring, the einsum ring and the flash
    ring under remat on a seq axis of 2 against one process with
    ``flash_attention`` causal over the whole sequence."""
    job = {"kind": "seq_parity", "layers": 2, "seq": 256, "max_len": 256,
           "batch": 4, "dtype": torch.float32, "opt": ("adam", 1e-4),
           "mesh": {"seq": SEQ},
           "programs": ["flash", "einsum", "flash remat"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = lm_runner(job)
    one = runner.run_steps(lm_window(job, 3, seed0=300))["loss"].tolist()
    runner.close()
    torch.cuda.empty_cache()
    ranks = spawn_ranks(job, SEQ)
    got = ranks[0]
    for program in job["programs"]:
        check(all(abs(a - b) <= 1e-6 * abs(b) for a, b in
                  zip(ranks[1][program], got[program])),
              f"{program}: the ranks' losses differ: {ranks}")
    pairs = [("flash", one, 1e-4, "one process"),
             ("einsum", one, 1e-4, "one process"),
             ("flash remat", got["flash"], 1e-6, "no remat")]
    for program, ref, tol, what in pairs:
        for i, (a, b) in enumerate(zip(got[program], ref)):
            check(math.isfinite(a) and abs(a - b) <= tol * abs(b),
                  f"step {i}: {program} loss {a} vs {what} {b} differ by "
                  f"more than {tol} relative")
    print(f"phase 11 fp32 2-layer TransformerLM, global seq 256, batch 4, "
          f"3 Adam steps, seq 2 on one card over gloo: one process "
          f"(flash_attention causal) {one}; " + "; ".join(
              f"{p} {got[p]}" for p in job["programs"]), flush=True)


def kernel_ms(top):
    """K1, K2a and K2b device ms a step from a profile's top list."""
    frags = {"flash_attention_fwd": "fwd_wgmma_kernel",
             "flash_attention_bwd_dq": "dq_wgmma_kernel",
             "flash_attention_bwd_dkv": "dkv_wgmma_kernel"}
    found = dict.fromkeys(frags, 0.0)
    for entry in top.split("; "):
        m = re.match(r"(.*) x[\d.]+ ([\d.]+) ms$", entry)
        for name, frag in frags.items():
            if m and frag in m.group(1) and "matmul" not in m.group(1):
                found[name] += float(m.group(2))
    return found


def seq_window_rows(job):
    """Phase 12 in one rank: per row a warm window, a timed one with the
    launch counters, then a profiled one of 2 steps."""
    out = {}
    for row in job["rows"]:
        rj = dict(job, **row)
        runner = lm_runner(rj, "flash", row["remat"])
        index = runner.lowered.mesh.axis("seq").index
        window = runner.place_steps(lm_window(rj, row["steps"]))
        dt, metrics = timed_window(runner, window)
        graphs = (runner.captures, runner.replays)
        route = check_route(runner, job, row["label"])
        if job["backend"] == "nccl":
            check(graphs == (1, 2), f"{row['label']}: {graphs[0]} captures "
                  f"and {graphs[1]} replays, expected 1 and 2")
        got = launches()
        want = dict.fromkeys(KERNELS, 0)
        want.update({k: n * row["steps"] for k, n in seq_want(
            index, job["layers"], row["remat"]).items()})
        check(got == want, f"{row['label']} on seq rank {index}: launches "
                           f"{got}, expected {want}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = metrics["loss"].float()
        check(bool(torch.isfinite(losses).all()),
              f"{row['label']}: non-finite loss {losses}")
        prof = profile_steps(runner, window, k=2, watch="wgmma_kernel")
        out[row["label"]] = {
            "seconds": dt, "launches": got, "peak_gb": peak_gb,
            "index": index, "loss": [float(losses[0]), float(losses[-1])],
            "profile": prof, "route": route,
            "attention_ms": None if prof is None else kernel_ms(prof[4])}
        runner.close()
        del runner, window
        torch.cuda.empty_cache()
    return out


def long_context_one_process(job):
    """One process over the whole 8192-token sequence (``flash_attention``
    causal, a loop of ``step`` calls as the gloo ranks run): step ms and
    peak memory."""
    rj = dict(job, batch=1, seq=LONG_LEN, max_len=LONG_LEN)
    runner = lm_runner(rj)
    window = runner.place_steps(lm_window(rj, LONG_STEPS))
    dt, _ = timed_window(runner, window, loop=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runner.close()
    del runner, window
    torch.cuda.empty_cache()
    return dt, peak_gb


def phase_seq_window():
    """bf16: the window on a seq axis of 2 over gloo (2 ranks on card
    0), then the long-context rows, remat off and on, beside one process
    at the whole sequence; over NCCL, one rank per card, where the
    machine has the cards (2: seq 2; 4: also seq 4, global 2048)."""
    main = {"label": "window", "batch": SEQ_BATCH, "seq": SEQ_LEN,
            "max_len": SEQ_LEN, "steps": SEQ_STEPS, "remat": False}
    long_rows = [{"label": f"long context{' remat' if remat else ''}",
                  "batch": 1, "seq": LONG_LEN, "max_len": LONG_LEN,
                  "steps": LONG_STEPS, "remat": remat}
                 for remat in (False, True)]
    job = {"kind": "seq_window", "layers": SEQ_LAYERS,
           "dtype": torch.bfloat16, "opt": ("adamw", 3e-4)}
    runs = [("gloo", {"seq": SEQ}, [main] + long_rows)]
    cards = torch.cuda.device_count()
    if cards >= SEQ:
        runs.append(("nccl", {"seq": SEQ}, [main]))
    if cards >= 4:
        runs.append(("nccl", {"seq": 4}, [main]))
    counts = {}
    for backend, mesh, rows in runs:
        world = math.prod(mesh.values())
        label = (f"{mesh_label(mesh)}, {world} ranks on one card, gloo, "
                 f"transfers through host" if backend == "gloo" else
                 f"{mesh_label(mesh)}, {world} ranks on {world} cards, NCCL")
        ranks = spawn_ranks(dict(job, mesh=mesh, rows=rows), world, backend)
        for row in rows:
            rs = [r[row["label"]] for r in ranks]
            dt = max(r["seconds"] for r in rs)
            tokens = row["steps"] * row["batch"] * row["seq"]
            line = (f"phase 12 {row['label']} bf16 [{label}, batch "
                    f"{row['batch']} of {row['seq']} tokens, positional "
                    f"table {row['max_len']} rows, run_steps route "
                    f"{rs[0]['route']}]: {row['steps']} steps in {dt:.3f} s "
                    f"= {tokens / dt:.1f} tokens/s, step "
                    f"{dt / row['steps'] * 1e3:.2f} ms, peak memory per "
                    f"rank " + ", ".join(f"{r['peak_gb']:.2f}" for r in rs)
                    + f" GB, loss {rs[0]['loss'][0]:.4f} -> "
                    f"{rs[0]['loss'][1]:.4f}")
            for r in rs:
                per_step = {k: n / row["steps"]
                            for k, n in r["launches"].items() if n}
                line += f"; seq rank {r['index']}: launches a step {per_step}"
                if r["profile"] is None:
                    line += ", profile: device time not measured"
                    continue
                prof_ms, busy, n_launch, _, top = r["profile"]
                line += (f", device busy {busy:.2f} ms of the profiled "
                         f"step's {prof_ms:.2f} ms ({busy / prof_ms:.1%}), "
                         f"{n_launch:.0f} kernel launches a step, K1/K2a/"
                         f"K2b device ms a step "
                         + "/".join(f"{ms:.3f}" for ms in
                                    r["attention_ms"].values())
                         + f"; top a step: {top}")
            print(line, flush=True)
            if backend == "gloo" and row is main:
                for r in rs:
                    for name, n in r["launches"].items():
                        counts[name] = counts.get(name, 0) + n
        if backend == "gloo":
            dt, peak_gb = long_context_one_process(job)
            print(f"phase 12 long context bf16 [one process on one card, "
                  f"batch 1 of {LONG_LEN} tokens, flash_attention causal, "
                  f"a loop of step calls]: step {dt / LONG_STEPS * 1e3:.2f} "
                  f"ms, peak memory {peak_gb:.2f} GB", flush=True)
    return counts


# --------------------------------------------------------------------- #
# phases 13 and 14: the data-parallel strategy zoo on BERT
# --------------------------------------------------------------------- #
def zoo_builder(spec):
    """A builder from ``(name, kwargs)``; ``None`` is AutoDist's default
    (``PSLoadBalancing``)."""
    if spec is None:
        return None
    name, kw = spec
    if name == "GradAccumulation":
        kw = dict(kw, builder=zoo_builder(kw["builder"]))
    return getattr(port, name)(**kw)


def zoo_runner(job, spec, batch):
    """BERT at full width, ``job["layers"]`` deep, the flash attention,
    weights from seed 0 on the card (every rank and row alike), through
    ``AutoDist({}, builder)``: the data axis is the job's ranks."""
    cfg = port.TransformerConfig(               # BERT-base's widths
        num_layers=job["layers"], dtype=job["dtype"], dropout_rate=0.0,
        attention_dropout_rate=0.0, attention_fn=fa.make_attention_fn(False))
    lr, wd, mu, eps = job["opt"]
    trainable = bert.make_mlm_trainable(
        cfg, port.optim.adamw(lr, eps=eps, weight_decay=wd, mu_dtype=mu),
        torch.Generator(device="cuda").manual_seed(0),
        with_input_mask=False)
    return port.AutoDist({}, zoo_builder(spec)).build(trainable), trainable


def zoo_window(job, steps, batch, seed0=0):
    batches = []
    for i in range(steps):
        b = bert.synthetic_mlm_batch(seed0 + i, batch, job["seq"],
                                     job["masked"], 30522)
        b.pop("input_mask")
        batches.append(b)
    return port.stack_steps(batches)


def state_bytes(tree):
    return sum(t.numel() * t.element_size()
               for _, t in flatten_with_names(tree)
               if isinstance(t, torch.Tensor))


def tensor_errs(got, want):
    """Per tensor max |a - b| over max |b|, floored at 1e-3 (a tensor
    that stays near 0, as the k projection's bias whose gradient is
    zero, is held at 1e-3 absolute times the tolerance)."""
    w = dict(flatten_with_names(want))
    return {n: float((a.float() - w[n].float()).abs().max()
                     / w[n].float().abs().max().clamp(min=1e-3))
            for n, a in flatten_with_names(got)}


def rel_err(got, want):
    """The largest of :func:`tensor_errs` over the tree."""
    return max(tensor_errs(got, want).values())


# Phase 13's wire units: a loss may part from AllReduce's by this much of
# itself for every update behind it (fp16, bf16: the wire's unit; int8:
# two levels of 1/127 of the largest value, its own rounding and the
# group scale's; PowerSGD: 1, a rank-r wire keeps no precision of the
# gradient outside its top r directions, so only the first loss, before
# any update, and finite losses are held).
ZOO_WIRE = {"fp16": 2.0 ** -11, "fp16_ef": 2.0 ** -11, "bf16": 2.0 ** -8,
            "bf16_ef": 2.0 ** -8, "int8_ef": 2.0 / 127,
            "int8_ring": 2.0 / 127, "powersgd:2": 1.0}
ZOO_GOLDEN = [("AllReduce", ("AllReduce", {"chunk_size": 2})),
              ("AllReduce-chunk1", ("AllReduce", {"chunk_size": 1})),
              ("PS", ("PS", {})), ("PSLoadBalancing", ("PSLoadBalancing", {})),
              ("PartitionedPS", ("PartitionedPS", {})),
              ("UnevenPartitionedPS", ("UnevenPartitionedPS", {})),
              ("PartitionedAR", ("PartitionedAR", {})),
              ("RandomAxisPartitionAR", ("RandomAxisPartitionAR",
                                         {"seed": 3})),
              ("Parallax", ("Parallax", {})),
              ("ZeRO1", ("ZeRO", {"stage": 1})),
              ("ZeRO2", ("ZeRO", {"stage": 2})),
              ("ZeRO3", ("ZeRO", {"stage": 3})),
              ("GradAccumulation", ("GradAccumulation", {
                  "builder": ("AllReduce", {}), "steps": 2}))]
ZOO_COMPRESSED = [(c, ("AllReduce", {"compressor": c})) for c in ZOO_WIRE]


def zoo_parity(job):
    """Phase 13 in one rank: 3 steps of every builder; losses, the
    parameters' largest relative distance from AllReduce's, the logical
    shapes of ``get_params``, stored bytes."""
    out, ref = {}, None
    world = torch.distributed.get_world_size()
    window = zoo_window(job, 3, job["batch"] * world, seed0=400)
    for label, spec in ZOO_GOLDEN + ZOO_COMPRESSED:
        runner, trainable = zoo_runner(job, spec, job["batch"])
        losses = runner.run_steps(window)["loss"].tolist()
        params = runner.get_params()
        shapes_ok = ([(n, tuple(t.shape)) for n, t in
                      flatten_with_names(params)]
                     == [(n, tuple(t.shape)) for n, t in
                         flatten_with_names(trainable.params)])
        if ref is None:
            ref = params
        out[label] = {"loss": losses, "shapes_ok": shapes_ok,
                      "err": rel_err(params, ref),
                      "params_bytes": state_bytes(runner.state["params"]),
                      "opt_bytes": state_bytes(runner.state["opt_state"]),
                      "route": check_route(runner, job, label)}
        runner.close()
        del runner, trainable, params
        torch.cuda.empty_cache()
    return out


def phase_zoo_parity():
    """fp32 on the card: BERT at full width cut to 2 layers, 3 AdamW
    steps of every golden builder, every compressor and accumulation on
    2 ranks over gloo (and over NCCL with 2 or more cards), each held to
    AllReduce's run on the same weights and batches."""
    # Adam's eps at 1e-4: the k projection's bias has an exactly zero
    # gradient (a softmax does not see a shift of every score), and at
    # 1e-8 Adam turns its summation-order noise into steps of the
    # learning rate that differ between any two reduction orders (a
    # microbatch sum, a reduce-scatter, NCCL's ring).
    job = {"kind": "zoo_parity", "layers": 2, "dtype": torch.float32,
           "seq": 128, "masked": 20, "batch": 4,
           "opt": (1e-4, 0.01, None, 1e-4)}
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = [("gloo", 2)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", torch.cuda.device_count()))
    for backend, world in runs:
        ranks = spawn_ranks(job, world, backend)
        got, ar = ranks[0], ranks[0]["AllReduce"]["loss"]
        faults = []
        for label, res in got.items():
            if not res["shapes_ok"]:
                faults.append(f"{label}: get_params shapes differ from "
                              f"the logical tree")
            if not all(math.isfinite(x) for x in res["loss"]):
                faults.append(f"{label}: non-finite loss {res['loss']}")
            if label not in ZOO_WIRE:
                if not (res["err"] <= 1e-5 and all(
                        abs(a - b) <= 1e-5 * abs(b)
                        for a, b in zip(res["loss"], ar))):
                    faults.append(
                        f"{label}: losses {res['loss']} vs AllReduce "
                        f"{ar}, params {res['err']:.3g} relative")
                continue
            eps = ZOO_WIRE[label]
            for k, (a, b) in enumerate(zip(res["loss"], ar)):
                bound = 1e-6 * abs(b) if k == 0 else eps * k * abs(b)
                if abs(a - b) > bound:
                    faults.append(f"{label} step {k}: loss {a} vs "
                                  f"AllReduce {b}, bound {bound:.3g}")
        sizes = {n: (got[n]["params_bytes"], got[n]["opt_bytes"])
                 for n in ("AllReduce", "PS", "PartitionedPS")}
        ar_p, ar_o = sizes["AllReduce"]
        if not (sizes["PS"][0] == ar_p and sizes["PS"][1] <= ar_o / world
                * 1.01 and sizes["PartitionedPS"][0] <= ar_p / world * 1.01
                and sizes["PartitionedPS"][1] <= ar_o / world * 1.01):
            faults.append(f"stored bytes a rank at data {world}: {sizes}")
        print(f"phase 13 fp32 2-layer BERT-base width, seq 128, batch "
              f"{job['batch']} a rank, 3 AdamW steps, data {world} "
              f"[{world} ranks, {backend}, run_steps route "
              f"{got['AllReduce']['route']}]: AllReduce losses {ar}; "
              + "; ".join(f"{n} params {r['err']:.2e} rel., last loss "
                          f"{r['loss'][-1]:.6f}" for n, r in got.items()
                          if n != "AllReduce")
              + "; stored bytes a rank (params, optimizer state) "
              + ", ".join(f"{n} {p}, {o}" for n, (p, o) in sizes.items()),
              flush=True)
        check(not faults, f"phase 13 over {backend}: " + "; ".join(faults))


# Phase 14's rows on the graph route: (label, builder spec).
ZOO_ROWS = [
    ("AutoDist default (PSLoadBalancing)", None),
    ("PartitionedPS", ("PartitionedPS", {})),
    *[(f"AllReduce {c}", ("AllReduce", {"chunk_size": 256,
                                        "compressor": c}))
      for c in ("bf16_ef", "int8_ring", "int8_ef", "powersgd:2")],
    ("GradAccumulation 2", ("GradAccumulation", {
        "builder": ("AllReduce", {"chunk_size": 256}), "steps": 2})),
    ("AllReduce", ("AllReduce", {"chunk_size": 256}))]
ZOO_GLOO = [("PS", ("PS", {})), ("PartitionedPS", ("PartitionedPS", {})),
            ("AllReduce", ("AllReduce", {"chunk_size": 256}))]


def zoo_bf16_job(world=1):
    return {"kind": "zoo_window", "layers": 12, "dtype": torch.bfloat16,
            "seq": BERT_SEQ, "masked": BERT_MASKED, "batch": BERT_BATCH,
            "opt": (1e-4, 0.01, torch.bfloat16, 1e-8), "world": world}


def zoo_row(job, label, spec, steps, check_graph):
    """One row: a warm window and a timed one (launch counters from 0
    before it), on the runner's route; the row's numbers and its final
    parameters."""
    world = job["world"]
    runner, _ = zoo_runner(job, spec, job["batch"])
    window = runner.place_steps(zoo_window(job, steps, job["batch"] * world))
    dt, metrics = timed_window(runner, window)
    got = launches()
    accum = 2 if label.startswith("GradAccumulation") else 1
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(TRAINING_KERNELS,
                              job["layers"] * steps * accum))
    check(got == want, f"{label}: launches {got}, expected {want}")
    if check_graph:
        check((runner.captures, runner.replays) == (1, 2),
              f"{label}: {runner.captures} captures and {runner.replays} "
              f"replays, expected 1 and 2")
    losses = metrics["loss"].float()
    check(bool(torch.isfinite(losses).all()), f"{label}: non-finite loss")
    row = {"seconds": dt, "launches": got,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "capture_s": runner.capture_seconds,
           "graphs": (runner.captures, runner.replays),
           "loss": [float(losses[0]), float(losses[-1])],
           "params_bytes": state_bytes(runner.state["params"]),
           "opt_bytes": state_bytes(runner.state["opt_state"]),
           "sync_bytes": state_bytes(runner.state["sync_state"])}
    params = runner.get_params()
    runner.close()
    del runner, window
    torch.cuda.empty_cache()
    return row, params


def zoo_window_rows(job):
    """Phase 14 in one rank of a spawned job: each row of ``job["rows"]``
    (labels into ``ZOO_ROWS`` or ``ZOO_GLOO``); with ``job["digest"]``
    rank 0 keeps each row's final parameters for the caller."""
    out, rows = {}, dict(ZOO_ROWS + ZOO_GLOO)
    for label in job["rows"]:
        row, params = zoo_row(job, label, rows[label], job["steps"],
                              job["backend"] == "nccl")
        row["route"] = "graph" if job["backend"] == "nccl" else "loop"
        if job.get("digest") and torch.distributed.get_rank() == 0:
            torch.save({n: t.cpu() for n, t in flatten_with_names(params)},
                       os.path.join(job["digest"], f"{label}.pt"))
        out[label] = row
        del params
    return out


def zoo_line(label, row, steps, batch, flops, chip, where):
    rate = steps * batch / row["seconds"]
    return (f"phase 14 {label} bf16 [{where}]: {steps} steps in "
            f"{row['seconds']:.3f} s = {rate:.2f} examples/s, step "
            f"{row['seconds'] / steps * 1e3:.2f} ms, MFU "
            f"{rate * flops / (chip.peak_bf16_tflops * 1e12):.4f}, peak "
            f"memory {row['peak_gb']:.2f} GB, stored bytes (params, "
            f"optimizer state, compressor rows) {row['params_bytes']}, "
            f"{row['opt_bytes']}, {row['sync_bytes']}, graph captures "
            f"{row['graphs'][0]} ({row['capture_s']:.2f} s), replays "
            f"{row['graphs'][1]}, loss {row['loss'][0]:.4f} -> "
            f"{row['loss'][1]:.4f}")


def update_distance(got, want, init):
    """``|got - want|_2 / |want - init|_2`` over the whole tree: how far
    two runs part, against how far the reference moved.  Over the tree,
    not a tensor: the k projection's bias has a zero gradient, so at
    Adam's eps 1e-8 its steps are summation noise, as large in one run
    as the other."""
    apart = sum(float((got[n].float() - w.float()).norm()) ** 2
                for n, w in want.items())
    moved = sum(float((w.float() - init[n].float()).norm()) ** 2
                for n, w in want.items())
    return (apart / max(moved, 1e-30)) ** 0.5


def phase_zoo_window():
    """bf16 BERT-base, the bench's window: every row on one card on the
    graph route; PS, PartitionedPS and AllReduce at data 2 over gloo on
    the card; over NCCL at data = the cards where there are 2 or more,
    each row's parameters held to one card's on the same batches.
    Returns the default row's launches."""
    cfg = bert.bert_base()
    flops = bert.mlm_model_flops_per_example(cfg, BERT_SEQ, BERT_MASKED)
    chip = port.ResourceSpec({}).chip
    job = dict(zoo_bf16_job(), backend="nccl")       # one card: graph
    counts = {}
    for label, spec in ZOO_ROWS:
        row, _ = zoo_row(job, label, spec, BERT_STEPS, True)
        if spec is None:
            counts = {k: row["launches"][k] for k in TRAINING_KERNELS}
        print(zoo_line(label, row, BERT_STEPS, BERT_BATCH, flops, chip,
                       "one card, data 1, run_steps route graph"),
              flush=True)
    ranks = spawn_ranks(dict(zoo_bf16_job(2), steps=3,
                             rows=[label for label, _ in ZOO_GLOO]), 2)
    for label, _ in ZOO_GLOO:
        rs = [r[label] for r in ranks]
        dt = max(r["seconds"] for r in rs)
        print(f"phase 14 {label} bf16 [data 2, 2 ranks on one card, gloo, "
              f"transfers through host, run_steps route loop, batch "
              f"{BERT_BATCH} a rank]: 3 steps in {dt:.3f} s, step "
              f"{dt / 3 * 1e3:.2f} ms; per rank: peak memory "
              + ", ".join(f"{r['peak_gb']:.2f}" for r in rs)
              + " GB, stored bytes (params, optimizer state) "
              + ", ".join(f"{r['params_bytes']}, {r['opt_bytes']}"
                          for r in rs), flush=True)
    cards = torch.cuda.device_count()
    if cards >= 2:
        with tempfile.TemporaryDirectory() as digest:
            ranks = spawn_ranks(dict(zoo_bf16_job(cards), steps=BERT_STEPS,
                                     rows=[label for label, _ in ZOO_ROWS],
                                     digest=digest), cards, "nccl")
            init_runner, _ = zoo_runner(zoo_bf16_job(cards), None,
                                        BERT_BATCH)
            init = {n: t.cpu() for n, t in flatten_with_names(
                init_runner.get_params())}
            init_runner.close()
            job_n = dict(zoo_bf16_job(cards), backend="nccl",
                         batch=BERT_BATCH * cards, world=1)
            for label, spec in ZOO_ROWS:
                rs = [r[label] for r in ranks]
                _, params = zoo_row(job_n, label, spec, BERT_STEPS, True)
                ref = {n: t.cpu() for n, t in flatten_with_names(params)}
                del params
                dist = update_distance(
                    torch.load(os.path.join(digest, f"{label}.pt")), ref,
                    init)
                check(dist <= 0.1, f"{label} over NCCL at data {cards}: "
                      f"parameters {dist:.3g} of one card's update away")
                print(zoo_line(label, rs[0], BERT_STEPS,
                               BERT_BATCH * cards, flops, chip,
                               f"data {cards}, {cards} cards, NCCL, "
                               f"run_steps route graph, batch {BERT_BATCH} "
                               f"a card")
                      + f"; parameters against one card's on the same "
                      f"{BERT_BATCH * cards}-row batches: {dist:.3e} of "
                      f"its update; peak memory per rank "
                      + ", ".join(f"{r['peak_gb']:.2f}" for r in rs)
                      + " GB", flush=True)
    return counts


# --------------------------------------------------------------------- #
# phases 15 and 16: ZeRO, compressors, accumulation and remat in the
# pipeline, sequence and expert lowerings
# --------------------------------------------------------------------- #
# A narrowed wire's unit, and whether it narrows the forward on its mesh
# too (a weight gather or a model-axis boundary: the first loss moves)
# or only the gradients.
BF16_GRAD, BF16_FWD = (2.0 ** -8, False), (2.0 ** -8, True)
INT8_GRAD, INT8_FWD = (2.0 / 127, False), (2.0 / 127, True)
# The fault row: the plain program at a learning rate of 0, which every
# bound must reject.
NO_UPDATE = "no update"
# The narrowed rows' optimizer and their reference: SGD, whose update is
# the synced gradient times the rate, so that a wire's rounding of each
# gradient shows in the parameters in proportion.  Adam at eps 1e-8
# steps every element by about the rate whatever its gradient, so an
# int8 wire that rounds the small gradients to 0 takes those steps away
# (0.88 of the table's update, the no-update run's 1.0: PERF.md, phase
# 15).
LINEAR, LINEAR_LR = "plain, SGD", 0.1
# An exact row held on SGD: accumulation sums each gradient as two
# half-batch sums, and where the halves cancel their rounding is a large
# share of a small gradient, which Adam divides by that gradient's own
# size (3.0e-4 of the q and v biases' largest value at eps 1e-4, 2.71e-3
# at 1e-8: PERF.md, phase 15).  SGD's step is linear in the gradient.
EXACT_SGD = "exact, SGD"
# Every slot of the "int8" string but vocab_stats: at this fp32 width a
# token whose tied logit stands ~11 above the rest has a sum-exp near 1
# beside others' ~400, and the group's shared int8 scale rounds it to 0
# (log 0: a loss of -inf).  The JAX package's rule gives the same -inf
# on such inputs (tests/test_torch_vocab_parallel.py,
# test_int8_stats_underflow_is_the_jax_rule).
INT8_BUT_STATS = {"tp_psum": "int8", "grad": "int8", "zero3_gather": "int8",
                  "moe_a2a": "int8"}


def zero_pipe_programs(int8, model_axis):
    """Phase 15's pipeline programs: (label, Pipeline keywords,
    accumulation steps, the wire, None for an exact one), the int8
    program at ``int8``, which narrows the forward only on a mesh with a
    ``model_axis``.  The mix: variables of 1 MiB and more (the kernels,
    the table) ZeRO-3, the rest bf16_ef."""
    return [
        ("plain", {}, 1, None),
        (LINEAR, {}, 1, LINEAR),
        (NO_UPDATE, {}, 1, NO_UPDATE),
        ("ZeRO-1", dict(zero_stage=1), 1, None),
        ("ZeRO-2", dict(zero_stage=2), 1, None),
        ("ZeRO-3", dict(zero_stage=3), 1, None),
        ("zero_min_bytes", dict(zero_stage=3, zero_min_bytes=1 << 20,
                                compressor="bf16_ef"), 1, BF16_GRAD),
        ("ZeRO-3 zero3_gather bf16", dict(zero_stage=3, collective_precision={
            "zero3_gather": "bf16"}), 1, BF16_FWD),
        ("bf16_ef", dict(compressor="bf16_ef"), 1, BF16_GRAD),
        ("int8", dict(collective_precision=int8), 1,
         INT8_FWD if model_axis else INT8_GRAD),
        ("GradAccumulation 2", {}, 2, EXACT_SGD),
        ("remat", dict(remat=True), 1, None)]


# On the vocab-parallel mesh also the fused int8 ring under remat: its
# recompute re-runs the stages' forward rings in the backward.
RING_REMAT = ("int8 quant_ring remat", dict(
    collective_precision=INT8_BUT_STATS, kernel=("quant_ring",),
    remat=True), 1, INT8_FWD)
# (mesh, layout, the int8 program's precision)
ZERO_PIPE_MESHES = [({"data": 2, "pipe": 2}, {}, "int8"),
                    ({"data": 2, "pipe": 1, "model": TP}, VOCAB_PARALLEL,
                     INT8_BUT_STATS)]
# Phase 16's pipeline rows at data 2 x pipe 2: (label, keywords, accum).
ZERO_WINDOW_ROWS = [("plain", {}, 1), ("ZeRO-1", dict(zero_stage=1), 1),
                    ("ZeRO-3", dict(zero_stage=3), 1),
                    ("GradAccumulation 2", {}, 2),
                    ("remat", dict(remat=True), 1)]
ZERO_WINDOW_STEPS = 2
ZERO_PARITY_STEPS = 2


def ring_remat_want(layers, first):
    """K3 a rank and step under remat at T = 2: ``tp_want``'s four rings
    a layer and microbatch plus the two forward rings recomputed in the
    backward (the prologue's lookup ring is outside the stages)."""
    return {"quant_ring_hop": 2 * 6 * layers * TP_MICRO
            + (TP if first else 0)}


def zero_pipe_runner(job, kw, accum, opt=None):
    """AutoDist + Pipeline (wrapped in GradAccumulation when ``accum`` >
    1) on the pipelined LM at full width, depth ``job["layers"]``, over
    ``job["mesh"]``; weights from seed 0 on the card; ``opt``, or Adam
    at ``job["opt"]``."""
    mesh = job["mesh"]
    cfg = port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=job["layers"],
        num_heads=HEADS, mlp_dim=MLP, max_len=job["seq"], dtype=job["dtype"],
        dropout_rate=0.0, attention_dropout_rate=0.0)
    rate, eps = job["opt"]
    trainable = make_pipeline_lm_trainable(
        cfg, opt or port.optim.adam(rate, eps=eps),
        torch.Generator(device="cuda").manual_seed(0))
    builder = Pipeline(num_microbatches=TP_MICRO,
                       virtual_stages=job["layers"] // mesh["pipe"],
                       tensor_parallel=mesh.get("model", 1),
                       **job["layout"], **kw)
    if accum > 1:
        builder = port.GradAccumulation(builder, accum)
    return port.AutoDist({"mesh": mesh}, builder).build(trainable)


def var_bytes(state):
    """Bytes a rank stores a variable: ``(params, optimizer state)``, the
    latter its Adam moments."""
    params = {nm: t.numel() * t.element_size()
              for nm, t in state["params"].items()}
    opt = dict.fromkeys(params, 0)
    for nm, t in flatten_with_names(state["opt_state"]):
        if nm.startswith(("mu/", "nu/")):
            opt[nm[3:]] += t.numel() * t.element_size()
    return params, opt


def zero_record(runner):
    """Stored bytes a variable and the lowering's records: the ZeRO
    (PS) variables, those stored as ZeRO-3 shards, the degraded ones,
    the unapplied slots."""
    params, opt = var_bytes(runner.state)
    low = runner.lowered
    return {"params_bytes": params, "opt_bytes": opt,
            "zero": sorted(nc.var_name for nc in runner.strategy.node_configs
                           if nc.synchronizer.kind == "ps"),
            "zero3": sorted(low.zero3_shapes),
            "degraded": sorted(low.zero_degraded),
            "unapplied": sorted(low.unapplied)}


def gradient_kept(runner):
    """From a run under Adam: each tensor's elements (logical shapes)
    whose gradient is more than summation noise, the root of Adam's
    second moment above 1e-5 of its tensor's largest; and each tensor's
    peak, the largest of those roots over their mean square's root.  A
    gradient that is zero in exact arithmetic (the k projection's bias:
    a softmax does not see a shift of every score) is fp32 noise, which
    Adam scales by up to lr / eps: two summation orders draw it
    apart."""
    nu = {nm[3:]: t for nm, t in flatten_with_names(
        runner.state["opt_state"]) if nm.startswith("nu/")}
    kept, peak = {}, {}
    for nm, t in runner.lowered.full_params(nu).items():
        g = t.sqrt()
        kept[nm] = g > 1e-5 * g.max()
        k = g[kept[nm]]
        peak[nm] = float(k.max() / k.pow(2).mean().sqrt()) if k.numel() \
            else 1.0
    return kept, peak


def kept_distances(got, want, init, kept):
    """Per tensor over its ``kept`` elements: ``(max |a - b| / max |b|,
    floored at 1e-3; |a - b|_2 / |b - init|_2)``, the exact rows' and the
    narrowed rows' distances from the reference ``want``."""
    out = {}
    for n, a in got.items():
        k = kept[n]
        d = (a.float() - want[n].float())[k]
        moved = (want[n].float() - init[n].float())[k].norm()
        out[n] = (float(d.abs().max() / want[n].float().abs().max().clamp(
                      min=1e-3)) if d.numel() else 0.0,
                  float(d.norm() / moved.clamp(min=1e-30)))
    return out


def wire_allowance(wire, peak):
    """A narrowed row's distance from the SGD reference a tensor may
    take, in units of the tensor's update: the wire's unit a step (bf16
    rounds each element by half a unit at most); int8 rounds to a level
    of 1/127 of the tensor's largest gradient, so a quarter of its
    ``peak`` (largest over mean square) times that, at least one
    unit."""
    unit, _ = wire
    if unit == BF16_GRAD[0]:
        return unit * ZERO_PARITY_STEPS
    return unit * ZERO_PARITY_STEPS * max(1.0, peak / 4)


def zero_pipe_parity(job):
    """Phase 15's pipeline in one rank: 2 steps of each program; losses,
    the parameters' distances from the reference's over the elements
    with a real gradient (:func:`gradient_kept`: the plain program's
    for the exact rows, the SGD program's for the narrowed ones),
    stored bytes a variable, and K3's launches."""
    out, refs, init, kept, peak = {}, {}, None, None, None
    window = tp_window(job, ZERO_PARITY_STEPS, seed0=500)
    eps = job["opt"][1]
    for label, kw, accum, wire in job["programs"]:
        # Adam for the exact rows (ZeRO's optimizer state is what they
        # shard), SGD for the rest.
        opt = (port.optim.adam(0.0, eps=eps) if wire == NO_UPDATE
               else None if wire is None
               else port.optim.sgd(LINEAR_LR))
        runner = zero_pipe_runner(job, kw, accum, opt)
        pipe = runner.lowered.mesh.axis("pipe").index
        if init is None:
            init = dict(flatten_with_names(runner.get_params()))
        reset_launches()
        losses = runner.run_steps(window)["loss"].tolist()
        got = launches()
        params = dict(flatten_with_names(runner.get_params()))
        if label == "plain":
            kept, peak = gradient_kept(runner)
        if label in ("plain", LINEAR):
            refs[label] = params
        ref = refs["plain" if wire in (None, NO_UPDATE) else LINEAR]
        dists = kept_distances(params, ref, init, kept)
        errs = {n: e for n, (e, _) in dists.items()}
        moved = {n: m for n, (_, m) in dists.items()}
        over = ({n: m / wire_allowance(wire, peak[n])
                 for n, m in moved.items()}
                if isinstance(wire, tuple) else {"-": 0.0})
        out[label] = dict(zero_record(runner), loss=losses,
                          err=max(errs.values()),
                          worst=max(errs, key=errs.get),
                          moved=max(moved.values()),
                          moved_worst=max(moved, key=moved.get),
                          over=max(over.values()),
                          over_worst=max(over, key=over.get),
                          left_out=sum(int((~k).sum()) for k in
                                       kept.values()),
                          launches=got, pipe=pipe,
                          route=check_route(runner, job, label))
        runner.close()
        del runner, params
        torch.cuda.empty_cache()
    return out


def zero_seq_parity(job):
    """Phase 15's sequence rows in one rank: 3 steps plain and under
    ZeRO-3 with the flash ring; losses, parameter distance, bytes and
    K1/K2 launches."""
    out, ref = {}, None
    window = lm_window(job, ZERO_PARITY_STEPS, seed0=600)
    for label, kw in job["programs"]:
        runner = lm_runner(job, "flash", builder_kw=kw)
        reset_launches()
        losses = runner.run_steps(window)["loss"].tolist()
        got = launches()
        params = runner.get_params()
        ref = params if ref is None else ref
        out[label] = dict(zero_record(runner), loss=losses,
                          err=rel_err(params, ref), launches=got,
                          index=runner.lowered.mesh.axis("seq").index)
        runner.close()
        del runner, params
        torch.cuda.empty_cache()
    return out


def zero_moe_parity(job):
    """Phase 15's expert rows in one rank: 3 steps of ``a2a_ring`` plain
    and under ZeRO-1; losses, parameter distance, bytes and K8's
    launches."""
    out, ref = {}, None
    window = moe_window(job, ZERO_PARITY_STEPS, seed0=700)
    for label, kw in job["programs"]:
        runner = moe_runner(job, "a2a_ring", extra=kw)
        reset_launches()
        losses = runner.run_steps(window)["loss"].tolist()
        got = launches()
        params = runner.get_params()
        ref = params if ref is None else ref
        out[label] = dict(zero_record(runner), loss=losses,
                          err=rel_err(params, ref), launches=got)
        runner.close()
        del runner, params
        torch.cuda.empty_cache()
    return out


# A narrowed forward wire's loss at step 0, before any update, relative
# to the reference's: the readings reach 1.28e-4 (the int8 ring under
# remat; the bf16 gather 2.2e-5: PERF.md, phase 15), a broken wire's scale
# would part it by its own error.
FWD_LOSS0 = 1e-3


def held(label, res, plain, wire, fault=None):
    """Phase 13's rule against the plain program: exact wires within 1e-5
    per tensor (of its largest value, floored at 1e-3) and 1e-5 on every
    loss.  A narrowed wire (``plain`` the SGD reference) per tensor
    within :func:`wire_allowance` of the tensor's update (``|a - b|_2 /
    |b - init|_2``), its loss at step k >= 1 within ``unit x k`` of the
    gap the updates opened between the reference's loss and the
    no-update run's (``fault``), and at step 0, before any update, within
    1e-6 of the reference's loss for a gradient wire and FWD_LOSS0 for a
    forward one.  Returns the faults."""
    faults = []
    if not all(math.isfinite(x) for x in res["loss"]):
        return [f"{label}: non-finite loss {res['loss']}"]
    if wire is None:
        if not (res["err"] <= 1e-5 and all(
                abs(a - b) <= 1e-5 * abs(b)
                for a, b in zip(res["loss"], plain["loss"]))):
            faults.append(f"{label}: losses {res['loss']} vs plain "
                          f"{plain['loss']}, params {res['err']:.3g} "
                          f"relative")
        return faults
    unit, forward = wire
    if res["over"] > 1:
        faults.append(f"{label}: {res['over_worst']} {res['over']:.3g} of "
                      f"its allowance from the SGD reference")
    for k, (a, b, c) in enumerate(zip(res["loss"], plain["loss"],
                                      fault["loss"])):
        bound = (unit * k * abs(b - c) if k
                 else (FWD_LOSS0 if forward else 1e-6) * abs(b))
        if abs(a - b) > bound:
            faults.append(f"{label} step {k}: loss {a} vs plain {b}, bound "
                          f"{bound:.3g}")
    return faults


def sharded_as_promised(label, res, plain, n):
    """The fraction ZeRO promises a rank, variable by variable: a ZeRO
    variable keeps about ``1/n`` of its optimizer state, at stage 3 of
    its parameter too; a degraded one and any other keep their plain
    bytes (the vocab table's state still shards: its record names stage
    3 only)."""
    faults = []
    for nm, p in plain["params_bytes"].items():
        o = plain["opt_bytes"][nm]
        got_p, got_o = res["params_bytes"][nm], res["opt_bytes"][nm]
        slack = 4 * n * 4                   # a few padded elements
        if nm not in res["zero"] or (nm in res["degraded"]
                                     and nm != "shared/embedding"):
            ok = got_p == p and got_o == o
        else:
            ok = got_o <= o / n + slack and (
                got_p <= p / n + slack if nm in res["zero3"]
                else got_p == p)
        if not ok:
            faults.append(f"{label} {nm}: params {got_p} of {p}, optimizer "
                          f"state {got_o} of {o} bytes a rank")
    return faults


def zero_sums(res):
    return (sum(res["params_bytes"].values()),
            sum(res["opt_bytes"].values()))


def phase_zero_parity():
    """fp32 on the card: the pipelined LM at full width cut to 2 layers
    (1 at pipe 1) with every ZeRO stage, the zero_min_bytes mix, the
    narrowed gather, a compressor, the "int8" string, accumulation and
    remat, each held to the plain program of its mesh (data 2 x pipe 2;
    data 2 x model 2 with vocab_parallel); the sequence lowering's
    ZeRO-3 on seq 2 and the expert lowering's ZeRO-1 on expert 2, each
    to its plain program; the stored bytes a rank of every row.  The
    four jobs (4, 4, 2 and 2 ranks) run at once on card 0 over gloo;
    2 steps each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    counts, faults, jobs = {}, [], []
    for mesh, layout, int8 in ZERO_PIPE_MESHES:
        # Adam at lr 1e-3 as bench.py quant builds it, at eps 1e-4 as
        # phase 13 runs it: at the bench's 1e-8 Adam steps each element
        # by the whole rate wherever its gradient's sign is summation
        # noise, and accumulation's two half-batch sums drew elements
        # 2 x lr apart (2.71e-3 and 2.17e-3 of a tensor's largest value,
        # with every gradient at or below 100 x eps left out: PERF.md,
        # phase 15); at 1e-4 the step is continuous in the gradient.  The
        # elements whose gradient is summation noise are left out of
        # the parameter checks (gradient_kept).
        jobs.append(({"kind": "zero_pipe_parity", "layers": mesh["pipe"],
                      "seq": 128, "batch": 8, "dtype": torch.float32,
                      "opt": (1e-3, 1e-4), "mesh": mesh, "layout": layout,
                      "programs": zero_pipe_programs(int8, "model" in mesh)
                      + ([RING_REMAT] if layout else [])},
                     math.prod(mesh.values())))
    seq_job = {"kind": "zero_seq_parity", "layers": 2, "seq": 256,
               "max_len": 256, "batch": 4, "dtype": torch.float32,
               "opt": ("adam", 1e-4), "mesh": {"seq": SEQ},
               "programs": [("plain", {}), ("ZeRO-3", dict(zero_stage=3))]}
    moe_job = {"kind": "zero_moe_parity", "layers": 1, "seq": 128,
               "batch": 8, "capacity": 4.0, "dtype": torch.float32,
               "lr": 1e-4,
               "programs": [("plain", {}), ("ZeRO-1", dict(zero_stage=1))]}
    *pipe_ranks, seq_ranks, moe_ranks = spawn_together(
        jobs + [(seq_job, SEQ), (moe_job, EXPERT)])
    for (job, world), ranks in zip(jobs, pipe_ranks):
        mesh, programs = job["mesh"], job["programs"]
        got, plain = ranks[0], ranks[0]["plain"]
        where = f"{mesh_label(mesh)}" + (", vocab_parallel"
                                         if job["layout"] else "")
        for label, _, _, wire in programs:
            for r in ranks:
                res = r[label]
                if wire == NO_UPDATE:
                    # Every bound must reject a run that never moves: its
                    # parameters a whole update away, beyond the exact
                    # rule, and its later losses apart from both
                    # references' (so that the narrowed rows' loss bound,
                    # a part of that gap, stands above fp32 noise).
                    if not (res["err"] > 1e-5 and all(
                            abs(a - b) > 1e-4 * abs(b)
                            for ref in ("plain", LINEAR) for a, b in zip(
                                res["loss"][1:], r[ref]["loss"][1:]))):
                        faults.append(f"{where}: the no-update run is not "
                                      f"rejected ({res['err']:.3g}, losses "
                                      f"{res['loss']})")
                    continue
                ref = r["plain"] if wire is None else r[LINEAR]
                if wire != LINEAR:
                    faults += held(f"{where} {label}", res, ref,
                                   None if wire == EXACT_SGD else wire,
                                   r[NO_UPDATE])
                faults += sharded_as_promised(f"{where} {label}", res, ref,
                                              mesh["data"])
            if label == RING_REMAT[0]:
                for r in ranks:
                    res = r[label]
                    want = dict.fromkeys(KERNELS, 0)
                    want.update({k: n * ZERO_PARITY_STEPS
                                 for k, n in ring_remat_want(
                                     job["layers"] // mesh["pipe"],
                                     res["pipe"] == 0).items()})
                    if res["launches"] != want:
                        faults.append(f"{where} {label}: launches "
                                      f"{res['launches']}, expected {want}")
                for name, n in got[label]["launches"].items():
                    counts[name] = counts.get(name, 0) + n
        print(f"phase 15 fp32 {job['layers']}-layer pipelined LM, seq 128, "
              f"batch 8, {ZERO_PARITY_STEPS} Adam steps (lr 1e-3, eps 1e-4; "
              f"accumulation and the narrowed rows SGD at {LINEAR_LR}), "
              f"{where} [{world} ranks on one card, gloo, run_steps route "
              f"{plain['route']}]: plain losses {plain['loss']}; "
              f"{plain['left_out']} elements with a noise gradient left "
              f"out; "
              + "; ".join(
                  f"{label} losses {got[label]['loss']}, params "
                  f"{got[label]['err']:.2e} rel. ({got[label]['worst']}), "
                  f"{got[label]['moved']:.3e} of the update "
                  f"({got[label]['moved_worst']}), "
                  f"{got[label]['over']:.3g} of the allowance "
                  f"({got[label]['over_worst']})"
                  for label, *_ in programs if label != "plain")
              + "; stored bytes rank 0 (params, optimizer state): "
              + ", ".join(f"{label} {'%d, %d' % zero_sums(got[label])}"
                          for label, *_ in programs)
              + "; degraded: " + ", ".join(
                  f"{label} {len(got[label]['degraded'])}"
                  for label, *_ in programs if got[label]["degraded"])
              + "; unapplied: " + (", ".join(
                  f"{label} {got[label]['unapplied']}"
                  for label, *_ in programs if got[label]["unapplied"])
                  or "none"), flush=True)
    for r in seq_ranks:
        res = r["ZeRO-3"]
        faults += held("seq 2 ZeRO-3", res, r["plain"], None)
        faults += sharded_as_promised("ZeRO-3", res, r["plain"], SEQ)
        for label in ("plain", "ZeRO-3"):
            want = dict.fromkeys(KERNELS, 0)
            want.update({k: n * ZERO_PARITY_STEPS for k, n in seq_want(
                r[label]["index"], seq_job["layers"]).items()})
            if r[label]["launches"] != want:
                faults.append(f"seq 2 {label} on seq rank "
                              f"{r[label]['index']}: launches "
                              f"{r[label]['launches']}, expected {want}")
        for name, n in r["ZeRO-3"]["launches"].items():
            counts[name] = counts.get(name, 0) + n
    got = seq_ranks[0]
    print(f"phase 15 fp32 2-layer TransformerLM, global seq 256, batch 4, "
          f"{ZERO_PARITY_STEPS} Adam steps, the flash ring on seq 2 [2 ranks "
          f"on one card, gloo]: plain losses {got['plain']['loss']}, ZeRO-3 "
          f"{got['ZeRO-3']['loss']}, params {got['ZeRO-3']['err']:.2e} "
          f"rel.; stored bytes a rank (params, optimizer state) plain "
          f"{'%d, %d' % zero_sums(got['plain'])}, ZeRO-3 "
          f"{'%d, %d' % zero_sums(got['ZeRO-3'])}", flush=True)
    for r in moe_ranks:
        res = r["ZeRO-1"]
        faults += held("expert 2 ZeRO-1", res, r["plain"], None)
        faults += sharded_as_promised("ZeRO-1", res, r["plain"], EXPERT)
        if not res["degraded"]:
            faults.append("expert 2 ZeRO-1: no expert table degraded")
        want = dict.fromkeys(KERNELS, 0)
        want["a2a_ring_hop"] = (EXPERT * 2 * 2 * moe_job["layers"]
                                * ZERO_PARITY_STEPS)
        for label in ("plain", "ZeRO-1"):
            if r[label]["launches"] != want:
                faults.append(f"expert 2 {label}: launches "
                              f"{r[label]['launches']}, expected {want}")
    got = moe_ranks[0]
    for name, n in got["ZeRO-1"]["launches"].items():
        counts[name] = counts.get(name, 0) + n
    print(f"phase 15 fp32 1-layer MoE LM, seq 128, batch 8, capacity 4.0, "
          f"{ZERO_PARITY_STEPS} Adam steps, a2a_ring on expert 2 [2 ranks "
          f"on one card, gloo]: plain losses {got['plain']['loss']}, ZeRO-1 "
          f"{got['ZeRO-1']['loss']}, params {got['ZeRO-1']['err']:.2e} "
          f"rel.; stored bytes a rank (params, optimizer state) plain "
          f"{'%d, %d' % zero_sums(got['plain'])}, ZeRO-1 "
          f"{'%d, %d' % zero_sums(got['ZeRO-1'])}; degraded "
          f"{got['ZeRO-1']['degraded']}", flush=True)
    check(not faults, "phase 15: " + "; ".join(faults))
    return counts


def zero_window_rows(job):
    """Phase 16 in one rank: per row a warm window and a timed one (the
    launch counters from 0 before it); step seconds, peak memory, stored
    bytes."""
    out = {}
    for label, kw, accum in job["rows"]:
        if job["lowering"] == "pipeline":
            runner = zero_pipe_runner(job, kw, accum)
            window = runner.place_steps(tp_window(job, ZERO_WINDOW_STEPS))
        else:
            runner = lm_runner(job, "flash", builder_kw=kw)
            window = runner.place_steps(lm_window(job, ZERO_WINDOW_STEPS))
        dt, metrics = timed_window(runner, window)
        route = check_route(runner, job, label)
        if job["backend"] == "nccl":
            check((runner.captures, runner.replays) == (1, 2),
                  f"{label}: {runner.captures} captures and "
                  f"{runner.replays} replays, expected 1 and 2")
        losses = metrics["loss"].float()
        check(bool(torch.isfinite(losses).all()),
              f"{label}: non-finite loss {losses}")
        rec = zero_record(runner)
        out[label] = {"seconds": dt, "launches": launches(),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "bytes": zero_sums(rec), "route": route,
                      "loss": [float(losses[0]), float(losses[-1])]}
        if job["lowering"] == "sequence":
            index = runner.lowered.mesh.axis("seq").index
            want = dict.fromkeys(KERNELS, 0)
            want.update({k: n * ZERO_WINDOW_STEPS for k, n in seq_want(
                index, job["layers"]).items()})
            check(out[label]["launches"] == want,
                  f"{label} on seq rank {index}: launches "
                  f"{out[label]['launches']}, expected {want}")
        runner.close()
        del runner, window
        torch.cuda.empty_cache()
    return out


def phase_zero_window():
    """bf16: the pipelined LM of bench.py quant's width, 4 layers, at data
    2 x pipe 2 plain, under ZeRO-1, ZeRO-3, GradAccumulation 2 and
    remat, and the sequence window (phase 12's model, seq 2) plain and
    under ZeRO-3: step ms, peak memory a rank and stored bytes a rank,
    ZeRO-3's parameters about half the plain row's; 2-step windows, the
    sequence model cut to 2 layers.  Over gloo on card 0; over
    NCCL on the graph route, one rank a card, where there are the cards
    (4: the pipeline; 2: the sequence window)."""
    pipe_job = {"kind": "zero_window", "lowering": "pipeline",
                "layers": TP_LAYERS, "seq": TP_SEQ, "batch": TP_BATCH,
                "dtype": torch.bfloat16, "opt": (1e-3, 1e-8),
                "mesh": {"data": 2, "pipe": PIPE}, "layout": {},
                "rows": ZERO_WINDOW_ROWS}
    # The sequence rows cut phase 12's model to 2 of its 4 layers (the
    # rows run over gloo, so their depth is the lever on run time).
    seq_job = {"kind": "zero_window", "lowering": "sequence",
               "layers": 2, "seq": SEQ_LEN, "max_len": SEQ_LEN,
               "batch": SEQ_BATCH, "dtype": torch.bfloat16,
               "opt": ("adamw", 3e-4), "mesh": {"seq": SEQ},
               "rows": [("plain", {}, 1),
                        ("ZeRO-3", dict(zero_stage=3), 1)]}
    runs = [("gloo", pipe_job), ("gloo", seq_job)]
    cards = torch.cuda.device_count()
    if cards >= 4:
        runs.append(("nccl", pipe_job))
    if cards >= SEQ:
        runs.append(("nccl", seq_job))
    counts = {}
    for backend, job in runs:
        mesh = job["mesh"]
        world = math.prod(mesh.values())
        where = (f"{mesh_label(mesh)}, {world} ranks on one card, gloo, "
                 f"transfers through host" if backend == "gloo" else
                 f"{mesh_label(mesh)}, {world} ranks on {world} cards, NCCL")
        ranks = spawn_ranks(job, world, backend)
        plain = ranks[0]["plain"]["bytes"]
        for label, _, accum in job["rows"]:
            rs = [r[label] for r in ranks]
            dt = max(r["seconds"] for r in rs)
            tokens = ZERO_WINDOW_STEPS * job["batch"] * job["seq"]
            print(f"phase 16 {job['lowering']} {label} bf16 [{where}, "
                  f"{job['layers']} layers, batch {job['batch']} of "
                  f"{job['seq']} tokens, run_steps route {rs[0]['route']}]: "
                  f"{ZERO_WINDOW_STEPS} steps in {dt:.3f} s = "
                  f"{tokens / dt:.1f} tokens/s, step "
                  f"{dt / ZERO_WINDOW_STEPS * 1e3:.2f} ms, peak memory per "
                  f"rank " + ", ".join(f"{r['peak_gb']:.2f}" for r in rs)
                  + " GB, stored bytes a rank (params, optimizer state) "
                  + ", ".join(f"{r['bytes'][0]}, {r['bytes'][1]}"
                              for r in rs)
                  + f" (plain rank 0: {plain[0]}, {plain[1]}), loss "
                  f"{rs[0]['loss'][0]:.4f} -> {rs[0]['loss'][1]:.4f}",
                  flush=True)
            if label == "ZeRO-3":
                for r in ranks:
                    p3, p = r[label]["bytes"][0], r["plain"]["bytes"][0]
                    check(p3 <= 0.51 * p, f"{job['lowering']} ZeRO-3 over "
                          f"{backend}: {p3} parameter bytes a rank against "
                          f"the plain row's {p}")
            if label == "ZeRO-1":
                for r in ranks:
                    o1, o = r[label]["bytes"][1], r["plain"]["bytes"][1]
                    check(o1 <= 0.51 * o, f"pipeline ZeRO-1 over {backend}: "
                          f"{o1} optimizer bytes a rank against {o}")
            if backend == "gloo" and job["lowering"] == "sequence" \
                    and label == "ZeRO-3":
                for r in rs:
                    for name, n in r["launches"].items():
                        counts[name] = counts.get(name, 0) + n
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16",
        help="comma-separated phases to run (default: all); the kernels "
             "line needs them all")
    phases = {int(p) for p in parser.parse_args(argv).phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"card(s)", flush=True)
    record, counts = {}, {}

    def add(found):
        for name, n in found.items():
            counts[name] = counts.get(name, 0) + n

    steps = [(1, lambda: (record.update(ptxas=ptxas_registers()),
                          phase_kernels(record),
                          phase_attention_kernels(record),
                          phase_tp_kernels(record),
                          phase_a2a_kernels(record))),
             (2, phase_parity),
             (3, lambda: add(phase_serve())),
             (4, phase_training_parity),
             (5, lambda: add(phase_train())),
             (6, phase_tp_parity),
             (7, lambda: add(phase_tp_window())),
             (8, phase_moe_parity),
             (9, lambda: add(phase_moe_window())),
             (10, lambda: add(phase_tp_serve())),
             (11, phase_seq_parity),
             (12, lambda: add(phase_seq_window())),
             (13, phase_zoo_parity),
             (14, lambda: add(phase_zoo_window())),
             (15, lambda: add(phase_zero_parity())),
             (16, lambda: add(phase_zero_window()))]
    for phase, run in steps:
        if phase in phases:
            t1 = time.perf_counter()
            run()
            print(f"phase {phase} took {time.perf_counter() - t1:.1f} s, "
                  f"done at {time.perf_counter() - t0:.1f} s", flush=True)
    if phases >= {phase for phase, _ in steps}:
        kernels = []
        for name, k in KERNELS.items():
            # K3 and K8 work on int8 levels and fp32 values: their one
            # record is fp32.
            dtype = (torch.bfloat16 if (name, torch.bfloat16) in record
                     else torch.float32)
            rec = record[(name, dtype)]
            kernels.append({
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": counts[name],
                "max_abs_err": rec["max_abs_err"],
                "max_abs_err_fp32": record[(name, torch.float32)][
                    "max_abs_err"],
                "ms": rec["ms"], "kernel_ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "dtype": str(dtype)[6:]})
            if "copy_ms" in rec:                 # K3, K8
                kernels[-1]["copy_ms"] = rec["copy_ms"]
            if (name, dtype, 512) in record:     # K4's out projection
                kernels[-1]["k512"] = record[(name, dtype, 512)]
            kernels[-1].update(record["ptxas"].get(name, {}))
            if (name, dtype, "serve_mix") in record:     # K5-K7
                for label in ("serve_mix", "one_slot", "tp2"):
                    kernels[-1][label] = record[(name, dtype, label)]
                kernels[-1]["ptxas_fp32"] = record["ptxas"][f"{name} fp32"]
            if f"{name} cuda_core" in counts:            # K7
                kernels[-1]["cuda_core_launches"] = counts[f"{name} cuda_core"]
            if name in PAIR:
                kernels[-1]["library"] = (
                    "SDPA's autograd backward (dq, dk, dv), shared by "
                    "K2a and K2b: compare the pair")
                kernels[-1]["pair"] = record[("K2 pair", dtype)]
            if name in TRAINING_KERNELS:                  # K1, K2a, K2b
                for label in ("ring_chunk", "ring_chunk_causal"):
                    kernels[-1][label] = dict(
                        record[(name, dtype, label)],
                        pair=record[("K2 pair", dtype, label)])
        print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

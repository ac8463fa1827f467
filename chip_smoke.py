#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gan_ffn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. device   -- the card's name and power limit (nvidia-smi) and torch's view.
2. build    -- nvcc builds every kernel under gan_ffn_tpu_torch/csrc
               (attention_fwd, attention_bwd, mlp_fwd, mlp_bwd, their bf16
               twins attention_fwd_bf16, attention_bwd_bf16, mlp_fwd_bf16,
               mlp_bwd_bf16, the GRU gates gru_gates, the grouped SwiGLU
               experts moe_ffn and the trace stamp trace_stamp), one
               process each, all at once;
               prints each library's nvcc seconds and each kernel's
               registers and spill bytes; fails if a variant of the bf16
               attention kernels spills or takes more than 128 registers,
               or one of the bf16 MLP kernels spills.
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the training paths' shapes (L=112 bucket; B=32 on the
               flagship path, B=30 on the DialogueRNN path): attention
               (B,10,112,10) and (B,8,112,64) at valid_len 112/90/1/0, and
               the ragged (4,2,17,33) at rate 0.1 for correctness only; MLP
               at M=3584 and M=3360 rows (the latter with a partial last
               64-row tile) for the four K->H->N geometries.  Each at
               dropout rate 0 and at the path's rate (attention 0.1, encoder
               FFN mid 0.1, generator head pre/mid/post 0.2): the kernels
               draw the plain versions' Philox masks, so the outputs are
               compared element by element.  Forward: attention max |diff|
               <= 1e-5, MLP <= 1e-4 * max(1, max |ref|).  Backward (against
               autograd of the plain version): <= 1e-4 * max(1, max |ref|)
               per gradient, and two calls of either kernel give identical
               bits.  The forward and the backward take the same branches of
               relu' at inputs built to put z1 within 1e-6 of 0 (K = 100 and
               512, M = 1, 3360 and 3584; mlp_relu_branches).  The kernels' keep
               fraction is within 5 sigma of 1 - rate.
               Times: CUDA events around 10 back-to-back calls queued behind
               a device sleep (so host launch cost is hidden), median of 21,
               L2-warm (the MLP backward: 5 calls, median of 11, at both
               rates, beside its workspace bytes and split launches);
               plain_ms for the plain version (autograd of it for
               a backward); library_ms for F.scaled_dot_product_attention's
               forward and backward (attention only; the port never calls
               it).  bound_ms = max(bytes / 3.35 TB/s, flops / 165 TFLOP/s),
               each input read once and each output written once: 165 is
               the H100 SXM data sheet's 495 TFLOP/s TF32 over the three
               TF32 products that give one f32-accurate product (3xTF32),
               the card's fastest f32-accurate rate.
               The GRU gate kernels (ops/gru.py) against the chain of torch
               ops they replace, at the DialogueRNN scan's three cells (B=30,
               X=2: g gi (2,30,1500) h (2,30,500); p gi (2,30,1,1500) h
               (2,30,2,500); e gi (2,30,300) h (2,30,100)), f32 and bf16:
               h', and dgi, dgh, dh through autograd and by
               gru_gates_backward alone, each the chain's bits.  Times as
               above: each kernel alone, the chain's forward, and forward
               plus backward of either through autograd; bound_ms from the
               bytes alone.
3b. moe     -- the grouped SwiGLU expert kernels (ops/moe.py, csrc/moe_ffn.cu)
               against the per-expert loop (ops.moe.grouped_swiglu_plain,
               cuBLAS f32) at Moonlight-16B-A3B's widths, hidden 2048, over
               one stage-A batch's 3,584 rows: the routed experts (64 of
               1,408, 3,520 rows routed to 6 each, weighted), the shared
               experts (one group of 2,816) and the dense layer (one group
               of 11,264).  y, dx, the three weight gradients and the
               routing weight's within 2e-5 of max |ref| (the limit of
               tests/test_torch_moe_cuda.py), two calls identical in bits,
               one forward and one backward call counted a call.  Times as
               above (11 groups of 5 calls): the forward, forward plus
               backward through autograd, and the loop's forward; bound_ms
               summed over the call's kernels, each reading every expert's
               weights and its rows once.  Then one stage-A step with the
               Moonlight text generator (GANConfig(text_generator=
               "moonlight"): the published widths at 5 of 27 layers) at
               B=32, L=112, valid_len 110, every dropout on, eager:
               exactly 208 / 176 / 220 / 182 attention_fwd / attention_bwd /
               mlp_fwd / mlp_bwd calls and 36 forward and 18 backward
               grouped_swiglu calls (9 a text-generator pass: the dense
               layer and 4 routed and 4 shared) in each of 2 steps, finite
               losses, every MoE layer's 3,520 rows routed with 6 x 3,520
               expert loads (dropless), host ms and the peak memory.
4. serving  -- a full-width 8-layer GAN_FFN (random weights from a fixed
               seed) exported and loaded by ServingClassifier on the card,
               answering HTTP POST /predict requests through the cli/serve.py
               handler and direct log_probs calls; every forward must launch
               the attention kernel 24 times and the MLP kernel 27 times; card
               log-probs agree with the CPU path (plain versions) within 1e-3.
               Prints ms/request and utterances/s at L=112, B=32, and the
               forward's device time (CUDA events, launches hidden) beside
               its host time with the inputs on the card.
5. training -- cli/train_iemocap.main runs the published pipeline at full
               width (8 layers) on a synthetic fixture whose batches fill
               the 112 bucket (B=32), with every dropout on: 1 epoch of
               stage A (the 12-duel adversarial pre-training of the three
               generators against the three discriminators), the six
               networks saved, the generators grafted into GAN_FFN, then 2
               epochs of stage B.  Checks: a 1-row GAN_loss.csv of finite
               losses, the six msgpack checkpoints (the JAX package's
               format) and their opt/ files, finite
               stage-B losses, a report file, and exactly 240 / 192 / 252 /
               198 attention_fwd / attention_bwd / mlp_fwd / mlp_bwd calls
               per stage-A step plus 24 + 24 attention and 27 + 27 MLP
               calls (forward + backward) per stage-B train step.  Then one
               stage-A step at B=32, L=112, every dropout on (gan_step:
               launches, host and enqueue ms, duel-utterances/s, peak
               memory), and one deterministic 12-duel step on the card
               against the same step on the CPU from the same weights and
               batch (gan_step_vs_cpu: depth 8, L=64, B=4, Adam eps 1e-3;
               the 12 losses within 1e-3 relative, every parameter after
               the step within 1e-5 absolute).  Then one stage-B train step
               at B=32, L=112 is timed (device ms
               by CUDA events with the launches queued behind a device
               sleep; host ms to the end of a synchronize; utterances/s),
               with each kernel's share of the step's device time.  Last,
               one deterministic step on the card against the same step on
               the CPU (plain versions) from the same weights and batch
               (L=64, B=4): loss and every parameter's gradient within max
               |diff| <= 1e-3 * max(1, max |ref|).
6. dialoguernn -- cli/train_iemocap_dialoguernn.main at full width (8-layer
               generators, D_g = D_p = 500, context attention general,
               every dropout on) for 2 epochs on phase 5's fixture at B=30
               (L=112 batches, the test loader's last with 1 real
               dialogue), loading the six networks phase 5 saved.  Checks:
               finite losses, the checkpoint, the best epoch's attention
               weights of shape (112, n_real, 112) per test batch, and
               exactly 24 + 24 attention and 27 + 27 MLP calls per train
               step and 24 + 27 per eval forward, and 3 * 112 GRU gate
               forward calls per train step or eval forward and 3 * 112 - 1
               backward per train step.  Then one train step at
               B=30, L=112 with every dropout on (dialoguernn_step: launches,
               host and enqueue ms, utterances/s, peak memory), and one
               deterministic step on the card against the CPU from the same
               weights and batch (dialoguernn_step_vs_cpu: depth 8, L=64,
               B=4 with a fully padded column): loss and every gradient
               within max |diff| <= 1e-3 * max(1, max |ref|).  Both
               step-vs-CPU steps also hold every gradient to its own scale,
               max |diff| <= 0.25 * max |ref| (a wrong or zeroed gradient
               would be O(1); relu' branch flips move a relu FFN's W1 and b1
               gradients by a few percent), and print the worst gradient's
               max |ref|.
7. graphs   -- the epoch-fused path (--epoch-fused): one CUDA graph per batch
               shape (train/graphs.py).  Both trainers with --epoch-fused at
               full width on a fixture whose batches are of L = 96 and 112 in
               every train epoch, every dropout on: the flagship 1 stage-A
               epoch and 2 stage-B epochs, the DialogueRNN 2 epochs with the
               0.98**e lr decay, loading the six networks; the checks of
               phases 5 and 6, and one graph per length in each train
               dispatcher, replayed.  Each run is traced by torch.profiler
               (device only) with the counts set to 0 just before it and
               read just after: every batch is its shape's eager first batch
               or a replay, the wrappers count the eager ones (a call that a
               graph records launches nothing), and the profiler's kernels
               by name count (eager first batches + replays) x 240 / 192 /
               252 / 198 per stage-A step, x 24 / 24 / 27 / 27 per train
               step and x 24 / 27 forward calls per eval forward.  Then
               attention and MLP calls, forward and backward, with dropout,
               captured once at valid_len 112 and replayed at valid_len 90,
               1 and 0 and three seed bases, each replay held to its plain
               version at that valid_len and seed under phase 3's limits.
               Then each step (stage A and stage B at B=32, the DialogueRNN
               at B=30, L=112, depth 8) with every dropout on, eager and
               graphed: the profiler's launches per replay (kernels by name,
               the GRU gate kernels' too: 3 * 112 and 3 * 112 - 1 in the
               DialogueRNN step, none in the others;
               a replay, and the eager step, is traced up to 3 times, since
               the tracer can lose records of a burst but never adds one)
               equal to the eager step's and to the wrappers' counts, host
               ms per step (eager against graphed; the graphed stage A and
               DialogueRNN must be faster), the device's busy ms in one
               replay, the capture seconds and the graph pool's bytes.
               Last, each step deterministic for 3 steps from the same
               weights and batches, the lr scaled by 1, 0.5, 0.25 between
               them, eager and graphed: with the same capturable Adams at
               eps 1e-8 the same bits; against the per-batch path's plain
               Adams at eps 1e-3, losses and every parameter within 1e-6 *
               max(1, max |ref|).

8. bf16_serving -- the bf16 forward kernels and the serving variants.
               Each bf16 kernel against its plain version (which rounds
               where the JAX kernel does) at the serving shapes: attention
               (32,10,112,10) and (32,8,112,64) at valid_len 112/90/1/0 (and
               at the DialogueRNN path's (30,10,112,10), (30,8,112,64)), MLP
               at M=3584 and the DialogueRNN path's 3360 for the four
               geometries (phase 3's inputs rounded to bf16), each at rate 0 and the path's rate: max |diff| <=
               2^-8 * max(1, max |ref|), at least 99% of the outputs
               identical (+0 and -0 as one), two calls identical in bits.  Times as in phase 3
               (rate 0 rows make the kernels line) beside the f32 kernel's
               on the same values, the plain version's and, for attention,
               SDPA's bf16 forward; bound_ms = max(bytes / 3.35 TB/s, flops
               / 989 TFLOP/s), 2-byte elements, 989 the H100 SXM data
               sheet's dense bf16 rate; for the MLP also its TFLOP/s on
               the f64 tensor cores it multiplies on (f64_tflops) and their
               floor, the exact work at 67 TFLOP/s (f64_floor_ms).  Then
               phase 4's 8-layer model
               exported as f32, bf16 and bf16 with int8 weights (bytes of
               each), each served on the card with 24 attention and 27 MLP
               launches per forward by its own kernels (bf16 kernels for
               both bf16 artifacts, no f32 one): the bf16 artifact within
               5e-2 of the same artifact on the CPU (L=64, B=4), the int8
               one within 1e-3 of the live bf16 model with its dequantized
               weights (L=112, B=32); ms per request and utterances/s at
               L=112, B=32 for the three, and argmax agreement against f32
               (no limit: random weights).  Last, cli/predict.py on phase
               5's checkpoint and test split: its F1 equals phase 5's
               best-epoch test F1; then --bf16, its F1 beside.

9. bf16_training -- the bf16 backward kernels and both trainers' --bf16.
               Each bf16 backward kernel against its plain version (which
               rounds where the JAX kernel does) at every path shape:
               attention (B,10,112,10) and (B,8,112,64) at B=32 and 30,
               valid_len 112/90/1/0; MLP at M=3584 and 3360 for the four
               geometries; each at rate 0 and the path's rate, under phase
               8's limits, every output of each call (two calls identical in
               bits).  Times as in phase 3 at the path's rates (and rate 0
               at B=32) beside the f32 kernel on the same values, the plain
               version and, for attention, SDPA's bf16 backward; bound_ms
               at 989 TFLOP/s and 2-byte elements; for the MLP also
               f64_tflops and f64_floor_ms as in phase 8.  The bf16 kernels
               take the same relu branches (mlp_relu_branches_bf16: no column of
               db1 may differ, over 786,432 z1 near the kink at H=512 and
               196,608 at each of M=3584 and 3360 for K=100 and 512 at
               H=2048, where the two kernels' d_ff splits differ).  One stage-B and one
               stage-A step at B=32, L=112, depth 8, every dropout on, bf16
               and f32 in turns: the bf16 twins at 24 / 24 / 27 / 27 and 240
               / 192 / 252 / 198 launches per step and no f32 kernel, host
               ms and the device's busy ms (torch.profiler).  Then the
               flagship trainer with --bf16 at full width on phase 5's
               fixture (1 stage-A and 1 stage-B epoch), per batch and with
               --epoch-fused (traced by torch.profiler: wrappers count the
               eager first batches, the profiler every batch), and the
               DialogueRNN trainer with --bf16 (B=30, 1 epoch, loading the
               bf16 run's networks): the bf16 kernels at the f32 counts and
               no f32 kernel in each run, f32 checkpoints.  Last, one
               deterministic bf16 flagship step (depth 8, L=64, B=4) on the
               card against the CPU's: loss within 1e-2 relative and every
               gradient within 5e-2 * max(1, max |ref|) (the CPU tests'
               limits against JAX) and 0.25 of its own max |ref|.

10. families -- serving of the other two classifier families, and the MELD
               trainer.  Path 1: phase 6's DialogueRNN checkpoint (8-layer
               generators, D_g = D_p = 500, 2 parties) exported by
               cli/export.py --model dialoguernn --verify --device cuda as
               f32, bf16 and bf16+int8 (bytes of each), each served on the
               card through ServingClassifier and the HTTP handler at (L=112,
               B=30) and an off-grid (L=50, B=7), ragged umask: every
               forward launches attention_fwd 24 and mlp_fwd 27 times (f32)
               or their bf16 twins at those counts and no f32 kernel (bf16,
               bf16+int8); log-probs against the same artifact on the CPU
               within 1e-3 (bf16 5e-2); request ms at L=112, B=30 (median of
               20) and the device's busy ms of one request (torch.profiler).
               Path 2: cli/train_meld.py at its published widths (D_m 600,
               D_e 300, 4-layer BiLSTM) at B=32 on a fixture whose batches
               reach the 33 bucket: 10 epochs per batch, 1 with
               --epoch-fused (traced by torch.profiler: no kernel of the
               port by name), 1 with --bf16; finite train and test losses,
               NaN valid metrics (valid 0.0), a float32 checkpoint, and none
               of the eight kernels launched.  One deterministic MELD train
               step (L=33, B=4, a fully padded column) on the card against
               the CPU's, f32 (loss 1e-3 relative, gradients 1e-3 of max(1,
               max |ref|), 0.25 of their own) and bf16 (1e-2, 5e-2, 0.25).
               The per-batch run's checkpoint exported in the three variants
               (--verify on the card) and served with warmup(lengths=(16,
               33)) at exact lengths (33, 30) and (7, 3): no kernel, the CPU
               limits above, request ms at L=33, B=30.

11. sweeps -- the GAN-epoch sweep, the multi-seed sweep and --dp, at full
               width on phase 5's fixture (B=32, L=112) and networks.
               cli/sweep.py --gan-epochs 1 3 1 --epochs 2 with --epoch-fused
               AUTO (one bucket: fused), traced whole by torch.profiler:
               every batch its shape's eager first batch or a replay, the
               wrappers counting the eager ones and the profiler every one
               (stage-A steps x 240 / 192 / 252 / 198 plus the points'
               train steps x 24 / 24 / 27 / 27 and eval forwards x 24 / 27);
               three reports, a 3-row GAN_loss.csv, device memory after each
               point within 16 MB of the first's; snapshot 2's generators
               equal to one uninterrupted 2-epoch stage A on the card in
               bits, snapshot 1 unequal to snapshot 3; stage A's and each
               point's seconds.  cli/seed_sweep.py --seeds 0 1 --epochs 2
               --use-trained-GAN from phase 5's GAN_save/, then each seed
               alone: each seed's best test loss and F1 equal to its run
               alone in bits, the two seeds' unequal, the launches of every
               train step and eval forward, host seconds per epoch.
               cli/train_iemocap.py --dp under python -m
               torch.distributed.run --standalone --nproc-per-node 1 (the
               rank runs ``chip_smoke.py --dp-rank ARGS``, which calls the
               trainer's main with the counts set to 0 before and printed
               after): an NCCL group of world size 1 on cuda:0, the JAX
               trainer's single-chip message, the launches of its stage A
               and stage B, and its stage-A loss rows and six networks equal
               to phase 5's run without --dp in bits.  One card: cross-card
               equivalence is not shown here (the CPU tests hold two gloo
               ranks to one process and to the JAX mesh).  Last, one stage-A
               step without a group and with an NCCL group of one (this
               process), in turns: launches, host ms, busy ms.

12. checkpoints -- the JAX-format checkpoints, --tensorboard, --profile and
               the data-parallel epoch-fused stage A.  Phase 5's six
               networks with their Adams and best classifier, and phase 6's
               best DialogueRNN classifier (msgpack, the JAX package's
               format) load strictly into fresh full-width modules through
               the port's reader, and the port's writer gives each file's
               bytes back; a live full-width stage A after one step on the
               card and a live 8-layer GAN_FFN are written and read back
               equal in bits (parameters, Adam moments and steps), with the
               host seconds of the six networks' write and read.  Then
               cli/train_iemocap.py --use-trained-GAN
               --continue-train-GAN-step 0 --tensorboard --profile DIR
               --epochs 2 at full width from a copy of phase 5's files: the
               wrappers' launches (24 / 24 / 27 / 27 per train step and, with
               a TBWriter that writes, per epoch's sampled gradients; 24 / 27
               per eval forward), the profiled epoch 1's four kernels by name
               per train step, exactly 24 / 24 / 27 / 27, and every launch
               of the trace with its kernel's record except in the trace's
               warm-up (utils/profiling.py: the tracer can lose the records
               of a session's first launches, which the warm-up takes; how
               many it lost is printed), whether the TBWriter wrote (it is a
               no-op without the tensorboard package) and its event file;
               cli/predict.py on the run's classifier_best.msgpack gives its
               best-epoch F1.  Last, make_gan_epoch_step(dp=<an NCCL group of
               one>) for 3 graphed deterministic steps at depth 8 (the lr
               scaled between them) against the per-batch DP step with the
               same capturable Adams: NCCL's all-reduce captured in the
               stage-A graph, the same bits.

13. library -- the modules that no entry point runs, the graft entry, the
               dry run and the reference import.  Each library-only model
               (GRU, Attention with the mlp and bi_linear scores,
               BiE2EModel, LSTMModel2, LSTMModel, CNN, TextCNN,
               FullyConnection, Emoformer, CNNFeatureExtractor,
               E2ELSTMModel; Emoformer and LSTMModel at the published
               widths, text and audio 100, visual 512; L=32, B=8, a ragged
               umask) runs one deterministic forward and backward on the
               card and on the CPU from the same weights: the output, the
               loss and every gradient within phase 6's limits, and no
               kernel of the port launched (none has a Pallas kernel behind
               it).  graft_entry.entry() on the card (8-layer GAN_FFN, L=112,
               B=32, valid_len 110) against entry("cpu") within 1e-3, 24
               attention_fwd and 27 mlp_fwd launches a call, host ms.
               graft_entry.dryrun_multichip over every visible card (NCCL):
               the classifier, stage A per batch and epoch-fused (graphed),
               BiModel, the seed sweep and the (seed, data) grid, each
               within the JAX dry run's bounds of one process, the deltas
               printed.  Six reference-shaped stage-A networks
               (tests/reference_gan_model.py, 8 layers) pickled whole as the
               reference saves them, imported by cli/import_reference.py,
               and the flagship trainer run one stage-B epoch from them
               with --use-trained-GAN --continue-train-GAN-step 0: 24 / 24 /
               27 / 27 launches per train
               step, 24 / 27 per eval forward.

The kernel counts are set to 0 just before the serving, the training, the
DialogueRNN, the two epoch-fused, the bf16 serving, the bf16 trainers', the
families' paths (each request and each MELD run), phase 11's runs,
phase 12's trainer run and phase 13's library models, entry() call and
trainer run, and are read just after; the comparisons of
phases 3, 8 and 9 do not count.  The
kernels read ``valid_len`` and their dropout seed from device memory;
phases 3 and 8 time them so, with both made once beforehand.  A ``graphs``
line sums up phase 7.  The line before the last is the ``kernels`` summary (times
per stage-B train step at B=32, L=112, at the path's dropout rates, the same
sums at the DialogueRNN step's B=30 shapes, and each kernel's launches per
stage-A step and per DialogueRNN train step; the bf16 forwards' per bf16
serving forward and, for attention_fwd_bf16, per bf16 train step too, the
bf16 backwards' per bf16 stage-B train step; the four forward kernels'
launches per DialogueRNN-family serving forward of phase 10, per phase 11
run and in phase 12's trainer run, with phase 12's profiled calls per
train step; the GRU gate kernels' launches and summed times per
DialogueRNN train step and their launches in the bf16 DialogueRNN run and
per DialogueRNN-family serving forward; the grouped SwiGLU expert
kernels' forward and backward calls per Moonlight stage-A step with their
summed times and bounds at phase 3b's shapes; every kernel's registers and
spill bytes by variant); the last line is ``{"ok": true, "device": {...}}``.  The
GRU gate kernels' launches are also checked in phase 9's bf16 trainers (the
DialogueRNN's both kernels, the flagship's none), phase 10's
DialogueRNN-family forwards (3 a time step of the forward's length, no
backward) and phase 13's GRU and BiE2EModel (both kernels).
"""

from __future__ import annotations

import ast
import contextlib
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_ACCURATE_FLOPS = 495e12 / 3  # H100 SXM TF32 tensor cores, 3 products per f32 (3xTF32)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ATTN_TOL = 1e-5
GRAD_TOL = 1e-4  # relative to max(1, max |ref|)
MLP_TOL = 1e-4
E2E_TOL = 1e-3
GRID = (1, 4, 8, 32)
ATTN_RATE = 0.1
# (B, H, L, Dh) -> attention launches per forward (and per backward) at L=112:
# B=32 on the flagship path, B=30 on the DialogueRNN path
ATTN_SHAPES = {(32, 10, 112, 10): 16, (32, 8, 112, 64): 8}
DRNN_ATTN_SHAPES = {(30, 10, 112, 10): 16, (30, 8, 112, 64): 8}
RAGGED_ATTN_SHAPE = (4, 2, 17, 33)  # L, Dh off the 16-row tiles and the head widths
# (K, H, N, site) -> MLP launches per forward (and per backward) at M = 112 * B rows
MLP_SHAPES = {
    (100, 2048, 100, "ffn"): 16,
    (512, 2048, 512, "ffn"): 8,
    (100, 512, 100, "head"): 2,
    (512, 1024, 100, "head"): 1,
}
MLP_ROWS = 112 * 32
DRNN_MLP_ROWS = 112 * 30  # 52.5 tiles of 64 rows: a partial last tile
SITE_RATE = {"ffn": 0.1, "head": 0.2}
# Where a kernel is held against its plain version: the kernels compute z1
# on the tensor cores (3xTF32), the plain version with cuBLAS in f32, sums in
# two orders up to a few 1e-6 apart.  Where z1 lies that close to relu's kink
# the two take different branches of relu' and their gradients differ by
# O(1) there, so those comparisons draw FFN inputs that keep every z1 at
# least RELU_KINK = 2e-5 from 0 (mlp_inputs).  The kernels agree with each
# other there: both compute z1 through the same tile code, which
# mlp_relu_branches checks at inputs built to lie on the kink.
STEP_LAUNCHES = {"attention_fwd": 24, "attention_bwd": 24, "mlp_fwd": 27, "mlp_bwd": 27}
# The GRU gate kernels (ops/gru.py): the DialogueRNN scan runs its g, p and e
# cells once a time step, so 3 * 112 forward launches a train step or eval
# forward at L=112, and 3 * 112 - 1 backward (the last step's g feeds only the
# history, which nothing reads after it, so autograd runs no backward for it)
GRU_SOURCE = "gan_ffn_tpu_torch/csrc/gru_gates.cu"
GRU_STEP_LAUNCHES = {"gru_fwd": 3 * 112, "gru_bwd": 3 * 112 - 1}
# cell -> (gi shape, h shape) of the DialogueRNN scan at B=30, both directions
# batched (X=2); the party cell's input is broadcast over its 2 parties
GRU_CELLS = {
    "g_cell": ((2, 30, 1500), (2, 30, 500)),
    "p_cell": ((2, 30, 1, 1500), (2, 30, 2, 500)),
    "e_cell": ((2, 30, 300), (2, 30, 100)),
}
# The grouped SwiGLU expert kernels (ops/moe.py) at Moonlight-16B-A3B's
# widths (models/moonlight.py): kind -> (groups, width).  The routed
# experts take MOE_ROUTED_ROWS of a batch's MOE_ROWS rows (L=112, B=32; the
# duel mask's at valid_len 110, n_real 32), each to MOE_TOP_K of them; the
# shared experts (one group) and the dense layer run over every row.
MOE_SOURCE = "gan_ffn_tpu_torch/csrc/moe_ffn.cu"
MOE_HIDDEN, MOE_ROWS, MOE_ROUTED_ROWS, MOE_TOP_K = 2048, 112 * 32, 110 * 32, 6
MOE_GROUPS = {"routed": (64, 1408), "shared": (1, 2816), "dense": (1, 11264)}
MOE_CALLS_PER_PASS = {"routed": 4, "shared": 4, "dense": 1}  # a dense layer, 4 MoE layers
MOE_TOL = 2e-5  # of max |ref|: tests/test_torch_moe_cuda.py's limit, and its reason
# fwd / bwd: the grouped forward kernels (gate-up with the SwiGLU epilogue,
# down) and backward kernels of a call
MOE_KERNELS = {"fwd": ("grouped_gate_up_kernel", "grouped_down_kernel"),
               "bwd": ("grouped_swiglu_bwd_kernel", "grouped_dw_sum_kernel",
                       "grouped_dx_kernel", "grouped_wgrad_kernel")}
# One stage-A step with the Moonlight text generator: GAN_STEP_LAUNCHES less
# the text encoder's 8 attention and 8 FFN launches in each of its 4 forward
# and 2 backward passes, and 9 grouped_swiglu calls a pass
MOONLIGHT_STEP_LAUNCHES = {"attention_fwd": 208, "attention_bwd": 176, "mlp_fwd": 220,
                           "mlp_bwd": 182, "moe_fwd": 36, "moe_bwd": 18}
# One stage-A step: an encoder pass launches 8 attention and 8 FFN kernels, a
# generator's head one more MLP; a disc duel runs 3 forward and 2 backward
# passes (discriminator, generator, discriminator), a gen duel 2 and 2.
GAN_STEP_LAUNCHES = {"attention_fwd": 240, "attention_bwd": 192, "mlp_fwd": 252, "mlp_bwd": 198}
GAN_PARAM_TOL = 1e-5  # absolute, on every parameter after one deterministic 12-duel step
# max |diff| / max |ref| of each gradient of a card-vs-CPU step: a wrong or
# zeroed gradient shows as O(1).  Not tighter: a relu FFN's W1 and b1
# gradients move by a few percent of their scale where the card's and the
# CPU's z1 fall on either side of relu's kink (see RELU_KINK).
OWN_SCALE_TOL = 0.25
SOURCES = {
    "attention_fwd": ("gan_ffn_tpu_torch/csrc/attention_fwd.cu", "gan_ffn_tpu/ops/attention.py:69"),
    "attention_bwd": ("gan_ffn_tpu_torch/csrc/attention_bwd.cu", "gan_ffn_tpu/ops/attention.py:86"),
    "mlp_fwd": ("gan_ffn_tpu_torch/csrc/mlp_fwd.cu", "gan_ffn_tpu/ops/mlp.py:134"),
    "mlp_bwd": ("gan_ffn_tpu_torch/csrc/mlp_bwd.cu", "gan_ffn_tpu/ops/mlp.py:162"),
}
# Phase 8: the bf16 forward kernels of the same TPU kernels at bf16 operands
BF16_SOURCES = {
    "attention_fwd_bf16": ("gan_ffn_tpu_torch/csrc/attention_fwd_bf16.cu",
                           "gan_ffn_tpu/ops/attention.py:69"),
    "mlp_fwd_bf16": ("gan_ffn_tpu_torch/csrc/mlp_fwd_bf16.cu", "gan_ffn_tpu/ops/mlp.py:134"),
}
# Phase 9: the bf16 backward kernels of the same TPU kernels at bf16 operands
BF16_TRAIN_SOURCES = {
    "attention_bwd_bf16": ("gan_ffn_tpu_torch/csrc/attention_bwd_bf16.cu",
                           "gan_ffn_tpu/ops/attention.py:86"),
    "mlp_bwd_bf16": ("gan_ffn_tpu_torch/csrc/mlp_bwd_bf16.cu", "gan_ffn_tpu/ops/mlp.py:162"),
}
# each f32 kernel's bf16 twin: a bf16 training step runs the twins at the f32 counts
BF16_TWIN = {"attention_fwd": "attention_fwd_bf16", "attention_bwd": "attention_bwd_bf16",
             "mlp_fwd": "mlp_fwd_bf16", "mlp_bwd": "mlp_bwd_bf16"}
# a bf16 train step on the card against the CPU's: the CPU tests' limits
# (tests/test_torch_bf16_train.py): loss relative, every gradient of max(1, max |ref|)
BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL = 1e-2, 5e-2
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
# a bf16 kernel against its plain version: max |diff| <= BF16_TOL * max(1, max |ref|)
# (bf16's unit roundoff) with at least BF16_SAME of the outputs identical (+0 and -0
# as one value: a dropped weight's zero products carry either sign)
BF16_TOL, BF16_SAME = 2.0 ** -8, 0.99
BF16_E2E_TOL = 5e-2  # bf16 artifact on the card against the CPU (gan_ffn_tpu/cli/export.py --verify)
# the bf16 attention kernels' registers a thread, without spills: at most 128
# (14 warps a block at L = 112); the forward's variants up to L = 112 take 72,
# two blocks an SM (csrc/attention_fwd_bf16.cu)
ATTN_BF16_MAX_REGISTERS = 128
# the bf16 MLP kernels multiply on the f64 tensor cores (csrc/mlp_bf16_tile.cuh):
# 67 TFLOP/s on the H100 SXM, dense; their TFLOP/s and floor (exact work / 67)
# beside the bf16 bound
PEAK_F64_TENSOR_FLOPS = 67e12
INT8_TOL = 1e-3  # int8 artifact against its dequantized live model


def site_cfg(site: str, rate: float) -> dict:
    if site == "ffn":
        return dict(mid=("relu", "act_first", rate))
    return dict(pre=("gelu", rate), mid=("gelu", "drop_first", rate),
                post=("gelu", "drop_first", rate))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_time_ms(torch, fn, reps: int = 21, group: int = 10, sleep_ms: float = 10.0) -> float:
    """Median device ms of one ``fn()`` call: events around ``group`` calls
    queued behind a device sleep of about ``sleep_ms``, so that host launch
    cost stays hidden."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * 2_000_000))  # ~2e6 cycles per ms
        start.record()
        for _ in range(group):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / group)
    return statistics.median(samples)


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_F32_ACCURATE_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card to run on")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    info = {
        "phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "capability": list(torch.cuda.get_device_capability(0)),
    }
    emit(info)
    return info


def phase_build():
    from gan_ffn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    secs = time.perf_counter() - t0
    want = (set(SOURCES) | set(BF16_SOURCES) | set(BF16_TRAIN_SOURCES)
            | {"trace_stamp", "gru_gates", "moe_ffn"})
    if set(libs) != want:
        fail(f"expected the kernels {sorted(want)}, built {sorted(libs)}")
    resources = {name: [{"kernel": r["kernel"], "registers": r.get("registers"),
                         "spill_stores": r.get("spill_stores"), "spill_loads": r.get("spill_loads")}
                        for r in _build.ptxas_resources(log)]
                 for name, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": secs, "libraries": {k: str(v.relative_to(REPO)) for k, v in libs.items()},
          "nvcc_seconds": dict(_build.build_seconds), "kernels": resources})
    for name in ("attention_fwd_bf16", "attention_bwd_bf16", "mlp_fwd_bf16", "mlp_bwd_bf16"):
        variants = resources.get(name, [])
        if not variants:
            fail(f"no ptxas resources for {name} (build/kernels holds its library without its .log)")
        limit = ATTN_BF16_MAX_REGISTERS if name.startswith("attention") else 255
        for r in variants:
            if (r["registers"] or 0) > limit or r["spill_stores"] or r["spill_loads"]:
                fail(f"{name}: {r}: more than {limit} registers or spills")
    return resources


class Rows:
    """Per-kernel timing rows: ``step`` at the training path's rates (one
    flagship train step, B=32), ``drnn`` the same for one DialogueRNN train
    step (B=30), ``serve`` at rate 0 (one serving forward, B=32)."""

    def __init__(self):
        self.step = {name: [] for name in SOURCES}
        self.drnn = {name: [] for name in SOURCES}
        self.serve = {"attention_fwd": [], "mlp_fwd": []}
        self.err = {name: 0.0 for name in SOURCES}

    def path(self, B: int) -> dict:
        return self.step if B == 32 else self.drnn


def _attention_bytes_flops(B, H, L, Dh, backward):
    n = B * H * L * Dh
    if backward:  # q, k, v, dO in; dq, dk, dv out; S, dV, dO V^T, dQ, dK
        return 4 * 7 * n, 5 * 2 * B * H * L * L * Dh
    return 4 * 4 * n, 2 * 2 * B * H * L * L * Dh


def phase_kernels_attention(torch, rows: Rows):
    import torch.nn.functional as F

    from gan_ffn_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, H, L, Dh), count in {**ATTN_SHAPES, **DRNN_ATTN_SHAPES}.items():
        q, k, v, dout = (torch.randn(B, H, L, Dh, device="cuda", generator=gen) for _ in range(4))
        for rate in (0.0, ATTN_RATE):
            for vl in (L, 90, 1, 0):
                seed = 1000 + vl
                got = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=seed)
                grads = A.fused_attention_backward(q, k, v, dout, vl, rate, seed)
                again = A.fused_attention_backward(q, k, v, dout, vl, rate, seed)
                torch.cuda.synchronize()
                want = A.attention_plain(q, k, v, vl, rate, seed)
                err = (got - want).abs().max().item()
                if not err <= ATTN_TOL:
                    fail(f"attention_fwd {(B, H, L, Dh)} rate={rate} valid_len={vl}: "
                         f"max |diff| {err} > {ATTN_TOL}")
                plain = A.attention_backward_plain(q, k, v, dout, vl, rate, seed)
                gabs = max((g - w).abs().max().item() for g, w in zip(grads, plain))
                gerr = max(max_rel_err(g, w) for g, w in zip(grads, plain))
                if not gerr <= GRAD_TOL:
                    fail(f"attention_bwd {(B, H, L, Dh)} rate={rate} valid_len={vl}: "
                         f"max |diff| / max(1, max |ref|) {gerr} > {GRAD_TOL}")
                if not all(torch.equal(g, h) for g, h in zip(grads, again)):
                    fail(f"attention_bwd {(B, H, L, Dh)} rate={rate} valid_len={vl}: "
                         "two calls differ")
                rows.err["attention_fwd"] = max(rows.err["attention_fwd"], err)
                rows.err["attention_bwd"] = max(rows.err["attention_bwd"], gabs)
                line = {"phase": "kernel", "shape": [B, H, L, Dh], "rate": rate, "valid_len": vl,
                        "fwd_max_abs_err": err, "bwd_max_abs_err": gabs, "bwd_max_rel_err": gerr}
                if vl != L:
                    emit({"name": "attention", **line})
                    continue
                # the timed calls read valid_len and the seed from device memory, as the path does
                dvl = torch.full((), vl, dtype=torch.int32, device="cuda")
                dseed = A.device_seed(seed, q.device)
                fwd = {
                    "ms": device_time_ms(torch, lambda: A.fused_attention(q, k, v, dvl, rate, dseed)),
                    "plain_ms": device_time_ms(torch, lambda: A.attention_plain(q, k, v, vl, rate, seed)),
                    "library_ms": device_time_ms(torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, dropout_p=rate)),
                }
                fwd["bound_ms"], fwd["bound_by"] = bound_ms(*_attention_bytes_flops(B, H, L, Dh, False))
                leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*leaves, dropout_p=rate)
                bwd = {
                    "ms": device_time_ms(torch, lambda: A.fused_attention_backward(
                        q, k, v, dout, dvl, rate, dseed)),
                    "plain_ms": device_time_ms(torch, lambda: A.attention_backward_plain(
                        q, k, v, dout, vl, rate, seed)),
                    "library_ms": device_time_ms(torch, lambda: torch.autograd.grad(
                        lib_out, leaves, dout, retain_graph=True)),
                }
                bwd["bound_ms"], bwd["bound_by"] = bound_ms(*_attention_bytes_flops(B, H, L, Dh, True))
                if rate == 0.0:
                    if B == 32:
                        rows.serve["attention_fwd"].append((count, fwd))
                else:
                    rows.path(B)["attention_fwd"].append((count, fwd))
                    rows.path(B)["attention_bwd"].append((count, bwd))
                emit({"name": "attention", **line, "launches_per_step": count,
                      "fwd": fwd, "bwd": bwd})

    # a ragged geometry (L and Dh off the kernels' tiles), correctness only
    B, H, L, Dh = RAGGED_ATTN_SHAPE
    q, k, v, dout = (torch.randn(B, H, L, Dh, device="cuda", generator=gen) for _ in range(4))
    for vl in (L, L - 3, 1, 0):
        seed = 3000 + vl
        got = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=ATTN_RATE, dropout_seed=seed)
        grads = A.fused_attention_backward(q, k, v, dout, vl, ATTN_RATE, seed)
        again = A.fused_attention_backward(q, k, v, dout, vl, ATTN_RATE, seed)
        torch.cuda.synchronize()
        err = (got - A.attention_plain(q, k, v, vl, ATTN_RATE, seed)).abs().max().item()
        plain = A.attention_backward_plain(q, k, v, dout, vl, ATTN_RATE, seed)
        gerr = max(max_rel_err(g, w) for g, w in zip(grads, plain))
        if not (err <= ATTN_TOL and gerr <= GRAD_TOL):
            fail(f"attention {(B, H, L, Dh)} rate={ATTN_RATE} valid_len={vl}: forward max |diff| "
                 f"{err} (limit {ATTN_TOL}), backward {gerr} (limit {GRAD_TOL} relative)")
        if not all(torch.equal(g, h) for g, h in zip(grads, again)):
            fail(f"attention_bwd {(B, H, L, Dh)} valid_len={vl}: two calls differ")
        emit({"phase": "kernel", "name": "attention", "shape": [B, H, L, Dh], "rate": ATTN_RATE,
              "valid_len": vl, "fwd_max_abs_err": err, "bwd_max_rel_err": gerr})

    # keep fraction of the kernel's mask: uniform weights, v = e_0
    B, H, L, Dh = 32, 8, 112, 64
    z = torch.zeros(B, H, L, Dh, device="cuda")
    v = torch.zeros(B, H, L, Dh, device="cuda")
    v[..., 0] = 1.0
    out = A.fused_attention(z, z, v, dropout_rate=ATTN_RATE, dropout_seed=7)
    kept = out[..., 0].double().mean().item() * (1 - ATTN_RATE)
    sigma = (ATTN_RATE * (1 - ATTN_RATE) / (B * H * L * L)) ** 0.5
    if abs(kept - (1 - ATTN_RATE)) > 5 * sigma:
        fail(f"attention dropout keeps {kept}, expected {1 - ATTN_RATE} +- {5 * sigma}")
    emit({"phase": "kernel", "name": "attention", "keep_fraction": kept,
          "expected": 1 - ATTN_RATE, "sigma": sigma})


def _mlp_bytes_flops(M, K, H, N, post, backward):
    weights = K * H + H + H * N + N
    if backward:  # x, weights, dout in; dx, dweights out
        flops = 2 * M * (3 * K * H + 2 * H * N) + (2 * M * H * N if post else 0)
        return 4 * (2 * M * K + 2 * weights + M * N), flops
    return 4 * (M * K + weights + M * N), 2 * M * (K * H + H * N)


def mlp_inputs(torch, gen, M, K, Hd, N, site):
    """``(x, w1, b1, w2, b2)`` and ``dout`` of an MLP comparison at ``M``
    rows, drawn from ``gen`` (``gan_ffn_tpu_torch.cli.kernel_bits``'s
    ``mlp_inputs``, which compares two checkouts' kernels on the same
    inputs)."""
    from gan_ffn_tpu_torch.cli.kernel_bits import mlp_inputs as draw

    return draw(gen, M, K, Hd, N, site)


def phase_kernels_mlp(torch, rows: Rows):
    from gan_ffn_tpu_torch.ops import mlp as Mo

    gen = torch.Generator(device="cuda").manual_seed(1)
    for M, ((K, Hd, N, site), count) in itertools.product((MLP_ROWS, DRNN_MLP_ROWS),
                                                          MLP_SHAPES.items()):
        args, dout = mlp_inputs(torch, gen, M, K, Hd, N, site)
        for rate in (0.0, SITE_RATE[site]):
            cfg, seed = site_cfg(site, rate), 2000 + K + N
            got = Mo.fused_mlp(*args, **cfg, dropout_seed=seed)
            got_again = Mo.fused_mlp(*args, **cfg, dropout_seed=seed)
            grads = Mo.fused_mlp_backward(*args, dout, **cfg, dropout_seed=seed)
            again = Mo.fused_mlp_backward(*args, dout, **cfg, dropout_seed=seed)
            torch.cuda.synchronize()
            want = Mo.mlp_plain(*args, **cfg, dropout_seed=seed)
            err = (got - want).abs().max().item()
            rel = max_rel_err(got, want)
            if not rel <= MLP_TOL:
                fail(f"mlp_fwd {K}->{Hd}->{N} ({site}) rate={rate}: "
                     f"max |diff| / max(1, max |ref|) {rel} > {MLP_TOL}")
            if not torch.equal(got, got_again):
                fail(f"mlp_fwd {K}->{Hd}->{N} ({site}) rate={rate}: two calls differ")
            plain = Mo.mlp_backward_plain(*args, dout, **cfg, dropout_seed=seed)
            gabs = max((g - w).abs().max().item() for g, w in zip(grads, plain))
            gerr = max(max_rel_err(g, w) for g, w in zip(grads, plain))
            if not gerr <= GRAD_TOL:
                fail(f"mlp_bwd {K}->{Hd}->{N} ({site}) rate={rate}: "
                     f"max |diff| / max(1, max |ref|) {gerr} > {GRAD_TOL}")
            if not all(torch.equal(g, h) for g, h in zip(grads, again)):
                fail(f"mlp_bwd {K}->{Hd}->{N} ({site}) rate={rate}: two calls differ")
            rows.err["mlp_fwd"] = max(rows.err["mlp_fwd"], err)
            rows.err["mlp_bwd"] = max(rows.err["mlp_bwd"], gabs)
            dseed = Mo.device_seed(seed, args[0].device)  # the timed calls read the seed on the device
            fwd = {
                "ms": device_time_ms(torch, lambda: Mo.fused_mlp(*args, **cfg, dropout_seed=dseed)),
                "plain_ms": device_time_ms(torch, lambda: Mo.mlp_plain(*args, **cfg, dropout_seed=seed)),
                "library_ms": None,
                "workspace_bytes": 4 * Mo.fwd_workspace_floats(M, K, Hd, N),
                "launch": Mo.fwd_launch(M, K, Hd, N),
            }
            fwd["bound_ms"], fwd["bound_by"] = bound_ms(*_mlp_bytes_flops(M, K, Hd, N, site == "head", False))
            bwd = {
                "ms": device_time_ms(torch, lambda: Mo.fused_mlp_backward(
                    *args, dout, **cfg, dropout_seed=dseed), reps=11, group=5),
                "plain_ms": device_time_ms(torch, lambda: Mo.mlp_backward_plain(
                    *args, dout, **cfg, dropout_seed=seed), reps=11, group=5),
                "library_ms": None,
                "workspace_bytes": 4 * Mo.bwd_workspace_floats(M, K, Hd, N),
                "split_launches": Mo.bwd_launches(M, K, Hd, N),
            }
            bwd["bound_ms"], bwd["bound_by"] = bound_ms(
                *_mlp_bytes_flops(M, K, Hd, N, site == "head", True))
            line = {"phase": "kernel", "name": "mlp", "shape": [M, K, Hd, N], "site": site,
                    "rate": rate, "fwd_max_abs_err": err, "fwd_max_rel_err": rel,
                    "bwd_max_abs_err": gabs, "bwd_max_rel_err": gerr,
                    "launches_per_step": count, "fwd": fwd, "bwd": bwd}
            if rate == 0.0:
                if M == MLP_ROWS:
                    rows.serve["mlp_fwd"].append((count, fwd))
            else:
                rows.path(M // 112)["mlp_fwd"].append((count, fwd))
                rows.path(M // 112)["mlp_bwd"].append((count, bwd))
            emit(line)

    mlp_relu_branches(torch, Mo)

    # keep fraction of the kernel's mid mask: z1 = 1 everywhere, out[:, 0] sums the mask
    rate, H, M = SITE_RATE["ffn"], 2048, MLP_ROWS
    w2 = torch.zeros(H, 4, device="cuda")
    w2[:, 0] = 1.0
    out = Mo.fused_mlp(torch.zeros(M, 100, device="cuda"), torch.zeros(100, H, device="cuda"),
                       torch.ones(H, device="cuda"), w2, torch.zeros(4, device="cuda"),
                       mid=("relu", "act_first", rate), dropout_seed=9)
    kept = out[:, 0].double().sum().item() * (1 - rate) / (M * H)
    sigma = (rate * (1 - rate) / (M * H)) ** 0.5
    if abs(kept - (1 - rate)) > 5 * sigma:
        fail(f"mlp dropout keeps {kept}, expected {1 - rate} +- {5 * sigma}")
    emit({"phase": "kernel", "name": "mlp", "keep_fraction": kept, "expected": 1 - rate,
          "sigma": sigma})


def mlp_relu_branches(torch, Mo) -> None:
    """The forward and the backward kernel take the same branch of relu' at
    inputs whose z1 lie within ~1e-6 of 0 (K -> 512 -> 512 relu FFN, K = 100
    and 512, M = 1, 3360 and 3584): every row is x0 plus noise of 1e-6, and b1 =
    -(x0 W1) in f64, rounded to f32.  With W2 = I, b2 = 0 and no post, out > 0
    exactly where the forward's z1 > 0.  dout holds whole numbers from 1 to
    1024, so db1 = sum_r dout[r, j] relu'(z1[r, j]) is exact in f32 and is
    held to sum_r dout[r, j] [out[r, j] > 0] in f64: a row on the other
    branch moves its column by its dout, and two such rows cancel only where
    their dout are equal.  Also reported: how many of those z1 the plain
    version (cuBLAS's order) puts on the other side of 0."""
    H = 512
    eye, zero = torch.eye(H, device="cuda"), torch.zeros(H, device="cuda")
    cfg = dict(mid=("relu", "act_first", 0.0))
    for K in (100, 512):
        for rows in (1, DRNN_MLP_ROWS, MLP_ROWS):
            rng = np.random.default_rng(K + rows)
            x0 = rng.standard_normal(K)
            x = torch.from_numpy((x0 + 1e-6 * rng.standard_normal((rows, K))).astype(np.float32)).cuda()
            w1 = torch.from_numpy((rng.standard_normal((K, H)) * K ** -0.5).astype(np.float32)).cuda()
            b1 = -(torch.from_numpy(x0).cuda() @ w1.double()).float()
            out = Mo.fused_mlp(x, w1, b1, eye, zero, **cfg)
            again = Mo.fused_mlp(x, w1, b1, eye, zero, **cfg)
            dout = torch.from_numpy(rng.integers(1, 1025, (rows, H)).astype(np.float32)).cuda()
            db1 = Mo.fused_mlp_backward(x, w1, b1, eye, zero, dout, **cfg)[2]
            plain = Mo.mlp_plain(x, w1, b1, eye, zero, **cfg)
            torch.cuda.synchronize()
            near = int(((x.double() @ w1.double() + b1.double()).abs() < 1e-6).sum().item())
            want = (dout.double() * (out > 0)).sum(0)
            line = {"phase": "kernel", "name": "mlp_relu_branches", "shape": [rows, K, H, H],
                    "z1_within_1e-6": near, "z1": rows * H,
                    "columns_fwd_bwd_differ": int((db1.double() != want).sum().item()),
                    "z1_plain_other_side": int(((plain > 0) != (out > 0)).sum().item()),
                    "fwd_repeat_identical": torch.equal(out, again)}
            emit(line)
            if near < rows * H // 10:
                fail(f"mlp_relu_branches {line}: too few z1 near the kink to probe it")
            if line["columns_fwd_bwd_differ"] or not line["fwd_repeat_identical"]:
                fail(f"mlp_relu_branches {line}: forward and backward take other branches")


def _gru_bytes(gi, h, backward: bool) -> int:
    """Bytes the GRU gate kernels move, each operand read once and each result
    written once: forward gi, gh, h in and h' out; backward gi, gh, h, dout in
    and dgi, dgh, dh out.  The gate math is a few dozen flops an element, so
    the bound is the bytes'."""
    n_gi, n_h = gi.numel(), h.numel()
    n = 2 * n_gi + 9 * n_h if backward else n_gi + 5 * n_h
    return n * h.element_size()


def phase_kernels_gru(torch) -> dict:
    """The GRU gate kernels against the chain of torch ops they replace
    (``ops.gru.gru_gates_plain``) at the DialogueRNN scan's three cells, f32
    and bf16: the forward, and dgi, dgh and dh through autograd, bit for bit.
    Then each kernel's device ms (the backward alone, by
    ``gru_gates_backward``), the chain's forward and the forward plus
    backward of either through autograd, beside the bytes' bound."""
    from gan_ffn_tpu_torch.ops import gru as G

    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for cell, (gi_shape, h_shape) in GRU_CELLS.items():
            gh_shape = (*h_shape[:-1], 3 * h_shape[-1])
            gi, gh, dout = (torch.randn(s, device="cuda", generator=gen).to(dtype)
                            for s in (gi_shape, gh_shape, h_shape))
            h = torch.randn(h_shape, device="cuda", generator=gen).tanh().to(dtype)
            leaves = [x.clone().requires_grad_(True) for x in (gi, gh, h)]
            before = G.gru_gates.launches, G.gru_gates_backward.launches
            got = G.gru_gates(*leaves)
            got_grads = torch.autograd.grad(got, leaves, dout)
            if (G.gru_gates.launches, G.gru_gates_backward.launches) != (before[0] + 1,
                                                                         before[1] + 1):
                fail(f"gru_gates {cell} {dtype}: the kernels did not launch once each")
            plain = [x.clone().requires_grad_(True) for x in (gi, gh, h)]
            want = G.gru_gates_plain(*plain)
            want_grads = torch.autograd.grad(want, plain, dout)
            alone = G.gru_gates_backward(gi, gh, h, dout)
            torch.cuda.synchronize()
            pairs = {"h'": (got, want)}
            pairs.update({k: (g, w) for k, g, w in zip(("dgi", "dgh", "dh"), got_grads, want_grads)})
            pairs.update({f"{k}_alone": (g, w) for k, g, w in zip(("dgi", "dgh", "dh"), alone,
                                                                   want_grads)})
            differ = {k: int((g != w).sum().item()) for k, (g, w) in pairs.items()}
            err = max((g.float() - w.float()).abs().max().item() for g, w in pairs.values())

            def fwd_bwd(fn):
                xs = [x.detach().requires_grad_(True) for x in (gi, gh, h)]
                return lambda: torch.autograd.grad(fn(*xs), xs, dout)

            fwd = {"ms": device_time_ms(torch, lambda: G.gru_gates(gi, gh, h)),
                   "plain_ms": device_time_ms(torch, lambda: G.gru_gates_plain(gi, gh, h))}
            bwd = {"ms": device_time_ms(torch, lambda: G.gru_gates_backward(gi, gh, h, dout))}
            fwd["bytes"], bwd["bytes"] = _gru_bytes(gi, h, False), _gru_bytes(gi, h, True)
            for d in (fwd, bwd):
                d["bound_ms"], d["bound_by"] = bound_ms(d["bytes"], 0.0)
            line = {"phase": "kernel", "name": "gru_gates", "cell": cell,
                    "dtype": str(dtype).removeprefix("torch."), "gi": list(gi_shape),
                    "h": list(h_shape), "elements_differ": differ, "max_abs_err": err,
                    "fwd": fwd, "bwd": bwd,
                    "fwd_bwd_ms": device_time_ms(torch, fwd_bwd(G.gru_gates)),
                    "plain_fwd_bwd_ms": device_time_ms(torch, fwd_bwd(G.gru_gates_plain))}
            emit(line)
            if any(differ.values()):
                fail(f"gru_gates {cell} {dtype}: not the chain's bits: {differ}, max |diff| {err}")
            rows[(cell, line["dtype"])] = line
    return rows


def _moe_bytes_flops(rows, E, H, F, backward):
    """(bytes, flops) of each kernel of one grouped_swiglu call over ``rows``
    rows of groups: every expert's weights read once (written once for
    their gradients), each row's operands read and results written once."""
    w_gu, w_d = E * 2 * F * H, E * H * F

    def work(rows_in, rows_out, weights, flops):
        return 4 * (weights + rows * (rows_in + rows_out)), flops

    if not backward:
        return [work(H, F, w_gu, 2 * rows * H * 2 * F), work(F, H, w_d, 2 * rows * F * H)]
    return [work(H + 2 * F, 2 * F, w_d, 2 * rows * H * F),  # da, SwiGLU': dy, z in; dz out
            work(2 * F, H, w_gu, 2 * rows * 2 * F * H),  # dx
            work(2 * F + H, 0, w_gu, 2 * rows * 2 * F * H),  # dWg, dWu
            work(H + F, 0, w_d, 2 * rows * H * F)]  # dWd


def _moe_case(torch, kind, gen):
    """(x, offsets, weights, (w_gate, w_up, w_down), rows of groups) of one
    grouped_swiglu call of ``kind`` (MOE_GROUPS)."""
    from gan_ffn_tpu_torch.nn import moe as M

    (E, F), H = MOE_GROUPS[kind], MOE_HIDDEN

    def uniform(shape, fan_in):
        return torch.rand(shape, device="cuda", generator=gen).sub_(0.5).mul_(2 / fan_in ** 0.5)

    w = (uniform((E, F, H), H), uniform((E, F, H), H), uniform((E, H, F), F))
    x = torch.randn(MOE_ROWS, H, device="cuda", generator=gen)
    if E == 1:
        return x, None, None, w, MOE_ROWS
    idx = torch.rand(MOE_ROWS, E, device="cuda", generator=gen).topk(MOE_TOP_K, dim=-1).indices
    valid = torch.arange(MOE_ROWS, device="cuda") < MOE_ROUTED_ROWS
    order, _, offsets, _, src = M.sort_pairs(idx, valid, E)
    route_w = torch.rand(MOE_ROWS * MOE_TOP_K, device="cuda", generator=gen)[order]
    return x[src], offsets, route_w, w, MOE_ROUTED_ROWS * MOE_TOP_K


def phase_kernels_moe(torch) -> dict:
    """The grouped SwiGLU expert kernels against the per-expert loop at
    Moonlight's widths (phase 3b): outputs and gradients, the bits of two
    calls, the launches a call, and the device ms of each call kind."""
    from gan_ffn_tpu_torch.ops import moe as O

    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = {}
    for kind, (E, F) in MOE_GROUPS.items():
        x, offsets, route_w, w, grouped = _moe_case(torch, kind, gen)
        dy = torch.randn(x.shape[0], MOE_HIDDEN, device="cuda", generator=gen)

        def run(fn, x=x, offsets=offsets, route_w=route_w, w=w, grouped=grouped, dy=dy):
            leaves = [t.clone().requires_grad_(True) for t in (x, *w)]
            wt = None if route_w is None else route_w.clone().requires_grad_(True)
            y = fn(*leaves, offsets, wt)
            grads = torch.autograd.grad(y[:grouped], leaves + ([wt] if wt is not None else []),
                                        dy[:grouped])
            return ([y[:grouped], grads[0][:grouped], *grads[1:4]]
                    + ([grads[4][:grouped]] if wt is not None else []))

        before = O.grouped_swiglu.launches, O.grouped_swiglu.backward_launches
        got = run(O.grouped_swiglu)
        if (O.grouped_swiglu.launches, O.grouped_swiglu.backward_launches) != (before[0] + 1,
                                                                               before[1] + 1):
            fail(f"grouped_swiglu {kind}: not one forward and one backward call counted")
        again = run(O.grouped_swiglu)
        want = run(O.grouped_swiglu_plain)
        torch.cuda.synchronize()
        names = ("y", "dx", "dw_gate", "dw_up", "dw_down", "dweights")
        errs = {n: (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
                for n, g, r in zip(names, got, want)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, want

        host_offsets = None if offsets is None else offsets.cpu()  # the loop reads them

        def fwd_bwd(x=x, offsets=offsets, route_w=route_w, w=w, dy=dy):
            leaves = [t.detach().requires_grad_(True) for t in (x, *w)]
            return lambda: torch.autograd.grad(O.grouped_swiglu(*leaves, offsets, route_w),
                                               leaves, dy)

        timing = {"reps": 11, "group": 5}
        fwd_ms = device_time_ms(torch, lambda: O.grouped_swiglu(x, *w, offsets, route_w), **timing)
        both_ms = device_time_ms(torch, fwd_bwd(), **timing)
        plain_ms = device_time_ms(
            torch, lambda: O.grouped_swiglu_plain(x, *w, host_offsets, route_w), **timing)
        bounds = {d: sum(bound_ms(b, f)[0] for b, f in _moe_bytes_flops(grouped, E, MOE_HIDDEN, F,
                                                                        d == "bwd"))
                  for d in ("fwd", "bwd")}
        line = {"phase": "kernel", "name": "grouped_swiglu", "kind": kind, "groups": E,
                "width": F, "hidden": MOE_HIDDEN, "rows": x.shape[0], "grouped_rows": grouped,
                "rel_err": errs, "identical_bits": same,
                "fwd": {"ms": fwd_ms, "plain_ms": plain_ms, "bound_ms": bounds["fwd"]},
                "bwd": {"ms": both_ms - fwd_ms, "bound_ms": bounds["bwd"]},
                "fwd_bwd_ms": both_ms}
        emit(line)
        if not all(e <= MOE_TOL for e in errs.values()):
            fail(f"grouped_swiglu {kind}: {errs}, limit {MOE_TOL} of max |ref|")
        if not same:
            fail(f"grouped_swiglu {kind}: two calls differ in bits")
        rows[kind] = line
    return rows


def phase_moonlight_step(torch) -> dict:
    """One eager stage-A step with the Moonlight text generator (phase 3b):
    the wrappers' launches in each of 2 steps, the losses, the MoE layers'
    routed rows and loads, host ms of 3 more, and the peak memory."""
    from gan_ffn_tpu_torch.cli.common import make_stage_a_step
    from gan_ffn_tpu_torch.ops import moe as O
    from gan_ffn_tpu_torch.train.gan import GANConfig, init_gan_state

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = GANConfig(num_layers=8, seed=5, text_generator="moonlight")
    state = init_gan_state(cfg, device="cuda")
    step = make_stage_a_step(cfg, state)
    gen = torch.Generator(device="cuda").manual_seed(23)
    batch = {k: torch.randn(112, 32, d, device="cuda", generator=gen)
             for k, d in (("text", 100), ("visual", 512), ("audio", 100))}
    batch["valid_len"] = torch.tensor(110, dtype=torch.int32, device="cuda")
    batch["n_real"] = torch.tensor(32, dtype=torch.int32, device="cuda")

    def read():
        return {**_read_counts(), "moe_fwd": O.grouped_swiglu.launches,
                "moe_bwd": O.grouped_swiglu.backward_launches}

    losses = {}
    counts = _launches_per_step(torch, lambda: losses.update(step(batch)), n=2, read=read)
    if any(c != MOONLIGHT_STEP_LAUNCHES for c in counts):
        fail(f"launches per Moonlight stage-A step {counts}, expected {MOONLIGHT_STEP_LAUNCHES}")
    if not all(math.isfinite(v.item()) for v in losses.values()):
        fail(f"Moonlight stage-A step losses {losses}")
    layers = state.modules["text_gen"].moe_layers()
    routed = [int(m.routed_rows) for m in layers]
    loads = [int(m.last_load.sum()) for m in layers]
    if routed != [MOE_ROUTED_ROWS] * len(layers) or loads != [MOE_TOP_K * MOE_ROUTED_ROWS] * len(layers):
        fail(f"Moonlight MoE layers routed {routed} rows with loads {loads}: expected "
             f"{MOE_ROUTED_ROWS} and {MOE_TOP_K * MOE_ROUTED_ROWS} each (dropless)")
    host_ms, enqueue_ms = _host_ms(torch, lambda: step(batch), 3)
    line = {"phase": "moonlight_step", "B": 32, "L": 112, "valid_len": 110, "n_real": 32,
            "launches_per_step": counts[0], "moe_layers": len(layers), "routed_rows": routed,
            "max_over_mean_load": [float(m.last_load.max() / m.last_load.float().mean())
                                   for m in layers],
            "host_ms": statistics.median(host_ms), "host_ms_all": host_ms,
            "enqueue_ms": statistics.median(enqueue_ms),
            "parameters": sum(p.numel() for p in state.modules["text_gen"].parameters()),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(line)
    del state, step, layers, losses
    torch.cuda.empty_cache()
    return line


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.load(resp)


def phase_serving(torch):
    from http.server import ThreadingHTTPServer

    from gan_ffn_tpu_torch.cli.serve import make_handler
    from gan_ffn_tpu_torch.models import GAN_FFN
    from gan_ffn_tpu_torch.ops import attention as A
    from gan_ffn_tpu_torch.ops import mlp as M
    from gan_ffn_tpu_torch.serving import ServingClassifier, export_classifier

    rng = np.random.default_rng(0)

    def request(L, B):
        return [rng.standard_normal((L, B, d)).astype(np.float32) for d in (100, 512, 100)]

    def check_lp(lp, L, B, what):
        if lp.shape != (L, B, 6) or not np.isfinite(lp).all():
            fail(f"{what}: log-probs of shape {lp.shape}, finite={np.isfinite(lp).all()}")
        if not np.allclose(np.exp(lp).sum(-1), 1.0, atol=1e-4):
            fail(f"{what}: probabilities do not sum to 1")

    model = GAN_FFN(n_classes=6, D_h=100, gen_num_layers=8,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gan_ffn.pt")
        export_classifier(model, path)
        clf = ServingClassifier.load(path, device="cuda", batch_grid=GRID)
        cpu = ServingClassifier.load(path, device="cpu", batch_grid=GRID)
    warm = clf.warmup()

    launches = []  # (attention, mlp) launches of each forward of the main path
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(clf))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}"
    A.fused_attention.launches = A.fused_attention_backward.launches = 0
    M.fused_mlp.launches = M.fused_mlp_backward.launches = 0
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.load(resp)
        if health["status"] != "ok" or health["device"] != "cuda":
            fail(f"healthz: {health}")
        for L, B, vl in ((20, 2, None), (57, 1, 50)):
            a, v, t = request(L, B)
            before = (A.fused_attention.launches, M.fused_mlp.launches)
            body = {"audio": a.tolist(), "visual": v.tolist(), "text": t.tolist()}
            if vl is not None:
                body["valid_len"] = vl
            resp = _post(f"{url}/predict", body)
            launches.append((A.fused_attention.launches - before[0], M.fused_mlp.launches - before[1]))
            if len(resp["classes"]) != B or any(len(r) != L for r in resp["classes"]):
                fail(f"POST /predict (L={L}, B={B}): classes {resp['classes']}")
            if any(n not in clf.label_names for r in resp["class_names"] for n in r):
                fail(f"POST /predict: unknown class names {resp['class_names']}")
        for L, B in ((110, 32), (64, 8), (33, 1)):
            before = (A.fused_attention.launches, M.fused_mlp.launches)
            check_lp(clf.log_probs(*request(L, B)), L, B, f"log_probs L={L} B={B}")
            launches.append((A.fused_attention.launches - before[0], M.fused_mlp.launches - before[1]))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    counts = {"attention_fwd": A.fused_attention.launches, "mlp_fwd": M.fused_mlp.launches}
    if any(n != (24, 27) for n in launches):
        fail(f"launches per forward (attention, mlp) were {launches}, expected (24, 27) each")
    if A.fused_attention_backward.launches or M.fused_mlp_backward.launches:
        fail("serving launched a backward kernel")

    xs = request(64, 4)
    card, host = clf.log_probs(*xs), cpu.log_probs(*xs)
    check_lp(card, 64, 4, "card log_probs L=64 B=4")
    e2e_err = float(np.abs(card - host).max())
    if not e2e_err <= E2E_TOL:
        fail(f"card vs CPU log-probs at L=64, B=4: max |diff| {e2e_err} > {E2E_TOL}")
    agree = float((card.argmax(-1) == host.argmax(-1)).mean())

    xs = request(112, 32)
    for _ in range(3):
        clf.log_probs(*xs)
    req_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        clf.log_probs(*xs)
        req_ms.append((time.perf_counter() - t0) * 1e3)
    dev = [torch.from_numpy(x).cuda() for x in xs]
    enqueue_ms, host_ms = [], []  # host clock, inputs already on the card
    with torch.inference_mode():
        fwd_ms = device_time_ms(torch, lambda: clf.model(*dev, valid_len=112), reps=7, group=3)
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clf.model(*dev, valid_len=112)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue_ms.append((t1 - t0) * 1e3)
            host_ms.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(req_ms)
    emit({
        "phase": "serving", "layers": 8, "widths": {"audio": 100, "visual": 512, "text": 100, "D_h": 100},
        "warmup_shapes": [[L, B] for L, B, _ in warm],
        "http_requests": 2, "direct_requests": 3, "launches_per_forward": launches,
        "launches": counts,
        "card_vs_cpu_max_abs_err": e2e_err, "card_vs_cpu_argmax_agreement": agree,
        "request_ms_L112_B32": ms, "request_ms_min": min(req_ms),
        "utterances_per_s": 112 * 32 / (ms / 1e3), "forward_device_ms_L112_B32": fwd_ms,
        "forward_host_ms_L112_B32": statistics.median(host_ms),
        "forward_enqueue_ms_L112_B32": statistics.median(enqueue_ms),
    })
    return counts, fwd_ms


def _counters():
    from gan_ffn_tpu_torch.ops import attention as A
    from gan_ffn_tpu_torch.ops import mlp as M

    return {"attention_fwd": A.fused_attention, "attention_bwd": A.fused_attention_backward,
            "mlp_fwd": M.fused_mlp, "mlp_bwd": M.fused_mlp_backward}


def _gru_counters():
    from gan_ffn_tpu_torch.ops import gru as G

    return {"gru_fwd": G.gru_gates, "gru_bwd": G.gru_gates_backward}


def _reset_counts():
    for fn in (*_counters().values(), *_gru_counters().values()):
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _read_all_counts():
    """:func:`_read_counts` and the GRU gate kernels' launches."""
    return {**_read_counts(), **{name: fn.launches for name, fn in _gru_counters().items()}}


def _steps(torch, model, deterministic=False):
    from gan_ffn_tpu_torch.cli.common import IEMOCAP_LOSS_WEIGHTS, IEMOCAP_N_CLASSES as N_CLASSES
    from gan_ffn_tpu_torch.train.classifier import make_classifier_steps
    from gan_ffn_tpu_torch.train.optim import torch_adam

    device = next(model.parameters()).device
    if type(model).__name__ == "MELDLSTMModel":  # the MELD trainer's Adam and unweighted loss
        opt = torch_adam(model.parameters(), 3e-4, weight_decay=1e-4)
        return make_classifier_steps(model, opt, model.n_classes, deterministic=deterministic)
    opt = torch_adam(model.parameters(), 1e-4, weight_decay=0.008)
    weights = torch.from_numpy(IEMOCAP_LOSS_WEIGHTS).to(device)
    return make_classifier_steps(model, opt, N_CLASSES, weights, deterministic=deterministic)


def phase_training(torch, tmp: str):
    """The flagship trainer in ``tmp``; its fixture and GAN_save/ stay there
    for :func:`phase_dialoguernn`."""
    from gan_ffn_tpu_torch.cli import train_iemocap as CLI
    from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
    from gan_ffn_tpu_torch.models import GAN_FFN
    from gan_ffn_tpu_torch.nn.core import set_dropout_generator
    from gan_ffn_tpu_torch.train.gan import DISC_NAMES, GEN_NAMES
    from gan_ffn_tpu_torch.train.loop import batch_to_tensors
    from gan_ffn_tpu_torch.utils.artifacts import load_gan_loss_csv

    epochs, gan_epochs = 2, 1
    data = write_synthetic_iemocap(os.path.join(tmp, "iemocap.pkl"), n_train=120, n_test=31,
                                   min_len=97, max_len=110, seed=0)
    train, valid, test = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)
    lengths = {b.seq_len for loader in (train, valid, test) for b in loader}
    if lengths != {112}:
        fail(f"the training fixture's batches have lengths {lengths}, expected the 112 bucket")
    save_dir = os.path.join(tmp, "GAN_save")
    argv = ["--GAN-epochs", str(gan_epochs), "--epochs", str(epochs), "--num-layers", "8",
            "--batch-size", "32", "--seed", "0", "--device", "cuda", "--data-path", data,
            "--output-dir", os.path.join(tmp, "output"), "--model-save-path", save_dir]
    out = io.StringIO()
    t0 = time.perf_counter()
    _reset_counts()
    with contextlib.redirect_stdout(out):
        result = CLI.main(argv)
    torch.cuda.synchronize()
    counts = _read_counts()
    seconds = time.perf_counter() - t0
    report_ok = os.path.isfile(result["report_path"]) and os.path.getsize(result["report_path"]) > 0
    ckpt_ok = os.path.isfile(result["checkpoint"])
    gan_history = load_gan_loss_csv(os.path.join(tmp, "output", "GAN_loss.csv"))
    gan_files = [os.path.join(save_dir, sub, f"{name}.msgpack")
                 for name in GEN_NAMES + DISC_NAMES for sub in ("", "opt")]
    missing = [f for f in gan_files if not os.path.isfile(f)]
    batch = batch_to_tensors(next(iter(train)), "cuda")
    log = out.getvalue().splitlines()
    lines = _check_trainer_run(result, log, epochs, "training")
    if not (report_ok and ckpt_ok):
        fail(f"training wrote no report or checkpoint: {result}")
    if (len(gan_history) != gan_epochs
            or not all(math.isfinite(v) for row in gan_history for v in row.values())):
        fail(f"stage A's GAN_loss.csv: {gan_history}")
    if missing:
        fail(f"stage A saved no {missing}")
    gan_steps = gan_epochs * len(train)  # stage A's loader: batch 32, valid 0.1, the same seed
    n_steps, n_evals = epochs * len(train), epochs * (len(valid) + len(test))
    expect = {name: per * (n_steps + (n_evals if name.endswith("fwd") else 0))
              + GAN_STEP_LAUNCHES[name] * gan_steps for name, per in STEP_LAUNCHES.items()}
    if counts != expect:
        fail(f"training launches {counts}, expected {expect} ({gan_steps} stage-A steps, "
             f"{n_steps} stage-B train steps, {n_evals} eval forwards)")
    emit({"phase": "training", "cli": "gan_ffn_tpu_torch.cli.train_iemocap", "argv": argv[:10],
          "gan_epochs": [l for l in log if l.startswith("GAN epoch ")], "gan_loss_csv": gan_history,
          "epochs": lines, "best_loss": result["best_loss"], "f1": result["f1"],
          "gan_steps": gan_steps, "train_steps": n_steps, "eval_forwards": n_evals,
          "launches": counts, "seconds": seconds})

    gan_step = phase_gan_step(torch, batch)

    # one train step at B=32, L=112, every dropout on
    model = GAN_FFN(n_classes=6, gen_num_layers=8, generator=torch.Generator().manual_seed(1),
                    device="cuda")
    set_dropout_generator(model, torch.Generator().manual_seed(2))
    train_step, _ = _steps(torch, model)
    step_counts = _launches_per_step(torch, lambda: train_step(batch))
    if any(c != STEP_LAUNCHES for c in step_counts):
        fail(f"launches per train step {step_counts}, expected {STEP_LAUNCHES}")
    host_ms, enqueue_ms = _host_ms(torch, lambda: train_step(batch), 10)
    enqueue = statistics.median(enqueue_ms)
    torch.cuda.reset_peak_memory_stats()
    device_ms = device_time_ms(torch, lambda: train_step(batch), reps=7, group=3,
                               sleep_ms=3 * enqueue + 20)
    host = statistics.median(host_ms)
    utterances = int(batch["umask"].sum().item())
    step = {"phase": "train_step", "B": 32, "L": 112, "valid_len": batch["host_valid_len"],
            "utterances": utterances, "launches_per_step": step_counts[0],
            "device_ms": device_ms, "host_ms": host, "enqueue_ms": enqueue,
            "utterances_per_s": utterances / (host / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(step)

    # one deterministic step on the card against the CPU path, same weights and batch
    rng = np.random.default_rng(3)
    L, B = 64, 4
    lengths = np.array([64, 50, 33, 10])
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    host_batch = {
        "audio": rng.standard_normal((L, B, 100)).astype(np.float32),
        "visual": rng.standard_normal((L, B, 512)).astype(np.float32),
        "text": rng.standard_normal((L, B, 100)).astype(np.float32),
        "umask": umask, "label": rng.integers(0, 6, (B, L)) * umask.astype(np.int64),
    }
    vs_cpu = _step_vs_cpu(torch, GAN_FFN, dict(n_classes=6, gen_num_layers=8), host_batch,
                          int(lengths.max()), seed=4)
    emit({"phase": "train_step_vs_cpu", "L": L, "B": B, **vs_cpu})
    return counts, step, gan_step


def _launches_per_step(torch, step, n: int = 3, read=_read_counts) -> list:
    """Each kernel's launches, as ``read()`` gives them, in each of ``n``
    calls of ``step()``."""
    counts = []
    for _ in range(n):
        before = read()
        step()
        torch.cuda.synchronize()
        counts.append({k: v - before[k] for k, v in read().items()})
    return counts


def _host_ms(torch, step, n: int):
    """Host ms of each of ``n`` calls of ``step()`` to the end of a
    synchronize, and their enqueue ms (to the return of the call)."""
    host_ms, enqueue_ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue_ms.append((t1 - t0) * 1e3)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return host_ms, enqueue_ms


def _step_vs_cpu(torch, cls, kwargs: dict, host_batch: dict, valid_len: int, seed: int,
                 loss_tol: float = E2E_TOL, grad_tol: float = E2E_TOL) -> dict:
    """One deterministic classifier train step of ``cls(**kwargs)`` on the
    CPU (plain versions) and on the card from the same weights and batch;
    fails unless the loss agrees within ``loss_tol`` relative and every
    parameter's gradient within max |diff| / max(1, max |ref|) <=
    ``grad_tol`` (both E2E_TOL at f32), and each gradient within
    OWN_SCALE_TOL of its own max |ref|."""
    cpu_model = cls(**kwargs, generator=torch.Generator().manual_seed(seed), device="cpu")
    card_model = cls(**kwargs, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    results = {}
    for name, model in (("cpu", cpu_model), ("cuda", card_model)):
        tensors = {k: torch.from_numpy(v).to(name) for k, v in host_batch.items()}
        tensors["valid_len"] = valid_len
        loss, _ = _steps(torch, model, deterministic=True)[0](tensors)
        results[name] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()})
    (cpu_loss, cpu_grads), (card_loss, card_grads) = results["cpu"], results["cuda"]
    loss_err = abs(card_loss - cpu_loss) / max(1.0, abs(cpu_loss))
    errs = {k: max_rel_err(card_grads[k], g) for k, g in cpu_grads.items()}
    worst = max(errs, key=errs.get)
    ref = {k: g.abs().max().item() for k, g in cpu_grads.items()}
    if not (loss_err <= loss_tol and errs[worst] <= grad_tol):
        fail(f"card vs CPU {cls.__name__} train step: loss {loss_err} (limit {loss_tol}), "
             f"gradients {errs[worst]} at {worst} (max |diff| / max(1, max |ref|), max |ref| "
             f"{ref[worst]}; limit {grad_tol})")
    diff = {k: (card_grads[k] - g).abs().max().item() for k, g in cpu_grads.items()}
    own = {k: d / ref[k] if ref[k] else (0.0 if d == 0 else math.inf) for k, d in diff.items()}
    own_worst = max(own, key=own.get)
    if not own[own_worst] <= OWN_SCALE_TOL:
        fail(f"card vs CPU {cls.__name__} train step: gradient {own_worst} off by "
             f"{own[own_worst]} of its max |ref| {ref[own_worst]} > {OWN_SCALE_TOL}")
    return {"loss_cpu": cpu_loss, "loss_cuda": card_loss, "loss_rel_err": loss_err,
            "max_grad_rel_err": errs[worst], "worst_grad": worst,
            "worst_grad_max_abs_ref": ref[worst], "max_abs_ref": max(ref.values()),
            "max_grad_own_scale_err": own[own_worst], "worst_own_scale_grad": own_worst,
            "worst_own_scale_grad_max_abs_ref": ref[own_worst], "min_max_abs_ref": min(ref.values()),
            "parameters": len(cpu_grads)}


def _gan_state(torch, device, seed, deterministic=False, eps=None):
    from gan_ffn_tpu_torch.nn.core import set_dropout_generator
    from gan_ffn_tpu_torch.ops.dropout import StepSeeds
    from gan_ffn_tpu_torch.train.gan import GANConfig, init_gan_state, make_gan_train_step

    state = init_gan_state(GANConfig(num_layers=8, seed=seed), device=device)
    dropout_seeds = StepSeeds(torch.Generator().manual_seed(seed + 1))  # one for all six
    for module in state.modules.values():
        set_dropout_generator(module, dropout_seeds)
    if eps is not None:
        for opt in state.opts.values():
            for group in opt.param_groups:
                group["eps"] = eps
    return state, make_gan_train_step(state.modules, state.opts, deterministic=deterministic)


def phase_gan_step(torch, batch):
    """One stage-A step (the 12 duels) at B=32, L=112 with every dropout on,
    then one deterministic step on the card against the CPU."""
    from gan_ffn_tpu_torch.cli.common import gan_batch_from
    from gan_ffn_tpu_torch.train.gan import DUEL_SCHEDULE

    gan_batch = gan_batch_from(batch)
    state, gan_step = _gan_state(torch, "cuda", 5)
    losses = {}
    step_counts = _launches_per_step(torch, lambda: losses.update(gan_step(gan_batch)), n=2)
    if any(c != GAN_STEP_LAUNCHES for c in step_counts):
        fail(f"launches per stage-A step {step_counts}, expected {GAN_STEP_LAUNCHES}")
    if not all(math.isfinite(v.item()) for v in losses.values()):
        fail(f"stage-A step losses {losses}")
    torch.cuda.reset_peak_memory_stats()
    host_ms, enqueue_ms = _host_ms(torch, lambda: gan_step(gan_batch), 5)
    host = statistics.median(host_ms)
    utterances = int(batch["umask"].sum().item())
    line = {"phase": "gan_step", "B": 32, "L": 112, "valid_len": batch["host_valid_len"],
            "n_real": batch["host_n_real"], "utterances": utterances, "duels": len(DUEL_SCHEDULE),
            "launches_per_step": step_counts[0], "host_ms": host,
            "enqueue_ms": statistics.median(enqueue_ms), "host_ms_all": host_ms,
            "duel_utterances_per_s": len(DUEL_SCHEDULE) * utterances / (host / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(line)
    del state, gan_step

    # one deterministic 12-duel step on the card against the CPU, same weights and batch
    rng = np.random.default_rng(6)
    L, B = 64, 4
    host_batch = {k: rng.standard_normal((L, B, d)).astype(np.float32)
                  for k, d in (("audio", 100), ("visual", 512), ("text", 100))}
    results = {}
    for device in ("cpu", "cuda"):
        state, step = _gan_state(torch, device, 7, deterministic=True, eps=1e-3)
        tensors = {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()}
        t0 = time.perf_counter()
        losses = step({**tensors, "valid_len": 50, "n_real": 3})
        results[device] = ([losses[f"duel_{i}"].item() for i in range(len(DUEL_SCHEDULE))],
                           {f"{name}.{k}": v.cpu() for name, m in state.modules.items()
                            for k, v in m.state_dict().items()},
                           time.perf_counter() - t0)
    (cpu_losses, cpu_params, cpu_s), (card_losses, card_params, card_s) = results["cpu"], results["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    param_err = max((card_params[k] - v).abs().max().item() for k, v in cpu_params.items())
    worst = max(cpu_params, key=lambda k: (card_params[k] - cpu_params[k]).abs().max().item())
    emit({"phase": "gan_step_vs_cpu", "L": L, "B": B, "valid_len": 50, "n_real": 3, "layers": 8,
          "losses_cpu": cpu_losses, "losses_cuda": card_losses, "max_loss_rel_err": loss_err,
          "max_param_abs_err": param_err, "worst_param": worst, "parameters": len(cpu_params),
          "seconds_cpu": cpu_s, "seconds_cuda": card_s})
    if not (loss_err <= E2E_TOL and param_err <= GAN_PARAM_TOL):
        fail(f"card vs CPU stage-A step at L=64, B=4: losses {loss_err} (limit {E2E_TOL} "
             f"relative), parameters {param_err} (limit {GAN_PARAM_TOL} absolute)")
    return line


def phase_dialoguernn(torch, tmp: str) -> dict:
    """The DialogueRNN trainer at full width on the training phase's
    fixture, loading that phase's six stage-A networks; one timed train
    step at B=30, L=112; one deterministic step on the card against the
    CPU."""
    from gan_ffn_tpu_torch.cli import train_iemocap_dialoguernn as CLI
    from gan_ffn_tpu_torch.data import get_iemocap_loaders
    from gan_ffn_tpu_torch.models import GAN_FFN_DialogueRNN
    from gan_ffn_tpu_torch.nn.core import set_dropout_generator
    from gan_ffn_tpu_torch.train.loop import batch_to_tensors

    epochs, B = 2, 30
    data, save_dir = os.path.join(tmp, "iemocap.pkl"), os.path.join(tmp, "GAN_save")
    train, valid, test = get_iemocap_loaders(data, batch_size=B, valid=0.1, seed=0)
    if {(b.seq_len, b.batch_size) for loader in (train, valid, test) for b in loader} != {(112, B)}:
        fail("the DialogueRNN fixture's batches are not all of L=112, B=30")
    argv = ["--epochs", str(epochs), "--num-layers", "8", "--seed", "0", "--device", "cuda",
            "--data-path", data, "--output-dir", os.path.join(tmp, "output_dialoguernn"),
            "--model-save-path", save_dir]
    out = io.StringIO()
    t0 = time.perf_counter()
    _reset_counts()
    with contextlib.redirect_stdout(out):
        result = CLI.main(argv)
    torch.cuda.synchronize()
    counts = _read_all_counts()
    seconds = time.perf_counter() - t0
    log = out.getvalue().splitlines()
    lines = _check_trainer_run(result, log, epochs, "DialogueRNN")
    if not any("loaded trained GAN" in l for l in log):
        fail("the DialogueRNN trainer did not load the flagship trainer's GAN networks")
    if not (math.isfinite(result["best_loss"])
            and os.path.isfile(os.path.join(save_dir, "dialoguernn_classifier_best.msgpack"))):
        fail(f"the DialogueRNN trainer wrote no checkpoint or lost its loss: {result}")
    attn = result["attentions"]
    shapes = {k: [a.shape for a in attn[k]] for k in ("alpha", "alpha_f", "alpha_b")}
    want_shapes = [(112, len(v), 112) for v in attn["vids"]]
    if (sum(map(len, attn["vids"])) != sum(b.n_real for b in test)
            or any(s != want_shapes for s in shapes.values())
            or not all(np.isfinite(a).all() for k in shapes for a in attn[k])):
        fail(f"DialogueRNN attentions: {shapes} for vids of {[len(v) for v in attn['vids']]}")
    n_steps, n_evals = epochs * len(train), epochs * (len(valid) + len(test))
    expect = {name: per * (n_steps + (n_evals if name.endswith("fwd") else 0))
              for name, per in {**STEP_LAUNCHES, **GRU_STEP_LAUNCHES}.items()}
    if counts != expect:
        fail(f"DialogueRNN launches {counts}, expected {expect} ({n_steps} train steps, "
             f"{n_evals} eval forwards)")
    emit({"phase": "dialoguernn", "cli": "gan_ffn_tpu_torch.cli.train_iemocap_dialoguernn",
          "argv": argv[:8], "epochs": lines, "best_loss": result["best_loss"], "f1": result["f1"],
          "attention_shapes": {k: [list(s) for s in v] for k, v in shapes.items()},
          "train_steps": n_steps, "eval_forwards": n_evals, "launches": counts,
          "seconds": seconds})

    # one train step at B=30, L=112, every dropout on
    batch = batch_to_tensors(next(iter(train)), "cuda")
    model = GAN_FFN_DialogueRNN(n_classes=6, gen_num_layers=8,
                                generator=torch.Generator().manual_seed(1), device="cuda")
    set_dropout_generator(model, torch.Generator().manual_seed(2))
    torch.manual_seed(3)
    train_step, _ = _steps(torch, model)
    step_counts = _launches_per_step(torch, lambda: train_step(batch), read=_read_all_counts)
    if any(c != {**STEP_LAUNCHES, **GRU_STEP_LAUNCHES} for c in step_counts):
        fail(f"launches per DialogueRNN train step {step_counts}, expected "
             f"{ {**STEP_LAUNCHES, **GRU_STEP_LAUNCHES} }")
    torch.cuda.reset_peak_memory_stats()
    host_ms, enqueue_ms = _host_ms(torch, lambda: train_step(batch), 5)
    host = statistics.median(host_ms)
    utterances = int(batch["umask"].sum().item())
    step = {"phase": "dialoguernn_step", "B": B, "L": 112, "valid_len": batch["host_valid_len"],
            "n_real": batch["host_n_real"], "utterances": utterances,
            "launches_per_step": step_counts[0], "host_ms": host,
            "enqueue_ms": statistics.median(enqueue_ms), "host_ms_all": host_ms,
            "utterances_per_s": utterances / (host / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(step)
    del model, train_step

    # one deterministic step on the card against the CPU path: depth 8, n_real < B
    rng = np.random.default_rng(5)
    L, B = 64, 4
    lengths = np.array([64, 41, 17, 0])
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    host_batch = {
        "audio": rng.standard_normal((L, B, 100)).astype(np.float32),
        "visual": rng.standard_normal((L, B, 512)).astype(np.float32),
        "text": rng.standard_normal((L, B, 100)).astype(np.float32),
        "qmask": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (L, B))] * umask.T[:, :, None],
        "umask": umask, "label": rng.integers(0, 6, (B, L)) * umask.astype(np.int64),
    }
    vs_cpu = _step_vs_cpu(torch, GAN_FFN_DialogueRNN, dict(n_classes=6, gen_num_layers=8),
                          host_batch, int(lengths.max()), seed=6)
    emit({"phase": "dialoguernn_step_vs_cpu", "L": L, "B": B, "n_real": 3, **vs_cpu})
    return counts, step


# Phase 7: a fixture whose batches span two buckets, L = 96 and L = 112, in
# every train loader's epochs (B = 32 and 30, loader seed 0)
GRAPH_FIXTURE = dict(n_train=120, n_test=31, min_len=40, max_len=98, seed=0)
GRAPH_LENGTHS = {96, 112}
GRAPH_TOL = 1e-6  # graphed against eager, relative to max(1, max |ref|)
GRAPH_SEEDS = (11, 2**62 + 5, 123456789)  # seed bases a captured graph replays with


def _check_trainer_run(result, log, epochs, what):
    """A trainer's epoch lines in ``log``: ``epochs`` of them, each with three
    finite losses, and a finite best loss."""
    lines = [l for l in log if l.startswith("epoch ")]
    losses = [float(w) for l in lines for k, w in zip(l.split()[::2], l.split()[1::2])
              if k.endswith("_loss")]
    if len(lines) != epochs or len(losses) != 3 * epochs or not all(map(math.isfinite, losses)):
        fail(f"{what} epochs: {lines}")
    if not math.isfinite(result["best_loss"]):
        fail(f"{what}: best loss {result['best_loss']}")
    return lines


def _graphs_cli(torch, tmp: str) -> dict:
    """Both trainers with --epoch-fused at full width on the two-bucket
    fixture, every dropout on: the artifacts of phases 5 and 6, and one
    graph per shape in every dispatcher, replayed."""
    from gan_ffn_tpu_torch.cli import train_iemocap as FLAGSHIP
    from gan_ffn_tpu_torch.cli import train_iemocap_dialoguernn as DRNN
    from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
    from gan_ffn_tpu_torch.train import graphs as G
    from gan_ffn_tpu_torch.train.gan import DISC_NAMES, GEN_NAMES
    from gan_ffn_tpu_torch.utils.artifacts import load_gan_loss_csv

    data = write_synthetic_iemocap(os.path.join(tmp, "iemocap_two_buckets.pkl"), **GRAPH_FIXTURE)
    for B in (32, 30):
        loaders = get_iemocap_loaders(data, batch_size=B, valid=0.1, seed=0)
        lengths = [[b.seq_len for b in loader] for loader in loaders]
        if set(lengths[0]) != GRAPH_LENGTHS or not set(sum(lengths, [])) <= GRAPH_LENGTHS:
            fail(f"the two-bucket fixture's batches at B={B} have lengths {lengths}")
    save_dir, out_dir = os.path.join(tmp, "GAN_save_graphs"), os.path.join(tmp, "output_graphs")
    common = ["--epoch-fused", "--num-layers", "8", "--seed", "0", "--device", "cuda",
              "--data-path", data, "--output-dir", out_dir, "--model-save-path", save_dir]
    gan_train = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)[0]
    made = []
    init = G.ShapeGraphs.__init__

    def recording_init(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    G.ShapeGraphs.__init__ = recording_init
    runs = {}
    try:
        for name, cli, argv, epochs, B in (
                ("flagship", FLAGSHIP, ["--GAN-epochs", "1", "--epochs", "2"], 2, 32),
                ("dialoguernn", DRNN, ["--epochs", "2", "--lr-schedule", "decay"], 2, 30)):
            made.clear()
            out = io.StringIO()
            result = {}
            t0 = time.perf_counter()
            _reset_counts()
            with contextlib.redirect_stdout(out):
                port, n_kernels, busy_ms = _profile_one(
                    torch, lambda: result.update(cli.main(common + argv)))
            counts = _read_counts()
            seconds = time.perf_counter() - t0
            log = out.getvalue().splitlines()
            lines = _check_trainer_run(result, log, epochs, f"{name} --epoch-fused")
            graphs = {g.mode: g.stats() for g in made}
            want_modes = {"stage_a", "train", "eval"} if name == "flagship" else {"train", "eval"}
            if set(graphs) != want_modes:
                fail(f"{name} --epoch-fused made dispatchers {sorted(graphs)}, expected "
                     f"{sorted(want_modes)}")
            # every batch is its shape's eager first batch or a replay; the
            # wrappers count the eager ones, the profiler every kernel run
            train, valid, test = get_iemocap_loaders(data, batch_size=B, valid=0.1, seed=0)
            batches = {"stage_a": len(gan_train), "train": epochs * len(train),
                       "eval": epochs * (len(valid) + len(test))}
            eager = {mode: len(st) for mode, st in graphs.items()}
            replays = {mode: sum(g["replays"] for g in st) for mode, st in graphs.items()}
            if any(eager[m] + replays[m] != batches[m] for m in want_modes):
                fail(f"{name} --epoch-fused ran {eager} eager first batches and {replays} "
                     f"replays, expected {batches} batches in all")
            per = {"stage_a": GAN_STEP_LAUNCHES, "train": STEP_LAUNCHES,
                   "eval": {k: n * k.endswith("fwd") for k, n in STEP_LAUNCHES.items()}}
            want_counts = {k: sum(per[m][k] * eager[m] for m in want_modes) for k in STEP_LAUNCHES}
            want_port = {k: sum(per[m][k] * batches[m] for m in want_modes) for k in STEP_LAUNCHES}
            profiled = _port_calls(port)
            runs[name] = {"epochs": lines, "best_loss": result["best_loss"], "f1": result["f1"],
                          "seconds_profiled": seconds, "graphs": graphs,
                          "eager_first_batches": eager, "replays": replays,
                          "wrapper_launches": counts, "profiled_calls": profiled,
                          "device_kernels": n_kernels, "device_busy_ms": busy_ms}
            if counts != want_counts or profiled != want_port:
                fail(f"{name} --epoch-fused: the wrappers counted {counts} (expected {want_counts},"
                     f" the eager first batches') and the profiler {profiled} calls (expected "
                     f"{want_port}, every batch's)")
            for mode in want_modes & {"stage_a", "train"}:
                lengths = {st["key"][1][1][0] for st in graphs[mode]}
                if lengths != GRAPH_LENGTHS or sum(st["replays"] for st in graphs[mode]) < 1:
                    fail(f"{name} --epoch-fused {mode}: graphs {graphs[mode]}, expected one per "
                         f"length {sorted(GRAPH_LENGTHS)}, replayed")
            if name == "flagship":
                history = load_gan_loss_csv(os.path.join(out_dir, "GAN_loss.csv"))
                missing = [f for n in GEN_NAMES + DISC_NAMES for f in (
                    os.path.join(save_dir, f"{n}.msgpack"),
                    os.path.join(save_dir, "opt", f"{n}.msgpack"))
                    if not os.path.isfile(f)]
                if (len(history) != 1 or missing
                        or not all(math.isfinite(v) for row in history for v in row.values())
                        or not os.path.isfile(result["report_path"])):
                    fail(f"flagship --epoch-fused artifacts: history {history}, missing {missing}")
                runs[name]["gan_loss_csv"] = history
            else:
                if not any("loaded trained GAN" in l for l in log):
                    fail("the DialogueRNN trainer did not load the six networks")
                attn = result["attentions"]
                test = get_iemocap_loaders(data, batch_size=30, valid=0.1, seed=0)[2]
                want = [(b.seq_len, b.n_real, b.seq_len) for b in test]
                for key in ("alpha", "alpha_f", "alpha_b"):
                    if ([a.shape for a in attn[key]] != want
                            or not all(np.isfinite(a).all() for a in attn[key])):
                        fail(f"DialogueRNN --epoch-fused attentions {key}: "
                             f"{[a.shape for a in attn[key]]}, expected {want}")
            emit({"phase": "graphs_cli", "cli": cli.__name__, "argv": argv,
                  **{k: v for k, v in runs[name].items() if k != "graphs"}})
    finally:
        G.ShapeGraphs.__init__ = init
    return runs


def _step_losses(out):
    """A step's losses as floats: stage A's 12 duels, or a classifier's loss."""
    if isinstance(out, dict):
        return [out[f"duel_{i}"].item() for i in range(12)]
    return [out[0].item()]


GRAPH_LR_SCALES = (1.0, 0.5, 0.25)  # set_lr_scale before each of the 3 compared steps


def _run_steps(torch, name: str, graphed: bool, batches, **kw):
    """Losses and parameters after ``build_step(name, graphed, **kw)``,
    deterministic, over ``batches``, the lr scaled by GRAPH_LR_SCALES."""
    from gan_ffn_tpu_torch.cli.step_profile import build_step
    from gan_ffn_tpu_torch.train.optim import set_lr_scale

    step, params, opts = build_step(name, graphed, deterministic=True, **kw)
    losses = []
    for scale, batch in zip(GRAPH_LR_SCALES, batches):
        for opt in opts:
            set_lr_scale(opt, scale)
        losses.append(_step_losses(step(batch)))
    torch.cuda.synchronize()
    if graphed and sum(st["replays"] for st in step.graphs.stats()) != len(batches) - 1:
        fail(f"{name}: the graphed steps did not replay: {step.graphs.stats()}")
    out = losses, {k: p.detach().cpu() for k, p in params.items()}
    del step, params, opts
    torch.cuda.empty_cache()
    return out


def _graphs_vs_eager(torch) -> dict:
    """Each of the three steps at depth 8, rate 0 (deterministic), 3 steps
    from the same weights and batches with the lr scaled by 1, 0.5 and 0.25
    between them (so between replays), graphed against eager: with the same
    capturable Adams at the trainers' eps 1e-8, so the graph is the only
    difference, identical bits; against the per-batch path's plain Adams,
    at eps 1e-3 (where a gradient that is 0 in exact arithmetic, but noise
    of either sign in either Adam's arithmetic, moves a parameter by far
    less than lr), the losses and every parameter within GRAPH_TOL *
    max(1, max |ref|)."""
    from gan_ffn_tpu_torch.cli.step_profile import STEPS, step_batch

    out = {}
    for name, B in STEPS.items():
        rng = np.random.default_rng(7)
        batches = [step_batch(name, rng) for _ in GRAPH_LR_SCALES]
        for against, kw in (("capturable_adam", dict(capturable=True)),
                            ("plain_adam", dict(eps=1e-3))):
            ref_losses, ref = _run_steps(torch, name, False, batches, **kw)
            got_losses, got = _run_steps(torch, name, True, batches, eps=kw.get("eps", 1e-8))
            errs = {k: (got[k] - v).abs().max().item() / max(1.0, v.abs().max().item())
                    for k, v in ref.items()}
            worst = max(errs, key=errs.get)
            loss_err = max(abs(a - b) / max(1.0, abs(b))
                           for la, lb in zip(got_losses, ref_losses) for a, b in zip(la, lb))
            identical = got_losses == ref_losses and all(torch.equal(got[k], v)
                                                         for k, v in ref.items())
            line = {"steps": len(batches), "B": B, "lr_scales": GRAPH_LR_SCALES,
                    "eps": kw.get("eps", 1e-8), "max_loss_rel_err": loss_err,
                    "max_param_rel_err": errs[worst], "worst_param": worst,
                    "identical_bits": identical, "parameters": len(ref)}
            out.setdefault(name, {})[against] = line
            emit({"phase": "graphs_vs_eager", "step": name, "against": against, **line})
            if against == "capturable_adam" and not identical:
                fail(f"{name} graphed against eager with the same capturable Adams: not the "
                     f"same bits (losses {loss_err}, parameter {worst} {errs[worst]})")
            if not (loss_err <= GRAPH_TOL and errs[worst] <= GRAPH_TOL):
                fail(f"{name} graphed against eager ({against}): losses {loss_err}, parameter "
                     f"{worst} {errs[worst]} (limit {GRAPH_TOL} of max(1, max |ref|))")
    return out


def _graphs_replay_inputs(torch) -> dict:
    """Attention and MLP calls, forward and backward, with dropout on,
    captured once at valid_len 112 and replayed at valid_len 90, 1 and 0
    with three seed bases: each replay against its plain version at that
    valid_len and seed, under phase 3's limits (a mask element drawn
    otherwise moves an output by ~1e-2, far past them)."""
    from gan_ffn_tpu_torch.ops import attention as A
    from gan_ffn_tpu_torch.ops import dropout as D
    from gan_ffn_tpu_torch.ops import mlp as Mo

    gen = torch.Generator(device="cuda").manual_seed(8)
    vl = torch.full((), 112, dtype=torch.int32, device="cuda")
    base = torch.zeros((), dtype=torch.int64, device="cuda")
    attn = [tuple(torch.randn(*shape, device="cuda", generator=gen) for _ in range(4))
            for shape in ((32, 10, 112, 10), (32, 8, 112, 64))]
    mlps = [(mlp_inputs(torch, gen, MLP_ROWS, K, Hd, N, site), site_cfg(site, SITE_RATE[site]))
            for K, Hd, N, site in ((512, 2048, 512, "ffn"), (100, 512, 100, "head"))]

    def calls():
        outs = []
        for i, (q, k, v, dout) in enumerate(attn):
            seed = D.SeedRef(base, i)
            outs.append((A.fused_attention(q, k, v, vl, ATTN_RATE, seed),
                         A.fused_attention_backward(q, k, v, dout, vl, ATTN_RATE, seed)))
        for i, ((args, dout), cfg) in enumerate(mlps):
            seed = D.SeedRef(base, len(attn) + i)
            outs.append((Mo.fused_mlp(*args, **cfg, dropout_seed=seed),
                         Mo.fused_mlp_backward(*args, dout, **cfg, dropout_seed=seed)))
        return outs

    calls()  # builds and configures the kernels outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    worst = {"attention_fwd": 0.0, "attention_bwd": 0.0, "mlp_fwd": 0.0, "mlp_bwd": 0.0}
    replays = []
    for valid_len in (90, 1, 0):
        for seed_base in GRAPH_SEEDS:
            vl.fill_(valid_len)
            base.fill_(seed_base)
            graph.replay()
            torch.cuda.synchronize()
            for i, ((q, k, v, dout), (fwd, bwd)) in enumerate(zip(attn, outs)):
                seed = D.derive_seed(seed_base, i)
                err = (fwd - A.attention_plain(q, k, v, valid_len, ATTN_RATE, seed)).abs().max().item()
                gerr = max(max_rel_err(g, w) for g, w in zip(bwd, A.attention_backward_plain(
                    q, k, v, dout, valid_len, ATTN_RATE, seed)))
                worst["attention_fwd"] = max(worst["attention_fwd"], err)
                worst["attention_bwd"] = max(worst["attention_bwd"], gerr)
                if not (err <= ATTN_TOL and gerr <= GRAD_TOL):
                    fail(f"replayed attention {tuple(q.shape)} at valid_len {valid_len}, seed base "
                         f"{seed_base}: forward {err} (limit {ATTN_TOL}), backward {gerr} "
                         f"(limit {GRAD_TOL} relative)")
            for i, (((args, dout), cfg), (fwd, bwd)) in enumerate(zip(mlps, outs[len(attn):])):
                seed = D.derive_seed(seed_base, len(attn) + i)
                rel = max_rel_err(fwd, Mo.mlp_plain(*args, **cfg, dropout_seed=seed))
                gerr = max(max_rel_err(g, w) for g, w in zip(bwd, Mo.mlp_backward_plain(
                    *args, dout, **cfg, dropout_seed=seed)))
                worst["mlp_fwd"] = max(worst["mlp_fwd"], rel)
                worst["mlp_bwd"] = max(worst["mlp_bwd"], gerr)
                if not (rel <= MLP_TOL and gerr <= GRAD_TOL):
                    fail(f"replayed MLP {tuple(args[1].shape)} at seed base {seed_base}: forward "
                         f"{rel} (limit {MLP_TOL} relative), backward {gerr} (limit {GRAD_TOL})")
            replays.append([valid_len, seed_base])
    line = {"phase": "graphs_replay_inputs", "captured_at": {"valid_len": 112, "seed_base": 0},
            "replays": replays, "worst": worst}
    emit(line)
    return line


# each kernel wrapper's call by one launch of its main kernel (the f32 MLP
# backward's dx product, the bf16 one's z1 launch); the bf16 names first
CALL_PATTERNS = (
    ("attention_fwd_bf16", "attention_fwd_bf16_kernel"),
    ("attention_bwd_bf16", "attention_bwd_bf16_kernel"),
    ("mlp_fwd_bf16", "mlp_fwd_bf16_kernel"),
    ("mlp_bwd_bf16", "z1_kernel"),
    ("attention_fwd", "attention_fwd_kernel"),
    ("attention_bwd", "attention_bwd_kernel"),
    ("mlp_fwd", "mlp_fwd_kernel"),
    ("mlp_bwd", "gemm_kernel<false,true,3>"),
    ("mlp_bwd", "gemm_kernel<false,true,kEpiDx>"),
)


def _port_calls(names, kernels=tuple(SOURCES)) -> dict:
    """Calls of each of ``kernels``' wrappers in a Counter of kernel names:
    one launch of its main kernel per call (CALL_PATTERNS)."""
    calls = dict.fromkeys(kernels, 0)
    for name, n in names.items():
        flat = re.sub(r"\(anonymous namespace\)::|<unnamed>::|mlp::|\(Epi\)|Epi\)|\(|\s", "", name)
        for kernel, pattern in CALL_PATTERNS:
            if pattern in flat:
                if kernel in calls:
                    calls[kernel] += n
                break
    return calls


REPLAY_TRACES = 3  # traces of one replay at most, until one counts every kernel
PORT_KERNELS = ("attention_fwd_kernel", "attention_bwd_kernel", "mlp_fwd_kernel",
                "mlp_fwd_reduce_kernel", "gemm_kernel", "reduce_kernel", "pre_kernel",
                "attention_fwd_bf16_kernel", "attention_bwd_bf16_kernel", "mlp_fwd_bf16_kernel",
                "z1_kernel", "colsum_kernel", "gru_gates_fwd_kernel", "gru_gates_bwd_kernel")


def _profiled_calls(names) -> dict:
    """:func:`_port_calls` of the four kernels, and the GRU gate kernels'
    launches by name."""
    gru = {k: sum(n for name, n in names.items() if f"gru_gates_{k[4:]}_kernel" in name)
           for k in GRU_STEP_LAUNCHES}
    return {**_port_calls(names), **gru}


def _profile_one(torch, fn):
    """One ``fn()`` under torch.profiler, tracing the device: a Counter of
    the port's kernels by full name, all device kernels, and the device's
    busy ms (the union of the kernels' intervals)."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    port = collections.Counter(e.name for e in kernels if "at::" not in e.name
                               and any(k in e.name for k in PORT_KERNELS))
    return port, len(kernels), busy / 1e3


def _graphs_steps(torch) -> dict:
    """Each of the three steps at full width, every dropout on: eager (the
    wrappers' counts, one profiled step, host ms) and graphed (capture
    seconds, pool bytes, one profiled replay, host ms per replay): the
    replay launches what the eager step launches."""
    from gan_ffn_tpu_torch.cli.step_profile import STEPS, build_step, step_batch

    out = {}
    for name, B in STEPS.items():
        batch = step_batch(name, np.random.default_rng(9))
        want = {**(GAN_STEP_LAUNCHES if name == "stage_a" else STEP_LAUNCHES),
                **(GRU_STEP_LAUNCHES if name == "dialoguernn"
                   else dict.fromkeys(GRU_STEP_LAUNCHES, 0))}
        step = build_step(name, False)[0]
        counts = _launches_per_step(torch, lambda: step(batch), n=1, read=_read_all_counts)[0]
        # the tracer may lose records of the eager step too (a DialogueRNN
        # step traced 23 of its 24 attention and 26 of its 27 MLP forward
        # calls once, NVIDIA H100 80GB HBM3, 700 W): retraced as a replay is
        eager_attempts = []
        for _ in range(REPLAY_TRACES):
            eager_names, eager_kernels, eager_busy = _profile_one(torch, lambda: step(batch))
            eager_attempts.append({"calls": _profiled_calls(eager_names),
                                   "device_kernels": eager_kernels})
            if eager_attempts[-1]["calls"] == want:
                break
        eager_ms, eager_enqueue = _host_ms(torch, lambda: step(batch), 5)
        del step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = build_step(name, True)[0]
        # the first batch of the shape runs eagerly, then is captured
        # (recorded, not launched), and the second replays
        graph_counts = _launches_per_step(torch, lambda: step(batch), n=2, read=_read_all_counts)
        # the tracer may lose records of a replay's burst of kernels (one
        # stage-A replay traced 581 of its ~15,960 short, NVIDIA H100 80GB
        # HBM3, 700 W) but never adds one: a traced replay that counts
        # each kernel's eager calls exactly is the replay's count
        attempts = []
        for _ in range(REPLAY_TRACES):
            replay_names, replay_kernels, replay_busy = _profile_one(torch, lambda: step(batch))
            attempts.append({"calls": _profiled_calls(replay_names),
                             "device_kernels": replay_kernels})
            if attempts[-1]["calls"] == want:
                break
        graph_ms, graph_enqueue = _host_ms(torch, lambda: step(batch), 10)
        stats = step.graphs.stats()
        line = {
            "phase": "graphs_step", "step": name, "B": B, "L": 112,
            "valid_len": batch["valid_len"].item(), "wrapper_launches": counts,
            "graphed_wrapper_launches": graph_counts,
            "profiled_eager_calls": _profiled_calls(eager_names),
            "profiled_replay_calls": _profiled_calls(replay_names), "replay_traces": attempts,
            "eager_traces": eager_attempts,
            "port_kernel_names": {k: v for k, v in replay_names.items()},
            "eager_device_kernels": eager_kernels, "replay_device_kernels": replay_kernels,
            "eager_host_ms": statistics.median(eager_ms), "eager_host_ms_all": eager_ms,
            "eager_enqueue_ms": statistics.median(eager_enqueue),
            "graphed_host_ms": statistics.median(graph_ms), "graphed_host_ms_all": graph_ms,
            "graphed_enqueue_ms": statistics.median(graph_enqueue),
            "eager_device_busy_ms": eager_busy, "replay_device_busy_ms": replay_busy,
            "capture_seconds": stats[0]["capture_seconds"], "pool_bytes": stats[0]["pool_bytes"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        emit(line)
        del step
        torch.cuda.empty_cache()
        if counts != want:
            fail(f"{name} eager step launched {counts}, expected {want}")
        if graph_counts != [want, dict.fromkeys(want, 0)]:
            fail(f"{name}: the wrappers counted {graph_counts} in the graphed step's first call "
                 f"and first replay, expected {want} (the eager call) and none")
        if line["profiled_eager_calls"] != want or line["profiled_replay_calls"] != want:
            fail(f"{name}: the profiler counts {line['profiled_eager_calls']} calls in the eager "
                 f"step and {line['profiled_replay_calls']} in a replay, expected {want}")
        if replay_names != eager_names:
            fail(f"{name}: a replay launches other port kernels than the eager step")
        out[name] = line
    for name in ("stage_a", "dialoguernn"):
        if not out[name]["graphed_host_ms"] < out[name]["eager_host_ms"]:
            fail(f"{name}: graphed host ms {out[name]['graphed_host_ms']} not below eager "
                 f"{out[name]['eager_host_ms']}")
    return out


def phase_graphs(torch, tmp: str) -> dict:
    """Phase 7: the epoch-fused trainers, graphed against eager, one graph
    at other valid_len and seeds, launches per replay and the timings."""
    summary = {"cli": _graphs_cli(torch, tmp)}
    summary["replay_inputs"] = _graphs_replay_inputs(torch)
    summary["steps"] = _graphs_steps(torch)
    summary["vs_eager"] = _graphs_vs_eager(torch)
    return summary


# ------------------------------------------------------------ phase 8: bf16 --


def _bf16_counters():
    from gan_ffn_tpu_torch.ops import attention as A
    from gan_ffn_tpu_torch.ops import mlp as M

    return {"attention_fwd_bf16": A.attention_fwd_bf16, "mlp_fwd_bf16": M.mlp_fwd_bf16,
            "attention_bwd_bf16": A.attention_bwd_bf16, "mlp_bwd_bf16": M.mlp_bwd_bf16}


def _all_counters():
    return {**_counters(), **_bf16_counters()}


def _bf16_check(torch, got, again, want, what: str) -> dict:
    """A bf16 kernel's output against its plain version's (phase 8's limits)."""
    ref = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    same = (got == want).double().mean().item()  # +0 and -0 as one value
    tol = BF16_TOL * max(1.0, ref)
    if not (err <= tol and same >= BF16_SAME):
        fail(f"{what}: max |diff| {err} (limit {tol}), {same} of the outputs identical "
             f"(limit {BF16_SAME})")
    if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
        fail(f"{what}: two calls differ")
    return {"max_abs_err": err, "max_abs_ref": ref, "identical": same}


def bf16_bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def f64_rate(t: dict, flops: float) -> None:
    """A bf16 MLP kernel's timing row gets its TFLOP/s on the f64 tensor
    cores and their floor, the exact work at 67 TFLOP/s."""
    t["f64_tflops"] = flops / (t["ms"] * 1e-3) / 1e12
    t["f64_floor_ms"] = flops / PEAK_F64_TENSOR_FLOPS * 1e3


def _bf16_kernels(torch) -> dict:
    """Each bf16 kernel against its plain version at the serving shapes
    (B=32, L=112; M=3584) and the DialogueRNN path's (B=30; M=3360), at rate
    0 and the path's rates, timed beside the f32 kernel on the same values
    and (attention) SDPA's bf16 forward.  Returns {kernel: [(launches per
    serving forward, rate-0 timing row)]}, each kernel's rows at the path's
    rate per train step (B=32) and per DialogueRNN step (B=30), and the
    worst max |diff| of each."""
    import torch.nn.functional as F

    from gan_ffn_tpu_torch.ops import attention as A
    from gan_ffn_tpu_torch.ops import mlp as Mo

    rows = {name: [] for name in BF16_SOURCES}
    train_rows = {name: {"step": [], "drnn": []} for name in BF16_SOURCES}  # at the path's rate
    err = dict.fromkeys(BF16_SOURCES, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for (B, H, L, Dh), count in {**ATTN_SHAPES, **DRNN_ATTN_SHAPES}.items():
        q, k, v = (torch.randn(B, H, L, Dh, device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        for rate in (0.0, ATTN_RATE):
            for vl in (L, 90, 1, 0):
                seed = 4000 + vl
                got = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=seed)
                again = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=seed)
                torch.cuda.synchronize()
                line = {"phase": "bf16_kernel", "name": "attention_fwd_bf16", "shape": [B, H, L, Dh],
                        "rate": rate, "valid_len": vl,
                        **_bf16_check(torch, got, again, A.attention_plain(q, k, v, vl, rate, seed),
                                      f"attention_fwd_bf16 {(B, H, L, Dh)} rate={rate} valid_len={vl}")}
                err["attention_fwd_bf16"] = max(err["attention_fwd_bf16"], line["max_abs_err"])
                if vl == L:
                    dvl = torch.full((), vl, dtype=torch.int32, device="cuda")
                    dseed = A.device_seed(seed, q.device)
                    q32, k32, v32 = q.float(), k.float(), v.float()
                    n = B * H * L * Dh
                    t = {"ms": device_time_ms(torch, lambda: A.fused_attention(q, k, v, dvl, rate, dseed)),
                         "f32_kernel_ms": device_time_ms(
                             torch, lambda: A.fused_attention(q32, k32, v32, dvl, rate, dseed)),
                         "plain_ms": device_time_ms(torch, lambda: A.attention_plain(q, k, v, vl, rate, seed)),
                         "library_ms": device_time_ms(torch, lambda: F.scaled_dot_product_attention(
                             q, k, v, dropout_p=rate))}
                    t["bound_ms"], t["bound_by"] = bf16_bound_ms(2 * 4 * n, 2 * 2 * B * H * L * L * Dh)
                    line["timing"] = t
                    if rate == 0.0 and B == 32:
                        rows["attention_fwd_bf16"].append((count, t))
                    elif rate > 0.0:
                        train_rows["attention_fwd_bf16"]["step" if B == 32 else "drnn"].append(
                            (count, t))
                emit(line)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for M, ((K, Hd, N, site), count) in itertools.product((MLP_ROWS, DRNN_MLP_ROWS),
                                                          MLP_SHAPES.items()):
        args32, _ = mlp_inputs(torch, gen, M, K, Hd, N, site)
        args = [t.bfloat16() for t in args32]
        for rate in (0.0, SITE_RATE[site]):
            cfg, seed = site_cfg(site, rate), 5000 + K + N
            got = Mo.fused_mlp(*args, **cfg, dropout_seed=seed)
            again = Mo.fused_mlp(*args, **cfg, dropout_seed=seed)
            torch.cuda.synchronize()
            line = {"phase": "bf16_kernel", "name": "mlp_fwd_bf16", "shape": [M, K, Hd, N],
                    "site": site, "rate": rate,
                    **_bf16_check(torch, got, again, Mo.mlp_plain(*args, **cfg, dropout_seed=seed),
                                  f"mlp_fwd_bf16 {M}x{K}->{Hd}->{N} ({site}) rate={rate}")}
            err["mlp_fwd_bf16"] = max(err["mlp_fwd_bf16"], line["max_abs_err"])
            dseed = Mo.device_seed(seed, args[0].device)
            t = {"ms": device_time_ms(torch, lambda: Mo.fused_mlp(*args, **cfg, dropout_seed=dseed)),
                 "f32_kernel_ms": device_time_ms(
                     torch, lambda: Mo.fused_mlp(*args32, **cfg, dropout_seed=dseed)),
                 "plain_ms": device_time_ms(torch, lambda: Mo.mlp_plain(*args, **cfg, dropout_seed=seed)),
                 "library_ms": None,
                 "workspace_bytes": 4 * Mo.fwd_bf16_workspace_floats(M, K, Hd, N),
                 "launch": Mo.fwd_bf16_launch(M, K, Hd, N)}
            n_bytes, flops = _mlp_bytes_flops(M, K, Hd, N, site == "head", False)
            t["bound_ms"], t["bound_by"] = bf16_bound_ms(n_bytes / 2, flops)  # 2-byte elements
            f64_rate(t, flops)
            line["timing"] = t
            if rate == 0.0:
                if M == MLP_ROWS:
                    rows["mlp_fwd_bf16"].append((count, t))
            else:
                train_rows["mlp_fwd_bf16"]["step" if M == MLP_ROWS else "drnn"].append((count, t))
            emit(line)
    return rows, train_rows, err


def _bf16_artifacts(torch, tmp: str) -> dict:
    """A full-width 8-layer GAN_FFN (phase 4's seed) exported as f32, bf16
    and bf16 with int8 weights, each served on the card with the counts set
    to 0 just before and read just after; the limits of phase 8."""
    from gan_ffn_tpu_torch.models import GAN_FFN
    from gan_ffn_tpu_torch.serving import (ServingClassifier, bf16_variant, dequantize_weights,
                                           export_classifier, quantize_weights_int8)

    model = GAN_FFN(n_classes=6, D_h=100, gen_num_layers=8,
                    generator=torch.Generator().manual_seed(0), device="cpu").eval()
    bf16 = bf16_variant(model)
    paths, sizes = {}, {}
    for name, m, int8 in (("f32", model, False), ("bf16", bf16, False), ("bf16+int8", bf16, True)):
        paths[name] = os.path.join(tmp, f"gan_ffn_{name}.pt")
        export_classifier(m, paths[name], weights_int8=int8)
        sizes[name] = os.path.getsize(paths[name])
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((112, 32, d)).astype(np.float32) for d in (100, 512, 100)]
    small = [x[:64, :4] for x in xs]
    out = {"bytes": sizes, "variants": {}}
    log_probs = {}
    for name, path in paths.items():
        clf = ServingClassifier.load(path, device="cuda", batch_grid=GRID)
        clf.warmup(lengths=(64, 112), batches=(4, 32))
        for fn in _all_counters().values():
            fn.launches = 0
        per_forward = []
        for req in (xs, small):
            before = {k: fn.launches for k, fn in _all_counters().items()}
            lp = clf.log_probs(*req)
            if lp.shape != req[0].shape[:2] + (6,) or not np.isfinite(lp).all():
                fail(f"bf16_serving {name}: log-probs of shape {lp.shape}, finite={np.isfinite(lp).all()}")
            per_forward.append({k: fn.launches - before[k] for k, fn in _all_counters().items()})
        counts = {k: fn.launches for k, fn in _all_counters().items()}
        kernels = ("attention_fwd", "mlp_fwd") if name == "f32" else tuple(BF16_SOURCES)
        want = dict.fromkeys(_all_counters(), 0)
        want.update(zip(kernels, (24, 27)))
        if any(n != want for n in per_forward):
            fail(f"bf16_serving {name}: launches per forward {per_forward}, expected {want}")
        log_probs[name] = clf.log_probs(*xs)
        req_ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            clf.log_probs(*xs)
            req_ms.append((time.perf_counter() - t0) * 1e3)
        dev = [torch.from_numpy(x).cuda() for x in xs]
        with torch.inference_mode():
            fwd_ms = device_time_ms(torch, lambda: clf.model(*dev, valid_len=112), reps=7, group=3)
        ms = statistics.median(req_ms)
        line = {"dtype": clf.dtype, "weights": clf.weights, "bytes": sizes[name],
                "launches": counts, "launches_per_forward": per_forward,
                "request_ms_L112_B32": ms, "request_ms_min": min(req_ms),
                "utterances_per_s": 112 * 32 / (ms / 1e3), "forward_device_ms_L112_B32": fwd_ms}
        if name == "bf16":  # the same artifact on the CPU through the plain versions
            cpu = ServingClassifier.load(path, device="cpu", batch_grid=GRID).log_probs(*small)
            line["card_vs_cpu_max_abs_err"] = float(np.abs(clf.log_probs(*small) - cpu).max())
            if not line["card_vs_cpu_max_abs_err"] <= BF16_E2E_TOL:
                fail(f"bf16 artifact, card against CPU at L=64, B=4: max |diff| "
                     f"{line['card_vs_cpu_max_abs_err']} > {BF16_E2E_TOL}")
        if name == "bf16+int8":  # the live bf16 model with the dequantized weights
            live = bf16_variant(model).cuda().eval()
            state = live.state_dict()
            live.load_state_dict(dequantize_weights(quantize_weights_int8(state), state))
            with torch.inference_mode():
                want_lp = live(*dev, valid_len=112).cpu().numpy()
            line["vs_dequantized_live_max_abs_err"] = float(np.abs(log_probs[name] - want_lp).max())
            if not line["vs_dequantized_live_max_abs_err"] <= INT8_TOL:
                fail(f"int8 artifact against its dequantized live model at L=112, B=32: max |diff| "
                     f"{line['vs_dequantized_live_max_abs_err']} > {INT8_TOL}")
        if name != "f32":
            line["argmax_agreement_vs_f32"] = float(
                (log_probs[name].argmax(-1) == log_probs["f32"].argmax(-1)).mean())
            line["max_abs_diff_vs_f32"] = float(np.abs(log_probs[name] - log_probs["f32"]).max())
        out["variants"][name] = line
        emit({"phase": "bf16_serving", "artifact": name, **line})
    if not sizes["bf16"] < 0.75 * sizes["f32"] or not sizes["bf16+int8"] < 0.45 * sizes["f32"]:
        fail(f"artifact bytes {sizes}: bf16 must be under 0.75x and bf16+int8 under 0.45x f32")
    return out


def _bf16_predict(torch, tmp: str) -> dict:
    """cli/predict.py on phase 5's checkpoint and test split: its F1 equals
    phase 5's best-epoch test F1 (the same model on the same batches); then
    --bf16, its F1 printed beside, with no limit."""
    from gan_ffn_tpu_torch.cli import predict as PREDICT

    reports = sorted(p for p in os.listdir(os.path.join(tmp, "output")) if p.startswith("test_out_"))
    if len(reports) != 1:
        fail(f"phase 5's report: {reports}")
    best_f1 = float(reports[0].split("F1-score=")[1][: -len(".txt")])
    argv = ["--data-path", os.path.join(tmp, "iemocap.pkl"), "--model-save-path",
            os.path.join(tmp, "GAN_save"), "--num-layers", "8", "--batch-size", "32",
            "--device", "cuda"]
    out = {"trainer_best_f1": best_f1}
    for name, extra in (("f32", []), ("bf16", ["--bf16"])):
        for fn in _all_counters().values():
            fn.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            res = PREDICT.main(argv + extra)
        out[name] = {"f1": res["f1"], "dialogues": res["n_dialogues"],
                     "launches": {k: fn.launches for k, fn in _all_counters().items()}}
    emit({"phase": "bf16_predict", **out})
    if out["f32"]["f1"] != best_f1:
        fail(f"cli/predict F1 {out['f32']['f1']} != the trainer's best-epoch test F1 {best_f1}")
    if not out["f32"]["launches"]["mlp_fwd"] or not out["bf16"]["launches"]["mlp_fwd_bf16"]:
        fail(f"cli/predict launched no MLP kernel: {out}")
    return out


def phase_bf16_serving(torch, tmp: str) -> dict:
    rows, train_rows, err = _bf16_kernels(torch)
    serving = _bf16_artifacts(torch, tmp)
    predict = _bf16_predict(torch, tmp)
    return {"rows": rows, "train_rows": train_rows, "err": err, "serving": serving,
            "predict": predict}


# Phase 9: bf16 training


def _bf16_backward_kernels(torch) -> dict:
    """Each bf16 backward kernel against its plain version at every path
    shape (B=32 and B=30 at L=112; M=3584 and 3360 rows), at rate 0 and the
    path's rates, under phase 8's limits; timed at the path's rates (and at
    rate 0 for B=32) beside the f32 kernel on the same values, the plain
    version and, for attention, SDPA's bf16 backward.  Returns the timing
    rows by kernel and path and the worst max |diff| and least identical
    share of each."""
    import torch.nn.functional as F

    from gan_ffn_tpu_torch.ops import attention as A
    from gan_ffn_tpu_torch.ops import mlp as Mo

    rows = {name: {"step": [], "drnn": [], "rate0": []} for name in BF16_TRAIN_SOURCES}
    err = dict.fromkeys(BF16_TRAIN_SOURCES, 0.0)
    same = dict.fromkeys(BF16_TRAIN_SOURCES, 1.0)

    def check(name, got, again, want, what):
        for i, (g, h, w) in enumerate(zip(got, again, want)):
            res = _bf16_check(torch, g, h, w, f"{what} output {i}")
            err[name] = max(err[name], res["max_abs_err"])
            same[name] = min(same[name], res["identical"])

    def keep(name, B, rate, count, t):
        if rate == 0.0:
            if B == 32:
                rows[name]["rate0"].append((count, t))
        else:
            rows[name]["step" if B == 32 else "drnn"].append((count, t))

    gen = torch.Generator(device="cuda").manual_seed(10)
    for (B, H, L, Dh), count in {**ATTN_SHAPES, **DRNN_ATTN_SHAPES}.items():
        q, k, v, dout = (torch.randn(B, H, L, Dh, device="cuda", generator=gen).bfloat16()
                         for _ in range(4))
        for rate in (0.0, ATTN_RATE):
            for vl in (L, 90, 1, 0):
                seed = 6000 + vl
                got = A.fused_attention_backward(q, k, v, dout, vl, rate, seed)
                again = A.fused_attention_backward(q, k, v, dout, vl, rate, seed)
                torch.cuda.synchronize()
                check("attention_bwd_bf16", got, again,
                      A.attention_backward_plain(q, k, v, dout, vl, rate, seed),
                      f"attention_bwd_bf16 {(B, H, L, Dh)} rate={rate} valid_len={vl}")
                if vl != L or (rate == 0.0 and B != 32):
                    continue
                dvl = torch.full((), vl, dtype=torch.int32, device="cuda")
                dseed = A.device_seed(seed, q.device)
                f32 = [x.float() for x in (q, k, v, dout)]
                leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*leaves, dropout_p=rate)
                t = {"ms": device_time_ms(torch, lambda: A.fused_attention_backward(
                        q, k, v, dout, dvl, rate, dseed)),
                     "f32_kernel_ms": device_time_ms(torch, lambda: A.fused_attention_backward(
                         *f32, dvl, rate, dseed)),
                     "plain_ms": device_time_ms(torch, lambda: A.attention_backward_plain(
                         q, k, v, dout, vl, rate, seed)),
                     "library_ms": device_time_ms(torch, lambda: torch.autograd.grad(
                         lib_out, leaves, dout, retain_graph=True))}
                n_bytes, flops = _attention_bytes_flops(B, H, L, Dh, True)
                t["bound_ms"], t["bound_by"] = bf16_bound_ms(n_bytes / 2, flops)  # 2-byte elements
                keep("attention_bwd_bf16", B, rate, count, t)
                emit({"phase": "bf16_train_kernel", "name": "attention_bwd_bf16",
                      "shape": [B, H, L, Dh], "rate": rate, "launches_per_step": count,
                      "timing": t})
    gen = torch.Generator(device="cuda").manual_seed(11)
    for M, ((K, Hd, N, site), count) in itertools.product((MLP_ROWS, DRNN_MLP_ROWS),
                                                          MLP_SHAPES.items()):
        args32, dout32 = mlp_inputs(torch, gen, M, K, Hd, N, site)
        args, dout = [t.bfloat16() for t in args32], dout32.bfloat16()
        for rate in (0.0, SITE_RATE[site]):
            cfg, seed = site_cfg(site, rate), 7000 + K + N
            got = Mo.fused_mlp_backward(*args, dout, **cfg, dropout_seed=seed)
            again = Mo.fused_mlp_backward(*args, dout, **cfg, dropout_seed=seed)
            torch.cuda.synchronize()
            check("mlp_bwd_bf16", got, again,
                  Mo.mlp_backward_plain(*args, dout, **cfg, dropout_seed=seed),
                  f"mlp_bwd_bf16 {M}x{K}->{Hd}->{N} ({site}) rate={rate}")
            if rate == 0.0 and M != MLP_ROWS:
                continue
            dseed = Mo.device_seed(seed, args[0].device)
            t = {"ms": device_time_ms(torch, lambda: Mo.fused_mlp_backward(
                    *args, dout, **cfg, dropout_seed=dseed), reps=11, group=5),
                 "f32_kernel_ms": device_time_ms(torch, lambda: Mo.fused_mlp_backward(
                     *args32, dout32, **cfg, dropout_seed=dseed), reps=11, group=5),
                 "plain_ms": device_time_ms(torch, lambda: Mo.mlp_backward_plain(
                     *args, dout, **cfg, dropout_seed=seed), reps=11, group=5),
                 "library_ms": None,
                 "workspace_bytes": 8 * Mo.bwd_bf16_workspace_doubles(M, K, Hd, N),
                 "split_launches": Mo.bwd_bf16_launches(M, K, Hd, N)}
            n_bytes, flops = _mlp_bytes_flops(M, K, Hd, N, site == "head", True)
            t["bound_ms"], t["bound_by"] = bf16_bound_ms(n_bytes / 2, flops)
            f64_rate(t, flops)
            keep("mlp_bwd_bf16", M // 112, rate, count, t)
            emit({"phase": "bf16_train_kernel", "name": "mlp_bwd_bf16", "shape": [M, K, Hd, N],
                  "site": site, "rate": rate, "launches_per_step": count, "timing": t})
    emit({"phase": "bf16_train_kernels", "max_abs_err": err, "least_identical": same})
    return {"rows": rows, "err": err, "identical": same}


def mlp_relu_branches_bf16(torch, Mo) -> dict:
    """mlp_relu_branches at bf16: the bf16 kernels take the same branch of
    relu' (mlp_bwd_bf16's recomputed z1 against mlp_fwd_bf16's).  Rows are
    x0 plus bf16 noise of 2^-7 (mlp_relu_branches' 1e-6 is lost in bf16),
    W1 as there, b1 = -(x0 W1) in f64 rounded to bf16, W2 = I, b2 = 0: out
    > 0 exactly where the forward's z1 > 0.  dout = 2^r on eight rows (r =
    0 .. 7) and 0 on the others, so db1 = sum_r 2^r relu'(z1[r, j]), a
    whole number below 256, is exact at bf16 and names the rows where relu'
    is 1.  H = 512 on eight-row calls: K = 100 and 512, and K = 100 with the
    generator head's gelu pre chain.  H = 2048 at the path's M = 3584 and
    3360 (one x0 for all rows), K = 100 and 512, with windows of eight rows
    across the row tiles, the partial last one included: there the
    forward's and the recompute's d_ff splits may differ (each line has
    both)."""
    out = {}

    def check(line, differ):
        line["columns_fwd_bwd_differ"] = differ
        emit(line)
        if differ:
            fail(f"bf16 relu branches {line}: mlp_bwd_bf16's z1 takes other branches than "
                 "mlp_fwd_bf16's")
        out[f"M={line['M']},K={line['K']},H={line['H']},pre={line['pre']}"] = line

    def weights(rng, K, H):
        w1 = torch.from_numpy((rng.standard_normal((K, H)) * K ** -0.5).astype(np.float32)).cuda()
        return w1.bfloat16()

    def at_kink(rng, w1, rows, pre):
        """x at relu's kink and its b1, W1 (K, H)."""
        K = w1.shape[0]
        x0 = torch.from_numpy(rng.standard_normal(K).astype(np.float32)).cuda()
        noise = torch.from_numpy(rng.standard_normal((rows, K)).astype(np.float32)).cuda()
        x = (x0 + 2.0 ** -7 * noise).bfloat16()
        t0 = x0.bfloat16().double()
        if pre is not None:
            t0 = torch.nn.functional.gelu(t0)
        return x, (-(t0 @ w1.double())).bfloat16()

    H, groups = 512, 64
    eye = torch.eye(H, device="cuda", dtype=torch.bfloat16)
    zero = torch.zeros(H, device="cuda", dtype=torch.bfloat16)
    dout = (2.0 ** torch.arange(8, device="cuda"))[:, None].expand(8, H).bfloat16().contiguous()
    for K, pre in ((100, None), (512, None), (100, "gelu")):
        cfg = dict(mid=("relu", "act_first", 0.0))
        if pre is not None:
            cfg["pre"] = (pre, 0.0)
        rng = np.random.default_rng(K + 3)
        w1 = weights(rng, K, H)
        differ = positive = 0
        for _ in range(groups):
            x, b1 = at_kink(rng, w1, 8, pre)
            fwd = Mo.fused_mlp(x, w1, b1, eye, zero, **cfg)
            db1 = Mo.fused_mlp_backward(x, w1, b1, eye, zero, dout, **cfg)[2]
            want = (dout.double() * (fwd > 0)).sum(0)
            differ += int((db1.double() != want).sum().item())
            positive += int((fwd > 0).sum().item())
        check({"phase": "bf16_relu_branches", "M": 8, "K": K, "H": H, "pre": pre,
               "z1": groups * 8 * H, "z1_positive": positive}, differ)

    H, windows = 2048, 12
    eye = torch.eye(H, device="cuda", dtype=torch.bfloat16)
    zero = torch.zeros(H, device="cuda", dtype=torch.bfloat16)
    cfg = dict(mid=("relu", "act_first", 0.0))
    for M, K in itertools.product((MLP_ROWS, DRNN_MLP_ROWS), (100, 512)):
        rng = np.random.default_rng(M + K)
        w1 = weights(rng, K, H)
        x, b1 = at_kink(rng, w1, M, None)
        fwd = Mo.fused_mlp(x, w1, b1, eye, zero, **cfg)
        differ = positive = 0
        for r0 in np.linspace(0, M - 8, windows).astype(int).tolist():
            dout = torch.zeros(M, H, device="cuda", dtype=torch.bfloat16)
            dout[r0:r0 + 8] = (2.0 ** torch.arange(8, device="cuda"))[:, None].bfloat16()
            db1 = Mo.fused_mlp_backward(x, w1, b1, eye, zero, dout, **cfg)[2]
            want = (dout.double() * (fwd > 0)).sum(0)
            differ += int((db1.double() != want).sum().item())
            positive += int((fwd[r0:r0 + 8] > 0).sum().item())
        check({"phase": "bf16_relu_branches", "M": M, "K": K, "H": H, "pre": None,
               "z1": windows * 8 * H, "z1_positive": positive,
               "fwd_split": list(Mo.fwd_bf16_split(M, K, H)),
               "z1_split": list(Mo.z1_bf16_split(M, K, H))}, differ)
    return out


def _bf16_counts_check(counts: dict, want: dict, what: str) -> None:
    """A bf16 run's launches: the bf16 kernels at ``want`` (by f32 name),
    every f32 kernel 0 times."""
    expect = {**dict.fromkeys(SOURCES, 0), **{BF16_TWIN[k]: n for k, n in want.items()}}
    if {k: counts[k] for k in expect} != expect:
        fail(f"{what}: launches {counts}, expected {expect} (the bf16 kernels at the f32 "
             "counts, no f32 kernel)")


def _bf16_steps(torch, batch) -> dict:
    """One stage-B train step and one stage-A step at B=32, L=112, depth 8,
    every dropout on, at bf16 and at f32 in turns: launches per step (the
    bf16 twins at the f32 counts, no f32 kernel), host ms and the device's
    busy ms (torch.profiler, union of the kernels' intervals)."""
    from gan_ffn_tpu_torch.cli.common import gan_batch_from
    from gan_ffn_tpu_torch.models import GAN_FFN
    from gan_ffn_tpu_torch.nn.core import set_dropout_generator
    from gan_ffn_tpu_torch.ops.dropout import StepSeeds
    from gan_ffn_tpu_torch.train.gan import GANConfig, init_gan_state, make_gan_train_step

    def stage_b(dtype):
        model = GAN_FFN(n_classes=6, gen_num_layers=8, generator=torch.Generator().manual_seed(1),
                        device="cuda", dtype=dtype)
        set_dropout_generator(model, torch.Generator().manual_seed(2))
        train_step, _ = _steps(torch, model)
        return lambda: train_step(batch)

    def stage_a(dtype):
        state = init_gan_state(GANConfig(num_layers=8, seed=5, dtype=dtype), device="cuda")
        seeds = StepSeeds(torch.Generator().manual_seed(6))
        for module in state.modules.values():
            set_dropout_generator(module, seeds)
        step = make_gan_train_step(state.modules, state.opts)
        gan_batch = gan_batch_from(batch)
        return lambda: step(gan_batch)

    out = {}
    for kind, make, per in (("stage_b", stage_b, STEP_LAUNCHES),
                            ("stage_a", stage_a, GAN_STEP_LAUNCHES)):
        line = {"phase": "bf16_step", "step": kind, "B": 32, "L": 112,
                "valid_len": batch["host_valid_len"]}
        turns = (("bf16", torch.bfloat16), ("f32", None))
        if kind == "stage_b":  # cheap enough to take the turns both ways
            turns += (("bf16_again", torch.bfloat16),)
        for name, dtype in turns:
            step = make(dtype)
            before = {k: fn.launches for k, fn in _all_counters().items()}
            step()
            torch.cuda.synchronize()
            counts = {k: fn.launches - before[k] for k, fn in _all_counters().items()}
            if dtype is not None:
                _bf16_counts_check(counts, per, f"one bf16 {kind} step")
            host_ms, _ = _host_ms(torch, step, 3)
            _, n_kernels, busy = _profile_one(torch, step)
            line[name] = {"launches_per_step": counts, "host_ms": statistics.median(host_ms),
                          "host_ms_all": host_ms, "device_busy_ms": busy,
                          "device_kernels": n_kernels}
            del step
        emit(line)
        out[kind] = line
    return out


def _bf16_trainer_runs(torch, tmp: str) -> dict:
    """Both trainers with --bf16 at full width on phase 5's fixture, every
    dropout on: the flagship per batch (1 stage-A epoch, 1 stage-B epoch)
    and with --epoch-fused (the same, one CUDA graph per shape, traced by
    torch.profiler), the DialogueRNN (B=30, 1 epoch) loading the networks
    the flagship's bf16 run saved.  The counts are set to 0 just before
    each run and read just after."""
    from gan_ffn_tpu_torch.cli import train_iemocap as FLAGSHIP
    from gan_ffn_tpu_torch.cli import train_iemocap_dialoguernn as DRNN
    from gan_ffn_tpu_torch.data import get_iemocap_loaders
    from gan_ffn_tpu_torch.train import graphs as G
    from gan_ffn_tpu_torch.train.gan import DISC_NAMES, GEN_NAMES

    data = os.path.join(tmp, "iemocap.pkl")
    gan_train = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)[0]
    names = tuple(SOURCES) + tuple(BF16_TWIN.values())
    runs = {}
    made = []
    init = G.ShapeGraphs.__init__

    def recording_init(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    G.ShapeGraphs.__init__ = recording_init
    try:
        for name, cli, argv, B in (
                ("flagship", FLAGSHIP, ["--GAN-epochs", "1", "--epochs", "1"], 32),
                ("flagship_epoch_fused", FLAGSHIP, ["--GAN-epochs", "1", "--epochs", "1",
                                                    "--epoch-fused"], 32),
                ("dialoguernn", DRNN, ["--epochs", "1"], 30)):
            save_dir = os.path.join(tmp, "GAN_save_bf16")
            full = argv + ["--bf16", "--num-layers", "8", "--batch-size", str(B), "--seed", "0",
                           "--device", "cuda", "--data-path", data, "--model-save-path", save_dir,
                           "--output-dir", os.path.join(tmp, f"output_bf16_{name}")]
            fused = "--epoch-fused" in argv
            made.clear()
            out, result = io.StringIO(), {}
            for fn in (*_all_counters().values(), *_gru_counters().values()):
                fn.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                if fused:
                    port, _, busy = _profile_one(torch, lambda: result.update(cli.main(full)))
                else:
                    result.update(cli.main(full))
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in _all_counters().items()}
            gru = {k: fn.launches for k, fn in _gru_counters().items()}
            # the DialogueRNN's scan runs the GRU gate kernels at bf16; the flagship none
            if not (min(gru.values()) > 0 if name == "dialoguernn" else not any(gru.values())):
                fail(f"{name} --bf16: GRU gate kernel launches {gru}")
            seconds = time.perf_counter() - t0
            log = out.getvalue().splitlines()
            lines = _check_trainer_run(result, log, 1, f"{name} --bf16")
            train, valid, test = get_iemocap_loaders(data, batch_size=B, valid=0.1, seed=0)
            gan = len(gan_train) if name.startswith("flagship") else 0
            batches = {"stage_a": gan, "train": len(train), "eval": len(valid) + len(test)}
            per = {"stage_a": GAN_STEP_LAUNCHES, "train": STEP_LAUNCHES,
                   "eval": {k: n * k.endswith("fwd") for k, n in STEP_LAUNCHES.items()}}
            run = {"cli": cli.__name__, "argv": argv + ["--bf16"], "epochs": lines,
                   "best_loss": result["best_loss"], "f1": result["f1"], "seconds": seconds,
                   "launches": counts, "gru_launches": gru, "batches": batches}
            if name == "dialoguernn" and not any("loaded trained GAN" in l for l in log):
                fail("the DialogueRNN --bf16 trainer did not load the six networks")
            if name.startswith("flagship"):
                missing = [n for n in GEN_NAMES + DISC_NAMES
                           if not os.path.isfile(os.path.join(save_dir, f"{n}.msgpack"))]
                if missing or not _all_f32(result["checkpoint"]):
                    fail(f"{name} --bf16: missing {missing} or a checkpoint not in f32")
            if not fused:
                want = {k: sum(per[m][k] * n for m, n in batches.items()) for k in STEP_LAUNCHES}
                _bf16_counts_check(counts, want, f"{name} --bf16")
            else:
                graphs = {g.mode: g.stats() for g in made}
                eager = {mode: len(st) for mode, st in graphs.items()}
                replays = {mode: sum(g["replays"] for g in st) for mode, st in graphs.items()}
                if any(eager.get(m, 0) + replays.get(m, 0) != n for m, n in batches.items()):
                    fail(f"{name} --bf16: {eager} eager first batches and {replays} replays, "
                         f"expected {batches} batches")
                _bf16_counts_check(counts, {k: sum(per[m][k] * eager.get(m, 0) for m in batches)
                                            for k in STEP_LAUNCHES}, f"{name} --bf16 (wrappers)")
                profiled = _port_calls(port, names)
                want_all = {k: sum(per[m][k] * n for m, n in batches.items()) for k in STEP_LAUNCHES}
                _bf16_counts_check(profiled, want_all, f"{name} --bf16 (profiler)")
                if sum(replays.values()) < 1:
                    fail(f"{name} --bf16 replayed no graph: {graphs}")
                run.update(eager_first_batches=eager, replays=replays, profiled_calls=profiled,
                           device_busy_ms=busy)
            emit({"phase": "bf16_training", "run": name, **run})
            runs[name] = run
    finally:
        G.ShapeGraphs.__init__ = init
    return runs


def _bf16_step_vs_cpu(torch) -> dict:
    """One deterministic bf16 flagship train step (depth 8, L=64, B=4) on the
    card against the CPU's from the same weights and batch, within the CPU
    tests' limits."""
    from gan_ffn_tpu_torch.models import GAN_FFN

    rng = np.random.default_rng(13)
    L, B = 64, 4
    lengths = np.array([64, 50, 33, 10])
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    host_batch = {
        "audio": rng.standard_normal((L, B, 100)).astype(np.float32),
        "visual": rng.standard_normal((L, B, 512)).astype(np.float32),
        "text": rng.standard_normal((L, B, 100)).astype(np.float32),
        "umask": umask, "label": rng.integers(0, 6, (B, L)) * umask.astype(np.int64),
    }
    res = _step_vs_cpu(torch, GAN_FFN, dict(n_classes=6, gen_num_layers=8, dtype=torch.bfloat16),
                       host_batch, int(lengths.max()), seed=14, loss_tol=BF16_STEP_LOSS_TOL,
                       grad_tol=BF16_STEP_GRAD_TOL)
    emit({"phase": "bf16_train_step_vs_cpu", "L": L, "B": B, **res})
    return res


def phase_bf16_training(torch, tmp: str) -> dict:
    from gan_ffn_tpu_torch.ops import mlp as Mo
    from gan_ffn_tpu_torch.train.loop import batch_to_tensors
    from gan_ffn_tpu_torch.data import get_iemocap_loaders

    kernels = _bf16_backward_kernels(torch)
    branches = mlp_relu_branches_bf16(torch, Mo)
    batch = batch_to_tensors(next(iter(get_iemocap_loaders(
        os.path.join(tmp, "iemocap.pkl"), batch_size=32, valid=0.1, seed=0)[0])), "cuda")
    steps = _bf16_steps(torch, batch)
    runs = _bf16_trainer_runs(torch, tmp)
    vs_cpu = _bf16_step_vs_cpu(torch)
    return {**kernels, "relu_branches": branches, "steps": steps, "runs": runs, "vs_cpu": vs_cpu}


# Phase 10: serving of the DialogueRNN and MELD families, and the MELD trainer
FAMILY_VARIANTS = {"f32": [], "bf16": ["--dtype", "bf16"],
                   "bf16+int8": ["--dtype", "bf16", "--weights", "int8"]}
# launches per DialogueRNN-family serving forward: the variant's own kernels
FAMILY_LAUNCHES = {"f32": {"attention_fwd": 24, "mlp_fwd": 27},
                   "bf16": {"attention_fwd_bf16": 24, "mlp_fwd_bf16": 27}}
MELD_FIXTURE = dict(n_train=96, n_test=32, min_len=3, max_len=33, seed=0)
MELD_WIDTHS = dict(D_m=600, D_e=300, D_h=600, n_classes=7)  # train_MELD.py:143-145


def _family_request(clf, L, B, rng):
    """Random inputs of ``clf``'s family: normal features, one-hot speakers
    and a umask of ragged lengths (the first dialogue L long), both zero past
    each dialogue."""
    lengths = np.maximum(1, rng.integers(L // 2, L + 1, B))
    lengths[0] = L
    um = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    out = []
    for s in clf.inputs:
        if s["kind"] == "feat":
            out.append(rng.standard_normal((L, B, s["dim"])).astype(np.float32))
        elif s["kind"] == "qmask":
            out.append(np.eye(s["dim"], dtype=np.float32)[rng.integers(0, s["dim"], (L, B))]
                       * um.T[:, :, None])
        else:
            out.append(um)
    return out


def _serve_family(torch, name: str, path: str, shapes, warm_lengths, card: str) -> dict:
    """One artifact served on the card through ServingClassifier and the
    HTTP handler: the launches of every kernel per forward (counts set to 0
    just before each request, read just after), log-probs against the same
    artifact on the CPU at ``shapes`` (phase 4's 1e-3; bf16 5e-2), request
    ms at the first shape (median of 20), and the device's busy ms of one
    request (torch.profiler)."""
    from http.server import ThreadingHTTPServer

    from gan_ffn_tpu_torch.cli.serve import make_handler
    from gan_ffn_tpu_torch.serving import ServingClassifier

    clf = ServingClassifier.load(path, device="cuda")
    cpu = ServingClassifier.load(path, device="cpu")
    warm = clf.warmup(lengths=warm_lengths)
    rng = np.random.default_rng(10)
    requests = [_family_request(clf, L, B, rng) for L, B in shapes]
    per_forward, gru_per_forward, errs = [], [], []
    tol = E2E_TOL if clf.dtype == "float32" else BF16_E2E_TOL
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(clf))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for (L, B), xs in zip(shapes, requests):
            for fn in (*_all_counters().values(), *_gru_counters().values()):
                fn.launches = 0
            resp = _post(f"http://127.0.0.1:{server.server_port}/predict",
                         {n: x.tolist() for n, x in zip(clf.input_names, xs)})
            per_forward.append({k: fn.launches for k, fn in _all_counters().items()})
            gru_per_forward.append({k: fn.launches for k, fn in _gru_counters().items()})
            if resp["classes"] != clf.predict(*xs).T.tolist():
                fail(f"{name}: POST /predict (L={L}, B={B}) disagrees with log_probs")
            card_lp, host_lp = clf.log_probs(*xs), cpu.log_probs(*xs)
            if card_lp.shape != (L, B, clf.meta["n_classes"]) or not np.isfinite(card_lp).all():
                fail(f"{name}: log-probs of shape {card_lp.shape} at L={L}, B={B}")
            errs.append(float(np.abs(card_lp - host_lp).max()))
            if not errs[-1] <= tol:
                fail(f"{name}: card vs CPU log-probs at L={L}, B={B}: {errs[-1]} > {tol}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    xs = requests[0]
    req_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        clf.log_probs(*xs)
        req_ms.append((time.perf_counter() - t0) * 1e3)
    _, n_kernels, busy = _profile_one(torch, lambda: clf.log_probs(*xs))
    return {"card": card, "artifact": name, "dtype": clf.dtype, "weights": clf.weights,
            "bytes": os.path.getsize(path), "warmup_shapes": [[L, B] for L, B, _ in warm],
            "shapes": [list(s) for s in shapes], "launches_per_forward": per_forward,
            "gru_launches_per_forward": gru_per_forward, "card_vs_cpu_max_abs_err": errs, "limit": tol,
            "request_ms": statistics.median(req_ms), "request_ms_min": min(req_ms),
            "request_shape": list(shapes[0]), "request_device_busy_ms": busy,
            "request_device_kernels": n_kernels}


def _export_family(torch, model: str, save_dir: str, out_dir: str, extra) -> dict:
    """cli/export.py --model ``model`` --verify on the card in the three
    variants; {variant: (path, the CLI's result)}."""
    from gan_ffn_tpu_torch.cli import export as EXPORT

    out = {}
    for variant, flags in FAMILY_VARIANTS.items():
        path = os.path.join(out_dir, f"{model}_{variant}.pt")
        argv = ["--model", model, "--model-save-path", save_dir, "--output", path, "--verify",
                "--device", "cuda"] + extra + flags
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                res = EXPORT.main(argv)
        except SystemExit as e:
            fail(f"cli/export.py {' '.join(argv)}: {e}\n{log.getvalue()}")
        out[variant] = (path, res)
    return out


def _dialoguernn_family(torch, tmp: str, card: str) -> dict:
    """Path 1: phase 6's checkpoint exported and served in three variants."""
    save_dir = os.path.join(tmp, "GAN_save")
    exported = _export_family(torch, "dialoguernn", save_dir, tmp, ["--num-layers", "8"])
    lines = {}
    for variant, (path, res) in exported.items():
        line = _serve_family(torch, f"dialoguernn {variant}", path, ((112, 30), (50, 7)),
                             (64, 112), card)
        want = dict.fromkeys(_all_counters(), 0)
        want.update(FAMILY_LAUNCHES["f32" if variant == "f32" else "bf16"])
        if any(n != want for n in line["launches_per_forward"]):
            fail(f"dialoguernn {variant}: launches per forward {line['launches_per_forward']}, "
                 f"expected {want}")
        # the scan's three cells a time step of the forward's length, no backward
        if any(n["gru_fwd"] < 3 * L or n["gru_fwd"] % 3 or n["gru_bwd"]
               for n, (L, _) in zip(line["gru_launches_per_forward"], line["shapes"])):
            fail(f"dialoguernn {variant}: GRU gate kernel launches per forward "
                 f"{line['gru_launches_per_forward']} at (L, B) {line['shapes']}")
        line["verify"] = res["verify"]
        emit({"phase": "families", "family": "gan_ffn_dialoguernn", **line})
        lines[variant] = line
    return lines


def _meld_trainer_runs(torch, tmp: str, card: str) -> dict:
    """cli/train_meld.py at its published widths, B=32, on a fixture whose
    batches reach the 33 bucket: 10 epochs per batch, 1 with --epoch-fused
    (traced by torch.profiler), 1 with --bf16; counts set to 0 just before
    each run and read just after: no kernel of the port may launch."""
    from gan_ffn_tpu_torch.cli import train_meld as CLI
    from gan_ffn_tpu_torch.data import get_meld_loaders, write_synthetic_meld

    data = write_synthetic_meld(os.path.join(tmp, "meld.pkl"), **MELD_FIXTURE)
    lengths = {b.seq_len for loader in get_meld_loaders(data, batch_size=32, seed=0)
               for b in loader}
    if 33 not in lengths:
        fail(f"the MELD fixture's batches have lengths {lengths}, none in the 33 bucket")
    runs = {}
    # per batch for 10 epochs: export --verify's argmax agreement (0.98 against
    # the f32 model) means something only on a trained checkpoint, and after 2
    # epochs the test loss is still near ln 7 (near-uniform log-probs)
    for name, extra, epochs in (("per_batch", [], 10), ("epoch_fused", ["--epoch-fused"], 1),
                                ("bf16", ["--bf16"], 1)):
        save_dir = os.path.join(tmp, "GAN_save_meld" if name == "per_batch" else f"meld_{name}")
        argv = ["--data-path", data, "--epochs", str(epochs), "--batch-size", "32", "--seed", "0",
                "--device", "cuda", "--model-save-path", save_dir] + extra
        log = io.StringIO()
        profiled = None
        for fn in _all_counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        holder = {}
        with contextlib.redirect_stdout(log):
            if name == "epoch_fused":  # graph replays launch nothing the wrappers count
                profiled, n_kernels, busy = _profile_one(
                    torch, lambda: holder.update(result=CLI.main(argv)))
            else:
                holder["result"] = CLI.main(argv)
        result = holder["result"]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in _all_counters().items()}
        epoch_lines = [l for l in log.getvalue().splitlines() if l.startswith("epoch ")]
        fields = [dict(zip(l.split()[::2], l.split()[1::2])) for l in epoch_lines]
        finite = all(math.isfinite(float(f[k])) for f in fields for k in ("train_loss", "test_loss"))
        ckpt = os.path.join(save_dir, "meld_classifier_best.msgpack")
        saved = os.path.isfile(ckpt)
        if (len(fields) != epochs or not finite or any(f["valid_loss"] != "nan" for f in fields)
                or not saved or not _all_f32(ckpt)):
            fail(f"train_meld {name}: epochs {epoch_lines}, checkpoint {ckpt} "
                 f"{'written' if saved else 'missing'}")
        by_name = {} if profiled is None else _port_calls(profiled, tuple(_all_counters()))
        if any(counts.values()) or any(by_name.values()):
            fail(f"train_meld {name} launched a kernel of the port: {counts} {by_name}")
        run = {"card": card, "phase": "meld_train", "run": name, "argv": argv[:8] + extra,
               "epochs": epoch_lines, "f1": result["f1"], "best_loss": result["best_loss"],
               "launches": counts, "seconds": seconds}
        if profiled is not None:
            run.update(profiled_port_calls=by_name, device_kernels=n_kernels,
                       device_busy_ms=busy)
        emit(run)
        runs[name] = run
    return runs


def _meld_step_vs_cpu(torch, card: str) -> dict:
    """One deterministic MELD train step (L=33, B=4, a fully padded column)
    on the card against the CPU's from the same weights: f32 and bf16."""
    from gan_ffn_tpu_torch.models import MELDLSTMModel

    rng = np.random.default_rng(12)
    L, B = 33, 4
    lengths = np.array([33, 20, 7, 0])
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    host_batch = {
        "text": rng.standard_normal((L, B, 600)).astype(np.float32) * umask.T[:, :, None],
        "qmask": np.eye(9, dtype=np.float32)[rng.integers(0, 9, (L, B))] * umask.T[:, :, None],
        "umask": umask, "label": rng.integers(0, 7, (B, L)) * umask.astype(np.int64),
    }
    out = {}
    for name, dtype, loss_tol, grad_tol in (("f32", None, E2E_TOL, E2E_TOL),
                                            ("bf16", torch.bfloat16, BF16_STEP_LOSS_TOL,
                                             BF16_STEP_GRAD_TOL)):
        for fn in _all_counters().values():
            fn.launches = 0
        res = _step_vs_cpu(torch, MELDLSTMModel, dict(MELD_WIDTHS, dtype=dtype), host_batch,
                           int(lengths.max()), seed=13, loss_tol=loss_tol, grad_tol=grad_tol)
        if any(fn.launches for fn in _all_counters().values()):
            fail(f"the MELD {name} step launched a kernel of the port")
        out[name] = res
        emit({"phase": "meld_step_vs_cpu", "card": card, "dtype": name, "L": L, "B": B,
              "n_real": 3, "loss_limit": loss_tol, "grad_limit": grad_tol, **res})
    return out


def _meld_family(torch, tmp: str, card: str) -> dict:
    """Path 2's serving: the per-batch run's checkpoint exported and served
    in three variants at exact request lengths."""
    exported = _export_family(torch, "meld", os.path.join(tmp, "GAN_save_meld"), tmp, [])
    lines = {}
    for variant, (path, res) in exported.items():
        line = _serve_family(torch, f"meld {variant}", path, ((33, 30), (7, 3)), (16, 33), card)
        if any(any(n.values()) for n in line["launches_per_forward"]):
            fail(f"meld {variant}: a forward launched a kernel: {line['launches_per_forward']}")
        line["verify"] = res["verify"]
        emit({"phase": "families", "family": "meld_lstm", **line})
        lines[variant] = line
    return lines


def phase_families(torch, tmp: str, card: str) -> dict:
    drnn = _dialoguernn_family(torch, tmp, card)
    runs = _meld_trainer_runs(torch, tmp, card)
    step = _meld_step_vs_cpu(torch, card)
    meld = _meld_family(torch, tmp, card)
    return {"dialoguernn": drnn, "meld_runs": runs, "meld_step": step, "meld": meld}


SWEEP_POINTS = (1, 3, 1)  # --gan-epochs START STOP STEP of phase 11's GAN-epoch sweep
SWEEP_EPOCHS = 2
SWEEP_MEMORY_SLACK = 16 * 2**20  # bytes a later point may hold over the first's


def _per_step_counts(modes: dict) -> dict:
    """Each f32 kernel's calls over ``modes`` ({mode: steps}): stage A's
    per-step counts, a train step's, an eval forward's."""
    per = {"stage_a": GAN_STEP_LAUNCHES, "train": STEP_LAUNCHES,
           "eval": {k: n * k.endswith("fwd") for k, n in STEP_LAUNCHES.items()}}
    return {k: sum(per[m][k] * n for m, n in modes.items()) for k in STEP_LAUNCHES}


def _gan_epoch_sweep(torch, tmp: str, card: str) -> dict:
    """cli/sweep.py --gan-epochs 1 3 1 --epochs 2 at full width on phase 5's
    fixture, --epoch-fused AUTO (one bucket: fused, one CUDA graph per
    shape), traced whole by torch.profiler with the counts set to 0 just
    before it and read just after; its snapshots against one uninterrupted
    2-epoch stage A on the card."""
    from gan_ffn_tpu_torch.cli import sweep as S
    from gan_ffn_tpu_torch.cli.common import generator_weights, train_gan
    from gan_ffn_tpu_torch.data import get_iemocap_loaders
    from gan_ffn_tpu_torch.train import graphs as G
    from gan_ffn_tpu_torch.train.gan import GANConfig
    from gan_ffn_tpu_torch.utils.artifacts import load_gan_loss_csv

    data, out_dir = os.path.join(tmp, "iemocap.pkl"), os.path.join(tmp, "output_sweep")
    start, stop, stride = SWEEP_POINTS
    points = list(range(start, stop + 1, stride))
    argv = ["--gan-epochs", str(start), str(stop), str(stride), "--epochs", str(SWEEP_EPOCHS),
            "--num-layers", "8", "--seed", "0", "--device", "cuda", "--data-path", data,
            "--output-dir", out_dir]
    # each dispatcher call is its shape's eager first batch (a new graph) or
    # a replay; counted without holding the dispatchers, whose graph pools
    # the sweep frees after each point
    batches_seen = {"eager": dict.fromkeys(("stage_a", "train", "eval"), 0),
                    "replays": dict.fromkeys(("stage_a", "train", "eval"), 0)}
    snapshots, holder = {}, {}
    call, real = G.ShapeGraphs.__call__, S.stage_a_snapshots

    def counting_call(self, batch):
        before = len(self.graphs)
        out = call(self, batch)
        batches_seen["eager" if len(self.graphs) > before else "replays"][self.mode] += 1
        return out

    def capture(*args, **kw):
        snaps, history = real(*args, **kw)
        snapshots.update(snaps)
        return snaps, history

    G.ShapeGraphs.__call__, S.stage_a_snapshots = counting_call, capture
    log = io.StringIO()
    try:
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            port, n_kernels, busy = _profile_one(torch, lambda: holder.update(r=S.main(argv)))
        seconds = time.perf_counter() - t0
        counts = _read_counts()
    finally:
        G.ShapeGraphs.__call__, S.stage_a_snapshots = call, real
    results, lines = holder["r"], log.getvalue().splitlines()
    gan_train = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)[0]
    train, _, test = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)
    batches = {"stage_a": stop * len(gan_train),
               "train": len(points) * SWEEP_EPOCHS * len(train),
               "eval": len(points) * SWEEP_EPOCHS * len(test)}
    eager, replays = batches_seen["eager"], batches_seen["replays"]
    want_counts, want_port = _per_step_counts(eager), _per_step_counts(batches)
    profiled = _port_calls(port)
    history = load_gan_loss_csv(os.path.join(out_dir, "GAN_loss.csv"))
    reports = sorted(os.listdir(os.path.join(out_dir, "history")))
    memory = [int(l.split(" device memory ")[1].split(" B ")[0]) for l in lines
              if " device memory " in l]
    stage_a_s = [float(l.split(" in ")[1].rstrip("s")) for l in lines if l.startswith("stage A: ")]
    point_s = [float(l.split("(")[1].split("s)")[0]) for l in lines if l.startswith("GAN-epochs=")
               and "F1=" in l]
    if not any("-> fused" in l for l in lines if l.startswith("--epoch-fused AUTO")):
        fail(f"sweep: AUTO did not fuse phase 5's one-bucket fixture: {lines[:6]}")
    if sorted(results) != points or len(reports) != len(points) or [
            r["epoch"] for r in history] != list(range(stop)):
        fail(f"sweep: results {results}, reports {reports}, GAN_loss.csv epochs "
             f"{[r['epoch'] for r in history]}")
    if any(eager[m] + replays[m] != batches[m] for m in batches) or counts != want_counts \
            or profiled != want_port:
        fail(f"sweep: {eager} eager first batches and {replays} replays of {batches} batches; "
             f"the wrappers counted {counts} (expected {want_counts}), the profiler {profiled} "
             f"(expected {want_port})")
    if len(memory) != len(points) or memory[-1] > memory[0] + SWEEP_MEMORY_SLACK:
        fail(f"sweep: device memory after each point {memory}: not flat")

    # snapshot 2 against one uninterrupted 2-epoch stage A (the sweep seeds
    # torch with --seed + 1 before its stage A, as this does)
    torch.manual_seed(1)
    with contextlib.redirect_stdout(io.StringIO()):
        state, _ = train_gan(GANConfig(num_layers=8, seed=0), gan_train, 2, device="cuda",
                             epoch_fused=True)
    want = generator_weights(state)
    del state
    same = {g: all(torch.equal(snapshots[g][k], v) for k, v in want.items()) for g in points}
    differs_1_3 = not all(torch.equal(snapshots[1][k], v) for k, v in snapshots[3].items())
    line = {"card": card, "phase": "sweep", "cli": "gan_ffn_tpu_torch.cli.sweep", "argv": argv[:6],
            "results": results, "reports": reports, "gan_loss_csv_epochs": len(history),
            "stage_a_seconds": stage_a_s, "point_seconds": point_s, "seconds_profiled": seconds,
            "eager_first_batches": eager, "replays": replays, "wrapper_launches": counts,
            "profiled_calls": profiled, "device_kernels": n_kernels, "device_busy_ms": busy,
            "memory_allocated_after_each_point": memory,
            "snapshot_equals_uninterrupted_2_epochs": same, "snapshot_1_differs_from_3": differs_1_3}
    emit(line)
    if not (same[2] and differs_1_3):
        fail(f"sweep: snapshot 2 equal to an uninterrupted 2-epoch stage A: {same[2]}; "
             f"snapshot 1 differs from 3: {differs_1_3}")
    del snapshots
    torch.cuda.empty_cache()
    return line


def _seed_sweep(torch, tmp: str, card: str) -> dict:
    """cli/seed_sweep.py --seeds 0 1 --epochs 2 --use-trained-GAN at full
    width from phase 5's GAN_save/, then each seed alone: the same best test
    loss and F1 per seed, in bits; the two seeds differ.  Counts set to 0
    just before each run and read just after."""
    from gan_ffn_tpu_torch.cli import seed_sweep as SS
    from gan_ffn_tpu_torch.data import get_iemocap_loaders

    data = os.path.join(tmp, "iemocap.pkl")
    common = ["--epochs", "2", "--use-trained-GAN", "--num-layers", "8", "--seed", "0",
              "--device", "cuda", "--data-path", data,
              "--model-save-path", os.path.join(tmp, "GAN_save")]
    train, _, test = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)
    runs = {}
    for seeds in ((0, 1), (0,), (1,)):
        log = io.StringIO()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            results = SS.main(["--seeds", *map(str, seeds), *common])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _read_counts()
        lines = log.getvalue().splitlines()
        epochs = [l for l in lines if l.startswith("epoch ")]
        loss_line = next((l for l in lines if l.startswith("best test loss per seed:")), "")
        want = _per_step_counts({"train": len(seeds) * 2 * len(train),
                                 "eval": len(seeds) * 2 * len(test)})
        runs[seeds] = {"results": results, "epochs": epochs, "launches": counts,
                       "best_loss": (ast.literal_eval(loss_line.split(":", 1)[1].strip())
                                     if loss_line else None),
                       "epoch_seconds": [float(l.split(" time ")[1].rstrip("s")) for l in epochs],
                       "seconds": seconds}
        if len(epochs) != 2 or counts != want or runs[seeds]["best_loss"] is None:
            fail(f"seed sweep {seeds}: epochs {epochs}, launches {counts} (expected {want})")
    pair = runs[(0, 1)]
    alone = {s: runs[(s,)] for s in (0, 1)}
    same = {s: alone[s]["results"] == {s: pair["results"][s]}
            and alone[s]["best_loss"] == {s: pair["best_loss"][s]} for s in (0, 1)}
    line = {"card": card, "phase": "seed_sweep", "cli": "gan_ffn_tpu_torch.cli.seed_sweep",
            "runs": {"+".join(map(str, k)): v for k, v in runs.items()},
            "each_seed_equals_its_run_alone": same,
            "host_s_per_epoch_two_seeds": pair["epoch_seconds"],
            "host_s_per_epoch_one_seed": {s: alone[s]["epoch_seconds"] for s in (0, 1)}}
    emit(line)
    if not all(same.values()) or pair["best_loss"][0] == pair["best_loss"][1]:
        fail(f"seed sweep: each seed equal to its run alone {same}; best losses {pair['best_loss']}")
    return line


def dp_rank_main(argv) -> None:
    """``chip_smoke.py --dp-rank ARGS``: one rank of python -m
    torch.distributed.run running ``cli/train_iemocap.main(ARGS)``, the
    counts set to 0 just before and printed (a ``dp_rank`` line) just after."""
    import torch

    sys.path.insert(0, REPO)
    from gan_ffn_tpu_torch.cli import train_iemocap as CLI

    _reset_counts()
    result = CLI.main(argv)
    torch.cuda.synchronize()
    emit({"dp_rank": int(os.environ.get("RANK", -1)), "launches": _read_counts(),
          "f1": None if result is None else result["f1"]})


def _dp_trainer(torch, tmp: str, card: str) -> dict:
    """cli/train_iemocap.py --dp under python -m torch.distributed.run
    --standalone --nproc-per-node 1 (NCCL, world size 1) on phase 5's
    fixture: its stage-A loss rows and six networks equal phase 5's run
    without --dp, in bits."""
    from gan_ffn_tpu_torch.data import get_iemocap_loaders
    from gan_ffn_tpu_torch.train.gan import DISC_NAMES, GEN_NAMES
    from gan_ffn_tpu_torch.utils.artifacts import load_gan_loss_csv

    data = os.path.join(tmp, "iemocap.pkl")
    save_dir, out_dir = os.path.join(tmp, "GAN_save_dp"), os.path.join(tmp, "output_dp")
    argv = ["--dp", "--GAN-epochs", "1", "--epochs", "1", "--num-layers", "8", "--batch-size",
            "32", "--seed", "0", "--device", "cuda", "--data-path", data, "--output-dir", out_dir,
            "--model-save-path", save_dir]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "1", os.path.abspath(__file__), "--dp-rank", *argv],
                         cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"--dp under torch.distributed.run exited {res.returncode}:\n{res.stdout[-3000:]}\n"
             f"{res.stderr[-3000:]}")
    lines = res.stdout.splitlines()
    group = [l for l in lines if l.startswith("stage A data parallelism over ")]
    rank_line = next((json.loads(l) for l in lines if l.startswith('{"dp_rank"')), None)
    train, valid, test = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)
    want = _per_step_counts({"stage_a": len(train), "train": len(train),
                             "eval": len(valid) + len(test)})
    rows = load_gan_loss_csv(os.path.join(out_dir, "GAN_loss.csv"))
    plain_rows = load_gan_loss_csv(os.path.join(tmp, "output", "GAN_loss.csv"))
    differ = [n for n in GEN_NAMES + DISC_NAMES
              if not _same_state(torch, os.path.join(save_dir, f"{n}.msgpack"),
                                 os.path.join(tmp, "GAN_save", f"{n}.msgpack"))]
    line = {"card": card, "phase": "dp", "argv": argv[:3], "group": group,
            "single_chip_message": "--dp requested but only one device present; running "
                                   "single-chip" in lines,
            "launches": rank_line and rank_line["launches"], "expected_launches": want,
            "gan_loss_rows": rows, "rows_equal_without_dp": rows == plain_rows,
            "networks_differing_from_without_dp": differ, "seconds": seconds,
            "note": "one card: the NCCL group has one rank, so cross-card equivalence is not "
                    "shown here (the CPU tests hold two gloo ranks to one process and to JAX)"}
    emit(line)
    if (group != ["stage A data parallelism over 1 process(es): rank 0 on cuda:0, backend nccl"]
            or not line["single_chip_message"] or rank_line is None
            or rank_line["launches"] != want or not line["rows_equal_without_dp"] or differ):
        fail(f"--dp under torch.distributed.run: {line}")
    return line


def _all_f32(path: str) -> bool:
    """Every leaf of the msgpack checkpoint ``path`` is float32."""
    from gan_ffn_tpu_torch.utils.checkpoint import all_float32

    return all_float32(path)


def _same_state(torch, a: str, b: str) -> bool:
    from gan_ffn_tpu_torch.utils.checkpoint import read_state_dict

    x, y = (read_state_dict(p) for p in (a, b))
    return x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)


def _dp_step(torch, tmp: str, card: str) -> dict:
    """One stage-A step at B=32, L=112, every dropout on, without a group
    and with an NCCL group of one process (this process as rank 0 of 1), in
    turns (3 steps each, twice): launches, host ms (median of 6) and the
    device's busy ms."""
    import socket

    from gan_ffn_tpu_torch.cli.common import gan_batch_from
    from gan_ffn_tpu_torch.data import get_iemocap_loaders
    from gan_ffn_tpu_torch.parallel.mesh import init_data_parallel, leave
    from gan_ffn_tpu_torch.train.gan import make_gan_train_step
    from gan_ffn_tpu_torch.train.loop import batch_to_tensors

    train = get_iemocap_loaders(os.path.join(tmp, "iemocap.pkl"), batch_size=32, valid=0.1,
                                seed=0)[0]
    batch = gan_batch_from(batch_to_tensors(next(iter(train)), "cuda"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dp = init_data_parallel("cuda")
        steps = {}
        for name in ("plain", "nccl_world_1"):
            state, _ = _gan_state(torch, "cuda", seed=21)
            steps[name] = make_gan_train_step(state.modules, state.opts,
                                              dp=dp if name != "plain" else None)
        out = {name: {"launches": _launches_per_step(torch, lambda s=step: s(batch), n=1)[0],
                      "host_ms": []} for name, step in steps.items()}
        for name in ("plain", "nccl_world_1", "nccl_world_1", "plain"):
            out[name]["host_ms"] += _host_ms(torch, lambda: steps[name](batch), 3)[0]
        for name, step in steps.items():
            _, kernels, busy = _profile_one(torch, lambda s=step: s(batch))
            out[name].update(device_busy_ms=busy, device_kernels=kernels,
                             host_ms_median=statistics.median(out[name]["host_ms"]))
        backend = dp.backend
        leave(dp)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del steps
    torch.cuda.empty_cache()
    line = {"card": card, "phase": "dp_step", "B": 32, "L": 112, "backend": backend, **out,
            "host_ratio": out["nccl_world_1"]["host_ms_median"] / out["plain"]["host_ms_median"]}
    emit(line)
    if backend != "nccl" or any(o["launches"] != GAN_STEP_LAUNCHES for o in out.values()):
        fail(f"the stage-A step with an NCCL group of one: {line}")
    return line


def phase_sweeps(torch, tmp: str, card: str) -> dict:
    """Phase 11: the GAN-epoch sweep, the multi-seed sweep and --dp, on
    phase 5's fixture and networks."""
    return {"sweep": _gan_epoch_sweep(torch, tmp, card), "seed_sweep": _seed_sweep(torch, tmp, card),
            "dp": _dp_trainer(torch, tmp, card), "dp_step": _dp_step(torch, tmp, card)}


CKPT_EPOCHS = 2  # phase 12: the flagship trainer's stage-B epochs from phase 5's files


def _round_trip_files(torch, tmp: str) -> dict:
    """Phase 5's six networks with their Adams and best classifier, and phase
    6's best DialogueRNN classifier (msgpack, the JAX package's format): each
    loads strictly into a fresh full-width module through the port's reader,
    and the port's writer gives the file's bytes back from it.  Then a live
    full-width stage A after one step on the card and a live 8-layer
    ``GAN_FFN``: written, read back into fresh modules, equal in bits
    (parameters, Adam moments and steps), with the host seconds of the six
    networks' write and read."""
    import shutil

    from gan_ffn_tpu_torch.cli.common import gan_batch_from
    from gan_ffn_tpu_torch.models import GAN_FFN, GAN_FFN_DialogueRNN
    from gan_ffn_tpu_torch.train.gan import DISC_NAMES, GEN_NAMES, GANConfig, init_gan_state
    from gan_ffn_tpu_torch.train.loop import batch_to_tensors
    from gan_ffn_tpu_torch.utils import checkpoint as C
    from gan_ffn_tpu_torch.utils.msgpack import to_bytes
    from gan_ffn_tpu_torch.utils.weights import jax_params_from_state_dict

    save_dir, again = os.path.join(tmp, "GAN_save"), os.path.join(tmp, "GAN_save_again")
    state = init_gan_state(GANConfig(num_layers=8, seed=5), device="cuda")
    C.load_gan_state(save_dir, *state, reset_opt=False)
    C.save_gan_state(again, state)
    files = {}
    for name in GEN_NAMES + DISC_NAMES:
        for sub in ("", "opt"):
            a, b = (os.path.join(d, sub, f"{name}.msgpack") for d in (save_dir, again))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                files[os.path.join(sub, name)] = (os.path.getsize(a), fa.read() == fb.read())
    for fname, model in (("classifier_best.msgpack", GAN_FFN(n_classes=6, gen_num_layers=8,
                                                              device="cuda")),
                         ("dialoguernn_classifier_best.msgpack",
                          GAN_FFN_DialogueRNN(n_classes=6, gen_num_layers=8, device="cuda"))):
        path = os.path.join(save_dir, fname)
        C.load_params_any_layout(path, model)
        with open(path, "rb") as f:
            same = f.read() == to_bytes(jax_params_from_state_dict(model))
        files[fname] = (os.path.getsize(path), same)
        del model
    shutil.rmtree(again)

    live, step = _gan_state(torch, "cuda", seed=31)
    step(gan_batch_from(batch_to_tensors(next(iter(_fixture_loader(tmp))), "cuda")))
    torch.cuda.synchronize()
    live_dir = os.path.join(tmp, "GAN_save_live")
    t0 = time.perf_counter()
    C.save_gan_state(live_dir, live)
    write_s = time.perf_counter() - t0
    fresh = init_gan_state(GANConfig(num_layers=8, seed=32), device="cuda")
    t0 = time.perf_counter()
    C.load_gan_state(live_dir, *fresh, reset_opt=False)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(live_dir, sub, f"{n}.msgpack"))
                 for n in GEN_NAMES + DISC_NAMES for sub in ("", "opt"))
    differ = []
    for name, module in live.modules.items():
        got = dict(fresh.modules[name].named_parameters())
        for k, p in module.named_parameters():
            st, st2 = live.opts[name].state[p], fresh.opts[name].state[got[k]]
            if not (torch.equal(got[k], p) and torch.equal(st["exp_avg"], st2["exp_avg"])
                    and torch.equal(st["exp_avg_sq"], st2["exp_avg_sq"])
                    and float(st["step"]) == float(st2["step"])):
                differ.append(f"{name}.{k}")
    model = GAN_FFN(n_classes=6, gen_num_layers=8, generator=torch.Generator().manual_seed(33),
                    device="cuda")
    path = C.save_params(os.path.join(live_dir, "classifier_best.msgpack"), model)
    back = C.load_params_any_layout(path, GAN_FFN(n_classes=6, gen_num_layers=8, device="cuda"))
    differ += [k for k, v in model.state_dict().items() if not torch.equal(back.state_dict()[k], v)]
    shutil.rmtree(live_dir)
    del live, fresh, model, back, step
    torch.cuda.empty_cache()
    line = {"phase": "checkpoint_files", "files": {k: {"bytes": b, "rewritten_in_bits": same}
                                                   for k, (b, same) in files.items()},
            "six_networks_bytes": nbytes, "six_networks_write_s": write_s,
            "six_networks_read_s": read_s, "live_differing": differ}
    emit(line)
    if differ or not all(same for _, same in files.values()):
        fail(f"the msgpack checkpoints did not come back in bits: {line}")
    return line


def _fixture_loader(tmp: str):
    from gan_ffn_tpu_torch.data import get_iemocap_loaders

    return get_iemocap_loaders(os.path.join(tmp, "iemocap.pkl"), batch_size=32, valid=0.1,
                               seed=0)[0]


def _trace_calls(prof_dir: str):
    """The one torch.profiler trace file that ``--profile`` wrote into
    ``prof_dir``: the port's four f32 kernels' calls (kernels by name), its
    device kernels, its bytes, and its kernel launches (runtime and driver
    API records) that have no kernel record, inside the warm-up span and
    outside it."""
    import collections

    from gan_ffn_tpu_torch.utils.profiling import WARMUP

    traces = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        fail(f"--profile wrote {traces} into {prof_dir}, expected one trace")
    with open(os.path.join(prof_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    recorded = {e.get("args", {}).get("correlation") for e in kernels}
    unrecorded = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "Launch" in e.get("name", "")
                  and e.get("args", {}).get("correlation") not in recorded]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == WARMUP and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        fail(f"the --profile trace has {len(spans)} {WARMUP!r} spans, expected one")
    [(a, b)] = spans
    in_warmup = sum(a <= e["ts"] <= b for e in unrecorded)
    lost = {"warmup": in_warmup, "region": len(unrecorded) - in_warmup}
    names = collections.Counter(e["name"] for e in kernels)
    return (_port_calls(names), len(kernels),
            os.path.getsize(os.path.join(prof_dir, traces[0])), lost)


def _checkpoint_trainer(torch, tmp: str, card: str) -> dict:
    """cli/train_iemocap.py --use-trained-GAN --continue-train-GAN-step 0
    --tensorboard --profile DIR --epochs 2 at full width from phase 5's
    msgpack files (a copy): the wrappers' launches (the counts set to 0
    before the run and read after), the profiled epoch 1's kernels by name
    per train step, the TBWriter's state and event files; then cli/predict.py
    on the run's classifier_best.msgpack reproduces its best-epoch F1."""
    import shutil

    from gan_ffn_tpu_torch.cli import predict as PREDICT
    from gan_ffn_tpu_torch.cli import train_iemocap as CLI
    from gan_ffn_tpu_torch.data import get_iemocap_loaders
    from gan_ffn_tpu_torch.utils.tensorboard import TBWriter

    run_dir = os.path.join(tmp, "checkpoint_run")
    save_dir, out_dir, prof = (os.path.join(run_dir, d) for d in ("GAN_save", "output", "prof"))
    shutil.copytree(os.path.join(tmp, "GAN_save"), save_dir)
    data = os.path.join(tmp, "iemocap.pkl")
    argv = ["--use-trained-GAN", "--continue-train-GAN-step", "0", "--tensorboard", "--profile",
            prof, "--epochs", str(CKPT_EPOCHS), "--num-layers", "8", "--batch-size", "32",
            "--seed", "0", "--device", "cuda", "--data-path", data, "--output-dir", out_dir,
            "--model-save-path", save_dir]
    probe = TBWriter(os.path.join(run_dir, "probe"), enabled=True)
    tb_enabled = probe.enabled
    probe.close()
    train, valid, test = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)
    n_steps, n_evals = CKPT_EPOCHS * len(train), CKPT_EPOCHS * (len(valid) + len(test))
    grads = CKPT_EPOCHS if tb_enabled else 0  # one sampled batch's gradients per epoch
    want = {k: per * (n_steps + grads + (n_evals if k.endswith("fwd") else 0))
            for k, per in STEP_LAUNCHES.items()}
    log = io.StringIO()
    t0 = time.perf_counter()
    _reset_counts()
    with contextlib.chdir(run_dir), contextlib.redirect_stdout(log):
        result = CLI.main(argv)
    torch.cuda.synchronize()
    counts = _read_counts()
    seconds = time.perf_counter() - t0
    lines = log.getvalue().splitlines()
    epochs = _check_trainer_run(result, lines, CKPT_EPOCHS, "checkpoint trainer")
    calls, kernels, trace_bytes, unrecorded = _trace_calls(prof)
    per_step = {k: calls[k] / len(train) for k in calls}
    events = [f for f in os.listdir(os.path.join(run_dir, "tensorboard"))
              if f.startswith("events.out.tfevents")] if tb_enabled else []
    reports = [p for p in os.listdir(out_dir) if p.startswith("test_out_")]
    best_f1 = float(reports[0].split("F1-score=")[1][: -len(".txt")]) if len(reports) == 1 else None
    plog = io.StringIO()
    with contextlib.redirect_stdout(plog):
        pred = PREDICT.main(["--data-path", data, "--model-save-path", save_dir, "--num-layers",
                             "8", "--batch-size", "32", "--device", "cuda"])
    line = {"card": card, "phase": "checkpoint_trainer", "argv": argv[:7], "epochs": epochs,
            "loaded": any("loaded trained GAN" in l for l in lines), "seconds": seconds,
            "launches": counts, "expected_launches": want,
            "profiled_train_steps": len(train), "profiled_calls": calls,
            "profiled_calls_per_train_step": per_step, "expected_per_train_step": STEP_LAUNCHES,
            "profiled_device_kernels": kernels, "trace_bytes": trace_bytes,
            "launches_without_kernel_record": unrecorded,
            "tbwriter_enabled": tb_enabled,
            "tbwriter_note": ("torch.utils.tensorboard imports here: event files written"
                              if tb_enabled else "no tensorboard package on this machine: the "
                              "TBWriter is a no-op, as the JAX one is without it"),
            "event_files": events, "trainer_best_f1": best_f1, "predict_f1": pred["f1"]}
    emit(line)
    if (not line["loaded"] or counts != want or unrecorded["region"]
            or any(calls[k] != STEP_LAUNCHES[k] * len(train) for k in STEP_LAUNCHES)
            or (tb_enabled and len(events) != 1) or best_f1 is None or pred["f1"] != best_f1):
        fail(f"the flagship trainer from the msgpack files: {line}")
    return line


def _dp_epoch_step(torch, card: str) -> dict:
    """make_gan_epoch_step(dp=<an NCCL group of one>) for 3 graphed steps
    at depth 8, deterministic, the lr scaled between them, against the
    per-batch DP step with the same capturable Adams: NCCL's all-reduce is
    captured in the stage-A graph and its replays give the same bits, or
    the capture raises (the phase then fails with it)."""
    import socket

    from gan_ffn_tpu_torch.cli.step_profile import step_batch
    from gan_ffn_tpu_torch.parallel.mesh import init_data_parallel, leave

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dp = init_data_parallel("cuda")
        rng = np.random.default_rng(7)
        batches = [step_batch("stage_a", rng) for _ in GRAPH_LR_SCALES]
        t0 = time.perf_counter()
        ref_losses, ref = _run_steps(torch, "stage_a", False, batches, capturable=True, dp=dp)
        got_losses, got = _run_steps(torch, "stage_a", True, batches, dp=dp)
        seconds = time.perf_counter() - t0
        backend = dp.backend
        leave(dp)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    identical = got_losses == ref_losses and all(torch.equal(got[k], v) for k, v in ref.items())
    line = {"card": card, "phase": "dp_epoch_step", "backend": backend, "world": 1,
            "torch": torch.__version__, "nccl": ".".join(map(str, torch.cuda.nccl.version())),
            "steps": len(batches), "depth": 8, "lr_scales": GRAPH_LR_SCALES,
            "outcome": "captured; replays equal the per-batch DP step in bits" if identical
            else "captured; replays differ from the per-batch DP step",
            "identical_bits": identical, "parameters": len(ref), "seconds": seconds,
            "note": "one card: the group has one rank, so the all-reduce sums one slice; "
                    "a capture across cards is not measured"}
    emit(line)
    if backend != "nccl" or not identical:
        fail(f"the data-parallel epoch-fused stage A: {line}")
    return line


def phase_checkpoints(torch, tmp: str, card: str) -> dict:
    """Phase 12: the msgpack checkpoints, --tensorboard and --profile in the
    flagship trainer, and the data-parallel epoch-fused stage A's graph."""
    t0 = time.perf_counter()
    out = {"files": _round_trip_files(torch, tmp),
           "trainer": _checkpoint_trainer(torch, tmp, card),
           "dp_epoch_step": _dp_epoch_step(torch, card)}
    emit({"phase": "checkpoints", "card": card, "seconds": time.perf_counter() - t0})
    return out


# Phase 13: the library-only models at their published widths where the
# reference has them (Emoformer and LSTMModel: text and audio 100, visual 512),
# small elsewhere; each name -> (model class, keyword arguments, input makers)
LIBRARY_L, LIBRARY_B = 32, 8
LIBRARY_VOCAB = 200


def _library_cases(np_rng):
    """``{name: (module path, class, kwargs, inputs)}``: the inputs numpy
    arrays (float features, int64 token ids, a ragged umask) or None."""
    L, B, V = LIBRARY_L, LIBRARY_B, LIBRARY_VOCAB
    lengths = np.linspace(L, L // 4, B).astype(int)
    um = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)

    def feats(d, length=L):
        return np_rng.standard_normal((length, B, d)).astype(np.float32) * (
            um.T[:, :, None] if length == L else 1.0)

    def tokens(*shape):
        return np_rng.integers(1, V, shape).astype(np.int64)

    return {
        "GRU": ("nn", "GRU", dict(input_size=100, hidden_size=100), [feats(100)]),
        "Attention_mlp": ("nn", "Attention", dict(embed_dim=100, score_function="mlp"),
                          [feats(100).transpose(1, 0, 2).copy(), feats(100).transpose(1, 0, 2).copy()]),
        "Attention_bi_linear": ("nn", "Attention", dict(embed_dim=100, score_function="bi_linear"),
                                [feats(100).transpose(1, 0, 2).copy(),
                                 feats(100).transpose(1, 0, 2).copy()]),
        "BiE2EModel": ("models", "BiE2EModel", dict(D_emb=300, D_m=100, D_g=500, D_p=500, D_e=100,
                                                    D_h=100, vocab_size=V, n_classes=7, att2=True,
                                                    context_attention="general2"),
                       [tokens(20, B), tokens(20, B), tokens(20, B)]),
        "LSTMModel2": ("models", "LSTMModel2", dict(D_m=100, D_e=100, D_h=100, n_classes=6,
                                                    attention=True), [feats(100), None, um]),
        "LSTMModel": ("models", "LSTMModel", dict(D_m=100, D_e=100, D_h=100, n_classes=6),
                      [feats(100), feats(100), feats(512), None, um]),
        "CNN": ("models", "CNN", dict(embedding_dim=100, num_filter=100, filter_sizes=(3, 4, 5),
                                      output_dim=6), [feats(100), None, None]),
        "TextCNN": ("models", "TextCNN", dict(sentence_max_size=L, label_num=6), [feats(100)]),
        "FullyConnection": ("models", "FullyConnection", {}, [feats(100)]),
        "Emoformer": ("models", "Emoformer", dict(D_m=100, D_e=100, n_classes=6),
                      [feats(100), feats(100), feats(512), None, um]),
        "CNNFeatureExtractor": ("models", "CNNFeatureExtractor", dict(vocab_size=V),
                                [tokens(L, B, 20), um]),
        "E2ELSTMModel": ("models", "E2ELSTMModel", dict(D_e=100, D_h=100, vocab_size=V,
                                                        n_classes=6, attention=True),
                         [tokens(L, B, 20), None, um]),
    }


def _library_vs_cpu(torch, name, module, cls_name, kwargs, inputs, seed) -> dict:
    """One deterministic forward and backward of the model on the card and
    on the CPU from the same weights: the first output within E2E_TOL of
    max(1, max |ref|), the loss ``sum(out * w)`` within E2E_TOL relative,
    every gradient within E2E_TOL of max(1, max |ref|) and OWN_SCALE_TOL of
    its own max |ref| (phase 6's limits)."""
    import importlib

    cls = getattr(importlib.import_module(f"gan_ffn_tpu_torch.{module}"), cls_name)
    cpu = cls(**kwargs, generator=torch.Generator().manual_seed(seed), device="cpu").eval()
    card = cls(**kwargs, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    results = {}
    for device, model in (("cpu", cpu), ("cuda", card)):
        args = [None if x is None else torch.from_numpy(x).to(device) for x in inputs]
        t0 = time.perf_counter()
        out = model(*args)
        out = out[0] if isinstance(out, (tuple, list)) else out
        w = torch.from_numpy(np.random.default_rng(seed).standard_normal(tuple(out.shape))
                             .astype(np.float32)).to(device)
        loss = (out.float() * w).sum()
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
        results[device] = (out.detach().cpu(), loss.item(), time.perf_counter() - t0,
                           {k: p.grad.cpu() for k, p in model.named_parameters()})
    (out_c, loss_c, _, grads_c), (out_g, loss_g, seconds, grads_g) = results["cpu"], results["cuda"]
    out_err = max_rel_err(out_g, out_c)
    loss_err = abs(loss_g - loss_c) / max(1.0, abs(loss_c))
    errs = {k: max_rel_err(grads_g[k], g) for k, g in grads_c.items()}
    ref = {k: g.abs().max().item() for k, g in grads_c.items()}
    own = {k: ((grads_g[k] - g).abs().max().item() / ref[k]) if ref[k] else
           (0.0 if torch.equal(grads_g[k], g) else math.inf) for k, g in grads_c.items()}
    worst, own_worst = max(errs, key=errs.get), max(own, key=own.get)
    line = {"model": name, "class": cls_name, "config": {k: v for k, v in kwargs.items()},
            "output_shape": list(out_c.shape), "output_rel_err": out_err, "loss_cpu": loss_c,
            "loss_cuda": loss_g, "loss_rel_err": loss_err, "max_grad_rel_err": errs[worst],
            "worst_grad": worst, "max_grad_own_scale_err": own[own_worst],
            "worst_own_scale_grad": own_worst, "parameters": len(grads_c),
            "card_seconds_first_call": seconds, "finite": bool(torch.isfinite(out_g).all())}
    if not (line["finite"] and out_err <= E2E_TOL and loss_err <= E2E_TOL
            and errs[worst] <= E2E_TOL and own[own_worst] <= OWN_SCALE_TOL):
        fail(f"card vs CPU {name}: {line}")
    return line


ENTRY_LAUNCHES = {"attention_fwd": 24, "attention_bwd": 0, "mlp_fwd": 27, "mlp_bwd": 0}


def _graft_entry(torch, card: str) -> dict:
    """entry() on the card against entry("cpu") (the same weights and
    inputs): log-probs within E2E_TOL, 24 / 27 launches a call, host ms."""
    from gan_ffn_tpu_torch.graft_entry import entry

    fn, args = entry()
    _reset_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    counts = _read_counts()
    host_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    cpu_fn, cpu_args = entry("cpu")
    want = cpu_fn(*cpu_args)
    err = (out.cpu() - want).abs().max().item()
    line = {"card": card, "phase": "graft_entry", "shape": list(out.shape), "launches": counts,
            "expected_launches": ENTRY_LAUNCHES, "max_abs_diff_vs_cpu": err,
            "host_ms_median": statistics.median(host_ms), "host_ms": host_ms}
    emit(line)
    if counts != ENTRY_LAUNCHES or not err <= E2E_TOL or list(out.shape) != [112, 32, 6]:
        fail(f"graft entry: {line}")
    return line


def _dryrun(torch, card: str) -> dict:
    """dryrun_multichip over every visible card (NCCL, one rank a card):
    each surface within the JAX dry run's bounds, or it raises."""
    from gan_ffn_tpu_torch.graft_entry import dryrun_multichip

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        report = dryrun_multichip(n)
    line = {"card": card, "phase": "dryrun_multichip", "ranks": n, "report": report,
            "seconds": time.perf_counter() - t0, "printed": log.getvalue().strip()}
    emit(line)
    if report["backend"] != "nccl":
        fail(f"the dry run's group: {line}")
    return line


def _imported_trainer(torch, tmp: str, card: str) -> dict:
    """Reference-shaped stage-A networks (tests/reference_gan_model.py, 8
    layers) pickled whole as the reference saves them, imported by
    cli/import_reference.py, and the flagship trainer run one stage-B epoch
    from them with --use-trained-GAN --continue-train-GAN-step 0 (no more
    stage-A epochs): the networks loaded strictly, the
    launches of every train step and eval forward."""
    import importlib.util
    import shutil

    from gan_ffn_tpu_torch.cli import import_reference as IMPORT
    from gan_ffn_tpu_torch.cli import train_iemocap as CLI
    from gan_ffn_tpu_torch.data import get_iemocap_loaders

    run = os.path.join(tmp, "imported")
    ref_dir, src, save = (os.path.join(run, d) for d in ("reference", "pth", "GAN_save"))
    for d in (ref_dir, src):
        os.makedirs(d)
    shutil.copy(os.path.join(REPO, "tests", "reference_gan_model.py"),
                os.path.join(ref_dir, "model.py"))
    spec = importlib.util.spec_from_file_location("model", os.path.join(ref_dir, "model.py"))
    model = importlib.util.module_from_spec(spec)
    sys.modules["model"] = model
    spec.loader.exec_module(model)
    torch.manual_seed(0)
    classes = {"acoustic_gen": "AcousticGenerator", "visual_gen": "VisualGenerator",
               "text_gen": "TextGenerator", "acoustic_disc": "AcousticDiscriminator",
               "visual_disc": "VisualDiscriminator", "text_disc": "TextDiscriminator"}
    for name, cls in classes.items():
        torch.save(torch.nn.DataParallel(getattr(model, cls)(100, 0.2, num_layers=8)),
                   os.path.join(src, f"{name}.pth"))
    del sys.modules["model"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        written = IMPORT.main(["--src", src, "--dst", save, "--reference", ref_dir])
    import_seconds = time.perf_counter() - t0
    data = os.path.join(tmp, "iemocap.pkl")
    argv = ["--use-trained-GAN", "--continue-train-GAN-step", "0", "--epochs", "1",
            "--num-layers", "8", "--batch-size", "32",
            "--seed", "0", "--device", "cuda", "--data-path", data, "--output-dir",
            os.path.join(run, "output"), "--model-save-path", save]
    train, valid, test = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)
    evals = len(valid) + len(test)
    want = {k: per * (len(train) + (evals if k.endswith("fwd") else 0))
            for k, per in STEP_LAUNCHES.items()}
    log = io.StringIO()
    t0 = time.perf_counter()
    _reset_counts()
    with contextlib.chdir(run), contextlib.redirect_stdout(log):
        result = CLI.main(argv)
    torch.cuda.synchronize()
    counts = _read_counts()
    lines = log.getvalue().splitlines()
    epochs = _check_trainer_run(result, lines, 1, "trainer from imported networks")
    line = {"card": card, "phase": "imported_trainer", "networks": sorted(written),
            "import_seconds": import_seconds, "loaded": any("loaded trained GAN" in l for l in lines),
            "trainer_seconds": time.perf_counter() - t0, "epochs": epochs, "launches": counts,
            "expected_launches": want}
    emit(line)
    if sorted(written) != sorted(classes) or not line["loaded"] or counts != want:
        fail(f"the flagship trainer from imported reference networks: {line}")
    return line


def phase_library(torch, tmp: str, card: str) -> dict:
    """Phase 13: the library-only models on the card against the CPU, the
    graft entry's forward, the data-parallel dry run over every card, and
    the flagship trainer from imported reference networks."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    models = {}
    _reset_counts()
    for i, (name, case) in enumerate(_library_cases(rng).items()):
        before = _read_all_counts()
        models[name] = _library_vs_cpu(torch, name, *case, seed=100 + i)
        after = _read_all_counts()
        models[name]["gru_launches"] = {k: after[k] - before[k] for k in GRU_STEP_LAUNCHES}
        emit({"card": card, "phase": "library_model", **models[name]})
    library_counts = _read_counts()
    if any(library_counts.values()):  # these models have no Pallas kernel behind them
        fail(f"the library-only models launched a kernel of the port: {library_counts}")
    for name in ("GRU", "BiE2EModel"):  # their GRU steps run the GRU gate kernels
        if min(models[name]["gru_launches"].values()) < 1:
            fail(f"{name} on the card did not launch both GRU gate kernels: "
                 f"{models[name]['gru_launches']}")
    out = {"models": models, "entry": _graft_entry(torch, card), "dryrun": _dryrun(torch, card),
           "trainer": _imported_trainer(torch, tmp, card)}
    emit({"phase": "library", "card": card, "seconds": time.perf_counter() - t0,
          "models": len(models)})
    return out


def main() -> None:
    import torch

    started = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card to run on")
    if not os.path.isdir(os.path.join(REPO, "gan_ffn_tpu_torch", "csrc")):
        fail(f"gan_ffn_tpu_torch/ not found beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, REPO)
    from gan_ffn_tpu_torch.utils.runtime import configure_cuda_runtime

    configure_cuda_runtime()

    info = phase_device(torch)
    resources = phase_build()
    rows = Rows()
    phase_kernels_attention(torch, rows)
    phase_kernels_mlp(torch, rows)
    gru_rows = phase_kernels_gru(torch)
    moe_rows = phase_kernels_moe(torch)
    moon_step = phase_moonlight_step(torch)
    serve_counts, fwd_ms = phase_serving(torch)
    with tempfile.TemporaryDirectory() as tmp:
        train_counts, step, gan_step = phase_training(torch, tmp)
        drnn_counts, drnn_step = phase_dialoguernn(torch, tmp)
        graphs = phase_graphs(torch, tmp)
        bf16 = phase_bf16_serving(torch, tmp)
        bf16_train = phase_bf16_training(torch, tmp)
        families = phase_families(torch, tmp, info["nvidia_smi"][0])
        sweeps = phase_sweeps(torch, tmp, info["nvidia_smi"][0])
        checkpoints = phase_checkpoints(torch, tmp, info["nvidia_smi"][0])
        phase_library(torch, tmp, info["nvidia_smi"][0])

    emit({"graphs": {
        "card": info["nvidia_smi"][0],
        "steps": {name: {k: line[k] for k in (
            "B", "L", "eager_host_ms", "graphed_host_ms", "eager_enqueue_ms",
            "graphed_enqueue_ms", "eager_device_busy_ms", "replay_device_busy_ms",
            "capture_seconds", "pool_bytes", "profiled_replay_calls", "replay_device_kernels")}
            for name, line in graphs["steps"].items()},
        "vs_eager": graphs["vs_eager"], "replay_inputs": graphs["replay_inputs"]["worst"],
        "epoch_fused_trainers": {name: {k: run[k] for k in (
            "seconds_profiled", "eager_first_batches", "replays", "wrapper_launches",
            "profiled_calls", "graphs")} for name, run in graphs["cli"].items()},
    }})
    emit({"phase": "total", "card": info["nvidia_smi"][0],
          "seconds": time.perf_counter() - started})
    kernels = []
    for name, step_rows in rows.step.items():
        total = lambda key, rs=step_rows: sum(n * r[key] for n, r in rs)  # noqa: E731
        lib = [r["library_ms"] for _, r in step_rows]
        ms = total("ms")
        drnn = rows.drnn[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
            "launches": train_counts[name], "max_abs_err": rows.err[name],
            "ms": ms, "kernel_ms": ms, "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(step_rows, key=lambda nr: nr[0] * nr[1]["bound_ms"])[1]["bound_by"],
            "library_ms": None if None in lib else total("library_ms"),
            "per": "one train step at B=32, L=112 with the path's dropout rates: "
                   "launches_per_step calls at the shapes of the kernels phase",
            "launches_per_step": sum(n for n, _ in step_rows),
            "share_of_train_step": ms / step["device_ms"],
            "gan_step_launches": gan_step["launches_per_step"][name],
            "dialoguernn_launches": drnn_counts[name],
            "dialoguernn_step_launches": drnn_step["launches_per_step"][name],
            # the epoch-fused trainers' runs, eager first batches and replays
            # (the profiler's count)
            "epoch_fused_launches": sum(run["profiled_calls"][name]
                                        for run in graphs["cli"].values()),
            # the same sums at the DialogueRNN step's shapes (B=30, M=3360)
            "dialoguernn_step_kernel_ms": sum(n * r["ms"] for n, r in drnn),
            "dialoguernn_step_plain_ms": sum(n * r["plain_ms"] for n, r in drnn),
            "dialoguernn_step_bound_ms": sum(n * r["bound_ms"] for n, r in drnn),
            "dialoguernn_step_library_ms": (None if any(r["library_ms"] is None for _, r in drnn)
                                            else sum(n * r["library_ms"] for n, r in drnn)),
        }
        entry.update({  # phase 11: the GAN-epoch sweep (wrappers: eager first batches;
            # profiler: every batch), the seed sweep, and --dp's rank
            "sweep_launches": sweeps["sweep"]["wrapper_launches"][name],
            "sweep_profiled_calls": sweeps["sweep"]["profiled_calls"][name],
            "seed_sweep_launches": sweeps["seed_sweep"]["runs"]["0+1"]["launches"][name],
            "dp_launches": sweeps["dp"]["launches"][name],
        })
        entry.update({  # phase 12: the flagship trainer from msgpack files, --profile's epoch
            "checkpoint_trainer_launches": checkpoints["trainer"]["launches"][name],
            "profiled_calls_per_train_step":
                checkpoints["trainer"]["profiled_calls_per_train_step"][name],
        })
        if name in FAMILY_LAUNCHES["f32"]:  # one DialogueRNN-family serving forward (phase 10)
            entry["dialoguernn_serving_launches_per_forward"] = (
                families["dialoguernn"]["f32"]["launches_per_forward"][0][name])
        if name in rows.serve:
            serve = rows.serve[name]
            entry["serving_launches"] = serve_counts[name]
            entry["serving_forward_ms"] = sum(n * r["ms"] for n, r in serve)
            entry["serving_forward_plain_ms"] = sum(n * r["plain_ms"] for n, r in serve)
            entry["share_of_serving_forward"] = entry["serving_forward_ms"] / fwd_ms
        kernels.append(entry)
    for name, bf16_rows in bf16["rows"].items():
        total = lambda key, rs=bf16_rows: sum(n * r[key] for n, r in rs)  # noqa: E731
        variant = bf16["serving"]["variants"]["bf16"]
        kernels.append({
            "name": name, "route": "cuda", "source": BF16_SOURCES[name][0],
            "replaces": BF16_SOURCES[name][1], "launches": variant["launches"][name],
            "max_abs_err": bf16["err"][name], "ms": total("ms"), "kernel_ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": max(bf16_rows, key=lambda nr: nr[0] * nr[1]["bound_ms"])[1]["bound_by"],
            "library_ms": None if name == "mlp_fwd_bf16" else total("library_ms"),
            "per": "one bf16 serving forward at B=32, L=112 (rate 0): launches_per_forward calls "
                   "at the shapes of the bf16_kernel lines",
            "launches_per_forward": sum(n for n, _ in bf16_rows),
            "f32_kernel_ms": total("f32_kernel_ms"),
            "share_of_bf16_serving_forward": total("ms") / variant["forward_device_ms_L112_B32"],
            "bf16_int8_serving_launches": bf16["serving"]["variants"]["bf16+int8"]["launches"][name],
            "predict_bf16_launches": bf16["predict"]["bf16"]["launches"][name],
            "bf16_training_launches": bf16_train["runs"]["flagship"]["launches"][name],
            "dialoguernn_serving_launches_per_forward": {
                v: families["dialoguernn"][v]["launches_per_forward"][0][name]
                for v in ("bf16", "bf16+int8")},
        })
        if name == "mlp_fwd_bf16":  # the f64 tensor cores' floor and rate over the forward's calls
            kernels[-1]["f64_floor_ms"] = total("f64_floor_ms")
            kernels[-1]["f64_tflops"] = PEAK_F64_TENSOR_FLOPS / 1e12 * total("f64_floor_ms") / total("ms")
        step, drnn = (bf16["train_rows"][name][k] for k in ("step", "drnn"))  # at the path's rate
        lib = name == "attention_fwd_bf16"
        kernels[-1].update({
            "step_kernel_ms": sum(n * r["ms"] for n, r in step),
            "step_plain_ms": sum(n * r["plain_ms"] for n, r in step),
            "step_bound_ms": sum(n * r["bound_ms"] for n, r in step),
            "step_library_ms": sum(n * r["library_ms"] for n, r in step) if lib else None,
            "dialoguernn_step_kernel_ms": sum(n * r["ms"] for n, r in drnn),
            "dialoguernn_step_plain_ms": sum(n * r["plain_ms"] for n, r in drnn),
            "dialoguernn_step_bound_ms": sum(n * r["bound_ms"] for n, r in drnn),
            "dialoguernn_step_library_ms": sum(n * r["library_ms"] for n, r in drnn) if lib else None,
        })
    drnn_graph = graphs["steps"]["dialoguernn"]
    for name, kernel, part in (("gru_fwd", "gru_gates_fwd_kernel", "fwd"),
                               ("gru_bwd", "gru_gates_bwd_kernel", "bwd")):
        # a DialogueRNN train step: each cell's call 112 times at f32 (the
        # backward's g cell 111 times)
        f32 = {cell: gru_rows[(cell, "float32")] for cell in GRU_CELLS}
        calls = {cell: 112 - (part == "bwd" and cell == "g_cell") for cell in GRU_CELLS}
        total = lambda get, f32=f32, calls=calls: sum(n * get(f32[c]) for c, n in calls.items())  # noqa: E731
        kernels.append({
            "name": kernel, "route": "cuda", "source": GRU_SOURCE,
            "replaces": "nn/recurrent.gru_update's chain of torch ops (ops.gru.gru_gates_plain)",
            "launches": drnn_counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in gru_rows.values()),
            "per": "one DialogueRNN train step at B=30, L=112: launches_per_step calls at the "
                   "f32 shapes of the gru_gates kernel lines",
            "launches_per_step": sum(calls.values()),
            "dialoguernn_step_launches": drnn_step["launches_per_step"][name],
            "profiled_replay_calls_per_dialoguernn_step": drnn_graph["profiled_replay_calls"][name],
            "dialoguernn_step_kernel_ms": total(lambda r: r[part]["ms"]),
            "dialoguernn_step_bound_ms": total(lambda r: r[part]["bound_ms"]),
            "bound_by": "bytes",
            "dialoguernn_step_plain_ms": (total(lambda r: r["fwd"]["plain_ms"]) if part == "fwd"
                                          else None),
            "bf16_dialoguernn_training_launches": bf16_train["runs"]["dialoguernn"]["gru_launches"][name],
            "dialoguernn_serving_launches_per_forward": {
                v: families["dialoguernn"][v]["gru_launches_per_forward"][0][name]
                for v in FAMILY_VARIANTS},
        })
    for part, passes in (("fwd", 4), ("bwd", 2)):
        # a Moonlight stage-A step: each text-generator pass calls the op
        # MOE_CALLS_PER_PASS times of each kind
        total = lambda key, part=part, passes=passes: sum(  # noqa: E731
            passes * n * moe_rows[kind][part][key] for kind, n in MOE_CALLS_PER_PASS.items())
        kernels.append({
            "name": f"grouped_swiglu_{part}", "route": "cuda", "source": MOE_SOURCE,
            "replaces": "the per-expert loop (ops.moe.grouped_swiglu_plain); no TPU kernel",
            "kernels": list(MOE_KERNELS[part]),
            "launches": moon_step["launches_per_step"][f"moe_{part}"],
            "max_rel_err": max(max(r["rel_err"].values()) for r in moe_rows.values()),
            "per": f"one Moonlight stage-A step at B=32, L=112: {passes} text-generator passes "
                   "of the calls of MOE_CALLS_PER_PASS at the shapes of the grouped_swiglu lines",
            "moonlight_step_ms": total("ms"), "moonlight_step_bound_ms": total("bound_ms"),
            "moonlight_step_plain_ms": total("plain_ms") if part == "fwd" else None,
        })
    runs = bf16_train["runs"]
    for name, source in BF16_TRAIN_SOURCES.items():
        r = bf16_train["rows"][name]
        total = lambda key, rs=r["step"]: sum(n * x[key] for n, x in rs)  # noqa: E731
        drnn = lambda key, rs=r["drnn"]: sum(n * x[key] for n, x in rs)  # noqa: E731
        lib = name == "attention_bwd_bf16"
        kernels.append({
            "name": name, "route": "cuda", "source": source[0], "replaces": source[1],
            "launches": runs["flagship"]["launches"][name], "max_abs_err": bf16_train["err"][name],
            "least_identical": bf16_train["identical"][name],
            "ms": total("ms"), "kernel_ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(r["step"], key=lambda nr: nr[0] * nr[1]["bound_ms"])[1]["bound_by"],
            "library_ms": total("library_ms") if lib else None,
            "per": "one bf16 stage-B train step at B=32, L=112 with the path's dropout rates: "
                   "launches_per_step calls at the shapes of the bf16_train_kernel lines",
            "launches_per_step": sum(n for n, _ in r["step"]),
            "f32_kernel_ms": total("f32_kernel_ms"),
            "rate0_ms": sum(n * x["ms"] for n, x in r["rate0"]),
            "gan_step_launches": bf16_train["steps"]["stage_a"]["bf16"]["launches_per_step"][name],
            "dialoguernn_launches": runs["dialoguernn"]["launches"][name],
            "epoch_fused_launches": runs["flagship_epoch_fused"]["profiled_calls"][name],
            "dialoguernn_step_kernel_ms": drnn("ms"), "dialoguernn_step_plain_ms": drnn("plain_ms"),
            "dialoguernn_step_bound_ms": drnn("bound_ms"),
            "dialoguernn_step_library_ms": drnn("library_ms") if lib else None,
        })
        if not lib:  # mlp_bwd_bf16: the f64 tensor cores' floor and rate per stage-B step
            kernels[-1]["f64_floor_ms"] = total("f64_floor_ms")
            kernels[-1]["f64_tflops"] = PEAK_F64_TENSOR_FLOPS / 1e12 * total("f64_floor_ms") / total("ms")
    for entry in kernels:  # every variant's registers and spill bytes (ptxas)
        if entry["source"] == GRU_SOURCE:
            variants = [r for r in resources["gru_gates"] if entry["name"] in r["kernel"]]
        elif entry["source"] == MOE_SOURCE:
            variants = [r for r in resources["moe_ffn"]
                        if any(k in r["kernel"] for k in entry["kernels"])]
        else:
            variants = resources.get(entry["name"], [])
        entry["variants"] = [{k: r[k] for k in ("registers", "spill_stores", "spill_loads")}
                             for r in variants]
        entry["registers"] = max((r["registers"] or 0 for r in variants), default=None)
        entry["spill_bytes"] = sum((r["spill_stores"] or 0) + (r["spill_loads"] or 0)
                                   for r in variants)
    for entry in kernels:
        if entry["source"] == GRU_SOURCE:  # the counts themselves are checked in their phases
            paths = [entry["launches"], entry["bf16_dialoguernn_training_launches"]]
            if entry["name"] == "gru_gates_fwd_kernel":  # serving runs no backward
                paths += entry["dialoguernn_serving_launches_per_forward"].values()
            if min(paths) < 1:
                fail(f"{entry['name']} was not launched on every DialogueRNN path: {entry}")
            if not entry["variants"]:
                fail(f"no ptxas resources for {entry['name']} in the gru_gates library's log")
            continue
        if entry["source"] == MOE_SOURCE:  # the counts themselves are checked in phase 3b
            if entry["launches"] < 1 or not entry["variants"]:
                fail(f"{entry['name']}: not launched in the Moonlight step, or no ptxas "
                     f"resources in the moe_ffn library's log: {entry}")
            continue
        if entry["name"] in BF16_SOURCES:
            if entry["launches"] < 1 or entry["predict_bf16_launches"] < 1:
                fail(f"{entry['name']} was not launched on the bf16 serving path")
            if entry["bf16_training_launches"] < 1:
                fail(f"{entry['name']} was not launched on the bf16 training path")
            continue
        if entry["name"] in BF16_TRAIN_SOURCES:
            if min(entry["launches"], entry["gan_step_launches"], entry["dialoguernn_launches"],
                   entry["epoch_fused_launches"]) < 1:
                fail(f"{entry['name']} was not launched on every bf16 training path: {entry}")
            continue
        if entry["launches"] < 1:
            fail(f"{entry['name']} was not launched on the training path")
        if entry["gan_step_launches"] < 1:
            fail(f"{entry['name']} was not launched in the stage-A step")
        if entry["dialoguernn_step_launches"] < 1:
            fail(f"{entry['name']} was not launched in the DialogueRNN train step")
        if entry["epoch_fused_launches"] < 1:
            fail(f"{entry['name']} was not launched in the epoch-fused trainers' runs")
        if min(entry["sweep_launches"], entry["sweep_profiled_calls"],
               entry["seed_sweep_launches"], entry["dp_launches"]) < 1:
            fail(f"{entry['name']} was not launched on every path of phase 11: {entry}")
        if entry["checkpoint_trainer_launches"] < 1:
            fail(f"{entry['name']} was not launched by the trainer of phase 12: {entry}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(sys.argv[2:])
    else:
        main()

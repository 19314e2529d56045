"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve,
train, run scheduled contractions, map/reduce kernels and row chains,
serve a continuous batch over a paged KV pool, train the reference
examples' models, serve the decoder's other modes (int8 weights,
ragged prompts, scoring, beam, speculative and lookup decoding and the
batcher's speculative rounds), train and serve the encoder-decoder and
recurrent models, export, load and profile a model, decode in
chunks and pipelined chunks, each chunk one CUDA graph replay, and run
the parallel layer: tensor-parallel serving and batching, sharded
training, sequence-parallel attention and sharded checkpoints, and run
the Mamba-1 kernels and a hybrid Mamba/attention/expert model, and the
decode step's weight products on the weight-streaming kernel.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. build the port's CUDA kernels from exprgrad_torch/csrc, and beside
   them the generated kernels' launcher (csrc/launch.cpp, the C++
   implementations of the ops that launch B5 and B6);
2. hold the flash-attention kernels (forward; backward dq and dkv)
   against their plain PyTorch versions on the card at the serving shape
   and at GQA, window, rectangular, offset, dead-row, head_dim 36,
   ragged (sq 200, skv 77; GQA h8/hkv2 at sq 300, d 64) and bfloat16
   shapes, check that two backward runs on the same inputs give the same
   bits, and time them at the serving shape (the backward in float32 and
   bfloat16) beside scaled_dot_product_attention and its backward (whose
   kernels torch.profiler names and times at the end of the run);
3. compile the serving model flash_transformer(vocab=2048, dim=512,
   heads=4, hidden=2048, blocks=2, max_seq=256) and drive the main path
   once: "predict" on [8, 256] tokens, then 8 requests of 128-token
   prompts for 128 new tokens through FlashLMServer, greedy and sampled.
   The kernel must launch exactly twice in that run (both in predict:
   decoding attends through plain torch, as in the JAX package), the
   rows must be finite distributions, the result must match the same
   model on the CPU, and the token ids must lie in the vocabulary;
4. time predict and greedy generation, check the server's forward
   against predict on the same tokens, and check that predict at a
   200-token length, which the JAX package routes to plain attention,
   still launches the kernel;
5. train the same model on 32 sequences of 256 tokens: two
   apply("train") steps, which must launch the forward, dq and dkv
   kernels exactly twice each per step and agree with the same steps of
   the CPU port; fit for a few epochs (the loss on the first batch must
   fall); one scan_batches epoch against a per-batch epoch from the same
   state; a checkpoint written from the card must predict the same on
   the CPU; and the time of a train step;
6. hold the scheduled matmul kernel (B1) against its plain version at
   4096^3, ragged 30x50x70 and 1000^3, a transposed store, each extra
   operand pattern of the epilogue (row bias, col broadcast, full
   residual, with relu and select; the residual also at 4095x4097x33)
   and bfloat16 inputs, at its default block, and at every other block
   of its lattice (exprgrad_torch.ops.matmul.BLOCKS) against the default
   block's bits; time it at 4096^3 beside torch.matmul (TF32 off), and
   each block at 4096^3 float32 and 1024^3 bfloat16 beside torch.matmul
   and the bound;
7. path (a): c[y,x] = a[y,it]*b[it,x] at 4096^3 float32 with
   schedule(tile 512) and with schedule(tile 128), compiled with
   schedule_mode="force": one kernel launch per call at the block
   block_for gives, lowering {"matmul": 1}, the product against
   torch.matmul in float64; then Model.autotune of the tile-512 model:
   its TuneReport, the tuned call against float64 (B1 once a call at
   the tuned block, or never where the plain lowering won), and
   export_tuning -> apply_tuning on a fresh compile giving the same
   blocks and bits;
8. path (b): a scheduled MLP at the flash_transformer FFN width (dense
   512->2048, relu, dense 2048->512, residual add, squared error, adam)
   on [2048, 512] rows: predict folds bias, relu and the residual into
   two kernel launches (matmul-fused 2) and matches the CPU port; three
   fit steps agree with the CPU port; the time of a train step; then
   Model.autotune of the train step: the parameters unchanged, B1 on
   the kernels that kept a schedule, and two tuned steps against two
   untuned ones from the same state by phase 5's rule;
9. hold the generated map/reduce kernel (B5) and fused row chain (B6)
   against their plain versions (the port's own lowering of the same
   IR, schedule_mode="ignore") on the card: one program per family of
   the classifier in float32 (ten in bfloat16), then 14 seeds each of
   the JAX package's three map/reduce fuzzers, and bench.py's scatter-add
   with every index on one destination, with 90% on one and with 5%
   outside [0, v); every case runs the generated kernels twice, which
   must give the same bits (a column sum of 1024 rows among the
   families takes B5's split reduction and its combine kernel); the
   launch path: later calls launch from C++, an operand off 16 bytes is
   copied and gives the same bits, a float64 operand raises; and time B6
   at softmax 8192^2 and B5 at bench.py's scatter-add (n=16384, v=2048,
   d=512) beside their plain versions, torch.softmax and index_add;
10. path (c): the programs of examples/scheduled_kernels.py sections 3-9
   and bench.py's two map/reduce cells under schedule_mode="force":
   each launches its kernels once, as its lowering stats say, and
   matches the plain lowering; the warm time of the softmax 8192^2 call;
11. path (d): the flash_transformer head (rms_norm(row_tile=32), dense
   512->2048 scheduled as path (b)'s, softmax(row_tile=32), the
   cross-entropy, adam) on [2048, 512] rows: predict (two row chains,
   one B1 launch) and three fit steps launch the kernels as the stats
   say and agree with the CPU port; the time of a train step; each of
   the step's B5 kernels (none a scatter) timed alone beside its bound
   (bytes over 3.35 TB/s) and a torch call of the same traffic
   (torch.sum of its largest operand over the dims it reduces, or
   torch.mul), with its plan and its PTX's 16-byte loads, and at the end
   of the run its device time and the torch call's by torch.profiler;
12. hold the paged decode-attention kernel (B7) against its plain
   version (decode_attention over gather_view) on the seven cases of
   tests/test_paged_attention.py, path (e)'s decode step, bench.py's
   paged shape and a few edges (the splits' among them: live pages that
   end inside a split, splits with no resident page, a window that ends
   inside a split, int8 pages over six splits, a one-entry table, rows of
   2048 slots at page 16), each run twice for the same bits, and time it
   at path (e)'s decode step and bench.py's shape beside the plain
   version and gather_view + scaled_dot_product_attention; then
   path (e): the serving model behind ContinuousBatcher(slots=8,
   capacity=256, paged=True, page_size=32, pool_pages=32) under
   bench.py's staggered mix of 12 requests.  With attention="flash" B7
   launches once per block per decode dispatch, with "gather" never;
   the pool preempts and every page comes back; with a float32 cache
   the greedy streams of flash, gather and solo generate agree but at
   near-ties of the solo logits; the bfloat16 drives are timed;
13. path (f), the north-star workloads: xor_mlp and xor_from_scratch
   (1000 steps of the examples' SGD) and derivative, at the examples'
   sizes; fashion_mnist_cnn (precision "highest") at bench.py's epoch
   (8192 samples, batch 256, fit(scan_batches=True)), whose fit must
   lower 5 or more kernels to cuDNN convolutions and none to a scatter,
   and at the example's epoch (4096 synthetic samples, batch 32) through
   Batches and fit_epochs(prefetch=2), whose checkpoint a
   CheckpointManager restores on the CPU to predict the same; each
   against the CPU port, as phase 5 holds training; the epochs' seconds
   and samples/s;
14. path (g): flash_transformer at the serving widths with 4 experts,
   top 2: predict on [8, 256] and two adam steps on phase 5's data
   against the CPU port, the flash kernels launching 2 a predict and 2
   each a step; the time of a step;
15. path (h): examples/rnn_lm.py's recurrent LM (its BPE tokenizer and
   text, windows of 24): 10 adam steps of each cell (lstm, gru, tanh)
   against the CPU port, each parameter within 10% of its update; the
   time of a step;
16. hold B7 against its plain version at the shapes a speculative verify
   round gives it (spec_k + 1 query rows a slot: the serving model's 4
   heads at t = 5, GQA 8/2 at t = 5, whose 10 rows take two row blocks,
   MQA 8/1 at t = 9, 72 rows; float32, bfloat16 and int8 pools, with and
   without a window; key_pos live up to the fed position plus spec_k) and
   time it at the serving model's verify shape; then path (i) on phase
   5's trained serving model: Model.quantize_weights (predict within 5%
   relative L2 of full precision, B2 launching twice; train refuses);
   FlashLMServer(weight_dtype=int8) (int8 codes within scale/2, prefill
   logits within 5%, its weight bytes); generate(lengths=) over 8 prompts
   of 48-128 tokens (each row its solo stream but at near-ties; stop_seq
   freezes rows; prompt buckets give the unbucketed tokens); score
   against predict's NLL (rtol 1e-4); generate_beam (best first, each
   score its teacher-forced log-probability within 1e-3, the top beam at
   least greedy's); generate_speculative with a draft of a quarter of the
   width (untrained: every round rewinds; after 30 steps on phase 5's
   data) and with the target as its own draft (at most ceil(63/4)
   rounds), sampled twice for the same tokens; generate_lookup on a
   window of the +1 cycle (fewer rounds than tokens); and path (e)'s
   batcher and mix with draft= (spec_k 4) and lookup=True, flash and
   gather: B7 launches blocks x verify dispatches with "flash" and never
   with "gather", the pool preempts and every page comes back, float32
   greedy streams equal solo generate but at near-ties; the bfloat16
   drives timed beside the plain drive (tokens/s, acceptance), and the
   host's wait at each round's read back by cProfile;
17. path (j), bench.py's seq2seq cell: tiny_seq2seq(vocab 512, dim 256,
   4 heads, hidden 512, max_src 64, max_tgt 65), 8 sources of 64 tokens:
   two adam steps on sequence reversal against the CPU port (B2, B3 and
   B4 three launches each a step: the non-causal encoder, the causal
   decoder, the cross-attention), the timed steps; predict against the
   CPU port; greedy_decode for 64 tokens (B2 at every target width from
   1 to 64); Seq2SeqServer: prefill against predict, greedy against
   greedy_decode, ragged sources of 17-64 tokens against solo, one beam
   against greedy, self-draft speculation against greedy (each but at
   near-ties), score against predict's NLL, int8 weights within 5%
   relative L2; Seq2SeqBatcher(slots=8) over 12 staggered sources of
   16-64 tokens, plain and lookup=True, each stream its solo stream but
   at near-ties; the tokens/s of each;
18. path (k): RecurrentServer on path (h)'s three trained cells, greedy
   against the predict target's argmax chain but at near-ties; tokens/s;
19. the model extras: export_compiled of phase 3's serving predict at
   [8, 256] and of path (a)'s scheduled contraction at 1024^3, then
   load_compiled: each artifact within rtol 1e-5 of model.call and
   running B2 (not sdpa's kernels) or B1 under torch.profiler; save_hlo
   naming the ops exprgrad_torch::flash_fwd and exprgrad_torch::matmul;
   profile writing a Chrome trace that holds B2; the host microseconds a
   call of B2 and B1 through their torch.library ops beside the direct
   launch, in turns; then export_compiled of path (d)'s head predict (B1
   and two B6 a call) and of path (c)'s bench.py scatter-add (one B5
   scatter): each artifact within rtol 1e-5 of model.call, launching the
   generated kernels (counted, and by name), save_hlo naming the ops
   exprgrad_torch::rowchain and exprgrad_torch::mapreduce, and the
   scatter-add's artifact loaded and run in a fresh process that imports
   only exprgrad_torch;
20. path (l): ContinuousBatcher(decode_chunk=N, pipeline=P), each chunk
   dispatch one CUDA graph replay: bench.py's continuous-batching cell
   (capacity 320, pages of 32, a pool of 40, decode_chunk 32, prompts
   bucketed to 192) under path (e)'s mix, flash and gather (float32-cache
   greedy streams equal decode_chunk 1's but at near-ties; bfloat16
   drives timed warm, decode_chunk 1 beside them, one under
   torch.profiler for the busy share and B7's device time a launch);
   bench.py's steady-state sweep over (decode_chunk, pipeline) = (1, 0),
   (8, 0), (32, 0), (32, 4), (128, 0), (128, 1) at capacity 1088 (tokens/s,
   ms a decode step and a dispatch; the pipelined streams equal pipeline
   0's); a windowed model under pipeline 1 against 0.  Graph replays equal
   the chunk dispatches, and B7 launches blocks x (steps a chunk x
   replays + one warm-up step a graph captured);
21. path (m), parallelism on torch.distributed with phase 5's trained
   weights.  (a) A world of one NCCL rank in this process, make_mesh(1):
   FlashLMServer(mesh=) greedy 8x128 -> 128 identical to solo, score
   within rtol 1e-5, one ShardedExecutor train step held against
   apply("train") by phase 5's rule.  (b) Worlds of 2 and 4 spawned
   ranks on this one card over gloo (NCCL refuses two ranks on one GPU;
   gloo's collectives stage CUDA tensors through pinned host memory),
   each with a deadline, a rank that fails failing the script: on a
   (1, 2) mesh, tensor-parallel greedy 8x128 -> 128 with a float32 cache
   (B2 twice a rank in the prefill, at 2 local heads) and the batcher
   under path (e)'s mix (B7 blocks x dispatches a rank), each stream
   solo's but at near-ties, and decode_chunk 32 refused; ring and
   gather sequence-parallel attention at [8, 4, 256, 128] float32,
   causal and window 64, 128 rows a rank, out and gradients against
   one-device B2-B4 at F32_OUT/F32_GRAD (B2 twice a rank a ring
   forward, once a gather forward); path (a)'s matmul at 2048^3 with a
   row shard a rank (B1 once a rank); one ShardedExecutor train step on
   meshes (2, 1) zero, (1, 2) fsdp and (2, 2) offload_opt_state, each
   held against the one-device step by phase 5's rule; save_sharded
   from the 2 x 2 world, load_sharded on (a)'s world of one, predict
   the same.  The times printed beside the card's name and power limit
   show the cost of staging through the host, not a gain.
22. the cost model on the card (exprgrad_torch/backend/policy.py): the
   loaded constants with the card they were measured on; a short run of
   scripts/calibrate_torch.py's calibrate (3 walls a case), each fresh
   constant beside the committed one (printed, not a bound); then under
   schedule_mode="auto" and "force", each from a fresh executor on the
   same device tensors: path (a) at 4096^3 float32, the same contraction
   at 1024^3 and 4096^3 bfloat16, path (b)'s MLP predict, path (c)'s softmax 8192^2
   and scatter-add, path (d)'s head predict and the serving predict.  For
   each, every kernel's decision and reason; the routed program's output
   equal to force's within the path's tolerance; each kernel launched as
   often as the decisions say (B1 once a matmul the model keeps, B5 once
   a kernel, B6 once a chain, B2 twice in the serving predict); every
   routing away a ScheduleWarning and a schedule-fallback stat; the auto
   call's time beside force's (CUDA events, 10 calls, the median of 4
   turns of the two, alternating which goes first).
23. the Mamba-1 kernels (csrc/selective_scan.cu) against their plain
   twins at AI21-Jamba2-Mini's widths (d_inner 8192, d_state 16,
   d_conv 4): ragged prefill rows in a padded bucket with strided x and
   z, and a decode step of 32 slots with parked rows (outputs and
   states within 1e-4 of the largest value; padding and a parked row
   leave the state bit for bit); each timed at a 1024-token prompt and
   a 32-slot decode step beside its bound and its twin; then a toy
   models.jamba hybrid through ContinuousBatcher(paged, flash,
   decode_chunk 4), whose greedy streams equal the solo server's but
   at near-ties, with both kernels' counters set to 0 just before the
   run and each equal after it to the Mamba layers times the steps run
   (eager, and the chunk graphs' replays times their steps); the
   kernels row reports the scan's launches, its conv entry the conv's.
24. the decode step's weight products on the weight-streaming kernel
   (csrc/gemm_skinny_sm90.cu, ops.matmul.weight_product): a toy dense
   SwiGLU model (2 blocks, heads of 128) through ContinuousBatcher(paged,
   flash, decode_chunk 4) on the card, whose greedy streams equal the
   same batcher's on the CPU but at near-ties, with every decode product
   on the kernel (15 a step, eager warm-ups and replays; none declined);
   then the kernel alone at each of the chat cells' 13 decode products
   (``DECODE_GEMMS``: heads in and out, the grouped experts with a
   shared and an own X, the Mamba projections, both heads) at 1, 23 and
   32 rows, each within rtol = atol = 1e-5 of float64 and the same bits
   twice, and at Mistral-7B's w1 at 32 rows timed beside torch.matmul
   and the bound.

B1-B4 compute float32 on the tensor cores as split TF32 and are held
to the same tolerances as the float32 kernels before them
(tests/test_torch_tf32x3.py gives the argument); the bounds of B1-B4
are reckoned at split TF32, 3 x operations over 495 TFLOP/s.  Each path
runs with the kernels' launch counters set to 0 just before it and read
just after.  After the timed phases torch.profiler gives the device
time of every kernel a B5 scatter-add, a B6 softmax and a B7 call
(bench.py's shape, the decode step, the verify round) launch, beside
index_add's, torch.softmax's and the library route's.
It needs a CUDA device and the rest of the repository; without either
it fails.  The line before the
last is the JSON list of kernels (time, bound, plain and library times);
the last line is a JSON object naming the device.
"""

import concurrent.futures
import faulthandler
import json
import math
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# Tolerances of the kernel against its plain version.  float32: both sum
# in float32 in different orders.  bfloat16: both compute in float32 from
# the same bfloat16 inputs and round the output once, so they differ by
# at most about one bfloat16 step (2^-7 relative) of the output.
F32_OUT = dict(rtol=1e-4, atol=1e-5)
F32_LSE_ATOL = 1e-4
BF16_OUT = dict(rtol=2e-2, atol=2e-2)
BF16_LSE_ATOL = 1e-3
# Tolerances of the backward kernels against their plain version.
# float32: dq sums up to 256 kv rows and dk/dv up to 1024 (query rows of
# a GQA group) of products in another order than the plain einsums, and
# the kernels take P from the saved lse where the plain version takes a
# fresh softmax; gradients here are of order 1 to 10.  bfloat16: both
# compute in float32 from the same bfloat16 inputs and round each
# gradient once, about one bfloat16 step (2^-7 relative).
F32_GRAD = dict(rtol=1e-4, atol=1e-4)
BF16_GRAD = dict(rtol=2e-2, atol=2e-2)
# The train step on the card against the CPU port, float32 (TF32 off) on
# both.  One step of plain gradient descent agrees closely (on an H100:
# the loss to 2e-6 relative, each parameter to 5e-5), but adam divides
# each gradient entry by its own running magnitude: an entry within
# float32 rounding of 0 can take either sign, and its parameter then
# moves by +eta or -eta (eta = 0.005), and small entries carry their
# rounding into the update as eta * error / |g|.  After two steps on 8.5M
# parameters more than 5e5 entries differ by more than 1e-4, some by
# 0.017.  So the check holds the whole update, not each entry: the
# difference of the two models' parameters, in L2 norm over all of them,
# within 10% of the norm of the update the steps made; and the loss
# within 1e-3.
TRAIN_UPDATE_RTOL = 0.1
TRAIN_LOSS = dict(rtol=1e-3, atol=0.0)
# predict on the card against predict on the CPU (float32 both ways)
PREDICT = dict(rtol=1e-4, atol=1e-6)


def matmul_f32_tol(k):
    """The matmul kernel against its plain version (a float64 product,
    then the epilogue in float64): float32 accumulation over k terms of
    order one errs by about 1e-7 * sqrt(k) times the sum's scale, so the
    absolute bound grows as sqrt(k)."""
    return dict(rtol=1e-4, atol=1e-5 * math.sqrt(k))


# a bfloat16 output rounds once more than the float64 plain version
MATMUL_BF16_OUT = dict(rtol=1e-2, atol=1e-2)

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# float32 outside the tensor cores, TF32 on the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# float32 products at float32's accuracy on the tensor cores: split TF32
# runs three TF32 products per product (csrc/tf32x3.cuh), so the bound of
# a float32 product is 3 x its operations over the TF32 rate
SPLIT_TF32 = dict(passes=3, rate=PEAK_TF32_FLOPS)

SERVING = dict(vocab=2048, dim=512, heads=4, hidden=2048, blocks=2,
               max_seq=256)
BATCH, SEQ, PROMPT, NEW = 8, 256, 128, 128
TRAIN_SEQS, TRAIN_EPOCHS, TIMED_STEPS = 32, 3, 5
# the scheduled paths: the repo's matmul cell (bench.py) and an MLP at
# the serving model's FFN width on 8 x 256 token rows
MATMUL_N, MATMUL_TILE = 4096, 512
# path (a) also at the tile of the kernel's default block; phase 6 times
# every block at 4096^3 float32 and at this bfloat16 size
MATMUL_TILE_SMALL = 128
BLOCK_BF16_N = 1024
MLP = dict(dim=512, hidden=2048, tile=128)
MLP_ROWS, MLP_STEPS = 2048, 3
# the map/reduce cells of bench.py, and the flash_transformer head at the
# serving width (8 x 256 tokens of dim 512, vocabulary 2048)
SOFTMAX_N = 8192
SCATTER = dict(n=16384, v=2048, d=512, tile={"i": 512, "x": 256})
HEAD = dict(rows=2048, dim=512, vocab=2048)
HEAD_STEPS = 3

# Tolerances of the generated kernels (B5, B6) against their plain
# version, the port's own lowering of the same IR on the card.  float32:
# both compute in float32; sums of up to 32768 terms run in another order
# (a program's blocks, then tl.sum's tree, against torch's reductions).
GEN_F32 = dict(rtol=1e-5, atol=1e-5)
# the softmax rows: every value is below 1 and each row sums 8192 exps
SOFTMAX_TOL = dict(rtol=1e-5, atol=1e-6)
# scatters: the kernel sums each destination's positions in position
# order (in register chains and fixed pieces), the plain lowering in the
# order of torch's indexed accumulation; a target sums up to 16384 values
# (all indices on one destination), of order 1/sqrt(512) each
GEN_SCATTER = dict(rtol=1e-5, atol=1e-5)
# bfloat16: the kernel computes in float32 and rounds once, the plain
# lowering rounds after every op in bfloat16 (2^-8 relative each)
GEN_BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_FAMILIES = ("elementwise", "ragged", "stencil", "gather", "scatter_add",
                 "scatter_max", "scatter_min", "pure_scatter", "softmax",
                 "rms_norm")
# the differential fuzzers' own tolerance (sums of up to 7200 terms of
# exp-scaled products)
GEN_FUZZ = dict(rtol=3e-4, atol=3e-4)
FUZZ_SEEDS = 14

# Phase 12, paged serving.  Path (e): the serving model behind the
# continuous batcher, 8 slots over the model's whole context, pages of 32
# slots and half the dense reservation (32 of 64 pages), so recompute
# preemption must happen; bench.py's staggered mix (bench.py:575-622): 12
# requests, prompts of 48-159 tokens, budgets of 32-95.
BATCHER = dict(slots=8, capacity=256, paged=True, page_size=32,
               pool_pages=32)
MIX = dict(n=12, prompt=(48, 160), budget=(32, 96))
# two greedy streams may part only where the solo run's top two logits are
# this close: float32 sums in another order can flip such a near-tie
NEAR_TIE = 1e-4
# B7's shapes: path (e)'s decode step (8 slots, 4 heads, d 128, tables of 8
# pages of 32, 4 resident a row in the 33-page bfloat16 pool), and
# bench.py:1111's (b 8, hkv 8, group 1, d 128, 16 pages of 128 a row,
# every slot live, a bfloat16 pool of 129 pages)
PAGED_SERVING_CASE = (8, 4, 4, 1, 128, 8, 32, torch.bfloat16)
PAGED_SERVING_LENS = (100, 128, 97, 120, 105, 128, 110, 99)
PAGED_BENCH_CASE = (8, 8, 8, 1, 128, 16, 128, torch.bfloat16)
PAGED_BENCH_LENS = (2048,) * 8
PAGED_BENCH_PAGES = 8 * 16 + 1
# rows of bench.py's paged shape whose live pages end inside a split (1000,
# 1500, 700, 1800 slots) and whose later splits hold no resident page (129
# and 1 slots)
PAGED_SPLIT_LENS = (2048, 1000, 1500, 700, 2000, 129, 1, 1800)

# Phases 13-15, the reference examples' models.  Path (f): the xor
# examples' SGD (rate 0.1, seed 10, examples/xor.py) cut from 5000 steps to
# XOR_STEPS; bench.py's fashion-MNIST epoch (bench.py:1227-1245: 8192
# samples of N(0, 1) from seed 0, batch 256) and the example's
# (examples/fashion_mnist.py:41-53: 4096 synthetic samples, batch 32).
XOR_STEPS = 1000
MNIST_BENCH = dict(n=8192, batch=256)
MNIST_EXAMPLE = dict(n=4096, batch=32, prefetch=2)
# path (g): the serving widths with 4 experts, top 2
# (tests/test_moe_layer.py:143)
MOE = dict(SERVING, moe_experts=4, moe_k=2)
MOE_STEPS = 2
# path (h): examples/rnn_lm.py (its text, BPE to 300, LSTM dim 24 hidden
# 48, eta 0.02, windows of 24 every 4 tokens), 10 steps of each cell
RNN_TEXT = ("the quick brown fox jumps over the lazy dog. "
            "the quick brown fox naps under the lazy sun. ") * 4
RNN = dict(dim=24, hidden=48, eta=0.02)
RNN_SEQ, RNN_STEPS = 24, 10

# Phase 16, path (i): the decoder server's other modes on phase 5's
# trained serving model.  The draft: the serving widths cut to a quarter
# (dim 128, 2 heads, hidden 512, one block) with a seed of its own, once
# untrained (it disagrees: every round rewinds) and once after
# DRAFT_STEPS adam steps on phase 5's data (it agrees often).
DRAFT = dict(vocab=2048, dim=128, heads=2, hidden=512, blocks=1,
             max_seq=256)
DRAFT_SEED, DRAFT_STEPS = 1, 30
SPEC_K, SPEC_NEW, LOOKUP_K = 4, 64, 8
# 8 prompts of 48-128 tokens right-padded to 128, 32 new tokens; beam
# search of 4 beams for 16 tokens after 8 prompts of 128; prompt buckets
RAGGED = dict(n=8, lens=(48, 129), width=128, new=32)
BEAM = dict(prompt=128, beams=4, new=16)
PROMPT_BUCKETS = [64, 128, 256]
# int8 weights against full precision: relative L2 of predict and of the
# prefill logits (the JAX package's bound, tests/test_serve.py:714-719);
# score against the NLL from predict; a beam's score against its
# teacher-forced log-probability
QUANT_REL = 0.05
SCORE_RTOL = 1e-4
BEAM_ATOL = 1e-3
# B7 at a verify round's shape: spec_k + 1 query rows a slot over path
# (e)'s tables (8 slots, 8 pages of 32, d 128): the serving model's 4 heads
# (t = 5, 5 rows a kv head), GQA 8/2 (10 rows: two row blocks) and MQA 8/1
# at lookup's k = 8 (t = 9, 72 rows); each at float32, bfloat16 and int8
# pools, with and without a window
VERIFY_SHAPES = ((4, 4, SPEC_K + 1), (8, 2, SPEC_K + 1), (8, 1, LOOKUP_K + 1))
VERIFY_WINDOW = 40
PAGED_VERIFY_CASE = (8, 4, 4, SPEC_K + 1, 128, 8, 32, torch.bfloat16)
PAGED_VERIFY_LENS = tuple(n + SPEC_K for n in PAGED_SERVING_LENS)

# Phase 17, path (j): bench.py's seq2seq serving cell (bench.py:1022-1053):
# tiny_seq2seq(vocab 512, dim 256, 4 heads, hidden 512, one encoder and
# one decoder block, max_src 64, max_tgt 65), 8 sources of 64 tokens and
# 64 new tokens.  It trains S2S_STEPS adam steps on sequence reversal
# (teacher-forced targets of 64) against the CPU port, then TIMED_STEPS
# more on the card; ragged sources of 17-64 tokens; the batcher serves 12
# staggered sources of 16-64 tokens with budgets of 16-60 (60 + spec_k 4
# fills the 64 positions after BOS that max_tgt 65 holds, so the lookup
# drive takes the same mix).
SEQ2SEQ = dict(vocab=512, dim=256, heads=4, hidden=512, max_src=64,
               max_tgt=65)
S2S_BATCH, S2S_SRC, S2S_NEW, S2S_STEPS = 8, 64, 64, 2
S2S_RAGGED = (17, 65)
S2S_MIX = dict(n=12, src=(16, 65), budget=(16, 61), slots=8)
# Phase 18, path (k): RecurrentServer on path (h)'s trained cells, the
# first 8 windows as prompts
RNN_SERVE = dict(batch=8, new=32)
# Phase 19: path (a)'s scheduled contraction, exported at a width that
# keeps the phase short
EXPORT_MATMUL_N = 1024

# Phase 20, path (l): multi-step and pipelined decode, one CUDA graph
# replay a chunk dispatch.  bench.py's continuous-batching cell
# (bench.py:575-622): the serving widths at max_seq = capacity 320, 8
# slots, pages of 32, a pool of half the dense reservation (8 * 10 // 2 =
# 40 pages), decode_chunk 32, prompts bucketed to 192, under path (e)'s
# staggered mix; and its steady-state sweep (bench.py:632-700): capacity
# 64 + 1024, 8 prompts of 64 with budgets of 1024, a pool of 8 * 34 pages,
# STEADY_CONFIGS of (decode_chunk, pipeline), the timed window of
# bench.py's formula; the pairs in STEADY_FULL then run to the end, for
# their streams.  A windowed model (window 64) at the cell's settings with
# decode_chunk 8, under pipeline 1 and 0.
CB_CELL = dict(slots=8, capacity=320, paged=True, page_size=32,
               pool_pages=8 * (320 // 32) // 2, decode_chunk=32,
               prompt_buckets=(192,))
STEADY = dict(slots=8, prompt=64, budget=1024, page_size=32)
STEADY_CONFIGS = ((1, 0), (8, 0), (32, 0), (32, 4), (128, 0), (128, 1))
STEADY_FULL = ((32, 0), (32, 4), (128, 0), (128, 1))
CB_WINDOW, CB_WINDOW_CHUNK = 64, 8


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, iters=50, warmup=5) -> float:
    """Mean milliseconds per call by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls=200) -> float:
    """Host microseconds per call of ``fn``, enqueue only (no synchronize
    inside the timed calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def compare(name, got, want, out_tol, lse_atol) -> float:
    """Assert kernel == plain within tolerance; returns max |out error|."""
    (out, lse), (ref_out, ref_lse) = got, want
    torch.testing.assert_close(out.float(), ref_out.float(), **out_tol,
                               msg=lambda m: f"{name} out: {m}")
    dead = torch.isneginf(ref_lse)
    assert torch.equal(torch.isneginf(lse), dead), f"{name}: dead rows differ"
    torch.testing.assert_close(lse[~dead], ref_lse[~dead], rtol=0,
                               atol=lse_atol,
                               msg=lambda m: f"{name} lse: {m}")
    err = (out.float() - ref_out.float()).abs().max().item()
    diff = (lse[~dead] - ref_lse[~dead]).abs()
    lse_err = diff.max().item() if diff.numel() else 0.0
    print(f"kernel check {name}: max |out err| {err:.3e}, "
          f"max |lse err| {lse_err:.3e}, {int(dead.sum())} dead rows")
    return err


def compare_grads(name, got, want, tol, lse) -> tuple:
    """Assert kernel (dq, dk, dv) == plain within tolerance, no NaN, and
    dq = 0 on dead rows; returns (max |dq err|, max |dk, dv err|)."""
    errs = []
    for part, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), f"{name} {part}: not finite"
        torch.testing.assert_close(a.float(), b.float(), **tol,
                                   msg=lambda m: f"{name} {part}: {m}")
        errs.append((a.float() - b.float()).abs().max().item())
    dq = got[0]
    dead = torch.isneginf(lse).reshape(dq.shape[:3])
    assert torch.all(dq[dead] == 0), f"{name}: dq of a dead row is not 0"
    print(f"kernel check {name} backward: max |dq err| {errs[0]:.3e}, "
          f"|dk err| {errs[1]:.3e}, |dv err| {errs[2]:.3e}, "
          f"{int(dead.sum())} dead rows with dq 0")
    return errs[0], max(errs[1], errs[2])


def lm_data(rng, vocab, n, t):
    """Cyclic +1 sequences with random phase, labels the next token
    one-hot (examples/flash_lm.py)."""
    phase = rng.integers(0, vocab, n)
    toks = (phase[:, None] + np.arange(t)[None, :]) % vocab
    labels = np.eye(vocab, dtype=np.float32)[(toks + 1) % vocab]
    return {"tokens": toks.astype(np.float32), "labels": labels}


def update_err(params, ref, start) -> tuple:
    """(|params - ref| / |ref - start| in L2 norm over every parameter,
    max elementwise |params - ref|): how far apart two runs of the same
    steps from ``start`` ended, against how far the steps moved."""
    diff = moved = 0.0
    worst = 0.0
    for tid, value in ref.items():
        value = value.double().cpu()
        d = params[tid].double().cpu() - value
        diff += float((d * d).sum())
        moved += float(((value - start[tid].double().cpu()) ** 2).sum())
        worst = max(worst, float(d.abs().max()))
    return (diff / moved) ** 0.5, worst


def bound(flops: float, nbytes: float, rate: float = PEAK_F32_FLOPS,
          passes: int = 1) -> tuple:
    """(the least milliseconds the card could take, what bounds it): the
    operations (``passes`` times ``flops``) over ``rate``, float32 outside
    the tensor cores by default, or the bytes over HBM's rate."""
    op_ms = passes * flops / rate * 1e3
    byte_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def attention_bounds(b, h, s, d) -> dict:
    """Bounds of the flash kernels at a causal [b, h, s, d] float32 call:
    multiply-adds over the live (row, key) pairs only (s(s+1)/2 of s^2),
    each input read once and each output written once.  Per live pair
    the forward does QK and PV (4d flops), dq recomputes S and does dP
    and dS.K (6d), dkv recomputes S and does P^T.dO, dP and dS^T.Q (8d).
    All three at split TF32, the route on which the card can do float32
    products at float32's accuracy fastest."""
    pairs = b * h * s * (s + 1) / 2
    full, rows = b * h * s * d * 4, b * h * s * 4
    return {
        "forward": bound(4 * d * pairs, 3 * full + full + rows, **SPLIT_TF32),
        "dq": bound(6 * d * pairs, 5 * full + rows + full + rows,
                    **SPLIT_TF32),
        "dkv": bound(8 * d * pairs, 4 * full + 2 * rows + 2 * full,
                     **SPLIT_TF32),
    }


def flash_cases(gen, dev) -> list:
    """Phase 2's shapes: (name, (q, k, v), keywords, out tolerance, lse
    tolerance), the serving shape first."""
    def qkv(b, h, hkv, sq, skv, d, dtype=torch.float32):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, h, sq, d), (b, hkv, skv, d),
                              (b, hkv, skv, d))]

    bf16 = torch.bfloat16
    return [
        ("serving [8,4,256,128] f32 causal", qkv(8, 4, 4, 256, 256, 128),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        ("gqa h4/hkv1 causal", qkv(2, 4, 1, 256, 256, 128),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        ("window 64", qkv(2, 4, 2, 256, 256, 128),
         dict(causal=True, window=64), F32_OUT, F32_LSE_ATOL),
        ("non-causal sq 128, skv 320", qkv(2, 4, 4, 128, 320, 128),
         dict(), F32_OUT, F32_LSE_ATOL),
        ("ragged sq 100, d 64", qkv(2, 2, 2, 100, 100, 64),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        ("offsets (192, 0)", qkv(2, 4, 2, 64, 256, 128),
         dict(causal=True, offsets=(192, 0)), F32_OUT, F32_LSE_ATOL),
        ("offsets (0, 16) window 8", qkv(2, 4, 2, 64, 64, 128),
         dict(causal=True, offsets=(0, 16), window=8), F32_OUT,
         F32_LSE_ATOL),
        ("dead shard offsets (0, 512)", qkv(1, 4, 4, 64, 64, 128),
         dict(causal=True, offsets=(0, 512)), F32_OUT, F32_LSE_ATOL),
        # d not a multiple of 8: the MMAs' last k step reads zero columns
        ("d 36 causal", qkv(2, 4, 2, 256, 256, 36),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        # sq and skv not multiples of the 32-row q and 64-row kv tiles
        ("non-causal sq 200, skv 77", qkv(2, 4, 4, 200, 77, 128),
         dict(), F32_OUT, F32_LSE_ATOL),
        # GQA with lengths not a multiple of any tile of the kernels
        ("gqa h8/hkv2 causal sq 300, d 64", qkv(2, 8, 2, 300, 300, 64),
         dict(causal=True), F32_OUT, F32_LSE_ATOL),
        ("serving shape bf16 causal", qkv(8, 4, 4, 256, 256, 128, bf16),
         dict(causal=True), BF16_OUT, BF16_LSE_ATOL),
        ("gqa h8/hkv2 bf16 causal sq 300, d 64",
         qkv(2, 8, 2, 300, 300, 64, bf16), dict(causal=True), BF16_OUT,
         BF16_LSE_ATOL),
        # 72-byte rows: plain loads in place of cp.async
        ("d 36 bf16 causal", qkv(2, 4, 2, 256, 256, 36, bf16),
         dict(causal=True), BF16_OUT, BF16_LSE_ATOL),
    ]


def check_flash_forward(attention, cases) -> float:
    """Phase 2: the forward kernel against its plain version at every
    case; returns the max |out error| at the serving shape."""
    errs = []
    for name, (q, k, v), kw, out_tol, lse_atol in cases:
        got = attention.flash_attention_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        want = attention.attention_forward_plain(q, k, v, **kw)
        errs.append(compare(name, got, want, out_tol, lse_atol))
    return errs[0]


def kernel_names(fn) -> list:
    """The CUDA kernels one call of ``fn`` launches, by torch.profiler
    (called after the timed phases, so that no profiler session runs
    before them)."""
    return sorted(device_kernels(fn, calls=1))


def device_kernels(fn, calls=20) -> dict:
    """{kernel name: device ms per call of ``fn``} by torch.profiler over
    ``calls`` calls (after the timed phases, as kernel_names).  The
    profiler can drop events: a session in which a kernel's launches are
    not a whole multiple of the calls is taken again, up to three times."""
    for _ in range(3):
        times = _kernel_times(fn, calls)
        if times and all(len(ms) % calls == 0 for ms in times.values()):
            break
    return {name: sum(ms) / calls for name, ms in times.items()}


def _kernel_times(fn, calls) -> dict:
    """{kernel name: [ms of each launch]} over ``calls`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    return out


def check_flash_backward(attention, cases, gen, dev) -> tuple:
    """Phase 2: the backward kernels against their plain version at every
    case, on the forward kernel's (out, lse) as the train step hands them
    over, and bit for bit against a second run on the same inputs (no
    atomics: the same inputs give the same bits); returns (max |dq err|,
    max |dk, dv err|) at the serving shape."""
    errs = []
    for name, (q, k, v), kw, _, _ in cases:
        tol = F32_GRAD if q.dtype == torch.float32 else BF16_GRAD
        out, lse = attention.flash_attention_forward(q, k, v, **kw)
        g = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        got = attention.flash_attention_backward(q, k, v, out, lse, g, **kw)
        again = attention.flash_attention_backward(q, k, v, out, lse, g,
                                                   **kw)
        torch.cuda.synchronize()
        for part, a, b in zip(("dq", "dk", "dv"), got, again):
            assert torch.equal(a, b), f"{name} {part}: two runs differ"
        want = attention.attention_backward_plain(q, k, v, out, lse, g, **kw)
        errs.append(compare_grads(name, got, want, tol, lse))
    print(f"backward repeat check: dq, dk and dv equal bit for bit in two "
          f"runs at all {len(cases)} cases")
    return errs[0]


def time_flash_backward(attention, q, k, v, gen, dev, gpu) -> dict:
    """Phase 2 timing of dq and dkv at one causal shape: the kernels and
    the plain backward in turns (plain, kernel, kernel, plain), then
    scaled_dot_product_attention's backward by CUDA events (its graph
    kept and walked again: autograd's host work included)."""
    out, lse = attention.flash_attention_forward(q, k, v, causal=True)
    g = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    _, delta = attention.flash_bwd_dq(q, k, v, out, lse, g, causal=True)
    times = {"plain": [], "dq": [], "dkv": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            times["plain"].append(cuda_ms(
                lambda: attention.attention_backward_plain(
                    q, k, v, out, lse, g, causal=True)))
            continue
        times["dq"].append(cuda_ms(
            lambda: attention.flash_bwd_dq(q, k, v, out, lse, g,
                                           causal=True)))
        times["dkv"].append(cuda_ms(
            lambda: attention.flash_bwd_dkv(q, k, v, lse, delta, g,
                                            causal=True)))
    res = {key: sum(val) / 2 for key, val in times.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa_bwd = sdpa_backward(q, k, v, g)
    res["library"] = cuda_ms(sdpa_bwd)
    res["runs"] = times
    print(f"flash bwd {list(q.shape)} {str(q.dtype)[6:]} causal: dq "
          f"{res['dq']:.4f} ms, dkv {res['dkv']:.4f} ms, plain backward "
          f"(dq, dk, dv) {res['plain']:.4f} ms (runs {times}), "
          f"scaled_dot_product_attention backward (dq, dk, dv) "
          f"{res['library']:.4f} ms by CUDA events on {gpu}")
    return res


def sdpa_backward(q, k, v, g):
    """A call of scaled_dot_product_attention's backward alone at a causal
    shape: its graph is built once and walked again at every call."""
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg,
                                                           is_causal=True)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), g,
                                       retain_graph=True)


def time_flash_forward(attention, q, k, v, gpu) -> dict:
    """Phase 2 timing at the serving shape: the kernel and its plain
    version in turns, then scaled_dot_product_attention (TF32 off)."""
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = (attention.attention_forward_plain if which == "plain"
              else attention.flash_attention_forward)
        times[which].append(cuda_ms(lambda: fn(q, k, v, causal=True)))
    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"kernel": sum(times["kernel"]) / 2,
           "plain": sum(times["plain"]) / 2,
           "library": cuda_ms(lambda: sdpa(q, k, v, is_causal=True))}
    print(f"flash fwd [8,4,256,128] f32 causal: kernel {out['kernel']:.4f} "
          f"ms, plain {out['plain']:.4f} ms (runs {times}), "
          f"scaled_dot_product_attention {out['library']:.4f} ms on {gpu}")
    return out


def epilogue(code, consts=(), patterns=()):
    """An epilogue program of the matmul kernel from named steps."""
    from exprgrad_torch.ops.matmul import OPCODE, Epilogue

    return Epilogue(tuple((OPCODE[op], *regs) for op, *regs in code),
                    tuple(consts), tuple(patterns))


def matmul_graph(egt, n_tile):
    """The repo's matmul cell (bench.py, benchmarks/matmul.py)."""
    y, x, it = egt.iters("y", "x", "it")
    c = egt.Fun("c")
    c[y, x] = egt.input("a")[y, it] * egt.input("b")[it, x]
    c.schedule(tile={"y": n_tile, "x": n_tile, "it": n_tile},
               parallel=["y", "x"])
    return c.target("c")


def scheduled_mlp(egt, dim, hidden, tile, eta=1e-3):
    """dense -> relu -> dense, each matmul scheduled, plus the residual
    add of a flash_transformer FFN block; mean squared error against the
    input "t", adam (tests/test_pallas_fusion_chains.py's pattern)."""
    sched = dict(tile={"y": tile, "x": tile, "it": tile},
                 parallel=["y", "x"], kernel=0)
    h = egt.layers.dense(egt.input("v"), dim, hidden).schedule(**sched)
    h = egt.layers.relu(h)
    o = egt.layers.dense(h, hidden, dim).schedule(**sched)
    y, x = egt.iters("y", "x")
    out = egt.Fun("out")
    out[y, x] = egt.input("v")[y, x] + o[y, x]
    return (out.target("predict").pipe(egt.layers.mse, egt.input("t"))
            .target("loss")
            .backprop(egt.make_opt(egt.layers.adam, eta=eta))
            .target("train"))


# --- scheduled map/reduce kernels and row chains (B5, B6) ---------------
#
# Each builder takes a DSL module (exprgrad_torch here; the CPU tests also
# hand it exprgrad_tpu) and returns (graph, inputs) of one target "out";
# the inputs come from a fixed seed, so both packages see the same data.

def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def fam_elementwise(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = m.exp(inp[y, x]) + 1.0
    out.schedule(tile={"y": 16})
    (v,) = _normal(1, (64, 200))
    return out.target("out"), {"inp": v}


def fam_inblock_reduction(m):
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = m.exp(a[y, x]) + b[y]
    out.schedule(tile={"y": 8}, share_cache=["x"])
    av, bv = _normal(2, (16, 32), (16,))
    return out.target("out"), {"a": av, "b": bv}


def fam_gridded_reduction(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = inp[y, x] * 2.0
    out.schedule(tile={"y": 32, "x": 128})
    (v,) = _normal(3, (64, 512))
    return out.target("out"), {"inp": v}


def fam_gridded_max(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out.maximize[y] = inp[y, x]
    out.schedule(tile={"x": 128})
    (v,) = _normal(4, (32, 512))
    return out.target("out"), {"inp": v}


def fam_stencil(m):
    img = m.input("img")
    y = m.iters("y")
    x = m.irange("x", 0, img.shape[1] - 2)
    out = m.Fun("out")
    out[y, x] = (img[y, x] + img[y, x + 1] + img[y, x + 2]) * (1.0 / 3.0)
    out.schedule(tile={"y": 16})
    (v,) = _normal(31, (64, 130))
    return out.target("out"), {"img": v}


def fam_stride_phase(m):
    imgs = m.input("imgs")
    i, y, x, c = m.iters("i", "y", "x", "c")
    out = m.Fun("out")
    out[i, y, x, c] = m.maximum(
        m.maximum(imgs[i, y * 2, x * 2, c], imgs[i, y * 2 + 1, x * 2, c]),
        m.maximum(imgs[i, y * 2, x * 2 + 1, c],
                  imgs[i, y * 2 + 1, x * 2 + 1, c]))
    out.schedule(tile={"y": 8})
    (v,) = _normal(10, (2, 16, 16, 128))
    return out.target("out"), {"imgs": v}


def fam_grouping(m):
    imgs = m.input("imgs")
    i, y, x, c = m.iters("i", "y", "x", "c")
    out = m.Fun("out")
    out[i, y, x, c] = imgs[i, y // 2, x // 2, c]
    out.with_shape([imgs.shape[0], imgs.shape[1] * 2, imgs.shape[2] * 2,
                    imgs.shape[3]])
    out.schedule(tile={"y": 8})
    (v,) = _normal(12, (2, 8, 8, 128))
    return out.target("out"), {"imgs": v}


def fam_flat_reads(m):
    a, b = m.input("a"), m.input("b")
    it = m.iters("it")
    out = m.Fun("out")
    out.raw[it] = m.exp(a.raw[it] * 0.3) + b.raw[it]
    out.schedule(tile={"it": 128})
    av, bv = _normal(62, (8, 16, 32), (8, 16, 32))
    return out.target("out"), {"a": av, "b": bv}


def fam_permuted_write(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[x, y] = a[y, x] * 2.0
    out.schedule(tile={"y": 32})
    (av,) = _normal(53, (64, 128))
    return out.target("out"), {"a": av}


def fam_permuted_read(m):
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = m.exp(a[y, x]) + b[x, y]
    out.schedule(tile={"y": 16})
    av, bv = _normal(52, (32, 128), (128, 32))
    return out.target("out"), {"a": av, "b": bv}


def fam_constant_write(m):
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[0] = m.sq(a[y, x] - b[y, x])
    out.schedule(tile={"y": 16})
    av, bv = _normal(41, (64, 128), (64, 128))
    return out.target("out"), {"a": av, "b": bv}


def fam_column_reduction(m):
    """A column sum (the stride-1 axis written, the strided one reduced),
    tall enough that B5 splits the reduction and combines the partials
    (squares: sums in other orders agree to float32)."""
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[x] = m.sq(a[y, x] - b[y, x])
    out.schedule(tile={"x": 64})
    av, bv = _normal(71, (1024, 64), (1024, 64))
    return out.target("out"), {"a": av, "b": bv}


def fam_triangular(m):
    a = m.input("a")
    y = m.iters("y")
    x = m.irange("x", 0, y + 1)
    out = m.Fun("out")
    out.maximize[y] = a[y, x]
    out.schedule(tile={"y": 16})
    (av,) = _normal(55, (64, 64))
    return out.target("out"), {"a": av}


def fam_epoch(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = a[y, x] * m.to_scalar(m.epoch())
    out.schedule(tile={"y": 8})
    (av,) = _normal(5, (16, 128))
    return out.target("out"), {"a": av}


def fam_ragged(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = m.exp(a[y, x])
    out.schedule(tile={"y": 48, "x": 100})
    (av,) = _normal(23, (100, 200))
    return out.target("out"), {"a": av}


def fam_gather(m):
    n, t, d = m.iters("n", "t", "d")
    tok, table = m.input("tok"), m.input("table")
    out = m.Fun("out")
    out[n, d] = table[m.to_index(tok[n, t]), d] * 2.0 + 1.0
    out.with_shape([tok.shape[0], table.shape[1]])
    out.schedule(tile={"n": 2})
    tokv = np.random.default_rng(2).integers(0, 8, (3, 5)).astype(np.float32)
    (tab,) = _normal(6, (8, 64))
    return out.target("out"), {"tok": tokv, "table": tab}


def fam_pure_gather(m):
    i, j = m.iters("i", "j")
    xin, ain = m.input("x"), m.input("a")
    out = m.Fun("out")
    out[i, j] = xin[i, j] * ain[(i + 2 * j) % 9]
    out.with_shape([xin.shape[0], xin.shape[1]])
    out.schedule(tile={"i": 2, "j": 3})
    xv, av = _normal(9, (4, 6), (9,))
    return out.target("out"), {"x": xv, "a": av}


def _scatter(m, mode):
    i, x = m.iters("i", "x")
    tok, g = m.input("tok"), m.input("g")
    out = m.Fun("out")
    dst = out if mode == "add" else getattr(out, mode)
    dst[m.to_index(tok[i]), x] = g[i, x]
    out.with_shape([11, 24])
    out.schedule(tile={"i": 16})
    toks = np.random.default_rng(15).integers(0, 11, 48).astype(np.float32)
    (gv,) = _normal(16, (48, 24))
    return out.target("out"), {"tok": toks, "g": gv}


def fam_scatter_add(m):
    return _scatter(m, "add")


def fam_scatter_max(m):
    return _scatter(m, "maximize")


def fam_scatter_min(m):
    return _scatter(m, "minimize")


def fam_pure_scatter(m):
    i, j = m.iters("i", "j")
    vin = m.input("v")
    out = m.Fun("out")
    out[i, (i + j) % 7] = vin[i, j]
    out.with_shape([6, 7])
    out.schedule(tile={"i": 2})
    (vv,) = _normal(13, (6, 9))
    return out.target("out"), {"v": vv}


def fam_causal_mask(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = m.select(x <= y, a[y, x], 0.0)
    out.schedule(tile={"y": 32})
    (av,) = _normal(22, (128, 128))
    return out.target("out"), {"a": av}


def fam_shape_query(m):
    a = m.input("a")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y] = a[y, x] / m.to_scalar(a.shape[1])
    out.schedule(tile={"y": 16})
    (av,) = _normal(59, (64, 128))
    return out.target("out"), {"a": av}


def fam_broadcast_write(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = inp[y] * 3.0
    out.with_shape([inp.shape[0], 64])
    out.schedule(tile={"y": 16})
    (v,) = _normal(7, (32,))
    return out.target("out"), {"inp": v}


# one program per family of PallasMapReduce's classifier; each runs one
# generated kernel (one "mapreduce" stat) in both packages
MAPREDUCE_FAMILIES = {
    "elementwise": fam_elementwise,
    "inblock_reduction": fam_inblock_reduction,
    "gridded_reduction": fam_gridded_reduction,
    "gridded_max": fam_gridded_max,
    "stencil": fam_stencil,
    "stride_phase": fam_stride_phase,
    "grouping": fam_grouping,
    "flat_reads": fam_flat_reads,
    "permuted_write": fam_permuted_write,
    "permuted_read": fam_permuted_read,
    "constant_write": fam_constant_write,
    "column_reduction": fam_column_reduction,
    "triangular": fam_triangular,
    "epoch": fam_epoch,
    "ragged": fam_ragged,
    "gather": fam_gather,
    "pure_gather": fam_pure_gather,
    "scatter_add": fam_scatter_add,
    "scatter_max": fam_scatter_max,
    "scatter_min": fam_scatter_min,
    "pure_scatter": fam_pure_scatter,
    "causal_mask": fam_causal_mask,
    "shape_query": fam_shape_query,
    "broadcast_write": fam_broadcast_write,
}


def softmax_chain(m, tile, rows=128, cols=256, seed=0, scale=8.0):
    """The three-kernel softmax of bench.py (row max, exp-sum,
    normalize), each kernel scheduled with ``tile``."""
    inp = m.input("inp")
    funs = []
    for name in ("mx", "sums", "out"):
        y, x = m.iters("y", "x")
        f = m.Fun(name)
        if name == "mx":
            f.maximize[y] = inp[y, x]
        elif name == "sums":
            f[y] = m.exp(inp[y, x] - funs[0][y])
        else:
            f[y, x] = m.exp(inp[y, x] - funs[0][y]) / funs[1][y]
        f.schedule(tile=tile)
        funs.append(f)
    (v,) = _normal(seed, (rows, cols), scale=scale)
    return funs[-1].target("out"), {"inp": v}


def chain_layer_norm(m):
    dim = 128
    inp, gamma, beta = m.input("inp"), m.input("gamma"), m.input("beta")
    n, v, out = m.Fun("mean"), m.Fun("var"), m.Fun("out")
    y, x = m.iters("y", "x")
    n[y] = inp[y, x] * (1.0 / dim)
    y, x = m.iters("y", "x")
    v[y] = m.sq(inp[y, x] - n[y]) * (1.0 / dim)
    y, x = m.iters("y", "x")
    out[y, x] = (inp[y, x] - n[y]) / m.sqrt(v[y] + 1e-5) * gamma[x] + beta[x]
    for f in (n, v, out):
        f.schedule(tile={"y": 16})
    a, g, b = _normal(2, (64, dim), (dim,), (dim,))
    return out.target("out"), {"inp": a, "gamma": g, "beta": b}


def chain_rms(m):
    a = m.input("a")
    ss, out = m.Fun("ss"), m.Fun("out")
    y, x = m.iters("y", "x")
    ss[y] = m.sq(a[y, x]) * (1.0 / 128.0)
    y, x = m.iters("y", "x")
    out[y, x] = a[y, x] / m.sqrt(ss[y] + 1e-6)
    for f in (ss, out):
        f.schedule(tile={"y": 16})
    (av,) = _normal(2, (64, 128))
    return out.target("out"), {"a": av}


def chain_escaping(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    mx = m.Fun("mx")
    mx.maximize[y] = inp[y, x]
    y, x = m.iters("y", "x")
    sums = m.Fun("sums")
    sums[y] = m.exp(inp[y, x] - mx[y])
    esc = m.Fun("esc")
    y2 = m.iters("y2")
    esc[y2] = mx[y2] * 2.0  # a second consumer of mx, outside the chain
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = (m.exp(inp[y, x] - mx[y]) / sums[y]) + 0.001 * esc[y]
    for f in (mx, sums, out):
        f.schedule(tile={"y": 16})
    (v,) = _normal(3, (32, 128))
    return out.target("out"), {"inp": v}


def chain_shared_operand(m):
    inp = m.input("inp")
    y, x = m.iters("y", "x")
    mx = m.Fun("mx")
    mx.maximize[y] = inp[y, x]
    mx.schedule(parallel=["y"])
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    out[y, x] = inp[y, x] - mx[y]
    out.schedule(parallel=["y"])
    (v,) = _normal(5, (64, 128))
    return out.target("out"), {"inp": v}


def chain_layer_softmax(m):
    import importlib

    layers = importlib.import_module(m.__name__ + ".layers")
    out = layers.softmax(m.input("inp"), row_tile=32)
    (v,) = _normal(7, (64, 256), scale=6.0)
    return out.target("out"), {"inp": v}


def chain_layer_rms_rank3(m):
    import importlib

    layers = importlib.import_module(m.__name__ + ".layers")
    out = layers.rms_norm(m.input("inp"), 128, rank=3, row_tile=16)
    (v,) = _normal(8, (4, 64, 128))
    return out.target("out"), {"inp": v}


def chain_causal_softmax(m):
    inp = m.input("inp")
    funs = []
    for name in ("mx", "sm", "out"):
        q, k = m.iters("q", "k")
        f = m.Fun(name)
        if name == "mx":
            f.maximize[q] = m.select(k <= q, inp[q, k], -1e30)
        elif name == "sm":
            f[q] = m.select(k <= q, m.exp(inp[q, k] - funs[0][q]), 0.0)
        else:
            f[q, k] = m.select(k <= q, m.exp(inp[q, k] - funs[0][q])
                               / funs[1][q], 0.0)
        f.schedule(tile={"q": 32})
        funs.append(f)
    (v,) = _normal(7, (128, 128), scale=4.0)
    return funs[-1].target("out"), {"inp": v}


def chain_ragged_rows(m):
    return softmax_chain(m, {"y": 48}, rows=100, cols=256, seed=1, scale=5.0)


# the row-chain programs of tests/test_pallas_rowchain.py that fuse; each
# runs one fused kernel (one "rowchain" stat) in both packages
ROWCHAIN_FAMILIES = {
    "softmax": lambda m: softmax_chain(m, {"y": 32}),
    "ragged_rows": chain_ragged_rows,
    "layer_norm": chain_layer_norm,
    "rms_norm": chain_rms,
    "escaping": chain_escaping,
    "shared_operand": chain_shared_operand,
    "layer_softmax": chain_layer_softmax,
    "layer_rms_rank3": chain_layer_rms_rank3,
    "causal_softmax": chain_causal_softmax,
}


# Seeded random programs, built as the JAX package's differential fuzzers
# build theirs (tests/test_fuzz_general.py, test_fuzz_cmpred.py,
# test_fuzz_rowchain.py): the same draws from the same seeds give the same
# programs and inputs.

def fuzz_general(m, rng):
    """Permuted reads and writes, maybe a triangular bound."""
    sizes = [int(rng.choice(c)) for c in
             ([13, 30, 48], [10, 24, 36], [100, 128, 200])]
    dynamic = rng.random() < 0.4
    i0 = m.iters("i0")
    if dynamic:
        c = int(rng.integers(1, 8))
        sizes[1] = sizes[0] - 1 + c
        i1 = m.irange("i1", 0, i0 + c)
    else:
        i1 = m.iters("i1")
    i2 = m.iters("i2")
    its = (i0, i1, i2)
    inputs = {"base": tuple(sizes)}
    exprs = [m.input("base")[i0, i1, i2]]
    for r in range(int(rng.integers(1, 3))):
        axes = sorted({2} | {a for a in (0, 1) if rng.random() < 0.5})
        order = list(rng.permutation(len(axes)))
        perm_axes = [axes[i] for i in order]
        inputs[f"t{r}"] = tuple(sizes[a] for a in perm_axes)
        exprs.append(m.input(f"t{r}")[tuple(its[a] for a in perm_axes)])
    expr = exprs[0]
    for other in exprs[1:]:
        op = rng.choice(["add", "mul", "max"])
        if op == "add":
            expr = expr + other
        elif op == "mul":
            expr = expr * other
        else:
            expr = m.maximum(expr, other)
    if rng.random() < 0.3:
        expr = m.exp(expr * 0.05)
    out = m.Fun("out")
    keep = sorted({2} | {0 for _ in (0,) if rng.random() < 0.7})
    if not dynamic and rng.random() < 0.5:
        keep = sorted(set(keep) | {1})
    order = list(rng.permutation(len(keep)))
    idx = tuple(its[keep[i]] for i in order)
    if rng.random() < 0.2:
        out.maximize[idx] = expr
    else:
        out[idx] = expr
    tiles = {}
    for a in keep:
        if rng.random() < 0.6:
            tiles[f"i{a}"] = int(rng.choice([8, 16, 48, 100]))
    if tiles:
        out.schedule(tile=tiles)
    else:
        out.schedule(parallel=[f"i{keep[0]}"])
    return [out.target("out")], inputs


def _index_expr(rng, its, V):
    a, b = rng.choice(len(its), size=2, replace=False)
    form = rng.integers(0, 4)
    ia, ib = its[int(a)], its[int(b)]
    if form == 0:
        e = ia * ib
    elif form == 1:
        e = ia * int(rng.integers(1, 5)) + ib * int(rng.integers(1, 5))
    elif form == 2:
        e = ia * ia + int(rng.integers(0, 7))
    else:
        e = ia // int(rng.integers(2, 5)) + ib
    return e % V


def fuzz_cmpred(m, rng):
    """Computed-index (pure-iterator) gathers and scatters."""
    sizes = [int(rng.integers(4, 20)), int(rng.integers(4, 20)),
             int(rng.choice([32, 64, 128]))]
    i0, i1, i2 = m.iters("i0", "i1", "i2")
    its = (i0, i1, i2)
    V = int(rng.integers(5, 60))
    inputs = {"base": tuple(sizes)}
    expr = m.input("base")[i0, i1, i2]
    for r in range(int(rng.integers(1, 3))):
        name = f"g{r}"
        gidx = _index_expr(rng, its, V)
        roll = rng.random()
        if roll < 0.3:
            trail = int(rng.choice([0, 1, 2]))
            inputs[name] = (V, sizes[trail])
            read = m.input(name)[gidx, its[trail]]
        elif roll < 0.5:
            V2 = int(rng.integers(4, 20))
            gidx2 = _index_expr(rng, its, V2)
            inputs[name] = (V, V2)
            read = m.input(name)[gidx, gidx2]
        else:
            inputs[name] = (V,)
            read = m.input(name)[gidx]
        expr = expr + read if rng.random() < 0.5 else expr * read
    if rng.random() < 0.3:
        expr = m.exp(expr * 0.05)
    out = m.Fun("out")
    if rng.random() < 0.35:
        acc_roll = rng.random()
        dst = (out.maximize if acc_roll < 1 / 6
               else out.minimize if acc_roll < 1 / 3 else out)
        Vout = int(rng.integers(5, 40))
        widx = _index_expr(rng, its, Vout)
        roll = rng.random()
        if roll < 0.3:
            dst[widx, i2] = expr
            shape = [Vout, sizes[2]]
        elif roll < 0.5:
            Vout2 = int(rng.integers(4, 16))
            widx2 = _index_expr(rng, its, Vout2)
            dst[widx, widx2] = expr
            shape = [Vout, Vout2]
        elif roll < 0.7:
            dst[widx, i0] = expr
            shape = [Vout, sizes[0]]
        else:
            dst[widx] = expr
            shape = [Vout]
        out.with_shape(shape)
    else:
        keep = sorted({2} | {a for a in (0, 1) if rng.random() < 0.6})
        out[tuple(its[a] for a in keep)] = expr
        out.with_shape([sizes[a] for a in keep])
    tiles = {}
    for a in range(3):
        if rng.random() < 0.5:
            tiles[f"i{a}"] = int(rng.choice([4, 8, 16, 64]))
    if tiles:
        out.schedule(tile=tiles)
    else:
        out.schedule(parallel=["i0"])
    return [out.target("out")], inputs


def fuzz_rowchain(m, rng):
    """2-4 kernel row chains, sometimes with an escaping intermediate."""
    r = int(rng.choice([48, 100, 128]))
    c = int(rng.choice([128, 200, 256]))
    inp = m.input("inp")
    tile = int(rng.choice([16, 32, 48]))
    funs = []
    y, x = m.iters("y", "x")
    head = m.Fun("k0")
    if rng.random() < 0.4:
        head.maximize[y] = inp[y, x]
    else:
        head[y] = m.exp(inp[y, x] * 0.1)
    head.schedule(tile={"y": tile})
    funs.append(head)
    for i in range(int(rng.integers(0, 2))):
        y, x = m.iters("y", "x")
        f = m.Fun(f"k{i + 1}")
        prev = funs[-1]
        kind = rng.choice(["exp", "sq", "mix"])
        if kind == "exp":
            f[y] = m.exp((inp[y, x] - prev[y]) * 0.1)
        elif kind == "sq":
            f[y] = m.sq(inp[y, x] * 0.05) + prev[y] * 0.01
        else:
            f[y] = m.maximum(inp[y, x] * 0.1, prev[y] * 0.05)
        f.schedule(tile={"y": tile})
        funs.append(f)
    y, x = m.iters("y", "x")
    out = m.Fun("out")
    prev, first = funs[-1], funs[0]
    if rng.random() < 0.7:
        out[y, x] = (inp[y, x] - first[y] * 0.5) / m.sqrt(
            prev[y] * prev[y] + 1.0)
    else:
        out[y] = (inp[y, x] - first[y] * 0.01) * 0.1 + prev[y]
    out.schedule(tile={"y": tile})
    funs.append(out)
    graphs = [out.target("out")]
    if rng.random() < 0.4 and len(funs) > 1:
        victim = funs[int(rng.integers(0, len(funs) - 1))]
        z = m.iters("z")
        esc = m.Fun("esc")
        esc[z] = victim[z] * 3.0
        graphs.append(esc.target("esc"))
    return graphs, {"inp": (r, c)}


def fuzz_case(m, kind, seed):
    """(graphs, inputs) of the fuzzer ``kind`` at ``seed``, with the
    fuzzers' own seed offsets and input draws."""
    build, base, scale = {"general": (fuzz_general, 9100, 0.5),
                          "cmpred": (fuzz_cmpred, 41000, 0.5),
                          "rowchain": (fuzz_rowchain, 8200, 2.0)}[kind]
    rng = np.random.default_rng(base + seed)
    graphs, shapes = build(m, rng)
    args = {name: (rng.normal(size=shape) * scale).astype(np.float32)
            for name, shape in shapes.items()}
    return graphs, args


def scatter_add_graph(m, v, d, tile):
    """bench.py's embedding-gradient scatter-add demb[tok[i], x] += g[i, x]."""
    i, x = m.iters("i", "x")
    tok, g = m.input("tok"), m.input("g")
    out = m.Fun("demb")
    out[m.to_index(tok[i]), x] = g[i, x]
    out.with_shape([v, d])
    out.schedule(tile=tile)
    return out.target("demb")


def transformer_head(m, dim, vocab, eta=1e-3):
    """The head of flash_transformer (models/transformer.py: rms_norm,
    dense to the vocabulary, softmax, the cross-entropy over the tokens)
    on rank-2 rows, its row-family layers given ``row_tile=32`` and its
    dense scheduled as path (b)'s, trained with adam."""
    import importlib

    layers = importlib.import_module(m.__name__ + ".layers")
    h = layers.rms_norm(m.input("x"), dim, row_tile=32)
    logits = layers.dense(h, dim, vocab).schedule(
        tile={"y": 128, "x": 128, "it": 128}, parallel=["y", "x"], kernel=0)
    predict = layers.softmax(logits, row_tile=32).target("predict")
    labels = m.input("labels")
    it = m.iters("it")
    loss = m.Fun("loss")
    loss[0] = -(labels.raw[it] * m.ln(predict.raw[it] + 1e-9)) / m.to_scalar(
        labels.shape[0])
    return (loss.target("loss").backwards()
            .optimize(m.make_opt(layers.adam, eta=eta)).target("train"))


def check_matmul_kernel(gen, dev) -> float:
    """Phase 6: the kernel at its default block against its plain version
    at every case, and at every other block of its lattice against the
    default block's bits (each block sums every output element's k terms
    in the same order, csrc/matmul.cuh); returns the max |error| at
    4096^3."""
    from exprgrad_torch.ops import matmul

    relu_row = epilogue([("extra", 1, 0, 0, 0), ("add", 2, 0, 1, 0),
                         ("const", 3, 0, 0, 0), ("le", 4, 3, 2, 0),
                         ("select", 5, 4, 2, 3), ("mov", 0, 5, 0, 0)],
                        (0.0,), ("row",))
    col_select = epilogue([("extra", 1, 0, 0, 0), ("sub", 2, 0, 1, 0),
                           ("const", 3, 0, 0, 0), ("lt", 4, 2, 3, 0),
                           ("const", 5, 1, 0, 0), ("mul", 6, 2, 5, 0),
                           ("select", 0, 4, 6, 2)], (0.0, 0.1), ("col",))
    residual_relu = epilogue([("extra", 1, 0, 0, 0), ("add", 2, 0, 1, 0),
                              ("const", 3, 0, 0, 0), ("le", 4, 3, 2, 0),
                              ("select", 0, 4, 2, 3)], (0.0,), ("full",))
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, (m, k, n), transposed, in/out dtype, epilogue
        ("4096^3 f32", (4096, 4096, 4096), False, f32, f32, None),
        ("ragged 30x50x70", (30, 50, 70), False, f32, f32, None),
        ("1000^3", (1000, 1000, 1000), False, f32, f32, None),
        ("transposed 512x256x384", (512, 256, 384), True, f32, f32, None),
        ("row bias + relu 1000x512x768", (1000, 512, 768), False, f32, f32,
         relu_row),
        ("col broadcast + select 333x257x129", (333, 257, 129), False, f32,
         f32, col_select),
        ("full residual + relu, transposed 300x200x500", (300, 200, 500),
         True, f32, f32, residual_relu),
        # k of 4097 (rows of 16388 bytes: plain loads), ragged tiles
        ("full residual + relu 4095x4097x33", (4095, 4097, 33), False, f32,
         f32, residual_relu),
        ("bf16 in, f32 out 1024^3", (1024, 1024, 1024), False, bf16, f32,
         None),
        ("bf16 in and out, row bias + relu 1024x1024x512",
         (1024, 1024, 512), False, bf16, bf16, relu_row),
    ]
    worst = None
    for name, (m, k, n), transposed, in_dt, out_dt, prog in cases:
        a = torch.randn(m, k, generator=gen, device=dev).to(in_dt)
        b = torch.randn(k, n, generator=gen, device=dev).to(in_dt)
        rows, cols = (n, m) if transposed else (m, n)
        shapes = {"row": (1, cols), "col": (rows, 1), "full": (rows, cols)}
        extra = [torch.randn(shapes[p], generator=gen, device=dev).to(out_dt)
                 for p in (prog.patterns if prog else ())]
        got = matmul.matmul_impl(a, b, out_dt, prog, extra, transposed)
        torch.cuda.synchronize()
        want = matmul.matmul_plain(a, b, out_dt, prog, extra, transposed)
        tol = matmul_f32_tol(k) if out_dt == f32 else MATMUL_BF16_OUT
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got.double(), want.double(), **tol,
                                   msg=lambda msg: f"matmul {name}: {msg}")
        err = (got.double() - want.double()).abs().max().item()
        for block in matmul.BLOCKS:
            other = matmul.matmul_impl(a, b, out_dt, prog, extra, transposed,
                                       block)
            torch.cuda.synchronize()
            assert torch.equal(other, got), (name, block, (
                other.double() - got.double()).abs().max().item())
        print(f"kernel check matmul {name}: max |err| {err:.3e} "
              f"(rtol {tol['rtol']}, atol {tol['atol']:.3e}); the "
              f"{len(matmul.BLOCKS)} blocks give the same bits")
        if worst is None:
            worst = err
    return worst


def time_matmul(gen, dev, n, gpu) -> dict:
    """Phase 6 timing at n^3 float32: the kernel, its plain version and
    torch.matmul with TF32 off, in turns."""
    from exprgrad_torch.ops import matmul

    a = torch.randn(n, n, generator=gen, device=dev)
    b = torch.randn(n, n, generator=gen, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = {"kernel": lambda: matmul.matmul_impl(a, b),
           "plain": lambda: matmul.matmul_plain(a, b),
           "library": lambda: torch.matmul(a, b)}
    runs = {name: [] for name in fns}
    for name in ("plain", "library", "kernel", "kernel", "library",
                 "plain"):
        runs[name].append(cuda_ms(fns[name], iters=10, warmup=2))
    out = {name: sum(v) / len(v) for name, v in runs.items()}
    out["bound"] = bound(2.0 * n ** 3, 3 * n * n * 4, **SPLIT_TF32)
    print(f"matmul {n}^3 f32: kernel {out['kernel']:.4f} ms, plain "
          f"(float64) {out['plain']:.4f} ms, torch.matmul TF32 off "
          f"{out['library']:.4f} ms, bound {out['bound'][0]:.4f} ms "
          f"({out['bound'][1]}) (runs {runs}) on {gpu}")
    return out


def time_matmul_blocks(gen, dev, gpu) -> dict:
    """Phase 6: the kernel at every block of its lattice at 4096^3 float32
    and 1024^3 bfloat16 (bfloat16 out), beside torch.matmul (TF32 off)
    and the bound, in turns: {shape: {"blocks": {block: ms}, "library":
    ms, "bound": (ms, by)}}."""
    from exprgrad_torch.ops import matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for n, dtype in ((MATMUL_N, torch.float32),
                     (BLOCK_BF16_N, torch.bfloat16)):
        a = torch.randn(n, n, generator=gen, device=dev).to(dtype)
        b = torch.randn(n, n, generator=gen, device=dev).to(dtype)
        iters = 10 if n > 2048 else 50
        times = {block: [] for block in matmul.BLOCKS}
        library = []
        for turn in range(2):
            library.append(cuda_ms(lambda: torch.matmul(a, b), iters=iters,
                                   warmup=2))
            order = matmul.BLOCKS if turn == 0 else matmul.BLOCKS[::-1]
            for block in order:
                times[block].append(cuda_ms(
                    lambda: matmul.matmul_impl(a, b, block=block),
                    iters=iters, warmup=2))
        size = 4 if dtype == torch.float32 else 2
        rate = (SPLIT_TF32 if dtype == torch.float32
                else dict(rate=PEAK_BF16_FLOPS))
        name = f"{n}^3 {'f32' if size == 4 else 'bf16'}"
        out[name] = {
            "blocks": {"x".join(map(str, block)): sum(v) / len(v)
                       for block, v in times.items()},
            "library": sum(library) / len(library),
            "bound": bound(2.0 * n ** 3, 3 * n * n * size, **rate)}
        best = min(out[name]["blocks"], key=out[name]["blocks"].get)
        print(f"matmul {name} by block (ms, mean of 2 turns): "
              f"{ {k: round(v, 4) for k, v in out[name]['blocks'].items()} }"
              f"; fastest {best}; torch.matmul {out[name]['library']:.4f} "
              f"ms (runs {library}); bound {out[name]['bound'][0]:.4f} ms "
              f"({out[name]['bound'][1]}) on {gpu}")
    return out


# the einsum path's contractions of portbench's codestral22b.train cell
# (Codestral-22B's widths, 4,096 tokens a step): (label, einsum spec,
# operand shapes); the weight gradients are the tn layout, the input
# gradients nt, the forward nn; q, k/v and o fold their heads into n or k
_T, _D, _H, _KV, _HD, _F, _V = 4096, 6144, 48, 8, 128, 16384, 32768
CELL_GEMMS = (
    ("ffn gate/up x.W", "abc,cd->abd", (1, _T, _D), (_D, _F)),
    ("ffn down x.W", "abc,cd->abd", (1, _T, _F), (_F, _D)),
    ("head x.W", "abc,cd->abd", (1, _T, _D), (_D, _V)),
    ("q x.W", "acd,bde->abce", (1, _T, _D), (_H, _D, _HD)),
    ("k/v x.W", "acd,bde->abce", (1, _T, _D), (_KV, _D, _HD)),
    ("o attn.W", "abcd,bde->ace", (1, _H, _T, _HD), (_H, _HD, _D)),
    ("ffn gate/up dW", "abd,abc->cd", (1, _T, _F), (1, _T, _D)),
    ("ffn down dW", "abd,abc->cd", (1, _T, _D), (1, _T, _F)),
    ("head dW", "abd,abc->cd", (1, _T, _V), (1, _T, _D)),
    ("ffn gate/up dX", "abd,cd->abc", (1, _T, _F), (_D, _F)),
    ("ffn down dX", "abd,cd->abc", (1, _T, _D), (_F, _D)),
    ("head dX", "abd,cd->abc", (1, _T, _V), (_D, _V)),
    ("q dW", "abce,acd->bde", (1, _H, _T, _HD), (1, _T, _D)),
    ("q dX", "abce,bde->acd", (1, _H, _T, _HD), (_H, _D, _HD)),
    ("o dW", "ace,abcd->bde", (1, _T, _D), (1, _H, _T, _HD)),
    ("o dX", "ace,bde->abcd", (1, _T, _D), (_H, _HD, _D)),
)
# every float32 weight product of a decode step of portbench's two chat
# cells (Mistral-7B-v0.1 and AI21-Jamba2-Mini at published widths), as
# ``ops.matmul.weight_product`` takes it: (label, x's shape with ROWS
# where the step's rows go, the weight's shape, the einsum or None for
# torch.matmul, the products a decode step of mistral7b.chat runs, those
# of jamba2mini.chat: 7 Mamba layers, 1 attention layer, 4 dense and 4
# expert FFNs); Jamba's attention and dense FFN have Mistral's widths
ROWS = -1
_HEADS_IN, _HEADS_OUT = "ntc,hcd->nhtd", "nhtd,hde->nte"
DECODE_GEMMS = (
    ("mistral wq", (ROWS, 1, 4096), (32, 4096, 128), _HEADS_IN, 32, 1),
    ("mistral wk/wv", (ROWS, 1, 4096), (8, 4096, 128), _HEADS_IN, 64, 2),
    ("mistral wo", (ROWS, 32, 1, 128), (32, 128, 4096), _HEADS_OUT, 32, 1),
    ("mistral w1/w3", (ROWS, 1, 4096), (4096, 14336), None, 64, 8),
    ("mistral w2", (ROWS, 1, 14336), (14336, 4096), None, 32, 4),
    ("mistral head", (ROWS, 1, 4096), (4096, 32000), None, 1, 0),
    ("jamba in_proj", (ROWS, 1, 4096), (4096, 16384), None, 0, 7),
    ("jamba x_proj", (ROWS, 1, 8192), (8192, 288), None, 0, 7),
    ("jamba dt_proj", (ROWS, 1, 256), (256, 8192), None, 0, 7),
    ("jamba out_proj", (ROWS, 1, 8192), (8192, 4096), None, 0, 7),
    ("jamba experts wg/wu, shared x", (ROWS, 4096), (16, 4096, 14336),
     None, 0, 8),
    ("jamba experts wd, own x", (16, ROWS, 14336), (16, 14336, 4096), None,
     0, 4),
    ("jamba head", (ROWS, 1, 4096), (4096, 65536), None, 0, 1),
)


def decode_x_shape(x_shape, m) -> tuple:
    """A ``DECODE_GEMMS`` x shape at ``m`` rows."""
    return tuple(m if d == ROWS else d for d in x_shape)


def decode_weight(shape, dev, gen=None) -> torch.Tensor:
    """A weight uniform at the configurations' standard deviation 0.02."""
    return (torch.rand(shape, device=dev, generator=gen) - 0.5) * (
        0.02 * math.sqrt(12))


# ragged m, n and k (a tile's guarded edges) and a batch of three
RAGGED_GEMMS = (
    ("ragged nn", "abc,cd->abd", (1, 200, 77), (77, 333)),
    ("ragged tn", "abd,abc->cd", (1, 301, 91), (1, 301, 70)),
    ("batched nt", "bmk,bnk->bmn", (3, 130, 50), (3, 70, 50)),
)


def gemm_plan(spec, sa, sb):
    """(plan, output shape, (batch, m, n, k)) of einsum ``spec`` over
    operands of shapes ``sa`` and ``sb`` (``ops.matmul.plan_gemm``)."""
    import string

    from exprgrad_torch.ops import matmul

    letters = string.ascii_letters
    ins, out = spec.split("->")
    ia, ib = ins.split(",")
    sizes = {}
    for axes, shape in ((ia, sa), (ib, sb)):
        for c, n in zip(axes, shape):
            sizes[letters.index(c)] = n
    ext = [sizes.get(i, 1) for i in range(max(sizes) + 1)]
    plan, why = matmul.plan_gemm([tuple(letters.index(c) for c in ia),
                                  tuple(letters.index(c) for c in ib)],
                                 tuple(letters.index(c) for c in out), ext)
    if plan is None:
        raise ValueError(f"{spec}: {why}")
    a, b = (sb, sa) if plan.swap else (sa, sb)
    batch, m, k = (math.prod(a[d] for d in g) for g in plan.a)
    n = math.prod(b[d] for d in plan.b[1])
    return plan, tuple(ext[letters.index(c)] for c in out), (batch, m, n, k)


def check_gemm_kernel(gen, dev, gpu) -> dict:
    """Phase 6: B1's Hopper mainloop (csrc/gemm_sm90.cu, the einsum
    path's ``ops.matmul.contract``) against its plain version
    ``contract_plain`` (float64) at the training cell's 16 contractions
    and at ragged and batched shapes, each as ``0.5 a.b + c``: within
    split TF32's bound (4 x 2^-24 sqrt(k) + 2^-21 of the product's scale),
    the same bits twice, one launch a call; then each cell shape timed,
    the kernel, its plain version and torch.einsum (TF32 off), beside
    the bound (3 x 2 m n k over the TF32 rate).  Returns {label: {...}}."""
    from exprgrad_torch.ops import matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for label, spec, sa, sb in CELL_GEMMS + RAGGED_GEMMS:
        plan, out_shape, (batch, m, n, k) = gemm_plan(spec, sa, sb)
        a = torch.randn(sa, generator=gen, device=dev)
        b = torch.randn(sb, generator=gen, device=dev)
        c = torch.randn(out_shape, generator=gen, device=dev)
        before = matmul.gemm_launches
        got = matmul.contract(a, b, plan, out_shape, 0.5, c)
        again = matmul.contract(a, b, plan, out_shape, 0.5, c)
        torch.cuda.synchronize()
        assert matmul.gemm_launches == before + 2, (label, before,
                                                    matmul.gemm_launches)
        assert torch.equal(got, again), label
        del again
        want = matmul.contract_plain(a.double(), b.double(), plan,
                                     out_shape, 0.5, c.double())
        err = float((got.double() - want).abs().max())
        del got, want
        scale = float(0.5 * torch.einsum(spec, a.double().abs(),
                                         b.double().abs()).max()
                      + c.abs().max())
        tol = 4 * 2.0 ** -24 * math.sqrt(k) + 2.0 ** -21
        assert err / scale < tol, (label, err, scale, tol)
        row = {"layout": plan.layout, "m": batch * m, "n": n, "k": k,
               "max_abs_err": err, "rel_err": err / scale, "tol": tol}
        if (label, spec, sa, sb) in CELL_GEMMS:
            fns = {"kernel": lambda: matmul.contract(a, b, plan, out_shape),
                   "plain": lambda: matmul.contract_plain(a, b, plan,
                                                          out_shape),
                   "library": lambda: torch.einsum(spec, a, b)}
            runs = {name: [] for name in fns}
            for name in ("plain", "library", "kernel", "kernel", "library",
                         "plain"):
                runs[name].append(cuda_ms(fns[name], iters=3, warmup=1))
            row.update({f"{name}_ms": sum(v) / len(v)
                        for name, v in runs.items()})
            ops = 2.0 * batch * m * n * k
            row["bound_ms"], row["bound_by"] = bound(
                ops, 4 * batch * (m * k + n * k + m * n), **SPLIT_TF32)
            row["tflops"] = ops / row["kernel_ms"] / 1e9
        print(f"gemm {label} ({spec} {list(sa)} x {list(sb)}, "
              f"{plan.layout}, m {batch * m} n {n} k {k}): max |err| "
              f"{err:.3e} ({err / scale:.3e} of the scale, bound "
              f"{tol:.3e})" + (
                  f"; kernel {row['kernel_ms']:.4f} ms ({row['tflops']:.1f}"
                  f" TFLOP/s float32-exact), plain (float64) "
                  f"{row['plain_ms']:.4f} ms, torch.einsum TF32 off "
                  f"{row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                  if "kernel_ms" in row else "") + f" on {gpu}")
        out[label] = row
        del a, b, c
        torch.cuda.empty_cache()
    return out


def b1_blocks(model, target) -> dict:
    """{kernel index: the block ``(bm, bn, bk)``} of every kernel of
    ``target`` that the model's executors launch kernel B1 for."""
    out = {}
    for (name, _), ex in model._executors.items():
        if name != target:
            continue
        for i, kernel in enumerate(ex.target.kernels):
            if i in ex.fused:
                sm = ex.fused[i][0]
            elif (i not in ex._skip_kernels and i in ex._lowerings
                  and ex._lowerings[i].scheduled_route() == "matmul"):
                sm = ex._lowerings[i].scheduled_matmul()
            else:
                continue
            out[i] = (sm.bm, sm.bn, sm.bk)
    return out


def stripped(report) -> set:
    """The kernels for which a TuneReport chose the plain lowering (no
    schedule left); B1 still runs the others it ran before tuning."""
    from exprgrad_torch.autotune import STRIP_LABEL

    return {e.kernel_index for e in report.entries
            if e.chosen["label"] == STRIP_LABEL}


def path_a(egt, matmul, gpu) -> dict:
    """Phase 7: the matmul cell through compile(schedule_mode="force") at
    tile 512 (bench.py's) and at tile 128, each launching B1 once a call
    at the block block_for gives; then Model.autotune of the tile-512
    model, its tuned call, and its tuning exported and applied to a fresh
    compile of the same source."""
    from exprgrad_torch.autotune import apply_tuning, export_tuning
    from exprgrad_torch.backend.scheduled import block_for

    rng = np.random.default_rng(0)
    n = MATMUL_N
    args = {"a": rng.standard_normal((n, n), dtype=np.float32),
            "b": rng.standard_normal((n, n), dtype=np.float32)}
    want = (torch.from_numpy(args["a"]).double().cuda()
            @ torch.from_numpy(args["b"]).double().cuda()).cpu().numpy()
    matmul.launches = 0
    models, res = {}, {"ms": {}}
    for tile in (MATMUL_TILE, MATMUL_TILE_SMALL):
        model = models[tile] = egt.compile(
            matmul_graph(egt, tile), seed=0, schedule_mode="force",
            device="cuda")
        before = matmul.launches
        t0 = time.perf_counter()
        out = model.call("c", args)
        first_ms = (time.perf_counter() - t0) * 1e3
        assert matmul.launches - before == 1, matmul.launches - before
        stats = model.lowering_stats("c")
        assert stats == {"matmul": 1}, stats
        blocks = b1_blocks(model, "c")
        assert blocks == {0: block_for(tile, tile, tile)}, blocks
        assert out.shape == (n, n) and np.isfinite(out).all()
        err = float(np.abs(out - want).max())
        np.testing.assert_allclose(out, want, **matmul_f32_tol(n))
        t0 = time.perf_counter()
        for _ in range(3):
            model.call("c", args)
        call_ms = (time.perf_counter() - t0) * 1e3 / 3
        assert matmul.launches - before == 4, matmul.launches - before
        res["ms"][tile] = call_ms
        print(f"path (a) matmul {n}^3 schedule(tile {tile}) force: 1 launch "
              f"per call at block {blocks[0]}, lowering {stats}, max |err| "
              f"vs torch.matmul float64 {err:.3e}; call (host arrays in and "
              f"out) {call_ms:.2f} ms warm, {first_ms:.2f} ms first, on "
              f"{gpu}")

    # the tile-512 model tuned on the card
    model = models[MATMUL_TILE]
    t0 = time.perf_counter()
    report = model.autotune("c", args)
    tune_s = time.perf_counter() - t0
    print(f"path (a) autotune {n}^3 ({tune_s:.1f} s) on {gpu}:\n{report}")
    before, before_gemm = matmul.launches, matmul.gemm_launches
    out = model.call("c", args)
    launched = matmul.launches - before
    blocks = b1_blocks(model, "c")
    stats = model.lowering_stats("c")
    if stripped(report):
        # the plain lowering: the einsum path, which at this size in
        # float32 runs on B1's Hopper mainloop (the cost model's choice)
        assert stats == {"einsum-b1": 1} and not blocks and not launched, (
            stats, blocks, launched)
        assert matmul.gemm_launches - before_gemm == 1, (
            matmul.gemm_launches - before_gemm)
    else:
        (kernel,) = model.program.targets["c"].kernels
        tiles = [loop.schedule.tile_size for loop in kernel.loops]
        assert stats == {"matmul": 1} and launched == 1, (stats, launched)
        assert blocks == {0: block_for(*tiles)}, (blocks, tiles)
    assert np.isfinite(out).all()
    err = float(np.abs(out - want).max())
    np.testing.assert_allclose(out, want, **matmul_f32_tol(n))
    t0 = time.perf_counter()
    for _ in range(3):
        model.call("c", args)
    res["ms"]["tuned"] = (time.perf_counter() - t0) * 1e3 / 3

    # the tuning, as a file would hold it, on a fresh compile
    tuning = json.loads(json.dumps(export_tuning(model, "c")))
    fresh = egt.compile(matmul_graph(egt, MATMUL_TILE), seed=0,
                        schedule_mode="force", device="cuda")
    apply_tuning(fresh, tuning)
    again = fresh.call("c", args)
    assert b1_blocks(fresh, "c") == blocks, b1_blocks(fresh, "c")
    assert np.array_equal(again, out)
    assert export_tuning(fresh, "c") == tuning
    res.update(launches=matmul.launches, report=report, blocks=blocks)
    print(f"path (a) tuned: B1 {launched} launch per call at {blocks}, "
          f"lowering {stats}, max |err| vs torch.matmul float64 {err:.3e}; "
          f"call {res['ms']['tuned']:.2f} ms warm; export_tuning -> "
          f"apply_tuning on a fresh compile: the same blocks and bits; "
          f"{matmul.launches} B1 launches in the path, on {gpu}")
    return res


def path_b(egt, matmul, gpu) -> dict:
    """Phase 8: the scheduled MLP, predict and three fit steps."""
    graph = scheduled_mlp(egt, **MLP)
    model = egt.compile(graph, seed=0, schedule_mode="force",
                        device="cuda")
    cpu = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    rng = np.random.default_rng(1)
    dim = MLP["dim"]
    data = {"v": rng.standard_normal((MLP_ROWS * MLP_STEPS, dim),
                                     dtype=np.float32),
            "t": rng.standard_normal((MLP_ROWS * MLP_STEPS, dim),
                                     dtype=np.float32)}
    v = {"v": data["v"][:MLP_ROWS]}
    matmul.launches = 0
    probs = model.call("predict", v)
    predict_launches = matmul.launches
    stats = model.lowering_stats("predict")
    assert stats == {"matmul-fused": 2}, stats
    assert predict_launches == 2, predict_launches
    want = cpu.call("predict", v)
    assert np.isfinite(probs).all()
    err = float(np.abs(probs - want).max())
    np.testing.assert_allclose(probs, want, **matmul_f32_tol(MLP["hidden"]))
    print(f"path (b) predict [{MLP_ROWS},{dim}]: {predict_launches} kernel "
          f"launches, lowering {stats}, max |err| vs the CPU port "
          f"{err:.3e}")

    start = {t: x.clone() for t, x in cpu.params.items()}
    matmul.launches = 0
    model.fit("train", data, batch_size=MLP_ROWS, log_status=False)
    torch.cuda.synchronize()
    fit_launches = matmul.launches
    train_stats = model.lowering_stats("train")
    per_step = train_stats.get("matmul", 0) + train_stats.get(
        "matmul-fused", 0)
    assert per_step >= 1 and fit_launches == MLP_STEPS * per_step, (
        fit_launches, train_stats)
    t0 = time.perf_counter()
    cpu.fit("train", data, batch_size=MLP_ROWS, log_status=False)
    cpu_s = time.perf_counter() - t0
    first = {"v": data["v"][:MLP_ROWS], "t": data["t"][:MLP_ROWS]}
    loss = float(model.call("loss", first)[0])
    cpu_loss = float(cpu.call("loss", first)[0])
    rel, worst = update_err(model.params, cpu.params, start)
    print(f"path (b) fit {MLP_STEPS} steps: {fit_launches} kernel launches "
          f"({per_step} per step), lowering {train_stats}; loss {loss:.6f} "
          f"vs CPU {cpu_loss:.6f} (CPU {cpu_s:.1f} s); parameters vs CPU: "
          f"|diff| / |update| {rel:.3e}, max |diff| {worst:.3e}")
    np.testing.assert_allclose(loss, cpu_loss, **TRAIN_LOSS)
    assert rel <= TRAIN_UPDATE_RTOL, rel

    model.epoch += 1
    model.apply("train", first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        model.apply("train", first)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"path (b) train step [{MLP_ROWS},{dim}]: {step_ms:.2f} ms (mean "
          f"of {TIMED_STEPS} warm steps), {per_step} kernel launches per "
          f"step, on {gpu}")

    # the train step tuned on the card: the parameters stay, B1 runs the
    # kernels that kept a schedule, and two tuned steps agree with two
    # untuned ones from the same state by phase 5's rule
    twin = egt.from_state(
        graph, {t: x.cpu().numpy() for t, x in model.params.items()},
        {t: x.cpu().numpy() for t, x in model.caches.items()}, model.epoch,
        model._rng.bit_generator.state, schedule_mode="force",
        device="cuda")
    start = {t: x.clone() for t, x in model.params.items()}
    untuned = set(b1_blocks(model, "train"))  # the step's B1 kernels
    matmul.launches = 0
    t0 = time.perf_counter()
    report = model.autotune("train", first, chain=2)
    tune_s = time.perf_counter() - t0
    tune_launches = matmul.launches
    print(f"path (b) autotune train [{MLP_ROWS},{dim}] ({tune_s:.1f} s, "
          f"{tune_launches} B1 launches) on {gpu}:\n{report}")
    for t, x in model.params.items():
        assert torch.equal(x, start[t]), f"autotune moved t{t}"
    kept = untuned - stripped(report)
    matmul.launches = 0
    for m in (model, twin):
        for _ in range(2):
            m.epoch += 1
            m.apply("train", first)
        torch.cuda.synchronize()
        if m is model:
            tuned_launches = matmul.launches
    tuned_stats = model.lowering_stats("train")
    tuned_per_step = tuned_stats.get("matmul", 0) + tuned_stats.get(
        "matmul-fused", 0)
    blocks = b1_blocks(model, "train")
    assert set(blocks) == kept, (blocks, kept)
    assert tuned_per_step == len(kept), (tuned_stats, kept)
    assert tuned_launches == 2 * len(kept), (tuned_launches, kept)
    loss = float(model.call("loss", first)[0])
    twin_loss = float(twin.call("loss", first)[0])
    rel, worst = update_err(model.params, twin.params, start)
    print(f"path (b) 2 tuned steps: B1 {tuned_launches} launches "
          f"({tuned_per_step} per step, at {blocks}; untuned {per_step} "
          f"per step at {b1_blocks(twin, 'train')}); loss {loss:.6f} vs "
          f"untuned {twin_loss:.6f}; parameters vs untuned: |diff| / "
          f"|update| {rel:.3e}, max |diff| {worst:.3e}")
    np.testing.assert_allclose(loss, twin_loss, **TRAIN_LOSS)
    assert rel <= TRAIN_UPDATE_RTOL, rel
    return {"predict": predict_launches, "fit": fit_launches,
            "tune": tune_launches, "tuned": tuned_launches}


def executor_of(model):
    (ex,) = model._executors.values()
    return ex


def kernel_vs_plain(egt, graphs, args, target="out", epoch=3):
    """The target on the card through the generated kernels
    (schedule_mode="force"), twice, which must give the same bits, and
    through the plain lowering (schedule_mode="ignore"), same parameters
    and inputs: (kernel output, plain output, the kernel model's
    stats)."""
    outs = []
    for mode in ("force", "ignore"):
        model = egt.compile(graphs, seed=0, schedule_mode=mode,
                            device="cuda")
        model.epoch = epoch
        outs.append(model.call(target, args))
        if mode == "force":
            stats = model.lowering_stats(target)
            again = model.call(target, args)
            assert np.array_equal(outs[0], again, equal_nan=True), (
                f"{target}: two runs of the generated kernels differ")
    return outs[0], outs[1], stats


def bf16_kernel_vs_plain(egt, graph, args, epoch=3):
    """The same pair in bfloat16: the compiled program with its scalar
    type set to bfloat16, run by an executor of each mode on bfloat16
    copies of the inputs and parameters (the generated kernels twice,
    which must give the same bits)."""
    from exprgrad_torch.backend.executor import TorchExecutor
    from exprgrad_torch.passes import infer_shapes

    model = egt.compile(graph, seed=0, schedule_mode="force",
                        device="cuda")
    prog = model.program.copy()
    prog.scalar_type = egt.ir.ScalarType.BF16
    shapes = infer_shapes(prog, "out", [(prog.inputs[n], list(v.shape))
                                        for n, v in args.items()])
    tensors = {prog.inputs[n]: torch.from_numpy(v).to(model.device)
               .bfloat16() for n, v in args.items()}
    tensors.update({t: p.bfloat16() for t, p in model.params.items()})
    out = prog.targets["out"].output
    got = {}
    for mode in ("force", "ignore"):
        ex = TorchExecutor(prog, "out", shapes, model.device, mode)
        got[mode] = ex.run(dict(tensors), shapes, epoch, 0)[out].float()
        if mode == "force":
            again = ex.run(dict(tensors), shapes, epoch, 0)[out].float()
            assert torch.equal(got[mode], again), (
                "two bfloat16 runs of the generated kernels differ")
    return got["force"], got["ignore"]


def assert_same(name, got, want, tol) -> float:
    """got == want within tol, with the same infinities (an empty row of a
    max or min scatter keeps its identity); returns max |error|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=name)
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all(), name
    np.testing.assert_allclose(got[fin], want[fin], **tol, err_msg=name)
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def check_generated_kernels(egt, gpu) -> dict:
    """Phase 9: B5 and B6 against their plain versions on the card, one
    program per family in float32 (and ten in bfloat16), then the seeded
    sweep of random kernels and chains, each run twice for the same
    bits.  Returns the max |error| of each kernel."""
    worst = {"mapreduce": 0.0, "rowchain": 0.0}
    families = [(n, f, "mapreduce") for n, f in MAPREDUCE_FAMILIES.items()]
    families += [(n, f, "rowchain") for n, f in ROWCHAIN_FAMILIES.items()]
    for name, family, kind in families:
        graph, args = family(egt)
        got, want, stats = kernel_vs_plain(egt, graph, args)
        assert stats.get(kind) == 1, (name, stats)
        tol = GEN_SCATTER if "scatter" in name else GEN_F32
        err = assert_same(f"{kind} {name}", got, want, tol)
        worst[kind] = max(worst[kind], err)
        line = (f"kernel check {kind} {name}: two runs equal bit for bit; "
                f"max |err| {err:.3e}")
        if name in BF16_FAMILIES:
            got, want = bf16_kernel_vs_plain(egt, graph, args)
            bf_err = assert_same(f"{kind} {name} bf16", got.cpu(),
                                 want.cpu(), GEN_BF16)
            line += f", bfloat16 {bf_err:.3e}"
        print(line)
    hits = {}
    for kind in ("general", "cmpred", "rowchain"):
        hits[kind] = 0
        for seed in range(FUZZ_SEEDS):
            graphs, args = fuzz_case(egt, kind, seed)
            for target in ("out", "esc")[:len(graphs)]:
                got, want, stats = kernel_vs_plain(egt, graphs, args, target)
                assert_same(f"fuzz {kind} seed {seed} {target}", got, want,
                            GEN_FUZZ)
                if target == "out":
                    hits[kind] += bool(stats.get("mapreduce")
                                       or stats.get("rowchain"))
    # a gathered index outside the table reads 0, as the TPU kernel does
    graph, args = fam_gather(egt)
    tok = args["tok"].copy()
    tok[0, 0], tok[1, 2], tok[2, 4] = 8, -1, 1000
    got = egt.compile(graph, seed=0, schedule_mode="force",
                      device="cuda").call("out", {**args, "tok": tok})
    idx = tok.astype(np.int64)
    inside = (idx >= 0) & (idx < args["table"].shape[0])
    rows = np.where(inside[..., None],
                    args["table"][np.clip(idx, 0, args["table"].shape[0] - 1)],
                    0.0)
    assert_same("gather out of range", got, (rows * 2.0 + 1.0).sum(1),
                GEN_F32)
    print("kernel check mapreduce gather with indices outside the table: "
          "they read 0")
    print(f"seeded sweep: {FUZZ_SEEDS} seeds each of the general, "
          f"computed-index and row-chain fuzzers match the plain version; "
          f"seeds that ran a generated kernel {hits}")
    return worst


def scatter_tokens(kind, n, v, seed=0):
    """bench.py's scatter-add indices (uniform in [0, v)) and the edges of
    phase 9: every index on one destination, 90% on one, 5% outside
    [0, v)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, v, n)
    if kind == "all on one destination":
        tok = np.full(n, 7)
    elif kind == "90% on one destination":
        tok = np.where(rng.random(n) < 0.9, 11, tok)
    elif kind == "5% outside [0, v)":
        tok = np.where(rng.random(n) < 0.05,
                       rng.choice([-1, v, v + 100, -50], n), tok)
    return tok.astype(np.float32)


SCATTER_EDGES = ("all on one destination", "90% on one destination",
                 "5% outside [0, v)")


def check_scatter_cases(egt) -> float:
    """Phase 9 (b): bench.py's scatter-add at its full shape with every
    index on one destination, with 90% on one and with 5% outside [0, v),
    each run twice on the card (the same bits both times) and held against
    the plain lowering.  The indices outside are dropped; the plain
    lowering clamps them, as the JAX package's XLA path does, so that case
    is held against numpy's sum in float64.  Returns the max |error|."""
    worst = 0.0
    v, d, n = SCATTER["v"], SCATTER["d"], SCATTER["n"]
    graph = scatter_add_graph(egt, v, d, SCATTER["tile"])
    g = (np.random.default_rng(1).normal(size=(n, d)) / np.sqrt(d)).astype(
        np.float32)
    for kind in SCATTER_EDGES:
        tok = scatter_tokens(kind, n, v)
        args = {"tok": tok, "g": g}
        idx = tok.astype(np.int64)
        keep = (idx >= 0) & (idx < v)
        exact = np.zeros((v, d))
        np.add.at(exact, idx[keep], g[keep].astype(np.float64))
        got, want, _ = kernel_vs_plain(egt, graph, args, "demb")
        if not keep.all():
            want = exact
        err = assert_same(f"scatter-add {kind}", got, want, GEN_SCATTER)
        worst = max(worst, err)
        print(f"kernel check mapreduce scatter-add n={n} v={v} d={d}, "
              f"{kind}: two runs equal bit for bit; max |err| "
              f"{err:.3e} against the "
              f"{'plain lowering' if keep.all() else 'float64 sum'}, "
              f"{float(np.abs(got - exact).max()):.3e} against the float64 "
              f"sum")
    return worst


def check_launch_path(egt, gpu) -> None:
    """Phase 9 (c): the generated kernels' launch path
    (``csrc/launch.cpp``).  A kernel's first call on the card registers
    its launch table; later calls launch from C++ (no first call, one
    count each); an operand at an address off 16 bytes (a view at an odd
    offset) is copied and gives the aligned operand's bits; an operand
    of another dtype raises; prints the host us a call."""
    from exprgrad_torch.ops import mapreduce
    from exprgrad_torch.utils import launcher

    graph, args = fam_column_reduction(egt)
    model = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
    model.call("out", args)
    ex = executor_of(model)
    (low,) = ex._lowerings.values()
    kern = low.scheduled_mapreduce().compiled()
    prog = model.program
    out_t = prog.targets["out"].output
    a = torch.from_numpy(args["a"]).cuda()
    b = torch.from_numpy(args["b"]).cuda()
    spare = torch.empty(a.numel() + 1, device="cuda")
    spare[1:] = a.reshape(-1)
    shifted = spare[1:].view(a.shape)
    assert shifted.data_ptr() % 16
    tensors = {prog.inputs["a"]: a, prog.inputs["b"]: b,
               out_t: torch.zeros(ex.shapes[out_t], device="cuda")}
    first, count = launcher.first_calls(), mapreduce.launches
    got = [mapreduce.mapreduce_impl(kern, tensors, 1) for _ in range(2)]
    got.append(mapreduce.mapreduce_impl(
        kern, {**tensors, prog.inputs["a"]: shifted}, 1))
    torch.cuda.synchronize()
    assert launcher.first_calls() == first, "a call found no launch table"
    assert mapreduce.launches - count == 3, mapreduce.launches - count
    assert all(torch.equal(got[0], g) for g in got[1:]), \
        "the launches differ (an operand off 16 bytes included)"
    try:
        mapreduce.mapreduce_impl(kern, {**tensors,
                                        prog.inputs["a"]: a.double()}, 1)
    except RuntimeError as err:
        assert "operand" in str(err), err
    else:
        raise AssertionError("a float64 operand reached the kernel")
    us = host_us(lambda: mapreduce.mapreduce_impl(kern, tensors, 1),
                 calls=1000)
    print(f"launch path: {launcher.registered()} launch tables registered, "
          f"{launcher.first_calls()} first calls in all; from C++ the same "
          f"bits on each call and with an operand off 16 bytes; a float64 "
          f"operand raises; host {us:.2f} us a call (the split column sum "
          f"{kern.plan['grid']}, two launches) on {gpu}")


def time_generated_kernels(egt, gpu) -> dict:
    """Phase 9 timing: B6 at softmax 8192^2 and B5 at bench.py's scatter-
    add shape, each beside its plain version and one PyTorch call for the
    same function, with CUDA events, in turns."""
    from exprgrad_torch.ops import mapreduce, rowchain

    out = {}
    n = SOFTMAX_N
    graph, args = softmax_chain(egt, {"y": 32}, rows=n, cols=n, scale=1.0)
    model = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
    model.call("out", args)
    ex = executor_of(model)
    (chain,) = ex.row_fused.values()
    dev = model.device
    x = torch.from_numpy(args["inp"]).to(dev)
    prog = model.program
    tensors = {prog.inputs["inp"]: x,
               prog.targets["out"].output: torch.zeros_like(x)}
    fns = {"kernel": lambda t=tensors: chain.lower(t),
           "plain": lambda t=tensors: chain.plain(t, 0),
           "library": lambda: torch.softmax(x, -1)}
    got = fns["kernel"]()[prog.targets["out"].output]
    want = fns["plain"]()[prog.targets["out"].output]
    err = assert_same("rowchain softmax 8192^2", got.cpu(), want.cpu(),
                      SOFTMAX_TOL)
    out["rowchain"] = timed(fns, chain.compiled().plan["bytes"])
    out["rowchain"]["err"] = err
    rowchain_fns = {"B6 softmax 8192^2": fns["kernel"],
                    "torch.softmax 8192^2": fns["library"]}
    print(f"rowchain softmax {n}x{n} f32: {out['rowchain']} on {gpu}")

    v, d, rows = SCATTER["v"], SCATTER["d"], SCATTER["n"]
    rng = np.random.default_rng(0)
    tok = rng.integers(0, v, rows).astype(np.float32)
    g = (rng.normal(size=(rows, d)) / np.sqrt(d)).astype(np.float32)
    model = egt.compile(scatter_add_graph(egt, v, d, SCATTER["tile"]),
                        seed=0, schedule_mode="force", device="cuda")
    model.call("demb", {"tok": tok, "g": g})
    ex = executor_of(model)
    (low,) = ex._lowerings.values()
    mr = low.scheduled_mapreduce()
    prog = model.program
    tok_t, g_t = torch.from_numpy(tok).to(dev), torch.from_numpy(g).to(dev)
    prev = torch.zeros(v, d, device=dev)
    tensors = {prog.inputs["tok"]: tok_t, prog.inputs["g"]: g_t,
               prog.targets["demb"].output: prev}
    tok_long = tok_t.long()
    fns = {"kernel": lambda t=tensors: mr.lower(t),
           "plain": lambda t=tensors: mr.plain(t, 0),
           "library": lambda: prev.index_add(0, tok_long, g_t)}
    err = assert_same("mapreduce scatter-add", fns["kernel"]().cpu(),
                      fns["plain"]().cpu(), GEN_SCATTER)
    out["mapreduce"] = timed(fns, mr.compiled().plan["bytes"])
    out["mapreduce"]["err"] = err
    out["mapreduce"]["host_us"] = {name: host_us(fns[name])
                                   for name in ("kernel", "library")}
    print(f"mapreduce scatter-add n={rows} v={v} d={d} f32: "
          f"{out['mapreduce']} on {gpu}")
    # the kernel and index_add on each edge's indices, for the device
    # times taken after the timed phases
    profiled = {"scatter-add uniform": fns["kernel"],
                "index_add uniform": fns["library"]}
    for kind in SCATTER_EDGES[:2]:
        skew = torch.from_numpy(scatter_tokens(kind, rows, v)).to(dev)
        edge = {**tensors, prog.inputs["tok"]: skew}
        profiled[f"scatter-add {kind}"] = lambda edge=edge: mr.lower(edge)
        profiled[f"index_add {kind}"] = (
            lambda skew=skew.long(): prev.index_add(0, skew, g_t))
    out["mapreduce"]["profiled"] = profiled
    out["rowchain"]["profiled"] = rowchain_fns
    mapreduce.launches = rowchain.launches = 0
    return out


def timed(fns, nbytes) -> dict:
    """Mean ms of each function by CUDA events, in turns, and the bound
    of the bytes it must move."""
    runs = {name: [] for name in fns}
    for name in ("plain", "library", "kernel", "kernel", "library",
                 "plain"):
        runs[name].append(cuda_ms(fns[name], iters=20, warmup=3))
    res = {name: sum(v) / len(v) for name, v in runs.items()}
    res["bound"] = bound(0.0, nbytes)
    return res


def path_c_programs(m):
    """The programs of examples/scheduled_kernels.py sections 3-9 at the
    example's sizes, and the two map/reduce cells of bench.py at theirs:
    (name, graph, target, inputs, the generated kernels they run)."""
    rng = np.random.default_rng(0)
    out = []
    n = SOFTMAX_N
    graph, args = softmax_chain(m, {"y": 32}, rows=n, cols=n, scale=1.0)
    out.append(("softmax 8192^2 (bench.py)", graph, "out", args,
                {"rowchain": 1}))
    v, d, rows = SCATTER["v"], SCATTER["d"], SCATTER["n"]
    out.append(("scatter-add (bench.py)",
                scatter_add_graph(m, v, d, SCATTER["tile"]), "demb",
                {"tok": rng.integers(0, v, rows).astype(np.float32),
                 "g": (rng.normal(size=(rows, d)) / np.sqrt(d)).astype(
                     np.float32)}, {"mapreduce": 1}))
    graph, args = softmax_chain(m, {"y": 64}, rows=256, cols=512, scale=1.0)
    out.append(("softmax 256x512", graph, "out", args, {"rowchain": 1}))
    inp = m.input("inp")
    q, k = m.iters("q", "k")
    causal = m.Fun("causal")
    causal[q, k] = m.select(k <= q, inp[q, k], 0.0)
    causal.schedule(tile={"q": 64})
    out.append(("causal mask", causal.target("causal"), "causal",
                {"inp": _normal(40, (128, 128))[0]}, {"mapreduce": 1}))
    img = m.input("img")
    y = m.iters("y")
    x = m.irange("x", 0, img.shape[1] - 2)
    blur = m.Fun("blur")
    blur[y, x] = (img[y, x] + img[y, x + 1] + img[y, x + 2]) * (1.0 / 3.0)
    blur.schedule(tile={"y": 32})
    out.append(("stencil blur", blur.target("blur"), "blur",
                {"img": _normal(41, (64, 258))[0]}, {"mapreduce": 1}))
    a, b = m.input("a"), m.input("b")
    y, x = m.iters("y", "x")
    loss = m.Fun("loss")
    loss[0] = m.sq(a[y, x] - b[y, x])
    loss.schedule(tile={"y": 32})
    av, bv = _normal(42, (128, 256), (128, 256))
    out.append(("scalar loss", loss.target("loss"), "loss",
                {"a": av, "b": bv}, {"mapreduce": 1}))
    ta = m.input("ta")
    y = m.iters("y")
    x = m.irange("x", 0, y + 1)
    tri = m.Fun("tri")
    tri[y] = ta[y, x]
    tri.schedule(tile={"y": 32})
    out.append(("triangular row sums", tri.target("tri"), "tri",
                {"ta": _normal(43, (128, 128))[0]}, {"mapreduce": 1}))
    import importlib

    layers = importlib.import_module(m.__name__ + ".layers")
    rn = layers.rms_norm(m.input("rn"), 256, row_tile=32)
    out.append(("rms_norm(row_tile=32)", rn.target("rn_out"), "rn_out",
                {"rn": _normal(44, (64, 256))[0]}, {"rowchain": 1}))
    tok, table = m.input("tok"), m.input("table")
    i, d = m.iters("i", "d")
    emb = m.Fun("emb")
    emb[i, d] = table[m.to_index(tok[i]), d]
    emb.with_shape([tok.shape[0], table.shape[1]])
    emb.schedule(tile={"i": 8})
    out.append(("embedding gather", emb.target("emb"), "emb",
                {"tok": rng.integers(0, 32, 16).astype(np.float32),
                 "table": _normal(45, (32, 128))[0]}, {"mapreduce": 1}))
    ha, hx = m.input("ha"), m.input("hx")
    y2, x2 = m.iters("y2", "x2")
    hashed = m.Fun("hashed")
    hashed[y2, x2] = hx[y2, x2] * ha[(y2 * x2) % 17]
    hashed.with_shape([hx.shape[0], hx.shape[1]])
    hashed.schedule(tile={"y2": 8})
    hv, av2 = _normal(46, (16, 64), (17,))
    out.append(("hashed LUT", hashed.target("hashed"), "hashed",
                {"hx": hv, "ha": av2}, {"mapreduce": 1}))
    sv = m.input("sv")
    si, sj = m.iters("si", "sj")
    hist = m.Fun("hist")
    hist[(si + sj) % 11] = sv[si, sj]
    hist.with_shape([11])
    hist.schedule(tile={"si": 8})
    out.append(("banded histogram", hist.target("hist"), "hist",
                {"sv": _normal(47, (16, 64))[0]}, {"mapreduce": 1}))
    return out


def path_c(egt, gpu) -> dict:
    """Phase 10: the schedule DSL surface under schedule_mode="force":
    every program launches its kernels once per kernel, as its stats say,
    and matches the plain lowering on the card."""
    from exprgrad_torch.ops import mapreduce, rowchain

    programs = path_c_programs(egt)
    models = []
    for name, graph, target, args, expect in programs:
        models.append(egt.compile(graph, seed=0, schedule_mode="force",
                                  device="cuda"))
    mapreduce.launches = rowchain.launches = 0
    outs = [model.call(target, args) for model, (_, _, target, args, _)
            in zip(models, programs)]
    torch.cuda.synchronize()
    launches = {"mapreduce": mapreduce.launches,
                "rowchain": rowchain.launches}
    want_launches = {"mapreduce": 0, "rowchain": 0}
    for model, got, (name, graph, target, args, expect) in zip(
            models, outs, programs):
        stats = model.lowering_stats(target)
        assert stats == expect, (name, stats)
        for kind in want_launches:
            want_launches[kind] += stats.get(kind, 0)
        plain = egt.compile(graph, seed=0, schedule_mode="ignore",
                            device="cuda").call(target, args)
        tol = (SOFTMAX_TOL if name.startswith("softmax") else
               GEN_SCATTER if "scatter" in name or "histogram" in name
               else GEN_F32)
        err = assert_same(f"path (c) {name}", got, plain, tol)
        print(f"path (c) {name}: lowering {stats}, max |err| vs the plain "
              f"lowering {err:.3e}")
    assert launches == want_launches, (launches, want_launches)
    model, (_, _, target, args, _) = models[0], programs[0]
    model.call(target, args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        model.call(target, args)
    call_ms = (time.perf_counter() - t0) * 1e3 / 5
    print(f"path (c): kernel launches {launches}, as the stats say; softmax "
          f"{SOFTMAX_N}^2 call (host arrays in and out) {call_ms:.2f} ms "
          f"warm on {gpu}")
    return launches


def path_d(egt, gpu) -> dict:
    """Phase 11: the flash_transformer head with row-tiled layers at the
    serving width: predict and three fit steps, against the CPU port."""
    from exprgrad_torch.ops import mapreduce, matmul, rowchain

    graph = transformer_head(egt, HEAD["dim"], HEAD["vocab"])
    model = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
    cpu = egt.compile(graph, seed=0, schedule_mode="force", device="cpu")
    rows, dim, vocab = HEAD["rows"], HEAD["dim"], HEAD["vocab"]
    rng = np.random.default_rng(2)
    data = {"x": rng.standard_normal((rows * HEAD_STEPS, dim),
                                     dtype=np.float32),
            "labels": np.eye(vocab, dtype=np.float32)[
                rng.integers(0, vocab, rows * HEAD_STEPS)]}
    first = {"x": data["x"][:rows]}
    counters = (mapreduce, rowchain, matmul)
    for c in counters:
        c.launches = 0
    probs = model.call("predict", first)
    torch.cuda.synchronize()
    predict_launches = {c.__name__.split(".")[-1]: c.launches
                        for c in counters}
    stats = model.lowering_stats("predict")
    want = {"mapreduce": stats.get("mapreduce", 0),
            "rowchain": stats.get("rowchain", 0),
            "matmul": stats.get("matmul", 0) + stats.get("matmul-fused", 0)}
    assert predict_launches == want, (predict_launches, stats)
    assert predict_launches["rowchain"] == 2, stats
    cpu_probs = cpu.call("predict", first)
    assert probs.shape == (rows, vocab) and np.isfinite(probs).all()
    err = float(np.abs(probs - cpu_probs).max())
    np.testing.assert_allclose(probs, cpu_probs, **PREDICT)
    print(f"path (d) predict [{rows},{dim}] -> [{rows},{vocab}]: launches "
          f"{predict_launches}, lowering {stats}, max |err| vs the CPU port "
          f"{err:.3e}")

    start = {t: x.clone() for t, x in cpu.params.items()}
    for c in counters:
        c.launches = 0
    model.fit("train", data, batch_size=rows, log_status=False)
    torch.cuda.synchronize()
    fit_launches = {c.__name__.split(".")[-1]: c.launches for c in counters}
    train_stats = model.lowering_stats("train")
    per_step = {"mapreduce": train_stats.get("mapreduce", 0),
                "rowchain": train_stats.get("rowchain", 0),
                "matmul": train_stats.get("matmul", 0)
                + train_stats.get("matmul-fused", 0)}
    assert fit_launches == {k: HEAD_STEPS * v for k, v in per_step.items()}, (
        fit_launches, train_stats)
    assert per_step["mapreduce"] >= 1 and per_step["rowchain"] >= 1, \
        train_stats
    cpu.fit("train", data, batch_size=rows, log_status=False)
    batch = {"x": data["x"][:rows], "labels": data["labels"][:rows]}
    loss = float(model.call("loss", batch)[0])
    cpu_loss = float(cpu.call("loss", batch)[0])
    rel, worst = update_err(model.params, cpu.params, start)
    print(f"path (d) fit {HEAD_STEPS} steps: launches {fit_launches} "
          f"({per_step} per step), lowering {train_stats}; loss {loss:.6f} "
          f"vs CPU {cpu_loss:.6f}; parameters vs CPU: |diff| / |update| "
          f"{rel:.3e}, max |diff| {worst:.3e}")
    np.testing.assert_allclose(loss, cpu_loss, **TRAIN_LOSS)
    assert rel <= TRAIN_UPDATE_RTOL, rel

    model.epoch += 1
    batch = {"x": data["x"][:rows], "labels": data["labels"][:rows]}
    model.apply("train", batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        model.apply("train", batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"path (d) train step [{rows},{dim}]: {step_ms:.2f} ms (mean of "
          f"{TIMED_STEPS} warm steps) on {gpu}")
    step_kernels = time_step_kernels(model, batch, gpu)
    return {"predict": predict_launches, "fit": fit_launches,
            "step_kernels": step_kernels}


def _library_twin(mr, tensors):
    """(label, fn) of one torch call of a B5 kernel's traffic: torch.sum
    of its largest operand over the dims the kernel reduces, or torch.mul
    of its two largest operands of the same shape."""
    reads = sorted(mr.kernel.reads, key=lambda r: tensors[r.tensor].numel(),
                   reverse=True)
    x = tensors[reads[0].tensor]
    if mr.red_axes:
        dims = [d for d, a in enumerate(mr.read_axes[reads[0].data])
                if a in mr.red_axes]
        return (f"torch.sum(dim={tuple(dims)})",
                lambda: torch.sum(x, dim=dims))
    same = [tensors[r.tensor] for r in reads[1:]
            if tensors[r.tensor].shape == x.shape]
    y = same[0] if same else x
    return "torch.mul", lambda: torch.mul(x, y)


def time_step_kernels(model, batch, gpu) -> list:
    """Phase 11: each B5 kernel of path (d)'s train step alone, on the
    tensors one step hands it (CUDA events, 50 calls), beside its bound
    (its bytes, every read tensor and the output once, over 3.35 TB/s)
    and a torch call of the same traffic, and its plan and the 16-byte
    loads (``ld.global.v4``) of its PTX.  Each row's ``profiled`` calls
    are timed by torch.profiler at the end of the run (device ms beside
    the events).  These launches are not the main path's: the counters
    are read before."""
    from exprgrad_torch.ops import mapreduce
    from exprgrad_torch.utils import launcher

    (ex,) = [ex for (name, _), ex in model._executors.items()
             if name == "train"]
    lows = {}
    for i, low in ex._lowerings.items():
        if (i in ex._skip_kernels or i in ex.fused or i in ex.row_fused
                or low.kernel.extern is not None or not low._bounds_ok
                or low.scheduled_route() != "mapreduce"):
            continue
        lows[id(low.scheduled_mapreduce().compiled())] = low
    seen = {}
    real = mapreduce.mapreduce_impl

    def spy(kern, tensors, epoch):
        if id(kern) in lows and id(kern) not in seen:
            seen[id(kern)] = (kern, {t: tensors[t] for t in kern.args},
                              epoch)
        return real(kern, tensors, epoch)

    mapreduce.mapreduce_impl = spy
    try:
        model.apply("train", batch)
    finally:
        mapreduce.mapreduce_impl = real
    torch.cuda.synchronize()
    rows = []
    for key, (kern, tensors, epoch) in seen.items():
        low = lows[key]
        mr = low.scheduled_mapreduce()
        call = (lambda kern=kern, tensors=tensors, epoch=epoch:
                real(kern, tensors, epoch))
        ms = cuda_ms(call, iters=50)
        label, fn = _library_twin(mr, tensors)
        library = cuda_ms(fn, iters=50)
        bound_ms = mr.total_bytes / PEAK_HBM_BYTES * 1e3
        shapes = (f"{[tuple(low.shapes[r.tensor]) for r in low.kernel.reads]}"
                  f" -> {tuple(low.shapes[low.kernel.write.tensor])}")
        plan = {k: kern.plan[k] for k in ("grid", "block_p", "block_q",
                                          "num_warps", "splits")}
        v4 = {name: ck.asm["ptx"].count("ld.global.v4")
              for name, ck in launcher.compiled_kernels(kern.spec).items()}
        rows.append({"kernel": low._kernel_desc(), "shapes": shapes,
                     "ms": ms, "bound_ms": bound_ms,
                     "bytes": mr.total_bytes, "library": label,
                     "library_ms": library, "plan": plan, "ld_v4": v4,
                     "profiled": (call, fn)})
        print(f"path (d) step B5 {low._kernel_desc()} {shapes}: {ms:.5f} "
              f"ms, bound {bound_ms:.5f} ms ({mr.total_bytes} bytes), "
              f"{label} {library:.5f} ms; plan {plan}, 16-byte loads in "
              f"the PTX {v4} on {gpu}")
    assert len(rows) == len(lows), (len(rows), len(lows))
    return rows


# --- paged serving: kernel B7 and the continuous batcher (phase 12) -------

def paged_case(gen, dev, b, h, hkv, t, d, P, page, dtype, n_pages=None,
               lens=None, q_dtype=torch.float32, seed=0, scale=1.0):
    """Inputs of paged decode attention: a pool of random values in every
    page (garbage where nothing was written), a page table of distinct
    pages per row with -1 past each row's length, ``key_pos`` live below
    the length and -1 after it, ``q_pos`` the last ``t`` positions; an
    int8 pool's scales uniform in [0.5, 1.5) times ``scale``.
    Returns (q, pool, table, key_pos, q_pos) on ``dev``."""
    from exprgrad_torch.ops.paged import PagedKVPool

    rng = np.random.default_rng(seed)
    n_pages = n_pages or 4 * P
    shape = (n_pages, hkv, page, d)
    if dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = ((torch.rand(shape[:3], generator=gen, device=dev) + 0.5)
                  * scale for _ in range(2))
        pool = PagedKVPool(k=k, v=v, k_scale=ks, v_scale=vs)
    else:
        pool = PagedKVPool(*(torch.randn(shape, generator=gen, device=dev)
                             .to(dtype) for _ in range(2)))
    lens = (rng.integers(t, P * page, b) if lens is None
            else np.asarray(lens))
    table = np.full((b, P), -1, np.int32)
    free = rng.permutation(n_pages)
    used = 0
    for i in range(b):
        n = -(-int(lens[i]) // page)
        table[i, :n] = free[used:used + n]
        used += n
    slots = np.arange(P * page)
    key_pos = np.where(slots[None] < lens[:, None], slots[None], -1)
    q_pos = (lens[:, None] - t + np.arange(t)[None])
    q = torch.randn((b, h, t, d), generator=gen, device=dev).to(q_dtype)
    return (q, pool, torch.as_tensor(table, device=dev),
            torch.as_tensor(key_pos.astype(np.int32), device=dev),
            torch.as_tensor(q_pos.astype(np.int32), device=dev))


def paged_bound(q, pool, table, key_pos, q_pos, window=None) -> tuple:
    """The bound of one paged-attention call on these inputs: the bytes of
    q, the out, the table and positions and the resident pages' K and V
    (and scales), each read or written once; the multiply-adds of QK and
    PV over the (query, key) pairs that attend (4d flops a pair)."""
    b, h, t, d = q.shape
    _, hkv, page, _ = pool.k.shape
    resident = int((table >= 0).sum()) * hkv * page
    kv = 2 * resident * d * pool.k.element_size()
    if pool.k_scale is not None:
        kv += 2 * resident * 4
    small = 2 * q.numel() * q.element_size() + 4 * (
        table.numel() + key_pos.numel() + q_pos.numel())
    kp = key_pos.long()[:, None, :]
    qp = q_pos.long()[:, :, None]
    keep = (kp >= 0) & (kp <= qp)
    if window is not None:
        keep = keep & (kp > qp - window)
    pairs = int(keep.sum()) * h
    return bound(4.0 * d * pairs, kv + small)


def check_paged_kernel(gen, dev) -> float:
    """Phase 12 (a): B7 against its plain version on the card, on the seven
    cases of tests/test_paged_attention.py, the serving decode step, bench.py's
    shape, and the edges (rows over one block, a page of 12, a head_dim
    with no 16-byte rows, bfloat16 queries, a row with no live key).
    Returns the largest |kernel - plain| over the cases."""
    from exprgrad_torch.ops import paged_attention as pa

    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    cases = [  # name, (b, h, hkv, t, d, P, page, pool dtype), window, extra
        ("mha", (2, 4, 4, 1, 128, 4, 64, f32), None, {}),
        ("gqa", (2, 4, 2, 1, 128, 4, 64, f32), None, {}),
        ("mqa d64", (2, 8, 1, 1, 64, 3, 32, f32), None, {}),
        ("t=3", (2, 4, 2, 3, 64, 4, 64, f32), None, {}),
        ("window 40", (2, 4, 4, 1, 128, 4, 64, f32), 40, {}),
        ("int8 + scales", (1, 4, 2, 2, 128, 3, 128, i8), None, {}),
        ("bf16 pages, window 24", (2, 2, 2, 2, 32, 4, 16, bf16), 24, {}),
        ("serving decode step", PAGED_SERVING_CASE, None,
         dict(n_pages=33, lens=PAGED_SERVING_LENS)),
        ("bench.py paged shape", PAGED_BENCH_CASE, None,
         dict(n_pages=PAGED_BENCH_PAGES, lens=PAGED_BENCH_LENS)),
        ("12 rows, page 12, d 40, window 20",
         (2, 8, 2, 3, 40, 5, 12, bf16), 20, {}),
        ("bf16 queries, int8 d 48", (3, 4, 2, 1, 48, 4, 16, i8), None,
         dict(q_dtype=bf16)),
        # the splits' edges, at bench.py's shape (6 splits of 3 pages): live
        # pages that end inside a split, rows whose later splits hold no
        # resident page (129 and 1 slots), a window that ends inside a
        # split, int8 pages across all six splits
        ("bench.py shape, rows ending mid-split and splits with no "
         "resident page", PAGED_BENCH_CASE, None,
         dict(n_pages=PAGED_BENCH_PAGES, lens=PAGED_SPLIT_LENS)),
        ("bench.py shape, window 500", PAGED_BENCH_CASE, 500,
         dict(n_pages=PAGED_BENCH_PAGES, lens=PAGED_BENCH_LENS)),
        # scales as ops.decode._quantize makes them (absmax / 127): keys of
        # order one.  With scales near 1 the dequantized keys reach +-190,
        # the scores +-200, and a softmax that sharp moves its output by
        # 1e-2 when float32 rounding moves a score by 1e-4 (both versions
        # sum the 128 products in other orders)
        ("bench.py shape, int8 pages", PAGED_BENCH_CASE[:-1] + (i8,), None,
         dict(n_pages=PAGED_BENCH_PAGES, lens=PAGED_SPLIT_LENS,
              scale=1 / 127)),
        ("a one-entry table (P = 1)", (4, 8, 2, 1, 128, 1, 64, bf16), None,
         {}),
        ("2048-slot rows at page 16", (4, 4, 2, 2, 64, 128, 16, bf16), None,
         dict(n_pages=4 * 128 + 1, lens=(2048, 2048, 1999, 2040))),
    ]
    worst = 0.0
    for i, (name, shape, window, extra) in enumerate(cases):
        q, pool, table, key_pos, q_pos = paged_case(gen, dev, *shape,
                                                    seed=i, **extra)
        if name.startswith("bf16 queries"):
            key_pos[1] = -1          # row 1 sees no key: 0 on both
        got = pa.paged_decode_attention(q, pool, table, key_pos, q_pos,
                                        window=window)
        again = pa.paged_decode_attention(q, pool, table, key_pos, q_pos,
                                          window=window)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"paged {name}: two runs differ"
        want = pa.paged_decode_attention_plain(q, pool, table, key_pos,
                                               q_pos, window=window)
        tol = F32_OUT if q.dtype == torch.float32 else BF16_OUT
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda m: f"paged {name}: {m}")
        err = (got.float() - want.float()).abs().max().item()
        if name.startswith("bf16 queries"):
            assert torch.all(got[1] == 0), "a row with no key is not 0"
        worst = max(worst, err)
        print(f"kernel check paged {name}: two runs equal bit for bit, "
              f"max |err| {err:.3e} "
              f"(q {tuple(q.shape)} {str(q.dtype)[6:]}, pool "
              f"{tuple(pool.k.shape)} {str(pool.k.dtype)[6:]}, "
              f"{int((table >= 0).sum())} resident pages)")
    # int8 pages at bench.py's shape with scales near 1 (keys up to +-190,
    # scores up to +-200), the data the int8 case above leaves out: a
    # softmax this sharp turns one float32 rounding of a score into 1e-4 to
    # 1e-3 of output, so the kernel and the plain version are each held
    # against the same formula in float64, beside that formula with each
    # score rounded once to float32 (printed, not asserted: which float32
    # order lands nearer varies with the data by ten times and more)
    q, pool, table, key_pos, q_pos = paged_case(
        gen, dev, *PAGED_BENCH_CASE[:-1], i8, seed=len(cases),
        n_pages=PAGED_BENCH_PAGES, lens=PAGED_SPLIT_LENS)
    got = pa.paged_decode_attention(q, pool, table, key_pos, q_pos)
    want = pa.paged_decode_attention_plain(q, pool, table, key_pos, q_pos)
    exact = paged_float64(q, pool, table, key_pos, q_pos)
    once = paged_float64(q, pool, table, key_pos, q_pos, round_scores=True)
    assert torch.isfinite(got).all()
    print(f"kernel check paged bench.py shape, int8 pages with scales near "
          f"1: max |out - float64 formula| kernel "
          f"{(got.double() - exact).abs().max().item():.3e}, plain "
          f"{(want.double() - exact).abs().max().item():.3e}, the formula "
          f"with each score rounded once to float32 "
          f"{(once - exact).abs().max().item():.3e}; max |kernel - plain| "
          f"{(got - want).abs().max().item():.3e}")
    return worst


def paged_float64(q, pool, table, key_pos, q_pos, round_scores=False):
    """The plain version's formula (gather_view, dequantize, softmax of the
    masked scores, P.V; 0 where a row sees no key) in float64; with
    ``round_scores`` each scaled score is rounded once to float32."""
    from exprgrad_torch.ops.paged import gather_view

    view = gather_view(pool, table.clamp(min=0))
    b, h, t, d = q.shape
    hkv, n = view.k.shape[1], view.k.shape[2]
    k, v = view.k.double(), view.v.double()
    if view.k_scale is not None:
        k = k * view.k_scale.double()[..., None]
        v = v * view.v_scale.double()[..., None]
    qg = q.double().reshape(b, hkv, h // hkv * t, d)
    s = torch.einsum("bgqd,bgsd->bgqs", qg, k).reshape(b, h, t, n) * d ** -0.5
    if round_scores:
        s = s.float().double()
    kp = key_pos.long()[:, None, None, :]
    mask = (kp >= 0) & (kp <= q_pos.long()[:, None, :, None])
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    p = torch.nan_to_num(p, nan=0.0)  # rows that see no key
    out = torch.einsum("bgqs,bgsd->bgqd", p.reshape(b, hkv, -1, n), v)
    return out.reshape(b, h, t, d)


def time_paged_kernel(gen, dev, gpu, name, shape, lens, n_pages) -> dict:
    """Phase 12 (b): B7 at one shape beside its plain version and the
    library route (gather_view, then scaled_dot_product_attention with a
    boolean mask: two calls), with CUDA events, in turns."""
    from exprgrad_torch.ops import paged_attention as pa
    from exprgrad_torch.ops.paged import gather_view

    q, pool, table, key_pos, q_pos = paged_case(gen, dev, *shape, lens=lens,
                                                n_pages=n_pages)
    h, hkv = q.shape[1], pool.k.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = ((key_pos[:, None, None, :] >= 0)
            & (key_pos[:, None, None, :] <= q_pos[:, None, :, None]))
    clamped = table.clamp(min=0)
    gqa = {"enable_gqa": True} if h != hkv else {}

    def library():
        view = gather_view(pool, clamped)
        return sdpa(q, view.k.to(q.dtype), view.v.to(q.dtype),
                    attn_mask=mask, **gqa)

    fns = {"kernel": lambda: pa.paged_decode_attention(
               q, pool, table, key_pos, q_pos),
           "plain": lambda: pa.paged_decode_attention_plain(
               q, pool, table, key_pos, q_pos),
           "library": library}
    torch.testing.assert_close(fns["library"](), fns["plain"](), **F32_OUT)
    runs = {k: [] for k in fns}
    for which in ("plain", "library", "kernel", "kernel", "library",
                  "plain"):
        runs[which].append(cuda_ms(fns[which], iters=50, warmup=5))
    res = {k: sum(v) / len(v) for k, v in runs.items()}
    res["runs"] = runs
    res["host_us"] = {k: host_us(fns[k]) for k in ("kernel", "library")}
    res["profiled"] = {"kernel": fns["kernel"], "library": library}
    res["bound"] = paged_bound(q, pool, table, key_pos, q_pos)
    res["err"] = (fns["kernel"]() - fns["plain"]()).abs().max().item()
    print(f"paged attention {name}: kernel {res['kernel']:.5f} ms, plain "
          f"{res['plain']:.5f} ms, gather_view + scaled_dot_product_attention"
          f" (two calls) {res['library']:.5f} ms, bound "
          f"{res['bound'][0]:.5f} ms ({res['bound'][1]}); runs {runs}; "
          f"host us per call {res['host_us']} on {gpu}")
    return res


def _percentiles(values) -> str:
    p50, p90 = np.percentile(np.asarray(values), [50, 90])
    return f"p50 {p50 * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms"


def staggered_mix(vocab):
    """bench.py's staggered mix from seed 0: (prompts, budgets)."""
    rng = np.random.default_rng(0)
    n = MIX["n"]
    sizes = rng.integers(*MIX["prompt"], n)
    budgets = [int(x) for x in rng.integers(*MIX["budget"], n)]
    prompts = [rng.integers(0, vocab, s).astype(np.float32) for s in sizes]
    return prompts, budgets


def drive_mix(server, kind, prompts, budgets, hook=None, **extra):
    """Serve the mix through ``ContinuousBatcher(server, attention=kind,
    **BATCHER, **extra)``: half the requests up front, then one more before
    each ``step()``; ``hook(batcher)`` runs right after its construction.
    Returns (streams in submission order, the batcher, the seconds from
    its construction to the last token, synchronized, the number of
    ``step()`` calls)."""
    from exprgrad_torch.models import ContinuousBatcher

    n = len(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = ContinuousBatcher(server, attention=kind, **BATCHER, **extra)
    if hook is not None:
        hook(b)
    rids = [b.submit(p, m) for p, m in zip(prompts[:n // 2],
                                          budgets[:n // 2])]
    out, steps = {}, 0
    while len(out) < n:
        if len(rids) < n:
            i = len(rids)
            rids.append(b.submit(prompts[i], budgets[i]))
        out.update(b.step())
        steps += 1
    torch.cuda.synchronize()
    return [out[r] for r in rids], b, time.perf_counter() - t0, steps


def path_e(egt, gpu) -> dict:
    """Phase 12 (c): the continuous batcher over a paged pool at the serving
    width, through kernel B7 (``attention="flash"``) and through the
    gathered view (``"gather"``), under bench.py's staggered mix."""
    from exprgrad_torch.models import FlashLMServer, flash_transformer
    from exprgrad_torch.ops import (attention, mapreduce, matmul,
                                    paged_attention, rowchain)

    counters = (attention, matmul, mapreduce, rowchain, paged_attention)
    model = egt.compile(flash_transformer(**SERVING), seed=0, device="cuda")
    vocab, blocks = SERVING["vocab"], SERVING["blocks"]
    prompts, budgets = staggered_mix(vocab)
    n = len(prompts)

    def drive(server, kind):
        """The mix with the kernels' counters at 0 just before; returns
        (streams, batcher, seconds, B7 launches)."""
        for c in counters:
            c.launches = 0
        streams, b, secs, _ = drive_mix(server, kind, prompts, budgets)
        launches = paged_attention.launches
        others = sum(c.launches for c in counters[:-1])
        stats = b.stats
        want = blocks * stats["dispatches"] if kind == "flash" else 0
        assert launches == want, (kind, launches, stats)
        assert others == 0, others
        assert stats["preemptions"] > 0, stats
        assert stats["free_pages"] == stats["pool_pages"], stats
        for s, m in zip(streams, budgets):
            assert s.shape == (m,), (s.shape, m)
            assert np.all((s >= 0) & (s < vocab))
        return streams, b, secs, launches

    # float32 cache: flash, gather and solo serving give the same greedy
    # streams, but where float32 reassociation flips a near-tie
    srv32 = FlashLMServer(model, cache_dtype=torch.float32)
    flash32, b32, _, l32 = drive(srv32, "flash")
    gather32, _, _, _ = drive(srv32, "gather")
    solo = [srv32.generate(p[None], n_new=m)[0].cpu().numpy().astype(
        np.int64) for p, m in zip(prompts, budgets)]
    parted = []
    for i, (f, g, s) in enumerate(zip(flash32, gather32, solo)):
        differ = np.flatnonzero((f != g) | (f != s))
        if not differ.size:
            continue
        j = int(differ[0])
        seq = np.concatenate([prompts[i], s[:j].astype(np.float32)])
        logits, _ = srv32.prefill(seq[None], srv32.init_caches(1))
        top = torch.topk(logits[0, -1], 2).values
        margin = float(top[0] - top[1])
        parted.append((i, j, margin))
        print(f"path (e) float32 request {i}: streams part at token {j} "
              f"(flash {f[j]}, gather {g[j]}, solo {s[j]}); solo top-2 "
              f"logit margin {margin:.3e}")
        assert margin <= NEAR_TIE, (i, j, margin)
    print(f"path (e) float32 cache: {n - len(parted)} of {n} greedy streams "
          f"equal across flash, gather and solo; stats {b32.stats}; B7 "
          f"launches {l32} = {blocks} blocks x {b32.stats['dispatches']} "
          f"dispatches")

    # the default bfloat16 cache: a warm drive of each, then the timed ones
    srv = FlashLMServer(model)
    drive(srv, "flash")
    drive(srv, "gather")
    res = {}
    for kind in ("flash", "gather"):
        streams, b, secs, launches = drive(srv, kind)
        tokens = sum(len(s) for s in streams)
        m = b.request_metrics()
        res[kind] = dict(streams=streams, secs=secs, launches=launches,
                         stats=b.stats, tokens=tokens)
        print(f"path (e) {kind} (bf16 cache): {tokens} tokens in {secs:.3f} s"
              f": {tokens / secs:.1f} tokens/s, {n / secs:.2f} requests/s, "
              f"ttft {_percentiles([r['ttft_s'] for r in m])}, latency "
              f"{_percentiles([r['latency_s'] for r in m])}; "
              f"{secs / b.stats['dispatches'] * 1e3:.2f} ms per decode "
              f"dispatch; "
              f"stats {b.stats}; B7 launches {launches} on {gpu}")
    same = sum(np.array_equal(a, b) for a, b in zip(
        res["flash"]["streams"], res["gather"]["streams"]))
    print(f"path (e) bf16 cache: {same} of {n} streams equal between flash "
          f"and gather")
    return {"launches": res["flash"]["launches"], "parted": parted,
            "same_bf16": same}


# --- the reference examples' models (phases 13-15) ------------------------

def mnist_synthetic(egt, rng, n):
    """examples/fashion_mnist.py:44-50's synthetic set: N(0, 0.1) noise
    with a bright 10x10 square at the label's offset; one-hot labels."""
    labels = rng.integers(0, 10, n)
    x = rng.normal(0, 0.1, (n, 28, 28)).astype(np.float32)
    for i, label in enumerate(labels):
        x[i, label:label + 10, label:label + 10] += 1.0
    return x, egt.one_hot(labels, 10)


def derivative_graph(egt):
    """examples/derivative.py's program: y = x^2 and its gradient."""
    x = egt.input("x")
    it = egt.iters("it")
    y = egt.Fun("y")
    y[it] = x[it] * x[it]
    return y.target("y").backwards().grad(x).target("grad_x")


def trained_alike(name, card, cpu, start, batch, loss_atol=0.0) -> float:
    """Assert the card's model and the CPU port's, after the same steps
    from ``start``, agree as the serving train check holds them: the loss
    on ``batch`` (TRAIN_LOSS, plus ``loss_atol``) and the parameters
    within TRAIN_UPDATE_RTOL of the update in L2 norm.  Returns the
    update error."""
    loss = float(card.call("loss", batch)[0])
    cpu_loss = float(cpu.call("loss", batch)[0])
    rel, worst = update_err(card.params, cpu.params, start)
    print(f"{name}: loss {loss:.6f} vs CPU {cpu_loss:.6f}; parameters vs "
          f"CPU: |diff| / |update| {rel:.3e}, max |diff| {worst:.3e}")
    np.testing.assert_allclose(loss, cpu_loss, rtol=TRAIN_LOSS["rtol"],
                               atol=loss_atol)
    assert rel <= TRAIN_UPDATE_RTOL, (name, rel)
    return rel


def path_f(egt, gpu) -> dict:
    """Phase 13: the north-star workloads.  xor and xor_from_scratch
    (XOR_STEPS steps of the examples' SGD) and derivative at their
    examples' sizes; fashion_mnist_cnn at bench.py's epoch (scan_batches)
    and at the example's epoch (Batches + fit_epochs with prefetch), then
    a CheckpointManager round trip from the card to the CPU.  Each against
    the CPU port."""
    import shutil

    from exprgrad_torch.io import Batches, CheckpointManager, Prefetcher, \
        fit_epochs
    from exprgrad_torch.models import fashion_mnist_cnn
    from exprgrad_torch.utils import kernels

    out = {}
    xor = {"x": np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32),
           "y": np.array([[0], [1], [1], [0]], np.float32)}
    for name in ("xor_mlp", "xor_from_scratch"):
        graph = getattr(egt.models, name)(rate=0.1)
        card = egt.compile(graph, seed=10, device="cuda")
        cpu = egt.compile(graph, seed=10, device="cpu")
        np.testing.assert_allclose(card.call("predict", xor),
                                   cpu.call("predict", xor), **PREDICT)
        start = {t: v.clone() for t, v in cpu.params.items()}
        loss0 = float(card.call("loss", xor)[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(XOR_STEPS):
            card.apply("train", xor)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for _ in range(XOR_STEPS):
            cpu.apply("train", xor)
        trained_alike(f"path (f) {name} after {XOR_STEPS} steps", card, cpu,
                      start, xor)
        loss = float(card.call("loss", xor)[0])
        assert loss < loss0, (name, loss0, loss)
        print(f"path (f) {name}: loss {loss0:.4f} -> {loss:.4f}, "
              f"{secs / XOR_STEPS * 1e3:.3f} ms a step on {gpu}")
        out[name] = secs

    xs = np.linspace(-2, 2, 9).astype(np.float32)
    card = egt.compile(derivative_graph(egt), device="cuda")
    cpu = egt.compile(derivative_graph(egt), device="cpu")
    for target, want in (("y", xs * xs), ("grad_x", 2 * xs)):
        got = card.call(target, {"x": xs})
        np.testing.assert_allclose(got, cpu.call(target, {"x": xs}),
                                   **PREDICT)
        np.testing.assert_allclose(got, want, **PREDICT)
    print("path (f) derivative: y and grad_x match the CPU port and 2x")

    # bench.py's epoch: 8192 samples of N(0, 1), batch 256, one scan
    rng = np.random.default_rng(0)
    n, batch = MNIST_BENCH["n"], MNIST_BENCH["batch"]
    data = {"x": rng.normal(size=(n, 28, 28)).astype(np.float32),
            "y": egt.one_hot(rng.integers(0, 10, n), 10)}
    first = {k: v[:batch] for k, v in data.items()}
    card = egt.compile(fashion_mnist_cnn(), seed=0, device="cuda")
    cpu = egt.compile(fashion_mnist_cnn(), seed=0, device="cpu")
    probs = card.call("predict", {"x": first["x"]})
    err = float(np.abs(probs - cpu.call("predict", {"x": first["x"]})).max())
    np.testing.assert_allclose(probs, cpu.call("predict", {"x": first["x"]}),
                               **PREDICT)
    start = {t: v.clone() for t, v in cpu.params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.fit("fit", data, batch_size=batch, scan_batches=True,
             log_status=False)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    stats = card.lowering_stats("fit")
    print(f"path (f) fashion_mnist_cnn fit lowering {stats}; predict "
          f"[{batch},28,28] vs the CPU port: max |err| {err:.3e}")
    assert stats.get("conv", 0) >= 5, stats
    assert "general-scatter" not in stats, stats
    cpu.fit("fit", data, batch_size=batch, scan_batches=True,
            log_status=False)
    trained_alike("path (f) bench.py epoch", card, cpu, start, first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.fit("fit", data, batch_size=batch, scan_batches=True,
             log_status=False)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"path (f) bench.py epoch ({n} samples, batch {batch}, "
          f"scan_batches, precision highest): {warm:.3f} s warm "
          f"({n / warm:.1f} samples/s), {cold:.3f} s cold, on {gpu}")
    out["bench_epoch_s"] = warm

    # the example's epoch through Batches + fit_epochs, then a checkpoint
    rng = np.random.default_rng(0)
    n, batch = MNIST_EXAMPLE["n"], MNIST_EXAMPLE["batch"]
    train_x, train_y = mnist_synthetic(egt, rng, n)
    test_x, test_y = mnist_synthetic(egt, rng, 512)
    test = {"x": test_x, "y": test_y}
    card = egt.compile(fashion_mnist_cnn(eta=0.01), seed=0, device="cuda")
    cpu = egt.compile(fashion_mnist_cnn(eta=0.01), seed=0, device="cpu")
    placed = next(iter(Prefetcher(Batches({"x": train_x}, batch), depth=1,
                                  dtype=np.float32, placement=card.device)))
    assert card._to_device(placed["x"]) is placed["x"], "a copy at apply"
    start = {t: v.clone() for t, v in cpu.params.items()}
    loss0 = float(card.call("loss", test)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_epochs(card, "fit", Batches({"x": train_x, "y": train_y}, batch,
                                    seed=0),
               epochs=1, prefetch=MNIST_EXAMPLE["prefetch"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fit_epochs(cpu, "fit", Batches({"x": train_x, "y": train_y}, batch,
                                   seed=0),
               epochs=1, prefetch=MNIST_EXAMPLE["prefetch"])
    # the epoch drives the loss down by orders of magnitude (the set is
    # separable): its last digits are the adam entries whose sign flipped,
    # so the loss is held to TRAIN_LOSS's 1e-3 of the loss it started at
    trained_alike("path (f) example epoch", card, cpu, start, test,
                  loss_atol=TRAIN_LOSS["rtol"] * loss0)
    accuracy = egt.classification_accuracy(card, {"x": test_x}, test_y)
    print(f"path (f) example epoch ({n} samples, batch {batch}, Batches + "
          f"fit_epochs(prefetch={MNIST_EXAMPLE['prefetch']})): {secs:.3f} s "
          f"({n / secs:.1f} samples/s, first call included); test loss "
          f"{loss0:.4f} -> {float(card.call('loss', test)[0]):.6f}, "
          f"accuracy {accuracy:.4f}, on {gpu}")
    out["example_epoch_s"] = secs

    directory = kernels.BUILD_DIR / "chip_smoke_checkpoints"
    shutil.rmtree(directory, ignore_errors=True)
    manager = CheckpointManager(str(directory), keep=1)
    manager.save(card)
    restored = manager.restore(device="cpu")
    shutil.rmtree(directory)
    assert restored.device.type == "cpu" and restored.epoch == card.epoch
    got = restored.call("predict", {"x": test_x})
    want = card.call("predict", {"x": test_x})
    ckpt_err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, **PREDICT)
    print(f"path (f) CheckpointManager: step {card.epoch} from the card "
          f"restored on the CPU predicts the same, max |err| {ckpt_err:.3e}")
    return out


def path_g(egt, attention, gpu) -> dict:
    """Phase 14: flash_transformer with 4 experts (top 2) at the serving
    widths: predict on [8, 256] and two adam train steps on the "+1
    cycle" data, against the CPU port, with the flash kernels' launches."""
    from exprgrad_torch.models import flash_transformer

    graph = flash_transformer(**MOE)
    card = egt.compile(graph, seed=0, device="cuda")
    cpu = egt.compile(graph, seed=0, device="cpu")
    blocks = MOE["blocks"]
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, MOE["vocab"], (BATCH, SEQ)).astype(np.float32)
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    probs = card.call("predict", {"tokens": tokens})
    torch.cuda.synchronize()
    launches = {"forward": attention.launches, "dq": 0, "dkv": 0}
    stats = card.lowering_stats("predict")
    assert launches["forward"] == blocks, launches
    assert stats.get("attention-impl:flash") == blocks, stats
    assert stats.get("extern:moe") == blocks, stats
    cpu_probs = cpu.call("predict", {"tokens": tokens})
    err = float(np.abs(probs - cpu_probs).max())
    np.testing.assert_allclose(probs, cpu_probs, **PREDICT)
    print(f"path (g) predict [{BATCH},{SEQ}]: flash forward launches "
          f"{launches['forward']}, lowering {stats}; vs the CPU port max "
          f"|err| {err:.3e}")

    data = lm_data(np.random.default_rng(0), MOE["vocab"], BATCH, SEQ)
    start = {t: v.clone() for t, v in cpu.params.items()}
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MOE_STEPS):
        card.epoch += 1
        card.apply("train", data)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3 / MOE_STEPS
    train = {"forward": attention.launches, "dq": attention.dq_launches,
             "dkv": attention.dkv_launches}
    stats = card.lowering_stats("train")
    print(f"path (g) {MOE_STEPS} train steps: flash launches {train}, "
          f"lowering {stats}")
    assert train == {k: blocks * MOE_STEPS for k in train}, train
    assert stats.get("attention-grad-impl:flash") == blocks, stats
    assert stats.get("extern:moe_grad") == 6 * blocks, stats
    for _ in range(MOE_STEPS):
        cpu.epoch += 1
        cpu.apply("train", data)
    trained_alike(f"path (g) {MOE_STEPS} train steps", card, cpu, start, data)
    for k in launches:
        launches[k] += train[k]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        card.epoch += 1
        card.apply("train", data)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"path (g) train step [{BATCH},{SEQ}] with {MOE['moe_experts']} "
          f"experts, top {MOE['moe_k']}: {step_ms:.2f} ms (mean of "
          f"{TIMED_STEPS} warm steps; the first {MOE_STEPS} took "
          f"{first_ms:.2f} ms each) on {gpu}")
    return {"launches": launches, "step_ms": step_ms}


def path_h(egt, gpu) -> dict:
    """Phase 15: examples/rnn_lm.py's recurrent LM (its BPE tokenizer on
    its text, windows of RNN_SEQ): RNN_STEPS adam steps for each cell,
    against the CPU port, every parameter within TRAIN_UPDATE_RTOL of its
    own update in L2 norm.  Returns {cell: (the trained card model, its
    data)} for path (k)."""
    from exprgrad_torch.io import BPETokenizer
    from exprgrad_torch.models import tiny_recurrent_lm

    tok = BPETokenizer.train(RNN_TEXT, vocab_size=300)
    ids = np.asarray(tok.encode(RNN_TEXT), np.int64)
    assert tok.decode(ids) == RNN_TEXT
    vocab = tok.vocab_size
    starts = np.arange(0, len(ids) - RNN_SEQ - 1, 4)
    args = {"tokens": np.stack([ids[s:s + RNN_SEQ] for s in starts]).astype(
        np.float32),
            "labels": np.eye(vocab, dtype=np.float32)[
                np.stack([ids[s + 1:s + RNN_SEQ + 1] for s in starts])]}
    out = {}
    for cell, op in (("lstm", "lstm"), ("gru", "gru"), ("rnn", "rnn_tanh")):
        graph = tiny_recurrent_lm(vocab=vocab, cell=cell, **RNN)
        card = egt.compile(graph, seed=0, device="cuda")
        cpu = egt.compile(graph, seed=0, device="cpu")
        start = {t: v.clone() for t, v in cpu.params.items()}
        loss0 = float(card.call("loss", args)[0])
        times = []
        for _ in range(RNN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card.epoch += 1
            card.apply("train", args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        for _ in range(RNN_STEPS):
            cpu.epoch += 1
            cpu.apply("train", args)
        stats = card.lowering_stats("train")
        assert stats.get(f"extern:{op}") == 1, stats
        assert stats.get(f"extern:{op}_grad") == 4, stats
        trained_alike(f"path (h) {cell} after {RNN_STEPS} steps", card, cpu,
                      start, args)
        worst = 0.0
        for tid in start:
            rel, _ = update_err({tid: card.params[tid]},
                                {tid: cpu.params[tid]}, start)
            worst = max(worst, rel)
            assert rel <= TRAIN_UPDATE_RTOL, (
                cell, card.program.tensors[tid].name, rel)
        loss = float(card.call("loss", args)[0])
        assert loss < loss0, (cell, loss0, loss)
        warm_ms = float(np.mean(times[1:])) * 1e3
        print(f"path (h) {cell} [{len(starts)},{RNN_SEQ}], vocab {vocab}: "
              f"loss {loss0:.4f} -> {loss:.4f} in {RNN_STEPS} steps; worst "
              f"parameter |diff| / |update| vs CPU {worst:.3e}; "
              f"{warm_ms:.2f} ms a step warm ({times[0] * 1e3:.1f} ms the "
              f"first) on {gpu}")
        out[cell] = (card, args)
    return out


# --- the decoder server's other modes (phase 16) --------------------------

def check_verify_kernel(gen, dev) -> float:
    """Phase 16 (a): B7 against its plain version at the shapes a verify
    round gives it (``VERIFY_SHAPES``): ``key_pos`` live up to each slot's
    fed position plus ``spec_k`` and ``q_pos`` the ``spec_k + 1`` positions
    from it, as the batcher's ``_cursor_key_pos(..., extra=spec_k)`` makes
    them; float32, bfloat16 and int8 pools (scales as the cache quantizes,
    absmax / 127), with and without a window; every case twice for the
    same bits.  Returns the largest |kernel - plain|."""
    from exprgrad_torch.models.batcher import _cursor_key_pos
    from exprgrad_torch.ops import paged_attention as pa

    worst, seed = 0.0, 100
    for h, hkv, t in VERIFY_SHAPES:
        k = t - 1
        rows = h // hkv * t
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for window in (None, VERIFY_WINDOW):
                seed += 1
                pos = np.random.default_rng(seed).integers(48, 256 - k, 8)
                q, pool, table, _, _ = paged_case(
                    gen, dev, 8, h, hkv, t, 128, 8, 32, dtype, n_pages=65,
                    lens=pos + t, seed=seed, scale=1 / 127)
                fed = torch.as_tensor(pos, dtype=torch.int32, device=dev)
                key_pos = _cursor_key_pos(256, fed, extra=k)
                q_pos = fed[:, None] + torch.arange(t, dtype=torch.int32,
                                                    device=dev)[None]
                got = pa.paged_decode_attention(q, pool, table, key_pos,
                                                q_pos, window=window)
                again = pa.paged_decode_attention(q, pool, table, key_pos,
                                                  q_pos, window=window)
                torch.cuda.synchronize()
                name = (f"verify h{h}/hkv{hkv} t={t} ({rows} rows a kv head, "
                        f"{-(-rows // pa.rows_per_block(rows))} row blocks), "
                        f"{str(dtype)[6:]} pool, window {window}")
                assert torch.equal(got, again), f"{name}: two runs differ"
                want = pa.paged_decode_attention_plain(
                    q, pool, table, key_pos, q_pos, window=window)
                assert torch.isfinite(got).all(), name
                torch.testing.assert_close(got, want, **F32_OUT,
                                           msg=lambda m: f"{name}: {m}")
                err = (got - want).abs().max().item()
                worst = max(worst, err)
                print(f"kernel check paged {name}: two runs equal bit for "
                      f"bit, max |err| {err:.3e}")
    return worst


def parted(server, prompt, want, got, what):
    """Where the greedy stream ``got`` first parts from ``want`` (the solo
    stream of ``prompt``), with the solo run's top-2 logit margin there,
    which must be within NEAR_TIE; None when they are equal."""
    differ = np.flatnonzero(np.asarray(want) != np.asarray(got))
    if not differ.size:
        return None
    j = int(differ[0])
    seq = np.concatenate([np.asarray(prompt, np.float32),
                          np.asarray(want[:j], np.float32)])
    logits, _ = server.prefill(seq[None], server.init_caches(1))
    top = torch.topk(logits[0, -1].float(), 2).values
    margin = float(top[0] - top[1])
    print(f"path (i) {what}: parts from solo at token {j} ({got[j]} vs "
          f"{want[j]}); solo top-2 logit margin {margin:.3e}")
    assert margin <= NEAR_TIE, (what, j, margin)
    return j, margin


def _ids(x) -> np.ndarray:
    return x.cpu().numpy().astype(np.int64)


def readback_split(fn):
    """(wall seconds, seconds blocked in ``Tensor.cpu`` reads, their
    count) of one call of ``fn`` under cProfile: the blocked time is the
    host waiting for the card at the rounds' one read back each."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    wait, calls = 0.0, 0
    for (_, _, name), row in pstats.Stats(prof).stats.items():
        if name.startswith("<method 'cpu' of"):
            calls, wait = calls + row[1], wait + row[3]
    return wall, wait, calls


def beam_check(server, prompts, beams, n_new):
    """``generate_beam`` on ``prompts``: asserts the beams come back best
    first and each score equals its sequence's teacher-forced
    log-probability within BEAM_ATOL.  Returns (that largest difference,
    the top beam's score minus the greedy sequence's log-probability, per
    prompt)."""
    seqs, scores = server.generate_beam(prompts, n_new=n_new, beams=beams)
    seqs, scores = _ids(seqs), scores.cpu().numpy()
    assert np.all(np.diff(scores, axis=1) <= 1e-6), scores
    greedy = _ids(server.generate(prompts, n_new=n_new))

    def forced(prompt_rows, cont):
        full_seq = np.concatenate([prompt_rows, cont.astype(np.float32)], 1)
        logits, _ = server.prefill(full_seq, server.init_caches(len(cont)))
        logp = torch.log_softmax(logits.float(), -1).cpu().numpy()
        t = prompt_rows.shape[1]
        return sum(logp[np.arange(len(cont)), t - 1 + i, cont[:, i]]
                   for i in range(cont.shape[1]))

    lp = forced(np.repeat(prompts, beams, 0), seqs.reshape(-1, n_new))
    err = float(np.abs(lp - scores.reshape(-1)).max())
    assert err <= BEAM_ATOL, err
    return err, scores[:, 0] - forced(prompts, greedy)


def train_draft(egt, data):
    """The draft, untrained and after DRAFT_STEPS adam steps on ``data``
    (the setup of path (i): its kernel launches count nowhere)."""
    from exprgrad_torch.models import flash_transformer

    graph = flash_transformer(**DRAFT)
    untrained = egt.compile(graph, seed=DRAFT_SEED, device="cuda")
    trained = egt.compile(graph, seed=DRAFT_SEED, device="cuda")
    first = {name: value[:BATCH] for name, value in data.items()}
    loss0 = float(trained.call("loss", first)[0])
    for _ in range(DRAFT_STEPS):
        trained.epoch += 1
        trained.apply("train", first)
    loss = float(trained.call("loss", first)[0])
    print(f"path (i) draft {DRAFT}: {DRAFT_STEPS} adam steps on phase 5's "
          f"data, loss {loss0:.4f} -> {loss:.4f}")
    return untrained, trained


def path_i(egt, model, drafts, gpu) -> dict:
    """Phase 16 (b): path (i), the decoder server's other modes on phase
    5's trained serving model: weight quantization, int8 weights, ragged
    prompts with stop sequences and buckets, scoring, beam search,
    speculative and prompt-lookup decoding, and the continuous batcher's
    draft and lookup rounds (path (e)'s batcher and mix), flash and
    gather."""
    from exprgrad_torch import ModelRuntimeError
    from exprgrad_torch.models import FlashLMServer, flash_transformer
    from exprgrad_torch.ops import (attention, mapreduce, matmul,
                                    paged_attention, rowchain)
    from exprgrad_torch.quant import QuantW, dequantize

    vocab, blocks = SERVING["vocab"], SERVING["blocks"]
    counters = (attention, matmul, mapreduce, rowchain, paged_attention)
    for c in counters:
        c.launches = 0
    rng = np.random.default_rng(16)
    tokens = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.float32)
    srv32 = FlashLMServer(model, cache_dtype=torch.float32)
    draft0 = FlashLMServer(drafts[0], cache_dtype=torch.float32)
    draft = FlashLMServer(drafts[1], cache_dtype=torch.float32)
    out = {}

    # 1. Model.quantize_weights on a copy of the model: predict runs B2
    # over the dequantized weights; training refuses
    full = model.call("predict", {"tokens": tokens})
    qmodel = egt.from_state(
        flash_transformer(**SERVING),
        {t: v.cpu().numpy() for t, v in model.params.items()},
        {t: v.cpu().numpy() for t, v in model.caches.items()}, model.epoch,
        device="cuda")
    done = qmodel.quantize_weights()
    before = attention.launches
    quant = qmodel.call("predict", {"tokens": tokens})
    torch.cuda.synchronize()
    q_launches = attention.launches - before
    rel = float(np.linalg.norm(quant - full) / np.linalg.norm(full))
    b2 = attention.launches            # the full and quantized predicts
    assert q_launches == blocks and b2 == 2 * blocks, (q_launches, b2)
    assert sum(c.launches for c in counters[1:]) == 0
    assert rel < QUANT_REL, rel
    labels = np.zeros((BATCH, SEQ, vocab), np.float32)
    try:
        qmodel.apply("train", {"tokens": tokens, "labels": labels})
    except ModelRuntimeError as exc:
        assert "inference-only" in str(exc), exc
    else:
        raise AssertionError("a quantized model trained")
    print(f"path (i) quantize_weights: {sorted(done.items())}; predict "
          f"[{BATCH},{SEQ}] relative L2 from full precision {rel:.3e}, B2 "
          f"launches {q_launches}; train refuses")

    # 2. FlashLMServer(weight_dtype=int8): codes, the scale/2 bound, the
    # prefill logits and the weight bytes
    q8 = FlashLMServer(model, cache_dtype=torch.float32,
                       weight_dtype=torch.int8)
    pairs = [(wf, wq) for bf, bq in zip(srv32.blocks, q8.blocks)
             for wf, wq in zip(bf, bq) if isinstance(wq, QuantW)]
    pairs.append((srv32.w_head, q8.w_head))
    for wf, wq in pairs:
        assert wq.codes.dtype == torch.int8
        assert wq.codes.device == wf.device
        assert bool(((wf - dequantize(wq)).abs()
                     <= wq.scale * 0.5 + 1e-7).all())
    lf, _ = srv32.prefill(tokens, srv32.init_caches(BATCH))
    lq, _ = q8.prefill(tokens, q8.init_caches(BATCH))
    rel8 = float(torch.linalg.norm(lq - lf) / torch.linalg.norm(lf))
    assert rel8 < QUANT_REL, rel8
    out["weight_bytes"] = (srv32.weight_bytes(), q8.weight_bytes())
    print(f"path (i) int8 server: {len(pairs)} matrices int8 within "
          f"scale/2; prefill logits relative L2 {rel8:.3e}; weight bytes "
          f"{q8.weight_bytes()} against {srv32.weight_bytes()} at full "
          f"precision ({q8.weight_bytes() / srv32.weight_bytes():.4f})")

    # 3. ragged prompts: each row the solo stream of its prompt but at
    # near-ties; a stop sequence freezes rows; buckets as unbucketed
    lens = rng.integers(*RAGGED["lens"], RAGGED["n"])
    padded = np.zeros((RAGGED["n"], RAGGED["width"]), np.float32)
    for i, n in enumerate(lens):
        padded[i, :n] = tokens[i, :n]
    new = RAGGED["new"]
    ragged = _ids(srv32.generate(padded, n_new=new, lengths=lens))
    for i, n in enumerate(lens):
        solo = _ids(srv32.generate(padded[i:i + 1, :n], n_new=new))[0]
        parted(srv32, padded[i, :n], solo, ragged[i], f"ragged row {i}")
    seq = [int(ragged[0, 2]), int(ragged[0, 3])]
    stopped = _ids(srv32.generate(padded, n_new=new, lengths=lens,
                                  stop_seq=seq))
    frozen = 0
    for free, got in zip(ragged, stopped):
        hit = next((j for j in range(1, new)
                    if list(free[j - 1:j + 1]) == seq), None)
        if hit is None:
            assert np.array_equal(got, free)
            continue
        frozen += 1
        assert np.array_equal(got[:hit + 1], free[:hit + 1])
        assert np.all(got[hit:] == seq[-1])
    assert frozen >= 1
    # a width of 100 pads to the 128 bucket
    short = 100
    bucketed = FlashLMServer(model, cache_dtype=torch.float32)
    bucketed.set_prompt_buckets(PROMPT_BUCKETS)
    narrow, narrow_lens = padded[:, :short], np.minimum(lens, short)
    plain = _ids(srv32.generate(narrow, n_new=new, lengths=narrow_lens))
    bucket = _ids(bucketed.generate(narrow, n_new=new, lengths=narrow_lens))
    for i in range(RAGGED["n"]):
        parted(srv32, narrow[i, :narrow_lens[i]], plain[i], bucket[i],
               f"bucketed row {i}")
    print(f"path (i) ragged generate: {RAGGED['n']} prompts of "
          f"{sorted(int(x) for x in lens)} tokens padded to "
          f"{RAGGED['width']}, {new} new; stop_seq {seq} froze {frozen} "
          f"rows; width {short} bucketed to "
          f"{bucketed._prompt_bucket(short)}")

    # 4. score against the NLL from predict
    nll = srv32.score(tokens).cpu().numpy()
    ids = tokens.astype(np.int64)
    want = -np.mean(np.log(np.take_along_axis(
        full[:, :-1], ids[:, 1:, None], axis=-1)[..., 0]), axis=1)
    np.testing.assert_allclose(nll, want, rtol=SCORE_RTOL, atol=0)
    print(f"path (i) score [{BATCH},{SEQ}]: {np.round(nll, 4).tolist()}, "
          f"max relative difference from predict's NLL "
          f"{float(np.max(np.abs(nll - want) / np.abs(want))):.3e}")

    # 5. beam search: best first, each beam's score its teacher-forced
    # log-probability, and one beam is greedy decoding.  With 4 beams the
    # top beam need not reach the greedy sequence's log-probability: when
    # four prefixes beat greedy's at some step it is pruned, and the JAX
    # package's beam search does the same (tests/test_torch_decoding.py);
    # the differences are printed
    beams, bnew = BEAM["beams"], BEAM["new"]
    for kind, prompts in (
            ("random prompts", tokens[:, :BEAM["prompt"]]),
            ("+1-cycle prompts", lm_data(rng, vocab, BATCH, BEAM["prompt"])[
                "tokens"])):
        beam_err, gap = beam_check(srv32, prompts, beams, bnew)
        one, _ = srv32.generate_beam(prompts, n_new=bnew, beams=1)
        greedy = _ids(srv32.generate(prompts, n_new=bnew))
        for i, (g, b) in enumerate(zip(greedy, _ids(one)[:, 0])):
            parted(srv32, prompts[i], g, b, f"one beam, {kind} row {i}")
        print(f"path (i) beam search, {kind}: {BATCH} prompts x {beams} "
              f"beams x {bnew}: scores vs teacher forcing max |diff| "
              f"{beam_err:.3e}; one beam is greedy; top beam minus greedy "
              f"log-prob {np.round(gap, 4).tolist()} "
              f"({int(np.sum(gap < -BEAM_ATOL))} below)")
        out.setdefault("beam_gaps", []).append(gap)

    # 6. speculative decoding, greedy: the disagreeing (untrained) draft
    # rewinds every round; the trained one is timed; the target as its
    # own draft accepts everything; sampled twice from one seed
    prompt = tokens[:1, :128]
    solo = _ids(srv32.generate(prompt, n_new=SPEC_NEW))[0]
    spec = {}
    for name, d in (("untrained draft", draft0), ("trained draft", draft),
                    ("self draft", srv32)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, steps = srv32.generate_speculative(d, prompt, n_new=SPEC_NEW,
                                                k=SPEC_K)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        parted(srv32, prompt[0], solo, _ids(got)[0], f"speculative, {name}")
        spec[name] = (steps, secs)
        print(f"path (i) generate_speculative k={SPEC_K}, {name}: "
              f"{SPEC_NEW} tokens in {steps} rounds, {secs:.3f} s")
    assert spec["untrained draft"][0] > math.ceil((SPEC_NEW - 1) / SPEC_K)
    assert spec["self draft"][0] <= math.ceil((SPEC_NEW - 1) / SPEC_K)
    a, _ = srv32.generate_speculative(draft, prompt, n_new=SPEC_NEW,
                                      k=SPEC_K, temperature=1.0, seed=5)
    b, _ = srv32.generate_speculative(draft, prompt, n_new=SPEC_NEW,
                                      k=SPEC_K, temperature=1.0, seed=5)
    assert torch.equal(a, b), "sampled speculation is not repeatable"
    assert bool(((a >= 0) & (a < vocab)).all())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv32.generate(prompt, n_new=SPEC_NEW)
    torch.cuda.synchronize()
    out["solo_s"] = time.perf_counter() - t0
    wall, wait, calls = readback_split(lambda: srv32.generate_speculative(
        draft, prompt, n_new=SPEC_NEW, k=SPEC_K))
    rounds = spec["trained draft"][0]
    out["spec"] = dict(rounds=spec, wall=wall, wait=wait, reads=calls)
    print(f"path (i) speculative rounds (trained draft, cProfile on): "
          f"{rounds} rounds in {wall * 1e3:.1f} ms, {wall / rounds * 1e3:.2f}"
          f" ms a round, of which {wait / rounds * 1e3:.3f} ms blocked in "
          f"{calls} reads back; plain generate of {SPEC_NEW} tokens "
          f"{out['solo_s']:.3f} s on {gpu}")

    # 7. prompt lookup: a window of the +1 cycle whose continuation the
    # prompt already holds (64..127 then 0..63)
    cyc = np.concatenate([np.arange(64, 128), np.arange(0, 64)]) % vocab
    cyc = cyc[None].astype(np.float32)
    csolo = _ids(srv32.generate(cyc, n_new=SPEC_NEW))[0]
    look, lsteps = srv32.generate_lookup(cyc, n_new=SPEC_NEW, k=LOOKUP_K)
    parted(srv32, cyc[0], csolo, _ids(look)[0], "lookup")
    assert lsteps < SPEC_NEW - 1, lsteps
    print(f"path (i) generate_lookup k={LOOKUP_K}: {SPEC_NEW} tokens in "
          f"{lsteps} rounds (first solo tokens {csolo[:8].tolist()})")

    # 8. the batcher's draft and lookup rounds under path (e)'s mix
    assert sum(c.launches for c in counters) == b2, "a kernel launched"
    mix_prompts, budgets = staggered_mix(vocab)
    n = len(mix_prompts)

    def drive(server, kind, check=True, **extra):
        for c in counters:
            c.launches = 0
        slot_rounds = []

        def hook(b):
            verify = b._verify

            def counted(*args):
                slot_rounds.append(int(b.active.sum()))
                return verify(*args)

            b._verify = counted

        streams, b, secs, _ = drive_mix(server, kind, mix_prompts, budgets,
                                        hook=hook, **extra)
        launches = paged_attention.launches
        stats = b.stats
        if check:
            want = blocks * stats["dispatches"] if kind == "flash" else 0
            assert launches == want, (kind, extra, launches, stats)
            assert sum(c.launches for c in counters[:-1]) == 0
            assert stats["preemptions"] > 0, stats
            assert stats["free_pages"] == stats["pool_pages"], stats
            for s, m in zip(streams, budgets):
                assert s.shape == (m,) and np.all((s >= 0) & (s < vocab))
        rounds = sum(slot_rounds)
        accept = ((stats["spec_emitted"] - rounds) / (SPEC_K * rounds)
                  if rounds else None)
        return dict(streams=streams, secs=secs, launches=launches,
                    stats=stats, accept=accept, slot_rounds=rounds,
                    tokens=sum(len(s) for s in streams))

    msolo = [_ids(srv32.generate(p[None], n_new=m))[0]
             for p, m in zip(mix_prompts, budgets)]
    b7 = verify = 0     # B7 launches: all, and in verify rounds
    modes = {"draft": dict(draft=draft, spec_k=SPEC_K),
             "lookup": dict(lookup=True, spec_k=SPEC_K)}
    for mode, extra in modes.items():
        for kind in ("flash", "gather"):
            run = drive(srv32, kind, **extra)
            b7 += run["launches"]
            verify += run["launches"]
            for i, (got, want) in enumerate(zip(run["streams"], msolo)):
                parted(srv32, mix_prompts[i], want, got,
                       f"batcher {mode} {kind} request {i}")
            print(f"path (i) batcher {mode} {kind} (float32 cache): stats "
                  f"{run['stats']}; B7 launches {run['launches']}; "
                  f"acceptance {run['accept']:.4f} over "
                  f"{run['slot_rounds']} slot rounds")

    # 9. the bfloat16 drives, timed beside path (e)'s plain drive; the
    # target as its own draft accepts every proposal: the most a round
    # can emit
    srv16 = FlashLMServer(model)
    timed = {}
    for mode, extra in (("plain", {}), *modes.items(),
                        ("self draft", dict(draft=srv16, spec_k=SPEC_K))):
        extra = dict(extra)
        if mode == "draft":
            extra["draft"] = FlashLMServer(drafts[1])
        drive(srv16, "flash", check=False, **extra)          # warm
        run = drive(srv16, "flash", **extra)
        b7 += run["launches"]
        verify += run["launches"] if extra else 0
        timed[mode] = run
        d = run["stats"]["dispatches"]
        acc = ("" if run["accept"] is None
               else f", acceptance {run['accept']:.4f}")
        print(f"path (i) timed {mode} flash drive (bf16 cache): "
              f"{run['tokens']} tokens in {run['secs']:.3f} s: "
              f"{run['tokens'] / run['secs']:.1f} tokens/s, {d} dispatches, "
              f"{run['secs'] / d * 1e3:.2f} ms a dispatch{acc}; stats "
              f"{run['stats']} on {gpu}")
    wall, wait, calls = readback_split(lambda: drive(
        srv16, "flash", check=False, draft=FlashLMServer(drafts[1]),
        spec_k=SPEC_K))
    print(f"path (i) draft flash drive under cProfile: {wall:.3f} s, "
          f"{wait:.3f} s blocked in {calls} reads back "
          f"({wait / max(calls, 1) * 1e3:.3f} ms a read) on {gpu}")
    out.update(timed=timed, b7=b7, b7_verify=verify, b2=b2,
               drive_split=(wall, wait, calls))
    return out


# --- encoder-decoder and recurrent serving, the model extras (17-19) ------

def reversal_data(rng, vocab, n, s):
    """Sequence reversal: sources of ids in [1, vocab), targets the
    reversed source teacher-forced after BOS 0, one-hot labels."""
    src = rng.integers(1, vocab, (n, s)).astype(np.float32)
    rev = src[:, ::-1]
    tgt = np.concatenate([np.zeros((n, 1), np.float32), rev[:, :-1]], 1)
    labels = np.eye(vocab, dtype=np.float32)[rev.astype(np.int64)]
    return {"src": src, "tgt": tgt, "labels": labels}


def s2s_parted(server, src_row, want, got, what):
    """Where greedy stream ``got`` first parts from ``want`` (the stream
    of ``src_row`` alone), with the server's top-2 logit margin there on
    ``src_row``, which must be within NEAR_TIE; None when equal."""
    differ = np.flatnonzero(np.asarray(want) != np.asarray(got))
    if not differ.size:
        return None
    j = int(differ[0])
    prefix = np.concatenate([[0.0], np.asarray(want[:j], np.float32)])
    logits, _ = server.prefill(prefix[None], server.encode(src_row[None]),
                               server.init_caches(1, j + 1))
    top = torch.topk(logits[0, -1].float(), 2).values
    margin = float(top[0] - top[1])
    print(f"path (j) {what}: parts at token {j} ({got[j]} vs {want[j]}); "
          f"top-2 logit margin {margin:.3e}")
    assert margin <= NEAR_TIE, (what, j, margin)
    return j, margin


def _counters():
    from exprgrad_torch.ops import (attention, mapreduce, matmul,
                                    paged_attention, rowchain)

    return attention, matmul, mapreduce, rowchain, paged_attention


def reset_counters() -> None:
    attention, *others = _counters()
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    for c in others:
        c.launches = 0


def flash_counts() -> dict:
    attention = _counters()[0]
    return {"forward": attention.launches, "dq": attention.dq_launches,
            "dkv": attention.dkv_launches}


def drive_s2s_mix(server, srcs, budgets, **kw):
    """Serve the mix through ``Seq2SeqBatcher(server, slots, **kw)``: half
    the requests up front, then one more before each ``step()``.  Returns
    (streams in submission order, the batcher, seconds from its
    construction to the last token, synchronized)."""
    from exprgrad_torch.models import Seq2SeqBatcher

    n = len(srcs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = Seq2SeqBatcher(server, slots=S2S_MIX["slots"], **kw)
    rids = [b.submit(s, m) for s, m in zip(srcs[:n // 2], budgets[:n // 2])]
    out = {}
    while len(out) < n:
        if len(rids) < n:
            i = len(rids)
            rids.append(b.submit(srcs[i], budgets[i]))
        out.update(b.step())
    torch.cuda.synchronize()
    return [out[r] for r in rids], b, time.perf_counter() - t0


def path_j(egt, gpu) -> dict:
    """Phase 17: path (j), bench.py's seq2seq cell.  Training runs B2 on
    the non-causal encoder, the causal decoder and the cross-attention
    (sq != skv), and B3/B4 carry the gradient into the encoder through
    the cross K/V; greedy_decode runs B2 at every target width from 1
    to 64.  Seq2SeqServer and Seq2SeqBatcher attend in plain torch, as
    the JAX package's (no kernel of their own)."""
    from exprgrad_torch.models import (Seq2SeqServer, greedy_decode,
                                       tiny_seq2seq)

    vocab = SEQ2SEQ["vocab"]
    graph = tiny_seq2seq(**SEQ2SEQ)
    card = egt.compile(graph, seed=0, device="cuda")
    cpu = egt.compile(graph, seed=0, device="cpu")
    n_params = sum(v.numel() for v in card.params.values())
    data = reversal_data(np.random.default_rng(0), vocab, S2S_BATCH, S2S_SRC)
    start = {t: v.clone() for t, v in cpu.params.items()}

    # training: S2S_STEPS steps held against the CPU port, then the timed
    # ones; the counters cover every step and greedy_decode
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(S2S_STEPS):
        card.epoch += 1
        card.apply("train", data)
    torch.cuda.synchronize()
    held_ms = (time.perf_counter() - t0) * 1e3
    steps_launches = flash_counts()
    stats = card.lowering_stats("train")
    per_step = stats.get("attention-impl:flash")
    assert per_step == 3, stats  # encoder, decoder self, cross
    assert stats.get("attention-grad-impl:flash") == 3, stats
    assert steps_launches == {"forward": 3 * S2S_STEPS, "dq": 3 * S2S_STEPS,
                              "dkv": 3 * S2S_STEPS}, steps_launches
    for _ in range(S2S_STEPS):
        cpu.epoch += 1
        cpu.apply("train", data)
    loss = float(card.call("loss", data)[0])
    cpu_loss = float(cpu.call("loss", data)[0])
    rel, worst = update_err(card.params, cpu.params, start)
    print(f"path (j) tiny_seq2seq {SEQ2SEQ}: {n_params} parameters; "
          f"{S2S_STEPS} adam steps on reversal [{S2S_BATCH},{S2S_SRC}] "
          f"({held_ms:.1f} ms on the card): loss {loss:.6f} vs CPU "
          f"{cpu_loss:.6f}; parameters vs CPU |diff| / |update| "
          f"{rel:.3e}, max |diff| {worst:.3e}; B2/B3/B4 launches a step "
          f"{per_step} each")
    np.testing.assert_allclose(loss, cpu_loss, **TRAIN_LOSS)
    assert rel <= TRAIN_UPDATE_RTOL, rel
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        card.epoch += 1
        card.apply("train", data)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"path (j) train step [{S2S_BATCH},{S2S_SRC}]: {step_ms:.2f} ms "
          f"(mean of {TIMED_STEPS} warm steps) on {gpu}")

    # predict on the card against the CPU port on the card's weights
    host = {t: v.cpu().numpy() for t, v in card.params.items()}
    cpu_copy = egt.from_state(graph, host, {t: v.cpu().numpy() for t, v in
                                           card.caches.items()},
                              card.epoch, device="cpu")
    args = {"src": data["src"], "tgt": data["tgt"]}
    probs = card.call("predict", args)
    want = cpu_copy.call("predict", args)
    predict_err = float(np.abs(probs - want).max())
    np.testing.assert_allclose(probs, want, **PREDICT)

    # greedy_decode: predict at every target width from 1 to S2S_NEW
    src = data["src"]
    before = flash_counts()["forward"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decoded = greedy_decode(card, src, S2S_NEW).astype(np.int64)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = flash_counts()["forward"] - before
    assert decode_launches == 3 * S2S_NEW, decode_launches
    launches = flash_counts()
    print(f"path (j) predict vs the CPU port: max |err| {predict_err:.3e}; "
          f"greedy_decode {S2S_BATCH}x{S2S_SRC} -> {S2S_NEW}: {decode_s:.3f}"
          f" s, {S2S_BATCH * S2S_NEW / decode_s:.1f} tokens/s, B2 launches "
          f"{decode_launches} (3 a width, widths 1-{S2S_NEW}) on {gpu}")

    # Seq2SeqServer: prefill against predict, then each mode
    server = Seq2SeqServer(card)
    logits, _ = server.prefill(data["tgt"], server.encode(src),
                               server.init_caches(S2S_BATCH, S2S_SRC))
    serve_probs = torch.softmax(logits, -1).cpu().numpy()
    np.testing.assert_allclose(serve_probs, probs, rtol=1e-4, atol=1e-5)
    server.generate(src, n_new=S2S_NEW)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = _ids(server.generate(src, n_new=S2S_NEW))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    assert flash_counts() == launches, "the server launched a kernel"
    parts = [s2s_parted(server, src[i], decoded[i], greedy[i],
                        f"generate row {i} vs greedy_decode")
             for i in range(S2S_BATCH)]
    res = {"launches": launches, "step_ms": step_ms,
           "decode_tok_s": S2S_BATCH * S2S_NEW / decode_s,
           "generate_tok_s": S2S_BATCH * S2S_NEW / gen_s}
    print(f"path (j) Seq2SeqServer.generate {S2S_BATCH}x{S2S_SRC} -> "
          f"{S2S_NEW} greedy (float32 cache): {gen_s:.3f} s, "
          f"{res['generate_tok_s']:.1f} tokens/s, "
          f"{res['generate_tok_s'] / res['decode_tok_s']:.1f}x "
          f"greedy_decode; {sum(p is None for p in parts)} of {S2S_BATCH} "
          f"rows equal greedy_decode's on {gpu}")

    rng = np.random.default_rng(1)
    lens = rng.integers(*S2S_RAGGED, S2S_BATCH)
    ragged_src = np.zeros_like(src)
    rows = []
    for i, n in enumerate(lens):
        rows.append(rng.integers(1, vocab, n).astype(np.float32))
        ragged_src[i, :n] = rows[-1]
    ragged = _ids(server.generate(ragged_src, n_new=S2S_NEW, lengths=lens))
    for i, row in enumerate(rows):
        solo = _ids(server.generate(row[None], n_new=S2S_NEW))[0]
        s2s_parted(server, row, solo, ragged[i], f"ragged row {i} (length "
                   f"{lens[i]}) vs solo")
    beam, beam_scores = server.generate_beam(src, n_new=S2S_NEW, beams=1)
    for i in range(S2S_BATCH):
        s2s_parted(server, src[i], greedy[i], _ids(beam)[i, 0],
                   f"beam of one row {i} vs greedy")
    # a round verifies k positions past the accepted ones, so the
    # positional table (max_tgt) holds n_new + k + 1
    spec_new = SEQ2SEQ["max_tgt"] - 1 - SPEC_K
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, rounds = server.generate_speculative(server, src[:1],
                                               n_new=spec_new, k=SPEC_K)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    s2s_parted(server, src[0], greedy[0, :spec_new], _ids(spec)[0],
               "self-draft speculation vs greedy")
    assert rounds <= -(-(spec_new - 1) // SPEC_K), rounds
    nll, _ = server.score(src, greedy)
    prefix = np.concatenate([np.zeros((S2S_BATCH, 1)), greedy[:, :-1]],
                            1).astype(np.float32)
    p = card.call("predict", {"src": src, "tgt": prefix})
    launches = res["launches"] = flash_counts()  # and the serving none
    want_nll = -np.log(np.take_along_axis(p, greedy[:, :, None], -1)[..., 0]
                       ).sum(-1)
    np.testing.assert_allclose(nll.cpu().numpy(), want_nll, rtol=SCORE_RTOL)
    quant = Seq2SeqServer(card, weight_dtype=torch.int8)
    q_logits, _ = quant.prefill(data["tgt"], quant.encode(src),
                                quant.init_caches(S2S_BATCH, S2S_SRC))
    q_rel = float(torch.linalg.norm(q_logits - logits)
                  / torch.linalg.norm(logits))
    assert q_rel <= QUANT_REL, q_rel
    print(f"path (j) ragged lengths {lens.tolist()} against solo, beam of "
          f"one against greedy: checked; self-draft speculation k={SPEC_K}, "
          f"{spec_new} tokens: {rounds} rounds, {spec_s:.3f} s, "
          f"{spec_new / spec_s:.1f} tokens/s"
          f"; score against predict's NLL: max rel err "
          f"{float(np.abs(nll.cpu().numpy() / want_nll - 1).max()):.3e}; "
          f"int8 weights: prefill logits relative L2 {q_rel:.4f} on {gpu}")

    # Seq2SeqBatcher over the staggered mix, plain and lookup
    n = S2S_MIX["n"]
    sizes = rng.integers(*S2S_MIX["src"], n)
    budgets = [int(x) for x in rng.integers(*S2S_MIX["budget"], n)]
    srcs = [rng.integers(1, vocab, m).astype(np.float32) for m in sizes]
    solo = [_ids(server.generate(s[None], n_new=m))[0]
            for s, m in zip(srcs, budgets)]
    for name, kw in (("plain", {}), ("lookup", dict(lookup=True,
                                                    spec_k=SPEC_K))):
        drive_s2s_mix(server, srcs, budgets, **kw)  # warm
        streams, b, secs = drive_s2s_mix(server, srcs, budgets, **kw)
        for i, (got, ref) in enumerate(zip(streams, solo)):
            assert got.shape == ref.shape, (name, i, got.shape)
            s2s_parted(server, srcs[i], ref, got,
                       f"batcher {name} request {i} vs solo")
        tokens = sum(len(x) for x in streams)
        m = b.request_metrics()
        res[f"batcher_{name}_tok_s"] = tokens / secs
        print(f"path (j) Seq2SeqBatcher(slots={S2S_MIX['slots']}) {name}: "
              f"{n} requests of {sizes.min()}-{sizes.max()} source tokens, "
              f"{tokens} tokens in {secs:.3f} s: {tokens / secs:.1f} "
              f"tokens/s, ttft {_percentiles([r['ttft_s'] for r in m])}, "
              f"latency {_percentiles([r['latency_s'] for r in m])}; "
              f"stats {b.stats} on {gpu}")
    assert flash_counts() == launches, "serving launched a kernel"
    return res


def path_k(egt, trained, gpu) -> dict:
    """Phase 18: path (k), RecurrentServer on path (h)'s three trained
    cells: greedy against the predict target's argmax chain (recomputed
    from scratch each step), but at near-ties; tokens/s."""
    from exprgrad_torch.models import RecurrentServer

    out = {}
    for cell, (model, args) in trained.items():
        srv = RecurrentServer(model)
        prompt = args["tokens"][:RNN_SERVE["batch"]]
        new = RNN_SERVE["new"]
        srv.generate(prompt, n_new=new)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = _ids(srv.generate(prompt, n_new=new))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        window, margins, equal = prompt.copy(), {}, 0
        chain = []
        for _ in range(new):
            probs = model.call("predict", {"tokens": window})[:, -1]
            chain.append(probs)
            nxt = probs.argmax(-1)
            window = np.concatenate([window, nxt[:, None].astype(
                np.float32)], 1)
        want = window[:, prompt.shape[1]:].astype(np.int64)
        for r in range(len(prompt)):
            differ = np.flatnonzero(want[r] != got[r])
            if not differ.size:
                equal += 1
                continue
            j = int(differ[0])
            top = np.sort(np.log(chain[j][r]))[-2:]
            margins[r] = float(top[1] - top[0])
            assert margins[r] <= NEAR_TIE, (cell, r, j, margins[r])
        out[cell] = len(prompt) * new / secs
        print(f"path (k) RecurrentServer {cell}: {len(prompt)}x"
              f"{prompt.shape[1]} -> {new} greedy: {secs:.3f} s, "
              f"{out[cell]:.1f} tokens/s; {equal} of {len(prompt)} rows "
              f"equal the predict chain (near-ties {margins}) on {gpu}")
    return out


def is_b2(name: str) -> bool:
    """Kernel B2 by its CUDA name (csrc/flash_fwd.cu's, in an anonymous
    namespace), not sdpa's (``pytorch_flash::flash_fwd_kernel``,
    ``fmha_*``)."""
    return "(anonymous namespace)::flash_fwd_kernel<" in name


def phase_extras(egt, model, q, k, v, gpu) -> dict:
    """Phase 19: the model extras.  export_compiled of phase 3's serving
    predict at [BATCH, SEQ] and of path (a)'s scheduled contraction at
    EXPORT_MATMUL_N, load_compiled, each artifact against model.call and
    running B2 (not sdpa) or B1; save_hlo naming both ops; profile's
    trace holding B2; and the host microseconds a call of B2 and B1
    through their torch.library ops beside the direct launch (what the
    wrappers did before the ops)."""
    import json as _json
    import tempfile

    from exprgrad_torch.ops import attention, matmul
    from exprgrad_torch.utils import kernels

    res = {"launches": {"B1": 0, "B2": 0}}
    tokens = np.random.default_rng(0).integers(
        0, SERVING["vocab"], (BATCH, SEQ)).astype(np.float32)
    n = EXPORT_MATMUL_N
    ab = np.random.default_rng(1).normal(size=(2, n, n)).astype(np.float32)
    mm = egt.compile(matmul_graph(egt, MATMUL_TILE), seed=0,
                     schedule_mode="force", device="cuda")
    cases = (("predict", model, "predict", {"tokens": tokens}, "B2",
              attention, SERVING["blocks"]),
             ("path (a)", mm, "c", {"a": ab[0], "b": ab[1]}, "B1", matmul,
              1))
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        for what, m, target, args, kernel, counter, per_call in cases:
            shapes = {name: list(a.shape) for name, a in args.items()}
            want = m.call(target, args)
            t0 = time.perf_counter()
            data = m.export_compiled(target, shapes)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fn = egt.load_compiled(data)
            load_s = time.perf_counter() - t0
            reset_counters()
            got = fn(args)
            torch.cuda.synchronize()
            launched = counter.launches
            assert launched == per_call, (what, launched)
            res["launches"][kernel] += launched
            err = float(np.abs(got.cpu().numpy() - want).max())
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5,
                                       atol=1e-6)
            names = kernel_names(lambda: fn(args))
            if kernel == "B2":
                assert any(is_b2(x) for x in names), names
                assert not any("fmha" in x or "pytorch_flash" in x
                               for x in names), names
            else:
                assert any("matmul_kernel" in x for x in names), names
            path = f"{tmp}/{target}.txt"
            m.save_hlo(path, target, shapes)
            op = {"B2": "exprgrad_torch.flash_fwd",
                  "B1": "exprgrad_torch.matmul"}[kernel]
            with open(path) as f:
                assert op in f.read(), (what, op)
            print(f"phase 19 {what}: export_compiled {export_s:.2f} s "
                  f"({len(data)} bytes), load_compiled {load_s:.2f} s; the "
                  f"artifact against model.call max |err| {err:.3e}, "
                  f"{kernel} launches {launched} a call; save_hlo names "
                  f"{op}; kernels {[x[:50] for x in names]} on {gpu}")
        logdir = f"{tmp}/profile"
        model.profile("predict", {"tokens": tokens}, logdir)
        with open(f"{logdir}/predict.pt.trace.json") as f:
            events = _json.load(f)["traceEvents"]
        assert any(is_b2(e.get("name", "")) for e in events)
        print(f"phase 19 profile: {len(events)} trace events in "
              f"{logdir}/predict.pt.trace.json, B2 among them")

    a = torch.randn(256, 256, device=q.device)
    qs = q[:1, :1, :64, :64].contiguous()  # device time far below the host's
    fns = {"B2 op": lambda: attention.flash_attention_forward(
               q, k, v, causal=True),
           "B2 direct": lambda: attention._flash_fwd_cuda(
               q, k, v, None, True, None, None),
           "B2 small op": lambda: attention.flash_attention_forward(
               qs, qs, qs, causal=True),
           "B2 small direct": lambda: attention._flash_fwd_cuda(
               qs, qs, qs, None, True, None, None),
           "B1 op": lambda: matmul.matmul_impl(a, a),
           "B1 direct": lambda: matmul._matmul_cuda(a, a, None, [], [], [],
                                                    [], False)}
    host = {name: [] for name in fns}
    for kern in ("B2", "B2 small", "B1"):
        for how in ("op", "direct", "direct", "op"):
            host[f"{kern} {how}"].append(round(host_us(fns[f"{kern} {how}"],
                                                       calls=1000), 2))
    res["host_us"] = host
    print(f"phase 19 host us a call, through the torch.library op and the "
          f"direct launch, in turns (B2 at [8,4,256,128] f32 causal and "
          f"at [1,1,64,64], B1 at 256^3): {host} on {gpu}")
    return res


_LOAD_IN_CHILD = """
import json, sys
import numpy as np
import torch
import exprgrad_torch as egt
from exprgrad_torch.ops import mapreduce, matmul, rowchain
args = dict(np.load(sys.argv[2]))
fn = egt.load_compiled(sys.argv[1])
got = fn(args)
torch.cuda.synchronize()
np.save(sys.argv[3], got.cpu().numpy())
print(json.dumps({"mapreduce": mapreduce.launches, "rowchain": rowchain.launches,
                  "matmul": matmul.launches, "modules": sorted(
                      m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu"))}))
"""


def export_generated(egt, gpu) -> dict:
    """Phase 19 (b): export of plans that launch the generated kernels:
    path (d)'s head predict (B1 and two B6 a call) and path (c)'s bench.py
    scatter-add (one B5 scatter).  Each artifact within rtol 1e-5 of
    model.call, running the generated kernels (counted, and by name under
    torch.profiler), save_hlo naming the ops; the scatter-add's artifact
    also loads and runs in a fresh process that imports only
    exprgrad_torch.  Returns the launches of the artifacts' calls."""
    import tempfile

    from exprgrad_torch.ops import mapreduce, matmul, rowchain
    from exprgrad_torch.utils import kernels

    counters = {"mapreduce": mapreduce, "rowchain": rowchain,
                "matmul": matmul}
    head = egt.compile(transformer_head(egt, HEAD["dim"], HEAD["vocab"]),
                       seed=0, schedule_mode="force", device="cuda")
    x = np.random.default_rng(2).standard_normal(
        (HEAD["rows"], HEAD["dim"]), dtype=np.float32)
    (_, graph, target, args, _) = next(
        p for p in path_c_programs(egt) if p[0] == "scatter-add (bench.py)")
    scatter = egt.compile(graph, seed=0, schedule_mode="force",
                          device="cuda")
    cases = (("path (d) head predict", head, "predict", {"x": x}),
             ("path (c) scatter-add", scatter, target, args))
    total = dict.fromkeys(counters, 0)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        for what, m, target, args in cases:
            shapes = {name: list(a.shape) for name, a in args.items()}
            want = m.call(target, args)
            stats = m.lowering_stats(target)
            expect = {"mapreduce": stats.get("mapreduce", 0),
                      "rowchain": stats.get("rowchain", 0),
                      "matmul": stats.get("matmul", 0)
                      + stats.get("matmul-fused", 0)}
            (ex,) = (e for (t, _), e in m._executors.items() if t == target)
            generated = ex.generated_kernels()
            assert len(generated) == expect["mapreduce"] + expect[
                "rowchain"] and generated, (what, generated, stats)
            t0 = time.perf_counter()
            data = m.export_compiled(target, shapes)
            export_s = time.perf_counter() - t0
            fn = egt.load_compiled(data)
            reset_counters()
            got = fn(args)
            torch.cuda.synchronize()
            launched = {k: c.launches for k, c in counters.items()}
            assert launched == expect, (what, launched, expect)
            for k in total:
                total[k] += launched[k]
            got = got.cpu().numpy()
            err = float(np.abs(got - want).max())
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            names = kernel_names(lambda: fn(args))
            for kind, name in (("rowchain", "egt_rowchain"),
                               ("mapreduce", "egt_mapreduce")):
                if expect[kind]:
                    assert any(name in n for n in names), (what, names)
            path = f"{tmp}/{target}.txt"
            m.save_hlo(path, target, shapes)
            with open(path) as f:
                text = f.read()
            ops = [f"exprgrad_torch.{k}" for k, n in expect.items() if n]
            assert all(op in text for op in ops), (what, ops)
            print(f"phase 19 {what}: export_compiled {export_s:.2f} s "
                  f"({len(data)} bytes); the artifact against model.call max "
                  f"|err| {err:.3e}, launches {launched} a call (the plan "
                  f"{generated}); save_hlo names {ops}; kernels "
                  f"{[n[:40] for n in names]} on {gpu}")
        art, npz, out = (f"{tmp}/scatter.egc", f"{tmp}/args.npz",
                         f"{tmp}/got.npy")
        with open(art, "wb") as f:
            f.write(data)
        np.savez(npz, **args)
        here = str(Path(__file__).resolve().parent)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", _LOAD_IN_CHILD, art, npz,
                              out], capture_output=True, text=True, env=env,
                             timeout=600)
        child_s = time.perf_counter() - t0
        assert run.returncode == 0, run.stderr[-4000:]
        child = json.loads(run.stdout.strip().splitlines()[-1])
        assert child["modules"] == [], child
        assert child["mapreduce"] == expect["mapreduce"] == 1, child
        err = float(np.abs(np.load(out) - want).max())
        np.testing.assert_allclose(np.load(out), want, rtol=1e-5, atol=1e-6)
        print(f"phase 19 path (c) scatter-add loaded in a fresh process "
              f"({child_s:.1f} s, imports only exprgrad_torch): launches "
              f"{child}, max |err| against model.call {err:.3e}")
    return total


def _parted_at_near_ties(srv, prompts, ref, streams, what) -> list:
    """Where ``streams`` part from ``ref``, the solo run's top-2 logit
    margin at the first differing token must be a near-tie; returns the
    (request, token, margin) of each parting."""
    parted = []
    for i, (r, g) in enumerate(zip(ref, streams)):
        differ = np.flatnonzero(r != g)
        if not differ.size:
            continue
        j = int(differ[0])
        seq = np.concatenate([prompts[i], r[:j].astype(np.float32)])
        logits, _ = srv.prefill(seq[None], srv.init_caches(1))
        top = torch.topk(logits[0, -1], 2).values
        margin = float(top[0] - top[1])
        parted.append((i, j, margin))
        print(f"path (l) {what} request {i}: parts at token {j} ({r[j]} vs "
              f"{g[j]}); solo top-2 logit margin {margin:.3e}")
        assert margin <= NEAR_TIE, (what, i, j, margin)
    return parted


def drive_batcher(b, prompts, budgets):
    """Serve the mix through the batcher ``b`` (half the requests up
    front, then one more before each step()) with the kernels' counters at
    0 just before; returns (streams, seconds to the last token,
    synchronized, graph replays in the drive, graphs captured in it, B7
    launches).  Checks each stream, that the replays are the chunk
    dispatches, and that every page came back."""
    from exprgrad_torch.ops import paged_attention

    n, vocab = len(prompts), b.server.vocab
    replays0 = sum(g.replays for g in b.chunk_graphs.values())
    graphs0, dispatches0 = len(b.chunk_graphs), b.stats["dispatches"]
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [b.submit(p, m) for p, m in zip(prompts[:n // 2],
                                          budgets[:n // 2])]
    out = {}
    while len(out) < n:
        if len(rids) < n:
            i = len(rids)
            rids.append(b.submit(prompts[i], budgets[i]))
        out.update(b.step())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = paged_attention.launches
    others = sum(c.launches for c in _counters()[:-1])
    assert others == 0, others
    replays = sum(g.replays for g in b.chunk_graphs.values()) - replays0
    dispatches = b.stats["dispatches"] - dispatches0
    assert replays == (dispatches if b.decode_chunk > 1 else 0), (
        replays, dispatches)
    assert b.stats["free_pages"] == b.stats["pool_pages"], b.stats
    streams = [out[r] for r in rids]
    for s, m in zip(streams, budgets):
        assert s.shape == (m,) and np.all((s >= 0) & (s < vocab)), s.shape
    return (streams, secs, replays, len(b.chunk_graphs) - graphs0,
            launches)


def b7_expected(b, replays, graphs, dispatches) -> int:
    """B7 launches of a run: a block each a step under flash, a step being
    an eager dispatch (decode_chunk 1), a captured step of a replay, or a
    graph's one-step warm-up; none under gather."""
    if b.attention != "flash":
        return 0
    blocks = len(b.server.blocks)
    if b.decode_chunk == 1:
        return blocks * dispatches
    return blocks * (b.decode_chunk * replays + graphs)


def path_l(egt, gpu) -> dict:
    """Phase 20: ContinuousBatcher(decode_chunk=N, pipeline=P) on the card,
    each chunk dispatch one CUDA graph replay: bench.py's
    continuous-batching cell (flash and gather; float32-cache greedy
    streams against decode_chunk 1 but at near-ties; bfloat16 drives
    timed), its steady-state sweep, and a windowed model's pipeline."""
    from torch.profiler import ProfilerActivity, profile

    from exprgrad_torch.models import (ContinuousBatcher, FlashLMServer,
                                       flash_transformer)

    res = {"b7": 0, "replays": 0, "tokens_s": {}}
    vocab, blocks = SERVING["vocab"], SERVING["blocks"]
    cap = CB_CELL["capacity"]
    model = egt.compile(flash_transformer(**dict(SERVING, max_seq=cap)),
                        seed=0, device="cuda")
    prompts, budgets = staggered_mix(vocab)
    tokens = sum(budgets)

    def run(b, what, timed=False):
        d0 = b.stats["dispatches"]
        streams, secs, replays, graphs, launches = drive_batcher(
            b, prompts, budgets)
        dispatches = b.stats["dispatches"] - d0
        want = b7_expected(b, replays, graphs, dispatches)
        assert launches == want, (what, launches, want, b.stats)
        res["b7"] += launches
        res["replays"] += replays
        print(f"path (l) {what}: {tokens} tokens in {secs:.4f} s, "
              f"{tokens / secs:.1f} tokens/s, {dispatches} dispatches "
              f"({secs / max(dispatches, 1) * 1e3:.3f} ms each), {replays} "
              f"graph replays, {graphs} captured; B7 launches {launches} = "
              f"{blocks} blocks x ({b.decode_chunk} steps x {replays} "
              f"replays + {graphs} warm-up); stats {b.stats}"
              + (f" on {gpu}" if timed else ""))
        return streams, secs

    def cell(server, kind, chunk=CB_CELL["decode_chunk"], **kw):
        return ContinuousBatcher(server, attention=kind, **dict(
            CB_CELL, decode_chunk=chunk, **kw))

    # float32 cache: decode_chunk 32 (flash, gather) against decode_chunk 1
    srv32 = FlashLMServer(model, cache_dtype=torch.float32)
    ref, _ = run(cell(srv32, "flash", chunk=1), "f32 flash chunk 1")
    for kind in ("flash", "gather"):
        got, _ = run(cell(srv32, kind), f"f32 {kind} chunk 32")
        parted = _parted_at_near_ties(srv32, prompts, ref, got,
                                      f"f32 {kind} chunk 32")
        print(f"path (l) f32 {kind} chunk 32: {len(prompts) - len(parted)} "
              f"of {len(prompts)} greedy streams equal decode_chunk 1's")

    # the default bfloat16 cache: a warm drive (with the capture), then a
    # timed drive on the same batcher; decode_chunk 1 beside it
    srv = FlashLMServer(model)
    for what, b in (("bf16 flash chunk 32", cell(srv, "flash")),
                    ("bf16 gather chunk 32", cell(srv, "gather")),
                    ("bf16 flash chunk 1", cell(srv, "flash", chunk=1))):
        run(b, what + " (first drive)")
        _, secs = run(b, what + " (warm)", timed=True)
        res["tokens_s"][what] = tokens / secs
        if what == "bf16 flash chunk 32":
            warm = b
    # one more warm drive under torch.profiler: the device's busy share
    # and B7's device time a launch inside the replays
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive_batcher(warm, prompts, budgets)
        wall = (time.perf_counter() - t0) * 1e3
    from exprgrad_torch.ops import paged_attention
    b7_launched = paged_attention.launches
    dev_ms, b7_ms, b7_seen = 0.0, 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            dev_ms += ms
            if "paged_split_kernel" in e.name or "paged_merge_kernel" in (
                    e.name):
                b7_ms += ms
                b7_seen += "paged_split_kernel" in e.name
    res["busy"] = dev_ms / wall
    res["b7_ms_per_launch"] = b7_ms / b7_seen if b7_seen else None
    print(f"path (l) bf16 flash chunk 32 under torch.profiler: wall "
          f"{wall:.2f} ms, device {dev_ms:.3f} ms, busy {dev_ms / wall:.4f}; "
          f"B7 {b7_seen} launches seen of {b7_launched}, device "
          f"{b7_ms:.4f} ms, {res['b7_ms_per_launch']} ms a launch on {gpu}")

    # the steady-state sweep (bench.py:632-700)
    steady_cap = STEADY["prompt"] + STEADY["budget"]
    smodel = egt.compile(flash_transformer(**dict(SERVING,
                                                  max_seq=steady_cap)),
                         seed=0, device="cuda")
    ssrv = FlashLMServer(smodel)
    pages = -(-steady_cap // STEADY["page_size"])
    full = {}
    res["steady"] = {}
    for chunk, pipe in STEADY_CONFIGS:
        b = ContinuousBatcher(
            ssrv, slots=STEADY["slots"], capacity=steady_cap, paged=True,
            page_size=STEADY["page_size"], pool_pages=STEADY["slots"] * pages,
            decode_chunk=chunk, pipeline=pipe, attention="flash")
        # the same prompts for every pair (bench.py draws each pair's from
        # one running generator), so that streams compare
        rng = np.random.default_rng(0)
        reset_counters()
        rids = [b.submit(rng.integers(0, vocab, STEADY["prompt"]).astype(
            np.float32), STEADY["budget"]) for _ in range(STEADY["slots"])]
        b.step()
        b.step()
        for _ in range(pipe):
            b.step()
        window = min(max(2 + pipe, 64 // chunk),
                     (STEADY["budget"] - 1) // chunk - 1 - 2 * pipe)
        assert window > 0, (chunk, pipe, window)
        steps0, d0 = b.stats["decode_steps"], b.stats["dispatches"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(window):
            b.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        assert b.active.all(), b.stats
        steps = b.stats["decode_steps"] - steps0
        dispatches = max(1, b.stats["dispatches"] - d0)
        key = f"{chunk}+pipe{pipe}" if pipe else str(chunk)
        res["steady"][key] = (STEADY["slots"] * steps / dt,
                              dt / steps * 1e3, dt / dispatches * 1e3)
        line = (f"path (l) steady {key}: {STEADY['slots'] * steps / dt:.1f} "
                f"tokens/s, {dt / steps * 1e3:.4f} ms per decode step, "
                f"{dt / dispatches * 1e3:.4f} ms per dispatch ({window} "
                f"step() calls timed)")
        if (chunk, pipe) in STEADY_FULL:
            out = b.run()
            full[(chunk, pipe)] = [out[r] for r in rids]
            replays = sum(g.replays for g in b.chunk_graphs.values())
            graphs = len(b.chunk_graphs)
            assert replays == b.stats["dispatches"], (replays, b.stats)
            launches = paged_attention.launches
            want = b7_expected(b, replays, graphs, b.stats["dispatches"])
            assert launches == want, (key, launches, want)
            assert b.stats["free_pages"] == b.stats["pool_pages"], b.stats
            res["b7"] += launches
            res["replays"] += replays
            line += (f"; to the end: {replays} replays, B7 launches "
                     f"{launches}")
        print(line + f" on {gpu}")
        if chunk == 32 and pipe == 0:
            res["tokens_s"]["steady 32"] = STEADY["slots"] * steps / dt
    for chunk, pipe in STEADY_FULL:
        if pipe:
            for a, c in zip(full[(chunk, pipe)], full[(chunk, 0)]):
                np.testing.assert_array_equal(a, c)
            print(f"path (l) steady {chunk}+pipe{pipe}: the {len(c)}-token "
                  f"greedy streams of all {STEADY['slots']} requests equal "
                  f"pipeline 0's")

    # a windowed model: pipeline 1 against pipeline 0 at decode_chunk 8
    wmodel = egt.compile(flash_transformer(**dict(
        SERVING, max_seq=cap, window=CB_WINDOW)), seed=0, device="cuda")
    wsrv = FlashLMServer(wmodel)
    got = {}
    for pipe in (1, 0):
        b = cell(wsrv, "flash", chunk=CB_WINDOW_CHUNK, pipeline=pipe)
        got[pipe], _ = run(b, f"window {CB_WINDOW} chunk "
                              f"{CB_WINDOW_CHUNK} pipeline {pipe}")
        assert b.stats["window_evicted"] > 0, b.stats
    for a, c in zip(got[1], got[0]):
        np.testing.assert_array_equal(a, c)
    print(f"path (l) window {CB_WINDOW}: the greedy streams of pipeline 1 "
          f"equal pipeline 0's")
    return res


# Phase 21, path (m): parallelism on torch.distributed.  (a) a world of
# one rank over NCCL in this process; (b) worlds of 2 and 4 ranks on this
# one card over gloo (NCCL refuses two ranks on one GPU), each rank a
# spawned process whose collectives stage CUDA tensors through the host.
# Meshes (data, model) of the training step and the options each runs
# with: ZeRO and FSDP shard over "data", so they run where it has 2
# ranks; (1, 2) has one data rank and takes the plain executor with the
# parameters' storage split over "model".  The sequence-parallel cases
# (impl, window) at [8, 4, 256, 128] float32 causal over 2 ranks (128
# rows a rank); path (a)'s scheduled matmul on a row shard per rank at
# MESH_MATMUL_N; path (d)'s head trained on a (2, 1) mesh, HEAD["rows"]
# split over the 2 ranks.
MESH_TRAIN = (((2, 1), ("zero",)), ((1, 2), ("offload_opt_state",)),
              ((2, 2), ("fsdp", "offload_opt_state")))
SP_SHAPE, SP_WINDOW = (8, 4, 256, 128), 64
SP_CASES = (("ring", None), ("ring", SP_WINDOW), ("gather", None),
            ("gather", SP_WINDOW))
MESH_MATMUL_N = 2048
# the longest a spawned world may take before the script fails
WORLD_DEADLINE = 420


def _rank_main(rank, world, store, out_dir, fn, args):
    """A spawned rank: joins the gloo world through the file ``store``
    on this card, runs ``fn(rank, world, *args)`` and leaves its result
    (or its traceback) under ``out_dir``."""
    import pickle
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=300))
        from exprgrad_torch.utils import kernels

        kernels.load()  # built by the parent: loads, never builds
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def spawn_world(fn, world, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one gloo
    group on this card; their results in rank order.  A rank that fails,
    or a world past WORLD_DEADLINE seconds, fails the script (the other
    ranks are killed)."""
    import pickle
    import shutil

    import torch.multiprocessing as mp
    from exprgrad_torch.utils import kernels

    root = kernels.BUILD_DIR / f"chip_smoke_world_{os.getpid()}_{world}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, str(root / "store"), str(root), fn,
                               args)) for r in range(world)]
    for p in procs:
        p.start()
    end = time.perf_counter() + WORLD_DEADLINE
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            assert not bad and time.perf_counter() < end, (
                f"world of {world}: ranks {bad} failed or the deadline "
                f"passed\n" + "\n".join(
                    (root / f"rank{r}.err").read_text()
                    for r in range(world)
                    if (root / f"rank{r}.err").exists()))
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        assert not bad, (f"world of {world}: ranks {bad} failed\n" +
                         "\n".join((root / f"rank{r}.err").read_text()
                                   for r in bad
                                   if (root / f"rank{r}.err").exists()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    out = []
    for r in range(world):
        with open(root / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    shutil.rmtree(root, ignore_errors=True)
    return out


def _mesh_step(model, mesh, first, options=()) -> tuple:
    """One ShardedExecutor train step of the serving model on ``first``
    with ``options`` (zero, fsdp, offload_opt_state): (its milliseconds,
    synchronized; the executor)."""
    from exprgrad_torch.parallel import ShardedExecutor

    shapes = {name: list(value.shape) for name, value in first.items()}
    ex = ShardedExecutor(model, "train", shapes, mesh,
                         batch_inputs=list(shapes),
                         **{o: True for o in options})
    model.epoch += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.run(first)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, ex


def _whole(model) -> dict:
    from exprgrad_torch.parallel.mesh import global_value

    return {t: global_value(v) for t, v in model.params.items()}


def _layouts(model) -> dict:
    """How many parameters and caches are split over ``data``, and how
    many caches lie in host memory."""
    from exprgrad_torch.parallel.mesh import is_dtensor, spec_of

    def split(table):
        return sum(1 for v in table.values()
                   if is_dtensor(v) and "data" in spec_of(v))

    return dict(data_params=split(model.params),
                data_caches=split(model.caches), caches=len(model.caches),
                host_caches=sum(1 for v in model.caches.values()
                                if (v.to_local() if hasattr(v, "to_local")
                                    else v).device.type == "cpu"))


def _head_dp(world) -> dict:
    """Path (d)'s head trained one step on a (2, 1) mesh, HEAD["rows"]
    rows split over the ranks, against the one-device step on the same
    rows (this rank, this card): the row chains (B6), the map/reduce
    kernels (B5) and the dense's matmul (B1) on each rank's rows,
    launches counted in the sharded step."""
    import exprgrad_torch as egt
    from exprgrad_torch.ops import mapreduce, matmul, rowchain
    from exprgrad_torch.parallel import ShardedExecutor, make_mesh

    graph = transformer_head(egt, HEAD["dim"], HEAD["vocab"])
    rows, dim, vocab = HEAD["rows"], HEAD["dim"], HEAD["vocab"]
    rng = np.random.default_rng(2)
    batch = {"x": rng.standard_normal((rows, dim), dtype=np.float32),
             "labels": np.eye(vocab, dtype=np.float32)[
                 rng.integers(0, vocab, rows)]}

    def fresh():
        m = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
        m.epoch = 1
        return m

    one = fresh()
    start = {t: v.clone() for t, v in one.params.items()}
    one.apply("train", batch)
    ref_loss = float(one.call("loss", batch)[0])
    solo = one.lowering_stats("train")
    mesh = make_mesh(world, devices="cuda:0")
    model = fresh()
    ex = ShardedExecutor(model, "train", {"x": [rows, dim],
                                          "labels": [rows, vocab]}, mesh)
    counters = (mapreduce, rowchain, matmul)
    for c in counters:
        c.launches = 0
    ex.run(batch)
    torch.cuda.synchronize()
    launches = {c.__name__.split(".")[-1]: c.launches for c in counters}
    stats = ex.lowering_stats()
    loss = float(model.call("loss", batch)[0])
    rel, worst = update_err(_whole(model), one.params, start)

    def warm(run):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / TIMED_STEPS

    return dict(launches=launches, stats=stats, solo=solo, loss=loss,
                ref_loss=ref_loss, rel=rel, worst=worst,
                ms=warm(lambda: ex.run(batch)),
                one_ms=warm(lambda: one.apply("train", batch)))


def _train_world(rank, world, ckpt, ref_ckpt, cases, save):
    """Each (mesh, options) of ``cases``: one sharded train step from the
    checkpoint ``ckpt``, held against the one-device step ``ref_ckpt``
    holds by phase 5's rule; in a world of 2, path (d)'s head on a
    (2, 1) mesh (``_head_dp``); with ``save``, a sharded checkpoint of
    the last case's state and (rank 0) its predict on 2 sequences."""
    from exprgrad_torch.io import load_model
    from exprgrad_torch.parallel import _comm, make_mesh, save_sharded

    data = lm_data(np.random.default_rng(0), SERVING["vocab"], TRAIN_SEQS,
                   SEQ)
    first = {name: value[:BATCH] for name, value in data.items()}
    start = load_model(ckpt, device="cuda").params
    ref = load_model(ref_ckpt, device="cuda")
    out = []
    for (data_axis, model_axis), options in cases:
        mesh = make_mesh(world, data=data_axis, model=model_axis,
                         devices="cuda:0")
        model = load_model(ckpt, device="cuda")
        reset_counters()
        _comm.reset_counters()
        ms, ex = _mesh_step(model, mesh, first, options)
        launches = flash_counts()
        staged, calls = _comm.staged_bytes, _comm.calls
        layouts = _layouts(model)
        loss = float(model.call("loss", first)[0])
        rel, worst = update_err(_whole(model), ref.params, start)
        # the step again, timed warm (the state now enters sharded)
        model.epoch += 1
        _comm.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run(first)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        out.append(dict(mesh=(data_axis, model_axis), options=options,
                        first_ms=ms, ms=warm, launches=launches,
                        staged=staged, calls=calls,
                        warm_staged=_comm.staged_bytes,
                        warm_calls=_comm.calls, loss=loss,
                        rel=rel, worst=worst, layouts=layouts,
                        stats=ex.lowering_stats()))
    if world == 2:
        out.append(_head_dp(world))
    if not save:
        return out, None
    save_sharded(model, ckpt + ".sharded")
    probs = model.call("predict", {"tokens": first["tokens"][:2]})
    return out, probs if rank == 0 else None


def _serve_world(rank, world, ckpt, mix):
    """Tensor-parallel serving on a (1, 2) mesh: greedy generate, the
    continuous batcher under path (e)'s mix, and decode_chunk 32's
    refusal; then sequence-parallel attention over the 2 ranks and path
    (a)'s scheduled matmul on a row shard each."""
    from exprgrad_torch import ModelRuntimeError
    from exprgrad_torch.io import load_model
    from exprgrad_torch.models import ContinuousBatcher, FlashLMServer
    from exprgrad_torch.ops import paged_attention
    from exprgrad_torch.parallel import _comm, make_mesh

    model = load_model(ckpt, device="cuda")
    mesh = make_mesh(world, model=world, devices="cuda:0")
    srv = FlashLMServer(model, cache_dtype=torch.float32, mesh=mesh)
    prompts = lm_data(np.random.default_rng(1), SERVING["vocab"], BATCH,
                      PROMPT)["tokens"]
    out = {"heads": (srv.heads, srv.kv_heads)}
    srv.generate(prompts[:1], n_new=2)  # warm-up
    reset_counters()
    _comm.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = srv.generate(prompts, n_new=NEW)
    torch.cuda.synchronize()
    out["generate_s"] = time.perf_counter() - t0
    out["generate_b2"] = flash_counts()["forward"]
    out["generate_staged"] = _comm.staged_bytes
    out["tokens"] = _ids(toks)

    prompts_mix, budgets = mix
    reset_counters()
    streams, b, secs, steps = drive_mix(srv, "flash", prompts_mix, budgets)
    out["mix"] = dict(streams=streams, secs=secs,
                      b7=paged_attention.launches,
                      dispatches=b.stats["dispatches"],
                      blocks=len(srv.blocks),
                      free=(b.stats["free_pages"], b.stats["pool_pages"]),
                      preemptions=b.stats["preemptions"])
    try:
        ContinuousBatcher(srv, attention="flash", decode_chunk=32,
                          **BATCHER)
        out["chunk_refusal"] = None
    except ModelRuntimeError as err:
        out["chunk_refusal"] = str(err)

    if rank == 0:  # solo streams and the near-tie margins where they part
        solo = FlashLMServer(model, cache_dtype=torch.float32)
        ref = _ids(solo.generate(prompts, n_new=NEW))
        out["solo_tokens"] = ref
        out["parted"] = _parted_at_near_ties(
            solo, list(prompts), list(ref), list(out["tokens"]),
            "path (m) tensor-parallel generate")
        ref_mix = [_ids(solo.generate(p[None], n_new=m))[0]
                   for p, m in zip(prompts_mix, budgets)]
        out["mix_parted"] = _parted_at_near_ties(
            solo, prompts_mix, ref_mix, streams,
            "path (m) tensor-parallel batcher")
    out["sp"] = _sp_cases(rank, world)
    out["matmul"] = _row_shard_matmul(world)
    return out


def _sp_cases(rank, world) -> list:
    """Ring and gather at SP_SHAPE, causal with and without the window,
    against one-device B2-B4 on the same inputs (every rank checks)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from exprgrad_torch.ops import attention
    from exprgrad_torch.parallel import _comm, sequence_parallel_attention
    from exprgrad_torch.parallel.mesh import global_value

    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    mesh.egt_device = torch.device("cuda:0")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    q, k, v, g = (torch.randn(SP_SHAPE, generator=gen, device="cuda")
                  for _ in range(4))
    n = SP_SHAPE[2] // world
    res = []
    for impl, window in SP_CASES:
        want, lse = attention.flash_attention_forward(q, k, v, None, True,
                                                      window=window)
        want_g = attention.flash_attention_backward(q, k, v, want, lse, g,
                                                    None, True,
                                                    window=window)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        reset_counters()
        out = sequence_parallel_attention(qs, ks, vs, mesh, causal=True,
                                          impl=impl, window=window)
        fwd = flash_counts()["forward"]
        (out.to_local() * g[:, :, rank * n:(rank + 1) * n]).sum().backward()
        counts = flash_counts()
        got = global_value(out.detach())
        grads = [_comm.all_reduce(x.grad, dist.group.WORLD)
                 for x in (qs, ks, vs)]
        what = f"path (m) {impl} window {window}"
        out_err = _close(f"{what} out", got, want, F32_OUT)
        grad_err = max(_close(f"{what} d{name}", a, b, F32_GRAD)
                       for name, a, b in zip("qkv", grads, want_g))
        res.append(dict(impl=impl, window=window, b2=fwd,
                        dq=counts["dq"], dkv=counts["dkv"],
                        out_err=out_err, grad_err=grad_err))
    return res


def _close(name, got, want, tol) -> float:
    """Assert ``got`` within ``tol`` of ``want``; returns max |error|."""
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    return (got.float() - want.float()).abs().max().item()


def _row_shard_matmul(world) -> dict:
    """Path (a)'s scheduled matmul at MESH_MATMUL_N under dp: each rank's
    B1 launch multiplies its row shard of ``a``."""
    import exprgrad_torch as egt
    from exprgrad_torch.ops import matmul
    from exprgrad_torch.parallel import ShardedExecutor, make_mesh

    n = MESH_MATMUL_N
    mesh = make_mesh(world, devices="cuda:0")
    model = egt.compile(matmul_graph(egt, MATMUL_TILE), seed=0,
                        schedule_mode="force", device="cuda")
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(n, n)).astype(np.float32) for _ in range(2))
    ex = ShardedExecutor(model, "c", {"a": [n, n], "b": [n, n]}, mesh,
                         batch_inputs=["a"])
    reset_counters()
    c = ex.run({"a": a, "b": b})[model.program.targets["c"].output]
    launches = matmul.launches
    want = torch.as_tensor(a, dtype=torch.float64) @ torch.as_tensor(
        b, dtype=torch.float64)
    err = float((c.double().cpu() - want).abs().max())
    np.testing.assert_allclose(c.double().cpu().numpy(), want.numpy(),
                               **matmul_f32_tol(n))
    return dict(launches=launches, err=err, stats=ex.lowering_stats())


def path_m(egt, model, gpu) -> dict:
    """Phase 21, path (m): the parallel layer at the serving widths with
    phase 5's trained weights.  (a) a world of one NCCL rank in this
    process: FlashLMServer(mesh=make_mesh(1)) greedy 8x128 -> 128 equal
    to solo, score within rtol 1e-5, a ShardedExecutor train step equal
    to apply("train"); (b) gloo worlds of 2 and 4 ranks on this card:
    tensor-parallel serving and batching, sequence-parallel attention,
    a row-sharded B1, the training step on three meshes against the
    one-device step, and a sharded checkpoint that loads on (a)'s world
    of one and predicts the same.  Returns the launches each kernel made
    in the spawned ranks and here."""
    import torch.distributed as dist

    from exprgrad_torch.io import load_model, save_model
    from exprgrad_torch.models import FlashLMServer
    from exprgrad_torch.parallel import load_sharded, make_mesh
    from exprgrad_torch.utils.kernels import BUILD_DIR as kernels_dir

    ckpt = str(kernels_dir / "chip_smoke_parallel_start.egt")
    ref_ckpt = str(kernels_dir / "chip_smoke_parallel_ref.egt")
    save_model(model, ckpt)
    data = lm_data(np.random.default_rng(0), SERVING["vocab"], TRAIN_SEQS,
                   SEQ)
    first = {name: value[:BATCH] for name, value in data.items()}
    totals = {"forward": 0, "dq": 0, "dkv": 0, "b7": 0, "b1": 0, "b5": 0,
              "b6": 0}

    # (a) one NCCL rank ------------------------------------------------
    store = kernels_dir / f"chip_smoke_nccl_{os.getpid()}"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh1 = make_mesh(1, devices="cuda:0")
        solo = FlashLMServer(model, cache_dtype=torch.float32)
        meshed = FlashLMServer(model, cache_dtype=torch.float32, mesh=mesh1)
        prompts = lm_data(np.random.default_rng(1), SERVING["vocab"], BATCH,
                          PROMPT)["tokens"]
        reset_counters()
        t0 = time.perf_counter()
        got = _ids(meshed.generate(prompts, n_new=NEW))
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = _ids(solo.generate(prompts, n_new=NEW))
        torch.cuda.synchronize()
        solo_s = time.perf_counter() - t0
        assert np.array_equal(got, want), "mesh(1) generate differs from solo"
        nll = meshed.score(prompts).cpu().numpy()
        np.testing.assert_allclose(nll, solo.score(prompts).cpu().numpy(),
                                   rtol=1e-5)
        ref = load_model(ckpt, device="cuda")
        ref.epoch += 1
        ref.apply("train", first)
        save_model(ref, ref_ckpt)
        ref_loss = float(ref.call("loss", first)[0])
        # the one-device step again, warm, for its time
        ref.epoch += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref.apply("train", first)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        ref = load_model(ref_ckpt, device="cuda")
        one = load_model(ckpt, device="cuda")
        reset_counters()
        one_ms, _ = _mesh_step(one, mesh1, first)
        for kind, n in flash_counts().items():
            totals[kind] += n
        start = load_model(ckpt, device="cuda").params
        rel, worst = update_err(_whole(one), ref.params, start)
        loss1 = float(one.call("loss", first)[0])
        np.testing.assert_allclose(loss1, ref_loss, **TRAIN_LOSS)
        assert rel <= TRAIN_UPDATE_RTOL, rel
        print(f"path (m) (a) world of 1 over NCCL: generate {BATCH}x"
              f"{PROMPT} -> {NEW} equal to solo ({BATCH * NEW / mesh_s:.1f} "
              f"tokens/s, solo {BATCH * NEW / solo_s:.1f}); score equal to "
              f"rtol 1e-5; a ShardedExecutor step {one_ms:.1f} ms (its "
              f"first) against a warm apply('train') {single_ms:.1f} ms: "
              f"loss {loss1:.6f} vs "
              f"{ref_loss:.6f}, |diff| / |update| {rel:.3e}; on {gpu}")

        # (b) gloo worlds on this card ---------------------------------
        t0 = time.perf_counter()
        mix = staggered_mix(SERVING["vocab"])
        serve = spawn_world(_serve_world, 2, ckpt, mix)
        serve_s = time.perf_counter() - t0
        for rank, r in enumerate(serve):
            assert r["heads"] == (2, 2), r["heads"]
            assert r["generate_b2"] == SERVING["blocks"], r["generate_b2"]
            assert np.array_equal(r["tokens"], serve[0]["tokens"]), rank
            m = r["mix"]
            assert m["b7"] == m["blocks"] * m["dispatches"], m
            assert m["free"][0] == m["free"][1], m
            assert r["chunk_refusal"] and "cannot be captured" in \
                r["chunk_refusal"], r["chunk_refusal"]
            for case in r["sp"]:
                # a ring forward launches B2 once a step, the gather once
                assert case["b2"] == (2 if case["impl"] == "ring" else 1), \
                    case
            assert r["matmul"]["launches"] == 1, r["matmul"]
            totals["forward"] += r["generate_b2"] + sum(
                c["b2"] for c in r["sp"])
            totals["dq"] += sum(c["dq"] for c in r["sp"])
            totals["dkv"] += sum(c["dkv"] for c in r["sp"])
            totals["b7"] += m["b7"]
            totals["b1"] += r["matmul"]["launches"]
        r0 = serve[0]
        gen_tps = BATCH * NEW / r0["generate_s"]
        print(f"path (m) (b) tensor-parallel (1, 2) over gloo on one card: "
              f"generate {BATCH}x{PROMPT} -> {NEW} {gen_tps:.1f} tokens/s "
              f"(solo {BATCH * NEW / solo_s:.1f} tokens/s), B2 "
              f"{r0['generate_b2']} launches a rank at 2 local heads, "
              f"{r0['generate_staged'] / 2**20:.2f} MiB staged a rank; "
              f"parts from solo at {r0['parted']}; on {gpu}")
        m = r0["mix"]
        print(f"path (m) (b) batcher (decode_chunk 1) under path (e)'s mix: "
              f"{m['secs']:.2f} s, B7 {m['b7']} launches a rank = "
              f"{m['blocks']} blocks x {m['dispatches']} dispatches, "
              f"preemptions {m['preemptions']}, parts from solo at "
              f"{r0['mix_parted']}; decode_chunk 32 refused "
              f"({r0['chunk_refusal'][:60]}...); on {gpu}")
        for case in r0["sp"]:
            print(f"path (m) (b) sequence-parallel {case['impl']} window "
                  f"{case['window']} {list(SP_SHAPE)} over 2 ranks: B2 "
                  f"{case['b2']} a rank a forward, dq {case['dq']}, dkv "
                  f"{case['dkv']}; out err {case['out_err']:.3e}, grad err "
                  f"{case['grad_err']:.3e}")
        print(f"path (m) (b) scheduled matmul {MESH_MATMUL_N}^3 row shard a "
              f"rank: B1 launches {r0['matmul']['launches']} a rank, max err "
              f"{r0['matmul']['err']:.3e}; world of 2 took {serve_s:.1f} s")

        t0 = time.perf_counter()
        two = spawn_world(_train_world, 2, ckpt, ref_ckpt,
                          MESH_TRAIN[:2], False)
        four = spawn_world(_train_world, 4, ckpt, ref_ckpt,
                           MESH_TRAIN[2:], True)
        train_s = time.perf_counter() - t0
        heads = [cases.pop() for cases, _ in two]
        for world_res in (two, four):
            for rank, (cases, _) in enumerate(world_res):
                for case in cases:
                    np.testing.assert_allclose(case["loss"], ref_loss,
                                               **TRAIN_LOSS)
                    assert case["rel"] <= TRAIN_UPDATE_RTOL, case
                    assert case["launches"] == {
                        k: SERVING["blocks"] for k in ("forward", "dq",
                                                       "dkv")}, case
                    for kind in ("forward", "dq", "dkv"):
                        totals[kind] += case["launches"][kind]
                    dp, lay = case["mesh"][0], case["layouts"]
                    # the data axis partitions the step, and the options
                    # split the state over it
                    assert (case["stats"].get("dp-sharded-kernels", 0) > 0
                            ) == (dp > 1), case
                    if "zero" in case["options"]:
                        assert lay["data_caches"] > 0, case
                    if "fsdp" in case["options"]:
                        assert lay["data_params"] > 0, case
                    if "offload_opt_state" in case["options"]:
                        assert lay["host_caches"] == lay["caches"], case
        for case in two[0][0] + four[0][0]:
            stats = case["stats"]
            print(f"path (m) (b) train step on mesh {case['mesh']} with "
                  f"{'+'.join(case['options'])}: {case['ms']:.1f} ms warm "
                  f"({case['first_ms']:.1f} ms first; one device "
                  f"{single_ms:.1f} ms); staged a rank: the first step "
                  f"{case['staged'] / 2**20:.1f} MiB in {case['calls']} "
                  f"collectives, the warm one "
                  f"{case['warm_staged'] / 2**20:.1f} MiB in "
                  f"{case['warm_calls']}; "
                  f"{stats.get('dp-sharded-kernels', 0)} kernels on the "
                  f"rank's rows; state split over data / in host memory: "
                  f"{case['layouts']}; loss "
                  f"{case['loss']:.6f} vs {ref_loss:.6f}, |diff| / |update| "
                  f"{case['rel']:.3e}; on {gpu}")
        for head in heads:
            launches, stats, solo = head["launches"], head["stats"], \
                head["solo"]
            np.testing.assert_allclose(head["loss"], head["ref_loss"],
                                       **TRAIN_LOSS)
            assert head["rel"] <= TRAIN_UPDATE_RTOL, head
            assert launches == {
                "mapreduce": stats.get("mapreduce", 0),
                "rowchain": stats.get("rowchain", 0),
                "matmul": stats.get("matmul", 0)
                + stats.get("matmul-fused", 0)}, head
            # the fusion plans hold on the rank's rows as on one device
            assert stats.get("rowchain", 0) == solo.get("rowchain", 0) \
                >= 1, head
            assert stats.get("dp-sharded-kernels", 0) > 0, head
            totals["b5"] += launches["mapreduce"]
            totals["b6"] += launches["rowchain"]
            totals["b1"] += launches["matmul"]
        head = heads[0]
        print(f"path (m) (b) path (d)'s head [{HEAD['rows']},{HEAD['dim']}]"
              f" -> {HEAD['vocab']} train step on mesh (2, 1): launches a "
              f"rank {head['launches']}, "
              f"{head['stats'].get('dp-sharded-kernels', 0)} kernels on the "
              f"rank's rows, lowering {head['stats']}; {head['ms']:.2f} ms "
              f"a step against {head['one_ms']:.2f} ms on one device "
              f"(mean of {TIMED_STEPS} warm steps each, both ranks on the "
              f"card at once); loss {head['loss']:.6f} vs "
              f"{head['ref_loss']:.6f}, |diff| / |update| "
              f"{head['rel']:.3e}; on {gpu}")

        # the 2 x 2 world's sharded checkpoint on this world of one
        probs = four[0][1]
        back = load_model(ckpt, device="cuda")
        load_sharded(ckpt + ".sharded", back, mesh=mesh1)
        again = back.call("predict", {"tokens": first["tokens"][:2]})
        np.testing.assert_allclose(again, probs, **PREDICT)
        print(f"path (m) (b) save_sharded from the 2 x 2 world, load_sharded "
              f"on a world of 1: predict max |err| "
              f"{float(np.abs(again - probs).max()):.3e}; the training "
              f"worlds took {train_s:.1f} s")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
        import shutil

        shutil.rmtree(ckpt + ".sharded", ignore_errors=True)
        for path in (ckpt, ref_ckpt):
            Path(path).unlink(missing_ok=True)
    return totals


# --- the cost model on the card (phase 22) -------------------------------

def calibrate_module():
    """scripts/calibrate_torch.py of this checkout, as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / "calibrate_torch.py"
    spec = importlib.util.spec_from_file_location("calibrate_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ran(ex, i) -> bool:
    """Whether kernel ``i`` of an executor runs through its own lowering
    (not folded into B1's epilogue or a row chain, not an extern)."""
    low = ex._lowerings.get(i)
    return (low is not None and i not in ex._skip_kernels
            and i not in ex.fused and i not in ex.row_fused
            and low.kernel.extern is None and low._bounds_ok)


def routed(egt, name, graph, target, args, tol, dtype="float32") -> dict:
    """One program under schedule_mode="auto" and "force", each a fresh
    executor on the same device tensors: the decisions, the launches
    against them, the outputs against each other and the two times."""
    from exprgrad_torch.backend.executor import TorchExecutor
    from exprgrad_torch.model import matmul_precision
    from exprgrad_torch.ops import attention, mapreduce, matmul, rowchain
    from exprgrad_torch.passes import infer_shapes

    base = egt.compile(graph, seed=0, schedule_mode="force", device="cuda")
    prog = base.program
    if dtype == "bfloat16":  # the compiled program in bfloat16
        prog = prog.copy()
        prog.scalar_type = egt.ir.ScalarType.BF16
    tdt = getattr(torch, dtype)
    shapes = infer_shapes(prog, target, base._input_shapes(args))
    tensors = {prog.inputs[n]: torch.from_numpy(v).to(base.device, tdt)
               for n, v in args.items()}
    tensors.update({t: p.to(tdt) for t, p in base.params.items()})
    out_tid = prog.targets[target].output
    counters = {"B1": matmul, "B2": attention, "B5": mapreduce,
                "B6": rowchain}
    runs = {}
    for mode in ("auto", "force"):
        ex = TorchExecutor(prog, target, shapes, base.device,
                           schedule_mode=mode)
        for c in counters.values():
            c.launches = 0
        with warnings.catch_warnings(record=True) as caught, \
                matmul_precision(base.precision):
            warnings.simplefilter("always")
            out = ex.run(dict(tensors), shapes, 1, 0)[out_tid]
            torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        runs[mode] = dict(ex=ex, out=out, launches=launches, ms=[],
                          warned=[str(w.message) for w in caught
                                  if issubclass(w.category,
                                                egt.ScheduleWarning)])
    # the two in turns, each turn's first side alternating; the medians
    with matmul_precision(base.precision):
        for turn in range(4):
            for mode in (("auto", "force") if turn % 2 == 0
                         else ("force", "auto")):
                ex = runs[mode]["ex"]
                runs[mode]["ms"].append(cuda_ms(
                    lambda: ex.run(dict(tensors), shapes, 1, 0),
                    iters=10, warmup=2))
    for run in runs.values():
        run["ms"] = float(np.median(run["ms"]))
    ex, fex = runs["auto"]["ex"], runs["force"]["ex"]
    pol = ex.policy
    lines = []
    for i, (sm, chain) in sorted(fex.fused.items()):
        d = fex._lowering(i).contraction_decision(sm, pol, len(chain.steps))
        lines.append(f"B1 {fex._lowering(i)._kernel_desc()} "
                     f"{sm.m}x{sm.n}x{sm.k} (with its epilogue): "
                     f"{'kernel' if d.use_pallas else 'plain'}, {d.reason}")
        assert (i in ex.fused) == d.use_pallas, (name, i, d)
    for i, chain in sorted(fex.row_fused.items()):
        d = pol.rowchain(chain.operand_bytes, chain.out_bytes,
                         len(chain.members))
        lines.append(f"B6 chain at {chain.members[0].low._kernel_desc()} "
                     f"({len(chain.members)} members, "
                     f"{chain.operand_bytes} + {chain.out_bytes} bytes): "
                     f"{'kernel' if d.use_pallas else 'plain'}, {d.reason}")
        assert (i in ex.row_fused) == d.use_pallas, (name, i, d)
    away = 0
    for i in sorted(ex._lowerings):
        if not _ran(ex, i):
            continue
        low = ex._lowerings[i]
        route, reason = low.scheduled_decision()
        if route is None and reason is None:
            continue
        sm = low.scheduled_matmul()
        b1 = not low._general_only() and sm.ok
        if reason is None or reason.startswith("cost model"):
            # the model's decision: kept (no fallback reason) or routed away
            mr = low.scheduled_mapreduce()
            reason = (low.contraction_decision(sm, pol) if b1 else
                      pol.mapreduce(mr.total_bytes, mr.gather_work * 4)
                      ).reason
            away += route is None
        lines.append(f"{'B1' if b1 else 'B5'} {low._kernel_desc()}: "
                     f"{route or 'plain'}, {reason}")
    for i, low in sorted(ex._lowerings.items()):
        ext = low.kernel.extern
        if ext is not None and ext.name == "attention":
            q, k = (low.shapes[t] for t in ext.inputs[:2])
            d = pol.attention(q[0], q[1], q[2], k[2], q[3])
            lines.append(f"B2 attention {q} x {k}: "
                         f"{'flash' if d.use_pallas else 'plain'}, "
                         f"{d.reason}")
            break
    gens = ex.generated_kernels()
    want = {"B1": len(ex.fused) + sum(
                _ran(ex, i) and ex._lowerings[i].scheduled_route()
                == "matmul" for i in ex._lowerings),
            "B2": ex.stats.get("attention-impl:flash", 0),
            "B5": sum(g.startswith("B5 ") for g in gens),
            "B6": sum(g.startswith("B6 ") for g in gens)}
    got = runs["auto"]["launches"]
    stats = ex.stats
    cost_warned = sum("cost model" in w for w in runs["auto"]["warned"])
    err = assert_same(f"phase 22 {name}", runs["auto"]["out"].float().cpu(),
                      runs["force"]["out"].float().cpu(), tol)
    print(f"cost model, {name}:")
    for line in lines:
        print(f"  {line}")
    print(f"  auto: launches {got}, stats {stats}, {cost_warned} "
          f"ScheduleWarning(s) naming the cost model; force: launches "
          f"{runs['force']['launches']}; auto vs force max |err| "
          f"{err:.3e}; a call {runs['auto']['ms']:.4f} ms auto, "
          f"{runs['force']['ms']:.4f} ms force (CUDA events) on {gpu_line()}")
    assert got == want, (name, got, want)
    assert cost_warned == away, (name, cost_warned, away)
    assert stats.get("schedule-fallback", 0) >= away, (name, stats, away)
    return {"launches": got, "auto_ms": runs["auto"]["ms"],
            "force_ms": runs["force"]["ms"], "away": away, "err": err}


def phase_cost_model(egt, gpu) -> dict:
    """Phase 22: the loaded constants, a short calibration beside them,
    then the paths' programs under auto against force."""
    from exprgrad_torch.backend import policy
    from exprgrad_torch.models import flash_transformer

    constants = policy._load_constants()
    print(f"cost model: constants measured on {constants['card']} "
          f"(calibrated: {constants['calibrated']}), this card {gpu}: "
          f"{ {k: round(v, 4) for k, v in constants.items() if k in policy._DEFAULTS} }")
    calib = calibrate_module()
    fresh = calib.calibrate(reps=3, quick=True)
    print(calib.table(fresh))
    for key in sorted(policy._DEFAULTS):
        print(f"cost model constant {key}: fresh {fresh['constants'][key]:.6g}"
              f", committed {constants[key]:.6g}")

    rng = np.random.default_rng(22)

    def mats(n):
        return {"a": rng.standard_normal((n, n), dtype=np.float32),
                "b": rng.standard_normal((n, n), dtype=np.float32)}

    out = {}
    out["path (a) 4096^3 float32"] = routed(
        egt, "path (a) 4096^3 float32", matmul_graph(egt, MATMUL_TILE), "c",
        mats(MATMUL_N), matmul_f32_tol(MATMUL_N))
    out["1024^3 bfloat16"] = routed(
        egt, "1024^3 bfloat16", matmul_graph(egt, MATMUL_TILE), "c",
        mats(BLOCK_BF16_N), MATMUL_BF16_OUT, dtype="bfloat16")
    out["path (a) 4096^3 bfloat16"] = routed(
        egt, "path (a) 4096^3 bfloat16", matmul_graph(egt, MATMUL_TILE),
        "c", mats(MATMUL_N), MATMUL_BF16_OUT, dtype="bfloat16")
    out["path (b) MLP predict"] = routed(
        egt, "path (b) MLP predict", scheduled_mlp(egt, **MLP), "predict",
        {"v": rng.standard_normal((MLP_ROWS, MLP["dim"]), dtype=np.float32)},
        matmul_f32_tol(MLP["hidden"]))
    for name, graph, target, args, _ in path_c_programs(egt)[:2]:
        tol = SOFTMAX_TOL if name.startswith("softmax") else GEN_SCATTER
        out[f"path (c) {name}"] = routed(egt, f"path (c) {name}", graph,
                                         target, args, tol)
    out["path (d) head predict"] = routed(
        egt, "path (d) head predict",
        transformer_head(egt, HEAD["dim"], HEAD["vocab"]), "predict",
        {"x": rng.standard_normal((HEAD["rows"], HEAD["dim"]),
                                  dtype=np.float32)}, PREDICT)
    tokens = rng.integers(0, SERVING["vocab"], (BATCH, SEQ)).astype(
        np.float32)
    out["serving predict"] = routed(
        egt, "serving predict", flash_transformer(**SERVING), "predict",
        {"tokens": tokens}, PREDICT)
    assert out["serving predict"]["launches"]["B2"] == 2, out
    launches = {k: sum(r["launches"][k] for r in out.values())
                for k in ("B1", "B2", "B5", "B6")}
    print(f"cost model: under auto {sum(r['away'] for r in out.values())} "
          f"kernel(s) routed away by the cost model; launches {launches}")
    return {"programs": out, "launches": launches,
            "constants": {k: constants[k] for k in policy._DEFAULTS},
            "fresh": fresh["constants"]}


# --- Mamba-1 kernels and a hybrid through the batcher (phase 23) ---------
# AI21-Jamba2-Mini's mixer widths: d_inner 8192, d_state 16, d_conv 4
MAMBA_D, MAMBA_N, MAMBA_K = 8192, 16, 4


def mamba_cost(kind: str, lengths, t: int, d: int = MAMBA_D,
               n: int = MAMBA_N, k: int = MAMBA_K) -> tuple:
    """(operations, bytes) of one conv or scan launch over rows of
    ``lengths`` padded to ``t`` (portbench/flops_hybrid.py's rule: each
    input read once, each output written once, each live row's state
    read and written once)."""
    tokens = sum(int(x) for x in lengths)
    live = sum(int(x) > 0 for x in lengths)
    out = 4 * d * len(lengths) * t
    if kind == "conv":
        return (tokens * d * (2 * k + 4),
                4 * d * (tokens + k + 1) + 2 * 4 * d * (k - 1) * live + out)
    return (tokens * d * (7 * n + 10),
            4 * (3 * d + 2 * n) * tokens + 4 * d * (n + 2)
            + 2 * 4 * d * n * live + out)


def phase_mamba(egt, gpu) -> dict:
    """Phase 23: the conv and scan kernels (csrc/selective_scan.cu)
    against their plain twins at Jamba2-Mini's widths (ragged prefill
    rows of a padded bucket, strided x and z, a decode step with parked
    rows; outputs and states, padding leaving states as they were), each
    timed beside its bound; then a toy hybrid (models.jamba.jamba_lm)
    through ContinuousBatcher(paged, flash, decode_chunk 4) on the card,
    whose float32-cache greedy streams equal the solo server's but at
    near-ties and whose kernels launch once a Mamba layer a step, eager
    or replayed in a chunk graph."""
    from exprgrad_torch.models import ContinuousBatcher, FlashLMServer
    from exprgrad_torch.models.jamba import jamba_lm
    from exprgrad_torch.ops import mamba

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    d, n, k = MAMBA_D, MAMBA_N, MAMBA_K

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    w, bias = rand(d, k, scale=0.5), rand(d, scale=0.1)
    a_log = torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32)
                      ).repeat(d, 1)
    dskip, dt_bias = torch.ones(d, device=dev), rand(d, scale=0.5) - 4.0
    errs, res = {}, {}

    def case(name, b, t, lengths):
        xz = rand(b, t, 2 * d)
        x, z = xz[..., :d], xz[..., d:]
        dt, bm, cm = rand(b, t, d, scale=0.5), rand(b, t, n), rand(b, t, n)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        first = mamba.MambaState(rand(b, d, k - 1), rand(b, d, n, scale=0.1))
        states = [first, mamba.MambaState(*(v.clone() for v in first))]
        before = [v.clone() for v in first]
        outs = []
        for st, conv, scan in (
                (states[0], mamba.causal_conv, mamba.selective_scan),
                (states[1], mamba.causal_conv_plain,
                 mamba.selective_scan_plain)):
            xc = conv(x, w, bias, st.conv, lens)
            outs.append((xc, scan(xc, dt, z, bm, cm, a_log, dskip, dt_bias,
                                  st.ssm, lens)))
        torch.cuda.synchronize()
        err = max(float((a - b_).abs().max()) for a, b_ in
                  zip(outs[0] + tuple(states[0]), outs[1] + tuple(states[1])))
        scale = max(float(v.abs().max()) for v in outs[1] + tuple(states[1]))
        assert err <= 1e-4 * max(scale, 1.0), (name, err, scale)
        for i, length in enumerate(lengths):
            assert float(outs[0][1][i, length:].abs().sum()) == 0
            if length == 0:  # a parked row keeps its state bit for bit
                for now, was in zip(states[0], before):
                    assert torch.equal(now[i], was[i]), name
        errs[name] = err
        print(f"phase 23 {name}: b {b} t {t} lengths {lengths[:4]}.. max "
              f"abs err {err:.3g} (largest value {scale:.3g})")
        return x, z, dt, bm, cm, lens, states[0]

    case("prefill ragged", 2, 300, [300, 137])
    case("decode parked rows", 32, 1, [1, 0] * 16)
    res["max_abs_err"] = max(errs.values())

    # time each kernel at the cell's shapes: a 1024-token prompt, and a
    # decode step of 32 slots
    times = {}
    for what, b, t, lengths in (("prefill", 1, 1024, [1024]),
                                ("decode", 32, 1, [1] * 32)):
        x, z, dt, bm, cm, lens, st = case(f"{what} timed", b, t, lengths)
        xc = mamba.causal_conv(x, w, bias, st.conv, lens)
        twins = {"conv": lambda: mamba.causal_conv_plain(x, w, bias,
                                                         st.conv, lens),
                 "scan": lambda: mamba.selective_scan_plain(
                     xc, dt, z, bm, cm, a_log, dskip, dt_bias, st.ssm,
                     lens)}
        for kind, fn in (
                ("conv", lambda: mamba.causal_conv(x, w, bias, st.conv,
                                                   lens)),
                ("scan", lambda: mamba.selective_scan(
                    xc, dt, z, bm, cm, a_log, dskip, dt_bias, st.ssm,
                    lens))):
            ms = cuda_ms(fn, iters=20, warmup=3)
            plain = cuda_ms(twins[kind], iters=2, warmup=1)
            ops, nbytes = mamba_cost(kind, lengths, t)
            least = bound(ops, nbytes)
            times[f"{kind} {what}"] = {"ms": ms, "plain_ms": plain,
                                       "bound_ms": least[0],
                                       "bound_by": least[1]}
            print(f"phase 23 {kind} kernel {what} [{b}, {t}, {d}]: {ms:.4f} "
                  f"ms, bound {least[0]:.4f} ms ({least[1]}), "
                  f"{100 * least[0] / ms:.1f}% of it; the plain twin "
                  f"{plain:.3f} ms; on {gpu}")
    res["times"] = times

    # a toy hybrid through the batcher's graph path
    model = egt.compile(jamba_lm(vocab=97, dim=64, heads=4, kv_heads=2,
                                 hidden=96, layers=8, n_experts=4,
                                 d_state=16, d_conv=4, dt_rank=8,
                                 max_seq=96), seed=0, device="cuda")
    srv = FlashLMServer(model, cache_dtype=torch.float32)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 97, int(m)).astype(np.float32)
               for m in rng.integers(3, 40, 10)]
    b = ContinuousBatcher(srv, slots=4, capacity=96, paged=True,
                          page_size=8, pool_pages=40, attention="flash",
                          decode_chunk=4)
    rids = [b.submit(p, 12) for p in prompts]
    # the steps run eagerly (prefills, each graph's warm-up step), apart
    # from those a chunk graph captured and replays
    eager = [0]
    step = srv._step

    def counted(*args, **kw):
        if not torch.cuda.is_current_stream_capturing():
            eager[0] += 1
        return step(*args, **kw)

    srv._step = counted
    mamba.scan_launches = mamba.conv_launches = 0
    done = b.run()
    scans, convs = mamba.scan_launches, mamba.conv_launches
    srv._step = step
    replays = sum(g.replays for g in b.chunk_graphs.values())
    layers = srv.mixers.count("mamba")
    steps = eager[0] + replays * b.decode_chunk
    # each Mamba layer launches one conv and one scan a step
    assert replays > 0 and scans == convs == layers * steps, (
        scans, convs, layers, eager[0], replays, b.stats)
    same = sum(np.array_equal(done[r], srv.generate(p[None], n_new=12)[0]
                              .cpu().numpy().astype(np.int64))
               for r, p in zip(rids, prompts))
    assert same >= len(prompts) - 1, (same, len(prompts))
    print(f"phase 23 toy hybrid: {same} of {len(prompts)} greedy streams "
          f"equal the solo server's; {eager[0]} eager steps and {replays} "
          f"graph replays of {b.decode_chunk} steps; {scans} scan and "
          f"{convs} conv launches, {layers} a step; stats {b.stats}")
    res["launches"], res["conv_launches"] = scans, convs
    return res


def phase_skinny(egt, gpu) -> dict:
    """Phase 24: the weight-streaming kernel (csrc/gemm_skinny_sm90.cu)
    under a toy dense model's continuous batcher on the card (paged,
    flash, decode_chunk 4: every decode step inside a chunk graph's
    replays).  Every decode weight product runs on the kernel (15 a step:
    q, k, v, o and the SwiGLU's three in each of 2 blocks, and the head;
    the prompts' prefills are wider than 32 rows and stay on
    torch.matmul), none is declined, and the greedy float32-cache
    streams equal the same batcher's eager run on the CPU but at
    near-ties.  Then the kernel alone at each of ``DECODE_GEMMS`` at 1,
    23 and 32 rows (fewer rows than the tile's 32 are read as zeros):
    within rtol = atol = 1e-5 of float64 (``weight_product_plain``), the
    same bits twice, one launch a call and none declined; the kernels
    row's ``tol_share`` gives each product's largest error as a share of
    that tolerance.  Last, Mistral-7B's w1 [4096, 14336] at 32 rows
    timed beside torch.matmul and the bound."""
    from exprgrad_torch.models import ContinuousBatcher, FlashLMServer
    from exprgrad_torch.ops import matmul

    graph = egt.models.flash_transformer(
        vocab=384, dim=256, heads=2, kv_heads=1, hidden=512, blocks=2,
        max_seq=160, rope=True, ffn="swiglu")
    card = egt.compile(graph, seed=24, device="cuda")
    host = {t: v.cpu().numpy() for t, v in card.params.items()}
    cpu = egt.from_state(graph, host, {t: v.cpu().numpy() for t, v in
                                       card.caches.items()}, card.epoch,
                         device="cpu")
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, 384, int(m)).astype(np.float32)
               for m in rng.integers(33, 90, 10)]
    kw = dict(slots=8, capacity=160, paged=True, page_size=16,
              pool_pages=80, attention="flash", decode_chunk=4)
    streams = {}
    for where, model in (("cuda", card), ("cpu", cpu)):
        srv = FlashLMServer(model, cache_dtype=torch.float32)
        b = ContinuousBatcher(srv, **kw)
        rids = [b.submit(q, 24) for q in prompts]
        done = b.run()
        streams[where] = [np.asarray(done[r]) for r in rids]
        if where == "cuda":
            torch.cuda.synchronize()
            stats = b.stats
            replays = sum(g.replays for g in b.chunk_graphs.values())
            graphs = len(b.chunk_graphs)
        else:
            cpu_srv = srv
    steps = replays * kw["decode_chunk"] + graphs  # a warm-up step a graph
    assert replays > 0 and stats["skinny_declined"] == 0, stats
    assert stats["skinny_launches"] == 15 * steps, (stats, replays, graphs)
    parted = _parted_at_near_ties(cpu_srv, prompts, streams["cpu"],
                                  streams["cuda"], "phase 24")
    print(f"phase 24 toy batcher: {len(prompts) - len(parted)} of "
          f"{len(prompts)} greedy streams equal the CPU's; {replays} "
          f"replays of {kw['decode_chunk']} steps and {graphs} warm-up "
          f"steps, {stats['skinny_launches']} kernel launches (15 a step),"
          f" {stats['skinny_declined']} declined")

    # the kernel alone at every decode product of the chat cells
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    shapes, err, w1 = {}, 0.0, None
    for label, xs, ws, spec, *_ in DECODE_GEMMS:
        w = decode_weight(ws, dev, gen)
        worst = 0.0
        for m in (1, 23, 32):
            x = torch.randn(decode_x_shape(xs, m), device=dev, generator=gen)
            launches, declined = matmul.skinny_launches, matmul.skinny_declined
            got = matmul.weight_product(x, w, spec)
            again = matmul.weight_product(x, w, spec)
            torch.cuda.synchronize()
            assert (matmul.skinny_launches - launches,
                    matmul.skinny_declined) == (2, declined), (label, m)
            assert torch.equal(got, again), (label, m)
            want = matmul.weight_product_plain(x.double(), w, spec)
            torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                       atol=1e-5, msg=f"{label} m {m}")
            diff = (got.double() - want).abs()
            err = max(err, float(diff.max()))
            worst = max(worst, float((diff / (1e-5 + 1e-5 * want.abs()))
                                     .max()))
            del got, again, want, diff
        shapes[label] = worst
        print(f"phase 24 weight_product {label} ({spec or 'matmul'} "
              f"{list(decode_x_shape(xs, 32))} x {list(ws)}) at 1, 23 and "
              f"32 rows: the same bits twice, largest error {worst:.3f} of "
              f"rtol = atol = 1e-5")
        if label == "mistral w1/w3":
            w1 = w
        del w, x
        torch.cuda.empty_cache()

    # timed at Mistral-7B's w1, 32 rows
    x = torch.randn(32, 1, 4096, device=dev, generator=gen)
    ms = cuda_ms(lambda: matmul.weight_product(x, w1), iters=20, warmup=3)
    library = cuda_ms(lambda: x @ w1, iters=20, warmup=3)
    plain = cuda_ms(lambda: matmul.weight_product_plain(x, w1), iters=2,
                    warmup=1)
    least = bound(2 * 32 * 4096 * 14336, 4 * (4096 * 14336 + 32 * 4096
                                              + 32 * 14336), **SPLIT_TF32)
    print(f"phase 24 weight_product [32, 4096] x [4096, 14336]: {ms:.4f} "
          f"ms, bound {least[0]:.4f} ms ({least[1]}), "
          f"{100 * least[0] / ms:.1f}% of it; torch.matmul {library:.4f} "
          f"ms, the plain twin {plain:.3f} ms; max abs err over the "
          f"{len(DECODE_GEMMS)} products {err:.3g}; on {gpu}")
    return {"launches": stats["skinny_launches"], "max_abs_err": err,
            "shapes": shapes, "ms": ms, "plain_ms": plain,
            "library_ms": library, "bound": least, "parted": len(parted)}


def phase_done(name, since) -> float:
    """Print a phase's seconds; returns the time it ended."""
    now = time.perf_counter()
    print(f"phase {name}: {now - since:.1f} s")
    return now


def main() -> int:
    faulthandler.enable()  # a crash in native code prints the Python stack
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import exprgrad_torch as egt
    from exprgrad_torch.io import load_model, save_model
    from exprgrad_torch.models import FlashLMServer, flash_transformer
    import exprgrad_torch.layers  # noqa: F401  (egt.layers in builders)
    from exprgrad_torch.ops import attention, matmul
    from exprgrad_torch.utils import kernels, launcher, triton_build

    gpu = gpu_line()
    dev = torch.device("cuda")
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    # the generated kernels' launcher (csrc/launch.cpp, the host compiler)
    # builds beside the nvcc compiles
    def timed(fn):
        t = time.perf_counter()
        return fn(), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        built = pool.submit(timed, kernels.load_launcher)
        kernels.load()
        launcher_path, launcher_s = built.result()
    launcher.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{kernels.library_path()} (host of {gpu}); nvcc seconds by "
          f"file {kernels.compile_seconds}; the launcher {launcher_path} "
          f"in {launcher_s:.1f} s")
    if kernels.build_log.strip():
        print(kernels.build_log.strip())

    t_phase = phase_done("1 (build)", t0)

    # 2. kernel against its plain version -------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = flash_cases(gen, dev)
    slice_err = check_flash_forward(attention, cases)
    q, k, v = cases[0][1]
    fwd_times = time_flash_forward(attention, q, k, v, gpu)
    kernel_ms, plain_ms = fwd_times["kernel"], fwd_times["plain"]
    sdpa_ms = fwd_times["library"]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    # the backward kernels against their plain version, then their times
    bwd_err = check_flash_backward(attention, cases, gen, dev)
    q, k, v = cases[0][1]
    bwd_times = time_flash_backward(attention, q, k, v, gen, dev, gpu)
    (bf16_case,) = (c for c in cases if c[0] == "serving shape bf16 causal")
    time_flash_backward(attention, *bf16_case[1], gen, dev, gpu)
    att_bounds = attention_bounds(*q.shape[:3], q.shape[3])
    print(f"flash bounds {att_bounds} on {gpu}")

    t_phase = phase_done("2 (flash kernels)", t_phase)

    # 3. predict through the compiled model ----------------------------
    graph = flash_transformer(**SERVING)
    model = egt.compile(graph, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SERVING["vocab"], (BATCH, SEQ)).astype(
        np.float32)

    # the main path: one predict call and two generate calls, as a user
    # makes them; the counter must show the kernel ran inside it
    server = FlashLMServer(model)
    prompts = tokens[:, :PROMPT]
    attention.launches = matmul.launches = 0
    t0 = time.perf_counter()
    probs = model.call("predict", {"tokens": tokens})
    first_ms = (time.perf_counter() - t0) * 1e3
    predict_launches = attention.launches
    greedy = server.generate(prompts, n_new=NEW)
    sampled = server.generate(prompts, n_new=NEW, temperature=0.8, top_k=50,
                              seed=0)
    torch.cuda.synchronize()
    launches = attention.launches
    print(f"main path: flash kernel launches {launches} "
          f"({predict_launches} in predict)")
    assert predict_launches == 2, predict_launches
    assert launches == 2, launches

    stats = model.lowering_stats("predict")
    assert stats.get("attention-impl:flash") == 2, stats
    assert probs.shape == (BATCH, SEQ, SERVING["vocab"]), probs.shape
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=0, atol=1e-4)
    for name, out in (("greedy", greedy), ("sampled", sampled)):
        assert out.shape == (BATCH, NEW), (name, out.shape)
        ids = out.cpu().numpy()
        assert np.all((ids >= 0) & (ids < SERVING["vocab"])), name
        assert np.array_equal(ids, np.round(ids)), name

    t0 = time.perf_counter()
    for _ in range(5):
        model.call("predict", {"tokens": tokens})
    predict_ms = (time.perf_counter() - t0) * 1e3 / 5
    print(f"predict [{BATCH},{SEQ}]: {predict_ms:.2f} ms warm, "
          f"{first_ms:.2f} ms first call; lowering {stats} on {gpu}")

    cpu_model = egt.compile(graph, seed=0, device="cpu")
    for tid, value in model.params.items():
        assert torch.equal(value.cpu(), cpu_model.params[tid]), tid
    cpu_probs = cpu_model.call("predict", {"tokens": tokens})
    predict_err = float(np.abs(probs - cpu_probs).max())
    np.testing.assert_allclose(probs, cpu_probs, **PREDICT)
    print(f"predict vs the CPU port: max |err| {predict_err:.3e}")

    # 4. serve -----------------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = server.generate(prompts, n_new=NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    assert torch.equal(again, greedy), "greedy generate is not repeatable"
    print(f"generate {BATCH}x{PROMPT} -> {NEW} greedy (bf16 cache): "
          f"{gen_s:.3f} s, {BATCH * NEW / gen_s:.1f} tokens/s on {gpu}")

    # the server's forward against predict on the same tokens
    server32 = FlashLMServer(model, cache_dtype=torch.float32)
    logits, _ = server32.prefill(tokens, server32.init_caches(BATCH))
    serve_probs = torch.softmax(logits, dim=-1).cpu().numpy()
    np.testing.assert_allclose(serve_probs, probs, rtol=1e-4, atol=1e-5)
    # greedy continuation against re-running predict on the grown window
    few = server32.generate(prompts[:2], n_new=4).cpu().numpy()
    window = prompts[:2].copy()
    for i in range(4):
        nxt = model.call("predict", {"tokens": window})[:, -1].argmax(-1)
        assert np.array_equal(few[:, i], nxt), (i, few[:, i], nxt)
        window = np.concatenate([window, nxt[:, None].astype(np.float32)],
                                axis=1)
    print("serve checks: prefill matches predict, greedy matches predict")

    # a length the TPU kernels' block rule sends to plain attention: on
    # the port "auto" asks the cost model, whose H100 constants choose
    # the kernel here, once per block
    before = attention.launches
    ragged = model.call("predict", {"tokens": tokens[:2, :200]})
    assert attention.launches - before == 2, attention.launches - before
    np.testing.assert_allclose(ragged, probs[:2, :200], **PREDICT)
    print("ragged predict [2,200]: 2 kernel launches, matches predict")

    t_phase = phase_done("3 and 4 (predict, serve)", t_phase)

    # 5. train -------------------------------------------------------------
    data = lm_data(np.random.default_rng(0), SERVING["vocab"], TRAIN_SEQS,
                   SEQ)
    first = {name: value[:BATCH] for name, value in data.items()}
    assert model.epoch == cpu_model.epoch == 0
    # the main path of training: two steps as a user makes them; each runs
    # the forward, dq and dkv kernels once per block
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    matmul.launches = matmul.gemm_launches = 0
    t0 = time.perf_counter()
    for _ in range(2):
        model.epoch += 1
        model.apply("train", first)
    torch.cuda.synchronize()
    first_steps_ms = (time.perf_counter() - t0) * 1e3
    train_launches = {"forward": attention.launches,
                      "dq": attention.dq_launches,
                      "dkv": attention.dkv_launches}
    train_gemm = matmul.gemm_launches
    stats = model.lowering_stats("train")
    print(f"train main path: kernel launches {train_launches} in 2 steps, "
          f"B1's Hopper mainloop {train_gemm} (lowering {stats})")
    assert train_launches == {"forward": 4, "dq": 4, "dkv": 4}, \
        train_launches
    assert stats.get("attention-grad-impl:flash") == 2, stats
    assert stats.get("extern:attention_grad") == 6, stats
    # the FFN's and the head's contractions (2048 x 512 x 2048) are above
    # the size where the cost model takes the kernel
    assert train_gemm > 0 and train_gemm == 2 * stats.get("einsum-b1", 0), (
        train_gemm, stats)

    start = {t: v.clone() for t, v in cpu_model.params.items()}
    t0 = time.perf_counter()
    for _ in range(2):
        cpu_model.epoch += 1
        cpu_model.apply("train", first)
    cpu_steps_s = time.perf_counter() - t0
    loss = float(model.call("loss", first)[0])
    cpu_loss = float(cpu_model.call("loss", first)[0])
    rel, worst = update_err(model.params, cpu_model.params, start)
    print(f"2 train steps (card {first_steps_ms:.1f} ms, CPU "
          f"{cpu_steps_s:.1f} s): loss {loss:.6f} vs CPU {cpu_loss:.6f}; "
          f"parameters vs CPU: |diff| / |update| {rel:.3e}, max |diff| "
          f"{worst:.3e}; on {gpu}")
    np.testing.assert_allclose(loss, cpu_loss, **TRAIN_LOSS)
    assert rel <= TRAIN_UPDATE_RTOL, rel

    losses = [loss]
    for _ in range(TRAIN_EPOCHS):
        losses.append(model.fit("train", data, batch_size=BATCH,
                                log_status=False, monitor="loss"))
    print(f"fit {TRAIN_EPOCHS} epochs of {TRAIN_SEQS // BATCH} batches: "
          f"loss on the first batch {' -> '.join(f'{x:.6f}' for x in losses)}")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

    # one scan_batches epoch against a per-batch epoch from the same state
    state = ({t: v.clone() for t, v in model.params.items()},
             {t: v.clone() for t, v in model.caches.items()},
             model.epoch, model._rng.bit_generator.state)
    model.fit("train", data, batch_size=BATCH, log_status=False)
    per_batch = {t: v.clone() for t, v in model.params.items()}
    params, caches, epoch, rng_state = state
    model.params, model.caches, model.epoch = dict(params), dict(caches), epoch
    model._rng.bit_generator.state = rng_state
    model.fit("train", data, batch_size=BATCH, log_status=False,
              scan_batches=True)
    bitwise = all(torch.equal(model.params[t], v)
                  for t, v in per_batch.items())
    rel, worst = update_err(model.params, per_batch, params)
    print(f"scan epoch vs per-batch epoch: |diff| / |update| {rel:.3e}, "
          f"max |diff| {worst:.3e}, equal bit for bit: {bitwise}")
    assert rel <= TRAIN_UPDATE_RTOL, rel

    # a checkpoint written from the card predicts the same on the CPU
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = kernels.BUILD_DIR / "chip_smoke_checkpoint.egt"
    save_model(model, str(ckpt))
    loaded = load_model(str(ckpt), device="cpu")
    ckpt.unlink()
    assert loaded.epoch == model.epoch, (loaded.epoch, model.epoch)
    trained = model.call("predict", {"tokens": tokens})
    reloaded = loaded.call("predict", {"tokens": tokens})
    ckpt_err = float(np.abs(reloaded - trained).max())
    np.testing.assert_allclose(reloaded, trained, **PREDICT)
    print(f"checkpoint from the card, predict on the CPU: max |err| "
          f"{ckpt_err:.3e}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        model.epoch += 1
        model.apply("train", first)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"train step [{BATCH},{SEQ}]: {step_ms:.2f} ms (mean of "
          f"{TIMED_STEPS} warm steps), {BATCH * SEQ / step_ms * 1e3:.1f} "
          f"training tokens/s on {gpu}")

    t_phase = phase_done("5 (train)", t_phase)

    # 6. the scheduled matmul kernel against its plain version, every
    # block against the default block -----------------------------------
    mm_err = check_matmul_kernel(gen, dev)
    mm_times = time_matmul(gen, dev, MATMUL_N, gpu)
    mm_blocks = time_matmul_blocks(gen, dev, gpu)
    gemm_cases = check_gemm_kernel(gen, dev, gpu)
    gemm_ffn = gemm_cases[CELL_GEMMS[0][0]]

    t_phase = phase_done("6 (matmul kernels)", t_phase)

    # 7. and 8. the scheduled paths, each with the counters at 0 ---------
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    path_a_run = path_a(egt, matmul, gpu)
    path_a_launches = path_a_run["launches"]
    path_b_launches = path_b(egt, matmul, gpu)
    mm_launches = path_a_launches + sum(path_b_launches.values())
    print(f"scheduled paths: matmul kernel launches path (a) "
          f"{path_a_launches}, path (b) {path_b_launches}")

    t_phase = phase_done("7 and 8 (paths (a), (b))", t_phase)

    # 9. the generated kernels against their plain versions ----------------
    gen_err = check_generated_kernels(egt, gpu)
    gen_err["mapreduce"] = max(gen_err["mapreduce"], check_scatter_cases(egt))
    check_launch_path(egt, gpu)
    gen_times = time_generated_kernels(egt, gpu)
    t_phase = phase_done(f"9 (generated kernels; Triton compiled for "
                         f"{triton_build.compile_seconds:.1f} s)", t_phase)

    # 10. and 11. the map/reduce paths, each with the counters at 0 -------
    path_c_launches = path_c(egt, gpu)
    t_phase = phase_done("10 (path (c))", t_phase)
    path_d_launches = path_d(egt, gpu)
    step_kernels = path_d_launches.pop("step_kernels")
    t_phase = phase_done("11 (path (d))", t_phase)
    gen_launches = {
        kind: path_c_launches[kind] + sum(
            run[kind] for run in path_d_launches.values())
        for kind in ("mapreduce", "rowchain")}
    print(f"map/reduce paths: generated kernel launches path (c) "
          f"{path_c_launches}, path (d) {path_d_launches}; Triton compiled "
          f"for {triton_build.compile_seconds:.1f} s in all")

    # 12. paged serving: B7 against its plain version, its times, and
    # path (e) with the counters at 0 ------------------------------------
    paged_err = check_paged_kernel(gen, dev)
    paged_times = {
        "serving": time_paged_kernel(
            gen, dev, gpu, "serving decode step [8,4,1,128], bf16 pool "
            "33x4x32x128", PAGED_SERVING_CASE, PAGED_SERVING_LENS, 33),
        "bench": time_paged_kernel(
            gen, dev, gpu, "bench.py shape [8,8,1,128], bf16 pool "
            "129x8x128x128", PAGED_BENCH_CASE, PAGED_BENCH_LENS,
            PAGED_BENCH_PAGES)}
    path_e_run = path_e(egt, gpu)
    t_phase = phase_done("12 (paged attention, path (e))", t_phase)

    # 13.-15. the reference examples' models, each path with the
    # counters at 0 just before it ------------------------------------
    path_f(egt, gpu)
    t_phase = phase_done("13 (path (f): xor, derivative, fashion-MNIST)",
                         t_phase)
    path_g_run = path_g(egt, attention, gpu)
    t_phase = phase_done("14 (path (g): flash_transformer with experts)",
                         t_phase)
    rnn_models = path_h(egt, gpu)
    t_phase = phase_done("15 (path (h): the recurrent LM)", t_phase)

    # 16. B7 at a verify round's shapes and its time there, then path (i)
    # on phase 5's trained model with the counters at 0 ----------------
    verify_err = check_verify_kernel(gen, dev)
    paged_times["verify"] = time_paged_kernel(
        gen, dev, gpu, f"verify round [8,4,{SPEC_K + 1},128] (spec_k "
        f"{SPEC_K}), bf16 pool 65x4x32x128", PAGED_VERIFY_CASE,
        PAGED_VERIFY_LENS, 65)
    drafts = train_draft(egt, data)
    path_i_run = path_i(egt, model, drafts, gpu)
    t_phase = phase_done("16 (B7 at the verify shapes, path (i): the "
                         "server's other modes and the speculative batcher)",
                         t_phase)

    # 17.-19. encoder-decoder and recurrent serving, the model extras,
    # each path with the counters at 0 just before it ---------------------
    path_j_run = path_j(egt, gpu)
    t_phase = phase_done("17 (path (j): seq2seq train, predict, "
                         "greedy_decode, Seq2SeqServer, Seq2SeqBatcher)",
                         t_phase)
    path_k(egt, rnn_models, gpu)
    t_phase = phase_done("18 (path (k): RecurrentServer)", t_phase)
    q, k, v = cases[0][1]
    extras = phase_extras(egt, model, q, k, v, gpu)
    exported = export_generated(egt, gpu)
    t_phase = phase_done("19 (export_compiled, load_compiled, save_hlo, "
                         "profile)", t_phase)

    # 20. multi-step and pipelined decode, a chunk one CUDA graph replay,
    # with the counters at 0 just before each drive --------------------
    path_l_run = path_l(egt, gpu)
    t_phase = phase_done("20 (path (l): decode_chunk and pipeline as CUDA "
                         "graphs)", t_phase)

    # 21. parallelism on torch.distributed: a world of one NCCL rank here,
    # gloo worlds of 2 and 4 spawned ranks on this card, each drive with
    # the counters at 0 just before it ---------------------------------
    path_m_run = path_m(egt, model, gpu)
    t_phase = phase_done("21 (path (m): tensor-parallel serving and "
                         "batching, sharded training, sequence-parallel "
                         "attention, sharded checkpoints)", t_phase)

    # 22. the cost model on the card: a short calibration, then the
    # paths' programs under schedule_mode="auto" against "force", each
    # with the counters at 0 just before it ---------------------------
    cost_model = phase_cost_model(egt, gpu)
    t_phase = phase_done("22 (the cost model: calibration, auto against "
                         "force)", t_phase)

    # 23. the Mamba kernels, and a hybrid through the batcher's graphs
    mamba_run = phase_mamba(egt, gpu)
    t_phase = phase_done("23 (the Mamba kernels, a hybrid through the "
                         "batcher)", t_phase)

    # 24. the decode step's weight products on the weight-streaming
    # kernel, through a toy batcher's chunk graphs
    skinny_run = phase_skinny(egt, gpu)
    phase_done("24 (the weight-streaming kernel through the batcher)",
               t_phase)
    j_launches = path_j_run["launches"]
    flash_launches = {"forward": launches + path_g_run["launches"]["forward"]
                      + path_i_run["b2"] + j_launches["forward"]
                      + extras["launches"]["B2"] + path_m_run["forward"],
                      "dq": train_launches["dq"]
                      + path_g_run["launches"]["dq"] + j_launches["dq"]
                      + path_m_run["dq"],
                      "dkv": train_launches["dkv"]
                      + path_g_run["launches"]["dkv"] + j_launches["dkv"]
                      + path_m_run["dkv"]}
    mm_launches += (extras["launches"]["B1"] + exported["matmul"]
                    + path_m_run["b1"] + cost_model["launches"]["B1"])
    flash_launches["forward"] += cost_model["launches"]["B2"]
    print(f"path (m) (phase 21) launches, every rank's: {path_m_run}")
    gen_launches["mapreduce"] += (path_m_run["b5"]
                                  + cost_model["launches"]["B5"])
    gen_launches["rowchain"] += (path_m_run["b6"]
                                 + cost_model["launches"]["B6"])
    for kind in ("mapreduce", "rowchain"):
        gen_launches[kind] += exported[kind]
    print(f"exported plans with generated kernels (phase 19): launches "
          f"{exported}; path (l) (phase 20): B7 launches "
          f"{path_l_run['b7']} in {path_l_run['replays']} graph replays")
    print(f"flash kernel launches: serving predict {launches} and train "
          f"{train_launches}, path (g) {path_g_run['launches']}, path (j) "
          f"{j_launches}, exported predict {extras['launches']['B2']}; in "
          f"all {flash_launches}; matmul kernel launches in all "
          f"{mm_launches} (exported path (a) {extras['launches']['B1']})")
    print(f"scaled_dot_product_attention [8,4,256,128] f32 causal runs "
          f"{kernel_names(lambda: sdpa(q, k, v, is_causal=True))}")
    # its backward by device time, which settles the library's figure
    # for dq and dkv without autograd's host work
    sdpa_bwd = device_kernels(sdpa_backward(
        q, k, v, torch.randn(q.shape, generator=gen, device=dev)))
    sdpa_bwd_ms = sum(sdpa_bwd.values())
    print(f"scaled_dot_product_attention backward [8,4,256,128] f32 causal "
          f"runs, device ms per call: {sdpa_bwd}; {sdpa_bwd_ms:.5f} ms in "
          f"all on {gpu}")
    # B5, B6 and B7 by device time: every kernel one call launches (B5's
    # keys, sort and searchsorted, and the segment walk;
    # index_add's clone and kernel; B6 and torch.softmax; B7's splits and
    # merge; the library route's gather and sdpa)
    profiled = {f"B5 {name}": fn for name, fn in
                gen_times["mapreduce"]["profiled"].items()}
    profiled.update(gen_times["rowchain"]["profiled"])
    for shape, res in paged_times.items():
        profiled[f"B7 {shape}"] = res["profiled"]["kernel"]
        profiled[f"B7 library {shape}"] = res["profiled"]["library"]
    device_ms = {}
    for name, fn in profiled.items():
        per_kernel = device_kernels(fn)
        device_ms[name] = sum(per_kernel.values())
        print(f"device ms per call, {name}: {device_ms[name]:.5f} "
              f"({ {k[:60]: round(v, 5) for k, v in per_kernel.items()} }) "
              f"on {gpu}")
    for row in step_kernels:  # path (d)'s step B5 kernels, phase 11
        call, library = row.pop("profiled")
        row["device_ms"] = sum(device_kernels(call).values())
        row["library_device_ms"] = sum(device_kernels(library).values())
        print(f"path (d) step B5 {row['kernel']} {row['shapes']}: CUDA "
              f"events {row['ms']:.5f} ms, device {row['device_ms']:.5f} "
              f"ms, bound {row['bound_ms']:.5f} ms; {row['library']} "
              f"events {row['library_ms']:.5f} ms, device "
              f"{row['library_device_ms']:.5f} ms on {gpu}")
    skew = (device_ms["B5 scatter-add all on one destination"]
            / device_ms["B5 scatter-add uniform"])
    print(f"B5 scatter-add: all indices on one destination takes {skew:.2f}x "
          f"the uniform case's device time")
    print(f"the whole run {time.perf_counter() - t_start:.1f} s")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu"))
    assert not loaded, f"the port imported {loaded}"

    def row(name, source, replaces, launches, err, ms, plain, library,
            bound_of, route="cuda"):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound_of[0], "bound_by": bound_of[1],
                "library_ms": library}

    print(gpu)
    print(json.dumps({"kernels": [
        row("flash_attention_forward", "exprgrad_torch/csrc/flash_fwd.cu",
            "exprgrad_tpu/ops/attention.py:293", flash_launches["forward"],
            slice_err,
            kernel_ms, plain_ms, sdpa_ms, att_bounds["forward"]),
        row("flash_attention_backward_dq", "exprgrad_torch/csrc/flash_bwd.cu",
            "exprgrad_tpu/ops/attention.py:375", flash_launches["dq"],
            bwd_err[0], bwd_times["dq"], bwd_times["plain"], sdpa_bwd_ms,
            att_bounds["dq"]),
        row("flash_attention_backward_dkv",
            "exprgrad_torch/csrc/flash_bwd.cu",
            "exprgrad_tpu/ops/attention.py:444", flash_launches["dkv"],
            bwd_err[1], bwd_times["dkv"], bwd_times["plain"], sdpa_bwd_ms,
            att_bounds["dkv"]),
        dict(row("scheduled_matmul", "exprgrad_torch/csrc/matmul.cuh",
                 "exprgrad_tpu/ops/matmul.py:24", mm_launches, mm_err,
                 mm_times["kernel"], mm_times["plain"], mm_times["library"],
                 mm_times["bound"]),
             blocks={shape: {"ms": res["blocks"],
                             "library_ms": res["library"],
                             "bound_ms": res["bound"][0],
                             "bound_by": res["bound"][1]}
                     for shape, res in mm_blocks.items()},
             path_a={"tile_ms": path_a_run["ms"],
                     "tuned_blocks": path_a_run["blocks"]},
             cost_model={name: {k: r[k] for k in ("launches", "auto_ms",
                                                  "force_ms", "away")}
                         for name, r in cost_model["programs"].items()}),
        dict(row("einsum_gemm", "exprgrad_torch/csrc/gemm_sm90.cu",
                 "exprgrad_tpu/backend/jaxeval.py:222", train_gemm,
                 max(r["max_abs_err"] for r in gemm_cases.values()),
                 gemm_ffn["kernel_ms"], gemm_ffn["plain_ms"],
                 gemm_ffn["library_ms"],
                 (gemm_ffn["bound_ms"], gemm_ffn["bound_by"])),
             shape=CELL_GEMMS[0][0], cases=gemm_cases),
        dict(row("scheduled_mapreduce", "exprgrad_torch/ops/mapreduce.py",
                 "exprgrad_tpu/backend/pallasgen.py:1804", gen_launches[
                     "mapreduce"], max(gen_err["mapreduce"],
                                       gen_times["mapreduce"]["err"]),
                 gen_times["mapreduce"]["kernel"],
                 gen_times["mapreduce"]["plain"],
                 gen_times["mapreduce"]["library"],
                 gen_times["mapreduce"]["bound"], route="triton"),
             head_step=step_kernels),
        row("scheduled_rowchain", "exprgrad_torch/ops/rowchain.py",
            "exprgrad_tpu/backend/pallasgen.py:2375", gen_launches[
                "rowchain"], max(gen_err["rowchain"],
                                 gen_times["rowchain"]["err"]),
            gen_times["rowchain"]["kernel"], gen_times["rowchain"]["plain"],
            gen_times["rowchain"]["library"], gen_times["rowchain"]["bound"],
            route="triton"),
        dict(row("paged_decode_attention",
                 "exprgrad_torch/csrc/paged_attention.cu",
                 "exprgrad_tpu/ops/paged_attention.py:78",
                 path_e_run["launches"] + path_i_run["b7"]
                 + path_l_run["b7"] + path_m_run["b7"],
                 max(paged_err, verify_err, paged_times["bench"]["err"],
                     paged_times["verify"]["err"]),
                 paged_times["bench"]["kernel"],
                 paged_times["bench"]["plain"],
                 paged_times["bench"]["library"],
                 paged_times["bench"]["bound"]),
             verify={"shape": list(PAGED_VERIFY_CASE[:7]),
                     "launches": path_i_run["b7_verify"],
                     "ms": paged_times["verify"]["kernel"],
                     "plain_ms": paged_times["verify"]["plain"],
                     "bound_ms": paged_times["verify"]["bound"][0],
                     "bound_by": paged_times["verify"]["bound"][1],
                     "library_ms": paged_times["verify"]["library"],
                     "device_ms": device_ms["B7 verify"],
                     "library_device_ms": device_ms["B7 library verify"]},
             graph={"replays": path_l_run["replays"],
                    "launches": path_l_run["b7"],
                    "device_ms_per_launch": path_l_run["b7_ms_per_launch"],
                    "busy": path_l_run["busy"]}),
        dict(row("selective_scan", "exprgrad_torch/csrc/selective_scan.cu",
                 "none (no state-space layer in the JAX package)",
                 mamba_run["launches"], mamba_run["max_abs_err"],
                 mamba_run["times"]["scan prefill"]["ms"],
                 mamba_run["times"]["scan prefill"]["plain_ms"], None,
                 (mamba_run["times"]["scan prefill"]["bound_ms"],
                  mamba_run["times"]["scan prefill"]["bound_by"])),
             shapes=mamba_run["times"],
             conv={"launches": mamba_run["conv_launches"],
                   "ms": mamba_run["times"]["conv prefill"]["ms"],
                   "plain_ms": mamba_run["times"]["conv prefill"]["plain_ms"],
                   "bound_ms": mamba_run["times"]["conv prefill"]["bound_ms"],
                   "bound_by": mamba_run["times"]["conv prefill"]["bound_by"]}),
        dict(row("weight_product", "exprgrad_torch/csrc/gemm_skinny_sm90.cu",
                 "none (the serving step's jnp matmuls, left to XLA)",
                 skinny_run["launches"], skinny_run["max_abs_err"],
                 skinny_run["ms"], skinny_run["plain_ms"],
                 skinny_run["library_ms"], skinny_run["bound"]),
             tol_share=skinny_run["shapes"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

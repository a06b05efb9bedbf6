#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; no phase is skipped or
caught).  Every ``Executor.run`` leg goes through the executor's fast
path, as a user's would: a bound entry's first step runs eager, its
second captures the step as one CUDA graph, every later step is one
replay; step times are taken from the third step on.  The windows that
split device time by op or kernel family run a step on the eager path
(``use_program_cache=False``: a replay emits no ranges) and say so
(``"path"``); a replay is profiled for its busy and idle time only:

1. the card: name and power limit (nvidia-smi), TF32 switched off for
   matmuls and convolutions;
2. the kernel build (one nvcc per source, all started together, sm_90a)
   from paddle_tpu_torch/csrc;
3. the paged decode kernel (B4: a split kernel over 256-key splits of a
   slot's pages and a merge kernel) at the decode slice's shapes (8
   slots, 8 heads, head_dim 64, page_size 16, 128 pages a sequence, a
   1025-page pool), float32 and bfloat16 pools, at the slice's kv_lens
   and at the edge lengths (1, ps, a split's size - 1, size and size + 1,
   mp*ps and mp*ps + 5, where the walk stops at the table's width):
   within KERNEL_TOL of its plain version, exact zeros for empty slots,
   non-finite stale tails ignored, and bitwise: two calls, each slot
   alone (S = 1) against its row of the S = 8 call, the pool's pages
   permuted with the tables moved to match.  Then B4's sweep (the slice's
   kv_lens in f32 and bf16, every slot at 2048, lengths in the serving
   run's range, one live slot, Dh 32 at H 16 and Dh 128 at H 4): its
   time by CUDA events, the merge kernel's share of its device time, the
   bound, one SDPA call over K/V gathered beforehand, the plain
   version's time and the host time a call takes to enqueue.  The paged
   prefill kernel (B5) at the same shapes: against its plain version,
   exact zeros, non-finite tails ignored, chunk-split bitwise equal to
   one call, at chunk starts and lengths on and off the kernel's 64-key
   tiles, C = 1 included, with NaN/Inf written past start + C, then its
   time, the plain version's, the bound and SDPA (a 1024-token prompt,
   and the second 512-token chunk of a prompt).  CUDA-event times queue
   a device-side wait before the start event, so they hold no host
   time;
4. the flash attention kernels (forward B1, fused backward B2: a delta
   pre-pass, the fused kernel and the dq sum) at the training slice's
   shape [64, 8, 256, 64], in float32 and bfloat16, on
   strided q/k/v/do views as the Program feeds them, with mixed kv_lens
   (zeros included): against their plain versions (forward out and lse
   <= 2e-5, backward <= 5e-5 absolute in float32; in bfloat16 <= 1e-2 of
   max(1, |value|), since one bf16 rounding grows with the value) for causal
   and not causal, causal T < S and an uneven tail (T = 200); rows with
   kv_lens 0 give zero out and zero, finite gradients; NaN/Inf written
   past kv_lens leaves every output bitwise unchanged; two backward calls
   give the same bits, and so do two forward calls and a forward over
   one sequence alone (batched == unbatched); then each kernel's time
   beside its plain version's, its bound and a
   scaled_dot_product_attention yardstick (its autograd backward for B2);
5. the two-pass flash backward (B3: a delta pre-pass, the dk/dv kernel
   and the dq kernel) on the same cases, f32 and bf16: against its plain
   version (the tiled two-pass translation) and against B2 on the same
   inputs, and B2 against the same plain version, with the backward
   tolerances above; rows with kv_lens 0 give zero gradients, NaN/Inf
   past kv_lens leaves every output bitwise unchanged, two calls give the
   same bits;
6. the backward engine sweep at bench.py's four Transformer shapes
   ([64, 8, 256, 64], [16, 8, 1024, 64], [8, 8, 2048, 64],
   [4, 8, 4096, 64], the last the long leg's), then B*H across the
   ``auto`` rule's former cut: [16..32, 8, 512, 64], [48, 8, 384, 64],
   [24..32, 4, 512, 128], [64, 4, 256, 128], and past it at
   [128, 8, 256, 64] and [64, 8, 256, 32]; float32, causal and full, the
   training feeds' kv_lens.  At each shape the forward, B2 and B3 are
   held against their plain versions (the tolerances above) and B3
   against B2; then B2's and B3's device times (each engine's three
   kernels from a torch.profiler window, B2's dq sum on its own; the
   faster engine is decided on these) and
   CUDA-event times, SDPA's autograd backward as a yardstick, the plain
   versions' and the bound (10*D operations a visible pair), with the
   engine ``auto`` picks; beside them the forward B1's device time (from
   a profiler window), SDPA's forward, B1's plain version and its bound
   (4*D operations a visible pair);
7. serving: the Transformer LM at the documented decode width
   (vocab 32000, 12 layers, 8 heads, d_model 512, d_inner 2048, random
   weights from a seed) through InferenceEngine.generate: 16 concurrent
   greedy requests, prompts of 32-1500 tokens, 64 new tokens each.  Both
   paged kernels' launch counts must move by layers x steps, and a few
   requests must come out bitwise equal from a max_active=1 engine;
   the LM's logits on the card are held against the plain CPU versions
   on a short input; a short profiled window then splits the device
   time by kernel family (B4's two kernels in one) and gives the
   device's idle share and B4's share of the window's wall time;
8. legacy serving: the same LM and prompts through an engine whose model
   has no chunk function (``build_decode_model(..., chunked=False)``), so
   each prompt is prefilled whole by ``lm_prefill`` on the flash forward
   (B1), 32 new tokens each: B1 launched 12 times a prompt, B4 12 times
   a step, B5 not at all; the greedy tokens equal the chunked engine's
   first 32, and three requests are bitwise equal to a max_active=1
   legacy engine; tokens/s, TTFT p50/p95 and peak memory.  Then B1 as
   the legacy prefill calls it at buckets 256, 1024 and 2048 ([1, 8,
   bucket, 64] causal, kv_lens = bucket - 7): against its plain version,
   its CUDA-event time, the plain version's, the bound (4*D operations a
   visible pair), one causal SDPA call and B5 over the same prompt;
9. predict serving: Transformer-base scoring (get_model(use_flash=True)
   pruned to its logits, at the training width: 6+6 layers, d_model 512,
   vocab 30000, 256 tokens, seeded parameters, f32 with TF32 off) saved
   by ``io.save_inference_model(..., aot=True)`` into a temporary
   directory and served by InferenceEngine(model_dir=...) on the card:
   two rows on the Program backend against the port's plain CPU path
   (LOGIT_TOL); the AOT graph (torch.export, B1 inside it as the
   custom op) against the Program at buckets 2, 4, 8 and 16, bitwise; B1
   launched 18 times a dispatch on each backend, no other kernel; the
   all-pad warm-up feed (kv_lens 0) finite at every bucket; each 2-row
   request alone (bucket 2) against the same request coalesced into one
   dispatch at buckets 4, 8 and 16, on each backend, held to
   PREDICT_BATCH_TOL (0); the
   first op whose bits move from bucket 2 to bucket 16 (ROADMAP F-6),
   with one product a mul and with the engine's blocks (256-row blocks,
   at least two, in one batched product a mul); the same AOT-against-
   Program and alone-against-coalesced checks for a model whose samples
   are one row (the Fluid book's MNIST MLP, 784-200-200-10), with the
   one-product engine's difference recorded beside; a hot
   swap to a second seeded version under 4 client threads (every answer
   one version's bits, the new version served after); then the load
   (64 requests of 1-4 rows with their own lengths from 8 clients,
   buckets 2-16, a 2 ms window): requests/s, rows/s, latency p50/p95,
   the bucket histogram, peak memory, the same load on engines with
   and without the blocks in turns (requests/s), a profiled window
   (device busy
   and idle share, B1's share, GEMMs, the device-to-host copy of the
   logits), batch-1 clients with batching on and off, the logits' copy
   to pageable and to pinned memory (``executor.as_numpy``); the Program
   backend's dispatches replay one CUDA graph a bucket (captured at the
   warm-up, none under the load); and B1 at
   [16, 8, 256, 64] (the encoder's and the decoder's causal lengths)
   against its plain version, its bound and one SDPA call;
10. MNIST LeNet (models.mnist.get_model, batch 128, f32, TF32 off): one
   step on the card against the port's CPU path from one set of numpy
   parameters (loss 1e-6 relative, each gradient 1e-5 of its max |g|),
   and the same step with TF32 on, which must exceed those limits; then
   20 steps through Executor.run fed by DataFeeder (every loss finite,
   every parameter moved, the loss falling); step ms, images/s (CUDA-graph
   replays, and LENET_EAGER_STEPS eager steps beside them), peak
   memory, and a profiled step's device busy time and idle share each
   way;
11. op rules on the card: ``mean`` of an int64 input and a float32 cast
   to int32 and uint8 (NaN, +-inf and values past the range) give the
   JAX package's values exactly (ROADMAP F-8, F-9);
12. ResNet-50 (models.resnet.get_model at 224 x 224, 1000 classes, f32,
   TF32 off): one step at batch 2 on the card against the port's CPU
   path from one set of numpy parameters, in float64 at the training
   limits (loss LOSS_RTOL, each gradient GRAD_RTOL of its max |g|, the
   running statistics, the accuracy), and in float32 against the CPU's
   float64 step where no ReLU gate reaches (the loss, fc_0's gradients,
   the running statistics) and over all gradients in L2
   (RESNET_GLOBAL_L2), with a TF32 step that must fail those limits;
   then RESNET_STEPS momentum steps at batch 128 on one seeded batch
   (finite, every parameter moved, the loss falling), step ms, images/s,
   the share of the f32 bound, peak memory, and a profiled step's
   device time by op type and idle share; then the test Program with
   non-trivial statistics folded by InferenceTranspiler (logits within
   RESNET_FOLD_RTOL of the unfolded Program's), saved with ``aot=True``,
   loaded and run, images/s of each; B1-B5 launched not at all;
13. training, card vs CPU: Transformer-base at full width (6+6 layers,
   d_model 512, vocab 30000, dropout 0) from one set of numpy
   parameters: one step's loss (1e-4 relative) and every <param>@GRAD
   (1e-3 of that tensor's max |g|; the few fc units whose ReLU gate opens
   on one side only are found and left out of their own fc's weight and
   bias check, and counted) through Executor.run on the card against the
   port's plain CPU path, twice: batch 2 x 64 with the fused engine (B2
   against the plain backward), then batch 2 x 200 with the pair engine
   on both sides (B3 against its plain version; several tiles and an
   uneven last one); their flash launches are counted apart from the
   main paths' (each step is its engine's main path when ``auto`` runs
   that engine on neither training leg);
14. training: Transformer-base as the JAX package's headline leg
   (bench.py: batch 64 x 256, vocab 30000, dropout 0.1, Adam with noam
   decay, use_flash=True, float32 with TF32 off) through
   Executor.run(startup) and 10 Executor.run(main) steps on seeded token
   feeds whose rows have their own lengths (64-256, pad tails), the
   backward engine left to ``auto``: every loss finite, every parameter
   finite and moved, the forward and the picked backward launched 18
   times a step; step time, target tokens/s, peak memory, the loss
   trajectory, and a profiled step split by kernel family with the
   device's idle share;
15. the executor's fast path (fast_path_phase): Transformer-base at the
   training leg's 64 x 256, dropout 0.1, from one seeded start state,
   FAST_STEPS steps eager and FAST_STEPS graphed: losses, parameters
   and Adam's accumulators bitwise equal, one capture (none over steps
   3-10), B1 and B2 18 launches a step with replays, fetched values
   (numpy, an unread LazyFetch, a return_numpy=False tensor, a scope
   value read as numpy) unchanged by later steps; FAST_CYCLE's batch
   sizes (64, 56, 48 and 40 x 256) in turn through one executor: one
   graph a shape in one shared pool, none evicted, bitwise equal to the
   same steps op by op; nan_guard: finite
   guarded steps (eager, then graphed) equal to unguarded eager steps, a
   NaN parameter set through the scope gives False twice with every
   persistable bitwise unchanged, restored True twice; JitStepCache's
   graphed callable; step ms and tokens/s each way, idle shares,
   capture ms, the graph's pool, peak memory;
16. the Trainer (trainer_phase): Transformer-base at 64 x 256, dropout
   0.1, through ``fluid.Trainer`` (``layers.data`` and
   ``T.transformer(..., use_flash=True)``, Adam with noam decay), the
   reader ``reader.batch(reader.buffered(samples), 64)`` of seeded
   samples: TRAINER_STEPS steps with device prefetch (a side CUDA
   stream) and ``nan_guard``, a checkpoint every TRAINER_CKPT_STEPS
   steps (the newest TRAINER_KEEP kept): losses finite, B1 and B2 18
   launches every step, 1 capture, feed host copies flat from the third
   step on, the serials on disk manifest-intact; a fresh Trainer resumes
   from the serial after step TRAINER_RESUME_AT and trains to
   TRAINER_STEPS without prefetch: losses, parameters, Adam's moments
   and the noam counter bitwise the first run's, 1 capture;
   ``Trainer.test`` on TRAINER_TEST_BATCHES batches (B1 18 a batch, B2
   none); unread steps without and with ``nan_guard`` and without
   prefetch; a rebind after ``load_checkpoint`` (one capture more, the
   pool grown by less than one state); no reader thread left.  Step ms
   and tokens/s beside the fast path's, a replay's idle share, each
   save's seconds and bytes, the validated load's seconds.  Then LeNet
   at batch 128 through the Trainer (lenet_trainer_phase): prefetch on
   and off bitwise (losses and state), images/s each way beside phase
   10's; ``fetch_metrics`` off on odd steps makes a second entry; NaN
   images in two batches under ``nan_guard=2``: the first guarded step
   leaves the state bitwise unchanged, the second rewinds it to the
   checkpoint's bits, one capture more, then finite steps; an
   ``Inferencer`` on the saved parameters against the test Program's
   probabilities; the test Program fed by ``DataFeeder.to_device_reader``
   (no host feed copy); a ``layers.py_reader`` Program trained without
   feeds until ``core.EOFException``, never bound; a ``FailureMonitor``
   with a stale peer: a checkpoint and a stop before the first step;
17. the long-context leg: the same model at bench.py's longest leg
   (batch 4 x 4096, max_length 4096, rows of 64-4096 tokens), 5 steps
   under ``auto``: the same checks, with B1 and the backward ``auto``
   picks launched 18 times a step and the other engine not at all;
18. ResNet-50 in bf16, bench.py's leg (get_model(dtype="bfloat16"),
   224 x 224, 1000 classes): one step at batch 2 from one bf16 state on
   the card and on the CPU, each held against the CPU's float64 step from
   the same state widened (the card within RESNET_BF16_FACTOR of the
   CPU's distance in the loss, fc_0's gradients and the running
   statistics; the loss also within RESNET_BF16_LOSS_RTOL and the
   statistics within one bf16 rounding; all gradients in L2 recorded),
   and the card's step with PyTorch's reduced-precision bf16 reduction
   recorded; then RESNET_STEPS steps at batch 128 on seeded
   bf16 images (finite; moved, or the last update under half the bf16
   spacing; the last loss under the first; the state's dtypes: bf16
   parameters and statistics, float32 velocities), images/s
   against the bf16 bound (989.4e12 / (3 x 3.8e9)), peak memory, device
   ms by op and idle share, beside the f32 leg's; then inference at
   batch 256 with bf16 state and images, unfolded and folded (the folded
   logits no farther from the f32 Program's than RESNET_BF16_FACTOR times
   the unfolded bf16 logits are), images/s;
19. Transformer-base from bench.py's bf16 state (bench.py:363-389): one
   step at batch 2 x 64 (dropout 0, full width) through program_to_fn on
   the card against the CPU (loss BF16_LOSS_ULPS bf16 ulps, gradients
   BF16_GRAD_GLOBAL_L2 together in L2, their median BF16_GRAD_MEDIAN_L2,
   each within BF16_GRAD_FACTOR times its own bf16 noise where that noise
   is under BF16_NOISE_CEIL, flipped ReLU units left out), B1 and B2 on
   bf16 tensors, with PyTorch's
   reduced-precision reduction recorded beside; then 64 x 256, dropout
   0.1, TRAIN_STEPS steps: finite, moved, parameters still bf16 and
   Adam's moments float32, B1 and B2 launched 18 times a step on bf16
   tensors; step ms, tokens/s, peak memory, device ms by family and idle
   share beside the f32 leg's;
20. Transformer-base at 64 x 256 through contrib.mixed_precision's
   decorate (bf16 mul and matmul, f32 master weights, the flash kernels
   in f32): DECORATE_STEPS steps from the f32 leg's parameters and feeds,
   every loss within DECORATE_LOSS_RTOL of the f32 leg's at the same
   step, B1 and B2 18 launches a step in float32; step ms, tokens/s,
   device ms by op;
21. Transformer-base beam-search inference (get_inference_model's
   defaults, beam 4, max_out_len 32, seq_len 64, at bench.py's widths,
   the parameters of get_model's training startup, f32 with TF32 off)
   through Executor(CUDAPlace(0)).run: first two sources at max_out_len
   16 in float64 on the card and on the port's CPU path (ids and
   lengths bitwise, scores within BEAM_SCORE_RTOL) with the float32
   decode's agreement recorded; then 64 sources of 8-64 tokens: every
   score finite and non-increasing within a source, every id in the
   vocabulary, every length in [1, 32], B1-B5 launched not at all; the
   fast path refuses to capture it (``while`` reads the host: counted
   once, the bound entry runs eager with the first decode's bits);
   sentences/s, generated tokens/s, ms an iteration, the device syncs
   of a decode, peak memory, and a profiled decode's device ms by op and
   idle share;
22. bench.py's two other long legs on bf16 (16 x 1024 for 15 steps,
   8 x 2048 for 12; bench.py's feeds, max_length = seq): the checks of
   phase 19's leg (B1 and B2 18 times a step on bf16); step ms, tokens/s,
   peak memory, idle share; then B1 and B2 at each leg's attention shape
   ([16, 8, 1024, 64], [8, 8, 2048, 64], bf16, not causal) against their
   plain versions, with their times, bounds and SDPA's;
23. a ``kernels`` JSON line (all six kernels: times at the shape of
   their main path, launches from it; B1's entry also carries its legacy
   serving launches and its figures at bucket 1024, and its predict
   launches (on the load) and figures at [16, 8, 256, 64]; B4's entry
   names its two kernels
   and carries each one's device time; B3's two kernels have no library
   call of their own, so their entries also carry the pair's time beside
   SDPA's whole backward; B1's and B2's also carry their figures at the
   long leg's shape (B2's dq sum apart) and their launches there, and
   their bf16 figures at [64, 8, 256, 64] (the bound at the bf16
   tensor-core peak, SDPA in bf16) with their launches on the bf16 leg,
   and at [16, 8, 1024, 64] and [8, 8, 2048, 64] with their launches on
   the 16 x 1024 and 8 x 2048 legs, and their launches a step on the
   Trainer's path and on ``Trainer.test``),
   the card line, and the final
   ``{"ok": true, "device": {...}}`` line.

It needs the repository beside it and a CUDA device; without either it
exits non-zero before printing any result.
"""
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
# the decode slice's shapes (docs/serving.md, "Autoregressive decode")
S, H, DH, PS, MP = 8, 8, 64, 16, 128
NUM_PAGES = S * MP + 1
LM_WIDTH = dict(vocab_size=32000, n_layer=12, n_head=8, d_model=512,
                d_inner=2048, max_length=2048)
DECODE_CONFIG = dict(num_slots=8, page_size=16, max_seq_len=2048,
                     max_new_tokens=256)
N_REQUESTS, NEW_TOKENS = 16, 64
# the legacy whole-prompt prefill (B1 on the serving path): the serving
# phase's 16 prompts, 32 new tokens each; B1 timed at these buckets with
# kv_lens = bucket - 7, the kernels line's figure at the second
LEGACY_NEW_TOKENS = 32
LEGACY_BUCKETS = (256, 1024, 2048)
# predict serving: Transformer-base scoring at TRAIN_CFG's width, the
# engine's default bucket ladder, and the load's requests (1-4 rows each)
PREDICT_BUCKETS = (2, 4, 8, 16)
PREDICT_REQUESTS = 64
# batch-1 clients with batching on and off (the JAX package's scenario 5)
PREDICT_BATCH1_REQUESTS = 32
# each request alone (bucket 2) against the same request coalesced into a
# larger bucket, max abs logit difference: bitwise.  With one product a
# mul, cuBLAS picked its SGEMM per bucket and a row moved by 1.07e-6 to
# 1.13e-6 (ROADMAP F-6).  Both backends now multiply each mul's rows in
# blocks of SERVING_BLOCK_ROWS (256) rows, padded to at least two blocks,
# as one batched product (cuBLAS's strided batched SGEMM, the weight
# expanded with a batch stride of 0): a block's bits do not depend on the
# block count (tools/serving_gemm_probe.py), and the AOT graph calls the
# same function as an operator at every batch, so the AOT backend gives
# the Program backend's bits.  Held for Transformer-base (256 rows a
# sample) and for a model whose samples are one row
PREDICT_BATCH_TOL = 0.0
# the one-row model: the Fluid book's recognize_digits MLP (784 -> 200 ->
# 200 -> 10, ReLU, softmax), seeded, f32
MLP_SIZES = (200, 200, 10)
# MNIST LeNet (benchmark/fluid/models/mnist.py), batch 128, f32
LENET_BATCH, LENET_STEPS = 128, 20
LENET_EAGER_STEPS = 10
# LeNet card vs CPU, TF32 off: the float32 step reads about 1e-7 (loss)
# and 1e-6 (gradients); TF32 rounds inputs to 10 mantissa bits (2**-11),
# so its control step must land above these
LENET_LOSS_RTOL, LENET_GRAD_RTOL = 1e-6, 1e-5
# ResNet-50 (benchmark/fluid/models/resnet.py, models.resnet.get_model)
# at bench.py's leg: 224 x 224, 1000 classes, batch 128, momentum 0.9 at
# lr 0.1, 30 iterations (bench.py:153); f32 with TF32 off; seeded normal
# images, as bench.py's.  On one batch at lr 0.1 the loss falls for two
# steps, then climbs for several before it falls again (the JAX package's
# get_model does the same on the CPU), so the fall is checked at the end
RESNET_CFG = dict(class_dim=1000, depth=50, image_shape=(3, 224, 224))
RESNET_BATCH, RESNET_STEPS, RESNET_CHECK_BATCH = 128, 30, 2
# bench.py:157: about 3.8e9 FLOPs an image forward, 3x for training
RESNET_TRAIN_FLOPS = 3 * 3.8e9
# ResNet-50's float32 training gradient jumps where a ReLU gate's input
# lies within rounding of 0 (tests/test_torch_resnet.py): the card's and
# the CPU's float32 gradients cannot meet GRAD_RTOL whatever computes
# them.  The float64 step holds LOSS_RTOL and GRAD_RTOL; the float32
# step is held to the CPU's float64 step where no gate reaches (the loss,
# fc_0's gradient, the running statistics) and, over all gradients
# together, to RESNET_GLOBAL_L2 (L2 distance of the L2 norm)
RESNET_STAT_RTOL = 1e-4    # running statistics, of each tensor's max
RESNET_GLOBAL_L2 = 0.1
# folded against unfolded logits, of their largest magnitude
RESNET_FOLD_RTOL = 1e-4
RESNET_INFER_RUNS = 5
# bf16 (bench.py's legs: ResNet-50 trained with get_model(dtype=
# "bfloat16") at 30 steps of batch 128, then inference at batch 256 with
# bf16 state and images, bench.py:277-328).  Card against CPU at batch 2:
# the card's bf16 step and the CPU's are each held against the CPU's
# float64 step from the same bf16 state (widened), and the card may lie
# no farther from it than RESNET_BF16_FACTOR times the CPU's distance, in
# the loss, fc_0's gradients, all gradients (L2) and the running
# statistics.  Both bf16 steps round every activation, gradient and
# statistic to bf16 once, with f32 sums in other orders (cuDNN and cuBLAS
# against the CPU's), so each lies its own bf16 noise away from the
# float64 step; on the CPU, two such steps (ResNet-50 at 64 x 64, batch
# 2: 1 thread against 8, and the port against the JAX package) lie
# within 0.96-1.06 times each other's distance in the gradients and the
# statistics (tools/bf16_probe.py resnet --jax; 1 and 8 threads give the
# same bits).  2 leaves room for that spread.  The loss is one bf16 value
# over two images, and bf16's noise through 50 layers moves it by whole
# ulps: the port's lay 0.008 from the float64 loss, the JAX package's
# 0.066, so the loss may also lie RESNET_BF16_LOSS_RTOL (twice the wider)
# from it; the statistics are stored in bf16, so they may also be off by
# one bf16 rounding, BF16_ROUNDING of the tensor's max.  Which limits can
# fail a wrong step (a zeroed tensor lies 1.0 of its max away, a sign
# flip 2.0): fc_0's gradients (the card read 0.23 of max against a limit
# of 2 x 0.22) and the statistics (0.077 against 2 x 0.077) can; the loss
# cannot fail a forward that gives uniform logits (ln 1000 lies 0.081
# from the f64 loss, inside 0.15).  All gradients in L2 are recorded, not
# held: the CPU's own bf16 step lies 1.32 of their norm from f64, so any
# limit above that passes a zeroed gradient (1.0)
RESNET_BF16_FACTOR = 2.0
RESNET_BF16_LOSS_RTOL = 0.15
BF16_ROUNDING = 2.0 ** -8
# bf16 inference at bench.py's batch.  The folded bf16 logits are held
# against the float32 unfolded Program's on the same state and images: no
# farther than RESNET_BF16_FACTOR times the unfolded bf16 logits are.
# (Against the unfolded bf16 logits directly there is no fixed limit:
# each folded weight w * k is rounded to bf16 once more and both Programs
# round every layer's output, and over 53 layers the two lie 15% of the
# logits' max apart on the CPU at 64 x 64, tools/bf16_probe.py fold.)
RESNET_INFER_BATCH = 256
# F-9: float32 cast to int32 and uint8, the JAX package's values
CAST_IN = [-2.7, -0.5, 0.5, 2.7, 3e9, -3e9, float("nan"), float("inf")]
CAST_WANT = {"int32": [-2, 0, 0, 2, 2147483647, -2147483648, 0, 2147483647],
             "uint8": [0, 0, 0, 2, 255, 0, 0, 255]}
KERNEL_TOL = 2e-5   # kernel vs plain, f32 math on both: summation order only
# the decode slice's kv_lens: empty slots, one key, a page, a page + 1, and
# longer walks up to 2047 keys
DECODE_LENS = np.array([0, 1, 16, 17, 300, 1024, 2047, 0], np.int32)
# paged prefill cases (start, C), each also split in two calls at C // 2:
# the slice's chunk shapes, then starts off the 64-key tiles, a ragged C
# split off a tile boundary and a one-row chunk
PREFILL_CASES = ((0, 16), (0, 512), (256, 256), (1024, 1024), (0, 2048),
                 (16, 48), (1008, 40), (0, 100), (37, 1))
# timed too: a monolithic prefill of 1024 tokens (the kernels line's
# shape), and the second chunk of a chunked prefill
PREFILL_TIMED = ((0, 1024), (1024, 512))
# the training slice's attention shape: [batch, heads, tokens, head_dim]
FB, FH, FT, FD = 64, 8, 256, 64
# kernel vs plain (forward, backward): f32 math on both, so summation order
# only.  bf16 outputs are rounded once from f32, half an ulp or 2**-9 of
# the value, so their error is taken relative to max(1, |value|)
FLASH_TOL = {"float32": (2e-5, 5e-5), "bfloat16": (1e-2, 1e-2)}
TRAIN_CFG = dict(batch_size=64, seq_len=256, src_vocab_size=30000,
                 trg_vocab_size=30000, max_length=256, use_flash=True)
TRAIN_STEPS = 10
# the executor's fast path (fast_path_phase): TRAIN_CFG (dropout 0.1) for
# FAST_STEPS steps eager and FAST_STEPS graphed from one start state; the
# loss of step FAST_HELD is held as numpy, that of the next step as an
# unread LazyFetch, that of the one after as a return_numpy=False tensor
FAST_STEPS = 10
FAST_HELD = 6
# batch sizes of 256 tokens through one executor in this order (a training
# loop's other batch sizes and last partial batches): each new one runs
# eager beside the graphs captured before, then is captured into their
# pool; the last round replays them all
FAST_CYCLE = (64, 64, 64, 56, 56, 48, 48, 40, 40, 64, 56, 48, 40)
# the Trainer (trainer_phase): TRAIN_CFG through fluid.Trainer, a
# checkpoint every TRAINER_CKPT_STEPS steps (the newest TRAINER_KEEP
# kept), stopped after TRAINER_STEPS; a fresh Trainer resumes from the
# checkpoint after step TRAINER_RESUME_AT; Trainer.test on
# TRAINER_TEST_BATCHES batches; TRAINER_TIMED_STEPS steps a timed leg
TRAINER_STEPS = 12
TRAINER_CKPT_STEPS = 4
TRAINER_KEEP = 2
TRAINER_RESUME_AT = 8
TRAINER_TEST_BATCHES = 4
TRAINER_TIMED_STEPS = 12
# LeNet through fluid.Trainer (lenet_trainer_phase): LENET_TRAINER_STEPS
# steps a leg; the rewind leg runs LENET_REWIND_STEPS steps under
# nan_guard=2 with a checkpoint every LENET_CKPT_STEPS steps and NaN
# images in the batches of steps LENET_NAN_STEPS (0-based)
LENET_TRAINER_STEPS = 40
LENET_REWIND_STEPS = 12
LENET_CKPT_STEPS = 4
LENET_NAN_STEPS = (5, 6)
# bench.py's bf16 Transformer, card against CPU at CHECK_CFG from one bf16
# state (bf16_step_errors), with limits fixed on the CPU from two
# implementations of the same bf16 step that sum in other orders, the
# port against the JAX package (tools/bf16_probe.py transformer, 6+6
# layers at d_model 128): the loss 0 ulps apart (limit 2); all gradients
# 0.036 apart in L2 and the median gradient 0.040 (limit 0.1 each).  No
# fixed limit holds a single gradient: where its signal is small, bf16's
# own noise exceeds its norm (fc_86.w_0 at full width: 2.70 of its norm
# between the CPU's bf16 and f32 steps).  So each gradient is held to
# its own bf16 noise, the CPU's bf16 step against the CPU's float32 step
# from the same state (bf16_noise_ratios): at most BF16_GRAD_FACTOR times
# it, the noise floored at BF16_NOISE_FLOOR.  The port against the JAX
# package lies 1.23 times the port's noise at the median, 1.42 at the
# 90th percentile and 1.85 at worst.  Which limits can fail a wrong step
# (a zeroed gradient lies 1.0 of its norm away, one of the same norm in
# another direction about 1.41, a sign flip 2.0): all gradients in L2
# and their median (0.1 each; the card read 0.021 and 0.036); each
# gradient held to its noise, where the limit stays under 1.0: a
# gradient whose noise exceeds BF16_NOISE_CEIL is left out of that check
# (counted and named in the log), since 3x its noise would pass a zeroed
# one.  The loss cannot fail a wrong forward at this random start: it
# reads 10.3125 = ln 30000 to a bf16 ulp, what uniform logits give
BF16_LOSS_ULPS = 2
BF16_GRAD_GLOBAL_L2 = 0.1
BF16_GRAD_MEDIAN_L2 = 0.1
BF16_GRAD_FACTOR = 3.0
BF16_NOISE_FLOOR = 0.02
BF16_NOISE_CEIL = 0.3
# through decorate: each loss against the f32 leg's at the same step, from
# the same parameters and feeds (the dropout draws differ; bf16 products
# round): up to 0.0064 at the CPU rehearsal's width (d_model 64, vocab
# 100, tools/bf16_probe.py rehearse), 3x that allowed
DECORATE_STEPS = 5
DECORATE_LOSS_RTOL = 0.02
CHECK_CFG = dict(TRAIN_CFG, batch_size=2, seq_len=64, dropout=0.0)
# the card-vs-CPU step with the pair engine: several 64-row tiles and an
# uneven last one
PAIR_CHECK_CFG = dict(CHECK_CFG, seq_len=200, max_length=200)
# the long-context leg: bench.py's longest Transformer leg (4 x 4096)
LONG_CFG = dict(TRAIN_CFG, batch_size=4, seq_len=4096, max_length=4096)
LONG_STEPS = 5
# the flash kernel cases: (causal, T, S, NaN/Inf check)
FLASH_CASES = ((False, FT, FT, True), (True, FT, FT, True),
               (True, 128, FT, False), (False, 200, 200, False),
               (True, 200, 200, False))
# the engine sweep's [B, H, T, D]: bench.py's four Transformer legs (tokens
# held at 16,384; the last is the long leg's), then B*H across B2's slots
# at D 64 (264 slots on 132 SMs) and at D 128 (132 slots), and past them
# (fill 3.9 at D 64; D 32, 396 slots)
SWEEP_SHAPES = ((64, 8, 256, 64), (16, 8, 1024, 64), (8, 8, 2048, 64),
                (4, 8, 4096, 64),
                (16, 8, 512, 64), (20, 8, 512, 64), (24, 8, 512, 64),
                (28, 8, 512, 64), (32, 8, 512, 64), (48, 8, 384, 64),
                (24, 4, 512, 128), (28, 4, 512, 128), (32, 4, 512, 128),
                (64, 4, 256, 128), (128, 8, 256, 64), (64, 8, 256, 32))
FLASH_BWD_KERNELS = {"fused": ("flash_attention_bwd",),
                     "pair": ("flash_attention_bwd_dkv",
                              "flash_attention_bwd_dq")}
LOSS_RTOL = 1e-4    # card vs CPU loss: GEMM summation orders differ
GRAD_RTOL = 1e-3    # card vs CPU, of each tensor's max |g|
LOGIT_TOL = 2e-3    # card vs CPU over 12 layers: GEMM summation orders differ
# Transformer-base beam-search inference: get_inference_model's defaults
# at bench.py's widths (6+6 layers, 8 heads, d_model 512, d_inner 2048,
# vocab 30000, max_length 256), 64 seeded sources of 8-64 tokens; the
# float64 card-vs-CPU check on two of them at max_out_len 16
BEAM_WIDTHS = dict(src_vocab_size=30000, trg_vocab_size=30000,
                   max_length=256, n_layer=6, n_head=8, d_model=512,
                   d_inner=2048)
BEAM_SIZE, BEAM_OUT_LEN, BEAM_SEQ = 4, 32, 64
BEAM_SOURCES = 64
BEAM_RUNS = 3
BEAM_CHECK_SOURCES, BEAM_CHECK_OUT_LEN = 2, 16
BEAM_SCORE_RTOL = 1e-9   # float64 card vs CPU: DGEMM summation orders only
DECODE_FAMILIES = {"mul": "gemm", "matmul": "gemm", "softmax": "softmax",
                   "layer_norm": "layer_norm", "top_k": "top_k",
                   "elementwise_mul": "elementwise",
                   "elementwise_add": "elementwise",
                   "reduce_sum": "reduce_sum"}
# bench.py's two other long Transformer legs (bench.py:458-461), on bf16:
# (batch, seq, steps)
BENCH_BF16_LEGS = ((16, 1024, 15), (8, 2048, 12))
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 (non-tensor) peak,
# and the dense bfloat16 tensor-core peak (989.4 TFLOP/s, no sparsity)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989.4e12
# the device-side wait before each timed launch: about 0.5 ms at the
# H100's 1.98 GHz boost clock, longer than any wrapper takes to enqueue
SLEEP_CYCLES = 1_000_000


def log(*args):
    print(*args, flush=True)


def check(ok, *what):
    """Fail the run (non-zero exit) unless ``ok``."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: %r" % (what,))


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def timed(fn, iters, flush, warmup=2):
    """(mean device time of ``fn`` in ms over ``iters`` launches, its last
    result); each launch is timed alone by CUDA events with the L2 cache
    flushed before it (the main path reaches each layer's pool cold).  A
    device-side wait of SLEEP_CYCLES is queued after the flush, so the
    host has queued ``fn``'s launches before the start event is reached:
    the interval holds the device's work and the gaps between its
    launches, not the host's time to enqueue them."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for a, b in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        result = fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / iters, result


def time_ms(fn, iters, flush, warmup=2):
    return timed(fn, iters, flush, warmup)[0]


def kernel_ms(torch, fn, iters, flush, names):
    """Mean device time a launch, in ms, of each kernel whose name holds
    one of ``names``, read from a torch.profiler window over ``iters``
    calls of ``fn`` (the L2 cache flushed before each), and the launches
    of each the profiler recorded: it may drop a few of a window's
    events, so the mean is over those it kept.  A window in which some
    kernel shows up not once is taken again, up to three windows in all;
    then each kernel must have shown up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        total = dict.fromkeys(names, 0.0)
        count = dict.fromkeys(names, 0)
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for n in names:
                if n in e.name:
                    total[n] += e.time_range.elapsed_us()
                    count[n] += 1
        if all(count.values()):
            break
    check(all(0 < c <= iters for c in count.values()),
          "profiler saw no launch of a kernel", count, iters)
    return {n: total[n] / count[n] / 1e3 for n in names}, count


def bound_ms(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNEL_NAMES = ("paged_decode_kernel", "paged_decode_merge_kernel",
                "paged_prefill_kernel",
                "flash_fwd_kernel", "flash_bwd_fused_kernel",
                "flash_bwd_dq_sum_kernel", "flash_bwd_delta_kernel",
                "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
# B4's two launches: the split kernel, then the merge
B4_KERNELS = ("paged_decode_kernel", "paged_decode_merge_kernel")
# the device kernels of each backward engine (names as the profiler shows
# them; no name holds another): B2's three launches and B3's three
B2_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_fused_kernel",
              "flash_bwd_dq_sum_kernel")
B3_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dkv_kernel",
              "flash_bwd_dq_kernel")


def ptxas_report(build_log):
    """(kernel<template arguments>, registers, spill-store bytes) of each
    kernel entry in nvcc's -Xptxas -v log."""
    rows, name, spill = [], None, 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((n for n in KERNEL_NAMES if n + "I" in line), None)
            if kernel:
                args = line.split(kernel + "I", 1)[1].split("EEv", 1)[0]
                args = re.sub(r"Li(\d+)E", r"\1 ", args).replace(
                    "13__nv_bfloat16", "bf16")
                args = re.sub(r" f$", " f32", args)
                name = "%s<%s>" % (kernel, args)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def make_pools(torch, dev, gen):
    """One layer's k/v pools ([P, ps, H, Dh], random), f32 and bf16."""
    k = torch.randn((NUM_PAGES, PS, H, DH), generator=gen, device=dev)
    v = torch.randn((NUM_PAGES, PS, H, DH), generator=gen, device=dev)
    return {"float32": (k, v),
            "bfloat16": (k.to(torch.bfloat16), v.to(torch.bfloat16))}


def decode_bytes_flops(lens, H, Dh, itemsize):
    """B4's bytes moved once (the visible key and value rows, q and out in
    float32, the page tables and kv_lens) and its 4*Dh operations a
    visible key, at these kv_lens (each clamped at the table's MP*PS)."""
    keys = int(np.minimum(np.maximum(lens, 0), MP * PS).sum())
    S_ = len(lens)
    nbytes = (keys * H * Dh * 2 * itemsize + 2 * S_ * H * Dh * 4
              + S_ * MP * 4 + S_ * 4)
    return nbytes, keys * H * Dh * 4


def decode_checks(torch, fa, dev, gen, rng):
    """B4 at the slice's width (S 8, H 8, Dh 64, ps 16, mp 128), f32 and
    bf16 pools, at the table's kv_lens and at the edge lengths (1, ps, a
    split's size - 1, size and size + 1, mp*ps, mp*ps + 5): within
    KERNEL_TOL of the plain version; kv_lens == 0 exact zeros; NaN/Inf in
    the stale tail of each slot's last page inert; and bitwise: two calls,
    each slot alone (S = 1) against its row in the S = 8 call, and the
    pools' pages permuted with the tables moved to match."""
    split = fa._b4_split_pages(PS) * PS
    cases = {"table": DECODE_LENS,
             "edges": np.array([1, PS, split - 1, split, split + 1, MP * PS,
                                MP * PS + 5, 0], np.int32)}
    # every slot its own pages (S * MP = NUM_PAGES - 1), in random order
    tables_np = rng.permutation(np.arange(1, NUM_PAGES)).reshape(S, MP)
    tables = torch.as_tensor(tables_np.astype(np.int32), device=dev)
    perm_np = np.concatenate([[0], rng.permutation(np.arange(1, NUM_PAGES))])
    perm = torch.as_tensor(perm_np, device=dev)
    moved = torch.as_tensor(np.argsort(perm_np).astype(np.int32),
                            device=dev)[tables.long()]
    q = torch.randn((S, H, DH), generator=gen, device=dev)
    scale = 1.0 / DH ** 0.5
    rows = []
    for dtype, (k, v) in make_pools(torch, dev, gen).items():
        kp, vp = k[perm], v[perm]
        for label, lens_np in cases.items():
            kv_lens = torch.as_tensor(lens_np, device=dev)
            out = fa.paged_decode_attention(q, k, v, tables, kv_lens)
            ref = fa._paged_reference(q, k, v, tables, kv_lens, scale)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            what = ("decode", dtype, label)
            check(err <= KERNEL_TOL, what, err)
            check(bool((out[kv_lens == 0] == 0).all()), what,
                  "kv_lens == 0 not zero")
            check(torch.equal(fa.paged_decode_attention(
                q, k, v, tables, kv_lens), out), what, "two calls differ")
            for s_ in range(S):
                one = slice(s_, s_ + 1)
                alone = fa.paged_decode_attention(q[one], k, v, tables[one],
                                                  kv_lens[one])
                check(torch.equal(alone, out[one]), what,
                      "slot alone != batched", s_)
            check(torch.equal(fa.paged_decode_attention(
                q, kp, vp, moved, kv_lens), out), what,
                "permuted page placement changed the bits")
            # non-finite garbage past each slot's length must not reach the sum
            kn, vn = k.clone(), v.clone()
            for s_, n in enumerate(lens_np):
                if 0 < n < MP * PS and n % PS:
                    last = tables_np[s_, (n - 1) // PS]
                    kn[last, n % PS:] = float("nan")
                    vn[last, n % PS:] = float("inf")
            out_nan = fa.paged_decode_attention(q, kn, vn, tables, kv_lens)
            check(torch.equal(out_nan, out), what, "stale non-finite tail "
                  "leaked")
            del kn, vn
            rows.append({"dtype": dtype, "case": label,
                         "kv_lens": lens_np.tolist(), "max_abs_err": err})
        del kp, vp
    for r in rows:
        log("decode check %-8s %-5s kv_lens=%s err=%.3g (tol %g); bitwise: "
            "two calls, each slot alone == batched, permuted pages; "
            "kv_lens==0 zeros; stale NaN/Inf inert"
            % (r["dtype"], r["case"], r["kv_lens"], r["max_abs_err"],
               KERNEL_TOL))
    return rows


def decode_sweep_row(torch, fa, dev, flush, gen, label, lens_np, dtype,
                     heads=H, dh=DH):
    """B4 at one sweep row: its time by CUDA events (L2 flushed), the
    merge kernel's share of its device time (a torch.profiler window), the
    bound, one SDPA call over K/V gathered beforehand, the plain version's
    time and the host time a call takes to enqueue; checked against the
    plain version first."""
    import torch.nn.functional as F

    k = torch.randn((NUM_PAGES, PS, heads, dh), generator=gen, device=dev)
    v = torch.randn((NUM_PAGES, PS, heads, dh), generator=gen, device=dev)
    k, v = k.to(getattr(torch, dtype)), v.to(getattr(torch, dtype))
    n = len(lens_np)
    tables = torch.randperm(NUM_PAGES - 1, generator=gen, device=dev)[
        :n * MP].reshape(n, MP).add(1).int()
    kv_lens = torch.as_tensor(lens_np, device=dev)
    q = torch.randn((n, heads, dh), generator=gen, device=dev)
    scale = 1.0 / dh ** 0.5
    call = lambda: fa.paged_decode_attention(  # noqa: E731
        q, k, v, tables, kv_lens)
    out = call()
    ref = fa._paged_reference(q, k, v, tables, kv_lens, scale)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(err <= KERNEL_TOL, "decode sweep", label, dtype, err)
    ms = time_ms(call, 50, flush)
    apart, _ = kernel_ms(torch, call, 20, flush, B4_KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        call()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    nbytes, flops = decode_bytes_flops(lens_np, heads, dh, k.element_size())
    kg = k[tables.long()].reshape(n, MP * PS, heads, dh).float()
    vg = v[tables.long()].reshape(n, MP * PS, heads, dh).float()
    kg, vg = kg.transpose(1, 2), vg.transpose(1, 2)
    mask = (torch.arange(MP * PS, device=dev)[None, :]
            < kv_lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    row = {"label": label, "dtype": dtype, "S": n, "H": heads, "Dh": dh,
           "kv_lens": [int(x) for x in lens_np], "max_abs_err": err,
           "ms": ms, "split_ms": apart[B4_KERNELS[0]],
           "merge_ms": apart[B4_KERNELS[1]],
           "merge_share": apart[B4_KERNELS[1]] / sum(apart.values()),
           "host_us": host_us,
           "plain_ms": time_ms(lambda: fa._paged_reference(
               q, k, v, tables, kv_lens, scale), 10, flush),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q4, kg, vg, attn_mask=mask), 20, flush),
           "bound": bound_ms(nbytes, flops), "bytes": nbytes,
           "flops": flops}
    del kg, vg, k, v
    return row


def decode_phase(torch, fa, dev, flush):
    """B4's checks, then its sweep: the slice's table case (f32 and bf16),
    every slot at 2048, lengths in the serving run's range, one live slot
    (max_active=1's shape), and Dh 32 at H 16 and Dh 128 at H 4."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    checks = decode_checks(torch, fa, dev, gen, rng)
    served = rng.randint(32, NEW_TOKENS + 1501, size=S).astype(np.int32)
    solo = np.zeros(S, np.int32)
    solo[0] = 2047
    rows = [decode_sweep_row(torch, fa, dev, flush, gen, label, lens, dtype,
                             heads, dh)
            for label, lens, dtype, heads, dh in (
                ("table", DECODE_LENS, "float32", H, DH),
                ("table", DECODE_LENS, "bfloat16", H, DH),
                ("full", np.full(S, 2048, np.int32), "float32", H, DH),
                ("served", served, "float32", H, DH),
                ("solo", solo, "float32", H, DH),
                ("dh32", DECODE_LENS, "float32", 16, 32),
                ("dh128", DECODE_LENS, "float32", 4, 128))]
    for r in rows:
        log("decode sweep %-6s %-8s S=%d H=%d Dh=%d kv_lens=%s err=%.3g "
            "(tol %g): kernel %.4f ms (device: split %.4f + merge %.4f ms, "
            "merge %.1f%%) host enqueue %.1f us | plain %.4f ms sdpa %.4f ms "
            "bound %.4f ms (%s)"
            % (r["label"], r["dtype"], r["S"], r["H"], r["Dh"], r["kv_lens"],
               r["max_abs_err"], KERNEL_TOL, r["ms"], r["split_ms"],
               r["merge_ms"], 100 * r["merge_share"], r["host_us"],
               r["plain_ms"], r["library_ms"], r["bound"][0],
               r["bound"][1]))
    return checks, rows


def prefill_phase(torch, fa, dev, flush):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    pages = torch.as_tensor(rng.choice(np.arange(1, NUM_PAGES), MP,
                                       replace=False).astype(np.int32),
                            device=dev)
    scale = 1.0 / DH ** 0.5
    pages_np = pages.cpu().numpy()
    span = MP * PS
    rows = []
    for dtype, (k, v) in make_pools(torch, dev, gen).items():
        for start, C in PREFILL_CASES + PREFILL_TIMED:
            q = torch.randn((C, H, DH), generator=gen, device=dev)
            out = fa.paged_prefill_attention(q, k, v, pages, start)
            ref = fa._paged_prefill_reference(q, k, v, pages, start, scale)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(err <= KERNEL_TOL, "prefill", dtype, start, C, err)
            half = C // 2
            split = torch.cat([
                fa.paged_prefill_attention(q[:half], k, v, pages, start),
                fa.paged_prefill_attention(q[half:], k, v, pages,
                                           start + half)])
            check(torch.equal(split, out), "chunk split", start, C)
            # NaN/Inf in the stale keys past the chunk, up to the end of the
            # 64-key tile that holds its last key (rest of its last page
            # included): every output bit unchanged
            stale = np.arange(start + C, min(span, (start + C) // 64 * 64 + 64))
            nan_checked = len(stale) > 0
            if nan_checked:
                kn, vn = k.clone(), v.clone()
                where = (torch.as_tensor(pages_np[stale // PS], device=dev).long(),
                         torch.as_tensor(stale % PS, device=dev))
                kn[where] = float("nan")
                vn[where] = float("inf")
                out_nan = fa.paged_prefill_attention(q, kn, vn, pages, start)
                check(torch.equal(out_nan, out), "prefill: stale NaN/Inf "
                      "past start + C changed an output", dtype, start, C)
                del kn, vn
            row = {"dtype": dtype, "start": start, "C": C,
                   "max_abs_err": err, "split_bitwise": True,
                   "stale_nan_inert": nan_checked}
            if (start, C) in PREFILL_TIMED:
                itemsize = k.element_size()
                nbytes = ((start + C) * H * DH * 2 * itemsize
                          + 2 * q.numel() * 4 + MP * 4)
                flops = 4 * H * DH * (C * start + C * (C + 1) // 2)
                span = MP * PS
                kg = k[pages.long()].reshape(1, span, H, DH).float()
                vg = v[pages.long()].reshape(1, span, H, DH).float()
                kg, vg = kg.transpose(1, 2), vg.transpose(1, 2)
                mask = (torch.arange(span, device=dev)[None, :]
                        <= start + torch.arange(C, device=dev)[:, None])
                q4 = q.transpose(0, 1)[None]
                row.update({
                    "ms": time_ms(lambda: fa.paged_prefill_attention(
                        q, k, v, pages, start), 20, flush),
                    "plain_ms": time_ms(lambda: fa._paged_prefill_reference(
                        q, k, v, pages, start, scale), 5, flush),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, kg, vg, attn_mask=mask), 10, flush),
                    "bound": bound_ms(nbytes, flops), "bytes": nbytes,
                    "flops": flops})
                del kg, vg
            rows.append(row)
    for r in rows:
        extra = ""
        if "ms" in r:
            extra = (" kernel %.4f ms plain %.4f ms sdpa %.4f ms bound "
                     "%.4f ms (%s)" % (r["ms"], r["plain_ms"],
                                       r["library_ms"], r["bound"][0],
                                       r["bound"][1]))
        log("prefill %-8s start=%d C=%d err=%.3g (tol %g) split bitwise%s%s"
            % (r["dtype"], r["start"], r["C"], r["max_abs_err"], KERNEL_TOL,
               ", stale NaN/Inf inert" if r["stale_nan_inert"] else "",
               extra))
    return rows


def logits_check(torch, T, params, meta, dev):
    """The LM on the card (kernels) against the plain versions on the
    CPU: one 40-token prompt prefilled in a 48-wide chunk, then 4 decode
    steps; max |logit difference| must stay under LOGIT_TOL."""
    rng = np.random.RandomState(SEED + 2)
    prompt = rng.randint(0, meta["vocab_size"], size=40).astype(np.int32)
    L, nh, hd = meta["n_layer"], meta["n_head"], meta["head_dim"]
    worst = 0.0
    results = {}
    for where in (dev, torch.device("cpu")):
        lm = T.params_from_numpy(params, where, meta=meta)
        pool = lambda: torch.zeros((L, 8, PS, nh, hd), device=where)
        kp, vp = pool(), pool()
        table = torch.tensor([1, 2, 3, 4, 0, 0, 0, 0], dtype=torch.int32,
                             device=where)
        toks = np.zeros(48, np.int32)
        toks[:40] = prompt
        with torch.no_grad():
            out = [T.lm_prefill_chunk(
                lm, torch.as_tensor(toks, device=where), 0, 40, kp, vp,
                table[:3].clone(), table)]
            tok = int(torch.argmax(out[0]))
            for step in range(4):
                pos = 40 + step
                logits = T.lm_decode_step(
                    lm, torch.tensor([tok], dtype=torch.int32, device=where),
                    torch.tensor([pos], dtype=torch.int32, device=where),
                    kp, vp, table[None].clone(),
                    torch.tensor([pos + 1], dtype=torch.int32, device=where))
                out.append(logits[0])
                tok = int(torch.argmax(logits[0]))
        results[where.type] = [o.float().cpu() for o in out]
    for a, b in zip(results["cuda"], results["cpu"]):
        check(bool(torch.isfinite(a).all()), "non-finite logits on the card")
        worst = max(worst, (a - b).abs().max().item())
    check(worst <= LOGIT_TOL, "card vs cpu logits", worst)
    return worst


def profile_window(torch, engine, meta):
    """Where a decode-serving window's device time goes: 8 concurrent
    256-token prompts, 32 new tokens each, under torch.profiler.  Returns
    device time by kernel family and the device's idle share of the
    window's wall time, or "not measured" when the profiler records no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(SEED + 4)
    prompts = [rng.randint(0, meta["vocab_size"], size=256).astype(np.int32)
               for _ in range(8)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = [engine.generate_async(p, max_new_tokens=32) for p in prompts]
        for f in futs:
            f.result(timeout=600)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return "not measured (the profiler recorded no device activity)"
    # B4's family holds both its launches (split kernel and merge)
    paged = {"paged_decode_kernel": "paged_decode",
             "paged_decode_merge_kernel": "paged_decode",
             "paged_prefill_kernel": "paged_prefill"}
    families = {"paged_decode": 0.0, "paged_prefill": 0.0, "gemm": 0.0,
                "memcpy": 0.0, "other": 0.0}
    merge_us, b4_calls = 0.0, 0
    for e in kernels:
        name = e.name.lower()
        fam = next((f for k, f in paged.items() if k in name), None)
        if fam is None:
            fam = ("gemm" if any(k in name for k in ("gemm", "xmma",
                                                       "cutlass", "gemv"))
                   else "memcpy" if "memcpy" in name else "other")
        families[fam] += e.time_range.elapsed_us()
        if "paged_decode_merge_kernel" in name:  # once a B4 call
            merge_us += e.time_range.elapsed_us()
            b4_calls += 1
    busy = sum(families.values())
    return {"window_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_by_family": {k: v / 1e3 for k, v in families.items()},
            "b4_merge_ms": merge_us / 1e3, "b4_calls_seen": b4_calls,
            "b4_share_of_wall": families["paged_decode"] / wall_us,
            "device_events": len(kernels)}


def serving_phase(torch, T, serving, fa, obs, dev):
    params, meta = T.lm_params(seed=SEED, **LM_WIDTH)
    logit_err = logits_check(torch, T, params, meta, dev)
    log("logits card vs cpu (prefill + 4 decode steps): max abs diff %.3g "
        "(tol %g)" % (logit_err, LOGIT_TOL))
    model = T.build_decode_model(params, meta, device=dev)
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(0, meta["vocab_size"],
                           size=int(n)).astype(np.int32)
               for n in rng.randint(32, 1501, size=N_REQUESTS)]
    t0 = time.perf_counter()
    engine = serving.InferenceEngine(
        decode_model=model, decode_config=serving.DecodeConfig(
            **DECODE_CONFIG), device=dev)
    setup_s = time.perf_counter() - t0
    steps = obs.counter("serving.decode.steps")
    prefills = obs.counter("serving.decode.prefills")
    step_timer = obs.timer("serving.decode.decode_step")
    steps0, prefills0 = steps.value, prefills.value
    timer0 = (step_timer.count, step_timer.total)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [engine.generate_async(p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(fa.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    n_steps = steps.value - steps0
    n_prefills = prefills.value - prefills0
    profile = profile_window(torch, engine, meta)
    engine.stop()
    L = meta["n_layer"]
    check(launches["paged_decode_attention"] == L * n_steps > 0,
          launches, n_steps)
    check(launches["paged_prefill_attention"] == L * n_prefills > 0,
          launches, n_prefills)
    for o in outs:
        check(o.shape == (NEW_TOKENS,) and o.dtype == np.int32, o.shape)
        check(((0 <= o) & (o < meta["vocab_size"])).all(), "token range")
    ttft = np.array([f.token_times[0] - f.enqueue_ts for f in futs])
    step_ms = ((step_timer.total - timer0[1])
               / max(1, step_timer.count - timer0[0]) * 1e3)
    tokens = sum(len(o) for o in outs)
    stats = {"requests": N_REQUESTS, "succeeded": len(outs),
             "prompt_tokens": int(sum(len(p) for p in prompts)),
             "generated_tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
             "ttft_p95_ms": float(np.percentile(ttft, 95) * 1e3),
             "decode_step_ms": step_ms, "decode_steps": n_steps,
             "prefill_chunks": n_prefills,
             "peak_memory_gib": peak / 2 ** 30, "engine_setup_s": setup_s,
             "launches": launches, "profile": profile}
    log("serving: " + json.dumps(stats))
    # continuous batching == serving alone, bitwise
    solo = serving.InferenceEngine(
        decode_model=model, decode_config=serving.DecodeConfig(
            max_active=1, **DECODE_CONFIG), device=dev)
    for i in (0, 7, 15):
        alone = solo.generate(prompts[i], max_new_tokens=NEW_TOKENS,
                              timeout=600)
        check(alone.tobytes() == outs[i].tobytes(),
              "request %d differs batched vs max_active=1" % i)
    solo.stop()
    log("serving: requests 0, 7, 15 bitwise equal to a max_active=1 engine")
    return stats, prompts, outs


def resident_gib(torch, dev):
    """Collect the engines earlier phases left in reference cycles
    (worker threads hold their schedulers), release the cached blocks,
    and return what stays allocated, in GiB: a phase's peak is measured
    from here."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev) / 2 ** 30


def legacy_b1_row(torch, fa, dev, flush, gen, bucket):
    """B1 as the legacy prefill calls it at one bucket: [1, 8, bucket, 64]
    float32, causal, kv_lens = [bucket - 7], q/k/v the [T, H, D] -> [1, H,
    T, D] views lm_prefill makes; against its plain version, then its
    CUDA-event time, the plain version's, the bound (4*D operations a
    visible pair, or the bytes moved once), one causal SDPA call over the
    same keys, and B5 over the same prompt in its pages (one bucket-wide
    chunk at start 0, the chunked path's monolithic prefill)."""
    import torch.nn.functional as F

    length = bucket - 7
    qkv = [torch.randn((bucket, H, DH), generator=gen, device=dev)
           for _ in range(3)]
    q, k, v = (x.transpose(0, 1)[None] for x in qkv)
    lens = torch.full((1,), length, dtype=torch.int32, device=dev)
    scale = 1.0 / DH ** 0.5
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, kv_lens=lens, causal=True)
        ref, _ = fa._flash_fwd_reference(q, k, v, lens, True, scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(err <= KERNEL_TOL, "legacy B1 vs plain", bucket, err)
        # the prompt's k/v in pages 1..bucket/PS of a pool, for B5
        n_pages = bucket // PS
        k_pool = torch.zeros((n_pages + 1, PS, H, DH), device=dev)
        v_pool = torch.zeros_like(k_pool)
        k_pool[1:] = qkv[1].reshape(n_pages, PS, H, DH)
        v_pool[1:] = qkv[2].reshape(n_pages, PS, H, DH)
        pages = torch.zeros((MP,), dtype=torch.int32, device=dev)
        pages[:n_pages] = torch.arange(1, n_pages + 1, device=dev)
        mask = torch.arange(bucket, device=dev)[None, :] < length
        mask = mask & torch.ones((bucket, bucket), dtype=torch.bool,
                                 device=dev).tril()
        pairs = visible_pairs([length], bucket, bucket, True, H)
        nbytes = 4 * H * DH * bucket * 4 + 4 + H * bucket * 4
        row = {"bucket": bucket, "kv_len": length, "max_abs_err": err,
               "ms": time_ms(lambda: fa.flash_attention(
                   q, k, v, kv_lens=lens, causal=True), 20, flush),
               "plain_ms": time_ms(lambda: fa._flash_fwd_reference(
                   q, k, v, lens, True, scale), 5, flush),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask), 20, flush),
               "b5_ms": time_ms(lambda: fa.paged_prefill_attention(
                   qkv[0], k_pool, v_pool, pages, 0), 20, flush),
               "bound": bound_ms(nbytes, 4 * DH * pairs)}
    return row


def legacy_phase(torch, T, serving, fa, obs, dev, prompts, chunked_outs):
    """The legacy whole-prompt prefill serving the decode LM: the serving
    phase's prompts through an engine whose model has no chunk function
    (``build_decode_model(..., chunked=False)``), so each admitted prompt
    runs ``lm_prefill`` — B1 once a layer — and the decode steps run B4.
    Checks B1's launches (12 a prompt), B4's (12 a step) and B5's (none),
    greedy tokens equal to the chunked engine's first LEGACY_NEW_TOKENS
    and, for three requests, bitwise equal to a max_active=1 legacy
    engine; then B1 at LEGACY_BUCKETS."""
    resident = resident_gib(torch, dev)
    params, meta = T.lm_params(seed=SEED, **LM_WIDTH)
    model = T.build_decode_model(params, meta, device=dev, chunked=False)
    check(model.prefill_chunk_fn is None, "legacy model has a chunk fn")
    t0 = time.perf_counter()
    engine = serving.InferenceEngine(
        decode_model=model, decode_config=serving.DecodeConfig(
            **DECODE_CONFIG), device=dev)
    setup_s = time.perf_counter() - t0
    steps = obs.counter("serving.decode.steps")
    prefills = obs.counter("serving.decode.prefills")
    step_timer = obs.timer("serving.decode.decode_step")
    steps0, prefills0 = steps.value, prefills.value
    timer0 = (step_timer.count, step_timer.total)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [engine.generate_async(p, max_new_tokens=LEGACY_NEW_TOKENS)
            for p in prompts]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(fa.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    n_steps = steps.value - steps0
    n_prefills = prefills.value - prefills0
    engine.stop()
    L = meta["n_layer"]
    check(n_prefills == len(prompts), "legacy prefills", n_prefills)
    check(launches["flash_attention_fwd"] == L * len(prompts), launches)
    check(launches["paged_decode_attention"] == L * n_steps > 0,
          launches, n_steps)
    check(launches["paged_prefill_attention"] == 0, launches)
    for i, (o, c) in enumerate(zip(outs, chunked_outs)):
        check(o.shape == (LEGACY_NEW_TOKENS,) and o.dtype == np.int32,
              o.shape)
        check(o.tobytes() == c[:LEGACY_NEW_TOKENS].tobytes(),
              "request %d: legacy greedy tokens differ from the chunked "
              "engine's" % i)
    ttft = np.array([f.token_times[0] - f.enqueue_ts for f in futs])
    step_ms = ((step_timer.total - timer0[1])
               / max(1, step_timer.count - timer0[0]) * 1e3)
    tokens = sum(len(o) for o in outs)
    solo = serving.InferenceEngine(
        decode_model=model, decode_config=serving.DecodeConfig(
            max_active=1, **DECODE_CONFIG), device=dev)
    for i in (0, 7, 15):
        alone = solo.generate(prompts[i], max_new_tokens=LEGACY_NEW_TOKENS,
                              timeout=600)
        check(alone.tobytes() == outs[i].tobytes(),
              "legacy request %d differs batched vs max_active=1" % i)
    solo.stop()
    del model, engine, solo
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    b1 = [legacy_b1_row(torch, fa, dev, flush, gen, b)
          for b in LEGACY_BUCKETS]
    del flush
    stats = {"requests": len(prompts), "succeeded": len(outs),
             "prompt_tokens": int(sum(len(p) for p in prompts)),
             "generated_tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
             "ttft_p95_ms": float(np.percentile(ttft, 95) * 1e3),
             "decode_step_ms": step_ms, "decode_steps": n_steps,
             "prefills": n_prefills, "peak_memory_gib": peak / 2 ** 30,
             "resident_before_gib": resident,
             "engine_setup_s": setup_s, "launches": launches}
    log("legacy serving: " + json.dumps(stats))
    log("legacy serving: greedy tokens equal to the chunked engine's; "
        "requests 0, 7, 15 bitwise equal to a max_active=1 engine")
    for r in b1:
        log("legacy B1 [1,%d,%d,%d] causal kv_len %d: err %.3g, kernel %.4f "
            "ms plain %.4f ms sdpa %.4f ms B5 (one chunk) %.4f ms bound "
            "%.4f ms (%s)" % (H, r["bucket"], DH, r["kv_len"],
                              r["max_abs_err"], r["ms"], r["plain_ms"],
                              r["library_ms"], r["b5_ms"], r["bound"][0],
                              r["bound"][1]))
    stats["b1"] = b1
    return stats


def predict_rows(rng, n, seq, vocab):
    """``n`` seeded scoring rows: source and target ids in [3, vocab),
    each row its own lengths (64..seq), PAD_IDX (0) tails."""
    src = rng.randint(3, vocab, size=(n, seq)).astype(np.int64)
    trg = rng.randint(3, vocab, size=(n, seq)).astype(np.int64)
    for b in range(n):
        ls, lt = rng.randint(min(64, seq), seq + 1, size=2)
        src[b, ls:] = 0
        trg[b, lt:] = 0
    return src, trg


def predict_feed(src, trg):
    return {"src_word": src, "trg_word": trg}


def word_lens(ids):
    return (ids != 0).sum(1).astype(np.int32)


def save_predict_model(fluid, T, dirname, seed, aot):
    """Transformer-base scoring at TRAIN_CFG's width, pruned to its
    logits, from a seeded startup on the card; returns the seconds the
    save took (the torch.export trace included with ``aot``)."""
    with fluid.unique_name.guard():
        m = T.get_model(**TRAIN_CFG)
    m["startup"].random_seed = seed
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(m["startup"])
        t0 = time.perf_counter()
        fluid.io.save_inference_model(
            dirname, ["src_word", "trg_word"], [m["predict"]], exe,
            main_program=m["test"], aot=aot)
        return time.perf_counter() - t0


def predict_engine(serving, dirname, dev, **kw):
    kw.setdefault("batch_buckets", PREDICT_BUCKETS)
    return serving.InferenceEngine(dirname, device=dev, **kw)


def predict_launch_check(fa, launches, dispatches, what):
    """B1 launched 18 times a dispatch (6 encoder, 6 decoder causal, 6
    cross attention), every other kernel not at all."""
    want = dict.fromkeys(launches, 0)
    want["flash_attention_fwd"] = 18 * dispatches
    check(dispatches > 0 and launches == want, what + " launches",
          dispatches, launches)


def serve_clients(engine, feeds, n_threads):
    """Send ``feeds`` from ``n_threads`` client threads (each its share in
    order); returns (outputs, per-request seconds, wall seconds)."""
    outs = [None] * len(feeds)
    lat = [None] * len(feeds)
    errors = []

    def client(idx):
        try:
            for i in idx:
                t0 = time.perf_counter()
                outs[i] = engine.predict(feeds[i], timeout=600)[0]
                lat[i] = time.perf_counter() - t0
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=client,
                                args=(range(t, len(feeds), n_threads),))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          "predict clients", errors[:1])
    return outs, lat, wall


def bucket_counts(obs):
    return {b: obs.counter("serving.batch_bucket_%d" % b).value
            for b in PREDICT_BUCKETS}


def profile_predict(torch, engine, feeds):
    """Where a predict window's device time goes: ``feeds`` from 8
    clients under torch.profiler.  Device time by family (B1, GEMMs, the
    device-to-host copy of the logits, other elementwise work), the
    device's idle share of the window's wall time, and B1's share; "not
    measured" when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_clients(engine, feeds, 8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return "not measured (the profiler recorded no device activity)"
    families = {"flash_fwd": 0.0, "gemm": 0.0, "memcpy_dtoh": 0.0,
                "memcpy_other": 0.0, "other": 0.0}
    b1_calls = 0
    for e in events:
        name = e.name.lower()
        if "flash_fwd_kernel" in name:
            fam = "flash_fwd"
            b1_calls += 1
        elif any(k in name for k in ("gemm", "xmma", "cutlass", "gemv",
                                      "sm90_", "sm80_")):
            fam = "gemm"
        elif "memcpy" in name:
            fam = "memcpy_dtoh" if "dtoh" in name else "memcpy_other"
        else:
            fam = "other"
        families[fam] += e.time_range.elapsed_us()
    busy = sum(families.values())
    return {"window_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_by_family": {k: v / 1e3 for k, v in families.items()},
            "b1_share_of_busy": families["flash_fwd"] / busy,
            "b1_calls_seen": b1_calls, "device_events": len(events)}


def logits_d2h(torch, dev, vocab, seq):
    """One bucket-16 logits tensor ([16, seq, vocab] float32, 491 MB at
    the phase's width) copied to the host: to pageable memory
    (``.cpu()``, the serving path before the fast path), into a pinned
    buffer made beforehand, and through ``executor.as_numpy`` (the
    serving path now: staged through a pinned buffer of the caching host
    allocator, then copied out into pageable memory), the first time and
    again, and three times while the earlier arrays are held; the bits
    equal.  Seconds each (host clock; the copies are waited for).  The
    host allocator's pinned bytes (``torch.cuda.host_memory_stats``,
    where this PyTorch has it) must not grow while arrays are held: the
    caller keeps pageable copies, not pinned blocks."""
    from paddle_tpu_torch import executor as executor_mod

    x = torch.randn((16, seq, vocab), device=dev)
    pinned = torch.empty(x.shape, pin_memory=True)
    torch.cuda.synchronize()
    out = {"bytes": x.numel() * 4}
    for name, copy in (("pageable_s", lambda: x.cpu()),
                       ("pinned_s", lambda: pinned.copy_(x))):
        copy()   # first touch of the host pages
        t0 = time.perf_counter()
        copy()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    want = x.cpu().numpy()
    del pinned
    host_stats = getattr(torch.cuda, "host_memory_stats", None)

    def pinned_bytes():
        return (host_stats().get("allocated_bytes.current")
                if host_stats is not None else None)

    for name in ("as_numpy_first_s", "as_numpy_again_s"):
        t0 = time.perf_counter()
        got = executor_mod.as_numpy(x)
        out[name] = time.perf_counter() - t0
        check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
              "pinned fetch bits", name)
        del got
    before = pinned_bytes()
    held, out["as_numpy_held_s"] = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        held.append(executor_mod.as_numpy(x))
        out["as_numpy_held_s"].append(time.perf_counter() - t0)
    after = pinned_bytes()
    del held
    if before is None or after is None:
        out["pinned_bytes_held"] = "not measured (no host_memory_stats)"
    else:
        out["pinned_bytes_before_held"] = before
        out["pinned_bytes_after_held"] = after
        check(after <= before, "pinned host memory grew with the arrays "
              "the caller holds", before, after)
    return out


def predict_b1_row(torch, fa, dev, src, trg):
    """B1 at this phase's shape, [16, 8, 256, 64] float32 with the
    traffic's lengths, as the Program calls it (q/k/v the [B, T, H, D] ->
    [B, H, T, D] views): the encoder (and cross) attention, not causal
    with kv_lens the source lengths, and the decoder's causal self
    attention with the target lengths.  Against the plain version, then
    the kernel's CUDA-event time, the plain version's, the bound (4*D
    operations a visible pair, or the bytes moved once) and one SDPA
    call over the same keys."""
    import torch.nn.functional as F

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    B, T = src.shape
    scale = 1.0 / FD ** 0.5
    rows = {}
    for case, causal, lens_np in (("encoder", False, word_lens(src)),
                                  ("decoder_causal", True, word_lens(trg))):
        q, k, v, _ = flash_inputs(torch, dev, gen, torch.float32, T, T, B=B)
        lens = torch.as_tensor(lens_np, device=dev)
        mask = (torch.arange(T, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        if causal:
            mask = mask & torch.ones((T, T), dtype=torch.bool,
                                     device=dev).tril()
        with torch.no_grad():
            out, _ = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
            ref, _ = fa._flash_fwd_reference(q, k, v, lens, causal, scale)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(err <= KERNEL_TOL, "predict B1 vs plain", case, err)
            rows[case] = {
                "shape": [B, FH, T, FD], "causal": causal,
                "kv_lens_mean": float(lens_np.mean()), "max_abs_err": err,
                "ms": time_ms(lambda: fa._flash_fwd_cuda(
                    q, k, v, lens, causal, scale), 20, flush),
                "plain_ms": time_ms(lambda: fa._flash_fwd_reference(
                    q, k, v, lens, causal, scale), 5, flush),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), 20, flush),
                "bound": flash_bounds(lens_np, T, T, causal, 4)[0]}
    return rows


def first_moving_op(torch, fluid, dirname, src, trg, block_rows=None):
    """Where a request's bits move between buckets (ROADMAP F-6, A13's
    first step): the saved Program run on the card once on the first
    request alone (its 2 rows, bucket 2) and once on 16 rows that start
    with it (bucket 16), every op's outputs fetched.  Each output is
    compared on the request's rows (the leading rows of a batch-major
    tensor, or the whole tensor where the shape does not depend on the
    batch); returns the ops in Program order whose outputs differ there,
    the first one first, with its type, output, shape and max abs
    difference.  ``block_rows`` is the executor's (the serving Program
    backend runs with SERVING_BLOCK_ROWS)."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.block_rows = block_rows
    with fluid.scope_guard(fluid.Scope()):
        prog, _, _ = fluid.io.load_inference_model(dirname, exe)
        ops = prog.global_block().ops
        # dropout gives no Mask for test
        names = list(dict.fromkeys(
            n for op in ops for slot, ns in op.outputs.items() for n in ns
            if not (op.type == "dropout" and slot == "Mask")))
        runs = []
        for rows in (2, 16):
            feed = predict_feed(src[:rows], trg[:rows])
            while True:
                try:
                    with torch.no_grad():
                        out = exe.run(prog, feed=feed, fetch_list=names,
                                      return_numpy=False,
                                      use_program_cache=False)
                    break
                except KeyError as exc:   # an output its rule leaves out
                    missing = re.search(r"fetch target '([^']+)'",
                                        str(exc))
                    check(missing is not None, "first_moving_op", str(exc))
                    names.remove(missing.group(1))
            runs.append(dict(zip(names, out)))
    alone, coalesced = runs
    moved, seen, incomparable = [], set(), 0
    for i, op in enumerate(ops):
        for n in (n for ns in op.outputs.values() for n in ns):
            if (n in seen or n not in alone
                    or not isinstance(alone[n], torch.Tensor)):
                continue
            seen.add(n)
            a, c = alone[n], coalesced[n]
            if a.shape != c.shape:
                if (a.dim() != c.dim() or a.shape[1:] != c.shape[1:]
                        or c.shape[0] != 8 * a.shape[0]):
                    incomparable += 1
                    continue
                c = c[:a.shape[0]]
            if not torch.equal(a, c):
                diff = (a.double() - c.double()).abs().max().item() if (
                    a.is_floating_point()) else None
                moved.append({"index": i, "type": op.type, "output": n,
                              "shape": list(a.shape), "max_abs": diff})
    del runs, alone, coalesced
    torch.cuda.empty_cache()
    return {"ops": len(ops), "outputs_compared": len(seen) - incomparable,
            "incomparable": incomparable, "moved": len(moved),
            "first": moved[0] if moved else None,
            "moved_types": sorted({m["type"] for m in moved}),
            "first_ten": moved[:10]}


def alone_vs_coalesced(eng, reqs, obs, name):
    """Each 2-row request of ``reqs`` alone (bucket 2) against the same
    request coalesced with the next ones into one dispatch at each larger
    bucket: the max abs difference by bucket (0.0: bitwise)."""
    alone = [eng.predict(r, timeout=600)[0] for r in reqs]
    diff = {}
    for b in PREDICT_BUCKETS[1:]:
        c0 = bucket_counts(obs)
        futs = [eng.predict_async(r) for r in reqs[:b // 2]]
        got = [f.result(timeout=600)[0] for f in futs]
        moved = {k: v - c0[k] for k, v in bucket_counts(obs).items()}
        check(moved == {k: int(k == b) for k in PREDICT_BUCKETS},
              "one dispatch at bucket %d" % b, name, moved)
        diff[b] = max(float(np.abs(g - a).max())
                      for g, a in zip(got, alone))
    return diff


def save_mlp_model(fluid, dirname, seed):
    """The one-row model (MLP_SIZES over 784 pixels), seeded on the card,
    saved with ``aot=True``."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        h = fluid.layers.data(name="img", shape=[784], dtype="float32")
        for i, size in enumerate(MLP_SIZES):
            h = fluid.layers.fc(h, size=size, act="softmax" if i == len(
                MLP_SIZES) - 1 else "relu")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, ["img"], [h], exe,
                                      main_program=main, aot=True)


def one_row_check(torch, fluid, serving, obs, dev, dirname):
    """F-6 for samples of one row (the MLP): on both backends each 2-row
    request alone against the same request coalesced at buckets 4, 8 and
    16 (PREDICT_BATCH_TOL), and the AOT graph against the Program at
    every bucket (bitwise); the card against the port's plain CPU path
    (KERNEL_TOL); the alone-against-coalesced difference of an engine
    that runs one product a mul recorded beside (what the blocks
    repair)."""
    save_mlp_model(fluid, dirname, SEED + 53)
    x = np.random.RandomState(SEED + 54).rand(16, 784).astype(np.float32)
    reqs = [{"img": x[i:i + 2]} for i in range(0, 16, 2)]
    engines = {name: predict_engine(serving, dirname, dev, backend=name,
                                    max_batch_size=16, batch_timeout_ms=100)
               for name in ("program", "aot")}
    try:
        outs = {name: [eng.predict({"img": x[:b]}, timeout=600)[0]
                       for b in PREDICT_BUCKETS]
                for name, eng in engines.items()}
        aot_bitwise = all(a.tobytes() == p.tobytes() for a, p in
                          zip(outs["aot"], outs["program"]))
        diff = {name: alone_vs_coalesced(eng, reqs, obs, name)
                for name, eng in engines.items()}
        engines["program"]._model._exe.block_rows = None
        one_product = alone_vs_coalesced(engines["program"], reqs, obs,
                                         "one product")
    finally:
        for eng in engines.values():
            eng.stop()
    cpu_model = serving.ModelStore(place="cpu").load(dirname, "program")
    cpu = cpu_model.predict_batch({"img": x})[0]
    cpu_model.close()
    card = outs["program"][-1]
    card_vs_cpu = float(np.abs(card - cpu).max())
    out = {"model": "MLP 784-%s, f32" % "-".join(map(str, MLP_SIZES)),
           "aot_vs_program_bitwise": aot_bitwise,
           "batched_vs_alone_max_abs": diff,
           "one_product_batched_vs_alone_max_abs": one_product,
           "card_vs_cpu_max_abs": card_vs_cpu}
    log("predict, one-row model (F-6): %s" % json.dumps(out))
    check(card.shape == (16, MLP_SIZES[-1]) and np.isfinite(card).all()
          and card_vs_cpu <= KERNEL_TOL, "one-row model card vs cpu",
          card_vs_cpu)
    check(aot_bitwise, "one-row model: aot vs program not bitwise")
    check(all(v <= PREDICT_BATCH_TOL for d in diff.values()
              for v in d.values()), "one-row model: batched vs alone", diff)
    return out


def predict_phase(torch, fluid, T, serving, fa, obs, dev):
    """Predict serving of Transformer-base scoring (the forward that
    ``get_model(use_flash=True)`` prunes to its logits) at TRAIN_CFG's
    width, saved by ``io.save_inference_model(..., aot=True)`` into a
    temporary directory and served by InferenceEngine(model_dir=...) on
    the card.  Checks: card vs the port's plain CPU path on two rows
    (LOGIT_TOL); the AOT graph against the Program at every bucket
    (bitwise); B1 = 18 launches a dispatch on each backend and
    no other kernel; the all-pad warm-up feed gives finite logits at
    every bucket; each request alone (bucket 2) against the same request
    coalesced into buckets 4, 8 and 16 on each backend (within
    PREDICT_BATCH_TOL, 0 = bitwise); a hot swap under 4 client threads answers every request
    with exactly one version's bits at the same bucket.  Then the load
    (PREDICT_REQUESTS requests of 1-4 rows from 8 clients: requests/s,
    rows/s, latency, the bucket histogram, peak memory, a profiled
    window), batching off against on (batch-1 clients), and B1's row at
    [16, 8, 256, 64] (PERF.md row 1S).  The Program backend's dispatches
    are CUDA-graph replays: the warm-up captures one graph a bucket, and
    the load captures none; the logits come back through pinned memory
    (logits_d2h)."""
    import shutil
    import tempfile

    from paddle_tpu_torch import executor as executor_mod

    resident = resident_gib(torch, dev)
    vocab, seq = TRAIN_CFG["trg_vocab_size"], TRAIN_CFG["seq_len"]
    # host seconds of each step of the phase, in order
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    tmp = tempfile.mkdtemp(prefix="predict_")
    try:
        d1, d2 = os.path.join(tmp, "v1"), os.path.join(tmp, "v2")
        save_s = save_predict_model(fluid, T, d1, SEED + 50, aot=True)
        save_program_s = save_predict_model(fluid, T, d2, SEED + 51,
                                            aot=False)
        torch.cuda.empty_cache()
        lap("save_v1_v2")
        rng = np.random.RandomState(SEED + 52)
        src, trg = predict_rows(rng, 16, seq, vocab)
        x2 = predict_feed(src[:2], trg[:2])

        # 1. the card (Program backend) against the plain CPU path
        t0 = time.perf_counter()
        prog = predict_engine(serving, d1, dev, backend="program",
                              max_batch_size=16, batch_timeout_ms=100)
        prog_setup_s = time.perf_counter() - t0
        card2 = prog.predict(x2, timeout=600)[0]
        cpu_model = serving.ModelStore(place="cpu").load(d1, "program")
        cpu2 = cpu_model.predict_batch(x2)[0]
        cpu_model.close()
        del cpu_model
        check(card2.shape == (2, seq, vocab) and np.isfinite(card2).all(),
              "predict logits", card2.shape)
        card_vs_cpu = float(np.abs(card2 - cpu2).max())
        check(card_vs_cpu <= LOGIT_TOL, "predict card vs cpu", card_vs_cpu)
        log("predict: logits card vs cpu (2 x %d tokens): max abs diff %.3g "
            "(tol %g)" % (seq, card_vs_cpu, LOGIT_TOL))
        lap("card_vs_cpu")

        # 2 + 3. the AOT graph against the Program, and each backend's
        # launches (B1 through the custom op, 18 a dispatch)
        t0 = time.perf_counter()
        aot = predict_engine(serving, d1, dev, backend="aot",
                             max_batch_size=16)
        aot_setup_s = time.perf_counter() - t0
        check(aot.health()["backend"] == "aot", aot.health()["backend"])
        backend_launches, outs = {}, {}
        for name, eng in (("program", prog), ("aot", aot)):
            b0 = obs.counter("serving.batches").value
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            outs[name] = [eng.predict(predict_feed(src[:b], trg[:b]),
                                      timeout=600)[0]
                          for b in PREDICT_BUCKETS]
            torch.cuda.synchronize()
            launches = dict(fa.KERNEL_LAUNCHES)
            dispatches = obs.counter("serving.batches").value - b0
            predict_launch_check(fa, launches, dispatches, name)
            backend_launches[name] = {"dispatches": dispatches,
                                      "launches": launches}
        aot_diff = max(float(np.abs(a - p).max())
                       for a, p in zip(outs["aot"], outs["program"]))
        aot_bitwise = all(a.tobytes() == p.tobytes()
                          for a, p in zip(outs["aot"], outs["program"]))
        log("predict: AOT vs Program on the card (buckets %s): %s, "
            "max abs diff %.3g; launches %s"
            % (list(PREDICT_BUCKETS), "bitwise" if aot_bitwise
               else "NOT bitwise", aot_diff, json.dumps(backend_launches)))
        # F-6: both backends multiply in the same blocks
        check(aot_bitwise, "aot vs program not bitwise", aot_diff)
        lap("aot_vs_program")

        # 4. the all-pad warm-up feed (kv_lens 0 in every row) at every
        # bucket gives finite logits
        for b in PREDICT_BUCKETS:
            zeros = np.zeros((b, seq), np.int64)
            pad_out = prog.predict(predict_feed(zeros, zeros),
                                   timeout=600)[0]
            check(np.isfinite(pad_out).all(), "all-pad logits", b)
        lap("all_pad")

        # 5. each request alone (bucket 2) against the same request
        # coalesced into one dispatch at buckets 4, 8 and 16
        # on both backends (F-6: the AOT graph multiplies in the Program
        # backend's blocks)
        reqs = [predict_feed(src[i:i + 2], trg[i:i + 2])
                for i in range(0, 16, 2)]
        batch_diff = {name: alone_vs_coalesced(eng, reqs, obs, name)
                      for name, eng in (("program", prog), ("aot", aot))}
        batch_bitwise = all(v == 0.0 for d in batch_diff.values()
                            for v in d.values())
        log("predict: alone (bucket 2) vs coalesced, max abs diff by "
            "backend and bucket %s (%s; PREDICT_BATCH_TOL %g)"
            % (json.dumps(batch_diff),
               "bitwise" if batch_bitwise else "NOT bitwise",
               PREDICT_BATCH_TOL))
        check(all(v <= PREDICT_BATCH_TOL for d in batch_diff.values()
                  for v in d.values()), "batched vs alone", batch_diff)
        prog.stop()
        aot.stop()
        del prog, aot
        lap("batched_vs_alone")
        moving = first_moving_op(torch, fluid, d1, src, trg)
        log("predict: first op whose bits move from bucket 2 to bucket 16, "
            "one product a mul (F-6): %s" % json.dumps(moving))
        moving_blocked = first_moving_op(torch, fluid, d1, src, trg,
                                         fluid.executor.SERVING_BLOCK_ROWS)
        log("predict: the same, each mul in blocks of %d rows in one "
            "batched product, as the engine runs it: %s"
            % (fluid.executor.SERVING_BLOCK_ROWS,
               json.dumps(moving_blocked)))
        lap("first_moving_op")
        one_row_model = one_row_check(torch, fluid, serving, obs, dev,
                                      os.path.join(tmp, "mlp"))
        lap("one_row_model")

        # 6. hot swap under load: one bucket (4), so each request's
        # reference is its own row at the bucket it is served at; 8 rows,
        # each sent twice
        swap_feeds = [predict_feed(src[i:i + 1], trg[i:i + 1])
                      for i in range(8)]
        ref2 = predict_engine(serving, d2, dev, batch_buckets=(4,),
                              backend="program")
        want2 = [ref2.predict(f, timeout=600)[0] for f in swap_feeds]
        ref2.stop()
        swap = predict_engine(serving, d1, dev, batch_buckets=(4,),
                              backend="program")
        want1 = [swap.predict(f, timeout=600)[0] for f in swap_feeds]
        v1 = swap.model_version
        results = [None] * (2 * len(swap_feeds))

        def swap_client(idx):
            for i in idx:
                results[i] = swap.predict(swap_feeds[i % 8],
                                          timeout=600)[0]

        clients = [threading.Thread(target=swap_client,
                                    args=(range(t, len(results), 4),))
                   for t in range(4)]
        for t in clients:
            t.start()
        v2 = swap.swap_model(d2)
        for t in clients:
            t.join(timeout=900)
        check(not any(t.is_alive() for t in clients), "swap clients hung")
        served = {"v1": 0, "v2": 0}
        for i, r in enumerate(results):
            check(r is not None, "request %d dropped across the swap" % i)
            hits = [k for k, w in (("v1", want1[i % 8]),
                                   ("v2", want2[i % 8]))
                    if r.tobytes() == w.tobytes()]
            check(len(hits) == 1, "request %d matches %s" % (i, hits))
            served[hits[0]] += 1
        after = swap.predict(swap_feeds[0], timeout=600)[0]
        check(v2 > v1 and swap.model_version == v2 and swap.ready()
              and after.tobytes() == want2[0].tobytes(),
              "after the swap the engine serves v2")
        swap.stop()
        del swap, ref2
        log("predict: hot swap v%d -> v%d under 4 clients: %d requests "
            "answered, %s" % (v1, v2, len(results), json.dumps(served)))
        lap("hot_swap")

        # 7. the load (the main path: counts from 0 here, read after)
        load = predict_engine(serving, d1, dev, backend="program",
                              batch_timeout_ms=2)
        sizes = rng.randint(1, 5, size=PREDICT_REQUESTS)
        load_feeds = [predict_feed(*predict_rows(rng, int(n), seq, vocab))
                      for n in sizes]
        c0, b0 = bucket_counts(obs), obs.counter("serving.batches").value
        compiles0 = executor_mod.compile_count()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.reset_launch_counts()
        outs, lat, wall = serve_clients(load, load_feeds, 8)
        torch.cuda.synchronize()
        launches = dict(fa.KERNEL_LAUNCHES)
        load_compiles = executor_mod.compile_count() - compiles0
        # the warm-up ran each bucket twice: eager, then a capture; the
        # load replays those graphs and captures none
        graphed = {b.static_feeds["src_word"].shape[0]: b.pool_bytes
                   for b in load._model._exe._bound.values()
                   if b.graph is not None}
        graphs = sorted(graphed)
        check(graphs == sorted(PREDICT_BUCKETS) and load_compiles == 0,
              "one graph a bucket, none captured under load", graphs,
              load_compiles)
        peak = torch.cuda.max_memory_allocated(dev)
        dispatches = obs.counter("serving.batches").value - b0
        histogram = {k: v - c0[k] for k, v in bucket_counts(obs).items()}
        predict_launch_check(fa, launches, dispatches, "predict load")
        for f, o in zip(load_feeds, outs):
            check(o.shape == (f["src_word"].shape[0], seq, vocab)
                  and np.isfinite(o).all(), "load logits", o.shape)
        rows = int(sizes.sum())
        lap("load")
        # F-6's fix (one batched product of 256-row blocks a mul)
        # against one product a mul (the engine's executor with its blocks
        # switched off): the same load, in turns
        blocks_ab = {"blocks": [], "one_product": []}
        for tag in ("blocks", "one_product", "one_product", "blocks"):
            eng = predict_engine(serving, d1, dev, backend="program",
                                 batch_timeout_ms=2)
            if tag == "one_product":
                eng._model._exe.block_rows = None
            _, _, ab_wall = serve_clients(eng, load_feeds, 8)
            eng.stop()
            blocks_ab[tag].append(PREDICT_REQUESTS / ab_wall)
        del eng
        lap("blocks_ab")
        profile = profile_predict(torch, load, load_feeds[:16])
        lap("profile")
        # scenario 5 of the JAX package's gate, recorded: batch-1 clients
        # with batching on (this engine) and off (max_batch_size 1)
        one_row = [predict_feed(src[i % 16:i % 16 + 1],
                                trg[i % 16:i % 16 + 1])
                   for i in range(PREDICT_BATCH1_REQUESTS)]
        _, _, on_wall = serve_clients(load, one_row, 8)
        load.stop()
        del load
        off = predict_engine(serving, d1, dev, batch_buckets=(2,),
                             max_batch_size=1, backend="program")
        _, _, off_wall = serve_clients(off, one_row, 8)
        off.stop()
        del off
        lap("batching_off")
        stats = {
            "model": "Transformer-base scoring (6+6 layers, d_model 512, "
                     "vocab %d, %d tokens), f32, TF32 off" % (vocab, seq),
            "save_s_with_export": save_s,
            "save_s_program_only": save_program_s,
            "logits_d2h": logits_d2h(torch, dev, vocab, seq),
            "program_engine_setup_s":
            prog_setup_s, "aot_engine_setup_s": aot_setup_s,
            "card_vs_cpu_max_abs": card_vs_cpu,
            "aot_vs_program_bitwise": aot_bitwise,
            "aot_vs_program_max_abs": aot_diff,
            "backend_launches": backend_launches,
            "batched_vs_alone_max_abs": batch_diff,
            "batched_vs_alone_bitwise": batch_bitwise,
            "first_moving_op": moving["first"],
            "first_moving_op_blocked": moving_blocked["first"],
            "one_row_model": one_row_model,
            "swap_served": served,
            "requests": PREDICT_REQUESTS, "rows": rows, "wall_s": wall,
            "requests_per_s": PREDICT_REQUESTS / wall,
            "requests_per_s_blocks_vs_one_product": blocks_ab,
            "rows_per_s": rows / wall,
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "latency_p95_ms": float(np.percentile(lat, 95) * 1e3),
            "dispatches": dispatches, "bucket_histogram": histogram,
            "graphs_by_bucket": graphs, "captures_under_load": load_compiles,
            "graph_pool_gib_by_bucket": {
                b: v / 2 ** 30 for b, v in sorted(graphed.items())},
            "peak_memory_gib": peak / 2 ** 30,
            "resident_before_gib": resident, "launches": launches,
            "profile": profile,
            "batch1_requests_per_s_batched":
            PREDICT_BATCH1_REQUESTS / on_wall,
            "batch1_requests_per_s_unbatched":
            PREDICT_BATCH1_REQUESTS / off_wall,
            "batching_speedup": off_wall / on_wall}
        log("predict serving: " + json.dumps(stats))
        stats["b1"] = predict_b1_row(torch, fa, dev, src, trg)
        lap("b1_row")
        stats["phase_s"] = laps
        log("predict phase seconds: " + json.dumps(laps))
        for case, r in stats["b1"].items():
            log("predict B1 %s %s: err %.3g, kernel %.4f ms plain %.4f ms "
                "sdpa %.4f ms bound %.4f ms (%s), kv_lens mean %.1f"
                % (case, r["shape"], r["max_abs_err"], r["ms"],
                   r["plain_ms"], r["library_ms"], r["bound"][0],
                   r["bound"][1], r["kv_lens_mean"]))
        return stats
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def synthetic_mnist(n, seed):
    """``n`` seeded (image [1, 28, 28] float32, label) samples, each label
    the argmax of a fixed random linear teacher over the image."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 28, 28).astype(np.float32)
    w = np.random.RandomState(1234).randn(784, 10).astype(np.float32)
    y = np.argmax((x.reshape(n, 784) - 0.5) @ w, axis=1)
    return [(x[i], int(y[i])) for i in range(n)]


def lenet_phase(torch, fluid, dev):
    """MNIST LeNet (models.mnist.get_model: conv 5x5x20, pool 2, conv
    5x5x50, pool 2, fc 10 softmax, Adam 1e-3) at batch LENET_BATCH, f32
    with TF32 off.  One step on the card against the port's CPU path from
    one set of numpy parameters (loss LENET_LOSS_RTOL relative, each
    gradient LENET_GRAD_RTOL of its max |g|), and the same step with TF32
    on as a control that must exceed them; then LENET_STEPS steps on the
    card through
    Executor.run(startup) and Executor.run(main), fed by DataFeeder each
    step with one batch of seeded synthetic images: every loss finite,
    every parameter moved, the last loss under 0.9 of the first (the net
    fits the batch; fresh batches of this teacher move the loss too
    little in 20 steps to show); step ms from the third step on (the
    first runs eager, the second captures the CUDA graph, the rest are
    replays) against LENET_EAGER_STEPS steps run op by op
    (``use_program_cache=False``) in images/s; a replay profiled for its
    busy and idle time, and an eager step by kernel family."""
    from paddle_tpu_torch.models import mnist

    resident = resident_gib(torch, dev)
    with fluid.unique_name.guard():
        m = mnist.get_model(batch_size=LENET_BATCH)
    m["startup"].random_seed = SEED + 30
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(m["startup"], scope=cpu_scope)
    state = {n: cpu_scope[n].numpy() for n in m["main"].persistable_names()
             if n in cpu_scope}
    batch = synthetic_mnist(LENET_BATCH, SEED + 31)
    grads = [p.name + "@GRAD"
             for p in m["main"].global_block().all_parameters()]
    fetch = [m["loss"]] + grads

    def card_step(tf32):
        card_scope = fluid.Scope()
        fluid.load_numpy_state(m["main"], state, scope=card_scope,
                               device=dev)
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return fluid.Executor(fluid.CUDAPlace(0)).run(
                m["main"], feed=fluid.DataFeeder(
                    m["feeds"], fluid.CUDAPlace(0),
                    program=m["main"]).feed(batch),
                fetch_list=fetch, scope=card_scope)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    def errors(card):
        """(loss error relative, worst gradient error of its max |g|)."""
        loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
        worst = 0.0
        for name, g, r in zip(grads, card[1:], cpu[1:]):
            check(g.shape == r.shape and np.isfinite(g).all(), name)
            rel = float(np.abs(g - r).max()) / float(np.abs(r).max())
            worst = max(worst, rel)
        return loss_err, worst

    cpu = fluid.Executor(fluid.CPUPlace()).run(
        m["main"], feed=fluid.DataFeeder(m["feeds"], fluid.CPUPlace(),
                                         program=m["main"]).feed(batch),
        fetch_list=fetch, scope=cpu_scope)
    card = card_step(tf32=False)
    loss_err, worst = errors(card)
    check(np.isfinite(float(card[0])) and loss_err <= LENET_LOSS_RTOL,
          "lenet card vs cpu loss", float(card[0]), float(cpu[0]), loss_err)
    check(worst <= LENET_GRAD_RTOL, "lenet card vs cpu gradient", worst)
    # the control: the same step with TF32 convolutions and GEMMs must
    # fail the limits, or they could not tell TF32 from float32
    tf32_loss_err, tf32_worst = errors(card_step(tf32=True))
    check(tf32_loss_err > LENET_LOSS_RTOL or tf32_worst > LENET_GRAD_RTOL,
          "lenet limits pass a TF32 step", tf32_loss_err, tf32_worst)
    del cpu_scope

    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(m["startup"], scope=scope)
    params = [p.name for p in m["main"].global_block().all_parameters()]
    before = {p: scope[p].clone() for p in params}
    feeder = fluid.DataFeeder(m["feeds"], fluid.CUDAPlace(0),
                              program=m["main"])
    batches = [synthetic_mnist(LENET_BATCH, SEED + 40)] * LENET_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, accs, step_s = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        loss, acc = exe.run(m["main"], feed=feeder.feed(b),
                            fetch_list=[m["loss"], m["acc"]], scope=scope)
        # reading a lazy fetch waits for the step
        losses.append(float(loss[0]))
        accs.append(float(acc[0]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)), "lenet non-finite loss", losses)
    for p in params:
        check(bool(torch.isfinite(scope[p]).all()), "lenet non-finite", p)
        check(not torch.equal(scope[p], before[p]), "lenet param still", p)
    check(losses[-1] < 0.9 * losses[0], "lenet loss did not fall", losses)
    steady = steady_ms(step_s) / 1e3
    graphed = profile_graphed(torch, exe, m, feeder.feed(batches[0]), scope,
                              [m["loss"], m["acc"]])
    # the same steps op by op (use_program_cache=False), against the
    # graph replays above
    eager_s = []
    for b in batches[:LENET_EAGER_STEPS]:
        t0 = time.perf_counter()
        loss, = exe.run(m["main"], feed=feeder.feed(b),
                        fetch_list=[m["loss"]], scope=scope,
                        use_program_cache=False)
        eager_s.append(time.perf_counter() - t0)
        check(np.isfinite(float(loss[0])), "lenet eager loss")
    eager = float(np.mean(eager_s[1:]))
    profile = profile_step(torch, exe, m, feeder.feed(batches[0]), scope)
    stats = {"batch": LENET_BATCH, "steps": LENET_STEPS,
             "loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
             "loss_rel_err": loss_err, "grads": len(grads),
             "worst_grad_err_of_max": worst,
             "tf32_control_loss_rel_err": tf32_loss_err,
             "tf32_control_worst_grad_err_of_max": tf32_worst,
             "first_step_ms": step_s[0] * 1e3,
             "capture_step_ms": step_s[1] * 1e3, "step_ms": steady * 1e3,
             "step_ms_all": [t * 1e3 for t in step_s],
             "images_per_s": LENET_BATCH / steady,
             "eager_step_ms": eager * 1e3,
             "eager_images_per_s": LENET_BATCH / eager,
             "peak_memory_gib": peak / 2 ** 30,
             "resident_before_gib": resident, "losses": losses,
             "accuracies": accs, "graphed_profile": graphed,
             "profile": profile}
    log("lenet (MNIST, batch %d, f32, TF32 off): %s"
        % (LENET_BATCH, json.dumps(stats)))
    return stats


def op_rule_checks(fluid, dev):
    """ROADMAP F-8 and F-9 on the card: ``mean`` of an int64 [4, 5] input
    in [-7, 7] gives float32, the JAX package's bits (its float32 sum
    times the float32 reciprocal of the count); a float32 cast to int32
    and to uint8 saturates, NaN to 0, the JAX package's values."""
    def run(build, feed):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            out = build()
        return fluid.Executor(device=dev).run(
            main, feed=feed, fetch_list=[out], scope=fluid.Scope())[0]

    ints = np.random.RandomState(0).randint(-7, 8, size=(4, 5))
    got = run(lambda: fluid.layers.mean(fluid.layers.data(
        name="x", shape=[4, 5], dtype="int64", append_batch_size=False)),
        {"x": ints})
    want = np.float32(ints.sum()) * np.float32(1.0 / ints.size)
    check(got.dtype == np.float32 and got.shape == (1,)
          and got[0].tobytes() == want.tobytes(), "F-8 mean", got, want)
    x = np.array(CAST_IN, np.float32)
    for dtype, want_cast in CAST_WANT.items():
        got_cast = run(lambda: fluid.layers.cast(fluid.layers.data(
            name="x", shape=[len(CAST_IN)], dtype="float32",
            append_batch_size=False), dtype), {"x": x})
        check(got_cast.dtype == np.dtype(dtype)
              and got_cast.tolist() == want_cast, "F-9 cast", dtype,
              got_cast.tolist())
    log("op rules on the card: mean of int64 %r (float32), cast %s"
        % (float(got[0]), json.dumps(CAST_WANT)))


def resnet_model(fluid, resnet, dtype="float32"):
    with fluid.unique_name.guard():
        return resnet.get_model(dtype=dtype, **RESNET_CFG)


def resnet_images(rng, n):
    """``n`` seeded images (standard normal, as bench.py's) and labels."""
    shape = RESNET_CFG["image_shape"]
    return (rng.randn(n, *shape).astype(np.float32),
            rng.randint(0, RESNET_CFG["class_dim"], size=(n, 1))
            .astype(np.int64))


def resnet_step(torch, fluid, m, state, x, y, dev, tf32=False):
    """One training step of ``m`` on ``dev`` from the numpy ``state``:
    (loss, accuracy, every trainable parameter's gradient, the running
    statistics after the step), as numpy.  ``tf32`` switches TF32 on for
    the step's convolutions and GEMMs."""
    blk = m["main"].global_block()
    grads = [p.name + "@GRAD" for p in blk.all_parameters() if p.trainable]
    stats = [p.name for p in blk.all_parameters() if not p.trainable]
    dtype = getattr(torch, str(blk.var("data").dtype))
    scope = fluid.Scope()
    fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = fluid.Executor(device=dev).run(
            m["main"], feed={"data": torch.as_tensor(x).to(dtype),
                             "label": y},
            fetch_list=[m["loss"], m["acc"]] + grads, scope=scope)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return {"loss": float(out[0][0]), "acc": float(out[1][0]),
            "grads": dict(zip(grads, out[2:])),
            "stats": {n: fluid.executor.as_numpy(scope[n]) for n in stats}}


def resnet_errors(a, ref):
    """``a``'s step against ``ref``'s: the loss relative, each gradient's
    and statistic's max error of its tensor's max, fc_0's gradients
    apart, all gradients' L2 distance of their L2 norm, the accuracy."""
    per = {n: float(np.abs(g - ref["grads"][n]).max())
           / float(np.abs(ref["grads"][n]).max()) for n, g in a["grads"].items()}
    num = sum(float(np.sum((g - ref["grads"][n]) ** 2))
              for n, g in a["grads"].items())
    den = sum(float(np.sum(g ** 2)) for g in ref["grads"].values())
    worst = max(per, key=per.get)
    return {"loss_rel": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_worst_of_max": per[worst], "grad_worst": worst,
            "fc_grad_worst_of_max": max(v for n, v in per.items()
                                        if n.startswith("fc_0.")),
            "grad_global_l2": (num / den) ** 0.5,
            "stat_worst_of_max": max(
                float(np.abs(v - ref["stats"][n]).max())
                / float(np.abs(ref["stats"][n]).max())
                for n, v in a["stats"].items()),
            "acc_equal": a["acc"] == ref["acc"]}


def resnet_f32_ok(e):
    return (e["loss_rel"] <= LOSS_RTOL and e["fc_grad_worst_of_max"]
            <= GRAD_RTOL and e["grad_global_l2"] <= RESNET_GLOBAL_L2
            and e["stat_worst_of_max"] <= RESNET_STAT_RTOL)


def resnet_check(torch, fluid, resnet, dev):
    """One training step at full width, batch RESNET_CHECK_BATCH, from one
    set of numpy parameters, on the card and on the port's CPU path:
    in float64, the loss (LOSS_RTOL), every gradient (GRAD_RTOL of its
    max |g|), the running statistics (RESNET_STAT_RTOL) and the
    accuracy; in float32 (TF32 off), the card and the CPU each against
    the CPU's float64 step, by resnet_f32_ok; and the float32 step with
    TF32 on, which must fail resnet_f32_ok."""
    m32, m64 = (resnet_model(fluid, resnet, d) for d in ("float32",
                                                          "float64"))
    m32["startup"].random_seed = SEED + 60
    cpu = torch.device("cpu")
    scope = fluid.Scope()
    fluid.Executor(device=cpu).run(m32["startup"], scope=scope)
    state = {n: scope[n].numpy() for n in m32["main"].persistable_names()
             if n in scope}
    del scope
    x, y = resnet_images(np.random.RandomState(SEED + 61),
                         RESNET_CHECK_BATCH)
    t0 = time.perf_counter()
    cpu64 = resnet_step(torch, fluid, m64, state, x, y, cpu)
    cpu32 = resnet_step(torch, fluid, m32, state, x, y, cpu)
    cpu_s = time.perf_counter() - t0
    card64 = resnet_step(torch, fluid, m64, state, x, y, dev)
    card32 = resnet_step(torch, fluid, m32, state, x, y, dev)
    tf32 = resnet_step(torch, fluid, m32, state, x, y, dev, tf32=True)
    e64 = resnet_errors(card64, cpu64)
    check(e64["loss_rel"] <= LOSS_RTOL and e64["grad_worst_of_max"]
          <= GRAD_RTOL and e64["stat_worst_of_max"] <= RESNET_STAT_RTOL
          and e64["acc_equal"], "resnet float64 card vs cpu", e64)
    out = {"float64_card_vs_cpu": e64,
           "float32_card_vs_cpu64": resnet_errors(card32, cpu64),
           "float32_cpu_vs_cpu64": resnet_errors(cpu32, cpu64),
           "float32_card_vs_cpu32": resnet_errors(card32, cpu32),
           "tf32_card_vs_cpu64": resnet_errors(tf32, cpu64),
           "loss": {"cpu64": cpu64["loss"], "card64": card64["loss"],
                    "cpu32": cpu32["loss"], "card32": card32["loss"],
                    "tf32": tf32["loss"]},
           "cpu_steps_s": cpu_s}
    check(resnet_f32_ok(out["float32_card_vs_cpu64"])
          and out["float32_card_vs_cpu32"]["acc_equal"],
          "resnet float32 card vs cpu", out["float32_card_vs_cpu64"])
    check(resnet_f32_ok(out["float32_cpu_vs_cpu64"]),
          "resnet float32 cpu vs cpu float64", out["float32_cpu_vs_cpu64"])
    check(not resnet_f32_ok(out["tf32_card_vs_cpu64"]),
          "resnet limits pass a TF32 step", out["tf32_card_vs_cpu64"])
    log("resnet-50 card vs cpu (batch %d, %s): %s"
        % (RESNET_CHECK_BATCH, RESNET_CFG, json.dumps(out)))
    return out


def resnet_bf16_state(torch, fluid, resnet, seed):
    """A bf16 ResNet-50's startup state (bf16 parameters and statistics,
    float32 velocities) as CPU tensors, with its bf16 and float64
    models."""
    mbf, m64 = (resnet_model(fluid, resnet, d) for d in ("bfloat16",
                                                          "float64"))
    mbf["startup"].random_seed = seed
    scope = fluid.Scope()
    fluid.Executor(device=torch.device("cpu")).run(mbf["startup"],
                                                   scope=scope)
    state = {n: scope[n] for n in mbf["main"].persistable_names()
             if n in scope}
    return mbf, m64, state


def bf16_within(e, ref):
    """A bf16 step's errors ``e`` against the CPU float64 step, held to
    RESNET_BF16_FACTOR times the CPU bf16 step's ``ref`` in the loss,
    fc_0's gradients and the statistics (the loss also to
    RESNET_BF16_LOSS_RTOL, the statistics to one bf16 rounding,
    BF16_ROUNDING): the names of the measures that miss, empty when all
    hold.  All gradients' L2 distance is not held (see
    RESNET_BF16_FACTOR)."""
    floors = {"loss_rel": RESNET_BF16_LOSS_RTOL,
              "stat_worst_of_max": BF16_ROUNDING,
              "fc_grad_worst_of_max": 0.0}
    return [k for k, floor in floors.items()
            if e[k] > max(RESNET_BF16_FACTOR * ref[k], floor)]


@contextlib.contextmanager
def reduced_precision_reduction(torch):
    """A control run on PyTorch's own bf16 setting: the port's
    ``f32_bf16_reduction`` made a no-op where the executor and
    program_to_fn call it (a seam of this script, not an option of the
    port) and cuBLAS's reduced-precision bf16 reduction on; all restored
    after."""
    from paddle_tpu_torch import executor, program_fn

    matmul = torch.backends.cuda.matmul
    saved = (executor.f32_bf16_reduction, program_fn.f32_bf16_reduction,
             matmul.allow_bf16_reduced_precision_reduction)
    executor.f32_bf16_reduction = program_fn.f32_bf16_reduction = (
        lambda device: contextlib.nullcontext())
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        yield
    finally:
        (executor.f32_bf16_reduction, program_fn.f32_bf16_reduction,
         matmul.allow_bf16_reduced_precision_reduction) = saved


def resnet_bf16_check(torch, fluid, resnet, dev):
    """One bf16 training step at full width, batch RESNET_CHECK_BATCH,
    from one bf16 state, on the card and on the port's CPU path, each
    held against the CPU's float64 step from the same state widened
    (bf16_within), with cuBLAS's bf16 reduction in float32 (the port's
    setting); the card's step with PyTorch's reduced-precision reduction
    is recorded beside it."""
    mbf, m64, state = resnet_bf16_state(torch, fluid, resnet, SEED + 66)
    x, y = resnet_images(np.random.RandomState(SEED + 67),
                         RESNET_CHECK_BATCH)
    x = torch.as_tensor(x).to(torch.bfloat16).float().numpy()  # bf16 images
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cpu64 = resnet_step(torch, fluid, m64, state, x, y, cpu)
    cpubf = resnet_step(torch, fluid, mbf, state, x, y, cpu)
    cpu_s = time.perf_counter() - t0
    cardbf = resnet_step(torch, fluid, mbf, state, x, y, dev)
    with reduced_precision_reduction(torch):
        reduced = resnet_step(torch, fluid, mbf, state, x, y, dev)
    out = {"cpu_bf16_vs_cpu64": resnet_errors(cpubf, cpu64),
           "card_bf16_vs_cpu64": resnet_errors(cardbf, cpu64),
           "card_bf16_reduced_reduction_vs_cpu64":
           resnet_errors(reduced, cpu64),
           "card_bf16_vs_cpu_bf16": resnet_errors(cardbf, cpubf),
           "loss": {"cpu64": cpu64["loss"], "cpu_bf16": cpubf["loss"],
                    "card_bf16": cardbf["loss"],
                    "card_bf16_reduced_reduction": reduced["loss"]},
           "factor": RESNET_BF16_FACTOR, "cpu_steps_s": cpu_s}
    ref = out["cpu_bf16_vs_cpu64"]
    out["card_ratio_to_cpu"] = {
        k: out["card_bf16_vs_cpu64"][k] / max(ref[k], 1e-30)
        for k in ("loss_rel", "fc_grad_worst_of_max", "grad_global_l2",
                  "stat_worst_of_max")}
    missed = bf16_within(out["card_bf16_vs_cpu64"], ref)
    out["missed_with_reduced_reduction"] = bf16_within(
        out["card_bf16_reduced_reduction_vs_cpu64"], ref)
    log("resnet-50 bf16 card vs cpu (batch %d, against the cpu's float64 "
        "step): %s" % (RESNET_CHECK_BATCH, json.dumps(out)))
    check(np.isfinite(cardbf["loss"]) and not missed,
          "resnet bf16 card vs cpu", missed, out["card_ratio_to_cpu"])
    return out


def resnet_bf16_phase(torch, fluid, fa, dev, f32):
    """bench.py's bf16 ResNet-50 leg (models.resnet.get_model(dtype=
    "bfloat16"), 224 x 224, 1000 classes): the card against the CPU
    (resnet_bf16_check), RESNET_STEPS training steps at batch
    RESNET_BATCH on bf16 images (resnet_train: images/s against the
    bf16 bound, peak memory, device ms by op, idle share), then inference
    at batch RESNET_INFER_BATCH with bf16 state and images, unfolded and
    folded (resnet_infer, against the f32 Program).  ``f32`` is the
    f32 phase's result, logged beside.  No kernel of this repo runs."""
    from paddle_tpu_torch.models import resnet

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = {"check": resnet_bf16_check(torch, fluid, resnet, dev)}
    t1 = time.perf_counter()
    out["train"], m, scope = resnet_train(torch, fluid, resnet, dev,
                                          "bfloat16")
    t2 = time.perf_counter()
    out["infer"] = resnet_infer(torch, fluid, resnet, dev, m, scope,
                                RESNET_INFER_BATCH,
                                resnet_model(fluid, resnet)["test"])
    t3 = time.perf_counter()
    del m, scope
    launches = dict(fa.KERNEL_LAUNCHES)
    check(not any(launches.values()),
          "a kernel launched in the resnet bf16 phase", launches)
    tr = out["train"]
    out["beside_f32"] = {
        "images_per_s": [tr["images_per_s"], f32["train"]["images_per_s"]],
        "share_of_bound": [tr["share_of_bound"],
                           f32["train"]["share_of_bound"]],
        "peak_memory_gib": [tr["peak_memory_gib"],
                            f32["train"]["peak_memory_gib"]],
        "step_ms": [tr["step_ms"], f32["train"]["step_ms"]],
        "inference_images_per_s_unfolded": [
            out["infer"]["images_per_s_unfolded"],
            f32["infer"]["images_per_s_unfolded"]],
        "inference_images_per_s_folded": [
            out["infer"]["images_per_s_folded"],
            f32["infer"]["images_per_s_folded"]]}
    out["phase_s"] = {"check": t1 - t0, "train": t2 - t1, "infer": t3 - t2}
    log("resnet-50 bf16 phase: bf16 beside f32 %s, seconds %s"
        % (json.dumps(out["beside_f32"]), json.dumps(out["phase_s"])))
    return out


RESNET_FAMILIES = {"conv2d": "conv", "batch_norm": "batch_norm",
                   "mul": "gemm"}


def profile_ops(torch, exe, m, feed, scope, fetch, families=None):
    """One run of ``m["main"]`` profiled, its device time by op type, on
    the eager path (``use_program_cache=False``: a CUDA-graph replay runs
    no rule, so it emits no range to attribute time by):
    each rule runs inside a ``record_function`` of its type (the ops of
    a sub-block under their own type), and a backward kernel goes to the
    forward op whose autograd node launched it (the profiler's sequence
    numbers).  Returns the wall time, device busy time, idle share, ms by
    family (``families``, RESNET_FAMILIES by default, the rest "other")
    and by op type; "not measured" without device events."""
    families_of = RESNET_FAMILIES if families is None else families
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch import executor as executor_mod

    rule = executor_mod.get_rule

    def tagged(op_type):
        fn = rule(op_type)

        def run(ctx, op):
            with record_function("op:" + op_type):
                fn(ctx, op)
        return run

    torch.cuda.synchronize()
    executor_mod.get_rule = tagged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exe.run(m["main"], feed=feed, fetch_list=fetch, scope=scope,
                    use_program_cache=False)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        executor_mod.get_rule = rule
    events = prof.events()
    # the device timeline also carries the op: ranges; they are not work
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith("op:")]
    if not device:
        return "not measured (the profiler recorded no device activity)"
    # busy: the union of the device events' intervals (cuDNN may run
    # kernels side by side on its own streams)
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    summed = sum(e.time_range.elapsed_us() for e in device)

    def tag(e):
        while e is not None:
            if e.name.startswith("op:"):
                return e.name[3:]
            e = e.cpu_parent
        return None

    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            t = tag(e)
            if t is not None:
                forward.setdefault(e.sequence_nr, t)

    def owner(e):
        while e is not None:
            if e.name.startswith("op:"):
                return e.name[3:]
            if e.name.startswith("autograd::engine::evaluate_function"):
                return forward.get(e.sequence_nr, "unattributed")
            e = e.cpu_parent
        return "unattributed"

    by_op, linked = {}, {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA or not e.kernels:
            continue
        k = owner(e)
        by_op[k] = by_op.get(k, 0.0) + sum(x.duration for x in e.kernels)
        for x in e.kernels:
            linked[x.name] = linked.get(x.name, 0.0) + x.duration
    # device time the profiler tied to no launching op, by kernel name
    unlinked = {}
    for e in device:
        unlinked[e.name] = (unlinked.get(e.name, 0.0)
                            + e.time_range.elapsed_us())
    unlinked = {k: v - linked.get(k, 0.0) for k, v in unlinked.items()}
    unlinked = dict(sorted(((k[:80], v / 1e3) for k, v in unlinked.items()
                            if v > 1.0), key=lambda kv: -kv[1])[:8])
    families = {}
    for k, v in by_op.items():
        fam = families_of.get(k, "other")
        families[fam] = families.get(fam, 0.0) + v
    return {"path": "eager (use_program_cache=False)",
            "step_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_by_family": {k: v / 1e3 for k, v in families.items()},
            "device_ms_by_op": {k: v / 1e3 for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1])},
            "attributed_ms": sum(by_op.values()) / 1e3,
            "device_events_summed_ms": summed / 1e3,
            "unlinked_ms_by_kernel": unlinked,
            "device_events": len(device)}


def resnet_train(torch, fluid, resnet, dev, dtype="float32"):
    """RESNET_STEPS steps at batch RESNET_BATCH through Executor.run on
    the card, on one seeded batch fed each step (bench.py feeds one
    device-resident batch too), the model and the images in ``dtype``:
    every loss finite, every parameter finite and moved (in bf16: moved,
    or its last update under half its bf16 spacing), the last loss
    under the first, the accuracy above chance at some step, every
    persistable in its declared dtype (in bfloat16: the parameters and
    running statistics bfloat16, the velocities float32, as the JAX
    package's optimizer declares them); step ms (steps 2 on), images/s,
    the share of the bound at ``dtype``'s peak, peak memory, a profiled
    step (eager) and a replay's busy and idle time.  Returns the stats,
    the model and its scope."""
    m = resnet_model(fluid, resnet, dtype)
    m["startup"].random_seed = SEED + 62
    exe = fluid.Executor(device=dev)
    scope = fluid.Scope()
    exe.run(m["startup"], scope=scope)
    blk = m["main"].global_block()
    params = [p.name for p in blk.all_parameters() if p.trainable]
    before = {p: scope[p].clone() for p in params}
    x, y = resnet_images(np.random.RandomState(SEED + 63), RESNET_BATCH)
    feed = {"data": torch.as_tensor(x, device=dev).to(getattr(torch, dtype)),
            "label": torch.as_tensor(y, device=dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, accs, step_s = [], [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        loss, acc = exe.run(m["main"], feed=feed,
                            fetch_list=[m["loss"], m["acc"]], scope=scope)
        # reading a lazy fetch waits for the step
        losses.append(float(loss[0]))
        accs.append(float(acc[0]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)), "resnet non-finite loss", losses)
    unmoved = []
    for p in params:
        check(bool(torch.isfinite(scope[p]).all()), "resnet non-finite", p)
        if torch.equal(scope[p], before[p]):
            unmoved.append(p)
    if dtype == "float32":
        check(not unmoved, "resnet param still", unmoved)
    else:
        # a bf16 parameter takes p - lr * v rounded to bf16: where every
        # element's update stays under half its bf16 spacing it rounds
        # back (batch_norm scales at 1.0 in deep layers), in the JAX
        # package too.  Such a parameter must show it: its last update,
        # lr times its float32 velocity, under half its spacing everywhere
        mom = {op.inputs["Param"][0]: op for op in blk.ops
               if op.type == "momentum"}
        for p in unmoved:
            op = mom[p]
            lr = float(scope[op.inputs["LearningRate"][0]].float().max())
            v = scope[op.inputs["Velocity"][0]].float().abs()
            w = before[p].float().abs().clamp_min(2.0 ** -126)
            spacing = torch.exp2(torch.floor(torch.log2(w)) - 7)
            check(bool((lr * v < spacing / 2).all()),
                  "resnet bf16 param still where its update shows", p)
        check(len(unmoved) < len(params) / 2, "resnet bf16 params still",
              unmoved)
    del before
    check(losses[-1] < losses[0], "resnet loss did not fall", losses)
    check(max(accs) > 1.0 / RESNET_CFG["class_dim"], "resnet accuracy",
          accs)
    dtypes = {}
    for v in m["main"].list_vars():
        if v.persistable and v.name in scope and isinstance(
                scope[v.name], torch.Tensor):
            got = str(scope[v.name].dtype).replace("torch.", "")
            check(got == str(v.dtype), "resnet state dtype", v.name, got,
                  v.dtype)
            kind = ("velocity" if "velocity" in v.name else "parameter"
                    if v.name in params else "other")
            dtypes.setdefault(kind, set()).add(got)
    dtypes = {k: sorted(v) for k, v in dtypes.items()}
    if dtype == "bfloat16":
        check(dtypes["parameter"] == ["bfloat16"]
              and dtypes["velocity"] == ["float32"], "resnet bf16 dtypes",
              dtypes)
    steady = steady_ms(step_s) / 1e3
    images_s = RESNET_BATCH / steady
    peak_flops = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    bound_images_s = peak_flops / RESNET_TRAIN_FLOPS
    graphed = profile_graphed(torch, exe, m, feed, scope,
                              [m["loss"], m["acc"]])
    profile = profile_ops(torch, exe, m, feed, scope, [m["loss"]])
    stats = {"dtype": dtype, "batch": RESNET_BATCH, "steps": RESNET_STEPS,
             "params": len(params),
             "param_values": int(sum(scope[p].numel() for p in params)),
             "state_dtypes": dtypes, "params_unmoved": unmoved,
             "first_step_ms": step_s[0] * 1e3, "step_ms": steady * 1e3,
             "step_ms_all": [t * 1e3 for t in step_s],
             "images_per_s": images_s, "bound_images_per_s": bound_images_s,
             "share_of_bound": images_s / bound_images_s,
             "peak_memory_gib": peak / 2 ** 30, "losses": losses,
             "accuracies": accs, "graphed_profile": graphed,
             "profile": profile}
    log("resnet-50 training (batch %d, 224 x 224, %s, TF32 off): %s"
        % (RESNET_BATCH, dtype, json.dumps(stats)))
    return stats, m, scope


def copy_scope(fluid, scope, names):
    out = fluid.Scope()
    for n in names:
        if n in scope:
            out[n] = scope[n].clone()
    return out


def images_per_s(exe, prog, feed, fetch, scope):
    """The ``prog`` run RESNET_INFER_RUNS times after two warm-up runs
    (the first eager, the second captures the CUDA graph; each run ends
    in the logits' numpy fetch, read at once): (images/s, the last
    logits)."""
    for _ in range(2):
        out = np.asarray(exe.run(prog, feed=feed, fetch_list=fetch,
                                 scope=scope)[0])
    t0 = time.perf_counter()
    for _ in range(RESNET_INFER_RUNS):
        out = np.asarray(exe.run(prog, feed=feed, fetch_list=fetch,
                                 scope=scope)[0])
    dt = (time.perf_counter() - t0) / RESNET_INFER_RUNS
    return len(feed["data"]) / dt, out


def resnet_infer(torch, fluid, resnet, dev, m, scope, batch=RESNET_BATCH,
                 f32_test=None):
    """Folded inference of the trained model's ``test`` Program at
    ``batch``, in the model's dtype (its images too).  Each
    batch_norm's Scale and Bias (found through the
    op's inputs) are set to seeded values in [0.5, 1.5] and [-0.5, 0.5],
    and its Mean and Variance to this batch's statistics under them, so
    that the fold has a scale and a shift to carry in every layer.
    Then: the unfolded logits (the softmax's
    input), the InferenceTranspiler's folded Program's logits (within
    RESNET_FOLD_RTOL of their max; in bf16, where ``f32_test`` is the
    same test Program in float32: no farther from its logits on the same
    state and images than RESNET_BF16_FACTOR times the unfolded bf16
    logits are), save_inference_model(aot=True) of the
    folded Program, loaded and run (within RESNET_FOLD_RTOL of the
    folded Program's logits; bits or the difference stated), images/s of
    each."""
    import shutil
    import tempfile

    test = m["test"]
    dtype = getattr(torch, str(test.global_block().var("data").dtype))
    blk = test.global_block()
    bns = [op for op in blk.ops if op.type == "batch_norm"]
    (logits,) = [op.inputs["X"][0] for op in blk.ops if op.type == "softmax"]
    names = [n for n in m["main"].persistable_names() if n in scope]
    rng = np.random.RandomState(SEED + 64)
    for op in bns:
        for slot, lo, hi in (("Scale", 0.5, 1.5), ("Bias", -0.5, 0.5)):
            n = op.inputs[slot][0]
            scope[n] = torch.as_tensor(rng.uniform(
                lo, hi, tuple(scope[n].shape)).astype(np.float32),
                device=dev).to(scope[n].dtype)
    x, y = resnet_images(np.random.RandomState(SEED + 65), batch)
    feed = {"data": torch.as_tensor(x, device=dev).to(dtype),
            "label": torch.as_tensor(y, device=dev)}
    exe = fluid.Executor(device=dev)
    # the batch statistics under these Scale and Bias: one training
    # forward in a copy of the scope
    probe = copy_scope(fluid, scope, names)
    saved = exe.run(m["main"], feed=feed, scope=probe, fetch_list=[
        op.outputs[s][0] for op in bns for s in ("SavedMean",
                                                 "SavedVariance")],
        return_numpy=False)
    del probe
    for k, op in enumerate(bns):
        scope[op.inputs["Mean"][0]] = saved[2 * k].detach().clone()
        scope[op.inputs["Variance"][0]] = saved[2 * k + 1].detach().clone()
    del saved
    unfolded_ips, unfolded = images_per_s(exe, test, feed, [logits], scope)
    folded = test.clone()
    fscope = copy_scope(fluid, scope, names)
    t0 = time.perf_counter()
    fluid.InferenceTranspiler().transpile(folded, scope=fscope)
    fold_s = time.perf_counter() - t0
    check(not any(op.type == "batch_norm" for op in folded.global_block().ops),
          "a batch_norm left after the fold")
    folded_ips, got = images_per_s(exe, folded, feed, [logits], fscope)
    scale = float(np.abs(unfolded).max())
    fold_diff = float(np.abs(got - unfolded).max())
    check(np.isfinite(got).all() and got.shape == (batch,
                                                   RESNET_CFG["class_dim"]),
          "resnet folded logits", got.shape)
    against_f32 = None
    if f32_test is None:
        check(fold_diff <= RESNET_FOLD_RTOL * scale,
              "resnet folded vs unfolded", fold_diff, scale)
    else:
        ref = exe.run(f32_test, feed={"data": feed["data"].float(),
                                      "label": feed["label"]},
                      fetch_list=[logits],
                      scope=copy_scope(fluid, scope, names))[0]
        against_f32 = {"unfolded_max_abs": float(np.abs(unfolded - ref).max()),
                       "folded_max_abs": float(np.abs(got - ref).max()),
                       "f32_logits_max_abs": float(np.abs(ref).max())}
        check(against_f32["folded_max_abs"] <= RESNET_BF16_FACTOR
              * against_f32["unfolded_max_abs"],
              "resnet bf16 folded vs f32", against_f32)
    tmp = tempfile.mkdtemp(prefix="resnet_")
    try:
        t0 = time.perf_counter()
        with fluid.scope_guard(fscope):
            fluid.io.save_inference_model(tmp, ["data"], [logits], exe,
                                          main_program=folded, aot=True)
        save_s = time.perf_counter() - t0
        predict, feeds, fetches = fluid.io.load_aot_inference_model(
            tmp, device=dev)
        check(feeds == ["data"] and fetches == [logits], feeds, fetches)
        aot = predict({"data": feed["data"]})[0]
        t0 = time.perf_counter()
        for _ in range(RESNET_INFER_RUNS):
            aot = predict({"data": feed["data"]})[0]
        aot_ips = batch / ((time.perf_counter() - t0) / RESNET_INFER_RUNS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    aot_diff = float(np.abs(aot - got).max())
    check(aot_diff <= RESNET_FOLD_RTOL * scale, "resnet aot vs folded",
          aot_diff)
    stats = {"batch": batch, "dtype": str(dtype).replace("torch.", ""),
             "batch_norms_folded": len(bns),
             "logits_max_abs": scale,
             "folded_vs_unfolded_max_abs": fold_diff,
             "folded_vs_unfolded_of_max": fold_diff / scale,
             "against_f32": against_f32,
             "aot_vs_folded_bitwise": aot.tobytes() == got.tobytes(),
             "aot_vs_folded_max_abs": aot_diff,
             "fold_s": fold_s, "save_aot_s": save_s,
             "images_per_s_unfolded": unfolded_ips,
             "images_per_s_folded": folded_ips,
             "images_per_s_aot_folded": aot_ips}
    log("resnet-50 folded inference (batch %d, %s): %s"
        % (batch, stats["dtype"], json.dumps(stats)))
    return stats


def resnet_phase(torch, fluid, fa, dev):
    """ResNet-50 at full width (224 x 224, 1000 classes): card against
    CPU (resnet_check), RESNET_STEPS training steps at batch RESNET_BATCH
    (resnet_train), folded inference (resnet_infer).  No kernel of this
    repo runs: B1-B5 launch 0 times in the phase."""
    from paddle_tpu_torch.models import resnet

    resident = resident_gib(torch, dev)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = {"check": resnet_check(torch, fluid, resnet, dev)}
    t1 = time.perf_counter()
    out["train"], m, scope = resnet_train(torch, fluid, resnet, dev)
    t2 = time.perf_counter()
    out["infer"] = resnet_infer(torch, fluid, resnet, dev, m, scope)
    t3 = time.perf_counter()
    launches = dict(fa.KERNEL_LAUNCHES)
    check(not any(launches.values()), "a kernel launched in the resnet phase",
          launches)
    out["phase_s"] = {"check": t1 - t0, "train": t2 - t1, "infer": t3 - t2}
    log("resnet-50 phase: launches %s, resident before %.2f GiB, seconds %s"
        % (json.dumps(launches), resident, json.dumps(out["phase_s"])))
    return out


def flash_inputs(torch, dev, gen, dtype, T, S, B=FB, H=FH, D=FD):
    """q, k, v, do as the Program feeds them: [B, H, T, D] views of
    [B, T, H, D] tensors (strided, last dimension contiguous)."""
    def view(n, scale=1.0):
        x = torch.randn((B, n, H, D), generator=gen, device=dev) * scale
        return x.to(dtype).transpose(1, 2)
    return view(T), view(S), view(S), view(T, 0.1)


def flash_lens(rng, S, with_zeros, B=FB):
    """kv_lens [B]: the training feeds' lengths (64..S), or mixed lengths
    with empty, single-key and full rows."""
    if not with_zeros:
        return rng.randint(min(64, S), S + 1, size=B).astype(np.int32)
    lens = rng.randint(1, S + 1, size=B).astype(np.int32)
    lens[[0, 5, 9]] = 0
    lens[1], lens[2], lens[3] = 1, S, 17
    return lens


def visible_pairs(lens, T, S, causal, H=FH):
    """(query, key) pairs the mask leaves visible, summed over the batch
    and heads (what the kernels compute for these kv_lens)."""
    total = 0
    for n in lens:
        if causal:
            rows = np.arange(T) + (S - T) + 1   # keys each row may see
            total += int(np.minimum(rows, n).clip(0).sum())
        else:
            total += T * int(n)
    return total * H


def flash_bounds(lens, T, S, causal, itemsize, H=FH, D=FD):
    """(forward, backward) bounds: the function's bytes moved once and
    4*D (forward) or 10*D (backward) operations a visible pair, at the
    peak rate of the inputs' type (float32: the CUDA cores; bfloat16:
    the tensor cores' dense bf16 rate, which the kernels, doing float32
    FMAs on widened bf16, cannot reach)."""
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    B = len(lens)
    pairs = visible_pairs(lens, T, S, causal, H)
    q_el, kv_el = B * H * T * D, B * H * S * D
    fwd_bytes = (q_el + 2 * kv_el) * itemsize + B * 4 \
        + q_el * itemsize + B * H * T * 4
    bwd_bytes = (3 * q_el + 2 * kv_el) * itemsize + B * H * T * 4 + B * 4 \
        + (q_el + 2 * kv_el) * itemsize
    return (bound_ms(fwd_bytes, 4 * D * pairs, peak),
            bound_ms(bwd_bytes, 10 * D * pairs, peak))


def pair_bounds(lens, T, S, causal, itemsize, H=FH, D=FD):
    """Bounds of B3's two kernels apart: each reads q, k, v, out, do, lse
    and kv_lens once; the dk/dv kernel writes dk and dv and does 8*D
    operations a visible pair (s, dp, dv, dk), the dq kernel writes dq and
    does 6*D (s, dp, dq)."""
    B = len(lens)
    pairs = visible_pairs(lens, T, S, causal, H)
    q_el, kv_el = B * H * T * D, B * H * S * D
    reads = (3 * q_el + 2 * kv_el) * itemsize + B * H * T * 4 + B * 4
    return (bound_ms(reads + 2 * kv_el * itemsize, 8 * D * pairs),
            bound_ms(reads + q_el * itemsize, 6 * D * pairs))


def flash_err(a, r, dtype):
    """float32: absolute.  bfloat16: absolute up to |value| 1, relative
    above it — one rounding to bf16 costs up to 2**-9 of the value."""
    d = (a.float() - r.float()).abs()
    if dtype == "bfloat16":
        d = d / r.float().abs().clamp_min(1.0)
    return d.max().item()


def flash_case(torch, fa, dev, gen, rng, dtype, causal, T, S, nan_check):
    """One kernel-vs-plain case of both flash kernels; returns errors."""
    q, k, v, do = flash_inputs(torch, dev, gen, dtype, T, S)
    lens_np = flash_lens(rng, S, with_zeros=True)
    lens = torch.as_tensor(lens_np, device=dev)
    scale = 1.0 / FD ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    grads = fa._flash_bwd_cuda(q, k, v, lens, out, lse, do, causal, scale)
    # the plain versions on the same values widened to float32 (exactly):
    # f32 math as in the kernels, results not rounded back to bf16
    f32 = [x.float() for x in (q, k, v, out, do)]
    r_out, r_lse = fa._flash_fwd_reference(*f32[:3], lens, causal, scale)
    r_grads = fa._flash_bwd_reference(*f32[:3], lens, f32[3], lse, f32[4],
                                      causal, scale)
    torch.cuda.synchronize()
    dtype = str(dtype).replace("torch.", "")
    err = lambda a, r: flash_err(a, r, dtype)  # noqa: E731

    fwd_err = max(err(out, r_out), err(lse, r_lse))
    bwd_err = max(err(g, r) for g, r in zip(grads, r_grads))
    tol_f, tol_b = FLASH_TOL[dtype]
    what = (dtype, "causal" if causal else "full", T, S)
    check(fwd_err <= tol_f, "flash fwd vs plain", what, fwd_err)
    check(bwd_err <= tol_b, "flash bwd vs plain", what, bwd_err)
    dead = torch.as_tensor(lens_np == 0, device=dev)
    check(bool((out[dead] == 0).all()), "kv_lens 0: out not zero", what)
    for g in grads:
        check(bool(torch.isfinite(g).all()), "non-finite gradient", what)
    check(bool((grads[0][dead] == 0).all()), "kv_lens 0: dq not zero", what)
    for b, n in enumerate(lens_np):
        check(bool((grads[1][b, :, n:] == 0).all()
                   and (grads[2][b, :, n:] == 0).all()),
              "dk/dv past kv_lens not zero", what, b)
    again = fa._flash_bwd_cuda(q, k, v, lens, out, lse, do, causal, scale)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "flash backward not bitwise repeatable", what)
    # the forward: two calls, and one sequence alone, give the same bits
    out2, lse2 = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    one = slice(3, 4)  # kv_lens 17: a partial first key tile
    out1, lse1 = fa._flash_fwd_cuda(q[one], k[one], v[one], lens[one],
                                    causal, scale)
    check(torch.equal(out2, out) and torch.equal(lse2, lse)
          and torch.equal(out1, out[one]) and torch.equal(lse1, lse[one]),
          "flash forward not bitwise repeatable or batched != unbatched",
          what)
    if nan_check:
        kn, vn = k.clone(), v.clone()
        for b, n in enumerate(lens_np):
            kn[b, :, n:] = float("nan")
            vn[b, :, n:] = float("inf")
        out_n, lse_n = fa._flash_fwd_cuda(q, kn, vn, lens, causal, scale)
        grads_n = fa._flash_bwd_cuda(q, kn, vn, lens, out_n, lse_n, do,
                                     causal, scale)
        check(torch.equal(out_n, out) and torch.equal(lse_n, lse)
              and all(torch.equal(a, b) for a, b in zip(grads_n, grads)),
              "NaN/Inf past kv_lens changed an output", what)
    return {"dtype": dtype, "causal": causal, "T": T, "S": S,
            "fwd_err": fwd_err, "bwd_err": bwd_err, "nan_checked": nan_check,
            "zero_rows": int((lens_np == 0).sum())}


def flash_timing(torch, fa, dev, gen, rng, causal, flush, dtype="float32",
                 B=FB, T=FT, lens_np=None):
    """Both kernels' times at [B, FH, T, FD] (the slice's shape by
    default; ``dtype``; kv_lens ``lens_np``, by default the training
    feeds' lengths), beside the plain versions, the bound and SDPA (in
    ``dtype``: in bfloat16 SDPA runs on the tensor cores)."""
    import torch.nn.functional as F

    q, k, v, do = flash_inputs(torch, dev, gen, getattr(torch, dtype), T,
                               T, B=B)
    if lens_np is None:
        lens_np = flash_lens(rng, T, with_zeros=False, B=B)
    lens = torch.as_tensor(lens_np, device=dev)
    scale = 1.0 / FD ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        mask = mask & torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        s_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    fwd_b, bwd_b = flash_bounds(lens_np, T, T, causal, q.element_size())
    row = {
        "shape": [B, FH, T, FD], "causal": causal, "dtype": dtype,
        "kv_lens_mean": float(lens_np.mean()),
        "fwd": {"ms": time_ms(lambda: fa._flash_fwd_cuda(
                    q, k, v, lens, causal, scale), 20, flush),
                "plain_ms": time_ms(lambda: fa._flash_fwd_reference(
                    q, k, v, lens, causal, scale), 5, flush),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), 20, flush),
                "bound": fwd_b},
        "bwd": {"ms": time_ms(lambda: fa._flash_bwd_cuda(
                    q, k, v, lens, out, lse, do, causal, scale), 20, flush),
                "plain_ms": time_ms(lambda: fa._flash_bwd_reference(
                    q, k, v, lens, out, lse, do, causal, scale), 5, flush),
                "library_ms": time_ms(lambda: torch.autograd.grad(
                    s_out, (qg, kg, vg), do, retain_graph=True), 20, flush),
                "bound": bwd_b}}
    return row


def flash_phase(torch, fa, dev, flush):
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    rng = np.random.RandomState(SEED + 10)
    cases = []
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for causal, T, S, nan_check in FLASH_CASES:
            cases.append(flash_case(torch, fa, dev, gen, rng, td, causal,
                                    T, S, nan_check))
    for c in cases:
        log("flash %-8s %-6s T=%d S=%d fwd err %.3g bwd err %.3g (tol %g/%g) "
            "kv_lens==0 rows %d zero%s, bwd bitwise repeatable"
            % (c["dtype"], "causal" if c["causal"] else "full", c["T"],
               c["S"], c["fwd_err"], c["bwd_err"], *FLASH_TOL[c["dtype"]],
               c["zero_rows"], ", NaN/Inf past kv_lens inert"
               if c["nan_checked"] else ""))
    timing = [flash_timing(torch, fa, dev, gen, rng, causal, flush, dtype)
              for dtype in ("float32", "bfloat16") for causal in (False, True)]
    for t in timing:
        for kind in ("fwd", "bwd"):
            r = t[kind]
            log("flash %s %-6s [%d,%d,%d,%d] %s kv_lens mean %.1f: kernel "
                "%.4f ms plain %.4f ms sdpa %.4f ms bound %.4f ms (%s)"
                % (kind, "causal" if t["causal"] else "full", FB, FH, FT, FD,
                   t["dtype"], t["kv_lens_mean"], r["ms"], r["plain_ms"],
                   r["library_ms"], r["bound"][0], r["bound"][1]))
    return cases, timing


def pair_case(torch, fa, dev, gen, rng, dtype, causal, T, S, nan_check):
    """One case of B3 (both kernels) against its plain version and against
    B2 on the same inputs, and B2 against the same plain version; returns
    errors."""
    q, k, v, do = flash_inputs(torch, dev, gen, dtype, T, S)
    lens_np = flash_lens(rng, S, with_zeros=True)
    lens = torch.as_tensor(lens_np, device=dev)
    scale = 1.0 / FD ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    grads = fa._flash_bwd_pair_cuda(q, k, v, lens, out, lse, do, causal,
                                    scale)
    fused = fa._flash_bwd_cuda(q, k, v, lens, out, lse, do, causal, scale)
    f32 = [x.float() for x in (q, k, v, out, do)]
    r_grads = fa._flash_bwd_pair_reference(*f32[:3], lens, f32[3], lse,
                                           f32[4], causal, scale)
    torch.cuda.synchronize()
    dtype = str(dtype).replace("torch.", "")
    errs = [flash_err(g, r, dtype) for g, r in zip(grads, r_grads)]
    b2_err = max(flash_err(g, f, dtype) for g, f in zip(grads, fused))
    b2_plain_err = max(flash_err(f, r, dtype) for f, r in zip(fused, r_grads))
    tol = FLASH_TOL[dtype][1]
    what = (dtype, "causal" if causal else "full", T, S)
    check(max(errs) <= tol, "pair bwd vs plain", what, errs)
    check(b2_err <= tol, "pair bwd vs B2", what, b2_err)
    check(b2_plain_err <= tol, "B2 vs plain", what, b2_plain_err)
    dead = torch.as_tensor(lens_np == 0, device=dev)
    for g in grads:
        check(bool(torch.isfinite(g).all()), "pair: non-finite gradient",
              what)
        check(bool((g[dead] == 0).all()), "pair: kv_lens 0 not zero", what)
    for b, n in enumerate(lens_np):
        check(bool((grads[1][b, :, n:] == 0).all()
                   and (grads[2][b, :, n:] == 0).all()),
              "pair: dk/dv past kv_lens not zero", what, b)
    again = fa._flash_bwd_pair_cuda(q, k, v, lens, out, lse, do, causal,
                                    scale)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "pair backward not bitwise repeatable", what)
    if nan_check:
        kn, vn = k.clone(), v.clone()
        for b, n in enumerate(lens_np):
            kn[b, :, n:] = float("nan")
            vn[b, :, n:] = float("inf")
        grads_n = fa._flash_bwd_pair_cuda(q, kn, vn, lens, out, lse, do,
                                          causal, scale)
        check(all(torch.equal(a, b) for a, b in zip(grads_n, grads)),
              "pair: NaN/Inf past kv_lens changed an output", what)
    return {"dtype": dtype, "causal": causal, "T": T, "S": S,
            "dq_err": errs[0], "dkv_err": max(errs[1:]), "b2_err": b2_err,
            "b2_plain_err": b2_plain_err, "nan_checked": nan_check,
            "zero_rows": int((lens_np == 0).sum())}


def pair_phase(torch, fa, dev):
    """B3 on the flash cases, f32 and bf16."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rng = np.random.RandomState(SEED + 11)
    cases = [pair_case(torch, fa, dev, gen, rng, getattr(torch, dtype),
                       causal, T, S, nan_check)
             for dtype in ("float32", "bfloat16")
             for causal, T, S, nan_check in FLASH_CASES]
    for c in cases:
        log("pair %-8s %-6s T=%d S=%d dq err %.3g dk/dv err %.3g vs B2 %.3g "
            "(B2 vs plain %.3g; tol %g) kv_lens==0 rows %d zero, bitwise "
            "repeatable%s"
            % (c["dtype"], "causal" if c["causal"] else "full", c["T"],
               c["S"], c["dq_err"], c["dkv_err"], c["b2_err"],
               c["b2_plain_err"],
               FLASH_TOL[c["dtype"]][1], c["zero_rows"],
               ", NaN/Inf past kv_lens inert" if c["nan_checked"] else ""))
    return cases


def sweep_row(torch, fa, dev, flush, shape, causal, gen, rng):
    """B2 against B3 (each engine's three kernels from a profiler window:
    B2's delta pre-pass, fused kernel and dq sum, B3's delta pre-pass,
    dk/dv and dq kernels), the plain versions, the bound and SDPA's
    backward at one sweep shape [B, H, T, D], float32, with the training
    feeds' kv_lens;
    beside them the forward (B1: its device time from a profiler window,
    its plain version's, SDPA's forward and the 4*D bound).  The forward,
    B2 and B3 are held against their plain versions on these inputs."""
    import torch.nn.functional as F

    B, H, T, D = shape
    q, k, v, do = flash_inputs(torch, dev, gen, torch.float32, T, T, B, H, D)
    lens_np = flash_lens(rng, T, with_zeros=False, B=B)
    lens = torch.as_tensor(lens_np, device=dev)
    scale = 1.0 / D ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    args = (q, k, v, lens, out, lse, do, causal, scale)
    iters = {256: 20, 384: 20, 512: 20, 1024: 10, 2048: 5}.get(T, 3)
    plain_iters = 3 if T <= 512 else 1
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        mask = mask & torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        s_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    fwd_b, bwd_b = flash_bounds(lens_np, T, T, causal, 4, H, D)
    dkv_b, dq_b = pair_bounds(lens_np, T, T, causal, 4, H, D)
    fwd_dev, _ = kernel_ms(torch, lambda: fa._flash_fwd_cuda(
        q, k, v, lens, causal, scale), iters, flush, ("flash_fwd_kernel",))
    b2_ms, b2 = timed(lambda: fa._flash_bwd_cuda(*args), iters, flush)
    b2_apart, b2_seen = kernel_ms(torch, lambda: fa._flash_bwd_cuda(*args),
                                  iters, flush, B2_KERNELS)
    pair_ms, pair = timed(lambda: fa._flash_bwd_pair_cuda(*args), iters,
                          flush)
    apart, seen = kernel_ms(torch, lambda: fa._flash_bwd_pair_cuda(*args),
                            iters, flush, B3_KERNELS)
    b2_plain_ms, b2_plain = timed(lambda: fa._flash_bwd_reference(*args),
                                  plain_iters, flush, 1)
    dkv_plain_ms, dkv_plain = timed(lambda: fa._pair_dkv_reference(*args),
                                    plain_iters, flush, 1)
    dq_plain_ms, dq_plain = timed(lambda: fa._pair_dq_reference(*args),
                                  plain_iters, flush, 1)
    fwd_plain_ms, (r_out, r_lse) = timed(
        lambda: fa._flash_fwd_reference(q, k, v, lens, causal, scale),
        plain_iters, flush, 1)
    torch.cuda.synchronize()
    err = lambda a, r: flash_err(a, r, "float32")  # noqa: E731
    errs = {"fwd": max(err(out, r_out), err(lse, r_lse)),
            "b2": max(err(g, r) for g, r in zip(b2, b2_plain)),
            "dkv": max(err(g, r) for g, r in zip(pair[1:], dkv_plain)),
            "dq": err(pair[0], dq_plain),
            "pair_vs_b2": max(err(g, r) for g, r in zip(pair, b2))}
    tol_f, tol_b = FLASH_TOL["float32"]
    what = (shape, "causal" if causal else "full")
    check(errs["fwd"] <= tol_f, "sweep: flash fwd vs plain", what, errs)
    check(max(errs["b2"], errs["dkv"], errs["dq"], errs["pair_vs_b2"])
          <= tol_b, "sweep: flash bwd vs plain", what, errs)
    row = {
        "shape": list(shape), "causal": causal,
        "kv_lens_mean": float(lens_np.mean()), "errs": errs,
        "b2_ms": b2_ms, "pair_ms": pair_ms,
        "b2_dev_ms": sum(b2_apart.values()),
        "b2_fused_ms": b2_apart["flash_bwd_fused_kernel"],
        "b2_dq_sum_ms": b2_apart["flash_bwd_dq_sum_kernel"],
        "b2_delta_ms": b2_apart["flash_bwd_delta_kernel"],
        "b2_profiled_launches": b2_seen,
        "pair_dev_ms": sum(apart.values()),
        "dkv_ms": apart["flash_bwd_dkv_kernel"],
        "dq_ms": apart["flash_bwd_dq_kernel"],
        "delta_ms": apart["flash_bwd_delta_kernel"], "profiled_launches": seen,
        "iters": iters,
        "fwd_dev_ms": fwd_dev["flash_fwd_kernel"],
        "fwd_plain_ms": fwd_plain_ms, "fwd_bound": fwd_b,
        "sdpa_fwd_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters, flush),
        "sdpa_bwd_ms": time_ms(lambda: torch.autograd.grad(
            s_out, (qg, kg, vg), do, retain_graph=True), iters, flush),
        "b2_plain_ms": b2_plain_ms, "dkv_plain_ms": dkv_plain_ms,
        "dq_plain_ms": dq_plain_ms,
        "bound": bwd_b, "dkv_bound": dkv_b, "dq_bound": dq_b,
        "auto": fa._pick_bwd_engine(B, H, D, fa._sm_count(0))}
    row["pair_plain_ms"] = row["dkv_plain_ms"] + row["dq_plain_ms"]
    # which engine is faster on the device: the kernels' own times from the
    # profiler (a CUDA-event time of an engine's three launches also takes
    # in the host's gaps between them)
    row["faster"] = ("fused" if row["b2_dev_ms"] <= row["pair_dev_ms"]
                     else "pair")
    # B2's grid, B*H*ceil(T/64) blocks, as a share of the blocks the card
    # holds at once
    row["b2_fill"] = (B * H * -(-T // 64)
                      / (fa._b2_blocks_per_sm(D) * fa._sm_count(0)))
    return row


def engine_sweep(torch, fa, dev, flush):
    """The backward engines at the sweep's shapes, causal and full: the
    measurements the ``auto`` rule is set from."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    rng = np.random.RandomState(SEED + 12)
    rows = []
    for shape in SWEEP_SHAPES:
        for causal in (False, True):
            rows.append(sweep_row(torch, fa, dev, flush, shape, causal, gen,
                                  rng))
            torch.cuda.empty_cache()
    for r in rows:
        log("sweep %s %-6s f32 kv_lens mean %.1f, B2's grid %.2f of its "
            "slots: device B2 %.4f ms (delta %.4f + fused %.4f + dq sum "
            "%.4f, %d + %d of %d profiled), B3 %.4f ms (delta %.4f + dkv "
            "%.4f + dq %.4f, %d + %d of %d profiled) | CUDA events B2 %.4f "
            "ms, B3 %.4f ms | "
            "sdpa bwd %.4f ms | plain B2 %.4f ms, B3 %.4f ms (dkv %.4f + dq "
            "%.4f) | bound %.4f ms (%s) "
            "| faster %s, auto picks %s | B1 fwd device %.4f ms, sdpa fwd "
            "%.4f ms, plain %.4f ms, bound %.4f ms (%s) | err vs plain: fwd "
            "%.3g B2 %.3g dkv %.3g dq %.3g, B3 vs B2 %.3g (tol %g/%g)"
            % (r["shape"], "causal" if r["causal"] else "full",
               r["kv_lens_mean"], r["b2_fill"], r["b2_dev_ms"],
               r["b2_delta_ms"], r["b2_fused_ms"], r["b2_dq_sum_ms"],
               r["b2_profiled_launches"]["flash_bwd_fused_kernel"],
               r["b2_profiled_launches"]["flash_bwd_dq_sum_kernel"],
               r["iters"],
               r["pair_dev_ms"], r["delta_ms"], r["dkv_ms"], r["dq_ms"],
               r["profiled_launches"]["flash_bwd_dkv_kernel"],
               r["profiled_launches"]["flash_bwd_dq_kernel"], r["iters"],
               r["b2_ms"], r["pair_ms"],
               r["sdpa_bwd_ms"], r["b2_plain_ms"],
               r["pair_plain_ms"], r["dkv_plain_ms"], r["dq_plain_ms"],
               r["bound"][0], r["bound"][1], r["faster"], r["auto"],
               r["fwd_dev_ms"], r["sdpa_fwd_ms"], r["fwd_plain_ms"],
               r["fwd_bound"][0], r["fwd_bound"][1], r["errs"]["fwd"],
               r["errs"]["b2"], r["errs"]["dkv"], r["errs"]["dq"],
               r["errs"]["pair_vs_b2"],
               *FLASH_TOL["float32"]))
    return rows


def make_feeds(rng, batch, seq, vocab):
    """Seeded token feeds: every row its own length (64..seq, at most
    seq), with PAD_IDX (0) tails; labels share the target's length."""
    lo = min(64, seq)
    src = rng.randint(3, vocab, size=(batch, seq)).astype(np.int64)
    trg = rng.randint(3, vocab, size=(batch, seq)).astype(np.int64)
    lbl = rng.randint(3, vocab, size=(batch, seq)).astype(np.int64)
    for b in range(batch):
        ls, lt = rng.randint(lo, seq + 1, size=2)
        src[b, ls:] = 0
        trg[b, lt:] = 0
        lbl[b, lt:] = 0
    return {"src_word": src, "trg_word": trg, "lbl_word": lbl}


def relu_gates(program):
    """For each relu of the Program's fc layers: (pre-activation var,
    weight name, bias name), read from the op chain mul -> elementwise_add
    -> relu that layers.fc(act="relu") builds."""
    producer = {n: op for op in program.global_block().ops
                for ns in op.outputs.values() for n in ns}
    out = []
    for op in program.global_block().ops:
        if op.type != "relu":
            continue
        pre = op.inputs["X"][0]
        add = producer[pre]
        mul = producer[add.inputs["X"][0]]
        out.append((pre, mul.inputs["Y"][0], add.inputs["Y"][0]))
    return out


def bwd_engine(fa, engine, cfg):
    """The backward engine the card runs for a training config's
    attention calls (all [batch, FH, seq, FD] against seq keys)."""
    if engine == "auto":
        return fa._pick_bwd_engine(cfg["batch_size"], FH, FD,
                                   fa._sm_count(0))
    return engine


def check_flash_launches(fa, launches, engine, calls, what):
    """The forward and the engine's backward kernels launched ``calls``
    times each; every other flash kernel not at all."""
    want = {n: 0 for sub in FLASH_BWD_KERNELS.values() for n in sub}
    want["flash_attention_fwd"] = calls
    want.update({n: calls for n in FLASH_BWD_KERNELS[engine]})
    check(all(launches[n] == c for n, c in want.items()),
          what + " flash launches", engine, launches)


def train_check_phase(torch, fluid, T, fa, dev, cfg, engine):
    """One training step on the card against the port's plain CPU path,
    from the same numpy parameters, at full width (``cfg``'s batch), with
    the flash backward engine ``engine`` on both sides.

    A ReLU gate whose pre-activation lies within rounding of 0 may open
    on one side and stay shut on the other; that moves its unit's column
    of the fc weight gradient (and bias element) by one token's whole
    contribution, which no summation tolerance covers.  Such units are
    found from the pre-activations of both runs and left out of the
    max-norm check of that fc's weight and bias (and counted); every
    other element of every gradient is held to GRAD_RTOL of its tensor's
    max |g|."""
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    m["startup"].random_seed = SEED + 5
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(m["startup"], scope=cpu_scope)
    state = {n: cpu_scope[n].numpy() for n in m["main"].persistable_names()
             if n in cpu_scope}
    fluid.load_numpy_state(m["main"], state, scope=card_scope, device=dev)
    feed = make_feeds(np.random.RandomState(SEED + 6), cfg["batch_size"],
                      cfg["seq_len"], cfg["trg_vocab_size"])
    grads = [p.name + "@GRAD"
             for p in m["main"].global_block().all_parameters() if p.trainable]
    gates = relu_gates(m["main"])
    fetch = [m["loss"]] + grads + [pre for pre, _, _ in gates]
    saved = fa.FLASH_BWD_IMPL
    fa.FLASH_BWD_IMPL = engine
    try:
        fa.reset_launch_counts()
        card = fluid.Executor(fluid.CUDAPlace(0)).run(
            m["main"], feed=feed, fetch_list=fetch, scope=card_scope)
        launches = dict(fa.KERNEL_LAUNCHES)
        cpu = fluid.Executor(fluid.CPUPlace()).run(
            m["main"], feed=feed, fetch_list=fetch, scope=cpu_scope)
    finally:
        fa.FLASH_BWD_IMPL = saved
    loss_card, loss_cpu = float(card[0]), float(cpu[0])
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    check(np.isfinite(loss_card) and loss_err <= LOSS_RTOL,
          "card vs cpu loss", loss_card, loss_cpu)
    # units whose ReLU gate differs between the card and the CPU, by the
    # gradient names of their fc weight (columns) and bias (elements)
    flipped, n_flips = {}, 0
    for i, (_, w, b) in enumerate(gates):
        a, r = card[1 + len(grads) + i], cpu[1 + len(grads) + i]
        diff = (a > 0) != (r > 0)
        n_flips += int(diff.sum())
        units = np.nonzero(diff.reshape(-1, diff.shape[-1]).any(0))[0]
        if len(units):
            flipped[w + "@GRAD"] = flipped[b + "@GRAD"] = units
    worst, worst_l2 = 0.0, 0.0
    for name, g, r in zip(grads, card[1:], cpu[1:]):
        check(g.shape == r.shape and np.isfinite(g).all(), name)
        scale = float(np.abs(r).max())
        d = np.abs(g - r)
        worst_l2 = max(worst_l2, float(np.linalg.norm(g - r))
                       / max(float(np.linalg.norm(r)), 1e-30))
        if name in flipped:
            d = d.copy()
            d[..., flipped[name]] = 0.0
        err = float(d.max())
        rel = err / scale if scale > 0 else err
        check(rel <= GRAD_RTOL, "card vs cpu gradient", name, err, scale)
        worst = max(worst, rel)
    check_flash_launches(fa, launches, bwd_engine(fa, engine, cfg), 18,
                         "card-vs-cpu step")
    out = {"engine": engine, "loss_card": loss_card, "loss_cpu": loss_cpu,
           "loss_rel_err": loss_err, "grads": len(grads),
           "worst_grad_err_of_max": worst, "worst_grad_l2_rel": worst_l2,
           "relu_gates": sum(int(np.prod(card[1 + len(grads) + i].shape))
                             for i in range(len(gates))),
           "relu_gate_flips": n_flips,
           "units_left_out": {k: len(v) for k, v in flipped.items()},
           "launches": launches}
    log("train check (card vs cpu, batch %d x %d, dropout 0, engine %s): %s"
        % (cfg["batch_size"], cfg["seq_len"], engine, json.dumps(out)))
    return out


def profile_step(torch, exe, m, feed, scope):
    """Where one training step's device time goes, by kernel family, and
    the device's idle share of the step's wall time, on the eager path
    (``use_program_cache=False``); "not measured" when the profiler
    records no device activity."""
    out = profile_call(torch, lambda: exe.run(
        m["main"], feed=feed, fetch_list=[m["loss"]], scope=scope,
        use_program_cache=False))
    if isinstance(out, dict):
        out["path"] = "eager (use_program_cache=False)"
    return out


def profile_graphed(torch, exe, m, feed, scope, fetch=None):
    """A replay of the step's CUDA graph profiled (``fetch`` the list the
    steps before it fetched, so that it replays their entry): busy and
    idle only.  Fails unless it replayed a graph the executor held
    (no entry bound or rebound)."""
    entries = {id(b): b for b in exe._bound.values()}
    check(any(b.program is m["main"] and b.graph is not None
              for b in entries.values()), "no graph to profile")
    out = busy_idle(profile_call(torch, lambda: exe.run(
        m["main"], feed=feed, fetch_list=fetch or [m["loss"]],
        scope=scope)))
    check({id(b) for b in exe._bound.values()} == set(entries),
          "the profiled step did not replay a held graph")
    if isinstance(out, dict):
        out["path"] = "graphed (a CUDA-graph replay)"
    return out


def profile_call(torch, step):
    """profile_step's split for one call of ``step``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return "not measured (the profiler recorded no device activity)"
    flash = {"flash_fwd_kernel": "flash_fwd",
             "flash_bwd_fused_kernel": "flash_bwd_fused",
             "flash_bwd_dq_sum_kernel": "flash_bwd_dq_sum",
             "flash_bwd_delta_kernel": "flash_bwd_delta",
             "flash_bwd_dkv_kernel": "flash_bwd_dkv",
             "flash_bwd_dq_kernel": "flash_bwd_dq"}
    families = dict.fromkeys(list(flash.values()) + ["gemm", "other"], 0.0)
    other = {}
    for e in kernels:
        name = e.name.lower()
        fam = next((f for k, f in flash.items() if k in name), None)
        if fam is None:
            # cuBLAS's Hopper bf16 kernels are named nvjet_*
            fam = ("gemm" if any(k in name for k in (
                "gemm", "xmma", "cutlass", "gemv", "sm90_", "sm80_",
                "nvjet")) else "other")
        families[fam] += e.time_range.elapsed_us()
        if fam == "other":
            other[e.name[:60]] = (other.get(e.name[:60], 0.0)
                                  + e.time_range.elapsed_us())
    busy = sum(families.values())
    return {"step_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_by_family": {k: v / 1e3 for k, v in families.items()},
            "other_ms_by_kernel": dict(sorted(
                ((k, v / 1e3) for k, v in other.items()),
                key=lambda kv: -kv[1])[:6]),
            "device_events": len(kernels)}


def steady_ms(step_s):
    """Mean ms of the steps from the third on: through Executor.run's
    fast path the first step runs eager and the second captures the CUDA
    graph."""
    return float(np.mean(step_s[2:])) * 1e3


def busy_idle(profile):
    """Only the busy and idle figures of a profile_call result (a graph
    replay emits no record_function ranges, so no split by op)."""
    if isinstance(profile, str):
        return profile
    return {k: profile[k] for k in ("step_wall_ms", "device_busy_ms",
                                    "device_idle_share", "device_events")}


def bits_equal(torch, a, b):
    """Whether two tensors hold the same bits (NaNs included)."""
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.detach().reshape(-1).contiguous().view(torch.uint8),
        b.detach().reshape(-1).contiguous().view(torch.uint8)))


def fast_path_phase(torch, fluid, T, fa, dev):
    """The executor's fast path on Transformer-base at TRAIN_CFG (64 x 256,
    dropout 0.1, Adam with noam decay, f32 with TF32 off) from one seeded
    start state copied into two scopes: FAST_STEPS steps eager
    (``use_program_cache=False``) and FAST_STEPS through the default path
    (eager, capture, then one CUDA-graph replay a step).  Checks: the
    losses, every parameter and every Adam accumulator bitwise equal; 1
    capture (``compile_count`` moves by 1 at step 2 and 0 over steps
    3-10); B1 and B2 18 launches on every step, replays included; the
    loss of step FAST_HELD as numpy, the next one's as a LazyFetch read
    only after the last step, the one after as a ``return_numpy=False``
    tensor, and a parameter read through the scope as numpy at step
    FAST_HELD, each unchanged after the later steps.  Then ``nan_guard``
    on a fresh executor: two finite guarded steps (the slow path, then a
    captured graph) bitwise equal to two unguarded eager steps; a
    parameter set to NaN through the scope (rebinding the entry): two
    guarded steps (slow, then graphed) read False with every persistable
    bitwise unchanged; the parameter restored: True, True.  JitStepCache
    on the card: a graphed callable equal to its eager call.  Recorded:
    step ms and tokens/s each way, the device's idle share of a profiled
    step each way (the eager one split by kernel family, the graphed one
    busy and idle only), capture ms, the graph's pool, peak memory."""
    import gc

    from paddle_tpu_torch import executor as executor_mod

    cfg = TRAIN_CFG
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    m["startup"].random_seed = SEED + 100
    m["main"].random_seed = SEED + 101   # the run seed of both paths
    start = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(m["startup"], scope=start)
    names = sorted(n for n in m["main"].persistable_names() if n in start)
    rng = np.random.RandomState(SEED + 102)
    feeds = [make_feeds(rng, cfg["batch_size"], cfg["seq_len"],
                        cfg["trg_vocab_size"]) for _ in range(FAST_STEPS + 7)]
    tokens = cfg["batch_size"] * cfg["seq_len"]
    run_kw = {"fetch_list": [m["loss"]]}

    def state_equal(a, b):
        return [n for n in names if not bits_equal(torch, a[n], b[n])]

    # eager: the step op by op, every time
    s_eager = copy_scope(fluid, start, names)
    exe_e = fluid.Executor(fluid.CUDAPlace(0))
    eager_losses, eager_s = [], []
    for feed in feeds[:FAST_STEPS]:
        t0 = time.perf_counter()
        (loss,) = exe_e.run(m["main"], feed=feed, scope=s_eager,
                            use_program_cache=False, **run_kw)
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
        eager_losses.append(np.array(loss))

    # graphed: eager, capture, replays
    s_graph = copy_scope(fluid, start, names)
    exe_g = fluid.Executor(fluid.CUDAPlace(0))
    pname = m["main"].global_block().all_parameters()[-1].name
    c0 = executor_mod.compile_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    graph_losses, graph_s, compiles, step_launches = [], [], [], []
    held = {}
    for i, feed in enumerate(feeds[:FAST_STEPS], 1):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        (loss,) = exe_g.run(m["main"], feed=feed, scope=s_graph,
                            return_numpy=i != FAST_HELD + 2, **run_kw)
        if i == FAST_HELD:
            loss = np.asarray(loss)   # read at once, inside the step
        torch.cuda.synchronize()
        graph_s.append(time.perf_counter() - t0)
        compiles.append(executor_mod.compile_count() - c0)
        step_launches.append([fa.KERNEL_LAUNCHES["flash_attention_fwd"],
                              fa.KERNEL_LAUNCHES["flash_attention_bwd"]])
        if i == FAST_HELD:
            held["numpy"] = (loss, loss.copy())
            w = np.asarray(s_graph.find_var(pname).get_tensor())
            held["param"] = (w, w.copy())
        elif i == FAST_HELD + 1:
            held["lazy"] = loss
        elif i == FAST_HELD + 2:
            held["tensor"] = (loss, loss.clone())
        if i not in (FAST_HELD + 1, FAST_HELD + 2):
            graph_losses.append(np.array(loss))
        else:
            graph_losses.append(None)
    peak = torch.cuda.max_memory_allocated(dev)
    check(isinstance(held["lazy"], executor_mod.LazyFetch),
          "a graphed fetch is a LazyFetch", type(held["lazy"]))
    graph_losses[FAST_HELD] = np.array(held["lazy"])   # read only now
    graph_losses[FAST_HELD + 1] = held["tensor"][0].cpu().numpy()
    check(all(a.tobytes() == b.tobytes()
              for a, b in zip(eager_losses, graph_losses)),
          "graphed losses not bitwise eager", eager_losses, graph_losses)
    moved = state_equal(s_eager, s_graph)
    check(not moved, "graphed state not bitwise eager", moved[:8])
    check(compiles[0] == 0 and compiles[1] == 1 and compiles[-1] == 1,
          "one capture, at step 2", compiles)
    check(all(n == [18, 18] for n in step_launches),
          "B1 and B2 18 launches a step", step_launches)
    a, a_copy = held["numpy"]
    w, w_copy = held["param"]
    t, t_copy = held["tensor"]
    check(a.tobytes() == a_copy.tobytes() == eager_losses[FAST_HELD - 1]
          .tobytes(), "a numpy fetch changed")
    check(w.tobytes() == w_copy.tobytes(), "a scope value read as numpy "
          "changed")
    check(not np.array_equal(w, s_graph[pname].cpu().numpy()),
          "the parameter did not move after step %d" % FAST_HELD)
    check(bits_equal(torch, t, t_copy), "a return_numpy=False fetch changed")
    entry = next(b for b in exe_g._bound.values() if b.graph is not None)
    # profiled: a replay (busy and idle only), then an eager step
    graph_profile = busy_idle(profile_call(torch, lambda: exe_g.run(
        m["main"], feed=feeds[FAST_STEPS], scope=s_graph, **run_kw)))
    eager_profile = profile_call(torch, lambda: exe_e.run(
        m["main"], feed=feeds[FAST_STEPS], scope=s_eager,
        use_program_cache=False, **run_kw))
    moved = state_equal(s_eager, s_graph)
    check(not moved, "state after the profiled steps", moved[:8])
    stats = {"steps": FAST_STEPS, "dropout": 0.1,
             "eager_step_ms_all": [x * 1e3 for x in eager_s],
             "graphed_step_ms_all": [x * 1e3 for x in graph_s],
             "eager_step_ms": float(np.mean(eager_s[1:])) * 1e3,
             "graphed_step_ms": steady_ms(graph_s),
             "capture_step_ms": graph_s[1] * 1e3,
             "capture_ms": entry.capture_s * 1e3,
             "graph_pool_gib": entry.pool_bytes / 2 ** 30,
             "peak_memory_gib": peak / 2 ** 30,
             "compiles_by_step": compiles,
             "launches_by_step": step_launches,
             "graph_launches_per_replay": {
                 "%s/%s" % k: n for k, n in entry.launches.items()},
             "bitwise_losses_and_state": True, "state_tensors": len(names),
             "graphed_profile": graph_profile, "eager_profile": eager_profile}
    stats["eager_tokens_per_s"] = tokens / stats["eager_step_ms"] * 1e3
    stats["graphed_tokens_per_s"] = tokens / stats["graphed_step_ms"] * 1e3
    # dropping the executor frees its graph and the graph's pool
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(dev)
    pool = entry.pool_bytes
    del exe_g, entry
    gc.collect()
    torch.cuda.empty_cache()
    freed = reserved - torch.cuda.memory_reserved(dev)
    stats["freed_on_drop_gib"] = freed / 2 ** 30
    check(freed >= 0.9 * pool, "dropping the executor kept its graph's pool",
          freed, pool)
    stats["shape_cycle"] = shape_cycle_check(torch, fluid, m, start, names,
                                             executor_mod, dev)
    del start

    # nan_guard, on a fresh executor: finite, NaN, restored
    exe_n = fluid.Executor(fluid.CUDAPlace(0))
    g_feeds = iter(feeds[FAST_STEPS + 1:])
    verdicts, guard_compiles = [], []

    def guarded():
        c = executor_mod.compile_count()
        exe_n.run(m["main"], feed=next(g_feeds), scope=s_graph,
                  nan_guard=True, **run_kw)
        guard_compiles.append(executor_mod.compile_count() - c)
        verdicts.append(exe_n.last_step_ok())

    for _ in range(2):
        guarded()
    for f in feeds[FAST_STEPS + 1:FAST_STEPS + 3]:
        exe_e.run(m["main"], feed=f, scope=s_eager, use_program_cache=False,
                  **run_kw)
    moved = state_equal(s_eager, s_graph)
    check(verdicts == [True, True] and not moved,
          "finite guarded steps against unguarded eager", verdicts, moved[:8])
    saved = s_graph[pname].clone()
    bad = saved.clone()
    bad.view(-1)[0] = float("nan")
    s_graph[pname] = bad
    snapshot = {n: s_graph[n].clone() for n in names}
    for _ in range(2):
        guarded()
        changed = [n for n in names
                   if not bits_equal(torch, s_graph[n], snapshot[n])]
        check(verdicts[-1] is False and not changed,
              "a NaN step changed state", verdicts, changed[:8])
    s_graph[pname] = saved
    for _ in range(2):
        guarded()
    check(verdicts == [True, True, False, False, True, True],
          "nan_guard verdicts", verdicts)
    check(guard_compiles == [0, 1] * 3, "a guarded entry captures at its "
          "second run", guard_compiles)
    stats["nan_guard"] = {"verdicts": verdicts, "compiles": guard_compiles,
                          "nan_param": pname,
                          "finite_guarded_equals_unguarded": True,
                          "nan_steps_state_unchanged": True}
    del exe_n, snapshot, s_eager, s_graph
    gc.collect()
    torch.cuda.empty_cache()

    # JitStepCache on the card: warm-up, capture, replays
    cache = executor_mod.JitStepCache(lambda key: (lambda x: x * key + 1))
    c = executor_mod.compile_count()
    fn = cache.get(3)
    xs = [torch.randn(4096, device=dev) for _ in range(3)]
    outs = [fn(x) for x in xs]
    check(fn._graph is not None and all(
        bits_equal(torch, o, x * 3 + 1) for o, x in zip(outs, xs))
          and executor_mod.compile_count() - c == 1,
          "JitStepCache graphed callable")
    stats["jit_step_cache"] = {"graphed": True, "compiles": 1}
    log("fast path (Transformer-base 64 x 256, dropout 0.1, eager against "
        "graphed): %s" % json.dumps(stats))
    return stats


def shape_cycle_check(torch, fluid, m, start, names, executor_mod, dev):
    """FAST_CYCLE's feed shapes through one executor, from ``start``'s
    state: one graph a shape, all in the executor's one pool, none
    evicted; the losses and every state tensor bitwise equal to the same
    sequence op by op.  Recorded: what each capture added to the pool,
    and the card's reserved memory before and at its peak."""
    import gc

    cfg = TRAIN_CFG
    rng = np.random.RandomState(SEED + 103)
    feeds = [make_feeds(rng, b, cfg["seq_len"], cfg["trg_vocab_size"])
             for b in FAST_CYCLE]
    run_kw = {"fetch_list": [m["loss"]]}
    s_eager = copy_scope(fluid, start, names)
    exe_e = fluid.Executor(fluid.CUDAPlace(0))
    eager = [np.array(exe_e.run(m["main"], feed=f, scope=s_eager,
                                use_program_cache=False, **run_kw)[0])
             for f in feeds]
    del exe_e
    s_graph = copy_scope(fluid, start, names)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reserved = torch.cuda.memory_reserved(dev)
    c0 = executor_mod.compile_count()
    e0 = executor_mod.cache_eviction_count()
    graphed = [np.array(exe.run(m["main"], feed=f, scope=s_graph,
                                **run_kw)[0]) for f in feeds]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved(dev)
    captures = executor_mod.compile_count() - c0
    evictions = [a - b for a, b in
                 zip(executor_mod.cache_eviction_count(), e0)]
    pools = {b.static_feeds["src_word"].shape[0]: b.pool_bytes
             for b in exe._bound.values() if b.graph is not None}
    check(sorted(pools) == sorted(set(FAST_CYCLE))
          and captures == len(pools) and evictions == [0, 0],
          "cycled shapes: one graph a shape, none evicted", sorted(pools),
          captures, evictions)
    check(all(a.tobytes() == b.tobytes() for a, b in zip(eager, graphed)),
          "cycled shapes: graphed losses not bitwise eager", eager, graphed)
    check(all(np.isfinite(x).all() for x in graphed),
          "cycled shapes: non-finite loss", graphed)
    moved = [n for n in names
             if not bits_equal(torch, s_eager[n], s_graph[n])]
    check(not moved, "cycled shapes: graphed state not bitwise eager",
          moved[:8])
    first, total = pools[FAST_CYCLE[0]], sum(pools.values())
    # four pools of their own would take about 3.25 times the first
    check(total < 2 * first, "cycled shapes: the graphs did not share "
          "one pool", {b: v / 2 ** 30 for b, v in pools.items()})
    out = {"batches": list(FAST_CYCLE), "seq_len": cfg["seq_len"],
           "captures": captures, "evictions": evictions,
           "pool_gib_by_capture": {b: v / 2 ** 30
                                   for b, v in sorted(pools.items())},
           "pool_gib_total": total / 2 ** 30,
           "reserved_before_gib": reserved / 2 ** 30,
           "reserved_peak_gib": peak / 2 ** 30,
           "bitwise_losses_and_state": True}
    del exe, s_eager, s_graph
    gc.collect()
    torch.cuda.empty_cache()
    log("fast path, cycled shapes (Transformer-base, batches %s x %d): %s"
        % (list(FAST_CYCLE), cfg["seq_len"], json.dumps(out)))
    return out


def train_phase(torch, fluid, T, fa, dev, cfg, steps, engine, label):
    """Transformer-base trains through Executor.run on the card, with the
    flash backward engine ``engine``."""
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    m["startup"].random_seed = SEED + 7
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(m["startup"], scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    params = [p.name for p in m["main"].global_block().all_parameters()]
    trainable = [p.name for p in m["main"].global_block().all_parameters()
                 if p.trainable]
    n_values = sum(scope[p].numel() for p in params)
    before = {p: scope[p].clone() for p in trainable}
    rng = np.random.RandomState(SEED + 8)
    feeds = [make_feeds(rng, cfg["batch_size"], cfg["seq_len"],
                        cfg["trg_vocab_size"])
             for _ in range(steps + 1)]
    saved = fa.FLASH_BWD_IMPL
    fa.FLASH_BWD_IMPL = engine
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.reset_launch_counts()
        losses, step_s = [], []
        for feed in feeds[:steps]:
            t0 = time.perf_counter()
            (loss,) = exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                              scope=scope)
            losses.append(float(loss))   # reading it waits for the step
            step_s.append(time.perf_counter() - t0)
        launches = dict(fa.KERNEL_LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        check(all(np.isfinite(losses)), "non-finite loss", losses)
        for p in trainable:
            check(bool(torch.isfinite(scope[p]).all()), "non-finite param", p)
            check(not torch.equal(scope[p], before[p]), "param did not move",
                  p)
        del before
        ran = bwd_engine(fa, engine, cfg)
        check_flash_launches(fa, launches, ran, 18 * steps, label)
        # the replay first: an eager step replaces the state the graph
        # holds, and the next run would bind again
        graphed = profile_graphed(torch, exe, m, feeds[steps], scope)
        profile = profile_step(torch, exe, m, feeds[steps], scope)
    finally:
        fa.FLASH_BWD_IMPL = saved
    steady = steady_ms(step_s) / 1e3
    tokens = cfg["batch_size"] * cfg["seq_len"]
    stats = {"params": len(params), "param_values": int(n_values),
             "steps": steps, "engine": engine, "engine_ran": ran,
             "startup_s": startup_s,
             "first_step_ms": step_s[0] * 1e3,
             "capture_step_ms": step_s[1] * 1e3, "step_ms": steady * 1e3,
             "step_ms_all": [t * 1e3 for t in step_s],
             "target_tokens_per_s": tokens / steady,
             "peak_memory_gib": peak / 2 ** 30, "losses": losses,
             "launches": launches, "graphed_profile": graphed,
             "profile": profile}
    log("training %s (Transformer-base, batch %d x %d, vocab %d, dropout "
        "0.1): %s" % (label, cfg["batch_size"], cfg["seq_len"],
                      cfg["trg_vocab_size"], json.dumps(stats)))
    return stats


class RecordSink:
    """A telemetry sink that keeps the trainer's step records (each
    checkpointing step's carries ``checkpoint_save_s``)."""

    wants_records = True
    wants_spans = False

    def __init__(self):
        self.records = []

    def emit(self, record):
        if record.get("source") == "trainer":
            self.records.append(record)


def trainer_samples(n, seed, cfg):
    """``n`` seeded Transformer samples: (src, trg, lbl) rows of
    ``cfg["seq_len"]`` tokens with their own lengths, as make_feeds'."""
    f = make_feeds(np.random.RandomState(seed), n, cfg["seq_len"],
                   cfg["trg_vocab_size"])
    return list(zip(f["src_word"], f["trg_word"], f["lbl_word"]))


def transformer_trainer_funcs(fluid, T, cfg):
    """Trainer's train_func (``layers.data`` and ``T.transformer`` at
    ``cfg``'s widths, dropout 0.1, flash attention) and optimizer_func
    (Adam with noam decay, as get_model's)."""
    def train_func():
        words = [fluid.layers.data(name=n, shape=[cfg["seq_len"]],
                                   dtype="int64")
                 for n in ("src_word", "trg_word", "lbl_word")]
        avg_cost, _sum_cost, _tokens, _logits = T.transformer(
            *words, cfg["src_vocab_size"], cfg["trg_vocab_size"],
            cfg["max_length"], T.N_LAYER, T.N_HEAD, T.D_MODEL, T.D_INNER,
            T.DROPOUT, use_flash=True)
        return avg_cost

    def optimizer_func():
        lr = fluid.layers.scale(x=fluid.layers.noam_decay(T.D_MODEL, 8000),
                                scale=2.0)
        return fluid.optimizer.AdamOptimizer(learning_rate=lr, beta1=0.9,
                                             beta2=0.98, epsilon=1e-9)

    return train_func, optimizer_func


def host_state(torch, scope, names):
    """Copies of ``names``' values on the host, as CPU tensors."""
    out = {}
    for n in names:
        v = scope[n]
        out[n] = (v.detach().cpu().clone() if isinstance(v, torch.Tensor)
                  else torch.as_tensor(np.array(v)))
    return out


def state_moved(torch, scope, want):
    """The names whose value in ``scope`` differs in bits from ``want``'s
    (host copies; a value loaded from a checkpoint may still be numpy in
    a wider dtype, and is compared in ``want``'s)."""
    out = []
    for n, w in want.items():
        v = scope[n]
        v = (v.detach().cpu() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.array(v)))
        if not bits_equal(torch, v.to(w.dtype), w):
            out.append(n)
    return out


def pipeline_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("paddle-tpu-")]


def trainer_run(fluid, fa, executor_mod, trainer, reader, feed_order,
                stop_at, read=True, **train_kw):
    """One ``trainer.train`` epoch, stopped after step ``stop_at``.  At
    each EndStepEvent: the step's loss (read there when ``read``, which
    waits for the step; else kept as the LazyFetch), the time, B1 and B2
    launches of the step, captures and feed host copies so far.  With
    ``read`` off the run ends with a device sync."""
    import torch

    out = {"steps": [], "losses": [], "end_s": [], "launches": [],
           "compiles": [], "feed_copies": [], "verdicts": []}
    c0 = executor_mod.compile_count()
    f0 = executor_mod.feed_host_copy_count()

    def handler(e):
        if isinstance(e, fluid.BeginStepEvent):
            fa.reset_launch_counts()
        elif isinstance(e, fluid.EndStepEvent):
            loss = e.metrics[0]
            out["losses"].append(np.array(loss) if read else loss)
            out["end_s"].append(time.perf_counter())
            out["steps"].append(e.step)
            out["launches"].append(
                [fa.KERNEL_LAUNCHES["flash_attention_fwd"],
                 fa.KERNEL_LAUNCHES["flash_attention_bwd"]])
            out["compiles"].append(executor_mod.compile_count() - c0)
            out["feed_copies"].append(
                executor_mod.feed_host_copy_count() - f0)
            if train_kw.get("nan_guard"):
                out["verdicts"].append(trainer.exe.last_step_ok())
            if e.step == stop_at:
                trainer.stop()

    out["t0"] = time.perf_counter()
    trainer.train(num_epochs=1, event_handler=handler, reader=reader,
                  feed_order=feed_order, **train_kw)
    torch.cuda.synchronize()
    out["t_end"] = time.perf_counter()
    if not read:
        out["losses"] = [np.array(x) for x in out["losses"]]
    return out


def piped_ms(run, first=2):
    """Mean ms a step of a run whose steps were not read one by one: from
    the end of step ``first - 1`` to the device sync after the last."""
    n = len(run["steps"]) - first
    return (run["t_end"] - run["end_s"][first - 1]) / n * 1e3


def synced_ms(run, skip=(), first=2):
    """Mean ms between EndStepEvents from step ``first`` on (each step's
    loss read at its event), leaving out the steps in ``skip`` (0-based:
    one that follows a checkpoint save)."""
    gaps = [run["end_s"][i] - run["end_s"][i - 1]
            for i in range(first, len(run["end_s"])) if i not in skip]
    return float(np.mean(gaps)) * 1e3


def trainer_phase(torch, fluid, T, fa, obs, dev, fast):
    """Transformer-base at TRAIN_CFG (64 x 256, dropout 0.1, Adam with noam
    decay, f32 with TF32 off) through ``fluid.Trainer`` on the card, the
    reader ``reader.batch(reader.buffered(samples), 64)`` of seeded
    samples.  Trainer A: TRAINER_STEPS steps with device prefetch and
    ``nan_guard``, checkpoints every TRAINER_CKPT_STEPS steps (the newest
    TRAINER_KEEP kept), stopped there: every loss finite and every
    verdict True, B1 and B2 18 launches every step, 1 capture, feed host
    copies flat from the third step on, the serials on disk those after
    steps 8 and 12, each manifest-intact (sizes and crc32s).  Trainer R,
    a fresh one, resumes from the serial after step TRAINER_RESUME_AT
    (``load_serial``) and trains to TRAINER_STEPS without prefetch (its
    feeds converted on the step loop): its losses, every parameter,
    Adam's moments and the noam step counter bitwise A's, 1 capture; then
    ``Trainer.test`` on TRAINER_TEST_BATCHES batches (B1 18 launches a
    batch, B2 none).  Trainer B: TRAINER_TIMED_STEPS steps with losses
    unread, without ``nan_guard``, with it, and without prefetch (the
    cost of the guard's host sync a step), then ``load_checkpoint`` and
    four more steps: one capture more, and what it adds to the pool
    against one state's bytes.  Recorded: step ms and target tokens/s
    from the third step on beside ``train_phase``'s and
    ``fast_path_phase``'s, a profiled replay's idle share, each
    checkpoint save's seconds and bytes, the validated load's seconds,
    peak memory; no ``paddle-tpu-*`` thread left."""
    import gc
    import resource
    import shutil
    import tempfile
    import warnings

    from paddle_tpu_torch import executor as executor_mod
    from paddle_tpu_torch import trainer as trainer_mod
    from paddle_tpu_torch.reader import device_prefetch

    cfg = TRAIN_CFG
    batch = cfg["batch_size"]
    tokens = batch * cfg["seq_len"]
    order = ["src_word", "trg_word", "lbl_word"]
    samples = trainer_samples((TRAINER_STEPS + 4) * batch, SEED + 60, cfg)
    reader = fluid.reader.batch(
        fluid.reader.buffered(lambda: iter(samples), 2 * batch), batch)
    train_func, optimizer_func = transformer_trainer_funcs(fluid, T, cfg)
    cdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    sink = RecordSink()
    obs.add_sink(sink)
    stats = {"batch": batch, "seq_len": cfg["seq_len"], "dropout": 0.1,
             "steps": TRAINER_STEPS}

    def ckpt_config(load_serial=None):
        c = fluid.CheckpointConfig(
            checkpoint_dir=cdir, max_num_checkpoints=TRAINER_KEEP,
            step_interval=TRAINER_CKPT_STEPS)
        c.load_serial = load_serial
        return c

    def replay_profile(t):
        """A replay of ``t``'s guarded training entry, profiled (busy
        and idle only); fails if it captured or bound anything."""
        feeder = fluid.DataFeeder([t.train_program.global_block().var(n)
                                   for n in order], fluid.CUDAPlace(0),
                                  program=t.train_program)
        feed = device_prefetch.put_feed_on_device(
            feeder._feed_host(samples[:batch]), t.exe, t.train_program)
        entries = set(map(id, t.exe._bound.values()))
        c = executor_mod.compile_count()
        with fluid.scope_guard(t.scope):
            out = busy_idle(profile_call(torch, lambda: t.exe.run(
                t.train_program, feed=feed, fetch_list=t.train_func_outputs,
                nan_guard=True)))
        check(executor_mod.compile_count() == c
              and set(map(id, t.exe._bound.values())) == entries,
              "the profiled trainer step did not replay its entry")
        if isinstance(out, dict):
            out["path"] = "graphed (a CUDA-graph replay of the Trainer's entry)"
        return out

    try:
        # -- A: train, checkpoint, stop after TRAINER_STEPS --------------
        np.random.seed(SEED + 61)
        t0 = time.perf_counter()
        a = fluid.Trainer(train_func, optimizer_func,
                          place=fluid.CUDAPlace(0),
                          checkpoint_config=ckpt_config())
        torch.cuda.synchronize()
        stats["construct_s"] = time.perf_counter() - t0
        names = sorted(n for n in a.train_program.persistable_names()
                       if n in a.scope)
        state_bytes = sum(a.scope[n].numel() * a.scope[n].element_size()
                          for n in names)
        stats.update({"persistables": len(names),
                      "state_bytes": int(state_bytes),
                      "param_values": int(sum(
                          a.scope[p.name].numel() for p in
                          a.train_program.global_block().all_parameters()))})
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        run_a = trainer_run(fluid, fa, executor_mod, a, reader, order,
                            TRAINER_STEPS - 1, nan_guard=True, prefetch=True)
        peak = torch.cuda.max_memory_allocated(dev)
        rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        check(run_a["steps"] == list(range(TRAINER_STEPS)),
              "trainer A steps", run_a["steps"])
        check(all(np.isfinite(x).all() for x in run_a["losses"])
              and run_a["verdicts"] == [True] * TRAINER_STEPS
              and a.nan_bad_steps == 0, "trainer A: a non-finite step",
              run_a["losses"], run_a["verdicts"])
        check(all(n == [18, 18] for n in run_a["launches"]),
              "trainer A: B1 and B2 18 launches a step", run_a["launches"])
        check(run_a["compiles"][0] == 0 and run_a["compiles"][1:]
              == [1] * (TRAINER_STEPS - 1), "trainer A: one capture",
              run_a["compiles"])
        check(len(set(run_a["feed_copies"][2:])) == 1,
              "trainer A: feed host copies after the second step",
              run_a["feed_copies"])
        serials = trainer_mod._serials(cdir)
        saves = [r["checkpoint_save_s"] for r in sink.records
                 if "checkpoint_save_s" in r]
        want_serials = list(range(TRAINER_STEPS // TRAINER_CKPT_STEPS
                                  - TRAINER_KEEP + 1,
                                  TRAINER_STEPS // TRAINER_CKPT_STEPS + 1))
        check(serials == want_serials and len(saves)
              == TRAINER_STEPS // TRAINER_CKPT_STEPS,
              "trainer A: checkpoint serials", serials, saves)
        for s in serials:
            d = os.path.join(cdir, "checkpoint_%d" % s)
            man = json.load(open(os.path.join(d, "MANIFEST.json")))
            check(trainer_mod._checkpoint_intact(d) and set(man["files"])
                  == {"params.npz", "meta.json", "rng_state.npy"}
                  and man["meta"] == {"epoch": 0,
                                      "step": s * TRAINER_CKPT_STEPS},
                  "trainer A: checkpoint %d" % s, man)
        ckpt_bytes = {s: sum(os.path.getsize(os.path.join(
            cdir, "checkpoint_%d" % s, f)) for f in os.listdir(
                os.path.join(cdir, "checkpoint_%d" % s))) for s in serials}
        # gaps ending at a step that follows a save hold the save
        after_save = {i for i in range(TRAINER_STEPS)
                      if i % TRAINER_CKPT_STEPS == 0 and i}
        step_ms = synced_ms(run_a, skip=after_save)
        stats.update({
            "step_ms": step_ms, "target_tokens_per_s": tokens / step_ms * 1e3,
            "step_ms_all": [(end - start) * 1e3 for start, end in zip(
                [run_a["t0"]] + run_a["end_s"][:-1], run_a["end_s"])],
            "steps_left_out_for_saves": sorted(after_save),
            "losses": [float(x) for x in run_a["losses"]],
            "launches_by_step": run_a["launches"],
            "compiles_by_step": run_a["compiles"],
            "feed_host_copies_by_step": run_a["feed_copies"],
            "peak_memory_gib": peak / 2 ** 30,
            "checkpoint_save_s": saves,
            "checkpoint_bytes": {str(s): b for s, b in ckpt_bytes.items()},
            "host_maxrss_gib_before_after": [rss0 / 2 ** 20, rss1 / 2 ** 20],
            "fast_path_graphed_step_ms": fast["graphed_step_ms"]})
        stats["vs_fast_path"] = step_ms / fast["graphed_step_ms"] - 1.0
        want = host_state(torch, a.scope, names)   # the state after step 12
        stats["graphed_profile"] = replay_profile(a)
        del a
        gc.collect()
        torch.cuda.empty_cache()

        # -- R: a fresh Trainer resumes from the serial after step 8 ------
        load0 = obs.timer("checkpoint.load").total
        np.random.seed(SEED + 62)   # another start: the checkpoint sets it
        t0 = time.perf_counter()
        r = fluid.Trainer(
            train_func, optimizer_func, place=fluid.CUDAPlace(0),
            checkpoint_config=ckpt_config(
                load_serial=TRAINER_RESUME_AT // TRAINER_CKPT_STEPS))
        torch.cuda.synchronize()
        stats["resume_construct_s"] = time.perf_counter() - t0
        stats["resume_load_s"] = obs.timer("checkpoint.load").total - load0
        check(r._step_start == TRAINER_RESUME_AT, "resume position",
              r._step_start)
        run_r = trainer_run(fluid, fa, executor_mod, r, reader, order,
                            TRAINER_STEPS - 1, nan_guard=True, prefetch=False)
        check(run_r["steps"] == list(range(TRAINER_RESUME_AT, TRAINER_STEPS)),
              "resumed steps", run_r["steps"])
        check([x.tobytes() for x in run_r["losses"]]
              == [x.tobytes() for x in run_a["losses"][TRAINER_RESUME_AT:]],
              "resumed losses not bitwise the first run's",
              [float(x) for x in run_r["losses"]])
        moved = state_moved(torch, r.scope, want)
        check(not moved, "resumed state not bitwise the first run's",
              moved[:8])
        check(run_r["compiles"][-1] == 1 and all(
            n == [18, 18] for n in run_r["launches"]),
              "resumed run: one capture, B1 and B2 18 a step",
              run_r["compiles"], run_r["launches"])
        del want
        test_samples = trainer_samples(TRAINER_TEST_BATCHES * batch,
                                       SEED + 64, cfg)
        fa.reset_launch_counts()
        c0 = executor_mod.compile_count()
        t0 = time.perf_counter()
        metrics = r.test(reader=fluid.reader.batch(
            lambda: iter(test_samples), batch), feed_order=order)
        test_s = time.perf_counter() - t0
        test_launches = dict(fa.KERNEL_LAUNCHES)
        check(len(metrics) == 1 and np.isfinite(metrics[0])
              and test_launches["flash_attention_fwd"]
              == 18 * TRAINER_TEST_BATCHES
              and test_launches["flash_attention_bwd"] == 0,
              "Trainer.test: B1 18 a batch, B2 none", metrics, test_launches)
        stats["resume"] = {
            "serial": TRAINER_RESUME_AT // TRAINER_CKPT_STEPS,
            "steps": run_r["steps"], "prefetch": False,
            "bitwise_losses_and_state": True,
            "compiles_by_step": run_r["compiles"],
            "launches_by_step": run_r["launches"]}
        stats["test"] = {"batches": TRAINER_TEST_BATCHES,
                         "mean_loss": metrics[0], "seconds": test_s,
                         "launches": test_launches,
                         "compiles": executor_mod.compile_count() - c0}
        del r
        gc.collect()
        torch.cuda.empty_cache()

        # -- B: the guard's sync, prefetch off, a rebind -----------------
        np.random.seed(SEED + 63)
        b = fluid.Trainer(train_func, optimizer_func,
                          place=fluid.CUDAPlace(0))
        timed = {}
        for label, kw in (("plain", dict(nan_guard=False, prefetch=True)),
                          ("nan_guard", dict(nan_guard=True, prefetch=True)),
                          ("no_prefetch", dict(nan_guard=False,
                                               prefetch=False))):
            run = trainer_run(fluid, fa, executor_mod, b, reader, order,
                              TRAINER_TIMED_STEPS - 1, read=False, **kw)
            check(all(np.isfinite(x).all() for x in run["losses"])
                  and all(n == [18, 18] for n in run["launches"]),
                  "trainer B %s" % label, run["launches"])
            timed[label] = {"step_ms": piped_ms(run),
                            "captures": run["compiles"][-1],
                            "feed_host_copies": run["feed_copies"][-1]}
            timed[label]["target_tokens_per_s"] = (
                tokens / timed[label]["step_ms"] * 1e3)
        check([timed[k]["captures"] for k in ("plain", "nan_guard",
                                              "no_prefetch")] == [1, 1, 0],
              "trainer B captures", timed)
        timed["guard_sync_cost"] = (timed["nan_guard"]["step_ms"]
                                    / timed["plain"]["step_ms"] - 1.0)
        stats["timed_unread"] = timed
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved(dev)
        with fluid.scope_guard(b.scope):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                t0 = time.perf_counter()
                meta = fluid.load_checkpoint(b.exe, cdir, b.train_program)
                stats["validated_load_s"] = time.perf_counter() - t0
        check(meta["serial"] == serials[-1], "load_checkpoint serial", meta)
        run = trainer_run(fluid, fa, executor_mod, b, reader, order, 3,
                          prefetch=True)
        grown = [e.pool_bytes for e in b.exe._bound.values()
                 if e.step is not None]
        check(run["compiles"] == [0, 1, 1, 1], "rebind: one capture more",
              run["compiles"])
        new_pool = max(e.pool_bytes for e in b.exe._bound.values()
                       if e.step is not None and e.program is b.train_program
                       and not e.nan_guard)
        check(new_pool <= state_bytes, "the rebind's capture grew the pool "
              "by more than one state", new_pool, state_bytes)
        stats["rebind"] = {
            "compiles_by_step": run["compiles"],
            "capture_added_to_pool_gib": new_pool / 2 ** 30,
            "pool_gib_by_capture": [g / 2 ** 30 for g in grown],
            "state_gib": state_bytes / 2 ** 30,
            "reserved_gib_before_after": [
                reserved0 / 2 ** 30,
                torch.cuda.memory_reserved(dev) / 2 ** 30]}
        del b
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        obs.remove_sink(sink)
        shutil.rmtree(cdir, ignore_errors=True)
    deadline = time.monotonic() + 5
    while pipeline_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    check(not pipeline_threads(), "reader threads left", pipeline_threads())
    log("trainer (Transformer-base %d x %d, dropout 0.1, through "
        "fluid.Trainer): %s" % (batch, cfg["seq_len"], json.dumps(stats)))
    return stats


def lenet_trainer_funcs(fluid, mnist, holder):
    """LeNet's train_func ([loss, accuracy]; the prediction kept in
    ``holder``), optimizer_func (Adam 1e-3) and infer_func, as
    models.mnist.get_model's."""
    def train_func():
        images = fluid.layers.data(name="pixel", shape=[1, 28, 28],
                                   dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = holder["predict"] = mnist.cnn_model(images)
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        return [fluid.layers.mean(x=cost),
                fluid.layers.accuracy(input=predict, label=label)]

    def optimizer_func():
        return fluid.optimizer.AdamOptimizer(learning_rate=0.001, beta1=0.9,
                                             beta2=0.999)

    def infer_func():
        return mnist.cnn_model(fluid.layers.data(
            name="pixel", shape=[1, 28, 28], dtype="float32"))

    return train_func, optimizer_func, infer_func


def lenet_trainer_phase(torch, fluid, fa, dev, lenet):
    """MNIST LeNet at batch LENET_BATCH through ``fluid.Trainer`` on the
    card, on synthetic_mnist's samples.  Prefetch on, then off, from one
    start, with cuDNN's deterministic algorithms: LENET_TRAINER_STEPS
    steps, losses and state bitwise equal between the two.  Then, with
    the default algorithms on fresh trainers, as many steps with each
    loss read at its event and as many unread: images/s each way beside
    ``lenet_phase``'s graphed figure.  A handler turning ``fetch_metrics`` off on odd steps: a
    second entry, one capture more.  The rewind: ``nan_guard=2``,
    checkpoints every LENET_CKPT_STEPS steps, the batches of steps
    LENET_NAN_STEPS with NaN images: the first guarded step leaves the
    state bitwise unchanged, the second rewinds it to the checkpoint's
    bits (those of checkpoint_1's params.npz), ``nan_rewinds == 1``, one
    capture more after the rewind, then finite steps.  An ``Inferencer``
    on the saved parameters gives the test Program's probabilities on
    one batch.  Then the reader entry points (lenet_reader_checks) and
    a ``FailureMonitor`` checkpoint-then-stop."""
    import gc
    import shutil
    import tempfile
    import warnings

    from paddle_tpu_torch import executor as executor_mod
    from paddle_tpu_torch import trainer as trainer_mod
    from paddle_tpu_torch.models import mnist

    holder = {}
    train_func, optimizer_func, infer_func = lenet_trainer_funcs(
        fluid, mnist, holder)
    order = ["pixel", "label"]
    samples = synthetic_mnist(LENET_BATCH * LENET_TRAINER_STEPS, SEED + 70)
    reader = fluid.reader.batch(lambda: iter(samples), LENET_BATCH)
    stats = {"batch": LENET_BATCH, "steps": LENET_TRAINER_STEPS,
             "lenet_phase_graphed_images_per_s": lenet["images_per_s"]}
    # cuDNN's default convolution algorithms are not deterministic (two
    # runs of one trainer differ in the last bits from the third step on),
    # so the bitwise legs run with deterministic algorithms, each on a
    # trainer of its own (a captured graph keeps the algorithms it was
    # captured with); the timed legs run the defaults, as lenet_phase
    exact, timed_t = {}, {}
    for prefetch in (True, False):
        kw = dict(prefetch=prefetch)
        np.random.seed(SEED + 71)
        t = fluid.Trainer(train_func, optimizer_func,
                          place=fluid.CUDAPlace(0))
        torch.backends.cudnn.deterministic = True
        try:
            run = trainer_run(fluid, fa, executor_mod, t, reader, order,
                              LENET_TRAINER_STEPS - 1, **kw)
        finally:
            torch.backends.cudnn.deterministic = False
        names = sorted(n for n in t.train_program.persistable_names()
                       if n in t.scope)
        exact[prefetch] = (run, host_state(torch, t.scope, names))
        np.random.seed(SEED + 71)
        t = timed_t[prefetch] = fluid.Trainer(
            train_func, optimizer_func, place=fluid.CUDAPlace(0))
        synced = trainer_run(fluid, fa, executor_mod, t, reader, order,
                             LENET_TRAINER_STEPS - 1, **kw)
        piped = trainer_run(fluid, fa, executor_mod, t, reader, order,
                            LENET_TRAINER_STEPS - 1, read=False, **kw)
        check(all(np.isfinite(x).all() for x in synced["losses"]
                  + piped["losses"]), "lenet trainer: a non-finite loss")
        stats["prefetch" if prefetch else "no_prefetch"] = {
            "images_per_s_read_each_step":
                LENET_BATCH / synced_ms(synced) * 1e3,
            "images_per_s_unread": LENET_BATCH / piped_ms(piped) * 1e3,
            "step_ms_read_each_step": synced_ms(synced),
            "step_ms_unread": piped_ms(piped),
            "captures": [run["compiles"][-1], synced["compiles"][-1],
                         piped["compiles"][-1]],
            "feed_host_copies": [synced["feed_copies"][-1],
                                 piped["feed_copies"][-1]],
            "losses_read_each_step": [x.tobytes() for x in
                                      synced["losses"]]}
    on = [x.tobytes() for x in exact[True][0]["losses"]]
    off = [x.tobytes() for x in exact[False][0]["losses"]]
    check(on == off and all(np.isfinite(x).all()
                            for x in exact[True][0]["losses"]),
          "lenet trainer: prefetch on and off losses differ",
          [float(x) for x in exact[True][0]["losses"]],
          [float(x) for x in exact[False][0]["losses"]])
    moved = [n for n in exact[True][1] if not bits_equal(
        torch, exact[True][1][n], exact[False][1][n])]
    check(not moved, "lenet trainer: prefetch on and off state differs",
          moved)
    default_same = (stats["prefetch"].pop("losses_read_each_step")
                    == stats["no_prefetch"].pop("losses_read_each_step"))
    stats["prefetch_on_off_bitwise"] = {
        "cudnn_deterministic": True,
        "default_algorithms_losses_equal": default_same}
    stats["prefetch_gain"] = (stats["prefetch"]["images_per_s_read_each_step"]
                              / stats["no_prefetch"][
                                  "images_per_s_read_each_step"] - 1.0)

    # a handler turning fetch_metrics off: a second entry, a second capture
    t = timed_t[True]
    c0 = executor_mod.compile_count()

    def every_other(e):
        if isinstance(e, fluid.BeginStepEvent):
            e.fetch_metrics = e.step % 2 == 0

    t.train(num_epochs=1, reader=reader, feed_order=order,
            event_handler=every_other)
    graphs = [e for e in t.exe._bound.values()
              if e.program is t.train_program and e.step is not None]
    check(len(graphs) == 2 and executor_mod.compile_count() - c0 == 1,
          "lenet trainer: fetch_metrics off makes one more entry",
          len(graphs), executor_mod.compile_count() - c0)
    stats["fetch_metrics_off"] = {
        "graphed_entries": len(graphs),
        "captures_added": executor_mod.compile_count() - c0,
        "pool_gib_by_capture": [e.pool_bytes / 2 ** 30 for e in graphs]}
    del exact, timed_t, t, graphs
    gc.collect()
    torch.cuda.empty_cache()

    # the rewind: two NaN batches under nan_guard=2
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lenet_ckpt_")
    pdir = tempfile.mkdtemp(prefix="chip_smoke_lenet_params_")
    try:
        np.random.seed(SEED + 72)
        w = fluid.Trainer(
            train_func, optimizer_func, place=fluid.CUDAPlace(0),
            checkpoint_config=fluid.CheckpointConfig(
                checkpoint_dir=ckdir, max_num_checkpoints=LENET_REWIND_STEPS,
                step_interval=LENET_CKPT_STEPS))
        names = sorted(n for n in w.train_program.persistable_names()
                       if n in w.scope)
        clean = synthetic_mnist(LENET_BATCH * LENET_REWIND_STEPS, SEED + 73)
        batches = [clean[i * LENET_BATCH:(i + 1) * LENET_BATCH]
                   for i in range(LENET_REWIND_STEPS)]
        for s in LENET_NAN_STEPS:
            batches[s] = [(np.full_like(x, np.nan), y) for x, y in batches[s]]
        snaps, verdicts, losses, compiles = {}, [], [], []
        c0 = executor_mod.compile_count()

        def handler(e):
            if isinstance(e, fluid.EndStepEvent):
                verdicts.append(w.exe.last_step_ok())
                losses.append(np.array(e.metrics[0]))
                compiles.append(executor_mod.compile_count() - c0)
                snaps[e.step] = host_state(torch, w.scope, names)

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            w.train(num_epochs=1, event_handler=handler,
                    reader=lambda: iter(batches), feed_order=order,
                    nan_guard=2)
        first, second = LENET_NAN_STEPS
        ckpt_step = (first // LENET_CKPT_STEPS) * LENET_CKPT_STEPS - 1
        check([i for i, v in enumerate(verdicts) if v is not True]
              == list(LENET_NAN_STEPS), "lenet rewind: verdicts", verdicts)
        check(w.nan_bad_steps == 2 and w.nan_rewinds == 1
              and any("rewound" in str(c.message) for c in caught),
              "lenet rewind: counts", w.nan_bad_steps, w.nan_rewinds)
        moved = [n for n in names if not bits_equal(
            torch, snaps[first][n], snaps[first - 1][n])]
        check(not moved, "lenet rewind: a guarded step changed state", moved)
        moved = [n for n in names if not bits_equal(
            torch, snaps[second][n], snaps[ckpt_step][n])]
        check(not moved, "lenet rewind: state after the rewind is not the "
              "checkpoint's", moved)
        serial = 1 + ckpt_step // LENET_CKPT_STEPS
        saved = np.load(os.path.join(ckdir, "checkpoint_%d" % serial,
                                     "params.npz"))
        moved = [n for n in names if n in saved and
                 snaps[second][n].numpy().tobytes() != saved[n].tobytes()]
        check(not moved and len(saved.files) == len(names),
              "lenet rewind: state is not checkpoint_%d's" % serial, moved)
        check(all(np.isfinite(x).all() for x in losses[second + 1:])
              and all(bool(torch.isfinite(v).all())
                      for v in snaps[LENET_REWIND_STEPS - 1].values()
                      if v.is_floating_point()),
              "lenet rewind: training did not go on finite", losses)
        # one capture before the NaN steps, one more after the rewind
        check(compiles[second] == 1 and compiles[-1] == 2
              and compiles[second + 1] == 1 and compiles[second + 2] == 2,
              "lenet rewind: captures", compiles)
        stats["rewind"] = {"nan_steps": list(LENET_NAN_STEPS),
                           "verdicts": verdicts,
                           "checkpoint_serial": serial,
                           "nan_bad_steps": w.nan_bad_steps,
                           "nan_rewinds": w.nan_rewinds,
                           "compiles_by_step": compiles,
                           "losses": [float(x) for x in losses]}

        # the Inferencer on the saved parameters against the test Program
        w.save_params(pdir)
        inf = fluid.Inferencer(infer_func, pdir, place=fluid.CUDAPlace(0))
        images = np.stack([x for x, _ in clean[:LENET_BATCH]])
        labels = np.array([[y] for _, y in clean[:LENET_BATCH]], np.int64)
        (got,) = inf.infer({"pixel": images})
        with fluid.scope_guard(w.scope):
            (want,) = w.exe.run(w.test_program,
                                feed={"pixel": images, "label": labels},
                                fetch_list=[holder["predict"]])
        got, want = np.asarray(got), np.asarray(want)
        err = float(np.abs(got - want).max())
        check(got.shape == want.shape == (LENET_BATCH, 10)
              and err <= 1e-6 * float(np.abs(want).max()),
              "Inferencer against Trainer.test's Program", err)
        stats["inferencer"] = {"max_abs_err": err,
                               "bitwise": got.tobytes() == want.tobytes()}
        stats["reader_entry_points"] = lenet_reader_checks(
            torch, fluid, mnist, executor_mod, w, order, clean, holder)
        del w, inf
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        shutil.rmtree(pdir, ignore_errors=True)
    stats["failure_monitor"] = lenet_failure_monitor_check(
        fluid, trainer_mod, train_func, optimizer_func, order, reader)
    gc.collect()
    torch.cuda.empty_cache()
    log("lenet trainer (MNIST, batch %d, through fluid.Trainer): %s"
        % (LENET_BATCH, json.dumps(stats)))
    return stats


def lenet_reader_checks(torch, fluid, mnist, executor_mod, w, order,
                        samples, holder):
    """The reader entry points on the card, on LeNet: the test Program
    fed by ``DataFeeder.to_device_reader`` (feeds already on the card, no
    host feed copy, each loss finite), and a ``layers.py_reader``
    Program trained without feeds until ``core.EOFException``: each loss
    finite, every run counted as ``graph_refused{op=py_reader}`` and
    none bound."""
    from paddle_tpu_torch import observability as obs

    batches = [samples[i * LENET_BATCH:(i + 1) * LENET_BATCH]
               for i in range(3)]
    feeder = fluid.DataFeeder([w.test_program.global_block().var(n)
                               for n in order], fluid.CUDAPlace(0),
                              program=w.test_program)
    feeds = feeder.to_device_reader(lambda: iter(batches), w.exe,
                                    w.test_program)()
    f0 = executor_mod.feed_host_copy_count()
    losses = []
    with fluid.scope_guard(w.scope):
        for feed in feeds:
            check(all(v.is_cuda for v in feed.values()),
                  "to_device_reader gave a host feed")
            (loss,) = w.exe.run(w.test_program, feed=feed,
                                fetch_list=[w.train_func_outputs[0]])
            losses.append(float(np.ravel(loss)[0]))
    check(len(losses) == len(batches) and np.isfinite(losses).all()
          and executor_mod.feed_host_copy_count() == f0,
          "DataFeeder.to_device_reader on the card", losses)
    out = {"to_device_reader_losses": losses}

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        r = fluid.layers.py_reader(
            capacity=4, shapes=[(-1, 1, 28, 28), (-1, 1)],
            dtypes=["float32", "int64"])
        images, label = fluid.layers.read_file(fluid.layers.double_buffer(r))
        predict = mnist.cnn_model(images)
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=predict, label=label))
        fluid.optimizer.AdamOptimizer(learning_rate=0.001).minimize(loss)
    host = [(np.stack([x for x, _ in b]),
             np.array([[y] for _, y in b], np.int64)) for b in batches]
    r.decorate_paddle_reader(lambda: iter(host))
    refused = obs.counter("executor.graph_refused", {"op": "py_reader"})
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        r0 = refused.value
        r.start()
        while True:
            try:
                (lv,) = exe.run(main, fetch_list=[loss])
            except fluid.core.EOFException:
                break
            losses.append(float(np.ravel(lv)[0]))
        r.reset()
    check(len(losses) == len(host) and np.isfinite(losses).all()
          and refused.value - r0 == len(host)
          and not any(b.program is main for b in exe._bound.values()),
          "py_reader on the card", losses, refused.value - r0)
    out.update({"py_reader_losses": losses,
                "py_reader_runs_refused": refused.value - r0})
    return out


def lenet_failure_monitor_check(fluid, trainer_mod, train_func,
                                optimizer_func, order, reader):
    """``FailureMonitor`` with a stale peer heartbeat: ``Trainer.train``
    on the card saves a checkpoint and stops before its first step."""
    import shutil
    import tempfile

    hb = tempfile.mkdtemp(prefix="chip_smoke_hb_")
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_fm_ckpt_")
    try:
        with open(os.path.join(hb, "trainer1.hb"), "w") as f:
            f.write(str(time.time() - 100))
        mon = fluid.FailureMonitor(hb, trainer_id="trainer0", interval=0.05,
                                   timeout=1.0, check_every=0.0)
        t = fluid.Trainer(train_func, optimizer_func,
                          place=fluid.CUDAPlace(0),
                          checkpoint_config=fluid.CheckpointConfig(
                              checkpoint_dir=ckdir, step_interval=100))
        steps = []
        t.train(num_epochs=2, reader=reader, feed_order=order,
                failure_monitor=mon,
                event_handler=lambda e: steps.append(e.step)
                if isinstance(e, fluid.EndStepEvent) else None)
        meta = json.load(open(os.path.join(ckdir, "checkpoint_1",
                                           "meta.json")))
        check(mon.failed_peers == ["trainer1"] and steps == []
              and trainer_mod._serials(ckdir) == [1]
              and meta == {"epoch": 0, "step": 0} and not mon._started,
              "FailureMonitor checkpoint-then-stop", mon.failed_peers,
              steps, meta)
    finally:
        shutil.rmtree(hb, ignore_errors=True)
        shutil.rmtree(ckdir, ignore_errors=True)
    return {"failed_peers": ["trainer1"], "steps_run": 0,
            "checkpoint_meta": meta}


def bf16_state(torch, program_fn, m, dev, seed):
    """bench.py:383-389's bf16 state: the startup run on ``dev``, then
    every float32 entry cast to bfloat16 (parameters, Adam's moments, the
    learning rate, the step counter and the beta powers alike)."""
    state = program_fn.init_state(m["startup"], seed=seed, device=dev)
    return {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v)
            for k, v in state.items()}


def bf16_step_errors(grads, gates, a, b):
    """One bf16 training step ``a`` (the loss, then each of ``grads``,
    then each ReLU gate's pre-activation of ``gates``, as float64 numpy)
    against ``b``: the loss in bf16 ulps of ``b``'s; all gradients
    together, L2 distance over L2 norm; each gradient's L2 distance
    relative to its norm, where a unit whose ReLU gate is open on one side
    only is left out of its own fc's weight column and bias element (in
    bf16 many pre-activations lie within a rounding of 0: such a flip
    moves the unit's column by a token's whole contribution; counted)."""
    n = len(grads)
    loss, ref = float(a[0].ravel()[0]), float(b[0].ravel()[0])
    ulp = 2.0 ** (np.floor(np.log2(abs(ref))) - 7)
    flipped, flips = {}, 0
    for i, (_, w, bias) in enumerate(gates):
        diff = (a[1 + n + i] > 0) != (b[1 + n + i] > 0)
        flips += int(diff.sum())
        units = np.nonzero(diff.reshape(-1, diff.shape[-1]).any(0))[0]
        if len(units):
            flipped[w + "@GRAD"] = flipped[bias + "@GRAD"] = units
    num = den = 0.0
    per = {}
    for name, g, r in zip(grads, a[1:1 + n], b[1:1 + n]):
        num += float(np.sum((g - r) ** 2))
        den += float(np.sum(r ** 2))
        d, rr = g - r, r
        if name in flipped:
            keep = np.ones(r.shape[-1], bool)
            keep[flipped[name]] = False
            d, rr = d[..., keep], r[..., keep]
        per[name] = float(np.linalg.norm(d)) / max(float(np.linalg.norm(rr)),
                                                   1e-30)
    worst = max(per, key=per.get)
    return {"loss": loss, "loss_ulps": abs(loss - ref) / ulp,
            "grad_global_l2": (num / max(den, 1e-300)) ** 0.5,
            "grad_l2_worst": per[worst], "grad_l2_worst_name": worst,
            "grad_l2_median": float(np.median(list(per.values()))),
            "relu_gate_flips": flips,
            "units_left_out": int(sum(len(v) for v in flipped.values()) // 2),
            "grad_l2": per}


def bf16_noise_ratios(errs, noise):
    """Each gradient's distance in ``errs`` over its bf16 noise in
    ``noise`` (bf16_step_errors of the same bf16 step against the float32
    step from the same state), the noise floored at BF16_NOISE_FLOOR;
    gradients whose noise exceeds BF16_NOISE_CEIL are left out."""
    return {n: d / max(noise["grad_l2"][n], BF16_NOISE_FLOOR)
            for n, d in errs["grad_l2"].items()
            if noise["grad_l2"][n] <= BF16_NOISE_CEIL}


def transformer_bf16_check(torch, fluid, T, fa, dev):
    """One training step of Transformer-base at full width, batch
    CHECK_CFG (2 x 64, dropout 0), from bench.py's bf16 state through
    program_to_fn on the card (B1 and B2 on bf16 tensors) and on the
    port's plain CPU path (bf16_step_errors): the loss within
    BF16_LOSS_ULPS bf16 ulps of the CPU's, all gradients (bf16, as their
    parameters) within BF16_GRAD_GLOBAL_L2 in L2, their median within
    BF16_GRAD_MEDIAN_L2, and each within BF16_GRAD_FACTOR times its own
    bf16 noise (the CPU's bf16 step against its float32 step from the
    same state, bf16_noise_ratios); the same step with PyTorch's
    reduced-precision bf16 reduction recorded beside it."""
    from paddle_tpu_torch import program_fn

    with fluid.unique_name.guard():
        m = T.get_model(**CHECK_CFG)
    cpu = torch.device("cpu")
    state = bf16_state(torch, program_fn, m, cpu, SEED + 70)
    feed = make_feeds(np.random.RandomState(SEED + 71),
                      CHECK_CFG["batch_size"], CHECK_CFG["seq_len"],
                      CHECK_CFG["trg_vocab_size"])
    grads = [p.name + "@GRAD"
             for p in m["main"].global_block().all_parameters() if p.trainable]
    gates = relu_gates(m["main"])
    fetch = [m["loss"]] + grads + [pre for pre, _, _ in gates]

    def step(device):
        fn = program_fn.program_to_fn(m["main"], fetch, device=device)
        return [t.cpu() for t in fn(state, feed)]

    fa.reset_launch_counts()
    card = step(dev)
    launches = {k: dict(v) for k, v in fa.KERNEL_LAUNCHES_BY_DTYPE.items()}
    with reduced_precision_reduction(torch):
        reduced = step(dev)
    t0 = time.perf_counter()
    ref = step(cpu)
    cpu_s = time.perf_counter() - t0
    # the CPU's float32 step from the same state widened: each gradient's
    # own bf16 noise
    bf16 = state
    state = {k: (v.float() if v.dtype == torch.bfloat16 else v)
             for k, v in bf16.items()}
    wide = step(cpu)
    state = bf16

    def errors(a, b=ref):
        out = bf16_step_errors(grads, gates, [t.double().numpy() for t in a],
                               [t.double().numpy() for t in b])
        out["dtypes"] = sorted({str(t.dtype) for t in a[:1 + len(grads)]})
        return out

    noise = errors(ref, wide)

    def against_noise(e):
        ratios = bf16_noise_ratios(e, noise)
        worst = max(ratios, key=ratios.get)
        return {"worst": ratios[worst], "worst_name": worst,
                "worst_noise": noise["grad_l2"][worst],
                "median": float(np.median(list(ratios.values()))),
                "held": len(ratios),
                "left_out": sorted(set(e["grad_l2"]) - set(ratios))}

    out = {"loss_cpu": float(ref[0].double()), "card": errors(card),
           "card_reduced_reduction": errors(reduced),
           "cpu_bf16_vs_cpu_f32": noise,
           "launches_by_dtype": launches, "cpu_step_s": cpu_s,
           "limits": {"loss_ulps": BF16_LOSS_ULPS,
                      "grad_global_l2": BF16_GRAD_GLOBAL_L2,
                      "grad_median_l2": BF16_GRAD_MEDIAN_L2,
                      "grad_of_noise": BF16_GRAD_FACTOR,
                      "noise_floor": BF16_NOISE_FLOOR,
                      "noise_ceil": BF16_NOISE_CEIL}}
    out["card"]["of_noise"] = against_noise(out["card"])
    out["card_reduced_reduction"]["of_noise"] = against_noise(
        out["card_reduced_reduction"])
    for k in ("card", "card_reduced_reduction", "cpu_bf16_vs_cpu_f32"):
        out[k].pop("grad_l2")   # per-gradient figures: too long to log
    log("transformer bf16 card vs cpu (batch %d x %d, dropout 0, bench.py's "
        "bf16 state): %s" % (CHECK_CFG["batch_size"], CHECK_CFG["seq_len"],
                             json.dumps(out)))
    e = out["card"]
    check(all(np.isfinite(float(t.double().abs().max()))
              for t in card[:1 + len(grads)]),
          "transformer bf16: non-finite loss or gradient")
    check(e["dtypes"] == ["torch.bfloat16"],
          "transformer bf16: loss or gradients not bf16", e["dtypes"])
    check(e["loss_ulps"] <= BF16_LOSS_ULPS
          and e["grad_global_l2"] <= BF16_GRAD_GLOBAL_L2
          and e["grad_l2_median"] <= BF16_GRAD_MEDIAN_L2
          and e["of_noise"]["worst"] <= BF16_GRAD_FACTOR,
          "transformer bf16 card vs cpu", e)
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        check(launches[name] == {"float32": 0, "bfloat16": 18},
              "transformer bf16 check launches", name, launches[name])
    return out


def bf16_leg(torch, fluid, T, fa, dev, cfg, steps, feeds, seed, label):
    """One of bench.py's Transformer-base legs as bench.py runs it on
    bf16 (bench.py:363-389): get_model(**cfg) (dropout 0.1, Adam with
    noam decay, use_flash=True), the startup's state cast to bf16,
    ``steps`` steps through program_to_fn on device-resident feeds
    (``feeds[i]``; the last one profiled): every loss finite, every
    parameter finite and still bf16 and moved where a warmup update can
    show in bf16, the accumulators float32, B1 and B2 launched 18 times a
    step on bf16 tensors (none on float32); step ms, target tokens/s,
    peak memory, a profiled step's device ms by family and idle share."""
    from paddle_tpu_torch import program_fn

    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    state = bf16_state(torch, program_fn, m, dev, seed)
    trainable = [p.name for p in m["main"].global_block().all_parameters()
                 if p.trainable]
    before = {p: state[p].clone() for p in trainable}
    feeds = [{k: torch.as_tensor(v, device=dev) for k, v in f.items()}
             for f in feeds]
    fn = program_fn.program_to_fn(m["main"], [m["loss"]], return_state=True,
                                  device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        (loss,), state = fn(state, feeds[i], seed=SEED + i)
        losses.append(float(loss.float()))   # waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = {k: dict(v) for k, v in fa.KERNEL_LAUNCHES_BY_DTYPE.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)), label, "bf16 loss", losses)
    # noam's warmup keeps the first steps' Adam updates near
    # learning_rate * d_model**-0.5 * step * warmup**-1.5 * sqrt(1 - b2) /
    # (1 - b1) (1.7e-7 at step 1); bf16 rounds a value v to a spacing of
    # at most v * 2**-7, so an update shows only on values below about
    # 2**8 times it.  A parameter holding such a value must move (in the
    # JAX package too the layer norms' scales, all 1.0, stay put)
    update = 2.0 * cfg.get("d_model", 512) ** -0.5 * 8000 ** -1.5 \
        * 0.02 ** 0.5 / 0.1
    unmoved = []
    for p in trainable:
        check(state[p].dtype == torch.bfloat16
              and bool(torch.isfinite(state[p]).all()),
              label, "bf16 parameter", p)
        if torch.equal(state[p], before[p]):
            check(float(before[p].float().abs().min()) >= update * 2 ** 7,
                  label, "bf16 parameter did not move", p)
            unmoved.append(p)
    check(len(unmoved) < len(trainable) / 2, label, "bf16 moved", unmoved)
    del before
    dtypes = sorted({str(v.dtype).replace("torch.", "")
                     for k, v in state.items() if k not in trainable})
    check("float32" in dtypes and all(
        state[k].dtype == torch.float32 for k in state if "moment" in k),
        label, "bf16 accumulators", dtypes)
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        check(launches[name] == {"float32": 0, "bfloat16": 18 * steps},
              label, "bf16 launches", name, launches[name])
    profile = profile_call(torch, lambda: fn(state, feeds[-1]))
    steady = float(np.mean(step_s[1:]))
    tokens = cfg["batch_size"] * cfg["seq_len"]
    out = {
        "shape": [cfg["batch_size"], cfg["seq_len"]], "steps": steps,
        "first_step_ms": step_s[0] * 1e3,
        "step_ms": steady * 1e3, "step_ms_all": [t * 1e3 for t in step_s],
        "target_tokens_per_s": tokens / steady,
        "peak_memory_gib": peak / 2 ** 30, "losses": losses,
        "params_unmoved": unmoved, "params": len(trainable),
        "other_state_dtypes": dtypes, "launches_by_dtype": launches,
        "profile": profile}
    log("training %s bf16 (bench.py's bf16 state, program_to_fn): %s"
        % (label, json.dumps(out)))
    return out


def transformer_bf16_phase(torch, fluid, T, fa, dev, f32):
    """bench.py's Transformer-base leg on bf16 at TRAIN_CFG (64 x 256):
    the card-against-CPU step (transformer_bf16_check), then bf16_leg
    for TRAIN_STEPS steps on seeded feeds whose rows have their own
    lengths, beside the f32 leg ``f32`` of this run."""
    out = {"check": transformer_bf16_check(torch, fluid, T, fa, dev)}
    torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 73)
    feeds = [make_feeds(rng, TRAIN_CFG["batch_size"], TRAIN_CFG["seq_len"],
                        TRAIN_CFG["trg_vocab_size"])
             for _ in range(TRAIN_STEPS + 1)]
    out["train"] = bf16_leg(torch, fluid, T, fa, dev, TRAIN_CFG, TRAIN_STEPS,
                            feeds, SEED + 72, "64 x 256")
    out["train"]["f32_leg"] = {
        "step_ms": f32["step_ms"],
        "target_tokens_per_s": f32["target_tokens_per_s"],
        "peak_memory_gib": f32["peak_memory_gib"], "profile": f32["profile"]}
    log("training 64 x 256 bf16, the f32 leg beside it: %s"
        % json.dumps(out["train"]["f32_leg"]))
    out["launches"] = {k: v["bfloat16"]
                       for k, v in out["train"]["launches_by_dtype"].items()}
    return out


def decorated_transformer(fluid, T, cfg):
    """get_model(**cfg)'s ``main`` and ``startup`` with the Adam optimizer
    wrapped in contrib.mixed_precision's ``decorate`` (get_model's body,
    which takes no such option in either package)."""
    from paddle_tpu_torch.contrib import mixed_precision

    c = dict(dict(n_layer=T.N_LAYER, n_head=T.N_HEAD, d_model=T.D_MODEL,
                  d_inner=T.D_INNER, dropout=T.DROPOUT), **cfg)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(name=n, shape=[c["seq_len"]],
                                   dtype="int64")
                 for n in ("src_word", "trg_word", "lbl_word")]
        loss, _, _, _ = T.transformer(
            *words, c["src_vocab_size"], c["trg_vocab_size"],
            c["max_length"], c["n_layer"], c["n_head"], c["d_model"],
            c["d_inner"], c["dropout"], use_flash=c["use_flash"])
        main.clone(for_test=True)
        lr = fluid.layers.scale(x=fluid.layers.noam_decay(c["d_model"], 8000),
                                scale=2.0)
        mixed_precision.decorate(fluid.optimizer.AdamOptimizer(
            learning_rate=lr, beta1=0.9, beta2=0.98,
            epsilon=1e-9)).minimize(loss)
    return {"main": main, "startup": startup, "loss": loss}


def transformer_decorate_phase(torch, fluid, T, fa, dev, f32):
    """Transformer-base at TRAIN_CFG through contrib.mixed_precision's
    ``decorate`` (decorated_transformer): bf16 ``mul`` and ``matmul``
    on float32 master weights, the flash kernels in float32, Executor.run
    from the f32 leg's startup seed on its first feeds, DECORATE_STEPS
    steps: every loss finite and within DECORATE_LOSS_RTOL of the f32
    leg's loss at the same step (``f32``: the same parameters and feeds;
    the dropout draws differ); B1 and B2 18 launches a step in float32,
    replays included (the steps from the second run as one CUDA graph);
    step ms (steps 3 on), target tokens/s, a replay's idle share and an
    eager step's device ms by op."""
    with fluid.unique_name.guard():
        m = decorated_transformer(fluid, T, TRAIN_CFG)
    m["startup"].random_seed = SEED + 7     # train_phase's
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(m["startup"], scope=scope)
    rng = np.random.RandomState(SEED + 8)   # train_phase's feeds
    feeds = [make_feeds(rng, TRAIN_CFG["batch_size"], TRAIN_CFG["seq_len"],
                        TRAIN_CFG["trg_vocab_size"])
             for _ in range(DECORATE_STEPS)]
    fa.reset_launch_counts()
    losses, step_s = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        (loss,) = exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                          scope=scope)
        losses.append(float(loss))   # reading it waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = {k: dict(v) for k, v in fa.KERNEL_LAUNCHES_BY_DTYPE.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, f32["losses"])]
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        check(launches[name] == {"float32": 18 * DECORATE_STEPS,
                                 "bfloat16": 0},
              "decorate launches", name, launches[name])
    check(all(np.isfinite(losses)) and max(rel) <= DECORATE_LOSS_RTOL,
          "decorate losses", losses, f32["losses"][:DECORATE_STEPS])
    casts = sum(op.type == "cast" for op in m["main"].global_block().ops)
    graphed = profile_graphed(torch, exe, m, feeds[-1], scope)
    profile = profile_ops(torch, exe, m, feeds[-1], scope, [m["loss"]])
    steady = steady_ms(step_s) / 1e3
    tokens = TRAIN_CFG["batch_size"] * TRAIN_CFG["seq_len"]
    out = {"steps": DECORATE_STEPS, "casts": casts, "losses": losses,
           "f32_losses": f32["losses"][:DECORATE_STEPS],
           "loss_rel_to_f32": rel, "limit": DECORATE_LOSS_RTOL,
           "first_step_ms": step_s[0] * 1e3, "step_ms": steady * 1e3,
           "target_tokens_per_s": tokens / steady,
           "launches_by_dtype": launches, "graphed_profile": graphed,
           "profile": profile}
    log("training 64 x 256 through decorate (bf16 mul/matmul, f32 master "
        "weights, flash f32): %s" % json.dumps(out))
    return out


def bench_feeds(batch, seq, vocab):
    """bench.py's feeds (bench.py:391-395): one batch of ids in
    [1, vocab) from RandomState(0), no padding, reused every step."""
    rng = np.random.RandomState(0)
    return {name: rng.randint(1, vocab, size=(batch, seq)).astype(np.int64)
            for name in ("src_word", "trg_word", "lbl_word")}


def flash_bf16_row(torch, fa, dev, flush, batch, seq):
    """B1 and B2 on bfloat16 at [batch, FH, seq, FD], not causal, every
    key visible (bench.py's feeds have no padding): against their plain
    versions (FLASH_TOL's bf16 limits), then flash_timing's times,
    bounds and SDPA in bf16."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 84 + seq)
    q, k, v, do = flash_inputs(torch, dev, gen, torch.bfloat16, seq, seq,
                               B=batch)
    lens_np = np.full(batch, seq, np.int32)
    lens = torch.as_tensor(lens_np, device=dev)
    scale = 1.0 / FD ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, lens, False, scale)
    grads = fa._flash_bwd_cuda(q, k, v, lens, out, lse, do, False, scale)
    f32 = [x.float() for x in (q, k, v, out, do)]
    r_out, r_lse = fa._flash_fwd_reference(*f32[:3], lens, False, scale)
    r_grads = fa._flash_bwd_reference(*f32[:3], lens, f32[3], lse, f32[4],
                                      False, scale)
    fwd_err = max(flash_err(out, r_out, "bfloat16"),
                  flash_err(lse, r_lse, "bfloat16"))
    bwd_err = max(flash_err(g, r, "bfloat16") for g, r in zip(grads, r_grads))
    del q, k, v, do, out, lse, grads, f32, r_out, r_lse, r_grads
    tol_f, tol_b = FLASH_TOL["bfloat16"]
    check(fwd_err <= tol_f and bwd_err <= tol_b, "flash bf16 vs plain",
          batch, seq, fwd_err, bwd_err)
    row = flash_timing(torch, fa, dev, gen, None, False, flush, "bfloat16",
                       B=batch, T=seq, lens_np=lens_np)
    row["fwd"]["max_abs_err"], row["bwd"]["max_abs_err"] = fwd_err, bwd_err
    torch.cuda.empty_cache()
    return row


def long_bf16_phase(torch, fluid, T, fa, dev):
    """bench.py's two other long legs (bench.py:458-461), 16 x 1024 for
    15 steps and 8 x 2048 for 12, through bf16_leg on bench.py's feeds
    (max_length = seq, vocab 30000, dropout 0.1, use_flash=True); then B1
    and B2 at each leg's attention shape ([16, 8, 1024, 64] and
    [8, 8, 2048, 64], bf16, not causal) by flash_bf16_row."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = []
    for batch, seq, steps in BENCH_BF16_LEGS:
        cfg = dict(TRAIN_CFG, batch_size=batch, seq_len=seq, max_length=seq)
        feed = bench_feeds(batch, seq, cfg["trg_vocab_size"])
        leg = bf16_leg(torch, fluid, T, fa, dev, cfg, steps,
                       [feed] * (steps + 1), SEED + 80, "%d x %d" % (batch,
                                                                   seq))
        torch.cuda.empty_cache()
        row = flash_bf16_row(torch, fa, dev, flush, batch, seq)
        for kind in ("fwd", "bwd"):
            r = row[kind]
            log("flash %s bf16 %s full: kernel %.4f ms plain %.4f ms sdpa "
                "%.4f ms bound %.4f ms (%s), err %.3g"
                % (kind, row["shape"], r["ms"], r["plain_ms"],
                   r["library_ms"], r["bound"][0], r["bound"][1],
                   r["max_abs_err"]))
        out.append({"seq": seq, "steps": steps, "leg": leg, "flash": row})
    return out


def beam_sources(rng, n):
    """``n`` source sentences of 8-BEAM_SEQ tokens (ids in [3, vocab)),
    PAD_IDX tails to BEAM_SEQ."""
    src = rng.randint(3, BEAM_WIDTHS["src_vocab_size"],
                      size=(n, BEAM_SEQ)).astype(np.int64)
    for b, n_tok in enumerate(rng.randint(8, BEAM_SEQ + 1, size=n)):
        src[b, n_tok:] = 0
    return src


def widened(fluid, program):
    """``program`` with every float32 variable, dtype attribute and
    constant array float64."""
    def wide(o):
        if isinstance(o, dict):
            return {k: wide(v) for k, v in o.items()}
        if isinstance(o, list):
            return [wide(v) for v in o]
        return "float64" if o == "float32" else o
    return fluid.Program.from_dict(wide(program.to_dict()))


def beam_decode(fluid, device, inf, program, state, src):
    """Decode ``src`` with ``program`` (``inf``'s or its widened copy)
    through Executor.run on ``device`` from ``state`` (in a scope of its
    own); returns the sentence ids and scores as LoDArrays."""
    scope = fluid.Scope()
    for name, value in state.items():
        scope[name] = value
    return fluid.Executor(device=device).run(
        program, feed={"src_word": src},
        fetch_list=[inf["ids"].name, inf["scores"].name], scope=scope,
        return_numpy=False)


def beam_check(torch, fluid, fa, dev, inf, state, src):
    """``inf`` (max_out_len BEAM_CHECK_OUT_LEN) on ``src`` in float64, the
    parameters ``state`` widened, on the card (cuBLAS DGEMMs) and on the
    port's CPU path: the sentence ids and both levels of lengths bitwise,
    the scores within BEAM_SCORE_RTOL; and the float32 decode's agreement
    with the float64 one (recorded, not held: near-ties among 30000
    random logits lie inside float32's card-vs-CPU gap)."""
    cpu = torch.device("cpu")
    state64 = {n: (v.double() if v.is_floating_point() else v).to(cpu)
               for n, v in state.items()}
    p64 = widened(fluid, inf["infer"])
    fa.reset_launch_counts()
    card64 = beam_decode(fluid, dev, inf, p64, state64, src)
    t0 = time.perf_counter()
    cpu64 = beam_decode(fluid, cpu, inf, p64, state64, src)
    cpu_s = time.perf_counter() - t0
    card32 = beam_decode(fluid, dev, inf, inf["infer"], state, src)
    launches = dict(fa.KERNEL_LAUNCHES)
    ids64, sc64 = card64[0], np.asarray(card64[1].data)
    check(ids64.data.dtype == np.int64 and sc64.dtype == np.float64,
          "beam float64 dtypes", ids64.data.dtype, sc64.dtype)
    for field in ("data", "lengths", "sub_lengths"):
        check(np.array_equal(getattr(ids64, field), getattr(cpu64[0], field)),
              "beam float64 card vs cpu", field, getattr(ids64, field),
              getattr(cpu64[0], field))
    ref = np.asarray(cpu64[1].data)
    rel = float(np.max(np.abs(sc64 - ref) / np.maximum(np.abs(ref), 1e-300)))
    check(rel <= BEAM_SCORE_RTOL, "beam float64 scores card vs cpu", rel)
    check(all(n == 0 for n in launches.values()), "beam check launched a "
          "flash kernel", launches)
    ids32 = card32[0]
    rows = ids64.data.shape[0]
    same_rows = [bool(np.array_equal(a, b) and la == lb) for a, b, la, lb in
                 zip(ids32.data, ids64.data, ids32.lengths, ids64.lengths)]
    out = {"sources": len(src), "max_out_len": BEAM_CHECK_OUT_LEN,
           "float64_ids_equal": True, "float64_scores_rel": rel,
           "cpu64_decode_s": cpu_s,
           "float32_vs_float64": {
               "hypotheses_equal": sum(same_rows), "hypotheses": rows,
               "tokens_equal": int((ids32.data == ids64.data).sum()),
               "tokens": int(ids64.data.size),
               "lengths_equal": int((ids32.lengths == ids64.lengths).sum()),
               "scores_max_rel": float(np.max(
                   np.abs(np.asarray(card32[1].data, np.float64) - sc64)
                   / np.abs(sc64)))},
           "float64_lengths": ids64.lengths.tolist()}
    log("beam search float64 card vs cpu (%d sources, max_out_len %d): %s"
        % (len(src), BEAM_CHECK_OUT_LEN, json.dumps(out)))
    return out


def count_syncs(torch, fn):
    """Run ``fn`` with CUDA's sync debug mode warning, and count the
    device syncs by the Python line that made them."""
    import warnings

    where = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message).lower():
            key = "%s:%d" % (os.path.basename(w.filename), w.lineno)
            where[key] = where.get(key, 0) + 1
    return where


def beam_phase(torch, fluid, T, fa, dev):
    """Transformer-base beam-search inference at bench.py's widths:
    get_inference_model(beam 4, max_out_len 32, seq_len 64) with the
    parameters of get_model(**TRAIN_CFG)'s startup (built under its own
    unique_name guard, as the inference model is), through
    Executor(CUDAPlace(0)).run on BEAM_SOURCES seeded sources; first
    beam_check on two of them.  Checks: every score finite, each source's
    beams' scores non-increasing, every id in [0, vocab), every length in
    [1, max_out_len], ``beam`` rows a source, B1-B5 launched 0 times;
    the fast path refuses to capture the Program (its ``while`` rule
    reads the host), counts the refusal once and runs the bound entry
    eager, with the first decode's bits.
    Recorded: sentences/s, generated tokens/s (sources x max_out_len /
    wall), ms an iteration, the device syncs of a decode by line, peak
    memory, and a profiled decode's device ms by op and idle share."""
    with fluid.unique_name.guard():
        m = T.get_model(**TRAIN_CFG)
    with fluid.unique_name.guard():
        inf = T.get_inference_model(BEAM_SIZE, BEAM_OUT_LEN, BEAM_SEQ,
                                    **BEAM_WIDTHS)
    with fluid.unique_name.guard():
        inf16 = T.get_inference_model(BEAM_SIZE, BEAM_CHECK_OUT_LEN,
                                      BEAM_SEQ, **BEAM_WIDTHS)
    m["startup"].random_seed = SEED + 90
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(m["startup"], scope=scope)
    names = inf["infer"].persistable_names()
    check(names == inf16["infer"].persistable_names()
          and all(n in scope for n in names),
          "inference parameters missing from the training startup",
          [n for n in names if n not in scope])
    # the decode needs the parameters alone, not Adam's moments
    state = {n: scope[n] for n in names}
    scope = fluid.Scope()
    for n, v in state.items():
        scope[n] = v
    src = beam_sources(np.random.RandomState(SEED + 91), BEAM_SOURCES)
    out = {"check": beam_check(torch, fluid, fa, dev, inf16, state,
                               src[:BEAM_CHECK_SOURCES])}
    fetch = [inf["ids"], inf["scores"]]

    def decode():
        return exe.run(inf["infer"], feed={"src_word": src},
                       fetch_list=fetch, scope=scope, return_numpy=False)

    from paddle_tpu_torch import executor as executor_mod, observability

    refused = observability.counter("executor.graph_refused", {"op": "while"})
    r0, c0 = refused.value, executor_mod.compile_count()
    # warm-up (cuBLAS's handles and the allocator's pools), then the timed
    # decodes, each op by op: the ``while`` rule reads its condition on
    # the host, so the Program is never bound or captured
    first = decode()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    walls = []
    for _ in range(BEAM_RUNS):
        t0 = time.perf_counter()
        ids, scores = decode()   # the LoDArray fetches wait for the decode
        walls.append(time.perf_counter() - t0)
        check(all(np.array_equal(getattr(a, k), getattr(b, k))
                  for a, b in ((ids, first[0]), (scores, first[1]))
                  for k in ("data", "lengths", "sub_lengths")),
              "the bound decode differs from the first")
    entries = [b for b in exe._bound.values() if b.program is inf["infer"]]
    check(refused.value - r0 == 1 + BEAM_RUNS and not entries
          and executor_mod.compile_count() == c0,
          "beam search refused capture by while", refused.value - r0,
          len(entries), executor_mod.compile_count() - c0)
    launches = dict(fa.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    vocab = BEAM_WIDTHS["trg_vocab_size"]
    data, lens = ids.data, ids.lengths
    sc = np.asarray(scores.data).reshape(BEAM_SOURCES, BEAM_SIZE)
    check(data.shape == (BEAM_SOURCES * BEAM_SIZE, BEAM_OUT_LEN),
          "beam ids shape", data.shape)
    check(bool(np.isfinite(sc).all()), "beam scores not finite")
    check(bool((np.diff(sc, axis=1) <= 0).all()),
          "beam scores not non-increasing within a source")
    check(bool(((data >= 0) & (data < vocab)).all()), "beam id out of range")
    check(bool(((lens >= 1) & (lens <= BEAM_OUT_LEN)).all()),
          "beam length out of range", lens.min(), lens.max())
    check(ids.sub_lengths.tolist() == [BEAM_SIZE] * BEAM_SOURCES,
          "beam rows a source", ids.sub_lengths)
    check(all(n == 0 for n in launches.values()),
          "beam search launched a flash kernel", launches)
    syncs = count_syncs(torch, decode)
    profile = profile_ops(torch, exe, {"main": inf["infer"]},
                          {"src_word": src}, scope, fetch,
                          families=DECODE_FAMILIES)
    wall = float(np.median(walls))
    iters = BEAM_OUT_LEN - 1
    out["decode"] = {
        "sources": BEAM_SOURCES, "beam": BEAM_SIZE,
        "max_out_len": BEAM_OUT_LEN, "iterations": iters,
        "decode_ms_all": [t * 1e3 for t in walls], "decode_ms": wall * 1e3,
        "sentences_per_s": BEAM_SOURCES / wall,
        "generated_tokens_per_s": BEAM_SOURCES * BEAM_OUT_LEN / wall,
        "ms_per_iteration": wall * 1e3 / iters,
        "host_syncs_by_line": syncs,
        "host_syncs_per_iteration": sum(syncs.values()) / iters,
        "resident_gib": resident / 2 ** 30, "peak_gib": peak / 2 ** 30,
        "decode_peak_over_resident_gib": (peak - resident) / 2 ** 30,
        "hyp_len_mean": float(lens.mean()),
        "hyps_ended": int((data[:, :iters] == T.EOS_IDX).any(1).sum()),
        "graph_refused_by": "while",
        "runs_refused": refused.value - r0, "launches": launches,
        "profile": profile}
    log("beam search (Transformer-base, %d sources of 8-%d tokens, beam %d, "
        "max_out_len %d, f32): %s" % (BEAM_SOURCES, BEAM_SEQ, BEAM_SIZE,
                                      BEAM_OUT_LEN, json.dumps(out["decode"])))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch import cuda_kernels, observability as obs
        from paddle_tpu_torch import serving
        from paddle_tpu_torch.models import transformer as T
        from paddle_tpu_torch.parallel import flash_attention as fa
    except ImportError as exc:
        print("chip_smoke: the paddle_tpu_torch package is not beside this "
              "script (%s)" % exc, file=sys.stderr)
        return 3
    check("jax" not in sys.modules and not any(
        m == "paddle_tpu" or m.startswith("paddle_tpu.") for m in sys.modules),
        "chip_smoke imported jax or paddle_tpu")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card: %s | torch %s, CUDA %s | allow_tf32 matmul=%s cudnn=%s"
        % (card, torch.__version__, torch.version.cuda,
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))

    cuda_kernels.load_library()
    info = cuda_kernels.build_info()
    log("build: %.2f s (%s)" % (info["seconds"], "built" if info["built"]
                                else "reused %s" % info["path"]))
    for name, regs, spill in ptxas_report(info["log"]):
        log("  ptxas: %s: %d registers, %d bytes spilled" % (name, regs, spill))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    dec_checks, dec = decode_phase(torch, fa, dev, flush)
    pre = prefill_phase(torch, fa, dev, flush)
    flash_cases, flash_times = flash_phase(torch, fa, dev, flush)
    pair_cases = pair_phase(torch, fa, dev)
    sweep = engine_sweep(torch, fa, dev, flush)
    del flush
    srv, srv_prompts, srv_outs = serving_phase(torch, T, serving, fa, obs,
                                               dev)
    torch.cuda.empty_cache()
    leg = legacy_phase(torch, T, serving, fa, obs, dev, srv_prompts,
                       srv_outs)
    torch.cuda.empty_cache()
    prd = predict_phase(torch, fluid, T, serving, fa, obs, dev)
    torch.cuda.empty_cache()
    lenet = lenet_phase(torch, fluid, dev)
    op_rule_checks(fluid, dev)
    torch.cuda.empty_cache()
    rsn = resnet_phase(torch, fluid, fa, dev)
    torch.cuda.empty_cache()
    # card vs CPU: B2 at batch 2 x 64, B3 at batch 2 x 200
    fused_check = train_check_phase(torch, fluid, T, fa, dev, CHECK_CFG,
                                    "fused")
    pair_check = train_check_phase(torch, fluid, T, fa, dev, PAIR_CHECK_CFG,
                                   "pair")
    trn = train_phase(torch, fluid, T, fa, dev, TRAIN_CFG, TRAIN_STEPS,
                      "auto", "64 x 256")
    torch.cuda.empty_cache()
    fast = fast_path_phase(torch, fluid, T, fa, dev)
    torch.cuda.empty_cache()
    trainer = trainer_phase(torch, fluid, T, fa, obs, dev, fast)
    torch.cuda.empty_cache()
    lenet_trainer_phase(torch, fluid, fa, dev, lenet)
    torch.cuda.empty_cache()
    lng = train_phase(torch, fluid, T, fa, dev, LONG_CFG, LONG_STEPS,
                      "auto", "4 x 4096")
    torch.cuda.empty_cache()
    resnet_bf16_phase(torch, fluid, fa, dev, rsn)
    torch.cuda.empty_cache()
    tbf = transformer_bf16_phase(torch, fluid, T, fa, dev, trn)
    torch.cuda.empty_cache()
    transformer_decorate_phase(torch, fluid, T, fa, dev, trn)
    torch.cuda.empty_cache()
    beam_phase(torch, fluid, T, fa, dev)
    torch.cuda.empty_cache()
    lbf = long_bf16_phase(torch, fluid, T, fa, dev)

    # each backward engine's main path: the first training leg that auto
    # runs it on, else the full-width card-vs-CPU step that runs it by name
    b2_path, b3_path = (
        next((t for t in (trn, lng) if t["engine_ran"] == engine), step)
        for engine, step in (("fused", fused_check), ("pair", pair_check)))
    d32 = next(r for r in dec
               if r["label"] == "table" and r["dtype"] == "float32")
    p32 = next(r for r in pre if r["dtype"] == "float32"
               and (r["start"], r["C"]) == PREFILL_TIMED[0])
    full = next(t for t in flash_times
                if not t["causal"] and t["dtype"] == "float32")
    full_bf16 = next(t for t in flash_times
                     if not t["causal"] and t["dtype"] == "bfloat16")
    # the long leg's shape, not causal.  No single PyTorch call computes
    # dk/dv alone or dq alone, so their library_ms is null; the pair as a
    # whole stands beside SDPA's autograd backward (dq, dk and dv)
    longest = next(r for r in sweep
                   if tuple(r["shape"]) == SWEEP_SHAPES[3] and not r["causal"])
    pair_vs_library = {"pair_ms": longest["pair_dev_ms"],
                       "pair_library_ms": longest["sdpa_bwd_ms"],
                       "pair_library": "scaled_dot_product_attention "
                                       "autograd backward (dq, dk, dv)"}
    pair_rows = {
        "flash_attention_bwd_dkv": {
            "ms": longest["dkv_ms"], "plain_ms": longest["dkv_plain_ms"],
            "bound": longest["dkv_bound"], "library_ms": None},
        "flash_attention_bwd_dq": {
            "ms": longest["dq_ms"], "plain_ms": longest["dq_plain_ms"],
            "bound": longest["dq_bound"], "library_ms": None}}
    # B1 at the long leg's shape, not causal (device time from the sweep's
    # profiler window), and its launches on the long leg
    fwd_long = {"long_shape": list(SWEEP_SHAPES[3]),
                "long_ms": longest["fwd_dev_ms"],
                "long_plain_ms": longest["fwd_plain_ms"],
                "long_bound_ms": longest["fwd_bound"][0],
                "long_library_ms": longest["sdpa_fwd_ms"],
                "long_launches": lng["launches"]["flash_attention_fwd"]}
    # B2 at the same shape: device time of its three launches, the dq sum's
    # share apart, and its launches on the long leg (0 unless auto runs it)
    bwd_long = {"long_shape": list(SWEEP_SHAPES[3]),
                "long_ms": longest["b2_dev_ms"],
                "long_fused_ms": longest["b2_fused_ms"],
                "long_dq_sum_ms": longest["b2_dq_sum_ms"],
                "long_plain_ms": longest["b2_plain_ms"],
                "long_bound_ms": longest["bound"][0],
                "long_library_ms": longest["sdpa_bwd_ms"],
                "long_launches": lng["launches"]["flash_attention_bwd"]}
    # B1 on the legacy prefill's serving path: its launches there and its
    # figures at bucket 1024
    b1_1024 = next(r for r in leg["b1"] if r["bucket"] == 1024)
    legacy_b1 = {"legacy_shape": [1, H, 1024, DH],
                 "legacy_kv_len": b1_1024["kv_len"],
                 "legacy_ms": b1_1024["ms"],
                 "legacy_plain_ms": b1_1024["plain_ms"],
                 "legacy_bound_ms": b1_1024["bound"][0],
                 "legacy_bound_by": b1_1024["bound"][1],
                 "legacy_library_ms": b1_1024["library_ms"],
                 "legacy_b5_ms": b1_1024["b5_ms"],
                 "legacy_launches": leg["launches"]["flash_attention_fwd"]}
    # B1 on predict serving: its launches on the load (the main path) and
    # its figures at [16, 8, 256, 64] (PERF.md row 1S)
    enc, dec_c = prd["b1"]["encoder"], prd["b1"]["decoder_causal"]
    predict_b1 = {"predict_shape": enc["shape"],
                  "predict_ms": enc["ms"], "predict_plain_ms": enc["plain_ms"],
                  "predict_bound_ms": enc["bound"][0],
                  "predict_bound_by": enc["bound"][1],
                  "predict_library_ms": enc["library_ms"],
                  "predict_causal_ms": dec_c["ms"],
                  "predict_causal_plain_ms": dec_c["plain_ms"],
                  "predict_causal_bound_ms": dec_c["bound"][0],
                  "predict_causal_library_ms": dec_c["library_ms"],
                  "predict_launches": prd["launches"]["flash_attention_fwd"]}
    f32_pairs = [c for c in pair_cases if c["dtype"] == "float32"]
    sweep_errs = lambda key: [r["errs"][key] for r in sweep]  # noqa: E731
    kernels = []
    for name, launches, row, replaces, src, errs in (
            ("flash_attention_fwd", trn["launches"], full["fwd"],
             "paddle_tpu/parallel/flash_attention.py:73",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["fwd_err"] for c in flash_cases if c["dtype"] == "float32"]
             + sweep_errs("fwd") + [r["max_abs_err"] for r in leg["b1"]]
             + [r["max_abs_err"] for r in prd["b1"].values()]),
            ("flash_attention_bwd", b2_path["launches"], full["bwd"],
             "paddle_tpu/parallel/flash_attention.py:513",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["bwd_err"] for c in flash_cases if c["dtype"] == "float32"]
             + sweep_errs("b2")),
            ("flash_attention_bwd_dkv", b3_path["launches"],
             pair_rows["flash_attention_bwd_dkv"],
             "paddle_tpu/parallel/flash_attention.py:288",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["dkv_err"] for c in f32_pairs] + sweep_errs("dkv")),
            ("flash_attention_bwd_dq", b3_path["launches"],
             pair_rows["flash_attention_bwd_dq"],
             "paddle_tpu/parallel/flash_attention.py:328",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["dq_err"] for c in f32_pairs] + sweep_errs("dq")),
            ("paged_decode_attention", srv["launches"], d32,
             "paddle_tpu/parallel/flash_attention.py:848",
             "paddle_tpu_torch/csrc/paged_attention.cu",
             [r["max_abs_err"] for r in dec_checks + dec]),
            ("paged_prefill_attention", srv["launches"], p32,
             "paddle_tpu/parallel/flash_attention.py:991",
             "paddle_tpu_torch/csrc/paged_attention.cu",
             [r["max_abs_err"] for r in pre])):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["library_ms"]})
        if name in pair_rows:
            kernels[-1].update(pair_vs_library)
        if name in ("flash_attention_fwd", "flash_attention_bwd"):
            # bf16 at [64, 8, 256, 64], not causal, and the bf16 leg's
            # launches (its main path)
            r = full_bf16["fwd" if name == "flash_attention_fwd" else "bwd"]
            kernels[-1].update({
                "bf16_shape": [FB, FH, FT, FD], "bf16_ms": r["ms"],
                "bf16_plain_ms": r["plain_ms"], "bf16_bound_ms": r["bound"][0],
                "bf16_bound_by": r["bound"][1],
                "bf16_library_ms": r["library_ms"],
                "bf16_launches": tbf["launches"][name]})
            # bench.py's 16 x 1024 and 8 x 2048 bf16 legs: the figures at
            # their attention shape and their launches (their main paths)
            for leg in lbf:
                r = leg["flash"]["fwd" if name == "flash_attention_fwd"
                                 else "bwd"]
                n = leg["leg"]["launches_by_dtype"][name]["bfloat16"]
                tag = "bf16_%d_" % leg["seq"]
                kernels[-1].update({
                    tag + "shape": leg["flash"]["shape"], tag + "ms": r["ms"],
                    tag + "plain_ms": r["plain_ms"],
                    tag + "bound_ms": r["bound"][0],
                    tag + "bound_by": r["bound"][1],
                    tag + "library_ms": r["library_ms"],
                    tag + "max_abs_err": r["max_abs_err"],
                    tag + "launches": n,
                    tag + "launches_per_step": n / leg["steps"]})
        if name in ("flash_attention_fwd", "flash_attention_bwd"):
            # the Trainer's path: its launches a step (the first run and
            # the resumed run, replays included) and on Trainer.test
            i = 0 if name == "flash_attention_fwd" else 1
            kernels[-1].update({
                "trainer_launches_by_step": [
                    n[i] for n in trainer["launches_by_step"]],
                "trainer_resumed_launches_by_step": [
                    n[i] for n in trainer["resume"]["launches_by_step"]],
                "trainer_test_launches": trainer["test"]["launches"][name]})
        if name in ("flash_attention_fwd", "flash_attention_bwd"):
            # the fast path's graphed steps: launches a step, replays
            # included, and a replay's recorded launches
            kernels[-1].update({
                "graphed_launches_by_step": [
                    n[0 if name == "flash_attention_fwd" else 1]
                    for n in fast["launches_by_step"]],
                "graphed_launches_per_replay":
                fast["graph_launches_per_replay"].get(name + "/float32", 0)})
        if name == "flash_attention_fwd":
            kernels[-1].update(fwd_long)
            kernels[-1].update(legacy_b1)
            kernels[-1].update(predict_b1)
        if name == "flash_attention_bwd":
            kernels[-1].update(bwd_long)
        if name == "paged_decode_attention":
            kernels[-1].update({"kernels": list(B4_KERNELS),
                                "split_ms": d32["split_ms"],
                                "merge_ms": d32["merge_ms"],
                                "merge_share": d32["merge_share"]})
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel was not launched on its main path", kernels)
    log("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

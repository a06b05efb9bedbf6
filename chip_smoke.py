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
   device's idle share and B4's share of the window's wall time.  The
   engine's export plane (``serve_metrics`` on 127.0.0.1) is scraped
   every SCRAPE_EVERY_S while the requests are served, each exposition
   parsed strictly; after them the decode histograms' bucket ladders
   are monotone and end at le="+Inf" equal to their ``_count``,
   ``/healthz`` answers 200, and after ``stop()`` the endpoint is down
   and a fresh one answers 503; the tokens are bitwise those of the
   same requests served first on an engine without an endpoint, whose
   tokens/s is recorded beside.  Every decode step and prefill chunk is
   a replay of a CUDA graph the engine's step cache captured at its
   warm-up: no step is built or captured under the load
   (``executor.compile_count``), each entry's capture seconds and pool
   bytes are recorded, and the decode step, the widest chunk and the
   256-wide chunk are each held against their own function called op
   by op on the same inputs and a clone of the pools (logits, sampled
   ids and both pools bitwise; B4 = 12 launches a decode replay, B5 =
   12 a chunk replay).  B5 also runs captured once with its start in a
   device tensor and replayed at other starts (bitwise a direct call at
   each).  Then the rest of the decode runtime (runtime_phase): a
   shared-prefix load (16 prompts of a 1024-token prefix and a 32-256
   token tail) on engines without and with the prefix cache (warm
   tokens bitwise cold, at least half the prefill tokens saved, no page
   referenced or shared after the drain, TTFT each way); ``kv_guard``
   with ``faults.corrupt_kv_page`` (exactly one KVCorruption, the other
   sequences bitwise a clean run, the pools finite after the scrub, the
   guard's captured sweeps held against their functions); a worker
   killed mid-decode whose sequences ``evict_if_dead`` harvests and a
   second scheduler ``resubmit``s from their journals (greedy and
   seeded, bitwise the fault-free tokens).  Then the replica pool
   (pool_phase): four decode replicas of the same model on this card,
   each on its own CUDA stream, serving the 16 prompts three times over
   at rotations 1, 2 and 4 (set_active_replicas), one timed run each:
   every request's tokens bitwise the serving engine's, at least two
   replicas serving at N >= 2, B4 and B5 12 launches a replay, no
   capture under load, tokens/s at each N, the captures, pool bytes and
   memory reserved after warm-up, and a profiled window at N = 1 and
   N = 2 (idle share of the union of kernel intervals, and the time
   kernels of two streams overlapped); replica 1's decode worker killed
   mid-decode at N = 4 (every sequence bitwise its fault-free tokens, a
   replay counted, the replica revived and serving alone again); a pool
   with replay_budget=0 (the killed replica's sequences fail typed, the
   others bitwise); two predict replicas over Transformer-base scoring
   on each backend (every answer bitwise a single engine's, B1 18 a
   dispatch) and a rolling swap v1 -> v2 under four clients (ready
   replicas never 0, answers bitwise a v2 engine's after, memory
   reserved within 5% of the figure before).  Then conversational
   sessions and prefill/decode roles (sessions_phase): first the
   page-bits probe (one 64-token turn of a 300-token prompt; its
   history's full pages, read at the last dispatch, against those a cold
   generate of the same history writes on a fresh scheduler, page by
   page and layer by layer: the largest difference and the elements that
   differ, prefill-written and decode-written pages apart; ROADMAP
   F-13); then 6 conversations of 4 turns each (a shared 128-token
   system prefix and a 128-384-token message, then the history and a
   32-96-token message a turn, 64 greedy tokens a turn, the
   conversations at once and each one's turns in order) on three pools
   of 3 replicas on this card: a control (no sessions, no affinity, no
   prefix cache: every history prefilled cold), a sessions pool and a
   roles pool (prefill, decode, decode; every generation's KV handed
   off through pinned host memory).  Each pool's tokens bitwise the
   control's, turn by turn; the sessions pool prefills fewer tokens
   than the control from turn 2 on; the roles pool's packets and
   injections both 32, no handoff failed, its prefill replica retiring
   nothing; on the sessions pool, conversation 0 again under its own
   key with its owner killed mid turn 2 (faults.kill_session_owner;
   the three turns bitwise the control's, turn 3 sticky to the
   re-parked session with page hits); after end_session on every key
   and stop(), every replica's allocator empty with a clean refcount
   sweep; B4 and B5 12 launches a replay and a chunk, no capture under
   load.  Logged: prefill tokens, TTFT p50 and the session store's
   pinned pages by turn, tokens/s of each pool, the handoff's packets,
   MB and stage ms (gather and scatter apart), the tokens the F-13
   repair prefills again, the phase's seconds.  Then the model router
   (router_phase): two decode deployments of the serving LM on a router
   with no budget, lm-a (SEED) and lm-b (SEED + 1), 2 replicas each, the
   serving prompts to each, interleaved (lm-a's tokens bitwise the
   serving engine's, lm-b's a dedicated 2-replica pool's; B4 and B5 12
   launches a replay; then lm-a alone through the router against a
   dedicated pool, alternated, tokens/s); the predict phase's two saved
   scoring versions as "scorer" v1 and v2, one replica each, split
   0.75/0.25 over 40 requests (counts 30/10 within one and equal to
   ``serving.router.requests{model,version}``, each answer bitwise its
   version's dedicated pool's, B1 18 launches a dispatch), then 10 after
   ``rollback`` all on v1; tenant "tight" on lm-a (rows_per_s 1, burst
   4, max_inflight 2): four generations admitted, the fifth refused with
   ServingQuotaExceeded before the decode queue moves, the labeled
   counter +1, a tenant with no quota passing 8; then a router with
   replica_budget=2, lm-a warm under 3 open-loop submitters (32 new
   tokens) and lm-b cold, three LRU cycles (8 lm-b requests park,
   activate evicting lm-a, answer; lm-a's parked traffic activates it
   again, evicting lm-b): every future resolved and bitwise, every
   activation's captures and no other compile, no two live holders
   sharing a stream (sampled every 20 ms), memory allocated after each
   cycle within 16 MiB of before it and reserved flat within 5%, the
   router's /metrics parsed strictly with its labeled families and
   /healthz 200 then 503 after stop; logged: each activation's pool
   build, captures and reclaim seconds, the parked requests' TTFT, the
   memory at each point, the phase's seconds;
8. legacy serving: the same LM and prompts through an engine whose model
   has no chunk function (``build_decode_model(..., chunked=False)``), so
   each prompt is prefilled whole by ``lm_prefill`` on the flash forward
   (B1; a captured graph a bucket), 32 new tokens each: B1 launched 12 times a prompt, B4 12 times
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
   directory (once a run, before the pool phase, which serves it first)
   and served by InferenceEngine(model_dir=...) on the card:
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
   (32 requests of 1-4 rows with their own lengths from 8 clients,
   buckets 2-16, a 2 ms window): requests/s, rows/s, latency p50/p95,
   the bucket histogram, peak memory, the same load on engines with
   and without the blocks, one run each (requests/s), a profiled window
   (device busy
   and idle share, B1's share, GEMMs, the device-to-host copy of the
   logits), the export plane scraped during the load as in phase 7
   (the serving histograms' ladders, ``/healthz`` 200 then 503, the
   load's logits bitwise those of the same load on an engine without
   an endpoint), batch-1 clients with batching on and off, the logits' copy
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
   JAX package's values exactly (ROADMAP F-8, F-9); after ResNet-50
   (ops_phase), every case of tests/test_torch_{math,tensor,nn}_ops.py
   in float64 on the card against the port's CPU, outputs and gradients
   within OPS_RTOL (infinities in the same places), the tie cases'
   gradients exactly their shares (halves; 0 for a zero logit in
   ``sigmoid_cross_entropy_with_logits``; ``roi_pool``'s tied maxima),
   ``scatter``, ``auc`` and ``mean_iou`` with repeated, negative and
   out-of-range ids the same bits SCATTER_RUNS times and the CPU's,
   ``argsort`` stable, out-of-range ids the JAX package's answer with no
   device assert, the four random ops in a captured step (the
   replay bitwise the eager step, every draw within its distribution's
   limits), and a step holding ``auc`` captured, its replays bitwise
   its eager steps;
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
   loaded and run, images/s of each; B1-B5 launched not at all; then
   the zoo (zoo_phase: VGG-16 with batch norm on CIFAR-10, SE-ResNeXt-50
   at 224 x 224, the word2vec softmax head, DeepFM, ZOO): one step at
   full width against the port's CPU path by the same method (VGG-16 at
   batch 4, word2vec's and DeepFM's float32 steps to their ``f32_rtol``), a
   TF32 step that must fail; ZOO_STEPS steps on the fast path at
   fluid_benchmark.py's batches (losses finite and falling; DeepFM's
   AUC): step ms, images/s, words/s or samples/s, a replay's device
   time and idle share, peak memory, an eager step's device time by op
   family; a pass of each test Program; B1-B5 launched not at all; then
   the sequence slice (sequence_phase): each of the 21 sequence op
   rules, StaticRNN, DynamicRNN and the rank table in float64 on the
   card against the port's CPU (outputs, lengths and gradients within
   OPS_RTOL, ``MAX`` pooling's tied shares exact, ``is_reverse`` bitwise
   the reversed forward pass); the stacked LSTM, the recommender and
   machine translation (SEQ_MODELS) at full width, each float32 step
   against the CPU's float64 step within its ``f32_rtol`` and a TF32
   step that must fail, then SEQ_STEPS steps (losses finite and
   falling): step ms, samples and tokens/s, launches a step, idle share,
   peak memory; machine translation's training step bound (one capture)
   and bitwise its op-by-op steps, its beam search in float64 equal on
   the card and the CPU, then timed in float32 (op by op: ``while``);
   the stacked LSTM fed a dense batch of the same padded shape (bound)
   against its ragged feed (op by op); B1-B5 launched not at all; then
   the structured-prediction slice (struct_phase): the 38 cases of
   tests/test_torch_struct_ops.py (CTC, ``ctc_align``, the edit
   distance, the CRF and Viterbi, ``chunk_eval``, NCE, hsigmoid) in
   float64 on the card against the port's CPU (OPS_RTOL; ids, paths with
   their ties, chunk counts and lengths exactly); the CRNN-CTC OCR model
   at get_model's defaults (1 x 48 x 384, 24 frames, 95 classes, labels
   of 1-12 ids) and the semantic-role labeler at the book's widths
   (hidden 512, depth 8, 8-64 tokens) (STRUCT_MODELS): a float64 step
   card vs CPU at the training limits, the float32 step against the
   CPU's float64 (struct_f32_ok) and a TF32 step that must fail it, 10
   steps (finite, falling): step ms, images or tokens a second, launches
   a step, idle share, peak memory; OCR's test Program through the
   greedy decoder and ``edit_distance``; SRL's Viterbi decode (tokens a
   second) and a ``chunk_eval`` of it equal on the card and the CPU;
   word2vec's NCE and hsigmoid heads at the zoo's widths, each step bound
   (one capture) and bitwise its op-by-op steps (the NCE draws too, in
   range and new each step), then ZOO_STEPS steps beside the softmax
   head's words/s and idle share; B1-B5 launched not at all; then the
   detection slice (detection_phase): the cases of
   tests/test_torch_detection_ops.py (the 14 detection rules) in float64
   on the card against the port's CPU (OPS_RTOL; match indices, NMS's
   rows and counts, the sampled indices and labels, ``detection_map``'s
   state, the prior tables and ``target_assign``'s weights exactly), one
   ``generate_proposals`` at the op's defaults (6000 / 1000 over 28,500
   anchors, DET_RPN) timed; MobileNet-SSD at get_model's defaults (300 x
   300, 21 classes, 2278 priors, RMSProp 1e-3; DET_MODELS): a float64
   step card vs CPU at the training limits, the float32 step against the
   CPU's float64 (struct_f32_ok) and a TF32 step that must fail it, 10
   steps at batch 32 with 1-20 boxes an image fed ragged (finite,
   falling): step ms, images/s, launches a step, idle share, peak
   memory; a pass of the test Program (``detection_output``) with the
   NMS loop's share; the same step fed dense (20 boxes an image) bound
   into one CUDA graph and bitwise its op-by-op steps; B1-B5 launched
   not at all; then the one-card parallel slice (parallel_phase):
   Transformer-base with both stacks a ``layers.Pipeline`` (2 stages, 4
   microbatches, 64 x 256, no flash: the pipeline forbids it; PIPE_CFG):
   its float32 step against the float64 step at batch 8 (loss
   LOSS_RTOL, gradients PIPE_GRAD_L2), PIPE_STEPS steps bound as one CUDA
   graph and bitwise its op-by-op steps, the loss falling, ms a step,
   idle share, peak memory; the circular layout (6 stages, rows for 2
   devices) the same way for PIPE_CIRCULAR_STEPS; the model unpipelined,
   timed beside it; ``switch_moe`` at Transformer-base's FFN widths (8
   experts, 64 x 256 tokens; MOE_CFG): float32 against float64, every
   chosen expert with a gradient and no other, 4 steps bound and
   bitwise; ParallelExecutor at TRAIN_CFG: 4 steps bitwise Executor.run's
   with B1 and B2 18 times a step, Trainer(parallel=True) bitwise
   Trainer(), build_mesh({"dp": 2}) raising; program_to_microbatched_fn
   (4 microbatches) against the full-batch step (MB_*); the contrib
   decoder at machine translation's widths (DEC_*): TrainingDecoder 4
   steps on a ragged batch of 32, BeamSearchDecoder on 16 sources, beam 4,
   32 steps, bitwise over two runs, scores against a float64 decode on
   the beams whose ids agree, sentences a second; B1-B5 launched by the
   ParallelExecutor and microbatch legs only; then the multi-rank
   engines on ranks that share the card (mesh_phase, MESH_*): Transformer-
   base at 64 x 256 (dropout 0, flash, no PAD tokens) through
   ParallelExecutor(mesh_shape=(2, 2), devices=["cuda:0"] * 4) for
   MESH_STEPS steps from the one-device leg's state, each loss within
   MESH_LOSS_RTOL and each parameter within MESH_PARAM_RTOL of its max of
   Executor.run's steps, two runs bitwise, B1 and B2 36 times a step, one
   CUDA graph; ZeRO stages 0, 1 and 3 at {"dp": 4}, stage 0 held to
   Executor.run's steps and stages 1 and 3 to stage 0 the same way, with
   each rank's state bytes; one flash_attention op at
   SP_SHAPE, causal and not, over {"dp": 1, "sp": 4} with sp_engine
   ulysses and ring: output and gradients within SP_RTOL of one-device
   B1/B2 over the whole sequence, the engine counters showing the engine
   and no fallback, ms beside the one-device step; PIPE_CFG's pipelined
   Transformer-base over {"pp": 2} (GPipe, stages on their own streams)
   and PIPE_CIRCULAR_CFG's over {"pp": 2}, each against the one-device
   pipeline op's steps (MESH_PIPE_RTOL), ms a step beside it; switch_moe
   at MOE_CFG's widths over {"ep": 8} at a capacity that drops nothing
   against the dense rule's steps (MESH_MOE_RTOL), ms a step of each
   over MESH_MOE_TIME_STEPS replays, and the tokens the engine drops at
   capacity factor MOE_DROP_CAP; then the parameter servers
   (pserver_phase, PS_*; trainers and pservers in threads, every
   Executor on the card, TCP on localhost): P1 fit-a-line's sync round of
   2 trainers against one Executor.run step on the concatenated batch
   (PS_RTOL, PS_ATOL), the trainers bitwise; P2 Transformer-base at
   TRAIN_CFG's widths, dropout 0, 1 trainer x 2 pservers with
   slice_var_up, bitwise Executor.run over PS_TF_ROUNDS rounds, B1 and
   B2 18 a round, one capture on the trainer and on each pserver, the
   round's ms by part; P3 DeepFM, 2 x 2,
   the trainers bitwise every round, round 1 within PS_DEEPFM_RTOL of
   Executor.run on the concatenated batch; P4 P1's cluster restarted
   from its checkpoint, bitwise an uninterrupted run
   (``--only pserver`` runs the build and this phase alone);
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
   then recompute (recompute_phase): the same model at 4 x 4096,
   dropout 0.1, RECOMPUTE_STEPS steps through Executor.run without
   recompute and as many with ``enable_recompute(RECOMPUTE_SEGMENTS)``,
   from one start state on the same batches: losses and every
   persistable bitwise equal, one capture each, B2 18 launches a step
   and B1 18 without recompute, 18 plus the attention calls of the
   checkpointed segments with it (replays included); step ms,
   tokens/s, peak memory and the graph's pool each way;
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
   then int8 quantization (quant_phase, alone with ``--only quant``):
   quantized_mul, quantized_conv2d and the fake quant on the card
   against the CPU, bitwise; ResNet-50 at batch 128 through
   QuantizeTranspiler.training_transpile, op by op and bound (one
   capture, bitwise), with metrics.Accuracy and average.WeightedAverage
   over the fetches, freeze_program in place, convert_to_int8; then
   int8 inference at batch 256 (fold, Int8InferenceTranspiler): the
   logits within QUANT_INT8_L2 of the folded float32 Program's,
   profiled replays of int8 GEMMs only, the card against the CPU on 4
   images, a quarter of the weight bytes, saved and loaded bitwise, a
   small int8 net exported AOT and loaded bitwise; torch._int_mm's
   shape limits; the three evaluators on the card against the CPU,
   ``reset`` capturing nothing new; B1-B5 0 launches;
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
22. bench.py's two other long legs on bf16 (16 x 1024 for 10 steps,
   8 x 2048 for 8, bench.py's 15 and 12 cut; bench.py's feeds,
   max_length = seq): the checks of
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
   Trainer's path and on ``Trainer.test``, on the recompute leg, on the
   ParallelExecutor leg, and a step on the mesh phase's dp x tp, ZeRO
   and Ulysses legs),
   the card line, and the final
   ``{"ok": true, "device": {...}}`` line.

It needs the repository beside it and a CUDA device; without either it
exits non-zero before printing any result.
"""
import contextlib
import gc
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
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
# the rest of the decode runtime: a shared-prefix load (16 prompts of a
# 1024-token prefix and a 32-256-token tail), the KV guard with one
# corrupted sequence, and journal replay after a worker killed
# mid-decode (at its dispatch 20, counted from 0: the 8 prompts' chunks
# and the decode steps between them are dispatches 0-15)
PREFIX_REQUESTS, PREFIX_TOKENS, PREFIX_TAILS = 16, 1024, (32, 256)
# the replica pool on one card: four decode replicas at rotations 1, 2
# and 4, a timed run of the serving prompts three times over at each;
# replica 1 killed mid-decode; two predict replicas at two buckets, and a
# swap whose memory reserved after may differ by this share of before
POOL_REPLICAS, POOL_ROTATIONS, POOL_RUNS, POOL_COPIES = 4, (1, 2, 4), 1, 3
POOL_KILLED, POOL_PROBE_TOKENS = 1, 8
POOL_PREDICT_REPLICAS, POOL_PREDICT_BUCKETS = 2, (2, 4)
POOL_PREDICT_REQUESTS, POOL_SWAP_RESERVED_TOL = 16, 0.05
PREFIX_NEW_TOKENS = 16
# conversational sessions: the page-bits probe (one turn of a
# SESSION_PROBE_PROMPT-token prompt, SESSION_NEW_TOKENS generated, its
# history's pages against a cold prefill's), then 6 conversations of 4
# turns each on three pools of 3 replicas: turn 1 a 128-token system
# prefix and a 128-384-token message, each later turn the history and a
# 32-96-token message, 64 greedy tokens a turn; conversation
# SESSION_KILLED's owner killed mid turn 2 on a fourth conversation set
SESSION_PROBE_PROMPT, SESSION_NEW_TOKENS = 300, 64
SESSION_CONVERSATIONS, SESSION_TURNS, SESSION_REPLICAS = 6, 4, 3
SESSION_SYSTEM, SESSION_FIRST, SESSION_LATER = 128, (128, 384), (32, 96)
SESSION_ROLES = ("prefill", "decode", "decode")
# the model router: two decode deployments of the serving LM (lm-a from
# SEED, lm-b from SEED + 1), ROUTER_REPLICAS replicas each, and the
# predict phase's two scoring versions as "scorer" v1 and v2, one replica
# each; the canary's split over ROUTER_CANARY requests, then
# ROUTER_ROLLBACK after the rollback; tenant "tight"'s quota, and the new
# tokens of the quota leg's generations; ROUTER_CYCLES LRU cycles under
# ROUTER_SUBMITTERS open-loop submitters on lm-a (ROUTER_HOT_TOKENS new
# tokens, a request a thread every ROUTER_HOT_GAP_S), ROUTER_COLD_REQUESTS
# parked on lm-b in each; memory allocated after a deactivation within
# ROUTER_ALLOCATED_TOL_MIB of before its activation, and reserved after
# the last cycle at most ROUTER_RESERVED_GROWTH times the first's
ROUTER_REPLICAS, ROUTER_CANARY, ROUTER_ROLLBACK = 2, 40, 10
ROUTER_SPLIT = (0.75, 0.25)
ROUTER_TIGHT = dict(rows_per_s=1, burst_rows=4, max_inflight=2)
ROUTER_QUOTA_TOKENS = 8
ROUTER_CYCLES, ROUTER_SUBMITTERS, ROUTER_COLD_REQUESTS = 2, 3, 8
ROUTER_HOT_TOKENS, ROUTER_HOT_GAP_S = 32, 0.1
ROUTER_ALLOCATED_TOL_MIB, ROUTER_RESERVED_GROWTH = 16, 1.05
GUARD_REQUESTS, GUARD_NEW_TOKENS = 4, 16
JOURNAL_REQUESTS, JOURNAL_NEW_TOKENS, JOURNAL_KILL_AT = 8, 32, 20
# predict serving: Transformer-base scoring at TRAIN_CFG's width, the
# engine's default bucket ladder, and the load's requests (1-4 rows each)
PREDICT_BUCKETS = (2, 4, 8, 16)
PREDICT_REQUESTS = 32
# the export plane: seconds between two scrapes of /metrics while an
# engine serves its load (30 times a 15 s Prometheus scrape; two or more
# scrapes a load)
SCRAPE_EVERY_S = 0.5
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
# lr 0.1, 20 of bench.py's 30 iterations (bench.py:153; cut for the
# script's time when the quantization phase came); f32 with TF32 off;
# seeded normal images, as bench.py's.  On one batch at lr 0.1 the loss
# falls for two steps, then climbs for several before it falls again
# (the JAX package's get_model does the same on the CPU; on the card the
# 20th f32 loss lay 0.59 under the first), so the fall is checked at
# the end
RESNET_CFG = dict(class_dim=1000, depth=50, image_shape=(3, 224, 224))
RESNET_BATCH, RESNET_STEPS, RESNET_CHECK_BATCH = 128, 20, 2
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
RESNET_INFER_RUNS = 3
# bf16 (bench.py's legs: ResNet-50 trained with get_model(dtype=
# "bfloat16") at RESNET_STEPS steps of batch 128, then inference at
# batch 256 with bf16 state and images, bench.py:277-328).  Card against CPU at batch 2:
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
# the op rules of paddle_tpu_torch/ops/{math,tensor,nn}_ops.py (ops_phase):
# each case of tests/test_torch_{math,tensor,nn}_ops.py in float64, card
# against the port's CPU, forward and gradient, of each output's largest
# finite magnitude (float64 rounding in another order only)
OPS_RTOL = 1e-9
SCATTER_RUNS = 5
# the bound step holding ``auc`` (auc_bound_check): its steps and batch
AUC_STEPS, AUC_BATCH = 4, 256
# the zoo (benchmarks/fluid_benchmark.py:60-62, 150-152, 167-169 and the
# models' get_model defaults): VGG-16 with batch norm on CIFAR-10 (Adam
# 1e-3), SE-ResNeXt-50 on ImageNet shapes (cardinality 32, reduction 16,
# momentum 0.1 / 0.9), the word2vec n-gram LM with the softmax head
# (vocab 2073, embedding 32, hidden 256, Adam 1e-3), DeepFM (26 fields of
# 1000 ids, embedding 8, hidden (64, 32), Adam 1e-3, its AUC over 4096
# bins); its batch, the feed's unit, the card-vs-CPU check's batch
# (ZOO_CHECK_BATCH unless given) and, where set, the limit of its float32
# step in the loss and every gradient (f32_rtol, else resnet_f32_ok).  VGG-16's check runs at batch 4: at batch 2 the batch_norm
# after its first fc normalizes 2 values, so the gradient it passes back
# is eps / (var + eps) of the incoming one, formed by cancelling two
# terms of the incoming size; a float32 rounding there becomes a
# whole-percent error in every gradient below it (on an H100 the card's
# float32 step was 0.171 from the CPU's float64 in L2 at batch 2; the
# CPU's float32 step is 3.0e-5 from it at batch 4)
ZOO = {
    "vgg16": dict(module="vgg", kw=dict(class_dim=10, image_shape=(3, 32, 32)),
                  batch=64, unit="images", check_batch=4),
    "se_resnext50": dict(module="se_resnext",
                         kw=dict(class_dim=1000, depth=50,
                                 image_shape=(3, 224, 224), lr=0.1),
                         batch=64, unit="images"),
    "word2vec": dict(module="word2vec", kw=dict(vocab_size=2073, emb_size=32,
                                                hidden_size=256),
                     batch=512, unit="words", f32_rtol=1e-5),
    "deepfm": dict(module="deepfm", kw=dict(), batch=512, unit="samples",
                   check_batch=64, f32_rtol=1e-5),
}
ZOO_STEPS, ZOO_CHECK_BATCH = 10, 2
# word2vec has no gate and no batch statistics, and DeepFM's only gates
# are its MLP's 96 ReLUs (6,144 pre-activations at its check batch of 64:
# one within float32 rounding of 0 is a chance of about 1e-3, and the
# seeded step is checked on the CPU in float32 too): each float32 step is
# a smooth function, so its float32 card step is held to ``f32_rtol`` of
# the CPU's float64 step in the loss and in every gradient (float32
# rounding, about 1e-6, with room; TF32's 10-bit products are about 1e-3)
# a bias added just before a batch_norm has a true gradient of 0: its
# step's gradient, of its layer weight gradient's largest, in any dtype.
# A true gradient would be of the weight gradient's order; the float32
# rounding of a sum over batch x 32 x 32 terms that cancels measured
# 1.46e-5 of it on an H100 (VGG-16, batch 2)
ZERO_GRAD_NOISE = 1e-3
ZOO_FAMILIES = {"conv2d": "conv", "batch_norm": "batch_norm", "mul": "gemm",
                "pool2d": "pool", "relu": "activation",
                "sigmoid": "activation", "dropout": "dropout",
                "elementwise_add": "elementwise",
                "elementwise_mul": "elementwise", "adam": "optimizer",
                "momentum": "optimizer", "lookup_table": "embedding",
                "concat": "concat", "softmax": "softmax",
                "cross_entropy": "loss", "mean": "loss",
                "sigmoid_cross_entropy_with_logits": "loss", "auc": "metric",
                "reduce_sum": "reduce", "elementwise_sub": "elementwise",
                "scale": "elementwise"}
# the sequence slice (sequence_phase): the stacked LSTM
# (benchmark/fluid/models/stacked_dynamic_lstm.py's widths: embedding and
# LSTM 512, IMDB's 5147 words, depth 1, batch 64, Adam 1e-3; lengths
# 32-256 padded to 256), the recommender (test_recommender_system.py's
# towers on MovieLens-1M's 6,040 users, 3,952 movies, 21 jobs and 18
# genres, a 5,000-word title dictionary, batch 256, SGD 5e-3; 1-6 genres
# and 1-15 title words a movie) and machine translation
# (machine_translation.py's defaults: dictionary 30000, embedding,
# encoder and decoder 512, 32 tokens, batch 16, Adam 2e-4); the batch of
# the card-vs-CPU check and the limit of its float32 step against the
# CPU's float64 step in the loss and every gradient (``f32_rtol``).  No
# model here has a ReLU gate or a batch statistic, so each step is a
# smooth function and float32 rounding (about 6e-8 an operation) is all
# that parts the two.  The recommender has no recurrence: DeepFM's 1e-5.
# The LSTM's gradient runs back through 256 steps of its recurrence and
# machine translation's through 32 decoder steps, each a 512-wide GEMM
# and a gate, with a 30000-way softmax over the decoder's outputs:
# rounding accumulated over the recurrence, about 256 x 2 x 6e-8 = 3e-5
# in the LSTM's worst case, under 1e-4; TF32's 10-bit products (about
# 1e-3) must fail each limit
SEQ_MODELS = {
    "stacked_dynamic_lstm": dict(
        module="stacked_dynamic_lstm",
        kw=dict(lstm_size=512, emb_dim=512, vocab_size=5147, depth=1),
        batch=64, check_batch=8, f32_rtol=1e-4),
    "recommender": dict(
        module="recommender",
        kw=dict(max_user_id=6040, max_movie_id=3952, max_job_id=20,
                n_categories=18, title_dict_size=5000),
        batch=256, check_batch=256, f32_rtol=1e-5),
    "machine_translation": dict(
        module="machine_translation",
        kw=dict(batch_size=16, seq_len=32, embedding_dim=512,
                encoder_size=512, decoder_size=512, dict_size=30000),
        batch=16, check_batch=4, f32_rtol=1e-4),
}
# machine translation's attention scores e_s = v . tanh(p_s + W h) meet a
# softmax over the source positions s, whose gradient sums to 0 over s:
# the gradient of W, sum_s dL/de_s v (1 - mix_s^2) h, loses its first
# term and is what a cancellation leaves (on an H100 its float64 card
# step was 2.7e-11 of its max from the CPU's, every other gradient's
# under 4e-15; in float32 0.0091 on the card, 0.0128 on the CPU).  Such a
# gradient (shift_invariant_weights) is held to SEQ_CANCEL_FACTOR times
# the CPU's own float32 error of it (or f32_rtol, the larger)
SEQ_CANCEL_FACTOR = 2.0
SEQ_STEPS = 10
SEQ_LSTM_T, SEQ_LSTM_LENS = 256, (32, 256)
SEQ_GENRES, SEQ_TITLE = 6, 15
SEQ_BOUND_STEPS = 4
# machine translation's beam search (test_machine_translation.py's decode):
# beam 3, 50 steps; the float64 card-vs-CPU check's sources; timed runs
SEQ_BEAM, SEQ_MAX_LEN = 3, 50
SEQ_GEN_CHECK_SOURCES = 4
SEQ_GEN_RUNS = 3
# the structured-prediction slice (struct_phase): the CRNN-CTC OCR model
# at get_model's defaults (the OCR benchmark's [1, 48, 384] images, GRU
# 200, 95 classes and the blank, Adam 1e-3; 24 frames after the four
# poolings), labels of 1-12 ids fed as [L] rows, batch 16, checked
# against the CPU at batch 4 as ResNet-50 is (its ReLUs, batch norms and
# ReLU-candidate GRUs make the float32 gradient jump where a gate flips;
# at batch 2 a batch norm over few values is ill-conditioned, ROADMAP's
# conditioning note).  A gate flips where its input is within rounding
# of 0, so the forward values move by rounding only: the loss, the last
# fc's gradient (forward values times the logits' gradient, no gate
# between) and the running statistics hold float32 limits (``f32``; on
# an 8-core Xeon the CPU's float32 step was 4.0e-8, 5.4e-7 and 2.2e-7
# from its float64 step at batch 4), and all gradients together the L2
# limit of ResNet-50's (RESNET_GLOBAL_L2).  TF32 rounds each product's
# inputs to 10 bits (2**-11, about 5e-4): the last fc's gradient, a TF32
# GEMM itself, must fail 1e-4.  The semantic-role labeler at the
# reference book's db_lstm widths (word 32, mark 5, hidden 512, depth 8:
# paddle_tpu/models/label_semantic_roles.py's "reference depth=8"),
# CoNLL-05's synthetic vocabularies, sentences of 8-64 tokens (all 8
# feeds ragged), batch 16, SGD 1e-3 (the book's mix_hidden_lr: at
# get_model's 1e-2 the loss of these feeds climbs from the second step
# and overflows by the sixth, in the JAX package on the CPU as in the
# port: 91.632, 99.022, 114.046, 122.961, 4711.4, 2.03e13), checked at
# batch 4.  It has no ReLU and no batch statistic, so each step is a
# smooth function and float32 rounding (about 6e-8 an operation) is all
# that parts a float32 step from a float64 one: its gradient runs back
# through 8 LSTMs of up to 64 steps, 512 sequential 512-wide GEMMs and
# gates, and through the CRF's 64-step forward algorithm, about
# 512 x 2 x 6e-8 = 6e-5 in the worst case: under 1e-4 (the stacked
# LSTM's limit, SEQ_MODELS), which TF32's 10-bit products (about 1e-3)
# must fail
STRUCT_MODELS = {
    "ocr_crnn_ctc": dict(module="ocr_crnn_ctc", kw=dict(), batch=16,
                         check_batch=4, steps=5, f32=dict(
                             loss_rel=1e-5, fc_grad_worst_of_max=1e-4,
                             stat_worst_of_max=RESNET_STAT_RTOL,
                             grad_global_l2=RESNET_GLOBAL_L2)),
    "label_semantic_roles": dict(module="label_semantic_roles",
                                 kw=dict(hidden_dim=512, depth=8, lr=1e-3),
                                 batch=16, check_batch=4, f32_rtol=1e-4,
                                 steps=5),
}
STRUCT_LABEL_LENS = (1, 12)
STRUCT_SRL_LENS = (8, 64)
SRL_CHUNK_TYPES = 5    # CoNLL-05's synthetic tags: B/I of 5 types, O last
# word2vec's NCE and hierarchical-sigmoid heads at the zoo's widths (ZOO):
# each step bound, STRUCT_W2V_BOUND_STEPS steps bitwise op by op
STRUCT_W2V_HEADS = ("nce", "hsigmoid")
STRUCT_W2V_BOUND_STEPS = 4
STRUCT_DECODE_RUNS = 3
# the detection slice (detection_phase): MobileNet-SSD at get_model's
# defaults (the object detection benchmark's PASCAL VOC shapes: 300 x 300
# images, 21 classes, 2278 priors over six maps, RMSProp 1e-3), batch 32,
# each image 1-20 seeded boxes fed ragged (DET_BOXES), 5 steps; checked
# against the CPU at batch 4 as ResNet-50 and OCR are: MobileNet's ReLUs
# and batch norms make the float32 gradient jump where a gate flips, and
# the hard-negative mining ranks some 2,000 candidates an image whose
# confidence losses sit close together at a random start, so a float32
# rounding can swap two of them at the cut
# (tests/test_torch_detection_models.py: at 96 x 96 the JAX package's
# float32 gradient lay 0.24 of its norm from the float64 step at one
# step, the port's 0.0024).  The forward values move by rounding only:
# the loss and the running statistics hold float32 limits, all gradients
# together the L2 limit of ResNet-50's; TF32 rounds every convolution's
# inputs to 10 bits (2**-11), which must fail them.  At batch 4 the three
# last extra blocks (1 x 1 maps) normalize 4 values a channel (ROADMAP's
# conditioning note: at 2 no float32 limit holds below them)
DET_MODELS = {
    "ssd": dict(module="ssd", kw=dict(), batch=32, check_batch=4, steps=5,
                f32=dict(loss_rel=1e-5, stat_worst_of_max=RESNET_STAT_RTOL,
                         grad_global_l2=RESNET_GLOBAL_L2)),
}
DET_BOXES = (1, 20)
# op types of SSD's training Program by family, for its profiled step
DET_FAMILIES = {"conv2d": "conv", "batch_norm": "batch_norm",
                "relu": "activation", "elementwise_add": "elementwise",
                "ssd_loss": "ssd_loss", "prior_box": "priors",
                "box_coder": "box_coder", "softmax": "softmax",
                "transpose": "layout", "reshape": "layout",
                "concat": "layout", "reduce_sum": "reduce",
                "rmsprop": "optimizer", "multiclass_nms": "nms"}
DET_BOUND_STEPS = 4
DET_TEST_RUNS = 3
# generate_proposals at the op's defaults (pre_nms_topN 6000,
# post_nms_topN 1000, nms_thresh 0.5, min_size 0.1): a 38 x 50 map (a
# 600 x 800 image at stride 16) with 15 anchors a cell (5 sizes x 3
# ratios), 28,500 anchors, 2 images
DET_RPN = dict(batch=2, height=38, width=50, stride=16.0,
               sizes=(32.0, 64.0, 128.0, 256.0, 512.0),
               ratios=(0.5, 1.0, 2.0), runs=1)
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
TRAINER_TIMED_STEPS = 6
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
# recompute (recompute_phase): LONG_CFG for RECOMPUTE_STEPS steps through
# the bound step without recompute, then as many with
# enable_recompute(RECOMPUTE_SEGMENTS), from one start state and the same
# batches
RECOMPUTE_SEGMENTS = 4
RECOMPUTE_STEPS = 4
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
BEAM_RUNS = 2
BEAM_CHECK_SOURCES, BEAM_CHECK_OUT_LEN = 2, 16
BEAM_SCORE_RTOL = 1e-9   # float64 card vs CPU: DGEMM summation orders only
DECODE_FAMILIES = {"mul": "gemm", "matmul": "gemm", "softmax": "softmax",
                   "layer_norm": "layer_norm", "top_k": "top_k",
                   "elementwise_mul": "elementwise",
                   "elementwise_add": "elementwise",
                   "reduce_sum": "reduce_sum"}
# bench.py's two other long Transformer legs (bench.py:458-461), on bf16:
# (batch, seq, steps); bench.py runs 15 and 12 steps, cut to 10 and 8
# for the script's time when the quantization phase came
BENCH_BF16_LEGS = ((16, 1024, 10), (8, 2048, 8))
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 (non-tensor) peak,
# and the dense bfloat16 tensor-core peak (989.4 TFLOP/s, no sparsity)
PEAK_BYTES_S = 3.35e12
# the one-card parallel slice (parallel_phase).  Pipelined Transformer-base:
# TRAIN_CFG's model without flash attention (the pipeline forbids it, as
# the JAX package does), both stacks a layers.Pipeline of 2 stages (3
# layers each) over 4 microbatches of 16, dropout 0.1; noam decay with
# warmup 8 and scale 0.1 (lr 2.0e-4 at step 1, 1.6e-3 at step 8), so that
# PIPE_STEPS steps on one batch move the loss past dropout's noise (get_
# model's warmup of 8000 gives 1.2e-7 at step 1).  Its float32 step is
# held to the float64 step of the same Program (widened) on the card at
# PIPE_CHECK_BATCH (2 rows a microbatch): the loss within LOSS_RTOL, all
# gradients together within PIPE_GRAD_L2 of their L2 norm (float32
# rounding over 12 layers; a ReLU gate whose pre-activation sits within
# rounding of 0 may open on one side only, which one element's L2 share
# absorbs)
PIPE_CFG = dict(TRAIN_CFG, use_flash=False, pipeline_stages=2,
                pipeline_microbatches=4, learning_rate=0.1, warmup_steps=8)
PIPE_STEPS = 8
PIPE_CHECK_BATCH = 8
PIPE_GRAD_L2 = 1e-3
# the circular layout: 6 virtual stages of one layer each, their rows laid
# out for 2 devices (circular_repeats 3), 4 microbatches.  circular_repeats
# 2 maps 6 stages to 3 devices, whose schedule takes microbatches in
# multiples of 3, and no multiple of 3 divides the batch of 64
PIPE_CIRCULAR_CFG = dict(PIPE_CFG, pipeline_stages=6,
                         pipeline_circular_repeats=3)
PIPE_CIRCULAR_STEPS = 4
# the same model unpipelined (pipeline_stages 0), timed beside it
PIPE_PLAIN_STEPS = 6
# switch_moe at Transformer-base's FFN widths: tokens of d 512 through 8
# relu experts of hidden 2048, top-1, capacity factor 2.0, 64 x 256 tokens,
# a mean squared error against seeded targets, Adam 1e-3, 4 steps; its
# float32 step held to the float64 step (loss LOSS_RTOL, all gradients
# PIPE_GRAD_L2 of their L2 norm; the top-1 choices counted where they
# differ)
MOE_CFG = dict(batch=64, tokens=256, d=512, hidden=2048, experts=8,
               capacity=2.0, steps=4, lr=1e-3)
# ParallelExecutor on the card: TRAIN_CFG (flash, dropout 0.1) for
# PE_STEPS steps, bitwise Executor.run's; the Trainer leg the same steps
PE_STEPS = 4
# program_to_microbatched_fn with MB_MICROBATCHES on TRAIN_CFG's model
# (dropout 0: the microbatches' dropout draws differ from the full
# batch's), every row at full length (equal tokens a microbatch, so the
# mean of the microbatch losses is the batch's loss): the loss within
# MB_LOSS_RTOL of the full-batch step's, Adam's first moments (0.1 of the
# gradients) within MB_GRAD_L2 of their L2 norm together.  A microbatch's
# GEMMs have a quarter of the rows, so cuBLAS sums them in another order,
# and a ReLU gate whose pre-activation lies within that rounding of 0
# opens on one side only: the float32 limit of this phase's float64
# checks (PIPE_GRAD_L2) holds them (2.2e-4 on an NVIDIA H100 80GB HBM3,
# the last decoder layer's first FFN weight the worst)
MB_MICROBATCHES = 4
MB_LOSS_RTOL = 1e-5
MB_GRAD_L2 = PIPE_GRAD_L2
# the contrib decoder at machine translation's widths (dictionary 30,000,
# embedding 512, hidden 512): an encoder (embedding, fc tanh, average
# pool, fc tanh) seeding an Elman StateCell (tanh(fc(x) + fc(h))),
# TrainingDecoder over the target with a softmax fc, Adam 1e-3, DEC_STEPS
# steps on a ragged batch of DEC_BATCH (DEC_LENS tokens a sentence); then
# BeamSearchDecoder on the trained weights: DEC_SOURCES sources, beam
# DEC_BEAM, max_len DEC_MAX_LEN, end id 1; the float32 decode against a
# float64 decode of the same Program: scores within DEC_SCORE_RTOL on the
# beams whose ids agree
DEC_CFG = dict(dict_size=30000, emb=512, hidden=512)
DEC_BATCH = 32
DEC_LENS = (8, 32)
DEC_STEPS = 4
DEC_SOURCES = 16
DEC_BEAM = 4
DEC_MAX_LEN = 32
DEC_END_ID = 1
DEC_SCORE_RTOL = 1e-4
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989.4e12
# the device-side wait before each timed launch: about 0.5 ms at the
# H100's 1.98 GHz boost clock, longer than any wrapper takes to enqueue
# the multi-rank engines (mesh_phase): ranks that share the card.
# Transformer-base at TRAIN_CFG with dropout 0 and every row at full
# length, MESH_STEPS steps from one numpy state on MESH_STEPS batches:
# Executor.run, then ParallelExecutor over a dp 2 x tp 2 mesh of four
# ranks on cuda:0 twice (bitwise), then ZeRO 0, 1 and 3 at dp 4.  The
# limits and measures are the JAX package's dryrun's for dp x tp
# (mesh_errors: every step's loss 2e-5 of max(1, |loss|), each parameter
# element after the first step 5e-4 of max(|value|, 1e-3)): a dp rank's
# GEMMs have half the rows and its weight gradients add in two parts, so
# cuBLAS and autograd may sum them in another order, and an Adam update
# whose gradient cancels to rounding noise follows that noise
MESH_RANKS = 4
MESH_CFG = dict(TRAIN_CFG, dropout=0.0)
MESH_STEPS = 4
MESH_LOSS_RTOL = 2e-5
MESH_PARAM_RTOL = 5e-4
# sequence parallelism: one flash_attention op (reduce_sum(o * r) and
# calc_gradient of q, k, v) at bench.py's long shape over an sp axis of
# 4; SP_CHECK_STEPS steps fetching the output and the gradients, each
# within SP_RTOL of its max |value| of the one-device kernels' (ring sums
# its blocks in float32 matmuls, in another order than B1's online
# softmax), then SP_STEPS fetching the loss alone, timed
SP_SHAPE = (4, 8, 4096, 64)
SP_CHECK_STEPS = 2
SP_STEPS = 5
SP_RTOL = 1e-4
# the pipelines over pp 2 against the one-device pipeline op: the same
# stage computations; the gradient of a stacked parameter adds its
# microbatches' parts in autograd's order, which the schedule sets
MESH_PIPE_STEPS = 4
MESH_PIPE_RTOL = 1e-5
# switch_moe over ep 8: capacity factor 8 gives each expert t_local slots
# (no token dropped), so the engine computes the dense rule's function;
# MESH_MOE_STEPS Adam steps, each loss within MESH_MOE_RTOL of the dense
# rule's and the first step's gradients (gate and both expert stacks)
# within MESH_MOE_RTOL of theirs in L2.  Not the parameters: an expert
# weight's gradient sums its tokens in slot order here and in token order
# there, and Adam's first steps (lr 1e-3) move an element whose gradient
# cancels to rounding noise by that noise's sign; then the tokens dropped
# at MOE_DROP_CAP
MOE_NODROP_CAP = 8.0
MOE_DROP_CAP = 1.0
MESH_MOE_STEPS = 3
MESH_MOE_TIME_STEPS = 12
MESH_MOE_RTOL = 1e-5
# the parameter-server phase (pserver_phase): pservers and trainers in
# threads of this process, every Executor on the card, as the JAX
# package's tests run them.  P1 the round contract (PS_RTOL, PS_ATOL: the
# JAX package's test's); P2 Transformer-base at TRAIN_CFG's widths,
# dropout 0, 1 trainer x 2 pservers, PS_TF_ROUNDS rounds; P3 DeepFM, 2 x
# 2, PS_DEEPFM_ROUNDS rounds of PS_DEEPFM_BATCH rows a trainer; P4 P1's
# cluster restarted after PS_RESTART_AT of PS_RESTART_ROUNDS rounds
PS_CFG = dict(TRAIN_CFG, dropout=0.0)
PS_TF_ROUNDS = 5
PS_DEEPFM_BATCH = 512
PS_DEEPFM_ROUNDS = 20
PS_DEEPFM_RTOL = 1e-5
PS_RESTART_AT, PS_RESTART_ROUNDS = 3, 6
PS_RTOL, PS_ATOL = 1e-5, 1e-6
PS_JOIN_S = 120.0
SLEEP_CYCLES = 1_000_000


def log(*args):
    print(*args, flush=True)


def clock(t_start, name):
    """Log the seconds since ``t_start`` at the end of a phase."""
    log("clock: %s done at %.1f s" % (name, time.perf_counter() - t_start))


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
        device_start = b5_device_start_check(torch, fa, dev, gen, k, v,
                                             pages, scale)
        log("prefill %-8s start read from device memory: one capture "
            "replayed at starts %s bitwise equal to direct calls, max err "
            "%.3g vs plain (tol %g)" % (dtype, device_start["starts"],
                                        device_start["max_abs_err"],
                                        KERNEL_TOL))
        for start, C in PREFILL_CASES + PREFILL_TIMED:
            q = torch.randn((C, H, DH), generator=gen, device=dev)
            st = torch.tensor([start], dtype=torch.int32, device=dev)
            out = fa.paged_prefill_attention(q, k, v, pages, st)
            ref = fa._paged_prefill_reference(q, k, v, pages, st, scale)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(err <= KERNEL_TOL, "prefill", dtype, start, C, err)
            half = C // 2
            split = torch.cat([
                fa.paged_prefill_attention(q[:half], k, v, pages, st),
                fa.paged_prefill_attention(q[half:], k, v, pages,
                                           st + half)])
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
                out_nan = fa.paged_prefill_attention(q, kn, vn, pages, st)
                check(torch.equal(out_nan, out), "prefill: stale NaN/Inf "
                      "past start + C changed an output", dtype, start, C)
                del kn, vn
            row = {"dtype": dtype, "start": start, "C": C,
                   "max_abs_err": err, "split_bitwise": True,
                   "stale_nan_inert": nan_checked}
            if not rows or rows[-1]["dtype"] != dtype:
                row["device_start"] = device_start
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
                        q, k, v, pages, st), 20, flush),
                    "plain_ms": time_ms(lambda: fa._paged_prefill_reference(
                        q, k, v, pages, st, scale), 5, flush),
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


def b5_device_start_check(torch, fa, dev, gen, k, v, pages, scale):
    """B5 reads its chunk's start from device memory: one call captured
    in a CUDA graph with ``start`` a [1] int32 tensor, replayed after
    other starts are written into that tensor, gives at each start the
    bits of a direct call there (so the launch did not freeze the start
    it was captured with) within KERNEL_TOL of the plain version."""
    C = 256
    q = torch.randn((C, H, DH), generator=gen, device=dev)
    start = torch.zeros((1,), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fa.paged_prefill_attention(q, k, v, pages, start)  # warm-up
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.paged_prefill_attention(q, k, v, pages, start)
    starts = (0, 16, 700, 1024, MP * PS - C)
    worst = 0.0
    for s in starts:
        start.fill_(s)
        graph.replay()
        st = torch.tensor([s], dtype=torch.int32, device=dev)
        direct = fa.paged_prefill_attention(q, k, v, pages, st)
        ref = fa._paged_prefill_reference(q, k, v, pages, st, scale)
        check(torch.equal(out, direct),
              "B5 replayed at start %d differs from a direct call" % s)
        worst = max(worst, (out - ref).abs().max().item())
    check(worst <= KERNEL_TOL, "B5 replays vs plain", worst)
    del graph
    return {"starts": list(starts), "max_abs_err": worst,
            "replay_bitwise_direct": True}


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
    merge_us, b4_calls, b5_calls = 0.0, 0, 0
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
        b5_calls += "paged_prefill_kernel" in name
    busy = sum(families.values())
    return {"window_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_by_family": {k: v / 1e3 for k, v in families.items()},
            "b4_merge_ms": merge_us / 1e3, "b4_calls_seen": b4_calls,
            "b4_share_of_wall": families["paged_decode"] / wall_us,
            # a call's device time as the replayed steps run it
            "b4_ms_per_call": (families["paged_decode"] / b4_calls / 1e3
                               if b4_calls else None),
            "b5_calls_seen": b5_calls,
            "b5_ms_per_call": (families["paged_prefill"] / b5_calls / 1e3
                               if b5_calls else None),
            "device_events": len(kernels)}


class Scraper:
    """Scrapes a MetricsServer's ``/metrics`` on a thread of its own, at
    once and then every SCRAPE_EVERY_S seconds until ``stop()`` (a load
    shorter than the period is still scraped while it runs), each
    exposition parsed with ``parse_prometheus(strict=True)``; keeps the
    count and the first error."""

    def __init__(self, obs, srv):
        self.obs, self.srv = obs, srv
        self.scrapes, self.errors = 0, []
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="chip-smoke-scraper")
        self._thread.start()

    def _loop(self):
        import urllib.request

        while True:
            try:
                with urllib.request.urlopen(self.srv.url + "/metrics",
                                            timeout=30) as r:
                    self.obs.parse_prometheus(r.read().decode(),
                                              strict=True)
                self.scrapes += 1
            except Exception as exc:  # noqa: BLE001 - checked by stop()
                self.errors.append(repr(exc))
            if self._done.wait(SCRAPE_EVERY_S):
                return

    def stop(self):
        self._done.set()
        self._thread.join(timeout=60)
        check(not self._thread.is_alive() and not self.errors
              and self.scrapes > 0, "scrapes under load", self.scrapes,
              self.errors[:1])
        return self.scrapes


def http_get(url):
    """(status, body) of a GET, an HTTP error's included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def export_checks(obs, engine, srv, bases):
    """The engine's endpoint after its load: ``/metrics`` parses strictly,
    each histogram of ``bases`` (registry names) has a bucket ladder that
    is monotone, ends at le="+Inf" and equals its ``_count`` there, with
    observations; ``/healthz`` answers 200 and ready.  Returns the
    sample count and each ladder's count."""
    status, body = http_get(srv.url + "/metrics")
    check(status == 200, "/metrics status", status)
    samples = obs.parse_prometheus(body, strict=True)
    counts = {}
    for base in bases:
        m = obs.prometheus_name(base) + "_seconds"
        # the engine's own cells carry no label; a labeled cell of the
        # family (a router's {model=...}, from an earlier phase) is a
        # ladder of its own
        ladder = sorted(
            ((k, v) for k, v in samples.items()
             if k.startswith(m + '_bucket{le="')),
            key=lambda kv: float(kv[0].split('le="')[1].split('"')[0]
                                 .replace("Inf", "inf")))
        values = [v for _, v in ladder]
        check(ladder and values == sorted(values)
              and 'le="+Inf"' in ladder[-1][0]
              and values[-1] == samples[m + "_count"] > 0,
              "bucket ladder of %s" % m, ladder[-3:])
        counts[base] = samples[m + "_count"]
    status, body = http_get(srv.url + "/healthz")
    check(status == 200 and json.loads(body)["ready"] is True,
          "/healthz while ready", status, body[:200])
    return {"samples": len(samples), "ladder_counts": counts}


def stopped_health_check(engine, srv):
    """After ``engine.stop()``: its endpoint is down, and a fresh one
    from ``serve_metrics`` answers /healthz with 503, not ready."""
    check(not srv.running, "the endpoint outlived its engine")
    again = engine.serve_metrics(host="127.0.0.1")
    try:
        status, body = http_get(again.url + "/healthz")
        check(again is not srv and status == 503
              and json.loads(body)["ready"] is False,
              "/healthz after stop", status, body[:200])
    finally:
        again.stop()
    return status


def step_graph_stats(sched):
    """A scheduler's compiled steps on the card: each key's capture
    seconds and the bytes its private pool added, every entry captured,
    and the sums."""
    rows = {}
    for key, st in sched.step_stats().items():
        check(st["captured"], "decode step %r not captured" % (key,))
        rows["/".join(str(k) for k in key)] = {
            "capture_s": st["capture_s"], "pool_bytes": st["pool_bytes"]}
    return {"steps": rows, "captures": len(rows),
            "capture_s": sum(r["capture_s"] for r in rows.values()),
            "pool_bytes": sum(r["pool_bytes"] for r in rows.values())}


def graph_inputs(sched, key, rng):
    """Packed int32 inputs for a scheduler's step ``key`` (the layout its
    ``_build_step`` unpacks) that write and read real pages: decode,
    eight slots at kv_lens across the table's span (two inactive); a
    chunk, the first prompt's worth at width 2048 or a tail at start
    1024; kvguard, a page vector of the pool's pages."""
    cache = sched._cache
    mp, ps, S = cache.max_pages_per_seq, cache.page_size, \
        sched.config.num_slots
    V = sched.model.vocab_size
    row = lambda: rng.permutation(np.arange(1, cache.num_pages))[:mp]  # noqa
    if key[0] == "decode":
        # disjoint pages a slot, so no two slots write one row
        lens = np.array([0, 1, 17, 300, 1024, 2047, 5, 0], np.int32)[:S]
        perm = rng.permutation(np.arange(1, cache.num_pages))
        tables = np.stack([perm[i * mp:(i + 1) * mp] if n
                           else np.zeros(mp, np.int64)
                           for i, n in enumerate(lens)])
        pos = np.maximum(lens - 1, 0)
        return np.concatenate([rng.randint(0, V, S), pos, lens,
                               tables.reshape(-1)]).astype(np.int32)
    if key[0] == "kvguard":
        return row()[:key[1]].astype(np.int32)
    w = key[1]
    start, valid = (0, min(w, 1500)) if w > 1024 else (1024, w - 56)
    table = row()
    chunk = np.zeros(w // ps, np.int64)
    n = -(-valid // ps)
    chunk[:n] = table[start // ps:start // ps + n]
    return np.concatenate([rng.randint(0, V, w), [start, valid], chunk,
                           table]).astype(np.int32)


def graph_check(torch, fa, sched, key, L):
    """A captured step against its own function called op by op, on the
    same inputs and on a clone of the pools as they were before: every
    output (logits, sampled ids, or the guard's booleans) and both pools
    after the step bitwise equal (the scratch page 0, which collects the
    pad rows' colliding writes and is never read, left out); the replay
    adds B4 = L launches (decode) or B5 = L (a chunk)."""
    entry = sched._jit.get(key)
    check(entry.captured, "step %r is not captured" % (key,))
    rng = np.random.RandomState(SEED + 40 + len(str(key)))
    x = sched._dev(graph_inputs(sched, key, rng))
    cache = sched._cache
    k0, v0 = cache.k_pool.clone(), cache.v_pool.clone()
    before = dict(fa.KERNEL_LAUNCHES)
    with torch.no_grad():
        out_g = entry(x)
    torch.cuda.synchronize()
    added = {n: fa.KERNEL_LAUNCHES[n] - before[n] for n in before}
    k_g, v_g = cache.k_pool, cache.v_pool
    cache.k_pool, cache.v_pool = k0, v0
    try:
        with torch.no_grad():
            out_e = entry.fn(x)
        torch.cuda.synchronize()
    finally:
        cache.k_pool, cache.v_pool = k_g, v_g
    outs_g = out_g if isinstance(out_g, tuple) else (out_g,)
    outs_e = out_e if isinstance(out_e, tuple) else (out_e,)
    for a, b in zip(outs_g, outs_e):
        check(torch.equal(a, b), "graph %r output differs from op by op"
              % (key,))
    check(torch.equal(k_g[:, 1:], k0[:, 1:])
          and torch.equal(v_g[:, 1:], v0[:, 1:]),
          "graph %r pools differ from op by op" % (key,))
    want = {"decode": {"paged_decode_attention": L},
            "chunk": {"paged_prefill_attention": L},
            "kvguard": {}}[key[0]]
    check({n: c for n, c in added.items() if c} == want,
          "launches of a %r replay" % (key,), added)
    del k0, v0
    return {"key": list(key), "bitwise": True, "replay_launches": want,
            "capture_s": entry.capture_s, "pool_bytes": entry.pool_bytes}


def serving_phase(torch, T, serving, fa, obs, dev):
    from paddle_tpu_torch.executor import compile_count

    params, meta = T.lm_params(seed=SEED, **LM_WIDTH)
    logit_err = logits_check(torch, T, params, meta, dev)
    log("logits card vs cpu (prefill + 4 decode steps): max abs diff %.3g "
        "(tol %g)" % (logit_err, LOGIT_TOL))
    model = T.build_decode_model(params, meta, device=dev)
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(0, meta["vocab_size"],
                           size=int(n)).astype(np.int32)
               for n in rng.randint(32, 1501, size=N_REQUESTS)]
    # the same requests on an engine without the export plane first: its
    # tokens/s and tokens beside the scraped run's
    plain = serving.InferenceEngine(
        decode_model=model, decode_config=serving.DecodeConfig(
            **DECODE_CONFIG), device=dev)
    t0 = time.perf_counter()
    plain_outs = [f.result(timeout=600) for f in [
        plain.generate_async(p, max_new_tokens=NEW_TOKENS) for p in prompts]]
    plain_wall = time.perf_counter() - t0
    plain.stop()
    del plain
    t0 = time.perf_counter()
    engine = serving.InferenceEngine(
        decode_model=model, decode_config=serving.DecodeConfig(
            **DECODE_CONFIG), device=dev)
    setup_s = time.perf_counter() - t0
    # the export plane, scraped while the requests are served
    srv = engine.serve_metrics(host="127.0.0.1")
    steps = obs.counter("serving.decode.steps")
    prefills = obs.counter("serving.decode.prefills")
    step_timer = obs.timer("serving.decode.decode_step")
    steps0, prefills0 = steps.value, prefills.value
    timer0 = (step_timer.count, step_timer.total)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    compiles0 = compile_count()
    fa.reset_launch_counts()
    scraper = Scraper(obs, srv)
    t0 = time.perf_counter()
    futs = [engine.generate_async(p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(fa.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    n_steps = steps.value - steps0
    n_prefills = prefills.value - prefills0
    compiles = compile_count() - compiles0
    check(compiles == 0, "the decode load built or captured a step",
          compiles)
    graphs = step_graph_stats(engine._decoder)
    export = {"scrapes_under_load": scraper.stop()}
    export.update(export_checks(obs, engine, srv, (
        "serving.decode.queue_wait", "serving.decode.ttft",
        "serving.decode.step")))
    check(all(a.tobytes() == b.tobytes() for a, b in zip(outs, plain_outs)),
          "decode tokens with the export plane not bitwise without")
    export["bitwise_without_endpoint"] = True
    export["tokens_per_s_without_endpoint"] = (
        sum(len(o) for o in plain_outs) / plain_wall)
    widths = engine._decoder._chunk_widths()
    graph_checks = [graph_check(torch, fa, engine._decoder, key, L=meta[
        "n_layer"]) for key in (("decode",), ("chunk", widths[-1]),
                                ("chunk", 256))]
    profile = profile_window(torch, engine, meta)
    engine.stop()
    export["healthz_after_stop"] = stopped_health_check(engine, srv)
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
             "compiles_during_load": compiles, "graphs": graphs,
             "graph_checks": graph_checks,
             "launches": launches, "profile": profile, "export": export}
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


def prefix_leg(torch, serving, obs, dev, model, meta):
    """The prefix cache on a shared-prefix load: PREFIX_REQUESTS prompts
    that share a PREFIX_TOKENS-token prefix, each with a tail of
    PREFIX_TAILS tokens, PREFIX_NEW_TOKENS new tokens each; the first
    request alone, then the rest together, on an engine without the
    cache (cold) and one with it (warm).  Warm tokens bitwise the cold
    ones, at least half the prefill tokens saved, no page referenced or
    shared after the drain, no step built or captured under the load;
    TTFT p50/p95 each way."""
    from paddle_tpu_torch.executor import compile_count

    rng = np.random.RandomState(SEED + 30)
    V = meta["vocab_size"]
    prefix = rng.randint(0, V, PREFIX_TOKENS)
    prompts = [np.concatenate([prefix, rng.randint(0, V, int(n))])
               .astype(np.int32)
               for n in rng.randint(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1,
                                    size=PREFIX_REQUESTS)]
    prefill_tokens = obs.counter("serving.decode.prefill_tokens")
    res = {}
    for name, kw in (("cold", {}), ("warm", {"prefix_cache": True})):
        engine = serving.InferenceEngine(
            decode_model=model, decode_config=serving.DecodeConfig(
                **dict(DECODE_CONFIG, **kw)), device=dev)
        p0, c0 = prefill_tokens.value, compile_count()
        t0 = time.perf_counter()
        futs = [engine.generate_async(prompts[0],
                                      max_new_tokens=PREFIX_NEW_TOKENS)]
        futs[0].result(timeout=600)
        futs += [engine.generate_async(p, max_new_tokens=PREFIX_NEW_TOKENS)
                 for p in prompts[1:]]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        dec = engine._decoder
        st, cache = dec.stats(), dec.cache_stats()
        engine.stop()
        check(st["kv_pages_used"] == 0 and cache["shared_pages"] == 0
              and cache["rc_errors"] == [] and cache["rc_sum_matches"],
              "prefix leg %s left pages referenced" % name, st, cache)
        check(compile_count() == c0, "prefix leg %s built a step" % name)
        ttft = np.array([f.token_times[0] - f.enqueue_ts for f in futs])
        res[name] = {
            "outs": outs, "prefill_tokens": prefill_tokens.value - p0,
            "wall_s": wall,
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
            "ttft_p95_ms": float(np.percentile(ttft, 95) * 1e3),
            "prefix": st.get("prefix"), "kv_pages_used": st["kv_pages_used"],
            "kv_shared_pages": cache["shared_pages"]}
        del engine, dec
        gc.collect()
    warm, cold = res["warm"], res["cold"]
    bad = [i for i, (a, b) in enumerate(zip(warm["outs"], cold["outs"]))
           if a.tobytes() != b.tobytes()]
    check(not bad, "prefix leg: warm tokens differ from cold", bad)
    saved = 1.0 - warm["prefill_tokens"] / cold["prefill_tokens"]
    check(saved >= 0.5 and warm["prefix"]["kv_hit_pages"] > 0,
          "prefix leg: prefill tokens saved", saved, warm["prefix"])
    for r in res.values():
        del r["outs"]
    out = {"requests": PREFIX_REQUESTS, "prefix_tokens": PREFIX_TOKENS,
           "tails": list(PREFIX_TAILS), "new_tokens": PREFIX_NEW_TOKENS,
           "warm_bitwise_cold": True, "prefill_tokens_saved": saved,
           "cold": cold, "warm": warm}
    log("prefix leg: " + json.dumps(out))
    return out


def guard_leg(torch, serving, fa, dev, model, meta, prompts):
    """kv_guard=True on one engine: GUARD_REQUESTS requests served clean,
    then again with ``faults.corrupt_kv_page`` writing NaN into one
    decoding sequence's tail page: exactly that sequence fails with
    KVCorruption (kv_guard_trips +1), the others' tokens are bitwise the
    clean run's, and both pools are finite after the scrub.  The guard's
    captured steps (the decode step's tail pages and the widest chunk's
    pages) are held against their functions op by op."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.testing import faults

    engine = serving.InferenceEngine(
        decode_model=model, decode_config=serving.DecodeConfig(
            **dict(DECODE_CONFIG, kv_guard=True)), device=dev)
    dec = engine._decoder
    batch = prompts[:GUARD_REQUESTS]
    clean = [f.result(timeout=600) for f in [
        engine.generate_async(p, max_new_tokens=GUARD_NEW_TOKENS)
        for p in batch]]
    trips = obs.counter("serving.decode.kv_guard_trips")
    t0 = trips.value
    futs = [engine.generate_async(p, max_new_tokens=GUARD_NEW_TOKENS)
            for p in batch]
    # the NaN goes to row 0 of the tail page; a sequence whose next
    # token would open a fresh page would overwrite it, so the target is
    # one whose length after its second token is off a page boundary
    ti = next(i for i, p in enumerate(batch)
              if i and (len(p) + 1) % DECODE_CONFIG["page_size"])
    with faults.corrupt_kv_page(dec, seq=futs[ti].seq, after_tokens=2) \
            as fired:
        failed = []
        for i, f in enumerate(futs):
            try:
                out = f.result(timeout=600)
            except serving.KVCorruption:
                failed.append(i)
                continue
            check(out.tobytes() == clean[i].tobytes(),
                  "guard leg: request %d differs from the clean run" % i)
    check(fired[0] == 1 and failed == [ti] and trips.value - t0 == 1,
          "guard leg: one KVCorruption", fired, failed, trips.value - t0)
    finite = bool(torch.isfinite(dec._cache.k_pool).all()
                  and torch.isfinite(dec._cache.v_pool).all())
    check(finite, "guard leg: pools not finite after the scrub")
    checks = [graph_check(torch, fa, dec, ("kvguard", n), meta["n_layer"])
              for n in (DECODE_CONFIG["num_slots"],
                        dec._chunk_widths()[-1] // DECODE_CONFIG["page_size"])]
    st = dec.stats()
    engine.stop()
    check(st["kv_pages_used"] == 0, "guard leg leaked pages", st)
    out = {"requests": len(batch), "failed": failed,
           "kv_guard_trips": trips.value - t0, "others_bitwise": True,
           "pools_finite": finite, "graph_checks": checks}
    log("guard leg: " + json.dumps(out))
    return out


def journal_leg(torch, serving, dev, model, prompts):
    """DecodeJournal replay: JOURNAL_REQUESTS requests (every other one
    sampled at a fixed seed) served fault-free on scheduler A; the same
    requests on scheduler B, whose worker is killed at dispatch
    JOURNAL_KILL_AT (mid-decode); ``evict_if_dead`` harvests them and
    each is resubmitted to A from its journal.  Every sequence's tokens
    are bitwise the fault-free run's."""
    from paddle_tpu_torch.testing import faults

    cfg = serving.DecodeConfig(**DECODE_CONFIG)
    batch = prompts[:JOURNAL_REQUESTS]
    kws = [dict(temperature=0.8, seed=100 + i) if i % 2 else {}
           for i in range(len(batch))]
    a = serving.DecodeScheduler(model, cfg)
    want = [f.result(timeout=600) for f in [
        a.submit(p, max_new_tokens=JOURNAL_NEW_TOKENS, **kw)
        for p, kw in zip(batch, kws)]]
    b = serving.DecodeScheduler(model, cfg, autostart=False)
    reqs = [b.submit(p, max_new_tokens=JOURNAL_NEW_TOKENS, **kw)
            for p, kw in zip(batch, kws)]
    with faults.kill_worker(at_dispatch=JOURNAL_KILL_AT):
        b.start()
        deadline = time.time() + 300
        while b.alive and time.time() < deadline:
            time.sleep(0.01)
    check(not b.alive, "journal leg: the worker was not killed")
    accepted = [len(r.journal.accepted) for r in reqs]
    harvested = b.evict_if_dead()
    check(len(harvested) == len(reqs) and b.cache_stats()["used_pages"] == 0
          and all(0 < n < JOURNAL_NEW_TOKENS for n in accepted),
          "journal leg: harvest", len(harvested), accepted)
    for r in harvested:
        a.resubmit(r)
    got = [r.result(timeout=600) for r in reqs]
    a.stop()
    b.stop()
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if g.tobytes() != w.tobytes()]
    check(not bad, "journal leg: resumed tokens differ", bad)
    out = {"requests": len(batch), "sampled": sum(1 for k in kws if k),
           "accepted_at_kill": accepted, "bitwise_fault_free": True}
    log("journal leg: " + json.dumps(out))
    return out


def runtime_phase(torch, T, serving, fa, obs, dev, prompts):
    """The rest of the decode runtime on the card: the prefix, guard and
    journal legs on the serving phase's model."""
    resident_gib(torch, dev)
    params, meta = T.lm_params(seed=SEED, **LM_WIDTH)
    model = T.build_decode_model(params, meta, device=dev)
    t0 = time.perf_counter()
    out = {"prefix": prefix_leg(torch, serving, obs, dev, model, meta),
           "guard": guard_leg(torch, serving, fa, dev, model, meta,
                              prompts),
           "journal": journal_leg(torch, serving, dev, model, prompts)}
    out["seconds"] = time.perf_counter() - t0
    log("decode runtime legs: %.1f s" % out["seconds"])
    return out


def union_ms(events):
    """Busy milliseconds of the union of the kernels' intervals: kernels
    of two streams that run at once are counted once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def pool_profile(torch, pool, meta):
    """A replica pool's decode window under torch.profiler: 8 concurrent
    256-token prompts, 32 new tokens each (profile_window's load).  The
    idle share is of the union of kernel intervals, since kernels of two
    replicas' streams may run at once; ``overlap_ms``, the summed kernel
    time less the union, is the time they did."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(SEED + 4)
    prompts = [rng.randint(0, meta["vocab_size"], size=256).astype(np.int32)
               for _ in range(8)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = [pool.generate_async(p, max_new_tokens=32) for p in prompts]
        for f in futs:
            f.result(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return "not measured (the profiler recorded no device activity)"
    busy = union_ms(kernels)
    total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {"window_wall_ms": wall_ms, "device_busy_ms": busy,
            "kernel_ms_summed": total, "overlap_ms": total - busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_events": len(kernels)}


def decode_pool_leg(torch, serving, fa, obs, dev, model, meta, prompts,
                    want):
    """POOL_REPLICAS decode replicas of ``model`` on this card: the
    rotations' timed runs, profiled windows at N = 1 and 2, and the kill
    at N = 4 (see the docstring's phase 7)."""
    from paddle_tpu_torch.executor import compile_count
    from paddle_tpu_torch.testing import faults

    L = meta["n_layer"]
    reserved0 = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    pool = serving.ReplicaPool(
        None, replicas=POOL_REPLICAS, devices=[dev], decode_model=model,
        decode_config=serving.DecodeConfig(**DECODE_CONFIG))
    setup_s = time.perf_counter() - t0
    reps = pool._replicas
    check(len({r.stream.cuda_stream for r in reps}) == POOL_REPLICAS
          and all(r.device == dev for r in reps), "a stream a replica")
    graphs = [step_graph_stats(r.decoder) for r in reps]
    warm = {"setup_s": setup_s,
            "captures": sum(g["captures"] for g in graphs),
            "capture_s": sum(g["capture_s"] for g in graphs),
            "pool_bytes": sum(g["pool_bytes"] for g in graphs),
            "memory_reserved_gib": torch.cuda.memory_reserved(dev) / 2 ** 30,
            "reserved_added_gib":
            (torch.cuda.memory_reserved(dev) - reserved0) / 2 ** 30}
    log("pool: %d decode replicas warm: %s" % (POOL_REPLICAS,
                                               json.dumps(warm)))
    batch = list(prompts) * POOL_COPIES
    wants = list(want) * POOL_COPIES
    steps, prefills = (obs.counter("serving.decode.steps"),
                       obs.counter("serving.decode.prefills"))
    completed = lambda: [r.decoder.stats()["completed"]  # noqa: E731
                         for r in reps]
    torch.cuda.synchronize()
    compiles0, steps0, prefills0 = (compile_count(), steps.value,
                                    prefills.value)
    fa.reset_launch_counts()
    runs, profiles = {}, {}
    for n in POOL_ROTATIONS:
        check(pool.set_active_replicas(n) == n, "rotation", n)
        runs[n] = []
        for _ in range(POOL_RUNS):
            c0 = completed()
            t0 = time.perf_counter()
            futs = [pool.generate_async(p, max_new_tokens=NEW_TOKENS)
                    for p in batch]
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            served = [b - a for a, b in zip(c0, completed())]
            bad = [i for i, (o, w) in enumerate(zip(outs, wants))
                   if o.tobytes() != w.tobytes()]
            check(not bad, "pool N=%d: tokens differ from the engine's" % n,
                  bad[:4])
            check(all(c == 0 for c in served[n:])
                  and sum(1 for c in served if c) >= min(n, 2),
                  "pool N=%d: replicas that served" % n, served)
            runs[n].append({"wall_s": wall, "served_by_replica": served,
                            "tokens_per_s": sum(len(o) for o in outs)
                            / wall})
        if n <= 2:
            profiles[n] = pool_profile(torch, pool, meta)
    torch.cuda.synchronize()
    launches = dict(fa.KERNEL_LAUNCHES)
    n_steps, n_prefills = steps.value - steps0, prefills.value - prefills0
    compiles = compile_count() - compiles0
    check(compiles == 0, "the pool's load built or captured a step",
          compiles)
    check(launches["paged_decode_attention"] == L * n_steps > 0
          and launches["paged_prefill_attention"] == L * n_prefills > 0,
          "pool launches", launches, n_steps, n_prefills)
    tps = {n: [r["tokens_per_s"] for r in rs] for n, rs in runs.items()}
    log("pool: tokens/s by rotation (%d runs each) %s; profiled window "
        "at N=1 %s, at N=2 %s" % (POOL_RUNS, json.dumps(tps),
                                   json.dumps(profiles[1]),
                                   json.dumps(profiles[2])))
    # the kill: replica 1's decode worker dies mid-decode under N = 4
    replays = obs.counter("serving.decode.replays")
    r0 = replays.value
    with faults.kill_replica_mid_decode(POOL_KILLED) as fired:
        futs = [pool.generate_async(p, max_new_tokens=NEW_TOKENS)
                for p in batch]
        outs = [f.result(timeout=600) for f in futs]
    bad = [i for i, (o, w) in enumerate(zip(outs, wants))
           if o.tobytes() != w.tobytes()]
    check(fired[0] == 1 and not bad and replays.value - r0 >= 1,
          "pool kill: replayed bitwise", fired, bad[:4],
          replays.value - r0)
    killed = reps[POOL_KILLED]
    deadline = time.time() + 60
    while not killed.decoder.alive and time.time() < deadline:
        time.sleep(0.01)
    check(killed.decoder.alive, "pool kill: replica not revived")
    # the revived replica alone in the rotation serves the probes
    before = killed.decoder.stats()["completed"]
    for r in reps:
        r.active = r is killed
    time.sleep(0.2)
    try:
        probes = [pool.generate(p, max_new_tokens=POOL_PROBE_TOKENS,
                                timeout=600) for p in prompts[:4]]
    finally:
        for r in reps:
            r.active = True
    check(killed.decoder.stats()["completed"] - before == 4
          and all(o.tobytes() == w[:POOL_PROBE_TOKENS].tobytes()
                  for o, w in zip(probes, want)),
          "pool kill: the revived replica serves")
    check(pool.drain_decode(timeout=60) and not any(
        r.decoder.cache_stats()["used_pages"] for r in reps),
        "pool leaked pages")
    pool.stop()
    kill = {"replays": replays.value - r0, "revived_claimed": 4,
            "bitwise_fault_free": True}
    # replay_budget=0: the killed replica's sequences fail typed
    pool0 = serving.ReplicaPool(
        None, replicas=2, devices=[dev], decode_model=model,
        decode_config=serving.DecodeConfig(replay_budget=0,
                                           **DECODE_CONFIG))
    with faults.kill_replica_mid_decode(POOL_KILLED) as fired:
        futs = [pool0.generate_async(p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        failed = []
        for i, f in enumerate(futs):
            try:
                out = f.result(timeout=600)
            except serving.ServingDegraded as exc:
                check("replay budget (0)" in str(exc), str(exc))
                failed.append(i)
                continue
            check(out.tobytes() == want[i].tobytes(),
                  "replay_budget=0: request %d differs" % i)
    pool0.stop()
    check(fired[0] == 1 and failed, "replay_budget=0 failed nothing")
    kill["budget0_failed_typed"] = len(failed)
    kill["budget0_others_bitwise"] = len(prompts) - len(failed)
    log("pool kill: " + json.dumps(kill))
    del pool, pool0
    return {"warm": warm, "runs": runs, "tokens_per_s": tps,
            "profiles": profiles, "launches": launches,
            "decode_steps": n_steps, "prefill_chunks": n_prefills,
            "compiles_during_load": compiles, "kill": kill}


def predict_pool_leg(torch, serving, fa, obs, dev, saved):
    """POOL_PREDICT_REPLICAS predict replicas over the predict phase's
    Transformer-base scoring (``saved``) on each backend, every answer
    against a single engine's, and on the Program backend's pool a
    rolling swap to v2 under load (the docstring's phase 7)."""
    (d1, _), (d2, _) = saved
    vocab, seq = TRAIN_CFG["trg_vocab_size"], TRAIN_CFG["seq_len"]
    rng = np.random.RandomState(SEED + 60)
    feeds = [predict_feed(*predict_rows(rng, int(n), seq, vocab))
             for n in rng.randint(1, 3, size=POOL_PREDICT_REQUESTS)]
    kw = dict(batch_buckets=POOL_PREDICT_BUCKETS)
    out = {}
    for backend in ("program", "aot"):
        ref = predict_engine(serving, d1, dev, backend=backend, **kw)
        want = [ref.predict(f, timeout=600)[0] for f in feeds]
        ref.stop()
        del ref
        pool = serving.ReplicaPool(
            d1, replicas=POOL_PREDICT_REPLICAS, devices=[dev],
            backend=backend, batch_timeout_ms=2, **kw)
        b0 = obs.counter("serving.batches").value
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        got, _, wall = serve_clients(pool, feeds, 4)
        torch.cuda.synchronize()
        launches = dict(fa.KERNEL_LAUNCHES)
        dispatches = obs.counter("serving.batches").value - b0
        predict_launch_check(fa, launches, dispatches, "pool " + backend)
        served = [st["dispatches"] for st in pool.replica_stats()]
        check(all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
              and all(served), "pool %s: not bitwise the engine, or a "
              "replica idle" % backend, served)
        out[backend] = {"requests_per_s": len(feeds) / wall,
                        "dispatches": dispatches,
                        "dispatches_by_replica": served,
                        "launches": launches, "bitwise_engine": True}
        if backend == "program":
            out["swap"] = pool_swap(torch, serving, dev, pool, d2, feeds,
                                    kw)
        pool.stop()
        del pool
    log("pool predict: " + json.dumps(out))
    return out


def pool_swap(torch, serving, dev, pool, d2, feeds, kw):
    """A rolling swap of ``pool`` to ``d2`` under four clients: ready
    replicas never 0, answers after it bitwise a v2 engine's, memory
    reserved after it within POOL_SWAP_RESERVED_TOL of before (the old
    version's graphs and their pool freed)."""
    ref = predict_engine(serving, d2, dev, backend="program", **kw)
    want2 = [ref.predict(f, timeout=600)[0] for f in feeds[:4]]
    ref.stop()
    del ref
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved_before = torch.cuda.memory_reserved(dev)
    allocated_before = torch.cuda.memory_allocated(dev)
    stop, min_ready, errors, answered = (threading.Event(),
                                         [pool.ready_replicas()], [], [0])

    def client(i):
        try:
            while not stop.is_set():
                pool.predict(feeds[i % len(feeds)], timeout=600)
                answered[0] += 1
                i += 4
        except BaseException as exc:  # noqa: BLE001 - checked below
            errors.append(exc)

    def sampler():
        while not stop.is_set():
            min_ready[0] = min(min_ready[0], pool.ready_replicas())
            time.sleep(0.001)

    threads = ([threading.Thread(target=sampler)]
               + [threading.Thread(target=client, args=(i,))
                  for i in range(4)])
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    try:
        v2 = pool.swap_model(d2)
    finally:
        swap_s = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(timeout=600)
    check(not errors and min_ready[0] >= 1 and v2 == 2
          and pool.health()["model_versions"] == [2],
          "pool swap under load", errors[:1], min_ready[0])
    after = [pool.predict(f, timeout=600)[0] for f in feeds[:4]]
    check(all(a.tobytes() == w.tobytes() for a, w in zip(after, want2)),
          "pool: answers after the swap not bitwise a v2 engine's")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved_after = torch.cuda.memory_reserved(dev)
    allocated_after = torch.cuda.memory_allocated(dev)
    moved = abs(reserved_after - reserved_before) / reserved_before
    check(moved <= POOL_SWAP_RESERVED_TOL, "pool swap: memory reserved "
          "moved", reserved_before, reserved_after)
    return {"seconds": swap_s, "min_ready_replicas": min_ready[0],
            "answered_during": answered[0],
            "reserved_before_gib": reserved_before / 2 ** 30,
            "reserved_after_gib": reserved_after / 2 ** 30,
            "reserved_moved_share": moved,
            "allocated_before_gib": allocated_before / 2 ** 30,
            "allocated_after_gib": allocated_after / 2 ** 30}


def pool_phase(torch, T, serving, fa, obs, dev, prompts, want, saved):
    """The replica pool (A8.1) on one card: the decode leg at the serving
    phase's width and prompts (``want``: the serving engine's tokens for
    them), then the predict leg over the predict phase's saved models
    (``saved``, save_predict_models')."""
    resident_gib(torch, dev)
    params, meta = T.lm_params(seed=SEED, **LM_WIDTH)
    model = T.build_decode_model(params, meta, device=dev)
    t0 = time.perf_counter()
    out = {"decode": decode_pool_leg(torch, serving, fa, obs, dev, model,
                                     meta, prompts, want)}
    out["decode_s"] = time.perf_counter() - t0
    del model
    resident_gib(torch, dev)
    out["predict"] = predict_pool_leg(torch, serving, fa, obs, dev, saved)
    out["seconds"] = time.perf_counter() - t0
    log("pool phase: %.1f s (decode leg %.1f s)" % (out["seconds"],
                                                    out["decode_s"]))
    return out


def page_bits_probe(torch, serving, dev, model, meta):
    """ROADMAP F-13's question, on this card: are the KV bits of a page
    that decode steps wrote those a prefill of the same tokens writes?
    One SESSION_NEW_TOKENS-token turn of a SESSION_PROBE_PROMPT-token
    prompt on a scheduler with the prefix cache; its slot's pages are
    read at the last dispatch (the serve-fault choke point, on the
    worker) and compared, page by page and layer by layer, over the
    history's full pages (those the JAX package's ``_park_session``
    pins), with the pages a cold generate of the same history writes on
    a fresh scheduler.  Pages below prompt_len // page_size were written
    by a prefill chunk on both sides, the others by decode steps on the
    warm side."""
    from paddle_tpu_torch.testing import faults

    rng = np.random.RandomState(SEED + 80)
    prompt = rng.randint(0, meta["vocab_size"],
                         SESSION_PROBE_PROMPT).astype(np.int32)
    cfg = serving.DecodeConfig(**dict(DECODE_CONFIG, prefix_cache=True))
    ps = cfg.page_size
    warm = serving.DecodeScheduler(model, config=cfg,
                                   sessions=serving.SessionStore())
    seen = {}

    def note(requests):
        for slot in warm._slots:
            if slot is not None:
                seen["pages"], seen["kv_len"] = list(slot.pages), slot.kv_len

    with faults._serve_fault_installed(note):
        out = warm.generate(prompt, max_new_tokens=SESSION_NEW_TOKENS,
                            session="probe", timeout=600)
    history = np.concatenate([prompt, out]).astype(np.int32)
    kv_len = len(history) - 1             # the last token is never fed
    n_full = kv_len // ps
    n_prefill = len(prompt) // ps
    idx = torch.tensor(seen["pages"][:n_full], dtype=torch.long,
                       device=dev)
    warm_k = torch.index_select(warm._cache.k_pool, 1, idx).cpu()
    warm_v = torch.index_select(warm._cache.v_pool, 1, idx).cpu()
    warm.stop()
    cold = serving.DecodeScheduler(model, config=cfg)
    cold.generate(history, max_new_tokens=1, timeout=600)
    cache = cold._cache
    pages = cache._indexed_run(cache.prefix_hashes(history), n_full)
    check(len(pages) == n_full, "probe: the cold prefill's pages",
          len(pages), n_full)
    idx = torch.tensor(pages, dtype=torch.long, device=dev)
    cold_k = torch.index_select(cache.k_pool, 1, idx).cpu()
    cold_v = torch.index_select(cache.v_pool, 1, idx).cpu()
    cold.stop()
    del warm, cold
    res = {"prompt_len": len(prompt), "generated": len(out),
           "full_pages": n_full, "prefill_pages": n_prefill,
           "decode_pages": n_full - n_prefill}
    for region, sl in (("prefill", slice(0, n_prefill)),
                       ("decode", slice(n_prefill, n_full))):
        row = {}
        for name, a, b in (("k", warm_k, cold_k), ("v", warm_v, cold_v)):
            a, b = a[:, sl], b[:, sl]
            differ = a.view(torch.int32) != b.view(torch.int32)
            row[name] = {
                "max_abs_diff": float((a - b).abs().max()),
                "differing_layer0": int(differ[0].sum()),
                "differing_later_layers": int(differ[1:].sum()),
                "elements_later_layers": int(differ[1:].numel()),
                "pages_differing": int(differ.flatten(2).any(0).any(-1)
                                       .sum())}
        res[region] = row
    res["decode_pages_bitwise"] = all(
        res["decode"][n]["differing_layer0"]
        + res["decode"][n]["differing_later_layers"] == 0 for n in "kv")
    res["prefill_pages_bitwise"] = all(
        res["prefill"][n]["differing_layer0"]
        + res["prefill"][n]["differing_later_layers"] == 0 for n in "kv")
    log("session page-bits probe: " + json.dumps(res))
    return res


def session_traffic(meta):
    """The sessions phase's conversations: each one's first prompt (the
    shared system prefix and a message) and its later messages."""
    rng = np.random.RandomState(SEED + 90)
    V = meta["vocab_size"]
    system = rng.randint(0, V, SESSION_SYSTEM)
    firsts = [np.concatenate([system, rng.randint(0, V, int(n))])
              .astype(np.int32)
              for n in rng.randint(SESSION_FIRST[0], SESSION_FIRST[1] + 1,
                                   size=SESSION_CONVERSATIONS)]
    later = [[rng.randint(0, V, int(n)).astype(np.int32)
              for n in rng.randint(SESSION_LATER[0], SESSION_LATER[1] + 1,
                                   size=SESSION_TURNS - 1)]
             for _ in range(SESSION_CONVERSATIONS)]
    return firsts, later


def run_conversations(obs, pool, firsts, later, key=None, turns=None):
    """Every conversation's turns on ``pool``, all conversations at once
    and each one's turns in order: turn t's prompt is the history (the
    first prompt, then each turn's message and answer) and message t.
    ``key`` (``"%d"``-formatted) tags each conversation's session.
    Returns the tokens by conversation and turn, and a row a turn:
    prompt and prefill tokens, TTFT p50, wall seconds, the store's
    pinned pages after it."""
    prefill = obs.counter("serving.decode.prefill_tokens")
    hists = [list(map(int, f)) for f in firsts]
    outs = [[] for _ in firsts]
    rows = []
    for t in range(turns or SESSION_TURNS):
        if t:
            for c, msgs in enumerate(later):
                hists[c] += list(map(int, msgs[t - 1]))
        p0, t0 = prefill.value, time.perf_counter()
        futs = [pool.generate_async(
            np.asarray(h, np.int32), max_new_tokens=SESSION_NEW_TOKENS,
            **({} if key is None else {"session": key % c}))
            for c, h in enumerate(hists)]
        prompt_tokens = sum(len(h) for h in hists)
        for c, f in enumerate(futs):
            outs[c].append(f.result(timeout=600))
            hists[c] += list(map(int, outs[c][-1]))
        wall = time.perf_counter() - t0
        ttft = [f.token_times[0] - f.enqueue_ts for f in futs]
        rows.append({"prompt_tokens": prompt_tokens,
                     "prefill_tokens": prefill.value - p0,
                     "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
                     "wall_s": wall,
                     "pinned_pages": (pool.sessions.stats()["pinned_pages"]
                                      if pool.sessions is not None else 0)})
    return outs, rows


def pool_caches_clean(pool, what):
    """After ``end_session`` on every key and ``stop()``: every replica's
    allocator holds no page and its refcount sweep is clean."""
    for r in pool._replicas:
        st = r.decoder.cache_stats()
        check(st["used_pages"] == 0 and not st["rc_errors"]
              and st["rc_sum_matches"], "%s: replica %d's pages after "
              "stop" % (what, r.index), st["used_pages"], st["rc_errors"])


def session_kill_leg(obs, pool, firsts, later, want):
    """Conversation 0 again on the sessions pool, under a key of its own:
    its owner killed mid turn 2 (``faults.kill_session_owner``), the turn
    replayed bitwise the control pool's (on whichever replica claims the
    replay first: a sibling, or the owner once revived), and turn 3
    sticky to the re-parked session, mapping its pinned pages."""
    from paddle_tpu_torch.testing import faults

    sticky = obs.counter("serving.affinity.sticky")
    hits = obs.counter("serving.decode.kv_hit_pages")
    prefill = obs.counter("serving.decode.prefill_tokens")
    hist = list(map(int, firsts[0]))
    outs = [pool.generate(np.asarray(hist, np.int32),
                          max_new_tokens=SESSION_NEW_TOKENS,
                          session="kill", timeout=600)]
    owner = pool.sessions.get("kill", touch=False).replica
    hist += list(map(int, outs[0])) + list(map(int, later[0][0]))
    with faults.kill_session_owner(pool, "kill", min_tokens=2) as fired:
        outs.append(pool.generate(np.asarray(hist, np.int32),
                                  max_new_tokens=SESSION_NEW_TOKENS,
                                  session="kill", timeout=600))
    moved = pool.sessions.get("kill", touch=False).replica
    hist += list(map(int, outs[1])) + list(map(int, later[0][1]))
    s0, h0, p0 = sticky.value, hits.value, prefill.value
    outs.append(pool.generate(np.asarray(hist, np.int32),
                              max_new_tokens=SESSION_NEW_TOKENS,
                              session="kill", timeout=600))
    bad = [t for t in range(3) if outs[t].tobytes() != want[0][t].tobytes()]
    check(fired[0] == 1 and not bad
          and sticky.value - s0 == 1 and hits.value - h0 > 0,
          "sessions: the owner's kill", fired, bad, owner, moved,
          sticky.value - s0, hits.value - h0)
    return {"owner": owner, "reparked_on": moved,
            "turn3_prompt_tokens": len(hist),
            "turn3_prefill_tokens": prefill.value - p0,
            "turn3_hit_pages": hits.value - h0, "bitwise_control": True}


def sessions_phase(torch, T, serving, fa, obs, dev):
    """Conversational sessions and prefill/decode roles (A8.2) on one
    card: the page-bits probe, then SESSION_CONVERSATIONS conversations
    of SESSION_TURNS turns on three pools of SESSION_REPLICAS replicas on
    this card at the serving width (the sessions pool, the roles pool
    and a control that prefills every history cold), each pool's tokens
    bitwise the control's, turn by turn (the docstring's phase 7)."""
    from paddle_tpu_torch.executor import compile_count

    resident_gib(torch, dev)
    t_phase = time.perf_counter()
    params, meta = T.lm_params(seed=SEED, **LM_WIDTH)
    model = T.build_decode_model(params, meta, device=dev)
    L, ps = meta["n_layer"], DECODE_CONFIG["page_size"]
    out = {"page_bits": page_bits_probe(torch, serving, dev, model, meta)}
    firsts, later = session_traffic(meta)
    steps, prefills = (obs.counter("serving.decode.steps"),
                       obs.counter("serving.decode.prefills"))
    handoff = {n: obs.counter("serving.handoff." + n) for n in
               ("packets", "pages", "bytes", "injected", "failed")}
    legs = {n: obs.timer("serving.handoff.stage", labels={"leg": n})
            for n in ("gather", "scatter")}
    n_gen = SESSION_CONVERSATIONS * SESSION_TURNS
    res, outs = {}, {}
    for name, kw, cfg in (
            ("control", {"sessions": False, "affinity_timeout_s": 0}, {}),
            ("sessions", {}, {"prefix_cache": True}),
            ("roles", {"roles": SESSION_ROLES}, {"prefix_cache": True})):
        t0 = time.perf_counter()
        pool = serving.ReplicaPool(
            None, replicas=SESSION_REPLICAS, devices=[dev],
            decode_model=model, decode_config=serving.DecodeConfig(
                **dict(DECODE_CONFIG, **cfg)), **kw)
        setup_s = time.perf_counter() - t0
        check((pool.sessions is None) == (name == "control"),
              "sessions: %s pool's store" % name)
        torch.cuda.synchronize()
        c0, st0, pf0 = compile_count(), steps.value, prefills.value
        h0 = {n: c.value for n, c in handoff.items()}
        g0 = {n: (t.count, t.total) for n, t in legs.items()}
        reserved0 = torch.cuda.memory_reserved(dev)
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        outs[name], rows = run_conversations(
            obs, pool, firsts, later,
            key=None if name == "control" else "c%d")
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(fa.KERNEL_LAUNCHES)
        n_steps, n_chunks = steps.value - st0, prefills.value - pf0
        check(compile_count() == c0, "sessions: the %s pool's load built "
              "or captured a step" % name, compile_count() - c0)
        check(launches["paged_decode_attention"] == L * n_steps > 0
              and launches["paged_prefill_attention"] == L * n_chunks > 0,
              "sessions: %s pool launches" % name, launches, n_steps,
              n_chunks)
        moved = {n: c.value - h0[n] for n, c in handoff.items()}
        r = {"setup_s": setup_s, "wall_s": wall, "turns": rows,
             "tokens_per_s": sum(len(o) for c in outs[name] for o in c)
             / wall,
             "peak_pinned_pages": max(row["pinned_pages"] for row in rows),
             "decode_steps": n_steps, "prefill_chunks": n_chunks,
             "launches": {k: launches[k] for k in
                          ("paged_decode_attention",
                           "paged_prefill_attention")},
             "reserved_during_load_mib":
             (torch.cuda.memory_reserved(dev) - reserved0) / 2 ** 20,
             "completed_by_replica": [rep.decoder.stats()["completed"]
                                      for rep in pool._replicas]}
        if name == "roles":
            check(moved["packets"] == moved["injected"] == n_gen
                  and moved["failed"] == 0
                  and r["completed_by_replica"][0] == 0,
                  "sessions: every generation crossed as a packet", moved,
                  r["completed_by_replica"])
            stage = {n: {"calls": t.count - g0[n][0],
                         "mean_ms": (t.total - g0[n][1]) * 1e3
                         / max(1, t.count - g0[n][0])}
                     for n, t in legs.items()}
            r["handoff"] = dict(moved, mb=moved["bytes"] / 1e6,
                                mb_per_packet=moved["bytes"] / 1e6
                                / max(1, moved["packets"]), stage=stage)
        if name == "sessions":
            r["kill"] = session_kill_leg(obs, pool, firsts, later,
                                         outs["control"])
        if pool.sessions is not None:
            for key in pool.sessions.keys():
                check(pool.end_session(key), "sessions: end_session", key)
        pool.stop()
        pool_caches_clean(pool, name)
        res[name] = r
        log("sessions: %s pool: %s" % (name, json.dumps(r)))
        del pool
        gc.collect()
    for name in ("sessions", "roles"):
        bad = [(c, t) for c in range(SESSION_CONVERSATIONS)
               for t in range(SESSION_TURNS)
               if outs[name][c][t].tobytes()
               != outs["control"][c][t].tobytes()]
        check(not bad, "sessions: %s pool's tokens differ from the "
              "control's" % name, bad[:4])
    fewer = [res["sessions"]["turns"][t]["prefill_tokens"]
             < res["control"]["turns"][t]["prefill_tokens"]
             for t in range(1, SESSION_TURNS)]
    check(all(fewer), "sessions: prefill tokens not fewer than cold",
          [row["prefill_tokens"] for row in res["sessions"]["turns"]],
          [row["prefill_tokens"] for row in res["control"]["turns"]])
    # the turns' prompts the JAX package's park would have mapped too:
    # each later turn's previous history, up to its last fed token, in
    # full pages, against the prompt's full pages that the port pins
    prev = [len(f) for f in firsts]
    refused = 0
    for t in range(1, SESSION_TURNS):
        refused += sum(((n + SESSION_NEW_TOKENS - 1) // ps - n // ps) * ps
                       for n in prev)
        prev = [n + SESSION_NEW_TOKENS + len(later[c][t - 1])
                for c, n in enumerate(prev)]
    out.update(res)
    out["bitwise_control"] = True
    out["decode_pages_tokens_prefilled_again"] = refused
    out["seconds"] = time.perf_counter() - t_phase
    del model
    log("sessions phase: %.1f s" % out["seconds"])
    return out


def stream_holders(executor, streams, pools):
    """(holder, handle) of every stream a live replica of ``pools`` holds
    (its worker stream, its load streams and the capture side stream of
    each) and of the capture side streams kept for the streams the lease
    did not hand out; ``pools`` maps a name to a pool.  Each replica's
    streams must be held by its own lease, unless its pool stopped
    meanwhile (a sampler racing a deactivation)."""
    out = []
    for name, pool in pools.items():
        for r in pool._replicas:
            own = [(role, s) for role, s in
                   [("worker", r.stream), ("load0", r._load_streams[0]),
                    ("load1", r._load_streams[1])] if s is not None]
            for role, s in own:
                tag = "%s.r%d.%s" % (name, r.index, role)
                check(streams.leased(0, s) is r.lease
                      or pool._state == "stopped",
                      "router: %s not leased to its replica" % tag)
                out.append((tag, s.cuda_stream))
                side = streams.side_of(0, s)
                if side is not None:
                    out.append((tag + "-side", side.cuda_stream))
    for (index, cur), side in list(executor._CAPTURE_STREAMS.items()):
        out.append(("unleased %#x-side" % cur, side.cuda_stream))
    return out


def distinct_holders(executor, streams, pools, what):
    """Check that no two live holders share a stream; returns their
    count."""
    held = stream_holders(executor, streams, pools)
    seen = {}
    for tag, h in held:
        check(h not in seen, "router: %s shares stream %#x with %s (%s)"
              % (tag, h, seen.get(h), what))
        seen[h] = tag
    return len(held)


def warm_pools(router):
    return {"%s:%s" % (dep.name, ver.version): ver.pool
            for dep in list(router._deps.values())
            for ver in list(dep.versions.values()) if ver.pool is not None}


def memory_now(torch, dev, collect=True):
    """memory_allocated and memory_reserved in MiB, after a collection
    and ``empty_cache`` when ``collect``."""
    if collect:
        gc.collect()
    torch.cuda.synchronize()
    if collect:
        torch.cuda.empty_cache()
    return {"allocated_mib": torch.cuda.memory_allocated(dev) / 2 ** 20,
            "reserved_mib": torch.cuda.memory_reserved(dev) / 2 ** 20}


def router_counter(obs, name, model, version="v1"):
    return obs.counter("serving.router." + name,
                       {"model": model, "version": version}).value


def router_decode_leg(torch, serving, fa, obs, dev, models, prompts, want,
                      executor, streams):
    """Leg 1: lm-a and lm-b warm on a router with no budget, the serving
    prompts to each, interleaved: lm-a's tokens bitwise the serving
    engine's (``want``), lm-b's a dedicated pool's; then tokens/s through
    the router against a dedicated lm-a pool, alternated.  Returns the
    router (still serving), lm-b's tokens and the leg's figures."""
    L = LM_WIDTH["n_layer"]
    cfg = serving.DecodeConfig(**DECODE_CONFIG)

    def dedicated(model):
        return serving.ReplicaPool(None, replicas=ROUTER_REPLICAS,
                                   devices=[dev], decode_model=model,
                                   decode_config=cfg)

    def run(gen):
        t0 = time.perf_counter()
        outs = [f.result(timeout=600) for f in
                [gen(p) for p in prompts]]
        return outs, sum(len(o) for o in outs) / (time.perf_counter() - t0)

    ded_b = dedicated(models["lm-b"])
    want_b, _ = run(lambda p: ded_b.generate_async(
        p, max_new_tokens=NEW_TOKENS))
    ded_b.stop()
    del ded_b
    ded_a = dedicated(models["lm-a"])
    router = serving.ModelRouter(devices=[dev])
    setup = {}
    for name in ("lm-a", "lm-b"):
        t0 = time.perf_counter()
        router.deploy(name, None, replicas=ROUTER_REPLICAS,
                      decode_model=models[name], decode_config=cfg)
        setup[name] = time.perf_counter() - t0
    pools = dict(warm_pools(router), dedicated_a=ded_a)
    holders = distinct_holders(executor, streams, pools, "leg 1")
    keys = sum(len(r.decoder._jit) for r in router._deps["lm-a"].versions[
        "v1"].pool._replicas)
    steps, prefills = (obs.counter("serving.decode.steps"),
                       obs.counter("serving.decode.prefills"))
    torch.cuda.synchronize()
    st0, pf0 = steps.value, prefills.value
    fa.reset_launch_counts()
    futs = []
    for p in prompts:
        for name in ("lm-a", "lm-b"):
            futs.append((name, router.generate_async(
                name, p, max_new_tokens=NEW_TOKENS)))
    outs = {"lm-a": [], "lm-b": []}
    for name, f in futs:
        outs[name].append(f.result(timeout=600))
    torch.cuda.synchronize()
    launches = dict(fa.KERNEL_LAUNCHES)
    n_steps, n_chunks = steps.value - st0, prefills.value - pf0
    check(launches["paged_decode_attention"] == L * n_steps > 0
          and launches["paged_prefill_attention"] == L * n_chunks > 0,
          "router leg 1 launches", launches, n_steps, n_chunks)
    bad_a = [i for i, (o, w) in enumerate(zip(outs["lm-a"], want))
             if o.tobytes() != w.tobytes()]
    bad_b = [i for i, (o, w) in enumerate(zip(outs["lm-b"], want_b))
             if o.tobytes() != w.tobytes()]
    check(not bad_a and not bad_b, "router: lm-a's tokens not bitwise the "
          "serving engine's, or lm-b's not its dedicated pool's",
          bad_a[:4], bad_b[:4])
    # the router's host cost: lm-a alone through the router against a
    # dedicated pool over the same model, alternated
    tps = {"dedicated": [], "router": []}
    for how in ("dedicated", "router", "router", "dedicated"):
        gen = ((lambda p: ded_a.generate_async(p, max_new_tokens=NEW_TOKENS))
               if how == "dedicated" else
               (lambda p: router.generate_async(
                   "lm-a", p, max_new_tokens=NEW_TOKENS)))
        got, rate = run(gen)
        check(all(g.tobytes() == w.tobytes() for g, w in zip(got, want)),
              "router: %s run not bitwise" % how)
        tps[how].append(rate)
    distinct_holders(executor, streams, pools, "leg 1, timed")
    ded_a.stop()
    del ded_a
    leg = {"setup_s": setup, "launches": {
        k: launches[k] for k in ("paged_decode_attention",
                                 "paged_prefill_attention")},
           "decode_steps": n_steps, "prefill_chunks": n_chunks,
           "bitwise": True, "tokens_per_s": tps,
           "router_over_dedicated": (sum(tps["router"])
                                     / sum(tps["dedicated"])),
           "live_holders": holders, "step_keys_per_pool": keys}
    log("router leg 1 (bitwise per model): " + json.dumps(leg))
    return router, want_b, leg


def router_canary_leg(torch, serving, fa, obs, dev, router, saved):
    """Leg 2: the predict phase's two saved scoring versions as "scorer"
    v1 and v2 (one replica each) on the leg-1 router, split 0.75/0.25
    over ROUTER_CANARY requests: counts exact within one, agreeing with
    the labeled counter, each answer bitwise its version's dedicated
    pool's, B1 18 launches a dispatch; after rollback every request on
    v1."""
    (d1, _), (d2, _) = saved
    vocab, seq = TRAIN_CFG["trg_vocab_size"], TRAIN_CFG["seq_len"]
    rng = np.random.RandomState(SEED + 80)
    n = ROUTER_CANARY + ROUTER_ROLLBACK
    feeds = [predict_feed(*predict_rows(rng, int(k), seq, vocab))
             for k in rng.randint(1, 3, size=n)]
    kw = dict(batch_buckets=POOL_PREDICT_BUCKETS)
    wants = {}
    for v, d in (("v1", d1), ("v2", d2)):
        ded = serving.ReplicaPool(d, replicas=1, devices=[dev], **kw)
        wants[v] = [f.result(timeout=600)[0] for f in
                    [ded.predict_async(x) for x in feeds]]
        ded.stop()
        del ded
    t0 = time.perf_counter()
    router.deploy("scorer", d1, version="v1", replicas=1, **kw)
    router.deploy("scorer", d2, version="v2", replicas=1, **kw)
    setup_s = time.perf_counter() - t0
    router.route("scorer", dict(zip(("v1", "v2"), ROUTER_SPLIT)))
    c0 = {v: router_counter(obs, "requests", "scorer", v)
          for v in ("v1", "v2")}
    b0 = obs.counter("serving.batches").value
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    futs = [router.predict_async("scorer", x)
            for x in feeds[:ROUTER_CANARY]]
    got = [f.result(timeout=600)[0] for f in futs]
    torch.cuda.synchronize()
    launches = dict(fa.KERNEL_LAUNCHES)
    dispatches = obs.counter("serving.batches").value - b0
    predict_launch_check(fa, launches, dispatches, "router canary")
    served = []
    for i, g in enumerate(got):
        hit = [v for v in ("v1", "v2")
               if g.tobytes() == wants[v][i].tobytes()]
        check(len(hit) == 1, "router canary: answer %d bitwise neither or "
              "both versions" % i, hit)
        served.append(hit[0])
    counts = {v: served.count(v) for v in ("v1", "v2")}
    counted = {v: router_counter(obs, "requests", "scorer", v) - c0[v]
               for v in ("v1", "v2")}
    check(abs(counts["v1"] - ROUTER_CANARY * ROUTER_SPLIT[0]) <= 1
          and counts == counted, "router canary split", counts, counted)
    router.rollback("scorer")
    c1 = {v: router_counter(obs, "requests", "scorer", v)
          for v in ("v1", "v2")}
    after = [router.predict("scorer", x, timeout=600)[0]
             for x in feeds[ROUTER_CANARY:]]
    check(all(a.tobytes() == w.tobytes() for a, w in
              zip(after, wants["v1"][ROUTER_CANARY:]))
          and router_counter(obs, "requests", "scorer", "v1") - c1["v1"]
          == ROUTER_ROLLBACK
          and router_counter(obs, "requests", "scorer", "v2") == c1["v2"],
          "router: after rollback not every request on v1")
    leg = {"setup_s": setup_s, "counts": counts, "counter": counted,
           "dispatches": dispatches,
           "launches": launches["flash_attention_fwd"],
           "bitwise_dedicated": True, "rollback_all_v1": ROUTER_ROLLBACK}
    log("router leg 2 (canary): " + json.dumps(leg))
    return leg


def router_quota_leg(serving, obs, router, prompts, want):
    """Leg 3: tenant "tight" (ROUTER_TIGHT) on lm-a: four generations
    admitted two at a time, the fifth refused typed before any queue is
    touched, the labeled counter +1; a tenant with no quota passes 8."""
    router.set_quota("tight", **ROUTER_TIGHT)
    pool = router._deps["lm-a"].versions["v1"].pool
    q = pool._decode_queue
    order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
    n_new = ROUTER_QUOTA_TOKENS
    rej = obs.counter("serving.router.quota_rejections",
                      {"model": "lm-a", "tenant": "tight"})
    r0 = rej.value
    got = []
    for pair in (order[:2], order[2:4]):
        futs = [router.generate_async("lm-a", prompts[i], tenant="tight",
                                      max_new_tokens=n_new) for i in pair]
        got += [(i, f.result(timeout=600)) for i, f in zip(pair, futs)]
    depth, seq = q.depth(), q.last_seq()
    try:
        router.generate_async("lm-a", prompts[order[4]], tenant="tight",
                              max_new_tokens=n_new)
    except serving.ServingQuotaExceeded as exc:
        refused = str(exc)
    else:
        refused = None
    check(refused is not None and q.depth() == depth
          and q.last_seq() == seq and rej.value - r0 == 1,
          "router quota: the fifth generation not refused typed before "
          "the queue", refused, rej.value - r0)
    futs = [(i, router.generate_async("lm-a", prompts[i], tenant="open",
                                      max_new_tokens=n_new))
            for i in order[:8]]
    got += [(i, f.result(timeout=600)) for i, f in futs]
    check(all(o.tobytes() == want[i][:n_new].tobytes() for i, o in got),
          "router quota: tokens not bitwise the serving engine's")
    leg = {"admitted": 4, "refused": refused, "rejections": 1,
           "open_tenant_passed": 8}
    log("router leg 3 (quota): " + json.dumps(leg))
    return leg


def router_cold_leg(torch, serving, obs, dev, models, prompts, want,
                    want_b, executor, streams, leg_keys):
    """Leg 4 (and 5): ROUTER_CYCLES LRU cycles under live traffic on a
    router with replica_budget=2 (see the docstring's phase 7)."""
    from paddle_tpu_torch.executor import compile_count

    cfg = serving.DecodeConfig(**DECODE_CONFIG)
    router = serving.ModelRouter(replica_budget=ROUTER_REPLICAS,
                                 devices=[dev])
    router.deploy("lm-a", None, replicas=ROUTER_REPLICAS,
                  decode_model=models["lm-a"], decode_config=cfg)
    router.deploy("lm-b", None, replicas=ROUTER_REPLICAS, warm=False,
                  decode_model=models["lm-b"], decode_config=cfg)
    srv = router.serve_metrics(host="127.0.0.1")
    acts0 = {m: router_counter(obs, "activations", m)
             for m in ("lm-a", "lm-b")}
    fails0 = {m: router_counter(obs, "activation_failures", m)
              for m in ("lm-a", "lm-b")}
    compiles0 = compile_count()
    hot, hot_lock, errors = [], threading.Lock(), []
    stop, resume = threading.Event(), threading.Event()
    resume.set()
    holders = {"samples": 0, "max": 0}

    def submitter(t):
        i = t
        while not stop.is_set():
            resume.wait()
            k = i % len(prompts)
            try:
                f = router.generate_async("lm-a", prompts[k],
                                          max_new_tokens=ROUTER_HOT_TOKENS)
            except (serving.ServingQueueFull, serving.ServingOverloaded):
                time.sleep(0.01)
                continue
            except BaseException as exc:  # noqa: BLE001 - checked below
                errors.append(repr(exc))
                return
            with hot_lock:
                hot.append((k, f))
            i += ROUTER_SUBMITTERS
            time.sleep(ROUTER_HOT_GAP_S)

    def sampler():
        try:
            while not stop.is_set():
                n = distinct_holders(executor, streams,
                                     warm_pools(router), "leg 4")
                holders["samples"] += 1
                holders["max"] = max(holders["max"], n)
                time.sleep(0.02)
        except BaseException as exc:  # noqa: BLE001 - checked below
            errors.append(repr(exc))

    def quiesce():
        """Pause the submitters and wait for every hot request so far."""
        resume.clear()
        time.sleep(ROUTER_HOT_GAP_S)
        with hot_lock:
            pending = [f for _, f in hot]
        for f in pending:
            f.result(timeout=600)

    threads = ([threading.Thread(target=submitter, args=(t,))
                for t in range(ROUTER_SUBMITTERS)]
               + [threading.Thread(target=sampler)])
    for t in threads:
        t.start()
    cycles, scrape, cold, parks = [], None, [], []
    try:
        for cycle in range(ROUTER_CYCLES):
            quiesce()
            before = memory_now(torch, dev)
            resume.set()
            time.sleep(0.2)                 # traffic flowing on lm-a
            t0 = time.perf_counter()
            parked = []
            for j in range(ROUTER_COLD_REQUESTS):
                k = (cycle * ROUTER_COLD_REQUESTS + j) % len(prompts)
                t_park = time.perf_counter()
                parked.append((k, t_park, router.generate_async(
                    "lm-b", prompts[k], max_new_tokens=NEW_TOKENS)))
            parks.append(parked[0][1])
            check(all(isinstance(f, serving.RoutedRequest)
                      for _, _, f in parked), "router: lm-b was not cold")
            outs = [(k, f.result(timeout=600)) for k, _, f in parked]
            answered_s = time.perf_counter() - t0
            after_act = memory_now(torch, dev, collect=False)
            ttft = np.array([f._inner.token_times[0] - t_park
                             for _, t_park, f in parked])
            cold += outs
            # lm-a's parked traffic re-activates it, evicting lm-b
            deadline = time.time() + 600
            while time.time() < deadline:
                h = router.health()["deployments"]
                if (h["lm-a"]["versions"]["v1"]["tier"] == "warm"
                        and h["lm-b"]["versions"]["v1"]["tier"] == "cold"):
                    break
                time.sleep(0.01)
            cycle_s = time.perf_counter() - t0
            if cycle == 0:
                scrape = router_export_check(obs, router, srv)
            quiesce()
            kept = memory_now(torch, dev, collect=False)
            after = memory_now(torch, dev)
            resume.set()
            cycles.append({
                "parked_answered_s": answered_s, "cycle_s": cycle_s,
                "parked_ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
                "parked_ttft_max_ms": float(ttft.max() * 1e3),
                "memory_before": before, "memory_after_activation":
                after_act, "memory_after_deactivation": after,
                "allocated_after_deactivation_before_collect_mib":
                kept["allocated_mib"]})
            log("router leg 4 cycle %d: %s" % (cycle, json.dumps(
                cycles[-1])))
    finally:
        stop.set()
        resume.set()
        for t in threads:
            t.join(timeout=600)
    check(not errors, "router: lm-a admission failed under the tier "
          "cycles", errors[:2])
    bad = [k for k, f in hot
           if f.result(timeout=600).tobytes()
           != want[k][:ROUTER_HOT_TOKENS].tobytes()]
    bad_b = [k for k, o in cold if o.tobytes() != want_b[k].tobytes()]
    check(not bad and not bad_b, "router: tier-cycle answers not bitwise",
          bad[:4], bad_b[:4])
    acts = {m: router_counter(obs, "activations", m) - acts0[m]
            for m in ("lm-a", "lm-b")}
    fails = {m: router_counter(obs, "activation_failures", m) - fails0[m]
             for m in ("lm-a", "lm-b")}
    compiles = compile_count() - compiles0
    check(acts == {"lm-a": ROUTER_CYCLES, "lm-b": ROUTER_CYCLES}
          and not any(fails.values()), "router activations", acts, fails)
    for i, c in enumerate(cycles):
        moved = abs(c["memory_after_deactivation"]["allocated_mib"]
                    - c["memory_before"]["allocated_mib"])
        check(moved <= ROUTER_ALLOCATED_TOL_MIB, "router cycle %d: memory "
              "allocated after the deactivation moved %.1f MiB" % (i, moved))
    r1 = cycles[0]["memory_after_deactivation"]["reserved_mib"]
    r3 = cycles[-1]["memory_after_deactivation"]["reserved_mib"]
    check(r3 <= ROUTER_RESERVED_GROWTH * r1, "router: memory reserved "
          "grew over the cycles", r1, r3)
    check(holders["samples"] > 0, "router: the stream sampler never ran")
    router.stop()
    healthz = stopped_health_check(router, srv)
    # each cycle's two activations: lm-b's (from its first park: the
    # reclaim, which drain-stops lm-a, then the pool's build, its warm-up
    # and captures) and lm-a's
    activation_s = []
    for first_park in parks:
        b, a = [{k: v for k, v in e.items() if k != "start"}
                for e in ROUTER_ACTIVATIONS if e["start"] > first_park][:2]
        check(b["model"] == "lm-b" and a["model"] == "lm-a"
              and b["captures"] == a["captures"] == leg_keys,
              "router: a cycle's activations", b, a, leg_keys)
        b["reclaim_s"] = next(e["start"] for e in ROUTER_ACTIVATIONS
                              if e["start"] > first_park) - first_park
        activation_s.append({"lm-b": b, "lm-a": a})
    check(compiles == 2 * ROUTER_CYCLES * leg_keys, "router: compiles under "
          "load are not the activations' captures", compiles, leg_keys)
    leg = {"cycles": cycles, "hot_requests": len(hot),
           "parked_requests": len(cold), "activations": acts,
           "activation": activation_s, "compiles_during_load": compiles,
           "stream_samples": holders["samples"],
           "max_live_holders": holders["max"],
           "streams_created": streams.LEASE.created(0),
           "export": scrape, "healthz_after_stop": healthz}
    log("router leg 4 (cold tier): " + json.dumps(leg))
    return leg


def router_export_check(obs, router, srv):
    """Leg 5: the router's /metrics once under leg 4's traffic, parsed
    strictly, with its labeled families; /healthz 200."""
    status, body = http_get(srv.url + "/metrics")
    check(status == 200, "router /metrics status", status)
    samples = obs.parse_prometheus(body, strict=True)
    want = ['%s_total{model="lm-%s",version="v1"}'
            % (obs.prometheus_name("serving.router." + fam), m)
            for fam in ("requests", "parked", "activations",
                        "deactivations") for m in ("a", "b")]
    want += [obs.prometheus_name("serving.router." + g)
             for g in ("warm_models", "replicas_in_use", "replica_budget")]
    missing = [k for k in want if k not in samples]
    check(not missing, "router /metrics lacks", missing)
    status, body = http_get(srv.url + "/healthz")
    check(status == 200 and json.loads(body)["ready"] is True,
          "router /healthz while serving", status, body[:200])
    return {"samples": len(samples), "router_families": len(want)}


ROUTER_ACTIVATIONS = []


def instrument_activations(torch):
    """Time every pool the router builds (its constructor: KV pools,
    warm-up runs and captures) and read its captures; returns the undo."""
    from paddle_tpu_torch.serving import router as router_mod

    real = router_mod.ReplicaPool

    def timed_pool(*args, **kw):
        t0 = time.perf_counter()
        pool = real(*args, **kw)
        seconds = time.perf_counter() - t0
        graphs = [step_graph_stats(r.decoder) for r in pool._replicas
                  if r.decoder is not None]
        ROUTER_ACTIVATIONS.append({
            "model": kw.get("model_label"), "start": t0,
            "pool_build_s": seconds,
            "captures": sum(g["captures"] for g in graphs),
            "capture_s": sum(g["capture_s"] for g in graphs),
            "warmup_and_rest_s": seconds - sum(g["capture_s"]
                                               for g in graphs)})
        return pool

    router_mod.ReplicaPool = timed_pool
    return lambda: setattr(router_mod, "ReplicaPool", real)


def router_phase(torch, T, serving, fa, obs, dev, prompts, want, saved):
    """The model router (A8.3) on one card: the docstring's phase 7,
    its legs 1-5.  ``prompts``/``want``: the serving phase's prompts and
    tokens; ``saved``: save_predict_models'."""
    from paddle_tpu_torch import executor, streams

    resident_gib(torch, dev)
    t_phase = time.perf_counter()
    models = {}
    for name, seed in (("lm-a", SEED), ("lm-b", SEED + 1)):
        params, meta = T.lm_params(seed=seed, **LM_WIDTH)
        models[name] = T.build_decode_model(params, meta, device=dev)
    del params
    timing = instrument_activations(torch)
    try:
        router, want_b, out = None, None, {}
        router, want_b, out["bitwise"] = router_decode_leg(
            torch, serving, fa, obs, dev, models, prompts, want, executor,
            streams)
        out["canary"] = router_canary_leg(torch, serving, fa, obs, dev,
                                          router, saved)
        out["quota"] = router_quota_leg(serving, obs, router, prompts, want)
        router.stop()
        del router
        resident_gib(torch, dev)
        del ROUTER_ACTIVATIONS[:]
        out["cold"] = router_cold_leg(
            torch, serving, obs, dev, models, prompts, want, want_b,
            executor, streams, out["bitwise"]["step_keys_per_pool"])
    finally:
        timing()
    left = {k: v for k, v in streams.LEASE.held().items()
            if v != executor._UNLEASED_SIDES.name}
    check(not left, "router: streams still leased after every pool "
          "stopped", left)
    out["seconds"] = time.perf_counter() - t_phase
    del models
    log("router phase: %.1f s" % out["seconds"])
    return out


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
    # the export plane, scraped while the requests are served
    srv = engine.serve_metrics(host="127.0.0.1")
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


def save_predict_models(torch, fluid, T, root):
    """The predict phase's two versions of Transformer-base scoring,
    saved once a run into ``root`` for the pool and predict phases: v1
    with its AOT artifact, v2 without.  Returns ((directory, seconds the
    save took), ...) for v1 and v2."""
    out = []
    for name, seed, aot in (("v1", SEED + 50, True),
                            ("v2", SEED + 51, False)):
        d = os.path.join(root, name)
        out.append((d, save_predict_model(fluid, T, d, seed, aot)))
    torch.cuda.empty_cache()
    return tuple(out)


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


def predict_phase(torch, fluid, T, serving, fa, obs, dev, saved):
    """Predict serving of Transformer-base scoring (the forward that
    ``get_model(use_flash=True)`` prunes to its logits) at TRAIN_CFG's
    width, saved by ``io.save_inference_model(..., aot=True)``
    (``saved``: save_predict_models' directories and seconds, saved
    before the pool phase) and served by InferenceEngine(model_dir=...)
    on the card.  Checks: card vs the port's plain CPU path on two rows
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
        (d1, save_s), (d2, save_program_s) = saved
        laps["save_v1_v2"] = save_s + save_program_s
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
        # the export plane, scraped while the load is served
        srv = load.serve_metrics(host="127.0.0.1")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.reset_launch_counts()
        scraper = Scraper(obs, srv)
        outs, lat, wall = serve_clients(load, load_feeds, 8)
        torch.cuda.synchronize()
        launches = dict(fa.KERNEL_LAUNCHES)
        export = {"scrapes_under_load": scraper.stop()}
        export.update(export_checks(obs, load, srv, (
            "serving.queue_wait", "serving.execute",
            "serving.request_latency_batch")))
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
        # switched off): the same load, once each
        blocks_ab = {"blocks": [], "one_product": []}
        plain_outs = None
        for tag in ("blocks", "one_product"):
            eng = predict_engine(serving, d1, dev, backend="program",
                                 batch_timeout_ms=2)
            if tag == "one_product":
                eng._model._exe.block_rows = None
            ab_outs, _, ab_wall = serve_clients(eng, load_feeds, 8)
            eng.stop()
            blocks_ab[tag].append(PREDICT_REQUESTS / ab_wall)
            if plain_outs is None:
                plain_outs = ab_outs
        del eng
        # the load's logits, served with the endpoint scraped, against
        # the same load on an engine without one
        check(all(a.tobytes() == b.tobytes()
                  for a, b in zip(outs, plain_outs)),
              "predict logits with the export plane not bitwise without")
        export["bitwise_without_endpoint"] = True
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
        export["healthz_after_stop"] = stopped_health_check(load, srv)
        del load, srv
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
            "batching_speedup": off_wall / on_wall,
            "export": export}
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


def resnet_errors(a, ref, fc="fc_0.", skip=()):
    """``a``'s step against ``ref``'s: the loss relative, each gradient's
    and statistic's max error of its tensor's max, the gradients of the
    fc whose names start with ``fc`` apart, all gradients' L2 distance
    of their L2 norm, the accuracy (0 and equal where a model has no
    statistics or accuracy).  The gradients named in ``skip`` are left
    out (zoo_check holds them apart)."""
    grads = {n: g for n, g in a["grads"].items() if n not in skip}
    # a gradient that is 0 throughout (SSD's box head of a map no ground
    # truth matched) is held to its absolute error
    per = {n: float(np.abs(g - ref["grads"][n]).max())
           / (float(np.abs(ref["grads"][n]).max()) or 1.0)
           for n, g in grads.items()}
    num = sum(float(np.sum((g - ref["grads"][n]) ** 2))
              for n, g in grads.items())
    den = sum(float(np.sum(ref["grads"][n] ** 2)) for n in grads)
    worst = max(per, key=per.get)
    return {"loss_rel": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_worst_of_max": per[worst], "grad_worst": worst,
            "fc_grad_worst_of_max": max(v for n, v in per.items()
                                        if n.startswith(fc)),
            "grad_global_l2": (num / den) ** 0.5,
            "stat_worst_of_max": max([
                float(np.abs(v - ref["stats"][n]).max())
                / float(np.abs(ref["stats"][n]).max())
                for n, v in a["stats"].items()] or [0.0]),
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


def resnet_bn_stats(torch, fluid, exe, m, scope, feed, rng):
    """Set each batch_norm's Scale and Bias (found through the op's
    inputs of ``m``'s test Program) in ``scope`` to seeded values in
    [0.5, 1.5] and [-0.5, 0.5], and its Mean and Variance to the
    statistics of ``feed``'s batch under them (one training step of
    ``m["main"]`` in a copy of the scope), so that a fold has a scale and
    a shift to carry in every layer."""
    bns = [op for op in m["test"].global_block().ops
           if op.type == "batch_norm"]
    names = [n for n in m["main"].persistable_names() if n in scope]
    for op in bns:
        for slot, lo, hi in (("Scale", 0.5, 1.5), ("Bias", -0.5, 0.5)):
            n = op.inputs[slot][0]
            scope[n] = torch.as_tensor(rng.uniform(
                lo, hi, tuple(scope[n].shape)).astype(np.float32),
                device=scope[n].device).to(scope[n].dtype)
    probe = copy_scope(fluid, scope, names)
    saved = exe.run(m["main"], feed=feed, scope=probe, fetch_list=[
        op.outputs[s][0] for op in bns for s in ("SavedMean",
                                                 "SavedVariance")],
        return_numpy=False)
    del probe
    for k, op in enumerate(bns):
        scope[op.inputs["Mean"][0]] = saved[2 * k].detach().clone()
        scope[op.inputs["Variance"][0]] = saved[2 * k + 1].detach().clone()


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
    x, y = resnet_images(np.random.RandomState(SEED + 65), batch)
    feed = {"data": torch.as_tensor(x, device=dev).to(dtype),
            "label": torch.as_tensor(y, device=dev)}
    exe = fluid.Executor(device=dev)
    resnet_bn_stats(torch, fluid, exe, m, scope, feed,
                    np.random.RandomState(SEED + 64))
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


# ---------------------------------------------------------------------------
# int8 quantization (quant_phase, ROADMAP A12.1)
# ---------------------------------------------------------------------------

# Q1: quantized_mul and quantized_conv2d on the card against their plain
# versions on the CPU, bitwise (an integer product is exact, and every
# float operation around it is the same IEEE operation on either device).
# quantized_mul: (rows, K, N): ResNet-50's fc at 5 and 256 images, and a
# head of 10 columns (N not a multiple of 8)
QUANT_MUL_CASES = {"rows_5": (5, 2048, 1000), "rows_256": (256, 2048, 1000),
                   "n_10": (64, 512, 10)}
# quantized_conv2d: (N, C, H, W, O, k, stride, pad, dilation, groups,
# bias): ResNet-50's stem (K = 3 a tap, 147 as im2col), a 3x3 at C 64, a
# strided 3x3, a 1x1 256 -> 64, a dilated 3x3, SE-ResNeXt's grouped 3x3
# (cardinality 32) and a 3x3 with the fold's Bias
QUANT_CONV_CASES = {
    "resnet_stem": (2, 3, 224, 224, 64, 7, 2, 3, 1, 1, False),
    "3x3_c64": (2, 64, 56, 56, 64, 3, 1, 1, 1, 1, False),
    "3x3_strided": (2, 128, 56, 56, 128, 3, 2, 1, 1, 1, False),
    "1x1_256_to_64": (2, 256, 56, 56, 64, 1, 1, 0, 1, 1, False),
    "dilated": (2, 64, 28, 28, 64, 3, 1, 2, 2, 1, False),
    "grouped": (2, 128, 28, 28, 128, 3, 1, 1, 1, 32, False),
    "bias": (2, 64, 56, 56, 64, 3, 1, 1, 1, 1, True),
}
# the fake quant on a 3x3 512 -> 512 filter (ResNet-50's widest)
QUANT_FAKE_SHAPE = (512, 512, 3, 3)
# torch._int_mm's shape limits on this card and PyTorch build, the second
# operand K-major as the port passes it: (rows, K, N) at and around them.
# A shape the port's padding makes (rows above 16, K and N multiples of 8)
# must be exact against the float64 product; the others are recorded,
# taken or refused
QUANT_INT_MM_SHAPES = ((16, 8, 8), (17, 8, 8), (17, 12, 8), (17, 8, 12),
                       (32, 16, 16))
# Q2: quantize-aware training of ResNet-50 at RESNET_BATCH: steps through
# Executor.run (eager, capture, replays), op by op and bound
QUANT_STEPS = 5
# replays in the profiled window of the int8 Program: the profiler may
# drop the first events of a window, so the check counts whole replays
# after the first
QUANT_PROFILED_REPLAYS = 3
# Q3: int8 inference at RESNET_INFER_BATCH; the card against the CPU's
# int8 run on QUANT_CPU_IMAGES images, within QUANT_CPU_OF_MAX of the
# largest |logit|
QUANT_CPU_IMAGES = 4
QUANT_CPU_OF_MAX = 1e-3
# the int8 logits' relative L2 distance from the folded float32 logits on
# the same state and images (predicted before the first run, PERF.md
# §6): each quantization (per-tensor activations, per-channel weights)
# rounds to 1/254 of its range, about 0.0023 of the range in RMS, an
# activation's range some 3-10 times its RMS: about 1% a layer in L2;
# ResNet-50's 54 quantized layers read 0.050 on the CPU at 64 x 64 and
# batch 16 (the phase rehearsed with these seeds), and the card's 224 x
# 224 is predicted at 0.03-0.08.  The limit, 3x the CPU's reading, still
# fails a fault: a dropped Bias or a wrong scale moves the logits by the
# order of their own size
QUANT_INT8_L2 = 0.15
# Q4: an evaluator's eval on the card against the CPU's: its counts are
# integers, its float32 sums (edit distances, the mAP's precision and
# recall) may add in another order
QUANT_EVAL_RTOL = 1e-6
# kernel names: a GEMM (cuBLAS, cuBLASLt, CUTLASS) and its int8 spelling,
# a convolution (cuDNN)
GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "gemv", "imma")
INT8_MARKS = ("s8", "i8", "int8", "imma")
CONV_MARKS = ("conv", "fprop", "dgrad", "wgrad", "implicit")


def quant_op_program(fluid, op_type, feeds, attrs, outs, grad=False,
                     bf16=False):
    """One ``op_type`` op appended raw over data variables named as
    ``feeds``' slots (``X``/``Input`` cast to bfloat16 where ``bf16``),
    its ``outs`` slots float32 variables; with ``grad``, also the
    gradient of sum(Out * g) with respect to X (``feeds["g"]``).
    Returns (Program, fetch list)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        vs = {slot: fluid.layers.data(
            name=slot.lower(), shape=list(a.shape), dtype=str(a.dtype),
            append_batch_size=False, stop_gradient=not grad)
            for slot, a in feeds.items()}
        ins = {s: [fluid.layers.cast(v, "bfloat16") if bf16 and s in (
            "X", "Input") else v] for s, v in vs.items() if s != "g"}
        helper = LayerHelper(op_type)
        out = {s: helper.create_variable_for_type_inference(dtype="float32")
               for s in outs}
        helper.append_op(type=op_type, inputs=ins,
                         outputs={s: [v] for s, v in out.items()},
                         attrs=attrs)
        fetch = [out[s] for s in outs]
        if grad:
            loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(
                out["Out"], vs["g"]))
            fetch += fluid.backward.calc_gradient(loss, [vs["X"]])
    return main, fetch


def quant_case(torch, fluid, dev, main, fetch, feeds):
    """``main`` on the card and on the CPU: (card fetches, CPU fetches,
    the largest difference)."""
    feed = {s.lower(): a for s, a in feeds.items()}
    card = [np.asarray(v, np.float32) for v in fluid.Executor(device=dev).run(
        main, feed=feed, fetch_list=fetch, scope=fluid.Scope())]
    cpu = [np.asarray(v, np.float32) for v in fluid.Executor(
        fluid.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                              scope=fluid.Scope())]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
    return card, cpu, diff


def quant_ops_check(torch, fluid, dev):
    """Q1: every case on the card against the CPU; the largest difference
    of each, all 0."""
    rng = np.random.RandomState(SEED + 170)
    rows = []
    for name, (m, k, n) in QUANT_MUL_CASES.items():
        feeds = {"X": rng.randn(m, k).astype(np.float32),
                 "QWeight": rng.randint(-127, 128, (k, n)).astype(np.int8),
                 "WScale": rng.uniform(0.01, 2.0, n).astype(np.float32)}
        for dtype in ("float32", "bfloat16"):
            main, fetch = quant_op_program(
                fluid, "quantized_mul", feeds, {"x_num_col_dims": 1},
                ["Out"], bf16=dtype == "bfloat16")
            card, _, diff = quant_case(torch, fluid, dev, main, fetch, feeds)
            check(np.isfinite(card[0]).all() and card[0].shape == (m, n),
                  "quantized_mul output", name, dtype)
            rows.append({"op": "quantized_mul", "case": name,
                         "dtype": dtype, "max_abs_err": diff})
    for name, (n, c, h, w, o, k, st, pad, dil, g, bias) in \
            QUANT_CONV_CASES.items():
        feeds = {"Input": rng.randn(n, c, h, w).astype(np.float32),
                 "QWeight": rng.randint(-127, 128, (o, c // g, k, k))
                 .astype(np.int8),
                 "WScale": rng.uniform(0.01, 2.0, o).astype(np.float32)}
        if bias:
            feeds["Bias"] = rng.randn(o).astype(np.float32)
        attrs = {"strides": [st, st], "paddings": [pad, pad],
                 "dilations": [dil, dil], "groups": g}
        for dtype in ("float32", "bfloat16"):
            main, fetch = quant_op_program(
                fluid, "quantized_conv2d", feeds, attrs, ["Output"],
                bf16=dtype == "bfloat16")
            card, _, diff = quant_case(torch, fluid, dev, main, fetch, feeds)
            check(np.isfinite(card[0]).all(), "quantized_conv2d output",
                  name, dtype)
            rows.append({"op": "quantized_conv2d", "case": name,
                         "dtype": dtype, "shape": list(card[0].shape),
                         "max_abs_err": diff})
    x = (rng.randn(*QUANT_FAKE_SHAPE) * 0.05).astype(np.float32)
    g = rng.randn(*QUANT_FAKE_SHAPE).astype(np.float32)
    main, fetch = quant_op_program(
        fluid, "fake_quantize_abs_max", {"X": x, "g": g},
        {"bit_length": 8}, ["Out", "OutScale"], grad=True)
    card, cpu, diff = quant_case(torch, fluid, dev, main, fetch,
                                 {"X": x, "g": g})
    check(card[2].tobytes() == g.tobytes(),
          "the fake quant's gradient is not the upstream gradient")
    rows.append({"op": "fake_quantize_abs_max", "case": "3x3_512",
                 "dtype": "float32", "max_abs_err": diff,
                 "out_scale": float(card[1][0]),
                 "gradient_is_upstream": True})
    check(all(r["max_abs_err"] == 0 for r in rows),
          "a quantized op on the card differs from the CPU", rows)
    return rows


def quant_int_mm_limits(torch, dev):
    """Q1's limits case: each QUANT_INT_MM_SHAPES product through
    ``torch._int_mm`` against the float64 product, or the error that
    refused it."""
    rng = torch.Generator().manual_seed(SEED + 171)
    rows = []
    for m, k, n in QUANT_INT_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=rng)
        b_t = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                            generator=rng)
        want = (a.double() @ b_t.double().t()).to(torch.int32)
        row = {"shape": [m, k, n]}
        try:
            got = torch._int_mm(a.to(dev), b_t.to(dev).t()).cpu()
            row["exact"] = torch.equal(got, want)
        except RuntimeError as exc:
            row["refused"] = str(exc).splitlines()[0][:120]
        padded = m > 16 and k % 8 == 0 and n % 8 == 0
        check(row.get("exact") or not padded,
              "torch._int_mm on a shape the port's padding makes", row)
        check(row.get("exact", True), "torch._int_mm took a shape and "
              "gave a wrong product", row)
        rows.append(row)
    return rows


def quant_train(torch, fluid, resnet, dev):
    """Q2: ResNet-50 at RESNET_BATCH, the training Program transpiled by
    ``QuantizeTranspiler.training_transpile`` (one fake quant a conv2d or
    mul weight), QUANT_STEPS steps from one start state three ways, with
    cuDNN's deterministic algorithms: the quantized Program op by op and
    through the fast path (eager, capture, replays: one capture, losses
    and every persistable bitwise the op-by-op run's), and the float
    Program through the fast path (step ms beside).  A
    ``metrics.Accuracy`` and an ``average.WeightedAverage`` take the fast
    run's fetched accuracies and losses.  Then ``freeze_program`` (in
    place: the same tensors, the scope's version unmoved) and
    ``convert_to_int8``.  Returns (stats, the float model, the
    quantize-aware run's scope, the persistable names)."""
    from paddle_tpu_torch import executor as executor_mod
    from paddle_tpu_torch.contrib.quantize import QuantizeTranspiler
    from paddle_tpu_torch.framework import OpRole

    m, q = resnet_model(fluid, resnet), resnet_model(fluid, resnet)
    qt = QuantizeTranspiler()
    t0 = time.perf_counter()
    qt.training_transpile(q["main"])
    transpile_s = time.perf_counter() - t0
    forward = [op for op in m["main"].global_block().ops
               if op.type in qt.QUANTIZABLE and op.attrs.get("op_role")
               not in (OpRole.Backward, OpRole.Optimize)]
    fakes = [op for op in q["main"].global_block().ops
             if op.type == "fake_quantize_abs_max"]
    check(len(fakes) == len({op.inputs[qt.QUANTIZABLE[op.type]][0]
                             for op in forward}) > 0,
          "one fake quant a conv2d/mul weight", len(fakes), len(forward))
    m["startup"].random_seed = SEED + 171
    scope0 = fluid.Scope()
    fluid.Executor(device=dev).run(m["startup"], scope=scope0)
    names = [n for n in m["main"].persistable_names() if n in scope0]
    x, y = resnet_images(np.random.RandomState(SEED + 172), RESNET_BATCH)
    feed = {"data": torch.as_tensor(x, device=dev),
            "label": torch.as_tensor(y, device=dev)}
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, model, cache in (("float", m, True),
                                    ("quant_eager", q, False),
                                    ("quant", q, True)):
            torch.cuda.empty_cache()
            exe, scope = fluid.Executor(device=dev), copy_scope(
                fluid, scope0, names)
            c0 = executor_mod.compile_count()
            losses, accs, step_s = [], [], []
            for _ in range(QUANT_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, acc = exe.run(model["main"], feed=feed,
                                    fetch_list=[model["loss"], model["acc"]],
                                    scope=scope, use_program_cache=cache)
                losses.append(np.asarray(loss))
                accs.append(np.asarray(acc))
                step_s.append(time.perf_counter() - t0)
            runs[label] = {
                "scope": scope, "losses": losses, "accs": accs,
                "step_s": step_s,
                "captures": executor_mod.compile_count() - c0,
                "entries": sum(b.program is model["main"]
                               for b in exe._bound.values())}
            if label == "float":
                del runs[label]["scope"]    # its pool and state go now
            del exe, scope
    finally:
        torch.backends.cudnn.deterministic = False
    del scope0
    e, f = runs["quant_eager"], runs["quant"]
    bitwise = (all(a.tobytes() == b.tobytes()
                   for a, b in zip(e["losses"], f["losses"]))
               and all(fluid.executor.as_numpy(e["scope"][n]).tobytes()
                       == fluid.executor.as_numpy(f["scope"][n]).tobytes()
                       for n in names))
    check(bitwise and f["captures"] == 1 and f["entries"] == 1
          and e["captures"] == 0,
          "quantize-aware steps not bound and replayed bitwise",
          bitwise, f["captures"], f["entries"], e["captures"])
    del e["scope"]
    losses = [float(v.reshape(-1)[0]) for v in f["losses"]]
    check(all(np.isfinite(losses)), "quantize-aware loss", losses)
    acc_metric = fluid.metrics.Accuracy()
    avg = fluid.average.WeightedAverage()
    for loss, acc in zip(f["losses"], f["accs"]):
        acc_metric.update(acc, RESNET_BATCH)
        avg.add(loss, RESNET_BATCH)
    accs = [float(a.reshape(-1)[0]) for a in f["accs"]]
    metric_err = max(abs(acc_metric.eval() - float(np.mean(accs))),
                     abs(avg.eval() - float(np.mean(losses))))
    check(metric_err <= 1e-12 * max(1.0, abs(float(np.mean(losses)))),
          "Accuracy / WeightedAverage against numpy's means", metric_err)
    scope = f["scope"]
    held = {n: scope[n] for n in names}
    version = scope._version
    t0 = time.perf_counter()
    qt.freeze_program(q["main"], scope)
    freeze_s = time.perf_counter() - t0
    check(scope._version == version
          and all(scope[n] is t for n, t in held.items()),
          "freeze_program replaced a scope tensor")
    qt.convert_to_int8(q["main"], scope)
    wnames = [op.inputs["X"][0] for op in fakes]
    check(all(scope[w + ".int8"].dtype == torch.int8
              and scope[w + ".int8"].device == scope[w].device
              for w in wnames), "convert_to_int8's tensors")
    int8_bytes = sum(scope[w + ".int8"].numel() for w in wnames)
    f32_bytes = sum(scope[w].numel() * scope[w].element_size()
                    for w in wnames)
    check(4 * int8_bytes == f32_bytes, "int8 storage", int8_bytes, f32_bytes)
    stats = {
        "batch": RESNET_BATCH, "steps": QUANT_STEPS,
        "fake_quant_ops": len(fakes), "quantized_weights": len(wnames),
        "transpile_s": transpile_s, "freeze_s": freeze_s,
        "captures": f["captures"], "entries": f["entries"],
        "replays_bitwise_eager": bitwise, "cudnn_deterministic": True,
        "losses": losses, "accuracies": accs,
        "accuracy_metric": acc_metric.eval(), "loss_average": avg.eval(),
        "step_ms": steady_ms(f["step_s"]),
        "step_ms_all": [t * 1e3 for t in f["step_s"]],
        "eager_step_ms": float(np.mean(e["step_s"][1:])) * 1e3,
        "float_step_ms": steady_ms(runs["float"]["step_s"]),
        "float_losses": [float(v.reshape(-1)[0])
                         for v in runs["float"]["losses"]],
        "convert_to_int8_bytes": int8_bytes, "f32_weight_bytes": f32_bytes}
    stats["over_float"] = stats["step_ms"] / stats["float_step_ms"]
    return stats, m, scope, names


def kernel_counts(torch, step, calls=1):
    """The device kernels of ``calls`` calls of ``step``, by name:
    (launches, device ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return {k: (n, us / 1e3) for k, (n, us) in out.items()}


def gemm_kinds(kernels):
    """Kernels by kind: int8 GEMMs, float GEMMs, convolutions, other."""
    kinds = {"int8_gemm": {}, "float_gemm": {}, "conv": {}, "other": {}}
    for name, (n, ms) in kernels.items():
        low = name.lower()
        if any(k in low for k in CONV_MARKS):
            kind = "conv"
        elif any(k in low for k in GEMM_MARKS):
            kind = ("int8_gemm" if any(k in low for k in INT8_MARKS)
                    else "float_gemm")
        else:
            kind = "other"
        kinds[kind][name[:120]] = [n, ms]
    return kinds


def quant_infer(torch, fluid, dev, m, scope, names, resnet_f32=None,
                resnet_bf16=None):
    """Q3: the frozen state's test Program (statistics as resnet_infer
    sets them) folded by the InferenceTranspiler, then
    ``Int8InferenceTranspiler``: every conv2d and mul quantized, each
    folded conv keeping its Bias (R-16); the int8 and the folded float32
    Programs at RESNET_INFER_BATCH (images/s, the int8 logits' relative
    L2 distance from the float32 logits within QUANT_INT8_L2);
    QUANT_PROFILED_REPLAYS profiled int8 replays (int8 GEMMs only, one a
    quantized op a replay: no convolution, no float GEMM); the
    card's int8 logits against the CPU's on QUANT_CPU_IMAGES images; the
    int8 weights' bytes a quarter of the float32 weights'; the Program
    saved, loaded back and run bitwise, its weights still int8, and once
    with ``aot=True`` on a small int8 Program (quant_aot)."""
    import shutil
    import tempfile

    from paddle_tpu_torch.contrib.quantize import Int8InferenceTranspiler

    t = {"start": time.perf_counter()}
    x, y = resnet_images(np.random.RandomState(SEED + 173),
                         RESNET_INFER_BATCH)
    feed = {"data": torch.as_tensor(x, device=dev),
            "label": torch.as_tensor(y, device=dev)}
    exe = fluid.Executor(device=dev)
    torch.cuda.empty_cache()
    # the statistics of the first RESNET_BATCH images (a training step's
    # memory at the training batch)
    resnet_bn_stats(torch, fluid, exe, m, scope,
                    {k: v[:RESNET_BATCH] for k, v in feed.items()},
                    np.random.RandomState(SEED + 174))
    test = m["test"]
    (logits,) = [op.inputs["X"][0] for op in test.global_block().ops
                 if op.type == "softmax"]
    fprog, fscope = test.clone(), copy_scope(fluid, scope, names)
    fluid.InferenceTranspiler().transpile(fprog, scope=fscope)
    qprog, qscope = test.clone(), copy_scope(fluid, scope, names)
    fluid.InferenceTranspiler().transpile(qprog, scope=qscope)
    folded = {op.outputs["Output"][0] for op in qprog.global_block().ops
              if op.type == "conv2d" and op.inputs.get("Bias")}
    t0 = time.perf_counter()
    Int8InferenceTranspiler().transpile(qprog, qscope)
    int8_s = time.perf_counter() - t0
    t["transpiled"] = time.perf_counter()
    ops = qprog.global_block().ops
    qops = [op for op in ops if op.type.startswith("quantized_")]
    check(not any(op.type in ("conv2d", "mul") for op in ops) and qops,
          "a conv2d or mul left in float")
    kept = {op.outputs["Output"][0] for op in qops
            if op.type == "quantized_conv2d" and op.inputs.get("Bias")}
    check(kept == folded and folded, "a folded conv lost its Bias (R-16)",
          len(kept), len(folded))
    replaced = [op.inputs["QWeight"][0][:-len(".int8")] for op in qops]
    int8_bytes = sum(qscope[w + ".int8"].numel() for w in replaced)
    f32_bytes = sum(qscope[w].numel() * qscope[w].element_size()
                    for w in replaced)
    check(all(qscope[w + ".int8"].dtype == torch.int8 for w in replaced)
          and 4 * int8_bytes == f32_bytes, "int8 weight storage",
          int8_bytes, f32_bytes)
    f32_ips, f32_logits = images_per_s(exe, fprog, feed, [logits], fscope)
    int8_ips, int8_logits = images_per_s(exe, qprog, feed, [logits], qscope)
    t["timed"] = time.perf_counter()
    check(np.isfinite(int8_logits).all() and int8_logits.shape == (
        RESNET_INFER_BATCH, RESNET_CFG["class_dim"]), "int8 logits")
    rel_l2 = float(np.linalg.norm(int8_logits - f32_logits)
                   / np.linalg.norm(f32_logits))
    log("quant: int8 logits %.6g in relative L2 from the folded float32 "
        "logits (limit %g)" % (rel_l2, QUANT_INT8_L2))
    check(rel_l2 <= QUANT_INT8_L2, "int8 logits against float32", rel_l2)
    check(any(b.program is qprog and b.graph is not None
              for b in exe._bound.values()), "no int8 graph to profile")
    replays = QUANT_PROFILED_REPLAYS
    kinds = gemm_kinds(kernel_counts(torch, lambda: exe.run(
        qprog, feed=feed, fetch_list=[logits], scope=qscope), replays))
    log("quant: kernels of %d int8 replays: %s"
        % (replays, json.dumps(kinds)))
    int8_launches = sum(c for c, _ in kinds["int8_gemm"].values())
    check(not kinds["conv"] and not kinds["float_gemm"]
          and int8_launches >= (replays - 1) * len(qops),
          "the int8 replays ran float convolutions or GEMMs", kinds)
    # the card against the CPU on a few images
    small = {"data": feed["data"][:QUANT_CPU_IMAGES],
             "label": feed["label"][:QUANT_CPU_IMAGES]}
    card = np.asarray(exe.run(qprog, feed=small, fetch_list=[logits],
                              scope=qscope, use_program_cache=False)[0])
    cpu_scope = fluid.Scope()
    for n in qprog.persistable_names():
        if n in qscope:
            cpu_scope[n] = qscope[n].detach().cpu()
    t0 = time.perf_counter()
    cpu = np.asarray(fluid.Executor(fluid.CPUPlace()).run(
        qprog, feed={k: v.cpu() for k, v in small.items()},
        fetch_list=[logits], scope=cpu_scope)[0])
    cpu_s = time.perf_counter() - t0
    t["card_vs_cpu"] = time.perf_counter()
    del cpu_scope
    cpu_diff = float(np.abs(card - cpu).max())
    cpu_max = float(np.abs(cpu).max())
    check(cpu_diff <= QUANT_CPU_OF_MAX * cpu_max,
          "int8 logits, card against CPU", cpu_diff, cpu_max)
    # saved and loaded back; once with the torch.export artifact
    tmp = tempfile.mkdtemp(prefix="int8_")
    try:
        with fluid.scope_guard(qscope):
            fluid.io.save_inference_model(tmp, ["data"], [logits], exe,
                                          main_program=qprog)
        lscope = fluid.Scope()
        with fluid.scope_guard(lscope):
            prog2, feeds2, fetch2 = fluid.io.load_inference_model(tmp, exe)
        loaded = np.asarray(exe.run(prog2, feed={"data": feed["data"]},
                                    fetch_list=fetch2, scope=lscope)[0])
        check(loaded.tobytes() == int8_logits.tobytes()
              and all(lscope[w + ".int8"].dtype == torch.int8
                      for w in replaced),
              "the loaded int8 model", float(np.abs(loaded - int8_logits)
                                             .max()))
        t["saved_and_loaded"] = time.perf_counter()
        aot = quant_aot(torch, fluid, dev, tmp)
        t["aot"] = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stats = {
        "batch": RESNET_INFER_BATCH, "quantized_ops": len(qops),
        "quantized_convs_with_bias": len(kept), "int8_transpile_s": int8_s,
        "int8_weight_bytes": int8_bytes, "f32_weight_bytes": f32_bytes,
        "logits_rel_l2": rel_l2, "logits_rel_l2_limit": QUANT_INT8_L2,
        "argmax_agree": float(np.mean(int8_logits.argmax(1)
                                      == f32_logits.argmax(1))),
        "images_per_s_int8": int8_ips, "images_per_s_f32_folded": f32_ips,
        "profiled_replays": replays, "int8_gemm_launches": int8_launches,
        "int8_gemm_ms_per_replay": sum(
            ms for _, ms in kinds["int8_gemm"].values()) / replays,
        "int8_gemm_kernels": kinds["int8_gemm"],
        "other_ms_per_replay": sum(
            ms for _, ms in kinds["other"].values()) / replays,
        "card_vs_cpu": {"images": QUANT_CPU_IMAGES, "max_abs": cpu_diff,
                        "of_max": cpu_diff / cpu_max,
                        "bitwise": card.tobytes() == cpu.tobytes(),
                        "cpu_s": cpu_s},
        "saved_and_loaded_bitwise": True, "aot": aot,
        "seconds": dict(zip(list(t)[1:], np.diff(list(t.values())).tolist()))}
    if resnet_f32 is not None:
        stats["images_per_s_f32_folded_at_%d" % RESNET_BATCH] = \
            resnet_f32["infer"]["images_per_s_folded"]
    if resnet_bf16 is not None:
        stats["images_per_s_bf16_folded"] = \
            resnet_bf16["infer"]["images_per_s_folded"]
    return stats


def quant_aot(torch, fluid, dev, tmp):
    """The int8 Program through ``save_inference_model(aot=True)``: the
    reference test's net (a 3x3 conv, a pool, two fc; its own seeded
    state) at 256 images of 3 x 16 x 16, transpiled by
    ``Int8InferenceTranspiler``; the exported graph's logits at 256 and
    at 5 images (a symbolic batch; the fc's rows padded past
    ``torch._int_mm``'s 16) bitwise the Program's.  Any failure of the
    export, the load or the comparison fails the run.  ResNet-50's int8
    Program is not exported here: its ``torch.export`` trace takes too
    long for the script's time limit."""
    from paddle_tpu_torch.contrib.quantize import Int8InferenceTranspiler

    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED + 176
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16],
                                dtype="float32")
        h = fluid.layers.conv2d(img, num_filters=8, filter_size=3,
                                act="relu")
        h = fluid.layers.pool2d(h, pool_size=2, pool_stride=2)
        h = fluid.layers.fc(h, size=32, act="relu")
        out = fluid.layers.fc(h, size=10)
    test = main.clone(for_test=True)
    exe, scope = fluid.Executor(device=dev), fluid.Scope()
    exe.run(startup, scope=scope)
    Int8InferenceTranspiler().transpile(test, scope)
    x = torch.as_tensor(np.random.RandomState(SEED + 177).randn(
        256, 3, 16, 16).astype(np.float32), device=dev)
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(tmp + "/aot", ["img"], [out], exe,
                                      main_program=test, aot=True)
    save_s = time.perf_counter() - t0
    predict, _, _ = fluid.io.load_aot_inference_model(tmp + "/aot",
                                                      device=dev)
    bitwise = {}
    for n in (256, 5):
        want = np.asarray(exe.run(test, feed={"img": x[:n]},
                                  fetch_list=[out], scope=scope)[0])
        got = np.asarray(predict({"img": x[:n]})[0])
        check(got.shape == want.shape, "the int8 AOT artifact's shape", n,
              got.shape, want.shape)
        bitwise[n] = got.tobytes() == want.tobytes()
        check(bitwise[n], "the int8 AOT artifact against the Program", n,
              float(np.abs(got - want).max()))
    return {"exported": True, "save_s": save_s,
            "bitwise_at_256_and_5": bitwise}


def quant_eval_program(fluid, kind):
    """A small seeded evaluator Program (``evaluator.ChunkEvaluator``,
    ``EditDistance`` or ``DetectionMAP``) and its two dense batches."""
    rng = np.random.RandomState(SEED + 175)
    if kind == "chunk":
        batches = []
        for _ in range(2):
            lab = rng.randint(0, 7, (16, 32)).astype(np.int64)
            inf = np.where(rng.rand(16, 32) < 0.3,
                           rng.randint(0, 7, (16, 32)), lab).astype(np.int64)
            batches.append({"i": inf, "l": lab})
    elif kind == "edit_distance":
        batches = [{"h": rng.randint(0, 5, (16, 24)).astype(np.int64),
                    "r": rng.randint(0, 5, (16, 24)).astype(np.int64)}
                   for _ in range(2)]
    else:
        batches = []
        for _ in range(2):
            det = np.full((8, 16, 6), -1.0, np.float32)
            det[:, :12, 0] = rng.randint(1, 4, (8, 12))
            det[:, :12, 1] = rng.rand(8, 12)
            det[:, :12, 2:4] = rng.rand(8, 12, 2)
            det[:, :12, 4:] = det[:, :12, 2:4] + rng.rand(8, 12, 2)
            gtb = (np.concatenate([det[:, :4, 2:4], det[:, :4, 4:]], axis=2)
                   + rng.uniform(-0.1, 0.1, (8, 4, 4))).astype(np.float32)
            batches.append({"d": det, "gb": gtb, "gl": rng.randint(
                1, 4, (8, 4)).astype(np.int64)})
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        v = {n: fluid.layers.data(name=n, shape=list(a.shape[1:]),
                                  dtype=str(a.dtype),
                                  lod_level=0 if kind == "detection_map"
                                  or n == "d" else 1)
             for n, a in batches[0].items()}
        if kind == "chunk":
            ev = fluid.evaluator.ChunkEvaluator(
                v["i"], v["l"], chunk_scheme="IOB", num_chunk_types=3)
        elif kind == "edit_distance":
            ev = fluid.evaluator.EditDistance(v["h"], v["r"])
        else:
            ev = fluid.evaluator.DetectionMAP(v["d"], v["gl"], v["gb"],
                                              class_num=4,
                                              state_capacity=64)
    return main, startup, ev, batches


def quant_evaluators(torch, fluid, dev):
    """Q4: each evaluator for two passes of its two batches (fed dense,
    so the step binds) with a ``reset`` between them, on the card and on
    the CPU: each pass's ``eval`` the CPU's (within QUANT_EVAL_RTOL), and
    ``reset`` causing no new capture on the card."""
    from paddle_tpu_torch import executor as executor_mod

    out = {}
    for kind in ("chunk", "edit_distance", "detection_map"):
        res = {}
        for where in ("card", "cpu"):
            main, startup, ev, batches = quant_eval_program(fluid, kind)
            scope = fluid.Scope()
            evals, captures = [], []
            with fluid.scope_guard(scope):
                exe = (fluid.Executor(device=dev) if where == "card"
                       else fluid.Executor(fluid.CPUPlace()))
                exe.run(startup)
                for p in range(2):
                    c0 = executor_mod.compile_count()
                    if p:
                        ev.reset(exe)
                    for _ in range(2):
                        for b in batches:
                            last = exe.run(main, feed=b,
                                           fetch_list=ev.metrics)
                    captures.append(executor_mod.compile_count() - c0)
                    # DetectionMAP's eval is its accumulated mAP, fetched
                    evals.append(
                        [float(np.asarray(e).reshape(-1)[0])
                         for e in ev.eval(exe)] if kind != "detection_map"
                        else [float(np.asarray(last[1]).reshape(-1)[0])])
            res[where] = {"evals": evals, "captures": captures}
        err = max(abs(a - b) / max(abs(b), 1e-30)
                  for pa, pb in zip(res["card"]["evals"], res["cpu"]["evals"])
                  for a, b in zip(pa, pb))
        check(err <= QUANT_EVAL_RTOL and res["card"]["captures"] == [1, 0],
              "evaluator on the card", kind, res)
        out[kind] = dict(res["card"], cpu_evals=res["cpu"]["evals"],
                         max_rel_err=err)
    return out


def quant_phase(torch, fluid, fa, dev, resnet_f32=None, resnet_bf16=None):
    """ResNet-50 quantized at full width (ROADMAP A12.1): Q1 the quantized
    ops on the card against the CPU (quant_ops_check) and
    ``torch._int_mm``'s shape limits (quant_int_mm_limits), Q2 quantize-aware
    training (quant_train), Q3 int8 inference (quant_infer), Q4 the
    evaluators (quant_evaluators).  ``resnet_f32`` and ``resnet_bf16``
    are the ResNet phases' results, whose inference figures are logged
    beside.  No kernel of this repo runs: B1-B5 launch 0 times."""
    from paddle_tpu_torch.models import resnet

    resident = resident_gib(torch, dev)
    fa.reset_launch_counts()
    t = [time.perf_counter()]
    out = {"card": card_line(), "ops": quant_ops_check(torch, fluid, dev),
           "int_mm_limits": quant_int_mm_limits(torch, dev)}
    t.append(time.perf_counter())
    out["train"], m, scope, names = quant_train(torch, fluid, resnet, dev)
    t.append(time.perf_counter())
    out["infer"] = quant_infer(torch, fluid, dev, m, scope, names,
                               resnet_f32, resnet_bf16)
    del m, scope
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    out["evaluators"] = quant_evaluators(torch, fluid, dev)
    t.append(time.perf_counter())
    launches = dict(fa.KERNEL_LAUNCHES)
    check(not any(launches.values()), "a kernel launched in the quant phase",
          launches)
    out["launches"] = launches
    out["resident_gib_before"] = resident
    out["seconds"] = dict(zip(("ops", "train", "infer", "evaluators"),
                              np.diff(t).tolist()))
    log("quant phase: %s" % json.dumps(out, default=str))
    return out


def _u(seed, shape, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape)


def _f64(rows):
    return np.array(rows, np.float64)


def op_cases():
    """The cases of tests/test_torch_{math,tensor,nn}_ops.py in float64
    (the integer ones in their own types): dicts of the op, its feeds (name ->
    array), input and output slots, attrs, output dtypes, the feeds the
    gradient of mean(first output) is taken for, and the exact gradient
    values a tie case must give (index into the gradient -> value)."""
    cases = []

    def add(label, op, feeds, inputs=None, outputs=None, attrs=None,
            dtypes=None, wrt=None, ties=None):
        if inputs is None:
            inputs = {k.upper() if len(k) == 1 else k: [k] for k in feeds}
        cases.append(dict(label=label, op=op, feeds=feeds, inputs=inputs,
                          outputs=outputs or {"Out": 1}, attrs=attrs or {},
                          dtypes=dtypes or {}, wrt=wrt, ties=ties or {}))

    ties = _f64([[-1.0, 0.0, 3.0, 6.0], [6.5, 0.0, 6.0, -0.5]])
    acts = {
        "relu6": ({"threshold": 6.0}, ties),
        "leaky_relu": ({"alpha": 0.1}, _f64([[0.0, -1.0, 2.0, -0.0]])),
        "elu": ({"alpha": 0.5}, (-3.0, 3.0)),
        "elu large": ({"alpha": 1.0}, _f64([[0.0, 50.0, -50.0, 100.0]])),
        "brelu": ({"t_min": 1.0, "t_max": 4.0}, _f64([[1.0, 4.0, 0.5, 5.0, 2.0]])),
        "soft_relu": ({"threshold": 2.0}, _f64([[2.0, -2.0, 0.5, 3.0]])),
        "sigmoid": ({}, (-6.0, 6.0)), "logsigmoid": ({}, (-6.0, 6.0)),
        "tanh": ({}, (-3.0, 3.0)), "tanh_shrink": ({}, (-3.0, 3.0)),
        "stanh": ({"scale_a": 0.67, "scale_b": 1.7159}, (-3.0, 3.0)),
        "hard_sigmoid": ({"slope": 0.25, "offset": 0.5},
                         _f64([[-2.0, 2.0, 0.0, -3.0, 3.0]])),
        "swish": ({"beta": 1.5}, (-4.0, 4.0)),
        "softplus": ({}, _f64([[0.0, 30.0, -30.0, 1.0]])),
        "softsign": ({}, (-3.0, 3.0)),
        "softshrink": ({"lambda": 0.5}, _f64([[0.5, -0.5, 0.2, 1.5, -2.0]])),
        "hard_shrink": ({"threshold": 0.5}, _f64([[0.5, -0.5, 0.2, 1.5, -2.0]])),
        "thresholded_relu": ({"threshold": 1.0}, _f64([[1.0, 0.5, 2.0, -1.0]])),
        "abs": ({}, _f64([[0.0, -1.5, 2.0, -0.0]])),
        "ceil": ({}, (-3.0, 3.0)), "floor": ({}, (-3.0, 3.0)),
        "cos": ({}, (-3.0, 3.0)), "sin": ({}, (-3.0, 3.0)),
        "round": ({}, _f64([[0.5, 1.5, 2.5, -0.5, -1.5, 0.49]])),
        "reciprocal": ({}, (0.5, 3.0)), "exp": ({}, (-3.0, 3.0)),
        "sqrt": ({}, (0.1, 4.0)), "rsqrt": ({}, (0.1, 4.0)),
        "selu": ({}, (-3.0, 3.0)), "sign": ({}, _f64([[0.0, -2.0, 3.0, -0.0]])),
    }
    for i, (label, (attrs, x)) in enumerate(acts.items()):
        op = label.split()[0]
        if isinstance(x, tuple):
            x = _u(i, (3, 5), *x)
        tie = {}
        if op == "relu6":
            tie = {(0, 1): 0.5 / 8, (0, 3): 0.5 / 8, (1, 1): 0.5 / 8,
                   (1, 2): 0.5 / 8}
        elif op == "brelu":
            tie = {(0, 0): 0.5 / 5, (0, 1): 0.5 / 5}
        elif op == "hard_sigmoid":
            tie = {(0, 0): 0.125 / 5, (0, 1): 0.125 / 5}
        elif op in ("leaky_relu", "abs"):
            tie = {(0, 0): 0.25, (0, 3): 0.25}
        add(label, op, {"x": x}, attrs=attrs, ties=tie)
    rng = np.random.RandomState(3)
    xi = rng.randint(-20, 20, (4, 5)).astype(np.int32)
    yi = rng.choice([-7, -3, -2, 2, 3, 7], (4, 5)).astype(np.int32)
    xf = rng.uniform(-9, 9, (4, 5))
    yf = rng.choice([-2.5, -1.5, 1.5, 2.5], (4, 5)).astype(np.float64)
    ymax = _f64([[0.0, 0.0, 3.0, 5.0], [7.0, 1.0, 6.0, -0.5]])
    add("elementwise_max ties", "elementwise_max", {"x": ties, "y": ymax},
        attrs={"axis": -1}, wrt=["x", "y"],
        ties={(0, 1): 0.5 / 8, (0, 2): 0.5 / 8, (1, 2): 0.5 / 8,
              (1, 3): 0.5 / 8})
    add("elementwise_max axis", "elementwise_max",
        {"x": _u(4, (2, 3, 4)), "y": _u(5, (3,))}, attrs={"axis": 1},
        wrt=["x", "y"])
    add("elementwise_pow", "elementwise_pow",
        {"x": _u(6, (3, 4), 0.5, 2.0), "y": _u(7, (3, 4))}, wrt=["x", "y"])
    add("elementwise_pow int32", "elementwise_pow",
        {"x": np.arange(-6, 6).reshape(3, 4).astype(np.int32),
         "y": np.tile(np.array([0, 1, 2, 3], np.int32), (3, 1))}, wrt=[])
    for op in ("elementwise_mod", "elementwise_floordiv"):
        add(op, op, {"x": xf, "y": yf}, wrt=["x", "y"])
        add(op + " int32", op, {"x": xi, "y": yi}, wrt=[])
    tied = _f64([[[1.0, 3.0, 3.0], [2.0, 2.0, -1.0]],
                 [[0.0, 0.0, 0.0], [5.0, 4.0, 5.0]]])
    pos = np.random.RandomState(9).uniform(0.5, 1.5, (2, 3, 4))
    zero = pos.copy()
    zero[1, 2, 3] = 0.0
    ints = np.random.RandomState(9).randint(-7, 8, (4, 5, 3)).astype(np.int32)
    big = np.random.RandomState(9).randint(200, 2000, (3, 6)).astype(np.int32)
    for label, op, dim, keep, red_all, x, tie in (
            ("reduce_max ties", "reduce_max", [-1], False, False, tied,
             {(0, 0, 1): 0.5 / 4, (0, 0, 2): 0.5 / 4}),
            ("reduce_max all", "reduce_max", None, False, True, tied, {}),
            ("reduce_min ties", "reduce_min", [1], True, False, tied, {}),
            ("reduce_min two dims", "reduce_min", [0, 2], False, False, tied, {}),
            ("reduce_mean", "reduce_mean", [1], False, False, pos, {}),
            ("reduce_mean all", "reduce_mean", None, True, True, pos, {}),
            ("reduce_prod", "reduce_prod", [0], False, False, pos, {}),
            ("reduce_prod zero", "reduce_prod", [0, 2], True, False, zero, {}),
            ("reduce_mean int32", "reduce_mean", [1], False, False, ints, {}),
            ("reduce_mean int32 all", "reduce_mean", None, False, True, ints, {}),
            ("reduce_prod int32 wraps", "reduce_prod", [1], False, False, big, {}),
            ("reduce_max int32", "reduce_max", [0], False, False, ints, {})):
        add(label, op, {"x": x}, attrs={"dim": dim, "keep_dim": keep,
                                        "reduce_all": red_all},
            dtypes={"Out": "float32"} if (op == "reduce_mean"
                                          and x.dtype == np.int32) else None,
            ties=tie)
    px = _u(11, (2, 3, 2, 2))
    px[0, 0, 0, 0] = 0.0
    for mode, alpha in (("all", _f64([0.25])), ("channel", _f64([0.1, 0.2, 0.3])),
                        ("element", _u(12, (1, 3, 2, 2), 0.0, 0.5))):
        add("prelu " + mode, "prelu", {"x": px, "alpha": alpha},
            inputs={"X": ["x"], "Alpha": ["alpha"]}, attrs={"mode": mode},
            wrt=["x", "alpha"])
    add("maxout", "maxout", {"x": _u(13, (2, 6, 3, 3))}, attrs={"groups": 2})
    mx = _u(13, (2, 6, 3, 3))
    mx[:, 1] = mx[:, 0]
    add("maxout ties", "maxout", {"x": mx}, attrs={"groups": 2},
        ties={(0, 0, 0, 0): 0.5 / 54, (0, 1, 0, 0): 0.5 / 54})
    cx = _f64([[-1.0, 1.0, 0.0, 2.0, -3.0]])
    add("clip on the bounds", "clip", {"x": cx}, attrs={"min": -1.0, "max": 1.0},
        ties={(0, 0): 0.5 / 5, (0, 1): 0.5 / 5})
    add("clip", "clip", {"x": _u(14, (3, 4))}, attrs={"min": -0.5, "max": 0.5})
    for mn in (0.5, 100.0):
        add("clip_by_norm %g" % mn, "clip_by_norm", {"x": _u(15, (4, 5))},
            attrs={"max_norm": mn})
    for rows in (4, 1):
        add("cos_sim %d" % rows, "cos_sim", {"x": _u(16, (4, 6)),
                                              "y": _u(17, (rows, 6))},
            outputs={"Out": 1, "XNorm": 1, "YNorm": 1}, wrt=["x", "y"])
    for axis in (1, -1):
        add("norm %d" % axis, "norm", {"x": _u(18, (3, 4, 5))},
            outputs={"Out": 1, "Norm": 1}, attrs={"axis": axis, "epsilon": 1e-10})
    for bias in (False, True):
        feeds = {"x": _u(19, (4, 3)), "y": _u(20, (4, 5)),
                 "w": _u(21, (2, 3, 5))}
        inputs = {"X": ["x"], "Y": ["y"], "Weight": ["w"]}
        if bias:
            feeds["b"] = _u(22, (1, 2))
            inputs["Bias"] = ["b"]
        add("bilinear_tensor_product bias %s" % bias,
            "bilinear_tensor_product", feeds, inputs=inputs, wrt=list(feeds))
    for n in (1, 3, 5):
        add("conv_shift %d" % n, "conv_shift", {"x": _u(23, (3, 7)),
                                                "y": _u(24, (3, n))},
            wrt=["x", "y"])
    # tensor ops
    add("fill_zeros_like", "fill_zeros_like", {"x": _u(1, (3, 4))}, wrt=[])
    for axis, shapes in ((0, [(2, 3), (4, 3), (1, 3)]), (1, [(2, 3), (2, 1), (2, 4)]),
                         (-1, [(2, 2, 3), (2, 2, 1), (2, 2, 2)])):
        feeds = {"x%d" % i: _u(i, sh) for i, sh in enumerate(shapes)}
        add("concat %d" % axis, "concat", feeds, inputs={"X": list(feeds)},
            attrs={"axis": axis}, wrt=list(feeds))
    for label, attrs, k in (("split num", {"num": 3, "axis": 1}, 3),
                            ("split sections", {"sections": [2, 3, 1], "axis": -1}, 3),
                            ("split sections short", {"sections": [2, 2], "axis": 1}, 2)):
        add(label, "split", {"x": _u(2, (2, 6))}, outputs={"Out": k}, attrs=attrs)
    for label, op, axes, shape in (("squeeze", "squeeze", [1], (3, 1, 4)),
                                   ("squeeze all", "squeeze", [], (1, 3, 1, 2)),
                                   ("squeeze2", "squeeze2", [-1], (3, 4, 1)),
                                   ("squeeze not one stays", "squeeze", [0, 1],
                                    (3, 1, 4))):
        add(label, op, {"x": _u(3, shape)}, attrs={"axes": axes})
    for axis in (0, 1, 2):
        add("flatten %d" % axis, "flatten", {"x": _u(4, (2, 3, 4))},
            attrs={"axis": axis})
    feeds = {"x%d" % i: _u(10 + i, (2, 3)) for i in range(3)}
    for axis in (0, 1, -1):
        add("stack %d" % axis, "stack", feeds, inputs={"X": list(feeds)},
            outputs={"Y": 1}, attrs={"axis": axis}, wrt=list(feeds))
    for axis, k in ((0, 3), (1, 2)):
        add("unstack %d" % axis, "unstack", {"x": _u(5, (3, 2, 4))},
            outputs={"Y": k}, attrs={"axis": axis})
    add("shape", "shape", {"x": _u(6, (2, 3, 4))}, inputs={"Input": ["x"]},
        dtypes={"Out": "int32"}, wrt=[])
    for label, ids in (("scatter repeated", [1, 1, 4, 1]),
                       ("scatter out of range", [1, 9, -2, -9, 6]),
                       ("scatter negative", [-1, 2, -6]),
                       ("scatter unique", [4, 0, 2])):
        ids = np.array(ids, np.int32)
        add(label, "scatter", {"x": _u(7, (6, 3)), "ids": ids,
                               "upd": _u(8, (len(ids), 3), 5.0, 9.0)},
            inputs={"X": ["x"], "Ids": ["ids"], "Updates": ["upd"]},
            wrt=["x", "upd"])
    add("pad", "pad", {"x": _u(9, (2, 3))},
        attrs={"paddings": [1, 0, 0, 2], "pad_value": 0.5})
    for mode in ("constant", "reflect", "edge"):
        add("pad2d " + mode, "pad2d", {"x": _u(10, (2, 2, 4, 5))},
            attrs={"paddings": [1, 2, 3, 0], "mode": mode, "pad_value": -1.0})
    add("pad_constant_like", "pad_constant_like",
        {"x": _u(11, (4, 5)), "y": _u(12, (2, 3))}, attrs={"pad_value": 1.5},
        wrt=["y"])
    add("crop", "crop", {"x": _u(13, (4, 6))},
        attrs={"offsets": [1, 2], "shape": [2, 3]})
    add("crop by input", "crop", {"x": _u(13, (4, 6)), "y": _u(14, (2, 3))},
        attrs={"offsets": [1, 2]}, wrt=["x"])
    for axis in ([0], [0, 2], 1):
        add("reverse %s" % axis, "reverse", {"x": _u(15, (2, 3, 4))},
            attrs={"axis": axis})
    for label, ids in (("multiplex", [[2], [0], [1], [2]]),
                       ("multiplex out of range", [[-1], [5], [-5], [1]])):
        feeds = {"x%d" % i: _u(20 + i, (4, 5)) for i in range(3)}
        feeds["ids"] = np.array(ids, np.int32)
        add(label, "multiplex", feeds,
            inputs={"X": ["x0", "x1", "x2"], "Ids": ["ids"]},
            wrt=["x0", "x1", "x2"])
    targ = _f64([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, -1.0, 2.0],
                 [5.0, 4.0, 5.0, 4.0]])
    for op, axis in (("arg_max", 0), ("arg_max", 1), ("arg_min", 0),
                     ("arg_min", -1)):
        add("%s %d" % (op, axis), op, {"x": targ}, attrs={"axis": axis},
            dtypes={"Out": "int64"}, wrt=[])
    for label, x, axis in (("argsort ties", _f64([[1, 0, 1, 0]]), -1),
                           ("argsort ties axis 0", targ, 0),
                           ("argsort random", _u(16, (3, 5)), 1),
                           ("argsort int32", np.array([[3, 1, 3, -2, 1]], np.int32), -1)):
        add(label, "argsort", {"x": x}, outputs={"Out": 1, "Indices": 1},
            attrs={"axis": axis}, dtypes={"Indices": "int64"})
    for op in ("has_inf", "has_nan", "isfinite"):
        for fill in (None, np.inf, -np.inf, np.nan):
            x = _u(17, (3, 4))
            if fill is not None:
                x[1, 2] = fill
            add("%s %s" % (op, fill), op, {"x": x}, dtypes={"Out": "bool"},
                wrt=[])
    feeds = {"x%d" % i: _u(30 + i, (3, 4)) for i in range(3)}
    for op in ("sum", "sums"):
        add(op, op, feeds, inputs={"X": list(feeds)}, wrt=list(feeds))
    for step in (0.0, 2.0, 3.0, 4.5, 9.0, 10.0, 11.0):
        add("piecewise_decay %g" % step, "piecewise_decay",
            {"step": np.array([step], np.float32)}, inputs={"Step": ["step"]},
            attrs={"boundaries": [3.0, 10.0], "values": [0.1, 0.01, 0.001]},
            wrt=[])
    nn_op_cases(add)
    return cases


def nn_op_cases(add):
    """The cases of tests/test_torch_nn_ops.py in float64 (ids and
    labels in their own types, the AUC's histograms float32 as a model
    holds them), through op_cases' ``add``."""
    def randn(seed, shape, scale=1.0):
        return np.random.RandomState(seed).randn(*shape) * scale

    convs = (
        ("conv3d", (1, 2, 4, 5, 5), (3, 2, 3, 3, 3), {"paddings": [1, 1, 1]}),
        ("conv3d stride dilation", (2, 2, 6, 7, 5), (3, 2, 2, 3, 2),
         {"strides": [2, 1, 2], "paddings": [1, 0, 1], "dilations": [2, 1, 1]}),
        ("conv3d groups", (1, 4, 4, 4, 4), (6, 2, 3, 3, 3),
         {"paddings": [1, 1, 1], "groups": 2}),
        ("conv2d_transpose", (2, 3, 5, 5), (3, 4, 3, 3), {}),
        ("conv2d_transpose stride padding", (2, 3, 5, 5), (3, 4, 3, 3),
         {"strides": [2, 2], "paddings": [1, 1]}),
        ("conv2d_transpose grads", (2, 3, 4, 4), (3, 2, 3, 3),
         {"strides": [2, 2], "paddings": [1, 1]}),
        ("conv2d_transpose groups dilation", (2, 4, 5, 4), (4, 3, 3, 2),
         {"strides": [2, 1], "paddings": [1, 0], "dilations": [2, 2],
          "groups": 2}),
        ("conv3d_transpose", (1, 2, 3, 3, 3), (2, 2, 2, 2, 2),
         {"strides": [2, 2, 2]}),
        ("conv3d_transpose padding", (1, 2, 3, 4, 3), (2, 3, 3, 3, 3),
         {"strides": [2, 1, 2], "paddings": [1, 1, 0]}),
        ("conv3d_transpose dilation ignored", (1, 2, 3, 3, 3), (2, 4, 3, 3, 3),
         {"dilations": [2, 2, 2]}),
        ("conv3d_transpose groups ignored", (1, 2, 3, 3, 3), (2, 4, 3, 3, 3),
         {"groups": 2}))
    for label, xs, ws, attrs in convs:
        add(label, label.split()[0], {"x": randn(1, xs), "w": randn(2, ws, 0.5)},
            inputs={"Input": ["x"], "Filter": ["w"]}, outputs={"Output": 1},
            attrs=attrs)
    pools = (("max", "max", 2, 2, 0, False, True, False, (1, 2, 4, 4, 4)),
             ("avg", "avg", 2, 2, 0, False, True, False, (1, 2, 4, 4, 4)),
             ("max padded", "max", 3, 2, 1, False, True, False, (2, 2, 5, 6, 5)),
             ("max ceil", "max", 3, 2, 0, True, True, False, (1, 2, 6, 6, 5)),
             ("max ceil window in padding", "max", 2, 2, 1, True, True, False,
              (1, 1, 5, 5, 5)),
             ("avg padded exclusive", "avg", 3, 2, 1, False, True, False,
              (1, 2, 5, 5, 5)),
             ("avg padded inclusive", "avg", 3, 2, 1, False, False, False,
              (1, 2, 5, 5, 5)),
             ("avg ceil exclusive", "avg", 3, 2, 0, True, True, False,
              (1, 2, 6, 6, 6)),
             ("avg ceil inclusive", "avg", 3, 2, 0, True, False, False,
              (1, 2, 6, 6, 6)),
             ("global avg", "avg", 2, 1, 0, False, True, True, (2, 3, 3, 4, 5)))
    for label, ptype, k, st, pad, ceil, excl, glob, shape in pools:
        x = (np.random.RandomState(2).permutation(int(np.prod(shape)))
             .reshape(shape) * 0.09)
        add("pool3d " + label, "pool3d", {"x": x}, attrs={
            "pooling_type": ptype, "ksize": [k] * 3, "strides": [st] * 3,
            "paddings": [pad] * 3, "ceil_mode": ceil, "exclusive": excl,
            "global_pooling": glob})
    for n, k, alpha, beta in ((5, 1.0, 1e-2, 0.75), (5, 2.0, 1e-4, 0.75),
                              (3, 1.0, 0.5, 0.5)):
        add("lrn %d %g" % (n, alpha), "lrn", {"x": _u(2, (2, 6, 4, 4), 0.0, 3.0)},
            outputs={"Out": 1, "MidOut": 1},
            attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    rng = np.random.RandomState(4)
    lr_lab = (rng.rand(5, 1) > 0.5).astype(np.float64)
    pm_lab = np.where(rng.rand(5, 1) > 0.5, 1.0, -1.0)
    xy = {"X": ["x"], "Y": ["y"]}
    add("smooth_l1_loss", "smooth_l1_loss",
        {"x": randn(1, (4, 6), 2), "y": randn(2, (4, 6), 2)}, inputs=xy,
        outputs={"Out": 1, "Diff": 1}, attrs={"sigma": 1.0}, wrt=["x", "y"])
    add("smooth_l1_loss weights sigma", "smooth_l1_loss",
        {"x": randn(8, (4, 3)), "y": randn(9, (4, 3)),
         "iw": _u(10, (4, 3), 0.5, 1.5), "ow": _u(11, (4, 3), 0.5, 1.5)},
        inputs={"X": ["x"], "Y": ["y"], "InsideWeight": ["iw"],
                "OutsideWeight": ["ow"]},
        outputs={"Out": 1, "Diff": 1}, attrs={"sigma": 2.0}, wrt=["x", "y"])
    add("dice_loss", "dice_loss", {"x": _u(2, (4, 5), 0.0, 1.0),
                                   "label": (_u(3, (4, 5), 0.0, 1.0) > 0.5)
                                   .astype(np.float64)},
        inputs={"X": ["x"], "Label": ["label"]}, attrs={"epsilon": 1e-5},
        wrt=["x"])
    rank = {"Label": ["label"], "Left": ["left"], "Right": ["right"]}
    add("rank_loss", "rank_loss", {"label": lr_lab, "left": randn(3, (5, 1)),
                                   "right": randn(5, (5, 1))},
        inputs=rank, wrt=["left", "right"])
    # exp(800) overflows float64 as exp(100) does float32
    add("rank_loss overflow", "rank_loss",
        {"label": _f64([[1.0], [0.0], [1.0]]),
         "left": _f64([[800.0], [1.0], [-3.0]]),
         "right": _f64([[0.0], [0.5], [2.0]])}, inputs=rank, wrt=[])
    margin = {"Label": ["label"], "X1": ["x1"], "X2": ["x2"]}
    add("margin_rank_loss", "margin_rank_loss",
        {"label": pm_lab, "x1": randn(6, (5, 1)), "x2": randn(7, (5, 1))},
        inputs=margin, attrs={"margin": 0.3}, wrt=["x1", "x2"])
    add("margin_rank_loss tie", "margin_rank_loss",
        {"label": _f64([[1.0], [-1.0], [-1.0], [1.0]]),
         "x1": _f64([[0.5], [0.0], [0.0], [2.0]]),
         "x2": _f64([[0.25], [1.0], [0.25], [0.0]])},
        inputs=margin, attrs={"margin": 0.25}, wrt=["x1", "x2"],
        ties={(0, 0): -0.5 / 4, (2, 0): 0.5 / 4})
    add("huber_loss", "huber_loss", {"x": randn(0, (6, 3)),
                                     "y": randn(0, (6, 3)) + randn(1, (6, 3), 2)},
        inputs=xy, outputs={"Out": 1, "Residual": 1}, attrs={"delta": 1.0},
        wrt=["x", "y"])
    add("huber_loss bounds", "huber_loss", {"x": _f64([[0.0, 1.0, -2.0, 3.0]]),
                                            "y": _f64([[1.0, 1.0, -2.5, 1.0]])},
        inputs=xy, outputs={"Out": 1, "Residual": 1}, attrs={"delta": 1.0},
        wrt=["x", "y"])
    add("log_loss", "log_loss",
        {"p": _u(1, (8, 1), 0.05, 0.95),
         "label": np.random.RandomState(1).randint(0, 2, (8, 1)).astype(np.float64)},
        inputs={"Predicted": ["p"], "Labels": ["label"]}, outputs={"Loss": 1},
        attrs={"epsilon": 1e-4}, wrt=["p"])
    sce = {"X": ["x"], "Label": ["label"]}
    add("sigmoid_cross_entropy_with_logits", "sigmoid_cross_entropy_with_logits",
        {"x": randn(2, (5, 4), 3), "label": _u(2, (5, 4), 0.0, 1.0)},
        inputs=sce, attrs={"ignore_index": -100}, wrt=["x", "label"])
    add("sigmoid_cross_entropy_with_logits ignore",
        "sigmoid_cross_entropy_with_logits",
        {"x": _f64([[1.0, -2.0, 3.0]]), "label": _f64([[1.0, -100.0, 0.0]])},
        inputs=sce, attrs={"ignore_index": -100}, wrt=["x"])
    add("sigmoid_cross_entropy_with_logits zero logit",
        "sigmoid_cross_entropy_with_logits",
        {"x": _f64([[0.0, 0.0, -0.0, 2.0]]), "label": _f64([[0.0, 1.0, 0.0, 0.5]])},
        inputs=sce, attrs={"ignore_index": -100}, wrt=["x"],
        ties={(0, 0): 0.0, (0, 2): 0.0, (0, 1): -1.0 / 4})
    auc_out = {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1}
    for label, seed, rows, cols, thresholds, scores in (
            ("auc rank formula", 1, 64, 2, 4095, None),
            ("auc few thresholds", 2, 40, 2, 7, None),
            ("auc one column", 3, 32, 1, 63, None),
            ("auc edges", 4, 6, 2, 3, _f64([[0, 0.25], [0, 0.5], [0, 1.0],
                                            [0, 1.5], [0, -0.2], [0, np.nan]]))):
        r = np.random.RandomState(seed)
        stat = r.randint(0, 3, (2, thresholds + 1)).astype(np.float32)
        p = r.rand(rows, cols) if scores is None else scores
        add(label, "auc", {"p": p, "label": r.randint(0, 2, (rows, 1)),
                           "sp": stat[0], "sn": stat[1]},
            inputs={"Predict": ["p"], "Label": ["label"], "StatPos": ["sp"],
                    "StatNeg": ["sn"]}, outputs=auc_out,
            attrs={"num_thresholds": thresholds},
            dtypes={k: "float32" for k in auc_out}, wrt=[])
    miou_types = {"OutMeanIou": "float32", "OutWrong": "int32",
                  "OutCorrect": "int32"}
    for label, pred, lab, n in (
            ("mean_iou", np.array([[0, 1, 2, 1], [2, 2, 0, 1]]),
             np.array([[0, 1, 1, 1], [2, 0, 0, 2]]), 3),
            ("mean_iou random", np.random.RandomState(6).randint(0, 5, (4, 9)),
             np.random.RandomState(7).randint(0, 5, (4, 9)), 5),
            ("mean_iou ids out of range", np.array([1, 1, 1, 1, 0, 0]),
             np.array([0, 4, -1, -5, 1, 1]), 2)):
        add(label, "mean_iou", {"pred": pred.astype(np.int64),
                                "label": lab.astype(np.int64)},
            inputs={"Predictions": ["pred"], "Labels": ["label"]},
            outputs={"OutMeanIou": 1, "OutWrong": 1, "OutCorrect": 1},
            attrs={"num_classes": n}, dtypes=miou_types, wrt=[])
    for label, shape, k, st, pad in (
            ("im2sequence", (1, 2, 4, 4), [2, 2], [2, 2], [0, 0, 0, 0]),
            ("im2sequence overlapping", (2, 3, 5, 4), [3, 2], [1, 1], [0, 0, 0, 0]),
            ("im2sequence asymmetric paddings", (2, 2, 5, 6), [2, 3], [1, 2],
             [1, 0, 2, 1])):
        add(label, "im2sequence", {"x": randn(1, shape)},
            attrs={"kernels": k, "strides": st, "paddings": pad})
    for label, op, shape, oh, ow in (
            ("bilinear up", "bilinear_interp", (2, 3, 4, 4), 8, 6),
            ("bilinear down 8 to 4", "bilinear_interp", (2, 3, 8, 8), 4, 4),
            ("bilinear down 8 to 5x7", "bilinear_interp", (2, 3, 8, 8), 5, 7),
            ("bilinear up and down", "bilinear_interp", (1, 2, 6, 9), 10, 4),
            ("nearest down", "nearest_interp", (1, 2, 4, 4), 2, 2),
            ("nearest up", "nearest_interp", (2, 3, 4, 5), 8, 10),
            ("nearest 8 to 5x7", "nearest_interp", (2, 3, 8, 8), 5, 7)):
        add(label, op, {"x": randn(1, shape)}, attrs={"out_h": oh, "out_w": ow})
    x = randn(0, (1, 3, 8, 8))
    rois = _f64([[0, 0, 7, 7], [2, 2, 10, 10], [4, 0, 6, 3]])
    distinct = np.random.RandomState(1).permutation(3 * 8 * 8).reshape(
        1, 3, 8, 8) * 0.1
    tied = np.floor(_u(2, (1, 2, 6, 6), 0.0, 2.0))
    # the tie case's one ROI covers 2 x 3 cells of 3 x 2 pixels: each of a
    # cell's k tied maxima takes (1 / 12) / k, the mean's share split by
    # amax's backward
    shares = {}
    for c in range(2):
        for i in range(2):
            for j in range(3):
                cell = tied[0, c, 3 * i:3 * i + 3, 2 * j:2 * j + 2]
                top = np.argwhere(cell == cell.max())
                for a, b in top:
                    shares[(0, c, 3 * i + a, 2 * j + b)] = (1.0 / 12) / len(top)
    roi_in = {"X": ["x"], "ROIs": ["rois"]}
    for label, feeds, ph, pw, scale, tie in (
            ("roi_pool", {"x": x, "rois": rois}, 2, 2, 0.5, {}),
            ("roi_pool grad", {"x": distinct, "rois": rois[:2]}, 2, 2, 0.5, {}),
            ("roi_pool ties", {"x": tied, "rois": _f64([[0, 0, 5, 5]])}, 2, 3,
             1.0, shares),
            ("roi_pool empty cells", {"x": x, "rois": _f64(
                [[0, 0, 3, 3], [10, 10, 14, 14], [5, 6, 7, 8]])}, 4, 2, 1.0, {})):
        add(label, "roi_pool", feeds, inputs=roi_in,
            attrs={"pooled_height": ph, "pooled_width": pw,
                   "spatial_scale": scale}, wrt=["x"], ties=tie)


def op_case_run(fluid, case, dev):
    """The case's one-op Program on ``dev``: its fetches as numpy, the
    outputs first, then the gradients of mean(first output) with respect
    to ``wrt`` (every float feed by default)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        vs = {n: fluid.layers.data(name=n, shape=list(a.shape),
                                   dtype=str(a.dtype), append_batch_size=False,
                                   stop_gradient=a.dtype.kind != "f")
              for n, a in case["feeds"].items()}
        helper = LayerHelper(case["op"])
        first = vs[next(iter(case["inputs"].values()))[0]]
        outs = {s: [helper.create_variable_for_type_inference(
            dtype=case["dtypes"].get(s, first.dtype)) for _ in range(k)]
            for s, k in case["outputs"].items()}
        helper.append_op(type=case["op"], inputs={
            s: [vs[n] for n in ns] for s, ns in case["inputs"].items()},
            outputs=outs, attrs=case["attrs"])
        fetch = [v for vl in outs.values() for v in vl]
        wrt = case["wrt"]
        if wrt is None:
            wrt = [n for n, a in case["feeds"].items() if a.dtype.kind == "f"]
        if wrt:
            fetch += fluid.backward.calc_gradient(
                fluid.layers.mean(fetch[0]), [vs[n] for n in wrt])
    out = fluid.Executor(device=dev).run(main, feed=case["feeds"],
                                         fetch_list=fetch, scope=fluid.Scope())
    return [np.asarray(o) for o in out]


def scatter_want(x, ids, upd):
    """The JAX package's ``x.at[ids].set(upd)`` in numpy: an id in
    [-n, 0) wraps, one outside [-n, n) is dropped, the last of repeated
    ids wins."""
    out = x.copy()
    n = len(x)
    for i, r in enumerate(ids):
        if -n <= r < n:
            out[r % n] = upd[i]
    return out


def multiplex_want(xs, ids):
    """The JAX package's ``xs[ids, rows]``: an id in [-k, 0) wraps, any
    other outside [0, k) is clamped."""
    k = len(xs)
    ids = np.where(ids < 0, ids + k, ids).clip(0, k - 1)
    return np.stack([xs[i][r] for r, i in enumerate(ids)])


def rng_program(fluid, rows):
    """A Program holding the four random ops (truncated normal, uniform
    batch-size-like, sampling_id, random_crop), its feed (``rows`` rows
    of probabilities) and fetches."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = SEED + 70
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ref = fluid.layers.data(name="ref", shape=[3], dtype="float32")
        probs = fluid.layers.data(name="p", shape=[5], dtype="float32")
        img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        helper = LayerHelper("truncated_gaussian_random")
        tg = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(type="truncated_gaussian_random", outputs={"Out": [tg]},
                         attrs={"shape": [100_000], "mean": 0.5, "std": 2.0,
                                "dtype": "float32", "seed": 0})
        uni = fluid.layers.uniform_random_batch_size_like(
            ref, shape=[-1, 20_000], min=-2.0, max=3.0)
        ids = fluid.layers.sampling_id(probs)
        crop = fluid.layers.random_crop(img, shape=[5, 6])
    feed = {"ref": np.zeros((7, 3), np.float32),
            "p": np.tile(np.array([0.1, 0.2, 0.3, 0.4, 0.0], np.float32),
                         (rows, 1)),
            "img": np.arange(4 * 3 * 8 * 8, dtype=np.float32).reshape(4, 3, 8, 8)}
    return main, feed, [tg, uni, ids, crop]


def rng_limits(out, feed):
    """The random ops' draws against their distributions: each sample
    mean within 5 standard errors, each variance within 5 of its own,
    every value in range; the crop one window of the image.  Returns
    the measures."""
    tg, uni, ids, crop = out
    n, mean, std = tg.size, 0.5, 2.0
    var1 = 1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi) / math.erf(
        2 / math.sqrt(2))
    tg_ok = (tg.min() > mean - 2 * std and tg.max() < mean + 2 * std
             and abs(tg.mean() - mean) < 5 * std * math.sqrt(var1 / n)
             and abs(tg.var() / std ** 2 - var1) < 5 * math.sqrt(2 / n))
    lo, hi = -2.0, 3.0
    var_u = (hi - lo) ** 2 / 12
    uni_ok = (uni.shape == (7, 20_000) and uni.min() >= lo and uni.max() < hi
              and abs(uni.mean() - (lo + hi) / 2) < 5 * math.sqrt(var_u / uni.size)
              and abs(uni.var() - var_u) < 5 * math.sqrt(0.8 * var_u ** 2 / uni.size))
    p = feed["p"][0]
    freq = np.bincount(ids, minlength=5) / ids.size
    ids_ok = bool(freq[4] == 0 and (np.abs(freq - p) < 5 * np.sqrt(
        p * (1 - p) / ids.size) + 1e-12).all())
    img = feed["img"]
    starts = [(a, b) for a in range(4) for b in range(3)
              if np.array_equal(crop, img[:, :, a:a + 5, b:b + 6])]
    check(tg_ok and uni_ok and ids_ok and len(starts) == 1,
          "random ops outside their distributions", tg_ok, uni_ok, ids_ok,
          starts)
    return {"truncated": {"min": float(tg.min()), "max": float(tg.max()),
                          "mean": float(tg.mean()), "var_over_std2":
                          float(tg.var() / std ** 2), "want_var": var1},
            "uniform": {"min": float(uni.min()), "max": float(uni.max()),
                        "mean": float(uni.mean()), "var": float(uni.var()),
                        "want_var": var_u},
            "sampling_id_freq": freq.tolist(), "crop_start": starts[0]}


def rng_check(torch, fluid, dev):
    """The four random ops in a bound step on the card: three steps
    through the fast path (eager, capture, replay) and three op by op
    from a fresh scope; the replayed third step's draws bitwise the
    eager third step's, every step drawing anew, each draw within its
    distribution's limits (rng_limits)."""
    from paddle_tpu_torch import executor as executor_mod

    runs = []
    for cache in (True, False):
        main, feed, fetch = rng_program(fluid, 20_000)
        exe = fluid.Executor(device=dev)
        scope = fluid.Scope()
        before = executor_mod.compile_count()
        runs.append([[np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope,
            use_program_cache=cache)] for _ in range(3)])
        if cache:
            captures = executor_mod.compile_count() - before
            check(captures == 1 and any(b.graph is not None
                                        for b in exe._bound.values()),
                  "the random ops' step was not captured", captures)
    bitwise = all(a.tobytes() == b.tobytes()
                  for a, b in zip(runs[0][2], runs[1][2]))
    check(bitwise, "replayed random ops differ from the eager step")
    check(all(runs[0][0][k].tobytes() != runs[0][1][k].tobytes()
              for k in range(3)), "a random op drew the same twice")
    return {"replay_bitwise_eager": bitwise,
            "limits": [rng_limits(r, feed) for r in runs[0]]}


def auc_bound_check(torch, fluid, dev):
    """A step holding ``layers.auc`` (a sigmoid over a seeded fc of the
    feed, as DeepFM's head) on the card: AUC_STEPS steps through the fast
    path (eager, capture, replays) and AUC_STEPS op by op from a fresh
    scope, a new seeded batch each step; each step's AUC and both
    histogram persistables after it bitwise the same in the two runs,
    the histograms counting every sample fed, one capture."""
    from paddle_tpu_torch import executor as executor_mod

    def program():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = SEED + 71
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            p = fluid.layers.sigmoid(fluid.layers.fc(x, 1))
            auc, stats = fluid.layers.auc(p, y)
        return main, startup, auc, stats

    def feed(step):
        r = np.random.RandomState(SEED + 72 + step)
        return {"x": r.randn(AUC_BATCH, 8).astype(np.float32),
                "y": r.randint(0, 2, (AUC_BATCH, 1)).astype(np.int64)}

    runs, captures = [], None
    for cache in (True, False):
        main, startup, auc, stats = program()
        exe, scope = fluid.Executor(device=dev), fluid.Scope()
        exe.run(startup, scope=scope)
        before = executor_mod.compile_count()
        steps = []
        for step in range(AUC_STEPS):
            (a,) = exe.run(main, feed=feed(step), fetch_list=[auc], scope=scope,
                           use_program_cache=cache)
            steps.append([np.array(a)] + [fluid.executor.as_numpy(scope[v.name])
                                          for v in stats])
        if cache:
            captures = executor_mod.compile_count() - before
        runs.append(steps)
    bitwise = all(a.tobytes() == b.tobytes()
                  for f, o in zip(*runs) for a, b in zip(f, o))
    counted = float(runs[0][-1][1].sum() + runs[0][-1][2].sum())
    aucs = [float(st[0][0]) for st in runs[0]]
    check(captures == 1 and bitwise and counted == AUC_BATCH * AUC_STEPS
          and all(0.0 <= a <= 1.0 for a in aucs),
          "the step holding auc", captures, bitwise, counted, aucs)
    return {"captures": captures, "replays_bitwise_eager": bitwise,
            "aucs": aucs, "counted": counted}


def ops_phase(torch, fluid, fa, dev):
    """Every case of tests/test_torch_{math,tensor,nn}_ops.py (op_cases)
    on the card in float64 against the port's CPU float64: each output
    and gradient within OPS_RTOL of its largest finite magnitude, its
    infinities and NaNs in the same places, integer, bool and index
    outputs exactly; the tie cases' gradients exactly their shares;
    ``scatter`` with repeated ids, and ``auc`` and ``mean_iou``, the same
    bits over SCATTER_RUNS runs and the CPU's answer; ``argsort`` stable
    on ties; out-of-range ids the JAX package's answer (scatter_want,
    multiplex_want) with no device assert; then the random ops in a
    bound step (rng_check) and a bound step holding ``auc``
    (auc_bound_check).  No kernel of this repo runs."""
    cpu = torch.device("cpu")
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    worst = {}
    cases = op_cases()
    for case in cases:
        want = op_case_run(fluid, case, cpu)
        got = op_case_run(fluid, case, dev)
        torch.cuda.synchronize()
        check(len(got) == len(want), case["label"])
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, case["label"],
                  g.shape, w.shape, g.dtype, w.dtype)
            if w.dtype.kind == "f":
                check(np.array_equal(np.isnan(g), np.isnan(w)), case["label"])
                inf = np.isinf(w)
                check(np.array_equal(g[inf], w[inf]), "infinities on the card "
                      "vs cpu", case["label"])
                fin = np.isfinite(w)
                scale = max(float(np.max(np.abs(w[fin]), initial=0.0)), 1e-300)
                e = float(np.max(np.abs(g[fin] - w[fin]), initial=0.0)) / scale
                err = max(err, e)
                check(e <= OPS_RTOL, "op on the card vs cpu", case["label"], e)
            else:
                check(np.array_equal(g, w), "op on the card vs cpu",
                      case["label"], g, w)
        worst[case["label"]] = err
        n_out = sum(case["outputs"].values())
        for idx, share in case["ties"].items():
            gx = got[n_out]
            check(gx[idx] == share, "tie share on the card", case["label"],
                  idx, float(gx[idx]), share)
        f = case["feeds"]
        if case["op"] == "scatter":
            check(np.array_equal(got[0], scatter_want(f["x"], f["ids"], f["upd"])),
                  "scatter vs the JAX package's answer", case["label"])
        if ((case["op"] == "scatter" and "repeated" in case["label"])
                or case["op"] in ("auc", "mean_iou")):
            # repeated (and, for the histograms, negative and out-of-range)
            # ids: the outputs the same bits on every run, the CPU's
            n_out = sum(case["outputs"].values())

            def joined(outs):
                return b"".join(o.tobytes() for o in outs[:n_out])
            bits = {joined(op_case_run(fluid, case, dev))
                    for _ in range(SCATTER_RUNS)}
            check(bits == {joined(got)} and bits == {joined(want)},
                  "bits moved between runs", case["label"], len(bits))
        if case["op"] == "multiplex":
            check(np.array_equal(got[0], multiplex_want(
                [f["x0"], f["x1"], f["x2"]], f["ids"][:, 0])),
                "multiplex vs the JAX package's answer", case["label"])
        if case["op"] == "argsort":
            axis = case["attrs"]["axis"]
            check(np.array_equal(got[1], np.argsort(f["x"], axis=axis,
                                                    kind="stable")),
                  "argsort not stable on the card", case["label"])
    cases_s = time.perf_counter() - t0
    rng = rng_check(torch, fluid, dev)
    auc = auc_bound_check(torch, fluid, dev)
    launches = dict(fa.KERNEL_LAUNCHES)
    check(not any(launches.values()), "a kernel launched in the ops phase",
          launches)
    out = {"cases": len(cases), "ops": len({c["op"] for c in cases}),
           "worst_rel_err": max(worst.values()),
           "worst_case": max(worst, key=worst.get),
           "tie_cases": sum(bool(c["ties"]) for c in cases),
           "rng": rng, "auc_bound": auc, "launches": launches,
           "seconds": {"cases": cases_s,
                       "rng": time.perf_counter() - t0 - cases_s}}
    log("op rules, card vs cpu float64 (%d cases): %s" % (len(cases),
                                                          json.dumps(out)))
    return out


def zoo_model(fluid, name, dtype="float32", no_dropout=False, cfg=None):
    """``ZOO[name]``'s get_model (or ``cfg``'s, a ZOO entry of its own) in
    ``dtype``, every dropout's probability set to 0 where ``no_dropout``
    (the card-vs-CPU check only)."""
    import importlib

    cfg = cfg or ZOO[name]
    mod = importlib.import_module("paddle_tpu_torch.models." + cfg["module"])
    with fluid.unique_name.guard():
        m = mod.get_model(dtype=dtype, **cfg["kw"])
    if no_dropout:
        for prog in (m["main"], m["test"]):
            for op in prog.global_block().ops:
                if op.type == "dropout":
                    op.attrs["dropout_prob"] = 0.0
    return m


def zoo_feed(name, m, rng, n, cfg=None):
    """``n`` seeded samples for ``m``'s feeds: standard normal images and
    labels, word ids of the vocabulary, or DeepFM's ids (one a field)
    and 0/1 click labels (fluid_benchmark.py's _synth)."""
    kw = (cfg or ZOO[name])["kw"]
    if name == "deepfm":
        return {"feat_ids": rng.randint(0, 1000, size=(n, 26)).astype(np.int64),
                "label": rng.randint(0, 2, size=(n, 1)).astype(np.float32)}
    if name == "word2vec":
        return {f: rng.randint(0, kw["vocab_size"], size=(n, 1))
                .astype(np.int64) for f in m["feeds"]}
    return {m["feeds"][0]: rng.randn(n, *kw["image_shape"]).astype(np.float32),
            "label": rng.randint(0, kw["class_dim"], size=(n, 1))
            .astype(np.int64)}


def last_fc(m):
    """The name prefix of the last fc's parameters (the softmax layer's:
    no gate lies between it and the loss)."""
    blk = m["main"].global_block()
    mul = [op for op in blk.ops if op.type == "mul"][-1]
    return mul.inputs["Y"][0].split(".")[0] + "."


def zoo_step(torch, fluid, name, m, state, feed, dev, tf32=False):
    """One training step of ``m`` on ``dev`` from the numpy ``state``, as
    resnet_step: (loss, accuracy or None, every trainable parameter's
    gradient, the running statistics after the step)."""
    blk = m["main"].global_block()
    grads = [p.name + "@GRAD" for p in blk.all_parameters() if p.trainable]
    stats = [p.name for p in blk.all_parameters() if not p.trainable]
    feed = {k: (torch.as_tensor(v).to(getattr(torch, str(blk.var(k).dtype)))
                if v.dtype.kind == "f" else v)
            for k, v in feed.items()}
    scope = fluid.Scope()
    fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
    acc = [m["acc"]] if "acc" in m else []
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = fluid.Executor(device=dev).run(
            m["main"], feed=feed, fetch_list=[m["loss"]] + acc + grads,
            scope=scope)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return {"loss": float(out[0][0]),
            "acc": float(out[1][0]) if acc else None,
            "grads": dict(zip(grads, out[1 + len(acc):])),
            "stats": {n: fluid.executor.as_numpy(scope[n]) for n in stats}}


def zoo_f32_ok(name, e):
    """resnet_f32_ok, and for a model with ``f32_rtol`` (word2vec,
    DeepFM: no batch statistics) the loss and every gradient within
    it."""
    rtol = ZOO[name].get("f32_rtol")
    if rtol is not None:
        return e["loss_rel"] <= rtol and e["grad_worst_of_max"] <= rtol
    return resnet_f32_ok(e)


def biases_before_batch_norm(program):
    """{bias gradient: its layer's weight gradient} for each parameter
    added to a conv or fc output that goes straight into a batch_norm
    (VGG's): the batch_norm takes the mean out, so its true gradient is
    0 and what the step gives is rounding."""
    ops = program.global_block().ops
    made = {n: op for op in ops for ns in op.outputs.values() for n in ns}
    params = {p.name for p in program.global_block().all_parameters()}
    out = {}
    for op in ops:
        add = made.get(op.inputs["X"][0]) if op.type == "batch_norm" else None
        if (add is not None and add.type == "elementwise_add"
                and add.inputs["Y"][0] in params):
            layer = made[add.inputs["X"][0]]
            weight = (layer.inputs.get("Filter") or layer.inputs["Y"])[0]
            out[add.inputs["Y"][0] + "@GRAD"] = weight + "@GRAD"
    return out


def zoo_check(torch, fluid, name, dev):
    """resnet_check's method and limits for ``name`` at full width, batch
    ZOO_CHECK_BATCH (VGG-16: 4, see ZOO), dropout 0: one step from one set of numpy
    parameters on the card and on the port's CPU path, in float64 (loss
    LOSS_RTOL, each gradient GRAD_RTOL of its max, the statistics, the
    accuracy) and in float32 with TF32 off against the CPU's float64
    (zoo_f32_ok, the last fc's gradients in place of fc_0's), and a
    float32 step with TF32 on, which must fail zoo_f32_ok.  A bias whose
    true gradient is 0 (biases_before_batch_norm) is held apart: its
    gradient under ZERO_GRAD_NOISE of its layer weight's largest, in
    every step but the TF32 one."""
    m32, m64 = (zoo_model(fluid, name, d, no_dropout=True)
                for d in ("float32", "float64"))
    m32["startup"].random_seed = SEED + 80
    scope = fluid.Scope()
    fluid.Executor(device=torch.device("cpu")).run(m32["startup"], scope=scope)
    state = {n: scope[n].numpy() for n in m32["main"].persistable_names()
             if n in scope}
    del scope
    feed = zoo_feed(name, m32, np.random.RandomState(SEED + 81),
                    ZOO[name].get("check_batch", ZOO_CHECK_BATCH))
    fc = last_fc(m32)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cpu64 = zoo_step(torch, fluid, name, m64, state, feed, cpu)
    cpu32 = zoo_step(torch, fluid, name, m32, state, feed, cpu)
    cpu_s = time.perf_counter() - t0
    card64 = zoo_step(torch, fluid, name, m64, state, feed, dev)
    card32 = zoo_step(torch, fluid, name, m32, state, feed, dev)
    tf32 = zoo_step(torch, fluid, name, m32, state, feed, dev, tf32=True)
    zero = biases_before_batch_norm(m32["main"])
    noise = {k: max([float(np.abs(st["grads"][b]).max())
                     / float(np.abs(st["grads"][w]).max())
                     for b, w in zero.items()] or [0.0])
             for k, st in (("cpu64", cpu64), ("cpu32", cpu32),
                           ("card64", card64), ("card32", card32))}
    check(max(noise.values()) <= ZERO_GRAD_NOISE,
          name + " a zero-gradient bias moved", noise)
    e64 = resnet_errors(card64, cpu64, fc, zero)
    check(e64["loss_rel"] <= LOSS_RTOL and e64["grad_worst_of_max"]
          <= GRAD_RTOL and e64["stat_worst_of_max"] <= RESNET_STAT_RTOL
          and e64["acc_equal"], name + " float64 card vs cpu", e64)
    out = {"float64_card_vs_cpu": e64,
           "float32_card_vs_cpu64": resnet_errors(card32, cpu64, fc, zero),
           "float32_cpu_vs_cpu64": resnet_errors(cpu32, cpu64, fc, zero),
           "tf32_card_vs_cpu64": resnet_errors(tf32, cpu64, fc, zero),
           "zero_gradient_biases": len(zero),
           "zero_gradient_worst_of_weight": noise,
           "loss": {"cpu64": cpu64["loss"], "card64": card64["loss"],
                    "cpu32": cpu32["loss"], "card32": card32["loss"],
                    "tf32": tf32["loss"]},
           "batch": len(feed[m32["feeds"][-1]]),
           "last_fc": fc, "cpu_steps_s": cpu_s}
    check(zoo_f32_ok(name, out["float32_card_vs_cpu64"]),
          name + " float32 card vs cpu", out["float32_card_vs_cpu64"])
    check(zoo_f32_ok(name, out["float32_cpu_vs_cpu64"]),
          name + " float32 cpu vs cpu float64", out["float32_cpu_vs_cpu64"])
    check(not zoo_f32_ok(name, out["tf32_card_vs_cpu64"]),
          name + " limits pass a TF32 step", out["tf32_card_vs_cpu64"])
    return out


def zoo_train(torch, fluid, name, dev, cfg=None):
    """ZOO_STEPS training steps of ``name`` (``cfg``'s model where given)
    at its batch through
    Executor.run on the card (step 1 eager, step 2 the capture, replays
    after), on one seeded batch fed each step, dropout as the model has
    it: every loss finite and the last under the first, every parameter
    finite; step ms (steps 3 on), samples/s, peak memory, a replay's
    busy and idle time, one eager step's device time by op family; then
    one pass of the test Program (``main.clone(for_test=True)``) on the
    batch: finite, of the expected shape, each softmax row summing to 1
    (DeepFM: each click probability in [0, 1]).  DeepFM's steps fetch
    its AUC too, the histograms accumulating across the replays: each
    in [0, 1], and the last one's histograms counting every sample fed."""
    cfg = cfg or ZOO[name]
    batch, unit = cfg["batch"], cfg["unit"]
    m = zoo_model(fluid, name, cfg=cfg)
    m["startup"].random_seed = SEED + 82
    exe = fluid.Executor(device=dev)
    scope = fluid.Scope()
    exe.run(m["startup"], scope=scope)
    params = [p.name for p in m["main"].global_block().all_parameters()
              if p.trainable]
    feed = {k: torch.as_tensor(v, device=dev) for k, v in zoo_feed(
        name, m, np.random.RandomState(SEED + 83), batch, cfg=cfg).items()}
    fetch_list = [m["loss"]] + ([m["auc"]] if "auc" in m else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, aucs, step_s = [], [], []
    for _ in range(ZOO_STEPS):
        t0 = time.perf_counter()
        out = exe.run(m["main"], feed=feed, fetch_list=fetch_list,
                      scope=scope)
        losses.append(float(out[0][0]))
        if len(out) > 1:
            aucs.append(float(out[1][0]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          name + " loss not finite or not falling", losses)
    if aucs:
        stat = [n for n in m["main"].global_block().vars if "_stat_" in n]
        counted = sum(float(scope[n].sum()) for n in stat)
        check(all(0.0 <= a <= 1.0 for a in aucs) and len(stat) == 2
              and counted == batch * ZOO_STEPS,
              name + " AUC outside [0, 1] or histograms miscounted", aucs,
              counted)
    check(all(bool(torch.isfinite(scope[p]).all()) for p in params),
          name + " non-finite parameter")
    steady = steady_ms(step_s)
    graphed = profile_graphed(torch, exe, m, feed, scope, fetch=fetch_list)
    profile = profile_ops(torch, exe, m, feed, scope, fetch_list,
                          families=ZOO_FAMILIES)
    top = (dict(sorted(profile["device_ms_by_family"].items(),
                       key=lambda kv: -kv[1])[:5])
           if isinstance(profile, dict) else profile)
    fetch = m["predict"] if "predict" in m else m["loss"]
    test = np.asarray(exe.run(m["test"], feed=feed, fetch_list=[fetch],
                              scope=scope)[0])
    if name == "deepfm":
        check(test.shape == (batch, 1) and np.isfinite(test).all()
              and ((test >= 0) & (test <= 1)).all(),
              name + " test Program", test.shape)
    elif "predict" in m:
        check(test.shape == (batch, cfg["kw"]["class_dim"])
              and np.isfinite(test).all()
              and np.allclose(test.sum(-1), 1.0, atol=1e-5),
              name + " test Program", test.shape)
    else:
        check(test.shape == (1,) and np.isfinite(test).all(),
              name + " test Program", test.shape)
    stats = {"batch": batch, "steps": ZOO_STEPS, "params": len(params),
             "param_values": int(sum(scope[p].numel() for p in params)),
             "first_step_ms": step_s[0] * 1e3,
             "capture_step_ms": step_s[1] * 1e3, "step_ms": steady,
             "step_ms_all": [t * 1e3 for t in step_s],
             unit + "_per_s": batch / (steady / 1e3),
             "replay_device_ms": (graphed["device_busy_ms"]
                                  if isinstance(graphed, dict) else graphed),
             "replay_idle_share": (graphed["device_idle_share"]
                                   if isinstance(graphed, dict) else graphed),
             "peak_memory_gib": peak / 2 ** 30, "losses": losses,
             "aucs": aucs or None,
             "test_pass": {"fetch": fetch.name, "shape": list(test.shape)},
             "graphed_profile": graphed, "eager_top_families_ms": top,
             "eager_profile": profile}
    return stats


def zoo_phase(torch, fluid, fa, dev):
    """VGG-16, SE-ResNeXt-50, word2vec and DeepFM (ZOO) at full width: the
    card-vs-CPU step (zoo_check) and ZOO_STEPS training steps on the
    fast path with a pass of the test Program (zoo_train).  No kernel
    of this repo runs: B1-B5 launch 0 times in the phase."""
    fa.reset_launch_counts()
    out = {}
    for name in ZOO:
        t0 = time.perf_counter()
        chk = zoo_check(torch, fluid, name, dev)
        t1 = time.perf_counter()
        trn = zoo_train(torch, fluid, name, dev)
        t2 = time.perf_counter()
        out[name] = {"check": chk, "train": trn,
                     "seconds": {"check": t1 - t0, "train": t2 - t1}}
        log("%s (full width, TF32 off): %s" % (name, json.dumps(out[name])))
        torch.cuda.empty_cache()
    launches = dict(fa.KERNEL_LAUNCHES)
    check(not any(launches.values()), "a kernel launched in the zoo phase",
          launches)
    log("zoo phase: launches %s, seconds %s" % (json.dumps(launches), json.dumps(
        {n: o["seconds"] for n, o in out.items()})))
    return out


# ---------------------------------------------------------------------------
# the sequence slice: the sequence op rules, StaticRNN/DynamicRNN and the
# stacked LSTM, recommender and machine-translation models
# ---------------------------------------------------------------------------


def seq_ragged(rng, lens, T, tail=(), ints=None):
    """A ragged feed (data, lengths): padded ``[len(lens), T] + tail``
    data, float64 (or ids in ``ints``), random in the padding too."""
    shape = (len(lens), T) + tuple(tail)
    data = (rng.randint(*ints, size=shape).astype(np.int64) if ints
            else rng.uniform(-2, 2, shape))
    return data, np.asarray(lens, np.int32)


def seq_op_cases():
    """Cases after tests/test_torch_sequence_ops.py and
    tests/test_torch_rnn.py (each of the 21 rules, their edges and the
    RNNs) in float64: dicts of a label, the feeds (name
    -> array, or (data, lengths) for a ragged one), a body building the
    outputs from the data variables through the layers, the outputs
    whose lengths are fetched, and exact gradient shares (tie cases)."""
    cases = []
    rng = np.random.RandomState(SEED + 100)

    def add(label, feeds, body, lod=(), ties=None):
        cases.append(dict(label=label, feeds=feeds, body=body, lod=lod,
                          ties=ties or {}))

    seq = seq_ragged(rng, [5, 2, 0, 4], 6, (3,))
    full = seq_ragged(rng, [5, 2, 1, 4], 6, (3,))
    for pool in ("average", "sum", "sqrt", "max", "min", "last", "first"):
        add("sequence_pool " + pool, {"x": full if pool in ("max", "min")
                                      else seq},
            lambda L, v, p=pool: [L.sequence_pool(v["x"], p)])
    tied = _f64([[[1, 3], [3, 3], [3, 9]], [[2, 0], [2, 5], [7, 5]]])
    add("sequence_pool max ties", {"x": (tied, np.array([3, 2], np.int32))},
        lambda L, v: [L.sequence_pool(v["x"], "max")],
        ties={(0, 1, 0): 0.125, (0, 2, 0): 0.125, (0, 2, 1): 0.25,
              (1, 0, 0): 0.125, (1, 1, 0): 0.125, (1, 1, 1): 0.25,
              (1, 2, 0): 0.0})
    # a softmax's entries sum to 1, so mean(softmax) has no gradient: the
    # case weighs the probabilities first
    add("sequence_softmax", {"x": seq_ragged(rng, [6, 1, 3], 6, (1,)),
                             "w": rng.uniform(-2, 2, (3, 6, 1))},
        lambda L, v: [L.elementwise_mul(L.sequence_softmax(v["x"]), v["w"])],
        lod=(0,))
    for k in (3, 4):
        add("sequence_conv %d" % k, {"x": seq_ragged(rng, [6, 3, 1], 7, (4,))},
            lambda L, v, k=k: [L.sequence_conv(v["x"], num_filters=5,
                                               filter_size=k, act="tanh")],
            lod=(0,))
    add("row_conv", {"x": seq_ragged(rng, [5, 3, 6], 6, (4,))},
        lambda L, v: [L.row_conv(v["x"], future_context_size=2)], lod=(0,))
    add("sequence_expand broadcast", {"x": rng.uniform(-2, 2, (4, 3)),
                                      "y": seq_ragged(rng, [5, 2, 0, 4], 6, (2,))},
        lambda L, v: [L.sequence_expand(v["x"], v["y"])], lod=(0,))
    add("sequence_expand_as", {"x": rng.uniform(-2, 2, (3, 1, 4)),
                               "y": seq_ragged(rng, [2, 5, 3], 5, (1,))},
        lambda L, v: [L.sequence_expand_as(v["x"], v["y"])], lod=(0,))
    add("sequence_concat", {"a": seq_ragged(rng, [2, 0, 3], 4, (3,)),
                            "b": seq_ragged(rng, [1, 4, 2], 4, (3,))},
        lambda L, v: [L.sequence_concat([v["a"], v["b"]])], lod=(0,))
    add("sequence_reshape", {"x": seq_ragged(rng, [4, 2, 3], 4, (4,))},
        lambda L, v: [L.sequence_reshape(v["x"], 2)], lod=(0,))
    add("sequence_enumerate", {"ids": seq_ragged(rng, [5, 2, 3], 5, (),
                                                 (1, 9))},
        lambda L, v: [L.sequence_enumerate(v["ids"], win_size=3,
                                           pad_value=-1)], lod=(0,))
    add("sequence_scatter", {
        "x": rng.uniform(-2, 2, (3, 6)),
        "ids": (np.array([[0, 5, -1, 2], [3, 3, 9, -7], [1, 4, 4, 0]]),
                np.array([4, 4, 2], np.int32)),
        "upd": (rng.uniform(-2, 2, (3, 4)), np.array([4, 4, 2], np.int32))},
        lambda L, v: [L.sequence_scatter(v["x"], v["ids"], v["upd"])])
    add("sequence_slice", {"x": seq_ragged(rng, [4, 3, 5], 5, (2,)),
                           "off": np.array([[1], [0], [3]]),
                           "len": np.array([[2], [3], [3]])},
        lambda L, v: [L.sequence_slice(v["x"], v["off"], v["len"])], lod=(0,))
    for maxlen in (None, 8, 3):
        add("sequence_pad %s" % maxlen, {"x": seq_ragged(rng, [5, 2, 0, 4], 6,
                                                         (2,))},
            lambda L, v, m=maxlen: list(L.sequence_pad(v["x"], -1.5, maxlen=m)))
    add("sequence_unpad", {"x": rng.uniform(-2, 2, (3, 5, 2)),
                           "len": np.array([5, 1, 3])},
        lambda L, v: [L.sequence_unpad(v["x"], v["len"])], lod=(0,))
    add("sequence_mask", {"x": np.array([3, 0, 5, 1])},
        lambda L, v: [L.sequence_mask(v["x"], maxlen=6, dtype="float32")])
    add("sequence_erase", {"ids": (np.array([[2, 5, 3, 2, 7, 1],
                                             [5, 5, 6, 2, 9, 9],
                                             [4, 2, 2, 2, 2, 2]]),
                                   np.array([6, 4, 2], np.int32))},
        lambda L, v: [L.sequence_erase(v["ids"], tokens=[2, 5])], lod=(0,))
    add("lod_reset", {"x": seq_ragged(rng, [2, 3, 1], 3, (2,))},
        lambda L, v: [L.lod_reset(v["x"], target_lod=[0, 4, 5, 6])], lod=(0,))
    add("lod_reset y", {"x": seq_ragged(rng, [2, 3, 1], 3, (2,)),
                        "y": seq_ragged(rng, [1, 4, 1], 4, (1,))},
        lambda L, v: [L.lod_reset(v["x"], y=v["y"])], lod=(0,))
    D = 4
    lens = [8, 3, 0, 6]
    for label, kw in (("peepholes", {}),
                      ("no peepholes", {"use_peepholes": False}),
                      ("reverse", {"is_reverse": True}),
                      ("activations", {"is_reverse": True,
                                       "gate_activation": "tanh",
                                       "cell_activation": "relu",
                                       "candidate_activation": "identity"})):
        add("dynamic_lstm " + label, {"x": seq_ragged(rng, lens, 8, (4 * D,))},
            lambda L, v, kw=kw: list(L.dynamic_lstm(v["x"], size=4 * D, **kw)),
            lod=(0, 1))
    add("dynamic_lstm initial state",
        {"x": seq_ragged(rng, lens, 8, (4 * D,)),
         "h0": rng.uniform(-1, 1, (4, D)), "c0": rng.uniform(-1, 1, (4, D))},
        lambda L, v: list(L.dynamic_lstm(v["x"], size=4 * D, h_0=v["h0"],
                                         c_0=v["c0"])), lod=(0, 1))
    add("dynamic_lstmp reverse", {"x": seq_ragged(rng, lens, 8, (4 * D,))},
        lambda L, v: list(L.dynamic_lstmp(v["x"], size=4 * D, proj_size=3,
                                          is_reverse=True)), lod=(0,))
    for origin, rev in ((False, False), (True, True)):
        add("dynamic_gru origin %s reverse %s" % (origin, rev),
            {"x": seq_ragged(rng, lens, 8, (3 * D,))},
            lambda L, v, o=origin, r=rev: [L.dynamic_gru(
                v["x"], size=D, origin_mode=o, is_reverse=r)], lod=(0,))
    add("gru_unit origin", {"x": rng.uniform(-1, 1, (3, 3 * D)),
                            "h": rng.uniform(-1, 1, (3, D))},
        lambda L, v: list(L.gru_unit(v["x"], v["h"], size=3 * D,
                                     origin_mode=True)))
    add("lstm_unit", {"x": rng.uniform(-1, 1, (3, 5)),
                      "h": rng.uniform(-1, 1, (3, D)),
                      "c": rng.uniform(-1, 1, (3, D))},
        lambda L, v: list(L.lstm_unit(v["x"], v["h"], v["c"],
                                      forget_bias=1.0)))

    def elman(L, v, dynamic):
        rnn = L.DynamicRNN() if dynamic else L.StaticRNN()
        with (rnn.block() if dynamic else rnn.step()):
            xt = rnn.step_input(v["x"])
            h_prev = (rnn.memory(shape=[-1, 3], value=0.0) if dynamic else
                      rnn.memory(shape=[-1, 3], batch_ref=xt, init_value=0.0))
            h = L.tanh(L.elementwise_add(L.fc(xt, size=3), L.fc(
                h_prev, size=3, bias_attr=False)))
            rnn.update_memory(h_prev, h)
            rnn.output(h)
        return [rnn()]

    add("StaticRNN", {"x": rng.uniform(-1, 1, (2, 7, 3))},
        lambda L, v: elman(L, v, False))
    add("DynamicRNN lengths", {"x": seq_ragged(rng, [7, 2, 5, 0], 7, (3,))},
        lambda L, v: elman(L, v, True), lod=(0,))
    add("max_sequence_len", {"x": seq_ragged(rng, [2, 4, 1], 5, (2,))},
        lambda L, v: [L.max_sequence_len(L.lod_rank_table(v["x"]))])
    return cases


def seq_case_program(fluid, case):
    """The case's Program in float64 (widened), its startup, the fetch
    names (the outputs, their lengths, then the gradients of mean(first
    output) with respect to every float feed and parameter) and the
    number of fetches before the gradients."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED + 101
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        vs = {}
        for n, v in case["feeds"].items():
            a = v[0] if isinstance(v, tuple) else v
            dtype = "float32" if a.dtype.kind == "f" else str(a.dtype)
            if isinstance(v, tuple):
                vs[n] = L.data(name=n, shape=list(a.shape[2:]), dtype=dtype,
                               lod_level=1, stop_gradient=a.dtype.kind != "f")
            else:
                vs[n] = L.data(name=n, shape=list(a.shape), dtype=dtype,
                               append_batch_size=False,
                               stop_gradient=a.dtype.kind != "f")
        outs = case["body"](L, vs)
        fetch = ([o.name for o in outs]
                 + [outs[i].name + "@LENGTHS" for i in case["lod"]])
        wrt = [vs[n] for n, v in case["feeds"].items()
               if (v[0] if isinstance(v, tuple) else v).dtype.kind == "f"]
        wrt += main.global_block().all_parameters()
        if (wrt and outs[0].dtype == "float32"
                and case.get("grad", True)):
            fetch += [g.name for g in fluid.backward.calc_gradient(
                L.mean(outs[0]), wrt)]
    return (widened(fluid, main), widened(fluid, startup), fetch,
            len(outs) + len(case["lod"]))


def seq_case_run(fluid, case, prog, state, dev):
    """One run of a case's Program on ``dev`` from ``state``: its fetches
    as numpy."""
    from paddle_tpu_torch.lod import LoDArray

    main, _, fetch, _ = prog
    scope = fluid.Scope()
    fluid.load_numpy_state(main, state, scope=scope, device=dev)
    feed = {n: (LoDArray(*v) if isinstance(v, tuple) else v)
            for n, v in case["feeds"].items()}
    return [np.asarray(o) for o in fluid.Executor(device=dev).run(
        main, feed=feed, fetch_list=fetch, scope=scope)]


def seq_reverse_exact(torch, fluid, dev):
    """``is_reverse`` on the card, exactly: a reverse dynamic_lstm and
    dynamic_gru over a ragged batch equal, bitwise, the forward ones (the
    same parameters) over the batch with each row reversed within its
    length, their outputs reversed back; float64 and float32."""
    from paddle_tpu_torch.lod import LoDArray

    rng = np.random.RandomState(SEED + 102)
    lens = np.array([8, 3, 0, 6, 1], np.int32)
    out = {}
    for dtype in ("float32", "float64"):
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = SEED + 103
        L = fluid.layers
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            outs = []
            for op, width in (("lstm", 16), ("gru", 12)):
                pa = fluid.ParamAttr(name=op + "_w")
                ba = fluid.ParamAttr(name=op + "_b")
                for rev, name in ((True, "x"), (False, "xr")):
                    x = L.data(name=op + name, shape=[width], dtype=dtype,
                               lod_level=1)
                    if op == "lstm":
                        h, _ = L.dynamic_lstm(x, size=width, param_attr=pa,
                                              bias_attr=ba, is_reverse=rev,
                                              dtype=dtype)
                    else:
                        h = L.dynamic_gru(x, size=width // 3, param_attr=pa,
                                          bias_attr=ba, is_reverse=rev)
                    outs.append(h)
        exe, scope = fluid.Executor(device=dev), fluid.Scope()
        exe.run(startup, scope=scope)
        feed = {}
        for op, width in (("lstm", 16), ("gru", 12)):
            x = rng.uniform(-2, 2, (5, 8, width)).astype(dtype)
            xr = x.copy()
            for b, n in enumerate(lens):
                xr[b, :n] = x[b, :n][::-1]
            feed[op + "x"], feed[op + "xr"] = (LoDArray(x, lens),
                                               LoDArray(xr, lens))
        got = [np.asarray(o) for o in exe.run(main, feed=feed,
                                              fetch_list=outs, scope=scope)]
        same = []
        for rev_out, fwd_out in (got[:2], got[2:]):
            back = fwd_out.copy()
            for b, n in enumerate(lens):
                back[b, :n] = fwd_out[b, :n][::-1]
            same.append(rev_out.tobytes() == back.tobytes())
        check(all(same), "is_reverse on the card not exactly the reversed "
              "forward pass", dtype, same)
        out[dtype] = same
    return out


def seq_ops_check(torch, fluid, dev):
    """seq_op_cases on the card in float64 against the port's CPU: each
    output and gradient within OPS_RTOL of its largest magnitude, integer
    outputs and lengths exactly, the tie cases' gradient shares exactly;
    then seq_reverse_exact."""
    cpu = torch.device("cpu")
    worst = {}
    cases = seq_op_cases()
    for case in cases:
        prog = seq_case_program(fluid, case)
        sc = fluid.Scope()
        fluid.Executor(device=cpu).run(prog[1], scope=sc)
        state = {n: sc[n].numpy() for n in prog[0].persistable_names()
                 if n in sc}
        want = seq_case_run(fluid, case, prog, state, cpu)
        got = seq_case_run(fluid, case, prog, state, dev)
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, case["label"],
                  g.shape, w.shape, g.dtype, w.dtype)
            if w.dtype.kind == "f":
                scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-300)
                e = float(np.max(np.abs(g - w), initial=0.0)) / scale
                err = max(err, e)
                check(e <= OPS_RTOL, "sequence op on the card vs cpu",
                      case["label"], e)
            else:
                check(np.array_equal(g, w), "sequence op on the card vs cpu",
                      case["label"])
        worst[case["label"]] = err
        n_out = prog[3]
        for idx, share in case["ties"].items():
            check(got[n_out][idx] == share, "tie share on the card",
                  case["label"], idx, float(got[n_out][idx]), share)
    return {"cases": len(cases), "worst_rel_err": max(worst.values()),
            "worst_case": max(worst, key=worst.get),
            "tie_cases": sum(bool(c["ties"]) for c in cases),
            "reverse_bitwise": seq_reverse_exact(torch, fluid, dev)}


def seq_cfg(name):
    """``name``'s entry of SEQ_MODELS, STRUCT_MODELS or DET_MODELS."""
    return (SEQ_MODELS.get(name) or STRUCT_MODELS.get(name)
            or DET_MODELS[name])


def seq_model(fluid, name, **over):
    """``seq_cfg(name)``'s get_model (``over`` on top of its kw)."""
    import importlib

    mod = importlib.import_module("paddle_tpu_torch.models."
                                  + seq_cfg(name)["module"])
    with fluid.unique_name.guard():
        return mod.get_model(**dict(seq_cfg(name)["kw"], **over))


def seq_words(rng, n, seq, vocab, pad):
    """``n`` rows of ids in [3, vocab), each 8 to ``seq`` tokens long,
    ``pad`` after."""
    words = rng.randint(3, vocab, size=(n, seq)).astype(np.int64)
    for b, k in enumerate(rng.randint(8, seq + 1, size=n)):
        words[b, k:] = pad
    return words


def seq_feed(name, rng, n, dense=False):
    """``n`` seeded samples for ``name``: the stacked LSTM's words
    (lengths SEQ_LSTM_LENS padded to SEQ_LSTM_T, a LoDArray unless
    ``dense``) and labels; the recommender's ids, 1 to SEQ_GENRES genres
    and 1 to SEQ_TITLE title words a movie (LoDArrays), and ratings in
    [1, 5]; machine translation's source and target rows (PAD_IDX tails)
    and the target shifted by one as the label; STRUCT_MODELS' from
    struct_feed."""
    from paddle_tpu_torch.lod import LoDArray

    if name in STRUCT_MODELS:
        return struct_feed(name, rng, n)
    if name in DET_MODELS:
        return det_feed(rng, n, dense)
    kw = SEQ_MODELS[name]["kw"]

    def ragged(lo, hi, T, vocab):
        return LoDArray(rng.randint(0, vocab, size=(n, T, 1)).astype(np.int64),
                        rng.randint(lo, hi + 1, size=n))

    if name == "stacked_dynamic_lstm":
        words = ragged(SEQ_LSTM_LENS[0], SEQ_LSTM_LENS[1], SEQ_LSTM_T,
                       kw["vocab_size"])
        return {"words": words.data if dense else words,
                "label": rng.randint(0, 2, size=(n, 1)).astype(np.int64)}
    if name == "recommender":
        feed = {k: rng.randint(lo, hi + 1, size=(n, 1)).astype(np.int64)
                for k, lo, hi in (("user_id", 1, kw["max_user_id"]),
                                  ("gender_id", 0, 1), ("age_id", 0, 6),
                                  ("job_id", 0, kw["max_job_id"]),
                                  ("movie_id", 1, kw["max_movie_id"]))}
        feed["category_id"] = ragged(1, SEQ_GENRES, SEQ_GENRES,
                                     kw["n_categories"])
        feed["movie_title"] = ragged(1, SEQ_TITLE, SEQ_TITLE,
                                     kw["title_dict_size"])
        feed["score"] = rng.uniform(1, 5, size=(n, 1)).astype(np.float32)
        return feed
    from paddle_tpu_torch.models import machine_translation as MT

    src, trg = (seq_words(rng, n, kw["seq_len"], kw["dict_size"], MT.PAD_IDX)
                for _ in range(2))
    label = np.concatenate([trg[:, 1:], np.full((n, 1), MT.PAD_IDX)], 1)
    return {"src_word": src, "trg_word": trg,
            "label": label[..., None].astype(np.int64)}


def seq_step(torch, fluid, m, main, state, feed, dev, tf32=False):
    """One training step of ``main`` (``m``'s Program or its widened copy)
    on ``dev`` from the numpy ``state``, as zoo_step: (loss, every
    trainable parameter's gradient, the running statistics after the
    step)."""
    blk = main.global_block()
    grads = [p.name + "@GRAD" for p in blk.all_parameters() if p.trainable]
    stats = [p.name for p in blk.all_parameters() if not p.trainable]
    feed = {k: (v.astype(str(blk.var(k).dtype))
                if isinstance(v, np.ndarray) and v.dtype.kind == "f" else v)
            for k, v in feed.items()}
    scope = fluid.Scope()
    fluid.load_numpy_state(main, state, scope=scope, device=dev)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = fluid.Executor(device=dev).run(
            main, feed=feed, fetch_list=[m["loss"].name] + grads, scope=scope)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return {"loss": float(np.asarray(out[0]).reshape(-1)[0]), "acc": None,
            "grads": dict(zip(grads, out[1:])),
            "stats": {n: fluid.executor.as_numpy(scope[n]) for n in stats}}


def seq_state(fluid, m, seed, dev):
    """``m``'s startup run on ``dev`` from ``seed``: its persistables as
    numpy."""
    m["startup"].random_seed = seed
    scope = fluid.Scope()
    fluid.Executor(device=dev).run(m["startup"], scope=scope)
    return {n: fluid.executor.as_numpy(scope[n])
            for n in m["main"].persistable_names() if n in scope}


def shift_invariant_weights(program):
    """The gradients of the weights of every ``mul`` whose output an
    ``unsqueeze`` reads, in any block: machine translation's attention
    state projection, added to every source position ahead of the
    attention's softmax (SEQ_CANCEL_FACTOR)."""
    out = []
    for blk in program.blocks:
        unsqueezed = {n for op in blk.ops if op.type == "unsqueeze"
                      for n in op.inputs["X"]}
        out += [op.inputs["Y"][0] + "@GRAD" for op in blk.ops
                if op.type == "mul" and op.outputs["Out"][0] in unsqueezed]
    return out


def seq_errors(a, ref, fc, cancel):
    """resnet_errors with the gradients in ``cancel`` left out of the
    worst and listed apart (each one's max error of its max)."""
    e = resnet_errors(a, ref, fc, skip=cancel)
    e["cancelling"] = {n: float(np.abs(a["grads"][n] - ref["grads"][n]).max())
                       / float(np.abs(ref["grads"][n]).max()) for n in cancel}
    return e


def seq_f32_ok(name, e, cpu32=None):
    """The loss and every gradient within ``f32_rtol``; a cancelling
    gradient (shift_invariant_weights) within SEQ_CANCEL_FACTOR times the
    CPU's own float32 error of it (``cpu32``'s) or ``f32_rtol``, the
    larger."""
    rtol = SEQ_MODELS[name]["f32_rtol"]
    cpu32 = cpu32 or e
    return (e["loss_rel"] <= rtol and e["grad_worst_of_max"] <= rtol
            and all(v <= SEQ_CANCEL_FACTOR * max(cpu32["cancelling"][n], rtol)
                    for n, v in e["cancelling"].items()))


def seq_check(torch, fluid, name, dev):
    """zoo_check's method for ``name`` at full width, batch
    ``check_batch``: one step from one set of numpy parameters on the
    card and on the port's CPU path, in float64 (the Program widened;
    loss LOSS_RTOL, each gradient GRAD_RTOL of its max) and in float32
    with TF32 off against the CPU's float64 step (the loss and every
    gradient within ``f32_rtol``), the CPU's float32 step too, and a
    float32 step with TF32 on, which must fail ``f32_rtol``."""
    cpu = torch.device("cpu")
    m = seq_model(fluid, name)
    state = seq_state(fluid, m, SEED + 110, cpu)
    feed = seq_feed(name, np.random.RandomState(SEED + 111),
                    SEQ_MODELS[name]["check_batch"])
    main64 = widened(fluid, m["main"])
    fc = last_fc(m)
    cancel = shift_invariant_weights(m["main"])
    t0 = time.perf_counter()
    cpu64 = seq_step(torch, fluid, m, main64, state, feed, cpu)
    cpu32 = seq_step(torch, fluid, m, m["main"], state, feed, cpu)
    cpu_s = time.perf_counter() - t0
    card64 = seq_step(torch, fluid, m, main64, state, feed, dev)
    card32 = seq_step(torch, fluid, m, m["main"], state, feed, dev)
    tf32 = seq_step(torch, fluid, m, m["main"], state, feed, dev, tf32=True)
    e64 = seq_errors(card64, cpu64, fc, cancel)
    check(e64["loss_rel"] <= LOSS_RTOL
          and max([e64["grad_worst_of_max"]] + list(e64["cancelling"].values()))
          <= GRAD_RTOL, name + " float64 card vs cpu", e64)
    out = {"float64_card_vs_cpu": e64,
           "float32_card_vs_cpu64": seq_errors(card32, cpu64, fc, cancel),
           "float32_cpu_vs_cpu64": seq_errors(cpu32, cpu64, fc, cancel),
           "tf32_card_vs_cpu64": seq_errors(tf32, cpu64, fc, cancel),
           "f32_rtol": SEQ_MODELS[name]["f32_rtol"],
           "loss": {"cpu64": cpu64["loss"], "card64": card64["loss"],
                    "cpu32": cpu32["loss"], "card32": card32["loss"],
                    "tf32": tf32["loss"]},
           "batch": SEQ_MODELS[name]["check_batch"], "cpu_steps_s": cpu_s}
    cpu_e = out["float32_cpu_vs_cpu64"]
    check(seq_f32_ok(name, out["float32_card_vs_cpu64"], cpu_e),
          name + " float32 card vs cpu", out["float32_card_vs_cpu64"])
    check(seq_f32_ok(name, cpu_e), name + " float32 cpu vs cpu float64", cpu_e)
    check(not seq_f32_ok(name, out["tf32_card_vs_cpu64"], cpu_e),
          name + " limits pass a TF32 step", out["tf32_card_vs_cpu64"])
    return out


def seq_units(name, feed):
    """The work units of one step on ``feed``: samples, and the tokens
    the step reads (the LSTM's word lengths, machine translation's
    non-pad target tokens, SRL's sentence lengths; OCR's images)."""
    if name == "ocr_crnn_ctc":
        return {"images": len(feed["pixel"])}
    if name in DET_MODELS:
        return {"images": len(feed["image"])}
    if name == "label_semantic_roles":
        return {"samples": len(feed["target"].lengths),
                "tokens": int(np.sum(feed["target"].lengths))}
    if name == "stacked_dynamic_lstm":
        words = feed["words"]
        return {"samples": len(feed["label"]),
                "tokens": int(np.sum(words.lengths) if hasattr(words, "lengths")
                              else words.shape[0] * words.shape[1])}
    if name == "machine_translation":
        from paddle_tpu_torch.models import machine_translation as MT

        return {"samples": len(feed["src_word"]),
                "tokens": int((feed["label"] != MT.PAD_IDX).sum())}
    return {"samples": len(feed["score"])}


def seq_train(torch, fluid, name, dev, dense=False):
    """SEQ_STEPS (or its ``steps``) training steps of ``name`` (a
    SEQ_MODELS or STRUCT_MODELS name) at its batch through
    Executor.run on the card, on one seeded batch fed each step (numpy
    and LoDArrays, as a reader gives them; ``dense``: the LSTM's words as
    a plain padded array): every loss finite and the last under the
    first, every parameter finite; ms a step (steps 3 on), samples and
    tokens a second, peak memory, and one profiled step: a replay's (a
    bound Program) or an op-by-op step's busy and idle time and its
    kernel launches.  Returns the figures, the executor, the scope, the
    model and the feed."""
    from paddle_tpu_torch import executor as executor_mod

    batch, steps = seq_cfg(name)["batch"], seq_cfg(name).get("steps",
                                                            SEQ_STEPS)
    m = seq_model(fluid, name)
    m["startup"].random_seed = SEED + 112
    exe, scope = fluid.Executor(device=dev), fluid.Scope()
    exe.run(m["startup"], scope=scope)
    params = [p.name for p in m["main"].global_block().all_parameters()
              if p.trainable]
    feed = seq_feed(name, np.random.RandomState(SEED + 113), batch, dense)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    c0 = executor_mod.compile_count()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        (loss,) = exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                          scope=scope)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    captures = executor_mod.compile_count() - c0
    bound = [b for b in exe._bound.values() if b.program is m["main"]]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          name + " loss not finite or not falling", losses)
    check(all(bool(torch.isfinite(scope[p]).all()) for p in params),
          name + " non-finite parameter")
    if bound:
        prof = profile_graphed(torch, exe, m, feed, scope)
    else:
        prof = busy_idle(profile_call(torch, lambda: exe.run(
            m["main"], feed=feed, fetch_list=[m["loss"]], scope=scope)))
    steady = steady_ms(step_s)
    units = seq_units(name, feed)
    out = {"batch": batch, "steps": steps, "bound": bool(bound),
           "captures": captures, "first_step_ms": step_s[0] * 1e3,
           "step_ms": steady, "step_ms_all": [t * 1e3 for t in step_s],
           "peak_memory_gib": peak / 2 ** 30, "losses": losses,
           "profile": prof}
    for unit, n in units.items():
        out[unit + "_per_step"] = n
        out[unit + "_per_s"] = n / (steady / 1e3)
    if isinstance(prof, dict):
        # the profiler's own overhead stretches the profiled step's wall:
        # its device time over the unprofiled steady step is the idle
        # share a user's step sees
        out["launches_per_step"] = prof["device_events"]
        out["idle_share"] = prof["device_idle_share"]
        out["idle_share_of_step"] = max(0.0, 1.0 - prof["device_busy_ms"]
                                        / steady)
    return out, exe, scope, m, feed


def seq_bound_check(torch, fluid, dev):
    """Machine translation's training step (DynamicRNN over the dense
    target: a ``static_rnn`` op, no host read) from one start state in
    two scopes: SEQ_BOUND_STEPS steps op by op and as many through the
    fast path (eager, capture, replays): one bound entry, one capture,
    the losses and every persistable bitwise equal."""
    from paddle_tpu_torch import executor as executor_mod

    name = "machine_translation"
    m = seq_model(fluid, name)
    state = seq_state(fluid, m, SEED + 114, dev)
    feed = seq_feed(name, np.random.RandomState(SEED + 115),
                    SEQ_MODELS[name]["batch"])
    runs = {}
    for cache in (False, True):
        exe, scope = fluid.Executor(device=dev), fluid.Scope()
        fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
        c0 = executor_mod.compile_count()
        losses = [np.asarray(exe.run(m["main"], feed=feed,
                                     fetch_list=[m["loss"]], scope=scope,
                                     use_program_cache=cache)[0])
                  for _ in range(SEQ_BOUND_STEPS)]
        bound = [b for b in exe._bound.values() if b.program is m["main"]]
        runs[cache] = {"losses": losses, "captures":
                       executor_mod.compile_count() - c0,
                       "graphs": sum(b.graph is not None for b in bound),
                       "entries": len(bound),
                       "state": {n: fluid.executor.as_numpy(scope[n])
                                 for n in state}}
    g, e = runs[True], runs[False]
    bitwise = (all(a.tobytes() == b.tobytes()
                   for a, b in zip(g["losses"], e["losses"]))
               and all(g["state"][n].tobytes() == e["state"][n].tobytes()
                       for n in state))
    check(g["entries"] == 1 and g["graphs"] == 1 and g["captures"] == 1
          and e["captures"] == 0 and bitwise,
          "machine translation's step not bound and replayed bitwise",
          g["entries"], g["graphs"], g["captures"], e["captures"], bitwise)
    return {"steps": SEQ_BOUND_STEPS, "entries": g["entries"],
            "captures": g["captures"], "replays_bitwise_eager": bitwise,
            "persistables": len(state),
            "losses": [float(v.reshape(-1)[0]) for v in g["losses"]]}


def seq_decode(fluid, dev, gen, program, state, src):
    scope = fluid.Scope()
    fluid.load_numpy_state(program, state, scope=scope, device=dev)
    return fluid.Executor(device=dev).run(
        program, feed={"src_word": src},
        fetch_list=[gen["ids"].name, gen["scores"].name], scope=scope,
        return_numpy=False)


def seq_generate(torch, fluid, dev, trained):
    """Machine translation's beam search (beam SEQ_BEAM, max_length
    SEQ_MAX_LEN, the While Program) from its startup's parameters with
    every trained one of the same name and shape carried over from
    ``trained`` (the training scope): on SEQ_GEN_CHECK_SOURCES sources in
    float64 on the card and on the port's CPU path, the ids and both
    levels of lengths bitwise, the scores within BEAM_SCORE_RTOL; then
    the training batch's sources in float32 on the card: every score
    finite and non-increasing within a source, every id in the
    vocabulary, every length in [1, max_length], ``beam`` rows a source,
    the fast path refusing it (``while``); sentences a second, and the
    float32 decode's agreement with the float64 one (recorded)."""
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.models import machine_translation as MT

    name = "machine_translation"
    kw = SEQ_MODELS[name]["kw"]
    gen = seq_model(fluid, name, is_generating=True, beam_size=SEQ_BEAM,
                    max_length=SEQ_MAX_LEN)
    cpu = torch.device("cpu")
    state = seq_state(fluid, gen, SEED + 116, cpu)
    carried = [n for n in state if n in trained
               and tuple(trained[n].shape) == state[n].shape]
    for n in carried:
        state[n] = fluid.executor.as_numpy(trained[n])
    src = seq_words(np.random.RandomState(SEED + 117), kw["batch_size"],
                    kw["seq_len"], kw["dict_size"], MT.PAD_IDX)
    few = src[:SEQ_GEN_CHECK_SOURCES]
    p64 = widened(fluid, gen["main"])
    card64 = seq_decode(fluid, dev, gen, p64, state, few)
    t0 = time.perf_counter()
    cpu64 = seq_decode(fluid, cpu, gen, p64, state, few)
    cpu_s = time.perf_counter() - t0
    for field in ("data", "lengths", "sub_lengths"):
        check(np.array_equal(getattr(card64[0], field),
                             getattr(cpu64[0], field)),
              "generation float64 card vs cpu", field)
    ref = np.asarray(cpu64[1].data)
    rel = float(np.max(np.abs(np.asarray(card64[1].data) - ref)
                       / np.maximum(np.abs(ref), 1e-300)))
    check(rel <= BEAM_SCORE_RTOL, "generation float64 scores card vs cpu", rel)
    refused = observability.counter("executor.graph_refused", {"op": "while"})
    r0 = refused.value
    exe, scope = fluid.Executor(device=dev), fluid.Scope()
    fluid.load_numpy_state(gen["main"], state, scope=scope, device=dev)
    walls = []
    for _ in range(SEQ_GEN_RUNS):
        t0 = time.perf_counter()
        ids, scores = exe.run(gen["main"], feed={"src_word": src},
                              fetch_list=[gen["ids"], gen["scores"]],
                              scope=scope, return_numpy=False)
        walls.append(time.perf_counter() - t0)
    n = len(src)
    sc = np.asarray(scores.data).reshape(n, SEQ_BEAM)
    check(bool(np.isfinite(sc).all()) and bool((np.diff(sc, axis=1) <= 0).all())
          and bool(((ids.data >= 0) & (ids.data < kw["dict_size"])).all())
          and bool(((ids.lengths >= 1) & (ids.lengths <= SEQ_MAX_LEN)).all())
          and ids.sub_lengths.tolist() == [SEQ_BEAM] * n
          and refused.value - r0 == SEQ_GEN_RUNS,
          "machine translation's beam search", ids.lengths.tolist(),
          refused.value - r0)
    f32_few = [r[:SEQ_GEN_CHECK_SOURCES * SEQ_BEAM] for r in (ids.data,
                                                            ids.lengths)]
    wall = float(np.median(walls))
    return {"carried_parameters": len(carried), "parameters": len(state),
            "check_sources": SEQ_GEN_CHECK_SOURCES,
            "float64_ids_equal": True, "float64_scores_rel": rel,
            "cpu64_decode_s": cpu_s,
            "float32_vs_float64_tokens_equal": int(
                (f32_few[0] == card64[0].data).sum()),
            "float32_vs_float64_lengths_equal": int(
                (f32_few[1] == card64[0].lengths).sum()),
            "tokens": int(card64[0].data.size),
            "sources": n, "beam": SEQ_BEAM, "max_length": SEQ_MAX_LEN,
            "decode_ms_all": [t * 1e3 for t in walls], "decode_ms": wall * 1e3,
            "sentences_per_s": n / wall, "graph_refused_by": "while",
            "hyp_len_mean": float(ids.lengths.mean())}


def sequence_phase(torch, fluid, fa, dev):
    """The sequence slice on the card: the sequence op rules,
    StaticRNN/DynamicRNN and the rank table in float64 against the CPU
    (seq_ops_check); the stacked LSTM, the recommender and machine
    translation (SEQ_MODELS) at full width, each float32 card step held
    to the CPU's float64 step (seq_check) and SEQ_STEPS training steps
    (seq_train); machine translation's step bound and replayed bitwise
    (seq_bound_check) and its beam search (seq_generate) on the trained
    weights; and what a ragged feed costs: the stacked LSTM's Program fed
    a dense batch of the same padded shape binds, against the ragged
    feed's op-by-op steps.  No kernel of this repo runs: B1-B5 launch 0
    times in the phase."""
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = {"ops": seq_ops_check(torch, fluid, dev)}
    seconds = {"ops": time.perf_counter() - t0}
    log("sequence ops, card vs cpu float64: %s" % json.dumps(out["ops"]))
    trained = None
    for name in SEQ_MODELS:
        t1 = time.perf_counter()
        chk = seq_check(torch, fluid, name, dev)
        t2 = time.perf_counter()
        trn, _, scope, m, _ = seq_train(torch, fluid, name, dev)
        out[name] = {"check": chk, "train": trn}
        if name == "machine_translation":
            trained = {n: scope[n] for n in m["main"].persistable_names()
                       if n in scope}
        seconds[name] = {"check": t2 - t1, "train": time.perf_counter() - t2}
        log("%s (full width, TF32 off): %s" % (name, json.dumps(out[name])))
        del scope, m
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    dense, *_ = seq_train(torch, fluid, "stacked_dynamic_lstm", dev, dense=True)
    ragged = out["stacked_dynamic_lstm"]["train"]
    check(dense["bound"] and dense["captures"] == 1 and not ragged["bound"]
          and ragged["captures"] == 0,
          "the LSTM bound ragged or did not bind dense", dense["bound"],
          dense["captures"], ragged["bound"])
    out["ragged_vs_dense"] = {
        "dense": dense, "ragged_step_ms": ragged["step_ms"],
        "dense_step_ms": dense["step_ms"],
        "ragged_over_dense": ragged["step_ms"] / dense["step_ms"],
        "ragged_launches_per_step": ragged.get("launches_per_step"),
        "dense_launches_per_step": dense.get("launches_per_step"),
        "ragged_idle_share": ragged.get("idle_share"),
        "dense_idle_share": dense.get("idle_share"),
        "ragged_idle_share_of_step": ragged.get("idle_share_of_step"),
        "dense_idle_share_of_step": dense.get("idle_share_of_step")}
    seconds["ragged_vs_dense"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["bound"] = seq_bound_check(torch, fluid, dev)
    out["generation"] = seq_generate(torch, fluid, dev, trained)
    seconds["bound_and_generation"] = time.perf_counter() - t1
    del trained
    torch.cuda.empty_cache()
    launches = dict(fa.KERNEL_LAUNCHES)
    check(not any(launches.values()), "a kernel launched in the sequence "
          "phase", launches)
    out["launches"] = launches
    out["seconds"] = seconds
    log("sequence phase: %s" % json.dumps(
        {k: out[k] for k in ("ragged_vs_dense", "bound", "generation",
                             "launches", "seconds")}))
    return out


# ---------------------------------------------------------------------------
# the structured-prediction slice: CTC, edit distance, the linear-chain
# CRF, chunk_eval, NCE and hsigmoid, with the CRNN-CTC OCR model, the
# semantic-role labeler and word2vec's sampled heads
# ---------------------------------------------------------------------------

# tests/test_torch_struct_ops.py's warpctc cases: (logit lengths, label
# lengths, blank, fixed label rows, norm_by_times); 6 classes, 9 frames
STRUCT_CTC_CASES = {
    "blank first": ([7, 5, 6], [3, 2, 2], 0, None, False),
    "blank last": ([7, 5, 6], [3, 2, 2], 5, None, False),
    "repeats": ([9, 5, 4], [4, 2, 2], 0, [[2, 2, 3, 3], [1, 1], [4, 4]],
                False),
    "last label is the pad id": ([6, 6, 5], [3, 2, 1], 5,
                                 [[3, 1, 0], [2, 0], [0]], False),
    "label too long": ([7, 3, 6], [3, 4, 2], 0, [[1, 2, 3], [2, 2, 3, 3]],
                       False),
    "zero-length logits": ([6, 0, 5], [2, 0, 2], 0, None, False),
    "norm_by_times": ([7, 5, 6], [3, 2, 2], 0, None, True),
}


def struct_op_cases(fluid):
    """The cases of tests/test_torch_struct_ops.py in float64 (seq_op_cases'
    form, for seq_case_program): every rule, ``warpctc`` with its label
    also fed as [B, U, 1] rows (R-7), ``ctc_align`` raw and through the
    greedy decoder, ``crf_decoding`` with Viterbi ties, ``chunk_eval``
    under the four schemes with and without excluded types, ``nce`` with
    fixed negatives and ``hsigmoid`` over every label."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    cases = []
    rng = np.random.RandomState(SEED + 130)

    def add(label, feeds, body, lod=()):
        cases.append(dict(label=label, feeds=feeds, body=body, lod=lod,
                          ties={}))

    def ids(lens, lo, hi, T=None, rows=()):
        data, lens = seq_ragged(rng, lens, T or max(lens), ints=(lo, hi))
        for b, row in enumerate(rows):
            data[b, :len(row)] = row
        return data, lens

    for name, (lens, label_lens, blank, rows, norm) in STRUCT_CTC_CASES.items():
        y = ids(label_lens, *((1, 6) if blank == 0 else (0, 5)),
                rows=rows or ())
        feeds = {"x": seq_ragged(rng, lens, 9, (6,)), "y": y}
        body = (lambda L, v, b=blank, n=norm:
                [L.warpctc(v["x"], v["y"], blank=b, norm_by_times=n)])
        add("warpctc " + name, feeds, body)
        if name == "blank first":
            add("warpctc label rows (R-7)",
                {"x": feeds["x"], "y": (y[0][..., None], y[1])}, body)
    x = rng.rand(3, 7, 3)
    x[0, np.arange(7), [0, 1, 1, 0, 2, 2, 0]] = 5.0
    add("ctc_greedy_decoder", {"x": (x, np.array([7, 5, 0], np.int32))},
        lambda L, v: [L.ctc_greedy_decoder(v["x"], blank=0)], lod=(0,))
    for merge in (True, False):
        def align(L, v, merge=merge):
            helper = LayerHelper("ctc_align")
            out = helper.create_variable_for_type_inference(dtype="int64")
            helper.append_op(type="ctc_align", inputs={"Input": [v["ids"]]},
                             outputs={"Output": [out]},
                             attrs={"blank": 0, "merge_repeated": merge})
            return [out]
        add("ctc_align merge=%s" % merge,
            {"ids": ids([8, 3, 0, 8], 0, 3, T=8,
                        rows=[[1, 1, 0, 1, 2, 2, 2, 0], [0, 0, 0]])},
            align, lod=(0,))
    for name, (hl, rl) in {"ragged": ([4, 6, 1, 5], [5, 3, 2, 5]),
                           "empty hypotheses": ([0, 3, 0], [2, 4, 0]),
                           "empty references": ([3, 0, 5], [0, 0, 2])}.items():
        for norm in (False, True):
            add("edit_distance %s normalized=%s" % (name, norm),
                {"h": ids(hl, 0, 5, T=6), "r": ids(rl, 0, 5, T=6)},
                lambda L, v, n=norm: list(L.edit_distance(v["h"], v["r"],
                                                          normalized=n)))

    def crf(L, v):
        attr = fluid.ParamAttr(name="crfw")
        nll = L.linear_chain_crf(v["x"], v["y"], param_attr=attr)
        (op,) = [o for o in fluid.default_main_program().global_block().ops
                 if o.type == "linear_chain_crf"]
        alpha = fluid.default_main_program().global_block().var(
            op.outputs["Alpha"][0])
        return [nll, alpha, L.crf_decoding(v["x"], attr),
                L.crf_decoding(v["x"], attr, label=v["y"])]

    for name, (lens, T) in {"ragged": ([3, 2, 6, 4], 6),
                            "lengths 0 and 1": ([0, 1, 5, 1], 5)}.items():
        add("linear_chain_crf and crf_decoding " + name,
            {"x": seq_ragged(rng, lens, T, (4,)), "y": ids(lens, 0, 4, T=T)},
            crf, lod=(2, 3))

    def ties(L, v):
        attr = fluid.ParamAttr(name="crfw",
                               initializer=fluid.initializer.Constant(0.0))
        L.linear_chain_crf(v["x"], v["y"], param_attr=attr)
        return [L.crf_decoding(v["x"], attr)]

    e = _f64([[[1, 1, 0, 1], [2, 0, 2, 2], [0, 0, 0, 0]],
              [[0, 3, 3, 1], [1, 1, 1, 1], [5, 2, 5, 5]]])
    add("crf_decoding ties", {"x": (e, np.array([3, 2], np.int32)),
                              "y": ids([3, 2], 0, 4, T=3)}, ties, lod=(0,))
    for scheme, hi in (("IOB", 7), ("IOE", 7), ("IOBES", 13), ("plain", 4)):
        for excluded in (None, [1]):
            lens = [8, 6, 10, 0, 9]
            lab = ids(lens, 0, hi, T=10)
            inf = (np.where(rng.rand(5, 10) < 0.3,
                            rng.randint(0, hi, (5, 10)), lab[0]), lab[1])
            add("chunk_eval %s excluded=%s" % (scheme, excluded),
                {"i": inf, "l": lab},
                lambda L, v, s=scheme, x=excluded: list(L.chunk_eval(
                    v["i"], v["l"], chunk_scheme=s, num_chunk_types=3,
                    excluded_chunk_types=x)))

    def nce(L, v, weighted):
        cost = L.nce(v["x"], v["y"], num_total_classes=8, num_neg_samples=4,
                     sample_weight=v["w"] if weighted else None)
        blk = fluid.default_main_program().global_block()
        (op,) = [o for o in blk.ops if o.type == "nce"]
        op.attrs["custom_neg_classes"] = [1, 4, 6, 1]
        return [cost] + [blk.var(op.outputs[s][0])
                         for s in ("SampleLogits", "SampleLabels")]

    for weighted in (False, True):
        feeds = {"x": rng.randn(6, 5), "y": rng.randint(0, 8, (6, 1))}
        if weighted:
            feeds["w"] = rng.rand(6, 1)
        add("nce fixed negatives weighted=%s" % weighted, feeds,
            lambda L, v, w=weighted: nce(L, v, w))
    for classes in (2, 6, 8, 11):
        for bias in (True, False):
            add("hsigmoid classes=%d bias=%s" % (classes, bias),
                {"x": rng.randn(2 * classes, 5),
                 "y": (np.arange(2 * classes) % classes)[:, None]},
                lambda L, v, c=classes, b=bias: [L.hsigmoid(
                    v["x"], v["y"], num_classes=c,
                    bias_attr=None if b else False)])
    return cases


def op_cases_check(torch, fluid, dev, cases, what):
    """``cases`` (seq_op_cases' form) on the card in float64 against the
    port's CPU, by seq_ops_check's method: each output and gradient
    within OPS_RTOL of its largest magnitude, integer outputs and lengths
    exactly, and a case's ``exact`` fetches (fetch index -> None for the
    whole array or a column) bitwise."""
    cpu = torch.device("cpu")
    worst = {}
    for case in cases:
        prog = seq_case_program(fluid, case)
        sc = fluid.Scope()
        fluid.Executor(device=cpu).run(prog[1], scope=sc)
        state = {n: sc[n].numpy() for n in prog[0].persistable_names()
                 if n in sc}
        want = seq_case_run(fluid, case, prog, state, cpu)
        got = seq_case_run(fluid, case, prog, state, dev)
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            check(g.shape == w.shape and g.dtype == w.dtype, case["label"],
                  g.shape, w.shape, g.dtype, w.dtype)
            if w.dtype.kind == "f":
                scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-300)
                e = float(np.max(np.abs(g - w), initial=0.0)) / scale
                err = max(err, e)
                check(e <= OPS_RTOL, what + " on the card vs cpu",
                      case["label"], i, e)
            else:
                check(np.array_equal(g, w), what + " on the card vs cpu",
                      case["label"], i, g, w)
            col = case.get("exact", {}).get(i, False)
            if col is not False:
                a, b = (g, w) if col is None else (g[..., col], w[..., col])
                check(a.tobytes() == b.tobytes(), what + " not bitwise on "
                      "the card", case["label"], i)
        worst[case["label"]] = err
    return {"cases": len(cases), "worst_rel_err": max(worst.values()),
            "worst_case": max(worst, key=worst.get)}


def struct_ops_check(torch, fluid, dev):
    """struct_op_cases by op_cases_check: ``ctc_align``'s ids,
    ``crf_decoding``'s paths with its ties, ``chunk_eval``'s counts, the
    sample labels and the lengths exactly."""
    return op_cases_check(torch, fluid, dev, struct_op_cases(fluid),
                          "struct op")


def struct_feed(name, rng, n):
    """``n`` seeded samples for ``name``: OCR's standard normal images and
    labels of STRUCT_LABEL_LENS ids of its classes, fed as [L] rows (a
    LoDArray of [n, 12] ids); SRL's 8 slots over sentences of
    STRUCT_SRL_LENS tokens (LoDArrays of [n, 64, 1] ids), the tags
    uniform over the 11."""
    from paddle_tpu_torch.lod import LoDArray
    from paddle_tpu_torch.models import label_semantic_roles as SRL
    from paddle_tpu_torch.models import ocr_crnn_ctc as OCR

    kw = STRUCT_MODELS[name]["kw"]
    if name == "ocr_crnn_ctc":
        lo, hi = STRUCT_LABEL_LENS
        shape = kw.get("data_shape") or OCR.DATA_SHAPE
        classes = kw.get("num_classes", OCR.NUM_CLASSES)
        return {"pixel": rng.randn(n, *shape).astype(np.float32),
                "label": LoDArray(rng.randint(0, classes, size=(n, hi))
                                  .astype(np.int64),
                                  rng.randint(lo, hi + 1, size=n))}
    lo, hi = STRUCT_SRL_LENS
    lens = rng.randint(lo, hi + 1, size=n)
    vocab = dict.fromkeys(SRL.FEED_NAMES[:-1], SRL.WORD_VOCAB)
    vocab.update(mark=SRL.MARK_DICT_LEN, target=SRL.LABEL_VOCAB)
    return {k: LoDArray(rng.randint(0, v, size=(n, hi, 1)).astype(np.int64),
                        lens) for k, v in vocab.items()}


def struct_f32_ok(name, e):
    """OCR and SSD: each of their ``f32`` limits; SRL: the loss and every
    gradient within its ``f32_rtol``."""
    cfg = seq_cfg(name)
    if "f32" in cfg:
        return all(e[k] <= v for k, v in cfg["f32"].items())
    return (e["loss_rel"] <= cfg["f32_rtol"]
            and e["grad_worst_of_max"] <= cfg["f32_rtol"])


def struct_check(torch, fluid, name, dev):
    """resnet_check's method for ``name`` at full width, batch
    ``check_batch``: one step from one set of numpy parameters on the
    card and on the port's CPU path in float64 (the Program widened;
    loss LOSS_RTOL, each gradient GRAD_RTOL of its max, the running
    statistics RESNET_STAT_RTOL), and in float32 with TF32 off against
    the CPU's float64 step (struct_f32_ok), the CPU's float32 step too,
    and a float32 step with TF32 on, which must fail struct_f32_ok."""
    cpu = torch.device("cpu")
    m = seq_model(fluid, name)
    state = seq_state(fluid, m, SEED + 120, cpu)
    feed = struct_feed(name, np.random.RandomState(SEED + 121),
                       STRUCT_MODELS[name]["check_batch"])
    main64 = widened(fluid, m["main"])
    fc = last_fc(m)
    t0 = time.perf_counter()
    cpu64 = seq_step(torch, fluid, m, main64, state, feed, cpu)
    cpu32 = seq_step(torch, fluid, m, m["main"], state, feed, cpu)
    cpu_s = time.perf_counter() - t0
    card64 = seq_step(torch, fluid, m, main64, state, feed, dev)
    card32 = seq_step(torch, fluid, m, m["main"], state, feed, dev)
    tf32 = seq_step(torch, fluid, m, m["main"], state, feed, dev, tf32=True)
    e64 = resnet_errors(card64, cpu64, fc)
    check(e64["loss_rel"] <= LOSS_RTOL and e64["grad_worst_of_max"]
          <= GRAD_RTOL and e64["stat_worst_of_max"] <= RESNET_STAT_RTOL,
          name + " float64 card vs cpu", e64)
    out = {"float64_card_vs_cpu": e64,
           "float32_card_vs_cpu64": resnet_errors(card32, cpu64, fc),
           "float32_cpu_vs_cpu64": resnet_errors(cpu32, cpu64, fc),
           "tf32_card_vs_cpu64": resnet_errors(tf32, cpu64, fc),
           "f32_limits": STRUCT_MODELS[name].get(
               "f32", STRUCT_MODELS[name].get("f32_rtol")),
           "loss": {"cpu64": cpu64["loss"], "card64": card64["loss"],
                    "cpu32": cpu32["loss"], "card32": card32["loss"],
                    "tf32": tf32["loss"]},
           "batch": STRUCT_MODELS[name]["check_batch"], "cpu_steps_s": cpu_s}
    check(struct_f32_ok(name, out["float32_card_vs_cpu64"]),
          name + " float32 card vs cpu", out["float32_card_vs_cpu64"])
    check(struct_f32_ok(name, out["float32_cpu_vs_cpu64"]),
          name + " float32 cpu vs cpu float64", out["float32_cpu_vs_cpu64"])
    check(not struct_f32_ok(name, out["tf32_card_vs_cpu64"]),
          name + " limits pass a TF32 step", out["tf32_card_vs_cpu64"])
    return out


def ocr_test_pass(fluid, exe, scope, m, feed):
    """The OCR test Program (cloned before Adam) on the training batch:
    its greedy decode (``ctc_align``'s ids and lengths), the edit
    distance of each row (finite, normalized, in [0, inf)) and the
    sequence count (the batch)."""
    (align,) = [op for op in m["test"].global_block().ops
                if op.type == "ctc_align"]
    dec, err, num = exe.run(
        m["test"], feed=feed, scope=scope, return_numpy=False,
        fetch_list=[align.outputs["Output"][0], m["error"], m["seq_num"]])
    err, num = (fluid.executor.as_numpy(t) for t in (err, num))
    n = len(feed["pixel"])
    check(dec.data.shape[0] == n and (dec.lengths <= dec.data.shape[1]).all()
          and err.shape == (n, 1) and np.isfinite(err).all()
          and (err >= 0).all() and int(num) == n,
          "OCR's test Program", dec.data.shape, err.shape, int(num))
    return {"decoded_lengths": dec.lengths.tolist(),
            "edit_distance_mean": float(err.mean()), "seq_num": int(num)}


def srl_decode(torch, fluid, dev, exe, scope, m, feed):
    """SRL's Viterbi decode (the main Program pruned to ``decode``) on the
    trained weights, timed over STRUCT_DECODE_RUNS runs (tokens a second),
    then one ``chunk_eval`` (IOB, SRL_CHUNK_TYPES types) of the decode
    against the tags, widened to float64, on the card and on the CPU:
    every output equal."""
    from paddle_tpu_torch.lod import LoDArray
    from paddle_tpu_torch.models import label_semantic_roles as SRL

    dec = m["main"].prune([m["decode"]])
    words = {k: feed[k] for k in SRL.FEED_NAMES}
    walls = []
    for _ in range(STRUCT_DECODE_RUNS):
        t0 = time.perf_counter()
        (path,) = exe.run(dec, feed=words, fetch_list=[m["decode"]],
                          scope=scope, return_numpy=False)
        walls.append(time.perf_counter() - t0)
    tags = feed["target"]
    check(np.array_equal(path.lengths, tags.lengths)
          and ((path.data >= 0) & (path.data < SRL.LABEL_VOCAB)).all(),
          "SRL's Viterbi path", path.lengths.tolist())
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        inf = fluid.layers.data(name="inf", shape=[1], dtype="int64",
                                lod_level=1)
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64",
                                lod_level=1)
        outs = fluid.layers.chunk_eval(inf, lab, chunk_scheme="IOB",
                                       num_chunk_types=SRL_CHUNK_TYPES)
    main = widened(fluid, main)
    chunk_feed = {"inf": LoDArray(path.data[..., None], path.lengths),
                  "lab": tags}
    got, want = ([np.asarray(o) for o in fluid.Executor(device=d).run(
        main, feed=chunk_feed, fetch_list=[o.name for o in outs],
        scope=fluid.Scope())] for d in (dev, torch.device("cpu")))
    check(all(g.tobytes() == w.tobytes() and g.dtype == w.dtype
              for g, w in zip(got, want)),
          "chunk_eval of the decode, card vs cpu", got, want)
    wall = float(np.median(walls))
    tokens = int(path.lengths.sum())
    return {"decode_ms_all": [t * 1e3 for t in walls], "decode_ms": wall * 1e3,
            "tokens": tokens, "decode_tokens_per_s": tokens / wall,
            "chunk_eval": {"precision": float(got[0]), "recall": float(got[1]),
                           "f1": float(got[2]), "infer_chunks": int(got[3]),
                           "label_chunks": int(got[4]),
                           "correct_chunks": int(got[5])},
            "chunk_eval_card_equals_cpu": True}


def struct_w2v_cfg(head):
    """ZOO's word2vec with the ``head`` output layer."""
    z = ZOO["word2vec"]
    return dict(z, kw=dict(z["kw"], loss_type=head))


def struct_w2v_bound(torch, fluid, head, dev):
    """word2vec's ``head`` step from one start state in two scopes:
    STRUCT_W2V_BOUND_STEPS steps op by op and as many through the fast
    path (eager, capture, replays): one bound entry and one capture, the
    losses and every persistable bitwise equal; the NCE head's negatives
    (SampleLabels, drawn from its generator) bitwise too, every id in
    [0, vocab), and each step's draws new."""
    from paddle_tpu_torch import executor as executor_mod

    cfg = struct_w2v_cfg(head)
    m = zoo_model(fluid, "word2vec", cfg=cfg)
    # the run seed of both scopes (a Program without one draws a random
    # seed a scope)
    m["main"].random_seed = SEED + 142
    state = seq_state(fluid, m, SEED + 140, dev)
    feed = {k: torch.as_tensor(v, device=dev) for k, v in zoo_feed(
        "word2vec", m, np.random.RandomState(SEED + 141), cfg["batch"],
        cfg=cfg).items()}
    fetch = [m["loss"]]
    if head == "nce":
        (op,) = [o for o in m["main"].global_block().ops if o.type == "nce"]
        fetch.append(op.outputs["SampleLabels"][0])
    runs = {}
    for cache in (False, True):
        exe, scope = fluid.Executor(device=dev), fluid.Scope()
        fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
        c0 = executor_mod.compile_count()
        outs = [[np.asarray(o) for o in exe.run(
            m["main"], feed=feed, fetch_list=fetch, scope=scope,
            use_program_cache=cache)] for _ in range(STRUCT_W2V_BOUND_STEPS)]
        bound = [b for b in exe._bound.values() if b.program is m["main"]]
        runs[cache] = {"outs": outs, "captures":
                       executor_mod.compile_count() - c0,
                       "graphs": sum(b.graph is not None for b in bound),
                       "entries": len(bound),
                       "state": {n: fluid.executor.as_numpy(scope[n])
                                 for n in state}}
    g, e = runs[True], runs[False]
    bitwise = (all(a.tobytes() == b.tobytes() for sa, sb in
                   zip(g["outs"], e["outs"]) for a, b in zip(sa, sb))
               and all(g["state"][n].tobytes() == e["state"][n].tobytes()
                       for n in state))
    check(g["entries"] == 1 and g["graphs"] == 1 and g["captures"] == 1
          and e["captures"] == 0 and bitwise,
          "word2vec's %s step not bound and replayed bitwise" % head,
          g["entries"], g["graphs"], g["captures"], e["captures"], bitwise)
    out = {"steps": STRUCT_W2V_BOUND_STEPS, "entries": g["entries"],
           "captures": g["captures"], "replays_bitwise_eager": bitwise,
           "losses": [float(s[0].reshape(-1)[0]) for s in g["outs"]]}
    if head == "nce":
        draws = [s[1][:, 1:] for s in g["outs"]]
        vocab = cfg["kw"]["vocab_size"]
        check(all(((d >= 0) & (d < vocab)).all() for d in draws)
              and all(a.tobytes() != b.tobytes()
                      for a, b in zip(draws, draws[1:])),
              "NCE's draws out of range or repeated between steps")
        out["draws_per_step"] = int(draws[0].size)
        out["distinct_ids_drawn"] = int(len(np.unique(np.stack(draws))))
    return out


def struct_phase(torch, fluid, fa, dev, softmax_head):
    """The structured-prediction slice on the card: the 8 struct op rules
    in float64 against the CPU (struct_ops_check); the CRNN-CTC OCR model
    and the semantic-role labeler (STRUCT_MODELS) at full width, each
    card step held to the CPU's (struct_check) and ``steps`` training
    steps (seq_train: losses finite and falling, step ms, units a
    second, launches a step, idle share, peak memory); a pass of OCR's
    test Program through the greedy decoder and ``edit_distance``
    (ocr_test_pass); SRL's Viterbi decode and a ``chunk_eval`` of it
    (srl_decode); word2vec's NCE and hsigmoid heads at the zoo's widths,
    each step bound and bitwise its op-by-op steps (struct_w2v_bound),
    then ZOO_STEPS steps (zoo_train) beside the softmax head's
    (``softmax_head``, zoo_phase's figures).  No kernel of this repo
    runs: B1-B5 launch 0 times in the phase."""
    fa.reset_launch_counts()
    card = card_line()
    t0 = time.perf_counter()
    out = {"card": card, "ops": struct_ops_check(torch, fluid, dev)}
    seconds = {"ops": time.perf_counter() - t0}
    log("struct ops, card vs cpu float64 (%s): %s"
        % (card, json.dumps(out["ops"])))
    for name in STRUCT_MODELS:
        t1 = time.perf_counter()
        chk = struct_check(torch, fluid, name, dev)
        t2 = time.perf_counter()
        trn, exe, scope, m, feed = seq_train(torch, fluid, name, dev)
        out[name] = {"check": chk, "train": trn}
        if name == "ocr_crnn_ctc":
            out[name]["test_pass"] = ocr_test_pass(fluid, exe, scope, m, feed)
        else:
            out[name]["decode"] = srl_decode(torch, fluid, dev, exe, scope,
                                             m, feed)
        seconds[name] = {"check": t2 - t1, "train": time.perf_counter() - t2}
        log("%s (full width, TF32 off, %s): %s"
            % (name, card, json.dumps(out[name])))
        del exe, scope, m
        torch.cuda.empty_cache()
    for head in STRUCT_W2V_HEADS:
        t1 = time.perf_counter()
        bound = struct_w2v_bound(torch, fluid, head, dev)
        trn = zoo_train(torch, fluid, "word2vec", dev,
                        cfg=struct_w2v_cfg(head))
        out["word2vec_" + head] = {
            "bound": bound, "train": trn,
            "softmax_head": {k: softmax_head[k] for k in (
                "step_ms", "words_per_s", "replay_idle_share")}}
        seconds["word2vec_" + head] = time.perf_counter() - t1
        log("word2vec %s head (zoo width, TF32 off, %s): %s"
            % (head, card, json.dumps(out["word2vec_" + head])))
        torch.cuda.empty_cache()
    launches = dict(fa.KERNEL_LAUNCHES)
    check(not any(launches.values()), "a kernel launched in the struct "
          "phase", launches)
    out["launches"] = launches
    out["seconds"] = seconds
    log("struct phase: %s" % json.dumps({k: out[k] for k in (
        "card", "launches", "seconds")}))
    return out


# ---------------------------------------------------------------------------
# the detection slice: prior boxes and anchors, IoU, matching, box coding,
# target assignment, the SSD loss, multiclass NMS, the RPN and RCNN
# sampling rules, the EAST transforms and the in-graph mAP, with
# MobileNet-SSD
# ---------------------------------------------------------------------------


def det_boxes(rng, shape, span=0.5):
    """Random ``[..., 4]`` corner boxes: a corner in [0, span), a size in
    [0, span)."""
    xy = rng.rand(*shape, 2) * span
    return np.concatenate([xy, xy + rng.rand(*shape, 2) * span], -1)


def det_op_cases(fluid):
    """The cases of tests/test_torch_detection_ops.py in float64
    (seq_op_cases' form, for seq_case_program), each with the fetches
    that must come back bitwise (``exact``: fetch index -> None for the
    whole array or a column): the prior and anchor tables under clip,
    flip and the min-max order; IoU of random and degenerate boxes and
    with X's lengths; ``bipartite_match`` under both match types over
    ties and a row of no ground truth; ``box_coder`` both ways and
    unnormalized; ``target_assign``; ``ssd_loss`` (a row without ground
    truth, mining capped) with ``detection_output``; ``multiclass_nms``
    over equal scores, all under the threshold and ``keep_top_k`` above
    the survivors; ``polygon_box_transform``; ``generate_proposals``;
    ``rpn_target_assign`` and ``generate_proposal_labels`` with padded
    and missing ground truth; ``roi_perspective_transform``;
    ``detection_map`` (integral and 11point, difficult boxes, a fed
    state)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    cases = []
    rng = np.random.RandomState(SEED + 150)

    def add(label, feeds, body, lod=(), exact=None, grad=True):
        cases.append(dict(label=label, feeds=feeds, body=body, lod=lod,
                          ties={}, exact=exact or {}, grad=grad))

    def priors(L, v):
        out = []
        for clip in (False, True):
            for flip in (False, True):
                for order in (False, True):
                    out += L.prior_box(
                        input=v["fm"], image=v["img"], min_sizes=[7.0, 11.0],
                        max_sizes=[15.0, 21.0], aspect_ratios=[2.0, 3.0],
                        flip=flip, clip=clip, min_max_aspect_ratios_order=order)
        out += L.prior_box(input=v["fm"], image=v["img"], min_sizes=[8.0],
                           steps=[6.0, 7.0], offset=0.25,
                           variance=[0.3, 0.1, 0.7, 0.2])
        return out + list(L.anchor_generator(
            v["fm"], anchor_sizes=[32.0, 64.0, 128.0],
            aspect_ratios=[0.5, 1.0, 2.0], stride=[16.0, 12.0], offset=0.3))

    add("prior_box and anchor_generator",
        {"img": np.zeros((1, 3, 32, 30)), "fm": np.zeros((1, 8, 5, 4))},
        priors, exact=dict.fromkeys(range(20)), grad=False)
    degenerate = np.array([[0.1, 0.1, 0.1, 0.5], [0.3, 0.3, 0.3, 0.3],
                           [0.2, 0.2, 0.6, 0.6], [0.2, 0.2, 0.6, 0.6],
                           [0.6, 0.2, 0.9, 0.6]])
    iou = lambda L, v: [L.iou_similarity(v["x"], v["y"])]
    add("iou_similarity random", {"x": det_boxes(rng, (5,)),
                                  "y": det_boxes(rng, (7,))}, iou)
    add("iou_similarity degenerate", {"x": degenerate,
                                      "y": degenerate[::-1].copy()}, iou)
    add("iou_similarity lengths",
        {"x": (det_boxes(rng, (3, 4)), np.array([4, 0, 2], np.int32)),
         "y": det_boxes(rng, (6,))}, iou, lod=(0,))
    for mt in ("bipartite", "per_prediction"):
        for name, d in {
                "greedy": (np.array([[[0.9, 0.2, 0.1], [0.8, 0.7, 0.3]]]),
                           np.array([2], np.int32)),
                "ties": (rng.randint(0, 4, size=(3, 4, 9)) * 0.25,
                         np.array([3, 0, 4], np.int32))}.items():
            add("bipartite_match %s %s" % (mt, name), {"d": d},
                lambda L, v, mt=mt: list(L.bipartite_match(
                    v["d"], match_type=mt, dist_threshold=0.3)),
                exact={1: None})
    M = 6
    prior = np.sort(rng.rand(M, 2, 2), axis=1).reshape(M, 4)
    coder = {"p": prior, "v": np.full((M, 4), 0.1),
             "c": rng.randn(2, M, 4) * 0.2}
    for norm in (True, False):
        def code(L, v, norm=norm):
            dec = L.box_coder(v["p"], v["v"], v["c"], box_normalized=norm,
                              code_type="decode_center_size")
            return [dec, L.box_coder(v["p"], v["v"], dec, box_normalized=norm,
                                     code_type="encode_center_size")]
        add("box_coder normalized=%s" % norm, coder, code)
    midx = rng.randint(-1, 4, size=(3, 7)).astype(np.int32)
    add("target_assign", {"x": (rng.randn(3, 4, 2),
                                np.array([4, 1, 3], np.int32)), "m": midx},
        lambda L, v: list(L.target_assign(v["x"], v["m"],
                                          mismatch_value=-3)),
        exact={1: None})
    Mp, C, G = 24, 5, 3
    for name, lens, kw in (
            ("reference", [3, 2], {}),
            ("row without gt", [3, 0, 2], {}),
            ("bipartite, mining capped", [3, 2],
             dict(neg_pos_ratio=20.0, match_type="bipartite",
                  overlap_threshold=0.3))):
        B = len(lens)
        lens = np.array(lens, np.int32)
        feeds = {"l": rng.randn(B, Mp, 4) * 0.1, "c": rng.randn(B, Mp, C),
                 "gb": (np.sort(rng.rand(B, G, 2, 2), axis=2)
                        .reshape(B, G, 4), lens),
                 "gl": (rng.randint(1, C, size=(B, G)).astype(np.int64),
                        lens),
                 "p": np.sort(rng.rand(Mp, 2, 2), axis=1).reshape(Mp, 4),
                 "pv": np.full((Mp, 4), 0.1)}

        def ssd(L, v, kw=kw, full=name == "reference"):
            loss = L.ssd_loss(v["l"], v["c"], v["gb"], v["gl"], v["p"],
                              v["pv"], **kw)
            if not full:
                return [loss]
            return [loss, L.detection_output(v["l"], v["c"], v["p"], v["pv"],
                                             nms_threshold=0.45,
                                             keep_top_k=10)]
        add("ssd_loss " + name, feeds, ssd, lod=(1,) if name == "reference"
            else (), exact={1: 0} if name == "reference" else {})

    def nms(attrs):
        def body(L, v):
            a = dict(background_label=0, score_threshold=0.01,
                     nms_threshold=0.5, nms_top_k=400, keep_top_k=200,
                     nms_eta=1.0)
            a.update(attrs)
            helper = LayerHelper("multiclass_nms")
            out = helper.create_variable_for_type_inference(dtype="float32")
            helper.append_op(type="multiclass_nms",
                             inputs={"BBoxes": [v["b"]], "Scores": [v["s"]]},
                             outputs={"Out": [out]}, attrs=a)
            return [out]
        return body

    for name, (Bn, Cn, Mn, levels, attrs) in {
            "random": (2, 4, 12, None, dict(nms_top_k=8, keep_top_k=10)),
            "equal scores": (2, 4, 12, 3, dict(nms_top_k=9, keep_top_k=12)),
            "all under the threshold": (2, 4, 12, None,
                                        dict(score_threshold=1.5)),
            "keep_top_k above the survivors": (2, 3, 5, None,
                                               dict(keep_top_k=50)),
            "background 2": (2, 4, 12, None, dict(background_label=2,
                                                  nms_threshold=0.2))}.items():
        s = (rng.randint(0, levels, size=(Bn, Cn, Mn)) / float(levels)
             if levels else rng.rand(Bn, Cn, Mn))
        add("multiclass_nms " + name,
            {"b": det_boxes(rng, (Bn, Mn), 0.4), "s": s}, nms(attrs),
            lod=(0,), exact={0: None}, grad=False)
    add("polygon_box_transform", {"x": rng.randn(2, 4, 3, 5)},
        lambda L, v: [L.polygon_box_transform(v["x"])])
    A, H, W = 3, 4, 5
    anchors = np.zeros((H, W, A, 4))
    for i in range(H):
        for j in range(W):
            for a in range(A):
                cx, cy, sz = j * 10 + 5, i * 10 + 5, 6 + 4 * a
                anchors[i, j, a] = [cx - sz, cy - sz, cx + sz, cy + sz]
    add("generate_proposals",
        {"s": rng.rand(2, A, H, W), "d": rng.randn(2, 4 * A, H, W) * 0.1,
         "i": np.array([[32.0, 32.0, 1.0], [40.0, 36.0, 1.5]]),
         "a": anchors, "v": rng.uniform(0.5, 1.5, (H, W, A, 4))},
        lambda L, v: list(L.generate_proposals(
            v["s"], v["d"], v["i"], v["a"], v["v"], pre_nms_top_n=40,
            post_nms_top_n=12, nms_thresh=0.4, min_size=2.0)),
        lod=(0, 1), grad=False)
    for name, feeds, kw in (
            ("padded gt", {"g": (np.array([[[0, 0, 7, 7], [0, 0, 0, 0]]],
                                          np.float64), np.array([1], np.int32)),
                           "a": np.array([[0, 0, 10, 10], [50, 50, 60, 60]],
                                         np.float64)},
             dict(rpn_batch_size_per_im=2)),
            ("random", {"g": (det_boxes(rng, (2, 3), 40.0),
                              np.array([3, 1], np.int32)),
                        "a": det_boxes(rng, (30,), 40.0)},
             dict(rpn_batch_size_per_im=8, rpn_positive_overlap=0.5))):
        Bn, N = feeds["g"][0].shape[0], feeds["a"].shape[0]
        feeds.update(p=rng.randn(Bn, N, 4),
                     l=np.arange(Bn * N, dtype=np.float64).reshape(Bn, N, 1),
                     var=np.full((N, 4), 0.5))
        add("rpn_target_assign " + name, feeds,
            lambda L, v, kw=kw: list(L.rpn_target_assign(
                v["p"], v["l"], v["a"], v["var"], v["g"], **kw)),
            lod=(0, 1, 2, 3), exact={0: None, 1: None})
    for name, feeds, kw in (
            ("no gt", {"r": np.array([[[0, 0, 10, 10], [20, 20, 30, 30]]],
                                     np.float64),
                       "c": (np.zeros((1, 1), np.int64), np.zeros(1, np.int32)),
                       "b": (np.zeros((1, 1, 4)), np.zeros(1, np.int32))},
             dict(batch_size_per_im=4, class_nums=5)),
            ("random", {"r": (det_boxes(rng, (2, 9), 30.0),
                              np.array([9, 6], np.int32)),
                        "c": rng.randint(1, 6, size=(2, 3)).astype(np.int64),
                        "b": (det_boxes(rng, (2, 3), 30.0),
                              np.array([3, 2], np.int32))},
             dict(batch_size_per_im=10, fg_fraction=0.3, fg_thresh=0.3,
                  bg_thresh_hi=0.3, bg_thresh_lo=0.05, class_nums=6))):
        add("generate_proposal_labels " + name, feeds,
            lambda L, v, kw=kw: list(L.generate_proposal_labels(
                v["r"], v["c"], v["b"], **kw)),
            lod=(0, 1, 2, 3, 4), exact={0: None, 3: None})
    base = np.array([0, 0, 8, 0, 8, 6, 0, 6], np.float64)
    inset = np.array([1, 1, -1, 1, -1, -1, 1, -1], np.float64)
    add("roi_perspective_transform",
        {"x": rng.randn(1, 2, 7, 9),
         "r": base + inset * rng.uniform(0.2, 1.5, (3, 8))},
        lambda L, v: [L.roi_perspective_transform(v["x"], v["r"], 4, 5)])
    pad = [[-1, 0, 0, 0, 0, 0]]
    maps = {
        "two images": (np.array([[[1, 0.9, 0, 0, 1, 1],
                                  [1, 0.6, 5, 5, 6, 6]] + pad * 2,
                                 [[2, 0.8, 2, 2, 3, 3]] + pad * 3]),
                       np.array([[[0, 0, 1, 1], [0, 0, 0, 0]],
                                 [[2, 2, 3, 3], [5, 5, 6, 6]]]),
                       np.array([[1, 0], [2, 1]]), [1, 2], None, 3),
        "difficult": (np.array([[[1, 0.9, 0, 0, 1, 1],
                                 [1, 0.8, 4, 4, 5, 5]]]),
                      np.array([[[0, 0, 1, 1], [4, 4, 5, 5]]]),
                      np.array([[1, 1]]), [2], np.array([[1, 0]]), 2)}
    for name, (det, gtb, gtl, lens, diff, cls) in maps.items():
        for ap in ("integral", "11point"):
            feeds = {"d": det, "b": (gtb, np.array(lens, np.int32)),
                     "l": gtl.astype(np.int64)}
            if diff is not None:
                feeds["df"] = diff.astype(np.int64)

            def dmap(L, v, cls=cls, ap=ap):
                kw = {}
                if "df" in v:
                    kw = dict(gt_difficult=v["df"], evaluate_difficult=False)
                if "pc" in v:
                    kw["input_states"] = [v["pc"], v["tp"], v["fp"]]
                return list(L.detection_map(
                    v["d"], v["b"], v["l"], class_num=cls,
                    overlap_threshold=0.5, ap_version=ap, state_capacity=8,
                    **kw))
            add("detection_map %s %s" % (name, ap), feeds, dmap,
                exact={1: None, 2: None, 3: None}, grad=False)
            if name == "two images":
                tp = np.full((3, 8, 2), -1.0)
                tp[1, 0] = [0.95, 1.0]
                fp = np.full((3, 8, 2), -1.0)
                fp[1, :2] = [[0.97, 1.0], [0.4, 1.0]]
                add("detection_map fed a state %s" % ap,
                    dict(feeds, pc=np.array([[0], [2], [1]], np.int32),
                         tp=tp, fp=fp), dmap,
                    exact={1: None, 2: None, 3: None}, grad=False)
    return cases


def det_ops_check(torch, fluid, dev):
    """det_op_cases by op_cases_check, each case's ``exact`` fetches
    bitwise."""
    cases = det_op_cases(fluid)
    out = op_cases_check(torch, fluid, dev, cases, "detection op")
    out["exact_fetches"] = sum(len(c["exact"]) for c in cases)
    return out


def det_rpn_timed(torch, fluid, dev):
    """``generate_proposals`` at the op's defaults on DET_RPN's map
    (anchors from ``anchor_generator`` on the card), through
    Executor.run (op by op: its outputs carry lengths): ms a run (host
    clock around a synchronized run, the median of DET_RPN's runs after
    one warm-up), a profiled run's launches, busy time and idle share,
    and the proposals kept (each image at most post_nms_topN, all
    finite)."""
    c = DET_RPN
    B, H, W = c["batch"], c["height"], c["width"]
    A = len(c["sizes"]) * len(c["ratios"])
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        v = {n: L.data(name=n, shape=shape, dtype="float32",
                       append_batch_size=False)
             for n, shape in (("s", [B, A, H, W]), ("d", [B, 4 * A, H, W]),
                              ("i", [B, 3]), ("fm", [B, 1, H, W]))}
        anchors, var = L.anchor_generator(
            v["fm"], anchor_sizes=list(c["sizes"]),
            aspect_ratios=list(c["ratios"]), stride=[c["stride"]] * 2)
        rois, probs = L.generate_proposals(v["s"], v["d"], v["i"], anchors,
                                           var)
    rng = np.random.RandomState(SEED + 160)
    feed = {"s": torch.as_tensor(rng.rand(B, A, H, W).astype(np.float32),
                                 device=dev),
            "d": torch.as_tensor((rng.randn(B, 4 * A, H, W) * 0.2)
                                 .astype(np.float32), device=dev),
            "i": torch.as_tensor(np.tile(np.float32(
                [[H * c["stride"], W * c["stride"], 1.0]]), (B, 1)),
                device=dev),
            "fm": torch.zeros((B, 1, H, W), device=dev)}
    exe, scope = fluid.Executor(device=dev), fluid.Scope()

    def run():
        return exe.run(main, feed=feed, fetch_list=[rois, probs], scope=scope,
                       return_numpy=False)

    run()
    walls = []
    for _ in range(c["runs"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_rois, got_probs = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = busy_idle(profile_call(torch, run))
    kept = got_rois.lengths
    post = min(1000, A * H * W)
    check(got_rois.data.shape == (B, post, 4) and (kept > 0).all()
          and (kept <= post).all() and np.isfinite(got_rois.data).all()
          and np.isfinite(got_probs.data).all(),
          "generate_proposals at its defaults", got_rois.data.shape,
          kept.tolist())
    return {"anchors": A * H * W, "batch": B, "pre_nms_top_n": 6000,
            "post_nms_top_n": 1000, "ms": float(np.median(walls)) * 1e3,
            "ms_all": [t * 1e3 for t in walls], "kept": kept.tolist(),
            "profile": prof}


def det_feed(rng, n, dense=False):
    """``n`` seeded SSD samples: standard normal images (300 x 300) and
    DET_BOXES[1] boxes an image inside it (each side in [0.05, 0.95) of
    the image's: PASCAL VOC's objects run from small to the whole image)
    with labels in [1, 21); each image's first 1-20 of them fed as a
    LoDArray, or all 20 as plain arrays (``dense``)."""
    from paddle_tpu_torch.lod import LoDArray
    from paddle_tpu_torch.models import ssd as SSD

    G = DET_BOXES[1]
    shape = DET_MODELS["ssd"]["kw"].get("img_shape") or SSD.IMG_SHAPE
    img = rng.randn(n, *shape).astype(np.float32)
    side = rng.uniform(0.05, 0.95, (n, G, 2))
    xy = rng.uniform(0.0, 1.0, (n, G, 2)) * (1.0 - side)
    boxes = np.concatenate([xy, xy + side], -1).astype(np.float32)
    labels = rng.randint(1, SSD.NUM_CLASSES, size=(n, G, 1)).astype(np.int64)
    if dense:
        return {"image": img, "gt_box": boxes, "gt_label": labels}
    lens = rng.randint(DET_BOXES[0], G + 1, size=n)
    return {"image": img, "gt_box": LoDArray(boxes, lens),
            "gt_label": LoDArray(labels, lens)}


def det_heads(m):
    """The names of the multibox head convolutions' biases (the
    ``elementwise_add`` whose output a ``transpose`` reads): no gate
    between them and the loss."""
    blk = m["main"].global_block()
    read = {o.inputs["X"][0] for o in blk.ops if o.type == "transpose"}
    return [op.inputs["Y"][0] for op in blk.ops
            if op.type == "elementwise_add" and op.outputs["Out"][0] in read]


def det_check(torch, fluid, dev):
    """struct_check's method for SSD at full width, batch
    ``check_batch``: one step from one set of numpy parameters on the
    card and on the port's CPU path in float64 (the Program widened;
    loss LOSS_RTOL, each gradient GRAD_RTOL of its max, the running
    statistics RESNET_STAT_RTOL), and in float32 with TF32 off against
    the CPU's float64 step (struct_f32_ok), the CPU's float32 step too,
    and a float32 step with TF32 on, which must fail struct_f32_ok."""
    cpu = torch.device("cpu")
    cfg = DET_MODELS["ssd"]
    m = seq_model(fluid, "ssd")
    state = seq_state(fluid, m, SEED + 151, cpu)
    feed = det_feed(np.random.RandomState(SEED + 152), cfg["check_batch"])
    main64 = widened(fluid, m["main"])
    head = det_heads(m)[-1].split(".")[0] + "."
    t0 = time.perf_counter()
    cpu64 = seq_step(torch, fluid, m, main64, state, feed, cpu)
    cpu32 = seq_step(torch, fluid, m, m["main"], state, feed, cpu)
    cpu_s = time.perf_counter() - t0
    card64 = seq_step(torch, fluid, m, main64, state, feed, dev)
    card32 = seq_step(torch, fluid, m, m["main"], state, feed, dev)
    tf32 = seq_step(torch, fluid, m, m["main"], state, feed, dev, tf32=True)
    e64 = resnet_errors(card64, cpu64, head)
    check(e64["loss_rel"] <= LOSS_RTOL and e64["grad_worst_of_max"]
          <= GRAD_RTOL and e64["stat_worst_of_max"] <= RESNET_STAT_RTOL,
          "ssd float64 card vs cpu", e64)
    out = {"float64_card_vs_cpu": e64,
           "float32_card_vs_cpu64": resnet_errors(card32, cpu64, head),
           "float32_cpu_vs_cpu64": resnet_errors(cpu32, cpu64, head),
           "tf32_card_vs_cpu64": resnet_errors(tf32, cpu64, head),
           "f32_limits": cfg["f32"],
           "loss": {"cpu64": cpu64["loss"], "card64": card64["loss"],
                    "cpu32": cpu32["loss"], "card32": card32["loss"],
                    "tf32": tf32["loss"]},
           "batch": cfg["check_batch"], "cpu_steps_s": cpu_s}
    check(struct_f32_ok("ssd", out["float32_card_vs_cpu64"]),
          "ssd float32 card vs cpu", out["float32_card_vs_cpu64"])
    check(struct_f32_ok("ssd", out["float32_cpu_vs_cpu64"]),
          "ssd float32 cpu vs cpu float64", out["float32_cpu_vs_cpu64"])
    check(not struct_f32_ok("ssd", out["tf32_card_vs_cpu64"]),
          "ssd limits pass a TF32 step", out["tf32_card_vs_cpu64"])
    return out


def det_test_pass(torch, fluid, dev, exe, scope, m, feed):
    """The test Program (cloned before RMSProp: ``detection_output``,
    nms_top_k 400, keep_top_k 200) on the trained weights and the
    training batch, through Executor.run (op by op: it fetches
    ``multiclass_nms``'s lengths): ms a batch (the median of
    DET_TEST_RUNS synchronized runs), a profiled pass's launches and idle
    share, the detections' shape, counts, labels and scores; then
    ``multiclass_nms`` alone on the pass's own decoded boxes and scores
    (a one-op Program at the same attrs): its ms and launches, and its
    share of the pass."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    blk = m["test"].global_block()
    (nms,) = [op for op in blk.ops if op.type == "multiclass_nms"]
    fetch = [m["nmsed_out"].name, nms.inputs["BBoxes"][0],
             nms.inputs["Scores"][0]]

    def timed_runs(fn):
        fn()
        walls = []
        for _ in range(DET_TEST_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)) * 1e3, res

    test_ms, (det, boxes, scores) = timed_runs(lambda: exe.run(
        m["test"], feed=feed, fetch_list=fetch, scope=scope,
        return_numpy=False))
    prof = busy_idle(profile_call(torch, lambda: exe.run(
        m["test"], feed=feed, fetch_list=fetch[:1], scope=scope,
        return_numpy=False)))
    n, cnt = len(feed["image"]), det.lengths
    valid = np.arange(det.data.shape[1])[None, :] < cnt[:, None]
    rows = det.data[valid]
    check(det.data.shape == (n, 200, 6) and (cnt <= 200).all()
          and np.isfinite(det.data).all() and (det.data[~valid] == -1).all()
          and ((rows[:, 0] >= 1) & (rows[:, 0] < 21)).all()
          and ((rows[:, 1] > 0.01) & (rows[:, 1] <= 1)).all(),
          "SSD's test Program detections", det.data.shape, cnt.tolist())
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        b = fluid.layers.data(name="b", shape=list(boxes.shape),
                              dtype="float32", append_batch_size=False)
        s = fluid.layers.data(name="s", shape=list(scores.shape),
                              dtype="float32", append_batch_size=False)
        helper = LayerHelper("multiclass_nms")
        out = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(type="multiclass_nms",
                         inputs={"BBoxes": [b], "Scores": [s]},
                         outputs={"Out": [out]}, attrs=dict(nms.attrs))
    nexe = fluid.Executor(device=dev)
    nms_run = lambda: nexe.run(main, feed={"b": boxes, "s": scores},
                               fetch_list=[out], scope=fluid.Scope(),
                               return_numpy=False)
    nms_ms, (alone,) = timed_runs(nms_run)
    check(np.array_equal(alone.data, det.data)
          and np.array_equal(alone.lengths, det.lengths),
          "multiclass_nms alone differs from the test Program's")
    nms_prof = busy_idle(profile_call(torch, nms_run))
    return {"batch": n, "ms": test_ms, "images_per_s": n / (test_ms / 1e3),
            "profile": prof, "detections": cnt.tolist(),
            "nms_top_k": nms.attrs["nms_top_k"],
            "keep_top_k": nms.attrs["keep_top_k"],
            "nms": {"ms": nms_ms, "profile": nms_prof,
                    "share_of_pass": nms_ms / test_ms}}


def det_bound_check(torch, fluid, dev):
    """SSD's training step fed dense (every image at DET_BOXES[1] boxes:
    no lengths, so no ``reads_host`` and no ragged feed) from one start
    state in two scopes: DET_BOUND_STEPS steps op by op and as many
    through the fast path (eager, capture, replays), with cuDNN's
    deterministic algorithms on both (its defaults are not
    deterministic): one bound entry, one capture, the losses and every
    persistable bitwise equal, the G-step match included."""
    from paddle_tpu_torch import executor as executor_mod

    m = seq_model(fluid, "ssd")
    state = seq_state(fluid, m, SEED + 153, dev)
    feed = {k: torch.as_tensor(v, device=dev) for k, v in det_feed(
        np.random.RandomState(SEED + 154), DET_MODELS["ssd"]["batch"],
        dense=True).items()}
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for cache in (False, True):
            exe, scope = fluid.Executor(device=dev), fluid.Scope()
            fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
            c0 = executor_mod.compile_count()
            losses = [np.asarray(exe.run(m["main"], feed=feed,
                                         fetch_list=[m["loss"]], scope=scope,
                                         use_program_cache=cache)[0])
                      for _ in range(DET_BOUND_STEPS)]
            bound = [b for b in exe._bound.values()
                     if b.program is m["main"]]
            runs[cache] = {"losses": losses, "captures":
                           executor_mod.compile_count() - c0,
                           "graphs": sum(b.graph is not None for b in bound),
                           "entries": len(bound),
                           "state": {n: fluid.executor.as_numpy(scope[n])
                                     for n in state}}
            del exe, scope
    finally:
        torch.backends.cudnn.deterministic = False
    g, e = runs[True], runs[False]
    bitwise = (all(a.tobytes() == b.tobytes()
                   for a, b in zip(g["losses"], e["losses"]))
               and all(g["state"][n].tobytes() == e["state"][n].tobytes()
                       for n in state))
    check(g["entries"] == 1 and g["graphs"] == 1 and g["captures"] == 1
          and e["captures"] == 0 and bitwise,
          "SSD's dense step not bound and replayed bitwise",
          g["entries"], g["graphs"], g["captures"], e["captures"], bitwise)
    return {"steps": DET_BOUND_STEPS, "entries": g["entries"],
            "captures": g["captures"], "replays_bitwise_eager": bitwise,
            "cudnn_deterministic": True, "persistables": len(state),
            "losses": [float(v.reshape(-1)[0]) for v in g["losses"]]}


def detection_phase(torch, fluid, fa, dev):
    """The detection slice on the card: the 14 detection rules in float64
    against the CPU (det_ops_check); ``generate_proposals`` at its
    defaults, timed (det_rpn_timed); MobileNet-SSD at get_model's
    defaults, its card step held to the CPU's (det_check), ``steps``
    training steps fed ragged (seq_train: losses finite and falling, step
    ms, images a second, launches a step, idle share, peak memory) and a
    pass of its test Program (det_test_pass); the same step fed dense,
    bound (seq_train with ``dense``) beside the ragged step, one eager
    step of it profiled by op (profile_ops, DET_FAMILIES), and its
    replays bitwise its op-by-op steps (det_bound_check).  No kernel of
    this repo runs: B1-B5 launch 0 times in the phase."""
    fa.reset_launch_counts()
    card = card_line()
    t0 = time.perf_counter()
    out = {"card": card, "ops": det_ops_check(torch, fluid, dev)}
    seconds = {"ops": time.perf_counter() - t0}
    log("detection ops, card vs cpu float64 (%s): %s"
        % (card, json.dumps(out["ops"])))
    t1 = time.perf_counter()
    out["generate_proposals"] = det_rpn_timed(torch, fluid, dev)
    seconds["generate_proposals"] = time.perf_counter() - t1
    log("generate_proposals at its defaults (%s): %s"
        % (card, json.dumps(out["generate_proposals"])))
    t1 = time.perf_counter()
    chk = det_check(torch, fluid, dev)
    t2 = time.perf_counter()
    trn, exe, scope, m, feed = seq_train(torch, fluid, "ssd", dev)
    t3 = time.perf_counter()
    test = det_test_pass(torch, fluid, dev, exe, scope, m, feed)
    out["ssd"] = {"check": chk, "train": trn, "test_pass": test}
    seconds["ssd"] = {"check": t2 - t1, "train": t3 - t2,
                      "test_pass": time.perf_counter() - t3}
    log("ssd (300 x 300, TF32 off, %s): %s" % (card, json.dumps(out["ssd"])))
    del exe, scope, m, feed
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    dense, exe, scope, m, feed = seq_train(torch, fluid, "ssd", dev,
                                           dense=True)
    # where the device time of a step goes, by op (eager)
    out["ssd"]["device_time_by_op"] = profile_ops(
        torch, exe, m, feed, scope, [m["loss"]], DET_FAMILIES)
    del exe, scope, m, feed
    ragged = out["ssd"]["train"]
    check(dense["bound"] and dense["captures"] == 1 and not ragged["bound"]
          and ragged["captures"] == 0,
          "SSD bound ragged or did not bind dense", dense["bound"],
          dense["captures"], ragged["bound"])
    out["ragged_vs_dense"] = {
        "dense": dense, "ragged_step_ms": ragged["step_ms"],
        "dense_step_ms": dense["step_ms"],
        "ragged_over_dense": ragged["step_ms"] / dense["step_ms"],
        "ragged_launches_per_step": ragged.get("launches_per_step"),
        "dense_launches_per_step": dense.get("launches_per_step"),
        "ragged_idle_share": ragged.get("idle_share"),
        "dense_idle_share": dense.get("idle_share")}
    out["bound"] = det_bound_check(torch, fluid, dev)
    seconds["dense"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    launches = dict(fa.KERNEL_LAUNCHES)
    check(not any(launches.values()), "a kernel launched in the detection "
          "phase", launches)
    out["launches"] = launches
    out["seconds"] = seconds
    log("detection phase: %s" % json.dumps(
        {k: out[k] for k in ("card", "ragged_vs_dense", "bound", "launches",
                             "seconds")}))
    log("ssd step's device time by op (eager, %s): %s"
        % (card, json.dumps(out["ssd"]["device_time_by_op"])))
    return out


def grad_l2(a, ref):
    """All of ``a``'s gradients together against ``ref``'s: their L2
    distance over the reference's L2 norm, and the worst element's error
    over its tensor's max."""
    num = sum(float(np.sum((np.asarray(g, np.float64) - ref[n]) ** 2))
              for n, g in a.items())
    den = sum(float(np.sum(np.asarray(ref[n], np.float64) ** 2)) for n in a)
    worst = {n: float(np.abs(np.asarray(g, np.float64) - ref[n]).max())
             / (float(np.abs(ref[n]).max()) or 1.0) for n, g in a.items()}
    name = max(worst, key=worst.get)
    return {"l2": (num / den) ** 0.5, "worst_of_max": worst[name],
            "worst": name}


def f64_step_errors(torch, fluid, m, state, feed, dev):
    """One step of ``m``'s Program in float32 and of its widened copy in
    float64 on the card from the numpy ``state`` (seq_step): the loss's
    relative error and the gradients' (grad_l2), and the float32 step.
    Both run with ``m``'s run seed (set on the copy: a Program's dict
    holds no seed), so their dropout masks are the same bits."""
    f32 = seq_step(torch, fluid, m, m["main"], state, feed, dev)
    wide = widened(fluid, m["main"])
    wide.random_seed = m["main"].random_seed
    f64 = seq_step(torch, fluid, m, wide, state, feed, dev)
    return {"loss_rel": abs(f32["loss"] - f64["loss"]) / abs(f64["loss"]),
            "loss": f32["loss"], "loss64": f64["loss"],
            "grads": grad_l2(f32["grads"], f64["grads"])}, f32


def bound_and_eager(torch, fluid, m, state, feed, dev, steps, seed):
    """``steps`` steps of ``m`` from the numpy ``state`` on one feed, through
    the fast path (bound: eager, capture, then replays) and op by op, each
    in its own scope with the run seed ``seed``: the bound run's losses,
    step seconds, captures, graphs and peak memory, its executor and
    scope, and whether its losses and every persistable are bitwise the
    op-by-op run's."""
    from paddle_tpu_torch import executor as executor_mod

    m["main"].random_seed = seed
    runs = {}
    for cache in (False, True):
        exe, scope = fluid.Executor(device=dev), fluid.Scope()
        fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        c0 = executor_mod.compile_count()
        losses, step_s = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            (loss,) = exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                              scope=scope, use_program_cache=cache)
            losses.append(np.asarray(loss))
            step_s.append(time.perf_counter() - t0)
        bound = [b for b in exe._bound.values() if b.program is m["main"]]
        runs[cache] = {
            "losses": losses, "step_s": step_s,
            "captures": executor_mod.compile_count() - c0,
            "graphs": sum(b.graph is not None for b in bound),
            "peak": torch.cuda.max_memory_allocated(dev),
            "state": {n: fluid.executor.as_numpy(scope[n]) for n in state}}
        if cache:   # the bound run's, for its profiled replay
            runs[cache].update(exe=exe, scope=scope)
        del exe, scope
    g, e = runs[True], runs[False]
    bitwise = (all(a.tobytes() == b.tobytes()
                   for a, b in zip(g["losses"], e["losses"]))
               and all(g["state"][n].tobytes() == e["state"][n].tobytes()
                       for n in state))
    return g, bitwise


def pipe_leg(torch, fluid, T, dev, cfg, steps, seed, f64_check=False):
    """The pipelined Transformer-base at ``cfg``: its f32 step against the
    f64 step at PIPE_CHECK_BATCH (``f64_check``), then ``steps`` steps on one
    batch bound and op by op (bound_and_eager): one capture and one
    graph, bitwise, losses finite and falling; ms a step (steps 3 on),
    tokens a second, peak memory, and a profiled replay's idle share."""
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    state = seq_state(fluid, m, seed, dev)
    feed = make_feeds(np.random.RandomState(seed + 1), cfg["batch_size"],
                      cfg["seq_len"], cfg["trg_vocab_size"])
    out = {"stages": cfg["pipeline_stages"],
           "microbatches": cfg["pipeline_microbatches"],
           "circular_repeats": cfg.get("pipeline_circular_repeats", 1),
           "stacked_params": sum(
               bool(getattr(p, "pp_stacked", False))
               for p in m["main"].global_block().all_parameters())}
    m["main"].random_seed = seed + 2
    if f64_check:
        small = {k: v[:PIPE_CHECK_BATCH] for k, v in feed.items()}
        e, _ = f64_step_errors(torch, fluid, m, state, small, dev)
        check(e["loss_rel"] <= LOSS_RTOL and e["grads"]["l2"] <= PIPE_GRAD_L2,
              "pipelined float32 step vs float64", e)
        out["float32_vs_float64"] = dict(e, batch=PIPE_CHECK_BATCH)
    g, bitwise = bound_and_eager(torch, fluid, m, state, feed, dev, steps,
                                 seed + 2)
    losses = [float(v.reshape(-1)[0]) for v in g["losses"]]
    check(g["captures"] == 1 and g["graphs"] == 1 and bitwise
          and np.isfinite(losses).all() and losses[-1] < losses[0],
          "pipelined Transformer-base not bound, not bitwise or not "
          "learning", g["captures"], g["graphs"], bitwise, losses)
    prof = profile_graphed(torch, g["exe"], m, feed, g["scope"])
    steady = steady_ms(g["step_s"])
    out.update({
        "steps": steps, "captures": g["captures"], "graphs": g["graphs"],
        "bitwise_op_by_op": bitwise, "losses": losses,
        "first_step_ms": g["step_s"][0] * 1e3,
        "capture_step_ms": g["step_s"][1] * 1e3, "step_ms": steady,
        "step_ms_all": [t * 1e3 for t in g["step_s"]],
        "target_tokens_per_s": cfg["batch_size"] * cfg["seq_len"]
        / (steady / 1e3),
        "peak_memory_gib": g["peak"] / 2 ** 30, "profile": prof})
    if isinstance(prof, dict):
        out["idle_share"] = prof["device_idle_share"]
        out["idle_share_of_step"] = max(0.0, 1.0 - prof["device_busy_ms"]
                                        / steady)
    return out


def plain_transformer_ms(torch, fluid, T, dev, cfg, steps, seed):
    """ms a step (steps 3 on, bound) and peak memory of ``cfg``'s model
    built without the pipeline."""
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    m["startup"].random_seed = seed
    m["main"].random_seed = seed + 1
    exe, scope = fluid.Executor(device=dev), fluid.Scope()
    exe.run(m["startup"], scope=scope)
    feed = make_feeds(np.random.RandomState(seed + 2), cfg["batch_size"],
                      cfg["seq_len"], cfg["trg_vocab_size"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        (loss,) = exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                          scope=scope)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
        step_s.append(time.perf_counter() - t0)
    check(np.isfinite(losses).all(), "unpipelined loss", losses)
    prof = profile_graphed(torch, exe, m, feed, scope)
    return {"step_ms": steady_ms(step_s),
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "idle_share": (prof["device_idle_share"]
                           if isinstance(prof, dict) else prof)}


def moe_model(fluid, capacity=None):
    """MOE_CFG's Program: ``switch_moe`` on [batch, tokens, d] inputs, a
    mean squared error, Adam (``capacity``: another capacity factor)."""
    c = dict(MOE_CFG, capacity=capacity or MOE_CFG["capacity"])
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[c["tokens"], c["d"]], dtype="float32")
        y = L.data(name="y", shape=[c["tokens"], c["d"]], dtype="float32")
        o = L.switch_moe(x, num_experts=c["experts"],
                         expert_hidden=c["hidden"],
                         capacity_factor=c["capacity"])
        loss = L.mean(L.square_error_cost(input=o, label=y))
        fluid.optimizer.Adam(learning_rate=c["lr"]).minimize(loss)
    (op,) = [o for o in main.global_block().ops if o.type == "switch_moe"]
    return {"main": main, "startup": startup, "loss": loss,
            "gate": op.inputs["GateW"][0], "w1": op.inputs["ExpertW1"][0],
            "w2": op.inputs["ExpertW2"][0]}


def moe_leg(torch, fluid, dev):
    """switch_moe at MOE_CFG: the float32 step against the float64 step
    (f64_step_errors, with the tokens whose top-1 choice differs
    counted), every chosen expert's two weight stacks with a nonzero
    gradient and every other expert's zero, then ``steps`` steps bound
    and op by op (bitwise, one capture, the loss falling): ms a step and
    peak memory."""
    c = MOE_CFG
    m = moe_model(fluid)
    state = seq_state(fluid, m, SEED + 170, dev)
    m["main"].random_seed = SEED + 172
    rng = np.random.RandomState(SEED + 171)
    shape = (c["batch"], c["tokens"], c["d"])
    feed = {"x": rng.randn(*shape).astype(np.float32),
            "y": rng.randn(*shape).astype(np.float32)}
    e, f32 = f64_step_errors(torch, fluid, m, state, feed, dev)
    x = torch.as_tensor(feed["x"], device=dev).reshape(-1, c["d"])
    gate = torch.as_tensor(state[m["gate"]], device=dev)
    choice32 = torch.softmax(x @ gate, -1).argmax(-1)
    choice64 = torch.softmax(x.double() @ gate.double(), -1).argmax(-1)
    e["choices_differ"] = int((choice32 != choice64).sum())
    chosen = sorted(set(choice32.tolist()))
    hit = {w: sorted(i for i in range(c["experts"])
                     if np.abs(f32["grads"][m[w] + "@GRAD"][i]).sum() > 0)
           for w in ("w1", "w2")}
    check(e["loss_rel"] <= LOSS_RTOL and e["grads"]["l2"] <= PIPE_GRAD_L2
          and hit["w1"] == chosen and hit["w2"] == chosen,
          "switch_moe float32 step vs float64, or its expert gradients",
          e, chosen, hit)
    g, bitwise = bound_and_eager(torch, fluid, m, state, feed, dev,
                                 c["steps"], SEED + 172)
    losses = [float(v.reshape(-1)[0]) for v in g["losses"]]
    check(g["captures"] == 1 and bitwise and np.isfinite(losses).all()
          and losses[-1] < losses[0], "switch_moe steps", g["captures"],
          bitwise, losses)
    tokens = c["batch"] * c["tokens"]
    steady = steady_ms(g["step_s"])
    return {"tokens": tokens, "experts": c["experts"], "d": c["d"],
            "hidden": c["hidden"], "capacity_factor": c["capacity"],
            "float32_vs_float64": e, "chosen_experts": chosen,
            "tokens_per_expert": torch.bincount(
                choice32, minlength=c["experts"]).tolist(),
            "experts_with_gradient": hit, "steps": c["steps"],
            "captures": g["captures"], "bitwise_op_by_op": bitwise,
            "losses": losses, "step_ms": steady,
            "step_ms_all": [t * 1e3 for t in g["step_s"]],
            "tokens_per_s": tokens / (steady / 1e3),
            "peak_memory_gib": g["peak"] / 2 ** 30}


def pe_leg(torch, fluid, T, fa, dev):
    """ParallelExecutor on the one card (devices=None: every card, one
    here) at TRAIN_CFG: PE_STEPS steps from one start state against
    Executor.run's (the losses and every persistable bitwise), B1 and B2
    18 times a step each; Trainer(parallel=True) against Trainer() over
    the same samples (losses and parameters bitwise); build_mesh({"dp":
    2}) raises the reference's ValueError."""
    from paddle_tpu_torch import parallel_executor as pe_mod

    cfg = TRAIN_CFG
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    state = seq_state(fluid, m, SEED + 180, dev)
    m["main"].random_seed = SEED + 181
    rng = np.random.RandomState(SEED + 182)
    feeds = [make_feeds(rng, cfg["batch_size"], cfg["seq_len"],
                        cfg["trg_vocab_size"]) for _ in range(PE_STEPS)]
    runs = {}
    for kind in ("executor", "parallel_executor"):
        scope = fluid.Scope()
        fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
        if kind == "executor":
            exe = fluid.Executor(device=dev)
            run = lambda f: exe.run(m["main"], feed=f,  # noqa: E731
                                    fetch_list=[m["loss"]], scope=scope)
        else:
            exe = fluid.ParallelExecutor(loss_name=m["loss"].name,
                                         main_program=m["main"], scope=scope)
            run = lambda f: exe.run(fetch_list=[m["loss"]], feed=f)  # noqa: E731
        fa.reset_launch_counts()
        step_s, losses = [], []
        for f in feeds:
            t0 = time.perf_counter()
            losses.append(np.asarray(run(f)[0]))
            step_s.append(time.perf_counter() - t0)
        runs[kind] = {"losses": losses, "step_s": step_s,
                      "launches": dict(fa.KERNEL_LAUNCHES),
                      "state": {n: fluid.executor.as_numpy(scope[n])
                                for n in state}}
        if kind == "parallel_executor":
            runs[kind]["devices"] = exe.device_count
            runs[kind]["mesh"] = exe._mesh.shape
        del exe, scope, run
    a, b = runs["executor"], runs["parallel_executor"]
    bitwise = (all(x.tobytes() == y.tobytes()
                   for x, y in zip(a["losses"], b["losses"]))
               and all(a["state"][n].tobytes() == b["state"][n].tobytes()
                       for n in state))
    ran = bwd_engine(fa, "auto", cfg)
    check(bitwise and b["devices"] == 1, "ParallelExecutor not bitwise "
          "Executor.run", bitwise, b["devices"])
    check_flash_launches(fa, b["launches"], ran, 18 * PE_STEPS,
                         "ParallelExecutor")
    try:
        pe_mod.build_mesh({"dp": 2})
        raised = None
    except ValueError as exc:
        raised = str(exc)
    check(raised is not None and raised.startswith(
        "mesh_shape {'dp': 2} needs 2 devices, only 1 available"),
        "build_mesh({'dp': 2}) on one card", raised)
    trainer = pe_trainer_leg(torch, fluid, T, fa)
    return {"steps": PE_STEPS, "devices": b["devices"], "mesh": b["mesh"],
            "bitwise_executor_run": bitwise,
            "losses": [float(v.reshape(-1)[0]) for v in b["losses"]],
            "step_ms": steady_ms(b["step_s"]),
            "executor_step_ms": steady_ms(a["step_s"]),
            "launches": b["launches"],
            "launches_per_step": {k: v / PE_STEPS
                                  for k, v in b["launches"].items()},
            "engine_ran": ran, "build_mesh_dp2": raised,
            "trainer": trainer}


def pe_trainer_leg(torch, fluid, T, fa):
    """Trainer(parallel=True) and Trainer() at TRAIN_CFG (flash, dropout
    0.1, Adam with noam decay) over the same PE_STEPS batches from one
    numpy seed: the losses and every parameter bitwise."""
    cfg = TRAIN_CFG
    samples = trainer_samples(cfg["batch_size"] * PE_STEPS, SEED + 183, cfg)
    order = ["src_word", "trg_word", "lbl_word"]
    out = {}
    for parallel in (False, True):
        np.random.seed(SEED + 184)   # the startup's and the run's seed
        train_func, optimizer_func = transformer_trainer_funcs(fluid, T, cfg)
        t = fluid.Trainer(train_func, optimizer_func,
                          place=fluid.CUDAPlace(0), parallel=parallel)
        losses = []
        t.train(num_epochs=1, reader=fluid.batch(lambda: iter(samples),
                                                 cfg["batch_size"]),
                feed_order=order,
                event_handler=lambda e, losses=losses: losses.append(
                    np.asarray(e.metrics[0]))
                if isinstance(e, fluid.EndStepEvent) else None)
        params = [p.name for p in t.train_program.global_block()
                  .all_parameters()]
        out[parallel] = {"losses": losses, "mesh": t.exe._mesh, "params": {
            n: fluid.executor.as_numpy(t.scope[n]) for n in params}}
        del t
        torch.cuda.empty_cache()
    a, b = out[False], out[True]
    bitwise = (len(a["losses"]) == PE_STEPS
               and all(x.tobytes() == y.tobytes()
                       for x, y in zip(a["losses"], b["losses"]))
               and all(a["params"][n].tobytes() == b["params"][n].tobytes()
                       for n in a["params"]))
    check(bitwise and a["mesh"] is None and b["mesh"].size == 1,
          "Trainer(parallel=True) not bitwise Trainer()", bitwise)
    return {"steps": len(b["losses"]), "bitwise_trainer": bitwise,
            "mesh": b["mesh"].shape,
            "losses": [float(v.reshape(-1)[0]) for v in b["losses"]]}


def microbatch_leg(torch, fluid, T, dev):
    """program_to_microbatched_fn with MB_MICROBATCHES on TRAIN_CFG's model
    at dropout 0 against program_to_fn's full-batch step from the same
    state and batch (every row at full length): the mean of the
    microbatch losses within MB_LOSS_RTOL of the full batch's, Adam's
    first moments (0.1 of the averaged gradients) within MB_GRAD_L2 of
    their L2 norm together; the parameters' largest difference reported
    (Adam's first update moves each element by at most the learning
    rate: 1.2e-7 at the full batch's step 1, 4.9e-7 at the microbatched
    function's step 4, R-9); ms (a second, warm call) and peak memory of
    each."""
    from paddle_tpu_torch.parallel.microbatch import program_to_microbatched_fn
    from paddle_tpu_torch.program_fn import program_to_fn

    cfg = dict(TRAIN_CFG, dropout=0.0)
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    state = seq_state(fluid, m, SEED + 190, dev)
    rng = np.random.RandomState(SEED + 191)
    feed = {n: rng.randint(3, cfg["trg_vocab_size"],
                           size=(cfg["batch_size"], cfg["seq_len"]))
            .astype(np.int64) for n in m["feeds"]}
    fns = {"full": program_to_fn(m["main"], [m["loss"]], return_state=True,
                                 device=dev),
           "micro": program_to_microbatched_fn(m["main"], [m["loss"]],
                                               MB_MICROBATCHES, device=dev)}
    out = {}
    for kind, fn in fns.items():
        fn(dict(state), feed)   # warm (the functions are pure): the next is timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        (loss,), new = fn(dict(state), feed)
        torch.cuda.synchronize()
        out[kind] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "peak_memory_gib":
                     torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                     "loss": loss.double().mean().item(),
                     "losses": loss.reshape(-1).tolist(),
                     "state": {n: v.detach().cpu().double().numpy()
                               for n, v in new.items()}}
        del new, loss
    full, micro = out["full"], out["micro"]
    moments = sorted(n for n in full["state"] if "moment1" in n)
    params = [p.name for p in m["main"].global_block().all_parameters()
              if p.trainable]
    loss_rel = abs(micro["loss"] - full["loss"]) / abs(full["loss"])
    grads = grad_l2({n: micro["state"][n] for n in moments},
                    {n: full["state"][n] for n in moments})
    worst_param = max(float(np.abs(micro["state"][n] - full["state"][n])
                            .max()) for n in params)
    check(loss_rel <= MB_LOSS_RTOL and grads["l2"] <= MB_GRAD_L2
          and len(moments) == len(params),
          "microbatched step vs the full-batch step", loss_rel, grads)
    return {"microbatches": MB_MICROBATCHES, "loss_rel": loss_rel,
            "first_moments": grads, "moments": len(moments),
            "param_worst_abs": worst_param, "losses": micro["losses"],
            "full_loss": full["loss"], "ms": micro["ms"],
            "full_ms": full["ms"],
            "peak_memory_gib": micro["peak_memory_gib"],
            "full_peak_memory_gib": full["peak_memory_gib"]}


def dec_cell(fluid, init_h):
    """The decoder's StateCell: h = tanh(fc(x) + fc(h)), the fcs named so
    that the training and the decode Programs share them."""
    L = fluid.layers
    from paddle_tpu_torch.contrib import InitState, StateCell

    cell = StateCell(inputs={"x": None}, states={"h": InitState(init=init_h)},
                     out_state="h")

    @cell.state_updater
    def updater(c):
        h = L.elementwise_add(
            L.fc(c.get_input("x"), size=DEC_CFG["hidden"], name="dec_x2h"),
            L.fc(c.get_state("h"), size=DEC_CFG["hidden"], name="dec_h2h"))
        c.set_state("h", L.tanh(h))

    return cell


def dec_encoder(fluid):
    """The source words (ragged) -> the decoder's first state: embedding
    (embedding_0), fc tanh (fc_0), average pool, fc tanh (fc_1)."""
    L = fluid.layers
    c = DEC_CFG
    src = L.data(name="src", shape=[1], dtype="int64", lod_level=1)
    emb = L.embedding(src, size=[c["dict_size"], c["emb"]], dtype="float32")
    enc = L.fc(emb, size=c["hidden"], act="tanh", num_flatten_dims=2)
    return L.fc(L.sequence_pool(enc, "average"), size=c["hidden"],
                act="tanh")


def dec_programs(fluid):
    """The training Program (TrainingDecoder over the target's embedding,
    embedding_1; a softmax fc, fc_2; cross entropy; Adam) and the decode
    Program (BeamSearchDecoder, whose own embedding and softmax fc are
    embedding_1 and fc_2 again), each with its startup."""
    from paddle_tpu_torch.contrib import BeamSearchDecoder, TrainingDecoder

    L = fluid.layers
    c = DEC_CFG
    train, train_start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(train, train_start):
        cell = dec_cell(fluid, dec_encoder(fluid))
        trg = L.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = L.data(name="lbl", shape=[1], dtype="int64", lod_level=1)
        decoder = TrainingDecoder(cell)
        trg_emb = L.embedding(trg, size=[c["dict_size"], c["emb"]],
                              dtype="float32")
        with decoder.block():
            word = decoder.step_input(trg_emb)
            decoder.state_cell.compute_state(inputs={"x": word})
            score = L.fc(decoder.state_cell.get_state("h"),
                         size=c["dict_size"], act="softmax")
            decoder.state_cell.update_states()
            decoder.output(score)
        loss = L.mean(L.cross_entropy(decoder(), lbl))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    decode, decode_start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(decode, decode_start):
        init_h = dec_encoder(fluid)
        init_ids = L.data(name="init_ids", shape=[DEC_BEAM], dtype="int64")
        init_scores = L.data(name="init_scores", shape=[DEC_BEAM],
                             dtype="float32")
        beam = BeamSearchDecoder(
            state_cell=dec_cell(fluid, init_h), init_ids=init_ids,
            init_scores=init_scores, target_dict_dim=c["dict_size"],
            word_dim=c["emb"], sparse_emb=False, max_len=DEC_MAX_LEN,
            beam_size=DEC_BEAM, end_id=DEC_END_ID)
        beam.decode()
        ids, scores = beam()
    return ({"main": train, "startup": train_start, "loss": loss},
            {"main": decode, "ids": ids, "scores": scores})


def dec_words(rng, n, vocab):
    """``n`` seeded sentences of DEC_LENS tokens (ids 2..vocab-1) as a
    LoDArray [n, max, 1]."""
    from paddle_tpu_torch.lod import LoDArray

    lens = rng.randint(DEC_LENS[0], DEC_LENS[1] + 1, size=n)
    data = rng.randint(2, vocab, size=(n, DEC_LENS[1], 1)).astype(np.int64)
    for i, k in enumerate(lens):
        data[i, k:] = 0
    return LoDArray(data, lens)


def decoder_leg(torch, fluid, dev):
    """The contrib decoder at DEC_CFG: DEC_STEPS TrainingDecoder steps on a
    ragged batch of DEC_BATCH (losses finite and falling; op by op, the
    DynamicRNN fed ragged), then BeamSearchDecoder on the trained weights
    (the decode Program's parameters are the training Program's, by
    name and shape): DEC_SOURCES sources, two float32 decodes bitwise
    equal, and a float64 decode of the widened Program from the same
    weights: the hypotheses whose ids and lengths agree, and their
    scores within DEC_SCORE_RTOL; sentences a second."""
    from paddle_tpu_torch.lod import LoDArray

    c = DEC_CFG
    tr, dc = dec_programs(fluid)
    tparams = {p.name: tuple(p.shape)
               for p in tr["main"].global_block().all_parameters()}
    dparams = {p.name: tuple(p.shape)
               for p in dc["main"].global_block().all_parameters()}
    check(all(tparams.get(n) == s for n, s in dparams.items()),
          "decode parameters are not the training Program's", dparams)
    tr["startup"].random_seed = SEED + 200
    tr["main"].random_seed = SEED + 201
    exe, scope = fluid.Executor(device=dev), fluid.Scope()
    exe.run(tr["startup"], scope=scope)
    rng = np.random.RandomState(SEED + 202)
    trg = dec_words(rng, DEC_BATCH, c["dict_size"])
    lbl = LoDArray(np.concatenate([trg.data[:, 1:], trg.data[:, :1] * 0 + 1],
                                  1), trg.lengths)
    feed = {"src": dec_words(rng, DEC_BATCH, c["dict_size"]), "trg": trg,
            "lbl": lbl}
    losses, step_s = [], []
    for _ in range(DEC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lv,) = exe.run(tr["main"], feed=feed, fetch_list=[tr["loss"]],
                        scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        step_s.append(time.perf_counter() - t0)
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "TrainingDecoder losses", losses)
    src = dec_words(np.random.RandomState(SEED + 203), DEC_SOURCES,
                    c["dict_size"])
    bfeed = {"src": src,
             "init_ids": np.zeros((DEC_SOURCES, DEC_BEAM), np.int64),
             "init_scores": np.tile(np.array(
                 [[0.0] + [-1e9] * (DEC_BEAM - 1)], np.float32),
                 (DEC_SOURCES, 1))}
    fetch = [dc["ids"], dc["scores"]]

    def decode(prog, sc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(prog, feed=bfeed, fetch_list=fetch, scope=sc,
                      return_numpy=False)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    runs = [decode(dc["main"], scope) for _ in range(2)]
    (ids, scores), _ = runs[0]
    (ids2, scores2), wall = runs[1]
    repeat = (ids.data.tobytes() == ids2.data.tobytes()
              and scores.data.tobytes() == scores2.data.tobytes()
              and np.array_equal(ids.lengths, ids2.lengths))
    weights = {n: fluid.executor.as_numpy(scope[n]).astype(np.float64)
               for n in dparams}
    scope64 = fluid.Scope()
    wide = widened(fluid, dc["main"])
    fluid.load_numpy_state(wide, weights, scope=scope64, device=dev)
    (ids64, scores64), wall64 = decode(wide, scope64)
    n_hyp = DEC_SOURCES * DEC_BEAM
    agree = [i for i in range(n_hyp)
             if ids.lengths[i] == ids64.lengths[i] and np.array_equal(
                 ids.data[i, :ids.lengths[i]],
                 ids64.data[i, :ids64.lengths[i]])]
    s32 = np.asarray(scores.data, np.float64).reshape(n_hyp, -1)
    s64 = np.asarray(scores64.data, np.float64).reshape(n_hyp, -1)
    worst = max((float(np.abs(s32[i] - s64[i]).max()
                       / max(float(np.abs(s64[i]).max()), 1e-30))
                 for i in agree), default=0.0)
    check(repeat and agree and worst <= DEC_SCORE_RTOL
          and ids.data.shape[0] == n_hyp
          and int(ids.data.max()) < c["dict_size"],
          "BeamSearchDecoder: repeat, agreement or scores", repeat,
          len(agree), worst)
    return {"dict_size": c["dict_size"], "emb": c["emb"],
            "hidden": c["hidden"], "batch": DEC_BATCH,
            "train_steps": DEC_STEPS, "losses": losses,
            "train_step_ms": [t * 1e3 for t in step_s],
            "sources": DEC_SOURCES, "beam": DEC_BEAM, "max_len": DEC_MAX_LEN,
            "repeat_bitwise": repeat, "beams_agree_f64": len(agree),
            "beams": n_hyp, "agreeing_score_worst_rel": worst,
            "lengths": [int(v) for v in ids.lengths],
            "decode_s": wall, "sentences_per_s": DEC_SOURCES / wall,
            "decode64_s": wall64}


def parallel_phase(torch, fluid, T, fa, dev):
    """The one-card parallel slice on the card: the pipelined
    Transformer-base (pipe_leg at PIPE_CFG with its float64 check, then
    the circular layout at PIPE_CIRCULAR_CFG) beside the same model
    unpipelined; switch_moe at MOE_CFG (moe_leg); ParallelExecutor and
    Trainer(parallel=True) at TRAIN_CFG (pe_leg, B1 and B2 18 times a
    step each); program_to_microbatched_fn (microbatch_leg); the contrib
    decoder (decoder_leg).  The pipeline, MoE and decoder legs launch
    none of B1-B5."""
    card = card_line()
    out, seconds = {"card": card}, {}

    def leg(name, fn, *args, kernels_free=True):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
        launches = dict(fa.KERNEL_LAUNCHES)
        if kernels_free:
            check(not any(launches.values()), "a kernel launched in the %s "
                  "leg" % name, launches)
        torch.cuda.empty_cache()
        log("parallel phase, %s (%s): %s" % (name, card, json.dumps(
            out[name], default=str)))

    leg("pipeline", pipe_leg, torch, fluid, T, dev, PIPE_CFG, PIPE_STEPS,
        SEED + 160, True)
    leg("pipeline_circular", pipe_leg, torch, fluid, T, dev,
        PIPE_CIRCULAR_CFG, PIPE_CIRCULAR_STEPS, SEED + 163)
    leg("unpipelined", plain_transformer_ms, torch, fluid, T, dev,
        dict(PIPE_CFG, pipeline_stages=0), PIPE_PLAIN_STEPS, SEED + 166)
    leg("switch_moe", moe_leg, torch, fluid, dev)
    leg("parallel_executor", pe_leg, torch, fluid, T, fa, dev,
        kernels_free=False)
    leg("microbatch", microbatch_leg, torch, fluid, T, dev,
        kernels_free=False)
    leg("decoder", decoder_leg, torch, fluid, dev)
    out["pipelined_over_unpipelined"] = (out["pipeline"]["step_ms"]
                                         / out["unpipelined"]["step_ms"])
    out["seconds"] = seconds
    log("parallel phase: %s" % json.dumps(
        {k: out[k] for k in ("card", "pipelined_over_unpipelined",
                             "seconds")}))
    return out


def mesh_feeds(rng, cfg):
    """Seeded token feeds with every row at full length (no PAD token)."""
    shape = (cfg["batch_size"], cfg["seq_len"])
    return {n: rng.randint(3, cfg["trg_vocab_size"], size=shape)
            .astype(np.int64) for n in ("src_word", "trg_word", "lbl_word")}


def mesh_steps(torch, fluid, fa, m, state, feeds, dev, mesh=None,
               devices=None, zero=0, fetch=None):
    """Steps of ``m`` from the numpy ``state``, one a feed: through
    Executor.run (``mesh`` None) or a ParallelExecutor over ``mesh`` of
    ``devices``.  Their fetches (the loss first), step seconds, kernel
    launches and engine runs, the parameters after them, each rank's
    state bytes and the state specs, the captured graphs and peak
    memory."""
    from paddle_tpu_torch.parallel import collective

    fetch = fetch or [m["loss"].name]
    scope = fluid.Scope()
    fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
    if mesh is None:
        exe = fluid.Executor(device=dev)
        run = lambda f: exe.run(m["main"], feed=f,  # noqa: E731
                                fetch_list=fetch, scope=scope)
    else:
        pe = fluid.ParallelExecutor(
            loss_name=m["loss"].name, main_program=m["main"], scope=scope,
            mesh_shape=mesh, devices=devices, zero_stage=zero)
        exe = pe._exe
        run = lambda f: pe.run(fetch_list=fetch, feed=f)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    collective.reset_engine_counts()
    outs, step_s = [], []
    params = [p.name for p in m["main"].global_block().all_parameters()]
    first = None
    for f in feeds:
        t0 = time.perf_counter()
        outs.append([np.asarray(v) for v in run(f)])
        step_s.append(time.perf_counter() - t0)
        if first is None:   # the parameters after one step
            first = {n: fluid.executor.as_numpy(scope[n]) for n in params}
    res = {"fetches": outs, "step_s": step_s, "params1": first,
           "launches": dict(fa.KERNEL_LAUNCHES),
           "engines": dict(collective.ENGINE_RUNS),
           "params": {n: fluid.executor.as_numpy(scope[n]) for n in params},
           "rank_state_bytes": exe.rank_state_bytes(scope, m["main"]),
           "specs": {n: s for n, s in exe.state_specs(scope, m["main"])
                     .items() if s},
           "graphs": sum(b.graph is not None for b in exe._bound.values()),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    del exe, scope, run
    torch.cuda.empty_cache()
    return res


def mesh_errors(got, want):
    """The JAX package's dryrun measures (``__graft_entry__.py:170-177``):
    the worst loss error over max(1, |loss|) of every step, and the
    worst parameter element's error over max(|value|, 1e-3) after one
    step, as the dryrun takes one (with its parameter's name), and the
    same after the last step, recorded.  Adam's first steps move every
    element by about its learning rate whatever its gradient's size, so
    an element whose gradient cancels to rounding noise moves by that
    noise's sign: at noam's warm-up rate one step moves it 1.2e-7, a
    flip 2.5e-7, a quarter of the limit at the 1e-3 floor."""
    loss = max(abs(float(a[0].reshape(-1)[0]) - float(b[0].reshape(-1)[0]))
               / max(1.0, abs(float(b[0].reshape(-1)[0])))
               for a, b in zip(got["fetches"], want["fetches"]))

    def worst(a, b):
        err = {n: float((np.abs(a[n].astype(np.float64) - w)
                         / np.maximum(np.abs(w), 1e-3)).max())
               for n, w in ((n, w.astype(np.float64)) for n, w in b.items())}
        name = max(err, key=err.get) if err else None
        return err.get(name, 0.0), name

    p1, n1 = worst(got["params1"], want["params1"])
    pl, nl = worst(got["params"], want["params"])
    return {"loss_rel": loss, "param_rel": p1, "param": n1,
            "last_step_param_rel": pl, "last_step_param": nl}


def same_bits(a, b):
    return (all(x.tobytes() == y.tobytes() for fa_, fb_ in
                zip(a["fetches"], b["fetches"]) for x, y in zip(fa_, fb_))
            and all(a["params"][n].tobytes() == b["params"][n].tobytes()
                    for n in a["params"]))


def mesh_losses(r):
    return [float(f[0].reshape(-1)[0]) for f in r["fetches"]]


def mesh_dp_tp_leg(torch, fluid, T, fa, dev):
    """Transformer-base through ParallelExecutor(mesh_shape=(2, 2)) on four
    ranks of the card against Executor.run from one state on the same
    batches; two mesh runs bitwise; B1 and B2 36 times a step; one graph.
    Then ZeRO 0, 1 and 3 at {"dp": 4}, stage 0 against Executor.run and
    the others against stage 0, stage 3 twice (bitwise)."""
    cfg = MESH_CFG
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    state = seq_state(fluid, m, SEED + 190, dev)
    m["main"].random_seed = SEED + 191
    rng = np.random.RandomState(SEED + 192)
    feeds = [mesh_feeds(rng, cfg) for _ in range(MESH_STEPS)]
    ranks = ["cuda:0"] * MESH_RANKS
    one = mesh_steps(torch, fluid, fa, m, state, feeds, dev)
    runs = [mesh_steps(torch, fluid, fa, m, state, feeds, dev, (2, 2), ranks)
            for _ in range(2)]
    e = mesh_errors(runs[0], one)
    bitwise = same_bits(runs[0], runs[1])
    check(e["loss_rel"] <= MESH_LOSS_RTOL
          and e["param_rel"] <= MESH_PARAM_RTOL and bitwise
          and runs[0]["graphs"] == 1,
          "dp x tp Transformer-base against Executor.run", e, bitwise,
          runs[0]["graphs"])
    check_flash_launches(fa, runs[0]["launches"], "fused",
                         36 * MESH_STEPS, "dp x tp")
    check_flash_launches(fa, one["launches"], "fused", 18 * MESH_STEPS,
                         "Executor.run beside dp x tp")
    out = {"mesh": {"dp": 2, "tp": 2}, "devices": ranks,
           "steps": MESH_STEPS, "vs_executor_run": e,
           "bitwise_two_runs": bitwise, "graphs": runs[0]["graphs"],
           "losses": mesh_losses(runs[0]),
           "executor_losses": mesh_losses(one),
           "step_ms": steady_ms(runs[0]["step_s"]),
           "step_ms_all": [t * 1e3 for t in runs[0]["step_s"]],
           "executor_step_ms": steady_ms(one["step_s"]),
           "launches": runs[0]["launches"],
           "launches_per_step": {k: v / MESH_STEPS
                                 for k, v in runs[0]["launches"].items()},
           "rank_state_bytes": runs[0]["rank_state_bytes"],
           "executor_state_bytes": one["rank_state_bytes"][0],
           "tp_split_values": len(runs[0]["specs"]),
           "peak_gib": runs[0]["peak_gib"],
           "executor_peak_gib": one["peak_gib"]}
    del runs
    zero = {}
    for stage in (0, 1, 3):
        zero[stage] = mesh_steps(torch, fluid, fa, m, state, feeds, dev,
                                 {"dp": MESH_RANKS}, ranks, zero=stage)
    again = mesh_steps(torch, fluid, fa, m, state, feeds, dev,
                       {"dp": MESH_RANKS}, ranks, zero=3)
    check(same_bits(zero[3], again), "ZeRO 3 not bitwise over two runs")
    zout = {"stage3_bitwise_two_runs": True}
    for stage, r in zero.items():
        e = mesh_errors(r, zero[0])
        check(e["loss_rel"] <= MESH_LOSS_RTOL
              and e["param_rel"] <= MESH_PARAM_RTOL and r["graphs"] == 1,
              "ZeRO stage %d against stage 0" % stage, e, r["graphs"])
        check_flash_launches(fa, r["launches"], "fused",
                             18 * MESH_RANKS * MESH_STEPS, "ZeRO %d" % stage)
        zout[stage] = {"vs_stage_0": e, "losses": mesh_losses(r),
                       "step_ms": steady_ms(r["step_s"]),
                       "rank_state_bytes": r["rank_state_bytes"],
                       "split_values": len(r["specs"]),
                       "launches": r["launches"],
                       "launches_per_step": {
                           k: v / MESH_STEPS
                           for k, v in r["launches"].items()},
                       "peak_gib": r["peak_gib"]}
    z0, z3 = (zero[s]["rank_state_bytes"] for s in (0, 3))
    zout["stage3_over_stage0_bytes"] = max(z3) / max(z0)
    check(zout["stage3_over_stage0_bytes"] < 0.3,
          "ZeRO 3 ranks hold more than about a quarter", z0, z3)
    e = mesh_errors(zero[0], one)
    check(e["loss_rel"] <= MESH_LOSS_RTOL
          and e["param_rel"] <= MESH_PARAM_RTOL,
          "ZeRO stage 0 against Executor.run", e)
    zout["stage0_vs_executor_run"] = e
    out["zero"] = zout
    return out


def sp_program(fluid, causal, engine):
    """One flash_attention op over [B, H, T, D] feeds q, k, v, the loss
    reduce_sum(o * r) and calc_gradient of q, k and v."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    shape = list(SP_SHAPE[1:])
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        q, k, v, r = (L.data(name=n, shape=shape, dtype="float32")
                      for n in ("q", "k", "v", "r"))
        for t in (q, k, v):
            t.stop_gradient = False
        o = L.flash_attention(q, k, v, causal=causal, sp_engine=engine)
        loss = L.reduce_sum(L.elementwise_mul(o, r))
        grads = fluid.backward.calc_gradient(loss, [q, k, v])
    return {"main": main, "startup": startup, "loss": loss,
            "fetch": [loss.name, o.name] + [g.name for g in grads]}


def mesh_sp_leg(torch, fluid, fa, dev):
    """The flash_attention op at SP_SHAPE over {"dp": 1, "sp": 4}, each
    engine and causal and not, against the one-device kernels: the output
    and gradients (SP_CHECK_STEPS steps), then ms a step fetching the
    loss (SP_STEPS steps), the engine counters and launches of those."""
    rng = np.random.RandomState(SEED + 193)
    feed = {n: rng.randn(*SP_SHAPE).astype(np.float32)
            for n in ("q", "k", "v", "r")}
    ranks = ["cuda:0"] * MESH_RANKS
    out = {"shape": list(SP_SHAPE), "mesh": {"dp": 1, "sp": MESH_RANKS}}
    for causal in (False, True):
        tag = "causal" if causal else "full"
        one = None
        for engine in (None, "ulysses", "ring"):
            m = sp_program(fluid, causal, engine or "auto")
            mesh = None if engine is None else {"dp": 1, "sp": MESH_RANKS}
            devs = ranks if mesh else None
            r = mesh_steps(torch, fluid, fa, m, {}, [feed] * SP_CHECK_STEPS,
                           dev, mesh, devs, fetch=m["fetch"])
            t = mesh_steps(torch, fluid, fa, m, {}, [feed] * SP_STEPS, dev,
                           mesh, devs)
            if engine is None:
                one = r
                check_flash_launches(fa, t["launches"], "fused", SP_STEPS,
                                     "one-device flash op")
                out["one_device_" + tag] = {
                    "step_ms": steady_ms(t["step_s"]),
                    "peak_gib": t["peak_gib"]}
                continue
            errs = [float(np.abs(a - b).max()) / float(np.abs(b).max())
                    for a, b in zip(r["fetches"][-1][1:],
                                    one["fetches"][-1][1:])]
            ran = t["engines"]
            check(max(errs) <= SP_RTOL and ran[engine] == SP_STEPS
                  and ran["sp_fallback"] == 0 and t["graphs"] == 1,
                  "sp %s (%s) against the one-device kernels"
                  % (engine, tag), errs, ran, t["graphs"])
            calls = MESH_RANKS * SP_STEPS if engine == "ulysses" else 0
            check_flash_launches(fa, t["launches"], "fused", calls,
                                 "sp " + engine)
            out["%s_%s" % (engine, tag)] = {
                "rel_errors_out_dq_dk_dv": errs,
                "bitwise_one_device": all(e == 0.0 for e in errs),
                "engines": ran, "launches": t["launches"],
                "launches_per_step": {k: v / SP_STEPS
                                      for k, v in t["launches"].items()},
                "step_ms": steady_ms(t["step_s"]),
                "over_one_device": steady_ms(t["step_s"])
                / out["one_device_" + tag]["step_ms"],
                "peak_gib": t["peak_gib"]}
    return out


def mesh_pipe_leg(torch, fluid, T, fa, dev, cfg, seed):
    """``cfg``'s pipelined Transformer-base over {"pp": 2} against the
    one-device pipeline op, MESH_PIPE_STEPS steps from one state."""
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    state = seq_state(fluid, m, seed, dev)
    m["main"].random_seed = seed + 1
    rng = np.random.RandomState(seed + 2)
    feeds = [make_feeds(rng, cfg["batch_size"], cfg["seq_len"],
                        cfg["trg_vocab_size"])] * MESH_PIPE_STEPS
    one = mesh_steps(torch, fluid, fa, m, state, feeds, dev)
    pp = mesh_steps(torch, fluid, fa, m, state, feeds, dev, {"pp": 2},
                    ["cuda:0"] * 2)
    e = mesh_errors(pp, one)
    engine = ("circular" if cfg.get("pipeline_circular_repeats", 1) > 1
              else "gpipe")
    check(e["loss_rel"] <= MESH_PIPE_RTOL
          and e["param_rel"] <= MESH_PIPE_RTOL
          and pp["engines"][engine] == 2 * MESH_PIPE_STEPS
          and pp["graphs"] == 1 and one["graphs"] == 1,
          "pp %s against the one-device pipeline op" % engine, e,
          pp["engines"], pp["graphs"])
    return {"engine": engine, "stages": cfg["pipeline_stages"],
            "repeats": cfg.get("pipeline_circular_repeats", 1),
            "vs_one_device": e, "bitwise_one_device": same_bits(pp, one),
            "engines": pp["engines"], "losses": mesh_losses(pp),
            "step_ms": steady_ms(pp["step_s"]),
            "one_device_step_ms": steady_ms(one["step_s"]),
            "rank_state_bytes": pp["rank_state_bytes"],
            "peak_gib": pp["peak_gib"],
            "one_device_peak_gib": one["peak_gib"]}


def mesh_moe_leg(torch, fluid, fa, dev):
    """switch_moe over {"ep": 8} at a capacity that drops nothing against
    the dense rule, and the median ms a step of each over the replays of
    MESH_MOE_TIME_STEPS steps (from the third on); the tokens dropped at
    MOE_DROP_CAP."""
    from paddle_tpu_torch.parallel import moe as moe_mod

    c = MOE_CFG
    m = moe_model(fluid, capacity=MOE_NODROP_CAP)
    state = seq_state(fluid, m, SEED + 194, dev)
    m["main"].random_seed = SEED + 195
    rng = np.random.RandomState(SEED + 196)
    shape = (c["batch"], c["tokens"], c["d"])
    feed = {"x": rng.randn(*shape).astype(np.float32),
            "y": rng.randn(*shape).astype(np.float32)}
    feeds = [feed] * MESH_MOE_STEPS
    grads = [m[w] + "@GRAD" for w in ("gate", "w1", "w2")]
    fetch = [m["loss"].name] + grads
    one = mesh_steps(torch, fluid, fa, m, state, feeds, dev, fetch=fetch)
    ep = mesh_steps(torch, fluid, fa, m, state, feeds, dev,
                    {"ep": c["experts"]}, ["cuda:0"] * c["experts"],
                    fetch=fetch)
    e = mesh_errors(ep, one)
    e["grads"] = grad_l2(
        dict(zip(grads, ep["fetches"][0][1:])),
        {g: v.astype(np.float64) for g, v in zip(grads, one["fetches"][0][1:])})
    check(e["loss_rel"] <= MESH_MOE_RTOL and e["grads"]["l2"] <= MESH_MOE_RTOL
          and ep["engines"]["ep"] == MESH_MOE_STEPS,
          "switch_moe ep against the dense rule", e, ep["engines"])
    x = torch.as_tensor(feed["x"], device=dev).reshape(-1, c["d"])
    gate = torch.as_tensor(state[m["gate"]], device=dev)
    dropped = moe_mod.dropped_tokens(x, gate, c["experts"], MOE_DROP_CAP)
    none = moe_mod.dropped_tokens(x, gate, c["experts"], MOE_NODROP_CAP)
    check(dropped > 0 and none == 0, "switch_moe drops", dropped, none)
    # ms a step over MESH_MOE_TIME_STEPS replays of each, the loss fetched
    timed = {k: mesh_steps(torch, fluid, fa, m, state,
                           [feed] * MESH_MOE_TIME_STEPS, dev, *a)["step_s"]
             for k, a in (("dense", ()),
                          ("ep", ({"ep": c["experts"]},
                                  ["cuda:0"] * c["experts"])))}
    ms = {k: [t * 1e3 for t in v[2:]] for k, v in timed.items()}
    return {"experts": c["experts"], "tokens": int(x.shape[0]),
            "capacity_factor": MOE_NODROP_CAP, "vs_dense": e,
            "bitwise_dense": same_bits(ep, one), "losses": mesh_losses(ep),
            "step_ms": float(np.median(ms["ep"])),
            "dense_step_ms": float(np.median(ms["dense"])),
            "step_ms_timed": ms["ep"], "dense_step_ms_timed": ms["dense"],
            "over_dense": float(np.median(ms["ep"]) / np.median(ms["dense"])),
            "over_dense_range": [min(ms["ep"]) / max(ms["dense"]),
                                 max(ms["ep"]) / min(ms["dense"])],
            "graphs": ep["graphs"],
            "dropped_at_capacity": {"capacity_factor": MOE_DROP_CAP,
                                    "dropped_tokens": dropped,
                                    "of_tokens": int(x.shape[0])}}


def mesh_phase(torch, fluid, T, fa, dev):
    """The multi-rank engines on ranks that share the card (see the module
    docstring): dp x tp and ZeRO, sp, pp and ep."""
    card = card_line()
    out, seconds = {"card": card}, {}
    for name, fn, args in (
            ("dp_tp", mesh_dp_tp_leg, (torch, fluid, T, fa, dev)),
            ("sp", mesh_sp_leg, (torch, fluid, fa, dev)),
            ("pp_gpipe", mesh_pipe_leg,
             (torch, fluid, T, fa, dev, PIPE_CFG, SEED + 197)),
            ("pp_circular", mesh_pipe_leg,
             (torch, fluid, T, fa, dev, PIPE_CIRCULAR_CFG, SEED + 200)),
            ("ep", mesh_moe_leg, (torch, fluid, fa, dev))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        log("mesh phase, %s (%s): %s" % (name, card, json.dumps(
            out[name], default=str)))
    out["seconds"] = seconds
    log("mesh phase: %s" % json.dumps({"card": card, "seconds": seconds}))
    return out


def ps_free_ep():
    """An endpoint on a port the OS hands out."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return "127.0.0.1:%d" % s.getsockname()[1]


def ps_wait(ep, timeout=PS_JOIN_S):
    """Wait until a pserver listens at ``ep``."""
    host, port = ep.rsplit(":", 1)
    deadline = time.monotonic() + timeout
    while True:
        try:
            socket.create_connection((host, int(port)), timeout=1).close()
            return
        except OSError:
            check(time.monotonic() < deadline, "no pserver at " + ep)
            time.sleep(0.05)


def ps_slice_state(pprog, state):
    """``state`` cut to one pserver: a slice var gets its rows of its
    source (a [1]-shaped one a whole copy)."""
    slices = getattr(pprog, "_slice_vars", {})
    out = {}
    for v in pprog.list_vars():
        if v.persistable and v.name in slices:
            src, _, r0, r1 = slices[v.name]
            out[v.name] = state[src] if r0 is None else state[src][r0:r1]
        elif v.persistable and v.name in state:
            out[v.name] = state[v.name]
    return out


def ps_transpile(fluid, m, tid, eps, trainers, sliced):
    cfg = fluid.DistributeTranspilerConfig()
    cfg.slice_var_up = sliced
    t = fluid.DistributeTranspiler(config=cfg)
    t.transpile(trainer_id=tid, program=m["main"], startup_program=m["startup"],
                pservers=",".join(eps), trainers=trainers)
    return t


def ps_serve(fluid, dev, t, m, ep, state, ckpt=None):
    """One pserver of transpiler ``t`` at ``ep``, its Executor on ``dev``,
    in a thread: its startup, then ``state`` cut to its slices (None: a
    restart, which restores its checkpoint), then the serve loop."""
    pprog = t.get_pserver_program(ep)
    if ckpt is not None:
        pprog.global_block().ops[-1].attrs["checkpoint_dir"] = ckpt
    scope = fluid.Scope()
    exe = fluid.Executor(device=dev)
    exe.run(t.get_startup_program(ep, pprog, m["startup"]), scope=scope)
    if state is not None:
        fluid.load_numpy_state(pprog, ps_slice_state(pprog, state),
                               scope=scope, device=dev)
    errors = []

    def run():
        try:
            exe.run(pprog, scope=scope)
        except BaseException as exc:  # noqa: BLE001 - checked by ps_join
            errors.append(exc)

    th = threading.Thread(target=run, daemon=True, name="chip-pserver")
    th.start()
    ps_wait(ep)
    return {"thread": th, "scope": scope, "errors": errors,
            "program": pprog, "exe": exe}


def ps_join(servers):
    for s in servers:
        s["thread"].join(PS_JOIN_S)
        check(not s["thread"].is_alive() and not s["errors"],
              "a pserver did not stop cleanly", s["errors"])


def ps_trainer(fluid, dev, m, tid, eps, trainers, sliced, state):
    """Trainer ``tid``: its transpiled Program, a scope holding ``state``
    on ``dev``, its Executor."""
    t = ps_transpile(fluid, m, tid, eps, trainers, sliced)
    scope = fluid.Scope()
    fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
    return {"exe": fluid.Executor(device=dev), "scope": scope,
            "program": t.get_trainer_program(), "loss": m["loss"].name,
            "params": [p.name for p in
                       m["main"].global_block().all_parameters()],
            "losses": [], "rounds": []}


def ps_rounds(trainers, feeds):
    """One round: each trainer its feed, one thread a trainer."""
    errors = []

    def run(tr, feed):
        try:
            (lv,) = tr["exe"].run(tr["program"], feed=feed,
                                  fetch_list=[tr["loss"]], scope=tr["scope"])
            tr["losses"].append(np.asarray(lv).copy())
            tr["rounds"].append(dict(tr["exe"].last_pserver_round))
        except BaseException as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(tr, f), daemon=True)
               for tr, f in zip(trainers[1:], feeds[1:])]
    for th in threads:
        th.start()
    run(trainers[0], feeds[0])
    for th in threads:
        th.join(PS_JOIN_S)
        check(not th.is_alive(), "a trainer hung")
    if errors:
        raise errors[0]


def ps_params(fluid, tr):
    return {n: fluid.executor.as_numpy(tr["scope"][n]) for n in tr["params"]}


def ps_done(trainers):
    """Trainer 0's Executor.close shuts the pservers down; the others
    close their connections."""
    trainers[0]["exe"].close()
    for tr in trainers[1:]:
        for c in tr["exe"]._ps_clients.values():
            c.close()


def ps_line_model(fluid):
    """The fit-a-line Program of tests/unittests/
    test_distributed_pserver.py:233-307: w constant 0.2, b 0, SGD 0.1."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(
            input=x, size=1,
            param_attr=fluid.ParamAttr(
                name="w", initializer=fluid.initializer.Constant(0.2)),
            bias_attr=fluid.ParamAttr(
                name="b", initializer=fluid.initializer.Constant(0.0)))
        cost = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return {"main": main, "startup": startup, "loss": cost}


def ps_line_feeds(rounds):
    """Each of 2 trainers' 16 x 4 batch a round (the JAX package's test's
    data, seed 7)."""
    rng = np.random.RandomState(7)
    w_true = np.array([[0.5], [-1.0], [2.0], [1.5]], "float32")
    out = []
    for _ in range(rounds):
        xs = [rng.randn(16, 4).astype("float32") for _ in range(2)]
        out.append([{"x": x, "y": x @ w_true} for x in xs])
    return out


def ps_line_run(torch, fluid, dev, state, feeds, ckpt=None, restart_at=None):
    """2 trainers and 1 pserver over ``feeds`` (a list of rounds); with
    ``restart_at`` the pserver is shut down after that round and started
    again from ``ckpt``.  Returns (trainers, the pserver's params after
    the first round, the restart's record)."""
    m = ps_line_model(fluid)
    ep = ps_free_ep()
    t = ps_transpile(fluid, m, 0, [ep], 2, False)
    servers = [ps_serve(fluid, dev, t, m, ep, state, ckpt)]
    trainers = [ps_trainer(fluid, dev, ps_line_model(fluid), i, [ep], 2,
                           False, state) for i in range(2)]
    first, restart = None, None
    try:
        for k, round_feeds in enumerate(feeds):
            ps_rounds(trainers, round_feeds)
            if k == 0:
                first = {n: fluid.executor.as_numpy(servers[0]["scope"][n])
                         for n in ("w", "b")}
            if k + 1 == restart_at:
                poke = fluid.transpiler.pserver_runtime.PSClient(ep)
                poke.shutdown_server()
                poke.close()
                ps_join(servers)
                saved = np.load(os.path.join(ckpt, "pserver_params.npz"))
                servers = [ps_serve(fluid, dev, t, m, ep, None, ckpt)]
                scope = servers[0]["scope"]
                restart = {
                    "after_round": k + 1,
                    "restored_on_card": all(
                        scope[n].device.type == "cuda" for n in ("w", "b")),
                    "restored_bitwise": all(
                        fluid.executor.as_numpy(scope[n]).tobytes()
                        == saved[n].tobytes() for n in ("w", "b"))}
    finally:
        ps_done(trainers)
        ps_join(servers)
    return trainers, first, restart


def ps_round_contract_leg(torch, fluid, dev):
    """P1: one sync round of 2 trainers equals Executor.run's step on the
    concatenated batch (PS_RTOL, PS_ATOL); the trainers' parameters
    bitwise equal, and the pserver's."""
    m = ps_line_model(fluid)
    state = seq_state(fluid, m, SEED + 210, dev)
    (halves,) = ps_line_feeds(1)
    scope = fluid.Scope()
    fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
    fluid.Executor(device=dev).run(
        m["main"], feed={k: np.concatenate([h[k] for h in halves])
                         for k in ("x", "y")},
        fetch_list=[m["loss"]], scope=scope)
    single = {n: fluid.executor.as_numpy(scope[n]) for n in ("w", "b")}
    trainers, first, _ = ps_line_run(torch, fluid, dev, state, [halves])
    a, b = (ps_params(fluid, tr) for tr in trainers)
    err = {n: float(np.abs(first[n] - single[n]).max()) for n in single}
    ok = all(np.allclose(first[n], single[n], rtol=PS_RTOL, atol=PS_ATOL)
             for n in single)
    bitwise = all(a[n].tobytes() == b[n].tobytes() == first[n].tobytes()
                  for n in single)
    check(ok and bitwise, "P1: a sync round against one step on the "
          "concatenated batch", err, bitwise)
    return {"trainers": 2, "pservers": 1, "max_abs_err": err,
            "rtol": PS_RTOL, "atol": PS_ATOL, "trainers_bitwise": bitwise}


def ps_restart_leg(torch, fluid, dev):
    """P4: P1's cluster for PS_RESTART_ROUNDS rounds, its pserver shut down
    after round PS_RESTART_AT and started again from its checkpoint_dir;
    the trainers reconnect.  Losses and parameters bitwise an
    uninterrupted run's: no round applied twice, the restore in the
    card's tensors."""
    m = ps_line_model(fluid)
    state = seq_state(fluid, m, SEED + 211, dev)
    feeds = ps_line_feeds(PS_RESTART_ROUNDS)
    whole, _, _ = ps_line_run(torch, fluid, dev, state, feeds)
    ckpt = tempfile.mkdtemp(prefix="pserver_ckpt_")
    try:
        cut, _, restart = ps_line_run(torch, fluid, dev, state, feeds, ckpt,
                                      PS_RESTART_AT)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    bitwise = all(
        [v.tobytes() for v in a["losses"]] == [v.tobytes() for v in b["losses"]]
        and all(x.tobytes() == ps_params(fluid, b)[n].tobytes()
                for n, x in ps_params(fluid, a).items())
        for a, b in zip(cut, whole))
    check(bitwise and restart["restored_on_card"]
          and restart["restored_bitwise"],
          "P4: a restarted pserver against an uninterrupted run", bitwise,
          restart)
    return {"rounds": PS_RESTART_ROUNDS, "restart": restart,
            "bitwise_uninterrupted": bitwise,
            "losses": [float(v.reshape(-1)[0]) for v in cut[0]["losses"]]}


def ps_round_ms(rounds):
    """Each part of a round in ms, the mean over rounds 3 on (the first
    runs eager, the second captures)."""
    keys = ("compute_s", "fetch_s", "wire_s", "copy_s")
    out = {k[:-2] + "_ms": float(np.mean([r[k] for r in rounds[2:]])) * 1e3
           for k in keys}
    out["round_ms"] = float(np.mean([sum(r[k] for k in keys)
                                     for r in rounds[2:]])) * 1e3
    return out


def ps_transformer_leg(torch, fluid, T, fa, dev):
    """P2: Transformer-base at TRAIN_CFG's widths, dropout 0, through one
    trainer and two pservers with slice_var_up (its embedding tables cut
    in row halves), PS_TF_ROUNDS rounds, against Executor.run of the
    untranspiled Program from the same state on the same batches: losses
    and every parameter bitwise (one trainer averages g / 1, Adam is
    elementwise, and the pservers apply the trainer's noam LR: R-13); B1
    and B2 18 launches a round; the trainer's compute step and each
    pserver's apply captured once and replayed on every later round; the
    round's ms by part."""
    cfg = PS_CFG

    def model():
        with fluid.unique_name.guard():
            return T.get_model(**cfg)

    m = model()
    state = seq_state(fluid, m, SEED + 212, dev)
    rng = np.random.RandomState(SEED + 213)
    feeds = [mesh_feeds(rng, cfg) for _ in range(PS_TF_ROUNDS)]
    one = mesh_steps(torch, fluid, fa, m, state, feeds, dev)
    engine = bwd_engine(fa, "auto", cfg)
    check_flash_launches(fa, one["launches"], engine, 18 * PS_TF_ROUNDS,
                         "Executor.run beside the pservers")
    eps = [ps_free_ep(), ps_free_ep()]
    t = ps_transpile(fluid, m, 0, eps, 1, True)
    servers = [ps_serve(fluid, dev, t, m, ep, state) for ep in eps]
    tr = ps_trainer(fluid, dev, model(), 0, eps, 1, True, state)
    sliced = sorted(n for n, s in t.param_slices.items() if len(s) > 1)
    n_params = int(sum(np.prod(v.shape) for n, v in state.items()
                       if n in tr["params"]))
    fa.reset_launch_counts()
    graphs, ps_graphs = [], []
    try:
        applies = []
        for k, f in enumerate(feeds):
            ps_rounds([tr], [f])
            applies.append([dict(s["exe"].last_pserver_apply)
                            for s in servers])
            if k >= 1:
                graphs.append([b.graph for b in tr["exe"]._bound.values()])
                ps_graphs.append([[b.graph for b in s["exe"]._bound.values()]
                                  for s in servers])
        launches = dict(fa.KERNEL_LAUNCHES)
        params = ps_params(fluid, tr)
    finally:
        ps_done([tr])
        ps_join(servers)
    captured_once = (len(graphs[0]) == 1 and graphs[0][0] is not None
                     and all(g == graphs[0] for g in graphs))
    # each pserver's apply: one bound entry, captured at its second round
    # and replayed after
    ps_captured_once = all(
        len(first) == 1 and first[0] is not None
        and all(g[i] == first for g in ps_graphs)
        for i, first in enumerate(ps_graphs[0]))
    loss_bits = ([v.tobytes() for v in tr["losses"]]
                 == [f[0].tobytes() for f in one["fetches"]])
    param_bits = {n: params[n].tobytes() == one["params"][n].tobytes()
                  for n in params}
    bitwise = loss_bits and all(param_bits.values())
    check(bitwise and captured_once and ps_captured_once
          and {"src_word_emb", "trg_word_emb"} <= set(sliced),
          "P2: Transformer-base through pservers against Executor.run",
          loss_bits, [n for n, ok in param_bits.items() if not ok][:8],
          captured_once, ps_captured_once, sliced[:4])
    check_flash_launches(fa, launches, engine, 18 * PS_TF_ROUNDS,
                         "P2's trainer")
    return {"trainers": 1, "pservers": 2, "rounds": PS_TF_ROUNDS,
            "params": n_params,
            "grad_bytes_a_round": 4 * n_params,
            "sliced_params": len(sliced),
            "bitwise_executor_run": bitwise, "captured_once": captured_once,
            "pservers_captured_once": ps_captured_once,
            "launches": launches,
            "launches_per_round": {k: v / PS_TF_ROUNDS
                                   for k, v in launches.items()},
            "losses": [float(v.reshape(-1)[0]) for v in tr["losses"]],
            "round": ps_round_ms(tr["rounds"]),
            # each pserver's part of wire_ms, from round 3 on
            "pserver_apply_ms": [
                {k[:-2] + "_ms": float(np.mean([a[i][k] for a in applies[2:]]))
                 * 1e3 for k in ("average_s", "apply_s", "snapshot_s")}
                for i in range(len(servers))],
            "round_ms_all": [sum(r[k] for k in ("compute_s", "fetch_s",
                                                "wire_s", "copy_s")) * 1e3
                             for r in tr["rounds"]],
            "executor_step_ms": steady_ms(one["step_s"])}


def ps_deepfm_feeds(rng, n):
    """A batch whose label follows a hidden linear model of the ids (the
    JAX package's test_deepfm_trains)."""
    w = rng.randn(1000) * 0.5
    ids = rng.randint(0, 1000, size=(n, 26)).astype("int64")
    label = (w[ids].sum(1) + 0.2 * rng.randn(n) > 0).astype("float32")
    return {"feat_ids": ids, "label": label.reshape(n, 1)}


def ps_deepfm_leg(torch, fluid, dev):
    """P3: DeepFM at get_model's widths (26 fields, 1000 ids, k 8, hidden
    64/32, Adam 1e-3), PS_DEEPFM_BATCH rows a trainer, 2 trainers x 2
    pservers with slice_var_up, PS_DEEPFM_ROUNDS rounds on each trainer's
    batch: the trainers' parameters bitwise equal after every round, the
    losses finite and falling, and after round 1 the pservers' parameters
    (the sliced ones put back together) within PS_DEEPFM_RTOL of each
    tensor's largest magnitude of one Executor.run step on the
    concatenated batch."""
    from paddle_tpu_torch.models import deepfm

    def model():
        with fluid.unique_name.guard():
            return deepfm.get_model()

    m = model()
    state = seq_state(fluid, m, SEED + 214, dev)
    rng = np.random.RandomState(SEED + 215)
    feeds = [ps_deepfm_feeds(rng, PS_DEEPFM_BATCH) for _ in range(2)]
    scope = fluid.Scope()
    fluid.load_numpy_state(m["main"], state, scope=scope, device=dev)
    fluid.Executor(device=dev).run(
        m["main"], feed={k: np.concatenate([f[k] for f in feeds])
                         for k in feeds[0]},
        fetch_list=[m["loss"]], scope=scope)
    eps = [ps_free_ep(), ps_free_ep()]
    t = ps_transpile(fluid, m, 0, eps, 2, True)
    servers = [ps_serve(fluid, dev, t, m, ep, state) for ep in eps]
    trainers = [ps_trainer(fluid, dev, model(), i, eps, 2, True, state)
                for i in range(2)]
    bitwise, first, round_s = [], {}, []
    try:
        for k in range(PS_DEEPFM_ROUNDS):
            t0 = time.perf_counter()
            ps_rounds(trainers, feeds)
            round_s.append(time.perf_counter() - t0)
            a, b = (ps_params(fluid, tr) for tr in trainers)
            bitwise.append(all(a[n].tobytes() == b[n].tobytes() for n in a))
            if k == 0:
                first = {n: np.concatenate([
                    fluid.executor.as_numpy(servers[eps.index(ep)]["scope"][sn])
                    for sn, ep, _, _ in sl])
                    for n, sl in t.param_slices.items()}
    finally:
        ps_done(trainers)
        ps_join(servers)
    err = {}
    for n, v in first.items():
        want = fluid.executor.as_numpy(scope[n])
        err[n] = float(np.abs(v - want).max() / max(np.abs(want).max(), 1e-30))
    losses = [[float(v.reshape(-1)[0]) for v in tr["losses"]]
              for tr in trainers]
    worst = max(err, key=err.get)
    check(all(bitwise) and all(np.isfinite(l).all() for l in losses)
          and all(l[-1] < l[0] for l in losses)
          and err[worst] <= PS_DEEPFM_RTOL,
          "P3: DeepFM through 2 x 2 pservers", bitwise, losses, worst,
          err[worst])
    return {"trainers": 2, "pservers": 2, "rounds": PS_DEEPFM_ROUNDS,
            "batch_a_trainer": PS_DEEPFM_BATCH,
            "sliced_params": sorted(n for n, s in t.param_slices.items()
                                    if len(s) > 1),
            "trainers_bitwise_every_round": all(bitwise),
            "round1_vs_executor_run": {"worst": worst, "rel": err[worst]},
            "losses": losses, "round_ms": steady_ms(round_s)}


def pserver_phase(torch, fluid, T, fa, dev):
    """The parameter servers (see the module docstring): P1 the round
    contract, P2 Transformer-base, P3 DeepFM, P4 a restart."""
    card = card_line()
    out, seconds = {"card": card}, {}
    for name, fn, args in (
            ("round_contract", ps_round_contract_leg, (torch, fluid, dev)),
            ("transformer", ps_transformer_leg, (torch, fluid, T, fa, dev)),
            ("deepfm", ps_deepfm_leg, (torch, fluid, dev)),
            ("restart", ps_restart_leg, (torch, fluid, dev))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        log("pserver phase, %s (%s): %s" % (name, card, json.dumps(
            out[name], default=str)))
    out["seconds"] = seconds
    log("pserver phase: %s" % json.dumps({"card": card, "seconds": seconds}))
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


def recompute_phase(torch, fluid, T, fa, dev):
    """Recompute on the bound training step: Transformer-base at LONG_CFG
    (4 x 4096, dropout 0.1, Adam with noam decay, flash, f32 with TF32
    off) from one seeded start state, RECOMPUTE_STEPS steps through
    Executor.run without recompute and as many with
    ``enable_recompute(RECOMPUTE_SEGMENTS)``, on the same batches, each
    run on a fresh executor (eager, capture, replays).  Checks: losses
    and every persistable bitwise equal; one capture each; B2 18
    launches every step, B1 18 without recompute and 18 plus the
    attention calls of the checkpointed segments with it (the rerun of
    each in the backward), replays included.  Recorded for both: step
    ms and tokens/s from the third step, the capture step, peak device
    memory (reset before each run) and the graph's pool."""
    from paddle_tpu_torch import executor as executor_mod

    cfg = LONG_CFG
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    m["startup"].random_seed = SEED + 110
    m["main"].random_seed = SEED + 111   # the run seed of both runs
    start = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(m["startup"], scope=start)
    names = sorted(n for n in m["main"].persistable_names() if n in start)
    rng = np.random.RandomState(SEED + 112)
    feeds = [make_feeds(rng, cfg["batch_size"], cfg["seq_len"],
                        cfg["trg_vocab_size"])
             for _ in range(RECOMPUTE_STEPS)]
    tokens = cfg["batch_size"] * cfg["seq_len"]
    ops = m["main"].global_block().ops
    pre = ops[:next(i for i, op in enumerate(ops) if op.type == "backward")]
    segments = executor_mod.recompute_segments(pre, RECOMPUTE_SEGMENTS)
    rerun = sum(op.type == "flash_attention" for seg in segments[:-1]
                for op in seg)
    attention = sum(op.type == "flash_attention" for op in pre)
    check(attention == 18 and len(segments) == RECOMPUTE_SEGMENTS,
          "attention calls and segments", attention, len(segments))

    def run(segs):
        m["main"]._recompute_segments = 0
        if segs:
            m["main"].enable_recompute(segs)
        scope = copy_scope(fluid, start, names)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        c0 = executor_mod.compile_count()
        losses, step_s, compiles, launches = [], [], [], []
        for feed in feeds:
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            (loss,) = exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                              scope=scope)
            losses.append(np.array(loss))   # reading it waits for the step
            step_s.append(time.perf_counter() - t0)
            compiles.append(executor_mod.compile_count() - c0)
            launches.append([fa.KERNEL_LAUNCHES["flash_attention_fwd"],
                             fa.KERNEL_LAUNCHES["flash_attention_bwd"]])
        peak = torch.cuda.max_memory_allocated(dev)
        (entry,) = [b for b in exe._bound.values() if b.graph is not None]
        out = {"segments": segs, "losses": [float(x) for x in losses],
               "step_ms_all": [t * 1e3 for t in step_s],
               "step_ms": steady_ms(step_s),
               "capture_step_ms": step_s[1] * 1e3,
               "tokens_per_s": tokens / steady_ms(step_s) * 1e3,
               "peak_memory_gib": peak / 2 ** 30,
               "graph_pool_gib": entry.pool_bytes / 2 ** 30,
               "capture_ms": entry.capture_s * 1e3,
               "compiles_by_step": compiles, "launches_by_step": launches}
        state = host_state(torch, scope, names)
        del exe, entry, scope
        gc.collect()
        torch.cuda.empty_cache()
        return out, losses, state

    plain, plain_losses, plain_state = run(0)
    rec, rec_losses, rec_state = run(RECOMPUTE_SEGMENTS)
    m["main"]._recompute_segments = 0
    check(all(np.isfinite(x).all() for x in plain_losses), "non-finite loss",
          plain["losses"])
    check(all(a.tobytes() == b.tobytes()
              for a, b in zip(plain_losses, rec_losses)),
          "recompute losses not bitwise", plain["losses"], rec["losses"])
    moved = [n for n in names
             if not bits_equal(torch, plain_state[n], rec_state[n])]
    check(not moved, "recompute state not bitwise", moved[:8])
    for r, b1 in ((plain, 18), (rec, 18 + rerun)):
        check(r["compiles_by_step"][0] == 0
              and r["compiles_by_step"][1:] == [1] * (RECOMPUTE_STEPS - 1),
              "one capture, at step 2", r["segments"], r["compiles_by_step"])
        check(all(n == [b1, 18] for n in r["launches_by_step"]),
              "B1 %d and B2 18 launches a step" % b1, r["segments"],
              r["launches_by_step"])
    stats = {"config": "4 x 4096, dropout 0.1", "steps": RECOMPUTE_STEPS,
             "segments": RECOMPUTE_SEGMENTS,
             "segment_ops": [len(seg) for seg in segments],
             "attention_calls": attention,
             "attention_calls_rerun": rerun,
             "b1_launches_per_step": 18 + rerun, "b2_launches_per_step": 18,
             "bitwise_losses_and_state": True, "state_tensors": len(names),
             "without": plain, "with": rec,
             "step_ms_ratio": rec["step_ms"] / plain["step_ms"],
             "peak_memory_ratio": (rec["peak_memory_gib"]
                                   / plain["peak_memory_gib"])}
    log("recompute (Transformer-base 4 x 4096, dropout 0.1, "
        "enable_recompute(%d) against none): %s"
        % (RECOMPUTE_SEGMENTS, json.dumps(stats)))
    return stats


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
    sink = obs.RingBufferSink()
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
                 if r.get("source") == "trainer" and "checkpoint_save_s" in r]
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


# compute introspection on the Trainer at TRAIN_CFG: steps a leg, the
# attribution window, the slow reader's sleep a batch (more than twice the
# 181 ms step), profiled steps, and the limits of the FLOP count against
# the hand count and of memory_usage against the measured peak
INTRO_STEPS = 10
INTRO_WINDOW = 5
INTRO_SLOW_S = 0.4
INTRO_SLOW_STEPS = 5
INTRO_PROFILED_STEPS = 3
INTRO_FLOPS_RTOL = 0.01
INTRO_MEMORY_RATIO = 1.5


def transformer_step_flops(T, cfg):
    """FLOPs of one Transformer-base training step at ``cfg`` by hand:
    2·tokens·(linear weights) for the forward and twice that for the
    backward (dX and dW of every product), plus the 18 attentions at
    torch's SDPA conventions (4·B·H·T·S·D forward, 10 backward)."""
    d, di, L, H = T.D_MODEL, T.D_INNER, T.N_LAYER, T.N_HEAD
    b, t = cfg["batch_size"], cfg["seq_len"]
    weights = (L * (4 * d * d + 2 * d * di)        # encoder
               + L * (8 * d * d + 2 * d * di)      # decoder
               + d * cfg["trg_vocab_size"])        # output projection
    attentions = 3 * L * 14 * b * H * t * t * (d // H)
    return {"linear_weights": weights, "linear": 6 * b * t * weights,
            "attentions": attentions, "total": 6 * b * t * weights
            + attentions}


def introspection_phase(torch, fluid, T, fa, obs, dev):
    """Compute introspection (``observability.xla_stats``,
    ``StepAttribution``, the profiler, ``contrib.memory_usage``) over
    Transformer-base at TRAIN_CFG through ``fluid.Trainer`` (graphed from
    the third step).  (a) INTRO_STEPS steps with the plane off, then
    INTRO_STEPS from the same start with it armed (``sync_timing`` off):
    every parameter and Adam accumulator bitwise equal, the same device
    syncs in both runs (``count_syncs``), B1 and B2 18 launches every
    step.  (b) The armed run's count: FLOPs within INTRO_FLOPS_RTOL of
    ``transformer_step_flops``, bytes, peak memory, MFU against the
    table's H100 row (989.4e12) and against PEAK_F32_FLOPS pinned by
    ``configure_peaks``, the Trainer's records carrying ``mfu``.
    (c) ``train(attribution=StepAttribution(window_steps=INTRO_WINDOW))``:
    compute-bound with prefetch, input-bound with a reader sleeping
    INTRO_SLOW_S a batch.  (d) A INTRO_PROFILED_STEPS-step
    ``profiler(trace_dir=...)`` session: its Chrome trace holds B1's and
    B2's kernels; ``compiled_op_report`` of the count has a
    ``flash_attention`` row; ``memory_usage(main, batch)`` within
    INTRO_MEMORY_RATIO of ``max_memory_allocated`` over one eager step
    from a fresh peak."""
    import gc
    import shutil
    import tempfile

    from paddle_tpu_torch import executor as executor_mod
    from paddle_tpu_torch.observability import xla_stats

    t_phase = time.perf_counter()
    cfg = TRAIN_CFG
    batch = cfg["batch_size"]
    order = ["src_word", "trg_word", "lbl_word"]
    samples = trainer_samples(INTRO_STEPS * batch, SEED + 70, cfg)
    reader = fluid.reader.batch(lambda: iter(samples), batch)
    train_func, optimizer_func = transformer_trainer_funcs(fluid, T, cfg)
    stats = {"batch": batch, "seq_len": cfg["seq_len"], "card": card_line()}

    def trainer():
        np.random.seed(SEED + 71)   # one start state, one run seed
        return fluid.Trainer(train_func, optimizer_func,
                             place=fluid.CUDAPlace(0))

    def state_of(t):
        names = sorted(n for n in t.train_program.persistable_names()
                       if n in t.scope)
        return host_state(torch, t.scope, names)

    def run(t, **kw):
        box = {}
        box["syncs"] = count_syncs(torch, lambda: box.update(
            run=trainer_run(fluid, fa, executor_mod, t, reader, order,
                            INTRO_STEPS - 1, **kw)))
        r = box["run"]
        check(r["steps"] == list(range(INTRO_STEPS))
              and all(n == [18, 18] for n in r["launches"]),
              "introspection: steps and B1/B2 launches", r["launches"])
        return r, box["syncs"]

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    xla_stats.disable()
    xla_stats.reset()
    xla_stats.restore_defaults()
    sink = obs.RingBufferSink()
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        # -- (a) bitwise neutrality, and no added synchronization --------
        a = trainer()
        run_off, syncs_off = run(a)
        want = state_of(a)
        del a
        release()
        b = trainer()
        tag = "%x:v%d" % (id(b.train_program), b.train_program.version)
        xla_stats.enable()
        obs.add_sink(sink)
        try:
            run_on, syncs_on = run(b)
        finally:
            obs.remove_sink(sink)
        moved = state_moved(torch, b.scope, want)
        check(not moved, "introspection: the armed run moved bits",
              moved[:8])
        check([x.tobytes() for x in run_on["losses"]]
              == [x.tobytes() for x in run_off["losses"]],
              "introspection: the armed run's losses differ")
        check(syncs_on == syncs_off, "introspection: the armed plane added "
              "device syncs", syncs_on, syncs_off)
        stats["neutrality"] = {
            "params_and_moments_bitwise": len(want),
            "syncs_off": syncs_off, "syncs_on": syncs_on,
            "added_syncs_per_step": (sum(syncs_on.values())
                                     - sum(syncs_off.values()))
            / INTRO_STEPS}
        del want

        # -- (b) the count and MFU ----------------------------------------
        st = xla_stats.program_stats(tag)
        hand = transformer_step_flops(T, cfg)
        check(st is not None and st.steps > 0,
              "introspection: no count or no observed step", st)
        rel = abs(st.flops - hand["total"]) / hand["total"]
        check(rel < INTRO_FLOPS_RTOL, "introspection: counted FLOPs vs the "
              "hand count", st.flops, hand)
        step_s = st.total_time_s / st.steps
        mfu_bf16 = st.flops / step_s / xla_stats.device_peaks()[0]
        recs = [r for r in sink.records if r.get("source") == "trainer"]
        with_mfu = [r["step"] for r in recs if r.get("mfu") is not None]
        check(with_mfu and with_mfu[-1] == INTRO_STEPS - 1,
              "introspection: trainer records without mfu", with_mfu)
        # three more steps against the float32 roof, pinned
        xla_stats.configure_peaks(PEAK_F32_FLOPS, PEAK_BYTES_S)
        n0 = st.steps
        trainer_run(fluid, fa, executor_mod, b, reader, order, 2)
        st = xla_stats.program_stats(tag)
        mfu_f32 = st.last_mfu
        check(st.steps > n0 and mfu_f32 is not None,
              "introspection: no step observed against the pinned roof")
        stats["count"] = {
            "flops": st.flops, "hand_flops": hand,
            "flops_rel_err": rel, "bytes_accessed": st.bytes_accessed,
            "arg_bytes": st.arg_bytes, "out_bytes": st.out_bytes,
            "temp_bytes": st.temp_bytes,
            "peak_hbm_bytes": st.peak_hbm_bytes,
            "arith_intensity": st.arith_intensity,
            "observed_steps": st.steps,
            "mean_device_step_ms": step_s * 1e3,
            "host_step_ms": synced_ms(run_on),
            "mfu_vs_989.4e12_bf16_table": mfu_bf16,
            "mfu_vs_67e12_f32_pinned": mfu_f32,
            "bw_util_vs_3.35e12": st.last_bw_util,
            "trainer_records_with_mfu": with_mfu,
            "gauges": {g: obs.gauge(g).value for g in xla_stats.GAUGES}}
        report, rows = fluid.profiler.compiled_op_report(
            b.train_program, None, compiled=st)
        check("flash_attention" in rows and "backward" in rows,
              "introspection: compiled_op_report rows", sorted(rows))
        stats["op_rows"] = rows
        xla_stats.disable()
        xla_stats.restore_defaults()

        # -- (c) attribution: compute-bound, then input-bound --------------
        att = obs.StepAttribution(window_steps=INTRO_WINDOW)
        trainer_run(fluid, fa, executor_mod, b, reader, order,
                    INTRO_STEPS - 1, attribution=att, prefetch=True)
        fast = att.verdict()

        def slow_reader():
            for item in reader():
                time.sleep(INTRO_SLOW_S)
                yield item

        att = obs.StepAttribution(window_steps=INTRO_WINDOW)
        trainer_run(fluid, fa, executor_mod, b, slow_reader, order,
                    INTRO_SLOW_STEPS - 1, attribution=att, prefetch=True)
        slow = att.verdict()
        check(fast["verdict"] == "compute-bound", "introspection: the "
              "prefetched Trainer is not compute-bound", fast)
        check(slow["verdict"] == "input-bound", "introspection: the slow "
              "reader's Trainer is not input-bound", slow)
        stats["attribution"] = {"prefetch": fast, "slow_reader": slow,
                                "slow_reader_sleep_s": INTRO_SLOW_S}

        # -- (d) the profiler ----------------------------------------------
        t0 = time.perf_counter()
        with fluid.profiler.profiler(
                profile_path=os.path.join(trace_dir, "report.txt"),
                trace_dir=trace_dir):
            trainer_run(fluid, fa, executor_mod, b, reader, order,
                        INTRO_PROFILED_STEPS - 1)
        trace_path = os.path.join(trace_dir, fluid.profiler.TRACE_FILE)
        trace = json.load(open(trace_path))
        names = [e.get("name", "") for e in trace.get("traceEvents", [])
                 if e.get("cat") == "kernel"]
        found = {k: sum(k in n for n in names)
                 for k in ("flash_fwd_kernel", "flash_bwd_fused_kernel")}
        check(all(found.values()), "introspection: the trace lacks B1 or "
              "B2", found, len(names))
        report = open(os.path.join(trace_dir, "report.txt")).read()
        check("executor.run" in report, "introspection: profiler report",
              report)
        stats["profiler"] = {
            "steps": INTRO_PROFILED_STEPS,
            "seconds": time.perf_counter() - t0,
            "trace_bytes": os.path.getsize(trace_path),
            "kernel_events": len(names), "flash_kernel_events": found,
            "report": report.splitlines()[:4]}
        program = b.train_program
        del b
        release()

        # -- (d) memory_usage vs one eager step's peak ---------------------
        resident = torch.cuda.memory_allocated(dev)
        low, high, unit = fluid.contrib.memory_usage(program, batch)
        scale = {"GB": 2 ** 30, "MB": 2 ** 20, "KB": 2 ** 10, "B": 1}[unit]
        release()
        t = trainer()   # the same Program and start state, a new scope
        feed = fluid.DataFeeder([t.train_program.global_block().var(n)
                                 for n in order], fluid.CUDAPlace(0),
                                program=t.train_program).feed(
                                    samples[:batch])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with fluid.scope_guard(t.scope):
            t.exe.run(t.train_program, feed=feed, fetch_list=[t.loss],
                      use_program_cache=False)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        ratio = low * scale / peak
        check(1 / INTRO_MEMORY_RATIO <= ratio <= INTRO_MEMORY_RATIO,
              "introspection: memory_usage vs the measured peak",
              low * scale, peak)
        stats["memory"] = {
            "memory_usage_low_bytes": low * scale,
            "memory_usage_high_bytes": high * scale,
            "eager_step_peak_bytes": peak,
            "allocated_before_step": base,
            "resident_before_memory_usage": resident,
            "low_over_peak": ratio}
        del t, feed
        release()
    finally:
        obs.remove_sink(sink)
        xla_stats.disable()
        xla_stats.restore_defaults()
        shutil.rmtree(trace_dir, ignore_errors=True)
    stats["seconds"] = time.perf_counter() - t_phase
    log("introspection (Transformer-base %d x %d through fluid.Trainer): %s"
        % (batch, cfg["seq_len"], json.dumps(stats, default=str)))
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
    10 steps and 8 x 2048 for 8 (BENCH_BF16_LEGS), through bf16_leg on
    bench.py's feeds
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
    device syncs by the Python line that made them.  The notice that the
    mode is a prototype (once a process, at the first switch) is not a
    sync and is left out."""
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
        text = str(w.message).lower()
        if "synchroniz" in text and "prototype feature" not in text:
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

    if sys.argv[1:] == ["--only", "mesh"]:
        # the mesh phase alone (a quick check of the multi-rank engines);
        # the contract's run takes no arguments and runs every phase
        log("mesh phase: %s" % json.dumps(
            mesh_phase(torch, fluid, T, fa, dev), default=str))
        return 0
    if sys.argv[1:] == ["--only", "pserver"]:
        # the parameter-server phase alone
        pserver_phase(torch, fluid, T, fa, dev)
        return 0
    if sys.argv[1:] == ["--only", "quant"]:
        # the quantization phase alone
        quant_phase(torch, fluid, fa, dev)
        return 0
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    dec_checks, dec = decode_phase(torch, fa, dev, flush)
    clock(t_start, "decode_phase")
    pre = prefill_phase(torch, fa, dev, flush)
    clock(t_start, "prefill_phase")
    flash_cases, flash_times = flash_phase(torch, fa, dev, flush)
    clock(t_start, "flash_phase")
    pair_cases = pair_phase(torch, fa, dev)
    clock(t_start, "pair_phase")
    sweep = engine_sweep(torch, fa, dev, flush)
    del flush
    srv, srv_prompts, srv_outs = serving_phase(torch, T, serving, fa, obs,
                                               dev)
    clock(t_start, "serving_phase")
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    rt = runtime_phase(torch, T, serving, fa, obs, dev, srv_prompts)
    clock(t_start, "runtime_phase")
    torch.cuda.empty_cache()
    # the predict phase's two model versions, saved once: the pool phase
    # serves them first
    models = tempfile.mkdtemp(prefix="predict_models_")
    try:
        saved = save_predict_models(torch, fluid, T, models)
        pool = pool_phase(torch, T, serving, fa, obs, dev, srv_prompts,
                          srv_outs, saved)
        clock(t_start, "pool_phase")
        torch.cuda.empty_cache()
        sess = sessions_phase(torch, T, serving, fa, obs, dev)
        clock(t_start, "sessions_phase")
        torch.cuda.empty_cache()
        rtr = router_phase(torch, T, serving, fa, obs, dev, srv_prompts,
                           srv_outs, saved)
        clock(t_start, "router_phase")
        torch.cuda.empty_cache()
        leg = legacy_phase(torch, T, serving, fa, obs, dev, srv_prompts,
                           srv_outs)
        clock(t_start, "legacy_phase")
        torch.cuda.empty_cache()
        prd = predict_phase(torch, fluid, T, serving, fa, obs, dev, saved)
        clock(t_start, "predict_phase")
    finally:
        shutil.rmtree(models, ignore_errors=True)
    torch.cuda.empty_cache()
    lenet = lenet_phase(torch, fluid, dev)
    clock(t_start, "lenet_phase")
    op_rule_checks(fluid, dev)
    torch.cuda.empty_cache()
    rsn = resnet_phase(torch, fluid, fa, dev)
    clock(t_start, "resnet_phase")
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    ops_phase(torch, fluid, fa, dev)
    clock(t_start, "ops_phase")
    torch.cuda.empty_cache()
    zoo = zoo_phase(torch, fluid, fa, dev)
    clock(t_start, "zoo_phase")
    torch.cuda.empty_cache()
    log("ops and zoo phases: %.1f s" % (time.perf_counter() - t_new))
    t_new = time.perf_counter()
    sequence_phase(torch, fluid, fa, dev)
    clock(t_start, "sequence_phase")
    torch.cuda.empty_cache()
    log("sequence phase: %.1f s" % (time.perf_counter() - t_new))
    t_new = time.perf_counter()
    struct_phase(torch, fluid, fa, dev, zoo["word2vec"]["train"])
    clock(t_start, "struct_phase")
    del zoo
    torch.cuda.empty_cache()
    log("struct phase: %.1f s" % (time.perf_counter() - t_new))
    t_new = time.perf_counter()
    detection_phase(torch, fluid, fa, dev)
    clock(t_start, "detection_phase")
    torch.cuda.empty_cache()
    log("detection phase: %.1f s" % (time.perf_counter() - t_new))
    t_new = time.perf_counter()
    par = parallel_phase(torch, fluid, T, fa, dev)
    clock(t_start, "parallel_phase")
    torch.cuda.empty_cache()
    log("parallel phase: %.1f s" % (time.perf_counter() - t_new))
    t_new = time.perf_counter()
    msh = mesh_phase(torch, fluid, T, fa, dev)
    clock(t_start, "mesh_phase")
    torch.cuda.empty_cache()
    log("mesh phase: %.1f s" % (time.perf_counter() - t_new))
    t_new = time.perf_counter()
    pserver_phase(torch, fluid, T, fa, dev)
    clock(t_start, "pserver_phase")
    torch.cuda.empty_cache()
    log("pserver phase: %.1f s" % (time.perf_counter() - t_new))
    # card vs CPU: B2 at batch 2 x 64, B3 at batch 2 x 200
    fused_check = train_check_phase(torch, fluid, T, fa, dev, CHECK_CFG,
                                    "fused")
    clock(t_start, "train_check_phase")
    pair_check = train_check_phase(torch, fluid, T, fa, dev, PAIR_CHECK_CFG,
                                   "pair")
    clock(t_start, "train_check_phase")
    trn = train_phase(torch, fluid, T, fa, dev, TRAIN_CFG, TRAIN_STEPS,
                      "auto", "64 x 256")
    clock(t_start, "train_phase")
    torch.cuda.empty_cache()
    fast = fast_path_phase(torch, fluid, T, fa, dev)
    clock(t_start, "fast_path_phase")
    torch.cuda.empty_cache()
    trainer = trainer_phase(torch, fluid, T, fa, obs, dev, fast)
    clock(t_start, "trainer_phase")
    torch.cuda.empty_cache()
    introspection_phase(torch, fluid, T, fa, obs, dev)
    clock(t_start, "introspection_phase")
    torch.cuda.empty_cache()
    lenet_trainer_phase(torch, fluid, fa, dev, lenet)
    clock(t_start, "lenet_trainer_phase")
    torch.cuda.empty_cache()
    lng = train_phase(torch, fluid, T, fa, dev, LONG_CFG, LONG_STEPS,
                      "auto", "4 x 4096")
    clock(t_start, "train_phase")
    torch.cuda.empty_cache()
    rcp = recompute_phase(torch, fluid, T, fa, dev)
    clock(t_start, "recompute_phase")
    torch.cuda.empty_cache()
    rsn_bf16 = resnet_bf16_phase(torch, fluid, fa, dev, rsn)
    clock(t_start, "resnet_bf16_phase")
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    quant_phase(torch, fluid, fa, dev, rsn, rsn_bf16)
    clock(t_start, "quant_phase")
    torch.cuda.empty_cache()
    log("quant phase: %.1f s" % (time.perf_counter() - t_new))
    tbf = transformer_bf16_phase(torch, fluid, T, fa, dev, trn)
    clock(t_start, "transformer_bf16_phase")
    torch.cuda.empty_cache()
    transformer_decorate_phase(torch, fluid, T, fa, dev, trn)
    clock(t_start, "transformer_decorate_phase")
    torch.cuda.empty_cache()
    beam_phase(torch, fluid, T, fa, dev)
    clock(t_start, "beam_phase")
    torch.cuda.empty_cache()
    lbf = long_bf16_phase(torch, fluid, T, fa, dev)
    clock(t_start, "long_bf16_phase")

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
             [r["max_abs_err"] for r in pre]
             + [r["device_start"]["max_abs_err"] for r in pre
                if "device_start" in r])):
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
        if name in ("flash_attention_fwd", "flash_attention_bwd"):
            # the recompute leg (4 x 4096, enable_recompute(4)): launches
            # a step with recompute, replays included
            i = 0 if name == "flash_attention_fwd" else 1
            kernels[-1].update({
                "recompute_launches_by_step": [
                    n[i] for n in rcp["with"]["launches_by_step"]]})
        if name == "flash_attention_fwd":
            kernels[-1].update(fwd_long)
            kernels[-1].update(legacy_b1)
            kernels[-1].update(predict_b1)
            # the replica pool's predict load on each backend
            kernels[-1].update({
                "pool_predict_launches": {
                    b: pool["predict"][b]["launches"][name]
                    for b in ("program", "aot")},
                "pool_predict_dispatches": {
                    b: pool["predict"][b]["dispatches"]
                    for b in ("program", "aot")}})
        if name == "flash_attention_fwd":
            # the router's canary: "scorer" v1 and v2 through the router
            kernels[-1].update({
                "router_launches": rtr["canary"]["launches"],
                "router_dispatches": rtr["canary"]["dispatches"]})
        if name in ("paged_decode_attention", "paged_prefill_attention"):
            # the router's lm-a and lm-b, the serving prompts to each
            kernels[-1].update({
                "router_launches": rtr["bitwise"]["launches"][name],
                "router_dispatches": rtr["bitwise"][
                    "decode_steps" if name == "paged_decode_attention"
                    else "prefill_chunks"]})
        if name in ("paged_decode_attention", "paged_prefill_attention"):
            # the replica pool's decode load: four replicas on this card
            # at rotations 1, 2 and 4 and two profiled windows
            kernels[-1].update({
                "pool_launches": pool["decode"]["launches"][name],
                "pool_dispatches": pool["decode"][
                    "decode_steps" if name == "paged_decode_attention"
                    else "prefill_chunks"]})
            # the sessions phase's three pools (sessions, roles, control)
            kernels[-1].update({
                "sessions_launches": {
                    p: sess[p]["launches"][name]
                    for p in ("sessions", "roles", "control")},
                "sessions_dispatches": {
                    p: sess[p]["decode_steps"
                               if name == "paged_decode_attention"
                               else "prefill_chunks"]
                    for p in ("sessions", "roles", "control")}})
        if name in ("flash_attention_fwd", "flash_attention_bwd"):
            # ParallelExecutor on the one card (a one-device mesh,
            # TRAIN_CFG): its launches over PE_STEPS steps and a step
            pe = par["parallel_executor"]
            kernels[-1].update({
                "parallel_executor_launches": pe["launches"][name],
                "parallel_executor_launches_per_step":
                pe["launches_per_step"][name]})
        if name in ("flash_attention_fwd", "flash_attention_bwd"):
            # the mesh phase: four ranks on the card, launches a step on
            # the dp x tp leg (two dp ranks), the ZeRO legs (four) and
            # the Ulysses sp legs (four sp ranks, one op)
            kernels[-1].update({
                "mesh_dp_tp_launches_per_step":
                msh["dp_tp"]["launches_per_step"][name],
                "mesh_zero_launches_per_step": {
                    str(z): msh["dp_tp"]["zero"][z]["launches_per_step"][name]
                    for z in (0, 1, 3)},
                "mesh_ulysses_launches_per_step": {
                    t: msh["sp"]["ulysses_" + t]["launches_per_step"][name]
                    for t in ("full", "causal")}})
        if name == "flash_attention_bwd":
            kernels[-1].update(bwd_long)
        if name == "paged_decode_attention":
            kernels[-1].update({"kernels": list(B4_KERNELS),
                                "split_ms": d32["split_ms"],
                                "merge_ms": d32["merge_ms"],
                                "merge_share": d32["merge_share"]})
        if name in ("paged_decode_attention", "paged_prefill_attention"):
            # every decode step and prefill chunk is a CUDA graph replay
            # adding the L launches its capture recorded
            kernels[-1]["launches_are_replays"] = True
        if name == "paged_prefill_attention":
            kernels[-1]["start"] = "device memory (a [1] int32 tensor)"
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

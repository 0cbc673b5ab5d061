#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: raise unless CUDA is available; print the card's name and
   power limit as nvidia-smi reports them.
2. Build: nvcc builds every kernel under kubeflow_tpu_torch/ops/csrc into
   build/kernels/ (one nvcc per source, started together). ptxas's report
   must show no spill in any instance of the bf16 flash forward, dQ or
   dK/dV kernel or of the paged window kernel's bf16 (wgmma) instances,
   and no ignored setmaxnreg (C7508); their register counts are printed.
3. Kernels vs plain: each paged-attention kernel against its plain
   PyTorch version on the card, at gpt_small's serving shapes (8 slots,
   12 heads x 64, page 16, 64 pages a slot, 384 pool pages), bf16 and
   f32, with ragged cursors (0, 15, 16, 1023 and a parked 1024); the
   decode kernel also at cursors on its split edges (127, 128, 129;
   checked, not timed) and at one slot with cursor 1023 (one long row,
   the case the split over pages is for; timed); the window kernel also
   at s = 5 (the K+1 verify window of K = 4) and over a view of 8,192
   positions (512 pages a slot, past the old kernel's cap), both checked,
   not timed; then the window kernel at the batch-1 calls phase 5 makes
   (MAIN_WINDOWS), whose mean the kernels line reports; then both
   kernels at phase 11c's small-draft calls (4 heads x 16: the decode
   kernel at the 8 ragged cursors, the window kernel at MAIN_WINDOWS'
   cursors; bf16 and f32, checked, not timed). Times are
   medians over CUDA events with the L2 flushed before each launch.
4. Serve f32: gpt_small at full width (seeded init) behind the REST
   server on a real socket, paged_attention=kernel; two greedy
   `:generate` requests must equal the port's `generate()`.
5. Serve bf16 (the main path): the same server in bf16 with prefill
   buckets 8..256; concurrent requests of 5-120 tokens, one ~700-token
   prompt (head prefill + chunk windows through the window kernel) and
   one 300-token prompt sent twice (a prefix hit with copy-on-write).
   Every reply must be 200, every emitted token's f32 teacher-forced
   logit within DELTA of its position's max, and both kernels launched.

6. Flash kernels vs plain: the three flash-attention kernels (forward,
   dQ, dK/dV) against their plain PyTorch versions at the training
   microbatch shape (B=2, H=12, D=64, S=4096, causal, bf16) without and
   with a key mask, and in f32 at S=1024 (o, dQ, dK and dV each held row
   by row at its own scale in bf16: FLASH_REL); times as in phase 3, the
   bound from the visible (query, key) pairs, and
   scaled_dot_product_attention (forward; its autograd backward for the
   dQ + dK/dV pair) as the library yardstick.
7. Train f32: gpt_small at seq 1024, batch 2, f32, 3 steps of
   `Trainer.fit` from the same seeded init and batches, once through the
   flash kernels and once dense: per-step losses within rel 1e-5, the
   updates of a few q/k/MLP/head leaves within rel 1e-4 (L2), flash
   launches only in the flash run.
8. Train bf16 (the training main path): `run_training` of gpt_small at
   configs/gpt_longcontext_v5e16.yaml's one-card share (seq 4096, global
   batch 8 = 4 microbatches of 2, remat, loss_chunk 4096, full attention,
   AdamW lr 3e-4, wd 0.1) with attention_impl="flash", 6 steps: every
   loss finite, launch counts equal to the config's formula; the steady
   step is steps 2-6's wall time over 5, with one host sync at their end.
9. int8 kernels vs plain: the int8 variants of both paged kernels
   (int8 pools from `quantize_kv` of phase 3's seeded pools, bf16
   scales) against their plain version (gather, `dequant_kv`, dense
   core) at phase 3's calls, bf16 and f32 compute; the library yardstick
   is gather + `dequant_kv` + scaled_dot_product_attention, and the
   bound counts D + 2 bytes per live K and V vector.
10. Serve int8 (the int8 main path): gpt_small with quantize="int8"
   (int8 weights dequantized at use, int8 KV pages). f32: phase 4's two
   greedy prompts through the int8 kernels and through gather +
   `dequant_kv` must give the same tokens. bf16: phase 5's traffic; every
   reply 200, every emitted token's f32 teacher-forced logit within
   DELTA of its position's max under the f32 model of the same int8
   weights; only the int8 kernels launch, the window kernel once per
   layer for each of MAIN_WINDOWS; the auto-sized pool holds the int8
   capacity ratio times phase 5's pages in no more bytes; and
   `quantization_accuracy` of gpt_small (bf16 and f32, a seeded batch)
   stays within the JAX package's pinned limits (ACCURACY).
11. Serve with speculation (K = SPEC_K draft tokens, gpt_small at full
   width, 8 slots, page 16, paged_attention=kernel). 11a, f32: phase 4's
   two greedy prompts through a drafted engine must equal `generate()`,
   with the same weights as the draft and with a draft whose head is
   rolled one vocab row (it never proposes the target's argmax); the
   first must accept at least ACCEPT_SAME of its proposals, the second
   none; at quantize="int8" a drafted engine's tokens must equal the K = 0 int8
   engine's. 11b, bf16 over REST (the main path with speculation):
   `build_server(..., draft_model=<the model>, num_draft_tokens=K)` (the
   draft's seed-0 init is the target's) serves phase 5's traffic; every
   reply 200 and within DELTA; the decode kernel launches exactly
   verify_steps x (K+1) x the draft's layers (the target's one-token
   step never runs), the window kernel verify_steps x the target's
   layers plus the chunk windows of both models; pages_in_use returns to
   what the prefix index holds; one sampled request sent twice with one
   seed returns the same tokens. 11c, bf16 with a small draft (gpt_tiny's
   widths at gpt_small's vocabulary and window, SMALL_DRAFT: the decode
   kernel runs at D = 16 on the draft's pool): phase 5's traffic through
   the engine, the DELTA gate, the launch formula, pages given back by
   rewinds, no page leaked. Printed, not gated: each engine's accept
   rate, wall time per verify iteration and tokens per iteration, beside
   phase 5's K = 0 step time and tokens/s from the same call.
12. Checkpoints: train, preempt, resume, serve (gpt_small at full width).
   12a, bf16 through the flash kernels: `run_training` of CKPT_TRAIN_CFG
   (phase 7's seq 1024 and batch 2, AdamW as phase 8) for 4 steps with a
   save every 2; a second run in a fresh directory preempted during step
   2 (it must commit step 2); `run_training(restore=True)` runs steps
   3-4. The resumed run's losses and its step-4 checkpoint (params,
   AdamW moments, counts: every shard file) must equal the uninterrupted
   run's, bit for bit; flash launches equal 8 updates x 12 layers each.
   Printed with the card's name and power limit:
   checkpoint_blocked_seconds, checkpoint_save_seconds (means), the bytes
   written and the resume's restore seconds. 12b, `build_server(...,
   checkpoint_dir=<12a's>)`: f32, the served weights are the trainer's
   step-4 params bit for bit and phase 4's requests equal `generate()`;
   f32 with K = SPEC_K and the draft from the same checkpoint, tokens
   equal `generate()` and accept at least ACCEPT_SAME; bf16 with K =
   SPEC_K and `draft_checkpoint_dir` (no draft params), phase 5's traffic
   under 11b's gates, its accept rate printed beside 11b's; int8, the
   restored envelope is the port's quantize of the trainer's params bit
   for bit, and phase 10's f32 token check holds (buckets up to 32, so
   the int8 window kernel runs). The kernels line gives each row's
   `checkpoint_launches` (12a for the flash rows, 12b for the paged
   ones); a row at 0 fails.
13. KV tiers and page handoff (gpt_small at full width, 8 slots, page
   16, paged_attention=kernel, through build_server and REST). 13a: a
   server whose pool of KV_POOL_PAGES pages sits above a host tier of
   KV_HOST_BYTES, and an always-resident one (auto pool, no tier), both
   serve a KV_SHARED-token prefix with a tail, KV_FILLS distinct fills
   that evict its chain into the host tier, the prefix with a new tail
   (a host-tier hit: uploads, then a chunk window), and the first
   request again (its tail page re-admitted as the boundary upload); in
   bf16 and with int8 KV pages (f32 compute): every reply's tokens equal
   the always-resident server's, kv_spill_pages and kv_spill_hits > 0,
   and at int8 the re-admitted first request's tokens equal its first
   serve's. 13b: a bf16 server with a prefix store serves phase 5's
   prompts (the 300-token one twice) and drains, which writes the final
   persist; a new server on the directory preloads it, and its first
   request (the 300-token prompt) is a prefix hit whose tokens equal the
   first server's prefix hit's. 13c, f32, over localhost HTTP: `:prefill`
   on a prefill server ships the prompt's pages to a decode server, whose
   `:generate` is a prefix hit with the unified server's tokens; the
   unified server's `/v1/kv/handoff` to two decode peers lands each chain
   at `rendezvous_rank(first_page_key(...))[0]` alone, and the next
   request there is a prefix hit with the same tokens. Printed with the
   card's name and power limit: TTFT cold / HBM hit / host-tier hit,
   spill and upload ms a page, the host tier's bytes, persist and
   preload seconds and the bytes on disk, handoff ms a page. The kernels
   line gives each paged row its `kv_tier_launches`; a row at 0 fails.
14. Observability and fault recovery (gpt_small at full width, 8 slots,
   page 16, paged_attention=kernel, bf16, through build_server and REST,
   the tracer configured from KFT_TRACE_* env). 14a: phase 5's traffic
   (its prompts, the repeat after the others) on a fresh traced server,
   each request with an X-Request-Id and one with a traceparent, then on
   a fresh untraced one: every reply's tokens equal phase 5's bitwise;
   each id is echoed and the traceparent's trace continued (its spans'
   remote parent is the header's span); each request's
   `/debug/trace?trace_id=` holds its request.queue_wait, request.prefill
   and request.decode spans, with engine.step spans inside the decode
   span; `/tracez` keeps every request; `/statusz` has its engines
   section; the median engine.step span is within SPAN_STEP_REL of the
   run's decode_step_ms. Printed: decode tokens/s traced and untraced.
   14b: on a fresh traced server, `engine.step:after=CHAOS_STEP_AFTER,once`
   armed under phase 5's concurrent traffic: every reply equals phase 5's
   tokens or is a 500 naming "decode step failed", at least one is;
   serving_engine_recoveries_total rises by exactly 1 and the trace holds
   one engine.recover; once idle every page in use is the prefix index's
   (none when every request failed); the failed requests resubmitted
   give phase 5's tokens as prefix misses; the warm-up prompt, committed
   before the fault, is a miss with its first tokens (the radix index
   was reset); `engine.prefill:once` fails exactly one request and the
   next succeeds. Printed: the time from the fault to the next
   admission. 14c: phase 12's configuration through `run_training` with
   KFT_CHAOS_POINTS=CHAOS_TRAIN_PLAN raises ChaosError after step 2's save
   (the shard-write fault absorbed by the retry, step 2 committed, the
   plan disarmed); a restart without the plan resumes from step 2, and its
   losses and step-4 params equal phase 12's uninterrupted run's, bit for
   bit; train.device_step spans are recorded. The kernels line gives each
   bf16 paged and flash row its `chaos_launches`; a row at 0 fails.
15. Images (resnet50, bf16): 15a `run_training` at one card's share of
   configs/resnet50_imagenet_v5e16.yaml (RESNET_CFG), 15b train to
   accuracy from npz shards through the native reader and a bitwise
   resume, 15c `:predict_npy` under concurrent clients. None of the
   attention kernels launches in it (checked).
16. BERT-base pretraining (BERT_CFG: bert_base bf16, S=512, batch 32,
   dropout 0.1, AdamW lr 1e-4 with warmup 1, the mlm stream made on the
   card). Phase 6 also holds the three flash kernels at BERT's call
   (B=32, S=512, H=12, D=64, bidirectional, unmasked and with a ragged
   key mask) and times them beside their bound and SDPA (`is_causal=
   False`, a boolean key mask). 16a: `Trainer.fit` through the flash
   kernels for 10 steps: every loss finite, input made on the device,
   each flash kernel launched exactly steps x 12 times; printed:
   tokens/sec/card, step ms, MFU (`encoder_train_flops`), device busy ms
   a step and peak memory. 16b: the same weights and batches at dropout
   0 through flash and dense: one forward and backward on ragged key
   masks (loss and gradient norm), then 4 steps' losses, within
   BERT_LOSS_REL / BERT_GRAD_REL; both step times and "auto"'s choice
   printed. 16c: `run_training` cut to 4 steps with a save every 2,
   preempted during step 2 and resumed: losses and the step-4 checkpoint
   bit for bit with dropout 0.1 on. The kernels line gives each flash
   row its `bert_launches` (16a; a row at 0 fails) and its BERT-call
   timings (`bert_call`, `bert_call_unmasked`).
17. Data-parallel training through the gang launcher: ranks are
   subprocesses (`python3 chip_smoke.py --gang-rank`, env from
   `render_gang_env` on 127.0.0.1 and a held port, each with its own
   time limit, every rank killed on a failure). 17a: GANG_RESNET_CFG
   (15a's one-card share of configs/resnet50_imagenet_v5e16.yaml with
   `mesh: {data: 1}`) through `runtime/launcher.py main` at world 1 over
   NCCL, 20 steps: the process group's backend nccl, one gradient
   all-reduce a step, finite losses; images/sec/card and step ms of its
   last log window (steps 11-20) and device busy (a 4-step run after
   17b's, steps 2-4, CUDA activity traced) printed beside 15a's
   in-process numbers from the same call; 17a's two launches and 17b's
   run in turn in one rank process (a process start is ~20 s, more
   than their steps). 17b: GANG_GPT_CFG (phase 8's configuration, the lm stream
   made on the card) through the launcher, world 1 over NCCL, 10 steps:
   nccl, one all-reduce a step, each flash kernel launched its formula's
   count; tokens/sec/card and MFU beside phase 8's. 17c: two ranks on
   the one card over gloo (`initialize_from_env(backend="gloo")`; NCCL
   refuses two ranks on one device): resnet50 at a global batch of 128
   saved at step 2, and gpt_small at a global batch of 2 at seq 1024,
   3 steps each (the first runs of phase 19's pair of rank processes,
   started with the gangs of phases 19-23, after phase 18; its gates
   read after them), against world-1 runs of the same global batches in
   this process:
   losses within GANG_LOSS_REL, the ranks' losses,
   weights and BatchNorm running averages equal bit for bit, the final
   weights within GANG_STEP_REL of world 1's as a share of world 1's
   update over every leaf and GANG_LEAF_STEP_REL at the worst leaf, the
   averages within GANG_BN_REL of world 1's, the step-2 checkpoint
   (process_count 2) resumed at world 1 to a step-3 loss within
   GANG_LOSS_REL of the gang's. 17d: 15b's npz blobs host-fed at prefetch depth 0 and
   PREFETCH_DEPTH (the DevicePrefetcher's thread and side stream),
   twice each, deterministic cuDNN: losses and weights bit for bit; the
   train.host_wait share of each run printed. The kernels line gives
   each flash row its `dp_launches` (17b; a row at 0 fails).
18. MoE (MOE_MODEL: gpt_small_moe, gpt_small with every MLP a Switch
   MoE of 8 experts, top-1, capacity factor 1.25; seeded weights; the
   serving geometry of phase 5). 18a, f32 over REST: two greedy
   requests (one past the largest bucket) through the paged kernels and
   through gather give the same tokens. 18b, bf16 (the MoE main path):
   phase 5's traffic; every reply 200; each request that took no prefix
   hit is served again alone by a fresh engine of the same geometry
   (the same tokens, its routes recorded) and replayed in f32 fed its
   tokens and routed as the engine routed it: each emitted token's f32
   logit within DELTA of its position's max (the phase-5 rescore, which
   routes in f32 on its own, is printed: a route that rounding flips
   moves a token by a whole expert); no choice dropped at a decode
   step; routed + dropped positions = the positions fed x layers x k;
   both paged kernels launched. Printed: decode_step_ms beside phase
   5's, a profiled decode window's device busy and copy/cast share, the
   `moe:` statusz line. 18c, int8: two greedy requests answer 200
   through the int8 kernels alone; phase 10's accuracy gate on the int8
   envelope (the [E, ...] stacks included), bf16 and f32, with both
   forwards routed alike; each routing on its own, the loss delta is
   gated and the logit error and flipped routes printed. 18d:
   gpt_small_moe through phase 7 (f32 flash against dense, losses rel
   1e-5, MOE_TRAIN_LEAVES' updates rel 1e-4), moe_aux_loss finite.
   18e: `run_training` of MOE_TRAIN_CFG (configs/gpt_moe_v5e16.yaml at
   one card's share, `mesh: {data: 1}`): finite losses, flash launches
   equal the formula; printed: tokens/sec/card, step ms, MFU
   (`lm_train_flops`' MoE count), device busy, the dispatch and combine
   einsums' share of it (timed alone at the step's shapes), peak
   memory. 18f: bert_base_moe through 16a's step for 3 steps: finite
   losses, one flash launch per layer a step. The kernels line gives
   each row its `moe_launches` (18b, 18c, 18e; a row at 0 fails) and
   the flash rows their `moe_bert_launches` (18f).
19. Sequence parallelism (configs/gpt_longcontext_v5e16.yaml's sequence
   axis at a two-rank share on one card: SEQ_CFG, gpt_small bf16,
   remat, loss_chunk 4096, seq 8192 = two shards of the config's 4096,
   global batch 2, 2 steps). 19a: `mesh: {sequence: 2}` by ring
   attention, two ranks of `chip_smoke.py --gang-rank` over gloo on the
   one card (after 17c's runs in the same two processes, which then
   run 19b; the quartet of phases 20-23 runs at the same time), against
   world 1 in this process (attention "flash" over all
   8192 positions): every step's loss within GANG_LOSS_REL of world
   1's, the final weights bit for bit equal across the ranks, and each
   rank's flash launches the formula (rank i a layer: i + 1 forwards,
   twice under remat, i + 1 of each backward kernel; an invisible block
   launches nothing). 19b: the same cell by Ulysses attention (6 heads
   a rank; the H100 auto policy takes the flash kernels at S = 8192):
   the same gates, one of each kernel a layer (the forward twice).
   Printed: losses, the gap, launches and step ms per rank (two
   processes share the card: for the record). 19c: ranks 0 and 7 of
   the config's 8-rank ring at its own geometry (q, k, v [2, 32768, 12,
   64] bf16 in 8 blocks), through `parallel/ring_attention.py
   ring_pass` on blocks it already holds, forward and forward plus
   backward as CUDA-event medians after the L2 flush, beside one causal
   flash call over 32,768 positions and its balanced eighth; the
   merges timed alone at those shapes; launches against the formula;
   peak memory. Gate: rank 7's output and gradients against the full
   causal call within FLASH_REL, row by row. The kernels line gives
   each flash row its `seq_launches` (19a-19c; a row at 0 fails).
20. Expert parallelism (configs/gpt_moe_v5e16.yaml's `expert: 4` on one
   of its data shards: its training block loaded by
   `TrainingConfig.from_dict` as it is, then cut by EXPERT_CUT). 20a:
   `mesh: {expert: 4}`, gpt_small_moe bf16, remat, flash, 8 sequences of
   1024, 3 steps, four ranks of `chip_smoke.py --gang-rank` over gloo on
   the one card, against world 1 (18e's cell at 3 steps) in this
   process. Gates: the ranks' losses bit for bit equal and within
   GANG_LOSS_REL of world 1's, every replicated leaf bit for bit equal
   across the ranks (sha256 digests), each rank's expert-stack bytes
   (parameters and AdamW moments) exactly a quarter of world 1's, and
   each rank's flash launches the formula (steps x layers x 2 forwards
   under remat, steps x layers of each backward kernel). Printed: each
   rank's state bytes, max_memory_allocated and step ms (a record: the
   ranks share the card and gloo stages every collective through the
   host). 20c: the gang saves at step EXPERT_SAVE, each stack's blocks
   written by their rank (4 writers); world 1 restores that step: its
   stacks are the ranks' blocks at that step joined, bit for bit, and it
   resumes to the gang's step-3 loss within GANG_LOSS_REL. 20b:
   gpt_small_moe on `{sequence: 2}` at seq 2048 by ring attention (the
   router logits gathered over the ring, each rank routing whole rows),
   two ranks against world 1's flash over 2048 (2 steps): the same loss
   gates, ring launch formula as 19a. The kernels line gives each flash
   row its `ep_launches` (20a, 20b; a row at 0 fails).
21. Pipeline parallelism (configs/gpt_pipeline_1f1b_v5e16.yaml's
   `pipeline: 4` on one of its data shards: its training block loaded
   by `TrainingConfig.from_dict` as it is, then cut by PIPELINE_CUT).
   21a: `mesh: {pipeline: 4}`, gpt_small bf16, remat, flash, 16
   sequences of 1024, 1f1b over M = 4, 3 steps, four ranks of
   `chip_smoke.py --gang-rank` over gloo on the one card (3 layers a
   stage), against world 1 (the same cell at `{pipeline: 1}`) in this
   process. Gates: the stages' losses bit for bit equal and within
   GANG_LOSS_REL of world 1's, each stage's parameter bytes the
   formula's (its layers, the embeddings on stage 0, the final
   LayerNorm and head on the last), each stage's flash launches the
   formula (steps x 3 layers x M x 2 forwards under remat, steps x 3 x M
   of each backward kernel), each stage's live microbatches S − s, and
   the stage blocks joined within GANG_STEP_REL / GANG_LEAF_STEP_REL of
   world 1's weights (17c's bounds). 21b: the same four processes at M =
   PIPELINE_WIDE_M, one step under GPipe and one under 1F1B: live
   microbatches M on every stage against S − s, the two losses within
   GANG_LOSS_REL; each stage's max_memory_allocated printed under each.
   21c: the gang saves at step PIPELINE_SAVE (each stacked layer leaf in
   4 stage blocks, each written by its stage); world 1 restores that
   step into its model without stages: its leaves are the stage blocks
   joined, bit for bit, and it resumes to the gang's step-3 loss within
   GANG_LOSS_REL. The kernels line gives each flash row its
   `pp_launches` (21a; a row at 0 fails).
22. The job path (cluster/, controllers/gpujob.py and studyjob.py,
   runtime/executor.py), the control plane in its background mode (the
   ControllerManager's threads and the PodExecutor's loop). 22a:
   bench.py's LR sweep as a StudyJob: STUDY_TRIAL (resnet50, global batch
   128, 10 steps) over STUDY_RATES, each trial a GPUTrainJob on h100-1
   run in this process by InProcessTrainerRunner, parallelism 1,
   maximize items_per_sec. Gates: Completed with every trial succeeded,
   bestTrial the argmax of the trials' trainingMetrics, each trial's pod
   env carrying its own rate, finite losses, trial 0's final loss within
   GANG_LOSS_REL of a direct `run_training` here. Printed: trials/hr,
   each trial's wall s, items/sec and loss, the best trial. 22b:
   GANG_GPT_CFG at JOB_STEPS steps, a commit every JOB_SAVE, as a
   GPUTrainJob (maxRestarts 1) through SubprocessPodRunner (one
   `runtime/launcher.py` child a pod, world 1 over NCCL); the spec's
   chaos plan JOB_PLAN, rendered by the controller, fails attempt 0 at
   step JOB_SAVE + 1. Gates: Restarting then Succeeded with restarts 1,
   attempt 0 failed at the plan, the second pod's env with
   KFT_RESTORE_DIR, attempt 1 resumed at step JOB_SAVE to JOB_STEPS,
   its losses within JOB_LOSS_REL (bit for bit) of an uninterrupted run
   here, each attempt's flash launches (its launcher line's
   `kernel_launches`) the formula. The kernels line gives each flash
   row its `job_launches` (both attempts; a row at 0 fails).
23. The fsdp axis (FSDP_CFG: gpt_small at full width, FSDP_DEPTH's 6
   of its 12 layers, bf16, remat, flash, seq 1024, global batch 8,
   loss_chunk 1024, 3 steps with warmup 2). 23a: `mesh: {fsdp: 4}`,
   four ranks of `chip_smoke.py --gang-rank` over gloo on the one card
   (in the quartet of phases 20-21, before 20a), each holding its quarter of every leaf whose spec names fsdp,
   gathered at its use and reduce-scattered back; against world 1 (the
   same cell at `{data: 1}`) in this process. Gates: the ranks' losses
   bit for bit equal and within GANG_LOSS_REL of world 1's, the whole
   leaves bit for bit equal across the ranks, rank 0's gathered final
   weights within GANG_STEP_REL / GANG_LEAF_STEP_REL of world 1's update,
   each rank's parameter bytes the specs' formula (`fsdp_param_bytes`)
   and its AdamW moments twice that, its flash launches, gathers,
   reduce-scatters and bucket all-reduces their formulas. Printed: the
   bytes against world 1's, max_memory_allocated a rank against world
   1's, step ms a rank (a record). 23b: the same on `{data: 2, fsdp:
   2}`. 23c: 23a's step-FSDP_SAVE checkpoint (each split leaf in 4
   blocks, written by its rank) restored at world 1: its leaves are the
   ranks' blocks joined, bit for bit, and it resumes to the gang's
   step-3 loss within GANG_LOSS_REL. The kernels line gives each flash
   row its `fsdp_launches` (23a, 23b; a row at 0 fails).
24. The serving mesh (SERVE_CELLS on SERVE_TRAFFIC, phase 5's seeded
   weights and traffic): 24a gpt_small on `{tensor: 2}` in bf16 and 24b
   in int8 (in the pair), 24c on `{tensor: 2, fsdp: 2}` and 24d
   gpt_small_moe on `{tensor: 2, expert: 2}` (in the quartet). Rank 0
   serves the traffic behind its REST server, every other rank runs the
   relayed programs on its shard; each rank builds its model on the host
   and copies only its blocks to the card. Gates: the tokens bit for bit
   those of the 1×1 reference (phase 5's, 10's, 5's, 18b's), a rank's
   pool bytes, weight bytes and a decode step's gathers their formulas,
   rank 0's paged launches the reference's, rank 0's build and every
   worker's peak card memory within the formula (SERVE_MEM_SLACK). The
   kernels line gives the paged rows their `mesh_launches`.

Every phase prints its seconds, and the line before the nvidia-smi line
the whole run's. The last lines are the nvidia-smi line, a {"kernels":
[...]} JSON line,
and {"ok": true, "device": {...}}. f32 matmuls run in full f32: TF32 is
turned off for matmuls and cuDNN below.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# the H100's peaks, from the one table the port keeps
from kubeflow_tpu_torch.observability.mfu import (
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
    H100_PEAK_OPS as PEAK_OPS,
)

# tolerances of each kernel against its plain version on the same inputs:
# f32 differs only in summation order; bf16 may also round a score,
# probability or output element one bf16 ulp apart (2^-8 relative)
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
# a bf16 greedy token may differ from f32's argmax on a near-tie: each
# emitted token's f32 logit must be within DELTA of its position's max
DELTA = 0.25

# flash kernels against the plain versions. f32 (summation order only):
# absolute. bf16: each row (one head's D values at one position) within
# FLASH_REL of the larger of its own largest |value| and the tensor's
# median |value| — two bf16 ulps of the row's largest element, with
# margin — or within the f32 tolerance. A row's scale is its own, so a
# causal row late in the sequence (|values| ~ sqrt(e/S)) is held as
# tightly as an early one (|values| ~ 1). lse is f32 from exact bf16
# products: absolute.
FLASH_ATOL = {"float32": dict(o=1e-5, lse=1e-5, grad=1e-4),
              "bfloat16": dict(o=1e-5, lse=1e-3, grad=1e-4)}
FLASH_REL = 2e-2
# phase 7: f32 flash against dense, summation order only: per-step losses
# within TRAIN_LOSS_REL, and each checked leaf's 3-step update within
# TRAIN_UPDATE_REL of dense's (relative L2 norm). The leaves are ones
# whose gradient passes through attention's backward (q and k
# projections) or follows from its output; not the key bias, whose
# gradient is 0 up to rounding (softmax ignores a per-row shift), so
# that AdamW's per-element step there is noise in both runs.
TRAIN_LOSS_REL, TRAIN_UPDATE_REL = 1e-5, 1e-4
TRAIN_LEAVES = ("layers.0.attention.query.kernel",
                "layers.1.attention.key.kernel", "layers.1.mlp_wi.kernel",
                "head.kernel")
# the JAX package's pinned int8 accuracy gate (tests/test_quantize.py):
# logit max-abs-err and held-out next-token loss delta of the dequantized
# model against the full-width one
ACCURACY = {"logit_max_abs_err": 0.25, "loss_delta": 0.02}
# the training main path: configs/gpt_longcontext_v5e16.yaml at one card's
# share (each of its 16 chips holds 2 sequences x 4096 positions a
# microbatch)
TRAIN_CFG = dict(
    model="gpt_small", seq_len=4096, global_batch_size=8, accum_steps=4,
    remat=True, loss_chunk=4096, assume_full_attention=True,
    learning_rate=3e-4, warmup_steps=2, weight_decay=0.1, steps=6,
    dtype="bfloat16", attention_impl="flash", checkpoint={"enabled": False},
)
# phase 6's kernel shapes: one microbatch of TRAIN_CFG, gpt_small heads
FB, FH, FD, FS = 2, 12, 64, 4096
# the kernels built on wgmma (the flash kernels with TMA and setmaxnreg too):
# phase 2 fails when ptxas reports that one of their instances spills or
# ignored setmaxnreg. The flash kernels' instances are named <kernel>ILi<D>E;
# the window kernel's bf16 instances by the storage they read, full-width
# bf16 pages (a repeated template argument, S<n>_) or int8 (a)
HOPPER_KERNELS = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
WINDOW_HOPPER_KERNELS = {
    "paged_window_bf16": r"paged_window_kernelI13__nv_bfloat16S\d*_Li(?P<d>\d+)E",
    "paged_window_int8_bf16": r"paged_window_kernelI13__nv_bfloat16aLi(?P<d>\d+)E",
}

# gpt_small serving geometry (engine defaults: 8 slots, page 16); a
# serving-mesh rank's heads at tensor 2 (phase 24)
B, H, D, PS, MP, NUM_PAGES = 8, 12, 64, 16, 64, 384
MESH_H = H // 2
# ragged cursors of the 8-slot calls; 1024 = max_len is a parked slot
CURSORS = (0, 15, 16, 1023, 1024, 300, 517, 64)
# the decode kernel's split edges (a split is 128 keys at page 16) and its
# one-long-row call
SPLIT_EDGES, LONG_ROW = (127, 128, 129), (1023,)
# the K+1 verify window of K = 4 draft tokens
VERIFY = 5
# a long view (512 pages of 16 a slot): slots near its end, mid-way, on a
# split edge, and parked; pool pages for their live pages
LONG_MP, LONG_NUM_PAGES = 512, 1400
LONG_CURSORS = (8100, 4000, 128, LONG_MP * PS)

# phase 5's traffic: prefill buckets up to 256, chunk windows of 64 rows
# (the engine's chunk_len at page 16), one long prompt and one prompt
# sent twice
BUCKETS = "8,16,32,64,128,256"
CHUNK, LONG_LEN, HIT_LEN = 64, 700, 300
LARGEST = int(BUCKETS.split(",")[-1])
# the windows phase 5 hands the window kernel, each a batch-1 call at
# cursor = the window's first position: the long prompt's and the first
# 300-token prompt's windows after their head prefill, then the repeat's
# one window after its prefix hit (the whole prompt but its last token)
def main_windows(long_len=LONG_LEN, hit_len=HIT_LEN, largest=LARGEST,
                 chunk=CHUNK):
    """The chunk windows phase 5's traffic makes (each prompt but the
    long and the hit one fits a prefill bucket), by first position."""
    return (*range(largest, long_len, chunk), *range(largest, hit_len, chunk),
            hit_len - 1)


MAIN_WINDOWS = main_windows()
# phase 11: K draft tokens a verify iteration; 11c's draft has gpt_tiny's
# widths (head dim 16) at the target's vocabulary and window
SPEC_K = 4
SMALL_DRAFT = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128)
SMALL_H = SMALL_DRAFT["num_heads"]
SMALL_D = SMALL_DRAFT["hidden_size"] // SMALL_H
# 11a: a draft with the target's own weights, f32, accepts at least this
# share of its proposals (one-token steps and the K+1 verify window differ
# only in summation order)
ACCEPT_SAME = 0.99
# phase 12: gpt_small at phase 7's seq 1024 and global batch 2, AdamW as
# phase 8, saved every CKPT_INTERVAL steps; the second run is preempted
# during step CKPT_PREEMPT and resumed to the budget
CKPT_TRAIN_CFG = dict(
    model="gpt_small", seq_len=1024, global_batch_size=2, steps=4,
    learning_rate=3e-4, warmup_steps=2, weight_decay=0.1, dtype="bfloat16",
    attention_impl="flash",
)
CKPT_INTERVAL, CKPT_PREEMPT = 2, 2
# 12b's int8 serve: phase 4's prompts with buckets up to 32, so the
# 37-token prompt's tail is a chunk window (the int8 window kernel)
CKPT_INT8_BUCKETS = (8, 16, 32)
# phase 13: 13a's pool is small enough that radix eviction must fire,
# above a host tier of KV_HOST_BYTES; its traffic is a KV_SHARED-token
# prefix with a KV_TAIL-token tail, KV_FILLS distinct KV_SHARED-token
# fills (they evict the prefix's chain into the host tier), the prefix
# with a new tail, then the first request again
KV_POOL_PAGES, KV_HOST_BYTES = 128, 256 << 20
KV_SHARED, KV_TAIL, KV_FILLS, KV_MAX_NEW = 512, 16, 4, 16
# 13b: a persist keeps every page phase 5's prompts commit
KV_PERSIST_CHAINS = 256
# 13c: the prompt the prefill server hands off, and the two chains the
# unified server hands to its peers (f32)
HANDOFF_LEN = 300

# phase 14: 14b's plan fails phase 5's traffic's (CHAOS_STEP_AFTER + 1)-th
# decode iteration, by when every request is resident; 14c's fails the
# device step after step 2's save and that save's first shard write (its
# retry absorbs it)
CHAOS_STEP_AFTER = 6
CHAOS_TRAIN_PLAN = ("trainer.device_step:after=2,once;"
                    "checkpoint.shard_write:once")
# 14a: the median engine.step span within this share of the same run's
# decode_step_ms (a span that closed at the launches would read short)
SPAN_STEP_REL = 0.25
# 14a: the one request that arrives with a W3C traceparent
TRACE_ID, PARENT_SPAN = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
# the kernels line's rows phase 14 runs (bf16 pages and bf16 flash)
CHAOS_ROWS = ("paged_decode", "paged_window", "flash_fwd", "flash_bwd_dq",
              "flash_bwd_dkv")

# phase 15a: resnet50 at one card's share of
# configs/resnet50_imagenet_v5e16.yaml (global batch 1024 over data: 16):
# 64 images of 224² a step, bf16, its recipe with the lr scaled linearly
# (0.4 x 64 / 1024) and the warmup cut to the run, label smoothing 0.1,
# crop_flip, synthetic batches made on the card
RESNET_CFG = dict(
    model="resnet50", global_batch_size=64, steps=22,
    learning_rate=0.4 * 64 / 1024, warmup_steps=2, weight_decay=1e-4,
    label_smoothing=0.1, dtype="bfloat16", data={"augment": "crop_flip"},
    checkpoint={"enabled": False},
)
RESNET_PROFILED = 3
# 15b: blobs (10 classes, 32 px) written as npz shards, trained through
# the native shard reader until eval top-1 reaches the target
BLOBS_TRAIN, BLOBS_VAL, BLOBS_SIZE, BLOBS_CLASSES = 2048, 512, 32, 10
BLOBS_SHARDS = 4
ACCURACY_CFG = dict(
    model="resnet50", global_batch_size=64, steps=300, learning_rate=0.05,
    warmup_steps=5, weight_decay=1e-4, dtype="bfloat16",
    checkpoint={"enabled": False},
)
ACCURACY_TARGET, ACCURACY_EVERY = 0.9, 10
# the bitwise resume: saved at step 2 of 4, restarted
RESUME_STEPS, RESUME_AT = 4, 2
# 15c: a reply's top-1 must equal the reference's wherever the
# reference's margin (top logit over the runner-up) exceeds DELTA; served
# accuracy within ACC_GAP of 15b's eval; bf16 serving logits within
# PREDICT_LOGIT_REL of the largest |f32 CPU logit| (bf16 rounds to 2^-8
# relative at each of ~50 layers: ~sqrt(50) x 2^-8 ~ 0.03)
ACC_GAP, PREDICT_LOGIT_REL = 0.01, 0.05
# the :predict_npy load: 4 clients, each 8 requests of 16 images of 224²
PREDICT_CLIENTS, PREDICT_REQUESTS, PREDICT_ROWS = 4, 8, 16
# phase 16: bert_base pretraining at the JAX package's own BERT-base step
# (bench.py:290-316: seq 512, 32 sequences a chip, lr 1e-4, warmup 1,
# the synthetic mlm stream), bf16, the preset's dropout 0.1, AdamW; the
# stream is made on the card
BERT_CFG = dict(
    model="bert_base", seq_len=512, global_batch_size=32, steps=10,
    learning_rate=1e-4, warmup_steps=1, dtype="bfloat16",
    attention_impl="flash", checkpoint={"enabled": False},
)
BERT_PROFILED = 3
# the flash kernels at BERT's call (one layer of a BERT_CFG step), and the
# ragged key mask's kept lengths: a full row, a row of one key, the rest
# drawn from a seed (each row keeps at least one key, so flash and dense
# agree on every row)
BB, BS, BH, BD = 32, 512, 12, 64
BERT_LENGTHS = tuple([BS, 1] + [int(n) for n in np.random.default_rng(16)
                                .integers(1, BS + 1, BB - 2)])
# 16b: BERT_PARITY_STEPS steps of flash and of dense from one init on the
# same batches, dropout 0: losses within BERT_LOSS_REL, and one forward
# and backward on a ragged-mask batch within it (loss) and
# BERT_GRAD_REL (global gradient norm). bf16: dense rounds QKᵀ and the
# 1/sqrt(D) scale to bf16 (2^-9 relative each) where flash keeps them in
# f32, so a score of size |s| moves by up to ~2^-8 |s| and its
# probability by as much relative; over 12 layers that reaches the logits
# as noise of a few 2^-8, and the mean over ~2,500 masked tokens and 32
# NSP rows keeps ~1/sqrt(2,500) of it. The bounds leave that room
# several times over; a gradient norm sums every element's noise.
BERT_PARITY_STEPS = 4
BERT_LOSS_REL, BERT_GRAD_REL = 2e-3, 2e-2
# 16c: 16a's configuration cut to 4 steps, a save every 2, the second run
# preempted during step 2 and resumed, at bert_base's dropout
BERT_CKPT_STEPS, BERT_CKPT_INTERVAL, BERT_CKPT_PREEMPT = 4, 2, 2
BERT_DROPOUT = 0.1
# phase 18: gpt_small_moe (gpt_small with every MLP a Switch MoE of 8
# experts, top-1, capacity factor 1.25, aux weight 0.01; ~559M
# parameters; seeded weights) and bert_base_moe. 18a/18c: two greedy
# prompts, the second past the largest bucket (a head prefill and chunk
# windows); 18b's decode profile: every slot decoding a 300-token prompt
MOE_MODEL, MOE_SEED = "gpt_small_moe", 0
MOE_PROMPTS, MOE_NEW = (37, 300), 16
MOE_PROFILE_PROMPT, MOE_PROFILE_NEW, MOE_PROFILE_S = 300, 200, 0.5
# 18d: phase 7's leaves, the MLP's replaced by an expert stack
MOE_TRAIN_LEAVES = ("layers.0.attention.query.kernel",
                    "layers.1.attention.key.kernel", "layers.1.moe.wi",
                    "head.kernel")
# 18e: configs/gpt_moe_v5e16.yaml at one card's share: its global batch of
# 64 over data 8 is 8 sequences of 1024 a card, every expert on the one
# card (`mesh: {data: 1}`; phase 20 runs the config's `expert: 4` on one
# data shard); cut to 8 steps, warmup 2 (the config's 2000 of 20000)
MOE_TRAIN_CFG = dict(
    model=MOE_MODEL, seq_len=1024, global_batch_size=8, remat=True,
    loss_chunk=1024, assume_full_attention=True, learning_rate=3e-4,
    warmup_steps=2, weight_decay=0.1, steps=8, dtype="bfloat16",
    attention_impl="flash", mesh={"data": 1}, checkpoint={"enabled": False},
)
MOE_PROFILED = 3
# 18f: phase 16's BERT-base step (bf16, S=512, batch 32, dropout 0.1) on
# bert_base_moe, 3 steps
MOE_BERT_CFG = dict(model="bert_base_moe", steps=3)
# phase 17: the gang launcher (runtime/launcher.py, one subprocess a rank,
# render_gang_env's env on 127.0.0.1). 17a: 15a's configuration (one
# card's share of configs/resnet50_imagenet_v5e16.yaml) and 17b: phase
# 8's (configs/gpt_longcontext_v5e16.yaml), at world 1
# over NCCL. The launcher logs a window every 10 steps and reports the
# last: 17a runs 20 (steps 11-20 reported; a second run of 4 steps is
# profiled), 17b 10 (2-10)
GANG_RESNET_CFG = dict(RESNET_CFG, steps=20, mesh={"data": 1})
GANG_GPT_CFG = dict(TRAIN_CFG, steps=10, mesh={"data": 1})
# a rank's own time limit (its process's start, kernel loads and run)
GANG_RANK_TIMEOUT_S = 300
# 17c: two ranks on the one card over gloo (NCCL refuses two ranks on one
# device): resnet50 at a global batch of 128 (64 a rank; 15a's recipe,
# its lr scaled to the batch) saved at step 2, and gpt_small at a global
# batch of 2 at seq 1024 (one sequence a rank, dropout 0), 3 steps each,
# against world-1 runs of the same global batches. bf16 rounds each
# activation to 2^-8 relative, and the gang's batch statistics and
# gradient sums add in another order than one card's. Read on an H100
# 80GB HBM3 at 700 W (the same in two calls): losses within 2.2e-05
# (resnet50) and 3.1e-05 (gpt_small) of world 1's, a restored run's
# step-3 loss within 1.3e-06; the final weights' gap to world 1's over
# world 1's update 1.4e-02 (resnet50) and 3.3e-02 (gpt_small) over every
# leaf, 0.20 at resnet50's worst leaf (a late BatchNorm bias, whose
# gradient is a sum that nearly cancels) and 0.12 at gpt_small's; running
# averages within 1.1e-03 of a leaf's largest. A wrong gradient step
# reads far wider: a rank that skips the all-reduce steps on half the
# batch (and the ranks differ), a doubled or halved SGD step, or a leaf
# whose update is lost, read 0.5 or more of the update
GANG2_STEPS, GANG2_SAVE = 3, 2
GANG2_RESNET_CFG = dict(
    model="resnet50", global_batch_size=128, steps=GANG2_STEPS,
    learning_rate=0.4 * 128 / 1024, warmup_steps=1, weight_decay=1e-4,
    label_smoothing=0.1, dtype="bfloat16", data={"augment": "crop_flip"},
)
GANG2_GPT_CFG = dict(
    model="gpt_small", seq_len=1024, global_batch_size=2, steps=GANG2_STEPS,
    learning_rate=3e-4, warmup_steps=1, weight_decay=0.1, dtype="bfloat16",
    attention_impl="flash", checkpoint={"enabled": False},
)
GANG_LOSS_REL, GANG_BN_REL = 1e-3, 5e-2
GANG_STEP_REL, GANG_LEAF_STEP_REL = 0.1, 0.5
# 17d: 15b's npz blobs host-fed at depth 0 and PREFETCH_DEPTH
PREFETCH_DEPTH = 2
PREFETCH_CFG = dict(ACCURACY_CFG, steps=20)
# phase 19: configs/gpt_longcontext_v5e16.yaml's sequence axis at a
# two-rank share on one card. Each rank holds 4096 positions, the
# config's per-chip shard of 32,768 over its 8 ranks, and the global
# batch is 2, the config's microbatch of one data rank (16 / 2 / 4);
# phase 8's learning-rate overrides, 2 steps. 19a rings it, 19b runs
# Ulysses (12 heads, 6 a rank); world 1 is the same cell in-process with
# the flash kernels over all 8192 positions: the function both compute.
# Bounds: every step's loss within GANG_LOSS_REL (17c's bf16 bound) of
# world 1's, the ranks' final weights equal bit for bit, and rank 0's
# final weights against world 1's under 17c's GANG_STEP_REL and
# GANG_LEAF_STEP_REL. Under warmup 2 the first update runs at lr 0, so
# both losses are read at the initial weights: the second update (lr >
# 0) is what the weight gate holds, the gradients of the ring and of
# Ulysses. Read on an H100 80GB HBM3 at 700 W: losses within 1.564e-06
# (ring) and 2.954e-06 (Ulysses); weights 3.855e-02 / 9.734e-02 (ring)
# and 2.115e-03 / 1.287e-02 (Ulysses) of world 1's update
SEQ_RANKS = 2
SEQ_CFG = dict(TRAIN_CFG, seq_len=2 * 4096, global_batch_size=2,
               accum_steps=1, steps=2)
# 19c: one ring rank's block loop at the config's own geometry: q, k, v
# [2, 32768, 12, 64] bf16 in 8 blocks of 4096 (ranks 0 and 7)
RING_B, RING_S, RING_N = 2, 32768, 8
# phase 20: configs/gpt_moe_v5e16.yaml's expert axis on the one card. 20a:
# its training block loaded as it is, cut to one of its 8 data shards:
# `mesh: {expert: 4}` (its own degree, 2 of gpt_small_moe's 8 experts a
# rank), its global batch of 64 over data 8 = 8 sequences of 1024, bf16,
# remat, loss_chunk 1024, flash, 3 steps with warmup 2 (its 2000 of
# 20000), 4 gloo ranks against world 1 (18e's cell at 3 steps). 20c: the
# gang saves at EXPERT_SAVE (the config's checkpoint block, interval cut)
# and world 1 restores that step. 20b: gpt_small_moe on `{sequence: 2}`
# at seq 2048 (1024 a rank), batch 2, ring, 3 steps (the third loss
# after an update at lr > 0), against world 1's flash over 2048, its
# rank 0's final weights against world 1's as 19's are, the routers and
# expert stacks by the worst-leaf bound alone (`update_gate`). Bounds:
# GANG_LOSS_REL (17c's bf16 bound), GANG_STEP_REL and GANG_LEAF_STEP_REL
EXPERT_CONFIG = os.path.join("configs", "gpt_moe_v5e16.yaml")
EXPERT_RANKS, EXPERT_SAVE = 4, 2
EXPERT_CUT = dict(steps=3, warmup_steps=2, seq_len=1024,
                  attention_impl="flash")
EXPERT_SEQ_CFG = dict(MOE_TRAIN_CFG, seq_len=2048, global_batch_size=2,
                      steps=3, attention_impl="ring", mesh={"sequence": 2})
# phase 21: configs/gpt_pipeline_1f1b_v5e16.yaml's pipeline axis on the
# one card. 21a: its training block loaded as it is, cut to one of its 4
# data shards: `mesh: {pipeline: 4}` (its own degree, 3 of gpt_small's 12
# layers a rank), its global batch of 64 over data 4 = 16 sequences of
# 1024, bf16, remat, 1f1b over M = 4 microbatches (its default: one a
# stage), flash, 3 steps with warmup 2 (its 2000 of 20000), four gloo
# ranks against world 1 (the same cell at `{pipeline: 1}`) in this
# process. 21b: the same ranks at M = PIPELINE_WIDE_M, one step under
# each schedule. 21c: the gang saves at PIPELINE_SAVE (the config's
# checkpoint block, interval cut) and world 1 restores that step.
# Bounds: GANG_LOSS_REL (17c's bf16 bound); the stage blocks joined
# against world 1's weights, 17c's GANG_STEP_REL and GANG_LEAF_STEP_REL
PIPELINE_CONFIG = os.path.join("configs", "gpt_pipeline_1f1b_v5e16.yaml")
PIPELINE_SAVE, PIPELINE_WIDE_M = 2, 8
PIPELINE_CUT = dict(steps=3, warmup_steps=2, attention_impl="flash")
# phase 23: the fsdp axis on the one card. 23a: gpt_small at full width
# (768/12/12/3072/50257), bf16, flash, remat, seq 1024, a global batch of 8
# (20a's: 8 sequences of 1024, 2 a rank), loss_chunk 1024, 3 steps with
# warmup 2, on `{fsdp: 4}`: four gloo ranks on the one card, each holding
# its quarter of every leaf whose spec names fsdp (every kernel on its
# embed dim, `pos_emb` and the head's kernel; the 50,257-row `tok_emb` and
# the 1-D leaves whole), saving at FSDP_SAVE. 23b: the same cell on
# `{data: 2, fsdp: 2}`. Each against world 1 (the same cell at `{data: 1}`)
# in this process. 23c: 23a's step-FSDP_SAVE checkpoint restored at world
# 1. Bounds: GANG_LOSS_REL (17c's bf16 bound), rank 0's gathered final
# weights against world 1's update by GANG_STEP_REL and GANG_LEAF_STEP_REL,
# a rank's parameter and moment bytes the specs' formula
# (`fsdp_param_bytes`), the flash launches, gathers, reduce-scatters and
# bucket all-reduces their formulas
FSDP_SAVE = 2
FSDP_CFG = dict(TRAIN_CFG, seq_len=1024, global_batch_size=8, accum_steps=1,
                loss_chunk=1024, steps=3)
# 23a's and 23b's depth: 6 of gpt_small's 12 layers (every width and
# every gate kept), so the quartet, the long pole of `phase_gangs`, keeps
# phase 24's cells inside the script's time limit
FSDP_DEPTH = {"num_layers": 6}
FSDP_MESHES = (("23a", {"fsdp": 4}), ("23b", {"data": 2, "fsdp": 2}))
# phase 24: the serving mesh on the one card (parallel/serving_mesh.py,
# serving/relay.py). Each cell serves phase 5's seeded weights (build_server's
# seed-0 init) at full width behind rank 0's REST server on phase 5's
# geometry and traffic (8 slots, page 16, the prefix cache, the seven
# concurrent greedy requests of 5-700 tokens with 32 new, then the
# 300-token request again), its pool auto-sized by the tensor rule (the
# 1×1 static pages times tensor), the ranks gloo ranks sharing the card.
# 24a: gpt_small on {tensor: 2}, bf16; 24b: the same in int8; 24c:
# gpt_small on {tensor: 2, fsdp: 2}, bf16; 24d: gpt_small_moe on {tensor:
# 2, expert: 2}, bf16. Gates: each cell's tokens equal its 1×1 reference
# bit for bit (phase 5's, phase 10's, phase 5's, 18b's); a rank's pool
# bytes the 1×1 pool's at tensor times the pages, its weight bytes and a
# step's gathers their specs' formulas; rank 0's paged launches phase 5's
# (744 decode, 108 window, at H = 6 a rank)
SERVE_CELLS = (("24a", "gpt_small", {"tensor": 2}, "none"),
               ("24b", "gpt_small", {"tensor": 2}, "int8"),
               ("24c", "gpt_small", {"tensor": 2, "fsdp": 2}, "none"),
               ("24d", MOE_MODEL, {"tensor": 2, "expert": 2}, "none"))
SERVE_TRAFFIC = dict(lens=(5, 17, 33, 64, 120, LONG_LEN, HIT_LEN),
                     max_new=32, buckets=BUCKETS, dtype="bfloat16")
# a rank's card memory against its formula (the ranks build their models
# on the host and copy only their blocks to the card): rank 0's build
# holds its weights (the specs' formula) and its pools plus at most
# SERVE_MEM_SLACK (allocator rounding, small buffers); a worker's peak,
# its build and the traffic, holds the same plus the activations rank 0's
# traffic read (rank 0's peak less its weights and pools), plus the slack
SERVE_MEM_SLACK = 64 << 20
# a gang of phase_gangs: its ranks' time limit (the gangs run at once)
GANGS_TIMEOUT_S = 600
# phase 22: the job path (cluster/, controllers/gpujob.py and studyjob.py,
# runtime/executor.py). 22a: bench.py's `bench_studyjob_trials`, the
# BASELINE's "Katib StudyJob HP sweep over tf-cnn learning rate", as a
# StudyJob of GPUTrainJob trials (h100-1, `mesh: {data: 1}`): resnet50 at
# a global batch of 128, 10 steps, checkpoints off, learning_rate over
# STUDY_RATES, parallelism 1, objective maximize items_per_sec, each trial
# run in this process by PodExecutor(InProcessTrainerRunner()). 22b:
# GANG_GPT_CFG (phase 8's cell) at JOB_STEPS steps with a commit every
# JOB_SAVE, one GPUTrainJob (h100-1, maxRestarts 1) through
# SubprocessPodRunner: one launcher child a pod, world 1 over NCCL. Its
# spec's chaos plan JOB_PLAN fails attempt 0 at the device step after the
# step-JOB_SAVE commit; the restart resumes from that step. Its final loss
# against an uninterrupted in-process run of the same config: JOB_LOSS_REL
# (0: bit for bit, as phase 12's resume)
STUDY_RATES = (0.1, 0.03, 0.01, 0.003)
STUDY_TRIAL = dict(model="resnet50", global_batch_size=128, steps=10,
                   mesh={"data": 1}, checkpoint={"enabled": False})
JOB_STEPS, JOB_SAVE = 4, 2
JOB_PLAN = f"trainer.device_step:after={JOB_SAVE},once,attempt=0"
JOB_LOSS_REL = 0.0
# the whole phase's time limit for each of 22a's study and 22b's job
JOB_TIMEOUT_S = 2 * GANG_RANK_TIMEOUT_S


def hopper_kernel_report(log, kernels=HOPPER_KERNELS):
    """{(kernel, D): (registers, spill store bytes, spill load bytes)} of
    each instance of `kernels` in a ptxas report (nvcc -Xptxas -v); raises
    when one spills, when ptxas ignored a setmaxnreg (C7508), or when an
    instance is missing. `kernels` names kernels whose instances are
    <kernel>ILi<D>E, or maps a label to a pattern of its instances' names
    with D as the group `d`."""
    if "C7508" in log or "setmaxnreg ignored" in log:
        raise AssertionError("ptxas ignored a setmaxnreg (C7508):\n" + "\n".join(
            line for line in log.splitlines() if "C7508" in line or "setmaxnreg" in line))
    if not isinstance(kernels, dict):
        kernels = {k: re.escape(k) + r"ILi(?P<d>\d+)E" for k in kernels}
    report = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        found = next(((k, m) for k, pat in kernels.items()
                      if (m := re.search(pat, name))), None)
        if found is None:
            continue
        kernel, d = found[0], int(found[1].group("d"))
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        if regs is None or spills is None:
            raise AssertionError(f"no ptxas register report for {name}")
        report[(kernel, d)] = (int(regs.group(1)), int(spills.group(1)),
                               int(spills.group(2)))
    want = {(k, d) for k in kernels for d in (16, 64, 128)}
    if set(report) != want:
        raise AssertionError(f"ptxas reported {sorted(report)}, not {sorted(want)}")
    spilled = {key: r for key, r in report.items() if r[1] or r[2]}
    if spilled:
        raise AssertionError(f"spills (registers, store bytes, load bytes): {spilled}")
    return report


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def kernel_inputs(torch, dtype, s, dev, cursors=CURSORS, seed=0, mp=MP,
                  num_pages=NUM_PAGES, h=H, d=D):
    """q, pools, page table and cursors at the serving shapes (or `mp`
    pages a slot in a pool of `num_pages`, `h` heads of `d`): each slot
    owns distinct pages up to its last live one; entries past it are
    stale (random) and must never be read."""
    g = torch.Generator().manual_seed(seed)
    b = len(cursors)
    q = torch.randn((b, s, h, d), generator=g).to(dtype)
    pool_k = torch.randn((num_pages, PS, h, d), generator=g).to(dtype)
    pool_v = torch.randn((num_pages, PS, h, d), generator=g).to(dtype)
    perm = torch.randperm(num_pages, generator=g).tolist()
    table = torch.randint(0, num_pages, (b, mp), generator=g, dtype=torch.int32)
    for row, cur in enumerate(cursors):
        live = min((cur + s - 1) // PS, mp - 1) + 1
        table[row, :live] = torch.tensor(perm[:live], dtype=torch.int32)
        perm = perm[live:]
    cursors = torch.tensor(cursors, dtype=torch.int32)
    return [t.to(dev) for t in (q, pool_k, pool_v, table, cursors)]


def work_bounds(cursors, itemsize, s, quantized=False, h=H, d=D):
    """(bytes, ops) this call needs: each live K/V vector read once (D
    elements of `itemsize`, or D int8 values and a 2-byte scale), the
    live rows' q read once, every output row written once, the live
    pages' table entries and the cursors read; 4 ops per live (query
    row, key, element) — QK^T and PV — plus, in int8, one dequant
    multiply per live K/V element. A parked row (cursor past the window)
    needs only its output written."""
    view_len = MP * PS
    kv_keys, pairs, live_rows, pages = 0, 0, 0, 0
    for cur in cursors:
        if cur >= view_len:
            continue
        n = min(cur + s - 1, view_len - 1) + 1
        kv_keys += n
        pages += -(-n // PS)
        pairs += sum(min(cur + j, view_len - 1) + 1 for j in range(s))
        live_rows += 1
    vector_bytes = d + 2 if quantized else d * itemsize
    nbytes = 2 * kv_keys * h * vector_bytes
    nbytes += (live_rows + len(cursors)) * s * h * d * itemsize
    nbytes += 4 * (pages + len(cursors))
    ops = 4 * pairs * h * d + (2 * kv_keys * h * d if quantized else 0)
    return nbytes, ops


def bound_of(name, cursors, itemsize, s, quantized=False, h=H, d=D):
    """(bound_ms, bound_by, bytes, ops) of one call on the H100."""
    nbytes, ops = work_bounds(cursors, itemsize, s, quantized, h, d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def time_ms(torch, fn, flush, iters=30, warmup=3):
    """Median device time of fn() over CUDA events, L2 flushed before
    every launch (the serving loop meets each layer's pool cold). The
    flush (a 2 GiB memset; phase 3 prints its time) also keeps the
    device busy while the host enqueues fn's launches, so a multi-launch
    fn is timed without the host's gaps between them."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_attention(torch, q, pool_k, pool_v, table, cursors, k_scale=None,
                      v_scale=None):
    """gather (+ `dequant_kv` of an int8 pool) + torch's
    scaled_dot_product_attention: a yardstick timed beside the kernels,
    never called by the port."""
    from kubeflow_tpu_torch.ops.attention import dequant_kv, paged_kv_view

    s = q.shape[1]
    k, v = paged_kv_view(pool_k, table), paged_kv_view(pool_v, table)
    if k_scale is not None:
        k = dequant_kv(k, paged_kv_view(k_scale, table), q.dtype)
        v = dequant_kv(v, paged_kv_view(v_scale, table), q.dtype)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    q_pos = cursors.long()[:, None] + torch.arange(s, device=q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, None, :] <= q_pos[:, :, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:, None]
    ).transpose(1, 2)


def measure(torch, pa, flush, dtype, s, cursors, quantized=False, timed=True,
            mp=MP, num_pages=NUM_PAGES, h=H, d=D):
    """One kernel call at (s, cursors) against its plain version (every
    row, parked ones included: both write zeros there) and the library
    yardstick (live rows), then their times and the call's bound. With
    `quantized`, the pools are `quantize_kv` of the same seeded pools and
    the call reads them through the kernel's int8 variant. Not `timed`:
    the check alone (the record carries the error only), which may take
    another view (`mp` pages a slot, `num_pages` in the pool) or another
    head geometry (`h` heads of `d`)."""
    from kubeflow_tpu_torch.ops.attention import quantize_kv

    name = str(dtype).replace("torch.", "")
    kname = pa.kernel_name(s, quantized)
    args = kernel_inputs(torch, dtype, s, "cuda", cursors=cursors, mp=mp,
                         num_pages=num_pages, h=h, d=d)
    kw = {}
    if quantized:
        (args[1], ks), (args[2], vs) = quantize_kv(args[1]), quantize_kv(args[2])
        kw = {"k_scale": ks, "v_scale": vs}
    out = pa.paged_attention(*args, dtype=dtype, **kw)
    ref = pa.paged_attention_reference(*args, dtype=dtype, **kw)
    lib = library_attention(torch, *args, **kw)
    torch.cuda.synchronize()
    live = args[4] < mp * PS
    err = (out.float() - ref.float()).abs().max().item()
    lib_err = (lib[live].float() - ref[live].float()).abs().max().item()
    label = (f"kernel {kname} {name} B={len(cursors)} s={s} cursors {list(cursors)}"
             + ("" if mp == MP else f" view {mp * PS}")
             + ("" if (h, d) == (H, D) else f" H={h} D={d}"))
    print(f"{label}: max_abs_err {err:.3e} (atol {ATOL[name]:g}); library "
          f"max_abs_err {lib_err:.3e}", flush=True)
    if not err <= ATOL[name]:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{err} > {ATOL[name]}")
    if not timed:
        return {"name": kname, "dtype": name, "max_abs_err": err}
    ms = time_ms(torch, lambda: pa.paged_attention(*args, dtype=dtype, **kw),
                 flush)
    plain_ms = time_ms(
        torch, lambda: pa.paged_attention_reference(*args, dtype=dtype, **kw),
        flush,
    )
    library_ms = time_ms(torch, lambda: library_attention(torch, *args, **kw),
                         flush)
    bound_ms, bound_by, nbytes, ops = bound_of(
        name, cursors, args[0].element_size(), s, quantized, h, d
    )
    print(f"{label}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}; {nbytes} B, "
          f"{ops} ops)", flush=True)
    return {
        "name": kname, "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/paged_attention.cu",
        # the kernel function, or its quantized branch's dequant
        "replaces": "kubeflow_tpu/ops/paged_attention.py:" + (
            ("106" if s == 1 else "184") if quantized
            else ("71" if s == 1 else "143")
        ),
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "dtype": name, "bytes": nbytes, "ops": ops,
        "shape": (f"B={len(cursors)} s={s} H={h} D={d} ps={PS} MP={mp} "
                  f"P={num_pages} cursors={list(cursors)}"),
    }


def phase_kernels(torch, quantized=False):
    """Each kernel (its int8 variant when `quantized`: phase 9) against
    its plain version: at the 8-slot decode shape and an 8-slot window
    (ragged cursors, a parked row) in both dtypes, at the batch-1
    windows the main path gives the window kernel, and at phase 11c's
    small-draft calls (SMALL_H heads of SMALL_D: the 8-slot draft step,
    the draft's chunk windows), checked, not timed."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    flush = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    print(f"L2 flush: {time_ms(torch, flush.zero_, flush, iters=5):.4f} ms",
          flush=True)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s in (1, CHUNK):
            rec = measure(torch, pa, flush, dtype, s, CURSORS, quantized)
            records[(rec["name"], rec["dtype"], "B8")] = rec
        measure(torch, pa, flush, dtype, 1, SPLIT_EDGES, quantized, timed=False)
        # the window kernel at the verify window and over a long view
        measure(torch, pa, flush, dtype, VERIFY, CURSORS, quantized, timed=False)
        for s in (VERIFY, CHUNK):
            measure(torch, pa, flush, dtype, s, LONG_CURSORS, quantized,
                    timed=False, mp=LONG_MP, num_pages=LONG_NUM_PAGES)
        # 11c's draft: its one-token steps (8 slots) and its chunk windows
        # (batch 1 at MAIN_WINDOWS' cursors) read a pool of D = 16 heads
        small = [measure(torch, pa, flush, dtype, 1, CURSORS, quantized,
                         timed=False, h=SMALL_H, d=SMALL_D)]
        small += [measure(torch, pa, flush, dtype, CHUNK, (c,), quantized,
                          timed=False, h=SMALL_H, d=SMALL_D)
                  for c in sorted(set(MAIN_WINDOWS))]
        for rec in small:
            key = (rec["name"], rec["dtype"], "small_draft")
            records[key] = {"max_abs_err": max(
                rec["max_abs_err"], records.get(key, {}).get("max_abs_err", 0.0))}
    # one long row: a slot at cursor 1023 walks 8 splits of 128 keys
    decode = pa.kernel_name(1, quantized)
    long_row = measure(torch, pa, flush, torch.bfloat16, 1, LONG_ROW, quantized)
    b8 = records[(decode, "bfloat16", "B8")]
    print(f"kernel {decode} bf16 one long row (B=1, cursor {LONG_ROW[0]}): ms "
          f"{long_row['ms']:.4f} bound_ms {long_row['bound_ms']:.5f} "
          f"({long_row['bound_ms'] / long_row['ms']:.1%} of bound); the B=8 "
          f"call {b8['ms']:.4f} ms ({b8['bound_ms'] / b8['ms']:.1%} of bound)",
          flush=True)
    # the main path's window calls (bf16, batch 1): each distinct cursor
    # measured once, then averaged over the calls phase 5 (10) makes; then
    # both kernels at a serving-mesh rank's shape (phase 24: H / 2 heads a
    # rank at tensor 2), the B=8 decode call and the same windows
    window = pa.kernel_name(CHUNK, quantized)
    records[(window, "bfloat16", "main")] = main_windows_record(
        torch, pa, flush, window, quantized, H)
    records[(decode, "bfloat16", "B8_rank")] = measure(
        torch, pa, flush, torch.bfloat16, 1, CURSORS, quantized, h=MESH_H)
    records[(window, "bfloat16", "main_rank")] = main_windows_record(
        torch, pa, flush, window, quantized, MESH_H)
    del flush
    return records


def main_windows_record(torch, pa, flush, window, quantized, h):
    """The window kernel at the main path's batch-1 bf16 windows with `h`
    heads: each distinct cursor measured once, averaged over the calls
    phase 5 (10) makes."""
    per_cursor = {
        c: measure(torch, pa, flush, torch.bfloat16, CHUNK, (c,), quantized,
                   h=h)
        for c in sorted(set(MAIN_WINDOWS))
    }
    calls = [per_cursor[c] for c in MAIN_WINDOWS]
    main = dict(calls[0])
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        main[key] = statistics.fmean(r[key] for r in calls)
    main["max_abs_err"] = max(r["max_abs_err"] for r in calls)
    main["bytes"] = sum(r["bytes"] for r in calls)
    main["ops"] = sum(r["ops"] for r in calls)
    main["bound_by"] = (
        "bytes" if main["bytes"] / HBM_BYTES_PER_S
        >= main["ops"] / PEAK_OPS["bfloat16"] else "operations"
    )
    main["shape"] = (f"B=1 s={CHUNK} H={h} D={D} ps={PS} MP={MP} "
                     f"P={NUM_PAGES}; mean over the main path's windows at "
                     f"cursors {list(MAIN_WINDOWS)}")
    print(f"kernel {window} bf16 main-path windows at H={h} (mean of "
          f"{len(calls)} calls): ms {main['ms']:.4f} plain_ms "
          f"{main['plain_ms']:.4f} library_ms {main['library_ms']:.4f} "
          f"bound_ms {main['bound_ms']:.5f} ({main['bound_by']})", flush=True)
    return main


def post(port, name, body, timeout=600):
    return post_h(port, name, body, {}, timeout)[:2]


def post_h(port, name, body, headers, timeout=600):
    """POST :generate with `headers` → (status, body, response headers)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **headers},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def step_ms_between(before, after):
    """decode_step_ms of the steps between two `stats()` readings."""
    steps = after["decode_steps"] - before["decode_steps"]
    return (after["decode_step_ms"] * after["decode_steps"]
            - before["decode_step_ms"] * before["decode_steps"]) / max(steps, 1)


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return resp.status, resp.read()


def static_num_pages(model, dtype, num_slots=8, page_size=16,
                     quantize=None):
    """The static rule's pool for a server of `model`. build_server sizes
    an auto pool from an earlier engine's pressure in this process (as
    the reference does), so every server here names its pool: phase 5's
    384 pages, phase 10's 744 int8 pages."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.engine import resolve_num_pages

    quantize = quantize or os.environ.get("KFT_SERVING_QUANTIZE", "") or "none"
    cfg = get_model(model, dtype=dtype, device="meta").cfg
    return resolve_num_pages(None, num_slots, cfg, page_size, quantize)


def serve(model, dtype, device, paged_attention="kernel", **knobs):
    from kubeflow_tpu_torch.api.wsgi import Server
    from kubeflow_tpu_torch.serving.main import build_server

    if not knobs.get("num_pages"):
        knobs["num_pages"] = static_num_pages(
            model, dtype, knobs.get("num_slots", 8),
            knobs.get("page_size", 16), knobs.get("quantize"))
    ms = build_server(model, device=device, dtype=dtype,
                      paged_attention=paged_attention, **knobs)
    httpd = Server(ms.app, port=0)
    httpd.start()
    return ms, httpd


def phase_serve_f32(torch, model="gpt_small", device="cuda", prompts=None,
                    max_new=16, **knobs):
    """Phase 4 (12b's f32 serve with `checkpoint_dir` in `knobs`): the
    engine's greedy tokens equal generate()'s. Returns the served model;
    `pa.launch_counts` then hold the requests' launches."""
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serving.generate import generate

    ms, httpd = serve(model, torch.float32, device, num_slots=8, page_size=16,
                      **knobs)
    try:
        rng = np.random.default_rng(1)
        lm = ms.lm(model)
        vocab = lm.model.cfg.vocab_size
        pa.reset_launch_counts()
        for n in prompts or (12, 37):
            prompt = rng.integers(0, vocab, n).tolist()
            status, out = post(httpd.port, model,
                               {"prompt_ids": [prompt], "max_new_tokens": max_new})
            if status != 200:
                raise AssertionError(f"f32 :generate answered {status}: {out}")
            want = generate(lm.model, [prompt], max_new)[0].tolist()
            got = out["sequences"][0]
            if got != want:
                raise AssertionError(
                    f"f32 engine tokens differ from generate(): "
                    f"{got[n:]} vs {want[n:]}"
                )
            print(f"serve f32: prompt {n} -> {max_new} tokens equal generate()",
                  flush=True)
        launches = dict(pa.launch_counts)
        kernel = ms.engine(model).stats()["attention_kernel"]
        print(f"serve f32: read path {kernel}, launches {launches}", flush=True)
        if kernel != "kernel" or (device == "cuda" and launches["paged_decode"] < 1):
            raise AssertionError(
                f"the f32 serve did not read through the decode kernel: "
                f"read path {kernel}, launches {launches}"
            )
        return lm.model
    finally:
        httpd.stop()
        ms.close()


def rescore(torch, f32_model, prompt, tokens):
    """Largest gap, over the emitted tokens, between a position's max f32
    logit and the emitted token's (teacher-forced, non-paged forward)."""
    return rescore_gaps(torch, f32_model, prompt, tokens).max().item()


def rescore_gaps(torch, f32_model, prompt, tokens):
    """Each emitted token's gap below its position's max f32 logit
    (teacher-forced, non-paged forward)."""
    seq = torch.tensor([prompt + tokens], device=f32_model.device)
    with torch.inference_mode():
        logits = f32_model(seq)[0]
    p = len(prompt)
    return logit_gaps(torch, logits[p - 1 : p - 1 + len(tokens)], tokens)


def logit_gaps(torch, rows, tokens):
    """rows [n, V] f32 logits: each row's max minus token i's logit."""
    picked = rows[torch.arange(len(tokens)),
                  torch.tensor(tokens, device=rows.device)]
    return rows.max(dim=-1).values - picked


def phase_serve_bf16(torch, f32_model, model="gpt_small", device="cuda",
                     short=(5, 17, 33, 64, 120), long_len=LONG_LEN,
                     hit_len=HIT_LEN, max_new=32, buckets=BUCKETS,
                     quantize="none"):
    """Phase 5 (phase 10's bf16 half with quantize="int8"): `f32_model`
    rescores every emitted token."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = buckets
    ms, httpd = serve(model, torch.bfloat16, device, num_slots=8, page_size=16,
                      quantize=quantize)
    tag = "bf16" if quantize == "none" else f"{quantize} bf16"
    try:
        prompts, warm = serve_traffic(f32_model.cfg.vocab_size,
                                      (*short, long_len, hit_len),
                                      int(buckets.split(",")[-1]))
        results = [None] * len(prompts)

        def run(i):
            results[i] = post(httpd.port, model,
                              {"prompt_ids": [prompts[i]], "max_new_tokens": max_new})

        # warm-up (not timed, not counted): the first bf16 call of each
        # shape pays CUDA's lazy module loading and library heuristics;
        # a prompt past the largest bucket runs both kernels once
        status, _ = post(httpd.port, model, {"prompt_ids": [warm],
                                             "max_new_tokens": 2})
        if status != 200:
            raise AssertionError(f"{tag} warm-up answered {status}")
        before = ms.engine(model).stats()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # the main path's run: every launch count starts at 0 here
        pa.reset_launch_counts()
        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        # the 300-token prompt again: its pages are committed now, so it
        # maps them and copies the partially matched boundary page
        prompts.append(prompts[-1])
        results.append(post(httpd.port, model,
                            {"prompt_ids": [prompts[-1]], "max_new_tokens": max_new}))
        launches = dict(pa.launch_counts)
        stats = ms.engine(model).stats()
        # decode steps of this run only (the warm-up's are subtracted)
        steps = stats["decode_steps"] - before["decode_steps"]
        step_ms = step_ms_between(before, stats)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        worst = 0.0
        for prompt, res in zip(prompts, results):
            if res is None or res[0] != 200:
                raise AssertionError(f"{tag} :generate failed: {res}")
            tokens = res[1]["sequences"][0][len(prompt):]
            if len(tokens) != max_new:
                raise AssertionError(f"expected {max_new} tokens, got {len(tokens)}")
            worst = max(worst, rescore(torch, f32_model, prompt, tokens))
        status, body = get(httpd.port, "/healthz")
        if status != 200:
            raise AssertionError(f"/healthz answered {status}")
        status, body = get(httpd.port, "/metrics")
        if status != 200 or b"serving_decode_steps_total" not in body:
            raise AssertionError("/metrics lacks the engine's series")
        gen_tokens = max_new * (len(prompts) - 1)
        print(f"serve {tag}: {len(results)} requests answered 200; "
              f"{gen_tokens} tokens in {wall:.3f} s of concurrent load = "
              f"{gen_tokens / wall:.1f} tokens/s; decode_step_ms "
              f"{step_ms:.3f} over {steps} steps; "
              f"max_memory_allocated {peak} B", flush=True)
        print(f"serve {tag}: stats {json.dumps(stats)}", flush=True)
        print(f"serve {tag}: launches {launches}; worst f32 logit gap of an "
              f"emitted token {worst:.4f} (delta {DELTA})", flush=True)
        if stats["cow_copies"] < 1 or stats["prefix_hit_tokens"] < 1:
            raise AssertionError("the repeated prompt did not hit the prefix cache")
        if stats["attention_kernel"] != "kernel":
            raise AssertionError(f"read path {stats['attention_kernel']}")
        if not worst <= DELTA:
            raise AssertionError(f"an emitted token is {worst} below its "
                                 f"position's max f32 logit (> {DELTA})")
        # the K = 0 numbers phase 11 prints beside its own, and the
        # traffic with its tokens (phase 14 serves it again)
        stats = dict(stats, load_tokens_per_s=gen_tokens / wall,
                     load_decode_step_ms=step_ms, peak_bytes=peak, traffic={
                         "prompts": prompts,
                         "tokens": [res[1]["sequences"][0][len(prompt):]
                                    for prompt, res in zip(prompts, results)],
                     })
        return launches, stats, steps
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)
        httpd.stop()
        ms.close()


def int8_f32_tokens(torch, model, device, prompts, max_new, **knobs):
    """Phase 10's f32 check (12b's with `checkpoint_dir` in `knobs`): the
    same greedy requests through the int8 kernels and through gather +
    dequant_kv give the same tokens. Returns (the full-width f32 model
    the ServedLm keeps, the kernel run's launches)."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    tokens, kernel_launches = {}, {}
    for impl in ("kernel", "gather"):
        ms, httpd = serve(model, torch.float32, device, paged_attention=impl,
                          num_slots=8, page_size=16, quantize="int8", **knobs)
        try:
            rng = np.random.default_rng(1)
            f32_full = ms.lm(model).model  # the ServedLm stays full width
            eng = ms.engine(model)
            pa.reset_launch_counts()
            tokens[impl] = []
            for n in prompts:
                prompt = rng.integers(0, f32_full.cfg.vocab_size, n).tolist()
                status, out = post(httpd.port, model, {
                    "prompt_ids": [prompt], "max_new_tokens": max_new})
                if status != 200:
                    raise AssertionError(f"int8 f32 :generate answered {status}: {out}")
                tokens[impl].append(out["sequences"][0][n:])
            launches = dict(pa.launch_counts)
            stats = eng.stats()
            weights = (eng.model.weight_bytes(), f32_full.weight_bytes())
        finally:
            httpd.stop()
            ms.close()
        print(f"serve int8 f32 {impl}: tokens {tokens[impl]}; launches "
              f"{launches}; resident weights {weights[0]} B int8 against "
              f"{weights[1]} B f32", flush=True)
        if (stats["kv_pool_dtype"], stats["quantize"]) != ("int8", "int8"):
            raise AssertionError(f"the int8 engine's pool is not int8: {stats}")
        if (device == "cuda" and impl == "kernel"
                and (launches["paged_decode_int8"] < 1
                     or launches["paged_decode"] + launches["paged_window"])):
            raise AssertionError(f"the int8 f32 serve did not read through the "
                                 f"int8 decode kernel alone: {launches}")
        if impl == "kernel":
            kernel_launches = launches
    if tokens["kernel"] != tokens["gather"]:
        raise AssertionError(f"int8 f32 kernel tokens {tokens['kernel']} differ "
                             f"from gather's {tokens['gather']}")
    print("serve int8 f32: kernel tokens equal gather + dequant_kv tokens",
          flush=True)
    return f32_full, kernel_launches


def phase_serve_int8(torch, bf16_stats, model="gpt_small", device="cuda",
                     f32_prompts=(12, 37), f32_max_new=16,
                     accuracy_shape=(4, 256), **traffic):
    """Phase 10: int8 serving (int8 weights, int8 KV pages). f32: the
    same greedy requests through the int8 kernels and through gather +
    dequant_kv must give the same tokens (phase 4's requests:
    `f32_prompts`, `f32_max_new`). bf16: phase 5's traffic
    (`traffic` overrides it, as for phase_serve_bf16), rescored by the f32
    model of the same int8 weights; the pool must hold the int8 capacity
    ratio times phase 5's pages (`bf16_stats`) in no more bytes; then the
    accuracy gate. Returns the bf16 run's (launches, stats, steps)."""
    from kubeflow_tpu_torch.checkpointing.quantize import (
        quantization_accuracy,
        quantize_params_int8,
    )
    from kubeflow_tpu_torch.models.gpt import int8_model
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.engine import (
        auto_num_pages,
        int8_page_capacity_ratio,
    )

    f32_full, _ = int8_f32_tokens(torch, model, device, f32_prompts,
                                  f32_max_new)

    # the f32 model of the int8 weights: dequantized (into f32) at each use
    f32_int8 = int8_model(f32_full)
    launches, stats, steps = phase_serve_bf16(
        torch, f32_int8, model=model, device=device, quantize="int8", **traffic
    )
    cfg = f32_full.cfg
    ratio = int8_page_capacity_ratio(cfg.hidden_size // cfg.num_heads, 2)
    want_pages = int(auto_num_pages(8, cfg.max_len, 16) * ratio)
    print(f"serve int8 bf16: {stats['pages_total']} pool pages in "
          f"{stats['kv_pool_bytes']} B (int8 capacity ratio {ratio:.4f} x "
          f"phase 5's {bf16_stats['pages_total']} pages in "
          f"{bf16_stats['kv_pool_bytes']} B)", flush=True)
    if stats["kv_pool_dtype"] != "int8" or stats["pages_total"] != want_pages:
        raise AssertionError(f"int8 pool: {stats['kv_pool_dtype']} with "
                             f"{stats['pages_total']} pages, not {want_pages}")
    if stats["kv_pool_bytes"] > bf16_stats["kv_pool_bytes"]:
        raise AssertionError("the int8 pool takes more bytes than phase 5's")
    if device == "cuda" and (launches["paged_decode"] or launches["paged_window"]
                             or launches["paged_decode_int8"] < 1):
        raise AssertionError(f"int8 serving launched a full-width kernel or "
                             f"no int8 decode kernel: {launches}")

    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, accuracy_shape)).to(device)
    del f32_int8
    for dtype, full in ((torch.bfloat16, get_model(model, device=device,
                                                   dtype=torch.bfloat16)),
                        (torch.float32, f32_full)):
        params = full.state_dict()
        acc = quantization_accuracy(full, params, quantize_params_int8(params), ids)
        print(f"int8 accuracy {str(dtype)[6:]} over {list(accuracy_shape)} "
              f"held-out tokens: {json.dumps(acc)} (limits {json.dumps(ACCURACY)})",
              flush=True)
        if not all(acc[k] <= ACCURACY[k] for k in ACCURACY):
            raise AssertionError(f"int8 accuracy {acc} above {ACCURACY}")
        del full, params
    return launches, stats, steps


def flash_case(torch, dtype, s, with_mask, dev="cuda", seed=0, b=FB, h=FH,
               d=FD, lengths=None):
    """q/k/v/dO [b, s, h, d]; with a mask, row 1 keeps its first 3/4, or
    with `lengths` row i keeps its first lengths[i] keys."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g).to(dtype).to(dev)
                   for _ in range(4))
    mask = None
    if with_mask:
        mask = torch.ones((b, s), dtype=torch.int32)
        if lengths is None:
            mask[1, (3 * s) // 4:] = 0
        else:
            for row, n in enumerate(lengths):
                mask[row, n:] = 0
        mask = mask.to(dev)
    return q, k, v, do, mask


def flash_err(torch, got, want, name, key):
    """(max_abs_err, worst, typical) of a flash kernel's output against
    its plain version's: `worst` is the largest, over rows (the last
    axis), of the row's max |got - want| over its limit (FLASH_ATOL in
    f32; in bf16 FLASH_REL x max(the row's max |want|, typical), at least
    FLASH_ATOL), so worst <= 1 passes; `typical` is the median |want|."""
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    typical = ref.median().item()
    floor = FLASH_ATOL[name][key]
    if name == "float32":
        limit = torch.full_like(ref[..., :1], floor)
    else:
        scale = ref.amax(-1, keepdim=True).clamp_min(typical)
        limit = (FLASH_REL * scale).clamp_min(floor)
    worst = (diff.amax(-1, keepdim=True) / limit).max().item()
    return diff.max().item(), worst, typical


def flash_bound(kname, mask, s, itemsize, dtype_name, causal=True, b=FB,
                h=FH, d=FD):
    """(bound_ms, bound_by, bytes, ops) of one call: ops = c·h·d per
    visible (query, key) pair, c = 4 (QKᵀ, PV), 6 (+dO·Vᵀ, dS·K) or 8
    (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q); bytes = each input read once and each
    output written once. A causal query sees the keys up to its own, a
    bidirectional one every key; a key mask hides the padded keys."""
    if mask is None:
        pairs = b * s * (s + 1) // 2 if causal else b * s * s
    else:
        # key j is seen by queries j..s-1 (causal) or by all s queries
        # when it is not padding
        m = mask.cpu().numpy() != 0
        seen_by = s - np.arange(s) if causal else np.full(s, s)
        pairs = int(sum(seen_by[m[row]].sum() for row in range(b)))
    elems = b * s * h * d
    mask_bytes = 0 if mask is None else 4 * b * s
    rows = 4 * b * h * s  # one f32 per (b, h, row): lse, delta
    c, n_in, n_out, f32_rows = {
        "flash_fwd": (4, 3, 1, 1),        # q k v → o, lse
        "flash_bwd_dq": (6, 4, 1, 2),     # q k v dO lse delta → dq
        "flash_bwd_dkv": (8, 4, 2, 2),    # q k v dO lse delta → dk dv
    }[kname]
    nbytes = (n_in + n_out) * elems * itemsize + f32_rows * rows + mask_bytes
    ops = c * pairs * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def library_flash(torch, q, k, v, causal=True, mask=None):
    """scaled_dot_product_attention on [B, H, S, D] (`is_causal`, or a
    boolean key mask broadcast over heads and queries): a yardstick timed
    beside the kernels, never called by the port."""
    attn_mask = None if mask is None else (mask != 0)[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=attn_mask, is_causal=causal,
    ).transpose(1, 2)


def measure_flash(torch, fa, flush, dtype, s, with_mask, causal=True, b=FB,
                  h=FH, d=FD, lengths=None):
    """The three flash kernels at (dtype, s, mask, causal, b, h, d)
    against their plain versions on the same inputs, then their times,
    bounds and the library yardstick (none for a causal call with a key
    mask: the library's causal call takes no mask)."""
    name = str(dtype).replace("torch.", "")
    tol = FLASH_ATOL[name]
    q, k, v, do, mask = flash_case(torch, dtype, s, with_mask, b=b, h=h, d=d,
                                   lengths=lengths)
    scale = fa.default_scale(d)
    o, lse = fa.flash_fwd(q, k, v, mask, causal, scale)
    ro, rlse = fa.flash_attention_reference(q, k, v, mask, causal, scale)
    delta = fa.flash_attention_delta(ro, do)
    dq = fa.flash_bwd_dq(q, k, v, mask, do, rlse, delta, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, mask, do, rlse, delta, causal, scale)
    rdq = fa.flash_bwd_dq_reference(q, k, v, mask, do, rlse, delta, causal,
                                    scale)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, mask, do, rlse, delta,
                                          causal, scale)
    torch.cuda.synchronize()
    form = "causal" if causal else "bidirectional"
    mask_text = ("ragged key mask" if lengths is not None else
                 "key mask" if with_mask else "no mask")
    label = f"{name} B={b} S={s} H={h} D={d} {form} {mask_text}"
    lse_err = (lse - rlse).abs().max().item()
    print(f"flash {label}: lse max_abs_err {lse_err:.3e} (atol {tol['lse']:g})",
          flush=True)
    if not lse_err <= tol["lse"]:
        raise AssertionError(f"flash_fwd lse {label}: {lse_err} > {tol['lse']}")
    errs = {}
    for kname, tname, got, want, key in (
            ("flash_fwd", "o", o, ro, "o"), ("flash_bwd_dq", "dq", dq, rdq, "grad"),
            ("flash_bwd_dkv", "dk", dk, rdk, "grad"),
            ("flash_bwd_dkv", "dv", dv, rdv, "grad")):
        e, worst, typical = flash_err(torch, got, want, name, key)
        limit = (f"atol {tol[key]:g}" if name == "float32" else
                 f"row limit {FLASH_REL:g} x max(row max |value|, median) or "
                 f"{tol[key]:g}; at the median row {FLASH_REL * typical:.3e}")
        print(f"flash {kname} {label}: {tname} max_abs_err {e:.3e}, median "
              f"|{tname}| {typical:.3e}, worst row err/limit {worst:.3f} "
              f"({limit})", flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"{kname} {label} disagrees with its plain "
                                 f"version: {tname} row error {worst:.3f} "
                                 f"x its limit")
        errs[kname] = max(errs.get(kname, 0.0), e)
    calls = {
        "flash_fwd": (
            lambda: fa.flash_fwd(q, k, v, mask, causal, scale),
            lambda: fa.flash_attention_reference(q, k, v, mask, causal,
                                                 scale)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, mask, do, rlse, delta, causal,
                                    scale),
            lambda: fa.flash_bwd_dq_reference(q, k, v, mask, do, rlse, delta,
                                              causal, scale)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, mask, do, rlse, delta, causal,
                                     scale),
            lambda: fa.flash_bwd_dkv_reference(q, k, v, mask, do, rlse, delta,
                                               causal, scale)),
    }
    library = {"flash_fwd": None, "flash_bwd_dq": None, "flash_bwd_dkv": None}
    if mask is None or not causal:
        library["flash_fwd"] = time_ms(
            torch, lambda: library_flash(torch, q, k, v, causal, mask), flush)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = library_flash(torch, qs, ks, vs, causal, mask)
        pair = time_ms(torch, lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), flush)
        library["flash_bwd_dq"] = library["flash_bwd_dkv"] = pair
        del out
    records = {}
    for kname, (kernel, plain) in calls.items():
        ms = time_ms(torch, kernel, flush)
        plain_ms = time_ms(torch, plain, flush, iters=10)
        bound_ms, bound_by, nbytes, ops = flash_bound(
            kname, mask, s, q.element_size(), name, causal, b, h, d)
        lib_ms = library[kname]
        print(f"flash {kname} {label}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms if lib_ms is None else round(lib_ms, 4)} "
              f"bound_ms {bound_ms:.5f} ({bound_by}; {nbytes} B, {ops} ops); "
              f"{bound_ms / ms:.1%} of bound", flush=True)
        records[kname] = {
            "name": kname, "route": "cuda",
            "source": "kubeflow_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": {
                "flash_fwd": "kubeflow_tpu/ops/flash_attention.py:169",
                "flash_bwd_dq": "kubeflow_tpu/ops/flash_attention.py:276",
                "flash_bwd_dkv": "kubeflow_tpu/ops/flash_attention.py:331",
            }[kname],
            "launches": 0, "max_abs_err": errs[kname], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "dtype": name, "bytes": nbytes, "ops": ops,
            "shape": (f"B={b} S={s} H={h} D={d} {form}, {mask_text}"
                      + ("; library_ms is SDPA's whole backward (dQ, dK, dV)"
                         if kname != "flash_fwd" and lib_ms is not None else "")),
        }
    return records


def phase_flash(torch):
    """Phase 6: each flash kernel against its plain version at the main
    path's microbatch shape (bf16, S=4096, no mask as the config runs, and
    with a key mask), in f32 at S=1024, and at BERT's call (bf16, B=32,
    S=512, bidirectional, without and with a ragged key mask) → (the
    main path's records, {"bert_call", "bert_call_unmasked": records})."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    flush = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    main = measure_flash(torch, fa, flush, torch.bfloat16, FS, False)
    measure_flash(torch, fa, flush, torch.bfloat16, FS, True)
    measure_flash(torch, fa, flush, torch.float32, 1024, False)
    measure_flash(torch, fa, flush, torch.float32, 1024, True)
    # BERT's call (phase 16): bidirectional, unmasked and with a ragged
    # key mask (phase 16a's batches pass their all-ones mask: the masked
    # form)
    bert = {
        "bert_call_unmasked": measure_flash(
            torch, fa, flush, torch.bfloat16, BS, False, causal=False, b=BB,
            h=BH, d=BD),
        "bert_call": measure_flash(
            torch, fa, flush, torch.bfloat16, BS, True, causal=False, b=BB,
            h=BH, d=BD, lengths=BERT_LENGTHS),
    }
    del flush
    torch.cuda.empty_cache()
    return main, bert


def phase_train_f32(torch, model="gpt_small", seq=1024, device="cuda",
                    leaves=TRAIN_LEAVES, tag="train f32"):
    """Phase 7 (18d with an MoE `model` and its `leaves`): the same 3 f32
    steps (`Trainer.fit`) through the flash kernels and dense, from one
    seeded init on the same batches: per-step losses and the updates of
    `leaves` must agree. Returns each run's last log window's aux."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training.trainer import Trainer

    losses, launches, updates, auxes = {}, {}, {}, {}
    for impl in ("flash", "dense"):
        cfg = TrainingConfig(
            model=model, seq_len=seq, global_batch_size=2, steps=3,
            learning_rate=3e-4, warmup_steps=1, weight_decay=0.1,
            dtype="float32", attention_impl=impl,
        )
        trainer = Trainer(cfg, device=device)
        state = trainer.init_state()
        init = {n: state.params[n].detach().clone() for n in leaves}
        fa.reset_launch_counts()
        last = trainer.fit(state=state, log_every=cfg.steps)
        launches[impl] = dict(fa.launch_counts)
        losses[impl] = [loss for _, loss in trainer.losses]
        auxes[impl] = dict(last.aux)
        updates[impl] = {n: state.params[n].detach() - init[n]
                         for n in leaves}
        print(f"{tag} {impl}: losses {losses[impl]} launches "
              f"{launches[impl]}", flush=True)
        del trainer, state, init
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["flash"], losses["dense"]))
    gaps = {n: ((updates["flash"][n] - updates["dense"][n]).norm()
                / updates["dense"][n].norm()).item() for n in leaves}
    print(f"{tag}: worst relative loss gap flash vs dense {worst:.3e} "
          f"(rel {TRAIN_LOSS_REL:g}); relative gap of each leaf's 3-step "
          f"update {json.dumps(gaps)} (rel {TRAIN_UPDATE_REL:g}); update "
          f"norms {json.dumps({n: u.norm().item() for n, u in updates['dense'].items()})}",
          flush=True)
    if len(losses["flash"]) != 3 or not worst <= TRAIN_LOSS_REL:
        raise AssertionError(f"f32 flash and dense losses disagree: {losses}")
    if not all(g <= TRAIN_UPDATE_REL for g in gaps.values()):
        raise AssertionError(f"f32 flash and dense updates disagree: {gaps}")
    if device == "cuda" and (min(launches["flash"].values()) < 1
                             or any(launches["dense"].values())):
        raise AssertionError(f"flash launches wrong: {launches}")
    return auxes


def phase_train_bf16(torch, overrides=None, device="cuda"):
    """Phase 8, the training main path: run_training at TRAIN_CFG."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.train_run import run_training

    cfg = TrainingConfig(**{**TRAIN_CFG, **(overrides or {})})
    layers = get_model(cfg.model, device="meta", max_len=1).cfg.num_layers
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the main path's run: every launch count starts at 0 here
    fa.reset_launch_counts()
    t0 = time.monotonic()
    # one log window after the first-step fence: steps 2..N are enqueued
    # back to back and the host syncs once, at the window's end (each
    # step's loss is read then)
    result = run_training(cfg, device=device, log_every=cfg.steps)
    wall = time.monotonic() - t0
    launches = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    losses = result["losses"]
    print(f"train bf16: per-step loss {losses}", flush=True)
    print(f"train bf16: {cfg.steps} steps in {wall:.3f} s; steady step "
          f"{result['step_time_s'] * 1e3:.3f} ms (wall time of steps 2-"
          f"{cfg.steps} over {cfg.steps - 1}, one host sync at their end); "
          f"{result['items_per_sec']:.1f} tokens/s; mfu {result.get('mfu')}; "
          f"compile_s {result.get('compile_s')}; max_memory_allocated {peak} B",
          flush=True)
    if [s for s, _ in losses] != list(range(1, cfg.steps + 1)):
        raise AssertionError(f"not every step's loss was read: {losses}")
    if not all(np.isfinite(loss) for _, loss in losses):
        raise AssertionError(f"a non-finite loss: {losses}")
    # per step: every layer's forward runs twice under remat (forward and
    # recompute), its backward once, in each microbatch
    a, r = cfg.accum_steps, 2 if cfg.remat else 1
    want = {"flash_fwd": cfg.steps * layers * a * r,
            "flash_bwd_dq": cfg.steps * layers * a,
            "flash_bwd_dkv": cfg.steps * layers * a}
    print(f"train bf16: launches {launches} (config's formula {want})", flush=True)
    if device == "cuda" and launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    return launches, result


def rolled_draft(torch, target):
    """A copy of `target` whose head weight is rolled one vocab row: each
    logit row shifts by one, so its argmax is never the target's."""
    from kubeflow_tpu_torch.models.gpt import Gpt

    draft = Gpt(target.cfg, device=target.device)
    draft.load_state_dict(target.state_dict())
    with torch.no_grad():
        draft.head.kernel.copy_(torch.roll(target.head.kernel, 1, dims=-1))
    return draft


def spec_summary(stats, before=None, num_slots=8):
    """accept_rate, verify_steps, rewind_pages_returned, ms per verify
    iteration, and tokens per iteration (over all slots, and per slot it
    served) of a drafted engine's run (its stats less `before`'s)."""
    before = before or {}
    keys = ("verify_steps", "draft_proposed", "draft_accepted", "tokens",
            "rewind_pages_returned")
    run = {k: stats[k] - before.get(k, 0) for k in keys}
    total_ms = (stats["decode_step_ms"] * stats["decode_steps"]
                - before.get("decode_step_ms", 0.0)
                * before.get("decode_steps", 0))
    steps = max(run["verify_steps"], 1)
    # slot-iterations: each verify iteration once per slot it served
    slot_steps = (stats["mean_occupancy"] * stats["decode_steps"]
                  - before.get("mean_occupancy", 0.0)
                  * before.get("decode_steps", 0)) * num_slots
    run["accept_rate"] = run["draft_accepted"] / max(run["draft_proposed"], 1)
    run["verify_iteration_ms"] = total_ms / steps
    run["tokens_per_iteration"] = run["tokens"] / steps
    run["tokens_per_slot_iteration"] = run["tokens"] / max(slot_steps, 1e-9)
    return run


def phase_spec_f32(torch, model="gpt_small", device="cuda", prompts=(12, 37),
                   max_new=16, k=SPEC_K):
    """11a: phase 4's greedy prompts through drafted f32 engines (the
    target's own weights as the draft, then the rolled-head draft) must
    equal `generate()`; at int8 a drafted engine must equal the K = 0
    int8 engine."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.generate import generate

    target = get_model(model, device=device, dtype=torch.float32)
    rng = np.random.default_rng(1)  # phase 4's prompts
    rows = [rng.integers(0, target.cfg.vocab_size, n) for n in prompts]
    want = [generate(target, r[None], max_new)[0, len(r):].tolist() for r in rows]

    def run(draft, kk, quantize="none"):
        eng = DecodeEngine("spec", target, device=device, num_slots=8,
                           page_size=16, paged_attention="kernel",
                           quantize=quantize, draft_model=draft,
                           num_draft_tokens=kk)
        try:
            futures = [eng.submit(r, max_new) for r in rows]
            return [f.wait(600)["tokens"] for f in futures], eng.stats()
        finally:
            eng.close()

    # the same weights accept every proposal (a draft pool out of lockstep
    # with the target's, or a wrong draft read, shows here and not in the
    # tokens); the rolled head proposes the target's argmax + 1, never it
    for label, draft, accept in (("same weights", target, ACCEPT_SAME),
                                 ("rolled head", rolled_draft(torch, target), 0.0)):
        pa.reset_launch_counts()
        got, stats = run(draft, k)
        launches = dict(pa.launch_counts)
        summary = spec_summary(stats)
        print(f"spec f32 ({label} draft, K={k}): {json.dumps(summary)}; "
              f"launches {launches}", flush=True)
        if got != want:
            raise AssertionError(f"f32 drafted tokens ({label}) differ from "
                                 f"generate(): {got} vs {want}")
        if not (summary["accept_rate"] >= accept if accept
                else summary["draft_accepted"] == 0):
            raise AssertionError(f"f32 {label} draft: accept_rate "
                                 f"{summary['accept_rate']} (want "
                                 f"{'>= ' if accept else ''}{accept})")
        if device == "cuda" and (launches["paged_decode"] < 1
                                 or launches["paged_window"] < 1):
            raise AssertionError(f"the f32 drafted serve missed a kernel: {launches}")
        del draft
    print(f"spec f32: both drafts' tokens equal generate() (prompts {list(prompts)}, "
          f"{max_new} new)", flush=True)
    k0, _ = run(None, 0, "int8")
    pa.reset_launch_counts()
    drafted, stats = run(target, k, "int8")
    launches = dict(pa.launch_counts)
    print(f"spec int8 f32 (K={k}): {json.dumps(spec_summary(stats))}; launches "
          f"{launches}", flush=True)
    if drafted != k0:
        raise AssertionError(f"int8 drafted tokens {drafted} differ from the K = 0 "
                             f"int8 engine's {k0}")
    if device == "cuda" and (launches["paged_decode_int8"] < 1
                             or launches["paged_window_int8"] < 1
                             or launches["paged_decode"] + launches["paged_window"]):
        raise AssertionError(f"the int8 drafted serve did not read through the "
                             f"int8 kernels alone: {launches}")
    print("spec int8 f32: drafted tokens equal the K = 0 int8 engine's", flush=True)
    return target


def check_spec_launches(tag, launches, run, device, windows, target_layers,
                        draft_layers, k=SPEC_K):
    """The drafted engine's launch formula: every one-token read is a draft
    step (K+1 an iteration, one per draft layer), every window read a
    verify (one per target layer) or a chunk window of either model."""
    want = {"paged_decode": run["verify_steps"] * (k + 1) * draft_layers,
            "paged_window": (run["verify_steps"] * target_layers
                             + len(windows) * (target_layers + draft_layers))}
    print(f"{tag}: launches {launches} (formula {want})", flush=True)
    if device == "cuda" and {n: launches[n] for n in want} != want:
        raise AssertionError(f"{tag}: launches {launches} != formula {want}")


def spec_traffic(f32_model, short, long_len, hit_len):
    """Phase 5's prompts (its seed, its lengths), then the hit prompt again."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, f32_model.cfg.vocab_size, n).tolist()
               for n in (*short, long_len, hit_len)]
    return prompts, rng


def phase_spec_serve(torch, f32_model, k0_stats, model="gpt_small", device="cuda",
                     short=(5, 17, 33, 64, 120), long_len=LONG_LEN,
                     hit_len=HIT_LEN, max_new=32, buckets=BUCKETS, k=SPEC_K,
                     **knobs):
    """11b: the drafted bf16 server (the draft is the registry model's
    seed-0 init, the target's) on phase 5's traffic over REST; phase 5's
    K = 0 tokens/s and step time (`k0_stats`) are printed beside. 12b's
    with `checkpoint_dir` and `draft_checkpoint_dir` in `knobs`. Returns
    the run's (launches, spec_summary)."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = buckets
    ms, httpd = serve(model, torch.bfloat16, device, num_slots=8, page_size=16,
                      draft_model=model, num_draft_tokens=k, **knobs)
    tag = "spec bf16" + (" (checkpoint)" if knobs else "")
    largest = int(buckets.split(",")[-1])
    try:
        eng = ms.engine(model)
        prompts, rng = spec_traffic(f32_model, short, long_len, hit_len)
        results = [None] * len(prompts)

        def run(i):
            results[i] = post(httpd.port, model,
                              {"prompt_ids": [prompts[i]], "max_new_tokens": max_new})

        warm = rng.integers(0, f32_model.cfg.vocab_size, largest + 4).tolist()
        status, _ = post(httpd.port, model, {"prompt_ids": [warm],
                                             "max_new_tokens": 2})
        if status != 200:
            raise AssertionError(f"spec bf16 warm-up answered {status}")
        before = eng.stats()
        # the main path's run with speculation: every count starts at 0 here
        pa.reset_launch_counts()
        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        prompts.append(prompts[-1])
        results.append(post(httpd.port, model,
                            {"prompt_ids": [prompts[-1]], "max_new_tokens": max_new}))
        launches = dict(pa.launch_counts)
        stats = eng.stats()
        run_stats = spec_summary(stats, before)
        worst = 0.0
        for prompt, res in zip(prompts, results):
            if res is None or res[0] != 200:
                raise AssertionError(f"spec bf16 :generate failed: {res}")
            tokens = res[1]["sequences"][0][len(prompt):]
            if len(tokens) != max_new:
                raise AssertionError(f"expected {max_new} tokens, got {len(tokens)}")
            worst = max(worst, rescore(torch, f32_model, prompt, tokens))
        gen_tokens = max_new * (len(prompts) - 1)
        print(f"{tag} (REST, same-weights draft, K={k}): {len(results)} "
              f"requests answered 200; {gen_tokens} tokens in {wall:.3f} s of "
              f"concurrent load = {gen_tokens / wall:.1f} tokens/s; "
              f"{json.dumps(run_stats)}; K = 0 (phase 5, this call): "
              f"{k0_stats['load_tokens_per_s']:.1f} tokens/s, decode_step_ms "
              f"{k0_stats['load_decode_step_ms']:.3f}", flush=True)
        print(f"{tag}: stats {json.dumps(stats)}", flush=True)
        print(f"{tag}: worst f32 logit gap of an emitted token {worst:.4f} "
              f"(delta {DELTA})", flush=True)
        layers = f32_model.cfg.num_layers
        check_spec_launches(tag, launches, run_stats, device,
                            main_windows(long_len, hit_len, largest), layers, layers)
        if not worst <= DELTA:
            raise AssertionError(f"an emitted token is {worst} below its "
                                 f"position's max f32 logit (> {DELTA})")
        if stats["cow_copies"] < 1 or stats["decode_steps"] != stats["verify_steps"]:
            raise AssertionError(f"spec bf16: no prefix hit, or a one-token step "
                                 f"ran: {stats}")
        if stats["pages_in_use"] != stats["prefix_index_pages"]:
            raise AssertionError(f"spec bf16 leaked pages: {stats['pages_in_use']} "
                                 f"in use, {stats['prefix_index_pages']} in the "
                                 f"prefix index")
        sampled = {"prompt_ids": [prompts[2]], "max_new_tokens": max_new,
                   "temperature": 0.8, "top_k": 50, "seed": 1234}
        twice = [post(httpd.port, model, sampled) for _ in range(2)]
        if any(st != 200 for st, _ in twice) or twice[0][1] != twice[1][1]:
            raise AssertionError(f"a sampled request sent twice with one seed "
                                 f"differs: {twice}")
        print(f"{tag}: a sampled request (temperature 0.8, top_k 50) sent "
              f"twice with one seed returned the same {max_new} tokens", flush=True)
        return launches, run_stats
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)
        httpd.stop()
        ms.close()


def phase_spec_small_draft(torch, f32_model, model="gpt_small", device="cuda",
                           short=(5, 17, 33, 64, 120), long_len=LONG_LEN,
                           hit_len=HIT_LEN, max_new=32, buckets=BUCKETS,
                           k=SPEC_K):
    """11c: a bf16 engine whose draft has SMALL_DRAFT's widths on phase
    5's traffic (the hit prompt once more after the rest)."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    target = get_model(model, device=device, dtype=torch.bfloat16)
    draft = get_model(model, device=device, dtype=torch.bfloat16, **SMALL_DRAFT)
    eng = DecodeEngine("spec-small", target, device=device, num_slots=8,
                       page_size=16, paged_attention="kernel",
                       prefill_buckets=[int(b) for b in buckets.split(",")],
                       draft_model=draft, num_draft_tokens=k)
    try:
        prompts, rng = spec_traffic(f32_model, short, long_len, hit_len)
        largest = eng.prefill_buckets[-1]
        warm = rng.integers(0, f32_model.cfg.vocab_size, largest + 4)
        eng.generate_row(warm, 2, timeout=600)
        before = eng.stats()
        pa.reset_launch_counts()
        t0 = time.monotonic()
        futures = [eng.submit(p, max_new) for p in prompts]
        results = [f.wait(900)["tokens"] for f in futures]
        wall = time.monotonic() - t0
        prompts.append(prompts[-1])
        results.append(eng.generate_row(prompts[-1], max_new, timeout=600)["tokens"])
        launches = dict(pa.launch_counts)
        stats = eng.stats()
    finally:
        eng.close()
    run_stats = spec_summary(stats, before)
    worst = max(rescore(torch, f32_model, p, r) for p, r in zip(prompts, results))
    gen_tokens = max_new * (len(prompts) - 1)
    print(f"spec bf16 small draft ({draft.cfg.hidden_size}/{draft.cfg.num_layers}/"
          f"{draft.cfg.num_heads}/{draft.cfg.mlp_dim}, head dim "
          f"{draft.cfg.head_dim}, K={k}): {gen_tokens} tokens in {wall:.3f} s "
          f"= {gen_tokens / wall:.1f} tokens/s; {json.dumps(run_stats)}; worst f32 "
          f"logit gap {worst:.4f} (delta {DELTA})", flush=True)
    check_spec_launches("spec bf16 small draft", launches, run_stats, device,
                        main_windows(long_len, hit_len, largest),
                        target.cfg.num_layers, draft.cfg.num_layers)
    if any(len(r) != max_new for r in results) or not worst <= DELTA:
        raise AssertionError(f"small-draft serve: lengths "
                             f"{[len(r) for r in results]}, worst gap {worst}")
    if stats["rewind_pages_returned"] < 1:
        raise AssertionError("no rewind gave a page back")
    if stats["pages_in_use"] != stats["prefix_index_pages"]:
        raise AssertionError(f"small-draft serve leaked pages: {stats}")
    return launches


class StopAfter:
    """A stop event read set from its (n+1)-th check on: `Trainer.fit`
    checks once a step, so it is set during step n+1, deterministically.
    `set()` (the SIGTERM handler's call) sets it at once."""

    def __init__(self, n):
        self.calls, self.n = 0, n

    def is_set(self):
        self.calls += 1
        return self.calls > self.n

    def set(self):
        self.n = self.calls


def same_step_files(a, b, step):
    """Whether step `step` of checkpoint dirs `a` and `b` holds the same
    shard files, byte for byte (the manifests differ in their timestamps
    only); returns the number of files."""
    import filecmp

    from kubeflow_tpu_torch.checkpointing import layout

    da, db = layout.step_dir(a, step), layout.step_dir(b, step)
    files = sorted(f for f in os.listdir(da) if f.endswith(".bin"))
    if files != sorted(f for f in os.listdir(db) if f.endswith(".bin")):
        raise AssertionError(f"step {step}: the shard files differ in name")
    _, mismatch, errors = filecmp.cmpfiles(da, db, files, shallow=False)
    if mismatch or errors:
        raise AssertionError(f"step {step}: shard files differ: "
                             f"{(mismatch + errors)[:6]}")
    ma, mb = (layout.read_manifest(d)["leaves"] for d in (da, db))
    if ma != mb:
        raise AssertionError(f"step {step}: the manifests list other leaves")
    return len(files)


def phase_ckpt_train(torch, root, overrides=None, device="cuda"):
    """12a: an uninterrupted `run_training` of CKPT_TRAIN_CFG's steps, and
    a second run in a fresh directory preempted during step CKPT_PREEMPT
    and resumed (`restore=True`) to the budget, both saving every
    CKPT_INTERVAL steps. The resumed run's losses and its saved params,
    moments and counts must equal the uninterrupted run's, bit for bit.
    Returns (flash launches, the uninterrupted run's trainer, the resumed
    run's checkpoint dir)."""
    from kubeflow_tpu_torch.checkpointing import layout
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer
    from kubeflow_tpu_torch.utils.metrics import (
        checkpoint_blocked_histogram,
        checkpoint_bytes_counter,
        checkpoint_save_histogram,
    )

    def cfg(name):
        return TrainingConfig(
            **{**CKPT_TRAIN_CFG, **(overrides or {})},
            checkpoint=dict(directory=os.path.join(root, name),
                            interval_steps=CKPT_INTERVAL),
        )

    whole_cfg = cfg("whole")
    steps = whole_cfg.steps
    cut_dir = cfg("cut").checkpoint.directory
    layers = get_model(whole_cfg.model, device="meta", max_len=1).cfg.num_layers
    blocked, saved = checkpoint_blocked_histogram(), checkpoint_save_histogram()
    written = checkpoint_bytes_counter()
    before = (blocked.count(), blocked.sum(), saved.count(), saved.sum(),
              written.value())
    # kept: its state after the run is the uninterrupted run's step 4
    trainer = Trainer(whole_cfg, device=device)
    # the main path's run: every launch count starts at 0 here
    fa.reset_launch_counts()
    by_run = []

    def run(*args, **kw):
        # each run's saves: (count, blocked seconds, save seconds)
        b = (blocked.count(), blocked.sum(), saved.sum())
        result = run_training(*args, device=device, log_every=steps, **kw)
        by_run.append((blocked.count() - b[0], blocked.sum() - b[1],
                       saved.sum() - b[2]))
        return result

    t0 = time.monotonic()
    whole = run(whole_cfg, trainer=trainer)
    cut = run(cfg("cut"), stop_event=StopAfter(CKPT_PREEMPT - 1))
    committed_at_cut = layout.committed_steps(cut_dir)
    resumed = run(cfg("cut"), restore=True)
    wall = time.monotonic() - t0
    launches = dict(fa.launch_counts)
    n_saves = saved.count() - before[2]
    stats = {
        "saves": n_saves,
        "checkpoint_blocked_seconds_mean": (blocked.sum() - before[1])
        / max(blocked.count() - before[0], 1),
        "checkpoint_save_seconds_mean": (saved.sum() - before[3])
        / max(n_saves, 1),
        "checkpoint_bytes_total": written.value() - before[4],
        # (saves, blocked seconds, save seconds) of each run, in order
        "by_run": by_run,
    }
    # the resumed run's restore of the step-CKPT_PREEMPT directory
    stats["restore_seconds"] = resumed["restore_s"]
    print(f"ckpt train: uninterrupted losses {whole['losses']}; preempted run "
          f"{cut['losses']} (preempted {cut['preempted']}, final step "
          f"{cut['final_step']}, committed {committed_at_cut}); resumed "
          f"{resumed['losses']}; {wall:.3f} s for the three runs", flush=True)
    if not cut["preempted"] or cut["final_step"] != CKPT_PREEMPT:
        raise AssertionError(f"the second run did not stop at step "
                             f"{CKPT_PREEMPT}: {cut}")
    if committed_at_cut[-1:] != [CKPT_PREEMPT]:
        raise AssertionError(f"the preempted run committed {committed_at_cut}")
    if (resumed["final_step"] != steps
            or resumed["losses"] != whole["losses"][CKPT_PREEMPT:]
            or cut["losses"] != whole["losses"][:CKPT_PREEMPT]):
        raise AssertionError(f"the resumed run's losses differ from the "
                             f"uninterrupted run's: {resumed['losses']} vs "
                             f"{whole['losses']}")
    n_files = same_step_files(whole_cfg.checkpoint.directory, cut_dir, steps)
    print(f"ckpt train: step {steps} of both runs holds the same {n_files} "
          f"shard files (params, AdamW moments, counts), byte for byte",
          flush=True)
    state_bytes = stats["checkpoint_bytes_total"] / max(n_saves, 1)
    print(f"ckpt train: {json.dumps(stats)}; {state_bytes:.0f} B a step "
          f"directory | {smi_line() if device == 'cuda' else device}",
          flush=True)
    # three runs of steps: 4 + 2 + 2 updates, each layer's forward and
    # backward once a step
    updates = steps + CKPT_PREEMPT + (steps - CKPT_PREEMPT)
    want = {name: updates * layers for name in launches}
    print(f"ckpt train: launches {launches} (formula {want})", flush=True)
    if device == "cuda" and launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    return launches, trainer, cut_dir


def phase_ckpt_serve(torch, trainer, ckpt_dir, k0_stats, accept_11b,
                     model="gpt_small", device="cuda", f32_prompts=(12, 37),
                     f32_max_new=16, **traffic):
    """12b: serve 12a's checkpoint. f32: the served weights are the
    trainer's step-4 params, bit for bit, and phase 4's requests equal
    generate(); a K = SPEC_K engine whose draft comes from the same
    checkpoint equals generate() and accepts at least ACCEPT_SAME. bf16,
    K = SPEC_K, draft from the checkpoint: phase 5's traffic over REST (11b's
    gates). int8: the restored envelope is the port's quantize of the
    trainer's params, bit for bit, and phase 10's f32 token check holds.
    Returns every paged kernel's launches over these runs."""
    from kubeflow_tpu_torch.checkpointing.quantize import quantize_params_int8
    from kubeflow_tpu_torch.models.convert import quantized_params_from_jax
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serving.generate import generate
    from kubeflow_tpu_torch.serving.main import build_server
    from kubeflow_tpu_torch.serving.server import restore_checkpoint_params

    total = {name: 0 for name in pa.launch_counts}

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    clock = [time.monotonic()]

    def lap():
        now = time.monotonic()
        dt, clock[0] = now - clock[0], now
        return f"{dt:.3f} s"

    params = {n: p.detach() for n, p in trainer._final_state.params.items()}
    f32_model = phase_serve_f32(torch, model=model, device=device,
                                prompts=f32_prompts, max_new=f32_max_new,
                                checkpoint_dir=ckpt_dir)
    add(pa.launch_counts)
    served = f32_model.state_dict()
    differ = sorted(n for n in params if not torch.equal(served[n], params[n]))
    if served.keys() != params.keys() or differ:
        raise AssertionError(f"the served f32 weights are not the trainer's "
                             f"step-{trainer._final_state.step} params: {differ[:4]}")
    print(f"ckpt serve f32: the {len(params)} served tensors are the trainer's "
          f"step-{trainer._final_state.step} params, bit for bit ({lap()})",
          flush=True)

    ms = build_server(model, ckpt_dir, device=device, dtype=torch.float32,
                      num_slots=8, page_size=16, paged_attention="kernel",
                      num_pages=static_num_pages(model, torch.float32),
                      draft_model=model, num_draft_tokens=SPEC_K,
                      draft_checkpoint_dir=ckpt_dir)
    try:
        eng = ms.engine(model)
        rng = np.random.default_rng(1)  # phase 4's prompts
        rows = [rng.integers(0, f32_model.cfg.vocab_size, n) for n in f32_prompts]
        pa.reset_launch_counts()
        futures = [eng.submit(r, f32_max_new) for r in rows]
        got = [f.wait(600)["tokens"] for f in futures]
        add(pa.launch_counts)
        summary = spec_summary(eng.stats())
    finally:
        ms.close()
    want = [generate(f32_model, r[None], f32_max_new)[0, len(r):].tolist()
            for r in rows]
    print(f"ckpt spec f32 (draft from the checkpoint, K={SPEC_K}): "
          f"{json.dumps(summary)} ({lap()})", flush=True)
    if got != want:
        raise AssertionError(f"f32 drafted tokens differ from generate(): "
                             f"{got} vs {want}")
    if not summary["accept_rate"] >= ACCEPT_SAME:
        raise AssertionError(f"the same-checkpoint f32 draft accepts "
                             f"{summary['accept_rate']} < {ACCEPT_SAME}")

    launches, run = phase_spec_serve(torch, f32_model, k0_stats, model=model,
                                     device=device, checkpoint_dir=ckpt_dir,
                                     draft_checkpoint_dir=ckpt_dir, **traffic)
    add(launches)
    print(f"ckpt spec bf16: accept_rate {run['accept_rate']:.4f} with the "
          f"draft from the checkpoint; 11b's seed-0 draft in this call "
          f"{accept_11b:.4f} ({lap()})", flush=True)
    del f32_model

    envelope = quantized_params_from_jax(restore_checkpoint_params(ckpt_dir, "int8"))
    mine = quantize_params_int8(params)
    for part in ("qvalues", "qscales"):
        got_p, want_p = envelope[part], mine[part]
        differ = sorted(n for n in want_p
                        if not torch.equal(got_p[n], want_p[n].cpu()))
        if got_p.keys() != want_p.keys() or differ:
            raise AssertionError(f"the restored int8 {part} differ from the "
                                 f"trainer's params quantized: {differ[:4]}")
    print(f"ckpt int8: the restored envelope ({len(mine['qscales'])} quantized "
          f"leaves) is the trainer's params quantized, bit for bit ({lap()})",
          flush=True)
    _, launches = int8_f32_tokens(torch, model, device, f32_prompts,
                                  f32_max_new, checkpoint_dir=ckpt_dir,
                                  prefill_buckets=list(CKPT_INT8_BUCKETS))
    add(launches)
    print(f"ckpt serve: int8 f32 tokens ({lap()}); paged launches {total}",
          flush=True)
    return total


def post_json(port, path, body, binary=False, timeout=600):
    """POST a JSON body (or raw bytes with `binary`) to any route:
    (status, JSON reply, response headers)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=body if binary else json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/octet-stream" if binary
                 else "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def tokens_of(port, model, prompt, max_new, tag):
    """One greedy `:generate` over REST: (new tokens, TTFT ms)."""
    status, out, headers = post_json(
        port, f"/v1/models/{model}:generate",
        {"prompt_ids": [prompt], "max_new_tokens": max_new})
    if status != 200:
        raise AssertionError(f"{tag} :generate answered {status}: {out}")
    return out["sequences"][0][len(prompt):], float(headers["X-TTFT-Ms"])


def spill_traffic(vocab, shared_len, tail_len, fills, seed=13):
    """13a's requests: the shared prefix with a tail, `fills` distinct
    prompts of the prefix's length, the prefix with a new tail, and the
    first request again."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len).tolist()
    first = shared + rng.integers(0, vocab, tail_len).tolist()
    rows = [rng.integers(0, vocab, shared_len).tolist() for _ in range(fills)]
    again = shared + rng.integers(0, vocab, tail_len).tolist()
    return [first, *rows, again, first]


def page_ms(torch, eng, device, batch=32):
    """Wall ms a page of the host tier's device→host spill (into the
    slots of a host page arena, as the engine's tier) and of its
    host→device upload, one page a call (`*_1`) and `batch` pages in one
    call (`*_batch`: an eviction's victims, an admission's uploads), over
    the engine's first `batch` pool pages (written back with their own
    bits)."""
    from kubeflow_tpu_torch.serving.kv_tiers import HostPageArena

    n = min(batch, eng.num_pages)
    pages = list(range(n))
    arena = HostPageArena(eng._page_template(eng._pool), None, n,
                          pin=device == "cuda")
    trees = [arena.pages(slot)[0] for slot in arena.alloc(n)]

    def ms_a_page(fn):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    return {
        "spill_1": ms_a_page(lambda: [
            eng.programs.spill(eng._pool, [p], out=[tree])
            for p, tree in zip(pages, trees)]),
        "spill_batch": ms_a_page(lambda: eng.programs.spill(
            eng._pool, pages, out=trees)),
        "upload_1": ms_a_page(lambda: [
            eng.programs.upload(eng._pool, [tree], [p])
            for tree, p in zip(trees, pages)]),
        "upload_batch": ms_a_page(lambda: eng.programs.upload(
            eng._pool, trees, pages)),
    }


def phase_kv_spill(torch, model="gpt_small", device="cuda",
                   pool_pages=KV_POOL_PAGES, host_bytes=KV_HOST_BYTES,
                   shared_len=KV_SHARED, tail_len=KV_TAIL, fills=KV_FILLS,
                   max_new=KV_MAX_NEW):
    """13a: the spill traffic through a server whose pool of `pool_pages`
    must evict into a host tier of `host_bytes`, and through an
    always-resident server (auto pool, no tier), bf16 and int8 (int8 KV
    pages, f32 compute): every reply's tokens equal, the tier spilled and
    re-admitted pages, and at int8 the first request's tokens equal its
    re-admission's. Prints TTFT cold / HBM hit / host-tier hit, the spill
    and upload ms a page and the tier's bytes."""
    rows = None
    for dtype, quantize in ((torch.bfloat16, "none"), (torch.float32, "int8")):
        tag = f"kv spill {'bf16' if quantize == 'none' else 'int8 (f32)'}"
        got, ttft = {}, {}
        for kind in ("resident", "tiered"):
            knobs = ({"num_pages": pool_pages, "kv_host_bytes": host_bytes}
                     if kind == "tiered" else {})
            ms, httpd = serve(model, dtype, device, num_slots=8,
                              page_size=16, quantize=quantize, **knobs)
            try:
                eng = ms.engine(model)
                if rows is None:
                    rows = spill_traffic(eng.model.cfg.vocab_size,
                                         shared_len, tail_len, fills)
                replies = [tokens_of(httpd.port, model, r, max_new, tag)
                           for r in rows]
                got[kind] = [toks for toks, _ in replies]
                ttft[kind] = [t for _, t in replies]
                stats = eng.stats()
                if kind == "tiered":
                    copy_ms = page_ms(torch, eng, device)
            finally:
                httpd.stop()
                ms.close()
        tier = stats["kv_host_tier"]
        print(f"{tag}: TTFT ms cold {ttft['tiered'][0]:.3f}, HBM hit "
              f"{ttft['resident'][-2]:.3f}, host-tier hit "
              f"{ttft['tiered'][-2]:.3f}; ms a page "
              f"{json.dumps({k: round(v, 4) for k, v in copy_ms.items()})}; "
              f"kv_spill_pages "
              f"{stats['kv_spill_pages']}, kv_spill_hits "
              f"{stats['kv_spill_hits']}, host tier {json.dumps(tier)}; "
              f"pages_total {stats['pages_total']}", flush=True)
        if got["tiered"] != got["resident"]:
            raise AssertionError(f"{tag}: the tiered server's tokens differ "
                                 f"from the always-resident one's: "
                                 f"{got['tiered']} vs {got['resident']}")
        if stats["kv_spill_pages"] < 1 or stats["kv_spill_hits"] < 1:
            raise AssertionError(f"{tag}: the host tier never spilled or "
                                 f"re-admitted a page")
        if quantize == "int8" and got["tiered"][-1] != got["tiered"][0]:
            raise AssertionError(f"{tag}: the re-admitted first request's "
                                 f"tokens {got['tiered'][-1]} differ from "
                                 f"its first serve's {got['tiered'][0]}")


def phase_kv_restart(torch, root, model="gpt_small", device="cuda",
                     short=(5, 17, 33, 64, 120), long_len=LONG_LEN,
                     hit_len=HIT_LEN, max_new=32, buckets=BUCKETS):
    """13b: a bf16 server with a prefix store serves phase 5's prompts
    (the 300-token one twice: the second is a prefix hit), then drains,
    which writes the final persist; a new server on the same directory
    preloads it, and its first request, the 300-token prompt again, is a
    prefix hit whose tokens equal the first server's prefix hit's."""
    store = os.path.join(root, "kv-store")
    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = buckets
    knobs = dict(num_slots=8, page_size=16, kv_persist_dir=store,
                 kv_persist_chains=KV_PERSIST_CHAINS)
    try:
        ms, httpd = serve(model, torch.bfloat16, device, **knobs)
        try:
            eng = ms.engine(model)
            rng = np.random.default_rng(2)  # phase 5's prompts
            prompts = [rng.integers(0, eng.model.cfg.vocab_size, n).tolist()
                       for n in (*short, long_len, hit_len)]
            for prompt in prompts:
                tokens_of(httpd.port, model, prompt, max_new, "kv restart")
            want, _ = tokens_of(httpd.port, model, prompts[-1], max_new,
                                "kv restart")
        finally:
            httpd.stop()
            if not ms.close(drain=True):
                raise AssertionError("the first server's drain timed out")
        first = eng.stats()
        on_disk = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(store) for f in files)
        ms, httpd = serve(model, torch.bfloat16, device, **knobs)
        try:
            eng = ms.engine(model)
            preload = eng.stats()
            got, ttft = tokens_of(httpd.port, model, prompts[-1], max_new,
                                  "kv restart")
            stats = eng.stats()
        finally:
            httpd.stop()
            ms.close()
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)
    print(f"kv restart: persisted {first['kv_persisted_chains']} pages in "
          f"{first['kv_persist_seconds']:.4f} s, {on_disk} B on disk; "
          f"preloaded {preload['kv_persisted_chains']} pages in "
          f"{preload['kv_preload_seconds']:.4f} s; the first request after "
          f"the restart: {stats['prefix_hit_tokens']} prefix-hit tokens, "
          f"TTFT {ttft:.3f} ms", flush=True)
    if preload["kv_persisted_chains"] < 1 or stats["prefix_hit_tokens"] < 1:
        raise AssertionError("the restarted server preloaded nothing or its "
                             "first request missed the prefix cache")
    if got != want:
        raise AssertionError(f"kv restart: tokens after the restart {got} "
                             f"differ from the first server's {want}")


def handoff_ms(direction):
    """(ms, pages) of every page handoff in `direction` so far."""
    from kubeflow_tpu_torch.utils.metrics import (
        serving_kv_handoff_ms_counter,
        serving_kv_handoff_pages_counter,
    )

    return tuple(
        sum(v for k, v in m.values_snapshot().items() if k[1] == direction)
        for m in (serving_kv_handoff_ms_counter(),
                  serving_kv_handoff_pages_counter())
    )


def phase_kv_handoff(torch, model="gpt_small", device="cuda",
                     prompt_len=HANDOFF_LEN, max_new=KV_MAX_NEW):
    """13c (f32): prefill, decode and unified servers over localhost
    HTTP. `:prefill` with a handoff_url ships the prompt's pages and the
    decode server's `:generate` is a prefix hit with the unified server's
    tokens; then the unified server's `/v1/kv/handoff` to two decode
    peers lands each chain at its first page's rendezvous home, where the
    next request is a prefix hit with the same tokens."""
    from kubeflow_tpu_torch.routing.affinity import (
        first_page_key,
        rendezvous_rank,
    )

    servers = {name: serve(model, torch.float32, device, num_slots=8,
                           page_size=16)
               for name in ("unified", "prefill", "d1", "d2")}
    try:
        port = {name: httpd.port for name, (_, httpd) in servers.items()}
        eng = {name: ms.engine(model) for name, (ms, _) in servers.items()}
        vocab = eng["unified"].model.cfg.vocab_size
        rng = np.random.default_rng(17)
        row = rng.integers(0, vocab, prompt_len).tolist()
        in_before = handoff_ms("in")
        status, doc, _ = post_json(
            port["prefill"], f"/v1/models/{model}:prefill",
            {"prompt_ids": [row],
             "handoff_url": f"http://127.0.0.1:{port['d1']}/v1/kv/pages"})
        if status != 200 or doc["handoff"].get("admitted") != doc["pages"]:
            raise AssertionError(f":prefill answered {status}: {doc}")
        hits = eng["d1"].stats()["prefix_hit_tokens"]
        split, _ = tokens_of(port["d1"], model, row, max_new, "split")
        unified, _ = tokens_of(port["unified"], model, row, max_new,
                               "unified")
        if eng["d1"].stats()["prefix_hit_tokens"] <= hits:
            raise AssertionError("the decode server's :generate missed the "
                                 "handed-off pages")
        if split != unified:
            raise AssertionError(f"split-path tokens {split} differ from the "
                                 f"unified server's {unified}")
        print(f"kv handoff: :prefill shipped {doc['pages']} pages, the "
              f"decode server's tokens equal the unified server's", flush=True)

        peers = {"d1": f"http://127.0.0.1:{port['d1']}",
                 "d2": f"http://127.0.0.1:{port['d2']}"}
        homed = {}
        while len(homed) < 2:
            cand = rng.integers(0, vocab, prompt_len).tolist()
            home = rendezvous_rank(first_page_key(cand, 16), list(peers))[0]
            homed.setdefault(home, cand)
        want = {home: tokens_of(port["unified"], model, cand, max_new,
                                "unified")[0] for home, cand in homed.items()}
        out_before = handoff_ms("out")
        status, doc, _ = post_json(port["unified"], "/v1/kv/handoff",
                                   {"peers": peers})
        out_ms, out_pages = (a - b for a, b in zip(handoff_ms("out"),
                                                   out_before))
        if status != 200 or any(doc["peers"].get(h, {}).get("admitted", 0) < 1
                                for h in peers):
            raise AssertionError(f"/v1/kv/handoff answered {status}: {doc}")
        for home, cand in homed.items():
            other = next(h for h in peers if h != home)
            if (not eng[home].export_prefix_entries(cand)
                    or eng[other].export_prefix_entries(cand)):
                raise AssertionError(f"a chain homed at {home} did not land "
                                     f"there alone")
            hits = eng[home].stats()["prefix_hit_tokens"]
            got, _ = tokens_of(port[home], model, cand, max_new, "handoff")
            if eng[home].stats()["prefix_hit_tokens"] <= hits or got != want[home]:
                raise AssertionError(f"the request at {home} missed the "
                                     f"handed-off chain or its tokens differ")
        in_ms, in_pages = (a - b for a, b in zip(handoff_ms("in"), in_before))
        print(f"kv handoff: /v1/kv/handoff {json.dumps(doc['peers'])}; each "
              f"chain at its rendezvous home, a prefix hit there; handoff out "
              f"{out_ms / max(out_pages, 1):.4f} ms a page over {out_pages:g} "
              f"pages (export + POST), in {in_ms / max(in_pages, 1):.4f} ms a "
              f"page over {in_pages:g} pages (decode + upload + admit)",
              flush=True)
    finally:
        for ms, httpd in servers.values():
            httpd.stop()
            ms.close()


def phase_kv_tiers(torch, model="gpt_small", device="cuda", spill=None,
                   restart=None, handoff=None):
    """Phase 13: 13a, 13b and 13c (each takes its keyword overrides).
    Returns every paged kernel's launches over the three."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    pa.reset_launch_counts()
    t0 = time.monotonic()
    phase_kv_spill(torch, model=model, device=device, **(spill or {}))
    with tempfile.TemporaryDirectory(prefix="kft-kv-") as root:
        phase_kv_restart(torch, root, model=model, device=device,
                         **(restart or {}))
    phase_kv_handoff(torch, model=model, device=device, **(handoff or {}))
    launches = dict(pa.launch_counts)
    print(f"kv tiers: paged launches {launches} in "
          f"{time.monotonic() - t0:.3f} s", flush=True)
    return launches


# -- phase 14: observability and fault recovery ---------------------------------


def chaos_traffic(port, model, prompts, max_new, tag, rows, traceparent=None):
    """`rows` of `prompts` sent concurrently, each with X-Request-Id
    `<tag>-<i>` (row 0 also with `traceparent` when given) → ({row:
    (status, body, headers)}, wall seconds)."""
    replies = {}

    def run(i):
        headers = {"X-Request-Id": f"{tag}-{i}"}
        if i == 0 and traceparent:
            headers["traceparent"] = traceparent
        replies[i] = post_h(port, model, {"prompt_ids": [prompts[i]],
                                          "max_new_tokens": max_new}, headers)

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,)) for i in rows]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return replies, time.monotonic() - t0


def reply_tokens(prompt, reply):
    status, body, _ = reply
    return body["sequences"][0][len(prompt):] if status == 200 else None


def warm_up(port, model, vocab, largest, seed=14):
    """One request past the largest bucket (both kernels once, CUDA's lazy
    loading paid), as phase 5 warms up; its pages commit. → (prompt,
    tokens)."""
    warm = np.random.default_rng(seed).integers(0, vocab, largest + 4).tolist()
    reply = post_h(port, model, {"prompt_ids": [warm], "max_new_tokens": 2},
                   {"X-Request-Id": "warm-up"})
    if reply[0] != 200:
        raise AssertionError(f"warm-up answered {reply[0]}: {reply[1]}")
    return warm, reply_tokens(warm, reply)


def phase_chaos_serve(torch, k0, model="gpt_small", device="cuda", max_new=32,
                      buckets=BUCKETS, step_after=CHAOS_STEP_AFTER,
                      span_rel=SPAN_STEP_REL):
    """14a and 14b over phase 5's traffic (`k0["traffic"]`: its prompts and
    tokens); returns the paged launches of both. `span_rel` None prints
    the engine.step spans against decode_step_ms without gating them."""
    from kubeflow_tpu_torch.chaos import default_chaos, parse_point
    from kubeflow_tpu_torch.observability.trace import (
        default_tracer,
        format_traceparent,
    )
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.utils.metrics import (
        serving_engine_recoveries_counter,
    )

    prompts, want = k0["traffic"]["prompts"], k0["traffic"]["tokens"]
    # every prompt but the last (the repeat of the 300-token one) goes out
    # at once, then the repeat, as phase 5 sends them
    concurrent = range(len(prompts) - 1)
    largest = int(buckets.split(",")[-1])
    tracer = default_tracer()
    knobs = {"KFT_SERVING_PREFILL_BUCKETS": buckets,
             "KFT_TRACE_BUFFER_SPANS": "65536",
             "KFT_TRACE_SAMPLE_PROB": "1", "KFT_TRACE_SAMPLE_KEEP": "256"}
    os.environ.update(knobs)
    where = smi_line() if device == "cuda" else device
    pa.reset_launch_counts()
    t_phase = time.monotonic()
    try:
        # -- 14a: traced, then untraced, each on a fresh server ------------
        tokens_per_s = {}
        for traced in (True, False):
            os.environ["KFT_TRACE_ENABLED"] = "1" if traced else "0"
            ms, httpd = serve(model, torch.bfloat16, device, num_slots=8,
                              page_size=16)
            tag = "traced" if traced else "untraced"
            try:
                engine = ms.engine(model)
                vocab = engine.model.cfg.vocab_size
                warm_up(httpd.port, model, vocab, largest)
                tracer.clear()
                before = engine.stats()
                replies, wall = chaos_traffic(
                    httpd.port, model, prompts, max_new, tag, concurrent,
                    traceparent=format_traceparent(TRACE_ID, PARENT_SPAN))
                last = len(prompts) - 1
                replies[last] = post_h(
                    httpd.port, model, {"prompt_ids": [prompts[last]],
                                        "max_new_tokens": max_new},
                    {"X-Request-Id": f"{tag}-{last}"})
                after = engine.stats()
                step_ms = step_ms_between(before, after)
                tokens_per_s[traced] = max_new * len(concurrent) / wall
                for i, prompt in enumerate(prompts):
                    got = reply_tokens(prompt, replies[i])
                    if got != want[i]:
                        raise AssertionError(
                            f"14a {tag}: request {i} answered "
                            f"{replies[i][0]} with tokens other than phase "
                            f"5's: {got} vs {want[i]}")
                if traced:
                    check_traced_run(httpd.port, tracer, replies, tag,
                                     step_ms, span_rel)
                else:
                    if tracer.snapshot():
                        raise AssertionError("an untraced run recorded spans")
            finally:
                httpd.stop()
                ms.close()
        print(f"chaos 14a: phase 5's traffic, tokens equal phase 5's bitwise "
              f"traced and untraced; decode tokens/s traced "
              f"{tokens_per_s[True]:.1f}, untraced {tokens_per_s[False]:.1f} "
              f"({tokens_per_s[True] / tokens_per_s[False]:.4f}x) | {where}",
              flush=True)

        # -- 14b: an engine.step fault with the traffic in flight -----------
        os.environ["KFT_TRACE_ENABLED"] = "1"
        ms, httpd = serve(model, torch.bfloat16, device, num_slots=8,
                          page_size=16)
        try:
            engine = ms.engine(model)
            vocab = engine.model.cfg.vocab_size
            warm, warm_tokens = warm_up(httpd.port, model, vocab, largest)
            recoveries = serving_engine_recoveries_counter()
            rec0 = recoveries.value(model=model)
            tracer.clear()
            default_chaos().arm([parse_point(
                f"engine.step:after={step_after},once")])
            replies, _ = chaos_traffic(httpd.port, model, prompts, max_new,
                                       "fault", concurrent)
            default_chaos().disarm()
            failed = []
            for i in concurrent:
                status, body, _ = replies[i]
                if status == 500 and "decode step failed" in body.get("log", ""):
                    failed.append(i)
                elif reply_tokens(prompts[i], replies[i]) != want[i]:
                    raise AssertionError(
                        f"14b: request {i} answered {status} {body} and not "
                        f"phase 5's tokens or a 500 naming the failed step")
            idle = engine.stats()
            records = tracer.snapshot()
            recover = [r for r in records if r.name == "engine.recover"]
            print(f"chaos 14b: the fault at decode iteration {step_after + 1} "
                  f"failed requests {failed} (of {len(concurrent)}); "
                  f"recoveries +{recoveries.value(model=model) - rec0}; "
                  f"engine.recover {[r.attrs for r in recover]}; idle: "
                  f"pages_in_use {idle['pages_in_use']}, prefix_index_pages "
                  f"{idle['prefix_index_pages']} of {idle['pages_total']}",
                  flush=True)
            if not failed:
                raise AssertionError("the engine.step fault failed no request")
            if recoveries.value(model=model) - rec0 != 1 or len(recover) != 1:
                raise AssertionError("not exactly one recovery for one fault")
            # every page in use is the prefix index's (requests that were
            # not resident at the fault finished and committed); with every
            # request failed, the pool is all free
            if idle["pages_in_use"] != idle["prefix_index_pages"] or (
                    len(failed) == len(concurrent) and idle["pages_in_use"]):
                raise AssertionError(f"pages leaked across the recovery: "
                                     f"{idle}")
            # the fault's cost: from the recovery to the next admission
            t_fault = recover[0].t_start
            nxt = min((r.t_start for r in records
                       if r.name == "request.prefill" and r.t_start > t_fault),
                      default=None)
            # the failed requests again: misses on the reset pool, with
            # phase 5's tokens
            hits0 = engine.stats()["prefix_hit_tokens"]
            again, _ = chaos_traffic(httpd.port, model, prompts, max_new,
                                     "retry", failed)
            for i in failed:
                if reply_tokens(prompts[i], again[i]) != want[i]:
                    raise AssertionError(
                        f"14b: resubmitted request {i} answered "
                        f"{again[i][0]} with tokens other than phase 5's")
            if nxt is None:
                nxt = min(r.t_start for r in tracer.snapshot()
                          if r.name == "request.prefill"
                          and r.t_start > t_fault)
            hits1 = engine.stats()["prefix_hit_tokens"]
            # the warm-up's pages were committed before the fault: the
            # reset radix index has forgotten them
            warm_again = post_h(httpd.port, model, {
                "prompt_ids": [warm], "max_new_tokens": 2},
                {"X-Request-Id": "warm-up-again"})
            hits2 = engine.stats()["prefix_hit_tokens"]
            print(f"chaos 14b: resubmitted {failed} → phase 5's tokens, "
                  f"prefix hit tokens +{hits1 - hits0} (the "
                  f"{len(prompts[-1])}-token prompt "
                  f"{'among them' if len(prompts) - 2 in failed else 'not failed'}"
                  f"); the warm-up prompt committed before the fault: hit "
                  f"tokens +{hits2 - hits1}; fault → next admission "
                  f"{(nxt - t_fault) * 1e3:.3f} ms | {where}", flush=True)
            if hits1 != hits0 or hits2 != hits1:
                raise AssertionError("a prefix hit after the recovery: the "
                                     "radix index outlived the pools")
            if reply_tokens(warm, warm_again) != warm_tokens:
                raise AssertionError("the warm-up prompt's tokens changed "
                                     "across the recovery")
            # engine.prefill: exactly one request fails, the next succeeds
            probe = np.random.default_rng(15).integers(0, vocab, 20).tolist()
            default_chaos().arm([parse_point("engine.prefill:once")])
            first = post_h(httpd.port, model, {"prompt_ids": [probe],
                                               "max_new_tokens": 4}, {})
            second = post_h(httpd.port, model, {"prompt_ids": [probe],
                                                "max_new_tokens": 4}, {})
            default_chaos().disarm()
            print(f"chaos 14b: engine.prefill:once → {first[0]} "
                  f"{first[1].get('log', '')!r}, then {second[0]}", flush=True)
            if (first[0] != 500 or "engine.prefill" not in first[1]["log"]
                    or second[0] != 200
                    or len(reply_tokens(probe, second)) != 4):
                raise AssertionError("engine.prefill:once did not fail "
                                     "exactly one request")
            if recoveries.value(model=model) - rec0 != 1:
                raise AssertionError("a prefill fault ran the recovery")
        finally:
            default_chaos().disarm()
            httpd.stop()
            ms.close()
    finally:
        for key in (*knobs, "KFT_TRACE_ENABLED"):
            os.environ.pop(key, None)
        tracer.configure(enabled=True, capacity=4096, sample_keep=128)
    launches = dict(pa.launch_counts)
    print(f"chaos serve: paged launches {launches} in "
          f"{time.monotonic() - t_phase:.3f} s", flush=True)
    return launches


def check_traced_run(port, tracer, replies, tag, step_ms, span_rel):
    """14a's trace gates: ids echoed, the traceparent continued, each
    request's spans in its /debug/trace dump with engine.step spans
    inside its decode span, /tracez keeping every request, /statusz up,
    and the median engine.step span within `span_rel` of the run's
    decode_step_ms."""
    ids = {}
    for i, (_, _, headers) in replies.items():
        want_id = TRACE_ID if i == 0 else f"{tag}-{i}"
        if headers.get("X-Request-Id") != want_id:
            raise AssertionError(f"request {i} echoed "
                                 f"{headers.get('X-Request-Id')!r}, not "
                                 f"{want_id!r}")
        ids[i] = want_id
    records = tracer.snapshot()
    continued = [r for r in records if r.trace_id == f"{TRACE_ID}/0"]
    if not continued or any(r.parent_span_id != PARENT_SPAN
                            for r in continued):
        raise AssertionError("the traceparent's trace was not continued")
    _, body = get(port, "/debug/trace")
    steps = [e for e in json.loads(body)["traceEvents"]
             if e["name"] == "engine.step" and e["ph"] == "X"]
    inside = {}
    for i, rid in ids.items():
        _, body = get(port, f"/debug/trace?trace_id={rid}")
        events = [e for e in json.loads(body)["traceEvents"] if e["ph"] != "M"]
        names = {e["name"] for e in events}
        need = {"request.queue_wait", "request.prefill", "request.decode"}
        if not need <= names:
            raise AssertionError(f"/debug/trace for {rid} lacks "
                                 f"{need - names}")
        (decode,) = [e for e in events if e["name"] == "request.decode"]
        end = decode["ts"] + decode["dur"]
        inside[i] = sum(decode["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end
                        for e in steps)
        if inside[i] < 1:
            raise AssertionError(f"no engine.step span inside {rid}'s decode")
    _, body = get(port, "/tracez")
    kept = {t["trace_id"] for t in json.loads(body)["traces"]}
    if not set(ids.values()) <= kept:
        raise AssertionError(f"/tracez lacks {set(ids.values()) - kept}")
    status, body = get(port, "/statusz")
    if status != 200 or b"[engines]" not in body:
        raise AssertionError("/statusz lacks its engines section")
    durs = [r.dur_s * 1e3 for r in records if r.name == "engine.step"]
    median = statistics.median(durs)
    print(f"chaos 14a: {len(records)} records; engine.step spans "
          f"{len(durs)}, median {median:.3f} ms, mean "
          f"{statistics.mean(durs):.3f} ms against decode_step_ms "
          f"{step_ms:.3f} ({median / step_ms:.4f}x); steps inside each "
          f"request's decode span {inside}; /statusz:\n"
          + body.decode().strip(), flush=True)
    if span_rel is not None and abs(median / step_ms - 1.0) > span_rel:
        raise AssertionError(f"the median engine.step span {median:.3f} ms "
                             f"is not within {span_rel:.0%} of "
                             f"decode_step_ms {step_ms:.3f}")


def phase_chaos_train(torch, root, want_losses, want_params, overrides=None,
                      device="cuda"):
    """14c: phase 12's configuration through `run_training` with
    CHAOS_TRAIN_PLAN: the run raises ChaosError after step 2's save (whose
    first shard write the retry absorbed), a restart without the plan
    resumes from step 2, and its losses and step-4 params equal phase
    12's uninterrupted run's (`want_losses`, `want_params`: name → CPU
    tensor), bit for bit. Returns the flash launches."""
    from kubeflow_tpu_torch.chaos import ChaosError, default_chaos
    from kubeflow_tpu_torch.checkpointing import latest_committed_step
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.observability.trace import default_tracer
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer
    from kubeflow_tpu_torch.utils.metrics import faults_injected_counter

    directory = os.path.join(root, "chaos")
    cfg = TrainingConfig(**{**CKPT_TRAIN_CFG, **(overrides or {})},
                         checkpoint=dict(directory=directory,
                                         interval_steps=CKPT_INTERVAL))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFT_CHAOS_")}
    faults = faults_injected_counter()
    points = ("trainer.device_step", "checkpoint.shard_write")
    before = {p: faults.value(point=p) for p in points}
    tracer = default_tracer()
    tracer.configure(enabled=True)
    tracer.clear()
    fa.reset_launch_counts()
    t0 = time.monotonic()
    try:
        run_training(cfg, device=device, log_every=cfg.steps,
                     environ={**env, "KFT_CHAOS_POINTS": CHAOS_TRAIN_PLAN})
    except ChaosError as e:
        raised = e
    else:
        raise AssertionError("the chaos plan did not fail the run")
    fired = {p: faults.value(point=p) - before[p] for p in points}
    committed = latest_committed_step(directory)
    if (raised.point != "trainer.device_step" or fired != dict.fromkeys(points, 1)
            or committed != CKPT_INTERVAL or default_chaos().enabled):
        raise AssertionError(f"14c: {raised}, faults {fired}, committed "
                             f"{committed}, armed {default_chaos().enabled}")
    trainer = Trainer(cfg, device=device)
    resumed = run_training(cfg, restore=True, device=device,
                           log_every=cfg.steps, environ=env, trainer=trainer)
    wall = time.monotonic() - t0
    got = {name: p.detach().cpu()
           for name, p in trainer._final_state.model.named_parameters()}
    same = sorted(name for name in want_params
                  if torch.equal(got[name], want_params[name]))
    spans = [r for r in tracer.snapshot() if r.name == "train.device_step"]
    launches = dict(fa.launch_counts)
    print(f"chaos 14c: {raised} after step {committed}'s save (faults "
          f"{fired}); resumed {resumed['losses']} (restore "
          f"{resumed['restore_s']:.3f} s); {len(same)}/{len(want_params)} "
          f"params bitwise phase 12's; {len(spans)} train.device_step spans; "
          f"flash launches {launches}; {wall:.3f} s | "
          f"{smi_line() if device == 'cuda' else device}", flush=True)
    if resumed["final_step"] != cfg.steps or \
            resumed["losses"] != want_losses[CKPT_INTERVAL:]:
        raise AssertionError(f"the resumed losses {resumed['losses']} are not "
                             f"phase 12's {want_losses[CKPT_INTERVAL:]}")
    if len(same) != len(want_params) or got.keys() != want_params.keys():
        raise AssertionError("the resumed step-4 params differ from phase "
                             "12's uninterrupted run")
    if len(spans) < cfg.steps:
        raise AssertionError(f"{len(spans)} train.device_step spans")
    return launches


def phase_resnet_train(torch, device="cuda"):
    """15a: run_training of resnet50 at RESNET_CFG. Gates: finite losses,
    the BatchNorm running averages moved and finite, the synthetic and
    augment streams on the card. Prints images/sec/card, step ms, MFU
    and the device-busy share over RESNET_PROFILED profiled steps."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    torch.backends.cudnn.benchmark = True
    cfg = TrainingConfig(**RESNET_CFG)
    trainer = Trainer(cfg, device=device)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    result = run_training(cfg, device=device, log_every=cfg.steps,
                          trainer=trainer)
    wall = time.monotonic() - t0
    losses = [loss for _, loss in result["losses"]]
    state = trainer._final_state
    bufs = dict(state.model.named_buffers())
    moved = sum(int(not torch.equal(b, torch.zeros_like(b) if n.endswith(
        ".mean") else torch.ones_like(b))) for n, b in bufs.items())
    finite = all(bool(torch.isfinite(b).all()) for b in bufs.values())
    step_ms = result["step_time_s"] * 1e3
    # the device's busy time a step: kernel time over profiled steps
    busy, top = float("nan"), []
    if cuda:
        gen = trainer.task.synthetic_data().device_batch_fn(device)
        step = state.step
        state, _ = trainer.train_step(state, gen(step))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(RESNET_PROFILED):
                state, _ = trainer.train_step(state, gen(step + 1 + i))
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3 \
            / RESNET_PROFILED
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"resnet 15a ({smi_line() if cuda else 'cpu'}): resnet50 bf16 224² batch "
          f"{cfg.global_batch_size}, {cfg.steps} steps in {wall:.3f} s; "
          f"{result['items_per_sec']:.1f} images/sec/card; steady step "
          f"{step_ms:.3f} ms (steps 2-{cfg.steps}, one host sync at their "
          f"end); mfu {result.get('mfu')}; compile_s "
          f"{result.get('compile_s')}; device busy {busy:.3f} ms a step = "
          f"{100 * busy / step_ms:.1f} % of the steady step (idle "
          f"{100 - 100 * busy / step_ms:.1f} %); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() if cuda else 0} B", flush=True)
    print("resnet 15a: losses " + json.dumps(losses), flush=True)
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / RESNET_PROFILED:9.3f} ms "
              f"a step {e.count / RESNET_PROFILED:7.1f}x  {e.key[:80]}",
              flush=True)
    if len(losses) != cfg.steps or not all(np.isfinite(losses)):
        raise AssertionError(f"15a: losses {losses}")
    if not finite or moved != len(bufs):
        raise AssertionError(f"15a: {moved} of {len(bufs)} BatchNorm "
                             f"running averages moved (finite: {finite})")
    if trainer.input_path != "device" or trainer.augment_device != device:
        raise AssertionError(f"15a: batches {trainer.input_path}, augment "
                             f"on {trainer.augment_device}")
    del trainer, state
    torch.cuda.empty_cache()
    return {"images_per_sec": result["items_per_sec"], "step_ms": step_ms,
            "busy_ms": busy}


def write_blob_shards(root):
    """make_blobs (BLOBS_CLASSES classes, BLOBS_SIZE px) as BLOBS_SHARDS
    train-*.npz shards and one val-0.npz under `root`; → the val arrays."""
    from kubeflow_tpu_torch.training.datasets import make_blobs

    arrays = make_blobs(BLOBS_TRAIN + BLOBS_VAL, image_size=BLOBS_SIZE,
                        num_classes=BLOBS_CLASSES, seed=0)
    per = BLOBS_TRAIN // BLOBS_SHARDS
    for i in range(BLOBS_SHARDS):
        np.savez(os.path.join(root, f"train-{i}.npz"),
                 **{k: v[i * per:(i + 1) * per] for k, v in arrays.items()})
    val = {k: v[BLOBS_TRAIN:] for k, v in arrays.items()}
    np.savez(os.path.join(root, "val-0.npz"), **val)
    return val


def phase_resnet_accuracy(torch, root, device="cuda"):
    """15b: resnet50 bf16 trained from npz shards (data.name=npz) through
    the native ShardPrefetcher until eval top-1 reaches ACCURACY_TARGET
    (an eval every ACCURACY_EVERY steps): the reader loaded natively,
    top-1 reached and the run stopped before its budget. Then the resume
    gate, with deterministic cuDNN (`torch.backends.cudnn.deterministic =
    True`, `benchmark = False`: the backward algorithms then use no
    atomics and every run picks the same ones): a run saved at step
    RESUME_AT and restarted ends with the step-RESUME_STEPS params,
    BatchNorm running averages and momentum buffers of an uninterrupted
    run, bit for bit. → (the trained model, the val arrays, eval top-1)."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.native.shard_prefetch import native_loaded
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    data_dir = os.path.join(root, "blobs")
    os.makedirs(data_dir)
    val = write_blob_shards(data_dir)
    if not native_loaded():
        raise AssertionError("15b: the native shard reader did not load "
                             "(python IO fallback)")
    cfg = TrainingConfig(**ACCURACY_CFG, data={
        "name": "npz", "path": data_dir, "eval_every_steps": ACCURACY_EVERY,
        "target_accuracy": ACCURACY_TARGET})
    trainer = Trainer(cfg, device=device)
    t0 = time.monotonic()
    result = run_training(cfg, device=device, log_every=ACCURACY_EVERY,
                          trainer=trainer)
    wall = time.monotonic() - t0
    print(f"resnet 15b ({smi_line() if device == 'cuda' else 'cpu'}): npz shards through the native reader; "
          f"eval top-1 {result.get('eval_top1')} (loss "
          f"{result.get('eval_loss')}) at step {result['final_step']} of "
          f"{cfg.steps} in {wall:.3f} s; {result['items_per_sec']:.1f} "
          f"images/sec/card at {BLOBS_SIZE} px; input {trainer.input_path}",
          flush=True)
    if not result.get("target_reached") or result["final_step"] >= cfg.steps:
        raise AssertionError(f"15b: target {ACCURACY_TARGET} not reached "
                             f"early: {result}")
    model = trainer._final_state.model
    top1 = result["eval_top1"]
    del trainer

    # the resume gate: uninterrupted against saved-and-restarted
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        base = dict(ACCURACY_CFG, steps=RESUME_STEPS,
                    data={"name": "npz", "path": data_dir})

        def final(run_cfg, **kw):
            t = Trainer(run_cfg, device=device)
            run_training(run_cfg, device=device, trainer=t, **kw)
            st = t._final_state
            out = {f"params/{n}": p.detach().clone()
                   for n, p in st.model.named_parameters()}
            out.update({f"buffers/{n}": b.clone()
                        for n, b in st.model.named_buffers()})
            out.update({f"momentum/{n}": st.optimizer.state[p][
                "momentum_buffer"].clone()
                for n, p in st.model.named_parameters()})
            return out

        want = final(TrainingConfig(**base))
        ckpt = {"enabled": True, "directory": os.path.join(root, "ckpt"),
                "interval_steps": RESUME_AT, "async_save": False}
        run_cfg = TrainingConfig(**{**base, "checkpoint": ckpt})
        t = Trainer(run_cfg, device=device)
        run_training(run_cfg, device=device, trainer=t,
                     steps_override=RESUME_AT)
        del t
        got = final(run_cfg, restore=True)
    finally:
        torch.backends.cudnn.deterministic = False
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    print(f"resnet 15b: resume at step {RESUME_AT} of {RESUME_STEPS} "
          f"(deterministic cuDNN): {len(want) - len(differ)} of {len(want)} "
          f"params, running averages and momentum buffers bit for bit",
          flush=True)
    if differ or len(got) != len(want):
        raise AssertionError(f"15b: the resumed run differs in {differ[:6]}")
    torch.cuda.empty_cache()
    return model, val, top1


def _margins(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def post_npy(port, name, rows):
    """POST rows to :predict_npy → (predictions, seconds, headers)."""
    buf = io.BytesIO()
    np.save(buf, rows, allow_pickle=False)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:predict_npy",
        data=buf.getvalue(), method="POST",
        headers={"Content-Type": "application/octet-stream"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as resp:
        body, headers = resp.read(), dict(resp.headers)
    return (np.load(io.BytesIO(body), allow_pickle=False),
            time.monotonic() - t0, headers)

def npy_clients(port, name, chunks):
    """PREDICT_CLIENTS threads post `chunks` between them → (replies in
    order, wall seconds)."""
    out = [None] * len(chunks)

    def work(idx):
        for i in idx:
            out[i] = post_npy(port, name, chunks[i])

    threads = [threading.Thread(target=work, args=(
        range(c, len(chunks), PREDICT_CLIENTS),)) for c in range(
            PREDICT_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads) or any(o is None for o in out):
        raise AssertionError("15c: a client did not finish")
    return out, time.monotonic() - t0


def phase_resnet_predict(torch, model, val, eval_top1, device="cuda"):
    """15c: 15b's trained resnet50 served over REST through
    `ServedModel(name, apply_fn, variables)` with a 2 ms batch window:
    :predict_npy of every val row (4 clients at once) and one :predict
    JSON request. Gates: top-1 equals 15b's eval forward wherever its
    bf16 margin exceeds DELTA, accuracy within ACC_GAP of 15b's eval
    top-1; top-1 equals the f32 CPU forward of the same variables
    wherever its margin exceeds DELTA, logits within PREDICT_LOGIT_REL of
    its largest. Then seed-0 resnet50 at 224²/1000, every bucket warmed,
    PREDICT_CLIENTS concurrent clients: images/sec, p50/p99 latency, the
    batcher's fusion (fewer device batches than requests) and the
    decomposition headers; `from_registry("resnet50")` must refuse."""
    from kubeflow_tpu_torch.api.wsgi import Server
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.server import ModelServer, ServedModel

    def apply_fn(m, x):
        return m(x, train=False)

    x, y = val["image"], val["label"].astype(np.int64)
    # 15b's eval forward: its batches of 64 rows in eval mode
    with torch.no_grad():
        want = np.concatenate([
            model(torch.from_numpy(x[i:i + 64]).to(device)).float().cpu().numpy()
            for i in range(0, len(x), 64)])

    served = ServedModel("resnet50-blobs", apply_fn, model,
                         batch_window_ms=2.0, device=device)
    ms = ModelServer()
    ms.add(served)
    httpd = Server(ms.app, port=0)
    httpd.start()
    try:
        chunks = [x[i:i + PREDICT_ROWS] for i in range(0, len(x), PREDICT_ROWS)]
        replies, _ = npy_clients(httpd.port, served.name, chunks)
        got = np.concatenate([r[0] for r in replies])
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.port}/v1/models/{served.name}:predict",
            data=json.dumps({"instances": x[:3].tolist()}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            status = resp.status
            json_rows = np.asarray(json.loads(resp.read())["predictions"],
                                   np.float32)
    finally:
        httpd.stop()
        ms.close()
    f32 = get_model("resnet50", dtype=torch.float32, device="cpu")
    f32.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        ref = f32(torch.from_numpy(x)).numpy()
    del f32
    pred, want_pred, ref_pred = got.argmax(-1), want.argmax(-1), ref.argmax(-1)
    sure_eval = _margins(want) > DELTA
    sure_f32 = _margins(ref) > DELTA
    acc = float((pred == y).mean())
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"resnet 15c: {len(x)} val rows over :predict_npy; accuracy {acc:.4f} "
          f"against 15b's eval top-1 {eval_top1:.4f}; top-1 equal to the eval "
          f"forward on {int((pred == want_pred)[sure_eval].sum())} of "
          f"{int(sure_eval.sum())} rows with margin > {DELTA} "
          f"({int((pred == want_pred).sum())} of {len(x)} in all); equal to "
          f"the f32 CPU forward on {int((pred == ref_pred)[sure_f32].sum())} "
          f"of {int(sure_f32.sum())} sure rows; logits within {err:.4f} of "
          f"the largest |f32 logit| (bound {PREDICT_LOGIT_REL}); :predict "
          f"JSON status {status}", flush=True)
    if (status != 200 or not (pred == want_pred)[sure_eval].all()
            or abs(acc - eval_top1) > ACC_GAP
            or not (pred == ref_pred)[sure_f32].all()
            or err > PREDICT_LOGIT_REL
            or np.abs(json_rows - got[:3]).max() > PREDICT_LOGIT_REL * np.abs(
                ref).max()):
        raise AssertionError("15c: served predictions disagree")

    # throughput: seed-0 resnet50 at 224² / 1000 classes; from_registry
    # (params only, as in the reference) refuses it first
    model = get_model("resnet50", device=device)
    try:
        ServedModel.from_registry("resnet50", device=device,
                                  params=dict(model.named_parameters()))
    except ValueError as e:
        if "batch_stats" not in str(e):
            raise
        print(f"resnet 15c: from_registry refused: {e}", flush=True)
    else:
        raise AssertionError("15c: from_registry served a BatchNorm model")
    phase_predict_load(torch, model, device)


def phase_predict_load(torch, model, device="cuda"):
    """15c's load: seed-0 `model` (resnet50, 224², 1000 classes) served
    with every bucket warmed, PREDICT_CLIENTS clients at once."""
    from kubeflow_tpu_torch.api.wsgi import Server
    from kubeflow_tpu_torch.serving.server import ModelServer, ServedModel

    torch.backends.cudnn.benchmark = True
    served = ServedModel("resnet50", lambda m, x: m(x, train=False), model,
                         batch_window_ms=2.0, device=device)
    t0 = time.monotonic()
    served.warmup((224, 224, 3))
    print(f"resnet 15c: every bucket warmed in {time.monotonic() - t0:.3f} s",
          flush=True)
    ms = ModelServer()
    ms.add(served)
    httpd = Server(ms.app, port=0)
    httpd.start()
    try:
        rng = np.random.default_rng(15)
        n = PREDICT_CLIENTS * PREDICT_REQUESTS
        chunks = [rng.standard_normal((PREDICT_ROWS, 224, 224, 3),
                                      dtype=np.float32) for _ in range(n)]
        before = served.batch_stats()
        replies, wall = npy_clients(httpd.port, served.name, chunks)
        lat = sorted(r[1] * 1e3 for r in replies)
        after = served.batch_stats()
        # the load's own batches (the warm-up's ran through the batcher)
        fused = after["fused_batches"] - before["fused_batches"]
        stats = {"fused_batches": fused, "fused_rows_mean": (
            after["fused_rows_mean"] * after["fused_batches"]
            - before["fused_rows_mean"] * before["fused_batches"]) / fused}
    finally:
        httpd.stop()
        ms.close()
    heads = {k: v for k, v in replies[-1][2].items() if k.startswith("X-")}
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
    for r in sorted(replies, key=lambda r: -r[1])[:3]:
        print(f"resnet 15c: a slowest request {r[1] * 1e3:.3f} ms: " + json.dumps(
            {k: v for k, v in r[2].items() if k.startswith("X-")}), flush=True)
    print(f"resnet 15c ({smi_line() if device == 'cuda' else 'cpu'}): :predict_npy resnet50 bf16 224², "
          f"{PREDICT_CLIENTS} clients x {PREDICT_REQUESTS} requests of "
          f"{PREDICT_ROWS} images: {n * PREDICT_ROWS / wall:.1f} images/sec; "
          f"latency p50 {statistics.median(lat):.3f} ms p99 {p99:.3f} ms; "
          f"{json.dumps(stats)} for {n} requests; last reply's headers "
          f"{json.dumps(heads)}", flush=True)
    if not stats or stats["fused_batches"] >= n:
        raise AssertionError(f"15c: {stats} device batches for {n} requests")
    if not all(r[0].shape == (PREDICT_ROWS, 1000) and np.isfinite(r[0]).all()
               for r in replies):
        raise AssertionError("15c: a reply is not finite [16, 1000] logits")
    del model, served
    torch.cuda.empty_cache()


def phase_image(torch, device="cuda"):
    """Phase 15: the image path (15a, 15b, 15c); none of the attention
    kernels runs in it. → 15a's images/sec, step and busy ms."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import paged_attention as pa

    fa.reset_launch_counts()
    pa.reset_launch_counts()
    t15 = time.monotonic()
    resnet = phase_resnet_train(torch, device)
    with tempfile.TemporaryDirectory(prefix="kft-resnet-") as root:
        model, val, top1 = phase_resnet_accuracy(torch, root, device)
        phase_resnet_predict(torch, model, val, top1, device)
    launched = {**fa.launch_counts, **pa.launch_counts}
    print(f"phase 15: {time.monotonic() - t15:.3f} s; attention kernel "
          f"launches {json.dumps(launched)}", flush=True)
    if any(launched.values()):
        raise AssertionError(f"the image path launched {launched}")
    return resnet


# -- phase 16: BERT-base pretraining ----------------------------------------


def device_busy_ms(torch, trainer, state, steps, top=6):
    """(device busy ms a step, the top kernels by device time) over
    `steps` profiled train steps on the synthetic stream's next batches,
    after one unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    gen = trainer.task.synthetic_data().device_batch_fn(trainer.device)
    step = state.step
    state, _ = trainer.train_step(state, gen(step))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            state, _ = trainer.train_step(state, gen(step + 1 + i))
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / steps
    return busy, sorted(events, key=lambda e: -e.self_device_time_total)[:top]


def phase_bert_train(torch, overrides=None, device="cuda", tag="bert 16a"):
    """16a, the main path: `Trainer.fit` of BERT_CFG (bert_base through
    the flash kernels, dropout 0.1, the mlm stream on the card). Gates:
    every loss finite, the input made on the device, each flash kernel
    launched exactly once per layer a step. Prints tokens/sec/card, step
    ms, MFU, device busy ms a step and peak memory → the launches."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig(**{**BERT_CFG, **(overrides or {})})
    trainer = Trainer(cfg, device=device)
    layers = trainer.model.cfg.num_layers
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the main path's run: every launch count starts at 0 here
    fa.reset_launch_counts()
    t0 = time.monotonic()
    metrics = trainer.fit(log_every=cfg.steps)
    wall = time.monotonic() - t0
    launches = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = [loss for _, loss in trainer.losses]
    busy, top = float("nan"), []
    if cuda:
        busy, top = device_busy_ms(torch, trainer, trainer._final_state,
                                   BERT_PROFILED)
    step_ms = metrics.step_time_s * 1e3
    print(f"{tag} ({smi_line() if cuda else device}): {cfg.model} "
          f"{cfg.dtype} S={cfg.seq_len} batch {cfg.global_batch_size} "
          f"dropout {trainer.model.cfg.dropout_rate} "
          f"{cfg.attention_impl}, {cfg.steps} steps in {wall:.3f} s; "
          f"{metrics.items_per_sec:.1f} tokens/sec/card; steady step "
          f"{step_ms:.3f} ms (steps 2-{cfg.steps}, one host sync at their "
          f"end); mfu {metrics.aux.get('mfu')}; compile_s "
          f"{metrics.aux.get('compile_s')}; device busy {busy:.3f} ms a step "
          f"= {100 * busy / step_ms:.1f} % of the steady step (idle "
          f"{100 - 100 * busy / step_ms:.1f} %); max_memory_allocated {peak} B; "
          f"input {trainer.input_path}", flush=True)
    print(f"{tag}: losses " + json.dumps(losses), flush=True)
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / BERT_PROFILED:9.3f} ms "
              f"a step {e.count / BERT_PROFILED:7.1f}x  {e.key[:80]}",
              flush=True)
    want = {name: cfg.steps * layers for name in launches}
    print(f"{tag}: launches {launches} (one per layer a step: {want})",
          flush=True)
    if len(losses) != cfg.steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if trainer.input_path != "device":
        raise AssertionError(f"{tag}: batches from {trainer.input_path}")
    if cuda and launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    del trainer, metrics
    return launches


def ragged_batch(torch, batch, lengths):
    """`batch` with row i's attention mask keeping its first lengths[i]
    keys."""
    mask = batch["attention_mask"].clone()
    for row, n in enumerate(lengths[:mask.shape[0]]):
        mask[row, n:] = 0
    return {**batch, "attention_mask": mask}


def bert_trainer(torch, cfg, device, dropout_rate):
    """A Trainer of `cfg` whose model is the config's at `dropout_rate`
    (the factory's kwargs the trainer would pass, and this rate)."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.training.trainer import Trainer

    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = get_model(cfg.model, dtype=dtype, max_len=cfg.seq_len,
                      attention_impl=cfg.attention_impl,
                      dropout_rate=dropout_rate, device=device, seed=cfg.seed)
    return Trainer(cfg, model=model, device=device)


def phase_bert_parity(torch, overrides=None, device="cuda"):
    """16b: BERT_CFG at dropout 0 through flash and dense from one seeded
    init: first one forward and backward on a batch with ragged key
    masks (loss and global gradient norm), then BERT_PARITY_STEPS steps
    of `Trainer.fit` on the same batches (per-step losses); both within
    BERT_LOSS_REL / BERT_GRAD_REL. Prints both step times and what
    "auto" picks at this shape."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops.attention import auto_attention_impl

    runs = {}
    for impl in ("flash", "dense"):
        cfg = TrainingConfig(**{**BERT_CFG, "steps": BERT_PARITY_STEPS,
                                **(overrides or {}), "attention_impl": impl})
        trainer = bert_trainer(torch, cfg, device, dropout_rate=0.0)
        state = trainer.init_state()
        gen = trainer.task.synthetic_data().device_batch_fn(device)
        # a batch of the stream that no step of the run trains on
        batch = ragged_batch(torch, gen(10_000), BERT_LENGTHS)
        fa.reset_launch_counts()
        loss, _ = trainer.task.loss(state.model, batch)
        loss.backward()
        grads = [p.grad.float() for p in state.model.parameters()]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        ragged = (loss.item(), norm.item())
        state.optimizer.zero_grad(set_to_none=True)
        metrics = trainer.fit(state=state, log_every=cfg.steps)
        runs[impl] = {"ragged": ragged,
                      "losses": [x for _, x in trainer.losses],
                      "step_ms": metrics.step_time_s * 1e3,
                      "launches": dict(fa.launch_counts)}
        print(f"bert 16b {impl}: ragged-mask loss {ragged[0]!r} grad norm "
              f"{ragged[1]!r}; losses {runs[impl]['losses']}; steady step "
              f"{runs[impl]['step_ms']:.3f} ms; launches "
              f"{runs[impl]['launches']}", flush=True)
        del trainer, state, batch, grads
        if device == "cuda":
            torch.cuda.empty_cache()
    f, d = runs["flash"], runs["dense"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(f["losses"] + [f["ragged"][0]],
                       d["losses"] + [d["ragged"][0]]))
    grad_gap = abs(f["ragged"][1] - d["ragged"][1]) / abs(d["ragged"][1])
    b, s = BERT_CFG["global_batch_size"], BERT_CFG["seq_len"]
    auto = auto_attention_impl(b, s, BH, torch.bfloat16, device=device)
    print(f"bert 16b ({smi_line() if device == 'cuda' else device}): worst "
          f"relative loss gap flash vs dense {loss_gap:.3e} (rel "
          f"{BERT_LOSS_REL:g}); ragged grad norm gap {grad_gap:.3e} (rel "
          f"{BERT_GRAD_REL:g}); steady step flash {f['step_ms']:.3f} ms, "
          f"dense {d['step_ms']:.3f} ms; auto picks {auto!r} at B={b} "
          f"S={s} H={BH}", flush=True)
    if len(f["losses"]) != len(d["losses"]) or not loss_gap <= BERT_LOSS_REL:
        raise AssertionError(f"16b: flash and dense losses disagree: {runs}")
    if not grad_gap <= BERT_GRAD_REL:
        raise AssertionError(f"16b: flash and dense gradient norms disagree: "
                             f"{runs}")
    if device == "cuda" and (min(f["launches"].values()) < 1
                             or any(d["launches"].values())):
        raise AssertionError(f"16b: flash launches wrong: {runs}")
    return auto


def phase_bert_ckpt(torch, root, overrides=None, device="cuda"):
    """16c: `run_training` of BERT_CFG cut to BERT_CKPT_STEPS steps with
    a save every BERT_CKPT_INTERVAL, once uninterrupted and once
    preempted during step BERT_CKPT_PREEMPT and resumed. With dropout 0.1
    on, the resumed run's losses and its last checkpoint (params, AdamW
    moments, counts) must equal the uninterrupted run's, bit for bit."""
    from kubeflow_tpu_torch.checkpointing import layout
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.train_run import run_training

    def cfg(name):
        return TrainingConfig(**{
            **BERT_CFG, "steps": BERT_CKPT_STEPS, **(overrides or {}),
            "checkpoint": dict(directory=os.path.join(root, name),
                               interval_steps=BERT_CKPT_INTERVAL)})

    def run(name, **kw):
        c = cfg(name)
        return run_training(c, device=device, log_every=steps, trainer=(
            bert_trainer(torch, c, device, BERT_DROPOUT)), **kw)

    steps, cut_dir = BERT_CKPT_STEPS, cfg("cut").checkpoint.directory
    t0 = time.monotonic()
    whole = run("whole")
    cut = run("cut", stop_event=StopAfter(BERT_CKPT_PREEMPT - 1))
    committed = layout.committed_steps(cut_dir)
    resumed = run("cut", restore=True)
    print(f"bert 16c: uninterrupted losses {whole['losses']}; preempted "
          f"{cut['losses']} (final step {cut['final_step']}, committed "
          f"{committed}); resumed {resumed['losses']}; "
          f"{time.monotonic() - t0:.3f} s for the three runs", flush=True)
    if not cut["preempted"] or cut["final_step"] != BERT_CKPT_PREEMPT:
        raise AssertionError(f"16c: the second run did not stop at step "
                             f"{BERT_CKPT_PREEMPT}: {cut}")
    if committed[-1:] != [BERT_CKPT_PREEMPT]:
        raise AssertionError(f"16c: the preempted run committed {committed}")
    if (resumed["final_step"] != steps
            or resumed["losses"] != whole["losses"][BERT_CKPT_PREEMPT:]
            or cut["losses"] != whole["losses"][:BERT_CKPT_PREEMPT]):
        raise AssertionError(f"16c: the resumed run's losses differ: "
                             f"{resumed['losses']} vs {whole['losses']}")
    n_files = same_step_files(cfg("whole").checkpoint.directory, cut_dir, steps)
    print(f"bert 16c: step {steps} of both runs holds the same {n_files} "
          f"shard files (params, AdamW moments, counts), byte for byte, "
          f"with dropout {BERT_DROPOUT} on", flush=True)


def phase_bert(torch, device="cuda"):
    """Phase 16: BERT-base pretraining (16a, 16b, 16c) → 16a's flash
    launches."""
    t16 = time.monotonic()
    launches = phase_bert_train(torch, device=device)
    phase_bert_parity(torch, device=device)
    with tempfile.TemporaryDirectory(prefix="kft-bert-") as root:
        phase_bert_ckpt(torch, root, device=device)
    print(f"phase 16: {time.monotonic() - t16:.3f} s", flush=True)
    return launches


# -- phase 17: data-parallel training through the gang launcher ------------


def gang_rank() -> int:
    """One rank of a gang of phases 17, 19, 20 or 21 (`python3
    chip_smoke.py --gang-rank`, the rendered KFT_* env, the job in
    KFT_SMOKE_JOB). mode "launcher": `runtime/launcher.py main --config
    <job config>` at world 1 (or each of the job's "runs" in turn,
    `launcher_runs`). mode "runs": `initialize_from_env(backend=...)`
    (gloo: several ranks on one card), then a `Trainer` and
    `run_training` for each of the job's "runs" in turn in this process
    (`rank_runs`). Prints one line "GANG {...}" after the launcher's
    result lines."""
    import torch

    job = json.loads(os.environ["KFT_SMOKE_JOB"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = bool(job.get("cudnn_benchmark"))
    report = {"rank": int(os.environ.get("KFT_PROCESS_ID", "0"))}
    if job["mode"] == "launcher":
        report["runs"] = launcher_runs(torch, job)
        report.update(report["runs"][-1])
        rc = report.pop("rc")
    elif job["mode"] == "runs":
        report["runs"] = rank_runs(torch, job)
        rc = 0
    else:
        raise ValueError(f"unknown gang mode {job['mode']!r}")
    print("GANG " + json.dumps(report), flush=True)
    return rc


def launcher_runs(torch, job):
    """A world-1 rank of mode "launcher": `launcher.main --config` for the
    job's config, or for each of its "runs" in turn in this process (the
    launcher joins and leaves the gang's group each time) → each run's
    {"launches", "result" (the launcher's result line), "rc", and with
    "profile" "busy_ms": the device's kernel time a step over steps
    2..1+RESNET_PROFILED, CUDA activity only}. A profiled run goes last:
    a window after a profiled one runs slower (CUPTI stays attached)."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime import launcher
    from kubeflow_tpu_torch.training.trainer import Trainer

    import gc

    runs = job.get("runs") or [{"config": job["config"],
                                "profile": job.get("profile")}]
    out = []
    first_step = Trainer.train_step
    for run in runs:
        prof, calls = None, [0]
        if run.get("profile"):
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])

            def train_step(self, state, batch):
                result = first_step(self, state, batch)
                calls[0] += 1
                if calls[0] in (1, 1 + RESNET_PROFILED):
                    # steps 2..1+RESNET_PROFILED, after the first
                    torch.cuda.synchronize()
                    (prof.start if calls[0] == 1 else prof.stop)()
                return result

            Trainer.train_step = train_step
        # the main path's run: every launch count starts at 0 here
        fa.reset_launch_counts()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = launcher.main(["--config", run["config"]] + (
                    ["--device", job["device"]] if job.get("device") else []))
        finally:
            Trainer.train_step = first_step
            sys.stdout.write(buf.getvalue())
            sys.stdout.flush()
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith('{"job"')]
        rep = {"launches": dict(fa.launch_counts), "rc": rc,
               "result": json.loads(lines[-1]) if lines else None}
        if prof is not None:
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            rep["busy_ms"] = (sum(e.self_device_time_total for e in events)
                              / 1e3 / RESNET_PROFILED)
        out.append(rep)
        if rc:
            break
        gc.collect()
        torch.cuda.empty_cache()
    return out


def rank_runs(torch, job):
    """A gang rank of mode "runs": join the gang (gloo: ranks sharing one
    card), then each of the job's "runs" in turn (a config file, model
    kwargs): a fresh `Trainer` and `run_training` with the flash launch
    counts set to 0 just before and read just after → each run's result,
    launches, backend, device, state bytes, max_memory_allocated, (with
    "digest_step") every parameter's digest as that update leaves it,
    (with "digests") the final leaves' digests, replicated and expert
    blocks apart, and the rank's coordinates, and on a pipeline axis the
    rank's stage, microbatches, schedule and live-activation peak, and on
    an fsdp axis its gathers and reduce-scatters. A run with "serve" is a
    serving-mesh cell of phase 24 (`serve_cell`). With "out" the rank's
    final parameters and buffers are saved as `<out>.<rank>.pt` (by the
    ranks "out_ranks" lists; by default every rank; on an fsdp axis the
    whole parameters, every rank gathering the blocks). One process start
    serves every run."""
    import gc

    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.models.layers import gather_fsdp_params
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel import distributed as gd
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    if job.get("device") == "cpu":
        # ranks sharing the host's cores (a CPU rehearsal)
        torch.set_num_threads(1)
    gd.initialize_from_env(device=job.get("device"), backend=job["backend"])
    dev = gd.gang_device(job.get("device"))
    rank = torch.distributed.get_rank()
    out = []
    for run in job["runs"]:
        t0 = time.monotonic()
        if run.get("serve"):
            # phase 24: a serving-mesh cell, rank 0's server or a worker
            with open(run["config"]) as f:
                rep = serve_cell(torch, json.load(f), dev)
            rep["seconds"] = {"run": time.monotonic() - t0}
            out.append(rep)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            continue
        with open(run["config"]) as f:
            cfg = TrainingConfig.from_dict(json.load(f))
        trainer = Trainer(cfg, device=dev,
                          model_kwargs=run.get("model_kwargs"))
        at = {}
        step_fn = trainer.train_step

        def train_step(state, batch, step_fn=step_fn, at=at, run=run):
            state, metrics = step_fn(state, batch)
            if state.step == run.get("digest_step"):
                at.update({n: digest(torch, p) for n, p in
                           state.model.named_parameters()})
            return state, metrics

        trainer.train_step = train_step
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        built = time.monotonic() - t0
        # the main path's run: every launch count starts at 0 here
        fa.reset_launch_counts()
        result = run_training(cfg, device=dev, trainer=trainer,
                              log_every=cfg.steps)
        rep = {"rank": rank, "result": result,
               "launches": dict(fa.launch_counts),
               "backend": torch.distributed.get_backend(),
               "device": str(dev), "bytes": state_bytes(trainer._final_state),
               "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                        if dev.type == "cuda" else 0),
               "digests_at": at}
        if run.get("digests"):
            # digests, not arrays: the ranks' leaves compared bit for bit
            # without writing each rank's weights to disk
            replicated, blocks = leaf_digests(torch,
                                              trainer._final_state.model)
            rep.update(replicated=replicated, blocks=blocks, blocks_at=at,
                       coords={a: trainer.mesh.get_local_rank(a)
                               for a in ("data", "fsdp", "expert",
                                         "sequence")})
        if trainer.pipe is not None:
            rep.update(stage=trainer.pipe.rank,
                       live=trainer.stage_live.peak,
                       microbatches=trainer.pipeline_microbatches,
                       schedule=trainer.model.cfg.pipeline_schedule)
        if run.get("out"):
            model = trainer._final_state.model
            if trainer.fsdp is not None:
                # a collective: every rank gathers the whole parameters
                arrays = {"params": {n: t.cpu() for n, t in
                                     gather_fsdp_params(model).items()},
                          "buffers": model_arrays(model)["buffers"]}
            if rank in run.get("out_ranks", [rank]):
                torch.save(arrays if trainer.fsdp is not None
                           else model_arrays(model), f"{run['out']}.{rank}.pt")
        rep["seconds"] = {"build": built, "run": time.monotonic() - t0}
        out.append(rep)
        # the step closure refers to the trainer: free the run's state
        # before the next one's peak is read
        del trainer, step_fn, train_step
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    gd.shutdown()
    return out


def run_gang_runs(torch, name, runs, world, root, **job):
    """One gang of `world` ranks (mode "runs") running each (config dict,
    run options) of `runs` in turn in the same processes → for each run,
    the ranks' reports in rank order."""
    return finish_gang_runs(start_gang_runs(torch, name, runs, world, root,
                                            **job))


def start_gang_runs(torch, name, runs, world, root, **job):
    """`run_gang_runs`' gang started, not waited for (`start_gang`) → its
    handle for `finish_gang_runs`."""
    specs = []
    for i, (cfg, opts) in enumerate(runs):
        path = os.path.join(root, f"{name}-run{i}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        specs.append({"config": path, **opts})
    gang = start_gang(torch, name, runs[0][0], world, mode="runs", root=root,
                      runs=specs, **job)
    gang["runs"] = len(specs)
    return gang


def finish_gang_runs(gang):
    """Wait for a `start_gang_runs` gang → for each run, the ranks'
    reports in rank order."""
    outs = finish_gang(gang)
    return [[rep["runs"][i] for _, rep in outs] for i in range(gang["runs"])]


def run_gang(torch, name, cfg, world, mode="launcher", hosts=None, **job):
    """Start `world` ranks of `python3 chip_smoke.py --gang-rank` with
    render_gang_env's env (127.0.0.1 and a port held until the gang
    ends: `reserve_port`), each with its own time limit; → [(launcher
    result or None, GANG report)] in rank order. Any failure kills every
    rank and raises."""
    return finish_gang(start_gang(torch, name, cfg, world, mode=mode,
                                  hosts=hosts, **job))


def start_gang(torch, name, cfg, world, mode="launcher", hosts=None,
               timeout_s=GANG_RANK_TIMEOUT_S, **job):
    """`run_gang`'s processes started, not waited for → the gang's handle
    for `finish_gang` (which reads it) or `stop_gang` (which kills it).
    Several gangs may run at once: each holds its own port."""
    from kubeflow_tpu_torch.parallel.distributed import (
        render_gang_env,
        reserve_port,
    )

    root = job.pop("root")
    cfg_path = os.path.join(root, f"{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    held = reserve_port()
    envs = render_gang_env(name, hosts or ["127.0.0.1"] * world,
                           coordinator_port=held.getsockname()[1])
    here = os.path.dirname(os.path.abspath(__file__))
    gang = {"name": name, "world": world, "procs": [], "logs": [],
            "held": held, "t0": time.monotonic(),
            "deadline": time.monotonic() + timeout_s}
    try:
        for i, e in enumerate(envs):
            env = dict(os.environ, **e, KFT_SMOKE_JOB=json.dumps(
                {"mode": mode, "config": cfg_path,
                 "out": os.path.join(root, name), **job}))
            env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
            gang["logs"].append(tuple(open(os.path.join(
                root, f"{name}.{i}.{k}"), "w+") for k in ("out", "err")))
            gang["procs"].append(subprocess.Popen(
                [sys.executable, os.path.join(here, "chip_smoke.py"),
                 "--gang-rank"], env=env, cwd=here,
                stdout=gang["logs"][-1][0], stderr=gang["logs"][-1][1],
                text=True))
    except BaseException:
        stop_gang(gang)
        raise
    return gang


def stop_gang(gang):
    """Kill a gang's live ranks, close its logs and release its port (a
    gang already stopped: nothing)."""
    for p in gang["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in (f for pair in gang["logs"] for f in pair):
        if not f.closed:
            f.close()
    gang["held"].close()


def finish_gang(gang):
    """Wait for a started gang's ranks → [(launcher result or None, GANG
    report)] in rank order. Every rank is polled: the first to fail (or a
    rank past the gang's time limit) fails the gang at once, its peers
    killed (they would wait at their next collective until killed)."""
    name, procs, logs = gang["name"], gang["procs"], gang["logs"]
    outs = []
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > gang["deadline"]:
                i = bad[0] if bad else next(
                    i for i, p in enumerate(procs) if p.poll() is None)
                logs[i][1].seek(0)
                raise AssertionError(
                    f"gang {name}: rank {i} "
                    f"{'exited ' + str(procs[i].returncode) if bad else 'timed out'}"
                    f":\n{logs[i][1].read()[-6000:]}")
            time.sleep(0.2)
        for p, (out_f, err_f) in zip(procs, logs):
            out_f.seek(0)
            err_f.seek(0)
            out, err = out_f.read(), err_f.read()
            if p.returncode != 0:
                raise AssertionError(f"gang {name}: a rank exited "
                                     f"{p.returncode}:\n{err[-6000:]}")
            lines = out.splitlines()
            result = [json.loads(ln) for ln in lines if ln.startswith('{"job"')]
            reports = [json.loads(ln[5:]) for ln in lines
                       if ln.startswith("GANG ")]
            outs.append((result[-1] if result else None, reports[-1]))
    finally:
        stop_gang(gang)
    print(f"gang {name}: {gang['world']} rank(s) in "
          f"{time.monotonic() - gang['t0']:.3f} s (process start to exit)",
          flush=True)
    return outs


def phase_gang_world1(torch, root, image_ref, lm_ref, layers):
    """17a and 17b: the launcher at world 1 over NCCL, one rank process
    running three launches in turn (17a's resnet50, 17b's gpt_small, then
    17a's profiled resnet50). → 17b's launches. 17a's throughput comes
    from an unprofiled run and its device busy time from a second, short
    one, run last: a window after a profiled one ran slower (CUPTI stays
    attached), so one run cannot give both."""
    runs = []
    for name, cfg, profiled in (
            ("resnet", GANG_RESNET_CFG, False),
            ("gpt", GANG_GPT_CFG, False),
            ("resnet-profiled", dict(GANG_RESNET_CFG,
                                     steps=1 + RESNET_PROFILED), True)):
        path = os.path.join(root, f"world1-{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        runs.append({"config": path, "profile": profiled})
    (_, gang), = run_gang(torch, "world1", GANG_RESNET_CFG, 1, root=root,
                          cudnn_benchmark=True, runs=runs)
    res, (gpt_res, gpt_rep), rep = (gang["runs"][0]["result"], (
        gang["runs"][1]["result"], gang["runs"][1]), gang["runs"][2])
    steps = GANG_RESNET_CFG["steps"]
    step_ms = res["step_time_s"] * 1e3
    print(f"gang 17a ({smi_line()}): resnet50 bf16 224² batch "
          f"{GANG_RESNET_CFG['global_batch_size']} through the launcher, world "
          f"{res['world_size']} over {res['backend']}: "
          f"{res['items_per_sec']:.1f} images/sec/card, steady step "
          f"{step_ms:.3f} ms (steps 11-{steps}), device busy "
          f"{rep['busy_ms']:.3f} ms a step (a second run's steps "
          f"2-{1 + RESNET_PROFILED}, CUDA activity traced) = "
          f"{100 * rep['busy_ms'] / step_ms:.1f} %, mfu {res.get('mfu')}; "
          f"in process (15a, this call): {image_ref['images_per_sec']:.1f} "
          f"images/sec/card, step {image_ref['step_ms']:.3f} ms, busy "
          f"{image_ref['busy_ms']:.3f} ms; the launcher's run over the "
          f"in-process one: {res['items_per_sec'] / image_ref['images_per_sec']:.4f}x "
          f"images/sec; gradient all-reduces {res['grad_allreduces']}",
          flush=True)
    if res["backend"] != "nccl" or res["world_size"] != 1:
        raise AssertionError(f"17a: backend {res['backend']}, world "
                             f"{res['world_size']}")
    if res["grad_allreduces"] != steps or res["final_step"] != steps:
        raise AssertionError(f"17a: {res['grad_allreduces']} all-reduces in "
                             f"{res['final_step']} of {steps} steps")
    if not all(np.isfinite(loss) for _, loss in res["losses"]):
        raise AssertionError(f"17a: losses {res['losses']}")

    res, rep = gpt_res, gpt_rep
    cfg = GANG_GPT_CFG
    a, r = cfg["accum_steps"], 2 if cfg["remat"] else 1
    want = {"flash_fwd": cfg["steps"] * layers * a * r,
            "flash_bwd_dq": cfg["steps"] * layers * a,
            "flash_bwd_dkv": cfg["steps"] * layers * a}
    launches = rep["launches"]
    print(f"gang 17b ({smi_line()}): gpt_small bf16 seq {cfg['seq_len']} batch "
          f"{cfg['global_batch_size']} in {a} microbatches, the lm stream made "
          f"on the card, through the launcher, world {res['world_size']} over "
          f"{res['backend']}: {res['items_per_sec']:.1f} tokens/sec/card, "
          f"steady step {res['step_time_s'] * 1e3:.3f} ms, mfu "
          f"{res.get('mfu')}; in process (phase 8, this call): "
          f"{lm_ref['items_per_sec']:.1f} tokens/sec/card, step "
          f"{lm_ref['step_time_s'] * 1e3:.3f} ms, mfu {lm_ref.get('mfu')}; "
          f"gradient all-reduces {res['grad_allreduces']}; flash launches "
          f"{launches} (formula {want})", flush=True)
    if res["backend"] != "nccl" or res["grad_allreduces"] != cfg["steps"]:
        raise AssertionError(f"17b: backend {res['backend']}, "
                             f"{res['grad_allreduces']} all-reduces")
    if launches != want:
        raise AssertionError(f"17b: launches {launches} != {want}")
    if not all(np.isfinite(loss) for _, loss in res["losses"]):
        raise AssertionError(f"17b: losses {res['losses']}")
    return launches


def _rel(a, b):
    return abs(a - b) / abs(b)


def model_arrays(model):
    """{"params", "buffers"}: copies of a model's leaves, on the host."""
    return {"params": {n: p.detach().to("cpu", copy=True) for n, p in
                       model.named_parameters()},
            "buffers": {n: b.detach().to("cpu", copy=True) for n, b in
                        model.named_buffers()}}


def ranks_equal(torch, ranks):
    """Whether every rank's parameters and buffers are bit for bit rank
    0's."""
    return all(torch.equal(r[k][n], ranks[0][k][n]) for r in ranks[1:]
               for k in ("params", "buffers") for n in ranks[0][k])


def is_stack(name):
    """Is this parameter name an MoE expert stack ([E, ...] wi / wo)?"""
    return name.endswith(("moe.wi", "moe.wo"))


def digest(torch, t):
    """sha256 of a tensor's bytes: a bit-for-bit fingerprint."""
    import hashlib

    raw = t.detach().cpu().contiguous().view(torch.uint8).numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


def leaf_digests(torch, model):
    """({name: digest} of the replicated parameters, {name: digest} of the
    blocks this model holds: the expert stacks', the fsdp leaves')."""
    from kubeflow_tpu_torch.models.layers import fsdp_leaves

    held = fsdp_leaves(model)
    out = ({}, {})
    for name, p in model.named_parameters():
        out[1 if is_stack(name) or name in held else 0][name] = digest(
            torch, p)
    return out


def state_bytes(state):
    """Resident bytes of a train state: its parameters, its optimizer's
    moments, and the expert stacks' share of both."""
    out = {"params": 0, "optimizer": 0, "stacks": 0}
    for name, p in state.model.named_parameters():
        own = p.numel() * p.element_size()
        moments = sum(t.numel() * t.element_size() for t in
                      state.optimizer.state.get(p, {}).values()
                      if t.dim() > 0)
        out["params"] += own
        out["optimizer"] += moments
        if is_stack(name):
            out["stacks"] += own + moments
    return out


def fsdp_param_bytes(model, size):
    """f32 bytes of one fsdp rank's parameters from the specs alone: Σ
    numel / size over the leaves whose spec names fsdp (models/layers.py
    `fsdp_leaf_dims` of `model`, a model holding every leaf whole), Σ
    numel over the rest."""
    from kubeflow_tpu_torch.models.layers import fsdp_leaf_dims

    split = fsdp_leaf_dims(model, size)
    return 4 * sum(p.numel() // (size if n in split else 1)
                   for n, p in model.named_parameters())


def update_gap(gang, one, init, skip=()):
    """How far the gang's final weights stray from world 1's, as a share
    of world 1's own update (Frobenius norms): (over every leaf at once,
    the worst leaf's, that leaf)."""
    worst, leaf, gaps, moves = 0.0, None, 0.0, 0.0
    for n, w in one.items():
        if n.endswith(skip):
            continue
        gap = float((gang[n] - w).norm())
        moved = float((w - init[n]).norm())
        gaps, moves = gaps + gap ** 2, moves + moved ** 2
        rel = gap / moved if moved else (0.0 if gap == 0 else float("inf"))
        if rel >= worst:
            worst, leaf = rel, n
    return (gaps / moves) ** 0.5, worst, leaf


def data_plan(root):
    """17c's gang runs, (config, run options) each: resnet50 on `{data:
    2}` saving at GANG2_SAVE, then gpt_small; every rank's final weights
    saved."""
    ckpt = os.path.join(root, "gang-ckpt")
    gang_cfg = dict(GANG2_RESNET_CFG, mesh={"data": 2}, checkpoint={
        "directory": ckpt, "interval_steps": GANG2_SAVE, "keep": 10,
        "async_save": False})
    gpt_cfg = dict(GANG2_GPT_CFG, mesh={"data": 2})
    return [(gang_cfg, {"out": os.path.join(root, "resnet2")}),
            (gpt_cfg, {"out": os.path.join(root, "gpt2")})]


def phase_gang_two_ranks(torch, gang):
    """17c: two ranks on the one card over gloo (`initialize_from_env(
    backend="gloo")`; each rank's "host" a loopback address of the same
    machine, so each is local rank 0 on cuda:0; `gang`: phase_gangs'
    "data" entry, the two-rank gang's first runs) against world-1 runs of
    the same global batches in this process."""
    from kubeflow_tpu_torch.checkpointing import layout
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    root, plan, (reps, gpt_reps) = gang
    ckpt = plan[0][0]["checkpoint"]["directory"]
    gang_losses = [loss for _, loss in reps[0]["result"]["losses"]]
    ranks = [torch.load(os.path.join(root, f"resnet2.{r}.pt")) for r in (0, 1)]
    bufs = ranks[0]["buffers"]
    # world 1, the same global batch of 128, in this process
    cfg1 = TrainingConfig(**dict(GANG2_RESNET_CFG,
                                 checkpoint={"enabled": False}))
    tr1 = Trainer(cfg1, device="cuda")
    init = model_arrays(tr1.init_state().model)["params"]
    one = run_training(cfg1, device="cuda", trainer=tr1,
                       log_every=cfg1.steps)
    one_losses = [loss for _, loss in one["losses"]]
    one_arrays = model_arrays(tr1._final_state.model)
    one_bufs = one_arrays["buffers"]
    del tr1
    torch.cuda.empty_cache()
    # world 1 restores the gang's step-2 checkpoint (rank 0 wrote it)
    only2 = os.path.join(root, "gang-ckpt-2")
    shutil.copytree(ckpt, only2)
    for s in layout.committed_steps(only2):
        if s != GANG2_SAVE:
            shutil.rmtree(layout.step_dir(only2, s))
    manifest = layout.read_manifest(layout.step_dir(only2, GANG2_SAVE))
    cfg_r = TrainingConfig(**dict(GANG2_RESNET_CFG, checkpoint={
        "directory": only2, "async_save": False}))
    resumed = run_training(cfg_r, restore=True, device="cuda",
                           log_every=cfg_r.steps)
    torch.cuda.empty_cache()
    same_ranks = ranks_equal(torch, ranks)
    bn_gap = max(float((bufs[n] - one_bufs[n]).abs().max()
                       / one_bufs[n].abs().max().clamp_min(1e-12))
                 for n in one_bufs)
    step_gap, leaf_gap, step_leaf = update_gap(
        ranks[0]["params"], one_arrays["params"], init)
    loss_gap = max(_rel(a, b) for a, b in zip(gang_losses, one_losses))
    resume_gap = _rel(resumed["losses"][0][1], gang_losses[-1])
    print(f"gang 17c ({smi_line()}): resnet50 bf16 global batch "
          f"{GANG2_RESNET_CFG['global_batch_size']} on 2 ranks of one card "
          f"over {reps[0]['backend']} ({reps[0]['device']}, "
          f"{reps[1]['device']}): losses {gang_losses} against world 1's "
          f"{one_losses} (worst rel {loss_gap:.3e}, bound {GANG_LOSS_REL:g}); "
          f"weights and BatchNorm running averages equal across the ranks: "
          f"{same_ranks}; final weights' gap to world 1's over world 1's "
          f"update {step_gap:.3e} over every leaf (bound {GANG_STEP_REL:g}), "
          f"{leaf_gap:.3e} at the worst leaf ({step_leaf}; bound "
          f"{GANG_LEAF_STEP_REL:g}); running averages' worst gap to world 1 "
          f"{bn_gap:.3e} of a leaf's largest (bound {GANG_BN_REL:g}); checkpoint of step {GANG2_SAVE}: process_count "
          f"{manifest['process_count']}, resumed at world 1 to step-3 loss "
          f"{resumed['losses'][0][1]} against the gang's {gang_losses[-1]} "
          f"(rel {resume_gap:.3e}); gradient all-reduces "
          f"{[rep['result']['grad_allreduces'] for rep in reps]}", flush=True)
    if [rep["backend"] for rep in reps] != ["gloo", "gloo"]:
        raise AssertionError(f"17c: backends {[r['backend'] for r in reps]}")
    if reps[0]["result"]["losses"] != reps[1]["result"]["losses"]:
        raise AssertionError("17c: the ranks' losses differ")
    if len(gang_losses) != GANG2_STEPS or not loss_gap <= GANG_LOSS_REL:
        raise AssertionError(f"17c resnet: losses {gang_losses} vs {one_losses}")
    if not same_ranks or not bn_gap <= GANG_BN_REL:
        raise AssertionError(f"17c: weights and running averages (ranks "
                             f"equal {same_ranks}, gap {bn_gap})")
    if not (step_gap <= GANG_STEP_REL and leaf_gap <= GANG_LEAF_STEP_REL):
        raise AssertionError(f"17c resnet: weights {step_gap} of the update "
                             f"from world 1's, {leaf_gap} at {step_leaf}")
    if manifest["process_count"] != 2 or not resume_gap <= GANG_LOSS_REL:
        raise AssertionError(f"17c: checkpoint resume {resumed['losses']}")

    reps = gpt_reps
    gang_losses = [loss for _, loss in reps[0]["result"]["losses"]]
    ranks = [torch.load(os.path.join(root, f"gpt2.{r}.pt")) for r in (0, 1)]
    cfg1 = TrainingConfig(**GANG2_GPT_CFG)
    tr1 = Trainer(cfg1, device="cuda")
    init = model_arrays(tr1.init_state().model)["params"]
    one = run_training(cfg1, device="cuda", trainer=tr1,
                       log_every=cfg1.steps)
    one_params = model_arrays(tr1._final_state.model)["params"]
    del tr1
    torch.cuda.empty_cache()
    one_losses = [loss for _, loss in one["losses"]]
    loss_gap = max(_rel(a, b) for a, b in zip(gang_losses, one_losses))
    same_ranks = ranks_equal(torch, ranks)
    # the attention key bias's true gradient is 0 (softmax ignores a
    # shift shared by a query's keys): AdamW steps it on summation noise
    step_gap, leaf_gap, step_leaf = update_gap(
        ranks[0]["params"], one_params, init, skip=("attention.key.bias",))
    del ranks, init, one_params
    print(f"gang 17c: gpt_small bf16 seq {GANG2_GPT_CFG['seq_len']} global "
          f"batch {GANG2_GPT_CFG['global_batch_size']} on 2 ranks over gloo: "
          f"losses {gang_losses} against world 1's {one_losses} (worst rel "
          f"{loss_gap:.3e}, bound {GANG_LOSS_REL:g}); weights equal across "
          f"the ranks: {same_ranks}; final weights' gap to world 1's over "
          f"world 1's update {step_gap:.3e} over every leaf (bound "
          f"{GANG_STEP_REL:g}), {leaf_gap:.3e} at the worst leaf "
          f"({step_leaf}; bound {GANG_LEAF_STEP_REL:g}); flash launches a rank "
          f"{[rep['launches'] for rep in reps]}", flush=True)
    if reps[0]["result"]["losses"] != reps[1]["result"]["losses"]:
        raise AssertionError("17c gpt: the ranks' losses differ")
    if not (same_ranks and step_gap <= GANG_STEP_REL
            and leaf_gap <= GANG_LEAF_STEP_REL):
        raise AssertionError(f"17c gpt: weights (ranks equal {same_ranks}, "
                             f"{step_gap} of the update from world 1's, "
                             f"{leaf_gap} at {step_leaf})")
    if len(gang_losses) != GANG2_STEPS or not loss_gap <= GANG_LOSS_REL:
        raise AssertionError(f"17c gpt: losses {gang_losses} vs {one_losses}")


def phase_prefetch(torch, root):
    """17d: phase 15b's npz blobs host-fed at prefetch depth 0 (read in
    the loop) and 2 (the DevicePrefetcher's thread and side stream),
    deterministic cuDNN: every step's loss and the final weights bit for
    bit; the train.host_wait share of each run's wall time printed."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer
    from kubeflow_tpu_torch.utils.metrics import host_wait_histogram

    data_dir = os.path.join(root, "blobs")
    os.makedirs(data_dir)
    write_blob_shards(data_dir)
    hist = host_wait_histogram()
    runs = {}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for depth in (0, PREFETCH_DEPTH, 0, PREFETCH_DEPTH):
            cfg = TrainingConfig(**dict(PREFETCH_CFG, data={
                "name": "npz", "path": data_dir, "prefetch_depth": depth}))
            trainer = Trainer(cfg, device="cuda")
            before = hist.sum(model=cfg.model)
            t0 = time.monotonic()
            result = run_training(cfg, device="cuda", trainer=trainer,
                                  log_every=cfg.steps)
            wall = time.monotonic() - t0
            waited = hist.sum(model=cfg.model) - before
            params = {n: p.detach().clone() for n, p in
                      trainer._final_state.model.named_parameters()}
            runs.setdefault(depth, []).append(
                (result["losses"], params, waited / wall,
                 result["items_per_sec"], trainer.input_path))
            del trainer
    finally:
        torch.backends.cudnn.deterministic = False
    (l0, p0, _, _, path0), (l2, p2, _, _, path2) = runs[0][0], runs[
        PREFETCH_DEPTH][0]
    same = l0 == l2 and all(torch.equal(p0[n], p2[n]) for n in p0)
    shares = {d: [r[2] for r in rs] for d, rs in runs.items()}
    speeds = {d: [r[3] for r in rs] for d, rs in runs.items()}
    print(f"prefetch 17d ({smi_line()}): resnet50 bf16 on npz blobs of "
          f"{BLOBS_SIZE} px, batch {PREFETCH_CFG['global_batch_size']}, "
          f"{PREFETCH_CFG['steps']} steps, host-fed ({path0}, {path2}): depth "
          f"0 and depth {PREFETCH_DEPTH} bit for bit: {same}; train.host_wait "
          f"share of the run's wall time, runs in order 0, {PREFETCH_DEPTH}, "
          f"0, {PREFETCH_DEPTH}: depth 0 {shares[0]}, depth {PREFETCH_DEPTH} "
          f"{shares[PREFETCH_DEPTH]}; images/sec/card depth 0 {speeds[0]}, "
          f"depth {PREFETCH_DEPTH} {speeds[PREFETCH_DEPTH]}", flush=True)
    if not same or path0 != "host" or path2 != "host":
        raise AssertionError(f"17d: depth 0 and {PREFETCH_DEPTH} differ "
                             f"(losses {l0} vs {l2})")


def phase_gang(torch, image_ref, lm_ref, layers):
    """Phase 17: 17a and 17b (the launcher at world 1 over NCCL), 17d (the
    DevicePrefetcher) → 17b's flash launches. 17c (two ranks on one card
    over gloo) runs in phase_gangs' two-rank gang, its gates in
    `phase_gang_two_ranks`."""
    t17 = time.monotonic()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="kft-gang-") as root:
        launches = phase_gang_world1(torch, root, image_ref, lm_ref, layers)
        phase_prefetch(torch, root)
    print(f"phase 17: {time.monotonic() - t17:.3f} s", flush=True)
    return launches


# -- phase 18: MoE (gpt_small_moe serving and training, bert_base_moe) -------


@contextlib.contextmanager
def route_patch(fn):
    """Inside, every MoeMlp routes through `fn` (it takes
    `parallel/moe.py topk_route`'s arguments): the engine's thread too."""
    from kubeflow_tpu_torch.models import layers

    orig = layers.topk_route
    layers.topk_route = fn
    try:
        yield
    finally:
        layers.topk_route = orig


def recording_route(torch, log):
    """`topk_route` that appends each call's choices [B, S, k] to `log`:
    the same softmax, choices and assignment, so the same bits."""
    from kubeflow_tpu_torch.parallel import moe

    def route(logits, capacity, k=1):
        probs = torch.softmax(logits.float(), dim=-1)
        _, top_i = moe.top_k_choices(probs, k)
        log.append(top_i)
        return moe.assign(probs, top_i, capacity)

    return route


def forced_route(torch, calls):
    """`topk_route` that takes each call's choices from `calls` (recorded
    by `recording_route`, in call order) instead of its own top-k: the
    gates and capacity are this call's. A recorded call over more rows
    (the engine's 8-slot decode step) gives its first rows (slot 0)."""
    from kubeflow_tpu_torch.parallel import moe

    it = iter(calls)

    def route(logits, capacity, k=1):
        probs = torch.softmax(logits.float(), dim=-1)
        top_i = next(it)[: logits.shape[0]].to(logits.device)
        if tuple(top_i.shape) != tuple(probs.shape[:2]) + (k,):
            raise AssertionError(f"a forced route of shape {tuple(top_i.shape)} "
                                 f"for logits {tuple(logits.shape)}")
        return moe.assign(probs, top_i, capacity)

    return route


def record_then_force(torch, n, log):
    """`topk_route` whose first `n` calls record into `log` and whose next
    `n` replay those choices: two forwards over the same input (a
    reference and a perturbed model) routed alike."""
    record, force = recording_route(torch, log), forced_route(torch, log)
    calls = [0]

    def route(logits, capacity, k=1):
        calls[0] += 1
        return (record if calls[0] <= n else force)(logits, capacity, k)

    return route


def moe_replay_gaps(torch, f32_model, prompt, tokens, routes, buckets,
                    chunk):
    """Each emitted token's gap below its position's max f32 logit, from
    a replay of one engine request in the engine's geometry (its prefill
    bucket, or the largest bucket's head prefill and the chunk windows;
    then one-token decode steps fed the emitted tokens), every MoE layer
    routed as the engine routed it (`routes`, recorded in call order)."""
    from kubeflow_tpu_torch.serving.engine import bucket_for

    dev, p, largest = f32_model.device, len(prompt), buckets[-1]
    rows = []
    with route_patch(forced_route(torch, routes)), torch.inference_mode():
        if p <= largest:
            ids = torch.zeros((1, bucket_for(p, buckets)), dtype=torch.long)
            ids[0, :p] = torch.tensor(prompt)
            mask = torch.zeros(ids.shape, dtype=torch.bool)
            mask[0, :p] = True
            logits, cache = f32_model.prefill(ids.to(dev), mask.to(dev))
            rows.append(logits[0, p - 1])
        else:
            ids = torch.tensor([prompt[:largest]], device=dev)
            _, cache = f32_model.prefill(ids, torch.ones_like(ids,
                                                              dtype=torch.bool))
            pos = largest
            while pos < p:
                nreal = min(chunk, p - pos)
                window = torch.zeros((1, chunk), dtype=torch.long)
                window[0, :nreal] = torch.tensor(prompt[pos:pos + nreal])
                logits = f32_model.decode(window.to(dev), cache)
                if pos + nreal >= p:
                    rows.append(logits[0, p - 1 - pos])
                pos += chunk
            # the engine's cursor: the window's pad tail stays invisible
            # and is overwritten by the decode steps
            cache.index = p
            cache.position = torch.full_like(cache.position, p)
        for t in tokens[:-1]:
            rows.append(f32_model.decode(
                torch.tensor([[t]], device=dev), cache)[0, 0])
    return logit_gaps(torch, torch.stack(rows), tokens)


def moe_weights(torch, model, dtype, state, device):
    """`model` built in `dtype` on `device` with the weights `state`."""
    from kubeflow_tpu_torch.models.registry import get_model

    m = get_model(model, device="meta", dtype=dtype).to_empty(device=device)
    m.load_state_dict(state)
    return m


def phase_moe_serve_f32(torch, f32_model, model=MOE_MODEL, device="cuda",
                        prompts=MOE_PROMPTS, max_new=MOE_NEW, buckets=BUCKETS):
    """18a: `model` f32 behind the REST server (8 slots, page 16, phase
    5's buckets), two greedy requests (the second past the largest
    bucket: a head prefill and chunk windows), once through the paged
    kernels and once through gather: the tokens must be equal. → the
    kernel run's launches."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    params = f32_model.state_dict()
    rng = np.random.default_rng(18)
    rows = [rng.integers(0, f32_model.cfg.vocab_size, n).tolist()
            for n in prompts]
    tokens, launches = {}, {}
    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = buckets
    try:
        for impl in ("kernel", "gather"):
            ms, httpd = serve(model, torch.float32, device,
                              paged_attention=impl, num_slots=8,
                              page_size=16, params=params)
            try:
                pa.reset_launch_counts()
                tokens[impl] = []
                for prompt in rows:
                    status, out = post(httpd.port, model, {
                        "prompt_ids": [prompt], "max_new_tokens": max_new})
                    if status != 200:
                        raise AssertionError(f"18a {impl}: {status} {out}")
                    tokens[impl].append(out["sequences"][0][len(prompt):])
                launches[impl] = dict(pa.launch_counts)
                moe = ms.engine(model).stats()["moe"]
            finally:
                httpd.stop()
                ms.close()
            print(f"moe 18a f32 {impl}: tokens {tokens[impl]}; launches "
                  f"{launches[impl]}; router {json.dumps(moe)}", flush=True)
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)
    if tokens["kernel"] != tokens["gather"]:
        raise AssertionError(f"18a: kernel tokens {tokens['kernel']} differ "
                             f"from gather's {tokens['gather']}")
    if device == "cuda" and (min(launches["kernel"]["paged_decode"],
                                 launches["kernel"]["paged_window"]) < 1
                             or any(launches["gather"].values())):
        raise AssertionError(f"18a: launches {launches}")
    print("moe 18a: f32 kernel tokens equal gather tokens", flush=True)
    return launches["kernel"]


def moe_decode_profile(torch, eng, vocab, layers, prompt=MOE_PROFILE_PROMPT,
                       max_new=MOE_PROFILE_NEW, window_s=MOE_PROFILE_S):
    """Every slot of `eng` decoding: (unprofiled ms a decode step, device
    busy ms a step, the copy/cast kernels' ms a step, the top kernels),
    as scripts/torch_decode_profile.py reads them."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(181)
    admitted = eng.stats()["admitted"]
    futures = [eng.submit(rng.integers(0, vocab, prompt), max_new)
               for _ in range(eng.num_slots)]
    while eng.stats()["admitted"] < admitted + eng.num_slots:
        time.sleep(0.01)
    time.sleep(0.2)
    s0 = eng.stats()
    time.sleep(window_s)
    s1 = eng.stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(window_s)
        torch.cuda.synchronize()
    for f in futures:
        f.wait(600)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    steps = max(sum(e.count for e in events if "paged_decode_kernel" in e.key)
                / layers, 1)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / steps
    casts = sum(e.self_device_time_total for e in events
                if "copy" in e.key) / 1e3 / steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return step_ms_between(s0, s1), busy, casts, steps, top


def phase_moe_serve_bf16(torch, f32_model, dense_stats, model=MOE_MODEL,
                         device="cuda", short=(5, 17, 33, 64, 120),
                         long_len=LONG_LEN, hit_len=HIT_LEN, max_new=32,
                         buckets=BUCKETS):
    """18b, the MoE main path: `model` in bf16 behind the REST server on
    phase 5's geometry and traffic. Gates: every reply 200; every
    request that took no prefix hit is served again alone by a fresh
    engine of the same geometry, its routes recorded, with the same
    tokens, and replayed in f32 with those tokens and routes: each
    emitted token's f32 logit within DELTA of its position's max; no
    drop at a decode step; routed + dropped positions = positions fed ×
    layers × k; both paged kernels launched. → (launches, summary)."""
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    cuda = device == "cuda"
    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = buckets
    ms, httpd = serve(model, torch.bfloat16, device, num_slots=8,
                      page_size=16, params=f32_model.state_dict())
    try:
        eng = ms.engine(model)
        cfg = eng.model.cfg
        layers, k, vocab = cfg.num_layers, cfg.moe_top_k, cfg.vocab_size
        prompts, warm = serve_traffic(vocab, (*short, long_len, hit_len),
                                      eng.prefill_buckets[-1])
        results = [None] * len(prompts)

        def run(i):
            results[i] = post(httpd.port, model, {"prompt_ids": [prompts[i]],
                                                  "max_new_tokens": max_new})

        if post(httpd.port, model, {"prompt_ids": [warm],
                                    "max_new_tokens": 2})[0] != 200:
            raise AssertionError("18b warm-up failed")
        # the positions fed to the router, and each decode step's drops
        progs = eng.programs
        orig = (progs.prefill, progs.chunk, progs.step)
        fed, decode_dropped = [0], []

        def prefill(ids, *a):
            fed[0] += ids.numel()
            return orig[0](ids, *a)

        def chunk(pool, ids, *a):
            fed[0] += ids.numel()
            return orig[1](pool, ids, *a)

        def step(pool, tokens, *a):
            fed[0] += tokens.numel()
            out = orig[2](pool, tokens, *a)
            decode_dropped.append(out[1][1])
            return out

        progs.prefill, progs.chunk, progs.step = prefill, chunk, step
        before = eng.stats()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # the main path's run: every launch count starts at 0 here
        pa.reset_launch_counts()
        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        prompts.append(prompts[-1])  # the prefix hit with copy-on-write
        results.append(post(httpd.port, model, {
            "prompt_ids": [prompts[-1]], "max_new_tokens": max_new}))
        launches = dict(pa.launch_counts)
        stats = eng.stats()
        progs.prefill, progs.chunk, progs.step = orig
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        replies = []
        for prompt, res in zip(prompts, results):
            if res is None or res[0] != 200:
                raise AssertionError(f"18b :generate failed: {res}")
            replies.append(res[1]["sequences"][0][len(prompt):])
        routed = (stats["moe"]["routed_positions"]
                  - before["moe"]["routed_positions"])
        dropped = stats["moe"]["dropped"] - before["moe"]["dropped"]
        dec_drop = float(torch.stack(decode_dropped).sum()) if decode_dropped else 0.0
        steps = stats["decode_steps"] - before["decode_steps"]
        step_ms = step_ms_between(before, stats)
        gen = max_new * (len(prompts) - 1)
        print(f"moe 18b ({smi_line() if cuda else device}): "
              f"{len(results)} requests answered 200; {gen} tokens in "
              f"{wall:.3f} s = {gen / wall:.1f} tokens/s; decode_step_ms "
              f"{step_ms:.3f} over {steps} steps (phase 5, dense, this call: "
              f"{dense_stats['load_decode_step_ms']:.3f} ms, "
              f"{dense_stats['load_tokens_per_s']:.1f} tokens/s); "
              f"max_memory_allocated {peak} B", flush=True)
        print(f"moe 18b: router positions fed {fed[0]} x {layers} layers x "
              f"k {k} = {fed[0] * layers * k}; routed {routed:g} + dropped "
              f"{dropped:g} (at decode steps {dec_drop:g}); launches "
              f"{launches}", flush=True)
        print(f"moe 18b: hit request ({stats['prefix_hit_tokens']} hit "
              f"tokens, {stats['cow_copies']} COW) tokens {replies[-1]}",
              flush=True)

        # every request but the hit, alone on a fresh engine of the same
        # geometry (a row's bits do not depend on the other slots), its
        # routes recorded; then the f32 replay with its tokens and routes
        solo = DecodeEngine("moe-solo", eng.model, device=device,
                            num_slots=8, page_size=16,
                            num_pages=stats["pages_total"],
                            prefill_buckets=eng.prefill_buckets,
                            prefix_cache=False, paged_attention="kernel")
        forced, free = [], []
        largest = eng.prefill_buckets[-1]
        chunk_len = eng.programs.chunk_len
        try:
            for prompt, tokens in zip(prompts[:-1], replies[:-1]):
                log = []
                with route_patch(recording_route(torch, log)):
                    again = solo.generate_row(prompt, max_new)["tokens"]
                if again != tokens:
                    raise AssertionError(
                        f"18b: a {len(prompt)}-token request served alone "
                        f"gave {again}, in the traffic {tokens}")
                windows = (0 if len(prompt) <= largest
                           else -(-(len(prompt) - largest) // chunk_len))
                if len(log) != layers * (1 + windows + max_new - 1):
                    raise AssertionError(f"18b: {len(log)} routing calls")
                forced.append(moe_replay_gaps(
                    torch, f32_model, prompt, tokens, log,
                    eng.prefill_buckets, chunk_len).max().item())
                free.append(rescore_gaps(torch, f32_model, prompt, tokens))
        finally:
            solo.close()
        free = torch.cat(free)
        worst = max(forced)
        print(f"moe 18b: worst f32 logit gap of an emitted token, replayed "
              f"with the engine's tokens and routes, by request {forced} "
              f"(delta {DELTA}); rescored as phase 5 (a full-sequence "
              f"forward routing in f32 on its own): worst "
              f"{free.max().item():.4f}, {int((free > DELTA).sum())} of "
              f"{free.numel()} tokens over delta", flush=True)
        status, body = get(httpd.port, "/statusz")
        moe_line = [ln.strip() for ln in body.decode().splitlines()
                    if ln.strip().startswith("moe:")]
        print(f"moe 18b: /statusz {moe_line}", flush=True)
        summary = {"decode_step_ms": step_ms, "tokens_per_s": gen / wall,
                   "peak_bytes": peak, "tokens": replies,
                   "launches": dict(launches),
                   "kv_pool_bytes": stats["kv_pool_bytes"]}
        if cuda:
            prof_ms, busy, casts, psteps, top = moe_decode_profile(
                torch, eng, vocab, layers)
            print(f"moe 18b decode profile: {prof_ms:.3f} ms a step (8 "
                  f"slots, unprofiled); device busy {busy:.3f} ms a step "
                  f"over {psteps:.1f} traced steps = "
                  f"{100 * busy / prof_ms:.1f} % (idle "
                  f"{100 - 100 * busy / prof_ms:.1f} %); copy/cast kernels "
                  f"{casts:.3f} ms a step = {100 * casts / busy:.1f} % of "
                  f"busy", flush=True)
            for e in top:
                print(f"  {e.self_device_time_total / 1e3 / psteps:8.4f} ms "
                      f"a step {e.count / psteps:6.1f}x  {e.key[:90]}",
                      flush=True)
            summary.update(profile_step_ms=prof_ms, busy_ms=busy,
                           cast_ms=casts)
        if stats["cow_copies"] < 1 or stats["prefix_hit_tokens"] < 1:
            raise AssertionError("18b: the repeat did not hit the prefix cache")
        if not worst <= DELTA:
            raise AssertionError(f"18b: an emitted token is {worst} below its "
                                 f"position's max f32 logit (> {DELTA})")
        if dec_drop != 0.0:
            raise AssertionError(f"18b: {dec_drop} choices dropped at decode")
        if routed + dropped != fed[0] * layers * k:
            raise AssertionError(f"18b: routed {routed} + dropped {dropped} "
                                 f"!= {fed[0]} x {layers} x {k}")
        if cuda and min(launches["paged_decode"], launches["paged_window"]) < 1:
            raise AssertionError(f"18b: launches {launches}")
        return launches, summary
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)
        httpd.stop()
        ms.close()


def phase_moe_serve_int8(torch, f32_model, model=MOE_MODEL, device="cuda",
                         prompts=MOE_PROMPTS, max_new=MOE_NEW,
                         buckets=BUCKETS, accuracy_shape=(4, 256)):
    """18c: `model` served int8 (int8 weights, the [E, ...] stacks
    included, dequantized at use; int8 KV pages) in bf16: two greedy
    requests answer 200 through the kernels' int8 variants alone. Then
    phase 10's accuracy gate on the int8 envelope, bf16 and f32, with
    both forwards routed alike (the full-width run's choices replayed in
    the int8 run): a flipped route moves a token's output by a whole
    expert, which says nothing of the quantization. The same gate with
    each forward routing on its own is printed, with the share of
    (token, layer) routes the int8 weights flip. → the launches."""
    from kubeflow_tpu_torch.checkpointing.quantize import (
        quantization_accuracy,
        quantize_params_int8,
    )
    from kubeflow_tpu_torch.ops import paged_attention as pa

    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = buckets
    state = f32_model.state_dict()
    try:
        ms, httpd = serve(model, torch.bfloat16, device, num_slots=8,
                          page_size=16, quantize="int8", params=state)
        try:
            rng = np.random.default_rng(18)
            pa.reset_launch_counts()
            for n in prompts:
                prompt = rng.integers(0, f32_model.cfg.vocab_size, n).tolist()
                status, out = post(httpd.port, model, {
                    "prompt_ids": [prompt], "max_new_tokens": max_new})
                if status != 200:
                    raise AssertionError(f"18c: {status} {out}")
            launches = dict(pa.launch_counts)
            stats = ms.engine(model).stats()
        finally:
            httpd.stop()
            ms.close()
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)
    print(f"moe 18c int8: {len(prompts)} requests answered 200; kv pool "
          f"{stats['kv_pool_dtype']} x {stats['pages_total']} pages; "
          f"launches {launches}; router {json.dumps(stats['moe'])}",
          flush=True)
    if device == "cuda" and (launches["paged_decode"] or launches["paged_window"]
                             or min(launches["paged_decode_int8"],
                                    launches["paged_window_int8"]) < 1):
        raise AssertionError(f"18c: launches {launches}")
    cfg = f32_model.cfg
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, accuracy_shape)).to(device)
    for dtype in (torch.bfloat16, torch.float32):
        full = (f32_model if dtype == torch.float32
                else moe_weights(torch, model, dtype, state, device))
        params = full.state_dict()
        qparams = quantize_params_int8(params)
        log = []
        with route_patch(record_then_force(torch, cfg.num_layers, log)):
            routed = quantization_accuracy(full, params, qparams, ids)
        free_log = []
        with route_patch(recording_route(torch, free_log)):
            free = quantization_accuracy(full, params, qparams, ids)
        n = cfg.num_layers
        flips = sum(int((a != b).sum()) for a, b in zip(free_log[:n],
                                                        free_log[n:]))
        total = sum(a.numel() for a in free_log[:n])
        print(f"moe 18c int8 accuracy {str(dtype)[6:]} over "
              f"{list(accuracy_shape)} held-out tokens, routed alike: "
              f"{json.dumps(routed)} (limits {json.dumps(ACCURACY)}); each "
              f"forward routing on its own: {json.dumps(free)}, "
              f"{flips} of {total} (token, layer) routes flipped", flush=True)
        if not all(routed[key] <= ACCURACY[key] for key in ACCURACY):
            raise AssertionError(f"18c: int8 accuracy {routed} above {ACCURACY}")
        if not free["loss_delta"] <= ACCURACY["loss_delta"]:
            raise AssertionError(f"18c: int8 loss delta {free} above "
                                 f"{ACCURACY['loss_delta']}")
        del full, params, qparams
    return launches


def moe_einsum_ms(torch, b, s, e, c, d, dtype, device):
    """(forward ms, forward + backward ms) of one MoE layer's dispatch
    (`bsec,bsd->ebcd`) and combine (`bsec,ebcd->bsd`) einsums at these
    shapes, medians over CUDA events."""
    g = torch.Generator(device=device).manual_seed(0)
    dispatch = (torch.rand((b, s, e, c), generator=g, device=device)
                < 1.0 / e).to(dtype)
    combine = (dispatch * 0.5).requires_grad_()
    x = torch.randn((b, s, d), generator=g, device=device,
                    dtype=dtype).requires_grad_()
    out_e = torch.randn((e, b, c, d), generator=g, device=device,
                        dtype=dtype).requires_grad_()
    gx = torch.randn((e, b, c, d), generator=g, device=device, dtype=dtype)
    gy = torch.randn((b, s, d), generator=g, device=device, dtype=dtype)

    def fwd():
        return (torch.einsum("bsec,bsd->ebcd", dispatch, x),
                torch.einsum("bsec,ebcd->bsd", combine, out_e))

    def both():
        torch.autograd.backward(fwd(), (gx, gy))

    def timed(fn):
        times = []
        for i in range(8):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    with torch.no_grad():
        f = timed(fwd)
    return f, timed(both)


def phase_moe_train_bf16(torch, overrides=None, device="cuda"):
    """18e, the MoE training main path: `run_training` of MOE_TRAIN_CFG
    (one card's share of configs/gpt_moe_v5e16.yaml) through the flash
    kernels. Gates: every loss finite, the flash launches equal the
    config's formula. Prints tokens/sec/card, step ms, MFU, device busy,
    the dispatch/combine einsums' share of it and peak memory. → the
    launches."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel.moe import expert_capacity
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig(**{**MOE_TRAIN_CFG, **(overrides or {})})
    trainer = Trainer(cfg, device=device)
    mcfg = trainer.model.cfg
    layers = mcfg.num_layers
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the main path's run: every launch count starts at 0 here
    fa.reset_launch_counts()
    result = run_training(cfg, device=device, log_every=cfg.steps,
                          trainer=trainer)
    launches = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = result["losses"]
    a, r = cfg.accum_steps, 2 if cfg.remat else 1
    want = {"flash_fwd": cfg.steps * layers * a * r,
            "flash_bwd_dq": cfg.steps * layers * a,
            "flash_bwd_dkv": cfg.steps * layers * a}
    step_ms = result["step_time_s"] * 1e3
    print(f"moe 18e ({smi_line() if cuda else device}): {cfg.model} "
          f"{cfg.dtype} seq {cfg.seq_len} batch {cfg.global_batch_size}, "
          f"{cfg.steps} steps; {result['items_per_sec']:.1f} tokens/sec/card; "
          f"steady step {step_ms:.3f} ms; mfu {result.get('mfu')}; "
          f"max_memory_allocated {peak} B; losses {losses}; launches "
          f"{launches} (formula {want})", flush=True)
    if cuda:
        busy, top = device_busy_ms(torch, trainer, trainer._final_state,
                                   MOE_PROFILED)
        b = cfg.global_batch_size // a
        c = expert_capacity(cfg.seq_len * mcfg.moe_top_k, mcfg.num_experts,
                            mcfg.expert_capacity_factor)
        fwd, both = moe_einsum_ms(torch, b, cfg.seq_len, mcfg.num_experts, c,
                                  mcfg.hidden_size, torch.bfloat16, device)
        # under remat each layer's forward runs twice, its backward once
        einsums = layers * a * (both + (fwd if cfg.remat else 0.0))
        print(f"moe 18e: device busy {busy:.3f} ms a step = "
              f"{100 * busy / step_ms:.1f} % of the steady step (idle "
              f"{100 - 100 * busy / step_ms:.1f} %); the dispatch and "
              f"combine einsums, timed alone at the step's shapes (B={b} "
              f"S={cfg.seq_len} E={mcfg.num_experts} C={c} D="
              f"{mcfg.hidden_size}: forward {fwd:.3f} ms, forward + backward "
              f"{both:.3f} ms a layer), {einsums:.3f} ms a step = "
              f"{100 * einsums / busy:.1f} % of busy", flush=True)
        for e in top:
            print(f"  {e.self_device_time_total / 1e3 / MOE_PROFILED:9.3f} ms "
                  f"a step {e.count / MOE_PROFILED:7.1f}x  {e.key[:80]}",
                  flush=True)
    if [st for st, _ in losses] != list(range(1, cfg.steps + 1)):
        raise AssertionError(f"18e: not every step's loss was read: {losses}")
    if not all(np.isfinite(loss) for _, loss in losses):
        raise AssertionError(f"18e: a non-finite loss: {losses}")
    if cuda and launches != want:
        raise AssertionError(f"18e: launches {launches} != {want}")
    del trainer
    return launches


def phase_moe(torch, dense_stats, device="cuda"):
    """Phase 18: 18a-18c serve gpt_small_moe (f32 on both read paths,
    bf16 on phase 5's traffic, int8), 18d trains it in f32 flash against
    dense, 18e in bf16 at one card's share of configs/gpt_moe_v5e16.yaml,
    18f trains bert_base_moe. → (each kernel row's launches on its MoE
    path (18b, 18c, 18e), 18f's BERT launches, 18b's summary: its tokens
    and paged launches are phase 24d's reference)."""
    from kubeflow_tpu_torch.models.registry import get_model

    t18 = time.monotonic()
    f32_model = get_model(MOE_MODEL, device=device, dtype=torch.float32,
                          seed=MOE_SEED)
    phase_moe_serve_f32(torch, f32_model, device=device)
    launches, served = phase_moe_serve_bf16(torch, f32_model, dense_stats,
                                            device=device)
    launches.update({name: n for name, n in phase_moe_serve_int8(
        torch, f32_model, device=device).items() if name.endswith("_int8")})
    del f32_model
    torch.cuda.empty_cache()
    auxes = phase_train_f32(torch, model=MOE_MODEL, device=device,
                            leaves=MOE_TRAIN_LEAVES, tag="moe 18d f32")
    print(f"moe 18d: moe_aux_loss {json.dumps({k: v.get('moe_aux_loss') for k, v in auxes.items()})}",
          flush=True)
    if not all(np.isfinite(v.get("moe_aux_loss", float("nan")))
               for v in auxes.values()):
        raise AssertionError(f"18d: moe_aux_loss {auxes}")
    torch.cuda.empty_cache()
    launches.update(phase_moe_train_bf16(torch, device=device))
    torch.cuda.empty_cache()
    bert = phase_bert_train(torch, overrides=MOE_BERT_CFG, device=device,
                            tag="moe 18f")
    torch.cuda.empty_cache()
    print(f"phase 18: {time.monotonic() - t18:.3f} s", flush=True)
    return launches, bert, served


def _ring_rank(torch, rp, q_blocks, kv_blocks, idx, grad=None):
    """Ring rank `idx`'s block loop (`ring_pass`) on blocks it already
    holds, in the ring's order (no rotation): → its output, and with
    `grad` (the output's cotangent) the gradients of its query block and
    of every K/V block."""
    n = len(kv_blocks)

    def rotate(t, _kv, mask):
        return kv_blocks[(idx - t - 1) % n], mask

    q = q_blocks[idx]
    o = rp.ring_pass(q, kv_blocks[idx], None, idx, n, rotate,
                     dtype=q.dtype, causal=True, impl="flash")
    if grad is None:
        return o
    return o, torch.autograd.grad(o, [q] + list(kv_blocks), grad,
                                  allow_unused=True)


def phase_ring_cost(torch, device="cuda", b=RING_B, s=RING_S, n=RING_N,
                    h=FH, d=FD, dtype=None):
    """19c: ranks 0 and n-1 of an n-rank ring at one rank's geometry,
    beside one causal flash call over all s positions and its balanced
    n-th. → the flash launches of one forward and backward of both
    ranks (the gated pass)."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel import ring_attention as rp

    dtype = torch.bfloat16 if dtype is None else dtype
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cuda = device == "cuda"
    g = torch.Generator().manual_seed(19)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g).to(dtype).to(device)
                   for _ in range(4))
    sb = s // n
    q_blocks = [q[:, i * sb:(i + 1) * sb].contiguous().requires_grad_()
                for i in range(n)]
    kv_blocks = [torch.stack([k[:, i * sb:(i + 1) * sb],
                              v[:, i * sb:(i + 1) * sb]]).requires_grad_()
                 for i in range(n)]
    last = n - 1
    do_last = do[:, last * sb:].contiguous()
    # the gated pass: one forward and backward of ranks 0 and n-1
    fa.reset_launch_counts()
    o0, g0 = _ring_rank(torch, rp, q_blocks, kv_blocks, 0,
                        do[:, :sb].contiguous())
    counted = {"rank0": dict(fa.launch_counts)}
    fa.reset_launch_counts()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    o7, g7 = _ring_rank(torch, rp, q_blocks, kv_blocks, last, do_last)
    counted[f"rank{last}"] = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated() - base if cuda else 0
    launches = {kname: counted["rank0"][kname] + counted[f"rank{last}"][kname]
                for kname in counted["rank0"]}
    # rank i: i + 1 visible blocks, one forward and one of each backward
    # kernel each; invisible blocks launch nothing
    want = {f"rank{i}": {"flash_fwd": i + 1, "flash_bwd_dq": i + 1,
                         "flash_bwd_dkv": i + 1} for i in (0, last)}
    # against the full causal call, its cotangent on rank n-1's rows only
    qf, kf, vf = (t.detach().clone().requires_grad_() for t in (q, k, v))
    full = fa.flash_attention(qf, kf, vf, causal=True)
    cot = torch.zeros_like(do)
    cot[:, last * sb:] = do_last
    dq_full, dk_full, dv_full = torch.autograd.grad(full, [qf, kf, vf], cot)
    errs = {"o": flash_err(torch, o7, full[:, last * sb:], name, "o"),
            "dq": flash_err(torch, g7[0], dq_full[:, last * sb:], name,
                            "grad")}
    dk7 = torch.cat([gk[0] for gk in g7[1:]], 1)
    dv7 = torch.cat([gk[1] for gk in g7[1:]], 1)
    errs["dk"] = flash_err(torch, dk7, dk_full, name, "grad")
    errs["dv"] = flash_err(torch, dv7, dv_full, name, "grad")
    del full, dq_full, dk_full, dv_full, qf, kf, vf, o0, g0
    print(f"seq 19c: ring ranks 0 and {last} of {n} at B={b} S={s} H={h} "
          f"D={d} {name}: launches {counted} (formula {want}); rank {last} "
          f"against one causal flash call over {s} (max_abs_err, worst "
          f"row over its limit, typical |value|): {errs}; rank {last}'s "
          f"forward and backward peak {peak} B above its inputs",
          flush=True)
    if cuda and counted != want:
        raise AssertionError(f"19c launches {counted} != {want}")
    bad = {k_: e for k_, e in errs.items() if not e[1] <= 1.0}
    if bad:
        raise AssertionError(f"19c: rank {last} against the full causal "
                             f"call: {bad}")
    if not cuda:
        return launches
    # the times (CUDA events, medians, L2 flushed before each)
    flush = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    times = {}
    with torch.no_grad():
        for idx in (0, last):
            times[f"rank{idx}_fwd"] = time_ms(
                torch, lambda: _ring_rank(torch, rp, q_blocks, kv_blocks,
                                          idx), flush, iters=20)
        times["full_fwd"] = time_ms(
            torch, lambda: fa.flash_attention(q, k, v, causal=True), flush,
            iters=20)
    for idx in (0, last):
        cot_i = do[:, idx * sb:(idx + 1) * sb].contiguous()
        times[f"rank{idx}_fwd_bwd"] = time_ms(
            torch, lambda: _ring_rank(torch, rp, q_blocks, kv_blocks, idx,
                                      cot_i), flush, iters=20)

    def full_fwd_bwd():
        o = fa.flash_attention(qf2, kf2, vf2, causal=True)
        return torch.autograd.grad(o, [qf2, kf2, vf2], do)

    qf2, kf2, vf2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    times["full_fwd_bwd"] = time_ms(torch, full_fwd_bwd, flush, iters=20)
    # the merges alone, at a block's shapes: rank n-1 merges n blocks
    acc = torch.randn((b, sb, h, d), generator=g).to(device)
    bo = torch.randn((b, sb, h, d), generator=g).to(device)
    lse_a = torch.randn((b, h, sb), generator=g).to(device)
    lse_b = torch.randn((b, h, sb), generator=g).to(device)
    with torch.no_grad():
        times["merge_fwd"] = time_ms(
            torch, lambda: rp.merge(acc, lse_a, bo, lse_b), flush, iters=20)
    acc_g, bo_g, la_g, lb_g = (t.clone().requires_grad_()
                               for t in (acc, bo, lse_a, lse_b))
    cot_m = torch.randn((b, sb, h, d), generator=g).to(device)

    def merge_fwd_bwd():
        o, lse = rp.merge(acc_g, la_g, bo_g, lb_g)
        return torch.autograd.grad((o, lse), [acc_g, la_g, bo_g, lb_g],
                                   (cot_m, torch.ones_like(lse)))

    times["merge_fwd_bwd"] = time_ms(torch, merge_fwd_bwd, flush, iters=20)
    del flush
    torch.cuda.empty_cache()
    share = {kind: times[f"full_{kind}"] / n for kind in ("fwd", "fwd_bwd")}
    ratio = {kind: times[f"rank{last}_{kind}"] / share[kind]
             for kind in ("fwd", "fwd_bwd")}
    merges = {kind: n * times[f"merge_{kind}"] / times[f"rank{last}_{kind}"]
              for kind in ("fwd", "fwd_bwd")}
    print(f"seq 19c ({smi_line()}): ms {json.dumps(times)}; balanced "
          f"share (the full causal call / {n}) {json.dumps(share)}; rank "
          f"{last} over the balanced share {json.dumps(ratio)}; rank {last}'s "
          f"{n} merges' share of its time {json.dumps(merges)}", flush=True)
    return launches


SEQ_IMPLS = (("19a", "ring"), ("19b", "ulysses"))


def sequence_plan(root, overrides=None, ranks=SEQ_RANKS):
    """19a's and 19b's gang runs, (config, run options) each: SEQ_CFG
    with `overrides` on `mesh: {sequence: ranks}`, each rank's final
    weights saved."""
    base = {**SEQ_CFG, **(overrides or {})}
    return [(dict(base, attention_impl=impl, mesh={"sequence": ranks}),
             {"out": os.path.join(root, f"seq_{impl}")})
            for _, impl in SEQ_IMPLS]


def update_gate(gang, one, init, apart=()):
    """`update_gap` of a gang's final weights against world 1's, with
    GPT's attention key bias left out (its true gradient is 0: softmax
    ignores a shift shared by a query's keys, so AdamW steps it on
    summation noise) → (the phase line's text, whether it is within
    GANG_STEP_REL over every leaf and GANG_LEAF_STEP_REL at the worst).
    The leaves whose names end with `apart` (MoE's routers and expert
    stacks) are held by the worst-leaf bound alone, their gap over all
    of them printed: bf16 rounding flips a share of the routes (~4.7 %
    of gpt_small_moe's, phase 18), a flipped token moves its whole
    contribution from one expert to another, and AdamW's first updates
    (about lr · sign(g) an element) turn that into sign flips of the
    stacks' small elements."""
    apart = tuple(apart)
    rest = {n: w for n, w in one.items() if not n.endswith(apart)}
    step_gap, leaf_gap, leaf = update_gap(gang, rest, init,
                                          skip=("attention.key.bias",))
    text = (f"final weights' gap to world 1's over world 1's update "
            f"{step_gap:.3e} over every leaf"
            f"{' but the routers and stacks' if apart else ''} (bound "
            f"{GANG_STEP_REL:g})")
    if apart:
        own_gap, own_leaf_gap, own_leaf = update_gap(
            gang, {n: w for n, w in one.items() if n.endswith(apart)}, init)
        if own_leaf_gap >= leaf_gap:
            leaf_gap, leaf = own_leaf_gap, own_leaf
        text += f", {own_gap:.3e} over the routers and stacks"
    text += (f", {leaf_gap:.3e} at the worst leaf ({leaf}; bound "
             f"{GANG_LEAF_STEP_REL:g})")
    return text, step_gap <= GANG_STEP_REL and leaf_gap <= GANG_LEAF_STEP_REL


def device_params(model):
    """Copies of a model's parameters, on its device."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def world1_run(torch, cfg_dict, device, model_kwargs=None):
    """A world-1 run of a gang's cell in this process → (result, trainer,
    copies of the initial parameters on the device, of the final
    ones)."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig(**cfg_dict)
    tr = Trainer(cfg, device=device, model_kwargs=model_kwargs)
    init = device_params(tr.init_state().model)
    res = run_training(cfg, device=device, trainer=tr, log_every=cfg.steps)
    return res, tr, init, device_params(tr._final_state.model)


def world1_cell(cut):
    """The world-1 cell of a gang's config cut: its mesh one device, no
    checkpoints."""
    return dict(cut, mesh={"data": 1}, checkpoint={"enabled": False})


def phase_sequence(torch, gang, device="cuda", ring_cost=None):
    """Phase 19: 19a the ring and 19b Ulysses over `mesh: {sequence:
    ranks}` as gloo ranks on the one card (`gang`: phase_gangs' "seq"
    entry), against world 1 in this process; 19c one ring rank's cost
    (`ring_cost`: phase_ring_cost's keyword overrides). → each flash
    kernel's launches over 19a-19c."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    t19 = time.monotonic()
    smi = smi_line() if device == "cuda" else "the CPU"
    root, plan, reports = gang
    ranks = plan[0][0]["mesh"]["sequence"]
    # world 1: the function the ring and Ulysses compute, over every
    # position at once
    one, tr1, init, one_params = world1_run(
        torch, dict(plan[0][0], attention_impl="flash", mesh={"data": 1}),
        device)
    cfg1, layers = tr1.cfg, tr1.model.cfg.num_layers
    one_losses = [loss for _, loss in one["losses"]]
    del tr1
    if device == "cuda":
        torch.cuda.empty_cache()
    total = {name: 0 for name in fa.launch_counts}
    steps, r = cfg1.steps, 2 if cfg1.remat else 1
    for (tag, impl), reps in zip(SEQ_IMPLS, reports):
        losses = [loss for _, loss in reps[0]["result"]["losses"]]
        arrays = [torch.load(os.path.join(root, f"seq_{impl}.{i}.pt"),
                             map_location=device) for i in range(ranks)]
        same = ranks_equal(torch, arrays)
        gate, held = update_gate(arrays[0]["params"], one_params, init)
        del arrays
        gap = max(_rel(a, b) for a, b in zip(losses, one_losses))
        launches = [rep["launches"] for rep in reps]
        # ring rank i: i + 1 visible blocks a layer; Ulysses: one
        # full-sequence call a layer on every rank
        blocks = [i + 1 if impl == "ring" else 1 for i in range(ranks)]
        want = [{"flash_fwd": steps * layers * nb * r,
                 "flash_bwd_dq": steps * layers * nb,
                 "flash_bwd_dkv": steps * layers * nb} for nb in blocks]
        step_ms = [rep["result"]["step_time_s"] * 1e3 for rep in reps]
        print(f"seq {tag} ({smi}): {cfg1.model} {cfg1.dtype} seq "
              f"{cfg1.seq_len} global batch {cfg1.global_batch_size} by "
              f"{impl} on {ranks} ranks over {reps[0]['backend']} "
              f"({[rep['device'] for rep in reps]}): losses {losses} "
              f"against world 1's {one_losses} (worst rel {gap:.3e}, "
              f"bound {GANG_LOSS_REL:g}); weights equal across the "
              f"ranks: {same}; {gate}; flash launches a rank {launches} "
              f"(formula {want}); step ms a rank {step_ms} (the ranks "
              f"share the card)", flush=True)
        if any(rep["result"]["losses"] != reps[0]["result"]["losses"]
               for rep in reps):
            raise AssertionError(f"{tag}: the ranks' losses differ")
        if len(losses) != steps or not gap <= GANG_LOSS_REL:
            raise AssertionError(f"{tag}: losses {losses} vs {one_losses}")
        if not same:
            raise AssertionError(f"{tag}: the ranks' weights differ")
        if not held:
            raise AssertionError(f"{tag}: {gate}")
        if device == "cuda" and launches != want:
            raise AssertionError(f"{tag}: launches {launches} != {want}")
        for rep in reps:
            for name, count in rep["launches"].items():
                total[name] += count
    del init, one_params
    for name, count in phase_ring_cost(torch, device=device,
                                       **(ring_cost or {})).items():
        total[name] += count
    print(f"phase 19: {time.monotonic() - t19:.3f} s; flash launches "
          f"{total}", flush=True)
    return total


def one_card_hosts(ranks):
    """Hostnames that make every rank of a gang local rank 0 (so each
    drives cuda:0): one loopback address a rank, the coordinator's
    first."""
    return [f"127.0.0.{i + 1}" for i in range(ranks)]


def moe_config_cut(root, overrides=None):
    """20a's cell: configs/gpt_moe_v5e16.yaml's `training` block, loaded
    as it is (`TrainingConfig.from_dict` must take it unedited), cut to
    one data shard of it (module constants EXPERT_*). → the gang's
    config dict."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.launcher import load_spec

    here = os.path.dirname(os.path.abspath(__file__))
    training = load_spec(os.path.join(here, EXPERT_CONFIG))
    full = TrainingConfig.from_dict(training)
    cut = dict(training, **EXPERT_CUT)
    cut["global_batch_size"] = full.global_batch_size // full.mesh.data
    cut["mesh"] = {"expert": full.mesh.expert}
    cut["checkpoint"] = dict(training["checkpoint"], directory=os.path.join(
        root, "ckpt"), interval_steps=EXPERT_SAVE)
    cut.update(overrides or {})
    return cut


def expert_gang_report(tag, reps, one_losses, steps, smi):
    """The gates every phase-20 gang shares: the ranks' losses bit for bit
    equal and within GANG_LOSS_REL of world 1's, every replicated leaf bit
    for bit equal across the ranks. Prints each rank's step ms (the ranks
    share the card and gloo stages every collective through the host: a
    record, not a speed) and memory. → the losses."""
    losses = [loss for _, loss in reps[0]["result"]["losses"]]
    gap = max(_rel(a, b) for a, b in zip(losses, one_losses))
    same = all(rep["replicated"] == reps[0]["replicated"] for rep in reps)
    step_ms = [rep["result"]["step_time_s"] * 1e3 for rep in reps]
    print(f"expert {tag} ({smi}): losses {losses} against world 1's "
          f"{one_losses} (worst rel {gap:.3e}, bound {GANG_LOSS_REL:g}); "
          f"replicated leaves equal across the ranks: {same}; flash "
          f"launches a rank {[rep['launches'] for rep in reps]}; step ms a "
          f"rank {step_ms} (a record, not a speed: the ranks share the card "
          f"and gloo stages each collective through the host); "
          f"max_memory_allocated a rank "
          f"{[rep['max_memory_allocated'] for rep in reps]} B", flush=True)
    if any(rep["result"]["losses"] != reps[0]["result"]["losses"]
           for rep in reps):
        raise AssertionError(f"{tag}: the ranks' losses differ")
    if len(losses) != steps or not gap <= GANG_LOSS_REL:
        raise AssertionError(f"{tag}: losses {losses} vs {one_losses}")
    if not same:
        raise AssertionError(f"{tag}: the ranks' replicated leaves differ")
    return losses


def expert_plan(root, overrides=None, seq_overrides=None):
    """20a's and 20b's gang runs, (config, run options) each: (20a's,
    20b's; rank 0's final weights saved)."""
    cut = moe_config_cut(root, overrides)
    return ((cut, {"digests": True, "digest_step": EXPERT_SAVE}),
            ({**EXPERT_SEQ_CFG, **(seq_overrides or {})},
             {"digests": True, "out": os.path.join(root, "expert_seq"),
              "out_ranks": [0]}))


def phase_expert(torch, gang, device="cuda"):
    """Phase 20: 20a configs/gpt_moe_v5e16.yaml's expert layout on one
    data shard (`mesh: {expert: ranks}`, gloo ranks on the one card)
    against world 1 in this process; 20b MoE under a sequence axis; 20c
    20a's checkpoint restored at world 1. `gang`: phase_gangs' "expert"
    entry. → each flash kernel's launches over the 20a and 20b gangs."""
    from kubeflow_tpu_torch.checkpointing import layout as ck_layout
    from kubeflow_tpu_torch.checkpointing import restore_latest
    from kubeflow_tpu_torch.ops import flash_attention as fa

    t20 = time.monotonic()
    cuda = device == "cuda"
    smi = smi_line() if cuda else "the CPU"
    total = {name: 0 for name in fa.launch_counts}
    root, plan, (reps, seq_reps) = gang
    cut = plan[0][0]
    ranks = cut["mesh"]["expert"]
    steps, r = cut["steps"], 2 if cut.get("remat") else 1
    res, tr, _, _ = world1_run(torch, world1_cell(cut), device)
    one_losses = [loss for _, loss in res["losses"]]
    one_bytes, layers = state_bytes(tr._final_state), tr.model.cfg.num_layers
    losses = expert_gang_report("20a", reps, one_losses, steps, smi)
    a = cut.get("accum_steps", 1)
    want = {"flash_fwd": steps * layers * a * r,
            "flash_bwd_dq": steps * layers * a,
            "flash_bwd_dkv": steps * layers * a}
    print(f"expert 20a: {cut['model']} {cut['dtype']} seq "
          f"{cut.get('seq_len')} global batch {cut['global_batch_size']} "
          f"on mesh {cut['mesh']}; world 1's state bytes {one_bytes}; a "
          f"rank's {[rep['bytes'] for rep in reps]} (stacks: a quarter "
          f"of world 1's each); flash launches formula a rank {want}",
          flush=True)
    for rep in reps:
        if rep["bytes"]["stacks"] * ranks != one_bytes["stacks"]:
            raise AssertionError(
                f"20a: rank {rep['rank']} holds {rep['bytes']['stacks']} "
                f"B of stacks, not 1/{ranks} of world 1's "
                f"{one_bytes['stacks']}")
        if cuda and rep["launches"] != want:
            raise AssertionError(f"20a: rank {rep['rank']} launches "
                                 f"{rep['launches']} != {want}")
        for name, count in rep["launches"].items():
            total[name] += count
    # 20c: world 1 restores the gang's step-EXPERT_SAVE checkpoint (each
    # stack's blocks written by its rank) into its own trainer (its state
    # is overwritten in place) and resumes from it
    ckpt = cut["checkpoint"]["directory"]
    tr.losses.clear()
    state = restore_latest(ckpt, tr._final_state, step=EXPERT_SAVE)
    by_block = {rep["coords"]["expert"]: rep for rep in reps}
    joined = {}
    for name, p in state.model.named_parameters():
        if is_stack(name):
            n = p.shape[0] // ranks
            joined[name] = all(
                digest(torch, p[x * n:(x + 1) * n])
                == by_block[x]["blocks_at"][name] for x in range(ranks))
    tr.fit(steps=steps - EXPERT_SAVE, state=state, log_every=steps)
    resumed = [loss for _, loss in tr.losses]
    gap_c = max(_rel(x, y) for x, y in zip(resumed, losses[EXPERT_SAVE:]))
    manifest = ck_layout.read_manifest(ck_layout.step_dir(ckpt,
                                                          EXPERT_SAVE))
    shards = {e["key"]: len(e["shards"]) for e in manifest["leaves"]
              if e["key"].endswith(("moe/wi", "moe/wo"))}
    print(f"expert 20c ({smi}): the step-{EXPERT_SAVE} checkpoint of "
          f"{manifest['process_count']} processes, each stack in "
          f"{sorted(set(shards.values()))} block(s) over {len(shards)} "
          f"stack leaves, restored at world 1: stacks equal the ranks' "
          f"blocks joined, bit for bit: {all(joined.values())}; resumed "
          f"to losses {resumed} against the gang's {losses[EXPERT_SAVE:]} "
          f"(worst rel {gap_c:.3e})", flush=True)
    del tr, state
    if cuda:
        torch.cuda.empty_cache()
    if not joined or not all(joined.values()):
        raise AssertionError(f"20c: stacks differ from the blocks: "
                             f"{[k for k, v in joined.items() if not v]}")
    if set(shards.values()) != {ranks}:
        raise AssertionError(f"20c: stacks not written in {ranks} blocks: "
                             f"{shards}")
    if len(resumed) != steps - EXPERT_SAVE or not gap_c <= GANG_LOSS_REL:
        raise AssertionError(f"20c: resumed losses {resumed}")
    # 20b: MoE under a sequence axis (the router logits gathered over the
    # ring, each rank routing whole rows)
    base, opts = plan[1]
    res, tr, init, one_params = world1_run(torch, dict(
        base, attention_impl="flash", mesh={"data": 1}), device)
    one_losses = [loss for _, loss in res["losses"]]
    layers = tr.model.cfg.num_layers
    del tr
    if cuda:
        torch.cuda.empty_cache()
    seq_ranks = base["mesh"]["sequence"]
    steps, r = base["steps"], 2 if base.get("remat") else 1
    expert_gang_report("20b", seq_reps, one_losses, steps, smi)
    gate, held = update_gate(
        torch.load(f"{opts['out']}.0.pt", map_location=device)["params"],
        one_params, init, apart=("moe.router", "moe.wi", "moe.wo"))
    del init, one_params
    want = [{"flash_fwd": steps * layers * (i + 1) * r,
             "flash_bwd_dq": steps * layers * (i + 1),
             "flash_bwd_dkv": steps * layers * (i + 1)}
            for i in range(seq_ranks)]
    got = [rep["launches"] for rep in seq_reps]
    print(f"expert 20b: {base['model']} {base['dtype']} seq "
          f"{base['seq_len']} global batch {base['global_batch_size']} "
          f"by ring on mesh {base['mesh']}; rank 0's {gate}; flash "
          f"launches {got} (formula {want})", flush=True)
    if not held:
        raise AssertionError(f"20b: rank 0's {gate}")
    if cuda and got != want:
        raise AssertionError(f"20b: launches {got} != {want}")
    for rep in seq_reps:
        for name, count in rep["launches"].items():
            total[name] += count
    print(f"phase 20: {time.monotonic() - t20:.3f} s; flash launches "
          f"{total}", flush=True)
    return total


def pipeline_config_cut(root, overrides=None):
    """21a's cell: configs/gpt_pipeline_1f1b_v5e16.yaml's `training`
    block, loaded as it is (`TrainingConfig.from_dict` must take it
    unedited), cut to one data shard of it (PIPELINE_CUT). → the gang's
    config dict."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.launcher import load_spec

    here = os.path.dirname(os.path.abspath(__file__))
    training = load_spec(os.path.join(here, PIPELINE_CONFIG))
    full = TrainingConfig.from_dict(training)
    if (full.mesh.pipeline, full.pipeline_schedule) != (4, "1f1b"):
        raise AssertionError(f"{PIPELINE_CONFIG}: mesh {full.mesh}, "
                             f"schedule {full.pipeline_schedule}")
    cut = dict(training, **PIPELINE_CUT)
    cut["global_batch_size"] = full.global_batch_size // full.mesh.data
    cut["mesh"] = {"pipeline": full.mesh.pipeline}
    cut["checkpoint"] = dict(training["checkpoint"], directory=os.path.join(
        root, "ckpt"), interval_steps=PIPELINE_SAVE)
    cut.update(overrides or {})
    return cut


def stage_param_bytes(mcfg, stage, stages):
    """f32 bytes of a GPT pipeline stage's parameters, from the config's
    widths alone: its L/S layers (q, k, v and out with biases, two
    LayerNorms, the MLP), the two embeddings on stage 0, the final
    LayerNorm and the head on the last."""
    d, f, v = mcfg.hidden_size, mcfg.mlp_dim, mcfg.vocab_size
    n = mcfg.num_layers // stages * (4 * d * d + 2 * d * f + 9 * d + f)
    if stage == 0:
        n += v * d + mcfg.max_len * d
    if stage == stages - 1:
        n += 2 * d + d * v
    return 4 * n


def pipeline_plan(root, overrides=None, model_kwargs=None):
    """21a's and 21b's gang runs, (config, run options) each: 21a, then
    one step at M = PIPELINE_WIDE_M under GPipe and under 1F1B."""
    cut = pipeline_config_cut(root, overrides)
    kw = dict(model_kwargs or {})
    runs = [(cut, {"model_kwargs": kw, "digest_step": PIPELINE_SAVE,
                   "out": os.path.join(root, "final")})]
    for schedule in ("gpipe", "1f1b"):
        runs.append((dict(cut, steps=1, pipeline_schedule=schedule,
                          checkpoint={"enabled": False}),
                     {"model_kwargs": dict(
                         kw, num_microbatches=PIPELINE_WIDE_M)}))
    return runs


def phase_pipeline(torch, gang, device="cuda"):
    """Phase 21: 21a configs/gpt_pipeline_1f1b_v5e16.yaml's pipeline axis on
    one data shard (`mesh: {pipeline: 4}`, four gloo ranks on the one
    card, 1f1b) against world 1 in this process; 21b the same ranks at
    M = PIPELINE_WIDE_M under each schedule; 21c 21a's checkpoint restored
    at world 1. `gang`: phase_gangs' "pipeline" entry. → each flash
    kernel's launches over 21a's ranks."""
    from kubeflow_tpu_torch.checkpointing import layout as ck_layout
    from kubeflow_tpu_torch.checkpointing import restore_latest
    from kubeflow_tpu_torch.ops import flash_attention as fa

    t21 = time.monotonic()
    cuda = device == "cuda"
    smi = smi_line() if cuda else "the CPU"
    total = {name: 0 for name in fa.launch_counts}
    root, plan, reps = gang
    cut, kw = plan[0][0], plan[0][1]["model_kwargs"]
    ranks, steps = cut["mesh"]["pipeline"], cut["steps"]
    # world 1: the same cell without the pipeline axis
    res, tr, init, one_params = world1_run(torch, world1_cell(cut), device,
                                           model_kwargs=kw)
    one_losses = [loss for _, loss in res["losses"]]
    mcfg = tr.model.cfg
    by_stage = {rep["stage"]: [run[r] for run in reps]
                for r, rep in enumerate(reps[0])}
    a = [by_stage[s][0] for s in range(ranks)]
    losses = [loss for _, loss in a[0]["result"]["losses"]]
    gap = max(_rel(x, y) for x, y in zip(losses, one_losses))
    m = a[0]["microbatches"]
    per = mcfg.num_layers // ranks
    r = 2 if cut.get("remat") else 1
    want = {"flash_fwd": steps * per * m * r,
            "flash_bwd_dq": steps * per * m,
            "flash_bwd_dkv": steps * per * m}
    got_bytes = [rep["bytes"]["params"] for rep in a]
    want_bytes = [stage_param_bytes(mcfg, s, ranks) for s in range(ranks)]
    joined = {}
    for s in range(ranks):
        joined.update(torch.load(os.path.join(root, f"final.{s}.pt"),
                                 map_location=device)["params"])
    gate, held = update_gate(joined, one_params, init)
    del joined, init, one_params
    step_ms = [rep["result"]["step_time_s"] * 1e3 for rep in a]
    seconds = [tuple(round(v, 3) for v in run["seconds"].values())
               for run in by_stage[0]]
    print(f"pipeline 21a ({smi}): {cut['model']} {cut['dtype']} seq "
          f"{mcfg.max_len} global batch {cut['global_batch_size']} on "
          f"mesh {cut['mesh']}, {a[0]['schedule']} over M = {m}: losses "
          f"{losses} against world 1's {one_losses} (worst rel "
          f"{gap:.3e}, bound {GANG_LOSS_REL:g}); the stage blocks joined: "
          f"{gate}; parameter bytes a stage {got_bytes} (formula "
          f"{want_bytes}); flash launches a stage "
          f"{[rep['launches'] for rep in a]} (formula {want}); live "
          f"microbatches a stage {[rep['live'] for rep in a]}; step ms a "
          f"stage {step_ms} (a record, not a speed: the ranks share the "
          f"card and gloo stages each transfer through the host); "
          f"max_memory_allocated a stage "
          f"{[rep['max_memory_allocated'] for rep in a]} B; stage 0's "
          f"runs (build, build + run) s {seconds}", flush=True)
    if any(rep["result"]["losses"] != a[0]["result"]["losses"] for rep in a):
        raise AssertionError("21a: the stages' losses differ")
    if len(losses) != steps or not gap <= GANG_LOSS_REL:
        raise AssertionError(f"21a: losses {losses} vs {one_losses}")
    if got_bytes != want_bytes:
        raise AssertionError(f"21a: parameter bytes {got_bytes} != "
                             f"{want_bytes}")
    if not held:
        raise AssertionError(f"21a: {gate}")
    if [rep["live"] for rep in a] != [min(ranks - s, m)
                                      for s in range(ranks)]:
        raise AssertionError(f"21a: live {[rep['live'] for rep in a]}")
    for rep in a:
        if cuda and rep["launches"] != want:
            raise AssertionError(f"21a: stage {rep['stage']} launches "
                                 f"{rep['launches']} != {want}")
        for name, count in rep["launches"].items():
            total[name] += count
    # 21b: M = PIPELINE_WIDE_M, one step under each schedule
    wide = {sched: [by_stage[s][i] for s in range(ranks)]
            for i, sched in ((1, "gpipe"), (2, "1f1b"))}
    live = {k: [rep["live"] for rep in v] for k, v in wide.items()}
    live_want = {"gpipe": [PIPELINE_WIDE_M] * ranks,
                 "1f1b": [ranks - s for s in range(ranks)]}
    mem = {k: [rep["max_memory_allocated"] for rep in v]
           for k, v in wide.items()}
    wide_losses = {k: v[0]["result"]["losses"] for k, v in wide.items()}
    print(f"pipeline 21b ({smi}): M = {PIPELINE_WIDE_M}, one step: live "
          f"microbatches a stage {live} (formula {live_want}); "
          f"max_memory_allocated a stage {mem} B; step-1 losses "
          f"{wide_losses}, equal bit for bit: "
          f"{wide_losses['gpipe'] == wide_losses['1f1b']}", flush=True)
    if live != live_want:
        raise AssertionError(f"21b: live {live} != {live_want}")
    if not _rel(wide_losses["1f1b"][0][1],
                wide_losses["gpipe"][0][1]) <= GANG_LOSS_REL:
        raise AssertionError(f"21b: losses {wide_losses}")
    # 21c: world 1 restores the gang's step-PIPELINE_SAVE checkpoint (each
    # stacked layer leaf written as 4 stage blocks) into its own trainer,
    # its layers read off the stacked leaves
    ckpt = cut["checkpoint"]["directory"]
    tr.losses.clear()
    state = restore_latest(ckpt, tr._final_state, step=PIPELINE_SAVE)
    digests = {}
    for rep in a:
        digests.update(rep["digests_at"])
    same = {name: digest(torch, p) == digests.get(name)
            for name, p in state.model.named_parameters()}
    tr.fit(steps=steps - PIPELINE_SAVE, state=state, log_every=steps)
    resumed = [loss for _, loss in tr.losses]
    gap_c = max(_rel(x, y) for x, y in zip(resumed, losses[PIPELINE_SAVE:]))
    manifest = ck_layout.read_manifest(ck_layout.step_dir(
        ckpt, PIPELINE_SAVE))
    shards = {e["key"]: len(e["shards"]) for e in manifest["leaves"]
              if e["key"].startswith("params/")}
    stacked = {k: v for k, v in shards.items() if "/stages/" in k}
    print(f"pipeline 21c ({smi}): the step-{PIPELINE_SAVE} checkpoint "
          f"of {manifest['process_count']} processes, {len(stacked)} "
          f"stacked layer leaves in {sorted(set(stacked.values()))} "
          f"block(s) each, {len(shards) - len(stacked)} other leaves in "
          f"{sorted({v for k, v in shards.items() if k not in stacked})}"
          f"; restored at world 1: its layers are the stage blocks "
          f"joined, bit for bit: {all(same.values())}; resumed to losses "
          f"{resumed} against the gang's {losses[PIPELINE_SAVE:]} (worst "
          f"rel {gap_c:.3e})", flush=True)
    del tr, state
    if cuda:
        torch.cuda.empty_cache()
    if not same or not all(same.values()):
        raise AssertionError(
            f"21c: leaves differ from the blocks: "
            f"{[k for k, v in same.items() if not v][:4]}")
    if set(stacked.values()) != {ranks} or not stacked:
        raise AssertionError(f"21c: stacked leaves not written in "
                             f"{ranks} blocks: {stacked}")
    if len(resumed) != steps - PIPELINE_SAVE or not gap_c <= GANG_LOSS_REL:
        raise AssertionError(f"21c: resumed losses {resumed}")
    print(f"phase 21: {time.monotonic() - t21:.3f} s; flash launches "
          f"{total}", flush=True)
    return total


def fsdp_plan(root, overrides=None, model_kwargs=FSDP_DEPTH):
    """23a's and 23b's gang runs, (config, run options) each: FSDP_CFG
    with `overrides` on each of FSDP_MESHES, the model built with
    `model_kwargs` (its depth), rank 0's gathered final weights saved;
    23a saves its checkpoint at FSDP_SAVE and its ranks record their
    blocks' digests there."""
    base = {**FSDP_CFG, **(overrides or {})}
    runs = []
    for tag, mesh in FSDP_MESHES:
        cfg = dict(base, mesh=mesh)
        opts = {"digests": True, "out": os.path.join(root, f"fsdp_{tag}"),
                "out_ranks": [0], "model_kwargs": dict(model_kwargs)}
        if tag == FSDP_MESHES[0][0]:
            cfg["checkpoint"] = {"directory": os.path.join(root, "ckpt"),
                                 "interval_steps": FSDP_SAVE, "keep": 10,
                                 "async_save": False}
            opts["digest_step"] = FSDP_SAVE
        runs.append((cfg, opts))
    return runs


def phase_fsdp(torch, gang, device="cuda"):
    """Phase 23: 23a gpt_small on `{fsdp: 4}` and 23b on `{data: 2, fsdp:
    2}` (gloo ranks on the one card; `gang`: phase_gangs' "fsdp" entry)
    against world 1 in this process; 23c 23a's checkpoint restored at
    world 1. → each flash kernel's launches over 23a's and 23b's ranks."""
    from kubeflow_tpu_torch.checkpointing import layout as ck_layout
    from kubeflow_tpu_torch.checkpointing import restore_latest
    from kubeflow_tpu_torch.models.layers import fsdp_leaf_dims
    from kubeflow_tpu_torch.ops import flash_attention as fa

    t23 = time.monotonic()
    cuda = device == "cuda"
    smi = smi_line() if cuda else "the CPU"
    total = {name: 0 for name in fa.launch_counts}
    root, plan, reports = gang
    base = plan[0][0]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res, tr, init, one_params = world1_run(
        torch, world1_cell(base), device,
        model_kwargs=plan[0][1]["model_kwargs"])
    one_peak = torch.cuda.max_memory_allocated() if cuda else 0
    one_losses = [loss for _, loss in res["losses"]]
    one_bytes = state_bytes(tr._final_state)
    layers = tr.model.cfg.num_layers
    steps, a = base["steps"], base.get("accum_steps", 1)
    r = 2 if base.get("remat") else 1
    want = {"flash_fwd": steps * layers * a * r,
            "flash_bwd_dq": steps * layers * a,
            "flash_bwd_dkv": steps * layers * a}
    losses_23a = None
    for (cfg, opts), reps, (tag, _) in zip(plan, reports, FSDP_MESHES):
        mesh, size = cfg["mesh"], cfg["mesh"]["fsdp"]
        split = fsdp_leaf_dims(tr.model, size)
        in_layers = sum(1 for n in split if n.startswith("layers."))
        # a gather a use (a layer's leaves again in the remat recompute),
        # a reduce-scatter a gathered use; one bucket all-reduce a step,
        # two when the blocks meet a data axis above 1
        collectives = {"all_gather": steps * a * (len(split)
                                                  + in_layers * (r - 1)),
                       "reduce_scatter": steps * a * len(split)}
        buckets = steps * (1 + (mesh.get("data", 1) > 1))
        want_bytes = fsdp_param_bytes(tr.model, size)
        losses = [loss for _, loss in reps[0]["result"]["losses"]]
        gap = max(_rel(x, y) for x, y in zip(losses, one_losses))
        same = all(rep["replicated"] == reps[0]["replicated"]
                   for rep in reps)
        gate, held = update_gate(torch.load(
            f"{opts['out']}.0.pt", map_location=device)["params"],
            one_params, init)
        got_bytes = [rep["bytes"]["params"] for rep in reps]
        got_opt = [rep["bytes"]["optimizer"] for rep in reps]
        got_coll = [rep["result"].get("fsdp_collectives") for rep in reps]
        got_buckets = [rep["result"]["grad_allreduces"] for rep in reps]
        print(f"fsdp {tag} ({smi}): {cfg['model']} {cfg['dtype']} seq "
              f"{cfg['seq_len']} global batch {cfg['global_batch_size']} on "
              f"mesh {mesh}: losses {losses} against world 1's "
              f"{one_losses} (worst rel {gap:.3e}, bound "
              f"{GANG_LOSS_REL:g}); whole leaves equal across the ranks: "
              f"{same}; rank 0's gathered {gate}; parameter bytes a rank "
              f"{got_bytes} (formula {want_bytes}: {len(split)} leaves "
              f"split in {size}; world 1's {one_bytes['params']}, "
              f"{want_bytes / one_bytes['params']:.4f}x), optimizer bytes "
              f"{got_opt} (world 1's {one_bytes['optimizer']}); "
              f"max_memory_allocated a rank "
              f"{[rep['max_memory_allocated'] for rep in reps]} B against "
              f"world 1's {one_peak} B; flash launches a rank "
              f"{[rep['launches'] for rep in reps]} (formula {want}); "
              f"gathers and reduce-scatters a rank {got_coll} (formula "
              f"{collectives}); bucket all-reduces {got_buckets} (formula "
              f"{buckets}); step ms a rank "
              f"{[rep['result']['step_time_s'] * 1e3 for rep in reps]} (a "
              f"record, not a speed: the ranks share the card and gloo "
              f"stages each collective through the host)", flush=True)
        if any(rep["result"]["losses"] != reps[0]["result"]["losses"]
               for rep in reps):
            raise AssertionError(f"{tag}: the ranks' losses differ")
        if len(losses) != steps or not gap <= GANG_LOSS_REL:
            raise AssertionError(f"{tag}: losses {losses} vs {one_losses}")
        if not same:
            raise AssertionError(f"{tag}: the ranks' whole leaves differ")
        if not held:
            raise AssertionError(f"{tag}: rank 0's {gate}")
        if got_bytes != [want_bytes] * len(reps) or \
                got_opt != [2 * want_bytes] * len(reps):
            raise AssertionError(f"{tag}: bytes a rank {got_bytes}, "
                                 f"{got_opt} != {want_bytes} (x2)")
        if got_coll != [collectives] * len(reps) or \
                got_buckets != [buckets] * len(reps):
            raise AssertionError(f"{tag}: collectives {got_coll}, "
                                 f"{got_buckets} != {collectives}, "
                                 f"{buckets}")
        for rep in reps:
            if cuda and rep["launches"] != want:
                raise AssertionError(f"{tag}: rank {rep['rank']} launches "
                                     f"{rep['launches']} != {want}")
            for name, count in rep["launches"].items():
                total[name] += count
        if losses_23a is None:
            losses_23a, reps_23a, size_23a = losses, reps, size
    del init, one_params
    # 23c: world 1 restores 23a's step-FSDP_SAVE checkpoint (each split
    # leaf written as its blocks by the ranks at data coordinate 0) into
    # its own trainer (its state is overwritten in place) and resumes
    ckpt = base["checkpoint"]["directory"]
    tr.losses.clear()
    state = restore_latest(ckpt, tr._final_state, step=FSDP_SAVE)
    split = fsdp_leaf_dims(tr.model, size_23a)
    by_block = {rep["coords"]["fsdp"]: rep for rep in reps_23a}
    joined = {}
    for name, p in state.model.named_parameters():
        if name in split:
            dim = split[name]
            n = p.shape[dim] // size_23a
            joined[name] = all(
                digest(torch, p.narrow(dim, f * n, n))
                == by_block[f]["blocks_at"][name] for f in range(size_23a))
        else:
            joined[name] = (digest(torch, p)
                            == by_block[0]["blocks_at"][name])
    tr.fit(steps=steps - FSDP_SAVE, state=state, log_every=steps)
    resumed = [loss for _, loss in tr.losses]
    gap_c = max(_rel(x, y) for x, y in zip(resumed,
                                           losses_23a[FSDP_SAVE:]))
    manifest = ck_layout.read_manifest(ck_layout.step_dir(ckpt, FSDP_SAVE))
    shards = {e["key"]: len(e["shards"]) for e in manifest["leaves"]
              if e["key"].startswith("params/")}
    blocked = {k: v for k, v in shards.items() if v > 1}
    print(f"fsdp 23c ({smi}): the step-{FSDP_SAVE} checkpoint of "
          f"{manifest['process_count']} processes, {len(blocked)} params "
          f"leaves in {sorted(set(blocked.values()))} block(s), "
          f"{len(shards) - len(blocked)} whole; restored at world 1: its "
          f"leaves are the ranks' blocks joined, bit for bit: "
          f"{all(joined.values())}; resumed to losses {resumed} against "
          f"the gang's {losses_23a[FSDP_SAVE:]} (worst rel {gap_c:.3e})",
          flush=True)
    del tr, state
    if cuda:
        torch.cuda.empty_cache()
    if not joined or not all(joined.values()):
        raise AssertionError(f"23c: leaves differ from the blocks: "
                             f"{[k for k, v in joined.items() if not v][:4]}")
    if set(blocked.values()) != {size_23a} or len(blocked) != len(split):
        raise AssertionError(f"23c: split leaves not written in "
                             f"{size_23a} blocks: {blocked}")
    if len(resumed) != steps - FSDP_SAVE or not gap_c <= GANG_LOSS_REL:
        raise AssertionError(f"23c: resumed losses {resumed}")
    print(f"phase 23: {time.monotonic() - t23:.3f} s; flash launches "
          f"{total}", flush=True)
    return total


# -- phase 24: the serving mesh ------------------------------------------------


def serve_plan(root, overrides=None, cells=SERVE_CELLS):
    """Phase 24's gang runs, (cell spec, run options) each: every cell of
    `cells` on SERVE_TRAFFIC with `overrides` (a model name map "models"
    and traffic fields)."""
    over = dict(overrides or {})
    models = over.pop("models", {})
    return [({"cell": cell, "model": models.get(model, model), "mesh": mesh,
              "quantize": quantize, **SERVE_TRAFFIC, **over},
             {"serve": True}) for cell, model, mesh, quantize in cells]


def serve_traffic(vocab, lens, largest):
    """Phase 5's prompts (drawn in its order: the requests, then the
    warm-up's `largest` + 4 tokens)."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    return prompts, rng.integers(0, vocab, largest + 4).tolist()


def mesh_formulas(torch, model, mesh, quantize, dtype="bfloat16"):
    """(weight bytes a rank holds, collectives and bytes a decode step's
    weight gathers bring in, the expert stacks' whole bytes) by the
    specs' formulas for registry `model` computing in `dtype` on serving
    mesh `mesh`: each leaf's bytes at rest (f32; an int8 leaf, ndim >=
    2, at one byte an element plus its f32 scale, held whole) over the
    product of its spec's axes; a transformer block's leaves gathered at
    once, one collective an axis they split over (a leaf outside the
    blocks alone, one an axis), each leaf bringing in its whole bytes
    less its block's in its wire dtype (int8, else `dtype`); an expert
    stack on an expert axis never."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.parallel.serving_mesh import (
        is_moe_expert_kernel_path,
        serving_leaf_specs,
        spec_bytes,
    )

    sizes = {a: mesh.get(a, 1) for a in ("tensor", "fsdp", "expert")}
    whole = get_model(model, device="meta", dtype=getattr(torch, dtype))
    shapes = {n: tuple(t.shape) for n, t in whole.state_dict().items()}
    int8 = {n for n in shapes if quantize == "int8" and len(shapes[n]) >= 2}
    wire = getattr(torch, dtype).itemsize
    specs = serving_leaf_specs(shapes, **sizes)
    held = spec_bytes(shapes, {n: 1 if n in int8 else 4 for n in shapes},
                      specs, sizes) + sum(4 * shapes[n][-1] for n in int8)
    units, moved = {}, 0
    for n, spec in specs.items():
        if sizes["expert"] > 1 and is_moe_expert_kernel_path(n):
            continue
        axes = {a for entry in spec for a in (
            (entry,) if isinstance(entry, str) else (entry or ()))
            if a in ("fsdp", "tensor") and sizes[a] > 1}
        if axes:
            unit = ".".join(n.split(".")[:2]) if n.startswith("layers.") \
                else n
            units.setdefault(unit, set()).update(axes)
            parts = int(np.prod([sizes[a] for a in axes]))
            nbytes = int(np.prod(shapes[n])) * (1 if n in int8 else wire)
            moved += nbytes - nbytes // parts
    stacks = sum(int(np.prod(shapes[n])) * 4 for n in shapes
                 if is_moe_expert_kernel_path(n))
    return held, sum(len(a) for a in units.values()), moved, stacks


def serve_cell(torch, spec, dev):
    """One rank's side of a phase-24 cell (`serve_plan`). Rank 0 (or a
    process without a gang, at mesh 1×1×1: the CPU rehearsal's 1×1
    reference) serves the cell through build_server behind the REST
    server: the warm-up, then phase 5's seven concurrent requests and the
    repeat with the paged launch counts set to 0 just before and read
    just after; a relayed decode step over parked slots counts a step's
    gathers. Every other rank runs serve_mesh_worker. → the rank's
    report."""
    from kubeflow_tpu_torch.api.wsgi import Server
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.parallel.distributed import rank
    from kubeflow_tpu_torch.serving.engine import resolve_num_pages
    from kubeflow_tpu_torch.serving.main import (
        build_server,
        serve_mesh_worker,
    )

    mesh, model, quantize = spec["mesh"], spec["model"], spec["quantize"]
    knobs = {f"mesh_{a}": mesh.get(a, 1) for a in ("tensor", "fsdp", "expert")}
    dtype = getattr(torch, spec["dtype"])
    cuda = dev.type == "cuda"
    # what the rank process's earlier runs left allocated
    leftover = torch.cuda.memory_allocated(dev) if cuda else 0
    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = spec["buckets"]
    try:
        if rank() > 0:
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            calls = serve_mesh_worker(model, device=dev, dtype=dtype, **knobs)
            return {"calls": calls, "leftover": leftover,
                    "max_memory_allocated": (
                        torch.cuda.max_memory_allocated(dev) if cuda else 0)}
        cfg = get_model(model, device="meta", dtype=dtype).cfg
        # the tensor rule's auto pool: the 1×1 static pages times tensor
        pages = resolve_num_pages(None, 8, cfg, 16, quantize,
                                  knobs["mesh_tensor"])
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        ms = build_server(model, device=dev, dtype=dtype, num_slots=8,
                          page_size=16, num_pages=pages, quantize=quantize,
                          paged_attention="kernel", **knobs)
        # what the build held on the card at its most
        build_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        httpd = Server(ms.app, port=0)
        httpd.start()
        try:
            eng = ms.engine(model)
            largest = eng.prefill_buckets[-1]
            prompts, warm = serve_traffic(cfg.vocab_size, spec["lens"],
                                          largest)
            results = [None] * len(prompts)

            def run(i):
                results[i] = post(httpd.port, model, {
                    "prompt_ids": [prompts[i]],
                    "max_new_tokens": spec["max_new"]})

            if post(httpd.port, model, {"prompt_ids": [warm],
                                        "max_new_tokens": 2})[0] != 200:
                raise AssertionError(f"{spec['cell']} warm-up failed")
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
            # the main path's run: every launch count starts at 0 here
            pa.reset_launch_counts()
            t0 = time.monotonic()
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            wall = time.monotonic() - t0
            prompts.append(prompts[-1])
            results.append(post(httpd.port, model, {
                "prompt_ids": [prompts[-1]],
                "max_new_tokens": spec["max_new"]}))
            launches = dict(pa.launch_counts)
            stats = eng.stats()
            peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            tokens = []
            for prompt, res in zip(prompts, results):
                if res is None or res[0] != 200:
                    raise AssertionError(f"{spec['cell']} :generate: {res}")
                tokens.append(res[1]["sequences"][0][len(prompt):])
            gathers = step_gathers(torch, eng)
            own_stacks = sum(t.numel() * t.element_size() for n, t in
                             eng.model.state_dict().items() if is_stack(n))
        finally:
            httpd.stop()
            ms.close()
        held, collectives, moved, stacks = mesh_formulas(
            torch, model, mesh, quantize, spec["dtype"])
        return {"tokens": tokens, "launches": launches, "stats": stats,
                "gathers": gathers, "wall_s": wall, "leftover": leftover,
                "stack_bytes": own_stacks,
                "max_memory_allocated": peak, "build_peak": build_peak,
                "formula": {"weight_bytes": held, "all_gather": collectives,
                            "bytes": moved, "stacks": stacks}}
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)


def step_gathers(torch, eng):
    """One decode step over parked slots, relayed as the engine relays
    its own: the weight gathers it makes on this rank (collectives, bytes
    brought in) and its attention-output gathers."""
    mesh = eng.mesh
    if mesh is None:
        return {"all_gather": 0, "bytes": 0, "heads": 0}
    s, before = eng.num_slots, dict(mesh.weights.counts)
    heads = 0 if mesh.heads is None else mesh.heads.counts["all_gather"]

    def job():
        eng.programs.step(
            eng._pool, eng._to_dev(np.zeros((s,), np.int64)),
            eng._to_dev(np.zeros((s, eng._max_pages), np.int32)),
            eng._to_dev(np.full((s,), eng.model.cfg.max_len, np.int32)),
            np.zeros((s,), np.int64), np.zeros((s,), np.int64),
            np.zeros((s,), np.float32), np.zeros((s,), np.int64),
            np.ones((s,), np.float32))

    eng._run_on_scheduler(job)
    return {"all_gather": mesh.weights.counts["all_gather"]
            - before["all_gather"],
            "bytes": mesh.weights.counts["bytes"] - before["bytes"],
            "heads": (0 if mesh.heads is None
                      else mesh.heads.counts["all_gather"] - heads)}


def phase_serving_mesh(torch, gang, refs=None, device="cuda"):
    """Phase 24's gates on its gang's reports (`gang`: phase_gangs'
    "serve" entry). `refs`: {cell: its 1×1 reference's {"tokens",
    "kv_pool_bytes", "launches" (paged)}} (phase 5's run for 24a and
    24c, phase 10's for 24b, 18b's for 24d), or None to serve each cell's
    1×1 reference here (the CPU rehearsal) → {cell: rank 0's report}."""
    from kubeflow_tpu_torch.models.registry import get_model

    t24 = time.monotonic()
    _, plan, reports = gang
    where = smi_line() if device == "cuda" else device
    out = {}
    for (spec, _), reps in zip(plan, reports):
        cell, mesh = spec["cell"], spec["mesh"]
        rep, workers = reps[0], reps[1:]
        ref = (refs or {}).get(cell)
        if ref is None:
            solo = serve_cell(torch, dict(spec, mesh={}), torch.device(device))
            ref = {"tokens": solo["tokens"], "launches": solo["launches"],
                   "kv_pool_bytes": solo["stats"]["kv_pool_bytes"],
                   "peak_bytes": solo["max_memory_allocated"]}
        st, f, g = rep["stats"], rep["formula"], rep["gathers"]
        t = mesh.get("tensor", 1)
        # a rank's card bytes by the formula: its weights and its pools
        held = st["weight_bytes_per_chip"] + st["kv_pool_bytes_per_chip"]
        acts = rep["max_memory_allocated"] - rep["leftover"] - held
        worker_peaks = [w["max_memory_allocated"] - w["leftover"]
                        for w in workers]
        print(f"serving mesh {cell} ({where}): {spec['model']} "
              f"{spec['quantize'] if spec['quantize'] != 'none' else spec['dtype']} "
              f"on {mesh}: {len(rep['tokens'])} requests, tokens equal the "
              f"1×1 reference's: {rep['tokens'] == ref['tokens']}; "
              f"{spec['max_new'] * (len(rep['tokens']) - 1)} "
              f"tokens of concurrent load in {rep['wall_s']:.3f} s; pool "
              f"{st['pages_total']} pages, {st['kv_pool_bytes_per_chip']} B a "
              f"rank ({st['kv_pool_bytes']} B whole; the 1×1 pool "
              f"{ref['kv_pool_bytes']} B); weights "
              f"{st['weight_bytes_per_chip']} B a rank (the specs' formula: "
              f"each leaf's bytes over its spec's axes = {f['weight_bytes']} "
              f"B; expert stacks {rep['stack_bytes']} B a rank of "
              f"{f['stacks']} B whole); a decode step's "
              f"gathers {g['all_gather']} of {g['bytes']} B (formula "
              f"{f['all_gather']} of {f['bytes']} B) and {g['heads']} "
              f"attention outputs; rank 0's paged launches "
              f"{rep['launches']}; max_memory_allocated by rank "
              f"{[r['max_memory_allocated'] for r in reps]} B (rank 0 over "
              f"the traffic, the workers' from their build; left allocated "
              f"by the rank process's earlier runs "
              f"{[r['leftover'] for r in reps]} B), the 1×1 engine's "
              f"{ref['peak_bytes']} B; rank 0's build "
              f"{rep['build_peak'] - rep['leftover']} B (its weights and "
              f"pools {held} B + at most {SERVE_MEM_SLACK} B); the workers' "
              f"{worker_peaks} B (bound: {held} B + rank 0's activations "
              f"{acts} B + {SERVE_MEM_SLACK} B); worker calls "
              f"{[sum(w['calls'].values()) for w in workers]}",
              flush=True)
        if rep["tokens"] != ref["tokens"]:
            bad = [i for i, (a, b) in enumerate(zip(rep["tokens"],
                                                    ref["tokens"])) if a != b]
            raise AssertionError(f"{cell}: requests {bad} answered other "
                                 f"tokens than the 1×1 reference's")
        if st["mesh_tensor"] != t or st["kv_pool_bytes"] != \
                t * st["kv_pool_bytes_per_chip"] or \
                st["kv_pool_bytes_per_chip"] != ref["kv_pool_bytes"]:
            raise AssertionError(f"{cell}: pool {st}, the 1×1 pool's "
                                 f"{ref['kv_pool_bytes']} B")
        if st["weight_bytes_per_chip"] != f["weight_bytes"]:
            raise AssertionError(f"{cell}: {st['weight_bytes_per_chip']} "
                                 f"weight bytes a rank, formula "
                                 f"{f['weight_bytes']}")
        if rep["stack_bytes"] * mesh.get("expert", 1) != f["stacks"]:
            raise AssertionError(f"{cell}: {rep['stack_bytes']} expert "
                                 f"stack bytes a rank of {f['stacks']}")
        if (g["all_gather"], g["bytes"]) != (f["all_gather"], f["bytes"]):
            raise AssertionError(f"{cell}: gathers {g}, formula {f}")
        layers = get_model(spec["model"], device="meta").cfg.num_layers
        if g["heads"] != (layers if t > 1 else 0):
            raise AssertionError(f"{cell}: {g['heads']} attention gathers")
        if not all(sum(w["calls"].values()) > 0 for w in workers):
            raise AssertionError(f"{cell}: a worker ran no call")
        if device == "cuda":
            want = {k: v for k, v in ref["launches"].items() if v}
            got = {k: v for k, v in rep["launches"].items() if v}
            if got != want:
                raise AssertionError(f"{cell}: launches {got}, the 1×1 "
                                     f"reference's {want}")
            if rep["build_peak"] - rep["leftover"] > held + SERVE_MEM_SLACK:
                raise AssertionError(f"{cell}: rank 0's build held "
                                     f"{rep['build_peak'] - rep['leftover']}"
                                     f" B on the card, formula {held} B")
            if max(worker_peaks) > held + acts + SERVE_MEM_SLACK:
                raise AssertionError(f"{cell}: worker peaks {worker_peaks} "
                                     f"B, bound {held} + {acts} B")
        out[cell] = rep
    print(f"phase 24: {time.monotonic() - t24:.3f} s (gates; the cells ran "
          f"in the gangs)", flush=True)
    return out


def phase_gangs(torch, root, device="cuda", data=None, seq=None,
                expert=None, pipeline=None, fsdp=None, serve=None):
    """The gang runs of phases 17c and 19-24, before the phases read them.
    One pair of rank processes runs 17c's two cells, 19a, 19b, 24a, 24b
    and 20b in turn, one quartet 21a, 21b, 23a, 23b, 24c, 24d and 20a (a
    rank process's start costs ~20 s, more than a cell's steps; 20a and
    20b last, whose processes kept ~1.9 GB allocated after their runs,
    which would read in the others' peaks). The pair and the quartet run
    at once (their ranks share the card and the host: the arithmetic and
    the memory, not the speed). `data`, `seq`, `expert`, `pipeline`,
    `fsdp`, `serve`: the keyword arguments of that phase's plan
    (`data_plan`, `sequence_plan`, `expert_plan`, `pipeline_plan`,
    `fsdp_plan`, `serve_plan`; {} for none), or None to leave its cells
    out. → {"data" | "seq" | "expert" | "pipeline" | "fsdp" | "serve":
    (its directory, its plan, its runs' reports in plan order, each the
    ranks' reports in rank order)}, the `gang` of phase_gang_two_ranks,
    phase_sequence, phase_expert, phase_pipeline, phase_fsdp and
    phase_serving_mesh."""
    plans = {}
    for name, fn, kw in (("data", data_plan, data),
                         ("seq", sequence_plan, seq),
                         ("expert", expert_plan, expert),
                         ("pipeline", pipeline_plan, pipeline),
                         ("fsdp", fsdp_plan, fsdp),
                         ("serve", serve_plan, serve)):
        if kw is not None:
            os.makedirs(os.path.join(root, name))
            plans[name] = (os.path.join(root, name),
                           list(fn(os.path.join(root, name), **kw)))
    # (gang, world, [(phase, its plan's runs)]) in run order
    layout = (("two", 2, [("data", slice(0, 2)), ("seq", slice(0, 2)),
                          ("serve", slice(0, 2)), ("expert", slice(1, 2))]),
              ("four", 4, [("pipeline", slice(0, 3)), ("fsdp", slice(0, 2)),
                           ("serve", slice(2, 4)),
                           ("expert", slice(0, 1))]))
    reports = {name: [None] * len(plan) for name, (_, plan) in plans.items()}
    started = []
    try:
        for gang, world, parts in layout:
            runs, at = [], []
            for name, cut in parts:
                if name not in plans:
                    continue
                plan = plans[name][1]
                for i in range(len(plan))[cut]:
                    axes = plan[i][0]["mesh"]
                    if int(np.prod(list(axes.values()))) != world:
                        raise AssertionError(f"gang {gang} of {world} "
                                             f"ranks: {name} run {i} on "
                                             f"mesh {axes}")
                    runs.append(plan[i])
                    at.append((name, i))
            if not runs:
                continue
            hosts = one_card_hosts(world) if device == "cuda" else None
            started.append((at, start_gang_runs(
                torch, gang, runs, world, root, hosts=hosts,
                backend="gloo", timeout_s=GANGS_TIMEOUT_S,
                **({} if device == "cuda" else {"device": "cpu"}))))
        for at, handle in started:
            for (name, i), reps in zip(at, finish_gang_runs(handle)):
                reports[name][i] = reps
    finally:
        for _, handle in started:
            stop_gang(handle)
    return {name: (path, plan, reports[name])
            for name, (path, plan) in plans.items()}


# -- phase 22: the job path (GPUTrainJob, the pod executor, the StudyJob) ------


def job_harness(runner_fn, study=False):
    """A StateStore, a ControllerManager with the GPUTrainJob controller
    (and the StudyJob's with `study`), and a PodExecutor over
    `runner_fn(store)` → (store, cm, executor, runner)."""
    from kubeflow_tpu_torch.cluster.reconciler import ControllerManager
    from kubeflow_tpu_torch.cluster.store import StateStore
    from kubeflow_tpu_torch.controllers.gpujob import GPUTrainJobController
    from kubeflow_tpu_torch.controllers.studyjob import StudyJobController
    from kubeflow_tpu_torch.runtime.executor import PodExecutor

    store = StateStore()
    cm = ControllerManager(store)
    cm.register(GPUTrainJobController())
    if study:
        cm.register(StudyJobController())
    runner = runner_fn(store)
    return store, cm, PodExecutor(store, runner), runner


def run_to_end(store, cm, executor, kind, name, terminal, timeout_s):
    """The control plane in its background mode, as a user runs it: the
    ControllerManager's threads and the PodExecutor's loop, until `kind`
    `name` holds one of the `terminal` conditions (its status returned);
    raise at `timeout_s`. Both are stopped on every exit."""
    cm.start()
    executor.start()
    try:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = store.get(kind, name).get("status") or {}
            if any(c["type"] in terminal and c["status"] == "True"
                   for c in status.get("conditions", [])):
                return status
            time.sleep(0.1)
        raise AssertionError(f"{kind} {name} did not end in {timeout_s} s: "
                             f"{store.get(kind, name).get('status')}")
    finally:
        executor.stop()
        cm.stop()


def phase_job_study(torch, device="cuda", trial=None):
    """22a: the LR sweep as a StudyJob of GPUTrainJob trials, run in this
    process by the in-process pod runner. Gates: the study Completed with
    every trial succeeded, bestTrial the argmax of the trials'
    trainingMetrics items_per_sec, each trial's pod env carrying its own
    rate, every trial's losses finite, and trial 0's final loss within
    GANG_LOSS_REL of a direct `run_training` of its config here. → the
    study's seconds."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.controllers.studyjob import new_study_job
    from kubeflow_tpu_torch.runtime.executor import (
        InProcessTrainerRunner,
        pod_env,
    )
    from kubeflow_tpu_torch.runtime.train_run import run_training

    trial = dict(STUDY_TRIAL if trial is None else trial)
    rates = STUDY_RATES
    dev = None if device == "cuda" else device
    store, cm, executor, runner = job_harness(
        lambda store: InProcessTrainerRunner(device=dev), study=True)
    store.create(new_study_job(
        "sweep", objective={"type": "maximize", "metric": "items_per_sec"},
        parameters=[{"name": "training.learning_rate", "type": "double",
                     "list": list(rates)}],
        trial_template={"slice": {"topology": "h100-1"}, "training": trial,
                        "runPolicy": {"maxRestarts": 0,
                                      "cleanPodPolicy": "None"}},
        max_trials=len(rates), parallelism=1))
    t0 = time.monotonic()
    status = run_to_end(store, cm, executor, "StudyJob", "sweep",
                        ("Completed", "Failed"), JOB_TIMEOUT_S)
    seconds = time.monotonic() - t0
    if status.get("trialsSucceeded") != len(rates) or not any(
            c["type"] == "Completed" and c["status"] == "True"
            for c in status["conditions"]):
        raise AssertionError(f"22a: the study did not complete every trial: "
                             f"{status}")
    metrics = [store.get("GPUTrainJob", f"sweep-trial-{i}")["status"][
        "trainingMetrics"] for i in range(len(rates))]
    best = status["bestTrial"]
    argmax = int(np.argmax([m["items_per_sec"] for m in metrics]))
    if best["index"] != argmax or best["metric"]["items_per_sec"] != metrics[
            argmax]["items_per_sec"]:
        raise AssertionError(f"22a: bestTrial {best} is not the argmax "
                             f"({argmax}) of {metrics}")
    runs = {r["pod"]: r for r in runner.runs}
    for i, rate in enumerate(rates):
        pod = f"sweep-trial-{i}-worker-0"
        spec = json.loads(pod_env(store.get("Pod", pod))["KFT_TRAINING_SPEC"])
        res = runs[pod]["result"]
        if spec["learning_rate"] != rate:
            raise AssertionError(f"22a: trial {i}'s pod runs rate "
                                 f"{spec['learning_rate']}, not {rate}")
        if not all(np.isfinite(loss) for _, loss in res["losses"]) or len(
                res["losses"]) != trial["steps"]:
            raise AssertionError(f"22a: trial {i}'s losses {res['losses']}")
    direct = run_training(TrainingConfig.from_dict(
        dict(trial, learning_rate=rates[0])), device=dev)
    first = runs["sweep-trial-0-worker-0"]["result"]["loss"]
    gap = _rel(first, direct["loss"])
    print(f"job 22a ({smi_line() if dev is None else dev}): StudyJob of "
          f"{len(rates)} GPUTrainJob "
          f"trials ({trial['model']}, global batch "
          f"{trial['global_batch_size']}, {trial['steps']} steps, "
          f"learning_rate {list(rates)}) in {seconds:.3f} s = "
          f"{3600.0 * len(rates) / seconds:.1f} trials/hr; per trial "
          + ", ".join(
              f"{i}: {runs[f'sweep-trial-{i}-worker-0']['wall_s']:.3f} s "
              f"{m['items_per_sec']:.1f} items/s loss "
              f"{runs[f'sweep-trial-{i}-worker-0']['result']['loss']:.5f}"
              for i, m in enumerate(metrics))
          + f"; best trial {best['index']} ({best['parameters']}); trial 0's "
          f"final loss {first!r} against a direct run's {direct['loss']!r}: "
          f"rel {gap:.3e}", flush=True)
    if gap > GANG_LOSS_REL:
        raise AssertionError(f"22a: trial 0's final loss {first} is {gap:.3e} "
                             f"from the direct run's {direct['loss']}")
    return seconds


def flash_formula(cfg, steps, layers):
    """Each flash kernel's launches in `steps` steps of a gpt `cfg`."""
    a, r = cfg.get("accum_steps", 1), 2 if cfg.get("remat") else 1
    return {"flash_fwd": steps * layers * a * r,
            "flash_bwd_dq": steps * layers * a,
            "flash_bwd_dkv": steps * layers * a}


def phase_job_resume(torch, root, layers):
    """22b: a GPUTrainJob of GANG_GPT_CFG (at JOB_STEPS steps, a
    commit every JOB_SAVE) through SubprocessPodRunner, its chaos plan
    JOB_PLAN rendered by the controller. Gates: Restarting then Succeeded
    with restarts 1; attempt 0 fails at the planned point after the
    commit; the second pod's env has KFT_RESTORE_DIR and attempt 1; it
    resumes at step JOB_SAVE and ends at JOB_STEPS within JOB_LOSS_REL of
    an uninterrupted run here; each attempt's flash launches (its
    launcher line) the formula. → the job's flash launches, both
    attempts."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.controllers.gpujob import new_gpu_train_job
    from kubeflow_tpu_torch.runtime.executor import (
        SubprocessPodRunner,
        pod_env,
    )
    from kubeflow_tpu_torch.runtime.train_run import run_training

    base = dict(GANG_GPT_CFG, steps=JOB_STEPS)
    ckpt = os.path.join(root, "job-ckpt")
    spec = dict(base, checkpoint={"directory": ckpt,
                                  "interval_steps": JOB_SAVE},
                chaos={"enabled": True, "points": [JOB_PLAN]})
    store, cm, executor, runner = job_harness(
        lambda store: SubprocessPodRunner(store))
    store.create(new_gpu_train_job("resume", max_restarts=1, training=spec,
                                   slice_spec={"topology": "h100-1"}))
    # attempt 0's pod as the controller renders it, before any pod runs
    cm.run_until_idle(max_seconds=10)
    env0 = pod_env(store.get("Pod", "resume-worker-0"))
    t0 = time.monotonic()
    try:
        status = run_to_end(store, cm, executor, "GPUTrainJob", "resume",
                            ("Succeeded", "Failed"), JOB_TIMEOUT_S)
    finally:
        runner.stop_all()
    seconds = time.monotonic() - t0
    env1 = pod_env(store.get("Pod", "resume-worker-0"))
    conds = {c["type"]: c for c in status["conditions"]}
    if (env0.get("KFT_CHAOS_POINTS") != JOB_PLAN
            or env0.get("KFT_CHAOS_ATTEMPT") != "0"
            or "KFT_RESTORE_DIR" in env0):
        raise AssertionError(f"22b: attempt 0's env {env0}")
    if (conds.get("Succeeded", {}).get("status") != "True"
            or conds.get("Restarting", {}).get("status") != "True"
            or status.get("restarts") != 1):
        raise AssertionError(f"22b: the job did not restart once and "
                             f"succeed: {status}")
    if env1.get("KFT_RESTORE_DIR") != ckpt or env1.get(
            "KFT_CHAOS_ATTEMPT") != "1":
        raise AssertionError(f"22b: attempt 1's env {env1}")
    by_attempt = {r["attempt"]: r for r in runner.results}
    first, last = by_attempt[0], by_attempt[1]
    if first["rc"] == 0 or "trainer.device_step" not in (
            first["line"] or {}).get("error", ""):
        raise AssertionError(f"22b: attempt 0 did not fail at the plan: "
                             f"{first}")
    res = last["line"]
    if (last["rc"] != 0 or res["backend"] != "nccl"
            or res["world_size"] != 1 or "restore_s" not in res
            or [s for s, _ in res["losses"]] != list(
                range(JOB_SAVE + 1, JOB_STEPS + 1))
            or res["final_step"] != JOB_STEPS):
        raise AssertionError(f"22b: attempt 1 did not resume at step "
                             f"{JOB_SAVE}: {last}")
    launches = {}
    for attempt, steps in ((first, JOB_SAVE), (last, JOB_STEPS - JOB_SAVE)):
        want = flash_formula(base, steps, layers)
        got = (attempt["line"] or {}).get("kernel_launches")
        if got != want:
            raise AssertionError(f"22b: attempt {attempt['attempt']}'s flash "
                                 f"launches {got} != {want}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    whole = run_training(TrainingConfig.from_dict(base))
    by_step = dict(whole["losses"])
    gaps = [_rel(loss, by_step[s]) for s, loss in res["losses"]]
    print(f"job 22b ({smi_line()}): GPUTrainJob of "
          f"{base['model']} through SubprocessPodRunner, world 1 over "
          f"{res['backend']}: attempt 0 failed at {JOB_PLAN!r} after the "
          f"step-{JOB_SAVE} commit ({first['wall_s']:.3f} s, rc "
          f"{first['rc']}); attempt 1 resumed with KFT_RESTORE_DIR (restore "
          f"{res['restore_s']:.3f} s), ran steps {JOB_SAVE + 1}-{JOB_STEPS} "
          f"({last['wall_s']:.3f} s) to loss {res['loss']!r} against the "
          f"uninterrupted run's {whole['loss']!r} (rel gaps by step "
          f"{['%.3e' % g for g in gaps]}); flash launches a attempt "
          f"{first['line']['kernel_launches']} / "
          f"{res['kernel_launches']}; the job {seconds:.3f} s", flush=True)
    if max(gaps) > JOB_LOSS_REL:
        raise AssertionError(f"22b: the resumed losses {res['losses']} are "
                             f"{max(gaps):.3e} from the uninterrupted run's "
                             f"{whole['losses']}")
    return launches


def phase_jobs(torch, layers):
    """Phase 22: 22a and 22b → 22b's flash launches (both attempts)."""
    t22 = time.monotonic()
    phase_job_study(torch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="kft-job-") as root:
        launches = phase_job_resume(torch, root, layers)
    print(f"phase 22: {time.monotonic() - t22:.3f} s", flush=True)
    return launches


def rank_shape(records, key):
    """A paged kernel row's numbers at a serving-mesh rank's shape (H =
    MESH_H): the B=8 decode call or the main path's windows."""
    rec = records[(key[0], key[1], key[2] + "_rank")]
    return {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "max_abs_err", "shape")}


class PhaseClock:
    """Seconds from one lap to the next (phases that print their own
    seconds are timed inside), and since the start."""

    def __init__(self):
        self.start = self.last = time.monotonic()

    def lap(self, label):
        now = time.monotonic()
        print(f"{label}: {now - self.last:.3f} s", flush=True)
        self.last = now

    def total(self):
        return time.monotonic() - self.start


def main() -> int:
    clock = PhaseClock()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.native.build import build_all, build_logs

    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.monotonic()
    libs = build_all()
    print(f"build: {sorted(libs)} in {time.monotonic() - t0:.2f} s", flush=True)
    for name, log in build_logs.items():
        print(f"build log {name}:\n{log.strip()}", flush=True)
    report = hopper_kernel_report(build_logs["flash_attention"])
    report.update(hopper_kernel_report(build_logs["paged_attention"],
                                       WINDOW_HOPPER_KERNELS))
    print("ptxas, the Hopper kernels (registers a thread at launch; no spills, "
          "setmaxnreg honoured): " + ", ".join(
              f"{k} D={d} {r[0]}" for (k, d), r in sorted(report.items())),
          flush=True)

    clock.lap("phases 1-2")
    records = phase_kernels(torch)
    clock.lap("phase 3")
    f32_model = phase_serve_f32(torch)
    clock.lap("phase 4")
    launches, bf16_stats, steps = phase_serve_bf16(torch, f32_model)
    layers = f32_model.cfg.num_layers
    del f32_model
    print(f"launches per decode step: "
          f"{launches['paged_decode'] / max(steps, 1):.2f} "
          f"(one per layer, {layers})", flush=True)
    # phase 3 timed the window kernel at the calls MAIN_WINDOWS lists:
    # one launch per layer for each
    if launches["paged_window"] != len(MAIN_WINDOWS) * layers:
        raise AssertionError(
            f"the main path made {launches['paged_window']} window launches, "
            f"not the {len(MAIN_WINDOWS)} windows x {layers} layers that "
            f"phase 3 measured"
        )
    kernels = []
    for key in (("paged_decode", "bfloat16", "B8"),
                ("paged_window", "bfloat16", "main")):
        rec = dict(records[key])
        rec["mesh_rank"] = rank_shape(records, key)
        rec["launches"] = launches[key[0]]
        if rec["launches"] < 1:
            raise AssertionError(f"the main path never launched {key[0]}")
        kernels.append(rec)
    torch.cuda.empty_cache()
    clock.lap("phase 5")

    flash_records, bert_records = phase_flash(torch)
    clock.lap("phase 6")
    phase_train_f32(torch)
    torch.cuda.empty_cache()
    clock.lap("phase 7")
    train_launches, train_result = phase_train_bf16(torch)
    for kname, rec in flash_records.items():
        rec = dict(rec)
        for key, bert in bert_records.items():
            rec[key] = {k: bert[kname][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "bytes", "ops", "shape")}
        rec["launches"] = train_launches[kname]
        if rec["launches"] < 1:
            raise AssertionError(f"the training main path never launched {kname}")
        kernels.append(rec)
    torch.cuda.empty_cache()

    clock.lap("phase 8")
    int8_records = phase_kernels(torch, quantized=True)
    clock.lap("phase 9")
    int8_launches, int8_stats, int8_steps = phase_serve_int8(torch,
                                                             bf16_stats)
    print(f"int8 launches per decode step: "
          f"{int8_launches['paged_decode_int8'] / max(int8_steps, 1):.2f} "
          f"(one per layer, {layers})", flush=True)
    if int8_launches["paged_window_int8"] != len(MAIN_WINDOWS) * layers:
        raise AssertionError(
            f"the int8 path made {int8_launches['paged_window_int8']} window "
            f"launches, not the {len(MAIN_WINDOWS)} windows x {layers} layers "
            f"that phase 9 measured"
        )
    for key in (("paged_decode_int8", "bfloat16", "B8"),
                ("paged_window_int8", "bfloat16", "main")):
        rec = dict(int8_records[key])
        rec["mesh_rank"] = rank_shape(int8_records, key)
        rec["launches"] = int8_launches[key[0]]
        if rec["launches"] < 1:
            raise AssertionError(f"the int8 main path never launched {key[0]}")
        kernels.append(rec)
    torch.cuda.empty_cache()
    clock.lap("phase 10")

    f32_model = phase_spec_f32(torch)
    spec_launches, spec_run = phase_spec_serve(torch, f32_model, bf16_stats)
    small_launches = phase_spec_small_draft(torch, f32_model)
    del f32_model
    small_shapes = {
        "paged_decode": f"B=8 s=1 H={SMALL_H} D={SMALL_D} cursors={list(CURSORS)}",
        "paged_window": (f"B=1 s={CHUNK} H={SMALL_H} D={SMALL_D} cursors="
                         f"{sorted(set(MAIN_WINDOWS))} (the draft's chunk "
                         f"windows); the target's verify at B=8 s={VERIFY} "
                         f"H={H} D={D}"),
    }
    for rec in kernels[:2]:
        # this slice's path: the drafted bf16 serve (11b), then 11c's,
        # whose draft calls run at D = 16 (phase 3 held them, not timed)
        rec["spec_launches"] = spec_launches[rec["name"]]
        rec["small_draft_launches"] = small_launches[rec["name"]]
        rec["small_draft_shape"] = small_shapes[rec["name"]]
        rec["small_draft_max_abs_err"] = records[
            (rec["name"], "bfloat16", "small_draft")]["max_abs_err"]
        if min(rec["spec_launches"], rec["small_draft_launches"]) < 1:
            raise AssertionError(f"the speculative path never launched {rec['name']}")
    torch.cuda.empty_cache()
    clock.lap("phase 11")

    # this slice's path: train, preempt, resume, then serve the checkpoint
    with tempfile.TemporaryDirectory(prefix="kft-ckpt-") as root:
        flash_launches, trainer, ckpt_dir = phase_ckpt_train(torch, root)
        paged_launches = phase_ckpt_serve(torch, trainer, ckpt_dir, bf16_stats,
                                          spec_run["accept_rate"])
        # phase 14c resumes to these, bit for bit
        ckpt_losses = list(trainer.losses)
        ckpt_params = {name: p.detach().cpu().clone() for name, p
                       in trainer._final_state.model.named_parameters()}
        del trainer
    for rec in kernels:
        rec["checkpoint_launches"] = {**flash_launches, **paged_launches}[rec["name"]]
        if rec["checkpoint_launches"] < 1:
            raise AssertionError(f"the checkpoint path never launched {rec['name']}")
    torch.cuda.empty_cache()
    clock.lap("phase 12")

    # this slice's path: host spill, warm restart and page handoff
    kv_launches = phase_kv_tiers(torch)
    for rec in kernels:
        if rec["name"] in kv_launches:
            rec["kv_tier_launches"] = kv_launches[rec["name"]]
            if rec["kv_tier_launches"] < 1:
                raise AssertionError(f"the KV tier path never launched "
                                     f"{rec['name']}")
    torch.cuda.empty_cache()
    clock.lap("phase 13")

    # this slice's path: traced serving, faults in serving and training
    t14 = time.monotonic()
    chaos_launches = phase_chaos_serve(torch, bf16_stats)
    with tempfile.TemporaryDirectory(prefix="kft-chaos-") as root:
        chaos_launches.update(phase_chaos_train(torch, root, ckpt_losses,
                                                ckpt_params))
    print(f"phase 14: {time.monotonic() - t14:.3f} s", flush=True)
    for rec in kernels:
        # the bf16 paged rows (14a, 14b) and the bf16 flash rows (14c)
        if rec["name"] in CHAOS_ROWS:
            rec["chaos_launches"] = chaos_launches[rec["name"]]
            if rec["chaos_launches"] < 1:
                raise AssertionError(f"the chaos path never launched "
                                     f"{rec['name']}")
    # ResNet-50 training, train to accuracy, :predict
    image_ref = phase_image(torch)
    torch.cuda.empty_cache()
    # this slice's path: BERT-base pretraining through the flash kernels'
    # bidirectional, key-masked calls
    bert_launches = phase_bert(torch)
    for rec in kernels:
        if rec["name"] in bert_launches:
            rec["bert_launches"] = bert_launches[rec["name"]]
            if rec["bert_launches"] < 1:
                raise AssertionError(f"the BERT path never launched "
                                     f"{rec['name']}")
    torch.cuda.empty_cache()
    # this slice's path: data-parallel training through the gang launcher
    dp_launches = phase_gang(torch, image_ref, train_result, layers)
    for rec in kernels:
        if rec["name"] in dp_launches:
            rec["dp_launches"] = dp_launches[rec["name"]]
            if rec["dp_launches"] < 1:
                raise AssertionError(f"the data-parallel path never launched "
                                     f"{rec['name']}")
    torch.cuda.empty_cache()
    # this slice's path: MoE serving (18b bf16, 18c int8) and training (18e;
    # 18f's BERT launches beside them)
    moe_launches, moe_bert_launches, moe_served = phase_moe(torch,
                                                            bf16_stats)
    for rec in kernels:
        rec["moe_launches"] = moe_launches[rec["name"]]
        if rec["name"] in moe_bert_launches:
            rec["moe_bert_launches"] = moe_bert_launches[rec["name"]]
        if rec["moe_launches"] < 1:
            raise AssertionError(f"the MoE path never launched {rec['name']}")
    torch.cuda.empty_cache()
    clock.lap("phases 14-18")
    with tempfile.TemporaryDirectory(prefix="kft-gangs-") as root:
        # the gangs of phases 17c and 19-24 run first (the pair and the
        # quartet at once); each phase then runs its world 1 and its gates
        # on its gang's reports
        gangs = phase_gangs(torch, root, data={}, seq={}, expert={},
                            pipeline={}, fsdp={}, serve={})
        clock.lap("the gangs of phases 17c and 19-24")
        # 17c: two data-parallel ranks on the one card over gloo
        phase_gang_two_ranks(torch, gangs["data"])
        torch.cuda.empty_cache()
        clock.lap("phase 17c")
        # this slice's path: sequence parallelism (19a ring, 19b Ulysses,
        # 19c a ring rank's block loop at the config's geometry)
        seq_launches = phase_sequence(torch, gangs["seq"])
        for rec in kernels:
            if rec["name"] in seq_launches:
                rec["seq_launches"] = seq_launches[rec["name"]]
                if rec["seq_launches"] < 1:
                    raise AssertionError(f"the sequence-parallel path never "
                                         f"launched {rec['name']}")
        torch.cuda.empty_cache()
        # this slice's path: the expert axis (20a, 20c) and MoE under a
        # sequence axis (20b)
        ep_launches = phase_expert(torch, gangs["expert"])
        for rec in kernels:
            if rec["name"] in ep_launches:
                rec["ep_launches"] = ep_launches[rec["name"]]
                if rec["ep_launches"] < 1:
                    raise AssertionError(f"the expert-parallel path never "
                                         f"launched {rec['name']}")
        torch.cuda.empty_cache()
        # this slice's path: the pipeline axis (21a; 21b and 21c beside it)
        pp_launches = phase_pipeline(torch, gangs["pipeline"])
        torch.cuda.empty_cache()
        # this slice's path: the fsdp axis (23a, 23b; 23c beside them)
        fsdp_launches = phase_fsdp(torch, gangs["fsdp"])
        torch.cuda.empty_cache()
        # this slice's path: the serving mesh (24a-24d), each cell against
        # its 1×1 reference run above
        dense_ref = {"tokens": bf16_stats["traffic"]["tokens"],
                     "kv_pool_bytes": bf16_stats["kv_pool_bytes"],
                     "peak_bytes": bf16_stats["peak_bytes"],
                     "launches": launches}
        served = phase_serving_mesh(torch, gangs["serve"], {
            "24a": dense_ref, "24c": dense_ref,
            "24b": {"tokens": int8_stats["traffic"]["tokens"],
                    "kv_pool_bytes": int8_stats["kv_pool_bytes"],
                    "peak_bytes": int8_stats["peak_bytes"],
                    "launches": int8_launches},
            "24d": moe_served})
    for rec in kernels:
        if rec["name"] in pp_launches:
            rec["pp_launches"] = pp_launches[rec["name"]]
            if rec["pp_launches"] < 1:
                raise AssertionError(f"the pipeline-parallel path never "
                                     f"launched {rec['name']}")
        if rec["name"] in fsdp_launches:
            rec["fsdp_launches"] = fsdp_launches[rec["name"]]
            if rec["fsdp_launches"] < 1:
                raise AssertionError(f"the fsdp path never launched "
                                     f"{rec['name']}")
        if rec["name"].startswith("paged_"):
            rec["mesh_launches"] = {
                cell: rep["launches"][rec["name"]]
                for cell, rep in served.items()
                if rep["launches"].get(rec["name"])}
            if not rec["mesh_launches"]:
                raise AssertionError(f"the serving mesh never launched "
                                     f"{rec['name']}")
    torch.cuda.empty_cache()
    # this slice's path: the job path (22a a StudyJob of GPUTrainJob
    # trials in process, 22b a GPUTrainJob's pods as launcher children)
    job_launches = phase_jobs(torch, layers)
    for rec in kernels:
        if rec["name"] in job_launches:
            rec["job_launches"] = job_launches[rec["name"]]
            if rec["job_launches"] < 1:
                raise AssertionError(f"the job path never launched "
                                     f"{rec['name']}")
    print(f"chip_smoke: the whole run {clock.total():.3f} s (phases 1-24, "
          f"after the interpreter's start)", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--gang-rank"]:
        sys.exit(gang_rank())
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``autodist_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build: the card, ``nvidia-smi``'s name and power limit, and
   the seconds to build every CUDA kernel from ``autodist_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. kernel vs plain: each kernel at the shapes its path gives it, held
   against its plain PyTorch version, with its median device time over
   50 launches (CUDA events, L2 evicted between launches, host launch
   overhead excluded), the plain version's time, one PyTorch library
   call's time and the least time the card could take (bytes over
   3.35 TB/s, or f32 operations over 67 TFLOP/s, whichever is larger;
   for K1–K3 also ``bound_tc_ms``, the operations at 495/3 TFLOP/s, the
   f32-accurate 3xTF32 rate of the tensor cores, and ``vs_library``; for
   K10 ``bound_tc_ms`` at 495/2 TFLOP/s, 2xTF32, since int8 weights are
   exact in TF32).  ``nvcc -Xptxas -v`` runs of the flash, int8 and
   paged-attention sources beside the build give each kernel's
   registers, spills and static shared memory.
   K9 (paged attention) is checked at the engine's decode shape in five
   rel cases at 1e-5, and again on 3 of its 12 heads (``h3_shape``: a
   rank's heads in ``serve_tp``, more splits a head), K10 (int8 matmul) at its eight serving shapes (M 8
   and 512 against the four (K, N) of the model) at rtol 1e-5 / atol
   1e-4, each twice with identical bits; K10's row in the ``kernels``
   line carries every shape with its ``vs_library`` and its top-level
   numbers are the worst shape's.  A ``k10_crossover`` line times K10's
   skinny and tiled kernels against each other at M 1 to 2048.
   The flash kernels K1–K3 are checked at the training shape (B 8, T 1024,
   H 12, D 64, causal), at it with q x 4 (full), at a ragged T = 1000
   (causal and not) and at D = 16: o and lse at rtol/atol 1e-5, dQ/dK/dV
   at 1e-4, and two backward runs must give identical bits; then at the
   ``long_context`` twin's block (B 4, T 512, H 4, D 32, causal and
   not), timed non-causal (the ring's off-diagonal blocks);
3. the slice at full width: ``transformer_lm()`` at its defaults (12
   layers, 12 heads x 64, vocab 32128, random weights from seed 0) served
   by ``serve(..., paged=True)`` over real HTTP after one warm-up pass of
   the same prompts; every answer must equal the port's plain generator
   token for token, and the paged-attention kernel must have been called
   12 times per decode tick (once per layer);
4. the slice in int8: the same weights quantized, a ``PagedDecodeEngine``
   run (after the same warm-up), token-exact against the generator on the
   int8 tree, with the int8 matmul kernel called 73 times per decode
   tick and per prefill dispatch;
5. training at full width: ``AutoDist(strategy_builder=AllReduce())``
   captures ``transformer_lm()`` (attention through K1–K3) with
   ``adamw(1e-3)``; 3 warm-up and 10 timed ``session.run`` steps on one
   fixed batch of 8 x 1024 tokens.  Losses must be finite and fall, each
   step must launch each of K1, K2 and K3 once per layer, and
   ``evaluate`` must add one forward launch per layer and no backward
   launch;
6. training parity: the same facade at full width and depth 2, with the
   flash kernels and with dense attention from the same parameters: 3
   steps whose losses agree at rtol 1e-4;
7. ZeRO-1 training at full width: ``AutoDist(strategy_builder=Zero1())``
   with ``fusable_adam(1e-3)`` and ``numerics={"clip_norm": 1.0}`` on the
   same fixed batch, 3 warm-up and 10 timed steps: the explicit bucketed
   step, its guard through K4 (two launches per bucket per step) and its
   shard update through K5 (one per bucket per step), attention through
   K1–K3.  Losses must be finite and fall, no step may be skipped;
8. ZeRO-1 parity: depth 2 at full width, 3 steps of ``Zero1`` +
   ``fusable_adam`` + clip (K4 and K5) against ``AllReduce`` + ``adam``
   with the same clip (the unfused per-variable guard): losses at rtol
   1e-4, parameters at atol 1e-5; then one step whose loss is multiplied
   by a NaN batch column must be skipped: parameters and optimizer state
   bit-identical, ``skipped_steps`` 1, no K5 launch.
8a. remat at full width (``train_remat``): ``transformer_lm(remat=)``
   under ``train_zero1``'s program (``Zero1`` + ``fusable_adam`` +
   clip), 2 warm-up and 3 timed steps for each of ``REMAT_CONFIGS``
   (``none``, ``full`` and ``dots`` at batch 8; ``dots`` at 16 and 32,
   the batch sweep; ``none`` at 32, the control): ms per step, tokens/s,
   peak memory, ``mfu_f32`` on the model's FLOPs; K1 twice per layer per
   step under ``full``/``dots`` (the backward recomputes the registered
   flash operator), K2/K3 once; at batch 8 ``full`` and ``dots`` end on
   ``none``'s losses and parameters bit for bit (or within rtol 1e-6,
   naming the leaves whose bits differ); and what ``dots`` keeps on the
   card (six ``aten.mm`` outputs a layer, K1 recomputed);
8b. bf16 optimizer state (``train_bf16_state``): ``train_zero1`` with
   ``cast_opt_state(fusable_adam(1e-3))``, 2 + 6 steps: bf16 moments on
   the shards and an int32 count, K5 dropped by the rule (its reason
   printed), K4 twice per bucket, losses finite and falling; the state's
   bytes and ms per step against ``train_zero1``'s;
8c. the model export (``export``): the full-width LM's logits
   ``apply_fn`` (batch 1 x 128 tokens) exported with
   ``SavedModelBuilder`` from card params, f32 and its int8 tree, and
   served by a fresh process that imports the checkpoint package and the
   kernels' operators but not the models: on the card equal to the eager
   forward bit for bit (K1 12 launches; K10 73 on the int8 tree), on the
   CPU at rtol 1e-4 / atol 1e-5; export, load and first-call seconds and
   the artifact's bytes;
8d. the accumulation pipeline (``train_accum``): ``train_zero1``'s program
   at ``accum_steps=4`` (2 rows a microbatch) under ``overlap="none"`` and
   ``"pipeline"``, 1 + 2 steps each: K1–K3 48 a step, K5 once per bucket,
   K4 twice per bucket (once per pipelined bucket, whose reduced value
   is its finiteness source, as in the JAX package); the two end on the
   same losses and parameters bit for bit (or within rtol 1e-6, naming
   the leaves whose bits differ); ms per step, peak memory, tokens/s;
8e. bounded staleness and proxies (``train_stale``): ``PS(staleness=2)``
   + ``fusable_adam`` at full width, 5 steps: the guard off (K4 0, as in
   the JAX package), K5 once per bucket; the first 2 steps leave the
   parameters unchanged, and each later step's shards, moments included,
   equal K5 applied to the delay queue's oldest entry (step t−2's
   gradient) bit for bit; then ``PS(local_proxy_variable=True)`` with
   ``AUTODIST_PROXY_REFRESH=2``, 4 steps: the true shards move every
   step, the compute copy is gathered on steps 2 and 4 only;
9. the facade's default at full width (``train_ps``): ``AutoDist()``
   with no builder must build ``PSLoadBalancing``'s Strategy (every
   variable on PS), which lowers to ``train_zero1``'s bucket plan; with
   ``fusable_adam(1e-3)`` and the clip, 3 warm-up and 10 timed steps
   launching K1–K5 as ``train_zero1`` does, with its losses bit for bit;
10. ``fit`` at full width (``train_fit``): the same model, batch and
   ``AutoDist()`` default with ``fusable_adam(1e-3)`` and ``numerics=
   {"clip_norm": 1.0, "on_nonfinite": "rollback", "rollback_after": 2}``,
   3 steps per epoch, the loss multiplied by a batch column ``s`` (1.0,
   NaN on a poisoned step).  ``fit(epochs=3)`` under ``"skip"`` with
   ``TimeHistory`` (its epoch losses must be ``train_ps``'s losses at
   steps 3, 6 and 9 bit for bit, and each step must launch K1–K5 as a
   ``train_ps`` step does); ``fit(epochs=1, checkpoint_dir=D)``, then a
   new session's ``fit(epochs=3, resume=True)`` must train epochs 2–3
   only and end on the uninterrupted run's epoch losses and parameter
   digest bit for bit; two poisoned steps in epoch 2 must roll back once
   to the verified-good step-3 checkpoint (the parameters right after the
   restore carry that checkpoint's digest), replay and end on the same
   digest; ``on_nonfinite="raise"`` must raise ``NonFiniteError`` at a
   poisoned step.  It prints fit's ms per step under ``skip`` and under
   ``rollback`` (one health read per step), in turns over 10-step epochs,
   against ``train_ps``'s, with ``TimeHistory``'s tokens/s, the
   seconds of a sync save, an async save's blocking part and its whole,
   a deep verify and a restore, and the checkpoint's bytes on disk (in a
   temporary directory, at most two checkpoints at a time);
10a. telemetry (``telemetry``), on ``train_ps``'s program at full width:
   four fresh sessions of 3 + 10 steps, telemetry on, off, off, on
   (``AUTODIST_TELEMETRY=0`` off), each launching K1–K5 as ``train_ps``
   with its losses bit for bit; the "on" runs' 13 StepRecords on disk
   under ``AUTODIST_TELEMETRY_DIR`` with the batch's 8 items and 8192
   tokens; the median ms per step of each mode, their difference and
   the spread between runs of a mode; the host cost of one
   ``autodist_sync/`` span with no profiler active; ``python -m
   autodist_tpu_torch.telemetry <dir> --json`` in a child process (the
   step count and the records' median step time) and ``--export-trace``;
   a trace window (``AUTODIST_TRACE_STEPS=2``): ``LegProfiler.
   parse_trace`` gives one sample per device range, every K4 kernel
   event lies inside a ``fused_pack_detect`` device range and every K5
   one inside ``fused_shard_update``, and the ``autodist_leg_exposed_ms``
   gauge per kind; ``fit`` (2 epochs x 4 steps, a checkpoint):
   ``History.goodput``'s ratio in (0, 1], the records' phases, loss and
   health, the journal's ``goodput/attempt``, ``checkpoint/save`` and
   ``checkpoint/verify``; ``serve(paged=True)`` (K9) answering 4
   requests, ``GET /metrics`` counting them in the latency and TTFT
   histograms, and each request's spans under its trace id.  ``ps_lb``
   (phase 12) traces one more step on rank 0 under ``torch.profiler``:
   each sync leg's device range (the host-staged collectives' copies
   included) parsed once;
10b. planning (``auto``): ``AutoStrategy()``, ``AutoStrategy(search=
   True)`` and ``AutoStrategy(search="beam")`` built for one card and for
   spec-only 4- and 8-card meshes (``hbm_gb`` the card's memory): each
   choice, its build seconds and its schedule IR's fingerprint and
   leg-priced cost (the beam's evaluations, rounds and pruned rule ids);
   the beam's one-card choice through ``create_distributed_session(
   validate=True)``, 3 + 10 steps with ``fusable_adam`` and the clip:
   K1–K3 12 a step, K4 and K5 as the session's schedule IR predicts
   (two K4 per ``fused_detect`` leg, one K5 per ``fused_update`` leg),
   finite and falling losses, ``train_ps``'s losses bit for bit where the
   fingerprints match; ms per step against ``train_ps``'s; the records'
   prediction and the IR-priced one against the measured step; the
   memory pass's watermark against ``max_memory_allocated``; the
   analyzer's and the verifier's seconds; ``fit(validate=True)`` (1 x 2,
   a checkpoint): one fingerprint in every record, the checkpoint meta,
   the session and a second build; an illegal plan (a variable left
   unsynced) refused with ``StrategyValidationError`` and no launch; a
   4-byte ``all_reduce``'s launch latency on a one-rank NCCL group beside
   the cost model's ``COLLECTIVE_ALPHA``, and in units of a trivial
   kernel launch timed just before by the same clock, which must lie
   within 3x of ``ALPHA_PER_LAUNCH`` (a slow host moves both readings;
   a collective grown on the card moves the ratio).  The ring's 4 ranks (phase 12)
   then build ``AutoStrategy(search="beam")`` for 4 cards, validate,
   train 1 + 2 steps with the IR's launches and end bit-identical;
10c. the schedule tuner and its tiers (``tune``), at full width: (a)
   ``LegProfiler.profile_ir`` on ``train_ps``'s IR, one sample per leg,
   the median per leg kind, and ``fit_leg_constants`` on those samples
   and the step records (printed beside the card); (b) ``train_ps``
   under ``AUTODIST_FLIGHTREC=legs``: one step's leg cursors equal the
   IR's stamped legs in order (the leg-cursor kernel launched once per
   stamp), ms per step with legs on and off (median of 10 each), and the
   stall check: a device-side delay (``torch.cuda._sleep``) enqueued
   just before the second bucket's reduce, the cursor read from another
   thread while the device waits must name the first bucket's reduce,
   while the host has enqueued further; (d) ``fit`` with RAM snapshots
   every 2 steps mirrored to a peer directory, 2 steps and the
   uninterrupted 2 more, then a new session resumed from the RAM ring
   and another from the peer directory, each to the same losses and
   parameter digest (snapshot seconds and bytes); (e) implicit capture
   inside ``ad.scope()`` (``optim.adamw``, ``opt.init``,
   ``torch.func.grad_and_value``), 1 + 2 steps bit for bit the explicit
   ``capture()``'s.  The ring's 4 ranks (phase 12) run (c) ``tune_swap``:
   ``AllReduce`` 1 step, the planted all-reduce drift, ``ScheduleTuner.
   maybe_retune`` (rank 0 alone searches), a fingerprint-changing swap
   at an unchanged step, 1 step, K1–K5 each step as each schedule's IR
   predicts, one fingerprint and bit-identical parameters on the 4
   ranks, and an oracle started on the winner from the swap step's
   snapshot matching the swapped run's losses and parameters bit for
   bit (the swap's milliseconds and the snapshot's bytes).  The
   ``kernels`` line gains the leg-cursor kernel (a port-only kernel: the
   JAX package stamps with a host callback), held against the plain
   host stamp;
10d. resilience at full width (``resilience``, one card): (a) the guard
   drill on ``train_ps``'s program with the rollback policy: under
   ``AUTODIST_CHAOS=nan_grad@step=2,bucket=<first bucket>`` K4 flags that
   bucket at step 2, the step is skipped with the parameters
   bit-identical, steps 0–1 and 3 equal a clean run's 0–1 and 2 (K1–K5
   counted: the skip drops one step's K5); ``loss_spike@step=9`` in
   ``fit`` (epochs of 5) rolls back once to step 5 and ends on the clean
   run's step-10 parameters bit for bit; (b) the Supervisor drill: a
   ``Supervisor`` launches ``chip_smoke.py --resilience-worker CKPT HB
   OUT`` (``fit``, 3 epochs of 2 steps, a checkpoint after each, the
   heartbeat and chaos callbacks, ``AUTODIST_FLIGHTREC=legs``): attempt 0
   dies under ``kill@step=3,attempt=0``, attempt 1 blocks under
   ``hang@step=5,attempt=1,leg=<the first bucket's reduce leg>`` and the
   monitor reads it WEDGED within its step timeout, the verdict naming
   the leg, attempt 2 resumes and finishes on the digest of an
   uninterrupted run made here (time to WEDGED, relaunch seconds, each
   attempt's K4/K5/leg-cursor launches);
11. ``Parallax()`` at full width (``train_parallax``): the embedding in a
   reduce-scatter bucket (K5), every other variable in all-reduce buckets
   (the tree update), K4 over all of them; 2 warm-up and 3 timed steps,
   losses within rtol 1e-5 of ``train_ps``'s;
12. the quantized ring (``train_ring``): the script starts itself again as
   4 worker processes on the one card (``--ring-rank R``), joined by a
   gloo group over ``tcp://localhost`` (NCCL refuses two ranks on one
   card; gloo carries the wire bytes through host memory, the kernels
   run on the card in every rank).  Each trains ``transformer_lm()`` at
   full width, 2 rows per rank of the same 8 x 1024 batch, with
   ``AllReduce(compressor="Int8Compressor", overlap="ring")`` + ``adam``
   and then ``Zero1(compressor="Fp8Compressor", overlap="ring")`` +
   ``fusable_adam``, both with ``numerics={"clip_norm": 1.0}``: 1 warm-up
   and 2 timed steps each.  Every step must launch K6 and K8 once and K7
   twice per ring bucket, K4 twice per bucket, K5 once per ZeRO-1 bucket
   and K1–K3 once per layer; every step finite with no saturated wire
   element, its loss within rtol 2e-3 of the one-card f32
   ``train_zero1`` run's at the same step, and every rank's parameters
   bit-identical at the end.  Then, on this rank's embedding gradient
   bucket, the quantized ring reduce-scatter with K6–K8 against the
   unfused ring (the plain torch ops on the card): output and error at
   atol 1e-6, saturation counts equal.  Then each rank trains
   ``PSLoadBalancing()`` (``ps_lb``) with ``fusable_adam`` and the clip,
   1 warm-up and 2 timed steps: each rank's Adam moments are
   ``padded_total / 4`` of every bucket, and the sparse ``embed`` is
   stored 1/4 a rank between steps (its bucket's chunk, gathered at the
   start of each step: ``resident_bytes``, ``stored_1n_bytes`` and the
   drop against the replicated layout, 74,022,912 B within 1 MiB), K5
   launches once per bucket per step (K4 twice, K1–K3 once per layer),
   every rank's parameters (gathered) are bit-identical at the end and
   each step's loss is within rtol 1e-4 of ``train_zero1``'s at the same
   step.  Then each rank runs ``train_p6``
   on ``transformer_lm(num_layers=4)`` at full width with the clip, 1 + 2
   steps each: ``AllReduce`` with ``HorovodCompressor`` and with
   ``PowerSGDCompressor``, ``Zero1`` with ``HorovodCompressorEF``,
   Program E (``HorovodCompressorEF``, fused groups, chunk 2,
   ``accum_steps=2``), ``Zero1`` + ``Int8Compressor`` at ``accum_steps=2``
   under ``overlap="pipeline"`` (one-shot per slot) and ``"full"`` (the
   ring per slot: K6–K8), and ``Zero1(hier=True)`` over 2 slices of 2,
   f32 and with ``AUTODIST_DCN_WIRE=int8``: finite, falling losses, K1–K8
   per step from the plan, every rank's parameters bit-identical, wire
   bytes per rank per step from the plan against an f32 all-reduce's,
   ms per step and peak memory per rank;
12b. elastic resume (``elastic``): after ``ps_lb``'s steps its 4 ranks
   write a Saver checkpoint (``--elastic-dir``; ``embed`` stored 1/4)
   and run 3 more steps (the donor); a one-card ``train_ps`` session
   runs ``preflight_elastic`` and ``elastic_restore``: parameters equal
   the ranks' gathered ones bit for bit, the first ``total`` elements of
   every moment vector bit-exact and the pad zero, the next 3 losses
   within rtol 1e-5 of the donor's with K4/K5 as the schedule IR
   predicts; a checkpoint whose bucket cap drifted raises
   ``ElasticResumeError`` before any read (the reshard's seconds and
   bytes);
12d. the ``seq`` mesh axis, on the same 4 ranks (no new group):
   ``seq_ring`` and ``seq_ulysses`` train ``transformer_lm()`` at full
   width on a ``{"seq": 4}`` mesh (each rank holds 256 of the 1024
   positions of the same 8 rows), ``AllReduce()`` + ``adamw(1e-3)``, 1 +
   1 steps, attention through ``make_ring_attention`` (K1 on the
   diagonal block causal, then on each of 3 blocks shifted around the
   ring, merged in log space; K2/K3 in the backward: 48 each a step a
   rank) and ``make_ulysses_attention`` (two all-to-alls around one K1
   over the whole sequence on 3 heads: 12 each); every rank ends on one
   parameter digest, rank 0's losses within rtol 1e-4 of phase 5's
   one-card flash run (same weights, batch and Adam); ms per step and
   peak memory per rank over its entry (4 host-staged ranks sharing one
   card: not a user's rate).  Then the ``long_context`` twin at
   ``--data-shards 1 --seq-shards 4`` and its own other defaults (seq 2048, head dim 32:
   K1–K3 at D = 32, 8 each a step);
12e. the ``model`` mesh axis, on the same 4 ranks (no new group), 1 + 1
   steps each, ``PartitionedPS()`` + ``fusable_adam(1e-3)`` + the clip
   at full width and :data:`TP_LAYERS` layers: ``tp_ps`` on ``{"data":
   2, "model": 2}`` (default attention: K1–K3 once a layer each a step a
   rank, on the rank's full heads inside the step) and ``tp_seq``,
   Program A's twin, on ``{"model": 2, "seq": 2}`` with
   ``make_ring_attention`` (2 ring blocks a layer); K4 and K5 as the session's schedule IR predicts (its
   per-variable legs included); every rank ends on one digest of the
   gathered parameters, holds exactly half of the logical bytes of its
   model-sharded parameters and moments (the plan's count printed beside
   the measured bytes), and rank 0's losses and global norms are within
   rtol 1e-4 of a one-card ``PartitionedPS()`` run of the same weights, batch and
   optimizer (``tp_reference``, in the main process before the ring);
   ms per step and peak memory per rank over its entry.  Then
   ``flash_model``: ``make_flash_attention(mesh)`` on ``{"model": 4}``
   at [8, 1024, 12, 64], causal: each rank launches K1 once on its 3
   heads and K2/K3 once in the backward of a fixed cotangent; the
   gathered output and dq/dk/dv equal the unsharded one-card K1–K3
   results bit for bit (else within rtol/atol 1e-5, reported);
12f. the ``expert`` mesh axis: ``moe_reference`` in the main process
   after ``tp_reference``: ``moe_transformer_lm()`` at the JAX widths
   (vocab 32128, 12 x 64 heads, d_ff 3072, 8 experts, seq 1024, random
   weights from seed 0) and :data:`MOE_LAYERS` layers with its attention
   through K1–K3, batch 8, ``PSLoadBalancing()`` + ``fusable_adam(1e-3)``
   + the clip, 1 + 3 steps: K1–K3 once a layer each a step, K4/K5 as the
   schedule IR
   predicts, finite falling losses, ``grad_health`` finite; ms per step,
   tokens/s, peak memory and ``mfu_f32`` over :func:`moe_flops_per_step`
   (the one-hot dispatch and combine einsums counted).  Last on the ring
   ranks, ``moe_ffn_ep``: ``moe_ffn(mesh=)`` on ``{"expert": 4}`` with 2
   of 8 experts a rank at the LM's layer shape (8 x 1024 x 768, d_ff
   3072), forward and backward, against the one-card call within
   rtol/atol 1e-5, and the int8 wire's exact construction (d_model 256,
   identity experts) bit for bit; then ``moe_ep``: the reference's
   program on ``{"data": 2, "expert": 2}``, 1 + 1 steps, K1–K3 once a
   layer a step a rank, K4/K5 as the IR predicts, one digest, each rank holding
   exactly half of every expert stack's bytes and of their moments, rank
   0's losses and global norms within rtol 1e-4 of ``moe_reference``'s
   first; ms per step and peak memory per rank over its entry;
12g. the ``pipe`` mesh axis: ``pipe_reference`` in the main process after
   ``moe_reference``: ``pipelined_transformer_lm()`` at the JAX widths
   (vocab 32128, 12 x 64 heads, d_ff 3072, seq 1024) and
   :data:`PIPE_LAYERS` layers at pipe 1 with its attention through K1–K3,
   batch 8, ``PSLoadBalancing()`` + ``fusable_adam(1e-3)`` + the clip, 1
   + 3 steps (K1–K3 once a layer a step, K4/K5 as the IR predicts; ms per
   step, tokens/s, peak, ``mfu_f32``), the
   check that the 1F1B spec's stack is the same draw stored device-major,
   and the pipelined MoE LM at :data:`PIPE_MOE_LAYERS` layers (full
   width, 8 experts) at pipe 1,
   1 + 1 steps.  Last on the ring ranks: ``pipe_gpipe``, the reference's
   program on ``{"pipe": 4}``, M = 8; ``pipe_1f1b``, interleaved 1F1B (V
   = 2) through ``capture(grad_fn=)`` on ``{"pipe": 2, "data": 2}``, M = 4
   a data shard; ``pipe_moe``, the MoE LM on ``{"pipe": 2, "expert": 2}``,
   M = 8; each 1 + 1 steps, K1–K3 a step a rank as :data:`PIPE_FLASH`
   says (a rank computes only on the ticks where it holds a microbatch),
   K4/K5 as the IR predicts, one digest, each rank holding exactly its
   plan's share of every stage stack and of its moments (1/4, 1/2, and
   1/4 of the expert stacks), rank 0's losses and global norms within
   rtol 1e-4 of the one-card references'; then the 1F1B twin
   (``examples_torch/pipeline_1f1b.py``) once, its losses equal on every
   rank; then the engines' meshes, last on the ring ranks:
   ``serve_tp``, phase 3's requests through ``PagedDecodeEngine`` on
   ``{"model": 4}`` (each rank's K and V pools hold 3 of the 12 heads,
   170,459,136 of 681,836,544 B; K9 12 a decode tick a rank on its 3
   heads, the heads gathered after it; the logits' largest difference
   from one decode tick over all 12 heads on the same pools), and
   ``serve_slots``, Program G's twin at full width: the slot engine at
   ``SLOT_GEOM`` on ``{"data": 4}`` (2 of the 8 slots a rank,
   150,994,944 of 603,979,776 B of K and V), Program G's 8 requests and
   its prefix pass with mixed ``use_prefix``; every rank's tokens equal
   the plain generator's (checked in the serving slice, phase 15);
12h. the MPMD pipeline runtime (``mpmd``), after the ring: the
   full-width LM's 12 blocks as two stage programs (6 blocks each; the
   embedding, the position table and the final norm frozen and closed
   over by the first stage's function and the last stage's loss), each
   stage its own world of 2 gloo ranks (``chip_smoke.py --mpmd-worker``
   processes), batch 8 (4 one-row microbatches a rank), ZeRO-1 SGD inside
   a stage, 3 steps, the activations staged through a transport
   directory; a clean job and a chaos job (stage 1's rank 0 killed after
   step 1, the stage-1 world relaunched by its ``Supervisor``) run at once
   beside the same program at data size 1 in this process: the clean
   job's losses within rtol 1e-5 of it, one digest per stage world, one
   schedule fingerprint everywhere (``build_pipeline_ir``'s), K1–K3 24 a
   step a rank, K4/K5 none, the chaos job's losses and parameters the
   clean job's bit for bit;
12c. the supervised replica pool (``router``): ``SupervisedReplicaPool(2)``
   of ``chip_smoke.py --replica`` processes (the full-width paged
   server, K9) behind ``Router(recover=True)``; 8 concurrent greedy
   requests of different lengths while ``kill_replica@replica=0,
   tokens=5`` SIGKILLs replica 0 mid-decode: every output equals the
   plain generator's, at least one ``recovered``; the pool relaunches
   replica 0; ``POST /admin/drain`` on replica 1 takes it out of
   rotation without a mark-down; ``rolling_restart`` under load drops no
   request; the survivor's K9 is 12 per decode tick (the recovery's
   extra ms against the healed pool, the relaunch and drain seconds);
13. the BASELINE models (BASELINE.json), each at the repo's defaults, f32,
   weights from ``SEED``, batch 32 (the JAX examples' ``--batch-size``),
   through the facade under its BASELINE builder, 2 warm-up and 5 timed
   steps, losses finite and ``session.params`` shaped as the init tree,
   ms per step, items per second, peak memory and ``mfu_f32`` from a FLOP
   count of the model's shapes: ``train_resnet50`` (224x224,
   ``AllReduce()``, ``sgd(1e-3, momentum=0.9)``: K1–K5 launch zero times;
   cuDNN's share of device time from ``profile_train``'s profile);
   ``train_vgg16`` (``PartitionedPS()``, the same sgd, the clip: K4 twice
   per bucket, ``fc1`` in a bucket of its own, no K5 and a warning that
   the shards take the unfused update); ``train_bert`` (``bert_base()``,
   seq 128, ``PartitionedAR()``, ``adamw(1e-3)``: K1/K2/K3 non-causal 12
   each per step, 12/0/0 in ``evaluate``) and ``train_bert_parity`` (a
   depth-2 copy, flash vs dense attention from the same weights, 3 steps,
   losses at rtol 1e-4); ``train_lm1b`` (vocabulary 793472, the chunked
   loss, ``Parallax()``, ``fusable_adam(1e-3)``, the clip: each table in a
   reduce-scatter bucket of its own, everything else all-reduce, K5 twice
   and K4 twice per bucket per step, words per second = batch x seq_len
   over the step, peak memory under ``LM1B_PEAK_BYTES``);
14. the rest of the model zoo, each printing its device busy time, idle
   share and kernel groups from ``profile_train``'s profile, and
   ``session.flops_per_step()``/``session.mfu()`` beside its written-out
   FLOP count: ``train_ncf`` (``ncf()`` at its defaults, batch
   ``NCF_BATCH`` = 4096, BASELINE's NCF config: ``PSLoadBalancing()``,
   ``fusable_adam(1e-3)``, the clip; the bucket plan must be the one
   ``tests/test_torch_models.py`` pins to the JAX planner's, K4 twice and
   K5 once per bucket per step, losses falling; samples per second),
   ``train_densenet121`` (224x224) and ``train_inception_v3`` (299x299),
   both as ``imagenet.py`` runs them by default (``AllReduce()``,
   ``sgd(1e-3, momentum=0.9)``, batch 32) with no kernel of K1–K10
   launched.  Every phase's launch check counts K1–K10.
15. the rest of serving at full width, last (after a fresh init of
   phase 3's model, so no earlier phase runs after its engines and
   profiles): ``serve_slot``, ``serve(spec,
   params)``'s default slot ``DecodeEngine`` (8 slots, window 1024) over
   real HTTP with phase 3's seven requests (the shared prefix registered
   with ``prefix_tokens``, a streamed and a 700-token request) after a
   warm-up pass, on the f32 tree and on an int8 tree of the same widths
   cut to ``SLOT_INT8_LAYERS`` layers (its generator oracle, token by
   token, is most of the slice's time): token-exact against the
   generator, K10 ``6 * layers + 1`` times per decode tick and prefill
   dispatch on int8 (0 on f32, K9 0), ms per tick, decode and prefill
   tokens/s, and a profile of 16 decode ticks with every slot live (host
   wall against device busy per tick); ``beam_score`` (batch 2, a
   16-token prompt, 32 new tokens): ``beam_search(num_beams=1)`` equal to
   greedy, width 4 finite, ``score`` (K1 once per layer) within rtol 1e-4
   of the teacher-forced decode logits' log-softmax sum; ``spec``: the
   speculative generator (gamma 4, batch 2 x 16, 48 new tokens) and
   ``serve(speculative=...)`` (the paged engine, gamma 4 adaptive, three
   HTTP requests), each with the target itself as draft (acceptance at
   least 0.95) and a 2-layer draft of the same widths from another seed,
   all token-exact against target-only greedy, K9 once per draft layer
   per draft tick (the verify is the paged prefill program); acceptance,
   tokens/s, K9 per round; ``tokenizer``: a ``BPETokenizer`` trained here
   on generated text (512 merges and ``<eos>``, padded with reserved
   tokens to the model's vocabulary), ``serve(tokenizer=,
   prefix_text=)``: ``{"prompt": text}`` answers ``text`` whose tokens
   are the generator's on ``encode(text)``; ``lora``: ``lora_setup``
   (rank 8, attention and MLP kernels) through the facade (``AllReduce``,
   adam), 2 + 3 steps with K1–K3 12 each a step, losses falling, the
   base bit-identical, the merged tree served by ``serve()`` token-exact.
   Each prints its ``wall_s``; the ``kernels`` line their sum,
   ``serving_slice_s``.  Last, ``examples``: every twin of the JAX
   example scripts under ``examples_torch/`` through its ``main`` on the
   card (the benchmark twins at their full-width defaults for 3 timed
   steps, the demos at theirs; :data:`EXAMPLE_TWINS`), its own asserts
   holding, one line each with its seconds, rate and kernel launches
   (BERT-base's K1–K3; none of K1 and K9 in the dense-attention demos);
   the ``kernels`` line adds their launches by path and their sum,
   ``examples_s``.

K1–K3 are also checked and timed at BERT-base's shape (B 32, T 128, H 12,
D 64, non-causal; SDPA with ``is_causal=False``; the ``<64, full>``
instantiation's ``ptxas`` line), and K4/K5 at one of lm1b's tables
(406,257,664 elements, 20 timed launches): rows beside the others, under
``bert_shape`` and ``lm1b_bucket`` in the ``kernels`` line.

``python3 chip_smoke.py --ring-repeat N`` builds the kernels and runs only
``train_ring`` (with ``ps_lb`` and ``train_p6``) N times, one line per run
(whether the ranks' parameter digests agreed in every configuration, or
which parameters differed) and a count of the runs that diverged; it
exits 1 when one did, and stops at any other failure.

``python3 chip_smoke.py --moe`` builds the kernels and runs only
``moe_reference`` and the ring's ``moe_ffn_ep`` and ``moe_ep``.

``python3 chip_smoke.py --collective-alpha`` measures only the launch
latency of one collective (the cost model's ``COLLECTIVE_ALPHA``) and of
a trivial kernel, and their ratio, which the ``auto`` phase's gate
holds.

``python3 chip_smoke.py --resilience`` builds the kernels and runs only
the ``resilience``, ``elastic`` (the ring's ranks in mode ``elastic``:
``ps_lb`` alone) and ``router`` phases.

``python3 chip_smoke.py --tune`` builds the kernels and runs only the
``tune`` phase and the ring's ``tune_swap``; ``python3 chip_smoke.py
--tune-predict`` runs ``tune_swap``'s re-search on ``meta`` tensors on
the CPU (no card) and prints its winner.

``python3 chip_smoke.py --p6-lr-control`` builds the kernels and, on the
ring's 4 ranks, prints rank 0's loss traces of ``train_p6``'s model and
batch under ``AllReduce()`` (f32 wire) and ``AllReduce(compressor=
"HorovodCompressor")`` (bf16 wire), with ``adam`` at 1e-3 and at
``train_p6``'s learning rate, 7 steps each: the control that tells a
defect of the bf16 wire from Adam's own overshoot at 1e-3.

K4 (guard statistics) and K5 (fused Adam) join phase 2 at the ZeRO-1
path's bucket sizes (24,674,304, 2,359,296 and 589,824 elements, and a
ragged 1,000,003): K4's count exactly, its sum of squares at rtol 1e-6 of
an f64 sum, NaN/+Inf/-Inf counted once and poisoning the sum, the same
bits twice; K5 over three steps (multipliers 1.0, 0.25, 1.0) at atol 1e-6
on p, m and v.  K6–K8 (the quantized ring's hop kernels) join it at the
ring's chunk sizes at 4 ranks (6,168,576, 589,824 and 147,456 elements,
and a ragged 1,000,003), int8 and fp8, on standard normal x 3 inputs and
a copy poisoned with +Inf, NaN and -Inf: the payload bit-equal to the
plain version's (NaN as NaN), the scales equal, the error and K8's output
at atol 1e-6, the saturation counts equal (at least 3 when poisoned), the
same bits twice.

Then one JSON line with every kernel's numbers (``launches`` counts the
wrapper's calls that launched its C entry point on the kernel's own path:
serving for K9 and K10, the 13 training steps for K1–K3 (``train_bert``'s
under ``bert_shape``, ``train_fit``'s in ``launches_by_path``), the 13
ZeRO-1 steps for K4 and K5, with their launches on ``train_ps``,
``train_fit``, ``train_remat``'s configurations (K1–K5),
``train_bf16_state`` (K1–K5), the export's serving process (K1, K10),
``train_parallax``, rank 0's ``ps_lb``, ``moe_reference`` and rank 0's
``moe_ep`` (K1–K5), ``pipe_reference``, its MoE reference, rank 0's
``pipe_gpipe``, ``pipe_1f1b``, ``pipe_moe`` and the 1F1B twin (K1–K5),
each clean ``mpmd`` rank (K1–K3), rank 0's ``serve_tp`` (K9),
``train_accum``, ``train_stale``,
rank 0's ``train_p6`` configurations (K1–K8), ``train_vgg16``,
``train_lm1b`` and ``train_ncf`` in ``launches_by_path``, rank 0's 6
quantized-ring
steps for K6–K8; each
such call issues one kernel, or two where the work is split and then
merged), the ``nvidia-smi`` line, and last ``{"ok": true, "device":
{...}}``.  Any failed check raises and the exit code is not 0; without a
CUDA device, or without the package beside this script, it exits 2 and
prints no result.
"""
import hashlib
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

SEED = 0
#: the interface the ring ranks' gloo pairs use
LOOPBACK = "lo"
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12         # TF32 tensor cores, dense (data sheet, SXM)
#: f32-accurate 3xTF32 (K1–K3): three TF32 products per f32 product
H100_3XTF32_FLOPS = H100_TF32_FLOPS / 3
#: K10 (int8 weights exact in TF32, x split in two): two TF32 products
H100_2XTF32_FLOPS = H100_TF32_FLOPS / 2
K9_SOURCE = "autodist_tpu_torch/csrc/paged_attention.cu"
K9_REPLACES = "autodist_tpu/ops/fused_kernels.py:624"
K10_SOURCE = "autodist_tpu_torch/csrc/int8_matmul.cu"
K10_REPLACES = "autodist_tpu/ops/quant.py:74"
#: K10's (K, N) on the serving path: q/k/v/o, the MLP's two kernels, the
#: tied head; each at decode (M 8) and prefill (M 512)
K10_SHAPES = ((768, 768), (768, 3072), (3072, 768), (768, 32128))
K10_CROSSOVER_M = (1, 8, 16, 17, 32, 64, 256, 512, 2048)
FLASH_SOURCE = "autodist_tpu_torch/csrc/flash_attention.cu"
#: sources whose kernels' registers and spills the ptxas lines report
PTXAS_SOURCES = ("flash_attention.cu", "int8_matmul.cu",
                 "paged_attention.cu")
FLASH_REPLACES = {"flash_fwd": "autodist_tpu/ops/flash_attention.py:56",
                  "flash_dq": "autodist_tpu/ops/flash_attention.py:141",
                  "flash_dkv": "autodist_tpu/ops/flash_attention.py:183"}
SYNC_SOURCE = "autodist_tpu_torch/csrc/fused_sync.cu"
SYNC_REPLACES = {"detect_stats": "autodist_tpu/ops/fused_kernels.py:219",
                 "adam_update": "autodist_tpu/ops/fused_kernels.py:365"}
#: the ZeRO-1 path's bucket sizes (the embedding's, a block's two MLP
#: kernels, four attention projections) and a ragged size
SYNC_SIZES = (24_674_304, 2_359_296, 589_824, 1_000_003)
QUANT_SOURCE = "autodist_tpu_torch/csrc/quant_hop.cu"
QUANT_REPLACES = {
    "quant_hop_quantize": "autodist_tpu/ops/fused_kernels.py:493",
    "quant_hop_accumulate": "autodist_tpu/ops/fused_kernels.py:501",
    "quant_hop_dequant_add": "autodist_tpu/ops/fused_kernels.py:513"}
#: the quantized ring's chunks at 4 ranks (the embedding's, an MLP
#: kernel's, an attention projection's) and a ragged size
QUANT_SIZES = (6_168_576, 589_824, 147_456, 1_000_003)
RING_RANKS = 4
#: the train_ring phase's configurations, in the order they run
RING_CONFIGS = ("int8_allreduce", "fp8_zero1")
#: the 4-rank run of the facade's default builder, after the ring configs
PS_LB_CONFIG = "ps_lb"
#: (cut from 2 + 5, then from 1 + 2, to keep the script's time with
#: train_p6 and then the resilience phases)
RING_WARMUP, RING_TIMED = 1, 1
#: the 4-rank run of ``AutoStrategy(search="beam")`` on a 4-chip spec,
#: after ``train_p6`` (the ``auto`` phase's sixth check)
AUTO_RING_CONFIG = "auto_beam"
#: each ring step's loss against the one-card f32 ``train_zero1`` run's at
#: the same step (same init, batch, Adam and clip): quantization noise only
#: the seq configurations' steps (against phase 5's first 2; cut from
#: 1 + 2 to keep the script's time)
SEQ_WARMUP, SEQ_TIMED = 1, 1
#: the seq axis's ring configurations (after ``tune_swap``), K1, K2 and K3
#: each per step per rank: 4 ring steps x 12 layers, one per layer
SEQ_CONFIGS = ("seq_ring", "seq_ulysses")
SEQ_LAUNCHES = {"seq_ring": 48, "seq_ulysses": 12}
#: rank 0's seq losses against phase 5's one-card flash run's
SEQ_LOSS_RTOL = 1e-4
#: the model axis's ring configurations (after ``long_context``): mesh,
#: depth (full width, :data:`TP_LAYERS` layers: cut from 12 for time
#: only), K1–K3 each per step per rank (one per layer, x 2 ring blocks on
#: seq), the steps, and rank 0's losses and global norms against the
#: one-card ``tp_reference``'s
TP_CONFIGS = ("tp_ps", "tp_seq")
TP_AXES = {"tp_ps": {"data": 2, "model": 2},
           "tp_seq": {"model": 2, "seq": 2}}
TP_LAYERS = 8
TP_FLASH = {"tp_ps": TP_LAYERS, "tp_seq": 2 * TP_LAYERS}
TP_WARMUP, TP_TIMED = 1, 1
TP_LOSS_RTOL = 1e-4
#: ``make_flash_attention(mesh)`` over the model axis: the mesh, the
#: shape (``transformer_lm()``'s attention at batch 8), the tolerance
#: that holds when the gathered result is not bit-equal to one card's
FLASH_MODEL = "flash_model"
FLASH_MODEL_AXES = {"model": 4}
FLASH_MODEL_TOL = 1e-5
#: the expert axis: the MoE LM's depth (full width, cut from 12 layers
#: for time only), the one-card MoE reference's steps (its first 1 + 1
#: losses hold ``moe_ep``'s), the ring configuration's mesh and steps,
#: rank 0's losses and global norms against the reference's, and
#: ``moe_ffn_ep``'s mesh, tolerance and int8 construction (d_model 256,
#: identity experts, integer tokens with every block's amax 127)
MOE_LAYERS = 8
MOE_REF_WARMUP, MOE_REF_TIMED = 1, 3
MOE_EP = "moe_ep"
MOE_EP_AXES = {"data": 2, "expert": 2}
MOE_EP_WARMUP, MOE_EP_TIMED = 1, 1
MOE_LOSS_RTOL = 1e-4
MOE_FFN_EP = "moe_ffn_ep"
MOE_FFN_AXES = {"expert": 4}
MOE_FFN_TOL = 1e-5
MOE_EXACT = dict(g=8, s=8, m=256, e=8)
#: the pipe axis: the ring configurations, their meshes, microbatches and
#: K1–K3 a step a rank (a rank computes only on the ticks where it holds
#: a microbatch: L/4 layers x 8 microbatches under GPipe on ``{"pipe":
#: 4}``; L/2 layers x 4 microbatches forward and again in the 1F1B
#: recompute, one backward, on ``{"pipe": 2, "data": 2}``; L'/2 layers
#: x 8 under the MoE GPipe on ``{"pipe": 2, "expert": 2}``), the one-card
#: reference's steps (its first 1 + 1 losses hold the ring's), the depths
#: L of the pipelined LM and L' of the pipelined MoE LM (full width; cut
#: from 12 for time only), and the 1F1B twin's arguments on the ring
#: ranks (``tests/test_examples.py``'s)
PIPE_GPIPE, PIPE_1F1B, PIPE_MOE = "pipe_gpipe", "pipe_1f1b", "pipe_moe"
PIPE_CONFIGS = (PIPE_GPIPE, PIPE_1F1B, PIPE_MOE)
PIPE_AXES = {PIPE_GPIPE: {"pipe": 4}, PIPE_1F1B: {"pipe": 2, "data": 2},
             PIPE_MOE: {"pipe": 2, "expert": 2}}
PIPE_MICROBATCHES = {PIPE_GPIPE: 8, PIPE_1F1B: 4, PIPE_MOE: 8}
PIPE_LAYERS, PIPE_MOE_LAYERS = 8, 4
PIPE_FLASH = {PIPE_GPIPE: (PIPE_LAYERS // 4 * 8,) * 3,
              PIPE_1F1B: (PIPE_LAYERS * 4,) + (PIPE_LAYERS // 2 * 4,) * 2,
              PIPE_MOE: (PIPE_MOE_LAYERS // 2 * 8,) * 3}
PIPE_REF_WARMUP, PIPE_REF_TIMED = 1, 3
PIPE_WARMUP, PIPE_TIMED = 1, 1
PIPE_LOSS_RTOL = 1e-4
PIPE_TWIN = "pipeline_1f1b"
PIPE_TWIN_ARGS = ("--pipe", "2", "--data-shards", "2", "--virtual-stages",
                  "2", "--num-layers", "4", "--seq-len", "16",
                  "--batch-size", "8", "--steps", "3")
#: the MPMD pipeline runtime (``mpmd``): 2 stage worlds of 2 gloo ranks
#: each on the card, the full-width LM's blocks split 6 a stage, global
#: batch 8 (4 one-row microbatches a DP rank), ZeRO-1 SGD within a stage;
#: K1–K3 a step a rank (6 blocks x 4 microbatches, no recompute); the
#: chaos job kills stage 1's rank 0 after step 1 (its first attempt
#: only) and a Supervisor relaunches that stage's group
MPMD_STAGES, MPMD_DP, MPMD_MICRO, MPMD_BATCH = 2, 2, 4, 8
MPMD_LAYERS, MPMD_STEPS, MPMD_LR = 12, 3, 0.05
MPMD_FLASH = 24
MPMD_BUCKET_BYTES = 1 << 25
MPMD_LOSS_RTOL = 1e-5
MPMD_CHAOS = "kill@step=1,proc=0,attempt=0,stage=1"
MPMD_TIMEOUT_S = 600
#: the engines' meshes on the ring ranks: the paged engine's pools over
#: ``{"model": 4}`` (K9 on 12 / 4 heads, 12 launches a decode tick a
#: rank) and the slot engine's slots over ``{"data": 4}`` (Program G's
#: requests); each rank's share of the K and V memory
SERVE_TP, SERVE_SLOTS = "serve_tp", "serve_slots"
SERVE_TP_AXES, SERVE_SLOTS_AXES = {"model": 4}, {"data": 4}
SERVE_TP_POOL_BYTES = (170_459_136, 681_836_544)
SERVE_SLOTS_CACHE_BYTES = (150_994_944, 603_979_776)
#: ``serve_slots``' sampled pass: the engine-wide knobs, the generator's
#: seed and Program G's requests' temperatures in turn (one greedy); the
#: ranks' tokens must equal the one-card engine's under that generator
SERVE_SLOTS_SAMPLED = dict(temperature=1.0, top_k=40)
SERVE_SLOTS_SAMPLE_SEED = 11
SERVE_SLOTS_TEMPS = (1.0, 0.7, 0.0, 1.3)
#: the ``long_context`` twin on the ring ranks, and its K1–K3 a step (2
#: layers x 4 ring blocks) over its 3 warm-up, 1 + 19 timed and 1 closing
#: steps (``benchmark.common.run_benchmark``'s defaults)
LONG_CONTEXT_ARGS = ("--data-shards", "1", "--seq-shards", "4")
LONG_CONTEXT_LAUNCHES = 8 * 24
#: the twin's local block at ``--seq-shards 4`` (seq 2048, batch 4, 4 x 32
#: heads): K1–K3 at D = 32
LONG_SHAPE = dict(B=4, T=512, H=4, D=32)
#: the ``train_fit`` loader drill: rows of the token set, epochs; the
#: preemption after this many steps (mid-epoch 1); rows timed for the
#: loader's batches per second
FIT_LOADER_ROWS, FIT_LOADER_EPOCHS, FIT_LOADER_PREEMPT = 16, 2, 3
LOADER_RATE_ROWS = 512
#: the tune phase: the ring configuration of the 4-rank swap drill
TUNE_RING_CONFIG = "tune_swap"
#: steps before and after the swap (and the oracle's; cut from 3)
TUNE_DRILL_STEPS = 1
#: steps of each legs-on / legs-off median (cut from 10)
TUNE_LEG_STEPS = 5
#: cycles of the device-side delay of the stall check (~1 s on the H100)
TUNE_SLEEP_CYCLES = 2_000_000_000
#: the tiers drill: epochs x steps per epoch before the stop, snapshot
#: every 2 steps
TUNE_FIT_EPOCHS, TUNE_FIT_STEPS, TUNE_SNAPSHOT_EVERY = 1, 2, 2
#: rounds of the drill's re-search (its winner is one move from a seed)
TUNE_SEARCH_ROUNDS = 1
#: the leg-cursor kernel (not a TPU kernel: the JAX package's leg cursor
#: is a host callback)
LEG_CURSOR_SOURCE = "autodist_tpu_torch/csrc/leg_cursor.cu"
LEG_CURSOR_REPLACES = ("autodist_tpu/telemetry/flightrec.py:328 "
                       "(traced_stamp, a host callback: no TPU kernel)")
RING_LOSS_RTOL = 2e-3
RING_TIMEOUT_S = 600
CLIP_NORM = 1.0
TRAIN_SHAPE = dict(B=8, T=1024, H=12, D=64)   # transformer_lm() at batch 8
WARMUP_STEPS, TIMED_STEPS = 3, 10
#: the ``train_parallax`` phase: its steps, and its losses against
#: ``train_ps``'s (the same model, batch and Adam; the dense variables take
#: the tree update where ``train_ps`` runs K5)
PARALLAX_WARMUP, PARALLAX_TIMED = 2, 3
PARALLAX_LOSS_RTOL = 1e-5
#: the ``auto`` phase: AutoStrategy's search modes (name, ``search=``), the
#: spec-only meshes' chip counts, the beam choice's steps, the ``fit``
#: epoch's steps
AUTO_MODES = (("heuristic", False), ("rank", True), ("beam", "beam"))
AUTO_SPEC_CHIPS = (4, 8)
AUTO_WARMUP, AUTO_TIMED = 3, 10
AUTO_FIT_STEPS = 2
#: the ``train_fit`` phase: steps per epoch, epochs, and the rollback
#: policy's streak of non-finite steps
FIT_STEPS_PER_EPOCH, FIT_EPOCHS, FIT_ROLLBACK_AFTER = 3, 3, 2
#: the steps of each timed ``fit`` epoch (``skip`` and ``rollback`` in
#: turns; cut from 10)
FIT_TIMED_STEPS = 5
#: the ``telemetry`` phase: telemetry on and off in turns (on, off, off,
#: on), each a fresh session of ``train_ps``'s program for ``WARMUP_STEPS``
#: + ``TIMED_STEPS``; the trace window's steps; ``fit``'s epochs x steps;
#: the requests to the paged server and their new tokens
TELEMETRY_ORDER = ("on", "off", "off", "on")
TELEMETRY_TRACE_STEPS = 2
TELEMETRY_FIT = (2, 4)
TELEMETRY_REQUESTS, TELEMETRY_NEW_TOKENS = 4, 16
#: the CUDA symbols of K4's and K5's kernels, and the ``autodist_sync/``
#: ranges each must lie in on the card
TELEMETRY_KERNEL_RANGES = {"detect_stats": "fused_pack_detect/",
                           "adam_update": "fused_shard_update"}
#: the 4-rank ``ps_lb`` run's losses against the one-card ``train_zero1``
#: run's (the JAX package's case-matrix tolerance)
PS_LB_LOSS_RTOL = 1e-4
#: ``ps_lb``: what a rank no longer holds between steps, ``embed`` (32128
#: x 768 f32, the sparse table ``PSLoadBalancing`` stores 1/4 per rank):
#: 3/4 of its bytes, held within :data:`PS_LB_DROP_TOL`
PS_LB_DROP_BYTES = 74_022_912
PS_LB_DROP_TOL = 1 << 20
#: the ``examples`` phase: each twin under ``examples_torch/`` by module,
#: with its arguments: the benchmark twins at their full-width defaults
#: (ResNet-50 at 224 and batch 32, BERT-base at seq 128, NCF, lm1b at vocab
#: 793472 under ``Parallax``) for 3 timed steps after 1 of warmup, the
#: demos at their own defaults
EXAMPLE_TWINS = (
    ("linear_regression", ()),
    ("image_classifier", ()),
    ("benchmark.imagenet", ("--model", "resnet50", "--image-size", "224",
                            "--batch-size", "32", "--steps", "3",
                            "--warmup", "1")),
    ("benchmark.bert", ("--size", "base", "--seq-len", "128", "--steps",
                        "3", "--warmup", "1")),
    ("benchmark.ncf", ("--steps", "3", "--warmup", "1")),
    ("lm1b.lm1b_train", ("--steps", "3", "--warmup", "1")),
    ("generate_text", ()),
    ("sentiment_classifier", ()),
    ("lora_finetune", ()),
    ("serving_engine", ()),
    ("serve_http", ()),
    ("speculative_draft", ()),
    ("input_pipeline", ()),
    ("implicit_capture", ()),
)
#: the twins whose JAX scripts pass ``dense_attention``: no K1, no K9
EXAMPLE_DENSE = ("generate_text", "lora_finetune", "serving_engine",
                 "speculative_draft")
SERVE_GEOM = dict(slots=8, window=1024, block_size=32, chunk=16,
                  prefill_chunk=256)
#: the BASELINE models' phases: the JAX examples' ``--batch-size``, steps
MODEL_BATCH = 32
MODEL_WARMUP, MODEL_TIMED = 2, 5
#: K1–K3 at BERT-base's shape (batch 32, seq 128, 12 heads of 64), non-causal
BERT_SHAPE = dict(B=32, T=128, H=12, D=64)
#: the depth-2 BERT copy's flash-vs-dense losses (the train-parity phase's)
BERT_PARITY_RTOL = 1e-4
#: one of lm1b's two 793472 x 512 tables: K4 and K5's largest bucket
LM1B_TABLE = 793_472 * 512
#: the ceiling predicted for ``train_lm1b``'s peak memory (PERF.md's
#: prediction for the BASELINE models)
LM1B_PEAK_BYTES = 26e9
#: NCF's batch (BASELINE.md's NCF row: batch 4096, PSLoadBalancing, Adam)
NCF_BATCH = 4096
#: ``ncf()``'s plan under ``PSLoadBalancing`` on one card: its buckets and
#: the :func:`_plan_digest` that ``tests/test_torch_models.py`` pins to
#: the JAX planner's plan
NCF_BUCKETS = 6
#: ``train_remat``: (policy, batch) per configuration, in the order they
#: run (docs/performance.md's batch sweep of ``remat="dots"`` and the
#: batch-32 control without remat), and the steps of each
REMAT_CONFIGS = (("none", 8), ("full", 8), ("dots", 8), ("dots", 16),
                 ("dots", 32), ("none", 32))
#: (timed steps cut from 5 in PR 13 to keep the script's time)
REMAT_WARMUP, REMAT_TIMED = 2, 3
#: remat's losses and parameters against the run without it, where the
#: bits differ (the JAX package's remat gradient tolerance)
REMAT_RTOL = 1e-6
#: ``train_bf16_state``'s steps: 8, as step 7 of this model, batch and
#: Adam is a spike that step 8 takes back (``train_zero1``'s losses)
BF16_WARMUP, BF16_TIMED = 2, 6
#: ``export``: the prompt (batch 1 x 128 tokens) and the tolerance of
#: the CPU serving against the CPU eager forward and of the card against
#: the float64 forward (the JAX package's saved-model test's)
EXPORT_TOKENS = (1, 128)
#: the exported trees: the f32 weights and their int8 tree
EXPORT_TREES = ("f32", "int8")
EXPORT_RTOL, EXPORT_ATOL = 1e-4, 1e-5
NCF_PLAN_SHA256 = ("820c3fa12b770e87d0984651ee7e0d4c"
                   "72476256521595a6d4f8d6ca9b7ecfc0")
#: ``train_accum``: microbatches per step (batch 8: 2 rows each), steps,
#: and the pipeline's losses and parameters against ``overlap="none"``
#: where their bits differ
ACCUM_STEPS = 4
ACCUM_WARMUP, ACCUM_TIMED = 1, 2
ACCUM_RTOL = 1e-6
#: ``train_stale``: ``PS(staleness=STALE_DEPTH)``'s steps; the proxy
#: run's refresh period and steps
STALE_DEPTH, STALE_STEPS = 2, 5
PROXY_REFRESH, PROXY_STEPS = 2, 4
#: ``train_p6``: the P6 options on the ring's 4 ranks, ``transformer_lm()``
#: at full width and P6_LAYERS layers, in the order they run
P6_LAYERS = 4
P6_WARMUP, P6_TIMED = 1, 1          # cut from 1 + 2
#: their learning rate: at 1e-3 Adam's fifth step on 4 layers spikes
#: (8.74 -> 11.94) with the f32 wire as with the bf16 one, the two traces
#: within 1e-4 of each other; at 3e-4 both fall on every step
#: (``--p6-lr-control``)
P6_LR = 3e-4
#: ``--p6-lr-control``: the learning rates and steps of its traces
P6_CONTROL_LRS = (1e-3, P6_LR)
P6_CONTROL_STEPS = 7
P6_CONFIGS = ("horovod_allreduce", "horovod_ef_zero1", "powersgd_allreduce",
              "program_e", "int8_pipeline", "int8_full", "hier_zero1",
              "hier_zero1_int8_dcn")
#: what the plan of each ``train_p6`` configuration must hold, fixed
#: here and not read from the plan: every bucket's compressor (None: no
#: bucket, PowerSGD's per-variable tier), the step's fused kernels (K4's
#: guard, K5's update, K6–K8's quant_hop), and whether every bucket is
#: pipelined, some run ring hops (K6–K8) and every bucket has two tiers
P6_PLAN = {
    "horovod_allreduce": ("HorovodCompressor", {"guard"}, False, False,
                          False),
    "horovod_ef_zero1": ("HorovodCompressorEF", {"guard", "update"}, False,
                         False, False),
    "powersgd_allreduce": (None, {"guard"}, False, False, False),
    "program_e": ("HorovodCompressorEF", {"guard"}, False, False, False),
    "int8_pipeline": ("Int8Compressor", {"guard", "update", "quant_hop"},
                      True, False, False),
    "int8_full": ("Int8Compressor", {"guard", "update", "quant_hop"}, True,
                  True, False),
    "hier_zero1": ("NoneCompressor", {"guard", "update"}, False, False, True),
    "hier_zero1_int8_dcn": ("NoneCompressor", {"guard", "update"}, False,
                            False, True)}
#: the two-tier runs' cluster: 2 slices of 2 of the 4 ranks
HIER_SPEC = {"nodes": [{"address": "localhost", "chips": RING_RANKS}],
             "num_slices": 2}
#: the slot engine's geometry (serve()'s default engine) and the decode
#: ticks of each of its profile windows
SLOT_GEOM = dict(slots=8, window=1024, chunk=16)
SLOT_PROFILE_TICKS = 16
#: the depth of the slot engine's int8 pass (full width): its oracle, the
#: plain generator on the int8 tree, runs every prompt position as one
#: host-bound decode tick, 2231 for the seven requests (cut from 6)
SLOT_INT8_LAYERS = 3
#: beam search and score: batch, prompt, new tokens; score against the
#: teacher-forced decode logits
BEAM_BATCH, BEAM_PROMPT, BEAM_NEW = 2, 16, 32
SCORE_RTOL = 1e-4
#: speculative decoding: proposal depth, the second draft's depth, the
#: generator's batch (prompt, new tokens), the paged engine's HTTP
#: requests (prompt, new tokens), and the self-draft's least acceptance
SPEC_GAMMA = 4
SPEC_DRAFT_LAYERS = 2
SPEC_BATCH, SPEC_PROMPT, SPEC_NEW = 2, 16, 48
SPEC_REQUESTS = ((16, 32), (64, 48), (32, 24))
SELF_ACCEPT_MIN = 0.95
#: the tokenizer's generated corpus (words) and its learned merges
TOKENIZER_WORDS = 6000
TOKENIZER_MERGES = 512
#: LoRA: rank, targets (the JAX package's LM test: attention output split
#: at 2, q/k/v, MLP), learning rate, warm-up and timed steps
LORA_RANK = 8
LORA_TARGETS = [("*/attn/out/*", 2), "*/attn/*", "*/mlp/*"]
LORA_LR = 1e-3
#: the resilience phase: the device step counter value ``nan_grad`` poisons,
#: the fit epochs' length and the step ``loss_spike`` spikes (at least 8
#: healthy losses before it: the detector's minimum window), its z-score
#: threshold; the supervised worker's epochs of 2 steps, the monitor's
#: step timeout (above a full-width checkpoint's save and verify, which
#: beat phase-tagged but leave the step unchanged) and beacon timeout
RES_NAN_STEP, RES_EPOCH_STEPS, RES_SPIKE_STEP = 2, 5, 9
RES_SPIKE_ZSCORE = 3.0
RES_SUP_EPOCHS = 3
RES_SUP_NUMERICS = {"clip_norm": CLIP_NORM}
RES_STEP_TIMEOUT_S, RES_BEACON_TIMEOUT_S = 10.0, 60.0
#: the elastic phase: steps after the resume and the losses' bound against
#: the 4-rank donor's (the JAX package's elastic test's)
ELASTIC_STEPS, ELASTIC_LOSS_RTOL = 3, 1e-5
ELASTIC_DRIFT_CAP = 1 << 10
#: the router phase: ``kill_replica``'s threshold (generated tokens, counted
#: at completions) and the requests' new tokens, all different so that
#: replica 0's first completion finds others mid-decode
ROUTER_KILL_TOKENS = 5
#: recovered requests re-issued on the healed pool (the baseline of the
#: recovery's extra ms)
ROUTER_HEALED_REPEATS = 2
ROUTER_NEW_TOKENS = tuple(range(24, 137, 16))
LORA_WARMUP, LORA_TIMED = 2, 3


#: the process's start on the host clock (``emit``'s ``t_s``)
T_START = time.perf_counter()


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase's line also carries
    ``t_s``, the seconds since the process started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, flops_per_s=H100_F32_FLOPS):
    """The least time for moving ``nbytes`` and doing ``flops`` at
    ``flops_per_s`` (f32 CUDA cores unless given): ``(ms, bound_by)``."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _k9_row(torch, timer, F, q, kc, vc, bt, rel_specs) -> dict:
    """K9 at one shape: held against its plain version at 1e-5 in each
    ``rel_specs`` case (and bit-identical when run twice), then timed at
    a full window with its bound, the plain version and SDPA."""
    from autodist_tpu_torch.ops import _build
    from autodist_tpu_torch.ops import fused_kernels as fk

    b, h, dh = q.shape
    bs, maxb = kc.shape[1], bt.shape[1]
    dev = q.device
    w = maxb * bs
    err = 0.0
    for name, rel_list in rel_specs.items():
        rel = torch.tensor(rel_list, dtype=torch.int32, device=dev)
        out = fk.paged_attention(q, kc, vc, bt, rel)
        again = fk.paged_attention(q, kc, vc, bt, rel)
        ref = fk.paged_attention_reference(q, kc, vc, bt, rel)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5,
                                   msg=f"K9 H={h} rel={name}")
        if not torch.equal(out, again):
            raise AssertionError(f"K9 not bit-identical at H={h} "
                                 f"rel={name}")
        err = max(err, (out - ref).abs().max().item())
    rel = torch.full((b,), w - 1, dtype=torch.int32, device=dev)
    live = int((rel.long() + 1).sum())
    nbytes = (live * h * dh * 2 * 4 + 2 * b * h * dh * 4
              + b * maxb * 4 + b * 4)
    bound, by = bound_ms(nbytes, 4.0 * live * h * dh)
    kb = kc[bt.long()].reshape(b, w, h, dh).permute(0, 2, 1, 3).contiguous()
    vb = vc[bt.long()].reshape(b, w, h, dh).permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(w, device=dev)[None, :] <= rel[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    return {
        "shape": dict(B=b, H=h, Dh=dh, BS=bs, MAXB=maxb, rel=w - 1),
        "splits": fk.splits_for(b, h, w, _build.sm_count(dev)),
        "max_abs_err": err,
        "ms": timer(lambda: fk.paged_attention(q, kc, vc, bt, rel)),
        "plain_ms": timer(
            lambda: fk.paged_attention_reference(q, kc, vc, bt, rel)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q4, kb, vb, attn_mask=mask)),
        "library_call": "F.scaled_dot_product_attention on the gathered "
                        "window (gather not timed)",
    }


def phase_kernels(torch, timer):
    import torch.nn.functional as F
    from autodist_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")

    # --- K9: decode shape, engine-default pool -------------------------
    b, h, dh, bs, maxb = 8, 12, 64, 32, 32
    nb = b * maxb + maxb + 1
    q = torch.randn(b, h, dh, generator=gen).to(dev)
    kc = torch.randn(nb, bs, h, dh, generator=gen).to(dev)
    vc = torch.randn(nb, bs, h, dh, generator=gen).to(dev)
    bt = torch.randint(1, nb, (b, maxb), generator=gen).to(dev, torch.int32)
    w = maxb * bs
    rel_specs = {"first": [0] * b, "mid_block": [15] * b,
                 "block_edge": [31, 32, 63, 64, 95, 96, 127, 128],
                 "full": [w - 1] * b,
                 "mixed": [0, 15, 31, 32, 500, 700, 1000, w - 1]}
    k9 = {"name": "paged_attention", "route": "cuda", "source": K9_SOURCE,
          "replaces": K9_REPLACES,
          **_k9_row(torch, timer, F, q, kc, vc, bt, rel_specs)}
    # the head-sharded pool's shape: this rank's 12 / 4 heads (serve_tp)
    h3 = h // SERVE_TP_AXES["model"]
    k9["h3_shape"] = _k9_row(torch, timer, F,
                             *(t[..., :h3, :].contiguous()
                               for t in (q, kc, vc)), bt, rel_specs)
    emit({"phase": "kernel", **k9})

    # --- K10: every (M, K, N) the serving path gives it -----------------
    k10_rows = []
    for m in (8, 512):
        for k, n in K10_SHAPES:
            # the model's scales: unit-variance activations after
            # LayerNorm, lecun-normal weights (std 1/sqrt(K))
            x = torch.randn(m, k, generator=gen).to(dev)
            wq = quant.quantize_weight(
                (torch.randn(k, n, generator=gen) / k ** 0.5).to(dev))
            wdeq = wq.q.float() * wq.scale
            out = quant.int8_matmul(x, wq)
            again = quant.int8_matmul(x, wq)
            ref = quant.int8_matmul_reference(x, wq)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4,
                                       msg=f"K10 M={m} K={k} N={n}")
            if not torch.equal(out, again):
                raise AssertionError(f"K10 not bit-identical at M={m} "
                                     f"K={k} N={n}")
            nbytes = k * n + 4 * (m * k + n + m * n)
            bnd, by = bound_ms(nbytes, 2.0 * m * k * n)
            row = {"M": m, "K": k, "N": n,
                   "path": "skinny" if m <= quant._SKINNY_M else "tiled",
                   "max_abs_err": (out - ref).abs().max().item(),
                   "ms": timer(lambda: quant.int8_matmul(x, wq)),
                   "plain_ms": timer(
                       lambda: quant.int8_matmul_reference(x, wq)),
                   "bound_ms": bnd, "bound_by": by,
                   "library_ms": timer(lambda: torch.matmul(x, wdeq))}
            # int8 is exact in TF32: two TF32 products per f32 product
            row["bound_tc_ms"], row["bound_tc_by"] = bound_ms(
                nbytes, 2.0 * m * k * n, H100_2XTF32_FLOPS)
            row["vs_library"] = row["ms"] / row["library_ms"]
            emit({"phase": "kernel", "name": "int8_matmul", **row})
            k10_rows.append(row)
    worst = max(k10_rows, key=lambda r: r["vs_library"])
    k10 = {
        "name": "int8_matmul", "route": "cuda", "source": K10_SOURCE,
        "replaces": K10_REPLACES,
        "shape": {k: worst[k] for k in ("M", "K", "N")},
        "max_abs_err": max(r["max_abs_err"] for r in k10_rows),
        **{k: worst[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        "worst_vs_library": worst["vs_library"],
        "shapes": [{k: r[k] for k in ("M", "K", "N", "path", "ms",
                                      "library_ms", "bound_ms",
                                      "bound_tc_ms", "vs_library")}
                   for r in k10_rows],
        "library_call": "torch.matmul against the pre-dequantized weight",
    }
    emit({"phase": "k10_crossover", **k10_crossover(torch, timer, gen)})
    return k9, k10


def k10_crossover(torch, timer, gen):
    """K10's skinny and tiled kernels timed against each other (and
    ``torch.matmul`` on the pre-dequantized weight) at every M of
    ``K10_CROSSOVER_M`` and each model shape (the skinny kernel runs any
    M, in slabs of 16 rows): where the tiled one starts to win."""
    from autodist_tpu_torch.ops import quant

    rows, first_tiled = [], {}
    for k, n in K10_SHAPES:
        wq = quant.quantize_weight(
            (torch.randn(k, n, generator=gen) / k ** 0.5).to("cuda"))
        wdeq = wq.q.float() * wq.scale
        for m in K10_CROSSOVER_M:
            x = torch.randn(m, k, generator=gen).to("cuda")
            row = {"M": m, "K": k, "N": n}
            for path in ("skinny", "tiled"):
                row[path + "_ms"] = timer(lambda: quant._launch(x, wq, path))
            row["library_ms"] = timer(lambda: torch.matmul(x, wdeq))
            rows.append(row)
            if row["tiled_ms"] < row["skinny_ms"]:
                first_tiled.setdefault(f"{k}x{n}", m)
    return {"rows": rows, "first_m_where_tiled_wins": first_tiled,
            "skinny_m": quant._SKINNY_M}


def _flash_case(torch, fa, gen, b, t, h, d, causal, mul=1.0):
    """K1–K3 against their plain versions on one shape (random q, k, v,
    dO and lse cotangent, q times ``mul``); returns the max abs errors and
    the inputs."""
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen).to("cuda")
                   for _ in range(4))
    q = q * mul
    dlse = torch.randn(b, h, t, generator=gen).to("cuda")
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = ((do * o).sum(-1).transpose(1, 2) - dlse).contiguous()
    bwd = (q, k, v, do, lse, delta, causal)
    got = {"o": o, "lse": lse, "dq": fa.flash_dq(*bwd)}
    got["dk"], got["dv"] = fa.flash_dkv(*bwd)
    again = (fa.flash_dq(*bwd),) + fa.flash_dkv(*bwd)
    want = dict(zip(("o", "lse"), fa.flash_fwd_reference(q, k, v, causal)))
    want["dq"] = fa.flash_dq_reference(*bwd)
    want["dk"], want["dv"] = fa.flash_dkv_reference(*bwd)
    torch.cuda.synchronize()
    label = f"B={b} T={t} H={h} D={d} causal={causal} q x {mul}"
    for name, tol in (("o", 1e-5), ("lse", 1e-5), ("dq", 1e-4), ("dk", 1e-4),
                      ("dv", 1e-4)):
        torch.testing.assert_close(got[name], want[name], rtol=tol, atol=tol,
                                   msg=f"flash {name} at {label}")
    if not all(torch.equal(x, y) for x, y in
               zip(again, (got["dq"], got["dk"], got["dv"]))):
        raise AssertionError(f"flash backward not bit-identical at {label}")
    errs = {n: (got[n] - want[n]).abs().max().item() for n in got}
    return errs, bwd


def phase_flash(torch, timer):
    """K1–K3: correctness at the training and ragged shapes, then times at
    the training shape (causal)."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

    gen = torch.Generator().manual_seed(SEED + 3)
    b, t, h, d = (TRAIN_SHAPE[x] for x in "BTHD")
    errs = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    # q x 4: scores of standard deviation near 4 and a peaked softmax,
    # where a lost low-order TF32 half would show
    for shape, causal, mul in (((b, 1000, h, d), True, 1.0),
                               ((b, 1000, h, d), False, 1.0),
                               ((b, 1000, h, 16), True, 1.0),
                               ((b, t, h, d), False, 4.0),
                               ((b, t, h, d), True, 1.0)):
        e, bwd = _flash_case(torch, fa, gen, *shape, causal, mul)
        errs["flash_fwd"] = max(errs["flash_fwd"], e["o"], e["lse"])
        errs["flash_dq"] = max(errs["flash_dq"], e["dq"])
        errs["flash_dkv"] = max(errs["flash_dkv"], e["dk"], e["dv"])
        emit({"phase": "flash_check", "shape": list(shape), "causal": causal,
              "q_mul": mul, "max_abs_err": e})
    return _flash_rows(torch, timer, bwd, dict(TRAIN_SHAPE, causal=True),
                       errs)


def _flash_rows(torch, timer, bwd, shape, errs):
    """K1–K3 timed on ``bwd`` (:func:`_flash_case`'s inputs): each row's
    kernel and plain ms, bound_ms / bound_tc_ms and SDPA's time (its
    backward on K2's row), each emitted as a ``kernel`` line."""
    import torch.nn.functional as F
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

    q, k, v, do, lse, delta, causal = bwd
    b, t, h, d = q.shape
    # (query, key) pairs: all of them, or the causal lower triangle
    pairs = b * h * t * (t + 1) // 2 if causal else b * h * t * t
    product = 2.0 * pairs * d                 # one T x T x D product
    rows, vec = 4.0 * b * t * h * d, 4.0 * b * h * t
    # K1: S = QK^T, O = PV; K2: S, dP = dO V^T, dQ = dS K; K3: S, dV = P^T
    # dO, dP, dK = dS^T Q.  Bytes: each input read once, each output once.
    work = {"flash_fwd": (4 * rows + vec, 2 * product),
            "flash_dq": (5 * rows + 2 * vec, 3 * product),
            "flash_dkv": (6 * rows + 2 * vec, 4 * product)}
    times = {
        "flash_fwd": (timer(lambda: fa.flash_fwd(q, k, v, causal)),
                      timer(lambda: fa.flash_fwd_reference(q, k, v, causal))),
        "flash_dq": (timer(lambda: fa.flash_dq(*bwd)),
                     timer(lambda: fa.flash_dq_reference(*bwd))),
        "flash_dkv": (timer(lambda: fa.flash_dkv(*bwd)),
                      timer(lambda: fa.flash_dkv_reference(*bwd))),
    }
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    lib_bwd = timer(sdpa_fwd_bwd) - lib_fwd
    library = {
        "flash_fwd": (lib_fwd, f"F.scaled_dot_product_attention forward "
                               f"(is_causal={causal}, [B, H, T, D] copies)"),
        "flash_dq": (lib_bwd, "F.scaled_dot_product_attention backward "
                              "(forward+backward minus forward): dQ, dK and "
                              "dV together, so it compares with "
                              "flash_dq + flash_dkv"),
        "flash_dkv": (None, "none alone: SDPA's backward is reported once, "
                            "on flash_dq"),
    }
    rows_out = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        bnd, by = bound_ms(*work[name])
        bnd_tc, by_tc = bound_ms(*work[name], H100_3XTF32_FLOPS)
        row = {
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[name], "shape": shape,
            "max_abs_err": errs[name], "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": bnd, "bound_by": by,
            "bound_tc_ms": bnd_tc, "bound_tc_by": by_tc,
            "gflop": work[name][1] / 1e9,
            "library_ms": library[name][0],
            "library_call": library[name][1]}
        if row["library_ms"] is not None:
            row["vs_library"] = row["ms"] / row["library_ms"]
        rows_out.append(row)
    # SDPA's backward computes dQ, dK and dV: K2 + K3 against it
    rows_out[1]["bwd_vs_library"] = ((rows_out[1]["ms"] + rows_out[2]["ms"])
                                     / rows_out[1]["library_ms"])
    for row in rows_out:
        emit({"phase": "kernel", **row})
    return rows_out


def start_ptxas_report(source: str):
    """Starts ``nvcc -Xptxas -v`` on ``csrc/<source>`` (a cubin in the
    build directory, beside the libraries) with the build's flags; returns
    the process for :func:`read_ptxas_report`."""
    from autodist_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = _build.BUILD_DIR / (source + ".ptxas.cubin")
    return subprocess.Popen(
        [_build.find_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o",
         str(out), str(_build.CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def read_ptxas_report(proc) -> dict:
    """``{"flash_fwd_kernel<64, causal>": {"registers", "spill_stores",
    "spill_loads", "stack", "static_smem"}, ...}`` from the process's
    output; raises if the compile failed."""
    from autodist_tpu_torch.ops import _build

    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{log}")
    return _build.parse_ptxas(log)


def phase_sync_kernels(torch, timer):
    """K4 and K5 against their plain versions at the ZeRO-1 path's bucket
    sizes; times at the embedding bucket, the largest."""
    from autodist_tpu_torch.ops import fused_kernels as fk

    gen = torch.Generator().manual_seed(SEED + 4)
    dev = torch.device("cuda")
    spec = fk.AdamSpec(lr=1e-3)
    # K4: max abs difference from the plain version (count and sum), and
    # the sum's relative error against an f64 sum (the yardstick)
    errs = {"detect_stats": 0.0, "adam_update": 0.0, "detect_rel": 0.0}
    for n in SYNC_SIZES:
        x = torch.randn(n, generator=gen).to(dev)
        nf, sq = fk.fused_detect_stats(x)
        nf2, sq2 = fk.fused_detect_stats(x)
        pnf, psq = fk.fused_detect_stats_reference(x)
        want = float((x.double() ** 2).sum())
        torch.cuda.synchronize()
        if float(nf) != 0.0 or float(pnf) != 0.0 \
                or not abs(float(sq) - want) <= 1e-6 * want:
            raise AssertionError(f"K4 at n={n}: ({float(nf)}, {float(sq)}),"
                                 f" want (0, {want})")
        if not (torch.equal(nf, nf2) and torch.equal(sq, sq2)):
            raise AssertionError(f"K4 at n={n}: two runs differ")
        errs["detect_stats"] = max(errs["detect_stats"],
                                   abs(float(sq) - float(psq)))
        errs["detect_rel"] = max(errs["detect_rel"],
                                 abs(float(sq) - want) / want)
        for bad in (float("nan"), float("inf"), -float("inf")):
            y = x.clone()
            y[n // 2] = bad
            bnf, bsq = fk.fused_detect_stats(y)
            if float(bnf) != 1.0 or np.isfinite(float(bsq)):
                raise AssertionError(f"K4 at n={n} with {bad}: "
                                     f"({float(bnf)}, {float(bsq)})")
        del y
        p, g, m = (torch.randn(n, generator=gen).to(dev) for _ in range(3))
        v = torch.rand(n, generator=gen).to(dev)
        kp, km, kv, rp, rm, rv = p, m, v, p, m, v
        for step, mult in enumerate((1.0, 0.25, 1.0)):
            scalars = fk.adam_scalars(
                torch.tensor(step, dtype=torch.int32, device=dev), spec,
                torch.tensor(mult, device=dev))
            kp, km, kv = fk.fused_adam_update(kp, g, km, kv, scalars, spec)
            rp, rm, rv = fk.fused_adam_update_reference(rp, g, rm, rv,
                                                        scalars, spec)
        torch.cuda.synchronize()
        for name, got, want_t in (("p", kp, rp), ("m", km, rm),
                                  ("v", kv, rv)):
            torch.testing.assert_close(got, want_t, atol=1e-6, rtol=0,
                                       msg=f"K5 {name} at n={n}")
            errs["adam_update"] = max(errs["adam_update"],
                                      (got - want_t).abs().max().item())
        emit({"phase": "sync_check", "n": n,
              "detect_stats_rel_err_vs_f64": abs(float(sq) - want) / want,
              "detect_stats_abs_diff_vs_plain": abs(float(sq) - float(psq)),
              "detect_stats_sums": [float(sq), float(psq), want],
              "adam_update_max_abs_err": errs["adam_update"]})
        del kp, km, kv, rp, rm, rv
    n = SYNC_SIZES[0]
    x = torch.randn(n, generator=gen).to(dev)
    p, g, m = (torch.randn(n, generator=gen).to(dev) for _ in range(3))
    v = torch.rand(n, generator=gen).to(dev)
    scalars = fk.adam_scalars(torch.tensor(3, dtype=torch.int32, device=dev),
                              spec, torch.tensor(0.5, device=dev))
    steps = [torch.tensor(4.0, device=dev)]
    lib_p, lib_m, lib_v, lib_g = (t.clone() for t in (p, m, v, g))
    one = torch.ones((), device=dev)
    rows = []
    for name, nbytes, t_k, t_plain, t_lib, lib_call in (
            ("detect_stats", 4.0 * n,
             timer(lambda: fk.fused_detect_stats(x)),
             timer(lambda: fk.fused_detect_stats_reference(x)),
             timer(lambda: torch.linalg.vector_norm(x)),
             "torch.linalg.vector_norm alone: only the sum-of-squares half "
             "(no non-finite count)"),
            ("adam_update", 28.0 * n,
             timer(lambda: fk.fused_adam_update(p, g, m, v, scalars, spec)),
             timer(lambda: fk.fused_adam_update_reference(p, g, m, v,
                                                          scalars, spec)),
             timer(lambda: torch._fused_adam_(
                 [lib_p], [lib_g], [lib_m], [lib_v], [], steps, lr=1e-3,
                 beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                 amsgrad=False, maximize=False, grad_scale=one)),
             "torch._fused_adam_ on the same shard with grad_scale (another "
             "expression order; in place)")):
        # K4: 1 multiply-add + 1 class test per element; K5: ~15 f32
        # operations per element (4 multiplies, 3 adds, 3 divides, 1 sqrt
        # in the update, the bias corrections outside)
        bnd, by = bound_ms(nbytes, (2.0 if name == "detect_stats"
                                    else 15.0) * n)
        rows.append({"name": name, "route": "cuda", "source": SYNC_SOURCE,
                     "replaces": SYNC_REPLACES[name], "shape": {"n": n},
                     "max_abs_err": errs[name],
                     "ms": t_k, "plain_ms": t_plain, "bound_ms": bnd,
                     "bound_by": by, "library_ms": t_lib,
                     "library_call": lib_call})
        emit({"phase": "kernel", **rows[-1]})
    rows[0]["rel_err_vs_f64"] = errs["detect_rel"]
    return rows


def _same_payload(torch, a, b) -> bool:
    """Wire payloads bit-equal, fp8 NaN compared as NaN."""
    if a.dtype == torch.int8:
        return torch.equal(a, b)
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    return torch.equal(na, nb) and torch.equal(a.view(torch.uint8)[~na],
                                               b.view(torch.uint8)[~nb])


def _check_quantized(torch, got, want, label) -> float:
    """A K6/K7 result ``(q, scales, err, sat)`` against the plain
    version's; returns the error's max abs difference."""
    (q, s, err, sat), (rq, rs, rerr, rsat) = got, want
    if not _same_payload(torch, q, rq):
        raise AssertionError(f"{label}: payload differs from the plain "
                             f"version's")
    if not torch.equal(s, rs):
        raise AssertionError(f"{label}: scales differ")
    torch.testing.assert_close(err, rerr, atol=1e-6, rtol=0, equal_nan=True,
                               msg=f"{label}: error")
    if float(sat) != float(rsat):
        raise AssertionError(f"{label}: saturation {float(sat)} vs "
                             f"{float(rsat)}")
    return (err - rerr).abs().nan_to_num(0.0).max().item()


def phase_quant_kernels(torch, timer):
    """K6–K8 against their plain versions at the ring's chunk sizes, int8
    and fp8, clean and poisoned; times at the embedding chunk."""
    from autodist_tpu_torch.kernel.synchronization import quant_ring as qr
    from autodist_tpu_torch.ops import fused_kernels as fk

    gen = torch.Generator().manual_seed(SEED + 5)
    dev = torch.device("cuda")
    formats = (qr.WIRE_INT8, qr.WIRE_FP8_E4M3)
    names = tuple(QUANT_REPLACES)
    errs = dict.fromkeys(names, 0.0)
    for n in QUANT_SIZES:
        x = (torch.randn(n, generator=gen) * 3).to(dev)
        chunk = torch.randn(n, generator=gen).to(dev)
        bad = torch.tensor([float("inf"), float("nan"), -float("inf")],
                           device=dev)
        at = [5, n // 2, n - 1]
        px, pchunk = x.clone(), chunk.clone()
        px[at], pchunk[at] = bad, bad
        for fmt in formats:
            # K7/K8 receive the quantized partial of x / 3 and add this
            # rank's chunk; the poisoned case poisons the input and chunk
            q_in, s_in = fk.fused_quantize_reference(x / 3, fmt)[:2]
            sats = {}
            for label, src, c in (("clean", x, chunk),
                                  ("poisoned", px, pchunk)):
                tag = f"{fmt.name} n={n} {label}"
                k6 = fk.fused_quantize(src, fmt)
                again = fk.fused_quantize(src, fmt)
                k7 = fk.fused_hop_accumulate(q_in, s_in, c, fmt)
                k8 = fk.fused_dequant_add(q_in, s_in, c, fmt)
                torch.cuda.synchronize()
                errs[names[0]] = max(errs[names[0]], _check_quantized(
                    torch, k6, fk.fused_quantize_reference(src, fmt),
                    f"K6 {tag}"))
                errs[names[1]] = max(errs[names[1]], _check_quantized(
                    torch, k7, fk.fused_hop_accumulate_reference(
                        q_in, s_in, c, fmt), f"K7 {tag}"))
                r8 = fk.fused_dequant_add_reference(q_in, s_in, c, fmt)
                torch.testing.assert_close(k8, r8, atol=1e-6, rtol=0,
                                           equal_nan=True, msg=f"K8 {tag}")
                errs[names[2]] = max(errs[names[2]], (k8 - r8).abs()
                                     .nan_to_num(0.0).max().item())
                if not (_same_payload(torch, again[0], k6[0])
                        and torch.equal(again[1], k6[1])
                        and torch.equal(again[2].nan_to_num(),
                                        k6[2].nan_to_num())
                        and float(again[3]) == float(k6[3])):
                    raise AssertionError(f"K6 {tag}: two runs differ")
                sats[label] = (float(k6[3]), float(k7[3]))
                if label == "poisoned" and min(sats[label]) < 3:
                    raise AssertionError(f"K6/K7 {tag}: saturation "
                                         f"{sats[label]} below 3")
            emit({"phase": "quant_check", "n": n, "wire": fmt.name,
                  "sat_counts_k6_k7": sats,
                  "max_abs_err": {k: errs[k] for k in names}})
    n = QUANT_SIZES[0]
    nb = qr.scale_count(n)
    x = (torch.randn(n, generator=gen) * 3).to(dev)
    chunk = torch.randn(n, generator=gen).to(dev)
    # bytes: K6 reads x and writes q, scales, err; K7 reads and writes
    # (q, scales) and reads the chunk and writes err; K8 reads q, scales
    # and the chunk and writes the sum.  Operations: ~10 f32 per element
    # (K8: a multiply-add)
    work = {names[0]: (9.0 * n + 4.0 * nb, 10.0 * n),
            names[1]: (10.0 * n + 8.0 * nb, 12.0 * n),
            names[2]: (9.0 * n + 4.0 * nb, 2.0 * n)}
    times = {}
    for fmt in formats:
        q_in, s_in = fk.fused_quantize(x / 3, fmt)[:2]
        times[fmt.name] = {
            names[0]: (timer(lambda: fk.fused_quantize(x, fmt)),
                       timer(lambda: fk.fused_quantize_reference(x, fmt))),
            names[1]: (timer(lambda: fk.fused_hop_accumulate(
                q_in, s_in, chunk, fmt)),
                timer(lambda: fk.fused_hop_accumulate_reference(
                    q_in, s_in, chunk, fmt))),
            names[2]: (timer(lambda: fk.fused_dequant_add(
                q_in, s_in, chunk, fmt)),
                timer(lambda: fk.fused_dequant_add_reference(
                    q_in, s_in, chunk, fmt)))}
    rows = []
    for name in names:
        bnd, by = bound_ms(*work[name])
        rows.append({
            "name": name, "route": "cuda", "source": QUANT_SOURCE,
            "replaces": QUANT_REPLACES[name],
            "shape": {"n": n, "wire": "int8"},
            "max_abs_err": errs[name], "ms": times["int8"][name][0],
            "plain_ms": times["int8"][name][1], "bound_ms": bnd,
            "bound_by": by, "library_ms": None,
            "library_call": "none: no single PyTorch call quantizes on a "
                            "per-block scale grid",
            "fp8_ms": times["float8_e4m3fn"][name][0],
            "fp8_plain_ms": times["float8_e4m3fn"][name][1]})
        emit({"phase": "kernel", **rows[-1]})
    return rows


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        if body.get("stream"):
            events = [json.loads(line[6:]) for line in
                      resp.read().decode().splitlines()
                      if line.startswith("data: ")]
            final = events[-1]
            if not final.get("done") or "tokens" not in final:
                raise RuntimeError(f"stream ended without a result: {final}")
            return final, len(events)
        return json.loads(resp.read()), 1


def _check_exact(torch, gen, params, prompt, n, got, label, want=None):
    """``got`` must equal the plain generator's greedy output (``want``,
    when the caller computed it for the same tree and request); on a
    mismatch report the first differing position and the top-2 logit gap
    there.  Returns the generator's output."""
    if want is None:
        want = gen(params, prompt[None, :], n)[0].cpu().numpy()
    got = np.asarray(got)
    if got.shape == want.shape and np.array_equal(got, want):
        return want
    _, logits = gen.with_logits(params, prompt[None, :], n)
    diff = np.nonzero(got[:want.size] != want[:got.size])[0]
    pos = int(diff[0]) if diff.size else min(got.size, want.size)
    top2 = torch.topk(logits[pos - 1, 0].float(), 2).values.tolist()
    raise AssertionError(
        f"{label}: output differs from the generator at position {pos} "
        f"(engine {got[pos] if pos < got.size else None}, generator "
        f"{want[pos] if pos < want.size else None}; top-2 logit gap there "
        f"{top2[0] - top2[1]:.3e})")


def _rates(engine):
    dec = [e for e in engine.timeline if e[0] == "decode"]
    pre = [e for e in engine.timeline if e[0] == "prefill"]
    dec_s = sum(e[3] for e in dec)
    pre_s = sum(e[3] for e in pre)
    return {
        "decode_tokens_per_s": sum(e[2] for e in dec) / dec_s,
        "ms_per_decode_tick": statistics.median(
            e[3] / e[1] * 1e3 for e in dec),
        "prefill_tokens_per_s": sum(e[2] for e in pre) / pre_s,
        "decode_ticks": sum(e[1] for e in dec),
        "decode_dispatches": len(dec), "prefill_dispatches": len(pre),
    }


def _warm_up(spec, params, prompts, device, geom):
    """One pass of a phase's prompts (2 new tokens each) through a
    throwaway engine, so first-call costs (CUDA module loading, GEMM
    heuristics per shape) stay out of the measured run."""
    from autodist_tpu_torch.serving import PagedDecodeEngine

    eng = PagedDecodeEngine(spec, params, device=device, **geom)
    for prompt in prompts:
        eng.submit(prompt, 2)
    eng.run()


def phase_serve(torch, spec, params, device="cuda", geom=SERVE_GEOM):
    from autodist_tpu_torch.models.generate import make_generator
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops import quant
    from autodist_tpu_torch.serving import serve

    requests, _ = _serve_requests(spec.config["vocab_size"], SEED + 1)

    _warm_up(spec, params, [r[0] for r in requests], device, geom)
    fk.paged_attention.calls = 0
    quant.int8_matmul.calls = 0
    srv = serve(spec, params, paged=True, device=device, host="127.0.0.1",
                port=0, **geom)
    try:
        url = "http://%s:%d" % srv.address
        # the first request alone warms the prefix trie
        answers, sse_events, wall = _http_round(url, [
            {"prompt_tokens": [int(t) for t in prompt],
             "max_new_tokens": n, "stream": stream}
            for prompt, n, stream in requests])
        with urllib.request.urlopen(url + "/v1/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
        k9_calls = fk.paged_attention.calls
        k10_calls = quant.int8_matmul.calls
    finally:
        srv.close()
    eng = srv.engine
    eng.assert_no_leaks()
    ticks = eng.stats.ticks
    if k9_calls <= 0 or k9_calls != spec.config["num_layers"] * ticks:
        raise AssertionError(f"paged_attention called {k9_calls} times "
                             f"for {ticks} decode ticks")
    if stats["trie_lookup_hits"] < 1 or eng.stats.cached_prompt_tokens < 64:
        raise AssertionError(f"the shared-prefix request missed the trie: "
                             f"{stats}")
    if sse_events < 2:
        raise AssertionError("the streamed request sent no SSE events")
    gen = make_generator(spec, device=device)
    oracle = [_check_exact(torch, gen, params, prompt, n, ans["tokens"],
                           f"HTTP request {i}")
              for i, ((prompt, n, _), ans) in enumerate(zip(requests,
                                                            answers))]
    return {"requests": len(requests), "wall_s": wall, "oracle": oracle,
            "paged_attention_calls": k9_calls,
            "int8_matmul_calls": k10_calls,
            "prefix_hit_tokens": eng.stats.cached_prompt_tokens,
            "prefill_chunks": eng.stats.prefill_chunks,
            "generated_tokens": eng.stats.generated_tokens,
            "sse_events": sse_events, **_rates(eng)}


def phase_int8(torch, spec, params, device="cuda", geom=SERVE_GEOM):
    from autodist_tpu_torch.models.generate import make_generator
    from autodist_tpu_torch.models.quantize import quantize_lm_params
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops import quant
    from autodist_tpu_torch.serving import PagedDecodeEngine

    qparams = quantize_lm_params(params)
    vocab = spec.config["vocab_size"]
    rng = np.random.RandomState(SEED + 2)
    requests = [(rng.randint(0, vocab, p).astype(np.int32), n)
                for p, n in ((32, 64), (300, 64), (100, 48), (600, 32))]
    _warm_up(spec, qparams, [r[0] for r in requests], device, geom)
    eng = PagedDecodeEngine(spec, qparams, device=device, **geom)
    fk.paged_attention.calls = 0
    quant.int8_matmul.calls = 0
    ids = [eng.submit(p, n) for p, n in requests]
    results = eng.run()
    k9_calls = fk.paged_attention.calls
    k10_calls = quant.int8_matmul.calls
    eng.assert_no_leaks()
    # q/k/v/out + wi/wo per layer, plus the tied head, per decode tick and
    # per prefill dispatch
    per_forward = 6 * spec.config["num_layers"] + 1
    dispatches = eng.stats.ticks + eng.stats.prefill_dispatches
    if k10_calls <= 0 or k10_calls != per_forward * dispatches:
        raise AssertionError(f"int8_matmul called {k10_calls} times "
                             f"for {dispatches} decode ticks and prefill "
                             f"dispatches ({per_forward} each)")
    if k9_calls != spec.config["num_layers"] * eng.stats.ticks:
        raise AssertionError(f"paged_attention called {k9_calls} times "
                             f"for {eng.stats.ticks} decode ticks")
    gen = make_generator(spec, device=device)
    for rid, (prompt, n) in zip(ids, requests):
        _check_exact(torch, gen, qparams, prompt, n, results[rid],
                     f"int8 request {rid}")
    return {"requests": len(requests),
            "paged_attention_calls": k9_calls,
            "int8_matmul_calls": k10_calls,
            "int8_matmul_calls_per_decode_tick": per_forward,
            "generated_tokens": eng.stats.generated_tokens,
            **_rates(eng)}


def _flash_counts(fa_fn):
    return (fa_fn.fwd_calls, fa_fn.dq_calls, fa_fn.dkv_calls)


def _expect_launches(label: str, got, want) -> None:
    """A kernel launch count of a phase's main path must be ``want``."""
    if got != want:
        raise AssertionError(f"{label}: {got} launches, expected {want}")


def _serve_requests(vocab: int, seed: int):
    """``phase_serve``'s seven requests: a shared 64-token prefix (two
    requests), a 700-token prompt, a streamed one and three others, as
    ``(prompt, max_new_tokens, stream)``; and the shared prefix."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, 64).astype(np.int32)
    first = (np.concatenate([shared, rng.randint(0, vocab, 16)]), 48, False)
    second = (np.concatenate([shared, rng.randint(0, vocab, 30)]), 40, False)
    rest = [(rng.randint(0, vocab, p), n, stream) for p, n, stream in
            ((700, 128, False), (16, 64, True), (300, 96, False),
             (40, 32, False), (500, 100, False))]
    return [(p.astype(np.int32), n, s) for p, n, s in
            [first, second] + rest], shared


def _http_round(url: str, bodies):
    """POST the first body alone, then the others concurrently; returns
    the answers, the SSE event count and the wall seconds."""
    answers = [None] * len(bodies)
    sse_events = 0

    def call(i):
        nonlocal sse_events
        answers[i], ev = _post(url + "/v1/completions", bodies[i])
        sse_events += ev if bodies[i].get("stream") else 0

    t0 = time.perf_counter()
    call(0)
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(1, len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(a is None for a in answers):
        raise RuntimeError("a request got no answer")
    return answers, sse_events, time.perf_counter() - t0


def _tick_profile(torch, eng, vocab: int, ticks: int = SLOT_PROFILE_TICKS):
    """All slots of ``eng`` live (64-token prompts), then ``ticks`` decode
    ticks timed on the host clock, and as many again under
    ``torch.profiler``: host wall and device busy (union of kernel
    intervals) per tick, and the idle share between them."""
    from torch.profiler import ProfilerActivity, profile

    from autodist_tpu_torch.profile_decode import _union_us

    rng = np.random.RandomState(SEED + 9)
    ids = [eng.submit(rng.randint(0, vocab, 64), 2 * ticks + 48)
           for _ in range(eng._slots)]
    eng.step()                      # admission, prefill, the first chunk

    def window():
        torch.cuda.synchronize()
        t0, start = time.perf_counter(), eng.stats.ticks
        while eng.stats.ticks - start < ticks:
            eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, eng.stats.ticks - start

    wall_s, n = window()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, n_prof = window()
    for rid in ids:
        eng.cancel(rid)
    eng.run()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    busy_ms = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels) / n_prof / 1e3
    wall_ms = wall_s / n * 1e3
    return {"live_slots": eng._slots, "ticks": n, "wall_ms_per_tick": wall_ms,
            "device_busy_ms_per_tick": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_tick": len(kernels) / n_prof}


def phase_serve_slot(torch, spec, params, tree: str, device="cuda",
                     geom=SLOT_GEOM, oracle=None):
    """``serve(spec, params)``, the slot ``DecodeEngine`` (serve()'s
    default), over real HTTP with ``phase_serve``'s seven requests (the
    shared prefix registered with ``prefix_tokens`` and opted into), after
    a warm-up pass: token-exact against the generator (``oracle``: its
    outputs for these requests on this tree, as ``phase_serve`` computed
    them); on the int8 tree K10 once per projection and head per decode
    tick and prefill dispatch (``6 * layers + 1``); then a decode-tick
    profile of the same engine."""
    from autodist_tpu_torch.models.generate import make_generator
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops import quant
    from autodist_tpu_torch.serving import DecodeEngine, serve

    vocab = spec.config["vocab_size"]
    requests, shared = _serve_requests(vocab, SEED + 1)
    bodies = []
    for i, (prompt, n, stream) in enumerate(requests):
        tail = prompt[shared.size:] if i < 2 else prompt
        bodies.append({"prompt_tokens": [int(t) for t in tail],
                       "max_new_tokens": n, "stream": stream,
                       "use_prefix": i < 2})
    warm = DecodeEngine(spec, params, device=device, **geom)
    warm.set_prefix(shared)
    for b in bodies:
        warm.submit(b["prompt_tokens"], 2, use_prefix=b["use_prefix"])
    warm.run()
    del warm
    srv = serve(spec, params, device=device, host="127.0.0.1", port=0,
                prefix_tokens=shared, **geom)
    try:
        if type(srv.engine) is not DecodeEngine:
            raise AssertionError(f"serve() built {type(srv.engine)}")
        _reset_all_counts()          # the main path starts here
        answers, sse_events, wall = _http_round(
            "http://%s:%d" % srv.address, bodies)
        counts = _kernel_counts()    # read just after it
    finally:
        srv.close()
    eng = srv.engine
    layers = spec.config["num_layers"]
    per_forward = 6 * layers + 1
    dispatches = eng.stats.ticks + eng.stats.prefill_dispatches
    if tree == "int8":
        _expect_launches("slot int8 K10", counts["int8_matmul"],
                         per_forward * dispatches)
    else:
        _expect_launches("slot f32 K10", counts["int8_matmul"], 0)
    _expect_launches("slot K9", counts["paged_attention"], 0)
    if sse_events < 2:
        raise AssertionError("the streamed request sent no SSE events")
    if eng.stats.prefix_admissions != 2:
        raise AssertionError(f"prefix admissions {eng.stats}")
    gen = make_generator(spec, device=device)
    for i, ((prompt, n, _), ans) in enumerate(zip(requests, answers)):
        got = np.asarray(ans["tokens"])
        if i < 2:      # the prefix is attended, not returned
            got = np.concatenate([shared, got])
        _check_exact(torch, gen, params, prompt, n, got,
                     f"slot {tree} HTTP request {i}",
                     want=None if oracle is None else oracle[i])
    out = {"tree": tree, "layers": layers, "requests": len(requests),
           "http_wall_s": wall,
           "launches": counts, "int8_matmul_per_dispatch":
           per_forward if tree == "int8" else 0,
           "generated_tokens": eng.stats.generated_tokens,
           "slot_utilization": eng.stats.slot_utilization,
           "sse_events": sse_events, **_rates(eng)}
    out["profile"] = _tick_profile(torch, eng, vocab)
    return out


def phase_beam_score(torch, spec, params, device="cuda"):
    """``beam_search`` and ``score`` at full width: batch 2, a 16-token
    prompt, 32 new tokens.  Width 1 equals greedy decode; width 4 runs;
    ``score`` (one forward through ``spec.apply_fn``: K1 once per layer)
    equals the log-softmax sum of the teacher-forced decode logits at
    rtol ``SCORE_RTOL``."""
    from autodist_tpu_torch.models.generate import make_generator

    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    gen = make_generator(spec, device=device)
    rng = np.random.RandomState(SEED + 3)
    prompt = rng.randint(0, spec.config["vocab_size"],
                         (BEAM_BATCH, BEAM_PROMPT)).astype(np.int32)
    greedy = gen(params, prompt, BEAM_NEW)
    gen.beam_search(params, prompt, BEAM_NEW, num_beams=4)   # warm-up
    times = {}
    for beams in (1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, logprob = gen.beam_search(params, prompt, BEAM_NEW,
                                          num_beams=beams)
        torch.cuda.synchronize()
        times[beams] = time.perf_counter() - t0
        if beams == 1 and not torch.equal(tokens, greedy):
            raise AssertionError("beam_search(num_beams=1) differs from "
                                 "greedy decode")
        if not bool(torch.isfinite(logprob).all()) \
                or tokens.shape != greedy.shape:
            raise AssertionError(f"beam {beams}: {tokens.shape}, {logprob}")
    gen.score(params, greedy)                                  # warm-up
    _reset_all_counts()              # the main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll, ppl = gen.score(params, greedy)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    k1 = fa.flash_attention.fwd_calls
    _expect_launches("score K1", k1, spec.config["num_layers"])
    t = greedy.shape[1] - 1
    _, logits = gen.with_logits(params, greedy, 1)
    forced = torch.log_softmax(logits[:t].float(), dim=-1).gather(
        -1, greedy[:, 1:].t()[..., None])[..., 0].sum(0)
    rel = float(((ll - forced).abs() / forced.abs()).max())
    if not rel <= SCORE_RTOL or not bool(torch.isfinite(ppl).all()):
        raise AssertionError(f"score {ll.tolist()} vs decode logits "
                             f"{forced.tolist()}: rel {rel:.2e}")
    return {"batch": BEAM_BATCH, "prompt": BEAM_PROMPT, "new": BEAM_NEW,
            "beam1_equals_greedy": True, "beam_ms": {
                str(k): v * 1e3 for k, v in times.items()},
            "score_ms": score_s * 1e3, "log_likelihood": ll.tolist(),
            "perplexity": ppl.tolist(), "score_max_rel_diff": rel,
            "score_rtol": SCORE_RTOL, "flash_fwd_per_score": k1}


def phase_spec(torch, spec, params, device="cuda", geom=SERVE_GEOM):
    """Speculative decoding at full width with two drafts: the target
    itself (acceptance at least ``SELF_ACCEPT_MIN``) and a 2-layer model
    of the same widths from another seed.  The slot generator
    (``make_speculative_generator``, gamma ``SPEC_GAMMA``) and
    ``serve(speculative=...)`` (the paged engine, adaptive gamma, K9 in
    every draft tick) are token-exact against target-only greedy."""
    from autodist_tpu_torch.models import (make_generator,
                                           make_speculative_generator)
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.serving import serve

    cfg = {k: v for k, v in spec.config.items() if k != "seq_len"}
    small = transformer_lm(**{**cfg, "num_layers": SPEC_DRAFT_LAYERS})
    drafts = {"self": (spec, params),
              "draft2": (small, small.init(SEED + 5, device=device))}
    gen = make_generator(spec, device=device)
    rng = np.random.RandomState(SEED + 4)
    vocab = cfg["vocab_size"]
    prompt = rng.randint(0, vocab, (SPEC_BATCH, SPEC_PROMPT)) \
        .astype(np.int32)
    want = gen(params, prompt, SPEC_NEW)
    reqs = [(rng.randint(0, vocab, p).astype(np.int32), n)
            for p, n in SPEC_REQUESTS]
    wants = [gen(params, p[None], n)[0].cpu().numpy() for p, n in reqs]
    out = {}
    for name, (dspec, dparams) in drafts.items():
        sg = make_speculative_generator(spec, dspec, device=device)
        sg(params, dparams, prompt[:, :8], 4, SPEC_GAMMA)       # warm-up
        _reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, stats = sg(params, dparams, prompt, SPEC_NEW, SPEC_GAMMA)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _kernel_counts()
        if not torch.equal(tokens, want):
            raise AssertionError(f"speculative generator ({name}) differs "
                                 f"from target-only greedy")
        _expect_launches(f"spec generator ({name}) K9",
                         counts["paged_attention"], 0)
        gen_accept = float(stats["accepted"].sum() / stats["proposed"].sum())
        srv = serve(spec, params, device=device, host="127.0.0.1", port=0,
                    speculative={"spec": dspec, "params": dparams,
                                 "gamma": SPEC_GAMMA, "adapt_gamma": True},
                    **geom)
        try:
            url = "http://%s:%d" % srv.address
            _post(url + "/v1/completions",
                  {"prompt_tokens": [1, 2, 3], "max_new_tokens": 8})
            srv.engine.timeline.clear()
            _reset_all_counts()          # the main path starts here
            answers, _, http_s = _http_round(url, [
                {"prompt_tokens": [int(t) for t in p], "max_new_tokens": n}
                for p, n in reqs])
            counts_paged = _kernel_counts()
            sched = srv.engine.scheduler_stats()["speculative"]
        finally:
            srv.close()
        eng = srv.engine
        eng.assert_no_leaks()
        for i, (ans, w) in enumerate(zip(answers, wants)):
            if not np.array_equal(np.asarray(ans["tokens"]), w):
                _check_exact(torch, gen, params, reqs[i][0], reqs[i][1],
                             ans["tokens"], f"paged spec ({name}) {i}")
        rounds = [e for e in eng.timeline if e[0] == "spec"]
        draft_ticks = sum(e[4] for e in rounds)
        _expect_launches(f"paged spec ({name}) K9",
                         counts_paged["paged_attention"],
                         dspec.config["num_layers"] * draft_ticks)
        accept = sched["acceptance_rate"]
        if name == "self" and not (accept >= SELF_ACCEPT_MIN
                                   and gen_accept >= SELF_ACCEPT_MIN):
            raise AssertionError(f"self-draft acceptance {accept} / "
                                 f"{gen_accept} below {SELF_ACCEPT_MIN}")
        round_s = sum(e[3] for e in rounds)
        out[name] = {
            "draft_layers": dspec.config["num_layers"],
            "generator": {"acceptance": gen_accept,
                          "iterations": stats["iterations"],
                          "tokens_per_s": SPEC_BATCH * SPEC_NEW / wall,
                          "wall_ms": wall * 1e3},
            "paged": {"acceptance": accept,
                      "mean_accept_len": sched["mean_accept_len"],
                      "gamma_hist": sched["gamma_hist"],
                      "rounds": len(rounds), "draft_ticks": draft_ticks,
                      "paged_attention_per_round":
                      counts_paged["paged_attention"] / len(rounds),
                      "tokens_per_s": sum(e[2] for e in rounds) / round_s,
                      "ms_per_round": round_s / len(rounds) * 1e3,
                      "http_wall_s": http_s,
                      "launches": counts_paged}}
    return {"gamma": SPEC_GAMMA, "batch": SPEC_BATCH, "prompt": SPEC_PROMPT,
            "new": SPEC_NEW, "requests": SPEC_REQUESTS, **out}


def _corpus(seed: int, words: int = TOKENIZER_WORDS):
    """Text the script makes: sentences of pseudo-words (a few hundred
    distinct ones, Zipf-like frequencies) with digits and punctuation."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("etaoinshrdlcumwfgypbvkjxqz"))
    vocab = ["".join(rng.choice(letters, rng.randint(2, 9),
                                p=None)) for _ in range(400)]
    weights = 1.0 / np.arange(1, len(vocab) + 1)
    picks = rng.choice(len(vocab), words, p=weights / weights.sum())
    out, line = [], []
    for i, w in enumerate(picks):
        line.append(vocab[w])
        if rng.rand() < 0.08:
            line.append(str(rng.randint(0, 1000)))
        if len(line) > 12:
            out.append(" ".join(line) + rng.choice([".", "?", "!", ","]))
            line = []
    return out


def phase_tokenizer(torch, spec, params, device="cuda", geom=SLOT_GEOM):
    """A ``BPETokenizer`` trained here on generated text, its vocabulary
    padded with reserved tokens to the model's (as T5's 32128 holds extra
    ids beside its merges), served by ``serve(tokenizer=, prefix_text=)``:
    ``{"prompt": text}`` answers ``text`` whose tokens are the generator's
    on ``encode(text)`` (the tokenizer's ``<eos>`` is the engine's)."""
    from autodist_tpu_torch.models.generate import make_generator
    from autodist_tpu_torch.runtime import BPETokenizer
    from autodist_tpu_torch.serving import serve

    texts = _corpus(SEED + 6)
    t0 = time.perf_counter()
    tok = BPETokenizer.train(texts, vocab_size=256 + TOKENIZER_MERGES,
                             special_tokens=["<eos>"])
    train_s = time.perf_counter() - t0
    vocab = spec.config["vocab_size"]
    tok.add_special_tokens([f"<extra_{i}>"
                            for i in range(vocab - tok.vocab_size)])
    sample = " ".join(texts[:40])
    sample_ids = tok.encode(sample)
    if tok.decode(sample_ids) != sample or tok.vocab_size != vocab:
        raise AssertionError("the tokenizer does not round-trip")
    prefix = texts[0]
    srv = serve(spec, params, device=device, host="127.0.0.1", port=0,
                tokenizer=tok, prefix_text=prefix, **geom)
    try:
        if srv.engine._eos_id != tok.eos_id:
            raise AssertionError("the tokenizer's <eos> is not the engine's")
        url = "http://%s:%d" % srv.address
        bodies = [{"prompt": texts[1], "max_new_tokens": 24},
                  {"prompt": " " + texts[2], "max_new_tokens": 24,
                   "use_prefix": True}]
        answers, _, wall = _http_round(url, bodies)
    finally:
        srv.close()
    gen = make_generator(spec, device=device)
    pre = tok.encode(prefix)
    for body, ans in zip(bodies, answers):
        ids = tok.encode(body["prompt"])
        full = (pre if body.get("use_prefix") else []) + ids
        want = gen(params, np.asarray([full]), body["max_new_tokens"],
                   eos_id=tok.eos_id)[0].cpu().numpy()[len(full) - len(ids):]
        got = np.asarray(ans["tokens"])
        if not (np.array_equal(got, want[:got.size]) and (
                got.size == want.size or got[-1] == tok.eos_id)):
            raise AssertionError(f"text request differs from the generator "
                                 f"on encode(text): {got} vs {want}")
        if ans["text"] != tok.decode(ans["tokens"]) \
                or not ans["text"].startswith(body["prompt"]):
            raise AssertionError(f"text {ans['text'][:80]!r} does not "
                                 f"round-trip {body['prompt'][:40]!r}")
    return {"merges": len(tok.merges), "vocab_size": tok.vocab_size,
            "train_s": train_s, "corpus_bytes": sum(len(t) for t in texts),
            "bytes_per_token": len(sample.encode()) / len(sample_ids),
            "prefix_tokens": len(pre), "requests": len(bodies),
            "http_wall_s": wall}


def phase_lora(torch, spec, params, device="cuda", geom=SLOT_GEOM):
    """``lora_setup`` on the full-width LM (rank ``LORA_RANK`` on the
    attention and MLP kernels) through the facade (``AllReduce()``, Adam):
    ``LORA_WARMUP`` + ``LORA_TIMED`` steps, K1–K3 once per layer each per
    step, losses finite and falling, the base bit-identical; the merged
    tree served by ``serve()`` is token-exact against the generator on
    it."""
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.models import lora_setup, make_generator
    from autodist_tpu_torch.serving import serve
    from autodist_tpu_torch.strategy import AllReduce

    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    base = {n: x.clone() for n, x in flatten(params)}
    setup = lora_setup(params, spec.loss_fn, rank=LORA_RANK,
                       targets=LORA_TARGETS,
                       rng=torch.Generator(device=device).manual_seed(SEED))
    _fresh_peak(torch)
    ad = adm.AutoDist(strategy_builder=AllReduce(), device=device)
    with ad.scope():
        ad.capture(**setup.capture_args, optimizer=optim.adam(LORA_LR))
    sess = ad.create_distributed_session()
    batch = spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED)
    layers = spec.config["num_layers"]
    losses, step_s = [], []
    for i in range(LORA_WARMUP + LORA_TIMED):
        fa.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(sess.run(batch)["loss"]))
        torch.cuda.synchronize()
        if i >= LORA_WARMUP:
            step_s.append(time.perf_counter() - t0)
        _expect_launches(f"lora step {i} (K1, K2, K3)",
                         _flash_counts(fa.flash_attention),
                         (layers, layers, layers))
    launches = _flash_counts(fa.flash_attention)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite LoRA loss: {losses}")
    _check_falling(losses)
    trained = sess.device_params
    changed = [n for n, x in flatten(trained["base"])
               if not torch.equal(x, base[n])]
    if changed:
        raise AssertionError(f"LoRA changed base parameters: {changed[:5]}")
    merged = setup.merge(trained)
    peak = torch.cuda.max_memory_allocated()
    del sess, ad
    _fresh_peak(torch)
    rng = np.random.RandomState(SEED + 7)
    reqs = [(rng.randint(0, spec.config["vocab_size"], p).astype(np.int32),
             n) for p, n in ((24, 16), (80, 24))]
    srv = serve(spec, merged, device=device, host="127.0.0.1", port=0,
                **geom)
    try:
        answers, _, _ = _http_round("http://%s:%d" % srv.address, [
            {"prompt_tokens": [int(t) for t in p], "max_new_tokens": n}
            for p, n in reqs])
    finally:
        srv.close()
    gen = make_generator(spec, device=device)
    for i, ((prompt, n), ans) in enumerate(zip(reqs, answers)):
        _check_exact(torch, gen, merged, prompt, n, ans["tokens"],
                     f"merged LoRA request {i}")
    return {"rank": LORA_RANK, "adapter_params": setup.num_adapter_params,
            "losses": losses, **_step_rates(torch, spec, step_s),
            "max_memory_allocated": peak,
            "launches": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                                 launches)),
            "launches_per_step": layers, "served_requests": len(reqs)}




#: ``lm_params``' first draw of each LM configuration and seed
_LM_PARAMS = {}


def lm_params(spec, seed: int = SEED, device=None):
    """``spec.init(seed, device=device)`` for a ``transformer_lm`` spec,
    drawn on the CPU once a process for each configuration and seed and
    copied from that draw after it: the same bits (the LMs here are all
    float32, so the config and the seed fix them), without the CPU's
    truncated-normal draw of every session (the 4 ring ranks draw at
    once on the host's shared cores).  The device is resolved as the
    spec's own ``init`` resolves it."""
    from autodist_tpu_torch.models import base

    key = (spec.name, tuple(sorted(spec.config.items())), seed)
    if key not in _LM_PARAMS:
        _LM_PARAMS[key] = spec.init(seed, device="cpu")
    device = base.resolve_device(device)

    def copy(tree):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        return tree.to(device, copy=True)
    return copy(_LM_PARAMS[key])


def _fresh_peak(torch) -> None:
    """Drop the last phase's facade (the process's default AutoDist holds
    its session), collect what only reference cycles still hold, and
    restart the peak-memory counter from what is left."""
    import gc

    from autodist_tpu_torch import autodist as adm

    adm._reset_default_autodist_for_testing()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _train_session(spec, params, batch_rows, builder=None, optimizer=None,
                   loss_fn=None, numerics=None, resource_info=None,
                   accum_steps=1, validate=None):
    """The program users run: ``AutoDist(builder)`` → capture → session,
    on the card (default: ``AllReduce()`` with ``adamw(1e-3)``;
    ``resource_info``: the cluster's resource spec as a dict)."""
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AllReduce

    adm._reset_default_autodist_for_testing()   # one facade per phase
    ad = adm.AutoDist(strategy_builder=builder or AllReduce(),
                      resource_spec=ResourceSpec(resource_info=resource_info)
                      if resource_info else None)
    with ad.scope():
        ad.capture(params=params, optimizer=optimizer or optim.adamw(1e-3),
                   loss_fn=loss_fn or spec.loss_fn,
                   sparse_vars=spec.sparse_vars, numerics=numerics,
                   accum_steps=accum_steps)
    return ad.create_distributed_session(validate=validate), \
        spec.sample_batch(batch_rows, seed=SEED)


def model_flops_per_step(cfg, batch: int) -> dict:
    """Model FLOPs of one training step of ``transformer_lm``: 6 per
    token and weight of every projection and the tied head (forward,
    input and weight gradients), plus the nine causal T x T x D products
    the flash kernels do per layer (two forward, three in dQ, four in
    dK/dV, the backward recomputing S)."""
    d = cfg["num_heads"] * cfg["head_dim"]
    t = cfg["seq_len"]
    weights = cfg["num_layers"] * (4 * d * d + 2 * d * cfg["d_ff"]) \
        + cfg["vocab_size"] * d
    dense = 6.0 * weights * batch * t
    attn = 9 * 2.0 * batch * cfg["num_heads"] * t * (t + 1) // 2 \
        * cfg["head_dim"] * cfg["num_layers"]
    return {"projections_and_head": dense, "attention": attn,
            "total": dense + attn}


def phase_train(torch):
    """Full-width training through the facade: launches per step, losses,
    step time, tokens/s, peak memory, MFU against the f32 peak."""
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

    spec = transformer_lm()       # attn_fn=None: K1–K3 on the card
    layers = spec.config["num_layers"]
    params = lm_params(spec)
    shapes = {n: tuple(x.shape) for n, x in flatten(params)}
    _fresh_peak(torch)
    sess, batch = _train_session(spec, params, TRAIN_SHAPE["B"])
    del params
    fa_fn = fa.flash_attention
    fa.reset_counts()             # the main path starts here
    losses, step_s = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        before = _flash_counts(fa_fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(sess.run(batch)["loss"]))
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            step_s.append(time.perf_counter() - t0)
        per_step = tuple(a - b for a, b in zip(_flash_counts(fa_fn), before))
        if per_step != (layers, layers, layers):
            raise AssertionError(f"step {i} launched (K1, K2, K3) = "
                                 f"{per_step}, expected {layers} each")
    launches = _flash_counts(fa_fn)   # read just after the main path
    before = launches
    ev = sess.evaluate(batch)
    ev_launches = tuple(a - b for a, b in zip(_flash_counts(fa_fn), before))
    if ev_launches != (layers, 0, 0):
        raise AssertionError(f"evaluate launched (K1, K2, K3) = "
                             f"{ev_launches}, expected ({layers}, 0, 0)")
    if not all(np.isfinite(losses)) or not np.isfinite(float(ev["loss"])):
        raise AssertionError(f"non-finite loss: {losses}, eval {ev}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    got = {n: tuple(x.shape) for n, x in flatten(sess.params)}
    if got != shapes:
        raise AssertionError("session.params differ from the init tree")
    step = statistics.median(step_s)
    flops = model_flops_per_step(spec.config, TRAIN_SHAPE["B"])
    tokens = TRAIN_SHAPE["B"] * spec.config["seq_len"]
    out = {"layers": layers, "batch": TRAIN_SHAPE["B"],
           "seq_len": spec.config["seq_len"], "losses": losses,
           "eval_loss": float(ev["loss"]), "ms_per_step": step * 1e3,
           "ms_per_step_min": min(step_s) * 1e3,
           "ms_per_step_max": max(step_s) * 1e3,
           "tokens_per_s": tokens / step,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "model_tflop_per_step": flops["total"] / 1e12,
           "model_tflop_split": {k: v / 1e12 for k, v in flops.items()},
           "mfu_f32": flops["total"] / step / H100_F32_FLOPS,
           "launches": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                                launches)),
           "launches_per_step": layers, "eval_launches": list(ev_launches)}
    del sess
    torch.cuda.empty_cache()
    return out


def phase_train_parity(torch):
    """Depth 2 at full width: flash kernels vs dense attention from the
    same parameters, 3 ``adamw`` steps, losses at rtol 1e-4."""
    from autodist_tpu_torch.models.transformer import dense_attention
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

    flash_spec = transformer_lm(num_layers=2)
    dense_spec = transformer_lm(num_layers=2, attn_fn=dense_attention)
    params = lm_params(flash_spec)
    out = {}
    for name, spec in (("flash", flash_spec), ("dense", dense_spec)):
        sess, batch = _train_session(spec, params, TRAIN_SHAPE["B"])
        before = _flash_counts(fa.flash_attention)
        out[name] = [float(sess.run(batch)["loss"]) for _ in range(3)]
        launched = tuple(a - b for a, b in
                         zip(_flash_counts(fa.flash_attention), before))
        want = (6, 6, 6) if name == "flash" else (0, 0, 0)
        if launched != want:
            raise AssertionError(f"{name} run launched (K1, K2, K3) = "
                                 f"{launched}, expected {want}")
        del sess
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["flash"], out["dense"]))
    if not rel <= 1e-4:
        raise AssertionError(f"flash vs dense losses differ (rel {rel:.2e}):"
                             f" {out}")
    torch.cuda.empty_cache()
    return {"layers": 2, "flash_losses": out["flash"],
            "dense_losses": out["dense"], "max_rel_diff": rel,
            "rtol": 1e-4}


def _sync_counts(fk):
    return (fk.fused_detect_stats.calls, fk.fused_adam_update.calls)


def _plan_digest(buckets) -> str:
    """One digest of a bucket plan: keys, members, offsets, sizes."""
    digest = hashlib.sha256()
    for b in buckets:
        digest.update(repr((b.key, b.mode, [(v.name, v.shape, v.offset)
                                             for v in b.vars],
                            b.total, b.padded_total)).encode())
    return digest.hexdigest()


def _kernel_counts() -> dict:
    """K1–K10's launch counters by kernel name."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops import quant

    return dict(zip(("flash_fwd", "flash_dq", "flash_dkv", "detect_stats",
                     "adam_update", "quant_hop_quantize",
                     "quant_hop_accumulate", "quant_hop_dequant_add",
                     "paged_attention", "int8_matmul"),
                    _flash_counts(fa.flash_attention) + _sync_counts(fk)
                    + _quant_counts(fk) + (fk.paged_attention.calls,
                                           quant.int8_matmul.calls)))


def _reset_all_counts() -> None:
    """Set K1–K10's launch counters to 0."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops import quant

    fa.reset_counts()
    fk.fused_detect_stats.calls = fk.fused_adam_update.calls = 0
    fk.fused_quantize.calls = fk.fused_hop_accumulate.calls = 0
    fk.fused_dequant_add.calls = fk.paged_attention.calls = 0
    quant.int8_matmul.calls = 0


def _checked_steps(torch, name, sess, batch, want, warmup, timed,
                   guarded):
    """``warmup + timed`` steps of ``sess``, each checked to launch exactly
    ``want`` (K1–K10 by name) and to be finite; ``guarded`` sessions must
    return ``grad_health`` with nothing skipped and a finite global norm,
    the others must not: losses, global norms (guarded), the timed steps'
    seconds and the counts read just after the last step.  The counts
    start at 0 here: the main path's launches."""
    _reset_all_counts()
    losses, norms, step_s = [], [], []
    for i in range(warmup + timed):
        before = _kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.run(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            step_s.append(time.perf_counter() - t0)
        per_step = {k: v - before[k] for k, v in _kernel_counts().items()}
        if per_step != want:
            raise AssertionError(f"{name} step {i} launched {per_step}, "
                                 f"expected {want}")
        if ("grad_health" in out) != guarded:
            raise AssertionError(f"{name} step {i}: grad_health "
                                 f"{'missing' if guarded else 'unexpected'}")
        if guarded:
            h = out["grad_health"]
            if not bool(h.all_finite) or int(h.skipped_steps) != 0 \
                    or not np.isfinite(float(h.global_norm)):
                raise AssertionError(f"{name} step {i}: grad_health {h}")
            norms.append(float(h.global_norm))
        losses.append(float(out["loss"]))
    launches = _kernel_counts()               # read just after the main path
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    return losses, norms, step_s, launches


def _bucketed_steps(torch, sess, batch, layers, warmup, timed):
    """:func:`_checked_steps` of a bucketed session with the guard and K5:
    K1–K3 once per layer, K4 twice per bucket and K5 once per
    reduce-scatter bucket each step (whether the losses fall is the
    caller's check: 7 steps at lr 1e-3 end on a spike that step 8 takes
    back); its results and the per-step counts."""
    want = dict(dict.fromkeys(_kernel_counts(), 0), flash_fwd=layers,
                flash_dq=layers, flash_dkv=layers,
                detect_stats=2 * len(sess._step.buckets),
                adam_update=len(sess.zero1_buckets))
    return _checked_steps(torch, "bucketed step", sess, batch, want, warmup,
                          timed, guarded=True) + (want,)


def _check_falling(losses) -> None:
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")


def _step_rates(torch, spec, step_s) -> dict:
    step = statistics.median(step_s)
    flops = model_flops_per_step(spec.config, TRAIN_SHAPE["B"])
    return {"ms_per_step": step * 1e3, "ms_per_step_min": min(step_s) * 1e3,
            "ms_per_step_max": max(step_s) * 1e3,
            "tokens_per_s": TRAIN_SHAPE["B"] * spec.config["seq_len"] / step,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "mfu_f32": flops["total"] / step / H100_F32_FLOPS}


def phase_train_zero1(torch):
    """Full-width ZeRO-1 training through the facade: K1–K3 12 times and
    K4 2 x buckets, K5 once per bucket each step; losses, step time,
    tokens/s, peak memory, MFU against the f32 peak."""
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import Zero1

    spec = transformer_lm()
    layers = spec.config["num_layers"]
    _fresh_peak(torch)
    sess, batch = _train_session(spec, lm_params(spec), TRAIN_SHAPE["B"],
                                 Zero1(), fk.fusable_adam(1e-3),
                                 numerics={"clip_norm": CLIP_NORM})
    n_buckets = len(sess.zero1_buckets)
    if sess._step.fused_kernels != ("guard", "update"):
        raise AssertionError(f"the step runs {sess._step.fused_kernels}")
    losses, norms, step_s, launches, per_step = _bucketed_steps(
        torch, sess, batch, layers, WARMUP_STEPS, TIMED_STEPS)
    _check_falling(losses)
    mu = sess.opt_state["zero1"]["mu"]
    if sorted(mu) != sorted(b.key for b in sess.zero1_buckets) or any(
            mu[b.key].numel() != b.padded_total for b in sess.zero1_buckets):
        raise AssertionError("ZeRO-1 state does not match the bucket plan")
    elements = sum(b.padded_total for b in sess.zero1_buckets)
    out = {"layers": layers, "batch": TRAIN_SHAPE["B"],
           "seq_len": spec.config["seq_len"], "buckets": n_buckets,
           "bucket_elements": elements,
           "bucket_plan_sha256": _plan_digest(sess._step.buckets),
           # per step over every bucket: K4 reads each element twice (the
           # packed vector and the reduced value), K5 moves 28 bytes each
           "bound_ms_per_step": {
               "detect_stats": bound_ms(8.0 * elements, 4.0 * elements)[0],
               "adam_update": bound_ms(28.0 * elements, 15.0 * elements)[0]},
           "bucket_sizes": sorted({b.total for b in sess.zero1_buckets}),
           "losses": losses, "global_norms": norms,
           **_step_rates(torch, spec, step_s),
           "opt_state_bytes": _state_bytes(sess.opt_state),
           "launches": launches, "launches_per_step": per_step}
    del sess
    torch.cuda.empty_cache()
    return out


def _state_bytes(tree) -> int:
    from autodist_tpu_torch.graph_item import flatten

    return sum(x.numel() * x.element_size() for _, x in flatten(tree))


def _host_tree(tree):
    """``{name: CPU copy}`` of a parameter tree."""
    from autodist_tpu_torch.graph_item import flatten

    return {n: x.detach().cpu() for n, x in flatten(tree)}


def _compare_to(torch, got, want) -> dict:
    """Losses and parameters against another run's: bit for bit, else
    at rtol ``REMAT_RTOL``, naming the leaves whose bits differ."""
    losses_equal = got["losses"] == want["losses"]
    differ = sorted(n for n, x in got["params"].items()
                    if not torch.equal(x, want["params"][n]))
    rel = max([abs(a - b) / abs(b)
               for a, b in zip(got["losses"], want["losses"])] + [0.0])
    for n in differ:
        if not torch.allclose(got["params"][n], want["params"][n],
                              rtol=REMAT_RTOL, atol=0.0):
            raise AssertionError(f"parameter {n} beyond rtol {REMAT_RTOL}")
    if rel > REMAT_RTOL:
        raise AssertionError(f"losses {got['losses']} differ from "
                             f"{want['losses']} by {rel:.2e}")
    return {"bit_equal": losses_equal and not differ,
            "losses_bit_equal": losses_equal,
            "max_rel_loss_diff": rel, "leaves_differing": differ}


def _dots_kept_ops(torch) -> dict:
    """What the ``dots`` policy keeps on the card: one forward and
    backward of a depth-1 full-width LM (batch 2) under the policy, the
    kept operators counted by name, and whether the flash operator K1
    was recomputed (kept: no)."""
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)

    from autodist_tpu_torch.graph_item import _REMAT_POLICIES, flatten
    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    saved, kept, recomputed = _REMAT_POLICIES["dots"], {}, set()

    def policy(ctx, op, *args, **kwargs):
        if ctx.is_recompute:
            return CheckpointPolicy.PREFER_RECOMPUTE
        if op in saved:
            kept[str(op)] = kept.get(str(op), 0) + 1
            return CheckpointPolicy.MUST_SAVE
        recomputed.add(str(op))
        return CheckpointPolicy.PREFER_RECOMPUTE

    spec = transformer_lm(num_layers=1)
    params = lm_params(spec)
    for _, x in flatten(params):
        x.requires_grad_()
    checkpoint(spec.loss_fn, params, spec.sample_batch(2, seed=SEED),
               use_reentrant=False,
               context_fn=lambda: create_selective_checkpoint_contexts(
                   policy)).backward()
    k1 = "autodist_tpu_torch.flash_fwd.default"
    if kept.get("aten.mm.default") != 6 or k1 not in recomputed:
        raise AssertionError(f"dots kept {kept}; K1 recomputed: "
                             f"{k1 in recomputed}")
    return {"kept": kept, "flash_fwd_recomputed": True}


def phase_train_remat(torch):
    """``transformer_lm(remat=)`` at full width under ``Zero1`` +
    ``fusable_adam`` + clip, each of :data:`REMAT_CONFIGS`: ms per step,
    tokens/s, peak memory, K1–K3 per step (K1 twice per layer under
    ``full``/``dots``: the backward recomputes it), ``mfu_f32`` on the
    model's FLOPs (the recompute not counted); at batch 8 ``full`` and
    ``dots`` against ``none``, bit for bit or at ``REMAT_RTOL``."""
    from autodist_tpu_torch.graph_item import flatten, unflatten
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import Zero1

    layers = transformer_lm().config["num_layers"]
    params0 = flatten(lm_params(transformer_lm(), device="cpu"))
    configs, runs = [], {}
    for remat, rows in REMAT_CONFIGS:
        spec = transformer_lm(remat=remat)
        _fresh_peak(torch)
        params = unflatten([(n, x.to("cuda")) for n, x in params0])
        sess, batch = _train_session(spec, params, rows, Zero1(),
                                     fk.fusable_adam(1e-3),
                                     numerics={"clip_norm": CLIP_NORM})
        del params
        want = dict(dict.fromkeys(_kernel_counts(), 0),
                    flash_fwd=layers * (1 if remat == "none" else 2),
                    flash_dq=layers, flash_dkv=layers,
                    detect_stats=2 * len(sess._step.buckets),
                    adam_update=len(sess.zero1_buckets))
        name = f"train_remat {remat} batch {rows}"
        losses, _, step_s, launches = _checked_steps(
            torch, name, sess, batch, want, REMAT_WARMUP, REMAT_TIMED,
            guarded=True)
        step = statistics.median(step_s)
        flops = model_flops_per_step(spec.config, rows)
        out = {"remat": remat, "batch": rows, "losses": losses,
               "ms_per_step": step * 1e3,
               "ms_per_step_min": min(step_s) * 1e3,
               "ms_per_step_max": max(step_s) * 1e3,
               "tokens_per_s": rows * spec.config["seq_len"] / step,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "mfu_f32": flops["total"] / step / H100_F32_FLOPS,
               "launches": {k: v for k, v in launches.items() if v},
               "launches_per_step": {k: v for k, v in want.items() if v}}
        if rows == TRAIN_SHAPE["B"]:
            runs[remat] = {"losses": losses,
                           "params": _host_tree(sess.device_params)}
            if remat != "none":
                out["vs_none"] = _compare_to(torch, runs[remat],
                                             runs["none"])
        configs.append(out)
        del sess
    del runs
    _fresh_peak(torch)
    return {"configs": configs, "warmup": REMAT_WARMUP,
            "timed": REMAT_TIMED, "dots_kept_ops": _dots_kept_ops(torch)}


def phase_train_bf16_state(torch, zero1_out):
    """``train_zero1`` with ``cast_opt_state(fusable_adam(1e-3))``: bf16
    moments on the ZeRO-1 shards, the count int32; K5 dropped by the
    rule (its reason printed), K4 twice per bucket; the state's bytes and
    ms per step against ``train_zero1``'s; losses finite and falling."""
    import warnings

    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops.opt_state_dtype import cast_opt_state
    from autodist_tpu_torch.strategy import Zero1

    spec = transformer_lm()
    layers = spec.config["num_layers"]
    _fresh_peak(torch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sess, batch = _train_session(
            spec, lm_params(spec), TRAIN_SHAPE["B"], Zero1(),
            cast_opt_state(fk.fusable_adam(1e-3)),
            numerics={"clip_norm": CLIP_NORM})
    reason = fk.fused_drop_reason(fk.KERNEL_UPDATE, optimizer_fusable=False)
    if sess._step.fused_kernels != (fk.KERNEL_GUARD,) or not any(
            reason in str(w.message) for w in caught):
        raise AssertionError(f"the step runs {sess._step.fused_kernels}; "
                             f"warnings {[str(w.message) for w in caught]}")
    want = dict(dict.fromkeys(_kernel_counts(), 0), flash_fwd=layers,
                flash_dq=layers, flash_dkv=layers,
                detect_stats=2 * len(sess._step.buckets))
    losses, norms, step_s, launches = _checked_steps(
        torch, "train_bf16_state", sess, batch, want, BF16_WARMUP,
        BF16_TIMED, guarded=True)
    _check_falling(losses)
    dtypes = sorted({f"{x.dim()}:{x.dtype}"
                     for _, x in flatten(sess.opt_state)})
    if dtypes != ["0:torch.int32", "1:torch.bfloat16"]:
        raise AssertionError(f"optimizer state dtypes {dtypes}")
    state_bytes = _state_bytes(sess.opt_state)
    ref = zero1_out["losses"][:len(losses)]
    out = {"losses": losses, "global_norms": norms,
           "losses_train_zero1": ref,
           "max_rel_loss_diff_vs_train_zero1": max(
               abs(a - b) / abs(b) for a, b in zip(losses, ref)),
           **_step_rates(torch, spec, step_s),
           "ms_per_step_train_zero1": zero1_out["ms_per_step"],
           "opt_state_bytes": state_bytes,
           "opt_state_bytes_train_zero1": zero1_out["opt_state_bytes"],
           "opt_state_ratio": state_bytes / zero1_out["opt_state_bytes"],
           "opt_state_dtypes": dtypes, "k5_drop_reason": reason,
           "launches": launches, "launches_per_step": want}
    del sess
    torch.cuda.empty_cache()
    return out


#: the ``export`` phase's serving process: loads each export (on the card,
#: then on the CPU) with the checkpoint package and the kernels' operators
#: only, and writes the outputs, the seconds and the K1/K10 launches
EXPORT_SERVE = """
import json, sys, time
import numpy as np
import torch
import autodist_tpu_torch.checkpoint
import autodist_tpu_torch.ops
import importlib
from autodist_tpu_torch.checkpoint import load_saved_model
from autodist_tpu_torch.ops import quant
fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
root, out = sys.argv[1], {}
tokens = np.load(f"{root}/tokens.npy")
for case in sys.argv[2:]:
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fn = load_saved_model(f"{root}/{case}", device=dev)
        load_s = time.perf_counter() - t0
        fa.reset_counts()
        quant.int8_matmul.calls = 0
        t0 = time.perf_counter()
        y = fn(tokens)
        if dev == "cuda":
            torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        np.save(f"{root}/{case}.{dev}.npy", y.cpu().numpy())
        out[f"{case}/{dev}"] = {
            "load_s": load_s, "first_call_s": serve_s,
            "flash_fwd": fa.flash_attention.fwd_calls,
            "int8_matmul": quant.int8_matmul.calls}
out["models_imported"] = sorted(
    m for m in sys.modules if m.startswith("autodist_tpu_torch.models"))
print(json.dumps(out))
"""


def _dir_size(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _tree_to(tree, to):
    """``.to(to)`` (a device or a dtype) of every tensor of a
    parameter tree (dicts of tensors and ``Quantized`` leaves)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, to) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_to(x, to) for x in tree))
    return tree.to(to)


def phase_export(torch):
    """The full-width LM's logits ``apply_fn`` exported from card params
    (f32, and its int8 tree), served by a fresh process that imports the
    checkpoint package and the operators, not the models: on the card
    bit for bit the eager forward (K1 12 launches; K10 73 on the int8
    tree); on the CPU, where K1's operator runs its plain version, at
    ``EXPORT_RTOL`` / ``EXPORT_ATOL`` of the CPU eager forward of the
    same tree through the same attention function (the saved-model
    test's comparison: a float32 forward of 12 random layers on the CPU
    and on the card differs by the hosts' rounding, which that tolerance
    does not cover on every host); and the f32 tree's card output at the
    same tolerance of a float64 forward of its weights.  Reports the CPU
    against the card, and both against float64; export and load seconds,
    artifact bytes."""
    import math
    import tempfile

    from autodist_tpu_torch.checkpoint import SavedModelBuilder
    from autodist_tpu_torch.models.quantize import quantize_lm_params
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops.flash_attention import flash_attention

    def attention_f64(q, k, v, causal: bool):
        # softmax attention in the inputs' dtype throughout
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) \
            / math.sqrt(q.shape[-1])
        if causal:
            t = q.shape[1]
            mask = torch.ones((t, t), dtype=torch.bool).tril()
            logits = logits.masked_fill(~mask, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd",
                            torch.softmax(logits, dim=-1), v)

    spec = transformer_lm()
    plain_spec = transformer_lm(attn_fn=flash_attention)
    layers = spec.config["num_layers"]
    params = lm_params(spec)
    trees = dict(zip(EXPORT_TREES, (params, quantize_lm_params(params))))
    tokens = np.random.RandomState(SEED).randint(
        0, spec.config["vocab_size"], EXPORT_TOKENS).astype(np.int32)
    root = tempfile.mkdtemp(prefix="export_")
    out = {"tokens": list(EXPORT_TOKENS)}
    try:
        np.save(os.path.join(root, "tokens.npy"), tokens)
        eager, eager_cpu = {}, {}
        for case, tree in trees.items():
            with torch.no_grad():
                eager[case] = spec.apply_fn(tree, tokens).cpu().numpy()
                cpu_tree = _tree_to(tree, "cpu")
                eager_cpu[case] = plain_spec.apply_fn(cpu_tree,
                                                      tokens).numpy()
                if case == "f32":
                    f64 = transformer_lm(attn_fn=attention_f64).apply_fn(
                        _tree_to(cpu_tree, torch.float64), tokens).numpy()
                del cpu_tree
            t0 = time.perf_counter()
            builder = SavedModelBuilder(os.path.join(root, case))
            builder.add_graph_and_variables(spec.apply_fn, tree, [tokens])
            builder.save()
            out[case] = {"export_s": time.perf_counter() - t0,
                         "artifact_bytes": _dir_size(os.path.join(root,
                                                                  case)),
                         "program_bytes": os.path.getsize(os.path.join(
                             root, case, "model.pt2"))}
        del trees, params
        torch.cuda.empty_cache()
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", EXPORT_SERVE, root,
                               *EXPORT_TREES], env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the serving process failed:\n"
                                 f"{proc.stderr[-4000:]}")
        served = json.loads(proc.stdout.strip().splitlines()[-1])
        out["serving_process_s"] = time.perf_counter() - t0
        if served.pop("models_imported"):
            raise AssertionError("the serving process imported the models")
        for case in EXPORT_TREES:
            want = eager[case]
            card = np.load(os.path.join(root, f"{case}.cuda.npy"))
            cpu = np.load(os.path.join(root, f"{case}.cpu.npy"))
            if card.shape != want.shape or not np.isfinite(card).all():
                raise AssertionError(f"export {case}: shape {card.shape}")
            if not np.array_equal(card, want):
                raise AssertionError(
                    f"export {case}: the card's output differs from the "
                    f"eager forward by {np.abs(card - want).max():.3e}")
            np.testing.assert_allclose(cpu, eager_cpu[case],
                                       rtol=EXPORT_RTOL, atol=EXPORT_ATOL)
            if case == "f32":
                np.testing.assert_allclose(card, f64, rtol=EXPORT_RTOL,
                                           atol=EXPORT_ATOL)
                out[case]["f64_max_abs_err"] = {
                    "card": float(np.abs(card - f64).max()),
                    "cpu": float(np.abs(cpu - f64).max())}
            on_card = served[f"{case}/cuda"]
            k10 = 6 * layers + 1 if case == "int8" else 0
            if (on_card["flash_fwd"], on_card["int8_matmul"]) \
                    != (layers, k10) or served[f"{case}/cpu"]["flash_fwd"] \
                    or served[f"{case}/cpu"]["int8_matmul"]:
                raise AssertionError(f"export {case}: launches {served}")
            out[case].update(
                card=on_card, cpu=served[f"{case}/cpu"],
                card_bit_equal=True,
                cpu_max_abs_err=float(np.abs(cpu - eager_cpu[case]).max()),
                cpu_vs_card_max_abs_err=float(np.abs(cpu - want).max()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_train_ps(torch, zero1_out):
    """The facade's default at full width: ``AutoDist()`` with no builder
    builds ``PSLoadBalancing``'s Strategy, whose PS plans lower to the
    same reduce-scatter buckets as ``Zero1()``'s, so the step and its
    kernels are ``train_zero1``'s and so are its losses, bit for bit."""
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import PSLoadBalancing

    spec = transformer_lm()
    layers = spec.config["num_layers"]
    _fresh_peak(torch)
    ad = adm.AutoDist()                       # no builder: the default
    with ad.scope():
        gi = ad.capture(params=lm_params(spec),
                        optimizer=fk.fusable_adam(1e-3),
                        loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                        numerics={"clip_norm": CLIP_NORM})
    built = ad.build_strategy()
    want = PSLoadBalancing().build(gi, ResourceSpec())
    want.id = built.id
    if built.to_dict() != want.to_dict() or {
            n.synchronizer.kind for n in built.node_config} != {"PS"}:
        raise AssertionError("AutoDist() did not build PSLoadBalancing's "
                             "Strategy")
    sess = ad.create_distributed_session()
    batch = spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED)
    if sess._step.fused_kernels != ("guard", "update"):
        raise AssertionError(f"the step runs {sess._step.fused_kernels}")
    digest = _plan_digest(sess._step.buckets)
    if digest != zero1_out["bucket_plan_sha256"]:
        raise AssertionError("the PS bucket plan differs from Zero1's")
    losses, norms, step_s, launches, per_step = _bucketed_steps(
        torch, sess, batch, layers, WARMUP_STEPS, TIMED_STEPS)
    if losses != zero1_out["losses"]:
        raise AssertionError(f"PS losses {losses} are not train_zero1's "
                             f"{zero1_out['losses']} bit for bit")
    out = {"builder": "PSLoadBalancing (the facade's default)",
           "layers": layers, "batch": TRAIN_SHAPE["B"],
           "seq_len": spec.config["seq_len"],
           "buckets": len(sess.zero1_buckets), "bucket_plan_sha256": digest,
           "schedule_fingerprint": sess.schedule_fingerprint,
           "losses": losses, "global_norms": norms,
           "losses_equal_train_zero1": True,
           **_step_rates(torch, spec, step_s),
           "launches": launches, "launches_per_step": per_step}
    del sess
    torch.cuda.empty_cache()
    return out


def _fit_session(spec):
    """``train_fit``'s session: ``AutoDist()``'s default with
    ``fusable_adam(1e-3)`` and the rollback policy, on the loss times the
    batch's ``s`` column."""
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch.ops import fused_kernels as fk

    def loss_fn(p, b):            # a NaN in "s" poisons the step
        return spec.loss_fn(p, b) * b["s"].mean()

    adm._reset_default_autodist_for_testing()
    ad = adm.AutoDist()
    with ad.scope():
        ad.capture(params=lm_params(spec), optimizer=fk.fusable_adam(1e-3),
                   loss_fn=loss_fn, sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": CLIP_NORM,
                             "on_nonfinite": "rollback",
                             "rollback_after": FIT_ROLLBACK_AFTER})
    return ad.create_distributed_session()


def _fit_data(batch, poison=None, steps=None):
    """A generator factory of ``steps`` (``FIT_STEPS_PER_EPOCH``) copies of
    ``batch`` with ``s`` = 1.0; ``poison = (epoch, steps)`` sets ``s`` to
    NaN at those steps of that epoch's first pass only (not in its
    replay)."""
    calls = []
    steps = steps or FIT_STEPS_PER_EPOCH

    def with_s(value):
        return dict(batch, s=np.full((TRAIN_SHAPE["B"],), value,
                                     np.float32))

    def factory():
        calls.append(1)
        bad = poison is not None and len(calls) == poison[0] + 1
        return iter([with_s(float("nan") if bad and i in poison[1] else 1.0)
                     for i in range(steps)])
    return factory


class _RecordingLoader:
    """A ``runtime.DataLoader`` whose yielded batches' token digests are
    kept in order (``fit`` sees the loader itself: ``state`` and
    ``load_state`` pass through)."""

    def __init__(self, loader):
        self.loader, self.seen = loader, []

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.seen.append(hashlib.sha256(
                batch["tokens"].tobytes()).hexdigest()[:16])
            yield batch


def _fit_loader_drill(torch, spec, root: str) -> dict:
    """``fit`` fed by the native ``DataLoader`` on ``train_fit``'s program:
    :data:`FIT_LOADER_EPOCHS` epochs over :data:`FIT_LOADER_ROWS` token
    rows (shuffled, batch 8) uninterrupted; the same preempted after
    :data:`FIT_LOADER_PREEMPT` steps (mid-epoch 1: the checkpoint records
    the loader's position) and resumed by a fresh session and loader.
    The resumed run's first batch is the uninterrupted run's next one and
    its final parameters the uninterrupted run's, bit for bit.  Then the
    loader's batches per second over :data:`LOADER_RATE_ROWS` rows (host
    only: shuffle, gather)."""
    import signal

    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.checkpoint.saver import tree_digest
    from autodist_tpu_torch.fit import Callback
    from autodist_tpu_torch.runtime import DataLoader, native_available

    seq = spec.config["seq_len"]
    tokens = np.random.RandomState(SEED + 11).randint(
        0, spec.config["vocab_size"], (LOADER_RATE_ROWS, seq)
    ).astype(np.int32)

    def loader():
        data = {"tokens": tokens[:FIT_LOADER_ROWS],
                "s": np.ones((FIT_LOADER_ROWS,), np.float32)}
        return _RecordingLoader(DataLoader(data, TRAIN_SHAPE["B"],
                                           shuffle=True, seed=SEED))

    class PreemptAt(Callback):
        def on_step_end(self, step, metrics):
            if step == FIT_LOADER_PREEMPT:
                os.kill(os.getpid(), signal.SIGUSR1)

    ref_loader = loader()
    sess = _fit_session(spec)
    sess.fit(ref_loader, epochs=FIT_LOADER_EPOCHS, on_nonfinite="skip")
    total = sess.step_count
    digest = tree_digest(sess.device_params)
    del sess
    torch.cuda.empty_cache()
    ck = os.path.join(root, "loader")
    sess = _fit_session(spec)
    hist = sess.fit(loader(), epochs=FIT_LOADER_EPOCHS, checkpoint_dir=ck,
                    preemption_signals=("SIGUSR1",), callbacks=[PreemptAt()])
    per_epoch = FIT_LOADER_ROWS // TRAIN_SHAPE["B"]
    state = Saver.read_meta(Saver.latest_checkpoint(ck))["data_state"]
    if not hist.preempted or sess.step_count != FIT_LOADER_PREEMPT or \
            state != {"epoch": FIT_LOADER_PREEMPT // per_epoch,
                      "offset": FIT_LOADER_PREEMPT % per_epoch,
                      "seed": SEED}:
        raise AssertionError(f"loader preemption: step {sess.step_count}, "
                             f"data state {state}")
    del sess
    torch.cuda.empty_cache()
    resumed_loader = loader()
    sess = _fit_session(spec)
    hist = sess.fit(resumed_loader, epochs=FIT_LOADER_EPOCHS,
                    checkpoint_dir=ck, resume=True)
    if resumed_loader.seen[0] != ref_loader.seen[FIT_LOADER_PREEMPT] or \
            sess.step_count != total or \
            hist.steps_run != total - FIT_LOADER_PREEMPT:
        raise AssertionError(f"the resumed run's batches "
                             f"{resumed_loader.seen} against "
                             f"{ref_loader.seen}, step {sess.step_count}")
    if tree_digest(sess.device_params) != digest:
        raise AssertionError("the loader-resumed run's parameters differ")
    del sess
    torch.cuda.empty_cache()
    timed = DataLoader({"tokens": tokens}, TRAIN_SHAPE["B"], shuffle=True,
                       seed=SEED)
    t0 = time.perf_counter()
    batches = sum(1 for _ in timed)
    rate = batches / (time.perf_counter() - t0)
    return {"native_available": native_available(), "steps": total,
            "preempted_at": FIT_LOADER_PREEMPT, "data_state": state,
            "next_batch_equal": True, "params_digest_equal": True,
            "loader_batches_per_s": rate, "loader_rows": LOADER_RATE_ROWS,
            "loader_batch_shape": [TRAIN_SHAPE["B"], seq]}


def _per_step_ms(th, steps: int) -> list:
    return [t / steps * 1e3 for t in th.epoch_times]


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def phase_train_fit(torch, ps_out):
    """``DistributedSession.fit`` at full width on ``train_ps``'s step:
    the uninterrupted run, an exact resume, a rollback, ``raise``, the
    launches per step and the checkpoint's costs."""
    import shutil
    import tempfile

    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.checkpoint.saver import tree_digest
    from autodist_tpu_torch.fit import Callback, TimeHistory
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.numerics import NonFiniteError

    spec = transformer_lm()
    batch = spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED)
    tokens = TRAIN_SHAPE["B"] * spec.config["seq_len"]
    spe, epochs = FIT_STEPS_PER_EPOCH, FIT_EPOCHS
    out = {"layers": spec.config["num_layers"], "steps_per_epoch": spe,
           "epochs": epochs}

    # 1. uninterrupted, the policy overridden to "skip": no checkpoint and
    #    no per-step health read; the counts start at 0 here
    sess = _fit_session(spec)
    th = TimeHistory(tokens)
    _reset_all_counts()
    hist = sess.fit(_fit_data(batch), epochs=epochs, steps_per_epoch=spe,
                    callbacks=[th], on_nonfinite="skip")
    launches = _kernel_counts()
    steps = hist.steps_run
    per_step = {k: v / steps for k, v in launches.items()}
    if per_step != ps_out["launches_per_step"] or steps != spe * epochs:
        raise AssertionError(f"fit launched {launches} in {steps} steps, "
                             f"train_ps {ps_out['launches_per_step']} per "
                             f"step")
    want = [ps_out["losses"][spe * (e + 1) - 1] for e in range(epochs)]
    if hist.history["epoch_loss"] != want:
        raise AssertionError(f"fit's epoch losses {hist.history} are not "
                             f"train_ps's {want} bit for bit")
    losses = hist.history["epoch_loss"]
    digest = tree_digest(sess.device_params)
    out.update(epoch_losses=losses, params_digest=digest,
               launches=launches, launches_per_step=per_step,
               skip_ms_per_step_by_epoch=_per_step_ms(th, spe),
               skip_tokens_per_s_by_epoch=th.items_per_sec,
               train_ps_ms_per_step=ps_out["ms_per_step"])
    del sess
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="train_fit_")
    try:
        # 2. exact resume: epoch 1 with a checkpoint, a new session resumes
        resume_dir = os.path.join(root, "resume")
        sess = _fit_session(spec)
        sess.fit(_fit_data(batch), epochs=1, steps_per_epoch=spe,
                 checkpoint_dir=resume_dir)
        if Saver.good_steps(resume_dir) != [spe]:
            raise AssertionError(f"epoch 1's checkpoint: good steps "
                                 f"{Saver.good_steps(resume_dir)}")
        del sess
        torch.cuda.empty_cache()
        sess = _fit_session(spec)
        th = TimeHistory(tokens)
        hist = sess.fit(_fit_data(batch), epochs=epochs, steps_per_epoch=spe,
                        checkpoint_dir=resume_dir, checkpoint_keep=1,
                        callbacks=[th])
        if hist.steps_run != spe * (epochs - 1) or \
                hist.history["epoch_loss"] != losses[1:]:
            raise AssertionError(f"resume ran {hist.steps_run} steps, "
                                 f"losses {hist.history['epoch_loss']} vs "
                                 f"{losses[1:]}")
        if tree_digest(sess.device_params) != digest:
            raise AssertionError("the resumed run's parameters differ")
        out.update(resumed_steps=hist.steps_run,
                   rollback_ms_per_step_by_epoch=_per_step_ms(th, spe),
                   rollback_tokens_per_s_by_epoch=th.items_per_sec)

        # the checkpoint's costs, on the resumed session's state
        shutil.rmtree(resume_dir)
        cost_dir = os.path.join(root, "cost")
        t0 = time.perf_counter()
        path = Saver(sess).save(cost_dir)
        sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not Saver.verify(path, deep=True):
            raise AssertionError(f"{path} failed the deep verify")
        verify_s = time.perf_counter() - t0
        sizes = {item: _dir_bytes(os.path.join(path, item))
                 for item in ("params", "opt_state", "sync_state")}
        t0 = time.perf_counter()
        if Saver(sess).restore(path) != sess.step_count:
            raise AssertionError("restore returned another step")
        restore_s = time.perf_counter() - t0
        shutil.rmtree(cost_dir)
        saver = Saver(sess, async_save=True)
        t0 = time.perf_counter()
        saver.save(cost_dir)
        async_block_s = time.perf_counter() - t0
        saver.wait()
        async_total_s = time.perf_counter() - t0
        shutil.rmtree(cost_dir)
        out["checkpoint"] = {"sync_save_s": sync_s,
                             "async_save_blocking_s": async_block_s,
                             "async_save_total_s": async_total_s,
                             "deep_verify_s": verify_s,
                             "restore_s": restore_s, "bytes": sizes}
        del sess, saver
        torch.cuda.empty_cache()

        # 3. rollback: epoch 2's first two steps poisoned on their first
        #    pass; fit restores step 3 (verified good) and replays
        rb_dir = os.path.join(root, "rollback")

        class Probe(Callback):
            """Each step's health; right after the restore, the params'
            digest and the restored checkpoint's (before retention)."""

            def __init__(self):
                self.begins, self.health, self.sess = [], [], None
                self.restored = self.anchor = None

            def on_train_begin(self, session):
                self.sess = session

            def on_epoch_begin(self, epoch):
                if epoch in self.begins:
                    self.restored = tree_digest(self.sess.device_params)
                    self.anchor = Saver.read_meta(Saver.last_good_checkpoint(
                        rb_dir))["checksums"]["params"]
                self.begins.append(epoch)

            def on_step_end(self, step, metrics):
                h = metrics["grad_health"]
                self.health.append((step, bool(h.all_finite),
                                    int(h.skipped_steps)))

        probe = Probe()
        sess = _fit_session(spec)
        hist = sess.fit(_fit_data(batch, poison=(1, {0, 1})), epochs=epochs,
                        steps_per_epoch=spe, checkpoint_dir=rb_dir,
                        checkpoint_keep=1, callbacks=[probe])
        want_rb = [{"at_step": spe + 2, "restored_step": spe,
                    "reason": f"{FIT_ROLLBACK_AFTER} consecutive non-finite "
                              f"steps"}]
        bad = [h for h in probe.health if not h[1]]
        if hist.history.get("rollbacks") != want_rb or bad != [
                (spe + 1, False, 1), (spe + 2, False, 2)]:
            raise AssertionError(f"rollback: {hist.history}, bad steps "
                                 f"{bad}")
        if probe.begins != [0, 1, 1, 2] or probe.restored != probe.anchor:
            raise AssertionError(f"after the restore: epochs {probe.begins}"
                                 f", digest {probe.restored} vs step "
                                 f"{spe}'s {probe.anchor}")
        final = tree_digest(sess.device_params)
        if final != digest or sess.step_count != spe * epochs or \
                not all(np.isfinite(hist.history["epoch_loss"])):
            raise AssertionError(f"after the rollback: digest {final}, "
                                 f"step {sess.step_count}, "
                                 f"{hist.history['epoch_loss']}")
        out["rollback"] = {"history": hist.history,
                           "bad_steps": bad,
                           "digest_after_restore": probe.restored,
                           "final_digest_equals_uninterrupted": True}

        # 4. raise: the second step of a poisoned epoch
        try:
            sess.fit(_fit_data(batch, poison=(0, {1})), epochs=1,
                     steps_per_epoch=spe, on_nonfinite="raise")
        except NonFiniteError as e:
            if f"step {spe * epochs + 2}" not in str(e):
                raise AssertionError(f"raised at another step: {e}")
            out["raise"] = str(e)
        else:
            raise AssertionError("on_nonfinite='raise' did not raise")

        # 5. ms per step under "skip" and "rollback" (one health read per
        #    step), in turns, one epoch of FIT_TIMED_STEPS each
        timing = {"skip": [], "rollback": []}
        for policy in ("skip", "rollback", "rollback", "skip"):
            th = TimeHistory(tokens)
            kw = {} if policy == "skip" else dict(
                checkpoint_dir=os.path.join(root, "timing"),
                checkpoint_keep=1, resume=False)
            sess.fit(_fit_data(batch, steps=FIT_TIMED_STEPS), epochs=1,
                     steps_per_epoch=FIT_TIMED_STEPS, callbacks=[th],
                     on_nonfinite=policy, **kw)
            timing[policy].append({
                "ms_per_step": th.epoch_times[0] / FIT_TIMED_STEPS * 1e3,
                "tokens_per_s": th.items_per_sec[0]})
        out["timed"] = dict(timing, steps=FIT_TIMED_STEPS,
                            order="skip, rollback, rollback, skip")
        del sess
        torch.cuda.empty_cache()

        # 6. the native loader feeding fit, cut mid-epoch and resumed
        out["loader"] = _fit_loader_drill(torch, spec, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _telemetry_session(spec, env):
    """``train_ps``'s program (``PSLoadBalancing()``, the facade's
    default, with ``fusable_adam(1e-3)`` and the clip) from ``SEED``'s
    weights, built with the environment ``env`` (a None value removes
    its variable), which the session reads when it is built."""
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import PSLoadBalancing

    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        os.environ.pop(k, None) if v is None else os.environ.update({k: v})
    try:
        return _train_session(spec, lm_params(spec), TRAIN_SHAPE["B"],
                              PSLoadBalancing(), fk.fusable_adam(1e-3),
                              numerics={"clip_norm": CLIP_NORM})
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.update(
                {k: v})


def _check_records(run_dir: str, steps: int, tokens: int) -> list:
    """The StepRecords on disk under ``run_dir``: ``steps`` of them, each
    but the first with the batch's items and tokens (rate x step time)
    and a ``dispatch`` phase."""
    from autodist_tpu_torch.telemetry import load_step_records

    recs = load_step_records(run_dir)
    if [r.step for r in recs] != list(range(steps)):
        raise AssertionError(f"{len(recs)} records on disk under {run_dir}, "
                             f"steps {[r.step for r in recs]}")
    for r in recs[1:]:
        items = r.items_per_s * r.step_time_s
        toks = r.tokens_per_s * r.step_time_s
        if abs(items - TRAIN_SHAPE["B"]) > 1e-6 * TRAIN_SHAPE["B"] \
                or abs(toks - tokens) > 1e-6 * tokens \
                or not r.phases.get("dispatch", 0) > 0:
            raise AssertionError(f"record {r.step}: items {items}, tokens "
                                 f"{toks}, phases {r.phases}")
    return recs


def _trace_window(torch, spec, tmp: str, want: dict) -> dict:
    """A session under ``AUTODIST_TRACE_STEPS``: the window's Chrome trace,
    ``LegProfiler.parse_trace``'s samples (each device range once), K4's
    and K5's kernel events inside their ``autodist_sync/`` device ranges,
    and the ``autodist_leg_exposed_ms`` gauge per kind."""
    from autodist_tpu_torch.telemetry import DEFAULT_REGISTRY, LegProfiler
    from autodist_tpu_torch.telemetry.profiler import (DEVICE_RANGE,
                                                       HOST_RANGE,
                                                       SYNC_SCOPE_PREFIX)
    from autodist_tpu_torch.utils import tracing

    default_dir = tracing.DEFAULT_TRACE_DIR
    tracing.DEFAULT_TRACE_DIR = os.path.join(tmp, "traces")
    try:
        sess, batch = _telemetry_session(spec, {
            "AUTODIST_TRACE_STEPS": str(TELEMETRY_TRACE_STEPS)})
    finally:
        tracing.DEFAULT_TRACE_DIR = default_dir
    _reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TELEMETRY_TRACE_STEPS):
        sess.run(batch)
    window_s = time.perf_counter() - t0           # the export included
    launches = _kernel_counts()
    if launches != {k: v * TELEMETRY_TRACE_STEPS for k, v in want.items()}:
        raise AssertionError(f"the traced steps launched {launches}")
    (path,) = sess.tracer.paths
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    samples = LegProfiler().parse_trace(os.path.dirname(path))
    ranges = {cat: [e for e in events if e.get("cat") == cat
                    and str(e.get("name", "")).startswith(SYNC_SCOPE_PREFIX)]
              for cat in (HOST_RANGE, DEVICE_RANGE)}
    if len(samples) != len(ranges[DEVICE_RANGE]) or not samples:
        raise AssertionError(f"{len(samples)} samples from "
                             f"{len(ranges[DEVICE_RANGE])} device ranges")
    kinds: dict = {}
    for smp in samples:
        if not smp.measured_s > 0:
            raise AssertionError(f"sample {smp.leg_id}: {smp.measured_s}")
        row = kinds.setdefault(smp.kind, {"samples": 0, "device_ms": 0.0})
        row["samples"] += 1
        row["device_ms"] += smp.measured_s * 1e3
    for kind in ("fused_detect", "psum_guard", "fused_update"):
        if kind not in kinds:
            raise AssertionError(f"no {kind} sample: {sorted(kinds)}")
    contained = {}
    for symbol, leg in TELEMETRY_KERNEL_RANGES.items():
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in ranges[DEVICE_RANGE]
                 if e["name"].startswith(SYNC_SCOPE_PREFIX + leg)]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and symbol in e.get("name", "")]
        outside = [k["name"] for k in kernels
                   if not any(a - 1e-3 <= k["ts"] and
                              k["ts"] + k["dur"] <= b + 1e-3
                              for a, b in spans)]
        if not kernels or outside:
            raise AssertionError(f"{symbol}: {len(kernels)} kernel events, "
                                 f"{len(outside)} outside the "
                                 f"{SYNC_SCOPE_PREFIX}{leg} ranges")
        contained[symbol] = {"kernel_events": len(kernels),
                             "ranges": len(spans)}
    host = {}
    for e in ranges[HOST_RANGE]:
        name = e["name"][len(SYNC_SCOPE_PREFIX):].split("/")[0]
        host[name] = host.get(name, 0) + 1
    gauges = {m.labels["kind"]: m.value for m in DEFAULT_REGISTRY.metrics()
              if m.name == "autodist_leg_exposed_ms"}
    out = {"trace_file": os.path.relpath(path, tmp),
           "spans_per_step": len(ranges[HOST_RANGE])
           / TELEMETRY_TRACE_STEPS,
           "trace_bytes": os.path.getsize(path),
           "window_steps": TELEMETRY_TRACE_STEPS, "window_s": window_s,
           "host_ranges_by_name": host,
           "device_ranges": len(ranges[DEVICE_RANGE]),
           "samples_by_kind": kinds, "kernels_in_ranges": contained,
           "leg_exposed_ms": gauges, "launches": launches}
    del sess
    torch.cuda.empty_cache()
    return out


def _span_cost_us(n: int = 200_000) -> float:
    """Host microseconds of one ``sync_span`` entered and left with no
    profiler active (what each of a step's spans costs outside a trace
    window): the median of 5 loops of ``n``."""
    from autodist_tpu_torch.telemetry import sync_span

    loops = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with sync_span("bucket_reduce/x"):
                pass
        loops.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(loops)


def _launched(label: str, count: int) -> None:
    """A kernel of a phase's main path must have launched."""
    if not count:
        raise AssertionError(f"{label}: no launch")


def _serve_metrics(torch, spec, tmp: str, device: str = "cuda") -> dict:
    """``serve(spec, params, paged=True)`` on the card (K9) answers
    ``TELEMETRY_REQUESTS`` requests, one after another; ``GET /metrics``
    must count them in the latency and TTFT histograms, and the span file
    must hold each request's spans under its trace id."""
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.serving import serve
    from autodist_tpu_torch.telemetry import configure_spans, load_spans

    span_dir = os.path.join(tmp, "spans")
    configure_spans(span_dir)
    params = lm_params(spec, device=device)
    vocab = spec.config["vocab_size"]
    rng = np.random.RandomState(SEED + 7)
    fk.paged_attention.calls = 0
    srv = serve(spec, params, paged=True, device=device, host="127.0.0.1",
                port=0, **SERVE_GEOM)
    url = "http://%s:%d" % srv.address
    try:
        t0 = time.perf_counter()
        for i in range(TELEMETRY_REQUESTS):
            body = {"prompt_tokens": rng.randint(0, vocab, 16 + 8 * i)
                    .tolist(), "max_new_tokens": TELEMETRY_NEW_TOKENS}
            req = urllib.request.Request(
                url + "/v1/completions", json.dumps(body).encode(),
                {"Content-Type": "application/json",
                 "X-Autodist-Trace": f"telemetry-{i}"})
            answer = json.loads(urllib.request.urlopen(req, timeout=600)
                                .read())
            if len(answer["new_tokens"]) != TELEMETRY_NEW_TOKENS:
                raise AssertionError(f"request {i}: {answer}")
        requests_s = time.perf_counter() - t0
        text = urllib.request.urlopen(url + "/metrics", timeout=60).read() \
            .decode()
    finally:
        srv.close()
    configure_spans(None)
    lines = dict(line.rsplit(" ", 1) for line in text.splitlines()
                 if line and not line.startswith("#"))
    counts = {k: float(lines[k]) for k in (
        "autodist_serving_request_latency_seconds_count",
        "autodist_serving_ttft_seconds_count",
        "autodist_serving_requests_served_total")}
    if set(counts.values()) != {float(TELEMETRY_REQUESTS)}:
        raise AssertionError(f"/metrics counts {counts}")
    by_trace: dict = {}
    for span in load_spans(span_dir):
        by_trace.setdefault(span["trace_id"], set()).add(span["name"])
    want = {f"telemetry-{i}": {"request", "queue_wait", "prefill", "decode"}
            for i in range(TELEMETRY_REQUESTS)}
    if by_trace != want:
        raise AssertionError(f"request spans {by_trace}")
    _launched("the paged server's K9", fk.paged_attention.calls)
    del params
    torch.cuda.empty_cache()
    return {"requests": TELEMETRY_REQUESTS, "metrics_counts": counts,
            "ttft_mean_s": float(lines[
                "autodist_serving_ttft_seconds_sum"]) / TELEMETRY_REQUESTS,
            "latency_mean_s": float(lines[
                "autodist_serving_request_latency_seconds_sum"])
            / TELEMETRY_REQUESTS,
            "spans_by_trace": {k: sorted(v) for k, v in by_trace.items()},
            "paged_attention_launches": fk.paged_attention.calls,
            "requests_s": requests_s}


def phase_telemetry(torch, ps_out):
    """The telemetry slice on ``train_ps``'s step at full width:
    telemetry on against off in turns (bit-identical losses, K1–K5 a step
    as ``train_ps``, 13 records on disk with the batch's items and
    tokens, ms per step of each and their difference against the runs'
    spread); a trace window (its device ranges parsed once each, K4 and
    K5 inside their ranges, the exposed ms per leg kind); ``fit`` with
    goodput, a checkpoint and the journal; the CLI in a child process;
    the paged server's ``/metrics`` and request spans."""
    import tempfile

    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.telemetry import configure_events, \
        load_run_events

    t_phase = time.perf_counter()
    spec = transformer_lm()
    layers = spec.config["num_layers"]
    tokens = TRAIN_SHAPE["B"] * spec.config["seq_len"]
    want = ps_out["launches_per_step"]
    steps = WARMUP_STEPS + TIMED_STEPS
    tmp = tempfile.mkdtemp(prefix="telemetry_")
    out = {"layers": layers, "steps_per_run": steps,
           "order": list(TELEMETRY_ORDER)}
    try:
        # 1. telemetry on against off, in turns, outside any trace window
        runs = []
        for i, mode in enumerate(TELEMETRY_ORDER):
            run_dir = os.path.join(tmp, f"run{i}")
            env = {"AUTODIST_TELEMETRY_DIR": run_dir,
                   "AUTODIST_TELEMETRY": None} if mode == "on" else \
                {"AUTODIST_TELEMETRY": "0", "AUTODIST_TELEMETRY_DIR": None}
            _fresh_peak(torch)
            sess, batch = _telemetry_session(spec, env)
            if (sess.telemetry is None) != (mode == "off"):
                raise AssertionError(f"run {i} ({mode}): recorder "
                                     f"{sess.telemetry}")
            losses, _, step_s, launches, per_step = _bucketed_steps(
                torch, sess, batch, layers, WARMUP_STEPS, TIMED_STEPS)
            if per_step != want or losses != ps_out["losses"]:
                raise AssertionError(f"run {i} ({mode}): {per_step} a step, "
                                     f"losses {losses} vs train_ps "
                                     f"{ps_out['losses']}")
            row = {"mode": mode, "ms_per_step":
                   statistics.median(step_s) * 1e3,
                   "ms_per_step_min": min(step_s) * 1e3,
                   "ms_per_step_max": max(step_s) * 1e3,
                   "step_ms": [t * 1e3 for t in step_s]}
            if mode == "on":
                sess.telemetry.flush()
                recs = _check_records(sess.telemetry.directory, steps,
                                      tokens)
                row["records"] = len(recs)
                row["run_dir"] = sess.telemetry.directory
            runs.append(row)
            del sess
        by_mode = {m: [r for r in runs if r["mode"] == m]
                   for m in ("on", "off")}
        med = {m: statistics.median([t for r in rs for t in r["step_ms"]])
               for m, rs in by_mode.items()}
        spread = {m: max(r["ms_per_step"] for r in rs)
                  - min(r["ms_per_step"] for r in rs)
                  for m, rs in by_mode.items()}
        out.update(runs=[{k: v for k, v in r.items() if k != "step_ms"}
                         for r in runs],
                   on_ms_per_step=med["on"], off_ms_per_step=med["off"],
                   on_minus_off_ms=med["on"] - med["off"],
                   spread_ms=spread, losses_bit_identical=True,
                   launches_per_step=want)

        out["span_us_no_profiler"] = _span_cost_us()

        # 2. the CLI on the first "on" run's directory, in a child
        run_dir = runs[0]["run_dir"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__))]
            + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
               if p]))
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "autodist_tpu_torch.telemetry", run_dir,
             "--json"], env=env, capture_output=True, text=True,
            timeout=120, check=True)
        summary = json.loads(cli.stdout)
        times = [r.step_time_s for r in _check_records(run_dir, steps,
                                                       tokens)
                 if r.step_time_s]
        p50 = round(float(np.percentile(times, 50)) * 1e3, 3)
        if summary["steps"] != steps or \
                summary["step_time"]["p50_ms"] != p50:
            raise AssertionError(f"the CLI: {summary.get('steps')} steps, "
                                 f"p50 {summary.get('step_time')} vs {p50}")
        trace = subprocess.run(
            [sys.executable, "-m", "autodist_tpu_torch.telemetry", run_dir,
             "--export-trace"], env=env, capture_output=True, text=True,
            timeout=120, check=True)
        with open(os.path.join(run_dir, "trace.json")) as f:
            exported = json.load(f)["traceEvents"]
        if sum(e["name"].startswith("step ") for e in exported) \
                != steps - 1:
            raise AssertionError(f"exported trace: {trace.stdout}")
        out["cli"] = {"steps": summary["steps"],
                      "p50_ms": summary["step_time"]["p50_ms"],
                      "records_p50_ms": p50, "seconds":
                      time.perf_counter() - t0,
                      "exported_events": len(exported)}

        # 3. the trace window
        _fresh_peak(torch)
        out["trace"] = _trace_window(torch, spec, tmp, want)

        # 4. fit with goodput, a checkpoint and the journal
        _fresh_peak(torch)
        fit_dir = os.path.join(tmp, "fit")
        configure_events(fit_dir)
        saved = os.environ.get("AUTODIST_TELEMETRY_DIR")
        os.environ["AUTODIST_TELEMETRY_DIR"] = fit_dir
        try:
            sess = _fit_session(spec)
        finally:
            os.environ.pop("AUTODIST_TELEMETRY_DIR")
            if saved is not None:
                os.environ["AUTODIST_TELEMETRY_DIR"] = saved
        batch = spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED)
        epochs, spe = TELEMETRY_FIT
        _reset_all_counts()
        t0 = time.perf_counter()
        hist = sess.fit(_fit_data(batch, steps=spe), epochs=epochs,
                        steps_per_epoch=spe, log_every=1,
                        checkpoint_dir=os.path.join(tmp, "ckpt"),
                        checkpoint_every=epochs, checkpoint_keep=1)
        fit_s = time.perf_counter() - t0
        fit_launches = _kernel_counts()
        if fit_launches != {k: v * epochs * spe for k, v in want.items()}:
            raise AssertionError(f"fit launched {fit_launches}")
        gp = hist.goodput
        if not 0.0 < gp["goodput_ratio"] <= 1.0:
            raise AssertionError(f"goodput {gp}")
        recs = sess.telemetry.records
        # the prefetcher pulls batches ahead, so a pull's data_load lands
        # in the record of the step that pulled it (as in the JAX
        # package); each loss read's wait lands in the next record
        pulls = sum("data_load" in r.phases for r in recs)
        if len(recs) != epochs * spe or not epochs <= pulls <= len(recs) \
                or not all(r.loss is not None and r.all_finite is True
                           and r.global_norm > 0
                           and r.loss_scale is not None
                           and r.skipped_steps == 0 for r in recs) \
                or not all("blocking_fetch" in r.phases for r in recs[1:]):
            raise AssertionError(f"fit's records {recs}")
        kinds = [e["kind"] for e in load_run_events(fit_dir)]
        for kind in ("goodput/attempt", "checkpoint/save",
                     "checkpoint/verify"):
            if kind not in kinds:
                raise AssertionError(f"no {kind} in the journal: {kinds}")
        configure_events(None)
        out["fit"] = {"epochs": epochs, "steps_per_epoch": spe,
                      "goodput": gp, "seconds": fit_s,
                      "journal": sorted(set(kinds)),
                      "records_with_data_load": pulls,
                      "phases_mean_ms": {
                          name: statistics.mean(r.phases.get(name, 0.0)
                                                for r in recs) * 1e3
                          for name in ("data_load", "dispatch",
                                       "blocking_fetch")},
                      "launches": fit_launches}
        del sess
        torch.cuda.empty_cache()

        # 5. the server's /metrics and request spans (K9)
        _fresh_peak(torch)
        out["serve"] = _serve_metrics(torch, spec, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def _auto_info(torch, chips: int) -> dict:
    """A spec of ``chips`` H100s: the analyzer's memory budget is this
    card's memory (``hbm_gb``)."""
    return {"nodes": [{"address": "localhost", "chips": chips}],
            "hbm_gb": torch.cuda.get_device_properties(0).total_memory
            / (1 << 30)}


def _ir_predicted_launches(ir, layers: int) -> dict:
    """K1–K10 a step as the schedule IR predicts them: K1–K3 once per
    layer, K4 twice per ``fused_detect`` leg (the packed vector's
    finiteness and the reduced value's squared norm; once for a
    pipelined bucket, whose reduced value is both), K5 once per
    ``fused_update`` leg."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    pipe = ir.pipelined_keys()
    k4 = sum(1 if leg.bucket in pipe else 2 for leg in ir.legs
             if leg.kind == sir.LEG_FUSED_DETECT)
    k5 = sum(1 for leg in ir.legs if leg.kind == sir.LEG_FUSED_UPDATE)
    return dict(dict.fromkeys(_kernel_counts(), 0), flash_fwd=layers,
                flash_dq=layers, flash_dkv=layers, detect_stats=k4,
                adam_update=k5)


def _auto_choose(torch, gi, chips: int, search) -> tuple:
    """``AutoStrategy(search=...)`` built on a ``chips``-card spec: the
    Strategy, and its choice, build seconds, the fingerprint and
    leg-priced cost of its schedule IR (and for the beam: evaluations,
    rounds, pruned candidates and their rule ids)."""
    from autodist_tpu_torch.analysis.search import facts_for_candidate
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AutoStrategy
    from autodist_tpu_torch.strategy.cost_model import estimate_ir_cost
    from autodist_tpu_torch.strategy.search import resolve_axes

    rs = ResourceSpec(resource_info=_auto_info(torch, chips))
    builder = AutoStrategy(search=search)
    t0 = time.perf_counter()
    strategy = builder.build(gi, rs)
    build_s = time.perf_counter() - t0
    axes = resolve_axes(gi, rs)
    facts, _, guard, prune = facts_for_candidate(strategy, gi, axes,
                                                 resource_spec=rs)
    if prune is not None:
        raise AssertionError(f"auto: the {search} choice is illegal: {prune}")
    ir = sir.ir_from_facts(facts, axes=axes, accum_steps=gi.accum_steps,
                           guard=guard)
    out = {"chips": chips, "search": search,
           "choice": builder.last_choice or "tiers", "build_s": build_s,
           "fingerprint": ir.fingerprint(),
           "ir_cost_ms": estimate_ir_cost(ir).time_s * 1e3}
    result = builder.last_search
    if result is not None:
        out.update(evaluations=result.n_evals, rounds=result.rounds,
                   search_wall_s=result.wall_time_s,
                   pruned=len(result.pruned),
                   pruned_rules=sorted({p.pruned_by.split(":")[0]
                                        for p in result.pruned}),
                   best_cost_ms=result.best.cost_s * 1e3)
    return strategy, out


def _auto_memory(torch, sess, gi, rs, batch) -> dict:
    """The memory pass's per-device estimate for the session's compiled
    strategy (its terms and the schedule's liveness watermark, the data
    of its ``memory/watermark`` finding) beside the card's measured
    peak."""
    from autodist_tpu_torch.analysis import analyze

    report = analyze(sess._step.compiled_strategy, gi, resource_spec=rs,
                     batch=batch, passes=("legality", "memory"))
    found = report.by_rule("memory/watermark")
    if len(found) != 1:
        raise AssertionError(f"auto: {len(found)} memory/watermark findings")
    est = dict(found[0].data)
    peak = torch.cuda.max_memory_allocated()
    return {**est, "max_memory_allocated": peak,
            "measured_over_estimate": peak / est["watermark_bytes"]}


class _Unsynced:
    """A builder whose Strategy leaves the first trainable variable
    without a sync rule: ``sync/unsynced-trainable``, an ERROR."""

    def build(self, graph_item, resource_spec):
        from autodist_tpu_torch.strategy import AllReduce

        st = AllReduce().build(graph_item, resource_spec)
        st.node_config = st.node_config[1:]
        return st


def phase_auto(torch, ps_out):
    """P8's main path at full width: ``AutoStrategy`` in each search mode
    on the one-card spec and on spec-only 4- and 8-card meshes; the
    beam's choice trained through ``create_distributed_session(
    validate=True)`` (K1–K3 12 a step, K4 and K5 as the schedule IR
    predicts, losses against ``train_ps``'s, the cost model's prediction
    and the memory pass's estimate against the card); ``fit(validate=
    True)`` with the fingerprint in every record, the checkpoint meta, the
    session and a second build; an illegal plan refused before any
    launch; the launch latency of one collective."""
    import shutil
    import tempfile

    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch.analysis import StrategyValidationError, analyze
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.graph_item import GraphItem
    from autodist_tpu_torch.kernel.graph_transformer import (
        lowered_schedule_ir)
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AutoStrategy, StrategyCompiler
    from autodist_tpu_torch.strategy import cost_model as cm
    from autodist_tpu_torch.telemetry.calibration import model_drift_reason

    t_phase = time.perf_counter()
    spec = transformer_lm()
    layers = spec.config["num_layers"]
    _fresh_peak(torch)
    params = lm_params(spec)
    numerics = {"clip_norm": CLIP_NORM}
    gi = GraphItem(params, optimizer=fk.fusable_adam(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics=numerics)
    # 1-2. the choice on the one-card spec, then on spec-only meshes
    choices = [_auto_choose(torch, gi, chips, search)[1]
               for chips in (1,) + AUTO_SPEC_CHIPS
               for _, search in AUTO_MODES]

    # 3. the beam's choice trained on the card, validated first
    rs = ResourceSpec(resource_info=_auto_info(torch, 1))
    builder = AutoStrategy(search="beam")
    adm._reset_default_autodist_for_testing()
    ad = adm.AutoDist(resource_spec=rs, strategy_builder=builder)
    with ad.scope():
        ad.capture(params=params, optimizer=fk.fusable_adam(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics=numerics)
    t0 = time.perf_counter()
    sess = ad.create_distributed_session(validate=True)
    session_s = time.perf_counter() - t0
    batch = spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED)
    compiled = sess._step.compiled_strategy
    t0 = time.perf_counter()
    report = analyze(compiled, ad.graph_item, resource_spec=rs)
    analyzer_s = time.perf_counter() - t0
    ir = sess.schedule_ir
    t0 = time.perf_counter()
    violations = sir.verify(ir)
    verifier_s = time.perf_counter() - t0
    if report.has_errors() or sir.errors(violations):
        raise AssertionError(f"auto: the beam's plan does not verify: "
                             f"{report.errors} {violations}")
    want = _ir_predicted_launches(ir, layers)
    losses, norms, step_s, launches = _checked_steps(
        torch, "auto", sess, batch, want, AUTO_WARMUP, AUTO_TIMED,
        guarded=True)
    _check_falling(losses)
    same_plan = sess.schedule_fingerprint == ps_out["schedule_fingerprint"]
    if same_plan and losses != ps_out["losses"]:
        raise AssertionError(f"auto: train_ps's plan, but losses {losses} "
                             f"are not train_ps's {ps_out['losses']}")
    measured = statistics.median(step_s)
    record = sess.telemetry.records[-1]
    predicted = record.predicted_step_time_s
    if predicted is None:
        raise AssertionError("auto: the step records carry no prediction")
    ir_predicted = cm.estimate_ir_cost(ir).time_s
    memory_out = _auto_memory(torch, sess, ad.graph_item, rs, batch)
    trained = {
        "choice": builder.last_choice, "layers": layers,
        "batch": TRAIN_SHAPE["B"],
        "schedule_fingerprint": sess.schedule_fingerprint,
        "train_ps_fingerprint": ps_out["schedule_fingerprint"],
        "same_plan_as_train_ps": same_plan,
        "buckets": len(sess._step.buckets),
        "zero1_buckets": len(sess.zero1_buckets),
        "fused_kernels": list(sess._step.fused_kernels),
        "ir_legs": len(ir.legs), "ir_buckets": len(ir.buckets),
        "session_build_s": session_s, "analyzer_s": analyzer_s,
        "verifier_s": verifier_s, "losses": losses, "global_norms": norms,
        **_step_rates(torch, spec, step_s),
        "train_ps_ms_per_step": ps_out["ms_per_step"],
        "train_ps_ms_per_step_range": [ps_out["ms_per_step_min"],
                                       ps_out["ms_per_step_max"]],
        "predicted_step_time_s": predicted,
        "measured_step_time_s": measured,
        "drift_ratio": measured / predicted if predicted else None,
        "drift_reason": model_drift_reason(predicted, measured),
        "ir_predicted_step_time_s": ir_predicted,
        "ir_drift_ratio": measured / ir_predicted if ir_predicted else None,
        "memory": memory_out, "launches": launches,
        "launches_per_step": want}

    # 4. fit(validate=True): one fingerprint everywhere
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_auto_")
    try:
        first = len(sess.telemetry.records)
        sess.fit(batch, epochs=1, steps_per_epoch=AUTO_FIT_STEPS,
                 validate=True, checkpoint_dir=ckpt)
        fit_fps = {r.schedule_fingerprint
                   for r in sess.telemetry.records[first:]}
        meta_fp = Saver.read_meta(Saver.latest_checkpoint(ckpt)).get(
            "schedule_fingerprint")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    again = AutoStrategy(search="beam").build(ad.graph_item, rs)
    second_fp = lowered_schedule_ir(ad.graph_item, StrategyCompiler(
        sess.mesh, rs).compile(again, ad.graph_item))[0].fingerprint()
    fps = {"records": sorted(fit_fps | {r.schedule_fingerprint for r in
                                        sess.telemetry.records}),
           "checkpoint_meta": meta_fp,
           "session": sess.schedule_fingerprint, "second_build": second_fp}
    if fps["records"] != [sess.schedule_fingerprint] or len(
            {meta_fp, sess.schedule_fingerprint, second_fp}) != 1:
        raise AssertionError(f"auto: schedule fingerprints differ: {fps}")
    del sess, ad
    torch.cuda.empty_cache()

    # 5. an illegal plan is refused before any launch
    adm._reset_default_autodist_for_testing()
    ad = adm.AutoDist(resource_spec=rs, strategy_builder=_Unsynced())
    with ad.scope():
        ad.capture(params=params, optimizer=fk.fusable_adam(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics=numerics)
    before = _kernel_counts()
    try:
        ad.create_distributed_session(validate=True)
    except StrategyValidationError as err:
        refused = sorted({d.rule for d in err.report.errors})
    else:
        raise AssertionError("auto: the illegal plan was not refused")
    if _kernel_counts() != before:
        raise AssertionError("auto: a kernel launched before the refusal")
    adm._reset_default_autodist_for_testing()
    del ad, params, gi
    torch.cuda.empty_cache()
    alpha = collective_alpha(torch)
    # the cost model's constant beside the host reading, not gated: a
    # host clock over back-to-back calls reads the host's speed too
    ratio = alpha["host_s_per_call"] / cm.COLLECTIVE_ALPHA
    gated = alpha["per_launch"] / ALPHA_PER_LAUNCH
    if not 1 / ALPHA_FACTOR <= gated <= ALPHA_FACTOR:
        raise AssertionError(
            f"auto: one collective costs {alpha['per_launch']:.2f} kernel "
            f"launches on this card ({alpha['host_s_per_call']:.3e} s over "
            f"{alpha['launch_s_per_call']:.3e} s), {gated:.2f}x the "
            f"{ALPHA_PER_LAUNCH} of earlier runs")
    return {"choices": choices, "trained": trained,
            "fingerprints": fps, "refused_rules": refused,
            "collective_alpha": {**alpha,
                                 "cost_model_alpha_s": cm.COLLECTIVE_ALPHA,
                                 "ratio": ratio,
                                 "per_launch_constant": ALPHA_PER_LAUNCH,
                                 "gated_ratio": gated},
            "wall_s": time.perf_counter() - t_phase}


def _auto_ring_train(torch):
    """The ``auto_beam`` configuration on this rank: ``AutoStrategy(
    search="beam")`` on a 4-card spec over the 4 ranks, validated, 1 + 2
    steps, K1–K5 each step as the schedule IR predicts.  Only rank 0
    searches; the others take its plan.  Rank-identical parameters and
    schedule fingerprints are checked by the caller."""
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import AutoStrategy

    spec = transformer_lm()
    _fresh_peak(torch)
    builder = AutoStrategy(search="beam")
    t0 = time.perf_counter()
    sess, batch = _train_session(spec, lm_params(spec), TRAIN_SHAPE["B"],
                                 builder, fk.fusable_adam(1e-3),
                                 numerics={"clip_norm": CLIP_NORM},
                                 resource_info=_auto_info(torch, RING_RANKS),
                                 validate=True)
    build_s = time.perf_counter() - t0
    if sess.data_axis_size != RING_RANKS:
        raise AssertionError(f"auto_beam: data axis {sess.data_axis_size}")
    searched = builder.last_search is not None
    if searched != (torch.distributed.get_rank() == 0):
        raise AssertionError(f"auto_beam: rank "
                             f"{torch.distributed.get_rank()} searched: "
                             f"{searched}")
    want = _ir_predicted_launches(sess.schedule_ir,
                                  spec.config["num_layers"])
    losses, _, step_s, launches = _checked_steps(
        torch, AUTO_RING_CONFIG, sess, batch, want, RING_WARMUP, RING_TIMED,
        guarded=True)
    return sess, {
        "choice": builder.last_choice if searched else None,
        "search_evaluations": builder.last_search.n_evals if searched
        else None,
        "build_s": build_s,
        "schedule_fingerprint": sess.schedule_fingerprint,
        "losses": losses, "ms_per_step": statistics.median(step_s) * 1e3,
        "launches": launches, "launches_per_step": want,
        **_params_digests(sess)}


def _seq_train(torch, name):
    """The ``seq_ring`` / ``seq_ulysses`` configuration on this rank:
    ``transformer_lm()`` at full width on a ``{"seq": 4}`` mesh over the 4
    ranks (this rank's 256 positions of phase 5's 8 x 1024 batch), ring or
    Ulysses attention with the flash kernels inside, ``AllReduce()`` +
    ``adamw(1e-3)``, 1 + 1 steps, each launching K1, K2 and K3
    :data:`SEQ_LAUNCHES` times.  Rank-identical parameters are checked
    by the caller, the losses against the one-card run by the main
    process."""
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.mesh import build_mesh
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.parallel import (make_ring_attention,
                                             make_ulysses_attention)
    from autodist_tpu_torch.strategy import AllReduce

    _fresh_peak(torch)
    at_entry = torch.cuda.memory_allocated()
    axes = {"seq": RING_RANKS}
    mesh = build_mesh(axes)
    make = make_ring_attention if name == "seq_ring" \
        else make_ulysses_attention
    spec = transformer_lm(attn_fn=make(mesh, inner="flash"))
    adm._reset_default_autodist_for_testing()
    ad = adm.AutoDist(strategy_builder=AllReduce(), mesh_axes=axes)
    with ad.scope():
        ad.capture(params=lm_params(spec), optimizer=optim.adamw(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session(mesh=mesh)
    if (sess.mesh.seq_size, sess.data_axis_size) != (RING_RANKS, 1):
        raise AssertionError(f"{name}: mesh {sess.mesh.shape}")
    batch = spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED)
    n = SEQ_LAUNCHES[name]
    want = dict(dict.fromkeys(_kernel_counts(), 0), flash_fwd=n,
                flash_dq=n, flash_dkv=n)
    losses, _, step_s, launches = _checked_steps(
        torch, name, sess, batch, want, SEQ_WARMUP, SEQ_TIMED,
        guarded=False)
    return sess, {
        "mesh": dict(sess.mesh.shape), "positions_per_rank":
        spec.config["seq_len"] // RING_RANKS, "losses": losses,
        "ms_per_step": statistics.median(step_s) * 1e3,
        "ms_per_step_label": "4 ranks time-sharing one card over gloo "
                             "(host-staged K/V and gradients)",
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_entry": at_entry,
        "peak_over_entry": torch.cuda.max_memory_allocated() - at_entry,
        "launches": launches, "launches_per_step": want,
        **_params_digests(sess)}


def _long_context_twin(torch):
    """``examples_torch/long_context.py`` on this rank through its
    ``main`` (:data:`LONG_CONTEXT_ARGS`, its own other defaults; output to
    stderr): K1–K3 at D = 32, :data:`LONG_CONTEXT_LAUNCHES` each."""
    import contextlib

    from autodist_tpu_torch import autodist as adm

    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    _fresh_peak(torch)
    adm._reset_default_autodist_for_testing()
    _reset_all_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rate = importlib.import_module("examples_torch.long_context").main(
            list(LONG_CONTEXT_ARGS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _kernel_counts()
    want = dict(dict.fromkeys(launches, 0),
                **dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"),
                                LONG_CONTEXT_LAUNCHES))
    if launches != want:
        raise AssertionError(f"long_context launched {launches}, expected "
                             f"{want}")
    return {"args": list(LONG_CONTEXT_ARGS), "seconds": seconds,
            "tokens_per_s": rate, "launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _tp_session(spec, axes=None, mesh=None):
    """``PartitionedPS()`` with ``fusable_adam(1e-3)`` and the clip on
    ``spec`` through the facade (on ``axes``; one card without): the
    session and the fixed batch of 8 rows."""
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import PartitionedPS

    adm._reset_default_autodist_for_testing()
    ad = adm.AutoDist(strategy_builder=PartitionedPS(), mesh_axes=axes)
    with ad.scope():
        ad.capture(params=lm_params(spec), optimizer=fk.fusable_adam(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": CLIP_NORM})
    return (ad.create_distributed_session(mesh=mesh),
            spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED))


def phase_tp_reference(torch):
    """The one-card run the model axis's ring configurations are held to:
    ``PartitionedPS()`` + ``fusable_adam(1e-3)`` + the clip at full width
    and :data:`TP_LAYERS` layers, the same weights and batch, 1 + 1
    steps, K1–K5 as its schedule IR predicts."""
    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    spec = transformer_lm(num_layers=TP_LAYERS)
    _fresh_peak(torch)
    sess, batch = _tp_session(spec)
    want = _ir_predicted_launches(sess.schedule_ir,
                                  spec.config["num_layers"])
    losses, norms, step_s, launches = _checked_steps(
        torch, "tp_reference", sess, batch, want, TP_WARMUP, TP_TIMED,
        guarded=True)
    del sess
    torch.cuda.empty_cache()
    return {"builder": "PartitionedPS", "losses": losses,
            "global_norms": norms,
            "ms_per_step": statistics.median(step_s) * 1e3,
            "launches": launches, "launches_per_step": want}


def _shard_bytes(torch, sess) -> dict:
    """The bytes this rank holds of its sharded parameters (over
    ``model``, ``expert`` or ``pipe``: ``shard_cuts``) and of their Adam
    moments, beside the plan's count (each kept sharding's logical bytes
    over the product of its axes' sizes; two moments each); raises unless
    they agree."""
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.kernel.graph_transformer import map_var_leaves

    step = sess._step
    cuts = step.shard_cuts
    infos = {v.name: v for v in sess._gi.info.variables}
    shape = sess.mesh.shape
    plan = sum(infos[n].byte_size // math.prod(shape.get(a, 1)
                                               for a in p.param_spec if a)
               for n, p in step.compiled_strategy.var_plans.items()
               if p.model_sharded)
    logical = sum(infos[n].byte_size for n in cuts)
    per_rank = sum(infos[n].byte_size // math.prod(k for _, k, _ in c)
                   for n, c in cuts.items())
    held = sum(x.numel() * x.element_size()
               for n, x in flatten(sess.device_params) if n in cuts)
    moments = []
    tree = sess.opt_state["vars"] if sess.zero1_buckets else sess.opt_state
    map_var_leaves(tree, cuts, lambda x, n: moments.append(
        x.numel() * x.element_size()))
    out = {"sharded_vars": len(cuts),
           "logical_param_bytes": logical,
           "plan_param_bytes_per_rank": plan,
           "param_bytes_held": held,
           "plan_moment_bytes_per_rank": 2 * plan,
           "moment_bytes_held": sum(moments)}
    if not (cuts and held == plan == per_rank
            and sum(moments) == 2 * plan):
        raise AssertionError(f"sharded variables: {out}")
    return out


def _tp_train(torch, name):
    """The ``tp_ps`` / ``tp_seq`` configuration on this rank (see the
    module docstring): the session and its numbers; rank-identical
    parameters are checked by the caller, the losses against
    ``tp_reference`` by the main process."""
    from autodist_tpu_torch.mesh import build_mesh
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.parallel import make_ring_attention

    _fresh_peak(torch)
    at_entry = torch.cuda.memory_allocated()
    axes = TP_AXES[name]
    mesh = build_mesh(axes)
    attn = {"attn_fn": make_ring_attention(mesh, inner="flash")} \
        if "seq" in axes else {}
    spec = transformer_lm(num_layers=TP_LAYERS, **attn)
    sess, batch = _tp_session(spec, axes, mesh)
    if {k: v for k, v in sess.mesh.shape.items() if v > 1} != axes:
        raise AssertionError(f"{name}: mesh {sess.mesh.shape}")
    held = _shard_bytes(torch, sess)
    want = _ir_predicted_launches(sess.schedule_ir, TP_FLASH[name])
    losses, norms, step_s, launches = _checked_steps(
        torch, name, sess, batch, want, TP_WARMUP, TP_TIMED, guarded=True)
    return sess, {
        "mesh": dict(axes), "builder": "PartitionedPS",
        "schedule_fingerprint": sess.schedule_fingerprint,
        "losses": losses, "global_norms": norms, **held,
        "ms_per_step": statistics.median(step_s) * 1e3,
        "ms_per_step_label": "4 ranks time-sharing one card over gloo "
                             "(host-staged gathers and reductions)",
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_entry": at_entry,
        "peak_over_entry": torch.cuda.max_memory_allocated() - at_entry,
        "launches": launches, "launches_per_step": want,
        **_params_digests(sess)}


def _flash_model(torch) -> dict:
    """``flash_model`` on this rank: ``make_flash_attention(mesh)`` on
    :data:`FLASH_MODEL_AXES` at the training shape, causal, forward and
    the backward of a fixed cotangent, against the unsharded K1–K3 on the
    same inputs (one card, this process): equal bits, or within
    :data:`FLASH_MODEL_TOL` (reported)."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    from autodist_tpu_torch.mesh import build_mesh

    _fresh_peak(torch)
    mesh = build_mesh(FLASH_MODEL_AXES)
    if mesh.model_size != RING_RANKS:
        raise AssertionError(f"{FLASH_MODEL}: mesh {mesh.shape}")
    b, t, h, d = (TRAIN_SHAPE[k] for k in "BTHD")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                   for _ in range(4))

    def run(fn):
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fn(*qkv, True)
        o.backward(do)
        torch.cuda.synchronize()
        return [o.detach()] + [x.grad for x in qkv]

    ref = run(fa.flash_attention)
    _reset_all_counts()             # the wrapper's launches from here
    t0 = time.perf_counter()
    got = run(fa.make_flash_attention(mesh))
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    want = dict(dict.fromkeys(launches, 0), flash_fwd=1, flash_dq=1,
                flash_dkv=1)
    if launches != want:
        raise AssertionError(f"{FLASH_MODEL}: launched {launches}, "
                             f"expected {want}")
    names = ("o", "dq", "dk", "dv")
    equal = {n: bool(torch.equal(a, r)) for n, a, r in zip(names, got, ref)}
    err = {n: float((a - r).abs().max()) for n, a, r in zip(names, got, ref)}
    if not all(equal.values()):
        for n, a, r in zip(names, got, ref):
            torch.testing.assert_close(a, r, rtol=FLASH_MODEL_TOL,
                                       atol=FLASH_MODEL_TOL, msg=n)
    return {"mesh": FLASH_MODEL_AXES, "shape": [b, t, h, d],
            "heads_per_rank": h // mesh.model_size, "causal": True,
            "bit_equal_to_one_card": equal, "max_abs_err": err,
            "tolerance_if_not_equal": FLASH_MODEL_TOL,
            "fwd_bwd_wall_ms": wall * 1e3,
            "wall_label": "4 ranks time-sharing one card over gloo "
                          "(host-staged head gathers)",
            "launches": launches, "launches_per_step": want}


def check_tp(ring, ref, smi) -> dict:
    """Rank 0's ``tp_ps`` / ``tp_seq`` losses and global norms (the
    guard's roll-up over the model group) against ``tp_reference``'s at
    :data:`TP_LOSS_RTOL`; emits each configuration's line and
    ``flash_model``'s; returns K1–K5's launches by path."""
    paths = {}
    for config in TP_CONFIGS:
        out = ring[config]
        rels = {}
        for key in ("losses", "global_norms"):
            want = ref[key][:len(out[key])]
            rels[key] = max(abs(a - b) / abs(b)
                            for a, b in zip(out[key], want))
            if not rels[key] <= TP_LOSS_RTOL:
                raise AssertionError(
                    f"{config}: rank 0's {key} {out[key]} differ from the "
                    f"one-card PartitionedPS run's {want} by "
                    f"{rels[key]:.2e}")
        emit({"phase": config, "card": smi, "ranks": RING_RANKS,
              "params_identical_across_ranks": True,
              "one_card_losses": ref["losses"][:len(out["losses"])],
              "one_card_global_norms":
                  ref["global_norms"][:len(out["global_norms"])],
              "max_rel_diff_vs_one_card": rels["losses"],
              "max_rel_norm_diff_vs_one_card": rels["global_norms"],
              "rtol": TP_LOSS_RTOL, **out})
        paths[config + " (rank 0)"] = out
    emit({"phase": FLASH_MODEL, "card": smi, "ranks": RING_RANKS,
          **ring[FLASH_MODEL]})
    paths[FLASH_MODEL + " (rank 0)"] = ring[FLASH_MODEL]
    return paths


def moe_flops_per_step(cfg, batch: int, capacity_factor: float = 2.0
                       ) -> dict:
    """Model FLOPs of one training step of ``moe_transformer_lm``: 6 per
    token and weight of the attention projections and the tied head; the
    experts at their capacity (``E·C`` slots a group, full or not: the
    one-hot formulation computes every slot), 3 passes; the dispatch and
    combine einsums, ``2·G·S·E·C·M`` each a pass, the dispatch in 2
    (forward and the input's gradient: the one-hot takes none) and the
    combine in 3; the router, 3 passes; and the nine causal ``T x T x D``
    products of the flash kernels a layer."""
    d = cfg["num_heads"] * cfg["head_dim"]
    t, e, f = cfg["seq_len"], cfg["num_experts"], cfg["d_ff"]
    layers = cfg["num_layers"]
    c = max(1, int(capacity_factor * t / e))
    tokens = batch * t
    dense = 6.0 * tokens * (layers * 4 * d * d + cfg["vocab_size"] * d)
    experts = 3 * 4.0 * e * batch * c * d * f * layers
    routing = (2 + 3) * 2.0 * batch * t * e * c * d * layers
    router = 3 * 2.0 * tokens * d * e * layers
    attn = 9 * 2.0 * batch * cfg["num_heads"] * t * (t + 1) // 2 \
        * cfg["head_dim"] * layers
    total = dense + experts + routing + router + attn
    return {"projections_and_head": dense, "experts": experts,
            "dispatch_and_combine": routing, "router": router,
            "attention": attn, "total": total, "capacity": c}


def _moe_spec(mesh=None):
    """``moe_transformer_lm`` at the repo's widths and :data:`MOE_LAYERS`
    layers, its attention through K1–K3 (``attn_fn`` defaults to dense, as
    in the JAX package)."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    from autodist_tpu_torch.models.moe_lm import moe_transformer_lm

    return moe_transformer_lm(mesh, num_layers=MOE_LAYERS,
                              attn_fn=fa.flash_attention)


def _moe_session(spec, axes=None, mesh=None):
    """``PSLoadBalancing()`` (the facade's default builder, named) with
    ``fusable_adam(1e-3)`` and the clip on the MoE LM through the facade
    (on ``axes``; one card without), its expert stacks flagged: the
    session and the fixed batch of 8 rows."""
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import PSLoadBalancing

    adm._reset_default_autodist_for_testing()
    ad = adm.AutoDist(strategy_builder=PSLoadBalancing(), mesh_axes=axes)
    with ad.scope():
        ad.capture(params=lm_params(spec), optimizer=fk.fusable_adam(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   expert_vars=spec.expert_vars,
                   numerics={"clip_norm": CLIP_NORM})
    return (ad.create_distributed_session(mesh=mesh),
            spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED))


def phase_moe_reference(torch):
    """``moe_reference``: the MoE LM at the JAX widths (vocab 32128, 12 x
    64 heads, d_ff 3072, 8 experts, seq 1024; :data:`MOE_LAYERS` layers)
    on one card,
    batch 8, ``PSLoadBalancing()`` + ``fusable_adam(1e-3)`` + the clip,
    1 + 3 steps: K1–K3 once a layer each a step, K4/K5 as the schedule IR
    predicts,
    finite falling losses, every step's ``grad_health`` finite; ms per
    step, tokens/s, peak memory and ``mfu_f32`` from the written-out
    FLOPs.  Its losses and global norms hold ``moe_ep``'s."""
    spec = _moe_spec()
    _fresh_peak(torch)
    t0 = time.perf_counter()
    sess, batch = _moe_session(spec)
    build_s = time.perf_counter() - t0
    cfg = spec.config
    want = _ir_predicted_launches(sess.schedule_ir, cfg["num_layers"])
    losses, norms, step_s, launches = _checked_steps(
        torch, "moe_reference", sess, batch, want, MOE_REF_WARMUP,
        MOE_REF_TIMED, guarded=True)
    _check_falling(losses)
    infos = sess._gi.info.variables
    step = statistics.median(step_s)
    flops = moe_flops_per_step(cfg, TRAIN_SHAPE["B"])
    out = {"builder": "PSLoadBalancing", "config": cfg,
           "params": sum(int(np.prod(v.shape)) for v in infos),
           "param_bytes": sum(v.byte_size for v in infos),
           "expert_param_bytes": sum(v.byte_size for v in infos
                                     if v.expert),
           "session_build_s": build_s, "losses": losses,
           "global_norms": norms, "ms_per_step": step * 1e3,
           "ms_per_step_min": min(step_s) * 1e3,
           "ms_per_step_max": max(step_s) * 1e3,
           "tokens_per_s": TRAIN_SHAPE["B"] * cfg["seq_len"] / step,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "model_tflop_per_step": flops["total"] / 1e12,
           "model_tflop_split": {k: v / 1e12 for k, v in flops.items()
                                 if k != "capacity"},
           "capacity": flops["capacity"],
           "mfu_f32": flops["total"] / step / H100_F32_FLOPS,
           "launches": launches, "launches_per_step": want}
    del sess
    torch.cuda.empty_cache()
    return out


def _moe_ep_train(torch):
    """``moe_ep`` on this rank: the MoE LM on :data:`MOE_EP_AXES` (its
    MoE layers given the mesh), ``moe_reference``'s program; the session
    and its numbers (rank-identical parameters are the caller's check,
    the losses against ``moe_reference`` the main process's)."""
    from autodist_tpu_torch.mesh import build_mesh

    _fresh_peak(torch)
    at_entry = torch.cuda.memory_allocated()
    mesh = build_mesh(MOE_EP_AXES)
    spec = _moe_spec(mesh)
    sess, batch = _moe_session(spec, MOE_EP_AXES, mesh)
    if {k: v for k, v in sess.mesh.shape.items() if v > 1} != MOE_EP_AXES:
        raise AssertionError(f"{MOE_EP}: mesh {sess.mesh.shape}")
    held = _shard_bytes(torch, sess)
    stacks = sorted(v.name for v in sess._gi.info.variables if v.expert)
    sharded = sorted(sess._step.model_shards)
    if sharded != stacks:
        raise AssertionError(f"{MOE_EP}: sharded {sharded}, expert stacks "
                             f"{stacks}")
    want = _ir_predicted_launches(sess.schedule_ir,
                                  spec.config["num_layers"])
    losses, norms, step_s, launches = _checked_steps(
        torch, MOE_EP, sess, batch, want, MOE_EP_WARMUP, MOE_EP_TIMED,
        guarded=True)
    return sess, {
        "mesh": dict(MOE_EP_AXES), "builder": "PSLoadBalancing",
        "schedule_fingerprint": sess.schedule_fingerprint,
        "losses": losses, "global_norms": norms, **held,
        "ms_per_step": statistics.median(step_s) * 1e3,
        "ms_per_step_label": "4 ranks time-sharing one card over gloo "
                             "(host-staged expert gathers and reductions)",
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_entry": at_entry,
        "peak_over_entry": torch.cuda.max_memory_allocated() - at_entry,
        "launches": launches, "launches_per_step": want,
        **_params_digests(sess)}


def _moe_ffn_ep(torch) -> dict:
    """``moe_ffn_ep`` on this rank: ``moe_ffn(mesh=)`` on
    :data:`MOE_FFN_AXES` with this rank's 2 of the 8 experts, at the MoE
    LM's layer shape (8 x 1024 x 768, d_ff 3072), forward and the
    backward of a fixed cotangent, against the one-card call on the same
    inputs and all 8 experts (this process) within rtol/atol
    :data:`MOE_FFN_TOL`: ``y``, aux, the gradients of x, the router and
    this rank's experts; then the int8 wire's exact construction
    (:data:`MOE_EXACT`), the quantized run equal to the f32 run bit for
    bit.  Neither launches a kernel of K1–K10."""
    from autodist_tpu_torch.mesh import build_mesh
    from autodist_tpu_torch.parallel.moe import init_moe_params, moe_ffn

    _fresh_peak(torch)
    mesh = build_mesh(MOE_FFN_AXES)
    n, r = mesh.expert_size, mesh.expert_rank
    if n != RING_RANKS:
        raise AssertionError(f"{MOE_FFN_EP}: mesh {mesh.shape}")
    b, t = TRAIN_SHAPE["B"], TRAIN_SHAPE["T"]
    m = TRAIN_SHAPE["H"] * TRAIN_SHAPE["D"]
    params = init_moe_params(SEED, m, 3072, 8)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(b, t, m, device="cuda", generator=gen)
    dy = torch.randn(b, t, m, device="cuda", generator=gen)

    def run(p, mesh_):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        y, aux = moe_ffn(leaves, xx, mesh=mesh_)
        ((y * dy).sum() + aux).backward()
        torch.cuda.synchronize()
        return {"y": y.detach(), "aux": aux.detach(), "dx": xx.grad,
                **{f"d{k}": v.grad for k, v in leaves.items()}}

    ref = run(params, None)
    mine = {k: v if k == "router" else v.chunk(n)[r].clone()
            for k, v in params.items()}
    _reset_all_counts()
    t0 = time.perf_counter()
    got = run(mine, mesh)
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    for k in ("dwi", "dwo"):
        ref[k] = ref[k].chunk(n)[r]
    err = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=MOE_FFN_TOL,
                                   atol=MOE_FFN_TOL, msg=k)
    g, s, em, e = (MOE_EXACT[k] for k in "gsme")
    eye = torch.eye(em, device="cuda").expand(e // n, em, em).contiguous()
    exact = {"router": torch.randn(em, e, device="cuda", generator=gen),
             "wi": eye, "wo": eye.clone()}
    tokens = torch.randint(-126, 127, (g, s, em), device="cuda",
                           generator=gen).float()
    tokens[:, :, 0] = 127.0
    runs = {wire: moe_ffn(exact, tokens, mesh=mesh, wire=wire,
                          capacity_factor=float(e), activation=lambda v: v)
            for wire in (None, "int8")}
    bit_equal = all(torch.equal(a, b) for a, b in zip(runs[None],
                                                      runs["int8"]))
    if not bit_equal:
        raise AssertionError(f"{MOE_FFN_EP}: the int8 wire changed the "
                             f"grid-exact construction's output")
    if any(launches.values()):
        raise AssertionError(f"{MOE_FFN_EP}: launched {launches}")
    return {"mesh": MOE_FFN_AXES, "shape": [b, t, m], "d_ff": 3072,
            "experts": 8, "experts_per_rank": 8 // n,
            "max_abs_err": err, "rtol": MOE_FFN_TOL, "atol": MOE_FFN_TOL,
            "int8_exact": {"shape": [g, s, em], "experts": e,
                           "bit_equal_to_f32_wire": bit_equal},
            "fwd_bwd_wall_ms": wall * 1e3,
            "wall_label": "4 ranks time-sharing one card over gloo "
                          "(host-staged all-to-alls)",
            "launches": launches}


def _moe_ring(torch, out, stamp) -> None:
    """The expert axis's ring configurations on this rank, into ``out``:
    ``moe_ffn_ep``, then ``moe_ep``."""
    out[MOE_FFN_EP] = _moe_ffn_ep(torch)
    stamp(MOE_FFN_EP)
    sess, out[MOE_EP] = _moe_ep_train(torch)
    del sess
    torch.cuda.empty_cache()
    stamp(MOE_EP)


def check_moe(ring, ref, smi) -> dict:
    """Rank 0's ``moe_ep`` losses and global norms (the guard's roll-up
    over every rank, each expert shard counted once) against
    ``moe_reference``'s first at :data:`MOE_LOSS_RTOL`; emits its line
    and ``moe_ffn_ep``'s; returns K1–K5's launches by path."""
    out = ring[MOE_EP]
    rels = {}
    for key in ("losses", "global_norms"):
        want = ref[key][:len(out[key])]
        rels[key] = max(abs(a - b) / abs(b) for a, b in zip(out[key], want))
        if not rels[key] <= MOE_LOSS_RTOL:
            raise AssertionError(
                f"{MOE_EP}: rank 0's {key} {out[key]} differ from the "
                f"one-card run's {want} by {rels[key]:.2e}")
    emit({"phase": MOE_EP, "card": smi, "ranks": RING_RANKS,
          "params_identical_across_ranks": True,
          "one_card_losses": ref["losses"][:len(out["losses"])],
          "one_card_global_norms":
              ref["global_norms"][:len(out["global_norms"])],
          "max_rel_diff_vs_one_card": rels["losses"],
          "max_rel_norm_diff_vs_one_card": rels["global_norms"],
          "rtol": MOE_LOSS_RTOL, **out})
    emit({"phase": MOE_FFN_EP, "card": smi, "ranks": RING_RANKS,
          **ring[MOE_FFN_EP]})
    return {MOE_EP + " (rank 0)": out}


def _pipe_spec(name=None, mesh=None):
    """The pipe axis's programs at the JAX widths and :data:`PIPE_LAYERS`
    layers, their attention through K1–K3: the pipelined LM (``name``
    None: pipe 1, the reference; :data:`PIPE_GPIPE` on ``mesh``;
    :data:`PIPE_1F1B`: 1F1B, V = 2, :data:`PIPE_MICROBATCHES` a data
    shard), or the pipelined MoE LM at :data:`PIPE_MOE_LAYERS` layers
    (:data:`PIPE_MOE`, and ``"moe_reference"`` at pipe 1)."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    from autodist_tpu_torch.models import (pipelined_moe_transformer_lm,
                                           pipelined_transformer_lm)

    if name in (PIPE_MOE, "moe_reference"):
        return pipelined_moe_transformer_lm(
            mesh, num_layers=PIPE_MOE_LAYERS, attn_fn=fa.flash_attention,
            num_microbatches=PIPE_MICROBATCHES[PIPE_MOE] if mesh else None)
    if name == PIPE_1F1B:
        return pipelined_transformer_lm(
            mesh, num_layers=PIPE_LAYERS, attn_fn=fa.flash_attention,
            schedule="1f1b", num_virtual_stages=2,
            num_microbatches=PIPE_MICROBATCHES[PIPE_1F1B])
    return pipelined_transformer_lm(
        mesh, num_layers=PIPE_LAYERS, attn_fn=fa.flash_attention,
        num_microbatches=PIPE_MICROBATCHES[PIPE_GPIPE] if mesh else None)


def _pipe_session(spec, axes=None, mesh=None):
    """``PSLoadBalancing()`` with ``fusable_adam(1e-3)`` and the clip on a
    pipelined LM through the facade (on ``axes``; one card without), its
    stage stacks flagged and its 1F1B ``grad_fn`` taken when it has one:
    the session and the fixed batch of 8 rows."""
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import PSLoadBalancing

    adm._reset_default_autodist_for_testing()
    ad = adm.AutoDist(strategy_builder=PSLoadBalancing(), mesh_axes=axes)
    with ad.scope():
        ad.capture(params=lm_params(spec), optimizer=fk.fusable_adam(1e-3),
                   loss_fn=spec.loss_fn, grad_fn=spec.grad_fn,
                   sparse_vars=spec.sparse_vars,
                   pipeline_vars=spec.pipeline_vars,
                   expert_vars=spec.expert_vars,
                   numerics={"clip_norm": CLIP_NORM})
    return (ad.create_distributed_session(mesh=mesh),
            spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED))


def phase_pipe_reference(torch):
    """``pipe_reference``: ``pipelined_transformer_lm()`` at the JAX
    widths and :data:`PIPE_LAYERS` layers at pipe 1 (the plain loop over
    the stack) on one card, batch 8, ``PSLoadBalancing()`` +
    ``fusable_adam(1e-3)`` + the clip, 1 + 3 steps: K1–K3 once a layer
    each a step, K4/K5 as the schedule IR
    predicts, finite falling losses; ms per step, tokens/s, peak memory
    and ``mfu_f32``.  Its losses and global norms hold ``pipe_gpipe``'s,
    and ``pipe_1f1b``'s: the 1F1B spec draws the same layers from the
    same seed and stores them device-major, which the check here
    confirms bit for bit on the CPU draws.  Then ``moe_reference``: the
    pipelined MoE LM at :data:`PIPE_MOE_LAYERS` layers the same way, 1 + 1
    steps, the oracle of ``pipe_moe``."""
    from autodist_tpu_torch.mesh import Mesh
    from autodist_tpu_torch.parallel.pipeline import interleaved_stage_order

    out = {}
    for name, warmup, timed in (("reference", PIPE_REF_WARMUP,
                                 PIPE_REF_TIMED),
                                ("moe_reference", PIPE_WARMUP, PIPE_TIMED)):
        spec = _pipe_spec(name)
        _fresh_peak(torch)
        t0 = time.perf_counter()
        sess, batch = _pipe_session(spec)
        build_s = time.perf_counter() - t0
        cfg = spec.config
        want = _ir_predicted_launches(sess.schedule_ir, cfg["num_layers"])
        losses, norms, step_s, launches = _checked_steps(
            torch, f"pipe_{name}", sess, batch, want, warmup, timed,
            guarded=True)
        step = statistics.median(step_s)
        infos = sess._gi.info.variables
        row = {"builder": "PSLoadBalancing", "config": cfg,
               "stack_bytes": sum(v.byte_size for v in infos
                                  if v.pipeline),
               "session_build_s": build_s, "losses": losses,
               "global_norms": norms, "ms_per_step": step * 1e3,
               "tokens_per_s": TRAIN_SHAPE["B"] * cfg["seq_len"] / step,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": launches, "launches_per_step": want}
        if name == "reference":
            _check_falling(losses)
            flops = model_flops_per_step(cfg, TRAIN_SHAPE["B"])
            row.update(ms_per_step_min=min(step_s) * 1e3,
                       ms_per_step_max=max(step_s) * 1e3,
                       model_tflop_per_step=flops["total"] / 1e12,
                       mfu_f32=flops["total"] / step / H100_F32_FLOPS)
        else:
            flops = moe_flops_per_step(cfg, TRAIN_SHAPE["B"])
            row["mfu_f32"] = flops["total"] / step / H100_F32_FLOPS
        out[name] = row
        del sess
        torch.cuda.empty_cache()
    # the 1F1B spec's stack is the reference's, stored device-major
    ref = lm_params(_pipe_spec(), device="cpu")["stack"]
    mine = lm_params(_pipe_spec(PIPE_1F1B, Mesh(
        shape=PIPE_AXES[PIPE_1F1B], device=torch.device("cpu"))),
        device="cpu")["stack"]
    lpc = PIPE_LAYERS // 4
    order = interleaved_stage_order(2, 2)
    rows = [order.index(g) * lpc + k for g in range(4) for k in range(lpc)]
    from autodist_tpu_torch.graph_item import flatten

    same = all(torch.equal(a[rows], b) for (_, a), (_, b) in zip(
        flatten(mine), flatten(ref)))
    if not same:
        raise AssertionError("pipe_1f1b's stack is not the reference's "
                             "layers in device-major order")
    out["reference"]["is_pipe_1f1b_pipeline_order"] = same
    return out


def _pipe_train(torch, name):
    """The ``pipe_gpipe`` / ``pipe_1f1b`` / ``pipe_moe`` configuration on
    this rank (see the module docstring): the session's numbers, K1–K3 a
    step as :data:`PIPE_FLASH` says and K4/K5 as the IR predicts, this
    rank's stage bytes and the digest of the gathered parameters."""
    from autodist_tpu_torch.mesh import build_mesh

    axes = PIPE_AXES[name]
    _fresh_peak(torch)
    at_entry = torch.cuda.memory_allocated()
    mesh = build_mesh(axes)
    spec = _pipe_spec(name, mesh)
    t0 = time.perf_counter()
    sess, batch = _pipe_session(spec, axes, mesh)
    build_s = time.perf_counter() - t0
    if {k: v for k, v in sess.mesh.shape.items() if v > 1} != axes:
        raise AssertionError(f"{name}: mesh {sess.mesh.shape}")
    held = _shard_bytes(torch, sess)
    stacks = sorted(v.name for v in sess._gi.info.variables if v.pipeline)
    if sorted(sess._step.shard_cuts) != stacks:
        raise AssertionError(f"{name}: cut {sorted(sess._step.shard_cuts)}"
                             f", stage stacks {stacks}")
    want = _ir_predicted_launches(sess.schedule_ir,
                                  spec.config["num_layers"])
    want.update(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                    PIPE_FLASH[name]))
    losses, norms, step_s, launches = _checked_steps(
        torch, name, sess, batch, want, PIPE_WARMUP, PIPE_TIMED,
        guarded=True)
    return sess, {
        "mesh": dict(axes), "builder": "PSLoadBalancing",
        "schedule": spec.config["schedule"],
        "virtual_stages": 2 if name == PIPE_1F1B else 1,
        "microbatches": PIPE_MICROBATCHES[name],
        "num_layers": spec.config["num_layers"],
        "schedule_fingerprint": sess.schedule_fingerprint,
        "session_build_s": build_s, "losses": losses,
        "global_norms": norms, **held,
        "ms_per_step": statistics.median(step_s) * 1e3,
        "ms_per_step_label": "4 ranks time-sharing one card over gloo "
                             "(host-staged activation hops and "
                             "reductions)",
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_entry": at_entry,
        "peak_over_entry": torch.cuda.max_memory_allocated() - at_entry,
        "launches": launches, "launches_per_step": want,
        **_params_digests(sess)}


def _pipe_twin(torch) -> dict:
    """The 1F1B twin (``examples_torch/pipeline_1f1b.py``) on this rank at
    :data:`PIPE_TWIN_ARGS` (``{"pipe": 2, "data": 2}``, V = 2): its
    1F1B and GPipe losses (its own drift check holds), seconds and
    launches; its output goes to stderr."""
    import contextlib

    twin = importlib.import_module(f"examples_torch.{PIPE_TWIN}")
    _fresh_peak(torch)
    _reset_all_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        losses = twin.main(list(PIPE_TWIN_ARGS))
    torch.cuda.synchronize()
    return {"args": list(PIPE_TWIN_ARGS), "losses": losses,
            "seconds": time.perf_counter() - t0,
            "launches": _kernel_counts()}


def _pipe_ring(torch, out, stamp) -> None:
    """The pipe axis's ring configurations on this rank, into ``out``:
    ``pipe_gpipe``, ``pipe_1f1b``, ``pipe_moe``, then the 1F1B twin."""
    for name in PIPE_CONFIGS:
        sess, out[name] = _pipe_train(torch, name)
        del sess
        torch.cuda.empty_cache()
        stamp(name)
    out[PIPE_TWIN] = _pipe_twin(torch)
    stamp(PIPE_TWIN)


def check_pipe(ring, ref, smi) -> dict:
    """Rank 0's ``pipe_gpipe`` and ``pipe_1f1b`` losses and global norms
    against ``pipe_reference``'s first and ``pipe_moe``'s against the
    MoE reference's at :data:`PIPE_LOSS_RTOL`; emits each line and the
    twin's; returns K1–K5's launches by path."""
    paths = {}
    for name in PIPE_CONFIGS:
        out = ring[name]
        base = ref["moe_reference" if name == PIPE_MOE else "reference"]
        rels = {}
        for key in ("losses", "global_norms"):
            want = base[key][:len(out[key])]
            rels[key] = max(abs(a - b) / abs(b)
                            for a, b in zip(out[key], want))
            if not rels[key] <= PIPE_LOSS_RTOL:
                raise AssertionError(
                    f"{name}: rank 0's {key} {out[key]} differ from the "
                    f"one-card run's {want} by {rels[key]:.2e}")
        emit({"phase": name, "card": smi, "ranks": RING_RANKS,
              "params_identical_across_ranks": True,
              "one_card_losses": base["losses"][:len(out["losses"])],
              "one_card_global_norms":
                  base["global_norms"][:len(out["global_norms"])],
              "max_rel_diff_vs_one_card": rels["losses"],
              "max_rel_norm_diff_vs_one_card": rels["global_norms"],
              "rtol": PIPE_LOSS_RTOL, **out})
        paths[f"{name} (rank 0)"] = out
    emit({"phase": PIPE_TWIN, "card": smi, "ranks": RING_RANKS,
          **ring[PIPE_TWIN]})
    paths.update({f"pipe_{k}": v for k, v in ref.items()})
    return paths


# --- P10's rest: the MPMD pipeline runtime and the engines' meshes --------

def _mpmd_rows(tokens, rank: int, dp: int) -> list:
    """Data-parallel rank ``rank``'s rows of each of the
    :data:`MPMD_MICRO` microbatches (disjoint rows; at ``dp`` 1 every
    microbatch whole)."""
    rows = tokens.shape[0] // (MPMD_MICRO * dp)
    return [tokens[j * dp * rows + rank * rows:
                   j * dp * rows + (rank + 1) * rows]
            for j in range(MPMD_MICRO)]


def _mpmd_case(torch, dp: int, device=None):
    """The full-width LM as :data:`MPMD_STAGES` stage programs:
    ``(program, per-stage params, stage_fn_for, loss_fn, tokens)``.  The
    blocks are the catalog (numpy, from the one CPU draw); the embedding,
    the position table and the final norm are frozen, closed over by stage
    0's ``stage_fn`` and the last stage's ``loss_fn``: the head is tied to
    the embedding, and a tied weight cannot live on two stages.  Attention
    is the flash kernels (K1–K3); ``device`` is resolved as the model's
    own (the card)."""
    from autodist_tpu_torch.graph_item import flatten, unflatten
    from autodist_tpu_torch.models import base
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
    from autodist_tpu_torch.models.base import (cross_entropy_loss,
                                                layer_norm, promote_f32)
    from autodist_tpu_torch.models.generate import decode_layer
    from autodist_tpu_torch.models.quantize import embed_lookup
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.parallel import mpmd

    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    spec = transformer_lm(num_layers=MPMD_LAYERS)
    cfg = spec.config
    host = lm_params(spec, device="cpu")
    layers = [{n: v.numpy() for n, v in flatten(
        host["decoder"][f"layers_{i}"])} for i in range(MPMD_LAYERS)]
    part, stage_params = mpmd.partition_params(layers, MPMD_STAGES)
    rows = MPMD_BATCH // (MPMD_MICRO * dp)
    prog = mpmd.build_pipeline_ir(
        layer_params=layers, num_stages=MPMD_STAGES,
        num_microbatches=MPMD_MICRO,
        act_nbytes=rows * cfg["seq_len"] * cfg["num_heads"]
        * cfg["head_dim"] * 4, data_axis=dp, zero1=True,
        bucket_bytes=MPMD_BUCKET_BYTES)
    device = base.resolve_device(device)
    embed = host["embed"].to(device)
    pos = host["pos_embed"].to(device)
    ln = host["decoder"]["ln_final"]["scale"].to(device)
    layer = decode_layer(cfg["num_heads"], cfg["head_dim"], cfg["d_ff"])

    def stage_fn_for(stage):
        pre = sir.stage_name(stage)

        def fn(p, h):
            if stage == 0:
                h = promote_f32(embed_lookup(embed, h.long(), pos.dtype)
                                + pos[None, :h.shape[1]])
            for j in part.layers[stage]:
                head = f"{pre}/l{j}/"
                h = layer(unflatten([(n[len(head):], v) for n, v in p.items()
                                     if n.startswith(head)]), h,
                          fa.flash_attention)
            return h
        return fn

    def loss_fn(y, tokens):
        logits = torch.einsum("btd,vd->btv", layer_norm(y, ln),
                              embed.to(y.dtype))
        return cross_entropy_loss(logits[:, :-1], tokens.long()[:, 1:])

    tokens = np.random.RandomState(SEED).randint(
        0, cfg["vocab_size"], (MPMD_BATCH, cfg["seq_len"])).astype(np.int64)
    return prog, stage_params, stage_fn_for, loss_fn, tokens


def mpmd_worker(stage: int, rank: int, init: str, root: str,
                job: str) -> int:
    """One rank of one stage world of an ``mpmd`` job: its StageRunner
    over :data:`MPMD_STEPS` steps, one JSON line a step and a last one
    (parameters' checksum and digest, fingerprint, launches) appended to
    ``root/<job>/steps.s<stage>r<rank>``; the ``chaos`` job snapshots
    every step and takes ``AUTODIST_CHAOS`` from the supervisor."""
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch.parallel import mpmd

    os.environ.setdefault("GLOO_SOCKET_IFNAME", LOOPBACK)
    dist.init_process_group("gloo", init_method=init, world_size=MPMD_DP,
                            rank=rank)
    try:
        prog, stage_params, stage_fn_for, loss_fn, tokens = _mpmd_case(
            torch, MPMD_DP)
        jobdir = os.path.join(root, job)
        last = stage == MPMD_STAGES - 1
        runner = mpmd.StageRunner(
            prog, stage, stage_fn=stage_fn_for(stage),
            params=stage_params[stage],
            transport=mpmd.ActivationTransport(
                os.path.join(jobdir, "acts"), channel=f"dp{rank}",
                timeout_s=MPMD_TIMEOUT_S),
            lr=MPMD_LR, loss_fn=loss_fn if last else None, zero1=True,
            state_dir=os.path.join(jobdir, "state")
            if job == "chaos" else None)
        mbs = _mpmd_rows(tokens, rank, MPMD_DP)
        log = os.path.join(jobdir, f"steps.s{stage}r{rank}")
        _reset_all_counts()
        t0, first = time.perf_counter(), runner.step
        while runner.step < MPMD_STEPS:
            loss = runner.run_step(mbs if stage == 0 else None,
                                   mbs if last else None)
            torch.cuda.synchronize()
            with open(log, "a", encoding="utf-8") as f:
                f.write(json.dumps({
                    "step": runner.step - 1, "loss": loss,
                    "attempt": int(os.environ.get("AUTODIST_ATTEMPT", "0")),
                    "fingerprint": runner.fingerprint,
                    "t_s": time.perf_counter() - t0}) + "\n")
        launches = _kernel_counts()
        host = [runner.params[n].cpu().numpy()
                for n in sorted(runner.params)]
        with open(log, "a", encoding="utf-8") as f:
            f.write(json.dumps({
                "done": True, "fingerprint": runner.fingerprint,
                "checksum": float(sum(np.abs(h.astype(np.float64)).sum()
                                      for h in host)),
                "digest": hashlib.sha256(b"".join(
                    h.tobytes() for h in host)).hexdigest(),
                "launches": launches, "steps_run": runner.step - first,
                "seconds": time.perf_counter() - t0}) + "\n")
    finally:
        dist.destroy_process_group()
    return 0


def _mpmd_job(root: str, job: str) -> dict:
    """One job's logs: the last stage's losses by step (a replayed
    step's last line kept; the data-parallel mean is every rank's, so the
    ranks' lines must agree), each process's last line, every
    fingerprint."""
    losses, final, fps = {}, {}, set()
    for st in range(MPMD_STAGES):
        for r in range(MPMD_DP):
            with open(os.path.join(root, job, f"steps.s{st}r{r}"),
                      encoding="utf-8") as f:
                for line in f:
                    rec = json.loads(line)
                    fps.add(rec["fingerprint"])
                    if rec.get("done"):
                        final[f"s{st}r{r}"] = rec
                    elif st == MPMD_STAGES - 1:
                        if losses.get(rec["step"], rec["loss"]) \
                                != rec["loss"]:
                            raise AssertionError(
                                f"mpmd {job}: step {rec['step']}'s loss "
                                f"differs across the last stage's ranks")
                        losses[rec["step"]] = rec["loss"]
    return {"losses": [losses.get(k) for k in range(MPMD_STEPS)],
            "final": final, "fingerprints": sorted(fps)}


def _mpmd_reference(torch) -> list:
    """The same program at data size 1 in this process, on the card: the
    stages on threads over the in-memory transport, the whole batch."""
    from autodist_tpu_torch.parallel import mpmd

    prog, stage_params, stage_fn_for, loss_fn, tokens = _mpmd_case(torch, 1)
    runners = [mpmd.StageRunner(
        prog, st, stage_fn=stage_fn_for(st), params=stage_params[st],
        transport=mpmd.ActivationTransport("", channel="reference"),
        lr=MPMD_LR, loss_fn=loss_fn if st == MPMD_STAGES - 1 else None,
        zero1=True) for st in range(MPMD_STAGES)]
    mbs = _mpmd_rows(tokens, 0, 1)
    losses = []
    for _ in range(MPMD_STEPS):
        res = [None] * MPMD_STAGES

        def run(st):
            res[st] = runners[st].run_step(
                mbs if st == 0 else None,
                mbs if st == MPMD_STAGES - 1 else None)
        threads = [threading.Thread(target=run, args=(st,))
                   for st in range(MPMD_STAGES)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if res[-1] is None:
            raise RuntimeError("mpmd reference: a stage thread failed")
        losses.append(res[-1])
    torch.cuda.synchronize()
    return losses


def phase_mpmd(torch) -> dict:
    """The MPMD pipeline runtime at full width: a clean job and a chaos
    job, each two stage worlds of two gloo ranks on the card (8
    processes at once), and the one-process reference meanwhile.  The
    clean job's losses hold the reference's at :data:`MPMD_LOSS_RTOL`,
    each stage world ends on one digest, every process runs
    ``build_pipeline_ir``'s fingerprint, each clean rank launches K1–K3
    :data:`MPMD_FLASH` a step and K4/K5 never; the chaos job (stage 1's
    rank 0 killed after step 1, the stage-1 world relaunched by its
    Supervisor) ends on the clean job's losses and parameters bit for
    bit."""
    import tempfile

    from autodist_tpu_torch.resilience import (Backoff, Supervisor,
                                               SupervisorPolicy)

    root = tempfile.mkdtemp(prefix="smoke_mpmd_")
    env = dict(os.environ, GLOO_SOCKET_IFNAME=LOOPBACK)
    logs, launched, stopping = [], [], threading.Event()

    def launch(job, stage, extra):
        if stopping.is_set():      # the phase failed: start nothing more
            return {}
        init = "file://" + os.path.join(tempfile.mkdtemp(dir=root), "rdv")
        procs = {}
        for r in range(MPMD_DP):
            path = os.path.join(root, f"{job}.s{stage}r{r}.{len(logs)}.log")
            logs.append(path)
            with open(path, "w") as out:
                procs[f"s{stage}r{r}"] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--mpmd-worker", str(stage), str(r), init, root, job],
                    env=dict(env, **extra), stdout=out,
                    stderr=subprocess.STDOUT, start_new_session=True)
        launched.extend(procs.values())
        return procs

    t0 = time.perf_counter()
    for job in ("clean", "chaos"):
        os.makedirs(os.path.join(root, job), exist_ok=True)
    clean = {}
    for st in range(MPMD_STAGES):
        clean.update(launch("clean", st, {}))
    reports = {}

    def supervise(st):
        sup = Supervisor(SupervisorPolicy(
            max_restarts=1, poll_interval=0.1, kill_grace=10.0,
            backoff=Backoff(max_tries=2, base=0.01, cap=0.01)),
            workdir=os.path.join(root, f"sup{st}"))
        reports[st] = sup.run(lambda att: launch(
            "chaos", st, {"AUTODIST_CHAOS": MPMD_CHAOS, **att.env()}))
    sups = [threading.Thread(target=supervise, args=(st,), daemon=True)
            for st in range(MPMD_STAGES)]
    for t in sups:
        t.start()
    try:
        t_ref = time.perf_counter()
        ref = _mpmd_reference(torch)
        ref_s = time.perf_counter() - t_ref
        deadline = time.monotonic() + MPMD_TIMEOUT_S
        for name, p in clean.items():
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        for t in sups:
            t.join(max(deadline - time.monotonic(), 1.0))
    finally:
        stopping.set()
        for p in launched:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0

    def tails():
        out = []
        for path in logs:
            with open(path, encoding="utf-8", errors="replace") as f:
                out.append(f"--- {os.path.basename(path)}\n"
                           + f.read()[-1500:])
        return "\n".join(out)
    bad = {n: p.returncode for n, p in clean.items() if p.returncode}
    if bad or any(t.is_alive() for t in sups) or not all(
            reports.get(st) is not None and reports[st].ok
            for st in range(MPMD_STAGES)):
        raise RuntimeError(f"mpmd: clean exits {bad}, chaos reports "
                           f"{reports}\n{tails()}")
    runs = {job: _mpmd_job(root, job) for job in ("clean", "chaos")}
    want_fp = _mpmd_case(torch, MPMD_DP)[0].ir.fingerprint()
    c, k = runs["clean"], runs["chaos"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(c["losses"], ref))
    checks = {
        "losses within rtol of the one-process run": rel <= MPMD_LOSS_RTOL,
        "one digest per stage world": all(
            c["final"][f"s{st}r0"]["digest"]
            == c["final"][f"s{st}r{r}"]["digest"]
            for st in range(MPMD_STAGES) for r in range(MPMD_DP)),
        "one fingerprint, build_pipeline_ir's": c["fingerprints"]
        == k["fingerprints"] == [want_fp],
        "K1-K3 a step a rank, K4/K5 0": all(
            [f["launches"][n] for n in ("flash_fwd", "flash_dq",
                                        "flash_dkv")]
            == [MPMD_FLASH * MPMD_STEPS] * 3
            and f["launches"]["detect_stats"] == 0
            and f["launches"]["adam_update"] == 0
            for f in c["final"].values()),
        "the chaos job relaunched stage 1 once": reports[0].attempts == 1
        and reports[1].attempts == 2,
        "chaos losses bit for bit": k["losses"] == c["losses"],
        "chaos parameters bit for bit": {
            n: (f["checksum"], f["digest"]) for n, f in k["final"].items()}
        == {n: (f["checksum"], f["digest"])
            for n, f in c["final"].items()},
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mpmd: {failed}: clean {c}, chaos {k}, "
                             f"reference {ref}\n{tails()}")
    shutil.rmtree(root, ignore_errors=True)
    rank0 = c["final"]["s0r0"]
    return {"stages": MPMD_STAGES, "ranks_per_stage": MPMD_DP,
            "layers": MPMD_LAYERS, "microbatches": MPMD_MICRO,
            "batch": MPMD_BATCH, "steps": MPMD_STEPS,
            "losses": c["losses"], "one_process_losses": ref,
            "max_rel_diff_vs_one_process": rel, "rtol": MPMD_LOSS_RTOL,
            "chaos_losses": k["losses"], "chaos": MPMD_CHAOS,
            "restarts": reports[1].attempts - 1,
            "schedule_fingerprint": want_fp,
            "launches": rank0["launches"],
            "launches_per_step": {n: v / MPMD_STEPS for n, v in
                                  rank0["launches"].items()},
            "seconds_by_rank": {n: f["seconds"]
                                for n, f in c["final"].items()},
            "reference_s": ref_s, "wall_s": wall,
            "seconds_label": "8 stage processes and the reference at once "
                             "on one card over gloo (host-staged)"}


def _program_g_requests(vocab: int, n: int):
    """Program G's requests (``__graft_entry__.py``) at ``vocab``:
    ``2n`` requests, the shared prefix, and the prefix pass's ``n``
    requests with mixed ``use_prefix``."""
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, vocab, rng.randint(2, 6)).astype(np.int32),
             int(rng.randint(3, 9))) for _ in range(2 * n)]
    prefix = rng.randint(0, vocab, 6).astype(np.int32)
    pre = [(rng.randint(0, vocab, rng.randint(2, 5)).astype(np.int32),
            int(rng.randint(3, 7)), bool(i % 2)) for i in range(n)]
    return reqs, prefix, pre


def _tp_logits_probe(torch, eng, params) -> float:
    """One decode tick at the engine's shape through the paged token step
    twice, on the same random pools, block table and inputs: over all the
    heads (the one-card engine's tick: K9 on 12 heads) and over this
    rank's heads of the model group (the sharded engine's: K9 on 3, the
    heads gathered); the logits' largest absolute difference."""
    from autodist_tpu_torch.models.generate import unpack_lm_params
    from autodist_tpu_torch.serving.paged_kv import _paged_token_step

    cfg, dev = eng._cfg, eng._device
    nl, h, dh = cfg["num_layers"], cfg["num_heads"], cfg["head_dim"]
    b, maxb, bs = eng._slots, eng._maxb, eng._block_size
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kc = torch.randn((nl, eng._num_blocks, bs, h, dh), generator=gen,
                     device=dev)
    vc = torch.randn(kc.shape, generator=gen, device=dev)
    bt = torch.randint(1, eng._num_blocks, (b, maxb), generator=gen,
                       device=dev, dtype=torch.int32)
    x = torch.randn((b, h * dh), generator=gen, device=dev)
    rel = torch.tensor([0, 15, 31, 32, 500, 700, 1000, maxb * bs - 1][:b],
                       dtype=torch.int32, device=dev).clamp(max=maxb * bs - 1)
    blk = bt.long()[torch.arange(b, device=dev), rel.long() // bs]
    off = rel.long() % bs
    _, m, rank = eng._head_shard
    embed, _, layers, ln = unpack_lm_params(params, nl)

    def cut(t):
        return t[..., rank * h // m:(rank + 1) * h // m, :].contiguous()
    with torch.no_grad():
        one = _paged_token_step(layers, ln, embed, x, kc.clone(),
                                vc.clone(), bt, blk, off, rel)
        tp = _paged_token_step(layers, ln, embed, x, cut(kc), cut(vc), bt,
                               blk, off, rel, head_shard=eng._head_shard)
    return (one - tp).abs().max().item()


def _serve_tp(torch) -> dict:
    """``serve``'s requests through ``PagedDecodeEngine`` on
    :data:`SERVE_TP_AXES`: each rank holds 1/4 of every K/V pool's heads
    and runs K9 on them, 12 launches a decode tick; the tokens (checked
    against the plain generator by the parent), the pool bytes a rank
    and the logits' difference from the one-card tick."""
    from autodist_tpu_torch.mesh import build_mesh
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.serving import PagedDecodeEngine

    spec = transformer_lm()
    cfg = spec.config
    params = lm_params(spec, device="cuda")
    requests, _ = _serve_requests(cfg["vocab_size"], SEED + 1)
    eng = PagedDecodeEngine(spec, params, device="cuda",
                            mesh=build_mesh(SERVE_TP_AXES), **SERVE_GEOM)
    _reset_all_counts()
    t0 = time.perf_counter()
    ids = [eng.submit(p, n) for p, n, _ in requests]
    res = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _kernel_counts()
    eng.assert_no_leaks()
    ticks = eng.stats.ticks
    if launches["paged_attention"] != cfg["num_layers"] * ticks or any(
            v for n, v in launches.items()
            if n not in ("paged_attention",)):
        raise AssertionError(f"{SERVE_TP}: launches {launches} for {ticks} "
                             f"decode ticks")
    pool = (eng._kc.numel() + eng._vc.numel()) * eng._kc.element_size()
    shards = SERVE_TP_AXES["model"]
    if (pool, pool * shards) != SERVE_TP_POOL_BYTES or \
            eng._kc.shape[3] != cfg["num_heads"] // shards:
        raise AssertionError(f"{SERVE_TP}: pool {tuple(eng._kc.shape)}, "
                             f"{pool} B a rank")
    return {"tokens": [res[i].tolist() for i in ids], "launches": launches,
            "decode_ticks": ticks,
            "paged_attention_per_tick": launches["paged_attention"] / ticks,
            "heads_per_rank": int(eng._kc.shape[3]),
            "pool_bytes_per_rank": pool, "pool_bytes_one_card": pool * shards,
            "seconds": seconds,
            "logits_max_abs_diff_vs_one_card": _tp_logits_probe(
                torch, eng, params)}


def _sampled_slot_run(torch, spec, params, reqs, mesh=None) -> list:
    """Program G's requests sampled (:data:`SERVE_SLOTS_SAMPLED`, the
    temperatures :data:`SERVE_SLOTS_TEMPS` in turn) on the slot engine at
    :data:`SLOT_GEOM` from a card generator seeded
    :data:`SERVE_SLOTS_SAMPLE_SEED`; on ``mesh`` its slots are sharded."""
    from autodist_tpu_torch.serving import DecodeEngine

    rng = torch.Generator(device="cuda").manual_seed(SERVE_SLOTS_SAMPLE_SEED)
    eng = DecodeEngine(spec, params, device="cuda", mesh=mesh, rng=rng,
                       **SLOT_GEOM, **SERVE_SLOTS_SAMPLED)
    temps = SERVE_SLOTS_TEMPS
    ids = [eng.submit(p, n, temperature=temps[i % len(temps)])
           for i, (p, n) in enumerate(reqs)]
    res = eng.run()
    return [res[i].tolist() for i in ids]


def _serve_slots(torch) -> dict:
    """Program G at full width: the slot engine (``serve()``'s default)
    at :data:`SLOT_GEOM` with its slots over :data:`SERVE_SLOTS_AXES`,
    2 a rank; Program G's requests, then its prefix pass, then the
    requests sampled; the tokens (checked by the parent against the plain
    generator, the sampled ones against the one-card engine) and the
    cache bytes a rank."""
    from autodist_tpu_torch.mesh import build_mesh
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.serving import DecodeEngine

    spec = transformer_lm()
    cfg = spec.config
    params = lm_params(spec, device="cuda")
    shards = SERVE_SLOTS_AXES["data"]
    reqs, prefix, pre = _program_g_requests(cfg["vocab_size"], shards)
    eng = DecodeEngine(spec, params, device="cuda",
                       mesh=build_mesh(SERVE_SLOTS_AXES), **SLOT_GEOM)
    _reset_all_counts()
    t0 = time.perf_counter()
    ids = [eng.submit(p, n) for p, n in reqs]
    res = eng.run()
    eng.set_prefix(prefix)
    pre_ids = [eng.submit(p, n, use_prefix=u) for p, n, u in pre]
    res_pre = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cache = (eng._kc.numel() + eng._vc.numel()) * eng._kc.element_size()
    if (cache, cache * shards) != SERVE_SLOTS_CACHE_BYTES or \
            tuple(eng._tokens.shape) != (SLOT_GEOM["slots"] // shards,
                                         SLOT_GEOM["window"]):
        raise AssertionError(f"{SERVE_SLOTS}: caches {tuple(eng._kc.shape)}"
                             f", {cache} B a rank")
    out = {"tokens": [res[i].tolist() for i in ids],
           "prefix_tokens": [res_pre[i].tolist() for i in pre_ids],
           "launches": _kernel_counts(), "seconds": seconds,
           "slots_per_rank": int(eng._kc.shape[2]),
           "cache_bytes_per_rank": cache,
           "cache_bytes_one_card": cache * shards,
           "prefix_admissions": eng.stats.prefix_admissions}
    del eng
    torch.cuda.empty_cache()
    out["sampled_tokens"] = _sampled_slot_run(torch, spec, params, reqs,
                                              build_mesh(SERVE_SLOTS_AXES))
    return out


def _serve_mesh_ring(torch, out, stamp) -> None:
    """The engines' meshes on this rank, into ``out``: ``serve_tp`` and
    ``serve_slots``."""
    for name, fn in ((SERVE_TP, _serve_tp), (SERVE_SLOTS, _serve_slots)):
        out[name] = fn(torch)
        torch.cuda.empty_cache()
        stamp(name)


def check_serve_mesh(torch, ring_results, tp_oracle, spec, params,
                     smi) -> dict:
    """Every rank's ``serve_tp`` tokens equal the plain generator's
    answers to ``serve``'s requests (``tp_oracle``) and every rank's
    ``serve_slots`` tokens the generator's to Program G's requests and
    prefix pass, and its sampled tokens the one-card engine's under the
    same generator; emits both lines; returns rank 0's results."""
    from autodist_tpu_torch.models.generate import make_generator

    gen = make_generator(spec, device="cuda")
    reqs, prefix, pre = _program_g_requests(spec.config["vocab_size"],
                                            SERVE_SLOTS_AXES["data"])
    want = {"tokens": [gen(params, p[None, :], n)[0].cpu().numpy()
                       for p, n in reqs],
            "prefix_tokens": []}
    for p, n, use in pre:
        full = np.concatenate([prefix, p]) if use else p
        got = gen(params, full[None, :], n)[0].cpu().numpy()
        want["prefix_tokens"].append(got[prefix.size:] if use else got)
    want["sampled_tokens"] = _sampled_slot_run(torch, spec, params, reqs)
    for r, res in enumerate(ring_results):
        for i, toks in enumerate(res[SERVE_TP]["tokens"]):
            if not np.array_equal(np.asarray(toks), tp_oracle[i]):
                raise AssertionError(f"{SERVE_TP}: rank {r} request {i} "
                                     f"differs from the generator")
        for key, of in (("tokens", "the generator"),
                        ("prefix_tokens", "the generator"),
                        ("sampled_tokens", "the one-card engine")):
            for i, toks in enumerate(res[SERVE_SLOTS][key]):
                if not np.array_equal(np.asarray(toks), want[key][i]):
                    raise AssertionError(
                        f"{SERVE_SLOTS}: rank {r} {key} {i} differs from "
                        f"{of}")
    out = {}
    for name in (SERVE_TP, SERVE_SLOTS):
        out[name] = {k: v for k, v in ring_results[0][name].items()
                     if k not in ("tokens", "prefix_tokens",
                                  "sampled_tokens")}
        emit({"phase": name, "card": smi, "ranks": RING_RANKS,
              "token_exact_vs_generator": True,
              "ranks_identical": True,
              **({"sampled_equal_one_card_engine": True,
                  "sampled_requests": len(want["sampled_tokens"])}
                 if name == SERVE_SLOTS else {}),
              "seconds_label": "4 ranks time-sharing one card over gloo "
                               "(host-staged wire)", **out[name]})
    return out


def phase_train_parallax(torch, ps_out):
    """``Parallax()`` at full width: the embedding (a sparse variable) on
    PS in a reduce-scatter bucket with K5, every dense variable in
    all-reduce buckets with the tree update, the guard (K4) over both;
    losses within rtol 1e-5 of ``train_ps``'s."""
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import Parallax

    spec = transformer_lm()
    layers = spec.config["num_layers"]
    _fresh_peak(torch)
    sess, batch = _train_session(spec, lm_params(spec), TRAIN_SHAPE["B"],
                                 Parallax(), fk.fusable_adam(1e-3),
                                 numerics={"clip_norm": CLIP_NORM})
    step = sess._step
    rs_names = {n for b in sess.zero1_buckets for n in b.names}
    ar_names = {n for b in step.buckets if b.mode == "all_reduce"
                for n in b.names}
    if rs_names != set(spec.sparse_vars) or \
            ar_names != set(step.trainable) - rs_names:
        raise AssertionError(f"Parallax buckets: reduce-scatter {rs_names}, "
                             f"all-reduce {len(ar_names)} variables")
    if step.fused_kernels != ("guard", "update"):
        raise AssertionError(f"the step runs {step.fused_kernels}")
    losses, norms, step_s, launches, per_step = _bucketed_steps(
        torch, sess, batch, layers, PARALLAX_WARMUP, PARALLAX_TIMED)
    _check_falling(losses)
    ref = ps_out["losses"][:len(losses)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    if not rel <= PARALLAX_LOSS_RTOL:
        raise AssertionError(f"Parallax losses {losses} differ from "
                             f"train_ps's {ref} by {rel:.2e}")
    out = {"layers": layers, "batch": TRAIN_SHAPE["B"],
           "seq_len": spec.config["seq_len"],
           "buckets": len(step.buckets),
           "reduce_scatter_buckets": len(sess.zero1_buckets),
           "all_reduce_buckets": len(step.buckets) - len(sess.zero1_buckets),
           "losses": losses, "global_norms": norms,
           "max_rel_diff_vs_train_ps": rel, "rtol": PARALLAX_LOSS_RTOL,
           **_step_rates(torch, spec, step_s),
           "launches": launches, "launches_per_step": per_step}
    del sess
    torch.cuda.empty_cache()
    return out


def phase_train_zero1_parity(torch):
    """Depth 2 at full width: ``Zero1`` + ``fusable_adam`` + clip (K4, K5)
    against ``AllReduce`` + ``adam`` + the same clip, 3 steps; then a
    poisoned step on the ZeRO-1 session must be skipped bit-identically
    with no K5 launch."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import AllReduce, Zero1

    spec = transformer_lm(num_layers=2)
    params = lm_params(spec)

    def loss_fn(p, b):            # the batch's "s" column poisons a step
        return spec.loss_fn(p, b) * b["s"].mean()

    def with_s(batch, value):
        return dict(batch, s=np.full((TRAIN_SHAPE["B"],), value, np.float32))

    runs = {}
    for name, builder, opt in (
            ("zero1", Zero1(), fk.fusable_adam(1e-3)),
            ("allreduce", AllReduce(), optim.adam(1e-3))):
        sess, batch = _train_session(spec, params, TRAIN_SHAPE["B"], builder,
                                     opt, loss_fn,
                                     {"clip_norm": CLIP_NORM})
        before = _sync_counts(fk)
        outs = [sess.run(with_s(batch, 1.0)) for _ in range(3)]
        launched = tuple(a - b for a, b in zip(_sync_counts(fk), before))
        n = len(sess.zero1_buckets)
        if launched != ((6 * n, 3 * n) if name == "zero1" else (0, 0)):
            raise AssertionError(f"{name}: (K4, K5) launched {launched}")
        runs[name] = (sess, batch, [float(o["loss"]) for o in outs],
                      [float(o["grad_health"].global_norm) for o in outs])
    zsess, zbatch, zl, zn = runs["zero1"]
    asess, _, al, an = runs["allreduce"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(zl, al))
    if not rel <= 1e-4:
        raise AssertionError(f"Zero1 vs AllReduce losses differ (rel "
                             f"{rel:.2e}): {zl} {al}")
    pdiff = max((a - b).abs().max().item() for (_, a), (_, b) in
                zip(flatten(zsess.device_params),
                    flatten(asess.device_params)))
    if not pdiff <= 1e-5:
        raise AssertionError(f"Zero1 vs AllReduce params differ by {pdiff}")
    del asess, runs
    snap = [x.clone() for _, x in flatten(zsess.device_params)] \
        + [x.clone() for _, x in flatten(zsess.opt_state)]
    before = _sync_counts(fk)
    out = zsess.run(with_s(zbatch, float("nan")))
    k4, k5 = (a - b for a, b in zip(_sync_counts(fk), before))
    h = out["grad_health"]
    after = [x for _, x in flatten(zsess.device_params)] \
        + [x for _, x in flatten(zsess.opt_state)]
    if bool(h.all_finite) or int(h.skipped_steps) != 1 or k5 != 0 \
            or k4 != 2 * len(zsess.zero1_buckets):
        raise AssertionError(f"poisoned step: {h.all_finite}, skipped "
                             f"{h.skipped_steps}, K4 {k4}, K5 {k5}")
    if not all(torch.equal(a, b) for a, b in zip(snap, after)):
        raise AssertionError("the skipped step changed params or state")
    del zsess
    torch.cuda.empty_cache()
    return {"layers": 2, "zero1_losses": zl, "allreduce_losses": al,
            "zero1_norms": zn, "allreduce_norms": an, "max_rel_diff": rel,
            "rtol": 1e-4, "max_param_diff": pdiff, "atol": 1e-5,
            "poisoned_step": {"all_finite": bool(h.all_finite),
                              "skipped_steps": int(h.skipped_steps),
                              "k4_launches": k4, "k5_launches": k5,
                              "state_bit_identical": True}}


def _host_params(sess) -> dict:
    """Every parameter as a host array, by name."""
    from autodist_tpu_torch.graph_item import flatten

    return {n: x.detach().cpu().numpy() for n, x in
            flatten(sess.device_params)}


def _expected_launches(sess, layers: int, accum: int = 1) -> dict:
    """K1–K10 per step of a bucketed session from its plan: K1–K3 once per
    layer and microbatch; K4 twice per bucket and per variable of the
    per-variable tier (the packed local vector and the reduced value),
    once per pipelined bucket (the reduced value is the finiteness
    source, as in the JAX package), none without the guard; K5 once per
    ZeRO-1 bucket when it runs; K6/K8 once and K7 ``d - 2`` times per ring
    bucket and reduction (one per microbatch slot when pipelined)."""
    step = sess._step
    d = sess.data_axis_size
    piped = set(step.pipelined_keys)
    bucketed = {n for b in step.buckets for n in b.names}
    pervar = [n for n in step.trainable if n not in bucketed]
    guard = "guard" in step.fused_kernels
    k4 = (2 * (len(step.buckets) - len(piped)) + len(piped)
          + 2 * len(pervar)) if guard else 0
    rings = sum(accum if b.key in piped else 1 for b in step.buckets
                if step.bucket_algs[b.key] == "ring")
    return dict(dict.fromkeys(_kernel_counts(), 0),
                flash_fwd=accum * layers, flash_dq=accum * layers,
                flash_dkv=accum * layers, detect_stats=k4,
                adam_update=len(step.zero1_buckets)
                if "update" in step.fused_kernels else 0,
                quant_hop_quantize=rings,
                quant_hop_accumulate=(d - 2) * rings,
                quant_hop_dequant_add=rings)


def _max_rel_diff(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(a[n] - b[n])
                            / np.maximum(np.abs(b[n]), 1e-30)))
               for n in b)


def phase_train_accum(torch):
    """``Zero1`` + ``fusable_adam`` + clip at ``accum_steps=4`` on the
    full-width LM, unpipelined and pipelined: the same losses and
    parameters (bit for bit, or within :data:`ACCUM_RTOL`, naming the
    leaves whose bits differ); K1–K3 48 times a step, K4 twice per bucket
    (once per pipelined bucket), K5 once per bucket."""
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import Zero1

    spec = transformer_lm()
    layers = spec.config["num_layers"]
    out, params = {}, {}
    for overlap in ("none", "pipeline"):
        _fresh_peak(torch)
        sess, batch = _train_session(
            spec, lm_params(spec), TRAIN_SHAPE["B"], Zero1(overlap=overlap),
            fk.fusable_adam(1e-3), numerics={"clip_norm": CLIP_NORM},
            accum_steps=ACCUM_STEPS)
        piped = len(sess._step.pipelined_keys)
        if piped != (len(sess._step.buckets) if overlap == "pipeline"
                     else 0):
            raise AssertionError(f"train_accum {overlap}: {piped} pipelined "
                                 f"buckets of {len(sess._step.buckets)}")
        want = _expected_launches(sess, layers, ACCUM_STEPS)
        losses, norms, step_s, launches = _checked_steps(
            torch, f"train_accum {overlap}", sess, batch, want, ACCUM_WARMUP,
            ACCUM_TIMED, guarded=True)
        params[overlap] = _host_params(sess)
        out[overlap] = {"losses": losses, "global_norms": norms,
                        "buckets": len(sess._step.buckets),
                        "pipelined_buckets": piped,
                        **_step_rates(torch, spec, step_s),
                        "launches": launches, "launches_per_step": want}
        del sess
        torch.cuda.empty_cache()
    differ = [n for n in params["none"]
              if not np.array_equal(params["none"][n], params["pipeline"][n])]
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(out["pipeline"]["losses"], out["none"]["losses"]))
    param_rel = _max_rel_diff(params["pipeline"], params["none"]) \
        if differ else 0.0
    if max(loss_rel, param_rel) > ACCUM_RTOL:
        raise AssertionError(f"train_accum: the pipeline's losses/params "
                             f"differ from overlap=none's by {loss_rel:.2e} "
                             f"/ {param_rel:.2e} (leaves {differ[:8]})")
    _check_falling(out["none"]["losses"])
    return {"layers": layers, "batch": TRAIN_SHAPE["B"],
            "accum_steps": ACCUM_STEPS, "configs": out,
            "bit_identical": not differ and loss_rel == 0.0,
            "differing_leaves": differ, "max_rel_diff_losses": loss_rel,
            "max_rel_diff_params": param_rel, "rtol": ACCUM_RTOL}


def _device_copy(sess) -> list:
    """A copy of every parameter on the card."""
    from autodist_tpu_torch.graph_item import flatten

    return [x.detach().clone() for _, x in flatten(sess.device_params)]


def _same_params(sess, copy) -> bool:
    """Does every parameter of the session equal its copy in ``copy``?"""
    import torch

    from autodist_tpu_torch.graph_item import flatten

    return all(torch.equal(x, y) for (_, x), y in
               zip(flatten(sess.device_params), copy))


def _bucket_shards(sess) -> dict:
    """Each ZeRO-1 bucket's packed parameters (one rank: the whole
    vector)."""
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.kernel.synchronization.bucketing import \
        pack_bucket

    leaves = dict(flatten(sess.device_params))
    return {b.key: pack_bucket(b, [leaves[n].detach() for n in b.names])
            for b in sess.zero1_buckets}


def phase_train_stale(torch):
    """``PS(staleness=2)`` + ``fusable_adam`` on the full-width LM: the
    guard off (K4 0), K5 once per bucket; the first 2 steps leave the
    parameters unchanged, and each later step applies the gradient step
    ``t - 2`` pushed, bit for bit (K5 on the queue's oldest entry and the
    state before the step gives the step's shards exactly).  Then
    ``PS(local_proxy_variable=True)`` with ``AUTODIST_PROXY_REFRESH=2``:
    the compute copy is gathered on refresh steps only, the true shards
    move every step."""
    import warnings

    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import PS

    spec = transformer_lm()
    layers = spec.config["num_layers"]
    _fresh_peak(torch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the guard's drop, as in JAX
        sess, batch = _train_session(
            spec, lm_params(spec), TRAIN_SHAPE["B"], PS(staleness=STALE_DEPTH),
            fk.fusable_adam(1e-3), numerics={"clip_norm": CLIP_NORM})
    if sess._step.fused_kernels != ("update",):
        raise AssertionError(f"train_stale runs {sess._step.fused_kernels}")
    adam = sess._gi.optimizer.fused_spec
    want = _expected_launches(sess, layers)
    _reset_all_counts()
    checked = 0
    first = _device_copy(sess)
    losses, step_s = [], []
    for i in range(STALE_STEPS):
        expected = None
        if i >= STALE_DEPTH:
            # outside the counted window: K5 on the delayed gradient
            z, q = sess.opt_state["zero1"], sess.sync_state["queue"]
            scalars = fk.adam_scalars(z["count"], adam)
            expected = {k: fk.fused_adam_update(
                p, q[k][0], z["mu"][k], z["nu"][k], scalars, adam)
                for k, p in _bucket_shards(sess).items()}
            checked += len(expected)
        before = _kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.run(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step = {k: v - before[k] for k, v in _kernel_counts().items()}
        if per_step != want or "grad_health" in out:
            raise AssertionError(f"train_stale step {i} launched {per_step} "
                                 f"(expected {want})")
        losses.append(float(out["loss"]))
        same = _same_params(sess, first)
        if same != (i < STALE_DEPTH):
            raise AssertionError(f"train_stale step {i}: parameters "
                                 f"{'un' if same else ''}changed")
        if expected is not None:
            z, got = sess.opt_state["zero1"], _bucket_shards(sess)
            for k, (p, m, v) in expected.items():
                if not (torch.equal(got[k], p) and torch.equal(z["mu"][k], m)
                        and torch.equal(z["nu"][k], v)):
                    raise AssertionError(f"train_stale step {i}: bucket {k} "
                                         "did not apply step "
                                         f"{i - STALE_DEPTH}'s gradient")
    launches = {k: v - (checked if k == "adam_update" else 0)
                for k, v in _kernel_counts().items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_stale: non-finite losses {losses}")
    stale = {"losses": losses, "steps_unchanged": STALE_DEPTH,
             "steps_checked_bit_for_bit": STALE_STEPS - STALE_DEPTH,
             **_step_rates(torch, spec, step_s[STALE_DEPTH:]),
             "launches": launches, "launches_per_step": want}
    del sess, expected
    torch.cuda.empty_cache()

    os.environ["AUTODIST_PROXY_REFRESH"] = str(PROXY_REFRESH)
    try:
        _fresh_peak(torch)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sess, batch = _train_session(
                spec, lm_params(spec), TRAIN_SHAPE["B"],
                PS(local_proxy_variable=True), fk.fusable_adam(1e-3),
                numerics={"clip_norm": CLIP_NORM})
    finally:
        os.environ.pop("AUTODIST_PROXY_REFRESH")
    want = _expected_launches(sess, layers)
    _reset_all_counts()
    refreshed, losses, step_s = [], [], []
    for i in range(PROXY_STEPS):
        copy = _device_copy(sess)
        true = [x.clone() for x in sess.sync_state["master"].values()]
        before = _kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.run(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step = {k: v - before[k] for k, v in _kernel_counts().items()}
        if per_step != want:
            raise AssertionError(f"proxy step {i} launched {per_step} "
                                 f"(expected {want})")
        losses.append(float(out["loss"]))
        if any(torch.equal(a, b) for a, b in
               zip(true, sess.sync_state["master"].values())):
            raise AssertionError(f"proxy step {i}: a true shard did not move")
        if not _same_params(sess, copy):
            refreshed.append(i)
    due = [i for i in range(PROXY_STEPS) if (i + 1) % PROXY_REFRESH == 0]
    if refreshed != due:
        raise AssertionError(f"proxy: the compute copy was gathered at steps "
                             f"{refreshed}, expected {due}")
    proxy = {"refresh": PROXY_REFRESH, "losses": losses,
             "gather_steps": refreshed, "gathers": len(refreshed),
             "steps": PROXY_STEPS, **_step_rates(torch, spec, step_s),
             "launches": _kernel_counts(), "launches_per_step": want}
    del sess
    torch.cuda.empty_cache()
    return {"layers": layers, "batch": TRAIN_SHAPE["B"],
            "staleness": STALE_DEPTH, "stale": stale, "proxy": proxy}


def _p6_configs():
    """``(name, builder, optimizer, accum_steps, resource spec, env)`` of
    the ``train_p6`` configurations, in :data:`P6_CONFIGS` order."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import AllReduce, Zero1

    adam, fadam = (lambda: optim.adam(P6_LR)), (lambda: fk.fusable_adam(P6_LR))
    return (
        ("horovod_allreduce", AllReduce(compressor="HorovodCompressor"),
         adam, 1, None, {}),
        ("horovod_ef_zero1", Zero1(compressor="HorovodCompressorEF"), fadam,
         1, None, {}),
        ("powersgd_allreduce", AllReduce(compressor="PowerSGDCompressor"),
         adam, 1, None, {}),
        ("program_e", AllReduce(compressor="HorovodCompressorEF",
                                fused_groups=True, chunk_size=2), adam, 2,
         None, {}),
        ("int8_pipeline", Zero1(compressor="Int8Compressor",
                                overlap="pipeline"), fadam, 2, None, {}),
        ("int8_full", Zero1(compressor="Int8Compressor", overlap="full"),
         fadam, 2, None, {}),
        ("hier_zero1", Zero1(hier=True), fadam, 1, HIER_SPEC, {}),
        ("hier_zero1_int8_dcn", Zero1(hier=True), fadam, 1, HIER_SPEC,
         {"AUTODIST_DCN_WIRE": "int8"}))


def _p6_wire_bytes(sess, accum: int, dcn_wire: str) -> dict:
    """Bytes one rank sends per step, from the plan: a bucket's reduction
    over a ring (an all-reduce sends ``2 (d-1)/d`` of the vector, a
    reduce-scatter ``(d-1)/d``) at its wire width (f32 4 bytes, the cast
    compressors' bf16 2, the int8 wire 1 plus its scales), once per
    microbatch when pipelined; a ZeRO-1 bucket's f32 parameter gather;
    under ``hier`` the within-slice legs at f32 and the cross-slice leg on
    the slice's shard (on ``dcn_wire``, the compressor
    ``AUTODIST_DCN_WIRE`` names); a PowerSGD matrix ``r (n + m)`` f32
    elements twice, any other per-variable gradient whole."""
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.kernel.synchronization import quant_ring as qr
    from autodist_tpu_torch.kernel.synchronization.compressor import \
        PowerSGDCompressor

    step, d = sess._step, sess.data_axis_size
    out = {"buckets": 0.0, "param_gather": 0.0, "per_variable": 0.0}
    f32 = 0.0
    for b in step.buckets:
        n, rs = b.padded_total, b.mode == "reduce_scatter"
        slots = accum if b.key in step.pipelined_keys else 1
        legs = 1 if rs else 2
        f32 += legs * (d - 1) / d * n * 4
        fmt = qr.wire_format_of(b.compressor)
        if b.key in step.hier_keys:
            s = HIER_SPEC["num_slices"]
            d_in = d // s
            dcn = qr.wire_format_of(dcn_wire)
            sh = n // d_in
            cross = (s - 1) * qr.wire_nbytes(sh, dcn) if dcn else \
                legs * (s - 1) / s * sh * 4
            out["buckets"] += slots * (legs * (d_in - 1) / d_in * n * 4
                                       + cross)
        elif fmt is not None:
            out["buckets"] += slots * legs * (d - 1) * qr.wire_nbytes(
                n // d, fmt)
        else:
            width = 2 if b.compressor in ("HorovodCompressor",
                                          "HorovodCompressorEF") else 4
            out["buckets"] += slots * legs * (d - 1) / d * n * width
        if rs:
            out["param_gather"] += (d - 1) / d * n * 4
            f32 += (d - 1) / d * n * 4
    bucketed = {n for b in step.buckets for n in b.names}
    for name, x in flatten(sess.device_params):
        if name not in step.trainable or name in bucketed:
            continue
        f32 += 2 * (d - 1) / d * x.numel() * 4
        elems = PowerSGDCompressor().rank * (x.shape[0] + x.shape[1]) \
            if x.dim() == 2 else x.numel()
        out["per_variable"] += 2 * (d - 1) / d * elems * 4
    out["total"] = sum(out.values())
    out["f32_all_reduce_equivalent"] = f32
    out["ratio_to_f32"] = out["total"] / f32
    return out


def _check_p6_plan(name, step, builder) -> None:
    """``step``'s plan against :data:`P6_PLAN`, so that the launch counts
    :func:`_expected_launches` derives from the plan check the options
    themselves: ZeRO-1 buckets reduce-scatter and the others all-reduce,
    and ``fused_groups`` puts each strategy group (``chunk_size``
    variables) in buckets of its own, every group present."""
    comp, kernels, piped, ring, two_tier = P6_PLAN[name]
    zero1 = "update" in kernels
    got = {
        "compressors": {b.compressor for b in step.buckets},
        "fused_kernels": set(step.fused_kernels),
        "all_pipelined": bool(step.buckets)
        and set(step.pipelined_keys) == {b.key for b in step.buckets},
        "any_pipelined": bool(step.pipelined_keys),
        "ring": "ring" in step.bucket_algs.values(),
        "all_two_tier": bool(step.buckets)
        and set(step.hier_keys) == {b.key for b in step.buckets},
        "any_two_tier": bool(step.hier_keys),
        "modes": {b.mode for b in step.buckets}}
    want = {
        "compressors": {comp} if comp else set(), "fused_kernels": kernels,
        "all_pipelined": piped, "any_pipelined": piped, "ring": ring,
        "all_two_tier": two_tier, "any_two_tier": two_tier,
        "modes": ({"reduce_scatter" if zero1 else "all_reduce"}
                  if comp else set())}
    if getattr(builder, "_fused", False):
        chunk = builder._chunk_size
        groups = -(-len(step.trainable) // chunk)
        got["groups"] = ({b.group for b in step.buckets},
                         max(len(b.vars) for b in step.buckets))
        want["groups"] = (set(range(groups)), chunk)
    if got != want:
        raise AssertionError(f"{name}: plan {got}, expected {want}")


def _p6_train(torch, name, builder, optimizer, accum, resource_info, env):
    """One ``train_p6`` configuration on this rank: finite, falling losses,
    K1–K8 per step from the plan, the wire bytes, ms per step and peak
    memory, and the parameter digests the ranks must share."""
    import warnings

    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    spec = transformer_lm(num_layers=P6_LAYERS)
    _fresh_peak(torch)
    os.environ.update(env)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the JAX fallbacks' warnings
            sess, batch = _train_session(
                spec, lm_params(spec), TRAIN_SHAPE["B"], builder, optimizer,
                numerics={"clip_norm": CLIP_NORM},
                resource_info=resource_info, accum_steps=accum)
    finally:
        for k in env:
            os.environ.pop(k)
    if sess.data_axis_size != RING_RANKS:
        raise AssertionError(f"{name}: data axis {sess.data_axis_size}")
    _check_p6_plan(name, sess._step, builder)
    step = sess._step
    want = _expected_launches(sess, P6_LAYERS, accum)
    losses, _, step_s, launches = _checked_steps(
        torch, name, sess, batch, want, P6_WARMUP, P6_TIMED, guarded=True)
    _check_falling(losses)
    return sess, {
        "layers": P6_LAYERS, "accum_steps": accum, "losses": losses,
        "ms_per_step": statistics.median(step_s) * 1e3,
        "ms_per_step_min": min(step_s) * 1e3,
        "ms_per_step_max": max(step_s) * 1e3,
        "buckets": len(step.buckets), "pipelined": len(step.pipelined_keys),
        "two_tier": len(step.hier_keys),
        "algs": sorted(set(step.bucket_algs.values())),
        "fused_kernels": list(step.fused_kernels),
        "sync_state_keys": len(sess.sync_state),
        "wire_bytes_per_rank_per_step": _p6_wire_bytes(
            sess, accum, "Int8Compressor"
            if env.get("AUTODIST_DCN_WIRE") == "int8" else "NoneCompressor"),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": want,
        **_params_digests(sess)}


def _quant_counts(fk):
    return (fk.fused_quantize.calls, fk.fused_hop_accumulate.calls,
            fk.fused_dequant_add.calls)


def _ring_wire_bytes(buckets, algs, d: int) -> dict:
    """Bytes one rank sends per step: each bucket's reduce leg sends
    ``d - 1`` chunks (ring hops or ``all_to_all``), quantized by
    ``wire_nbytes``; an all-reduce bucket's gather leg as many again,
    quantized; a ZeRO-1 bucket's parameter gather ``d - 1`` f32 chunks."""
    from autodist_tpu_torch.kernel.synchronization import quant_ring as qr

    quantized = f32 = 0
    for b in buckets:
        chunk = b.padded_total // d
        fmt = qr.wire_format_of(b.compressor)
        legs = 1 if b.mode == "reduce_scatter" else 2
        quantized += legs * (d - 1) * qr.wire_nbytes(chunk, fmt)
        if b.mode == "reduce_scatter":
            f32 += (d - 1) * 4 * chunk
    return {"quantized": quantized, "f32_param_gather": f32,
            "f32_all_reduce_equivalent": sum(
                2 * (d - 1) * 4 * (b.padded_total // d) for b in buckets)}


def _ring_train(torch, name, builder, optimizer):
    """One configuration of the ``train_ring`` phase on this rank."""
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    from autodist_tpu_torch.ops import fused_kernels as fk

    spec = transformer_lm()
    layers = spec.config["num_layers"]
    _fresh_peak(torch)
    sess, batch = _train_session(spec, lm_params(spec), TRAIN_SHAPE["B"],
                                 builder, optimizer,
                                 numerics={"clip_norm": CLIP_NORM})
    step = sess._step
    d = sess.data_axis_size
    if d != RING_RANKS:
        raise AssertionError(f"{name}: data axis {d}, expected {RING_RANKS}")
    ring = sum(1 for a in step.bucket_algs.values() if a == "ring")
    if "quant_hop" not in step.fused_kernels or ring == 0:
        raise AssertionError(f"{name}: no quantized ring bucket "
                             f"({step.fused_kernels}, {step.bucket_algs})")
    n_buckets, n_zero1 = len(step.buckets), len(step.zero1_buckets)
    want = (layers, layers, layers, 2 * n_buckets, n_zero1, ring,
            (d - 2) * ring, ring)
    fa.reset_counts()                   # the main path starts here
    fk.fused_detect_stats.calls = fk.fused_adam_update.calls = 0
    fk.fused_quantize.calls = fk.fused_hop_accumulate.calls = 0
    fk.fused_dequant_add.calls = 0

    def counts():
        return (_flash_counts(fa.flash_attention) + _sync_counts(fk)
                + _quant_counts(fk))

    losses, step_s = [], []
    for i in range(RING_WARMUP + RING_TIMED):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.run(batch)
        torch.cuda.synchronize()
        if i >= RING_WARMUP:
            step_s.append(time.perf_counter() - t0)
        per_step = tuple(a - b for a, b in zip(counts(), before))
        if per_step != want:
            raise AssertionError(f"{name} step {i} launched (K1, K2, K3, K4,"
                                 f" K5, K6, K7, K8) = {per_step}, expected "
                                 f"{want}")
        h = out["grad_health"]
        sat = {k: float(v["sat_count"]) for k, v in h.per_bucket.items()
               if "sat_count" in v}
        if not bool(h.all_finite) or int(h.skipped_steps) != 0 \
                or len(sat) != n_buckets or any(sat.values()):
            raise AssertionError(f"{name} step {i}: all_finite "
                                 f"{bool(h.all_finite)}, skipped "
                                 f"{int(h.skipped_steps)}, saturation {sat}")
        losses.append(float(out["loss"]))
    launches = counts()                 # read just after the main path
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite losses: {losses}")
    residual = {k: v for k, v in sess.sync_state.items()
                if isinstance(v, torch.Tensor)}
    if sorted(residual) != sorted(b.key for b in step.buckets) or any(
            residual[b.key].numel() != b.padded_total for b in step.buckets):
        raise AssertionError(f"{name}: residuals do not match the plan")
    return sess, {
        "losses": losses, "ms_per_step": statistics.median(step_s) * 1e3,
        "ms_per_step_min": min(step_s) * 1e3,
        "ms_per_step_max": max(step_s) * 1e3,
        "buckets": n_buckets, "ring_buckets": ring,
        "algs": sorted(set(step.bucket_algs.values())),
        "one_shot_bucket_sizes": sorted(
            b.total for b in step.buckets
            if step.bucket_algs[b.key] != "ring"),
        "wire_bytes_per_step": _ring_wire_bytes(step.buckets,
                                                step.bucket_algs, d),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": dict(zip(("flash_fwd", "flash_dq", "flash_dkv",
                              "detect_stats", "adam_update",
                              "quant_hop_quantize", "quant_hop_accumulate",
                              "quant_hop_dequant_add"), launches)),
        "launches_per_step": list(want),
        **_params_digests(sess)}


def _ring_fused_vs_unfused(torch, sess, batch_rows, rank):
    """This rank's embedding gradient bucket through the quantized ring
    reduce-scatter with K6–K8 and unfused, both wire formats."""
    import torch.distributed as dist
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.kernel.synchronization import quant_ring as qr
    from autodist_tpu_torch.kernel.synchronization.bucketing import \
        pack_bucket
    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    spec = transformer_lm()
    bucket = next(b for b in sess._step.buckets if "embed" in b.names)
    tree = sess.device_params
    embed = tree["embed"].detach().clone().requires_grad_()
    rows = {k: torch.as_tensor(v[rank * batch_rows:(rank + 1) * batch_rows],
                               device=embed.device) for k, v in
            spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED).items()}
    (grad,) = torch.autograd.grad(spec.loss_fn(dict(tree, embed=embed), rows),
                                  embed)
    flat = dict(flatten(tree))
    vec = pack_bucket(bucket, [grad.detach() if n == "embed"
                               else torch.zeros_like(flat[n])
                               for n in bucket.names])
    group, d = dist.group.WORLD, dist.get_world_size()
    out = {"elements": vec.numel(), "chunk": vec.numel() // d}
    for fmt in (qr.WIRE_INT8, qr.WIRE_FP8_E4M3):
        fused = qr.quantized_ring_reduce_scatter(vec, group, d, fmt,
                                                 fused=True)
        plain = qr.quantized_ring_reduce_scatter(vec, group, d, fmt,
                                                 fused=False)
        torch.cuda.synchronize()
        for part, a, b in (("output", fused[0], plain[0]),
                           ("err", fused[1], plain[1])):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0,
                                       msg=f"fused vs unfused {fmt.name} "
                                           f"{part}")
        if float(fused[2]) != float(plain[2]):
            raise AssertionError(f"fused vs unfused {fmt.name}: saturation "
                                 f"{float(fused[2])} vs {float(plain[2])}")
        out[fmt.name] = {
            "max_abs_diff_output": (fused[0] - plain[0]).abs().max().item(),
            "max_abs_diff_err": (fused[1] - plain[1]).abs().max().item(),
            "sat": float(fused[2])}
    return out


def _params_digests(sess) -> dict:
    """``params_sha256``, one digest of every parameter's logical value in
    catalog order (gathered where a rank stores 1/N: every rank calls
    it), and ``param_sha256``, each parameter's own (to name the ones
    that differ when the ranks disagree)."""
    import torch

    from autodist_tpu_torch.graph_item import flatten

    digest, each = hashlib.sha256(), {}
    for pname, x in flatten(sess._step.export_params(sess.device_params,
                                                     sess.sync_state)):
        data = x.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes()
        digest.update(pname.encode())
        digest.update(data)
        each[pname] = hashlib.sha256(data).hexdigest()[:16]
    return {"params_sha256": digest.hexdigest(), "param_sha256": each}


def _ps_lb_train(torch):
    """The ``ps_lb`` configuration on this rank: ``PSLoadBalancing()`` with
    ``fusable_adam`` and clip over the 4 ranks, each holding 1/4 of every
    bucket's Adam moments and 1/4 of the sparse ``embed`` (its bucket's
    chunk, gathered at the start of each step); K1–K5 checked per step as
    in ``train_zero1``, K4/K5 on the stored bucket too.  After the last
    step: ``resident_bytes`` (``memory_allocated``), the stored chunk's
    bytes and the drop against the replicated layout, held to
    :data:`PS_LB_DROP_BYTES`."""
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import PSLoadBalancing

    spec = transformer_lm()
    _fresh_peak(torch)
    sess, batch = _train_session(spec, lm_params(spec), TRAIN_SHAPE["B"],
                                 PSLoadBalancing(), fk.fusable_adam(1e-3),
                                 numerics={"clip_norm": CLIP_NORM})
    d = sess.data_axis_size
    if d != RING_RANKS or sess._step.fused_kernels != ("guard", "update"):
        raise AssertionError(f"ps_lb: data axis {d}, kernels "
                             f"{sess._step.fused_kernels}")
    losses, norms, step_s, launches, per_step = _bucketed_steps(
        torch, sess, batch, spec.config["num_layers"], RING_WARMUP,
        RING_TIMED)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    z = sess.opt_state["zero1"]
    for b in sess.zero1_buckets:
        for m in ("mu", "nu"):
            if z[m][b.key].numel() != b.padded_total // d:
                raise AssertionError(f"ps_lb: {m} shard of {b.key} holds "
                                     f"{z[m][b.key].numel()} elements, "
                                     f"expected {b.padded_total // d}")
    stored = sess.stored_buckets
    if [b.names for b in stored] != [("embed",)]:
        raise AssertionError(f"ps_lb: stored buckets "
                             f"{[b.names for b in stored]}, expected embed")
    leaves = dict(flatten(sess.device_params))
    held = sum(leaves[n].numel() * leaves[n].element_size()
               for b in stored for n in b.names)
    logical = sum(b.total * leaves[b.names[0]].element_size()
                  for b in stored)
    if abs(logical - held - PS_LB_DROP_BYTES) > PS_LB_DROP_TOL:
        raise AssertionError(f"ps_lb: the rank holds {held} of the stored "
                             f"variables' {logical} bytes, a drop of "
                             f"{logical - held}, expected "
                             f"{PS_LB_DROP_BYTES}")
    return sess, {
        "losses": losses, "global_norms": norms,
        "ms_per_step": statistics.median(step_s) * 1e3,
        "ms_per_step_min": min(step_s) * 1e3,
        "ms_per_step_max": max(step_s) * 1e3,
        "buckets": len(sess.zero1_buckets),
        "moment_elements_per_rank": sum(b.padded_total // d
                                        for b in sess.zero1_buckets),
        "moment_elements_logical": sum(b.total for b in sess.zero1_buckets),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "resident_bytes": resident, "stored_1n_bytes": held,
        "stored_logical_bytes": logical, "drop_bytes": logical - held,
        "stored_buckets": [b.key for b in stored],
        "launches": launches, "launches_per_step": per_step,
        **_params_digests(sess)}


def _ps_lb_trace(torch, sess, rank: int):
    """One more ``ps_lb`` step on every rank, rank 0's under
    ``torch.profiler`` (CPU and CUDA): ``LegProfiler.parse_trace``'s
    samples per leg kind from the trace, where each sync leg's device
    range holds its work (the host-staged collectives' copies and the
    kernels around them), and the host ranges against them."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from autodist_tpu_torch.telemetry import LegProfiler
    from autodist_tpu_torch.telemetry.profiler import (DEVICE_RANGE,
                                                       HOST_RANGE,
                                                       span_leg_kind)

    batch = sess._last_batch
    if rank != 0:
        sess.run(batch)
        return None
    tmp = tempfile.mkdtemp(prefix="ps_lb_trace_")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sess.run(batch)
        prof.export_chrome_trace(os.path.join(tmp, "ps_lb.trace.json"))
        with open(os.path.join(tmp, "ps_lb.trace.json")) as f:
            events = json.load(f)["traceEvents"]
        samples = LegProfiler().parse_trace(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranges = {cat: sum(1 for e in events if e.get("cat") == cat
                       and span_leg_kind(str(e.get("name", ""))))
              for cat in (HOST_RANGE, DEVICE_RANGE)}
    kinds: dict = {}
    for smp in samples:
        row = kinds.setdefault(smp.kind, {"samples": 0, "device_ms": 0.0,
                                          "min_ms": None})
        row["samples"] += 1
        row["device_ms"] += smp.measured_s * 1e3
        row["min_ms"] = smp.measured_s * 1e3 if row["min_ms"] is None \
            else min(row["min_ms"], smp.measured_s * 1e3)
    return {"host_ranges": ranges[HOST_RANGE],
            "device_ranges": ranges[DEVICE_RANGE],
            "samples": len(samples), "by_kind": kinds}


def _p6_lr_control(torch) -> dict:
    """``--p6-lr-control`` on this rank: the losses of ``train_p6``'s
    model, weights and batch under ``AllReduce()`` and
    ``AllReduce(compressor="HorovodCompressor")``, with the clip and
    ``adam`` at each of :data:`P6_CONTROL_LRS`, by wire and rate."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.strategy import AllReduce

    spec = transformer_lm(num_layers=P6_LAYERS)
    out = {}
    for lr in P6_CONTROL_LRS:
        for wire, comp in (("f32", "NoneCompressor"),
                           ("bf16", "HorovodCompressor")):
            sess, batch = _train_session(
                spec, lm_params(spec), TRAIN_SHAPE["B"],
                AllReduce(compressor=comp), optim.adam(lr),
                numerics={"clip_norm": CLIP_NORM})
            out[f"{wire} lr {lr:g}"] = [float(sess.run(batch)["loss"])
                                        for _ in range(P6_CONTROL_STEPS)]
            del sess
            torch.cuda.empty_cache()
    return out


# -- the tune phase: the schedule tuner, leg cursors, tiers, implicit capture


def tune_constants():
    """The ACTIVE calibration the drill's running schedule is priced with:
    every leg kind at 45 GB/s and 5 us (the JAX package's drill,
    ``tests/test_search.py:379-466``)."""
    from autodist_tpu_torch.telemetry.calibration import (LEG_KINDS,
                                                          LegCalibration)

    cal = LegCalibration()
    for kind in LEG_KINDS:
        cal.bandwidths[kind] = 45e9
        cal.alphas[kind] = 5e-6
    cal.quant_overhead_per_byte = 0.0
    return cal


def tune_drift_samples():
    """The planted drift: all_reduce legs 20x slower than the active
    constants predict (a throttled interconnect), every other kind on its
    model, six samples per kind at 256 KiB, 1 MiB and 4 MiB."""
    from autodist_tpu_torch.telemetry.profiler import LegSample

    out = []
    for nb in (1 << 18, 1 << 20, 4 << 20):
        for kind in ("all_reduce", "reduce_scatter", "all_gather",
                     "ps_exchange", "ppermute_hop", "update", "psum_guard"):
            t = 20 * nb / 45e9 if kind == "all_reduce" else nb / 45e9 + 5e-6
            out += [LegSample(schedule_fingerprint="planted",
                              leg_id=f"{kind}/{nb}/{i}", kind=kind,
                              measured_s=t, nbytes=nb) for i in range(6)]
    return out


class _FixedBuilder:
    """A builder of one given Strategy (the drill's oracle)."""

    def __init__(self, strategy):
        self._strategy = strategy

    def build(self, graph_item, resource_spec):
        return self._strategy


def tune_prediction(device: str = "meta", chips: int = RING_RANKS) -> dict:
    """The 4-rank drill's re-search, run on ``meta`` tensors (no memory,
    no card): the winner the ScheduleTuner's ``maybe_retune`` would pick
    on a ``chips``-card spec from AllReduce after :func:`tune_drift_
    samples`.  ``python3 chip_smoke.py --tune-predict`` prints it."""
    from autodist_tpu_torch.graph_item import GraphItem
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AllReduce
    from autodist_tpu_torch.strategy.search import SearchSpace, beam_search
    from autodist_tpu_torch.telemetry.calibration import (drifted_leg_kinds,
                                                          fit_leg_constants)

    spec = transformer_lm()
    gi = GraphItem(lm_params(spec, device=device),
                   optimizer=fk.fusable_adam(1e-3), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": CLIP_NORM})
    gi.prepare()
    rs = ResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "chips": chips}], "hbm_gb": 80})
    samples = tune_drift_samples()
    reasons = drifted_leg_kinds(samples, tune_constants())
    refit = fit_leg_constants(samples)
    current = AllReduce().build(gi, rs)
    t0 = time.perf_counter()
    result = beam_search(gi, rs, axes={"data": chips},
                         space=SearchSpace(max_rounds=TUNE_SEARCH_ROUNDS),
                         constants=refit,
                         extra_seeds=[("current", current)])
    cur = next(e for e in result.evaluated if e.name == "seed:current")
    return {"chips": chips, "drifted_kinds": sorted(reasons),
            "winner": result.best.name,
            "winner_fingerprint": result.best.fingerprint,
            "winner_cost_ms": result.best.cost_s * 1e3,
            "current_fingerprint": cur.fingerprint,
            "current_cost_ms": cur.cost_s * 1e3,
            "winner_sync": sorted({n.synchronizer.kind for n in
                                   result.best_strategy.node_config}),
            "evaluated": len(result.evaluated),
            "search_s": time.perf_counter() - t0}


def _tune_ring_train(torch):
    """The ``tune_swap`` configuration on this rank (4 ranks on one card):
    ``AllReduce`` with ``fusable_adam`` and the clip at full width,
    :data:`TUNE_DRILL_STEPS` steps, the planted drift,
    ``ScheduleTuner.maybe_retune`` (only rank 0 searches; every rank
    swaps), as many steps on the winner, then an oracle session started
    on the winner's Strategy from the anchor snapshot taken at the swap
    step: its steps must give the swapped run's losses
    and parameters bit for bit.  K1–K5 each step as each schedule's IR
    predicts."""
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch.checkpoint.tiers import capture_snapshot
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AllReduce, ScheduleTuner
    from autodist_tpu_torch.strategy.search import SearchSpace

    spec = transformer_lm()
    layers = spec.config["num_layers"]
    rank = torch.distributed.get_rank()
    info = _auto_info(torch, RING_RANKS)
    kw = dict(numerics={"clip_norm": CLIP_NORM}, resource_info=info)
    _fresh_peak(torch)
    sess, batch = _train_session(spec, lm_params(spec), TRAIN_SHAPE["B"],
                                 AllReduce(), fk.fusable_adam(1e-3), **kw)
    gi = adm.get_default_autodist().graph_item
    old_fp = sess.schedule_fingerprint
    want0 = _ir_predicted_launches(sess.schedule_ir, layers)
    losses0, _, _, _ = _checked_steps(torch, "tune_swap before", sess, batch,
                                      want0, 0, TUNE_DRILL_STEPS, True)
    anchor = capture_snapshot(sess)
    step0 = sess.step_count
    tuner = ScheduleTuner(gi, ResourceSpec(resource_info=info),
                          constants=tune_constants(),
                          space=SearchSpace(max_rounds=TUNE_SEARCH_ROUNDS),
                          calibration_path=None)
    tuner.feed_samples(tune_drift_samples())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swapped = tuner.maybe_retune(sess)
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    new_fp = sess.schedule_fingerprint
    searched = tuner.last_result is not None
    if not swapped or new_fp == old_fp or sess.step_count != step0 \
            or searched != (rank == 0):
        raise AssertionError(
            f"tune_swap rank {rank}: swapped {swapped}, fingerprint "
            f"{old_fp} -> {new_fp}, step {step0} -> {sess.step_count}, "
            f"searched {searched}")
    want1 = _ir_predicted_launches(sess.schedule_ir, layers)
    losses1, _, _, launches = _checked_steps(
        torch, "tune_swap after", sess, batch, want1, 0, TUNE_DRILL_STEPS,
        True)
    digests = _params_digests(sess)
    strategy = sess._step.compiled_strategy.strategy
    out = {"from_fingerprint": old_fp, "to_fingerprint": new_fp,
           "winner": tuner.last_result.best.name if searched else None,
           "winner_sync": sorted({n.synchronizer.kind
                                  for n in strategy.node_config}),
           "searched": searched, "swap_ms": swap_s * 1e3,
           "swap_in_tuner_ms": tuner.last_swap_s * 1e3,
           "snapshot_bytes": anchor.nbytes,
           "moments_exact": tuner.last_swap_exact_opt,
           "moments_note": tuner.last_swap_note,
           "step_at_swap": step0, "losses_before": losses0,
           "losses_after": losses1, "launches_per_step_before": want0,
           "launches_per_step_after": want1, "launches": launches,
           "schedule_fingerprint": new_fp}
    del sess
    _fresh_peak(torch)
    oracle, _ = _train_session(spec, lm_params(spec), TRAIN_SHAPE["B"],
                               _FixedBuilder(strategy), fk.fusable_adam(1e-3),
                               **kw)
    tuner.adopt_snapshot(oracle, anchor, oracle._step)
    del anchor
    if oracle.schedule_fingerprint != new_fp or oracle.step_count != step0:
        raise AssertionError(f"tune_swap oracle: fingerprint "
                             f"{oracle.schedule_fingerprint}, step "
                             f"{oracle.step_count}")
    oracle_losses = [float(oracle.run(batch)["loss"])
                     for _ in range(TUNE_DRILL_STEPS)]
    oracle_digests = _params_digests(oracle)
    if oracle_losses != losses1 or \
            oracle_digests["params_sha256"] != digests["params_sha256"]:
        raise AssertionError(f"tune_swap: the oracle's losses "
                             f"{oracle_losses} / parameters differ from the "
                             f"swapped run's {losses1}")
    out.update(oracle_losses_equal=True, oracle_params_equal=True,
               **digests)
    return oracle, out


def _median_step_ms(torch, sess, batch, steps: int) -> float:
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _tune_leg_profile(torch, spec) -> dict:
    """(a) ``LegProfiler.profile_ir`` on ``train_ps``'s IR (one sample per
    leg, the median per leg kind) and ``fit_leg_constants`` on those
    samples and the session's step records."""
    from autodist_tpu_torch.telemetry.calibration import fit_leg_constants
    from autodist_tpu_torch.telemetry.profiler import LegProfiler

    _fresh_peak(torch)
    sess, batch = _telemetry_session(spec, {})
    for _ in range(3):
        sess.run(batch)
    ir = sess.schedule_ir
    t0 = time.perf_counter()
    samples = LegProfiler(mesh=sess.mesh).profile_ir(ir)
    profile_s = time.perf_counter() - t0
    if sorted(s.leg_id for s in samples) != sorted(l.id for l in ir.legs):
        raise AssertionError(f"profile_ir: {len(samples)} samples for "
                             f"{len(ir.legs)} legs")
    by_kind = {}
    for smp in samples:
        by_kind.setdefault(smp.kind, []).append(smp)
    fitted = fit_leg_constants(samples, sess.telemetry.records)
    if fitted is None:
        raise AssertionError("fit_leg_constants fitted nothing")
    out = {"legs": len(ir.legs), "samples": len(samples),
           "profile_s": profile_s,
           "median_ms_by_kind": {
               k: statistics.median(x.measured_s for x in v) * 1e3
               for k, v in sorted(by_kind.items())},
           "predicted_ms_by_kind": {
               k: statistics.median(x.predicted_s or 0.0 for x in v) * 1e3
               for k, v in sorted(by_kind.items())},
           "fitted": fitted.to_dict()}
    del sess
    return out


def _leg_cursor_row(torch, launches: int, step_cursor_ok: bool) -> dict:
    """The leg-cursor kernel held against its plain version (the host
    stamp, :func:`flightrec.record_cursor`): the same legs in the same
    order; its device time per stamp from CUDA events over a run of
    stamps, the plain version's host time per stamp."""
    from autodist_tpu_torch.ops import leg_cursor
    from autodist_tpu_torch.telemetry import flightrec as fr

    legs = [f"leg/{i}" for i in range(256)]
    dev = torch.device("cuda")
    fr.reset_for_testing()
    for leg in legs:
        leg_cursor.stamp(dev, leg)
    torch.cuda.synchronize()
    got = [c.leg for c in fr.ring().cursors()]
    fr.reset_for_testing()
    for leg in legs:
        fr.record_cursor(leg)
    plain = [c.leg for c in fr.ring().cursors()]
    fr.reset_for_testing()
    if got != plain:
        raise AssertionError("leg cursors differ from the plain stamps")
    n = 1000
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(n):
        leg_cursor.stamp(dev, "t")
    e1.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fr.record_cursor("t")
    plain_ms = (time.perf_counter() - t0) * 1e3 / n
    fr.reset_for_testing()
    bnd, by = bound_ms(16, 0)
    return {"name": "leg_cursor", "route": "cuda",
            "source": LEG_CURSOR_SOURCE, "replaces": LEG_CURSOR_REPLACES,
            "shape": {"stamps": n, "bytes_per_stamp": 16},
            "launches": launches, "max_abs_err": 0.0,
            "ms": e0.elapsed_time(e1) / n, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "step_cursors_equal_ir_legs": step_cursor_ok}


def _tune_legs(torch, spec) -> dict:
    """(b) ``train_ps`` under ``AUTODIST_FLIGHTREC=legs``: one step's leg
    cursors are the IR's stamped legs in order; ms per step with legs on
    and off (median of 10 each); the stall check: a device-side delay
    enqueued just before a chosen leg, the cursor read while the device
    waits names the leg before it, not the last one the host enqueued."""
    from autodist_tpu_torch.kernel.synchronization.explicit_sync import \
        stamped_legs
    from autodist_tpu_torch.ops import leg_cursor
    from autodist_tpu_torch.telemetry import flightrec as fr

    _fresh_peak(torch)
    sess, batch = _telemetry_session(spec, {"AUTODIST_FLIGHTREC": "legs"})
    ir = sess.schedule_ir
    want = stamped_legs(ir, [b.key for b in sess.zero1_buckets])
    sess.run(batch)                     # builds the cursor ring
    fr.reset_for_testing()
    fr.set_fingerprint(ir.fingerprint())
    leg_cursor.stamp.calls = 0
    _reset_all_counts()
    sess.run(batch)
    torch.cuda.synchronize()
    launches = leg_cursor.stamp.calls
    seen = [c for c in fr.ring().cursors() if c.kind == "leg"]
    if [c.leg for c in seen] != want or launches != len(want) or any(
            c.fingerprint != ir.fingerprint() for c in seen):
        raise AssertionError(f"leg cursors {[c.leg for c in seen]} "
                             f"({launches} launches), the IR's {want}")
    on_ms = _median_step_ms(torch, sess, batch, TUNE_LEG_STEPS)

    # the stall: a delay just before the second bucket's reduce leg
    chosen, before = want[1], want[0]
    real = fr.traced_stamp

    def delayed(leg, **kw):
        if leg == chosen:
            torch.cuda._sleep(TUNE_SLEEP_CYCLES)
        real(leg, **kw)
    seen_at = {}

    def watch():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30:
            cur = fr.latest_cursor()
            if cur is not None and cur.kind == "leg" and cur.leg == before:
                time.sleep(0.2)          # the device is inside the delay
                seen_at["device"] = fr.latest_cursor().leg
                seen_at["host"] = leg_cursor.enqueued_leg(sess.mesh.device)
                return
            time.sleep(0.002)
    fr.reset_for_testing()
    fr.traced_stamp = delayed
    watcher = threading.Thread(target=watch)
    try:
        watcher.start()
        t0 = time.perf_counter()
        sess.run(batch)
        torch.cuda.synchronize()
        stall_step_s = time.perf_counter() - t0
    finally:
        fr.traced_stamp = real
        watcher.join()
    if seen_at.get("device") != before or seen_at.get("host") in (None,
                                                                  before):
        raise AssertionError(f"stall check: while the device waited before "
                             f"{chosen}, the cursor read {seen_at}; want "
                             f"{before} (the host had enqueued further)")
    del sess
    _fresh_peak(torch)
    sess, batch = _telemetry_session(spec, {"AUTODIST_FLIGHTREC": None})
    sess.run(batch)
    off_ms = _median_step_ms(torch, sess, batch, TUNE_LEG_STEPS)
    del sess
    fr.reset_for_testing()
    return {"stamped_legs": len(want), "ir_legs": len(ir.legs),
            "cursors_equal_ir_legs": True, "launches": launches,
            "legs_on_ms_per_step": on_ms, "legs_off_ms_per_step": off_ms,
            "stall": {"delayed_before": chosen, "device_cursor":
                      seen_at["device"], "host_enqueued": seen_at["host"],
                      "step_s": stall_step_s}}


def _tune_tiers(torch, spec) -> dict:
    """(d) ``fit`` with RAM snapshots every 2 steps mirrored to a peer
    directory: 2 steps (one snapshot), then the uninterrupted
    continuation (2 more steps); a new session resumes from the RAM ring
    and another from the peer directory, each to the same losses and
    parameters bit for bit."""
    import shutil
    import tempfile

    from autodist_tpu_torch.checkpoint.saver import tree_digest
    from autodist_tpu_torch.checkpoint.tiers import CheckpointTiers

    root = tempfile.mkdtemp(prefix="tune_tiers_")
    peer = os.path.join(root, "peer")
    spe, epochs = TUNE_FIT_STEPS, TUNE_FIT_EPOCHS
    try:
        _fresh_peak(torch)
        sess, batch = _telemetry_session(spec, {})
        tiers = CheckpointTiers(sess, snapshot_every=TUNE_SNAPSHOT_EVERY,
                                peer_dir=peer)
        hist = sess.fit(batch, epochs=epochs, steps_per_epoch=spe,
                        tiers=tiers, log_every=1)
        snap = tiers.ring.latest()
        if tiers.ring.steps() != list(range(
                TUNE_SNAPSHOT_EVERY, spe * epochs + 1, TUNE_SNAPSHOT_EVERY)) \
                or snap.step != spe * epochs or \
                hist.resume_tier is not None:
            raise AssertionError(f"tiers: ring {tiers.ring.steps()}")
        out = {"snapshot_s": tiers.last_snapshot_s,
               "snapshot_bytes": snap.nbytes,
               "peer_files": sorted(os.listdir(os.path.join(peer,
                                                            tiers.host_id)))}
        ref = sess.fit(batch, epochs=1, steps_per_epoch=spe, log_every=1)
        ref_losses = ref.history["loss"]
        ref_digest = tree_digest(sess.device_params)
        del sess
        for tier in ("ram", "peer"):
            _fresh_peak(torch)
            sess, batch = _telemetry_session(spec, {})
            t = CheckpointTiers(sess, peer_dir=peer if tier == "peer"
                                else None)
            if tier == "ram":
                t.ring = tiers.ring     # this process's ring survived
            t0 = time.perf_counter()
            hist = sess.fit(batch, epochs=epochs + 1, steps_per_epoch=spe,
                            tiers=t, log_every=1)
            wall = time.perf_counter() - t0
            digest = tree_digest(sess.device_params)
            if hist.resume_tier != tier or hist.steps_run != spe or \
                    hist.history["loss"] != ref_losses or \
                    digest != ref_digest:
                raise AssertionError(
                    f"tiers: the {tier} resume ({hist.resume_tier}, "
                    f"{hist.steps_run} steps, losses {hist.history['loss']}"
                    f") differs from the uninterrupted {ref_losses}")
            out[f"{tier}_resume"] = {"losses": hist.history["loss"],
                                     "params_digest": digest,
                                     "fit_wall_s": wall, "equal": True}
            del sess
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _tune_implicit(torch, spec) -> dict:
    """(e) A plain script inside ``ad.scope()``: ``optim.adamw``, its
    ``init`` on the parameters and ``torch.func.grad_and_value`` of the
    loss, no ``capture()``; 1 + 2 steps bit for bit the explicit
    ``capture()``'s."""
    import torch.func

    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.checkpoint.saver import tree_digest

    batch = spec.sample_batch(TRAIN_SHAPE["B"], seed=SEED)
    runs = {}
    for mode in ("implicit", "explicit"):
        _fresh_peak(torch)
        ad = adm.AutoDist()
        with ad.scope():
            if mode == "implicit":
                opt = optim.adamw(1e-3)
                opt.init(lm_params(spec))
                torch.func.grad_and_value(spec.loss_fn)
            else:
                ad.capture(params=lm_params(spec),
                           optimizer=optim.adamw(1e-3), loss_fn=spec.loss_fn)
        sess = ad.create_distributed_session()
        want = _ir_predicted_launches(sess.schedule_ir,
                                      spec.config["num_layers"])
        losses, _, _, launches = _checked_steps(
            torch, f"implicit capture ({mode})", sess, batch, want, 1, 2,
            False)
        runs[mode] = {"losses": losses,
                      "params_digest": tree_digest(sess.device_params),
                      "launches": launches,
                      "optimizer_factory": ad._implicit_record
                      .optimizer_factory if mode == "implicit" else None}
        del sess, ad
    if runs["implicit"]["losses"] != runs["explicit"]["losses"] or \
            runs["implicit"]["params_digest"] != \
            runs["explicit"]["params_digest"]:
        raise AssertionError(f"implicit capture {runs['implicit']} differs "
                             f"from explicit {runs['explicit']}")
    return dict(runs, equal=True)


def phase_tune(torch, smi) -> tuple:
    """P8's second half at full width on one card: (a) the leg profile
    and the fitted constants, (b) the leg cursors, (d) the RAM and peer
    tiers, (e) implicit capture; the 4-rank swap drill (c) runs with the
    ring ranks.  The result and the leg-cursor kernel's row."""
    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    spec = transformer_lm()
    out, seconds = {"card": smi}, {}
    for name, fn in (("leg_profile", _tune_leg_profile),
                     ("leg_cursors", _tune_legs),
                     ("tiers", _tune_tiers),
                     ("implicit_capture", _tune_implicit)):
        t0 = time.perf_counter()
        out[name] = fn(torch, spec)
        seconds[name] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    legs = out["leg_cursors"]
    row = _leg_cursor_row(torch, legs["launches"],
                          legs["cursors_equal_ir_legs"])
    out["seconds"] = seconds
    return out, row


def ring_worker(rank: int, init: str, mode: str,
                elastic_dir: str = None) -> int:
    """One rank of the ``train_ring`` phase (``mode`` "smoke"), or of
    ``--p6-lr-control`` ("lr_control"): prints ``RING_RESULT`` and its
    JSON as the last line.  With ``elastic_dir``, ``ps_lb`` also writes
    the ``elastic`` phase's donor checkpoint there."""
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import AllReduce, Zero1

    os.environ.setdefault("GLOO_SOCKET_IFNAME", LOOPBACK)
    dist.init_process_group("gloo", init_method=init,
                            world_size=RING_RANKS, rank=rank)
    try:
        out = {"rank": rank, "t_s": {}}

        def stamp(name):        # each configuration's end, on this rank
            out["t_s"][name] = time.perf_counter() - T_START
        if mode == "lr_control":
            out["lr_control"] = _p6_lr_control(torch)
            print("RING_RESULT " + json.dumps(out), flush=True)
            return 0
        if mode == "tune":
            sess, out[TUNE_RING_CONFIG] = _tune_ring_train(torch)
            del sess
            print("RING_RESULT " + json.dumps(out), flush=True)
            return 0
        if mode == "seq":
            for name in SEQ_CONFIGS:
                sess, out[name] = _seq_train(torch, name)
                del sess
                torch.cuda.empty_cache()
                stamp(name)
            out["long_context"] = _long_context_twin(torch)
            stamp("long_context")
            print("RING_RESULT " + json.dumps(out), flush=True)
            return 0
        if mode == "moe":
            _moe_ring(torch, out, stamp)
            print("RING_RESULT " + json.dumps(out), flush=True)
            return 0
        if mode == "elastic":
            sess, out[PS_LB_CONFIG] = _ps_lb_train(torch)
            out[PS_LB_CONFIG]["elastic_donor"] = _ps_lb_donor(
                torch, sess, elastic_dir)
            del sess
            print("RING_RESULT " + json.dumps(out), flush=True)
            return 0
        for name, builder, opt in (
                ("int8_allreduce",
                 AllReduce(compressor="Int8Compressor", overlap="ring"),
                 optim.adam(1e-3)),
                ("fp8_zero1", Zero1(compressor="Fp8Compressor",
                                    overlap="ring"), fk.fusable_adam(1e-3))):
            sess, out[name] = _ring_train(torch, name, builder, opt)
            stamp(name)
            if name == "int8_allreduce":
                out["fused_vs_unfused"] = _ring_fused_vs_unfused(
                    torch, sess, TRAIN_SHAPE["B"] // RING_RANKS, rank)
                stamp("fused_vs_unfused")
            del sess
            torch.cuda.empty_cache()
        sess, out[PS_LB_CONFIG] = _ps_lb_train(torch)
        stamp(PS_LB_CONFIG)
        out[PS_LB_CONFIG]["trace"] = _ps_lb_trace(torch, sess, rank)
        stamp(PS_LB_CONFIG + " trace")
        if elastic_dir:
            out[PS_LB_CONFIG]["elastic_donor"] = _ps_lb_donor(
                torch, sess, elastic_dir)
            stamp(PS_LB_CONFIG + " donor")
        del sess
        torch.cuda.empty_cache()
        for name, builder, opt, accum, info, env in _p6_configs():
            sess, out[name] = _p6_train(torch, name, builder, opt(), accum,
                                        info, env)
            del sess
            torch.cuda.empty_cache()
            stamp(name)
        sess, out[AUTO_RING_CONFIG] = _auto_ring_train(torch)
        del sess
        torch.cuda.empty_cache()
        stamp(AUTO_RING_CONFIG)
        sess, out[TUNE_RING_CONFIG] = _tune_ring_train(torch)
        del sess
        torch.cuda.empty_cache()
        stamp(TUNE_RING_CONFIG)
        for name in SEQ_CONFIGS:
            sess, out[name] = _seq_train(torch, name)
            del sess
            torch.cuda.empty_cache()
            stamp(name)
        out["long_context"] = _long_context_twin(torch)
        stamp("long_context")
        _tp_ring(torch, out, stamp)
        _moe_ring(torch, out, stamp)
        _pipe_ring(torch, out, stamp)
        _serve_mesh_ring(torch, out, stamp)
        print("RING_RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _tp_ring(torch, out, stamp) -> None:
    """The model axis's ring configurations and ``flash_model`` on this
    rank, into ``out``."""
    for name in TP_CONFIGS:
        sess, out[name] = _tp_train(torch, name)
        del sess
        torch.cuda.empty_cache()
        stamp(name)
    out[FLASH_MODEL] = _flash_model(torch)
    stamp(FLASH_MODEL)


def _rendezvous() -> str:
    """A ``file://`` init method for the ring ranks, in a fresh temporary
    directory: no TCP port is picked and released before the ranks
    rendezvous (gloo's own pairs take ports the kernel assigns and
    holds)."""
    import tempfile

    return "file://" + os.path.join(tempfile.mkdtemp(prefix="ring_"),
                                    "rendezvous")


def check_ring_losses(config, losses, f32_losses) -> float:
    """Each ring step's loss against the f32 one-card run's at the same
    step, at :data:`RING_LOSS_RTOL`; returns the largest relative
    difference."""
    if len(losses) > len(f32_losses):
        raise AssertionError(f"{config}: {len(losses)} ring steps, only "
                             f"{len(f32_losses)} f32 steps to hold them to")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, f32_losses)]
    if not max(rel) <= RING_LOSS_RTOL:
        raise AssertionError(f"{config}: ring losses {losses} differ from "
                             f"the f32 run's {f32_losses} by up to "
                             f"{max(rel):.2e} (rtol {RING_LOSS_RTOL})")
    return max(rel)


class RankDivergence(AssertionError):
    """The ring ranks ended with different parameters."""


def phase_examples(torch, smi) -> dict:
    """Every twin of :data:`EXAMPLE_TWINS` in this process on the card,
    through its ``main`` (what ``python examples_torch/<twin>.py`` runs;
    its own asserts hold or the phase fails; its printout goes to stderr):
    one line per twin with its seconds, its rate where it reports one
    (items/sec of a benchmark twin, tokens/sec of the engine) and its
    kernel launches.  ``benchmark/bert.py`` must launch K1–K3 (BERT's
    default attention), the twins of :data:`EXAMPLE_DENSE` neither K1 nor
    K9."""
    import contextlib

    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    twins, total = {}, 0.0
    import tempfile

    for name, args in EXAMPLE_TWINS:
        _fresh_peak(torch)
        _reset_all_counts()
        ck = tempfile.mkdtemp(prefix="smoke_pipeline_")
        if name == "input_pipeline":         # a fresh checkpoint directory
            args = tuple(args) + ("--checkpoint-dir", ck)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            result = importlib.import_module(
                "examples_torch." + name).main(list(args))
        shutil.rmtree(ck, ignore_errors=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        total += seconds
        launches = _kernel_counts()
        if name == "benchmark.bert" and not all(
                launches[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")):
            raise AssertionError(f"examples {name}: K1–K3 launches "
                                 f"{launches}")
        if name in EXAMPLE_DENSE and (launches["flash_fwd"]
                                      or launches["paged_attention"]):
            raise AssertionError(f"examples {name}: dense attention, but "
                                 f"launches {launches}")
        rate = result if name.startswith(("benchmark.", "lm1b.")) or \
            name in ("serving_engine", "input_pipeline") else None
        twins[name] = {"seconds": seconds, "rate": rate,
                       "launches": {k: v for k, v in launches.items() if v},
                       "peak_bytes": torch.cuda.max_memory_allocated()}
        emit({"phase": "examples", "twin": name, "card": smi,
              "args": list(args), **twins[name]})
    _fresh_peak(torch)
    return {"twins": twins, "seconds": total}


def phase_train_ring(mode: str = "smoke", elastic_dir: str = None):
    """Start the 4 ring ranks on the card, wait for them, check they agree
    and report rank 0's numbers (every rank's parameters must hash the
    same); ``mode`` "lr_control" runs ``--p6-lr-control``'s ranks;
    ``elastic_dir`` receives ``ps_lb``'s donor checkpoint."""
    init = _rendezvous()
    cmd = [sys.executable, os.path.abspath(__file__), "--ring-init", init,
           "--ring-mode", mode] + (["--elastic-dir", elastic_dir]
                                   if elastic_dir else []) + ["--ring-rank"]
    env = dict(os.environ, GLOO_SOCKET_IFNAME=LOOPBACK)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(RING_RANKS)]
    logs = [None] * RING_RANKS

    def wait(r):
        try:
            logs[r] = procs[r].communicate(timeout=RING_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            procs[r].kill()
            logs[r] = procs[r].communicate()
    threads = [threading.Thread(target=wait, args=(r,))
               for r in range(RING_RANKS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for p in procs:                     # one failed rank strands the rest
        if p.poll() is None:
            p.kill()
    shutil.rmtree(os.path.dirname(init[len("file://"):]), ignore_errors=True)
    results = []
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, logs)):
        last = (stdout or "").strip().splitlines()[-1:]
        if p.returncode != 0 or not last or \
                not last[0].startswith("RING_RESULT "):
            raise RuntimeError(f"ring rank {r} failed (exit {p.returncode}):"
                               f"\n{(stdout or '')[-2000:]}\n"
                               f"{(stderr or '')[-4000:]}")
        results.append(json.loads(last[0][len("RING_RESULT "):]))
    wall = time.perf_counter() - t0
    if mode == "tune":
        _check_rank_results(results, (TUNE_RING_CONFIG,))
        return results[0], wall, None
    if mode == "seq":
        _check_rank_results(results, SEQ_CONFIGS)
        return results[0], wall, None
    if mode == "moe":
        _check_rank_results(results, (MOE_EP,))
        return results[0], wall, None
    if mode != "smoke":
        return results[0], wall, None
    # the engines' meshes are checked on every rank's tokens
    results[0]["serve_mesh_ranks"] = [
        {n: res[n] for n in (SERVE_TP, SERVE_SLOTS)} for res in results]
    _check_rank_results(results, RING_CONFIGS + (PS_LB_CONFIG,) + P6_CONFIGS
                        + (AUTO_RING_CONFIG, TUNE_RING_CONFIG) + SEQ_CONFIGS
                        + TP_CONFIGS + (MOE_EP,) + PIPE_CONFIGS)
    return results[0], wall, [res["fused_vs_unfused"] for res in results]


def _check_rank_results(results, configs) -> None:
    """Every rank's parameters hash the same after each configuration, and
    every rank launched the same; the search configurations end on one
    schedule fingerprint, and only rank 0 searched the tuner's drill."""
    for config in configs:
        digests = {res[config]["params_sha256"] for res in results}
        if len(digests) != 1:
            each = [res[config]["param_sha256"] for res in results]
            differ = [n for n in each[0]
                      if len({e[n] for e in each}) > 1]
            raise RankDivergence(
                f"{config}: ranks' parameters differ ({len(digests)} "
                f"digests; {len(differ)} of {len(each[0])} parameters, "
                f"first {differ[:8]}; rank groups of the first "
                f"{[e[differ[0]] for e in each] if differ else None})")
        for res in results:
            del res[config]["param_sha256"]     # kept out of the report
        for res in results[1:]:
            if res[config]["launches"] != results[0][config]["launches"]:
                raise AssertionError(f"{config}: ranks launched "
                                     f"differently")
    for config in {AUTO_RING_CONFIG, TUNE_RING_CONFIG, *TP_CONFIGS,
                   MOE_EP, *PIPE_CONFIGS} & set(configs):
        fps = [res[config]["schedule_fingerprint"] for res in results]
        if len(set(fps)) != 1:
            raise AssertionError(f"{config}: schedule fingerprints by rank "
                                 f"{fps}")
    if PIPE_GPIPE in configs and len({
            json.dumps(res[PIPE_TWIN]["losses"]) for res in results}) != 1:
        raise AssertionError(f"{PIPE_TWIN}: the ranks' losses differ")
    if TUNE_RING_CONFIG in configs and [
            res[TUNE_RING_CONFIG]["searched"] for res in results] != [
                True] + [False] * (len(results) - 1):
        raise AssertionError(f"{TUNE_RING_CONFIG}: not rank 0 alone "
                             f"searched")


def phase_flash_bert(torch, timer):
    """K1–K3 at BERT-base's training shape, non-causal: held against their
    plain versions at the flash tolerances, then timed as
    :func:`phase_flash` times the causal shape (SDPA with
    ``is_causal=False``).  Rows by kernel name."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

    gen = torch.Generator().manual_seed(SEED + 6)
    b, t, h, d = (BERT_SHAPE[x] for x in "BTHD")
    e, bwd = _flash_case(torch, fa, gen, b, t, h, d, False)
    errs = {"flash_fwd": max(e["o"], e["lse"]), "flash_dq": e["dq"],
            "flash_dkv": max(e["dk"], e["dv"])}
    emit({"phase": "flash_check", "shape": [b, t, h, d], "causal": False,
          "q_mul": 1.0, "max_abs_err": e})
    return {row["name"]: row for row in _flash_rows(
        torch, timer, bwd, dict(BERT_SHAPE, causal=False), errs)}


def phase_flash_long(torch, timer):
    """K1–K3 at D = 32, the ``long_context`` twin's block on one ring rank
    (:data:`LONG_SHAPE`): held against their plain versions causal (the
    diagonal block) and not (the shifted blocks) at the flash tolerances,
    then timed non-causal as :func:`phase_flash` times its shape.  Rows
    by kernel name."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

    gen = torch.Generator().manual_seed(SEED + 7)
    b, t, h, d = (LONG_SHAPE[x] for x in "BTHD")
    errs = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for causal in (True, False):
        e, bwd = _flash_case(torch, fa, gen, b, t, h, d, causal)
        errs["flash_fwd"] = max(errs["flash_fwd"], e["o"], e["lse"])
        errs["flash_dq"] = max(errs["flash_dq"], e["dq"])
        errs["flash_dkv"] = max(errs["flash_dkv"], e["dk"], e["dv"])
        emit({"phase": "flash_check", "shape": [b, t, h, d],
              "causal": causal, "q_mul": 1.0, "max_abs_err": e})
    return {row["name"]: row for row in _flash_rows(
        torch, timer, bwd, dict(LONG_SHAPE, causal=False), errs)}


def phase_sync_lm1b_bucket(torch, timer):
    """K4 and K5 at one of lm1b's tables (406,257,664 elements), the
    largest bucket of any phase: K4's count exactly and its sum at rtol
    1e-6 of an f64 sum, K5's step at atol 1e-6 of the plain version; then
    their times, the plain versions' and the library calls'."""
    from autodist_tpu_torch.ops import fused_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    dev = torch.device("cuda")
    n = LM1B_TABLE
    spec = fk.AdamSpec(lr=1e-3)
    x = torch.randn(n, generator=gen, device=dev)
    nf, sq = fk.fused_detect_stats(x)
    want = float((x.double() ** 2).sum())
    if float(nf) != 0.0 or not abs(float(sq) - want) <= 1e-6 * want:
        raise AssertionError(f"K4 at n={n}: ({float(nf)}, {float(sq)}), "
                             f"want (0, {want})")
    y = x.clone()
    y[n - 1] = float("nan")
    if float(fk.fused_detect_stats(y)[0]) != 1.0:
        raise AssertionError(f"K4 at n={n} missed a NaN in the last element")
    del y
    p, g, m = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    v = torch.rand(n, generator=gen, device=dev)
    scalars = fk.adam_scalars(torch.tensor(3, dtype=torch.int32, device=dev),
                              spec, torch.tensor(0.5, device=dev))
    got = fk.fused_adam_update(p, g, m, v, scalars, spec)
    ref = fk.fused_adam_update_reference(p, g, m, v, scalars, spec)
    adam_err = 0.0
    for part, a, r in zip("pmv", got, ref):
        torch.testing.assert_close(a, r, atol=1e-6, rtol=0,
                                   msg=f"K5 {part} at n={n}")
        adam_err = max(adam_err, (a - r).abs().max().item())
    del got, ref
    steps = [torch.tensor(4.0, device=dev)]
    one = torch.ones((), device=dev)
    rows = {
        "detect_stats": {
            "n": n, "rel_err_vs_f64": abs(float(sq) - want) / want,
            "ms": timer(lambda: fk.fused_detect_stats(x), iters=20),
            "plain_ms": timer(lambda: fk.fused_detect_stats_reference(x),
                              iters=20),
            "library_ms": timer(lambda: torch.linalg.vector_norm(x),
                                iters=20)},
        "adam_update": {
            "n": n, "max_abs_err": adam_err,
            "ms": timer(lambda: fk.fused_adam_update(p, g, m, v, scalars,
                                                     spec), iters=20),
            "plain_ms": timer(lambda: fk.fused_adam_update_reference(
                p, g, m, v, scalars, spec), iters=20),
            "library_ms": timer(lambda: torch._fused_adam_(
                [p], [g], [m], [v], [], steps, lr=1e-3, beta1=0.9,
                beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                maximize=False, grad_scale=one), iters=20)}}
    for name, nbytes, ops in (("detect_stats", 4.0 * n, 2.0 * n),
                              ("adam_update", 28.0 * n, 15.0 * n)):
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound_ms(nbytes, ops)
        emit({"phase": "kernel_lm1b_bucket", "name": name, **rows[name]})
    del x, p, g, m, v
    torch.cuda.empty_cache()
    return rows


def _model_session(torch, spec, builder, optimizer, numerics=None,
                   rows=MODEL_BATCH):
    """The facade's session of a BASELINE model at its defaults (weights
    from ``SEED``, drawn on the host so the card holds one copy), its
    batch of ``rows`` and the parameter shapes of the init tree; the
    peak-memory counter starts here."""
    from autodist_tpu_torch.graph_item import flatten

    params = spec.init(SEED, device="cpu")
    shapes = {n: tuple(x.shape) for n, x in flatten(params)}
    _fresh_peak(torch)
    sess, batch = _train_session(spec, params, rows, builder,
                                 optimizer, numerics=numerics)
    return sess, batch, shapes


def _model_out(torch, name, sess, shapes, losses, step_s, launches, want,
               items_per_step, flops, rows=MODEL_BATCH) -> dict:
    """The phase's report, after checking ``session.params``' shapes
    against the init tree."""
    from autodist_tpu_torch.graph_item import flatten

    got = {n: tuple(x.shape) for n, x in flatten(sess.device_params)}
    if got != shapes:
        raise AssertionError(f"{name}: session.params differ from the init "
                             f"tree")
    step = statistics.median(step_s)
    return {"batch": rows, "losses": losses,
            "ms_per_step": step * 1e3, "ms_per_step_min": min(step_s) * 1e3,
            "ms_per_step_max": max(step_s) * 1e3,
            "items_per_s": items_per_step / step,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "model_tflop_per_step": flops["total"] / 1e12,
            "model_tflop_split": {k: v / 1e12 for k, v in flops.items()},
            "mfu_f32": flops["total"] / step / H100_F32_FLOPS,
            "launches": launches, "launches_per_step": want}


def _session_flops(sess, flops) -> dict:
    """``sess.mfu()`` (its step-time window, the card's bf16 peak) and
    ``sess.flops_per_step()`` (``FlopCounterMode``'s count of one forward
    and backward) beside the written-out count ``flops``."""
    mfu = sess.mfu()
    counted = sess.flops_per_step()
    return {"session_mfu_bf16_peak": mfu, "session_flops_per_step": counted,
            "session_flops_over_written_count":
                None if counted is None else counted / flops["total"]}


def _device_split(prof, ms_per_step) -> dict:
    """``profile_train.profile_steps``' numbers: busy ms, the idle share
    at the median step, kernels and device ms per kernel group."""
    return {"device_busy_ms_per_step": prof["busy_us"] / 1e3,
            "device_idle_share": 1.0 - prof["busy_us"] / 1e3 / ms_per_step,
            "kernels_per_step": prof["kernels"],
            "device_ms_per_step": prof["device_ms"],
            "launches_per_step_by_group": prof["launches"]}


def resnet_flops(stage_sizes, num_classes: int, image_size: int,
                 batch: int) -> dict:
    """Model FLOPs of one ResNet training step, by
    :func:`model_flops_per_step`'s convention (forward, input and weight
    gradients): each conv ``2·H_out·W_out·kh·kw·C_in·C_out`` per image,
    three times, but twice for the stem (the images take no gradient);
    the head ``2·in·out`` three times.  Norms, pools and activations are
    not counted."""
    def out(size, stride):
        return -(-size // stride)

    h = out(image_size, 2)
    stem = 2.0 * h * h * 7 * 7 * 3 * 64
    h = out(h, 2)                              # the 3x3/s2 max pool
    c, convs = 64, 0.0
    for i, blocks in enumerate(stage_sizes):
        f = 64 * 2 ** i
        for j in range(blocks):
            s = 2 if i > 0 and j == 0 else 1
            h2 = out(h, s)
            convs += 2.0 * h * h * c * f + 2.0 * h2 * h2 * 9 * f * f \
                + 2.0 * h2 * h2 * f * 4 * f
            if j == 0:
                convs += 2.0 * h2 * h2 * c * 4 * f
            h, c = h2, 4 * f
    head = 2.0 * c * num_classes
    split = {"stem": 2 * stem * batch, "convs": 3 * convs * batch,
             "head": 3 * head * batch}
    return dict(split, total=sum(split.values()))


def vgg_flops(num_classes: int, image_size: int, batch: int) -> dict:
    """Model FLOPs of one VGG16 training step, by
    :func:`resnet_flops`' convention (the first conv twice, the rest and
    the three dense layers three times)."""
    from autodist_tpu_torch.models.vgg import _CFG16

    h, c, first, convs = image_size, 3, 0.0, 0.0
    for v in _CFG16:
        if v == "M":
            h //= 2
            continue
        f = 2.0 * h * h * 9 * c * v
        if c == 3:
            first = f
        else:
            convs += f
        c = v
    dense = 2.0 * (h * h * c * 4096 + 4096 * 4096 + 4096 * num_classes)
    split = {"first_conv": 2 * first * batch, "convs": 3 * convs * batch,
             "dense": 3 * dense * batch}
    return dict(split, total=sum(split.values()))


def bert_flops(cfg, batch: int) -> dict:
    """Model FLOPs of one BERT training step, by
    :func:`model_flops_per_step`'s convention: 6 per token and weight of
    every projection, ``mlm_transform`` and the tied decoder, plus the nine
    T x T x D products the flash kernels do per layer (two forward, three
    in dQ, four in dK/dV, the backward recomputing S) over every (query,
    key) pair: attention is not causal."""
    d = cfg["num_heads"] * cfg["head_dim"]
    t = cfg["seq_len"]
    weights = cfg["num_layers"] * (4 * d * d + 2 * d * cfg["d_ff"]) \
        + d * d + cfg["vocab_size"] * d
    dense = 6.0 * weights * batch * t
    attn = 9 * 2.0 * batch * cfg["num_heads"] * t * t * cfg["head_dim"] \
        * cfg["num_layers"]
    return {"projections_and_head": dense, "attention": attn,
            "total": dense + attn}


def lm1b_flops(cfg, batch: int) -> dict:
    """Model FLOPs of one lm1b training step, by
    :func:`model_flops_per_step`'s convention: the LSTM's four gate
    products per step (input ``[in, 4H]`` and recurrent ``[H, 4H]``) and
    the projection, three times each; the chunked loss's ``h @ Wᵀ`` over
    the whole vocabulary four times (the forward, the backward's
    recompute, ``dh`` and ``dW``) for the ``T - 1`` predicted positions."""
    e, hid, t = cfg["emb_dim"], cfg["hidden_dim"], cfg["seq_len"]
    n = batch * t
    lstm, width = 0.0, e
    for _ in range(cfg["num_layers"]):
        lstm += 2.0 * n * width * 4 * hid + 2.0 * n * hid * 4 * hid
        width = hid
    proj = 2.0 * n * hid * e
    loss = 4 * 2.0 * batch * (t - 1) * cfg["vocab_size"] * e
    split = {"lstm": 3 * lstm, "proj": 3 * proj, "chunked_loss": loss}
    return dict(split, total=sum(split.values()))


def ncf_flops(mf_dim: int, mlp_dims, batch: int) -> dict:
    """Model FLOPs of one NCF training step: 6 per sample and weight of
    the MLP's dense layers and ``prediction`` (forward, input and weight
    gradients: the first layer's input is the tables' rows, which take a
    gradient).  The gathers and the GMF product are not counted."""
    weights, width = 0, mlp_dims[0]
    for d in mlp_dims[1:]:
        weights += width * d
        width = d
    weights += width + mf_dim
    return {"dense": 6.0 * weights * batch, "total": 6.0 * weights * batch}


def densenet_flops(block_sizes, growth: int, num_classes: int,
                   image_size: int, batch: int) -> dict:
    """Model FLOPs of one DenseNet training step, by :func:`resnet_flops`'
    convention: ``conv_init`` (7x7/s2, SAME) twice, every other conv and
    the head three times; each dense layer a 1x1 conv to ``4·growth`` and
    a 3x3 conv to ``growth``, each transition a 1x1 conv halving the
    channels before the 2x2 pool."""
    h = -(-image_size // 2)
    stem = 2.0 * h * h * 7 * 7 * 3 * 2 * growth
    h, c, convs = -(-h // 2), 2 * growth, 0.0
    for i, n in enumerate(block_sizes):
        for _ in range(n):
            convs += 2.0 * h * h * (c * 4 * growth + 9 * 4 * growth * growth)
            c += growth
        if i != len(block_sizes) - 1:
            convs += 2.0 * h * h * c * (c // 2)
            h, c = h // 2, c // 2
    head = 2.0 * c * num_classes
    split = {"stem": 2 * stem * batch, "convs": 3 * convs * batch,
             "head": 3 * head * batch}
    return dict(split, total=sum(split.values()))


def inception_flops(num_classes: int, image_size: int, batch: int) -> dict:
    """Model FLOPs of one InceptionV3 training step, by
    :func:`resnet_flops`' convention (``stem1`` twice, every other conv and
    the head three times), each conv's ``2·H_out·W_out·kh·kw·C_in·C_out``
    taken from the model's own block structure walked on a ``meta``
    image."""
    import torch

    from autodist_tpu_torch.models.inception import VALID, InceptionV3
    from autodist_tpu_torch.models.resnet import conv

    per_conv = []

    def count(p, name, x, filters, kernel, stride=1, valid=False):
        kh, kw = kernel
        y = conv(x, torch.empty((kh, kw, x.shape[1], filters),
                                device="meta"), stride,
                 VALID if valid else None)
        per_conv.append(2.0 * y.shape[2] * y.shape[3] * kh * kw
                        * x.shape[1] * filters)
        return y

    x = InceptionV3._features(count, {}, torch.empty(
        (1, 3, image_size, image_size), device="meta"))
    head = 2.0 * x.shape[1] * num_classes
    split = {"stem": 2 * per_conv[0] * batch,
             "convs": 3 * sum(per_conv[1:]) * batch,
             "head": 3 * head * batch}
    return dict(split, total=sum(split.values()))


def phase_train_resnet50(torch):
    """``resnet50()`` at 224x224 through the facade with ``AllReduce()``
    and ``sgd(1e-3, momentum=0.9)``: no Pallas kernel's twin runs (K1–K5
    zero), cuDNN's share of device time from ``profile_train``'s
    profile."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch import profile_train
    from autodist_tpu_torch.models import resnet50
    from autodist_tpu_torch.strategy import AllReduce

    spec = resnet50()
    sess, batch, shapes = _model_session(torch, spec, AllReduce(),
                                         optim.sgd(1e-3, momentum=0.9))
    want = dict.fromkeys(_kernel_counts(), 0)
    losses, _, step_s, launches = _checked_steps(
        torch, "train_resnet50", sess, batch, want, MODEL_WARMUP, MODEL_TIMED,
        guarded=False)
    out = _model_out(torch, "train_resnet50", sess, shapes, losses, step_s,
                     launches, want, MODEL_BATCH,
                     resnet_flops([3, 4, 6, 3], 1000, 224, MODEL_BATCH))
    prof = profile_train.profile_steps(sess, batch)
    total = sum(prof["device_ms"].values())
    out.update(images_per_s=out.pop("items_per_s"),
               **_device_split(prof, out["ms_per_step"]),
               cudnn_share_of_device_time=prof["device_ms"].get(
                   "cudnn_conv", 0.0) / total)
    del sess
    torch.cuda.empty_cache()
    return out


def phase_train_vgg16(torch):
    """``vgg16()`` at 224x224 with ``PartitionedPS()``, ``sgd(1e-3,
    momentum=0.9)`` and the clip: every variable in a reduce-scatter
    bucket, ``fc1`` in one of its own, K4 twice per bucket per step, no
    K5 (the step warns that the shards take the unfused update)."""
    import warnings

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models import vgg16
    from autodist_tpu_torch.strategy import PartitionedPS

    spec = vgg16()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sess, batch, shapes = _model_session(
            torch, spec, PartitionedPS(), optim.sgd(1e-3, momentum=0.9),
            {"clip_norm": CLIP_NORM})
    if not any("the ZeRO-1 shards take the unfused update" in str(w.message)
               and "fusable_adam" in str(w.message) for w in caught):
        raise AssertionError("train_vgg16: no warning that the shards take "
                             "the unfused update")
    step = sess._step
    if step.fused_kernels != ("guard",) or \
            ("fc1/kernel",) not in [b.names for b in sess.zero1_buckets]:
        raise AssertionError(f"train_vgg16: kernels {step.fused_kernels}, "
                             f"buckets {[b.names for b in step.buckets]}")
    want = dict.fromkeys(_kernel_counts(), 0)
    want["detect_stats"] = 2 * len(step.buckets)
    losses, _, step_s, launches = _checked_steps(
        torch, "train_vgg16", sess, batch, want, MODEL_WARMUP, MODEL_TIMED,
        guarded=True)
    out = _model_out(torch, "train_vgg16", sess, shapes, losses, step_s,
                     launches, want, MODEL_BATCH,
                     vgg_flops(1000, 224, MODEL_BATCH))
    out.update(images_per_s=out.pop("items_per_s"),
               buckets=len(step.buckets),
               reduce_scatter_buckets=len(sess.zero1_buckets),
               fc1_bucket_elements=25088 * 4096)
    del sess
    torch.cuda.empty_cache()
    return out


def phase_train_bert(torch):
    """``bert_base()`` at seq 128 with ``PartitionedAR()`` and
    ``adamw(1e-3)``: K1/K2/K3 non-causal, 12 each per step, 12/0/0 in
    ``evaluate``."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models import bert_base
    from autodist_tpu_torch.strategy import PartitionedAR

    spec = bert_base()
    layers = spec.config["num_layers"]
    sess, batch, shapes = _model_session(torch, spec, PartitionedAR(),
                                         optim.adamw(1e-3))
    want = dict.fromkeys(_kernel_counts(), 0)
    want.update(flash_fwd=layers, flash_dq=layers, flash_dkv=layers)
    losses, _, step_s, launches = _checked_steps(
        torch, "train_bert", sess, batch, want, MODEL_WARMUP, MODEL_TIMED,
        guarded=False)
    before = _kernel_counts()
    ev = sess.evaluate(batch)
    ev_launches = {k: v - before[k] for k, v in _kernel_counts().items()}
    if ev_launches != dict(want, flash_dq=0, flash_dkv=0) or \
            not np.isfinite(float(ev["loss"])):
        raise AssertionError(f"train_bert evaluate: launched {ev_launches},"
                             f" loss {ev['loss']}")
    out = _model_out(torch, "train_bert", sess, shapes, losses, step_s,
                     launches, want, MODEL_BATCH,
                     bert_flops(spec.config, MODEL_BATCH))
    out.update(sequences_per_s=out.pop("items_per_s"),
               tokens_per_s=MODEL_BATCH * spec.config["seq_len"]
               / statistics.median(step_s), layers=layers,
               seq_len=spec.config["seq_len"],
               eval_loss=float(ev["loss"]), eval_launches=ev_launches)
    del sess
    torch.cuda.empty_cache()
    return out


def phase_train_bert_parity(torch):
    """A depth-2 copy of ``bert_base()``: 3 ``PartitionedAR`` + adamw steps
    with the flash kernels and with dense attention from the same weights,
    losses at ``BERT_PARITY_RTOL``."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models import bert_base
    from autodist_tpu_torch.models.transformer import dense_attention
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    from autodist_tpu_torch.strategy import PartitionedAR

    flash_spec = bert_base(num_layers=2)
    dense_spec = bert_base(num_layers=2, attn_fn=dense_attention)
    params = flash_spec.init(SEED, device="cpu")
    out = {}
    for name, spec in (("flash", flash_spec), ("dense", dense_spec)):
        sess, batch = _train_session(spec, params, MODEL_BATCH,
                                     PartitionedAR(), optim.adamw(1e-3))
        before = _flash_counts(fa.flash_attention)
        out[name] = [float(sess.run(batch)["loss"]) for _ in range(3)]
        launched = tuple(a - b for a, b in
                         zip(_flash_counts(fa.flash_attention), before))
        want = (6, 6, 6) if name == "flash" else (0, 0, 0)
        if launched != want:
            raise AssertionError(f"BERT {name} run launched (K1, K2, K3) = "
                                 f"{launched}, expected {want}")
        del sess
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["flash"], out["dense"]))
    if not rel <= BERT_PARITY_RTOL:
        raise AssertionError(f"BERT flash vs dense losses differ (rel "
                             f"{rel:.2e}): {out}")
    torch.cuda.empty_cache()
    return {"layers": 2, "flash_losses": out["flash"],
            "dense_losses": out["dense"], "max_rel_diff": rel,
            "rtol": BERT_PARITY_RTOL}


def phase_train_lm1b(torch):
    """``lm1b()`` (vocabulary 793472, the chunked exact loss) with
    ``Parallax()``, ``fusable_adam(1e-3)`` and the clip: each table in a
    reduce-scatter bucket of its own (K5 twice per step on 406 M
    elements), every other variable in all-reduce buckets, K4 twice per
    bucket; peak memory under ``LM1B_PEAK_BYTES``."""
    from autodist_tpu_torch.models import lm1b
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import Parallax

    spec = lm1b()
    sess, batch, shapes = _model_session(torch, spec, Parallax(),
                                         fk.fusable_adam(1e-3),
                                         {"clip_norm": CLIP_NORM})
    step = sess._step
    rs = sorted(b.names for b in sess.zero1_buckets)
    ar = {n for b in step.buckets if b.mode == "all_reduce" for n in b.names}
    if rs != [("embedding",), ("softmax_embedding",)] or \
            ar != set(step.trainable) - {"embedding", "softmax_embedding"} \
            or step.fused_kernels != ("guard", "update"):
        raise AssertionError(f"train_lm1b: reduce-scatter {rs}, all-reduce "
                             f"{sorted(ar)}, kernels {step.fused_kernels}")
    want = dict.fromkeys(_kernel_counts(), 0)
    want.update(detect_stats=2 * len(step.buckets), adam_update=2)
    losses, _, step_s, launches = _checked_steps(
        torch, "train_lm1b", sess, batch, want, MODEL_WARMUP, MODEL_TIMED,
        guarded=True)
    out = _model_out(torch, "train_lm1b", sess, shapes, losses, step_s,
                     launches, want, MODEL_BATCH * spec.config["seq_len"],
                     lm1b_flops(spec.config, MODEL_BATCH))
    if not out["max_memory_allocated"] < LM1B_PEAK_BYTES:
        raise AssertionError(f"train_lm1b: peak memory "
                             f"{out['max_memory_allocated']} bytes, "
                             f"predicted under {LM1B_PEAK_BYTES:.0f}")
    out.update(words_per_s=out.pop("items_per_s"),
               buckets=len(step.buckets),
               reduce_scatter_bucket_elements=[b.total for b in
                                               sess.zero1_buckets],
               peak_bytes_limit=LM1B_PEAK_BYTES)
    del sess
    torch.cuda.empty_cache()
    return out


def phase_train_ncf(torch):
    """``ncf()`` at its defaults (138496 users, 26752 items, 31.7 M table
    elements) at BASELINE's batch of ``NCF_BATCH`` under
    ``PSLoadBalancing()`` with ``fusable_adam(1e-3)`` and the clip: every
    variable on PS, the plan the CPU test pins (``NCF_BUCKETS`` buckets,
    ``NCF_PLAN_SHA256``), K4 twice and K5 once per bucket per step and no
    other kernel; losses finite and falling; the device split and idle
    share from ``profile_train``'s profile."""
    from autodist_tpu_torch import profile_train
    from autodist_tpu_torch.models import ncf
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import PSLoadBalancing

    spec = ncf()
    sess, batch, shapes = _model_session(
        torch, spec, PSLoadBalancing(), fk.fusable_adam(1e-3),
        {"clip_norm": CLIP_NORM}, rows=NCF_BATCH)
    step = sess._step
    digest = _plan_digest(step.buckets)
    if step.fused_kernels != ("guard", "update") \
            or len(sess.zero1_buckets) != NCF_BUCKETS \
            or digest != NCF_PLAN_SHA256:
        raise AssertionError(f"train_ncf: kernels {step.fused_kernels}, "
                             f"buckets {[b.names for b in step.buckets]}, "
                             f"plan {digest}")
    want = dict.fromkeys(_kernel_counts(), 0)
    want.update(detect_stats=2 * len(step.buckets),
                adam_update=len(sess.zero1_buckets))
    losses, _, step_s, launches = _checked_steps(
        torch, "train_ncf", sess, batch, want, MODEL_WARMUP, MODEL_TIMED,
        guarded=True)
    _check_falling(losses)
    flops = ncf_flops(64, (256, 256, 128, 64), NCF_BATCH)
    out = _model_out(torch, "train_ncf", sess, shapes, losses, step_s,
                     launches, want, NCF_BATCH, flops, rows=NCF_BATCH)
    elements = sum(b.padded_total for b in sess.zero1_buckets)
    out.update(samples_per_s=out.pop("items_per_s"),
               buckets=len(step.buckets), bucket_plan_sha256=digest,
               bucket_elements=elements,
               bound_ms_per_step={
                   "detect_stats": bound_ms(8.0 * elements,
                                            4.0 * elements)[0],
                   "adam_update": bound_ms(28.0 * elements,
                                           15.0 * elements)[0]},
               **_session_flops(sess, flops),
               **_device_split(profile_train.profile_steps(sess, batch),
                               out["ms_per_step"]))
    del sess
    torch.cuda.empty_cache()
    return out


def _image_phase(torch, name, spec, flops) -> dict:
    """An image model at batch ``MODEL_BATCH`` as ``imagenet.py`` runs it by
    default: ``AllReduce()`` and ``sgd(1e-3, momentum=0.9)``; no kernel of
    K1–K10 may launch; the device split and idle share from
    ``profile_train``'s profile."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch import profile_train
    from autodist_tpu_torch.strategy import AllReduce

    sess, batch, shapes = _model_session(torch, spec, AllReduce(),
                                         optim.sgd(1e-3, momentum=0.9))
    want = dict.fromkeys(_kernel_counts(), 0)
    losses, _, step_s, launches = _checked_steps(
        torch, name, sess, batch, want, MODEL_WARMUP, MODEL_TIMED,
        guarded=False)
    out = _model_out(torch, name, sess, shapes, losses, step_s, launches,
                     want, MODEL_BATCH, flops)
    out.update(images_per_s=out.pop("items_per_s"),
               image_size=spec.config["image_size"],
               **_session_flops(sess, flops),
               **_device_split(profile_train.profile_steps(sess, batch),
                               out["ms_per_step"]))
    del sess
    torch.cuda.empty_cache()
    return out


def phase_train_densenet121(torch):
    """``densenet121()`` at 224x224 (:func:`_image_phase`)."""
    from autodist_tpu_torch.models import densenet121

    return _image_phase(torch, "train_densenet121", densenet121(),
                        densenet_flops([6, 12, 24, 16], 32, 1000, 224,
                                       MODEL_BATCH))


def phase_train_inception_v3(torch):
    """``inception_v3()`` at 299x299 (:func:`_image_phase`)."""
    from autodist_tpu_torch.models import inception_v3

    return _image_phase(torch, "train_inception_v3", inception_v3(),
                        inception_flops(1000, 299, MODEL_BATCH))


# -- resilience: chaos, heartbeats, the Supervisor (one card) ---------------

def _resilience_session(spec, env=None, numerics=None):
    """``train_ps``'s program (``AutoDist()``'s default, ``fusable_adam``,
    the clip) with the rollback policy and the spike detector, built with
    the environment ``env`` (``AUTODIST_CHAOS`` is read when the step is
    built); the session and the batch."""
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.strategy import PSLoadBalancing

    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        os.environ.pop(k, None) if v is None else os.environ.update({k: v})
    try:
        return _train_session(
            spec, lm_params(spec), TRAIN_SHAPE["B"], PSLoadBalancing(),
            fk.fusable_adam(1e-3), numerics=numerics or {
                "clip_norm": CLIP_NORM, "on_nonfinite": "rollback",
                "spike_zscore": RES_SPIKE_ZSCORE,
                "rollback_after": FIT_ROLLBACK_AFTER})
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.update(
                {k: v})


def _resilience_guard(torch, spec) -> dict:
    """(a) The guard drill: a clean run; the same program under
    ``nan_grad@step=2,bucket=<first bucket>`` (K4 flags step 2, which is
    skipped with the parameters bit-identical; steps 0–1 and 3 equal the
    clean run's 0–1 and 2); ``loss_spike@step=9`` in ``fit`` (one
    rollback to step 5, replayed to the clean run's step-10 parameters
    bit for bit)."""
    import tempfile

    from autodist_tpu_torch.kernel.synchronization.explicit_sync import \
        leg_stamp_points

    layers = spec.config["num_layers"]
    clean, batch = _resilience_session(spec)
    key = clean.zero1_buckets[0].key
    reduce_leg = leg_stamp_points(clean.schedule_ir)["reduce"][key][0]
    clean_losses, clean_copies = [], []
    for _ in range(RES_NAN_STEP + 1):
        clean_losses.append(float(clean.run(batch)["loss"]))
        clean_copies.append(_device_copy(clean))
    sess, _ = _resilience_session(spec, {
        "AUTODIST_CHAOS": f"nan_grad@step={RES_NAN_STEP},bucket={key}"})
    want = _expected_launches(sess, layers)
    _reset_all_counts()
    losses, flagged, skipped = [], None, None
    for i in range(RES_NAN_STEP + 2):
        before = _device_copy(sess) if i == RES_NAN_STEP else None
        out = sess.run(batch)
        h = out["grad_health"]
        losses.append(float(out["loss"]))
        if i == RES_NAN_STEP:
            flagged = [k for k, v in h.per_bucket.items() if not v["finite"]]
            skipped = int(h.skipped_steps)
            if bool(h.all_finite) or flagged != [key] or skipped != 1 \
                    or not _same_params(sess, before):
                raise AssertionError(
                    f"nan_grad step: all_finite {h.all_finite}, flagged "
                    f"{flagged}, skipped {skipped}, parameters kept "
                    f"{_same_params(sess, before)}")
        elif not bool(h.all_finite):
            raise AssertionError(f"step {i} was not finite: {h}")
    torch.cuda.synchronize()
    nan_launches = _kernel_counts()
    steps = RES_NAN_STEP + 2
    # the skipped step runs K4 (it detects the poison) and no update (K5)
    expect = {k: v * steps for k, v in want.items()}
    expect["adam_update"] -= want["adam_update"]
    if nan_launches != expect:
        raise AssertionError(f"nan_grad run launched {nan_launches}, "
                             f"expected {expect}")
    after = losses[:RES_NAN_STEP] + losses[RES_NAN_STEP + 1:]
    if after != clean_losses or not _same_params(sess, clean_copies[-1]):
        raise AssertionError(f"the unpoisoned steps' losses {after} are "
                             f"not the clean run's {clean_losses}")
    del sess, clean_copies
    # the spike: the clean program continued to 10 steps is the oracle
    for _ in range(2 * RES_EPOCH_STEPS - RES_NAN_STEP - 1):
        clean.run(batch)
    oracle = _device_copy(clean)
    del clean
    _fresh_peak(torch)
    sess, _ = _resilience_session(spec)
    ckpt = tempfile.mkdtemp(prefix="smoke_spike_")
    # the health monitor reads the spike events when fit builds it
    os.environ["AUTODIST_CHAOS"] = f"loss_spike@step={RES_SPIKE_STEP}"
    try:
        t0 = time.perf_counter()
        hist = sess.fit([batch] * RES_EPOCH_STEPS, epochs=2,
                        steps_per_epoch=RES_EPOCH_STEPS,
                        checkpoint_dir=ckpt, checkpoint_keep=2)
        fit_s = time.perf_counter() - t0
    finally:
        os.environ.pop("AUTODIST_CHAOS", None)
        shutil.rmtree(ckpt, ignore_errors=True)
    rbs = [(r["at_step"], r["restored_step"])
           for r in hist.history.get("rollbacks", [])]
    if rbs != [(RES_SPIKE_STEP, RES_EPOCH_STEPS)] \
            or sess.step_count != 2 * RES_EPOCH_STEPS \
            or not _same_params(sess, oracle):
        raise AssertionError(f"loss_spike: rollbacks {rbs}, step "
                             f"{sess.step_count}, oracle parameters "
                             f"{_same_params(sess, oracle)}")
    del sess, oracle
    _fresh_peak(torch)
    return {"nan_bucket": key, "nan_step": RES_NAN_STEP,
            "k4_flagged": flagged, "skipped_steps": skipped,
            "params_bit_identical_across_skip": True,
            "unpoisoned_steps_equal_clean_run": True,
            "losses": losses, "clean_losses": clean_losses,
            "launches": nan_launches, "launches_per_step": want,
            "spike_step": RES_SPIKE_STEP, "rollbacks": rbs,
            "rollback_matches_oracle": True, "spike_fit_s": fit_s,
            "reduce_leg": reduce_leg}


class _ResilienceProgress:
    """``fit`` callback of the supervised worker: after each step, the
    step, the time and this attempt's launch counts (K4, K5, the leg
    cursor) to ``<out>.progress`` (written atomically: a killed attempt
    leaves its last line)."""

    def __init__(self, path: str):
        self.path = path

    def on_train_begin(self, session) -> None: ...

    def on_epoch_begin(self, epoch) -> None: ...

    def on_step_end(self, step, metrics) -> None:
        from autodist_tpu_torch.ops import leg_cursor

        counts = _kernel_counts()
        rec = {"step": int(step), "time": time.time(),
               "attempt": os.environ.get("AUTODIST_ATTEMPT"),
               "detect_stats": counts["detect_stats"],
               "adam_update": counts["adam_update"],
               "leg_cursor": leg_cursor.stamp.calls}
        with open(self.path + ".tmp", "w", encoding="utf-8") as f:
            json.dump(rec, f)
        os.replace(self.path + ".tmp", self.path)

    def on_epoch_end(self, epoch, logs) -> None: ...

    def on_train_end(self, history) -> None: ...


def resilience_worker(ckpt: str, hb_dir: str, out: str) -> int:
    """One attempt of the supervisor drill (``--resilience-worker``):
    ``train_ps``'s program through ``fit``, 3 epochs of 2 steps with a
    checkpoint after each (resuming the newest), the heartbeat callback
    on ``hb_dir`` and ``AUTODIST_CHAOS`` through the chaos callback; the
    finished attempt writes its parameter digest to ``out``."""
    import torch

    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.resilience import (ChaosCallback, ChaosMonkey,
                                               HeartbeatCallback,
                                               HeartbeatWriter)

    torch.cuda.set_device(0)
    spec = transformer_lm()
    sess, batch = _resilience_session(spec, numerics=RES_SUP_NUMERICS)
    writer = HeartbeatWriter(hb_dir, "worker-0", interval=0.5)
    hist = sess.fit([batch] * 2, epochs=RES_SUP_EPOCHS, steps_per_epoch=2,
                    checkpoint_dir=ckpt, callbacks=[
                        _ResilienceProgress(out + ".progress"),
                        HeartbeatCallback(writer),
                        ChaosCallback(ChaosMonkey.from_env())])
    with open(out, "w", encoding="utf-8") as f:
        json.dump({"params_sha256": _params_digests(sess)["params_sha256"],
                   "step": sess.step_count, "steps_run": hist.steps_run,
                   "resume_tier": hist.resume_tier}, f)
    return 0


def _resilience_supervisor(torch, spec, reduce_leg: str) -> dict:
    """(b) The Supervisor drill: ``--resilience-worker`` attempts under
    ``kill@step=3,attempt=0`` and ``hang@step=5,attempt=1,leg=<reduce
    leg>`` (``AUTODIST_FLIGHTREC=legs``): the monitor reads the hang as
    WEDGED within its step timeout and the evidence names the leg; the
    third attempt finishes, its digest the parent's uninterrupted run's."""
    import tempfile

    from autodist_tpu_torch.resilience import (Backoff, Supervisor,
                                               SupervisorPolicy)
    from autodist_tpu_torch.telemetry import events as ev

    # the parent's oracle: the same fit, uninterrupted, no checkpoints
    _fresh_peak(torch)
    oracle, batch = _resilience_session(spec, numerics=RES_SUP_NUMERICS)
    oracle.fit([batch] * 2, epochs=RES_SUP_EPOCHS, steps_per_epoch=2)
    want = _params_digests(oracle)["params_sha256"]
    del oracle
    _fresh_peak(torch)

    work = tempfile.mkdtemp(prefix="smoke_sup_")
    ckpt, outs, launched = os.path.join(work, "ckpt"), [], []
    # the attempts publish their schedule IR here, and the supervisor's
    # crash bundles land here: the hang diagnosis reads both
    tel = os.path.join(work, "telemetry")
    chaos = (f"kill@step=3,attempt=0;hang@step=5,attempt=1,"
             f"leg={reduce_leg}")

    def launch(att):
        out = os.path.join(work, f"attempt_{att.index}.json")
        outs.append(out)
        launched.append(time.time())
        env = dict(os.environ, **att.env(), AUTODIST_CHAOS=chaos,
                   AUTODIST_FLIGHTREC="legs", AUTODIST_TELEMETRY_DIR=tel)
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--resilience-worker", ckpt, att.heartbeat_dir, out],
            env=env, start_new_session=True, stdout=subprocess.DEVNULL,
            stderr=open(out + ".err", "w"))

    sup = Supervisor(SupervisorPolicy(
        max_restarts=3, heartbeat_timeout=RES_BEACON_TIMEOUT_S,
        step_timeout=RES_STEP_TIMEOUT_S, poll_interval=0.2, kill_grace=10.0,
        backoff=Backoff(max_tries=4, base=0.1, cap=0.2, jitter=0)),
        checkpoint_dir=ckpt, workdir=os.path.join(work, "sup"))
    ev.configure(None)
    t0 = time.perf_counter()
    os.environ["AUTODIST_TELEMETRY_DIR"] = tel
    try:
        report = sup.run(launch)
        wall = time.perf_counter() - t0
        progress = [json.load(open(o + ".progress")) for o in outs]
        result = json.load(open(outs[-1])) if report.ok else None
        errs = [open(o + ".err").read()[-2000:] for o in outs]
    finally:
        os.environ.pop("AUTODIST_TELEMETRY_DIR", None)
        shutil.rmtree(work, ignore_errors=True)
    events = ev.get_journal().events
    fails = [e for e in events if e["kind"] == "supervisor/attempt_failure"]
    starts = [e for e in events if e["kind"] == "supervisor/attempt_start"]
    kinds = [(f.attempt, f.kind) for f in report.failures]
    if not report.ok or kinds != [(0, "exit"), (1, "heartbeat")]:
        raise AssertionError(f"supervisor: ok {report.ok}, failures "
                             f"{report.failures}, gave up "
                             f"{report.gave_up!r}; stderr {errs}")
    wedge = report.failures[1]
    if "wedged" not in wedge.detail or reduce_leg not in wedge.detail:
        raise AssertionError(f"the WEDGED verdict does not name the "
                             f"planted leg {reduce_leg}: {wedge.detail}")
    if result["params_sha256"] != want \
            or result["step"] != 2 * RES_SUP_EPOCHS:
        raise AssertionError(f"the supervised run ended on {result}, the "
                             f"uninterrupted run's digest is {want}")
    if [p["step"] for p in progress] != [3, 5, 2 * RES_SUP_EPOCHS]:
        raise AssertionError(f"attempts' last steps {progress}")
    resume_steps = [s["resume_step"] for s in starts]
    to_wedged = fails[1]["time"] - progress[1]["time"]
    relaunch = [progress[i + 1]["time"] - fails[i]["time"]
                for i in range(2)]
    if not to_wedged <= RES_STEP_TIMEOUT_S + 5:
        raise AssertionError(f"WEDGED after {to_wedged:.1f} s, the step "
                             f"timeout is {RES_STEP_TIMEOUT_S} s")
    if progress[1]["leg_cursor"] <= 0:
        raise AssertionError("attempt 1 launched no leg cursor")
    return {"attempts": report.attempts,
            "failures": [{"attempt": f.attempt, "kind": f.kind,
                          "culprit": f.culprit, "detail": f.detail}
                         for f in report.failures],
            "resume_steps": resume_steps, "params_equal_oracle": True,
            "step_timeout_s": RES_STEP_TIMEOUT_S,
            "time_to_wedged_s": to_wedged,
            "relaunch_to_first_step_s": relaunch,
            "attempt_last_steps": [p["step"] for p in progress],
            "attempt_launches": [{k: p[k] for k in (
                "detect_stats", "adam_update", "leg_cursor")}
                for p in progress], "wall_s": wall}


def phase_resilience(torch) -> dict:
    """The ``resilience`` phase (one card): the guard drill and the
    Supervisor drill at full width."""
    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    spec = transformer_lm()
    t0 = time.perf_counter()
    guard = _resilience_guard(torch, spec)
    guard_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    sup = _resilience_supervisor(torch, spec, guard["reduce_leg"])
    return {"guard": guard, "guard_s": guard_s, "supervisor": sup,
            "supervisor_s": time.perf_counter() - t1,
            "total_s": time.perf_counter() - t0}


# -- elastic: a 4-rank ZeRO-1 checkpoint on one card --------------------------

def _ps_lb_donor(torch, sess, directory: str) -> dict:
    """After ``ps_lb``'s steps: a Saver checkpoint of the 4 ranks (rank 0
    writes), the logical parameters' digest at it, and the losses of
    :data:`ELASTIC_STEPS` more steps (the donor's)."""
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    batch = transformer_lm().sample_batch(TRAIN_SHAPE["B"], seed=SEED)
    t0 = time.perf_counter()
    path = Saver(sess).save(directory)
    save_s = time.perf_counter() - t0
    digest = _params_digests(sess)["params_sha256"]
    return {"path": path, "step": sess.step_count, "save_s": save_s,
            "params_sha256": digest,
            "losses": [float(sess.run(batch)["loss"])
                       for _ in range(ELASTIC_STEPS)]}


def _drifted_checkpoint(path: str, buckets, out: str) -> str:
    """A step directory beside ``path`` whose items are links to its own
    and whose meta records the layout the same catalog gets under a
    bucket cap of :data:`ELASTIC_DRIFT_CAP` (what a drifted
    ``bucket_bytes`` writes: every multi-member bucket splits)."""
    from autodist_tpu_torch.checkpoint.saver import META_FILE, Saver
    from autodist_tpu_torch.kernel.synchronization.bucketing import \
        assign_buckets
    from autodist_tpu_torch.resilience.elastic import bucket_layout

    meta = Saver.read_meta(path)
    entries = [(v.name, v.shape, b.dtype, b.compressor, b.group, b.mode,
                b.stored) for b in buckets for v in b.vars]
    meta["zero1_buckets"] = bucket_layout(assign_buckets(
        entries, bucket_bytes=ELASTIC_DRIFT_CAP,
        shard_divisor=meta.get("data_axis_size", 1)))
    os.makedirs(out)
    for item in meta.get("items", []):
        if os.path.isdir(os.path.join(path, item)):
            os.symlink(os.path.join(path, item), os.path.join(out, item))
    with open(os.path.join(out, META_FILE), "w", encoding="utf-8") as f:
        json.dump(meta, f)
    return out


def phase_elastic(torch, donor: dict) -> dict:
    """The ``elastic`` phase: ``ps_lb``'s 4-rank checkpoint (``embed``
    stored 1/4) into a one-card ``train_ps`` session: ``preflight_elastic``
    then ``elastic_restore``; parameters bit-exact with the ranks'
    gathered ones, every moment's first ``total`` elements bit-exact and
    the pad zero, the next losses at rtol 1e-5 of the donor's with K4/K5
    as the schedule IR predicts; a drifted bucket cap raises."""
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.checkpoint.saver import read_item
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.resilience import (ElasticResumeError,
                                               elastic_restore,
                                               preflight_elastic)
    from autodist_tpu_torch.telemetry import events as ev

    spec = transformer_lm()
    layers = spec.config["num_layers"]
    path = donor["path"]
    _fresh_peak(torch)
    t0 = time.perf_counter()
    sess, batch = _resilience_session(spec, numerics={
        "clip_norm": CLIP_NORM})
    meta = Saver.read_meta(path)
    if meta["data_axis_size"] != RING_RANKS or sess.data_axis_size != 1:
        raise AssertionError(f"elastic: checkpoint at data "
                             f"{meta['data_axis_size']}, session at "
                             f"{sess.data_axis_size}")
    t1 = time.perf_counter()
    preflight_elastic(sess, meta, context="chip_smoke elastic")
    preflight_s = time.perf_counter() - t1
    ev.configure(None)
    t1 = time.perf_counter()
    step = elastic_restore(sess, path, validate=False)
    restore_s = time.perf_counter() - t1
    (reshard,) = [e for e in ev.get_journal().events
                  if e["kind"] == "elastic/reshard"]
    if step != donor["step"] or \
            _params_digests(sess)["params_sha256"] != donor["params_sha256"]:
        raise AssertionError("elastic: the restored parameters are not "
                             "the ranks' gathered parameters bit for bit")
    saved = read_item(path, "opt_state")["zero1"]
    _, opt = sess.export_state()
    repadded = 0
    for b, old in zip(sess.zero1_buckets, meta["zero1_buckets"]):
        repadded += int(old["padded_total"] != b.padded_total)
        for m in ("mu", "nu"):
            got = opt["zero1"][m][b.key].cpu()
            if not torch.equal(got[:b.total], saved[m][b.key][:b.total]) \
                    or bool(got[b.total:].any()):
                raise AssertionError(f"elastic: {m} of {b.key} is not the "
                                     f"checkpoint's (or its pad is not 0)")
    del saved, opt
    want = _expected_launches(sess, layers)
    predicted = _ir_predicted_launches(sess.schedule_ir, layers)
    if want != predicted:
        raise AssertionError(f"elastic: the plan's launches {want}, the "
                             f"IR's {predicted}")
    losses, _, step_s, launches = _checked_steps(
        torch, "elastic", sess, batch, want, 0, ELASTIC_STEPS, True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, donor["losses"]))
    if not rel <= ELASTIC_LOSS_RTOL:
        raise AssertionError(f"elastic: losses {losses}, the donor's "
                             f"{donor['losses']} (rel {rel:.2e})")
    drift = _drifted_checkpoint(path, sess.zero1_buckets,
                                os.path.join(os.path.dirname(path),
                                             "drifted"))
    try:
        Saver(sess).restore(drift)
        raise AssertionError("elastic: a drifted bucket cap restored")
    except ElasticResumeError as e:
        drift_error = str(e)[:200]
    del sess
    _fresh_peak(torch)
    return {"from_data": meta["data_axis_size"], "to_data": 1,
            "restored_step": step, "buckets": len(meta["zero1_buckets"]),
            "repadded_buckets": repadded, "preflight_s": preflight_s,
            "restore_s": restore_s, "reshard_s": reshard["duration_s"],
            "reshard_bytes": reshard["bytes"],
            "donor_save_s": donor["save_s"],
            "params_equal_donor": True, "moments_equal_donor": True,
            "losses": losses, "donor_losses": donor["losses"],
            "max_rel_diff": rel, "rtol": ELASTIC_LOSS_RTOL,
            "ms_per_step": statistics.median(step_s) * 1e3,
            "launches": launches, "launches_per_step": want,
            "ir_predicted_per_step": predicted,
            "drifted_cap_raises": drift_error,
            "total_s": time.perf_counter() - t0}


# -- router: two supervised replicas on the card ------------------------------

def replica_main() -> int:
    """One serving replica of the ``router`` phase (``--replica``): the
    full-width paged server from ``SEED``'s weights on a free port, its
    address published to ``AUTODIST_REPLICA_ADDR_FILE``, beacons on
    ``AUTODIST_REPLICA_HB_DIR``, and K9's launches and the decode ticks
    in ``<address file>.k9`` (read by the parent)."""
    import torch

    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.resilience import HeartbeatWriter
    from autodist_tpu_torch.serving import serve

    torch.cuda.set_device(0)
    addr = os.environ["AUTODIST_REPLICA_ADDR_FILE"]
    spec = transformer_lm()
    srv = serve(spec, spec.init(SEED, device="cuda"), paged=True,
                device="cuda", host="127.0.0.1", port=0, **SERVE_GEOM)
    writer = HeartbeatWriter(os.environ["AUTODIST_REPLICA_HB_DIR"],
                             os.environ["AUTODIST_REPLICA_NAME"],
                             interval=0.5).start()
    host, port = srv.address

    def publish(path, payload):
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(path + ".tmp", path)
    publish(addr, {"host": host, "port": port, "pid": os.getpid()})
    eng = srv.engine
    while True:
        time.sleep(0.3)
        writer.beat(step=int(eng.stats.ticks))
        publish(addr + ".k9", {"paged_attention": fk.paged_attention.calls,
                               "ticks": int(eng.stats.ticks)})


def _router_requests(vocab: int):
    """The kill drill's greedy requests: short ones (their completion
    arms the kill) and long ones (in flight when it lands)."""
    rng = np.random.RandomState(SEED + 7)
    return [(rng.randint(0, vocab, int(rng.randint(8, 24))).astype(
        np.int32), n) for n in ROUTER_NEW_TOKENS]


def phase_router(torch) -> dict:
    """The ``router`` phase: ``SupervisedReplicaPool(2)`` of full-width
    paged replicas (``--replica``), ``Router(recover=True)``; chaos
    SIGKILLs replica 0 mid-decode and the stitched outputs equal the
    plain generator token for token, at least one ``recovered``; the pool
    relaunches replica 0; ``/admin/drain`` on replica 1 takes it out of
    rotation without a mark-down; ``rolling_restart`` drops nothing."""
    import tempfile

    from autodist_tpu_torch.models.generate import make_generator
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.resilience import Backoff, SupervisorPolicy
    from autodist_tpu_torch.serving.router import (Router,
                                                   SupervisedReplicaPool)

    spec = transformer_lm()
    work = tempfile.mkdtemp(prefix="smoke_pool_")
    chaos = ("slow_replica@replica=0,seconds=0.05,attempt=0;"
             f"kill_replica@replica=0,tokens={ROUTER_KILL_TOKENS},"
             "attempt=0")
    launches = []

    def launch(index, attempt):
        launches.append((index, attempt.index, time.time()))
        env = dict(os.environ, AUTODIST_REPLICA_ADDR_FILE=os.path.join(
            work, f"replica_{index}.addr.json"),
            AUTODIST_REPLICA_HB_DIR=attempt.heartbeat_dir,
            AUTODIST_REPLICA_NAME=f"replica-{index}",
            AUTODIST_ATTEMPT=str(attempt.index), AUTODIST_CHAOS=chaos)
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--replica"],
            env=env, start_new_session=True, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    def wait(pred, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.2)
        raise AssertionError(f"router: timed out waiting for {what}")

    torch.cuda.empty_cache()
    pool = SupervisedReplicaPool(2, launch, work, policy=SupervisorPolicy(
        max_restarts=6, heartbeat_timeout=30.0, poll_interval=0.2,
        kill_grace=10.0, backoff=Backoff(max_tries=8, base=0.2, cap=1.0,
                                         jitter=0)))
    eps = pool.endpoints()
    router = Router(eps, probe_ttl_s=0.2, stats_ttl_s=0.1, retry_wait_s=0.2,
                    max_attempts=40)
    requests = _router_requests(spec.config["vocab_size"])
    t0 = time.perf_counter()
    try:
        pool.start()
        wait(lambda: all(ep.probe() for ep in eps), 300, "both replicas")
        start_s = time.perf_counter() - t0
        # the kill drill: every request in flight at once
        results, errors, lat = {}, [], {}

        def issue(i, prompt, n):
            t = time.perf_counter()
            try:
                results[i] = router.complete(
                    {"prompt_tokens": [int(x) for x in prompt],
                     "max_new_tokens": n}, timeout_s=300)
                lat[i] = time.perf_counter() - t
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=issue, args=(i, p, n))
                   for i, (p, n) in enumerate(requests)]
        t_kill = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or len(results) != len(requests):
            raise AssertionError(f"router: requests failed {errors}")
        recovered = [i for i, r in results.items() if r.get("recovered")]
        if not recovered:
            raise AssertionError("router: no request was recovered from "
                                 "the killed replica")
        wait(lambda: eps[0].probe(), 300, "replica 0's relaunch")
        relaunched = [t for i, a, t in launches if i == 0 and a == 1]
        relaunch_s = time.time() - relaunched[0] if relaunched else None
        replica0_up_s = time.time() - t_kill
        # a fresh router for the healed pool: the drill's router holds
        # replica 0's circuit breaker open after its in-flight failures
        router = Router(eps, probe_ttl_s=0.2, stats_ttl_s=0.1,
                        retry_wait_s=0.2, max_attempts=40)
        # each recovered request again on the healed pool: its latency
        # without the failure, the baseline of the recovery's extra ms
        healed = {}
        for i in recovered[:ROUTER_HEALED_REPEATS]:
            t = time.perf_counter()
            again = router.complete(
                {"prompt_tokens": [int(x) for x in requests[i][0]],
                 "max_new_tokens": requests[i][1]}, timeout_s=300)
            healed[i] = time.perf_counter() - t
            if again["tokens"] != results[i]["tokens"]:
                raise AssertionError(f"router: request {i} on the healed "
                                     f"pool differs from its recovery")
        k9 = json.load(open(os.path.join(work, "replica_1.addr.json.k9")))
        if k9["paged_attention"] != spec.config["num_layers"] * k9["ticks"] \
                or k9["paged_attention"] <= 0:
            raise AssertionError(f"router: the survivor's K9 {k9}")
        # the drain: replica 1 leaves rotation, not marked down
        cli1 = eps[1].client()
        t1 = time.perf_counter()
        status, body = cli1._request("POST", "/admin/drain", {})
        if status != 200 or not body.get("draining"):
            raise AssertionError(f"router: drain answered {status} {body}")
        before = eps[1].fetch_stats()["requests_served"]
        for prompt, _ in requests[:2]:
            router.complete({"prompt_tokens": [int(x) for x in prompt],
                             "max_new_tokens": 4}, timeout_s=120)
        after = eps[1].fetch_stats()
        if after["requests_served"] != before or not after["draining"] \
                or "replica-1" in router._down_until:
            raise AssertionError(f"router: the drained replica served or "
                                 f"was marked down: {after}")
        cli1._request("POST", "/admin/undrain", {})
        drain_s = time.perf_counter() - t1
        # the rolling restart under load
        stop, load_errors, served = threading.Event(), [], []
        prompt = [int(x) for x in requests[0][0]]

        def load():
            while not stop.is_set():
                try:
                    served.append(router.complete(
                        {"prompt_tokens": prompt, "max_new_tokens": 4},
                        timeout_s=300))
                except Exception as e:  # noqa: BLE001 - reported below
                    load_errors.append(repr(e))
                    return
        loaders = [threading.Thread(target=load) for _ in range(2)]
        old = {i: pool.current_proc(i).pid for i in range(2)}
        t1 = time.perf_counter()
        for t in loaders:
            t.start()
        try:
            summary = pool.rolling_restart(drain_timeout_s=120.0,
                                           relaunch_timeout_s=300.0)
        finally:
            stop.set()
            for t in loaders:
                t.join(timeout=300)
        rolling_s = time.perf_counter() - t1
        if summary["failed"] or load_errors or not served or any(
                pool.current_proc(i).pid == old[i] for i in range(2)):
            raise AssertionError(f"router: rolling restart {summary}, "
                                 f"errors {load_errors}")
        if len({tuple(s["tokens"]) for s in served}) != 1:
            raise AssertionError("router: the rolling restart's answers "
                                 "differ")
    finally:
        pool.stop()
        shutil.rmtree(work, ignore_errors=True)
    # the oracle: the plain generator on the same weights
    params = lm_params(spec, device="cuda")
    gen = make_generator(spec, device="cuda")
    for i, (prompt, n) in enumerate(requests):
        _check_exact(torch, gen, params, prompt, n, results[i]["tokens"],
                     f"router request {i}")
    _check_exact(torch, gen, params, requests[0][0], 4, served[0]["tokens"],
                 "rolling restart request")
    del params
    torch.cuda.empty_cache()
    return {"replicas": 2, "requests": len(requests),
            "recovered": len(recovered),
            "resumed_tokens": [results[i]["resumed_tokens"]
                               for i in recovered],
            "token_exact": True, "start_s": start_s,
            "recovery_extra_ms": [(lat[i] - healed[i]) * 1e3
                                  for i in healed],
            "recovered_latency_s": [lat[i] for i in healed],
            "healed_latency_s": [healed[i] for i in healed],
            "relaunch_s": relaunch_s, "replica0_back_after_kill_s":
                replica0_up_s, "drain_s": drain_s,
            "drained_replica_skipped": True,
            "rolling_restart_s": rolling_s,
            "rolling_restart_served": len(served),
            "rolling_restart_summary": summary,
            "survivor_k9": k9, "total_s": time.perf_counter() - t0}


def check_seq(ring, train_losses, smi) -> dict:
    """Rank 0's ``seq_ring`` / ``seq_ulysses`` losses against the one-card
    flash run's (``train_losses``, phase 5's) at :data:`SEQ_LOSS_RTOL`;
    emits each configuration's line and the twin's; returns the K1–K3
    launches by path."""
    paths = {}
    for config in SEQ_CONFIGS:
        out = ring[config]
        ref = train_losses[:len(out["losses"])]
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], ref))
        if not rel <= SEQ_LOSS_RTOL:
            raise AssertionError(f"{config}: rank 0's losses "
                                 f"{out['losses']} differ from the one-card "
                                 f"run's {ref} by {rel:.2e}")
        emit({"phase": config, "card": smi, "ranks": RING_RANKS,
              "params_identical_across_ranks": True,
              "one_card_losses": ref, "max_rel_diff_vs_one_card": rel,
              "rtol": SEQ_LOSS_RTOL, **out})
        paths[config + " (rank 0)"] = out
    emit({"phase": "long_context", "card": smi, "ranks": RING_RANKS,
          **ring["long_context"]})
    paths["long_context D=32 (rank 0)"] = dict(
        ring["long_context"], launches_per_step={
            k: 8 for k in ("flash_fwd", "flash_dq", "flash_dkv")})
    return paths


def seq_only(torch) -> int:
    """``--seq``: the build, K1–K3 at D = 32 against their plain versions,
    a one-card flash reference of 2 steps (phase 5's program) and the
    ring ranks' ``seq_ring``, ``seq_ulysses`` and ``long_context``, with
    their checks."""
    from autodist_tpu_torch.device_timer import Timer
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops import _build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    proc = start_ptxas_report("flash_attention.cu")
    _build.build_all()
    report = read_ptxas_report(proc)
    emit({"phase": "device", "nvidia_smi": smi,
          "build_s": time.perf_counter() - t0,
          "ptxas_d32": {k: v for k, v in report.items() if "<32," in k}})
    rows = phase_flash_long(torch, Timer())
    spec = transformer_lm()
    _fresh_peak(torch)
    sess, batch = _train_session(spec, lm_params(spec), TRAIN_SHAPE["B"])
    losses = [float(sess.run(batch)["loss"])
              for _ in range(SEQ_WARMUP + SEQ_TIMED)]
    del sess
    _fresh_peak(torch)
    ring, wall, _ = phase_train_ring(mode="seq")
    check_seq(ring, losses, smi)
    emit({"phase": "seq_only", "ring_wall_s": wall,
          "d32_ms": {k: r["ms"] for k, r in rows.items()}})
    print(smi, flush=True)
    return 0


def moe_only(torch) -> int:
    """``--moe``: the build, ``moe_reference`` and the ring ranks'
    ``moe_ffn_ep`` and ``moe_ep``, with their checks."""
    from autodist_tpu_torch.ops import _build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "device", "nvidia_smi": smi,
          "build_s": time.perf_counter() - t0})
    ref = phase_moe_reference(torch)
    emit({"phase": "moe_reference", "card": smi, **ref})
    _fresh_peak(torch)
    ring, wall, _ = phase_train_ring(mode="moe")
    check_moe(ring, ref, smi)
    emit({"phase": "moe_only", "ring_wall_s": wall,
          "rank0_t_s": ring["t_s"]})
    print(smi, flush=True)
    return 0


def ring_repeat(torch, times: int) -> int:
    """``train_ring`` ``times`` times in a row: each repetition's outcome
    (rank digests agree, or which parameters differ) as one JSON line, then
    the count that diverged.  Exits 1 when one did; any other failure of
    the ring propagates."""
    from autodist_tpu_torch.ops import _build

    _build.build_all()
    diverged = 0
    for i in range(times):
        t0 = time.perf_counter()
        try:
            ring, _, _ = phase_train_ring()
            emit({"phase": "ring_repeat", "run": i, "ok": True,
                  "wall_s": time.perf_counter() - t0,
                  "rank0_t_s": ring["t_s"],
                  "params_sha256": {c: ring[c]["params_sha256"]
                                    for c in RING_CONFIGS + (PS_LB_CONFIG,)
                                    + P6_CONFIGS}})
        except RankDivergence as e:
            diverged += 1
            emit({"phase": "ring_repeat", "run": i, "ok": False,
                  "wall_s": time.perf_counter() - t0, "error": str(e)})
    emit({"phase": "ring_repeat_summary", "runs": times,
          "diverged": diverged})
    return 1 if diverged else 0


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


#: the launch-latency probe: warm-up and timed 4-byte all_reduce calls
#: (and as many launches of a trivial kernel just before them)
ALPHA_WARMUP, ALPHA_CALLS = 100, 2000
#: how far (either way) the ``auto`` phase's gated reading may lie from
#: its constant: the cost model's drift threshold
#: (``telemetry.calibration.DRIFT_THRESHOLD``)
ALPHA_FACTOR = 3.0
#: the gated reading's constant: one collective's host cost over one
#: trivial kernel launch's, both timed back to back in the same process
#: (``collective_alpha``'s ``per_launch``), so that a host slower in
#: every call moves both and the ratio holds: the median of three
#: ``--collective-alpha`` readings, 4.92, 6.74 and 5.84 (38.5–38.7 µs
#: over 5.7–7.8 µs; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6)
ALPHA_PER_LAUNCH = 5.84


def _host_calls(torch, call) -> float:
    """Seconds a call of ``call()`` over ``ALPHA_CALLS`` calls back to back
    after ``ALPHA_WARMUP``, by the host clock up to a synchronize."""
    for _ in range(ALPHA_WARMUP):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ALPHA_CALLS):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ALPHA_CALLS


def collective_alpha(torch) -> dict:
    """The fixed cost of one collective on this card: a 4-byte
    ``all_reduce`` on a one-rank NCCL group, ``ALPHA_CALLS`` calls back
    to back after ``ALPHA_WARMUP``, timed by the host clock up to a
    synchronize (``host_s_per_call``: what a step that issues the
    collective waits) and by CUDA events (``device_s_per_call``).  The
    cost model's ``COLLECTIVE_ALPHA`` is the host reading.  Just before,
    the same count of launches of a trivial kernel (a 4-byte in-place
    add) by the same clock (``launch_s_per_call``): ``per_launch``, the
    collective's cost in launches, is what a slow host leaves as it is
    and a collective grown several-fold on the card does not."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    x = torch.ones(1, device="cuda")
    launch_s = _host_calls(torch, lambda: x.add_(1.0))
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        x = torch.ones(1, device="cuda")
        for _ in range(ALPHA_WARMUP):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(ALPHA_CALLS):
            dist.all_reduce(x)
        end.record()
        torch.cuda.synchronize()
        host_s = (time.perf_counter() - t0) / ALPHA_CALLS
        device_s = start.elapsed_time(end) / 1e3 / ALPHA_CALLS
    finally:
        dist.destroy_process_group()
    return {"calls": ALPHA_CALLS, "nbytes": 4,
            "host_s_per_call": host_s, "device_s_per_call": device_s,
            "launch_s_per_call": launch_s, "per_launch": host_s / launch_s}


def p6_lr_control(torch) -> int:
    """``--p6-lr-control``: build the kernels, run its 4 ranks and print
    rank 0's loss traces beside the card's name and power limit."""
    from autodist_tpu_torch.ops import _build

    _build.build_all()
    ring, wall, _ = phase_train_ring("lr_control")
    emit({"phase": "p6_lr_control", "card": nvidia_smi(),
          "ranks": RING_RANKS, "layers": P6_LAYERS,
          "batch": TRAIN_SHAPE["B"], "clip_norm": CLIP_NORM,
          "wall_s": wall, "losses": ring["lr_control"]})
    return 0


def tune_only(torch) -> int:
    """``--tune``: the kernels' build and the tune phase alone (its one-card
    parts and the 4-rank swap drill), for work on that phase."""
    from autodist_tpu_torch.ops import _build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "device", "nvidia_smi": smi,
          "build_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    tune_out, leg_row = phase_tune(torch, smi)
    emit({"phase": "tune", "wall_s": time.perf_counter() - t0, **tune_out})
    ring, wall, _ = phase_train_ring("tune")
    emit({"phase": "tune", "config": TUNE_RING_CONFIG, "wall_s": wall,
          **ring[TUNE_RING_CONFIG]})
    emit({"kernels": [leg_row]})
    print(smi, flush=True)
    return 0


def resilience_only(torch) -> int:
    """``--resilience``: the kernels' build and the three resilience phases
    alone (``ps_lb``'s 4 ranks write the elastic donor), for work on
    them."""
    import tempfile

    from autodist_tpu_torch.ops import _build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "device", "nvidia_smi": smi,
          "build_s": time.perf_counter() - t0})
    res_out = phase_resilience(torch)
    emit({"phase": "resilience", "card": smi, **res_out})
    elastic_dir = tempfile.mkdtemp(prefix="smoke_elastic_")
    try:
        ring, wall, _ = phase_train_ring("elastic", elastic_dir)
        emit({"phase": PS_LB_CONFIG, "wall_s": wall,
              "losses": ring[PS_LB_CONFIG]["losses"]})
        elastic_out = phase_elastic(torch,
                                    ring[PS_LB_CONFIG]["elastic_donor"])
    finally:
        shutil.rmtree(elastic_dir, ignore_errors=True)
    emit({"phase": "elastic", "card": smi, **elastic_out})
    router_out = phase_router(torch)
    emit({"phase": "router", "card": smi, **router_out})
    emit({"phase": "resilience_total", "seconds": res_out["total_s"]
          + elastic_out["total_s"] + router_out["total_s"]})
    print(smi, flush=True)
    return 0


def main() -> int:
    import torch

    if "--ring-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return ring_worker(int(args["--ring-rank"]), args["--ring-init"],
                           args["--ring-mode"], args.get("--elastic-dir"))
    if "--tune-predict" in sys.argv:
        # the CPU's prediction for the tune phase's 4-rank drill (meta
        # tensors: no card needed)
        emit({"phase": "tune_predict", **tune_prediction()})
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if "--resilience-worker" in sys.argv:
        i = sys.argv.index("--resilience-worker")
        return resilience_worker(*sys.argv[i + 1:i + 4])
    if "--mpmd-worker" in sys.argv:
        i = sys.argv.index("--mpmd-worker")
        stage, rank, init, root, job = sys.argv[i + 1:i + 6]
        return mpmd_worker(int(stage), int(rank), init, root, job)
    if "--replica" in sys.argv:
        return replica_main()
    if "--tune" in sys.argv:
        return tune_only(torch)
    if "--seq" in sys.argv:
        return seq_only(torch)
    if "--moe" in sys.argv:
        return moe_only(torch)
    if "--resilience" in sys.argv:
        return resilience_only(torch)
    if "--p6-lr-control" in sys.argv:
        return p6_lr_control(torch)
    if "--collective-alpha" in sys.argv:
        emit({"phase": "collective_alpha", "card": nvidia_smi(),
              **collective_alpha(torch)})
        return 0
    if "--ring-repeat" in sys.argv:
        return ring_repeat(torch, int(sys.argv[sys.argv.index(
            "--ring-repeat") + 1]))
    try:
        from autodist_tpu_torch.device_timer import Timer
        from autodist_tpu_torch.models.transformer_lm import transformer_lm
        from autodist_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    t0 = time.perf_counter()
    ptxas = {src: start_ptxas_report(src) for src in PTXAS_SOURCES}
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas_reports = {src: read_ptxas_report(p) for src, p in ptxas.items()}
    ptxas_report = ptxas_reports["flash_attention.cu"]
    emit({"phase": "device", "device": device_name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s})
    for src, report in ptxas_reports.items():
        emit({"phase": "ptxas", "source": "autodist_tpu_torch/csrc/" + src,
              "kernels": report})

    timer = Timer()
    k9, k10 = phase_kernels(torch, timer)
    flash_rows = phase_flash(torch, timer)
    bert_rows = phase_flash_bert(torch, timer)
    long_rows = phase_flash_long(torch, timer)
    sync_rows = phase_sync_kernels(torch, timer)
    lm1b_bucket = phase_sync_lm1b_bucket(torch, timer)
    quant_rows = phase_quant_kernels(torch, timer)
    del timer
    torch.cuda.empty_cache()

    spec = transformer_lm()          # the repo's defaults, float32
    t0 = time.perf_counter()
    params = lm_params(spec, device="cuda")
    init_s = time.perf_counter() - t0
    serve_out = phase_serve(torch, spec, params)
    serve_oracle = serve_out.pop("oracle")
    emit({"phase": "serve", "init_s": init_s, **serve_out})
    k9["launches"] = serve_out["paged_attention_calls"]

    int8_out = phase_int8(torch, spec, params)
    emit({"phase": "int8", **int8_out})
    k10["launches"] = int8_out["int8_matmul_calls"]

    del params
    torch.cuda.empty_cache()
    train_out = phase_train(torch)
    emit({"phase": "train", "card": smi, **train_out})
    for row in flash_rows:
        row["ptxas"] = ptxas_report[row["name"] + "_kernel<64, causal>"]
        row["launches"] = train_out["launches"][row["name"]]
        row["launches_per_step"] = train_out["launches_per_step"]
        row["share_of_step"] = (row["ms"] * train_out["launches_per_step"]
                                / train_out["ms_per_step"])
    emit({"phase": "train_parity", **phase_train_parity(torch)})

    zero1_out = phase_train_zero1(torch)
    emit({"phase": "train_zero1", "card": smi, **zero1_out})
    for row in sync_rows:
        row["launches"] = zero1_out["launches"][row["name"]]
        row["launches_per_step"] = zero1_out["launches_per_step"][row["name"]]
    emit({"phase": "train_zero1_parity",
          **phase_train_zero1_parity(torch)})
    accum_out = phase_train_accum(torch)
    emit({"phase": "train_accum", "card": smi, **accum_out})
    stale_out = phase_train_stale(torch)
    emit({"phase": "train_stale", "card": smi, **stale_out})
    remat_out = phase_train_remat(torch)
    emit({"phase": "train_remat", "card": smi, **remat_out})
    bf16_out = phase_train_bf16_state(torch, zero1_out)
    emit({"phase": "train_bf16_state", "card": smi, **bf16_out})
    export_out = phase_export(torch)
    emit({"phase": "export", "card": smi, **export_out})
    ps_out = phase_train_ps(torch, zero1_out)
    emit({"phase": "train_ps", "card": smi, **ps_out})
    t0 = time.perf_counter()
    fit_out = phase_train_fit(torch, ps_out)
    emit({"phase": "train_fit", "card": smi,
          "wall_s": time.perf_counter() - t0, **fit_out})
    telemetry_out = phase_telemetry(torch, ps_out)
    emit({"phase": "telemetry", "card": smi, **telemetry_out})
    auto_out = phase_auto(torch, ps_out)
    emit({"phase": "auto", "card": smi, **auto_out})
    t0 = time.perf_counter()
    tune_out, leg_row = phase_tune(torch, smi)
    emit({"phase": "tune", "wall_s": time.perf_counter() - t0, **tune_out})
    res_out = phase_resilience(torch)
    emit({"phase": "resilience", "card": smi, **res_out})
    for row in flash_rows:
        row["launches_by_path"] = {"train_fit": {
            "launches": fit_out["launches"][row["name"]],
            "per_step": fit_out["launches_per_step"][row["name"]]}}
        for c in remat_out["configs"]:
            row["launches_by_path"][
                f"train_remat {c['remat']} batch {c['batch']}"] = {
                "launches": c["launches"][row["name"]],
                "per_step": c["launches_per_step"][row["name"]]}
        row["launches_by_path"]["train_bf16_state"] = {
            "launches": bf16_out["launches"][row["name"]],
            "per_step": bf16_out["launches_per_step"][row["name"]]}
    flash_rows[0]["launches_by_path"]["export (serving process)"] = {
        case: export_out[case]["card"]["flash_fwd"] for case in EXPORT_TREES}
    k10["launches_by_path"] = {"export int8 (serving process)": export_out[
        "int8"]["card"]["int8_matmul"]}
    parallax_out = phase_train_parallax(torch, ps_out)
    emit({"phase": "train_parallax", "card": smi, **parallax_out})
    tp_ref = phase_tp_reference(torch)
    emit({"phase": "tp_reference", "card": smi, **tp_ref})
    moe_ref = phase_moe_reference(torch)
    emit({"phase": "moe_reference", "card": smi, **moe_ref})
    pipe_ref = phase_pipe_reference(torch)
    emit({"phase": "pipe_reference", "card": smi, **pipe_ref})
    for row in sync_rows:
        row["launches_by_path"] = {
            path: {"launches": out["launches"][row["name"]],
                   "per_step": out["launches_per_step"][row["name"]]}
            for path, out in (("train_ps", ps_out), ("train_fit", fit_out),
                              ("train_parallax", parallax_out),
                              ("train_bf16_state", bf16_out))}
        row["launches_by_path"].update({
            f"train_remat {c['remat']} batch {c['batch']}": {
                "launches": c["launches"][row["name"]],
                "per_step": c["launches_per_step"][row["name"]]}
            for c in remat_out["configs"]})
    for row in flash_rows + sync_rows:
        row.setdefault("launches_by_path", {})["telemetry fit"] = {
            "launches": telemetry_out["fit"]["launches"][row["name"]],
            "per_step": telemetry_out["launches_per_step"][row["name"]]}
        row["launches_by_path"]["auto"] = {
            "launches": auto_out["trained"]["launches"][row["name"]],
            "per_step": auto_out["trained"]["launches_per_step"][
                row["name"]]}

    import tempfile

    elastic_dir = tempfile.mkdtemp(prefix="smoke_elastic_")
    ring, ring_wall, fused_vs_unfused = phase_train_ring(
        elastic_dir=elastic_dir)
    for config in RING_CONFIGS:
        rel = check_ring_losses(config, ring[config]["losses"],
                                zero1_out["losses"])
        emit({"phase": "train_ring", "config": config, "card": smi,
              "ranks": RING_RANKS,
              "ms_per_step_label": "4 ranks time-sharing one card over gloo "
                                   "(host-staged wire)",
              "max_rel_diff_vs_f32": rel, "rtol_vs_f32": RING_LOSS_RTOL,
              **ring[config]})
    emit({"phase": "train_ring_fused_vs_unfused", "atol": 1e-6,
          "per_rank": fused_vs_unfused, "wall_s": ring_wall,
          "rank0_t_s": ring["t_s"]})
    for row in quant_rows:
        row["launches"] = sum(ring[c]["launches"][row["name"]]
                              for c in RING_CONFIGS)
    ps_lb = ring[PS_LB_CONFIG]
    ref = zero1_out["losses"][:len(ps_lb["losses"])]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ps_lb["losses"], ref))
    if not rel <= PS_LB_LOSS_RTOL:
        raise AssertionError(f"ps_lb losses {ps_lb['losses']} differ from "
                             f"train_zero1's {ref} by {rel:.2e}")
    trace = ps_lb["trace"]
    if trace["samples"] != trace["device_ranges"] or not all(
            trace["by_kind"].get(k, {}).get("min_ms", 0) > 0
            for k in ("all_reduce", "all_gather", "fused_detect",
                      "psum_guard", "fused_update")):
        raise AssertionError(f"ps_lb's traced step: {trace}")
    emit({"phase": PS_LB_CONFIG, "card": smi, "ranks": RING_RANKS,
          "ms_per_step_label": "4 ranks time-sharing one card over gloo "
                               "(host-staged wire)",
          "max_rel_diff_vs_train_zero1": rel, "rtol": PS_LB_LOSS_RTOL,
          **ps_lb})
    for row in sync_rows:
        row["launches_by_path"][PS_LB_CONFIG + " (rank 0)"] = {
            "launches": ps_lb["launches"][row["name"]],
            "per_step": ps_lb["launches_per_step"][row["name"]]}
    try:
        elastic_out = phase_elastic(torch, ps_lb.pop("elastic_donor"))
    finally:
        shutil.rmtree(elastic_dir, ignore_errors=True)
    emit({"phase": "elastic", "card": smi, **elastic_out})
    router_out = phase_router(torch)
    emit({"phase": "router", "card": smi, **router_out})
    emit({"phase": "resilience_total", "card": smi,
          "seconds": res_out["total_s"] + elastic_out["total_s"]
          + router_out["total_s"],
          "by_phase": {"resilience": res_out["total_s"],
                       "elastic": elastic_out["total_s"],
                       "router": router_out["total_s"]}})
    for row in sync_rows:
        row["launches_by_path"]["resilience nan_grad drill"] = {
            "launches": res_out["guard"]["launches"][row["name"]],
            "per_step": res_out["guard"]["launches_per_step"][row["name"]]}
        row["launches_by_path"]["elastic resume (one card)"] = {
            "launches": elastic_out["launches"][row["name"]],
            "per_step": elastic_out["launches_per_step"][row["name"]]}
    k9.setdefault("launches_by_path", {})[
        "router survivor replica (its process)"] = {
        "launches": router_out["survivor_k9"]["paged_attention"],
        "decode_ticks": router_out["survivor_k9"]["ticks"]}
    leg_row.setdefault("launches_by_path", {})[
        "resilience supervisor attempt 1 (legs, until the hang)"] = {
        "launches": res_out["supervisor"]["attempt_launches"][1][
            "leg_cursor"]}
    auto_ring = ring[AUTO_RING_CONFIG]
    emit({"phase": "auto", "config": AUTO_RING_CONFIG, "card": smi,
          "ranks": RING_RANKS, "params_identical_across_ranks": True,
          "ms_per_step_label": "4 ranks time-sharing one card over gloo "
                               "(host-staged wire)", **auto_ring})
    for row in sync_rows + flash_rows:
        row["launches_by_path"][AUTO_RING_CONFIG + " (rank 0)"] = {
            "launches": auto_ring["launches"][row["name"]],
            "per_step": auto_ring["launches_per_step"][row["name"]]}
    tune_ring = ring[TUNE_RING_CONFIG]
    emit({"phase": "tune", "config": TUNE_RING_CONFIG, "card": smi,
          "ranks": RING_RANKS, "params_identical_across_ranks": True,
          "ms_label": "4 ranks time-sharing one card over gloo "
                      "(host-staged wire)", **tune_ring})
    for row in sync_rows + flash_rows:
        row["launches_by_path"][TUNE_RING_CONFIG + " after the swap (rank 0)"
                                ] = {
            "launches": tune_ring["launches"][row["name"]],
            "per_step": tune_ring["launches_per_step_after"][row["name"]]}
    seq_paths = check_seq(ring, train_out["losses"], smi)
    tp_paths = check_tp(ring, tp_ref, smi)
    tp_paths.update(check_moe(ring, moe_ref, smi))
    tp_paths["moe_reference"] = moe_ref
    tp_paths.update(check_pipe(ring, pipe_ref, smi))
    for row in flash_rows + sync_rows:
        row["launches_by_path"].update({
            path: {"launches": out["launches"][row["name"]],
                   "per_step": out["launches_per_step"][row["name"]]}
            for path, out in tp_paths.items()
            if out["launches"][row["name"]]})
        if ring[PIPE_TWIN]["launches"][row["name"]]:
            row["launches_by_path"][f"examples {PIPE_TWIN} (rank 0)"] = {
                "launches": ring[PIPE_TWIN]["launches"][row["name"]]}
    for row in flash_rows:
        row["launches_by_path"].update({
            path: {"launches": out["launches"][row["name"]],
                   "per_step": out["launches_per_step"][row["name"]]}
            for path, out in seq_paths.items()})
        long_row = long_rows[row["name"]]
        long_row["ptxas"] = {
            c: ptxas_report[f"{row['name']}_kernel<32, {c}>"]
            for c in ("causal", "full")}
        long_row["launches"] = ring["long_context"]["launches"][row["name"]]
        long_row["launches_per_step"] = 8
        row["d32_shape"] = long_row
    t0 = time.perf_counter()
    mpmd_out = phase_mpmd(torch)
    emit({"phase": "mpmd", "card": smi, "phase_s": time.perf_counter() - t0,
          **mpmd_out})
    for row in flash_rows:
        row["launches_by_path"]["mpmd (each clean stage rank)"] = {
            "launches": mpmd_out["launches"][row["name"]],
            "per_step": mpmd_out["launches_per_step"][row["name"]]}
    for config in P6_CONFIGS:
        emit({"phase": "train_p6", "config": config, "card": smi,
              "ranks": RING_RANKS,
              "ms_per_step_label": "4 ranks time-sharing one card over gloo "
                                   "(host-staged wire)", **ring[config]})
    p6_paths = {f"train_accum {k}": v for k, v in
                accum_out["configs"].items()}
    p6_paths.update({"train_stale": stale_out["stale"],
                     "train_stale proxy": stale_out["proxy"]})
    p6_paths.update({f"train_p6 {c} (rank 0)": ring[c] for c in P6_CONFIGS})
    for row in flash_rows + sync_rows + quant_rows:
        row.setdefault("launches_by_path", {}).update({
            path: {"launches": out["launches"][row["name"]],
                   "per_step": out["launches_per_step"][row["name"]]}
            for path, out in p6_paths.items()
            if out["launches_per_step"][row["name"]]})

    # the BASELINE models, each at full width under its BASELINE builder
    resnet_out = phase_train_resnet50(torch)
    emit({"phase": "train_resnet50", "card": smi, **resnet_out})
    vgg_out = phase_train_vgg16(torch)
    emit({"phase": "train_vgg16", "card": smi, **vgg_out})
    bert_out = phase_train_bert(torch)
    emit({"phase": "train_bert", "card": smi, **bert_out})
    emit({"phase": "train_bert_parity", **phase_train_bert_parity(torch)})
    lm1b_out = phase_train_lm1b(torch)
    emit({"phase": "train_lm1b", "card": smi, **lm1b_out})
    ncf_out = phase_train_ncf(torch)
    emit({"phase": "train_ncf", "card": smi, **ncf_out})
    emit({"phase": "train_densenet121", "card": smi,
          **phase_train_densenet121(torch)})
    emit({"phase": "train_inception_v3", "card": smi,
          **phase_train_inception_v3(torch)})
    for row in flash_rows:
        bert_row = bert_rows[row["name"]]
        bert_row["ptxas"] = ptxas_report[row["name"] + "_kernel<64, full>"]
        bert_row["launches"] = bert_out["launches"][row["name"]]
        bert_row["launches_per_step"] = bert_out["launches_per_step"][
            row["name"]]
        row["bert_shape"] = bert_row
    for row in sync_rows:
        row["lm1b_bucket"] = lm1b_bucket[row["name"]]
        for path, out in (("train_vgg16", vgg_out), ("train_lm1b", lm1b_out),
                          ("train_ncf", ncf_out)):
            row["launches_by_path"][path] = {
                "launches": out["launches"][row["name"]],
                "per_step": out["launches_per_step"][row["name"]]}

    # the rest of serving, last so that no earlier phase runs after its
    # engines and profiles: the slot engine, beam search and score,
    # speculative decoding, the tokenizer, LoRA
    from autodist_tpu_torch.models.quantize import quantize_lm_params

    _fresh_peak(torch)
    t0 = time.perf_counter()
    params = lm_params(spec, device="cuda")

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(torch, *args, **kwargs)
        emit({"phase": name, "card": smi,
              "wall_s": time.perf_counter() - t, **out})
        return out

    serve_mesh = check_serve_mesh(torch, ring["serve_mesh_ranks"],
                                  serve_oracle, spec, params, smi)
    k9.setdefault("launches_by_path", {})[f"{SERVE_TP} (rank 0, 3 heads)"] = {
        "launches": serve_mesh[SERVE_TP]["launches"]["paged_attention"],
        "per_tick": serve_mesh[SERVE_TP]["paged_attention_per_tick"]}
    slot_out = {"f32": timed("serve_slot", phase_serve_slot, spec, params,
                             "f32", oracle=serve_oracle)}
    int8_spec = transformer_lm(**{
        **{k: v for k, v in spec.config.items() if k != "seq_len"},
        "num_layers": SLOT_INT8_LAYERS})
    qparams = quantize_lm_params(lm_params(int8_spec, device="cuda"))
    slot_out["int8"] = timed("serve_slot", phase_serve_slot, int8_spec,
                             qparams, "int8")
    del qparams
    beam_out = timed("beam_score", phase_beam_score, spec, params)
    spec_out = timed("spec", phase_spec, spec, params)
    timed("tokenizer", phase_tokenizer, spec, params)
    lora_out = timed("lora", phase_lora, spec, params)
    del params
    serving_slice_s = time.perf_counter() - t0

    for row in flash_rows:
        row["launches_by_path"]["lora"] = {
            "launches": lora_out["launches"][row["name"]],
            "per_step": lora_out["launches_per_step"]}
    flash_rows[0]["launches_by_path"]["beam_score score"] = {
        "launches": beam_out["flash_fwd_per_score"], "per_step": None}
    k9.setdefault("launches_by_path", {}).update({
        f"spec paged {name}": {
            "launches": spec_out[name]["paged"]["launches"][
                "paged_attention"],
            "per_round": spec_out[name]["paged"][
                "paged_attention_per_round"]}
        for name in ("self", "draft2")})
    k10["launches_by_path"]["serve_slot int8"] = {
        "launches": slot_out["int8"]["launches"]["int8_matmul"],
        "per_dispatch": slot_out["int8"]["int8_matmul_per_dispatch"]}

    examples_out = phase_examples(torch, smi)
    for row in flash_rows + sync_rows + quant_rows + [k9, k10]:
        row.setdefault("launches_by_path", {}).update({
            f"examples {name}": {"launches": out["launches"][row["name"]]}
            for name, out in examples_out["twins"].items()
            if out["launches"].get(row["name"])})

    emit({"kernels": flash_rows + sync_rows + quant_rows + [k9, k10,
                                                           leg_row],
          "card": smi, "serving_slice_s": serving_slice_s,
          "examples_s": examples_out["seconds"],
          "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (``saturn_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure is an exception and a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), its compute
   capability, and the build of the CUDA kernels from
   ``saturn_tpu_torch/csrc/flash_attn.cu`` and ``csrc/linear_ce.cu`` (one
   ``nvcc`` each, started together), with each kernel's ptxas line and the
   wgmma / TMA / cp.async / mma.sync / setmaxnreg instructions in its SASS
   (``cuobjdump``); the flash kernels (the forward at head dim 64 and 128,
   the head-dim-256 forward, dQ, dK/dV) and the CE forward, ds, dx and dW
   kernels must hold wgmma and TMA tile loads, the head-dim-256 forward,
   dQ and dK/dV also setmaxnreg.
2. Kernels against their plain PyTorch versions: flash forward, dQ and
   dK/dV at the GPT-2-small training shape (B 8, H 12, T 512, D 64, bf16,
   causal), a grouped-query shape (B 2, H 32, KV 4, T 1024, D 64), the main
   shape non-causal (BERT-base's), one tile (T 64), T 320 (T % 128 == 64),
   head dim 128 with grouped queries (H 8, KV 2) and, with long walks, (B 4,
   H 16, KV 4, T 2048), causal and not; the CE head's forward,
   dx and dW at the main shape (N 4096, D 768, V 50304), at an odd shape
   (N 4000, V 50257, the last 64 labels ignored), at D 1024 and at D 64 (odd
   shape), each in stash and in recompute mode, and in recompute mode over
   five vocab slabs, the last ragged (N 6000, V 50257, labels at every slab's
   edge columns, an ignored tail); the recompute-mode ds kernel alone on one
   slab at the main and the five-slab shape; and the shapes of phase 4's
   b8 x 1024 run: the CE head in recompute mode and its ds kernel at N 8192,
   D 768, V 50304 (seven slabs), the flash kernels at B 8, H 12, T 1024,
   causal; and head dim 256, GPT-J-6B's attention in phase 8b: timed at
   (B 8, H 16, T 512), causal, checked with grouped queries at T 192 and
   320, causal and not, on one tile, causal and not, at T 1024 and at B 1,
   H 1, and the forward, dQ and dK/dV run twice bitwise equal. Each
   kernel's device time, the plain version's and the library call's, all
   read from torch.profiler, and the kernel's bound on the card.
   The library call of a forward kernel is the library's forward (SDPA; the
   unfused ``F.linear`` + ``F.cross_entropy``), of a backward kernel the
   library's backward alone, run on a graph built outside the timed window.
   Beside each CE kernel, the time of cuBLAS on its product alone
   (``torch.matmul`` of x by Wᵀ with a bf16 (N, V) result beside
   ``ce_fwd``, of the bf16 (N, V) stash by the (V, D) W beside ``ce_dx``, of
   a bf16 (V, N) by the (N, D) x beside ``ce_dw``): yardsticks, in no table
   column.
3. The port's main path at full width: a heterogeneous sweep of two
   GPT-2-small tasks (b8 x 512, differing only in lr, ``pretraining_loss``)
   and one BERT-base task (b8 x 512, ``mlm_loss``), synthetic data, through
   ``register_default_library`` -> ``search(["dp"])`` (with a fresh profile
   cache under ``chiprun_out/``, so its trials run: one per signature, the
   second GPT-2 task is a cache hit) -> ``orchestrate`` (its defaults: the
   anytime solver, the health guardian) in intervals of INTERVAL_SHARE of
   the shortest task's profiled runtime, so that each task runs several; every
   checkpoint must reach its ``batch_count`` with finite, falling losses,
   and all six kernels must have run. Trials time K-step windows (K =
   ``max_window()``, 8) and the intervals run through them, the tail and
   short intervals through a window of one step: each interval's K,
   windows, tail, eager warm-up step and capture time are logged, and an
   interval whose config did not change must not have restored the
   checkpoint. The kernel launch counts of this phase go into the kernels
   line.
4. The kernels on the training path: dp ``execute`` of GPT-2-small for 10
   steps pinned to flash attention, from the same init and batches as a run
   pinned to dense and a flash run over the logits (a loss without the
   fused-head tag), each run twice: in windows of 8 (an eager step, the
   captures, one window, a tail of one one-step window) and one step at a
   time. Exactly 12
   launches of each flash kernel and 1 of each CE kernel per step where they
   apply, none elsewhere, in both runs; the windowed losses equal the eager
   ones within WINDOW_ATOL per step (the log says whether bitwise); the
   three configs' trajectories agree within the bf16 band. Then GPT-2-small
   at its published context, b8 x 1024 (N 8192), where ``ce.auto_stash``
   picks recompute mode: flash + fused head in windows of 8 and eager, and
   flash over the logits eager as the loss reference, with the same checks,
   the peak memory of each run, and the size of the recompute-mode ds
   scratch (N x ``ce.slab_width`` bf16) held under ``ce.SLAB_BYTES_MAX``.
5. Where a step's time goes, for the three pinned configs: synchronized
   per-step times, peak device memory, and a torch.profiler window (device
   busy share, each kernel's launches and device time inside the step, top
   operators). For flash + fused also the steady-state per-batch time of 3
   windows of 8 without a synchronize between them, beside the eager path's
   over the same 24 steps, in turns; the device busy time and idle share
   over the windows, with each kernel's launches per step as the profiler
   saw them inside the replays (they must be phase 4's); the peak memory of
   the windows. The same windows profile for flash + fused at b8 x 1024
   (recompute mode).
6. A sweep past the MILP's task limit: 13 GPT-2-small tasks (b8 x 512,
   at SWEEP_LAYERS of its 12 layers, cut in depth only; synthetic data, 16
   batches each) through ``search(["dp"])`` and
   ``orchestrate`` with the defaults (the health guardian, the anytime
   solver) and a fresh profile cache. Twelve differ only in lr
   (``pretraining_loss``, the fused head); the 13th runs an untagged loss
   over the logits that is NaN on its dataset's batch 12 (a marked row:
   sqrt(-1) computed on the card inside the captured window). Checked:
   the first search runs 2 trials (one per signature) and answers 11 from
   the cache, a repeat search runs none; the 13th task faults after a
   checkpoint, is retried from it, has batch 12 quarantined after its
   second fault and completes; every checkpoint written holds finite
   weights (checked before each write); every task completes with finite
   losses below the initial one; the metrics file holds the solve, solver
   tier, profile-cache and guardian events; the memory allocated falls
   back once the tasks complete. Printed: the solve's tier, wall time and
   makespan against the serial sum of runtimes, the peak memory, the
   checkpoint bytes written (the phase then deletes its checkpoints) and
   the phase's time. Its kernel launches join phase 3's in the kernels line.
7. Kill-replay of a sweep through the durability journal: two GPT-2-small
   tasks (b8 x 512 at KILL_LAYERS of its 12 layers, cut in depth only,
   flash + fused head, ``dp``, AdamW, 16 batches each, differing only in
   lr; the first search runs the trials of that depth into a profile cache
   of the phase's own, which phase 11 reuses) in intervals of
   KILL_INTERVAL_SHARE of the
   shortest profiled runtime, so that each task runs at least 3. One
   uninterrupted ``orchestrate(resume_dir=A)`` is the reference; then a
   chain on journal B and a second checkpoint directory, fresh tasks for
   each incarnation: the first killed by ``CrashInjector("mid-fsync",
   hit=2)`` (its journal tail torn), the second by ``("mid-interval",
   hit=1)`` (its checkpoint written, its progress not committed), the third
   running to the end. Checked: every task completes; each final checkpoint
   is at step 16 with parameters and AdamW moments bitwise equal to the
   reference run's; B replays strictly as one ``seq`` chain with the JAX
   package's record kinds and three recoveries, its torn tail in a
   ``.corrupt`` sidecar; B's progress is 16 for each task; the memory
   allocated after each killed incarnation is back where it was before the
   first; all six kernels ran. Printed: the journal's commit times, each
   resume's replay, reconcile (with ``verify`` of each checkpoint) and fold
   times, and the chain's time against the reference run's. Its launches
   are logged apart and leave the kernels line as phases 3, 14 and 6 made
   it.
8. Host offload (``parallel/offload.py``). a) GPT-2-small b8 x 512 over
   the logits (an untagged loss), 4 steps one at a time from the seed-0
   init under offload stream, offload bulk (remat off) and dp: the offload
   losses within OFFLOAD_REL of dp's (the log says whether bitwise), exact
   flash launches (12 of each kernel per step, the forward twice in
   stream mode, which recomputes every block), the host state pinned, and
   the memory each run holds on the card after its steps under dp's by at
   least the AdamW moments. b) GPT-J-6B at its published shape (28
   layers, d_model 4096, 16 heads, d_ff 16384, rotary 64, parallel
   residual, vocab 50304, b8 x 512, bf16 compute, fp32 params, AdamW; the
   host's memory, cores and free disk logged): 8b-1, ``search(["dp"])`` at
   the published depth must find every dp config infeasible by the static
   screen on the meta-device model (no init drawn), and
   ``search(["offload"])`` at
   GPTJ_SEARCH_LAYERS (cut in depth only) must time each offload config
   or find it out of device memory;
   8b-2, at GPTJ_CKPT_LAYERS (the machine's cap on disk writes a call
   holds no deeper checkpoint), ``search(["offload"])`` and
   ``orchestrate`` train the winner for 4 batches to a checkpoint at step
   4 with exactly one launch of each flash kernel (head dim 256) per layer
   and step (the forward twice where blocks are recomputed); the
   checkpoint, restored in place into a fresh host state, holds finite
   weights, and stream against bulk on it and one batch agree within
   STREAM_BULK_LOSS_REL (loss) and STREAM_BULK_GRAD_REL (gradients by
   relative norm); the card's memory returns to where 8b-2 began. c)
   GPT-J-6B at GPTJ_PARITY_LAYERS over the logits, 4 steps from one seed-0
   init through each technique's bundle (no checkpoint) under offload
   stream, offload bulk and dp: offload's losses within OFFLOAD_REL of dp's,
   exact flash launches. Printed: each step's host->card, compute,
   card->host and host-update seconds, the peak card memory, the pinned
   host bytes, the checkpoint's bytes and write seconds, the host states'
   draw seconds, the trials' kernel launches, and the bytes the run has
   passed to write calls before 8b-2's checkpoint.
9. What users hand the four calls and what they get back. a)
   ``generate_corpus`` writes its default 120 MB; the native word tokenizer
   (``native/tokenize.cpp``) reads the bundled corpus
   (``examples/data/corpus.txt``), the generated one and its first 8 MB,
   each into GPT-2's 50257-id vocab, timed (seconds, MB/s); its ids on the
   bundled corpus and the 8 MB prefix are byte-identical to
   ``_word_tokenize_python``'s. c) (run before b) a child process with an
   empty ``SATURN_TPU_COMPILE_CACHE_DIR`` builds the CUDA kernels and the
   native libraries into it (two ``nvcc``, two ``g++``, timed), a second
   one loads them from it and starts no process at all, and each launches
   the flash forward. b) the sweep driver,
   ``saturn_tpu_torch.examples.lm_sweep``, run as ``python -m`` runs it
   from a child launcher that passes ``trace_dir`` to its ``search`` and
   ``orchestrate`` (lm_sweep has no flag for it), with 9c's compile cache
   from the environment: GPT-2-small b8 x 512 at SWEEP_TRACE_LAYERS of its
   12 layers (cut in depth only), two lrs, SWEEP_BATCH_COUNT batches,
   ``dp``, the bundled corpus through the word tokenizer. Every
   task must reach its steps; the two traces (search, orchestrate) must
   name the flash forward, dQ, dK/dV and the CE forward, dx and dW kernels
   as often as the launch counters counted them over the run (a trace
   short of a count, lost events, is taken again once); their bytes and
   export seconds are printed. d) a user's script defines a ``dp``
   subclass in its ``__main__`` and registers it under
   ``SATURN_TPU_LIBRARY_PATH``, beside two JAX-format ``.udp`` files; a
   second process retrieves it by name (the ``.udp`` files left alone) and
   trains GPT-2-small (at TECHNIQUE_LAYERS of its 12 layers, cut in depth
   only) with it through ``search`` and ``orchestrate``. e)
   GPT-2-small at PRETRAINED_LAYERS of its 12 layers (cut in depth only)
   from an HF ``GPT2LMHeadModel``-named fp32 state dict (seeded numpy,
   50257 rows, 1024 positions): the first dp step's loss (bf16,
   flash, fused head) within PRETRAINED_LOSS_REL of the same ingested
   model's f32 loss on the CPU and at least PRETRAINED_CONTROL times that
   far from a random init's, then ``search`` and ``orchestrate``. f) GPT-J-6B at
   GPTJ_HF_LAYERS layers from an HF ``GPTJForCausalLM``-named fp16 state
   dict (HF's 50400 embedding rows, so vocab_size 50432; about 1.6 GB):
   offload bulk and dp over the logits from it, losses within OFFLOAD_REL,
   exact flash launches at head dim 256; its logits within BF16_BAND (by
   relative norm) of a plain f32 forward with HF's interleaved rotary,
   and at least WRONG_ROTARY_MIN times further from one that rotates split
   halves of HF's lanes (what ingest without the lane permutation gives).
10. Fused stacking and co-scheduled interleaving (``parallel/fused.py``,
   the engine's group launchers), GPT-2-small at FUSED_LAYERS of its 12
   layers (cut in depth only), ``dp``, flash and the fused head. a)
   ``search`` on four b8 x 512 tasks that differ only in lr (FUSED_LRS;
   profile cache seeded from phases 6 and 7's entries of that depth): one fusion group
   measured, every member's ``fused_per_batch_time`` and every solo
   trial's ``host_fraction`` set; the lockstep time against four times the
   solo per-batch time, and whether the solver's pricing fuses the group
   (at b8 x 512 it need not). b) the
   stacked program against four solo runs from
   the same init and batches (an eager step, then one window of 8, a CUDA
   graph): losses and final params within FUSED_LOSS_REL / FUSED_PARAM_REL
   (the log says whether bitwise), the stacked window's launches exactly
   one per layer and lockstep step of each flash kernel and 4 of each CE
   kernel, its peak
   memory. c) the same sweep at b2 x 512 (FUSED_SMALL_BATCH rows a member,
   where stacking pays): its search, whose
   pricing must fuse the group, then ``orchestrate`` of the four with a
   journal and a metrics file, in two intervals: the first plan fuses them
   and passes the
   verifier, the journal replays strictly, every checkpoint reaches
   FUSED_BATCHES (one write per fused interval), ``fused_interval`` events
   cover every member, the launches are exact; the solver's fused makespan
   against its solo one. d) four tasks over the logits
   (``nan_on_mark_loss``) at SWEEP_LAYERS (phase 6's depth, whose profile
   entry their search reuses) in a hand-built fused plan through
   ``engine.execute``: member 3's batch UNFUSE_MARKED is marked, member 2
   detaches after the first window. Member 3 faults alone and writes
   nothing, members 0 and 1 commit, member 2 is unfused (a synchronous
   write at its step), resumes solo from it and ends at its budget with no
   lost or repeated step (``check_writes``); launches exact. e) a
   GPT-2-small and a BERT-base task (at FUSED_LAYERS) in a hand-built
   co-schedule plan
   (verified) through ``engine.execute``: both losses and checkpoints
   bitwise equal to their solo runs; the interleaved wall time against the
   serial one, the measured host fractions, and whether ``solve`` would
   co-locate the pair at ``coschedule_min_gain``. Phase 10c's launches join
   phases 3, 14 and 6's in the kernels line.
11. Fault injection, fleet health and elastic recovery
   (``saturn_tpu_torch/resilience/``, the engine's fault hooks), two
   GPT-2-small tasks (b8 x 512 at FAULT_LAYERS of its 12 layers, cut in
   depth only, ``dp``, flash and the fused head, FAULT_BATCHES batches each,
   differing only in lr; searched once, profile cache seeded from phase 7's
   entry of that depth; each run trains clones). a) the seed
   CHAOS_SEED campaign (``run_campaign``) of the four health-fault classes
   (a NaN and a 1e9 spike in the observed loss, a poisoned batch, a
   CHAOS_STALL_S dispatch stall) with the sentinel's spike screen on, a
   guardian whose watchdog deadline (CHAOS_WATCHDOG) is below the stall,
   and a kill at ``post-rollback``: both tasks complete across one restart,
   the poisoned batch is quarantined and the journal replays the
   quarantine, a hung dispatch and a numeric fault were seen, every final
   checkpoint equals byte for byte (``compare_checkpoints``) that of a
   fault-free run with the quarantine applied beforehand, each task writes
   one checkpoint per interval that ran to its end, and the launches are
   exact (12 of each flash kernel and 1 of each CE kernel per step run,
   discarded runs included). b) a drill through ``SATURN_TPU_FAULTS``: a
   ``trial_crash`` at interval 0, ``device_loss`` of device 0 at interval
   1 + DRILL_AFTER_SHARE of the unfaulted run's first launch,
   ``device_return`` at interval 2 (``SATURN_TPU_GROW_HYSTERESIS=1``), a
   ``straggler`` of DRILL_SLOWDOWN at interval 3. Checked: the crash costs
   one retry and the preemption none; the run under the loss is discarded
   (no checkpoint write) and its task requeued; the poll at interval 2
   reports a grow gaining device 0 (journaled ``grow_event``; on one device
   the loss no poll saw cancels into a grow, the JAX package's rule) and
   the re-plan passes the verifier as ``migration-replan``; the straggler
   raises no degrade (one device has no median); every checkpoint is at
   its budget, bitwise the unfaulted run's, the journal replays strictly
   with each task's batches once; the launches are exact. Printed: the
   campaign's faults and discarded runs, ``replan_latency_s``, the seconds
   of discarded work, the faulted run's wall time against the unfaulted
   one's. Its launches join the kernels line.
12. The online job service (``saturn_tpu_torch.serve``, ``SaturnService``):
   GPT-2-small jobs at FAULT_LAYERS of its 12 layers (cut in depth only;
   b8 x 512, ``dp``, flash and the fused head, SERVICE_BATCHES batches
   each, differing only in lr), the profile cache seeded from phase 7's
   entry of that depth, the interval SERVICE_INTERVAL_SHARE
   of a job's profiled runtime. a) an uninterrupted service with a journal
   and a metrics file: the client submits A (priority 1); once A runs, L
   (priority 0) and H (priority 5) back to back; once both are admitted, C
   (priority 0), cancelled once admitted. Checked: every admission warm (0
   trials); H started before L; C evicted with "cancelled", never launched,
   no checkpoint, no live state; A, L and H done at step 16 with finite
   losses below the first, each over at least SERVICE_MIN_INTERVALS
   intervals; the journal replays strictly as one ``seq`` chain with the
   JAX service's record kinds, every committed plan passing the verifier
   (``audit_journal``); exact launches; ``stop()`` raises nothing. b) A, L
   and H again on a second journal, killed at SERVICE_KILL through
   ``run_to_kill`` (the injector armed before ``start()``); the dead
   service's writes joined and its states released, the memory allocated
   back where it was before a); a fresh ``SaturnService`` with a
   ``task_provider`` on the same journal: each remaining budget it hands
   the provider is 16 less the job's verified checkpoint step (a job whose
   checkpoint is at 16 comes back DONE), the live jobs re-admit warm, every
   job ends done with params and AdamW moments bitwise a)'s, the journal
   counts 16 batches a job over both incarnations, a recovery record each;
   launches exact in each incarnation, logged apart. c) ``python -m
   saturn_tpu_torch.service`` over a)'s metrics file, a child process, prints
   A, L and H DONE and C EVICTED. Printed: each job's submit, admission,
   start and end seconds, each re-solve's tier and seconds, the commit
   times, the service's wall time against the jobs' step time, the
   restart's replay, reconcile and re-admission seconds, the steps redone
   after the kill, the phase's time. a)'s launches join the kernels line.
12d. The network gateway (``service.gateway``, ``resilience.netchaos``):
   the service on the card with phase 12's interval rule (at GATEWAY_BATCHES
   a job), a ``GatewayServer`` on a loopback port and a ``GatewayClient``
   in this process. 1) Three GPT-2-small jobs (b8 x 512 at FAULT_LAYERS of
   its 12 layers, cut in depth only, dp; profile cache seeded
   from phase 7's entry of that depth) submitted with dedup keys through a seeded ``kill_ack`` proxy and waited
   for through a mixed-fault one: every job DONE at its budget with falling
   losses, one ``job_submitted`` per key, at least one ``kill_ack`` injected
   and the retried submit answered from the dedup table (a
   ``gateway_dedup_hit`` with the original id). 2) Two more jobs, of
   GATEWAY_KILL_BATCHES (more than an interval runs); the first, once it
   ran, cancelled over the wire while the loop waits at its
   ``mid-interval`` barrier, then the service killed there (a
   ``CrashInjector``), before the boundary that would sweep the job; a
   fresh service and gateway on the same journal hold it EVICTED
   ("cancelled"), rebuilt by no ``task_provider`` call and launched by
   nothing, the other job's resubmit gets its original id, is handed its
   budget less its checkpoint's step and ends DONE, and the drain journals
   ``gateway_drain``. Launches exact in each incarnation; the journal
   replays strictly with the JAX service's record kinds and the gateway's,
   every plan verified. Printed: the submit -> ACK seconds over the wire
   and the share of them in ``queue.submit`` (its durable commit), the
   faults by class, dedup hits, sheds, the commit times, the wall time
   against the steps, the restart's replay, reconcile and re-admission
   seconds. Its launches join the kernels line.

12e. The compile-ahead pool (``tenancy/compile_ahead.py``, the service's
   ``compile_ahead``): two GPT-2-small jobs (b8 x 512 at FAULT_LAYERS of its
   12 layers, cut in depth only, ``dp``, flash and the fused head,
   CA_BATCHES batches each, differing only in lr; profile cache seeded from
   phase 7's entry of that depth) through a durable ``SaturnService``, once
   without a pool and once with ``CompileAheadPool(workers=1)``. Their task
   class's ``compile_ahead(topology)`` hands the pool the builds of
   CA_SOURCES (``prewarm_build``'s pairs, keyed by each library's digest
   name) at ADMIT, and its first model build takes them from the pool.
   Checked: both jobs DONE in each run; each build's ``requested``,
   ``ready`` and ``hit`` records in the journal, ``replay_service_state``'s
   ``compile_ahead`` fold equal to the records' counts, the ledger's
   ``hit_rate`` 1.0 with no miss; exact launches in each run; the losses
   and the final checkpoints with the pool bitwise those without. Printed:
   each job's admit -> first step seconds with and without the pool, the
   pool's ledger. The pool run's launches join the kernels line.
13. The digital twin (``saturn_tpu_torch/twin/``) on the card's host: it
   runs no kernel. a) the synth campaign (``CampaignConfig()``'s defaults,
   seed 7) and ``tests/test_twin.py``'s storm, each twice with
   ``SATURN_TPU_PARTITION_MAX=4`` and a TWIN_SOLVE_S solve deadline: the
   two runs' ``events.jsonl`` and ``ledger.json`` bitwise equal, no
   deadline miss, the storm's jobs all completed or failed. b) phase 12a's
   journal replayed in trace mode (one virtual device, 12a's interval and
   its measured per-batch time): every journaled submission once; printed,
   each job's submit -> done in the twin against the journal's, the
   makespan ratio, the tier and verdict share deltas (12a's metrics file is
   the tier reference), ``within_band`` and the terms outside the band (not
   gated: 12a's first intervals are host-bound, which the twin does not
   model).
14. Multi-device blocks, rehearsed on one card (run after phase 3, before
   the phases that write the most): a block whose positions name card 0
   more than once holds one model replica per position
   (``parallel/spmd_base.py``, ``parallel/collectives.py``). a) GPT-2-small
   b8 x 512 (12 layers, dp, flash, fused head, remat off) on two replicas
   against one replica at b8: an eager step then a window of 8, the first
   loss within MD_LOSS0_REL, the losses within MD_LOSS_REL and the
   parameters within MD_PARAM_REL by relative norm, the replicas bitwise
   equal after each unit, exactly twice one replica's launches, no
   device-to-host copy in a step; then BERT-base's first loss on two
   replicas against one at b8, on ``mlm_loss`` and on a padded MLM
   objective whose replicas count different labels, each through the fused
   head's parts and over the logits, within MD_LOSS0_REL. Printed: both
   GPT-2 runs' milliseconds per batch and peak memory (a rehearsal says
   nothing of the speed of several cards). b) ``search(prune=True)`` of a
   GPT-2-small task at MD_LAYERS over card 0 eight times: only the anchor
   sizes 1, 4 and 8 trialled (one step at a time, MD_SEARCH_ENV), size 2
   filled from the fit,
   ``parallel_trials`` resolved to 1, a topology signature apart from eight
   cards'; then ``orchestrate`` of its plan, verified, to its budget with
   exact launches. c) the same task on card 0 twice loses position 1 with
   no return during interval 1 (``seeded_schedule(MD_ELASTIC_SEED)``): the
   interval is discarded, the pool shrinks, the replanner synthesizes size
   1, the task restores its checkpoint onto one replica and ends at its
   budget with exact launches; printed, the seconds of work discarded and
   ``replan_latency_s``. d) 14a's GPT-2 run on cards 0 and 1 through NCCL,
   where the machine has two cards; else one line says it did not run (not
   a pass). 14b's and 14c's launches join the kernels line.
15. The sharded train state (``parallel/fsdp.py``, ``sharding.py``,
   ``ops/collective_matmul.py``, the manifest of ``utils/checkpoint.py``),
   rehearsed on one card (run after phase 14): a) GPT-2-small b8 x 512 (12
   layers, flash, remat off) under fsdp on card 0 twice against dp on the
   same block with its fused head off (the logits, fsdp's route at n > 1):
   an eager step then a window of 8, losses and parameters bitwise; the
   ZeRO-3 program (``overlap``) prefetched against serial, bitwise, its
   losses within MD_LOSS_REL of dp's; 12 launches of each flash kernel per
   replica and step and no CE launch in every run, no device-to-host copy
   in a step of fsdp and of the prefetched program. Printed: each run's
   milliseconds per batch and peak memory above what the card held before
   it (a rehearsal, not a claim). b) dp's state of a) (1.49 GB) written as
   a manifest and, for the write times, as the single ``torch.save`` file
   the port wrote before it, in turns (single, manifest, manifest,
   single); the manifest verifies and restores bitwise under fsdp at 2
   positions and dp at 1, each then takes an eager step and a window: fsdp
   bitwise dp's own state going on, dp at 1 (the fused head) within
   BF16_BAND (another loss route); a copy with a truncated shard file
   fails ``verify`` and its restore quarantines and raises. Printed: each
   write's host-copy and disk
   seconds and bytes. c) at FSDP_LAYERS (depth only): ``search`` with dp and
   fsdp registered over card 0 twice (trials one step at a time) and
   ``orchestrate`` of its plan to its budget, verified, launches exact; then
   14c's drill on an fsdp task (its search a hit of that cache): position 1 lost with no return in interval
   1, size 1 synthesized, the 2-position sharded state restored onto one
   position from the manifest, that interval's first loss bitwise an eager
   step from a copy of the checkpoint it read, launches exact; printed,
   ``replan_latency_s`` and the seconds of work discarded. d) NCCL's
   gather and reduce-scatter across cards 0 and 1 against their plain
   versions and a)'s check there, where the machine has two cards; else one
   line says it did not run (not a pass). 15c's launches join the kernels
   line.
16. Tensor parallelism (``parallel/tp.py``, ``spmd_base.tp_step_fns``,
   ``models/gpt2.tp_logits``, ``collectives.ModelGroup``), rehearsed on one
   card (run after phase 15): a) GPT-2-small b8 x 512 (12 layers, flash,
   remat off) under tp 2 x data 1 on card 0 twice against dp on the same
   block over the logits: an eager step then a window of 8, the 9 losses
   within MD_LOSS_REL and the parameters within MD_PARAM_REL by relative
   norm (the row-parallel partial products in bf16, their model-group sum
   and the bias add in fp32), every replicated leaf bitwise across the
   positions, each split leaf at its shard shape, every flash launch on
   H / tp heads, 12 launches of each flash kernel a position and step, no
   CE launch, no device-to-host copy; tp's ``overlap`` config bitwise
   fsdp's ZeRO-3 program (the same program at tp 2 x data 1). Printed:
   each run's milliseconds per batch and peak memory beside 15a's. b) at
   TP_LAYERS: tp 2 x data 2 with ``zero`` on card 0 four times (a leaf
   split over both axes), two steps, a manifest; restored under dp at 1
   and fsdp at 2 bitwise, one more step each, the first losses printed.
   c) at TP_LAYERS: ``search`` with dp, fsdp and tp over card 0 twice
   (trials one step at a time; dp and fsdp hit 15c's profile cache) and
   ``orchestrate`` of its plan to its budget, verified, launches exact;
   16c's launches join the kernels line. d) a) over cards 0 and 1 (the
   model group's NCCL sums), where the machine has two cards; else one line
   says it did not run (not a pass).

The last lines are the kernels JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Details go to ``chiprun_out/``.

    python3 chip_smoke.py --flash-sweep [--head-dim D] [--root DIR]

builds the kernels and only times the three flash kernels against SDPA's
forward and backward alone (dQ + dK/dV against the backward) over a sweep
of sequence lengths and batch sizes (``chiprun_out/flash_sweep.json``): how
their time scales with the work. Each time is the median of three profiled
windows, as phase 2 takes it, held to its bound (a time under it is taken
again, and flagged if it stays there). ``--head-dim`` keeps the sweep's rows at
that head dim. ``--root`` times the port of another checkout instead (a
``git archive`` of an earlier commit unpacked into a directory that
``.gitignore`` lists), built from its own sources and not held to this
script's SASS rules, into ``chiprun_out/flash_sweep_<DIR's name>.json``:
run it beside this tree's sweep in one call to compare two commits on one
card.

    python3 chip_smoke.py --staging-ab

builds the kernels and only times flash + fused at b8 x 512 with each
unit's batch staged inline, as ``execute`` stages it, against staging on a
second thread one unit ahead, in windows of 8 and one step at a time
(``chiprun_out/staging_ab.json``).

    python3 chip_smoke.py --offload

builds the kernels, checks them at head dim 256 and runs phase 8
(``chiprun_out/offload.json``).

    python3 chip_smoke.py --data

builds the kernels and runs phase 9 (``chiprun_out/data.json``).

    python3 chip_smoke.py --fused

builds the kernels and runs phase 10 (``chiprun_out/fused.json``).

    python3 chip_smoke.py --faults

builds the kernels and runs phase 11 (``chiprun_out/faults.json``).

    python3 chip_smoke.py --service

builds the kernels and runs phase 12 (``chiprun_out/service.json``; with
no phase 3 profile cache its template search runs the trials, and every
admission after it is warm).

    python3 chip_smoke.py --gateway

builds the kernels and runs phase 12d (``chiprun_out/gateway.json``, the
journal ``gateway_journal``, ``gateway_events.jsonl``).

    python3 chip_smoke.py --compile-ahead

builds the kernels and runs phase 12e (``chiprun_out/compile_ahead.json``;
with no phase 7 profile cache its template search runs the trials).

    python3 chip_smoke.py --twin

builds the kernels and runs phase 12 (13b's journal) and phase 13
(``chiprun_out/twin.json``, the campaigns under ``chiprun_out/twin/``).

    python3 chip_smoke.py --multi-device [--14a] [--14b] [--14c] [--14d]

builds the kernels and runs phase 14, or the sub-phases named
(``chiprun_out/multi_device.json``).

    python3 chip_smoke.py --fsdp [--15a] [--15b] [--15c] [--15d]

builds the kernels and runs phase 15, or the sub-phases named (15b runs
15a first; ``chiprun_out/fsdp.json``).

    python3 chip_smoke.py --tp [--16a] [--16b] [--16c] [--16d]

builds the kernels and runs phase 16, or the sub-phases named (without
phase 15's profile cache 16c runs every lane's trials; output in
``chiprun_out/tp.json``).

    python3 chip_smoke.py --fused-profile

builds the kernels and only profiles a stacked window of four GPT-2-small
members against a solo window at b8 and b2 x 512: the lockstep time
against four solo steps, and each kernel's device time in the stack less
four times a solo step's (``chiprun_out/fused_profile.json``).
"""

from __future__ import annotations

import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out")
CKPTS = os.path.join(REPO, "saturn_ckpts", "chip_smoke")
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
BF16_BAND = 2e-2           # the bf16 tolerance of tests/test_flash.py and tests/test_ce.py
FLASH_LSE_ATOL = 1e-5      # flash lse (f32) against the plain version, absolute
FLASH_O_ATOL = 2.0 ** -8   # flash o: one bf16 step of the plain value (rtol 2^-7) plus this
FLASH_GRAD_REL = 2e-3      # flash dq, dk and dv against the plain version, by relative norm
                           # (readings on an H100: lse at most 9.5e-7, gradients 4.4e-4)
CE_ROW_ATOL = 1e-4         # CE loss and lse (f32) against the plain version
CE_GRAD_REL = 2e-3         # CE dx and dW against the plain version, by relative norm
                           # (readings on an H100: at most 3.5e-4; loss and lse 7.6e-6)
STEPS_PINNED = 10
WINDOW = 8                 # the window of phases 4 and 5 (DEFAULT_MAX_WINDOW)
WINDOW_ATOL = 1e-5         # windowed against eager losses, absolute per step
INTERVAL_SHARE = 0.55      # phase 3: interval over the shortest task's profiled runtime
# The main path's shapes: GPT-2-small and BERT-base, b8 x 512.
DEVICE = "cuda"
GPT2, BERT = "gpt2-small", "bert-base"
BATCH, SEQ, VOCAB, LAYERS = 8, 512, 50304, 12
FLASH_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
CE_NAMES = ("ce_fwd", "ce_dx", "ce_dw")
KERNEL_NAMES = FLASH_NAMES + CE_NAMES
SOURCES = {
    "flash_fwd": "saturn_tpu/ops/flash.py:132",
    "flash_dq": "saturn_tpu/ops/flash.py:250",
    "flash_dkv": "saturn_tpu/ops/flash.py:276",
    "ce_fwd": "saturn_tpu/ops/ce.py:208",
    "ce_dx": "saturn_tpu/ops/ce.py:290",
    "ce_dw": "saturn_tpu/ops/ce.py:314",
}
#: How each kernel's launches begin in a profile (``csrc/flash_attn.cu``,
#: ``csrc/linear_ce.cu``).
KERNEL_SYMBOLS = {
    # fwd_kernel<64>, fwd_kernel<128>; fwd_pingpong_kernel at head dim 256
    "flash_fwd": ("(anonymous namespace)::fwd_kernel<",
                  "(anonymous namespace)::fwd_pingpong_kernel("),
    # dq_kernel<64>, dq_kernel<128>; dq_wide_kernel at head dim 256
    "flash_dq": ("(anonymous namespace)::dq_kernel<", "(anonymous namespace)::dq_wide_kernel("),
    # dkv_kernel<64>, dkv_kernel<128>; dkv_wide_kernel at head dim 256
    "flash_dkv": ("(anonymous namespace)::dkv_kernel<",
                  "(anonymous namespace)::dkv_wide_kernel("),
    "ce_fwd": ("(anonymous namespace)::ce_fwd_",),  # ce_fwd_sm90_kernel<, ce_fwd_combine_kernel
    # ce_dx_sm90_kernel<, ce_dx_reduce_kernel
    "ce_dx": ("(anonymous namespace)::ce_dx_",),
    "ce_dw": ("(anonymous namespace)::ce_dw_",),  # ce_dw_sm90_kernel<
}
#: A CE wrapper's second kernel (the forward's combine, dx's split-K
#: reduction): its time counts to the wrapper's, its launches do not.
SECOND_KERNELS = ("ce_fwd_combine_kernel", "ce_dx_reduce_kernel")
#: The recompute-mode ds kernel: ce_dx and ce_dw each launch it once per
#: vocab slab, just before the slab's product kernel.
DS_SYMBOL = "(anonymous namespace)::ce_ds_sm90_kernel"


def log(msg: str) -> None:
    print(msg, flush=True)


#: Instructions counted in each kernel's SASS: wgmma, TMA tile loads,
#: cp.async copies, mma.sync, setmaxnreg.
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA", "USETMAXREG")
#: Kernels whose SASS must hold wgmma and TMA tile loads, by source.
WGMMA_KERNELS = {"flash_attn": ("fwd_kernel", "fwd_pingpong_kernel", "dq_kernel",
                                "dq_wide_kernel", "dkv_kernel", "dkv_wide_kernel"),
                 "linear_ce": ("ce_fwd_sm90_kernel", "ce_ds_sm90_kernel", "ce_dx_sm90_kernel",
                               "ce_dw_sm90_kernel")}
#: Of those, the kernels whose SASS must also hold setmaxnreg (their
#: producer gives registers to their consumers), by source.
SETMAXREG_KERNELS = {"flash_attn": ("fwd_pingpong_kernel", "dq_wide_kernel", "dkv_wide_kernel")}


def sass_kernel_name(fn: str):
    """(kernel name, its int or bool template arguments as digits joined by
    commas, or None) of a mangled SASS function name, or (fn, None) when it
    names no ``*_kernel``."""
    m = re.search(r"((?:ce_)?[a-z]+(?:_[a-z]+)?(?:_sm90)?_kernel)(?:I((?:L[ib]\d+E)+)E)?", fn)
    if not m:
        return fn, None
    return m.group(1), ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) if m.group(2) else None


def sass_counts(sass: str):
    """{mangled function name: {op: count}} of SASS_OPS in a SASS dump."""
    ops, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            ops[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                ops[fn][op] += op in line
    return ops


def check_sass(cuda_build, src: str) -> None:
    """Log, per kernel of the built library, how many of each SASS_OPS
    instruction its SASS holds (``cuobjdump --dump-sass``); raise if a kernel
    of WGMMA_KERNELS[src] is missing or holds no HGMMA or no UTMALDG, or one
    of SETMAXREG_KERNELS[src] holds no USETMAXREG."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(cuda_build.library_path(src))], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    with open(os.path.join(OUT, f"sass_{src}.txt"), "w") as f:
        f.write(sass)
    required, seen = set(WGMMA_KERNELS.get(src, ())), set()
    for fn, counts in sorted(sass_counts(sass).items()):
        base, arg = sass_kernel_name(fn)
        name = f"{base}<{arg}>" if arg else base
        log(f"    SASS {src} {name}: " + ", ".join(f"{op} {n}" for op, n in counts.items()))
        if base in required:
            seen.add(base)
            missing = [op for op in ("HGMMA", "UTMALDG")
                       + (("USETMAXREG",) if base in SETMAXREG_KERNELS.get(src, ()) else ())
                       if not counts[op]]
            if missing:
                raise AssertionError(f"{name} in {src}: no {' or '.join(missing)} in its SASS")
    if seen != required:
        raise AssertionError(f"no SASS found for {required - seen} in {src}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def topology():
    from saturn_tpu_torch.core.mesh import SliceTopology

    return SliceTopology()


def events_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` between two CUDA events: device
    time plus whatever host work between launches the device waits for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_events(prof):
    """(name, start us, end us) of every kernel, copy and memset that
    torch.profiler recorded on the card (annotation ranges left out)."""
    from torch.autograd import DeviceType

    return sorted(
        ((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
         if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)),
        key=lambda x: x[1])


class LaunchShapeError(AssertionError):
    """A CE wrapper's kernels ran in a sequence that is no run of launches."""


def ce_run_launches(name: str, run: str) -> int:
    """Launches of the CE wrapper ``name`` in ``run``, the kinds of an
    unbroken run of its events in order: "d" the ds kernel, "p" its product
    kernel, "s" its second kernel. A launch is "p" or "ps" (the forward, and
    stash mode's backward), or "dp" once per vocab slab and then "s" where
    the wrapper has one (recompute mode); a recompute-mode launch that no
    "s" ends ends the run, and one run holds launches of one mode. Any other
    sequence raises: a product with no ds before it in a slab loop, two ds
    in a row, a second kernel with no product before it. Two stash-mode
    products in a row are two launches, which the exact launch counts catch
    where one call ran its kernel twice."""
    if not re.fullmatch(r"(?:ps?)+|(?:(?:dp)+s)*(?:dp)*", run):
        raise LaunchShapeError(f"{name}: its kernels ran as {run!r} (d ds, p product, s second "
                             f"kernel), not as launches of p[s] or (dp)+[s]")
    return len(re.findall(r"(?:dp)+s?|ps?", run))


def step_kernels(events, n: int):
    """{kernel name: {launches_per_step, device_ms_per_step}} of the device
    events of ``n`` profiled steps, in order, each kernel found by
    KERNEL_SYMBOLS; a ds kernel (DS_SYMBOL) belongs to the CE wrapper of the
    next CE event. Each flash event is one launch of its wrapper. A CE
    wrapper's launches are counted over each run of its events with no other
    CE event between them, by ``ce_run_launches``: the time of its ds and
    second kernels counts to the wrapper, their launches do not."""
    owner = [next((name for name, symbols in KERNEL_SYMBOLS.items()
                   if any(s in e for s in symbols)), None) for e, _, _ in events]
    follows = None  # the CE wrapper of the next CE event
    for i in reversed(range(len(events))):
        if DS_SYMBOL in events[i][0]:
            if follows is None:
                raise LaunchShapeError(f"a ds kernel at {events[i][1]} us with no CE kernel "
                                       f"after it")
            owner[i] = follows
        elif owner[i] in CE_NAMES:
            follows = owner[i]
    launches, device_us = dict.fromkeys(KERNEL_SYMBOLS, 0), dict.fromkeys(KERNEL_SYMBOLS, 0.0)
    runs = []  # [CE wrapper, kinds of its events] of each unbroken run
    for (e, a, b), name in zip(events, owner):
        if name is None:
            continue
        device_us[name] += b - a
        if name not in CE_NAMES:
            launches[name] += 1
            continue
        kind = ("d" if DS_SYMBOL in e else "s" if any(s in e for s in SECOND_KERNELS)
                else "p")
        if runs and runs[-1][0] == name:
            runs[-1][1] += kind
        else:
            runs.append([name, kind])
    for name, run in runs:
        launches[name] += ce_run_launches(name, run)
    return {name: {"launches_per_step": launches[name] / n,
                   "device_ms_per_step": device_us[name] / 1e3 / n} for name in KERNEL_SYMBOLS}


def busy_ms(events) -> float:
    """Milliseconds of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, a, b in events:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


class NoDeviceActivity(AssertionError):
    """A profiled window in which torch.profiler saw no device work."""


def profiled(fn, n: int, attempts: int = 5):
    """Run ``fn`` ``n`` times under torch.profiler, synchronized at the end;
    returns the device events. One more call runs first under the profiler
    as its warm-up step, synchronized and not recorded: on one card the
    tracer lost the same launch of every window that began with the
    recorded calls (a flash forward of 48, three windows running).
    torch.profiler now and then records none of a window's device work,
    sometimes several windows running: such a window is taken again, up to
    ``attempts`` windows in all, and then this raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(attempts):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = device_events(prof)
        if events:
            return prof, events
    raise NoDeviceActivity(f"torch.profiler recorded no device activity in {attempts} windows")


SHORT_PROFILES: list = []  # every profile short of its launch count, for chip_smoke.json


def counted_profile(fn, calls: int, steps: int, want, label: str, attempts: int = 3):
    """``profiled(fn, calls)``, ``steps`` training steps in all, whose
    kernels' launches per step must be ``want`` (``step_kernels``); returns
    (prof, events, kernels). Every launch of a
    step or a graph replay happens, so a count below the want in one profile
    is a lost trace event (seen on the card: 287 of 288): that profile is
    recorded in SHORT_PROFILES (which kernels, seen against wanted) and
    taken again, up to ``attempts`` in all; a count above the want raises
    at once, as does a count still short after the last attempt. A profile
    whose CE kernels ran out of shape (``LaunchShapeError``: a lost ds or
    product event looks like one) is recorded and taken again the same way,
    and raises if the last attempt is out of shape too."""
    for attempt in range(attempts):
        prof, events = profiled(fn, calls)
        try:
            kernels = step_kernels(events, steps)
        except LaunchShapeError as e:
            SHORT_PROFILES.append({"label": label, "attempt": attempt + 1, "steps": steps,
                                   "out_of_shape": str(e)})
            if attempt == attempts - 1:
                raise
            log(f"  {label}: profile {attempt + 1} out of shape ({e}); taking it again")
            continue
        seen = {name: k["launches_per_step"] for name, k in kernels.items()}
        if seen == want:
            return prof, events, kernels
        SHORT_PROFILES.append({"label": label, "attempt": attempt + 1, "steps": steps,
                               "short": {x: [seen[x], want[x]] for x in want
                                         if seen[x] != want[x]}})
        if any(seen[x] > want[x] for x in want) or attempt == attempts - 1:
            raise AssertionError(f"{label}: the profiler saw {seen} launches per step, "
                                 f"want {want}")
        log(f"  {label}: profile {attempt + 1} lost trace events ({seen} launches per "
            f"step); taking it again")


def device_ms(fn, n: int = 20, warmup: int = 3, windows: int = 3) -> float:
    """Device milliseconds per call of ``fn``: the union of its kernels',
    copies' and memsets' intervals over ``n`` profiled calls, divided by
    ``n``; the median of ``windows`` such windows, which leaves out a window
    whose device events the profiler partly lost. Host work between launches
    (argument checks, allocation, the ctypes call, autograd's bookkeeping) is
    left out. Where the profiler records nothing at all, the time between
    CUDA events instead (host dispatch included), and a line says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        try:
            times.append(busy_ms(profiled(fn, n)[1]) / n)
        except NoDeviceActivity as e:
            log(f"  ({e}: this time is between CUDA events, host dispatch included)")
            return events_ms(fn, n, warmup=0)
    return float(np.median(times))


def bound(flops: float, nbytes: float):
    """(bound ms, what sets it) on the card."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_rows(rows, timings, work, lib_label):
    """Device, event and plain times, bound and library time of each kernel."""
    for name, (fn, plain, lib_ms) in timings.items():
        flops, nbytes = work[name]
        bound_ms, bound_by = bound(flops, nbytes)
        rows[name].update(
            ms=device_ms(fn), events_ms=events_ms(fn), plain_ms=device_ms(plain, n=5),
            library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
        )
        r = rows[name]
        log(f"  {name}: device {r['ms']:.4f} ms (between CUDA events, host dispatch "
            f"included: {r['events_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; "
            f"{lib_label(name)} {lib_ms:.4f} ms), bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}")


# ------------------------------------------------------------------ phase 2
def kernel_inputs(B, H, KV, T, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn((n, T, D), generator=g, device="cuda").to(torch.bfloat16)
    return mk(B * H), mk(B * KV), mk(B * KV), mk(B * H)


def work(B, H, KV, T, D, causal):
    """(FLOPs, bytes) per kernel for these inputs: products over the (q, k)
    pairs the mask keeps, each input read once and each output written once."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    q_bytes, kv_bytes, row_bytes = B * H * T * D * 2, B * KV * T * D * 2, B * H * T * 4
    return {
        "flash_fwd": (4 * D * pairs, q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        "flash_dq": (6 * D * pairs, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes),
        "flash_dkv": (8 * D * pairs, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + 2 * kv_bytes),
        # the whole backward as one function (SDPA's backward alone): the five
        # products S, dP, dV, dK, dQ; dq, dk and dv written once
        "flash_bwd": (10 * D * pairs,
                      2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes + 2 * kv_bytes),
    }


def check_kernels(flash, shape, causal, seed, timed):
    """Each kernel against its plain version on the same inputs; with
    ``timed``, also the times. Returns {name: row}.

    Tolerances: lse (f32, the same arithmetic in another order) within
    FLASH_LSE_ATOL; o within one bf16 step of the plain value (rtol 2^-7)
    plus FLASH_O_ATOL: both versions round P to bf16, the kernel at each
    tile's running max, the plain version at the final one; dq, dk and dv by
    relative norm within FLASH_GRAD_REL."""
    B, H, KV, T, D = shape
    q, k, v, do = kernel_inputs(B, H, KV, T, D, seed)
    o, lse = flash.flash_fwd(q, k, v, causal, H, KV)
    o_ref, lse_ref = flash.flash_fwd_reference(q, k, v, causal, H, KV)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash.flash_dq(q, k, v, do, lse, delta, causal, H, KV)
    dk, dv = flash.flash_dkv(q, k, v, do, lse, delta, causal, H, KV)
    dq_ref = flash.flash_dq_reference(q, k, v, do, lse, delta, causal, H, KV)
    dk_ref, dv_ref = flash.flash_dkv_reference(q, k, v, do, lse, delta, causal, H, KV)
    torch.cuda.synchronize()
    where = f"(B,H,KV,T,D)={shape} causal={causal}"
    for name, got in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash {name} {where}: non-finite output")
    torch.testing.assert_close(lse, lse_ref, rtol=0.0, atol=FLASH_LSE_ATOL,
                               msg=lambda m: f"flash lse {where}: {m}")
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=2.0 ** -7, atol=FLASH_O_ATOL,
                               msg=lambda m: f"flash o {where}: {m}")
    rel = {"dq": rel_err(dq, dq_ref), "dk": rel_err(dk, dk_ref), "dv": rel_err(dv, dv_ref)}
    bad = {n: r for n, r in rel.items() if not r <= FLASH_GRAD_REL}
    if bad:
        raise AssertionError(f"flash {where}: relative errors {bad} above {FLASH_GRAD_REL}")
    err = {n: (got.float() - want.float()).abs().max().item()
           for n, got, want in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                                ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
    # what the o check needs beyond one bf16 step: max(|err| - 2^-7 |plain|)
    o_excess = ((o.float() - o_ref.float()).abs() - 2.0 ** -7 * o_ref.float().abs()).max().item()
    rows = {
        "flash_fwd": {"max_abs_err": max(err["o"], err["lse"]), "o_max_abs_err": err["o"],
                      "lse_max_abs_err": err["lse"], "o_beyond_one_step": o_excess},
        "flash_dq": {"max_abs_err": err["dq"], "rel_err": rel["dq"]},
        "flash_dkv": {"max_abs_err": max(err["dk"], err["dv"]), "rel_err": max(rel["dk"], rel["dv"])},
    }
    log(f"  flash kernels vs plain at {where}: max|err| "
        + ", ".join(f"{n} {e:.3e}" for n, e in err.items())
        + f"; o beyond one bf16 step {o_excess:.3e} (within {FLASH_O_ATOL:g}), lse within "
        + f"{FLASH_LSE_ATOL:g}; relative " + ", ".join(f"{n} {r:.3e}" for n, r in rel.items())
        + f" (within {FLASH_GRAD_REL:g})")
    if not timed:
        return rows

    q4, k4, v4 = (t.view(B, -1, T, D) for t in (q, k, v))
    sdpa_kw = {"is_causal": causal, **({"enable_gqa": True} if KV != H else {})}
    q4g = q4.detach().clone().requires_grad_(True)
    k4g = k4.detach().clone().requires_grad_(True)
    v4g = v4.detach().clone().requires_grad_(True)
    do4 = do.view(B, H, T, D)

    out4 = F.scaled_dot_product_attention(q4g, k4g, v4g, **sdpa_kw)  # the graph, built once

    def sdpa_bwd():
        torch.autograd.grad(out4, (q4g, k4g, v4g), do4, retain_graph=True)

    sdpa_fwd_ms = device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, **sdpa_kw))
    sdpa_bwd_ms = device_ms(sdpa_bwd)
    timings = {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, causal, H, KV),
                      lambda: flash.flash_fwd_reference(q, k, v, causal, H, KV), sdpa_fwd_ms),
        "flash_dq": (lambda: flash.flash_dq(q, k, v, do, lse, delta, causal, H, KV),
                     lambda: flash.flash_dq_reference(q, k, v, do, lse, delta, causal, H, KV),
                     sdpa_bwd_ms),
        "flash_dkv": (lambda: flash.flash_dkv(q, k, v, do, lse, delta, causal, H, KV),
                      lambda: flash.flash_dkv_reference(q, k, v, do, lse, delta, causal, H, KV),
                      sdpa_bwd_ms),
    }
    time_rows(rows, timings, work(B, H, KV, T, D, causal),
              lambda n: "SDPA " + ("fwd" if n == "flash_fwd" else "bwd alone"))
    log_backward_family("flash dq + dkv", rows["flash_dq"]["ms"] + rows["flash_dkv"]["ms"],
                        "SDPA's backward alone", sdpa_bwd_ms)
    return rows


def log_backward_family(kernels, kernels_ms, library, library_ms) -> None:
    """One line comparing a family's summed backward kernels with the
    library's backward alone (device times)."""
    log(f"  {kernels}: {kernels_ms:.4f} ms against {library} {library_ms:.4f} ms "
        f"({kernels_ms / library_ms:.2f}x)")


def ce_work(N, D, V, stash):
    """(FLOPs, bytes) per CE kernel: one product pass of 2 N V D (two in the
    recompute-mode backward), each input read once, each output written once."""
    ops = 2 * N * V * D
    x_b, w_b, s_b, row_b, dw_b = N * D * 2, V * D * 2, N * V * 2, N * 4, V * D * 4
    passes = 1 if stash else 2
    return {
        "ce_fwd": (ops, x_b + w_b + row_b + 2 * row_b + (s_b if stash else 0)),
        "ce_dx": (passes * ops, (s_b if stash else x_b) + w_b + 3 * row_b + x_b),
        "ce_dw": (passes * ops, (s_b if stash else w_b) + x_b + 3 * row_b + dw_b),
    }


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over all elements, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def check_ce(ce, N, D, V, stash, seed, tail, timed):
    """The CE kernels against their plain versions: x ~ N(0, 1), W ~
    N(0, 0.05) in bf16, the cotangent of a summed loss (1 per counted row).

    Tolerances: loss and lse (f32, the same arithmetic in another order)
    within CE_ROW_ATOL absolute; the bf16 stash within one bf16 step of the
    plain value (rtol 2^-7) plus CE_ROW_ATOL; dx and dW by relative norm,
    within CE_GRAD_REL. The one-hot term dominates both gradients here (in
    dW, -x summed into the label rows; the softmax part is spread thin over
    all V rows), so dx and dW are also compared with every label ignored and
    g = 1: the softmax part alone, by relative norm within CE_GRAD_REL. In
    recompute mode the first rows' labels sit at the first and last column
    of each vocab slab (``slab_labels``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((N, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device=DEVICE) * 0.05).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=gen, device=DEVICE, dtype=torch.int32)
    if not stash:
        edges = slab_labels(ce, N, V)
        labels[:len(edges)] = edges
    if tail:
        labels[-tail:] = -1
    g = (labels >= 0).float()
    loss, lse, s = ce.ce_fwd(x, w, labels, stash)
    dx = ce.ce_dx(x, w, labels, lse, g, s)
    dw = ce.ce_dw(x, w, labels, lse, g, s)
    loss_r, lse_r, s_r = ce.ce_fwd_reference(x, w, labels, stash)
    dx_r = ce.ce_dx_reference(x, w, labels, lse, g, s_r)
    dw_r = ce.ce_dw_reference(x, w, labels, lse, g, s_r)
    none, ones = torch.full_like(labels, -1), torch.ones_like(g)
    soft = (ce.ce_dx(x, w, none, lse, ones, s), ce.ce_dw(x, w, none, lse, ones, s))
    soft_r = (ce.ce_dx_reference(x, w, none, lse, ones, s_r),
              ce.ce_dw_reference(x, w, none, lse, ones, s_r))
    torch.cuda.synchronize()
    where = f"N={N} V={V} {'stash' if stash else 'recompute'}"
    for name, t in (("loss", loss), ("lse", lse), ("dx", dx), ("dw", dw), ("softmax dx", soft[0]),
                    ("softmax dw", soft[1])) + ((("stash", s),) if stash else ()):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"ce {name} {where}: non-finite output")
    counted = dx[:N - tail].float().abs().sum(1)
    if tail and torch.count_nonzero(dx[-tail:]) or not (counted > 0).all():
        raise AssertionError(f"ce {where}: an ignored row got a gradient or a counted row none")
    errs = {}
    for name, got, want in (("loss", loss, loss_r), ("lse", lse, lse_r)):
        torch.testing.assert_close(got, want, rtol=0.0, atol=CE_ROW_ATOL,
                                   msg=lambda m: f"ce {name} {where}: {m}")
        errs[name] = (got - want).abs().max().item()
    if stash:
        torch.testing.assert_close(s.float(), s_r.float(), rtol=2.0 ** -7, atol=CE_ROW_ATOL,
                                   msg=lambda m: f"ce stash {where}: {m}")
        errs["stash"] = (s.float() - s_r.float()).abs().max().item()
    rel = {"dx": rel_err(dx, dx_r), "dw": rel_err(dw, dw_r),
           "softmax dx": rel_err(soft[0], soft_r[0]), "softmax dw": rel_err(soft[1], soft_r[1])}
    bad = {k: v for k, v in rel.items() if not v <= CE_GRAD_REL}
    if bad:
        raise AssertionError(f"ce {where}: relative errors {bad} above {CE_GRAD_REL}")
    errs["dx"] = (dx.float() - dx_r.float()).abs().max().item()
    errs["dw"] = (dw - dw_r).abs().max().item()
    rows = {
        "ce_fwd": {"max_abs_err": max(errs[k] for k in ("loss", "lse", "stash") if k in errs),
                   "loss_lse_max_abs_err": max(errs["loss"], errs["lse"]),
                   "stash_max_abs_err": errs.get("stash")},
        "ce_dx": {"max_abs_err": errs["dx"], "rel_err": rel["dx"],
                  "softmax_rel_err": rel["softmax dx"]},
        "ce_dw": {"max_abs_err": errs["dw"], "rel_err": rel["dw"],
                  "softmax_rel_err": rel["softmax dw"]},
    }
    log(f"  CE kernels vs plain at D={D} {where} (ignored tail {tail}): max|err| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (loss, lse within {CE_ROW_ATOL:g}" + ("; stash within 2^-7 relative" if stash else "")
        + "); relative "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" (within {CE_GRAD_REL:g})")
    if not timed:
        return rows

    lab64 = labels.long()
    xg, wg = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)

    def lib_fwd():
        return F.cross_entropy(F.linear(x, w).float(), lab64, ignore_index=-1, reduction="none")

    lib_out = F.cross_entropy(F.linear(xg, wg).float(), lab64, ignore_index=-1,
                              reduction="none")  # the graph, built once

    def lib_bwd():
        torch.autograd.grad(lib_out, (xg, wg), g, retain_graph=True)

    lib_fwd_ms, lib_bwd_ms = device_ms(lib_fwd), device_ms(lib_bwd)
    timings = {
        "ce_fwd": (lambda: ce.ce_fwd(x, w, labels, stash),
                   lambda: ce.ce_fwd_reference(x, w, labels, stash), lib_fwd_ms),
        "ce_dx": (lambda: ce.ce_dx(x, w, labels, lse, g, s),
                  lambda: ce.ce_dx_reference(x, w, labels, lse, g, s_r), lib_bwd_ms),
        "ce_dw": (lambda: ce.ce_dw(x, w, labels, lse, g, s),
                  lambda: ce.ce_dw_reference(x, w, labels, lse, g, s_r), lib_bwd_ms),
    }
    time_rows(rows, timings, ce_work(N, D, V, stash),
              lambda n: "linear + cross_entropy " + ("fwd" if n == "ce_fwd" else "bwd alone"))
    log_backward_family(f"ce dx + dw ({'stash' if stash else 'recompute'})",
                        rows["ce_dx"]["ms"] + rows["ce_dw"]["ms"],
                        "linear + cross_entropy's backward alone", lib_bwd_ms)
    del lib_out
    # cuBLAS on each product alone: yardsticks, not the kernels' library call
    ms = device_ms(lambda: torch.matmul(x, w.t()))
    rows["ce_fwd"]["cublas_product_ms"] = ms
    log(f"  cuBLAS yardstick for ce_fwd's product: torch.matmul of the (N, D) x by the "
        f"(D, V) Wᵀ, bf16 (N, V) out: {ms:.4f} ms (ce_fwd {rows['ce_fwd']['ms']:.4f} ms)")
    if stash:
        ms = device_ms(lambda: torch.matmul(s, w))  # the bf16 (N, V) stash as ds
        rows["ce_dx"]["cublas_product_ms"] = ms
        log(f"  cuBLAS yardstick for ce_dx's product: torch.matmul of the bf16 (N, V) stash by "
            f"the (V, D) W, bf16 out: {ms:.4f} ms (ce_dx {rows['ce_dx']['ms']:.4f} ms)")
        ds_t = s.t()  # a bf16 (V, N) operand laid out as the kernel reads dsᵀ
        ms = device_ms(lambda: torch.matmul(ds_t, x))
        rows["ce_dw"]["cublas_product_ms"] = ms
        log(f"  cuBLAS yardstick for ce_dw's product: torch.matmul of the bf16 (V, N) dsᵀ by "
            f"the (N, D) x, bf16 out: {ms:.4f} ms (ce_dw {rows['ce_dw']['ms']:.4f} ms)")
    return rows


def slab_edges(ce, N, V):
    """(first, last column + 1) of each vocab slab of recompute mode at N x V."""
    vs = ce.slab_width(N, V)
    return [(v0, min(V, v0 + vs)) for v0 in range(0, V, vs)]


def slab_labels(ce, N, V):
    """The first and the last column of each vocab slab, as int32 labels."""
    return torch.tensor([c for v0, v1 in slab_edges(ce, N, V) for c in (v0, v1 - 1)],
                        dtype=torch.int32, device=DEVICE)


def check_ds(ce, N, D, V, seed, timed):
    """The recompute-mode ds kernel alone (``ce.ce_ds_slab``) against its
    plain version on one vocab slab: the second slab of
    ``ce.slab_width(N, V)`` columns (the first where one holds the whole
    vocab), labels at the edge
    columns of every slab, a non-uniform g and an ignored tail of N / 16
    rows. Both form ds in f32 and round it to bf16 once: within one bf16
    step of the plain value (rtol 2^-7), and 2^-126 absolute, since ex2.approx
    flushes what falls below the smallest normal float to 0. With ``timed``,
    the kernel over the whole vocab as one slab (the work of every slab of a
    recompute-mode backward kernel) beside its bound and its plain version."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((N, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device=DEVICE) * 0.05).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=gen, device=DEVICE, dtype=torch.int32)
    edges = slab_labels(ce, N, V)
    labels[:len(edges)] = edges
    labels[N - N // 16:] = -1
    g = (torch.rand((N,), generator=gen, device=DEVICE) * 1.9 + 0.1) * (labels >= 0)
    _, lse, _ = ce.ce_fwd(x, w, labels, False)
    slabs = slab_edges(ce, N, V)
    v0, v1 = slabs[1] if len(slabs) > 1 else slabs[0]
    ds = ce.ce_ds_slab(x, w, labels, lse, g, v0, v1)
    want = ce.ce_ds_slab_reference(x, w, labels, lse, g, v0, v1)
    torch.cuda.synchronize()
    where = f"N={N} D={D} V={V} slab {v0}:{v1}"
    if ds.shape != want.shape or ds.dtype != torch.bfloat16 or not torch.isfinite(ds.float()).all():
        raise AssertionError(f"ce ds {where}: {ds.shape} {ds.dtype} against {want.shape}, or "
                             f"non-finite")
    torch.testing.assert_close(ds.float(), want.float(), rtol=2.0 ** -7, atol=2.0 ** -126,
                               msg=lambda m: f"ce ds {where}: {m}")
    err = (ds.float() - want.float()).abs().max().item()
    row = {"slab": [v0, v1], "max_abs_err": err, "rel_err": rel_err(ds, want)}
    log(f"  CE ds kernel vs plain at {where}: max|err| {err:.3e}, relative {row['rel_err']:.3e} "
        f"(within one bf16 step)")
    if not timed:
        return row
    ops = 2 * N * V * D
    nbytes = N * D * 2 + V * D * 2 + 3 * N * 4 + N * V * 2
    bound_ms, bound_by = bound(ops, nbytes)
    row.update(ms=device_ms(lambda: ce.ce_ds_slab(x, w, labels, lse, g, 0, V)),
               plain_ms=device_ms(lambda: ce.ce_ds_slab_reference(x, w, labels, lse, g, 0, V),
                                  n=5),
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"  ce_ds over the whole vocab (V={V} as one slab): device {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f} ms), bound {bound_ms:.4f} ms by {bound_by}")
    return row


#: (B, H, T, D, causal) of the flash sweep: T at the main batch, causal and
#: not; the batch at the main T; head dim 128; head dim 256 at GPT-J-6B's
#: heads, causal T at b8 and T 512 not.
SWEEP = ([(BATCH, 12, T, 64, True) for T in (64, 128, 256, 512, 1024, 2048, 4096)]
         + [(BATCH, 12, T, 64, False) for T in (128, 256, 512, 1024)]
         + [(B, 12, SEQ, 64, True) for B in (1, 2, 4, 16, 32)]
         + [(4, 16, T, 128, True) for T in (512, 2048)]
         + [(BATCH, 16, T, 256, True) for T in (512, 1024, 2048)]
         + [(BATCH, 16, SEQ, 256, False)])


#: The work (``work``'s key) whose bound each time of a sweep row is held to.
SWEEP_WORK = {"fwd_ms": "flash_fwd", "dq_ms": "flash_dq", "dkv_ms": "flash_dkv",
              "sdpa_fwd_ms": "flash_fwd", "sdpa_bwd_ms": "flash_bwd"}


def bounded_ms(fn, bound_ms: float, attempts: int = 3):
    """(``device_ms(fn)``, how often it was taken again): a time under
    ``bound_ms``, which no run can be (the profiler lost device events in
    most of its windows), is taken again, up to ``attempts`` in all."""
    for attempt in range(attempts):
        ms = device_ms(fn)
        if ms >= bound_ms:
            break
    return ms, attempt


def flash_sweep(flash, sweep=SWEEP):
    """Device times of the three flash kernels and of SDPA's forward and
    backward alone over ``sweep`` (rows of SWEEP), each timed as phase 2
    times a kernel (``device_ms``: the median of three profiled windows);
    the forward's rate in TFLOP/s, and dQ + dK/dV against SDPA's backward
    alone. Each time is held to its bound (SWEEP_WORK): one under it is
    taken again (``bounded_ms``; the row's ``retaken`` counts how often),
    and one still under it is logged and named in the row's
    ``under_bound``."""
    rows = []
    for B, H, T, D, causal in sweep:
        q, k, v, do = kernel_inputs(B, H, H, T, D, 0)
        o, lse = flash.flash_fwd(q, k, v, causal, H, H)
        delta = (do.float() * o.float()).sum(-1)
        q4, k4, v4 = (t.view(B, H, T, D).detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        n = T // 64
        timings = {
            "fwd_ms": lambda: flash.flash_fwd(q, k, v, causal, H, H),
            "dq_ms": lambda: flash.flash_dq(q, k, v, do, lse, delta, causal, H, H),
            "dkv_ms": lambda: flash.flash_dkv(q, k, v, do, lse, delta, causal, H, H),
            "sdpa_fwd_ms": lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
            "sdpa_bwd_ms": lambda: torch.autograd.grad(out4, (q4, k4, v4), do.view(B, H, T, D),
                                                       retain_graph=True)}
        w = work(B, H, H, T, D, causal)
        bounds = {name: bound(*w[SWEEP_WORK[name]])[0] for name in timings}
        timed = {name: bounded_ms(fn, bounds[name]) for name, fn in timings.items()}
        row = {"B": B, "H": H, "T": T, "D": D, "causal": causal,
               "tile_steps": B * H * (n * (n + 1) // 2 if causal else n * n),
               **{name: ms for name, (ms, _) in timed.items()}, "bound_ms": bounds,
               "retaken": {name: k for name, (_, k) in timed.items() if k},
               "under_bound": [name for name in timings if timed[name][0] < bounds[name]]}
        row["fwd_tflops"] = w["flash_fwd"][0] / row["fwd_ms"] / 1e9
        row["bwd_vs_sdpa"] = (row["dq_ms"] + row["dkv_ms"]) / row["sdpa_bwd_ms"]
        rows.append(row)
        where = f"B{B} H{H} T{T} D{D} causal={causal}"
        log(f"  {where}: {row['tile_steps']} tile steps; "
            f"fwd {row['fwd_ms']:.4f} ms ({row['fwd_tflops']:.0f} TFLOP/s), SDPA fwd "
            f"{row['sdpa_fwd_ms']:.4f}; dq {row['dq_ms']:.4f} + dkv {row['dkv_ms']:.4f} "
            f"against SDPA bwd alone {row['sdpa_bwd_ms']:.4f} ({row['bwd_vs_sdpa']:.2f}x)")
        for name, k in row["retaken"].items():
            log(f"  {where}: {name} read under its bound {bounds[name]:.4f} ms, taken again "
                f"{k} time(s)")
        for name in row["under_bound"]:
            log(f"  {where}: {name} {row[name]:.4f} ms is UNDER its bound "
                f"{bounds[name]:.4f} ms: windows short of device events")
        del out4
    return rows


#: GPT-J-6B's attention at b8 x 512 (phase 8b's path): B, H, KV, T, D.
GPTJ_ATTN = (BATCH, 16, 16, SEQ, 256)


def check_head_dim_256(flash):
    """The flash kernels at head dim 256: timed at GPT-J-6B's shape (causal);
    checked with grouped queries where T % 128 == 64 (the last q block's
    second warpgroup has no rows: T 192, 320), causal and not, on one tile,
    over walks of 16 (T 1024) and on a grid of four blocks (B 1, H 1); the
    forward, dQ and dK/dV twice at GPT-J's shape, causal, bitwise equal."""
    rows = check_kernels(flash, GPTJ_ATTN, True, 16, timed=True)
    for seed, (shape, causal) in enumerate((((2, 8, 2, 320, 256), True),
                                            ((2, 8, 2, 320, 256), False),
                                            ((2, 8, 2, 192, 256), True),
                                            ((2, 8, 2, 192, 256), False),
                                            ((2, 4, 4, 64, 256), True),
                                            ((2, 4, 4, 64, 256), False),
                                            ((2, 16, 16, 1024, 256), True),
                                            ((1, 1, 1, SEQ, 256), True)), start=17):
        check_kernels(flash, shape, causal, seed, timed=False)
    B, H, KV, T, D = GPTJ_ATTN
    q, k, v, do = kernel_inputs(B, H, KV, T, D, 16)
    first, second = flash.flash_fwd(q, k, v, True, H, KV), flash.flash_fwd(q, k, v, True, H, KV)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"flash forward at {GPTJ_ATTN}: two runs on the same inputs differ")
    o, lse = first
    delta = (do.float() * o.float()).sum(-1)
    first, second = (flash.flash_dq(q, k, v, do, lse, delta, True, H, KV) for _ in range(2))
    if not torch.equal(first, second):
        raise AssertionError(f"flash dQ at {GPTJ_ATTN}: two runs on the same inputs differ")
    first, second = (flash.flash_dkv(q, k, v, do, lse, delta, True, H, KV) for _ in range(2))
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"flash dK/dV at {GPTJ_ATTN}: two runs on the same inputs differ")
    log(f"  flash forward, dQ and dK/dV at (B,H,KV,T,D)={GPTJ_ATTN}: two runs bitwise equal")
    return rows


# ------------------------------------------------------------------ phase 3
def lm_task(sat, name, lr, batch_count, save_dir, model=GPT2, loss_fn=None, wrap=None,
            seq=SEQ, batch=None, task_cls=None, **kwargs):
    """A GPT-2 (``pretraining_loss``) or BERT (``mlm_loss``, [MASK] id kept
    out of the data) task at the main path's shapes (at ``seq`` tokens a
    row, ``batch`` rows a batch, BATCH by default), synthetic tokens (passed
    through ``wrap`` when given), of class ``task_cls`` (``sat.Task``)."""
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.bert import build_bert, mlm_loss
    from saturn_tpu_torch.models.gpt2 import build_gpt2
    from saturn_tpu_torch.models.loss import pretraining_loss

    bert = model == BERT
    build = build_bert if bert else build_gpt2
    return (task_cls or sat.Task)(
        get_model=lambda **kw: build(model, **{"seq_len": seq, **kw}),
        get_dataloader=lambda: (wrap or (lambda ds: ds))(make_lm_dataset(
            context_length=seq, batch_size=batch or BATCH, vocab_size=VOCAB, seed=0,
            reserved_ids=1 if bert else 0)),
        loss_fn=loss_fn or (mlm_loss if bert else pretraining_loss),
        hparams=sat.HParams(lr=lr, batch_count=batch_count, kwargs=kwargs),
        name=name,
        save_dir=save_dir,
    )


def initial_loss(task) -> float:
    """Loss of the seed-0 init on batch 0 (where every run starts)."""
    spec = task.get_model(attention="dense")
    model = spec.init_fn(torch.Generator().manual_seed(0), torch.device(DEVICE))
    tokens = torch.from_numpy(task.batch_at(0)).to(DEVICE, torch.long)
    with torch.no_grad():
        loss = task.loss_fn(spec.apply_fn(model, tokens), tokens).item()
    del model
    torch.cuda.empty_cache()
    return loss


def reset_counts(flash, ce) -> None:
    flash.reset_launch_counts()
    ce.reset_launch_counts()


def counts(flash, ce):
    return {**flash.LAUNCHES, **ce.LAUNCHES}


def main_path(sat, flash, ce, card):
    from saturn_tpu_torch.parallel import spmd_base
    from saturn_tpu_torch.solver import anytime
    from saturn_tpu_torch.utils import checkpoint as ckpt

    names = sat.library.register_default_library()
    tasks = [lm_task(sat, f"gpt2s-lr{i}", lr, 20, CKPTS) for i, lr in enumerate((6e-4, 1e-3))]
    tasks.append(lm_task(sat, "bert-base", 1e-3, 20, CKPTS, model=BERT))
    loss0 = {t.name: initial_loss(t) for t in tasks}
    topo = topology()
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    cache_dir = os.path.join(OUT, "main_path_profile_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)  # its trials must run
    # solo tasks (fusion=False): phase 10 runs the two GPT-2 lr points' kind of
    # sweep fused
    stats = sat.search(tasks, technique_names=["dp"], topology=topo, profile_cache=cache_dir,
                       fusion=False)
    t_search = time.perf_counter() - t0
    tech = tasks[0].strategies[1].executor
    k_trial = spmd_base.max_window()
    log(f"  library {names}; search profiled {stats['trials_run']} (task, size) points "
        f"({stats['cache_hits']} profile-cache hits: the GPT-2 tasks differ only in lr), "
        f"{len(tech.trials)} configs, in {t_search:.1f}s, each trial timing windows of "
        f"K={k_trial}:")
    for task_name, size, config, spb, outcome in tech.trials:
        log(f"    trial {task_name} g={size} {config}: "
            + (f"{spb:.6f} s/batch (K={k_trial} windows)" if spb is not None
               else f"infeasible ({outcome})")
            + f"  [{card}]")
    if k_trial != WINDOW:
        raise AssertionError(f"trials timed windows of {k_trial}, want {WINDOW}")
    if any(spb is None for *_, spb, _ in tech.trials):
        raise AssertionError("a trial did not fit in device memory: see the lines above")
    won = {t.name: t.strategies[1].params for t in tasks}
    log(f"  chosen configs: {won}")
    interval = INTERVAL_SHARE * min(t.strategies[1].runtime for t in tasks)
    log(f"  interval {interval:.3f}s ({INTERVAL_SHARE} of the shortest profiled runtime)")
    plan = anytime.anytime_resolve(tasks, topo, None, interval)
    for n, a in plan.assignments.items():
        log(f"  plan: {n} on block [{a.block.offset}:{a.block.end}] start {a.start:.3f}s "
            f"runtime {a.runtime:.3f}s (makespan {plan.makespan:.3f}s)")
    dev = torch.device(DEVICE, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = sat.orchestrate(tasks, interval=interval, topology=topo, fusion=False)
    t_orch = time.perf_counter() - t0
    # live states, graphs and their pools of the tasks not yet finished
    peak = {"allocated": torch.cuda.max_memory_allocated(dev),
            "reserved": torch.cuda.max_memory_reserved(dev)}
    launches = counts(flash, ce)
    log(f"  orchestrate: completed {out['completed']} in {t_orch:.1f}s; peak memory "
        f"{peak['allocated'] / 2**30:.2f} GiB allocated, {peak['reserved'] / 2**30:.2f} GiB "
        f"reserved; kernel launches over search + orchestrate {launches}")
    unchanged = check_intervals(tech.intervals)
    for r in tech.intervals:
        log(f"    interval {r['task']} {r['config']}: {r['n']} batches, K={r['k']}, "
            f"{r['windows']} windows, tail {r['tail']}"
            + (" (one-step windows)" if r["k"] > 1 and r["tail"] else "")
            + (f", eager warm-up step and capture {r['capture_s']:.3f}s" if r["warm"] else "")
            + (", restored the checkpoint" if r["restored"] else ", no restore")
            + (f", {r['per_batch_s'] * 1e3:.2f} ms/batch" if r["per_batch_s"] else "")
            + f"; host s: state {r['state_s']:.3f}, units {r['run_s']:.3f}, checkpoint "
            f"copy {r['save_s']:.3f}  [{card}]")
    log(f"  {unchanged} intervals ran an unchanged config: none restored the checkpoint; "
        f"{len(tech.intervals)} intervals, host s summed: state "
        f"{sum(r['state_s'] for r in tech.intervals):.3f}, units "
        f"{sum(r['run_s'] for r in tech.intervals):.3f}, checkpoint copy "
        f"{sum(r['save_s'] for r in tech.intervals):.3f}")
    results = {}
    for t in tasks:
        saved = ckpt.load(t.ckpt_path)
        if saved["step"] != t.hparams.batch_count:
            raise AssertionError(f"{t.name}: checkpoint step {saved['step']} != "
                                 f"batch_count {t.hparams.batch_count}")
        losses = np.asarray(t.last_losses)
        if not np.isfinite(losses).all() or not losses[-1] < loss0[t.name]:
            raise AssertionError(f"{t.name}: losses {losses} not finite or not below "
                                 f"the initial {loss0[t.name]:.4f}")
        tok_s = BATCH * SEQ / t.last_per_batch_s
        log(f"  {t.name}: step {saved['step']}/{t.hparams.batch_count}, loss "
            f"{loss0[t.name]:.4f} -> {losses[-1]:.4f}, last interval "
            f"{t.last_per_batch_s * 1e3:.2f} ms/step, {tok_s:.0f} tokens/s  [{card}]")
        results[t.name] = {"config": won[t.name], "initial_loss": loss0[t.name],
                           "final_loss": float(losses[-1]),
                           "ms_per_step": t.last_per_batch_s * 1e3, "tokens_per_s": tok_s}
    for name in KERNEL_NAMES:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    trials = [{"task": n, "config": c, "s_per_batch": s, "k": k_trial}
              for n, _, c, s, _ in tech.trials]
    return launches, {"tasks": results, "trials": trials, "search_s": t_search,
                      "orchestrate_s": t_orch, "orchestrate_peak_bytes": peak,
                      "intervals": tech.intervals}


def check_intervals(intervals) -> int:
    """Raise unless the intervals ran through windows of WINDOW, and no
    interval whose task ran the same config in its previous interval
    restored the checkpoint; returns how many intervals kept their config."""
    if not any(r["k"] == WINDOW and r["windows"] for r in intervals):
        raise AssertionError(f"no interval ran windows of {WINDOW}: {intervals}")
    last, unchanged = {}, 0
    for r in intervals:
        if last.get(r["task"]) == r["config"]:
            unchanged += 1
            if r["restored"]:
                raise AssertionError(f"{r['task']} restored the checkpoint in an interval "
                                     f"whose config {r['config']} did not change")
        last[r["task"]] = r["config"]
    if not unchanged:
        raise AssertionError("no task ran two intervals: lower INTERVAL_SHARE")
    return unchanged


# ------------------------------------------------------------------ phase 4
def untagged_loss(logits, tokens):
    """pretraining_loss without the fused-head tag: the step runs it over
    the logits."""
    from saturn_tpu_torch.models.loss import pretraining_loss

    return pretraining_loss(logits, tokens)


#: (label, attention, loss) of the pinned GPT-2-small runs.
PINNED = (("flash", "flash", None), ("dense", "dense", None),
          ("flash-logits", "flash", untagged_loss))


def want_launches(attention, loss_fn, steps=1, layers=0):
    """Launches of each kernel in ``steps`` training steps at ``layers`` (0:
    LAYERS): one of each flash kernel per layer with flash attention, one
    of each CE kernel on the fused head."""
    want = {n: ((layers or LAYERS) * steps if attention == "flash" else 0) for n in FLASH_NAMES}
    want.update({n: (0 if loss_fn else steps) for n in CE_NAMES})
    return want


def pinned_task(sat, label, attention, loss_fn, k=1, seq=SEQ):
    """The pinned task of ``label``; its eager run (``k`` 1) keeps the
    checkpoint that phase 5 reads."""
    where = label if k == 1 else f"{label}-k{k}"
    task = lm_task(sat, f"pinned-{where}", 6e-4, STEPS_PINNED, os.path.join(CKPTS, where),
                   loss_fn=loss_fn, seq=seq)
    config = {"attention": attention, "remat": False}
    return task, config


def compare_windowed(label, windowed, eager) -> str:
    """How the windowed losses hold against the eager ones: "bitwise", or
    "within WINDOW_ATOL" with the largest difference; raise beyond it."""
    w, e = np.asarray(windowed), np.asarray(eager)
    if w.shape != e.shape:
        raise AssertionError(f"{label}: {w.shape} windowed losses against {e.shape} eager")
    if (w == e).all():
        return "bitwise"
    diff = np.abs(w - e).max()
    if not diff <= WINDOW_ATOL:
        raise AssertionError(f"{label}: windowed losses {w} vs eager {e}: max |diff| "
                             f"{diff:.3e} above {WINDOW_ATOL:g}")
    return f"within {WINDOW_ATOL:g} (max |diff| {diff:.3e})"


def pinned_runs(sat, flash, ce, card):
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.utils import checkpoint as ckpt

    runs = {}
    for label, attention, loss_fn in PINNED:
        for k in (WINDOW, 1):
            task, config = pinned_task(sat, label, attention, loss_fn, k)
            tech = DataParallel()
            task.strategies[1] = sat.Strategy(tech, 1, config, 0.0)
            task.select_strategy(1)
            reset_counts(flash, ce)
            tech.execute(task, [torch.device(DEVICE, 0)], 0,
                         override_batch_count=STEPS_PINNED, window_size=k)
            r = tech.intervals[-1]
            runs[label, k] = (task, counts(flash, ce), r)
            log(f"  pinned {label} K={k} ({r['windows']} windows, tail {r['tail']}"
                + (", eager warm-up step" if r["warm"] else "") + "): "
                f"{task.last_per_batch_s * 1e3:.2f} ms/step, "
                f"{BATCH * SEQ / task.last_per_batch_s:.0f} tokens/s, launches "
                f"{runs[label, k][1]}, losses {np.round(task.last_losses, 4).tolist()}  [{card}]")
    for label, attention, loss_fn in PINNED:
        want = want_launches(attention, loss_fn, STEPS_PINNED)
        for k in (WINDOW, 1):
            if runs[label, k][1] != want:
                raise AssertionError(f"{label} K={k} run launched {runs[label, k][1]}, "
                                     f"want {want}")
        if not runs[label, WINDOW][2]["windows"]:
            raise AssertionError(f"{label}: the K={WINDOW} run ran no window")
        held = compare_windowed(label, runs[label, WINDOW][0].last_losses,
                                runs[label, 1][0].last_losses)
        log(f"  {label}: windowed losses against eager: {held}; exact launch counts in both")
    for task, _, _ in runs.values():  # phase 5 measures one state at a time
        task.release_live_state()
        task.release_compiled()
    ckpt.flush()
    ref = np.asarray(runs["flash", 1][0].last_losses)
    for label in ("dense", "flash-logits"):
        other = np.asarray(runs[label, 1][0].last_losses)
        if not np.allclose(other, ref, rtol=BF16_BAND, atol=BF16_BAND):
            raise AssertionError(f"{label} losses {other} vs flash {ref} outside the bf16 band")
        log(f"  flash vs {label} loss trajectories: max |diff| "
            f"{np.abs(other - ref).max():.4e} (band 2e-2)")
    return {f"{x}-k{k}": {"ms_per_step": t.last_per_batch_s * 1e3,
                          "tokens_per_s": BATCH * SEQ / t.last_per_batch_s,
                          "losses": t.last_losses, "launches": c, "interval": r}
            for (x, k), (t, c, r) in runs.items()}


LONG_SEQ = 1024  # GPT-2's published context (n_ctx); b8 x 1024 is N 8192, past the stash limit


def long_context_runs(sat, flash, ce, card):
    """GPT-2-small at b8 x LONG_SEQ, where ``ce.auto_stash`` picks recompute
    mode for the fused head: ``pretraining_loss`` (stash=None) in windows of
    8 and one step at a time, and the untagged loss over the logits one step
    at a time as its loss reference, STEPS_PINNED steps each from the same
    init and batches. Exact launch counts (12 of each flash kernel and 1 of
    each CE kernel per step), windowed losses within WINDOW_ATOL of the
    eager ones, fused within the bf16 band of the logits path; ms per step,
    tokens/s and peak memory; the size of the ds scratch of one vocab slab
    (N x ``ce.slab_width`` bf16, the one allocation recompute mode adds)
    under ``ce.SLAB_BYTES_MAX``."""
    from saturn_tpu_torch.models.gpt2 import build_gpt2
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    n_tokens = BATCH * LONG_SEQ
    d_model = build_gpt2(GPT2, seq_len=LONG_SEQ).config.d_model
    if ce.auto_stash(n_tokens, VOCAB, d_model):
        raise AssertionError(f"auto_stash keeps the stash at N {n_tokens}: want recompute")
    dev = torch.device(DEVICE, 0)
    label = f"flash-{LONG_SEQ}"
    runs = {}
    for loss_fn, k in ((None, WINDOW), (None, 1), (untagged_loss, 1)):
        where = label + ("-logits" if loss_fn else "")
        task, config = pinned_task(sat, where, "flash", loss_fn, k, seq=LONG_SEQ)
        tech = DataParallel()
        task.strategies[1] = sat.Strategy(tech, 1, config, 0.0)
        task.select_strategy(1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(flash, ce)
        tech.execute(task, [dev], 0, override_batch_count=STEPS_PINNED, window_size=k)
        peak = {"allocated": torch.cuda.max_memory_allocated(dev),
                "reserved": torch.cuda.max_memory_reserved(dev)}
        r, launched = tech.intervals[-1], counts(flash, ce)
        want = want_launches("flash", loss_fn, STEPS_PINNED)
        if launched != want:
            raise AssertionError(f"{where} K={k} run launched {launched}, want {want}")
        if k > 1 and not r["windows"]:
            raise AssertionError(f"{where}: the K={k} run ran no window")
        runs[where, k] = (task, launched, r, peak)
        log(f"  pinned {where} b{BATCH}x{LONG_SEQ} K={k} ({r['windows']} windows, tail "
            f"{r['tail']}" + (", eager warm-up step" if r["warm"] else "") + "): "
            f"{task.last_per_batch_s * 1e3:.2f} ms/step, "
            f"{n_tokens / task.last_per_batch_s:.0f} tokens/s, peak memory "
            f"{peak['allocated'] / 2**30:.2f} GiB allocated, {peak['reserved'] / 2**30:.2f} GiB "
            f"reserved, launches {launched} (exact), losses "
            f"{np.round(task.last_losses, 4).tolist()}  [{card}]")
        task.release_live_state()  # one state on the card at a time
        task.release_compiled()
    ckpt.flush()
    held = compare_windowed(label, runs[label, WINDOW][0].last_losses,
                            runs[label, 1][0].last_losses)
    fused = np.asarray(runs[label, 1][0].last_losses)
    logits = np.asarray(runs[label + "-logits", 1][0].last_losses)
    if not np.allclose(fused, logits, rtol=BF16_BAND, atol=BF16_BAND):
        raise AssertionError(f"{label}: fused losses {fused} vs logits {logits} outside the "
                             f"bf16 band")
    scratch = n_tokens * ce.slab_width(n_tokens, VOCAB) * 2
    if scratch > ce.SLAB_BYTES_MAX:
        raise AssertionError(f"the ds scratch takes {scratch} bytes, above "
                             f"{ce.SLAB_BYTES_MAX}")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  {label}: recompute mode (auto_stash at N {n_tokens}); windowed losses against "
        f"eager: {held}; fused against logits: max |diff| {np.abs(fused - logits).max():.4e} "
        f"(band 2e-2); ds scratch {scratch / 2**20:.1f} MiB (slab of "
        f"{ce.slab_width(n_tokens, VOCAB)} columns, cap {ce.SLAB_BYTES_MAX / 2**20:.0f} MiB); "
        f"{seconds:.1f}s")
    return {"recompute": True, "slab_scratch_bytes": scratch, "windowed_vs_eager": held,
            "seconds": seconds,
            **{f"{x}-k{k}": {"ms_per_step": t.last_per_batch_s * 1e3,
                             "tokens_per_s": n_tokens / t.last_per_batch_s,
                             "losses": t.last_losses, "launches": c, "interval": r,
                             "peak_bytes": p}
               for (x, k), (t, c, r, p) in runs.items()}}


# ------------------------------------------------------------------ phase 5
def profile_steps(sat, card, n_sync=8, n_prof=4):
    """Where a training step's time goes, for each pinned config: per-step
    times with a synchronize after every step and the peak device memory
    over them, then ``n_prof`` steps under torch.profiler. From the profile:
    the device's busy time per step and its idle share of the median
    synchronized step, each kernel's launches and device time per step
    (phase 2's kernel times, read inside the real step), and the top
    operators (``chiprun_out/profile_*.txt``)."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.utils import checkpoint as ckpt

    out = {}
    dev = torch.device(DEVICE, 0)
    for label, attention, loss_fn in PINNED:
        task, config = pinned_task(sat, label, attention, loss_fn)
        bundle = DataParallel().build(task, [dev], config)
        state = ckpt.restore(task.ckpt_path, bundle.empty())
        batch = bundle.stage(task.batch_at(0))
        for _ in range(2):
            state, _ = bundle.step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        synced = []
        for _ in range(n_sync):
            t0 = time.perf_counter()
            state, _ = bundle.step(state, batch)
            torch.cuda.synchronize()
            synced.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev)
        # the step updates ``state`` in place
        want = want_launches(attention, loss_fn)
        prof, events, kernels = counted_profile(lambda: bundle.step(state, batch), n_prof,
                                                n_prof, want, label)
        busy = busy_ms(events) / n_prof
        try:
            table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
        except (KeyError, AttributeError, ValueError):
            table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
        with open(os.path.join(OUT, f"profile_{label}.txt"), "w") as f:
            f.write(table)
        step_ms = float(np.median(synced))
        flash_ms = sum(kernels[n]["device_ms_per_step"] for n in FLASH_NAMES)
        ce_ms = sum(kernels[n]["device_ms_per_step"] for n in CE_NAMES)
        readbacks = sum("DtoH" in n for n, _, _ in events) / n_prof
        out[label] = {"synced_ms": synced, "device_busy_ms": busy,
                      "idle_share": 1 - busy / step_ms, "kernels": kernels,
                      "readbacks_per_step": readbacks, "peak_bytes": peak}
        log(f"  {label}: synced steps {np.round(synced, 2).tolist()} ms (median "
            f"{step_ms:.2f}); peak memory {peak / 2**30:.2f} GiB; {readbacks:g} "
            f"device-to-host copies per step; device busy {busy:.2f} ms/step, idle share "
            f"{1 - busy / step_ms:.3f} of the median synced step; flash kernels "
            f"{flash_ms:.3f} ms/step, CE kernels {ce_ms:.3f} ms/step on the device; "
            + ", ".join(f"{n} {k['device_ms_per_step'] / max(want[n], 1):.4f} ms/launch"
                        for n, k in kernels.items() if want[n]) + f"  [{card}]")
        del state, bundle
        torch.cuda.empty_cache()
    return out


def optimizer_ab(bundle, state, batch, rounds):
    """The eager step's device time with the capturable optimizer and with
    the same optimizer not capturable (step counts on the host), in turns."""
    opt = state["opt_state"]
    accepted = inspect.signature(type(opt).__init__).parameters
    plain = type(opt)(state["params"].parameters(),
                      **{k: v for k, v in opt.defaults.items()
                         if k in accepted and k != "capturable"},
                      capturable=False) if "capturable" in opt.defaults else opt
    plain.load_state_dict(opt.state_dict())
    eager_busy = {"capturable": [], "plain": []}
    for _ in range(rounds):
        for name, o in (("capturable", opt), ("plain", plain)):
            state["opt_state"] = o
            eager_busy[name].append(busy_ms(profiled(lambda: bundle.step(state, batch), 4)[1]) / 4)
    state["opt_state"] = opt
    return eager_busy


def profile_windows(sat, card, k=WINDOW, n_windows=3, rounds=2, label="flash", seq=SEQ,
                    compare_optimizers=True):
    """The flash + fused config (the pinned task ``label`` at b x ``seq``)
    in windows of ``k``: the steady-state per-batch time of ``n_windows``
    windows without a synchronize between them, beside the eager path's over
    the same ``n_windows * k`` steps, in turns (windows, steps, windows,
    steps, ...); the device busy time and idle share over the windows
    (torch.profiler), the flash and CE kernels' device time per step inside
    them, and the peak memory of the windows, allocated and reserved (the
    graph's pool is reserved). With ``compare_optimizers``, also
    ``optimizer_ab``."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE, 0)
    _, attention, loss_fn = PINNED[0]
    task, config = pinned_task(sat, label, attention, loss_fn, seq=seq)
    bundle = DataParallel().build(task, [dev], config)
    state = ckpt.restore(task.ckpt_path, bundle.empty())
    n = n_windows * k
    batches = [task.batch_at(i) for i in range(n)]
    windows = [stage_tokens(np.stack(batches[w * k:(w + 1) * k]), dev)
               for w in range(n_windows)]
    steps = [bundle.stage(b) for b in batches]
    window = bundle.fused(k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state, _ = bundle.warm_step(state, steps[0])
    t0 = time.perf_counter()
    state, _ = window(state, windows[0])  # the capture, then a replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0

    def run_windows():
        for w in windows:
            window(state, w)

    def run_steps():
        for b in steps:
            bundle.step(state, b)

    run_windows()
    torch.cuda.synchronize()
    peak = {"allocated": torch.cuda.max_memory_allocated(dev),
            "reserved": torch.cuda.max_memory_reserved(dev)}
    times = {"windowed": [], "eager": []}
    for _ in range(rounds):
        for name, fn in (("windowed", run_windows), ("eager", run_steps)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / n)
    # the profiler's count inside the replays, independent of LAUNCHES (which
    # a replay advances by what its capture recorded)
    _, events, kernels = counted_profile(run_windows, 1, n, want_launches(attention, loss_fn),
                                         f"{label} windows")
    busy = busy_ms(events) / n
    windowed_ms = float(np.median(times["windowed"]))
    flash_ms = sum(kernels[x]["device_ms_per_step"] for x in FLASH_NAMES)
    ce_ms = sum(kernels[x]["device_ms_per_step"] for x in CE_NAMES)
    eager_busy = optimizer_ab(bundle, state, steps[0], rounds) if compare_optimizers else None
    out = {"seq": seq, "k": k, "windows": n_windows, "capture_s": capture_s,
           "ms_per_batch": times, "device_busy_ms": busy, "idle_share": 1 - busy / windowed_ms,
           "flash_ms_per_step": flash_ms, "ce_ms_per_step": ce_ms,
           "seconds": time.perf_counter() - t_phase,
           "readbacks_per_step": sum("DtoH" in e for e, _, _ in events) / n,
           "kernels": kernels, "peak_bytes": peak, "eager_device_busy_ms": eager_busy}
    log(f"  {label} b{BATCH}x{seq} in windows of {k}: capture {capture_s:.3f}s; per batch "
        f"without a synchronize between steps, {n} steps, in turns: windowed "
        f"{np.round(times['windowed'], 3).tolist()} ms, eager "
        f"{np.round(times['eager'], 3).tolist()} ms; device busy {busy:.2f} ms/step, idle "
        f"share {out['idle_share']:.3f} of the windowed batch; flash kernels {flash_ms:.3f} "
        f"ms/step, CE kernels {ce_ms:.3f} ms/step; "
        f"{out['readbacks_per_step']:g} device-to-host copies per step; peak memory "
        f"{peak['allocated'] / 2**30:.2f} GiB allocated, {peak['reserved'] / 2**30:.2f} GiB "
        f"reserved; launches per step seen by the profiler "
        + ", ".join(f"{name} {kk['launches_per_step']:g}" for name, kk in kernels.items())
        + (f"; eager device busy per step, in turns: capturable "
           f"{type(state['opt_state']).__name__} "
           f"{np.round(eager_busy['capturable'], 3).tolist()} ms, not capturable "
           f"{np.round(eager_busy['plain'], 3).tolist()} ms" if eager_busy else "")
        + f"; {out['seconds']:.1f}s  [{card}]")
    bundle.release_windows()
    del state, bundle, windows, steps
    torch.cuda.empty_cache()
    return out


def staging_ab(sat, card, k=WINDOW, n_windows=4, rounds=3):
    """Staging inline on the dispatching thread (what ``execute`` does)
    against staging on a second thread one unit ahead through a queue of
    depth 2 (what the JAX package's ``DevicePrefetcher`` does), flash +
    fused at b8 x 512 on one state: the per-batch time of ``n_windows``
    windows of ``k``, and of the same steps one at a time, each run staging
    its own batches from the host and ending in one loss readback, in turns
    (inline, thread, then thread, inline, ``rounds`` times)."""
    import queue
    import threading

    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens

    dev = torch.device(DEVICE, 0)
    task, config = pinned_task(sat, "flash", "flash", None)
    bundle = DataParallel().build(task, [dev], config)
    state = bundle.init()
    n = n_windows * k

    def stager(size):
        def stage(u):
            host = np.stack([task.batch_at(u * size + j) for j in range(size)])
            return stage_tokens(host if size > 1 else host[0], dev)
        return stage

    def inline(count, stage):
        for u in range(count):
            yield stage(u)

    def threaded(count, stage):
        q = queue.Queue(maxsize=2)
        producer = threading.Thread(target=lambda: [q.put(stage(u)) for u in range(count)],
                                    daemon=True)
        producer.start()
        for _ in range(count):
            yield q.get()
        producer.join()

    window = bundle.fused(k)
    state, _ = bundle.warm_step(state, stager(1)(0))
    window(state, stager(k)(0))  # the capture, then a replay
    torch.cuda.synchronize()
    out = {"card": card, "k": k, "batches": n}
    for label, size, run in (("windowed", k, window), ("eager", 1, bundle.step)):
        times = {"inline": [], "thread": []}
        for r in range(rounds):
            for mode in (("inline", "thread") if r % 2 == 0 else ("thread", "inline")):
                feed = inline if mode == "inline" else threaded
                t0 = time.perf_counter()
                losses = [run(state, batch)[1].reshape(-1)
                          for batch in feed(n // size, stager(size))]
                torch.cat(losses).cpu()
                times[mode].append((time.perf_counter() - t0) * 1e3 / n)
        out[label] = times
        log(f"  {label} ({n} batches per run, in turns): staged inline "
            f"{np.round(times['inline'], 3).tolist()} ms/batch, on a thread "
            f"{np.round(times['thread'], 3).tolist()} ms/batch  [{card}]")
    bundle.release_windows()
    del state, bundle
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 6
SWEEP_TASKS = 12           # lr points of GPT-2-small, fused head; a 13th runs the logits
SWEEP_BATCHES = 16
#: GPT-2-small's depth in the sweep, cut from 12 (depth only): its cost is
#: per task (a fresh init, the captures, two checkpoint writes), and the
#: script's time limit is shared by every phase
SWEEP_LAYERS = 4
MARKED_BATCH = 12          # the 13th task's dataset index whose loss is NaN
MARK = VOCAB - 1           # a whole row of this id marks that batch (synthetic data never does)
SWEEP_INTERVAL_BATCHES = 9.5  # interval: this many of the 13th task's profiled batches


class PoisonedDataset:
    """A dataset whose batch ``index`` (modulo the epoch) has its first row
    set to ``mark``: a loss that tests for the mark is NaN there."""

    def __init__(self, base, index: int, mark: int):
        self.base, self.index, self.mark = base, index, mark
        self.batch_size = base.batch_size

    def __len__(self) -> int:
        return len(self.base)

    def batch(self, i: int):
        b = np.array(self.base.batch(i))
        if i % len(self.base) == self.index:
            b[0, :] = self.mark
        return b

    def example_batch(self):
        return self.base.example_batch()


def nan_on_mark_loss(logits, tokens):
    """The pretraining loss over the logits (no fused-head tag), plus
    sqrt(-1) = NaN on a batch whose first row is all ``MARK``: a NaN
    computed on the card inside the captured window. No gradient flows
    through it, so only the marked step's loss is non-finite and the
    sentinel blames that batch alone (it blames every non-finite step, as
    the JAX package does); that no faulted attempt writes a checkpoint is
    held by the sequence of writes (``check_writes``)."""
    return untagged_loss(logits, tokens) + torch.sqrt(-(tokens[0] == MARK).all().float())


def sweep_tasks(sat, save_dir):
    """The sweep: SWEEP_TASKS GPT-2-small tasks that differ only in lr
    (``pretraining_loss``, the fused head), and one whose loss runs over the
    logits and is NaN on its batch MARKED_BATCH."""
    tasks = [lm_task(sat, f"sweep-lr{i}", 2e-4 + 1e-4 * i, SWEEP_BATCHES, save_dir,
                     model=GPT2, n_layers=SWEEP_LAYERS) for i in range(SWEEP_TASKS)]
    sick = lm_task(sat, "sweep-nan", 6e-4, SWEEP_BATCHES, save_dir, model=GPT2,
                   loss_fn=nan_on_mark_loss,
                   wrap=lambda ds: PoisonedDataset(ds, MARKED_BATCH, MARK), n_layers=SWEEP_LAYERS)
    return tasks + [sick]


def check_search(stats, trials: int, hits: int) -> None:
    """Raise unless a search ran ``trials`` (task, size) trials and answered
    ``hits`` from the profile cache."""
    got = (stats["trials_run"], stats["cache_hits"])
    if got != (trials, hits):
        raise AssertionError(f"search ran {got[0]} trials with {got[1]} cache hits, "
                             f"want {trials} and {hits}")


def nonfinite(tensors) -> list:
    """Names of the tensors of a ``{name: tensor}`` map holding a NaN or Inf."""
    names = list(tensors)
    if not names:
        return []
    ok = torch.stack([torch.isfinite(tensors[n]).all() for n in names]).cpu()
    return [n for n, good in zip(names, ok.tolist()) if not good]


class CheckedWrites:
    """Wrap ``checkpoint.save_async``: every state written must hold finite
    weights (checked on the device before the host copy); records every
    write's (path, step) in order."""

    def __init__(self, ckpt):
        self.ckpt, self.save = ckpt, ckpt.save_async
        self.writes: list = []  # (path, step) of every write, in order

    def __enter__(self):
        def checked(path, state, **kwargs):
            bad = nonfinite(dict(state["params"].named_parameters()))
            if bad:
                raise AssertionError(f"{path}: a checkpoint write of non-finite weights {bad}")
            self.writes.append((path, int(state["step"])))
            return self.save(path, state, **kwargs)

        self.ckpt.save_async = checked
        return self

    def __exit__(self, *exc):
        self.ckpt.save_async = self.save

    def steps(self, path: str) -> list:
        """The step of every write to ``path``, in order."""
        return [step for p, step in self.writes if p == path]

    def bytes_written(self) -> int:
        self.ckpt.flush()
        return sum(dir_bytes(p) for p, _ in self.writes)


def check_writes(name: str, steps: list, runs: list, total: int) -> None:
    """Raise unless a task's checkpoint writes (their steps, in order) are
    one per interval of ``runs`` (the executor's records of the intervals
    that ran to their end), each at the step where its interval ended, the
    last at ``total``: an attempt that the sentinel faulted, or that the
    watchdog abandoned, writes nothing."""
    want = np.cumsum([r["n"] for r in runs]).tolist()
    if steps != want or want[-1:] != [total]:
        raise AssertionError(f"{name}: checkpoint writes at steps {steps}, want one at the "
                             f"end of each interval that ran to its end, {want}, the last "
                             f"at {total}")


def sweep_events(path: str, sick: str, index: int) -> dict:
    """Read the sweep's metrics file back (``metrics.read_events``): it must
    hold ``solve``, ``solver_tier``, ``profile_cache`` and ``health``
    events, and ``sick``'s guardian trail must be fault, backoff, fault,
    quarantine of ``[index]``, backoff, then its completion. Returns the
    events by kind."""
    from saturn_tpu_torch.utils import metrics

    events = metrics.read_events(path)
    by_kind: dict = {}
    for e in events:
        by_kind.setdefault(e["kind"], []).append(e)
    for kind in ("solve", "solver_tier", "profile_cache", "health", "task_completed"):
        if not by_kind.get(kind):
            raise AssertionError(f"no {kind} event in {path}")
    trail = [(e["code"], e.get("batches")) for e in by_kind["health"] if e["task"] == sick]
    want = [("SAT-H001", None), ("SAT-H003", None), ("SAT-H001", None),
            ("SAT-H010", [index]), ("SAT-H003", None)]
    if trail != want:
        raise AssertionError(f"{sick}: guardian trail {trail}, want {want}")
    if sick not in [e["task"] for e in by_kind["task_completed"]]:
        raise AssertionError(f"{sick} did not complete")
    return by_kind


def sweep_phase(sat, flash, ce, card):
    """13 GPT-2-small tasks, past ``milp_task_limit``: search -> a repeat
    search -> orchestrate with the defaults (the guardian, the anytime
    ladder), a fresh profile cache and a metrics file."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    save_dir = os.path.join(CKPTS, "sweep")
    cache_dir = os.path.join(OUT, "sweep_profile_cache")
    events_path = os.path.join(OUT, "sweep_events.jsonl")
    shutil.rmtree(cache_dir, ignore_errors=True)
    if os.path.exists(events_path):
        os.unlink(events_path)
    tasks = sweep_tasks(sat, save_dir)
    sick = tasks[-1]
    loss0 = initial_loss(tasks[0])  # seed-0 init, batch 0: every task's start
    topo = topology()
    dev = torch.device(DEVICE, 0)
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated(dev)
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    stats = sat.search(tasks, technique_names=["dp"], topology=topo,
                       profile_cache=cache_dir, metrics_path=events_path, fusion=False)
    t_search = time.perf_counter() - t0
    check_search(stats, 2, len(tasks) - 2)
    t0 = time.perf_counter()
    again = sat.search(tasks, technique_names=["dp"], topology=topo, profile_cache=cache_dir,
                       fusion=False)
    t_again = time.perf_counter() - t0
    check_search(again, 0, len(tasks))
    log(f"  search: {stats['trials_run']} trials (fused head, logits), "
        f"{stats['cache_hits']} profile-cache hits, {t_search:.1f}s; repeat search "
        f"{again['trials_run']} trials, {again['cache_hits']} hits, {t_again:.1f}s  [{card}]")
    configs = {t.name: t.strategies[1].params for t in tasks}
    pbt = {t.name: t.strategies[1].per_batch_time for t in tasks}
    log(f"  configs {configs[tasks[0].name]} (fused), {configs[sick.name]} (logits); "
        f"profiled {pbt[tasks[0].name] * 1e3:.2f} and {pbt[sick.name] * 1e3:.2f} ms/batch")
    interval = SWEEP_INTERVAL_BATCHES * pbt[sick.name]
    serial = sum(t.strategies[1].runtime for t in tasks)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with CheckedWrites(ckpt) as writes:
        out = sat.orchestrate(tasks, interval=interval, topology=topo,
                              metrics_path=events_path, fusion=False)
    t_orch = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    after = torch.cuda.memory_allocated(dev)
    launches = counts(flash, ce)
    if sorted(out["completed"]) != sorted(t.name for t in tasks) or out["failed"]:
        raise AssertionError(f"sweep: completed {out['completed']}, failed {out['failed']}")
    if after > base_bytes + 256 * 2**20:
        raise AssertionError(f"sweep: {after / 2**30:.2f} GiB still allocated after every "
                             f"task completed (before: {base_bytes / 2**30:.2f} GiB)")
    events = sweep_events(events_path, sick.name, MARKED_BATCH)
    tiers = events["solver_tier"]
    first = tiers[0]
    log(f"  interval {interval:.3f}s ({SWEEP_INTERVAL_BATCHES} of the logits task's batches); "
        f"initial solve: tier {first['tier']} ({first['tier_name']}, tried "
        f"{first['tiers_tried']}) in {first['wall_s'] * 1e3:.1f} ms of a "
        f"{first['deadline_s'] * 1e3:.1f} ms deadline, makespan {first['makespan_s']:.3f}s "
        f"against a serial sum of runtimes {serial:.3f}s (+ {len(tasks) - 1} x 1 s of "
        f"ordering slack on one device); {len(tiers)} solves, tiers "
        f"{sorted({e['tier'] for e in tiers})}, at most {max(e['wall_s'] for e in tiers) * 1e3:.1f}"
        f" ms  [{card}]")
    faults = [e for e in events.get("task_numeric_fault", []) if e["task"] == sick.name]
    runs = [r for r in sick.strategies[1].executor.intervals if r["task"] == sick.name]
    # the faulted attempts record nothing; the first after the quarantine restores
    if sick.quarantined_batches != (MARKED_BATCH,) or not any(r["restored"] for r in runs):
        raise AssertionError(f"{sick.name}: quarantined {sick.quarantined_batches}, "
                             f"intervals {runs}")
    log(f"  {sick.name}: {len(faults)} numeric faults at interval step "
        f"{[e['step'] for e in faults]} (dataset batches {[e['batches'] for e in faults]}) "
        f"after a checkpoint at step {runs[0]['n']}; batch {MARKED_BATCH} quarantined after "
        f"the second; the next attempt restored that checkpoint and completed; checkpoint "
        f"writes at steps {writes.steps(sick.ckpt_path)}")
    for t in tasks:
        losses = np.asarray(t.last_losses)
        check_writes(t.name, writes.steps(t.ckpt_path),
                     [r for r in t.strategies[1].executor.intervals if r["task"] == t.name],
                     SWEEP_BATCHES)
        if not np.isfinite(losses).all() or not losses[-1] < loss0:
            raise AssertionError(f"{t.name}: losses {losses} not finite or not below {loss0}")
    n_bytes = writes.bytes_written()
    names = {t.name for t in tasks}
    recs = [r for r in sick.strategies[1].executor.intervals if r["task"] in names]
    split = {x: sum(r[f"{x}_s"] for r in recs) for x in ("state", "run", "save")}
    log(f"  {len(recs)} intervals ran to their end, {sum(r['warm'] for r in recs)} with an "
        f"eager warm-up step and captures ({sum(r['capture_s'] or 0 for r in recs):.1f}s of "
        f"captures); host s summed: state {split['state']:.1f} (fresh inits and restores), "
        f"units {split['run']:.1f}, checkpoint copy and wait {split['save']:.1f}  [{card}]")
    log(f"  {len(out['completed'])} tasks completed in {t_orch:.1f}s, every final loss below "
        f"the initial {loss0:.4f}; {len(writes.writes)} checkpoint writes, all finite, one "
        f"per interval that ran to its end, {n_bytes / 1e9:.2f} GB "
        f"({n_bytes / len(writes.writes) / 1e9:.2f} GB each); peak "
        f"{peak / 2**30:.2f} GiB allocated, {after / 2**30:.2f} GiB after (before "
        f"{base_bytes / 2**30:.2f}); launches {launches}  [{card}]")
    shutil.rmtree(save_dir, ignore_errors=True)
    for name in KERNEL_NAMES:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched in the sweep")
    seconds = time.perf_counter() - t_phase
    log(f"  sweep phase {seconds:.1f}s  [{card}]")
    return launches, {"search": stats, "repeat_search": again, "search_s": t_search,
                      "orchestrate_s": t_orch, "interval_s": interval, "serial_s": serial,
                      "solver_tiers": tiers, "faults": faults, "host_s": split,
                      "checkpoint_writes": len(writes.writes),
                      "sick_writes": writes.steps(sick.ckpt_path),
                      "checkpoint_bytes": n_bytes, "peak_bytes": peak,
                      "after_bytes": after, "before_bytes": base_bytes, "seconds": seconds}


# ------------------------------------------------------------------ phase 7
KILL_BATCHES = 16
#: GPT-2-small's depth in phase 7, cut from 12 (depth only: the phase's
#: checks do not depend on it); never above the model's own
KILL_LAYERS = 4
KILL_INTERVAL_SHARE = 0.4  # of the shortest profiled runtime: about 6 batches an interval
KILL_MIN_INTERVALS = 3     # intervals each task of the reference run must take
KILL_CHAIN = (("mid-fsync", 2), ("mid-interval", 1), (None, None))  # (point, hit) per incarnation
JOURNAL_KINDS = ("segment_open", "recovery", "plan_commit", "task_progress",
                 "ckpt_published", "interval_commit", "task_completed")
MEMORY_SLACK = 256 * 2**20  # bytes a phase may leave allocated beyond where it began


class CallTimes:
    """Time every call of the functions ``targets`` names (``label=(holder,
    attribute)``) inside the block; ``seconds[label]`` lists them."""

    def __init__(self, **targets):
        self.targets = targets
        self.seconds = {label: [] for label in targets}
        self.saved = {}

    def __enter__(self):
        for label, (holder, attr) in self.targets.items():
            self.saved[label] = fn = getattr(holder, attr)
            setattr(holder, attr, self._timed(label, fn))
        return self

    def _timed(self, label, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[label].append(time.perf_counter() - t0)
        return timed

    def __exit__(self, *exc):
        for label, (holder, attr) in self.targets.items():
            setattr(holder, attr, self.saved[label])


def check_same_state(name: str, want: dict, got: dict) -> None:
    """Raise unless two checkpoint payloads (``checkpoint.load``) hold the
    same step, parameters and optimizer state, bit for bit."""
    if got["step"] != want["step"]:
        raise AssertionError(f"{name}: step {got['step']}, want {want['step']}")
    pairs = [(f"params[{k}]", got["params"].get(k), v) for k, v in want["params"].items()]
    gs, ws = got["opt_state"]["state"], want["opt_state"]["state"]
    if set(gs) != set(ws) or set(got["params"]) != set(want["params"]):
        raise AssertionError(f"{name}: the checkpoints hold different entries")
    for i, entry in ws.items():
        pairs += [(f"opt_state[{i}][{k}]", gs[i].get(k), v) for k, v in entry.items()]
    for label, g, w in pairs:
        same = (torch.equal(g, w) if isinstance(w, torch.Tensor) and isinstance(g, torch.Tensor)
                else g == w)
        if not same:
            raise AssertionError(f"{name}: {label} differs from the uninterrupted run's")
    if got["opt_state"]["param_groups"] != want["opt_state"]["param_groups"]:
        raise AssertionError(f"{name}: optimizer param groups differ")


def check_progress(progress: dict, want: dict) -> None:
    """Raise unless the journal's progress (``replay_batch_state``) counts
    each task's batches exactly once."""
    if progress != want:
        raise AssertionError(f"journaled progress {progress}, want {want}")


def check_memory(label: str, after: int, before: int, slack: int = MEMORY_SLACK) -> None:
    if after > before + slack:
        raise AssertionError(f"{label}: {after / 2**30:.3f} GiB allocated, "
                             f"{before / 2**30:.3f} GiB before")


def check_kill_journal(root: str, incarnations: int) -> dict:
    """Raise unless the journal replays strictly as one ``seq`` chain over
    ``incarnations`` recoveries, holds the JAX package's record kinds, and
    its torn tail went to a ``.corrupt`` sidecar. Returns the record count
    of each kind."""
    from saturn_tpu_torch.durability import replay

    recs = replay(root, strict=True)
    seqs = [r["seq"] for r in recs]
    if seqs != list(range(1, len(recs) + 1)):
        raise AssertionError(f"{root}: seq {seqs} is not one chain from 1")
    kinds: dict = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    missing = [k for k in JOURNAL_KINDS if k not in kinds]
    if missing or kinds.get("recovery") != incarnations:
        raise AssertionError(f"{root}: record kinds {kinds}; missing {missing}, want "
                             f"{incarnations} recovery records")
    if not [n for n in os.listdir(root) if ".corrupt" in n]:
        raise AssertionError(f"{root}: no .corrupt sidecar of the torn tail")
    return kinds


def idle_commits(jmod, root: str, n: int = 20) -> list:
    """Seconds of ``n`` journal commits of one small record each into a
    journal of its own, with no checkpoint write in flight."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    ckpt.flush()
    shutil.rmtree(root, ignore_errors=True)
    out = []
    with jmod.Journal(root) as journal:
        for i in range(n):
            journal.append("task_progress", task="probe", batches=i)
            t0 = time.perf_counter()
            journal.commit()
            out.append(time.perf_counter() - t0)
    return out


def kill_replay_phase(sat, flash, ce, card):
    """Two GPT-2-small tasks (b8 x 512, fused head, differing only in lr):
    one uninterrupted ``orchestrate(resume_dir=A)``, then a chain of three
    incarnations on journal B with fresh tasks each, killed at ``mid-fsync``
    (hit 2) and at ``mid-interval`` (hit 1), the third running to the end."""
    import gc
    import traceback

    from saturn_tpu_torch.durability import journal as jmod
    from saturn_tpu_torch.durability import recovery as rmod
    from saturn_tpu_torch.executor import orchestrator
    from saturn_tpu_torch.resilience import CrashInjector, SimulatedKill
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    root = os.path.join(CKPTS, "kill_replay")
    journals = {k: os.path.join(OUT, f"kill_replay_journal_{k}") for k in "AB"}
    cache_dir = os.path.join(OUT, "kill_replay_profile_cache")
    for d in (root, cache_dir, *journals.values()):
        shutil.rmtree(d, ignore_errors=True)
    topo = topology()
    dev = torch.device(DEVICE, 0)

    def tasks_in(save_dir):
        # the first search runs the trials of this depth, the others hit its entry
        tasks = [lm_task(sat, f"kill-lr{i}", lr, KILL_BATCHES, save_dir,
                         n_layers=min(KILL_LAYERS, LAYERS))
                 for i, lr in enumerate((6e-4, 1e-3))]
        sat.search(tasks, technique_names=["dp"], topology=topo, profile_cache=cache_dir,
                   fusion=False)
        return tasks

    reset_counts(flash, ce)
    ref = tasks_in(os.path.join(root, "reference"))
    interval = KILL_INTERVAL_SHARE * min(t.strategies[1].runtime for t in ref)
    with CallTimes(commit=(jmod.Journal, "commit"), fsync=(os, "fsync")) as timer:
        t0 = time.perf_counter()
        out = sat.orchestrate(ref, interval=interval, topology=topo, resume_dir=journals["A"],
                              fusion=False)
        t_ref = time.perf_counter() - t0
    names = sorted(t.name for t in ref)
    if sorted(out["completed"]) != names or out["failed"]:
        raise AssertionError(f"reference run: {out}")
    records = ref[0].strategies[1].executor.intervals
    runs = {n: [r["n"] for r in records if r["task"] == n] for n in names}
    if min(len(v) for v in runs.values()) < KILL_MIN_INTERVALS:
        raise AssertionError(f"reference intervals {runs}: lower KILL_INTERVAL_SHARE")
    want = {t.name: ckpt.load(t.ckpt_path) for t in ref}
    commit_s, fsync_s = timer.seconds["commit"], timer.seconds["fsync"]
    idle_s = idle_commits(jmod, os.path.join(OUT, "kill_replay_journal_idle"))
    log(f"  reference: interval {interval:.3f}s ({KILL_INTERVAL_SHARE} of the shortest "
        f"profiled runtime), batches per interval {runs}, {t_ref:.1f}s; {len(commit_s)} "
        f"journal commits, median {np.median(commit_s) * 1e3:.2f} ms, max "
        f"{max(commit_s) * 1e3:.2f} ms; the run's {len(fsync_s)} fsyncs (the commits' and "
        f"the journal's opening and closing) median {np.median(fsync_s) * 1e3:.2f} ms, max "
        f"{max(fsync_s) * 1e3:.2f} ms; with no checkpoint "
        f"write in flight a commit takes median {np.median(idle_s) * 1e3:.2f} ms, max "
        f"{max(idle_s) * 1e3:.2f}  [{card}]")
    del ref, records
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)

    chain = []
    t_chain = time.perf_counter()
    for point, hit in KILL_CHAIN:
        tasks = tasks_in(os.path.join(root, "chain"))
        inj = CrashInjector(point, hit=hit) if point else None
        timer = CallTimes(replay=(rmod, "replay_batch_state"),
                          reconcile=(rmod, "reconcile_checkpoints"),
                          fold=(orchestrator, "_fold_batch_recovery"),
                          checkpoint_step=(orchestrator, "_checkpoint_step"),
                          verify=(ckpt, "verify"), saved_step=(ckpt, "saved_step"),
                          commit=(jmod.Journal, "commit"))
        killed = None
        t0 = time.perf_counter()
        with timer:
            try:
                out = sat.orchestrate(tasks, interval=interval, topology=topo,
                                      resume_dir=journals["B"],
                                      crash_barrier=inj.barrier if inj else None,
                                      fusion=False)
            except SimulatedKill as e:
                killed = str(e)
                traceback.clear_frames(e.__traceback__)
        seconds = time.perf_counter() - t0
        step = {n: timer.seconds[n][0] if timer.seconds[n] else None
                for n in ("replay", "reconcile", "fold")}
        # the fold's checkpoint reads: waiting for a write in flight, verify, the step
        step["checkpoint_wait"] = (sum(timer.seconds["checkpoint_step"])
                                   - sum(timer.seconds["verify"])
                                   - sum(timer.seconds["saved_step"]))
        entry = {"kill": point, "hit": hit, "killed": killed, "seconds": seconds,
                 "recovery_s": step, "verify_s": timer.seconds["verify"],
                 "saved_step_s": timer.seconds["saved_step"],
                 "commit_s": timer.seconds["commit"],
                 "progress": rmod.replay_batch_state(journals["B"]).progress}
        if point is not None:
            if killed is None:
                raise AssertionError(f"the kill at {point} (hit {hit}) never fired: {out}")
            for t in tasks:  # the dead incarnation's states, graphs and pools
                t.release_live_state()
                t.release_compiled()
            del tasks
            gc.collect()
            entry["allocated_after"] = after = torch.cuda.memory_allocated(dev)
            check_memory(f"after the kill at {point}", after, before)
        chain.append(entry)
        log(f"  incarnation {len(chain)}: " + (f"killed at {point} (hit {hit})" if killed
                                                else "ran to the end")
            + f" in {seconds:.1f}s; recovery s: replay {step['replay']:.4f}, reconcile "
            f"{step['reconcile']:.3f}, fold {step['fold']:.3f} ({len(entry['verify_s'])} "
            f"checkpoint(s) verified in {sum(entry['verify_s']):.3f}s, "
            f"{step['checkpoint_wait']:.3f}s waiting for writes in flight); journaled progress "
            f"{entry['progress']}"
            + (f"; {entry['allocated_after'] / 2**30:.3f} GiB allocated after, "
               f"{before / 2**30:.3f} before" if killed else "") + f"  [{card}]")
    t_chain = time.perf_counter() - t_chain
    if sorted(out["completed"]) != names or out["failed"]:
        raise AssertionError(f"last incarnation: {out}")
    for t in tasks:
        check_same_state(t.name, want[t.name], ckpt.load(t.ckpt_path))
    progress = rmod.replay_batch_state(journals["B"]).progress
    check_progress(progress, {n: KILL_BATCHES for n in names})
    kinds = check_kill_journal(journals["B"], len(KILL_CHAIN))
    launches = counts(flash, ce)
    for name in KERNEL_NAMES:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched in the kill-replay phase")
    del tasks, want
    shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"  every task at step {KILL_BATCHES}, parameters and AdamW moments bitwise equal "
        f"to the reference run's; journal B replays strictly, {kinds}, its torn tail in a "
        f".corrupt sidecar; launches {launches}")
    log(f"  kill chain {t_chain:.1f}s against the reference run's {t_ref:.1f}s; phase "
        f"{seconds:.1f}s  [{card}]")
    return {"interval_s": interval, "reference_s": t_ref, "reference_intervals": runs,
            "commit_s": {"median": float(np.median(commit_s)), "max": max(commit_s),
                         "n": len(commit_s), "fsync": fsync_s,
                         "idle_median": float(np.median(idle_s)), "idle_max": max(idle_s)},
            "incarnations": chain, "chain_s": t_chain, "journal_kinds": kinds,
            "progress": progress, "launches": launches, "allocated_before": before,
            "seconds": seconds}


# ------------------------------------------------------------------ phase 8
OFFLOAD_STEPS = 4
OFFLOAD_REL = 1e-4          # offload against dp: the repo's trajectory tolerance, relative
STREAM_BULK_LOSS_REL = 1e-5  # GPT-J-6B stream against bulk on one state and batch
STREAM_BULK_GRAD_REL = 1e-3  # the same, gradients by relative norm
STREAM = {"stream": True, "remat": True}
BULK = {"stream": False, "remat": False}
GPTJ = "gptj-6b"
GPTJ_LAYERS = 28             # the published depth: 8b-1's dp screen, on the meta device
#: The depth of 8b-1's offload trials, which draw one host state: 24 layers'
#: draw takes 80-106 s on an H100's host, a tenth of the script's time limit
#: (cut in depth only).
GPTJ_SEARCH_LAYERS = 4
#: The depth of 8b-2, whose run writes a checkpoint of params and AdamW moments
#: (12 bytes a parameter): the card's machine takes at most 45 GiB of disk writes
#: a call, deleted files included, and 24 layers' checkpoint is 56.3 GiB. The
#: run cannot read what is left of that budget (``bytes_written``), and the
#: script's time limit is shared by every phase, so 8b-2, 8c and 9f run at 2.
GPTJ_CKPT_LAYERS = 2
#: The depth of 8c, GPT-J-6B offload against dp: dp's state fits the card.
GPTJ_PARITY_LAYERS = 2


def host_facts(free_text: str, nproc_text: str, df_text: str) -> dict:
    """The host's memory (``free -b``), cores (``nproc``) and free disk
    (``df -B1 --output=avail DIR``) as numbers: bytes and a count."""
    lines = [ln.split() for ln in free_text.strip().splitlines()]
    header = lines[0]
    mem = next(ln for ln in lines if ln[0] == "Mem:")
    values = dict(zip(header, (int(v) for v in mem[1:])))
    return {"mem_total": values["total"], "mem_available": values["available"],
            "cores": int(nproc_text.strip()),
            "disk_free": int(df_text.strip().splitlines()[-1].strip())}


SPLIT_KEYS = ("h2d_s", "compute_s", "d2h_s", "update_s", "step_s")


def split_summary(splits) -> dict:
    """Per-step lines and medians of offload steps' time splits
    (``HostOffload.splits`` records)."""
    lines = [f"step {r['step']}: host->card {r['h2d_s']:.3f}s ({r['h2d_bytes'] / 1e9:.2f} GB), "
             f"compute {r['compute_s']:.3f}s, card->host {r['d2h_s']:.3f}s "
             f"({r['d2h_bytes'] / 1e9:.2f} GB), host update {r['update_s']:.3f}s, "
             f"step {r['step_s']:.3f}s" for r in splits]
    median = {k: float(np.median([r[k] for r in splits])) if splits else None for k in SPLIT_KEYS}
    return {"lines": lines, "median": median, "steps": len(splits)}


def rel_diff(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def want_offload_launches(recompute: bool, steps: int, layers: int = LAYERS) -> dict:
    """Flash launches of ``steps`` steps over the logits: one of each kernel
    per layer, the forward twice where the blocks are recomputed."""
    want = {n: layers * steps for n in FLASH_NAMES}
    want["flash_fwd"] *= 2 if recompute else 1
    want.update({n: 0 for n in CE_NAMES})
    return want


def bytes_written() -> int:
    """Bytes this process has passed to write calls so far (``wchar`` of
    ``/proc/self/io``), deleted files included. The chip machine counts a
    call's disk writes on its host, where the run cannot read them."""
    with open("/proc/self/io") as f:
        return next(int(line.split()[1]) for line in f if line.startswith("wchar:"))


def parity_programs():
    """(label, technique class, config, whether the blocks are recomputed)
    of the offload-against-dp runs over the logits."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.offload import HostOffload

    return (("offload-stream", HostOffload, STREAM, True),
            ("offload-bulk", HostOffload, BULK, False),
            ("dp-logits", DataParallel, {"remat": False}, False))


def offload_parity(sat, flash, ce, card):
    """Phase 8a: offload stream and bulk against dp over the logits at
    GPT-2-small, b8 x 512, from one seed-0 init, one step at a time."""
    import gc

    from saturn_tpu_torch.utils import checkpoint as ckpt

    dev = torch.device(DEVICE, 0)
    runs = {}
    for label, cls, config, recompute in parity_programs():
        task = lm_task(sat, f"parity-{label}", 6e-4, OFFLOAD_STEPS,
                       os.path.join(CKPTS, "parity", label), loss_fn=untagged_loss)
        tech = cls()
        task.strategies[1] = sat.Strategy(tech, 1, config, 0.0)
        task.select_strategy(1)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        reset_counts(flash, ce)
        t0 = time.perf_counter()
        tech.execute(task, [dev], 0, override_batch_count=OFFLOAD_STEPS, window_size=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts(flash, ce)
        want = want_offload_launches(recompute, OFFLOAD_STEPS)
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")
        state = task._live_state[1]
        held = torch.cuda.memory_allocated(dev) - base
        run = {"losses": task.last_losses, "launches": got, "held_bytes": held,
               "seconds": seconds, "ms_per_step": task.last_per_batch_s * 1e3}
        if "host" in state:
            host = state["host"]
            if not host.pinned() or not next(state["params"].parameters()).is_pinned():
                raise AssertionError(f"{label}: the host state is not pinned")
            run.update(pinned_bytes=host.nbytes(),
                       splits=split_summary([r for r in tech.splits if r["task"] == task.name]))
        runs[label] = run
        log(f"  {label} {config}: losses {np.round(task.last_losses, 5).tolist()}, "
            f"{run['ms_per_step']:.1f} ms/step, launches {got}, "
            f"{held / 2**30:.3f} GiB held on the card after the steps"
            + (f", {run['pinned_bytes'] / 2**30:.2f} GiB pinned on the host" if "host" in state
               else "") + f"  [{card}]")
        for line in run.get("splits", {}).get("lines", []):
            log(f"    {line}  [{card}]")
        task.release_live_state()
        task.release_compiled()
        ckpt.flush()
    ref = runs["dp-logits"]
    n_params = sum(p.numel() for p in lm_task(
        sat, "parity-count", 6e-4, 1, CKPTS).get_model().abstract_init().parameters())
    moments = 2 * 4 * n_params
    for label in ("offload-stream", "offload-bulk"):
        diff = rel_diff(runs[label]["losses"], ref["losses"])
        bitwise = runs[label]["losses"] == ref["losses"]
        if not diff <= OFFLOAD_REL:
            raise AssertionError(f"{label}: losses {runs[label]['losses']} against dp's "
                                 f"{ref['losses']}: {diff:.3e} relative, over {OFFLOAD_REL:g}")
        below = ref["held_bytes"] - runs[label]["held_bytes"]
        if below < moments:
            raise AssertionError(f"{label} holds {runs[label]['held_bytes']} bytes on the card "
                                 f"after its steps, dp {ref['held_bytes']}: under dp's by less "
                                 f"than the AdamW moments ({moments})")
        runs[label].update(loss_rel_diff=diff, bitwise=bitwise)
        log(f"  {label} against dp over the logits: max relative loss difference {diff:.3e}"
            f" ({'bitwise equal' if bitwise else 'not bitwise'}); {below / 1e9:.2f} GB less "
            f"held on the card than dp (AdamW moments {moments / 1e9:.2f} GB)")
    return runs


class TechniqueSearches:
    """Every technique instance whose ``search`` runs inside the block."""

    def __enter__(self):
        from saturn_tpu_torch.parallel.spmd_base import SPMDTechnique

        self.cls, self.orig, self.seen = SPMDTechnique, SPMDTechnique.search, []

        def search(tech, *args, **kwargs):
            if tech not in self.seen:
                self.seen.append(tech)
            return self.orig(tech, *args, **kwargs)

        SPMDTechnique.search = search
        return self

    def __exit__(self, *exc):
        self.cls.search = self.orig

    def named(self, name):
        return next(t for t in self.seen if t.name == name)


def run_text(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=60).stdout


def gptj_task(sat, name, layers, save_dir, loss_fn=None):
    """A GPT-J-6B task at ``layers`` layers (the rest at the published
    shape), AdamW at the reference's lr, b8 x 512 synthetic tokens."""
    task = lm_task(sat, name, 1e-4, OFFLOAD_STEPS, save_dir, model=GPTJ, loss_fn=loss_fn,
                   n_layers=layers)
    cfg = task.get_model().config
    n = sum(p.numel() for p in task.get_model().abstract_init().parameters())
    log(f"  {name}: GPT-J-6B at {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, d_ff {cfg.ff_dim}, rotary {cfg.rotary_dim}, parallel residual "
        f"{cfg.parallel_residual}, vocab {cfg.vocab_size}, attention {cfg.attention}, "
        f"b{BATCH} x {SEQ}: {n:,} parameters; dp's fp32 params, grads and AdamW moments "
        f"{16 * n / 2**30:.1f} GiB, a checkpoint (params and moments) {12 * n / 2**30:.1f} GiB")
    return task, n


def gptj_dp_screen(sat, topo, save_dir):
    """8b-1's dp half, through the entry point: ``search`` with ``["dp"]`` on
    GPT-J-6B at its published depth (GPTJ_LAYERS) must find every dp config
    infeasible by the static screen (the meta-device model's fp32 params,
    grads and AdamW moments against the card) before any init is drawn, and
    leave the task no feasible strategy. Returns ``[(config, state bytes)]``
    and the parameter count."""
    task, n_params = gptj_task(sat, "gptj-6b-published", GPTJ_LAYERS, save_dir)
    sat.library.register_default_library()
    with TechniqueSearches() as searched:
        sat.search([task], technique_names=["dp"], topology=topo, profile_cache=False)
    dp = searched.named("dp")
    outcomes = [(c, o) for name, _, c, _, o in dp.trials if name == task.name]
    if not outcomes or any(o != "static" for _, o in outcomes):
        raise AssertionError(f"dp trials {dp.trials}: want every config screened out "
                             f"statically at {GPTJ_LAYERS} layers")
    if task.feasible_strategies():
        raise AssertionError(f"{task.name}: feasible strategies {task.feasible_strategies()} "
                             f"after every dp config was screened out")
    return [(c, dp.state_bytes(task, c)) for c, _ in outcomes], n_params


def gptj_search(sat, flash, ce, card, searched_inits):
    """Phase 8b-1: GPT-J-6B's dp configs screened out at its published
    depth before any init; offload's configs timed on one shared host state
    at GPTJ_SEARCH_LAYERS (cut in depth only)."""
    import gc

    save_dir = os.path.join(CKPTS, "gptj")
    os.makedirs(save_dir, exist_ok=True)
    log(f"  host: free -g\n{run_text(['free', '-g']).rstrip()}")
    facts = host_facts(run_text(["free", "-b"]), run_text(["nproc"]),
                       run_text(["df", "-B1", "--output=avail", save_dir]))
    log(f"  host: {facts['cores']} cores, {facts['mem_total'] / 2**30:.1f} GiB of memory "
        f"({facts['mem_available'] / 2**30:.1f} GiB available), "
        f"{facts['disk_free'] / 1e9:.1f} GB of disk free at {save_dir}")
    topo = topology()
    screened, n_full = gptj_dp_screen(sat, topo, save_dir)
    for c, need in screened:
        log(f"    dp {c} at {GPTJ_LAYERS} layers: {need / 2**30:.1f} GiB of train state, "
            f"infeasible by the static screen, no init drawn")
    task, n_params = gptj_task(sat, "gptj-6b", GPTJ_SEARCH_LAYERS, save_dir)
    cache_dir = os.path.join(OUT, "gptj_profile_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    with TechniqueSearches() as searched, searched_inits:
        stats = sat.search([task], technique_names=["offload"], topology=topo,
                           profile_cache=cache_dir)
    t_search = time.perf_counter() - t0
    trial_launches = counts(flash, ce)
    if not all(trial_launches[n] for n in FLASH_NAMES):
        raise AssertionError(f"{task.name}: the trials launched the flash kernels "
                             f"{trial_launches}, want each at head dim 256")
    gc.collect()
    off = searched.named("offload")
    outcomes = {"dp": [(c, "static", need) for c, need in screened],
                "offload": [(c, s, o) for _, _, c, s, o in off.trials]}
    if any(o not in ("ok", "memory") for *_, o in outcomes["offload"]):
        raise AssertionError(f"offload trials {off.trials}")
    for c, spb, o in outcomes["offload"]:
        log(f"    trial offload {c}: " + (f"{spb:.3f} s/batch" if spb is not None
                                          else "infeasible (out of device memory)")
            + f"  [{card}]")
    split = split_summary(list(off.splits))
    for line in split["lines"]:
        log(f"      trial {line}  [{card}]")
    strat = task.strategies[1]
    if not strat.feasible or strat.executor.name != "offload":
        raise AssertionError(f"gptj-6b: no offload strategy won: {strat}")
    log(f"  search: {stats}, {t_search:.1f}s; won: offload {strat.params} at "
        f"{strat.per_batch_time:.3f} s/batch; the host state drawn in "
        f"{searched_inits.seconds['state']} s, its buffers allocated and pinned in "
        f"{searched_inits.seconds['buffer']} s; the trials' launches {trial_launches}  [{card}]")
    return {"facts": facts, "layers": GPTJ_SEARCH_LAYERS, "dp_layers": GPTJ_LAYERS,
            "dp_params": n_full, "params": n_params,
            "stats": stats, "seconds": t_search, "trial_launches": trial_launches,
            "dp": outcomes["dp"],
            "offload": outcomes["offload"], "splits": split, "won": strat.params,
            "s_per_batch": strat.per_batch_time}


def grads_against(host, want: torch.Tensor):
    """The host state's gradients against ``want`` (the same flat layout, on
    the card), parameter by parameter: (relative norm of the difference,
    whether bitwise equal)."""
    num = den = 0.0
    same = True
    for _, off, n, _ in host.layout.entries:
        got = host.grads[off:off + n].to(want.device, non_blocking=True)
        ref = want[off:off + n]
        same = same and torch.equal(got, ref)
        num += float(((got - ref).double() ** 2).sum())
        den += float((ref.double() ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5, same


def gptj_train(sat, flash, ce, card, inits):
    """Phase 8b-2: GPT-J-6B at GPTJ_CKPT_LAYERS through search(["offload"])
    -> orchestrate to a checkpoint at step OFFLOAD_STEPS, restored in place;
    stream against bulk on that state and one batch."""
    import gc

    from saturn_tpu_torch.parallel.offload import HostOffload
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens
    from saturn_tpu_torch.utils import checkpoint as ckpt

    save_dir = os.path.join(CKPTS, "gptj")
    os.makedirs(save_dir, exist_ok=True)
    task, n_params = gptj_task(sat, "gptj-6b-ckpt", GPTJ_CKPT_LAYERS, save_dir)
    dev = torch.device(DEVICE, 0)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    topo = topology()
    cache_dir = os.path.join(OUT, "gptj_profile_cache")
    with inits:
        sat.search([task], technique_names=["offload"], topology=topo, profile_cache=cache_dir)
    strat = task.strategies[1]
    off = strat.executor
    log(f"  search(['offload']): won {strat.params} at {strat.per_batch_time:.3f} s/batch  "
        f"[{card}]")
    torch.cuda.reset_peak_memory_stats(dev)
    n_before = len(off.splits)
    written = bytes_written()
    log(f"  written by this run before the checkpointed run: {written / 2**30:.2f} GiB "
        f"(write calls, deleted files included)")
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    with CallTimes(write=(ckpt, "_write")) as writes, inits:
        out = sat.orchestrate([task], interval=2.0 * strat.runtime + 60.0, topology=topo)
        ckpt.flush()
    t_orch = time.perf_counter() - t0
    launches = counts(flash, ce)
    want = want_offload_launches(bool(strat.params.get("stream") or strat.params.get("remat")),
                                 OFFLOAD_STEPS, GPTJ_CKPT_LAYERS)
    if launches != want:
        raise AssertionError(f"{task.name}: orchestrate launched {launches}, want {want}")
    log(f"  orchestrate's kernel launches (head dim 256): {launches}")
    peak = {"allocated": torch.cuda.max_memory_allocated(dev),
            "reserved": torch.cuda.max_memory_reserved(dev)}
    if out["completed"] != [task.name]:
        raise AssertionError(f"{task.name} did not complete: {out}")
    steps = split_summary([r for r in list(off.splits)[n_before:] if r["task"] == task.name])
    for line in steps["lines"]:
        log(f"    {line}  [{card}]")
    ckpt_bytes = dir_bytes(task.ckpt_path)
    log(f"  orchestrate: {t_orch:.1f}s, losses {np.round(task.last_losses, 4).tolist()}; peak "
        f"{peak['allocated'] / 2**30:.2f} GiB allocated, {peak['reserved'] / 2**30:.2f} GiB "
        f"reserved on the card; checkpoint {ckpt_bytes / 1e9:.2f} GB written in "
        f"{writes.seconds['write']} s; host states drawn in {inits.seconds['state']} s "
        f"(8b so far)  [{card}]")
    if not np.isfinite(task.last_losses).all():
        raise AssertionError(f"{task.name} losses {task.last_losses}")
    gc.collect()
    torch.cuda.empty_cache()
    check_memory(f"{task.name} after orchestrate", torch.cuda.memory_allocated(dev), before)

    # stream against bulk, one state (the checkpoint, restored in place) and one batch
    tech = HostOffload()
    t0 = time.perf_counter()
    state = ckpt.restore(task.ckpt_path, tech.build(task, [dev], STREAM).empty())
    t_restore = time.perf_counter() - t0
    host = state["host"]
    if state["step"] != OFFLOAD_STEPS:
        raise AssertionError(f"{task.name} checkpoint at step {state['step']}, "
                             f"want {OFFLOAD_STEPS}")
    bad = nonfinite(dict(state["params"].named_parameters()))
    if bad:
        raise AssertionError(f"{task.name} checkpoint holds non-finite weights: {bad}")
    if not host.pinned():
        raise AssertionError(f"{task.name}: the restored host state is not pinned")
    log(f"  restored step {state['step']} in place in {t_restore:.1f}s: finite weights, "
        f"{host.nbytes() / 2**30:.2f} GiB pinned on the host")
    state["opt_state"].step = lambda: None  # the check takes no update
    at = state["step"]
    batch = stage_tokens(task.batch_at(0), dev)
    _, loss_s = tech.build(task, [dev], STREAM).step(state, batch)
    loss_s = loss_s.item()
    grads_s = host.grads.to(dev)
    _, loss_b = tech.build(task, [dev], {"stream": False, "remat": True}).step(state, batch)
    loss_b = loss_b.item()
    grad_rel, same = grads_against(host, grads_s)
    bitwise = same and loss_s == loss_b
    loss_rel = abs(loss_b - loss_s) / abs(loss_s)
    check_split = split_summary(list(tech.splits))
    for line in check_split["lines"]:
        log(f"    check {line}  [{card}]")
    del grads_s, batch
    if not (loss_rel <= STREAM_BULK_LOSS_REL and grad_rel <= STREAM_BULK_GRAD_REL):
        raise AssertionError(f"{task.name} stream loss {loss_s} against bulk {loss_b} "
                             f"({loss_rel:.3e} relative), gradients {grad_rel:.3e} by relative "
                             f"norm: over {STREAM_BULK_LOSS_REL:g} / {STREAM_BULK_GRAD_REL:g}")
    log(f"  stream against bulk on step {at}'s state: loss {loss_s:.6f} / {loss_b:.6f} "
        f"({loss_rel:.2e} relative), gradients {grad_rel:.2e} by relative norm "
        f"({'bitwise equal' if bitwise else 'not bitwise'})")
    pinned_bytes = host.nbytes()
    del state, host
    gc.collect()
    torch.cuda.empty_cache()
    check_memory(f"{task.name} after the check", torch.cuda.memory_allocated(dev), before)
    shutil.rmtree(save_dir, ignore_errors=True)
    return {"layers": GPTJ_CKPT_LAYERS, "params": n_params, "won": strat.params,
            "s_per_batch": strat.per_batch_time, "orchestrate_s": t_orch,
            "launches": launches, "written_before_bytes": written,
            "losses": task.last_losses, "steps": steps, "peak_bytes": peak,
            "pinned_bytes": pinned_bytes, "ckpt_bytes": ckpt_bytes,
            "ckpt_write_s": writes.seconds["write"], "restore_s": t_restore,
            "stream_vs_bulk": {"loss": [loss_s, loss_b], "loss_rel": loss_rel,
                               "grad_rel": grad_rel, "bitwise": bitwise,
                               "splits": check_split}}


def bundle_steps(tech, task, config, dev, steps: int):
    """``steps`` steps one at a time through the technique's bundle from the
    seed-0 init, on the task's first batches; no checkpoint is written. The
    per-step losses."""
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens

    bundle = tech.build(task, [dev], config)
    state = bundle.init()
    losses = []
    for i in range(steps):
        state, loss = bundle.step(state, stage_tokens(task.batch_at(i), dev))
        losses.append(loss.reshape(()))
    out = torch.stack(losses).float().cpu().tolist()
    del state, bundle
    return out


def gptj_parity(sat, flash, ce, card):
    """Phase 8c: GPT-J-6B at GPTJ_PARITY_LAYERS over the logits (published
    widths: head dim 256, rotary, parallel residual), 4 steps from one seed-0
    init under offload stream, offload bulk and dp; no checkpoint (12 GB
    each at this depth)."""
    import gc

    dev = torch.device(DEVICE, 0)
    task, n_params = gptj_task(sat, "gptj-6b-parity", GPTJ_PARITY_LAYERS,
                               os.path.join(CKPTS, "gptj-parity"), loss_fn=untagged_loss)
    runs = {}
    for label, cls, config, recompute in parity_programs():
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts(flash, ce)
        t0 = time.perf_counter()
        losses = bundle_steps(cls(), task, config, dev, OFFLOAD_STEPS)
        seconds = time.perf_counter() - t0
        got = counts(flash, ce)
        want = want_offload_launches(recompute, OFFLOAD_STEPS, GPTJ_PARITY_LAYERS)
        if got != want:
            raise AssertionError(f"gptj {label}: launches {got}, want {want}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"gptj {label}: losses {losses}")
        runs[label] = {"losses": losses, "launches": got, "seconds": seconds}
        log(f"  {label} {config}: losses {np.round(losses, 5).tolist()}, launches {got}, "
            f"{seconds:.1f}s with the init  [{card}]")
    ref = runs["dp-logits"]["losses"]
    for label in ("offload-stream", "offload-bulk"):
        got = runs[label]["losses"]
        diff = rel_diff(got, ref)
        if not diff <= OFFLOAD_REL:
            raise AssertionError(f"gptj {label}: losses {got} against dp's {ref}: "
                                 f"{diff:.3e} relative, over {OFFLOAD_REL:g}")
        runs[label].update(loss_rel_diff=diff, bitwise=got == ref)
        log(f"  {label} against dp over the logits: max relative loss difference {diff:.3e} "
            f"({'bitwise equal' if got == ref else 'not bitwise'})")
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": GPTJ_PARITY_LAYERS, "params": n_params, "runs": runs}


def offload_phase(sat, flash, ce, card) -> dict:
    from saturn_tpu_torch.parallel import offload as offload_mod

    log("phase 8a: offload stream and bulk against dp over the logits, GPT-2-small b8x512")
    t0 = time.perf_counter()
    out = {"parity": offload_parity(sat, flash, ce, card)}
    log(f"  phase 8a took {time.perf_counter() - t0:.1f}s")
    for label, run, inits in (("8b-1", gptj_search, "search"), ("8b-2", gptj_train, "train")):
        log(f"phase {label}: GPT-J-6B b8x512 on one card, "
            + (f"the dp screen at {GPTJ_LAYERS} layers, search(['offload']) at "
               f"{GPTJ_SEARCH_LAYERS}" if inits == "search"
               else f"{GPTJ_CKPT_LAYERS} layers, search(['offload']) -> orchestrate"))
        # every host state's allocation, pinning and draw, and its buffers alone
        timer = CallTimes(state=(offload_mod, "make_host_state"),
                          buffer=(offload_mod._HostBuffer, "__init__"))
        t0 = time.perf_counter()
        out[inits] = run(sat, flash, ce, card, timer)
        out[inits].update(phase_s=time.perf_counter() - t0, host_state_s=timer.seconds["state"],
                          host_buffer_s=timer.seconds["buffer"])
        log(f"  phase {label} took {out[inits]['phase_s']:.1f}s")
    log(f"phase 8c: GPT-J-6B b8x512 at {GPTJ_PARITY_LAYERS} layers, offload stream and bulk "
        "against dp over the logits")
    t0 = time.perf_counter()
    out["parity_gptj"] = gptj_parity(sat, flash, ce, card)
    log(f"  phase 8c took {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------------ phase 9
BUNDLED_CORPUS = os.path.join(REPO, "examples", "data", "corpus.txt")
GPT2_VOCAB = 50257            # HF GPT-2's vocabulary: the word tokenizer's cap in 9a
PLAIN_PREFIX_BYTES = 8 * 2**20  # 9a: the generated corpus's prefix also held to the plain version
SWEEP_BATCH_COUNT = 16        # 9b: batches of each task of the traced sweep
#: 9b: GPT-2-small's depth in the traced sweep, cut from 12 (depth only): its
#: trials and steps run under the profiler, whose traces grow with the depth
#: (592 MB at 12 layers), and the script's time limit is shared by every phase
#: (4 before phase 16, cut to 2 for its time)
SWEEP_TRACE_LAYERS = 2
SWEEP_LRS = ("6e-4", "1e-3")
PRETRAINED_STEPS = 3          # 9e's orchestrate and 9f's runs: steps of each
TECHNIQUE_LAYERS = 2          # 9d: GPT-2-small's depth in the user's run, cut from 12 (depth only)
PRETRAINED_LAYERS = 2         # 9e: GPT-2-small's depth, cut from 12 (depth only; 4 before phase 16)
#: 9e: the card's first loss against the ingested model's f32 loss on the
#: CPU, relative (read at 2.42e-05 on an H100); the loss of a random init of
#: the same spec must lie PRETRAINED_CONTROL times as far off, so that the
#: check tells the ingested weights from a random draw.
PRETRAINED_LOSS_REL = 5e-4
PRETRAINED_CONTROL = 5.0
GPTJ_HF_VOCAB = 50400         # HF GPT-J-6B's embedding rows (its tokenizer has 50257 ids)
GPTJ_HF_PADDED = 50432        # the preset vocab that holds them, a multiple of 128
GPTJ_HF_LAYERS = 2            # 9f: the depth of 8b-2 and 8c
WRONG_ROTARY_MIN = 5.0        # 9f: the split-half forward's distance over the interleaved one's, at least
#: 9b: a launcher that runs the sweep driver as ``python -m`` would, with
#: ``trace_dir`` passed to its ``search`` and ``orchestrate`` and the model
#: cut to a depth (lm_sweep has a flag for neither), the compile cache from
#: the environment; it writes the kernel launch counters over the whole run
#: and the trace exports' seconds.
SWEEP_LAUNCHER = r"""
import functools, json, runpy, sys, time
import torch.profiler
import saturn_tpu_torch as sat
from saturn_tpu_torch.models import gpt2
from saturn_tpu_torch.ops import ce, flash
out, trace_dir, layers = sys.argv[1], sys.argv[2], int(sys.argv[3])
exports = []
handler_of = torch.profiler.tensorboard_trace_handler
def timed_handler(*args, **kwargs):
    handler = handler_of(*args, **kwargs)
    def export(prof):
        t0 = time.perf_counter()
        handler(prof)
        exports.append(time.perf_counter() - t0)
    return export
torch.profiler.tensorboard_trace_handler = timed_handler
sat.search = functools.partial(sat.search, trace_dir=trace_dir)
sat.orchestrate = functools.partial(sat.orchestrate, trace_dir=trace_dir)
gpt2.build_gpt2 = functools.partial(gpt2.build_gpt2, n_layers=layers)
flash.reset_launch_counts()
ce.reset_launch_counts()
sys.argv = ["lm_sweep"] + sys.argv[4:]
t0 = time.perf_counter()
runpy.run_module("saturn_tpu_torch.examples.lm_sweep", run_name="__main__", alter_sys=True)
with open(out, "w") as f:
    json.dump({"launches": {**flash.LAUNCHES, **ce.LAUNCHES}, "export_s": exports,
               "seconds": time.perf_counter() - t0}, f)
"""
#: 9c: load the port's compiled code (building it where the compile cache
#: lacks it), recording every process started, and launch one kernel.
BUILD_PROBE = r"""
import json, subprocess, sys, time
started = []
class Popen(subprocess.Popen):
    def __init__(self, args, *a, **k):
        started.append(str(args[0]))
        super().__init__(args, *a, **k)
subprocess.Popen = Popen
t0 = time.perf_counter()
import torch
from saturn_tpu_torch import native
from saturn_tpu_torch.ops import flash
from saturn_tpu_torch.utils import cuda_build
t_import = time.perf_counter() - t0
t0 = time.perf_counter()
cuda_build.load_all(["flash_attn", "linear_ce"])
native.load("spase")
native.load("tokenize")
t_load = time.perf_counter() - t0
q = torch.randn(1, 2, 128, 64, device="cuda", dtype=torch.bfloat16)
o = flash.flash_attention(q, q, q, causal=True)
torch.cuda.synchronize()
print(json.dumps({"started": started, "import_s": t_import, "load_s": t_load,
                  "finite": bool(torch.isfinite(o).all()),
                  "libraries": sorted(str(cuda_build.library_path(n)) for n in
                                      ("flash_attn", "linear_ce"))
                  + sorted(str(native.library_path(n)) for n in ("spase", "tokenize"))}))
"""
#: 9d: a user's script, its technique defined in ``__main__``.
TECHNIQUE_SCRIPT = r'''
"""A user's script: a dp subclass of its own, registered under
SATURN_TPU_LIBRARY_PATH."""
from saturn_tpu_torch import library
from saturn_tpu_torch.parallel.dp import DataParallel


class ScriptDP(DataParallel):
    """dp under a name of its own, defined in the script that registers it."""

    name = "script-dp"


if __name__ == "__main__":
    library.register("script-dp", ScriptDP)
    print("registered", ScriptDP.__module__, ScriptDP.__qualname__)
'''
#: 9d: a second script that finds the technique by name and trains with it.
TECHNIQUE_USER = r"""
import json, os, sys
import saturn_tpu_torch as sat
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.utils import checkpoint as ckpt
names = sat.library.registered_names()
cls = sat.library.retrieve("script-dp")
try:
    sat.library.retrieve("jax-only")
    jax_only = "loaded"
except KeyError:
    jax_only = "absent"
task = sat.Task(get_model=lambda **kw: build_gpt2("gpt2-small", n_layers=int(sys.argv[3]), **kw),
                get_dataloader=lambda: make_lm_dataset(context_length=512, batch_size=8, seed=0),
                loss_fn=pretraining_loss, hparams=sat.HParams(lr=6e-4, batch_count=int(sys.argv[2])),
                name="script-dp-task", save_dir=sys.argv[1])
task.clear_ckpt()
stats = sat.search([task], technique_names=["script-dp"], profile_cache=False)
strategy = task.strategies[1]
result = sat.orchestrate([task], interval=60.0)
print(json.dumps({"registered": names, "qualname": cls.__qualname__, "module": cls.__module__,
                  "jax_only": jax_only, "trials": stats["trials_run"],
                  "executor": type(strategy.executor).__qualname__,
                  "completed": result["completed"], "step": ckpt.saved_step(task.ckpt_path),
                  "losses": task.last_losses}))
"""


def tokenize_timed(lm_dataset, path: str, max_vocab: int, cache_dir: str) -> dict:
    """The native tokenizer on ``path`` with an empty cache: ids, vocab
    size, seconds and MB/s."""
    shutil.rmtree(cache_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ids, vocab = lm_dataset.word_tokenize_file(path, max_vocab=max_vocab, cache_dir=cache_dir)
    seconds = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    return {"ids": ids, "vocab": vocab, "seconds": seconds, "mb": mb, "mb_per_s": mb / seconds,
            "tokens": int(ids.size), "unk_share": float((ids == 1).mean())}


def check_plain(lm_dataset, label: str, path: str, got: dict) -> float:
    """Hold native ids to ``_word_tokenize_python`` on the same file, byte
    for byte; returns the plain version's seconds."""
    with open(path, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    ids, vocab = lm_dataset._word_tokenize_python(data, GPT2_VOCAB)
    seconds = time.perf_counter() - t0
    if vocab != got["vocab"] or ids.dtype != got["ids"].dtype \
            or ids.tobytes() != got["ids"].tobytes():
        raise AssertionError(f"9a {label}: native ids ({got['tokens']}, vocab {got['vocab']}) "
                             f"differ from the plain version's ({ids.size}, vocab {vocab})")
    return seconds


def data_phase(card) -> dict:
    """Phase 9a: the corpus generator and the native word tokenizer."""
    from saturn_tpu_torch import native
    from saturn_tpu_torch.data import corpus_gen, lm_dataset

    t0 = time.perf_counter()
    native.load("tokenize")  # its first build stays out of the tokenizer's times
    build_s = time.perf_counter() - t0
    log(f"  the native tokenizer built (or found built) and loaded in {build_s:.2f}s")
    root = os.path.join(OUT, "data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    corpus = os.path.join(root, "corpus_gen.txt")
    t0 = time.perf_counter()
    info = corpus_gen.generate_corpus(corpus)
    gen_s = time.perf_counter() - t0
    log(f"  generate_corpus: {info['bytes'] / 1e6:.1f} MB, {info['tokens']:,} tokens, "
        f"{info['types']:,} types in {gen_s:.1f}s")
    out = {"generate": {**info, "seconds": gen_s}, "tokenizer_load_s": build_s}
    prefix = os.path.join(root, "corpus_gen_prefix.txt")
    with open(corpus, "rb") as f:
        head = f.read(PLAIN_PREFIX_BYTES)
    with open(prefix, "wb") as f:
        f.write(head[: head.rindex(b"\n") + 1])
    for label, path in (("bundled", BUNDLED_CORPUS), ("generated", corpus),
                        ("generated-prefix", prefix)):
        got = tokenize_timed(lm_dataset, path, GPT2_VOCAB, os.path.join(root, f"cache_{label}"))
        row = {k: v for k, v in got.items() if k != "ids"}
        if label != "generated":
            row["plain_s"] = check_plain(lm_dataset, label, path, got)
        if not (got["ids"].max() < got["vocab"] <= GPT2_VOCAB):
            raise AssertionError(f"9a {label}: ids up to {got['ids'].max()}, vocab {got['vocab']}")
        out[label] = row
        log(f"  native tokenizer, {label}: {row['mb']:.2f} MB, {row['tokens']:,} tokens, vocab "
            f"{row['vocab']}, <unk> {row['unk_share']:.4f} in {row['seconds']:.2f}s "
            f"({row['mb_per_s']:.1f} MB/s)"
            + (f"; ids byte-identical to the plain version's ({row['plain_s']:.2f}s)"
               if "plain_s" in row else "") + f"  [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    return out


def trace_kernel_events(path: str):
    """(name, start us, end us) of every kernel in a torch.profiler Chrome
    trace, in order."""
    with open(path) as f:
        trace = json.load(f)
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"),
                  key=lambda x: x[1])


def trace_launches(paths) -> dict:
    """Launches of each kernel wrapper in the traces at ``paths``, read as
    ``step_kernels`` reads a profile."""
    total = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for path in paths:
        for name, k in step_kernels(trace_kernel_events(path), 1).items():
            total[name] += int(round(k["launches_per_step"]))
    return total


def child_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def run_child(args, label: str, timeout: int, **env) -> subprocess.CompletedProcess:
    """Run a child python process from the repo's root; its output goes to
    ``chiprun_out/<label>.log``; a non-zero exit raises."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=child_env(**env),
                          capture_output=True, text=True, timeout=timeout)
    with open(os.path.join(OUT, f"{label}.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    proc.seconds = time.perf_counter() - t0
    return proc


def sweep_trace_phase(card, cache_dir: str, attempts: int = 2) -> dict:
    """Phase 9b: the port's sweep driver on the bundled corpus, traced."""
    for attempt in range(attempts):
        trace_dir = os.path.join(OUT, "sweep_trace")
        ckpts = os.path.join(CKPTS, "lm_sweep")
        counts_path = os.path.join(OUT, "sweep_trace_counts.json")
        for d in (trace_dir, ckpts, os.path.join(OUT, "sweep_profile_cache_9b")):
            shutil.rmtree(d, ignore_errors=True)
        args = ["--preset", GPT2, "--batch-sizes", str(BATCH), "--lrs", *SWEEP_LRS,
                "--batch-count", str(SWEEP_BATCH_COUNT), "--techniques", "dp",
                "--save-dir", ckpts]
        proc = run_child(["-c", SWEEP_LAUNCHER, counts_path, trace_dir,
                          str(SWEEP_TRACE_LAYERS), *args],
                         "sweep_trace", 900, SATURN_TPU_COMPILE_CACHE_DIR=cache_dir,
                         SATURN_TPU_PROFILE_CACHE_DIR=os.path.join(OUT, "sweep_profile_cache_9b"))
        steps = re.findall(r"trained steps=(\d+) remaining=(\d+)", proc.stdout)
        if len(steps) != len(SWEEP_LRS) or any(
                (int(s), int(r)) != (SWEEP_BATCH_COUNT, 0) for s, r in steps):
            raise AssertionError(f"9b: lm_sweep's tasks ended at {steps}, want "
                                 f"{SWEEP_BATCH_COUNT} steps each")
        if "tokenizer=word" not in proc.stdout or "corpus.txt" not in proc.stdout:
            raise AssertionError("9b: lm_sweep did not train on the bundled corpus")
        with open(counts_path) as f:
            counted = json.load(f)
        traces = sorted(os.path.join(trace_dir, n) for n in os.listdir(trace_dir)
                        if n.endswith(".pt.trace.json"))
        if len(traces) != 2:
            raise AssertionError(f"9b: {len(traces)} traces in {trace_dir}, want 2 "
                                 f"(search, orchestrate)")
        seen = trace_launches(traces)
        want = {n: counted["launches"][n] for n in KERNEL_NAMES}
        sizes = [os.path.getsize(p) for p in traces]  # search's, then orchestrate's
        nbytes = sum(sizes)
        row = {"traces": [os.path.basename(p) for p in traces], "trace_bytes": nbytes,
               "trace_file_bytes": sizes,
               "export_s": counted["export_s"], "launches": want, "trace_launches": seen,
               "sweep_s": counted["seconds"], "process_s": proc.seconds, "steps": steps,
               "attempt": attempt + 1}
        log(f"  lm_sweep: {len(SWEEP_LRS)} tasks x {SWEEP_BATCH_COUNT} steps at "
            f"{SWEEP_TRACE_LAYERS} layers on the bundled corpus in {counted['seconds']:.1f}s ({proc.seconds:.1f}s with the process); "
            f"traces {nbytes / 1e6:.1f} MB (search {sizes[0] / 1e6:.1f}, orchestrate "
            f"{sizes[1] / 1e6:.1f}), exported in "
            f"{', '.join(f'{s:.2f}s' for s in counted['export_s'])}  [{card}]")
        log(f"  launch counters {want}; in the traces {seen}")
        missing = [n for n in KERNEL_NAMES if not want[n]]
        if missing:
            raise AssertionError(f"9b: kernels {missing} never launched in the sweep")
        if seen == want:
            shutil.rmtree(trace_dir, ignore_errors=True)
            shutil.rmtree(ckpts, ignore_errors=True)
            return row
        SHORT_PROFILES.append({"label": "9b trace", "attempt": attempt + 1,
                               "short": {n: [seen[n], want[n]] for n in KERNEL_NAMES
                                         if seen[n] != want[n]}})
        if any(seen[n] > want[n] for n in KERNEL_NAMES) or attempt == attempts - 1:
            raise AssertionError(f"9b: the traces hold {seen} launches, the counters {want}")
        log("  the traces lost kernel events; running lm_sweep again")


def compile_cache_phase(card, cache_dir: str) -> dict:
    """Phase 9c: a fresh compile cache is built into, then loaded from with
    no compiler started."""
    shutil.rmtree(cache_dir, ignore_errors=True)
    runs = []
    for label in ("build", "hit"):
        proc = run_child(["-c", BUILD_PROBE], f"compile_cache_{label}", 900,
                         SATURN_TPU_COMPILE_CACHE_DIR=cache_dir)
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["process_s"] = proc.seconds
        if not run["finite"]:
            raise AssertionError(f"9c {label}: the flash forward gave non-finite values")
        if any(os.path.dirname(p) != os.path.realpath(cache_dir) for p in run["libraries"]):
            raise AssertionError(f"9c {label}: libraries outside the cache: {run['libraries']}")
        runs.append(run)
        log(f"  {label}: loaded {len(run['libraries'])} libraries in {run['load_s']:.2f}s "
            f"({run['process_s']:.1f}s with the process), compilers started: "
            f"{[os.path.basename(s) for s in run['started']]}  [{card}]")
    built = sorted(os.path.basename(s) for s in runs[0]["started"])
    if built != ["g++", "g++", "nvcc", "nvcc"]:
        raise AssertionError(f"9c: the fresh cache's process started {built}, want two nvcc "
                             f"and two g++")
    if runs[1]["started"]:
        raise AssertionError(f"9c: the second process started {runs[1]['started']}")
    if runs[0]["libraries"] != runs[1]["libraries"]:
        raise AssertionError("9c: the two processes loaded different libraries")
    return {"build": runs[0], "hit": runs[1]}


def technique_phase(card) -> dict:
    """Phase 9d: a technique of a user's ``__main__`` script, registered in
    one process and trained with in the next."""
    store = os.path.join(OUT, "technique_library")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store)
    script = os.path.join(OUT, "user_script.py")
    with open(script, "w") as f:
        f.write(TECHNIQUE_SCRIPT)
    # JAX-format records: one under a name of its own and one beside the
    # port's record of the same name; the port must load neither
    for name in ("jax-only", "script-dp"):
        with open(os.path.join(store, f"{name}.udp"), "wb") as f:
            f.write(b"\x80\x04not a pickle the port may read")
    run_child([script], "technique_register", 300, SATURN_TPU_LIBRARY_PATH=store)
    files = sorted(os.listdir(store))
    from saturn_tpu_torch import library

    if files != sorted(["jax-only.udp", "script-dp.udp", "script-dp" + library.SUFFIX]):
        raise AssertionError(f"9d: the store holds {files}")
    save_dir = os.path.join(CKPTS, "script_dp")
    proc = run_child(["-c", TECHNIQUE_USER, save_dir, str(PRETRAINED_STEPS),
                      str(TECHNIQUE_LAYERS)],
                     "technique_use", 600, SATURN_TPU_LIBRARY_PATH=store)
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if got["qualname"] != "ScriptDP" or got["executor"] != "ScriptDP" \
            or got["jax_only"] != "absent" or "jax-only" in got["registered"]:
        raise AssertionError(f"9d: {got}")
    if got["step"] != PRETRAINED_STEPS or got["completed"] != ["script-dp-task"] \
            or not np.isfinite(got["losses"]).all() or got["trials"] < 1:
        raise AssertionError(f"9d: the persisted technique's run: {got}")
    log(f"  {got['qualname']} from {got['module']} (registered by {os.path.basename(script)}): "
        f"GPT-2-small at {TECHNIQUE_LAYERS} layers, {got['trials']} trials, {got['step']} steps, losses "
        f"{np.round(got['losses'], 4).tolist()}; JAX .udp files left alone; "
        f"{proc.seconds:.1f}s  [{card}]")
    shutil.rmtree(save_dir, ignore_errors=True)
    return {**got, "process_s": proc.seconds, "files": files}


def seeded_normal(rng, shape, std: float, mean: float = 0.0, dtype=torch.float32):
    """A tensor of N(mean, std) drawn in fp32 from the numpy generator ``rng``,
    cast to ``dtype``."""
    t = rng.standard_normal(shape, dtype=np.float32) * np.float32(std) + np.float32(mean)
    return torch.from_numpy(t).to(dtype)


def hf_gpt2_state_dict(cfg, seed: int, vocab: int = GPT2_VOCAB, n_positions: int = 1024,
                       dtype=torch.float32) -> dict:
    """A state dict in HF ``GPT2LMHeadModel`` naming and layout (Conv1D
    weights (in, out), the ``transformer.`` prefix, the tied
    ``lm_head.weight``) at ``cfg``'s widths, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    D, F_ = cfg.d_model, cfg.ff_dim

    def draw(shape, std, mean=0.0):
        return seeded_normal(rng, shape, std, mean, dtype)

    sd = {"transformer.wte.weight": draw((vocab, D), 0.02),
          "transformer.wpe.weight": draw((n_positions, D), 0.01)}
    for i in range(cfg.n_layers):
        h = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[f"{h}{ln}.weight"] = draw((D,), 0.1, 1.0)
            sd[f"{h}{ln}.bias"] = draw((D,), 0.01)
        for name, shape in (("attn.c_attn", (D, 3 * D)), ("attn.c_proj", (D, D)),
                            ("mlp.c_fc", (D, F_)), ("mlp.c_proj", (F_, D))):
            sd[f"{h}{name}.weight"] = draw(shape, 0.02)
            sd[f"{h}{name}.bias"] = draw(shape[1:], 0.01)
    sd["transformer.ln_f.weight"] = draw((D,), 0.1, 1.0)
    sd["transformer.ln_f.bias"] = draw((D,), 0.01)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]  # tied, as HF saves it
    return sd


def hf_gptj_state_dict(cfg, seed: int, vocab: int = GPTJ_HF_VOCAB,
                       dtype=torch.float16) -> dict:
    """A state dict in HF ``GPTJForCausalLM`` naming and layout (Linear
    weights (out, in), separate q/k/v with no biases, an untied ``lm_head``
    with a bias) at ``cfg``'s widths, drawn from a numpy seed; fp16, the
    dtype of HF's ``float16`` revision."""
    rng = np.random.default_rng(seed)
    D, F_ = cfg.d_model, cfg.ff_dim

    def draw(shape, std, mean=0.0):
        return seeded_normal(rng, shape, std, mean, dtype)

    sd = {"transformer.wte.weight": draw((vocab, D), 0.02)}
    for i in range(cfg.n_layers):
        h = f"transformer.h.{i}."
        sd[h + "ln_1.weight"] = draw((D,), 0.1, 1.0)
        sd[h + "ln_1.bias"] = draw((D,), 0.01)
        for n in ("q", "k", "v", "out"):
            sd[f"{h}attn.{n}_proj.weight"] = draw((D, D), 0.02)
        sd[h + "mlp.fc_in.weight"] = draw((F_, D), 0.02)
        sd[h + "mlp.fc_in.bias"] = draw((F_,), 0.01)
        sd[h + "mlp.fc_out.weight"] = draw((D, F_), 0.02)
        sd[h + "mlp.fc_out.bias"] = draw((D,), 0.01)
    sd["transformer.ln_f.weight"] = draw((D,), 0.1, 1.0)
    sd["transformer.ln_f.bias"] = draw((D,), 0.01)
    sd["lm_head.weight"] = draw((vocab, D), 0.02)
    sd["lm_head.bias"] = draw((vocab,), 0.01)
    return sd


def interleaved_gptj_logits(sd: dict, cfg, tokens: torch.Tensor, interleaved: bool = True):
    """The plain forward of an HF GPT-J state dict in f32 on ``tokens``'
    device: HF's interleaved rotary (lane pairs (2i, 2i+1) of each head's
    first ``rotary_dim`` lanes) on q and k, and otherwise the port's model:
    eps 1e-6 norms, tanh GELU, the parallel residual, the tied head over
    ``wte`` zero-padded to ``cfg.vocab_size``. ``interleaved=False`` rotates
    split halves of the same lanes instead: the function of a mapping that
    leaves HF's lanes where they are."""
    from saturn_tpu_torch.models.gpt2 import NORM_EPS

    dev = tokens.device

    def w(key):
        return sd[key].to(dev, torch.float32)

    B, T = tokens.shape
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    rd = cfg.rotary_dim or hd
    wte = w("transformer.wte.weight")
    x = wte[tokens.long()]
    inv = 1.0 / (10000.0 ** (torch.arange(0, rd, 2, device=dev, dtype=torch.float32) / rd))
    ang = torch.arange(T, device=dev, dtype=torch.float32)[:, None] * inv[None, :]

    def rotate(t):
        r, rest = t[..., :rd], t[..., rd:]
        if interleaved:
            sin, cos = ang.sin().repeat_interleave(2, -1), ang.cos().repeat_interleave(2, -1)
            x1, x2 = r[..., ::2], r[..., 1::2]
            turned = torch.stack((-x2, x1), dim=-1).flatten(-2)
        else:
            sin, cos = ang.sin().repeat(1, 2), ang.cos().repeat(1, 2)
            x1, x2 = r[..., : rd // 2], r[..., rd // 2:]
            turned = torch.cat((-x2, x1), dim=-1)
        return torch.cat([r * cos + turned * sin, rest], dim=-1)

    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    for i in range(cfg.n_layers):
        p = f"transformer.h.{i}."
        h = F.layer_norm(x, (D,), w(p + "ln_1.weight"), w(p + "ln_1.bias"), eps=NORM_EPS)
        q, k, v = ((h @ w(f"{p}attn.{n}_proj.weight").T).view(B, T, H, hd).transpose(1, 2)
                   for n in "qkv")
        q, k = rotate(q), rotate(k)
        scores = (q @ k.transpose(-1, -2)) / float(np.sqrt(hd))
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        attn = (probs @ v).transpose(1, 2).reshape(B, T, D) @ w(p + "attn.out_proj.weight").T
        mlp = F.gelu(h @ w(p + "mlp.fc_in.weight").T + w(p + "mlp.fc_in.bias"),
                     approximate="tanh") @ w(p + "mlp.fc_out.weight").T + w(p + "mlp.fc_out.bias")
        x = x + attn + mlp
    x = F.layer_norm(x, (D,), w("transformer.ln_f.weight"), w("transformer.ln_f.bias"),
                     eps=NORM_EPS)
    head = torch.cat([wte, wte.new_zeros(cfg.vocab_size - wte.shape[0], D)])
    return x @ head.T


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def pretrained_gpt2_phase(sat, flash, ce, card) -> dict:
    """Phase 9e: GPT-2-small from an HF-named state dict under dp with the
    fused head."""
    from saturn_tpu_torch.models.gpt2 import build_gpt2, config_for
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.utils import checkpoint as ckpt

    sat.library.register_default_library()
    path = os.path.join(CKPTS, "hf_gpt2_small.pt")
    os.makedirs(CKPTS, exist_ok=True)
    t0 = time.perf_counter()
    sd = hf_gpt2_state_dict(config_for(GPT2, n_layers=PRETRAINED_LAYERS), seed=17)
    torch.save(sd, path)
    del sd
    write_s = time.perf_counter() - t0
    task = lm_task(sat, "gpt2s-pretrained", 6e-4, PRETRAINED_STEPS,
                   os.path.join(CKPTS, "gpt2_pretrained"), pretrained=path,
                   n_layers=PRETRAINED_LAYERS)
    dev = torch.device(DEVICE, 0)
    reset_counts(flash, ce)
    first = bundle_steps(DataParallel(), task, {"attention": "flash", "remat": False}, dev, 1)[0]
    got = counts(flash, ce)
    if got != want_launches("flash", None, layers=PRETRAINED_LAYERS):
        raise AssertionError(f"9e: the first step's launches {got}")
    t0 = time.perf_counter()
    tokens = torch.from_numpy(task.batch_at(0)).long()
    cpu_loss = {}
    for label, pretrained in (("ingested", path), ("random", None)):
        spec = build_gpt2(GPT2, pretrained=pretrained, dtype=torch.float32, attention="dense",
                          n_layers=PRETRAINED_LAYERS)
        model = spec.init_fn(torch.Generator().manual_seed(0))
        with torch.no_grad():
            cpu_loss[label] = task.loss_fn(spec.apply_fn(model, tokens), tokens).item()
        del model
    cpu_s = time.perf_counter() - t0
    want, random_loss = cpu_loss["ingested"], cpu_loss["random"]
    diff = abs(first - want) / abs(want)
    control = abs(first - random_loss) / abs(random_loss)
    log(f"  first step's loss on the card (bf16, flash, fused head) {first:.6f}, the same "
        f"ingested model's f32 loss on the CPU {want:.6f}: {diff:.2e} relative (limit "
        f"{PRETRAINED_LOSS_REL:g}); a random init's f32 loss {random_loss:.6f}: {control:.2e} "
        f"relative ({cpu_s:.1f}s on the CPU)  [{card}]")
    if not diff <= PRETRAINED_LOSS_REL:
        raise AssertionError(f"9e: {first} against {want}, over {PRETRAINED_LOSS_REL}")
    if not control >= PRETRAINED_CONTROL * PRETRAINED_LOSS_REL:
        raise AssertionError(f"9e: the card's loss {first} lies {control:.2e} from a random "
                             f"init's {random_loss}, under {PRETRAINED_CONTROL:g} x the limit")
    topo = topology()
    stats = sat.search([task], technique_names=["dp"], topology=topo, profile_cache=False)
    result = sat.orchestrate([task], interval=60.0, topology=topo)
    step = ckpt.saved_step(task.ckpt_path)
    losses = task.last_losses
    if result["completed"] != [task.name] or step != PRETRAINED_STEPS \
            or not np.isfinite(losses).all():
        raise AssertionError(f"9e: orchestrate {result}, step {step}, losses {losses}")
    log(f"  search ({stats['trials_run']} trials) -> orchestrate: {step} steps, losses "
        f"{np.round(losses, 5).tolist()}  [{card}]")
    task.release_live_state()
    os.unlink(path)
    shutil.rmtree(task.save_dir, ignore_errors=True)
    return {"first_loss": first, "cpu_f32_loss": want, "rel_diff": diff,
            "random_f32_loss": random_loss, "rel_diff_random": control, "write_s": write_s,
            "cpu_s": cpu_s, "trials": stats["trials_run"], "step": step, "losses": losses}


def pretrained_gptj_phase(sat, flash, ce, card) -> dict:
    """Phase 9f: GPT-J-6B at GPTJ_HF_LAYERS layers from an fp16 HF-named
    state dict, under offload bulk and dp, and its logits against the plain
    interleaved-rotary forward."""
    import gc

    from saturn_tpu_torch.models.gpt2 import config_for
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.offload import HostOffload

    cfg = config_for(GPTJ, n_layers=GPTJ_HF_LAYERS, vocab_size=GPTJ_HF_PADDED)
    path = os.path.join(CKPTS, "hf_gptj_6b.pt")
    os.makedirs(CKPTS, exist_ok=True)
    written0 = bytes_written()
    t0 = time.perf_counter()
    sd = hf_gptj_state_dict(cfg, seed=23)
    torch.save(sd, path)
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    log(f"  an HF GPT-J state dict, {GPTJ_HF_LAYERS} layers, vocab {GPTJ_HF_VOCAB}, fp16: "
        f"{nbytes / 1e9:.2f} GB written in {write_s:.1f}s")
    task = lm_task(sat, "gptj-pretrained", 1e-4, PRETRAINED_STEPS,
                   os.path.join(CKPTS, "gptj_pretrained"), model=GPTJ, loss_fn=untagged_loss,
                   n_layers=GPTJ_HF_LAYERS, vocab_size=GPTJ_HF_PADDED, pretrained=path)
    dev = torch.device(DEVICE, 0)
    runs = {}
    for label, cls, config in (("offload-bulk", HostOffload, BULK),
                               ("dp-logits", DataParallel, {"remat": False})):
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts(flash, ce)
        t0 = time.perf_counter()
        losses = bundle_steps(cls(), task, config, dev, PRETRAINED_STEPS)
        seconds = time.perf_counter() - t0
        got = counts(flash, ce)
        want = want_offload_launches(False, PRETRAINED_STEPS, GPTJ_HF_LAYERS)
        if got != want:
            raise AssertionError(f"9f {label}: launches {got}, want {want}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"9f {label}: losses {losses}")
        runs[label] = {"losses": losses, "launches": got, "seconds": seconds}
        log(f"  {label}: losses {np.round(losses, 5).tolist()}, launches {got}, {seconds:.1f}s "
            f"with the ingest  [{card}]")
    diff = rel_diff(runs["offload-bulk"]["losses"], runs["dp-logits"]["losses"])
    if not diff <= OFFLOAD_REL:
        raise AssertionError(f"9f: offload bulk against dp: {diff:.3e} relative, over "
                             f"{OFFLOAD_REL:g}")
    gc.collect()
    torch.cuda.empty_cache()
    spec = task.get_model()
    model = spec.init_fn(torch.Generator().manual_seed(0), dev)
    tokens = torch.from_numpy(task.batch_at(0)).to(dev, torch.long)
    with torch.no_grad():
        logits = spec.apply_fn(model, tokens)
        del model
        torch.cuda.empty_cache()
        ref = interleaved_gptj_logits(sd, cfg, tokens)
        err = rel_norm(logits, ref)
        del ref
        wrong = rel_norm(logits, interleaved_gptj_logits(sd, cfg, tokens, interleaved=False))
    del logits, sd
    log(f"  logits (bf16, flash at head dim 256) against the plain interleaved-rotary f32 "
        f"forward: {err:.3e} relative norm (band {BF16_BAND:g}); against split halves on HF's "
        f"lanes: {wrong:.3e}  [{card}]")
    if not err <= BF16_BAND or not wrong >= WRONG_ROTARY_MIN * err:
        raise AssertionError(f"9f: logits {err:.3e} from the interleaved forward, {wrong:.3e} "
                             f"from the split-half one")
    os.unlink(path)
    shutil.rmtree(task.save_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    written = bytes_written() - written0
    log(f"  offload bulk against dp: {diff:.3e} relative; {written / 2**30:.2f} GiB passed to "
        f"write calls in 9f")
    return {"layers": GPTJ_HF_LAYERS, "file_bytes": nbytes, "write_s": write_s, "runs": runs,
            "loss_rel_diff": diff, "logits_rel": err, "logits_rel_split_halves": wrong,
            "bytes_written": written}


def data_api_phase(sat, flash, ce, card) -> dict:
    """Phase 9: what users hand the four calls and what they get back. 9c
    runs before 9b, whose lm_sweep run then loads its kernels from 9c's cache."""
    out = {}
    cache_dir = os.path.join(OUT, "compile_cache")
    torch.cuda.empty_cache()
    for label, title, run in (
            ("data", "9a: corpus_gen and the native word tokenizer", lambda: data_phase(card)),
            ("compile_cache", "9c: the compile cache, built then hit",
             lambda: compile_cache_phase(card, cache_dir)),
            ("sweep", "9b: the sweep driver (lm_sweep) on the bundled corpus, traced",
             lambda: sweep_trace_phase(card, cache_dir)),
            ("technique", "9d: a persisted technique from a user's __main__",
             lambda: technique_phase(card)),
            ("gpt2", "9e: pretrained GPT-2-small (HF names) under dp, fused head",
             lambda: pretrained_gpt2_phase(sat, flash, ce, card)),
            ("gptj", f"9f: pretrained GPT-J-6B at {GPTJ_HF_LAYERS} layers (HF names, fp16) "
                     f"under offload bulk and dp",
             lambda: pretrained_gptj_phase(sat, flash, ce, card))):
        log(f"phase {title}")
        t0 = time.perf_counter()
        out[label] = run()
        out[label]["phase_s"] = time.perf_counter() - t0
        log(f"  phase {title.split(':')[0]} took {out[label]['phase_s']:.1f}s")
    shutil.rmtree(cache_dir, ignore_errors=True)
    return out


# ----------------------------------------------------------------- phase 10
FUSED_LRS = (1e-4, 3e-4, 6e-4, 1e-3)   # 10a-10c: the members, differing only in lr
FUSED_BATCHES = 16                    # 10c: each member's budget
FUSED_INTERVAL_SHARE = 0.6            # 10c: interval over a member's solo runtime (2 intervals)
# 10b: fused against solo after 9 steps, set from the card's readings (at most 1.14e-4 for
# the losses, 1.23e-3 for the params; the batched products sum in another order, and AdamW
# moves near-zero-gradient weights by up to lr on rounding noise), under BF16_BAND
FUSED_LOSS_REL = 1e-3                 # losses, relative, per step
FUSED_PARAM_REL = 5e-3                # params, by relative norm
FUSED_SMALL_BATCH = 2                 # 10c: rows a batch of each member (stacking pays there)
UNFUSE_BATCHES = 12                   # 10d: each member's budget
UNFUSE_POLL = 2                       # 10d: member 2 detaches at its third poll (after the window)
UNFUSE_MARKED = 4                     # 10d: member 3's dataset index whose loss is NaN
COSCHEDULE_BATCHES = 10               # 10e: each member's budget
FUSED_LAYERS = 4                      # 10a-10c and 10e: GPT-2-small's and BERT-base's depth,
                                      # cut from 12 (depth only; their searches hit phase 6's
                                      # and phase 7's entries of that depth)


def flash_per_step(config, name: str = "flash_dq", layers: int = 0) -> int:
    """Launches of flash kernel ``name`` per (lockstep) step under
    ``config`` at ``layers`` (0: LAYERS): one per layer with flash
    attention (the members folded into its batch), the forward twice with
    remat (the backward recomputes each block), none with dense."""
    config = config or {}
    if config.get("attention") != "flash":
        return 0
    return (layers or LAYERS) * (2 if name == "flash_fwd" and config.get("remat") else 1)


def fused_tasks(sat, save_dir, loss_fn=None, wrap=None, batches=FUSED_BATCHES, prefix="fused",
                batch=None, **kwargs):
    """GPT-2-small tasks (b``batch`` x 512, BATCH rows by default, at
    FUSED_LAYERS unless ``n_layers`` says) differing only in lr
    (FUSED_LRS); ``wrap`` maps a member index to its dataset wrapper;
    ``kwargs`` go to the model."""
    kwargs.setdefault("n_layers", FUSED_LAYERS)
    return [lm_task(sat, f"{prefix}-lr{i}", lr, batches, save_dir, model=GPT2, loss_fn=loss_fn,
                    wrap=(wrap(i) if wrap else None), seq=SEQ, batch=batch, **kwargs)
            for i, lr in enumerate(FUSED_LRS)]


def seeded_cache(name: str) -> str:
    """A fresh profile cache under chiprun_out/ seeded with the entries of
    phase 3 (GPT-2-small and BERT-base at b8 x 512), phase 6 (GPT-2-small
    over the logits) and phase 7 (GPT-2-small at KILL_LAYERS), where they
    ran."""
    cache_dir = os.path.join(OUT, name)
    shutil.rmtree(cache_dir, ignore_errors=True)
    os.makedirs(cache_dir)
    for seed in ("main_path_profile_cache", "sweep_profile_cache", "kill_replay_profile_cache"):
        seed = os.path.join(OUT, seed)
        for entry in (os.listdir(seed) if os.path.isdir(seed) else ()):
            shutil.copy(os.path.join(seed, entry), cache_dir)
    return cache_dir


def stage_window(tasks, first: int, k: int):
    """The (K, M, B, T) window of batches first..first+K-1 of ``tasks``."""
    from saturn_tpu_torch.ops import stacking
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens

    host = np.stack([stacking.stack_member_batches([t.batch_at(first + j) for t in tasks])
                     for j in range(k)])
    return stage_tokens(host, torch.device(DEVICE, 0))


def fused_search(sat, card, tasks, topo, label="10a"):
    """10a: search on the members; one fusion group measured, every member's
    lockstep time and host fraction set. Returns what was measured and
    whether the solver's pricing (``milp.fusion_priced_groups``, the JAX
    package's rule) fuses the group."""
    from saturn_tpu_torch.executor.orchestrator import _static_fusion_gate
    from saturn_tpu_torch.solver import milp

    cache_dir = seeded_cache("fused_profile_cache")
    t0 = time.perf_counter()
    stats = sat.search(tasks, technique_names=["dp"], topology=topo, profile_cache=cache_dir)
    t_search = time.perf_counter() - t0
    if stats["fused_groups"] != 1:
        raise AssertionError(f"{label}: search measured {stats['fused_groups']} fused groups, "
                             f"want 1")
    strats = [t.strategies[1] for t in tasks]
    if any(s.fused_per_batch_time is None for s in strats):
        raise AssertionError(f"{label}: a member has no fused_per_batch_time")
    if any(not s.host_fraction > 0.0 for s in strats):
        raise AssertionError(f"{label}: host fractions {[s.host_fraction for s in strats]}")
    lock = strats[0].fused_per_batch_time
    solo = strats[0].per_batch_time
    priced = milp.fusion_priced_groups(tasks, [[t.name for t in tasks]], topo,
                                       fusion_fits=_static_fusion_gate(topo))
    rows = tasks[0].get_dataset().batch_size
    log(f"  {label} search, b{rows} x {SEQ}: {stats['trials_run']} trials, "
        f"{stats['cache_hits']} cache hits, {stats['fused_groups']} fused group, "
        f"{t_search:.1f}s; config {strats[0].params}; lockstep {lock * 1e3:.2f} ms for "
        f"{len(tasks)} members against {len(tasks)} x solo {solo * 1e3:.2f} = "
        f"{len(tasks) * solo * 1e3:.2f} ms ({len(tasks) * solo / lock:.3f}x); host fractions "
        f"{[round(s.host_fraction, 5) for s in strats]}; the solver's pricing "
        f"{'fuses' if priced else 'does not fuse'} the group  [{card}]")
    return {"search": stats, "search_s": t_search, "config": strats[0].params,
            "batch": rows, "lockstep_s": lock, "solo_per_batch_s": solo,
            "host_fractions": [s.host_fraction for s in strats], "priced": bool(priced)}


def fused_against_solo(sat, flash, ce, card, tasks, k=WINDOW):
    """10b: the stacked program against four solo runs from the same init
    (seed 0) and batches: an eager step, then one window of K (a CUDA graph),
    for each. Losses and final params compared, launches of the stacked
    window exact, its peak memory."""
    from saturn_tpu_torch.parallel import fused
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens

    dev = torch.device(DEVICE, 0)
    tech = tasks[0].strategies[1].executor
    config = dict(tasks[0].strategies[1].params)
    solo_losses, solo_params, solo_ms = [], [], []
    for t in tasks:
        bundle = tech.build(t, [dev], config)
        state = bundle.init()
        state, l0 = bundle.warm_step(state, stage_tokens(t.batch_at(0), dev))
        win = bundle.fused(k)
        batch = stage_tokens(np.stack([t.batch_at(1 + j) for j in range(k)]), dev)
        win.capture(state, batch.shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, ls = win(state, batch)
        torch.cuda.synchronize()
        solo_ms.append((time.perf_counter() - t0) * 1e3 / k)
        solo_losses.append(torch.cat([l0.reshape(1).float(), ls]).cpu().numpy())
        solo_params.append({n: p.detach().clone() for n, p in state["params"].named_parameters()})
        del state, win
        tech.release_task(t.name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    prog = fused.build_fused_program(tasks, [dev], inner=tech, config=config)
    state = fused.stack_state(prog, [prog.init_member_tree()] * len(tasks),
                              [t.hparams.lr for t in tasks], [0] * len(tasks))
    state, l0 = prog.bundle.warm_step(state, stage_window(tasks, 0, 1)[0])
    win = prog.bundle.fused(k)
    batch = stage_window(tasks, 1, k)
    win.capture(state, batch.shape)
    torch.cuda.synchronize()
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    state, ls = win(state, batch)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3 / k
    launched = counts(flash, ce)
    # over the eager step, the capture and the replay: the graph's pool is
    # reserved memory
    peak = {"allocated": torch.cuda.max_memory_allocated(dev),
            "reserved": torch.cuda.max_memory_reserved(dev)}
    m = len(tasks)
    want = {**{n: flash_per_step(config, n, FUSED_LAYERS) * k for n in FLASH_NAMES},
            **{n: m * k for n in CE_NAMES}}
    if launched != want:
        raise AssertionError(f"10b: the stacked window launched {launched}, want {want}")
    fused_losses = torch.cat([l0.reshape(1, m).float(), ls]).cpu().numpy()
    rows, bitwise = [], True
    for i, t in enumerate(tasks):
        lrel = rel_diff(fused_losses[:, i], solo_losses[i])
        num = den = 0.0
        pmax = 0.0
        for n, p in state["params"].named_parameters():
            d = (p.detach()[i] - solo_params[i][n]).float()
            num += float((d * d).sum())
            den += float((solo_params[i][n].float() ** 2).sum())
            pmax = max(pmax, float(d.abs().max()))
        prel = (num / max(den, 1e-30)) ** 0.5
        same = lrel == 0.0 and pmax == 0.0
        bitwise = bitwise and same
        rows.append({"task": t.name, "loss_rel": lrel, "param_rel_norm": prel,
                     "param_max_abs": pmax, "bitwise": same,
                     "fused_losses": fused_losses[:, i].tolist(),
                     "solo_losses": solo_losses[i].tolist()})
        log(f"  10b {t.name}: {k + 1} steps, losses {solo_losses[i][0]:.4f} -> "
            f"{solo_losses[i][-1]:.4f} solo, {fused_losses[-1, i]:.4f} fused; fused against solo: "
            f"losses {lrel:.3e} relative, params {prel:.3e} by relative norm, {pmax:.3e} max "
            f"abs{' (bitwise)' if same else ''}  [{card}]")
        if lrel > FUSED_LOSS_REL or prel > FUSED_PARAM_REL:
            raise AssertionError(f"10b {t.name}: fused against solo {lrel:.3e} (losses), "
                                 f"{prel:.3e} (params), over {FUSED_LOSS_REL} / "
                                 f"{FUSED_PARAM_REL}")
    log(f"  10b stacked window of {k}: {fused_ms:.2f} ms per lockstep step against solo "
        f"{[round(x, 2) for x in solo_ms]} ms per step ({sum(solo_ms):.2f} summed; host clock, "
        f"one replay each, synchronized); launches {launched} (exact); peak "
        f"{peak['allocated'] / 2**30:.2f} GiB allocated, {peak['reserved'] / 2**30:.2f} GiB "
        f"reserved; bitwise {bitwise}  [{card}]")
    del state, win
    fused.release_programs()
    torch.cuda.empty_cache()
    return {"rows": rows, "bitwise": bitwise, "lockstep_ms": fused_ms, "solo_ms": solo_ms,
            "launches": launched, "peak_bytes": peak, "k": k}


def fused_orchestrate(sat, flash, ce, card, tasks, topo):
    """10c: orchestrate the members with a journal and a metrics file; the
    plan fuses them, each reaches its budget."""
    from saturn_tpu_torch import analysis, durability
    from saturn_tpu_torch.solver import anytime, milp
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import metrics

    journal = os.path.join(OUT, "fused_journal")
    events_path = os.path.join(OUT, "fused_events.jsonl")
    shutil.rmtree(journal, ignore_errors=True)
    if os.path.exists(events_path):
        os.unlink(events_path)
    names = [t.name for t in tasks]
    # the forecast gives each member interval / its solo per-batch time
    # batches (the JAX package's rule), so this splits the budget in two
    interval = FUSED_INTERVAL_SHARE * FUSED_BATCHES * tasks[0].strategies[1].per_batch_time
    priced = anytime.anytime_resolve(tasks, topo, None, interval, fusion=[names])
    solo = anytime.anytime_resolve(tasks, topo, None, interval)
    serial = sum(t.strategies[1].runtime for t in tasks)
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    with CheckedWrites(ckpt) as writes:
        out = sat.orchestrate(tasks, interval=interval, topology=topo, metrics_path=events_path,
                              resume_dir=journal)
    t_orch = time.perf_counter() - t0
    launches = counts(flash, ce)
    if sorted(out["completed"]) != sorted(names) or out["failed"]:
        raise AssertionError(f"10c: completed {out['completed']}, failed {out['failed']}")
    records = durability.replay(journal, strict=True)
    commits = [r["data"]["plan"] for r in records if r["kind"] == "plan_commit"]
    plan = milp.Plan.from_json(commits[0])
    if plan.fused != [names]:
        raise AssertionError(f"10c: the first plan's fusion groups {plan.fused}, want [{names}]")
    analysis.verify_or_raise(plan, topology=topo, tasks=tasks, source="10c")
    for t in tasks:
        step = ckpt.load(t.ckpt_path)["step"]
        if step != FUSED_BATCHES:
            raise AssertionError(f"10c {t.name}: checkpoint step {step}, want {FUSED_BATCHES}")
    evs = metrics.read_events(events_path, kind="fused_interval")
    covered = {n for e in evs for n in e["members"]}
    if covered != set(names):
        raise AssertionError(f"10c: fused_interval events cover {sorted(covered)}")
    lockstep = sum(e["batches"] for e in evs)
    want = {**{n: flash_per_step(tasks[0].strategies[1].params, n, FUSED_LAYERS) * lockstep
               for n in FLASH_NAMES},
            **{n: len(names) * lockstep for n in CE_NAMES}}
    if lockstep != FUSED_BATCHES or launches != want:
        raise AssertionError(f"10c: {lockstep} lockstep steps, launches {launches}, want {want}")
    for t in tasks:
        steps = writes.steps(t.ckpt_path)
        if steps != np.cumsum([e["batches"] for e in evs]).tolist():
            raise AssertionError(f"10c {t.name}: checkpoint writes at {steps}")
    log(f"  10c orchestrate: {len(evs)} fused intervals of {[e['batches'] for e in evs]} "
        f"lockstep steps at {[round(e['per_step_s'] * 1e3, 2) for e in evs]} ms each, interval "
        f"{interval:.3f}s, {t_orch:.1f}s; plan fused {plan.fused} (verified, replayed strictly "
        f"from the journal: {len(commits)} plan commits); solver's makespan {priced.makespan:.3f}s "
        f"fused against {solo.makespan:.3f}s solo ({solo.makespan / max(priced.makespan, 1e-9):.3f}"
        f"x; the solo plan's serial sum of runtimes {serial:.3f}s, the rest its ordering slack "
        f"between tasks on one device); every checkpoint at step {FUSED_BATCHES}; launches "
        f"{launches} (exact)  [{card}]")
    for t in tasks:
        t.release_live_state()
        t.release_compiled()
    return launches, {"interval_s": interval, "orchestrate_s": t_orch,
                      "fused_intervals": evs, "makespan_fused_s": priced.makespan,
                      "makespan_solo_s": solo.makespan, "serial_runtime_s": serial,
                      "plan_commits": len(commits),
                      "launches": launches}


class DetachAfterPolls:
    """Make a task's ``_fused_detach`` flag read True from its
    ``polls``-th read on: the stack's unit-boundary poll unfuses it there."""

    def __init__(self, task, polls: int):
        self.task, self.polls, self.reads = task, polls, 0
        cls = type(task)
        outer = self

        def read(_):
            outer.reads += 1
            return outer.reads > outer.polls

        task.__class__ = type("Detaching" + cls.__name__, (cls,),
                              {"_fused_detach": property(read, lambda *_: None)})


def unfuse_phase(sat, flash, ce, card, topo):
    """10d: four members over the logits (``nan_on_mark_loss``) in a fused
    plan through ``engine.execute``: member 3's batch UNFUSE_MARKED is
    marked (a NaN on the card), member 2 detaches after the first window.
    Member 3 faults alone, 0 and 1 commit, 2 resumes solo to its budget.
    At phase 6's depth (SWEEP_LAYERS, cut in depth only), whose profile
    entry over the logits its search reuses."""
    from saturn_tpu_torch.core.mesh import Block
    from saturn_tpu_torch.executor import engine
    from saturn_tpu_torch.health import NumericFaultError
    from saturn_tpu_torch.parallel import fused
    from saturn_tpu_torch.solver import milp
    from saturn_tpu_torch.utils import checkpoint as ckpt

    save_dir = os.path.join(CKPTS, "unfuse")
    tasks = fused_tasks(sat, save_dir, loss_fn=nan_on_mark_loss, batches=UNFUSE_BATCHES,
                        prefix="unfuse",
                        wrap=lambda i: ((lambda ds: PoisonedDataset(ds, UNFUSE_MARKED, MARK))
                                        if i == 3 else None), n_layers=SWEEP_LAYERS)
    # the plan is hand-built: no fused trial
    sat.search(tasks, technique_names=["dp"], topology=topo,
               profile_cache=seeded_cache("unfuse_profile_cache"), fusion=False)
    names = [t.name for t in tasks]
    plan = milp.Plan({n: milp.Assignment(1, Block(0, 1), 0.0, 1.0) for n in names},
                     makespan=1.0, fused=[names])
    plan.compute_dependencies()
    DetachAfterPolls(tasks[2], UNFUSE_POLL)
    saves: list = []
    real_save = ckpt.save

    def counted_save(path, state):
        saves.append((path, int(state["step"])))
        return real_save(path, state)

    reset_counts(flash, ce)
    done: list = []
    ckpt.save = counted_save
    t0 = time.perf_counter()
    try:
        with CheckedWrites(ckpt) as writes:
            errors = engine.execute(tasks, {n: UNFUSE_BATCHES for n in names}, 1000.0, plan,
                                    topo, failure_policy="drop",
                                    on_task_done=lambda n, b: done.append((n, b)))
            ckpt.flush()
    finally:
        ckpt.save = real_save
    seconds = time.perf_counter() - t0
    launches = counts(flash, ce)
    sick, leaver = tasks[3], tasks[2]
    if set(errors) != {sick.name} or not isinstance(errors[sick.name], NumericFaultError):
        raise AssertionError(f"10d: errors {errors}, want one numeric fault of {sick.name}")
    steps = {t.name: writes.steps(t.ckpt_path) for t in tasks}
    unfused_at = [s for p, s in saves if p == leaver.ckpt_path]
    if len(unfused_at) != 1:
        raise AssertionError(f"10d: {leaver.name} unfuse writes {unfused_at}")
    d = unfused_at[0]
    want = {names[0]: [UNFUSE_BATCHES], names[1]: [UNFUSE_BATCHES],
            names[2]: [UNFUSE_BATCHES], names[3]: []}
    if steps != want or not 0 < d < UNFUSE_BATCHES:
        raise AssertionError(f"10d: async writes {steps}, want {want}; unfused at {d}")
    runs = [r for r in leaver.strategies[1].executor.intervals if r["task"] == leaver.name]
    check_writes(leaver.name, [d] + steps[leaver.name],
                 [{"n": d}] + runs[-1:], UNFUSE_BATCHES)
    if sorted(done) != sorted((n, UNFUSE_BATCHES) for n in names[:3]):
        raise AssertionError(f"10d: progress {done}")
    if leaver.current_batch != UNFUSE_BATCHES or not runs[-1]["restored"]:
        raise AssertionError(f"10d: {leaver.name} cursor {leaver.current_batch}, "
                             f"solo resume {runs[-1:]}")
    lock = 2 * UNFUSE_BATCHES - d  # stack steps plus the leaver's solo steps
    want_l = {**{n: flash_per_step(tasks[0].strategies[1].params, n, SWEEP_LAYERS) * lock
                 for n in FLASH_NAMES},
              **{n: 0 for n in CE_NAMES}}
    if launches != want_l:
        raise AssertionError(f"10d: launches {launches}, want {want_l}")
    err = errors[sick.name]
    log(f"  10d: {sick.name} faulted alone ({err.cause} at interval step {err.step}, dataset "
        f"batches {list(err.batch_indices)}), no write; {names[0]}, {names[1]} committed at "
        f"step {UNFUSE_BATCHES}; {leaver.name} unfused at step {d} (synchronous write), resumed "
        f"solo from that checkpoint for {UNFUSE_BATCHES - d} batches and wrote step "
        f"{steps[leaver.name]}; launches {launches} (exact: {lock} steps x "
        f"{flash_per_step(tasks[0].strategies[1].params, layers=SWEEP_LAYERS)}); "
        f"{seconds:.1f}s  [{card}]")
    for t in tasks:
        t.release_live_state()
        t.release_compiled()
    fused.release_programs()
    shutil.rmtree(save_dir, ignore_errors=True)
    return launches, {"unfused_at": d, "fault": {"task": sick.name, "cause": err.cause,
                                                 "step": err.step},
                      "writes": steps, "seconds": seconds}


def coschedule_phase(sat, flash, ce, card, topo):
    """10e: a GPT-2-small and a BERT-base task on one block, a hand-built
    co-schedule plan through ``engine.execute``: both members' losses and
    checkpoints equal their solo runs' bitwise."""
    from saturn_tpu_torch import analysis
    from saturn_tpu_torch.core.mesh import Block
    from saturn_tpu_torch.executor import engine
    from saturn_tpu_torch.solver import milp
    from saturn_tpu_torch.utils import checkpoint as ckpt

    save_dir = os.path.join(CKPTS, "coschedule")
    cache = seeded_cache("coschedule_profile_cache")

    def pair(suffix):
        ts = [lm_task(sat, f"co-gpt2{suffix}", 6e-4, COSCHEDULE_BATCHES, save_dir, model=GPT2,
                      seq=SEQ, n_layers=FUSED_LAYERS),
              lm_task(sat, f"co-bert{suffix}", 1e-3, COSCHEDULE_BATCHES, save_dir, model=BERT,
                      seq=SEQ, n_layers=FUSED_LAYERS)]
        sat.search(ts, technique_names=["dp"], topology=topo, profile_cache=cache)
        return ts

    solos, co = pair("-solo"), pair("")
    dev = torch.device(DEVICE, 0)
    serial = []
    for t in solos:
        t.select_strategy(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.selected_strategy.executor.execute(t, [dev], 0, override_batch_count=COSCHEDULE_BATCHES)
        torch.cuda.synchronize()
        serial.append(time.perf_counter() - t0)
        t.release_live_state()
        t.release_compiled()
    plan = milp.Plan({t.name: milp.Assignment(1, Block(0, 1), 0.0, t.strategies[1].runtime)
                      for t in co}, makespan=max(t.strategies[1].runtime for t in co),
                     coschedule=[[t.name for t in co]])
    plan.compute_dependencies()
    analysis.verify_or_raise(plan, topology=topo, tasks=co, source="10e")
    reset_counts(flash, ce)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errors = engine.execute(co, {t.name: COSCHEDULE_BATCHES for t in co}, 1000.0, plan, topo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(flash, ce)
    if errors:
        raise AssertionError(f"10e: {errors}")
    ckpt.flush()
    for s, t in zip(solos, co):
        if t.last_losses != s.last_losses:
            raise AssertionError(f"10e {t.name}: losses {t.last_losses} differ from solo "
                                 f"{s.last_losses}")
        check_same_state(t.name, ckpt.load(s.ckpt_path), ckpt.load(t.ckpt_path))
    hfs = {t.name: t.strategies[1].host_fraction for t in co}
    choices = {t.name: [(1, Block(0, 1), t.strategies[1].runtime)] for t in co}
    cands = milp.coschedule_candidates(co, choices, 1.15)
    solved = milp.solve(co, topo, time_limit=5.0)
    log(f"  10e: {co[0].name} + {co[1].name} interleaved on one block, {COSCHEDULE_BATCHES} "
        f"batches each, losses and checkpoints bitwise equal to their solo runs; wall "
        f"{wall:.3f}s interleaved against {sum(serial):.3f}s serial ({serial[0]:.3f} + "
        f"{serial[1]:.3f}; both with their captures); host fractions "
        f"{ {n: round(v, 5) for n, v in hfs.items()} }; solve at coschedule_min_gain 1.15: "
        f"{'co-locates' if solved.coschedule else 'does not co-locate'} the pair "
        f"(candidates {[(a, b) for a, b, _ in cands]}); launches {launches}  [{card}]")
    for t in co:
        t.release_live_state()
        t.release_compiled()
    shutil.rmtree(save_dir, ignore_errors=True)
    return launches, {"wall_s": wall, "serial_s": serial, "host_fractions": hfs,
                      "solver_coschedules": solved.coschedule, "candidates": len(cands)}


def kernels_by_name(prof, steps: int) -> dict:
    """{kernel name (90 characters): [ms per step, launches per step]} of a
    torch.profiler run over ``steps`` steps."""
    out: dict = {}
    for name, a, b in device_events(prof):
        row = out.setdefault(name[:90], [0.0, 0.0])
        row[0] += (b - a) / 1e3 / steps
        row[1] += 1.0 / steps
    return out


def fused_profile(sat, card, k=WINDOW, batches=(BATCH, FUSED_SMALL_BATCH)) -> dict:
    """Where a stacked lockstep step's time goes against four solo steps:
    one solo window and one stacked window of K (CUDA graphs, flash and the
    fused head, from seed 0) at each batch, timed by CUDA events over four
    replays and profiled over one; per kernel, the stack's device time less
    four times the solo step's."""
    from torch.profiler import ProfilerActivity, profile

    from saturn_tpu_torch.parallel import fused
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens

    sat.library.register_default_library()
    dev = torch.device(DEVICE, 0)
    tech, config = DataParallel(), {"remat": False, "attention": "flash"}
    out = {}

    def measure(win, state, batch, steps):
        for _ in range(2):
            win(state, batch)
        ms = events_ms(lambda: win(state, batch), n=4, warmup=1) / k
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            win(state, batch)
            torch.cuda.synchronize()
        return ms, busy_ms(device_events(prof)) / steps, kernels_by_name(prof, steps)

    for b in batches:
        tasks = fused_tasks(sat, os.path.join(CKPTS, "fused_profile"), batch=b,
                            prefix=f"profile-b{b}", n_layers=LAYERS)
        for t in tasks:
            t.strategies[1] = sat.Strategy(tech, 1, config, 1.0, 1.0)
            t.select_strategy(1)
        t = tasks[0]
        bundle = tech.build(t, [dev], config)
        state = bundle.init()
        state, _ = bundle.warm_step(state, stage_tokens(t.batch_at(0), dev))
        win = bundle.fused(k)
        batch = stage_tokens(np.stack([t.batch_at(1 + j) for j in range(k)]), dev)
        win.capture(state, batch.shape)
        solo = measure(win, state, batch, k)
        del state, win
        tech.release_task(t.name)
        prog = fused.build_fused_program(tasks, [dev], inner=tech, config=config)
        state = fused.stack_state(prog, [prog.init_member_tree()] * len(tasks),
                                  [x.hparams.lr for x in tasks], [0] * len(tasks))
        state, _ = prog.bundle.warm_step(state, stage_window(tasks, 0, 1)[0])
        win = prog.bundle.fused(k)
        batch = stage_window(tasks, 1, k)
        win.capture(state, batch.shape)
        stack = measure(win, state, batch, k)
        del state, win
        fused.release_programs()
        torch.cuda.empty_cache()
        m = len(tasks)
        extra = sorted(((name, stack[2].get(name, [0.0, 0.0])[0]
                         - m * solo[2].get(name, [0.0, 0.0])[0])
                        for name in set(solo[2]) | set(stack[2])), key=lambda r: -abs(r[1]))
        log(f"  b{b} x {SEQ}: stacked {stack[0]:.3f} ms per lockstep step (busy {stack[1]:.3f}) "
            f"against {m} x solo {solo[0]:.3f} = {m * solo[0]:.3f} ms (busy {m} x {solo[1]:.3f}); "
            f"{m * solo[0] / stack[0]:.3f}x  [{card}]")
        for name, d in extra[:12]:
            log(f"    {d:+8.3f} ms  {name}")
        out[f"b{b}"] = {"stacked_ms": stack[0], "stacked_busy_ms": stack[1],
                        "solo_ms": solo[0], "solo_busy_ms": solo[1],
                        "extra_ms": extra[:30]}
    shutil.rmtree(os.path.join(CKPTS, "fused_profile"), ignore_errors=True)
    return out


def fused_phase(sat, flash, ce, card) -> tuple:
    """Phase 10: fused stacking and co-scheduled interleaving on one card."""
    t_phase = time.perf_counter()
    sat.library.register_default_library()
    topo = topology()
    save_dir = os.path.join(CKPTS, "fused")
    log("phase 10: fused GPT-2-small x4 (lr sweep) and a co-scheduled pair, dp")
    tasks = fused_tasks(sat, save_dir)
    out = {"search": fused_search(sat, card, tasks, topo)}
    out["against_solo"] = fused_against_solo(sat, flash, ce, card, tasks)
    for t in tasks:
        t.release_compiled()
    small = fused_tasks(sat, save_dir, batch=FUSED_SMALL_BATCH, prefix="fused-b2")
    out["search_small"] = fused_search(sat, card, small, topo, label="10c")
    if not out["search_small"]["priced"]:
        m = out["search_small"]
        raise AssertionError(f"10c: the solver's pricing does not fuse the b{m['batch']} group: "
                             f"lockstep {m['lockstep_s'] * 1e3:.2f} ms against 4 x solo "
                             f"{4 * m['solo_per_batch_s'] * 1e3:.2f} ms")
    launches, out["orchestrate"] = fused_orchestrate(sat, flash, ce, card, small, topo)
    shutil.rmtree(save_dir, ignore_errors=True)
    _, out["unfuse"] = unfuse_phase(sat, flash, ce, card, topo)
    _, out["coschedule"] = coschedule_phase(sat, flash, ce, card, topo)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10 {out['seconds']:.1f}s  [{card}]")
    return launches, out


# ------------------------------------------------------------------ phase 11
FAULT_BATCHES = 16                    # each task's budget
#: GPT-2-small's depth in phase 11, cut from 12 (depth only; its search hits
#: phase 7's profile entry of this depth); never above the model's
FAULT_LAYERS = 4
CHAOS_NAMES = ("chaos-a", "chaos-b")  # tests/test_torch_chaos.py's names: the same schedule
CHAOS_LRS = (6e-4, 1e-3)
CHAOS_SEED = 11
CHAOS_STALL_S = 14.0                  # 11a: the injected dispatch wedge
#: 11a: the watchdog's deadline, floor s + factor x profiled work: below the
#: stall, above a healthy first launch (a fresh init, the captures, 16
#: steps, the checkpoint copy: about 5 s at 12 layers on an H100 80GB HBM3)
CHAOS_WATCHDOG = (10.0, 2.0)
CHAOS_INTERVAL_S = 1000.0             # 11a: every attempt runs its whole budget in one interval
CHAOS_SOLVE_S = 0.25                  # 11a: the solver's deadline (not interval / 2)
DRILL_NAMES = ("drill-lr0", "drill-lr1")
DRILL_INTERVAL_SHARE = 0.6            # 11b: of the shortest profiled runtime (about 10 batches)
DRILL_AFTER_SHARE = 0.25              # 11b: the loss lands this share into a first launch
DRILL_SLOWDOWN = 4.0                  # 11b: the straggler of interval 3
#: the sentinel's spike screen (off by default) on, so that it sees the campaign's 1e9 spike
SENTINEL_SPIKE = {"SATURN_TPU_SENTINEL_SPIKE": "8", "SATURN_TPU_SENTINEL_WARMUP": "2"}


class EnvSet:
    """Set environment variables inside the block; restore them after."""

    def __init__(self, **env):
        self.env, self.saved = env, {}

    def __enter__(self):
        for k, v in self.env.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class VerifiedSources:
    """Record the ``source`` of every plan that ``analysis.verify_or_raise``
    passes inside the block."""

    def __init__(self, analysis):
        self.analysis, self.sources = analysis, []

    def __enter__(self):
        self.real = real = self.analysis.verify_or_raise

        def verify(plan, *args, **kwargs):
            out = real(plan, *args, **kwargs)
            self.sources.append(kwargs.get("source"))
            return out

        self.analysis.verify_or_raise = verify
        return self

    def __exit__(self, *exc):
        self.analysis.verify_or_raise = self.real


def fault_templates(sat, topo, names, save_dir, cache_dir):
    """GPT-2-small tasks (b8 x 512, fused head, differing only in lr)
    searched once with dp; each run trains clones of them."""
    tasks = [lm_task(sat, name, lr, FAULT_BATCHES, save_dir, n_layers=fault_layers())
             for name, lr in zip(names, CHAOS_LRS)]
    sat.search(tasks, technique_names=["dp"], topology=topo, profile_cache=cache_dir, fusion=False)
    return tasks


def task_clones(templates, save_dir, quarantine=None):
    """Fresh tasks of ``templates`` (their profiled strategies, one technique
    instance) checkpointing into ``save_dir``, with ``quarantine`` applied."""
    os.makedirs(save_dir, exist_ok=True)
    out = []
    for t in templates:
        c = t.clone(name=t.name)
        c.save_dir = save_dir
        c.quarantine_batches((quarantine or {}).get(t.name, []))
        out.append(c)
    return out


def release(tasks) -> None:
    for t in tasks:
        t.release_live_state()
        t.release_compiled()


def steps_since(tech, marks) -> int:
    """Training steps the technique ran since ``marks`` (the lengths of its
    published and discarded interval records then), discarded ones too."""
    i0, d0 = marks
    return sum(r["n"] for r in tech.intervals[i0:]) + sum(r["n"] for r in tech.discarded[d0:])


def fault_layers() -> int:
    return min(FAULT_LAYERS, LAYERS)


def want_fault_launches(config, steps: int, layers: int = 0) -> dict:
    """Exact launches of ``steps`` steps at ``layers`` (0: LAYERS)."""
    return {**{n: flash_per_step(config, n, layers) * steps for n in FLASH_NAMES},
            **{n: steps for n in CE_NAMES}}


def check_launches(label: str, launches: dict, want: dict) -> None:
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")


def chaos_campaign(sat, flash, ce, card, templates, topo):
    """11a: the seeded campaign of the four health-fault classes, killed at
    post-rollback once, against a fault-free run with its quarantine."""
    import gc

    from saturn_tpu_torch.durability import replay_batch_state
    from saturn_tpu_torch.health import HEALTH_EVENT_CODES, GuardianConfig, TrainingGuardian
    from saturn_tpu_torch.resilience import (CampaignSpec, campaign_schedule,
                                             compare_checkpoints, run_campaign)
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import metrics

    root = os.path.join(CKPTS, "chaos")
    wal, events_path = os.path.join(OUT, "chaos_journal"), os.path.join(OUT, "chaos_events.jsonl")
    for d in (root, wal):
        shutil.rmtree(d, ignore_errors=True)
    if os.path.exists(events_path):
        os.unlink(events_path)
    names = [t.name for t in templates]
    tech, config = templates[0].strategies[1].executor, templates[0].strategies[1].params
    pbt = max(t.strategies[1].per_batch_time for t in templates)
    guardian_config = GuardianConfig(watchdog_floor_s=CHAOS_WATCHDOG[0],
                                     watchdog_factor=CHAOS_WATCHDOG[1])
    deadline = TrainingGuardian(guardian_config).window_deadline_s(FAULT_BATCHES * pbt)
    if not deadline < CHAOS_STALL_S:
        raise AssertionError(f"11a: the watchdog deadline {deadline:.2f}s is not below the "
                             f"stall of {CHAOS_STALL_S}s")
    spec = CampaignSpec(seed=CHAOS_SEED, kill_during_rollback=True, poison_range=FAULT_BATCHES,
                        stall_s=CHAOS_STALL_S)
    schedule = campaign_schedule(names, spec)
    dev = torch.device(DEVICE, 0)
    gc.collect()
    before = torch.cuda.memory_allocated(dev)
    after_kill = []

    def on_kill(tasks):
        release(tasks)
        gc.collect()
        after_kill.append(torch.cuda.memory_allocated(dev))

    reset_counts(flash, ce)
    marks = (len(tech.intervals), len(tech.discarded))
    t0 = time.perf_counter()
    with EnvSet(**SENTINEL_SPIKE), CheckedWrites(ckpt) as writes:
        result = run_campaign(lambda: task_clones(templates, os.path.join(root, "campaign")),
                              spec, wal, guardian_config=guardian_config, on_kill=on_kill,
                              interval=CHAOS_INTERVAL_S, solver_time_limit=CHAOS_SOLVE_S,
                              topology=topo, metrics_path=events_path, fusion=False)
    seconds = time.perf_counter() - t0
    launches, steps = counts(flash, ce), steps_since(tech, marks)
    if sorted(result.completed) != sorted(names) or result.failed:
        raise AssertionError(f"11a: completed {result.completed}, failed {result.failed}")
    if result.kills != 1 or result.restarts != 1:
        raise AssertionError(f"11a: {result.kills} kills, {result.restarts} restarts, want 1")
    for label, after in zip(("the kill",), after_kill):
        check_memory(f"11a after {label}", after, before)
    replayed = replay_batch_state(wal)
    if result.quarantined != replayed.quarantined or not result.quarantined:
        raise AssertionError(f"11a: quarantine {result.quarantined}, the journal replays "
                             f"{replayed.quarantined}")
    poisoned = {e.task: set(e.batches) for e in schedule if e.kind == "batch_poison"}
    for name, idx in poisoned.items():
        if not idx <= set(result.quarantined.get(name, ())):
            raise AssertionError(f"11a: {name}'s poisoned batches {sorted(idx)} not in its "
                                 f"quarantine {result.quarantined}")
    health = metrics.read_events(events_path, kind="health")
    hung = [e for e in health if e.get("code") == HEALTH_EVENT_CODES["hung_dispatch"]]
    numeric = [e for e in health if e.get("code") == HEALTH_EVENT_CODES["numeric_fault"]]
    if not hung or not numeric:
        raise AssertionError(f"11a: health events {health}: want a hung dispatch (the watchdog "
                             f"ends the stall) and a numeric fault")
    check_launches("11a campaign", launches, want_fault_launches(config, steps, fault_layers()))
    for name in names:
        path = os.path.join(root, "campaign", f"{name}.pt")
        if ckpt.load(path)["step"] != FAULT_BATCHES:
            raise AssertionError(f"11a {name}: checkpoint step {ckpt.load(path)['step']}")
        runs = [r for r in tech.intervals[marks[0]:] if r["task"] == name]
        check_writes(name, writes.steps(path), runs, FAULT_BATCHES)
    discarded = [r for r in tech.discarded[marks[1]:]]
    faults = [(e.kind, e.task, e.step, e.batches, e.stall_s) for e in schedule]
    log(f"  11a campaign (seed {CHAOS_SEED}): {faults}; "
        f"{len(discarded)} interval(s) run and discarded "
        f"({[(r['task'], r['discarded'], r['n']) for r in discarded]}), {len(hung)} hung "
        f"dispatch(es) (deadline {deadline:.2f}s below the {CHAOS_STALL_S}s stall), "
        f"{len(numeric)} numeric fault(s); killed at post-rollback and restarted once; "
        f"quarantined {result.quarantined} (the journal replays it), detached "
        f"{result.detached}; both complete at step {FAULT_BATCHES}; {steps} steps run, "
        f"launches {launches} (exact); {seconds:.1f}s  [{card}]")
    release(templates)

    # the fault-free run over the same surviving batches
    ref = task_clones(templates, os.path.join(root, "reference"), quarantine=result.quarantined)
    reset_counts(flash, ce)
    marks = (len(tech.intervals), len(tech.discarded))
    t0 = time.perf_counter()
    with EnvSet(**SENTINEL_SPIKE):
        out = sat.orchestrate(ref, interval=CHAOS_INTERVAL_S, solver_time_limit=CHAOS_SOLVE_S,
                              topology=topo, fusion=False)
    t_ref = time.perf_counter() - t0
    if sorted(out["completed"]) != sorted(names) or out["failed"]:
        raise AssertionError(f"11a reference: {out}")
    check_launches("11a reference", counts(flash, ce),
                   want_fault_launches(config, steps_since(tech, marks), fault_layers()))
    mismatches = compare_checkpoints(os.path.join(root, "campaign"),
                                     os.path.join(root, "reference"), names=names)
    if mismatches:
        raise AssertionError(f"11a: the campaign's checkpoints against the fault-free run's: "
                             f"{mismatches}")
    release(ref)
    log(f"  11a: every final checkpoint byte for byte the fault-free run's with the quarantine "
        f"applied beforehand ({t_ref:.1f}s)  [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    return launches, {"schedule": [str(e) for e in schedule], "seconds": seconds,
                      "reference_s": t_ref, "kills": result.kills,
                      "quarantined": result.quarantined, "detached": result.detached,
                      "hung": len(hung), "numeric": len(numeric), "deadline_s": deadline,
                      "discarded": [(r["task"], r["discarded"], r["n"]) for r in discarded],
                      "steps": steps, "launches": launches}


def preemption_drill(sat, flash, ce, card, templates, topo):
    """11b: the same sweep through SATURN_TPU_FAULTS: a crash at interval 0,
    device 0 lost during interval 1, back at interval 2, a straggler at
    interval 3; against the same sweep unfaulted."""
    from saturn_tpu_torch import analysis, durability
    from saturn_tpu_torch.resilience import FleetHealthMonitor
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import metrics

    root = os.path.join(CKPTS, "drill")
    wal = os.path.join(OUT, "drill_journal")
    events_path = os.path.join(OUT, "drill_events.jsonl")
    clean_path = os.path.join(OUT, "drill_clean_events.jsonl")
    for d in (root, wal):
        shutil.rmtree(d, ignore_errors=True)
    for p in (events_path, clean_path):
        if os.path.exists(p):
            os.unlink(p)
    names = [t.name for t in templates]
    tech, config = templates[0].strategies[1].executor, templates[0].strategies[1].params
    interval = DRILL_INTERVAL_SHARE * min(t.strategies[1].runtime for t in templates)

    reset_counts(flash, ce)
    marks = (len(tech.intervals), len(tech.discarded))
    clean = task_clones(templates, os.path.join(root, "clean"))
    t0 = time.perf_counter()
    out = sat.orchestrate(clean, interval=interval, topology=topo, metrics_path=clean_path,
                          fusion=False)
    t_clean = time.perf_counter() - t0
    if sorted(out["completed"]) != sorted(names) or out["failed"]:
        raise AssertionError(f"11b clean run: {out}")
    check_launches("11b clean run", counts(flash, ce),
                   want_fault_launches(config, steps_since(tech, marks), fault_layers()))
    want = {t.name: ckpt.load(t.ckpt_path) for t in clean}
    first = metrics.read_events(clean_path, kind="interval")[0]["elapsed_s"]
    after_s = round(DRILL_AFTER_SHARE * first, 3)
    release(clean)
    del clean

    schedule = (f"0:trial_crash:;1+{after_s}:device_loss:0;2:device_return:0;"
                f"3:straggler:0@{DRILL_SLOWDOWN}")
    reset_counts(flash, ce)
    marks = (len(tech.intervals), len(tech.discarded))
    tasks = task_clones(templates, os.path.join(root, "faulted"))
    t0 = time.perf_counter()
    with EnvSet(SATURN_TPU_FAULTS=schedule, SATURN_TPU_GROW_HYSTERESIS="1"), \
            VerifiedSources(analysis) as verified, CheckedWrites(ckpt) as writes:
        monitor = FleetHealthMonitor.for_topology(topo)
        out = sat.orchestrate(tasks, interval=interval, topology=topo, health_monitor=monitor,
                              failure_policy="retry", max_task_retries=1, resume_dir=wal,
                              metrics_path=events_path, fusion=False)
    t_fault = time.perf_counter() - t0
    launches, steps = counts(flash, ce), steps_since(tech, marks)
    if sorted(out["completed"]) != sorted(names) or out["failed"]:
        raise AssertionError(f"11b: completed {out['completed']}, failed {out['failed']}")
    ev = metrics.read_events(events_path)

    def kinds(kind):
        return [e for e in ev if e["kind"] == kind]

    retries, preempted = kinds("task_retry"), kinds("task_preempted")
    if len(retries) != 1 or "injected transient trial crash" not in retries[0]["error"]:
        raise AssertionError(f"11b: retries {retries}: want the crash's one")
    if not preempted:
        raise AssertionError("11b: no task was preempted by the loss during interval 1")
    intervals = kinds("interval")
    if not intervals[0]["failed"] or not intervals[1]["preempted"] or intervals[1]["failed"]:
        raise AssertionError(f"11b: interval events {intervals[:2]}: want the crash in the "
                             f"first, the preemption in the second")
    discarded = [r for r in tech.discarded[marks[1]:] if r["discarded"] == "preempted"]
    if not discarded:
        raise AssertionError(f"11b: no run was discarded: {tech.discarded[marks[1]:]}")
    changes = kinds("topology_change")
    if [(c["change"], c["gained"], c["lost"]) for c in changes] != [("grow", [0], [])]:
        raise AssertionError(f"11b: topology changes {changes}: want one grow gaining device 0 "
                             f"(the straggler of one device has no median to degrade against)")
    recs = durability.replay(wal, strict=True)
    grows = [r["data"] for r in recs if r["kind"] == "grow_event"]
    if [(g["interval"], g["gained"]) for g in grows] != [(2, [0])]:
        raise AssertionError(f"11b: journaled grow events {grows}: want one at interval 2")
    if "migration-replan" not in verified.sources:
        raise AssertionError(f"11b: verified plans {verified.sources}: no migration-replan")
    recovery = kinds("recovery")
    if len(recovery) != 1:
        raise AssertionError(f"11b: recovery events {recovery}")
    if monitor.max_slowdown([0]) != DRILL_SLOWDOWN:
        raise AssertionError(f"11b: the straggler's slowdown {monitor.max_slowdown([0])}")
    progress = durability.replay_batch_state(wal).progress
    check_progress(progress, {n: FAULT_BATCHES for n in names})
    check_launches("11b", launches, want_fault_launches(config, steps, fault_layers()))
    for t in tasks:
        check_same_state(t.name, want[t.name], ckpt.load(t.ckpt_path))
        runs = [r for r in tech.intervals[marks[0]:] if r["task"] == t.name]
        check_writes(t.name, writes.steps(t.ckpt_path), runs, FAULT_BATCHES)
    lost_s = sum(r["state_s"] + r["run_s"] for r in discarded)
    latency = recovery[0]["replan_latency_s"]
    log(f"  11b drill: SATURN_TPU_FAULTS={schedule!r} (the loss {after_s}s into interval 1, "
        f"{DRILL_AFTER_SHARE} of the clean run's first launch, {first:.3f}s); interval "
        f"{interval:.3f}s; the crash took 1 retry, the preemption none "
        f"({[e['task'] for e in preempted]} requeued; {len(discarded)} run(s) discarded, "
        f"{[(r['task'], r['n']) for r in discarded]}, {lost_s:.3f}s of discarded work); the "
        f"poll at interval 2 reported grow gaining [0], re-plan verified "
        f"(migration-replan), replan_latency_s {latency:.6f}; the straggler slowed device 0 "
        f"by {monitor.max_slowdown([0])}x (latency EWMA {monitor.latency_ewma(0)}), no "
        f"degrade on one device; every checkpoint at step {FAULT_BATCHES}, bitwise the "
        f"unfaulted run's; journal progress {progress}; {steps} steps run, launches "
        f"{launches} (exact); wall {t_fault:.1f}s against the unfaulted {t_clean:.1f}s  [{card}]")
    release(tasks)
    shutil.rmtree(root, ignore_errors=True)
    return launches, {"schedule": schedule, "interval_s": interval, "after_s": after_s,
                      "first_launch_s": first, "faulted_s": t_fault, "clean_s": t_clean,
                      "replan_latency_s": latency, "discarded_s": lost_s,
                      "discarded": [(r["task"], r["n"]) for r in discarded],
                      "preempted": [e["task"] for e in preempted],
                      "latency_ewma_s": monitor.latency_ewma(0), "steps": steps,
                      "launches": launches}


def faults_phase(sat, flash, ce, card) -> tuple:
    """Phase 11: fault injection, fleet health and elastic recovery on one
    card: the chaos campaign (11a) and the preemption drill (11b)."""
    t_phase = time.perf_counter()
    sat.library.register_default_library()
    topo = topology()
    cache_dir = seeded_cache("faults_profile_cache")
    save_dir = os.path.join(CKPTS, "faults_templates")
    log(f"phase 11: fault injection and elastic recovery, two GPT-2-small tasks b8x512 at "
        f"{fault_layers()} of its {LAYERS} layers, dp")
    out = {}
    chaos = fault_templates(sat, topo, CHAOS_NAMES, save_dir, cache_dir)
    launches, out["campaign"] = chaos_campaign(sat, flash, ce, card, chaos, topo)
    release(chaos)
    drill = fault_templates(sat, topo, DRILL_NAMES, save_dir, cache_dir)
    drill_launches, out["drill"] = preemption_drill(sat, flash, ce, card, drill, topo)
    release(drill)
    launches = {n: launches[n] + drill_launches[n] for n in KERNEL_NAMES}
    shutil.rmtree(save_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11 {out['seconds']:.1f}s  [{card}]")
    return launches, out


# ----------------------------------------------------------------- phase 12
SERVICE_BATCHES = 16
#: (name, lr, priority) of A, L, H and C, GPT-2-small jobs that differ only in lr
SERVICE_JOBS = {"A": ("svc-a", 6e-4, 1.0), "L": ("svc-l", 1e-3, 0.0),
                "H": ("svc-h", 3e-4, 5.0), "C": ("svc-c", 2e-4, 0.0)}
SERVICE_INTERVAL_SHARE = 0.6  # of a job's profiled runtime: two intervals a job
SERVICE_KILL = ("mid-interval", 2)  # 12b's kill: A's second interval ran, uncommitted
SERVICE_MIN_INTERVALS = 2
#: the record kinds the JAX package's service writes
SERVICE_KINDS = ("segment_open", "recovery", "job_submitted", "job_admission", "job_state",
                 "job_recovered", "job_deferred", "plan_commit", "plan_quarantine",
                 "task_progress", "ckpt_published", "topology_change", "grow_event",
                 "backlog_drain", "migration_intent", "migration_done", "migration_rollback",
                 "defrag_wave", "tenant_charge", "health_quarantine", "health_unquarantine",
                 "health_detach", "health_backoff", "health_unbench", "health_evict")
SERVICE_REQUIRED = ("segment_open", "recovery", "job_submitted", "job_admission", "job_state",
                    "plan_commit", "task_progress", "ckpt_published")


def wait_for(client, job_id: str, pred, label: str, timeout: float = 300.0) -> dict:
    """Poll a job's status until ``pred(snapshot)``; raise if it ends or
    ``timeout`` passes first."""
    deadline = time.monotonic() + timeout
    while True:
        snap = client.status(job_id)
        if pred(snap):
            return snap
        if snap["state"] in ("DONE", "FAILED", "EVICTED") or time.monotonic() > deadline:
            raise AssertionError(f"{label}: job {job_id} is {snap['state']} ({snap['error']})")
        time.sleep(0.005)


def service_jobs(sat, save_dir, keys) -> dict:
    """The jobs' tasks, built (their datasets drawn) before any is submitted."""
    return {k: lm_task(sat, SERVICE_JOBS[k][0], SERVICE_JOBS[k][1], SERVICE_BATCHES, save_dir,
                       n_layers=fault_layers())
            for k in keys}


def submit_jobs(svc, client, tasks) -> dict:
    """A; once A is running, L and H back to back, under the queue's lock so
    that one drain admits both; with C in ``tasks``, once L and H are
    admitted, C, cancelled once it is admitted. Ordered by the jobs' states,
    never by sleeps."""
    def submit(k):
        return client.submit(tasks[k], priority=SERVICE_JOBS[k][2],
                             spec={"lr": SERVICE_JOBS[k][1]})

    ids = {"A": submit("A")}
    wait_for(client, ids["A"], lambda s: s["started_at"] is not None, "12: A never started")
    with svc.queue._lock:  # re-entrant: the submits take it again
        ids["L"] = submit("L")
        ids["H"] = submit("H")
    if "C" in tasks:
        for k in ("L", "H"):
            wait_for(client, ids[k], lambda s: s["admitted_at"] is not None,
                     f"12: {k} never admitted")
        ids["C"] = submit("C")
        wait_for(client, ids["C"], lambda s: s["admitted_at"] is not None,
                 "12: C never admitted")
        if not client.cancel(ids["C"]):
            raise AssertionError("12: C was terminal before its cancel")
    return ids


def job_steps(tasks) -> tuple:
    """(steps run, steps run in discarded runs) over the techniques of
    ``tasks`` (each admission profiles into a technique instance of its own)."""
    techs = {id(t.strategies[1].executor): t.strategies[1].executor for t in tasks
             if 1 in t.strategies}
    return (sum(r["n"] for tech in techs.values() for r in tech.intervals),
            sum(r["n"] for tech in techs.values() for r in tech.discarded))


def check_service_journal(root: str, incarnations: int, extra_kinds=()) -> dict:
    """Raise unless the service's journal replays strictly as one ``seq``
    chain, holds only the JAX service's record kinds (the required ones
    among them; ``extra_kinds`` allowed too), a recovery record per
    incarnation, and every committed plan passes the verifier
    (``audit_journal``). Returns the count of each kind."""
    from saturn_tpu_torch import analysis
    from saturn_tpu_torch.durability import replay

    recs = replay(root, strict=True)
    if [r["seq"] for r in recs] != list(range(1, len(recs) + 1)):
        raise AssertionError(f"{root}: the records are not one seq chain from 1")
    kinds: dict = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    foreign = sorted(set(kinds) - set(SERVICE_KINDS) - set(extra_kinds))
    missing = [k for k in SERVICE_REQUIRED if k not in kinds]
    if foreign or missing:
        raise AssertionError(f"{root}: record kinds {kinds}; not the JAX service's {foreign}, "
                             f"missing {missing}")
    got = [r["data"]["incarnation"] for r in recs if r["kind"] == "recovery"]
    if got != list(range(1, incarnations + 1)):
        raise AssertionError(f"{root}: recovery records {got}, want {incarnations} incarnations")
    report = analysis.audit_journal(root)
    if not report.ok:
        raise AssertionError(f"{root}: the journal audit fails: {report.codes()}")
    return kinds


def job_progress(root: str) -> dict:
    """task -> the sum of its ``task_progress`` records, every incarnation."""
    from saturn_tpu_torch.durability import replay

    out: dict = {}
    for r in replay(root, strict=True):
        if r["kind"] == "task_progress":
            out[r["data"]["task"]] = out.get(r["data"]["task"], 0) + r["data"]["batches"]
    return out


def checkpoint_step(ckpt, path: str) -> int:
    """The step of a verified checkpoint at ``path``, 0 without one."""
    return ckpt.saved_step(path) if ckpt.exists(path) and ckpt.verify(path) else 0


def service_phase(sat, flash, ce, card) -> tuple:
    """Phase 12: the online service on the card. 12a an uninterrupted
    service (admission, priority-weighted re-solves, a cancel), 12b the
    same jobs killed at SERVICE_KILL and recovered by a fresh service, 12c
    the CLI over 12a's metrics."""
    import gc
    import traceback

    from saturn_tpu_torch.durability import journal as jmod
    from saturn_tpu_torch.durability import recovery as rmod
    from saturn_tpu_torch.durability import replay
    from saturn_tpu_torch.resilience import CrashInjector, run_to_kill
    from saturn_tpu_torch.service import SaturnService, ServiceClient
    from saturn_tpu_torch.service import admission as adm
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    sat.library.register_default_library()
    topo = topology()
    cache_dir = seeded_cache("service_profile_cache")
    root = os.path.join(CKPTS, "service")
    journals = {k: os.path.join(OUT, f"service_journal_{k}") for k in "AB"}
    events = {k: os.path.join(OUT, f"service_events_{k}.jsonl") for k in "AB"}
    for d in (root, *journals.values()):
        shutil.rmtree(d, ignore_errors=True)
    for p in events.values():
        if os.path.exists(p):
            os.unlink(p)
    log(f"phase 12: the online service, GPT-2-small jobs b8x512 ({fault_layers()} of its "
        f"{LAYERS} layers), dp")
    template = lm_task(sat, "svc-template", 6e-4, SERVICE_BATCHES, os.path.join(root, "t"),
                       n_layers=fault_layers())
    t0 = time.perf_counter()
    stats = sat.search([template], technique_names=["dp"], topology=topo,
                       profile_cache=cache_dir, fusion=False)
    t_search = time.perf_counter() - t0
    strat = template.strategies[1]
    config, pbt = dict(strat.params), strat.per_batch_time
    interval = SERVICE_INTERVAL_SHARE * SERVICE_BATCHES * pbt
    t0 = time.perf_counter()
    loss0 = initial_loss(template)
    t_loss0 = time.perf_counter() - t0
    release([template])
    del template, strat
    dev = torch.device(DEVICE, 0)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    out = {"config": config, "per_batch_s": pbt, "interval_s": interval,
           "template_trials": stats["trials_run"], "template_search_s": t_search,
           "initial_loss": loss0, "initial_loss_s": t_loss0, "journals": journals,
           "events": events}
    log(f"  the jobs' profile: {config}, {pbt * 1e3:.3f} ms/batch ({stats['trials_run']} "
        f"trial(s), {stats['cache_hits']} cache hit(s), {t_search:.1f}s); interval "
        f"{interval:.3f}s ({SERVICE_INTERVAL_SHARE} of a job's runtime); the first loss "
        f"{loss0:.4f} ({t_loss0:.1f}s)")

    # ---- 12a: an uninterrupted service
    tasks = service_jobs(sat, os.path.join(root, "A"), "ALHC")
    reset_counts(flash, ce)
    t0, m0 = time.perf_counter(), time.monotonic()
    with CallTimes(commit=(jmod.Journal, "commit")) as timer:
        svc, client = sat.serve(topology=topo, interval=interval, technique_names=["dp"],
                                profile_cache=cache_dir, durability_dir=journals["A"],
                                metrics_path=events["A"])
        try:
            ids = submit_jobs(svc, client, tasks)
            snaps = {k: client.wait(j, timeout=600) for k, j in ids.items()}
        finally:
            svc.stop(timeout=600)  # raises what the loop raised
    wall_a = time.perf_counter() - t0
    launches = counts(flash, ce)
    states = {k: (s["state"], s["error"]) for k, s in snaps.items()}
    if states != {"A": ("DONE", None), "L": ("DONE", None), "H": ("DONE", None),
                  "C": ("EVICTED", "cancelled")}:
        raise AssertionError(f"12a: job states {states}")
    if not snaps["H"]["started_at"] < snaps["L"]["started_at"]:
        raise AssertionError(f"12a: H started at {snaps['H']['started_at']}, after L at "
                             f"{snaps['L']['started_at']}")
    admitted = [e for e in metrics.read_events(events["A"], kind="job_admitted")
                if e["decision"] == "admit"]
    if (sorted(e["job"] for e in admitted) != sorted(ids.values())
            or any(e["trials_run"] or not e["warm"] for e in admitted)):
        raise AssertionError(f"12a: admissions {admitted}: want every job once, warm")
    kinds = check_service_journal(journals["A"], 1)
    recs_a = replay(journals["A"], strict=True)
    c_name = SERVICE_JOBS["C"][0]
    if [r for r in recs_a if r["kind"] == "ckpt_published" and r["data"]["task"] == c_name]:
        raise AssertionError("12a: C published a checkpoint")
    if tasks["C"]._live_state is not None or [
            r for r in tasks["C"].strategies[1].executor.intervals if r["task"] == c_name]:
        raise AssertionError("12a: C ran, or holds a live state")
    per_job = {}
    for k in "ALH":
        t = tasks[k]
        saved = ckpt.load(t.ckpt_path)
        losses = np.asarray(t.last_losses)
        runs = [r for r in t.strategies[1].executor.intervals if r["task"] == t.name]
        if saved["step"] != SERVICE_BATCHES or not np.isfinite(losses).all() \
                or not losses[-1] < loss0:
            raise AssertionError(f"12a {k}: step {saved['step']}, losses {losses} (first "
                                 f"{loss0:.4f})")
        if len(runs) < SERVICE_MIN_INTERVALS:
            raise AssertionError(f"12a {k}: {len(runs)} interval(s): lower "
                                 f"SERVICE_INTERVAL_SHARE")
        per_job[k] = {"intervals": [r["n"] for r in runs], "final_loss": float(losses[-1]),
                      "device_s": sum(r["n"] * (r["per_batch_s"] or 0.0) for r in runs),
                      "run_s": sum(r["run_s"] for r in runs)}
    steps, discarded = job_steps(tasks.values())
    check_launches("12a", launches, want_fault_launches(config, steps + discarded,
                                                               fault_layers()))
    tiers = [(e["tier_name"], e["wall_s"]) for e in
             metrics.read_events(events["A"], kind="solver_tier") if e["source"] == "service"]
    commit_s = timer.seconds["commit"]
    device_s = sum(v["device_s"] for v in per_job.values())
    for k, s in snaps.items():
        marks = " -> ".join(f"{lbl} {s[f] - m0:.3f}" for lbl, f in (
            ("submitted", "submitted_at"), ("admitted", "admitted_at"),
            ("started", "started_at"), ("done", "finished_at")) if s[f] is not None)
        log(f"    {k} ({s['task']}, priority {s['priority']}): {marks} s; {s['state']}"
            + (f" ({s['error']})" if s["error"] else "")
            + (f"; intervals {per_job[k]['intervals']}" if k in per_job else ""))
    log(f"  12a: H before L, C evicted by its cancel, A/L/H at step {SERVICE_BATCHES}; "
        f"journal {kinds}, every plan verified; {len(tiers)} re-solves (tier, s): {tiers}; "
        f"{len(commit_s)} commits, median {np.median(commit_s) * 1e3:.2f} ms, max "
        f"{max(commit_s) * 1e3:.2f} ms; {steps} steps, launches {launches} (exact); wall "
        f"{wall_a:.1f}s against {device_s:.3f}s of the jobs' steps (batches x per-batch s)"
        f"  [{card}]")
    out["12a"] = {"states": states, "snapshots": snaps, "jobs": per_job, "journal": kinds,
                  "tiers": tiers, "commit_s": commit_s, "wall_s": wall_a,
                  "device_s": device_s, "steps": steps, "launches": launches}
    want = {k: ckpt.load(tasks[k].ckpt_path) for k in "ALH"}
    release(tasks.values())
    del svc, client, tasks

    # ---- 12b: the same jobs, killed and recovered
    tasks_b = service_jobs(sat, os.path.join(root, "B"), "ALH")
    reset_counts(flash, ce)
    inj = CrashInjector(*SERVICE_KILL, armed=False)
    t0 = time.perf_counter()
    svc = SaturnService(topology=topo, interval=interval, technique_names=["dp"],
                        profile_cache=cache_dir, durability_dir=journals["B"],
                        metrics_path=events["B"], crash_barrier=inj.barrier)
    inj.arm()  # before start(): the kill cannot race the loop's barriers
    svc.start()
    ids_b = submit_jobs(svc, ServiceClient(svc), tasks_b)
    run_to_kill(inj, svc, timeout=300)  # the one kill this phase catches
    t_kill = time.perf_counter() - t0
    svc.stop(timeout=60)
    killed_launches = counts(flash, ce)
    killed_steps = sum(job_steps(tasks_b.values()))
    check_launches("12b killed", killed_launches, want_fault_launches(config, killed_steps, fault_layers()))
    # the dead incarnation's writes land; its states, graphs and pools go
    ckpt.flush()
    release(r.task for r in svc.queue.jobs())
    traceback.clear_frames(svc._error.__traceback__)
    del svc, tasks_b
    gc.collect()
    torch.cuda.empty_cache()
    after_kill = torch.cuda.memory_allocated(dev)
    check_memory("12b after the kill", after_kill, before)
    names = {k: SERVICE_JOBS[k][0] for k in "ALH"}
    ckpt_steps = {k: checkpoint_step(ckpt, os.path.join(root, "B", f"{n}.pt"))
                  for k, n in names.items()}
    specs = []

    def provide(spec):
        specs.append(spec)
        return lm_task(sat, spec["task"], spec["spec"]["lr"], SERVICE_BATCHES,
                       os.path.join(root, "B"), n_layers=fault_layers())

    reset_counts(flash, ce)
    rt = CallTimes(replay=(rmod, "replay_service_state"),
                   reconcile=(rmod, "reconcile_checkpoints"),
                   follow=(rmod, "follow_checkpoints"),
                   admit=(adm.AdmissionController, "admit"))
    t0 = time.perf_counter()
    with rt:
        svc2 = SaturnService(topology=topo, interval=interval, technique_names=["dp"],
                             profile_cache=cache_dir, durability_dir=journals["B"],
                             metrics_path=events["B"], task_provider=provide)
        t_recover = time.perf_counter() - t0
        svc2.start()
        client2 = ServiceClient(svc2)
        try:
            snaps_b = {k: client2.wait(j, timeout=600) for k, j in ids_b.items()}
        finally:
            svc2.stop(timeout=600)
    wall_b = time.perf_counter() - t0
    restart_launches = counts(flash, ce)
    rebuilt = [r.task for r in svc2.queue.jobs() if hasattr(r.task, "strategies")
               and 1 in r.task.strategies]
    restart_steps = sum(job_steps(rebuilt))
    check_launches("12b restart", restart_launches, want_fault_launches(config, restart_steps, fault_layers()))
    if {k: s["state"] for k, s in snaps_b.items()} != {k: "DONE" for k in "ALH"}:
        raise AssertionError(f"12b: job states {snaps_b}")
    by_name = {v: k for k, v in names.items()}
    got_remaining = {by_name[s["task"]]: s["remaining_batches"] for s in specs}
    want_remaining = {k: SERVICE_BATCHES - ckpt_steps[k] for k in got_remaining}
    finished = sorted(k for k in "ALH" if k not in got_remaining)
    if got_remaining != want_remaining or any(ckpt_steps[k] != SERVICE_BATCHES
                                              for k in finished):
        raise AssertionError(f"12b: remaining batches {got_remaining}, want 16 less each "
                             f"verified checkpoint's step {ckpt_steps}; not rebuilt {finished}")
    kinds_b = check_service_journal(journals["B"], 2)
    recs_b = replay(journals["B"], strict=True)
    second = max(i for i, r in enumerate(recs_b) if r["kind"] == "recovery")
    readmits = [r["data"] for r in recs_b[second:] if r["kind"] == "job_admission"]
    if (sorted(d["task"] for d in readmits) != sorted(names[k] for k in got_remaining)
            or any(d["decision"] != "admit" or d["trials_run"] for d in readmits)):
        raise AssertionError(f"12b: re-admissions {readmits}: want the live jobs, warm")
    progress = job_progress(journals["B"])
    if progress != {n: SERVICE_BATCHES for n in names.values()}:
        raise AssertionError(f"12b: journaled progress {progress}")
    for k, n in names.items():
        check_same_state(n, want[k], ckpt.load(os.path.join(root, "B", f"{n}.pt")))
    redone = killed_steps + restart_steps - len(names) * SERVICE_BATCHES
    recovery = {"replay_s": rt.seconds["replay"], "reconcile_s": rt.seconds["reconcile"],
                "follow_s": rt.seconds["follow"],
                "readmit_s": rt.seconds["admit"][:len(got_remaining)],
                "constructor_s": t_recover}
    log(f"  12b: killed at {SERVICE_KILL} after {t_kill:.1f}s ({killed_steps} steps, "
        f"launches {killed_launches}, exact); {after_kill / 2**30:.3f} GiB allocated after "
        f"the kill, {before / 2**30:.3f} before 12a; checkpoint steps {ckpt_steps}, "
        f"remaining batches handed to task_provider {got_remaining} ({finished} restored "
        f"DONE); restart: replay {sum(recovery['replay_s']):.4f}s, reconcile "
        f"{sum(recovery['reconcile_s']):.3f}s, follow {sum(recovery['follow_s']):.3f}s, "
        f"re-admission {sum(recovery['readmit_s']):.3f}s (warm), the constructor "
        f"{t_recover:.3f}s; {restart_steps} steps after it, launches {restart_launches} "
        f"(exact); {redone} steps ({redone * pbt:.3f}s) redone; progress {progress}; every "
        f"checkpoint bitwise 12a's; journal {kinds_b}; wall {wall_b:.1f}s  [{card}]")
    out["12b"] = {"kill": list(SERVICE_KILL), "kill_s": t_kill, "checkpoint_steps": ckpt_steps,
                  "remaining": got_remaining, "restored_done": finished,
                  "recovery": recovery, "killed_steps": killed_steps,
                  "restart_steps": restart_steps, "redone_steps": redone,
                  "redone_s": redone * pbt, "progress": progress, "journal": kinds_b,
                  "killed_launches": killed_launches, "restart_launches": restart_launches,
                  "allocated_before": before, "allocated_after_kill": after_kill,
                  "wall_s": wall_b}
    release(rebuilt)
    del svc2, client2, rebuilt

    # ---- 12c: the CLI over 12a's metrics, in a child process
    proc = run_child(["-m", "saturn_tpu_torch.service", events["A"]], "service_cli", timeout=300)
    rows = {line.split()[1]: line.split()[2] for line in proc.stdout.splitlines()[1:]
            if len(line.split()) >= 3 and line.split()[0].startswith("j")}
    want_rows = {names[k]: "DONE" for k in "ALH"}
    want_rows[c_name] = "EVICTED"
    if rows != want_rows:
        raise AssertionError(f"12c: the CLI printed {rows}, want {want_rows}:\n{proc.stdout}")
    log(f"  12c: python -m saturn_tpu_torch.service printed {rows} in {proc.seconds:.1f}s")
    out["12c"] = {"rows": rows, "seconds": proc.seconds}
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12 {out['seconds']:.1f}s  [{card}]")
    return launches, out


# ---------------------------------------------------------------- phase 12d
GATEWAY_BATCHES = 8
#: 12d-1's jobs (name, lr), submitted with dedup keys through a kill_ack proxy
GATEWAY_JOBS = {"N1": ("gw-n1", 6e-4), "N2": ("gw-n2", 1e-3), "N3": ("gw-n3", 3e-4)}
#: 12d-2's jobs: D cancelled over the wire, then the kill; E resubmitted after it
GATEWAY_KILL_JOBS = {"D": ("gw-d", 2e-4), "E": ("gw-e", 8e-4)}
#: 12d-2's budget a job: 4x what the interval was sized for, so that neither job
#: finishes in the interval the cancel and the kill land in when the realized
#: per-batch time comes in below the profiled one (the forecast runs the
#: interval over the refreshed estimate)
GATEWAY_KILL_BATCHES = 4 * GATEWAY_BATCHES
GATEWAY_SEED = 11  # with 3 submits the kill_ack spec cuts the second one's answer
GATEWAY_KINDS = ("gateway_dedup_hit", "gateway_shed", "gateway_drain")


def gateway_counts(root: str) -> tuple:
    """(job_submitted records per dedup key, dedup hits [(key, job)]) of a
    journal."""
    from saturn_tpu_torch.durability import replay

    per_key: dict = {}
    hits = []
    for r in replay(root, strict=True):
        d = r["data"]
        if r["kind"] == "job_submitted" and d.get("dedup_key") is not None:
            per_key[d["dedup_key"]] = per_key.get(d["dedup_key"], 0) + 1
        elif r["kind"] == "gateway_dedup_hit":
            hits.append((d["key"], d["job"]))
    return per_key, hits


class HeldKill:
    """A crash barrier that stops the service loop at the first
    ``mid-interval`` crossing after job ``hold``'s first launch until
    :meth:`release`, then lets a ``CrashInjector`` at that barrier fire: a
    kill after the cancel's commit and before the next boundary."""

    def __init__(self, injector):
        self.injector = injector
        self.hold = None  # (queue, job id)
        self.held = threading.Event()
        self.go = threading.Event()

    def barrier(self, point, ctx):
        if point == "mid-interval" and self.hold is not None and not self.held.is_set():
            queue, jid = self.hold
            if queue.get(jid).started_at is not None:
                self.held.set()
                if not self.go.wait(300):
                    raise AssertionError("12d-2: the loop was never released")
        self.injector.barrier(point, ctx)

    def release(self):
        self.injector.arm()
        self.go.set()


def gateway_phase(sat, flash, ce, card) -> tuple:
    """Phase 12d: the network gateway on the card. 12d-1 submits three jobs
    with dedup keys through a seeded ``kill_ack`` proxy and waits through a
    mixed-fault one; 12d-2 cancels an admitted job over the wire, kills the
    service before the boundary that would sweep it, and restarts service
    and gateway on the same journal, where the other job's resubmit gets
    its original id."""
    import gc
    import traceback

    from saturn_tpu_torch.durability import journal as jmod
    from saturn_tpu_torch.durability import recovery as rmod
    from saturn_tpu_torch.resilience import (CrashInjector, NetChaosProxy, NetChaosSpec,
                                             single_fault_spec)
    from saturn_tpu_torch.service import GatewayClient, GatewayServer, SaturnService
    from saturn_tpu_torch.service import admission as adm
    from saturn_tpu_torch.service.queue import SubmissionQueue
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    sat.library.register_default_library()
    topo = topology()
    cache_dir = seeded_cache("gateway_profile_cache")
    root = os.path.join(CKPTS, "gateway")
    journal = os.path.join(OUT, "gateway_journal")
    events = os.path.join(OUT, "gateway_events.jsonl")
    for d in (root, journal):
        shutil.rmtree(d, ignore_errors=True)
    if os.path.exists(events):
        os.unlink(events)
    log(f"phase 12d: the gateway, GPT-2-small jobs b{BATCH}x{SEQ} ({fault_layers()} of its "
        f"{LAYERS} layers), dp, over loopback TCP through a seeded chaos proxy")
    template = lm_task(sat, "gw-template", 6e-4, GATEWAY_BATCHES, os.path.join(root, "t"),
                       n_layers=fault_layers())
    t0 = time.perf_counter()
    stats = sat.search([template], technique_names=["dp"], topology=topo,
                       profile_cache=cache_dir, fusion=False)
    t_search = time.perf_counter() - t0
    strat = template.strategies[1]
    config, pbt = dict(strat.params), strat.per_batch_time
    interval = SERVICE_INTERVAL_SHARE * GATEWAY_BATCHES * pbt
    loss0 = initial_loss(template)
    release([template])
    del template, strat
    dev = torch.device(DEVICE, 0)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    lrs = {n: lr for n, lr in list(GATEWAY_JOBS.values()) + list(GATEWAY_KILL_JOBS.values())}
    built: dict = {}  # name -> the tasks task_provider built for it
    specs: list = []

    def provide(spec):  # in a gateway reader thread, or in recovery: host work only
        specs.append(spec)
        task = lm_task(sat, spec["task"], lrs[spec["task"]], spec["total_batches"], root,
                       n_layers=fault_layers())
        built.setdefault(spec["task"], []).append(task)
        return task

    out = {"config": config, "per_batch_s": pbt, "interval_s": interval,
           "template_trials": stats["trials_run"], "template_search_s": t_search,
           "initial_loss": loss0}
    log(f"  the jobs' profile: {config}, {pbt * 1e3:.3f} ms/batch ({stats['trials_run']} "
        f"trial(s), {stats['cache_hits']} cache hit(s), {t_search:.1f}s); interval "
        f"{interval:.3f}s; the first loss {loss0:.4f}")

    # ---- 12d-1: three jobs through the chaos proxy
    held = HeldKill(CrashInjector("mid-interval", hit=1, armed=False))
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    timer = CallTimes(commit=(jmod.Journal, "commit"), admit=(SubmissionQueue, "submit"))
    with timer:
        svc = SaturnService(topology=topo, interval=interval, technique_names=["dp"],
                            profile_cache=cache_dir, durability_dir=journal,
                            metrics_path=events, task_provider=provide,
                            crash_barrier=held.barrier)
        svc.start()
        gw = GatewayServer(svc).start()
        names = {k: v[0] for k, v in GATEWAY_JOBS.items()}
        keys = {k: f"12d:{n}" for k, n in names.items()}
        ids, ack_s = {}, []
        submit_spec = single_fault_spec(GATEWAY_SEED, "kill_ack", max_faults_per_conn=2)
        with NetChaosProxy(*gw.address, submit_spec) as px:
            with GatewayClient(*px.address, session="12d", seed=GATEWAY_SEED, timeout_s=30.0,
                               max_attempts=10) as c:
                for k in GATEWAY_JOBS:
                    t1 = time.perf_counter()
                    ids[k] = c.submit(name=names[k], total_batches=GATEWAY_BATCHES,
                                      spec={"lr": lrs[names[k]]}, dedup_key=keys[k])
                    ack_s.append(time.perf_counter() - t1)
            submit_faults = dict(px.stats.injected)
        admit_s = list(timer.seconds["admit"])
        wait_spec = NetChaosSpec(seed=GATEWAY_SEED, fault_rate=0.25, max_faults_per_conn=2)
        with NetChaosProxy(*gw.address, wait_spec) as px:
            with GatewayClient(*px.address, session="12d", seed=GATEWAY_SEED + 1, timeout_s=2.0,
                               max_attempts=20) as c:
                snaps = {k: c.wait(j, timeout=600) for k, j in ids.items()}
            wait_faults = dict(px.stats.injected)
        wall_1 = time.perf_counter() - t0
        launches_1 = counts(flash, ce)
        tasks_1 = [t for k in GATEWAY_JOBS for t in built[names[k]]]
        steps_1, discarded_1 = job_steps(tasks_1)
        check_launches("12d-1", launches_1, want_fault_launches(config, steps_1 + discarded_1,
                                                                   fault_layers()))
        if any(s["state"] != "DONE" for s in snaps.values()):
            raise AssertionError(f"12d-1: job states {snaps}")
        per_key, hits = gateway_counts(journal)
        if per_key != {keys[k]: 1 for k in GATEWAY_JOBS}:
            raise AssertionError(f"12d-1: job_submitted records per key {per_key}")
        if submit_faults.get("kill_ack", 0) < 1:
            raise AssertionError(f"12d-1: the proxy injected {submit_faults}, no kill_ack")
        by_key = {keys[k]: ids[k] for k in GATEWAY_JOBS}
        if not hits or any(by_key.get(key) != job for key, job in hits):
            raise AssertionError(f"12d-1: dedup hits {hits}, want the original ids {by_key}")
        for k in GATEWAY_JOBS:
            t = built[names[k]][-1]
            losses = np.asarray(t.last_losses)
            step = ckpt.load(t.ckpt_path)["step"]
            if step != GATEWAY_BATCHES or not np.isfinite(losses).all() or not losses[-1] < loss0:
                raise AssertionError(f"12d-1 {k}: step {step}, losses {losses}")
        gw_stats_1 = gw.stats()
        log(f"  12d-1: 3 jobs DONE at step {GATEWAY_BATCHES}, one job_submitted per key; submit "
            f"faults {submit_faults}, wait faults {wait_faults}; dedup hits {hits} (the original "
            f"ids); sheds {gw_stats_1['sheds']}; submit -> ACK over the wire median "
            f"{np.median(ack_s) * 1e3:.2f} ms, max {max(ack_s) * 1e3:.2f} ms, of which "
            f"queue.submit (its durable commit) {sum(admit_s) / sum(ack_s):.3f}; wall "
            f"{wall_1:.1f}s against {steps_1 * pbt:.3f}s of steps ({steps_1}); launches "
            f"{launches_1} (exact)  [{card}]")
        out["12d-1"] = {"ids": ids, "states": {k: s["state"] for k, s in snaps.items()},
                        "ack_s": ack_s, "admit_s": admit_s, "submit_faults": submit_faults,
                        "wait_faults": wait_faults, "dedup_hits": hits,
                        "gateway": gw_stats_1, "wall_s": wall_1, "steps": steps_1,
                        "launches": launches_1}
        release(tasks_1)

        # ---- 12d-2: a wire cancel of an admitted job, then a kill before the boundary
        reset_counts(flash, ce)
        t0 = time.perf_counter()
        knames = {k: v[0] for k, v in GATEWAY_KILL_JOBS.items()}
        kkeys = {k: f"12d:{n}" for k, n in knames.items()}
        with GatewayClient(*gw.address, session="12d-2", seed=GATEWAY_SEED + 2,
                           timeout_s=30.0) as c:
            kids = {}
            for k in GATEWAY_KILL_JOBS:
                kids[k] = c.submit(name=knames[k], total_batches=GATEWAY_KILL_BATCHES,
                                   spec={"lr": lrs[knames[k]]}, dedup_key=kkeys[k])
                if k == "D":
                    held.hold = (svc.queue, kids["D"])
            if not held.held.wait(300):
                raise AssertionError("12d-2: D never ran an interval")
            t1 = time.perf_counter()
            answered = c.cancel(kids["D"])
            cancel_s = time.perf_counter() - t1
        if answered is not True:
            raise AssertionError(f"12d-2: the cancel of an admitted D answered {answered}")
        held.release()
        if not held.injector.fired.wait(300):
            raise AssertionError("12d-2: the kill never fired")
        svc._thread.join(300)
        if not svc.killed:
            raise AssertionError("12d-2: the service outlived its kill")
        gw._die(svc._error)  # the process is dead: its gateway too
        svc.stop(timeout=60)
    t_kill = time.perf_counter() - t0
    commit_s = timer.seconds["commit"]
    killed_launches = counts(flash, ce)
    d_state = svc.queue.get(kids["D"]).state.value
    killed_tasks = [t for k in GATEWAY_KILL_JOBS for t in built.get(knames[k], [])]
    killed_steps = sum(job_steps(killed_tasks))
    check_launches("12d-2 killed", killed_launches, want_fault_launches(config, killed_steps, fault_layers()))
    killed_e = sum(job_steps(built.get(knames["E"], [])))
    ckpt.flush()
    release(r.task for r in svc.queue.jobs())
    traceback.clear_frames(svc._error.__traceback__)
    del svc, gw, killed_tasks
    gc.collect()
    torch.cuda.empty_cache()
    after_kill = torch.cuda.memory_allocated(dev)
    check_memory("12d-2 after the kill", after_kill, before)
    ckpt_e = checkpoint_step(ckpt, os.path.join(root, f"{knames['E']}.pt"))
    n_specs = len(specs)

    reset_counts(flash, ce)
    rt = CallTimes(replay=(rmod, "replay_service_state"),
                   reconcile=(rmod, "reconcile_checkpoints"),
                   admit=(adm.AdmissionController, "admit"))
    t0 = time.perf_counter()
    with rt:
        svc2 = SaturnService(topology=topo, interval=interval, technique_names=["dp"],
                             profile_cache=cache_dir, durability_dir=journal,
                             metrics_path=events, task_provider=provide)
        t_recover = time.perf_counter() - t0
        svc2.start()
        gw2 = GatewayServer(svc2).start()
        try:
            with GatewayClient(*gw2.address, session="12d-2", seed=GATEWAY_SEED + 3,
                               timeout_s=30.0) as c:
                d_snap = c.status(kids["D"])
                again = c.submit(name=knames["E"], total_batches=GATEWAY_KILL_BATCHES,
                                 spec={"lr": lrs[knames["E"]]}, dedup_key=kkeys["E"])
                e_snap = c.wait(kids["E"], timeout=600)
        finally:
            drained = gw2.shutdown(timeout=30.0, reason="12d")
            svc2.stop(timeout=600)
    wall_2 = time.perf_counter() - t0
    restart_launches = counts(flash, ce)
    rebuilt = [r.task for r in svc2.queue.jobs() if hasattr(r.task, "strategies")
               and 1 in r.task.strategies]
    restart_steps = sum(job_steps(rebuilt))
    check_launches("12d-2 restart", restart_launches,
                   want_fault_launches(config, restart_steps, fault_layers()))
    restart_specs = specs[n_specs:]
    if (d_snap["state"], d_snap["error"]) != ("EVICTED", "cancelled") or any(
            s["task"] == knames["D"] for s in restart_specs):
        raise AssertionError(f"12d-2: D after the restart {d_snap}; specs {restart_specs}")
    if [r.task.name for r in svc2.queue.jobs() if r.job_id == kids["D"]
            and hasattr(r.task, "strategies") and r.task.strategies]:
        raise AssertionError("12d-2: D was rebuilt")
    if again != kids["E"] or e_snap["state"] != "DONE":
        raise AssertionError(f"12d-2: E resubmitted as {again} (want {kids['E']}), {e_snap}")
    handed = [s["remaining_batches"] for s in restart_specs if s["task"] == knames["E"]]
    if handed != [GATEWAY_KILL_BATCHES - ckpt_e]:
        raise AssertionError(f"12d-2: E handed {handed}, want {GATEWAY_KILL_BATCHES} less its "
                             f"checkpoint's step {ckpt_e}")
    redone = killed_e + restart_steps - GATEWAY_KILL_BATCHES
    if redone != killed_e - ckpt_e:
        raise AssertionError(f"12d-2: {redone} steps of E redone, want {killed_e - ckpt_e} (the "
                             f"killed run's steps past its checkpoint)")
    if ckpt.load(os.path.join(root, f"{knames['E']}.pt"))["step"] != GATEWAY_KILL_BATCHES:
        raise AssertionError("12d-2: E's checkpoint is not at its budget")
    kinds = check_service_journal(journal, 2, extra_kinds=GATEWAY_KINDS)
    if not kinds.get("gateway_drain") or not drained:
        raise AssertionError(f"12d-2: drain {drained}, journal {kinds}")
    from saturn_tpu_torch.durability import replay_service_state

    folded = replay_service_state(journal)
    if (folded.jobs[kids["D"]].state, folded.jobs[kids["D"]].error) != ("EVICTED", "cancelled"):
        raise AssertionError(f"12d-2: the journal holds D as {folded.jobs[kids['D']]}")
    progress = job_progress(journal)
    if (any(progress.get(n) != GATEWAY_BATCHES for n in names.values())
            or progress.get(knames["E"]) != GATEWAY_KILL_BATCHES):
        raise AssertionError(f"12d-2: journaled progress {progress}")
    recovery = {"replay_s": rt.seconds["replay"], "reconcile_s": rt.seconds["reconcile"],
                "readmit_s": rt.seconds["admit"], "constructor_s": t_recover}
    log(f"  12d-2: D cancelled over the wire while {d_state} ({cancel_s * 1e3:.2f} ms, journaled), "
        f"the service killed at mid-interval before the boundary ({t_kill:.1f}s, {killed_steps} "
        f"steps, launches {killed_launches}, exact); {after_kill / 2**30:.3f} GiB allocated "
        f"after the kill, {before / 2**30:.3f} before; restart: D EVICTED (cancelled), not "
        f"rebuilt; E's resubmit got {again}, handed {handed} (checkpoint step {ckpt_e}), DONE, "
        f"{redone} steps redone; replay {sum(recovery['replay_s']):.4f}s, reconcile "
        f"{sum(recovery['reconcile_s']):.3f}s, re-admission {sum(recovery['readmit_s']):.3f}s, "
        f"the constructor {t_recover:.3f}s; {restart_steps} steps, launches {restart_launches} "
        f"(exact); drained clean {drained}; journal {kinds}; commits {len(commit_s)}, median "
        f"{np.median(commit_s) * 1e3:.2f} ms, max {max(commit_s) * 1e3:.2f} ms; wall "
        f"{wall_2:.1f}s  [{card}]")
    out["12d-2"] = {"ids": kids, "cancel_s": cancel_s, "d_state_at_cancel": d_state,
                    "kill_s": t_kill, "killed_steps": killed_steps,
                    "killed_launches": killed_launches, "checkpoint_step_e": ckpt_e,
                    "handed_e": handed, "redone_steps": redone, "recovery": recovery,
                    "restart_steps": restart_steps, "restart_launches": restart_launches,
                    "allocated_before": before, "allocated_after_kill": after_kill,
                    "journal": kinds, "progress": progress, "commit_s": commit_s,
                    "wall_s": wall_2}
    launches = {n: launches_1[n] + killed_launches[n] + restart_launches[n]
                for n in KERNEL_NAMES}
    release(rebuilt)
    del svc2, gw2, rebuilt
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12d {out['seconds']:.1f}s ({out['12d-1']['steps'] + killed_steps + restart_steps}"
        f" steps, {(out['12d-1']['steps'] + killed_steps + restart_steps) * pbt:.3f}s of them); "
        f"launches {launches}  [{card}]")
    return launches, out


# ---------------------------------------------------------------- phase 12e
CA_BATCHES = 8
#: 12e's jobs (name, lr): GPT-2-small at FAULT_LAYERS, phase 7's and 11's depth
CA_JOBS = {"P": ("ca-p", 6e-4), "Q": ("ca-q", 1e-3)}
#: the builds a job hands the pool at ADMIT: the CUDA sources of its kernels
CA_SOURCES = ("flash_attn", "linear_ce")
CA_ACQUIRE_S = 120.0  # how long a job's first model build waits for a build in flight


def prewarm_task_class(sat):
    """A task whose builds (CA_SOURCES) the service's compile-ahead pool
    starts at ADMIT (its ``compile_ahead`` hook), and whose first model
    build after that takes them from the pool (``acquire``: a hit when the
    pool got there first). Without a pool it is a plain task. ``losses``
    keeps every interval's ``last_losses``."""
    from saturn_tpu_torch.tenancy.compile_ahead import build_thunks

    class PrewarmTask(sat.Task):
        ca_pool = None
        _ca_keys = None

        @property
        def last_losses(self):
            return self._last_losses

        @last_losses.setter
        def last_losses(self, value):
            self._last_losses = value
            self.__dict__.setdefault("losses", []).extend(value)

        def compile_ahead(self, topology):
            pairs = build_thunks(CA_SOURCES)
            self._ca_keys = [k for k, _ in pairs]
            return pairs

        def get_model(self, **overrides):
            keys, self._ca_keys = self._ca_keys, None
            for key in keys or ():
                if self.ca_pool.acquire(key, timeout=CA_ACQUIRE_S) is None:
                    raise AssertionError(f"12e: {self.name}: build {key} missed the pool "
                                         f"({self.ca_pool.error(key)})")
            return super().get_model(**overrides)

    return PrewarmTask


def compile_ahead_run(sat, flash, ce, topo, cache_dir, interval, root, label, pool):
    """12e's two jobs through a durable service, with ``pool`` or without."""
    from saturn_tpu_torch.service import SaturnService, ServiceClient

    cls = prewarm_task_class(sat)
    tasks = {k: lm_task(sat, name, lr, CA_BATCHES, os.path.join(root, label),
                        n_layers=fault_layers(), task_cls=cls)
             for k, (name, lr) in CA_JOBS.items()}
    for t in tasks.values():
        t.ca_pool = pool
    journal = os.path.join(OUT, f"compile_ahead_journal_{label}")
    shutil.rmtree(journal, ignore_errors=True)
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    svc = SaturnService(topology=topo, interval=interval, technique_names=["dp"],
                        profile_cache=cache_dir, durability_dir=journal, compile_ahead=pool)
    if pool is not None and pool.journal is not svc.journal:
        raise AssertionError("12e: the service did not give the pool its journal")
    svc.start()
    client = ServiceClient(svc)
    try:
        ids = {k: client.submit(t, spec={"lr": CA_JOBS[k][1]}) for k, t in tasks.items()}
        snaps = {k: client.wait(j, timeout=600) for k, j in ids.items()}
    finally:
        svc.stop(timeout=600)
    wall = time.perf_counter() - t0
    launches = counts(flash, ce)
    if {k: s["state"] for k, s in snaps.items()} != {k: "DONE" for k in CA_JOBS}:
        raise AssertionError(f"12e {label}: job states {snaps}")
    return tasks, snaps, launches, journal, wall


def compile_ahead_phase(sat, flash, ce, card) -> tuple:
    """Phase 12e: the compile-ahead pool on the card. The same two jobs
    through a durable service without a pool and with one: the pool's
    ``requested`` / ``ready`` / ``hit`` records per build, its hit rate 1.0,
    exact launches, and the same losses and checkpoints bit for bit."""
    from saturn_tpu_torch.durability import recovery as rmod
    from saturn_tpu_torch.durability import replay
    from saturn_tpu_torch.tenancy import CompileAheadPool
    from saturn_tpu_torch.tenancy.compile_ahead import build_thunks
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    sat.library.register_default_library()
    topo = topology()
    cache_dir = seeded_cache("compile_ahead_profile_cache")
    root = os.path.join(CKPTS, "compile_ahead")
    shutil.rmtree(root, ignore_errors=True)
    layers = fault_layers()
    log(f"phase 12e: the compile-ahead pool, two GPT-2-small jobs b{BATCH}x{SEQ} at {layers} "
        f"of its {LAYERS} layers, dp")
    template = lm_task(sat, "ca-template", 6e-4, CA_BATCHES, os.path.join(root, "t"),
                       n_layers=layers)
    stats = sat.search([template], technique_names=["dp"], topology=topo,
                       profile_cache=cache_dir, fusion=False)
    strat = template.strategies[1]
    config, pbt = dict(strat.params), strat.per_batch_time
    interval = SERVICE_INTERVAL_SHARE * CA_BATCHES * pbt
    release([template])
    del template, strat
    out = {"config": config, "per_batch_s": pbt, "interval_s": interval,
           "template_trials": stats["trials_run"]}
    log(f"  the jobs' profile: {config}, {pbt * 1e3:.3f} ms/batch ({stats['trials_run']} "
        f"trial(s)); interval {interval:.3f}s")
    keys = [k for k, _ in build_thunks(CA_SOURCES)]
    runs = {}
    for label in ("plain", "pool"):
        pool = CompileAheadPool(workers=1) if label == "pool" else None
        tasks, snaps, launches, journal, wall = compile_ahead_run(
            sat, flash, ce, topo, cache_dir, interval, root, label, pool)
        steps, discarded = job_steps(tasks.values())
        check_launches(f"12e {label}", launches,
                       want_fault_launches(config, steps + discarded, layers))
        kinds = check_service_journal(journal, 1, extra_kinds=("compile_ahead",))
        first_step = {k: s["started_at"] - s["admitted_at"] for k, s in snaps.items()}
        if any(len(t.losses) != CA_BATCHES or not np.isfinite(t.losses).all()
               for t in tasks.values()):
            raise AssertionError(f"12e {label}: losses {[t.losses for t in tasks.values()]}")
        runs[label] = {"first_step_s": first_step, "launches": launches, "steps": steps,
                       "journal": kinds, "wall_s": wall,
                       "losses": {k: t.losses for k, t in tasks.items()},
                       "states": {k: ckpt.load(t.ckpt_path) for k, t in tasks.items()}}
        if pool is not None:
            ledger = pool.ledger()
            records = [r["data"] for r in replay(journal, strict=True)
                       if r["kind"] == "compile_ahead"]
            per_key = {key: sorted({d["status"] for d in records if d["key"] == key})
                       for key in keys}
            want_counts: dict = {}
            for d in records:
                want_counts[d["status"]] = want_counts.get(d["status"], 0) + 1
            folded = rmod.replay_service_state(journal).compile_ahead
            if any(v != ["hit", "ready", "requested"] for v in per_key.values()):
                raise AssertionError(f"12e: the journal's compile_ahead statuses per build "
                                     f"{per_key}")
            if folded != want_counts or ledger["hit_rate"] != 1.0 \
                    or ledger["requested"] != len(keys) or ledger["ahead_misses"]:
                raise AssertionError(f"12e: the fold {folded} of {want_counts}, the ledger "
                                     f"{ledger}")
            runs[label]["ledger"] = ledger
            runs[label]["folded"] = folded
        release(tasks.values())
        del tasks
        log(f"  12e {label}: admit -> first step "
            + ", ".join(f"{k} {v:.3f}s" for k, v in first_step.items())
            + f"; {steps} steps, launches {launches} (exact); journal {kinds}"
            + (f"; pool ledger {runs[label]['ledger']}, fold {runs[label]['folded']}"
               if pool is not None else "") + f"; wall {wall:.1f}s  [{card}]")
    for k in CA_JOBS:
        if runs["pool"]["losses"][k] != runs["plain"]["losses"][k]:
            raise AssertionError(f"12e {k}: losses with the pool {runs['pool']['losses'][k]}, "
                                 f"without {runs['plain']['losses'][k]}")
        check_same_state(CA_JOBS[k][0], runs["plain"]["states"][k], runs["pool"]["states"][k])
    for run in runs.values():
        del run["states"]
    out["runs"] = runs
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  12e: losses and checkpoints with the pool bitwise those without; phase 12e "
        f"{out['seconds']:.1f}s  [{card}]")
    return runs["pool"]["launches"], out


# ----------------------------------------------------------------- phase 13
TWIN_SOLVE_S = 30.0  # 13a: every tier the ladder tries finishes inside it (tests/test_twin.py)
#: 13a's storm: tests/test_twin.py's STORM_CFG
TWIN_STORM = dict(n_jobs=24, n_slices=2, interval_s=12.0, total_batches=6,
                  solve_deadline_s=TWIN_SOLVE_S, metrics=False, seed=3, storm=True,
                  storm_p_preempt=0.6, storm_p_crash=0.5, storm_p_straggler=0.3,
                  outage_intervals=1, max_intervals=80)


def band_terms(fid: dict) -> list:
    """The terms of a fidelity comparison that left its band."""
    band = fid["band"]
    lo, hi = band["makespan_ratio"]
    terms = [f"tier {t} ({d})" for t, d in fid["tier_share_deltas"].items()
             if d > band["tier_share_delta"]]
    terms += [f"verdict {v} ({d})" for v, d in fid["verdict_share_deltas"].items()
              if d > band["verdict_share_delta"]]
    if not lo <= fid["makespan_ratio"] <= hi:
        terms.append(f"makespan ratio {fid['makespan_ratio']}")
    return terms


def journal_jobs(root: str) -> dict:
    """task -> (submit ts, terminal ts, terminal state) from a service journal."""
    from saturn_tpu_torch.durability import replay_reconciled

    names, out = {}, {}
    for r in replay_reconciled(root):
        d = r["data"]
        if r["kind"] == "job_submitted":
            names[d["job"]] = d["task"]
            out[d["task"]] = [r["ts"], None, None]
        elif r["kind"] == "job_state" and d["state"] in ("DONE", "FAILED", "EVICTED"):
            out[names[d["job"]]][1:] = [r["ts"], d["state"]]
    return {k: tuple(v) for k, v in out.items()}


def twin_phase(card, service_out) -> dict:
    """Phase 13: the digital twin on the card's host. 13a the synth and
    storm campaigns, each twice; 13b phase 12a's journal replayed in trace
    mode at 12a's measured per-batch time and interval."""
    from saturn_tpu_torch.analysis.cli import _twin_fidelity
    from saturn_tpu_torch.twin.runner import CampaignConfig, run_campaign
    from saturn_tpu_torch.twin.trace import load_trace

    t_phase = time.perf_counter()
    root = os.path.join(OUT, "twin")
    shutil.rmtree(root, ignore_errors=True)
    import scipy

    # tier 1's MILPs (HiGHS through scipy) decide the campaigns' plans: their
    # bytes repeat on one installation, not across scipy versions
    log(f"phase 13: the digital twin (twin/) on the card's host (scipy {scipy.__version__}, "
        f"numpy {np.__version__})")
    out = {}
    with EnvSet(SATURN_TPU_PARTITION_MAX="4"):
        for label, cfg in (("synth", CampaignConfig(solve_deadline_s=TWIN_SOLVE_S, seed=7)),
                           ("storm", CampaignConfig(**TWIN_STORM))):
            runs = [run_campaign(cfg, os.path.join(root, f"{label}-{i}")) for i in range(2)]
            blobs = []
            for i in range(2):
                with open(os.path.join(root, f"{label}-{i}", "events.jsonl"), "rb") as f, \
                        open(os.path.join(root, f"{label}-{i}", "ledger.json"), "rb") as g:
                    blobs.append((f.read(), g.read()))
            s = runs[0]
            if blobs[0] != blobs[1] or not blobs[0][0]:
                raise AssertionError(f"13a {label}: the two runs' events or ledgers differ")
            if s["status"] != "ok" or s["deadline_misses"]:
                raise AssertionError(f"13a {label}: {s['status']}, {s['deadline_misses']} "
                                     f"deadline misses")
            if label == "storm" and s["completed"] + s["failed"] != cfg.n_jobs:
                raise AssertionError(f"13a storm: {s['completed']} completed + {s['failed']} "
                                     f"failed of {cfg.n_jobs}")
            keep = ("submitted", "shed_total", "completed", "failed", "evicted", "solves",
                    "tier_counts", "tier_shares", "intervals", "makespan_s",
                    "topology_changes", "crashes", "preemption_requeues")
            out[f"13a-{label}"] = {**{k: s[k] for k in keep},
                                   "wall_s": [r["wall_s"] for r in runs]}
            log(f"  13a {label}: events and ledger bitwise equal over 2 runs; "
                f"{s['submitted']} submitted, {s['completed']} completed, {s['failed']} failed, "
                f"{s['evicted']} evicted, {s['shed_total']} shed; tiers {s['tier_shares']}; "
                f"{s['intervals']} intervals, {s['makespan_s']:.1f} sim s in "
                f"{runs[0]['wall_s']:.2f} / {runs[1]['wall_s']:.2f} s wall  [{card}]")

    # 13b: phase 12a's journal through the twin
    a = service_out["12a"]
    journal, metrics_path = service_out["journals"]["A"], service_out["events"]["A"]
    pbt = a["device_s"] / a["steps"]
    interval = service_out["interval_s"]
    cfg = CampaignConfig(trace_dir=journal, n_slices=1, chips_per_slice=1, interval_s=interval,
                         solve_deadline_s=interval / 2, flat_per_batch_s=pbt, metrics=False,
                         seed=0)
    twin_dir = os.path.join(root, "replay-12a")
    s = run_campaign(cfg, twin_dir)
    trace = load_trace(journal)
    with open(os.path.join(twin_dir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    admitted = [e["task"] for e in events if e["kind"] == "admission"]
    if (s["submitted"] != len(trace.jobs) or s["duplicates"] or s["shed_total"]
            or sorted(admitted) != sorted(j.name for j in trace.jobs)):
        raise AssertionError(f"13b: {s['submitted']} submitted, admissions {admitted}, of the "
                             f"journal's {[j.name for j in trace.jobs]}")
    fid = _twin_fidelity(s, journal, metrics_path)
    at = {j.name: j.at_s for j in trace.jobs}
    done = {e["task"]: e["t"] for e in events if e["kind"] == "job_completed"}
    real = journal_jobs(journal)
    t0 = min(v[0] for v in real.values())
    per_job = {n: {"twin_s": done[n] - at[n] if n in done else None,
                   "real_s": (v[1] - v[0]) if v[1] is not None else None,
                   "real_state": v[2], "submit_s": v[0] - t0}
               for n, v in sorted(real.items(), key=lambda kv: kv[1][0])}
    terms = band_terms(fid)
    out["13b"] = {"per_batch_s": pbt, "interval_s": interval, "per_job": per_job,
                  "twin_makespan_s": s["makespan_s"],
                  "real_makespan_s": fid["reference"]["real_makespan_s"],
                  "fidelity": fid, "out_of_band": terms, "tier_counts": s["tier_counts"]}
    def secs(x):
        return "none" if x is None else f"{x:.3f}s"

    for n, v in per_job.items():
        log(f"    {n}: submitted at {v['submit_s']:.3f}s; submit -> done twin "
            f"{secs(v['twin_s'])}, journal {secs(v['real_s'])} ({v['real_state']})")
    log(f"  13b: 12a's journal ({len(trace.jobs)} submissions, each once) in trace mode at "
        f"{pbt * 1e3:.3f} ms/batch and a {interval:.3f}s interval: makespan twin "
        f"{s['makespan_s']:.3f}s against the journal's {fid['reference']['real_makespan_s']:.3f}s"
        f" (ratio {fid['makespan_ratio']}); tier deltas {fid['tier_share_deltas']}, verdict "
        f"deltas {fid['verdict_share_deltas']}; within_band {fid['within_band']}"
        + (f", out of band: {terms}" if terms else "") + f"  [{card}]")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13 {out['seconds']:.1f}s  [{card}]")
    return out


# ----------------------------------------------------------------- phase 14
MD_CONFIG = {"attention": "flash", "remat": False}
MD_LOSS0_REL = 1e-5      # a first loss of two replicas against one replica at the full batch
MD_LOSS_REL = 1e-3       # 14a's losses over an eager step and a window (phase 10b's bounds for
MD_PARAM_REL = 5e-3      # another summation order); its parameters, by relative norm
MD_LAYERS = 4            # 14b and 14c's depth
MD_SEARCH_POSITIONS = 8  # 14b: [card 0] * 8, sizes 1, 2, 4, 8
MD_SEARCH_BATCHES = 24
# 14b runs one step at a time: its checks (the anchors, the fill, the plan,
# the launches) do not depend on K, and capturing windows of 8 replicas is
# most of its time; 14a and 14c run windows
MD_SEARCH_ENV = {"SATURN_TPU_MAX_WINDOW": "1"}
MD_ELASTIC_BATCHES = 96  # 14c: three intervals of 32 batches
MD_ELASTIC_SEED = 27     # seeded_schedule(27, 3, 2), preemptions only: position 1, 0.165 s
                         # into interval 1
MD_PREEMPT_ONLY = dict(p_preempt=0.5, p_crash=0.0, p_straggler=0.0)
PAD_ID = 0               # 14a's padded MLM objective: the pad id is no label


def md_devices(n: int, distinct: bool = False):
    """``n`` positions: card 0 repeated, or cards 0..n-1."""
    return [torch.device(DEVICE, i if distinct else 0) for i in range(n)]


def replicas_equal(state) -> bool:
    from saturn_tpu_torch.parallel.spmd_base import replicas

    reps = replicas(state)
    return all(torch.equal(a, b.to(a.device)) for rep in reps[1:]
               for a, b in zip(reps[0]["params"].parameters(), rep["params"].parameters()))


def dtoh_copies(fn, n: int = 2) -> float:
    """Device-to-host copies per call of ``fn``, from a torch.profiler
    window of ``n`` calls."""
    _, events = profiled(fn, n)
    return sum("DtoH" in name for name, _, _ in events) / n


def flat_params(state) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1) for p in state["params"].parameters()])


def md_state(bundle, base=None):
    """A fresh train state of ``bundle``: its seed-0 init, or, given
    ``base`` (the state dict of a seed-0 init of the same model), those
    weights copied into every replica of an uninitialised state, with fresh
    optimizers: the same state without drawing the weights again."""
    from saturn_tpu_torch.parallel.spmd_base import replicas

    if base is None:
        return bundle.init()
    state = bundle.empty()
    for rep in replicas(state):
        rep["params"].load_state_dict(base)
    return state


def md_gpt2_run(sat, flash, ce, devices, base=None) -> dict:
    """GPT-2-small b8 x 512 (dp, flash, fused head, remat off) on
    ``devices``: an eager step, then a window of WINDOW steps (WINDOW eager
    steps over distinct cards, where a block runs K = 1), from the seed-0
    init (``md_state``). Launches of each unit, whether the replicas are
    bitwise equal after each, the milliseconds per batch of the window, the
    peak memory, the device-to-host copies of two more eager steps, and
    (``base``) the init's weights."""
    from saturn_tpu_torch.core.mesh import physical_groups
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens
    from saturn_tpu_torch.utils import timing

    task = lm_task(sat, f"md-gpt2-{len(devices)}", 6e-4, 1 + WINDOW, os.path.join(CKPTS, "md"))
    tech = DataParallel()
    bundle = tech.build(task, devices, MD_CONFIG)
    dev = bundle.device
    state = md_state(bundle, base)
    drawn = None if base is not None else {k: v.clone()
                                           for k, v in state["params"].state_dict().items()}
    for d in set(bundle.devices):
        timing.synchronize(d)
        timing.reset_peak_memory(d)
    reset_counts(flash, ce)
    state, loss = bundle.step(state, bundle.stage(task.batch_at(0)))
    eager, equal = counts(flash, ce), [replicas_equal(state)]
    stack = stage_tokens(np.stack([task.batch_at(1 + i) for i in range(WINDOW)]), dev)
    graphed = len(physical_groups(devices)) == 1
    if graphed:
        bundle.capture([WINDOW], state, stack.shape[-2:])
    reset_counts(flash, ce)
    timing.synchronize(dev)
    t0 = time.perf_counter()
    if graphed:
        state, losses = bundle.fused(WINDOW)(state, stack)
    else:
        out = []
        for i in range(WINDOW):
            state, one = bundle.step(state, stack[i])
            out.append(one)
        losses = torch.stack(out)
    timing.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / WINDOW
    window = counts(flash, ce)
    equal.append(replicas_equal(state))
    peak = max(timing.peak_memory_bytes(d) for d in set(bundle.devices))
    result = {"losses": [float(loss)] + [float(x) for x in losses.reshape(-1).tolist()],
              "params": flat_params(state), "eager": eager, "window": window,
              "replicas_equal": equal, "ms_per_batch": ms, "peak_bytes": peak,
              "graphed": graphed, "base": drawn}
    batch = bundle.stage(task.batch_at(0))
    result["dtoh_per_step"] = dtoh_copies(lambda: bundle.step(state, batch))
    del state, batch, stack
    tech.release_task(task.name)
    return result


def rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def md_step_check(sat, flash, ce, card, devices, label) -> dict:
    """14a / 14d's GPT-2-small run on ``devices`` against one replica."""
    one = md_gpt2_run(sat, flash, ce, md_devices(1))
    many = md_gpt2_run(sat, flash, ce, devices, base=one.pop("base"))
    many.pop("base")
    n = len(devices)
    want_eager = want_launches("flash", None, 1)
    if one["eager"] != want_eager or one["window"] != want_launches("flash", None, WINDOW):
        raise AssertionError(f"{label}: one replica launched {one['eager']} / {one['window']}, "
                             f"want {want_eager} a step")
    for unit in ("eager", "window"):
        want = {k: n * v for k, v in one[unit].items()}
        if many[unit] != want:
            raise AssertionError(f"{label}: {n} replicas launched {many[unit]} in the {unit} "
                                 f"unit, want {want} ({n}x one replica's)")
    loss0 = rel(many["losses"][0], one["losses"][0])
    if not loss0 <= MD_LOSS0_REL:
        raise AssertionError(f"{label}: first loss {many['losses'][0]} against "
                             f"{one['losses'][0]}: rel {loss0:.3e} > {MD_LOSS0_REL:g}")
    loss_rel = max(rel(a, b) for a, b in zip(many["losses"], one["losses"]))
    if not loss_rel <= MD_LOSS_REL:
        raise AssertionError(f"{label}: losses {many['losses']} against {one['losses']}: "
                             f"rel {loss_rel:.3e} > {MD_LOSS_REL:g}")
    a, b = many.pop("params"), one.pop("params")
    param_rel = float((a.to(b.device) - b).norm() / b.norm())
    del a, b
    if not param_rel <= MD_PARAM_REL:
        raise AssertionError(f"{label}: parameters after {1 + WINDOW} steps at rel norm "
                             f"{param_rel:.3e} > {MD_PARAM_REL:g}")
    if not all(many["replicas_equal"]):
        raise AssertionError(f"{label}: replicas not bitwise equal after each unit: "
                             f"{many['replicas_equal']}")
    if many["dtoh_per_step"] or one["dtoh_per_step"]:
        raise AssertionError(f"{label}: device-to-host copies per step {many['dtoh_per_step']} "
                             f"({n} replicas), {one['dtoh_per_step']} (one)")
    log(f"  {label}: GPT-2-small b{BATCH}x{SEQ} dp flash + fused head, {n} replicas on "
        f"{[str(d) for d in devices]} against one: first loss rel {loss0:.2e} (bound "
        f"{MD_LOSS0_REL:g}), losses over an eager step and "
        f"{'a window' if many['graphed'] else 'eager steps'} of {WINDOW} rel "
        f"{loss_rel:.2e} (bound {MD_LOSS_REL:g}), parameters rel norm {param_rel:.2e} "
        f"(bound {MD_PARAM_REL:g}); replicas bitwise equal after each unit; launches "
        f"{many['eager']} a step ({n}x one replica's), 0 device-to-host copies a step; "
        f"{many['ms_per_batch']:.2f} ms/batch against {one['ms_per_batch']:.2f}, peak "
        f"{many['peak_bytes'] / 2**30:.2f} GiB against {one['peak_bytes'] / 2**30:.2f} GiB  "
        f"[{card}]")
    torch.cuda.empty_cache()
    return {"one": one, "many": many, "loss0_rel": loss0, "loss_rel": loss_rel,
            "param_rel": param_rel}


def pad_mlm_loss(logits, tokens):
    """Mean CE at BERT's masked positions that do not hold PAD_ID."""
    from saturn_tpu_torch.models.bert import _mask

    B, T = tokens.shape
    m = (_mask(T, tokens.device)[None, :] & (tokens != PAD_ID)).float()
    per = F.cross_entropy(logits.float().reshape(B * T, -1), tokens.reshape(-1).long(),
                          reduction="none").reshape(B, T)
    return (per * m).sum() / m.sum().clamp_min(1)


pad_mlm_loss.supports_fused_head = "mlm-pad"


def untagged(fn):
    def loss(logits, tokens):
        return fn(logits, tokens)
    return loss


def pad_bert(**kw):
    """BERT-base whose fused head also takes PAD_ID as no label (the
    objective of ``pad_mlm_loss``)."""
    from saturn_tpu_torch.models import bert, gpt2

    cfg = bert.build_bert(BERT, **kw).config
    mask_id = cfg.vocab_size - 1

    def inputs(tokens):
        m = bert._mask(tokens.shape[-1], tokens.device)[None, :]
        return torch.where(m, torch.full_like(tokens, mask_id), tokens)

    def labels(tokens):
        keep = bert._mask(tokens.shape[-1], tokens.device)[None, :] & (tokens != PAD_ID)
        return torch.where(keep, tokens.to(torch.int32), -1)

    return gpt2.spec_for(cfg, inputs_fn=inputs, labels_fn=labels, objective="mlm-pad")


def uneven_batch(seed: int = 14) -> np.ndarray:
    """A b8 x 512 BERT batch whose first half of rows hold PAD_ID at 80 % of
    their positions: the padded objective's replicas count different
    numbers of labels."""
    rng = np.random.default_rng(seed)
    batch = rng.integers(1, VOCAB - 1, size=(BATCH, SEQ))
    batch[:BATCH // 2][rng.random((BATCH // 2, SEQ)) < 0.8] = PAD_ID
    return batch


def md_bert_first_losses(sat, flash, ce, card, devices) -> dict:
    """BERT-base's first loss on ``devices`` against one replica at b8, on
    ``mlm_loss`` and the padded objective, each through the fused head's
    parts and over the logits (an untagged copy)."""
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.bert import build_bert, mlm_loss
    from saturn_tpu_torch.parallel.dp import DataParallel

    batch = uneven_batch()
    out, base = {}, None
    for objective, tagged, model in (("mlm", mlm_loss, lambda **kw: build_bert(BERT, **kw)),
                                     ("mlm-pad", pad_mlm_loss, pad_bert)):
        for route, loss_fn in (("fused", tagged), ("logits", untagged(tagged))):
            got = {}
            for n, devs in ((1, md_devices(1)), (len(devices), devices)):
                task = sat.Task(get_model=lambda **kw: model(**{"seq_len": SEQ, **kw}),
                                get_dataloader=lambda: make_lm_dataset(
                                    context_length=SEQ, batch_size=BATCH, vocab_size=VOCAB,
                                    seed=0, reserved_ids=1),
                                loss_fn=loss_fn, hparams=sat.HParams(lr=1e-3, batch_count=1),
                                name=f"md-bert-{objective}-{route}-{n}",
                                save_dir=os.path.join(CKPTS, "md"))
                tech = DataParallel()
                bundle = tech.build(task, devs, MD_CONFIG)
                state = md_state(bundle, base)
                if base is None:  # one seed-0 draw for every run: one BERT-base shape
                    base = {k: v.clone() for k, v in state["params"].state_dict().items()}
                reset_counts(flash, ce)
                _, loss = bundle.step(state, bundle.stage(batch))
                got[n] = (float(loss), counts(flash, ce)["ce_fwd"])
                del state
                tech.release_task(task.name)
            r = rel(got[len(devices)][0], got[1][0])
            want_ce = len(devices) if route == "fused" else 0
            if got[len(devices)][1] != want_ce or got[1][1] != (1 if route == "fused" else 0):
                raise AssertionError(f"14a BERT {objective} {route}: CE forward launches "
                                     f"{got[len(devices)][1]} / {got[1][1]}")
            if not r <= MD_LOSS0_REL:
                raise AssertionError(f"14a BERT {objective} {route}: first loss "
                                     f"{got[len(devices)][0]} against {got[1][0]}: rel {r:.3e} "
                                     f"> {MD_LOSS0_REL:g}")
            out[f"{objective}-{route}"] = {"loss": got[len(devices)][0], "one": got[1][0],
                                           "rel": r}
    from saturn_tpu_torch.models.bert import _mask

    keep = (_mask(SEQ, "cpu")[None, :] & (torch.from_numpy(batch) != PAD_ID)).sum(1)
    rows = BATCH // len(devices)
    counts_by_row = [int(keep[r * rows:(r + 1) * rows].sum()) for r in range(len(devices))]
    if len(set(counts_by_row)) < 2:
        raise AssertionError(f"14a: the padded batch's replicas hold {counts_by_row} labels")
    log(f"  14a BERT-base b{BATCH}x{SEQ}, {len(devices)} replicas against one, first loss: "
        + ", ".join(f"{k} rel {v['rel']:.2e}" for k, v in out.items())
        + f" (bound {MD_LOSS0_REL:g}; the padded objective's replicas count {counts_by_row} "
        f"labels, mlm_loss's static mask the same in every row)  [{card}]")
    out["pad_label_counts"] = counts_by_row
    return out


def md_search_phase(sat, flash, ce, card) -> tuple:
    """14b: search(prune=True) of a GPT-2-small task at MD_LAYERS over
    [card 0] * 8, then orchestrate of its plan."""
    from saturn_tpu_torch import analysis
    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.trial_runner import evaluator
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import metrics
    from saturn_tpu_torch.utils import profile_cache as pcache

    topo = SliceTopology(md_devices(MD_SEARCH_POSITIONS))
    save_dir = os.path.join(CKPTS, "md_search")
    cache_dir = os.path.join(OUT, "md_search_profile_cache")
    events = os.path.join(OUT, "md_search_events.jsonl")
    shutil.rmtree(cache_dir, ignore_errors=True)
    if os.path.exists(events):
        os.unlink(events)
    task = lm_task(sat, "md-search", 6e-4, MD_SEARCH_BATCHES, save_dir, n_layers=MD_LAYERS)
    workers = evaluator._default_parallelism(topo)
    if workers != 1:
        raise AssertionError(f"14b: parallel_trials resolves to {workers} on {topo.devices}")
    sig = pcache.topology_signature(topo)
    cards = f"{torch.cuda.get_device_name(0) if DEVICE == 'cuda' else 'cpu'}x8:cap8"
    if sig == cards or not sig.endswith(":distinct1"):
        raise AssertionError(f"14b: the rehearsal's topology signature {sig!r} against eight "
                             f"cards' {cards!r}")
    t0 = time.perf_counter()
    with EnvSet(**MD_SEARCH_ENV):
        stats = sat.search([task], technique_names=["dp"], topology=topo,
                           profile_cache=cache_dir, metrics_path=events, fusion=False)
    search_s = time.perf_counter() - t0
    tech = task.strategies[1].executor
    trialled = sorted({size for name, size, _, _, _ in tech.trials if name == task.name})
    if trialled != [1, 4, 8]:
        raise AssertionError(f"14b: trialled sizes {trialled}, want the anchors [1, 4, 8]")
    s2 = task.strategies[2]
    interp = metrics.read_events(events, kind="trial_interpolated")
    if not (s2.feasible and s2.interpolated) or [e["size"] for e in interp] != [2]:
        raise AssertionError(f"14b: size 2 {s2}, interpolated events {interp}")
    table = {g: (s.per_batch_time, dict(s.params or {}), s.interpolated)
             for g, s in sorted(task.strategies.items()) if s.feasible}
    reset_counts(flash, ce)
    marks = (len(tech.intervals), len(tech.discarded))
    interval = INTERVAL_SHARE * min(s.runtime for s in task.feasible_strategies().values())
    t0 = time.perf_counter()
    with VerifiedSources(analysis) as verified, EnvSet(**MD_SEARCH_ENV):
        out = sat.orchestrate([task], interval=interval, topology=topo, fusion=False)
    run_s = time.perf_counter() - t0
    launches = counts(flash, ce)
    if out["completed"] != [task.name] or out["failed"]:
        raise AssertionError(f"14b: {out}")
    step = ckpt.load(task.ckpt_path)["step"]
    if step != MD_SEARCH_BATCHES:
        raise AssertionError(f"14b: checkpoint step {step}, want {MD_SEARCH_BATCHES}")
    if not verified.sources:
        raise AssertionError("14b: no plan went through the plan verifier")
    runs = tech.intervals[marks[0]:] + tech.discarded[marks[1]:]
    want = md_want_launches(runs)
    check_launches("14b", launches, want)
    sizes = sorted({r["replicas"] for r in runs})
    log(f"  14b search(prune=True) over {MD_SEARCH_POSITIONS} positions of one card "
        f"(signature {sig!r}, parallel_trials 1): trials {stats['trials_run']} at sizes "
        f"{trialled}, size 2 from the fit ({s2.per_batch_time * 1e3:.2f} ms/batch), table "
        f"{ {g: round(t * 1e3, 3) for g, (t, _, _) in table.items()} } ms/batch, "
        f"{search_s:.1f}s; orchestrate ran blocks of {sizes} to step {step} "
        f"(plans verified: {verified.sources}), launches {launches} (exact), {run_s:.1f}s  "
        f"[{card}]")
    task.release_live_state()
    task.release_compiled()
    return launches, {"trialled": trialled, "stats": stats, "signature": sig,
                      "table_ms": {g: t * 1e3 for g, (t, _, _) in table.items()},
                      "search_s": search_s, "run_s": run_s, "sizes_run": sizes,
                      "launches": launches}


def md_want_launches(runs) -> dict:
    """Exact launches of interval records ``runs`` at MD_LAYERS: each step
    of each replica launches its kernels."""
    want = dict.fromkeys(KERNEL_NAMES, 0)
    for r in runs:
        steps = r["n"] * r["replicas"]
        for name in FLASH_NAMES:
            want[name] += flash_per_step(r["config"], name, MD_LAYERS) * steps
        for name in CE_NAMES:
            want[name] += steps
    return want


def md_elastic_phase(sat, flash, ce, card) -> tuple:
    """14c: a dp task on both positions of [card 0] * 2 loses position 1,
    with no return, during interval 1 (a seeded slice_preemption); it
    shrinks to one replica, restores the checkpoint there and ends at its
    full budget."""
    from saturn_tpu_torch import analysis
    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.resilience import FaultInjector, seeded_schedule
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import metrics

    topo = SliceTopology(md_devices(2))
    save_dir = os.path.join(CKPTS, "md_elastic")
    cache_dir = os.path.join(OUT, "md_elastic_profile_cache")
    events = os.path.join(OUT, "md_elastic_events.jsonl")
    shutil.rmtree(cache_dir, ignore_errors=True)
    if os.path.exists(events):
        os.unlink(events)
    schedule = seeded_schedule(MD_ELASTIC_SEED, 3, 2, **MD_PREEMPT_ONLY)
    if [(e.at_interval, e.kind, e.devices) for e in schedule] != [(1, "slice_preemption", (1,))]:
        raise AssertionError(f"14c: seeded schedule {schedule}")
    task = lm_task(sat, "md-elastic", 6e-4, MD_ELASTIC_BATCHES, save_dir, n_layers=MD_LAYERS)
    task.chip_range = [2]  # profiled at 2 replicas only: the replanner synthesizes size 1
    sat.search([task], technique_names=["dp"], topology=topo, profile_cache=cache_dir,
               fusion=False)
    strat = task.strategies[2]
    tech = strat.executor
    interval = strat.runtime / 3
    reset_counts(flash, ce)
    marks = (len(tech.intervals), len(tech.discarded))
    t0 = time.perf_counter()
    with VerifiedSources(analysis) as verified:
        out = sat.orchestrate([task], interval=interval, topology=topo, fusion=False,
                              fault_injector=FaultInjector(schedule=schedule),
                              failure_policy="retry", max_task_retries=1,
                              metrics_path=events)
    run_s = time.perf_counter() - t0
    launches = counts(flash, ce)
    if out["completed"] != [task.name] or out["failed"]:
        raise AssertionError(f"14c: {out}")
    step = ckpt.load(task.ckpt_path)["step"]
    if step != MD_ELASTIC_BATCHES:
        raise AssertionError(f"14c: checkpoint step {step}, want {MD_ELASTIC_BATCHES}")
    ev = metrics.read_events(events)

    def kinds(kind):
        return [e for e in ev if e["kind"] == kind]

    changes = [(c["change"], c["lost"], c["gained"]) for c in kinds("topology_change")]
    if changes != [("shrink", [1], [])]:
        raise AssertionError(f"14c: topology changes {changes}")
    replans = [e.get("synthesized") for e in kinds("replan")]
    migrations = [(m["moved_from"], m["moved_to"]) for m in kinds("migration")]
    if replans != [{task.name: [1]}] or migrations != [([2, 0], [1, 0])]:
        raise AssertionError(f"14c: replans {replans}, migrations {migrations}")
    if "migration-replan" not in verified.sources:
        raise AssertionError(f"14c: verified plans {verified.sources}")
    discarded = [r for r in tech.discarded[marks[1]:] if r["discarded"] == "preempted"]
    if [e["task"] for e in kinds("task_preempted")] != [task.name] or not discarded:
        raise AssertionError(f"14c: preempted {kinds('task_preempted')}, discarded "
                             f"{tech.discarded[marks[1]:]}: the loss did not land mid-interval")
    runs = tech.intervals[marks[0]:]
    after = [r for r in runs if r["replicas"] == 1]
    if not after or not after[0]["restored"] or {r["replicas"] for r in discarded} != {2}:
        raise AssertionError(f"14c: runs {[(r['replicas'], r['n'], r['restored']) for r in runs]}"
                             f", discarded {[(r['replicas'], r['n']) for r in discarded]}")
    check_launches("14c", launches, md_want_launches(runs + tech.discarded[marks[1]:]))
    lost_s = sum(r["state_s"] + r["run_s"] for r in discarded)
    latency = kinds("recovery")[0]["replan_latency_s"]
    log(f"  14c elastic: seeded_schedule({MD_ELASTIC_SEED}) = {schedule[0]}; interval "
        f"{interval:.3f}s; runs (replicas, batches, restored) "
        f"{[(r['replicas'], r['n'], r['restored']) for r in runs]}; discarded "
        f"{[(r['replicas'], r['n']) for r in discarded]} ({lost_s:.3f}s of work); shrink "
        f"lost [1], size 1 synthesized, migrated [2, 0] -> [1, 0], re-plan verified, "
        f"replan_latency_s {latency:.6f}; step {step}; launches {launches} (exact); "
        f"{run_s:.1f}s  [{card}]")
    task.release_live_state()
    task.release_compiled()
    return launches, {"schedule": str(schedule[0]), "interval_s": interval,
                      "discarded_s": lost_s, "replan_latency_s": latency, "run_s": run_s,
                      "runs": [(r["replicas"], r["n"], r["restored"]) for r in runs],
                      "launches": launches}


def multi_device_phase(sat, flash, ce, card, parts=("14a", "14b", "14c", "14d")) -> tuple:
    """Phase 14: multi-device blocks rehearsed on one card (positions that
    name card 0 more than once): 14a the replicated step at full width,
    14b the control path, 14c the elastic shrink; 14d the step over two
    real cards, where the machine has them."""
    t_phase = time.perf_counter()
    sat.library.register_default_library()
    launches, out = dict.fromkeys(KERNEL_NAMES, 0), {}
    log(f"phase 14: multi-device blocks ({', '.join(parts)})")
    if "14a" in parts:
        t0 = time.perf_counter()
        out["14a"] = md_step_check(sat, flash, ce, card, md_devices(2), "14a")
        out["14a"]["bert"] = md_bert_first_losses(sat, flash, ce, card, md_devices(2))
        out["14a"]["seconds"] = time.perf_counter() - t0
    if "14b" in parts:
        got, out["14b"] = md_search_phase(sat, flash, ce, card)
        launches = {n: launches[n] + got[n] for n in KERNEL_NAMES}
    if "14c" in parts:
        got, out["14c"] = md_elastic_phase(sat, flash, ce, card)
        launches = {n: launches[n] + got[n] for n in KERNEL_NAMES}
    if "14d" in parts:
        cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
        if cards >= 2:
            out["14d"] = md_step_check(sat, flash, ce, card, md_devices(2, distinct=True), "14d")
        else:
            out["14d"] = {"ran": False, "why": f"{cards} CUDA device(s); NCCL across two "
                                                f"cards needs two"}
            log(f"  14d did not run: this machine has {cards} CUDA device(s), and the NCCL sum "
                f"across distinct cards needs two (not a pass)")
    for d in ("md", "md_search", "md_elastic"):
        shutil.rmtree(os.path.join(CKPTS, d), ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14 {out['seconds']:.1f}s  [{card}]")
    return launches, out


# ----------------------------------------------------------------- phase 15
FSDP_CONFIG = {"attention": "flash", "remat": False, "offload": False}
FSDP_OVERLAP = dict(FSDP_CONFIG, overlap=True)
FSDP_LAYERS = 4            # 15c's depth
FSDP_SEARCH_BATCHES = 24
FSDP_ELASTIC_BATCHES = 96  # 15c's drill: three intervals of 32 batches
FSDP_ELASTIC_SEED = 27     # seeded_schedule(27, 3, 2), preemptions only: position 1 in interval 1


def fsdp_want_launches(runs, layers: int) -> dict:
    """Exact launches of dp, fsdp and tp interval records ``runs`` at
    ``layers``: every replica (tp: every position, on its heads) of every
    step launches its flash kernels; the CE kernels run where the step
    takes the fused head (dp; fsdp on one position outside the ZeRO-3
    program) and not over the logits (fsdp and tp at n > 1)."""
    want = dict.fromkeys(KERNEL_NAMES, 0)
    for r in runs:
        steps = r["n"] * r["replicas"]
        for name in FLASH_NAMES:
            want[name] += flash_per_step(r["config"], name, layers) * steps
        fused = r.get("technique") == "dp" or (r["replicas"] == 1
                                               and not r["config"].get("overlap"))
        for name in CE_NAMES:
            want[name] += steps if fused else 0
    return want


def flat_full(state) -> dict:
    from saturn_tpu_torch.parallel.spmd_base import full_params

    return {k: v.clone() for k, v in full_params(state).items()}


def fsdp_run(sat, flash, ce, tech, devices, config, label: str, keep: bool = False,
             dtoh: bool = True) -> dict:
    """GPT-2-small b8 x 512 (flash, ``pretraining_loss``, remat off) under
    ``tech`` on ``devices`` from the seed-0 init: an eager step, then a
    window of WINDOW steps (a CUDA graph where the positions share a card,
    else WINDOW eager steps). The losses, the parameters after, each unit's
    launches, the ms per batch of the window, the peak memory and the
    device-to-host copies of two more eager steps; with ``keep`` the task,
    bundle and state."""
    from saturn_tpu_torch.core.mesh import physical_groups
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens
    from saturn_tpu_torch.utils import timing

    task = lm_task(sat, f"fsdp-{label}", 6e-4, 2 + 2 * WINDOW, os.path.join(CKPTS, "fsdp"))
    bundle = tech.build(task, devices, config)
    dev = bundle.device
    # what the card holds before this run (an earlier run's kept state):
    # the run's peak is counted above it
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    state = bundle.init()
    for d in set(bundle.devices):
        timing.synchronize(d)
        timing.reset_peak_memory(d)
    reset_counts(flash, ce)
    state, loss = bundle.step(state, bundle.stage(task.batch_at(0)))
    eager = counts(flash, ce)
    stack = stage_tokens(np.stack([task.batch_at(1 + i) for i in range(WINDOW)]), dev)
    graphed = len(physical_groups(devices)) == 1
    if graphed:
        bundle.capture([WINDOW], state, stack.shape[-2:])
    reset_counts(flash, ce)
    timing.synchronize(dev)
    t0 = time.perf_counter()
    if graphed:
        state, losses = bundle.fused(WINDOW)(state, stack)
    else:
        out = []
        for i in range(WINDOW):
            state, one = bundle.step(state, stack[i])
            out.append(one)
        losses = torch.stack(out)
    timing.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / WINDOW
    window = counts(flash, ce)
    peak = max(timing.peak_memory_bytes(d) for d in set(bundle.devices)) - held
    result = {"losses": [float(loss)] + [float(x) for x in losses.reshape(-1).tolist()],
              "params": flat_full(state), "eager": eager, "window": window,
              "ms_per_batch": ms, "peak_bytes": peak, "graphed": graphed}
    if keep:
        result.update(task=task, bundle=bundle, state=state, tech=tech)
        return result
    if dtoh:
        batch = bundle.stage(task.batch_at(0))
        result["dtoh_per_step"] = dtoh_copies(lambda: bundle.step(state, batch))
        del batch
    del state, stack
    tech.release_task(task.name)
    return result


def same_params(a: dict, b: dict) -> list:
    """The names whose tensors differ in a bit."""
    return [k for k in a if not torch.equal(a[k], b[k].to(a[k].device))]


def fsdp_step_check(sat, flash, ce, card, devices, label: str) -> dict:
    """15a / 15d: fsdp against dp on the same block and loss route (the
    logits: fsdp's rule at n > 1, dp with its fused head off), and the
    ZeRO-3 program prefetched against serial. Keeps dp's run for 15b, and
    in it the prefetched program's as ``zero3`` (for 16a)."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.fsdp import FSDP

    n = len(devices)
    dp = DataParallel()
    dp.fused_loss_shardable = False  # the logits route, as fsdp's at n > 1
    ref = fsdp_run(sat, flash, ce, dp, devices, {"attention": "flash", "remat": False},
                   f"{label}-dp", keep=True)
    runs = {"fsdp": fsdp_run(sat, flash, ce, FSDP(), devices, FSDP_CONFIG, f"{label}-fsdp")}
    for prefetch in (True, False):
        tech = FSDP()
        tech.prefetch = prefetch
        # the device-to-host count of the prefetched program (the serial one
        # differs in where its gathers run, not in what it reads back)
        runs[f"zero3-{'prefetch' if prefetch else 'serial'}"] = fsdp_run(
            sat, flash, ce, tech, devices, FSDP_OVERLAP, f"{label}-z{int(prefetch)}",
            dtoh=prefetch)
    want = {name: (LAYERS * n if name in FLASH_NAMES else 0) for name in KERNEL_NAMES}
    for name, run in [("dp", ref)] + list(runs.items()):
        if run["eager"] != want or run["window"] != {k: WINDOW * v for k, v in want.items()}:
            raise AssertionError(f"{label} {name}: launches {run['eager']} / {run['window']}, "
                                 f"want {want} a step")
        if run.get("dtoh_per_step"):
            raise AssertionError(f"{label} {name}: {run['dtoh_per_step']} device-to-host "
                                 f"copies a step")
    got = runs["fsdp"]
    if got["losses"] != ref["losses"] or same_params(ref["params"], got["params"]):
        raise AssertionError(f"{label}: fsdp losses {got['losses']} against dp's "
                             f"{ref['losses']}, differing parameters "
                             f"{same_params(ref['params'], got['params'])[:4]}")
    pre, ser = runs["zero3-prefetch"], runs["zero3-serial"]
    if pre["losses"] != ser["losses"] or same_params(pre["params"], ser["params"]):
        raise AssertionError(f"{label}: prefetched losses {pre['losses']} against serial "
                             f"{ser['losses']}, differing parameters "
                             f"{same_params(pre['params'], ser['params'])[:4]}")
    zero3_rel = max(rel(a, b) for a, b in zip(pre["losses"], ref["losses"]))
    if not zero3_rel <= MD_LOSS_REL:
        raise AssertionError(f"{label}: the ZeRO-3 program's losses {pre['losses']} against "
                             f"dp's {ref['losses']}: rel {zero3_rel:.3e} > {MD_LOSS_REL:g}")
    times = {name: (run["ms_per_batch"], run["peak_bytes"] / 2**30)
             for name, run in [("dp", ref)] + list(runs.items())}
    log(f"  {label}: GPT-2-small b{BATCH}x{SEQ} on {[str(d) for d in devices]}, flash, over "
        f"the logits: fsdp bitwise dp (an eager step and "
        f"{'a window' if ref['graphed'] else 'eager steps'} of {WINDOW}: {len(ref['losses'])} "
        f"losses, every parameter); the ZeRO-3 program prefetched bitwise serial, its losses "
        f"rel {zero3_rel:.2e} of dp's (each replica's mean over its rows); launches {want} a "
        f"step in every run, 0 device-to-host copies a step (fsdp, ZeRO-3 prefetched); "
        f"ms/batch and peak GiB above the card's holdings before each run "
        + ", ".join(f"{k} {ms:.2f} / {gib:.2f}" for k, (ms, gib) in times.items())
        + f"  [{card}]")
    ref["zero3"] = dict(pre)  # 16a holds tp's overlap config to it
    for run in runs.values():
        run.pop("params")
    torch.cuda.empty_cache()
    out = {"runs": {k: {kk: v for kk, v in run.items() if kk != "params"}
                    for k, run in runs.items()},
           "dp": {k: ref[k] for k in ("losses", "ms_per_batch", "peak_bytes", "eager", "window",
                                      "graphed")},
           "zero3_loss_rel": zero3_rel, "ms_peak": times}
    return out, ref


def dir_bytes(path: str) -> int:
    """Bytes of a checkpoint on disk: its manifest and its shard files."""
    import glob

    return sum(os.path.getsize(p) for p in [path] + glob.glob(glob.escape(path) + ".g*.npz"))


def timed_writes(path: str, legacy: str, state) -> dict:
    """The manifest's write (``save_async``: its host copy, then the disk
    write on its thread) and the single ``torch.save`` file of the port
    before it (its pinned host copy, then ``torch.save``), of one state, in
    turns: single, manifest, manifest, single (the first host copy of a run
    also pays the pinned allocations the others reuse)."""
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import timing

    dev = torch.device(DEVICE, 0)
    out = {"manifest": [], "single": []}
    for kind in ("single", "manifest", "manifest", "single"):
        timing.synchronize(dev)
        t0 = time.perf_counter()
        if kind == "manifest":
            ckpt.save_async(path, state)
            copy_s = time.perf_counter() - t0
            ckpt.flush()
        else:
            host = legacy_host_copy({"params": state["params"].state_dict(),
                                     "opt_state": state["opt_state"].state_dict(),
                                     "step": int(state["step"])})
            copy_s = time.perf_counter() - t0
            torch.save(host, legacy)
            del host
        out[kind].append((copy_s, time.perf_counter() - t0 - copy_s))
    out["manifest_bytes"], out["single_bytes"] = dir_bytes(path), os.path.getsize(legacy)
    os.unlink(legacy)
    return out


def fsdp_manifest_check(sat, flash, ce, card, ref) -> dict:
    """15b: dp's state of 15a written as a manifest (and, for the write
    times, as the single ``torch.save`` file the port wrote before it),
    restored under fsdp at 2 positions and dp at 1, one more eager step and
    window each, against dp's own state going on; a copy with a truncated
    shard file."""
    import glob

    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.fsdp import FSDP
    from saturn_tpu_torch.utils import checkpoint as ckpt

    task, state, bundle = ref.pop("task"), ref.pop("state"), ref.pop("bundle")
    path = task.ckpt_path
    writes = timed_writes(path, os.path.join(CKPTS, "fsdp", "single.pt"), state)
    if not ckpt.verify(path):
        raise AssertionError("15b: the manifest does not verify")
    want = flat_full(state)
    step0 = int(state["step"])

    def more(bundle, state) -> list:
        """One eager step and a window of WINDOW from ``step0``."""
        state, loss = bundle.step(state, bundle.stage(task.batch_at(step0)))
        stack = bundle.stage(np.stack([task.batch_at(step0 + 1 + i) for i in range(WINDOW)]))
        state, losses = bundle.fused(WINDOW)(state, stack)
        return [float(loss)] + [float(x) for x in losses.tolist()], flat_full(state)

    runs = {"dp-2 (its own state)": more(bundle, state)}
    del state
    ref["tech"].release_task(task.name)
    torch.cuda.empty_cache()
    for name, tech, n, config in (("fsdp-2", FSDP(), 2, FSDP_CONFIG),
                                  ("dp-1", DataParallel(), 1,
                                   {"attention": "flash", "remat": False})):
        b = tech.build(task, md_devices(n), config)
        got = ckpt.restore_sharded(path, b.empty())
        if same_params(want, flat_full(got)) or got["step"] != step0:
            raise AssertionError(f"15b {name}: the restored state differs from the saved one")
        runs[name] = more(b, got)
        del got
        tech.release_task(task.name)
    (dl, dp_params), (fl, fsdp_params) = runs["dp-2 (its own state)"], runs["fsdp-2"]
    if fl != dl or same_params(dp_params, fsdp_params):
        raise AssertionError(f"15b: fsdp restored {fl} against dp's own state {dl}")
    one = runs["dp-1"][0]
    one_rel = max(rel(a, b) for a, b in zip(one, dl))
    if not (np.isfinite(one).all() and one_rel <= BF16_BAND):
        raise AssertionError(f"15b: dp at 1 restored {one} against dp at 2 {dl}: rel "
                             f"{one_rel:.3e}")
    # a copy with one truncated shard file
    bad_dir = os.path.join(CKPTS, "fsdp_bad")
    os.makedirs(bad_dir, exist_ok=True)
    bad = os.path.join(bad_dir, os.path.basename(path))
    shutil.copy(path, bad)
    shards = glob.glob(glob.escape(path) + ".g*.npz")
    for s in shards:
        shutil.copy(s, bad_dir)
    victim = os.path.join(bad_dir, os.path.basename(shards[0]))
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    if ckpt.verify(bad):
        raise AssertionError("15b: a truncated shard file verifies")
    try:
        ckpt.restore_sharded(bad, FSDP().build(task, md_devices(2), FSDP_CONFIG).empty())
    except ckpt.CheckpointCorruptError as e:
        quarantined = e.quarantined
    else:
        raise AssertionError("15b: a truncated shard file restored")
    if quarantined != bad + ".corrupt" or os.path.exists(bad):
        raise AssertionError(f"15b: quarantined to {quarantined}")
    shutil.rmtree(bad_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    def pairs(kind):
        return ", ".join(f"{c:.3f} + {w:.3f}" for c, w in writes[kind])

    log(f"  15b: dp's state (2 positions, step {step0}): the manifest "
        f"{writes['manifest_bytes'] / 1e9:.3f} GB, host copy + disk write {pairs('manifest')} "
        f"s; the single torch.save file of before {writes['single_bytes'] / 1e9:.3f} GB, "
        f"{pairs('single')} s (in turns: single, manifest, manifest, single); verify True; "
        f"restored bitwise under fsdp at 2 and dp at 1; one more step and window: fsdp bitwise "
        f"dp's own state going on, dp at 1 (the fused head) rel {one_rel:.2e}; a truncated "
        f"shard file fails verify, its restore quarantined and raised  [{card}]")
    return {"writes": writes, "one_rel": one_rel,
            "losses": {k: v[0] for k, v in runs.items()}}


def legacy_host_copy(obj):
    """A pinned host copy of a payload, every copy queued before one wait
    (the single-file writer's snapshot before the manifest)."""
    streams = {}

    def copy(o):
        if isinstance(o, torch.Tensor):
            if not o.is_cuda:
                return o.detach().clone()
            host = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            host.copy_(o.detach(), non_blocking=True)
            streams.setdefault(o.device, torch.cuda.current_stream(o.device))
            return host
        if isinstance(o, dict):
            return {k: copy(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(copy(v) for v in o)
        return o

    out = copy(obj)
    for stream in streams.values():
        stream.synchronize()
    return out


def interval_runs(techs) -> list:
    """Every published and discarded interval record of ``techs``, each
    with its technique's name."""
    return [dict(r, technique=t.name) for t in techs for r in t.intervals + t.discarded]


def fsdp_search_phase(sat, flash, ce, card) -> tuple:
    """15c-1: search of a GPT-2-small task at FSDP_LAYERS with dp and fsdp
    registered, over [card 0] * 2 (trials one step at a time), then
    orchestrate of its plan to the budget."""
    from saturn_tpu_torch import analysis
    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import metrics

    topo = SliceTopology(md_devices(2))
    cache_dir = os.path.join(OUT, "fsdp_profile_cache")
    events = os.path.join(OUT, "fsdp_search_events.jsonl")
    shutil.rmtree(cache_dir, ignore_errors=True)
    if os.path.exists(events):
        os.unlink(events)
    task = lm_task(sat, "fsdp-search", 6e-4, FSDP_SEARCH_BATCHES,
                   os.path.join(CKPTS, "fsdp_search"), n_layers=FSDP_LAYERS)
    task.chip_range = [2]
    t0 = time.perf_counter()
    with EnvSet(**MD_SEARCH_ENV):
        sat.search([task], technique_names=["dp", "fsdp"], topology=topo,
                   profile_cache=cache_dir, metrics_path=events, fusion=False)
    search_s = time.perf_counter() - t0
    trials = [e for e in metrics.read_events(events) if e["kind"] == "trial"]
    # each lane's fastest config at each size, and its seconds a batch
    trialled = {name: [(e["size"], e["params"], e["per_batch_s"]) for e in trials
                       if e["technique"] == name and e["feasible"]] for name in ("dp", "fsdp")}
    if not trialled["dp"] or not trialled["fsdp"]:
        raise AssertionError(f"15c: feasible trials {trialled}, want dp and fsdp")
    techs = {id(s.executor): s.executor for s in task.strategies.values() if s.feasible}
    techs = list(techs.values())
    reset_counts(flash, ce)
    marks = [(len(t.intervals), len(t.discarded)) for t in techs]
    t0 = time.perf_counter()
    with VerifiedSources(analysis) as verified, EnvSet(**MD_SEARCH_ENV):
        out = sat.orchestrate([task], interval=task.strategies[2].runtime / 2, topology=topo,
                              fusion=False)
    run_s = time.perf_counter() - t0
    launches = counts(flash, ce)
    step = ckpt.saved_step(task.ckpt_path)
    if out["completed"] != [task.name] or step != FSDP_SEARCH_BATCHES or not verified.sources:
        raise AssertionError(f"15c: {out}, step {step}, verified {verified.sources}")
    runs = [dict(r, technique=t.name) for t, (i, d) in zip(techs, marks)
            for r in t.intervals[i:] + t.discarded[d:]]
    check_launches("15c", launches, fsdp_want_launches(runs, FSDP_LAYERS))
    ran = sorted({(r["technique"], r["replicas"]) for r in runs})
    log(f"  15c search: GPT-2-small at {FSDP_LAYERS} layers over [card 0] * 2, dp and fsdp "
        f"registered: each lane's fastest (size, config, s/batch) {trialled}, "
        f"{search_s:.1f}s; the plan "
        f"ran (technique, positions) {ran} to step {step}, verified, launches {launches} "
        f"(exact), {run_s:.1f}s  [{card}]")
    task.release_live_state()
    task.release_compiled()
    return launches, {"trialled": trialled, "ran": ran, "search_s": search_s, "run_s": run_s,
                      "launches": launches}


def fsdp_elastic_phase(sat, flash, ce, card) -> tuple:
    """15c-2: an fsdp task on both positions of [card 0] * 2 loses position
    1, with no return, during interval 1 (14c's seeded schedule); size 1 is
    synthesized and its sharded state restored onto one position from the
    manifest. The restoring interval's first loss is bitwise one eager step
    from a copy of that checkpoint (the unfaulted run's)."""
    import glob

    from saturn_tpu_torch import analysis
    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.parallel.fsdp import FSDP
    from saturn_tpu_torch.resilience import FaultInjector, seeded_schedule
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import metrics

    topo = SliceTopology(md_devices(2))
    save_dir = os.path.join(CKPTS, "fsdp_elastic")
    copy_dir = os.path.join(CKPTS, "fsdp_elastic_first")
    # 15c-1's cache: the drill's task has that task's signature, so its
    # search is a cache hit
    cache_dir = os.path.join(OUT, "fsdp_profile_cache")
    events = os.path.join(OUT, "fsdp_elastic_events.jsonl")
    if os.path.exists(events):
        os.unlink(events)
    schedule = seeded_schedule(FSDP_ELASTIC_SEED, 3, 2, **MD_PREEMPT_ONLY)
    if [(e.at_interval, e.kind, e.devices) for e in schedule] != [(1, "slice_preemption", (1,))]:
        raise AssertionError(f"15c: seeded schedule {schedule}")
    task = lm_task(sat, "fsdp-elastic", 6e-4, FSDP_ELASTIC_BATCHES, save_dir,
                   n_layers=FSDP_LAYERS)
    task.chip_range = [2]  # profiled at 2 positions only: the replanner synthesizes size 1
    with EnvSet(**MD_SEARCH_ENV):
        sat.search([task], technique_names=["fsdp"], topology=topo, profile_cache=cache_dir,
                   fusion=False)
    strat = task.strategies[2]
    tech = strat.executor
    interval = strat.runtime / 3
    os.makedirs(copy_dir, exist_ok=True)

    def keep_first(stem, path):
        # the first publication, which the restore after the loss reads
        if stem == task.name and not os.listdir(copy_dir):
            for f in [path] + glob.glob(glob.escape(path) + ".g*.npz"):
                shutil.copy(f, copy_dir)

    reset_counts(flash, ce)
    marks = (len(tech.intervals), len(tech.discarded))
    ckpt.add_publish_hook(keep_first)
    t0 = time.perf_counter()
    try:
        with VerifiedSources(analysis) as verified:
            out = sat.orchestrate([task], interval=interval, topology=topo, fusion=False,
                                  fault_injector=FaultInjector(schedule=schedule),
                                  failure_policy="retry", max_task_retries=1,
                                  metrics_path=events)
    finally:
        ckpt.remove_publish_hook(keep_first)
    run_s = time.perf_counter() - t0
    launches = counts(flash, ce)
    if out["completed"] != [task.name] or out["failed"]:
        raise AssertionError(f"15c drill: {out}")
    step = ckpt.saved_step(task.ckpt_path)
    if step != FSDP_ELASTIC_BATCHES:
        raise AssertionError(f"15c drill: checkpoint step {step}, want {FSDP_ELASTIC_BATCHES}")
    ev = metrics.read_events(events)

    def kinds(kind):
        return [e for e in ev if e["kind"] == kind]

    changes = [(c["change"], c["lost"], c["gained"]) for c in kinds("topology_change")]
    migrations = [(m["moved_from"], m["moved_to"]) for m in kinds("migration")]
    if changes != [("shrink", [1], [])] or migrations != [([2, 0], [1, 0])]:
        raise AssertionError(f"15c drill: topology changes {changes}, migrations {migrations}")
    if "migration-replan" not in verified.sources:
        raise AssertionError(f"15c drill: verified plans {verified.sources}")
    discarded = [r for r in tech.discarded[marks[1]:] if r["discarded"] == "preempted"]
    runs = tech.intervals[marks[0]:]
    after = [r for r in runs if r["replicas"] == 1]
    if not discarded or not after or not after[0]["restored"]:
        shape = [(r["replicas"], r["n"], r["restored"]) for r in runs]
        raise AssertionError(f"15c drill: runs {shape}, discarded {discarded}")
    check_launches("15c drill", launches,
                   fsdp_want_launches([dict(r, technique="fsdp")
                                       for r in runs + tech.discarded[marks[1]:]],
                                      FSDP_LAYERS))
    # the unfaulted run's first step from the checkpoint the restore read
    first = os.path.join(copy_dir, os.path.basename(task.ckpt_path))
    start = ckpt.saved_step(first)
    ref_tech = FSDP()
    bundle = ref_tech.build(task, md_devices(1), dict(after[0]["config"]))
    state = ckpt.restore_sharded(first, bundle.empty())
    _, loss = bundle.step(state, bundle.stage(task.batch_at(task.cursor_for_step(start))))
    want = float(loss)
    del state
    ref_tech.release_task(task.name)
    if after[0]["first_loss"] != want:
        raise AssertionError(f"15c drill: the restoring interval's first loss "
                             f"{after[0]['first_loss']} against {want} from step {start}")
    lost_s = sum(r["state_s"] + r["run_s"] for r in discarded)
    latency = kinds("recovery")[0]["replan_latency_s"]
    shutil.rmtree(copy_dir, ignore_errors=True)
    log(f"  15c drill: fsdp {strat.params} at 2 positions, seeded_schedule("
        f"{FSDP_ELASTIC_SEED}) = {schedule[0]}; interval {interval:.3f}s; runs (positions, "
        f"batches, restored) {[(r['replicas'], r['n'], r['restored']) for r in runs]}; "
        f"discarded {[(r['replicas'], r['n']) for r in discarded]} ({lost_s:.3f}s of work); "
        f"the 2-position sharded state restored onto one position from the manifest (step "
        f"{start}), first loss {want:.6f} bitwise the unfaulted run's; replan_latency_s "
        f"{latency:.6f}; step {step}; launches {launches} (exact); {run_s:.1f}s  [{card}]")
    task.release_live_state()
    task.release_compiled()
    return launches, {"schedule": str(schedule[0]), "interval_s": interval, "start": start,
                      "first_loss": want, "discarded_s": lost_s, "replan_latency_s": latency,
                      "run_s": run_s, "launches": launches,
                      "runs": [(r["replicas"], r["n"], r["restored"]) for r in runs]}


def nccl_check(card) -> dict:
    """15d: ``BlockReducer.all_gather`` and ``reduce_scatter`` across cards
    0 and 1 through NCCL against their plain versions (exact: a gather is a
    copy, a sum of two terms rounds once either way)."""
    from saturn_tpu_torch.parallel.collectives import BlockReducer

    devices = md_devices(2, distinct=True)
    red = BlockReducer(devices)
    g = torch.Generator().manual_seed(15)
    full = torch.randn(768, 2304, generator=g)
    parts = [torch.randn(768, 2304, generator=g) for _ in devices]
    out = {}
    for d in (0, 1):
        exts = [tuple((0, s) if i != d else (r * s // 2, (r + 1) * s // 2)
                      for i, s in enumerate(full.shape)) for r in range(2)]
        sl = [tuple(slice(a, b) for a, b in e) for e in exts]
        fulls = [torch.empty_like(full, device=dev) for dev in devices]
        red.all_gather([full[s].contiguous().to(dev) for s, dev in zip(sl, devices)], fulls, exts)
        gathered = all(torch.equal(f.cpu(), full) for f in fulls)
        shards = [torch.empty(full[s].shape, device=dev) for s, dev in zip(sl, devices)]
        red.reduce_scatter([p.to(dev) for p, dev in zip(parts, devices)], shards, exts)
        want = parts[0] + parts[1]
        scattered = all(torch.equal(sh.cpu(), want[s]) for sh, s in zip(shards, sl))
        if not (gathered and scattered):
            raise AssertionError(f"15d: dimension {d}: gather {gathered}, reduce-scatter "
                                 f"{scattered}")
        out[f"dim{d}"] = True
    log(f"  15d: NCCL all_gather and reduce_scatter across cards 0 and 1 equal their plain "
        f"versions (split along dimension 0 and 1)  [{card}]")
    return out


def fsdp_phase(sat, flash, ce, card, parts=("15a", "15b", "15c", "15d"),
               keep=None) -> tuple:
    """Phase 15: the sharded train state on one card (positions that name
    card 0 twice): 15a fsdp against dp at full width, 15b the manifest,
    15c search -> orchestrate with dp and fsdp and the loss drill; 15d NCCL
    across two cards, where the machine has them. ``keep`` (a dict) gets
    15a's dp and ZeRO-3 runs, their losses and parameters, and its ms a
    batch and peak memory, which 16a compares tp with."""
    t_phase = time.perf_counter()
    sat.library.register_default_library()
    launches, out = dict.fromkeys(KERNEL_NAMES, 0), {}
    log(f"phase 15: sharded train state ({', '.join(parts)})")
    ref = None
    if "15a" in parts or "15b" in parts:
        t0 = time.perf_counter()
        out["15a"], ref = fsdp_step_check(sat, flash, ce, card, md_devices(2), "15a")
        out["15a"]["seconds"] = time.perf_counter() - t0
    if "15b" in parts:
        t0 = time.perf_counter()
        out["15b"] = fsdp_manifest_check(sat, flash, ce, card, ref)
        out["15b"]["seconds"] = time.perf_counter() - t0
    elif ref is not None:
        ref["tech"].release_task(ref["task"].name)
    if keep is not None and ref is not None:
        keep["dp"] = {k: ref[k] for k in ("losses", "params", "ms_per_batch", "peak_bytes",
                                          "eager", "window", "graphed")}
        keep["zero3"] = ref["zero3"]
        keep["ms_peak"] = out["15a"]["ms_peak"]
    ref = None
    torch.cuda.empty_cache()
    if "15c" in parts:
        t0 = time.perf_counter()
        got, out["15c"] = fsdp_search_phase(sat, flash, ce, card)
        launches = {n: launches[n] + got[n] for n in KERNEL_NAMES}
        got, out["15c"]["drill"] = fsdp_elastic_phase(sat, flash, ce, card)
        launches = {n: launches[n] + got[n] for n in KERNEL_NAMES}
        out["15c"]["seconds"] = time.perf_counter() - t0
    if "15d" in parts:
        cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
        if cards >= 2:
            out["15d"] = nccl_check(card)
            out["15d"]["step"], ref = fsdp_step_check(sat, flash, ce, card,
                                                      md_devices(2, distinct=True), "15d")
            ref["tech"].release_task(ref["task"].name)
            ref = None
        else:
            out["15d"] = {"ran": False, "why": f"{cards} CUDA device(s); NCCL across two "
                                                f"cards needs two"}
            log(f"  15d did not run: this machine has {cards} CUDA device(s), and NCCL's "
                f"gather and reduce-scatter across distinct cards need two (not a pass)")
    for d in ("fsdp", "fsdp_search", "fsdp_elastic"):
        shutil.rmtree(os.path.join(CKPTS, d), ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15 {out['seconds']:.1f}s  [{card}]")
    return launches, out


# ----------------------------------------------------------------- phase 16
TP_CONFIG = {"tp": 2, "remat": False, "zero": False, "attention": "flash"}
TP_OVERLAP = {"tp": 2, "remat": False, "zero": True, "overlap": True, "attention": "flash"}
TP_ZERO = {"tp": 2, "remat": False, "zero": True, "attention": "flash"}
TP_LAYERS = 4            # 16b and 16c's depth
TP_SEARCH_BATCHES = 16


def tp_extents_held(state, cfg) -> list:
    """Where a position holds other than its extents: the split leaves of
    every position at their shard shapes (qkv's column block in
    ``shards``, the whole qkv its gather buffer)."""
    from saturn_tpu_torch.parallel.spmd_base import replicas

    reps = replicas(state)
    tp = state["placement"]["mesh_axes"]["model"]
    D, F, V = cfg.d_model, cfg.ff_dim, cfg.vocab_size
    qkv = D + 2 * cfg.kv_heads * cfg.head_dim
    want = {"wte": (V // tp, D), "mlp_in.weight": (F // tp, D), "mlp_in.bias": (F // tp,),
            "attn_out.weight": (D, D // tp), "mlp_out.weight": (D, F // tp)}
    bad = []
    for r, rep in enumerate(reps):
        named = dict(rep["params"].named_parameters())
        for name, p in named.items():
            key = name.split(".", 2)[-1] if name.startswith("blocks.") else name
            if key in want and tuple(p.shape) != want[key]:
                bad.append((r, name, tuple(p.shape)))
        for k in range(cfg.n_layers):
            shard = rep["shards"][f"blocks.{k}.qkv.weight"]
            if tuple(shard.shape) != (qkv // tp, D):
                bad.append((r, f"blocks.{k}.qkv shard", tuple(shard.shape)))
    return bad


def tp_replicated_equal(state) -> list:
    """The replicated leaves (held whole, not in ``shards``) that differ in
    a bit between position 0 and another position."""
    from saturn_tpu_torch.parallel.spmd_base import replicas

    reps = replicas(state)
    first = dict(reps[0]["params"].named_parameters())
    return [name for rep in reps[1:] for name, p in rep["params"].named_parameters()
            if name not in rep["shards"] and not torch.equal(first[name], p.to(first[name].device))]


def tp_step_check(sat, flash, ce, card, devices, label: str, from15=None) -> dict:
    """16a / 16d: tp at full width against dp over the logits on the same
    block (15a's route): the losses and parameters within the fused
    stack's bounds (the row-parallel sums reassociate), the replicated
    leaves bitwise across the positions, the split ones at their shard
    shapes, each flash launch on H / tp heads, no CE launch, no
    device-to-host copy; and tp's overlap config bitwise fsdp's ZeRO-3
    program at tp 2 x data 1 (the same program). ``from15``: 15a's dp and
    ZeRO-3 runs on this block (``fsdp_phase``'s ``keep``), compared with
    and printed beside; without it both run here."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.fsdp import FSDP
    from saturn_tpu_torch.parallel.tp import TensorParallel

    # the overlap config at tp 2 x data 1 and fsdp's ZeRO-3 program must
    # name one step: 15a's run stands in for the latter in the whole script
    same = {k: v for k, v in TP_OVERLAP.items() if k not in ("tp", "zero")}
    if same != {k: v for k, v in FSDP_OVERLAP.items() if k != "offload"}:
        raise AssertionError(f"{label}: TP_OVERLAP {TP_OVERLAP} is not FSDP_OVERLAP "
                             f"{FSDP_OVERLAP}'s program")
    n = len(devices)
    if from15:
        ref, zero3 = from15["dp"], from15["zero3"]
    else:
        dp = DataParallel()
        dp.fused_loss_shardable = False  # the logits route, as tp's
        ref = fsdp_run(sat, flash, ce, dp, devices, {"attention": "flash", "remat": False},
                       f"{label}-dp")
        zero3 = fsdp_run(sat, flash, ce, FSDP(), devices, FSDP_OVERLAP, f"{label}-fsdp-zero3",
                         dtoh=False)
    heads = []
    real = flash.flash_attention

    def spy(q, k, v, **kw):
        heads.append(int(q.shape[1]))
        return real(q, k, v, **kw)

    flash.flash_attention = spy
    try:
        got = fsdp_run(sat, flash, ce, TensorParallel(), devices, TP_CONFIG, f"{label}-tp",
                       keep=True)
    finally:
        flash.flash_attention = real
    task, bundle, state = got.pop("task"), got.pop("bundle"), got.pop("state")
    cfg = task.get_model().config
    shapes = tp_extents_held(state, cfg)
    differing = tp_replicated_equal(state)
    batch = bundle.stage(task.batch_at(0))
    got["dtoh_per_step"] = dtoh_copies(lambda: bundle.step(state, batch))
    del batch, state
    got.pop("tech").release_task(task.name)
    torch.cuda.empty_cache()
    runs = {"tp": got,
            "tp-overlap": fsdp_run(sat, flash, ce, TensorParallel(), devices, TP_OVERLAP,
                                   f"{label}-tp-overlap", dtoh=False),
            "fsdp-zero3": zero3}
    want = {name: (LAYERS * n if name in FLASH_NAMES else 0) for name in KERNEL_NAMES}
    for name, run in [("dp", ref)] + list(runs.items()):
        if run["eager"] != want or run["window"] != {k: WINDOW * v for k, v in want.items()}:
            raise AssertionError(f"{label} {name}: launches {run['eager']} / {run['window']}, "
                                 f"want {want} a step")
        if run.get("dtoh_per_step"):
            raise AssertionError(f"{label} {name}: {run['dtoh_per_step']} device-to-host "
                                 f"copies a step")
    per_head = cfg.n_heads // TP_CONFIG["tp"]
    if not heads or set(heads) != {per_head}:
        raise AssertionError(f"{label}: flash launched on {sorted(set(heads))} heads, want "
                             f"{per_head}")
    if shapes or differing:
        raise AssertionError(f"{label}: positions off their extents {shapes[:4]}, replicated "
                             f"leaves differing {differing[:4]}")
    loss_rel = max(rel(a, b) for a, b in zip(got["losses"], ref["losses"]))
    names = sorted(ref["params"])
    a = torch.cat([ref["params"][k].float().reshape(-1) for k in names])
    b = torch.cat([got["params"][k].float().reshape(-1).to(a.device) for k in names])
    param_rel = float((b - a).norm() / a.norm())
    if not (np.isfinite(got["losses"]).all() and loss_rel <= MD_LOSS_REL
            and param_rel <= MD_PARAM_REL):
        raise AssertionError(f"{label}: tp losses {got['losses']} against dp's {ref['losses']}: "
                             f"rel {loss_rel:.3e} (bound {MD_LOSS_REL:g}), parameters rel norm "
                             f"{param_rel:.3e} (bound {MD_PARAM_REL:g})")
    ov, z3 = runs["tp-overlap"], runs["fsdp-zero3"]
    if ov["losses"] != z3["losses"] or same_params(z3["params"], ov["params"]):
        raise AssertionError(f"{label}: tp's overlap config {ov['losses']} against fsdp's "
                             f"ZeRO-3 program {z3['losses']}, differing parameters "
                             f"{same_params(z3['params'], ov['params'])[:4]}")
    times = {name: (run["ms_per_batch"], run["peak_bytes"] / 2**30)
             for name, run in [("dp", ref)] + list(runs.items())}
    before = (from15 or {}).get("ms_peak")
    log(f"  {label}: GPT-2-small b{BATCH}x{SEQ} on {[str(d) for d in devices]}, flash, tp "
        f"{TP_CONFIG['tp']} x data {n // TP_CONFIG['tp']}: {len(got['losses'])} losses rel "
        f"{loss_rel:.2e} of dp's over the logits (bound {MD_LOSS_REL:g}), parameters rel norm "
        f"{param_rel:.2e} (bound {MD_PARAM_REL:g}); the row-parallel partial products bf16, "
        f"their model-group sum and the bias add fp32; replicated leaves bitwise across the "
        f"positions, split leaves at their shard shapes; each flash launch on {per_head} of "
        f"{cfg.n_heads} heads; launches {want} a step, 0 CE; {got['dtoh_per_step']:g} "
        f"device-to-host copies a step; the overlap config bitwise fsdp's ZeRO-3 program"
        f"{' (15a' + chr(39) + 's runs of dp and of it)' if from15 else ''}; ms/"
        f"batch and peak GiB above the card's holdings "
        + ", ".join(f"{k} {ms:.2f} / {gib:.2f}" for k, (ms, gib) in times.items())
        + ("" if not before else "; 15a's " + ", ".join(
            f"{k} {ms:.2f} / {gib:.2f}" for k, (ms, gib) in before.items()
            if k not in ("dp", "zero3-prefetch")))
        + f"  [{card}]")
    torch.cuda.empty_cache()
    return {"runs": {k: {kk: v for kk, v in run.items() if kk != "params"}
                     for k, run in runs.items()},
            "dp": {k: ref[k] for k in ("losses", "ms_per_batch", "peak_bytes", "eager", "window",
                                       "graphed")},
            "loss_rel": loss_rel, "param_rel": param_rel, "heads": per_head,
            "ms_peak": times, "ms_peak_15a": before}


def tp_manifest_check(sat, flash, ce, card) -> dict:
    """16b: a tp 2 x data 2 state with ``zero`` (attn_out's kernel split
    over both axes) on [card 0] * 4 at TP_LAYERS, two steps, written as a
    manifest; restored under dp at one position and fsdp at two, every
    parameter bitwise the written one, and one more step under each."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.fsdp import FSDP
    from saturn_tpu_torch.parallel.tp import TensorParallel
    from saturn_tpu_torch.utils import checkpoint as ckpt

    task = lm_task(sat, "tp-manifest", 6e-4, 8, os.path.join(CKPTS, "tp"), n_layers=TP_LAYERS)
    tech = TensorParallel()
    bundle = tech.build(task, md_devices(4), TP_ZERO)
    state = bundle.init()
    losses = []
    for i in range(2):
        state, loss = bundle.step(state, bundle.stage(task.batch_at(i)))
        losses.append(float(loss))
    specs = state["placement"]["specs"]
    two_d = [k for k, v in specs.items() if "model" in str(v) and "data" in str(v)]
    if not two_d:
        raise AssertionError(f"16b: no leaf split over both axes in {sorted(specs)[:4]}...")
    want = flat_full(state)
    path = task.ckpt_path
    t0 = time.perf_counter()
    ckpt.save(path, state)
    save_s = time.perf_counter() - t0
    del state
    tech.release_task(task.name)
    if not ckpt.verify(path):
        raise AssertionError("16b: the manifest does not verify")
    first = {}
    for name, other, n, config in (("dp-1", DataParallel(), 1,
                                    {"attention": "flash", "remat": False}),
                                   ("fsdp-2", FSDP(), 2, FSDP_CONFIG)):
        b = other.build(task, md_devices(n), config)
        got = ckpt.restore_sharded(path, b.empty())
        if got["step"] != 2 or same_params(want, flat_full(got)):
            raise AssertionError(f"16b {name}: the restored state differs from the saved one "
                                 f"{same_params(want, flat_full(got))[:4]}")
        got, loss = b.step(got, b.stage(task.batch_at(2)))
        first[name] = float(loss)
        del got
        other.release_task(task.name)
    if not all(np.isfinite(v) for v in first.values()):
        raise AssertionError(f"16b: first losses after the restores {first}")
    torch.cuda.empty_cache()
    log(f"  16b: tp 2 x data 2 with zero on [card 0] * 4 at {TP_LAYERS} layers, losses "
        f"{losses}; {len(two_d)} leaves split over both axes ({two_d[0]}); the manifest "
        f"{dir_bytes(path) / 1e9:.3f} GB written in {save_s:.2f}s, verify True; restored "
        f"bitwise under dp at 1 and fsdp at 2, first loss after each "
        + ", ".join(f"{k} {v:.6f}" for k, v in first.items()) + f"  [{card}]")
    return {"losses": losses, "two_d": len(two_d), "save_s": save_s, "first_losses": first}


def tp_search_phase(sat, flash, ce, card) -> tuple:
    """16c: search of a GPT-2-small task at TP_LAYERS with dp, fsdp and tp
    over [card 0] * 2 (trials one step at a time; 15c's profile cache, so
    where phase 15 ran only tp's trials run), then orchestrate of its plan
    to the budget, verified, launches exact."""
    from saturn_tpu_torch import analysis
    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.utils import checkpoint as ckpt
    from saturn_tpu_torch.utils import metrics

    topo = SliceTopology(md_devices(2))
    cache_dir = os.path.join(OUT, "fsdp_profile_cache")
    events = os.path.join(OUT, "tp_search_events.jsonl")
    if os.path.exists(events):
        os.unlink(events)
    task = lm_task(sat, "tp-search", 6e-4, TP_SEARCH_BATCHES, os.path.join(CKPTS, "tp_search"),
                   n_layers=TP_LAYERS)
    task.chip_range = [2]
    t0 = time.perf_counter()
    with EnvSet(**MD_SEARCH_ENV):
        sat.search([task], technique_names=["dp", "fsdp", "tp"], topology=topo,
                   profile_cache=cache_dir, metrics_path=events, fusion=False)
    search_s = time.perf_counter() - t0
    ev = metrics.read_events(events)
    trials = [e for e in ev if e["kind"] == "trial"]
    hits = {e["technique"] for e in ev if e["kind"] == "profile_cache" and e["hit"]}
    lanes = {e["technique"] for e in trials} | hits
    tp_trials = [(e["params"], e["per_batch_s"]) for e in trials
                 if e["technique"] == "tp" and e["feasible"]]
    if lanes != {"dp", "fsdp", "tp"} or not tp_trials:
        raise AssertionError(f"16c: lanes {lanes} (cache hits {hits}), tp's feasible trials "
                             f"{tp_trials}")
    techs = list({id(s.executor): s.executor for s in task.strategies.values()
                  if s.feasible}.values())
    reset_counts(flash, ce)
    marks = [(len(t.intervals), len(t.discarded)) for t in techs]
    t0 = time.perf_counter()
    with VerifiedSources(analysis) as verified, EnvSet(**MD_SEARCH_ENV):
        out = sat.orchestrate([task], interval=task.strategies[2].runtime / 2, topology=topo,
                              fusion=False)
    run_s = time.perf_counter() - t0
    launches = counts(flash, ce)
    step = ckpt.saved_step(task.ckpt_path)
    if out["completed"] != [task.name] or step != TP_SEARCH_BATCHES or not verified.sources:
        raise AssertionError(f"16c: {out}, step {step}, verified {verified.sources}")
    runs = [dict(r, technique=t.name) for t, (i, d) in zip(techs, marks)
            for r in t.intervals[i:] + t.discarded[d:]]
    check_launches("16c", launches, fsdp_want_launches(runs, TP_LAYERS))
    ran = sorted({(r["technique"], r["replicas"]) for r in runs})
    fastest = min(tp_trials, key=lambda t: t[1])
    log(f"  16c search: GPT-2-small at {TP_LAYERS} layers over [card 0] * 2, dp, fsdp and tp "
        f"registered: {len(trials)} trial events, cache hits {sorted(hits)}, tp's fastest "
        f"{fastest[0]} "
        f"{fastest[1] * 1e3:.1f} ms/batch, {search_s:.1f}s; the plan ran (technique, "
        f"positions) {ran} to step {step}, verified, launches {launches} (exact), "
        f"{run_s:.1f}s  [{card}]")
    task.release_live_state()
    task.release_compiled()
    return launches, {"tp_trials": tp_trials, "hits": sorted(hits), "ran": ran,
                      "search_s": search_s,
                      "run_s": run_s, "launches": launches}


def tp_phase(sat, flash, ce, card, parts=("16a", "16b", "16c", "16d"), from15=None) -> tuple:
    """Phase 16: tensor parallelism on one card (positions that name card
    0 two and four times): 16a tp against dp at full width and its overlap
    config against fsdp's ZeRO-3 program, 16b a 2-D split state's manifest,
    16c search -> orchestrate with dp, fsdp and tp; 16d the model groups'
    NCCL sums across two cards, where the machine has them. ``from15``:
    15a's dp and ZeRO-3 runs (``fsdp_phase``'s ``keep``) for 16a."""
    t_phase = time.perf_counter()
    sat.library.register_default_library()
    launches, out = dict.fromkeys(KERNEL_NAMES, 0), {}
    log(f"phase 16: tensor parallelism ({', '.join(parts)})")
    if "16a" in parts:
        t0 = time.perf_counter()
        out["16a"] = tp_step_check(sat, flash, ce, card, md_devices(2), "16a", from15)
        out["16a"]["seconds"] = time.perf_counter() - t0
    if "16b" in parts:
        t0 = time.perf_counter()
        out["16b"] = tp_manifest_check(sat, flash, ce, card)
        out["16b"]["seconds"] = time.perf_counter() - t0
    if "16c" in parts:
        t0 = time.perf_counter()
        launches, out["16c"] = tp_search_phase(sat, flash, ce, card)
        out["16c"]["seconds"] = time.perf_counter() - t0
    if "16d" in parts:
        cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
        if cards >= 2:
            out["16d"] = tp_step_check(sat, flash, ce, card, md_devices(2, distinct=True), "16d")
        else:
            out["16d"] = {"ran": False, "why": f"{cards} CUDA device(s); the model group's "
                                                f"NCCL sums across two cards need two"}
            log(f"  16d did not run: this machine has {cards} CUDA device(s), and the model "
                f"group's NCCL sums across distinct cards need two (not a pass)")
    for d in ("tp", "tp_search"):
        shutil.rmtree(os.path.join(CKPTS, d), ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 {out['seconds']:.1f}s  [{card}]")
    return launches, out


def option(argv, name: str, default=None):
    """The value after ``name`` in ``argv``, or ``default``."""
    return argv[argv.index(name) + 1] if name in argv else default


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    root = os.path.abspath(option(argv, "--root", REPO))  # whose port: --flash-sweep only
    if root != REPO and "--flash-sweep" not in argv:
        raise SystemExit("chip_smoke: --root goes with --flash-sweep")
    sys.path.insert(0, root)
    import saturn_tpu_torch as sat
    from saturn_tpu_torch.ops import ce, flash
    from saturn_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    shutil.rmtree(CKPTS, ignore_errors=True)
    t_start = time.perf_counter()

    log("phase 1: device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; device {kind}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    sources = ("flash_attn", "linear_ce")
    cuda_build.load_all(sources)
    log(f"  built and loaded the CUDA kernels of {sources} in {time.perf_counter() - t0:.1f}s")
    for src in sources:
        report = cuda_build.build_log(src)
        with open(os.path.join(OUT, f"ptxas_{src}.log"), "w") as f:
            f.write(report)
        for line in report.splitlines():
            # advisories C7510-C7519 ("Potential Performance Loss", an injected
            # warpgroup.wait): ptxas serialized or delayed a kernel's wgmma
            if ("registers" in line or "spill" in line or "(C751" in line
                    or "Performance Loss" in line):
                log(f"    ptxas {src}: {line.strip()}")
        if root == REPO:
            check_sass(cuda_build, src)
    if "--flash-sweep" in argv:
        head_dim = option(argv, "--head-dim")
        log(f"flash sweep of the port in {root}"
            + (f", head dim {head_dim}" if head_dim else ""))
        rows = flash_sweep(flash, [row for row in SWEEP
                                   if head_dim is None or row[3] == int(head_dim)])
        name = ("flash_sweep.json" if root == REPO
                else f"flash_sweep_{os.path.basename(root)}.json")
        with open(os.path.join(OUT, name), "w") as f:
            json.dump({"card": card, "kind": kind, "root": root, "rows": rows}, f, indent=1)
        return 0
    if "--staging-ab" in argv:
        log("staging: inline against a thread")
        with open(os.path.join(OUT, "staging_ab.json"), "w") as f:
            json.dump(staging_ab(sat, card), f, indent=1)
        return 0
    if "--data" in argv:
        data = data_api_phase(sat, flash, ce, card)
        with open(os.path.join(OUT, "data.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "data": data,
                       "short_profiles": SHORT_PROFILES,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--fused-profile" in argv:
        log("where a stacked step's time goes, against four solo steps")
        with open(os.path.join(OUT, "fused_profile.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "rows": fused_profile(sat, card)}, f,
                      indent=1)
        return 0
    if "--fused" in argv:
        _, fused_out = fused_phase(sat, flash, ce, card)
        with open(os.path.join(OUT, "fused.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "fused": fused_out,
                       "seconds": time.perf_counter() - t_start}, f, indent=1, default=str)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--compile-ahead" in argv:
        _, ca_out = compile_ahead_phase(sat, flash, ce, card)
        with open(os.path.join(OUT, "compile_ahead.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "compile_ahead": ca_out,
                       "seconds": time.perf_counter() - t_start}, f, indent=1, default=str)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--twin" in argv:
        _, service_out = service_phase(sat, flash, ce, card)  # 13b replays 12a's journal
        twin_out = twin_phase(card, service_out)
        with open(os.path.join(OUT, "twin.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "twin": twin_out,
                       "seconds": time.perf_counter() - t_start}, f, indent=1, default=str)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--gateway" in argv:
        _, gateway_out = gateway_phase(sat, flash, ce, card)
        with open(os.path.join(OUT, "gateway.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "gateway": gateway_out,
                       "seconds": time.perf_counter() - t_start}, f, indent=1, default=str)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--service" in argv:
        _, service_out = service_phase(sat, flash, ce, card)
        with open(os.path.join(OUT, "service.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "service": service_out,
                       "seconds": time.perf_counter() - t_start}, f, indent=1, default=str)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--faults" in argv:
        _, faults_out = faults_phase(sat, flash, ce, card)
        with open(os.path.join(OUT, "faults.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "faults": faults_out,
                       "seconds": time.perf_counter() - t_start}, f, indent=1, default=str)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--multi-device" in argv:
        parts = tuple(p for p in ("14a", "14b", "14c", "14d") if f"--{p}" in argv)
        _, md_out = multi_device_phase(sat, flash, ce, card,
                                       parts or ("14a", "14b", "14c", "14d"))
        with open(os.path.join(OUT, "multi_device.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "multi_device": md_out,
                       "seconds": time.perf_counter() - t_start}, f, indent=1, default=str)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--fsdp" in argv:
        parts = tuple(p for p in ("15a", "15b", "15c", "15d") if f"--{p}" in argv)
        _, fsdp_out = fsdp_phase(sat, flash, ce, card, parts or ("15a", "15b", "15c", "15d"))
        with open(os.path.join(OUT, "fsdp.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "fsdp": fsdp_out,
                       "seconds": time.perf_counter() - t_start}, f, indent=1, default=str)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--tp" in argv:
        parts = tuple(p for p in ("16a", "16b", "16c", "16d") if f"--{p}" in argv)
        _, tp_out = tp_phase(sat, flash, ce, card, parts or ("16a", "16b", "16c", "16d"))
        with open(os.path.join(OUT, "tp.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "tp": tp_out,
                       "seconds": time.perf_counter() - t_start}, f, indent=1, default=str)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0
    if "--offload" in argv:
        log("the flash kernels at head dim 256 (phase 8b's attention)")
        rows_d256 = check_head_dim_256(flash)
        offload = offload_phase(sat, flash, ce, card)
        with open(os.path.join(OUT, "offload.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "kernel_rows_d256": rows_d256,
                       "offload": offload,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0

    log("phase 2: kernels against their plain versions")
    main_shape = (BATCH, 12, 12, SEQ, 64)
    rows = check_kernels(flash, main_shape, True, 0, timed=True)
    check_kernels(flash, (2, 32, 4, 1024, 64), True, 1, timed=False)
    check_kernels(flash, main_shape, False, 2, timed=False)  # BERT-base's shape
    for seed, shape in enumerate(((BATCH, 12, 12, 64, 64), (4, 12, 12, 320, 64),
                                  (2, 8, 2, SEQ, 128), (4, 16, 4, 2048, 128)), start=10):
        for causal in (True, False):
            check_kernels(flash, shape, causal, seed, timed=False)
    N, D = BATCH * SEQ, 768
    rows.update(check_ce(ce, N, D, VOCAB, True, 3, 0, timed=True))
    recompute = check_ce(ce, N, D, VOCAB, False, 4, 0, timed=True)
    recompute["ce_ds"] = check_ds(ce, N, D, VOCAB, 9, timed=True)
    check_ce(ce, 4000, D, 50257, True, 5, 64, timed=False)
    check_ce(ce, 4000, D, 50257, False, 8, 64, timed=False)
    # the other widths of the dx and dW kernels in both modes: D tiles of 256 and of 64
    for stash in (True, False):
        check_ce(ce, N, 1024, VOCAB, stash, 6, 0, timed=False)
        check_ce(ce, 4000, 64, 50257, stash, 7, 64, timed=False)
    # recompute over 5 slabs, the last ragged, and N that no token tile divides
    check_ce(ce, 6000, D, 50257, False, 11, 64, timed=False)
    check_ds(ce, 6000, D, 50257, 12, timed=False)
    # the shapes of phase 4's b8 x 1024 run: its CE head in recompute mode at N 8192, its
    # flash kernels at T 1024
    check_ce(ce, BATCH * LONG_SEQ, D, VOCAB, False, 13, 0, timed=False)
    check_ds(ce, BATCH * LONG_SEQ, D, VOCAB, 14, timed=False)
    check_kernels(flash, (BATCH, 12, 12, LONG_SEQ, 64), True, 15, timed=False)
    # GPT-J-6B's attention (phase 8b): head dim 256
    rows_d256 = check_head_dim_256(flash)
    torch.cuda.empty_cache()

    phase_s = {"1-2": time.perf_counter() - t_start}

    def mark(label: str) -> None:
        """The seconds since the previous mark, under ``label``."""
        phase_s[label] = time.perf_counter() - t_start - sum(phase_s.values())

    log("phase 3: search -> orchestrate, two GPT-2-small tasks and one BERT-base task b8x512")
    launches, main_results = main_path(sat, flash, ce, card)
    mark("3")

    # phase 14 runs here, before the phases that write the most to the disk
    md_launches, md_out = multi_device_phase(sat, flash, ce, card)
    mark("14")
    launches = {n: launches[n] + md_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3, 14b and 14c: {launches}")
    with open(os.path.join(OUT, "multi_device.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "multi_device": md_out}, f, indent=1,
                  default=str)

    from15 = {}
    fsdp_launches, fsdp_out = fsdp_phase(sat, flash, ce, card, keep=from15)
    mark("15")
    launches = {n: launches[n] + fsdp_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3, 14b, 14c and 15c: {launches}")
    with open(os.path.join(OUT, "fsdp.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "fsdp": fsdp_out}, f, indent=1, default=str)

    tp_launches, tp_out = tp_phase(sat, flash, ce, card, from15=from15)
    from15 = None
    mark("16")
    launches = {n: launches[n] + tp_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3, 14b, 14c, 15c and 16c: {launches}")
    with open(os.path.join(OUT, "tp.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "tp": tp_out}, f, indent=1, default=str)

    log("phase 4: the kernels on the training path (dp execute, pinned)")
    pinned = pinned_runs(sat, flash, ce, card)
    pinned[f"b{BATCH}x{LONG_SEQ}"] = long_context_runs(sat, flash, ce, card)
    mark("4")

    log("phase 5: where a step's time goes (pinned configs)")
    step_profile = profile_steps(sat, card)
    step_profile["flash-windows"] = profile_windows(sat, card)
    step_profile[f"flash-{LONG_SEQ}-windows"] = profile_windows(
        sat, card, label=f"flash-{LONG_SEQ}", seq=LONG_SEQ, compare_optimizers=False)
    mark("5")

    log("phase 6: a sweep past milp_task_limit, 13 GPT-2-small tasks b8x512, defaults")
    sweep_launches, sweep = sweep_phase(sat, flash, ce, card)
    mark("6")
    launches = {n: launches[n] + sweep_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3, 14, 15, 16 and 6: {launches}")

    log(f"phase 7: kill-replay of a two-task GPT-2-small sweep b8x512 at "
        f"{min(KILL_LAYERS, LAYERS)} of its {LAYERS} layers (resume_dir)")
    kill_replay = kill_replay_phase(sat, flash, ce, card)
    shutil.rmtree(CKPTS, ignore_errors=True)
    mark("7")

    offload = offload_phase(sat, flash, ce, card)
    shutil.rmtree(CKPTS, ignore_errors=True)
    mark("8")

    data = data_api_phase(sat, flash, ce, card)
    shutil.rmtree(CKPTS, ignore_errors=True)
    mark("9")

    fused_launches, fused_out = fused_phase(sat, flash, ce, card)
    mark("10")
    launches = {n: launches[n] + fused_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3, 14, 15, 16, 6 and 10c: {launches}")
    shutil.rmtree(CKPTS, ignore_errors=True)

    faults_launches, faults_out = faults_phase(sat, flash, ce, card)
    mark("11")
    launches = {n: launches[n] + faults_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3, 14, 15, 6, 10c and 11: {launches}")
    shutil.rmtree(CKPTS, ignore_errors=True)

    service_launches, service_out = service_phase(sat, flash, ce, card)
    mark("12")
    launches = {n: launches[n] + service_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3, 14, 15, 6, 10c, 11 and 12a: {launches}")
    with open(os.path.join(OUT, "service.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "service": service_out}, f, indent=1,
                  default=str)
    shutil.rmtree(CKPTS, ignore_errors=True)

    gateway_launches, gateway_out = gateway_phase(sat, flash, ce, card)
    mark("12d")
    launches = {n: launches[n] + gateway_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3, 14, 15, 6, 10c, 11, 12a and 12d: {launches}")
    with open(os.path.join(OUT, "gateway.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "gateway": gateway_out}, f, indent=1,
                  default=str)
    shutil.rmtree(CKPTS, ignore_errors=True)

    ca_launches, ca_out = compile_ahead_phase(sat, flash, ce, card)
    mark("12e")
    launches = {n: launches[n] + ca_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3, 14, 15, 6, 10c, 11, 12a, 12d and 12e: {launches}")
    with open(os.path.join(OUT, "compile_ahead.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "compile_ahead": ca_out}, f, indent=1,
                  default=str)
    shutil.rmtree(CKPTS, ignore_errors=True)

    twin_out = twin_phase(card, service_out)
    mark("13")
    with open(os.path.join(OUT, "twin.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "twin": twin_out}, f, indent=1, default=str)
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    def entry(row, n_launches):
        return {"launches": n_launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    kernels = []
    for n in KERNEL_NAMES:
        k = {"name": n, "route": "cuda",
             "source": "saturn_tpu_torch/csrc/" + ("flash_attn.cu" if n in FLASH_NAMES
                                                  else "linear_ce.cu"),
             "replaces": SOURCES[n], **entry(rows[n], launches[n])}
        if n in FLASH_NAMES:
            # head dim 256 at GPT-J-6B's shape; launches: phase 8b-2's orchestrate
            k["head_dim_256"] = entry(rows_d256[n], offload["train"]["launches"][n])
        kernels.append(k)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "kernels": kernels, "kernel_rows": rows,
                   "kernel_rows_d256": rows_d256, "ce_recompute_rows": recompute, "main_path": main_results,
                   "pinned": pinned, "step_profile": step_profile, "sweep": sweep,
                   "kill_replay": kill_replay, "offload": offload, "data": data,
                   "fused": fused_out, "faults": faults_out,
                   "service": {k: service_out[k] for k in ("seconds", "interval_s")},
                   "gateway": {k: gateway_out[k] for k in ("seconds", "interval_s")},
                   "compile_ahead": {k: ca_out[k] for k in ("seconds", "interval_s")},
                   "twin": {"seconds": twin_out["seconds"]},
                   "multi_device": {"seconds": md_out["seconds"]},
                   "fsdp": {"seconds": fsdp_out["seconds"]},
                   "tp": {"seconds": tp_out["seconds"]},
                   "short_profiles": SHORT_PROFILES, "phase_s": phase_s,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"profiles short of their launch count, each taken again: {len(SHORT_PROFILES)} "
        f"{SHORT_PROFILES}")
    log(f"done in {time.perf_counter() - t_start:.1f}s; {bytes_written() / 2**30:.2f} GiB "
        f"passed to write calls")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

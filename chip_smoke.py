#!/usr/bin/env python3
"""Drive the torch port's serving and training paths on one NVIDIA card and
check them.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each fatal on failure (exit 1, and no final ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, and torch's device name;
2. build every CUDA kernel of the paths from ``automodel_tpu_torch/csrc``
   with nvcc (one process per source, all at once);
3. each kernel against its plain torch version on the card at its path's
   shapes, with times of the kernel, the plain version and a library
   yardstick, beside the least time the card could take:
   - paged attention (serving): B=16, N=32, Nkv=8, H=128, BS=16, ragged
     lengths 1..4096; Sq 1 and 5, bf16 and int8 pools, a window case, a
     soft-cap case, cases whose attention is sharp (q four times larger),
     lengths on the chunk edges of the kernel's split-KV grid (bf16 at Sq
     1, int8 at Sq 5 with the cap) and one 4096-token sequence (B=1, bf16
     and int8); and verify chunks past 32 query rows a kv head, the
     kernel's row tiles, at Qwen3-30B-A3B's 32 heads over 4 kv heads,
     ragged lengths 1..2048: Sq 5 (40 rows, bf16 and int8), Sq 8 (64) and
     Sq 20 (160), each timed; the yardstick is
     ``scaled_dot_product_attention`` over the gathered view;
   - flash attention forward, dq and dk/dv (training): B=1, S=4096, N=32,
     Nkv=8, H=128, causal; then a 1024 window, 4 packed documents,
     non-causal, H=64, S=4000, sharp attention and Nkv=4 (Qwen3's 8 q heads
     per kv head); the yardstick is
     ``scaled_dot_product_attention(..., is_causal=True, enable_gqa=True)``:
     its forward beside fwd, its backward alone beside dq + dkv (no library
     call computes dq, or dk and dv, alone); each time is printed beside
     the recorded time of K1's earlier ``mma.sync`` kernels (PERF.md) and
     the speed-up;
   - the flash kernels with Gemma 2's logits soft cap (phase 3b): B=1,
     S=8192, N=16, Nkv=8, H=256, scale 1/16, cap 50, causal and with the
     4096 window (both timed beside the earlier kernels' times; the yardstick is
     ``torch.compile`` of ``flex_attention`` with a tanh ``score_mod``,
     forward and backward apart, and SDPA without the cap beside it); the
     cap saturated (q x 64), where the plain dq with the
     cap's factor 1 - t^2 dropped must miss by more than 4x the limit (a
     planted fault); 4 packed documents; S=8000; H=256 without a cap; and
     Gemma 2 27B's heads (N=32, Nkv=16, H=128, scale 144^-0.5) with the cap;
4. the serving engine at full Llama-3-8B width (random bf16 weights from a
   seed), built by the ``serve`` CLI's own ``build_engine`` from a config
   dict: 16 greedy requests, 8 of them sharing a 512-token prefix, on a
   bf16 pool; then a profile of decode steps with every slot busy; then 8
   requests on an int8 pool. Every request must end with ``length`` or
   ``stop`` and the paged kernel must have launched once per layer per
   decode forward;
5. one decode step at full width on the fused backend (the kernel) against
   the gather backend (plain attention over the gathered view): logits
   must agree;
6. training at Llama-3-8B widths cut to 8 layers
   (``automodel_tpu_torch/configs/sft_llama3_8b.yaml``), built by the
   ``finetune`` CLI's own recipe class: 4 steps of 2 microbatches of 4096
   tokens through the flash kernels. Every loss and grad norm must be
   finite, the weights must move, and each flash kernel must have launched
   layers x microbatches x steps times; then a profile of one step;
7. one step's loss and grad norm at those widths with ``attn: flash``
   against ``attn: sdpa`` (plain attention), same weights and batch;
8. the grouped-matmul kernels (gmm, gmm with a transposed rhs, tgmm with
   an fp32 and a bf16 output) against their plain versions at
   Qwen3-30B-A3B's MoE shapes (4096 tokens routed top-8 over 128 experts:
   M = 32768 rows, hidden 2048, expert width 768): routing from a real gate
   (all six launches of a layer's forward and backward, tgmm in both
   output types, timed against the plain versions, ``torch._grouped_mm``
   and the bound of the output type written), balanced routing, skewed
   groups (empty first and last experts, one expert holding a quarter of
   the rows) and K = N = 1000; then gmm and gmm_t at gpt-oss-20b's
   recompute shapes in K3's backward (4096 tokens routed top-4 over 32
   experts by the gpt-oss gate: M = 16384, (K, N) = (2880, 5760) and
   (2880, 2880)), timed the same way. tgmm's bf16 output must equal its
   fp32 output cast to bf16 bit for bit; gmm's times are taken with the
   plan given, as the MoE layer runs it, and in each of the kernel's two
   orders of a group's items beside the one gmm picks;
9. MoE training at Qwen3-30B-A3B widths cut to 4 layers
   (``automodel_tpu_torch/configs/pretrain_qwen3_moe_a3b.yaml``), built by
   the ``pretrain`` CLI's recipe class: 4 steps of 2 microbatches of 4096
   tokens through the grouped-matmul and flash kernels. Every loss, grad
   norm and aux loss must be finite, every weight matrix and every expert
   slab that received rows must move, and each kernel must have launched
   its count; then a profile of one step;
10. one step at 1 layer of those widths and 2048 tokens with ``experts:
   ragged`` (the kernels) against ``experts: dense`` (plain torch): loss,
   grad norm and aux loss must agree;
11. flash attention with gpt-oss sinks folded around the kernels at
   GPT-OSS's attention shape (B=1, S=4096, N=64, Nkv=8, H=64, causal, a 128
   window and full): out, dq, dk, dv and d_sinks against the same fold
   around the plain versions; each kernel timed beside its bound and a
   yardstick without sinks (SDPA causal for the full layer, compiled
   ``flex_attention`` with the window's block mask for the windowed one);
12. the fused expert-MLP kernels (the forward's two launches, the gmm
   kernel with the activation in its epilogue and then with the row bias;
   bwd_gu, the backward's elementwise pass bwd_act, bwd_dwd and bwd_dx,
   bwd_gu with JAX's fp32 weight grad and the last three each called
   alone, which runs the pass inside) against their plain versions at
   gpt-oss-20b's MoE shapes (4096 tokens routed top-4 over 32 experts by a
   real gate with a learned bias: M = 16384 rows, hidden 2880, expert
   width 2880, swiglu_oai, expert biases), timed against the plain
   versions, a ``torch._grouped_mm`` composition and the bound; the
   forward's two launches also apart, beside ``torch._grouped_mm`` alone
   on each; bwd_gu and bwd_dwd (their bf16 weight grads, which must equal
   their fp32 ones cast bit for bit) and bwd_dx are timed given the pass's
   output, as the backward calls them, beside ``torch._grouped_mm`` alone
   on that operand, each called alone, the weight grads in fp32, bwd_gu's
   product and bias sums apart, and bwd_dx's product in both orders of a
   group's items; then Qwen3-30B-A3B's
   shapes (swiglu, no biases), skewed groups, inputs scaled so that ~10%
   of g and u pass the +-7 clamps, swiglu with a limit of 2, and a NaN tail
   past the groups (every weight and bias grad finite and equal to the
   clean tail's);
13. GPT-OSS training at gpt-oss-20b widths cut to 3 layers
   (``automodel_tpu_torch/configs/pretrain_gpt_oss_20b.yaml``) through the
   ``pretrain`` recipe class: 4 steps of 2 microbatches of 4096 tokens
   through the fused expert-MLP, grouped-matmul and flash kernels. Every
   loss and grad norm must be finite, every weight matrix, bias and sink and
   every expert slab that received rows must move, and each kernel must have
   launched its count (each K3 wrapper, bwd_act included, once per layer
   and microbatch; K2's tgmm wrapper none: K3b's and K3c's tgmm launches
   and K3d's gmm count in bwd_gu, bwd_dwd and bwd_dx); then a profile of
   one step;
14. one step at 1 layer of those widths and 2048 tokens with ``experts:
   ragged_fused`` against ``experts: ragged``: loss and grad norm must
   agree;
15. Gemma 2 training at gemma-2-9b widths cut to 8 layers
   (``automodel_tpu_torch/configs/pretrain_gemma2_9b.yaml``) through the
   ``pretrain`` recipe class: 4 steps of 2 microbatches of 8192 tokens
   through the flash kernels with the cap of 50 inside them (head_dim 256,
   a 4096 window on the even layers). Every loss and grad norm must be
   finite, every weight matrix must move, and each flash kernel must have
   launched 8 x 2 x 4 times; then a profile of one step;
16. one step at 2 layers of those widths (a sliding and a full layer) and
   8192 tokens with ``attn: flash`` against ``attn: sdpa``: loss and grad
   norm must agree within phase 7's limits;
17. the checkpoint round trip at Llama-3-8B widths cut to 2 layers (disk
   sets the size: ~15 GB a DCP state, ~3 GB a consolidated save), through
   the ``finetune`` recipe class: the free disk printed first; 4 steps of
   2 x 4096 tokens twice without checkpoints (the card's own run-to-run
   spread); the same config with checkpoints every 2 steps (consolidated
   HF save, keep_last_k 1) and 2 validation batches every 2 steps, stopped
   at step 2 and resumed by a fresh recipe object to step 4, whose steps 3
   and 4 must match the unbroken run (bit for bit when the two unbroken
   runs agree bit for bit, else within 4x their step-1 spread), with a
   resume record, ``val_loss`` records and ``BEST.json`` naming a
   committed dir, flash launches layers x microbatches x steps (plus a
   forward per layer and validation batch); ``verify-ckpt`` through the
   CLI's function passing on the tree; the offline consolidation of the
   step-4 dir on the card, byte-identical to its ``hf/`` save; ``from_pretrained`` of
   that ``hf/`` dir, and the ``serve`` CLI's ``build_engine`` on it, whose
   full forward must give the trained model's logits bit for bit and
   whose 4 greedy requests of 128-512 prompt tokens must end by length or
   stop with the paged kernel launched decode forwards x layers times;
   last, a hard-linked copy of the step dir with its DCP data file cut by
   one byte, which ``verify-ckpt`` must fail. The save, load and
   consolidation times and bytes are printed beside the card's name and
   power limit, and the directory is deleted;
18. the ``benchmark llm`` recipe (``recipes.benchmark.main`` on the
   ``configs/benchmark_*.yaml`` dicts), 2 warmup and 5 measured steps
   (``BENCH_STEPS_ON_CARD``, where the configs say 3 and 10) in four
   legs, each a fresh recipe: (a) Llama-3-8B widths cut to 8 layers,
   2 x 4096 tokens, with the decode leg (4 greedy prompts of 64 tokens, 64
   new tokens each) and the serving leg (16 Poisson requests at 8 a second,
   128-1024 prompt tokens, 64 new, through the paged kernel); (b)
   Qwen3-30B-A3B at 4 layers (K2); (c) gpt-oss-20b at 3 layers (K3); (d)
   gemma-2-9b at 8 layers, 2 x 8192 tokens (K1 with the cap). Each leg's
   step count, tokens a step, finite loss, an MFU in (0, 1) on the card's
   peak (found by its name), positive dispatch and device means and a
   positive peak of device memory must hold, each kernel's launches over
   the 13 steps must equal its training phase's count a step x 13, and
   leg (a)'s decode and serving legs must run (256 tokens; 16 requests,
   served with speculative decoding, a Llama-3.2-1B-width draft at k = 4,
   and again with the draft off: ``serve_draft_tps`` and both sides of
   ``serve_spec_ab`` non-null; the paged kernel launched (decode + verify
   forwards) x 8 layers + draft forwards x 16 draft layers times) with the
   spill and fleet legs naming their missing sections. Each leg's result is printed
   beside its training phase's own step time and FLOP share, and the CUDA
   runtime calls that make the host wait in one more step (torch.profiler,
   CPU side), unchecked;
19. the ``kd llm`` recipe (``recipes/kd.py``'s recipe class, as its
   ``main`` runs it, on ``configs/kd_llama3_8b_to_llama3_2_1b.yaml`` as a
   dict): first the flash kernels at the student's attention
   (Llama-3.2-1B: B=1, S=4096, N=32, Nkv=8, H=64, causal, no sinks)
   against their plain versions with phase 3's limits, timed beside the
   bound and SDPA; then 4 steps of 2 x 4096 tokens with the Llama-3-8B
   teacher (32 layers, frozen) and the Llama-3.2-1B student (16 layers),
   both at full depth, with the student at ``remat: none``, ``full`` and
   ``selective``: every loss and grad norm finite, the
   teacher's forward kernel launched 32 x 2 x 4 times (read around its
   forward), the student's 16 x 2 x 4 (twice that under ``full`` and
   ``selective``, whose recompute runs it again), dq and dkv 16 x 2 x 4
   each; the step time, tokens/s, peak memory and a profile of one more
   step printed; last, one microbatch's KD loss
   and the student's grad norm with both models cut to 2 layers, ``attn:
   flash`` against ``attn: sdpa`` within phase 7's limits;
20. speculative serving at full width
   (``automodel_tpu_torch/configs/serve_qwen3_moe_a3b_spec.yaml`` as a
   dict, through the ``serve`` CLI's ``build_engine``): the Qwen3-30B-A3B
   target at its published widths, its 48 layers cut to 24 (phase 25 took
   the time; ``experts: ragged``) and the
   Qwen3-0.6B draft (28 layers), k = 4, greedy, a bf16 pool on the fused
   backend, 16 slots. 16 token-id requests of 128-1024 prompt tokens, 8
   sharing a 512-token prefix, 64 new tokens each: (a) every request ends
   by length or stop and the block pool audits clean and drains; (b) the
   paged kernel's launches equal verify forwards x 24 + draft forwards x
   28 and gmm's 2 x 24 x the target's forwards (prefill chunks and
   verifies), each formula printed beside its count; a profile of verify
   rounds with every slot busy; (c) the same requests with the draft off,
   whose greedy streams the spec-on ones must equal or first leave at a
   near tie of the spec-off step's top two logits (within phase 5's
   limit; each printed), and one verify forward's logits through fused
   against gather within phase 5's limits; ``generate`` of 4 prompts x 32
   tokens on the same model (the contiguous cache); (d) at Llama-3-8B
   widths cut to 4 layers, a draft given the target's config and weights
   must accept at least 0.8 of its proposals, its streams held to the
   spec-off ones as in (c). Tokens/s, TTFT p50, accept rate and draft
   tokens a second (spec on and off) and the peak device memory are
   printed;
21. the serving front and the host spill tier at Llama-3-8B's published
   widths and FRONT_LAYERS (8) of its 32 layers (cut to keep the script
   inside its time limit; ``configs/serve_llama3_8b_front.yaml`` as a
   dict, random bf16 weights): (a) one slot on a 512-block bf16 pool with
   a 4 GiB host tier, 4 groups of a 2048-token prefix, each arriving 2
   times round-robin with a fresh 64-token suffix (32 new tokens, greedy),
   spill on then off: the reload counts equal those of the schedule
   replayed on the host, the allocator and tier audit clean after every
   request, the spill-on streams equal the spill-off ones up to a near tie
   of at most 3 bf16 ulps between the top two logits, extract → inject →
   extract of 128 blocks is bit-identical, and the paged kernel launched
   decode forwards x 32 times; TTFT p50, tokens/s, the tier's bytes and
   the moves' ms and GB/s printed; (b) the same on an int8 pool at 4
   groups (the scales bit-identical too); (c) the HTTP front
   (``start_http_front``: warm-up, ``serve_http``, the SIGTERM handler)
   with QoS, 32 POSTs from 8 client threads: each answered once (200, or
   429 / 503 with Retry-After), one terminal record each, ``/stats`` equal
   to the records and ``/metrics`` to ``/stats``, ``/healthz`` 200
   throughout; (d) the installed SIGTERM handler called with every slot
   busy and a queue: ``/readyz`` and a new POST 503, the queue ends
   ``draining`` (retriable), the wave finishes, ``drain_duration_s`` set;
   (e) a watchdog of 2-4 s deadlines and one decode program wrapped with
   a 6 s sleep: exactly that wave ends ``engine_stall``, one stall, the
   pool's bytes unchanged, the flight recorder and stacks written, and
   the requests after it decode the tokens they decoded before. Every
   serving phase (4, 18's leg (a), 20, 21, 22) checks that its engines
   rebuilt for no error and no unplanned stall;
22. traced serving at Llama-3-8B's published widths and FRONT_LAYERS (8)
   (phase 21's config with ``tracing: {enabled: true, sample_rate: 1.0}``,
   through ``serving.server.build_tracer`` and the HTTP front): 16 POSTs
   of 256-1024 prompt tokens and 64 new from 8 client threads, 8 of them
   carrying a ``traceparent`` header minted by a client-side tracer that
   writes its own JSONL. Each request has exactly one ``serve`` span, a
   headered one with the header's trace id and the client span as its
   parent; every child span lies inside its root within 1 ms; the port's
   ``trace`` command over both JSONLs assembles 16 traces with no orphan
   and no partial trace and writes a Chrome trace and a markdown
   waterfall; ``automodel_serve_stage_seconds``'s counts on ``/metrics``
   equal the span counts by stage; ``report --strict`` passes the serve
   JSONL; the paged kernel launched decode forwards x 32 times. The same
   requests run with tracing off too, in turns (off, on, on, off), and
   the legs' tokens/s and TTFT p50 are printed (a reading, not a claim);
23. training: (a) ``configs/sft_llama3_8b_full.yaml`` as a dict, Llama-3-8B
   at all 32 layers with bf16 Adam moments (``moments_dtype: param``) and
   ``remat: full``, 4 steps of 4096 tokens through the ``finetune`` recipe
   class: every loss finite, the peak of device memory under 79 GiB, the
   flash forward launched 32 x 4 x 2 times (the recompute runs it again),
   dq and dkv 32 x 4, ``report --strict`` passing its JSONL; step time
   from step 2, tokens/s, MFU on 989 TFLOP/s and the peak printed; (b)
   lion, sgd, adafactor and muon, each 3 steps at Llama-3-8B widths cut to
   2 layers (a constant lr each, ``OPT_LR``), every loss finite, and step 1's
   update of the held tensors (both layers' k_proj, their input norms,
   the final norm; the lm_head too but under muon, whose Newton-Schulz
   over it would take the CPU minutes) equal to the same optimizer run on
   the CPU from the same weights, grads and grad norm: at most 0.1% of
   their elements apart, none by more than 2 bf16 steps; (c)
   ``on_nonfinite: rollback`` at Llama-3.2-1B widths cut to 2 layers,
   checkpoints every 2 steps, 4 steps, a non-finite flag planted on step
   3's metrics: the run restores step 2, ends at step 4 with
   ``rollbacks_total`` 1 and the loader at batch 6 of its epoch, where
   JAX's arithmetic puts it (``tests/test_resilience.py:876-903``);
24. the data path: (a) a Megatron corpus of 2^27 uint32 tokens (512 MiB;
   documents of log-normal lengths, median 1536, 16-16,384 tokens, ids
   uniform over Llama-3's 128,256) and three nanoGPT sources of two
   2^23-token shards each, written by the port's writer
   (``data/synthetic.py``) from seeds, sizes and seconds printed; the
   index built by the native helpers (``g++``), which must have built and
   run; (b) ``configs/pretrain_llama3_8b_megatron.yaml`` as a dict,
   Llama-3-8B at DATA_PRETRAIN_LAYERS (8) of its 32 layers (cut to keep
   the script inside its time limit) on that corpus through the ``pretrain``
   recipe class, 6 steps of 4096 tokens three times: sync, with
   ``data.prefetch`` (depth 2, 2 collate workers), sync again. Every batch
   read back from the card after its step equals the host's collate and
   the sync run's bit for bit; the prefetched losses follow phase 17's
   rule against the two sync runs; the flash forward launched 16 x 6 x 2
   times a run (remat), dq and dkv 16 x 6; the peak under 79 GiB; step
   time, tokens/s, MFU on 989 TFLOP/s, the peak, ``host_input_wait_s`` and
   ``prefetch_depth`` printed for each run; (c) the corpus's documents
   packed by ``pack_sequences`` into a 4096-token row of at least 3
   documents and collated by ``packed_collater``: one step's loss and
   grad norm at Llama-3-8B widths cut to 8 layers with ``attn: flash``
   (the kernels with segment ids, 8 launches each) against ``attn: sdpa``
   (the segment mask, no launch) within phase 7's limits; the flash
   kernels on that row against their plain versions (phase 3's limits),
   timed beside the bound of the row's live pairs and SDPA with the row's
   mask; (d) the blended nanoGPT sources (weights 1, 2, 1) at Llama-3-8B
   widths cut to 2 layers with prefetch on: two unbroken 4-step runs, a
   run saved at step 2 whose next window lies in a source's second shard,
   and a fresh recipe resumed from it whose steps 3-4 (batches and losses)
   must equal the unbroken run's under phase 17's rule; its step 4 is
   flagged non-finite once under ``on_nonfinite: rollback``: the run
   restores step 2, retrains steps 3-4 on the batches past the failed
   window and ends with the loader at batch 7, where JAX's arithmetic puts
   it. The corpora and checkpoints are deleted.
25. the training run's telemetry, profiling, goodput, metrics port and
   guard, on a 2^22-token Megatron corpus: (a) phase 24's config at
   DATA_PRETRAIN_LAYERS (8), 7 steps, with every section on (the memory census every 3
   steps, a manual ``torch.profiler`` window over step 4, the cost count
   of step 1, ``metrics_server`` on a free port, the guard's defaults) and
   again with each ``enabled: false``: the losses and grad norms must be
   equal bit for bit; the on run's records carry every
   ``grad_norm/<group>``, ``grad_nonfinite_count: 0``, the ``time/*_s``
   means, ``mem_bytes_in_use`` on its cadence, ``heartbeat_age_s``,
   ``mfu_pct`` and ``mfu_measured_pct``, and the off run's none of them;
   one ``cost_attribution`` event (its FLOPs a token printed beside the
   analytic law); a ``/metrics`` scrape after each log record's fold
   shows all 23 ``automodel_train_*`` families and the last step;
   ``goodput`` on the run dir exits 0 with the segments within 5% of the
   wall clock; the step-time ratio on / off printed for plain, census and
   window steps; (b) the ``profile`` command on the same config, 2 warmup
   steps and 1 traced: the trace must hold CUDA kernel events (it fails
   with none), K1's three kernels among its top ops with 2 x 32
   forward and 32 dq and dkv launches, the busy share and the largest
   host gaps printed; (c) at 2 layers, step 1's counted FLOPs under
   ``attn: flash`` equal ``attn: sdpa``'s exactly; (d) at 2 layers,
   ``straggle_ms`` at step 6 fires a triggered capture whose trace holds
   K1's kernels beside a CUDA memory snapshot, and ``nan_grads_at_step``
   under ``on_nonfinite: skip`` logs ``nonfinite: true, skipped: true`` with
   a non-finite ``grad_norm/layers`` and a capture with reason
   ``nonfinite``; (e) two ``pretrain llm`` CLI processes at 2 layers side
   by side, beside (c) and (d): a hang after the step-2 checkpoint exits 75 within the
   watchdog's deadline plus a poll, with the stacks, a ``hang`` event and
   a flight-recorder dump; SIGTERM mid-run exits 75 with a committed
   emergency checkpoint, the restart resumes at the next step and the
   ledger holds two chained attempts, each within 5% of its wall clock.
   The run dirs are deleted.

26. parallelism: (a) phase 23's full-depth SFT config under FSDP2
   (``configs/sft_llama3_8b_fsdp.yaml``: ``distributed: {dp_shard: -1}``),
   4 steps through the ``finetune`` CLI's ``main`` in a child of
   ``python -m torch.distributed.run --nproc_per_node 1`` (a one-rank
   NCCL group; the 32 layers and the root wrapped by ``fully_shard``):
   each loss and grad norm held to phase 23's run of the config unwrapped
   (whether bit for bit is printed), K1's launches counted, step time and
   peak memory printed beside phase 23's; (b) the context-parallel ring's
   per-rank schedule at cp = 4 virtual ranks driven in this process through
   the port's own step and merge functions: Llama-3-8B's attention (N 32,
   Nkv 8, H 128, bf16, causal) at S = 32768 (8192 tokens a rank), zigzag
   and contiguous, Gemma 2's (H 256, cap 50, window 4096) and gpt-oss's (H
   64, N 64, sinks) at S = 16384 zigzag: the stitched out, lse, dq, dk and
   dv held to K1 over the whole sequence (phase 3's limits), each rank's
   K1 time and live pairs printed, and the ring through K1 held to the ring
   through the plain versions at S = 2048; (c) in the same child, ``attn:
   ring`` at cp = 1 against ``attn: flash`` at 2 layers of those widths: the
   same losses and grad norms bit for bit; then phase 28 (b)'s two runs,
   which phase 28 checks (one torchrun start fewer). The card is one device, so no
   collective crosses ranks here: NCCL across ranks is not measured.
27. DeepSeek-V3's family: (a) ``configs/pretrain_moonlight_16b_a3b.yaml``
   as a dict, Moonlight-16B-A3B's published widths (MLA with q_lora_rank
   null, 128 nope + 64 rope channels, v 128; 64 experts top-6 of width
   1408 with 2 shared, sigmoid aux-free routing; vocab 163840) cut to
   MOONLIGHT_TRAIN_LAYERS (4: the dense first and 3 MoE, where the config
   has 7), 4 steps of 2 microbatches of 4096
   tokens through the ``pretrain`` recipe class with ``attn: flash`` (K1
   at head_dim 192, v padded) and ``experts: ragged_fused`` (K3): every
   kernel's launches counted, the loss falling, each layer's correction
   bias moving, step ms, tokens/s, MFU on 989 and the peak printed; (b) K1
   at DeepSeek-V3's attention shape (B 1, S 4096, 128 heads, head_dim 192
   with v padded from 128, causal, its yarn softmax scale), with and
   without 4 packed documents, held to the plain versions (phase 3's
   limits) and timed beside the bound and SDPA; (c) at 2 of those layers
   and one 4096-token row, ``gspmd`` at a capacity factor where no pick
   drops against ``ragged_fused`` (loss, grad norm), ``gspmd`` at 1.25
   with the share of picks dropped, and the ``a2a_fused`` per-rank body at
   ep = 4 virtual ranks in this process (K3 on each rank's 16 experts)
   against ``ragged_fused`` over the row. The all-to-all across cards is
   not measured: one card.
28. the rest of MoE: (a) one MoE layer of Moonlight-16B-A3B (D 2048, 64
   experts top-6, I 1408) and one of gpt-oss-20b (D 2880, 32 experts
   top-4, I 2880, ``swiglu_oai`` with its biases) at full width, on their
   layer's real input (a 4096-token row), through ``a2a_fused`` (K3 at the
   I-shard, 704 and 1440) and ``a2a`` (K2) at ep = 2 x tp = 2 virtual
   ranks in this process (each tp rank the I-shard of its ep rank's
   experts, the down bias on tp rank 0 outside K3, the fp32 partials
   summed) against ``ragged_fused`` / ``ragged`` over the row on one rank:
   out and dx rows within 2^-6, the slabs' grad rows within 2^-10; K3's
   forward and K2's gmm timed on rank (0, 0)'s rows at each I-shard beside
   their plain versions, bounds and ``torch._grouped_mm``; (b) Moonlight
   at 3 layers, 3 steps, unwrapped and under FSDP2 at world 1 (each MoE
   layer's experts an FSDP2 unit over ``expert_fsdp``) in phase 26's
   one-rank NCCL torchrun child: losses and grad norms bit for bit, K3
   counted;
   (c) muon, then adafactor, on Moonlight at 3 layers through the recipe:
   the partition (Newton-Schulz or Adam, factored or not) printed with the
   step time and the peak, the loss falling; (d) gpt-oss-20b at 3 layers
   written from seeded weights into an MXFP4 checkpoint (``pack_mxfp4`` on
   the card) and a bf16 one of the dequantized slabs, both loaded with
   ``from_pretrained``: the logits bit for bit, the MXFP4 load's seconds
   and GB/s, one training step through K3. The collectives across cards
   are not measured: one card.

Phases 11 and 12 run right after phase 8, phases 13 and 14 after phase 10,
phase 3b right after phase 3, phases 15 to 28 last; the whole run's
seconds come last before the ``kernels`` line. After the build the
script prints ptxas's registers and spills for each flash, grouped-matmul
and paged-attention kernel, with the registers its SASS names and the
counts its ``setmaxnreg`` instructions set (flash and grouped matmul), and
fails if any of the 24 flash, 4 grouped-matmul or 18 paged-attention
instantiations spills; the flash register split read from the SASS is
printed just before the ``kernels`` line, and each flash and grouped-matmul
entry carries the readings of its instantiations.
The ``kernels`` JSON line comes third from last, the ``nvidia-smi`` card
line second, and the last line is ``{"ok": true, "device": {...}}``. It
imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM

LLAMA3_8B = dict(  # meta-llama/Meta-Llama-3-8B config.json widths
    architectures=["LlamaForCausalLM"], model_type="llama",
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
    max_position_embeddings=8192, tie_word_embeddings=False,
)
BF16 = dict(attn="sdpa", param_dtype="bfloat16", compute_dtype="bfloat16")
LLAMA3_2_1B = dict(  # meta-llama/Llama-3.2-1B config.json widths
    architectures=["LlamaForCausalLM"], model_type="llama",
    vocab_size=128256, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    head_dim=64, rope_theta=500000.0,
    rope_scaling=dict(rope_type="llama3", factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                      original_max_position_embeddings=8192),
    rms_norm_eps=1e-5, max_position_embeddings=131072, tie_word_embeddings=True,
)
MAX_NEW = 64  # generated tokens per serving request
# kernel vs plain, per output row (one query head at one position):
# |out - ref| / |ref| over the row's H channels. Both versions round an fp32
# result to bf16; an element that flips by one bf16 ulp moves by at most
# 2^-7 of itself, so a row whose elements all agree within one ulp moves by
# at most 2^-7 of its norm. A
# masking fault moves rows much further: one row dropped at a window's edge
# moves the worst row by more than 4x this limit, in near-uniform and in
# sharp attention (tests/test_torch_cuda_kernels.py::
# test_row_check_catches_one_masked_row).
KERNEL_ROW_REL_TOL = 2.0**-7
# fused vs gather logits after 32 bf16 layers: the gather path rounds
# attention probabilities to bf16 before the value product (as the JAX sdpa
# does), the kernel keeps them fp32, and each layer's bf16 rounding carries
# into the next. Limits at about 3x and 5x what three runs on an H100 read
# (max |diff| 2.06% of max |logit|, min cosine 0.99982; PERF.md).
LOGITS_REL_TOL = 0.06
LOGITS_MIN_COSINE = 0.999


# flash kernels vs plain (tests/test_torch_cuda_kernels.py holds the same
# limits): out per row as above (the kernel also rounds P to bf16 before
# P.V, ~2^-8 in a CPU emulation); dq/dk/dv per row within 2^-6 (P and dS
# rounded to bf16 before the second products, ~2^-8 emulated), a row judged
# against at least 1/8 of the tensor's RMS row norm (a row whose exact value
# cancels to ~0 holds only rounding noise); lse, fp32 in both, within 1e-3.
# Excluding the causal diagonal or cutting a 1024 window to 1023 moves the
# worst row of each past 4x its limit
# (tests/test_torch_cuda_kernels.py::test_flash_row_check_catches_an_off_by_one_mask).
FLASH_OUT_TOL = 2.0**-7
FLASH_GRAD_TOL = 2.0**-6
FLASH_GRAD_FLOOR = 0.125
FLASH_LSE_TOL = 1e-3
# The training recipe's config, automodel_tpu_torch/configs/sft_llama3_8b.yaml
# as a dict (the card has no YAML reader; tests/test_torch_cli.py checks the
# two agree): Llama-3-8B widths, depth cut to 8 layers.
SFT_LLAMA3_8B = dict(
    seed=42,
    model=dict(
        hf_config=dict(LLAMA3_8B, num_hidden_layers=8),
        backend=dict(attn="flash", param_dtype="bfloat16", compute_dtype="bfloat16"),
    ),
    dataset=dict(_target_="automodel_tpu_torch.data.sft.MockSFTDataset", vocab_size=128256,
                 seq_length=4096, num_samples=1024),
    dataloader=dict(global_batch_size=1),
    step_scheduler=dict(grad_acc_steps=1, num_epochs=1, log_every_steps=10),
    optimizer=dict(name="adamw", lr=1e-5, weight_decay=0.01, betas=[0.9, 0.95], grad_clip_norm=1.0,
                   lr_schedule=dict(style="cosine", warmup_steps=100, decay_steps=2000)),
    loss_fn=dict(name="fused_linear_ce"),
    logging=dict(metrics_path="runs/torch_sft_llama3_8b/train_metrics.jsonl"),
)
TRAIN_STEPS = 4
TRAIN_ACC = 2
# attn flash vs sdpa over one step at 8 layers (loss and fp32 grad norm,
# relative): the kernels round P and dS to bf16 where sdpa keeps the
# backward in fp32, and sdpa rounds P to bf16 before P.V where the kernel
# keeps the forward's normalisation in fp32. Limits at ~7x the first reading
# on an H100 (loss 1.33e-5, grad norm 2.78e-5; PERF.md).
STEP_LOSS_REL_TOL = 1e-4
STEP_GRAD_NORM_REL_TOL = 2e-4

QWEN3_MOE_A3B = dict(  # Qwen/Qwen3-30B-A3B config.json widths
    architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe",
    vocab_size=151936, hidden_size=2048, intermediate_size=6144, moe_intermediate_size=768,
    num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4, head_dim=128,
    num_experts=128, num_experts_per_tok=8, norm_topk_prob=True, router_aux_loss_coef=0.001,
    rope_theta=1000000.0, rms_norm_eps=1e-6, max_position_embeddings=40960, tie_word_embeddings=False,
)
# automodel_tpu_torch/configs/pretrain_qwen3_moe_a3b.yaml as a dict
# (tests/test_torch_cli.py checks the two agree): depth cut to 4 layers.
PRETRAIN_QWEN3_MOE_A3B = dict(
    seed=42,
    model=dict(
        hf_config=dict(QWEN3_MOE_A3B, num_hidden_layers=4),
        backend=dict(attn="flash", experts="ragged", param_dtype="bfloat16", compute_dtype="bfloat16"),
    ),
    dataset=dict(_target_="automodel_tpu_torch.data.sft.MockSFTDataset", vocab_size=151936,
                 seq_length=4096, num_samples=1024),
    dataloader=dict(global_batch_size=1),
    step_scheduler=dict(grad_acc_steps=2, num_epochs=1, log_every_steps=10),
    optimizer=dict(name="adamw", lr=3e-4, weight_decay=0.1, betas=[0.9, 0.95], grad_clip_norm=1.0,
                   lr_schedule=dict(style="cosine", warmup_steps=2000, decay_steps=100000)),
    loss_fn=dict(name="fused_linear_ce"),
    logging=dict(metrics_path="runs/torch_qwen3_moe_a3b/train_metrics.jsonl"),
)
MOE_STEPS = 4
# grouped-matmul kernels vs plain (tests/test_torch_cuda_kernels.py holds
# the same limits): gmm and gmm_t per output row within 2^-7 (both round an
# fp32 sum to bf16, one ulp at most per element; a row past the groups must
# be exactly zero); tgmm per row of each [K, N] slab within 2^-13 (fp32 sums
# of exact bf16 products, apart only by their order). First readings on an
# H100: gmm rows at most 0.00087, tgmm slab rows at most 9.6e-6 (the skewed
# case's 8192-row group; PERF.md). A group that gains or loses one row
# moves the worst row of each past 4x its limit
# (tests/test_torch_cuda_kernels.py::test_grouped_row_check_catches_a_one_row_boundary_shift).
GMM_ROW_TOL = 2.0**-7
TGMM_ROW_TOL = 2.0**-13
# experts ragged vs dense over one step at 1 layer (relative): the same
# routing (identical gate inputs, so the aux loss agrees exactly), but
# dense runs every expert over every token and sums the [T, E] combine in
# bf16 where ragged sums the K picks in fp32. First reading on an H100:
# loss 0, grad norm 1.13e-5, aux 0 (PERF.md); the limits are ~9x the grad
# norm's reading, as phase 7's are.
MOE_STEP_LOSS_REL_TOL = 1e-4
MOE_STEP_GRAD_NORM_REL_TOL = 1e-4
MOE_STEP_AUX_REL_TOL = 1e-6

GPT_OSS_20B = dict(  # openai/gpt-oss-20b config.json widths and rope
    architectures=["GptOssForCausalLM"], model_type="gpt_oss",
    vocab_size=201088, hidden_size=2880, intermediate_size=2880, num_hidden_layers=24,
    num_attention_heads=64, num_key_value_heads=8, head_dim=64, num_local_experts=32, num_experts_per_tok=4,
    sliding_window=128, rope_theta=150000.0,
    rope_scaling=dict(rope_type="yarn", factor=32.0, beta_fast=32.0, beta_slow=1.0,
                      original_max_position_embeddings=4096, truncate=False),
    rms_norm_eps=1e-5, attention_bias=True, max_position_embeddings=131072, tie_word_embeddings=False,
)
# automodel_tpu_torch/configs/pretrain_gpt_oss_20b.yaml as a dict
# (tests/test_torch_gpt_oss.py checks the two agree): depth cut to 3 layers.
PRETRAIN_GPT_OSS_20B = dict(
    seed=42,
    model=dict(
        hf_config=dict(GPT_OSS_20B, num_hidden_layers=3),
        backend=dict(attn="flash", experts="ragged_fused", param_dtype="bfloat16", compute_dtype="bfloat16"),
    ),
    dataset=dict(_target_="automodel_tpu_torch.data.sft.MockSFTDataset", vocab_size=201088,
                 seq_length=4096, num_samples=1024, mask_ratio=0.0),
    dataloader=dict(global_batch_size=1),
    step_scheduler=dict(grad_acc_steps=2, num_epochs=1, max_steps=4, log_every_steps=1),
    optimizer=dict(name="adamw", lr=1e-4),
    loss_fn=dict(name="fused_linear_ce"),
    logging=dict(metrics_path="runs/torch_gpt_oss_20b/train_metrics.jsonl"),
)
# fused expert-MLP kernels vs plain (tests/test_torch_cuda_kernels.py holds
# the same limits and the reasons): out and dlhs per row within 2^-7, as
# gmm; the weight grads (dW gate | up, dWd) per row of each slab within
# 2^-10 (fp32 sums of bf16 products whose bf16 operand, dg, du or mid, the
# two versions compute a few fp32 ulps apart and may round one ulp apart);
# the bias grads per expert row within 2^-12 (fp32 sums in another order).
# A group that gains or loses one row moves the worst row of each past 4x
# its limit (tests/test_torch_cuda_kernels.py::
# test_fused_row_check_catches_a_one_row_boundary_shift).
FEM_ROW_TOL = 2.0**-7
FEM_DW_ROW_TOL = 2.0**-10
FEM_BIAS_ROW_TOL = 2.0**-12
# flash with sinks vs plain with sinks: out and dq/dk/dv as phase 3's;
# d_sinks = -sum over rows of p_sink x delta (delta = dO . out per row) is a
# signed sum that cancels, so each head's error is judged against the sum of
# its terms' magnitudes, sum p_sink |dO| |out|: with out rows within 2^-7,
# |delta - delta'| <= 2^-7 |dO| |out|, so 2^-7 holds whatever the
# cancellation (tests/test_torch_cuda_kernels.py holds the same; a limit of
# 1e-3 of the largest element, set before any reading, was broken at 2.6e-3
# by the first reading on an H100, S=1000, N=16)
SINKS_GRAD_TOL = 2.0**-7
# experts ragged_fused vs ragged over one step at 1 layer of gpt-oss-20b
# widths (relative). Looser than ragged vs dense (1e-4 each, whose routing
# and activation are the same): the fused forward keeps g, u and the
# activation in fp32 and rounds mid once, where ragged rounds g | u to bf16,
# adds the biases in bf16 and runs swiglu_oai in bf16 eager torch, as JAX's
# make_act2 does; the backward differs the same way. First reading on an
# H100: loss 1.79e-5, grad norm 4.96e-5 (PERF.md); the limits are ~10x it.
FUSED_STEP_LOSS_REL_TOL = 2e-4
FUSED_STEP_GRAD_NORM_REL_TOL = 5e-4

GEMMA2_9B = dict(  # google/gemma-2-9b config.json widths
    architectures=["Gemma2ForCausalLM"], model_type="gemma2",
    vocab_size=256000, hidden_size=3584, intermediate_size=14336, num_hidden_layers=42,
    num_attention_heads=16, num_key_value_heads=8, head_dim=256, query_pre_attn_scalar=256,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0, sliding_window=4096, rope_theta=10000.0,
    rms_norm_eps=1e-6, hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
    max_position_embeddings=8192,
)
# automodel_tpu_torch/configs/pretrain_gemma2_9b.yaml as a dict
# (tests/test_torch_gemma.py checks the two agree): depth cut to 8 layers.
PRETRAIN_GEMMA2_9B = dict(
    seed=42,
    model=dict(
        hf_config=dict(GEMMA2_9B, num_hidden_layers=8),
        backend=dict(attn="flash", param_dtype="bfloat16", compute_dtype="bfloat16"),
    ),
    dataset=dict(_target_="automodel_tpu_torch.data.sft.MockSFTDataset", vocab_size=256000,
                 seq_length=8192, num_samples=1024, mask_ratio=0.0),
    dataloader=dict(global_batch_size=1),
    step_scheduler=dict(grad_acc_steps=2, num_epochs=1, max_steps=4, log_every_steps=1),
    optimizer=dict(name="adamw", lr=1e-4),
    loss_fn=dict(name="fused_linear_ce"),
    logging=dict(metrics_path="runs/torch_gemma2_9b/train_metrics.jsonl"),
)

# phase 18, the ``benchmark llm`` recipe: each leg is one card config with a
# ``benchmark:`` section (automodel_tpu_torch/configs/benchmark_*.yaml as
# dicts; tests/test_torch_benchmark.py checks each pair agrees). Leg (a)
# adds the decode and serving legs: 4 greedy prompts of 64 tokens, 64 new
# tokens each and no eos; 16 Poisson requests at 8 a second of 128-1024
# prompt tokens and 64 new ones, on a pool that holds all 16 at once,
# served with speculative decoding (a Llama-3.2-1B-width draft, k = 4) and
# again with the draft off (the leg's spec on/off A/B).
BENCH_STEPS = dict(warmup_steps=3, measure_steps=10)
BENCH_LLAMA3_8B = dict(
    SFT_LLAMA3_8B,
    step_scheduler=dict(SFT_LLAMA3_8B["step_scheduler"], grad_acc_steps=2),
    benchmark=BENCH_STEPS,
    generation=dict(max_new_tokens=64, greedy=True, bench_batch=4, bench_prompt_len=64),
    serving=dict(slots=16, block_size=16, num_blocks=2048, prefill_chunk=512, max_seq_len=2048,
                 prefix_cache=True, kv_cache_dtype="bf16", decode_kernel="auto", bench_requests=16,
                 bench_rate=8.0, bench_prompt_len_min=128, bench_prompt_len_max=1024, bench_max_new_tokens=64,
                 speculative=dict(enabled=True, k=4, draft=dict(hf_config=LLAMA3_2_1B, backend=BF16))),
    logging=dict(metrics_path="runs/torch_bench_llama3_8b/bench_metrics.jsonl"),
)
BENCH_QWEN3_MOE_A3B = dict(PRETRAIN_QWEN3_MOE_A3B, benchmark=BENCH_STEPS,
                           logging=dict(metrics_path="runs/torch_bench_qwen3_moe_a3b/bench_metrics.jsonl"))
BENCH_GPT_OSS_20B = dict(PRETRAIN_GPT_OSS_20B, benchmark=BENCH_STEPS,
                         logging=dict(metrics_path="runs/torch_bench_gpt_oss_20b/bench_metrics.jsonl"))
BENCH_GEMMA2_9B = dict(PRETRAIN_GEMMA2_9B, benchmark=BENCH_STEPS,
                       logging=dict(metrics_path="runs/torch_bench_gemma2_9b/bench_metrics.jsonl"))


# phase 19, the ``kd llm`` recipe: automodel_tpu_torch/configs/
# kd_llama3_8b_to_llama3_2_1b.yaml as a dict (tests/test_torch_kd.py checks
# the two agree): the Llama-3-8B teacher and the Llama-3.2-1B student, both
# at their published widths and depths.
KD_LLAMA3_8B_TO_1B = dict(
    seed=42,
    teacher_model=dict(hf_config=LLAMA3_8B,
                       backend=dict(attn="flash", param_dtype="bfloat16", compute_dtype="bfloat16")),
    model=dict(hf_config=LLAMA3_2_1B,
               backend=dict(attn="flash", param_dtype="bfloat16", compute_dtype="bfloat16", remat="full")),
    kd=dict(ratio=0.5, temperature=2.0),
    dataset=dict(_target_="automodel_tpu_torch.data.sft.MockSFTDataset", vocab_size=128256,
                 seq_length=4096, num_samples=1024),
    dataloader=dict(global_batch_size=1),
    step_scheduler=dict(grad_acc_steps=2, num_epochs=1, log_every_steps=10),
    optimizer=dict(name="adamw", lr=1e-4),
    loss_fn=dict(name="masked_ce"),
    logging=dict(metrics_path="runs/torch_kd_llama3_8b_to_1b/train_metrics.jsonl"),
)
KD_STEPS = 4

# phase 20, speculative serving: automodel_tpu_torch/configs/
# serve_qwen3_moe_a3b_spec.yaml as a dict (tests/test_torch_cli.py checks
# the two agree): the Qwen3-30B-A3B target at its published 48 layers
# (cut to SPEC_TARGET_LAYERS in the phase; experts ragged, the paged
# kernel in decode and verify) and the
# Qwen3-0.6B draft, k = 4, greedy, on one card.
QWEN3_0_6B = dict(  # Qwen/Qwen3-0.6B config.json widths
    architectures=["Qwen3ForCausalLM"], model_type="qwen3", vocab_size=151936, hidden_size=1024,
    intermediate_size=3072, num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8, head_dim=128,
    rope_theta=1000000.0, rms_norm_eps=1e-6, max_position_embeddings=40960, tie_word_embeddings=True,
)
SERVE_QWEN3_MOE_A3B_SPEC = dict(
    seed=0, device="cuda",
    model=dict(hf_config=QWEN3_MOE_A3B,
               backend=dict(attn="sdpa", experts="ragged", param_dtype="bfloat16", compute_dtype="bfloat16")),
    generation=dict(max_new_tokens=64, greedy=True, eos_token_id=151645, pad_token_id=151643, seed=0),
    serving=dict(slots=16, block_size=16, num_blocks=2048, prefill_chunk=512, max_seq_len=2048, prefix_cache=True,
                 kv_cache_dtype="bf16", decode_kernel="fused",
                 speculative=dict(enabled=True, k=4, draft=dict(hf_config=QWEN3_0_6B, backend=BF16))),
)
# the self-draft check: Llama-3-8B widths cut to 4 layers, the draft given
# the target's own config and, after the build, its weights. Only bf16
# rounding between the draft's one-token forwards and the verify's
# (k+1)-token forward can make a proposal miss, so at least this share of
# proposals must be accepted (JAX's engine, whose draft pool never gets
# d_k's row, reads 0.375 in its own self-draft test on the CPU at fp32).
SELF_DRAFT_LLAMA3_8B = dict(
    seed=0, device="cuda",
    model=dict(hf_config=dict(LLAMA3_8B, num_hidden_layers=4), backend=BF16),
    generation=dict(max_new_tokens=64, greedy=True, seed=0),
    serving=dict(slots=16, block_size=16, num_blocks=2048, prefill_chunk=512, max_seq_len=2048, prefix_cache=True,
                 kv_cache_dtype="bf16", decode_kernel="fused",
                 speculative=dict(enabled=True, k=4,
                                  draft=dict(hf_config=dict(LLAMA3_8B, num_hidden_layers=4), backend=BF16))),
)
SELF_DRAFT_MIN_ACCEPT = 0.8
# phase 20's target depth: Qwen3-30B-A3B's widths, its 48 layers cut to 24
# (at 16 a spec-off stream left a spec-on one away from a near tie: MoE
# routing flips move logits by more than rounding)
# so the whole script keeps inside its time limit with phase 25
SPEC_TARGET_LAYERS = 24


def row_rel_err(out, ref) -> float:
    """Worst row's |out - ref| / |ref| over the last axis; a row of ref that
    is all zeros must be matched exactly."""
    d = (out.float() - ref.float()).norm(dim=-1)
    r = ref.float().norm(dim=-1)
    return float((d / r.clamp_min(1e-30)).max())


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

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


def cuda_ms_queued(fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """The device time of one call with the host kept ahead of the card: a
    sleep kernel holds the stream while the host enqueues every call, so
    the events time the calls back to back on the card even where one call
    costs the host more than the card does (a decode-sized paged
    attention). Raises if the host took longer to enqueue them than the
    card slept. → (ms a call on the card, host us to enqueue a call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pre, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    pre.record()
    t0 = time.perf_counter()
    torch.cuda._sleep(40_000_000)  # ~20 ms at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    slept = pre.elapsed_time(start)
    if host_ms >= slept:
        raise RuntimeError(f"cuda_ms_queued: the host took {host_ms:.3f} ms to enqueue, the card slept {slept:.3f}")
    return start.elapsed_time(end) / iters, 1e3 * host_ms / iters


# -- phase 3: paged attention against its plain version ----------------------


def paged_case(torch, dev, sq: int, quantized: bool, seed: int = 0, uniform: int | None = None,
               sharp: float = 1.0, batch: int = 16, lengths: list | None = None, nkv: int = 8,
               max_len: int = 4096):
    """The serving path's decode shapes: B=16 sequences of ragged lengths
    1..max_len (or all of length ``uniform``, or ``lengths``) over one
    layer's pool, 32 query heads over ``nkv`` kv heads. q is standard
    normal times ``sharp``: at 1 the attention over random keys is near
    uniform, at 4 a few rows carry most of each row's weight."""
    from automodel_tpu_torch.ops.paged_attention import quantize_kv_rows

    B, N, Nkv, H, BS = batch, 32, nkv, 128, 16
    nbseq = -(-(max_len + sq) // BS)
    nb = B * nbseq + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    given = lengths
    lengths = torch.randint(1, max_len + 1, (B,), generator=g, device=dev)
    if B > 1:
        lengths[0], lengths[1] = 1, max_len
    if uniform is not None:
        lengths.fill_(uniform)
    if given is not None:
        lengths = torch.tensor(given, device=dev)
    tables = (torch.randperm(nb - 1, generator=g, device=dev) + 1).reshape(B, nbseq)
    q = (torch.randn((B, sq, N, H), generator=g, device=dev) * sharp).to(torch.bfloat16)
    kp = torch.randn((nb, BS, Nkv, H), generator=g, device=dev)
    vp = torch.randn((nb, BS, Nkv, H), generator=g, device=dev)
    if quantized:
        kq, ks = quantize_kv_rows(kp)
        vq, vs = quantize_kv_rows(vp)
        pool = (kq, vq, tables.to(torch.int32), lengths.to(torch.int32), ks, vs)
    else:
        pool = (kp.to(torch.bfloat16), vp.to(torch.bfloat16), tables.to(torch.int32),
                lengths.to(torch.int32))
    return q, pool


def paged_bound(q, pool, window) -> tuple[float, str, int]:
    """Least time for one call: every attended KV row (and its scale) read
    once, q read once, the output written once, over HBM bandwidth; and
    the attention's 4*H flops per (query head, attended row) over the bf16
    peak. → (ms, what bounds it, bytes)."""
    B, Sq, N, H = q.shape
    k_pool, lengths = pool[0], pool[3]
    Nkv = k_pool.shape[2]
    rows = 0
    for length in lengths.tolist():
        lo = 0 if window is None else max(0, length - window + 1)
        rows += length + Sq - lo
    per_row = 2 * Nkv * H * k_pool.element_size() + (2 * Nkv * 4 if len(pool) > 4 else 0)
    nbytes = rows * per_row + 2 * q.numel() * q.element_size() + B * 4
    flops = 4 * H * (N // Nkv) * Nkv * rows * Sq
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def sdpa_library_ms(torch, q, pool, window) -> float:
    """``scaled_dot_product_attention`` over the gathered (dequantized) view
    under the same mask; the gather itself is not timed."""
    import torch.nn.functional as F

    from automodel_tpu_torch.ops.paged_attention import dequantize_kv

    B, Sq, N, H = q.shape
    k_pool, v_pool, tables, lengths = pool[:4]
    _, BS, Nkv, _ = k_pool.shape
    t = tables.long()
    if len(pool) > 4:
        k = dequantize_kv(k_pool[t], pool[4][t], torch.bfloat16)
        v = dequantize_kv(v_pool[t], pool[5][t], torch.bfloat16)
    else:
        k, v = k_pool[t], v_pool[t]
    C = t.shape[1] * BS
    rep = N // Nkv
    k = k.reshape(B, C, Nkv, H).transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    v = v.reshape(B, C, Nkv, H).transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    pos = torch.arange(C, device=q.device)
    q_abs = lengths.long()[:, None] + torch.arange(Sq, device=q.device)[None, :]
    mask = pos[None, None, :] <= q_abs[:, :, None]
    if window is not None:
        mask = mask & (q_abs[:, :, None] - pos[None, None, :] < window)
    mask = mask[:, None]
    qt = q.transpose(1, 2).contiguous()
    return cuda_ms(lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask), iters=20)


def paged_chunk_edges(torch, sq: int, batch: int = 16, nkv: int = 8) -> list:
    """16 lengths whose last query position is the last token of a chunk of
    the kernel's split-KV grid or the first of the next, and 0 and 1."""
    from automodel_tpu_torch.ops.paged_attention import chunk_blocks

    nbseq = -(-(4096 + sq) // 16)
    C = 16 * chunk_blocks(batch, nkv, nbseq, torch.cuda.get_device_properties(0).multi_processor_count)
    ends = [k * C for k in range(1, 8) if k * C <= 4096]
    return ([0, 1] + [e - sq + d for e in ends for d in (0, 1)] + [4096 - sq] * batch)[:batch]


def phase_kernels(torch, dev) -> dict:
    from automodel_tpu_torch.ops.paged_attention import paged_attend, paged_attend_plain

    # the two main cases are timed against the plain version and the library
    # call; the uniform ones and one long sequence time the kernel as the
    # context grows; the chunk-edge cases put lengths on the split-KV grid's
    # chunk boundaries
    cases = [
        dict(sq=1, quantized=False, main=True),
        dict(sq=1, quantized=True, main=True),
        dict(sq=5, quantized=False),
        dict(sq=5, quantized=True),
        dict(sq=1, quantized=False, window=1024),
        dict(sq=1, quantized=False, cap=30.0),
        dict(sq=1, quantized=False, sharp=4.0),
        dict(sq=5, quantized=True, sharp=4.0),
        dict(sq=1, quantized=False, window=1024, sharp=4.0),
        dict(sq=1, quantized=False, uniform=256),
        dict(sq=1, quantized=False, uniform=1024),
        dict(sq=1, quantized=False, uniform=4096),
        dict(sq=1, quantized=False, lengths=paged_chunk_edges(torch, 1)),
        dict(sq=5, quantized=True, cap=30.0, lengths=paged_chunk_edges(torch, 5)),
        dict(sq=1, quantized=False, batch=1, uniform=4096),
        dict(sq=1, quantized=True, batch=1, uniform=4096),
        # verify chunks past 32 query rows a kv head (the kernel's row
        # tiles): Qwen3-30B-A3B's 32 heads over 4 at Sq 5 (k = 4: 40 rows,
        # bf16 and int8), Sq 8 (64) and Sq 20 (160), ragged 1-2048
        dict(sq=5, quantized=False, nkv=4, max_len=2048, wide=True),
        dict(sq=5, quantized=True, nkv=4, max_len=2048, wide=True),
        dict(sq=8, quantized=False, nkv=4, max_len=2048, wide=True),
        dict(sq=20, quantized=False, nkv=4, max_len=2048, wide=True),
    ]
    results = []
    for i, c in enumerate(cases):
        c = dict(dict(window=None, cap=None, main=False, uniform=None, sharp=1.0, batch=16, lengths=None, nkv=8,
                      max_len=4096, wide=False), **c)
        q, pool = paged_case(torch, dev, c["sq"], c["quantized"], seed=i, uniform=c["uniform"],
                             sharp=c["sharp"], batch=c["batch"], lengths=c["lengths"], nkv=c["nkv"],
                             max_len=c["max_len"])
        kw = dict(sliding_window=c["window"], logits_soft_cap=c["cap"])
        out = paged_attend(q, *pool, **kw)
        torch.cuda.synchronize()
        ref = paged_attend_plain(q, *pool, **kw)
        max_err = float((out.float() - ref.float()).abs().max())
        row_err = row_rel_err(out, ref)
        ok = row_err <= KERNEL_ROW_REL_TOL
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"paged kernel produced non-finite values in case {c}")
        lengths = (f"all {c['uniform']}" if c["uniform"] else
                   "chunk edges" if c["lengths"] else f"ragged 1-{c['max_len']}")
        row = dict(
            sq=c["sq"], pool="int8" if c["quantized"] else "bf16", window=c["window"],
            cap=c["cap"], sharp=c["sharp"], batch=c["batch"], lengths=lengths,
            max_abs_err=max_err, max_row_rel_err=row_err, ok=ok,
        )
        if c["wide"]:
            rows = c["sq"] * 32 // c["nkv"]
            row.update(wide=True, nkv=c["nkv"], rows_per_kv_head=rows, row_tiles=-(-rows // 32))
        if c["main"] or c["uniform"] or c["wide"]:
            # one call costs the host about as long as the card here: timed
            # with the host ahead, and the host's time per call beside it
            row["ms"], row["host_us_per_call"] = cuda_ms_queued(lambda: paged_attend(q, *pool, **kw), iters=50)
            row["ms_back_to_back"] = cuda_ms(lambda: paged_attend(q, *pool, **kw), iters=50)
            row["bound_ms"], row["bound_by"], row["bytes"] = paged_bound(q, pool, c["window"])
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if c["main"] or c["wide"]:
            row["plain_ms"] = cuda_ms(lambda: paged_attend_plain(q, *pool, **kw), iters=5, warmup=1)
            row["library_ms"] = sdpa_library_ms(torch, q, pool, c["window"])
        results.append(row)
        print(f"kernel paged_attention vs plain: {json.dumps(row)}", flush=True)
        del q, pool, out, ref
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise RuntimeError(
            f"paged kernel disagrees with its plain version beyond a row-relative "
            f"error of {KERNEL_ROW_REL_TOL}: {bad}"
        )
    return {"cases": results}


# -- phase 4: serving at full width -------------------------------------------


def serve_requests(engine, prompts: list[list[int]], shared: int, max_new: int):
    """Submit one sharing request and the non-sharing ones, step until the
    sharer's prompt is prefilled (so its blocks are in the prefix cache),
    then submit the other sharers and drain. → (records, wall seconds)."""
    t0 = time.perf_counter()
    ids = {}
    first_wave = [0] + list(range(shared, len(prompts)))
    for i in first_wave:
        ids[i] = engine.submit(prompts[i], request_id=f"r{i}", max_new_tokens=max_new)
    recs = []
    for _ in range(-(-len(prompts[0]) // engine.config.prefill_chunk)):
        recs += engine.step()
    for i in range(1, shared):
        ids[i] = engine.submit(prompts[i], request_id=f"r{i}", max_new_tokens=max_new)
    recs += engine.run()
    import torch

    torch.cuda.synchronize()
    return recs, time.perf_counter() - t0


def make_prompts(n: int, shared: int, seed: int, vocab: int, max_len: int = 2048) -> list[list[int]]:
    import random

    rng = random.Random(seed)
    prefix = [rng.randrange(1, vocab) for _ in range(512)]
    prompts = []
    for i in range(n):
        length = rng.randint(128, max_len)
        if i < shared:
            length = max(length, 513)
            prompts.append(prefix + [rng.randrange(1, vocab) for _ in range(length - 512)])
        else:
            prompts.append([rng.randrange(1, vocab) for _ in range(length)])
    return prompts


def serve_config(kv_cache_dtype: str) -> dict:
    """The ``serve`` config, as a dict (no YAML reader needed): Llama-3-8B
    widths with random bf16 weights from seed 0 on the card, the pool and
    scheduler of automodel_tpu_torch/configs/serve_llama3_8b.yaml at half
    its blocks and context, greedy decoding."""
    return dict(
        seed=0, device="cuda",
        model=dict(hf_config=LLAMA3_8B, backend=BF16),
        generation=dict(max_new_tokens=MAX_NEW, greedy=True, seed=0),
        serving=dict(
            slots=16, block_size=16, num_blocks=4096, prefill_chunk=512, max_seq_len=4096,
            prefix_cache=True, kv_cache_dtype=kv_cache_dtype, decode_kernel="auto",
        ),
    )


def phase_serving(torch, engine, n: int, shared: int) -> dict:
    from automodel_tpu_torch.ops.paged_attention import paged_attend

    kv_cache_dtype = engine.config.kv_cache_dtype
    max_new = engine.gen_config.max_new_tokens
    auto = engine.auto
    prompts = make_prompts(n, shared, seed=1 if kv_cache_dtype == "bf16" else 2,
                           vocab=auto.config.vocab_size)
    # the main path's run: every count set to 0 just before, read just after
    paged_attend.launches = 0
    recs, wall = serve_requests(engine, prompts, shared, max_new)
    launches = paged_attend.launches
    layers = auto.config.num_layers
    if len(recs) != n:
        raise RuntimeError(f"{len(recs)} records for {n} requests")
    reasons = {r["completion_reason"] for r in recs}
    if not reasons <= {"length", "stop"}:
        raise RuntimeError(f"requests ended with {reasons}")
    if launches != engine.decode_forwards * layers or launches == 0:
        raise RuntimeError(
            f"paged kernel launched {launches} times for {engine.decode_forwards} decode "
            f"forwards x {layers} layers"
        )
    hits = [r["prefix_hit_tokens"] for r in recs if r["request_id"] in {f"r{i}" for i in range(1, shared)}]
    if min(hits) < 512:
        raise RuntimeError(f"shared-prefix requests missed the prefix cache: hits {hits}")
    gen = sum(r["n_generated"] for r in recs)
    ttfts = sorted(r["ttft_s"] for r in recs)
    out = dict(
        kv_cache_dtype=kv_cache_dtype, requests=n, generated_tokens=gen,
        prompt_tokens=sum(len(p) for p in prompts), wall_s=wall, tokens_per_s=gen / wall,
        ttft_p50_s=statistics.median(ttfts), ttft_max_s=ttfts[-1],
        decode_forwards=engine.decode_forwards, prefill_chunks=engine.prefill_chunks,
        paged_attend_launches=launches, prefix_hit_tokens=sum(hits),
        pool_gib=engine.pool_bytes / 2**30,
    )
    print(f"serving {kv_cache_dtype}: {json.dumps(out)}", flush=True)
    return out


def phase_profile(torch, engine, steps: int = 8, label: str = "decode step profile") -> dict:
    """Where a decode step's time goes at full width: every slot decoding
    (prompts of 1024 tokens), ``steps`` scheduler steps timed by the host
    clock, then the same number under ``torch.profiler`` for the device
    kernels by name. The idle share is 1 - kernel time / profiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(20)
    for i in range(engine.config.slots):
        prompt = torch.randint(1, engine.auto.config.vocab_size, (1024,), generator=g).tolist()
        engine.submit(prompt, request_id=f"p{i}", max_new_tokens=2 * steps + 4)
    while engine.queue_depth or not bool(engine.decode_batch()[3].all()):
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    engine.run()
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n_kernels += 1
    out = dict(slots=engine.config.slots, context=1024, step_ms=step_ms)
    if not by_name:
        out["profile"] = "no device events from torch.profiler: not measured"
    else:
        busy = sum(by_name.values())

        def share(pred):
            return sum(v for k, v in by_name.items() if pred(k.lower())) / steps

        gemm = ("gemm", "xmma", "cutlass", "cublas", "nvjet")
        out.update(
            profiled_step_ms=wall_ms / steps, device_busy_ms_per_step=busy / steps,
            idle_share=1.0 - busy / wall_ms, device_ops_per_step=n_kernels / steps,
            paged_attention_ms_per_step=share(lambda k: "paged_attention" in k),
            grouped_matmul_ms_per_step=share(lambda k: "gmm_kernel" in k),
            matmul_ms_per_step=share(lambda k: any(s in k for s in gemm)),
            top=[dict(name=k[:80], ms_per_step=v / steps)
                 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]],
        )
    print(f"{label}: {json.dumps(out)}", flush=True)
    return out


# -- phase 5: one decode step, fused against gather ---------------------------


def phase_fused_vs_gather(torch, auto, draft_k: int = 0, label: str = "decode step") -> dict:
    """One decode forward (``draft_k`` 0) or one verify forward over [cur,
    d_1..d_draft_k] (random drafts) at four slots' offsets through the
    fused backend (the kernel) and through gather (plain attention over
    the gathered view), each on its own copy of the same pool: the logits
    must agree within the limits.

    An MoE model's top-k routing is discontinuous: a token whose k-th and
    (k+1)-th experts score within bf16 rounding of each other changes
    experts between the two forwards, and after 48 layers such flips move
    the logits past any rounding limit (the first chip run of Qwen3-30B-A3B's
    verify read rel 0.089, min cosine 0.9961). So for a model with MoE
    layers the fused forward is run a second time with every gate's output
    taken from the gather forward (the routing pinned): that pair is held
    to the limits, and the unpinned pair is printed beside it with the
    number of (token, layer) routings that differ between the two."""
    from automodel_tpu_torch.generation.engine import GenerationConfig
    from automodel_tpu_torch.serving import paged
    from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine

    engine = ServingEngine(
        auto,
        ServeConfig(slots=4, block_size=16, num_blocks=1024, prefill_chunk=512, max_seq_len=4096),
        GenerationConfig(max_new_tokens=64, greedy=True),
    )
    g = torch.Generator().manual_seed(10)
    for length in (100, 700, 1500, 2000):
        engine.submit(torch.randint(1, auto.config.vocab_size, (length,), generator=g).tolist())
    batch = engine.decode_batch()
    while not bool(batch[3].all()):  # step until every prompt is prefilled
        engine.step()
        batch = engine.decode_batch()
    kw = dict(block_size=16, compute_dtype=auto.model.compute_dtype)
    pool = engine.kv_pool

    def clone(p):
        side = lambda s: tuple(t.clone() for t in s) if isinstance(s, tuple) else s.clone()
        return paged.PagedKV(k=side(p.k), v=side(p.v))

    fed = batch[2][:, None]
    if draft_k:
        drafts = torch.randint(1, auto.config.vocab_size, (fed.shape[0], draft_k), generator=g).to(fed.device)
        fed = torch.cat([fed, drafts], dim=1)

    def forward(backend):
        with torch.inference_mode():
            out = paged.decode_logits(auto.model, clone(pool), *batch[:2], fed, batch[3], backend=backend, **kw)
        return out.reshape(-1, out.shape[-1])

    def compare(fused, gather):
        if not (bool(torch.isfinite(fused).all()) and bool(torch.isfinite(gather).all())):
            raise RuntimeError("non-finite logits")
        diff = float((fused - gather).abs().max())
        scale = float(gather.abs().max())
        cos = torch.nn.functional.cosine_similarity(fused.flatten(1), gather.flatten(1), dim=-1)
        return dict(
            max_abs_diff=diff, max_abs_logit=scale, rel=diff / max(scale, 1e-30),
            min_cosine=float(cos.min()),
            argmax_agree=int((fused.argmax(-1) == gather.argmax(-1)).sum()), slots=fused.shape[0],
        )

    from automodel_tpu_torch.moe import layer as moe_layer

    real_gate, gates = moe_layer.gate, []

    def recording_gate(*a, **k):
        gates.append(real_gate(*a, **k))
        return gates[-1]

    moe_layer.gate = recording_gate
    try:
        gather = forward("gather")
    finally:
        moe_layer.gate = real_gate
    fused = forward("fused")
    torch.cuda.synchronize()
    out = compare(fused, gather)
    if gates:  # an MoE model: the fused forward again with the gather forward's routing
        replay, flips = iter(gates), []

        def pinned_gate(*a, **k):
            own, theirs = real_gate(*a, **k), next(replay)
            differ = own.topk_idx.sort(-1).values != theirs.topk_idx.sort(-1).values
            flips.append(int(differ.any(-1).sum()))
            return theirs

        moe_layer.gate = pinned_gate
        try:
            pinned = forward("fused")
        finally:
            moe_layer.gate = real_gate
        torch.cuda.synchronize()
        out = dict(compare(pinned, gather), unpinned=out, routing_flips=sum(flips),
                   routings=len(gates) * fused.shape[0])
    print(f"{label} fused vs gather: {json.dumps(out)}", flush=True)
    if out["rel"] > LOGITS_REL_TOL or out["min_cosine"] < LOGITS_MIN_COSINE:
        raise RuntimeError(
            f"fused and gather logits disagree: {out} (limits: rel {LOGITS_REL_TOL}, "
            f"min cosine {LOGITS_MIN_COSINE})"
        )
    del engine
    torch.cuda.empty_cache()
    return out


# -- phase 3: flash attention against its plain versions ----------------------


def grad_row_err(out, ref) -> float:
    """Worst row's |out - ref| / max(|ref|, FLASH_GRAD_FLOOR x RMS row norm)."""
    import torch

    d = (out.float() - ref.float()).norm(dim=-1)
    r = ref.float().norm(dim=-1)
    floor = FLASH_GRAD_FLOOR * r.pow(2).mean().sqrt()
    return float((d / torch.maximum(r, floor).clamp_min(1e-30)).max())


def flash_case(torch, dev, S=4096, H=128, B=1, N=32, Nkv=8, sharp=1.0, docs=0, seed=0, seg_ids=None):
    """bf16 q/k/v/dO from a seeded generator on the card, positions 0..S-1,
    and with ``docs`` packed documents of ragged lengths segment ids (or
    the given ``seg_ids`` [B, S], a packed row's)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, S, N, H), generator=g, device=dev) * sharp).to(torch.bfloat16)
    k, v = (torch.randn((B, S, Nkv, H), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    do = torch.randn((B, S, N, H), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    seg = None
    if docs:
        cuts = torch.stack([torch.randperm(S - 1, generator=g, device=dev)[: docs - 1] + 1 for _ in range(B)])
        seg = (pos[None, :, None] >= cuts.sort(dim=1).values[:, None, :]).sum(-1).to(torch.int32)
    if seg_ids is not None:
        seg = seg_ids.to(device=dev, dtype=torch.int32)
    return q, k, v, do, pos, seg


def flash_bound(q, k, pairs: int) -> dict:
    """Least time of each kernel: its bf16 products over the live (q, k)
    pairs (fwd 2, dq 3, dkv 4 products of 2*H flops per pair and q head)
    over the peak, against its bytes (each input read once, each output
    written once) over HBM bandwidth. A soft cap's tanh is not counted.
    → {kernel: (ms, bound_by)}."""
    B, S, N, H = q.shape
    Sk, Nkv = k.shape[1], k.shape[2]
    qb, kb, lse_b = B * S * N * H * 2, B * Sk * Nkv * H * 2, B * N * S * 4
    work = dict(
        fwd=(2, qb + 2 * kb + qb + lse_b),
        dq=(3, 2 * qb + 2 * kb + 2 * lse_b + 2 * qb),
        dkv=(4, 2 * qb + 2 * kb + 2 * lse_b + 4 * kb),
    )
    out = {}
    for name, (products, nbytes) in work.items():
        t_ops = products * 2 * H * pairs * N / BF16_FLOPS
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def _library_times(fwd_fn, leaves, dot, iters: int = 10, warmup: int = 2) -> tuple[float, float, float]:
    """A library attention's forward, forward+backward, and backward alone:
    ``torch.autograd.grad`` on a fresh forward each time (a compiled
    backward may not run twice over one graph), the events around the
    backward only."""
    import torch

    fwd = cuda_ms(lambda: fwd_fn(*(t.detach() for t in leaves)), iters=20)

    def fwd_bwd():
        fwd_fn(*leaves).backward(dot)

    fwd_bwd_ms = cuda_ms(fwd_bwd, iters=iters)
    bwd = 0.0
    for i in range(warmup + iters):
        out = fwd_fn(*leaves)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, leaves, dot)
        end.record()
        end.synchronize()
        bwd += start.elapsed_time(end) if i >= warmup else 0.0
        del out
    return fwd, fwd_bwd_ms, bwd / iters


def flash_library_ms(torch, q, k, v, do, causal: bool, scale=None) -> tuple[float, float, float]:
    """``scaled_dot_product_attention`` on the [B, N, S, H] views: forward,
    forward+backward, and the backward alone (a yardstick only; the port
    never calls it)."""
    import torch.nn.functional as F

    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(is_causal=causal, enable_gqa=True, scale=scale)
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    return _library_times(lambda *a: F.scaled_dot_product_attention(*a, **kw), leaves, dot)


def sdpa_mask_library_ms(torch, q, k, v, do, mask, scale=None) -> tuple[float, float, float]:
    """``scaled_dot_product_attention`` with ``mask`` [B, S, S] (True =
    attend) as its boolean ``attn_mask``: forward, forward+backward and the
    backward alone (a yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(attn_mask=mask[:, None], enable_gqa=True, scale=scale)
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    return _library_times(lambda *a: F.scaled_dot_product_attention(*a, **kw), leaves, dot)


def flex_library_ms(torch, q, k, v, do, cap, window, scale: float) -> tuple[float, float, float]:
    """``torch.compile(flex_attention)`` with the soft cap as a tanh
    ``score_mod`` (none when ``cap`` is None) and a causal (or causal
    window) block mask: the same function as the kernels, forward,
    forward+backward and the backward alone (a yardstick only; the port
    never calls it)."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        keep = q_idx >= kv_idx
        return keep & (q_idx - kv_idx < window) if window is not None else keep

    S = q.shape[1]
    block_mask = create_block_mask(mask_mod, None, None, S, S, device=q.device)
    flex = torch.compile(flex_attention)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(score_mod=score_mod if cap is not None else None, block_mask=block_mask, scale=scale, enable_gqa=True)
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    return _library_times(lambda *a: flex(*a, **kw), leaves, dot)


def set_flash_library_ms(row: dict, lib: tuple) -> None:
    """The library's forward beside fwd; dq and dkv get none, since no
    library call computes dq, or dk and dv, alone: the library's backward
    stands beside the two together (``flash_backward_pair``)."""
    for name in ("fwd", "dq", "dkv"):
        row["timed"][name]["library_ms"] = lib[0] if name == "fwd" else None


def flash_backward_pair(c: dict) -> dict:
    """dq and dkv together at one timed case against the library's
    backward alone (dq, dk and dv at once): their summed times and bounds,
    and the sum over the library's time."""
    dq, dkv = c["timed"]["dq"], c["timed"]["dkv"]
    ms = dq["ms"] + dkv["ms"]
    return dict(kernels="flash_attention_dq + flash_attention_dkv", ms=ms, bound_ms=dq["bound_ms"] + dkv["bound_ms"],
                library_ms=c["library_bwd_ms"], ms_over_library_ms=ms / c["library_bwd_ms"],
                library_fwd_bwd_ms=c["library_fwd_bwd_ms"])


# K1's times with its earlier mma.sync kernels (PERF.md section 6, on an
# NVIDIA H100 80GB HBM3, 700.00 W), by case: printed beside each reading
K1_MMA_SYNC_MS = {
    "causal": dict(fwd=1.3864, dq=1.7402, dkv=2.8311),
    "gemma2-9b causal, cap 50": dict(fwd=8.3934, dq=10.1396, dkv=12.5767),
    "gemma2-9b window 4096, cap 50": dict(fwd=6.6723, dq=7.7972, dkv=9.8729),
}


def time_flash(torch, rf, label: str, args: tuple, kw: dict, bound: dict, before: dict | None) -> dict:
    """The three kernels and their plain versions timed at one case, each
    beside its bound; the printed line puts the earlier kernel's recorded
    time beside each reading, where there is one."""
    q, k, v, do, lse, delta, q_pos, kv_pos, seg_q, seg_kv = args
    calls = dict(
        fwd=(lambda: rf.flash_block_fwd(q, k, v, q_pos, kv_pos, seg_q, seg_kv, **kw),
             lambda: rf._flash_fwd_plain(q, k, v, q_pos, kv_pos, seg_q, seg_kv, **kw)),
        dq=(lambda: rf.flash_block_dq(*args, **kw), lambda: rf._flash_dq_plain(*args, **kw)),
        dkv=(lambda: rf.flash_block_dkv(*args, **kw), lambda: rf._flash_dkv_plain(*args, **kw)),
    )
    out = {}
    for name, (kern, plain_fn) in calls.items():
        out[name] = dict(ms=cuda_ms(kern, iters=20), plain_ms=cuda_ms(plain_fn, iters=3, warmup=1),
                         bound_ms=bound[name][0], bound_by=bound[name][1])
    torch.cuda.empty_cache()
    print(f"timed {label}: " + ", ".join(
        f"{n} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}"
        + (f", mma.sync kernel {before[n]:.4f} recorded, {before[n] / t['ms']:.2f}x" if before else ", no earlier time")
        + ")" for n, t in out.items()), flush=True)
    return out


FLASH_CASE_DEFAULTS = dict(main=False, window=None, causal=True, S=4096, H=128, N=32, Nkv=8, docs=0, sharp=1.0,
                           cap=None, scale=None, fault=False, seg_ids=None, v_dim=None)


def flash_check(torch, dev, c: dict, seed: int) -> dict:
    """One case: the forward, dq and dkv kernels against their plain
    versions, both backward versions fed the plain forward's lse and delta.
    With ``fault`` the plain dq with the soft cap's factor 1 - t^2 dropped
    must move the worst row past 4x its limit. With ``main`` the kernels,
    the plain versions and the library yardsticks are timed beside the
    bound."""
    from automodel_tpu_torch.ops import ring_flash as rf

    c = dict(FLASH_CASE_DEFAULTS, **c)
    q, k, v, do, pos, seg = flash_case(torch, dev, S=c["S"], H=c["H"], N=c["N"], Nkv=c["Nkv"], sharp=c["sharp"],
                                       docs=c["docs"], seed=seed, seg_ids=c["seg_ids"])
    if c["v_dim"] is not None:
        # MLA: v_head_dim zero-padded to the q/k head_dim, as the block pads it
        v[..., c["v_dim"]:] = 0
    scale = c["scale"] or c["H"] ** -0.5
    kw = dict(causal=c["causal"], window=c["window"], scale=scale, soft_cap=c["cap"])
    out, lse = rf.flash_block_fwd(q, k, v, pos, pos, seg, seg, **kw)
    r_out, r_lse = rf._flash_fwd_plain(q, k, v, pos, pos, seg, seg, **kw)
    # both backward versions read the plain forward's lse and delta
    delta = (do.float() * r_out.float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (q, k, v, do, r_lse, delta, pos, pos, seg, seg)
    dq = rf.flash_block_dq(*bargs, **kw)
    dk, dv = rf.flash_block_dkv(*bargs, **kw)
    torch.cuda.synchronize()
    r_dq = rf._flash_dq_plain(*bargs, **kw)
    r_dk, r_dv = rf._flash_dkv_plain(*bargs, **kw)
    got = (out, dq, dk, dv)
    if not all(bool(torch.isfinite(t.float()).all()) for t in (*got, lse)):
        raise RuntimeError(f"flash kernels produced non-finite values in case {c['name']}")
    mask = rf._mask(pos, pos, seg, seg, c["causal"], c["window"])
    if c["seg_ids"] is not None:
        # a packed row's segment 0 is padding: its rows are computed and
        # never read, so the bound counts the documents' pairs alone
        mask = mask & (seg > 0)[:, :, None]
    pairs = int(mask.sum()) * (q.shape[0] if seg is None else 1)
    row = dict(
        case=c["name"], S=c["S"], H=c["H"], N=c["N"], Nkv=c["Nkv"], cap=c["cap"], live_pairs=pairs,
        out_row_err=row_rel_err(out, r_out), lse_err=float((lse - r_lse).abs().max()),
        dq_row_err=grad_row_err(dq, r_dq), dk_row_err=grad_row_err(dk, r_dk),
        dv_row_err=grad_row_err(dv, r_dv),
        max_abs_err=dict(
            fwd=float((out.float() - r_out.float()).abs().max()),
            dq=float((dq - r_dq).abs().max()),
            dkv=max(float((dk - r_dk).abs().max()), float((dv - r_dv).abs().max())),
        ),
    )
    row["ok"] = (row["out_row_err"] <= FLASH_OUT_TOL and row["lse_err"] <= FLASH_LSE_TOL
                 and max(row["dq_row_err"], row["dk_row_err"], row["dv_row_err"]) <= FLASH_GRAD_TOL)
    if c["fault"]:
        # the planted fault: the plain dq without the cap's factor 1 - t^2
        scores = rf._scores
        rf._scores = lambda *a: (scores(*a)[0], None)
        try:
            wrong = rf._flash_dq_plain(*bargs, **kw)
        finally:
            rf._scores = scores
        row["fault_dq_row_err"] = grad_row_err(wrong, r_dq)
        row["ok"] = row["ok"] and row["fault_dq_row_err"] > 4 * FLASH_GRAD_TOL
        del wrong
    del r_out, r_lse, r_dq, r_dk, r_dv, mask
    torch.cuda.empty_cache()
    if c["main"]:
        row["timed"] = time_flash(torch, rf, c["name"], bargs, kw, flash_bound(q, k, pairs),
                                  K1_MMA_SYNC_MS.get(c["name"]))
        if seg is not None:
            # packed documents: SDPA with the same mask as a boolean attn_mask
            lib = sdpa_mask_library_ms(torch, q, k, v, do, rf._mask(pos, pos, seg, seg, c["causal"], c["window"]),
                                       scale)
        elif c["cap"] is None:
            lib = flash_library_ms(torch, q, k, v, do, c["causal"], scale)
        else:
            # no SDPA call computes the cap: flex_attention with a tanh
            # score_mod does; SDPA without the cap (causal) stands beside it
            lib = flex_library_ms(torch, q, k, v, do, c["cap"], c["window"], scale)
            row["sdpa_no_cap_fwd_ms"], row["sdpa_no_cap_fwd_bwd_ms"], row["sdpa_no_cap_bwd_ms"] = flash_library_ms(
                torch, q, k, v, do, True, scale)
        row["library_fwd_ms"], row["library_fwd_bwd_ms"], row["library_bwd_ms"] = lib
        set_flash_library_ms(row, lib)
        torch.cuda.empty_cache()
    del q, k, v, do, out, lse, dq, dk, dv, bargs
    torch.cuda.empty_cache()
    return row


def run_flash_cases(torch, dev, cases: list, label: str, seed0: int = 0) -> dict:
    results = []
    for i, c in enumerate(cases):
        row = flash_check(torch, dev, c, seed0 + i)
        results.append(row)
        print(f"kernel {label} vs plain: {json.dumps(row)}", flush=True)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise RuntimeError(
            f"{label} kernels disagree with their plain versions (limits: out {FLASH_OUT_TOL}, lse "
            f"{FLASH_LSE_TOL}, grads {FLASH_GRAD_TOL} per row; a planted fault past 4x): {bad}"
        )
    return {"cases": results}


def phase_flash_kernels(torch, dev) -> dict:
    cases = [
        dict(name="causal", main=True),
        dict(name="window 1024", window=1024),
        dict(name="4 packed documents", docs=4),
        dict(name="non-causal", causal=False),
        dict(name="H=64", H=64),
        dict(name="S=4000", S=4000),
        dict(name="sharp (q x 4)", sharp=4.0),
        dict(name="rep 8 (Qwen3: N=32, Nkv=4)", Nkv=4),
    ]
    return run_flash_cases(torch, dev, cases, "flash_attention")


def phase_flash_cap(torch, dev) -> dict:
    """Gemma 2 9B's attention (B=1, S=8192, N=16, Nkv=8, H=256, the scale
    query_pre_attn_scalar^-0.5 = 1/16, soft cap 50), causal and with the
    4096 window, both timed; then the cap saturated (q x 64: scale * q.k
    ~ N(0, 64^2), most tanh near +-1), with the planted fault; 4 packed
    documents; S=8000; H=256 without a cap; and Gemma 2 27B's head shape
    (N=32, Nkv=16, H=128, scale 144^-0.5) with the cap."""
    hf = GEMMA2_9B
    g = dict(S=8192, H=hf["head_dim"], N=hf["num_attention_heads"], Nkv=hf["num_key_value_heads"],
             cap=hf["attn_logit_softcapping"], scale=hf["query_pre_attn_scalar"] ** -0.5)
    cases = [
        dict(g, name="gemma2-9b causal, cap 50", main=True),
        dict(g, name="gemma2-9b window 4096, cap 50", window=hf["sliding_window"], main=True),
        dict(g, name="saturated cap (q x 64), planted fault", sharp=64.0, fault=True),
        dict(g, name="4 packed documents, cap 50", docs=4),
        dict(g, name="S=8000, cap 50", S=8000),
        dict(g, name="H=256 without a cap", cap=None),
        dict(g, name="gemma2-27b heads (N=32, Nkv=16, H=128), cap 50", S=4096, H=128, N=32, Nkv=16,
             scale=144**-0.5),
    ]
    return run_flash_cases(torch, dev, cases, "flash_attention with soft cap", seed0=40)


# -- phase 6: training at Llama-3-8B widths through the flash kernels ---------


def train_config() -> dict:
    """SFT_LLAMA3_8B on the card with the smoke's step plan. The schedule is
    a constant lr of 1e-4: the recipe's 100-step warmup gives an lr of at
    most 3e-7 over 4 steps, below half a bf16 ulp of weights near
    1/sqrt(4096), so the weights would not move."""
    cfg = json.loads(json.dumps(SFT_LLAMA3_8B))
    cfg["device"] = "cuda"
    cfg["step_scheduler"].update(grad_acc_steps=TRAIN_ACC, max_steps=TRAIN_STEPS, log_every_steps=1)
    cfg["optimizer"].update(lr=1e-4, lr_schedule=dict(style="constant"))
    here = __import__("pathlib").Path(__file__).resolve().parent
    cfg["logging"]["metrics_path"] = str(here / "runs" / "chip_smoke" / f"train_metrics_{time.time_ns()}.jsonl")
    return cfg


def live_pairs(seq: int, window) -> int:
    """Live (q, k) pairs of one causal sequence, under a window if given."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def attention_flops(cfg: dict, seq: int, windows=None) -> float:
    """Attention products of one causal sequence over all layers, forward
    (2 products) and backward (4), 2*H flops per live pair and q head;
    ``windows`` gives each layer's window (None: full causal)."""
    hf = cfg["model"]["hf_config"]
    windows = windows or [None] * hf["num_hidden_layers"]
    return 12 * hf["head_dim"] * hf["num_attention_heads"] * sum(live_pairs(seq, w) for w in windows)


def profile_train_step(torch, recipe, acc: int = TRAIN_ACC) -> dict:
    """One more step under torch.profiler: device ms by kernel family and
    the device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from automodel_tpu_torch.data.collators import stack_microbatches

    dl = recipe.dataloader
    batch = recipe._place(stack_microbatches([dl.batch_for(0, 100 + i) for i in range(acc)]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recipe.train_step(recipe.state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return {"profile": "no device events from torch.profiler: not measured", "wall_ms": wall_ms}
    gemm = ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")

    def ms(pred):
        return sum(v for k, v in by_name.items() if pred(k.lower()))

    busy = sum(by_name.values())
    out = dict(
        profiled_step_ms=wall_ms, device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
        flash_fwd_ms=ms(lambda k: "flash_fwd_kernel" in k),
        flash_dq_ms=ms(lambda k: "flash_dq_kernel" in k),
        flash_dkv_ms=ms(lambda k: "flash_dkv_kernel" in k),
        matmul_ms=ms(lambda k: "flash" not in k and any(s in k for s in gemm)),
    )
    out["rest_ms"] = busy - out["flash_fwd_ms"] - out["flash_dq_ms"] - out["flash_dkv_ms"] - out["matmul_ms"]
    out["top"] = [dict(name=k[:80], ms=v) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:16]]
    return out


def phase_training(torch) -> dict:
    cfg = train_config()
    print("training: lr schedule overridden to a constant 1e-4 (the recipe's 100-step warmup "
          "would leave bf16 weights unmoved over 4 steps)", flush=True)
    return run_dense_training(torch, cfg, "training")


def run_dense_training(torch, cfg: dict, label: str) -> dict:
    """The config's steps through the ``finetune`` / ``pretrain`` recipe
    class: each flash kernel launched layers x microbatches x steps times
    (counts set to 0 just before the run, read just after), every loss and
    grad norm finite, every weight matrix moved; then a profile of one step
    and the optimizer's time alone."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.ops import ring_flash as rf
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    acc = cfg["step_scheduler"]["grad_acc_steps"]
    steps = cfg["step_scheduler"]["max_steps"]
    t0 = time.perf_counter()
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    torch.cuda.synchronize()
    params = recipe.state.params
    n_params = sum(p.numel() for p in params)
    layers = cfg["model"]["hf_config"]["num_hidden_layers"]
    print(f"{label} model: {n_params} params bf16, {layers} layers of {cfg['model']['hf_config']['architectures'][0]}"
          f" widths, set up in {time.perf_counter() - t0:.1f}s", flush=True)
    names = [n for n, _ in recipe.model.named_parameters()]
    before = [p.detach().flatten()[::997].clone() for p in params]
    # the main path's run: every count set to 0 just before, read just after
    kernels = (rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv)
    for f in kernels:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("fwd", "dq", "dkv"), (f.launches for f in kernels)))
    want = layers * acc * steps
    if any(n != want for n in launches.values()):
        raise RuntimeError(f"{label}: flash launches {launches}, want {want} (= {layers} layers x {acc} "
                           f"microbatches x {steps} steps) each")
    rows = step_records(cfg["logging"]["metrics_path"])
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise RuntimeError(f"metric rows for steps {[r['step'] for r in rows]}")
    for r in rows:
        if r.get("loss") is None or r.get("grad_norm") is None or r["nonfinite"]:
            raise RuntimeError(f"non-finite step: {r}")
    moved = [n for n, p, b in zip(names, params, before) if not torch.equal(p.detach().flatten()[::997], b)]
    # llama's norm weights start at 1.0, where a bf16 ulp (2^-7) is far
    # above what 4 steps at lr 1e-4 move them (Gemma's zero-centered ones
    # start at 0 and move); every matrix must move
    still = [n for n in names if n not in moved and not n.endswith("norm.weight")]
    if still:
        raise RuntimeError(f"weights unchanged after {steps} steps: {still}")
    seq = cfg["dataset"]["seq_length"]
    tokens = seq * acc * cfg["dataloader"]["global_batch_size"]
    step_s = statistics.median(r["step_time_s"] for r in rows[1:])
    mcfg = recipe.model.config
    windows = [mcfg.layer_window(i) for i in range(layers)] if hasattr(mcfg, "layer_window") else None
    # the tied lm_head is the embedding: its product counts
    embed = 0 if mcfg.tie_embeddings else recipe.model.model.embed_tokens.weight.numel()
    flops = 6 * (n_params - embed) * tokens + acc * attention_flops(cfg, seq, windows)
    out = dict(
        params=n_params, layers=layers, tokens_per_step=tokens, steps=steps, microbatches=acc,
        losses=[r["loss"] for r in rows], grad_norms=[r["grad_norm"] for r in rows],
        compile_time_s=rows[0].get("compile_time_s"), step_ms=1e3 * step_s, tokens_per_s=tokens / step_s,
        model_flop_per_step=flops, model_flops_share_of_989=flops / step_s / BF16_FLOPS,
        wall_s=wall, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        flash_launches=launches, matrices_moved=len(moved),
    )
    out["profile"] = profile_train_step(torch, recipe, acc)
    # the fp32-moment AdamW alone over every parameter (zero grads), after
    # the checks above: how much of the step's elementwise time is the update
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    out["optimizer_update_ms"] = cuda_ms(lambda: recipe.state.optimizer.update(zeros), iters=3, warmup=1)
    del zeros
    print(f"{label}: {json.dumps(out)}", flush=True)
    del recipe, params, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 7: one step's loss and grad norm, flash against sdpa ---------------


def phase_flash_vs_sdpa(torch, cfg=None, label: str = "flash vs sdpa", mb: dict | None = None) -> dict:
    """The training step's loss and fp32 grad norm (one microbatch of the
    config's tokens, or ``mb``, a collated host batch; no update; by default
    the Llama training config) from the same weights and batch, with the
    attention backend switched between the kernels and the plain ``sdpa``.
    The kernels' launches in each pass are counted (``launches``)."""
    import dataclasses

    from automodel_tpu_torch.data.collators import default_collater
    from automodel_tpu_torch.data.sft import MockSFTDataset
    from automodel_tpu_torch.generation.engine import build_auto_from_model_section
    from automodel_tpu_torch.ops import ring_flash as rf
    from automodel_tpu_torch.optim.builders import global_norm_fp32
    from automodel_tpu_torch.training.train_step import make_causal_lm_loss

    cfg = cfg or train_config()
    dev = torch.device(cfg["device"])
    auto = build_auto_from_model_section(cfg["model"], dev, seed=cfg["seed"], trainable=True)
    model = auto.model
    params = list(model.parameters())
    if mb is None:
        ds = MockSFTDataset(**{k: v for k, v in cfg["dataset"].items() if k != "_target_"})
        mb = default_collater([ds[7]])
    mb = {k: torch.from_numpy(v).to(dev) for k, v in mb.items() if hasattr(v, "shape")}
    out = {}
    kernels = (rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv)
    for attn in ("flash", "sdpa"):
        model.backend = dataclasses.replace(model.backend, attn=attn)
        for f in kernels:
            f.launches = 0
        loss_sum, n = make_causal_lm_loss(model, loss="fused_linear_ce")(mb)
        grads = torch.autograd.grad(loss_sum.float(), params)
        denom = n.clamp_min(1).float()
        norm = global_norm_fp32(g.float() / denom for g in grads)
        out[attn] = dict(loss=float(loss_sum.detach() / denom), grad_norm=float(norm),
                         launches=dict(zip(("fwd", "dq", "dkv"), (f.launches for f in kernels))))
        del grads, loss_sum
        torch.cuda.empty_cache()
    f, s = out["flash"], out["sdpa"]
    out["loss_rel"] = abs(f["loss"] - s["loss"]) / abs(s["loss"])
    out["grad_norm_rel"] = abs(f["grad_norm"] - s["grad_norm"]) / abs(s["grad_norm"])
    print(f"one step, {label}: {json.dumps(out)}", flush=True)
    if not all(map(lambda x: x == x and abs(x) != float("inf"), (f["loss"], s["loss"], f["grad_norm"], s["grad_norm"]))):
        raise RuntimeError(f"non-finite loss or grad norm: {out}")
    if out["loss_rel"] > STEP_LOSS_REL_TOL or out["grad_norm_rel"] > STEP_GRAD_NORM_REL_TOL:
        raise RuntimeError(f"{label}: the steps disagree: {out} (limits: loss {STEP_LOSS_REL_TOL}, "
                           f"grad norm {STEP_GRAD_NORM_REL_TOL}, relative)")
    del auto, model, params
    torch.cuda.empty_cache()
    return out


# -- phase 8: grouped matmul against its plain versions -----------------------


def moe_rows(torch, dev, routing: str, seed: int):
    """One 4096-token microbatch at Qwen3-30B-A3B's MoE widths: its token
    rows sorted by expert ([32768, 2048] bf16) and the int32 group sizes.
    ``gate``: a real gate (top-8 of a softmax over 128 experts, normalized)
    over random tokens and a random router; ``balanced``: the fake balanced
    gate; ``skewed``: random rows in groups where the first and last
    experts (and three more) are empty and expert 5 holds a quarter."""
    from automodel_tpu_torch.moe.config import MoEConfig
    from automodel_tpu_torch.moe.gate import fake_balanced_gate, gate

    hf = QWEN3_MOE_A3B
    T, D, E, K = 4096, hf["hidden_size"], hf["num_experts"], hf["num_experts_per_tok"]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)
    if routing == "skewed":
        M = T * K
        w = torch.rand(E, generator=g, device=dev) + 0.05
        w[[0, E - 1, 17, 64, 90, 5]] = 0.0
        sizes = torch.floor(w / w.sum() * (M - M // 4)).long()
        sizes[1] += M - M // 4 - int(sizes.sum())
        sizes[5] = M // 4
        rows = torch.randn((M, D), generator=g, device=dev).to(torch.bfloat16)
        return rows, sizes.to(torch.int32)
    cfg = MoEConfig(num_experts=E, num_experts_per_tok=K, moe_intermediate_size=hf["moe_intermediate_size"],
                    norm_topk_prob=True)
    if routing == "balanced":
        gout = fake_balanced_gate(x, cfg)
    else:
        router = (torch.randn((E, D), generator=g, device=dev) / D**0.5).to(torch.bfloat16)
        gout = gate(x, router, cfg)
    order = torch.argsort(gout.topk_idx.reshape(-1), stable=True)
    return x.index_select(0, order // K), gout.expert_counts


def grouped_bound(kind: str, a, b, gs, n_out: int, out_bytes: int = 2) -> tuple[float, str]:
    """Least time of one launch: 2 flops per routed row and (k, n) pair
    over the bf16 peak, against the bytes (lhs and the second operand read
    once, only the rhs slabs of groups that received rows, the output
    written once) over HBM bandwidth. gmm / gmm_t: a [M, K], b the stacked
    rhs, output [M, n_out] bf16; tgmm: a [M, K], b dout [M, N], output
    [G, K, N] of ``out_bytes`` an element (4 fp32, 2 bf16)."""
    M, K = a.shape
    rows = int(gs.sum())
    G = gs.shape[0]
    if kind == "tgmm":
        N = b.shape[1]
        nbytes = a.numel() * 2 + b.numel() * 2 + G * K * N * out_bytes
    else:
        N = n_out
        nbytes = a.numel() * 2 + int((gs > 0).sum()) * K * N * 2 + M * N * 2
    t_ops, t_bytes = 2 * rows * K * N / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def grouped_library_ms(torch, kind: str, a, b, gs, out_dtype=None):
    """``torch._grouped_mm`` on the same operands (a yardstick only; the
    port never calls it), or None where this torch has none or refuses
    (tgmm's fp32 output may be refused: its output is bf16)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    kw = {} if out_dtype in (None, torch.bfloat16) else dict(out_dtype=out_dtype)
    calls = dict(
        gmm=lambda: fn(a, b, offs=offs),
        gmm_t=lambda: fn(a, b.transpose(-2, -1), offs=offs),
        tgmm=lambda: fn(a.t(), b, offs=offs, **kw),
    )
    try:
        return cuda_ms(calls[kind], iters=20)
    except (RuntimeError, TypeError, ValueError) as e:
        print(f"torch._grouped_mm refused the {kind} case ({out_dtype}): {str(e)[:200]}", flush=True)
        return None


def phase_grouped_kernels(torch, dev) -> dict:
    """gmm, gmm_t and tgmm (both output types) against their plain versions
    at Qwen3-30B-A3B's MoE shapes (four routings) and gmm / gmm_t at
    gpt-oss-20b's recompute shapes (K3's backward), timed at the gate-routed
    cases; tgmm's bf16 output must also equal its fp32 output cast to bf16
    bit for bit."""
    from automodel_tpu_torch.ops import grouped_matmul as gm

    hf = QWEN3_MOE_A3B
    D, I, E = hf["hidden_size"], hf["moe_intermediate_size"], hf["num_experts"]
    g = torch.Generator(device=dev).manual_seed(100)
    bf16, fp32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    w_gu = randn(E, D, 2 * I, scale=D**-0.5)
    w_dn = randn(E, I, D, scale=I**-0.5)
    results = []
    for ci, (case, routing) in enumerate((("gate", "gate"), ("balanced", "balanced"), ("skewed", "skewed"),
                                          ("K=N=1000", "gate"), ("gpt-oss", "gpt-oss"))):
        # name -> (kind, a, b, n_out or None, output dtype)
        if case == "gpt-oss":  # K3's backward: gu = gmm(x, gate_up), dmid = gmm(dy, down, transpose_rhs)
            xs, gs = gpt_oss_rows(torch, dev, "gate", seed=ci)
            M, Do, Io, Eo = xs.shape[0], GPT_OSS_20B["hidden_size"], GPT_OSS_20B["intermediate_size"], gs.shape[0]
            launches = dict(gmm=("gmm", xs, randn(Eo, Do, 2 * Io, scale=Do**-0.5), 2 * Io, bf16),
                            gmm_t=("gmm_t", randn(M, Do), randn(Eo, Io, Do, scale=Io**-0.5), Io, bf16))
        else:
            xs, gs = moe_rows(torch, dev, routing, seed=ci)
            M = xs.shape[0]
            if case == "K=N=1000":
                w_odd = randn(E, 1000, 1000, scale=1000**-0.5)
                lhs, dy = randn(M, 1000), randn(M, 1000)
                launches = dict(gmm=("gmm", lhs, w_odd, 1000, bf16), gmm_t=("gmm_t", randn(M, 1000), w_odd, 1000, bf16),
                                tgmm=("tgmm", lhs, dy, None, fp32), tgmm_bf16=("tgmm", lhs, dy, None, bf16))
            else:
                dgu = randn(M, 2 * I)
                launches = dict(gmm=("gmm", xs, w_gu, 2 * I, bf16), gmm_t=("gmm_t", dgu, w_gu, D, bf16),
                                tgmm=("tgmm", xs, dgu, None, fp32), tgmm_bf16=("tgmm", xs, dgu, None, bf16))
                if case == "gate":  # the down projection's launches as well
                    h, dy = randn(M, I), randn(M, D)
                    launches.update(gmm_down=("gmm", h, w_dn, D, bf16), gmm_t_down=("gmm_t", dy, w_dn, I, bf16),
                                    tgmm_down=("tgmm", h, dy, None, fp32), tgmm_bf16_down=("tgmm", h, dy, None, bf16))
        timed = case in ("gate", "gpt-oss")
        # the MoE layer builds the plan once and passes it to its four gmm
        # launches (ops/grouped_matmul.ragged_dot), so gmm is timed with it given
        plan = gm.gmm_plan(gs, M)
        for name, (kind, a, b, n_out, dt) in launches.items():
            if kind == "tgmm":
                run = lambda a=a, b=b, dt=dt: gm.tgmm(a, b, gs, dt)
                plain = lambda a=a, b=b, dt=dt: gm._tgmm_plain(a, b, gs, dt)
            else:
                t = kind == "gmm_t"
                run = lambda a=a, b=b, t=t: gm.gmm(a, b, gs, transpose_rhs=t, plan=plan)
                plain = lambda a=a, b=b, t=t: gm._gmm_plain(a, b, gs, transpose_rhs=t)
            out = run()
            torch.cuda.synchronize()
            ref = plain()
            if not bool(torch.isfinite(out.float()).all()):
                raise RuntimeError(f"grouped kernel {name} produced non-finite values in case {case}")
            # tgmm in fp32: the order of an fp32 sum; in bf16 (and gmm): one bf16 ulp of an fp32 sum
            tol = TGMM_ROW_TOL if kind == "tgmm" and dt == fp32 else GMM_ROW_TOL
            row = dict(case=case, launch=name, kind=kind, out_dtype=str(dt).replace("torch.", ""), M=M,
                       K=a.shape[1], N=b.shape[1] if kind == "tgmm" else n_out, G=gs.shape[0],
                       groups_with_rows=int((gs > 0).sum()), largest_group=int(gs.max()),
                       max_abs_err=float((out.float() - ref.float()).abs().max()),
                       max_row_rel_err=row_rel_err(out, ref), limit=tol)
            row["ok"] = row["max_row_rel_err"] <= tol
            if kind == "tgmm" and dt == bf16:  # the same fp32 sum, rounded once
                row["equals_fp32_output_cast"] = bool(torch.equal(out, gm.tgmm(a, b, gs).to(bf16)))
                row["ok"] = row["ok"] and row["equals_fp32_output_cast"]
            del out, ref
            if timed:
                row["ms"] = cuda_ms(run, iters=20)
                row["plain_ms"] = cuda_ms(plain, iters=2, warmup=1)
                row["bound_ms"], row["bound_by"] = grouped_bound(kind, a, b, gs, n_out, 2 if dt == bf16 else 4)
                row["library_ms"] = grouped_library_ms(torch, kind, a, b, gs, dt)
                if kind != "tgmm":
                    # the kernel's two orders of a group's items (gmm picks
                    # one from the shape), and the plan
                    t = kind == "gmm_t"
                    row["plan_ms"] = cuda_ms(lambda: gm.gmm_plan(gs, M), iters=20)
                    row["order"] = "n tiles" if gm._lib().grouped_matmul_gmm_n_major(a.shape[1], n_out) else "units"
                    row["ms_by_order"] = {o: cuda_ms(lambda nm=nm: gm._gmm_launch(a, b, gs, plan, n_out, t, nm),
                                                     iters=20) for nm, o in ((False, "units"), (True, "n tiles"))}
            results.append(row)
            print(f"kernel grouped_matmul vs plain: {json.dumps(row)}", flush=True)
            torch.cuda.empty_cache()
        del xs, launches, plan
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise RuntimeError(f"grouped-matmul kernels disagree with their plain versions: {bad}")
    return {"cases": results}


# -- phase 9: MoE training at Qwen3-30B-A3B widths ------------------------------


def moe_train_config() -> dict:
    """PRETRAIN_QWEN3_MOE_A3B on the card with the smoke's step plan and a
    constant lr of 3e-4 (the example's peak): its 2000-step warmup would
    leave the bf16 weights unmoved over 4 steps."""
    cfg = json.loads(json.dumps(PRETRAIN_QWEN3_MOE_A3B))
    cfg["device"] = "cuda"
    cfg["step_scheduler"].update(max_steps=MOE_STEPS, log_every_steps=1)
    cfg["optimizer"].update(lr=3e-4, lr_schedule=dict(style="constant"))
    here = __import__("pathlib").Path(__file__).resolve().parent
    cfg["logging"]["metrics_path"] = str(here / "runs" / "chip_smoke" / f"moe_metrics_{time.time_ns()}.jsonl")
    return cfg


# kernel families of the MoE profiles, by the kernels' names
QWEN_FAMILIES = dict(
    gmm_ms=lambda k: "gmm_kernel<false>" in k and "tgmm_kernel" not in k,
    gmm_t_ms=lambda k: "gmm_kernel<true>" in k and "tgmm_kernel" not in k,
    tgmm_ms=lambda k: "tgmm_kernel" in k,
    flash_fwd_ms=lambda k: "flash_fwd_kernel" in k,
    flash_dq_ms=lambda k: "flash_dq_kernel" in k,
    flash_dkv_ms=lambda k: "flash_dkv_kernel" in k,
)
# on the GPT-OSS path K2's tgmm wrapper never runs: tgmm_ms sums K3b's
# product (dW gate | up, on lhs and dg | du) and K3c's (dWd, on mid and
# dy), both tgmm_kernel<true>; gmm_t_ms holds K3d's product (dlhs, K = 2I)
# beside K2's dmid: the kernels share their names. K3a's two launches and
# K3b's bias sums have names of their own.
GPT_OSS_FAMILIES = dict(
    QWEN_FAMILIES,
    fem_fwd_gu_act_ms=lambda k: "gmm_act_kernel" in k,
    fem_fwd_down_ms=lambda k: "gmm_bias_kernel" in k,
    fem_bwd_dgub_ms=lambda k: "bwd_dgub_kernel" in k,
    fem_bwd_act_ms=lambda k: "bwd_act_kernel" in k,
    fem_bwd_ddb_ms=lambda k: "bwd_ddb_kernel" in k,
)
GEMM_NAMES = ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")


def profile_moe_step(torch, recipe, acc: int, families: dict) -> dict:
    """One more step under torch.profiler: device ms by kernel family (the
    port's kernels by name, cuBLAS, and the rest) and the device's idle
    share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from automodel_tpu_torch.data.collators import stack_microbatches

    dl = recipe.dataloader
    batch = recipe._place(stack_microbatches([dl.batch_for(0, (100 + i) % len(dl)) for i in range(acc)]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recipe.train_step(recipe.state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return {"profile": "no device events from torch.profiler: not measured", "wall_ms": wall_ms}
    ours = list(families.values())
    families = dict(families, cublas_ms=lambda k: not any(f(k) for f in ours)
                    and "flash" not in k and "gmm_kernel" not in k and any(s in k for s in GEMM_NAMES))
    busy = sum(by_name.values())
    out = dict(profiled_step_ms=wall_ms, device_busy_ms=busy, idle_share=1.0 - busy / wall_ms)
    for fam, pred in families.items():
        out[fam] = sum(v for k, v in by_name.items() if pred(k.lower()))
    out["rest_ms"] = busy - sum(out[f] for f in families)
    out["top"] = [dict(name=k[:80], ms=v) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:16]]
    return out


def run_moe_training(torch, cfg: dict, label: str, kernels: dict, want: dict, families: dict,
                     inspect=None, time_optimizer: bool = True) -> dict:
    """4 steps of an MoE config through the ``pretrain`` recipe class: every
    loss, grad norm and aux loss finite; every kernel launched its ``want``
    count (set to 0 just before the run, read just after); every weight
    matrix, bias and sink moved, and every expert slab that received rows
    reaching the loss; then a profile of one step and the optimizer's time
    (``time_optimizer``: its fp32 zero grads take 4 bytes a parameter).
    ``inspect(recipe)``, called before the run, returns a function called
    after it whose dict joins the result."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.moe import layer as moe_layer
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    acc = cfg["step_scheduler"]["grad_acc_steps"]
    steps = cfg["step_scheduler"]["max_steps"]
    t0 = time.perf_counter()
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    torch.cuda.synchronize()
    params = recipe.state.params
    n_params = sum(p.numel() for p in params)
    layers = cfg["model"]["hf_config"]["num_hidden_layers"]
    print(f"{label} model: {n_params} params bf16, {layers} layers, set up in {time.perf_counter() - t0:.1f}s",
          flush=True)
    names = [n for n, _ in recipe.model.named_parameters()]
    # the stacked expert weights are kept whole on the host, so every
    # [E, ...] slab is compared in full: a slab fed a few rows moves only a
    # few of its elements by a bf16 ulp in 4 steps
    before = [p.detach().to("cpu", copy=True) if ".experts." in n else p.detach().flatten()[::997].clone()
              for n, p in zip(names, params)]
    # which expert slabs receive rows over the run: each MoE layer's picks,
    # and each microbatch's labels, in the order the run makes them. In the
    # last layer a token without a label (the masked prompt quarter of a
    # MockSFTDataset sample, and every sample's last token) has no gradient
    # at all, since nothing after that layer reads its row: there only
    # labeled tokens' rows count (tests/test_torch_moe_model.py::
    # test_last_layer_expert_fed_only_unlabeled_rows_gets_exactly_zero_grad).
    picks: dict[int, list] = {}
    labels_seen: list = []
    real_gate, real_place = moe_layer.gate, recipe._place

    def recording_gate(x, weight, *a, **kw):
        out = real_gate(x, weight, *a, **kw)
        picks.setdefault(weight.data_ptr(), []).append(out.topk_idx)
        return out

    def recording_place(stacked):
        placed = real_place(stacked)
        labels_seen.extend(placed["labels"].unbind(0))
        return placed

    moe_layer.gate, recipe._place = recording_gate, recording_place
    after = inspect(recipe) if inspect is not None else None
    try:
        # the main path's run: every count set to 0 just before, read just after
        for f, attr in kernels.values():
            setattr(f, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(f, attr) for k, (f, attr) in kernels.items()}
    finally:
        # delete the instance attribute: assigning the bound method back would
        # make a reference cycle that keeps the model alive after the phase
        moe_layer.gate = real_gate
        del recipe._place
    if launches != want:
        raise RuntimeError(f"{label}: kernel launches {launches}, want {want} ({layers} layers x {acc} microbatches "
                           f"x {steps} steps)")
    rows = step_records(cfg["logging"]["metrics_path"])
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise RuntimeError(f"metric rows for steps {[r['step'] for r in rows]}")
    for r in rows:
        if any(r.get(k) is None for k in ("loss", "grad_norm", "moe_aux_loss")) or r["nonfinite"]:
            raise RuntimeError(f"non-finite step: {r}")
    blocks = recipe.model.moe_layers()
    E = blocks[0].cfg.num_experts
    fed_rows_by_layer = []
    for li, blk in enumerate(blocks):
        router = getattr(blk, blk.router_name)
        n_rows = torch.zeros(E, dtype=torch.long, device=router.weight.device)
        for idx, labels in zip(picks[router.weight.data_ptr()], labels_seen):
            keep = torch.ones_like(idx) if li < len(blocks) - 1 else (labels.reshape(-1, 1) != -100).expand_as(idx)
            n_rows.scatter_add_(0, idx.reshape(-1), keep.reshape(-1).long())
        fed_rows_by_layer.append(n_rows.cpu())
    moe_layer_of = {id(blk): li for li, blk in enumerate(blocks)}
    still, slabs_moved, slabs_fed, fed_rows = [], 0, 0, []
    for (n, p), b in zip(recipe.model.named_parameters(), before):
        if ".experts." in n:
            rows_e = fed_rows_by_layer[moe_layer_of[id(recipe.model.model.layers[int(n.split(".")[2])].mlp)]]
            fed = rows_e > 0
            moved = (p.detach().cpu() != b).flatten(1).any(dim=1)
            slabs_fed += int(fed.sum())
            slabs_moved += int((moved & fed).sum())
            fed_rows += rows_e[fed].tolist()
            bad = torch.nonzero(fed & ~moved).flatten().tolist()
            if bad:
                still.append(f"{n}: experts {bad} (rows reaching the loss {rows_e[bad].tolist()})")
        elif not n.endswith("norm.weight") and torch.equal(p.detach().flatten()[::997], b):
            still.append(n)
    if still:
        raise RuntimeError(f"weights unchanged after {steps} steps: {still}")
    seq = cfg["dataset"]["seq_length"]
    tokens = seq * acc * cfg["dataloader"]["global_batch_size"]
    step_s = statistics.median(r["step_time_s"] for r in rows[1:])
    out = dict(
        params=n_params, layers=layers, tokens_per_step=tokens, steps=steps, microbatches=acc,
        losses=[r["loss"] for r in rows], grad_norms=[r["grad_norm"] for r in rows],
        moe_aux_losses=[r["moe_aux_loss"] for r in rows],
        expert_load_imbalance=[r["expert_load_imbalance"] for r in rows],
        expert_load_imbalance_per_layer=rows[-1]["expert_load_imbalance_per_layer"],
        compile_time_s=rows[0].get("compile_time_s"), step_ms=1e3 * step_s, tokens_per_s=tokens / step_s,
        wall_s=wall, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
        expert_slabs_fed=slabs_fed, expert_slabs_moved=slabs_moved, fewest_rows_of_a_fed_slab=min(fed_rows),
    )
    del before
    if after is not None:
        out.update(after())
        after = None
    out["profile"] = profile_moe_step(torch, recipe, acc, families)
    if time_optimizer:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        out["optimizer_update_ms"] = cuda_ms(lambda: recipe.state.optimizer.update(zeros), iters=3, warmup=1)
        del zeros
    print(f"{label}: {json.dumps(out)}", flush=True)
    del recipe, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe_training(torch) -> dict:
    from automodel_tpu_torch.ops import grouped_matmul as gm
    from automodel_tpu_torch.ops import ring_flash as rf

    cfg = moe_train_config()
    print("moe training: lr schedule overridden to a constant 3e-4 (the example's 2000-step warmup "
          "would leave bf16 weights unmoved over 4 steps)", flush=True)
    kernels = dict(gmm=(gm.gmm, "launches"), gmm_t=(gm.gmm, "launches_t"), tgmm=(gm.tgmm, "launches"),
                   flash_fwd=(rf.flash_block_fwd, "launches"), flash_dq=(rf.flash_block_dq, "launches"),
                   flash_dkv=(rf.flash_block_dkv, "launches"))
    # two gmm, gmm_t and tgmm launches per MoE layer
    per = dict(gmm=2, gmm_t=2, tgmm=2, flash_fwd=1, flash_dq=1, flash_dkv=1)
    n = cfg["model"]["hf_config"]["num_hidden_layers"] * cfg["step_scheduler"]["grad_acc_steps"] * MOE_STEPS
    return run_moe_training(torch, cfg, "moe training", kernels, {k: v * n for k, v in per.items()}, QWEN_FAMILIES)


# -- phase 13: GPT-OSS training at gpt-oss-20b widths ------------------------------


def gpt_oss_train_config() -> dict:
    """PRETRAIN_GPT_OSS_20B on the card with a JSONL path of its own (its
    4 steps, its constant lr of 1e-4 and its per-step logging are the
    config's)."""
    cfg = json.loads(json.dumps(PRETRAIN_GPT_OSS_20B))
    cfg["device"] = "cuda"
    here = __import__("pathlib").Path(__file__).resolve().parent
    cfg["logging"]["metrics_path"] = str(here / "runs" / "chip_smoke" / f"gpt_oss_metrics_{time.time_ns()}.jsonl")
    return cfg


def fused_kernel_counters() -> dict:
    from automodel_tpu_torch.ops import fused_expert_mlp as fem
    from automodel_tpu_torch.ops import grouped_matmul as gm
    from automodel_tpu_torch.ops import ring_flash as rf

    return dict(fem_fwd=(fem.fwd, "launches"), fem_bwd_gu=(fem.bwd_gu, "launches"),
                fem_bwd_act=(fem.bwd_act, "launches"), fem_bwd_dwd=(fem.bwd_dwd, "launches"),
                fem_bwd_dx=(fem.bwd_dx, "launches"),
                gmm=(gm.gmm, "launches"), gmm_t=(gm.gmm, "launches_t"), tgmm=(gm.tgmm, "launches"),
                flash_fwd=(rf.flash_block_fwd, "launches"), flash_dq=(rf.flash_block_dq, "launches"),
                flash_dkv=(rf.flash_block_dkv, "launches"))


def phase_gpt_oss_training(torch) -> dict:
    cfg = gpt_oss_train_config()
    n = (cfg["model"]["hf_config"]["num_hidden_layers"] * cfg["step_scheduler"]["grad_acc_steps"]
         * cfg["step_scheduler"]["max_steps"])
    # one call of each K3 wrapper (the backward's elementwise pass once,
    # bwd_dwd, bwd_dx and bwd_gu given its outputs), one K2 gmm (the gu
    # recompute) and gmm_t (dmid) per layer and microbatch; no call of K2's
    # tgmm wrapper (K3b's and K3c's tgmm launches count in fem_bwd_gu and
    # fem_bwd_dwd, K3d's gmm in fem_bwd_dx, K3a's two in fem_fwd)
    want = dict(fem_fwd=n, fem_bwd_gu=n, fem_bwd_act=n, fem_bwd_dwd=n, fem_bwd_dx=n, gmm=n, gmm_t=n, tgmm=0,
                flash_fwd=n, flash_dq=n, flash_dkv=n)
    return run_moe_training(torch, cfg, "gpt-oss training", fused_kernel_counters(), want, GPT_OSS_FAMILIES)


# -- phases 15 and 16: Gemma 2 training at gemma-2-9b widths ----------------------


def gemma_train_config() -> dict:
    """PRETRAIN_GEMMA2_9B on the card with a JSONL path of its own (its 4
    steps, its constant lr of 1e-4 and its per-step logging are the
    config's)."""
    cfg = json.loads(json.dumps(PRETRAIN_GEMMA2_9B))
    cfg["device"] = "cuda"
    here = __import__("pathlib").Path(__file__).resolve().parent
    cfg["logging"]["metrics_path"] = str(here / "runs" / "chip_smoke" / f"gemma2_metrics_{time.time_ns()}.jsonl")
    return cfg


def phase_gemma_training(torch) -> dict:
    """4 steps of 2 x 8192 tokens at gemma-2-9b widths cut to 8 layers
    (sliding and full alternating) through the flash kernels with the cap
    of 50 inside them: each flash kernel 8 x 2 x 4 launches."""
    return run_dense_training(torch, gemma_train_config(), "gemma2 training")


def phase_gemma_flash_vs_sdpa(torch) -> dict:
    """One step at 2 layers of gemma-2-9b widths (a sliding and a full
    layer) and 8192 tokens, the flash kernels against plain ``sdpa``."""
    cfg = gemma_train_config()
    cfg["model"]["hf_config"]["num_hidden_layers"] = 2
    return phase_flash_vs_sdpa(torch, cfg, "gemma2 flash vs sdpa")


# -- phase 17: checkpoint round trip --------------------------------------------

# Llama-3-8B widths cut to 2 layers: disk sets the size. 1.487 B parameters:
# 2.97 GB of bf16 weights, ~11.9 GB of fp32 moments, ~15 GB a DCP state and
# ~3 GB a consolidated save; two step dirs, a consolidation and the
# page-cached reads peak near 40 GB of disk.
CKPT_LAYERS = 2
CKPT_DISK_NEED_GB = 40.0


def ckpt_train_config(root, tag: str, max_steps: int, checkpoint: bool) -> dict:
    """The training phase's config (train_config) at CKPT_LAYERS layers with
    its metrics under ``root``; with ``checkpoint`` on: a save every 2
    steps with the consolidated HF export, keep_last_k 1, and a validation
    set of 2 batches every 2 steps."""
    cfg = train_config()
    cfg["model"]["hf_config"]["num_hidden_layers"] = CKPT_LAYERS
    cfg["step_scheduler"]["max_steps"] = max_steps
    cfg["logging"]["metrics_path"] = str(root / f"{tag}.jsonl")
    if checkpoint:
        cfg["checkpoint"] = dict(enabled=True, checkpoint_dir=str(root / "ckpt"), save_consolidated=True,
                                 keep_last_k=1)
        cfg["step_scheduler"].update(ckpt_every_steps=2, val_every_steps=2)
        cfg["validation_dataset"] = dict(cfg["dataset"], num_samples=2, seed=1)
    return cfg


def run_recipe(torch, cfg: dict):
    """The ``finetune`` CLI's recipe class over ``cfg`` → (recipe, JSONL
    rows, flash launches of the run, seconds)."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.ops import ring_flash as rf
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    kernels = (rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv)
    # the main path's run: every count set to 0 just before, read just after
    for f in kernels:
        f.launches = 0
    t0 = time.perf_counter()
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("fwd", "dq", "dkv"), (f.launches for f in kernels)))
    rows = [json.loads(line) for line in open(cfg["logging"]["metrics_path"])]
    return recipe, rows, launches, wall


def train_rows(rows: list) -> dict:
    return {r["step"]: r for r in rows if "loss" in r}


# the records the default-on telemetry adds beside the step rows
TELEMETRY_EVENTS = ("cost_attribution", "trace_capture", "goodput_tail", "nonfinite_step")


def step_records(path) -> list:
    """A metrics JSONL's step rows, without the event records."""
    return [r for r in map(json.loads, open(path)) if "event" not in r]


def gbps(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9 if seconds > 0 else float("nan")


def phase_checkpoint(torch) -> dict:
    """Checkpoints and HF weights in and out at Llama-3-8B widths cut to
    CKPT_LAYERS layers: two unbroken 4-step runs (the card's own spread), a
    run broken at step 2 and resumed by a fresh recipe object, the audit,
    and serving from the consolidated save."""
    import shutil

    from automodel_tpu_torch.auto_model import from_pretrained
    from automodel_tpu_torch.checkpoint.consolidate import consolidate
    from automodel_tpu_torch.cli.app import main as cli_main
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.ops.paged_attention import paged_attend
    from automodel_tpu_torch.serving.server import build_engine

    here = __import__("pathlib").Path(__file__).resolve().parent
    root = here / "runs" / "chip_smoke" / f"ckpt_{time.time_ns()}"
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    card = card_line()
    try:
        disk = shutil.disk_usage(root)
        print(f"checkpoint: disk under {root.parent}: {disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f} GB",
              flush=True)
        if disk.free / 1e9 < CKPT_DISK_NEED_GB:
            raise RuntimeError(f"checkpoint phase needs ~{CKPT_DISK_NEED_GB} GB of disk, {disk.free / 1e9:.1f} free")
        acc, layers = TRAIN_ACC, CKPT_LAYERS
        out: dict = dict(layers=layers, card=card, disk_free_gb=disk.free / 1e9, disk_total_gb=disk.total / 1e9)

        # 1. the unbroken run, twice: the card's own run-to-run spread
        finals, runs = [], []
        for tag in ("unbroken_a", "unbroken_b"):
            recipe, rows, launches, wall = run_recipe(torch, ckpt_train_config(root, tag, TRAIN_STEPS, False))
            want = layers * acc * TRAIN_STEPS
            if any(n != want for n in launches.values()):
                raise RuntimeError(f"{tag}: flash launches {launches}, want {want} each")
            runs.append(train_rows(rows))
            finals.append([p.detach().to("cpu", copy=True) for p in recipe.state.params])
            out["params"] = sum(p.numel() for p in recipe.state.params)
            del recipe
            gc.collect()
            torch.cuda.empty_cache()
        a, b = runs
        steps = list(range(1, TRAIN_STEPS + 1))
        if sorted(a) != steps or sorted(b) != steps:
            raise RuntimeError(f"unbroken runs logged steps {sorted(a)} and {sorted(b)}")
        keys = ("loss", "grad_norm")
        bitwise = all(a[s][k] == b[s][k] for s in steps for k in keys) and all(
            torch.equal(x, y) for x, y in zip(*finals))
        spread = max(abs(a[1][k] - b[1][k]) / abs(a[1][k]) for k in keys)
        out.update(unbroken_losses=[a[s]["loss"] for s in steps], unbroken_grad_norms=[a[s]["grad_norm"] for s in steps],
                   unbroken_bitwise=bitwise, unbroken_step1_rel_spread=spread)
        print(f"checkpoint: two unbroken runs {'agree bit for bit' if bitwise else 'differ'} "
              f"(step-1 relative spread {spread}) | {card}", flush=True)

        # 2. the broken run: stop at step 2, resume from a fresh recipe object
        ck_root = root / "ckpt"
        recipe, rows1, l1, wall1 = run_recipe(torch, ckpt_train_config(root, "broken", 2, True))
        save2 = dict(recipe.checkpointer.last_save)
        del recipe
        gc.collect()
        torch.cuda.empty_cache()
        recipe, rows2, l2, wall2 = run_recipe(torch, ckpt_train_config(root, "broken", TRAIN_STEPS, True))
        val_fwd = 2 * layers  # 2 validation batches through the flash forward
        for tag, launches in (("steps 1-2", l1), ("steps 3-4", l2)):
            want = dict(fwd=layers * acc * 2 + val_fwd, dq=layers * acc * 2, dkv=layers * acc * 2)
            if launches != want:
                raise RuntimeError(f"broken run {tag}: flash launches {launches}, want {want}")
        rows = [json.loads(line) for line in open(root / "broken.jsonl")]
        resumes = [r for r in rows if r.get("event") == "resume"]
        if [r["resumed_from_step"] for r in resumes] != [2]:
            raise RuntimeError(f"resume records {resumes}, want one from step 2")
        vals = [r for r in rows if "val_loss" in r]
        if [r["step"] for r in vals] != [2, 4] or not all(math.isfinite(r["val_loss"]) for r in vals):
            raise RuntimeError(f"validation records {vals}, want finite val_loss at steps 2 and 4")
        c = train_rows(rows)
        errs = {k: max(abs(c[s][k] - a[s][k]) / abs(a[s][k]) for s in (3, 4)) for k in keys}
        same_params = all(torch.equal(p.detach().cpu(), x) for p, x in zip(recipe.state.params, finals[0]))
        resumed_bitwise = all(c[s][k] == a[s][k] for s in (3, 4) for k in keys) and same_params
        if bitwise and not resumed_bitwise:
            raise RuntimeError(f"resumed steps 3-4 differ from the unbroken run, which repeats bit for bit: "
                               f"rel errors {errs}, final params equal {same_params}")
        if not bitwise and max(errs.values()) > 4 * spread:
            raise RuntimeError(f"resumed steps 3-4 off the unbroken run by {errs}, beyond 4x the step-1 spread {spread}")
        best = json.loads((ck_root / "BEST.json").read_text())
        if not (ck_root / best["dir"] / "MANIFEST.json").exists():
            raise RuntimeError(f"BEST.json names {best['dir']}, which is not committed")
        step4 = ck_root / "epoch_0_step_4"
        save4, load = dict(recipe.checkpointer.last_save), dict(recipe.checkpointer.last_load)
        out.update(resumed_losses=[c[s]["loss"] for s in (3, 4)], resumed_grad_norms=[c[s]["grad_norm"] for s in (3, 4)],
                   resumed_bitwise=resumed_bitwise, resumed_rel_err=errs, val_losses=[r["val_loss"] for r in vals],
                   best=best["dir"], broken_wall_s=[wall1, wall2], save_step2=save2, save_step4=save4, resume_load=load)

        # 3. the audit, through the CLI's own function
        t0 = time.perf_counter()
        rc = cli_main(["verify-ckpt", str(ck_root)])
        out["verify_s"] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"verify-ckpt exited {rc} on the committed tree")
        t0 = time.perf_counter()
        consolidated = consolidate(step4, root / "consolidated")
        out["consolidate_s"] = time.perf_counter() - t0
        same = [f.name for f in (step4 / "hf").glob("*.safetensors")
                if (consolidated / f.name).read_bytes() == f.read_bytes()]
        if not same or len(same) != len(list((step4 / "hf").glob("*.safetensors"))):
            raise RuntimeError("the offline consolidation's safetensors differ from the run's hf/ save")
        out["consolidate_file_bytes"] = sum(f.stat().st_size for f in consolidated.glob("*.safetensors"))

        # 4. serve from the consolidated save
        trained = recipe.model
        dev = recipe.device
        g = torch.Generator().manual_seed(17)
        ids = torch.randint(1, LLAMA3_8B["vocab_size"], (1, 512), generator=g).to(dev)
        with torch.no_grad():
            ref = trained(ids)
        backend = ckpt_train_config(root, "x", 1, False)["model"]["backend"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = from_pretrained(step4 / "hf", backend, device=dev)
        torch.cuda.synchronize()
        out["from_pretrained_s"] = time.perf_counter() - t0
        out["from_pretrained_bytes"] = sum(p.numel() * p.element_size() for p in loaded.model.state_dict().values())
        del loaded
        scfg = serve_config("bf16")
        scfg["model"] = dict(pretrained_model_name_or_path=str(step4 / "hf"), backend=backend)
        scfg["serving"].update(num_blocks=1024)
        engine = build_engine(ConfigNode(scfg))
        with torch.no_grad():
            served = engine.auto.model(ids)
        if not torch.equal(served, ref):
            diff = float((served.float() - ref.float()).abs().max())
            raise RuntimeError(f"logits served from hf/ differ from the trained model's (max |diff| {diff})")
        out["logits_bitwise"] = True
        del trained, recipe, ref, served
        gc.collect()
        torch.cuda.empty_cache()
        prompts = [torch.randint(1, LLAMA3_8B["vocab_size"], (n,), generator=g).tolist() for n in (128, 256, 384, 512)]
        paged_attend.launches = 0
        for i, p in enumerate(prompts):
            engine.submit(p, request_id=f"c{i}", max_new_tokens=MAX_NEW)
        recs = engine.run()
        torch.cuda.synchronize()
        launches = paged_attend.launches
        reasons = {r["completion_reason"] for r in recs}
        if len(recs) != 4 or not reasons <= {"length", "stop"}:
            raise RuntimeError(f"served from hf/: {len(recs)} records ending {reasons}")
        if launches == 0 or launches != engine.decode_forwards * layers:
            raise RuntimeError(f"paged kernel launched {launches} times for {engine.decode_forwards} "
                               f"decode forwards x {layers} layers")
        out.update(served_requests=len(recs), served_prompt_tokens=[len(p) for p in prompts],
                   paged_attend_launches=launches, decode_forwards=engine.decode_forwards)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        # 5. a hard-linked copy of the step dir with its DCP data file cut by
        # one byte (last: the link shares the original's bytes) must fail
        bad = root / "truncated" / step4.name
        for f in step4.rglob("*"):
            if f.is_file():
                (bad / f.relative_to(step4)).parent.mkdir(parents=True, exist_ok=True)
                os.link(f, bad / f.relative_to(step4))
        data = max((bad / "state").iterdir(), key=lambda f: f.stat().st_size)
        os.truncate(data, data.stat().st_size - 1)
        rc = cli_main(["verify-ckpt", str(bad)])
        if rc == 0:
            raise RuntimeError("verify-ckpt passed a step dir whose state file lost a byte")
        out["truncated_verify_rc"] = rc

        s4, ld = save4, load
        print(f"checkpoint times | {card}: save at step 4: DCP state {s4.get('state_bytes')} B in "
              f"{s4.get('state_s')} s ({gbps(s4.get('state_bytes', 0), s4.get('state_s', 0))} GB/s), hf/ "
              f"{s4.get('hf_bytes')} B in {s4.get('hf_s')} s ({gbps(s4.get('hf_bytes', 0), s4.get('hf_s', 0))} GB/s), "
              f"manifest {s4.get('manifest_s')} s; resume load: verify {ld.get('verify_s')} s, DCP state "
              f"{ld.get('state_bytes')} B in {ld.get('state_s')} s ({gbps(ld.get('state_bytes', 0), ld.get('state_s', 0))} "
              f"GB/s); from_pretrained {out['from_pretrained_bytes']} B in {out['from_pretrained_s']} s "
              f"({gbps(out['from_pretrained_bytes'], out['from_pretrained_s'])} GB/s); offline consolidation "
              f"{out['consolidate_file_bytes']} B of files in {out['consolidate_s']} s "
              f"({gbps(out['consolidate_file_bytes'], out['consolidate_s'])} GB/s); verify-ckpt of the tree "
              f"{out['verify_s']} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"checkpoint round trip: {json.dumps(out)}", flush=True)
    print(f"checkpoint phase: {out['phase_s']:.1f} s", flush=True)
    return out


# -- phase 18: the benchmark llm recipe ------------------------------------------


def draft_forwards(engine) -> int:
    """The draft forwards a speculative engine ran: k + 1 a round."""
    spec = engine.config.speculative
    return (spec.k + 1) * engine.spec_rounds if spec.enabled else 0


def spec_paged_launches(engines) -> tuple[int, str]:
    """The paged kernel's launches the engines' forwards imply: each
    target decode or verify forward once a target layer, each draft
    forward (draft_k + 1 a round) once a draft layer. → (count, the
    formula with its numbers)."""
    total, terms = 0, []
    for e in engines:
        layers = e.model.config.num_layers
        total += (e.decode_forwards + e.spec_rounds) * layers
        terms.append(f"({e.decode_forwards} decode + {e.spec_rounds} verify forwards) x {layers} layers")
        if e.config.speculative.enabled:
            d_layers, drafts = e.draft_auto.model.config.num_layers, draft_forwards(e)
            total += drafts * d_layers
            terms.append(f"{drafts} draft forwards x {d_layers} draft layers")
    return total, " + ".join(terms) + f" = {total}"


# phase 18's legs on the card: 2 warmup and 5 measured steps (the configs
# say 3 and 10), for the script's time; the legs' step counts are checked
# against these
BENCH_STEPS_ON_CARD = dict(warmup_steps=2, measure_steps=5)


def bench_config(base: dict, tag: str) -> dict:
    """A phase-18 leg's config on the card with a JSONL path of its own,
    at BENCH_STEPS_ON_CARD."""
    cfg = json.loads(json.dumps(base))
    cfg["device"] = "cuda"
    cfg["benchmark"] = dict(cfg["benchmark"], **BENCH_STEPS_ON_CARD)
    here = __import__("pathlib").Path(__file__).resolve().parent
    cfg["logging"]["metrics_path"] = str(here / "runs" / "chip_smoke" / f"bench_{tag}_{time.time_ns()}.jsonl")
    return cfg


def step_host_syncs(torch, recipe) -> dict:
    """One more training step (the scheduler's next batch) under
    torch.profiler, CPU side only: the CUDA runtime calls in it that make
    the host wait for the card or free its memory, by name and count. A
    ``dispatch`` time near the step's means the host waited inside
    ``train_step``: on one of these, or on a full launch queue (which no
    event shows)."""
    from torch.profiler import ProfilerActivity, profile

    from automodel_tpu_torch.data.collators import stack_microbatches

    batch = recipe._place(stack_microbatches(next(iter(recipe.step_scheduler))))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recipe.train_step(recipe.state, batch)
    torch.cuda.synchronize()
    waits = ("Synchronize", "cudaFree", "cudaMemcpy", "cudaStreamWaitEvent")
    counts: dict[str, int] = {}
    for e in prof.events():
        if e.name.startswith("cuda") and any(w in e.name for w in waits):
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def run_bench_leg(torch, label: str, cfg: dict, kernels: dict, per_step: dict, training: dict) -> dict:
    """One leg through ``recipes.benchmark.main``: every kernel count set to
    0 just before the recipe, read when its measured steps end (before the
    decode leg), and each equal to its per-step count x (warmup + measured)
    steps; the paged kernel's launches counted over the serving leg alone.
    The result's checks fail the phase; the matching training phase's own
    step time and FLOP share are printed beside it, unchecked."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.ops.paged_attention import paged_attend
    from automodel_tpu_torch.recipes import benchmark as bm
    from automodel_tpu_torch.serving.engine import ServingEngine

    bench = cfg["benchmark"]
    steps = bench["warmup_steps"] + bench["measure_steps"]
    sched = cfg["step_scheduler"]
    layers = cfg["model"]["hf_config"]["num_hidden_layers"]
    want = {k: v * steps for k, v in per_step.items()}
    after_steps, engines = {}, []
    cls = bm.BenchmarkingRecipeForNextTokenPrediction
    real = (cls._generation_leg, cls._serving_leg, ServingEngine.run_workload)

    def generation_leg(self):  # the measured steps are done: read their counts
        after_steps.update({k: getattr(f, attr) for k, (f, attr) in kernels.items()})
        after_steps["host_syncs"] = step_host_syncs(torch, self)
        return real[0](self)

    def serving_leg(self):
        paged_attend.launches = 0
        try:
            return real[1](self)
        finally:
            after_steps["paged_attention"] = paged_attend.launches

    def run_workload(self, arrivals):
        engines.append(self)
        return real[2](self, arrivals)

    cls._generation_leg, cls._serving_leg, ServingEngine.run_workload = generation_leg, serving_leg, run_workload
    try:
        # the main path's run: every count set to 0 just before, read just after the steps
        for f, attr in kernels.values():
            setattr(f, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = bm.main(ConfigNode(cfg))
        wall = time.perf_counter() - t0
    finally:
        cls._generation_leg, cls._serving_leg, ServingEngine.run_workload = real
    launches = {k: after_steps[k] for k in kernels}
    if launches != want:
        raise RuntimeError(f"{label}: kernel launches over the {steps} steps {launches}, want {want}")
    tokens = cfg["dataset"]["seq_length"] * sched["grad_acc_steps"] * cfg["dataloader"]["global_batch_size"]
    problems = []
    if res["timers"]["step"]["count"] != bench["measure_steps"]:
        problems.append(f"timers.step.count {res['timers']['step']['count']}")
    if res["tokens_per_step"] != tokens:
        problems.append(f"tokens_per_step {res['tokens_per_step']}, want {tokens}")
    if not math.isfinite(res["loss"]):
        problems.append(f"loss {res['loss']}")
    if not isinstance(res["mfu"], float) or not 0 < res["mfu"] < 1:
        problems.append(f"mfu {res['mfu']} (want a number in (0, 1) on the card's peak)")
    if not all(v > 0 for v in res["step_decomposition"].values()):
        problems.append(f"step_decomposition {res['step_decomposition']}")
    if not any(d.get("peak_bytes_in_use", 0) > 0 for d in res["memory"]["devices"].values()):
        problems.append(f"memory.devices {res['memory']['devices']}")
    if "generation" in cfg:
        n_gen = cfg["generation"]["bench_batch"] * cfg["generation"]["max_new_tokens"]
        if res["gen_failure"] is not None or res["gen_tokens"] != n_gen or not res["gen_decode_tps"] > 0:
            problems.append(f"decode leg {res['gen_failure']}, {res.get('gen_tokens')} tokens (want {n_gen}), "
                            f"{res['gen_decode_tps']} tokens/s")
    if "serving" in cfg:
        n_req = cfg["serving"]["bench_requests"]
        if res["serve_failure"] is not None or res["serve_requests"] != n_req or not res["serve_tokens_per_s"] > 0:
            problems.append(f"serving leg {res['serve_failure']}, {res['serve_requests']} requests (want {n_req}), "
                            f"{res['serve_tokens_per_s']} tokens/s")
        if not engines:
            problems.append("the serving leg ran no workload")
        for i, engine in enumerate(engines):  # the recipe reports a rebuild too; held here as well
            check_engine_healthy(engine, f"{label} serving engine {i}")
        # each decode or verify forward of the target runs the kernel once a
        # layer, each draft forward once a draft layer
        want_paged, formula = spec_paged_launches(engines)
        if after_steps["paged_attention"] != want_paged or want_paged == 0:
            problems.append(f"paged kernel launched {after_steps['paged_attention']} times, want {formula}")
        if cfg["serving"].get("speculative", {}).get("enabled"):
            ab = res.get("serve_spec_ab") or {}
            if (res["serve_spec_failure"] is not None or not res["serve_draft_tps"]
                    or not ab.get("spec_on_tokens_per_s") or not ab.get("spec_off_tokens_per_s")):
                problems.append(f"speculative serving: serve_spec_failure {res['serve_spec_failure']!r}, "
                                f"serve_draft_tps {res['serve_draft_tps']}, serve_spec_ab {ab}")
        if "kv_spill" not in res["serve_spill_failure"] or "fleet" not in res["serve_fleet_failure"]:
            problems.append(f"spill / fleet reasons {res['serve_spill_failure']!r} / {res['serve_fleet_failure']!r}")
    if problems:
        raise RuntimeError(f"{label}: " + "; ".join(problems))
    shown = dict(res, memory=dict(res["memory"], census={k: v for k, v in res["memory"]["census"].items()
                                                         if k != "top"}))
    out = dict(result=shown, launches=launches, wall_s=wall, host_syncs_one_more_step=after_steps["host_syncs"],
               paged_attention_launches=after_steps.get("paged_attention"),
               decode_forwards=sum(e.decode_forwards for e in engines) if engines else None,
               paged_launch_formula=spec_paged_launches(engines)[1] if engines else None,
               training_phase={k: training.get(k) for k in ("step_ms", "model_flops_share_of_989", "tokens_per_s")})
    print(f"{label}: {json.dumps(out)}", flush=True)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_benchmark(torch, training: dict, moe: dict, gpt_oss: dict, gemma: dict) -> dict:
    """The four legs, each a fresh recipe: (a) Llama-3-8B at 8 layers with
    its decode and serving legs, (b) Qwen3-30B-A3B at 4 layers (K2), (c)
    gpt-oss-20b at 3 layers (K3), (d) gemma-2-9b at 8 layers (K1 with the
    cap); each kernel's count as its training phase counts it a step."""
    from automodel_tpu_torch.ops import grouped_matmul as gm
    from automodel_tpu_torch.ops import ring_flash as rf

    def flash(layers, acc):
        return dict(flash_fwd=(rf.flash_block_fwd, "launches"), flash_dq=(rf.flash_block_dq, "launches"),
                    flash_dkv=(rf.flash_block_dkv, "launches")), dict.fromkeys(
                        ("flash_fwd", "flash_dq", "flash_dkv"), layers * acc)

    legs = {}
    cfg = bench_config(BENCH_LLAMA3_8B, "llama3_8b")
    kernels, per = flash(cfg["model"]["hf_config"]["num_hidden_layers"], cfg["step_scheduler"]["grad_acc_steps"])
    legs["llama"] = run_bench_leg(torch, "benchmark (a) llama-3-8b", cfg, kernels, per, training)

    cfg = bench_config(BENCH_QWEN3_MOE_A3B, "qwen3_moe_a3b")
    n = cfg["model"]["hf_config"]["num_hidden_layers"] * cfg["step_scheduler"]["grad_acc_steps"]
    kernels, per = flash(cfg["model"]["hf_config"]["num_hidden_layers"], cfg["step_scheduler"]["grad_acc_steps"])
    kernels.update(gmm=(gm.gmm, "launches"), gmm_t=(gm.gmm, "launches_t"), tgmm=(gm.tgmm, "launches"))
    per.update(gmm=2 * n, gmm_t=2 * n, tgmm=2 * n)  # two of each per MoE layer, as phase 9
    legs["qwen3_moe"] = run_bench_leg(torch, "benchmark (b) qwen3-30b-a3b", cfg, kernels, per, moe)

    cfg = bench_config(BENCH_GPT_OSS_20B, "gpt_oss_20b")
    n = cfg["model"]["hf_config"]["num_hidden_layers"] * cfg["step_scheduler"]["grad_acc_steps"]
    per = dict(fem_fwd=n, fem_bwd_gu=n, fem_bwd_act=n, fem_bwd_dwd=n, fem_bwd_dx=n, gmm=n, gmm_t=n, tgmm=0,
               flash_fwd=n, flash_dq=n, flash_dkv=n)  # as phase 13
    legs["gpt_oss"] = run_bench_leg(torch, "benchmark (c) gpt-oss-20b", cfg, fused_kernel_counters(), per, gpt_oss)

    cfg = bench_config(BENCH_GEMMA2_9B, "gemma2_9b")
    kernels, per = flash(cfg["model"]["hf_config"]["num_hidden_layers"], cfg["step_scheduler"]["grad_acc_steps"])
    legs["gemma2"] = run_bench_leg(torch, "benchmark (d) gemma-2-9b", cfg, kernels, per, gemma)
    return legs


# -- phase 19: knowledge distillation, Llama-3-8B into Llama-3.2-1B -------------


def phase_kd_flash(torch, dev) -> dict:
    """K1 at the student's attention (Llama-3.2-1B: B=1, S=4096, N=32,
    Nkv=8, H=64, causal, no sinks) against its plain version, timed beside
    its bound and SDPA."""
    hf = LLAMA3_2_1B
    case = dict(name="llama-3.2-1b causal (H=64)", main=True, H=hf["head_dim"], N=hf["num_attention_heads"],
                Nkv=hf["num_key_value_heads"])
    return run_flash_cases(torch, dev, [case], "flash_attention at Llama-3.2-1B's shape", seed0=90)


def kd_config(remat: str) -> dict:
    """KD_LLAMA3_8B_TO_1B on the card, 4 steps of 2 x 4096 tokens, the
    student under ``remat``."""
    cfg = json.loads(json.dumps(KD_LLAMA3_8B_TO_1B))
    cfg["device"] = "cuda"
    cfg["model"]["backend"]["remat"] = remat
    cfg["step_scheduler"].update(max_steps=KD_STEPS, log_every_steps=1)
    here = __import__("pathlib").Path(__file__).resolve().parent
    cfg["logging"]["metrics_path"] = str(here / "runs" / "chip_smoke" / f"kd_metrics_{remat}_{time.time_ns()}.jsonl")
    return cfg


def run_kd(torch, remat: str) -> dict:
    """``kd llm``'s recipe class (what ``recipes/kd.main`` runs: setup, then
    the loop) at full depth with the student under ``remat``: the flash
    launches of the run (counts set to 0 just before, read just after),
    the teacher's share read around its forward; the step time (median of
    steps 2-4, each ending in a synchronise), tokens/s, the peak device
    memory and the finite losses."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.ops import ring_flash as rf
    from automodel_tpu_torch.recipes.kd import KDRecipeForNextTokenPrediction

    cfg = kd_config(remat)
    acc, steps = cfg["step_scheduler"]["grad_acc_steps"], cfg["step_scheduler"]["max_steps"]
    t0 = time.perf_counter()
    recipe = KDRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    teacher = recipe.teacher.model
    kernels = dict(fwd=rf.flash_block_fwd, dq=rf.flash_block_dq, dkv=rf.flash_block_dkv)
    teacher_fwd = [0, 0]  # launches read before the teacher's forward, launches in it

    def before(module, args):
        teacher_fwd[0] = rf.flash_block_fwd.launches

    def after(module, args, out):
        teacher_fwd[1] += rf.flash_block_fwd.launches - teacher_fwd[0]

    hooks = [teacher.register_forward_pre_hook(before), teacher.register_forward_hook(after)]
    for f in kernels.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kernels.items()}
    t_layers = cfg["teacher_model"]["hf_config"]["num_hidden_layers"]
    s_layers = cfg["model"]["hf_config"]["num_hidden_layers"]
    recompute = 2 if remat in ("full", "selective") else 1
    want = dict(teacher_fwd=t_layers * acc * steps, student_fwd=recompute * s_layers * acc * steps,
                dq=s_layers * acc * steps, dkv=s_layers * acc * steps)
    got = dict(teacher_fwd=teacher_fwd[1], student_fwd=launches["fwd"] - teacher_fwd[1], dq=launches["dq"],
               dkv=launches["dkv"])
    if got != want:
        raise RuntimeError(f"kd (remat {remat}): flash launches {got}, want {want} (teacher {t_layers} layers, "
                           f"student {s_layers} layers x {recompute} under remat {remat}, x {acc} microbatches x "
                           f"{steps} steps)")
    rows = step_records(cfg["logging"]["metrics_path"])
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise RuntimeError(f"kd (remat {remat}): metric rows for steps {[r['step'] for r in rows]}")
    for r in rows:
        if r.get("loss") is None or r.get("grad_norm") is None or r["nonfinite"] or not math.isfinite(r["loss"]):
            raise RuntimeError(f"kd (remat {remat}): non-finite step: {r}")
    seq = cfg["dataset"]["seq_length"]
    tokens = seq * acc * cfg["dataloader"]["global_batch_size"]
    step_s = statistics.median(r["step_time_s"] for r in rows[1:])
    s_params = sum(p.numel() for p in recipe.model.parameters())
    t_params = sum(p.numel() for p in teacher.parameters())
    shc, thc = cfg["model"]["hf_config"], cfg["teacher_model"]["hf_config"]
    s_embed = 0 if shc["tie_word_embeddings"] else shc["vocab_size"] * shc["hidden_size"]
    t_embed = thc["vocab_size"] * thc["hidden_size"]  # the lookup; the untied lm_head is a product
    pairs = live_pairs(seq, None)
    # the student's training (6 x params, the tied lm_head counted) and the
    # teacher's forward (2 x params) over the tokens, and attention: the
    # student's 12 H flops and the teacher's 4 H a live pair and q head
    flops = (6 * (s_params - s_embed) + 2 * (t_params - t_embed)) * tokens + acc * pairs * (
        12 * shc["head_dim"] * shc["num_attention_heads"] * shc["num_hidden_layers"]
        + 4 * thc["head_dim"] * thc["num_attention_heads"] * thc["num_hidden_layers"])
    out = dict(
        remat=remat, student_params=s_params, teacher_params=t_params, tokens_per_step=tokens, steps=steps,
        microbatches=acc, setup_s=setup_s, wall_s=wall, losses=[r["loss"] for r in rows],
        grad_norms=[r["grad_norm"] for r in rows], compile_time_s=rows[0].get("compile_time_s"),
        step_ms=1e3 * step_s, step_ms_each=[1e3 * r["step_time_s"] for r in rows[1:]],
        tokens_per_s=tokens / step_s, model_flop_per_step=flops,
        model_flops_share_of_989=flops / step_s / BF16_FLOPS,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, flash_launches=got,
    )
    out["profile"] = profile_train_step(torch, recipe, acc)
    print(f"kd llm, remat {remat}: {json.dumps(out)}", flush=True)
    del recipe, teacher
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_kd_flash_vs_sdpa(torch) -> dict:
    """One microbatch's KD loss (the blend of the config's ratio and
    temperature) and the student's fp32 grad norm with both models cut to
    2 layers, the same weights and batch, ``attn: flash`` against ``attn:
    sdpa`` in both; phase 7's limits."""
    import dataclasses

    from automodel_tpu_torch.data.collators import default_collater
    from automodel_tpu_torch.data.sft import MockSFTDataset
    from automodel_tpu_torch.generation.engine import build_auto_from_model_section
    from automodel_tpu_torch.optim.builders import global_norm_fp32
    from automodel_tpu_torch.recipes.kd import make_kd_loss

    cfg = kd_config("selective")
    for section in ("model", "teacher_model"):
        cfg[section]["hf_config"]["num_hidden_layers"] = 2
    dev = torch.device(cfg["device"])
    student = build_auto_from_model_section(cfg["model"], dev, seed=cfg["seed"], trainable=True).model
    teacher = build_auto_from_model_section(cfg["teacher_model"], dev, seed=cfg["seed"] + 100).model
    params = list(student.parameters())
    ds = MockSFTDataset(**{k: v for k, v in cfg["dataset"].items() if k != "_target_"})
    mb = {k: torch.from_numpy(v).to(dev) for k, v in default_collater([ds[7]]).items() if hasattr(v, "shape")}
    out = {}
    for attn in ("flash", "sdpa"):
        for m in (student, teacher):
            m.backend = dataclasses.replace(m.backend, attn=attn)
        loss_sum, n = make_kd_loss(student, teacher, cfg["kd"]["ratio"], cfg["kd"]["temperature"])(mb)
        grads = torch.autograd.grad(loss_sum.float(), params)
        denom = n.clamp_min(1).float()
        norm = global_norm_fp32(g.float() / denom for g in grads)
        out[attn] = dict(loss=float(loss_sum.detach() / denom), grad_norm=float(norm))
        del grads, loss_sum
        torch.cuda.empty_cache()
    f, s = out["flash"], out["sdpa"]
    out["loss_rel"] = abs(f["loss"] - s["loss"]) / abs(s["loss"])
    out["grad_norm_rel"] = abs(f["grad_norm"] - s["grad_norm"]) / abs(s["grad_norm"])
    print(f"one step, kd flash vs sdpa (2 + 2 layers): {json.dumps(out)}", flush=True)
    if not all(math.isfinite(x) for x in (f["loss"], s["loss"], f["grad_norm"], s["grad_norm"])):
        raise RuntimeError(f"kd flash vs sdpa: non-finite loss or grad norm: {out}")
    if out["loss_rel"] > STEP_LOSS_REL_TOL or out["grad_norm_rel"] > STEP_GRAD_NORM_REL_TOL:
        raise RuntimeError(f"kd flash vs sdpa: the steps disagree: {out} (limits: loss {STEP_LOSS_REL_TOL}, "
                           f"grad norm {STEP_GRAD_NORM_REL_TOL}, relative)")
    del student, teacher, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_kd(torch, dev) -> dict:
    """Phase 19: K1 at the student's shape, then ``kd llm`` at full depth
    with the student at ``remat: none``, ``full`` and ``selective``, each
    with a profile of one more step, then KD with flash against sdpa."""
    out = dict(flash=phase_kd_flash(torch, dev))
    out["none"] = run_kd(torch, "none")
    out["full"] = run_kd(torch, "full")
    out["selective"] = run_kd(torch, "selective")
    out["flash_vs_sdpa"] = phase_kd_flash_vs_sdpa(torch)
    return out


def kd_flash_entry(name: str, kd: dict) -> dict:
    """One flash kernel on the KD path: its launches in the selective run
    (the teacher's forward at H=128, the student's at H=64), its time at
    the student's shape beside its bound and SDPA, and its row error."""
    c = kd["flash"]["cases"][0]
    errs = dict(fwd=("out_row_err",), dq=("dq_row_err",), dkv=("dk_row_err", "dv_row_err"))[name]
    launches = kd["selective"]["flash_launches"]
    out = dict(
        c["timed"][name], shape="B=1 S=4096 N=32 Nkv=8 H=64 causal, no sinks (Llama-3.2-1B)",
        live_pairs=c["live_pairs"], max_row_rel_err=max(c[k] for k in errs), max_abs_err=c["max_abs_err"][name],
        launches_selective=(dict(teacher=launches["teacher_fwd"], student=launches["student_fwd"]) if name == "fwd"
                            else launches[name]),
    )
    if name == "dq":
        out["backward"] = flash_backward_pair(c)
    return out

# -- phases 10 and 14: one step, two experts backends ---------------------------


def moe_step(torch, model, mb: dict, counters: dict) -> dict:
    """One microbatch's loss, fp32 grad norm and aux loss (no update), with
    each kernel's launches in it."""
    from automodel_tpu_torch.optim.builders import global_norm_fp32
    from automodel_tpu_torch.training.train_step import make_causal_lm_loss

    params = [p for p in model.parameters() if p.requires_grad]
    before = {k: getattr(f, a) for k, (f, a) in counters.items()}
    loss_sum, n, extras = make_causal_lm_loss(model, loss="fused_linear_ce")(mb)
    grads = torch.autograd.grad(loss_sum.float(), params)
    denom = n.clamp_min(1).float()
    norm = global_norm_fp32(g.float() / denom for g in grads)
    torch.cuda.synchronize()
    launches = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items() if getattr(f, a) != before[k]}
    out = dict(loss=float(loss_sum.detach() / denom), grad_norm=float(norm),
               moe_aux_loss=float(extras["moe_aux_loss"]), launches=launches)
    del grads, loss_sum, extras
    torch.cuda.empty_cache()
    return out


def one_step_experts_ab(torch, cfg: dict, label: str, backends: tuple, want: dict, tols: dict) -> dict:
    """One step's loss, fp32 grad norm and aux loss (one microbatch of the
    config's tokens, no update) from the same weights and batch, with the
    experts backend switched between ``backends``: each must launch the
    grouped-matmul and fused expert-MLP kernels ``want[backend]`` times,
    and each metric in ``tols`` must agree within its limit (relative to
    the second backend's)."""
    import dataclasses

    from automodel_tpu_torch.data.collators import default_collater
    from automodel_tpu_torch.data.sft import MockSFTDataset
    from automodel_tpu_torch.generation.engine import build_auto_from_model_section

    dev = torch.device(cfg["device"])
    model = build_auto_from_model_section(cfg["model"], dev, seed=cfg["seed"], trainable=True).model
    ds = MockSFTDataset(**{k: v for k, v in cfg["dataset"].items() if k != "_target_"})
    mb = {k: torch.from_numpy(v).to(dev) for k, v in default_collater([ds[3]]).items() if hasattr(v, "shape")}
    counters = {k: v for k, v in fused_kernel_counters().items() if not k.startswith("flash")}
    out = {}
    for experts in backends:
        model.backend = dataclasses.replace(model.backend, experts=experts)
        out[experts] = moe_step(torch, model, mb, counters)
    a, b = (out[e] for e in backends)
    for key in tols:
        out[f"{key}_rel"] = abs(a[key] - b[key]) / abs(b[key])
    print(f"one step, {label}: {json.dumps(out)}", flush=True)
    if any(out[e]["launches"] != want[e] for e in backends):
        raise RuntimeError(f"{label}: kernel launches {[out[e]['launches'] for e in backends]}, want {want}")
    if not all(math.isfinite(x[k]) for x in (a, b) for k in ("loss", "grad_norm", "moe_aux_loss")):
        raise RuntimeError(f"non-finite loss, grad norm or aux loss: {out}")
    if any(out[f"{key}_rel"] > tol for key, tol in tols.items()):
        raise RuntimeError(f"{label}: the steps disagree: {out} (limits, relative: {tols})")
    del model
    torch.cuda.empty_cache()
    return out


def phase_ragged_vs_dense(torch) -> dict:
    """One step at 1 layer of Qwen3-30B-A3B's widths and 2048 tokens with
    the experts on the grouped-matmul kernels (``ragged``: two gmm, gmm_t
    and tgmm launches) and on plain torch (``dense``)."""
    cfg = moe_train_config()
    cfg["model"]["hf_config"]["num_hidden_layers"] = 1
    cfg["dataset"]["seq_length"] = 2048
    want = dict(ragged=dict(gmm=2, gmm_t=2, tgmm=2), dense={})
    tols = dict(loss=MOE_STEP_LOSS_REL_TOL, grad_norm=MOE_STEP_GRAD_NORM_REL_TOL, moe_aux_loss=MOE_STEP_AUX_REL_TOL)
    return one_step_experts_ab(torch, cfg, "experts ragged vs dense", ("ragged", "dense"), want, tols)


def phase_fused_vs_ragged(torch) -> dict:
    """One step at 1 layer of gpt-oss-20b's widths and 2048 tokens with the
    experts on the fused expert-MLP kernels (``ragged_fused``: the five K3
    calls, K2's gmm and gmm_t once each) and on the grouped-matmul kernels
    with the activation in bf16 eager torch (``ragged``). The aux loss is 0
    here (the config sets no coefficient), so it is not compared."""
    cfg = gpt_oss_train_config()
    cfg["model"]["hf_config"]["num_hidden_layers"] = 1
    cfg["dataset"]["seq_length"] = 2048
    want = dict(ragged_fused=dict(fem_fwd=1, fem_bwd_gu=1, fem_bwd_act=1, fem_bwd_dwd=1, fem_bwd_dx=1, gmm=1, gmm_t=1),
                ragged=dict(gmm=2, gmm_t=2, tgmm=2))
    tols = dict(loss=FUSED_STEP_LOSS_REL_TOL, grad_norm=FUSED_STEP_GRAD_NORM_REL_TOL)
    return one_step_experts_ab(torch, cfg, "experts ragged_fused vs ragged", ("ragged_fused", "ragged"), want, tols)


# -- phase 11: flash with sinks against its plain version ------------------------


def phase_flash_sinks(torch, dev) -> dict:
    """GPT-OSS's attention shape, B=1, S=4096, N=64, Nkv=8, H=64, causal,
    with a 128 window and full, random sinks: the fold around the kernels
    against the same fold around the plain versions. The folded out and the
    extended lse; dq, dk and dv with both backward versions fed the plain
    fold's extended lse and delta (as phase 3 feeds them the plain
    forward's); d_sinks end to end, each side from its own out and lse."""
    from automodel_tpu_torch.ops import ring_flash as rf

    hf = GPT_OSS_20B
    N, Nkv, H = hf["num_attention_heads"], hf["num_key_value_heads"], hf["head_dim"]
    results = []
    for i, window in enumerate((hf["sliding_window"], None)):
        q, k, v, do, pos, _ = flash_case(torch, dev, S=4096, H=H, N=N, Nkv=Nkv, seed=20 + i)
        sinks = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(30 + i), device=dev) * 2
        kw = dict(causal=True, window=window, scale=H**-0.5)
        delta = lambda o: (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        out, lse = rf.fold_sinks(*rf.flash_block_fwd(q, k, v, pos, pos, None, None, **kw), sinks)
        ds = rf.sinks_grad(lse, delta(out), sinks)
        r_out, r_lse = rf.fold_sinks(*rf._flash_fwd_plain(q, k, v, pos, pos, None, None, **kw), sinks)
        bargs = (q, k, v, do, r_lse, delta(r_out), pos, pos, None, None)
        dq = rf.flash_block_dq(*bargs, **kw)
        dk, dv = rf.flash_block_dkv(*bargs, **kw)
        torch.cuda.synchronize()
        r_dq = rf._flash_dq_plain(*bargs, **kw)
        r_dk, r_dv = rf._flash_dkv_plain(*bargs, **kw)
        r_ds = rf.sinks_grad(r_lse, delta(r_out), sinks)
        if not all(bool(torch.isfinite(t.float()).all()) for t in (out, lse, dq, dk, dv, ds)):
            raise RuntimeError(f"flash with sinks produced non-finite values (window {window})")
        # each head's d_sinks error against the sum of its terms' magnitudes
        p_sink = torch.exp(sinks[None, :, None] - r_lse)
        mag = (p_sink * (do.float().norm(dim=-1) * r_out.float().norm(dim=-1)).transpose(1, 2)).sum(dim=(0, 2))
        row = dict(
            window=window, S=q.shape[1], N=N, Nkv=Nkv, H=H,
            out_row_err=row_rel_err(out, r_out), lse_err=float((lse - r_lse).abs().max()),
            dq_row_err=grad_row_err(dq, r_dq), dk_row_err=grad_row_err(dk, r_dk), dv_row_err=grad_row_err(dv, r_dv),
            d_sinks_err=float(((ds - r_ds).abs() / mag.clamp_min(1e-30)).max()),
            d_sinks_err_of_largest=float((ds - r_ds).abs().max() / r_ds.abs().max()),
            sink_share=float(p_sink.mean()),
        )
        row["ok"] = (row["out_row_err"] <= FLASH_OUT_TOL and row["lse_err"] <= FLASH_LSE_TOL
                     and max(row["dq_row_err"], row["dk_row_err"], row["dv_row_err"]) <= FLASH_GRAD_TOL
                     and row["d_sinks_err"] <= SINKS_GRAD_TOL)
        del r_out, r_dq, r_dk, r_dv, p_sink, mag
        torch.cuda.empty_cache()
        # the kernels at this shape (the fold around them is plain torch),
        # each beside its bound; the yardstick has no sinks: SDPA causal for
        # the full layers, flex_attention with the window's block mask for
        # the windowed ones
        pairs = int(rf._mask(pos, pos, None, None, True, window).sum())
        row["live_pairs"] = pairs
        row["timed"] = time_flash(torch, rf, f"gpt-oss-20b sinks, window {window}", bargs, kw,
                                  flash_bound(q, k, pairs), None)
        if window is None:
            lib = flash_library_ms(torch, q, k, v, do, True, H**-0.5)
            row["library"] = "scaled_dot_product_attention, causal, no sinks"
        else:
            lib = flex_library_ms(torch, q, k, v, do, None, window, H**-0.5)
            row["library"] = f"torch.compile(flex_attention), the {window} window's block mask, no sinks"
        row["library_fwd_ms"], row["library_fwd_bwd_ms"], row["library_bwd_ms"] = lib
        set_flash_library_ms(row, lib)
        results.append(row)
        print(f"kernel flash_attention with sinks vs plain: {json.dumps(row)}", flush=True)
        del q, k, v, do, out, lse, dq, dk, dv, r_lse, bargs
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise RuntimeError(f"flash with sinks disagrees with its plain version (limits: out {FLASH_OUT_TOL}, lse "
                           f"{FLASH_LSE_TOL}, grads {FLASH_GRAD_TOL} per row, d_sinks {SINKS_GRAD_TOL}): {bad}")
    return {"cases": results}


# -- phase 12: the fused expert-MLP kernels against their plain versions ---------


def gpt_oss_rows(torch, dev, routing: str, seed: int, scale: float = 1.0):
    """One 4096-token microbatch at gpt-oss-20b's MoE widths: its token rows
    sorted by expert ([16384, 2880] bf16, times ``scale``) and the int32
    group sizes. ``gate``: the gpt-oss gate (top-4 of the raw logits of a
    random router with a random learned bias, softmax over the picks) over
    random tokens; ``skewed``: random rows in groups where the first and
    last experts (and two more) are empty and expert 5 holds a quarter."""
    from automodel_tpu_torch.moe.config import MoEConfig
    from automodel_tpu_torch.moe.gate import gate

    hf = GPT_OSS_20B
    T, D, E, K = 4096, hf["hidden_size"], hf["num_local_experts"], hf["num_experts_per_tok"]
    g = torch.Generator(device=dev).manual_seed(seed)
    if routing == "skewed":
        M = T * K
        w = torch.rand(E, generator=g, device=dev) + 0.05
        w[[0, E - 1, 11, 5]] = 0.0
        sizes = torch.floor(w / w.sum() * (M - M // 4)).long()
        sizes[1] += M - M // 4 - int(sizes.sum())
        sizes[5] = M // 4
        rows = (torch.randn((M, D), generator=g, device=dev) * scale).to(torch.bfloat16)
        return rows, sizes.to(torch.int32)
    x = (torch.randn((T, D), generator=g, device=dev) * scale).to(torch.bfloat16)
    cfg = MoEConfig(num_experts=E, num_experts_per_tok=K, moe_intermediate_size=hf["intermediate_size"],
                    softmax_before_topk=False, router_linear_bias=True, expert_mlp_bias=True, activation="swiglu_oai")
    router = (torch.randn((E, D), generator=g, device=dev) / D**0.5).to(torch.bfloat16)
    lb = torch.randn(E, generator=g, device=dev) * 0.5
    gout = gate(x, router, cfg, linear_bias=lb)
    order = torch.argsort(gout.topk_idx.reshape(-1), stable=True)
    return x.index_select(0, order // K), gout.expert_counts


def fem_bound(kind: str, M: int, D: int, I: int, gs, biased: bool, out_bytes: int = 4,
              given: bool = False) -> tuple[float, str]:
    """Least time of one call: its tensor-core products (2 flops per routed
    row and (k, n) pair) over the bf16 peak, against its bytes over HBM
    bandwidth: each operand read once (the routed rows of lhs, gu, dmid and
    dy, the weight slabs of experts that received rows, the biases), each
    output written once (out and dlhs [M, D] bf16, bwd_gu's and bwd_dwd's
    weight grads in ``out_bytes`` an element, the bias grads fp32).
    bwd_gu, bwd_dwd and bwd_dx read gu [M, 2I] (and dmid) when called alone
    (they run the elementwise pass) and the pass's output (mid [M, I],
    dg | du [M, 2I]) under ``given``, as the backward calls them; bwd_gu's
    bias grads read g | u and dmid either way. bwd_act reads g | u and
    dmid of the routed rows and writes mid and dg | du over all M rows; its
    fp32 elementwise work (~40 flops an element, ~0.03 ms at 67 TFLOP/s at
    gpt-oss-20b's widths) is under its bytes and not counted, nor is the
    activation elsewhere."""
    rows, fed, G = int(gs.sum()), int((gs > 0).sum()), gs.shape[0]
    bf = 2
    if kind == "fwd":
        flops = 6 * rows * D * I
        nbytes = rows * D * bf + fed * 3 * D * I * bf + (fed * (2 * I + D) * bf if biased else 0) + M * D * bf
    elif kind == "bwd_gu":
        flops = 4 * rows * D * I
        reads = D + (2 * I + (3 * I if biased else 0) if given else 3 * I)
        nbytes = rows * reads * bf + G * D * 2 * I * out_bytes + (G * 2 * I * 4 if biased else 0)
    elif kind == "bwd_act":
        flops = 0
        nbytes = rows * 3 * I * bf + M * 3 * I * bf
    elif kind == "bwd_dwd":
        flops = 2 * rows * I * D
        nbytes = rows * ((I if given else 2 * I) + D) * bf + G * I * D * out_bytes + (G * D * 4 if biased else 0)
    else:  # bwd_dx
        flops = 4 * rows * I * D
        nbytes = rows * (2 * I if given else 3 * I) * bf + fed * 2 * D * I * bf + M * D * bf
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def fem_library_ms(torch, kind: str, xs, gu, dmid, dy, w_gu, w_dn, gs, gub, db, act, limit, mid=None,
                   dgdu=None, fwd_mid=None) -> dict:
    """Yardsticks the port never calls: ``composition_ms``, the function
    as ``torch._grouped_mm`` products with the activation (and its
    backward, the bias adds) in eager torch; ``library_ms``, for bwd_gu,
    bwd_dwd and bwd_dx the one ``torch._grouped_mm`` call of their product
    on the materialized operand (``dgdu``, ``mid``: the kernels' work as
    the backward calls them), for the forward the composition (no one call
    computes it), with ``gu_library_ms`` and ``down_library_ms`` beside it:
    ``torch._grouped_mm`` alone on each of its two launches' operands (the
    forward's mid, ``fwd_mid``, for the second). None where this torch has
    no ``_grouped_mm`` or it refuses; bwd_act has no library call."""
    from automodel_tpu_torch.ops import fused_expert_mlp as fem

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or kind == "bwd_act":
        return dict(library_ms=None, composition_ms=None)
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    I = w_dn.shape[1]

    def act_fwd(h):
        return fem._act_core(h[:, :I].float(), h[:, I:].float(), act, limit).to(torch.bfloat16)

    def act_bwd():
        return torch.cat(fem._act_grads(gu[:, :I], gu[:, I:], dmid, act, limit), dim=1).to(torch.bfloat16)

    def fwd():
        h = fn(xs, w_gu, offs=offs)
        h = h if gub is None else fem.add_row_bias(h, gub, gs)
        y = fn(act_fwd(h), w_dn, offs=offs)
        return y if db is None else fem.add_row_bias(y, db, gs)

    compositions = dict(
        fwd=fwd,
        bwd_gu=lambda: fn(xs.t(), act_bwd(), offs=offs),
        bwd_dwd=lambda: fn(act_fwd(gu).t(), dy, offs=offs),
        bwd_dx=lambda: fn(act_bwd(), w_gu.transpose(-2, -1), offs=offs),
    )
    alone = dict(bwd_gu=lambda: fn(xs.t(), dgdu, offs=offs), bwd_dwd=lambda: fn(mid.t(), dy, offs=offs),
                 bwd_dx=lambda: fn(dgdu, w_gu.transpose(-2, -1), offs=offs))
    calls = [("composition_ms", compositions[kind]), ("library_ms", alone.get(kind))]
    if kind == "fwd":
        calls += [("gu_library_ms", lambda: fn(xs, w_gu, offs=offs)),
                  ("down_library_ms", lambda: fn(fwd_mid, w_dn, offs=offs))]
    out = {}
    for key, call in calls:
        try:
            out[key] = None if call is None else cuda_ms(call, iters=10)
        except (RuntimeError, TypeError, ValueError) as e:
            print(f"torch._grouped_mm refused the {kind} {key}: {str(e)[:200]}", flush=True)
            out[key] = None
    if kind == "fwd":
        out["library_ms"] = out["composition_ms"]
    return out


def phase_fused_kernels(torch, dev) -> dict:
    from automodel_tpu_torch.ops import fused_expert_mlp as fem
    from automodel_tpu_torch.ops import grouped_matmul as gm

    cases = [
        dict(name="gate (gpt-oss-20b)", widths="gpt_oss", act="swiglu_oai", main=True),
        dict(name="Qwen3-30B-A3B", widths="qwen3", act="swiglu", biased=False),
        dict(name="skewed", widths="gpt_oss", routing="skewed", act="swiglu_oai"),
        # lhs x 4.26: g and u ~ N(0, 4.26^2), ~10% past 7 in magnitude
        dict(name="clamped (~10% past +-7)", widths="gpt_oss", act="swiglu_oai", scale=4.26),
        dict(name="swiglu limit 2.0", widths="gpt_oss", act="swiglu", limit=2.0, scale=1.5),
        dict(name="NaN tail (last 10% of rows)", widths="gpt_oss", act="swiglu_oai", tail=0.1),
    ]
    results = []
    weights = {}
    for ci, c in enumerate(cases):
        c = dict(dict(main=False, routing="gate", biased=True, limit=None, scale=1.0, tail=0.0), **c)
        act, limit, biased = c["act"], c["limit"], c["biased"]
        if c["widths"] == "qwen3":
            xs, gs = moe_rows(torch, dev, "gate", seed=40 + ci)
            D, I = QWEN3_MOE_A3B["hidden_size"], QWEN3_MOE_A3B["moe_intermediate_size"]
        else:
            xs, gs = gpt_oss_rows(torch, dev, c["routing"], seed=40 + ci, scale=c["scale"])
            D, I = GPT_OSS_20B["hidden_size"], GPT_OSS_20B["intermediate_size"]
        M, G = xs.shape[0], gs.shape[0]
        if c["widths"] not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            g = torch.Generator(device=dev).manual_seed(50)
            rnd = lambda *shape, s=1.0: (torch.randn(shape, generator=g, device=dev) * s).to(torch.bfloat16)
            weights[c["widths"]] = dict(gate_up=rnd(G, D, 2 * I, s=D**-0.5), down=rnd(G, I, D, s=I**-0.5),
                                        gate_up_bias=rnd(G, 2 * I, s=0.5), down_bias=rnd(G, D, s=0.5))
        w = weights[c["widths"]]
        gub, db = (w["gate_up_bias"], w["down_bias"]) if biased else (None, None)
        dy = torch.randn((M, D), generator=torch.Generator(device=dev).manual_seed(60 + ci), device=dev).to(torch.bfloat16)
        if c["tail"]:
            # the groups end 10% before M; the rows past them hold NaN
            n = M - int(M * c["tail"])
            gs = torch.diff(torch.cumsum(gs.long(), 0).clamp_max(n), prepend=gs.new_zeros(1).long()).to(torch.int32)
        n = int(gs.sum())
        plan = gm.gmm_plan(gs, M)

        def run(lhs, dout, plain=False):
            gu = gm.gmm(lhs, w["gate_up"], gs, plan=plan)
            gu = gu if gub is None else fem.add_row_bias(gu, gub, gs)
            dmid = gm.gmm(dout, w["down"], gs, transpose_rhs=True, plan=plan)
            if plain:
                f = (fem._fwd_plain, fem._bwd_gu_plain, fem._bwd_dwd_plain, fem._bwd_dx_plain)
                out = f[0](lhs, w["gate_up"], w["down"], gs, gub, db, act, limit)
            else:
                f = (fem.fwd, fem.bwd_gu, fem.bwd_dwd, fem.bwd_dx)
                out = f[0](lhs, w["gate_up"], w["down"], gs, gub, db, act, limit, plan=plan)
            # bwd_gu with JAX's fp32 out, called alone (the elementwise pass inside)
            dw, dbias = f[1](lhs, gu, dmid, gs, act, limit, biased)
            # bwd_dwd (fp32 out) and bwd_dx alone, each running the elementwise pass
            dwd, ddb = f[2](gu, dout, gs, act, limit, biased)
            dlhs = f[3](gu, dmid, w["gate_up"], gs, act, limit) if plain else f[3](
                gu, dmid, w["gate_up"], gs, act, limit, plan=plan)
            mid, dgdu = (fem._bwd_act_plain if plain else fem.bwd_act)(gu, dmid, gs, act, limit)
            return (out, dw, dbias, dwd, ddb, dlhs, mid, dgdu), gu, dmid

        got, gu, dmid = run(xs, dy)
        torch.cuda.synchronize()
        want, _, _ = run(xs, dy, plain=True)
        names = ("out", "dw", "dbias", "dwd", "ddb", "dlhs", "mid", "dgdu")
        limits = dict(out=FEM_ROW_TOL, dlhs=FEM_ROW_TOL, dw=FEM_DW_ROW_TOL, dwd=FEM_DW_ROW_TOL,
                      dbias=FEM_BIAS_ROW_TOL, ddb=FEM_BIAS_ROW_TOL, mid=FEM_ROW_TOL, dgdu=FEM_ROW_TOL)
        if not all(bool(torch.isfinite(t.float()).all()) for t in got if t is not None):
            raise RuntimeError(f"fused expert-MLP kernels produced non-finite values in case {c['name']}")
        g_, u_ = gu[:n, :I].float(), gu[:n, I:].float()
        row = dict(
            case=c["name"], act=act, limit=limit, biased=biased, M=M, D=D, I=I, G=G, rows=n,
            groups_with_rows=int((gs > 0).sum()), largest_group=int(gs.max()),
            clamped_share=dict(g_above_7=float((g_ > 7).float().mean()), u_beyond_7=float((u_.abs() > 7).float().mean()),
                               at_bound=float(((g_ == 7) | (u_.abs() == 7)).float().mean())),
            row_err={k: row_rel_err(a, b) for k, a, b in zip(names, got, want) if b is not None},
            max_abs_err={k: float((a.float() - b.float()).abs().max()) for k, a, b in zip(names, got, want)
                         if b is not None},
            tail_rows_zero=all(bool((got[i][n:] == 0).all()) for i in (0, 5, 6, 7)),
        )
        row["ok"] = row["tail_rows_zero"] and all(v <= limits[k] for k, v in row["row_err"].items())
        if c["tail"]:
            # NaN past the groups in lhs and dy: the kernels read no such row,
            # so every output equals the clean tail's bit for bit
            dirty_x, dirty_dy = xs.clone(), dy.clone()
            dirty_x[n:] = float("nan")
            dirty_dy[n:] = float("nan")
            dirty, _, _ = run(dirty_x, dirty_dy)
            torch.cuda.synchronize()
            row["nan_tail_equal"] = all(torch.equal(a, b) for a, b in zip(dirty, got) if a is not None)
            row["nan_tail_finite"] = all(bool(torch.isfinite(a.float()).all()) for a in dirty if a is not None)
            row["ok"] = row["ok"] and row["nan_tail_equal"] and row["nan_tail_finite"]
            del dirty, dirty_x, dirty_dy
        del want
        if c["main"]:
            ends = fem._ends(gs)
            fwd_mid = fem._launch_fwd_gu_act(xs, w["gate_up"], gub, plan, ends, act, limit)
            # the backward's operands, as the autograd function makes them once
            mid, dgdu = got[6], got[7]
            bf16 = torch.bfloat16
            timed = dict(
                fwd=(lambda: fem.fwd(xs, w["gate_up"], w["down"], gs, gub, db, act, limit, plan=plan),
                     lambda: fem._fwd_plain(xs, w["gate_up"], w["down"], gs, gub, db, act, limit)),
                bwd_gu=(lambda: fem.bwd_gu(xs, gu, dmid, gs, act, limit, biased, dgdu=dgdu, out_dtype=bf16),
                        lambda: fem._bwd_gu_plain(xs, gu, dmid, gs, act, limit, biased, bf16, dgdu=dgdu)),
                bwd_act=(lambda: fem.bwd_act(gu, dmid, gs, act, limit),
                         lambda: fem._bwd_act_plain(gu, dmid, gs, act, limit)),
                bwd_dwd=(lambda: fem.bwd_dwd(gu, dy, gs, act, limit, biased, bf16, mid=mid),
                         lambda: fem._bwd_dwd_plain(gu, dy, gs, act, limit, biased, bf16, mid=mid)),
                bwd_dx=(lambda: fem.bwd_dx(gu, dmid, w["gate_up"], gs, act, limit, plan=plan, dgdu=dgdu),
                        lambda: fem._bwd_dx_plain(gu, dmid, w["gate_up"], gs, act, limit, dgdu=dgdu)),
            )
            row["timed"] = {}
            for kind, (kern, plain) in timed.items():
                # K3b-K3d as the backward calls them: the pass's output given, the weight grads in bf16
                bound_ms, bound_by = fem_bound(kind, M, D, I, gs, biased, out_bytes=2, given=True)
                row["timed"][kind] = dict(
                    ms=cuda_ms(kern, iters=10), plain_ms=cuda_ms(plain, iters=2, warmup=1), bound_ms=bound_ms,
                    bound_by=bound_by,
                    **fem_library_ms(torch, kind, xs, gu, dmid, dy, w["gate_up"], w["down"], gs, gub, db, act, limit,
                                     mid=mid, dgdu=dgdu, fwd_mid=fwd_mid),
                )
                torch.cuda.empty_cache()
            t = row["timed"]
            t["fwd"]["gu_act_ms"] = cuda_ms(
                lambda: fem._launch_fwd_gu_act(xs, w["gate_up"], gub, plan, ends, act, limit), iters=10)
            t["fwd"]["down_ms"] = cuda_ms(lambda: fem._launch_fwd_down(fwd_mid, w["down"], db, plan, ends), iters=10)
            # each launch in both orders of a group's items, and K2's gmm (plain
            # store) on the same operands in the order it takes: what the
            # epilogues cost
            t["fwd"]["order"] = {k: "n tiles" if gm._lib().grouped_matmul_gmm_n_major(K, N) else "units"
                                 for k, K, N in (("gu_act", D, 2 * I), ("down", I, D))}
            t["fwd"]["ms_by_order"] = {
                o: dict(gu_act=cuda_ms(lambda nm=nm: fem._launch_fwd_gu_act(xs, w["gate_up"], gub, plan, ends, act,
                                                                            limit, n_major=nm), iters=10),
                        down=cuda_ms(lambda nm=nm: fem._launch_fwd_down(fwd_mid, w["down"], db, plan, ends,
                                                                        n_major=nm), iters=10))
                for nm, o in ((False, "units"), (True, "n tiles"))}
            t["fwd"]["k2_gmm_same_operands_ms"] = dict(
                gate_up=cuda_ms(lambda: gm.gmm(xs, w["gate_up"], gs, plan=plan), iters=10),
                down=cuda_ms(lambda: gm.gmm(fwd_mid, w["down"], gs, plan=plan), iters=10))
            # bwd_gu and bwd_dwd each called alone (the pass inside), and with
            # JAX's fp32 weight grad (as the earlier fused kernels wrote it,
            # PERF.md) beside its bound; bwd_gu's product and bias sums apart
            t["bwd_gu"]["alone_ms"] = cuda_ms(lambda: fem.bwd_gu(xs, gu, dmid, gs, act, limit, biased, out_dtype=bf16),
                                              iters=10)
            t["bwd_gu"]["fp32_alone_ms"] = cuda_ms(lambda: fem.bwd_gu(xs, gu, dmid, gs, act, limit, biased), iters=10)
            t["bwd_gu"]["fp32_alone_bound_ms"] = fem_bound("bwd_gu", M, D, I, gs, biased)[0]
            t["bwd_gu"]["tgmm_ms"] = cuda_ms(lambda: gm._tgmm_launch(xs, dgdu, gs, bf16), iters=10)
            if biased:
                sums = torch.empty_like(got[2])
                t["bwd_gu"]["dgub_ms"] = cuda_ms(
                    lambda: fem._lib().fused_expert_mlp_bwd_dgub(gu.data_ptr(), dmid.data_ptr(), ends.data_ptr(),
                                                                 sums.data_ptr(), M, I, G, *fem._act_args(act, limit),
                                                                 fem._stream(gu)), iters=10)
                del sums
            t["bwd_dwd"]["alone_ms"] = cuda_ms(lambda: fem.bwd_dwd(gu, dy, gs, act, limit, biased, bf16), iters=10)
            t["bwd_dwd"]["fp32_alone_ms"] = cuda_ms(lambda: fem.bwd_dwd(gu, dy, gs, act, limit, biased), iters=10)
            t["bwd_dwd"]["fp32_alone_bound_ms"] = fem_bound("bwd_dwd", M, D, I, gs, biased)[0]
            t["bwd_dwd"]["ddb_ms"] = cuda_ms(
                lambda: fem._lib().fused_expert_mlp_bwd_ddb(dy.data_ptr(), ends.data_ptr(), got[4].data_ptr(), M, D, G,
                                                            fem._stream(dy)), iters=10)
            t["bwd_dx"]["alone_ms"] = cuda_ms(lambda: fem.bwd_dx(gu, dmid, w["gate_up"], gs, act, limit, plan=plan),
                                              iters=10)
            t["bwd_dx"]["order"] = "n tiles" if gm._lib().grouped_matmul_gmm_n_major(2 * I, D) else "units"
            t["bwd_dx"]["ms_by_order"] = {
                o: cuda_ms(lambda nm=nm: gm._gmm_launch(dgdu, w["gate_up"], gs, plan, D, True, nm), iters=10)
                for nm, o in ((False, "units"), (True, "n tiles"))}
            t["k3c_k3d_and_pass_ms"] = t["bwd_act"]["ms"] + t["bwd_dwd"]["ms"] + t["bwd_dx"]["ms"]
            t["k3_backward_kernels_ms"] = t["k3c_k3d_and_pass_ms"] + t["bwd_gu"]["ms"]
            # each weight grad written in bf16 is its fp32 sum rounded once
            dwd16 = fem.bwd_dwd(gu, dy, gs, act, limit, biased, bf16, mid=mid)[0]
            dw16, dbias16 = fem.bwd_gu(xs, gu, dmid, gs, act, limit, biased, dgdu=dgdu, out_dtype=bf16)
            row["dwd_bf16_equals_fp32_cast"] = bool(torch.equal(dwd16, got[3].to(bf16)))
            row["dw_bf16_equals_fp32_cast"] = bool(torch.equal(dw16, got[1].to(bf16))) and (
                dbias16 is None or bool(torch.equal(dbias16, got[2])))
            row["ok"] = row["ok"] and row["dwd_bf16_equals_fp32_cast"] and row["dw_bf16_equals_fp32_cast"]
            del fwd_mid, mid, dgdu, dwd16, dw16, dbias16
        results.append(row)
        print(f"kernel fused_expert_mlp vs plain: {json.dumps(row)}", flush=True)
        del xs, dy, got, gu, dmid, plan
        torch.cuda.empty_cache()
    weights.clear()
    torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise RuntimeError(f"fused expert-MLP kernels disagree with their plain versions (limits per row: out and "
                           f"dlhs {FEM_ROW_TOL}, dW {FEM_DW_ROW_TOL}, bias grads {FEM_BIAS_ROW_TOL}): {bad}")
    return {"cases": results}


def gemma_flash_entry(name: str, flash_cap: dict, gemma: dict, errs: tuple) -> dict:
    """One flash kernel on the Gemma 2 path: its launches in the Gemma run,
    its times at the causal and the 4096-window layer (cap 50, H=256), and
    its worst row error over the soft-cap cases."""
    timed = {("window" if c["case"].startswith("gemma2-9b window") else "causal"): c
             for c in flash_cap["cases"] if "timed" in c}
    out = dict(
        launches=gemma["flash_launches"][name],
        shape="B=1 S=8192 N=16 Nkv=8 H=256 scale 1/16 soft cap 50",
        max_row_rel_err=max(c[k] for c in flash_cap["cases"] for k in errs),
        max_abs_err=max(c["max_abs_err"][name] for c in flash_cap["cases"]),
        library="torch.compile(flex_attention) with a tanh score_mod and the block mask: its forward beside fwd, "
                "its backward alone (dq, dk and dv at once) beside dq + dkv under dq's backward; SDPA without the "
                "cap beside both",
    )
    for layer, c in timed.items():
        out[layer] = dict(c["timed"][name], live_pairs=c["live_pairs"])
        if name == "fwd":
            out[layer]["sdpa_no_cap_fwd_ms"] = c["sdpa_no_cap_fwd_ms"]
        if name == "dq":
            out[layer]["backward"] = dict(flash_backward_pair(c), sdpa_no_cap_bwd_ms=c["sdpa_no_cap_bwd_ms"],
                                          sdpa_no_cap_fwd_bwd_ms=c["sdpa_no_cap_fwd_bwd_ms"])
    return out


def sinks_flash_entry(name: str, sinks: dict) -> dict:
    """One flash kernel at GPT-OSS's attention shape (phase 11): its time,
    bound and library time with the 128 window and without (for dq, the
    library's backward beside dq + dkv)."""
    out = {}
    for c in sinks["cases"]:
        out[f"window {c['window']}"] = dict(c["timed"][name], library=c["library"], live_pairs=c["live_pairs"])
        if name == "dq":
            out[f"window {c['window']}"]["backward"] = flash_backward_pair(c)
    return out


def fused_entries(fused: dict, gpt_oss: dict, ptxas: list, sass: dict) -> list:
    """The ``kernels`` line's fused expert-MLP entries: phase 12's times at
    the gpt-oss gate-routed case, phase 13's launches, ptxas's report and
    the SASS reading of each kernel a call launches. The forward's two
    launches count as one call, their times apart beside the total and
    beside ``torch._grouped_mm`` alone on each. K3b, K3c and K3d are the
    elementwise pass (bwd_act, an entry of its own), K2's products and, for
    K3b and K3c, a bias-sum kernel: their ms are as the backward calls them
    (the pass's output given, the weight grads in bf16) and library_ms is
    torch._grouped_mm on the same operands; beside them each called alone,
    and with JAX's fp32 weight grad, as the earlier fused kernels wrote it
    (PERF.md)."""
    fmain = next(c for c in fused["cases"] if "timed" in c)
    entries = []
    outputs = dict(fwd=("out",), bwd_gu=("dw", "dbias"), bwd_act=("mid", "dgdu"), bwd_dwd=("dwd", "ddb"),
                   bwd_dx=("dlhs",))
    k2_source = "automodel_tpu_torch/csrc/grouped_matmul.cu"
    sources = dict(fwd=k2_source, bwd_gu=k2_source, bwd_dwd=k2_source, bwd_dx=k2_source)
    kernels_of = dict(fwd="gmm_act_kernel then gmm_bias_kernel (grouped_matmul.cu)",
                      bwd_gu="tgmm_kernel<true> (grouped_matmul.cu) on lhs and dg | du, bwd_dgub_kernel "
                             "(fused_expert_mlp.cu)",
                      bwd_act="bwd_act_kernel",
                      bwd_dwd="tgmm_kernel<true> (grouped_matmul.cu), bwd_ddb_kernel (fused_expert_mlp.cu)",
                      bwd_dx="gmm_kernel<true> (grouped_matmul.cu) over K = 2I")
    launched = dict(fwd=("gmm_act_kernel", "gmm_bias_kernel"), bwd_gu=("tgmm_kernel<1>", "bwd_dgub_kernel"),
                    bwd_act=("bwd_act_kernel",), bwd_dwd=("tgmm_kernel<1>", "bwd_ddb_kernel"),
                    bwd_dx=("gmm_kernel<1>",))
    # bwd_act replaces the activation of _bwd_gu_kernel (:423), _bwd_dwd_kernel (:530) and _bwd_dx_kernel (:615)
    for kind, line_no in (("fwd", 59), ("bwd_gu", 423), ("bwd_act", 615), ("bwd_dwd", 530), ("bwd_dx", 615)):
        t = fmain["timed"][kind]
        entry = {
            "name": f"fused_expert_mlp_{kind}",
            "route": "cuda",
            "source": sources.get(kind, "automodel_tpu_torch/csrc/fused_expert_mlp.cu"),
            "replaces": f"automodel_tpu/ops/fused_expert_mlp.py:{line_no}",
            "kernels": kernels_of[kind],
            "launches": gpt_oss["launches"][f"fem_{kind}"],
            "max_abs_err": max(c["max_abs_err"][k] for c in fused["cases"] for k in outputs[kind]
                               if k in c["max_abs_err"]),
            "max_row_rel_err": max(c["row_err"][k] for c in fused["cases"] for k in outputs[kind]
                                   if k in c["row_err"]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "composition: torch._grouped_mm products, activation and biases in eager torch",
            "shape": f"M={fmain['M']} D={fmain['D']} I={fmain['I']} G={fmain['G']}, gpt-oss gate-routed, "
                     f"swiglu_oai with expert biases",
            "ptxas": [u for u in ptxas if u["kernel"] in launched[kind]],
            "sass": {k: v for k, v in sass.items() if k in launched[kind]},
        }
        if kind == "fwd":
            entry.update(library="composition: torch._grouped_mm products, activation and biases in eager torch; "
                                 "gu_library_ms / down_library_ms: torch._grouped_mm alone on each launch's operands",
                         **{k: t[k] for k in ("gu_act_ms", "down_ms", "composition_ms", "gu_library_ms",
                                              "down_library_ms", "order", "ms_by_order", "k2_gmm_same_operands_ms")})
        elif kind == "bwd_act":
            entry.update(library="none: no one PyTorch call computes the activation and its gradient",
                         also_replaces=["automodel_tpu/ops/fused_expert_mlp.py:423",
                                        "automodel_tpu/ops/fused_expert_mlp.py:530"])
        else:
            entry.update(library="torch._grouped_mm alone on the materialized operand (dg | du, or mid)",
                         composition_ms=t["composition_ms"], alone_ms=t["alone_ms"],
                         **{k: t[k] for k in ("fp32_alone_ms", "fp32_alone_bound_ms", "tgmm_ms", "dgub_ms", "ddb_ms",
                                              "order", "ms_by_order") if k in t})
        entries.append(entry)
    return entries


# -- phase 20: speculative serving at Qwen3-30B-A3B's full width and depth ----


def moe_layers(engine) -> int:
    moe = getattr(engine.model, "moe_layers", None)
    return len(moe()) if moe else 0


def serve_and_count(torch, engine, prompts: list, shared: int, label: str) -> dict:
    """The main path's run: every kernel count set to 0 just before the
    requests, read just after. Checks (a) every request ends by length or
    stop, the pool audits clean and drains to fully available; (b) the
    paged kernel launched once a layer for each target decode or verify
    forward and once a draft layer for each draft forward, and gmm twice a
    MoE layer for every target forward (prefill chunks, decode and verify;
    nothing of the backward). → readings (tokens/s, TTFT p50, accept
    rate, drafts a second, the counts and their formulas)."""
    from automodel_tpu_torch.ops import grouped_matmul as gm
    from automodel_tpu_torch.ops.paged_attention import paged_attend

    max_new = engine.gen_config.max_new_tokens
    paged_attend.launches = gm.gmm.launches = gm.gmm.launches_t = gm.tgmm.launches = 0
    recs, wall = serve_requests(engine, prompts, shared, max_new)
    k4, k2 = paged_attend.launches, gm.gmm.launches
    k2_other = gm.gmm.launches_t + gm.tgmm.launches
    if len(recs) != len(prompts):
        raise RuntimeError(f"{label}: {len(recs)} records for {len(prompts)} requests")
    reasons = {r["completion_reason"] for r in recs}
    if not reasons <= {"length", "stop"}:
        raise RuntimeError(f"{label}: requests ended with {reasons}")
    engine.check_invariants()
    check_engine_healthy(engine, label)
    if engine.pool.available() != engine.pool.usable_blocks:
        raise RuntimeError(f"{label}: the pool holds {engine.pool.available()} of {engine.pool.usable_blocks} "
                           "blocks after every request ended")
    want_k4, k4_formula = spec_paged_launches([engine])
    n_moe = moe_layers(engine)
    forwards = engine.prefill_chunks + engine.decode_forwards + engine.spec_rounds
    want_k2 = 2 * n_moe * forwards
    k2_formula = (f"2 x {n_moe} MoE layers x ({engine.prefill_chunks} prefill chunks + {engine.decode_forwards} "
                  f"decode + {engine.spec_rounds} verify forwards) = {want_k2}")
    print(f"{label}: paged_attention launches {k4} = {k4_formula}; gmm launches {k2} = {k2_formula}", flush=True)
    if k4 != want_k4 or k4 == 0:
        raise RuntimeError(f"{label}: paged kernel launched {k4} times, want {k4_formula}")
    if k2 != want_k2 or (n_moe and k2 == 0) or k2_other:
        raise RuntimeError(f"{label}: gmm launched {k2} times (gmm_t and tgmm {k2_other}), want {k2_formula}")
    gen = sum(r["n_generated"] for r in recs)
    ttfts = sorted(r["ttft_s"] for r in recs)
    out = dict(
        requests=len(recs), generated_tokens=gen, prompt_tokens=sum(len(p) for p in prompts), wall_s=wall,
        tokens_per_s=gen / wall, ttft_p50_s=statistics.median(ttfts), ttft_max_s=ttfts[-1],
        reasons=sorted(reasons), prefill_chunks=engine.prefill_chunks, decode_forwards=engine.decode_forwards,
        verify_forwards=engine.spec_rounds, draft_forwards=draft_forwards(engine),
        paged_attend_launches=k4, paged_attend_formula=k4_formula, gmm_launches=k2, gmm_formula=k2_formula,
        accept_rate=engine.spec_accept_rate, spec_proposed=engine.spec_proposed_total,
        spec_accepted=engine.spec_accepted_total, spec_rounds=engine.spec_rounds,
        draft_tps=engine.spec_proposed_total / wall if engine.config.speculative.enabled else None,
        pool_gib=engine.pool_bytes / 2**30, draft_pool_gib=engine.draft_pool_bytes / 2**30,
    )
    print(f"{label}: {json.dumps(out)}", flush=True)
    out["records"] = recs
    return out


def last_logits(torch, model, ids: list[int]):
    """The full forward's logits at the last of ``ids`` (fp32)."""
    with torch.inference_mode():
        h = model.hidden(torch.tensor([ids], device=next(model.parameters()).device))
        h = h[0] if isinstance(h, tuple) else h
        return model.logits(h[0, -1]).float()


def compare_streams(torch, model, prompts: list, on: dict, off: dict, label: str) -> dict:
    """Spec-on greedy streams against spec-off ones: equal token for
    token, or first apart where the spec-off step's top two logits lie
    within LOGITS_REL_TOL of the step's largest |logit| of each other (a
    near tie that bf16 rounding between a one-token and a (k+1)-token
    forward may flip; phase 5's limit for fused against gather). Each
    near tie is printed; any other difference fails."""
    on = {r["request_id"]: r["tokens"] for r in on["records"]}
    off = {r["request_id"]: r["tokens"] for r in off["records"]}
    ties, bad, same = [], [], 0
    for i, prompt in enumerate(prompts):
        a, b = on[f"r{i}"], off[f"r{i}"]
        if a == b:
            same += 1
            continue
        j = next((t for t in range(min(len(a), len(b))) if a[t] != b[t]), min(len(a), len(b)))
        logits = last_logits(torch, model, prompt + b[:j])
        top = torch.topk(logits, 2).values
        gap, scale = float(top[0] - top[1]), float(logits.abs().max())
        entry = dict(request=f"r{i}", position=j, on=a[j] if j < len(a) else None,
                     off=b[j] if j < len(b) else None, top2_gap=gap, max_abs_logit=scale, rel_gap=gap / scale)
        (ties if gap <= LOGITS_REL_TOL * scale else bad).append(entry)
        print(f"{label}: {'near tie' if entry in ties else 'MISMATCH'} {json.dumps(entry)}", flush=True)
    if bad:
        raise RuntimeError(f"{label}: spec-on and spec-off streams differ away from a near tie: {bad}")
    return dict(identical=same, near_ties=ties)


def spec_off_engine(engine):
    """The same model, pool geometry and generation config with the draft
    off."""
    from automodel_tpu_torch.serving.engine import ServingEngine, SpeculativeConfig

    return ServingEngine(engine.auto, dataclasses.replace(engine.config, speculative=SpeculativeConfig()),
                         engine.gen_config)


def phase_spec_self_draft(torch) -> dict:
    """(d): Llama-3-8B widths cut to 4 layers, the draft given the
    target's config and weights: the accept rate must read at least
    SELF_DRAFT_MIN_ACCEPT, and the committed streams follow rule (c)."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.serving.server import build_engine

    engine = build_engine(ConfigNode(json.loads(json.dumps(SELF_DRAFT_LLAMA3_8B))))
    engine.draft_auto.model.load_state_dict(engine.auto.model.state_dict())
    prompts = make_prompts(8, 4, seed=5, vocab=engine.auto.config.vocab_size, max_len=1024)
    on = serve_and_count(torch, engine, prompts, 4, "self-draft llama-3-8b x4 spec on")
    engine.release_pools()
    off_engine = spec_off_engine(engine)
    del engine
    torch.cuda.empty_cache()
    off = serve_and_count(torch, off_engine, prompts, 4, "self-draft llama-3-8b x4 spec off")
    streams = compare_streams(torch, off_engine.auto.model, prompts, on, off, "self-draft streams")
    out = dict(accept_rate=on["accept_rate"], spec_proposed=on["spec_proposed"], spec_accepted=on["spec_accepted"],
               streams=streams)
    print(f"self-draft: {json.dumps(out)}", flush=True)
    if not on["accept_rate"] >= SELF_DRAFT_MIN_ACCEPT:
        raise RuntimeError(f"self-draft accept rate {on['accept_rate']} < {SELF_DRAFT_MIN_ACCEPT}")
    del off_engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_spec_serving(torch) -> dict:
    """Phase 20: speculative serving through the ``serve`` CLI's ``build_engine`` on
    serve_qwen3_moe_a3b_spec.yaml (as a dict): (a)-(b) 16 requests of
    128-1024 prompt tokens, 8 sharing a 512-token prefix, 64 new tokens,
    with the launch counts; a profile of verify rounds with every slot
    busy; (c) the same requests with the draft off (the streams held to
    each other) and one verify forward's logits through fused against
    gather; ``generate`` on the same model (the contiguous cache); (d) the
    self-draft check. (e) runs in phase 18, leg (a)."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.generation.engine import GenerationConfig, GenerationEngine
    from automodel_tpu_torch.serving.server import build_engine

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: the target alone is 61 GB
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = json.loads(json.dumps(SERVE_QWEN3_MOE_A3B_SPEC))
    cfg["model"]["hf_config"]["num_hidden_layers"] = SPEC_TARGET_LAYERS
    engine = build_engine(ConfigNode(cfg))
    auto = engine.auto
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in auto.model.parameters())
    n_draft = sum(p.numel() for p in engine.draft_auto.model.parameters())
    build_s = time.perf_counter() - t0
    print(f"model: Qwen3-30B-A3B ({auto.config.num_layers} layers, {n_params} params bf16) and Qwen3-0.6B draft "
          f"({engine.draft_auto.config.num_layers} layers, {n_draft} params), random init and pools {build_s:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)
    prompts = make_prompts(16, 8, seed=3, vocab=auto.config.vocab_size, max_len=1024)
    on = serve_and_count(torch, engine, prompts, 8, "spec serving qwen3-30b-a3b spec on")
    profile = phase_profile(torch, engine, steps=4, label="verify round profile (qwen3-30b-a3b, 16 slots)")
    peak_serving = torch.cuda.max_memory_allocated()
    engine.release_pools()
    off_engine = spec_off_engine(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    off = serve_and_count(torch, off_engine, prompts, 8, "spec serving qwen3-30b-a3b spec off")
    streams = compare_streams(torch, auto.model, prompts, on, off, "qwen3-30b-a3b streams")
    off_engine.release_pools()
    del off_engine
    torch.cuda.empty_cache()
    verify = phase_fused_vs_gather(torch, auto, draft_k=SERVE_QWEN3_MOE_A3B_SPEC["serving"]["speculative"]["k"],
                                   label="qwen3-30b-a3b verify forward")

    # generate on the same model: the contiguous-cache path
    gen_engine = GenerationEngine(auto, GenerationConfig(max_new_tokens=32, greedy=True, pad_to_multiple=16))
    g = torch.Generator().manual_seed(6)
    gen_prompts = [torch.randint(1, auto.config.vocab_size, (n,), generator=g).tolist() for n in (128, 256, 384, 512)]
    gen_engine.generate_ids(gen_prompts)  # warm-up
    res = gen_engine.generate_ids(gen_prompts)
    if res["gen_tokens"] != 4 * 32 or not res["decode_tps"] > 0:
        raise RuntimeError(f"generate on qwen3-30b-a3b: {res['gen_tokens']} tokens, {res['decode_tps']} tokens/s")
    generate = {k: res[k] for k in ("ttft_s", "decode_tps", "gen_tokens", "decode_steps", "cache_bytes")}
    print(f"generate qwen3-30b-a3b 4 x 32: {json.dumps(generate)}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    del auto, gen_engine
    gc.collect()
    torch.cuda.empty_cache()

    self_draft = phase_spec_self_draft(torch)
    keep = ("tokens_per_s", "ttft_p50_s", "accept_rate", "draft_tps", "wall_s", "verify_forwards", "draft_forwards",
            "decode_forwards", "prefill_chunks", "paged_attend_launches", "paged_attend_formula", "gmm_launches",
            "gmm_formula", "pool_gib", "draft_pool_gib")
    out = dict(
        spec_on={k: on[k] for k in keep}, spec_off={k: off[k] for k in keep}, streams=streams,
        verify_fused_vs_gather=verify, profile=profile, generate=generate, self_draft=self_draft,
        peak_gib_serving=peak_serving / 2**30, peak_gib=peak / 2**30, build_s=build_s,
        paged_attend_launches=on["paged_attend_launches"], gmm_launches=on["gmm_launches"],
    )
    print(f"phase 20 speculative serving: {json.dumps({k: v for k, v in out.items() if k != 'profile'})}",
          flush=True)
    return out


# -- phase 21: the serving front and the host spill tier ------------------------


def check_engine_healthy(engine, label: str, stalls: int = 0) -> None:
    """No rebuild may hide a kernel failure: an engine that served a phase
    must have rebuilt its pool for no error, and for a stall only where the
    phase planned one, and every spill extract must have succeeded."""
    if engine.error_total != 0 or engine.stall_total != stalls or engine.spill_errors != 0:
        raise RuntimeError(f"{label}: engine recovered from a fault (error_total {engine.error_total}, stall_total "
                           f"{engine.stall_total}, spill_errors {engine.spill_errors}, want 0, {stalls} and 0; "
                           f"last: {engine.last_fault})")


# automodel_tpu_torch/configs/serve_llama3_8b_front.yaml as a dict (the card
# has no YAML reader; tests/test_torch_serving_front.py checks the two agree)
SERVE_LLAMA3_8B_FRONT = dict(
    seed=0, device="cuda",
    model=dict(hf_config=dict(LLAMA3_8B), backend=dict(BF16)),
    generation=dict(max_new_tokens=32, greedy=True, eos_token_id=128001, pad_token_id=128001, seed=0),
    serving=dict(
        slots=16, block_size=16, num_blocks=4096, kv_cache_dtype="bf16", decode_kernel="auto",
        prefill_chunk=512, max_seq_len=4096, max_queue=8, prefix_cache=True,
        http=dict(host="127.0.0.1", port=8000),
        qos=dict(enabled=True, tenants=dict(a=dict(tier="interactive"),
                                            b=dict(tier="batch", requests_per_s=2.0, burst_s=1.0))),
        drain=dict(grace_s=30.0, requeue_exit="auto"),
        watchdog=dict(enabled=True),
        kv_spill=dict(enabled=True, max_host_mb=4096),
        speculative=dict(enabled=False),
        limits=dict(deadline_s=600.0, max_queue_wait_s=120.0),
    ),
)
# phase 22: phase 21's front with tracing on
TRACED_REQUESTS = 16
TRACED_MAX_NEW = 64
TRACE_SLACK_S = 1e-3  # a child span within 1 ms of its root's interval
# phase 23 (a): configs/sft_llama3_8b_full.yaml as a dict
# (tests/test_torch_optim_more.py checks the two agree)
SFT_LLAMA3_8B_FULL = dict(
    seed=42,
    model=dict(
        hf_config=dict(LLAMA3_8B),
        backend=dict(attn="flash", param_dtype="bfloat16", compute_dtype="bfloat16", remat="full"),
    ),
    dataset=dict(_target_="automodel_tpu_torch.data.sft.MockSFTDataset", vocab_size=128256,
                 seq_length=4096, num_samples=1024),
    dataloader=dict(global_batch_size=1),
    step_scheduler=dict(grad_acc_steps=1, num_epochs=1, log_every_steps=10),
    optimizer=dict(name="adamw", lr=1e-5, weight_decay=0.01, betas=[0.9, 0.95], grad_clip_norm=1.0,
                   moments_dtype="param", lr_schedule=dict(style="cosine", warmup_steps=100, decay_steps=2000)),
    loss_fn=dict(name="fused_linear_ce"),
    logging=dict(metrics_path="runs/torch_sft_llama3_8b_full/train_metrics.jsonl"),
)
FULL_STEPS = 4
TRAIN_DEVICE = "cuda"  # phase 23's recipes (a CPU rehearsal sets "cpu")
FULL_PEAK_GIB = 79.0
# (b): step 1's update on the card against the CPU's, the held tensors
OPTIMIZERS_ON_CARD = ("lion", "sgd", "adafactor", "muon")
# a constant lr for each, large enough that step 1 moves bf16 weights
# (a bf16 step is 2^-8 of a weight): lion moves each by lr, sgd by lr x g
# under a clipped grad norm of 1, adafactor by lr x the leaf's RMS, and
# muon's Adam branch by about lr
OPT_LR = dict(lion=1e-3, sgd=10.0, adafactor=1e-2, muon=1e-3)
OPT_LAYERS = 2
OPT_STEPS = 3
OPT_MAX_DIFFERING = 1e-3  # share of the held elements apart
OPT_MAX_BF16_STEPS = 2
# (c): rollback
ROLLBACK_STEPS = 4
ROLLBACK_FAIL_STEP = 3

# phase 24: configs/pretrain_llama3_8b_megatron.yaml as a dict
# (tests/test_torch_data_megatron.py checks the two agree): Llama-3-8B at
# its published widths and 32 layers on a Megatron corpus, prefetch on
PRETRAIN_LLAMA3_8B_MEGATRON = dict(
    seed=42,
    model=dict(
        hf_config=dict(LLAMA3_8B),
        backend=dict(attn="flash", param_dtype="bfloat16", compute_dtype="bfloat16", remat="full"),
    ),
    dataset=dict(_target_="automodel_tpu.data.megatron.gpt_dataset.MegatronPretraining",
                 paths="runs/megatron_llama3/corpus", seq_length=4096),
    dataloader=dict(global_batch_size=1),
    data=dict(prefetch=dict(depth=2, collate_workers=2)),
    step_scheduler=dict(grad_acc_steps=1, num_epochs=1, log_every_steps=10),
    optimizer=dict(name="adamw", lr=1e-5, weight_decay=0.01, betas=[0.9, 0.95], grad_clip_norm=1.0,
                   moments_dtype="param", lr_schedule=dict(style="cosine", warmup_steps=100, decay_steps=2000)),
    loss_fn=dict(name="fused_linear_ce"),
    logging=dict(metrics_path="runs/torch_pretrain_llama3_8b_megatron/train_metrics.jsonl"),
)
DATA_CORPUS_TOKENS = 2**27  # 512 MiB of uint32 tokens
DATA_DOC_MEDIAN = 1536  # log-normal document lengths, clipped to 16-16,384
DATA_NANOGPT_SOURCES = 3
DATA_NANOGPT_SHARDS = 2
DATA_NANOGPT_SHARD_TOKENS = 2**23
DATA_NANOGPT_WEIGHTS = (1.0, 2.0, 1.0)
DATA_STEPS = 6
# phase 24 (b) and phase 25 (a)-(b) at 8 of Llama-3-8B's 32 layers: the
# whole script read up to 1185.5 s of its 1200 s on one card at 16, with
# phases 27 and 28 to fit, so the depth of these runs was cut
DATA_PRETRAIN_LAYERS = 8
DATA_PEAK_GIB = 79.0
DATA_PACKED_LAYERS = 8
DATA_RESUME_LAYERS = 2
DATA_SAVE_STEP = 2

# (a)/(b): a 512-block pool (0.25 GiB bf16 at 8 layers) holds about three
# groups of a 2048-token shared prefix (128 blocks) + a 64-token suffix + 32
# new tokens
FRONT_POOL_BLOCKS = 512
# 2 rounds and 4 bf16 groups (from 3 and 8) for phase 25's time
FRONT_PREFIX, FRONT_SUFFIX, FRONT_NEW, FRONT_ROUNDS = 2048, 64, 32, 2
FRONT_GROUPS = {"bf16": 4, "int8": 4}
# a spill-on stream may leave a spill-off one only where the spill-off
# step's top two logits lie within this many bf16 ulps of the top one
FRONT_TIE_ULPS = 3
# (e): a stall past the watchdog's largest deadline
FRONT_WATCHDOG = dict(min_deadline_s=2.0, max_deadline_s=4.0, multiplier=2.0, compile_grace_s=120.0,
                      poll_interval_s=0.05)
FRONT_STALL_S = 6.0
# phases 21 and 22 at 8 of Llama-3-8B's 32 layers: the whole script read
# 923.7-1185.5 s of its 1200 s on one card at 16, the host-bound phases
# 30% apart between calls, with phase 28 to fit
FRONT_LAYERS = 8


def front_config(**serving) -> dict:
    cfg = json.loads(json.dumps(SERVE_LLAMA3_8B_FRONT))
    cfg["model"]["hf_config"]["num_hidden_layers"] = FRONT_LAYERS
    cfg["serving"].update(serving)
    return cfg


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0**-133


def spill_prompts(groups: int, vocab: int, seed: int) -> list:
    """[(request id, prompt)] in arrival order: ``groups`` distinct
    2048-token prefixes, each arriving FRONT_ROUNDS times round-robin with
    a distinct 64-token suffix, so every return to a group comes after the
    other groups churned the pool."""
    import random

    rng = random.Random(seed)
    prefixes = [[rng.randrange(1, vocab) for _ in range(FRONT_PREFIX)] for _ in range(groups)]
    out = []
    for r in range(FRONT_ROUNDS):
        for g in range(groups):
            out.append((f"g{g}r{r}", prefixes[g] + [rng.randrange(1, vocab) for _ in range(FRONT_SUFFIX)]))
    return out


def expected_spill_counts(prompts: list, block_size: int, num_blocks: int, payload_bytes: int,
                          max_host_bytes: int) -> dict:
    """The engine's one-slot schedule replayed on the host: the allocator
    and the spill tier with placeholder payloads of the real size, the same
    match → allocate (evictions spill) → reload lookup → register → free
    order as ``ServingEngine._admit`` and ``_terminate``. → the counters the
    spill-on engine must read."""
    from automodel_tpu_torch.serving.block_pool import BlockPool, HostSpillTier, blocks_needed, prompt_chain

    pool = BlockPool(num_blocks, block_size)
    pool.spill = tier = HostSpillTier(max_host_bytes)

    def on_evict(evicted):
        for h, _ in evicted:
            if tier.put(h, ("payload", h), payload_bytes):
                pool.counters["spilled_blocks"] += 1

    pool.on_evict = on_evict
    for _, p in prompts:
        hits, _ = pool.match_prefix(p)
        fresh = pool.allocate(blocks_needed(len(p) + FRONT_NEW, block_size) - len(hits))
        n = 0
        for h in prompt_chain(p, block_size)[len(hits):]:
            if n >= len(fresh) or tier.get(h) is None:
                break
            n += 1
        if n:
            pool.counters["spill_reloads"] += 1
            pool.counters["spill_reloaded_blocks"] += n
        pool.register_prefix(p, hits + fresh)
        pool.free(hits + fresh)
        pool.check_invariants()
    keys = ("spill_reloads", "spill_reloaded_blocks", "spilled_blocks", "evictions")
    return {k: pool.counters[k] for k in keys}


def bits(t):
    """A host tensor's bits, for bit-exact comparison (bf16 -0.0 != 0.0)."""
    import torch

    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32) if t.dtype == torch.float32 else t


def same_payload(torch, a, b) -> bool:
    def flat(x):
        return list(x) if isinstance(x, tuple) else [x]

    return all(torch.equal(bits(x), bits(y)) for side in ("k", "v") for x, y in zip(flat(a[side]), flat(b[side])))


def front_round_trip(torch, engine, label: str) -> dict:
    """extract → inject → extract of 128 blocks of the engine's pool,
    bit-identical (an int8 pool's scales included), with each move's time
    and rate."""
    from automodel_tpu_torch.serving import paged

    src = list(range(1, 129))
    dst = list(range(129, 257))
    pool = engine.kv_pool
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k, v = paged.extract_blocks(pool, src)
    extract_s = time.perf_counter() - t0
    payload = {"k": k, "v": v}
    nbytes = paged.kv_nbytes(payload)
    t0 = time.perf_counter()
    paged.inject_blocks(pool, dst, payload)
    torch.cuda.synchronize()
    inject_s = time.perf_counter() - t0
    k2, v2 = paged.extract_blocks(pool, dst)
    if not same_payload(torch, payload, {"k": k2, "v": v2}):
        raise RuntimeError(f"{label}: extract → inject → extract of 128 blocks is not bit-identical")
    out = dict(blocks=128, bytes=nbytes, extract_ms=extract_s * 1e3, inject_ms=inject_s * 1e3,
               extract_gb_s=gbps(nbytes, extract_s), inject_gb_s=gbps(nbytes, inject_s), bit_identical=True)
    print(f"{label} round trip: {json.dumps(out)}", flush=True)
    return out


def drive_front_leg(torch, engine, prompts: list, label: str) -> dict:
    """One request at a time (the one slot), each run to its end, the
    allocator and tier audited after each; the paged kernel's count set to
    0 just before and read just after. → readings and the records."""
    from automodel_tpu_torch.ops.paged_attention import paged_attend

    layers = engine.auto.config.num_layers
    df0 = engine.decode_forwards
    # host seconds inside the spill hook (extract at eviction) and the
    # reload (tier lookups, concatenation, inject) of the spill-on engine
    spent = dict(extract_s=0.0, extracts=0, reload_s=0.0, reloads=0)

    def timed(fn, key):
        def run(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spent[key + "_s"] += time.perf_counter() - t
                spent[key + "s"] += 1
        return run

    if engine.pool.spill is not None:
        engine.pool.on_evict = timed(engine._spill_evicted, "extract")
        engine._resolve_hierarchy = timed(engine._resolve_hierarchy, "reload")
    paged_attend.launches = 0
    recs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, p in prompts:
        engine.submit(p, request_id=rid, max_new_tokens=FRONT_NEW)
        for r in engine.run():
            recs[r["request_id"]] = r
        engine.check_invariants()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4, forwards = paged_attend.launches, engine.decode_forwards - df0
    if k4 != forwards * layers or k4 == 0:
        raise RuntimeError(f"{label}: paged kernel launched {k4} times for {forwards} decode forwards x {layers}")
    if sorted(recs) != sorted(rid for rid, _ in prompts):
        raise RuntimeError(f"{label}: records {sorted(recs)} for requests {[rid for rid, _ in prompts]}")
    reasons = {r["completion_reason"] for r in recs.values()}
    if not reasons <= {"length", "stop"}:
        raise RuntimeError(f"{label}: requests ended with {reasons}")
    check_engine_healthy(engine, label)
    ttfts = [r["ttft_s"] for r in recs.values()]
    # TTFT of the requests after the first round: reload (spill on) or
    # prefill (spill off) of the evicted prefix
    later = sorted(r["ttft_s"] for rid, r in recs.items() if not rid.endswith("r0"))
    gen = sum(r["n_generated"] for r in recs.values())
    out = dict(requests=len(recs), generated_tokens=gen, wall_s=wall, tokens_per_s=gen / wall,
               ttft_p50_s=statistics.median(ttfts), ttft_p50_returning_s=statistics.median(later),
               decode_forwards=forwards, paged_attend_launches=k4, prefill_chunks=engine.prefill_chunks,
               spill_host=spent if engine.pool.spill is not None else None,
               counters={k: engine.pool.counters[k] for k in
                         ("spill_reloads", "spill_reloaded_blocks", "spilled_blocks", "evictions",
                          "prefix_hit_tokens", "prefix_miss_tokens")})
    print(f"{label}: {json.dumps(out)}", flush=True)
    out["records"] = recs
    return out


def compare_front_streams(torch, model, prompts: list, on: dict, off: dict, label: str) -> dict:
    """Spill-on greedy streams against spill-off ones: equal, or first apart
    where the spill-off step's top two logits (a full forward) lie within
    FRONT_TIE_ULPS bf16 ulps of the top one; each such tie printed."""
    ties, bad, same = [], [], 0
    for rid, prompt in prompts:
        a, b = on["records"][rid]["tokens"], off["records"][rid]["tokens"]
        if a == b:
            same += 1
            continue
        j = next((t for t in range(min(len(a), len(b))) if a[t] != b[t]), min(len(a), len(b)))
        logits = last_logits(torch, model, prompt + b[:j])
        top = torch.topk(logits, 2).values
        gap, ulp = float(top[0] - top[1]), bf16_ulp(float(top[0]))
        entry = dict(request=rid, position=j, on=a[j] if j < len(a) else None, off=b[j] if j < len(b) else None,
                     top2_gap=gap, top1_ulp=ulp, gap_ulps=gap / ulp)
        (ties if gap <= FRONT_TIE_ULPS * ulp else bad).append(entry)
        print(f"{label}: {'near tie' if entry in ties else 'MISMATCH'} {json.dumps(entry)}", flush=True)
    if bad:
        raise RuntimeError(f"{label}: spill-on and spill-off streams differ away from a near tie: {bad}")
    return dict(identical=same, near_ties=ties)


def front_spill_ab(torch, auto, dtype: str) -> dict:
    """(a) / (b): the spill A/B on one pool dtype."""
    from automodel_tpu_torch.generation.engine import GenerationConfig
    from automodel_tpu_torch.serving import paged
    from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine

    groups = FRONT_GROUPS[dtype]
    label = f"front (a) spill bf16 x{groups}" if dtype == "bf16" else f"front (b) spill int8 x{groups}"
    prompts = spill_prompts(groups, auto.config.vocab_size, seed=21 if dtype == "bf16" else 22)
    cfg = front_config(slots=1, num_blocks=FRONT_POOL_BLOCKS, kv_cache_dtype=dtype, max_seq_len=4096,
                       qos=dict(enabled=False), max_queue=64)
    gen = GenerationConfig.from_dict(cfg["generation"])
    legs, trip, tier_state = {}, None, None
    for spill in (True, False):
        scfg = dict(cfg["serving"], kv_spill=dict(cfg["serving"]["kv_spill"], enabled=spill))
        engine = ServingEngine(auto, ServeConfig.from_dict(scfg), gen)
        if spill:
            # one payload block's host bytes, for the schedule's replay
            payload_bytes = paged.kv_nbytes(dict(zip(("k", "v"), paged.extract_blocks(engine.kv_pool, [1]))))
            want = expected_spill_counts(prompts, engine.config.block_size, FRONT_POOL_BLOCKS, payload_bytes,
                                         engine.pool.spill.max_bytes)
        leg = drive_front_leg(torch, engine, prompts, f"{label} spill {'on' if spill else 'off'}")
        if spill:
            got = {k: leg["counters"][k] for k in want}
            print(f"{label}: spill counters {json.dumps(got)}, derived from the schedule {json.dumps(want)}",
                  flush=True)
            if got != want or got["spill_reloads"] == 0:
                raise RuntimeError(f"{label}: spill counters {got} != the schedule's {want}")
            tier = engine.pool.spill
            tier.check_invariants()
            tier_state = dict(spill_bytes=tier.bytes, spill_entries=len(tier), **tier.counters)
            print(f"{label}: spill tier {json.dumps(tier_state)}", flush=True)
            trip = front_round_trip(torch, engine, label)
        legs["on" if spill else "off"] = leg
        engine.release_pools()
        del engine
        torch.cuda.empty_cache()
    streams = compare_front_streams(torch, auto.model, prompts, legs["on"], legs["off"], f"{label} streams")
    keep = ("tokens_per_s", "ttft_p50_s", "ttft_p50_returning_s", "wall_s", "decode_forwards",
            "paged_attend_launches", "prefill_chunks", "counters", "spill_host")
    out = dict(spill_on={k: legs["on"][k] for k in keep}, spill_off={k: legs["off"][k] for k in keep},
               expected=want, tier=tier_state, round_trip=trip, streams=streams,
               paged_attend_launches=legs["on"]["paged_attend_launches"] + legs["off"]["paged_attend_launches"])
    print(f"{label}: {json.dumps(out)} | {card_line()}", flush=True)
    return out


def http_call(port: int, path: str, body: dict | None = None, headers: dict | None = None, timeout: float = 120):
    """→ (status, JSON body, headers) of one loopback request."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            return resp.status, (json.loads(raw) if path != "/metrics" else raw.decode()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def parse_metrics(text: str) -> dict:
    """Prometheus text exposition → {sample name with labels: value}; every
    line must be a comment or ``name[{labels}] value``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not name or (" " in name and "{" not in name):
            raise RuntimeError(f"/metrics line does not parse: {line!r}")
        out[name] = float(value)
    return out


def front_http(torch, auto) -> dict:
    """(c) and (d): the HTTP front with QoS, then its drain."""
    import signal
    import threading

    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.generation.engine import GenerationConfig
    from automodel_tpu_torch.ops.paged_attention import paged_attend
    from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine
    from automodel_tpu_torch.serving.server import _drain_exit_code, start_http_front, stats_snapshot

    cfg = ConfigNode(front_config(http=dict(host="127.0.0.1", port=0)))
    records = []
    engine = ServingEngine(auto, ServeConfig.from_dict(cfg.serving.to_dict()),
                           GenerationConfig.from_dict(cfg.generation.to_dict()), on_record=records.append)
    engine.boot_t = time.perf_counter()
    engine.start_watchdog()
    prior = signal.getsignal(signal.SIGTERM)
    df0 = engine.decode_forwards
    paged_attend.launches = 0
    server, loop, handler, state = start_http_front(engine, cfg.serving.http.to_dict())
    serve_thread = threading.Thread(target=server.serve_forever, name="front-http", daemon=True)
    serve_thread.start()
    port = server.server_address[1]
    try:
        code, ready, _ = http_call(port, "/readyz")
        if code != 200 or not ready["ready"]:
            raise RuntimeError(f"front (c): /readyz after the warm-up answered {code} {ready}")
        # /healthz polled through the traffic
        health, stop_health = [], threading.Event()

        def poll_health():
            while not stop_health.is_set():
                health.append(http_call(port, "/healthz", timeout=30)[0])
                time.sleep(0.1)

        import random

        rng = random.Random(23)
        vocab = auto.config.vocab_size
        jobs = []
        for i in range(32):
            tenant = "a" if i % 2 == 0 else "b"
            body = dict(prompt_ids=[rng.randrange(1, vocab) for _ in range(rng.randint(128, 512))],
                        max_new_tokens=32)
            headers = {}
            if i % 4 < 2:
                body["tenant"] = tenant
            else:
                headers["X-Tenant-Id"] = tenant
            jobs.append((body, headers))
        answers = [None] * len(jobs)

        def client(c):
            for j in range(c, len(jobs), 8):
                answers[j] = http_call(port, "/generate", *jobs[j])

        health_thread = threading.Thread(target=poll_health, daemon=True)
        health_thread.start()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        stop_health.set()
        health_thread.join(timeout=30)
        if any(t.is_alive() for t in clients) or any(a is None for a in answers):
            raise RuntimeError("front (c): a client got no answer within 300 s")
        codes = [a[0] for a in answers]
        for code, body, headers in answers:
            if code not in (200, 429, 503) or (code != 200 and "Retry-After" not in headers):
                raise RuntimeError(f"front (c): answer {code} {body} {headers}")
        if set(health) != {200}:
            raise RuntimeError(f"front (c): /healthz answered {sorted(set(health))} during the traffic")
        reqs = [r for r in records if r.get("event") == "serve_request" and r["request_id"] != "__warmup__"]
        by_reason = {}
        for r in reqs:
            by_reason[r["completion_reason"]] = by_reason.get(r["completion_reason"], 0) + 1
        if len(reqs) != len(jobs) or len({r["request_id"] for r in reqs}) != len(reqs):
            raise RuntimeError(f"front (c): {len(reqs)} terminal records for {len(jobs)} requests")
        ended = dict(by_reason)
        ended["completed"] = ended.pop("length", 0) + ended.pop("stop", 0)
        answered = {"completed": codes.count(200), "quota": codes.count(429), "shed": codes.count(503)}
        if {k: v for k, v in ended.items() if v} != {k: v for k, v in answered.items() if v}:
            raise RuntimeError(f"front (c): records by reason {by_reason} != answers {answered}")
        ok_ids = {a[1]["request_id"] for a in answers if a[0] == 200}
        if ok_ids != {r["request_id"] for r in reqs if r["completion_reason"] in ("length", "stop")}:
            raise RuntimeError("front (c): the 200 answers are not the completed records")
        code, stats, _ = http_call(port, "/stats")
        warm = 1  # the warm-up request completed too
        want = dict(completed_total=ended["completed"] + warm, quota_total=ended.get("quota", 0),
                    shed_total=ended.get("shed", 0), failed_total=len(reqs) - ended["completed"],
                    stall_total=0, error_total=0)
        if any(stats[k] != v for k, v in want.items()):
            raise RuntimeError(f"front (c): /stats { {k: stats[k] for k in want} } != the records' {want}")
        tenants = stats["qos"]["tenants"]
        if tenants["b"]["quota"] != ended.get("quota", 0) or not tenants["a"]["completed"]:
            raise RuntimeError(f"front (c): /stats qos tenants {tenants}")
        code, text, _ = http_call(port, "/metrics")
        m = parse_metrics(text)
        pairs = dict(completed_total="automodel_serve_requests_completed_total",
                     failed_total="automodel_serve_requests_failed_total",
                     quota_total="automodel_serve_requests_quota_total",
                     shed_total="automodel_serve_requests_shed_total",
                     stall_total="automodel_serve_engine_stalls_total",
                     error_total="automodel_serve_engine_errors_total",
                     queue_depth="automodel_serve_queue_depth")
        pairs.update({f"allocator.{k}": f"automodel_serve_block_{k}_total" for k in stats["allocator"]})
        for key, name in pairs.items():
            have = stats["allocator"][key.split(".")[1]] if key.startswith("allocator.") else stats[key]
            if m.get(name) != float(have):
                raise RuntimeError(f"front (c): /metrics {name} = {m.get(name)} but /stats {key} = {have}")
        k4, forwards = paged_attend.launches, engine.decode_forwards - df0
        layers = auto.config.num_layers
        if k4 != forwards * layers or k4 == 0:
            raise RuntimeError(f"front (c): paged kernel launched {k4} times for {forwards} decode forwards x {layers}")
        ttfts = sorted(r["ttft_s"] for r in reqs if "ttft_s" in r)
        gen = sum(r["n_generated"] for r in reqs)
        http = dict(requests=len(jobs), answers={str(c): codes.count(c) for c in sorted(set(codes))},
                    records_by_reason=by_reason, wall_s=wall, tokens_per_s=gen / wall,
                    ttft_p50_s=statistics.median(ttfts), healthz_polls=len(health),
                    decode_forwards=forwards, paged_attend_launches=k4,
                    metrics_samples=len(m), time_to_ready_s=stats["time_to_ready_s"])
        print(f"front (c) http + qos: {json.dumps(http)} | {card_line()}", flush=True)

        # (d): the drain, while 16 requests are in flight and 6 queued
        n_before = len(records)
        drain_jobs = [dict(prompt_ids=[rng.randrange(1, vocab) for _ in range(256)], max_new_tokens=192,
                           tenant="a") for _ in range(22)]
        drain_answers = [None] * len(drain_jobs)

        def drain_client(j):
            drain_answers[j] = http_call(port, "/generate", drain_jobs[j])

        dclients = [threading.Thread(target=drain_client, args=(j,), daemon=True) for j in range(len(drain_jobs))]
        term = signal.getsignal(signal.SIGTERM)
        if handler is None or term != handler._handle:
            raise RuntimeError(f"front (d): the SIGTERM handler is {term}, not the drain's")

        def frozen_when(cond, what):
            """Poll the engine under the loop's lock; → with the lock HELD
            once ``cond(busy, queued, ended)`` holds."""
            deadline = time.monotonic() + 120
            while True:
                loop.lock.acquire()
                state_ = (engine.busy_slots, engine.queue_depth,
                          sum(r.get("event") == "serve_request" for r in records[n_before:]))
                if cond(*state_):
                    return state_
                loop.lock.release()
                if time.monotonic() > deadline:
                    raise RuntimeError(f"front (d): {what} not reached: busy, queued, ended {state_}")
                time.sleep(0.005)

        slots, cap = engine.config.slots, engine.config.max_queue
        # every slot busy first, in bursts the queue holds (a burst past
        # max_queue between two steps is shed), then a queue
        started = 0
        while started < slots:
            n = min(cap, slots - started)
            for t in dclients[started:started + n]:
                t.start()
            started += n
            frozen_when(lambda busy, queued, ended: busy + ended == started, f"{started} admitted")
            loop.lock.release()
        for t in dclients[slots:]:
            t.start()
        busy, queued, ended = frozen_when(
            lambda busy, queued, ended: busy + queued + ended == len(drain_jobs) and busy == slots and queued,
            "every request admitted or queued")
        try:
            t_term = time.perf_counter()
            term(signal.SIGTERM, None)  # as SIGTERM would
            while not engine.draining and time.perf_counter() - t_term < 30:
                time.sleep(0.001)
        finally:
            loop.lock.release()
        code, ready, _ = http_call(port, "/readyz")
        late = http_call(port, "/generate", dict(prompt_ids=[1, 2, 3], max_new_tokens=4, tenant="a"))
        if code != 503 or ready["ready"] or not ready["draining"]:
            raise RuntimeError(f"front (d): /readyz while draining answered {code} {ready}")
        if late[0] != 503 or "Retry-After" not in late[2] or late[1].get("reason") != "draining":
            raise RuntimeError(f"front (d): a POST while draining answered {late}")
        for t in dclients:
            t.join(timeout=120)
        serve_thread.join(timeout=120)
        if serve_thread.is_alive() or any(a is None for a in drain_answers):
            raise RuntimeError("front (d): the drain did not end the front within 120 s")
        drain_s = time.perf_counter() - t_term
        drained = [r for r in records[n_before:] if r.get("event") == "serve_request"]
        reasons = sorted("completed" if r["completion_reason"] in ("length", "stop") else r["completion_reason"]
                         for r in drained)
        if reasons != ["completed"] * (busy + ended) + ["draining"] * queued or not all(
                r["retriable"] for r in drained if r["completion_reason"] == "draining"):
            raise RuntimeError(f"front (d): drained records {reasons} (busy {busy}, queued {queued}, ended {ended})")
        dcodes = sorted(a[0] for a in drain_answers)
        if dcodes != [200] * (busy + ended) + [503] * queued or not all("Retry-After" in a[2] for a in drain_answers if a[0] == 503):
            raise RuntimeError(f"front (d): answers {dcodes}")
        if engine.drain_duration_s is None or state["rc"] != _drain_exit_code(engine.config.drain):
            raise RuntimeError(f"front (d): drain_duration_s {engine.drain_duration_s}, exit code {state['rc']}")
        check_engine_healthy(engine, "front (c)-(d)")
        events = [r for r in records if r.get("event") == "serve_engine_event"]
        if events:
            raise RuntimeError(f"front (c)-(d): unplanned engine events {events}")
        with loop.lock:
            final = stats_snapshot(engine)
        drain = dict(in_flight=busy, queued=queued, drain_duration_s=engine.drain_duration_s, drain_wall_s=drain_s,
                     exit_code=state["rc"], late_post=late[0], retry_after=late[2].get("Retry-After"),
                     completed_total=final["completed_total"], failed_total=final["failed_total"])
        print(f"front (d) drain: {json.dumps(drain)}", flush=True)
        k4_total = paged_attend.launches
    finally:
        server.shutdown()
        server.server_close()
        loop.close()
        engine.stop_watchdog()
        if handler is not None:
            handler.restore()
        if signal.getsignal(signal.SIGTERM) != prior:
            signal.signal(signal.SIGTERM, prior)
    engine.release_pools()
    return dict(http=http, drain=drain, paged_attend_launches=k4_total,
                decode_forwards=engine.decode_forwards - df0)


def front_watchdog(torch, auto) -> dict:
    """(e): one planned stall around a real decode launch."""
    import tempfile

    from automodel_tpu_torch.generation.engine import GenerationConfig
    from automodel_tpu_torch.ops.paged_attention import paged_attend
    from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine
    from automodel_tpu_torch.telemetry.flight_recorder import FlightRecorder, build_fingerprint

    cfg = front_config(num_blocks=FRONT_POOL_BLOCKS, watchdog=FRONT_WATCHDOG, qos=dict(enabled=False),
                       kv_spill=dict(enabled=False))
    events = []
    engine = ServingEngine(auto, ServeConfig.from_dict(cfg["serving"]), GenerationConfig.from_dict(cfg["generation"]),
                           on_record=events.append)
    tmp = tempfile.mkdtemp(prefix="front_watchdog_")
    recorder = FlightRecorder(path=os.path.join(tmp, "flight_recorder.json"), fingerprint=build_fingerprint(cfg))
    import random

    rng = random.Random(24)
    prompts = [[rng.randrange(1, auto.config.vocab_size) for _ in range(256)] for _ in range(4)]
    pool_bytes = engine.pool_bytes
    df0 = engine.decode_forwards
    paged_attend.launches = 0
    wd = engine.start_watchdog(flight_recorder=recorder, stacks_path=os.path.join(tmp, "watchdog_stacks.txt"))
    try:
        def run(tag):
            engine.touch_watchdog()
            for i, p in enumerate(prompts):
                engine.submit(p, request_id=f"{tag}{i}", max_new_tokens=16)
            return {r["request_id"]: r for r in engine.run()}

        ref = run("ref")
        # the stall: a wave that has run one real decode step, then a decode
        # program wrapped once with a sleep past the largest deadline
        engine.touch_watchdog()
        for i, p in enumerate(prompts):
            engine.submit(p, request_id=f"stall{i}", max_new_tokens=16)
        df = engine.decode_forwards
        done = []
        while engine.decode_forwards == df:
            done += engine.step()
        real = engine._decode

        def stalled(*a, **k):
            engine._decode = real
            time.sleep(FRONT_STALL_S)
            return real(*a, **k)

        engine._decode = stalled
        t0 = time.perf_counter()
        done += engine.step()
        stall_step_s = time.perf_counter() - t0
        after = run("after")
    finally:
        engine.stop_watchdog()
    stalled_recs = sorted((r["request_id"], r["completion_reason"], r["retriable"]) for r in done)
    if stalled_recs != [(f"stall{i}", "engine_stall", True) for i in range(4)]:
        raise RuntimeError(f"front (e): the stalled wave ended {stalled_recs}")
    check_engine_healthy(engine, "front (e)", stalls=1)
    got_events = [(e.get("event"), e.get("reason")) for e in events if e.get("event") == "serve_engine_event"]
    if got_events != [("serve_engine_event", "engine_stall")] or wd.fired_total != 1:
        raise RuntimeError(f"front (e): engine events {got_events}, watchdog fired {wd.fired_total} times")
    engine.check_invariants()
    if engine.pool_bytes != pool_bytes or engine.pool.available() != engine.pool.usable_blocks:
        raise RuntimeError(f"front (e): pool {engine.pool_bytes} bytes (was {pool_bytes}), "
                           f"{engine.pool.available()} of {engine.pool.usable_blocks} blocks free")
    files = {n: os.path.getsize(os.path.join(tmp, n)) for n in ("flight_recorder.json", "watchdog_stacks.txt")}
    with open(os.path.join(tmp, "flight_recorder.json")) as f:
        dump = json.load(f)
    if dump.get("reason") != "engine_stall" or "Thread" not in open(os.path.join(tmp, "watchdog_stacks.txt")).read():
        raise RuntimeError(f"front (e): flight recorder reason {dump.get('reason')}, stacks {files}")
    for i in range(4):
        if after[f"after{i}"]["tokens"] != ref[f"ref{i}"]["tokens"]:
            raise RuntimeError(f"front (e): request {i} after the rebuild decoded other tokens than before the stall")
    k4, forwards = paged_attend.launches, engine.decode_forwards - df0
    if k4 != forwards * auto.config.num_layers:
        raise RuntimeError(f"front (e): paged kernel launched {k4} times for {forwards} decode forwards")
    out = dict(stalled=len(stalled_recs), stall_total=engine.stall_total, fired=wd.fired["heartbeat_age_s"],
               deadline_s=wd.fired["deadline_s"], stall_step_s=stall_step_s, pool_bytes=pool_bytes, files=files,
               decode_forwards=forwards, paged_attend_launches=k4)
    print(f"front (e) watchdog: {json.dumps(out)}", flush=True)
    engine.release_pools()
    return out


def phase_front(torch) -> dict:
    """Phase 21: the serving front and the host spill tier at Llama-3-8B's
    published widths and FRONT_LAYERS of its layers (random bf16 weights
    from seed 0):
    (a) the spill A/B on a bf16 pool, (b) on an int8 pool, (c) the HTTP
    front with QoS, (d) its SIGTERM drain, (e) a planned stall."""
    from automodel_tpu_torch.generation.engine import build_auto_from_cfg
    from automodel_tpu_torch.config import ConfigNode

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    auto = build_auto_from_cfg(ConfigNode(front_config()))
    torch.cuda.synchronize()
    print(f"model: Llama-3-8B ({auto.config.num_layers} layers), random init {time.perf_counter() - t0:.1f}s", flush=True)
    out = {}
    t = time.perf_counter()
    out["spill_bf16"] = front_spill_ab(torch, auto, "bf16")
    out["spill_int8"] = front_spill_ab(torch, auto, "int8")
    out["spill_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["http"] = front_http(torch, auto)
    out["http_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["watchdog"] = front_watchdog(torch, auto)
    out["watchdog_s"] = time.perf_counter() - t
    out["paged_attend_launches"] = sum(out[k]["paged_attend_launches"] for k in
                                       ("spill_bf16", "spill_int8", "http", "watchdog"))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del auto
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 21 serving front: {json.dumps({k: out[k] for k in ('spill_s', 'http_s', 'watchdog_s', 'paged_attend_launches', 'peak_gib')})}",
          flush=True)
    return out


# -- phase 22: traced serving --------------------------------------------------


def traced_leg(torch, auto, traced: bool, jobs: list, label: str) -> dict:
    """One leg of phase 22: an engine on ``auto`` behind the HTTP front, with
    tracing on (spans to a JSONL beside the serve records, a client tracer
    minting the headers) or off; ``jobs`` are (body, with a traceparent)."""
    import threading

    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.generation.engine import GenerationConfig
    from automodel_tpu_torch.loggers.metric_logger import MetricLogger
    from automodel_tpu_torch.ops.paged_attention import paged_attend
    from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine
    from automodel_tpu_torch.serving.server import build_tracer, serve_http
    from automodel_tpu_torch.telemetry.tracing import Tracer, to_traceparent

    cfg = front_config(http=dict(host="127.0.0.1", port=0, warmup=False))
    if traced:
        cfg["tracing"] = dict(enabled=True, sample_rate=1.0)
    cfg = ConfigNode(cfg)
    here = __import__("pathlib").Path(__file__).resolve().parent / "runs" / "chip_smoke"
    serve_path = here / f"traced_serve_{time.time_ns()}.jsonl"
    client_path = here / f"traced_client_{time.time_ns()}.jsonl"
    logger = MetricLogger(str(serve_path))
    records = []

    def on_record(rec: dict) -> None:
        records.append(rec)
        rec = dict(rec)
        rec.pop("tokens", None)  # as the serve CLI's on_record
        logger.log(rec)

    engine = ServingEngine(auto, ServeConfig.from_dict(cfg.serving.to_dict()),
                           GenerationConfig.from_dict(cfg.generation.to_dict()), on_record=on_record,
                           tracer=build_tracer(cfg, emit=on_record))
    if (engine.tracer is not None) != traced:
        raise RuntimeError(f"{label}: tracer {engine.tracer} with tracing {traced}")
    client_log = MetricLogger(str(client_path))
    client = Tracer("client", emit=client_log.log)
    df0 = engine.decode_forwards
    paged_attend.launches = 0
    server, loop = serve_http(engine, 0)
    serve_thread = threading.Thread(target=server.serve_forever, name="traced-http", daemon=True)
    serve_thread.start()
    port = server.server_address[1]
    answers, sent = [None] * len(jobs), [None] * len(jobs)
    try:
        def one(j):
            body, headed = jobs[j]
            if headed and traced:
                with client.span(None, "client_request", request_id=f"t{j}") as ctx:
                    sent[j] = ctx
                    answers[j] = http_call(port, "/generate", dict(body, id=f"t{j}"),
                                           headers={"traceparent": to_traceparent(ctx)})
            else:
                answers[j] = http_call(port, "/generate", dict(body, id=f"t{j}"))

        def worker(c):
            for j in range(c, len(jobs), 8):
                one(j)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(c,), daemon=True) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or any(a is None or a[0] != 200 for a in answers):
            raise RuntimeError(f"{label}: answers {[a and a[0] for a in answers]}")
        code, text, _ = http_call(port, "/metrics")
    finally:
        server.shutdown()
        server.server_close()
        loop.close()
    check_engine_healthy(engine, label)
    forwards = engine.decode_forwards - df0
    layers = auto.config.num_layers
    if paged_attend.launches != forwards * layers or not forwards:
        raise RuntimeError(f"{label}: paged kernel launched {paged_attend.launches} times for {forwards} decode "
                           f"forwards x {layers}")
    reqs = [r for r in records if r.get("event") == "serve_request"]
    ttfts = sorted(r["ttft_s"] for r in reqs)
    out = dict(requests=len(reqs), wall_s=wall, tokens_per_s=sum(r["n_generated"] for r in reqs) / wall,
               ttft_p50_s=statistics.median(ttfts), decode_forwards=forwards,
               paged_attend_launches=paged_attend.launches)
    if traced:
        out.update(check_traces(records, answers, sent, serve_path, client_path, parse_metrics(text), label))
    engine.release_pools()
    print(f"{label}: {json.dumps(out)} | {card_line()}", flush=True)
    return out


def check_traces(records, answers, sent, serve_path, client_path, metrics: dict, label: str) -> dict:
    """Phase 22's checks on the traced leg's spans (see the module text)."""
    from automodel_tpu_torch.telemetry import report, tracing

    spans = [r for r in records if r.get("event") == "span"]
    roots = {}
    for s in spans:
        if s["stage"] == "serve":
            if s["request_id"] in roots:
                raise RuntimeError(f"{label}: two serve spans for {s['request_id']}")
            roots[s["request_id"]] = s
    rids = {a[1]["request_id"] for a in answers}
    if set(roots) != rids:
        raise RuntimeError(f"{label}: serve spans for {sorted(roots)}, requests {sorted(rids)}")
    by_rid = {a[1]["request_id"]: j for j, a in enumerate(answers)}
    headed = 0
    for rid, root in roots.items():
        ctx = sent[by_rid[rid]]
        if ctx is not None:
            headed += 1
            if (root["trace_id"], root.get("parent_id")) != (ctx.trace_id, ctx.span_id):
                raise RuntimeError(f"{label}: {rid}'s root {root} is not a child of its header {ctx}")
        elif root.get("parent_id") is not None:
            raise RuntimeError(f"{label}: {rid}'s root has a parent without a header: {root}")
    by_id = {s["span_id"]: s for s in spans}
    worst = 0.0
    for s in spans:
        if s["stage"] == "serve":
            continue
        r = by_id[s["parent_id"]]
        out_by = max(r["ts"] - s["ts"], (s["ts"] + s["duration_s"]) - (r["ts"] + r["duration_s"]))
        worst = max(worst, out_by)
        if r["stage"] != "serve" or out_by > TRACE_SLACK_S:
            raise RuntimeError(f"{label}: span {s} lies {out_by:.6f}s outside its root {r}")
    chrome, md = str(serve_path) + ".chrome.json", str(serve_path) + ".md"
    rc = tracing.main([str(serve_path), str(client_path), "--chrome", chrome, "--md", md])
    found, problems = tracing.read_span_records([str(serve_path), str(client_path)])
    traces = tracing.assemble_traces(found)
    orphans = sum(len(t["orphans"]) for t in traces)
    partial = sum(1 for t in traces if t["partial"])
    if rc != 0 or problems or len(traces) != len(answers) or orphans or partial:
        raise RuntimeError(f"{label}: trace rc {rc}, {len(traces)} traces, {orphans} orphans, {partial} partial, "
                           f"problems {problems[:3]}")
    events = json.load(open(chrome))["traceEvents"]
    if not events or "## trace" not in open(md).read():
        raise RuntimeError(f"{label}: the Chrome trace or the waterfall is empty")
    stages = {}
    for s in spans:
        stages[s["stage"]] = stages.get(s["stage"], 0) + 1
    scraped = {k.split('stage="')[1].split('"')[0]: int(v) for k, v in metrics.items()
               if k.startswith("automodel_serve_stage_seconds_count{")}
    if scraped != stages:
        raise RuntimeError(f"{label}: /metrics stage counts {scraped} != span counts {stages}")
    rc_report = report.main([str(serve_path), "--strict"])
    if rc_report != 0:
        raise RuntimeError(f"{label}: report --strict exited {rc_report} on {serve_path}")
    return dict(spans=len(spans), spans_by_stage=stages, traces=len(traces), with_header=headed, orphans=orphans,
                partial=partial, worst_outside_root_s=worst, chrome_events=len(events), report_strict_rc=rc_report)


def phase_traced_front(torch) -> dict:
    """Phase 22 (see the module text): the traced leg, then the untraced one
    on the same model and requests."""
    import random

    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.generation.engine import build_auto_from_cfg

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    auto = build_auto_from_cfg(ConfigNode(front_config()))
    torch.cuda.synchronize()
    print(f"phase 22 model: Llama-3-8B ({auto.config.num_layers} layers), random init {time.perf_counter() - t0:.1f}s",
          flush=True)
    rng = random.Random(22)
    vocab = auto.config.vocab_size
    jobs = [(dict(prompt_ids=[rng.randrange(1, vocab) for _ in range(rng.randint(256, 1024))],
                  max_new_tokens=TRACED_MAX_NEW, tenant="a"), j % 2 == 0) for j in range(TRACED_REQUESTS)]
    # in turns, untraced, traced, traced, untraced: the first leg on a fresh
    # model pays first-call costs that are not tracing's
    legs = [traced_leg(torch, auto, traced, jobs, f"phase 22 leg {i + 1} {'traced' if traced else 'untraced'}")
            for i, traced in enumerate((False, True, True, False))]
    on, off = [legs[1], legs[2]], [legs[0], legs[3]]
    out = dict(legs=legs, paged_attend_launches=sum(x["paged_attend_launches"] for x in on))
    mean = lambda xs, k: sum(x[k] for x in xs) / len(xs)
    out["tokens_per_s_traced_over_untraced"] = mean(on, "tokens_per_s") / mean(off, "tokens_per_s")
    out["ttft_p50_traced_over_untraced"] = mean(on, "ttft_p50_s") / mean(off, "ttft_p50_s")
    del auto
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 22 traced vs untraced (a reading, not a claim): "
          f"{json.dumps({k: out[k] for k in ('tokens_per_s_traced_over_untraced', 'ttft_p50_traced_over_untraced')})}"
          f" | {card_line()}", flush=True)
    return out


# -- phase 23: training at full depth, the optimizers, rollback ---------------


def metrics_path(tag: str) -> str:
    here = __import__("pathlib").Path(__file__).resolve().parent
    return str(here / "runs" / "chip_smoke" / f"{tag}_{time.time_ns()}.jsonl")


def phase_sft_full(torch) -> dict:
    """Phase 23 (a): Llama-3-8B SFT at 32 layers through the recipe class."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.ops import ring_flash as rf
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction
    from automodel_tpu_torch.telemetry import report

    cfg = json.loads(json.dumps(SFT_LLAMA3_8B_FULL))
    cfg["device"] = TRAIN_DEVICE
    cfg["step_scheduler"].update(max_steps=FULL_STEPS, log_every_steps=1)
    cfg["logging"]["metrics_path"] = metrics_path("sft_full")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in recipe.state.params)
    kernels = (rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv)
    # the main path's run: every count set to 0 just before, read just after
    for f in kernels:
        f.launches = 0
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("fwd", "dq", "dkv"), (f.launches for f in kernels)))
    layers = cfg["model"]["hf_config"]["num_hidden_layers"]
    want = dict(fwd=layers * FULL_STEPS * 2, dq=layers * FULL_STEPS, dkv=layers * FULL_STEPS)
    if launches != want:
        raise RuntimeError(f"23 (a): flash launches {launches}, want {want} (remat: full runs the forward twice)")
    rows = [json.loads(line) for line in open(cfg["logging"]["metrics_path"])]
    steps = [r for r in rows if "loss" in r]
    if [r["step"] for r in steps] != list(range(1, FULL_STEPS + 1)) or any(
            r["loss"] is None or r["nonfinite"] or not math.isfinite(r["loss"]) for r in steps):
        raise RuntimeError(f"23 (a): step rows {steps}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if peak >= FULL_PEAK_GIB:
        raise RuntimeError(f"23 (a): peak {peak:.2f} GiB, want under {FULL_PEAK_GIB}")
    rc = report.main([cfg["logging"]["metrics_path"], "--strict"])
    if rc != 0:
        raise RuntimeError(f"23 (a): report --strict exited {rc}")
    seq = cfg["dataset"]["seq_length"]
    step_s = statistics.median(r["step_time_s"] for r in steps[1:])
    embed = recipe.model.model.embed_tokens.weight.numel()
    flops = 6 * (n_params - embed) * seq + attention_flops(cfg, seq)
    out = dict(params=n_params, layers=layers, setup_s=setup_s, wall_s=wall, losses=[r["loss"] for r in steps],
               grad_norms=[r["grad_norm"] for r in steps], compile_time_s=steps[0].get("compile_time_s"),
               step_ms=1e3 * step_s, tokens_per_s=seq / step_s, model_flop_per_step=flops,
               mfu_on_989=flops / step_s / BF16_FLOPS, peak_mem_gib=peak, flash_launches=launches,
               moments_dtype=str(recipe.state.optimizer.mu[0].dtype), report_strict_rc=rc)
    print(f"phase 23 (a) sft full depth: {json.dumps(out)} | {card_line()}", flush=True)
    del recipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def held_names(names: list, optimizer: str) -> list:
    """The tensors phase 23 (b) holds to the CPU: whole JAX leaves."""
    keep = ("self_attn.k_proj.weight", "input_layernorm.weight", "model.norm.weight")
    if optimizer != "muon":
        keep += ("lm_head.weight",)
    return [n for n in names if n.endswith(keep)]


def bf16_steps_apart(a, b) -> tuple[int, int]:
    """(elements apart, the largest distance in bf16 steps) of two bf16
    tensors of one shape, read as bit patterns."""
    x = a.view(__import__("torch").int16).to(__import__("torch").int32)
    y = b.view(__import__("torch").int16).to(__import__("torch").int32)
    d = (x - y).abs()
    return int((d > 0).sum()), int(d.max()) if d.numel() else 0


def run_optimizer_on_card(torch, name: str) -> dict:
    """Phase 23 (b) for one optimizer."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.optim.builders import build_optimizer
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    cfg = json.loads(json.dumps(SFT_LLAMA3_8B))
    cfg["device"] = TRAIN_DEVICE
    cfg["model"]["hf_config"]["num_hidden_layers"] = OPT_LAYERS
    cfg["step_scheduler"].update(grad_acc_steps=1, max_steps=OPT_STEPS, log_every_steps=1)
    cfg["optimizer"].update(name=name, lr=OPT_LR[name], lr_schedule=dict(style="constant"))
    cfg["logging"]["metrics_path"] = metrics_path(f"opt_{name}")
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    names = [n for n, _ in recipe.model.named_parameters()]
    held = held_names(names, name)
    idx = [names.index(n) for n in held]
    opt = recipe.state.optimizer
    seen = {}
    update = opt.update

    def capture(grads, grad_norm=None):
        if not seen:
            seen["before"] = [recipe.state.params[i].detach().cpu().clone() for i in idx]
            seen["grads"] = [grads[i].detach().cpu().clone() for i in idx]
            seen["norm"] = grad_norm.detach().cpu().clone()
            update(grads, grad_norm)
            seen["after"] = [recipe.state.params[i].detach().cpu().clone() for i in idx]
            return None
        return update(grads, grad_norm)

    opt.update = capture
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(cfg["logging"]["metrics_path"])]
    losses = [r["loss"] for r in rows if "loss" in r]
    if len(losses) != OPT_STEPS or not all(x is not None and math.isfinite(x) for x in losses):
        raise RuntimeError(f"23 (b) {name}: losses {losses}")
    ocfg = {k: v for k, v in cfg["optimizer"].items() if k != "_target_"}
    params = [t.clone() for t in seen["before"]]
    ref = build_optimizer(params, names=held, **ocfg)
    ref.update(seen["grads"], seen["norm"])
    apart, worst, total = 0, 0, 0
    for n, got, want in zip(held, seen["after"], params):
        a, w = bf16_steps_apart(got, want)
        apart, worst, total = apart + a, max(worst, w), total + got.numel()
    moved = sum(int((b != a).sum()) for b, a in zip(seen["before"], seen["after"]))
    out = dict(optimizer=name, losses=losses, wall_s=wall, held_tensors=len(held), held_elements=total,
               moved_elements=moved, apart=apart, share_apart=apart / total, worst_bf16_steps=worst)
    if apart > OPT_MAX_DIFFERING * total or worst > OPT_MAX_BF16_STEPS or not moved:
        raise RuntimeError(f"23 (b) {name}: step 1 on the card against the CPU: {out}")
    del recipe, opt, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_rollback_on_card(torch) -> dict:
    """Phase 23 (c): the rollback policy through the recipe class."""
    import shutil

    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    root = __import__("pathlib").Path(__file__).resolve().parent / "runs" / "chip_smoke" / f"rollback_{time.time_ns()}"
    cfg = json.loads(json.dumps(SFT_LLAMA3_8B))
    cfg["device"] = TRAIN_DEVICE
    cfg["model"]["hf_config"] = dict(LLAMA3_2_1B, num_hidden_layers=2)
    cfg["dataset"].update(num_samples=64)
    cfg["step_scheduler"].update(grad_acc_steps=1, max_steps=ROLLBACK_STEPS, ckpt_every_steps=2, log_every_steps=1)
    cfg["checkpoint"] = dict(enabled=True, checkpoint_dir=str(root))
    cfg["fault_tolerance"] = dict(on_nonfinite="rollback")
    cfg["logging"]["metrics_path"] = metrics_path("rollback")
    try:
        recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
        recipe.setup()
        orig, fired = recipe.train_step, []

        def flaky(state, batch):
            m = orig(state, batch)
            if m["step"] == ROLLBACK_FAIL_STEP and not fired:
                fired.append(1)
                m = dict(m, nonfinite=torch.tensor(True, device=m["loss"].device))
            return m

        recipe.train_step = flaky
        t0 = time.perf_counter()
        last = recipe.run_train_validation_loop()
        wall = time.perf_counter() - t0
        rows = [json.loads(line) for line in open(cfg["logging"]["metrics_path"])]
        events = [(r["event"], r.get("fail_step", r.get("resumed_from_step"))) for r in rows
                  if r.get("event") not in (None, *TELEMETRY_EVENTS)]
        cursor = recipe.dataloader.state_dict()
        out = dict(last_step=last["step"], rollbacks_total=last.get("rollbacks_total"), events=events,
                   loader=dict(epoch=cursor["epoch"], batch_in_epoch=cursor["batch_in_epoch"]), wall_s=wall,
                   losses=[r["loss"] for r in rows if "loss" in r])
        # restore to step 2 (2 batches consumed), skip the failed step's
        # batch, train steps 3 and 4, and the scheduler's look-ahead batch
        want_cursor = dict(epoch=0, batch_in_epoch=6)
        if (fired != [1] or last["step"] != ROLLBACK_STEPS or last.get("rollbacks_total") != 1
                or events != [("rollback", ROLLBACK_FAIL_STEP), ("resume", 2)] or out["loader"] != want_cursor
                or not all(math.isfinite(x) for x in out["losses"])):
            raise RuntimeError(f"23 (c) rollback: {out}, want the loader at {want_cursor}")
        del recipe
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_training_rest(torch) -> dict:
    """Phase 23 (see the module text)."""
    out = dict(full=phase_sft_full(torch))
    t0 = time.perf_counter()
    out["optimizers"] = [run_optimizer_on_card(torch, name) for name in OPTIMIZERS_ON_CARD]
    print(f"phase 23 (b) optimizers on the card ({time.perf_counter() - t0:.1f}s): {json.dumps(out['optimizers'])} "
          f"| {card_line()}", flush=True)
    out["rollback"] = run_rollback_on_card(torch)
    print(f"phase 23 (c) rollback: {json.dumps(out['rollback'])}", flush=True)
    return out


# -- phase 24: the data path ---------------------------------------------------


def data_root():
    here = __import__("pathlib").Path(__file__).resolve().parent
    return here / "runs" / "chip_smoke" / f"data_{time.time_ns()}"


def write_corpora(root) -> dict:
    """Phase 24 (a): the Megatron corpus and the three nanoGPT sources,
    written by the port's writer from seeds as uint32, and the Megatron
    index built by the native helpers."""
    from automodel_tpu_torch.data import synthetic
    from automodel_tpu_torch.data.megatron import helpers
    from automodel_tpu_torch.data.megatron.gpt_dataset import MegatronPretraining

    vocab = LLAMA3_8B["vocab_size"]
    prefix = root / "megatron" / "corpus"
    megatron = synthetic.write_megatron_corpus(prefix, DATA_CORPUS_TOKENS, vocab, seed=0, median=DATA_DOC_MEDIAN)
    sources = [root / "nanogpt" / f"source_{s}" for s in range(DATA_NANOGPT_SOURCES)]
    nanogpt = [synthetic.write_nanogpt_shards(p, DATA_NANOGPT_SHARDS, DATA_NANOGPT_SHARD_TOKENS, vocab, seed=100 + i)
               for i, p in enumerate(sources)]
    helpers.native_calls.clear()
    t0 = time.perf_counter()
    native = helpers.native_available()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = MegatronPretraining(str(prefix), seq_length=PRETRAIN_LLAMA3_8B_MEGATRON["dataset"]["seq_length"])
    index_s = time.perf_counter() - t0
    calls = dict(helpers.native_calls)
    out = dict(megatron=megatron, nanogpt=nanogpt, samples=len(ds), helpers_build_s=build_s, index_s=index_s,
               native=native, native_calls=calls, library=str(helpers.library_path().name))
    print(f"phase 24 (a) corpora: {json.dumps(out)}", flush=True)
    if not native or calls.get("build_sample_idx", 0) < 1:
        raise RuntimeError(f"24 (a): the native index helpers did not build or did not run: {out}")
    if (vocab > 2**16 and megatron["dtype"] != "uint32") or megatron["tokens"] != DATA_CORPUS_TOKENS:
        raise RuntimeError(f"24 (a): the Megatron corpus is {megatron}")
    return dict(out, prefix=prefix, sources=sources)


def reading_back(torch, recipe) -> list:
    """Wrap ``recipe.train_step`` so that each step's batch, as it reached
    the card, is read back to the host after the step."""
    seen, step = [], recipe.train_step

    def wrapped(state, batch):
        metrics = step(state, batch)
        seen.append({k: v.detach().to("cpu", copy=True) for k, v in batch.items()})
        return metrics

    recipe.train_step = wrapped
    return seen


def same_batches(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
                                    for x, y in zip(a, b))


def host_batches(torch, recipe, start: int, n: int) -> list:
    """Batches ``start..start+n-1`` of epoch 0 collated and stacked on the
    host, as the sync path builds them."""
    inner = getattr(recipe.dataloader, "loader", recipe.dataloader)
    return [{k: torch.from_numpy(v) for k, v in recipe._prepare_group([inner.batch_for(0, i)])[0].items()
             if hasattr(v, "shape")} for i in range(start, start + n)]


def same_trajectory(a: dict, b: dict, c: dict, steps, label: str) -> dict:
    """Phase 17's rule: run ``c`` must equal run ``a`` bit for bit where
    ``a`` and ``b`` (two runs of one config) agree bit for bit, else lie
    within 4x their step-1 spread. Rows by step → the reading."""
    keys = ("loss", "grad_norm")
    first = min(steps)
    bitwise = all(a[s][k] == b[s][k] for s in steps for k in keys)
    spread = max(abs(a[first][k] - b[first][k]) / abs(a[first][k]) for k in keys)
    errs = {k: max(abs(c[s][k] - a[s][k]) / abs(a[s][k]) for s in steps) for k in keys}
    out = dict(reference_bitwise=bitwise, step1_rel_spread=spread, rel_errs=errs,
               equal=all(c[s][k] == a[s][k] for s in steps for k in keys))
    if (bitwise and not out["equal"]) or (not bitwise and max(errs.values()) > 4 * spread):
        raise RuntimeError(f"{label}: steps {list(steps)} off the reference run: {out}")
    return out


def megatron_config(prefix, prefetch: bool, tag: str) -> dict:
    cfg = json.loads(json.dumps(PRETRAIN_LLAMA3_8B_MEGATRON))
    cfg["device"] = TRAIN_DEVICE
    cfg["model"]["hf_config"]["num_hidden_layers"] = DATA_PRETRAIN_LAYERS
    cfg["dataset"]["paths"] = str(prefix)
    cfg["step_scheduler"].update(max_steps=DATA_STEPS, log_every_steps=1)
    cfg["logging"]["metrics_path"] = metrics_path(tag)
    if not prefetch:
        del cfg["data"]
    return cfg


def run_pretrain_megatron(torch, prefix, prefetch: bool, tag: str) -> dict:
    """Phase 24 (b), one run: ``pretrain llm``'s recipe (as the CLI's entry
    runs it) at DATA_PRETRAIN_LAYERS on the Megatron corpus, each batch read back."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.ops import ring_flash as rf
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    cfg = megatron_config(prefix, prefetch, tag)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    seen = reading_back(torch, recipe)
    kernels = (rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv)
    # the main path's run: every count set to 0 just before, read just after
    for f in kernels:
        f.launches = 0
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("fwd", "dq", "dkv"), (f.launches for f in kernels)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    layers = cfg["model"]["hf_config"]["num_hidden_layers"]
    acc = cfg["step_scheduler"]["grad_acc_steps"]
    want = dict(fwd=2 * layers * acc * DATA_STEPS, dq=layers * acc * DATA_STEPS, dkv=layers * acc * DATA_STEPS)
    if launches != want:
        raise RuntimeError(f"24 (b) {tag}: flash launches {launches}, want {want} (remat: full runs the forward twice)")
    rows = train_rows([json.loads(line) for line in open(cfg["logging"]["metrics_path"])])
    steps = list(range(1, DATA_STEPS + 1))
    if sorted(rows) != steps or any(not math.isfinite(rows[s]["loss"]) or rows[s]["nonfinite"] for s in steps):
        raise RuntimeError(f"24 (b) {tag}: step rows {rows}")
    if peak >= DATA_PEAK_GIB:
        raise RuntimeError(f"24 (b) {tag}: peak {peak:.2f} GiB, want under {DATA_PEAK_GIB}")
    host = host_batches(torch, recipe, 0, DATA_STEPS)
    if not same_batches(torch, seen, host):
        raise RuntimeError(f"24 (b) {tag}: a batch read back from the card differs from the host's collate")
    seq = cfg["dataset"]["seq_length"]
    n_params = sum(p.numel() for p in recipe.state.params)
    embed = recipe.model.model.embed_tokens.weight.numel()
    flops = 6 * (n_params - embed) * seq + attention_flops(cfg, seq)
    step_s = statistics.median(rows[s]["step_time_s"] for s in steps[1:])
    out = dict(prefetch=prefetch, wall_s=wall, step_ms=1e3 * step_s, tokens_per_s=seq / step_s,
               mfu_on_989=flops / step_s / BF16_FLOPS, peak_mem_gib=peak, flash_launches=launches,
               host_input_wait_s=[rows[s]["host_input_wait_s"] for s in steps[1:]],
               prefetch_depth=[rows[s].get("prefetch_depth") for s in steps[1:]],
               losses=[rows[s]["loss"] for s in steps], compile_time_s=rows[1].get("compile_time_s"))
    print(f"phase 24 (b) pretrain llm, {tag}: {json.dumps(out)} | {card_line()}", flush=True)
    del recipe
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, rows=rows, batches=seen)


def phase_data_pretrain(torch, prefix) -> dict:
    """Phase 24 (b): Llama-3-8B at DATA_PRETRAIN_LAYERS on the Megatron corpus, sync,
    prefetched, sync: the batches and the losses held to the sync runs."""
    sync_a = run_pretrain_megatron(torch, prefix, False, "megatron_sync_a")
    pf = run_pretrain_megatron(torch, prefix, True, "megatron_prefetch")
    sync_b = run_pretrain_megatron(torch, prefix, False, "megatron_sync_b")
    if not (same_batches(torch, pf["batches"], sync_a["batches"])
            and same_batches(torch, sync_b["batches"], sync_a["batches"])):
        raise RuntimeError("24 (b): the prefetched run's batches differ from the sync run's")
    rule = same_trajectory(sync_a["rows"], sync_b["rows"], pf["rows"], range(1, DATA_STEPS + 1), "24 (b) prefetch")
    print(f"phase 24 (b) prefetch against sync: batches equal bit for bit, losses {json.dumps(rule)}", flush=True)
    keep = ("step_ms", "tokens_per_s", "mfu_on_989", "peak_mem_gib", "host_input_wait_s", "prefetch_depth",
            "flash_launches", "losses")
    return dict(sync={k: sync_a[k] for k in keep}, sync_b={k: sync_b[k] for k in keep},
                prefetch={k: pf[k] for k in keep}, rule=rule)


def packed_row(prefix, seq: int):
    """The first ``seq``-token row ``pack_sequences`` fills with at least
    3 documents of the Megatron corpus, collated by ``packed_collater``."""
    import numpy as np

    from automodel_tpu_torch.data.collators import packed_collater
    from automodel_tpu_torch.data.megatron.indexed_dataset import IndexedDataset
    from automodel_tpu_torch.data.packed import pack_sequences

    ds = IndexedDataset(prefix)
    docs = ({"input_ids": np.asarray(ds[i], np.int32)} for i in range(len(ds)))
    row = next(r for r in pack_sequences(docs, seq) if max(r["segment_ids"]) >= 3)
    return packed_collater([row])


def phase_data_packing(torch, dev, prefix) -> dict:
    """Phase 24 (c): a packed row through K1's segment path, one step's
    loss and grad norm at 8 layers flash against sdpa's segment mask, and
    the kernels timed on the row beside the bound of its live pairs."""
    import numpy as np

    cfg = train_config()
    cfg["model"]["hf_config"]["num_hidden_layers"] = DATA_PACKED_LAYERS
    seq = cfg["dataset"]["seq_length"]
    batch = packed_row(prefix, seq)
    seg = batch["segment_ids"][0]
    lengths = np.bincount(seg)[1:]
    doc_pairs = int(sum(int(n) * (int(n) + 1) // 2 for n in lengths))
    pad = int((seg == 0).sum())
    step = phase_flash_vs_sdpa(torch, cfg, "24 (c) packed row, flash (segment ids) vs sdpa (segment mask)", mb=batch)
    want = dict(fwd=DATA_PACKED_LAYERS, dq=DATA_PACKED_LAYERS, dkv=DATA_PACKED_LAYERS)
    if step["flash"]["launches"] != want or any(step["sdpa"]["launches"].values()):
        raise RuntimeError(f"24 (c): launches flash {step['flash']['launches']} (want {want}), "
                           f"sdpa {step['sdpa']['launches']} (want none)")
    seg_t = torch.from_numpy(batch["segment_ids"])
    row = run_flash_cases(torch, dev, [dict(name="packed row", main=True, seg_ids=seg_t)], "flash packed row",
                          seed0=240)["cases"][0]
    if row["live_pairs"] != doc_pairs:
        raise RuntimeError(f"24 (c): the kernels' live pairs {row['live_pairs']} are not the documents' {doc_pairs}")
    out = dict(documents=len(lengths), doc_lengths=lengths.tolist(), pad_tokens=pad, live_pairs=doc_pairs,
               label_tokens=batch["num_label_tokens"], step=step, kernels=row)
    print(f"phase 24 (c) packing: {json.dumps({k: v for k, v in out.items() if k != 'kernels'})} | {card_line()}",
          flush=True)
    return out


def nanogpt_config(sources, ds_seed: int, tag: str, max_steps: int, ckpt_dir=None, rollback: bool = False) -> dict:
    """Phase 24 (d)'s config: Llama-3-8B widths cut to DATA_RESUME_LAYERS
    layers on the blended nanoGPT sources, prefetch on, bf16 moments."""
    from automodel_tpu_torch.data.synthetic import token_dtype

    cfg = json.loads(json.dumps(SFT_LLAMA3_8B))
    cfg["device"] = TRAIN_DEVICE
    cfg["model"]["hf_config"]["num_hidden_layers"] = DATA_RESUME_LAYERS
    cfg["dataset"] = dict(_target_="automodel_tpu.data.nanogpt.BlendedNanogptDataset",
                          sources=[dict(paths=str(p), weight=w) for p, w in zip(sources, DATA_NANOGPT_WEIGHTS)],
                          seq_length=cfg["dataset"]["seq_length"], seed=ds_seed,
                          dtype=token_dtype(cfg["model"]["hf_config"]["vocab_size"]).name)
    cfg["data"] = dict(PRETRAIN_LLAMA3_8B_MEGATRON["data"])
    cfg["step_scheduler"].update(grad_acc_steps=1, max_steps=max_steps, log_every_steps=1)
    cfg["optimizer"].update(lr=1e-4, lr_schedule=dict(style="constant"), moments_dtype="param")
    cfg["logging"]["metrics_path"] = metrics_path(tag)
    if ckpt_dir is not None:
        cfg["checkpoint"] = dict(enabled=True, checkpoint_dir=str(ckpt_dir))
        cfg["step_scheduler"]["ckpt_every_steps"] = DATA_SAVE_STEP
    if rollback:
        cfg["fault_tolerance"] = dict(on_nonfinite="rollback")
    return cfg


def second_shard_seed(sources, seq: int, loader_seed: int) -> tuple[int, dict]:
    """The first blend seed whose window at step DATA_SAVE_STEP + 1 lies in
    a source's second .bin shard → (seed, where that window lies)."""
    import numpy as np

    from automodel_tpu_torch.data.loader import DataLoader
    from automodel_tpu_torch.data.nanogpt import BlendedNanogptDataset
    from automodel_tpu_torch.data.synthetic import token_dtype

    for seed in range(64):
        ds = BlendedNanogptDataset([dict(paths=str(p), weight=w) for p, w in zip(sources, DATA_NANOGPT_WEIGHTS)],
                                   seq_length=seq, seed=seed, dtype=token_dtype(LLAMA3_8B["vocab_size"]))
        idx = int(DataLoader(ds, global_batch_size=1, seed=loader_seed)._epoch_order(0)[DATA_SAVE_STEP])
        src, pos = int(ds._assignment[idx]), int(ds._position[idx])
        d = ds.datasets[src]
        pass_no, local = divmod(pos, len(d))
        window = int(ds._window_order(src, pass_no)[local])
        shard = int(np.searchsorted(d._cum, window, side="right") - 1)
        if shard == 1:
            return seed, dict(sample=idx, source=src, shard=shard, window=window, source_counts=ds.source_counts())
    raise RuntimeError("24 (d): no blend seed under 64 puts the resumed step's window in a second shard")


def phase_data_resume(torch, sources) -> dict:
    """Phase 24 (d): the blended nanoGPT sources with prefetch on, resumed
    mid-stream across a shard boundary, then a planned non-finite step
    rolled back."""
    import shutil

    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    seq = SFT_LLAMA3_8B["dataset"]["seq_length"]
    ds_seed, where = second_shard_seed(sources, seq, SFT_LLAMA3_8B["seed"])
    root = data_root()
    last = DATA_SAVE_STEP + 2

    def run(cfg, flaky_step=None):
        recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
        recipe.setup()
        fired = []
        if flaky_step is not None:
            step = recipe.train_step

            def flaky(state, batch):
                m = step(state, batch)
                if m["step"] == flaky_step and not fired:
                    # the flagged step logs no row: keep its own reading
                    fired.append(dict(step=m["step"], loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
                    m = dict(m, nonfinite=torch.tensor(True, device=m["loss"].device))
                return m

            recipe.train_step = flaky
        seen = reading_back(torch, recipe)
        recipe.run_train_validation_loop()
        torch.cuda.synchronize()
        rows = [json.loads(line) for line in open(cfg["logging"]["metrics_path"])]
        return recipe, rows, seen, fired

    try:
        t0 = time.perf_counter()
        ref = []
        for tag in ("unbroken_a", "unbroken_b"):
            recipe, rows, seen, _ = run(nanogpt_config(sources, ds_seed, f"nanogpt_{tag}", last))
            ref.append((train_rows(rows), seen))
            host = host_batches(torch, recipe, 0, last)
            del recipe
            gc.collect()
            torch.cuda.empty_cache()
        (a, a_batches), (b, b_batches) = ref
        if not (same_batches(torch, a_batches, host) and same_batches(torch, b_batches, host)):
            raise RuntimeError("24 (d): the unbroken runs' batches read back differ from the host's collate")
        ck = root / "ckpt"
        recipe, rows1, _, _ = run(nanogpt_config(sources, ds_seed, "nanogpt_broken", DATA_SAVE_STEP, ck))
        del recipe
        gc.collect()
        torch.cuda.empty_cache()
        # a fresh recipe resumes at the save, trains on, and its last step is
        # flagged non-finite once: the rollback restores the save again
        cfg = nanogpt_config(sources, ds_seed, "nanogpt_resumed", last, ck, rollback=True)
        recipe, rows2, seen, fired = run(cfg, flaky_step=last)
        events = [(r["event"], r.get("fail_step", r.get("resumed_from_step"))) for r in rows2
                  if r.get("event") not in (None, *TELEMETRY_EVENTS)]
        if [f["step"] for f in fired] != [last] or events != [
                ("resume", DATA_SAVE_STEP), ("rollback", last), ("resume", DATA_SAVE_STEP)]:
            raise RuntimeError(f"24 (d): events {events}, planted at {fired}")
        # the first pass of the resumed steps against the unbroken run
        first = {last: fired[0]}
        for r in rows2:
            if "loss" in r and r["step"] not in first:
                first[r["step"]] = r
        resumed = range(DATA_SAVE_STEP + 1, last + 1)
        rule = same_trajectory(a, b, first, resumed, "24 (d) resumed")
        if not same_batches(torch, seen[: last - DATA_SAVE_STEP], a_batches[DATA_SAVE_STEP:]):
            raise RuntimeError("24 (d): the resumed steps' batches differ from the unbroken run's")
        # JAX's rollback arithmetic: restore at the save, the cursor past the
        # failed window, the steps retrained, and the scheduler's look-ahead
        # batch (tests/test_resilience.py:876-903, one batch a step here)
        want_cursor = DATA_SAVE_STEP + (last - DATA_SAVE_STEP) + (last - DATA_SAVE_STEP) + 1
        cursor = recipe.dataloader.state_dict()
        retrained = seen[last - DATA_SAVE_STEP:]
        want_retrained = host_batches(torch, recipe, last, last - DATA_SAVE_STEP)
        rows_by_step = train_rows(rows2)
        out = dict(blend_seed=ds_seed, resumed_window=where, events=events, rule=rule,
                   losses_unbroken=[a[s]["loss"] for s in range(1, last + 1)],
                   losses_resumed=[first[s]["loss"] for s in resumed], loader=cursor, want_batch_in_epoch=want_cursor,
                   rollbacks_total=rows_by_step[last].get("rollbacks_total"), wall_s=time.perf_counter() - t0)
        if (cursor["epoch"], cursor["batch_in_epoch"]) != (0, want_cursor) or out["rollbacks_total"] != 1:
            raise RuntimeError(f"24 (d): after the rollback {out}")
        if not same_batches(torch, retrained, want_retrained):
            raise RuntimeError("24 (d): the steps retrained after the rollback did not take the batches past the "
                               "failed window")
        print(f"phase 24 (d) resume and rollback on nanoGPT: {json.dumps(out)} | {card_line()}", flush=True)
        del recipe
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_data(torch, dev) -> dict:
    """Phase 24 (see the module text)."""
    import shutil

    root = data_root()
    try:
        t0 = time.perf_counter()
        corpora = write_corpora(root)
        out = dict(corpora={k: v for k, v in corpora.items() if k not in ("prefix", "sources")})
        out["pretrain"] = phase_data_pretrain(torch, corpora["prefix"])
        out["packing"] = phase_data_packing(torch, dev, corpora["prefix"])
        out["resume"] = phase_data_resume(torch, corpora["sources"])
        out["wall_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# -- phase 25: the training run's telemetry, profiling, goodput and guard -------

OBS_STEPS = 7  # (a): a manual profile window over step 4, the memory census every 3 steps
OBS_CENSUS_EVERY = 3
OBS_WINDOW_STEP = 4
OBS_CORPUS_TOKENS = 2**22  # 16 MiB of uint32 tokens: the runs read 6 x 4096 of them
OBS_LAYERS = 2  # (c)-(e)
OBS_PROFILE = dict(trace_warmup_steps=2, trace_steps=1)  # (b)
OBS_STRAGGLE = dict(straggle_host=0, straggle_ms=2000.0, straggle_at_step=6)  # (d), a 9-step run
# (d) runs beside (e)'s two processes: a slow step is 5x the EMA, not 3x,
# so the host they share cannot fire a capture before the straggle
OBS_TRIGGER = dict(slow_step_factor=5.0)
OBS_NAN_STEP = 3  # (d), a 6-step run under skip
OBS_HANG_STEP = 3  # (e), after the step-2 checkpoint
OBS_WATCHDOG = dict(min_deadline_s=5.0, poll_interval_s=0.25, multiplier=4.0)
# (e)'s checkpoints: size-only manifests (phase 17 holds the CRC read-back);
# the 2-layer state at 8B widths is ~9 GB a save, and time is short
OBS_CKPT = dict(enabled=True, manifest_checksums=False)
OBS_OFF = dict(telemetry={"enabled": False}, profiling={"enabled": False}, distributed_guard={"enabled": False},
               metrics_server={"enabled": False})
OBS_EVENT_SLACK_S = 1.0  # host jitter beside the watchdog's poll


def obs_config(prefix, root, tag: str, steps: int, layers: int | None = None, **sections) -> dict:
    """Phase 24's Megatron config (prefetch on) in a run dir of its own."""
    cfg = megatron_config(prefix, True, tag)
    cfg["output_dir"] = str(root / tag)
    cfg["logging"]["metrics_path"] = str(root / tag / "train_metrics.jsonl")
    cfg["step_scheduler"].update(max_steps=steps, log_every_steps=1)
    if layers is not None:
        cfg["model"]["hf_config"]["num_hidden_layers"] = layers
    cfg.update(json.loads(json.dumps(sections)))
    return cfg


def obs_run(torch, cfg: dict, scrape: bool = False) -> dict:
    """One run of the training recipe (the CLI's entry) → its records, the
    flash launches of the run, wall seconds and, with ``scrape``, the
    ``/metrics`` body read after each log record's fold."""
    import urllib.request

    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.ops import ring_flash as rf
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction
    from automodel_tpu_torch.resilience import fault_injection

    gc.collect()
    torch.cuda.empty_cache()
    recipe = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
    recipe.setup()
    scrapes, scrape_s = [], [0.0]
    if scrape:
        port = recipe._prom_server.server_address[1]
        fold = recipe._prom.update_goodput

        def update_goodput(snapshot):  # the last fold of a log record
            fold(snapshot)
            t = time.perf_counter()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
                scrapes.append(r.read().decode())
            scrape_s[0] += time.perf_counter() - t

        recipe._prom.update_goodput = update_goodput
    kernels = (rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv)
    for f in kernels:  # the main path's run: every count set to 0 just before, read just after
        f.launches = 0
    t0 = time.perf_counter()
    try:
        recipe.run_train_validation_loop()
    finally:
        fault_injection.activate(None)  # the injector is process-global
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("fwd", "dq", "dkv"), (f.launches for f in kernels)))
    rows = [json.loads(line) for line in open(cfg["logging"]["metrics_path"])]
    out = dict(rows=rows, launches=launches, wall_s=wall, scrapes=scrapes, scrape_s=scrape_s[0],
               model_config=recipe.model.config,
               n_params=sum(p.numel() for p in recipe.state.params))
    del recipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flash_counts(top_ops: list) -> dict:
    """Launches of K1's three kernels among a trace report's top ops."""
    return {k: sum(o["count"] for o in top_ops if f"flash_{k}_kernel" in o["name"]) for k in ("fwd", "dq", "dkv")}


def phase_obs_on_off(torch, prefix, root) -> dict:
    """Phase 25 (a): every section on (a memory cadence, a manual profile
    window, the cost count, a metrics port, the guard's defaults) and every
    section off, at DATA_PRETRAIN_LAYERS: the same losses and grad norms bit for bit;
    the records' keys, one cost_attribution event, a /metrics scrape at the
    last step, and the goodput ledger summing to the wall clock."""
    from automodel_tpu_torch.telemetry.goodput import _read_records, rollup
    from automodel_tpu_torch.telemetry.goodput import main as goodput_main
    from automodel_tpu_torch.telemetry.prometheus import TrainMetricsExporter
    from automodel_tpu_torch.utils.flops_utils import flops_per_token_for_config

    on_cfg = obs_config(prefix, root, "on", OBS_STEPS, telemetry=dict(
        memory_every_steps=OBS_CENSUS_EVERY, profile=dict(enabled=True, start_step=OBS_WINDOW_STEP,
                                                          end_step=OBS_WINDOW_STEP + 1,
                                                          trace_dir=str(root / "on" / "trace"))),
        metrics_server=dict(port=0))
    on = obs_run(torch, on_cfg, scrape=True)
    off = obs_run(torch, obs_config(prefix, root, "off", OBS_STEPS, **OBS_OFF))
    steps = list(range(1, OBS_STEPS + 1))
    a, b = train_rows(on["rows"]), train_rows(off["rows"])
    if sorted(a) != steps or sorted(b) != steps:
        raise RuntimeError(f"25 (a): steps logged {sorted(a)} / {sorted(b)}")
    same = all(a[s][k] == b[s][k] for s in steps for k in ("loss", "grad_norm"))
    if not same:
        raise RuntimeError(f"25 (a): on / off losses {[(a[s]['loss'], b[s]['loss']) for s in steps]}, grad norms "
                           f"{[(a[s]['grad_norm'], b[s]['grad_norm']) for s in steps]} differ")
    layers = on_cfg["model"]["hf_config"]["num_hidden_layers"]
    want_launch = dict(fwd=2 * layers * OBS_STEPS, dq=layers * OBS_STEPS, dkv=layers * OBS_STEPS)
    if on["launches"] != want_launch or off["launches"] != want_launch:
        raise RuntimeError(f"25 (a): flash launches {on['launches']} / {off['launches']}, want {want_launch}")
    groups = ("grad_norm/embed", "grad_norm/layers", "grad_norm/final_norm", "grad_norm/lm_head")
    problems = []
    for s in steps:
        r = a[s]
        need = ["grad_nonfinite_count", "heartbeat_age_s", "attempt_id", *groups]
        if s > 1:
            need += ["time/data_wait_s", "time/dispatch_s", "time/device_sync_s", "mfu_pct", "mfu_measured_pct"]
        if s % OBS_CENSUS_EVERY == 0:
            need += ["mem_bytes_in_use", "mem_peak_bytes"]
        missing = [k for k in need if r.get(k) is None]
        if missing or r["grad_nonfinite_count"] != 0 or r["nonfinite"]:
            problems.append(f"step {s} lacks {missing} or is flagged: {r}")
        if any(k.startswith(("grad_norm/", "time/")) or k in ("nonfinite", "heartbeat_age_s", "attempt_id")
               for k in b[s]):
            problems.append(f"step {s} of the off run carries telemetry keys: {sorted(b[s])}")
    costs = [r for r in on["rows"] if r.get("event") == "cost_attribution"]
    if len(costs) != 1 or not costs[0]["flops"] > 0 or any(r.get("event") for r in off["rows"]):
        problems.append(f"cost_attribution events {costs} (off run events "
                        f"{[r['event'] for r in off['rows'] if r.get('event')]})")
    families = [l.split()[2] for l in TrainMetricsExporter().registry.render().splitlines() if l.startswith("# TYPE")]
    last = parse_metrics(on["scrapes"][-1]) if on["scrapes"] else {}
    if (len(on["scrapes"]) != OBS_STEPS or last.get("automodel_train_step") != OBS_STEPS
            or [f for f in families if f"# TYPE {f} " not in on["scrapes"][-1]]):
        problems.append(f"/metrics: {len(on['scrapes'])} scrapes, step {last.get('automodel_train_step')}")
    if problems:
        raise RuntimeError("25 (a): " + "; ".join(problems))
    seq = on_cfg["dataset"]["seq_length"]
    law = flops_per_token_for_config(on["model_config"], seq)
    cost = costs[0]
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = goodput_main([str(root / "on")])
    roll = rollup(_read_records(root / "on" / "goodput.jsonl"))
    (att,) = roll["attempts"]
    # the harness's own scrapes run between a record and the next window: no segment holds them
    if rc != 0 or att["unattributed_s"] - on["scrape_s"] > 0.05 * att["wall_s"]:
        raise RuntimeError(f"25 (a): goodput rc {rc}, attempt {att}\n{buf.getvalue()}")
    def ratio(kind: list) -> float:
        return statistics.median(a[s]["step_time_s"] for s in kind) / statistics.median(
            b[s]["step_time_s"] for s in kind)

    census = [s for s in steps[1:] if s % OBS_CENSUS_EVERY == 0]
    # the window's step, and the next, whose first hook stops and writes the trace
    window = [OBS_WINDOW_STEP, OBS_WINDOW_STEP + 1]
    plain = [s for s in steps[1:] if s not in census and s not in window]
    out = dict(
        bitwise_equal=True, losses=[a[s]["loss"] for s in steps], grad_norms=[a[s]["grad_norm"] for s in steps],
        step_ms_on=[1e3 * a[s]["step_time_s"] for s in steps[1:]], step_ms_off=[1e3 * b[s]["step_time_s"] for s in steps[1:]],
        step_time_ratio_on_off=ratio(plain), ratio_steps=plain, step_time_ratio_census_steps=ratio(census),
        step_time_ratio_window_steps=ratio(window),
        mfu_pct=[a[s]["mfu_pct"] for s in steps[1:]], mfu_measured_pct=[a[s]["mfu_measured_pct"] for s in steps[1:]],
        measured_flops_per_token=cost["flops"] / seq, law_flops_per_token=law,
        measured_over_law=cost["flops"] / seq / law, roofline_class=cost.get("roofline_class"),
        arithmetic_intensity=cost.get("arithmetic_intensity"), cost_eqns=cost.get("eqns"),
        compile_time_s=(a[1]["compile_time_s"], b[1]["compile_time_s"]),
        mem_bytes_in_use={s: a[s]["mem_bytes_in_use"] for s in census},
        heartbeat_age_s=[a[s]["heartbeat_age_s"] for s in steps], launches=on["launches"],
        goodput=dict(wall_s=att["wall_s"], unattributed_s=att["unattributed_s"], scrape_s=on["scrape_s"],
                     segments=att["segments"],
                     goodput_fraction=att.get("goodput_fraction")),
        scrape_step=last.get("automodel_train_step"), scrape_families=len(families),
        wall_s=(on["wall_s"], off["wall_s"]),
    )
    print(f"phase 25 (a) sections on / off at {layers} layers: {json.dumps(out)} | {card_line()}", flush=True)
    return out


def phase_obs_profile(torch, prefix, root) -> dict:
    """Phase 25 (b): the ``profile`` command at DATA_PRETRAIN_LAYERS: the trace must
    hold device kernel events (it fails with none), K1's three kernels
    among the top ops with layers x steps launches (the forward twice under
    remat: full), the busy share and the largest host gaps printed."""
    from automodel_tpu_torch.config import ConfigNode
    from automodel_tpu_torch.telemetry.profiling.runner import main as profile_main

    cfg = obs_config(prefix, root, "profile", 100, profiling=dict(OBS_PROFILE, top_k=400))
    t0 = time.perf_counter()
    rc = profile_main(ConfigNode(cfg))
    wall = time.perf_counter() - t0
    report = json.loads((root / "profile" / "profile" / "report.json").read_text())
    if rc != 0 or report["kernel_events"] == 0:
        raise RuntimeError(f"25 (b): profile rc {rc}, {report['kernel_events']} kernel events in the trace "
                           f"(device {report['device']}): the profiler recorded no CUDA activity")
    layers, steps = cfg["model"]["hf_config"]["num_hidden_layers"], OBS_PROFILE["trace_steps"]
    counts = flash_counts(report["top_ops"])
    # the kernel libraries link the static cudart: does the trace hold the
    # host launch event of each K1 kernel (its correlation id), as it does
    # for torch's own kernels?
    from automodel_tpu_torch.telemetry.profiling.trace import load_trace_events

    events = load_trace_events(root / "profile" / "profile" / "trace")
    host = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            host[(e.get("args") or {}).get("correlation")] = e.get("name")
    k1 = [e for e in events if e.get("cat") == "kernel" and "flash_" in str(e.get("name"))]
    torch_k = [e for e in events if e.get("cat") == "kernel" and "flash_" not in str(e.get("name"))]
    linked = [host.get((e.get("args") or {}).get("correlation")) for e in k1]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    edges = [(str(e.get("name"))[:60], round(e["ts"] - kernels[0]["ts"], 1)) for e in kernels[:10] + kernels[-3:]]
    print(f"phase 25 (b) the trace's first and last kernels (name, us from the first): {edges}", flush=True)
    launches = dict(k1_kernels=len(k1), k1_with_host_launch=sum(x is not None for x in linked),
                    k1_launch_names=sorted({x for x in linked if x}),
                    torch_kernels=len(torch_k),
                    torch_with_host_launch=sum(host.get((e.get("args") or {}).get("correlation")) is not None
                                               for e in torch_k))
    want = dict(fwd=2 * layers * steps, dq=layers * steps, dkv=layers * steps)
    if counts != want:
        raise RuntimeError(f"25 (b): K1 launches in the trace {counts}, want {want}; launch events {launches}; "
                           f"top ops {[(o['name'], o['count']) for o in report['top_ops'][:30]]}")
    out = dict(rc=rc, wall_s=wall, kernel_events=report["kernel_events"], op_events=report["op_events"],
               window_s=report["window_s"], device_busy_s=report["device_busy_s"],
               device_busy_fraction=report["device_busy_fraction"], host_gap_s=report["host_gap_s"],
               host_gaps=report["host_gaps"], flash_counts=counts,
               flash_self_s={k: sum(o["self_s"] for o in report["top_ops"] if f"flash_{k}_kernel" in o["name"])
                             for k in ("fwd", "dq", "dkv")},
               top_ops=[(o["name"], o["count"], o["self_s"], o["share_pct"]) for o in report["top_ops"][:8]],
               launch_events=launches, run_metrics=report.get("run_metrics"))
    print(f"phase 25 (b) profile at {layers} layers: {json.dumps(out)} | {card_line()}", flush=True)
    return out


def phase_obs_flops(torch, prefix, root) -> dict:
    """Phase 25 (c): at Llama-3-8B width cut to 2 layers, the counted step's
    flops under ``attn: flash`` equal ``attn: sdpa``'s exactly."""
    flops = {}
    for attn in ("flash", "sdpa"):
        cfg = obs_config(prefix, root, f"flops_{attn}", 1, OBS_LAYERS)
        cfg["model"]["backend"]["attn"] = attn
        run = obs_run(torch, cfg)
        (cost,) = [r for r in run["rows"] if r.get("event") == "cost_attribution"]
        flops[attn] = cost
    keys = ("flops", "dot_flops", "dot_ops")
    out = {attn: {k: flops[attn][k] for k in keys} for attn in flops}
    print(f"phase 25 (c) counted flops, flash against sdpa at 2 layers: {json.dumps(out)}", flush=True)
    if flops["flash"]["flops"] != flops["sdpa"]["flops"] or flops["flash"]["dot_flops"] != flops["sdpa"]["dot_flops"]:
        raise RuntimeError(f"25 (c): flash counts {out['flash']}, sdpa {out['sdpa']}")
    return out


def phase_obs_triggered(torch, prefix, root) -> dict:
    """Phase 25 (d): a straggled step fires a triggered capture whose trace
    holds K1's kernels beside a CUDA memory snapshot; NaN grads under
    ``skip`` log the skipped step with its non-finite group norm and a
    capture with reason ``nonfinite``."""
    from automodel_tpu_torch.telemetry.profiling.trace import analyze_trace, load_trace_events

    run = obs_run(torch, obs_config(prefix, root, "straggle", 9, OBS_LAYERS, fault_injection=OBS_STRAGGLE,
                                    profiling=dict(triggered=OBS_TRIGGER)))
    caps = [r for r in run["rows"] if r.get("event") == "trace_capture" and r.get("capture_path")]
    if [c["reason"] for c in caps] != ["slow_step"]:
        raise RuntimeError(f"25 (d): captures {caps}")
    cap = caps[0]
    report = analyze_trace(load_trace_events(cap["trace_file"]), top_k=400)
    snap = cap.get("memory_profile")
    counts = flash_counts(report["top_ops"])
    if not (snap and os.path.getsize(snap) > 0) or not all(counts.values()):
        raise RuntimeError(f"25 (d): capture {cap}, K1 in its trace {counts}")
    straggle = dict(capture=cap, trace_kernel_events=report["kernel_events"], flash_counts=counts,
                    snapshot_bytes=os.path.getsize(snap))
    nan = obs_run(torch, obs_config(prefix, root, "nan", 6, OBS_LAYERS, fault_tolerance=dict(on_nonfinite="skip"),
                                    fault_injection=dict(nan_grads_at_step=OBS_NAN_STEP)))
    rows = train_rows(nan["rows"])
    bad = rows[OBS_NAN_STEP]
    ncaps = [r for r in nan["rows"] if r.get("event") == "trace_capture" and r.get("capture_path")]
    if (bad["nonfinite"] is not True or bad["skipped"] is not True or bad["grad_norm/layers"] is not None
            or not bad.get("grad_norm/layers_nonfinite") or [c["reason"] for c in ncaps] != ["nonfinite"]
            or rows[6].get("skipped_steps_total") != 1):
        raise RuntimeError(f"25 (d): the NaN step's record {bad}, captures {ncaps}")
    out = dict(straggle=straggle, nan_step={k: bad.get(k) for k in ("nonfinite", "skipped", "grad_nonfinite_count",
                                                                     "grad_norm/layers", "grad_norm/layers_nonfinite")},
               nan_capture=ncaps[0])
    print(f"phase 25 (d) triggered captures: {json.dumps(out)}", flush=True)
    return out


def obs_subprocess(cfg: dict, path, extra: tuple = ()) -> subprocess.Popen:
    here = __import__("pathlib").Path(__file__).resolve().parent
    path.write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "AUTOMODEL_FAULT_INJECTION"}
    env["PYTHONPATH"] = str(here)
    return subprocess.Popen([sys.executable, "-m", "automodel_tpu_torch.cli.app", "pretrain", "llm", "-c", str(path),
                             *extra], cwd=str(here), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_obs_subprocesses(prefix, root) -> dict:
    """Phase 25 (e), started: two ``pretrain llm`` CLI processes at 2
    layers, a hang after the step-2 checkpoint and a run to be SIGTERMed
    (they run beside (c) and (d))."""
    hang_cfg = obs_config(prefix, root, "hang", 100, OBS_LAYERS,
                          checkpoint=dict(OBS_CKPT, checkpoint_dir=str(root / "hang" / "ckpt")),
                          fault_injection=dict(hang_at_step=OBS_HANG_STEP, hang_seconds=600),
                          distributed_guard=dict(watchdog=OBS_WATCHDOG))
    hang_cfg["step_scheduler"]["ckpt_every_steps"] = 2
    term_cfg = obs_config(prefix, root, "term", 100, OBS_LAYERS,
                          checkpoint=dict(OBS_CKPT, checkpoint_dir=str(root / "term" / "ckpt")),
                          fault_injection=dict(slow_collate_ms=300))
    (root / "hang").mkdir(parents=True, exist_ok=True)
    (root / "term").mkdir(parents=True, exist_ok=True)
    return dict(t0=time.perf_counter(), term_cfg=term_cfg, hang=obs_subprocess(hang_cfg, root / "hang.json"),
                term=obs_subprocess(term_cfg, root / "term.json"))


def phase_obs_subprocesses(torch, prefix, root, started: dict | None = None) -> dict:
    """Phase 25 (e), finished: the hang exits 75 with the stacks, a hang
    event and a flight-recorder dump, within the deadline plus one poll;
    SIGTERM mid-run exits 75 with a committed emergency checkpoint, the
    restart resumes at the next step, and ``goodput`` shows one joined
    ledger."""
    from automodel_tpu_torch.telemetry.goodput import _read_records, rollup
    from automodel_tpu_torch.telemetry.goodput import main as goodput_main

    started = started or start_obs_subprocesses(prefix, root)
    t0, term_cfg, hang, term = started["t0"], started["term_cfg"], started["hang"], started["term"]
    term_rows = root / "term" / "train_metrics.jsonl"
    try:
        while True:
            n = sum(1 for r in (map(json.loads, open(term_rows)) if term_rows.exists() else ()) if "loss" in r)
            if n >= 3 or term.poll() is not None or time.perf_counter() - t0 > 600:
                break
            time.sleep(0.2)
        t_sig = time.perf_counter()
        term.send_signal(__import__("signal").SIGTERM)
        term_out = term.communicate(timeout=600)
        drain_s = time.perf_counter() - t_sig
        hang_out = hang.communicate(timeout=600)
    finally:
        for p in (hang, term):
            if p.poll() is None:
                p.kill()
                p.wait()
    problems = []
    if hang.returncode != 75 or "[watchdog] HANG" not in hang_out[1]:
        problems.append(f"hang: rc {hang.returncode}, stderr {hang_out[1][-3000:]}")
    hdir = root / "hang"
    dump = json.loads((hdir / "flight_recorder.json").read_text()) if (hdir / "flight_recorder.json").exists() else {}
    hrec = next((r for r in dump.get("records", []) if r.get("event") == "hang"), None)
    hrows = [json.loads(l) for l in open(hdir / "train_metrics.jsonl")]
    stacks = (hdir / "watchdog_stacks.txt").read_text() if (hdir / "watchdog_stacks.txt").exists() else ""
    limit = OBS_WATCHDOG["poll_interval_s"] + OBS_EVENT_SLACK_S
    if (hrec is None or hrec["step"] != OBS_HANG_STEP or f"hang at step {OBS_HANG_STEP}" not in stacks
            or not any(r.get("event") == "hang" for r in hrows)
            or not hrec["heartbeat_age_s"] <= hrec["deadline_s"] + limit):
        problems.append(f"hang evidence: record {hrec}, {len(stacks)} bytes of stacks")
    if term.returncode != 75:
        problems.append(f"SIGTERM: rc {term.returncode}, stderr {term_out[1][-3000:]}")
    committed = sorted(int(p.parent.name.rsplit("_", 1)[1]) for p in (root / "term" / "ckpt").glob("*/MANIFEST.json"))
    if problems or len(committed) != 1:
        raise RuntimeError(f"25 (e): {problems}, committed {committed}")
    saved = committed[0]
    trows = [json.loads(l) for l in open(term_rows)]
    tail = next((r for r in trows if r.get("event") == "goodput_tail"), {})
    restart = obs_subprocess(dict(term_cfg, step_scheduler=dict(term_cfg["step_scheduler"], max_steps=saved + 2)),
                             root / "term2.json")
    r_out = restart.communicate(timeout=600)
    rows = [json.loads(l) for l in open(term_rows)]
    resumed = [r["resumed_from_step"] for r in rows if r.get("event") == "resume"]
    after = [r["step"] for r in rows if "loss" in r and r.get("restart_count") == 1]
    roll = rollup(_read_records(root / "term" / "goodput.jsonl"))
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        grc = goodput_main([str(root / "term")])
    atts = roll["attempts"]
    if (restart.returncode != 0 or resumed != [saved] or after != [saved + 1, saved + 2] or grc != 0
            or len(atts) != 2 or atts[0]["end_reason"] != "preempted"
            or any(a["unattributed_s"] > 0.05 * a["wall_s"] for a in atts)):
        raise RuntimeError(f"25 (e): restart rc {restart.returncode} ({r_out[1][-2000:]}), resumed {resumed}, "
                           f"steps {after}, goodput rc {grc}, attempts {atts}")
    out = dict(hang=dict(rc=hang.returncode, step=hrec["step"], heartbeat_age_s=hrec["heartbeat_age_s"],
                         deadline_s=hrec["deadline_s"], poll_interval_s=OBS_WATCHDOG["poll_interval_s"]),
               sigterm=dict(rc=term.returncode, saved_step=saved, signal_to_exit_s=drain_s,
                            ckpt_save_s=tail.get("ckpt_save_s"), window_excluded_s=tail.get("window_excluded_s"),
                            restart_rc=restart.returncode, resumed_from=resumed, steps_after=after),
               goodput=[dict(end=a["end_reason"], wall_s=a["wall_s"], unattributed_s=a["unattributed_s"],
                             segments=a["segments"]) for a in atts],
               wall_s=time.perf_counter() - t0)
    print(f"phase 25 (e) hang and SIGTERM at 2 layers: {json.dumps(out)}", flush=True)
    print("phase 25 (e) goodput report:\n" + buf.getvalue(), flush=True)
    return out


def phase_observability(torch, dev) -> dict:
    """Phase 25 (see the module text)."""
    import shutil

    from automodel_tpu_torch.data import synthetic

    root = data_root().with_name(f"obs_{time.time_ns()}")
    try:
        t0 = time.perf_counter()
        prefix = root / "megatron" / "corpus"
        synthetic.write_megatron_corpus(prefix, OBS_CORPUS_TOKENS, LLAMA3_8B["vocab_size"], seed=0,
                                        median=DATA_DOC_MEDIAN)
        out = dict(on_off=phase_obs_on_off(torch, prefix, root))
        out["profile"] = phase_obs_profile(torch, prefix, root)
        started = start_obs_subprocesses(prefix, root)  # (e) runs beside (c) and (d)
        try:
            out["flops"] = phase_obs_flops(torch, prefix, root)
            out["triggered"] = phase_obs_triggered(torch, prefix, root)
        finally:
            out["subprocesses"] = phase_obs_subprocesses(torch, prefix, root, started)
        out["wall_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def packed_flash_entry(name: str, data: dict) -> dict:
    """K1 on phase 24 (c)'s packed row: its launches in the 8-layer step,
    its time beside the bound of the row's live pairs and SDPA with the
    segment mask."""
    row = data["packing"]["kernels"]
    t = row["timed"][name]
    return dict(launches=data["packing"]["step"]["flash"]["launches"][name], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
                library="scaled_dot_product_attention with the row's mask as attn_mask (its forward beside fwd, "
                        "its backward alone in library_bwd_ms)",
                library_bwd_ms=row["library_bwd_ms"], documents=data["packing"]["documents"],
                live_pairs=row["live_pairs"], shape="B=1 S=4096 N=32 Nkv=8 H=128 causal, a packed row's segments")


# -- phase 26: parallelism --------------------------------------------------------

# (a): configs/sft_llama3_8b_fsdp.yaml as a dict, phase 23's full-depth SFT
# under FSDP2 (tests/test_torch_mesh.py checks the two agree)
SFT_LLAMA3_8B_FSDP = dict(SFT_LLAMA3_8B_FULL, distributed=dict(dp_shard=-1),
                          logging=dict(metrics_path="runs/torch_sft_llama3_8b_fsdp/train_metrics.jsonl"))
FSDP_CHILD_TIMEOUT_S = 600
# (c): the ring at cp = 1 against attn: flash on a 2-layer bf16 Llama whose
# head_dim (128) K1 takes, through the CLI in the same one-rank group
RING_CP1_LAYERS = 2
RING_CP1_STEPS = 3
# (b): the ring's per-rank schedule at cp = 4 virtual ranks
RING_CP = 4
RING_CASES = {
    "llama3-8b": dict(S=32768, N=32, Nkv=8, H=128, window=None, cap=None, scale=None, sinks=False),
    "gemma2-9b window 4096, cap 50": dict(S=16384, N=16, Nkv=8, H=256, window=4096, cap=50.0, scale=1.0 / 16,
                                           sinks=False),
    "gpt-oss-20b sinks": dict(S=16384, N=64, Nkv=8, H=64, window=None, cap=None, scale=None, sinks=True),
}
# the plain versions' sizes: 512-token blocks, and 400 (halves of 200: K1's
# 128- and 64-row tiles straddle the zigzag gap)
RING_PLAIN_S = (2048, 1600)
RING_TIMING_ITERS = 5


def fsdp_child(out_path: str, *configs: str) -> int:
    """The torchrun child of phases 26 (a), (c) and 28 (b): ``finetune
    llm`` through the CLI's ``main`` for each config in turn, in the
    one-rank NCCL group torchrun set up; writes each run's exit code, K1
    launches, K2 and K3 launches (``moe_launches``) and peak device
    memory."""
    import torch

    from automodel_tpu_torch.cli import app
    from automodel_tpu_torch.ops import ring_flash as rf

    kernels = dict(fwd=rf.flash_block_fwd, dq=rf.flash_block_dq, dkv=rf.flash_block_dkv)
    moe = {k: v for k, v in fused_kernel_counters().items() if not k.startswith("flash")}
    runs = []
    for cfg in configs:
        for f in kernels.values():
            f.launches = 0
        moe_before = {k: getattr(f, a) for k, (f, a) in moe.items()}
        # the last run's FSDP state holds cycles: free it before the next
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        at_start = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        rc = app.main(["finetune", "llm", "-c", cfg])
        torch.cuda.synchronize()
        runs.append(dict(config=cfg, rc=rc, wall_s=time.perf_counter() - t0, allocated_at_start_gib=at_start,
                         launches={k: f.launches for k, f in kernels.items()},
                         moe_launches={k: getattr(f, a) - moe_before[k] for k, (f, a) in moe.items()},
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30))
        print(f"fsdp child: {json.dumps(runs[-1])}", flush=True)
    if int(os.environ.get("RANK", "0")) == 0:
        with open(out_path, "w") as f:
            json.dump(runs, f)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


def phase_parallel_fsdp(torch, rest: dict) -> dict:
    """Phase 26 (a) and (c): one torchrun child (one rank, NCCL) runs the
    full-depth SFT under FSDP2, then the 2-layer ring at cp = 1 and its
    flash twin, then phase 28 (b)'s two Moonlight runs; (a)'s losses and
    grad norms are held to phase 23's run of the same config unwrapped."""
    from pathlib import Path

    here = Path(__file__).resolve().parent
    root = here / "runs" / "chip_smoke" / f"parallel_{time.time_ns()}"
    root.mkdir(parents=True, exist_ok=True)
    full = json.loads(json.dumps(SFT_LLAMA3_8B_FSDP))
    full["device"] = TRAIN_DEVICE
    full["step_scheduler"].update(max_steps=FULL_STEPS, log_every_steps=1)
    full["logging"]["metrics_path"] = str(root / "fsdp.jsonl")
    tiny = {}
    for attn in ("ring", "flash"):
        cfg = dict(json.loads(json.dumps(SFT_LLAMA3_8B_FULL)), device=TRAIN_DEVICE, distributed=dict(cp=1),
                   logging=dict(metrics_path=str(root / f"cp1_{attn}.jsonl")))
        cfg["model"]["hf_config"].update(num_hidden_layers=RING_CP1_LAYERS)
        cfg["model"]["backend"].update(attn=attn, remat="none")
        cfg["step_scheduler"].update(max_steps=RING_CP1_STEPS, log_every_steps=1)
        tiny[attn] = cfg
    paths = []
    for tag, cfg in (("fsdp", full), ("cp1_ring", tiny["ring"]), ("cp1_flash", tiny["flash"])):
        paths.append(root / f"{tag}.json")
        paths[-1].write_text(json.dumps(cfg))
    # phase 28 (b)'s two Moonlight runs ride the same child (one torchrun
    # start fewer); phase 28 checks them
    paths += p28_fsdp_configs(root / "moe_fsdp")
    out_path = root / "child.json"
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(here))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", str(here / "chip_smoke.py"),
         "--fsdp-child", str(out_path), *map(str, paths)],
        cwd=str(here), env=env, capture_output=True, text=True, timeout=FSDP_CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"26: the torchrun child exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    runs = json.loads(out_path.read_text())
    print("\n".join(line for line in proc.stdout.splitlines() if line.startswith("fsdp child:")), flush=True)
    steps = {tag: [r for r in map(json.loads, open(root / f"{tag}.jsonl")) if "loss" in r]
             for tag in ("fsdp", "cp1_ring", "cp1_flash")}
    f = steps["fsdp"]
    if [r["step"] for r in f] != list(range(1, FULL_STEPS + 1)) or any(r["nonfinite"] for r in f):
        raise RuntimeError(f"26 (a): step rows {f}")
    layers = full["model"]["hf_config"]["num_hidden_layers"]
    want = dict(fwd=layers * FULL_STEPS * 2, dq=layers * FULL_STEPS, dkv=layers * FULL_STEPS)
    if runs[0]["launches"] != want:
        raise RuntimeError(f"26 (a): flash launches {runs[0]['launches']}, want {want}")
    ref = rest["full"]
    loss_err = max(abs(a["loss"] - b) / abs(b) for a, b in zip(f, ref["losses"]))
    norm_err = max(abs(a["grad_norm"] - b) / abs(b) for a, b in zip(f, ref["grad_norms"]))
    if loss_err > STEP_LOSS_REL_TOL or norm_err > STEP_GRAD_NORM_REL_TOL:
        raise RuntimeError(f"26 (a): FSDP2 losses {[r['loss'] for r in f]} / grad norms "
                           f"{[r['grad_norm'] for r in f]} against phase 23's {ref['losses']} / {ref['grad_norms']}")
    bit = [r["loss"] for r in f] == ref["losses"] and [r["grad_norm"] for r in f] == ref["grad_norms"]
    step_s = statistics.median(r["step_time_s"] for r in f[1:])
    a = dict(layers=layers, losses=[r["loss"] for r in f], grad_norms=[r["grad_norm"] for r in f],
             loss_max_rel_err=loss_err, grad_norm_max_rel_err=norm_err, bit_for_bit_with_phase_23=bit,
             step_ms=1e3 * step_s, step_ms_unwrapped=ref["step_ms"], peak_gib=runs[0]["peak_gib"],
             peak_gib_unwrapped=ref["peak_mem_gib"], flash_launches=runs[0]["launches"], wall_s=runs[0]["wall_s"],
             child_s=child_s)
    print(f"phase 26 (a) FSDP2 at {layers} layers, one-rank NCCL group under torchrun: {json.dumps(a)} | "
          f"{card_line()}", flush=True)
    ring_rows, flash_rows = steps["cp1_ring"], steps["cp1_flash"]
    same = [(r["loss"], r["grad_norm"]) for r in ring_rows] == [(r["loss"], r["grad_norm"]) for r in flash_rows]
    if not same or len(ring_rows) != RING_CP1_STEPS:
        raise RuntimeError(f"26 (c): attn ring at cp = 1 {ring_rows} against attn flash {flash_rows}")
    want = dict(fwd=RING_CP1_LAYERS * RING_CP1_STEPS, dq=RING_CP1_LAYERS * RING_CP1_STEPS,
                dkv=RING_CP1_LAYERS * RING_CP1_STEPS)
    if runs[1]["launches"] != want or runs[2]["launches"] != want:
        raise RuntimeError(f"26 (c): flash launches ring {runs[1]['launches']}, flash {runs[2]['launches']}, want {want}")
    c = dict(losses=[r["loss"] for r in ring_rows], grad_norms=[r["grad_norm"] for r in ring_rows],
             bit_for_bit_with_flash=same, ring_launches=runs[1]["launches"])
    print(f"phase 26 (c) attn ring at cp = 1 through the CLI: {json.dumps(c)}", flush=True)
    moe = p28_fsdp_results(root / "moe_fsdp", runs[3:])
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    return dict(fsdp=a, ring_cp1=c, expert_fsdp_runs=moe)


def _ring_layout(torch, x, zigzag: bool, axis: int = 1, undo: bool = False):
    from automodel_tpu_torch.parallel import cp as tcp

    if not zigzag:
        return x
    return (tcp.undo_zigzag if undo else tcp.apply_zigzag)(x, RING_CP, axis=axis)


def run_ring(torch, tcp, ranks: dict, sinks, kw: dict, zigzag: bool) -> tuple:
    """Every rank's forward and backward steps of the ring, in ring order
    → (outs, lses, dqs, dks, dvs, d_sinks)."""
    outs, lses = tcp.ring_forward_ranks(ranks["q"], ranks["k"], ranks["v"], None, sinks, zigzag=zigzag, **kw)
    grads = tcp.ring_backward_ranks(ranks["q"], ranks["k"], ranks["v"], outs, lses, ranks["do"], None, sinks,
                                    zigzag=zigzag, **kw)
    return (outs, lses) + tuple(grads)


def ring_case(torch, dev, name: str, c: dict, zigzag: bool, seed: int, time_it: bool = True) -> dict:
    """One ring at cp = 4 virtual ranks of S / 4 tokens: the stitched out,
    lse, dq, dk and dv (and d_sinks) held to K1 over the whole sequence,
    every rank's K1 time and live pairs beside its bound."""
    from automodel_tpu_torch.ops import ring_flash as rf
    from automodel_tpu_torch.parallel import cp as tcp

    S, N, Nkv, H = c["S"], c["N"], c["Nkv"], c["H"]
    q, k, v, do, pos, _ = flash_case(torch, dev, S=S, H=H, N=N, Nkv=Nkv, seed=seed)
    sinks = None
    if c["sinks"]:
        sinks = (torch.randn(N, generator=torch.Generator(device=dev).manual_seed(seed), device=dev) * 2)
    scale = c["scale"] if c["scale"] is not None else H ** -0.5
    kw = dict(causal=True, window=c["window"], scale=scale, soft_cap=c["cap"])
    # the whole sequence through K1 in its natural order
    ref_out, ref_lse = rf.flash_block_fwd(q, k, v, pos, pos, None, None, **kw)
    if sinks is not None:
        ref_out, ref_lse = rf.fold_sinks(ref_out, ref_lse, sinks)
    delta = tcp.ring_delta(do, ref_out)
    ref_dq, ref_dk, ref_dv = rf.flash_block_bwd(q, k, v, do, ref_lse, delta, pos, pos, None, None, **kw)
    ref_ds = None if sinks is None else rf.sinks_grad(ref_lse, delta, sinks)
    s_loc = S // RING_CP
    ranks = {n: list(_ring_layout(torch, t, zigzag).split(s_loc, dim=1)) for n, t in
             dict(q=q, k=k, v=v, do=do).items()}
    ranks = {n: [t.contiguous() for t in ts] for n, ts in ranks.items()}
    kernels = (rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv)
    for f in kernels:
        f.launches = 0
    outs, lses, dqs, dks, dvs, d_sinks = run_ring(torch, tcp, ranks, sinks, kw, zigzag)
    torch.cuda.synchronize()
    launches = dict(zip(("fwd", "dq", "dkv"), (f.launches for f in kernels)))
    if launches != dict(fwd=RING_CP**2, dq=RING_CP**2, dkv=RING_CP**2):
        raise RuntimeError(f"26 (b) {name}: K1 launches {launches}, want {RING_CP ** 2} each")
    stitched = lambda ts, axis=1: _ring_layout(torch, torch.cat(ts, dim=axis), zigzag, axis=axis, undo=True)
    out, lse = stitched(outs), stitched(lses, axis=2)
    errs = dict(out_row_err=row_rel_err(out, ref_out),
                lse_max_abs_err=float((lse - ref_lse).abs().max()),
                dq_row_err=grad_row_err(stitched(dqs), ref_dq), dk_row_err=grad_row_err(stitched(dks), ref_dk),
                dv_row_err=grad_row_err(stitched(dvs), ref_dv),
                max_abs_err=float((out.float() - ref_out.float()).abs().max()))
    if sinks is not None:
        # each head's d_sinks error against the sum of its terms' magnitudes (phase 11's measure)
        p_sink = torch.exp(sinks[None, :, None] - ref_lse)
        mag = (p_sink * (do.float().norm(dim=-1) * ref_out.float().norm(dim=-1)).transpose(1, 2)).sum(dim=(0, 2))
        errs["d_sinks_err"] = float(((d_sinks - ref_ds).abs() / mag.clamp_min(1e-30)).max())
    bad = (errs["out_row_err"] > FLASH_OUT_TOL or errs["lse_max_abs_err"] > FLASH_LSE_TOL
           or max(errs[k] for k in ("dq_row_err", "dk_row_err", "dv_row_err")) > FLASH_GRAD_TOL
           or errs.get("d_sinks_err", 0.0) > SINKS_GRAD_TOL or not torch.isfinite(out.float()).all())
    if bad:
        raise RuntimeError(f"26 (b) {name} zigzag={zigzag}: the stitched ring against K1 whole: {errs}")
    row = dict(case=name, zigzag=zigzag, S=S, cp=RING_CP, launches=launches, **errs)
    if not time_it:
        return row
    pos_r = [tcp.rank_positions(r, s_loc, RING_CP, zigzag, dev) for r in range(RING_CP)]
    per_rank = []
    for r in range(RING_CP):
        ms = dict(fwd=0.0, dq=0.0, dkv=0.0)
        bound = dict(fwd=0.0, dq=0.0, dkv=0.0)
        pairs = 0
        for step in range(RING_CP):
            j = (r - step) % RING_CP
            p = tcp.live_pairs(pos_r[r], pos_r[j], True, c["window"])
            pairs += p
            args = (ranks["q"][r], ranks["k"][j], ranks["v"][j], ranks["do"][r], lses[r],
                    tcp.ring_delta(ranks["do"][r], outs[r]), pos_r[r], pos_r[j], None, None)
            ms["fwd"] += cuda_ms(lambda: rf.flash_block_fwd(*args[:3], *args[6:], **kw), iters=RING_TIMING_ITERS)
            ms["dq"] += cuda_ms(lambda: rf.flash_block_dq(*args, **kw), iters=RING_TIMING_ITERS)
            ms["dkv"] += cuda_ms(lambda: rf.flash_block_dkv(*args, **kw), iters=RING_TIMING_ITERS)
            b = flash_bound(ranks["q"][r], ranks["k"][j], p)
            for n in bound:
                bound[n] += b[n][0]
        per_rank.append(dict(rank=r, live_pairs=pairs, ms=ms, bound_ms=bound))
    row["per_rank"] = per_rank
    if name == "llama3-8b" and zigzag:
        # the library yardstick at one step: SDPA with the block pair's mask
        # (rank 0 against its own block: the causal diagonal of both halves)
        step_args = (ranks["q"][0], ranks["k"][0], ranks["v"][0], ranks["do"][0], lses[0],
                     tcp.ring_delta(ranks["do"][0], outs[0]), pos_r[0], pos_r[0], None, None)
        mask = (pos_r[0][:, None] >= pos_r[0][None, :])[None]
        lib = sdpa_mask_library_ms(torch, *step_args[:4], mask)
        row["step0"] = dict(
            live_pairs=tcp.live_pairs(pos_r[0], pos_r[0], True, None),
            fwd_ms=cuda_ms(lambda: rf.flash_block_fwd(*step_args[:3], *step_args[6:], **kw), iters=10),
            dq_ms=cuda_ms(lambda: rf.flash_block_dq(*step_args, **kw), iters=10),
            dkv_ms=cuda_ms(lambda: rf.flash_block_dkv(*step_args, **kw), iters=10),
            library_fwd_ms=lib[0], library_fwd_bwd_ms=lib[1], library_bwd_ms=lib[2],
            library="scaled_dot_product_attention with the step's boolean mask as attn_mask")
        del mask
    pairs = [x["live_pairs"] for x in per_rank]
    row["live_pairs_max_over_min"] = max(pairs) / max(min(pairs), 1)
    fwd = [x["ms"]["fwd"] + x["ms"]["dq"] + x["ms"]["dkv"] for x in per_rank]
    row["k1_ms_max_over_min"] = max(fwd) / min(fwd)
    torch.cuda.empty_cache()
    return row


def ring_plain_check(torch, dev, S: int) -> dict:
    """(b): the ring through K1 against the ring through the plain versions
    (the same steps and merges, each K1 call swapped for its plain fp32
    version) at Llama-3-8B's heads and ``S`` over 4 zigzag ranks: the
    forwards on the same inputs, then both backwards from the K1 ring's
    out and lse, so each kernel meets its plain version on the same
    inputs."""
    from automodel_tpu_torch.ops import ring_flash as rf
    from automodel_tpu_torch.parallel import cp as tcp

    c = RING_CASES["llama3-8b"]
    q, k, v, do, pos, _ = flash_case(torch, dev, S=S, H=c["H"], N=c["N"], Nkv=c["Nkv"], seed=261)
    kw = dict(causal=True, window=None, scale=c["H"] ** -0.5, soft_cap=None)
    s_loc = S // RING_CP
    ranks = {n: [t.contiguous() for t in _ring_layout(torch, x, True).split(s_loc, dim=1)]
             for n, x in dict(q=q, k=k, v=v, do=do).items()}
    qs, ks, vs, dos = ranks["q"], ranks["k"], ranks["v"], ranks["do"]
    outs, lses = tcp.ring_forward_ranks(qs, ks, vs, zigzag=True, **kw)
    grads = tcp.ring_backward_ranks(qs, ks, vs, outs, lses, dos, zigzag=True, **kw)
    saved = (rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv)
    try:
        rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv = rf._flash_fwd_plain, rf._flash_dq_plain, rf._flash_dkv_plain
        p_outs, p_lses = tcp.ring_forward_ranks(qs, ks, vs, zigzag=True, **kw)
        p_grads = tcp.ring_backward_ranks(qs, ks, vs, outs, lses, dos, zigzag=True, **kw)
    finally:
        rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv = saved
    times = dict(fwd_ms=cuda_ms(lambda: tcp.ring_forward_ranks(qs, ks, vs, zigzag=True, **kw), iters=3),
                 bwd_ms=cuda_ms(lambda: tcp.ring_backward_ranks(qs, ks, vs, outs, lses, dos, zigzag=True, **kw),
                                iters=3))
    try:
        rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv = rf._flash_fwd_plain, rf._flash_dq_plain, rf._flash_dkv_plain
        times.update(
            plain_fwd_ms=cuda_ms(lambda: tcp.ring_forward_ranks(qs, ks, vs, zigzag=True, **kw), iters=2, warmup=1),
            plain_bwd_ms=cuda_ms(lambda: tcp.ring_backward_ranks(qs, ks, vs, outs, lses, dos, zigzag=True, **kw),
                                 iters=2, warmup=1))
    finally:
        rf.flash_block_fwd, rf.flash_block_dq, rf.flash_block_dkv = saved
    cat = lambda ts, axis=1: torch.cat(ts, dim=axis)
    errs = dict(out_row_err=row_rel_err(cat(outs), cat(p_outs)),
                lse_max_abs_err=float((cat(lses, 2) - cat(p_lses, 2)).abs().max()),
                dq_row_err=grad_row_err(cat(grads[0]), cat(p_grads[0])),
                dk_row_err=grad_row_err(cat(grads[1]), cat(p_grads[1])),
                dv_row_err=grad_row_err(cat(grads[2]), cat(p_grads[2])),
                max_abs_err=float((cat(outs).float() - cat(p_outs).float()).abs().max()))
    if (errs["out_row_err"] > FLASH_OUT_TOL or errs["lse_max_abs_err"] > FLASH_LSE_TOL
            or max(errs[k] for k in ("dq_row_err", "dk_row_err", "dv_row_err")) > FLASH_GRAD_TOL):
        raise RuntimeError(f"26 (b): the ring through K1 against its plain versions at S={S}: {errs}")
    return dict(S=S, cp=RING_CP, **errs, **times)


def phase_ring(torch, dev) -> dict:
    """Phase 26 (b): the ring's per-rank schedule at cp = 4 (see the module
    text)."""
    rows = []
    for i, (name, c) in enumerate(RING_CASES.items()):
        for zigzag in ((True, False) if name == "llama3-8b" else (True,)):
            rows.append(ring_case(torch, dev, name, c, zigzag, seed=260 + i))
            r = rows[-1]
            print(f"phase 26 (b) ring {name} S={r['S']} cp={RING_CP} zigzag={zigzag}: errors "
                  + json.dumps({k: r[k] for k in r if k.endswith("err")})
                  + "; per rank K1 ms (fwd + dq + dkv) and live pairs: "
                  + ", ".join(f"rank {x['rank']} {x['ms']['fwd'] + x['ms']['dq'] + x['ms']['dkv']:.3f} ms "
                              f"{x['live_pairs']} pairs" for x in r["per_rank"])
                  + f"; max/min pairs {r['live_pairs_max_over_min']:.3f}, K1 ms {r['k1_ms_max_over_min']:.3f} | "
                  f"{card_line()}", flush=True)
    plain = [ring_plain_check(torch, dev, S) for S in RING_PLAIN_S]
    print(f"phase 26 (b) the ring through K1 against the plain versions: {json.dumps(plain)}", flush=True)
    return dict(cases=rows, plain=plain)


def ring_flash_entry(name: str, ring: dict) -> dict:
    """K1's row in the ring: launches and per-rank times at Llama-3-8B's
    attention, S = 32768 over 4 zigzag ranks."""
    main = next(r for r in ring["cases"] if r["case"] == "llama3-8b" and r["zigzag"])
    contiguous = next(r for r in ring["cases"] if r["case"] == "llama3-8b" and not r["zigzag"])
    return dict(launches=main["launches"][name], shape="B=1 S=32768 N=32 Nkv=8 H=128 causal, cp=4 zigzag, "
                "8192-token blocks", ms_per_rank=[x["ms"][name] for x in main["per_rank"]],
                bound_ms_per_rank=[x["bound_ms"][name] for x in main["per_rank"]],
                live_pairs_per_rank=[x["live_pairs"] for x in main["per_rank"]],
                contiguous_ms_per_rank=[x["ms"][name] for x in contiguous["per_rank"]],
                contiguous_live_pairs_per_rank=[x["live_pairs"] for x in contiguous["per_rank"]],
                step0=main["step0"], plain=ring["plain"])


# -- phase 27: DeepSeek-V3's family, Moonlight-16B-A3B, MLA through K1 at H = 192 -------

MOONLIGHT_16B_A3B = dict(  # moonshotai/Moonlight-16B-A3B config.json
    architectures=["DeepseekV3ForCausalLM"], model_type="deepseek_v3",
    vocab_size=163840, hidden_size=2048, intermediate_size=11264, moe_intermediate_size=1408,
    num_hidden_layers=27, num_attention_heads=16, num_key_value_heads=16, q_lora_rank=None, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64, num_experts_per_tok=6,
    n_shared_experts=2, first_k_dense_replace=1, moe_layer_freq=1, n_group=1, topk_group=1,
    topk_method="noaux_tc", scoring_func="sigmoid", norm_topk_prob=True, routed_scaling_factor=2.446,
    aux_loss_alpha=0.001, seq_aux=True, hidden_act="silu", rope_theta=50000.0, rope_scaling=None,
    rms_norm_eps=1e-5, max_position_embeddings=8192, attention_bias=False, tie_word_embeddings=False,
)
# automodel_tpu_torch/configs/pretrain_moonlight_16b_a3b.yaml as a dict
# (tests/test_torch_deepseek_v3.py checks the two agree): depth cut to 7
# layers (the dense first and 6 MoE layers)
PRETRAIN_MOONLIGHT_16B_A3B = dict(
    seed=42,
    model=dict(
        hf_config=dict(MOONLIGHT_16B_A3B, num_hidden_layers=7),
        backend=dict(attn="flash", experts="ragged_fused", param_dtype="bfloat16", compute_dtype="bfloat16"),
    ),
    dataset=dict(_target_="automodel_tpu_torch.data.sft.MockSFTDataset", vocab_size=163840,
                 seq_length=4096, num_samples=1024),
    dataloader=dict(global_batch_size=1),
    step_scheduler=dict(grad_acc_steps=2, num_epochs=1, max_steps=4, log_every_steps=1),
    optimizer=dict(name="adamw", lr=3e-4, weight_decay=0.1, betas=[0.9, 0.95], grad_clip_norm=1.0,
                   lr_schedule=dict(style="constant")),
    loss_fn=dict(name="fused_linear_ce"),
    logging=dict(metrics_path="runs/torch_moonlight_16b_a3b/train_metrics.jsonl"),
)
# DeepSeek-V3's attention (deepseek-ai/DeepSeek-V3 config.json): 128 heads
# of 128 nope + 64 rope channels, v 128 (padded to 192 for K1), the yarn
# softmax scale 192^-0.5 x (0.1 x 1.0 x ln 40 + 1)^2
DSV3_MLA_SCALE = 192**-0.5 * (0.1 * math.log(40.0) + 1.0) ** 2
MLA_FLASH_CASES = [
    dict(name="deepseek-v3 mla causal", main=True, H=192, N=128, Nkv=128, scale=DSV3_MLA_SCALE, v_dim=128),
    dict(name="deepseek-v3 mla, 4 packed documents", main=True, H=192, N=128, Nkv=128, scale=DSV3_MLA_SCALE,
         v_dim=128, docs=4),
]
EP_VIRTUAL_RANKS = 4
# gspmd against ragged_fused at a capacity where nothing drops (relative):
# the same routing; gspmd's per-expert MLP runs in bf16 cuBLAS products
# with the activation in bf16 torch, where K3 keeps it in fp32 registers,
# as ragged against ragged_fused in phase 14
GSPMD_LOSS_REL_TOL = FUSED_STEP_LOSS_REL_TOL
GSPMD_GRAD_NORM_REL_TOL = FUSED_STEP_GRAD_NORM_REL_TOL


def moonlight_train_config() -> dict:
    cfg = json.loads(json.dumps(PRETRAIN_MOONLIGHT_16B_A3B))
    cfg["device"] = TRAIN_DEVICE
    here = __import__("pathlib").Path(__file__).resolve().parent
    cfg["logging"]["metrics_path"] = str(here / "runs" / "chip_smoke" / f"moonlight_metrics_{time.time_ns()}.jsonl")
    return cfg


def moonlight_flops_per_token(model, seq: int) -> float:
    """Training flops a token: 6 x the parameters a token's products touch
    (every matrix but the embedding; of the routed experts K of E), plus
    the attention products, 6 x (qk_head_dim + v_head_dim) a live pair and
    head over the causal sequence's pairs (the kernels pad v: not counted)."""
    cfg = model.config
    E, K = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    active = 0.0
    for n, p in model.named_parameters():
        if n == "model.embed_tokens.weight" or p.dim() < 2:
            continue
        active += p.numel() * (K / E if ".mlp.experts." in n else 1.0)
    attn = 6 * (cfg.qk_head_dim + cfg.v_head_dim) * cfg.num_heads * cfg.num_layers * live_pairs(seq, None) / seq
    return 6 * active + attn


# phase 27 (a)'s depth: the config's 7 layers cut to 4 (the dense first and
# 3 MoE layers) for the script's time
MOONLIGHT_TRAIN_LAYERS = 4


def phase_moonlight_training(torch) -> dict:
    """(a) 4 steps of 2 x 4096 tokens (the same two rows each step) at
    Moonlight-16B-A3B's widths, MOONLIGHT_TRAIN_LAYERS layers, through the
    ``pretrain`` recipe class: MLA through K1 at head dim 192, the experts
    through K3 (and K2's gmm in its backward); the loss falls, the
    correction bias moves."""
    cfg = moonlight_train_config()
    cfg["model"]["hf_config"]["num_hidden_layers"] = MOONLIGHT_TRAIN_LAYERS
    # the same 2 rows every step: the mock tokens are uniform, so across
    # rows there is nothing to learn (earlier phases' losses stay flat at
    # ~ln V + 0.4); repeated rows are memorized, so the loss falls when the
    # backward and the update are right
    cfg["dataset"]["num_samples"] = cfg["step_scheduler"]["grad_acc_steps"]
    cfg["step_scheduler"]["num_epochs"] = cfg["step_scheduler"]["max_steps"]
    hf = cfg["model"]["hf_config"]
    moe_layers = hf["num_hidden_layers"] - hf["first_k_dense_replace"]
    n_mb = cfg["step_scheduler"]["grad_acc_steps"] * cfg["step_scheduler"]["max_steps"]
    n, m = moe_layers * n_mb, hf["num_hidden_layers"] * n_mb
    want = dict(fem_fwd=n, fem_bwd_gu=n, fem_bwd_act=n, fem_bwd_dwd=n, fem_bwd_dx=n, gmm=n, gmm_t=n, tgmm=0,
                flash_fwd=m, flash_dq=m, flash_dkv=m)

    def inspect(recipe):
        blocks = recipe.model.moe_layers()
        bias0 = [getattr(b, b.router_name).bias.detach().clone() for b in blocks]
        flops = moonlight_flops_per_token(recipe.model, cfg["dataset"]["seq_length"])

        def after():
            moved = [float((getattr(b, b.router_name).bias - b0).abs().max()) for b, b0 in zip(blocks, bias0)]
            return dict(correction_bias_max_move=moved, flops_per_token=flops)

        return after

    out = run_moe_training(torch, cfg, "moonlight training", fused_kernel_counters(), want, GPT_OSS_FAMILIES,
                           inspect=inspect, time_optimizer=False)
    out["mfu_989"] = out["tokens_per_s"] * out["flops_per_token"] / BF16_FLOPS
    out["head_dim"] = MOONLIGHT_16B_A3B["qk_nope_head_dim"] + MOONLIGHT_16B_A3B["qk_rope_head_dim"]
    print(f"moonlight training: step {out['step_ms']:.1f} ms, {out['tokens_per_s']:.0f} tokens/s, MFU on 989 "
          f"{out['mfu_989']:.4f}, peak {out['peak_mem_gib']:.2f} GiB, K1 at H=192 launches fwd "
          f"{out['launches']['flash_fwd']} dq {out['launches']['flash_dq']} dkv {out['launches']['flash_dkv']}, "
          f"K3 fwd {out['launches']['fem_fwd']}, losses {out['losses']}, correction bias moved by "
          f"{out['correction_bias_max_move']}", flush=True)
    if not out["losses"][-1] < out["losses"][0]:
        raise RuntimeError(f"moonlight training: the loss did not fall over 4 steps: {out['losses']}")
    if not all(x > 0 for x in out["correction_bias_max_move"]):
        raise RuntimeError(f"moonlight training: a layer's correction bias did not move: {out}")
    return out


def phase_moonlight_experts(torch) -> dict:
    """(c) At Moonlight's widths, 2 layers (the dense first, one MoE), one
    4096-token row: ``gspmd`` at a capacity factor where no pick drops
    (from the row's largest expert load) against ``ragged_fused`` (loss,
    grad norm, aux); ``gspmd`` at 1.25 with the share of picks dropped; and
    the ``a2a_fused`` per-rank body at ep = 4 virtual ranks in this process
    (K3 on each rank's 16 local experts, the chunk rows padded) against
    ``ragged_fused`` over the whole row, on the MoE layer's real input:
    output and x-grad rows within 2^-7, expert weight-grad slab rows within
    2^-10. The all-to-all across cards is not measured: one card."""
    from automodel_tpu_torch.data.collators import default_collater
    from automodel_tpu_torch.data.sft import MockSFTDataset
    from automodel_tpu_torch.generation.engine import build_auto_from_model_section
    from automodel_tpu_torch.moe import experts as mexp
    from automodel_tpu_torch.moe import gate as mgate
    from automodel_tpu_torch.moe import layer as moe_layer

    cfg = moonlight_train_config()
    cfg["model"]["hf_config"]["num_hidden_layers"] = 2
    dev = torch.device(cfg["device"])
    model = build_auto_from_model_section(cfg["model"], dev, seed=cfg["seed"], trainable=True).model
    ds = MockSFTDataset(**{k: v for k, v in cfg["dataset"].items() if k != "_target_"})
    mb = {k: torch.from_numpy(v).to(dev) for k, v in default_collater([ds[3]]).items() if hasattr(v, "shape")}
    counters = {k: v for k, v in fused_kernel_counters().items() if not k.startswith("flash")}
    block = model.moe_layers()[0]
    moe_cfg = block.cfg
    E, K, S = moe_cfg.num_experts, moe_cfg.num_experts_per_tok, cfg["dataset"]["seq_length"]
    seen: dict = {}
    real_gate = moe_layer.gate

    def recording_gate(x, weight, *a, **kw):
        out = real_gate(x, weight, *a, **kw)
        seen.update(x=x.detach().clone(), idx=out.topk_idx)
        return out

    def set_backend(experts: str, capacity_factor: float | None = None):
        model.backend = dataclasses.replace(model.backend, experts=experts)
        if capacity_factor is not None:
            block.cfg = dataclasses.replace(moe_cfg, capacity_factor=capacity_factor)

    out: dict = {}
    moe_layer.gate = recording_gate
    try:
        set_backend("ragged_fused")
        out["ragged_fused"] = moe_step(torch, model, mb, counters)
    finally:
        moe_layer.gate = real_gate
    load = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, seen["idx"].reshape(-1), torch.ones_like(seen["idx"].reshape(-1)))
    max_load = int(load.max())
    no_drop = (max_load + 0.5) * E / (S * K)
    set_backend("gspmd", no_drop)
    out["gspmd_no_drop"] = dict(moe_step(torch, model, mb, counters), capacity_factor=no_drop, max_load=max_load,
                                capacity=max(K, math.ceil(S * K / E * no_drop)))
    cap = max(K, math.ceil(S * K / E * 1.25))
    set_backend("gspmd", 1.25)
    out["gspmd_1.25"] = dict(moe_step(torch, model, mb, counters), capacity_factor=1.25, capacity=cap,
                             dropped_share=float((load - cap).clamp_min(0).sum()) / (S * K))
    block.cfg = moe_cfg
    a, b = out["gspmd_no_drop"], out["ragged_fused"]
    out["gspmd_loss_rel"] = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    out["gspmd_grad_norm_rel"] = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
    out["gspmd_aux_abs"] = abs(a["moe_aux_loss"] - b["moe_aux_loss"])  # 0 without an aux coefficient

    # the a2a_fused per-rank body at ep = 4 against ragged_fused, one layer
    x = seen["x"]
    router = getattr(block, block.router_name)
    act2 = moe_layer.make_act2(moe_cfg, torch.nn.functional.silu)
    fused_act = mexp._fused_act_of(moe_cfg, "silu")
    g = torch.Generator(device=dev).manual_seed(27)
    dout = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)

    def run(split: bool):
        xl = x.clone().requires_grad_(True)
        w = {k: v.detach().clone().requires_grad_(True) for k, v in block.experts.named_parameters()}
        gate = lambda t: mgate.gate(t, router.weight, moe_cfg, bias=router.bias, seq_len=S)
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        if split:
            xs = list(xl.chunk(EP_VIRTUAL_RANKS))
            y = torch.cat(mexp.a2a_forward_ranks(xs, [gate(t) for t in xs], w, moe_cfg, act2, fused_act))
        else:
            y = mexp.ragged_fused_experts(xl, gate(xl), w, moe_cfg, act2)
        y.backward(dout)
        torch.cuda.synchronize()
        launches = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items() if getattr(f, a) != before[k]}
        return y.detach(), xl.grad, {k: v.grad for k, v in w.items()}, launches

    y4, dx4, dw4, launches4 = run(True)
    y1, dx1, dw1, launches1 = run(False)
    C = mexp.a2a_chunk_rows(x.shape[0] // EP_VIRTUAL_RANKS, moe_cfg, EP_VIRTUAL_RANKS)
    out["a2a_fused_ep4"] = dict(
        chunk_rows=C, rows_a_rank=EP_VIRTUAL_RANKS * C, picks=S * K, launches=launches4,
        ragged_fused_launches=launches1, out_row_err=row_rel_err(y4, y1), dx_row_err=grad_row_err(dx4, dx1),
        dw_row_err={k: row_rel_err(dw4[k].flatten(1), dw1[k].flatten(1)) for k in dw1},
    )
    print(f"moonlight experts backends (2 layers, one 4096-token row): {json.dumps(out)}", flush=True)
    e = out["a2a_fused_ep4"]
    if launches4.get("fem_fwd") != EP_VIRTUAL_RANKS or launches1.get("fem_fwd") != 1:
        raise RuntimeError(f"a2a_fused at ep = {EP_VIRTUAL_RANKS}: K3 launches {launches4}, want one a rank")
    if out["ragged_fused"]["launches"].get("fem_fwd") != 1 or out["gspmd_no_drop"]["launches"]:
        raise RuntimeError(f"experts backends launched {out}: want K3 once under ragged_fused, no kernel under gspmd")
    if e["out_row_err"] > FEM_ROW_TOL or e["dx_row_err"] > FEM_ROW_TOL or max(e["dw_row_err"].values()) > FEM_DW_ROW_TOL:
        raise RuntimeError(f"a2a_fused at ep = {EP_VIRTUAL_RANKS} disagrees with ragged_fused: {e}")
    if out["gspmd_loss_rel"] > GSPMD_LOSS_REL_TOL or out["gspmd_grad_norm_rel"] > GSPMD_GRAD_NORM_REL_TOL:
        raise RuntimeError(f"gspmd without drops disagrees with ragged_fused: {out}")
    del model, block, x, dout, y4, y1, dx4, dx1, dw4, dw1
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moonlight(torch, dev) -> dict:
    """Phase 27: (a) Moonlight-16B-A3B training, (b) K1 at DeepSeek-V3's
    attention shape, (c) the experts backends."""
    out = dict(training=phase_moonlight_training(torch))
    out["mla_flash"] = run_flash_cases(torch, dev, MLA_FLASH_CASES, "flash (deepseek-v3 mla, H=192)", seed0=270)
    out["experts"] = phase_moonlight_experts(torch)
    return out


def mla_flash_entry(name: str, moon: dict, sass: dict) -> dict:
    """A flash kernel's reading at H = 192: phase 27 (a)'s launches, (b)'s
    times at DeepSeek-V3's attention shape (causal; packed documents
    beside it) and SDPA at the same shape."""
    row_errs = dict(fwd=("out_row_err",), dq=("dq_row_err",), dkv=("dk_row_err", "dv_row_err"))
    cases = moon["mla_flash"]["cases"]
    main, packed = cases
    t = main["timed"][name]
    return dict(
        launches=moon["training"]["launches"][f"flash_{name}"],
        shape="B=1 S=4096 N=128 Nkv=128 H=192 (v 128 zero-padded) causal, scale 192^-0.5 x yarn mscale^2",
        live_pairs=main["live_pairs"], max_row_rel_err=max(c[k] for c in cases for k in row_errs[name]),
        max_abs_err=max(c["max_abs_err"][name] for c in cases),
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        library_bwd_ms=main["library_bwd_ms"], packed_documents={k: packed["timed"][name][k] for k in
                                                                  ("ms", "plain_ms", "bound_ms", "bound_by")},
        sass=sass.get(f"flash_{name}_kernel<192, 0>"),
    )


# -- phase 28: the rest of MoE (tp on the experts, expert_fsdp, muon and adafactor, MXFP4) --

# (a): ep x tp virtual ranks in one process; a few thousand tokens (one
# 4096-token row, 2048 an ep rank), each tp rank running the I-shard of its
# ep rank's experts: Moonlight's I 1408 -> 704, gpt-oss-20b's 2880 -> 1440
P28_EP, P28_TP = 2, 2
P28_TIMING_ITERS = 10
# out and dx rows at ep x tp against one rank: each tp rank's partial (K3's
# bf16 output, its bf16 dx) is rounded to bf16 before the sum, where one
# rank rounds the whole product once, and the partials may cancel: twice
# the one-kernel bound, 2^-6 (the first card reading, gpt-oss-20b's dx,
# was 0.0074, below 2^-7 but close to it). The weight grads are the same
# per-column sums (the I-split partitions the columns): FEM_DW_ROW_TOL.
P28_TP_ROW_TOL = 2.0**-6
# (b), (c): Moonlight-16B-A3B cut to its dense first layer and two MoE layers
P28_LAYERS = 3
P28_STEPS = 3
P28_OPT_LR = dict(muon=1e-3, adafactor=1e-2)


def p28_layer(torch, family: str):
    """One MoE layer at full width, its real input and routing: a 2-layer
    Moonlight (the dense first, one MoE) or a 1-layer gpt-oss-20b built on
    the card from the seed; the MoE block's input recorded at its gate
    over one 4096-token row → (block, x [4096, D], seq_len)."""
    from automodel_tpu_torch.data.collators import default_collater
    from automodel_tpu_torch.data.sft import MockSFTDataset
    from automodel_tpu_torch.generation.engine import build_auto_from_model_section
    from automodel_tpu_torch.moe import layer as moe_layer

    cfg = moonlight_train_config() if family == "moonlight" else gpt_oss_train_config()
    cfg["device"] = TRAIN_DEVICE
    cfg["model"]["hf_config"]["num_hidden_layers"] = 2 if family == "moonlight" else 1
    dev = torch.device(cfg["device"])
    model = build_auto_from_model_section(cfg["model"], dev, seed=cfg["seed"], trainable=True).model
    ds = MockSFTDataset(**{k: v for k, v in cfg["dataset"].items() if k != "_target_"})
    mb = {k: torch.from_numpy(v).to(dev) for k, v in default_collater([ds[5]]).items() if hasattr(v, "shape")}
    seen: dict = {}
    real_gate = moe_layer.gate

    def recording_gate(x, weight, *a, **kw):
        seen["x"] = x.detach().clone()
        return real_gate(x, weight, *a, **kw)

    moe_layer.gate = recording_gate
    try:
        with torch.no_grad():
            model(mb["input_ids"])
    finally:
        moe_layer.gate = real_gate
    block = model.moe_layers()[0]
    del model
    return block, seen["x"], cfg["dataset"]["seq_length"]


def p28_rank_rows(torch, x, gouts, weights, cfg):
    """Rank (ep 0, tp 0)'s local problem: the rows it receives from every ep
    rank sorted by its local expert, their group sizes, and its I-shard of
    its experts' slabs (the operands of its K2 / K3 launches)."""
    from automodel_tpu_torch.moe import experts as mexp

    ep, E = P28_EP, cfg.num_experts
    xs = list(x.chunk(ep))
    C = mexp.a2a_chunk_rows(xs[0].shape[0], cfg, ep)
    sends = [mexp.a2a_pack(t, g.topk_idx, E, ep, C) for t, g in zip(xs, gouts)]
    recv_x = mexp.exchange_ranks([s.x for s in sends], C)[0]
    recv_ids = mexp.exchange_ranks([s.ids for s in sends], C)[0]
    E_loc = E // ep
    order = torch.argsort(recv_ids, stable=True)
    gsz = torch.zeros(E_loc + 1, dtype=torch.int32, device=x.device)
    gsz = gsz.scatter_add_(0, recv_ids, torch.ones_like(recv_ids, dtype=torch.int32))[:E_loc]
    w = mexp._local_slabs(mexp.tp_local_slabs(weights, 0, P28_TP), 0, E_loc)
    return recv_x.index_select(0, order).detach(), gsz, {k: v.detach().contiguous() for k, v in w.items()}, C


def p28_time_kernels(torch, label: str, xs2, gsz, w, cfg, act_kind, limit) -> dict:
    """K3's forward (both launches) and K2's gmm (the gate_up product) on
    rank (0, 0)'s rows at the I-shard, against their plain versions, their
    bounds and ``torch._grouped_mm``."""
    from automodel_tpu_torch.ops import fused_expert_mlp as fem
    from automodel_tpu_torch.ops import grouped_matmul as gm

    M, D = xs2.shape
    I = w["down"].shape[1]
    gub = w.get("gate_up_bias")
    plan = gm.gmm_plan(gsz, M)
    biased = gub is not None
    fwd = lambda: fem.fwd(xs2, w["gate_up"], w["down"], gsz, gub, None, act_kind, limit, plan=plan)
    fwd_plain = lambda: fem._fwd_plain(xs2, w["gate_up"], w["down"], gsz, gub, None, act_kind, limit)
    gmm = lambda: gm.gmm(xs2, w["gate_up"], gsz, plan=plan)
    gmm_plain = lambda: gm._gmm_plain(xs2, w["gate_up"], gsz)
    out = dict(rows=M, routed_rows=int(gsz.sum()), D=D, I=I, experts=int(gsz.shape[0]))
    y, y_plain = fwd(), fwd_plain()
    g, g_plain = gmm(), gmm_plain()
    torch.cuda.synchronize()
    fem_bound_ms, fem_by = fem_bound("fwd", M, D, I, gsz, biased, out_bytes=2)
    gmm_bound_ms, gmm_by = grouped_bound("gmm", xs2, w["gate_up"], gsz, 2 * I)
    gu = gm._gmm_plain(xs2, w["gate_up"], gsz)
    if biased:
        gu = fem.add_row_bias(gu, gub, gsz)
    mid = fem._act_core(gu[:, :I].float(), gu[:, I:].float(), act_kind, limit).to(torch.bfloat16)
    lib = fem_library_ms(torch, "fwd", xs2, None, None, None, w["gate_up"], w["down"], gsz, gub, None, act_kind, limit,
                         fwd_mid=mid)
    out["fused_expert_mlp_fwd"] = dict(
        ms=cuda_ms(fwd, iters=P28_TIMING_ITERS), plain_ms=cuda_ms(fwd_plain, iters=2, warmup=1),
        bound_ms=fem_bound_ms, bound_by=fem_by, library_ms=lib.get("library_ms"),
        gu_library_ms=lib.get("gu_library_ms"), down_library_ms=lib.get("down_library_ms"),
        max_abs_err=float((y.float() - y_plain.float()).abs().max()), max_row_rel_err=row_rel_err(y, y_plain))
    out["grouped_matmul_gmm"] = dict(
        ms=cuda_ms(gmm, iters=P28_TIMING_ITERS), plain_ms=cuda_ms(gmm_plain, iters=2, warmup=1),
        bound_ms=gmm_bound_ms, bound_by=gmm_by, library_ms=grouped_library_ms(torch, "gmm", xs2, w["gate_up"], gsz),
        max_abs_err=float((g.float() - g_plain.float()).abs().max()), max_row_rel_err=row_rel_err(g, g_plain))
    f, k = out["fused_expert_mlp_fwd"], out["grouped_matmul_gmm"]
    if f["max_row_rel_err"] > FEM_ROW_TOL or k["max_row_rel_err"] > GMM_ROW_TOL:
        raise RuntimeError(f"28 (a) {label}: K3 / K2 at I = {I} disagree with their plain versions: {out}")
    print(f"phase 28 (a) {label}: K3 fwd at I = {I} {f['ms']:.4f} ms (plain {f['plain_ms']:.3f}, bound "
          f"{f['bound_ms']:.4f} by {f['bound_by']}, torch._grouped_mm composition {f['library_ms']}), K2 gmm "
          f"{k['ms']:.4f} ms (plain {k['plain_ms']:.3f}, bound {k['bound_ms']:.4f} by {k['bound_by']}, library "
          f"{k['library_ms']}) on rank (0, 0)'s {M} rows ({out['routed_rows']} routed) | {card_line()}", flush=True)
    return out


def p28_tp_layer(torch, family: str) -> dict:
    """28 (a) at one layer: ``a2a_fused`` and ``a2a`` at ep = 2 x tp = 2
    virtual ranks against ``ragged_fused`` / ``ragged`` over all the rows
    on one rank: out and dx rows within P28_TP_ROW_TOL, the slabs' grad
    rows within 2^-10; then K2's and K3's times at the I-shard."""
    from automodel_tpu_torch.moe import experts as mexp
    from automodel_tpu_torch.moe import gate as mgate
    from automodel_tpu_torch.moe import layer as moe_layer

    block, x, S = p28_layer(torch, family)
    dev = x.device
    cfg = block.cfg
    router = getattr(block, block.router_name)
    act2 = moe_layer.make_act2(cfg, torch.nn.functional.silu)
    fused_act = mexp._fused_act_of(cfg, "silu")
    counters = {k: v for k, v in fused_kernel_counters().items() if not k.startswith("flash")}
    g = torch.Generator(device=dev).manual_seed(28)
    dout = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    gate = lambda t: mgate.gate(t, router.weight, cfg, bias=router.bias, seq_len=t.shape[0],
                                linear_bias=router.linear_bias)

    def run(backend: str, split: bool):
        xl = x.clone().requires_grad_(True)
        w = {k: v.detach().clone().requires_grad_(True) for k, v in block.experts.named_parameters()}
        fused = fused_act if backend.endswith("fused") else None
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        if split:
            xs = list(xl.chunk(P28_EP))
            y = torch.cat(mexp.a2a_forward_ranks(xs, [gate(t) for t in xs], w, cfg, act2, fused, tp=P28_TP))
        else:
            one = mexp.ragged_fused_experts if fused else mexp.ragged_experts
            y = one(xl, gate(xl), w, cfg, act2)
        y.backward(dout)
        torch.cuda.synchronize()
        launches = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items() if getattr(f, a) != before[k]}
        return y.detach(), xl.grad, {k: v.grad for k, v in w.items()}, launches

    out = dict(family=family, D=x.shape[1], experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
               I=cfg.moe_intermediate_size, I_shard=cfg.moe_intermediate_size // P28_TP, tokens=x.shape[0],
               ep=P28_EP, tp=P28_TP, activation=cfg.activation, biased=cfg.expert_mlp_bias)
    for backend, ref in (("a2a_fused", "ragged_fused"), ("a2a", "ragged")):
        y4, dx4, dw4, l4 = run(backend, True)
        y1, dx1, dw1, l1 = run(backend, False)
        e = dict(launches=l4, one_rank_launches=l1, against=ref, out_row_err=row_rel_err(y4, y1),
                 dx_row_err=grad_row_err(dx4, dx1),
                 dw_row_err={k: row_rel_err(dw4[k].flatten(1), dw1[k].flatten(1)) for k in dw1})
        out[backend] = e
        n = P28_EP * P28_TP
        want = dict(fem_fwd=n) if backend == "a2a_fused" else dict(gmm=2 * n)
        if any(l4.get(k) != v for k, v in want.items()):
            raise RuntimeError(f"28 (a) {family} {backend}: launches {l4}, want {want} (one a virtual rank)")
        if (e["out_row_err"] > P28_TP_ROW_TOL or e["dx_row_err"] > P28_TP_ROW_TOL
                or max(e["dw_row_err"].values()) > FEM_DW_ROW_TOL):
            raise RuntimeError(f"28 (a) {family} {backend} at ep = {P28_EP} x tp = {P28_TP} disagrees with {ref}: {e}")
        print(f"phase 28 (a) {family} {backend} at ep = {P28_EP} x tp = {P28_TP} against {ref}: {json.dumps(e)}",
              flush=True)
        del y4, dx4, dw4, y1, dx1, dw1
    with torch.no_grad():
        w = {k: v.detach() for k, v in block.experts.named_parameters()}
        xs2, gsz, w0, C = p28_rank_rows(torch, x, [gate(t) for t in x.chunk(P28_EP)], w, cfg)
        out["chunk_rows"] = C
        out["timed"] = p28_time_kernels(torch, family, xs2, gsz, w0, cfg, *fused_act)
    print(f"phase 28 (a) {family} layer at ep = {P28_EP} x tp = {P28_TP}: {json.dumps(out)}", flush=True)
    del block, x, w, w0, xs2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p28_moonlight_config(tag: str, root, **over) -> dict:
    """Moonlight-16B-A3B at P28_LAYERS layers, the same two rows each step
    (phase 27 (a)'s), P28_STEPS steps."""
    cfg = moonlight_train_config()
    cfg["model"]["hf_config"]["num_hidden_layers"] = P28_LAYERS
    cfg["dataset"]["num_samples"] = cfg["step_scheduler"]["grad_acc_steps"]
    cfg["step_scheduler"].update(max_steps=P28_STEPS, num_epochs=P28_STEPS)
    cfg["logging"]["metrics_path"] = str(root / f"{tag}.jsonl")
    cfg.update(over)
    return cfg


P28_FSDP_TAGS = ("unwrapped", "expert_fsdp")


def p28_fsdp_configs(root) -> list:
    """28 (b)'s two configs, written under ``root``: Moonlight at
    P28_LAYERS layers unwrapped and under FSDP2 at world 1
    (``distributed: {dp_shard: -1}``: each MoE layer's experts an FSDP2
    unit over expert_fsdp, sharding the model width) → their paths."""
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for tag, over in zip(P28_FSDP_TAGS, ({}, dict(distributed=dict(dp_shard=-1)))):
        paths.append(root / f"{tag}.json")
        paths[-1].write_text(json.dumps(p28_moonlight_config(tag, root, **over)))
    return paths


def p28_fsdp_results(root, runs: list) -> dict:
    """The torchrun child's reading of 28 (b)'s two configs → their step
    rows and run records (read before ``root`` goes)."""
    return dict(runs=runs, rows={tag: [r for r in map(json.loads, open(root / f"{tag}.jsonl")) if "loss" in r]
                                 for tag in P28_FSDP_TAGS})


def p28_expert_fsdp(torch, root, done: dict | None = None) -> dict:
    """28 (b): Moonlight at P28_LAYERS layers unwrapped and under FSDP2 at
    world 1 in a one-rank NCCL torchrun child: the losses and grad norms
    bit for bit. ``done``: the two runs phase 26's child already made
    (``p28_fsdp_results``); without it (phase 28 alone) a child of its own
    runs them."""
    from pathlib import Path

    if done is None:
        here = Path(__file__).resolve().parent
        paths = p28_fsdp_configs(root)
        out_path = root / "child.json"
        gc.collect()
        torch.cuda.empty_cache()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
             str(here / "chip_smoke.py"), "--fsdp-child", str(out_path), *map(str, paths)],
            cwd=str(here), env=dict(os.environ, PYTHONPATH=str(here)), capture_output=True, text=True,
            timeout=FSDP_CHILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"28 (b): the torchrun child exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-6000:]}")
        done = p28_fsdp_results(root, json.loads(out_path.read_text()))
    runs, a, b = done["runs"], done["rows"]["unwrapped"], done["rows"]["expert_fsdp"]
    moe_layers = P28_LAYERS - MOONLIGHT_16B_A3B["first_k_dense_replace"]
    want = moe_layers * PRETRAIN_MOONLIGHT_16B_A3B["step_scheduler"]["grad_acc_steps"] * P28_STEPS
    out = dict(layers=P28_LAYERS, losses=[r["loss"] for r in b], grad_norms=[r["grad_norm"] for r in b],
               bit_for_bit=[(r["loss"], r["grad_norm"]) for r in a] == [(r["loss"], r["grad_norm"]) for r in b],
               step_ms=1e3 * statistics.median(r["step_time_s"] for r in b[1:]),
               step_ms_unwrapped=1e3 * statistics.median(r["step_time_s"] for r in a[1:]),
               peak_gib=runs[1]["peak_gib"], peak_gib_unwrapped=runs[0]["peak_gib"],
               k3_launches=runs[1]["moe_launches"], wall_s=[r["wall_s"] for r in runs])
    print(f"phase 28 (b) expert_fsdp under FSDP2 at world 1, Moonlight at {P28_LAYERS} layers: {json.dumps(out)} | "
          f"{card_line()}", flush=True)
    if len(b) != P28_STEPS or not out["bit_for_bit"]:
        raise RuntimeError(f"28 (b): FSDP2 {b} against the unwrapped {a}")
    if any(r["moe_launches"].get("fem_fwd") != want for r in runs):
        raise RuntimeError(f"28 (b): K3 launches {[r['moe_launches'] for r in runs]}, want {want} each")
    return out


def p28_optimizers(torch, root) -> dict:
    """28 (c): muon, then adafactor, on Moonlight at P28_LAYERS layers for
    P28_STEPS steps through the recipe: the partition (which JAX leaves
    take Newton-Schulz and which Adam), the step time, the peak memory;
    the loss must fall."""
    out = {}
    for name in ("muon", "adafactor"):
        cfg = p28_moonlight_config(name, root, device=TRAIN_DEVICE)
        cfg["optimizer"] = dict(name=name, lr=P28_OPT_LR[name], lr_schedule=dict(style="constant"))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        recipe, rows, _, wall = run_recipe(torch, cfg)
        opt = recipe.state.optimizer
        steps = [r for r in rows if "loss" in r]
        e = dict(losses=[r["loss"] for r in steps], step_ms=1e3 * statistics.median(r["step_time_s"] for r in steps[1:]),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30, wall_s=wall)
        if name == "muon":
            e["newton_schulz"] = sorted(opt.muon_leaves)
            e["adam"] = sorted(lf.path for lf in opt.leaves if lf.path not in opt.muon_leaves)
        else:
            e["factored"] = sorted(p for p, d in opt.dims.items() if d is not None)
            e["unfactored"] = sorted(p for p, d in opt.dims.items() if d is None)
        out[name] = e
        print(f"phase 28 (c) {name} on Moonlight at {P28_LAYERS} layers: {json.dumps(e)} | {card_line()}", flush=True)
        if not e["losses"][-1] < e["losses"][0]:
            raise RuntimeError(f"28 (c) {name}: the loss did not fall: {e['losses']}")
        del recipe, opt
    return out


def p28_mxfp4(torch, root) -> dict:
    """28 (d): gpt-oss-20b at phase 13's depth written from seeded weights
    into an MXFP4 checkpoint (the experts' ``gate_up_proj`` / ``down_proj``
    packed by ``pack_mxfp4`` on the card) and into a bf16 one of the
    dequantized weights; both loaded with ``from_pretrained``: the logits
    bit for bit, the MXFP4 load's seconds and GB/s; then one training step
    of the MXFP4-loaded model through K3."""
    from automodel_tpu_torch.auto_model import from_config, from_pretrained
    from automodel_tpu_torch.checkpoint import quant_io
    from automodel_tpu_torch.checkpoint.addons import write_hf_addons
    from automodel_tpu_torch.checkpoint.hf_io import save_hf_checkpoint

    cfg = gpt_oss_train_config()
    hf, backend = cfg["model"]["hf_config"], cfg["model"]["backend"]
    dev = torch.device(TRAIN_DEVICE)
    src = from_config(hf, backend, device=dev, seed=cfg["seed"]).model
    adapter = src.state_dict_adapter(src)
    quant, dense = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for key, t in adapter.to_hf(src.state_dict()):
            if key.endswith(("experts.gate_up_proj", "experts.down_proj")):
                blocks, scales = quant_io.pack_mxfp4(t)
                quant += [(f"{key}_blocks", blocks.cpu()), (f"{key}_scales", scales.cpu())]
                dense.append((key, quant_io.dequantize_mxfp4(blocks, scales).cpu()))
            else:
                quant.append((key, t.cpu()))
                dense.append((key, t.cpu()))
    pack_s = time.perf_counter() - t0
    del src
    for tag, tensors in (("mxfp4", quant), ("bf16", dense)):
        save_hf_checkpoint(root / tag, tensors)
        write_hf_addons(root / tag, hf_config=dict(hf, torch_dtype="bfloat16"))
    file_bytes = {tag: sum(f.stat().st_size for f in (root / tag).glob("*.safetensors")) for tag in ("mxfp4", "bf16")}
    del quant, dense
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = from_pretrained(root / "mxfp4", backend, device=dev, trainable=True).model
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = from_pretrained(root / "bf16", backend, device=dev).model
    torch.cuda.synchronize()
    bf16_load_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(281)
    ids = torch.randint(0, hf["vocab_size"], (1, 1024), generator=g).to(dev)
    with torch.no_grad():
        a, _ = model(ids)
        b, _ = ref(ids)
    bitwise = torch.equal(a, b)
    del ref, a, b
    gc.collect()
    torch.cuda.empty_cache()
    from automodel_tpu_torch.data.collators import default_collater
    from automodel_tpu_torch.data.sft import MockSFTDataset

    ds = MockSFTDataset(**{k: v for k, v in cfg["dataset"].items() if k != "_target_"})
    mb = {k: torch.from_numpy(v).to(dev) for k, v in default_collater([ds[0]]).items() if hasattr(v, "shape")}
    counters = {k: v for k, v in fused_kernel_counters().items() if not k.startswith("flash")}
    step = moe_step(torch, model, mb, counters)
    out = dict(layers=hf["num_hidden_layers"], file_bytes=file_bytes, pack_s=pack_s, load_s=load_s,
               load_gbps=gbps(file_bytes["mxfp4"], load_s), bf16_load_s=bf16_load_s,
               bf16_load_gbps=gbps(file_bytes["bf16"], bf16_load_s), logits_bitwise=bitwise, step=step)
    print(f"phase 28 (d) gpt-oss-20b at {out['layers']} layers from MXFP4: {json.dumps(out)} | {card_line()}",
          flush=True)
    if not bitwise:
        raise RuntimeError("28 (d): the MXFP4-loaded model's logits differ from the bf16 checkpoint's")
    if step["launches"].get("fem_fwd") != hf["num_hidden_layers"] or not math.isfinite(step["loss"]):
        raise RuntimeError(f"28 (d): the training step {step}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe_rest(torch, fsdp_done: dict | None = None) -> dict:
    """Phase 28: (a) tp on the experts at full width, (b) expert_fsdp under
    FSDP2 (its runs made by phase 26's torchrun child, ``fsdp_done``),
    (c) muon and adafactor on Moonlight, (d) GPT-OSS from MXFP4."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent / "runs" / "chip_smoke" / f"moe_rest_{time.time_ns()}"
    root.mkdir(parents=True, exist_ok=True)
    try:
        out = dict(tp=dict(moonlight=p28_tp_layer(torch, "moonlight"), gpt_oss=p28_tp_layer(torch, "gpt_oss")))
        out["expert_fsdp"] = p28_expert_fsdp(torch, root, fsdp_done)
        out["optimizers"] = p28_optimizers(torch, root)
        out["mxfp4"] = p28_mxfp4(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def kernels_line(kernels, serving_bf16, serving_int8, profile_bf16, flash, training, grouped, moe, sinks, fused,
                 gpt_oss, flash_cap, gemma, kd, flash_sass, grouped_ptxas, grouped_sass, fused_ptxas, spec,
                 front, traced, rest, data, ring, parallel, moon, rest_moe) -> dict:
    """The ``{"kernels": [...]}`` line: each kernel of the four paths, its
    launches on its path's run and its times at the main case; the paged
    kernel with its times as the context grows (card time with the host
    queued ahead, ``timing``, and back to back beside it) and ptxas's
    report of each instantiation; the flash
    kernels with what this build's SASS names (``flash_sass``) at each
    shape's instantiation, the grouped-matmul kernels with ptxas's report
    and the SASS reading of each instantiation."""
    timed = {c["pool"]: c for c in kernels["cases"] if "plain_ms" in c and not c.get("wide")}
    main_case = timed["bf16"]
    growth = {f"{c['pool']} B={c['batch']} {c['lengths']}": {k: c[k] for k in ("ms", "ms_back_to_back", "bound_ms")}
              for c in kernels["cases"] if "ms" in c and "plain_ms" not in c}
    line = {
        "kernels": [
            {
                "name": "paged_attention",
                "route": "cuda",
                "source": "automodel_tpu_torch/csrc/paged_attention.cu",
                "replaces": "automodel_tpu/ops/paged_attention.py:97",
                "launches": serving_bf16["paged_attend_launches"],
                "max_abs_err": max(c["max_abs_err"] for c in kernels["cases"]),
                "max_row_rel_err": max(c["max_row_rel_err"] for c in kernels["cases"]),
                "ms": main_case["ms"],
                "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"],
                "kernel_ms": main_case["ms"],
                "timing": "queued",
                "ms_back_to_back": main_case["ms_back_to_back"],
                "bytes": main_case["bytes"],
                "host_us_per_call": main_case["host_us_per_call"],
                "int8": {k: timed["int8"][k]
                         for k in ("ms", "ms_back_to_back", "plain_ms", "library_ms", "bound_ms", "bytes")},
                "by_context": growth,
                # verify chunks past 32 query rows a kv head, each tile an
                # instantiation <pool, 128, 2, 2> (its ptxas reading beside it)
                "wide_rows": [
                    dict({k: c[k] for k in ("sq", "pool", "nkv", "rows_per_kv_head", "row_tiles", "lengths", "ms",
                                            "ms_back_to_back", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                            "bytes", "share_of_bound", "max_row_rel_err")},
                         ptxas=next((u for u in kernels["ptxas"] if u["kernel"] ==
                                     f"paged_attention_kernel<{int(c['pool'] == 'int8')}, 128, 2, 2>"), None))
                    for c in kernels["cases"] if c.get("wide")
                ],
                "launches_spec_serving": spec["paged_attend_launches"],
                "launches_int8_run": serving_int8["paged_attend_launches"],
                "launches_serving_front": front["paged_attend_launches"],
                "launches_traced_serving": traced["paged_attend_launches"],
                "decode_forwards": serving_bf16["decode_forwards"],
                "paged_attention_ms_per_decode_step": profile_bf16.get("paged_attention_ms_per_step"),
                "kernels": "paged_attention_kernel<int8 pool, head dim, query n-tiles a warp, warps a worker>; "
                           "the main path's <0, 128, 1, 1> (bf16) and <1, 128, 1, 1> (int8)",
                "ptxas": kernels["ptxas"],
            }
        ]
    }
    main_flash = next(c for c in flash["cases"] if "timed" in c)
    # the Pallas kernel each replaces (ring_flash.py), and its row errors
    replaces = dict(fwd=62, dq=102, dkv=134)
    row_errs = dict(fwd=("out_row_err",), dq=("dq_row_err",), dkv=("dk_row_err", "dv_row_err"))
    for name, line_no in replaces.items():
        t = main_flash["timed"][name]
        line["kernels"].append({
            "name": f"flash_attention_{name}",
            "route": "cuda",
            "source": "automodel_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"automodel_tpu/ops/ring_flash.py:{line_no}",
            "launches": training["flash_launches"][name],
            "max_abs_err": max(c["max_abs_err"][name] for c in flash["cases"]),
            "max_row_rel_err": max(c[k] for c in flash["cases"] for k in row_errs[name]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "scaled_dot_product_attention: its forward beside fwd; its backward alone (dq, dk and dv "
                       "at once) beside dq + dkv, under dq's backward; none computes dq, or dk and dv, alone",
            "live_pairs": main_flash["live_pairs"],
            "shape": "B=1 S=4096 N=32 Nkv=8 H=128 causal",
            "sass": {f"<{H}, {cap}>": flash_sass.get(f"flash_{name}_kernel<{H}, {cap}>")
                     for H, cap in ((128, 0), (256, 1), (64, 0), (192, 0))},
            "with_sinks_max_row_rel_err": max(c[k] for c in sinks["cases"] for k in row_errs[name]),
            "gpt_oss_sinks": sinks_flash_entry(name, sinks),
            "gemma2": gemma_flash_entry(name, flash_cap, gemma, row_errs[name]),
            "kd_llama3_2_1b": kd_flash_entry(name, kd),
            "launches_sft_full_depth": rest["full"]["flash_launches"][name],
            "launches_pretrain_megatron": data["pretrain"]["prefetch"]["flash_launches"][name],
            "packed_segments": packed_flash_entry(name, data),
            "ring_cp4": ring_flash_entry(name, ring),
            "launches_ring_cp4": ring_flash_entry(name, ring)["launches"],
            "launches_fsdp_full_depth": parallel["fsdp"]["flash_launches"][name],
            "launches_ring_cp1_cli": parallel["ring_cp1"]["ring_launches"][name],
            "deepseek_v3_mla_h192": mla_flash_entry(name, moon, flash_sass),
            "launches_moonlight_h192": moon["training"]["launches"][f"flash_{name}"],
        })
        if name == "dq":
            line["kernels"][-1]["backward"] = flash_backward_pair(main_flash)
    # grouped matmul: times at the gate_up-shaped launch of the gate-routed
    # case, the down-shaped launch and gpt-oss-20b's recompute shape beside
    # them; tgmm's main path writes bf16 (ragged_dot's backward), its fp32
    # output (JAX's _tgmm) beside it
    timed = {(r["case"], r["launch"]): r for r in grouped["cases"] if "ms" in r}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "K", "N", "plan_ms")
    instantiations = dict(gmm="gmm_kernel<0>", gmm_t="gmm_kernel<1>", tgmm="tgmm_kernel<")
    for kind, line_no in (("gmm", 155), ("gmm_t", 155), ("tgmm", 230)):
        main_launch = "tgmm_bf16" if kind == "tgmm" else kind
        t, down = timed[("gate", main_launch)], timed[("gate", f"{main_launch}_down")]
        rows = [r for r in grouped["cases"] if r["kind"] == kind]
        line["kernels"].append({
            "name": f"grouped_matmul_{kind}",
            "route": "cuda",
            "source": "automodel_tpu_torch/csrc/grouped_matmul.cu",
            "replaces": f"automodel_tpu/ops/grouped_matmul.py:{line_no}",
            "launches": moe["launches"][kind],
            "launches_spec_serving": spec["gmm_launches"] if kind == "gmm" else 0,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_row_rel_err": max(r["max_row_rel_err"] for r in rows),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "plan_ms": t.get("plan_ms"),
            "shape": f"M={t['M']} K={t['K']} N={t['N']} G=128, gate-routed (gate_up projection), "
                     f"{t['out_dtype']} out",
            "down": {k: down[k] for k in keys if k in down},
            "ptxas": [u for u in grouped_ptxas if u["kernel"].startswith(instantiations[kind])],
            "sass": {k: v for k, v in grouped_sass.items() if k.startswith(instantiations[kind])},
        })
        if kind == "tgmm":
            line["kernels"][-1]["fp32_out"] = {k: timed[("gate", "tgmm")][k] for k in keys if k != "plan_ms"}
            line["kernels"][-1]["fp32_out_down"] = {k: timed[("gate", "tgmm_down")][k] for k in keys if k != "plan_ms"}
        else:
            line["kernels"][-1]["gpt_oss"] = {k: timed[("gpt-oss", kind)][k] for k in keys}
            for entry, r in ((line["kernels"][-1], t), (line["kernels"][-1]["down"], down),
                             (line["kernels"][-1]["gpt_oss"], timed[("gpt-oss", kind)])):
                entry.update({k: r[k] for k in ("order", "ms_by_order")})
    line["kernels"] += fused_entries(fused, gpt_oss, grouped_ptxas + fused_ptxas, grouped_sass)
    for entry in line["kernels"]:
        kind = entry["name"].removeprefix("fused_expert_mlp_")
        if entry["name"].startswith("fused_expert_mlp_"):
            entry["launches_moonlight"] = moon["training"]["launches"][f"fem_{kind}"]
            if kind == "fwd":
                entry["launches_a2a_fused_ep4"] = moon["experts"]["a2a_fused_ep4"]["launches"].get("fem_fwd")
                entry.update(p28_kernel_entry(rest_moe, "fused_expert_mlp_fwd", "a2a_fused", "fem_fwd"))
        if entry["name"] == "grouped_matmul_gmm":
            entry.update(p28_kernel_entry(rest_moe, "grouped_matmul_gmm", "a2a", "gmm"))
    return line


def p28_kernel_entry(rest_moe: dict, timed: str, backend: str, counter: str) -> dict:
    """Phase 28's reading of K3's forward or K2's gmm: its launches at ep =
    2 x tp = 2 (a), (b)'s and (d)'s runs, and its times at each layer's
    I-shard on rank (0, 0)'s rows (Moonlight I 704, gpt-oss-20b I 1440)."""
    tp = rest_moe["tp"]
    return dict(
        launches_tp2_ep2={f: tp[f][backend]["launches"].get(counter) for f in tp},
        launches_expert_fsdp=rest_moe["expert_fsdp"]["k3_launches"].get(counter),
        launches_mxfp4_step=rest_moe["mxfp4"]["step"]["launches"].get(counter),
        tp_shards={f"{f} I={tp[f]['I_shard']}": tp[f]["timed"][timed] for f in tp},
    )


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--fsdp-child":
        return fsdp_child(*sys.argv[2:])
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    try:
        from automodel_tpu_torch.config import ConfigNode
        from automodel_tpu_torch.generation.engine import GenerationConfig
        from automodel_tpu_torch.ops import _cuda_build
        from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine
        from automodel_tpu_torch.serving.server import build_engine
    except ImportError as e:
        fail(f"run from the repository root: the automodel_tpu_torch package is missing ({e})")
    dev = torch.device("cuda")
    try:
        card = card_line()
        name = torch.cuda.get_device_name(0)
        print(f"card: {card} | torch: {name} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

        t0 = time.perf_counter()
        _cuda_build.build(["paged_attention", "flash_attention", "grouped_matmul", "fused_expert_mlp"])
        print(f"kernel build: {time.perf_counter() - t0:.1f}s (nvcc, sm_90a)", flush=True)
        flash_ptxas = _cuda_build.ptxas_usage("flash_attention")
        flash_sass = _cuda_build.sass_registers("flash_attention")
        print(f"ptxas flash_attention: {json.dumps(flash_ptxas)}", flush=True)
        for u in flash_ptxas:
            sass = flash_sass.get(u["kernel"], {})
            print(f"ptxas {u['kernel']}: {u.get('registers')} registers at entry, "
                  f"{sass.get('registers', 'unknown')} named in its code (SASS setmaxnreg dec "
                  f"{sass.get('setmaxnreg_dec', 'unknown')}, inc {sass.get('setmaxnreg_inc', 'unknown')}), "
                  f"{u.get('spill_stores', 0)} bytes spill stores, {u.get('spill_loads', 0)} bytes spill loads",
                  flush=True)
        spilled = [u for u in flash_ptxas if u.get("spill_stores") or u.get("spill_loads")]
        if len(flash_ptxas) != 24 or spilled:
            raise RuntimeError(f"flash kernels: want 24 instantiations and no spills, ptxas reports {flash_ptxas}")
        grouped_ptxas = _cuda_build.ptxas_usage("grouped_matmul")
        grouped_sass = _cuda_build.sass_registers("grouped_matmul")
        print(f"ptxas grouped_matmul: {json.dumps(grouped_ptxas)}", flush=True)
        for u in grouped_ptxas:
            sass = grouped_sass.get(u["kernel"], {})
            print(f"ptxas {u['kernel']}: {u.get('registers')} registers at entry, "
                  f"{sass.get('registers', 'unknown')} named in its code (SASS setmaxnreg dec "
                  f"{sass.get('setmaxnreg_dec', 'unknown')}, inc {sass.get('setmaxnreg_inc', 'unknown')}), "
                  f"{u.get('spill_stores', 0)} bytes spill stores, {u.get('spill_loads', 0)} bytes spill loads",
                  flush=True)
        # gmm_kernel<transpose> x 2, K3a's gmm_act_kernel and gmm_bias_kernel, tgmm_kernel<bf16 out> x 2
        spilled = [u for u in grouped_ptxas if u.get("spill_stores") or u.get("spill_loads")]
        if len(grouped_ptxas) != 6 or spilled:
            raise RuntimeError(f"grouped kernels: want 6 instantiations and no spills, ptxas reports {grouped_ptxas}")
        # bwd_act_kernel, bwd_ddb_kernel, bwd_dgub_kernel
        fused_ptxas = _cuda_build.ptxas_usage("fused_expert_mlp")
        print(f"ptxas fused_expert_mlp: {json.dumps(fused_ptxas)}", flush=True)
        spilled = [u for u in fused_ptxas if u.get("spill_stores") or u.get("spill_loads")]
        if len(fused_ptxas) != 3 or spilled:
            raise RuntimeError(f"fused kernels: want 3 kernels and no spills, ptxas reports {fused_ptxas}")

        # paged_attention_kernel<int8 pool, head dim, query n-tiles a warp, warps a worker>: 18
        paged_ptxas = _cuda_build.ptxas_usage("paged_attention")
        for u in paged_ptxas:
            print(f"ptxas {u['kernel']}: {u.get('registers')} registers, {u.get('spill_stores', 0)} bytes spill "
                  f"stores, {u.get('spill_loads', 0)} bytes spill loads", flush=True)
        spilled = [u for u in paged_ptxas if u.get("spill_stores") or u.get("spill_loads")]
        if len(paged_ptxas) != 18 or spilled:
            raise RuntimeError(f"paged kernels: want 18 instantiations and no spills, ptxas reports {paged_ptxas}")

        torch.backends.cuda.matmul.allow_tf32 = False
        lap = [time.perf_counter()]

        def took(label: str) -> None:
            # each phase's seconds, so a later cut knows where the time goes
            now = time.perf_counter()
            print(f"{label}: {now - lap[0]:.1f}s", flush=True)
            lap[0] = now

        kernels = phase_kernels(torch, dev)
        kernels["ptxas"] = paged_ptxas
        took("phase 3 (paged attention kernel)")
        flash = phase_flash_kernels(torch, dev)
        flash_cap = phase_flash_cap(torch, dev)
        took("phases 3, 3b (flash kernels)")
        grouped = phase_grouped_kernels(torch, dev)
        took("phase 8 (grouped matmul kernels)")
        sinks = phase_flash_sinks(torch, dev)
        fused = phase_fused_kernels(torch, dev)
        took("phases 11, 12 (flash with sinks, fused expert MLP kernels)")

        # the serve CLI's own builder, from a config dict
        t0 = time.perf_counter()
        engine = build_engine(ConfigNode(serve_config("bf16")))
        auto = engine.auto
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in auto.model.parameters())
        print(f"model: Llama-3-8B widths, {n_params} params bf16, random init and pool {time.perf_counter() - t0:.1f}s", flush=True)
        serving_bf16 = phase_serving(torch, engine, n=16, shared=8)
        check_engine_healthy(engine, "serving bf16")
        profile_bf16 = phase_profile(torch, engine)
        del engine
        torch.cuda.empty_cache()

        cfg = serve_config("int8")
        engine = ServingEngine(
            auto, ServeConfig.from_dict(cfg["serving"]), GenerationConfig.from_dict(cfg["generation"])
        )
        serving_int8 = phase_serving(torch, engine, n=8, shared=4)
        check_engine_healthy(engine, "serving int8")
        del engine
        torch.cuda.empty_cache()
        phase_fused_vs_gather(torch, auto)
        del auto
        torch.cuda.empty_cache()
        took("phases 4, 5 (serving, decode profile, fused vs gather)")

        training = phase_training(torch)
        phase_flash_vs_sdpa(torch)
        took("phases 6, 7 (Llama training, flash vs sdpa)")
        moe = phase_moe_training(torch)
        phase_ragged_vs_dense(torch)
        took("phases 9, 10 (MoE training, ragged vs dense)")
        gpt_oss = phase_gpt_oss_training(torch)
        phase_fused_vs_ragged(torch)
        took("phases 13, 14 (GPT-OSS training, fused vs ragged)")
        gemma = phase_gemma_training(torch)
        phase_gemma_flash_vs_sdpa(torch)
        took("phases 15, 16 (Gemma 2 training, flash vs sdpa)")
        phase_checkpoint(torch)
        took("phase 17 (checkpoint round trip)")
        t0 = time.perf_counter()
        phase_benchmark(torch, training, moe, gpt_oss, gemma)
        print(f"phase 18 (benchmark llm, four legs): {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        kd = phase_kd(torch, dev)
        print(f"phase 19 (kd llm, Llama-3-8B into Llama-3.2-1B): {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        spec = phase_spec_serving(torch)
        print(f"phase 20 (speculative serving, Qwen3-30B-A3B with a Qwen3-0.6B draft): "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        front = phase_front(torch)
        print(f"phase 21 (serving front and spill tier, Llama-3-8B at {FRONT_LAYERS} layers): "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        traced = phase_traced_front(torch)
        print(f"phase 22 (traced serving, Llama-3-8B at {FRONT_LAYERS} layers): {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        rest = phase_training_rest(torch)
        print(f"phase 23 (Llama-3-8B SFT at 32 layers, the optimizers, rollback): {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        data = phase_data(torch, dev)
        print(f"phase 24 (the data path: corpora, pretrain llm at {DATA_PRETRAIN_LAYERS} layers, packing, resume): "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        obs = phase_observability(torch, dev)
        print(f"phase 25 (telemetry, profiling, goodput, metrics port and guard at {DATA_PRETRAIN_LAYERS} layers): "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        ring = phase_ring(torch, dev)
        parallel = phase_parallel_fsdp(torch, rest)
        print(f"phase 26 (parallelism: FSDP2 at 32 layers under torchrun, the cp = 4 ring, the ring at cp = 1): "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        moon = phase_moonlight(torch, dev)
        print(f"phase 27 (Moonlight-16B-A3B at {MOONLIGHT_TRAIN_LAYERS} layers, K1 at H=192, the experts backends): "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        rest_moe = phase_moe_rest(torch, parallel["expert_fsdp_runs"])
        print(f"phase 28 (tp on the experts, expert_fsdp under FSDP2, muon and adafactor on Moonlight, gpt-oss-20b "
              f"from MXFP4): {time.perf_counter() - t0:.1f}s", flush=True)

        print(f"whole run: {time.perf_counter() - t_start:.1f}s (torch's import, the build and phases 1-28)",
              flush=True)
        line = kernels_line(kernels, serving_bf16, serving_int8, profile_bf16, flash, training, grouped, moe, sinks,
                            fused, gpt_oss, flash_cap, gemma, kd, flash_sass, grouped_ptxas, grouped_sass,
                            fused_ptxas, spec, front, traced, rest, data, ring, parallel, moon, rest_moe)
        splits = sorted({(tuple(v["setmaxnreg_dec"]), tuple(v["setmaxnreg_inc"])) for v in flash_sass.values()})
        print(f"flash_attention register split, read from this build's SASS over {len(flash_sass)} kernels: "
              + "; ".join(f"producer warpgroup setmaxnreg.dec {list(d)}, consumers setmaxnreg.inc {list(i)}"
                          for d, i in splits), flush=True)
        print(json.dumps(line), flush=True)
        print(card_line(), flush=True)
    except Exception:
        traceback.print_exc()
        fail("a phase failed (traceback above)")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]
                          [--phases dryrun,kernels,parity,moe,gpt3,
                                    families,train,train_mesh,tp,serve,
                                    dense,tiers,disagg]

Phases (dryrun, kernels, parity, moe, gpt3, families, train, train_mesh,
tp, serve, dense, tiers and disagg by default):

1. print the card (``nvidia-smi`` name and power limit), build every CUDA
   kernel of the port from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once) and print each kernel's registers, shared
   memory and spills as ``ptxas -v`` reports them;
1b. ``dryrun`` (first, while the card's segments are empty): the dry
   run's predictions (``repro_torch.launch.dryrun``: the step traced on
   fake tensors) held to the card's own allocator, Qwen2.5-14B at full
   width and the serve phase's depth: for the serving workload's decode
   step (batch 4, max_seq 384) and one 2048-token prefill, the predicted
   argument bytes equal to the rise of ``memory_allocated()`` across
   making them, and the predicted transient within max(10 %, 1 MiB) of
   the measured one (the second of two steps); with the weights paged,
   the device bytes equal too and the host bytes equal to the ledger's
   remote tier; the resident / paged ratio printed, and the dry run's
   flops and bytes of the decode step at 48 layers and at this depth with
   the least time they allow (printed, and after the serve phase beside
   its replayed step).  In the tp phase's m = 2 ranks, each rank's tally
   of a row-parallel decode step and an admission's prefill must equal
   the dry run's shape-only tally of the same step;
2. ``kernels``: run each kernel against its plain PyTorch version on the
   card at the serving path's shapes, within a stated tolerance — K1 over
   bf16/fp32 pools and, scaled, over int8 and fp8_e4m3 pools, at the
   kernels phase's and the serving run's lengths (two launches must give
   the same bits, a seq_len 0 slot exactly its v0, and a slot's bits must
   not move when the other slots change), at Qwen2.5-14B's G = 5 and at
   G = 12 and 16 (d = 128, and 256) over bf16 and int8 pools, at
   granite-moe-3b-a800m's G = 3, d = 64 over bf16 and int8, and at the
   MHA models' G = 1: gpt3-175b's 96 kv heads at d = 128 and
   minicpm-2b's 36 at d = 64 (timed, as G = 12 and 16 are), each
   element and each output row (against its largest value) within
   tolerance; K2 on the
   route ``plan`` picks (wgmma for bf16, mma for fp32, for bf16 views
   with a head stride TMA cannot describe -- every case again as such a
   view -- and for G > 64) at d = 32, 64, 128 and 256, G = 1 (96/96
   heads at d = 128,
   36/36 at d = 64, both also timed at an 8-token admission), windows
   (some skipping whole key
   tiles), kv_valid padding and Sq = Sk up to 2048, the families
   phase's shapes (whisper-base's encoder at Sq = Sk = 1500 and its
   cross-attention at Sq = 8, Sk = 1500, non-causal, and its causal
   8-token self-attention, 8/8 heads at d = 64, batch 4;
   recurrentgemma-9b's admission and 2100-token prompt, 16/1 at d = 256
   under a window of 2048; all timed, SDPA given the window as a
   boolean mask), each element and each
   row (against its largest value) within tolerance, two launches giving
   the same bits, and suffix rows at q_offset 48, 200 and 130 (with and
   without a window) bit-identical to the unshared rows (bf16 on wgmma,
   fp32 on mma); K3
   (``ops.matmul``, each of its four routes as ``plan`` picks them:
   Qwen2.5-14B's up- and
   down-projections at decode and prefill widths, an unaligned view of
   each width, the reference bench's fp32 shape, ragged shapes, and the
   realign route at every base offset of 0-7 elements of x and of w, at
   odd and even row strides, with ragged K and N; two launches must give
   the same bits), K4 (``ops.accumulate``) and the expert gather (bit
   for bit against ``index_select`` on the host bank plus
   ``index_copy_``, packed into min(N, E) + 1 rows through the moe path's
   slot map over granite's banks in mapped pinned host memory and on the
   card, every and no expert routed, and through the identity slot map
   into buffers of the bank's shape, a ragged byte-wise bank among them;
   its byte counter equal to the routed rows' bytes; a warm call
   returning while ~50 ms of queued sleep still runs; timed in turns
   with one ``copy_`` of the same bytes) — and time the kernel and one
   library call (timed only) by replaying a CUDA graph of 50 calls
   over inputs rotated past the 50 MB L2 (device time, without the host's
   launch overhead), and the plain version eagerly; then drive K3's and
   K4's path, their wrappers, once at each shape with launch counts reset
   just before, each K3 route reached;
3. ``parity``: serve a smoke-size fp32 model on the card and on the CPU
   (plain versions) and hold their tokens and logits together, greedy
   and, over int8 pools, at temperature 0.7; the same for a smoke-size
   MoE (served resident on both, and expert-paged on the card: the
   card's resident tokens), a VLM (prefill with patches, then four
   decode steps: logits within 1e-3), and the dense configs qwen3-14b,
   minicpm-2b (G = 1 kept), starcoder2-15b and gpt3-175b (G = 1 kept)
   over pools and qwen2.5-14b with a window of 8 and with ``kv_quant``
   over the dense slab (first-8 tokens, logits within 1e-3; K1 never
   over the slab), and the other families: recurrentgemma-9b reduced to
   one (rec, rec, att) group and a tail of two rec blocks (window 8) and
   xlstm-125m served over their slab (first-8 tokens, prefill logits
   within 1e-3), whisper-base's ``prefill`` with frames and 7 greedy
   decode steps (the tokens equal, prefill logits within 1e-3); and the
   training loss and gradients of one batch for each family's fp32 smoke
   model (dense, MoE, VLM with patches, hybrid, xLSTM, whisper with
   frames), the card against the CPU: the loss within 1e-4, every
   gradient leaf within 1e-3 of its largest magnitude (floored at 1e-3
   of the tree's largest), K2 on its mma route only;
4. ``moe``: serve granite-moe-3b-a800m at its published widths and full
   depth (32 layers, d 1536, 24/8 heads, 40 experts top-8 of d_ff 512,
   tp=1, random bf16 weights) on the serve phase's four 8-token prompts
   (64 new tokens, batch 4, block 32, max_seq 384, page 16, seed 0),
   before the Qwen weights exist: resident over bf16 pools (greedy and
   0.7) and int8 pools (0.7); then the expert banks moved to mapped
   pinned host memory (``page_experts``): greedy and 0.7 with the layer
   pager off, greedy with it on, each with the resident run's tokens.
   Every run: K1 32 times a decode step, K2 32 times an admission on the
   wgmma route; expert-paged, the gather once a layer a step and an
   admission, its counted bytes equal to the routed experts x 4,718,592,
   at most min(B k, E) experts routed in one gather (device counters),
   every gather on the route ``plan`` gives the placed banks, the
   staging alive at a decode step's gathers equal to the ledger's live
   ``expert_weights`` line, (min(B k, E) + 1) rows a bank, at batch 4
   and in a batch-1 run, the most staging alive equal to its capacity
   line, and one decode step asking for no host sync
   (``set_sync_debug_mode``).  It logs whether a decode step's packed
   dispatch gives the resident dispatch's bits, and prints tok/s, ms a
   step, peak device memory resident against expert-paged, the bytes at
   rest, the experts staged a layer a step, the staging alive and the
   staged bytes' rate;
4b. ``gpt3``: serve gpt3-175b at its published widths (d 12288, 96/96
   heads, MHA: G = 1, d_ff 32768, vocab 50257) and 8 of its 96 layers
   (REDUCED depth: 29.0 GB of bf16 layers and 2.47 GB of embedding and
   head; the whole model is 348 GB), tp=1, random bf16 weights, after
   the moe phase and before the Qwen weights exist, on the serve phase's
   four 8-token prompts (32 new tokens, batch 4, block 32, max_seq 384,
   page 16, seed 0): resident greedy and at 0.7, then greedy with the
   layers paged from pinned host memory by the Tensor Prefetcher (the
   paper's case: GPT-3's weights in remote memory) with the resident
   run's tokens; K1 once a layer a decode step at G = 1, K2 once a layer
   an admission on the wgmma route, every layer fetched once a step and
   an admission.  It prints the host's MemTotal, tok/s, ms a step and
   peak device memory beside the floors (a step's bytes over 3.35 TB/s
   resident, the layers over 64 GB/s paged);
4c. ``families``: the hybrid, ssm and encdec families at full width,
   tp=1, random weights from a seed, after the gpt3 phase and before the
   Qwen weights exist, each freeing its weights when done.
   recurrentgemma-9b at full width and 14 of its 38 layers
   (``FAMILIES_RG_LAYERS``: 4 (rec, rec, att) groups and its 2-rec tail,
   of 12 groups; d 4096, 16/1 heads, d_head 256, d_ff 12288, vocab
   256000) through ``BatchedServer`` over its slab of recurrent
   state and attention windows, on the serve phase's four 8-token
   prompts (32 new tokens, batch 4, block 32, max_seq 384, seed 0):
   greedy and at 0.7, K1 never, K2 once an att layer an admission on
   wgmma at d = 256, the greedy tokens held to a model-level
   ``prefill`` + ``decode_step`` loop at batch 1 (first-8 >= 0.75,
   bit-equality logged); one 2100-token prompt at batch 1 (max_seq
   2200, 16 new tokens: its 2048 window slots roll), held the same way;
   then greedy with the 12 groups in pinned host memory, streamed a group
   at a time by the Tensor Prefetcher (lookahead 1; tail, embedding and
   head resident): the resident tokens, every group fetched once a step
   and once an admission; then ``offload_kv`` on the same placed groups
   (16 new tokens, block 16): the group caches at rest in pinned host
   memory, paged a group at a time beside the weights, the resident
   run's first 16 tokens bit for bit, 12 group slices paged in and
   written back a decode step (``offload_gates``).  xlstm-125m (12
   layers (m, m, m, s) x 3, d 768, 4 heads) through ``BatchedServer``:
   bf16 greedy and at 0.7 (no kernel launches), each again with
   ``offload_kv`` and paged groups under the same gates, then fp32 on
   the card and on the CPU (prefill logits within 1e-3, first-8
   equal).  whisper-base (6 + 6 layers, d
   512, 8/8 heads, 1500 frames) at the model level, as in the reference
   (no server path): seeded random frames (4, 1500, 512), ``prefill`` of
   the four prompts and 31 greedy ``decode_step``s in bf16, K2 18 times
   a prefill (6 encoder launches at Sq = Sk = 1500, 6 causal, 6 cross at
   Sq = 8, Sk = 1500) on wgmma at d = 64 and none a step, then the same
   with ``offload_kv`` and the decoder's layers paged (the self and
   cross KV at rest in pinned host memory, the prefill one window pass,
   the cross KV never written back; the resident tokens); fp32 card
   against CPU on two prompts (prefill logits within 1e-3, first 8
   tokens equal).  It prints ms a step, tok/s, peak device memory, a
   slot's slab bytes (recurrent state beside the windows, against
   Qwen2.5-14B's KV), the paged run's host-to-device rate beside its
   PCIe floor, and the phase's time;
4d. ``train``: training, after the families phase and before the Qwen
   weights exist.  Gate 1: the attention's gradients -- K2's forward under
   autograd with the plain backward -- against torch autograd through
   the plain version in fp32 on the same inputs, at minicpm-2b's
   training shape (B 4, S 1024, 36/36 heads at d 64, causal), Qwen's GQA
   (40/8 at d 128, S 1024), recurrentgemma-9b's windowed layer (B 1, S
   2100, 16/1 at d 256, window 2048) and whisper-base's cross-attention
   (B 4, Sq 64, Sk 1500, 8/8 at d 64, non-causal), in fp32 (1e-4) and
   bf16 (3e-2): K2's output each element and each row against the row's
   largest |plain|, dQ, dK and dV each element against its row's largest
   |want|; K2's forward timed beside the plain forward and SDPA's (a kernels-JSON
   row each), the plain backward beside SDPA's backward, and forward +
   backward beside SDPA's.  Gate 2: minicpm-2b at full width, 2 of its 40
   layers, fp32, a batch of 2 x 128 tokens: the loss (1e-4) and every
   gradient leaf (1e-3 of its largest magnitude), the card against the
   CPU.  Gate 4: minicpm-2b at full width, 4 of 40 layers, bf16, 5 steps
   through ``FaultTolerantLoop`` (async checkpoints every 2 steps into a
   temporary directory, one step raising at step 3): the final params
   equal an uninterrupted run's bit for bit.  Gate 3: minicpm-2b at full
   width and depth (40 layers, d 2304, 36/36 heads at d 64, d_ff 5760,
   vocab 122753 tied; tp=1, random bf16 weights, fp32 moments), 6 steps
   of ``make_train_step`` on one seeded ``SyntheticLM`` batch of 4 x 1024
   tokens, accum_steps 2, WSD, remat on: every loss finite, the last
   below the first, and K2 160 times a step on wgmma (40 layers x 2
   microbatches x the forward and its remat recompute), counts reset
   just before the run and read just after.  It prints ms a step (the
   median of steps 2-6), tokens/s and peak device memory;
4d2. ``train_mesh``: training over a (data 2, model 2) mesh of 4 ranks
   on the one card (``make_train_step(model, tcfg, mesh)``: params
   row-parallel by ``param_specs``, the batch and the ZeRO-1 moments over
   "data", each group of ranks with its own slice of one shared region,
   every collective the TAB's collective kernel), minicpm-2b at full width
   (tp=2).  Gate A, the fp32 witness (2 of 40 layers, one step of 4 x
   1024 tokens, accum 2) against the one-card step on the same params and
   batch: the loss within 1e-5 and grad_norm within 1e-4 relative, every
   gathered gradient leaf within 1e-4 of its largest magnitude (floored
   at 1e-3 of the tree's largest) or twice the gap of one card against
   itself over 4 microbatches (measured first: the tied embedding's is
   ~1e-4); K2 8 times on mma on every rank.  Gate B (bf16 weights, fp32
   moments, 4 layers, 3 steps, WSD): each step's loss within 0.05 of one
   card's loss at the same params (the mesh's, gathered before the
   step; one card's own run is printed beside it, not held: bf16 Adam
   steps part two valid orders by up to ~0.7 at full width), the two
   data replicas of each model shard bit-equal after every step, K2 16
   times a step on every rank (4 layers x 2 microbatches x the forward
   and its remat recompute) and TAB collectives on every rank.  The
   ZeRO-1 witness: one update over the mesh (fp32 reduce-scatter, the
   shard's update, the bf16 all-gather) of the mesh's gradients, scaled
   below the clip, gives one card's AdamW params and moments bit for
   bit.  Gate C: a rank's argument bytes (params, moments, batch rows)
   equal to the dry run's prediction of the same step, to the byte; the
   measured peak printed beside the predicted one.  It prints ms a step
   per rank, each step's collectives by axis and kind (transfers, bytes)
   and ``wait_s``, and the TAB collective at the phase's shapes (K4 rows:
   an fp32 gradient round and a bf16 param round over the data axis, the
   model axis's activation all-reduce in bf16 and fp32, timed);
4e. ``tp``: tensor-parallel serving on the one card, after the train
   phase and before the serve phase's weights exist.  Qwen2.5-14B at
   full width and 12 of its 48 layers (``TP_LAYERS``; random bf16
   weights from a seed, tp=1 config), bf16 pools, the serve phase's four
   8-token prompts (24 new tokens, batch 4, blocks of 8, max_seq 384,
   page 16): served by this process (eager), then by m = 2 and m = 4 ranks
   (``repro_torch.launch.mesh.spawn``; the kernels built before, the
   ranks only load them) over one CUDA region the ranks share by IPC
   (``SharedRegionTransport``), ``BatchedServer(mesh=
   make_serving_mesh(model=m))`` on each rank over the weights this
   process shares by IPC (each rank copies its shard): over the
   region's flags notice (the default: every collective one launch of
   the TAB's collective, which writes the slot, publishes the rank's
   arrival, waits for its peers' in device memory and sums or gathers;
   the decode blocks captured and replayed as CUDA graphs), and again
   over its barrier notice (a stream sync and a gloo barrier a
   collective, K4 the accumulate; eager), whose bf16 tokens the flags'
   must equal bit for bit.  After each flags run every rank replays its
   last captured block and runs one block eagerly over the same
   buffers, timed, and rank 0 traces one more replay (the TAB kernel's
   share of the block's device time, ``tp_replay``).  Gates on every
   rank: the TAB's sums launched (replays counted), K1 once a layer a
   step, K2 on wgmma, pool bytes x m = one card's, ``model_shards`` and
   the ledger's ``shards`` = m, the graph route over the flags (a block
   replayed) and the eager route over the barrier, the embedding
   bit-equal; the greedy tokens bit-equal to one card's, or else the
   fp32 witness (the same weights in fp32, 16 new tokens, served by one
   card and by the ranks: the first-8 rule and the prompts'
   last-position logits within 1e-2).  It prints per rank the ms a step
   over both notices, the barrier's share in its notice, peak device
   memory, the collectives and bytes on the ``"model"`` axis issued
   from Python, each layer's max |d| against one card's in bf16 and in
   fp32, and whether layer 0's column-sharded products equal the full
   product's columns (``tp_products``).  The m = 2 ranks then serve
   the memory tiers and the request lifecycle (``TP_RUNS``, at the first
   6 of the 12 layers: ``TP_LIFE_LAYERS``), each run held to the same
   mesh's resident monolithic run: paged weights (each rank packs its
   2.23 GB shard of the 6 layers into pinned host memory
   and pages it through its own Tensor Prefetcher), ``offload_kv`` over
   the pools and over the slab (16 new tokens, blocks of 16), preemption
   and cold parking at 0.7 over a pool of 7 pages (32 tokens), and
   disaggregated prefill (chunks of 16: the 40-token prompt pair in four
   chunks; 16 tokens), every run in blocks of 16.  Gates on every rank: tokens bit-
   equal to the resident run's (or, where bf16 parts, the fp32 witness
   of both runs bit-equal), K1 once a layer a step over pools, K2 and K4
   launched (the TAB's collective), nothing degraded, the graph route
   unless the run pages (then eager), weight fetches = layers x passes
   and the ledger's remote ``layer_weights`` = the rank's shard, the KV
   window's
   moves, preemptions resumed, parks promoted, stash and handoff bytes
   whole pages of the rank's KV heads.  It prints per run ms a step,
   the notice's share, peak device memory (the rank's own allocations),
   pinned bytes, the weights' copy rate, stash and handoff bytes and the
   host's MemAvailable.  Row-parallel TP (``BatchedServer(...,
   deterministic=False)``: every output projection by its contraction
   rows, the ranks' partial products summed by the TAB's collective on
   the shared region, on every layer): the m = 2 and m = 4 ranks also
   serve the greedy run that way over both notices (and its fp32
   witness), the m = 2 ranks the runs of
   ``TP_ROWPAR_RUNS`` (resident twice, paged weights, ``offload_kv``
   pools, disaggregated against monolithic), each held bit for bit to
   the same mesh's resident run, the greedy run to one card by the first-8
   rule (first-8 >= 0.75 and the logits within atol 0.1, rtol 0.02) or
   else its fp32 witness; gates: the TAB's sums at least 2 x layers + 1
   a step, each rank's weight bytes its ``param_specs`` shard (the
   all-gather runs': their ``serving_param_specs`` shard), the flags'
   tokens bit-equal to the barrier's.  Then one spawn of 2
   ranks serves recurrentgemma-9b (its first pattern period and tail: 5
   of 38 layers, tp=2 so its one KV head is replicated to each rank),
   xlstm-125m and whisper-base (with its frames) row-parallel over the
   slab, in turn, 4 prompts of 8 tokens, 16 greedy tokens in blocks of
   8 (the second block replayed), against
   this process's one-card runs (bf16 by the first-8 rule, whisper's logits
   within its F4 bound 0.25, or else the fp32 witness), with the same
   gates, on the graph route.  Last, the TAB's collective against its
   plain version (the same protocol in one thread a rank over host
   memory; ``check_tab_kernel``) in this process, m simulated ranks on
   m streams at once, at ``TAB_SHAPES`` (each mesh's decode all-reduce,
   largest partial and logits gather) and at the largest all-reduce and
   all-gather each mesh and family issued: a gather bit-equal, a sum
   within one bf16 ulp; timed (a round of the m kernels from a replayed
   graph), beside its plain version and ``torch.sum`` / ``torch.stack``.
   ``--phases notice`` runs only those checks at ``TAB_SHAPES`` and the
   notice probe (``tab_probe``: a (4, 5120) all-reduce timed across the
   ranks eager over the flags, replayed from a graph of 26, and over the
   barrier).  Every rank runs on the same card, so no NCCL path
   (``ProcessGroupTransport`` on cards of their own) is exercised
   here;
5. ``serve``: serve Qwen2.5-14B at its published widths and 8 of its 48
   layers (``SERVE_LAYERS``, ``--layers``: the depth of the serve, dense,
   tiers and disagg phases, cut to keep the default run inside its time;
   tp=1, random bf16 weights from a seeded torch.Generator, made once
   and shared by those phases) through
   ``BatchedServer`` — four 8-token prompts plus a prefix-sharing pair, 64
   new tokens each, block 32, max_seq 384, page 16 — over bf16, int8 and
   fp8_e4m3 pools, each greedy and at temperature 0.7 (seed 0), with
   kernel launch counts reset just before each timed run and read just
   after (K1 must run once per layer per decode step); each
   configuration is served again without prefix caching and once more
   with it, and all three runs must emit the same tokens; every prefill
   must take K2's wgmma route (the parity phase's fp32 model its mma
   route);
   then, with the first 24 (at most) of the same weights
   (``SERVE_PAGED_LAYERS``) moved to pinned host memory and paged back layer by layer by the
   Tensor Prefetcher (lookahead 1), bf16 greedy once more: the same
   tokens as a resident run at that depth, K1 once a layer a step, every
   layer fetched once a step and once an admission; it prints
   tok/s, peak device memory, the ledger's window beside two layers'
   bytes, the pinned bytes and the host-to-device rate;
5b. ``dense``: Qwen2.5-14B at full width and the serve phase's depth
   (its weights) over the dense per-slot slab, ``BatchedServer(paged=False)``,
   on the serve phase's four prompts (64 new tokens): bf16 greedy and at
   0.7, ``kv_quant`` greedy; K1 never launches, K2 once a layer an
   admission.  K1 and its plain version round differently, and random
   layers amplify that past the first-8 rule (0.5 in bf16 at 48), so
   the slab is held: in bf16 and int8 to the paged runs read through
   K1's plain version, whose arithmetic its read shares (first-8 match
   rate >= 0.75; one decode step from the same stored KV within a max
   |dlogit| of 1e-2); ``kv_quant``'s prefill to the bf16 slab's logits
   and ``kv_quantize`` of its values, bit for bit, and its first tokens
   to the bf16 run's; and, with the same weights converted to fp32, to
   K1 itself (the first-8 rule and the 1e-2 step bound), beside K1 against
   its plain version by depth in bf16 and fp32 (a rounding gap shrinks
   with the unit); timed in turns with a paged bf16 run, it prints ms a
   step, tok/s, the slab's bytes beside the paged pool's peak bytes and
   its fragmentation one block in, and peak device memory.  Then
   ``offload_kv`` over the slab with paged weights at the first 6
   layers (``DENSE_OFFLOAD_LAYERS``; ``check_dense_offload``; 8 new
   tokens, block 8): bf16 and
   ``kv_quant``, greedy and at 0.7, each the resident slab's tokens at
   that depth bit for bit, the slab's leaves in pinned host memory and
   none on the card, 12 slices paged in and written back a decode step,
   K1 never, K2 once a layer an admission; timed in turns with the same
   paged weights serving the slab from device memory, it prints ms a
   step, peak device memory, the slab at rest beside the window and the
   link's rates;
6. ``tiers``: KV across the memory tiers, Qwen2.5-14B at the serve
   phase's depth (its weights), on the serve phase's four 8-token prompts
   (64 new tokens, block 32, max_seq 384, page 16, seed 0):
   preemption -- a pool of 13 pages (12 usable against four requests of
   5 worst-case pages) over bf16, int8 and fp8_e4m3 pools, greedy and at
   temperature 0.7: the tokens must equal an uncontended run's (the
   serve phase's, when it ran), at least one preemption,
   every victim resumed; preemption mid-decode -- the pool run dry after
   the first block (``FaultPlan(exhaust_at_block=1)``), bf16 greedy and
   fp8_e4m3 at 0.7: victims stash 3 pages each that decode wrote, the
   same tokens; cold parking -- stashes straight
   to the cold tier (``cold_park_after_blocks=0``, the remote tier's
   high-water mark flat through every swap-out) and parked by age (1),
   bf16 greedy, every park promoted back, the same tokens; ``offload_kv``
   at the first 6 layers at most (``OFFLOAD_LAYERS``)
   -- the weights paged from pinned host memory and the KV pools at rest
   there too, paged a layer at a time: the tokens of a resident run at
   that depth, nothing
   degraded, every layer's pool slice paged in and written back once a
   step and once an admission, timed against the same placed weights
   serving with the pools in device memory (paged, offload, offload,
   paged), and once more with the pool run dry mid-decode (preemption
   from pools at rest, the same tokens).  In every run K1 runs once a layer a
   decode step and K2 once a layer an admission.  It prints the stash
   bytes per tier, the measured swap-out, swap-in, park and promote rates
   (bytes over each transfer's wall time) beside the ledger's modeled
   seconds (the paper's ``DEFAULT_TIER_LINKS``), where a swap's time goes
   (a new registered or pageable buffer, each copy, at 1 and 24 pages),
   and the offload run's tok/s, peak device memory and KV window bytes
   against the resident pool's bytes;
7. ``disagg``: disaggregated prefill and the request lifecycle,
   Qwen2.5-14B at 6 of its 48 layers (the first layers of the serving
   phases' weights: ``DISAGG_LAYERS``), on
   the serving benchmark's interference
   traffic (batch 4, block 32, max_seq 384, page 16, seed 0: four 8-token
   prompts with 32, 64, 96 and 96 new tokens and two 128-token prompts
   with 8, admitted as slots free; ``prefill_chunk_tokens`` 32):
   monolithic against disaggregated over bf16 (greedy and 0.7), int8
   (0.7) and fp8_e4m3 (greedy), each pair's tokens equal, the decode
   stall at most one block disaggregated and at least three monolithic,
   K2 once a layer a chunk (576 launches disaggregated, 288 monolithic,
   wgmma only); the serve phase's prefix pair through the engine (three
   shared pages adopted as completed chunks, the unshared tokens); chunks
   of 32, 64 and 128 with the long prompts arriving while decode is live
   (the stall within ceil(chunk / block)); a prefill-engine crash before
   its second chunk and a decode-engine crash at an adoption (the
   uncontended tokens after lease reclaim and retry); NaN written into
   one victim's private page after the first block (only it is shed); a
   deadline of one block on a staged prompt (expired, its pages
   reclaimed); ``max_pending=2`` against the burst of six (four
   rejected); a snapshot with one handoff staged and one prefill
   mid-chunk, restored into a new server (the uncontended tokens).  Every
   run audits after each step and ends with every page, handoff and
   stash reclaimed.  It prints ms per decode step (wall, and on the card
   from CUDA events around each decode block), the longest gap between
   two decode blocks on the card, TTFT p50/p99 in blocks, the stage time
   and bytes of a handoff (and of its host copy when a snapshot reads
   it) and the ledger's ``kv_handoff`` peak;
8. ``profile`` (only when named in ``--phases``): with ``train``, one more
   training step of minicpm-2b traced (the device's busy share, device
   time by kind of kernel and the top kernels); with ``serve``, separate
   traced serving runs (bf16 greedy, int8 at temperature 0.7, and bf16
   greedy with paged weights), printing device time by kernel and the
   device's busy share; for paged weights also the copy stream's busy
   time beside the compute's, and how long both ran at once;
9. ``sweep`` (only when named): K3's splitk and wgmma routes timed side by
   side over M = 1 .. 64 at Qwen2.5-14B's MLP shapes, where the planner's
   ``SPLITK_MAX_M`` comes from.

Every resident server decodes through ``make_decode_loop``'s graph
route: one CUDA graph of ``block_size`` steps captured at a key's second
block and replayed after (``repro_torch.runtime.decode_graph``); each
served run's captures stay within its page-table widths (one over the
slab) and its blocks are counted once, replayed or eager
(``capture_bound``), and launch counts include replays.  The moe, gpt3,
families, serve and dense phases also run the decode block on both
routes from one prefilled state (``graph_vs_eager``: four 24-token
prompts, three blocks of 8 steps -- the graph route's warm-up, its
capture and a replay -- a padded page-table delta before the second over
pools): granite-moe-3b-a800m resident, gpt3-175b, recurrentgemma-9b,
xlstm-125m, whisper-base (with its frames), Qwen2.5-14B over bf16, int8
and fp8_e4m3 pools and over the slab (bf16 and ``kv_quant``), greedy and
at 0.7: tokens, valid and poison masks, the final state and every cache
leaf bit-equal, one capture and two replays, the launches of both routes
equal.  The serve phase ends its resident runs with the steady-state
run (``check_steady``: Qwen2.5-14B bf16 greedy, batch 4, block 32, page
16, max_seq 1024, 520-token prompts, 480 new tokens: 15 blocks in one
table width) on both routes, the same tokens, the graph route capturing
once and replaying 14 blocks, printing ms a step, tok/s, captures and
their seconds, the graph pool's bytes and peak device memory; with
``profile`` it also traces one replayed block of a warmed graph-route
server and prints the device's busy share.

The second-to-last line of standard output is a JSON object with each
kernel's numbers, one entry per kernel (variant or route) and timed
shape, ``tiers_launches``, ``disagg_launches``, ``moe_launches``,
``gpt3_launches``, ``dense_launches``, ``families_launches``,
``train_launches``, ``tp_launches`` (the tp phase's: a row at a rank's
shapes, K1 at Hkv 4 and 2, K2 at 20/4 and 10/2 heads, K4 at (2, 4, 5120),
(2, 64, 5120), (4, 4, 5120) and (4, 8, 5120), reads its mesh's ranks,
summed, both modes; a row at the family spawn's rank shapes, K2 at 8/1
heads d 256 and 4/4 d 64, K4 at recurrentgemma-9b's, xlstm-125m's and
whisper-base's partials, reads that spawn's ranks as ``launches`` too;
the others the one-process run; beside ``tp_path``), ``graph_launches`` (the steady-state graph
run's)
and ``graph_replayed_launches`` (those its replays made) beside
``launches`` (a row at granite's shapes, and
the gather's, reads ``launches`` from the moe phase, by route; a row at
gpt3-175b's from the gpt3 phase; at whisper-base's or
recurrentgemma-9b's from the families phase; at minicpm-2b's, and the
train phase's rows at the training shapes, from the train phase's
40-layer run; the train_mesh phase's rows, K2 at a rank's 18/18 heads
and K4 at the phase's shapes, from its ranks' gates A and B, summed; a
row whose instantiation its path never launched reads 0); the last is ``{"ok": true, "device": {...}}``.  Any
failed phase raises, and the script exits non-zero without that line.
It exits non-zero at once when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12          # H100 SXM fp32 on the CUDA cores (no TF32)
#: fp32-accurate products on the tensor cores: 3xTF32, three tf32 products
#: (495 TFLOP/s dense) for each fp32 one -- the bound of K2's and K3's
#: fp32 products; F32_FLOPS_PER_S stays for K4's fp32 adds
TF32X3_FLOPS_PER_S = 495e12 / 3
ROTATE = 16                      # input copies cycled past the L2 in timing
BF16_TOL = 3e-2   # both versions accumulate in fp32 and round once to bf16:
                  # they may land one bf16 ulp apart (2^-7 |o| < 0.03 at |o| < 4)
F32_TOL = 1e-4    # fp32: summation order only


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its
    (mangled) name, registers, shared memory and spills; warnings and
    errors as they are."""
    out, name, spill = [], "", ""
    for line in report.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "spill" in line:
            spill = line
        elif "Used" in line and "registers" in line:
            out.append(f"{name[:110]}: {line.split(':', 1)[-1].strip()}; "
                       f"{spill}")
        elif "warning" in line or "error" in line:
            out.append(line)
    return out


_SIDE = None


def time_ms(torch, fn, inputs, iters: int = 50, graph: bool = True) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``inputs``
    (so each call finds its operands out of L2), after warm-up.  With
    ``graph`` the calls are captured once in a CUDA graph and the replay
    is timed: the device's time for the work, without the host's launch
    overhead (which exceeds a small kernel's own time); without it, the
    calls are issued eagerly and the host's time counts where it is the
    longer."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if not graph:
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    global _SIDE
    if _SIDE is None:       # one warm-up stream: cuBLAS keeps a workspace
        _SIDE = torch.cuda.Stream()   # for every stream it has run on
    g = torch.cuda.CUDAGraph()
    side = _SIDE
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs[0])
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    g.replay()
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del g
    return ms


def bound(nbytes: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

#: K1's timed shapes: the kernels phase's (an idle slot, up to max_seq - 1)
#: and the serving run's (lengths of its four 8-token prompts a few blocks
#: into decode); both over a 24-page table, as the serve phase's
K1_LENS = ([0, 71, 135, 383], [8, 40, 72, 72])
#: K1's groups past 8 query rows a kv head (Hkv, G, d, timed, the path
#: its rows read launches from): starcoder2-15b's 48/4 heads, qwen3-235b's
#: 64/4 and recurrentgemma-9b's 16/1 at d = 256 (the 16-row
#: instantiation), over bf16 and int8 pools; the MHA models'; and the tp
#: phase's ranks' Qwen2.5-14B heads, 4 and 2 of its 8 KV heads a rank at
#: m = 2 and 4
K1_GROUPS = ((4, 12, 128, True, "serve"), (4, 16, 128, True, "serve"),
             (1, 16, 256, False, "serve"), (36, 1, 64, True, "kernels"),
             (96, 1, 128, True, "gpt3"), (4, 5, 128, True, "tp2"),
             (2, 5, 128, True, "tp4"))


def check_paged(torch, card: str, results: dict, kv: str | None = None,
                hkv: int = 8, g: int = 5, d: int = 128,
                timed: bool = True, phase: str = "serve") -> None:
    """K1 against its plain version at Hkv kv heads of G query rows and
    head dim d (Qwen2.5-14B's 8 x 5 x 128 by default), each element and
    each output row (one slot, head and query row, against its own
    largest |plain| value) within the tolerance: outputs over a few
    hundred near-uniform positions are ~0.05-0.1, where the absolute
    bound alone would let a dropped page pass.  ``kv`` None:
    bf16/fp32 pools in q's dtype; "int8" / "fp8_e4m3": the scaled
    variant, one-byte pools with bf16 scales made by the port's
    quantizer, q and extra_kv in bf16 or fp32.  Also: a seq_len 0 slot is
    exactly its v0, two launches give the same bits, and a slot's bits do
    not move when the other slots' lengths, pages and page contents
    change (the split grid depends only on the table's width).  With
    ``timed`` the kernel, its plain version and SDPA are timed at both
    length sets, their rows read launches from ``phase``'s path."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention.ref import (byte_view,
                                                         gather_pages,
                                                         gather_scales,
                                                         paged_attention_ref)
    from repro_torch.models.base import ModelConfig
    from repro_torch.models.layers import kv_dequantize, kv_pool_quantize
    B, HKV, G, D, PAGE, N = 4, hkv, g, d, 16, 24
    P = 1 + B * N
    gen = torch.Generator(device="cuda").manual_seed(1)
    name = "paged_attention" if kv is None else f"paged_attention_{kv}"

    def inputs(dtype, lens_l=K1_LENS[0]):
        """(q, k_pages, v_pages, table, lens, k0, v0, k_scales, v_scales)."""
        kp = torch.randn((P, PAGE, HKV, D), generator=gen, device="cuda")
        vp = torch.randn((P, PAGE, HKV, D), generator=gen, device="cuda")
        q = (torch.randn((B, HKV, G, D), generator=gen, device="cuda") * 0.3
             ).to(dtype)
        k0 = (torch.randn((B, HKV, D), generator=gen, device="cuda") * 0.3
              ).to(dtype)
        v0 = torch.randn((B, HKV, D), generator=gen, device="cuda").to(dtype)
        perm = torch.randperm(P - 1, generator=gen, device="cuda")[:B * N] + 1
        table = perm.reshape(B, N).to(torch.int32)
        if lens_l[0] == 0:
            table[0] = 0              # the idle slot maps the null page
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        if kv is None:
            return q, kp.to(dtype), vp.to(dtype), table, lens, k0, v0, None, \
                None
        qdt, qmax = ModelConfig.KV_DTYPES[kv]
        (kq, ks), (vq, vs) = (kv_pool_quantize(x, qdt, qmax) for x in (kp, vp))
        return q, kq, vq, table, lens, k0, v0, ks, vs

    def kernel(q, kp, vp, t, l, a, b, ks, vs, extra=True):
        return K.paged_attention(q, kp, vp, t, l,
                                 extra_kv=(a, b) if extra else None,
                                 k_scales=ks, v_scales=vs)

    def plain(q, kp, vp, t, l, a, b, ks, vs, extra=True):
        return paged_attention_ref(q, kp, vp, t, l,
                                   extra_kv=(a, b) if extra else None,
                                   k_scales=ks, v_scales=vs)

    errs = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for lens_l in K1_LENS:
            args = inputs(dtype, lens_l)
            for extra in (True, False):
                got = kernel(*args, extra=extra)
                again = kernel(*args, extra=extra)
                want = plain(*args, extra=extra)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                rel = (diff.amax(-1) / want.float().abs().amax(-1).clamp_min(
                    1e-30)).max().item()
                case = (f"{name} Hkv={HKV} G={G} d={D} q={str(dtype)[6:]} "
                        f"lens={lens_l} extra={extra}")
                log(f"K1 {case}: max_abs_err {err:.3e}, largest row error "
                    f"over the row's max |plain| {rel:.3e} (bound {tol:g} "
                    f"for both)")
                if not (err <= tol and rel <= tol):
                    raise AssertionError(f"K1 {case}: {err}, {rel} > {tol}")
                if not torch.equal(got, again):
                    raise AssertionError(f"K1 {case}: two launches differ")
                key = (dtype, tuple(lens_l))
                errs[key] = max(errs.get(key, 0.0), err)
                # a seq_len == 0 slot comes out as exactly its v0
                v0 = args[6]
                if extra and lens_l[0] == 0 and not torch.equal(
                        got[0], v0[0][:, None, :].expand(HKV, G, D)):
                    raise AssertionError(f"K1 {case}: seq_len 0 slot is not v0")
    log(f"K1 {name} Hkv={HKV} G={G} d={D}: two launches bit-identical; "
        f"seq_len 0 slot exactly v0")

    # slot independence: slot 2's bits with the other slots changed
    args = list(inputs(torch.bfloat16))
    before = kernel(*args)
    other = inputs(torch.bfloat16, [5, 200, 0, 17])
    mine = args[3][2].clone()
    for i in (0, 1, 3):
        args[3][i] = other[3][i]
        args[4][i] = other[4][i]
        keep = torch.isin(args[3][i].long(), mine.long(), invert=True)
        pages = args[3][i].long()[keep]
        for j in (1, 2, 7, 8):          # pools (fp8 as bytes) and scales
            if args[j] is not None:
                byte_view(args[j])[pages] = byte_view(other[j])[pages]
    after = kernel(*args)
    torch.cuda.synchronize()
    if not torch.equal(before[2], after[2]):
        raise AssertionError(f"K1 {name}: slot 2 moved when the others did")
    log(f"K1 {name} Hkv={HKV} G={G} d={D}: slot 2 bit-identical with the "
        f"other slots' lengths, pages and page contents changed")
    if not timed:
        return

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for lens_l in K1_LENS:
        # timing at the bf16 decode shape, inputs rotated past the L2
        sets = [inputs(torch.bfloat16, lens_l) for _ in range(ROTATE)]
        ms = time_ms(torch, kernel, sets)
        eager_ms = time_ms(torch, kernel, sets, graph=False)
        plain_ms = time_ms(torch, plain, sets, iters=20, graph=False)
        # library yardstick: SDPA over the gathered KV (+ the current
        # column), dequantized to bf16 and GQA-expanded beforehand; only
        # the SDPA call is timed, so it leaves the dequantization out
        lib_sets = []
        for q, kp, vp, t, l, a, b, ks, vs in sets:
            kk, vv = gather_pages(kp, t), gather_pages(vp, t)
            if kv is not None:
                kk = kv_dequantize(kk, gather_scales(ks, t), torch.bfloat16)
                vv = kv_dequantize(vv, gather_scales(vs, t), torch.bfloat16)
            kk = torch.cat([kk, a[:, :, None]], dim=2)
            vv = torch.cat([vv, b[:, :, None]], dim=2)
            S = kk.shape[2]
            mask = torch.arange(S, device="cuda")[None, :] < l[:, None].long()
            mask[:, -1] = True
            lib_sets.append((q.reshape(B, HKV * G, 1, D),
                             kk.repeat_interleave(G, dim=1),
                             vv.repeat_interleave(G, dim=1),
                             mask[:, None, None, :]))
        lib_ms = time_ms(torch, lambda q, k, v, m: sdpa(q, k, v, attn_mask=m),
                         lib_sets)
        live = sum(lens_l)
        el = 2 if kv is None else 1              # pool bytes per element
        nbytes = (2 * B * HKV * G * D * 2                  # q in, out (bf16)
                  + 2 * live * HKV * D * el                # live K and V rows
                  + (0 if kv is None else 2 * live * HKV * 2)   # their scales
                  + 2 * B * HKV * D * 2                    # extra k0, v0
                  + B * N * 4 + B * 4)                     # table, seq_lens
        flops = 4 * sum(n + 1 for n in lens_l) * HKV * G * D
        b_ms, b_by = bound(nbytes, flops)
        shape = (f"B={B} Hkv={HKV} G={G} d={D} page={PAGE} n={N} "
                 f"lens={lens_l}")
        log(f"K1 {name} q=bf16 {shape} [{card}]: kernel {ms:.4f} ms "
            f"(eager, host included: {eager_ms:.4f}), plain {plain_ms:.4f} "
            f"ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of the bound, kernel / sdpa "
            f"{ms / lib_ms:.2f}x")
        rows.append(dict(shape=shape, instance=K.instance(G), phase=phase,
                         max_abs_err=errs[(torch.bfloat16, tuple(lens_l))],
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, eager_ms=eager_ms))
    results.setdefault(name, []).extend(rows)


#: K2's checked cases: (B, Sq, Sk, Hq, Hkv, d, keywords).  Qwen2.5-14B's
#: 40/8 heads at d = 128 (a prompt of 8, 64, 384 and 2048 tokens, a
#: prefix-cached suffix, windows), 24/8 heads at d = 64, a 32-wide head,
#: and recurrentgemma-9b's 16/1 heads at d = 256 with windows and
#: non-causal over kv_valid padding.  The windows of 100 (d = 128, also
#: under a q_offset) and of 256 (d = 256, 2048 tokens) leave whole key
#: tiles below the window of a query tile's first row: both routes skip
#: them.  72 query heads on one kv head (G = 72 > 64) take the mma route
#: in bf16 too.  The families phase's shapes: whisper-base's encoder
#: (non-causal, Sq = Sk = 1500 over 24 key tiles, the last cut at 1500 by
#: kv_valid), its cross-attention (Sq = 8 against the 1500 frames) and
#: causal self-attention (8/8 heads at d = 64, batch 4), and
#: recurrentgemma-9b's admission and 2100-token prompt (16/1 heads at d =
#: 256 under its window of 2048).  The tp phase's family spawn's, a
#: rank's at m = 2: recurrentgemma-9b's admission (8/1 heads at d = 256)
#: and whisper-base's encoder, cross- and self-attention (4/4 heads at d =
#: 64, one request an admission).  The train phase's: minicpm-2b's
#: training shape (batch 4, 1024 causal tokens, 36/36 heads at d = 64,
#: 16 key tiles) and whisper-base's training cross-attention (64 queries
#: against the 1500 frames).  The train_mesh phase's: a rank's of
#: minicpm-2b over (data 2, model 2) (one row of a microbatch, 1024
#: causal tokens, 18/18 heads at d = 64)
FLASH_CASES = ((1, 8, 8, 40, 8, 128, {}), (1, 64, 64, 40, 8, 128, {}),
               (1, 384, 384, 40, 8, 128, {}),
               (1, 2048, 2048, 40, 8, 128, {}),
               (1, 16, 64, 40, 8, 128, {"q_offset": 48}),
               (1, 50, 50, 40, 8, 128, {"window": 13}),
               (1, 300, 300, 40, 8, 128, {"window": 100}),
               (1, 100, 384, 40, 8, 128, {"q_offset": 284, "window": 100}),
               (1, 40, 64, 40, 8, 128, {"causal": False, "kv_valid": 50}),
               (2, 96, 96, 24, 8, 64, {}), (1, 8, 8, 24, 8, 64, {}),
               (1, 70, 70, 8, 8, 32, {}),
               (1, 50, 50, 16, 1, 256, {"window": 13}),
               (1, 40, 64, 16, 1, 256, {"causal": False, "kv_valid": 50}),
               (1, 300, 300, 16, 1, 256, {}),
               (1, 2048, 2048, 16, 1, 256, {}),
               (1, 2048, 2048, 16, 1, 256, {"window": 256}),
               (1, 8, 8, 96, 96, 128, {}), (1, 384, 384, 96, 96, 128, {}),
               (1, 8, 8, 36, 36, 64, {}), (1, 64, 64, 36, 36, 64, {}),
               (1, 50, 50, 36, 36, 64, {"window": 13}),
               (1, 40, 40, 72, 1, 64, {}),
               (4, 1500, 1500, 8, 8, 64, {"causal": False}),
               (4, 8, 1500, 8, 8, 64, {"causal": False}),
               (4, 8, 8, 8, 8, 64, {}),
               (1, 8, 8, 16, 1, 256, {"window": 2048}),
               (1, 2100, 2100, 16, 1, 256, {"window": 2048}),
               (4, 1024, 1024, 36, 36, 64, {}),
               (4, 64, 1500, 8, 8, 64, {"causal": False}),
               (1, 8, 8, 20, 4, 128, {}), (1, 8, 8, 10, 2, 128, {}),
               (1, 16, 64, 20, 4, 128, {"q_offset": 48}),
               (1, 16, 64, 10, 2, 128, {"q_offset": 48}),
               (1, 8, 8, 8, 1, 256, {"window": 2048}),
               (1, 1500, 1500, 4, 4, 64, {"causal": False}),
               (1, 8, 1500, 4, 4, 64, {"causal": False}),
               (1, 8, 8, 4, 4, 64, {}),
               (1, 1024, 1024, 18, 18, 64, {}))
#: the prefix contract's cases: (Sq = Sk, q_offset, Hq, Hkv, d, window).
#: At 130 a row sits at another place of its query tile than unshared
#: (25 positions a tile at 40/8 heads, 4 at 16/1), and with a window of
#: 100 some query tiles skip a leading key tile that the other launch's
#: tile holding the same row reads (all masked for that row)
FLASH_PREFIX = ((64, 48, 40, 8, 128, 0), (384, 200, 40, 8, 128, 0),
                (384, 130, 40, 8, 128, 0), (384, 130, 40, 8, 128, 100),
                (384, 130, 16, 1, 256, 100))
#: the paths a K2 row's launches are read from, by attention (Hq, Hkv,
#: d): granite-moe-3b-a800m's (moe phase), gpt3-175b's MHA (gpt3 phase),
#: minicpm-2b's MHA (its training, train phase), whisper-base's and
#: recurrentgemma-9b's (families phase), a rank's of Qwen2.5-14B at m = 2
#: and 4 (tp phase, its mesh), of whisper-base and recurrentgemma-9b
#: at m = 2 (tp phase, the family spawn) and of minicpm-2b at m = 2
#: (train_mesh phase); else serve
ATTN_PHASE = {(24, 8, 64): "moe", (96, 96, 128): "gpt3",
              (36, 36, 64): "train", (8, 8, 64): "families",
              (16, 1, 256): "families", (20, 4, 128): "tp2",
              (10, 2, 128): "tp4", (8, 1, 256): "tpfam",
              (4, 4, 64): "tpfam", (18, 18, 64): "train_mesh"}
#: K2's timed shapes (route, dtype, Sq = Sk, Hq, Hkv, d): the main path's
#: route at Qwen2.5-14B's width over four prompt lengths, at
#: granite-moe-3b-a800m's admission (8 tokens, 24/8 heads, d = 64), at
#: MHA (G = 1) admissions of gpt3-175b (96/96, d = 128) and minicpm-2b
#: (36/36, d = 64) and at d = 256; the mma route in fp32 at the width of
#: the parity phase's fp32 model (and of the dense phase's fp32 witness)
#: at 384 and 2048 tokens, and in bf16 over a view of head stride d + 9
#: (not TMA's; the field after d is that padding); the families phase's
#: whisper-base encoder, cross- and self-attention and recurrentgemma-9b's
#: admission and 2100-token prompt, the tp phase's rank shapes (its
#: family spawn's too), and the train_mesh phase's rank shape in bf16
#: (gate B, wgmma) and fp32 (gate A, mma), at the batch and keywords its
#: path gives them (the first and last fields)
FLASH_TIMED = ((1, "wgmma", "bfloat16", 8, 8, 40, 8, 128, 0, {}),
               (1, "wgmma", "bfloat16", 8, 8, 24, 8, 64, 0, {}),
               (1, "wgmma", "bfloat16", 8, 8, 96, 96, 128, 0, {}),
               (1, "wgmma", "bfloat16", 8, 8, 36, 36, 64, 0, {}),
               (1, "wgmma", "bfloat16", 64, 64, 40, 8, 128, 0, {}),
               (1, "wgmma", "bfloat16", 384, 384, 40, 8, 128, 0, {}),
               (1, "wgmma", "bfloat16", 2048, 2048, 40, 8, 128, 0, {}),
               (1, "wgmma", "bfloat16", 2048, 2048, 16, 1, 256, 0, {}),
               (1, "mma", "float32", 384, 384, 40, 8, 128, 0, {}),
               (1, "mma", "float32", 2048, 2048, 40, 8, 128, 0, {}),
               (1, "mma", "bfloat16", 384, 384, 40, 8, 128, 9, {}),
               (4, "wgmma", "bfloat16", 1500, 1500, 8, 8, 64, 0,
                {"causal": False}),
               (4, "wgmma", "bfloat16", 8, 1500, 8, 8, 64, 0,
                {"causal": False}),
               (4, "wgmma", "bfloat16", 8, 8, 8, 8, 64, 0, {}),
               (1, "wgmma", "bfloat16", 8, 8, 16, 1, 256, 0,
                {"window": 2048}),
               (1, "wgmma", "bfloat16", 2100, 2100, 16, 1, 256, 0,
                {"window": 2048}),
               (1, "wgmma", "bfloat16", 8, 8, 20, 4, 128, 0, {}),
               (1, "wgmma", "bfloat16", 8, 8, 10, 2, 128, 0, {}),
               (1, "wgmma", "bfloat16", 8, 8, 8, 1, 256, 0,
                {"window": 2048}),
               (1, "wgmma", "bfloat16", 1500, 1500, 4, 4, 64, 0,
                {"causal": False}),
               (1, "wgmma", "bfloat16", 8, 1500, 4, 4, 64, 0,
                {"causal": False}),
               (1, "wgmma", "bfloat16", 8, 8, 4, 4, 64, 0, {}),
               (1, "wgmma", "bfloat16", 1024, 1024, 18, 18, 64, 0, {}),
               (1, "mma", "float32", 1024, 1024, 18, 18, 64, 0, {}))


def _flash_pairs(torch, sq, sk, causal=True, window=0, q_offset=None,
                 kv_valid=None) -> int:
    """Attended (query, key) pairs of one head: the work the data needs."""
    from repro_torch.kernels.flash_attention.ref import _mask
    q_offset = sk - sq if q_offset is None else q_offset
    kv_valid = sk if kv_valid is None else kv_valid
    return int(_mask(q_offset + torch.arange(sq), torch.arange(sk),
                     causal=causal, window=window, kv_valid=kv_valid
                     ).expand(sq, sk).sum())


def check_flash(torch, card: str, results: dict) -> None:
    """K2 against its plain version, each case in bf16 (tol 3e-2) and
    fp32 (tol 1e-4), launched twice for the same bits.  Every element is
    within tol of the plain version, and every output row (one position,
    one head) within tol times its own largest |plain| value: q, k and v
    are randn, so scores have a std of about 1 and a long row's outputs
    are small (~0.04 at 2048 keys), where an absolute bound alone would
    let a fault in a few key tiles pass.  The route each launch took (its
    launch count) must be the one ``plan`` gives: wgmma for bf16
    (TMA-describable, G <= 64), mma for fp32, for G > 64 and for bf16
    views with a head stride TMA cannot describe (every case is run again
    as such a view).  The prefix contract (``FLASH_PREFIX``): rows
    attended as a suffix at a q_offset are bit-identical to the unshared
    rows, bf16 on wgmma and fp32 on mma.  Then the timed shapes."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(b, sq, sk, hq, hkv, d, dtype, pad=0):
        q = torch.randn((b, sq, hq, d + pad), generator=gen, device="cuda")
        k = torch.randn((b, sk, hkv, d + pad), generator=gen, device="cuda")
        v = torch.randn((b, sk, hkv, d + pad), generator=gen, device="cuda")
        return q.to(dtype)[..., :d], k.to(dtype)[..., :d], v.to(dtype)[..., :d]

    def run(fn, q, k, v, **kw):
        kw.setdefault("causal", True)
        kw.setdefault("window", 0)
        kw.setdefault("q_offset", k.shape[1] - q.shape[1])
        kw.setdefault("kv_valid", k.shape[1])
        return fn(q, k, v, **kw)

    def routed(q, k, v, **kw):
        """(output, the route whose count moved)."""
        before = launch_counts()
        out = run(K.flash_attention, q, k, v, **kw)
        moved = [n for n, c in launch_counts().items() if c != before[n]]
        return out, moved

    errs = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        cases = [(c, 0) for c in FLASH_CASES]
        if dtype == torch.bfloat16:      # head stride d + 9: not TMA's
            cases += [(c, 8 + 1) for c in FLASH_CASES]
        for (b, sq, sk, hq, hkv, d, kw), pad in cases:
            q, k, v = inputs(b, sq, sk, hq, hkv, d, dtype, pad)
            want_route = K.plan(dtype, d, hq // hkv,
                                dtype == torch.bfloat16
                                and K.aligned(q, k, v))
            got, moved = routed(q, k, v, **kw)
            again = run(K.flash_attention, q, k, v, **kw)
            want = run(flash_attention_ref, q, k, v, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            rel = (diff.amax(-1) / want.float().abs().amax(-1).clamp_min(
                1e-30)).max().item()
            name = (f"flash_attention_{want_route} {str(dtype)[6:]} B={b} "
                    f"Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} d={d} {kw}"
                    f"{f' head stride {q.stride(2)}' if pad else ''}")
            same = torch.equal(got, again)
            log(f"K2 {name}: max_abs_err {err:.3e}, largest row error over "
                f"the row's max |plain| {rel:.3e} (bound {tol:g} for both); "
                f"two launches bit-identical: {same}")
            if moved != [f"flash_attention_{want_route}"]:
                raise AssertionError(f"K2 {name}: launched {moved}")
            if not (err <= tol and rel <= tol):
                raise AssertionError(f"K2 {name}: {err}, {rel} > {tol}")
            if not same:
                raise AssertionError(f"K2 {name}: two launches differ")
            key = (b, want_route, str(dtype)[6:], sq, sk, hq, hkv, d, pad,
                   tuple(sorted(kw.items())))
            errs[key] = max(errs.get(key, 0.0), err)
    # the prefix contract: suffix rows with q_offset equal the full rows
    for dtype in (torch.bfloat16, torch.float32):
        for sq, off, hq, hkv, d, window in FLASH_PREFIX:
            q, k, v = inputs(1, sq, sq, hq, hkv, d, dtype)
            full = run(K.flash_attention, q, k, v, window=window)
            part = run(K.flash_attention, q[:, off:], k, v, q_offset=off,
                       window=window)
            torch.cuda.synchronize()
            if not torch.equal(full[:, off:], part):
                raise AssertionError(
                    f"K2 {str(dtype)[6:]}: q_offset={off} rows differ from "
                    f"unshared rows (Sq=Sk={sq} Hq={hq} Hkv={hkv} d={d} "
                    f"window={window})")
    log(f"K2 flash_attention: rows at a q_offset bit-identical to unshared "
        f"rows, bf16 (wgmma) and fp32 (mma), at (Sq=Sk, q_offset, Hq, "
        f"Hkv, d, window) in {FLASH_PREFIX}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    from repro_torch.kernels.flash_attention.ref import _mask
    for b, route, dt, sq, sk, hq, hkv, d, pad, kw in FLASH_TIMED:
        dtype = getattr(torch, dt)
        # a set of ~30 MB or more: four sets still rotate past L2
        big = b * max(sq, sk) >= 2048
        sets = [inputs(b, sq, sk, hq, hkv, d, dtype, pad)
                for _ in range(4 if big else ROTATE)]
        if K.plan(dtype, d, hq // hkv, dtype == torch.bfloat16
                  and K.aligned(*sets[0])) != route:
            raise AssertionError(f"K2 timed {route}: plan disagrees")
        ms = time_ms(torch, lambda q, k, v: run(K.flash_attention, q, k, v,
                                                **kw), sets)
        plain_ms = time_ms(torch, lambda q, k, v: run(
            flash_attention_ref, q, k, v, **kw), sets, iters=1 if big
            else 5, graph=False)
        lib_sets = [(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(
            hq // hkv, dim=1), v.transpose(1, 2).repeat_interleave(
            hq // hkv, dim=1)) for q, k, v in sets]
        causal = kw.get("causal", True)
        if kw.get("window"):
            # SDPA has no window: the same mask, given as a boolean tensor
            mask = _mask(sk - sq + torch.arange(sq, device="cuda"),
                         torch.arange(sk, device="cuda"), causal=causal,
                         window=kw["window"], kv_valid=sk)
            lib_ms = time_ms(torch, lambda q, k, v: sdpa(
                q, k, v, attn_mask=mask), lib_sets)
        else:
            lib_ms = time_ms(torch, lambda q, k, v: sdpa(
                q, k, v, is_causal=causal), lib_sets)
        size = sets[0][0].element_size()
        nbytes = size * b * (2 * sq * hq * d + 2 * sk * hkv * d)  # q,o,k,v
        flops = 4 * d * hq * b * _flash_pairs(torch, sq, sk, **kw)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S if dt ==
                           "bfloat16" else TF32X3_FLOPS_PER_S)
        seqs = f"Sq=Sk={sq}" if sq == sk else f"Sq={sq} Sk={sk}"
        mode = "causal" if causal else "non-causal"
        if kw.get("window"):
            mode += f" window {kw['window']}"
        shape = (f"B={b} {seqs} Hq={hq} Hkv={hkv} d={d} {mode} {dt}"
                 f"{f' head stride {sets[0][0].stride(2)}' if pad else ''}")
        log(f"K2 flash_attention_{route} {shape} [{card}]: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}), {100 * b_ms / ms:.1f}% of the bound, "
            f"kernel / sdpa {ms / lib_ms:.2f}x")
        results.setdefault(f"flash_attention_{route}", []).append(dict(
            shape=shape, instance=K.instance(d, dtype),
            phase=ATTN_PHASE.get((hq, hkv, d), "serve"),
            max_abs_err=errs[(b, route, dt, sq, sk, hq, hkv, d, pad,
                              tuple(sorted(kw.items())))], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))


#: K3's shapes: the reference bench's (benchmarks/kernels_bench.py:29), and
#: Qwen2.5-14B's MLP up-projection (5120 -> 13824) and down-projection
#: (13824 -> 5120) at decode batch 4 and at a 2048-token prefill, w ~
#: randn / sqrt(K); (shape, dtype, w's row padding): a padded w is a view
#: whose row stride TMA cannot describe, so the up-projection with it
#: times the realign route at Qwen width, at prefill and at decode
MATMUL_SHAPES = (((256, 512, 256), "float32", 0),
                 ((4, 5120, 13824), "bfloat16", 0),
                 ((4, 13824, 5120), "bfloat16", 0),
                 ((2048, 5120, 13824), "bfloat16", 0),
                 ((2048, 13824, 5120), "bfloat16", 0),
                 ((2048, 5120, 13824), "bfloat16", 1),
                 ((4, 5120, 13824), "bfloat16", 1))
#: ragged shapes, both dtypes: checked, not timed
MATMUL_RAGGED = (((7, 513, 129), "float32", 0), ((7, 513, 129), "bfloat16", 0))
#: K4's shapes: the reference bench's (benchmarks/kernels_bench.py:66), an
#: 8-way TAB all-reduce of a Qwen2.5-14B 2048-token activation, the tp
#: phase's decode-step all-reduce (the embedding's, and every row-parallel
#: projection's partials) at m = 2 and 4 ranks and its largest prefill
#: partial (a 64-token admission at m = 2, 8 tokens at m = 4), the family
#: spawn's row-parallel partials at m = 2: a decode step's 4 rows of
#: recurrentgemma-9b, xlstm-125m (d = 768) and whisper-base, and the
#: largest each sums: an 8-token admission (recurrentgemma-9b; the
#: sLSTM's up projection, 1024 wide, for xlstm-125m) and whisper's
#: encoder, 1500 frames (``ACCUMULATE_PHASE``); and a ragged trailing
#: shape (checked, not timed)
ACCUMULATE_SHAPES = (((8, 64, 512), "float32"), ((8, 2048, 5120), "bfloat16"),
                     ((2, 4, 5120), "bfloat16"), ((4, 4, 5120), "bfloat16"),
                     ((2, 64, 5120), "bfloat16"), ((4, 8, 5120), "bfloat16"),
                     ((2, 4, 4096), "bfloat16"), ((2, 8, 4096), "bfloat16"),
                     ((2, 4, 768), "bfloat16"), ((2, 8, 1024), "bfloat16"),
                     ((2, 4, 512), "bfloat16"), ((2, 1500, 512), "bfloat16"))
ACCUMULATE_PHASE = {(2, 4, 5120): "tp2", (4, 4, 5120): "tp4",
                    (2, 64, 5120): "tp2", (4, 8, 5120): "tp4",
                    **dict.fromkeys(((2, 4, 4096), (2, 8, 4096), (2, 4, 768),
                                     (2, 8, 1024), (2, 4, 512),
                                     (2, 1500, 512)), "tpfam")}
ACCUMULATE_RAGGED = (((5, 3, 7, 11), "float32"),)


def _matmul_inputs(torch, gen, shape, dtype, pad=0):
    m, k, n = shape
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n + pad), generator=gen, device="cuda") / k ** 0.5
    return x.to(dtype), w.to(dtype)[:, :n]


def _route(torch, x, w) -> str:
    from repro_torch.kernels.streamed_matmul import kernel as K
    (m, k), n = x.shape, w.shape[1]
    return K.plan(m, k, n, x.dtype,
                  x.dtype == torch.bfloat16 and K.aligned(x, w)).name


def check_matmul(torch, card: str, results: dict) -> None:
    """K3 against its plain version, one route at a time as ``plan``
    picks it.  fp32: |err| <= 2e-4 + 2e-4 |plain| (the reference's
    tolerance; summation order only, no TF32).  bf16 at Qwen widths: max
    |err| <= 1e-2 max |plain| (both sum in fp32 and round once to bf16:
    one bf16 ulp is 2^-8 relative); bf16 ragged: the reference's 5e-2.
    Every case is launched twice and must give the same bits (split-K
    sums its partials in a fixed order)."""
    from repro_torch.kernels.streamed_matmul import ops
    from repro_torch.kernels.streamed_matmul.ref import streamed_matmul_ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, dt, pad in MATMUL_SHAPES + MATMUL_RAGGED:
        dtype = getattr(torch, dt)
        x, w = _matmul_inputs(torch, gen, shape, dtype, pad)
        route = _route(torch, x, w)
        got, again = ops.matmul(x, w), ops.matmul(x, w)
        want = streamed_matmul_ref(x, w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tag = (f"K3 streamed_matmul_{route} {dt} {shape}"
               f"{f' w row stride {w.stride(0)}' if pad else ''}")
        if got.shape != want.shape or got.dtype != dtype:
            raise AssertionError(f"{tag}: {got.shape} {got.dtype}")
        if dt == "float32" or (shape, dt, pad) in MATMUL_RAGGED:
            tol = 2e-4 if dt == "float32" else 5e-2
            ok = bool((err <= tol + tol * want.float().abs()).all())
            what = f"atol=rtol={tol:g}"
        else:
            limit = 1e-2 * want.float().abs().max().item()
            ok = err.max().item() <= limit
            what = f"<= {limit:.3e}"
        same = torch.equal(got, again)
        log(f"{tag}: max_abs_err {err.max().item():.3e} ({what}); two "
            f"launches bit-identical: {same}")
        if not ok:
            raise AssertionError(f"{tag}: outside the tolerance")
        if not same:
            raise AssertionError(f"{tag}: two launches differ")
        if (shape, dt, pad) not in MATMUL_SHAPES:
            continue
        m, k, n = shape
        sets = [_matmul_inputs(torch, gen, shape, dtype, pad)
                for _ in range(ROTATE)]
        ms = time_ms(torch, ops.matmul, sets)
        plain_ms = time_ms(torch, streamed_matmul_ref, sets, iters=10,
                           graph=False)
        lib_ms = time_ms(torch, torch.matmul, sets)
        size = 4 if dt == "float32" else 2
        nbytes = (m * k + k * n + m * n) * size
        b_ms, b_by = bound(nbytes, 2 * m * k * n,
                           TF32X3_FLOPS_PER_S if dt == "float32"
                           else BF16_FLOPS_PER_S)
        log(f"{tag} [{card}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.matmul {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of the bound, kernel / torch.matmul "
            f"{ms / lib_ms:.2f}x")
        results.setdefault(f"streamed_matmul_{route}", []).append(dict(
            shape=f"({m},{k})@({k},{n}) {dt}"
                  f"{f', w row stride {w.stride(0)}' if pad else ''}",
            max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))


#: the realign route's views (M, K, N): K and N ragged, a prefill-width
#: and a decode-width M; x and w each at every base offset of 0-7
#: elements, at an odd and at an even row stride
REALIGN_SHAPES = ((200, 77, 300), (3, 130, 261))


def check_realign(torch) -> None:
    """K3's realign route against its plain version on views whose bases
    sit at every offset of 0-7 elements from a 16-byte boundary (x and w
    independently), at odd and even row strides, ragged K and N: each
    element within the reference's ragged tolerance (atol = rtol = 5e-2),
    two launches the same bits, every launch on the realign route.  Each
    view ends with its buffer (its last element is the buffer's)."""
    from repro_torch.kernels.streamed_matmul import kernel as K
    from repro_torch.kernels.streamed_matmul import ops
    from repro_torch.kernels.streamed_matmul.ref import streamed_matmul_ref
    gen = torch.Generator(device="cuda").manual_seed(7)

    def view(rows, cols, off, odd, scale=1.0):
        ld = cols + 3
        ld += (ld % 2) != int(odd)
        buf = (torch.randn(off + (rows - 1) * ld + cols, generator=gen,
                           device="cuda") * scale).to(torch.bfloat16)
        return buf.as_strided((rows, cols), (ld, 1), off)

    worst, cases = 0.0, 0
    for m, k, n in REALIGN_SHAPES:
        for odd in (True, False):
            for ox in range(8):
                for ow in range(8):
                    x = view(m, k, ox, odd)
                    w = view(k, n, ow, odd, k ** -0.5)
                    before = K.launches["realign"].count
                    got, again = ops.matmul(x, w), ops.matmul(x, w)
                    want = streamed_matmul_ref(x, w)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs()
                    tag = (f"K3 streamed_matmul_realign ({m},{k})@({k},{n}) "
                           f"x offset {ox} stride {x.stride(0)}, w offset "
                           f"{ow} stride {w.stride(0)}")
                    if K.launches["realign"].count != before + 2:
                        raise AssertionError(f"{tag}: not the realign route")
                    if not bool((err <= 5e-2 + 5e-2 * want.float().abs())
                                .all()):
                        raise AssertionError(f"{tag}: max_abs_err "
                                             f"{err.max().item():.3e}")
                    if not torch.equal(got, again):
                        raise AssertionError(f"{tag}: two launches differ")
                    worst = max(worst, err.max().item())
                    cases += 1
    log(f"K3 streamed_matmul_realign: {cases} views at every base offset "
        f"0-7 of x and w, odd and even row strides, shapes "
        f"{REALIGN_SHAPES}: max_abs_err {worst:.3e} (atol=rtol=5e-2), two "
        f"launches bit-identical")


def sweep_matmul(torch, card: str) -> None:
    """Where K3's planner switches from splitk to wgmma: both routes timed
    at Qwen2.5-14B's two MLP shapes for M = 1 .. 64 (``--phases sweep``;
    ``SPLITK_MAX_M`` is set from this)."""
    from repro_torch.kernels.streamed_matmul import kernel as K
    gen = torch.Generator(device="cuda").manual_seed(6)
    for k, n in ((5120, 13824), (13824, 5120)):
        for m in (1, 2, 4, 8, 16, 32, 64):
            sets = [_matmul_inputs(torch, gen, (m, k, n), torch.bfloat16)
                    for _ in range(ROTATE)]
            times = {}
            for name in ("splitk", "wgmma"):
                if name == "splitk" and m > 8:      # its widest template
                    continue
                route = (K._plan_splitk(m, k, n) if name == "splitk" else
                         K.plan(m, k, n, torch.bfloat16, True)
                         if m > K.SPLITK_MAX_M else
                         K.Route("wgmma", (-(-m // 128) * -(-n // 256), 1, 1),
                                 1, k))
                times[name] = time_ms(torch, lambda x, w, r=route: K._launch(
                    x, w, r), sets)
            lib = time_ms(torch, torch.matmul, sets)
            log(f"K3 sweep ({m},{k})@({k},{n}) bf16 [{card}]: " + ", ".join(
                f"{r} {t:.4f} ms" for r, t in times.items())
                + f", torch.matmul {lib:.4f} ms")


def check_accumulate(torch, card: str, results: dict) -> None:
    """K4 against its plain version: fp32 within 1e-4; bf16 within 5e-2
    and within one bf16 ulp of the plain sum (both sum in fp32 and round
    once, in different orders); permuted shards within 1e-5 in fp32 (the
    reduction is order-free up to fp32 rounding)."""
    from repro_torch.kernels.write_accumulate import ops
    from repro_torch.kernels.write_accumulate.ref import write_accumulate_ref
    gen = torch.Generator(device="cuda").manual_seed(4)

    def inputs(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def library(s):
        return torch.sum(s, 0, dtype=torch.float32).to(s.dtype)

    for shape, dt in ACCUMULATE_SHAPES + ACCUMULATE_RAGGED:
        dtype = getattr(torch, dt)
        s = inputs(shape, dtype)
        got, want = ops.accumulate(s), write_accumulate_ref(s)
        torch.cuda.synchronize()
        tag = f"K4 write_accumulate {dt} {shape}"
        if got.shape != want.shape or got.dtype != dtype:
            raise AssertionError(f"{tag}: {got.shape} {got.dtype}")
        err = (got.float() - want.float()).abs()
        tol = 1e-4 if dt == "float32" else 5e-2
        ok = bool((err <= tol + tol * want.float().abs()).all())
        if dt == "bfloat16":
            ulp = torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp_min(2.0 ** -126))) - 7)
            ok = ok and bool((err <= ulp).all())
        log(f"{tag}: max_abs_err {err.max().item():.3e} (atol=rtol={tol:g}"
            f"{', and <= 1 bf16 ulp' if dt == 'bfloat16' else ''})")
        if not ok:
            raise AssertionError(f"{tag}: outside the tolerance")
        if shape == (8, 64, 512):
            perm = torch.randperm(shape[0], generator=gen, device="cuda")
            d = (ops.accumulate(s[perm]) - got).abs().max().item()
            log(f"{tag}: permuted shards differ by {d:.3e} (bound 1e-5)")
            if not d <= 1e-5:
                raise AssertionError(f"{tag}: not order-free: {d}")
        if (shape, dt) not in ACCUMULATE_SHAPES:
            continue
        sets = [(inputs(shape, dtype),) for _ in range(ROTATE)]
        ms = time_ms(torch, ops.accumulate, sets)
        plain_ms = time_ms(torch, write_accumulate_ref, sets, iters=20,
                           graph=False)
        lib_ms = time_ms(torch, library, sets)
        n, size = shape[0], s[0].numel()
        nbytes = (n + 1) * size * s.element_size()
        b_ms, b_by = bound(nbytes, (n - 1) * size,
                           F32_FLOPS_PER_S)   # the adds are fp32 CUDA-core
        log(f"{tag} [{card}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.sum {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        results.setdefault("write_accumulate", []).append(dict(
            shape=f"{shape} {dt}", max_abs_err=err.max().item(), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, **({"phase": ACCUMULATE_PHASE[shape]}
                                  if shape in ACCUMULATE_PHASE else {})))


#: the expert gather's main-path shape: granite-moe-3b-a800m's three banks
#: of one layer, (E, d, f), (E, d, f), (E, f, d) bf16, and a decode
#: step's routing at batch 4, top-8 of 40 (the union of four tokens'
#: choices); a ragged fp32 case takes the byte-wise path
GATHER_MAIN = (40, 1536, 512, 4, 8)
GATHER_RAGGED = ((5, 3, 7), "float32")
PCIE_BYTES_PER_S = 64e9          # PCIe Gen5 x16, one direction


def _routed_mask(torch, gen, experts: int, tokens: int, top_k: int):
    """The union of ``tokens`` tokens' top-k choices, each a random set
    of ``top_k`` of ``experts``: an (E,) bool mask on the card."""
    mask = torch.zeros(experts, dtype=torch.bool, device="cuda")
    for _ in range(tokens):
        mask[torch.randperm(experts, generator=gen,
                            device="cuda")[:top_k]] = True
    return mask


#: cycles of ``torch.cuda._sleep`` queued ahead of the no-wait gate's
#: gather: ~50 ms at an H100 SXM's 1.98 GHz boost clock
SLEEP_CYCLES = 100_000_000


def _slot_map(torch, mask, n: int):
    """The moe path's packing for a gather of ``n`` routed choices: rows
    min(n, E) + 1, each routed expert's row its rank in the mask, the
    rest on the spare last row."""
    rows = min(n, mask.numel()) + 1
    slots = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    slots.masked_fill_(~mask, rows - 1)
    return rows, slots


def check_gather(torch, card: str, results: dict) -> None:
    """The expert gather (port-only) against its plain version
    (``index_select`` on the host bank, then ``index_copy_`` on the
    device), bit for bit over the whole buffers (routed rows copied, the
    others left as they were), on the route ``plan`` gives (``sm``):
    packed as the moe path packs, into min(N, E) + 1 rows through the
    slot map, granite's banks in mapped pinned host memory
    (``tiers.host_empty(..., mapped=True)``: ``cudaHostAlloc``) under a
    decode step's routing (N = 32), the same banks resident on the card,
    every expert routed (N = 64, an admission) and none; through the
    identity slot map (``arange(E)``: buffers of the bank's shape) the
    same decode routing and a ragged fp32 bank (the byte-wise path).
    The kernel's byte counter must equal the routed rows' bytes.  No
    wait: with ~50 ms of ``torch.cuda._sleep`` queued, a warm gather
    must return while the stream is still busy (a sync inside the C
    library, which ``set_sync_debug_mode`` cannot see, would wait).
    Then the main shape is timed (eager, CUDA events: one
    launch moves ~0.1 GB, so the host's launch cost is noise) in turns
    with the copy engine moving the same bytes from pinned memory in one
    ``copy_`` (not the same function: no PyTorch call gathers host rows
    into device memory, so ``library_ms`` is null), and the plain
    version."""
    from repro_torch.kernels.expert_gather import kernel as K
    from repro_torch.kernels.expert_gather.ref import expert_gather_ref
    from repro_torch.memory import REMOTE, tiers
    gen = torch.Generator(device="cuda").manual_seed(6)
    e, d, f, tokens, top_k = GATHER_MAIN

    def banks(shapes, dtype, host=True):
        out = []
        for shape in shapes:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            out.append(tiers.to_tier(x, REMOTE, mapped=True) if host else x)
        return out

    def case(tag, src, mask, n=None):
        """Bytes routed; the kernel bit-equal to the plain version, twice,
        its counter the routed bytes, each launch on the planned route.
        ``n``: the routed choices a packed gather serves (None: the
        identity slot map, a buffer of the bank's E rows)."""
        e_rows = src[0].shape[0]
        rows, slots = ((e_rows, torch.arange(e_rows, dtype=torch.int32,
                                             device="cuda"))
                       if n is None else _slot_map(torch, mask, n))
        init = [torch.randn((rows,) + tuple(b.shape[1:]), generator=gen,
                            device="cuda").to(b.dtype) for b in src]
        got, again, want = ([x.clone() for x in init] for _ in range(3))
        route = K.plan([b.device for b in src], got[0].device)
        before = K.launches.by_instance.get(route, 0)
        counter = torch.zeros(1, dtype=torch.int64, device="cuda")
        K.expert_gather(src, mask, slots, got, counter)
        K.expert_gather(src, mask, slots, again,
                        torch.zeros(1, dtype=torch.int64, device="cuda"))
        expert_gather_ref(src, mask, slots, want)
        torch.cuda.synchronize()
        routed = int(mask.sum())
        nbytes = routed * sum(b[0].numel() * b.element_size() for b in src)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"expert gather {tag}, route {route}: {routed} of "
            f"{mask.numel()} experts routed into {rows} rows, bit-equal to "
            f"index_select + index_copy_: {same}; counter {int(counter)} "
            f"bytes (routed rows {nbytes})")
        if not same or not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"expert gather {tag}: differs from its "
                                 f"plain version or between launches")
        if int(counter) != nbytes:
            raise AssertionError(f"expert gather {tag}: counted "
                                 f"{int(counter)} bytes, routed {nbytes}")
        if K.launches.by_instance.get(route, 0) != before + 2:
            raise AssertionError(f"expert gather {tag}: launches by route "
                                 f"{K.launches.by_instance}, expected 2 "
                                 f"more on {route}")
        return nbytes

    shapes = ((e, d, f), (e, d, f), (e, f, d))
    host = banks(shapes, torch.bfloat16)
    mask = _routed_mask(torch, gen, e, tokens, top_k)
    n = tokens * top_k
    nbytes = case(f"granite banks {shapes} bf16 mapped host, batch "
                  f"{tokens} top-{top_k}, packed", host, mask, n)
    case("granite banks on the card, packed", [b.to("cuda") for b in host],
         mask, n)
    case("every expert, packed (an admission's N = 64)", host,
         torch.ones(e, dtype=torch.bool, device="cuda"), 2 * n)
    case("no expert, packed", host,
         torch.zeros(e, dtype=torch.bool, device="cuda"), n)
    case("granite banks mapped host, identity slots", host, mask)
    shape, dt = GATHER_RAGGED
    case(f"ragged {shape} {dt} (byte-wise), identity slots",
         banks((shape,) * 3, getattr(torch, dt)),
         _routed_mask(torch, gen, shape[0], 1, 2))

    rows, slots = _slot_map(torch, mask, n)
    out = [torch.empty((rows,) + tuple(b.shape[1:]), dtype=b.dtype,
                       device="cuda") for b in host]
    counter = torch.zeros(1, dtype=torch.int64, device="cuda")
    route = K.plan([b.device for b in host], out[0].device)

    def gather():
        K.expert_gather(host, mask, slots, out, counter)

    gather()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    gather()
    host_ms = (time.perf_counter() - t0) * 1e3
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    log(f"expert gather no-wait, route {route}: the call returned in "
        f"{host_ms:.3f} ms with the stream still busy: {busy}")
    if not busy:
        raise AssertionError("expert gather: the host waited for the device")
    flat = tiers.tier_empty((nbytes,), torch.uint8, REMOTE, device="cuda")
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    timed = {"copy_": lambda: dev.copy_(flat, non_blocking=True),
             route: gather}
    ms: dict = {}
    for name in ("copy_", route, route, "copy_"):
        ms.setdefault(name, []).append(time_ms(torch, timed[name], [()],
                                               iters=20, graph=False))
    plain_ms = time_ms(torch, lambda: expert_gather_ref(host, mask, slots,
                                                        out),
                       [()], iters=5, graph=False)
    b_ms = max(nbytes / PCIE_BYTES_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    tag = (f"E={e} d={d} f={f} x3 bf16, {int(mask.sum())} routed, packed "
           f"into {rows} rows")
    t, dma_ms = min(ms[route]), min(ms["copy_"])
    log(f"expert gather {tag}, route {route} [{card}]: kernel {t:.4f} ms = "
        f"{nbytes / t / 1e6:.2f} GB/s (turns {ms[route]}), plain "
        f"{plain_ms:.4f} ms; the copy engine moves the same {nbytes} bytes "
        f"from pinned memory in one copy_ in {dma_ms:.4f} ms = "
        f"{nbytes / dma_ms / 1e6:.2f} GB/s (turns {ms['copy_']}): "
        f"{t / dma_ms:.3f}x the copy_; bound {b_ms:.6f} ms (bytes over PCIe "
        f"Gen5 x16 at 64 GB/s), {100 * b_ms / t:.1f}% of the bound")
    results.setdefault("expert_gather", []).append(dict(
        shape=tag, instance=route, max_abs_err=0.0, ms=t, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by="bytes", library_ms=None,
        copy_engine_ms=dma_ms, gbps=nbytes / t / 1e6))


def drive_ops(torch) -> dict:
    """K3's and K4's path: their public wrappers, ``ops.matmul`` and
    ``ops.accumulate``, once at each of their shapes (no serving path
    reaches them; in the reference only benchmarks/kernels_bench.py
    does).  Counts are reset just before and read just after; every call
    must launch the kernel of the route ``plan`` gives its shape once,
    every K3 route must run, the ragged bf16 shape must take the realign
    route, and nothing else may launch."""
    from collections import Counter
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.streamed_matmul import ops as sm
    from repro_torch.kernels.write_accumulate import ops as wa
    gen = torch.Generator(device="cuda").manual_seed(5)
    mm = [_matmul_inputs(torch, gen, shape, getattr(torch, dt), pad)
          for shape, dt, pad in MATMUL_SHAPES + MATMUL_RAGGED]
    acc = [torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dt)) for shape, dt in ACCUMULATE_SHAPES
        + ACCUMULATE_RAGGED]
    routes = [_route(torch, x, w) for x, w in mm]
    if routes[-1] != "realign" or set(routes) != {"wgmma", "splitk",
                                                  "realign", "f32"}:
        raise AssertionError(f"K3 routes {routes}: the ragged bf16 shape "
                             f"must take realign and every route must run")
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [sm.matmul(x, w) for x, w in mm] + [wa.accumulate(s) for s in acc]
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {f"streamed_matmul_{r}": c for r, c in Counter(routes).items()}
    want["write_accumulate"] = len(acc)
    got = {k: n for k, n in launches.items() if n}
    log(f"ops path (ops.matmul x{len(mm)}, ops.accumulate x{len(acc)}): "
        f"launches {got}")
    if got != want:
        raise AssertionError(f"ops path launched {got}, expected {want}")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError("ops path: non-finite output")
    return launches


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prompts(vocab: int, seed: int):
    """Four 8-token prompts (the serving benchmark's workload) and a pair
    of 40-token prompts whose first 32 tokens agree: padded to 64, they
    share three whole 16-token pages."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = [rng.randint(1, vocab, size=8).astype(np.int32) for _ in range(4)]
    base = rng.randint(1, vocab, size=40).astype(np.int32)
    other = base.copy()
    other[32:] = rng.randint(1, vocab, size=8)
    return out + [base, other]


def serve(server, reqs_prompts, new_tokens: int):
    import torch
    reqs = [server.submit(p, max_new_tokens=new_tokens) for p in reqs_prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.run_once()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def check_parity(torch) -> dict:
    """Smoke-size fp32 model: the card (kernels) against the CPU (plain
    versions), same weights and prompts; greedy over bf16-width pools,
    and sampled at temperature 0.7 over int8 pools.  Its prefills must
    take K2's mma route (fp32).  Returns the greedy card run's kernel
    launches and, by template instantiation, ``instance_counts()``
    (counts reset just before the run, read just after)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import instance_counts, reset_launch_counts
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    base = get_config("qwen2.5-14b").reduced(dtype=torch.float32)
    base = dataclasses.replace(base, head_dim=128, d_model=512, num_heads=10,
                               num_kv_heads=2)
    cpu_params = DenseLM(base).init(0, device="cpu")

    # int8: a KV element whose fp32 value lies within the two devices'
    # summation-order difference of a rounding boundary lands one int8
    # quantum apart, which moves the logits by up to ~1e-3
    for kv, temperature, tol in ((None, 0.0, 1e-3), ("int8", 0.7, 1e-2)):
        model = DenseLM(dataclasses.replace(base, kv_dtype=kv))
        kernel = "paged_attention" + ("" if kv is None else f"_{kv}")
        outs = {}
        for dev, params in (("cpu", cpu_params),
                            ("cuda", _to(cpu_params, "cuda"))):
            reset_launch_counts()
            server = BatchedServer(model, params, batch_size=4, max_seq=128,
                                   block_size=8, temperature=temperature,
                                   seed=1, device=dev)
            reqs = [server.submit(p, max_new_tokens=16)
                    for p in prompts(base.vocab, 3)]
            server.run_once()
            outs[dev] = [r.output for r in reqs]
            if dev == "cuda":
                launches = dict(server.stats["kernel_launches"])
                if kv is None:
                    greedy = launches, instance_counts()
            toks = torch.from_numpy(prompts(base.vocab, 3)[4][None]).to(dev)
            pages = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=dev)
            logits, _ = model.prefill_paged(
                params, toks, model.init_paged_cache(8, device=dev), pages)
            outs[dev + "_logits"] = logits.float().cpu()
        err = (outs["cpu_logits"] - outs["cuda_logits"]).abs().max().item()
        first8 = all(a[:8] == b[:8] for a, b in zip(outs["cpu"],
                                                    outs["cuda"]))
        log(f"parity (smoke fp32, kv_dtype={kv}, temperature {temperature}, "
            f"card vs CPU): prefill logits max_abs_err {err:.3e} (bound "
            f"{tol:g}), first-8 tokens agree: {first8}, launches {launches}")
        if not (err <= tol and first8 and launches[kernel] > 0):
            raise AssertionError(f"card and CPU disagree on the smoke model "
                                 f"(kv_dtype={kv})")
        if not (launches["flash_attention_mma"] > 0
                and launches["flash_attention_wgmma"] == 0):
            raise AssertionError(f"fp32 smoke model: K2 launches "
                                 f"{launches}, expected the mma route only")
    return greedy


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def check_parity_families(torch) -> None:
    """Smoke-size fp32 MoE (granite-moe-3b-a800m reduced: 4 experts, top-2),
    VLM (llava-next-34b reduced: 8 patches), hybrid (recurrentgemma-9b
    reduced to 5 layers), xLSTM and whisper, the card against the CPU
    with the same weights.  The hybrid and the xLSTM: served greedy over
    their slab, the first 8 tokens and the prefill logits (1e-3);
    whisper: ``prefill`` with frames and 7 greedy decode steps, the
    tokens equal and the prefill logits within 1e-3.  MoE: served greedy (the serve phase's
    prompts), tokens' first 8 and the prefill logits (bound 1e-3) agree;
    served once more on the card with its banks in mapped pinned host
    memory (``page_experts``): the card's resident tokens, through the
    expert gather.  VLM: ``prefill_paged`` with patches, then four decode
    steps, logits within 1e-3 at every step."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime.serve import BatchedServer
    cfg = get_config("granite-moe-3b-a800m").reduced(dtype=torch.float32)
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    work = prompts(cfg.vocab, 3)
    outs = {}
    for dev, params in (("cpu", cpu_params),
                        ("cuda", _to(cpu_params, "cuda"))):
        server = BatchedServer(model, params, batch_size=4, max_seq=128,
                               block_size=8, seed=1, device=dev)
        reqs = [server.submit(p, max_new_tokens=16) for p in work]
        server.run_once()
        outs[dev] = [r.output for r in reqs]
        toks = torch.from_numpy(work[4][None]).to(dev)
        pages = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=dev)
        logits, _ = model.prefill_paged(
            params, toks, model.init_paged_cache(8, device=dev), pages)
        outs[dev + "_logits"] = logits.float().cpu()
    err = (outs["cpu_logits"] - outs["cuda_logits"]).abs().max().item()
    first8 = all(a[:8] == b[:8] for a, b in zip(outs["cpu"], outs["cuda"]))
    paged = build_model(cfg.with_pager(page_experts=True))
    pparams = dict(params)
    pparams["layers"] = paged.mem.place_layer_weights(params["layers"])
    server = BatchedServer(paged, pparams, batch_size=4, max_seq=128,
                           block_size=8, seed=1, device="cuda")
    reqs = [server.submit(p, max_new_tokens=16) for p in work]
    reset_launch_counts()
    server.run_once()
    gathers = launch_counts()["expert_gather"]
    same = [r.output for r in reqs] == outs["cuda"]
    log(f"parity (smoke fp32 MoE, card vs CPU): prefill logits max_abs_err "
        f"{err:.3e} (bound 1e-3), first-8 tokens agree: {first8}; "
        f"expert-paged on the card (banks in mapped pinned host memory): "
        f"the card's resident tokens: {same}, {gathers} expert gathers")
    if not (err <= 1e-3 and first8 and same and gathers > 0):
        raise AssertionError("smoke MoE: card and CPU disagree, or the "
                             "expert-paged tokens differ")

    cfg = get_config("llava-next-34b").reduced(dtype=torch.float32)
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(4)
    patches = torch.randn((1, cfg.num_patches, cfg.d_model), generator=gen)
    toks = torch.randint(1, cfg.vocab, (1, 12), generator=gen)
    feed = torch.randint(1, cfg.vocab, (1, 4), generator=gen)
    total = cfg.num_patches + toks.shape[1]
    logits = {}
    for dev, params in (("cpu", cpu_params),
                        ("cuda", _to(cpu_params, "cuda"))):
        pages = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
        out, cache = model.prefill_paged(
            params, toks.to(dev), model.init_paged_cache(4, device=dev),
            pages, extra={"patches": patches.to(dev)})
        steps = [out.float().cpu()]
        for i in range(feed.shape[1]):
            out, cache = model.decode_step(
                params, feed[:, i:i + 1].to(dev), cache,
                torch.tensor([total + i], dtype=torch.int32, device=dev),
                pages)
            steps.append(out.float().cpu())
        logits[dev] = torch.stack(steps)
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    log(f"parity (smoke fp32 VLM, {cfg.num_patches} patches + 12 tokens, "
        f"then 4 decode steps, card vs CPU): logits max_abs_err {err:.3e} "
        f"(bound 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("smoke VLM: card and CPU disagree")
    parity_patterned(torch, gen)


def parity_patterned(torch, gen) -> None:
    """The parity phase's hybrid (recurrentgemma-9b reduced to one group
    and a tail of two rec blocks, window 8) and xLSTM, served over their
    slab on the card and on the CPU (``_card_and_cpu``), and whisper at
    the model level (it has no server path)."""
    from repro_torch.configs import build_model, get_config
    problems: list = []
    kw = dict(batch_size=4, max_seq=128, block_size=8, seed=1)
    for arch, over in (("recurrentgemma-9b", {"num_layers": 5}),
                       ("xlstm-125m", {})):
        cfg = get_config(arch).reduced(dtype=torch.float32, **over)
        model = build_model(cfg)
        _card_and_cpu(torch, model, model.init(0, device="cpu"),
                      f"parity (smoke {arch})", kw,
                      prompts(cfg.vocab, 3), problems, new=16)
    cfg = get_config("whisper-base").reduced(dtype=torch.float32)
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)
    toks = torch.randint(1, cfg.vocab, (2, 12), generator=gen)
    runs = {dev: _whisper_run(torch, model, prm, frames.to(dev),
                              toks.to(dev), 8)
            for dev, prm in (("cpu", cpu_params),
                             ("cuda", _to(cpu_params, "cuda")))}
    err = (runs["cpu"][1] - runs["cuda"][1]).abs().max().item()
    log(f"parity (smoke fp32 whisper-base, 16 frames + 12 tokens, then 7 "
        f"greedy decode steps, card vs CPU): prefill logits max_abs_err "
        f"{err:.3e} (bound 1e-3), tokens equal: "
        f"{runs['cpu'][0] == runs['cuda'][0]}")
    if not (err <= 1e-3 and runs["cpu"][0] == runs["cuda"][0]):
        problems.append("smoke whisper-base: card and CPU disagree")
    if problems:
        raise AssertionError("; ".join(problems))


#: the parity phase's dense models at smoke size, fp32: (arch, overrides
#: of ``reduced``).  minicpm-2b and gpt3-175b's MHA keeps G = 1 with 4 kv
#: heads (``reduced`` would make it G = 2); qwen2.5-14b with a window of 8
#: and with ``kv_quant`` serves from the dense slab
PARITY_DENSE = (("qwen3-14b", {}), ("minicpm-2b", {"num_kv_heads": 4}),
                ("starcoder2-15b", {}), ("gpt3-175b", {"num_kv_heads": 4}),
                ("qwen2.5-14b", {"sliding_window": 8}),
                ("qwen2.5-14b", {"kv_quant": True}))


def check_parity_dense(torch) -> None:
    """The dense configs of ``PARITY_DENSE`` at smoke size, fp32, the
    card against the CPU with the same weights: served greedy
    (``paged=None``: pools, or the slab for a window or ``kv_quant``) on
    the serve phase's prompts, the first 8 tokens of every request equal,
    and the prefill logits within 1e-3; on the card K1 runs once a layer
    a decode step over pools and never over the slab."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime.serve import BatchedServer
    for arch, kw in PARITY_DENSE:
        cfg = get_config(arch).reduced(dtype=torch.float32, **kw)
        model = build_model(cfg)
        cpu_params = model.init(0, device="cpu")
        work = prompts(cfg.vocab, 3)
        outs = {}
        for dev, params in (("cpu", cpu_params),
                            ("cuda", _to(cpu_params, "cuda"))):
            server = BatchedServer(model, params, batch_size=4, max_seq=128,
                                   block_size=8, seed=1, device=dev)
            reqs = [server.submit(p, max_new_tokens=16) for p in work]
            reset_launch_counts()
            server.run_once()
            k1 = launch_counts()["paged_attention"]
            outs[dev] = [r.output for r in reqs]
            toks = torch.from_numpy(work[4][None]).to(dev)
            if server.paged:
                pages = torch.tensor([[1, 2, 3]], dtype=torch.int32,
                                     device=dev)
                logits, _ = model.prefill_paged(
                    params, toks, model.init_paged_cache(8, device=dev),
                    pages)
            else:
                logits, _ = model.prefill(
                    params, toks, model.init_cache(1, 128, device=dev))
            outs[dev + "_logits"] = logits.float().cpu()
        err = (outs["cpu_logits"] - outs["cuda_logits"]).abs().max().item()
        first8 = all(a[:8] == b[:8] for a, b in zip(outs["cpu"],
                                                    outs["cuda"]))
        k1_ok = (k1 == cfg.num_layers * server.stats["steps"]
                 if server.paged else k1 == 0)
        log(f"parity (smoke fp32 {arch} {kw}, G = {cfg.q_per_kv}, "
            f"{'pools' if server.paged else 'dense slab'}, card vs CPU): "
            f"prefill logits max_abs_err {err:.3e} (bound 1e-3), first-8 "
            f"tokens agree: {first8}, K1 launches on the card {k1}")
        if not (err <= 1e-3 and first8 and k1_ok):
            raise AssertionError(f"smoke {arch} {kw}: card and CPU disagree "
                                 f"or K1 launched {k1} times")


#: the serving runs: (kv_dtype, temperature)
SERVE_RUNS = ((None, 0.0), (None, 0.7), ("int8", 0.0), ("int8", 0.7),
              ("fp8_e4m3", 0.0), ("fp8_e4m3", 0.7))


def qwen_params(torch, layers: int):
    """Qwen2.5-14B at its published widths, tp=1, ``layers`` deep, and
    random bf16 weights from a seeded torch.Generator on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DenseLM
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), tp=1,
                              num_layers=layers)
    log(f"serve: device memory allocated before the weights "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB (left by earlier "
        f"phases)")
    t0 = time.perf_counter()
    params = DenseLM(cfg).init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: {cfg.name} tp=1 layers={layers} d={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab}: {n_params / 1e9:.3f} B params bf16, init "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


#: the dryrun phase's steps: the serving workload's decode (batch 4,
#: max_seq 384) and one 2048-token prompt's prefill into a cache of 2048
DRYRUN_STEPS = (("decode", 4, 384), ("prefill", 1, 2048))
#: a transient's tolerance: max(10 %, 1 MiB)
DRYRUN_REL, DRYRUN_ABS = 0.10, 1 << 20
#: the tp phase's dry-run tally checks: one decode step, one admission's
#: prefill
DRYRUN_TP_STEPS = (("decode", 4, 384), ("prefill", 1, 8))
#: what the dryrun phase predicted, for the serve phase's comparison
DRYRUN: dict = {}


def dryrun_build(torch, model, kind: str, b: int, s: int) -> dict:
    """A step's real inputs on the card, made in the order the dry run
    counts them (``dryrun._arguments``) with nothing else allocated in
    between: each parameter leaf an ``empty`` filled in place, the
    pageable layers placed in the remote tier (the device copies freed,
    their segments returned), the cache, the tokens, the positions, the
    key."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import prng
    from repro_torch.memory.accounting import tree_map

    def real(x):
        t = torch.empty(x.shape, dtype=x.dtype, device="cuda")
        return t.normal_(0.0, 0.02) if t.is_floating_point() else t.zero_()

    with FakeTensorMode():
        shapes = model.init(0, device="cpu")       # no memory
    params = tree_map(real, shapes)
    if model.cfg.pager.enabled:
        params["layers"] = model.mem.place_layer_weights(params["layers"])
        gc.collect()
        torch.cuda.empty_cache()
    out = dict(params=params, cache=model.init_cache(b, s, device="cuda"))
    if kind == "prefill":
        out["tokens"] = torch.zeros((b, s), dtype=torch.int64, device="cuda")
    else:
        out["tokens"] = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
        out["cur_pos"] = torch.full((b,), s // 2, dtype=torch.int32,
                                    device="cuda")
        out["key"] = prng.PRNGKey(0, "cuda")
    return out


def dryrun_step(torch, model, kind: str, x: dict):
    from repro_torch.runtime.serve import make_prefill_step, make_serve_step
    with torch.no_grad():
        if kind == "prefill":
            return make_prefill_step(model)(x["params"], x["tokens"],
                                            x["cache"])
        return make_serve_step(model)(x["params"], x["tokens"], x["cache"],
                                      x["cur_pos"], x["key"])


def dryrun_bound(cost: dict) -> float:
    """The least ms a step's counted work allows on an H100 SXM: its
    flops at the bf16 peak or its bytes at the HBM rate, the larger."""
    from repro_torch.core.hw import H100_SXM
    return 1e3 * max(cost["flops"] / H100_SXM.peak_bf16_flops,
                     cost["bytes_accessed"] / H100_SXM.hbm_bw)


def check_dryrun(torch, card: str, layers: int) -> None:
    """The dryrun phase: the dry run's predictions held against the
    card's own allocator, Qwen2.5-14B at full width and ``layers`` deep
    (the serve phase's depth), tp=1.

    For each step of ``DRYRUN_STEPS``, resident: the predicted
    ``argument_bytes`` must equal the rise of ``memory_allocated()``
    across making the inputs (``dryrun_build``, from empty segments:
    this phase runs first), and the predicted transient (peak minus
    arguments) the measured one -- ``max_memory_allocated()`` after
    ``reset_peak_memory_stats()`` less ``memory_allocated()`` before the
    second of two steps, so that cuBLAS's workspace is in the baseline --
    within max(10 %, 1 MiB).  With the weights paged
    (``with_pager(enabled=True, lookahead=1)``), the decode step: the
    device rise equal to the prediction, the predicted host bytes equal
    to the remote tier's line in the ledger; the resident / paged device
    bytes printed.  Printed only: the dry run's flops and bytes of the
    resident decode step at 48 layers and at this depth with the least
    time they allow (``dryrun_bound``), the latter beside the replayed
    step the serve phase measures (``DRYRUN``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.memory import tiers
    from repro_torch.models.transformer import DenseLM
    base_cfg = dataclasses.replace(get_config("qwen2.5-14b"), tp=1,
                                   num_layers=layers)
    log(f"dryrun: DEPTH CUT: Qwen2.5-14B at full width and {layers} of 48 "
        f"layers")
    problems, device = [], {}
    cases = [(False, kind, b, s) for kind, b, s in DRYRUN_STEPS]
    cases.append((True,) + DRYRUN_STEPS[0])
    for paged, kind, b, s in cases:
        cfg = (base_cfg.with_pager(enabled=True, lookahead=1) if paged
               else base_cfg)
        tag = f"{kind} B={b} S={s}{' paged' if paged else ''}"
        t0 = time.perf_counter()
        pred = dryrun.trace_step(DenseLM(cfg), kind, b, s)
        trace_s = time.perf_counter() - t0
        mem = pred["memory"]
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        model = DenseLM(cfg)
        x = dryrun_build(torch, model, kind, b, s)
        rise = torch.cuda.memory_allocated() - before
        device[paged, kind] = rise
        out = dryrun_step(torch, model, kind, x)
        torch.cuda.synchronize()
        del out
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = dryrun_step(torch, model, kind, x)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base
        finite = bool(torch.isfinite(out[1] if kind == "decode"
                                     else out[0]).all())
        del out
        host = model.mem.ledger.in_use(tiers.REMOTE)
        packed = sum(p.nbytes for p in getattr(x["params"]["layers"],
                                               "packed", ()))
        tol = max(DRYRUN_REL * mem["temp_bytes"], DRYRUN_ABS)
        log(f"dryrun {tag} [{card}]: arguments predicted "
            f"{mem['argument_bytes']} B, measured {rise} B; transient "
            f"predicted {mem['temp_bytes']} B, measured {measured} B "
            f"({measured / max(mem['temp_bytes'], 1):.4f}x, tolerance "
            f"{tol:.0f} B); host predicted {mem['host_argument_bytes']} B "
            f"allocated (the packed layers: {packed} B) holding "
            f"{mem['params']['host']} B of weights (the ledger's remote "
            f"tier: {host} B); flops {pred['cost']['flops']}"
            f", bytes {pred['cost']['bytes_accessed']}, {pred['ops']} ops "
            f"traced in {trace_s:.2f} s")
        if rise != mem["argument_bytes"]:
            problems.append(f"{tag}: argument bytes {rise} measured, "
                            f"{mem['argument_bytes']} predicted")
        if not paged and abs(measured - mem["temp_bytes"]) > tol:
            problems.append(f"{tag}: transient {measured} measured, "
                            f"{mem['temp_bytes']} predicted")
        if paged and (host != mem["params"]["host"]
                      or packed != mem["host_argument_bytes"]):
            problems.append(f"{tag}: host bytes {host} in the ledger, "
                            f"{mem['params']['host']} predicted; {packed} "
                            f"packed, {mem['host_argument_bytes']} "
                            f"predicted")
        if not finite:
            problems.append(f"{tag}: non-finite output")
        del x, model
    on_card, at_rest = device[False, "decode"], device[True, "decode"]
    log(f"dryrun [{card}]: resident / paged device bytes of the decode "
        f"step at {layers} layers {on_card / max(at_rest, 1):.4f} "
        f"({on_card} / {at_rest} B, measured and predicted alike)")
    for depth in (48, layers):
        cfg = dataclasses.replace(base_cfg, num_layers=depth)
        kind, b, s = DRYRUN_STEPS[0]
        cost = dryrun.trace_step(DenseLM(cfg), kind, b, s)["cost"]
        DRYRUN[depth] = dict(cost, bound_ms=dryrun_bound(cost))
        log(f"dryrun decode B={b} S={s} at {depth} layers (counted, not "
            f"measured) [{card}]: flops {cost['flops']}, bytes "
            f"{cost['bytes_accessed']}: at least "
            f"{DRYRUN[depth]['bound_ms']:.4f} ms a step on an H100 SXM "
            f"(bf16 peak 989 TFLOP/s, HBM 3.35 TB/s)")
    if problems:
        raise AssertionError("dryrun: " + "; ".join(problems))


def tp_dryrun_tally(torch, cfg, params, mesh) -> dict:
    """In a rank of the tp phase: one row-parallel decode step and one
    admission's prefill (``DRYRUN_TP_STEPS``) over the mesh's shared
    region, each step's tally beside the dry run's of the same step on
    this rank's shape-only view of the mesh (the same region and
    notice).  Returns kind -> (real tally, dry-run tally)."""
    from repro_torch import prng
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import shape_mesh
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import make_prefill_step, make_serve_step
    model = DenseLM(cfg)
    model.mem.bind_mesh(mesh, row_parallel=True)
    t = mesh.transport("model")
    out = {}
    try:
        shard = model.mem.place_params(params, model.param_specs())
        for kind, b, s in DRYRUN_TP_STEPS:
            cache = model.init_cache(b, s, device="cuda")
            t.reset_tally()
            with torch.no_grad():
                if kind == "decode":
                    make_serve_step(model)(
                        shard, torch.zeros((b, 1), dtype=torch.int64,
                                           device="cuda"), cache,
                        torch.full((b,), s // 2, dtype=torch.int32,
                                   device="cuda"), prng.PRNGKey(0, "cuda"))
                else:
                    make_prefill_step(model)(
                        shard, torch.zeros((b, s), dtype=torch.int64,
                                           device="cuda"), cache)
            torch.cuda.synchronize()
            real = {k: dict(v) for k, v in t.tally.items() if v["transfers"]}
            view = shape_mesh(dict(mesh.shape), rank=mesh.rank,
                              region_bytes=t.half, notice=t.notice)
            dryrun.trace_step(DenseLM(cfg), kind, b, s, view)
            dry = {k: dict(v) for k, v in view.transport("model").tally.items()
                   if v["transfers"]}
            out[kind] = (real, dry)
            del cache
    finally:
        model.mem.bind_mesh(None)
    return out


#: the depth of the serve, dense, tiers and disagg phases, which share one
#: set of Qwen2.5-14B weights: 8 of its 48 layers.  At 48 the default run
#: took 945-998 s on an H100 80GB HBM3 at 700 W (the serve phase 206-233
#: s, dense ~103, tiers ~144 with offload_kv) and passed 1200 s on a card
#: whose host-bound steps run ~1.3x slower; their eager steps are
#: host-bound, so their time follows the depth.  12 from PR 27; 8 since
#: the tp phase took both notices (a card ~1.45x slower than PR 29's ran
#: the default run past 1040 s of phases at 12)
SERVE_LAYERS = 8

#: the serving runs' server settings (the BENCH_serve.json workload's)
SERVE_KW = dict(batch_size=4, max_seq=384, block_size=32, page_size=16,
                seed=0)


def check_serve(torch, card: str, cfg, params, profile: bool):
    """Serve Qwen2.5-14B (one set of weights) over bf16, int8 and fp8
    pools, greedy and at temperature 0.7.  Returns kernel name -> its
    launches in the run of its own path (the greedy one), kernel name ->
    {template instantiation -> launches} in that run, and each run's
    tokens by (kv_dtype, temperature)."""
    import dataclasses
    from repro_torch.models.transformer import DenseLM
    if cfg.num_layers != 48:
        log(f"DEPTH CUT: serving {cfg.num_layers} of Qwen2.5-14B's 48 "
            f"layers")
    work = prompts(cfg.vocab, 0)
    launches, instances, per_page, tokens = {}, {}, {}, {}
    for kv, temperature in SERVE_RUNS:
        model = DenseLM(dataclasses.replace(cfg, kv_dtype=kv))
        got = serve_config(torch, card, model, params, work,
                           dict(SERVE_KW, temperature=temperature))
        per_page[kv] = got["bytes_per_page"]
        if temperature == 0.0:
            launches.update(got["launches"])
            instances.update(got["instances"])
        tokens[kv, temperature] = got["tokens"]
    for kv in ("int8", "fp8_e4m3"):
        if per_page[kv] * 256 != per_page[None] * 130:
            raise AssertionError(f"{kv} KV bytes per page {per_page[kv]} is "
                                 f"not 130/256 of bf16's {per_page[None]}")
    log(f"serve: KV bytes per page bf16 {per_page[None]}, int8 "
        f"{per_page['int8']}, fp8_e4m3 {per_page['fp8_e4m3']} (130/256)")
    problems = []
    for kv, temperature in SERVE_RUNS:
        problems += graph_vs_eager(
            torch, card, f"Qwen2.5-14B pools kv_dtype={kv} "
                         f"temperature={temperature}",
            DenseLM(dataclasses.replace(cfg, kv_dtype=kv)), params,
            temperature=temperature)
    if problems:
        raise AssertionError("serve phase: " + "; ".join(problems))
    check_steady(torch, card, cfg, params)
    if profile:
        profile_graph(torch, card, cfg, params)
        for kv, temperature in ((None, 0.0), ("int8", 0.7)):
            profile_serve(torch, DenseLM(dataclasses.replace(
                cfg, kv_dtype=kv)), params,
                dict(SERVE_KW, temperature=temperature), work[:4], card)
    return launches, instances, tokens


#: the serve phase's paged-weights run: the first 24 of the 48 layers
#: (cut from 48 to keep the default run inside its time; the step is the
#: link's, ~0.65 s a step at 48 layers on an H100 80GB HBM3 at 700 W)
SERVE_PAGED_LAYERS = 24


def check_serve_paged(torch, card: str, cfg, params, profile: bool) -> None:
    """The serve phase's last run: bf16 greedy with the first
    ``SERVE_PAGED_LAYERS`` layers paged from pinned host memory, held to
    a resident run at that depth (consumes ``params["layers"]``)."""
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    work = prompts(cfg.vocab, 0)
    depth = min(cfg.num_layers, SERVE_PAGED_LAYERS)
    cfg = dataclasses.replace(cfg, num_layers=depth)
    params["layers"] = params["layers"][:depth]
    if depth < 48:
        log(f"DEPTH CUT: the paged-weights run serves {depth} of "
            f"Qwen2.5-14B's 48 layers")
    want, secs = serve(BatchedServer(DenseLM(cfg), params,
                                     **dict(SERVE_KW, temperature=0.0)),
                       work, 64)
    want = [r.output for r in want]
    log(f"paged serve: the resident reference at {depth} layers took "
        f"{secs:.3f} s")
    model = DenseLM(cfg.with_pager(enabled=True, lookahead=1))
    serve_paged(torch, card, model, params, work,
                dict(SERVE_KW, temperature=0.0), want)
    if profile:
        profile_serve(torch, model, params, dict(SERVE_KW, temperature=0.0),
                      work[:4], card)


def serve_paged(torch, card: str, model, params, work, kw,
                want: list, new: int = 64) -> dict:
    """The same weights, moved to the remote tier (pinned host memory)
    and paged back layer by layer by the Tensor Prefetcher, serving the
    same workload once (bf16 pools, greedy, ``new`` tokens a request):
    the tokens must equal the resident run's, K1 must run once a layer a
    decode step, and the prefetcher must fetch every layer once a decode
    step and once an admission.  ``params["layers"]`` is replaced by the
    placed layers, which frees their device copies.  Returns the run's
    seconds, decode steps, tokens and peak device memory."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.memory import LOCAL, REMOTE
    from repro_torch.runtime.serve import BatchedServer
    cfg, mem = model.cfg, model.mem
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params["layers"] = mem.place_layer_weights(params["layers"])
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    placed, pf = params["layers"], mem.prefetcher
    if pf is None or mem.degraded:
        raise AssertionError(f"paged serve: placement degraded "
                             f"{mem.describe()}")
    if not all(p.buffer.is_pinned() for p in placed.packed):
        raise AssertionError("paged serve: a remote layer is not pinned")
    led = mem.ledger
    total = led.classes(REMOTE)["layer_weights"]
    window = led.classes(LOCAL)["layer_weights_window"]
    log(f"paged serve {cfg.name} [{card}]: placed {cfg.num_layers} layers in "
        f"{place_s:.1f} s; device memory allocated {before / 2**30:.2f} -> "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; pinned host "
        f"{placed.nbytes} bytes (ledger remote layer_weights {total}); "
        f"ledger local layer_weights_window {window} bytes = 2 x per-layer "
        f"{2 * (total // cfg.num_layers)}; window allocated "
        f"{pf.window_bytes} bytes")
    if window != 2 * (total // cfg.num_layers):
        raise AssertionError("paged serve: the window is not two layers")
    torch.cuda.reset_peak_memory_stats()
    server = BatchedServer(model, params, prefix_cache=True, **kw)
    reset_launch_counts()
    fetches, fetched = pf.fetches, pf.fetched_bytes
    reqs, secs = serve(server, work, new)
    launches = launch_counts()
    fetches, fetched = pf.fetches - fetches, pf.fetched_bytes - fetched
    st = server.stats
    tokens = sum(len(r.output) for r in reqs)
    peak = torch.cuda.max_memory_allocated()
    log(f"paged serve {cfg.name} kv_dtype=None temperature=0.0 lookahead=1 "
        f"[{card}]: "
        f"{tokens} tokens in {secs:.3f} s = {tokens / secs:.2f} tok/s "
        f"({1e3 * secs / st['steps']:.2f} ms per decode step, admissions "
        f"included), steps {st['steps']}, admissions {st['admitted']}, "
        f"layer fetches {fetches}, {fetched} bytes host-to-device = "
        f"{fetched / secs / 1e9:.2f} GB/s over the run, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB, launches {launches}")
    log(f"paged serve: ledger at peak pool occupancy "
        f"{json.dumps(server.tier_stats_peak())}")
    if [r.output for r in reqs] != want:
        raise AssertionError("paged serve: tokens differ from the resident "
                             "run's")
    if st["nonfinite_logits"]:
        raise AssertionError("paged serve: non-finite logits")
    if launches["paged_attention"] != cfg.num_layers * st["steps"]:
        raise AssertionError(f"paged serve: {launches['paged_attention']} "
                             f"K1 launches for {st['steps']} decode steps")
    if launches["flash_attention_mma"] or not launches[
            "flash_attention_wgmma"]:
        raise AssertionError(f"paged serve: K2 launches {launches}; every "
                             f"bf16 prefill must take the wgmma route")
    if fetches != cfg.num_layers * (st["steps"] + st["admitted"]):
        raise AssertionError(f"paged serve: {fetches} layer fetches for "
                             f"{st['steps']} steps + {st['admitted']} "
                             f"admissions")
    log("paged serve: tokens equal the resident run's; K1 once a layer a "
        "step; every layer fetched once a step and once an admission")
    return {"secs": secs, "steps": st["steps"], "tokens": tokens,
            "peak": peak}


def serve_config(torch, card: str, model, params, work, kw) -> dict:
    """One serving configuration, three runs of the workload: prefix
    cache on (timed, kernel counts reset just before and read just
    after), off, and on again; all three must emit the same tokens."""
    from repro_torch.kernels import (instance_counts, launch_counts,
                                     reset_launch_counts)
    from repro_torch.runtime.serve import BatchedServer
    kv, temperature = model.cfg.kv_dtype, kw["temperature"]
    kernel = "paged_attention" + ("" if kv is None else f"_{kv}")
    tag = f"kv_dtype={kv} temperature={temperature}"
    torch.cuda.reset_peak_memory_stats()
    server = BatchedServer(model, params, prefix_cache=True, **kw)
    reset_launch_counts()
    reqs, secs = serve(server, work, 64)
    launches, instances = launch_counts(), instance_counts()
    tokens = sum(len(r.output) for r in reqs)
    st = server.stats
    # KV bytes of one page in use, scales included
    server.manager.ensure(0, 1)
    per_page = server.kv_bytes_in_use() // server.manager.pages_in_use
    server.manager.free_slot(0)
    capture_bound(server, f"serve {tag}")
    log(f"serve {tag} [{card}]: {tokens} tokens in {secs:.3f} s = "
        f"{tokens / secs:.1f} tok/s ({1e3 * secs / st['steps']:.2f} ms per "
        f"decode step, admissions included; route {server.route}: "
        f"{st['graph_blocks']} of {st['blocks']} blocks replayed, "
        f"{st['compiles']} captures), steps {st['steps']}, prefix "
        f"hits {st['prefix_hits']} ({st['prefix_shared_pages']} pages), "
        f"kv_bytes_in_use/page {per_page}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}")
    if any(len(r.output) != 64 for r in reqs):
        raise AssertionError(f"{tag}: a request did not emit its 64 tokens")
    if st["nonfinite_logits"]:
        raise AssertionError(f"{tag}: {st['nonfinite_logits']} non-finite "
                             f"logits")
    if launches[kernel] != model.cfg.num_layers * st["steps"]:
        raise AssertionError(f"{tag}: {launches[kernel]} K1 launches for "
                             f"{st['steps']} decode steps, not one a layer")
    others = {k: n for k, n in launches.items()
              if k not in (kernel, "flash_attention_wgmma") and n}
    if launches["flash_attention_wgmma"] < 1 or others:
        raise AssertionError(f"{tag}: kernel launches {launches}; every "
                             f"bf16 prefill must take K2's wgmma route")
    if st["prefix_hits"] < 1:
        raise AssertionError(f"{tag}: the prefix pair did not share pages")

    unshared, secs2 = serve(BatchedServer(model, params, prefix_cache=False,
                                          **kw), work, 64)
    again, secs3 = serve(BatchedServer(model, params, prefix_cache=True,
                                       **kw), work, 64)
    log(f"serve {tag}: prefix cache off {tokens / secs2:.1f} tok/s, on "
        f"again {tokens / secs3:.1f} tok/s")
    if [r.output for r in reqs] != [r.output for r in unshared]:
        raise AssertionError(f"{tag}: prefix-shared tokens differ from "
                             f"unshared")
    if [r.output for r in reqs] != [r.output for r in again]:
        raise AssertionError(f"{tag}: a second run with the same seed gave "
                             f"other tokens")
    log(f"serve {tag}: prefix-shared tokens equal unshared tokens and a "
        f"second run's")
    mine = (kernel, "flash_attention_wgmma")
    return {"launches": {k: launches[k] for k in mine},
            "instances": {k: instances[k] for k in mine},
            "bytes_per_page": per_page, "tokens": [r.output for r in reqs]}


# ---------------------------------------------------------------------------
# the decode block as one CUDA graph
# ---------------------------------------------------------------------------

#: graph against eager: blocks of GRAPH_BLOCK steps from one prefilled
#: state of four GRAPH_PROMPT-token prompts; the first block of the graph
#: route runs eagerly (its warm-up), the second is captured and replayed,
#: the third replays
GRAPH_BLOCK = 4
GRAPH_BLOCKS = 3
GRAPH_PROMPT = 24
#: the budgets of the four slots: two drain inside the compared blocks
GRAPH_BUDGETS = (GRAPH_BLOCK * GRAPH_BLOCKS, GRAPH_BLOCK * GRAPH_BLOCKS, 7, 3)


def _tree_clone(torch, tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(torch, v) for k, v in tree.items()}
    return tree.clone()


def _bits(torch, t):
    """A tensor's bytes, for bit-equality of any dtype (fp8 included)."""
    return t.contiguous().view(torch.uint8)


def capture_bound(server, tag: str) -> None:
    """A server's captures stay within its page-table widths (one over
    the slab) x its one temperature mode, and every block it dispatched
    ran once, as a replay or eagerly; the route is the one its
    placement gives."""
    from repro_torch.runtime.decode_graph import choose_route
    st = server.stats
    bound = len(server._tables) if server.paged else 1
    want = choose_route(server.model, server.device)[0]
    if (st["compiles"] > bound or server.route != want
            or st["graph_blocks"] + st["eager_blocks"] != st["blocks"]):
        raise AssertionError(f"{tag}: route {server.route} (placement "
                             f"gives {want}), captures {st['compiles']} "
                             f"(bound {bound}), blocks {st['blocks']} = "
                             f"graph {st['graph_blocks']} + eager "
                             f"{st['eager_blocks']}?")


def graph_vs_eager(torch, card: str, tag: str, model, params, *,
                   temperature: float = 0.0, extra: dict | None = None,
                   paged: bool | None = None) -> list:
    """The decode block on both routes of ``make_decode_loop``, each on
    its own copy of one prefilled state (four GRAPH_PROMPT-token prompts,
    ``paged``: over the page pools, else the slab; ``extra`` the
    prefill's frames): GRAPH_BLOCKS blocks of GRAPH_BLOCK steps, a padded
    page-table delta before the second over pools.  Tokens, valid,
    poison, the final state and every cache leaf must be bit-equal, the
    graph route must capture once and replay twice, and each kernel's
    launches must equal the eager route's (K1 once a layer a step over
    pools, replays counted).  Logs each route's ms a step for the last
    block (a replay on the graph route).  Returns the problems found."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.base import DecodeState
    from repro_torch.runtime.serve import make_decode_loop
    cfg = model.cfg
    paged = model.supports_paged_kv() if paged is None else paged
    batch, steps = len(GRAPH_BUDGETS), GRAPH_BLOCK * GRAPH_BLOCKS
    total = GRAPH_PROMPT + steps
    rng = np.random.RandomState(17)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab, (
        batch, GRAPH_PROMPT)).astype(np.int32)).cuda()
    table = delta = None
    if paged:
        page = cfg.page_size
        per = -(-total // page)                  # pages a slot in all
        width = 1 << (per - 1).bit_length()      # the bucketed width
        pids = np.arange(1, batch * per + 1, dtype=np.int32).reshape(
            batch, per)
        pre = -(-(GRAPH_PROMPT + GRAPH_BLOCK) // page)
        host = np.zeros((batch, width), np.int32)
        host[:, :pre] = pids[:, :pre]
        table = torch.from_numpy(host).cuda()
        cache = model.init_paged_cache(batch * per + 1, device="cuda")
        logits, cache = model.prefill_paged(
            params, toks, cache, table[:, :-(-GRAPH_PROMPT // page)]
            .contiguous())
        # the rest of each slot's pages, and two padding entries (an
        # out-of-range column) that the scatter must drop
        rows, cols = np.nonzero(np.broadcast_to(np.arange(width) < per,
                                                (batch, width)))
        keep = cols >= pre
        d = np.stack([np.r_[rows[keep], 0, 1], np.r_[cols[keep], width,
                                                       width + 3],
                      np.r_[pids[rows[keep], cols[keep]], 7, 7]]
                     ).astype(np.int32)
        delta = tuple(torch.from_numpy(d).cuda())
    else:
        cache = model.init_cache(batch, total + 8, device="cuda")
        logits, cache = model.prefill(params, toks, cache, extra)
    base = prng.PRNGKey(0, "cuda")
    state = DecodeState(
        tokens=logits.float().argmax(-1),
        pos=torch.full((batch,), GRAPH_PROMPT, dtype=torch.int32,
                       device="cuda"),
        active=torch.ones(batch, dtype=torch.bool, device="cuda"),
        remaining=torch.tensor(GRAPH_BUDGETS, dtype=torch.int32,
                               device="cuda"),
        pages=table,
        slot_keys=torch.stack([prng.fold_in(base, u) for u in range(batch)]))
    runs = {}
    for graph in (True, False):
        c = _tree_clone(torch, cache)
        st = DecodeState(**{k: None if v is None else v.clone()
                            for k, v in vars(state).items()})
        loop = make_decode_loop(model, block_size=GRAPH_BLOCK,
                                temperature=temperature,
                                detect_nonfinite=True, graph=graph)
        outs = []
        torch.cuda.synchronize()
        reset_launch_counts()
        for i in range(GRAPH_BLOCKS):
            t0 = time.perf_counter()
            got = loop(params, c, st, delta if i == 1 else None)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if got[3] is not c or got[4] is not st:
                raise AssertionError(f"graph {tag}: the loop did not "
                                     f"return its donated inputs")
            # a graph's outputs live in its pool until its next replay
            outs.append([t.clone() for t in got[:3]])
        runs[graph] = (outs, c, st, launch_counts(), loop.blocks, secs)
    problems = []
    (g_outs, g_cache, g_st, g_n, g_blocks, g_s), \
        (e_outs, e_cache, e_st, e_n, e_blocks, e_s) = runs[True], runs[False]
    if (g_blocks.route, g_blocks.captures, g_blocks.replays,
            g_blocks.eager) != ("graph", 1, GRAPH_BLOCKS - 1, 1):
        problems.append(f"{tag}: graph route {g_blocks.route} captured "
                        f"{g_blocks.captures}, replayed {g_blocks.replays}, "
                        f"eager {g_blocks.eager}")
    for i, (g, e) in enumerate(zip(g_outs, e_outs)):
        for name, a, b in zip(("tokens", "valid", "poison"), g, e):
            if not torch.equal(a, b):
                problems.append(f"{tag}: block {i} {name} differ")
    if any(o[2].any() for o in e_outs):
        problems.append(f"{tag}: non-finite logits")
    for name in ("tokens", "pos", "active", "remaining", "pages",
                 "slot_keys"):
        a, b = getattr(g_st, name), getattr(e_st, name)
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            problems.append(f"{tag}: final state {name} differs")

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield "/".join(path + (k,)), v
    e_leaves = dict(leaves(e_cache))
    for name, a in leaves(g_cache):
        if not torch.equal(_bits(torch, a), _bits(torch, e_leaves[name])):
            problems.append(f"{tag}: cache leaf {name} differs")
    want_k1 = cfg.num_layers * steps if paged else 0
    k1 = sum(n for k, n in g_n.items() if k.startswith("paged_attention"))
    if g_n != e_n or k1 != want_k1:
        problems.append(f"{tag}: launches graph { {k: n for k, n in g_n.items() if n} } "
                        f"eager { {k: n for k, n in e_n.items() if n} }, "
                        f"K1 {k1} for {want_k1}")
    emitted = int(e_outs[-1][1].sum())
    log(f"graph {tag} [{card}]: {GRAPH_BLOCKS} blocks of {GRAPH_BLOCK} "
        f"steps, graph vs eager bit-equal" if not problems else
        f"graph {tag} [{card}]: PROBLEMS {problems}")
    log(f"graph {tag}: capture {g_blocks.capture_seconds:.3f} s, pool "
        f"{g_blocks.pool_bytes} bytes; last block (graph: a replay) "
        f"{1e3 * g_s / GRAPH_BLOCK:.3f} ms a step, eager "
        f"{1e3 * e_s / GRAPH_BLOCK:.3f} ms a step ({emitted} tokens "
        f"emitted in it); launches {({k: n for k, n in g_n.items() if n})}")
    return problems


#: the steady-state served run: Qwen2.5-14B resident, bf16 greedy; its
#: 520-token prompts and 480 new tokens keep the page table in one width
#: bucket (64 pages) for all 15 decode blocks
STEADY_KW = dict(batch_size=4, max_seq=1024, block_size=32, page_size=16,
                 seed=0, temperature=0.0)
STEADY_PROMPT = 520
STEADY_NEW = 480
#: the steady-state graph run's launches (kernel -> n; kernel ->
#: {instantiation -> n}) and those of them its replays made, for the
#: kernels line
GRAPH_RUN: dict = {}


def check_steady(torch, card: str, cfg, params) -> None:
    """The steady-state served run on both routes (``graph=True``, then
    ``graph=False``): the same tokens; the graph route captures once (one
    width bucket x one temperature mode), replays 14 blocks and runs one
    eagerly; K1 once a layer a step on both, replays counted.  Prints ms
    a step (admissions included), tok/s, captures and their seconds, the
    graph pool's bytes and peak device memory for each."""
    import numpy as np
    from repro_torch.kernels import (instance_counts, launch_counts,
                                     reset_launch_counts)
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    rng = np.random.RandomState(3)
    work = [rng.randint(1, cfg.vocab, STEADY_PROMPT).astype(np.int32)
            for _ in range(STEADY_KW["batch_size"])]
    blocks = -(-(STEADY_NEW - 1) // STEADY_KW["block_size"])
    out = {}
    for graph in (True, False):
        model = DenseLM(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        server = BatchedServer(model, params, graph=graph, **STEADY_KW)
        reset_launch_counts()
        reqs = [server.submit(p, max_new_tokens=STEADY_NEW) for p in work]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the admissions and the first two blocks (the graph route's
        # warm-up and capture), then the 13 blocks of steady decode
        server.run_once(max_blocks=2)
        torch.cuda.synchronize()
        t1, head = time.perf_counter(), server.stats["steps"]
        server.run_once()
        torch.cuda.synchronize()
        secs, decode_s = time.perf_counter() - t0, time.perf_counter() - t1
        n, st, b = launch_counts(), server.stats, server._loop.blocks
        tokens = sum(len(r.output) for r in reqs)
        route = server.route
        tail = st["steps"] - head
        log(f"steady {route} [{card}]: {tokens} tokens in {secs:.3f} s = "
            f"{tokens / secs:.2f} tok/s ({1e3 * secs / st['steps']:.3f} ms "
            f"a decode step, 4 admissions of {STEADY_PROMPT} tokens "
            f"included); blocks 3-{st['blocks']}: {tail} steps in "
            f"{decode_s:.3f} s = {1e3 * decode_s / tail:.3f} ms a step, "
            f"{4 * tail / decode_s:.2f} tok/s; steps {st['steps']}, blocks "
            f"{st['blocks']} "
            f"(graph {st['graph_blocks']}, eager {st['eager_blocks']}), "
            f"captures {st['compiles']} in {b.capture_seconds:.3f} s, "
            f"graph pool {b.pool_bytes} bytes, table widths "
            f"{sorted(server._tables)}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, K1 "
            f"{n['paged_attention']}")
        if any(len(r.output) != STEADY_NEW or r.error for r in reqs):
            raise AssertionError(f"steady {route}: a request did not emit "
                                 f"its {STEADY_NEW} tokens")
        if n["paged_attention"] != cfg.num_layers * st["steps"]:
            raise AssertionError(f"steady {route}: {n['paged_attention']} "
                                 f"K1 launches for {st['steps']} steps")
        want = ((1, blocks - 1, 1) if graph else (0, 0, blocks))
        got = (st["compiles"], st["graph_blocks"], st["eager_blocks"])
        if route != ("graph" if graph else "eager") or got != want or \
                st["table_rebuilds"] != 1:
            raise AssertionError(f"steady {route}: (captures, graph blocks, "
                                 f"eager blocks) {got}, want {want}; table "
                                 f"rebuilds {st['table_rebuilds']}")
        out[graph] = ([r.output for r in reqs], decode_s / tail)
        if graph:
            GRAPH_RUN.update(total=n, by_instance=instance_counts(),
                             replayed=dict(b.replayed),
                             replay_ms=1e3 * decode_s / tail)
        del server
    if out[True][0] != out[False][0]:
        raise AssertionError("steady: the graph route's tokens differ from "
                             "the eager route's")
    log(f"steady [{card}]: tokens equal on both routes; blocks 3-15, graph "
        f"{1e3 * out[True][1]:.3f} ms a step against eager "
        f"{1e3 * out[False][1]:.3f} ms ({out[False][1] / out[True][1]:.2f}x)")


def profile_graph(torch, card: str, cfg, params) -> None:
    """A traced graph-route block: the steady-state server warmed by one
    run of 64 new tokens (its warm-up block and its capture), then four
    new requests of the same shape admitted untraced and one block of
    decode traced, a replay: the device's busy share of the block's wall
    time, and device time by kernel.  (Tracing the admissions too makes
    ~10^6 events, which the profiler takes minutes to sum.)"""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    rng = np.random.RandomState(4)
    server = BatchedServer(DenseLM(cfg), params, **STEADY_KW)
    work = [rng.randint(1, cfg.vocab, STEADY_PROMPT).astype(np.int32)
            for _ in range(2 * STEADY_KW["batch_size"])]
    serve(server, work[:4], 64)
    reqs = [server.submit(p, max_new_tokens=64) for p in work[4:]]
    server.run_once(max_blocks=0)             # the admissions, untraced
    before = dict(server.stats)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_once(max_blocks=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    server.run_once()
    st = server.stats
    steps = st["steps"] - before["steps"]
    if (st["compiles"] != before["compiles"] or st["graph_blocks"]
            != before["graph_blocks"] + 2 or any(len(r.output) != 64
                                                 for r in reqs)):
        raise AssertionError(f"profile graph: the traced block was not a "
                             f"replay: {before} -> {st}")
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev, ev.key, ev.count))
    busy = sum(r[0] for r in rows) / 1e6
    traced = STEADY_KW["block_size"]
    log(f"profile graph route [{card}]: one replayed block of {traced} "
        f"decode steps ({STEADY_PROMPT}-token prompts, batch 4) in "
        f"{secs:.3f} s wall ({1e3 * secs / traced:.3f} ms a step, traced); "
        f"device busy {busy:.3f} s ({100 * busy / secs:.1f}%); the run's "
        f"{steps} steps untraced otherwise")
    for dev, key, count in sorted(rows, reverse=True)[:14]:
        log(f"  {dev / 1e3:10.2f} ms  {100 * dev / 1e6 / busy:5.1f}%  "
            f"x{count:<6d} {key[:90]}")


# ---------------------------------------------------------------------------
# MoE serving with expert paging
# ---------------------------------------------------------------------------

#: the moe phase's resident runs: (kv_dtype, temperature)
MOE_RUNS = ((None, 0.0), (None, 0.7), ("int8", 0.7))


def granite_params(torch):
    """granite-moe-3b-a800m at its published widths and full depth (32
    layers, d 1536, 24/8 heads, 40 experts top-8 of d_ff 512, vocab
    49155), tp=1, random bf16 weights from a seeded torch.Generator on
    the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoELM
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), tp=1)
    t0 = time.perf_counter()
    params = MoELM(cfg).init(0, device="cuda")
    torch.cuda.synchronize()
    log(f"moe: {cfg.name} tp=1 layers={cfg.num_layers} d={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} experts={cfg.num_experts}"
        f" top-{cfg.top_k} d_ff={cfg.d_ff} vocab={cfg.vocab} (padded "
        f"{cfg.padded_vocab}): {sum(t.numel() for t in _leaves(params)) / 1e9:.3f}"
        f" B params, {sum(t.numel() * t.element_size() for t in _leaves(params))}"
        f" bytes, init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def _no_sync_decode_step(torch, model, params) -> int:
    """One decode step of ``model`` at batch 4 under
    ``torch.cuda.set_sync_debug_mode("warn")``: the number of host syncs
    it asked for (after a warm-up step)."""
    import warnings
    cache = model.init_paged_cache(9, device="cuda")
    pages = torch.arange(1, 9, dtype=torch.int32, device="cuda").reshape(4, 2)
    tokens = torch.tensor([[5], [17], [123], [9]], device="cuda")
    pos = torch.tensor([3, 7, 12, 20], dtype=torch.int32, device="cuda")
    model.decode_step(params, tokens, cache, pos, pages)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.decode_step(params, tokens, cache, pos, pages)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    for msg in syncs[:3]:
        log(f"  sync: {msg[:160]}")
    return len(syncs)


def packed_dispatch_bits(torch, cfg, lp: dict, batch: int) -> None:
    """Log whether a decode step's packed dispatch (routed experts'
    rows copied into min(N, E) + 1 slots, GEMMs batched over those) gives
    the resident dispatch's bits (GEMMs batched over all E): cuBLAS may
    pick another kernel for another batch count."""
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(3)
    xt = (torch.randn((batch, cfg.d_model), generator=gen, device="cuda")
          * 0.5).to(cfg.dtype)
    routing = moe.route(lp["router"], xt, cfg)
    ids = routing[1].reshape(-1)
    mask = torch.zeros(cfg.padded_experts, dtype=torch.bool, device="cuda")
    mask[ids] = True
    rows, slots = _slot_map(torch, mask, ids.numel())
    order = torch.full((rows,), int(mask.nonzero()[0, 0]), device="cuda")
    order[slots[mask].long()] = mask.nonzero()[:, 0]
    packed = {n: lp[n][order] for n in ("wi", "wg", "wo")}
    a = moe.dispatch(lp, xt, routing)
    b = moe.dispatch(packed, xt, routing, slots)
    log(f"moe: one layer's dispatch at batch {batch}, packed into {rows} "
        f"slots against all {cfg.padded_experts} experts: bit-equal "
        f"{torch.equal(a, b)}, max |diff| "
        f"{(a.float() - b.float()).abs().max().item():.3e}")


def check_moe(torch, card: str, counts: Launches) -> None:
    """granite-moe-3b-a800m at full width and depth through
    ``BatchedServer`` on the serve phase's workload (four 8-token
    prompts, 64 new tokens, batch 4, block 32, max_seq 384, page 16,
    seed 0).  Resident: bf16 greedy and at 0.7, int8 pools at 0.7.  Then
    the expert banks move to mapped pinned host memory
    (``page_experts``): bf16 greedy and 0.7 with the layer pager off,
    greedy with it on (the rest of each layer paged by the Tensor
    Prefetcher), each with the resident run's tokens.  Every run: K1 32
    times a decode step, K2 32 times an admission on the wgmma route;
    expert-paged, the expert gather once a layer a step and an
    admission, its counted bytes = the routed experts x 4,718,592, at
    most min(B k, E) experts routed in one gather, the staging alive at
    every gather of a decode step equal to the ledger's live
    ``expert_weights`` line for it, min(B k, E) + 1 rows a bank (33 of
    40 at batch 4; 9 in a batch-1 run), byte for byte, and the most
    staging ever alive equal to the ledger's capacity line (41 rows: an
    admission routes N = 64); one expert-paged decode step asks for no
    host sync; every gather takes the route ``plan`` gives the placed
    banks.  Before the paged runs it logs whether one layer's packed
    dispatch (batches of S = 33 experts) gives the bits of the resident
    one (batches of E = 40), at a decode step's shapes."""
    import dataclasses
    from repro_torch.kernels import instance_counts
    from repro_torch.kernels.expert_gather import kernel as EG
    from repro_torch.memory import LOCAL, REMOTE
    from repro_torch.models.moe import MoELM
    from repro_torch.runtime.serve import BatchedServer
    cfg, params = granite_params(torch)
    work = prompts(cfg.vocab, 0)[:4]
    e, k, layers = cfg.padded_experts, cfg.top_k, cfg.num_layers
    row = 3 * cfg.d_model * cfg.d_ff * cfg.dtype.itemsize   # 4,718,592
    bank = e * row                                         # one layer
    batch = SERVE_KW["batch_size"]
    problems, resident, peak = [], {}, {}

    def serve_run(model, prms, temperature, tag):
        torch.cuda.reset_peak_memory_stats()
        server = BatchedServer(model, prms,
                               **dict(SERVE_KW, temperature=temperature))
        server.tag = tag
        toks, secs, got = counts.run(torch, server, work)
        st = server.stats
        tokens = sum(len(t) for t in toks)
        peak[tag] = torch.cuda.max_memory_allocated()
        log(f"moe {tag} [{card}]: {tokens} tokens in {secs:.3f} s = "
            f"{tokens / secs:.1f} tok/s ({1e3 * secs / st['steps']:.2f} ms "
            f"per decode step, admissions included), steps {st['steps']}, "
            f"admissions {st['admitted']}, max_memory_allocated "
            f"{peak[tag] / 2**30:.3f} GiB, launches "
            f"{ {n: c for n, c in got.items() if c} }")
        return toks, server, got, secs

    for kv, temperature in MOE_RUNS:
        tag = f"resident kv_dtype={kv} temperature={temperature}"
        toks, _, got, _ = serve_run(
            MoELM(dataclasses.replace(cfg, kv_dtype=kv)), params,
            temperature, tag)
        if got["expert_gather"]:
            problems.append(f"{tag}: {got['expert_gather']} expert gathers")
        resident[kv, temperature] = toks
    problems += graph_vs_eager(torch, card, "granite-moe-3b-a800m resident",
                               MoELM(cfg), params)

    def staging_gates(model, tag, b):
        """F3: the staging alive at each gather of a decode step (N = b
        k rows) is the ledger's live line for it, (min(N, E) + 1) rows a
        bank, byte for byte; the most ever alive is the capacity line."""
        ep, led = model.mem.expert_policy, model.mem.ledger
        n = b * k
        live = led.classes(LOCAL).get("expert_weights", 0)
        cap = led.capacities(LOCAL).get("expert_weights", 0)
        want = (min(n, e) + 1) * row
        lo, hi = ep.live_at_gather.get(n, (None, None))
        log(f"moe {tag}: staging alive at a decode step's gathers {lo}.."
            f"{hi} bytes = {(hi or 0) / bank:.3f} of a layer's bank; the "
            f"ledger's live expert_weights {live} ({min(n, e) + 1} of {e} "
            f"rows: {want}); peak staging {ep.staging_peak} against the "
            f"capacity line {cap}; remote expert_weights "
            f"{led.classes(REMOTE).get('expert_weights')} bytes at rest "
            f"({layers} x {bank})")
        if not lo == hi == live == want:
            problems.append(f"{tag}: staging alive {lo}..{hi}, ledger live "
                            f"{live}, {min(n, e) + 1} rows {want}")
        if ep.staging_peak != cap:
            problems.append(f"{tag}: peak staging {ep.staging_peak}, "
                            f"capacity line {cap}")

    def paged_run(model, prms, temperature, tag):
        ep = model.mem.expert_policy
        ep.reset_stats()
        toks, server, got, secs = serve_run(model, prms, temperature, tag)
        routes = instance_counts()["expert_gather"]
        log(f"moe {tag}: gathers by route {routes}")
        if set(routes) != {route}:
            problems.append(f"{tag}: gathers by route {routes}, not all on "
                            f"{route}")
        st = server.stats
        stats = ep.gather_stats()
        n_gathers = sum(r["gathers"] for r in stats.values())
        if not (got["expert_gather"] == n_gathers
                == layers * (st["steps"] + st["admitted"])):
            problems.append(f"{tag}: {got['expert_gather']} gather launches,"
                            f" {n_gathers} gathers, {st['steps']} steps + "
                            f"{st['admitted']} admissions")
        for n, r in sorted(stats.items()):
            what = "decode step" if n == batch * k else f"call of {n} rows"
            log(f"moe {tag}: a {what} ({n} = tokens x top-{k}): "
                f"{r['gathers']} gathers, {r['routed_experts'] / r['gathers']:.2f}"
                f" experts staged a layer, {r['staged_bytes']} bytes staged "
                f"= {r['routed_experts']} routed x {row}: "
                f"{r['staged_bytes'] == r['routed_experts'] * row}")
            if r["staged_bytes"] != r["routed_experts"] * row:
                problems.append(f"{tag}: staged {r['staged_bytes']} bytes "
                                f"for {r['routed_experts']} routed experts")
            log(f"moe {tag}: at most {r['max_routed']} experts routed in "
                f"one gather of {n} rows (bound min(N, E) = {min(n, e)})")
            if not 1 <= r["max_routed"] <= min(n, e):
                problems.append(f"{tag}: {r['max_routed']} experts routed "
                                f"in one gather of {n} rows")
        dec = stats.get(batch * k)
        if dec:
            per_step = dec["staged_bytes"] / (dec["gathers"] / layers)
            log(f"moe {tag}: {per_step / 1e9:.3f} GB staged a decode step; "
                f"all staged bytes over the run's wall time "
                f"{sum(r['staged_bytes'] for r in stats.values()) / secs / 1e9:.2f}"
                f" GB/s")
        staging_gates(model, tag, server.batch)
        if toks != resident[None, temperature]:
            problems.append(f"{tag}: tokens differ from the resident run's")
        else:
            log(f"moe {tag}: tokens equal the resident run's")
        return server

    packed_dispatch_bits(torch, cfg, params["layers"][0]["moe"], batch)

    # banks to mapped pinned host memory; the device copies are freed
    model = MoELM(cfg.with_pager(page_experts=True))
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = dict(params, layers=model.mem.place_layer_weights(
        params["layers"]))
    torch.cuda.synchronize()
    banks = params["layers"][0]["moe"]
    route = EG.plan([banks[n].device for n in ("wi", "wg", "wo")],
                    torch.device("cuda", 0))
    log(f"moe: banks placed in {time.perf_counter() - t0:.1f} s; pinned "
        f"{all(banks[n].is_pinned() for n in ('wi', 'wg', 'wo'))}; device "
        f"memory allocated {before / 2**30:.3f} -> "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    syncs = _no_sync_decode_step(torch, model, params)
    log(f"moe: one expert-paged decode step asked for {syncs} host syncs; "
        f"gather route {route}")
    if syncs:
        problems.append(f"an expert-paged decode step synced {syncs} times")
    for temperature in (0.0, 0.7):
        paged_run(model, params, temperature,
                  f"expert-paged temperature={temperature}")
    # batch 1: (top_k + 1) rows a bank
    model.mem.expert_policy.reset_stats()
    one = BatchedServer(model, params, **dict(SERVE_KW, batch_size=1))
    serve(one, work[:1], 8)
    staging_gates(model, "expert-paged batch 1", 1)
    del one          # its params hold the attention weights on the card

    # the rest of each layer paged too (the banks stay where they are)
    model = MoELM(cfg.with_pager(enabled=True, lookahead=1,
                                 page_experts=True))
    params = dict(params, layers=model.mem.place_layer_weights(
        params["layers"]))
    torch.cuda.synchronize()
    pf, led = model.mem.prefetcher, model.mem.ledger
    fetches = pf.fetches
    server = paged_run(model, params, 0.0,
                       "expert-paged + paged layers temperature=0.0")
    st = server.stats
    window = led.classes(LOCAL)["layer_weights_window"]
    rest = led.classes(REMOTE)["layer_weights"]
    log(f"moe paged layers: window {window} bytes = 2 x {rest // layers} "
        f"(a layer without its banks), allocated {pf.window_bytes}; "
        f"{pf.fetches - fetches} layer fetches")
    if (window != 2 * (rest // layers) or pf.fetches - fetches
            != layers * (st["steps"] + st["admitted"])):
        problems.append("paged layers: window or fetches wrong")
    log(f"moe peak device memory [{card}] (max_memory_allocated, GiB): "
        + ", ".join(f"{t} {b / 2**30:.3f}" for t, b in peak.items()))
    if problems:
        raise AssertionError("moe phase: " + "; ".join(problems))
    log("moe: every gate held")


# ---------------------------------------------------------------------------
# GPT-3 175B at full width, and the dense cache
# ---------------------------------------------------------------------------

#: gpt3-175b's depth on one card: 8 of its 96 layers (a layer is
#: 1,811,939,328 params, 3.62 GB in bf16: the whole model is 348 GB)
GPT3_LAYERS = 8
#: new tokens a request in the gpt3 phase: the serve phase's 64, cut to
#: one decode block (a paged step reads 29 GB over PCIe)
GPT3_NEW = 32


def host_mem(field: str = "MemTotal") -> str:
    """A ``/proc/meminfo`` field of the host, as the kernel says it."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith(field + ":"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def check_gpt3(torch, card: str, counts: Launches) -> None:
    """gpt3-175b at its published widths (d 12288, 96/96 heads: MHA, G =
    1, head dim 128, d_ff 32768, vocab 50257) and 8 of its 96 layers,
    tp=1, random bf16 weights, on the serve phase's four 8-token prompts
    (32 new tokens, batch 4, block 32, max_seq 384, page 16, seed 0):
    resident, greedy and at 0.7; then greedy with the layers moved to
    pinned host memory and paged back by the Tensor Prefetcher, with the
    resident run's tokens.  Every run: K1 once a layer a decode step on
    its 8-row instantiation (G = 1, Hkv = 96), K2 once a layer an
    admission on the wgmma route at d = 128, none on mma; paged, every
    layer fetched once a step and once an admission.  Prints tok/s, ms a
    step and peak device memory beside each run's floor: a resident step
    reads every layer and the head from HBM (3.35 TB/s), a paged one the
    layers over PCIe Gen5 x16 (64 GB/s)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import instance_counts
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    full = get_config("gpt3-175b")
    cfg = dataclasses.replace(full, tp=1, num_layers=GPT3_LAYERS)
    t0 = time.perf_counter()
    model = DenseLM(cfg)
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    layer = _nbytes(params["layers"][0])
    layers = layer * cfg.num_layers
    embed, head = (_nbytes(params["embed"][n]) for n in ("tok", "head"))
    log(f"gpt3: {cfg.name} tp=1 d={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} (G = {cfg.q_per_kv}) head_dim={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab} (padded {cfg.padded_vocab}); "
        f"REDUCED depth: {cfg.num_layers} of {full.num_layers} layers, "
        f"{layer} bytes a layer, {layers} in all, embedding {embed} and "
        f"head {head} (the full model {full.num_layers * layer + embed + head}"
        f" bytes); host MemTotal {host_mem()}; init "
        f"{time.perf_counter() - t0:.1f} s")
    work = prompts(cfg.vocab, 0)[:4]
    L = cfg.num_layers
    floor_ms = 1e3 * (layers + head) / HBM_BYTES_PER_S
    problems, resident = [], {}
    for temperature in (0.0, 0.7):
        torch.cuda.reset_peak_memory_stats()
        server = BatchedServer(model, params,
                               **dict(SERVE_KW, temperature=temperature))
        server.tag = tag = f"resident temperature={temperature}"
        toks, secs, got = counts.run(torch, server, work, GPT3_NEW)
        inst, st = instance_counts(), server.stats
        tokens = sum(len(t) for t in toks)
        log(f"gpt3 {tag} [{card}]: {tokens} tokens in {secs:.3f} s = "
            f"{tokens / secs:.2f} tok/s ({1e3 * secs / st['steps']:.2f} ms a "
            f"decode step, admissions included; floor {floor_ms:.2f} ms: "
            f"{(layers + head) / 1e9:.2f} GB at 3.35 TB/s), steps "
            f"{st['steps']}, admissions {st['admitted']}, "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"by instantiation K1 {inst['paged_attention']} K2 "
            f"{inst['flash_attention_wgmma']}")
        if (inst["paged_attention"] != {"rows=8": L * st["steps"]}
                or inst["flash_attention_wgmma"]
                != {"d=128": L * st["admitted"]}):
            problems.append(f"{tag}: launches {inst}")
        resident[temperature] = toks
    problems += graph_vs_eager(torch, card, "gpt3-175b resident", model,
                               params)
    run = serve_paged(torch, card, DenseLM(cfg.with_pager(enabled=True,
                                                          lookahead=1)),
                      params, work, dict(SERVE_KW, temperature=0.0),
                      resident[0.0], GPT3_NEW)
    paged_floor = layers / PCIE_BYTES_PER_S
    log(f"gpt3 paged [{card}]: {run['tokens'] / run['secs']:.2f} tok/s, "
        f"{run['secs'] / run['steps']:.3f} s a decode step (admissions "
        f"included; floor {paged_floor:.3f} s: {layers / 1e9:.2f} GB at 64 "
        f"GB/s), max_memory_allocated {run['peak'] / 2**30:.2f} GiB")
    if problems:
        raise AssertionError("gpt3 phase: " + "; ".join(problems))
    log("gpt3: every gate held")


# ---------------------------------------------------------------------------
# the hybrid, ssm and encdec families at full width
# ---------------------------------------------------------------------------

#: new tokens a request in the families phase: one decode block
FAMILIES_NEW = 32
#: recurrentgemma-9b's long prompt: past its 2048-slot window, batch 1
LONG_PROMPT, LONG_MAX_SEQ, LONG_NEW = 2100, 2200, 16


def _state_bytes(model, max_seq: int) -> dict:
    """A slot's slab bytes by leaf name, summed over the layers."""
    out: dict = {}
    for leaves in model.cache_shapes(1, max_seq).values():
        for name, (shape, dt) in leaves.items():
            out[name] = out.get(name, 0) + dt.itemsize * math.prod(shape)
    return out


def _greedy_loop(torch, model, params, prompts_, new: int, max_seq: int):
    """Model-level greedy generation of ``prompts_`` (equal lengths) as a
    server batches them: each prompt's ``prefill`` into a fresh batch-1
    slab, spliced into row b of a batch-B slab (the batch axis found per
    leaf), then B-row ``decode_step``s feeding each token back.  Returns
    (the tokens, a list a prompt; the logits of request 0's first decode
    step at batch B and, from its own batch-1 slab, at batch 1)."""
    from repro_torch.models.transformer import sample_tokens
    vocab, b = model.cfg.vocab, len(prompts_)
    cache = model.init_cache(b, max_seq, device="cuda")

    def splice(big: dict, small: dict, row: int) -> None:
        for name, leaf in big.items():
            if isinstance(leaf, dict):
                splice(leaf, small[name], row)
                continue
            diff = [i for i, (x, y) in enumerate(zip(leaf.shape,
                                                     small[name].shape))
                    if x != y]
            leaf.copy_(small[name]) if not diff else leaf.narrow(
                diff[0], row, 1).copy_(small[name])

    firsts = []
    for row, prompt in enumerate(prompts_):
        small = model.init_cache(1, max_seq, device="cuda")
        logits, small = model.prefill(
            params, torch.from_numpy(prompt[None]).to("cuda"), small)
        firsts.append(sample_tokens(logits, vocab))
        splice(cache, small, row)
        if row == 0:
            first_slab = small
    nxt = torch.cat(firsts)
    out, s = [nxt], len(prompts_[0])
    for i in range(new - 1):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        logits, cache = model.decode_step(params, nxt, cache, pos)
        if i == 0:
            at_b = logits[:1].float().cpu()
            at_1 = model.decode_step(params, nxt[:1], first_slab,
                                     pos[:1])[0].float().cpu()
        nxt = sample_tokens(logits, vocab)
        out.append(nxt)
    return torch.cat(out, dim=1).tolist(), (at_b, at_1)


def _hold_to_loop(tag: str, got: list, want: list, problems: list,
                  bit_equal: bool) -> None:
    """Server tokens against the model-level loop's: bit-equal when the
    two batch alike, else the first-8 rule; the rate is logged."""
    rate = _match_first8(got, want)
    gate = "bit-equal" if bit_equal else f"first-8 >= {MATCH_FIRST8}"
    log(f"families {tag}: server tokens against the model-level prefill + "
        f"decode_step loop: first-8 match rate {rate:.3f}, bit-equal: "
        f"{got == want} (gate: {gate})")
    if (got != want) if bit_equal else rate < MATCH_FIRST8:
        problems.append(f"{tag}: first-8 rate {rate:.3f} against the loop")


#: the families phase's recurrentgemma-9b depth: 4 of its 12 (rec, rec,
#: att) groups and its tail (its gates scale with the groups); cut from
#: 38 when the tp phase took both notices and a card ~1.45x slower in
#: every phase ran the default run past 1040 s of phases
FAMILIES_RG_LAYERS = 14


def check_recurrentgemma(torch, card: str, counts: Launches,
                         problems: list) -> None:
    """recurrentgemma-9b at full width and ``FAMILIES_RG_LAYERS`` of its
    38 layers (4 of its 12 (rec, rec, att) groups and its 2-rec tail; d
    4096, 16/1 heads, d_head 256, d_ff 12288, vocab 256000; tp=1, random
    bf16 weights) through
    ``BatchedServer`` over its slab of recurrent state and windows, on
    the serve phase's four 8-token prompts (32 new tokens, batch 4, block
    32, max_seq 384, seed 0): greedy and at 0.7, K1 never, K2 once an att
    layer an admission on wgmma at d = 256; the greedy tokens
    held to the model-level loop at batch 1.  One 2100-token prompt at
    batch 1 (max_seq 2200: its 2048 window slots roll), 16 new tokens,
    held the same way.  Then greedy with the groups paged from pinned
    host memory (lookahead 1; the tail, embedding and head resident):
    the resident tokens, every group fetched once a step and once an
    admission.  Frees its weights."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import instance_counts
    from repro_torch.memory import LOCAL, REMOTE, PinLocal
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.runtime.serve import BatchedServer
    full = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(full, tp=1, num_layers=FAMILIES_RG_LAYERS)
    log(f"families: DEPTH CUT: recurrentgemma-9b at full width and "
        f"{cfg.num_layers} of {full.num_layers} layers")
    t0 = time.perf_counter()
    model = HybridLM(cfg)
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    groups, rest = _nbytes(params["groups"]), _nbytes(
        {k: v for k, v in params.items() if k != "groups"})
    att = model.n_groups * cfg.block_pattern.count("att") + \
        model.tail.count("att")
    state = _state_bytes(model, SERVE_KW["max_seq"])
    rec = state["h"] + state["conv"]
    dense_kv = 2 * 48 * 8 * 128 * 2 * SERVE_KW["max_seq"]
    log(f"families recurrentgemma-9b [{card}]: {cfg.num_layers} layers = "
        f"{model.n_groups} x {cfg.block_pattern} + tail {model.tail}, d "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_head "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; groups "
        f"{groups} bytes, tail + embedding + head {rest}; init "
        f"{time.perf_counter() - t0:.1f} s; a slot's slab at max_seq "
        f"{SERVE_KW['max_seq']}: recurrent state {rec} bytes (h "
        f"{state['h']}, conv {state['conv']}), attention windows "
        f"{state['k'] + state['v']} ({att} layers x min(max_seq, "
        f"{cfg.sliding_window}) slots), against {dense_kv} bytes of "
        f"Qwen2.5-14B's KV at the same length; at a full window "
        f"{sum(_state_bytes(model, cfg.sliding_window).values())} bytes")
    work = prompts(cfg.vocab, 0)[:4]
    resident = {}
    for temperature in (0.0, 0.7):
        torch.cuda.reset_peak_memory_stats()
        server = BatchedServer(model, params,
                               **dict(SERVE_KW, temperature=temperature))
        server.tag = tag = f"recurrentgemma-9b temperature={temperature}"
        toks, secs, _ = counts.run(torch, server, work, FAMILIES_NEW,
                                   attn_layers=att)
        inst, st = instance_counts(), server.stats
        tokens = sum(len(t) for t in toks)
        log(f"families {tag} [{card}]: {tokens} tokens in {secs:.3f} s = "
            f"{tokens / secs:.2f} tok/s ({1e3 * secs / st['steps']:.2f} ms a "
            f"decode step, admissions included), steps {st['steps']}, "
            f"admissions {st['admitted']}, slab {server.kv_bytes_capacity()}"
            f" bytes, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K2 "
            f"{inst['flash_attention_wgmma']}")
        if inst["flash_attention_wgmma"] != {
                f"d={cfg.head_dim}": att * st["admitted"]}:
            problems.append(f"{tag}: K2 launches {inst}")
        resident[temperature] = toks
    problems += graph_vs_eager(torch, card, "recurrentgemma-9b", model,
                               params)
    # the server at batch 4 against the loop batched as it is; at batch 1
    # (four requests in turn) against the loop at batch 1, the first-8
    # rule; the batch-4 run against the batch-1 loop is logged with one
    # decode step's logit gap between the two batchings (cuBLAS rounds a
    # 4-row and a 1-row product apart, and random layers amplify it)
    loop4, (at_4, at_1) = _greedy_loop(torch, model, params, work,
                                       FAMILIES_NEW, SERVE_KW["max_seq"])
    _hold_to_loop("recurrentgemma-9b greedy, batch 4", resident[0.0], loop4,
                  problems, bit_equal=True)
    loop1 = [_greedy_loop(torch, model, params, [p], FAMILIES_NEW,
                          SERVE_KW["max_seq"])[0][0] for p in work]
    server = BatchedServer(model, params, **dict(SERVE_KW, batch_size=1))
    server.tag = "recurrentgemma-9b greedy, batch 1"
    one, _, _ = counts.run(torch, server, work, FAMILIES_NEW,
                           attn_layers=att)
    _hold_to_loop("recurrentgemma-9b greedy, batch 1", one, loop1, problems,
                  bit_equal=False)
    log(f"families recurrentgemma-9b: the batch-4 run against the batch-1 "
        f"loop: first-8 match rate {_match_first8(resident[0.0], loop1):.3f}"
        f", bit-equal {resident[0.0] == loop1}; one decode step from the "
        f"same slab, request 0's logits at batch 4 against batch 1: max "
        f"|dlogit| {(at_4 - at_1).abs().max().item():.4g}")

    long_prompt = np.random.RandomState(7).randint(
        1, cfg.vocab, LONG_PROMPT).astype(np.int32)
    server = BatchedServer(model, params, **dict(
        SERVE_KW, batch_size=1, max_seq=LONG_MAX_SEQ))
    server.tag = tag = f"recurrentgemma-9b {LONG_PROMPT}-token prompt"
    torch.cuda.reset_peak_memory_stats()
    toks, secs, _ = counts.run(torch, server, [long_prompt], LONG_NEW,
                               attn_layers=att)
    slab = server.cache["b2"]["k"]
    cache = model.init_cache(1, LONG_MAX_SEQ, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, torch.from_numpy(long_prompt[None]).to("cuda"),
                  cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del cache
    log(f"families {tag} [{card}]: batch 1, max_seq {LONG_MAX_SEQ}, "
        f"{LONG_NEW} new tokens in {secs:.3f} s (the prefill included; "
        f"one prefill alone {1e3 * prefill_s:.1f} ms), "
        f"window slab {tuple(slab.shape)} (rolls: {slab.shape[3]} = "
        f"{cfg.sliding_window} slots), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if slab.shape[3] != cfg.sliding_window:
        problems.append(f"{tag}: the window slab has {slab.shape[3]} slots")
    _hold_to_loop(tag, toks, _greedy_loop(
        torch, model, params, [long_prompt], LONG_NEW, LONG_MAX_SEQ)[0],
        problems, bit_equal=False)
    del server, slab

    # offload_kv planned from the start: the paged-groups run below keeps
    # its slab in device memory (the kv_pool policy PinLocal while it
    # places it), the offload run that follows rests it in pinned host
    # memory on the same placed groups
    paged = HybridLM(cfg.with_pager(enabled=True, lookahead=1,
                                    offload_kv=True))
    mem = paged.mem
    t0 = time.perf_counter()
    params["groups"] = mem.place_layer_weights(params["groups"])
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    pf = mem.prefetcher
    if pf is None or mem.degraded or not all(
            p.buffer.is_pinned() for p in params["groups"].packed):
        raise AssertionError(f"families: group placement {mem.describe()}")
    led = mem.ledger
    log(f"families recurrentgemma-9b paged [{card}]: placed "
        f"{model.n_groups} groups in {place_s:.1f} s; ledger remote "
        f"layer_weights {led.classes(REMOTE)['layer_weights']}, local "
        f"layer_weights_window {led.classes(LOCAL)['layer_weights_window']}"
        f" (2 groups); device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    policy, mem.policies["kv_pool"] = mem.policies["kv_pool"], PinLocal()
    try:
        server = BatchedServer(paged, params,
                               **dict(SERVE_KW, temperature=0.0))
    finally:
        mem.policies["kv_pool"] = policy
    server.tag = tag = "recurrentgemma-9b paged groups greedy"
    fetches, fetched = pf.fetches, pf.fetched_bytes
    toks, secs, _ = counts.run(torch, server, work, FAMILIES_NEW,
                               attn_layers=att)
    fetches, fetched = pf.fetches - fetches, pf.fetched_bytes - fetched
    st = server.stats
    floor = groups / PCIE_BYTES_PER_S
    log(f"families {tag} [{card}]: {sum(len(t) for t in toks) / secs:.2f} "
        f"tok/s, {secs / st['steps']:.3f} s a decode step (admissions "
        f"included; floor {floor:.3f} s: {groups / 1e9:.2f} GB at 64 GB/s), "
        f"{1e3 * secs / (st['steps'] + st['admitted']):.2f} ms a pass, "
        f"group fetches {fetches} for {st['steps']} steps + "
        f"{st['admitted']} admissions, {fetched} bytes host-to-device = "
        f"{_gbps(fetched, secs)} GB/s over the run, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if toks != resident[0.0]:
        problems.append(f"{tag}: tokens differ from the resident run's")
    if fetches != model.n_groups * (st["steps"] + st["admitted"]):
        problems.append(f"{tag}: {fetches} group fetches")
    del server
    offload_serve(torch, card, counts, paged, params, work,
                  {0.0: resident[0.0]}, problems, FAMILIES_OFFLOAD_NEW,
                  attn_layers=att)
    del params, paged, mem, pf
    gc.collect()


#: new tokens a request of recurrentgemma-9b's offload_kv run (its
#: groups paged at 0.33 s a step): the first 16 of the resident run's 32
FAMILIES_OFFLOAD_NEW = 16


def offload_serve(torch, card: str, counts: Launches, model, params, work,
                  want: dict, problems: list, new: int = FAMILIES_NEW,
                  attn_layers: int = 0) -> None:
    """A pattern model planned with ``offload_kv`` (its groups placed
    by ``model.mem``) served at each temperature of ``want``: its group
    caches at rest in pinned host memory (``offload_gates``: a group's
    slices paged in and written back once a decode step, the tail in
    device memory), the resident slab run's first ``new`` tokens bit for
    bit (``want``: temperature -> tokens)."""
    from repro_torch.memory import LOCAL, REMOTE
    from repro_torch.runtime.serve import BatchedServer
    mem = model.mem
    for temperature, tokens in want.items():
        server = BatchedServer(model, params, **dict(
            SERVE_KW, block_size=min(new, SERVE_KW["block_size"]),
            temperature=temperature))
        server.tag = tag = (f"{model.cfg.name} offload_kv, paged groups, "
                            f"temperature={temperature}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        toks, secs, _ = counts.run(torch, server, work, new,
                                   attn_layers=attn_layers)
        st, win = server.stats, mem.kv_window
        passes = st["steps"] + st["admitted"]
        log(f"families {tag} [{card}]: {1e3 * secs / st['steps']:.2f} ms a "
            f"decode step (admissions included), {1e3 * secs / passes:.2f} "
            f"ms a pass (steps {st['steps']} + admissions "
            f"{st['admitted']}); group caches at rest "
            f"{kv_tier_bytes(server, REMOTE)} bytes (pinned host), device "
            f"{kv_tier_bytes(server, LOCAL)} (window {win.window_bytes} + "
            f"tail); KV slices paged in {win.fetches}, written back "
            f"{win.writebacks}; {_gbps(2 * win.fetches * win.slot_bytes, secs)}"
            f" GB/s of KV both ways over the run; peak device memory "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
            f"above the {base / 2**30:.2f} GiB held before the run")
        offload_gates(tag, mem, server.cache, model.n_groups * st["steps"],
                      problems)
        if toks != [t[:new] for t in tokens]:
            problems.append(f"{tag}: tokens differ from the resident "
                            f"slab's")


def _card_and_cpu(torch, model, cpu_params, tag: str, serve_kw: dict,
                  work, problems: list, new: int = FAMILIES_NEW):
    """fp32: the same weights served on the card and on the CPU (``new``
    tokens a request), the first 8 tokens equal and a prompt's prefill
    logits within 1e-3."""
    from repro_torch.runtime.serve import BatchedServer
    outs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", _to(cpu_params,
                                                          "cuda"))):
        server = BatchedServer(model, params, device=dev, **serve_kw)
        reqs = [server.submit(p, max_new_tokens=new) for p in work]
        server.run_once()
        outs[dev] = [r.output for r in reqs]
        toks = torch.from_numpy(work[0][None]).to(dev)
        logits, _ = model.prefill(params, toks, model.init_cache(
            1, serve_kw["max_seq"], device=dev))
        outs[dev + "_logits"] = logits.float().cpu()
    err = (outs["cpu_logits"] - outs["cuda_logits"]).abs().max().item()
    first8 = all(a[:8] == b[:8] for a, b in zip(outs["cpu"], outs["cuda"]))
    log(f"{tag} fp32, card vs CPU: prefill logits max_abs_err "
        f"{err:.3e} (bound 1e-3), first-8 tokens equal: {first8}")
    if not (err <= 1e-3 and first8):
        problems.append(f"{tag} fp32: card and CPU disagree")


def check_xlstm(torch, card: str, counts: Launches, problems: list) -> None:
    """xlstm-125m at full width (12 layers, (m, m, m, s) x 3, d 768, 4
    heads, vocab 50304; tp=1) through ``BatchedServer`` over its slab of
    fp32 recurrent state, on the serve phase's prompts (32 new tokens):
    bf16 greedy and at 0.7, no kernel launched; then fp32 on the card
    and on the CPU (``_card_and_cpu``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.ssm import XLSTM
    from repro_torch.runtime.serve import BatchedServer
    cfg = dataclasses.replace(get_config("xlstm-125m"), tp=1)
    model = XLSTM(cfg)
    params = model.init(0, device="cuda")
    state = _state_bytes(model, SERVE_KW["max_seq"])
    log(f"families xlstm-125m [{card}]: {cfg.num_layers} layers = "
        f"{model.n_groups} x {cfg.block_pattern}, d {cfg.d_model}, "
        f"{cfg.num_heads} heads, vocab {cfg.vocab}, {_nbytes(params)} bytes "
        f"of weights; a slot's state {sum(state.values())} bytes "
        f"({state}), fp32, the same at any length (max_seq 384 and "
        f"{sum(_state_bytes(model, 524288).values())} at 524288)")
    work = prompts(cfg.vocab, 0)[:4]
    resident = {}
    for temperature in (0.0, 0.7):
        torch.cuda.reset_peak_memory_stats()
        server = BatchedServer(model, params,
                               **dict(SERVE_KW, temperature=temperature))
        server.tag = tag = f"xlstm-125m temperature={temperature}"
        toks, secs, got = counts.run(torch, server, work, FAMILIES_NEW,
                                     attn_layers=0)
        st = server.stats
        log(f"families {tag} [{card}]: {sum(len(t) for t in toks) / secs:.2f}"
            f" tok/s ({1e3 * secs / st['steps']:.2f} ms a decode step, "
            f"admissions included), steps {st['steps']}, slab "
            f"{server.kv_bytes_capacity()} bytes, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{ {k: n for k, n in got.items() if n} }")
        if any(got.values()):
            problems.append(f"{tag}: kernels launched {got}")
        resident[temperature] = toks
    problems += graph_vs_eager(torch, card, "xlstm-125m", model, params)
    offload = XLSTM(cfg.with_pager(enabled=True, lookahead=1,
                                   offload_kv=True))
    placed = dict(params, groups=offload.mem.place_layer_weights(
        params["groups"]))
    offload_serve(torch, card, counts, offload, placed, work, resident,
                  problems)
    del placed, offload
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = XLSTM(f32)
    _card_and_cpu(torch, model, model.init(0, device="cpu"),
                  "families xlstm-125m", dict(SERVE_KW, temperature=0.0),
                  work, problems)


def _whisper_run(torch, model, params, frames, toks, new: int):
    """``prefill`` of the prompts with the frames, then ``new - 1`` greedy
    ``decode_step``s, kernel counts reset just before: (tokens (B, new),
    prefill logits, prefill seconds, decode seconds, the run's launches,
    by kernel and by instantiation, the cache).  A model planned with
    ``offload_kv`` places its cache in the remote tier first."""
    from repro_torch.kernels import (instance_counts, launch_counts,
                                     reset_launch_counts)
    from repro_torch.models.transformer import sample_tokens
    vocab, dev = model.cfg.vocab, frames.device
    b, s = toks.shape
    cache = model.mem.place_kv_pool(model.init_cache(b, s + new, device=dev))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, toks, cache,
                                  extra={"frames": frames})
    sync()
    t1 = time.perf_counter()
    first = logits.float().cpu()
    nxt = sample_tokens(logits, vocab)
    out = [nxt]
    for i in range(new - 1):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, nxt, cache, pos)
        nxt = sample_tokens(logits, vocab)
        out.append(nxt)
    sync()
    return (torch.cat(out, dim=1).tolist(), first, t1 - t0,
            time.perf_counter() - t1, launch_counts(), instance_counts(),
            cache)


def check_whisper(torch, card: str, counts: Launches, problems: list) -> None:
    """whisper-base at full width (6 + 6 layers, d 512, 8/8 heads, d_head
    64, d_ff 2048, vocab 51865, 1500 frames; tp=1) at the model level,
    as the reference serves it (its server takes no frames): seeded
    random frames (4, 1500, 512), ``prefill`` of the serve phase's four
    8-token prompts, 32 greedy tokens.  bf16: K2 18 times a prefill on
    wgmma at d = 64 (6 encoder launches at Sq = Sk = 1500, 6 causal
    self-attention, 6 cross-attention at Sq = 8, Sk = 1500).  fp32 on
    the card and on the CPU, two of the prompts: prefill logits within
    1e-3 and the first 8 tokens equal."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.encdec import EncDecLM
    cfg = dataclasses.replace(get_config("whisper-base"), tp=1)
    model = EncDecLM(cfg)
    params = model.init(0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    frames = torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device="cuda")
    toks = torch.from_numpy(np.stack(prompts(cfg.vocab, 0)[:4])).to("cuda")
    xkv = sum(dt.itemsize * math.prod(shape) for name, (shape, dt) in
              model.cache_shapes(1, 8 + FAMILIES_NEW).items()
              if name.startswith("x"))
    torch.cuda.reset_peak_memory_stats()
    out, _, pre_s, dec_s, got, insts, _ = _whisper_run(
        torch, model, params, frames.to(cfg.dtype), toks, FAMILIES_NEW)
    counts.add(got, insts)
    k2 = {k: n for k, n in got.items() if n}
    inst = insts["flash_attention_wgmma"]
    tokens = len(out) * (FAMILIES_NEW - 1)
    log(f"families whisper-base bf16 [{card}]: prefill (encode "
        f"{cfg.encoder_seq} frames x 4 + 8-token prompts) {1e3 * pre_s:.2f} ms, {FAMILIES_NEW - 1} "
        f"decode steps {1e3 * dec_s / (FAMILIES_NEW - 1):.2f} ms a step = "
        f"{tokens / dec_s:.2f} tok/s, cross KV {xkv} bytes a slot (written "
        f"once, read every step), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{k2} by instantiation {inst}")
    want = 2 * cfg.num_layers + cfg.num_encoder_layers
    if (k2 != {"flash_attention_wgmma": want}
            or inst != {f"d={cfg.head_dim}": want}):
        problems.append(f"whisper-base: launches {k2} {inst}, expected "
                        f"{want} a prefill on wgmma and none a step")
    problems += graph_vs_eager(torch, card, "whisper-base", model, params,
                               extra={"frames": frames.to(cfg.dtype)})
    # offload_kv with the decoder's layers paged: the self and cross KV
    # at rest in pinned host memory, written by the prefill through the
    # window (one pass), read a layer at a time every step
    offload = EncDecLM(cfg.with_pager(enabled=True, lookahead=1,
                                      offload_kv=True))
    placed = dict(params, dec_layers=offload.mem.place_layer_weights(
        params["dec_layers"]))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    toks_off, _, pre_s, dec_s, got, insts, cache = _whisper_run(
        torch, offload, placed, frames.to(cfg.dtype), toks, FAMILIES_NEW)
    counts.add(got, insts)
    win = offload.mem.kv_window
    tag = "whisper-base bf16 offload_kv, paged decoder layers"
    log(f"families {tag} [{card}]: prefill {1e3 * pre_s:.2f} ms, "
        f"{1e3 * dec_s / (FAMILIES_NEW - 1):.2f} ms a decode step; KV at "
        f"rest {win.at_rest_bytes} bytes (pinned host), window "
        f"{win.window_bytes}; slices paged in {win.fetches}, written back "
        f"{win.writebacks} (the cross KV never written back by decode); "
        f"peak device memory "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB above "
        f"the {base / 2**30:.2f} GiB held before the run; launches "
        f"{ {k: n for k, n in got.items() if n} }")
    offload_gates(tag, offload.mem, cache, cfg.num_layers * FAMILIES_NEW,
                  problems)
    if toks_off != out:
        problems.append(f"{tag}: tokens differ from the resident run's")
    if {k: n for k, n in got.items() if n} != {"flash_attention_wgmma": want}:
        problems.append(f"{tag}: launches {got}")
    del placed, offload, cache, win
    whisper_fp32(torch, dataclasses.replace(cfg, dtype=torch.float32),
                 frames[:2].cpu(), toks[:2].cpu(), problems)


def whisper_fp32(torch, cfg, frames, toks, problems: list) -> None:
    """whisper-base in fp32, the card against the CPU with the same
    weights, frames (B, 1500, d) and prompts: each of the 12 layers at
    full width from the CPU's input to it (the encoder's over the 1500
    frames, the decoder's over the prompt and the CPU's encoder output)
    within 1e-3 of the CPU's output.  The whole model's prefill logits
    and 8 greedy tokens are logged beside them: with the reference's
    init scales (K and V drawn at 1/sqrt(Hkv), not 1/sqrt(d): a score's
    std is ~8) the random model amplifies fp32 rounding ~1e6-fold
    through its depth, so two correct fp32 runs part there (PERF.md, PR
    23)."""
    from repro_torch.models import layers as L
    from repro_torch.models.encdec import EncDecLM
    model = EncDecLM(cfg)
    cpu = model.init(0, device="cpu")
    card = _to(cpu, "cuda")
    worst = 0.0

    def held(want: torch.Tensor, got: torch.Tensor) -> None:
        nonlocal worst
        worst = max(worst, (want - got.cpu()).abs().max().item())

    h, pos = frames.float(), torch.arange(frames.shape[1])
    for lc, lg in zip(cpu["enc_layers"], card["enc_layers"]):
        out = model.enc_block(lc, h, pos)
        held(out, model.enc_block(lg, h.cuda(), pos.cuda()))
        h = out
    enc = L.rmsnorm(h, cpu["enc_ln"], cfg.norm_eps)
    x, pos = L.embed_lookup(cpu["embed"], toks), torch.arange(toks.shape[1])
    for lc, lg in zip(cpu["dec_layers"], card["dec_layers"]):
        out = model.dec_block(lc, x, pos, enc)[0]
        held(out, model.dec_block(lg, x.cuda(), pos.cuda(), enc.cuda())[0])
        x = out
    runs = {dev: _whisper_run(torch, model, prm, frames.to(dev),
                              toks.to(dev), 8)
            for dev, prm in (("cpu", cpu), ("cuda", card))}
    err = (runs["cpu"][1] - runs["cuda"][1]).abs().max().item()
    log(f"families whisper-base fp32, card vs CPU ({toks.shape[0]} "
        f"prompts): every layer from the CPU's input, max_abs_err "
        f"{worst:.3e} (bound 1e-3); the whole model, logged: prefill "
        f"logits max_abs_err {err:.3e}, first-8 tokens equal "
        f"{runs['cpu'][0] == runs['cuda'][0]}; card launches "
        f"{ {k: n for k, n in runs['cuda'][4].items() if n} }")
    if not worst <= 1e-3:
        problems.append(f"whisper-base fp32: a layer {worst:.3e} from the "
                        f"CPU's")


def check_families(torch, card: str, counts: Launches) -> None:
    """The ``families`` phase: recurrentgemma-9b, xlstm-125m and
    whisper-base at full width (``check_recurrentgemma``,
    ``check_xlstm``, ``check_whisper``), every gate checked before it
    raises."""
    problems: list = []
    t0 = time.perf_counter()
    for check in (check_recurrentgemma, check_xlstm, check_whisper):
        t = time.perf_counter()
        check(torch, card, counts, problems)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"families: {check.__name__} took "
            f"{time.perf_counter() - t:.1f} s")
    log(f"families: the phase took {time.perf_counter() - t0:.1f} s")
    if problems:
        raise AssertionError("families phase: " + "; ".join(problems))
    log("families: every gate held")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

#: the train phase's attention-gradient shapes (gate 1): (model, B, Sq, Sk,
#: Hq, Hkv, d, mask keywords) -- minicpm-2b's training microbatch shape,
#: Qwen2.5-14B's GQA, recurrentgemma-9b's windowed layer over its 2100
#: tokens and whisper-base's decoder cross-attention over the 1500 frames
TRAIN_ATTN = (("minicpm-2b", 4, 1024, 1024, 36, 36, 64, {}),
              ("qwen2.5-14b", 1, 1024, 1024, 40, 8, 128, {}),
              ("recurrentgemma-9b", 1, 2100, 2100, 16, 1, 256,
               {"window": 2048}),
              ("whisper-base", 4, 64, 1500, 8, 8, 64, {"causal": False}))
#: minicpm-2b's training run (gate 3): batch x tokens, microbatches, steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4, 1024, 2, 6
#: the fault-tolerant run (gate 4): layers kept of 40, steps, the step
#: that raises once, checkpoint period
FT_LAYERS, FT_STEPS, FT_FAIL_AT, FT_EVERY = 4, 5, 3, 2
#: card-against-CPU gradients: the loss within 1e-4, each leaf within 1e-3
#: of its largest magnitude, floored at 1e-3 of the tree's largest (a
#: leaf whose exact gradient is 0, the mLSTM input-gate bias, holds only
#: rounding on both devices)
GRAD_LOSS_TOL, GRAD_TOL = 1e-4, 1e-3


def _row_errors(got, want) -> tuple[float, float]:
    """(largest |got - want|, largest row error over the row's largest
    |want|), rows along the last dim."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), (diff.amax(-1) / want.float().abs().amax(
        -1).clamp_min(1e-30)).max().item()


def train_attention_grads(torch, card: str, results: dict) -> list:
    """Gate 1: K2 under autograd (``ops.attention``: K2's forward, the
    plain backward) against torch autograd through the plain version in
    fp32 on the same inputs, at ``TRAIN_ATTN``'s shapes, in fp32 (bound
    1e-4) and bf16 (3e-2).  The forward's output is held as
    ``check_flash`` holds K2: each element, and each output row within
    the bound times its row's largest |plain|.  dQ, dK and dV are held
    row by row: each element's error over its row's largest |want| (a
    row: one position of one head), since their scale (4 to 8 at
    minicpm-2b's shape) follows the inputs'; one K2 launch on the route
    ``plan`` gives.  Then
    the timings: K2's forward (graph replay) beside the plain forward and
    SDPA's (a kernels-JSON row, phase "train"); the plain backward beside
    SDPA's backward, and K2 + the plain backward beside SDPA's forward
    and backward under autograd, from replayed graphs and eagerly.
    Returns the problems found."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.backward import (
        flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (
        _mask, flash_attention_ref)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(5)
    problems = []
    for arch, b, sq, sk, hq, hkv, d, kw in TRAIN_ATTN:
        causal, window = kw.get("causal", True), kw.get("window", 0)
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            def inputs():
                return [torch.randn(shape, generator=gen, device="cuda").to(
                    dtype) for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                                         (b, sk, hkv, d), (b, sq, hq, d))]
            q, k, v, do = inputs()
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = launch_counts()
            out = ops.attention(*leaves, **kw)
            got = torch.autograd.grad(out, leaves, do)
            moved = {n: c - before[n] for n, c in launch_counts().items()
                     if c != before[n]}
            route = K.plan(dtype, d, hq // hkv, dtype == torch.bfloat16
                           and K.aligned(q, k, v))
            ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
            ref_out = flash_attention_ref(*ref_leaves, **kw)
            want = torch.autograd.grad(ref_out, ref_leaves, do.float())
            fwd_err, fwd_row = _row_errors(out, ref_out.detach())
            errs = {n: _row_errors(g, w)
                    for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            dt = str(dtype)[6:]
            shape = (f"B={b} {f'Sq=Sk={sq}' if sq == sk else f'Sq={sq} Sk={sk}'}"
                     f" Hq={hq} Hkv={hkv} d={d} "
                     f"{'causal' if causal else 'non-causal'}"
                     f"{f' window {window}' if window else ''} {dt}")
            log(f"train attention grads ({arch}: {shape}): K2 forward + "
                f"plain backward against autograd through the plain version "
                f"in fp32: " + ", ".join(
                    f"{n} max_abs_err {e:.3e} row {r:.3e}"
                    for n, (e, r) in errs.items())
                + f" (bound {tol:g} for each row); forward max_abs_err "
                f"{fwd_err:.3e} row {fwd_row:.3e} (bound {tol:g} for both); "
                f"launches {moved}")
            if moved != {f"flash_attention_{route}": 1}:
                problems.append(f"attention grads {arch} {dt}: launches "
                                f"{moved}, expected one on {route}")
            if not (fwd_err <= tol and fwd_row <= tol):
                problems.append(f"attention forward {arch} {dt}: "
                                f"{fwd_err}, row {fwd_row} over {tol}")
            if not all(r <= tol for _, r in errs.values()):
                problems.append(f"attention grads {arch} {dt}: rows {errs} "
                                f"over {tol}")
            del leaves, out, got, ref_leaves, ref_out, want

            # timings: four input sets rotate past the L2
            sets = [inputs() for _ in range(4)]
            ms = time_ms(torch, lambda q, k, v, do: ops.attention(q, k, v,
                                                                  **kw),
                         sets)
            plain_ms = time_ms(torch, lambda q, k, v, do: flash_attention_ref(
                q, k, v, **kw), sets, iters=1, graph=False)
            g = hq // hkv
            lib = [[t.transpose(1, 2) if i in (0, 3) else
                    t.transpose(1, 2).repeat_interleave(g, dim=1)
                    for i, t in enumerate(s)] for s in sets]
            mask = None
            if window:
                mask = _mask(sk - sq + torch.arange(sq, device="cuda"),
                             torch.arange(sk, device="cuda"), causal=causal,
                             window=window, kv_valid=sk)

            def lib_fwd(q, k, v, do):
                return (sdpa(q, k, v, attn_mask=mask) if mask is not None
                        else sdpa(q, k, v, is_causal=causal))
            lib_ms = time_ms(torch, lib_fwd, lib)
            # device times from replayed graphs: the plain backward alone;
            # K2 + the plain backward, and SDPA's forward and backward,
            # under autograd (SDPA's backward: the difference with its
            # forward); then the same two under autograd eagerly, the
            # host's issue time included, as a training step pays it
            bwd_ms = time_ms(torch, lambda q, k, v, do: flash_attention_bwd(
                q, k, v, do, **kw), sets, iters=10)
            grad_sets = [[t.requires_grad_() if i < 3 else t
                          for i, t in enumerate(s)] for s in sets]
            lib_grad = [[t.detach().requires_grad_() if i < 3 else t
                         for i, t in enumerate(s)] for s in lib]

            def fwd_bwd(attn, q, k, v, do):
                torch.autograd.grad(attn(q, k, v, do), (q, k, v), do)

            def ours(*t):
                fwd_bwd(lambda q, k, v, do: ops.attention(q, k, v, **kw), *t)
            fb_ms = time_ms(torch, ours, grad_sets, iters=10)
            lib_fb_ms = time_ms(torch, lambda *t: fwd_bwd(lib_fwd, *t),
                                lib_grad, iters=10)
            lib_bwd_ms = lib_fb_ms - lib_ms
            fb_eager_ms = time_ms(torch, ours, grad_sets, iters=10,
                                  graph=False)
            lib_fb_eager_ms = time_ms(torch, lambda *t: fwd_bwd(lib_fwd, *t),
                                      lib_grad, iters=10, graph=False)
            size = q.element_size()
            pairs = hq * b * _flash_pairs(torch, sq, sk, **kw)
            peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
                else TF32X3_FLOPS_PER_S
            nbytes = size * b * (2 * sq * hq * d + 2 * sk * hkv * d)
            b_ms, b_by = bound(nbytes, 4 * d * pairs, peak)
            # backward: q, do, dq and k, v, dk, dv once each; S recomputed,
            # dP, dV, dQ, dK: 10 d operations a pair
            bb_ms, bb_by = bound(size * b * (3 * sq * hq * d
                                             + 4 * sk * hkv * d),
                                 10 * d * pairs, peak)
            log(f"train K2 flash_attention_{route} {shape} [{card}]: forward "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), "
                f"{100 * b_ms / ms:.1f}% of the bound; plain backward "
                f"{bwd_ms:.4f} ms, sdpa backward {lib_bwd_ms:.4f} ms, bound "
                f"{bb_ms:.6f} ms ({bb_by}), {100 * bb_ms / bwd_ms:.1f}% of "
                f"the bound, plain / sdpa {bwd_ms / lib_bwd_ms:.2f}x; "
                f"forward + backward {fb_ms:.4f} ms against sdpa's "
                f"{lib_fb_ms:.4f} ms ({fb_ms / lib_fb_ms:.2f}x); eager, "
                f"host included, {fb_eager_ms:.4f} against "
                f"{lib_fb_eager_ms:.4f} ms")
            results.setdefault(f"flash_attention_{route}", []).append(dict(
                shape=f"{shape} ({arch} training)",
                instance=K.instance(d, dtype), phase="train",
                max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, plain_bwd_ms=bwd_ms,
                library_bwd_ms=lib_bwd_ms, bwd_bound_ms=bb_ms,
                fwd_bwd_ms=fb_ms, library_fwd_bwd_ms=lib_fb_ms,
                fwd_bwd_eager_ms=fb_eager_ms,
                library_fwd_bwd_eager_ms=lib_fb_eager_ms,
                grad_max_abs_err={n: e for n, (e, _) in errs.items()},
                grad_row_err={n: r for n, (_, r) in errs.items()}))
            del sets, lib, grad_sets, lib_grad
    return problems


def _train_batch(torch, cfg, b: int, s: int, seed: int = 0) -> dict:
    """A seeded ``SyntheticLM`` batch, with seeded patches (VLM) or frames
    (encoder-decoder) where the family takes them."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    batch = SyntheticLM(DataConfig(batch=b, seq=s, vocab=cfg.vocab,
                                   seed=seed)).batch_at(0)
    rng = np.random.RandomState(seed)
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(b, cfg.num_patches,
                                     cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(b, cfg.encoder_seq,
                                    cfg.d_model).astype(np.float32)
    return batch


def grads_card_vs_cpu(torch, model, cpu_params, batch: dict, tag: str,
                      problems: list) -> dict:
    """The loss and every gradient leaf of one batch, the card against the
    CPU with the same weights (``GRAD_LOSS_TOL``, ``GRAD_TOL``); returns
    the card run's kernel launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import train
    tcfg = train.TrainConfig()
    out = {}
    for dev, params in (("cpu", cpu_params), ("cuda", _to(cpu_params,
                                                          "cuda"))):
        reset_launch_counts()
        loss, grads = train.loss_and_grads(model, tcfg, params,
                                           train.to_device(batch, dev))
        out[dev] = (float(loss), [g.cpu() for g in grads])
        launches = {k: n for k, n in launch_counts().items() if n}
        del params, grads
    (lc, gc_), (lg, gg) = out["cpu"], out["cuda"]
    top = max(g.abs().max().item() for g in gc_)
    worst = max((a - b).abs().max().item()
                / max(a.abs().max().item(), 1e-3 * top)
                for a, b in zip(gc_, gg))
    log(f"{tag}, card vs CPU: loss {lg:.6f} against {lc:.6f} (|diff| "
        f"{abs(lg - lc):.3e}, bound {GRAD_LOSS_TOL:g}); {len(gc_)} gradient "
        f"leaves, the worst {worst:.3e} of its largest magnitude (bound "
        f"{GRAD_TOL:g}); card launches {launches}")
    if not (abs(lg - lc) <= GRAD_LOSS_TOL and worst <= GRAD_TOL):
        problems.append(f"{tag}: card and CPU gradients disagree")
    return launches


#: the parity phase's training models: (arch, overrides of ``reduced``)
PARITY_TRAIN = (("qwen2.5-14b", {}), ("granite-moe-3b-a800m", {}),
                ("llava-next-34b", {}),
                ("recurrentgemma-9b", {"num_layers": 5}),
                ("xlstm-125m", {}), ("whisper-base", {}))


def check_parity_train(torch) -> None:
    """Every family's fp32 smoke model (dense, MoE, VLM, hybrid, ssm,
    encoder-decoder): the loss and gradients of one batch (2 x 16 tokens,
    with patches or frames) on the card against the CPU
    (``grads_card_vs_cpu``); K2 on its mma route only (fp32), and twice
    an attention layer (the forward and its recompute under remat)."""
    from repro_torch.configs import build_model, get_config
    problems: list = []
    for arch, over in PARITY_TRAIN:
        cfg = get_config(arch).reduced(dtype=torch.float32, **over)
        model = build_model(cfg)
        cpu_params = model.init(0, device="cpu")
        got = grads_card_vs_cpu(torch, model, cpu_params,
                                _train_batch(torch, cfg, 2, 16),
                                f"parity train (smoke fp32 {arch})", problems)
        if got.get("flash_attention_wgmma", 0):
            problems.append(f"parity train {arch}: wgmma launched in fp32")
    if problems:
        raise AssertionError("; ".join(problems))


def minicpm_config(torch, layers: int, dtype):
    """minicpm-2b at its published widths on one card (tp=1: 36/36 heads,
    none padded), ``layers`` of its 40 deep."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("minicpm-2b"), tp=1,
                               num_layers=layers, dtype=dtype)


def train_fp32_card_vs_cpu(torch, problems: list) -> None:
    """Gate 2: minicpm-2b at full width, 2 of its 40 layers, fp32, one
    batch of 2 x 128 tokens: the loss and every gradient leaf, the card
    against the CPU (``grads_card_vs_cpu``).  Two layers: the reference's
    init gives scores a std of ~8 (sqrt(d / Hkv)), and depth amplifies
    fp32 rounding past the bound (whisper-base, PERF.md)."""
    from repro_torch.models.transformer import DenseLM
    cfg = minicpm_config(torch, 2, torch.float32)
    model = DenseLM(cfg)
    cpu_params = model.init(0, device="cpu")
    grads_card_vs_cpu(torch, model, cpu_params,
                      _train_batch(torch, cfg, 2, 128),
                      "train minicpm-2b fp32 (full width, 2 of 40 layers, "
                      "2 x 128 tokens)", problems)
    del cpu_params
    gc.collect()


def train_minicpm(torch, card: str, counts: Launches, problems: list,
                  profiled: bool = False) -> None:
    """Gate 3: minicpm-2b at full width and depth (40 layers, d 2304, 36/36
    heads at d 64, d_ff 5760, vocab 122753 tied; tp=1, random bf16
    weights, fp32 moments), ``TRAIN_STEPS`` steps of ``make_train_step``
    on one seeded ``SyntheticLM`` batch of TRAIN_BATCH x TRAIN_SEQ tokens,
    accum_steps=2, WSD, remat on: every loss finite and the last below
    the first; K2 once a layer a microbatch forward and once more in its
    remat recompute (wgmma only), every step.  Prints ms a step (median
    of steps 2..6), tokens/s and peak device memory; with ``profiled``,
    one more step traced (``profile_train_step``)."""
    import statistics

    from repro_torch.kernels import (instance_counts, launch_counts,
                                     reset_launch_counts)
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime import optim, train
    cfg = minicpm_config(torch, 40, torch.bfloat16)
    model = DenseLM(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device="cuda")
    opt = optim.init_opt_state(params)
    n_params = sum(p.numel() for p in _leaves(params))
    tcfg = train.TrainConfig(adamw=optim.AdamWConfig(
        lr=3e-3, schedule="wsd", warmup_steps=2, total_steps=TRAIN_STEPS,
        decay_fraction=0.5), accum_steps=TRAIN_ACCUM)
    step = train.make_train_step(model, tcfg)
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)
    log(f"train minicpm-2b [{card}]: {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads at d "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded "
        f"{cfg.padded_vocab}) tied, {n_params} parameters in bf16, fp32 "
        f"moments; batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, accum_steps "
        f"{TRAIN_ACCUM}, WSD, remat on")
    want = cfg.num_layers * TRAIN_ACCUM * 2    # forward + remat recompute
    losses, secs, per_step = [], [], []
    reset_launch_counts()
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])        # waits for the step
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        now = launch_counts()
        per_step.append({n: now[n] - before[n] for n in now
                         if now[n] != before[n]})
        log(f"train minicpm-2b step {i}: loss {loss:.4f}, lr "
            f"{float(m['lr']):.3e}, grad_norm {float(m['grad_norm']):.3f}, "
            f"{1e3 * secs[-1]:.1f} ms, launches {per_step[-1]}")
    counts.add(launch_counts(), instance_counts())
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(secs[1:])
    log(f"train minicpm-2b [{card}]: {1e3 * med:.1f} ms a step (median of "
        f"steps 2..{TRAIN_STEPS}; the first {1e3 * secs[0]:.1f} ms), "
        f"{TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; losses {losses}; K2 launches a step "
        f"{[s.get('flash_attention_wgmma', 0) for s in per_step]} "
        f"(expected {want}: {cfg.num_layers} layers x {TRAIN_ACCUM} "
        f"microbatches x 2, the forward and the remat recompute)")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        problems.append(f"train minicpm-2b: losses {losses} not finite and "
                        f"falling")
    if any(s != {"flash_attention_wgmma": want} for s in per_step):
        problems.append(f"train minicpm-2b: launches a step {per_step}, "
                        f"expected {want} on wgmma")
    if profiled:
        profile_train_step(torch, card, step, params, opt, batch)
    del params, opt, m
    gc.collect()
    torch.cuda.empty_cache()


def train_fault_tolerant(torch, card: str, problems: list) -> None:
    """Gate 4: minicpm-2b at full width, FT_LAYERS of its 40 layers, bf16:
    FT_STEPS steps through ``FaultTolerantLoop`` (checkpoints every
    FT_EVERY steps, saved asynchronously into a temporary directory) with
    a step that raises once at FT_FAIL_AT, against the same steps run
    without the loop: the loop restores the latest checkpoint, replays,
    and its final params equal the uninterrupted run's bit for bit."""
    import shutil
    import tempfile

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime import optim, train
    from repro_torch.runtime.ft import FaultTolerantLoop, FTConfig
    cfg = minicpm_config(torch, FT_LAYERS, torch.bfloat16)
    model = DenseLM(cfg)
    step = train.make_train_step(model, train.TrainConfig(
        adamw=optim.AdamWConfig(lr=3e-3, schedule="wsd", warmup_steps=1,
                                total_steps=FT_STEPS), accum_steps=2))
    data = SyntheticLM(DataConfig(batch=4, seq=256, vocab=cfg.vocab, seed=3))

    def fresh():
        params = model.init(0, device="cuda")
        return params, optim.init_opt_state(params)

    params, opt = fresh()
    for i in range(FT_STEPS):
        params, opt, _ = step(params, opt, data.batch_at(i))
    want = [p.cpu() for p in _leaves(params)]
    del params, opt
    failures = {FT_FAIL_AT}

    def step_fn(state, i):
        if i in failures:
            failures.clear()
            raise RuntimeError(f"injected failure at step {i}")
        p, o = state
        p, o, m = step(p, o, data.batch_at(i))
        return (p, o), m

    root = tempfile.mkdtemp(prefix="train_ft_")
    try:
        free = shutil.disk_usage(root).free
        loop = FaultTolerantLoop(FTConfig(ckpt_dir=root, ckpt_every=FT_EVERY,
                                          keep=2, async_save=True), step_fn)
        t0 = time.perf_counter()
        (params, _), end = loop.run(fresh(), num_steps=FT_STEPS)
        secs = time.perf_counter() - t0
        saved = sorted(p.name for p in Path(root).iterdir())
        nbytes = sum(f.stat().st_size for f in Path(root).rglob("*")
                     if f.is_file())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    got = [p.cpu() for p in _leaves(params)]
    same = all(torch.equal(a, b) for a, b in zip(want, got))
    differ = [i for i, (a, b) in enumerate(zip(want, got))
              if not torch.equal(a, b)]
    log(f"train fault-tolerant loop [{card}]: minicpm-2b at full width, "
        f"{FT_LAYERS} of 40 layers, bf16, {FT_STEPS} steps, checkpoints "
        f"every {FT_EVERY} (async; {saved} kept, {nbytes} bytes, "
        f"{free / 2**30:.1f} GiB free before), one failure at step "
        f"{FT_FAIL_AT}: restarts {loop.restarts}, steps logged "
        f"{[m['step'] for m in loop.metrics_log]}, ended at {end}, "
        f"{secs:.1f} s; final params equal the uninterrupted run's bit for "
        f"bit: {same} (leaves that differ: {differ})")
    if not (same and loop.restarts == 1 and end == FT_STEPS):
        problems.append("train fault-tolerant loop: the replay differs from "
                        "the uninterrupted run")
    del params
    gc.collect()
    torch.cuda.empty_cache()


#: coarse kinds of device kernels in a traced training step, by name
TRAIN_KERNEL_KINDS = (("K2", ("flash_wgmma_kernel", "flash_mma_kernel")),
                      ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass",
                                           "sm90_", "nvjet")),
                      ("softmax / logsumexp", ("softmax", "logsumexp")),
                      ("reductions", ("reduce",)),
                      ("index / scatter", ("index", "scatter", "gather",
                                           "embedding")),
                      ("copies and casts", ("copy", "Memcpy", "Memset")),
                      ("elementwise", ("elementwise", "vectorized",
                                       "unrolled")))


def profile_train_step(torch, card: str, step, params, opt, batch) -> None:
    """One more training step under ``torch.profiler``: the device's busy
    share of its wall time, device time by kind of kernel and the top
    kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev, ev.key, ev.count))
    busy = sum(r[0] for r in rows) / 1e6
    kinds: dict = {}
    for dev, key, _ in rows:
        kind = next((k for k, subs in TRAIN_KERNEL_KINDS
                     if any(s in key for s in subs)), "other")
        kinds[kind] = kinds.get(kind, 0) + dev
    log(f"profile train minicpm-2b step [{card}]: {secs:.3f} s wall (traced), "
        f"device busy {busy:.3f} s ({100 * busy / secs:.1f}%); by kind: "
        + ", ".join(f"{k} {v / 1e3:.1f} ms ({100 * v / 1e6 / busy:.1f}%)"
                    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
    for dev, key, count in sorted(rows, reverse=True)[:14]:
        log(f"  {dev / 1e3:10.2f} ms  {100 * dev / 1e6 / busy:5.1f}%  "
            f"x{count:<6d} {key[:90]}")


def check_train(torch, card: str, results: dict, counts: Launches,
                profiled: bool = False) -> None:
    """The ``train`` phase: gates 1-4 (``train_attention_grads``,
    ``train_fp32_card_vs_cpu``, ``train_fault_tolerant``,
    ``train_minicpm``, which traces one more step when ``profiled``),
    every gate checked before it raises."""
    t0 = time.perf_counter()
    problems = train_attention_grads(torch, card, results)
    log(f"train: train_attention_grads took {time.perf_counter() - t0:.1f} s")
    for name, check in (
            ("train_fp32_card_vs_cpu",
             lambda: train_fp32_card_vs_cpu(torch, problems)),
            ("train_fault_tolerant",
             lambda: train_fault_tolerant(torch, card, problems)),
            ("train_minicpm",
             lambda: train_minicpm(torch, card, counts, problems,
                                   profiled))):
        t = time.perf_counter()
        check()
        log(f"train: {name} took {time.perf_counter() - t:.1f} s")
    log(f"train: the phase took {time.perf_counter() - t0:.1f} s")
    if problems:
        raise AssertionError("train phase: " + "; ".join(problems))
    log("train: every gate held")


#: the train_mesh phase: minicpm-2b at full width (tp=2: 36/36 heads
#: shard whole) over a (data 2, model 2) mesh of 4 ranks on the one card
TRAIN_MESH = {"data": 2, "model": 2}
#: gate A's layers (fp32, one step), gate B's layers and steps (bf16)
TRAIN_MESH_A_LAYERS, TRAIN_MESH_B_LAYERS, TRAIN_MESH_STEPS = 2, 4, 3
#: bytes of each half of a group's slice: the data axis moves fp32
#: gradient sums and bf16 params in rounds of half / 2 bytes a rank; the
#: model axis a microbatch's (1, 1024, 2304) activations, fp32 in gate A
TRAIN_MESH_REGION = {"data": 64 << 20, "model": 32 << 20}
#: seconds the ranks may take, their start included
TRAIN_MESH_TIMEOUT = 300
#: gate B's loss bound: each step's mesh loss against one card's loss
#: at the same params (the mesh's, gathered before the step): bf16, each
#: rank's partial products round on their own.  The one-card run's own
#: losses are printed beside them but not held: Adam's first steps turn
#: rounding-level differences of near-zero bf16 gradients into moves of
#: a whole lr (two one-card runs of other microbatch splits parted by
#: 0.051 and 0.664 after their first two updates on an H100 80GB HBM3 at
#: 700 W), so the update is held directly instead (``zero1_witness``)
TRAIN_MESH_LOSS_ATOL = 0.05
#: gate A's bound on each gathered gradient leaf (of its scale), or
#: twice that leaf's gap of one card against itself over 4 microbatches
#: when that is larger (the tied embedding's: 9.5e-5 on the same card)
TRAIN_MESH_GRAD_TOL = 1e-4
#: the K4 rows at the train_mesh phase's shapes: a gradient
#: reduce-scatter's round of fp32 sums and a ZeRO-1 param all-gather's
#: round of bf16 over the data axis, and the model axis's all-reduce of a
#: microbatch's (1, 1024, 2304) activations (or their gradients): bf16 in
#: gate B, fp32 in gate A
TRAIN_MESH_TAB = (("gradient reduce-scatter round", 2,
                   ((TRAIN_MESH_REGION["data"] // 2) // 4,), False,
                   "train_mesh", "float32"),
                  ("ZeRO-1 param all-gather round", 2,
                   ((TRAIN_MESH_REGION["data"] // 2) // 2,), True,
                   "train_mesh", "bfloat16"),
                  ("model-axis activation all-reduce", 2, (1024, 2304),
                   False, "train_mesh", "bfloat16"),
                  ("model-axis activation all-reduce", 2, (1024, 2304),
                   False, "train_mesh", "float32"))
TRAIN_MESH_PATH = ("make_train_step(model, tcfg, mesh), minicpm-2b at full "
                   "width over (data 2, model 2): 4 ranks on one card, one "
                   "shared-region slice a group, gate B's 3 steps (4 of 40 "
                   "layers, bf16) and gate A's step (2 layers, fp32) of 4 x "
                   "1024 tokens in 2 microbatches (the forward and the "
                   "remat recompute), the ranks summed (train_mesh phase)")


def train_mesh_config(torch, layers: int, dtype):
    """minicpm-2b at its published widths, ``layers`` of its 40, tp=2 (36
    heads split whole over the model axis; no padding)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("minicpm-2b"), tp=2,
                               num_layers=layers, dtype=dtype)


def train_mesh_tcfg(torch, dtype):
    from repro_torch.runtime import optim, train
    return train.TrainConfig(adamw=optim.AdamWConfig(
        lr=3e-3, schedule="wsd", warmup_steps=2, total_steps=TRAIN_STEPS,
        decay_fraction=0.5), accum_steps=TRAIN_ACCUM)


def _param_hashes(torch, params) -> "torch.Tensor":
    """Two int64 hashes a leaf of its bits (their sum, and their sum
    weighted by position mod 1021), on the leaves' device."""
    out = []
    for x in _leaves(params):
        v = x.contiguous().view(torch.int16 if x.element_size() == 2
                                else torch.int32).reshape(-1).long()
        w = torch.arange(v.numel(), device=v.device) % 1021 + 1
        out += [v.sum(), (v * w).sum()]
    return torch.stack(out)


def _tallies(mesh) -> dict:
    """axis -> kind -> {transfers, bytes} of the mesh's transports (the
    kinds that moved), and axis -> wait_s."""
    out = {}
    for axis, t in mesh.transports().items():
        out[axis] = {k: {"transfers": v["transfers"], "bytes": v["bytes"]}
                     for k, v in t.tally.items() if v["transfers"]}
        out[axis]["wait_s"] = t.wait_s
    return out


def _leaf_errors(want: list, got: list) -> list[float]:
    """Each leaf's largest |got - want| over its scale: its largest
    |want|, floored at 1e-3 of the tree's largest
    (``tests/test_torch_train.py``'s ``_hold``)."""
    top = max(float(w.abs().max()) for w in want)
    return [float((w.float() - g.float()).abs().max())
            / max(float(w.abs().max()), 1e-3 * top)
            for w, g in zip(want, got)]


def _traced_mesh_step(torch, step, params, opt, rows, rank: int) -> dict:
    """One more step of every rank, traced on rank 0 (``torch.profiler``):
    its wall ms, the card's busy ms and the device ms of the TAB's
    collective, of K2, of the matmuls (cuBLAS) and of the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if rank == 0 else contextlib.nullcontext())
    with ctx as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, rows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rank != 0:
        return {}
    kinds = {"tab": ("tab_sum_kernel", "tab_gather_kernel"),
             "k2": ("flash_",), "gemm": ("gemm", "xmma", "cutlass", "sm90")}
    out = dict.fromkeys(("busy", *kinds, "other"), 0.0)
    calls = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0)) / 1e3
        out["busy"] += dev
        kind = next((k for k, names in kinds.items()
                     if any(n in ev.key for n in names)), "other")
        out[kind] += dev
        calls += ev.count
    return {"wall_ms": 1e3 * wall, "kernels": calls,
            **{f"{k}_ms": v for k, v in out.items()}}


def zero1_witness(torch, model, tcfg, full, rows, mesh) -> dict:
    """One ZeRO-1 update over the mesh held to the one-card AdamW update
    of the same gradients (every rank runs it): the mesh's gradients at
    ``full`` (reduced over "data" in fp32), scaled by a power of two
    until their norm is below half the clip (the clip then does not act,
    so the norm's summation order cannot matter), each data rank passing
    half of them (their fp32 sum is exact), go through ``zero1_apply``
    (the fp32 reduce-scatter onto the shard, the shard's update, the
    all-gather of the bf16 shards); rank 0 holds the gathered params and
    moments against ``optim.adamw_update`` of the gathered gradients on
    one card, bit for bit.  Returns the counts of elements that differ
    (rank 0) and the gradients' norm and scale."""
    import torch.distributed as dist
    from repro_torch.memory.accounting import tree_leaves, tree_map
    from repro_torch.runtime import optim, sharding, train
    specs = model.param_specs()
    dev = next(tree_leaves(full)).device
    params = sharding.shard_tree(full, specs, mesh, device=dev)
    _, grads = train.loss_and_grads(model, tcfg, params, rows, mesh)
    it = iter(grads)
    whole = sharding.gather_tree(tree_map(lambda _: next(it), params),
                                 specs, mesh)
    norm = float(optim.global_norm(whole))
    scale = 2.0 ** -(math.floor(math.log2(norm / tcfg.adamw.grad_clip)) + 2)
    plan = optim.zero1_plan(params, specs, mesh)
    accs = plan.accumulators(dev)
    plan.accumulate(accs, [g * (0.5 * scale) for g in grads])
    del grads
    opt = optim.init_opt_state(params, mesh=mesh, specs=specs)
    optim.zero1_apply(tcfg.adamw, params, accs, opt, plan)
    del accs
    out = {"norm": norm, "scale": scale}
    want = wopt = None
    if mesh.rank == 0:
        want = tree_map(lambda x: x.clone(), full)
        wopt = optim.init_opt_state(want)
        _, _, m = optim.adamw_update(
            tcfg.adamw, want, tree_map(lambda g: g * scale, whole), wopt)
        out["card_norm"] = float(m["grad_norm"])
    del whole
    zspecs = optim.zero1_specs(params, specs, mesh)
    for name, tree, spec, ref in (
            ("params", params, specs, lambda: want),
            ("m", opt["m"], zspecs["m"], lambda: optim.stack_groups(
                wopt["m"])),
            ("v", opt["v"], zspecs["v"], lambda: optim.stack_groups(
                wopt["v"]))):
        got = sharding.gather_tree(tree, spec, mesh)
        if mesh.rank == 0:
            out[f"{name}_differ"] = sum(
                int((a != b).sum()) for a, b in zip(
                    tree_leaves(ref()), tree_leaves(got)))
            out[f"{name}_elements"] = sum(x.numel()
                                          for x in tree_leaves(got))
        del got
    del params, opt, want, wopt
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    return out


def train_mesh_rank(full16, full32, grads32) -> dict:
    """One rank of the train_mesh phase (``launch.mesh.spawn``'s target,
    the world spawned with ``TRAIN_MESH``'s axes): gate B first (on the
    empty card: the bytes of its state, for gate C; one card's loss at
    each step's params on rank 0), the ZeRO-1 witness, then gate A.
    ``full16`` / ``full32`` and ``grads32``
    arrive as CUDA IPC handles on the parent's full trees; each rank
    copies its shards."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import (_kernel_modules, build, instance_counts,
                                     launch_counts, reset_launch_counts)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.memory.accounting import tree_leaves, tree_map
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime import optim, sharding, train
    build.require_built([m.SOURCE for m in _kernel_modules()])
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(TRAIN_MESH["data"], TRAIN_MESH["model"])
    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}

    # gate B (and C): bf16, TRAIN_MESH_B_LAYERS layers, 3 steps
    cfg = train_mesh_config(torch, TRAIN_MESH_B_LAYERS, torch.bfloat16)
    model = DenseLM(cfg)
    specs = model.param_specs()
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = sharding.shard_tree(full16, specs, mesh, device="cuda")
    opt = optim.init_opt_state(params, mesh=mesh, specs=specs)
    rows = train.to_device(train.shard_batch(batch, mesh, TRAIN_ACCUM),
                           torch.device("cuda"))
    torch.cuda.synchronize()
    out["argument_bytes"] = torch.cuda.memory_allocated() - base
    tcfg16 = train_mesh_tcfg(torch, torch.bfloat16)
    step = train.make_train_step(model, tcfg16, mesh)
    td = mesh.transport("data")
    card_model = DenseLM(cfg)           # one card's, bound to no mesh
    whole_batch = train.to_device(batch, torch.device("cuda"))
    steps, total, by_instance = [], {}, {}

    def tally(got: dict, inst: dict) -> None:
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        for k, d in inst.items():
            for j, n in d.items():
                by_instance.setdefault(k, {})
                by_instance[k][j] = by_instance[k].get(j, 0) + n

    for i in range(TRAIN_MESH_STEPS):
        # one card's loss at this step's params (the mesh's, gathered),
        # on rank 0, before the step's counts and clocks start
        snap = sharding.gather_tree(params, specs, mesh)
        card_loss = None
        if mesh.rank == 0:
            card_loss = float(train.loss_and_grads(
                card_model, tcfg16, snap, whole_batch)[0])
        del snap
        torch.cuda.synchronize()
        dist.barrier()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
        for t in mesh.transports().values():
            t.reset_tally()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, opt, rows)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got, inst = launch_counts(), instance_counts()
        tally(got, inst)
        if i == 0:
            out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        # the data replicas of this model shard: the same bits
        hashes = td.all_gather(_param_hashes(torch, params)[None], 0)
        steps.append({"loss": loss, "card_loss": card_loss,
                      "grad_norm": float(m["grad_norm"]),
                      "s": secs, "launches": {k: n for k, n in got.items()
                                              if n},
                      "tally": _tallies(mesh),
                      "replicas_equal": bool((hashes == hashes[0]).all())})
    out["steps"] = steps
    out["trace"] = _traced_mesh_step(torch, step, params, opt, rows,
                                     mesh.rank)
    out["state_bytes"] = {"params": sum(x.numel() * x.element_size()
                                        for x in tree_leaves(params)),
                          "moments": sum(x.numel() * x.element_size()
                                         for x in tree_leaves(opt)),
                          "batch": sum(x.numel() * x.element_size()
                                       for x in rows.values())}
    del params, opt, step, m, card_model, whole_batch
    gc.collect()
    torch.cuda.empty_cache()
    out["zero1"] = zero1_witness(torch, model, tcfg16, full16, rows, mesh)
    del rows
    gc.collect()
    torch.cuda.empty_cache()

    # gate A: the fp32 witness, one step's loss, gradients and norm
    cfg = train_mesh_config(torch, TRAIN_MESH_A_LAYERS, torch.float32)
    model = DenseLM(cfg)
    specs = model.param_specs()
    tcfg = train_mesh_tcfg(torch, torch.float32)
    rows = train.to_device(train.shard_batch(
        _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ), mesh, TRAIN_ACCUM),
        torch.device("cuda"))
    params = sharding.shard_tree(full32, specs, mesh, device="cuda")
    loss, grads = train.loss_and_grads(model, tcfg, params, rows, mesh)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), params)
    whole = sharding.gather_tree(gtree, specs, mesh)
    errs = _leaf_errors(list(tree_leaves(grads32)), list(tree_leaves(whole)))
    del grads, gtree, whole
    opt = optim.init_opt_state(params, mesh=mesh, specs=specs)
    step = train.make_train_step(model, tcfg, mesh)
    reset_launch_counts()
    _, _, m = step(params, opt, rows)
    torch.cuda.synchronize()
    got, inst = launch_counts(), instance_counts()
    tally(got, inst)
    out["gate_a"] = {"loss": float(loss), "step_loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "grad_rel_err": max(errs), "leaf_errs": errs,
                     "launches": {k: n for k, n in got.items() if n}}
    out["launches"], out["instances"] = total, by_instance
    return out


def check_train_mesh(torch, card: str, results: dict, counts: Launches
                     ) -> None:
    """The ``train_mesh`` phase: minicpm-2b at full width trained over a
    (data 2, model 2) mesh of 4 ranks on the one card (``make_train_step``
    with the mesh: row-parallel params, the batch and the ZeRO-1 moments
    over "data", every collective a TAB collective kernel in its group's
    slice of one shared region).  The floor first: one card's fp32
    gradients against its own over 4 microbatches (the same loss; other
    products and another summation order).  Gate A (fp32, 2 of 40
    layers, batch 4 x 1024, accum 2) against the one-card step on the
    same params and batch: the loss within 1e-5 relative, grad_norm
    within 1e-4, every gathered gradient leaf within 1e-4 of its largest
    magnitude (floored at 1e-3 of the tree's;
    ``tests/test_torch_train.py``'s bound) or twice that leaf's floor,
    K2 layers x accum x 2 launches on mma.  Gate B (bf16, 4 layers, 3
    steps, WSD): each step's loss within 0.05 of one card's at the same
    params, the two data replicas of each model shard bit-equal after
    every step, K2 layers x accum x 2 launches a step on every rank and
    TAB collectives on every rank.  The ZeRO-1 witness
    (:func:`zero1_witness`): 0 elements apart.  Gate C: a rank's
    argument bytes (params, moments, batch rows) equal
    ``dryrun.trace_step``'s to the byte; the measured peak printed
    beside the predicted one.  Then the TAB collective at the phase's
    shapes (K4 rows)."""
    import statistics

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import shape_mesh, spawn
    from repro_torch.memory.accounting import tree_map
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime import optim, train
    t0 = time.perf_counter()
    problems = []
    # one card: gate B's bf16 losses, gate A's fp32 loss, grads and norm
    cfg16 = train_mesh_config(torch, TRAIN_MESH_B_LAYERS, torch.bfloat16)
    full16 = DenseLM(cfg16).init(0, device="cuda")
    params = tree_map(lambda x: x.clone(), full16)
    opt = optim.init_opt_state(params)
    step = train.make_train_step(DenseLM(cfg16),
                                 train_mesh_tcfg(torch, torch.bfloat16))
    batch16 = _train_batch(torch, cfg16, TRAIN_BATCH, TRAIN_SEQ)
    want16, norms16, secs16 = [], [], []
    for _ in range(TRAIN_MESH_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = step(params, opt, batch16)
        want16.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs16.append(time.perf_counter() - t)
        norms16.append(float(m["grad_norm"]))
    del params, opt, step, m
    cfg32 = train_mesh_config(torch, TRAIN_MESH_A_LAYERS, torch.float32)
    model32 = DenseLM(cfg32)
    full32 = model32.init(0, device="cuda")
    tcfg32 = train_mesh_tcfg(torch, torch.float32)
    batch32 = train.to_device(_train_batch(torch, cfg32, TRAIN_BATCH,
                                           TRAIN_SEQ), torch.device("cuda"))
    loss32, grads32 = train.loss_and_grads(model32, tcfg32, full32, batch32)
    it = iter(grads32)
    grads32 = tree_map(lambda _: next(it), full32)
    want32 = {"loss": float(loss32),
              "grad_norm": float(optim.global_norm(grads32))}
    _, grads4 = train.loss_and_grads(
        model32, dataclasses.replace(tcfg32, accum_steps=2 * TRAIN_ACCUM),
        full32, batch32)
    floor32 = _leaf_errors(list(_leaves(grads32)), grads4)
    del grads4
    gc.collect()
    torch.cuda.empty_cache()
    # the dry run's prediction of one rank's gate B step (every rank's
    # shards are the same size)
    pred = dryrun.trace_step(DenseLM(cfg16), "train", TRAIN_BATCH, TRAIN_SEQ,
                             shape_mesh(TRAIN_MESH), accum_steps=TRAIN_ACCUM)
    predicted = {k: pred["memory"][k] for k in
                 ("argument_bytes", "temp_bytes", "peak_device_bytes",
                  "moment_bytes", "grad_bytes", "batch_bytes")}
    log(f"train_mesh: one-card references and the dry run took "
        f"{time.perf_counter() - t0:.1f} s; one card's bf16 losses "
        f"{want16} (grad norms {norms16}; ms a step "
        f"{[round(1e3 * x, 1) for x in secs16]} [{card}]), fp32 loss "
        f"{want32['loss']:.6f} "
        f"grad_norm {want32['grad_norm']:.6f}; one card against itself "
        f"over {2 * TRAIN_ACCUM} microbatches: fp32 gradients' worst leaf "
        f"{max(floor32):.2e} of its "
        f"scale (leaves {[f'{e:.1e}' for e in floor32]}); the dry run of "
        f"a rank's step: {predicted}, collectives {pred['collectives']}")
    t1 = time.perf_counter()
    ranks = spawn(train_mesh_rank, math.prod(TRAIN_MESH.values()), full16,
                  full32, grads32, device="cuda",
                  axes=TRAIN_MESH, region_bytes=TRAIN_MESH_REGION,
                  timeout=TRAIN_MESH_TIMEOUT)
    wall = time.perf_counter() - t1
    del full16, full32, grads32
    gc.collect()
    torch.cuda.empty_cache()
    want_k2 = TRAIN_MESH_B_LAYERS * TRAIN_ACCUM * 2
    want_a = TRAIN_MESH_A_LAYERS * TRAIN_ACCUM * 2
    leaf_tol = [max(TRAIN_MESH_GRAD_TOL, 2 * f) for f in floor32]
    log(f"train_mesh: gate A's leaf bounds {[f'{t:.1e}' for t in leaf_tol]}")
    card_losses = [s["card_loss"] for s in ranks[0]["steps"]]
    z = ranks[0]["zero1"]
    log(f"train_mesh ZeRO-1 witness (bf16, {TRAIN_MESH_B_LAYERS} layers): "
        f"the mesh's gradients (norm {z['norm']:.4f}) scaled by "
        f"{z['scale']:g} (the one card's norm {z['card_norm']:.6f}, below "
        f"the clip); after one update, elements that differ from one "
        f"card's AdamW: params {z['params_differ']} of "
        f"{z['params_elements']}, m {z['m_differ']} of {z['m_elements']}, "
        f"v {z['v_differ']} of {z['v_elements']} (0 required)")
    if z["params_differ"] or z["m_differ"] or z["v_differ"]:
        problems.append(f"train_mesh: ZeRO-1's update parts from one "
                        f"card's: {z}")
    for r in ranks:
        tag = f"train_mesh rank {r['rank']} {r['coords']}"
        a = r["gate_a"]
        rel_loss = abs(a["loss"] - want32["loss"]) / abs(want32["loss"])
        rel_step = abs(a["step_loss"] - want32["loss"]) / abs(want32["loss"])
        rel_norm = (abs(a["grad_norm"] - want32["grad_norm"])
                    / want32["grad_norm"])
        log(f"{tag} gate A (fp32, {TRAIN_MESH_A_LAYERS} of 40 layers, "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, accum {TRAIN_ACCUM}): loss "
            f"{a['loss']:.6f} (rel {rel_loss:.2e}; the step's {rel_step:.2e}; "
            f"bound 1e-5), grad_norm {a['grad_norm']:.6f} (rel "
            f"{rel_norm:.2e}, bound 1e-4), gathered gradients' worst error "
            f"{a['grad_rel_err']:.2e} of their leaf's scale (leaves "
            f"{[f'{e:.1e}' for e in a['leaf_errs']]}, each within its "
            f"bound)")
        log(f"{tag} gate A launches {a['launches']} (want {want_a} K2 "
            f"on mma and TAB collectives)")
        if not (rel_loss <= 1e-5 and rel_step <= 1e-5 and rel_norm <= 1e-4
                and all(e <= t for e, t in zip(a["leaf_errs"], leaf_tol))):
            problems.append(f"{tag}: gate A {a} against {want32}")
        if a["launches"].get("flash_attention_mma", 0) != want_a or a[
                "launches"].get("flash_attention_wgmma", 0) or not a[
                "launches"].get("tab_collective", 0):
            problems.append(f"{tag}: gate A launches {a['launches']}")
        secs = [s["s"] for s in r["steps"]]
        for i, s in enumerate(r["steps"]):
            k2 = s["launches"].get("flash_attention_wgmma", 0)
            k4 = s["launches"].get("tab_collective", 0)
            gap = abs(s["loss"] - card_losses[i])
            log(f"{tag} gate B step {i}: loss {s['loss']:.4f} (one card at "
                f"the same params {card_losses[i]:.4f}, apart {gap:.4f} of "
                f"{TRAIN_MESH_LOSS_ATOL}; one card's own run {want16[i]:.4f},"
                f" apart {abs(s['loss'] - want16[i]):.4f}, not held), "
                f"grad_norm {s['grad_norm']:.4f}, "
                f"{1e3 * s['s']:.1f} ms, K2 {k2} (want {want_k2}), TAB "
                f"collectives {k4}, data replicas bit-equal "
                f"{s['replicas_equal']}; tally {s['tally']}")
            if gap > TRAIN_MESH_LOSS_ATOL:
                problems.append(f"{tag} step {i}: loss {s['loss']} against "
                                f"one card's {card_losses[i]} at the same "
                                f"params")
            if not s["replicas_equal"]:
                problems.append(f"{tag} step {i}: data replicas differ")
            if k2 != want_k2 or s["launches"].get(
                    "flash_attention_mma", 0) or not k4:
                problems.append(f"{tag} step {i}: launches {s['launches']}, "
                                f"want {want_k2} K2 on wgmma and TAB "
                                f"collectives")
        log(f"{tag} [{card}]: {1e3 * statistics.median(secs[1:]):.1f} ms a "
            f"step (median of steps 2..{len(secs)}; the first "
            f"{1e3 * secs[0]:.1f} ms), {TRAIN_BATCH * TRAIN_SEQ / statistics.median(secs[1:]):.0f} "
            f"tokens/s across the mesh; peak device memory above its "
            f"arguments {r['peak_bytes'] - r['argument_bytes']} B, of "
            f"{r['peak_bytes']} B in all (predicted "
            f"{predicted['peak_device_bytes']} B in all, "
            f"{predicted['temp_bytes']} B above the arguments); state "
            f"{r['state_bytes']}")
        log(f"{tag} gate C: argument bytes {r['argument_bytes']} measured, "
            f"{predicted['argument_bytes']} predicted by the dry run")
        if r["trace"]:
            t = r["trace"]
            log(f"{tag} [{card}]: one more step traced: {t['wall_ms']:.1f} "
                f"ms of wall, the card busy {t['busy_ms']:.1f} ms "
                f"({100 * t['busy_ms'] / t['wall_ms']:.1f} %; the 4 ranks' "
                f"contexts take turns): the TAB's collective "
                f"{t['tab_ms']:.1f} ms, K2 {t['k2_ms']:.1f}, matmuls "
                f"{t['gemm_ms']:.1f}, the rest {t['other_ms']:.1f} "
                f"({t['kernels']} kernels)")
        if r["argument_bytes"] != predicted["argument_bytes"]:
            problems.append(f"{tag}: argument bytes {r['argument_bytes']} "
                            f"against the dry run's "
                            f"{predicted['argument_bytes']}")
        counts.add(r["launches"], r["instances"])
    log(f"train_mesh: the ranks took {wall:.1f} s (their start included)")
    check_tab_kernel(torch, card, results, TRAIN_MESH_TAB)
    log(f"train_mesh: the phase took {time.perf_counter() - t0:.1f} s")
    if problems:
        raise AssertionError("train_mesh phase: " + "; ".join(problems))
    log("train_mesh: every gate held")


#: the dense phase's runs over the slab: (kv_quant, temperature)
DENSE_RUNS = ((False, 0.0), (False, 0.7), (True, 0.0))
#: the first-8 rule for tokens that need not be bit-equal: the first 8 tokens
#: of the requests agree at this rate at least, and one decode step's
#: max |logit difference| stays within the bound.  The bound is set from
#: the readings at full width and depth (Qwen2.5-14B, 48 layers, on an
#: H100 80GB HBM3): pairs that should agree read 0.000 (the slab against
#: the pools' plain read, bf16 and int8) and 2.7e-4 (fp32, the slab and
#: K1's plain version against K1); the least perturbation it must catch,
#: one bf16 rounding of its own (K1 against its plain version over bf16
#: pools), reads 0.66
MATCH_FIRST8 = 0.75
LOGIT_BOUND = 1e-2
#: depths of the rounding witness's one-step sweep below the phase's own
#: depth, which always ends it
WITNESS_DEPTHS = (1, 4, 16)


def _match_first8(got, want) -> float:
    pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g[:8], w[:8])]
    return sum(a == b for a, b in pairs) / max(len(pairs), 1)


@contextlib.contextmanager
def plain_paged_read():
    """The paged decode read takes K1's plain version on the card: the
    same arithmetic as the slab's read (fp32 scores, probabilities and
    sums over the stored values), where K1 sums in another order."""
    from repro_torch.kernels.paged_attention import ops, ref
    kernel = ops.attend
    ops.attend = ref.paged_attention_ref
    try:
        yield
    finally:
        ops.attend = kernel


def _one_step(torch, model, params, cache, fed: int, pos: int,
              pages=None):
    """One decode step feeding ``fed`` at position ``pos`` (a batch of
    one): its logits, fp32 on the host."""
    out, _ = model.decode_step(
        params, torch.tensor([[fed]], device="cuda"), cache,
        torch.tensor([pos], dtype=torch.int32, device="cuda"), pages)
    return out.float().cpu()


def _slab_from_pools(torch, pools: dict, table, quant: bool) -> dict:
    """A batch-1 slab holding the values a one-slot page table maps:
    every layer's pages gathered in position order (int8 values and
    their scales for an int8 pool)."""
    from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                         gather_scales)
    layers = pools["k_pages"].shape[0]
    slab = {n: torch.stack([gather_pages(pools[f"{n}_pages"][i], table)
                            for i in range(layers)]) for n in ("k", "v")}
    if quant:
        for n in ("k", "v"):
            slab[f"{n}_scale"] = torch.stack(
                [gather_scales(pools[f"{n}_scale"][i], table)
                 for i in range(layers)])
    return slab


def _convert_params(torch, tree, dtype) -> None:
    """Every floating-point leaf of a parameter tree converted in place,
    one leaf at a time, the old copies' memory handed back after each
    item of a list (a layer)."""
    for k, v in list(tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _convert_params(torch, v, dtype)
            if isinstance(tree, list):
                torch.cuda.empty_cache()
        elif v.is_floating_point():
            tree[k] = v.to(dtype)


def check_rounding_witness(torch, card: str, cfg, params, work) -> list:
    """Why K1 and its plain version part at full width: each rounds once
    in its own order, and layers of random weights amplify the
    difference, or K1 errs.  (1) One decode step from the same stored KV
    (a prompt prefilled into pools), K1 against its plain version, at
    ``WITNESS_DEPTHS`` in bf16, then with the same weights in fp32
    (activations and pools: a rounding unit 2^16 times finer): a
    rounding difference shrinks with the unit, a fault does not.  (2) At
    the phase's depth in fp32, the slab contract against K1 itself: the slab
    holding the pools' values takes one step within ``LOGIT_BOUND`` of
    K1's, and greedy runs over the slab and through K1's plain version
    agree with the K1 run under the first-8 rule (>= 0.75).  The
    weights are converted to fp32 in place, leaf by leaf, and back to
    bf16 (exact: every value came from bf16) before it returns.
    Returns the failed gates."""
    import dataclasses
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    prompt = torch.from_numpy(work[0][None]).to("cuda")
    table = torch.tensor([[1, 2, 3]], dtype=torch.int32, device="cuda")
    n = prompt.shape[1]
    problems, gaps, last = [], {}, {}
    depths = tuple(d for d in WITNESS_DEPTHS if d < cfg.num_layers) + (
        cfg.num_layers,)

    def sweep(dtype):
        for depth in depths:
            c = dataclasses.replace(cfg, num_layers=depth, dtype=dtype)
            p = dict(params, layers=params["layers"][:depth])
            pool = DenseLM(c)
            logits, pools = pool.prefill_paged(
                p, prompt, pool.init_paged_cache(4, device="cuda"), table)
            fed = int(logits.argmax())
            k1 = _one_step(torch, pool, p, pools, fed, n, table)
            with plain_paged_read():
                plain = _one_step(torch, pool, p, pools, fed, n, table)
            gaps[dtype, depth] = (k1 - plain).abs().max().item()
            last.update(c=c, pools=pools, fed=fed, k1=k1)
            del pools
        log(f"dense witness: one decode step from the same stored KV, K1 "
            f"against its plain version, max |dlogit| by depth, "
            f"{str(dtype)[6:]} weights, activations and pools [{card}]: "
            + ", ".join(f"{d} layers {gaps[dtype, d]:.3e}"
                        for d in depths))

    t0 = time.perf_counter()
    sweep(torch.bfloat16)
    last.clear()
    log(f"dense witness: device memory allocated before the fp32 weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    _convert_params(torch, params, torch.float32)
    try:
        sweep(torch.float32)
        c32, fed = last["c"], last["fed"]
        slab = _slab_from_pools(torch, last["pools"], table, False)
        mine = _one_step(torch, DenseLM(c32), params, slab, fed, n)
        slab_gap = (mine - last["k1"]).abs().max().item()
        k1_gap = gaps[torch.float32, depths[-1]]
        del slab, last["pools"]
        ratios = [f"{d} layers {gaps[torch.float32, d] / b:.2e}"
                  if (b := gaps[torch.bfloat16, d]) else
                  f"{d} layers - (bf16 0)" for d in depths]
        log(f"dense witness: fp32 over bf16 gap by depth: "
            + ", ".join(ratios)
            + f"; fp32 at {c32.num_layers} layers, one step from the pools' "
              f"values: the slab against K1 {slab_gap:.3e}, K1's plain "
              f"version against K1 {k1_gap:.3e} (bound {LOGIT_BOUND})")
        for what, gap in (("the slab", slab_gap), ("K1's plain version",
                                                   k1_gap)):
            if not gap <= LOGIT_BOUND:
                problems.append(f"fp32 one step: {what} |dlogit| {gap} "
                                f"from K1's")
        runs = {}
        for tag, paged, plain_read in (("paged K1", True, False),
                                       ("paged K1's plain version", True,
                                        True),
                                       ("slab", False, False)):
            with (plain_paged_read() if plain_read
                  else contextlib.nullcontext()):
                server = BatchedServer(DenseLM(c32), params, paged=paged,
                                       prefix_cache=False, **SERVE_KW)
                reqs, secs = serve(server, work, 64)
            runs[tag] = [r.output for r in reqs]
            if server.stats["nonfinite_logits"]:
                problems.append(f"fp32 {tag}: non-finite logits")
            if tag != "paged K1":
                m = _match_first8(runs[tag], runs["paged K1"])
                log(f"dense witness: fp32 greedy at {c32.num_layers} layers "
                    f"(64 new tokens), {tag} against the paged K1 run: "
                    f"first-8 match {m:.3f}, all tokens equal "
                    f"{runs[tag] == runs['paged K1']}")
                if m < MATCH_FIRST8:
                    problems.append(f"fp32 {tag}: first-8 match {m} "
                                    f"against K1's run")
    finally:
        _convert_params(torch, params, torch.bfloat16)
    log(f"dense witness: {time.perf_counter() - t0:.1f} s, the weights "
        f"back in bf16")
    return problems


def check_quant_prefill(torch, cfg, params, prompt) -> list:
    """``kv_quant``'s prefill, as the reference's: attention over the
    unquantized KV, then the slab stores int8 values and bf16 scales of
    exactly that KV.  So its logits are the bf16 slab's bit for bit, and
    its slab is ``kv_quantize`` of the bf16 slab's values, every layer.
    Returns the failed gates."""
    import dataclasses
    from repro_torch.models.layers import kv_quantize
    from repro_torch.models.transformer import DenseLM
    got = {}
    for quant in (False, True):
        model = DenseLM(dataclasses.replace(cfg, kv_quant=quant))
        got[quant] = model.prefill(params, prompt, model.init_cache(
            1, SERVE_KW["max_seq"], device="cuda"))
    n = prompt.shape[1]
    (lb, cb), (lq, cq) = got[False], got[True]
    want = {}
    for name in ("k", "v"):
        want[name], want[f"{name}_scale"] = kv_quantize(cb[name][:, :, :, :n])
    same = {name: torch.equal(cq[name][:, :, :, :n], w)
            for name, w in want.items()}
    log(f"dense: kv_quant prefill of an {n}-token prompt at "
        f"{cfg.num_layers} layers: logits bit-equal to the bf16 slab's "
        f"{torch.equal(lb, lq)}; slab bit-equal to kv_quantize of the bf16 "
        f"slab, by leaf {same}")
    if not (torch.equal(lb, lq) and all(same.values())):
        return [f"kv_quant prefill: logits equal {torch.equal(lb, lq)}, "
                f"slab leaves equal {same}"]
    return []


def check_dense(torch, card: str, cfg, params, counts: Launches,
                served: dict | None) -> None:
    """Qwen2.5-14B at full width and the serve phase's depth (its weights)
    served over the dense per-slot slab (``paged=False``) on the serve
    phase's four 8-token prompts (64 new tokens, batch 4, block 32,
    max_seq 384, seed 0): bf16 greedy and at 0.7, and ``kv_quant`` (int8
    values, bf16 scales a token and head) greedy.  K1 launches 0 times
    (the slab's decode read is plain torch), K2 once a layer an admission
    on the wgmma route.

    Two valid reads of the same stored KV round differently, and at full
    width with random weights the top logits sit so close that greedy
    tokens part early: the phase measures that floor in the same call, K1
    against its plain version (``plain_paged_read``) over the same pools,
    and ``check_rounding_witness`` shows it is rounding (the gap shrinks
    with fp32's unit) and holds the slab to K1 itself in fp32.  Gates in
    bf16 and int8: (1) from identical stored KV (a prompt prefilled into
    pools; the slab holds those values, int8 and scales for
    ``kv_quant``), one decode step over the slab is within
    ``LOGIT_BOUND`` of the same step over the pools through the plain
    read, whose arithmetic the slab's read shares; (2) the bf16 slab
    runs' tokens agree with the paged runs through the plain read under
    the first-8 rule (match >= 0.75); (3) ``kv_quant``: its prefill
    gives the bf16 slab's logits and stores ``kv_quantize`` of its
    values (``check_quant_prefill``), so each request's first token is
    the bf16 greedy slab run's.  Its later tokens are held to no pool
    run: the reference's dense prefill attends the unquantized KV where
    an int8 pool's attends its round trip.  Reported beside them: each
    slab run against the K1 run of its pool precision (the serve phase's
    when it ran).  Timed in turns with a paged bf16 greedy
    run (paged, slab runs, paged); prints ms a step, tok/s, the slab's
    bytes beside the paged pool's peak bytes and its ``fragmentation()``
    one block into the run, and peak device memory."""
    import dataclasses
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    work = prompts(cfg.vocab, 0)[:4]
    problems, timing = [], {}

    def paged_run(kv, temperature, tag):
        """A paged run, one block first to read the pool mid-run."""
        from repro_torch.kernels import reset_launch_counts
        model = DenseLM(dataclasses.replace(cfg, kv_dtype=kv))
        server = BatchedServer(model, params, prefix_cache=False,
                               **dict(SERVE_KW, temperature=temperature))
        reqs = [server.submit(p, max_new_tokens=64) for p in work]
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.run_once(max_blocks=1)
        frag = server.manager.fragmentation()
        live, pages = server.kv_bytes_in_use(), server.manager.pages_in_use
        server.run_once()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = server.stats
        log(f"dense {tag} [{card}]: {1e3 * secs / st['steps']:.2f} ms a "
            f"decode step, {sum(len(r.output) for r in reqs) / secs:.1f} "
            f"tok/s; pool after one block: {pages} pages in use, {live} "
            f"bytes live of {server.kv_bytes_capacity()} provisioned, "
            f"fragmentation {frag:.4f}; peak {st['kv_pages_hwm']} pages = "
            f"{st['kv_pages_hwm'] * (live // max(pages, 1))} bytes")
        timing.setdefault(tag, []).append(secs / st["steps"])
        return [r.output for r in reqs]

    k1 = {k: v[:4] for k, v in (served or {}).items()}
    k1[None, 0.0] = paged_run(None, 0.0, "paged bf16 greedy")
    for kv, temperature in ((None, 0.7), ("int8", 0.0)):
        if (kv, temperature) not in k1:
            k1[kv, temperature] = paged_run(kv, temperature,
                                            f"paged kv_dtype={kv} "
                                            f"temperature={temperature}")
    plain = {}
    with plain_paged_read():
        for kv, temperature in ((None, 0.0), (None, 0.7), ("int8", 0.0)):
            plain[kv, temperature] = paged_run(
                kv, temperature, f"paged kv_dtype={kv} temperature="
                                 f"{temperature}, K1's plain version")
    for kv in (None, "int8"):
        floor = _match_first8(plain[kv, 0.0], k1[kv, 0.0])
        log(f"dense: two valid reads of kv_dtype={kv} pools at full width, "
            f"K1's plain version against K1, greedy: first-8 match "
            f"{floor:.3f}, all tokens equal {plain[kv, 0.0] == k1[kv, 0.0]}")

    # one step from identical stored KV: pools, and the slab holding them
    prompt = torch.from_numpy(work[0][None]).to("cuda")
    table = torch.tensor([[1, 2, 3]], dtype=torch.int32, device="cuda")
    n = prompt.shape[1]
    for kv in (None, "int8"):
        pool = DenseLM(dataclasses.replace(cfg, kv_dtype=kv))
        logits, pools = pool.prefill_paged(
            params, prompt, pool.init_paged_cache(4, device="cuda"), table)
        fed = int(logits.argmax())
        slab = _slab_from_pools(torch, pools, table, kv is not None)
        dense = DenseLM(dataclasses.replace(cfg, kv_quant=kv is not None))
        mine = _one_step(torch, dense, params, slab, fed, n)
        step_k1 = _one_step(torch, pool, params, pools, fed, n, table)
        with plain_paged_read():
            step_plain = _one_step(torch, pool, params, pools, fed, n, table)
        err = (mine - step_plain).abs().max().item()
        log(f"dense: one decode step from the same stored KV "
            f"(kv_dtype={kv} pools; the slab holds their values): slab "
            f"against the pools' plain read max |dlogit| {err:.3e} (bound "
            f"{LOGIT_BOUND}); against K1 "
            f"{(mine - step_k1).abs().max().item():.3e}, K1's plain version "
            f"against K1 {(step_plain - step_k1).abs().max().item():.3e} "
            f"(logits: max |x| {step_k1.abs().max().item():.2f}, std "
            f"{step_k1.std().item():.2f})")
        if not err <= LOGIT_BOUND:
            problems.append(f"kv_dtype={kv}: one step over the slab "
                            f"|dlogit| {err} from the pools' plain read")

    slabs = {}
    for quant, temperature in DENSE_RUNS:
        model = DenseLM(dataclasses.replace(cfg, kv_quant=quant))
        torch.cuda.reset_peak_memory_stats()
        server = BatchedServer(model, params, paged=False,
                               **dict(SERVE_KW, temperature=temperature))
        server.tag = tag = f"slab kv_quant={quant} temperature={temperature}"
        toks, secs, got = counts.run(torch, server, work)
        st = server.stats
        slab = server.kv_bytes_in_use()
        key = ("int8" if quant else None), temperature
        timing.setdefault(tag, []).append(secs / st["steps"])
        log(f"dense {tag} [{card}]: {1e3 * secs / st['steps']:.2f} ms a "
            f"decode step, {sum(len(t) for t in toks) / secs:.1f} tok/s, "
            f"slab {slab} bytes ({tuple(server.cache['k'].shape)} "
            f"{server.cache['k'].dtype} k and v"
            f"{' + bf16 scales' if quant else ''}), max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{ {k: c for k, c in got.items() if c} }; first-8 match "
            f"against the paged run of its pool precision through the "
            f"plain read {_match_first8(toks, plain[key]):.3f}, through K1 "
            f"{_match_first8(toks, k1[key]):.3f}")
        if server.paged or st["nonfinite_logits"]:
            problems.append(f"{tag}: paged {server.paged}, non-finite "
                            f"{st['nonfinite_logits']}")
        if not quant and _match_first8(toks, plain[key]) < MATCH_FIRST8:
            problems.append(f"{tag}: first-8 match "
                            f"{_match_first8(toks, plain[key])} against "
                            f"the plain read's paged run")
        slabs[quant, temperature] = toks
    firsts = [[t[0] for t in slabs[q, 0.0]] for q in (False, True)]
    log(f"dense: first tokens, bf16 slab greedy {firsts[0]}, kv_quant slab "
        f"greedy {firsts[1]}")
    if firsts[0] != firsts[1]:
        problems.append(f"kv_quant: first tokens {firsts[1]}, the bf16 "
                        f"slab's {firsts[0]}")
    for quant in (False, True):
        for temperature in (0.0, 0.7):
            problems += graph_vs_eager(
                torch, card, f"Qwen2.5-14B slab kv_quant={quant} "
                             f"temperature={temperature}",
                DenseLM(dataclasses.replace(cfg, kv_quant=quant)), params,
                temperature=temperature, paged=False)
    problems += check_quant_prefill(torch, cfg, params, prompt)
    del server, model
    paged_run(None, 0.0, "paged bf16 greedy")
    log(f"dense: ms a decode step by run, in the order run [{card}]: "
        + ", ".join(f"{k} {[round(1e3 * v, 2) for v in vs]}"
                    for k, vs in timing.items()))
    gc.collect()
    problems += check_dense_offload(torch, card, cfg, params, counts)
    gc.collect()
    problems += check_rounding_witness(torch, card, cfg, params, work)
    if problems:
        raise AssertionError("dense phase: " + "; ".join(problems))
    log("dense: every gate held")


#: the dense phase's offload_kv runs: the first 6 of the 48 layers, 8
#: new tokens a request in one block of 8 steps (a block runs all its
#: steps; the tokens were cut from 16, then the depth from 24 to 12 when
#: the graph checks joined the default run, and to 6 when the tp phase
#: took both notices, to keep its time)
DENSE_OFFLOAD_LAYERS = 6
DENSE_OFFLOAD_NEW = 8
OFFLOAD_KW = dict(SERVE_KW, block_size=DENSE_OFFLOAD_NEW)
#: (kv_quant, temperature) of its runs
DENSE_OFFLOAD_RUNS = ((False, 0.0), (False, 0.7), (True, 0.0), (True, 0.7))


def kv_tier_bytes(server, tier: str) -> int:
    """The ledger's KV lines in ``tier``: under ``offload_kv`` the cache
    at rest (remote ``kv_pool``), the window and a pattern model's tail
    (local ``kv_pool_window`` and ``kv_pool``)."""
    by = server.tier_stats()[tier]["by_class"]
    return by.get("kv_pool", 0) + by.get("kv_pool_window", 0)


def offload_gates(tag: str, mem, cache: dict, passes: int,
                  problems: list) -> None:
    """``offload_kv``'s gates on a run over a slab at rest: nothing
    degraded, the cache's stacked leaves the KV window's, each in pinned
    host memory and none on the device, and ``passes`` layer (group)
    slices paged in and as many written back (the window is the run's
    own: one per server or model-level cache)."""
    win = mem.kv_window
    if mem.degraded or win is None or not mem.kv_offloaded(cache):
        problems.append(f"{tag}: not offloaded ({mem.describe()})")
        return
    bad = [p for p, t in win.leaves if t.is_cuda or not t.is_pinned()]
    if bad:
        problems.append(f"{tag}: slab leaves {bad} not in pinned host "
                        f"memory")
    if not win.fetches == win.writebacks == passes:
        problems.append(f"{tag}: {win.fetches} slices paged in, "
                        f"{win.writebacks} written back, expected {passes}")


def check_dense_offload(torch, card: str, cfg, params,
                        counts: Launches) -> list:
    """Qwen2.5-14B over the dense slab with ``offload_kv`` and paged
    weights, at the first ``DENSE_OFFLOAD_LAYERS`` of ``params``' layers,
    on the serve phase's four prompts (``DENSE_OFFLOAD_NEW`` new tokens,
    batch 4, one block, max_seq 384): bf16 and ``kv_quant``, greedy and at
    0.7.  Each against the resident slab's run at the same depth (resident
    weights, the slab in device memory): the same tokens, bit for bit;
    the slab's leaves in pinned host memory and none on the device; the
    window's slices paged in and written back ``layers x steps`` times
    (an admission prefills a staged device row); K1 never, K2 once a
    layer an admission (``Launches.run``).  Timed in turns with the
    same placed weights serving the slab from device memory (paged bf16
    greedy first and last).  Prints ms a step, peak device memory above
    what the run started with, the slab's bytes at rest beside the
    window's, and the link's rates.  Returns the problems."""
    import dataclasses
    import statistics
    from repro_torch.memory import LOCAL, REMOTE, PinLocal
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    depth, new = DENSE_OFFLOAD_LAYERS, DENSE_OFFLOAD_NEW
    cfg = dataclasses.replace(cfg, num_layers=depth)
    params = dict(params, layers=params["layers"][:depth])
    work = prompts(cfg.vocab, 0)[:4]
    problems, want = [], {}
    for quant, temperature in DENSE_OFFLOAD_RUNS:
        server = BatchedServer(
            DenseLM(dataclasses.replace(cfg, kv_quant=quant)), params,
            paged=False, **dict(OFFLOAD_KW, temperature=temperature))
        server.tag = tag = (f"resident slab at {depth} layers kv_quant="
                            f"{quant} temperature={temperature}")
        want[quant, temperature], secs, _ = counts.run(torch, server, work,
                                                       new)
        log(f"dense offload_kv: {tag} [{card}]: "
            f"{1e3 * secs / server.stats['steps']:.2f} ms a decode step "
            f"(admissions included)")
    del server
    pcfg = cfg.with_pager(enabled=True, lookahead=1, offload_kv=True)
    model = DenseLM(pcfg)
    mem = model.mem
    t0 = time.perf_counter()
    placed = dict(params, layers=mem.place_layer_weights(params["layers"]))
    torch.cuda.synchronize()
    log(f"dense offload_kv: placed {depth} layers ({placed['layers'].nbytes}"
        f" bytes) in pinned host memory in {time.perf_counter() - t0:.1f} s;"
        f" host MemAvailable {host_mem('MemAvailable')}")
    # one orchestrator (its placed weights and prefetcher) for both slabs
    models = {False: model, True: DenseLM(dataclasses.replace(
        pcfg, kv_quant=True))}
    models[True].mem = mem
    pf = mem.prefetcher
    timing: dict = {}

    def run(quant: bool, temperature: float, offload: bool) -> None:
        policy = mem.policies["kv_pool"]
        if not offload:
            mem.policies["kv_pool"] = PinLocal()
        try:
            srv = BatchedServer(models[quant], placed, paged=False,
                                **dict(OFFLOAD_KW, temperature=temperature))
        finally:
            mem.policies["kv_pool"] = policy
        srv.tag = tag = " ".join([
            "offload_kv" if offload else "paged weights, slab in device "
            "memory", f"kv_quant={quant} temperature={temperature}"])
        if not offload and not all(t.is_cuda for t in _leaves(srv.cache)):
            problems.append(f"{tag}: the slab left the device")
        f0, b0 = pf.fetches, pf.fetched_bytes
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        toks, secs, _ = counts.run(torch, srv, work, new)
        st = srv.stats
        ms = 1e3 * secs / st["steps"]
        timing.setdefault(tag, []).append(round(ms, 2))
        fetches, weights = pf.fetches - f0, pf.fetched_bytes - b0
        line = (f"dense {tag} [{card}]: {ms:.2f} ms a decode step "
                f"(admissions included), {sum(map(len, toks)) / secs:.2f} "
                f"tok/s, steps {st['steps']}, admissions {st['admitted']}, "
                f"weight fetches {fetches} ({weights} bytes), peak device "
                f"memory {(torch.cuda.max_memory_allocated() - base) / 2**30:.3f}"
                f" GiB above the {base / 2**30:.2f} GiB held before the run")
        if offload:
            win = mem.kv_window
            kv_in = win.fetches * win.slot_bytes
            kv_out = win.writebacks * win.slot_bytes
            line += (f"; slab at rest {kv_tier_bytes(srv, REMOTE)} bytes "
                     f"(pinned host), KV window {win.window_bytes} bytes "
                     f"(ledger local {kv_tier_bytes(srv, LOCAL)}); KV slices "
                     f"paged in {win.fetches}, written back "
                     f"{win.writebacks}; host-to-device "
                     f"{_gbps(weights + kv_in, secs)} GB/s over the run "
                     f"({weights} weight + {kv_in} KV bytes), "
                     f"device-to-host {_gbps(kv_out, secs)} GB/s ({kv_out} "
                     f"KV bytes)")
            offload_gates(tag, mem, srv.cache, depth * st["steps"],
                          problems)
        log(line)
        if toks != want[quant, temperature]:
            problems.append(f"{tag}: tokens differ from the resident "
                            f"slab's")
        if fetches != depth * (st["steps"] + st["admitted"]):
            problems.append(f"{tag}: {fetches} weight fetches")

    run(False, 0.0, offload=False)
    for quant, temperature in DENSE_OFFLOAD_RUNS:
        run(quant, temperature, offload=True)
    run(False, 0.0, offload=False)
    paged = timing.pop("paged weights, slab in device memory kv_quant="
                       "False temperature=0.0")
    off = timing["offload_kv kv_quant=False temperature=0.0"][0]
    log(f"dense offload_kv cost [{card}]: ms a decode step, paged weights "
        f"with the slab in device memory {paged} (first and last), "
        f"offload_kv {timing}; bf16 greedy "
        f"{100 * (off / statistics.mean(paged) - 1):+.2f}% against the "
        f"paged mean")
    del placed, models, model, mem, pf
    return problems


# ---------------------------------------------------------------------------
# KV across the tiers
# ---------------------------------------------------------------------------

#: the tiers phase's pool for preemption: 12 usable pages against four
#: requests of 5 worst-case pages each (8-token prompts, 64 new tokens,
#: page 16), so two decode at once and the backlog head must preempt
TIERS_POOL = 13


class Launches:
    """Kernel launches summed over a phase's runs (tiers, moe, gpt3,
    dense); each run's counts are reset just before it and read just
    after."""

    def __init__(self, phase: str = "tiers"):
        self.phase = phase
        self.total: dict = {}
        self.by_instance: dict = {}

    def add(self, got: dict, inst: dict) -> None:
        """Sum one run's launches, by kernel and by instantiation."""
        for k, n in got.items():
            self.total[k] = self.total.get(k, 0) + n
        for k, d in inst.items():
            mine = self.by_instance.setdefault(k, {})
            for i, n in d.items():
                mine[i] = mine.get(i, 0) + n

    def run(self, torch, server, work, new: int = 64,
            attn_layers: int | None = None):
        """Serve ``work`` once (``new`` new tokens each) and count: K1
        once a layer a decode step (never over the dense slab), K2 once
        an attention layer (``attn_layers``, default every layer) an
        admission on the wgmma route; returns (tokens, seconds, this
        run's launches)."""
        from repro_torch.kernels import (instance_counts, launch_counts,
                                         reset_launch_counts)
        reset_launch_counts()
        reqs, secs = serve(server, work, new)
        got = launch_counts()
        self.add(got, instance_counts())
        tokens = [r.output for r in reqs]
        tag = getattr(server, "tag", "")
        if any(len(t) != new for t in tokens) or any(r.error for r in reqs):
            raise AssertionError(f"{self.phase} {tag}: a request did not emit its "
                                 f"{new} tokens: {[r.error for r in reqs]}")
        st, cfg = server.stats, server.model.cfg
        kernel = "paged_attention" + ("" if cfg.kv_dtype is None
                                      else f"_{cfg.kv_dtype}")
        if st["nonfinite_logits"]:
            raise AssertionError(f"{self.phase} {tag}: non-finite logits")
        k1 = sum(n for k, n in got.items() if k.startswith("paged_attention"))
        if not server.paged:
            if k1:
                raise AssertionError(f"{self.phase} {tag}: {k1} K1 launches "
                                     f"over the dense slab")
        elif got[kernel] != cfg.num_layers * st["steps"]:
            raise AssertionError(f"{self.phase} {tag}: {got[kernel]} K1 launches "
                                 f"for {st['steps']} decode steps")
        if attn_layers is None:
            attn_layers = cfg.num_layers
        if (got["flash_attention_wgmma"] != attn_layers * st["admitted"]
                or got["flash_attention_mma"]):
            raise AssertionError(f"{self.phase} {tag}: K2 launches {got} for "
                                 f"{st['admitted']} admissions")
        capture_bound(server, f"{self.phase} {tag}")
        return tokens, secs, got


def _gbps(nbytes: float, secs: float) -> str:
    return f"{nbytes / secs / 1e9:.2f}" if secs > 0 else "n/a"


def tier_report(server, card: str) -> None:
    """Stash bytes per tier, each transfer kind's measured rate, and the
    ledger's modeled seconds for the same bytes."""
    sw, led = server.swapper, server.mem.ledger
    log(f"tiers {server.tag} [{card}]: stash peak bytes per tier "
        f"{sw.stash_hwm()}, stash bytes left {sw.outstanding_bytes}")
    for what, t in sorted(sw.timings.items()):
        log(f"  measured {what}: {t['count']} transfers, {t['bytes']} bytes "
            f"in {t['seconds'] * 1e3:.3f} ms wall = "
            f"{_gbps(t['bytes'], t['seconds'])} GB/s")
    for edge, x in led.transfers().items():
        log(f"  modeled {edge} (the paper's DEFAULT_TIER_LINKS, not this "
            f"card): {x['count']} transfers, {x['bytes']} bytes, "
            f"{x['modeled_s'] * 1e3:.4f} ms = "
            f"{_gbps(x['bytes'], x['modeled_s'])} GB/s")


def swap_cost(torch, card: str, page_bytes: int) -> None:
    """Where a swap's wall time goes: for stashes of 1 and 24 pages of
    ``page_bytes`` each, the median of five of each step a transfer takes
    -- a new tier buffer (remote: an exact-size registered pinned
    buffer; cold: pageable), a device-to-host copy into each, a
    host-to-device copy from pinned memory, and the park and promote
    copies -- as ``PageSwapper`` does them."""
    import statistics
    from repro_torch.memory import COLD, REMOTE, tiers

    def ms(fn):
        out = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(out)

    for pages in (1, 24):
        n = pages * page_bytes
        dev = torch.empty(n, dtype=torch.uint8, device="cuda")
        pinned = tiers.tier_empty((n,), torch.uint8, REMOTE, device="cuda")
        pageable = tiers.tier_empty((n,), torch.uint8, COLD, device="cuda")
        steps = {
            "new remote buffer (register + unregister)":
                lambda: tiers.tier_empty((n,), torch.uint8, REMOTE,
                                         device="cuda"),
            "new cold buffer (pageable)": lambda: tiers.tier_empty(
                (n,), torch.uint8, COLD, device="cuda"),
            "D2H into registered pinned": lambda: pinned.copy_(
                dev, non_blocking=True),
            "D2H into pageable": lambda: pageable.copy_(dev),
            "H2D from registered pinned": lambda: dev.copy_(
                pinned, non_blocking=True),
            "pinned -> new pageable (park)": lambda: tiers.to_tier(
                pinned, COLD, device="cuda"),
            "pageable -> new pinned (promote)": lambda: tiers.to_tier(
                pageable, REMOTE, device="cuda"),
        }
        for what, fn in steps.items():
            t = ms(fn)
            log(f"swap cost [{card}]: {pages} page(s), {n} bytes: {what} "
                f"{t:.3f} ms = {_gbps(n, t / 1e3)} GB/s")


def check_tiers(torch, card: str, cfg, params, counts: Launches,
                served: dict | None) -> None:
    """Preemption over the three pool dtypes at both temperatures,
    preemption mid-decode (a stash of pages decode wrote) and cold
    parking.  ``served``: the
    serve phase's tokens by (kv_dtype, temperature) when it ran these
    settings at this depth (its first four requests are this phase's
    workload, in the same slots); else the uncontended runs are made
    here."""
    import dataclasses
    from repro_torch.memory import REMOTE, FaultPlan, fault_plan
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    work = prompts(cfg.vocab, 0)[:4]
    swap_cost(torch, card, 2 * cfg.num_layers * SERVE_KW["page_size"]
              * cfg.num_kv_heads * cfg.head_dim * 2)

    def server(kv, temperature, **kw):
        model = DenseLM(dataclasses.replace(cfg, kv_dtype=kv))
        srv = BatchedServer(model, params, audit=True,
                            **dict(SERVE_KW, temperature=temperature), **kw)
        srv.tag = " ".join([f"kv_dtype={kv} temperature={temperature}"]
                           + [f"{k}={v}" for k, v in kw.items()])
        return srv

    uncontended = {}
    for kv, temperature in SERVE_RUNS:
        if served is not None:
            want, base = served[kv, temperature][:4], "the serve phase's run"
        else:
            want, base_s, _ = counts.run(torch, server(kv, temperature), work)
            base = f"{base_s:.3f} s uncontended"
        uncontended[kv, temperature] = want
        srv = server(kv, temperature, num_pages=TIERS_POOL)
        got, secs, launches = counts.run(torch, srv, work)
        st = srv.stats
        log(f"tiers {srv.tag} [{card}]: {secs:.3f} s ({base}), steps "
            f"{st['steps']}, admissions {st['admitted']}, preemptions "
            f"{st['preemptions']} ({st['preempted_pages']} pages), resumes "
            f"{st['resumes']}, launches "
            f"{ {k: n for k, n in launches.items() if n} }")
        tier_report(srv, card)
        if got != want:
            raise AssertionError(f"tiers {srv.tag}: preempted tokens differ "
                                 f"from the uncontended run's")
        if st["preemptions"] < 1 or st["resumes"] != st["preemptions"] \
                or st["sheds"]:
            raise AssertionError(f"tiers {srv.tag}: {st}")
    # the pool runs dry after the first block: the victims have decoded
    # 32 tokens past their 8-token prompts, 3 pages each, which K1's
    # decode steps wrote
    for kv, temperature in ((None, 0.0), ("fp8_e4m3", 0.7)):
        srv = server(kv, temperature)
        srv.tag += " mid-decode pool exhaustion at block 1"
        with fault_plan(FaultPlan(exhaust_at_block=1, exhaust_blocks=2)):
            got, secs, _ = counts.run(torch, srv, work)
        st = srv.stats
        log(f"tiers {srv.tag} [{card}]: {secs:.3f} s, steps {st['steps']}, "
            f"pool faults {st['pool_faults']}, preemptions "
            f"{st['preemptions']} ({st['preempted_pages']} pages), resumes "
            f"{st['resumes']}")
        tier_report(srv, card)
        if got != uncontended[kv, temperature]:
            raise AssertionError(f"tiers {srv.tag}: tokens differ from the "
                                 f"uncontended run's")
        if (st["pool_faults"] != 1 or st["preemptions"] < 1
                or st["preempted_pages"] < 3 * st["preemptions"]
                or st["resumes"] != st["preemptions"] or st["sheds"]):
            raise AssertionError(f"tiers {srv.tag}: {st}")
    for park_after in (0, 1):
        srv = server(None, 0.0, num_pages=TIERS_POOL,
                     cold_park_after_blocks=park_after)
        led, flat = srv.mem.ledger, []
        preempt = srv._preempt_slot

        def watched(i, finished, preempt=preempt, led=led, flat=flat):
            before = led.hwm(REMOTE)
            preempt(i, finished)
            flat.append(led.hwm(REMOTE) == before)

        srv._preempt_slot = watched
        got, secs, _ = counts.run(torch, srv, work)
        st = srv.stats
        log(f"tiers {srv.tag} [{card}]: {secs:.3f} s, preemptions "
            f"{st['preemptions']}, cold parks {st['cold_parks']}, promotes "
            f"{st['cold_promotes']}, remote hwm flat through each swap-out "
            f"{flat}")
        tier_report(srv, card)
        if got != uncontended[None, 0.0]:
            raise AssertionError(f"tiers {srv.tag}: tokens differ from the "
                                 f"uncontended run's")
        if (st["cold_parks"] < 1 or st["cold_promotes"] != st["cold_parks"]
                or st["resumes"] != st["preemptions"]):
            raise AssertionError(f"tiers {srv.tag}: {st}")
        if park_after == 0 and not all(flat):
            raise AssertionError(f"tiers {srv.tag}: a swap-out raised the "
                                 f"remote tier's high-water mark")
    log("tiers: preempted (at admission and mid-decode) and cold-parked "
        "tokens equal the uncontended runs'; every victim resumed, every "
        "park promoted back")


#: the offload_kv run's depth: the first quarter of Qwen2.5-14B's 48
#: layers.  Its gates hold its runs to a resident run at the same depth.
#: At 48 layers it took ~257 s of a ~1011 s default run on an H100 80GB
#: HBM3 at 700 W (four timed runs bound by PCIe); at 24, 122-145 s, and
#: with the dense phase's offload_kv runs a slow card's default run passed
#: 1200 s (see ``DISAGG_LAYERS``); 68.1 s at 12; 6 since the tp phase's
#: row-parallel runs and family spawn (~100 s more)
OFFLOAD_LAYERS = 6


def check_offload(torch, card: str, cfg, params, counts: Launches) -> None:
    """``offload_kv`` with paged weights, bf16 greedy, at ``cfg``'s depth
    (the first ``cfg.num_layers`` of ``params["layers"]``): a resident
    run first, then the same tokens with the weights paged and the KV
    pools at rest in pinned host memory, nothing degraded, every layer's
    pool slice paged in and written back once a step and once an
    admission; then the same with the pool run dry mid-decode
    (preemption swaps from pools at rest in pinned host memory).  The
    offload's cost: the same weights, paged the same way, serve the same
    four prompts with the pools in device memory, interleaved with the
    offloaded runs (paged, offload, offload, paged).  Uses
    ``params["layers"]`` (re-made from the same seed if an earlier run
    already moved them to the host)."""
    import gc
    import statistics
    from repro_torch.memory import (LOCAL, FaultPlan, PagedLayers, PinLocal,
                                    fault_plan)
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    if isinstance(params["layers"], PagedLayers):
        params["layers"] = None
        gc.collect()
        params["layers"] = DenseLM(cfg).init(0, device="cuda")["layers"]
    params = dict(params, layers=params["layers"][:cfg.num_layers])
    work = prompts(cfg.vocab, 0)[:4]
    srv = BatchedServer(DenseLM(cfg), params,
                        **dict(SERVE_KW, temperature=0.0))
    srv.tag = f"resident at {cfg.num_layers} layers (offload's reference)"
    want, _, _ = counts.run(torch, srv, work)
    del srv
    model = DenseLM(cfg.with_pager(enabled=True, lookahead=1,
                                   offload_kv=True))
    mem = model.mem
    params["layers"] = mem.place_layer_weights(params["layers"])
    gc.collect()
    torch.cuda.synchronize()

    def server(offload: bool, **kw):
        """A server on the placed weights; without ``offload`` its pools
        stay in device memory (the kv_pool policy is PinLocal while it
        places them)."""
        policy = mem.policies["kv_pool"]
        if not offload:
            mem.policies["kv_pool"] = PinLocal()
        try:
            srv = BatchedServer(model, params,
                                **dict(SERVE_KW, temperature=0.0), **kw)
        finally:
            mem.policies["kv_pool"] = policy
        srv.tag = " ".join(
            ["offload_kv" if offload else "paged weights, pools in device "
             "memory", "kv_dtype=None temperature=0.0"]
            + [f"{k}={v}" for k, v in kw.items()])
        if offload and (mem.degraded or srv.cache["k_pages"].is_cuda
                        or not all(t.is_pinned()
                                   for t in srv.cache.values())):
            raise AssertionError(f"offload: {mem.describe()}; pools at "
                                 f"rest must be pinned host memory")
        if not offload and not srv.cache["k_pages"].is_cuda:
            raise AssertionError("paged weights: the pools left the device")
        return srv

    def run(offload: bool, checked: bool = False):
        srv = server(offload)
        win, pf = mem.kv_window, mem.prefetcher
        w0, f0 = (win.fetches if offload else 0), pf.fetches
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got, secs, _ = counts.run(torch, srv, work)
        st = srv.stats
        ms = 1e3 * secs / st["steps"]
        passes = cfg.num_layers * (st["steps"] + st["admitted"])
        log(f"{srv.tag} [{card}]: {sum(len(t) for t in got)} tokens in "
            f"{secs:.3f} s = {sum(len(t) for t in got) / secs:.2f} tok/s "
            f"({ms:.1f} ms per decode step, admissions included), steps "
            f"{st['steps']}, admissions {st['admitted']}, layer weight "
            f"fetches {pf.fetches - f0}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
            f"above the {base / 2**30:.2f} GiB held before the run")
        if got != want:
            raise AssertionError(f"{srv.tag}: tokens differ from the "
                                 f"resident run's")
        if pf.fetches - f0 != passes:
            raise AssertionError(f"{srv.tag}: {pf.fetches - f0} weight "
                                 f"fetches, expected {passes}")
        if offload and not (win.fetches - w0 == win.writebacks == passes):
            raise AssertionError(f"offload: {win.fetches - w0} slices paged "
                                 f"in, {win.writebacks} written back, "
                                 f"expected {passes}")
        if checked:
            log(f"offload_kv [{card}]: KV slices paged in "
                f"{win.fetches - w0}, written back {win.writebacks}; KV "
                f"window {win.window_bytes} bytes in device memory against "
                f"the resident pool's {srv.kv_bytes_capacity()} bytes "
                f"(pinned host); ledger local {mem.ledger.classes(LOCAL)}")
        return ms

    times = {True: [], False: []}
    for offload, checked in ((False, False), (True, True), (True, False),
                             (False, False)):
        times[offload].append(run(offload, checked))
    paged, off = (statistics.mean(times[k]) for k in (False, True))
    log(f"offload_kv cost [{card}]: ms per decode step (admissions "
        f"included), paged weights with pools in device memory "
        f"{times[False]}, offload_kv {times[True]} (run order paged, "
        f"offload, offload, paged); means {paged:.3f} and {off:.3f} ms, "
        f"offload {100 * (off - paged) / paged:+.2f}%; spread within each "
        f"{max(times[False]) - min(times[False]):.3f} and "
        f"{max(times[True]) - min(times[True]):.3f} ms")

    # preemption from pools at rest, mid-decode: the pool runs dry after
    # the first block, and the swapper gathers the victims' 3 pages each
    # (prefill and decode wrote them through the window) on the host,
    # behind the window's write-backs, and scatters them back there
    srv = server(True, audit=True)
    srv.tag += " mid-decode pool exhaustion at block 1"
    with fault_plan(FaultPlan(exhaust_at_block=1, exhaust_blocks=2)):
        got, secs, _ = counts.run(torch, srv, work)
    st = srv.stats
    log(f"{srv.tag} [{card}]: {secs:.3f} s, steps {st['steps']}, pool "
        f"faults {st['pool_faults']}, preemptions {st['preemptions']} "
        f"({st['preempted_pages']} pages), resumes {st['resumes']}")
    tier_report(srv, card)
    if got != want:
        raise AssertionError(f"{srv.tag}: tokens differ from the resident "
                             f"run's")
    if (st["pool_faults"] != 1 or st["preemptions"] < 1
            or st["preempted_pages"] < 3 * st["preemptions"]
            or st["resumes"] != st["preemptions"] or st["sheds"]):
        raise AssertionError(f"{srv.tag}: {st}")
    if mem.degraded:
        raise AssertionError(f"offload degraded: {mem.degraded}")
    log("offload_kv: tokens equal the resident run's, with and without "
        "preemption; nothing degraded; every layer's pool paged once a "
        "step and once an admission")
    params["layers"] = None
    del srv, model, mem
    gc.collect()


# ---------------------------------------------------------------------------
# disaggregated prefill and the request lifecycle
# ---------------------------------------------------------------------------

#: the disagg phase's prefill chunk (one block's worth of tokens)
DISAGG_CHUNK = 32
#: the disagg phase's depth: an eighth of Qwen2.5-14B's 48 layers.  Every
#: gate of the phase holds its runs against each other (monolithic against
#: disaggregated, crashed against uncontended) and scales its counts by
#: the depth, so none needs full depth.  With the families phase the
#: default run reached 1057-1108 s of its 1200 s at 48 here; at 24, with
#: the dense phase's offload_kv runs, an H100 80GB HBM3 at 700 W whose
#: host-bound steps ran ~1.3x slower than another's took ~1262 s (116 s
#: here), so the phase's host-bound steps were halved again (12), and
#: halved once more (6) when the tp phase took both notices and a card
#: ~1.35x slower ran the default run in 1070 s of phases
DISAGG_LAYERS = 6
#: the serving benchmark's interference traffic: four 8-token prompts
#: with staggered budgets, so slots free at different blocks, and two
#: 128-token prompts that arrive mid-stream as slots free
DISAGG_STEADY_NEW = (32, 64, 96, 96)
DISAGG_LONG, DISAGG_LONG_NEW = 128, 8


def disagg_work(vocab: int) -> list:
    """(prompt, max_new_tokens) of the interference traffic."""
    import numpy as np
    rng = np.random.RandomState(17)
    work = [(rng.randint(0, vocab, 8).astype(np.int32), m)
            for m in DISAGG_STEADY_NEW]
    return work + [(rng.randint(0, vocab, DISAGG_LONG).astype(np.int32),
                    DISAGG_LONG_NEW) for _ in range(2)]


class DisaggRun:
    """One serving run of the disagg phase: launch counts reset just
    before it and read just after (summed into ``total`` /
    ``by_instance`` across the phase), and a CUDA event before and after
    every decode block.  From the events come each block's span on the
    card's timeline and the gaps between two blocks that advance a
    request in both: what work issued between them (a prefill) costs a
    decoding slot on the card.  A gap that no request decodes across
    (nothing left to dispatch while the engine drains a burst) stalls
    nobody and is left out."""

    total: dict = {}
    by_instance: dict = {}

    def __init__(self, torch, card: str, server, tag: str):
        self.torch, self.card, self.server, self.tag = torch, card, server, tag

    def __call__(self, submit, checks: bool = True, drained: bool = True):
        """Submit through ``submit(server)`` (which may serve blocks
        itself) and serve until every request is done; returns the
        requests.  ``checks``: no non-finite logits; ``drained``: every
        page, handoff and stash reclaimed at the end."""
        from repro_torch.kernels import (instance_counts, launch_counts,
                                         reset_launch_counts)
        torch, srv = self.torch, self.server
        events, plain = [], srv._dispatch_block

        def timed():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            blk = plain()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            if blk is not None:       # the requests this block advances
                events.append((start, end,
                               {req.uid for req, _ in blk[2].values()}))
            return blk

        reset_launch_counts()
        srv._dispatch_block = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = submit(srv)
            for _ in range(200):
                if all(r.done.is_set() for r in reqs):
                    break
                srv.run_once()
            torch.cuda.synchronize()
            self.secs = time.perf_counter() - t0
        finally:
            del srv._dispatch_block
        if not all(r.done.is_set() for r in reqs):
            raise AssertionError(f"disagg {self.tag}: requests stuck")
        got, inst = launch_counts(), instance_counts()
        for k, n in got.items():
            DisaggRun.total[k] = DisaggRun.total.get(k, 0) + n
        for k, d in inst.items():
            mine = DisaggRun.by_instance.setdefault(k, {})
            for i, n in d.items():
                mine[i] = mine.get(i, 0) + n
        self.launches = got
        self.block_ms = [s.elapsed_time(e) for s, e, _ in events]
        self.gaps_ms = [a[1].elapsed_time(b[0])
                        for a, b in zip(events, events[1:]) if a[2] & b[2]]
        st, cfg = srv.stats, srv.model.cfg
        kernel = "paged_attention" + ("" if cfg.kv_dtype is None
                                      else f"_{cfg.kv_dtype}")
        prefills = (st["prefill_chunks"] if srv.prefill is not None
                    else st["admitted"])
        if got[kernel] != cfg.num_layers * st["steps"]:
            raise AssertionError(f"disagg {self.tag}: {got[kernel]} K1 "
                                 f"launches for {st['steps']} decode steps")
        if (got["flash_attention_wgmma"] != cfg.num_layers * prefills
                or got["flash_attention_mma"]):
            raise AssertionError(f"disagg {self.tag}: K2 launches {got} for "
                                 f"{prefills} prefill chunks / admissions")
        if checks and st["nonfinite_logits"]:
            raise AssertionError(f"disagg {self.tag}: non-finite logits")
        m = srv.manager
        m.audit()
        busy_engine = srv.prefill is not None and (
            not srv.prefill.idle or srv.prefill.staging.outstanding_bytes)
        if drained and (m.pages_in_use or m.handoff_pages or srv._preempted
                        or busy_engine):
            raise AssertionError(f"disagg {self.tag}: not fully reclaimed "
                                 f"({m.pages_in_use} pages, "
                                 f"{m.handoff_pages} handoff pages)")
        steps = max(st["steps"], 1)
        log(f"disagg {self.tag} [{self.card}]: {self.secs:.3f} s, "
            f"{1e3 * self.secs / steps:.2f} ms per decode step wall "
            f"(prefills included), {sum(self.block_ms) / steps:.2f} ms per "
            f"decode step between the events around each block (the card's "
            f"timeline, host-bound), steps {st['steps']}, blocks "
            f"{st['blocks']}, longest gap between two decode blocks on the "
            f"card that a request decodes across "
            f"{max(self.gaps_ms, default=0.0):.2f} ms, prefill chunks "
            f"{st['prefill_chunks']}, handoffs {st['handoffs']}, admitted "
            f"{st['admitted']}, decode stall max/total "
            f"{st['decode_stall_blocks_max']}/"
            f"{st['decode_stall_blocks_total']} blocks, TTFT p50/p99 "
            f"{st['ttft_p50_blocks']}/{st['ttft_p99_blocks']} blocks, "
            f"e2e p50/p99 {st['e2e_p50_blocks']}/{st['e2e_p99_blocks']} "
            f"blocks, K1 {got[kernel]}, K2 wgmma "
            f"{got['flash_attention_wgmma']}")
        return reqs


def _submit_all(work, deadlines=None):
    deadlines = deadlines or {}

    def submit(server):
        return [server.submit(p, max_new_tokens=m,
                              deadline_blocks=deadlines.get(i))
                for i, (p, m) in enumerate(work)]
    return submit


def _submit_mid_stream(work):
    """The four short prompts, one decode block, then the long ones: they
    prefill while decode is live."""
    def submit(server):
        reqs = [server.submit(p, max_new_tokens=m) for p, m in work[:4]]
        server.run_once(max_blocks=1)
        return reqs + [server.submit(p, max_new_tokens=m)
                       for p, m in work[4:]]
    return submit


def stage_cost(torch, card: str, server, pages: int) -> None:
    """What staging one handoff of ``pages`` pages costs on the card: the
    deferred gather (device time between CUDA events around the call,
    and the call's wall time), and, when a snapshot reads the stash, its
    copy into new registered pinned host memory."""
    import gc
    import statistics
    pids = list(range(1, pages + 1))
    staging = server.prefill.staging
    dev, wall = [], []
    for i in range(6):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        h = staging.swap_out(server.cache, pids, defer=True)
        end.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if i:                                    # the first one warms up
            dev.append(start.elapsed_time(end))
            wall.append(1e3 * (t1 - t0))
        n = h.nbytes
        staging.release(h)
        del h
    mat = []
    for _ in range(3):
        h = staging.swap_out(server.cache, pids, defer=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h.materialize()
        mat.append(1e3 * (time.perf_counter() - t0))
        staging.release(h)
        del h
        gc.collect()
    d = statistics.median(dev)
    log(f"disagg stage cost [{card}]: one handoff of {pages} pages = {n} "
        f"bytes: deferred gather {d:.4f} ms on the card "
        f"({_gbps(2 * n, d / 1e3)} GB/s read + write), "
        f"{statistics.median(wall):.3f} ms wall for the call (medians of "
        f"5); the host copy a snapshot makes (new registered pinned "
        f"buffers + D2H) {statistics.median(mat):.3f} ms (median of 3)")


def check_disagg(torch, card: str, cfg, params, served: dict | None) -> None:
    """Disaggregated prefill and the request lifecycle at ``cfg``'s depth
    (``DISAGG_LAYERS`` in the default run): the interference traffic
    monolithic and disaggregated (bf16 greedy and at
    0.7, int8 at 0.7, fp8 greedy), the serve phase's prefix pair through
    the engine, a chunk sweep with the long prompts arriving mid-stream,
    both engine crashes, a poisoned victim, a deadline, overload control
    and a snapshot taken mid-handoff.  ``served``: the serve phase's
    tokens by (kv_dtype, temperature) when it ran at ``cfg``'s depth."""
    import dataclasses
    from repro_torch.memory import REMOTE, FaultPlan, fault_plan
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    work = disagg_work(cfg.vocab)
    kw = dict(SERVE_KW)

    def server(kv=None, temperature=0.0, disagg=True, **extra):
        model = DenseLM(dataclasses.replace(cfg, kv_dtype=kv))
        if disagg:
            extra.setdefault("prefill_async", True)
            extra.setdefault("prefill_chunk_tokens", DISAGG_CHUNK)
        return BatchedServer(model, params, audit=True,
                             **dict(kw, temperature=temperature), **extra)

    def tokens(reqs):
        return [r.output for r in reqs]

    # monolithic against disaggregated on the interference traffic
    want = {}
    gaps = {}
    for kv, temperature in ((None, 0.0), (None, 0.7), ("int8", 0.7),
                            ("fp8_e4m3", 0.0)):
        out = {}
        for disagg in (False, True):
            tag = (f"{'disaggregated' if disagg else 'monolithic'} "
                   f"kv_dtype={kv} temperature={temperature}")
            srv = server(kv, temperature, disagg)
            run = DisaggRun(torch, card, srv, tag)
            reqs = run(_submit_all(work))
            st = srv.stats
            if any(r.outcome != "completed" for r in reqs):
                raise AssertionError(f"disagg {tag}: {[r.error for r in reqs]}")
            out[disagg] = tokens(reqs)
            gaps[disagg, kv, temperature] = max(run.gaps_ms, default=0.0)
            layers = cfg.num_layers
            if disagg:
                if (st["prefill_chunks"] != 12 or st["handoffs"] != 6
                        or run.launches["flash_attention_wgmma"]
                        != 12 * layers
                        or st["decode_stall_blocks_max"] > 1):
                    raise AssertionError(f"disagg {tag}: {st}")
                staging = srv.prefill.staging
                t = staging.timings["kv_swap_out"]
                log(f"disagg {tag}: {t['count']} handoffs staged, "
                    f"{t['bytes'] // t['count']} bytes and "
                    f"{1e3 * t['seconds'] / t['count']:.3f} ms wall each "
                    f"(the deferred gather's call); ledger kv_handoff peak "
                    f"by tier {staging.stash_hwm()} bytes, now "
                    f"{srv.mem.ledger.classes(REMOTE).get('kv_handoff')}")
            elif (st["admitted"] != 6 or st["decode_stall_blocks_max"] < 3
                  or run.launches["flash_attention_wgmma"] != 6 * layers):
                raise AssertionError(f"monolithic {tag}: {st}")
        if out[True] != out[False]:
            raise AssertionError(f"disagg kv_dtype={kv} temperature="
                                 f"{temperature}: disaggregated tokens "
                                 f"differ from monolithic")
        want[kv, temperature] = out[True]
        log(f"disagg kv_dtype={kv} temperature={temperature}: "
            f"disaggregated tokens equal monolithic; longest gap between "
            f"decode blocks on the card {gaps[False, kv, temperature]:.2f} "
            f"ms monolithic, {gaps[True, kv, temperature]:.2f} ms "
            f"disaggregated")
    greedy = want[None, 0.0]

    srv = server()
    stage_cost(torch, card, srv, DISAGG_LONG // kw["page_size"])
    del srv

    # the serve phase's prefix pair through the engine: the second prompt
    # adopts the first one's three published pages as completed chunks
    # and prefills its 16-token suffix at q_offset 48
    pair = prompts(cfg.vocab, 0)[4:]
    if served is not None:
        unshared = served[None, 0.0][4:]
    else:
        unshared = tokens(DisaggRun(torch, card, server(prefix_cache=False),
                                    "prefix pair, unshared")(
            _submit_all([(p, 64) for p in pair])))

    def submit_pair(server):
        first = [server.submit(pair[0], max_new_tokens=64)]
        server.run_once(max_blocks=0)       # prefilled, published, adopted
        return first + [server.submit(pair[1], max_new_tokens=64)]

    srv = server()
    got = tokens(DisaggRun(torch, card, srv, "prefix pair")(submit_pair))
    st = srv.stats
    if got != unshared or st["prefix_hits"] != 1 \
            or st["prefix_shared_pages"] != 3 or st["prefill_chunks"] != 3:
        raise AssertionError(f"disagg prefix pair: tokens equal unshared "
                             f"{got == unshared}, {st}")
    log("disagg prefix pair: 3 shared pages adopted as completed chunks; "
        "tokens equal the unshared run's")

    # chunk sweep, the long prompts arriving while decode is live
    for chunk in (DISAGG_CHUNK, 2 * DISAGG_CHUNK, 4 * DISAGG_CHUNK):
        srv = server(prefill_chunk_tokens=chunk)
        run = DisaggRun(torch, card, srv, f"mid-stream chunk {chunk}")
        got = tokens(run(_submit_mid_stream(work)))
        st, bound = srv.stats, -(-chunk // kw["block_size"])
        if got != greedy or st["decode_stall_blocks_max"] > bound \
                or st["prefill_chunks"] != 4 + 2 * (DISAGG_LONG // chunk):
            raise AssertionError(f"disagg chunk {chunk}: tokens equal "
                                 f"{got == greedy}, {st}")

    # engine crashes: the prefill engine before its second chunk, the
    # decode engine at its first adoption from block 1
    for plan, what in ((FaultPlan(crash_prefill_at_chunk=2), "prefill"),
                       (FaultPlan(crash_adopt_at_block=1), "adopt")):
        srv = server(handoff_lease_blocks=2)
        with fault_plan(plan):
            got = tokens(DisaggRun(torch, card, srv, f"{what} crash")(
                _submit_all(work)))
        st = srv.stats
        if got != greedy or st["engine_crashes"] != 1 \
                or st["crash_requeues"] < 1 or (
                    what == "adopt" and st["lease_reclaims"] < 1):
            raise AssertionError(f"disagg {what} crash: tokens equal "
                                 f"{got == greedy}, {st}")

    # NaN in one victim's private page after the first block
    def submit_poisoned(server):
        reqs = _submit_all(work)(server)
        server.run_once(max_blocks=1)
        slot = 1
        victim = server.slots[slot]
        pid = next(p for p in server.manager.pages[slot]
                   if server.manager.refcount[p] == 1)
        server.cache["k_pages"][:, pid] = float("nan")
        for _ in range(20):
            server.run_once(max_blocks=1)
            if victim.done.is_set():
                break
        # a one-off corruption: scrub the freed pages before reuse
        for pool in ("k_pages", "v_pages"):
            torch.nan_to_num_(server.cache[pool])
        submit_poisoned.victim = victim
        return reqs

    srv = server()
    reqs = DisaggRun(torch, card, srv, "NaN in one victim's page")(
        submit_poisoned, checks=False)
    victim = submit_poisoned.victim
    st = srv.stats
    others = [(r.output, w) for r, w in zip(reqs, greedy) if r is not victim]
    if (victim.outcome != "shed"
            or victim.error["reason"] != "poisoned_logits"
            or st["poison_sheds"] != 1 or st["sheds"] != 1
            or any(a != b for a, b in others)):
        raise AssertionError(f"disagg poison: victim {victim.error}, {st}")
    log(f"disagg poison: only uid {victim.uid} shed ({victim.error}); the "
        f"others' tokens equal the uncontended run's")

    # a deadline of one block on the first long prompt: it expires staged
    srv = server()
    reqs = DisaggRun(torch, card, srv, "deadline_blocks=1 on uid 5")(
        _submit_all(work, {4: 1}))
    late = reqs[4]
    if (late.outcome != "expired" or late.error["reason"]
            != "deadline_expired" or srv.stats["expired"] != 1
            or any(r.output != w for i, (r, w) in enumerate(zip(reqs, greedy))
                   if i != 4)):
        raise AssertionError(f"disagg deadline: {late.error}, {srv.stats}")
    log(f"disagg deadline: uid {late.uid} expired ({late.error['detail']}), "
        f"its pages reclaimed; the others' tokens equal the uncontended "
        f"run's")

    # overload control: two pending at most against a burst of six
    srv = server(max_pending=2)
    reqs = DisaggRun(torch, card, srv, "max_pending=2, burst of 6")(
        lambda s: [r for r in _submit_all(work)(s)])
    rejected = [r for r in reqs if r.outcome == "rejected"]
    if (len(rejected) != 4 or srv.stats["rejected"] != 4
            or any(r.error["reason"] != "admission_rejected"
                   for r in rejected)
            or tokens(reqs[:2]) != greedy[:2]):
        raise AssertionError(f"disagg overload: {srv.stats}")
    log("disagg overload: 4 of 6 rejected at submit, the 2 admitted "
        "complete with the uncontended tokens")

    # snapshot with one handoff staged and one prefill mid-chunk
    def submit_snapshot(server):
        reqs = [server.submit(p, max_new_tokens=m) for p, m in work[:5]]
        server.run_once(max_blocks=0)        # burst: 4 adopted, 1 staged
        reqs.append(server.submit(work[5][0], max_new_tokens=work[5][1]))
        server.run_once(max_blocks=0)        # the last one: one chunk
        eng = server.prefill
        if ([h.req.uid for h in eng.ready] != [5]
                or [(i.req.uid, i.done) for i in eng.inflight]
                != [(6, DISAGG_CHUNK)]):
            raise AssertionError("disagg snapshot: not mid-handoff")
        t0 = time.perf_counter()
        snap = server.snapshot()
        submit_snapshot.secs = time.perf_counter() - t0
        submit_snapshot.snap = snap
        return []

    srv = server()
    DisaggRun(torch, card, srv, "snapshot mid-handoff")(submit_snapshot,
                                                         drained=False)
    snap = submit_snapshot.snap
    srv2 = server()
    srv2.restore(snap)
    restored = list(srv2._backlog) + [ps.req for ps in srv2._preempted]
    restored.sort(key=lambda r: r.uid)
    DisaggRun(torch, card, srv2, "restored")(lambda s: restored)
    if tokens(restored) != greedy:
        raise AssertionError("disagg restore: tokens differ from the "
                             "uninterrupted run's")
    nbytes = sum(s[a].numel() * s[a].element_size()
                 for s in snap["sequences"] for a in ("k", "v") if a in s)
    log(f"disagg snapshot: {len(snap['sequences'])} sequences, {nbytes} KV "
        f"bytes, taken in {submit_snapshot.secs * 1e3:.1f} ms; restored "
        f"tokens equal the uninterrupted run's")
    log("disagg: every pair equal; stall <= 1 block disaggregated, >= 3 "
        "monolithic; crashes, restore and prefix runs give the "
        "uncontended tokens; only the NaN victim shed; every audit clean")


def profile_serve(torch, model, params, kw, work, card) -> None:
    """A separate traced run (four requests, one 32-step block): device
    time by kernel name and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve import BatchedServer
    server = BatchedServer(model, params, **kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = serve(server, work, 33)
    # device-side events only: an operator's row carries the device time
    # of the kernels it launched too, so counting both would double it
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev, ev.key, ev.count))
    busy = sum(r[0] for r in rows) / 1e6
    paged = model.mem.prefetcher is not None
    log(f"profile kv_dtype={model.cfg.kv_dtype} temperature="
        f"{kw['temperature']}{' paged weights' if paged else ''} [{card}]: "
        f"{server.stats['steps']} decode steps + 4 admissions in "
        f"{secs:.3f} s wall; device busy {busy:.3f} s "
        f"({100 * busy / secs:.1f}%)")
    for dev, key, count in sorted(rows, reverse=True)[:14]:
        log(f"  {dev / 1e3:10.2f} ms  {100 * dev / 1e6 / busy:5.1f}%  "
            f"x{count:<6d} {key[:90]}")
    if paged:
        # the copy engine's host-to-device copies against everything
        # else on the device, as unions of their intervals
        copy, compute = [], []
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                span = (ev.time_range.start, ev.time_range.end)
                (copy if ev.name.startswith("Memcpy HtoD") else
                 compute).append(span)
        copy, compute = _union(copy), _union(compute)
        both = _overlap(copy, compute)
        c_s, k_s = (sum(e - b for b, e in u) / 1e6 for u in (copy, compute))
        log(f"profile paged weights [{card}]: copy stream (host-to-device) "
            f"busy {c_s:.3f} s, compute busy {k_s:.3f} s, both at once "
            f"{both / 1e6:.3f} s, of {secs:.3f} s wall")


def _union(spans):
    """Merge (start, end) intervals into a sorted disjoint list."""
    out = []
    for b, e in sorted(spans):
        if out and b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


# ---------------------------------------------------------------------------
# tensor-parallel serving over a mesh (the tp phase)
# ---------------------------------------------------------------------------

#: the tp phase: Qwen2.5-14B at full width and the first 12 of its 48
#: layers, served by one process and by m = 2 and 4 ranks on the one card
TP_LAYERS = 12
TP_SHARDS = (2, 4)
TP_NEW = 24
#: the greedy runs' blocks: three of 8, whose page tables are 1, 2 and 2
#: pages wide, so on the graph route the third block is captured and
#: replayed (a key's first block runs eagerly)
TP_BLOCK = 8
#: the fp32 witness's new tokens (the first-8 rule reads 8)
TP_WITNESS_NEW = 16
#: bytes of each half of the shared region (a collective's payload times
#: the ranks must fit: the largest, a decode step's logits at m = 4, is
#: 4 x 304,128 B)
TP_REGION = 16 << 20
#: seconds the ranks of one mesh may take, their start included (a mesh
#: took 11-25 s on an H100 80GB HBM3 at 700 W): past it the ranks are
#: stopped and the phase fails, well inside the run's 1200 s
TP_TIMEOUT = 180
#: more seconds for the m = 2 ranks' ``TP_RUNS``
TP_LIFECYCLE_S = 240
#: the paged bf16 bound the logits are held to when the tokens are not
#: bit-equal (atol, rtol), beside the first-8 rule
TP_LOGIT_ATOL, TP_LOGIT_RTOL = 0.1, 0.02
#: the runs each kernel row's ``tp_launches`` sums, by mesh size (a row
#: at a rank's shapes, phase "tp2" or "tp4", reads its mesh's; the
#: others the one-process run's)
TP_PATH = {
    1: "BatchedServer, one process, Qwen2.5-14B at 12 of 48 layers, greedy, "
       "eager (tp phase)",
    2: "BatchedServer(mesh=make_serving_mesh(model=2)), 2 ranks on one card "
       "over one shared region, Qwen2.5-14B at 12 of 48 layers (TP_RUNS "
       "and TP_ROWPAR_RUNS at 6): the greedy "
       "run over the flags notice (graph route, replays counted) and over "
       "the barrier (eager), and TP_RUNS (paged weights, offload_kv over "
       "the pools and the slab, preemption and cold parking at 0.7, "
       "disaggregated prefill) all-gather, the same two greedy runs and "
       "TP_ROWPAR_RUNS (resident twice, paged weights, offload_kv pools, "
       "disaggregated and monolithic) row-parallel (deterministic=False), "
       "both ranks summed (tp phase)",
    4: "BatchedServer(mesh=make_serving_mesh(model=4)), 4 ranks on one card "
       "over one shared region, Qwen2.5-14B at 12 of 48 layers, greedy, "
       "all-gather and row-parallel, each over the flags notice (graph "
       "route, replays counted) and over the barrier (eager), the ranks "
       "summed (tp phase)",
    "fam": "BatchedServer(mesh=make_serving_mesh(model=2), "
           "deterministic=False), 2 ranks on one card over one shared "
           "region's flags notice (graph route), over the slab: "
           "recurrentgemma-9b at 5 of 38 layers, xlstm-125m and "
           "whisper-base (with frames), greedy, both ranks summed (tp "
           "phase, family spawn)"}


def tp_hidden(torch, model, params, toks):
    """Each layer's output and the last position's logits for one batch
    of prompts through the model's blocks (the prefill's arithmetic,
    page-size row chunks), over the mesh the model is bound to."""
    from repro_torch.models import layers as L
    from repro_torch.runtime.sharding import activate_mesh
    with torch.no_grad(), activate_mesh(model.mem.mesh,
                                        row_parallel=model.mem.row_parallel):
        x = L.embed_lookup(params["embed"], toks)
        pos = torch.arange(toks.shape[1], device=toks.device)
        outs = [x.cpu()]
        for lp in params["layers"]:
            x, _ = model.block_prefill(lp, x, pos, model.cfg.page_size)
            outs.append(x.cpu())
        logits = model._logits(params, x).float().cpu()
    return outs, logits


@contextlib.contextmanager
def largest_collectives(t, seen: dict):
    """Note in ``seen`` the shape of the largest tensor this rank passes
    to ``t.all_reduce`` (a row-parallel projection's partial product or
    the embedding's rows) and to ``t.all_gather`` (the logits) while the
    ``with`` lasts.  Python sees the eager blocks' and the admissions'
    collectives; a graph's replays call no Python (their launches are
    counted through the launch tally)."""
    if t is None:
        yield
        return
    calls = {k: getattr(t, k) for k in ("all_reduce", "all_gather")}

    def noted(kind):
        def call(x, *a):
            if kind not in seen or x.numel() > math.prod(seen[kind]):
                seen[kind] = tuple(x.shape)
            return calls[kind](x, *a)
        return call
    for kind in calls:
        setattr(t, kind, noted(kind))
    try:
        yield
    finally:
        for kind in calls:
            delattr(t, kind)


def tp_replay(torch, server, rank: int) -> dict:
    """After a served run on the graph route, on every rank in step: the
    server's last captured block replayed once, then one block run
    eagerly over the same buffers (its collectives the same kernels,
    issued from the host), each timed (ms a step: this rank's wall, the
    waits for its peers in it); then one more replay, traced on rank 0:
    the TAB kernel's device time (its spin in it) against the block's
    device time and wall.  Nothing is counted on a path."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    blocks = server._loop.blocks
    if blocks is None or not blocks.graphs:
        return {}
    replay, _ = list(blocks.graphs.values())[-1]
    steps = blocks.block_size
    out = {"steps": steps}
    for name, fn in (("replay", replay), ("eager", lambda: blocks.block(
            server.params, server.cache, server.state))):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / steps
    torch.cuda.synchronize()
    dist.barrier()
    if rank != 0:
        replay()
        torch.cuda.synchronize()
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = tab = calls = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        busy += dev
        if "tab_sum_kernel" in ev.key or "tab_gather_kernel" in ev.key:
            tab += dev
            calls += ev.count
    out.update(wall_ms=1e3 * wall, busy_ms=busy / 1e3, tab_ms=tab / 1e3,
               tab_calls=calls)
    return out


#: the TAB's collective (K4 redesigned, ``csrc/write_accumulate.cu``)
#: against its plain version at the tp phase's served shapes, bf16: each
#: mesh's decode all-reduce (one token a slot, batch 4), its largest
#: partial (row-parallel: an admission's 64-row prefill at m = 2, an
#: 8-token one at m = 4) and a decode step's gather of the logits (the
#: vocab's 152,064 columns split m ways): (label, ranks, shape, gather)
TAB_SHAPES = (("decode all-reduce", 2, (4, 5120), False),
              ("decode all-reduce", 4, (4, 5120), False),
              ("largest partial", 2, (64, 5120), False),
              ("largest partial", 4, (8, 5120), False),
              ("logits gather", 2, (4, 76032), True),
              ("logits gather", 4, (4, 38016), True))
#: the collectives' watchdog in the smoke (s): far past any wait a
#: healthy run has, well inside a phase's time
TAB_TIMEOUT_S = 60.0
#: the probe: eager collectives timed a rank, and a decode step's 26
#: collectives captured into one graph, replayed TAB_PROBE_REPLAYS times
TAB_PROBE_ITERS = 200
TAB_PROBE_GRAPH = 26
TAB_PROBE_REPLAYS = 8


def _tab_round(torch, streams, xs, data, flags, gather: bool) -> list:
    """One collective of len(xs) ranks in this process: rank r's kernel
    on ``streams[r]``, all issued together (their 32 CTAs each fit the
    card at once), joined back into the current stream.  Every stream
    waits for the current one before any kernel is issued: PyTorch hands
    out streams from a pool of 32, so one of ``streams`` can be the
    current stream (a graph's capture stream), and a wait issued after a
    peer's kernel on it would make this rank's kernel wait for its
    peer's, which spins on this one until the watchdog fires."""
    from repro_torch.kernels.write_accumulate import ops
    cur = torch.cuda.current_stream()
    outs = []
    for s in streams:
        s.wait_stream(cur)
    for r, s in enumerate(streams):
        with torch.cuda.stream(s):
            outs.append(ops.collective(xs[r], data, flags, rank=r,
                                       size=len(xs), gather=gather,
                                       timeout_s=TAB_TIMEOUT_S))
    for s in streams:
        cur.wait_stream(s)
    return outs


def _tab_plain(torch, xs, gather: bool) -> list:
    """The plain version of one collective: every rank a thread over one
    region and flag area in host memory, the same protocol."""
    import threading
    from repro_torch.kernels.write_accumulate import ops
    n = len(xs)
    stride = ops.slot_stride(xs[0].numel() * xs[0].element_size())
    data = torch.zeros(2 * n * stride, dtype=torch.uint8)
    flags = torch.zeros(ops.flag_words(n), dtype=torch.int64)
    outs, errors = [None] * n, []

    def rank(r):
        try:
            outs[r] = ops.collective(xs[r].cpu(), data, flags, rank=r,
                                     size=n, gather=gather,
                                     timeout_s=TAB_TIMEOUT_S)
        except Exception as e:       # re-raised below, in this thread
            errors.append(e)
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs


def check_tab_kernel(torch, card: str, results: dict, cases) -> None:
    """The TAB's collective against its plain version, in this process:
    at each case (label, ranks n, shape, gather, phase), n simulated
    ranks over one device region, their kernels on n streams at once,
    against the plain protocol in n threads over host memory: a gather
    bit-equal, a sum within one bf16 ulp (both sum in fp32 in slot order
    and round once), bit-equality logged.  Then timed: a round of the n
    kernels replayed from a CUDA graph (device time), the plain version's
    round eager, and ``torch.sum`` over the stacked (n, ...) slots (a
    sum) or ``torch.stack`` of the n contributions (a gather) as the
    library call.  Bound: n ranks x (the slot written + n slots read +
    the output written) at 3.35 TB/s, against the sum's fp32 adds at 67
    TFLOP/s.  Launches made here are not counted on any path."""
    from repro_torch.kernels.write_accumulate import ops
    gen = torch.Generator(device="cuda").manual_seed(9)
    done = set()
    for label, n, shape, gather, phase, *kind in cases:
        dtype = getattr(torch, kind[0] if kind else "bfloat16")
        size = torch.empty((), dtype=dtype).element_size()
        if (n, math.prod(shape), gather, dtype) in done:
            continue
        done.add((n, math.prod(shape), gather, dtype))
        stride = ops.slot_stride(math.prod(shape) * size)
        data = torch.zeros(2 * n * stride, dtype=torch.uint8, device="cuda")
        flags = torch.zeros(ops.flag_words(n), dtype=torch.int64,
                            device="cuda")
        streams = [torch.cuda.Stream() for _ in range(n)]

        def inputs():
            return [torch.randn(shape, generator=gen, device="cuda")
                    .to(dtype) for _ in range(n)]
        xs = inputs()
        got = [o.float().cpu() for o in _tab_round(torch, streams, xs, data,
                                                   flags, gather)]
        torch.cuda.synchronize()
        words = flags[n * ops.FLAG_CTAS:].tolist()
        want = [o.float() for o in _tab_plain(torch, xs, gather)]
        tag = (f"TAB collective {label} m={n} ({n}, "
               f"{', '.join(map(str, shape))}) "
               f"{'bf16' if dtype == torch.bfloat16 else str(dtype)[6:]} "
               f"{'gather' if gather else 'sum'}")
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        mantissa = 7 if dtype == torch.bfloat16 else 23
        if gather:
            ok = same
        else:
            ok = all(bool(((a - b).abs() <= torch.exp2(torch.floor(
                torch.log2(b.abs().clamp_min(2.0 ** -126))) - mantissa))
                .all()) for a, b in zip(got, want))
        ok = ok and all(torch.equal(a, got[0]) for a in got) and not any(
            words)
        log(f"{tag}: max_abs_err {err:.3e} against the plain protocol "
            f"({'bit-equal' if same else 'not bit-equal'}; "
            f"{'exact' if gather else 'within one ulp'} required), "
            f"every rank's output equal, error words {words}")
        if not ok:
            raise AssertionError(f"{tag}: parts from its plain version "
                                 f"or between ranks")
        sets = [(inputs(),) for _ in range(ROTATE)]
        ms = time_ms(torch, lambda v: _tab_round(torch, streams, v, data,
                                                 flags, gather), sets)
        t0 = time.perf_counter()
        for _ in range(3):
            _tab_plain(torch, xs, gather)
        plain_ms = 1e3 * (time.perf_counter() - t0) / 3
        if gather:
            lib_ms = time_ms(torch, lambda v: torch.stack(v), sets)
        else:
            stacks = [(torch.stack(v),) for (v,) in sets]
            lib_ms = time_ms(torch, lambda s: torch.sum(
                s, 0, dtype=torch.float32).to(s.dtype), stacks)
        nbytes = math.prod(shape) * size
        out_bytes = n * nbytes if gather else nbytes
        b_ms, b_by = bound(n * (nbytes + n * nbytes + out_bytes),
                           0 if gather else n * (n - 1) * math.prod(shape),
                           F32_FLOPS_PER_S)
        if flags[n * ops.FLAG_CTAS:].any():
            raise AssertionError(f"{tag}: the watchdog fired while timed")
        log(f"{tag} [{card}]: a round of {n} kernels {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, {'torch.stack' if gather else 'torch.sum'} "
            f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        results.setdefault("tab_collective", []).append(dict(
            shape=tag.removeprefix("TAB collective "), max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, phase=phase))
        del data, flags, streams, sets
        torch.cuda.empty_cache()


def tab_probe(torch, mesh, barrier_mesh) -> dict:
    """The completion notice across this world's ranks (every rank runs
    it): ms a collective of a (4, 5120) bf16 all-reduce, eager over the
    flags, the flags' collectives captured into one CUDA graph of a
    decode step's ``TAB_PROBE_GRAPH`` and replayed, and eager over the
    barrier.  The graph's launches go to a tally of their own (not
    counted on any path)."""
    import torch.distributed as dist
    from repro_torch.kernels import build
    gen = torch.Generator(device="cuda").manual_seed(11 + mesh.rank)
    x = torch.randn((4, 5120), generator=gen, device="cuda").to(
        torch.bfloat16)
    out = {"rank": mesh.rank}

    def timed(fn, calls: int) -> float:
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / calls

    for name, m in (("flags", mesh), ("barrier", barrier_mesh)):
        t = m.transport("model")
        iters = TAB_PROBE_ITERS if name == "flags" else TAB_PROBE_ITERS // 4
        for _ in range(4):
            t.all_reduce(x)
        out[name] = timed(lambda: [t.all_reduce(x) for _ in range(iters)],
                          iters)
    t = mesh.transport("model")
    g = torch.cuda.CUDAGraph()
    for _ in range(2):                  # the warm-up a capture needs
        t.all_reduce(x)
    torch.cuda.synchronize()
    with build.launch_tally(), torch.cuda.graph(g):
        for _ in range(TAB_PROBE_GRAPH):
            y = t.all_reduce(x)
    out["graph"] = timed(lambda: [g.replay() for _ in
                                  range(TAB_PROBE_REPLAYS)],
                         TAB_PROBE_REPLAYS * TAB_PROBE_GRAPH)
    out["sum"] = y.float().cpu()
    t.check()
    del g
    return out


def tab_probe_rank() -> dict:
    """A rank of the notice phase: loads the kernels the parent built,
    then ``tab_probe`` over the world's mesh (flags and barrier)."""
    import torch
    from repro_torch.kernels import _kernel_modules, build
    from repro_torch.launch.mesh import make_serving_mesh, world
    build.require_built([m.SOURCE for m in _kernel_modules()])
    n = world().size
    return tab_probe(torch, make_serving_mesh(model=n),
                     make_serving_mesh(model=n, notice="barrier"))


def log_probe(card: str, m: int, probes: list) -> None:
    """Log the notice probe of a mesh's ranks and hold their sums
    equal."""
    for p in probes:
        log(f"notice probe m={m} rank {p['rank']} [{card}]: ms a (4, 5120) "
            f"bf16 all-reduce: flags eager {p['flags']:.4f}, flags replayed "
            f"from one graph of {TAB_PROBE_GRAPH} {p['graph']:.4f}, barrier "
            f"eager {p['barrier']:.4f}")
    if any(not p["sum"].equal(probes[0]["sum"]) for p in probes):
        raise AssertionError(f"notice probe m={m}: the ranks' sums differ")


def check_notice(torch, card: str, results: dict) -> None:
    """The notice phase (off by default): the TAB's collective against
    its plain version at ``TAB_SHAPES`` in this process, then the probe
    on m = 2 and 4 ranks of this card."""
    from repro_torch.launch.mesh import spawn
    check_tab_kernel(torch, card, results, [
        (label, n, shape, gather, f"tp{n}")
        for label, n, shape, gather in TAB_SHAPES])
    for m in TP_SHARDS:
        t0 = time.perf_counter()
        probes = spawn(tab_probe_rank, m, device="cuda", timeout=TP_TIMEOUT)
        log_probe(card, m, probes)
        log(f"notice m={m}: {time.perf_counter() - t0:.1f} s with the "
            f"ranks' start")


def _tp_serve(torch, cfg, params, work, new: int, mesh=None, *,
              hidden: bool = True, replay: bool = False, **kw) -> dict:
    """Serve ``work`` (``new`` tokens each, greedy unless ``kw`` says
    otherwise: the serving settings, updated by ``kw``, ``deterministic``
    among them) with the counts and the mesh's tally reset just before;
    the tokens, the run's numbers (the memory tiers' and the lifecycle's
    too), the largest all-reduce and all-gather this rank issued from
    Python, with ``replay`` ``tp_replay`` (after the counts are read),
    and with ``hidden`` ``tp_hidden`` of the prompts."""
    from repro_torch.kernels import (instance_counts, launch_counts,
                                     reset_launch_counts)
    from repro_torch.memory import tiers, tree_bytes
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    model = DenseLM(cfg)
    host_before = host_mem("MemAvailable")
    server = BatchedServer(model, params, mesh=mesh,
                           graph=False if mesh is None else None,
                           **dict(SERVE_KW, **kw))
    host_placed = host_mem("MemAvailable")
    t = mesh.transport("model") if mesh is not None else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    if t is not None:
        t.reset_tally()
    seen: dict = {}
    with largest_collectives(t, seen):
        reqs, secs = serve(server, work, new)
    mem, st = server.mem, server.stats
    pf, win = mem.prefetcher, mem.kv_window
    out = {"tokens": [r.output for r in reqs],
           "errors": [r.error for r in reqs], "secs": secs,
           "steps": st["steps"],
           "model_shards": st["model_shards"],
           "route": server.route, "launches": launch_counts(),
           "instances": instance_counts(),
           "tally": ({k: dict(v) for k, v in t.tally.items()}
                     if t is not None else {}),
           "wait_s": t.wait_s if t is not None else 0.0,
           "peak": torch.cuda.max_memory_allocated(),
           "kv_capacity": server.mem.ledger.capacities(tiers.LOCAL)
           .get("kv_pool", 0), "cache_bytes": tree_bytes(server.cache),
           "shards": server.tier_stats()[tiers.LOCAL]["shards"],
           "params_bytes": tree_bytes(server.params),
           "stats": {k: v for k, v in st.items()
                     if isinstance(v, (int, float))},
           "degraded": dict(mem.degraded),
           "ledger": {tier: mem.ledger.capacities(tier)
                      for tier in mem.ledger.tiers()},
           "fetches": pf.fetches if pf is not None else 0,
           "fetched_bytes": pf.fetched_bytes if pf is not None else 0,
           "pinned_weights": pf.layers.nbytes if pf is not None else 0,
           "window": (win.fetches, win.writebacks) if win is not None
           else None,
           "kv_at_rest": win.at_rest_bytes if win is not None else 0,
           "swap": {k: dict(v) for k, v in server.swapper.timings.items()}
           if server.swapper is not None else {},
           "handoff": {k: dict(v) for k, v in
                       server.prefill.staging.timings.items()}
           if server.prefill is not None else {},
           "host": (host_before, host_placed, host_mem("MemAvailable")),
           "deterministic": st["deterministic"],
           "largest": seen.get("all_reduce"),
           "largest_gather": seen.get("all_gather")}
    if replay:
        out["replay"] = tp_replay(torch, server, mesh.rank)
    if hidden:
        toks = torch.as_tensor([list(p) for p in work], device="cuda")
        out["hidden"], out["logits"] = tp_hidden(torch, model,
                                                 server.params, toks)
    del server, mem, pf, win, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: the tp phase's runs of the memory tiers and the request lifecycle over
#: the m = 2 mesh (each rank pins its shard of the layers, 4.47 GB at 12
#: layers, 2.23 GB at ``TP_LIFE_LAYERS``, for the paged weights): (name,
#: the config's pager, server
#: keywords, prompts (the serve phase's first four 8-token ones, or six
#: with its 40-token prefix pair), new tokens, the uncontended resident
#: monolithic run of the same mesh its tokens are held to).  Every run
#: decodes in blocks of 16.  The tiers' runs stream the weights over
#: PCIe every step, so they make 16 tokens; preemption and cold parking
#: make 32 (3 worst-case pages a request) in a pool of 7 pages, so two
#: requests decode at once and the backlog head preempts; the
#: disaggregated run prefills the 40-token prompts (64 with the bucket)
#: in four chunks, at q_offset 16, 32 and 48
TP_TIER_NEW = 16
TP_LIFE_NEW = 32
#: the depth of those runs: the first 6 of the tp phase's 12 layers (each
#: run is held to a resident run at the same depth; cut from 12 when the
#: greedy runs took both notices)
TP_LIFE_LAYERS = 6
TP_POOL = 7
TP_CHUNK = 16
_TIER_KW = dict(block_size=TP_TIER_NEW)
TP_RUNS = (
    ("resident", None, _TIER_KW, 4, TP_TIER_NEW, None),
    ("paged weights", dict(enabled=True, lookahead=1), _TIER_KW, 4,
     TP_TIER_NEW, "resident"),
    ("offload_kv pools", dict(enabled=True, offload_kv=True), _TIER_KW, 4,
     TP_TIER_NEW, "resident"),
    ("resident slab", None, dict(_TIER_KW, paged=False), 4, TP_TIER_NEW,
     None),
    ("offload_kv slab", dict(enabled=True, offload_kv=True),
     dict(_TIER_KW, paged=False), 4, TP_TIER_NEW, "resident slab"),
    ("resident 0.7", None, dict(_TIER_KW, temperature=0.7), 4, TP_LIFE_NEW,
     None),
    ("preempt 0.7", None, dict(_TIER_KW, temperature=0.7,
                               num_pages=TP_POOL), 4, TP_LIFE_NEW,
     "resident 0.7"),
    ("cold park 0.7", None, dict(_TIER_KW, temperature=0.7,
                                 num_pages=TP_POOL,
                                 cold_park_after_blocks=0), 4, TP_LIFE_NEW,
     "resident 0.7"),
    ("monolithic", None, _TIER_KW, 6, TP_TIER_NEW, None),
    ("disaggregated", None, dict(_TIER_KW, prefill_async=True,
                                 prefill_chunk_tokens=TP_CHUNK), 6,
     TP_TIER_NEW, "monolithic"))
#: the m = 2 ranks' row-parallel runs (``deterministic=False``), laid out
#: as ``TP_RUNS``: the resident run twice (single-run determinism), paged
#: weights (each rank pages its ``param_specs`` shard, the output
#: projections by their rows: 3.30 GB at 12 layers) and offload_kv pools
#: against it, disaggregated prefill against the monolithic run
_ROWPAR = dict(_TIER_KW, deterministic=False)
TP_ROWPAR_RUNS = (
    ("resident", None, _ROWPAR, 4, TP_TIER_NEW, None),
    ("resident again", None, _ROWPAR, 4, TP_TIER_NEW, "resident"),
    ("paged weights", dict(enabled=True, lookahead=1), _ROWPAR, 4,
     TP_TIER_NEW, "resident"),
    ("offload_kv pools", dict(enabled=True, offload_kv=True), _ROWPAR, 4,
     TP_TIER_NEW, "resident"),
    ("monolithic", None, _ROWPAR, 6, TP_TIER_NEW, None),
    ("disaggregated", None, dict(_ROWPAR, prefill_async=True,
                                 prefill_chunk_tokens=TP_CHUNK), 6,
     TP_TIER_NEW, "monolithic"))


def _cut(cfg, params, layers: int) -> tuple:
    """``cfg`` and ``params`` cut to their first ``layers`` layers."""
    return (dataclasses.replace(cfg, num_layers=layers),
            dict(params, layers=params["layers"][:layers]))


def tp_lifecycle(torch, cfg, params, cfg32, params32, mesh,
                 table: tuple = TP_RUNS) -> dict:
    """The m = 2 ranks' runs of ``table`` (``TP_RUNS``, or
    ``TP_ROWPAR_RUNS``) on this rank, each with the counts reset just
    before it.  A run whose bf16 tokens part from its resident run's is
    served again, with that run, from the same weights in fp32 (the
    witness: ``witness`` holds both runs' tokens)."""
    runs: dict = {}
    for name, pager, kw, n, new, base in table:
        work = prompts(cfg.vocab, 0)[:n]
        pick = (lambda c: c if pager is None else c.with_pager(**pager))
        runs[name] = _tp_serve(torch, pick(cfg), params, work, new, mesh,
                               hidden=False, **kw)
        if base is None or runs[name]["tokens"] == runs[base]["tokens"]:
            continue
        _, bpager, bkw, _, _, _ = next(r for r in table if r[0] == base)
        pick32 = (lambda c: c if bpager is None else c.with_pager(**bpager))
        want = _tp_serve(torch, pick32(cfg32), params32, work, new, mesh,
                         hidden=False, **bkw)
        got = _tp_serve(torch, pick(cfg32), params32, work, new, mesh,
                        hidden=False, **kw)
        runs[name]["witness"] = (got["tokens"], want["tokens"])
    return runs


def tp_rank(cfg, params, cfg32, params32, work: list,
            lifecycle: bool) -> dict:
    """One rank of the tp phase (``launch.mesh.spawn``'s target): loads
    the kernels the parent built (builds nothing), then serves ``work``
    over the world's mesh on the shared region in bf16 (``TP_NEW``
    tokens), all-gather and row-parallel, each over the flags notice
    (the graph route, ``tp_replay`` after it) and over the barrier (the
    eager route: the bits the flags' runs are held to); with
    ``lifecycle`` the runs of the memory tiers and
    the request lifecycle in both modes (``tp_lifecycle``: ``TP_RUNS``,
    ``TP_ROWPAR_RUNS``, over the flags) and, the bf16 shard freed, the
    fp32 witnesses of both modes (``TP_WITNESS_NEW``).  ``params`` and
    ``params32`` arrive as CUDA IPC handles on the parent's full trees;
    each server copies this rank's shard (a paging server packs it into
    pinned host memory)."""
    import torch
    from repro_torch.kernels import _kernel_modules, build
    from repro_torch.launch.mesh import make_serving_mesh, world
    build.require_built([m.SOURCE for m in _kernel_modules()])
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_serving_mesh(model=world().size, transport="shared")
    barrier = make_serving_mesh(model=world().size, notice="barrier")
    greedy = dict(block_size=TP_BLOCK)
    out = _tp_serve(torch, cfg, params, work, TP_NEW, mesh, replay=True,
                    **greedy)
    out["barrier"] = _tp_serve(torch, cfg, params, work, TP_NEW, barrier,
                               hidden=False, **greedy)
    out["rowpar"] = _tp_serve(torch, cfg, params, work, TP_NEW, mesh,
                              deterministic=False, replay=True, **greedy)
    out["rowpar_barrier"] = _tp_serve(torch, cfg, params, work, TP_NEW,
                                      barrier, hidden=False,
                                      deterministic=False, **greedy)
    if lifecycle:
        out["dryrun_tally"] = tp_dryrun_tally(torch, cfg, params, mesh)
        life = (*_cut(cfg, params, TP_LIFE_LAYERS),
                *_cut(cfg32, params32, TP_LIFE_LAYERS))
        out["lifecycle"] = tp_lifecycle(torch, *life, mesh)
        out["rowpar_lifecycle"] = tp_lifecycle(torch, *life, mesh,
                                               TP_ROWPAR_RUNS)
        del life
    del params
    out["fp32"] = _tp_serve(torch, cfg32, params32, work, TP_WITNESS_NEW,
                            mesh, **greedy)
    out["rowpar_fp32"] = _tp_serve(torch, cfg32, params32, work,
                                   TP_WITNESS_NEW, mesh, deterministic=False,
                                   **greedy)
    out["rank"] = mesh.rank
    return out


def tp_products(torch, card: str, params, rows: tuple = (4, 8)) -> None:
    """Why sharded bf16 serving parts from one card's: layer 0's
    column-sharded products (q, k, v, gate, up) and the LM head, at the
    decode step's 4 rows and an 8-token admission's, each shard's product
    against the full product's columns: the share of elements that
    differ, under cuBLAS's defaults and with reduced-precision split-K
    reductions off."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    lp = params["layers"][0]
    ws = {"wq": lp["attn"]["wq"], "wk": lp["attn"]["wk"],
          "wv": lp["attn"]["wv"], "wg": lp["mlp"]["wg"],
          "wi": lp["mlp"]["wi"], "head": params["embed"]["head"]}
    flag = torch.backends.cuda.matmul
    for reduced in (True, False):
        keep = flag.allow_bf16_reduced_precision_reduction
        flag.allow_bf16_reduced_precision_reduction = reduced
        try:
            parts = []
            for m_rows in rows:
                x = torch.randn(m_rows, ws["wq"].shape[0], generator=gen,
                                device="cuda").to(torch.bfloat16)
                for name, w in ws.items():
                    full = x @ w
                    for m in TP_SHARDS:
                        c = w.shape[1] // m
                        diff = sum(int((x @ w[:, r * c:(r + 1) * c]
                                        .contiguous() != full[:, r * c:(
                                            r + 1) * c]).sum())
                                   for r in range(m))
                        parts.append(f"{name} M={m_rows} m={m} "
                                     f"{diff / full.numel():.3f}")
        finally:
            flag.allow_bf16_reduced_precision_reduction = keep
        log(f"tp products [{card}], share of a shard's elements that "
            f"differ from the full product's columns (bf16, "
            f"allow_bf16_reduced_precision_reduction={reduced}): "
            + ", ".join(parts))


def _shard_bytes(tree, specs, m: int) -> int:
    """One rank's bytes of ``tree`` over m model shards: a leaf whose spec
    names ``"model"`` is split m ways, the others whole."""
    from repro_torch.runtime.sharding import _map_specs
    sizes: list = []
    _map_specs(lambda _, spec, x: sizes.append(
        x.numel() * x.element_size() // (m if "model" in spec else 1)),
        specs, tree)
    return sum(sizes)


def check_tp_lifecycle(torch, card: str, cfg, params, r: dict, m: int,
                       problems: list, rowpar: bool = False) -> None:
    """Log and gate one rank's ``tp_lifecycle`` runs (``rowpar``: of
    ``TP_ROWPAR_RUNS``, else of ``TP_RUNS``): each run's tokens bit-equal
    to its resident run's (or its fp32 witness's), K1 once a layer a step
    over pools (never over the slab), K2 and the TAB's collective
    launched (row-parallel: its sums at least 2 x layers + 1 a step),
    nothing degraded, the graph route unless the run pages (then
    eager); the paged weights'
    fetches (layers x passes) and remote bytes (this rank's shard under
    the mode's specs), the KV window's moves, the stashes and handoffs in
    whole pages of this rank's KV heads."""
    from repro_torch.memory import tiers
    from repro_torch.models.transformer import DenseLM
    layers = cfg.num_layers
    model = DenseLM(cfg)
    specs = model.param_specs() if rowpar else model.serving_param_specs()
    shard = _shard_bytes(params["layers"], specs["layers"], m)
    page_bytes = (2 * layers * SERVE_KW["page_size"]
                  * (cfg.num_kv_heads // m) * cfg.head_dim * 2)
    runs = r["rowpar_lifecycle" if rowpar else "lifecycle"]
    for name, pager, kw, n, new, base in (TP_ROWPAR_RUNS if rowpar
                                          else TP_RUNS):
        run = runs[name]
        st, la = run["stats"], run["launches"]
        tag = (f"tp m={m} rank {r['rank']} "
               f"{'row-parallel ' if rowpar else ''}{name}")
        moved = {k: v["bytes"] for k, v in {**run["swap"],
                                            **run["handoff"]}.items()}
        log(f"{tag} [{card}]: {1e3 * run['secs'] / run['steps']:.2f} ms a "
            f"step ({run['steps']} steps, {st['admitted']} admissions, "
            f"{new} new tokens, route {run['route']}), peak device memory "
            f"{run['peak'] / 2**30:.2f} GiB "
            f"(this rank's own allocations: the weights this process "
            f"shares by IPC are not among them), pinned weights "
            f"{run['pinned_weights']} B, KV at rest {run['kv_at_rest']} B, "
            f"weights paged in {run['fetched_bytes']} B = "
            f"{run['fetched_bytes'] / run['secs'] / 1e9:.2f} GB/s over the "
            f"run, KV window (fetches, write-backs) {run['window']}, "
            f"preemptions {st['preemptions']} ({st['preempted_pages']} "
            f"pages), resumes {st['resumes']}, cold parks "
            f"{st['cold_parks']}, promotes {st['cold_promotes']}, chunks "
            f"{st['prefill_chunks']}, handoffs {st['handoffs']}, stash and "
            f"handoff bytes by transfer {moved}, K1 "
            f"{la['paged_attention']}, K2 {la['flash_attention_wgmma']}, "
            f"the TAB's collective {run['instances']['tab_collective']}; "
            f"host MemAvailable before the server, placed, after "
            f"{run['host']}")
        if any(run["errors"]) or any(len(t) != new for t in run["tokens"]):
            problems.append(f"{tag}: a request did not emit its {new} "
                            f"tokens: {run['errors']}")
        route = "eager" if pager is not None else "graph"
        if run["degraded"] or run["route"] != route or \
                run["model_shards"] != m:
            problems.append(f"{tag}: degraded {run['degraded']}, route "
                            f"{run['route']}, shards {run['model_shards']}")
        if base is not None and run["tokens"] != runs[base]["tokens"]:
            got, want = run.get("witness", (None, ()))
            log(f"{tag}: bf16 tokens NOT bit-equal to the {base} run's; "
                f"the fp32 witness "
                f"{'bit-equal' if got == want else 'NOT bit-equal'}")
            if got != want:
                problems.append(f"{tag}: tokens and the fp32 witness part "
                                f"from the {base} run's")
        elif base is not None:
            log(f"{tag}: bf16 tokens bit-equal to the {base} run's")
        slab = kw.get("paged") is False
        if la["paged_attention"] != (0 if slab else layers * run["steps"]):
            problems.append(f"{tag}: K1 {la['paged_attention']} for "
                            f"{run['steps']} steps")
        sums = run["instances"]["tab_collective"].get("sum", 0)
        if la["flash_attention_wgmma"] < 1 or sums < 1:
            problems.append(f"{tag}: K2 or the TAB's sum never launched")
        if rowpar and (sums < (2 * layers + 1) * run["steps"]
                       or run["deterministic"]):
            problems.append(f"{tag}: the TAB's sums {sums} for "
                            f"{run['steps']} steps, deterministic "
                            f"{run['deterministic']}")
        if pager is not None:
            remote = run["ledger"].get(tiers.REMOTE, {})
            if run["fetches"] != layers * (run["steps"] + st["admitted"]) \
                    or remote.get("layer_weights") != shard:
                problems.append(f"{tag}: {run['fetches']} weight fetches, "
                                f"remote layer_weights "
                                f"{remote.get('layer_weights')} B (this "
                                f"rank's shard: {shard} B)")
        if pager is not None and pager.get("offload_kv"):
            passes = run["steps"] + (0 if slab else st["admitted"])
            if run["window"] != (layers * passes, layers * passes):
                problems.append(f"{tag}: KV window {run['window']} for "
                                f"{passes} passes")
        if kw.get("num_pages"):
            swapped = run["swap"].get("kv_swap_out", {}).get("bytes", 0)
            if (st["preemptions"] < 1 or st["resumes"] != st["preemptions"]
                    or st["sheds"]
                    or swapped != st["preempted_pages"] * page_bytes):
                problems.append(f"{tag}: {st['preemptions']} preemptions, "
                                f"{st['resumes']} resumes, {st['sheds']} "
                                f"sheds, {swapped} B stashed for "
                                f"{st['preempted_pages']} pages of "
                                f"{page_bytes} B")
        if "cold_park_after_blocks" in kw and not (
                st["cold_parks"] >= 1
                and st["cold_promotes"] == st["cold_parks"]):
            problems.append(f"{tag}: {st['cold_parks']} parks, "
                            f"{st['cold_promotes']} promotes")
        if kw.get("prefill_async"):
            staged = run["handoff"].get("kv_swap_out", {}).get("bytes", 0)
            if (st["handoffs"] < 2 or st["prefill_chunks"] <= st["handoffs"]
                    or not staged or staged % page_bytes):
                problems.append(f"{tag}: {st['handoffs']} handoffs, "
                                f"{st['prefill_chunks']} chunks, {staged} B "
                                f"staged (pages of {page_bytes} B)")


def _cross_placement(tag: str, got: dict, want: dict, got32: dict,
                     want32: dict, problems: list,
                     atol: float = TP_LOGIT_ATOL) -> None:
    """Hold a sharded bf16 run to one card's by the first-8 rule (first-8 >=
    ``MATCH_FIRST8`` and the last position's logits within ``atol`` +
    ``TP_LOGIT_RTOL`` |logit|), or else its fp32 witness to one card's
    (first-8, the logits within ``LOGIT_BOUND``)."""
    dl = (got["logits"] - want["logits"]).abs()
    over = (dl - TP_LOGIT_RTOL * want["logits"].abs()).max().item()
    f8 = _match_first8(got["tokens"], want["tokens"])
    d32 = (got32["logits"] - want32["logits"]).abs().max().item()
    f8_32 = _match_first8(got32["tokens"], want32["tokens"])
    bf16_ok = f8 >= MATCH_FIRST8 and over <= atol
    log(f"{tag}: against one card, bf16 last-position logits max |d| "
        f"{dl.max().item():.4g} ({'within' if over <= atol else 'beyond'} "
        f"atol {atol:g} + rtol {TP_LOGIT_RTOL:g}), first-8 {f8:.3f}, tokens "
        f"{'bit-equal' if got['tokens'] == want['tokens'] else 'not bit-equal'}"
        f"; fp32 witness logits max |d| {d32:.4g}, first-8 {f8_32:.3f}: "
        f"{'the first-8 rule held in bf16' if bf16_ok else 'held to the fp32 witness'}")
    if not bf16_ok and (f8_32 < MATCH_FIRST8 or d32 > LOGIT_BOUND):
        problems.append(f"{tag}: bf16 and the fp32 witness part from one "
                        f"card's: first-8 {f8:.3f} / {f8_32:.3f}, logits "
                        f"{over:.4g} / {d32:.4g}")


def check_tp_rowpar(torch, card: str, cfg, params, r: dict, m: int,
                    one: dict, one32: dict, problems: list) -> None:
    """Log and gate one rank's row-parallel greedy run (``rowpar``) beside
    its all-gather run: ms a step in both modes over the flags (the graph
    route) and over the barrier (eager), weight bytes in both modes (each
    its specs' shard), the TAB's sums at least 2 x layers + 1 a step, K1
    once a layer a step, K2 launched, the graph route, the bf16 tokens
    bit-equal to the barrier run's; against one card by the first-8 rule
    or the fp32 witness."""
    from repro_torch.memory import tree_bytes
    from repro_torch.models.transformer import DenseLM
    model = DenseLM(cfg)
    row, layers = r["rowpar"], cfg.num_layers
    tag = f"tp m={m} rank {r['rank']} row-parallel"
    la = row["launches"]
    want_row = _shard_bytes(params, model.param_specs(), m)
    want_gather = _shard_bytes(params, model.serving_param_specs(), m)
    moved = {k: (v["transfers"], v["bytes"])
             for k, v in row["tally"].items() if v["transfers"]}
    bar = r["rowpar_barrier"]
    log(f"{tag} [{card}]: {1e3 * row['secs'] / row['steps']:.2f} ms a step "
        f"over the flags, route {row['route']} ({row['steps']} steps, "
        f"admissions included; all-gather "
        f"{1e3 * r['secs'] / r['steps']:.2f}); over the barrier, route "
        f"{bar['route']}, {1e3 * bar['secs'] / bar['steps']:.2f} ms, the "
        f"notice {100 * bar['wait_s'] / bar['secs']:.1f} % of it; weight "
        f"bytes "
        f"{row['params_bytes']} (all-gather {r['params_bytes']}, one card "
        f"{tree_bytes(params)}; the layers' "
        f"{_shard_bytes(params['layers'], model.param_specs()['layers'], m)}"
        f" vs "
        f"{_shard_bytes(params['layers'], model.serving_param_specs()['layers'], m)}"
        f"), peak device memory {row['peak'] / 2**30:.2f} GiB, collectives "
        f"on 'model' (transfers, bytes) from Python: {moved}, K1 "
        f"{la['paged_attention']}, K2 {la['flash_attention_wgmma']}, the "
        f"TAB's collective {row['instances']['tab_collective']}; the "
        f"largest partial {row['largest']}")
    if any(row["errors"]) or any(len(t) != TP_NEW for t in row["tokens"]):
        problems.append(f"{tag}: a request did not emit its {TP_NEW} "
                        f"tokens: {row['errors']}")
    if (row["model_shards"] != m or row["route"] != "graph"
            or bar["route"] != "eager" or row["deterministic"]):
        problems.append(f"{tag}: shards {row['model_shards']}, route "
                        f"{row['route']} (barrier {bar['route']}), "
                        f"deterministic {row['deterministic']}")
    if row["tokens"] != bar["tokens"]:
        problems.append(f"{tag}: bf16 tokens over the flags (graph) part "
                        f"from the barrier run's (eager)")
    sums = row["instances"]["tab_collective"].get("sum", 0)
    if (sums < (2 * layers + 1) * row["steps"]
            or la["paged_attention"] != layers * row["steps"]
            or la["flash_attention_wgmma"] < 1):
        problems.append(f"{tag}: the TAB's sums {sums}, K1 "
                        f"{la['paged_attention']}, K2 "
                        f"{la['flash_attention_wgmma']} for {row['steps']} "
                        f"steps")
    if row["params_bytes"] != want_row or r["params_bytes"] != want_gather:
        problems.append(f"{tag}: weight bytes {row['params_bytes']} / "
                        f"{r['params_bytes']}, the specs' shards {want_row} "
                        f"/ {want_gather}")
    _cross_placement(tag, row, one, r["rowpar_fp32"], one32, problems)


#: the tp phase's family spawn, row-parallel on 2 ranks over the slab:
#: (architecture, config overrides, all-reduces a decode step -- one a
#: row-parallel projection and the embedding's --, K2 launches an
#: admission).  recurrentgemma-9b is cut to its first pattern period and
#: its tail (5 of 38 layers: rec, rec, att + rec, rec), tp=2 so that its
#: one KV head is replicated to each rank; xlstm-125m (12 blocks, one
#: partial each) and whisper-base (3 partials a decoder layer; its
#: encoder's 6 and decoder's 12 attentions an admission) at full depth,
#: tp=1
TP_FAMILIES = (("recurrentgemma-9b", dict(num_layers=5, tp=2), 11, 1),
               ("xlstm-125m", dict(tp=1), 13, 0),
               ("whisper-base", dict(tp=1), 19, 18))
TP_FAMILY_NEW = 16
#: blocks of 8: over the slab a block's inputs keep one key, so the
#: second block is captured and replayed
TP_FAMILY_KW = dict(batch_size=4, max_seq=64, block_size=8, paged=False)
#: whisper-base's bf16 logit bound against one card (F4, ROADMAP)
WHISPER_LOGIT_ATOL = 0.25
#: seconds the family spawn's ranks may take, their start included
TP_FAMILY_S = 300


def _family_work(cfg):
    """The serve phase's four 8-token prompts and, for the
    encoder-decoder, a request's seeded random frames (1, 1500, d)."""
    import numpy as np
    work = prompts(cfg.vocab, 0)[:4]
    if cfg.family != "encdec":
        return work, None
    rng = np.random.RandomState(5)
    return work, [rng.randn(1, cfg.encoder_seq, cfg.d_model).astype(
        np.float32) for _ in work]


def _family_serve(torch, cfg, params, work, frames, new: int, mesh=None,
                  **kw) -> dict:
    """Serve ``work`` over the slab (``TP_FAMILY_KW``, updated by ``kw``)
    with the counts and the mesh's tally reset just before; the run's
    tokens and numbers, the largest partial summed from Python, and
    (after the counts are read) the prompts' last position's logits from
    one prefill at the model level."""
    import numpy as np
    from repro_torch.configs import build_model
    from repro_torch.kernels import (instance_counts, launch_counts,
                                     reset_launch_counts)
    from repro_torch.memory import tree_bytes
    from repro_torch.runtime.serve import BatchedServer
    model = build_model(cfg)
    server = BatchedServer(model, params, mesh=mesh,
                           graph=False if mesh is None else None,
                           **dict(TP_FAMILY_KW, **kw))
    t = mesh.transport("model") if mesh is not None else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    if t is not None:
        t.reset_tally()
    seen: dict = {}
    with largest_collectives(t, seen):
        reqs = [server.submit(p, max_new_tokens=new,
                              extra=None if frames is None
                              else {"frames": frames[i]})
                for i, p in enumerate(work)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.run_once()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    st = server.stats
    out = {"tokens": [r.output for r in reqs],
           "errors": [r.error for r in reqs], "secs": secs,
           "steps": st["steps"], "admitted": st["admitted"],
           "route": server.route, "graph_blocks": st["graph_blocks"],
           "launches": launch_counts(),
           "instances": instance_counts(),
           "tally": ({k: dict(v) for k, v in t.tally.items()}
                     if t is not None else {}),
           "wait_s": t.wait_s if t is not None else 0.0,
           "params_bytes": tree_bytes(server.params),
           "model_shards": st["model_shards"],
           "deterministic": st["deterministic"],
           "peak": torch.cuda.max_memory_allocated(),
           "largest": seen.get("all_reduce")}
    toks = torch.as_tensor(np.stack(work), device="cuda")
    extra = (None if frames is None else
             {"frames": torch.from_numpy(np.concatenate(frames)).to("cuda")})
    with torch.no_grad():
        logits, _ = model.prefill(server.params, toks, model.init_cache(
            len(work), 16, device="cuda"), extra)
    out["logits"] = logits.float().cpu()
    del server, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_family_rank(fams: list) -> dict:
    """One rank of the family spawn: loads the kernels the parent built,
    then serves each family of ``fams`` in turn row-parallel over the
    world's mesh on the shared region, in bf16 (``TP_FAMILY_NEW`` tokens)
    and its fp32 witness (``TP_WITNESS_NEW``), from the parent's weights
    shared by IPC (each server copies this rank's ``param_specs``
    shard)."""
    import torch
    from repro_torch.kernels import _kernel_modules, build
    from repro_torch.launch.mesh import make_serving_mesh, world
    build.require_built([m.SOURCE for m in _kernel_modules()])
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_serving_mesh(model=world().size, transport="shared")
    out = {"rank": mesh.rank}
    for name, cfg, params, cfg32, params32, work, frames in fams:
        out[name] = _family_serve(torch, cfg, params, work, frames,
                                  TP_FAMILY_NEW, mesh, deterministic=False)
        out[name]["fp32"] = _family_serve(torch, cfg32, params32, work,
                                          frames, TP_WITNESS_NEW, mesh,
                                          deterministic=False)
    return out


def check_tp_families(torch, card: str, counts: Launches,
                      problems: list) -> list:
    """recurrentgemma-9b (5 of 38 layers), xlstm-125m and whisper-base at
    full width, bf16 from seeded random weights, served by this process
    (eager) and row-parallel by 2 ranks over one shared region's flags
    (``TP_FAMILIES``), each with its fp32 witness.  Gates on every rank:
    the tokens emitted and equal on both ranks, the graph route, the
    TAB's sums at least the family's all-reduces a step x steps, K2 at
    the family's launches an admission, the rank's weight bytes its
    ``param_specs`` shard; against one card by the first-8 rule
    (whisper's logits within its F4 bound) or else the fp32 witness.
    Returns the TAB's cases at each family's largest partial (for
    ``check_tab_kernel``)."""
    import dataclasses
    from repro_torch.configs import build_model, get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.memory import tree_bytes
    from repro_torch.memory.accounting import tree_map
    fams, ones, rules, cases = [], {}, {}, []
    for name, over, reduces, k2 in TP_FAMILIES:
        full = get_config(name)
        cfg = dataclasses.replace(full, **over)
        if cfg.num_layers < full.num_layers:
            log(f"tp: DEPTH CUT: {name} at full width and {cfg.num_layers} "
                f"of {full.num_layers} layers")
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        params = build_model(cfg).init(0, device="cuda")
        params32 = tree_map(lambda t: t.float(), params)
        work, frames = _family_work(cfg)
        ones[name] = (_family_serve(torch, cfg, params, work, frames,
                                    TP_FAMILY_NEW),
                      _family_serve(torch, cfg32, params32, work, frames,
                                    TP_WITNESS_NEW))
        rules[name] = (reduces, k2, build_model(cfg).param_specs())
        fams.append((name, cfg, params, cfg32, params32, work, frames))
    t0 = time.perf_counter()
    ranks = spawn(tp_family_rank, 2, fams, device="cuda",
                  region_bytes=TP_REGION, timeout=TP_FAMILY_S)
    wall = time.perf_counter() - t0
    for r in ranks:
        for name, cfg, params, *_ in fams:
            run, (one, one32) = r[name], ones[name]
            reduces, k2, specs = rules[name]
            counts.add(run["launches"], run["instances"])
            la, tag = run["launches"], f"tp family {name} m=2 rank {r['rank']}"
            want_bytes = _shard_bytes(params, specs, 2)
            moved = {k: (v["transfers"], v["bytes"])
                     for k, v in run["tally"].items() if v["transfers"]}
            log(f"{tag} row-parallel [{card}]: "
                f"{1e3 * run['secs'] / run['steps']:.2f} ms a step "
                f"({run['steps']} steps, admissions included, route "
                f"{run['route']}, {run['graph_blocks']} blocks replayed; "
                f"one card "
                f"{1e3 * one['secs'] / one['steps']:.2f}), weight "
                f"bytes {run['params_bytes']} (one card "
                f"{tree_bytes(params)}), peak device memory "
                f"{run['peak'] / 2**30:.2f} GiB, collectives on 'model' "
                f"(transfers, bytes) from Python: {moved}, K2 "
                f"{la['flash_attention_wgmma']}, the TAB's collective "
                f"{run['instances']['tab_collective']}; the largest "
                f"partial {run['largest']}")
            if any(run["errors"]) or any(len(t) != TP_FAMILY_NEW
                                         for t in run["tokens"]):
                problems.append(f"{tag}: a request did not emit its "
                                f"{TP_FAMILY_NEW} tokens: {run['errors']}")
            if (run["route"] != "graph" or run["graph_blocks"] < 1
                    or run["model_shards"] != 2 or run["deterministic"]):
                problems.append(f"{tag}: route {run['route']} "
                                f"({run['graph_blocks']} blocks replayed), shards "
                                f"{run['model_shards']}, deterministic "
                                f"{run['deterministic']}")
            sums = run["instances"]["tab_collective"].get("sum", 0)
            if (sums < reduces * run["steps"]
                    or la["flash_attention_wgmma"] != k2 * run["admitted"]
                    or la["flash_attention_mma"]):
                problems.append(f"{tag}: the TAB's sums {sums} for "
                                f"{run['steps']} steps (>= {reduces} a "
                                f"step), K2 {la} for {run['admitted']} "
                                f"admissions ({k2} each)")
            if run["params_bytes"] != want_bytes:
                problems.append(f"{tag}: weight bytes {run['params_bytes']}"
                                f", its param_specs shard {want_bytes}")
            if run["largest"] is not None:
                cases.append((f"{name}'s largest partial", 2,
                              run["largest"], False, "tpfam"))
            _cross_placement(tag, run, one, run["fp32"], one32, problems,
                             atol=WHISPER_LOGIT_ATOL
                             if name == "whisper-base" else TP_LOGIT_ATOL)
    for name, *_ in fams:
        if ranks[0][name]["tokens"] != ranks[1][name]["tokens"]:
            problems.append(f"tp family {name}: the ranks' tokens differ")
    log(f"tp families m=2: {wall:.1f} s with the ranks' start")
    del fams, ranks
    gc.collect()
    torch.cuda.empty_cache()
    return cases


def _tp_layers(torch, got, want) -> str:
    """Each layer output's max |d| and share of differing elements, the
    embedding first."""
    return ", ".join(
        f"{'emb' if i == 0 else i - 1} {(a.float() - b.float()).abs().max().item():.3g}"
        f"/{(a != b).float().mean().item():.3f}"
        for i, (a, b) in enumerate(zip(got, want)))


def check_tp(torch, card: str, counts: dict, results: dict) -> None:
    """The tp phase: Qwen2.5-14B at full width and ``TP_LAYERS`` layers,
    bf16 pools, the serving workload's four 8-token prompts (``TP_NEW``
    new tokens), served by this process (eager) and then by m = 2 and
    m = 4 ranks on this card over one shared region
    (``SharedRegionTransport``): over its flags notice, every collective
    one launch of the TAB's collective and the decode blocks replayed as
    CUDA graphs, and over its barrier notice, eagerly (K4 the
    accumulate).

    Gates: the TAB's sums, K1 (once a layer a step, replays counted) and
    K2 on every rank, per-rank pool bytes = single / m, ``model_shards``
    and the ledger's shards m, the graph route over the flags and the
    eager route over the barrier, the flags' bf16 tokens bit-equal to the
    barrier's, the embedding bit-equal on every rank; the tokens
    bit-equal to the single server's, or else the fp32 witness: the same
    weights in fp32 (a rounding unit 2^16 times finer), sharded against
    one card, held to the first-8 rule and the last position's logits
    within ``LOGIT_BOUND`` (a rounding difference shrinks with the unit,
    a fault does not).  The bf16 logits against the paged bf16 bound
    (``TP_LOGIT_ATOL`` / ``TP_LOGIT_RTOL``) and first-8, each layer's
    max |d|, and whether layer 0's sharded products equal the full
    product's columns are printed (``tp_products``).  The m = 2 ranks also
    serve ``TP_RUNS`` (``check_tp_lifecycle``).  Then the TAB's
    collective against its plain version at ``TAB_SHAPES`` and at the
    largest all-reduce and all-gather each mesh issued
    (``check_tab_kernel``: rows of ``results``).  ``counts``: m -> the
    launches of its runs (m = 1: this process's)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.memory import tree_bytes
    from repro_torch.memory.accounting import tree_map
    from repro_torch.models.transformer import DenseLM
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), tp=1,
                              num_layers=TP_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    log(f"tp: DEPTH CUT: Qwen2.5-14B at full width and {TP_LAYERS} of 48 "
        f"layers; TP_RUNS and TP_ROWPAR_RUNS at {TP_LIFE_LAYERS}")
    before = torch.cuda.memory_allocated()
    params = DenseLM(cfg).init(0, device="cuda")
    work = prompts(cfg.vocab, 0)[:4]
    one = _tp_serve(torch, cfg, params, work, TP_NEW, block_size=TP_BLOCK)
    counts[1].add(one["launches"], one["instances"])
    log(f"tp m=1 [{card}]: {1e3 * one['secs'] / one['steps']:.2f} ms a "
        f"step eager ({one['steps']} steps, admissions included, route "
        f"{one['route']}), peak device memory {one['peak'] / 2**30:.2f} "
        f"GiB, params {tree_bytes(params) / 2**30:.2f} GiB, kv_pool "
        f"{one['kv_capacity']} B, K1 {one['launches']['paged_attention']}, "
        f"K4 {one['launches']['write_accumulate']}")
    tp_products(torch, card, params)
    params32 = tree_map(lambda t: t.float(), params)
    one32 = _tp_serve(torch, cfg32, params32, work, TP_WITNESS_NEW,
                      block_size=TP_BLOCK)
    problems = []
    cases = [(label, n, shape, gather, f"tp{n}")
             for label, n, shape, gather in TAB_SHAPES]
    for m in TP_SHARDS:
        t0 = time.perf_counter()
        ranks = spawn(tp_rank, m, cfg, params, cfg32, params32, work,
                      m == 2, device="cuda", region_bytes=TP_REGION,
                      timeout=TP_TIMEOUT + (TP_LIFECYCLE_S if m == 2 else 0))
        wall = time.perf_counter() - t0
        for r in ranks:
            for run in (r["barrier"], r["rowpar_barrier"]):
                counts[m].add(run["launches"], run["instances"])
            for key, gather in (("largest", False),
                                ("largest_gather", True)):
                for run in (r, r["rowpar"]):
                    if run[key] is not None:
                        cases.append((f"the ranks' largest "
                                      f"{'gather' if gather else 'all-reduce'}",
                                      m, run[key], gather, f"tp{m}"))
            counts[m].add(r["launches"], r["instances"])
            for run in r.get("lifecycle", {}).values():
                counts[m].add(run["launches"], run["instances"])
            for run in r.get("rowpar_lifecycle", {}).values():
                counts[m].add(run["launches"], run["instances"])
            counts[m].add(r["rowpar"]["launches"], r["rowpar"]["instances"])
            if "lifecycle" in r:
                for rowpar in (False, True):
                    check_tp_lifecycle(torch, card,
                                       *_cut(cfg, params, TP_LIFE_LAYERS),
                                       r, m, problems, rowpar=rowpar)
            check_tp_rowpar(torch, card, cfg, params, r, m, one, one32,
                            problems)
            tag = f"tp m={m} rank {r['rank']}"
            for kind, (real, dry) in r.get("dryrun_tally", {}).items():
                log(f"{tag} row-parallel {kind} step, the shared region's "
                    f"tally {real}, the dry run's {dry}")
                if not real or real != dry:
                    problems.append(f"{tag}: the {kind} step's tally {real}"
                                    f" is not the dry run's {dry}")
            bar = r["barrier"]
            moved = {k: (v["transfers"], v["bytes"])
                     for k, v in r["tally"].items() if v["transfers"]}
            log(f"{tag} [{card}]: {1e3 * r['secs'] / r['steps']:.2f} ms a "
                f"step over the flags ({r['steps']} steps, admissions "
                f"included, route {r['route']}: {r['stats']['graph_blocks']}"
                f" blocks replayed, {r['stats']['eager_blocks']} eager); "
                f"over the barrier {1e3 * bar['secs'] / bar['steps']:.2f} ms"
                f" (route {bar['route']}), the completion notice (stream "
                f"sync + gloo barrier) {100 * bar['wait_s'] / bar['secs']:.1f}"
                f" % of it; peak device memory "
                f"{r['peak'] / 2**30:.2f} GiB (params "
                f"{r['params_bytes'] / 2**30:.2f} GiB), kv_pool "
                f"{r['kv_capacity']} B, collectives on 'model' (transfers, "
                f"bytes) from Python: {moved}, K1 "
                f"{r['launches']['paged_attention']}, K2 "
                f"{r['launches']['flash_attention_wgmma']}, the TAB's "
                f"collective {r['instances']['tab_collective']} (barrier: K4 "
                f"{bar['launches']['write_accumulate']})")
            for mode, run in (("all-gather", r), ("row-parallel",
                                                  r["rowpar"])):
                rp = run.get("replay", {})
                if not rp:
                    problems.append(f"{tag} {mode}: no block was captured")
                    continue
                log(f"{tag} {mode} [{card}]: a block of {rp['steps']} steps "
                    f"replayed {rp['replay']:.2f} ms a step, run "
                    f"eagerly over the flags {rp['eager']:.2f} ms a step"
                    + ("" if "tab_ms" not in rp else
                       f"; traced replay {rp['wall_ms']:.2f} ms wall, device "
                       f"busy {rp['busy_ms']:.2f} ms "
                       f"({100 * rp['busy_ms'] / rp['wall_ms']:.1f} %), the "
                       f"TAB's collective {rp['tab_ms']:.2f} ms of it "
                       f"({100 * rp['tab_ms'] / rp['busy_ms']:.1f} %, "
                       f"{rp['tab_calls']} launches, "
                       f"{rp['tab_ms'] / max(rp['tab_calls'], 1):.4f} ms "
                       f"each)"))
            if any(r["errors"]) or any(len(t) != TP_NEW for t in r["tokens"]):
                problems.append(f"{tag}: a request did not emit its "
                                f"{TP_NEW} tokens: {r['errors']}")
            if r["model_shards"] != m or r["shards"] != m:
                problems.append(f"{tag}: model_shards {r['model_shards']}, "
                                f"ledger shards {r['shards']}")
            if r["route"] != "graph" or bar["route"] != "eager" or \
                    r["stats"]["graph_blocks"] < 1:
                problems.append(f"{tag}: route {r['route']} "
                                f"({r['stats']['graph_blocks']} blocks "
                                f"replayed), barrier {bar['route']}")
            if r["tokens"] != bar["tokens"]:
                problems.append(f"{tag}: bf16 tokens over the flags (graph)"
                                f" part from the barrier run's (eager)")
            if r["instances"]["tab_collective"].get("sum", 0) < r["steps"] \
                    or bar["launches"]["write_accumulate"] < 1:
                problems.append(f"{tag}: the TAB's sums "
                                f"{r['instances']['tab_collective']}, the "
                                f"barrier's K4 "
                                f"{bar['launches']['write_accumulate']}")
            if r["launches"]["paged_attention"] != TP_LAYERS * r["steps"]:
                problems.append(f"{tag}: K1 {r['launches']['paged_attention']}"
                                f" for {r['steps']} steps, not one a layer")
            if r["launches"]["flash_attention_wgmma"] < 1:
                problems.append(f"{tag}: K2 never launched on wgmma")
            if r["kv_capacity"] * m != one["kv_capacity"] or \
                    r["cache_bytes"] * m != one["cache_bytes"]:
                problems.append(f"{tag}: kv_pool {r['kv_capacity']} B "
                                f"(cache {r['cache_bytes']}) x {m} != "
                                f"{one['kv_capacity']}")
            if not torch.equal(r["hidden"][0], one["hidden"][0]):
                problems.append(f"{tag}: the embedding (K4's all-reduce of "
                                f"one row and zeros) is not one card's")
            dl = (r["logits"] - one["logits"]).abs()
            over = (dl - TP_LOGIT_RTOL * one["logits"].abs()).max().item()
            f8 = _match_first8(r["tokens"], one["tokens"])
            log(f"{tag}: bf16 layer outputs against one card's, max |d| / "
                f"share differing: {_tp_layers(torch, r['hidden'], one['hidden'])}"
                f"; last-position logits max |d| {dl.max().item():.4g} "
                f"({'within' if over <= TP_LOGIT_ATOL else 'beyond'} the "
                f"bf16 bound), first-8 {f8:.3f}")
            w32 = r["fp32"]
            d32 = (w32["logits"] - one32["logits"]).abs().max().item()
            f8_32 = _match_first8(w32["tokens"], one32["tokens"])
            log(f"{tag}: fp32 witness: layer outputs "
                f"{_tp_layers(torch, w32['hidden'], one32['hidden'])}; "
                f"last-position logits max |d| {d32:.4g}, tokens "
                f"{'bit-equal' if w32['tokens'] == one32['tokens'] else 'not bit-equal'}"
                f", first-8 {f8_32:.3f}")
            if r["tokens"] == one["tokens"]:
                log(f"{tag}: bf16 tokens bit-equal to one card's")
                continue
            log(f"{tag}: bf16 tokens NOT bit-equal to one card's: held to "
                f"the fp32 witness")
            if f8_32 < MATCH_FIRST8 or d32 > LOGIT_BOUND:
                problems.append(f"{tag}: the fp32 witness parts from one "
                                f"card's: first-8 {f8_32:.3f}, logits "
                                f"{d32:.4g} (bound {LOGIT_BOUND})")
        if any(r["rowpar"]["tokens"] != ranks[0]["rowpar"]["tokens"]
               for r in ranks):
            problems.append(f"tp m={m}: the ranks' row-parallel tokens "
                            f"differ")
        log(f"tp m={m}: {wall:.1f} s with the ranks' start")
    # the weights the ranks shared by IPC come back once every rank let go
    del params, params32, ranks
    gc.collect()
    torch.cuda.empty_cache()
    cases += check_tp_families(torch, card, counts["fam"], problems)
    check_tab_kernel(torch, card, results, cases)
    left = torch.cuda.memory_allocated() - before
    log(f"tp: device memory still allocated after the phase "
        f"{left / 2**30:.2f} GiB")
    if left > 1 << 30:
        problems.append(f"{left / 2**30:.2f} GiB still allocated after the "
                        f"ranks exited (memory shared by IPC not released)")
    if problems:
        raise AssertionError("tp phase: " + "; ".join(problems))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=SERVE_LAYERS,
                    help="depth of the serve, dense, tiers and disagg "
                         "phases (Qwen2.5-14B has 48; the default run "
                         f"serves {SERVE_LAYERS} to stay inside its time)")
    ap.add_argument("--phases",
                    default="dryrun,kernels,parity,moe,gpt3,families,"
                            "train,train_mesh,tp,serve,dense,tiers,disagg",
                    help="comma list of dryrun, kernels, parity, moe, gpt3, "
                         "families, train, train_mesh, tp, serve, dense, "
                         "tiers, disagg, "
                         "profile (a traced serving run), sweep (K3's "
                         "routes over M) and notice (the TAB's collective "
                         "against its plain version and its notice timed "
                         "across ranks); the last three are off by "
                         "default")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build_all
    from repro_torch.kernels.expert_gather import kernel as eg_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.streamed_matmul import kernel as sm_kernel
    from repro_torch.kernels.write_accumulate import kernel as wa_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = start = time.perf_counter()
    reports = build_all()
    log(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for src, rep in reports.items():
        for line in ptxas_summary(rep):
            log(f"  {src}: {line}")

    results: dict = {}
    clock = [time.perf_counter()]

    def took(phase: str) -> None:
        """Log the seconds since the last phase ended, and the host's
        available memory and the card's allocated memory after it."""
        now = time.perf_counter()
        log(f"phase {phase}: {now - clock[0]:.1f} s; host MemAvailable "
            f"{host_mem('MemAvailable')}, device memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        clock[0] = now

    if "dryrun" in phases:
        # first: its allocations start from empty segments
        check_dryrun(torch, card, args.layers)
        gc.collect()
        torch.cuda.empty_cache()
        took("dryrun")
    if "kernels" in phases:
        for kv in (None, "int8", "fp8_e4m3"):
            check_paged(torch, card, results, kv)
        for hkv, g, d, timed, phase in K1_GROUPS:
            for kv in (None, "int8"):
                check_paged(torch, card, results, kv, hkv=hkv, g=g, d=d,
                            timed=timed and kv is None, phase=phase)
        for kv in (None, "int8"):      # granite-moe-3b-a800m's decode
            check_paged(torch, card, results, kv, hkv=8, g=3, d=64,
                        phase="moe")
        check_flash(torch, card, results)
        check_gather(torch, card, results)
        check_matmul(torch, card, results)
        check_realign(torch)
        check_accumulate(torch, card, results)
        ops_launches = drive_ops(torch)
        took("kernels")
    if "sweep" in phases:
        sweep_matmul(torch, card)
        took("sweep")
    if "notice" in phases:
        check_notice(torch, card, results)
        took("notice")
    parity_launches = None
    if "parity" in phases:
        parity_launches = check_parity(torch)
        check_parity_families(torch)
        check_parity_dense(torch)
        check_parity_train(torch)
        took("parity")
    moe = None
    if "moe" in phases:
        # before the Qwen2.5-14B weights exist: its peak device memory is
        # the MoE's alone
        moe = Launches("moe")
        check_moe(torch, card, moe)
        torch.cuda.empty_cache()
        took("moe")
    gpt3 = None
    if "gpt3" in phases:
        # also before the Qwen2.5-14B weights: 31.5 GB of its own
        gpt3 = Launches("gpt3")
        check_gpt3(torch, card, gpt3)
        gc.collect()
        torch.cuda.empty_cache()
        took("gpt3")
    families = None
    if "families" in phases:
        # before the Qwen2.5-14B weights too: recurrentgemma-9b's 20.9 GB
        families = Launches("families")
        check_families(torch, card, families)
        gc.collect()
        torch.cuda.empty_cache()
        took("families")
    trained = None
    if "train" in phases:
        # before the Qwen2.5-14B weights too: minicpm-2b's training state
        # (bf16 params and grads, fp32 moments and summed grads) is ~44 GB
        trained = Launches("train")
        check_train(torch, card, results, trained, "profile" in phases)
        gc.collect()
        torch.cuda.empty_cache()
        took("train")
    train_meshed = None
    if "train_mesh" in phases:
        # before the Qwen2.5-14B weights: 4 ranks' training state
        train_meshed = Launches("train_mesh")
        check_train_mesh(torch, card, results, train_meshed)
        gc.collect()
        torch.cuda.empty_cache()
        took("train_mesh")
    tp = None
    if "tp" in phases:
        # before the Qwen2.5-14B weights of the serve phase: the ranks'
        # shards and this process's 12 layers share the card
        tp = {m: Launches(f"tp m={m}") for m in (1, *TP_SHARDS, "fam")}
        check_tp(torch, card, tp, results)
        gc.collect()
        torch.cuda.empty_cache()
        took("tp")
    launches = tiers = served = dense = None
    if phases & {"serve", "tiers", "disagg", "dense"}:
        # one set of weights, --layers deep, for the serving phases
        cfg, params = qwen_params(torch, args.layers)
    if "serve" in phases:
        *launches, served = check_serve(torch, card, cfg, params,
                                        "profile" in phases)
        if args.layers in DRYRUN and "replay_ms" in GRAPH_RUN:
            log(f"dryrun vs serve [{card}]: the decode step at "
                f"{args.layers} layers, counted by the dry run at B=4 "
                f"S=384, allows at least "
                f"{DRYRUN[args.layers]['bound_ms']:.4f} ms; the steady "
                f"state's replayed step (B=4, pools of max_seq 1024) took "
                f"{GRAPH_RUN['replay_ms']:.4f} ms "
                f"({GRAPH_RUN['replay_ms'] / DRYRUN[args.layers]['bound_ms']:.2f}"
                f"x); at 48 layers the dry run allows "
                f"{DRYRUN[48]['bound_ms']:.4f} ms")
        took("serve")
    if "tiers" in phases:
        tiers = Launches()
        check_tiers(torch, card, cfg, params, tiers, served)
        took("tiers")
    if "disagg" in phases:
        depth = min(cfg.num_layers, DISAGG_LAYERS)
        check_disagg(torch, card,
                     dataclasses.replace(cfg, num_layers=depth),
                     dict(params, layers=params["layers"][:depth]), None)
        took("disagg")
    if "dense" in phases:
        dense = Launches("dense")
        check_dense(torch, card, cfg, params, dense, served)
        took("dense")
    if "serve" in phases:
        check_serve_paged(torch, card, cfg, params, "profile" in phases)
        took("serve (paged weights)")
    if "tiers" in phases:
        check_offload(torch, card, dataclasses.replace(
            cfg, num_layers=min(cfg.num_layers, OFFLOAD_LAYERS)), params,
            tiers)
        took("tiers (offload_kv)")

    log(f"chip_smoke: {time.perf_counter() - start:.1f} s from the build "
        f"to the last phase's end")
    if results and launches is not None and parity_launches is not None:
        # a row's launches: its instantiation's (K1: query rows; K2: head
        # dim) where the kernel names them, in the run of the row's path;
        # a row whose instantiation that path never launched reads 0
        kernels = []
        serving = "BatchedServer, greedy run of its pool dtype (serve phase)"
        smoke = ("BatchedServer, fp32 smoke model, greedy card run (parity "
                 "phase)")
        wrappers = "ops.matmul / ops.accumulate at their shapes (kernels phase)"
        def count(counts, name, row):
            total, by_instance = counts
            return (by_instance.get(name, {}).get(row["instance"], 0)
                    if "instance" in row else total.get(name, 0))

        def summed(run):
            return (run.total, run.by_instance) if run else ({}, {})

        def tp_mesh(row):
            """The mesh (its size, or "fam": the family spawn) whose tp
            runs a row's tp_launches read."""
            phase = row.get("phase", "")
            if phase == "tpfam":
                return "fam"
            return int(phase[2:]) if phase.startswith("tp") else 1

        tiered, moed, gpt3d, densed, familied, trainedd, meshd = (
            summed(r) for r in (tiers, moe, gpt3, dense, families, trained,
                                train_meshed))
        tpd = {m: summed(tp[m] if tp else None)
               for m in (1, *TP_SHARDS, "fam")}
        moe_path = ("BatchedServer, granite-moe-3b-a800m at full width, "
                    "greedy and sampled runs summed (moe phase)")
        # rows whose shape is another path's than their kernel's
        by_phase = {
            "moe": (moe_path, moed),
            "gpt3": ("BatchedServer, gpt3-175b at full width (8 of 96 "
                     "layers), resident greedy and sampled runs summed "
                     "(gpt3 phase)", gpt3d),
            "families": ("BatchedServer, recurrentgemma-9b at full width "
                         "and depth (resident runs, the 2100-token prompt, "
                         "paged groups), and whisper-base's bf16 prefill "
                         "and decode at full width, summed (families "
                         "phase)", familied),
            "train": ("make_train_step, minicpm-2b at full width and depth, "
                      f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
                      "tokens in 2 microbatches, the forward and the remat "
                      "recompute (train phase)", trainedd),
            "train_mesh": (TRAIN_MESH_PATH, meshd),
            "kernels": ("kernels phase only", ({}, {})),
            **{f"tp{m}": (TP_PATH[m], tpd[m]) for m in TP_SHARDS},
            "tpfam": (TP_PATH["fam"], tpd["fam"])}
        for mod, path, counts in ((pa_kernel, serving, launches),
                                  (fa_kernel, serving, launches),
                                  (sm_kernel, wrappers, (ops_launches, {})),
                                  (wa_kernel, wrappers, (ops_launches, {})),
                                  (eg_kernel, moe_path, moed)):
            for counter in mod.COUNTERS:
                name = counter.name
                if name == "flash_attention_mma":
                    path, counts = smoke, parity_launches
                for row in results.get(name, []):
                    mine = by_phase.get(row.get("phase"), (path, counts))
                    n = count(mine[1], name, row)
                    # the steady-state graph run serves the serve path's
                    # shapes only
                    graphed = 0 if row.get("phase") else count(
                        (GRAPH_RUN.get("total", {}),
                         GRAPH_RUN.get("by_instance", {})), name, row)
                    kernels.append({"name": name, "route": "cuda",
                                    "source": f"src/repro_torch/kernels/"
                                              f"csrc/{mod.SOURCE}",
                                    "replaces": mod.REPLACES,
                                    "path": mine[0] if n else
                                    "gradient checks only (train phase)"
                                    if row.get("phase") == "train" else
                                    "kernels phase only", "launches": n,
                                    "tiers_launches": count(tiered, name,
                                                            row),
                                    "disagg_launches": count(
                                        (DisaggRun.total,
                                         DisaggRun.by_instance), name, row),
                                    "moe_launches": count(moed, name, row),
                                    "gpt3_launches": count(gpt3d, name,
                                                           row),
                                    "dense_launches": count(densed, name,
                                                            row),
                                    "families_launches": count(
                                        familied, name, row),
                                    "train_launches": count(trainedd, name,
                                                            row),
                                    "train_mesh_launches": count(meshd, name,
                                                                 row),
                                    "tp_launches": count(tpd[tp_mesh(row)],
                                                         name, row),
                                    "tp_path": TP_PATH[tp_mesh(row)],
                                    "graph_launches": graphed,
                                    "graph_replayed_launches": (
                                        GRAPH_RUN.get("replayed", {})
                                        .get(name, 0) if graphed else 0),
                                    **row})
        log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

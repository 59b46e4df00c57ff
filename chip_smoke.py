#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and reported ok):

 1. build    nvcc-compiles every kernel in src/repro_torch/kernels/csrc
             (one process per source, all at once, threefry.cuh and
             walk_bits.cu with the rest, and the pointer_chase.cu latency
             probe beside them) into build/; then the probe: one thread
             follows a random cycle through 1 GiB of int32 (and through 16
             MiB, held in L2), 100,000 dependent reads, ns a read.
 2. serve    the serve_200m_replicated graph (140M pins, 60M boards, 1.2B
             edges, 4 edge languages) drawn uniformly on the card from a
             seeded generator and compiled by the port's build_graph;
             requests answered by PixieServer(buckets=[(1, 8)]) under the
             full production walk (FULL_WALK); p50 latency and per-phase
             times printed.  Kernel launch counts are reset before and read
             after this run.  Then one more request under torch.profiler:
             the device's busy and idle share and its time by kernel (the
             trace goes to chiprun_out/chip_smoke_trace.json).  2b: the
             top-k's selection kernel (topk_select) against its twin
             (counter.topk_select_plain) on a request's real boosted
             counts, its 8 slots as 8 rows of 140M (the related cell's
             shape) and its 8-slot boost as one row, k = top_k: the same
             indices bit for bit; timed beside the twin, its byte bound
             and torch.topk (the kernels line's two topk_select rows).
 3. parity   the same requests through serve_batch with backend="xla" (the
             plain PyTorch twins, on the card): ids, scores, steps_taken and
             n_high must be bit-identical to the kernel path.
 4. batched  synthetic.generate(20k pins, 2k boards, 16 topics, 4 langs,
             seed 7); 32 board-rec requests (count_boards on) through
             buckets [(16, 4), (8, 8)]: the batch-native qid lanes and the
             visit_counter_wide kernel; checked against the plain path.
 4b. past cap on the same graph, 1,537 queries x 8 slots (12,296 counter
             rows, past the 12,288 that visit_counter_update_high's shared
             tally once capped; 984 MB of counts) through serve_batch's
             batch-native engine on the kernel path under FULL_WALK (twice,
             wall time each), bit-identical to the plain twins through the
             same engine; then 1,600 queries x 8 slots sharded 2 ways
             (LocalFabric(2), 12,800 rows a shard; 1,024 walkers and
             20,000 steps a query), kernel path == plain path, drops
             included.
 5. kernels  each kernel against its plain twin at the main path's shapes
             (exact match), timed with CUDA events beside its twin, its
             bandwidth bound and, for the counters, torch's index_add_;
             the walk kernel draws its words from the keys, its twin takes
             walk._chunk_rbits' table of the same keys (timed alone on the
             card beside the walk row), its bound the larger of its bytes
             and its threefry integer operations; its chain of dependent
             reads replayed per walker and priced at the probe's L2-hit
             latency (the chain floor), at its DRAM latency, and by a
             first-touch L2 model of a cold chunk (with the L2 hit share);
             one launch at a time timed after a write that evicts L2 and
             without;
             visit_counter_update_high timed as the path calls it (the
             crossings added into a running tally in place, one launch),
             its old three-launch sequence (zeroed delta, kernel, add)
             logged beside it.  5b: visit_counter_wide at the board-rec
             bucket (16 x 4 x 2000 bins, 1,048,576 events, where a tile's
             bins fit the block's shared window) and at edge cases (no
             events, sentinel and negative lanes, one bin, no query lane,
             windows too big to share).  5c: a full-width board-rec
             request (count_boards on the FULL walk, 8 x 60M board bins)
             through serve_batch on the kernel and the plain path, bit for
             bit, its board counts from the kernel engine equal to the
             plain per-query engine's, and visit_counter_wide timed on its
             first chunk's board lanes (no shared window holds 480M bins).
             Each bound counts the distinct 32-byte sectors the run's own
             inputs touch (repeat reads of a row are L2 hits), plus the
             lanes and walker state read or written once.
 6. ranked   on the same graph, the reference's default ranker
             (RankerConfig(n_items=140M): d_model 32, 8 neighbors, 64
             candidates, final 16, two scenario heads), its 17.9 GB item
             table drawn on the card from a seeded generator after the
             graph build has freed its scratch; the 24 requests through
             PixieServer(ranker=...) with alternating scenarios, every
             result held against the plain path (walk twins plus the bag
             twin): ids, scores, steps_taken and n_high bit-identical.
             p50/max latency and one request's split (retrieval,
             neighborhoods, bags, heads, top-k).
 7. open     run_open_loop on that ranked replica: 200 Poisson requests
             offered at half of 1000 / p50 ms, admission-bounded
             (ResilienceConfig(elastic=False, max_queue_per_bucket=8));
             achieved QPS, p50/p99, the wait/compute split, drops and
             rejections.
 8. bag      the embedding-bag kernel against its twin, bit for bit, at the
             ranked path's shapes (a (1, 64, 8) neighbor bag and a (1, 1,
             64) query bag over the 140M x 32 table: each alone, and both
             in the ONE pair launch the path makes, against two twin
             calls) and at edge shapes and lengths (bf16, d = 33 and 48,
             bag lengths 1, 31, 32, 33, 64, 65 and 300, past the staging of
             256 rows, all-padding bags, sum and mean, the pair at edge
             lengths); the pair's device ms back to back, single launches
             with a warm and an evicted L2, the twin's ms, the byte bound,
             the chain floor (an id, then its row: two dependent reads at
             the probe's L2 and DRAM latencies) and torch's
             F.embedding_bag(mode="sum") over both sets in one call
             (which omits the mean's division).
 9. users    on the 20k graph: ranked buckets (16, 4) and (8, 8) with
             mixed scenarios, both walk backends identical and equal to
             the single-bucket flush oracle; submit_user users equal to
             per-cluster walks merged by merge_interest_topk, and
             recommend_multi_interest(rank=...) equal to those merged
             lanes ranked.
10. chaos    on the 20k retrieval replica with elastic resilience: one
             seeded ChaosConfig (latency spikes, traffic bursts) run twice
             must give identical results and budgets; a zero-fault
             schedule must equal the plain open-loop run bit for bit.

11. sharded the same full-width graph sliced on the card into 16 node-range
             shards (the serve_3b_sharded recipe's shard count), after the
             17.9 GB item table is freed; per-shard sizes, the sharded
             copy's GB, resident and peak memory, and the cuts (140M / 60M
             / 1.2B instead of 2B / 1B / 17B; 16 shards on one card).
12. sh-parity the 8 one- and two-pin requests through serve_batch on the
             sharded graph (FULL_WALK with bias_beta=0, LocalFabric(16),
             slack 32): no walker dropped, early stop fired, and ids,
             scores, steps_taken and n_high bit-identical to serve_batch on
             the replicated graph with the same keys.
13. recipe   pixie_walk_sharded with SHARDED_WALK (24 supersteps, 512
             walkers per shard, slack 2.0) for 8 requests: p50/max, drops
             and max occupancy; the batched engine's kernel path equals its
             plain path (counts, stats, drops, occupancy) and the entry
             point's top-k.
14. replica  PixieServer on the sharded graph: 24 requests (p50/max), then
             kill_shard(3, at_superstep=8) (killed > 0, results equal to
             serve_batch(shard_dead_at=...), overlap@k against the healthy
             run), then revive_shards() (equal to the healthy run), then
             one request under torch.profiler (the trace goes to
             chiprun_out/chip_smoke_sharded_trace.json); a seeded
             run_open_loop with two shard deaths replays identically
             twice.
15. hop      the walk_hop kernel (each lane's word read from the chunk's
             table by walker id) against its twin on the gathered words, on
             the exact routed buffers and table of superstep 8 of a recipe
             walk (both hops, 16 shards per launch) and on edge cases (all
             lanes gated off, degree-0 rows, each shard's last row, row_base
             > 0, board rows, garbage positions and walker ids on gated-off
             lanes); device ms a launch, twin ms, the byte bound (lanes once
             plus the distinct sectors the gated lanes need), the chain of
             2 dependent reads priced as the walk's is, and one launch at a
             time with a cold and a warm L2.  Then walk_bits against
             walk._chunk_rbits at the sharded replica's chunk (one request)
             and the parity batch's (8 requests), bit for bit, timed beside
             it.
16. nccl     ProcessGroupFabric over NCCL on one rank (a TCP store on
             localhost) equals LocalFabric(1) on the 20k graph, the
             recsys mega-table's lookup_sharded over it equals lookup, and
             the 4-way sharded walk's board counts equal the unsharded ones.

17. attn     after the Pixie state is freed: the decode-attention kernel
             against its twin (max abs difference <= 2e-6 on the float32
             output) at edge shapes: length 1, ragged lengths in one batch,
             a length that is not a multiple of the tile, dh 16, 20, 64 and
             128, groups 1, 3 and 8, float32 and bf16 caches, q in float32
             and in the cache's dtype.
18. lm_f32   Qwen2.5-3B at full width (36 layers, vocab 151,936, seeded
             init on the card) in float32 compute and cache: a seeded 4 x
             512 prompt, 32 greedy tokens through decode.generate on the
             kernel path and on the plain path (backend="xla"): tokens
             identical; then both decode paths side by side on the same
             tokens, the max logit difference per step.
19. lm_bf16  the same weights cast once to the config's own bf16 (the
             serving dtypes): generate on both paths (the share of tokens
             they agree on: bf16 rounding lets greedy paths part),
             prefill ms, decode ms per step (p50 of 32), tokens/s at batch
             4, decode-attention launches, one profiled step (device idle
             share; its sums from kineto's chrome trace held to
             key_averages()' op for op: summary_check), and the attention
             kernel on that step's layer-0
             inputs (the serving shape) beside SDPA and its bound.  Then the
             reference's decode_32k cell, cut: batch 16 instead of 128 (a
             bf16 cache of 128 x 32,768 tokens is 154.6 GB), the cache
             filled with seeded random bf16 values, one decode_step at
             position 32,767 timed (kernel path, plain path, one profiled);
             on that step's layer-0 inputs the kernel against its twin
             (<= 2e-6), its device ms beside the twin, torch's
             scaled_dot_product_attention(enable_gqa=True) and the byte
             bound.  Both timed attention calls log the kernel's split
             plan (splits, CTAs) and must give the same bits twice.
20. smollm   SmolLM-360M at full width in float32 (15 heads padded to 16):
             16 greedy tokens after a 4 x 128 prompt, kernel path == plain
             path, the per-step logit difference.

21. events  run after phase 5, while the full-width graph is resident: the
             reference's serve_200m_replicated cell as the reference serves
             it, in event mode (pixie_walk_events + recommend_from_events,
             FULL_WALK, 8 slots, count_boards off) on the 24 requests of
             phase 2: p50/max latency, the kernel path (walk_steps_fused)
             equal to the plain path bit for bit (both lanes, steps_taken,
             chunks_run, n_high, scores, ids); check_mode "incremental"
             equal to "full" at check_every 1, 2 and 4 on two requests;
             with early stopping off, equal to the dense engine's counts with
             every query pin masked, and to walk.recommend itself where no
             query pin was visited from another slot (the one place the two
             reference engines part); one request under torch.profiler
             (chiprun_out/chip_smoke_events_trace.json); peak memory.
22. wide     16 slots (the reference's PixieArchConfig.n_slots): 2.24e9
             packed (slot, pin) ids, which select_count_engine refuses for
             dense counting; 8 requests of up to 16 pins in event mode,
             kernel path == plain path.
23. legacy   ops.walk_step chained for 5 supersteps over 8192 walkers on the
             full-width graph (query pins of phase 2, seeded uint32 words),
             kernel == twin at every step; ops.visit_counts over one event
             request's pin lane (invalid events -1) into n_pins bins,
             kernel == twin, and per slot equal to events_to_counts' runs;
             both kernels at edge shapes (no events, negative and
             out-of-range ids, bin counts off the 32-multiple, dead-end pins
             and empty boards on each CSR's last row, high-bit words, alpha
             0 and 2**32 - 1, walker counts off the 256-multiple); their
             kernels-line rows (torch.bincount as visit_counter's library
             call); walk_step's row adds its chain floor (its 4 dependent
             CSR reads at the probe's L2-hit latency; 5 levels with the
             lane read, logged beside it) and single launches timed with a
             warm and an evicted L2.

24. prune   run after phase 23, before the ranker's table exists, so only
             the full-width graph, its two int8 language arrays and the
             topics are resident: seeded stand-in pin topics (140M x 16
             float32, 8.96 GB, softmax(z / 0.25) of normal draws from one
             torch.Generator on the card; the recipe is printed), then
             pruning.prune_graph with the reference's PruneConfig (10% of
             boards by entropy, delta 0.91, min_keep 2) and the languages:
             edges before, after entropy pruning and after degree pruning,
             boards dropped, bytes before and after, seconds, resident GB
             before and peak GB of the phase; the counts must hold
             together and no pin may keep more than its ceil(d**delta)
             target.  Then phase 2's 24 requests through PixieServer on the
             pruned graph: kernel path == plain path (ids, scores,
             steps_taken, n_high), walk_steps_fused and
             visit_counter_update_high launched, p50 beside phase 2's
             unpruned p50.  The topics and the pruned graph are freed.
25. fig4     on the 20k graph, bench_fig4_pruning.py's sweep (delta 1.0,
             0.95, 0.9, 0.8, 0.65; 10% of boards): the card's pruned CSR
             arrays and stats equal to the CPU's at every delta; edges,
             keep fraction and link-prediction F1 (20 held-out boards,
             walk.recommend on the kernel path) per delta; the boards whose
             entropy on the card differs from the CPU's (float64 log), and
             the degrees 0..10,000 where the card's pow would part from
             numpy's (the port uses numpy's table).
26. table1   bench_table1_hitrate.py's 40 queries on the 20k graph: hit
             rates at 10, 100 and 1000 of the textual, visual and combined
             content baselines and of Pixie (kernel path); each baseline's
             scores on the card against the CPU port's (cosine within 2e-6,
             Hamming and combined exact).  Quality is printed, not gated.
27. oracle   on small_test_graph, the kernel-path walk's normalized visits
             against core/reference.py's sequential oracle: total-variation
             distance under 0.15 unbiased (basic_random_walk_ref, oracle
             seed 3, walk key 0) and 0.2 biased (pixie_random_walk_ref,
             language 1, seed 5, key 1), the reference test's own bounds.

28. sasrec   right after phase 24 frees its topics and pruned graph, before
             the ranker's table (only the graph and its languages
             resident): SASRec at its published widths (configs/sasrec.py
             FULL: dim 50, 2 blocks, 1 head, seq_len 50) with n_items set to
             the graph's 140M pins (140,000,256 padded rows x 50 float32,
             28.0 GB, drawn on the card from a seeded generator; the one
             cut) ranks Pixie's candidates: phase 2's 24 requests, each with
             a seeded 50-pin history (left-padded with -1 by 0, 10, 25 or
             49), through pixie_then_rank(..., FULL_WALK,
             sasrec_ranker(...), TwoStageConfig()) on the kernel path and
             with backend="xla": final ids and scores bit-identical,
             walk_steps_fused and visit_counter_update_high launched; p50
             and max beside phase 2's p50, one request's split (walk, user
             state, candidate scores, top-k), resident GB before and peak
             GB of the phase.  The table is freed.
29. recsys   after the 20k graph's state is freed, before the LM phases,
             nothing else resident, one model at a time (each table freed
             before the next): SASRec FULL (10M items, 2.0 GB) user states
             at serve_p99 (512 seeded histories, padded rows among them)
             and score_candidates for one user over 1,000,000 distinct
             candidates, top 100 (equal to a direct recomputation of those
             candidates' dots within 2e-6, descending, none left out scoring
             higher); BST FULL (1.28 GB) bst_forward at serve_p99 and
             serve_bulk (262,144); dlrm-rm2 (187,767,808 rows x 64 bf16,
             24.0 GB) then dlrm-mlperf (x 128 bf16, 48.1 GB): forward at
             serve_p99 and serve_bulk (seeded dense features, ids uniform
             within each feature's rows), retrieval_score over 1,000,000
             candidates in chunks of 2**17 (top 100 checked as SASRec's),
             lookup_sharded over LocalFabric(4) == lookup.  Device ms a
             call and peak GB per model beside the card's name and power
             limit.  Then the four SMOKE configs on the card against the
             CPU port with the same parameters: user states, scores,
             logits and the three losses within 2e-6 (the maximum
             printed), top-k ids exact.  Every float32 comparison first
             asserts float32 matmul precision "highest" and no TF32.
30. moe_granite  after phase 20, nothing else resident:
             granite_moe_3b_a800m.FULL at full width and depth (40 experts
             padded to 48, top 8, 24 heads padded to 32, 49,155 tokens
             padded to 49,168), seeded weights on the card, a 4 x 512
             prompt.  The peak is reckoned from the config first
             (weights, two KV caches, one MoE layer's prefill transients);
             the float32 run cuts its depth only if that passes 76 GB.
             float32: 32 greedy and 32 sampled tokens (temperature 0.7, a
             seeded key) through decode.generate on the kernel path and
             with backend="xla", identical, and the largest logit
             difference of each lockstep step; the card's gumbel noise of
             one step (4 x 49,168) equal to the CPU port's bit for bit.
             bf16 (weights drawn cast, one layer's slice at a time):
             prefill ms, decode ms a step (p50 of 32), tokens/s, one
             profiled step (device idle share), decode-attention launches,
             the tokens the two paths agree on, and the attention kernel
             at layer 0 of the last step beside SDPA and its byte bound.
31. moe_deepseek  the same for deepseek_moe_16b.FULL (64 experts top 6,
             2 shared, dense layer 0 with d_ff 10,944, MHA: the kernel's
             group 1).
32. gin      gin_tu.FULL on cora_like() (full_graph_sm: 2,708 nodes,
             10,556 edges, 1,433 features, 7 classes), on a FanoutSampler
             block of reddit_like() (minibatch_lg: the full 232,965-node,
             ~115M-edge graph built on the host, 1,024 seeds, fanout 15 /
             10, 602 features, 41 classes) and on a 128-graph molecule
             batch (sum readout): logits and loss on the card against the
             CPU port on the same parameters within 2e-6 times max(1, the
             largest magnitude), two card calls the same bits, ms a
             forward.  Phases 30-31's bf16 step also names the MoE
             router's keying pass (counter.order_keys, topk_total's pass
             beyond topk_dense): the step profiled again with each call
             under a record_function range, its calls, its kernels'
             device time and their share of the step's device-busy time.

33. lm_train after phase 32, nothing else resident: SmolLM-360M FULL at
             full width and depth (32 layers, d 960, 15 heads padded to 16,
             5 KV heads, ff 2560, vocab 49,152; bf16 compute, float32
             parameters, remat on, loss_chunk 1024) trained through
             train_loop.make_train_step(transformer.loss_fn, n_micro=4,
             AdamWConfig()) at the reference's train_4k shape (seq_len
             4096), batches from TokenPipeline(49152, batch, 4096, 0).  The
             one cut, global batch 256: the largest multiple of 4 (at
             least 8) whose peak, reckoned from the config first
             (train_reckon_gb), stays under 70 GB is 112, and a step costs
             ~0.8 s a sequence, so the batch is cut on to 8
             (TRAIN_TIME_BATCH) for the time limit.  4 steps uninterrupted
             (loss, grad_norm and lr finite at every step, step 4's loss
             below step 1's), the state copied to the host; then
             run_resilient over the same steps from the same seed with a
             checkpoint every 2 steps under a temporary directory and one
             injected failure at step 3: one restore, and the final
             parameters and optimizer state equal to the uninterrupted
             run's bit for bit (cut from 8 steps, checkpoints every 4 and a
             failure at step 6, to pay for phase 38).  Printed: the
             reckoned and measured peak, step ms (p50 of steps 2-4),
             tokens/s, seconds to save and to
             restore one checkpoint (restored bits checked), one profiled
             step's device busy and idle share (the profiler's own cost
             inflates that step's wall time: its busy time is also given
             as a share of the unprofiled p50 step), and the step's reckoned
             FLOPs (6 N a token plus attention) as a share of the bf16
             dense peak.
34. gin_train gin_tu FULL at full_graph_sm (cora_like) and at molecule (128
             graphs of 30 nodes): 20 make_train_step steps with
             AdamWConfig() each, twice from one seed: the same bits, the
             loss falling, ms a step.
35. dist     after phase 34, nothing else resident: the distribution layer
             (launch/mesh.py, distribution/sharding.py).  Expert-parallel
             MoE decode through decode.generate(mesh=) on a local
             ("data", "model") mesh of (1, 4), the padded experts a
             leading model-shard dim on the card (granite 12 a shard):
             granite_moe_3b_a800m.FULL in float32, 32 greedy tokens equal
             to phase 30's unsharded ones and the largest logit difference
             of each step of a lockstep run (EP beside unsharded); then in
             bf16, decode ms a step (p50 of 64, in turns unsharded, EP, EP,
             unsharded) beside the unsharded p50, the EP generate's
             decode-attention launches; then deepseek_moe_16b.FULL the same
             in bf16 when its reckoned peak (moe_reckon_gb) stays under
             76 GB.  compressed_psum over a local data axis of 4 on
             SmolLM-360M's gradient tree (365,753,280 seeded floats a
             shard, 5.85 GB in all): ms a call (p50 of 3) beside its byte
             bound, every leaf within one quantisation step of the float64
             mean, final_norm and blocks/wk equal to the CPU port's bit for
             bit.  train_loop.jit_train_step over an NCCL process group of
             one rank (a TCP store on localhost), LM_TRAIN_RULES with
             ZeRO-1, SmolLM-360M FULL at phase 33's shape and seed, 2 steps,
             both ways: the gathered step (the state DTensors, every
             parameter gathered whole, transformer.loss_fn(mesh=)) and the
             tensor-parallel one (tp=, the loss transformer.loss_fn(tp=),
             the state the rank's blocks); each one's parameters and
             optimizer state equal phase 33's after its first 2 one-device
             steps bit for bit, and each one's step seconds are printed.  The phase's seconds.
36. launch   after phase 35, nothing resident: the launch layer
             (configs/registry.py, launch/cells.py, dryrun.py,
             hlo_analysis.py).  (a) and (b) are host processes (fake
             tensors, no card) started when the phase starts, after every
             phase that times the host, so no time printed before them
             shares the host with them.  (a) python -m
             repro_torch.launch.dryrun --all --mesh single --subprocess
             --jobs 7 (seven worker processes sharing the cells, the
             longest first): every one of the 42 production cells
             (11 archs of the registry, their shape cells, the (16, 16)
             mesh) traced as rank 0's program on fake tensors over a fake
             process group of 256 ranks, all "ok", one line a cell (GB a
             rank beside the card's 80, FLOPs by dtype, bytes, collective
             bytes by kind and axis, the three roofline terms, the dominant
             one, seconds; reckoned on H100 SXM5 data-sheet constants,
             never measured), then the cells ok out of 42 and those over
             80 GB a rank (a finding, not a failure); no real kernel
             launches while it runs.  (b) the dry run on a one-rank mesh at
             the shapes the card ran: phase 33's lm_train (SmolLM-360M,
             seq 4096, its global batch, 4 microbatches), whose reckoned
             peak must lie within 25% of phase 33's measured
             max_memory_allocated (printed beside it and beside
             train_reckon_gb), its counted FLOPs beside the 6 N plus
             attention reckoning; and qwen2.5-3b decode_32k at phase 19b's
             batch of 16 beside that phase's measured peak.  (c) while (a)
             and (b) run, two cells built by launch/cells.py on a one-rank
             NCCL mesh with real tensors: pixie serve_200m_replicated (the
             FULL walk, its shape params set to phase 4's 20k-pin graph,
             one 5-pin query of 8 slots) and qwen2.5-3b decode_32k at
             batch 4 (seeded bf16 weights and cache, position 32,767),
             each equal to the direct module calls (walk.pixie_walk_events
             + recommend_from_events; transformer.decode_step) bit for bit
             (the decode cell is the tensor-parallel program of phase 37 on
             one rank: its attention the partial kernel over the whole
             cache, its merge over one block exact).  (c) prints no time.
             The phase's seconds.
37. tp_serve after phase 36, nothing resident: tensor-parallel LM serving
             (sharding.TensorParallel; transformer.prefill / decode_step
             with tp=).  (a) decode_attention_partial at decode_32k's shape
             cut into 4 kv_seq blocks (batch 16, 32,768 positions, 16 / 2
             heads of 128, bf16 cache, q bf16 and float32), lengths 1,
             8,192, 8,193, 32,768 and per row (blocks wholly past the
             length launch and give the empty sentinel): o within 2e-6 of
             the twin, m and l within 2e-6 times max(1, |value|), the 4
             blocks merged (merge_partials) within 2e-6 of the whole-cache
             kernel; one block's call timed (device ms, the twin's, one
             aten._scaled_dot_product_efficient_attention call returning
             (o, lse) with the kv heads expanded, the byte bound).  (b)
             qwen2_5_3b.FULL in float32 through a local ("data", "model")
             mesh of (1, 4): a 128-token prompt at batch 4 prefilled with
             the heads, FFN and vocabulary on 'model' (LM_TRAIN_RULES),
             then 16 greedy decode steps under the decode cell's serve
             rules (heads whole, kv_seq on 'model'), in lockstep with the
             unsharded path fed the same tokens: every token equal, the
             largest logit difference of each step printed, and each
             layer's gap (largest |output difference| over max(1, largest
             |output|)) of every pass: every gap within 1e-4 and every
             logit difference within 1e-4; the local blocks are views of
             the one tree.  (c) deepseek_moe_16b.FULL the same way in
             float32 (phase 31's moe_f32_config: full depth when the
             reckoned peak fits 76 GB), every token equal, and each layer's
             routing beside the gaps: up to the run's first routing flip
             every gap within 1e-4 and that flip a near-tie (the unsharded
             k-th less (k+1)-th router probability within 1e-5), then again
             with the unsharded path's routing imposed on the
             tensor-parallel path layer by layer, held as qwen is (no
             flip: gaps and logits within 1e-4); then in bf16: token
             agreement, the largest logit difference of each step, peak GB
             beside the tree's (each peak must stay under 1.5 trees).  (d)
             phase 36's dry-run records of the 15 LM serve cells:
             deepseek-moe-16b prefill_32k, decode_32k and long_500k each
             under 80 GB a rank; every decode cell's all-gather bytes
             exactly its step's (o, m, l), router and logit gathers (no
             parameter leaf or cache layer) and its collective term below
             its memory term.  (e) qwen2.5-3b and deepseek-moe-16b FULL in
             bf16 at batch 4 after a 512-token prompt: the unsharded
             decode step against the tensor-parallel program on a
             one-shard (1, 1) mesh, the same logits bit for bit, the p50 of
             32 steps a turn (turns unsharded, one-shard, one-shard,
             unsharded) and one profiled step of each.  The phase's
             seconds.
38. tp_train after phase 37, nothing resident: tensor-parallel LM training
             (transformer.loss_fn(tp=) under train_loop.jit_train_step(tp=)
             on a local ("data", "model") mesh of (1, 4), LM_TRAIN_RULES
             with ZeRO-1, the state in TensorParallel.local_form's
             stacked-shard form).  (a) smollm_360m.FULL at full width and
             depth in float32 (15 heads padded to 16, 4 a shard; the 5 KV
             heads whole; ff 2560 -> 640 and the tied vocabulary 49,152 ->
             12,288 a shard), batch 4 x seq 1024 (cut from train_4k's 256 x
             4096) in 2 microbatches from phase 33's seeds: the first
             step's loss within 1e-5 relative and every leaf's gradient
             within 1e-4 times its own largest |gradient| of the one
             device's (microbatch.accumulated_grads; each leaf's largest
             difference, largest |gradient| and their ratio printed), then
             2 make_train_step steps beside 2
             tensor-parallel steps, each step's loss within 1e-5 relative.
             (b) deepseek_moe_16b.FULL at full width in float32 with
             ep_shard_map, its depth cut to the deepest of dense0 plus 1-3
             MoE layers whose float32 state, reckoned at 16 bytes a
             parameter, stays under 60 GB (dense0 + 3), the first step held
             as (a) with each FFN call's gap and routing beside it (phase
             37's LayerTrace, forward and remat recompute): up to the first
             routing flip every gap within 1e-4 and that flip a near-tie
             (margin within 1e-5), then again with the unsharded expert
             selection imposed, held as (a).  (c) smollm_360m.FULL in bf16
             at batch 4 x seq 4096, 2 microbatches: the one-device step and
             the (1, 4) step, 3 each in turns (no warm-up), their
             p50 ms, tokens/s and peak GB over what was resident; one
             tensor-parallel step profiled on the device only (device
             operations, busy ms, idle share).  (d) is phase 35c.  (e) phase 36's dry-run records
             of the five LM train_4k cells, now the tensor-parallel
             program: each under 80 GB a rank and under PR 28's figure,
             its all-gathers over 'model' only the MoE router's logits
             (none in a dense model: no parameter leaf), its three terms
             beside PR 28's.  The phase's seconds.
39. global_route after phase 38, nothing resident: MoE routing over the
             global batch across data ranks (moe.moe_ffn_global, the
             reference's GSPMD moe_ffn without ep_shard_map), on
             deepseek_moe_16b.FULL at full width in float32 without
             ep_shard_map, its depth cut as 38b's (dense0 + 3 MoE
             layers).  (a) One microbatch of 4 x 256 tokens (drawn from
             256 ids: skewed, so that the cut binds) through
             transformer.forward and loss_fn with mesh= a local
             ("data", "model") mesh of (2, 1) and of (4, 1) (the data
             blocks one after another over a LocalFabric), held to the
             one device's forward / loss_fn of the whole batch: hidden
             states within 2e-6 times max(1, |one device's|), the loss
             within 1e-6 relative, every leaf's gradient within 1e-4 of its
             own largest |gradient| (each leaf's printed in the
             global_route_grads lines).  (b) decode.generate on a
             128-token prompt at batch 4 with the (2, 1) mesh: the prefill
             and 8 greedy decode steps (decode_attention launched, the
             phase's counts) give the one device's tokens.  (c) The
             witness line: each MoE layer's assignments kept by the
             global cut and by per-rank cuts of 2 and 4 blocks
             (moe.kept_assignments), the experts past the global
             capacity; the cuts must keep different sets.  (d) Two gloo
             processes on the card, started with the phase, probe an
             all-reduce and an all-gather of CUDA tensors; where the
             installation runs them, once the parent has freed the card,
             each runs forward and loss_fn with mesh= a (2, 1)
             process-group mesh on its rows and holds them to the one
             device's whole batch (hidden rows, the ranks' summed loss,
             the gradients of the routers and norms summed over the
             ranks); where it does not, the line says so and nothing
             stands in for it.  The phase's seconds and peak GB beside the
             card's name and power limit.

Launch counts are reset just before and read just after each path that
is driven (phases 2, 4, 4b and its sharded batch, 5c, 6, 7, 9, 10, 12,
13, 14, 18, 19 and 19b, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, whose
models launch no hand kernel, 30 and 31, 33-34, whose training path
reaches none, 35's expert-parallel decode paths, 36's two real cells:
walk_steps_fused from the replicated Pixie cell, decode_attention_partial
from the decode cell (the dry run launches nothing), 37's
tensor-parallel steps, each reset and read around the step, 38's
training, which reaches none, and 39's split prefill and decode); the kernels
line sums them, and every one of its eleven kernels (the eight TPU kernels',
decode_attention's partial form, walk_bits and topk_select) must have
launched.  The build
fails on a register spill of the walk, hop, word-table, bag or counter
kernels (ptxas -v).  The profiled
dense, event-mode and sharded requests (phases 2, 21, 14) must draw no
torch threefry words (no prng.bits call); a "request_ops" line gives
their device operations and chunks beside the card's operations of one
torch word table (walk._chunk_rbits), which a parent commit's request
drew once a chunk.

Prints one ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
non-zero without a result when no CUDA device is visible or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# 32-bit integer ALU operations a second: the data sheet's 67 TFLOP/s
# float32 rate over 4 (an H100 SM has half as many INT32 lanes as FP32
# lanes, and the float32 rate counts an FMA as two operations)
INT32_OPS_PER_S = 67e12 / 4
# one threefry2x32 block: 20 rounds of add, rotate and xor, 10 key
# injections, 2 initial key adds; a word adds its y0 ^ y1
THREEFRY_OPS = 72
SECTOR = 32                        # bytes per DRAM sector touched at random
CHASE_INTS = 2**28                 # the latency probe's cycle: 1 GiB of int32
CHASE_L2_INTS = 2**22              # and one that L2 holds: 16 MiB
CHASE_READS = 100_000
REQUEST_PINS = (8, 3, 1, 5, 8, 2) * 4  # pins per full-width request
OPEN_LOOP_REQUESTS = 200
# card measurements a later phase sets its reckonings beside
MEASURED: dict = {}


_T0 = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line; ``at_s`` is the script's seconds so far."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - _T0}), flush=True)


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` back-to-back calls, timed
    with CUDA events after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int, sleep_cycles: int = 10**8) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` calls run back to
    back: the card is held in ``torch.cuda._sleep`` while the host enqueues
    every call, so the Python wrapper's launch cost leaves no gaps between
    kernels.  Retries with a longer sleep if the card caught up with the
    host (then the span would hold host gaps).  ``fn`` must not
    synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        caught_up = start.query()
        end.synchronize()
        if not caught_up:
            return start.elapsed_time(end) / n
        sleep_cycles *= 4
    raise RuntimeError("the host could not keep ahead of the card")


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


# ---------------------------------------------------------------------------
# Phase 2: the full-width graph and requests
# ---------------------------------------------------------------------------


def full_width_graph(shape, dev):
    """Uniform random edges with 4 edge languages, drawn on the card:
    ``(graph, (pin_lang, board_lang))``, the languages int8 (pruning sorts
    the pruned graph's edges by them)."""
    import torch
    from repro_torch.core.graph import build_graph

    gen = torch.Generator(device=dev).manual_seed(SEED)
    randint = lambda hi, n, dt: torch.randint(
        0, hi, (n,), generator=gen, dtype=dt, device=dev
    )
    pins = randint(shape.n_pins, shape.n_edges, torch.int32)
    boards = randint(shape.n_boards, shape.n_edges, torch.int32)
    pin_lang = randint(4, shape.n_pins, torch.int8)
    board_lang = randint(4, shape.n_boards, torch.int8)
    p2b_feat = torch.index_select(board_lang, 0, boards)
    b2p_feat = torch.index_select(pin_lang, 0, pins)
    graph = build_graph(
        pins, boards, shape.n_pins, shape.n_boards,
        edge_feat=p2b_feat, n_feats=4, edge_feat_b2p=b2p_feat,
    )
    del pins, boards, p2b_feat, b2p_feat
    torch.cuda.empty_cache()
    return graph, (pin_lang, board_lang)


def full_width_requests(graph, n_slots: int):
    """(pins, weights, feat) per request: random pins with edges."""
    import torch

    rng = np.random.default_rng(SEED)
    cand = torch.from_numpy(
        rng.integers(0, graph.n_pins, 256).astype(np.int32)
    ).to(graph.device)
    cand = cand[graph.pin_degree(cand) > 0].cpu().numpy()
    reqs, at = [], 0
    for k in REQUEST_PINS:
        k = min(k, n_slots)
        pins = [int(p) for p in cand[at:at + k]]
        at += k
        weights = [float(w) for w in rng.uniform(0.1, 1.0, k).astype(np.float32)]
        reqs.append((pins, weights, int(rng.integers(0, 4))))
    return reqs


def padded_batch(reqs, n_slots, dev):
    import torch

    pins = np.full((len(reqs), n_slots), -1, np.int32)
    weights = np.zeros((len(reqs), n_slots), np.float32)
    feats = np.zeros((len(reqs),), np.int32)
    for i, (p, w, f) in enumerate(reqs):
        pins[i, :len(p)] = p
        weights[i, :len(w)] = w
        feats[i] = f
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(pins), t(weights), t(feats)


def serve_with_stats(graph, reqs, req_ids, n_slots, cfg, backend):
    """serve_batch(with_stats=True) per request under the server's keys."""
    from repro_torch.core import prng, service

    server_key = prng.key(SEED, graph.device)
    out = []
    for rid, req in zip(req_ids, reqs):
        pins, weights, feats = padded_batch([req], n_slots, graph.device)
        keys = prng.fold_in(server_key, rid)[None, :]
        out.append(service.serve_batch(
            graph, pins, weights, feats, keys, cfg, backend=backend,
            with_stats=True,
        ))
    return out


def assert_same(a, b, what: str) -> None:
    import torch

    for name, x, y in zip(("scores", "ids", "steps_taken", "n_high"), a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs between kernel and plain paths")


def check_result(scores, ids, k: int, n_pins: int, what: str) -> None:
    import torch

    if scores.shape[-1] != k or ids.shape[-1] != k:
        raise AssertionError(f"{what}: expected top {k}, got {tuple(scores.shape)}")
    if not bool(torch.isfinite(torch.as_tensor(scores)).all()):
        raise AssertionError(f"{what}: non-finite scores")
    ids = torch.as_tensor(ids)
    if int(ids.min()) < 0 or int(ids.max()) >= n_pins:
        raise AssertionError(f"{what}: ids outside [0, {n_pins})")
    if float(torch.as_tensor(scores).max()) <= 0:
        raise AssertionError(f"{what}: the walk visited nothing")


def profile_request(server, req, req_id: int, top: int = 14,
                    trace: str = "chip_smoke_trace.json") -> dict:
    """One full-width request through ``server`` under torch.profiler
    (``profile_call``): its device operations and launches by kernel."""
    def serve():
        server.submit(*req[:2], user_feat=req[2], req_id=req_id)
        server.pump()
        server.harvest()

    return profiled_ops(serve, trace, top)


def profiled_ops(fn, trace: str, top: int = 14) -> dict:
    """``profile_call`` with the port's launch counts of the same call and
    the number of torch threefry word draws (``prng.bits`` calls) in it,
    which the kernel path must not make."""
    from repro_torch.core import prng
    from repro_torch.kernels import _build

    real_bits, draws = prng.bits, []

    def counted_bits(*a, **kw):
        draws.append(1)
        return real_bits(*a, **kw)

    _build.reset_launches()
    prng.bits = counted_bits
    try:
        n_ops = profile_call(fn, top, trace)
    finally:
        prng.bits = real_bits
    return dict(ops=n_ops, launches=dict(_build.launches),
                torch_threefry_draws=len(draws))


def profile_call(fn, top: int = 14, trace: str = "chip_smoke_trace.json") -> int:
    """``fn()`` under torch.profiler: the device's busy and idle share of
    its wall time, and where the device time goes by kernel.  The trace
    goes to chiprun_out/<trace>; returns the number of device operations
    (kernels and copies) the call ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    n_ops = sum(e.count for e in kernels)
    log("profile", trace=trace, wall_ms=wall, device_busy_ms=busy,
        device_idle_share=max(0.0, 1 - busy / wall) if wall else None,
        kernel_launches=n_ops,
        top=[dict(kernel=e.key[:90], count=e.count,
                  ms=e.self_device_time_total / 1e3) for e in kernels[:top]])
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / trace))
    return n_ops


# ---------------------------------------------------------------------------
# Phase 5: kernels against their twins
# ---------------------------------------------------------------------------


def walk_inputs(graph, reqs, n_slots, cfg):
    """The main path's first-chunk walk inputs for a padded batch."""
    import torch
    from repro_torch.core import prng, walk

    dev = graph.device
    pins, weights, feats = padded_batch(reqs, n_slots, dev)
    plan = walk._plan(graph, pins, weights, cfg, None)
    n_queries = len(reqs)
    w = cfg.n_walkers
    keys = prng.fold_in(prng.key(SEED, dev), torch.arange(n_queries, device=dev))
    p2b_fb, b2p_fb = walk._validated_bias_bounds(graph, cfg)
    return dict(
        curr=plan.query_of_walker.reshape(-1).contiguous(),
        query=plan.query_of_walker.reshape(-1).contiguous(),
        feat=feats.repeat_interleave(w),
        slot=plan.slot_of_walker.reshape(-1).contiguous(),
        qid=torch.arange(n_queries, dtype=torch.int32, device=dev).repeat_interleave(w),
        keys=walk._key_bits(keys, dev),
        steps=dict(step_base=0, chunk_steps=cfg.chunk_steps),
        # the twin's words (and the sector replay's): the same keys' table
        rbits=walk._chunk_rbits(keys, 0, cfg.chunk_steps, w),
        csr=(graph.p2b.offsets, graph.p2b.targets, graph.b2p.offsets,
             graph.b2p.targets, p2b_fb, b2p_fb),
        kw=dict(n_pins=graph.n_pins, n_slots=n_slots, n_queries=n_queries,
                n_boards=graph.n_boards, alpha_u32=walk._prob_u32(cfg.alpha),
                beta_u32=walk._prob_u32(cfg.bias_beta),
                count_boards=cfg.count_boards),
    )


def walk_sectors(inp, pin_events):
    """The 32-byte sectors of the CSR and feature-bound arrays that this
    chunk's walk reads: the kernel's reads replayed step by step in plain
    PyTorch (sectors counted from each array's start), the query pin's row
    read once up front as the kernel reads it.  The replay's pin lane must
    equal the kernel's, so the address model is the kernel's own.

    Returns ``(distinct sectors, reads)``: ``reads`` is ``(round, walker,
    sector)`` for every read, round ``4 * s + k`` for hop ``k`` of step
    ``s`` (offset pair with its feature bounds, target, the board's offset
    pair with its feature bounds, target), for ``read_chain``."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels.walk_step import RMASK

    p2b_off, p2b_tgt, b2p_off, b2p_tgt, p2b_fb, b2p_fb = inp["csr"]
    kw = inp["kw"]
    biased = p2b_fb is not None and kw["beta_u32"] > 0
    rb = prng.from_int32_bits(inp["rbits"])
    feat, query = inp["feat"].long(), inp["query"].long()
    cur = inp["curr"].long()
    walker = torch.arange(cur.numel(), device=cur.device)
    touched, rounds, walkers = [], [], []

    def touch(array_id, idx, mask, rnd):
        touched.append((idx[mask] >> 3) | (array_id << 40))
        walkers.append(walker[mask])
        rounds.append(torch.full_like(walkers[-1], rnd))

    def pick(start, deg, r, use_b, fb, rows, mask, read, array_id, rnd):
        base, span = start, deg.clamp(min=1)
        if biased:
            m = use_b & mask
            at = rows * fb.shape[1] + feat
            touch(array_id, at, read, rnd)
            touch(array_id, at + 1, read, rnd)
            flat = fb.reshape(-1)
            lo, hi = flat[at].long(), flat[at + 1].long()
            sub = m & (hi > lo)
            base = torch.where(sub, start + lo, base)
            span = torch.where(sub, hi - lo, span)
        return torch.where(mask, base + r % span, 0)

    every = torch.ones_like(query, dtype=torch.bool)
    touch(0, query, every, 0)
    touch(0, query + 1, every, 0)
    if biased:
        touch(1, query * p2b_fb.shape[1] + feat, every, 0)
        touch(1, query * p2b_fb.shape[1] + feat + 1, every, 0)
    pins = []
    for s in range(rb.shape[0]):
        use_b = rb[s, :, 1] < kw["beta_u32"]
        pos = torch.where(rb[s, :, 0] < kw["alpha_u32"], query, cur)
        away = pos != query                 # else the row is in registers
        touch(0, pos, away, 4 * s)
        touch(0, pos + 1, away, 4 * s)
        start = p2b_off[pos].long()
        deg = p2b_off[pos + 1].long() - start
        ok1 = deg > 0
        eidx = pick(start, deg, rb[s, :, 2] & RMASK, use_b, p2b_fb, pos, ok1,
                    use_b & away, 1, 4 * s)
        touch(2, eidx, ok1, 4 * s + 1)
        board = torch.where(ok1, p2b_tgt[eidx].long() - kw["n_pins"], 0)
        touch(3, board, ok1, 4 * s + 2)
        touch(3, board + 1, ok1, 4 * s + 2)
        bstart = b2p_off[board].long()
        bdeg = b2p_off[board + 1].long() - bstart
        ok = ok1 & (bdeg > 0)
        bidx = pick(bstart, bdeg, rb[s, :, 3] & RMASK, use_b, b2p_fb, board,
                    ok, use_b & ok1, 4, 4 * s + 2)
        touch(5, bidx, ok, 4 * s + 3)
        pin = b2p_tgt[bidx].long()
        cur = torch.where(ok, pin, query)
        pins.append(torch.where(ok, pin, 0))
    if not torch.equal(torch.stack(pins).int(), pin_events):
        raise AssertionError("walk sector replay disagrees with the kernel's pin lane")
    sectors = torch.cat(touched)
    reads = (torch.cat(rounds), torch.cat(walkers), sectors)
    return int(torch.unique(sectors).numel()), reads


def read_chain(reads, n_lanes: int, lat: dict) -> dict:
    """Each lane's chain of dependent reads, priced two ways.

    ``reads`` is ``(round, lane, sector)`` for every read; a lane's reads
    in one round are issued together, each round waits for the one before.
    ``chain_floor_ms``: the longest chain with every read at the L2-hit
    latency (the least it can take, L1 hits aside; also what a rerun of the
    same chunk pays once its lines sit in L2).  ``chain_dram_ms``: every
    read at the DRAM latency.  ``chain_cold_ms``: a first-touch model of a
    chunk that starts with a cold L2 -- a read misses when it is among the
    first round to touch its sector, hits L2 after -- priced per lane,
    the longest lane taken; ``l2_hit_share`` is its share of reads that
    hit.  The model takes the chunk's lines to fit in the 50 MB L2
    (``footprint_mib``, 128-byte lines) and ignores what an earlier chunk
    left there."""
    import torch

    rnd, lane, sec = reads
    if sec.numel() == 0:
        return dict(chain_reads=0, chain_floor_ms=0.0, chain_dram_ms=0.0,
                    chain_cold_ms=0.0, l2_hit_share=0.0, reads=0,
                    footprint_mib=0.0)
    uniq, inv = torch.unique(sec, return_inverse=True)
    first = torch.full((uniq.numel(),), 2**62, dtype=torch.int64,
                       device=sec.device).scatter_reduce(0, inv, rnd, "amin")
    miss = (rnd == first[inv]).long()
    n_rounds = int(rnd.max()) + 1
    cell = rnd * n_lanes + lane
    read = torch.zeros(n_rounds * n_lanes, dtype=torch.long, device=sec.device)
    read[cell] = 1
    missed = torch.zeros_like(read).scatter_reduce(0, cell, miss, "amax")
    per_lane_reads = read.view(n_rounds, n_lanes).sum(0)
    per_lane_misses = missed.view(n_rounds, n_lanes).sum(0)
    cold_ns = (per_lane_misses * lat["dram_ns"]
               + (per_lane_reads - per_lane_misses) * lat["l2_ns"])
    longest = int(per_lane_reads.max())
    n_reads = int(read.sum())
    return dict(
        chain_reads=longest,
        chain_floor_ms=longest * lat["l2_ns"] * 1e-6,
        chain_dram_ms=longest * lat["dram_ns"] * 1e-6,
        chain_cold_ms=float(cold_ns.max()) * 1e-6,
        l2_hit_share=1 - int(missed.sum()) / max(n_reads, 1),
        reads=n_reads,
        footprint_mib=torch.unique(sec >> 2).numel() * 128 / 2**20,
    )


def cold_l2_ms(fn, dev, n: int = 20) -> dict:
    """Mean device ms of single ``fn()`` launches timed one at a time with
    CUDA events, after a 256 MiB write that evicts the 50 MB L2
    (``cold_ms``) and with no write between (``warm_ms``): the same timing
    both ways, so their ratio is the L2's doing.  The card sleeps before
    each launch so the host is ahead and no enqueue gap is timed.  ``fn``
    must not synchronise."""
    import torch

    flush = torch.empty(2**26, dtype=torch.int32, device=dev)
    out = {}
    for name, evict in (("warm_ms", False), ("cold_ms", True)):
        fn()
        torch.cuda.synchronize()
        pairs = []
        for i in range(n):
            torch.cuda._sleep(10**6)
            if evict:
                flush.fill_(i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        out[name] = sum(a.elapsed_time(b) for a, b in pairs) / n
    del flush
    return out


def walk_ops(n_keys: int, walkers: int, chunk_steps: int) -> int:
    """32-bit integer operations of one chunk's threefry words: a step key
    per key and step, four words per walker and step."""
    return chunk_steps * (n_keys * THREEFRY_OPS
                          + 4 * walkers * (THREEFRY_OPS + 1))


def run_walk_kernel(inp):
    """``walk_steps_fused`` on ``inp``."""
    from repro_torch.kernels import walk_step as ws

    return ws.walk_steps_fused(
        inp["curr"], inp["query"], inp["feat"], inp["slot"], inp["keys"],
        *inp["csr"], inp["qid"], **inp["steps"], **inp["kw"])


def check_walk_kernel(inp, lat: dict):
    """The walk kernel (words drawn from the keys) against its twin on the
    table of the same keys; timed beside the plain version (the table drawn
    in torch, then the twin) and the card's time for that table
    (``_chunk_rbits``) alone, and one launch at a time with a warm and a
    cold L2 beside its chain of dependent reads (``read_chain``)."""
    from repro_torch.core import walk
    from repro_torch.kernels import walk_step as ws

    a = (inp["curr"], inp["query"], inp["feat"], inp["slot"])
    c, w = inp["rbits"].shape[0], inp["rbits"].shape[1]
    n_keys = inp["keys"].shape[0]
    table = lambda: walk._chunk_rbits(inp["keys"], 0, c, w // n_keys)
    plain = lambda: ws.walk_chunk_batched_plain(*a, inp["qid"], table(), *inp["csr"], **inp["kw"])
    got, want = run_walk_kernel(inp), plain()
    err = 0
    for x, y in zip(got, want):
        if (x is None) != (y is None):
            raise AssertionError("walk_steps_fused: lanes differ in presence")
        if x is not None:
            err = max(err, int((x.long() - y.long()).abs().max()))
    if err:
        raise AssertionError(f"walk_steps_fused differs from its twin: max err {err}")
    ms = device_ms(lambda: run_walk_kernel(inp), 50)
    call_ms = cuda_ms(lambda: run_walk_kernel(inp), 50)
    plain_ms = cuda_ms(plain, 5)
    rbits_ms = cuda_ms(table, 20)
    # bound: the distinct CSR and feature-bound sectors this chunk reads,
    # plus the keys and walker state read once and the lanes and next pins
    # written once; against the threefry words' integer operations
    _, _, sev, pev, _ = got
    n_ok = int((sev != inp["kw"]["n_slots"]).sum())
    sectors, reads = walk_sectors(inp, pev)
    chain = read_chain(reads, w, lat)
    lanes = 3 + (1 if inp["kw"]["count_boards"] else 0)
    nbytes = SECTOR * sectors + 8 * n_keys + 4 * lanes * c * w + 4 * 6 * w
    n_ops = walk_ops(n_keys, w, c)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    single = cold_l2_ms(lambda: run_walk_kernel(inp), inp["curr"].device)
    log("kernel", name="walk_steps_fused", device_ms=ms, call_ms=call_ms,
        walkers=w, chunk_steps=c,
        valid_events=n_ok, distinct_sectors=sectors, bound_bytes=nbytes,
        bound_int32_ops=n_ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
        **chain, **single,
        chunk_rbits_ms=rbits_ms, plain_is="walk._chunk_rbits, then the twin")
    return dict(
        name="walk_steps_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/walk_steps_fused.cu",
        replaces="src/repro/kernels/walk_step.py:519",
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, chain_floor_ms=chain["chain_floor_ms"],
        chunk_rbits_ms=rbits_ms,
    ), got


def check_bits_kernel(keys, chunk_steps: int, w: int, what: str):
    """``walk_bits`` against ``walk._chunk_rbits`` bit for bit, then timed
    beside it; ``keys`` as int32 bit patterns."""
    import torch
    from repro_torch.core import walk
    from repro_torch.kernels import walk_step as ws

    got = ws.walk_bits(keys, 0, chunk_steps, w)
    want = walk._chunk_rbits(keys, 0, chunk_steps, w)
    if not torch.equal(got, want):
        raise AssertionError(f"walk_bits {what}: differs from _chunk_rbits")
    n_keys = 1 if keys.dim() == 1 else keys.shape[0]
    ms = device_ms(lambda: ws.walk_bits(keys, 0, chunk_steps, w), 50)
    plain_ms = cuda_ms(lambda: walk._chunk_rbits(keys, 0, chunk_steps, w), 20)
    nbytes = 8 * n_keys + got.numel() * 4
    n_ops = walk_ops(n_keys, n_keys * w, chunk_steps)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    log("bits", what=what, shape=list(got.shape), identical=True, device_ms=ms,
        plain_ms=plain_ms, bound_bytes=nbytes, bound_int32_ops=n_ops,
        bytes_ms=bytes_ms, ops_ms=ops_ms)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def chase_latency(dev) -> dict:
    """Nanoseconds of one dependent read: one thread follows a seeded
    random cycle through ``CHASE_INTS`` int32 (1 GiB, far past the 50 MB
    L2) ``CHASE_READS`` times (``csrc/pointer_chase.cu``): ``dram_ns``; the
    same chase through ``CHASE_L2_INTS`` (16 MiB, held in L2): ``l2_ns``,
    a dependent read that hits L2."""
    import ctypes

    import torch
    from repro_torch.kernels import _build

    fn = _build.library("pointer_chase").pointer_chase_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ns = {}
    for n_ints in (CHASE_INTS, CHASE_L2_INTS):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        perm = torch.randperm(n_ints, generator=gen, device=dev, dtype=torch.int32)
        nxt = torch.empty_like(perm)
        nxt[perm.long()] = torch.roll(perm, -1)   # one cycle through every slot
        del perm

        def chase(n):
            _build.check(fn(nxt.data_ptr(), 0, n, out.data_ptr(), stream),
                         "pointer_chase")

        chase(CHASE_READS // 10)                   # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chase(CHASE_READS)
        end.record()
        end.synchronize()
        ns[n_ints] = start.elapsed_time(end) * 1e6 / CHASE_READS
        # a launch that reads nothing: the floor of any one-launch kernel
        launch_ms = device_ms(lambda: chase(0), 100)
        del nxt
    log("chase", reads=CHASE_READS, ns_per_read=ns[CHASE_INTS],
        gib=CHASE_INTS * 4 / 2**30, l2_ns_per_read=ns[CHASE_L2_INTS],
        l2_mib=CHASE_L2_INTS * 4 / 2**20, launch_floor_ms=launch_ms,
        last=int(out))
    torch.cuda.empty_cache()
    return dict(dram_ns=ns[CHASE_INTS], l2_ns=ns[CHASE_L2_INTS])


def check_counter_kernel(name, kernel, plain, n_bins, lanes, kw, replaces,
                         label=None):
    """A counter kernel against its twin on a warm buffer, then timed.
    ``visit_counter_update_high`` runs as the main path calls it: the
    crossings added into a running tally in place, one launch; its old
    three-launch sequence (a zeroed delta, the kernel, an add) is timed
    beside it once, for the record."""
    import torch
    from repro_torch.kernels.visit_counter import _valid_bins

    dev = lanes[0].device
    high = name == "visit_counter_update_high"
    base = torch.zeros((n_bins,), dtype=torch.int32, device=dev)
    qev, sev, iev = lanes
    n_dim = kw.get("n_pins", kw.get("n_dim"))
    n_rows = n_bins // n_dim
    bins = _valid_bins(sev, iev, qev, kw["n_slots"], n_dim, kw["n_queries"])
    # a warm buffer: every other touched bin sits one below n_v, so the
    # checked round's first event there crosses it
    base[bins[::2]] = kw.get("n_v", 4) - 1
    ck, cp = base.clone(), base.clone()
    extra = {}
    if high:
        # a running tally that already holds counts: the kernel adds to it
        tally = torch.arange(7, 7 + n_rows, dtype=torch.int32, device=dev)
        extra = dict(high=tally.clone())
    got = kernel(ck, sev, iev, qev, **kw, **extra)
    want = plain(cp, sev, iev, qev, **kw)
    err = int((ck.long() - cp.long()).abs().max())
    if high:
        if int(want.sum()) == 0:
            raise AssertionError(f"{name}: the checked round crossed no bin")
        if got is not extra["high"]:
            raise AssertionError(f"{name}: the tally was not updated in place")
        err = max(err, int((got.long() - (tally + want).long()).abs().max()))
    if err:
        raise AssertionError(f"{name} differs from its twin: max err {err}")
    del cp
    run = lambda: kernel(ck, sev, iev, qev, **kw, **extra)
    ms = device_ms(run, 50)
    call_ms = cuda_ms(run, 50)
    plain_ms = cuda_ms(lambda: plain(ck, sev, iev, qev, **kw), 5)
    ones = torch.ones_like(bins, dtype=torch.int32)
    library_ms = device_ms(lambda: ck.index_add_(0, bins, ones), 50)
    three_ms = None
    if high:
        t = extra["high"]
        three_ms = device_ms(lambda: t.add_(kernel(ck, sev, iev, qev, **kw)), 50)
    m = sev.shape[0]
    # bound: the lanes read once, and each distinct 32-byte sector of the
    # count buffer the events touch read once and written once (a bin hit
    # again is an L2 hit: the buffer of the wide check fits in L2 whole)
    sectors = int(torch.unique(bins >> 3).numel())
    nbytes = 4 * 3 * m + 2 * SECTOR * sectors
    if high:
        nbytes += 2 * 4 * n_rows          # the tally read and written
    log("kernel", name=name, shape=label, device_ms=ms, call_ms=call_ms,
        events=m,
        valid_events=int(bins.shape[0]), bins=n_bins,
        distinct_bins=int(torch.unique(bins).numel()),
        distinct_sectors=sectors, bound_bytes=nbytes,
        crossed=int(want.sum()) if high else None,
        index_add_ms=library_ms, three_launch_ms=three_ms,
        three_launch_is="torch.zeros delta, the kernel, tally + delta: the "
                        "sequence before the in-place tally" if high else None)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/visit_counter.cu",
        replaces=replaces, launches=None, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=library_ms,
    )


def check_topk_select(keys, k: int, label: str) -> dict:
    """Phase 2b: the top-k's selection kernel against its twin on the
    card, the same indices bit for bit; timed beside the twin, its bound
    (the keys read once) and ``torch.topk`` (no tie rule)."""
    import torch
    from repro_torch.core import counter
    from repro_torch.kernels import topk_select as ts

    kth = torch.topk(keys, k, dim=-1, sorted=True).values[:, -1:]
    got = ts.topk_select(keys, kth, k)
    if not torch.equal(got, counter.topk_select_plain(keys, kth, k)):
        raise AssertionError(f"topk_select differs from its twin at {label}")
    ms = device_ms(lambda: ts.topk_select(keys, kth, k), 20)
    plain_ms = cuda_ms(lambda: counter.topk_select_plain(keys, kth, k), 3)
    library_ms = device_ms(lambda: torch.topk(keys, k, dim=-1, sorted=True), 5)
    nbytes = keys.numel() * keys.element_size()
    log("kernel", name="topk_select", shape=label, device_ms=ms, k=k,
        above_kth=int((keys > kth).sum()), ties_at_kth=int((keys == kth).sum()),
        bound_bytes=nbytes, torch_topk_ms=library_ms)
    return dict(
        name="topk_select", route="cuda", shape=label,
        source="src/repro_torch/kernels/csrc/topk_select.cu",
        replaces="none (counter._topk's selection; the reference's top-k is lax.top_k)",
        launches=None, max_abs_err=0, ms=ms, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms,
    )


def wide_edge_cases(dev) -> int:
    """``visit_counter_wide`` against its twin on a prefilled buffer: no
    events (no launch), negative and sentinel lanes, every event in one
    bin, no query lane, and tiles whose bins do not fit the block's shared
    window (a query window of 12M bins) beside ones that do."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import visit_counter as vc

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    n = 0
    for case in ("no_events", "sentinels", "one_bin", "no_query_lane",
                 "window_misses"):
        n_queries, w, steps, n_slots, n_dim = 16, 8192, 8, 4, 2000
        if case == "window_misses":
            n_queries, n_dim = 2, 3_000_000
        m = n_queries * w * steps
        q = torch.arange(n_queries, dtype=torch.int32, device=dev)
        q = q.repeat_interleave(w).repeat(steps)          # query-major walkers
        s = torch.randint(0, n_slots, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
        i = torch.randint(0, n_dim, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
        i[::3] = i[::3] % 4                                 # hot bins
        if case == "sentinels":
            q[::7] = n_queries
            s[1::11] = n_slots
            s[2::13] = -1
            i[3::17] = n_dim
            i[4::19] = -5
        if case == "one_bin":
            q.fill_(3), s.fill_(1), i.fill_(17)
        if case == "no_events":
            q, s, i = q[:0], s[:0], i[:0]
        qe, nq = (None, 0) if case == "no_query_lane" else (q, n_queries)
        n_rows = n_queries * n_slots if qe is not None else n_slots
        prior = torch.randint(0, 3, (n_rows * n_dim,), generator=gen,
                              device=dev, dtype=torch.int32)
        ck, cp = prior.clone(), prior.clone()
        kw = dict(n_slots=n_slots, n_dim=n_dim, n_queries=nq)
        before = _build.launches["visit_counter_wide"]
        vc.visit_counter_wide(ck, s, i, qe, **kw)
        torch.cuda.synchronize()
        launched = _build.launches["visit_counter_wide"] - before
        vc.visit_counter_wide_plain(cp, s, i, qe, **kw)
        if not torch.equal(ck, cp):
            raise AssertionError(f"visit_counter_wide {case}: differs from its twin")
        if launched != (0 if case == "no_events" else 1):
            raise AssertionError(f"visit_counter_wide {case}: {launched} launches")
        if case == "one_bin" and int((ck.long() - prior.long()).sum()) != m:
            raise AssertionError("visit_counter_wide one_bin: events lost")
        n += 1
    return n


def board_rec_full(graph, reqs, shape, cfg, dev) -> tuple:
    """A full-width board-rec request (``count_boards`` on the FULL walk:
    8 slots x 60M boards = 480M board bins, 1.92 GB) through serve_batch
    on the kernel path and the plain path, bit for bit; the board counts
    themselves from the batch-native kernel engine against the per-query
    plain engine; then ``visit_counter_wide`` on that request's first chunk
    of board lanes, whose one-query window (480M bins) no shared window
    holds.  Returns the kernel path's launches and the kernel's row."""
    import torch
    from repro_torch.core import prng, service, walk
    from repro_torch.kernels import _build
    from repro_torch.kernels import visit_counter as vc

    bcfg = service.board_rec_config(cfg)
    batch = padded_batch(reqs[:1], shape.n_slots, dev)
    keys = prng.fold_in(prng.key(SEED, dev), 0)[None, :]
    service.serve_batch(graph, *batch, keys, bcfg)                # warm-up
    torch.cuda.synchronize()
    out = {}
    _build.reset_launches()
    kern_ms = wall_ms(lambda: out.setdefault("k", service.serve_batch(
        graph, *batch, keys, bcfg, backend="pallas", with_stats=True)))
    launches = dict(_build.launches)
    if launches["visit_counter_wide"] == 0:
        raise AssertionError("the full-width board-rec request never launched visit_counter_wide")
    plain_ms = wall_ms(lambda: out.setdefault("p", service.serve_batch(
        graph, *batch, keys, bcfg, backend="xla", with_stats=True)))
    kern, plain = out["k"], out["p"]
    assert_same(kern, plain, "full-width board-rec request")
    check_result(kern[0][0], kern[1][0], bcfg.top_k, graph.n_pins,
                 "full-width board-rec request")
    bk = walk.pixie_random_walk_batched(
        graph, *batch, keys, dataclasses.replace(bcfg, backend="pallas"))
    boards_k = bk.board_counts[0].clone()
    del bk
    bp = walk.pixie_random_walk(
        graph, batch[0][0], batch[1][0], batch[2][0], keys[0],
        dataclasses.replace(bcfg, backend="xla"))
    if not torch.equal(boards_k, bp.board_counts):
        raise AssertionError("full-width board counts: kernel and plain engines differ")
    visited = int((boards_k > 0).sum())
    total = int(boards_k.sum(dtype=torch.int64))
    del bp, boards_k
    torch.cuda.empty_cache()
    winp = walk_inputs(graph, reqs[:1], shape.n_slots, bcfg)
    _, qev, sev, _, bev = run_walk_kernel(winp)
    row = check_counter_kernel(
        "visit_counter_wide", vc.visit_counter_wide, vc.visit_counter_wide_plain,
        shape.n_slots * graph.n_boards,
        (qev.reshape(-1), sev.reshape(-1), bev.reshape(-1)),
        dict(n_slots=shape.n_slots, n_dim=graph.n_boards, n_queries=1),
        "src/repro/kernels/visit_counter.py:196",
        label="full-width board-rec chunk (8 x 60M bins)")
    log("board_rec_full", pins=len(reqs[0][0]),
        board_bins=shape.n_slots * graph.n_boards,
        board_gb=shape.n_slots * graph.n_boards * 4 / 1e9,
        kernel_path_ms=kern_ms, plain_path_ms=plain_ms, identical=True,
        boards_identical=True, boards_visited=visited, board_visits=total,
        steps_taken=int(kern[2].sum()), launches=launches,
        wide_chunk_ms=row["ms"], wide_chunk_bound_ms=row["bound_ms"])
    del winp, qev, sev, bev
    torch.cuda.empty_cache()
    return launches, row


# ---------------------------------------------------------------------------
# Phases 6-8: ranked serving, the open loop, the bag kernel
# ---------------------------------------------------------------------------


def ranked_plain(graph, rank, pins, weights, feats, keys, cfg, scen):
    """The plain ranked path: the walk twins, then stage 2 with the bag
    twin (``use_kernel=False``)."""
    from repro_torch.core import service
    from repro_torch.serving import ranker

    retrieval = dataclasses.replace(cfg, top_k=rank.cfg.n_candidates)
    s, i, steps, n_high = service.serve_batch(
        graph, pins, weights, feats, keys, retrieval, backend="xla",
        with_stats=True)
    s, i = ranker.rank_candidates(rank.params, rank.cfg, graph, i, s, scen,
                                  use_kernel=False)
    return s, i, steps, n_high


def ranked_split_ms(graph, rank, pins, weights, feats, keys, cfg, scen):
    """One ranked request's phases, each timed alone with a synchronise:
    retrieval (the walk with top_k = n_candidates), the 2-hop
    neighborhoods, the bags (the pair launch and the self-row gather),
    the scenario heads and the final top-k."""
    import torch
    from repro_torch.core import counter as counter_lib
    from repro_torch.core import service
    from repro_torch.kernels import ops
    from repro_torch.serving import ranker

    rc = rank.cfg
    table = rank.params["items"]
    retrieval = dataclasses.replace(cfg, top_k=rc.n_candidates)
    out = {}
    ms = {"retrieval": wall_ms(lambda: out.setdefault("walk", service.serve_batch(
        graph, pins, weights, feats, keys, retrieval)))}
    s, i = out["walk"]
    valid = s > 0
    ms["neighborhoods"] = wall_ms(lambda: out.setdefault(
        "nbr", ranker.candidate_neighborhoods(graph, i, valid, rc.n_neighbors)))

    def bags():
        nbr_ids, nbr_w = out["nbr"]
        q_ids, q_w = ranker.query_bag(i, s)
        neigh, query = ops.embedding_bag_pair(table, nbr_ids, nbr_w, q_ids,
                                              q_w, mode="mean")
        out["emb"] = (
            table[torch.where(valid, i, 0).long()] * valid[..., None].to(table.dtype),
            neigh, query[:, 0],
        )

    ms["bags"] = wall_ms(bags)
    ms["heads"] = wall_ms(lambda: out.setdefault("raw", ranker.score_heads(
        rank.params["heads"], torch.as_tensor(scen).long(), *out["emb"])))
    ms["topk"] = wall_ms(lambda: counter_lib.topk_dense(
        torch.where(valid, out["raw"], float("-inf")), rc.final_k))
    return ms


def check_ranked(scores, ids, k: int, n_pins: int, what: str) -> None:
    """A full-width ranked result: k real candidates, finite scores in
    descending order."""
    import torch

    scores, ids = torch.as_tensor(scores), torch.as_tensor(ids)
    if scores.shape[-1] != k or ids.shape[-1] != k:
        raise AssertionError(f"{what}: expected {k} ranked, got {tuple(ids.shape)}")
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"{what}: non-finite ranked scores")
    if int(ids.min()) < 0 or int(ids.max()) >= n_pins:
        raise AssertionError(f"{what}: ranked ids outside [0, {n_pins})")
    if bool((scores[..., 1:] > scores[..., :-1]).any()):
        raise AssertionError(f"{what}: ranked scores not descending")


def connected_pins(graph, n: int):
    """Up to ``n`` seeded random pins with at least one board."""
    import torch

    rng = np.random.default_rng(SEED + 3)
    cand = torch.from_numpy(
        rng.integers(0, graph.n_pins, n).astype(np.int32)).to(graph.device)
    return cand[graph.pin_degree(cand) > 0].cpu().numpy()


def bag_sector_bytes(table, ids) -> int:
    """Bytes of the distinct 32-byte sectors of table rows that the bags
    read (an invalid id reads row 0)."""
    import torch

    v, d = table.shape
    row_bytes = d * table.element_size()
    rows = torch.where((ids >= 0) & (ids < v), ids, 0).long().unique()
    first = rows * row_bytes // SECTOR
    last = ((rows + 1) * row_bytes - 1) // SECTOR
    span = torch.arange(int((last - first).max()) + 1, device=rows.device)
    sec = first[:, None] + span[None, :]
    return SECTOR * int(sec[sec <= last[:, None]].unique().numel())


def check_bag(table, ids, weights, mode: str, what: str):
    """The bag kernel against its twin on the same inputs, bit for bit."""
    import torch
    from repro_torch.kernels import embedding_bag as eb

    if ids.dim() == 3:
        got = eb.embedding_bag_batched(table, ids, weights, mode=mode)
        want = eb.embedding_bag_batched_plain(table, ids, weights, mode=mode)
    else:
        got = eb.embedding_bag(table, ids, weights, mode=mode)
        want = eb.embedding_bag_plain(table, ids, weights, mode=mode)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"embedding_bag {what}: differs from its twin, max err {err}")
    return got


def time_bag(table, ids, weights, mode: str, what: str) -> dict:
    """Device ms of the kernel (back to back), the twin's ms, torch's
    F.embedding_bag(mode="sum") on the same bags (no mean division) and
    the byte bound: ids, weights and output once plus the distinct table
    sectors the bags read."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb

    out = check_bag(table, ids, weights, mode, what)
    l = ids.shape[-1]
    ids2, w2 = ids.reshape(-1, l), weights.reshape(-1, l)
    valid = (ids2 >= 0) & (ids2 < table.shape[0])
    lib_ids = torch.where(valid, ids2, 0).long()
    lib_w = w2 * valid
    nbytes = (4 * ids.numel() + 4 * weights.numel()
              + out.numel() * out.element_size() + bag_sector_bytes(table, ids))
    row = dict(
        ms=device_ms(lambda: eb.embedding_bag_batched(table, ids, weights, mode=mode), 50),
        plain_ms=cuda_ms(lambda: eb.embedding_bag_batched_plain(table, ids, weights, mode=mode), 5),
        library_ms=device_ms(lambda: F.embedding_bag(
            lib_ids, table, per_sample_weights=lib_w, mode="sum"), 50),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
    )
    log("bag", shape=list(ids.shape), table=list(table.shape), mode=mode,
        bound_bytes=nbytes, **row)
    return row


EDGE_BAGS = [  # (table dtype, d, ids shape): beside the main path's shapes
    ("bfloat16", 32, (4, 16, 8)),
    ("float32", 48, (3, 7, 5)),
    ("float32", 32, (37, 1)),
    ("bfloat16", 48, (13, 3)),
]
# bag lengths at the kernel's edges (one warp a bag up to 16 elements, two
# up to 48, eight beyond; 32 rows staged a warp, so 300 runs in two tiles
# of an eight-warp team's 256) over these tables (bf16 rows of odd width
# are not 4-byte aligned and are staged through registers)
EDGE_LENGTHS = (1, 31, 32, 33, 64, 65, 300)
EDGE_TABLES = (("float32", 32), ("bfloat16", 32), ("float32", 48),
               ("bfloat16", 33))


def check_pair(table, a, b, mode: str, what: str):
    """The pair launch (``embedding_bag_pair``) against two twin calls, bit
    for bit; ``a`` and ``b`` are ``(ids, weights)`` of (b, k, l) bags."""
    import torch
    from repro_torch.kernels import embedding_bag as eb

    got = eb.embedding_bag_pair(table, *a, *b, mode=mode)
    want = eb.embedding_bag_pair_plain(table, *a, *b, mode=mode)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            err = float((g.float() - w.float()).abs().max())
            raise AssertionError(
                f"embedding_bag_pair {what}: differs from two twin calls, max err {err}")
    return got


def time_pair(table, a, b, mode: str, lat: dict) -> dict:
    """The ranked request's two bags in one launch: device ms back to back,
    single launches with a warm and a cold L2 (serving rows start cold),
    the same bags as two single-set launches, the twin's ms, torch's
    F.embedding_bag(mode="sum") over both sets in ONE call (offsets mark
    the bags; no mean division), the byte bound (ids, weights and outputs
    once plus the distinct table sectors) and the chain floor: two
    dependent reads, an id and then its row, at the probe's L2 latency
    (and, logged, at its DRAM latency)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb

    outs = check_pair(table, a, b, mode, "ranked shapes")
    dev = table.device
    v = table.shape[0]
    flat_ids, flat_w, offsets, start = [], [], [], 0
    for ids, w in (a, b):
        l = ids.shape[-1]
        valid = (ids >= 0) & (ids < v)
        flat_ids.append(torch.where(valid, ids, 0).reshape(-1).long())
        flat_w.append((w * valid).reshape(-1))
        offsets.append(start + l * torch.arange(ids.numel() // l, device=dev))
        start += ids.numel()
    lib = (torch.cat(flat_ids), torch.cat(offsets), torch.cat(flat_w))
    all_ids = torch.cat([a[0].reshape(-1), b[0].reshape(-1)])
    nbytes = (8 * all_ids.numel()
              + sum(o.numel() * o.element_size() for o in outs)
              + bag_sector_bytes(table, all_ids))
    run = lambda: eb.embedding_bag_pair(table, *a, *b, mode=mode)
    row = dict(
        ms=device_ms(run, 50),
        plain_ms=cuda_ms(lambda: eb.embedding_bag_pair_plain(table, *a, *b, mode=mode), 5),
        library_ms=device_ms(lambda: F.embedding_bag(
            lib[0], table, lib[1], per_sample_weights=lib[2], mode="sum"), 50),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        chain_floor_ms=2 * lat["l2_ns"] * 1e-6,
    )
    two_ms = device_ms(lambda: (eb.embedding_bag_batched(table, *a, mode=mode),
                                eb.embedding_bag_batched(table, *b, mode=mode)), 50)
    single = cold_l2_ms(run, dev)
    log("bag_pair", shapes=[list(a[0].shape), list(b[0].shape)],
        table=list(table.shape), mode=mode, bound_bytes=nbytes, **row,
        chain_dram_ms=2 * lat["dram_ns"] * 1e-6, **single,
        two_launches_ms=two_ms,
        library_is="F.embedding_bag(mode='sum') over both sets in one call")
    return row


def check_edge_bags(dev) -> int:
    """The kernel against its twin at the edge shapes and lengths, in sum
    and mean mode, with weights and without, each with an all-padding bag;
    the pair at edge lengths against two twin calls."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def bags(shape):
        ids = torch.randint(-1, 1000, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        ids.reshape(-1, shape[-1])[0] = -1
        return ids, torch.rand(shape, generator=gen, device=dev) * 2

    cases = list(EDGE_BAGS) + [(dtype, d, (3, 5, l)) for dtype, d in EDGE_TABLES
                               for l in EDGE_LENGTHS]
    n = 0
    for k, (dtype, d, shape) in enumerate(cases):
        table = torch.randn((1000, d), generator=gen, device=dev).to(
            getattr(torch, dtype))
        ids, w = bags(shape)
        other = bags((2, 1, EDGE_LENGTHS[k % len(EDGE_LENGTHS)]))
        for mode in ("sum", "mean"):
            for weights in (w, None):
                got = check_bag(table, ids, weights, mode, f"{dtype} d={d} {shape}")
                if got.reshape(-1, d)[0].any():
                    raise AssertionError("an all-padding bag pooled to non-zero")
                n += 1
            if len(shape) == 3:
                check_pair(table, (ids, w), other, mode, f"{dtype} d={d} {shape}")
                n += 1
    return n


# ---------------------------------------------------------------------------
# Phases 9-10: batched ranked serving, multi-interest users, chaos
# ---------------------------------------------------------------------------


def serve_requests(server, reqs, scenarios=None):
    """Submit every request at t=0, dispatch at t=1, results by id."""
    for rid, (p, w, f) in enumerate(reqs):
        kw = {} if scenarios is None else dict(scenario=scenarios[rid])
        server.submit(p, w, user_feat=f, now=0.0, req_id=rid, **kw)
    server.pump(now=1.0)
    return sorted(server.harvest(), key=lambda r: r.req_id)


def assert_results_equal(a, b, what: str) -> None:
    if [r.req_id for r in a] != [r.req_id for r in b]:
        raise AssertionError(f"{what}: different request ids")
    for x, y in zip(a, b):
        if not (np.array_equal(x.scores, y.scores) and np.array_equal(x.ids, y.ids)):
            raise AssertionError(f"{what}: request {x.req_id} differs")


def lane_oracle(graph, uq, user_id, cfg, dev):
    """One user's cluster lanes walked one query at a time with the
    server's per-(user, cluster) keys and budgets, then merged."""
    import torch
    from repro_torch.core import prng, service, walk

    server_key = prng.key(SEED, dev)
    budgets = service.cluster_step_budgets(uq.importance, cfg.n_steps)
    scores, ids = [], []
    for ci in range(uq.n_clusters):
        t = lambda a: torch.as_tensor(a, device=dev)
        key = prng.fold_in(prng.fold_in(server_key, user_id), ci)[None, :]
        s, i = service.serve_batch(
            graph, t(uq.cluster_pins[ci][None]), t(uq.cluster_weights[ci][None]),
            t(np.array([uq.user_feat], np.int32)), key, cfg,
            step_budgets=t(np.array([budgets[ci]], np.int32)))
        scores.append(s[0])
        ids.append(i[0])
    return walk.merge_interest_topk(torch.stack(scores), torch.stack(ids),
                                    torch.as_tensor(uq.importance, device=dev))


def multi_interest_users(sg, cfg, rank, dev, n_users: int = 8):
    """submit_user against the per-cluster oracle, then the same users
    ranked by recommend_multi_interest against the oracle's merged lanes
    ranked by rank_candidates.  Returns the submit_user run's launches."""
    import torch
    from repro_torch.core import prng, service
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import _build
    from repro_torch.serving import ranker
    from repro_torch.serving.recommend import recommend_multi_interest
    from repro_torch.serving.server import PixieServer

    hist = synthetic.sample_user_histories(sg, synthetic.UserHistoryConfig(
        n_users=n_users, n_interests=3, mean_actions=20, seed=SEED))
    srv = PixieServer(sg.graph, cfg, buckets=[(16, 4), (8, 8)], seed=SEED,
                      pin_topics=sg.pin_topics, n_clusters=3)
    _build.reset_launches()
    for u, h in enumerate(hist):
        srv.submit_user(h.actions, user_feat=u % 4, now=0.0, req_id=u)
    srv.pump(now=1.0)
    got = {r.req_id: r for r in srv.harvest()}
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    uqs = [service.build_user_query(h.actions, sg.pin_topics, n_slots=srv.max_slots,
                                    n_clusters=3, user_feat=u % 4)
           for u, h in enumerate(hist)]
    n_lanes = 0
    for u, uq in enumerate(uqs):
        ms, mi = lane_oracle(sg.graph, uq, u, cfg, dev)
        if not (np.array_equal(got[u].scores, ms.cpu().numpy())
                and np.array_equal(got[u].ids, mi.cpu().numpy())):
            raise AssertionError(f"user {u}: submit_user differs from the per-cluster oracle")
        n_lanes += uq.n_clusters

    retrieval = dataclasses.replace(cfg, top_k=rank.cfg.n_candidates)
    batch = service.batch_user_queries(uqs, cfg.n_steps, device=dev)
    server_key = prng.key(SEED, dev)
    keys = []
    for li, u in enumerate(batch.lane_user):
        ci = int(np.nonzero(batch.lane_of_user[u] == li)[0][0])
        keys.append(prng.fold_in(prng.fold_in(server_key, int(u)), ci))
    scen = torch.arange(len(uqs), device=dev, dtype=torch.int32) % 2
    rs, ri = recommend_multi_interest(sg.graph, batch, torch.stack(keys), cfg,
                                      rank=rank, scenario=scen)
    merged = [lane_oracle(sg.graph, uq, u, retrieval, dev) for u, uq in enumerate(uqs)]
    ws, wi = ranker.rank_candidates(
        rank.params, rank.cfg, sg.graph, torch.stack([m[1] for m in merged]),
        torch.stack([m[0] for m in merged]), scen)
    if not (torch.equal(rs, ws) and torch.equal(ri, wi)):
        raise AssertionError("recommend_multi_interest(rank=...) differs from the ranked oracle")
    log("users", users=len(uqs), lanes=n_lanes, batches=srv.stats.batches,
        identical=True, ranked_identical=True, launches=launches)
    return launches


def chaos_runs(sg, cfg, dev, n_requests: int = 64):
    """A seeded chaos schedule twice (identical results and budgets), and a
    zero-fault schedule against the plain run (bit-identical).  Returns
    the first chaos run's launches."""
    import torch
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import _build
    from repro_torch.serving import traffic
    from repro_torch.serving.resilience import ResilienceConfig
    from repro_torch.serving.server import PixieServer

    reqs = traffic.poisson_requests(
        synthetic.top_degree_pins(sg, 256),
        traffic.OpenLoopConfig(offered_qps=2000.0, n_requests=n_requests,
                               seed=SEED, max_pins=8, n_feats=4))
    faults = traffic.sample_fault_schedule(traffic.ChaosConfig(
        horizon_s=reqs[-1].t_arrival, seed=SEED, n_spikes=3,
        spike_duration_s=0.005, n_bursts=2, burst_duration_s=0.005))
    shed = ResilienceConfig(deadline_ms=20.0, shed_start_ms=2.0)

    def run(resilience, schedule):
        srv = PixieServer(sg.graph, cfg, buckets=[(16, 4), (8, 8)], seed=SEED,
                          resilience=resilience)
        return traffic.run_open_loop(srv, reqs, faults=schedule)

    _build.reset_launches()
    a = run(shed, faults)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    b = run(shed, faults)
    if a.budgets != b.budgets or sorted(a.results) != sorted(b.results):
        raise AssertionError("chaos replay: budgets or served requests differ")
    assert_results_equal([a.results[k] for k in sorted(a.results)],
                         [b.results[k] for k in sorted(b.results)], "chaos replay")
    if min(a.budgets.values()) >= cfg.n_steps:
        raise AssertionError("chaos run shed no budget: the schedule did not engage")
    plain = run(None, None)
    idle = run(ResilienceConfig(deadline_ms=1e6, shed_start_ms=1e5),
               traffic.FaultSchedule())
    assert_results_equal([plain.results[k] for k in sorted(plain.results)],
                         [idle.results[k] for k in sorted(idle.results)],
                         "zero-fault chaos vs plain")
    log("chaos", requests=n_requests, events=len(faults.events),
        served=a.n_served, shed_requests=sum(v < cfg.n_steps for v in a.budgets.values()),
        min_budget=min(a.budgets.values()), replay_identical=True,
        zero_fault_identical=True, launches=launches,
        chaos_p99_ms=a.percentile(99), plain_p99_ms=plain.percentile(99))
    return launches


# ---------------------------------------------------------------------------
# Phase 4b: batches past 12,288 counter rows
# ---------------------------------------------------------------------------

PAST_CAP_QUERIES = 1_537          # x 8 slots: 12,296 rows, 984 MB of counts
SHARDED_PAST_CAP_QUERIES = 1_600  # x 8 slots: 12,800 rows on each of 2 shards
PAST_CAP_SLOTS = 8
# the sharded batch's walk, cut: 1,024 walkers and 20,000 steps a query
# (FULL_WALK's 8,192 and 200,000 would route 13M walkers a superstep)
SHARDED_PAST_CAP_WALKERS = 1_024
SHARDED_PAST_CAP_STEPS = 20_000


def past_cap_batch(sg, n_queries: int, seed: int):
    """``n_queries`` requests of 1 to 8 top-degree pins -> ``(requests,
    (pins, weights, feats, keys))``: padded, with per-query keys (the
    server's folds of the request ids)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.graphs import synthetic

    dev = sg.graph.device
    rng = np.random.default_rng(seed)
    top = synthetic.top_degree_pins(sg, 256)
    reqs = []
    for i in range(n_queries):
        k = 1 + i % PAST_CAP_SLOTS
        reqs.append(([int(p) for p in rng.choice(top, k, replace=False)],
                     [float(x) for x in rng.uniform(0.1, 1.0, k).astype(np.float32)],
                     int(rng.integers(0, 4))))
    keys = prng.fold_in(prng.key(SEED, dev), torch.arange(n_queries, device=dev))
    return reqs, (*padded_batch(reqs, PAST_CAP_SLOTS, dev), keys)


def past_cap_phases(sg, cfg, dev):
    """Phase 4b on the 20k graph: a batch whose counter rows pass the old
    12,288-row cap of visit_counter_update_high through serve_batch's
    batch-native engine, kernel path == plain path through the same
    engine, and the counter kernel timed on the batch's first chunk;
    then a sharded batch past the cap on each shard (kernel path == plain
    path, drops included).  Returns both paths' launch counts."""
    import torch
    from repro_torch.core import distributed as dist
    from repro_torch.core import service, walk
    from repro_torch.kernels import _build
    from repro_torch.kernels import visit_counter as vc

    graph = sg.graph
    n_rows = PAST_CAP_QUERIES * PAST_CAP_SLOTS
    reqs, batch = past_cap_batch(sg, PAST_CAP_QUERIES, SEED + 6)
    if not walk.batched_engine_fits(PAST_CAP_QUERIES, PAST_CAP_SLOTS,
                                    graph.n_pins, graph.n_boards):
        raise AssertionError("the past-cap batch does not fit the batched engine")
    torch.cuda.reset_peak_memory_stats()
    walls, runs = [], []
    for rnd in range(2):                  # the first run grows the allocator
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        runs.append(service.serve_batch(graph, *batch, cfg, backend="pallas",
                                        with_stats=True))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high"):
        if launches[name] == 0:
            raise AssertionError(f"the past-cap batch never launched {name}")
    got = runs[1]
    assert_same(runs[0], got, "past-cap batch, two kernel runs")
    t = time.perf_counter()
    want = walk.recommend_with_stats_batched(
        graph, *batch, dataclasses.replace(cfg, backend="xla"))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    assert_same(got, want, "past-cap batch")
    check_result(got[0], got[1], cfg.top_k, graph.n_pins, "past-cap batch")
    if int(got[3].sum()) == 0:
        raise AssertionError("past-cap batch: no bin crossed n_v")
    stats = dict(steps_taken=int(got[2].sum()), n_high=int(got[3].sum()),
                 early_stopped_rows=int((got[3] > cfg.n_p).sum()),
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del runs, got, want
    # the counter on the batch's first chunk: 8 steps of 12.6M walkers
    # into 12,296 rows (its "kernel" line; the kernels line keeps the
    # retrieval chunk's)
    inp = walk_inputs(graph, reqs, PAST_CAP_SLOTS, cfg)
    _, qev, sev, pev, _ = run_walk_kernel(inp)
    del inp
    counter = check_counter_kernel(
        "visit_counter_update_high", vc.visit_counter_update_high,
        vc.visit_counter_update_high_plain, n_rows * graph.n_pins,
        (qev.reshape(-1), sev.reshape(-1), pev.reshape(-1)),
        dict(n_slots=PAST_CAP_SLOTS, n_pins=graph.n_pins, n_v=cfg.n_v,
             n_queries=PAST_CAP_QUERIES),
        "src/repro/kernels/visit_counter.py:329",
        label=f"past-cap batch's first chunk ({n_rows} x {graph.n_pins} bins)")
    del qev, sev, pev
    log("past_cap", queries=PAST_CAP_QUERIES, n_slots=PAST_CAP_SLOTS,
        counter_rows=n_rows, count_bins=n_rows * graph.n_pins,
        counts_gb=n_rows * graph.n_pins * 4 / 1e9,
        walkers=PAST_CAP_QUERIES * cfg.n_walkers, kernel_wall_ms=walls,
        plain_wall_ms=plain_ms, identical_to_plain=True,
        **stats, counter_ms=counter["ms"], counter_bound_ms=counter["bound_ms"],
        launches=launches)
    del batch
    torch.cuda.empty_cache()

    # the sharded engine counts each shard's n_queries * n_slots rows
    n_shards = 2
    shg = dist.shard_graph(graph, n_shards)
    fabric = dist.LocalFabric(n_shards, device=dev)
    scfg = dataclasses.replace(cfg, n_walkers=SHARDED_PAST_CAP_WALKERS,
                               n_steps=SHARDED_PAST_CAP_STEPS, bias_beta=0.0)
    _, batch = past_cap_batch(sg, SHARDED_PAST_CAP_QUERIES, SEED + 7)
    out, walls = {}, {}
    for backend in ("pallas", "xla"):
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        out[backend] = service.serve_batch(shg, *batch, scfg, backend=backend,
                                           with_stats=True, fabric=fabric)
        torch.cuda.synchronize()
        walls[backend] = (time.perf_counter() - t) * 1e3
        if backend == "pallas":
            sharded_launches = dict(_build.launches)
    for name in ("walk_hop_fused", "walk_bits", "visit_counter_update_high"):
        if sharded_launches[name] == 0:
            raise AssertionError(f"the sharded past-cap batch never launched {name}")
    a, b = out["pallas"], out["xla"]
    assert_same(a, b, "sharded past-cap batch")
    if not torch.equal(a[4], b[4]):
        raise AssertionError("sharded past-cap batch: drops differ between paths")
    check_result(a[0], a[1], scfg.top_k, graph.n_pins, "sharded past-cap batch")
    log("sharded_past_cap", queries=SHARDED_PAST_CAP_QUERIES,
        n_slots=PAST_CAP_SLOTS, n_shards=n_shards,
        counter_rows_per_shard=SHARDED_PAST_CAP_QUERIES * PAST_CAP_SLOTS,
        walk=dict(n_walkers=scfg.n_walkers, n_steps=scfg.n_steps),
        kernel_wall_ms=walls["pallas"], plain_wall_ms=walls["xla"],
        identical_to_plain=True, dropped=int(a[4]), n_high=int(a[3].sum()),
        launches=sharded_launches)
    del out, a, b, shg, batch
    torch.cuda.empty_cache()
    return launches, sharded_launches


# ---------------------------------------------------------------------------
# Phases 11-16: the node-range-sharded engine
# ---------------------------------------------------------------------------

# 2 * n_shards, the reference's drop-free parity slack
SHARDED_SLACK = 32.0
# the 1- and 2-pin requests: one or two slots share the whole step budget,
# so Algorithm 3's early stop fires on them at this graph's degrees
SHARDED_PARITY_REQUESTS = [i for i, k in enumerate(REQUEST_PINS) if k <= 2]
SHARD_CUTS = [
    "140M pins / 60M boards / 1.2B edges (serve_200m_replicated) instead of "
    "serve_3b_sharded's 2B / 1B / 17B: one card's 80 GB holds no more",
    "16 shards co-located on one card (LocalFabric) instead of 16 cards",
]


def shard_sizes(shg) -> dict:
    return dict(
        p2b_edges=shg.p2b_offsets[:, -1].tolist(),
        b2p_edges=shg.b2p_offsets[:, -1].tolist(),
        padded_edges=[shg.p2b_targets.shape[1], shg.b2p_targets.shape[1]],
    )


def hop_sectors(hop, out):
    """Distinct 32-byte sectors the kernel needs from the arrays it reads
    on some lanes only: ``pos`` and ``walker`` at the gated lanes, the
    table's words at the gated lanes, and the offsets and targets that the
    gated lanes read (offset pair, then target), replayed in plain
    PyTorch; the replayed targets must equal the kernel's, so the address
    model is the kernel's own.  Returns ``(distinct sectors, reads)``:
    ``reads`` is ``(round, lane, sector)`` of the dependent reads for
    ``read_chain``, round 0 the offset pair with the word beside it,
    round 1 the target."""
    import torch
    from repro_torch.kernels.walk_step import RMASK

    pos, gate, table, step, column, walker, base, off, tgt = hop
    n = table.shape[1]
    s_idx = torch.arange(pos.shape[0], device=pos.device)[:, None]
    local = torch.where(gate, pos - base[:, None], 0).long()
    at_o = s_idx * off.shape[1] + local
    flat_o = off.reshape(-1)
    start = flat_o[at_o].long()
    deg = flat_o[at_o + 1].long() - start
    ok = gate & (deg > 0)
    at_w = (step * n + torch.where(gate, walker, 0).long()) * 4 + column
    r = table.reshape(-1)[at_w]
    at_t = s_idx * tgt.shape[1] + torch.where(
        ok, start + (r.long() & RMASK) % deg.clamp(min=1), 0)
    if not torch.equal(torch.where(ok, tgt.reshape(-1)[at_t], 0), out):
        raise AssertionError("walk_hop sector replay disagrees with the kernel")
    sec_o = torch.unique(torch.cat([at_o[gate], at_o[gate] + 1]) >> 3).numel()
    sec_t = torch.unique(at_t[ok] >> 3).numel()
    sec_w = torch.unique(at_w[gate] >> 3).numel()
    lane = s_idx * pos.shape[1] + torch.arange(pos.shape[1], device=pos.device)
    sec_lanes = 2 * torch.unique(lane[gate] >> 3).numel()   # pos and walker
    lane = lane.expand_as(pos)
    parts = [(0, 0, at_o, gate), (0, 0, at_o + 1, gate), (0, 1, at_w, gate),
             (1, 2, at_t, ok)]
    reads = tuple(torch.cat(x) for x in zip(*[
        (torch.full_like(lane[m], rnd), lane[m], (at[m] >> 3) | (arr << 40))
        for rnd, arr, at, m in parts]))
    return int(sec_o + sec_t + sec_w + sec_lanes), reads


def hop_args(pos, gate, table, off, tgt, base, *, step, column, walker):
    """An ``ops.walk_hop`` call's arguments in ``walk_hop_fused``'s order."""
    return (pos, gate, table, step, column, walker, base, off, tgt)


def check_hop(hop, what: str):
    """The hop kernel against its twin on the words gathered from the
    table, exactly."""
    import torch
    from repro_torch.kernels import walk_step as ws

    pos, gate, table, step, column, walker, base, off, tgt = hop
    got = ws.walk_hop_fused(*hop)
    r = table[step, :, column][torch.where(gate, walker, 0).long()]
    want = ws.walk_hop_ref(pos, gate, r, off, tgt, base)
    torch.cuda.synchronize()
    err = int((got[0].long() - want[0].long()).abs().max()) if got[0].numel() else 0
    if err or not torch.equal(got[1], want[1]):
        raise AssertionError(f"walk_hop_fused {what}: differs from its twin (max err {err})")
    return got


def time_hop(hop, what: str, lat: dict) -> dict:
    """Device ms of one hop launch (back to back), its twin's ms (the
    words gathered from the table, then ``walk_hop_ref``) and the byte
    bound: ``gate`` read and ``out``/``ok`` written once for every lane,
    ``row_base`` once, plus the distinct sectors the gated or hopping
    lanes need (``hop_sectors``); the hop's chain of two dependent random
    reads (offset pair, then target) priced by ``read_chain``, and one
    launch at a time with a warm and a cold L2."""
    import torch
    from repro_torch.kernels import walk_step as ws

    pos, gate, table, step, column, walker, base, off, tgt = hop
    out, ok = check_hop(hop, what)
    lanes = pos.numel()
    sectors, reads = hop_sectors(hop, out)
    chain = read_chain(reads, lanes, lat)
    nbytes = lanes * (1 + 4 + 1) + 4 * base.numel() + SECTOR * sectors

    def plain():
        r = table[step, :, column][torch.where(gate, walker, 0).long()]
        return ws.walk_hop_ref(pos, gate, r, off, tgt, base)

    row = dict(
        ms=device_ms(lambda: ws.walk_hop_fused(*hop), 50),
        plain_ms=cuda_ms(plain, 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        chain_floor_ms=chain["chain_floor_ms"],
    )
    single = cold_l2_ms(lambda: ws.walk_hop_fused(*hop), pos.device)
    log("hop", hop=what, shape=list(pos.shape), gated=int(gate.sum()),
        hopped=int(ok.sum()), distinct_sectors=sectors, bound_bytes=nbytes,
        **{**row, **chain, **single})
    return row


def hop_edge_cases(shg, dev) -> int:
    """All lanes gated off; degree-0 rows and each shard's last row at
    row_base > 0; garbage positions and walker ids on gated-off lanes;
    the table's last walker and last step."""
    import torch

    s, pps = shg.n_shards, shg.pins_per_shard
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    off, tgt = shg.p2b_offsets, shg.p2b_targets
    base = (torch.arange(s, device=dev, dtype=torch.int32) * pps).contiguous()
    l, n = 256, 4096
    table = torch.randint(-2**31, 2**31 - 1, (3, n, 4), generator=gen,
                          device=dev, dtype=torch.int32)
    walker = torch.randint(0, n, (s, l), generator=gen, device=dev,
                           dtype=torch.int32)
    walker[:, 0] = n - 1
    local = torch.randint(0, pps, (s, l), generator=gen, device=dev)
    deg = off[:, 1:] - off[:, :-1]
    for i in range(s):
        zero = torch.nonzero(deg[i] == 0)[:64, 0]
        local[i, :zero.numel()] = zero
    local[:, -1] = pps - 1
    pos = (base[:, None] + local).to(torch.int32).contiguous()
    none = torch.zeros((s, l), dtype=torch.bool, device=dev)
    got = check_hop((pos, none, table, 0, 2, walker, base, off, tgt),
                    "all lanes gated off")
    if got[0].any() or got[1].any():
        raise AssertionError("walk_hop_fused: a gated-off lane hopped")
    every = torch.ones_like(none)
    got = check_hop((pos, every, table, 2, 2, walker, base, off, tgt),
                    "degree-0 and last rows")
    if bool(got[1][deg.gather(1, local) == 0].any()):
        raise AssertionError("walk_hop_fused: a degree-0 row hopped")
    half = torch.rand((s, l), generator=gen, device=dev) < 0.5
    garbage = torch.where(half, pos, torch.full_like(pos, -7))
    junk = torch.where(half, walker, torch.full_like(walker, -(2**31)))
    check_hop((garbage, half, table, 1, 2, junk, base, off, tgt),
              "garbage on gated-off lanes")
    bo = shg.b2p_offsets
    bbase = (torch.arange(s, device=dev, dtype=torch.int32) * shg.boards_per_shard)
    blocal = torch.randint(0, shg.boards_per_shard, (s, l), generator=gen, device=dev)
    blocal[:, -1] = shg.boards_per_shard - 1
    check_hop(((bbase[:, None] + blocal).to(torch.int32).contiguous(), every,
               table, 2, 3, walker, bbase.contiguous(), bo, shg.b2p_targets),
              "board rows")
    return 4


def sharded_phases(graph, reqs, shape, dev, read_ns: dict):
    """Phases 11-15 on the full-width graph; returns the hop and word-table
    kernels' rows, the launch counts of each sharded path and the profiled
    request's operation counts."""
    import torch
    from repro_torch.configs.pixie import FULL_WALK, SERVE_3B_SHARDED, SHARDED_WALK
    from repro_torch.core import distributed as dist
    from repro_torch.core import prng, service
    from repro_torch.core import walk as walk_lib
    from repro_torch.kernels import _build, ops
    from repro_torch.serving import traffic
    from repro_torch.serving.resilience import overlap_at_k
    from repro_torch.serving.server import PixieServer

    n_shards = SERVE_3B_SHARDED.n_shards
    # 11. the 16-way sharded copy, sliced on the card
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    shg = dist.shard_graph(graph, n_shards)
    torch.cuda.synchronize()
    log("sharded_graph", name=f"{shape.name} sharded {n_shards} ways",
        n_shards=n_shards, pins_per_shard=shg.pins_per_shard,
        boards_per_shard=shg.boards_per_shard, **shard_sizes(shg),
        sharded_gb=shg.nbytes() / 1e9, shard_s=time.perf_counter() - t,
        resident_gb=torch.cuda.memory_allocated() / 1e9,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, cuts=SHARD_CUTS)
    fabric = dist.LocalFabric(n_shards, device=dev)
    cfg0 = dataclasses.replace(FULL_WALK, bias_beta=0.0)
    server_key = prng.key(SEED, dev)

    # 12. full-width parity: 8 requests, sharded vs unsharded, bit for bit
    ids = SHARDED_PARITY_REQUESTS
    pins, weights, feats = padded_batch([reqs[i] for i in ids], shape.n_slots, dev)
    keys = prng.fold_in(server_key, torch.tensor(ids, device=dev))
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t = time.perf_counter()
    got = service.serve_batch(shg, pins, weights, feats, keys, cfg0,
                              with_stats=True, fabric=fabric, slack=SHARDED_SLACK)
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t) * 1e3
    parity_launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    t = time.perf_counter()
    want = service.serve_batch(graph, pins, weights, feats, keys, cfg0,
                               with_stats=True)
    torch.cuda.synchronize()
    unsharded_ms = (time.perf_counter() - t) * 1e3
    if int(got[4]) != 0:
        raise AssertionError(f"sharded parity run dropped {int(got[4])} walkers")
    assert_same(got[:4], want, "16-way sharded vs unsharded")
    early = int((got[3] > cfg0.n_p).sum())
    if not early:
        raise AssertionError("sharded parity: early stop never fired")
    for i in range(len(ids)):
        check_result(got[0][i], got[1][i], cfg0.top_k, graph.n_pins, f"sharded {ids[i]}")
    for name in ("walk_hop_fused", "visit_counter_update_high", "walk_bits"):
        if parity_launches[name] == 0:
            raise AssertionError(f"the sharded parity run never launched {name}")
    log("sharded_parity", requests=ids, identical=True, dropped=0,
        slack=SHARDED_SLACK, early_stopped_rows=early,
        steps_taken=got[2].sum(1).tolist(), n_high=got[3].sum(1).tolist(),
        sharded_batch_ms=sharded_ms, unsharded_per_query_ms=unsharded_ms,
        peak_gb=peak, launches=parity_launches)
    del got, want
    torch.cuda.empty_cache()

    # 13. the production recipe: kernel path == plain path, drops included
    wcfg = dist._wrapper_walk_config(SHARDED_WALK, n_shards)
    plain_cfg = dataclasses.replace(wcfg, backend="xla")
    lat, drops, occs, captured = [], [], [], {}
    real_hop = ops.walk_hop
    recipe_launches = dict.fromkeys(_build.launches, 0)
    for rid in range(8):
        qp, qw, _ = padded_batch([reqs[rid]], shape.n_slots, dev)
        key = prng.fold_in(server_key, rid)
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        top = dist.pixie_walk_sharded(shg, qp[0], qw[0], key, SHARDED_WALK, fabric)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        for name, n in _build.launches.items():
            recipe_launches[name] += n
        calls = []

        def recording_hop(*args, use_kernel, **kw):
            # the routed buffers of superstep 8's two hops and the chunk's
            # word table, as the engine hands them over (none is written to
            # after the call)
            if rid == 0 and len(calls) in (16, 17):
                captured[len(calls)] = hop_args(*args, **kw)
            calls.append(None)
            return real_hop(*args, use_kernel=use_kernel, **kw)

        ops.walk_hop = recording_hop
        try:
            runs = [dist.pixie_walk_sharded_batched(
                shg, qp, qw, prng.split(key, 1), c, fabric,
                slack=SHARDED_WALK.slack) for c in (wcfg, plain_cfg)]
        finally:
            ops.walk_hop = real_hop
        a, b = runs
        for name, x in a._asdict().items():
            y = getattr(b, name)
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                raise AssertionError(f"recipe request {rid}: {name} differs between kernel and plain paths")
        sc, ids_k = dist._hierarchical_topk(a.counts, n_shards, 1, shape.n_slots,
                                            shg.pins_per_shard, SHARDED_WALK.top_k, fabric)
        if not (torch.equal(sc[0], top.top_scores) and torch.equal(ids_k[0], top.top_pins)):
            raise AssertionError(f"recipe request {rid}: entry point differs from the engine")
        check_result(top.top_scores, top.top_pins, SHARDED_WALK.top_k, graph.n_pins,
                     f"recipe {rid}")
        drops.append(int(a.dropped))
        occs.append(int(a.max_occupancy))
        del runs, a, b
    if recipe_launches["walk_hop_fused"] == 0:
        raise AssertionError("the production recipe never launched walk_hop_fused")
    log("sharded_recipe", recipe=dataclasses.asdict(SHARDED_WALK), n_shards=n_shards,
        walkers=wcfg.n_walkers, capacity=SHARDED_WALK.capacity(n_shards),
        requests=8, p50_ms=float(np.percentile(lat, 50)), max_ms=float(np.max(lat)),
        latencies_ms=lat, dropped=drops, max_occupancy=occs,
        kernel_equals_plain=True, launches=recipe_launches)

    # 15. the hop kernel against its twin at the production shapes
    hops = [captured[i] for i in (16, 17)]
    timed = [time_hop(h, w, read_ns)
             for h, w in zip(hops, ("pin->board", "board->pin"))]
    n_edge = hop_edge_cases(shg, dev)
    hop_row = dict(
        name="walk_hop_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/walk_hop.cu",
        replaces="src/repro/kernels/walk_step.py:760",
        launches=None, max_abs_err=0,
        **{k: (timed[0][k] + timed[1][k]) / 2
           for k in ("ms", "plain_ms", "bound_ms", "chain_floor_ms")},
        bound_by="bytes", library_ms=None,
    )
    log("hop_kernel", superstep=8, identical=True, edge_cases_identical=n_edge,
        row_is="one launch: the mean of one superstep's two hops, all 16 "
               "shards per launch",
        library="none: no single torch call computes the hop")

    # the word-table kernel at the sharded replica's chunk (one request,
    # FULL_WALK's walkers and chunk), and at the parity batch's
    sk = prng.fold_in(server_key, torch.arange(len(ids), device=dev))
    kbits = walk_lib._key_bits(sk, dev)
    bits = check_bits_kernel(kbits[:1], cfg0.chunk_steps, cfg0.n_walkers,
                             "one request")
    check_bits_kernel(kbits, cfg0.chunk_steps, cfg0.n_walkers,
                      f"{len(ids)} requests")
    bits_row = dict(
        name="walk_bits", route="cuda",
        source="src/repro_torch/kernels/csrc/walk_bits.cu",
        replaces="src/repro/core/walk.py:262 (_chunk_rbits: jax.random, "
                 "no Pallas kernel)",
        launches=None, max_abs_err=0, library_ms=None, **bits,
    )

    # 14. the sharded replica: healthy, one shard killed, revived
    def serve_all(srv):
        out = []
        for rid, (p, w, f) in enumerate(reqs):
            srv.submit(p, w, user_feat=f, req_id=rid)
            srv.pump()
            out += srv.harvest()
        torch.cuda.synchronize()
        return sorted(out, key=lambda r: r.req_id)

    srv = PixieServer(shg, cfg0, buckets=[(1, shape.n_slots)], seed=SEED,
                      fabric=fabric, slack=SHARDED_SLACK)
    _build.reset_launches()
    healthy = serve_all(srv)
    server_launches = dict(_build.launches)
    hlat = [r.latency_ms for r in healthy]
    victim, at = 3, 8
    srv.kill_shard(victim, at_superstep=at)
    killed = serve_all(srv)
    n_killed = srv.stats.killed
    if n_killed <= 0:
        raise AssertionError("a shard died at superstep 8 and no walker was killed")
    dead = torch.full((n_shards,), dist.NEVER_DIES, dtype=torch.int32, device=dev)
    dead[victim] = at
    for r in killed:
        batch = padded_batch([reqs[r.req_id]], shape.n_slots, dev)
        s_o, i_o = service.serve_batch(
            shg, *batch, prng.fold_in(server_key, r.req_id)[None, :], cfg0,
            fabric=fabric, slack=SHARDED_SLACK, shard_dead_at=dead)
        if not (np.array_equal(s_o[0].cpu().numpy(), r.scores)
                and np.array_equal(i_o[0].cpu().numpy(), r.ids)):
            raise AssertionError(f"killed request {r.req_id}: replica differs from the shard_dead_at oracle")
    overlap = overlap_at_k(np.stack([r.ids for r in killed]),
                           np.stack([r.ids for r in healthy]))
    srv.revive_shards()
    revived = serve_all(srv)
    assert_results_equal(revived, healthy, "revived vs healthy")
    sharded_ops = profile_request(srv, reqs[0], len(reqs),
                                  trace="chip_smoke_sharded_trace.json")
    log("sharded_server", requests=len(healthy), p50_ms=float(np.percentile(hlat, 50)),
        max_ms=float(np.max(hlat)), latencies_ms=hlat,
        killed_p50_ms=float(np.percentile([r.latency_ms for r in killed], 50)),
        victim=victim, at_superstep=at, killed=n_killed,
        route_dropped=srv.stats.route_dropped, overlap_at_k=overlap,
        oracle_identical=True, revived_identical=True, launches=server_launches)

    # 14b. open loop with seeded shard deaths, replayed twice
    oreqs = traffic.poisson_requests(
        connected_pins(graph, 1024), traffic.OpenLoopConfig(
            offered_qps=0.5 * 1000.0 / float(np.percentile(hlat, 50)),
            n_requests=24, seed=SEED, max_pins=shape.n_slots, n_feats=4))
    faults = traffic.sample_fault_schedule(traffic.ChaosConfig(
        horizon_s=oreqs[-1].t_arrival, seed=SEED, n_shard_deaths=2,
        n_shards=n_shards, death_max_superstep=16))
    reps = []
    _build.reset_launches()
    for _ in range(2):
        osrv = PixieServer(shg, cfg0, buckets=[(1, shape.n_slots)], seed=SEED,
                           fabric=fabric, slack=SHARDED_SLACK)
        reps.append((traffic.run_open_loop(osrv, oreqs, faults=faults), osrv))
        if len(reps) == 1:
            open_launches = dict(_build.launches)
    (a, sa), (b, sb) = reps
    if sorted(a.results) != sorted(b.results) or sa.dead_shards() != sb.dead_shards():
        raise AssertionError("sharded open loop: the replay served other requests")
    assert_results_equal([a.results[k] for k in sorted(a.results)],
                         [b.results[k] for k in sorted(b.results)],
                         "sharded open-loop replay")
    if not sa.dead_shards() or sa.stats.killed != sb.stats.killed:
        raise AssertionError("sharded open loop: deaths did not replay")
    log("sharded_open_loop", requests=len(oreqs), served=a.n_served,
        deaths=[[e.shard, e.at_superstep, e.t_start] for e in faults.of_kind("shard_death")],
        dead_shards=sa.dead_shards(), killed=sa.stats.killed,
        route_dropped=sa.stats.route_dropped, replay_identical=True,
        offered_qps=a.offered_qps, achieved_qps=a.achieved_qps,
        p50_ms=a.percentile(50), p99_ms=a.percentile(99), launches=open_launches)
    del shg, srv, osrv, reps, captured, hops
    torch.cuda.empty_cache()
    return ([hop_row, bits_row],
            [parity_launches, recipe_launches, server_launches, open_launches],
            sharded_ops)


def nccl_fabric(sg, dev) -> None:
    """Phase 16: ProcessGroupFabric over NCCL on one rank (a TCP store on
    localhost) equals LocalFabric(1) on the 20k graph, and the mega-table's
    ``lookup_sharded`` over it equals ``lookup``; board counts of the
    4-way sharded walk equal the unsharded engine's."""
    import datetime
    import socket

    import torch
    import torch.distributed as tdist
    from repro_torch.configs import dlrm_rm2
    from repro_torch.core import counter, distributed as dist, prng, walk
    from repro_torch.models import embedding

    cfg = walk.WalkConfig(n_steps=20_000, n_walkers=512, chunk_steps=4, n_p=300,
                          n_v=3, bias_beta=0.0, count_boards=True, backend="pallas")
    from repro_torch.graphs import synthetic

    qs = synthetic.top_degree_pins(sg, 16)
    pins = torch.as_tensor(qs[:12].reshape(3, 4).astype(np.int32), device=dev)
    weights = torch.full((3, 4), 0.5, device=dev)
    keys = prng.split(prng.key(SEED + 6, dev), 3)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                             world_size=1, rank=0,
                             timeout=datetime.timedelta(seconds=120))
    try:
        shg1 = dist.shard_graph(sg.graph, 1)
        runs = [dist.pixie_walk_sharded_batched(shg1, pins, weights, keys, cfg, f, slack=2.0)
                for f in (dist.ProcessGroupFabric(device=dev), dist.LocalFabric(1, device=dev))]
        tops = [dist._hierarchical_topk(r.counts, 1, 3, 4, shg1.pins_per_shard, 50, f)
                for r, f in zip(runs, (dist.ProcessGroupFabric(device=dev), None))]
        # the recsys mega-table's sharded lookup over the same one-rank group
        tcfg = dlrm_rm2.SMOKE.table
        table = embedding.init_table(torch.Generator(device=dev).manual_seed(SEED + 16), tcfg)
        rng = np.random.default_rng(SEED + 16)
        ids = torch.as_tensor(np.stack([rng.integers(0, r, 512) for r in tcfg.feature_rows],
                                       1).astype(np.int32), device=dev)
        pg_rows = embedding.lookup_sharded(table, ids, tcfg, dist.ProcessGroupFabric(device=dev))
        torch.cuda.synchronize()
    finally:
        tdist.destroy_process_group()
    if not torch.equal(pg_rows, embedding.lookup(table, ids, tcfg)):
        raise AssertionError("NCCL fabric: lookup_sharded differs from lookup")
    for name, x in runs[0]._asdict().items():
        y = getattr(runs[1], name)
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            raise AssertionError(f"NCCL fabric: {name} differs from LocalFabric(1)")
    if not all(torch.equal(x, y) for x, y in zip(*tops)):
        raise AssertionError("NCCL fabric: top-k differs from LocalFabric(1)")
    shg4 = dist.shard_graph(sg.graph, 4)
    res4 = dist.pixie_walk_sharded_batched(shg4, pins, weights, keys, cfg,
                                           dist.LocalFabric(4, device=dev), slack=8.0)
    flat = walk.pixie_random_walk_batched(
        sg.graph, pins, weights, torch.zeros(3, dtype=torch.int32, device=dev), keys, cfg)
    folded = counter.fold_sharded_counts(res4.board_counts, 3, 4, shg4.boards_per_shard)
    if int(res4.dropped) or not torch.equal(folded[..., :sg.graph.n_boards], flat.board_counts):
        raise AssertionError("4-way sharded board counts differ from the unsharded engine's")
    log("nccl_fabric", backend="nccl", world_size=1, identical_to_local=True,
        lookup_sharded_identical=True, board_counts_4way_identical=True, board_visits=int(flat.board_counts.sum()))


# ---------------------------------------------------------------------------
# Phases 17-20: dense-LM decode serving (Qwen2.5-3B and SmolLM-360M)
# ---------------------------------------------------------------------------

LM_BATCH = 4
LM_PROMPT = 512
LM_NEW_TOKENS = 32
SMOLLM_PROMPT = 128
SMOLLM_NEW_TOKENS = 16
# the reference's decode_32k cell (repro/configs/registry.py LM_SHAPES) is
# 128 sequences of 32,768 tokens; 128 x 32,768 x 36,864 bytes of bf16 cache
# is 154.6 GB, more than one card holds, so the batch is cut to 16 (19.3 GB)
DECODE_32K = dict(seq_len=32_768, batch=16, reference_batch=128)
F32_PEAK_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
ATTN_TOL = 2e-6            # kernel vs twin, absolute, on the float32 output
ATTN_EDGE_CASES = [        # (b, h, kh, dh, s, lengths, cache dtype)
    (2, 8, 2, 64, 300, 1, "float32"),            # length 1
    (4, 16, 2, 128, 544, "ragged", "bfloat16"),  # ragged lengths, group 8
    (3, 15, 5, 64, 700, 131, "float32"),         # not a tile multiple, group 3
    (2, 24, 8, 128, 1000, "ragged", "bfloat16"), # group 3, dh 128
    (2, 16, 2, 128, 4096, 4095, "float32"),      # group 8, dh 128
    (2, 6, 2, 16, 40, 33, "bfloat16"),           # dh 16, the smoke configs'
    (2, 3, 1, 20, 70, "ragged", "float32"),      # dh 20, not a multiple of 32
]


def attn_inputs(dev, b, h, kh, dh, s, lengths, kv_dtype, q_dtype, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, dh), generator=g, device=dev).to(q_dtype)
    k = torch.randn((b, s, kh, dh), generator=g, device=dev).to(kv_dtype)
    v = torch.randn((b, s, kh, dh), generator=g, device=dev).to(kv_dtype)
    if lengths == "ragged":
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                                dtype=torch.int32)
        lengths[0] = s
    return q, k, v, lengths


def check_attn(q, k, v, lengths, what: str) -> float:
    """The decode-attention kernel against its twin on the same inputs:
    max abs difference, which must stay within ATTN_TOL."""
    import torch
    from repro_torch.kernels import decode_attention as da

    got = da.decode_attention(q, k, v, lengths)
    want = da.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"decode_attention {what}: bad output")
    err = float((got - want).abs().max())
    if err > ATTN_TOL:
        raise AssertionError(f"decode_attention {what}: max err {err} > {ATTN_TOL}")
    return err


def attn_bound(q, k, lengths) -> dict:
    """The least time for this call: its bytes (``call_cost``, K and V read
    once up to each row's length) over the HBM rate, its float32
    multiply-adds (scores and p @ V) over the float32 peak."""
    b = q.shape[0]
    lens = ([int(lengths)] * b if isinstance(lengths, int)
            else [int(x) for x in lengths.tolist()])
    return cost_bound(q, k, sum(lens), partial=False, per_row=not isinstance(lengths, int))


def cost_bound(q, k, n_pos: int, *, partial: bool, per_row: bool) -> dict:
    """``decode_attention.call_cost``'s bytes over the HBM rate and FLOPs
    over the float32 peak: the larger is the bound."""
    from repro_torch.kernels.decode_attention import call_cost

    nbytes, flops = call_cost(q, k, n_pos, partial=partial, per_row=per_row)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_PEAK_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, flops=flops)


def sdpa_yardstick(q, k, v, lengths):
    """One PyTorch call computing the same function, timed beside the
    kernel and never served with: scaled_dot_product_attention with
    enable_gqa over (b, heads, s, dh) views of the cache; the length mask
    is passed only where some row is shorter than the cache (an all-true
    mask would only push SDPA onto a slower backend)."""
    import torch
    import torch.nn.functional as F

    b, h, dh = q.shape
    s = k.shape[1]
    qs = q.to(k.dtype)[:, :, None, :]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = None
    if isinstance(lengths, int):
        if lengths < s:
            mask = (torch.arange(s, device=k.device) < lengths)[None, None, None, :]
    elif bool((lengths < s).any()):
        mask = (torch.arange(s, device=k.device)[None, :] < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def time_attn(q, k, v, lengths, what: str) -> dict:
    """Device ms of the kernel (back to back), its twin's ms, SDPA's ms
    and the bound, on one call's inputs (``lengths`` an int: the wrapper
    then never synchronises), with the kernel's split plan; two calls on
    the same inputs must give the same bits."""
    import torch
    from repro_torch.kernels import decode_attention as da

    err = check_attn(q, k, v, lengths, what)
    if not torch.equal(da.decode_attention(q, k, v, lengths),
                       da.decode_attention(q, k, v, lengths)):
        raise AssertionError(f"decode_attention {what}: two runs differ")
    b, h, dh = q.shape
    plan = da.plan(b, h, k.shape[2], dh, k.dtype,
                   lengths if isinstance(lengths, int) else k.shape[1])
    row = dict(
        ms=device_ms(lambda: da.decode_attention(q, k, v, lengths), 20),
        plain_ms=cuda_ms(lambda: da.decode_attention_plain(q, k, v, lengths), 3),
        library_ms=device_ms(sdpa_yardstick(q, k, v, lengths), 20),
        max_abs_err=err, **attn_bound(q, k, lengths))
    log("attn_timing", what=what, q=list(q.shape), k=list(k.shape),
        cache_dtype=str(k.dtype), lengths=lengths, splits=plan.n_splits,
        split_len=plan.split_len, ctas=plan.ctas,
        kernel_over_sdpa=row["ms"] / row["library_ms"],
        share_of_bound=row["bound_ms"] / row["ms"], **row)
    return row


def capture_attention(fn):
    """Run ``fn`` with the decode step's attention op wrapped so that its
    first call's inputs are kept: ``(result of fn, (q, k, v, lengths))``.
    k and v stay views of the cache's layer 0."""
    from repro_torch.kernels import ops

    real, seen = ops.decode_attention, []

    def spy(q, k, v, lengths, *, use_kernel):
        if not seen:
            seen.append((q.clone(), k, v, lengths))
        return real(q, k, v, lengths, use_kernel=use_kernel)

    ops.decode_attention = spy
    try:
        out = fn()
    finally:
        ops.decode_attention = real
    return out, seen[0]


def lockstep_logits(params, cfg, prompt, n_new: int, temperature: float = 0.0,
                    key=None) -> list:
    """Prefill once, then decode on the kernel path and the plain path side
    by side, both fed the kernel path's token (greedy, or sampled as
    ``decode.generate`` samples with ``temperature`` and ``key``): the max
    |logit difference| per step; the tokens must agree at every step."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serving import decode

    logits, cache_k = transformer.prefill(params, prompt, cfg,
                                          max_seq=prompt.shape[1] + n_new)
    cache_p = {name: t.clone() for name, t in cache_k.items()}
    cur = decode._sample(logits, temperature, key, 0)
    diffs = []
    for i in range(n_new - 1):
        pos = prompt.shape[1] + i
        lk, cache_k = transformer.decode_step(params, cache_k, cur, pos, cfg)
        lp, cache_p = transformer.decode_step(params, cache_p, cur, pos, cfg,
                                              backend="xla")
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"{cfg.name}: step {i} logits not finite")
        diffs.append(float((lk - lp).abs().max()))
        cur = decode._sample(lk, temperature, key, i + 1)
        if not torch.equal(cur, decode._sample(lp, temperature, key, i + 1)):
            raise AssertionError(f"{cfg.name}: tokens differ at step {i}")
    return diffs


def generate_both(params, cfg, prompt, n_new: int, what: str, identical=True,
                  **sample):
    """Generate (greedy, or with ``sample``'s temperature and key) on the
    kernel path (its launches counted) and on the plain path; the tokens
    must be in range and, with ``identical``, equal.
    Returns the kernel path's tokens, its launches, its wall seconds and
    the share of generated tokens the two paths agree on.  In bf16 the two
    attention outputs round to different bf16 values, so the paths may
    part; in float32 they must not."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving import decode

    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    toks = decode.generate(params, prompt, cfg, max_new_tokens=n_new, **sample)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = dict(_build.launches)
    plain = decode.generate(params, prompt, cfg, max_new_tokens=n_new,
                            backend="xla", **sample)
    torch.cuda.synchronize()
    if _build.launches["decode_attention"] != launches["decode_attention"]:
        raise AssertionError(f"{what}: the plain path launched the kernel")
    b, s0 = prompt.shape
    if toks.shape != (b, s0 + n_new) or not torch.equal(toks[:, :s0], prompt):
        raise AssertionError(f"{what}: generated tokens have the wrong shape")
    new = toks[:, s0:]
    if int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
        raise AssertionError(f"{what}: a generated token is outside the vocabulary")
    if identical and not torch.equal(toks, plain):
        raise AssertionError(f"{what}: kernel and plain paths generate different tokens")
    agree = float((new == plain[:, s0:]).float().mean())
    return toks, launches, wall_s, agree


TRACE_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the profiler's own CUPTI overheads ("Activity Buffer Request", "Command
# Buffer Full"): written on no thread, counted by key_averages as host
# operations of the profiling thread
TRACE_OVERHEAD_CAT = "overhead"


def trace_summary(prof) -> tuple:
    """A finished profile's device and host operations by name, ``{name:
    [count, microseconds]}``: each device operation's duration, and each
    host operation's self time, the sums ``key_averages()`` gives (held
    equal on the card by ``summary_check``).  Read from the chrome trace
    kineto writes in C++: Python's own parse of a training step's ~700k
    events (``key_averages``, ``events``) takes minutes.  The host tree is
    torch's (``EventList._populate_cpu_children`` and
    ``_remove_dup_nodes``): on each thread, by start, an op is the child
    of the innermost open op that holds its whole interval; an op's only
    child of the same name is folded into it, its children lifted; self
    time is an op's duration less its children's."""
    import collections
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    device = collections.defaultdict(lambda: [0, 0.0])
    host = collections.defaultdict(lambda: [0, 0.0])
    threads = collections.defaultdict(list)
    overheads, first = [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in TRACE_DEVICE_CATS:
            d = device[e["name"]]
            d[0] += 1
            d[1] += e["dur"]
            continue
        if cat not in TRACE_HOST_CATS and cat != TRACE_OVERHEAD_CAT:
            continue
        # integer nanoseconds: exact, where the sum of two microsecond
        # floats near 1e12 is not
        start = round(e["ts"] * 1000)
        op = (start, start + round(e["dur"] * 1000), e["name"])
        if cat == TRACE_OVERHEAD_CAT:
            overheads.append(op)
            continue
        key = (e["pid"], e["tid"])
        threads[key].append(op)
        if cat == "cpu_op" and (first is None or start < first[0]):
            first = (start, key)
    if overheads and first is not None:
        threads[first[1]].extend(overheads)
    for ops in threads.values():
        ops.sort(key=lambda op: (op[0], -op[1]))
        stack = []              # open ops: [end, name, duration, children, self time]

        def close(node):
            kids = node[3]
            while len(kids) == 1 and kids[0][1] == node[1]:
                host[node[1]][0] -= 1         # folded: no op of its own
                host[node[1]][1] -= kids[0][4]
                kids = kids[0][3]
            node[3], node[4] = kids, node[2] - sum(k[2] for k in kids)
            host[node[1]][0] += 1
            host[node[1]][1] += node[4]

        for start, end, name in ops:
            while stack and (start >= stack[-1][0] or end > stack[-1][0]):
                close(stack.pop())
            node = [end, name, (end - start) / 1000, [], 0.0]
            if stack:
                stack[-1][3].append(node)
            stack.append(node)
        while stack:
            close(stack.pop())
    return device, host


SUMMARY_REL_TOL = 1e-6     # trace_summary against key_averages, microseconds


def summary_check(prof, device: dict, host: dict) -> dict:
    """``trace_summary``'s sums against ``key_averages()``'s on the same
    card profile: every device and host operation's count equal, its
    device time and host self time within ``SUMMARY_REL_TOL``.  Raises
    on a difference; returns the totals and each parse's seconds."""
    import torch

    t = time.perf_counter()
    events = prof.key_averages()
    kinds = torch.autograd.DeviceType
    ka = {"device": {e.key: (e.count, e.self_device_time_total) for e in events
                     if e.device_type == kinds.CUDA},
          "host": {e.key: (e.count, e.self_cpu_time_total) for e in events
                   if e.device_type == kinds.CPU}}
    ka_s = time.perf_counter() - t
    wrong = []
    for side, ours in (("device", device), ("host", host)):
        theirs = ka[side]
        for name in set(theirs) | set(ours):
            a, b = theirs.get(name, (0, 0.0)), ours.get(name, (0, 0.0))
            if a[0] != b[0] or abs(a[1] - b[1]) > SUMMARY_REL_TOL * max(1.0, abs(a[1])):
                wrong.append((side, name, tuple(b), tuple(a)))
    if wrong:
        raise AssertionError(f"trace_summary against key_averages (side, op, ours, "
                             f"theirs): {wrong[:12]}")
    return dict(device_ops=sum(n for n, _ in device.values()),
                device_us=sum(us for _, us in device.values()),
                host_ops=sum(n for n, _ in host.values()),
                host_us=sum(us for _, us in host.values()),
                names=len(device) + len(host), key_averages_s=ka_s, rel_tol=SUMMARY_REL_TOL)


def profile_decode_step(fn, check: bool = False, host: bool = True) -> dict:
    """One step (a decode step, a train step) under torch.profiler: wall
    ms, device busy ms and the idle share, the device operations it
    issued, and the host operations that took the most host time (self
    time, profiler overhead included).  ``check``: ``summary_check`` too.
    Without ``host`` only the device is traced (its launches the only host
    operations): a step of ~10^6 host operations exports and parses in a
    fraction of the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if host else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    device, host = trace_summary(prof)
    parse_s = time.perf_counter() - t
    checked = summary_check(prof, device, host) if check else None
    busy = sum(us for _, us in device.values()) / 1e3
    kernels = sorted(device.items(), key=lambda kv: -kv[1][1])
    hosts = sorted(host.items(), key=lambda kv: -kv[1][1])
    return dict(wall_ms=wall, device_busy_ms=busy,
                device_idle_share=max(0.0, 1 - busy / wall) if wall else None,
                device_ops=sum(n for n, _ in device.values()),
                top=[dict(kernel=k[:80], count=n, ms=us / 1e3) for k, (n, us) in kernels[:6]],
                top_host=[dict(op=k[:80], count=n, ms=us / 1e3) for k, (n, us) in hosts[:8]],
                **({} if checked is None else dict(summary_check=dict(
                    checked, trace_summary_s=parse_s))))


def lm_phases(dev, qwen, smollm, lm_batch=LM_BATCH, prompt_len=LM_PROMPT,
              new_tokens=LM_NEW_TOKENS, smollm_prompt=SMOLLM_PROMPT,
              smollm_new=SMOLLM_NEW_TOKENS, long=DECODE_32K):
    """Phases 17-20 (see the module docstring); returns the kernels-line
    row of decode_attention and the launch counts of the three LM paths."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)

    # 17. the kernel against its twin at edge shapes
    errs = []
    for i, (b, h, kh, dh, s, lengths, kv) in enumerate(ATTN_EDGE_CASES):
        for q_dtype in (torch.float32, getattr(torch, kv)):
            q, k, v, lens = attn_inputs(dev, b, h, kh, dh, s, lengths,
                                        getattr(torch, kv), q_dtype, SEED + i)
            errs.append(check_attn(q, k, v, lens, f"edge case {i}"))
    log("attn_kernel", cases=len(errs), max_abs_err=max(errs), tolerance=ATTN_TOL,
        shapes=[list(c) for c in ATTN_EDGE_CASES])
    del q, k, v, lens

    # 18. Qwen2.5-3B at full width in float32: kernel path == plain path
    cfg32 = dataclasses.replace(qwen, **f32)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    prompt = torch.randint(0, qwen.vocab_size, (lm_batch, prompt_len), dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 1),
                           device=dev)
    _, f32_launches, f32_wall, _ = generate_both(params, cfg32, prompt, new_tokens,
                                                 "qwen f32")
    diffs = lockstep_logits(params, cfg32, prompt, new_tokens)
    log("lm_f32", model=qwen.name, n_layers=qwen.n_layers, d_model=qwen.d_model,
        vocab=qwen.vocab_size, params=qwen.param_count(), init_s=init_s,
        batch=lm_batch, prompt=prompt_len, new_tokens=new_tokens,
        tokens_identical=True, max_logit_diff_per_step=diffs,
        generate_s=f32_wall, launches=f32_launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    # 19. the serving dtypes (bf16 compute and cache): prefill, decode steps
    served = transformer.cast_for_serving(params, qwen)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    transformer.decode_step(served, transformer.prefill(served, prompt[:, :8], qwen,
                                                        max_seq=9)[1],
                            prompt[:, 8], 8, qwen)                     # warm-up
    toks, bf16_launches, bf16_wall, bf16_agree = generate_both(
        served, qwen, prompt, new_tokens, "qwen bf16", identical=False)
    out = {}
    prefill_ms = wall_ms(lambda: out.setdefault("p", transformer.prefill(
        served, prompt, qwen, max_seq=prompt_len + new_tokens)))
    cache = out["p"][1]
    step_ms = [wall_ms(lambda i=i: transformer.decode_step(
        served, cache, toks[:, prompt_len + i], prompt_len + i, qwen))
        for i in range(new_tokens)]
    prof = profile_decode_step(lambda: transformer.decode_step(
        served, cache, toks[:, -1], prompt_len + new_tokens - 1, qwen), check=True)
    # the kernel at the serving shape: layer 0 of the last step
    _, (q, k, v, lengths) = capture_attention(lambda: transformer.decode_step(
        served, cache, toks[:, -1], prompt_len + new_tokens - 1, qwen))
    serve_row = time_attn(q, k, v, lengths, f"serving batch {lm_batch} layer 0")
    del q, k, v
    p50 = float(np.percentile(step_ms, 50))
    log("lm_bf16", model=qwen.name, compute_dtype="bfloat16", cache_dtype="bfloat16",
        batch=lm_batch, prompt=prompt_len, new_tokens=new_tokens,
        prefill_ms=prefill_ms, decode_p50_ms=p50, decode_ms=step_ms,
        decode_tokens_per_s=lm_batch * 1e3 / p50,
        generate_s=bf16_wall, generate_tokens_per_s=lm_batch * new_tokens / bf16_wall,
        tokens_agreeing_with_plain=bf16_agree,
        attention_launches=bf16_launches["decode_attention"],
        launches=bf16_launches, profiled_step=prof,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del cache, out

    # 19b. decode_32k, cut: one decode step at position 32,767
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lb, ls = long["batch"], long["seq_len"]
    lcache = transformer.init_kv_cache(qwen, lb, ls, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    for t_ in lcache.values():
        t_.normal_(generator=g)
    ltoks = torch.randint(0, qwen.vocab_size, (lb,), dtype=torch.int32, generator=g, device=dev)
    step = lambda backend: transformer.decode_step(served, lcache, ltoks, ls - 1, qwen,
                                                   backend=backend)
    step("pallas")                                                     # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    long_ms = wall_ms(lambda: step("pallas"))
    long_launches = dict(_build.launches)
    long_plain_ms = wall_ms(lambda: step("xla"))
    (logits_k, _), (q, k, v, lengths) = capture_attention(lambda: step("pallas"))
    logits_p, _ = step("xla")
    torch.cuda.synchronize()
    row = time_attn(q, k, v, lengths, "decode_32k layer 0")
    long_prof = profile_decode_step(lambda: step("pallas"))
    log("decode_32k", model=qwen.name, seq_len=ls, batch=lb,
        cut=f"batch {lb} instead of {long['reference_batch']}: "
            f"{long['reference_batch']} x {ls} tokens x "
            f"{2 * qwen.n_layers * qwen.n_kv_heads * qwen.head_dim * 2} bytes of bf16 "
            "cache exceed one card",
        cache_gb=sum(t_.numel() * t_.element_size() for t_ in lcache.values()) / 1e9,
        step_ms=long_ms, plain_step_ms=long_plain_ms,
        max_logit_diff=float((logits_k - logits_p).abs().max()),
        launches=long_launches, profiled_step=long_prof,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    MEASURED["decode_32k_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del lcache, served, q, k, v, logits_k, logits_p
    torch.cuda.empty_cache()

    # 20. SmolLM-360M at full width in float32: pad heads on the card
    scfg = dataclasses.replace(smollm, **f32)
    torch.cuda.reset_peak_memory_stats()
    sparams = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED + 3), scfg)
    sprompt = torch.randint(0, smollm.vocab_size, (lm_batch, smollm_prompt), dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 4),
                            device=dev)
    _, small_launches, small_wall, _ = generate_both(sparams, scfg, sprompt, smollm_new,
                                                     "smollm f32")
    sdiffs = lockstep_logits(sparams, scfg, sprompt, smollm_new)
    log("lm_smollm", model=smollm.name, n_heads=smollm.n_heads,
        n_heads_padded=smollm.n_heads_padded, batch=lm_batch, prompt=smollm_prompt,
        new_tokens=smollm_new, tokens_identical=True, max_logit_diff_per_step=sdiffs,
        generate_s=small_wall, launches=small_launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del sparams
    torch.cuda.empty_cache()

    paths = [f32_launches, bf16_launches, long_launches, small_launches]
    if any(p["decode_attention"] == 0 for p in paths):
        raise AssertionError(f"an LM phase never launched decode_attention: {paths}")
    row = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:80",
        launches=None,
        max_abs_err=max(row["max_abs_err"], serve_row["max_abs_err"], *errs),
        **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
    )
    return row, paths


# ---------------------------------------------------------------------------
# Phases 30-32: MoE LM serving (granite, deepseek) and the GIN model
# ---------------------------------------------------------------------------

MOE_TEMPERATURE = 0.7
MOE_F32_LIMIT_GB = 76.0    # the float32 phase's reckoned peak must stay under this
GIN_TOL = 2e-6             # card vs CPU port, times max(1, the CPU's largest |value|)
REDDIT_BATCH, REDDIT_FANOUT = 1024, (15, 10)   # registry.py minibatch_lg
MOLECULE_BATCH = 128                           # registry.py molecule


def moe_reckon_gb(cfg, dtype, batch: int, prompt_len: int, max_seq: int) -> dict:
    """The peak a decode phase reckons from its config, before it runs:
    the weights in ``dtype`` (the router in float32), two KV caches (the
    lockstep check holds one per path), and the larger of one MoE layer's
    prefill transients (the ``(E, cap, d)`` buffer, its gate/up/swiglu
    products in float32, the down product, the gathered tokens and their
    contributions) and one layer's float32 draw at init."""
    import torch

    m = cfg.moe
    size = torch.empty((), dtype=dtype).element_size()
    d, e, ff = cfg.d_model, m.n_experts_padded, m.d_ff_expert
    router = cfg.n_scan * d * e
    weights = (cfg.physical_param_count() - router) * size + router * 4
    cache = 2 * 2 * cfg.n_layers * batch * max_seq * cfg.n_kv_heads * cfg.head_dim * \
        torch.empty((), dtype=cfg.cache_dtype).element_size()
    t = batch * prompt_len
    cap = m.capacity(t)
    prefill = (3 * e * cap * d * size + 3 * e * cap * ff * 4
               + 2 * t * m.top_k * d * size)
    if cfg.first_dense_ff:
        prefill = max(prefill, 3 * t * cfg.first_dense_ff * 4)
    draw = (3 * e * d * ff + d * e) * 4
    return dict(weights_gb=gb(weights), caches_gb=gb(cache),
                transient_gb=gb(max(prefill, draw)),
                peak_gb=gb(weights + cache + max(prefill, draw)))


def moe_f32_config(cfg, lm_batch: int, prompt_len: int, max_seq: int) -> tuple:
    """The float32 config at full depth when the reckoning fits, else cut:
    ``(config, reckoning, cut or None)``."""
    import torch

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32, cache_dtype=torch.float32)
    reckon = moe_reckon_gb(cfg32, torch.float32, lm_batch, prompt_len, max_seq)
    cut = None
    while reckon["peak_gb"] > MOE_F32_LIMIT_GB:
        cfg32 = dataclasses.replace(cfg32, n_layers=cfg32.n_layers - 1)
        reckon = moe_reckon_gb(cfg32, torch.float32, lm_batch, prompt_len, max_seq)
        cut = (f"float32 depth {cfg32.n_layers} of {cfg.n_layers}: the reckoned "
               f"peak at full depth passes {MOE_F32_LIMIT_GB} GB")
    return cfg32, reckon, cut


def moe_model(dev, cfg, seed: int, prompt_len: int, lm_batch: int, new_tokens: int,
              what: str) -> tuple:
    """One MoE config on the card: float32 (kernel path == plain path,
    greedy and sampled, the card's gumbel noise == the CPU port's), then
    bf16 (prefill, decode p50, tokens/s, a profiled step, the attention
    kernel at layer 0 beside SDPA).  Returns (attention row, launches of
    the four driven paths, the float32 greedy tokens)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models import transformer

    max_seq = prompt_len + new_tokens
    gen = lambda: torch.Generator(device=dev).manual_seed(seed)
    prompt = moe_prompt(dev, cfg, seed, lm_batch, prompt_len)
    key = prng.key(seed + 2, dev)
    sample = dict(temperature=MOE_TEMPERATURE, key=key)

    cfg32, reckon, cut = moe_f32_config(cfg, lm_batch, prompt_len, max_seq)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = transformer.init_params(gen(), cfg32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    greedy, greedy_launches, greedy_s, _ = generate_both(params, cfg32, prompt,
                                                         new_tokens, f"{what} f32")
    greedy_diffs = lockstep_logits(params, cfg32, prompt, new_tokens)
    sampled, sampled_launches, sampled_s, _ = generate_both(
        params, cfg32, prompt, new_tokens, f"{what} f32 sampled", **sample)
    sampled_diffs = lockstep_logits(params, cfg32, prompt, new_tokens, **sample)
    shape = (lm_batch, cfg.vocab_padded)
    noise = prng.gumbel(prng.fold_in(key, 1), shape)
    host = prng.gumbel(prng.fold_in(prng.key(seed + 2, "cpu"), 1), shape)
    if not torch.equal(noise.cpu().view(torch.int32), host.view(torch.int32)):
        raise AssertionError(f"{what}: the card's gumbel noise differs from the CPU's")
    log(f"{what}_f32", model=cfg.name, n_layers=cfg32.n_layers, d_model=cfg.d_model,
        n_experts=cfg.moe.n_experts, n_experts_padded=cfg.moe.n_experts_padded,
        top_k=cfg.moe.top_k, n_shared=cfg.moe.n_shared, vocab=cfg.vocab_size,
        params=cfg.param_count(), physical_params=cfg32.physical_param_count(),
        active_params=cfg.active_param_count(), cut=cut, reckoned=reckon,
        init_s=init_s, batch=lm_batch, prompt=prompt_len, new_tokens=new_tokens,
        tokens_identical=True, max_logit_diff_per_step=greedy_diffs,
        sampled_tokens_identical=True, temperature=MOE_TEMPERATURE,
        sampled_max_logit_diff_per_step=sampled_diffs,
        sampled_differs_from_greedy=not torch.equal(sampled, greedy),
        gumbel_bits_equal_cpu=list(shape), generate_s=greedy_s,
        sampled_generate_s=sampled_s, launches=greedy_launches,
        sampled_launches=sampled_launches,
        peak_gb=gb(torch.cuda.max_memory_allocated()))
    del params, noise
    torch.cuda.empty_cache()

    # bf16 at full depth, drawn cast (a float32 tree never coexists)
    reckon = moe_reckon_gb(cfg, cfg.compute_dtype, lm_batch, prompt_len, max_seq)
    torch.cuda.reset_peak_memory_stats()
    served = transformer.init_params(gen(), cfg, dtype=cfg.compute_dtype)
    transformer.decode_step(served, transformer.prefill(served, prompt[:, :8], cfg,
                                                        max_seq=9)[1],
                            prompt[:, 8], 8, cfg)                       # warm-up
    toks, bf16_launches, bf16_wall, bf16_agree = generate_both(
        served, cfg, prompt, new_tokens, f"{what} bf16", identical=False)
    _, sampled_bf16_launches, _, sampled_agree = generate_both(
        served, cfg, prompt, new_tokens, f"{what} bf16 sampled", identical=False,
        **sample)
    out = {}
    prefill_ms = wall_ms(lambda: out.setdefault("p", transformer.prefill(
        served, prompt, cfg, max_seq=max_seq)))
    cache = out["p"][1]
    step_ms = [wall_ms(lambda i=i: transformer.decode_step(
        served, cache, toks[:, prompt_len + i], prompt_len + i, cfg))
        for i in range(new_tokens)]
    last = prompt_len + new_tokens - 1
    prof = profile_decode_step(lambda: transformer.decode_step(
        served, cache, toks[:, -1], last, cfg))
    keying = route_keying_cost(lambda: transformer.decode_step(
        served, cache, toks[:, -1], last, cfg), cfg, prof)
    _, (q, k, v, lengths) = capture_attention(lambda: transformer.decode_step(
        served, cache, toks[:, -1], last, cfg))
    attn_row = time_attn(q, k, v, lengths, f"{cfg.name} batch {lm_batch} layer 0")
    p50 = float(np.percentile(step_ms, 50))
    log(f"{what}_bf16", model=cfg.name, compute_dtype="bfloat16", cache_dtype="bfloat16",
        n_layers=cfg.n_layers, reckoned=reckon, batch=lm_batch, prompt=prompt_len,
        new_tokens=new_tokens, prefill_ms=prefill_ms, decode_p50_ms=p50,
        decode_ms=step_ms, decode_tokens_per_s=lm_batch * 1e3 / p50,
        generate_s=bf16_wall, generate_tokens_per_s=lm_batch * new_tokens / bf16_wall,
        tokens_agreeing_with_plain=bf16_agree,
        sampled_tokens_agreeing_with_plain=sampled_agree,
        attention_launches=bf16_launches["decode_attention"],
        launches=bf16_launches, profiled_step=prof, router_keying=keying,
        weights_floor_ms=reckon["weights_gb"] * 1e9 / HBM_BYTES_PER_S * 1e3,
        peak_gb=gb(torch.cuda.max_memory_allocated()))
    del served, cache, out, q, k, v
    torch.cuda.empty_cache()
    return attn_row, [greedy_launches, sampled_launches, bf16_launches,
                      sampled_bf16_launches], greedy


def route_keying_cost(step, cfg, prof: dict) -> dict:
    """The MoE router's keying pass (``counter.order_keys``: the one pass
    ``topk_total`` makes beyond ``topk_dense``) in one decode step: the
    step profiled again with each call under a ``record_function`` range,
    its calls and the device time of the kernels they launched, beside
    the step's device-busy time from ``prof``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import counter

    real = counter.order_keys

    def annotated(x):
        with record_function("moe_route_order_keys"):
            return real(x)

    counter.order_keys = annotated
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            step()
            torch.cuda.synchronize()
    finally:
        counter.order_keys = real
    # the host-side ranges: their device time is their kernels' (the
    # device-side annotation spans the gaps between launches too)
    ranges = [e for e in p.key_averages() if e.key == "moe_route_order_keys"
              and e.device_type == torch.autograd.DeviceType.CPU]
    kernel_ms = sum(e.device_time_total for e in ranges) / 1e3
    busy = prof["device_busy_ms"]
    return dict(calls=sum(e.count for e in ranges), moe_layers=cfg.n_scan,
                kernel_ms=kernel_ms, step_device_busy_ms=busy,
                share_of_busy=kernel_ms / busy if busy else None)


def moe_phases(dev, granite, deepseek, lm_batch=LM_BATCH, prompt_len=LM_PROMPT,
               new_tokens=LM_NEW_TOKENS) -> tuple:
    """Phases 30-31 (see the module docstring): ``(attention rows, launch
    counts of every driven path, {config name: (seed, float32 greedy
    tokens)})``; each path must launch the attention kernel."""
    rows, paths, greedy = [], [], {}
    for i, (cfg, what) in enumerate(((granite, "moe_granite"),
                                     (deepseek, "moe_deepseek"))):
        seed = moe_seed(i)
        row, p, toks = moe_model(dev, cfg, seed, prompt_len, lm_batch, new_tokens, what)
        rows.append(row)
        paths += p
        greedy[cfg.name] = (seed, toks.cpu())
    if any(p["decode_attention"] == 0 for p in paths):
        raise AssertionError(f"an MoE phase never launched decode_attention: {paths}")
    return rows, paths, greedy


def moe_seed(i: int) -> int:
    """The seed of phase 30 (granite, ``i`` 0) or 31 (deepseek, 1): its
    weights, and its prompt from ``seed + 1``."""
    return SEED + 10 * (i + 1)


def moe_prompt(dev, cfg, seed: int, lm_batch: int, prompt_len: int):
    import torch

    return torch.randint(0, cfg.vocab_size, (lm_batch, prompt_len), dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(seed + 1),
                         device=dev)


def gin_cases(scale: float = 1.0) -> list:
    """``(name, config, host arrays, cut)`` at the reference's GNN cells:
    full_graph_sm on ``cora_like()``, a minibatch_lg ``FanoutSampler``
    block of ``reddit_like(scale)`` and a molecule batch (sum readout)."""
    from repro_torch.configs import gin_tu
    from repro_torch.graphs import gnn_data, sampler

    cora = gnn_data.cora_like(seed=SEED)
    t = time.perf_counter()
    red = gnn_data.reddit_like(seed=SEED, scale=scale)
    n = red.feats.shape[0]
    csr = sampler.csr_from_edges(red.edge_src, red.edge_dst, n)
    seeds = np.random.default_rng(SEED).choice(n, REDDIT_BATCH, replace=False)
    block = sampler.FanoutSampler(csr, REDDIT_FANOUT, seed=SEED).sample(
        seeds.astype(np.int32), step=0)
    arr = sampler.block_to_arrays(block, red.feats, red.labels)
    reddit_s = time.perf_counter() - t
    mol = gnn_data.molecule_batch(batch=MOLECULE_BATCH, seed=SEED)
    return [
        ("full_graph_sm", gin_tu.FULL,
         dict(feats=cora.feats, edge_src=cora.edge_src, edge_dst=cora.edge_dst,
              labels=cora.labels, mask=cora.train_mask), None),
        ("minibatch_lg", dataclasses.replace(gin_tu.FULL, d_in=602, n_classes=41),
         dict(arr, graph_nodes=n, graph_edges=int(red.edge_src.size),
              build_s=reddit_s,
              block_nodes=int((block.nodes >= 0).sum()),
              block_edges=int((block.edge_src >= 0).sum())),
         None if scale == 1.0 else f"reddit_like nodes and edges x {scale}"),
        ("molecule", dataclasses.replace(gin_tu.FULL, d_in=16, n_classes=2,
                                         readout="sum"),
         dict(feats=mol.feats, edge_src=mol.edge_src, edge_dst=mol.edge_dst,
              graph_ids=mol.graph_ids, labels=mol.labels, n_graphs=MOLECULE_BATCH),
         None),
    ]


GIN_ARRAYS = ("feats", "edge_src", "edge_dst", "labels", "mask", "graph_ids")


def gin_loss(params, cfg, t: dict):
    """One case's loss; ``t`` holds its arrays as tensors on the
    parameters' device."""
    from repro_torch.models import gnn

    args = (t["feats"], t["edge_src"], t["edge_dst"])
    if cfg.readout == "sum":
        return gnn.graph_classification_loss(params, *args, t["graph_ids"], t["labels"],
                                             cfg, t["n_graphs"])
    return gnn.node_classification_loss(params, *args, t["labels"], t["mask"], cfg)


def gin_outputs(params, cfg, t: dict):
    """``(logits, loss)`` of one case (see ``gin_loss``)."""
    from repro_torch.models import gnn

    args = (t["feats"], t["edge_src"], t["edge_dst"])
    if cfg.readout == "sum":
        logits = gnn.forward(params, *args, cfg, graph_ids=t["graph_ids"],
                             n_graphs=t["n_graphs"])
    else:
        logits = gnn.forward(params, *args, cfg)
    return logits, gin_loss(params, cfg, t)


def gin_phase(dev, cases=None) -> dict:
    """Phase 32: each GIN case on the card against the CPU port on the same
    parameters (logits and loss within GIN_TOL times max(1, the CPU's
    largest magnitude)), two card calls the same bits, ms a forward on
    inputs already on the card (CUDA events around back-to-back calls; each
    ``segment_sum`` reads its depth from the card).  Returns the largest
    relative differences."""
    import torch
    from repro_torch.models import gnn

    assert_fp32_matmuls()
    errs = {}
    for i, (name, cfg, a, cut) in enumerate(cases or gin_cases()):
        params = gnn.init_params(torch.Generator(device=dev).manual_seed(SEED + 30 + i), cfg)
        host = {g: {k: v.cpu() for k, v in d.items()} for g, d in params.items()}
        on = lambda d: dict({k: torch.as_tensor(a[k], device=d)
                             for k in GIN_ARRAYS if k in a}, n_graphs=a.get("n_graphs"))
        card = on(dev)
        logits, loss = gin_outputs(params, cfg, card)
        again, loss2 = gin_outputs(params, cfg, card)
        if not (torch.equal(logits, again) and torch.equal(loss, loss2)):
            raise AssertionError(f"gin {name}: two calls on the card differ")
        want, want_loss = gin_outputs(host, cfg, on("cpu"))
        rows = a.get("n_graphs", a["feats"].shape[0])
        check_finite(logits, (rows, cfg.n_classes), f"gin {name}")
        err = {}
        for what, got, ref in (("logits", logits, want), ("loss", loss, want_loss)):
            scale = max(1.0, float(ref.abs().max()))
            err[what] = float((got.cpu() - ref).abs().max())
            if err[what] > GIN_TOL * scale:
                raise AssertionError(f"gin {name} {what}: {err[what]} > {GIN_TOL} x {scale}")
            err[f"{what}_scale"] = scale
        ms = cuda_ms(lambda: gnn.forward(params, card["feats"], card["edge_src"],
                                         card["edge_dst"], cfg,
                                         graph_ids=card.get("graph_ids"),
                                         n_graphs=a.get("n_graphs", 0)), 5)
        errs[name] = max(err["logits"] / err["logits_scale"], err["loss"] / err["loss_scale"])
        log("gin", cell=name, n_layers=cfg.n_layers, d_hidden=cfg.d_hidden,
            d_in=cfg.d_in, n_classes=cfg.n_classes, readout=cfg.readout,
            nodes=int(a["feats"].shape[0]), edges=int(a["edge_src"].shape[0]),
            cut=cut, **{k: a[k] for k in ("graph_nodes", "graph_edges", "build_s",
                                           "block_nodes", "block_edges") if k in a},
            card_equals_itself=True, max_abs_diff=err, tolerance=GIN_TOL,
            loss=float(loss), forward_ms=ms)
    return errs


# ---------------------------------------------------------------------------
# Phases 21-23: event-mode serving and the legacy kernels
# ---------------------------------------------------------------------------

WIDE_SLOTS = 16            # the reference's PixieArchConfig.n_slots
WIDE_REQUEST_PINS = (16, 12, 9, 16, 4, 16, 1, 10)
CHECK_EVERY = (1, 2, 4)    # FULL_WALK runs 4 chunks: 4 checks, 2, or 1
DENSE_CHECKED = (0, 1, 2)  # requests held against the dense engine
LEGACY_STEPS = 5
EVENT_FIELDS = ("slot_events", "pin_events", "steps_taken", "chunks_run",
                "n_high", "scores", "ids")


def wide_requests(graph):
    """Requests of up to ``WIDE_SLOTS`` pins with edges, as
    ``full_width_requests`` draws them."""
    import torch

    rng = np.random.default_rng(SEED + 3)
    cand = torch.from_numpy(
        rng.integers(0, graph.n_pins, 512).astype(np.int32)
    ).to(graph.device)
    cand = cand[graph.pin_degree(cand) > 0].cpu().numpy()
    reqs, at = [], 0
    for k in WIDE_REQUEST_PINS:
        pins = [int(p) for p in cand[at:at + k]]
        at += k
        weights = [float(w) for w in rng.uniform(0.1, 1.0, k).astype(np.float32)]
        reqs.append((pins, weights, int(rng.integers(0, 4))))
    return reqs


def event_request(graph, req, rid: int, n_slots: int, cfg, **kw):
    """One request through ``pixie_walk_events`` + ``recommend_from_events``
    under the server key's fold for ``rid``: the EventWalkResult's fields,
    then ``(scores, ids)``."""
    from repro_torch.core import prng, walk

    dev = graph.device
    pins, weights, feats = padded_batch([req], n_slots, dev)
    key = prng.fold_in(prng.key(SEED, dev), rid)
    r = walk.pixie_walk_events(graph, pins[0], weights[0], feats[0], key, cfg, **kw)
    return (*r, *walk.recommend_from_events(r, n_slots, graph.n_pins, pins[0],
                                            cfg.top_k))


def assert_events_equal(a, b, what: str) -> None:
    import torch

    for name, x, y in zip(EVENT_FIELDS, a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs")


def serve_events(graph, reqs, n_slots, cfg):
    """Every request through event mode, each timed on the host clock
    between two synchronisations -> (outputs, latencies in ms)."""
    import torch

    outs, lat = [], []
    for rid, req in enumerate(reqs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(event_request(graph, req, rid, n_slots, cfg))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    return outs, lat


def dense_oracle(graph, req, rid: int, n_slots: int, cfg):
    """The dense engine on one request under the same key: ``walk.recommend``
    itself; the dense counts with every query pin's column zeroed, boosted
    and ranked (event mode's query-pin rule: the dense engine debits only a
    slot's own query pin); and the visits query pins got from other
    slots, the only thing that can part the two."""
    from repro_torch.core import counter, prng, walk

    dev = graph.device
    pins, weights, feats = padded_batch([req], n_slots, dev)
    key = prng.fold_in(prng.key(SEED, dev), rid)
    rec = walk.recommend(graph, pins[0], weights[0], feats[0], key, cfg)
    counts = walk.pixie_random_walk(graph, pins[0], weights[0], feats[0], key,
                                    cfg).counts
    q = pins[0][pins[0] >= 0].long()
    cross = int(counts[:, q].sum())
    counts[:, q] = 0
    masked = counter.topk_dense(counter.boost_combine(counts), cfg.top_k)
    return rec, masked, cross


VISIT_EDGE_CASES = [(0, 64), (1, 1), (5000, 1300), (777, 33), (4096, 1),
                    (300, 0), (200_000, 4099)]   # (events, bins)
STEP_EDGE_WALKERS = (1, 100, 256, 4096)
STEP_EDGE_ALPHAS = (0, 2**31, 2**32 - 1)


def dead_end_csr(dev):
    """6 pins, 4 boards (global ids 6..9): pins 0 and 5 (the last row)
    have no boards, boards 2 and 3 (the last row) no pins, and pins 3 and
    1 point at them, so both last rows are reached."""
    import torch

    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return (t([0, 0, 2, 3, 4, 6, 6]), t([6, 9, 7, 8, 6, 7]),
            t([0, 2, 4, 4, 4]), t([1, 4, 2, 4])), 6


def int_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def legacy_edge_cases(graph, dev) -> int:
    """Both legacy kernels against their twins at edge shapes; returns the
    number of cases checked."""
    import torch
    from repro_torch.kernels import visit_counter as vc
    from repro_torch.kernels import walk_step as ws

    n = 0
    for i, (m, n_bins) in enumerate(VISIT_EDGE_CASES):
        rng = np.random.default_rng(SEED + 10 + i)
        ev = rng.integers(-5, n_bins + 20, m).astype(np.int32)
        if m >= 4:
            ev[:4] = [-(2**31), 2**31 - 1, n_bins, -1]
        ev = torch.as_tensor(ev, device=dev)
        if int_err(vc.visit_counter(ev, n_bins), vc.visit_counter_plain(ev, n_bins)):
            raise AssertionError(f"visit_counter edge case {(m, n_bins)} differs")
        n += 1
    dead, dead_pins = dead_end_csr(dev)
    full = (graph.p2b.offsets, graph.p2b.targets, graph.b2p.offsets,
            graph.b2p.targets)
    for csr, n_pins, walkers in ((dead, dead_pins, STEP_EDGE_WALKERS),
                                 (full, graph.n_pins, (8192,))):
        for w in walkers:
            for alpha in STEP_EDGE_ALPHAS:
                gen = torch.Generator(device=dev).manual_seed(SEED + w + alpha % 97)
                curr = torch.randint(0, n_pins, (w,), generator=gen, device=dev,
                                     dtype=torch.int32)
                query = torch.randint(0, n_pins, (w,), generator=gen, device=dev,
                                      dtype=torch.int32)
                words = torch.randint(0, 2**32, (w, 3), generator=gen, device=dev,
                                      dtype=torch.int64)
                words[::2] |= 2**31                 # high-bit draws
                rb = ws.u32_bits_as_int32(words).contiguous()
                got = ws.walk_step(curr, query, rb, *csr, n_pins=n_pins,
                                   alpha_u32=alpha)
                want = ws.walk_step_plain(curr, query, rb, *csr, n_pins=n_pins,
                                          alpha_u32=alpha)
                if any(int_err(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"walk_step edge case w={w} alpha={alpha} differs")
                n += 1
    return n


def legacy_step_inputs(graph, reqs, cfg):
    """Phase 23's walkers: ``cfg.n_walkers`` query pins cycled from the
    requests, ``LEGACY_STEPS`` seeded (w, 3) tables of uint32 words (int64
    values), the CSR and the restart threshold."""
    import torch
    from repro_torch.core import walk

    dev = graph.device
    w = cfg.n_walkers
    qpins = torch.tensor([p for r in reqs for p in r[0]], dtype=torch.int32,
                         device=dev)
    query = qpins.repeat(-(-w // qpins.numel()))[:w].contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    words = [torch.randint(0, 2**32, (w, 3), generator=gen, device=dev,
                           dtype=torch.int64) for _ in range(LEGACY_STEPS)]
    csr = (graph.p2b.offsets, graph.p2b.targets, graph.b2p.offsets,
           graph.b2p.targets)
    return query, words, csr, walk._prob_u32(cfg.alpha)


def event_phases(graph, reqs, shape, dev, read_ns: dict):
    """Phases 21-23 on the full-width graph; returns the kernels-line rows
    of visit_counter and walk_step, the launch counts of each path and the
    profiled request's operation counts.  ``read_ns`` is the probe's
    latencies (``chase_latency``), which price walk_step's chain."""
    import torch
    from repro_torch.configs.pixie import FULL_WALK
    from repro_torch.core import counter, walk
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import visit_counter as vc
    from repro_torch.kernels import walk_step as ws

    cfg = FULL_WALK
    plain = dataclasses.replace(cfg, backend="xla")
    n_slots = shape.n_slots
    n_pins = graph.n_pins

    # 21. the replicated cell in event mode
    torch.cuda.reset_peak_memory_stats()
    event_request(graph, reqs[0], 0, n_slots, cfg)     # warm-up
    _build.reset_launches()
    outs, lat = serve_events(graph, reqs, n_slots, cfg)
    replicated_launches = dict(_build.launches)
    if replicated_launches["walk_steps_fused"] == 0:
        raise AssertionError("event mode never launched walk_steps_fused")
    for rid, out in enumerate(outs):
        check_result(out[5], out[6], cfg.top_k, n_pins, f"event request {rid}")
        assert_events_equal(out, event_request(graph, reqs[rid], rid, n_slots, plain),
                            f"event request {rid}, kernel vs plain path")
    modes = []
    for rid in (0, 3):
        for every in CHECK_EVERY:
            inc = event_request(graph, reqs[rid], rid, n_slots, cfg, check_every=every)
            full = event_request(graph, reqs[rid], rid, n_slots, cfg,
                                 check_every=every, check_mode="full")
            assert_events_equal(inc, full, f"event request {rid}, check_every "
                                f"{every}: incremental vs full")
            modes.append(dict(request=rid, check_every=every,
                              chunks_run=int(inc[3]), n_high=int(inc[4].sum())))
    nes = cfg.without_early_stop()
    dense = []
    for rid in DENSE_CHECKED:
        ev = event_request(graph, reqs[rid], rid, n_slots, nes)
        rec, masked, cross = dense_oracle(graph, reqs[rid], rid, n_slots, nes)
        same_rec = torch.equal(ev[5], rec[0]) and torch.equal(ev[6], rec[1])
        if not (torch.equal(ev[5], masked[0]) and torch.equal(ev[6], masked[1])):
            raise AssertionError(f"event request {rid}: event mode differs from "
                                 "the dense engine's counts")
        if cross == 0 and not same_rec:
            raise AssertionError(f"event request {rid}: event mode differs from "
                                 "walk.recommend")
        dense.append(dict(request=rid, query_pin_visits_from_other_slots=cross,
                          equal_to_recommend=same_rec))
    log("events_replicated", name=shape.name, n_slots=n_slots,
        requests=len(outs), p50_ms=float(np.percentile(lat, 50)),
        max_ms=float(np.max(lat)), latencies_ms=lat,
        max_events=int(outs[0][0].shape[0]),
        chunks_run=[int(o[3]) for o in outs],
        steps_taken=[int(o[2].sum()) for o in outs],
        n_high=[int(o[4].sum()) for o in outs],
        identical_to_plain=True, incremental_equals_full=modes,
        dense_without_early_stop=dense, launches=replicated_launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        resident_gb=torch.cuda.memory_allocated() / 1e9)
    event_ops = profiled_ops(lambda: event_request(graph, reqs[0], 0, n_slots, cfg),
                             trace="chip_smoke_events_trace.json")

    # 22. 16 slots: 2.24e9 packed ids, past what dense counting can index
    try:
        walk.select_count_engine(cfg.backend, WIDE_SLOTS, n_pins)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("dense counting accepted 16 slots at full width")
    if "pixie_walk_events" not in refused:
        raise AssertionError(f"dense refusal does not name event mode: {refused}")
    wreqs = wide_requests(graph)
    _build.reset_launches()
    wouts, wlat = serve_events(graph, wreqs, WIDE_SLOTS, cfg)
    wide_launches = dict(_build.launches)
    if wide_launches["walk_steps_fused"] == 0:
        raise AssertionError("16-slot event mode never launched walk_steps_fused")
    for rid, out in enumerate(wouts):
        check_result(out[5], out[6], cfg.top_k, n_pins, f"16-slot request {rid}")
        assert_events_equal(out, event_request(graph, wreqs[rid], rid, WIDE_SLOTS,
                                               plain),
                            f"16-slot request {rid}, kernel vs plain path")
    log("events_wide", n_slots=WIDE_SLOTS, packed_ids=WIDE_SLOTS * n_pins,
        dense_refused=refused, requests=len(wouts),
        pins=[len(r[0]) for r in wreqs], p50_ms=float(np.percentile(wlat, 50)),
        max_ms=float(np.max(wlat)), latencies_ms=wlat,
        chunks_run=[int(o[3]) for o in wouts], identical_to_plain=True,
        launches=wide_launches)

    # 23. the legacy kernels: ops.walk_step chained, ops.visit_counts over
    # one event request's pin lane
    w = cfg.n_walkers
    query, words, csr, alpha = legacy_step_inputs(graph, reqs, cfg)
    sev, pev = outs[0][0], outs[0][1]
    lane = torch.where(sev < n_slots, pev, -1)
    _build.reset_launches()
    curr_k = curr_p = query
    hops, step_err = [], 0
    for s in range(LEGACY_STEPS):
        got = ops.walk_step(curr_k, query, words[s], *csr, n_pins=n_pins,
                            alpha_u32=alpha)
        want = ops.walk_step(curr_p, query, words[s], *csr, n_pins=n_pins,
                             alpha_u32=alpha, use_kernel=False)
        step_err = max(step_err, *(int_err(a, b) for a, b in zip(got, want)))
        if step_err:
            raise AssertionError(f"ops.walk_step superstep {s}: kernel vs twin differ")
        hops.append(int(got[2].sum()))
        curr_k, curr_p = got[0], want[0]
    hist = ops.visit_counts(lane, n_pins)
    visit_err = int_err(hist, ops.visit_counts(lane, n_pins, use_kernel=False))
    if visit_err:
        raise AssertionError("ops.visit_counts: kernel vs twin differ")
    uniq_slot, uniq_pin, counts = counter.events_to_counts(sev, pev, n_slots,
                                                           sev.shape[0])
    for slot in range(n_slots):
        hs = ops.visit_counts(torch.where(sev == slot, pev, -1), n_pins)
        sel = uniq_slot == slot
        if not (torch.equal(hs[uniq_pin[sel].long()], counts[sel])
                and int(hs.sum()) == int(counts[sel].sum())):
            raise AssertionError(f"slot {slot}: histogram differs from the event runs")
    legacy_launches = dict(_build.launches)
    for name in ("walk_step", "visit_counter"):
        if legacy_launches[name] == 0:
            raise AssertionError(f"the legacy path never launched {name}")
    n_edge = legacy_edge_cases(graph, dev)
    log("legacy_kernels", walkers=w, supersteps=LEGACY_STEPS, hops_ok=hops,
        events=int(lane.numel()), valid_events=int((lane >= 0).sum()),
        n_bins=n_pins, identical=True, per_slot_equals_event_runs=True,
        edge_cases_identical=n_edge, launches=legacy_launches)

    # the two rows of the kernels line, at the legacy path's shapes
    valid_ids = lane[lane >= 0]
    ms = device_ms(lambda: vc.visit_counter(lane, n_pins), 50)
    sectors = int(torch.unique(valid_ids >> 3).numel())
    nbytes = 4 * lane.numel() + 4 * n_pins + SECTOR * sectors
    visit_row = dict(
        name="visit_counter", route="cuda",
        source="src/repro_torch/kernels/csrc/visit_counter.cu",
        replaces="src/repro/kernels/visit_counter.py:83", launches=None,
        max_abs_err=visit_err, ms=ms,
        plain_ms=cuda_ms(lambda: vc.visit_counter_plain(lane, n_pins), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.bincount(valid_ids, minlength=n_pins), 50),
    )
    log("kernel", name="visit_counter", device_ms=ms, events=int(lane.numel()),
        valid_events=int(valid_ids.numel()), bins=n_pins,
        distinct_sectors=sectors, bound_bytes=nbytes)
    rb = ws.u32_bits_as_int32(words[0]).contiguous()
    step = lambda: ws.walk_step(query, query, rb, *csr, n_pins=n_pins,
                                alpha_u32=alpha)
    _, visited, _ = step()
    rb4 = torch.zeros((1, w, 4), dtype=torch.int32, device=dev)
    rb4[0, :, 0], rb4[0, :, 2], rb4[0, :, 3] = rb[:, 0], rb[:, 1], rb[:, 2]
    # the fused walk's replay of one step reads what this kernel reads
    # (every walker starts on its query pin, so both read that row first)
    sectors, reads = walk_sectors(dict(
        rbits=rb4, feat=torch.zeros_like(query), query=query, curr=query,
        csr=(*csr, None, None), kw=dict(n_pins=n_pins, alpha_u32=alpha,
                                        beta_u32=0)), visited[None, :])
    # chain floor: the 4 dependent CSR reads (offset pair, board, offset
    # pair, pin) at the probe's L2-hit latency, the walk row's convention;
    # the lane read before them makes 5
    chain = read_chain(reads, w, read_ns)
    nbytes = SECTOR * sectors + (4 + 4 + 12 + 4 + 4 + 1) * w
    ms = device_ms(step, 50)
    single = cold_l2_ms(step, dev)
    step_row = dict(
        name="walk_step", route="cuda",
        source="src/repro_torch/kernels/csrc/walk_step.cu",
        replaces="src/repro/kernels/walk_step.py:143", launches=None,
        max_abs_err=step_err, ms=ms,
        plain_ms=cuda_ms(lambda: ws.walk_step_plain(query, query, rb, *csr,
                                                    n_pins=n_pins,
                                                    alpha_u32=alpha), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, chain_floor_ms=chain["chain_floor_ms"],
    )
    log("kernel", name="walk_step", device_ms=ms, walkers=w,
        distinct_sectors=sectors, bound_bytes=nbytes, **chain,
        chain_floor_with_lanes_ms=(chain["chain_reads"] + 1) * read_ns["l2_ns"] * 1e-6,
        **single)
    del outs, wouts, lane, hist, counts
    torch.cuda.empty_cache()
    return [visit_row, step_row], [replicated_launches, wide_launches,
                                   legacy_launches], event_ops


# ---------------------------------------------------------------------------
# Phases 24-27: the paper's graph pruning, content baselines and oracle
# ---------------------------------------------------------------------------

TOPICS = 16                  # topics a pin (the benchmarks' 20k graph's count)
TOPIC_TEMPERATURE = 0.25     # softmax(z / T), z ~ N(0, 1): peaked, row-stochastic
TOPIC_ROWS = 10_000_000      # rows drawn at a time
FIG4_DELTAS = (1.0, 0.95, 0.9, 0.8, 0.65)   # bench_fig4_pruning.py's sweep
FIG4_BOARDS = 20
TABLE1_QUERIES = 40
TABLE1_KS = (10, 100, 1000)
COSINE_TOL = 2e-6            # the CPU tests' bound on cosine scores
ORACLE_TV = {"basic": 0.15, "biased": 0.2}   # tests/test_walk.py:42, :64


def draw_topics(n_pins: int, dev):
    """Seeded stand-in pin topics on the card: ``softmax(z / T)`` of normal
    draws, a block of rows at a time, from one explicit generator."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    topics = torch.empty((n_pins, TOPICS), dtype=torch.float32, device=dev)
    for r0 in range(0, n_pins, TOPIC_ROWS):
        r1 = min(r0 + TOPIC_ROWS, n_pins)
        z = torch.randn((r1 - r0, TOPICS), generator=gen, device=dev)
        topics[r0:r1] = torch.softmax(z / TOPIC_TEMPERATURE, dim=1)
        del z
    return topics


def serve_all(server, reqs):
    """The requests one at a time through ``server``: results by id."""
    out = []
    for rid, (p, w, f) in enumerate(reqs):
        server.submit(p, w, user_feat=f, req_id=rid)
        server.pump()
        out += server.harvest()
    return sorted(out, key=lambda r: r.req_id)


def prune_full(graph, langs, reqs, shape, cfg, dev, unpruned_p50: float) -> dict:
    """Phase 24: the paper's pruning at full width on the card (topics
    drawn on the card), then the phase-2 requests on the pruned graph,
    kernel path == plain path.  Returns that serving run's launches."""
    import torch
    from repro_torch.core import prng, pruning, service
    from repro_torch.kernels import _build
    from repro_torch.serving.server import PixieServer

    resident = torch.cuda.memory_allocated() / 1e9
    t = time.perf_counter()
    topics = draw_topics(graph.n_pins, dev)
    torch.cuda.synchronize()
    log("topics", shape=list(topics.shape), gb=topics.numel() * 4 / 1e9,
        draw_s=time.perf_counter() - t, seed=SEED + 24,
        recipe=f"softmax(z / {TOPIC_TEMPERATURE}) per row, z ~ N(0, 1) float32 "
               f"from torch.Generator({dev.type}).manual_seed({SEED + 24}), "
               f"{TOPIC_ROWS:,} rows at a time")
    pcfg = pruning.PruneConfig()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    pruned, stats = pruning.prune_graph(graph, topics, None, pcfg,
                                        board_lang=langs[1], pin_lang=langs[0],
                                        n_langs=4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 1e9
    del topics
    # the stages' counts hold together, and no pin keeps more than its target
    before, after = graph.p2b.degrees(), pruned.p2b.degrees()
    table = torch.as_tensor(pruning.degree_targets(
        graph.max_pin_degree, pcfg.delta, pcfg.min_keep), device=dev)
    if not (stats["edges_before"] >= stats["edges_after_entropy"]
            >= stats["edges_after"] == pruned.n_edges == pruned.b2p.n_edges):
        raise AssertionError(f"full-width prune: inconsistent counts {stats}")
    if stats["boards_dropped"] != int(pcfg.entropy_board_frac * graph.n_boards):
        raise AssertionError("full-width prune dropped the wrong number of boards")
    if bool((after > table[before.long()]).any()) or bool((after > before).any()):
        raise AssertionError("full-width prune kept more edges than a pin's target")
    boards_left = int((pruned.b2p.degrees() > 0).sum())
    if boards_left > graph.n_boards - stats["boards_dropped"]:
        raise AssertionError("a dropped board kept an edge")
    del before, after, table
    torch.cuda.empty_cache()
    log("prune", config=dataclasses.asdict(pcfg), stats=stats, seconds=seconds,
        resident_gb=resident, peak_gb=peak, n_edges=pruned.n_edges,
        max_pin_degree=pruned.max_pin_degree, graph_gb=pruned.nbytes() / 1e9,
        boards_with_edges=boards_left, chunk_edges=pruning.CHUNK_EDGES,
        cuts=["none in the graph (phase 2's uniform random edges)",
              "pin topics are seeded stand-ins drawn on the card: no topic "
              "data is public, and uniform edges carry no topic structure"])

    service.serve_batch(pruned, *padded_batch(reqs[:1], shape.n_slots, dev),
                        prng.key(SEED, dev), cfg)                 # warm-up
    server = PixieServer(pruned, cfg, buckets=[(1, shape.n_slots)], seed=SEED)
    torch.cuda.synchronize()
    _build.reset_launches()
    results = serve_all(server, reqs)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high"):
        if launches[name] == 0:
            raise AssertionError(f"serving the pruned graph never launched {name}")
    ids = list(range(len(reqs)))
    kern = serve_with_stats(pruned, reqs, ids, shape.n_slots, cfg, "pallas")
    plain = serve_with_stats(pruned, reqs, ids, shape.n_slots, cfg, "xla")
    for rid, a, b, r in zip(ids, kern, plain, results):
        assert_same(a, b, f"pruned request {rid}")
        if not (np.array_equal(a[0][0].cpu().numpy(), r.scores)
                and np.array_equal(a[1][0].cpu().numpy(), r.ids)):
            raise AssertionError(f"pruned request {rid}: server differs from serve_batch")
        live = pruned.pin_degree(torch.as_tensor(reqs[rid][0], device=dev))
        if bool((live > 0).any()):      # a pin with edges left: the walk ran
            check_result(r.scores, r.ids, cfg.top_k, pruned.n_pins, f"pruned {rid}")
    lat = [r.latency_ms for r in results]
    log("pruned_serve", requests=len(results), p50_ms=float(np.percentile(lat, 50)),
        unpruned_p50_ms=unpruned_p50, max_ms=float(np.max(lat)), latencies_ms=lat,
        identical_to_plain=True, launches=launches,
        steps_taken=[int(a[2].sum()) for a in kern],
        n_high=[int(a[3].sum()) for a in kern])
    del pruned, server, results, kern, plain
    torch.cuda.empty_cache()
    return launches


def link_pred_f1(sg, graph, dev, seed: int = SEED) -> float:
    """``bench_fig4_pruning.py``'s link prediction on the port, kernel
    path: each held-out board's first 8 members query the walk, F1 of the
    top 100 against the board's held-out pins."""
    import torch
    from repro_torch.core import prng, walk

    rng = np.random.default_rng(seed)
    by_board = {}
    for p, b in zip(sg.heldout_pins, sg.heldout_boards):
        by_board.setdefault(int(b), []).append(int(p))
    boards = [b for b, pins in by_board.items() if len(pins) >= 2]
    rng.shuffle(boards)
    off = graph.b2p.offsets.cpu().numpy()
    tgt = graph.b2p.targets.cpu().numpy()
    cfg = walk.WalkConfig(n_steps=20_000, n_walkers=256, top_k=100, n_p=10**9,
                          n_v=10**9, backend="pallas")
    f1s = []
    for i, b in enumerate(boards[:FIG4_BOARDS]):
        members = tgt[off[b]:off[b + 1]][:8]
        if members.size == 0:
            continue
        qp = np.full(8, -1, np.int32)
        qp[:members.size] = members
        qw = np.zeros(8, np.float32)
        qw[:members.size] = 1.0
        vals, ids = walk.recommend(graph, torch.as_tensor(qp, device=dev),
                                   torch.as_tensor(qw, device=dev), 0,
                                   prng.key(seed + i, dev), cfg)
        r = set(ids.cpu().numpy()[vals.cpu().numpy() > 0].tolist())
        x = set(by_board[b])
        tp = len(r & x)
        prec, rec = tp / max(len(r), 1), tp / max(len(x), 1)
        f1s.append(2 * prec * rec / max(prec + rec, 1e-9))
    return float(np.mean(f1s)) if f1s else 0.0


def prune_20k(sg, dev) -> dict:
    """Phase 25: the Fig. 4 sweep on the 20k graph, the card's prune equal
    to the CPU's array for array at every delta; link-prediction F1 on the
    kernel path.  Returns the F1 walks' launches."""
    import torch
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import pruning
    from repro_torch.kernels import _build

    cpu_graph = sg.graph.to("cpu")
    # the entropy's float64 log is the card's; measured against the CPU's
    pins, boards = graph_lib.edge_list(cpu_graph)
    ent_cpu = pruning.board_entropy(pins, boards, sg.pin_topics, cpu_graph.n_boards)
    ent_card = pruning.board_entropy(
        torch.as_tensor(pins, device=dev), torch.as_tensor(boards, device=dev),
        torch.as_tensor(sg.pin_topics, device=dev), cpu_graph.n_boards).cpu()
    # and the card's pow, which the port does not use (numpy's table)
    deg = np.arange(10_001)
    pow_parts = {d: int((torch.ceil(torch.pow(torch.as_tensor(
        deg, dtype=torch.float64, device=dev), d)).cpu().numpy()
        != np.ceil(deg.astype(np.float64) ** d)).sum()) for d in FIG4_DELTAS}
    rows = []
    _build.reset_launches()
    for delta in FIG4_DELTAS:
        pcfg = pruning.PruneConfig(entropy_board_frac=0.10, delta=delta)
        kw = dict(board_lang=sg.board_lang, pin_lang=sg.pin_lang, n_langs=4)
        t = time.perf_counter()
        card, stats = pruning.prune_graph(sg.graph, sg.pin_topics, None, pcfg, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        host, host_stats = pruning.prune_graph(cpu_graph, sg.pin_topics, None, pcfg, **kw)
        cpu_s = time.perf_counter() - t
        a, b = graph_lib.graph_to_numpy(card), graph_lib.graph_to_numpy(host)
        if stats != host_stats or a.keys() != b.keys() or not all(
                np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError(f"delta {delta}: the card's prune differs from the CPU's")
        rows.append(dict(delta=delta, edges=stats["edges_after"],
                         edge_keep_frac=stats["edge_keep_frac"],
                         f1=link_pred_f1(sg, card, dev), card_s=card_s, cpu_s=cpu_s))
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high"):
        if launches[name] == 0:
            raise AssertionError(f"the Fig. 4 walks never launched {name}")
    log("prune_20k", sweep=rows, card_equals_cpu=True, board_frac=0.10,
        entropy_boards_differ=int((ent_card != ent_cpu).sum()),
        entropy_max_abs_diff=float((ent_card - ent_cpu).abs().max()),
        card_pow_degrees_differ=pow_parts,
        boards_evaluated=FIG4_BOARDS, launches=launches,
        note="synthetic 20k graph (seed 7), not the paper's data")
    return launches


def table1_queries(sg, n: int, seed: int = SEED) -> np.ndarray:
    """``benchmarks/common.py`` ``sample_query_pins``: pins drawn by degree."""
    rng = np.random.default_rng(seed)
    degs = sg.graph.p2b.degrees().cpu().numpy().astype(np.float64)
    return rng.choice(sg.graph.n_pins, size=n, replace=False,
                      p=degs / degs.sum()).astype(np.int32)


def baselines_20k(sg, dev) -> dict:
    """Phase 26: Table 1 on the card (bench_table1_hitrate.py's queries and
    ground truth): hit rates at 10 / 100 / 1000 of the three content
    baselines and Pixie; each baseline's scores on the card against the
    CPU port's.  Returns the Pixie walks' launches."""
    import torch
    from repro_torch.core import baselines, prng, walk
    from repro_torch.kernels import _build

    g = sg.graph
    rng = np.random.default_rng(SEED)
    queries = table1_queries(sg, TABLE1_QUERIES)
    p2b_off, p2b_tgt = g.p2b.offsets.cpu().numpy(), g.p2b.targets.cpu().numpy()
    b2p_off, b2p_tgt = g.b2p.offsets.cpu().numpy(), g.b2p.targets.cpu().numpy()

    def co_board_pin(q):
        lo, hi = p2b_off[q], p2b_off[q + 1]
        if hi == lo:
            return None
        b = p2b_tgt[rng.integers(lo, hi)] - g.n_pins
        cands = b2p_tgt[b2p_off[b]:b2p_off[b + 1]]
        cands = cands[cands != q]
        return None if cands.size == 0 else int(rng.choice(cands))

    text, vis = baselines.make_content_embeddings(sg.pin_topics, seed=SEED)
    on = {d: (torch.as_tensor(text, device=d), torch.as_tensor(vis, device=d))
          for d in (dev, torch.device("cpu"))}
    scorers = {
        "content_text": lambda t, v, q: baselines.cosine_rank_scores(t, q),
        "content_visual": lambda t, v, q: baselines.hamming_rank_scores(v, q),
        "content_combined": baselines.combined_rank_scores,
    }
    cfg = walk.WalkConfig(n_steps=30_000, n_walkers=512, top_k=1000, bias_beta=0.0,
                          n_p=10**9, n_v=10**9, backend="pallas")
    hits = {m: {k: 0 for k in TABLE1_KS} for m in (*scorers, "pixie")}
    cos_err, n_eval = 0.0, 0
    _build.reset_launches()
    for qi, q in enumerate(queries):
        x = co_board_pin(int(q))
        if x is None:
            continue
        n_eval += 1
        for name, fn in scorers.items():
            s = fn(*on[dev], int(q)).cpu().numpy()
            s_cpu = fn(*on[torch.device("cpu")], int(q)).numpy()
            err = float(np.abs(s - s_cpu).max())
            if name == "content_text":
                cos_err = max(cos_err, err)
                if err > COSINE_TOL:
                    raise AssertionError(f"query {q}: cosine scores {err} apart")
            elif err != 0.0:
                raise AssertionError(f"query {q}: {name} scores differ card vs CPU")
            s = s.copy()
            s[int(q)] = -np.inf
            rank = int(np.sum(s > s[x]))
            for k in TABLE1_KS:
                hits[name][k] += int(rank < k)
        vals, ids = walk.recommend(
            g, torch.tensor([int(q)], dtype=torch.int32, device=dev),
            torch.ones(1, device=dev), 0, prng.key(SEED + qi, dev), cfg)
        ids, vals = ids.cpu().numpy(), vals.cpu().numpy()
        pos = np.where((ids == x) & (vals > 0))[0]
        rank = int(pos[0]) if pos.size else 10**9
        for k in TABLE1_KS:
            hits["pixie"][k] += int(rank < k)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high"):
        if launches[name] == 0:
            raise AssertionError(f"the Table 1 walks never launched {name}")
    table = {m: {f"top_{k}": hits[m][k] / max(n_eval, 1) for k in TABLE1_KS}
             for m in hits}
    log("baselines_20k", queries=n_eval, table=table, cosine_max_abs_err=cos_err,
        cosine_tol=COSINE_TOL, hamming_identical=True, combined_identical=True,
        launches=launches, note="synthetic 20k graph (seed 7), not the paper's data")
    return launches


def oracle_check(dev) -> dict:
    """Phase 27: the kernel-path walk against the sequential oracle on
    small_test_graph, as tests/test_walk.py holds the reference's engine:
    total-variation distance of the normalized visits under 0.15 (basic)
    and 0.2 (biased).  Returns the walks' launches."""
    import torch
    from repro_torch.core import prng, reference, walk
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import _build

    sg = synthetic.small_test_graph(0, device=dev)
    g = sg.graph
    q = int(synthetic.top_degree_pins(sg, 1)[0])

    def tv(a, b):
        return 0.5 * float(np.abs(a / max(a.sum(), 1) - b / max(b.sum(), 1)).sum())

    _build.reset_launches()
    v_ref = reference.basic_random_walk_ref(g, q, alpha=0.5, n_steps=40_000, seed=3)
    cfg = walk.WalkConfig(n_steps=40_000, n_walkers=512, bias_beta=0.0, n_p=10**9,
                          n_v=10**9, backend="pallas")
    v = walk.basic_random_walk(g, q, prng.key(0, dev), cfg).cpu().numpy()
    tv_basic = tv(v_ref, v)
    b_ref = reference.pixie_random_walk_ref(
        g, q, user_feat=1, alpha=0.5, n_steps=30_000, n_p=10**9, n_v=10**9,
        beta=0.9, seed=5)
    cfg = dataclasses.replace(cfg, n_steps=30_000, bias_beta=0.9)
    res = walk.pixie_random_walk(g, torch.tensor([q], dtype=torch.int32, device=dev),
                                 torch.ones(1, device=dev), 1, prng.key(1, dev), cfg)
    tv_biased = tv(b_ref, res.counts[0].cpu().numpy())
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high"):
        if launches[name] == 0:
            raise AssertionError(f"the oracle check never launched {name}")
    if tv_basic >= ORACLE_TV["basic"] or tv_biased >= ORACLE_TV["biased"]:
        raise AssertionError(f"oracle TV distance: basic {tv_basic}, biased {tv_biased}")
    log("oracle", query_pin=q, tv_basic=tv_basic, tv_biased=tv_biased,
        bounds=ORACLE_TV, seeds={"basic": {"oracle": 3, "walk_key": 0},
                                 "biased": {"oracle": 5, "walk_key": 1}},
        launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Phases 28-29: the recsys models (SASRec, BST, DLRM) at full width
# ---------------------------------------------------------------------------

SASREC_HISTORY_PAD = (0, 10, 25, 49)   # leading -1s of request rid % 4's history
RECSYS_P99 = 512                       # RECSYS_SHAPES serve_p99 (registry.py:85)
RECSYS_BULK = 262_144                  # serve_bulk
RECSYS_CAND = 1_000_000                # retrieval_cand
RECSYS_TOP = 100
RECSYS_TOL = 2e-6                      # the CPU tests' bound on float outputs


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of card 0."""
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def assert_fp32_matmuls() -> None:
    """float32 products in float32: no TF32 anywhere a comparison is made."""
    import torch

    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision is not 'highest'")
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmuls are allowed")


def gb(n_bytes) -> float:
    return n_bytes / 1e9


def seeded_histories(n_requests: int, n_items: int, seq_len: int, dev):
    """One seeded history a request; request ``rid``'s is left-padded with
    ``SASREC_HISTORY_PAD[rid % 4]`` ids of -1."""
    import torch

    rng = np.random.default_rng(SEED + 28)
    h = rng.integers(0, n_items, (n_requests, seq_len)).astype(np.int32)
    for rid in range(n_requests):
        h[rid, :SASREC_HISTORY_PAD[rid % 4]] = -1
    return torch.as_tensor(h, device=dev)


def sasrec_two_stage(graph, reqs, shape, cfg, dev, unpruned_p50: float) -> dict:
    """Phase 28: SASRec at its published widths ranks Pixie's candidates
    on the full-width graph, ``pixie_then_rank`` with ``sasrec_ranker``,
    the kernel path against the plain path.  Returns the kernel run's
    launches."""
    import torch
    from repro_torch.configs import sasrec
    from repro_torch.core import counter as counter_lib
    from repro_torch.core import prng, walk
    from repro_torch.kernels import _build
    from repro_torch.models import sequential_rec as sr
    from repro_torch.serving import recommend

    assert_fp32_matmuls()
    resident = gb(torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    scfg = dataclasses.replace(sasrec.FULL, n_items=graph.n_pins)
    t = time.perf_counter()
    params = sr.init_params(torch.Generator(device=dev).manual_seed(SEED + 28), scfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    table = params["items"]
    hist = seeded_histories(len(reqs), graph.n_pins, scfg.seq_len, dev)
    ts = recommend.TwoStageConfig()
    key0 = prng.key(SEED, dev)

    def run(rid, walk_cfg):
        pins, weights, _ = padded_batch(reqs[rid:rid + 1], shape.n_slots, dev)
        ranker = recommend.sasrec_ranker(params, hist[rid], scfg)
        return recommend.pixie_then_rank(
            graph, pins[0], weights[0], reqs[rid][2], prng.fold_in(key0, rid),
            walk_cfg, ranker, ts)

    run(0, cfg)                                                 # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    kern, lat = [], []
    for rid in range(len(reqs)):
        t = time.perf_counter()
        kern.append(run(rid, cfg))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high"):
        if launches[name] == 0:
            raise AssertionError(f"SASRec two-stage never launched {name}")
    plain_cfg = dataclasses.replace(cfg, backend="xla")
    n_real = []
    for rid, (s, i) in enumerate(kern):
        ps, pi = run(rid, plain_cfg)
        if not (torch.equal(s, ps) and torch.equal(i, pi)):
            raise AssertionError(f"SASRec two-stage request {rid}: kernel and plain paths differ")
        real = i >= 0
        if i.shape != (ts.final_k,) or not bool(torch.isfinite(s[real]).all()):
            raise AssertionError(f"SASRec two-stage request {rid}: bad result")
        if bool((s[1:] > s[:-1]).any()) or not bool(torch.isneginf(s[~real]).all()):
            raise AssertionError(f"SASRec two-stage request {rid}: bad order or padding")
        if int(i.max()) >= graph.n_pins or not bool(real.any()):
            raise AssertionError(f"SASRec two-stage request {rid}: bad ids")
        n_real.append(int(real.sum()))
    # one request's split, each part synchronised
    pins, weights, _ = padded_batch(reqs[:1], shape.n_slots, dev)
    rcfg = dataclasses.replace(cfg, top_k=ts.n_candidates)
    out = {}
    split = {"walk": wall_ms(lambda: out.setdefault("w", walk.recommend(
        graph, pins[0], weights[0], reqs[0][2], prng.fold_in(key0, 0), rcfg)))}
    split["user_state"] = wall_ms(lambda: out.setdefault("r", recommend.sasrec_ranker(
        params, hist[0], scfg)))
    ws, cand = out["w"]
    split["candidate_scores"] = wall_ms(lambda: out.setdefault("s", out["r"](cand)))
    split["topk"] = wall_ms(lambda: counter_lib.topk_total(
        torch.where(ws > 0, out["s"], float("-inf")), ts.final_k))
    log("sasrec_2stage", requests=len(reqs), n_items=scfg.n_items,
        table_rows=table.shape[0], table_gb=gb(table.numel() * table.element_size()),
        init_s=init_s, p50_ms=float(np.percentile(lat, 50)), max_ms=float(np.max(lat)),
        latencies_ms=lat, pixie_p50_ms=unpruned_p50, split_ms=split,
        launches=launches, identical_to_plain=True, real_ids=n_real,
        history_pad=list(SASREC_HISTORY_PAD), resident_gb=resident,
        peak_gb=gb(torch.cuda.max_memory_allocated()), card=card_line(),
        cuts=[f"n_items {scfg.n_items:,} (the graph's pins) instead of 10,000,000: "
              "candidates are pin ids"])
    del params, table, kern, out, hist
    torch.cuda.empty_cache()
    return launches


def recsys_smoke_outputs(name: str, dev) -> dict:
    """One SMOKE config's outputs on ``dev``, parameters drawn on the CPU
    from one seed and carried across, inputs from one numpy seed."""
    import torch
    from repro_torch.configs import bst, dlrm_mlperf, dlrm_rm2, sasrec
    from repro_torch.models import dlrm, sequential_rec as sr

    rng = np.random.default_rng(SEED + 29)
    gen = torch.Generator().manual_seed(SEED + 29)
    to = lambda a: torch.as_tensor(a, device=dev)
    move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)
    out = {}
    if name in ("sasrec", "bst"):
        cfg = (sasrec if name == "sasrec" else bst).SMOKE
        p = move(sr.init_params(gen, cfg))
        seq = rng.integers(0, cfg.n_items, (9, cfg.seq_len)).astype(np.int32)
        seq[2, :5], seq[5, :-1] = -1, -1
        if name == "sasrec":
            tg = rng.integers(-1, cfg.n_items, seq.shape).astype(np.int32)
            neg = rng.integers(0, cfg.n_items, seq.shape + (cfg.n_negatives,)).astype(np.int32)
            st = sr.sasrec_user_state(p, to(seq), cfg)
            out["user_state"] = st
            out["scores"], out["ids"] = sr.score_candidates(
                p, st, to(np.arange(cfg.n_items, dtype=np.int32)), cfg, top_k=20)
            out["loss"] = sr.sasrec_loss(p, to(seq), to(tg), to(neg), cfg)
        else:
            cand = to(rng.integers(0, cfg.n_items, 9).astype(np.int32))
            out["logits"] = sr.bst_forward(p, to(seq), cand, cfg)
            out["loss"] = sr.bst_loss(p, to(seq), cand,
                                      to((rng.random(9) < 0.5).astype(np.float32)), cfg)
    else:
        cfg = (dlrm_rm2 if name == "dlrm_rm2" else dlrm_mlperf).SMOKE
        p = move(dlrm.init_params(gen, cfg))
        dense = to(rng.normal(size=(16, cfg.n_dense)).astype(np.float32))
        sparse = to(np.stack([rng.integers(0, r, 16) for r in cfg.feature_rows], 1)
                    .astype(np.int32))
        out["logits"] = dlrm.forward(p, dense, sparse, cfg)
        out["loss"] = dlrm.bce_loss(p, dense, sparse,
                                    to((rng.random(16) < 0.5).astype(np.float32)), cfg)
        out["scores"], out["ids"] = dlrm.retrieval_score(
            p, dense[0], sparse[0], to(np.arange(cfg.feature_rows[0], dtype=np.int32)),
            cfg, top_k=10)
    return {k: v.cpu() for k, v in out.items()}


RECSYS_SMOKE = ("sasrec", "bst", "dlrm_rm2", "dlrm_mlperf")


def recsys_smoke_parity(dev, names=RECSYS_SMOKE) -> dict:
    """The four SMOKE configs on the card against the CPU port: floats
    within RECSYS_TOL, top-k ids exact.  Returns the largest differences."""
    import torch

    assert_fp32_matmuls()
    errs = {}
    for name in names:
        got, want = recsys_smoke_outputs(name, dev), recsys_smoke_outputs(name, "cpu")
        for k, w in want.items():
            if k == "ids":
                if not torch.equal(got[k], w):
                    raise AssertionError(f"{name} SMOKE: top-k ids differ card vs CPU")
                continue
            err = float((got[k] - w).abs().max())
            if not err <= RECSYS_TOL:
                raise AssertionError(f"{name} SMOKE {k}: card vs CPU {err} > {RECSYS_TOL}")
            errs[f"{name}/{k}"] = err
    return errs


def padded_ids(n: int, seq_len: int, n_items: int, gen, dev):
    """``(n, seq_len)`` uniform item ids; row ``i`` left-padded with
    ``(i % 5) * seq_len // 5`` ids of -1, and row 1 all -1."""
    import torch

    ids = torch.randint(0, n_items, (n, seq_len), generator=gen, device=dev,
                        dtype=torch.int32)
    pad = (torch.arange(n, device=dev) % 5) * seq_len // 5
    ids = torch.where(torch.arange(seq_len, device=dev)[None] < pad[:, None], -1, ids)
    ids[1] = -1
    return ids


def distinct_ids(n_items: int, n: int, gen, dev):
    """``n`` distinct int32 ids drawn uniformly from ``[0, n_items)``."""
    import torch

    return torch.randperm(n_items, generator=gen, device=dev)[:n].to(torch.int32)


def timed(fn, n: int):
    """``(result, device ms a call over n calls after a warm-up, peak GB)``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    ms = cuda_ms(fn, n)
    return out, ms, gb(torch.cuda.max_memory_allocated())


def check_finite(x, shape, what: str) -> None:
    import torch

    if tuple(x.shape) != tuple(shape) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{what}: expected finite {shape}, got {tuple(x.shape)}")


def check_topk(vals, ids, direct, rest_max, k: int, what: str) -> float:
    """A top-k against a direct recomputation of its candidates' scores:
    within RECSYS_TOL, descending, and no other candidate above the k-th
    by more than RECSYS_TOL.  Returns the largest difference."""
    if vals.shape != (k,) or ids.shape != (k,):
        raise AssertionError(f"{what}: expected top {k}")
    err = float((vals - direct).abs().max())
    if not err <= RECSYS_TOL:
        raise AssertionError(f"{what}: top-k scores {err} from their direct recomputation")
    if bool((vals[1:] > vals[:-1]).any()):
        raise AssertionError(f"{what}: top-k not descending")
    if float(rest_max) > float(vals[-1]) + RECSYS_TOL:
        raise AssertionError(f"{what}: a candidate outside the top-k scores higher")
    return err


def recsys_full(dev) -> dict:
    """Phase 29: SASRec, BST, dlrm-rm2 and dlrm-mlperf at their published
    widths, one at a time (each table freed before the next), then the
    SMOKE configs on the card against the CPU.  Returns the launches
    (none: these models run no hand kernel)."""
    import torch
    from repro_torch.configs import bst, dlrm_mlperf, dlrm_rm2, sasrec
    from repro_torch.core.distributed import LocalFabric
    from repro_torch.kernels import _build
    from repro_torch.models import dlrm, embedding, sequential_rec as sr

    assert_fp32_matmuls()
    card = card_line()
    log("recsys_start", resident_gb=gb(torch.cuda.memory_allocated()), card=card)
    _build.reset_launches()

    # SASRec: user states at serve_p99, one user against 1M candidates
    cfg = sasrec.FULL
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    torch.cuda.reset_peak_memory_stats()
    p = sr.init_params(gen, cfg)
    seq = padded_ids(RECSYS_P99, cfg.seq_len, cfg.n_items, gen, dev)
    st, st_ms, st_peak = timed(lambda: sr.sasrec_user_state(p, seq, cfg), 10)
    check_finite(st, (RECSYS_P99, cfg.embed_dim), "sasrec user states")
    cand = distinct_ids(cfg.n_items, RECSYS_CAND, gen, dev)
    (vals, ids), sc_ms, sc_peak = timed(
        lambda: sr.score_candidates(p, st[:1], cand, cfg, top_k=RECSYS_TOP), 5)
    items = p["items"]
    rest = torch.where(torch.isin(cand, ids[0]), float("-inf"),
                       torch.mv(items[cand.long()], st[0])).max()
    err = check_topk(vals[0], ids[0], (items[ids[0].long()] * st[0]).sum(-1), rest,
                     RECSYS_TOP, "sasrec score_candidates")
    log("recsys_sasrec", table_gb=gb(items.numel() * 4), rows=items.shape[0],
        user_state_ms=st_ms, user_state_batch=RECSYS_P99, user_state_peak_gb=st_peak,
        score_candidates_ms=sc_ms, n_candidates=RECSYS_CAND, top_k=RECSYS_TOP,
        score_candidates_peak_gb=sc_peak, topk_max_abs_err=err,
        peak_gb=max(st_peak, sc_peak), card=card)
    del p, items, st, vals, ids, rest, cand, seq
    torch.cuda.empty_cache()

    # BST: CTR logits at serve_p99 and serve_bulk
    cfg = bst.FULL
    torch.cuda.reset_peak_memory_stats()
    p = sr.init_params(gen, cfg)
    row = {}
    for label, b, n in (("serve_p99", RECSYS_P99, 10), ("serve_bulk", RECSYS_BULK, 3)):
        seq = padded_ids(b, cfg.seq_len, cfg.n_items, gen, dev)
        c = torch.randint(0, cfg.n_items, (b,), generator=gen, device=dev, dtype=torch.int32)
        logits, ms, peak = timed(lambda: sr.bst_forward(p, seq, c, cfg), n)
        check_finite(logits, (b,), f"bst {label}")
        row[label] = dict(batch=b, ms=ms, peak_gb=peak)
        del seq, c, logits
    log("recsys_bst", table_gb=gb(p["items"].numel() * 4), rows=p["items"].shape[0],
        forward=row, card=card)
    del p
    torch.cuda.empty_cache()

    # the DLRMs: forward, retrieval over 1M candidates, the sharded lookup
    for cfg in (dlrm_rm2.FULL, dlrm_mlperf.FULL):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        p = dlrm.init_params(gen, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        table = p["table"]

        def batch(b):
            dense = torch.randn((b, cfg.n_dense), generator=gen, device=dev)
            sparse = torch.stack([torch.randint(0, r, (b,), generator=gen, device=dev,
                                                dtype=torch.int32)
                                  for r in cfg.feature_rows], 1)
            return dense, sparse

        row = {}
        for label, b, n in (("serve_p99", RECSYS_P99, 10), ("serve_bulk", RECSYS_BULK, 3)):
            dense, sparse = batch(b)
            logits, ms, peak = timed(lambda: dlrm.forward(p, dense, sparse, cfg), n)
            check_finite(logits, (b,), f"{cfg.name} {label}")
            row[label] = dict(batch=b, ms=ms, peak_gb=peak)
            del dense, sparse, logits
        dense, sparse = batch(RECSYS_P99)
        cand = distinct_ids(cfg.feature_rows[0], RECSYS_CAND, gen, dev)
        (vals, ids), r_ms, r_peak = timed(lambda: dlrm.retrieval_score(
            p, dense[0], sparse[0], cand, cfg, top_k=RECSYS_TOP), 2)
        ids_b = sparse[:1].expand(RECSYS_TOP, cfg.n_sparse).clone()
        ids_b[:, 0] = ids
        direct = dlrm.forward(p, dense[:1].expand(RECSYS_TOP, cfg.n_dense), ids_b, cfg)
        # every candidate once more, in chunks of another size: the largest
        # score outside the top-k
        rest = []
        for c0 in range(0, RECSYS_CAND, dlrm.RETRIEVAL_CHUNK // 2):
            c = cand[c0:c0 + dlrm.RETRIEVAL_CHUNK // 2]
            ib = sparse[:1].expand(c.shape[0], cfg.n_sparse).clone()
            ib[:, 0] = c
            sc = dlrm.forward(p, dense[:1].expand(c.shape[0], cfg.n_dense), ib, cfg)
            rest.append(torch.where(torch.isin(c, ids), float("-inf"), sc).max())
        err = check_topk(vals, ids, direct, torch.stack(rest).max(), RECSYS_TOP,
                         f"{cfg.name} retrieval_score")
        sharded = embedding.lookup_sharded(table, sparse, cfg.table, LocalFabric(4, device=dev))
        if not torch.equal(sharded, embedding.lookup(table, sparse, cfg.table)):
            raise AssertionError(f"{cfg.name}: lookup_sharded over 4 shards differs from lookup")
        log("recsys_dlrm", name=cfg.name, rows=table.shape[0], dim=cfg.embed_dim,
            table_dtype=str(table.dtype), table_gb=gb(table.numel() * table.element_size()),
            init_s=init_s, forward=row, retrieval_ms=r_ms, n_candidates=RECSYS_CAND,
            top_k=RECSYS_TOP, chunk=dlrm.RETRIEVAL_CHUNK, retrieval_peak_gb=r_peak,
            topk_max_abs_err=err, lookup_sharded_4_identical=True,
            peak_gb=gb(torch.cuda.max_memory_allocated()), card=card)
        del p, table, dense, sparse, cand, vals, ids, ids_b, direct, rest, sharded
        torch.cuda.empty_cache()

    launches = dict(_build.launches)
    errs = recsys_smoke_parity(dev)
    log("recsys_smoke_parity", max_abs_err=errs, tol=RECSYS_TOL, topk_ids_identical=True,
        card=card)
    return launches


# ---------------------------------------------------------------------------
# Phases 33-34: training on one card
# ---------------------------------------------------------------------------

TRAIN_SEQ = 4096                 # registry.py train_4k
TRAIN_GLOBAL_BATCH = 256         # registry.py train_4k's global batch
TRAIN_MICRO = 4                  # cells.py build_lm_cell's n_micro
TRAIN_LIMIT_GB = 70.0            # the reckoned peak must stay under this
# a step costs ~0.8 s a sequence on the card (6.3 s at batch 8, PERF.md
# §5): the memory-fitted batch (112) would take ~90 s a step, and the
# phase's 19 steps would pass the script's time limit
TRAIN_TIME_BATCH = 8
# cut from 8 steps (checkpoints every 4, a failure before step 6) to pay
# for phase 38
TRAIN_STEPS = 4
TRAIN_CKPT_EVERY = 2
TRAIN_FAIL_AT = {3: 1}           # one injected failure before step 3
GIN_TRAIN_STEPS = 20
BF16_DENSE_FLOPS = 989e12        # H100 SXM, NVIDIA data sheet, dense
# phase 35: the ("data", "model") local mesh of expert-parallel decode
# (granite's 48 padded experts 12 a shard, deepseek's 64 16 a shard), the
# data shards of compressed_psum, and the ZeRO-1 steps held to phase 33's
EP_MESH = (1, 4)
PSUM_SHARDS = 4
PSUM_CPU_LEAVES = ("final_norm", "blocks/wk")   # the slice also run on the CPU
DIST_TRAIN_STEPS = 2


def train_reckon_gb(cfg, batch: int, seq: int, n_micro: int) -> dict:
    """The training step's reckoned peak, from the config: five float32
    copies of the parameters (the parameters, ``m``, ``v``, the grad sum
    and one microbatch's grads, or the clipped copy in the update), each
    block's bf16 input saved for the backward pass (``remat``), and the
    larger of one block's recompute and one loss chunk: the block's float32
    scores and probabilities over the (causally visible) rows of each KV
    chunk plus one chunk's gradients, and a loss chunk's float32 logits,
    softmax and their gradients."""
    import torch

    p = cfg.physical_param_count()
    bm = batch // n_micro
    cd = torch.empty((), dtype=cfg.compute_dtype).element_size()
    hp, kvc = cfg.n_heads_padded, min(cfg.kv_chunk, seq)
    rows = sum(seq - c * kvc for c in range(-(-seq // kvc)))
    state = 5 * 4 * p
    saved = cfg.n_layers * bm * seq * cfg.d_model * cd
    block = (2 * bm * rows * hp * kvc * 4            # scores and probabilities kept
             + 3 * bm * seq * hp * kvc * 4           # one chunk's grads in flight
             + 8 * bm * seq * max(cfg.d_ff, hp * cfg.head_dim) * 4)
    loss = 4 * bm * min(cfg.loss_chunk, seq) * cfg.vocab_padded * 4
    peak = state + saved + max(block, loss)
    return dict(params=p, state_gb=gb(state), saved_inputs_gb=gb(saved),
                block_recompute_gb=gb(block), loss_chunk_gb=gb(loss), peak_gb=gb(peak))


def train_batch_size(cfg, seq: int, n_micro: int, limit_gb: float = TRAIN_LIMIT_GB,
                     start: int = TRAIN_GLOBAL_BATCH) -> int:
    """The largest multiple of ``n_micro`` (and at least 2 * n_micro) up to
    ``start`` whose reckoned peak stays under ``limit_gb``."""
    for batch in range(start, 2 * n_micro - 1, -n_micro):
        if train_reckon_gb(cfg, batch, seq, n_micro)["peak_gb"] < limit_gb:
            return batch
    raise AssertionError(f"{cfg.name}: no batch of {seq} tokens fits {limit_gb} GB")


def to_host(state) -> list:
    """The state's leaves copied to the host, in the checkpoint's order (a
    copy even of host tensors: the state is updated in place)."""
    from repro_torch.training import tree

    return [x.detach().to("cpu", copy=True) for x in tree.leaves(state)]


def same_bits(state, host: list) -> bool:
    import torch
    from repro_torch.training import tree

    leaves = tree.leaves(state)
    return len(leaves) == len(host) and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b) for a, b in zip(leaves, host))


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Reckoned model FLOPs of a step: 6 N a token plus attention's 12 L h
    dh s a token (PaLM's count; causal masking and remat not subtracted
    or added)."""
    return tokens * (6 * cfg.param_count()
                     + 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq)


def lm_train_phase(dev, cfg, seq: int = TRAIN_SEQ, batch=None, n_steps: int = TRAIN_STEPS,
                   n_micro: int = TRAIN_MICRO, keep_after: int = DIST_TRAIN_STEPS) -> dict:
    """Phase 33 (see the module docstring).  Returns the phase's numbers,
    and under ``"kept"`` the state after ``keep_after`` steps on the host
    (phase 35 starts from the same seed and batches)."""
    import tempfile

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer
    from repro_torch.training import checkpoint, optim, resilience, train_loop

    fitted = train_batch_size(cfg, seq, n_micro)
    batch = batch or min(fitted, TRAIN_TIME_BATCH)
    reckon = train_reckon_gb(cfg, batch, seq, n_micro)
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=SEED)
    to_dev = lambda b: {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    step = train_loop.make_train_step(
        lambda p, b: transformer.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg),
        train_loop.TrainStepConfig(adamw=optim.AdamWConfig(), n_micro=n_micro))

    def fresh():
        params = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
        return params, optim.init(params)

    # the uninterrupted run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    metrics, step_s, kept = [], [], None
    for i in range(n_steps):
        t = time.perf_counter()
        state, m = step(state, to_dev(pipe(i)))
        m = {k: float(v) for k, v in m.items()}          # reads the card
        step_s.append(time.perf_counter() - t)
        metrics.append(m)
        if i + 1 == keep_after:
            kept = to_host(state)
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(metrics):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"lm_train step {i + 1}: a metric is not finite: {m}")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise AssertionError(f"lm_train: the loss did not fall: {metrics}")
    clean = to_host(state)
    del state
    torch.cuda.empty_cache()

    # the same steps under run_resilient, one failure, one restore
    with tempfile.TemporaryDirectory() as d:
        rc = resilience.ResilienceConfig(ckpt_dir=d, ckpt_every=TRAIN_CKPT_EVERY)
        t = time.perf_counter()
        state, report = resilience.run_resilient(
            step, lambda s: to_dev(pipe(s)), fresh(), n_steps, rc,
            failure_hook=resilience.make_scheduled_failures(TRAIN_FAIL_AT))
        resilient_s = time.perf_counter() - t
        if report.restores != 1:
            raise AssertionError(f"lm_train: {report.restores} restores, expected 1")
        if not same_bits(state, clean):
            raise AssertionError("lm_train: the resilient run ended on other bits")
        t = time.perf_counter()
        checkpoint.save(os.path.join(d, "timed"), n_steps, state)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        restored, _ = checkpoint.restore(os.path.join(d, "timed"), state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        if not same_bits(restored, clean):
            raise AssertionError("lm_train: a restored checkpoint has other bits")
        del restored
    del clean

    # one profiled step: the device's busy and idle share
    b = to_dev(pipe(n_steps))
    box = {}
    prof = profile_decode_step(lambda: box.setdefault("s", step(state, b)))
    del box, state
    torch.cuda.empty_cache()
    tokens = batch * seq
    p50 = float(np.percentile(step_s[1:], 50))
    flops = train_flops(cfg, tokens, seq)
    out = dict(
        model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_heads_padded=cfg.n_heads_padded,
        n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        compute_dtype=str(cfg.compute_dtype), remat=cfg.remat, loss_chunk=cfg.loss_chunk,
        params=cfg.param_count(), seq=seq, global_batch=batch,
        memory_fitted_batch=fitted, n_micro=n_micro,
        cut=(f"global batch {batch} of {TRAIN_GLOBAL_BATCH} ({fitted} fit "
             f"{TRAIN_LIMIT_GB} GB by the reckoning; {batch} for the time limit)"),
        reckoned=reckon,
        resident_gb=gb(resident), peak_gb=gb(peak),
        losses=[m["loss"] for m in metrics], grad_norms=[m["grad_norm"] for m in metrics],
        lrs=[m["lr"] for m in metrics], step_s=step_s, step_p50_ms=p50 * 1e3,
        tokens_per_s=tokens / p50, resilient_s=resilient_s, restores=report.restores,
        steps_run=report.steps_run, replay_bit_exact=True, checkpoint_save_s=save_s,
        checkpoint_restore_s=restore_s,
        reckoned_flops=flops, reckoned_bf16_peak_share=flops / p50 / BF16_DENSE_FLOPS,
        profiled_step=prof,
        device_busy_share_of_p50_step=prof["device_busy_ms"] / (p50 * 1e3))
    log("lm_train", **out)
    out["kept"] = kept
    return out


def gin_train_phase(dev, cases=None, n_steps: int = GIN_TRAIN_STEPS) -> dict:
    """Phase 34: GIN FULL at full_graph_sm and molecule, ``n_steps``
    make_train_step steps with AdamWConfig(), twice from the same seed:
    the same bits, the loss falling, ms a step."""
    import torch
    from repro_torch.models import gnn
    from repro_torch.training import optim, train_loop

    out = {}
    for i, (name, cfg, a, cut) in enumerate(cases or gin_cases()):
        if name == "minibatch_lg":
            continue
        t = {k: torch.as_tensor(a[k], device=dev) for k in GIN_ARRAYS if k in a}
        t["n_graphs"] = a.get("n_graphs")
        loss_fn = lambda p, b, cfg=cfg, t=t: gin_loss(p, cfg, t)
        step = train_loop.make_train_step(loss_fn, train_loop.TrainStepConfig())
        runs = []
        for _ in range(2):
            params = gnn.init_params(torch.Generator(device=dev).manual_seed(SEED + 40 + i),
                                     cfg)
            state, losses = (params, optim.init(params)), []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                state, m = step(state, None)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append((to_host(state), [float(x) for x in losses], wall))
        (first, losses, wall), (second, losses2, _) = runs
        if not all(torch.equal(x, y) for x, y in zip(first, second)) or losses != losses2:
            raise AssertionError(f"gin_train {name}: two runs give other bits")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"gin_train {name}: the loss did not fall: {losses}")
        out[name] = dict(ms_per_step=wall * 1e3 / n_steps, first_loss=losses[0],
                         last_loss=losses[-1])
        log("gin_train", cell=name, steps=n_steps, nodes=int(a["feats"].shape[0]),
            edges=int(a["edge_src"].shape[0]), losses=losses, same_bits_twice=True,
            ms_per_step=wall * 1e3 / n_steps, cut=cut)
    return out


# ---------------------------------------------------------------------------
# Phase 35: the distribution layer on one card
# ---------------------------------------------------------------------------


def decode_ms(params, cfg, prompt, toks, n: int, mesh=None) -> list:
    """Prefill, then ``n`` decode steps fed ``toks``' generated tokens, each
    step's wall ms (host clock, synchronised)."""
    from repro_torch.models import transformer

    s0 = prompt.shape[1]
    _, cache = transformer.prefill(params, prompt, cfg, max_seq=s0 + n, mesh=mesh)
    return [wall_ms(lambda i=i: transformer.decode_step(
        params, cache, toks[:, s0 + i], s0 + i, cfg, mesh)) for i in range(n)]


def lockstep_mesh(params, cfg, prompt, n_new: int, mesh) -> list:
    """Prefill and decode with ``mesh`` and without, side by side, both fed
    the mesh path's greedy token: the largest |logit difference| of each
    step; the tokens must agree at every step."""
    import torch
    from repro_torch.models import transformer

    s0 = prompt.shape[1]
    le, cache_e = transformer.prefill(params, prompt, cfg, max_seq=s0 + n_new, mesh=mesh)
    lu, cache_u = transformer.prefill(params, prompt, cfg, max_seq=s0 + n_new)
    diffs = [float((le - lu).abs().max())]
    for i in range(n_new - 1):
        cur = torch.argmax(le, dim=-1).to(torch.int32)
        if not torch.equal(cur, torch.argmax(lu, dim=-1).to(torch.int32)):
            raise AssertionError(f"{cfg.name}: EP and unsharded tokens differ at step {i}")
        le, cache_e = transformer.decode_step(params, cache_e, cur, s0 + i, cfg, mesh)
        lu, cache_u = transformer.decode_step(params, cache_u, cur, s0 + i, cfg)
        if not bool(torch.isfinite(le).all()):
            raise AssertionError(f"{cfg.name}: EP step {i} logits not finite")
        diffs.append(float((le - lu).abs().max()))
    return diffs


def ep_generate(params, cfg, prompt, n_new: int, mesh, what: str) -> tuple:
    """``decode.generate`` with ``mesh``: the tokens, their launches and
    wall seconds; the tokens in range."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving import decode

    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    toks = decode.generate(params, prompt, cfg, max_new_tokens=n_new, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(_build.launches)
    new = toks[:, prompt.shape[1]:]
    if toks.shape != (prompt.shape[0], prompt.shape[1] + n_new) or \
            int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
        raise AssertionError(f"{what}: EP tokens out of shape or range")
    if launches["decode_attention"] == 0:
        raise AssertionError(f"{what}: EP decode never launched decode_attention")
    return toks, launches, wall


def ep_bf16(dev, cfg, seed: int, lm_batch: int, prompt_len: int, new_tokens: int,
            mesh, what: str) -> tuple:
    """bf16 decode through the expert-parallel route beside the unsharded
    one, timed in turns (unsharded, EP, EP, unsharded): p50 a step of each,
    the EP generate's launches.  Returns (numbers, launches)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serving import decode

    max_seq = prompt_len + new_tokens
    reckon = moe_reckon_gb(cfg, cfg.compute_dtype, lm_batch, prompt_len, max_seq)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                                     dtype=cfg.compute_dtype)
    prompt = moe_prompt(dev, cfg, seed, lm_batch, prompt_len)
    toks, launches, wall = ep_generate(params, cfg, prompt, new_tokens, mesh, what)
    plain = decode.generate(params, prompt, cfg, max_new_tokens=new_tokens)
    agree = float((toks[:, prompt_len:] == plain[:, prompt_len:]).float().mean())
    runs = {"unsharded": [], "ep": []}
    for path in ("unsharded", "ep", "ep", "unsharded"):
        runs[path] += decode_ms(params, cfg, prompt, toks, new_tokens,
                                mesh if path == "ep" else None)
    p50 = {k: float(np.percentile(v, 50)) for k, v in runs.items()}
    out = dict(model=cfg.name, compute_dtype="bfloat16", mesh=list(EP_MESH),
               experts_a_shard=cfg.moe.n_experts_padded // EP_MESH[1], reckoned=reckon,
               batch=lm_batch, prompt=prompt_len, new_tokens=new_tokens,
               ep_decode_p50_ms=p50["ep"], unsharded_decode_p50_ms=p50["unsharded"],
               ep_over_unsharded=p50["ep"] / p50["unsharded"], decode_ms=runs,
               ep_generate_s=wall, tokens_agreeing_with_unsharded=agree,
               attention_launches=launches["decode_attention"], resident_gb=gb(resident),
               peak_gb=gb(torch.cuda.max_memory_allocated()))
    del params
    torch.cuda.empty_cache()
    return out, launches


def ep_phase(dev, granite, deepseek, greedy: dict, lm_batch=LM_BATCH, prompt_len=LM_PROMPT,
             new_tokens=LM_NEW_TOKENS) -> list:
    """Phase 35a: MoE decode through expert parallelism on a local (1, 4)
    mesh: granite FULL in float32 (the tokens equal to phase 30's
    unsharded ones, the logit differences of a lockstep run), then bf16
    (p50 a step beside the unsharded p50), then deepseek FULL in bf16 when
    its reckoned peak leaves room.  Returns the launches of every EP path."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer

    mesh = mesh_lib.local_mesh(EP_MESH, ("data", "model"), device=dev)
    seed, want = greedy[granite.name]
    max_seq = prompt_len + new_tokens
    cfg32, reckon, cut = moe_f32_config(granite, lm_batch, prompt_len, max_seq)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(seed), cfg32)
    prompt = moe_prompt(dev, granite, seed, lm_batch, prompt_len)
    toks, f32_launches, wall = ep_generate(params, cfg32, prompt, new_tokens, mesh,
                                           "ep_granite f32")
    if not torch.equal(toks.cpu(), want):
        raise AssertionError("ep_granite f32: EP tokens differ from phase 30's unsharded ones")
    torch.cuda.synchronize()
    from repro_torch.kernels import _build

    _build.reset_launches()
    diffs = lockstep_mesh(params, cfg32, prompt, new_tokens, mesh)
    lock_launches = dict(_build.launches)
    log("ep_granite_f32", model=granite.name, mesh=list(EP_MESH), axes=["data", "model"],
        n_layers=cfg32.n_layers, cut=cut, reckoned=reckon, batch=lm_batch,
        prompt=prompt_len, new_tokens=new_tokens, tokens_equal_phase30=True,
        max_logit_diff_per_step=diffs, generate_s=wall, launches=f32_launches,
        resident_gb=gb(resident), peak_gb=gb(torch.cuda.max_memory_allocated()))
    del params
    torch.cuda.empty_cache()
    paths = [f32_launches, lock_launches]
    bf16, launches = ep_bf16(dev, granite, seed, lm_batch, prompt_len, new_tokens, mesh,
                             "ep_granite bf16")
    log("ep_granite_bf16", **bf16)
    paths.append(launches)
    seed, _ = greedy[deepseek.name]
    reckon = moe_reckon_gb(deepseek, deepseek.compute_dtype, lm_batch, prompt_len, max_seq)
    if reckon["peak_gb"] < MOE_F32_LIMIT_GB:
        bf16, launches = ep_bf16(dev, deepseek, seed, lm_batch, prompt_len, new_tokens,
                                 mesh, "ep_deepseek bf16")
        log("ep_deepseek_bf16", **bf16)
        paths.append(launches)
    else:
        log("ep_deepseek_bf16", skipped=f"reckoned peak {reckon['peak_gb']} GB")
    return paths


def psum_phase(dev, cfg, n_shards: int = PSUM_SHARDS, cpu_leaves=PSUM_CPU_LEAVES) -> dict:
    """Phase 35b: ``compressed_psum`` over a local data axis of
    ``n_shards`` on ``cfg``'s gradient tree (seeded gradients and
    residuals, every leaf ``(n_shards, ...)``): ms a call (p50 of 3), the
    largest error against the float64 mean within one quantisation step,
    and the leaves ``cpu_leaves`` equal to the CPU port's bit for bit."""
    import torch
    from repro_torch.core.distributed import LocalFabric
    from repro_torch.models import transformer
    from repro_torch.training import compression, tree

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    draw = lambda p, scale: torch.randn((n_shards,) + tuple(p.shape), generator=gen,
                                        device=dev) * scale
    grads = tree.tree_map(lambda p: draw(p, 1e-3), params)
    resid = tree.tree_map(lambda p: draw(p, 1e-6), params)
    del params
    names, g_leaves = tree.flatten_with_names(grads)
    per_shard = sum(x[0].numel() for x in g_leaves)
    fabric = LocalFabric(n_shards, device=dev)
    ms, box = [], {}
    for _ in range(3):
        box.clear()
        ms.append(wall_ms(lambda: box.setdefault(
            "out", compression.compressed_psum(grads, resid, fabric))))
    reduced, new_r = box.pop("out")
    worst = 0.0
    r_leaves = tree.leaves(resid)
    for name, g, r, red in zip(names, g_leaves, r_leaves, tree.leaves(reduced)):
        eff = g.double() + r.double()
        step = float(eff.abs().max()) / 127
        err = float((red.double() - eff.mean(0)).abs().max())
        if not err <= step:
            raise AssertionError(f"compressed_psum {name}: error {err} over one step {step}")
        worst = max(worst, err / step)
        del eff
    cpu_fabric = LocalFabric(n_shards, device="cpu")
    keys = ["/".join(f"['{k}']" for k in leaf.split("/")) for leaf in cpu_leaves]
    idx = [names.index(k) for k in keys]
    sub_g = {k: g_leaves[i].cpu() for k, i in zip(keys, idx)}
    sub_r = {k: r_leaves[i].cpu() for k, i in zip(keys, idx)}
    c_red, c_res = compression.compressed_psum(sub_g, sub_r, cpu_fabric)
    card_red, card_res = tree.leaves(reduced), tree.leaves(new_r)
    for k, i in zip(keys, idx):
        if not (torch.equal(card_red[i].cpu(), c_red[k]) and torch.equal(card_res[i].cpu(),
                                                                           c_res[k])):
            raise AssertionError(f"compressed_psum {k}: the card's bits differ from the CPU's")
    n_bytes = sum(4 * x.numel() for x in g_leaves) * 2 + sum(4 * x.numel() for x in g_leaves) \
        + sum(4 * x[0].numel() for x in g_leaves)
    result = dict(shards=n_shards, floats_a_shard=per_shard, leaves=len(g_leaves),
                  grads_gb=gb(4 * n_shards * per_shard), ms=ms,
                  p50_ms=float(np.percentile(ms, 50)),
                  bytes_bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                  largest_error_in_steps=worst, cpu_bits_equal=list(cpu_leaves),
                  resident_gb=gb(resident), peak_gb=gb(torch.cuda.max_memory_allocated()))
    log("compressed_psum", **result)
    del grads, resid, reduced, new_r, g_leaves, r_leaves, card_red, card_res
    torch.cuda.empty_cache()
    return result


def zero1_phase(dev, cfg, kept: list, batch: int, seq: int = TRAIN_SEQ,
                n_micro: int = TRAIN_MICRO, n_steps: int = DIST_TRAIN_STEPS,
                backend: str = "nccl") -> dict:
    """Phase 35c: ``jit_train_step`` over a process group of one rank (a
    TCP store on localhost), ``LM_TRAIN_RULES`` with ZeRO-1, from phase
    33's seed and batches, both ways: the gathered step (the state
    DTensors, every parameter gathered whole, ``loss_fn(mesh=)``) and the
    tensor-parallel one (``tp=``, the loss ``transformer.loss_fn(tp=)``,
    the state this rank's blocks).  After ``n_steps`` each one's
    parameters and optimizer state equal ``kept`` (phase 33's one-device
    state) bit for bit."""
    import datetime
    import socket

    import torch
    import torch.distributed as tdist
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distribution import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.training import optim, train_loop

    def run(mesh, tp) -> dict:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        params = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
        psh, osh = train_loop.state_shardings(transformer.param_logical(cfg),
                                              sharding.LM_TRAIN_RULES, mesh, zero1=True,
                                              params_abs=params)
        bsh = train_loop.batch_shardings(
            {k: ("batch", "seq") for k in ("tokens", "labels", "mask")},
            sharding.LM_TRAIN_RULES, mesh)
        step = train_loop.jit_train_step(train_loop.make_train_step(
            lambda p, b: transformer.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg,
                                             mesh=None if tp else mesh, tp=tp),
            train_loop.TrainStepConfig(adamw=optim.AdamWConfig(), n_micro=n_micro)),
            psh, osh, bsh, tp=tp)
        state = (params, optim.init(params))
        if tp is None:
            state = sharding.place(state, (psh, osh))
        # (one rank's blocks are the whole leaves)
        del params
        pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=SEED)
        step_s, losses = [], []
        for i in range(n_steps):
            t = time.perf_counter()
            state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                    for k, v in pipe(i).items()})
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t)
        how = "gathered" if tp is None else "tensor-parallel"
        if not same_bits(state if tp else sharding.gather_state(state), kept):
            raise AssertionError(f"zero1: the one-rank {how} steps differ from phase 33's "
                                 "bits")
        del state
        return dict(step=how, losses=losses, step_s=step_s, equal_to_one_device_bits=True,
                    resident_gb=gb(resident), peak_gb=gb(torch.cuda.max_memory_allocated()))

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                             world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = mesh_lib.process_group_mesh((1, 1), ("data", "model"), device=dev)
        runs = [run(mesh, None), run(mesh, sharding.TensorParallel(mesh,
                                                                   sharding.LM_TRAIN_RULES))]
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    out = dict(backend=backend, world_size=1, mesh=[1, 1], rules="LM_TRAIN_RULES",
               zero1=True, model=cfg.name, seq=seq, global_batch=batch, n_micro=n_micro,
               steps=n_steps, runs=runs)
    log("zero1_train", **out)
    return out


def dist_phase(dev, granite, deepseek, smollm, greedy: dict, kept: list, batch: int) -> list:
    """Phase 35 (see the module docstring): returns the EP paths' launches."""
    t = time.perf_counter()
    paths = ep_phase(dev, granite, deepseek, greedy)
    psum_phase(dev, smollm)
    zero1_phase(dev, smollm, kept, batch)
    log("dist", seconds=time.perf_counter() - t)
    return paths


# ---------------------------------------------------------------------------
# 36. launch: the dry run of every production cell, and two cells on the card
# ---------------------------------------------------------------------------

LAUNCH_JOBS = 7                 # dry-run worker processes (the host has 8 cores)
LAUNCH_TRAIN_TOL = 0.25         # the lm_train reckoned peak against measured
LAUNCH_DECODE_BATCH = 4         # the qwen decode cell run on the card
LAUNCH_SLOTS = 8                # the replicated Pixie cell's query slots
CARD_GB = 80.0


def dryrun_proc(log_path: str, out: str, *args) -> subprocess.Popen:
    """``python -m repro_torch.launch.dryrun ... --out out`` in a process of
    its own at the lowest CPU priority (CPU only: fake tensors), its output
    to ``log_path``."""
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with open(log_path, "w") as log_f:
        return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                                 "--out", out], env=env, stdout=log_f,
                                stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))


def read_records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def rank_gb(rec: dict) -> float:
    ma = rec["memory_analysis"]
    return (ma["argument_size"] + ma["temp_size"]) / 1e9


def nccl_one_rank(dev, backend: str = "nccl"):
    """A process group of one rank (NCCL: a TCP store on localhost) and its
    (1, 1) mesh."""
    import datetime
    import socket

    import torch.distributed as tdist
    from repro_torch.launch import mesh as mesh_lib

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=1,
                             rank=0, timeout=datetime.timedelta(seconds=300))
    return mesh_lib.process_group_mesh((1, 1), ("data", "model"), device=dev)


def real_cells(dev, card: str) -> dict:
    """Phase 36c: the pixie_replicated cell (FULL walk, shape params set to
    phase 4's 20k-pin graph) and a qwen2.5-3b decode_32k cell (FULL at
    batch 4, seeded bf16 weights) built by launch/cells.py on a one-rank
    NCCL mesh and run with real tensors; each equal to the direct module
    calls bit for bit.  Returns their launches."""
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_arch
    from repro_torch.core import prng, walk
    from repro_torch.core.graph import CSR, PinBoardGraph
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import _build
    from repro_torch.launch import cells
    from repro_torch.models import transformer

    mesh = nccl_one_rank(dev)
    launches = {}
    try:
        # the replicated Pixie cell on phase 4's graph
        sg = synthetic.generate(synthetic.SyntheticGraphConfig(
            n_pins=20_000, n_boards=2_000, n_topics=16, n_langs=4, seed=7), device=dev)
        g = sg.graph
        spec = get_arch("pixie")
        shape = dataclasses.replace(spec.shapes[1], params=dict(
            n_pins=g.n_pins, n_boards=g.n_boards, n_edges=g.n_edges, n_slots=LAUNCH_SLOTS))
        cell = cells.build_cell(spec, shape, mesh)
        rng = np.random.default_rng(SEED + 36)
        pins = rng.choice(synthetic.top_degree_pins(sg, 256), 5, replace=False)
        qp = torch.full((1, LAUNCH_SLOTS), -1, dtype=torch.int32, device=dev)
        qw = torch.zeros((1, LAUNCH_SLOTS), dtype=torch.float32, device=dev)
        qp[0, :5] = torch.as_tensor(pins.astype(np.int32), device=dev)
        qw[0, :5] = torch.as_tensor(rng.uniform(0.1, 1.0, 5).astype(np.float32), device=dev)
        feat = torch.zeros((1,), dtype=torch.int32, device=dev)
        key = prng.key(SEED, dev)
        arrays = (g.p2b.offsets.int(), g.p2b.targets, g.b2p.offsets.int(), g.b2p.targets)
        _build.reset_launches()
        scores, ids = cell.fn(*cells.place(cell, arrays + (qp, qw, feat, key)))
        torch.cuda.synchronize()
        launches["pixie_replicated"] = dict(_build.launches)
        direct_graph = PinBoardGraph(p2b=CSR(*arrays[:2]), b2p=CSR(*arrays[2:]),
                                     n_pins=g.n_pins, n_boards=g.n_boards, max_pin_degree=4096)
        wcfg = dataclasses.replace(spec.config.walk, count_boards=False)
        res = walk.pixie_walk_events(direct_graph, qp[0], qw[0], feat[0],
                                     prng.split(key, 1)[0], wcfg)
        want_s, want_i = walk.recommend_from_events(res, LAUNCH_SLOTS, g.n_pins, qp[0],
                                                    wcfg.top_k)
        if not (torch.equal(scores[0].view(torch.int32), want_s.view(torch.int32))
                and torch.equal(ids[0], want_i)):
            raise AssertionError("launch: the pixie_replicated cell differs from the direct call")
        if launches["pixie_replicated"]["walk_steps_fused"] == 0:
            raise AssertionError("launch: the pixie cell never launched walk_steps_fused")
        check_result(scores[0].cpu().numpy(), ids[0].cpu().numpy(), wcfg.top_k, g.n_pins,
                     "launch pixie cell")
        log("launch_cell", cell="pixie/serve_200m_replicated", card=card,
            params=shape.params, walk="FULL (n_steps 200000, 8192 walkers, top 1000)",
            identical_to_direct_call=True, launches=launches["pixie_replicated"])
        del sg, g, arrays, direct_graph, res

        # a qwen2.5-3b decode_32k cell at batch 4, seeded bf16 weights
        spec = get_arch("qwen2.5-3b")
        cfg = spec.config
        shape = dataclasses.replace(spec.shapes[2], params=dict(
            spec.shapes[2].params, global_batch=LAUNCH_DECODE_BATCH))
        seq = shape.params["seq_len"]
        cell = cells.build_cell(spec, shape, mesh)
        gen = torch.Generator(device=dev).manual_seed(SEED + 36)
        params = transformer.init_params(gen, cfg, dtype=torch.bfloat16)
        cache = transformer.init_kv_cache(cfg, LAUNCH_DECODE_BATCH, seq, device=dev)
        for t_ in cache.values():
            t_.normal_(generator=gen)
        toks = torch.randint(0, cfg.vocab_size, (LAUNCH_DECODE_BATCH,), dtype=torch.int32,
                             generator=gen, device=dev)
        pos = torch.tensor(seq - 1, dtype=torch.int32, device=dev)
        placed = cells.place(cell, (params, cache, toks, pos))
        torch.cuda.synchronize()
        _build.reset_launches()
        logits, new_cache = cell.fn(*placed)
        torch.cuda.synchronize()
        launches["qwen_decode"] = dict(_build.launches)
        del placed
        want, want_cache = transformer.decode_step(params, cache, toks, seq - 1, cfg)
        if not (torch.equal(logits, want)
                and all(torch.equal(new_cache[k], want_cache[k]) for k in ("k", "v"))):
            raise AssertionError("launch: the qwen decode cell differs from decode_step")
        if launches["qwen_decode"]["decode_attention_partial"] != cfg.n_layers:
            raise AssertionError(
                f"launch: the decode cell launched "
                f"{launches['qwen_decode']['decode_attention_partial']} attentions")
        log("launch_cell", cell="qwen2.5-3b/decode_32k", card=card, batch=LAUNCH_DECODE_BATCH,
            seq_len=seq, pos=seq - 1, weights="seeded bf16", identical_to_direct_call=True,
            launches=launches["qwen_decode"], peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del params, cache, logits, new_cache, want, want_cache
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


def start_dry_runs(train_batch: int) -> dict:
    """Phase 36's (a) and (b) started as host processes (fake tensors, no
    card), to trace while 36c uses the card; (b)'s lm_train cell at phase
    33's global batch ``train_batch``."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    path = {k: os.path.join(tmp, f"{k}.jsonl") for k in ("single", "train", "decode")}
    procs = {
        "single": dryrun_proc(path["single"] + ".log", path["single"], "--all", "--mesh",
                              "single", "--subprocess", "--jobs", str(LAUNCH_JOBS)),
        "train": dryrun_proc(path["train"] + ".log", path["train"], "--arch", "smollm-360m",
                             "--shape", "train_4k", "--mesh", "one", "--n-micro",
                             str(TRAIN_MICRO), "--params", json.dumps(
                                 {"seq_len": TRAIN_SEQ, "global_batch": train_batch})),
        "decode": dryrun_proc(path["decode"] + ".log", path["decode"], "--arch", "qwen2.5-3b",
                              "--shape", "decode_32k", "--mesh", "one", "--params",
                              json.dumps({"global_batch": DECODE_32K["batch"]})),
    }
    return {"path": path, "procs": procs}


def launch_phase(dev, trained: dict) -> list:
    """Phase 36 (see the module docstring): returns the real cells'
    launches."""
    import torch
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    # (a) and (b) trace on the host once every phase that times the host is
    # done; (c) runs on the card meanwhile and times nothing
    dry = start_dry_runs(trained["global_batch"])
    path, procs = dry["path"], dry["procs"]
    cell_launches = real_cells(dev, card)
    after_cells = dict(_build.launches)
    for name, proc in procs.items():
        proc.wait(timeout=900)
        if proc.returncode != 0:
            with open(path[name] + ".log") as f:
                raise AssertionError(f"launch: the dry run ({name}) failed:\n{f.read()[-3000:]}")
    if dict(_build.launches) != after_cells:
        raise AssertionError("launch: a kernel launched during the dry run")
    keep = Path("chiprun_out")
    if keep.is_dir():
        for name in path:
            shutil.copy(path[name], keep / f"dryrun_{name}.jsonl")

    # (a) every single-pod cell, reckoned on H100 data-sheet constants
    recs = read_records(path["single"])
    MEASURED["dryrun_single"] = recs        # phase 37 (d) reads the LM serve cells
    bad = [f"{r['arch']}/{r['shape']}" for r in recs if r["status"] != "ok"]
    if len(recs) != 42 or bad:
        raise AssertionError(f"launch: {len(recs)} dry-run records, failed: {bad}")
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        log("dryrun_cell", cell=f"{r['arch']}/{r['shape']}", mesh=r["mesh"],
            n_chips=r["n_chips"], form=r["form"], card=card, gb_per_rank=rank_gb(r),
            card_gb=CARD_GB, flops_by_dtype=r["flops_by_dtype"], hbm_bytes=r["hbm_bytes"],
            collectives=r["collectives"], coll_by_axis=r["coll_by_axis"],
            t_compute_s=r["t_compute_s"], t_memory_s=r["t_memory_s"],
            t_collective_s=r["t_collective_s"], dominant=r["dominant"],
            fake_kernel_calls=r["kernels"], seconds=r["seconds"],
            terms="reckoned from H100 SXM5 data-sheet constants, not measured")
    over = sorted(f"{r['arch']}/{r['shape']}" for r in recs if rank_gb(r) > CARD_GB)
    log("dryrun_summary", mesh="single (16, 16)", card=card, cells_ok=len(recs),
        cells=len(recs), over_80gb_a_rank=over,
        dominant={d: sum(r["dominant"] == d for r in recs)
                  for d in ("compute", "memory", "collective")},
        real_launches_during_dry_run=0)

    # (b) reckoned against measured, one-rank meshes at the card's shapes
    (tr,) = read_records(path["train"])
    (dc,) = read_records(path["decode"])
    reckoned, measured = tr["peak_bytes"] / 1e9, trained["peak_gb"]
    off = reckoned / measured - 1
    log("dryrun_vs_card", cell="smollm-360m/train_4k", mesh="one (1, 1)", card=card,
        seq_len=TRAIN_SEQ, global_batch=trained["global_batch"], n_micro=TRAIN_MICRO,
        reckoned_peak_gb=reckoned, measured_peak_gb=measured,
        train_reckon_gb=trained["reckoned"]["peak_gb"], reckoned_off=off,
        counted_flops=tr["flops"], counted_flops_by_dtype=tr["flops_by_dtype"],
        model_flops_6n_plus_attention=trained["reckoned_flops"],
        counted_over_model=tr["flops"] / trained["reckoned_flops"])
    if abs(off) > LAUNCH_TRAIN_TOL:
        raise AssertionError(f"launch: lm_train reckoned peak {reckoned:.3f} GB is "
                             f"{off:+.1%} from the measured {measured:.3f} GB")
    log("dryrun_vs_card", cell="qwen2.5-3b/decode_32k", mesh="one (1, 1)", card=card,
        global_batch=DECODE_32K["batch"], reckoned_peak_gb=dc["peak_bytes"] / 1e9,
        measured_peak_gb=MEASURED.get("decode_32k_peak_gb"),
        note="the cell casts its float32 parameters at each use; phase "
             "19b decodes with the weights cast to bf16 once")
    log("launch", seconds=time.perf_counter() - t0, card=card)
    return [cell_launches["pixie_replicated"], cell_launches["qwen_decode"]]


# ---------------------------------------------------------------------------
# 37. tp_serve: tensor-parallel LM serving on a local (1, 4) mesh
# ---------------------------------------------------------------------------

TP_MESH = (1, 4)
TP_BATCH = 4
TP_PROMPT = 128
TP_NEW_TOKENS = 16          # decode steps after the prefill's token
TP_BLOCKS = 4               # the decode_32k cache cut into kv_seq blocks
TP_PEAK_OVER_TREE = 1.5     # the local blocks are views: no second tree
TP_F32_LOGIT_TOL = 1e-4     # float32 |logit| gap, tensor-parallel vs unsharded, one routing
TP_GAP_TOL = 1e-4           # a layer's gap over max(1, |output|) before the first routing flip
TP_FLIP_MARGIN = 1e-5       # that flip's k-th less (k+1)-th router probability, at most
TP_ONE_SHARD_STEPS = 32     # decode steps a turn: one-shard tensor-parallel vs unsharded
PARTIAL_LENGTHS = (1, 8192, 8193, 32768, "rows")
LM_SERVE_ARCHS = ("qwen2.5-3b", "smollm-360m", "minitron-4b", "granite-moe-3b-a800m",
                  "deepseek-moe-16b")
LM_SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def efficient_attention_yardstick(q, kb, vb):
    """One PyTorch call returning (o, log-sum-exp) over a block:
    ``aten._scaled_dot_product_efficient_attention(..., compute_log_sumexp=
    True)`` on (b, h, s, dh) tensors, K and V copied out to every query
    head outside the timed call (the op takes no GQA).  Returns (the call,
    how K and V were given)."""
    import torch

    b, h, dh = q.shape
    s, kh = kb.shape[1], kb.shape[2]
    qs = q.to(kb.dtype)[:, :, None, :]
    ks = kb.transpose(1, 2)[:, :, None].expand(b, kh, h // kh, s, dh).reshape(b, h, s, dh)
    vs = vb.transpose(1, 2)[:, :, None].expand(b, kh, h // kh, s, dh).reshape(b, h, s, dh)
    op = torch.ops.aten._scaled_dot_product_efficient_attention
    call = lambda: op(qs, ks, vs, None, True)
    call()
    return call, "kv heads expanded to query heads (a copy outside the call)"


def partial_kernel_check(dev, card: str) -> dict:
    """Phase 37a: the partial kernel against its twin at decode_32k's
    shape (batch 16, 32,768 positions, 16 query / 2 kv heads of 128, bf16)
    cut into 4 blocks, at lengths that leave blocks empty, per-row and
    uniform, q bf16 and float32; the 4 blocks merged against the
    whole-cache kernel; one block's call timed.  Returns the kernels-line
    row (launches filled from the main paths)."""
    import torch
    from repro_torch.kernels import decode_attention as da

    b, h, kh, dh, s = DECODE_32K["batch"], 16, 2, 128, DECODE_32K["seq_len"]
    blk = s // TP_BLOCKS
    q, k, v, _ = attn_inputs(dev, b, h, kh, dh, s, 1, torch.bfloat16, torch.bfloat16, SEED + 37)
    kbs = [k[:, i * blk:(i + 1) * blk].contiguous() for i in range(TP_BLOCKS)]
    vbs = [v[:, i * blk:(i + 1) * blk].contiguous() for i in range(TP_BLOCKS)]
    errs = {"o": 0.0, "m_rel": 0.0, "l_rel": 0.0, "merged": 0.0}
    for q_dtype in (torch.bfloat16, torch.float32):
        qq = q.to(q_dtype)
        for lengths in PARTIAL_LENGTHS:
            if lengths == "rows":
                lengths = torch.randint(1, s + 1, (b,), dtype=torch.int32, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(37))
                lengths[:4] = torch.tensor([1, blk, blk + 1, s], dtype=torch.int32)
            parts = []
            for i in range(TP_BLOCKS):
                got = da.decode_attention_partial(qq, kbs[i], vbs[i], i * blk, lengths)
                want = da.decode_attention_partial_plain(qq, kbs[i], vbs[i], i * blk, lengths)
                if not all(bool(torch.isfinite(x).all()) for x in got):
                    raise AssertionError(f"partial block {i}: not finite")
                errs["o"] = max(errs["o"], float((got[0] - want[0]).abs().max()))
                for name, x, y in (("m_rel", got[1], want[1]), ("l_rel", got[2], want[2])):
                    errs[name] = max(errs[name], float(
                        ((x - y).abs() / torch.clamp(y.abs(), min=1.0)).max()))
                parts.append(got)
            o, m, l = (torch.stack(t) for t in zip(*parts))
            whole = da.decode_attention(qq, k, v, lengths)
            errs["merged"] = max(errs["merged"],
                                 float((da.merge_partials(o, m, l) - whole).abs().max()))
    torch.cuda.synchronize()
    if max(errs.values()) > ATTN_TOL:
        raise AssertionError(f"decode_attention_partial: errors {errs} > {ATTN_TOL}")
    # one full block, as a decode step's shard calls it at pos = s - 1
    kb, vb = kbs[0], vbs[0]
    first = da.decode_attention_partial(q, kb, vb, 0, s)
    if not all(torch.equal(x, y) for x, y in zip(first, da.decode_attention_partial(
            q, kb, vb, 0, s))):
        raise AssertionError("decode_attention_partial: two runs differ")
    library, form = efficient_attention_yardstick(q, kb, vb)
    row = dict(
        name="decode_attention_partial", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention_partial.cu",
        replaces="src/repro/kernels/decode_attention.py:80", launches=None,
        max_abs_err=max(errs.values()),
        ms=device_ms(lambda: da.decode_attention_partial(q, kb, vb, 0, s), 20),
        plain_ms=cuda_ms(lambda: da.decode_attention_partial_plain(q, kb, vb, 0, s), 3),
        library_ms=device_ms(library, 20),
        **cost_bound(q, kb, b * blk, partial=True, per_row=False))
    plan = da.plan(b, h, kh, dh, kb.dtype, blk)
    log("tp_partial_kernel", card=card, q=list(q.shape), block=list(kb.shape),
        blocks=TP_BLOCKS, lengths=[str(x) for x in PARTIAL_LENGTHS],
        q_dtypes=["bfloat16", "float32"], errors=errs, tol=ATTN_TOL,
        splits=plan.n_splits, split_len=plan.split_len, ctas=plan.ctas,
        library_form=form, kernel_over_library=row["ms"] / row["library_ms"],
        share_of_bound=row["bound_ms"] / row["ms"], **row)
    del q, k, v, kbs, vbs
    torch.cuda.empty_cache()
    return row


class LayerTrace:
    """Each layer's output and routing in a lockstep run, both sides:
    ``transformer._ffn`` (the unsharded step, side "u"),
    ``transformer._ffn_tp`` (the tensor-parallel step, "t") and
    ``moe.route_logits`` (both) wrapped while it is entered.  With
    ``impose`` the tensor-parallel pass takes the unsharded pass's expert
    selection and gate values layer by layer (the unsharded pass runs
    first); under autograd the gates' gradient is that of its own router
    probabilities at those experts, renormalised as ``route_logits``
    does (the value plus a zero that carries it)."""

    def __init__(self, impose: bool = False):
        from repro_torch.models import moe, transformer

        self.transformer, self.moe, self.impose = transformer, moe, impose
        self.side = "u"
        self.clear()

    def clear(self):
        self.x = {"u": [], "t": []}
        self.routes = {"u": [], "t": []}
        self.calls = {"u": [], "t": []}     # the FFN call each routing is in

    def __enter__(self):
        tf, moe = self.transformer, self.moe
        self.saved = (tf._ffn, tf._ffn_tp, moe.route_logits)
        ffn, ffn_tp, route_logits = self.saved

        def ffn_u(*a, **kw):
            x, aux = ffn(*a, **kw)
            self.x["u"].append(x.detach().float())
            return x, aux

        def ffn_t(*a, **kw):
            x, aux = ffn_tp(*a, **kw)
            self.x["t"].append(x.detach().float())
            return x, aux

        def route(logits, cfg):
            import torch

            out = route_logits(logits, cfg)
            mine = self.routes[self.side]
            if self.side == "t" and self.impose:
                probs, (_, gate_u, sel) = out[0], self.routes["u"][len(mine)]
                gate = probs.gather(-1, sel.long())
                gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
                out = (probs, gate_u + (gate - gate.detach()), sel)
            mine.append(tuple(t.detach() for t in out))
            self.calls[self.side].append(len(self.x[self.side]))
            return out

        tf._ffn, tf._ffn_tp, moe.route_logits = ffn_u, ffn_t, route
        return self

    def __exit__(self, *exc):
        tf, moe = self.transformer, self.moe
        tf._ffn, tf._ffn_tp, moe.route_logits = self.saved

    def report(self, cfg) -> dict:
        """One pass (the prefill or a decode step) of both sides, then
        cleared: each layer's gap (the largest |difference| of its output
        over max(1, its largest |output|)), and each layer where a token's
        expert set differs: the tokens, and the largest margin between the
        unsharded path's k-th and (k+1)-th router probability over them."""
        gaps = [float((u - t).abs().max()) / max(1.0, float(u.abs().max()))
                for u, t in zip(self.x["u"], self.x["t"])]
        flips = []
        for i, ((pu, _, su), (_, _, st)) in enumerate(zip(self.routes["u"],
                                                           self.routes["t"])):
            diff = (su.sort(-1)[0] != st.sort(-1)[0]).any(-1)
            if bool(diff.any()):
                k = cfg.moe.top_k
                top = pu.sort(-1, descending=True)[0]
                flips.append(dict(layer=cfg.n_layers - cfg.n_scan + i, tokens=int(diff.sum()),
                                  margin=float((top[:, k - 1] - top[:, k])[diff].max()),
                                  call=self.calls["u"][i]))
        self.clear()
        return dict(gaps=gaps, flips=flips)


def tp_lockstep(params, cfg, prompt, n_new: int, mesh, what: str, exact: bool,
                trace: LayerTrace) -> dict:
    """Prefill and ``n_new`` greedy decode steps tensor-parallel over
    ``mesh`` (prefill under LM_TRAIN_RULES, decode under the decode cell's
    serve rules) beside the unsharded path (each pass run first, so that
    ``trace`` may impose its routing), both fed the tensor-parallel path's
    token: the largest |logit difference| of each step, the share of
    (step, row) tokens that agree, and ``trace``'s report of each pass;
    ``exact``: every token must agree.  The tensor-parallel steps'
    launches are counted alone."""
    import torch
    from repro_torch.distribution import sharding
    from repro_torch.kernels import _build
    from repro_torch.models import transformer

    serve = sharding.LM_SERVE_RULES.with_overrides(heads=None, embed=None)
    pre = sharding.TensorParallel(mesh, sharding.LM_TRAIN_RULES, sharding.LM_SERVE_RULES)
    dec = sharding.TensorParallel(mesh, serve)
    logical = transformer.param_logical(cfg)
    s0 = prompt.shape[1]
    max_seq = s0 + n_new
    launches = {k: 0 for k in _build.launches}
    ms = []

    def tp_call(fn):
        trace.side = "t"
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        for k_, n in _build.launches.items():
            launches[k_] += n
        trace.side = "u"
        return out

    passes = []
    with torch.no_grad(), trace:
        lu, cache_u = transformer.prefill(params, prompt, cfg, max_seq=max_seq)
        lt, cache_t = tp_call(lambda: transformer.prefill(
            pre.local_form(params, logical), prompt, cfg, max_seq=max_seq, tp=pre))
        dparams = dec.local_form(params, logical)
        diffs = [float((lt - lu).abs().max())]
        agree = [float((lt.argmax(-1) == lu.argmax(-1)).float().mean())]
        passes.append(trace.report(cfg))
        for i in range(n_new):
            cur = torch.argmax(lt, dim=-1).to(torch.int32)
            lu, cache_u = transformer.decode_step(params, cache_u, cur, s0 + i, cfg)
            lt, cache_t = tp_call(lambda: transformer.decode_step(
                dparams, cache_t, cur, s0 + i, cfg, tp=dec))
            if not bool(torch.isfinite(lt).all()):
                raise AssertionError(f"{what}: tensor-parallel step {i} logits not finite")
            diffs.append(float((lt - lu).abs().max()))
            agree.append(float((lt.argmax(-1) == lu.argmax(-1)).float().mean()))
            passes.append(trace.report(cfg))
    if exact and min(agree) < 1.0:
        raise AssertionError(f"{what}: tensor-parallel tokens differ from the unsharded "
                             f"ones (agreement by step {agree})")
    want = cfg.n_layers * TP_MESH[1] * n_new
    if launches["decode_attention_partial"] != want:
        raise AssertionError(f"{what}: {launches['decode_attention_partial']} partial "
                             f"attention launches, expected {want}")
    return dict(max_logit_diff_per_step=diffs, token_agreement_per_step=agree,
                token_agreement=float(np.mean(agree)), tp_ms=ms, launches=launches,
                passes=passes)


def tp_witness(out: dict, what: str) -> dict:
    """A float32 lockstep run held to what explains its gap.  Up to the
    run's first routing flip (the first pass and layer where a token's
    expert set differs), every layer's gap must stay within TP_GAP_TOL
    and that flip's margins within TP_FLIP_MARGIN: a near-tie that the
    blocked products' float32 reordering can flip (later passes read the
    flipped tokens' cache).  A run with no flip must keep every step's
    logit difference within TP_F32_LOGIT_TOL.  Returns the witness for the
    log line; the per-pass reports leave ``out``."""
    passes = out.pop("passes")
    flip = next(((i, p["flips"][0]) for i, p in enumerate(passes) if p["flips"]), None)
    before = []
    for i, p in enumerate(passes):
        if flip is not None and i == flip[0]:
            before += p["gaps"][:flip[1]["layer"]]
            break
        before += p["gaps"]
    over = next(((i, layer) for i, p in enumerate(passes)
                 for layer, g in enumerate(p["gaps"]) if g > TP_GAP_TOL), None)
    witness = dict(
        first_flip=None if flip is None else dict(flip[1], pass_index=flip[0]),
        flips=[dict(f, pass_index=i) for i, p in enumerate(passes) for f in p["flips"]][:12],
        max_gap_before_flip=max(before) if before else None,
        first_gap_over_tol=over, gap_tol=TP_GAP_TOL, flip_margin_tol=TP_FLIP_MARGIN,
        logit_tol=TP_F32_LOGIT_TOL, prefill_gaps=passes[0]["gaps"],
        last_step_gaps=passes[-1]["gaps"])
    if before and max(before) > TP_GAP_TOL:
        raise AssertionError(f"{what}: a layer's gap {max(before)} > {TP_GAP_TOL} before "
                             f"any routing flip")
    if flip is None:
        if max(out["max_logit_diff_per_step"]) > TP_F32_LOGIT_TOL:
            raise AssertionError(f"{what}: logit difference "
                                 f"{max(out['max_logit_diff_per_step'])} > "
                                 f"{TP_F32_LOGIT_TOL} with no routing flip")
    elif flip[1]["margin"] > TP_FLIP_MARGIN:
        raise AssertionError(f"{what}: the first routing flip {flip} is no near-tie "
                             f"(margin > {TP_FLIP_MARGIN})")
    return witness


def tp_model(dev, cfg, seed: int, card: str, what: str, exact: bool,
             impose: bool = False, **extra) -> list:
    """One model at full width through ``tp_lockstep`` on a local (1, 4)
    mesh, its tree drawn on the card (the local blocks are views of it);
    ``exact`` (float32): every token equal and ``tp_witness``; ``impose``:
    a second run with the unsharded path's routing imposed, held to the
    same.  ``extra`` joins the log line.  Returns each run's launches."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = transformer.init_params(gen, cfg, dtype=cfg.compute_dtype)
    tree = torch.cuda.memory_allocated() - resident
    prompt = moe_prompt(dev, cfg, seed, TP_BATCH, TP_PROMPT)
    mesh = mesh_lib.local_mesh(TP_MESH, ("data", "model"), device=dev)
    runs = {"": tp_lockstep(params, cfg, prompt, TP_NEW_TOKENS, mesh, what, exact,
                            LayerTrace())}
    if impose:
        runs["_routing_imposed"] = tp_lockstep(params, cfg, prompt, TP_NEW_TOKENS, mesh,
                                               what, exact, LayerTrace(impose=True))
    peak = torch.cuda.max_memory_allocated() - resident
    for tag, out in runs.items():
        witness = tp_witness(out, what + tag) if exact else None
        if not exact:
            out.pop("passes")
        out.update(model=cfg.name, card=card, compute_dtype=str(cfg.compute_dtype),
                   cache_dtype=str(cfg.cache_dtype), mesh=list(TP_MESH), batch=TP_BATCH,
                   prompt=TP_PROMPT, decode_steps=TP_NEW_TOKENS, tree_gb=gb(tree),
                   peak_gb=gb(peak),
                   tokens_equal_unsharded=min(out["token_agreement_per_step"]) == 1.0,
                   n_layers=cfg.n_layers, routing_imposed=bool(tag), witness=witness,
                   **extra)
        log(what + tag, **out)
    if peak > TP_PEAK_OVER_TREE * tree:
        raise AssertionError(f"{what}: peak {gb(peak)} GB against a {gb(tree)} GB tree")
    del params
    torch.cuda.empty_cache()
    return [out["launches"] for out in runs.values()]


def one_shard_decode(dev, cfg, seed: int, card: str, what: str) -> None:
    """Phase 37e: the unsharded decode step against the tensor-parallel
    program on a one-shard local (1, 1) mesh, the same bits required:
    p50 wall ms of TP_ONE_SHARD_STEPS greedy steps at batch LM_BATCH
    after an LM_PROMPT-token prompt, turns unsharded, one-shard,
    one-shard, unsharded, and one profiled step of each (device
    operations, busy ms, host launch calls).  Why the unsharded step keeps
    its own layer loop (PERF.md)."""
    import torch
    from repro_torch.distribution import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer

    torch.cuda.empty_cache()
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                                     dtype=cfg.compute_dtype)
    prompt = moe_prompt(dev, cfg, seed, LM_BATCH, LM_PROMPT)
    mesh = mesh_lib.local_mesh((1, 1), ("data", "model"), device=dev)
    serve = sharding.LM_SERVE_RULES.with_overrides(heads=None, embed=None)
    pre = sharding.TensorParallel(mesh, sharding.LM_TRAIN_RULES, sharding.LM_SERVE_RULES)
    dec = sharding.TensorParallel(mesh, serve)
    logical = transformer.param_logical(cfg)
    dparams = dec.local_form(params, logical)
    n, s0 = TP_ONE_SHARD_STEPS, LM_PROMPT
    steps = {
        "unsharded": lambda c, t, i: transformer.decode_step(params, c, t, s0 + i, cfg),
        "one_shard": lambda c, t, i: transformer.decode_step(dparams, c, t, s0 + i, cfg,
                                                             tp=dec),
    }
    with torch.no_grad():
        lu, cache_u = transformer.prefill(params, prompt, cfg, max_seq=s0 + n)
        lt, cache_t = transformer.prefill(pre.local_form(params, logical), prompt, cfg,
                                          max_seq=s0 + n, tp=pre)
        if not torch.equal(lu, lt):
            raise AssertionError(f"{what}: one-shard prefill logits differ from unsharded")
        caches = {"unsharded": cache_u, "one_shard": cache_t}
        toks, want = [torch.argmax(lu, -1).to(torch.int32)], []
        for i in range(n):
            logits, _ = steps["unsharded"](cache_u, toks[i], i)
            want.append(logits)
            toks.append(torch.argmax(logits, -1).to(torch.int32))
        p50 = {"unsharded": [], "one_shard": []}
        for name in ("unsharded", "one_shard", "one_shard", "unsharded"):
            out = []
            ms = [wall_ms(lambda i=i: out.append(steps[name](caches[name], toks[i], i)[0]))
                  for i in range(n)]
            if not all(torch.equal(a, b) for a, b in zip(out, want)):
                raise AssertionError(f"{what}: {name} step logits differ from the first turn")
            p50[name].append(float(np.percentile(ms, 50)))
        prof = {name: profile_decode_step(lambda f=f: f(caches[name], toks[0], 0))
                for name, f in steps.items()}
    launch_calls = {name: sum(h["count"] for h in p["top_host"]
                              if h["op"] in ("cudaLaunchKernel", "cuLaunchKernelEx"))
                    for name, p in prof.items()}
    log("tp_one_shard", model=cfg.name, card=card, compute_dtype=str(cfg.compute_dtype),
        batch=LM_BATCH, prompt=LM_PROMPT, steps=n, turns=["unsharded", "one_shard",
                                                        "one_shard", "unsharded"],
        p50_ms=p50, one_shard_over_unsharded=min(p50["one_shard"]) / min(p50["unsharded"]),
        same_bits=True, launch_calls_in_top_host=launch_calls,
        profiled={name: {k: p[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                            "device_ops")} for name, p in prof.items()})
    del params, dparams, caches, cache_u, cache_t
    torch.cuda.empty_cache()


def tp_dryrun_cells(card: str) -> None:
    """Phase 37d: phase 36's dry-run records of the LM serve cells, which
    now reckon the tensor-parallel programs: deepseek-moe-16b's three under
    80 GB a rank, and every decode cell's all-gathers only its steps'
    (o, m, l), router-logit and logit gathers (no parameter leaf or cache
    layer), its collective term below its memory term."""
    from repro_torch.configs import get_arch

    recs = {(r["arch"], r["shape"]): r for r in MEASURED["dryrun_single"]}
    for arch in LM_SERVE_ARCHS:
        cfg = get_arch(arch).config
        for shape in LM_SERVE_SHAPES:
            r = recs[(arch, shape)]
            fields = dict(cell=f"{arch}/{shape}", card=card, gb_per_rank=rank_gb(r),
                          collectives=r["collectives"], coll_by_axis=r["coll_by_axis"],
                          t_compute_s=r["t_compute_s"], t_memory_s=r["t_memory_s"],
                          t_collective_s=r["t_collective_s"], dominant=r["dominant"],
                          kernels=r["kernels"],
                          terms="reckoned from H100 SXM5 data-sheet constants, not measured")
            if shape != "prefill_32k":
                rows = 1 if shape == "long_500k" else 128 // 16
                n_moe = cfg.n_scan if cfg.moe is not None else 0
                experts = cfg.moe.n_experts_padded if n_moe else 0
                want = 4 * rows * (cfg.n_layers * 16 * cfg.n_heads * (cfg.head_dim + 2)
                                   + cfg.vocab_padded + n_moe * experts)
                fields["all_gather_expected"] = want
                if r["collectives"].get("all-gather") != want:
                    raise AssertionError(f"tp_dryrun {arch}/{shape}: all-gather "
                                         f"{r['collectives']} beyond the step's {want}")
                if r["t_collective_s"] >= r["t_memory_s"]:
                    raise AssertionError(f"tp_dryrun {arch}/{shape}: collective term "
                                         "not below the memory term")
            if arch == "deepseek-moe-16b" and rank_gb(r) >= CARD_GB:
                raise AssertionError(f"tp_dryrun {arch}/{shape}: {rank_gb(r)} GB a rank")
            log("tp_dryrun_cell", **fields)


def tp_serve_phase(dev, qwen, deepseek) -> tuple:
    """Phase 37 (the module docstring): the partial kernel's row and the
    launches of the tensor-parallel paths."""
    import dataclasses as dc

    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    row = partial_kernel_check(dev, card)
    qwen32 = dc.replace(qwen, compute_dtype=torch.float32)
    # deepseek in float32 too (phase 31's config: full depth where the
    # reckoning fits), where the tokens must agree: bf16 decode of its
    # seeded weights flips most greedy tokens on any reordering of sums
    # (phase 31's kernel path against its plain path)
    deep32, reckon, cut = moe_f32_config(deepseek, TP_BATCH, TP_PROMPT,
                                         TP_PROMPT + TP_NEW_TOKENS)
    paths = (tp_model(dev, qwen32, SEED + 371, card, "tp_qwen_f32", exact=True)
             + tp_model(dev, deep32, SEED + 372, card, "tp_deepseek_f32", exact=True,
                        impose=True, reckoned=reckon, cut=cut)
             + tp_model(dev, deepseek, SEED + 372, card, "tp_deepseek_bf16", exact=False))
    for cfg, seed, what in ((qwen, SEED + 373, "qwen_bf16"),
                            (deepseek, SEED + 374, "deepseek_bf16")):
        one_shard_decode(dev, cfg, seed, card, what)
    tp_dryrun_cells(card)
    log("tp_serve", seconds=time.perf_counter() - t0, card=card)
    return row, paths


# ---------------------------------------------------------------------------
# 38. tp_train: tensor-parallel LM training on a local (1, 4) mesh
# ---------------------------------------------------------------------------

TT_MESH = (1, 4)
TT_BATCH, TT_SEQ, TT_MICRO = 4, 1024, 2   # (a), (b): cut from train_4k's 256 x 4096
TT_STEPS = 2
TT_LOSS_TOL = 1e-5          # |loss difference| over |loss|, against make_train_step's
# |gradient difference| over the leaf's own largest |gradient|: the sound
# readings on an H100 were up to 7.8e-7 (a) and 6.7e-6 (b); a leaf the
# tensor-parallel side loses reads 1.0
TT_GRAD_TOL = 1e-4
TT_STATE_GB = 60.0          # (b): the reckoned float32 state, 16 bytes a parameter
TT_TIME_SEQ = 4096          # (c): bf16 at batch 4 x seq 4096
TT_TIME_REPS = 3
# PR 28's dry run of the train_4k cells (the parameters gathered whole):
# GB a rank on the single-pod mesh, and its (compute, memory, collective) s
PR28_TRAIN = {
    "deepseek-moe-16b": (217.2, (3.18, 8.91, 4.88)),
    "granite-moe-3b-a800m": (66.8, (2.8, 13.3, 1.74)),
    "minitron-4b": (86.3, (7, 14.9, 1.3)),
    "qwen2.5-3b": (50.0, (4.19, 8.97, 0.756)),
    "smollm-360m": (13.8, (1.37, 5.9, 0.0895)),
}


def tt_setup(dev, cfg, seq: int, n_steps: int):
    """Phase 38's tensor-parallel context on a local (1, 4) mesh: the
    ``TensorParallel``, the two losses (one device, tensor-parallel), the
    tensor-parallel step's shardings and ``n_steps`` batches from phase
    33's pipeline seed."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distribution import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer

    mesh = mesh_lib.local_mesh(TT_MESH, ("data", "model"), device=dev)
    tp = sharding.TensorParallel(mesh, sharding.LM_TRAIN_RULES)
    pipe = TokenPipeline(cfg.vocab_size, TT_BATCH, seq, seed=SEED)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in pipe(i).items()}
               for i in range(n_steps)]
    one = lambda p, b: transformer.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg)
    tpl = lambda p, b: transformer.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg, tp=tp)
    return tp, one, tpl, batches


def tt_steps(tp, cfg, one, tpl, params, n_micro: int):
    """``make_train_step(one)`` on ``params`` and the tensor-parallel
    ``jit_train_step`` on a copy in the stacked-shard form (views of the
    copy), each with its fresh AdamW state: ``((step, state), (step,
    state))``."""
    from repro_torch.distribution import sharding
    from repro_torch.models import transformer
    from repro_torch.training import optim, train_loop
    from repro_torch.training import tree as tree_lib

    logical = transformer.param_logical(cfg)
    conf = train_loop.TrainStepConfig(adamw=optim.AdamWConfig(), n_micro=n_micro)
    copy = tree_lib.tree_map(lambda x: x.clone(), params)
    psh, osh = train_loop.state_shardings(logical, sharding.LM_TRAIN_RULES, tp.mesh,
                                          zero1=True, params_abs=copy)
    bsh = train_loop.batch_shardings({k: ("batch", "seq") for k in ("tokens", "labels",
                                                                   "mask")},
                                     sharding.LM_TRAIN_RULES, tp.mesh)
    opt = optim.init(copy)
    tp_state = (tp.local_form(copy, logical),
                optim.OptState(tp.local_form(opt.m, logical), tp.local_form(opt.v, logical),
                               opt.step))
    return ((train_loop.make_train_step(one, conf), (params, optim.init(params))),
            (train_loop.jit_train_step(train_loop.make_train_step(tpl, conf), psh, osh, bsh,
                                       tp=tp), tp_state))


def tt_grads(tp, cfg, one, tpl, params, batch, trace=None) -> dict:
    """A step's loss and gradients (``accumulated_grads`` over TT_MICRO
    microbatches) on one device and tensor-parallel (the stacked-shard
    form, views of ``params``; ``trace``'s sides "u" and "t"), held leaf
    by leaf, each put back whole one at a time: the loss within
    TT_LOSS_TOL relative and every gradient within TT_GRAD_TOL times its
    leaf's own largest |gradient| (``ok``; a leaf whose gradient is all
    zero must be matched exactly).  Each leaf's largest difference, its
    largest |gradient| and their ratio are printed."""
    import contextlib

    import torch
    from repro_torch.distribution import sharding
    from repro_torch.models import transformer
    from repro_torch.training import microbatch
    from repro_torch.training import tree as tree_lib

    logical = transformer.param_logical(cfg)
    with trace if trace is not None else contextlib.nullcontext():
        if trace is not None:
            trace.side = "u"
        lu, gu = microbatch.accumulated_grads(one, params, batch, TT_MICRO)
        if trace is not None:
            trace.side = "t"
        lt, gt = microbatch.accumulated_grads(tpl, tp.local_form(params, logical), batch,
                                              TT_MICRO)

    def leaf(names, got, want):
        whole = tp.whole_form(got, names)
        return torch.stack([(whole.float() - want.float()).abs().max(),
                            want.float().abs().max()]).cpu()

    res = sharding.map_logical(leaf, logical, gt, gu)
    del gu, gt
    names, pairs = tree_lib.flatten_with_names(res)
    grads = {}
    for n, (diff, top) in zip(names, [p.tolist() for p in pairs]):
        rel = diff / top if top > 0 else (0.0 if diff == 0 else float("inf"))
        grads[n] = dict(max_diff=diff, max_abs=top, rel=rel)
    worst = max(g["rel"] for g in grads.values())
    loss_rel = abs(float(lt) - float(lu)) / abs(float(lu))
    return dict(loss_one=float(lu), loss_tp=float(lt), loss_rel_diff=loss_rel,
                grads=grads, max_grad_rel_diff=worst,
                ok=loss_rel <= TT_LOSS_TOL and worst <= TT_GRAD_TOL)


def tp_train_smollm(dev, cfg, card: str) -> dict:
    """Phase 38a: SmolLM-360M FULL in float32 (the module docstring)."""
    import dataclasses as dc

    import torch
    from repro_torch.models import transformer

    cfg = dc.replace(cfg, compute_dtype=torch.float32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tp, one, tpl, batches = tt_setup(dev, cfg, TT_SEQ, TT_STEPS)
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    grads = tt_grads(tp, cfg, one, tpl, params, batches[0])
    if not grads["ok"]:
        raise AssertionError(f"tp_train_smollm: loss or gradients apart: {grads}")
    (ostep, ostate), (tstep, tstate) = tt_steps(tp, cfg, one, tpl, params, TT_MICRO)
    metrics = {"one": [], "tp": []}
    for b in batches:
        ostate, m1 = ostep(ostate, b)
        tstate, m2 = tstep(tstate, b)
        metrics["one"].append({k: float(v) for k, v in m1.items()})
        metrics["tp"].append({k: float(v) for k, v in m2.items()})
    rel = [abs(a["loss"] - b["loss"]) / abs(a["loss"]) for a, b in zip(metrics["one"],
                                                                       metrics["tp"])]
    if max(rel) > TT_LOSS_TOL:
        raise AssertionError(f"tp_train_smollm: step losses apart {rel}")
    out = dict(model=cfg.name, card=card, mesh=list(TT_MESH), rules="LM_TRAIN_RULES",
               compute_dtype="float32", n_layers=cfg.n_layers,
               heads=f"{cfg.n_heads} padded to {cfg.n_heads_padded}, "
                     f"{cfg.n_heads_padded // TT_MESH[1]} a shard; {cfg.n_kv_heads} kv whole",
               d_ff_a_shard=cfg.d_ff // TT_MESH[1],
               vocab_a_shard=cfg.vocab_padded // TT_MESH[1], batch=TT_BATCH, seq=TT_SEQ,
               n_micro=TT_MICRO, steps=TT_STEPS,
               cut=f"batch {TT_BATCH} x seq {TT_SEQ} of train_4k's 256 x 4096",
               first_step=grads, step_losses=metrics, step_loss_rel_diff=rel,
               peak_gb=gb(torch.cuda.max_memory_allocated()),
               seconds=time.perf_counter() - t0)
    del params, ostate, tstate
    torch.cuda.empty_cache()
    log("tp_train_smollm", **out)
    return out


def tt_depth(cfg) -> tuple:
    """Phase 38b's depth: the deepest of dense0 plus 3, 2 or 1 MoE layers
    whose float32 training state, reckoned at 16 bytes a parameter, stays
    under TT_STATE_GB."""
    import dataclasses as dc

    for n in (4, 3, 2):
        c = dc.replace(cfg, n_layers=n)
        state = 16 * c.physical_param_count() / 1e9
        if state < TT_STATE_GB:
            return c, state
    raise AssertionError(f"{cfg.name}: no depth fits {TT_STATE_GB} GB")


def tp_train_deepseek(dev, cfg, card: str) -> dict:
    """Phase 38b: deepseek-moe-16b FULL width, depth cut (the module
    docstring)."""
    import dataclasses as dc

    import torch
    from repro_torch.models import transformer

    cfg = dc.replace(cfg, compute_dtype=torch.float32,
                     moe=dc.replace(cfg.moe, ep_shard_map=True))
    cfg, state_gb = tt_depth(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tp, one, tpl, batches = tt_setup(dev, cfg, TT_SEQ, 1)
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED + 38), cfg)
    trace = LayerTrace()
    runs = {"": tt_grads(tp, cfg, one, tpl, params, batches[0], trace)}
    rep = trace.report(cfg)
    flip = rep["flips"][0] if rep["flips"] else None
    witness = dict(first_flip=flip, flips=rep["flips"][:12], gaps=rep["gaps"],
                   gap_tol=TP_GAP_TOL, flip_margin_tol=TP_FLIP_MARGIN)
    if flip is not None:
        # the FFN calls before the first flip's (forward and remat recompute,
        # both microbatches) must be close and the flip a near-tie; then the
        # routing imposed, held as (a)
        before = rep["gaps"][:flip["call"]]
        witness["max_gap_before_flip"] = max(before) if before else None
        if before and max(before) > TP_GAP_TOL:
            raise AssertionError(f"tp_train_deepseek: gap {max(before)} before the first flip")
        if flip["margin"] > TP_FLIP_MARGIN:
            raise AssertionError(f"tp_train_deepseek: the first routing flip {flip} is no "
                                 "near-tie")
        trace = LayerTrace(impose=True)
        runs["_routing_imposed"] = tt_grads(tp, cfg, one, tpl, params, batches[0], trace)
        trace.report(cfg)
    elif max(rep["gaps"]) > TP_GAP_TOL:
        raise AssertionError(f"tp_train_deepseek: gap {max(rep['gaps'])} with no flip")
    held = runs.get("_routing_imposed", runs[""])
    if not held["ok"]:
        raise AssertionError(f"tp_train_deepseek: loss or gradients apart: {held}")
    out = dict(model=cfg.name, card=card, mesh=list(TT_MESH), compute_dtype="float32",
               n_layers=cfg.n_layers, moe_layers=cfg.n_scan, ep_shard_map=True,
               experts_a_shard=cfg.moe.n_experts_padded // TT_MESH[1],
               params=cfg.physical_param_count(), reckoned_state_gb=state_gb,
               cut=f"depth {cfg.n_layers} of 28 (dense0 + {cfg.n_scan} MoE layers: float32 "
                   f"state under {TT_STATE_GB} GB at 16 bytes a parameter); batch "
                   f"{TT_BATCH} x seq {TT_SEQ}",
               batch=TT_BATCH, seq=TT_SEQ, n_micro=TT_MICRO, runs=runs, witness=witness,
               peak_gb=gb(torch.cuda.max_memory_allocated()),
               seconds=time.perf_counter() - t0)
    del params
    torch.cuda.empty_cache()
    log("tp_train_deepseek", **out)
    return out


def tp_train_timing(dev, cfg, card: str) -> dict:
    """Phase 38c: SmolLM-360M FULL in bf16 at batch 4 x seq 4096, the
    one-device step and the (1, 4) tensor-parallel step timed in turns,
    one tensor-parallel step profiled."""
    import torch
    from repro_torch.models import transformer

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp, one, tpl, batches = tt_setup(dev, cfg, TT_TIME_SEQ, 1)
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    (ostep, ostate), (tstep, tstate) = tt_steps(tp, cfg, one, tpl, params, TT_MICRO)
    box = {"one": [ostep, ostate], "tp": [tstep, tstate]}
    b = batches[0]
    ms, peak, loss = {"one": [], "tp": []}, {"one": 0.0, "tp": 0.0}, {}

    def run(side):
        stp, st = box[side]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        st, m = stp(st, b)
        loss[side] = float(m["loss"])                # reads the card
        torch.cuda.synchronize()
        box[side][1] = st
        peak[side] = max(peak[side], gb(torch.cuda.max_memory_allocated() - before))
        return (time.perf_counter() - t) * 1e3

    for _ in range(TT_TIME_REPS):
        for side in ("one", "tp"):
            ms[side].append(run(side))
    prof = profile_decode_step(lambda: box["tp"].__setitem__(1, tstep(box["tp"][1], b)[0]),
                               host=False)
    p50 = {k: float(np.percentile(v, 50)) for k, v in ms.items()}
    out = dict(model=cfg.name, card=card, mesh=list(TT_MESH), compute_dtype="bfloat16",
               batch=TT_BATCH, seq=TT_TIME_SEQ, n_micro=TT_MICRO, turns="one, tp x 3",
               step_ms=ms, p50_ms=p50, tp_over_one=p50["tp"] / p50["one"],
               tokens_per_s={k: TT_BATCH * TT_TIME_SEQ / (v / 1e3) for k, v in p50.items()},
               step_peak_over_resident_gb=peak, last_loss=loss,
               resident_gb=gb(torch.cuda.memory_allocated()),
               profiled_tp_step={k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                      "device_idle_share", "device_ops",
                                                      "top")},
               seconds=time.perf_counter() - t0)
    del box, ostate, tstate, params
    torch.cuda.empty_cache()
    log("tp_train_timing", **out)
    return out


def tp_train_dryrun(card: str) -> None:
    """Phase 38e: phase 36's dry-run records of the five LM train_4k
    cells, now the tensor-parallel program: each under 80 GB a rank and
    under PR 28's figure, its all-gathers over 'model' only the MoE
    router's logits ``(16 t, E_pad / 16)`` float32 (none in a dense
    model: no parameter leaf), its terms beside PR 28's."""
    from repro_torch.configs import get_arch

    recs = {(r["arch"], r["shape"]): r for r in MEASURED["dryrun_single"]}
    for arch, (old_gb, old_terms) in PR28_TRAIN.items():
        r = recs[(arch, "train_4k")]
        cfg = get_arch(arch).config
        model = r.get("gathers_by_axis", {}).get("model", {})
        ok_shapes = {k for k in model if cfg.moe is not None and k.endswith(" float32")
                     and k.split(")")[0].split(", ")[-1] == str(cfg.moe.n_experts_padded // 16)}
        if set(model) != ok_shapes:
            raise AssertionError(f"tp_train_dryrun {arch}: gathered over 'model': {model}")
        if rank_gb(r) >= CARD_GB or rank_gb(r) > old_gb:
            raise AssertionError(f"tp_train_dryrun {arch}: {rank_gb(r)} GB a rank "
                                 f"(PR 28: {old_gb})")
        log("tp_train_dryrun_cell", cell=f"{arch}/train_4k", card=card,
            gb_per_rank=rank_gb(r), pr28_gb_per_rank=old_gb,
            terms_s=[r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]],
            pr28_terms_s=list(old_terms), dominant=r["dominant"],
            collectives=r["collectives"], coll_by_axis=r["coll_by_axis"],
            gathers_over_model=model,
            terms="reckoned from H100 SXM5 data-sheet constants, not measured")


def tp_train_phase(dev, smollm, deepseek) -> dict:
    """Phase 38 (the module docstring): the launches of its paths (the
    training path reaches no hand kernel; the counts are read all the
    same)."""
    import torch
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    _build.reset_launches()
    tp_train_smollm(dev, smollm, card)
    tp_train_deepseek(dev, deepseek, card)
    tp_train_timing(dev, smollm, card)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    tp_train_dryrun(card)
    log("tp_train", seconds=time.perf_counter() - t0, card=card)
    return launches


# ---------------------------------------------------------------------------
# 39. MoE routing over the global batch across data ranks
# ---------------------------------------------------------------------------

GR_BLOCKS = (2, 4)          # (a): the tokens in 2 and in 4 data blocks
GR_BATCH, GR_SEQ = 4, 256   # (a): one microbatch
GR_IDS = 256                # the tokens' ids: a skewed draw, so that the cut binds
GR_PROMPT = 128             # (b): batch GR_BATCH split 2 ways
GR_DECODE = 8               # (b): greedy decode steps after the prefill's token
GR_HIDDEN_TOL = 2e-6        # |hidden difference| over max(1, |one device's|)
GR_LOSS_TOL = 1e-6          # |loss difference| over |loss|
GR_GRAD_TOL = 1e-4          # a leaf's |gradient difference| over its own largest (phase 38)
# a gloo rank's hidden rows against the one device's: its dense products run
# on half the rows, where cuBLAS may pick another kernel (another summation
# order) than for the whole batch; phase 37's bound on reordered products
GR_RANK_HIDDEN_TOL = TP_GAP_TOL
GR_RANKS = 2                # gloo processes on the one card
GR_GLOO_LEAVES = ("blocks/moe/router", "blocks/ln1", "blocks/ln2", "final_norm")
GR_WAIT_S = 300.0


def gr_config(deepseek):
    """deepseek-moe-16b FULL in float32 without ``ep_shard_map``, its depth
    cut as phase 38b cuts it (dense0 + 3 MoE layers)."""
    import dataclasses as dc

    import torch

    cfg = dc.replace(deepseek, compute_dtype=torch.float32,
                     moe=dc.replace(deepseek.moe, ep_shard_map=False))
    return tt_depth(cfg)


def gr_batch(dev, cfg, seed: int = SEED + 39) -> dict:
    """(a)'s microbatch: GR_BATCH x GR_SEQ tokens drawn from GR_IDS ids,
    the next token its label, the last position masked."""
    import torch

    tokens = torch.randint(0, GR_IDS, (GR_BATCH, GR_SEQ), dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    mask = torch.ones((GR_BATCH, GR_SEQ), dtype=torch.float32, device=dev)
    mask[:, -1] = 0.0
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1), "mask": mask}


def gr_params(dev, cfg):
    import torch
    from repro_torch.models import transformer

    return transformer.init_params(torch.Generator(device=dev).manual_seed(SEED + 39), cfg)


def gr_witness(cfg, sels: list) -> list:
    """(c): each MoE layer's kept assignments under the global cut and
    under per-rank cuts of GR_BLOCKS blocks (``moe.kept_assignments``),
    the experts past the global capacity and the assignments the cuts
    keep differently."""
    from repro_torch.models import moe

    rows = []
    for i, sel in enumerate(sels):
        whole = moe.kept_assignments(sel, cfg.moe)
        counts = sel.reshape(-1).long().bincount(minlength=cfg.moe.n_experts_padded)
        row = dict(layer=cfg.n_layers - cfg.n_scan + i, assignments=sel.numel(),
                   capacity=cfg.moe.capacity(sel.shape[0]),
                   experts_over_capacity=int((counts > cfg.moe.capacity(sel.shape[0])).sum()),
                   kept_global=int(whole.sum()))
        for n in GR_BLOCKS:
            split = moe.kept_assignments(sel, cfg.moe, n)
            row[f"kept_per_rank_{n}"] = int(split.sum())
            row[f"differ_{n}"] = int((whole != split).sum())
        rows.append(row)
    for n in GR_BLOCKS:
        if not any(r[f"differ_{n}"] for r in rows):
            raise AssertionError(f"global_route: the global cut and {n} per-rank cuts keep "
                                 f"the same assignments: {rows}")
    if not any(r["kept_global"] < r["assignments"] for r in rows):
        raise AssertionError(f"global_route: the global cut drops nothing: {rows}")
    return rows


def gr_grads(loss, leaves) -> list:
    import torch

    return [g.detach() for g in torch.autograd.grad(loss, leaves)]


def gr_compare_grads(names, got, want) -> dict:
    out = {}
    for n, a, b in zip(names, got, want):
        diff, top = float((a - b).abs().max()), float(b.abs().max())
        out[n] = dict(max_diff=diff, max_abs=top,
                      rel=diff / top if top > 0 else (0.0 if diff == 0 else float("inf")))
    return out


_GR_RANK = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.global_route_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
"""


def global_route_rank(rank: int, work: str, device: str, config: str) -> None:
    """One of phase 39's GR_RANKS gloo processes on the one card: the
    collectives the route needs (an all-reduce and an all-gather of CUDA
    tensors) probed, then, once the parent has freed the card (its ``go``
    file), the deepseek model of (a) through ``transformer.forward`` and
    ``loss_fn`` with ``mesh=`` a (2, 1) process-group mesh on this rank's
    rows, held to the one device's whole batch, which each rank computes
    too: its hidden rows, the loss (the ranks' shares summed), and the
    gradients of GR_GLOO_LEAVES (summed over the ranks; the router's reads
    every rank's probabilities through the global aux).  ``config`` names
    the deepseek config (``FULL``; ``SMOKE`` in a rehearsal on the CPU,
    ``device`` "cpu")."""
    import datetime

    import torch
    import torch.distributed as tdist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.training import tree as tree_lib

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    res = {"rank": rank}
    tdist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=GR_RANKS,
                             rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        x = torch.full((3,), float(rank + 1), device=dev)
        tdist.all_reduce(x)
        y = torch.empty(GR_RANKS * 2, dtype=torch.long, device=dev)
        tdist.all_gather_into_tensor(y, torch.full((2,), rank, dtype=torch.long, device=dev))
        res["probe"] = dict(all_reduce=x.tolist(), all_gather=y.tolist())
        res["gloo_cuda"] = (x.tolist() == [3.0] * 3 and y.tolist() == [0, 0, 1, 1])
    except Exception as e:        # the installation's gloo takes no CUDA tensors
        res["gloo_cuda"], res["error"] = False, repr(e)[:500]
    if res["gloo_cuda"]:
        go = Path(work) / "go"
        t = time.perf_counter()
        while not go.exists():
            if time.perf_counter() - t > GR_WAIT_S:
                raise TimeoutError("phase 39's parent never freed the card")
            time.sleep(0.05)
        t0 = time.perf_counter()
        assert_fp32_matmuls()
        cfg, _ = gr_config(getattr(deepseek_moe_16b, config))
        params = gr_params(dev, cfg)
        b = gr_batch(dev, cfg)
        mesh = mesh_lib.process_group_mesh((GR_RANKS, 1), ("data", "model"), device=dev)
        data = mesh.fabric("data")
        rows = slice(rank * GR_BATCH // GR_RANKS, (rank + 1) * GR_BATCH // GR_RANKS)
        traces = [LayerTrace(), LayerTrace()]
        with torch.no_grad(), traces[0]:
            h0, _ = transformer.forward(params, b["tokens"], cfg)
        with torch.no_grad(), traces[1]:
            h1, _ = transformer.forward(params, b["tokens"][rows], cfg, mesh=mesh)
        scale = max(1.0, float(h0[rows].abs().max()))
        res["hidden_rel_diff"] = float((h1 - h0[rows]).abs().max()) / scale
        # each layer's output gap (dense0's has no MoE: the dense products alone)
        res["layer_gaps"] = [float((u - w[rows]).abs().max()) / max(1.0, float(w.abs().max()))
                             for w, u in zip(traces[0].x["u"], traces[1].x["u"])]
        del h0, h1, traces
        names, leaves = tree_lib.flatten_with_names(params)
        keep = [i for i, n in enumerate(names)
                if n.replace("['", "").replace("']", "") in GR_GLOO_LEAVES]
        sub = [leaves[i] for i in keep]
        for x_ in sub:
            x_.requires_grad_(True)
        l0 = transformer.loss_fn(params, b["tokens"], b["labels"], b["mask"], cfg)
        g0 = gr_grads(l0, sub)
        l1 = transformer.loss_fn(params, b["tokens"][rows], b["labels"][rows],
                                 b["mask"][rows], cfg, mesh=mesh)
        g1 = [data.psum(g[None]) for g in gr_grads(l1, sub)]
        loss = float(data.psum(l1.detach()[None]))
        l0 = float(l0.detach())
        res.update(loss_one=l0, loss_ranks=loss, loss_rel_diff=abs(loss - l0) / abs(l0),
                   grads=gr_compare_grads([names[i] for i in keep], g1, g0),
                   peak_gb=(gb(torch.cuda.max_memory_allocated()) if dev.type == "cuda"
                            else None),
                   seconds=time.perf_counter() - t0)
    tdist.destroy_process_group()
    with open(Path(work) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def global_route_phase(dev, deepseek) -> dict:
    """Phase 39 (the module docstring); returns (b)'s launches."""
    import tempfile

    import torch
    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.serving import decode
    from repro_torch.training import tree as tree_lib

    t0 = time.perf_counter()
    card = card_line()
    work = tempfile.mkdtemp(prefix="chip_smoke_route_")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    here = str(Path(__file__).resolve().parent)
    config = next(k for k in ("FULL", "SMOKE") if getattr(deepseek_moe_16b, k) is deepseek)
    ranks = [subprocess.Popen([sys.executable, "-c", _GR_RANK, here, str(r), work, str(dev),
                               config],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(GR_RANKS)]
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        assert_fp32_matmuls()
        cfg, state_gb = gr_config(deepseek)
        params = gr_params(dev, cfg)
        b = gr_batch(dev, cfg)
        # (a) forward, then the loss and every leaf's gradient, per block count
        trace = LayerTrace()
        with torch.no_grad(), trace:
            h0, a0 = transformer.forward(params, b["tokens"], cfg)
        sels = [r[2] for r in trace.routes["u"]]
        scale = max(1.0, float(h0.abs().max()))
        names, leaves = tree_lib.flatten_with_names(params)
        for x in leaves:
            x.requires_grad_(True)
        l0 = transformer.loss_fn(params, b["tokens"], b["labels"], b["mask"], cfg)
        g0 = gr_grads(l0, leaves)
        blocks = {}
        for n in GR_BLOCKS:
            mesh = mesh_lib.local_mesh((n, 1), ("data", "model"), device=dev)
            with torch.no_grad():
                h, a = transformer.forward(params, b["tokens"], cfg, mesh=mesh)
            l1 = transformer.loss_fn(params, b["tokens"], b["labels"], b["mask"], cfg,
                                     mesh=mesh)
            grads = gr_compare_grads(names, gr_grads(l1, leaves), g0)
            blocks[n] = dict(hidden_rel_diff=float((h - h0).abs().max()) / scale,
                             aux=float(a), aux_one=float(a0), loss=float(l1.detach()),
                             loss_one=float(l0.detach()),
                             loss_rel_diff=abs(float(l1.detach()) - float(l0.detach()))
                             / abs(float(l0.detach())),
                             max_grad_rel_diff=max(g["rel"] for g in grads.values()),
                             grads=grads)
            del h, l1, grads
        del h0, g0, l0
        for x in leaves:
            x.requires_grad_(False)
        bad = {n: r for n, r in blocks.items()
               if r["hidden_rel_diff"] > GR_HIDDEN_TOL or r["loss_rel_diff"] > GR_LOSS_TOL
               or r["max_grad_rel_diff"] > GR_GRAD_TOL}
        # (c) the cuts keep different sets at (a)'s batch
        witness = gr_witness(cfg, sels)
        # (b) prefill and greedy decode split 2 ways against one device
        prompt = b["tokens"][:, :GR_PROMPT].contiguous()
        with torch.no_grad():
            want = decode.generate(params, prompt, cfg, max_new_tokens=GR_DECODE + 1)
            torch.cuda.synchronize()
            _build.reset_launches()
            got = decode.generate(params, prompt, cfg, max_new_tokens=GR_DECODE + 1,
                                  mesh=mesh_lib.local_mesh((2, 1), ("data", "model"),
                                                           device=dev))
            torch.cuda.synchronize()
        launches = dict(_build.launches)
        tokens_equal = bool(torch.equal(got, want))
        peak = gb(torch.cuda.max_memory_allocated())
        del params, leaves, b, prompt, got, want, trace, sels
        torch.cuda.empty_cache()
        # the gloo ranks, once the card is free
        (Path(work) / "go").touch()
        outs = [p.communicate(timeout=GR_WAIT_S + 120) for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(ranks, outs):
        if p.returncode != 0:
            raise AssertionError(f"global_route: a gloo rank failed: {err[-3000:]}")
    gloo = [json.loads((Path(work) / f"rank{r}.json").read_text()) for r in range(GR_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    gloo_ok = all(g["gloo_cuda"] for g in gloo)
    gloo_bad = [g["rank"] for g in gloo if gloo_ok and (
        g["hidden_rel_diff"] > GR_RANK_HIDDEN_TOL or g["loss_rel_diff"] > GR_LOSS_TOL
        or max(v["rel"] for v in g["grads"].values()) > GR_GRAD_TOL)]
    log("global_route_witness", card=card, model=cfg.name, batch=GR_BATCH, seq=GR_SEQ,
        token_ids=GR_IDS, layers=witness)
    log("global_route_gloo", card=card, ranks=GR_RANKS, gloo_cuda=gloo_ok,
        leaves=list(GR_GLOO_LEAVES), per_rank=gloo,
        tol=dict(hidden=GR_RANK_HIDDEN_TOL, loss=GR_LOSS_TOL, grad=GR_GRAD_TOL),
        note=None if gloo_ok else "gloo on this installation takes no CUDA tensors: "
                                  "the process-group route was not run on the card")
    out = dict(model=cfg.name, card=card, compute_dtype="float32", ep_shard_map=False,
               n_layers=cfg.n_layers, moe_layers=cfg.n_scan, params=cfg.physical_param_count(),
               reckoned_state_gb=state_gb, batch=GR_BATCH, seq=GR_SEQ, token_ids=GR_IDS,
               cut=f"depth {cfg.n_layers} of 28 (phase 38b's cut); one microbatch of "
                   f"{GR_BATCH} x {GR_SEQ}",
               blocks={n: {k: v for k, v in r.items() if k != "grads"}
                       for n, r in blocks.items()},
               tol=dict(hidden=GR_HIDDEN_TOL, loss=GR_LOSS_TOL, grad=GR_GRAD_TOL),
               serve=dict(prompt=GR_PROMPT, batch=GR_BATCH, data_blocks=2,
                          decode_steps=GR_DECODE, tokens_equal_one_device=tokens_equal,
                          launches=launches),
               peak_gb=peak, gloo_peak_gb=[g.get("peak_gb") for g in gloo],
               seconds=time.perf_counter() - t0)
    log("global_route", **out)
    for n, r in blocks.items():
        log("global_route_grads", card=card, data_blocks=n, grads=r["grads"])
    if bad:
        raise AssertionError(f"global_route: the data blocks {sorted(bad)} apart from one "
                             f"device: {out['blocks']}")
    if gloo_bad:
        raise AssertionError(f"global_route: gloo ranks {gloo_bad} apart from one device")
    if not tokens_equal:
        raise AssertionError("global_route: the split prefill and decode gave other tokens")
    if launches["decode_attention"] == 0:
        raise AssertionError("global_route: the split decode never launched decode_attention")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import (deepseek_moe_16b, granite_moe_3b_a800m,
                                     qwen2_5_3b, smollm_360m)
    from repro_torch.configs.pixie import FULL_WALK, SERVE_200M_REPLICATED
    from repro_torch.core import prng, service, walk
    from repro_torch.core import counter as counter_lib
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import visit_counter as vc
    from repro_torch.serving import ranker, traffic
    from repro_torch.serving.resilience import ResilienceConfig
    from repro_torch.serving.server import PixieServer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # 1. build (the latency probe beside the kernels), then the probe -------
    t = time.perf_counter()
    built = _build.build([*_build.SOURCES, "pointer_chase"])
    log("build", seconds=time.perf_counter() - t, built=built,
        ptxas=_build.ptxas_reports)
    for name in ("walk_steps_fused", "walk_hop", "walk_bits", "embedding_bag",
                 "visit_counter"):
        # (a library built by an earlier run in this checkout has no report)
        spills = [r for r in _build.ptxas_reports.get(name, [])
                  if "spill" in r and "0 bytes spill stores, 0 bytes spill loads" not in r]
        if spills:
            raise AssertionError(f"{name} spills registers: {spills}")
    read_ns = chase_latency(dev)

    # 2. full-width serving ---------------------------------------------------
    shape = SERVE_200M_REPLICATED
    cfg = FULL_WALK
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    graph, langs = full_width_graph(shape, dev)
    torch.cuda.synchronize()
    log("graph", name=shape.name, n_pins=graph.n_pins, n_boards=graph.n_boards,
        n_edges=graph.n_edges, max_pin_degree=graph.max_pin_degree,
        graph_gb=graph.nbytes() / 1e9, build_s=time.perf_counter() - t,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, cuts="none")
    reqs = full_width_requests(graph, shape.n_slots)
    # warm-up outside the measured run: library load, allocator growth
    service.serve_batch(graph, *padded_batch(reqs[:1], shape.n_slots, dev),
                        prng.key(SEED, dev), cfg)
    torch.cuda.synchronize()

    server = PixieServer(graph, cfg, buckets=[(1, shape.n_slots)], seed=SEED)
    _build.reset_launches()
    results = serve_all(server, reqs)
    torch.cuda.synchronize()
    serve_launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high"):
        if serve_launches[name] == 0:
            raise AssertionError(f"the full-width run never launched {name}")
    for r in results:
        check_result(r.scores, r.ids, cfg.top_k, graph.n_pins, f"request {r.req_id}")
    lat = [r.latency_ms for r in results]
    # per-phase split of one request, each phase synchronised
    pins, weights, feats = padded_batch(reqs[:1], shape.n_slots, dev)
    keys = prng.fold_in(prng.key(SEED, dev), 0)[None, :]
    res = {}
    phase_ms = dict(walk_loop=wall_ms(lambda: res.setdefault(
        "w", walk.pixie_random_walk_batched(graph, pins, weights, feats, keys, cfg))))
    boosted = {}
    phase_ms["boost"] = wall_ms(lambda: boosted.setdefault(
        "b", counter_lib.boost_combine(res["w"].counts)))
    phase_ms["topk"] = wall_ms(lambda: counter_lib.topk_dense(boosted["b"], cfg.top_k))
    # 2b. the selection kernel on these counts: 8 one-slot rows, then one row
    rows8 = counter_lib.boost_combine(res["w"].counts.reshape(shape.n_slots, 1, -1))
    topk_rows = [check_topk_select(rows8, cfg.top_k, f"({shape.n_slots}, {graph.n_pins})")]
    del rows8
    topk_rows.append(check_topk_select(boosted["b"], cfg.top_k, f"(1, {graph.n_pins})"))
    del res, boosted
    torch.cuda.empty_cache()
    log("serve", requests=len(results), p50_ms=float(np.percentile(lat, 50)),
        max_ms=float(np.max(lat)), latencies_ms=lat, phase_ms=phase_ms,
        launches=serve_launches,
        steps_budget=cfg.n_steps, walkers=cfg.n_walkers)

    dense_ops = profile_request(server, reqs[0], len(reqs))

    # 3. parity on the card -----------------------------------------------------
    ids = list(range(len(reqs)))
    kern = serve_with_stats(graph, reqs, ids, shape.n_slots, cfg, "pallas")
    plain = serve_with_stats(graph, reqs, ids, shape.n_slots, cfg, "xla")
    for rid, a, b, r in zip(ids, kern, plain, results):
        assert_same(a, b, f"full-width request {rid}")
        if not (np.array_equal(a[0][0].cpu().numpy(), r.scores)
                and np.array_equal(a[1][0].cpu().numpy(), r.ids)):
            raise AssertionError(f"request {rid}: server result differs from serve_batch")
    log("parity", requests=len(ids), identical=True,
        steps_taken=[int(a[2].sum()) for a in kern],
        n_high=[int(a[3].sum()) for a in kern])

    # 5a. walk + update_high at the full-width shapes, while that graph is
    # resident (launch counts are filled in from phases 2 and 4)
    winp = walk_inputs(graph, reqs[:1], shape.n_slots, cfg)
    walk_row, lanes = check_walk_kernel(winp, read_ns)
    _, qev, sev, pev, _ = lanes
    high_row = check_counter_kernel(
        "visit_counter_update_high", vc.visit_counter_update_high,
        vc.visit_counter_update_high_plain,
        shape.n_slots * graph.n_pins, (qev.reshape(-1), sev.reshape(-1), pev.reshape(-1)),
        dict(n_slots=shape.n_slots, n_pins=graph.n_pins, n_v=cfg.n_v, n_queries=1),
        "src/repro/kernels/visit_counter.py:329",
    )
    del winp, lanes, qev, sev, pev, kern, plain, server, results
    torch.cuda.empty_cache()

    # 5c. a full-width board-rec request, and the wide counter at its shape
    board_launches, _ = board_rec_full(graph, reqs, shape, cfg, dev)

    # 21-23. event-mode serving and the legacy kernels on the same graph ---------
    event_rows, event_paths, event_ops = event_phases(graph, reqs, shape, dev,
                                                      read_ns)

    # 24. the paper's pruning at full width, where only the graph, its
    # languages and the topics are resident; then the pruned graph served
    log("prune_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    pruned_launches = prune_full(graph, langs, reqs, shape, cfg, dev,
                                 float(np.percentile(lat, 50)))
    del langs
    torch.cuda.empty_cache()

    # 28. SASRec ranking Pixie's candidates, before the ranker's table
    sasrec_launches = sasrec_two_stage(graph, reqs, shape, cfg, dev,
                                       float(np.percentile(lat, 50)))

    # 6. full-width ranked serving ------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    rcfg = ranker.RankerConfig(n_items=graph.n_pins)
    t = time.perf_counter()
    rank = ranker.RankRequest(ranker.init_ranker_params(
        torch.Generator(device=dev).manual_seed(SEED), rcfg), rcfg)
    torch.cuda.synchronize()
    table = rank.params["items"]
    log("ranker", n_items=rcfg.n_items, d_model=rcfg.d_model,
        n_neighbors=rcfg.n_neighbors, n_candidates=rcfg.n_candidates,
        final_k=rcfg.final_k, scenarios=list(rcfg.scenarios),
        table_gb=table.numel() * table.element_size() / 1e9,
        init_s=time.perf_counter() - t,
        resident_gb=torch.cuda.memory_allocated() / 1e9)
    rwalk = dataclasses.replace(cfg, top_k=rcfg.n_candidates)
    scen = [rid % 2 for rid in range(len(reqs))]
    service.serve_batch(graph, *padded_batch(reqs[:1], shape.n_slots, dev),
                        prng.key(SEED, dev), rwalk, rank=rank)   # warm-up
    rserver = PixieServer(graph, rwalk, buckets=[(1, shape.n_slots)],
                          seed=SEED, ranker=rank)
    torch.cuda.synchronize()
    _build.reset_launches()
    ranked = []
    for rid, (p, w, f) in enumerate(reqs):
        rserver.submit(p, w, user_feat=f, req_id=rid, scenario=scen[rid])
        rserver.pump()
        ranked += rserver.harvest()
    torch.cuda.synchronize()
    ranked_launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high", "embedding_bag"):
        if ranked_launches[name] == 0:
            raise AssertionError(f"the full-width ranked run never launched {name}")
    server_key = prng.key(SEED, dev)
    for r in ranked:
        check_ranked(r.scores, r.ids, rcfg.final_k, graph.n_pins, f"ranked {r.req_id}")
        batch = padded_batch([reqs[r.req_id]], shape.n_slots, dev)
        keys = prng.fold_in(server_key, r.req_id)[None, :]
        sc = torch.tensor([scen[r.req_id]], dtype=torch.int32, device=dev)
        kern = service.serve_batch(graph, *batch, keys, rwalk, backend="pallas",
                                   rank=rank, scenario=sc, with_stats=True)
        assert_same(kern, ranked_plain(graph, rank, *batch, keys, rwalk, sc),
                    f"full-width ranked request {r.req_id}")
        if not (np.array_equal(kern[0][0].cpu().numpy(), r.scores)
                and np.array_equal(kern[1][0].cpu().numpy(), r.ids)):
            raise AssertionError(f"ranked request {r.req_id}: server differs from serve_batch")
    rlat = [r.latency_ms for r in ranked]
    r_p50 = float(np.percentile(rlat, 50))
    split = ranked_split_ms(
        graph, rank, *padded_batch(reqs[:1], shape.n_slots, dev),
        prng.fold_in(server_key, 0)[None, :], rwalk,
        torch.zeros(1, dtype=torch.int32, device=dev))
    log("ranked", requests=len(ranked), p50_ms=r_p50, max_ms=float(np.max(rlat)),
        latencies_ms=rlat, split_ms=split, launches=ranked_launches,
        identical_to_plain=True,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        resident_gb=torch.cuda.memory_allocated() / 1e9)

    # 7. open loop on the full-width ranked replica ----------------------------------
    offered = 0.5 * 1000.0 / r_p50
    oreqs = traffic.poisson_requests(
        connected_pins(graph, 1024), traffic.OpenLoopConfig(
            offered_qps=offered, n_requests=OPEN_LOOP_REQUESTS, seed=SEED,
            max_pins=shape.n_slots, n_feats=4))
    oserver = PixieServer(
        graph, rwalk, buckets=[(1, shape.n_slots)], seed=SEED, ranker=rank,
        resilience=ResilienceConfig(elastic=False, max_queue_per_bucket=8))
    _build.reset_launches()
    t = time.perf_counter()
    report = traffic.run_open_loop(oserver, oreqs)
    torch.cuda.synchronize()
    open_wall = time.perf_counter() - t
    open_launches = dict(_build.launches)
    if report.n_served + report.n_dropped != OPEN_LOOP_REQUESTS or not report.n_served:
        raise AssertionError(f"open loop: {report.summary()}")
    for r in report.results.values():
        check_ranked(r.scores, r.ids, rcfg.final_k, graph.n_pins, f"open-loop {r.req_id}")
    log("open_loop", offered_qps=report.offered_qps, target_qps=offered,
        achieved_qps=report.achieved_qps, served=report.n_served,
        dropped=report.n_dropped, rejected=report.n_rejected,
        drop_rate=report.drop_rate, p50_ms=report.percentile(50),
        p99_ms=report.percentile(99), max_ms=float(report.latency_ms.max()),
        mean_wait_ms=float(report.wait_ms.mean()),
        mean_queue_ms=float(report.queue_ms.mean()),
        mean_compute_ms=float(report.compute_ms.mean()),
        p99_compute_ms=float(np.percentile(report.compute_ms, 99)),
        batches=oserver.stats.batches, makespan_s=report.makespan_s,
        wall_s=open_wall, launches=open_launches)

    # 8. the bag kernel at the ranked path's shapes, then edge shapes -----------------
    s0, i0 = service.serve_batch(
        graph, *padded_batch(reqs[:1], shape.n_slots, dev),
        prng.fold_in(server_key, 0)[None, :], rwalk)
    nbr_ids, nbr_w = ranker.candidate_neighborhoods(graph, i0, s0 > 0,
                                                    rcfg.n_neighbors)
    q_ids, q_w = ranker.query_bag(i0, s0)
    # each set alone (one launch each), then the pair as the path runs it
    time_bag(table, nbr_ids, nbr_w, "mean", "neighbor bag")
    time_bag(table, q_ids, q_w, "mean", "query bag")
    pair = time_pair(table, (nbr_ids, nbr_w), (q_ids, q_w), "mean", read_ns)
    n_edge = check_edge_bags(dev)
    bag_row = dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:108",
        launches=None, max_abs_err=0.0,
        **{k: pair[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        bound_by="bytes", chain_floor_ms=pair["chain_floor_ms"],
    )
    log("bag_kernel", main_shapes=[list(nbr_ids.shape), list(q_ids.shape)],
        identical=True, edge_cases_identical=n_edge,
        row_is="one ranked request's pair launch (both bag sets)")
    del rank, table, rserver, oserver, report, ranked, kern
    del s0, i0, nbr_ids, nbr_w, q_ids, q_w
    torch.cuda.empty_cache()

    # 11-15. the sharded engine on the full-width graph (the item table is
    # freed first) ----------------------------------------------------------------
    sharded_rows, sharded_paths, sharded_ops = sharded_phases(
        graph, reqs, shape, dev, read_ns)
    # the card's operations of one torch word table, in the per-query and
    # batched layouts the plain routes draw it in
    rbits_ops = {}
    for layout, k in (("per_query", prng.key(SEED, dev)),
                      ("batched", prng.key(SEED, dev)[None, :])):
        rbits_ops[layout] = profile_call(
            lambda: walk._chunk_rbits(k, 0, cfg.chunk_steps, cfg.n_walkers),
            top=4, trace=f"chip_smoke_chunk_rbits_{layout}_trace.json")
    del graph
    torch.cuda.empty_cache()
    requests_ops = dict(dense=dense_ops, events=event_ops, sharded=sharded_ops)
    for path, r in requests_ops.items():
        if r["torch_threefry_draws"]:
            raise AssertionError(f"the {path} kernel path drew its words in torch")
    # chunks of each profiled request: one walk launch (dense, events) or
    # one table launch (sharded) a chunk
    chunks = dict(dense=dense_ops["launches"]["walk_steps_fused"],
                  events=event_ops["launches"]["walk_steps_fused"],
                  sharded=sharded_ops["launches"]["walk_bits"])
    layout = dict(dense="batched", events="per_query", sharded="batched")
    log("request_ops", ops={p: r["ops"] for p, r in requests_ops.items()},
        chunks=chunks, chunk_rbits_ops=rbits_ops,
        torch_threefry_draws={p: r["torch_threefry_draws"]
                              for p, r in requests_ops.items()},
        chunks_x_chunk_rbits_ops={p: chunks[p] * rbits_ops[layout[p]]
                                  for p in chunks},
        note="a parent commit's request drew one torch table a chunk")

    # 4. batched qid lanes, count_boards -----------------------------------------
    sg = synthetic.generate(
        synthetic.SyntheticGraphConfig(
            n_pins=20_000, n_boards=2_000, n_topics=16, n_langs=4, seed=7),
        device=dev,
    )
    bcfg = service.board_rec_config(cfg)
    rng = np.random.default_rng(SEED + 1)
    top = synthetic.top_degree_pins(sg, 256)
    breqs = []
    for i in range(32):
        k = 1 + i % 8
        breqs.append(([int(p) for p in rng.choice(top, k, replace=False)],
                      [float(x) for x in rng.uniform(0.1, 1.0, k).astype(np.float32)],
                      int(rng.integers(0, 4))))
    outs = {}
    batch_launches = {}
    for backend in ("pallas", "xla"):
        srv = PixieServer(sg.graph, bcfg, buckets=[(16, 4), (8, 8)],
                          seed=SEED, backend=backend)
        _build.reset_launches()
        for rid, (p, w, f) in enumerate(breqs):
            srv.submit(p, w, user_feat=f, now=0.0, req_id=rid)
        srv.pump(now=1.0)
        outs[backend] = sorted(srv.harvest(), key=lambda r: r.req_id)
        torch.cuda.synchronize()
        batch_launches[backend] = dict(_build.launches)
    if any(batch_launches["pallas"][k] == 0 for k in
           ("walk_steps_fused", "visit_counter_update_high", "visit_counter_wide")):
        raise AssertionError(f"batched run missed a kernel: {batch_launches['pallas']}")
    # the top-k's selection is the kernel on any CUDA tensor, on both paths
    if {k for k, v in batch_launches["xla"].items() if v} != {"topk_select"}:
        raise AssertionError("the plain path launched a walk kernel")
    for a, b in zip(outs["pallas"], outs["xla"]):
        if not (np.array_equal(a.scores, b.scores) and np.array_equal(a.ids, b.ids)):
            raise AssertionError(f"batched request {a.req_id}: kernel and plain paths differ")
        check_result(a.scores, a.ids, bcfg.top_k, sg.graph.n_pins, f"batched {a.req_id}")
    # stats parity on one 16-query bucket
    small = [r for r in breqs if len(r[0]) <= 4][:16]
    bp, bw, bf = padded_batch(small, 4, dev)
    bkeys = prng.fold_in(prng.key(SEED, dev), torch.arange(len(small), device=dev))
    assert_same(
        service.serve_batch(sg.graph, bp, bw, bf, bkeys, bcfg, backend="pallas", with_stats=True),
        service.serve_batch(sg.graph, bp, bw, bf, bkeys, bcfg, backend="xla", with_stats=True),
        "batched 16-query bucket",
    )
    log("batched", requests=len(breqs), batches=srv.stats.batches,
        identical=True, launches=batch_launches["pallas"])

    # 4b. batches past 12,288 counter rows, unsharded and sharded
    past_cap_launches = past_cap_phases(sg, cfg, dev)

    # 5b. wide counter at the batched board shapes
    binp = walk_inputs(sg.graph, small, 4, bcfg)
    _, bq, bs, _, bb = run_walk_kernel(binp)
    wide_row = check_counter_kernel(
        "visit_counter_wide", vc.visit_counter_wide, vc.visit_counter_wide_plain,
        len(small) * 4 * sg.graph.n_boards,
        (bq.reshape(-1), bs.reshape(-1), bb.reshape(-1)),
        dict(n_slots=4, n_dim=sg.graph.n_boards, n_queries=len(small)),
        "src/repro/kernels/visit_counter.py:196",
        label="board-rec bucket (16 x 4 x 2000 bins)",
    )
    log("wide_kernel", edge_cases_identical=wide_edge_cases(dev))

    # 9. batched ranked serving and multi-interest users -----------------------------
    rcfg20 = ranker.RankerConfig(n_items=sg.graph.n_pins)
    rank20 = ranker.RankRequest(ranker.init_ranker_params(
        torch.Generator(device=dev).manual_seed(SEED + 2), rcfg20), rcfg20)
    rscen = [rid % 2 for rid in range(len(breqs))]
    routs, rlaunches = {}, {}
    for backend in ("pallas", "xla"):
        srv = PixieServer(sg.graph, cfg, buckets=[(16, 4), (8, 8)], seed=SEED,
                          backend=backend, ranker=rank20)
        _build.reset_launches()
        routs[backend] = serve_requests(srv, breqs, rscen)
        torch.cuda.synchronize()
        rlaunches[backend] = dict(_build.launches)
    if any(rlaunches["pallas"][k] == 0 for k in
           ("walk_steps_fused", "visit_counter_update_high", "embedding_bag")):
        raise AssertionError(f"batched ranked run missed a kernel: {rlaunches['pallas']}")
    if rlaunches["xla"]["walk_steps_fused"] or rlaunches["xla"]["visit_counter_update_high"]:
        raise AssertionError("the plain walk launched a walk kernel")
    assert_results_equal(routs["pallas"], routs["xla"], "batched ranked backends")
    oracle = PixieServer(sg.graph, cfg, buckets=[(8, 8)], seed=SEED, ranker=rank20)
    for rid, (p, w, f) in enumerate(breqs):
        oracle.submit(p, w, user_feat=f, now=0.0, req_id=rid, scenario=rscen[rid])
    assert_results_equal(routs["pallas"], oracle.flush(now=0.0), "ranked flush oracle")
    for r in routs["pallas"]:
        if r.ids.shape != (rcfg20.final_k,) or not np.isfinite(r.scores).all():
            raise AssertionError(f"batched ranked {r.req_id}: bad result")
    log("batched_ranked", requests=len(breqs), identical=True,
        flush_oracle_identical=True, launches=rlaunches["pallas"])
    user_launches = multi_interest_users(sg, cfg, rank20, dev)

    # 10. chaos on the 20k retrieval replica --------------------------------------
    chaos_launches = chaos_runs(sg, cfg, dev)

    # 25-27. Fig. 4's pruning sweep, Table 1's baselines, the oracle ----------------
    fig4_launches = prune_20k(sg, dev)
    table1_launches = baselines_20k(sg, dev)
    oracle_launches = oracle_check(dev)

    # 16. the NCCL fabric on one rank, 4-way board counts ------------------------------
    nccl_fabric(sg, dev)

    # 17-20. dense-LM decode serving, after the Pixie state is freed ----------------
    del sg, srv, outs, routs, oracle, rank20, binp, bq, bs, bb
    torch.cuda.empty_cache()

    # 29. the recsys models at full width, nothing else resident ----------------------
    recsys_launches = recsys_full(dev)
    log("lm_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    attn_row, lm_paths = lm_phases(dev, qwen2_5_3b.FULL, smollm_360m.FULL)

    # 30-31. MoE LM serving at full width, nothing else resident ------------------
    torch.cuda.empty_cache()
    log("moe_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    moe_rows, moe_paths, moe_greedy = moe_phases(dev, granite_moe_3b_a800m.FULL,
                                                 deepseek_moe_16b.FULL)
    attn_row["max_abs_err"] = max(attn_row["max_abs_err"],
                                  *(r["max_abs_err"] for r in moe_rows))

    # 32. the GIN model at the reference's three GNN cells --------------------------
    gcases = gin_cases()
    gin_errs = gin_phase(dev, gcases)

    # 33-34. training on one card, nothing else resident (no hand kernel on
    # this path: its count is read all the same) -------------------------------------
    torch.cuda.empty_cache()
    log("train_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    _build.reset_launches()
    trained = lm_train_phase(dev, smollm_360m.FULL)
    gin_train_phase(dev, gcases)
    torch.cuda.synchronize()
    train_launches = dict(_build.launches)
    del gcases

    # 35. the distribution layer: expert-parallel MoE decode, compressed_psum,
    # ZeRO-1 steps over NCCL, nothing else resident ------------------------------
    torch.cuda.empty_cache()
    log("dist_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    dist_paths = dist_phase(dev, granite_moe_3b_a800m.FULL, deepseek_moe_16b.FULL,
                            smollm_360m.FULL, moe_greedy, trained.pop("kept"),
                            trained["global_batch"])

    # 36. launch: the dry run of every production cell on this host, set
    # beside phases 33 and 19b; two cells on the card, nothing else resident
    torch.cuda.empty_cache()
    log("launch_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    launch_paths = launch_phase(dev, trained)

    # 37. tensor-parallel LM serving on a local (1, 4) mesh, nothing else
    # resident; the dry run's LM serve cells from phase 36
    torch.cuda.empty_cache()
    log("tp_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    partial_row, tp_paths = tp_serve_phase(dev, qwen2_5_3b.FULL, deepseek_moe_16b.FULL)

    # 38. tensor-parallel LM training on a local (1, 4) mesh, nothing else
    # resident; the dry run's LM train cells from phase 36
    torch.cuda.empty_cache()
    log("tp_train_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    tt_launches = tp_train_phase(dev, smollm_360m.FULL, deepseek_moe_16b.FULL)

    # 39. MoE routing over the global batch in data blocks, nothing else resident
    torch.cuda.empty_cache()
    log("global_route_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    gr_launches = global_route_phase(dev, deepseek_moe_16b.FULL)

    # the kernels line ---------------------------------------------------------------
    paths = [serve_launches, board_launches, batch_launches["pallas"], ranked_launches,
             open_launches, rlaunches["pallas"], user_launches, chaos_launches,
             *past_cap_launches, *sharded_paths, *lm_paths, *event_paths,
             pruned_launches, fig4_launches, table1_launches, oracle_launches,
             sasrec_launches, recsys_launches, *moe_paths, train_launches, *dist_paths,
             *launch_paths, *tp_paths, tt_launches, gr_launches]
    rows = [walk_row, high_row, wide_row, bag_row, sharded_rows[0], attn_row,
            *event_rows, sharded_rows[1], partial_row, *topk_rows]
    for row in rows:
        row["launches"] = sum(p[row["name"]] for p in paths)
    if bag_row["launches"] == 0 or ranked_launches["embedding_bag"] == 0:
        raise AssertionError("the embedding bag never launched on the ranked path")
    if any(p["walk_hop_fused"] == 0 or p["walk_bits"] == 0 for p in sharded_paths):
        raise AssertionError("a sharded path never launched walk_hop_fused or walk_bits")
    if any(row["launches"] == 0 for row in rows):
        raise AssertionError(f"a kernel never launched: {[r['name'] for r in rows if not r['launches']]}")
    log("launches", retrieval=serve_launches, board_rec_full=board_launches,
        batched=batch_launches["pallas"], past_cap=past_cap_launches[0],
        sharded_past_cap=past_cap_launches[1],
        ranked=ranked_launches, open_loop=open_launches,
        batched_ranked=rlaunches["pallas"], users=user_launches,
        chaos=chaos_launches, sharded_parity=sharded_paths[0],
        sharded_recipe=sharded_paths[1], sharded_server=sharded_paths[2],
        sharded_open_loop=sharded_paths[3], lm_f32=lm_paths[0],
        lm_bf16=lm_paths[1], decode_32k=lm_paths[2], lm_smollm=lm_paths[3],
        events_replicated=event_paths[0], events_wide=event_paths[1],
        legacy_kernels=event_paths[2], pruned_serve=pruned_launches,
        prune_20k=fig4_launches, baselines_20k=table1_launches,
        oracle=oracle_launches, sasrec_2stage=sasrec_launches,
        recsys_full=recsys_launches, moe_granite=moe_paths[:4],
        moe_deepseek=moe_paths[4:], gin_max_rel_diff=gin_errs, train=train_launches,
        dist_ep=dist_paths, launch_cells=launch_paths, tp_serve=tp_paths,
        tp_train=tt_launches, global_route=gr_launches)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

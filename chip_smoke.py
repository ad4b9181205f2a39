#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port of the LazyPIM simulator on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:

1. environment — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device is a failure;
2. build — compile every ``src/repro_torch/csrc/*.cu`` (``bloom.cu``,
   ``bloom_onehot.cu``, ``lazy_merge.cu``, ``flash_attention.cu``,
   ``flash_attention_sm90.cu``) with ``nvcc`` for sm_90a, one process each,
   started together, into the gitignored ``build/``; print what
   ``cudaFuncGetAttributes`` reads from the loaded ``bloom_query``,
   ``bloom_query_onehot``, ``bloom_insert`` (id and bitmap forms),
   ``bloom_insert_onehot``, ``h3_hash`` and
   ``bloom_detect_conflicts`` (transposed and direct routes) kernels (the
   paper's geometry fixed, and any; local memory must be 0), from the general flash
   attention kernel's bands (three a dtype) and from the sm90 one at each
   head dim (registers and local memory, i.e. spills and stack, a thread;
   static and dynamic shared memory a block); then the card's launch
   floor: a one-element elementwise op timed as the kernels are;
2a. dry run started — ``DRYRUN_SCRIPT`` in a process of its own (no CUDA
   device visible to it; its fake process group is global to its
   process), beside the phases below: ``launch.dryrun.lower_cell`` for
   qwen3-4b ``train_4k`` and ``prefill_32k`` at full width on the fake
   (16, 16) and (2, 16, 16) meshes, ``roofline.analysis.analyze_cell``
   for ``train_4k``, and the card's own training cell (1 x 4,096 tokens)
   on a one-rank mesh; its output and errors go to temporary files (a
   pipe left unread could fill and stall it), read in phase 22a;
3. one phase per Bloom kernel of the Fig. 7 path (``h3_hash``,
   ``bloom_insert``, ``bloom_query``, ``bloom_intersect``) — each against
   its plain PyTorch version on the card on that path's data (the HTAP
   bucket: 3 lanes of 262,144 lines, 72 windows of 256 PIM slots; every
   window checked); integer results, so the tolerance is exact equality;
   time per call of the kernel and of the plain version from CUDA events
   over back-to-back calls on input copies rotated through 100 MB (twice
   the L2), and the kernel's bound (bytes over 3.35 TB/s vs operations
   over 67 Top/s, whichever is larger); a time under its bound fails.
   ``h3_hash`` is held on the bucket's lines, on 262,144 random 32-bit
   addresses and on LazySync's first 4 x 4,096 touched ids at qwen3-4b
   width, and timed at 262,144 lines and at those 16,384 ids, with the
   launch floor and, on a text line, the previous design's reading.
   ``bloom_query`` is held on every window with one bitmap and with two
   (``present`` and ``dirty``), and timed both ways; its bound counts the
   bitmaps read and written and the signature against the parity hash's
   operations for the set lines (the old bound printed beside it).
   ``bloom_insert`` is held on every window's read list alone and paired
   with its write list, and in bank mode on ``dirty`` alone and paired with
   a window's ``conc``; it is timed at the window's shapes as the id list,
   the id pair, the bank and the bank pair (no fill in either); each
   timing prints its bound (the parity hash's operations against the
   bytes), the launch floor and, on its text line only, the previous
   design's reading kept in ``PERF.md``.  ``bloom_intersect`` is held per
   row and, in its pair-and-any form (what the window launches), on every
   window's ``dirty`` and ``conc`` banks against its read image, both
   against the plain version and against two per-row calls and their
   ``.any``; the pair is timed at the window's shape (3 lanes x 16
   registers x 64 words, two banks) beside the per-row form and the two
   per-row calls it replaced;
4. Fig. 7 path — ``Study(all_workloads())`` with all six mechanisms on
   ``engine="batch"`` and ``engine="sequential"``, launch counts set to 0
   just before and read just after each run; ``bloom_query`` must launch
   exactly twice a window of each LazyPIM dispatch (``QUERIES_PER_WINDOW``;
   the windows of each geometry bucket in the batch engine, of each point
   in the sequential one), ``bloom_insert`` exactly twice a window
   (``INSERTS_PER_WINDOW``: the two images, the two banks) and
   ``bloom_intersect`` exactly once (``INTERSECTS_PER_WINDOW``: both
   conflict checks); the engines must agree on every field and
   ``pagerank-arxiv`` / ``htap128`` must match the goldens in
   ``tests/golden/`` (event counts exact, ratios 1e-6, raw 1e-4); the
   batch run's ``sweep_cache_sizes`` deltas (new dispatch shapes, the
   reference's compile count) must equal ``plan().compiles_per_mechanism``,
   and the sequential run's ``sequential_cache_sizes`` deltas are printed;
5. Fig. 7 profile — ``FIG7_PROFILE_WORKLOADS`` (two of the 12) on the batch
   engine, once unprofiled and once under ``torch.profiler``: device time by
   kernel and the device's idle share of the unprofiled wall time (the
   whole fleet took ~2 min of profiler bookkeeping);
5m. lane mesh — the Fig. 7 study at ``devices=1`` (counted; a spy on
   ``sim.mesh.shard_lanes`` sees no call) equal to phase 4's batch run on
   every field; ``devices`` one past the visible cards refused naming the
   count; where two or more cards are visible, the study at ``devices=2``
   equal to ``devices=1`` on every field, each card launching the window
   loop's B2, B3 and B4 (counted by entry point and card); on one card a
   line says the ``devices=2`` leg did not run, and why;
5a. extended Fig. 7 fleet — ``Study(all_workloads(extended=True))``, the
   reference Fig. 7 driver's 22 workloads (the paper's 12, ``bfs`` and
   ``sssp`` on every graph input, ``htap_stream``, ``mtmix`` on every graph
   input) at the reference's defaults, on both engines, counted as in
   phase 4 (two ``bloom_query``, two ``bloom_insert`` and one
   ``bloom_intersect`` launch a LazyPIM window); batch == sequential on
   every field of 22 x 6 results; the goldens held; the 12 paper workloads
   equal phase 4's sequential results on every field; the 10 new ones equal
   one ``device="cpu"`` sequential run of the port on every field; both
   walls and the CPU run's printed;
5x. examples — ``examples/torch_quickstart.py``, ``torch_study_grid.py``,
   ``torch_lazy_coherence_demo.py`` and ``torch_train_100m.py`` through
   their ``main`` on the card at their defaults (the trainer's steps
   apart), each counted: the
   quickstart's two workloads and the grid's default-hardware,
   default-LazyPIM point equal to phase 4's results on every field (and
   the signature verdicts True / False), the LazySync demo's 24 steps of
   conflicts and bytes equal to its CPU run, the 100M trainer's loss
   falling across its injected failure and restart (``TRAIN_100M_STEPS``
   steps, the rest of its flags the reference's defaults);
5g. ``sim.synth.generator`` — one plan of each synthesized family
   (``GENERATOR_FAMILIES``) at its default size: ``fn(*args)`` on the card
   equal to the same plan's CPU run field by field, each timed;
5b. signature caps — the M = 64 ``Study`` (htap128 and pagerank-arxiv at
   ``SignatureSpec(4096, 64)`` and ``(2048, 64)``, full size) on both
   engines against its CPU run, every field exact, counted a window; every
   parity-form kernel at ``SignatureSpec(4096, 128)`` (640 column masks,
   two launches a call) and B4 / B1 at its 128 segments; the bitmap
   kernels (B2 in both forms, B3, B8a, B8b) at 70,000 lanes, one launch
   each; every result equal to its plain version;
5c. study service — the resident study service (``repro_torch.serve``) on
   the card: the Fig. 7 fleet as one JSON request (3 buckets: served by the
   batch engine, uncoalesced), every field equal to phase 4's results; a
   burst of 16 paper-scale requests (one of the 12 workloads each, all six
   mechanisms, ``offchip_bw_gbs`` 32 and 64: 2 lanes) served coalesced with
   the adaptive policy and then one at a time, every answer equal to its
   spec's direct ``Study.run()`` on every field (dispatch widths, audited
   lanes, p50 / p99 latency and studies/s of both legs printed); the
   reference's chaos storm (``make_storm``, seed 0, rate 0.3, every fault
   class, 170 requests on the reference chaos tests' two small specs, a
   virtual clock) served one at a time (a crash through
   ``restart_server``) and coalesced, every rid resolved as ROADMAP's
   contract table says, none lost, every served answer equal to the
   fault-free run; ``python -m repro_torch.launch.serve --study ...
   --cache-dir ...`` twice in fresh processes, the second warmed from the
   first one's manifest and then building and binding nothing.  Every
   LazyPIM window any leg walked (counted by wrapping the engine's window
   loop) asks two ``bloom_query``, two ``bloom_insert`` and one
   ``bloom_intersect`` launch;
6. seed path — the seed reference engine ``run_all_bool`` over the same 12
   workloads at full scale (default ``SignatureSpec`` and ``HWParams``),
   one trace at a time, counted and tapped: every ``bloom_insert_onehot``
   / ``bloom_query_onehot`` call held to its plain version (exact; an
   insert call answers both of a window's images), ``bloom_insert_onehot``
   launched exactly once a LazyPIM window, every
   field of the 12 x 6 results equal to the packed sequential engine's of
   phase 4, the goldens held; the full-commit and no-DBI LazyPIM ablations
   on ``pagerank-arxiv`` and ``htap128`` against the packed engine; those
   two workloads once more under ``torch.profiler`` for the idle share
   (against their wall time in the counted run);
7. the two B8 kernels timed as in phase 3 at the seed path's shapes, on
   inputs it gave them, the insert alone and as the window's pair (bound:
   bytes, or the parity hash's operations this data needs at 67 Top/s —
   every column for the insert, the columns up to each address's first
   clear bit for the query, with the query's xor-fold bound printed beside
   it; the insert also prints the launch floor and, on its text line
   only, the previous design's reading);
8. signatures — ``benchmarks/bench_signatures.py`` on the card: B1
   against the xor-fold hash at batch 4,096, B8 against B2 / B3 at batch
   1,024 (both inserts now hash with the parity form and share one kernel,
   so that pair compares B8a's incoming-signature OR with B2's plain
   image), B5 against the two-pass PyTorch path (G = 4); every pair
   bit-exact; one ``{"signatures": ...}`` line, no file written;
9. capture path — ``Study(["capture/lazy_embed"])`` (the live LazySync
   protocol recorded at its default scale: vocab 24,000, 48,000 lines in
   the 65,536-line bucket, 24 kernels x 3 steps) with all six mechanisms on
   both engines, held against the port's own ``device="cpu"`` run of the
   same study (event counts exact, ratios 1e-6, raw 1e-4); all six kernels
   must launch, ``bloom_query`` and ``bloom_insert`` twice a LazyPIM window,
   ``bloom_intersect`` once; every ``bloom_detect_conflicts`` and
   ``lazy_merge`` call the
   protocol made is held against its plain version on its own inputs;
10. LazySync at qwen3-4b width — ``LazyEmbed(get_config("qwen3_4b"),
   LazySyncConfig())`` (G = 4, vocab 151,936, d_model 2,560, bf16, 2,048-bit
   signatures, budget 1,024, commit every 16 steps): 24 ``sync_step``s with
   4,096 zipf-drawn touched ids per group and a sparse gradient on those
   rows, both from numpy seeds; each step's ``bloom_detect_conflicts`` and
   ``lazy_merge`` calls held against their plain versions (exact), every
   replica equal to ``base`` after the commit; step wall times, conflict
   rows, pinned rows, bytes against the dense all-reduce, peak memory;
   then 8 more steps twice from one snapshot, unprofiled and under
   ``torch.profiler``, for the device's idle share of a step;
11. LazySync kernel phases — first, at qwen3-4b width, B5 on a draw of
   1,024 ids a group, whose hit counts must vary (the path's own draw
   saturates the signatures), and B6 on the path's reconcile rows with
   about half of them valid; then ``bloom_detect_conflicts`` at the
   capture's shape (G = 4, N = 192) and at qwen3-4b width (N = 16,384);
   ``lazy_merge`` at the reconcile shape (4, 1,024, 2,560) and the commit
   shape (4, 151,936, 2,560) in bf16, on inputs the two paths gave them:
   times and bounds as in phase 3 (merge: exact expected, 1e-6 relative
   allowed); B5 on its transposed route, with the launch floor and, on a
   text line, the previous design's reading;
12. capture/kv_serve — ``Study(["capture/kv_serve"])`` (the paged-KV decode
   loop at its default scale: 500 pages, batch 24, 24 kernels x 3 steps)
   with all six mechanisms on both engines, each held to one
   ``device="cpu"`` run of the port (the engines agree bit for bit) at the
   same tolerances; B1–B4 must launch, ``bloom_query`` and ``bloom_insert``
   twice a LazyPIM window, ``bloom_intersect`` once;
13. qwen3-4b prefill — ``get_config("qwen3_4b")`` at full width and depth
   (36 layers, ~4.02 B parameters, ~8.0 GB in bf16) initialised on the card
   from a seeded generator; ``make_prefill_step`` on 4 prompts of 4,096
   seeded tokens, three times: counted and tapped (exactly 36
   ``flash_attention`` launches, all on the sm90 route — bf16, D = 128 —
   and none on the general one; every call held to the plain version at
   the row-scaled tolerance of ``fa_excess``), unprofiled (wall time, peak
   memory), under ``torch.profiler`` (the device's idle share);
14. kernel flash_attention — B7 at the prefill path's shape, q (4, 4,096,
   32, 128) and k / v (4, 4,096, 8, 128) causal, on layer 0's inputs: the
   sm90 route in bf16 (``flash_attention_sm90.cu``, what the path takes),
   the general route (``flash_attention.cu``) in float32 (the same inputs
   cast: what phase 16 runs) and in bf16 (forced): each against its plain
   version (``fa_excess``), timed as in phase 3 with its bound in
   operations (bf16 at the tensor-core rate, 989 TFLOP/s; float32 at the
   FFMA rate, 67 TFLOP/s), and one ``scaled_dot_product_attention`` call on
   the same inputs as the library yardstick (float32 with TF32 off; the port
   never calls it);
15. qwen3-4b serve — ``launch.serve.serve`` at full width with the
   reference serve loop's defaults (8 requests, batch 4, max-new 16, max-len
   64) on the same weights: all 8 served, tokens per second; 8 decode
   steps at batch 4 timed and then profiled (kernels a step, device busy
   time, idle share); then one teacher-forced 64-token prompt through
   decode against the full forward (top-1 agreement and max |logit
   difference|, recorded, not gated);
16. qwen3-4b prefill, float32 — the bf16 weights cast to float32 (~16 GB;
   the bf16 ones dropped), ``make_prefill_step`` on 1 prompt of 4,096
   seeded tokens with TF32 off: counted and tapped (exactly 36 B7 launches,
   all on the general route, each held to its plain version at
   ``FA_TOL``'s float32 pair), logits finite; then unprofiled (wall time,
   tokens/s, peak memory) and profiled (idle share, top kernels, B7's share
   of device time): the general route at full width;
17. smoke prefill, float32 — the qwen3-4b smoke config (2 layers, D = 16)
   in float32 through ``make_prefill_step`` on 2 x 150 tokens, counted
   (one general-route B7 launch a layer, none on the sm90 route), tapped
   (every call held to the plain version at ``FA_TOL``'s float32 pair,
   rtol 1e-5 and row_tol 1e-3) and held to the CPU run's logits (1e-4):
   the general route's own path;
18. qwen2-moe-a2.7b prefill — ``get_config("qwen2_moe_a2_7b")`` at full
   width and depth (24 layers of attention + MoE: 60 routed experts padded
   to 64, top-4, 4 shared; 14,835,091,456 parameters, 27.63 GiB in bf16)
   initialised on the card from a seeded generator after the qwen3-4b
   weights are freed; ``make_prefill_step`` on 4 x 4,096 seeded tokens,
   three times: counted and tapped (exactly 24 B7 launches, all on the
   sm90 route at Hq = Hkv = 16, each held to its plain version by
   ``fa_excess``; each layer's pairs dropped past capacity printed; no
   padded expert routed), unprofiled (wall, tokens/s, peak memory),
   profiled (idle share, top kernels, B7's share of device time);
19. MoE dispatch check — layer 0's MoE block on the prefill's own layer-0
   input under ``sort``, ``cumsum`` and ``ep``, at the model's capacity
   factor (1.25) and at 1.0 (capacity 1,024: the hot experts drop): the
   same kept (token, expert, rank) set, outputs within 3e-2 of ``sort``'s
   (the tolerance of ``tests/test_moe_ep.py:43``), ``sort`` twice giving
   the same bits; then B7's sm90 kernel timed at the MoE prefill's shape,
   q / k / v (4, 4,096, 16, 128) causal on layer 0's inputs, as phase 14
   times it (SDPA as yardstick);
20. qwen2-moe-a2.7b serve — ``launch.serve.serve`` at full width with the
   reference loop's defaults: all 8 served, tokens/s; 8 decode steps at
   batch 4 timed and profiled (kernels a step, device busy, idle share);
20a. moonshot-v1-16b-a3b — ``get_config("moonshot_v1_16b_a3b")`` at full
   width and depth (48 layers, d_model 2,048, 16 heads of 128, 64 routed
   top-6 experts and 2 shared, d_expert 1,408, vocab 163,840;
   28.55 B parameters, 53.2 GiB bf16) drawn after qwen2-moe's weights are
   freed: phases 18–20 on it (a 4 x 4,096 prefill with exactly 48 sm90 B7
   launches, each held to its plain version, drops by layer; layer 0's
   dispatch check; the serve loop);
20b. phi3-mini-3.8b — ``get_config("phi3_mini_3_8b")`` at full width and
   depth (32 layers, d_model 3,072, 32 heads of 96, MHA; 3.72 B
   parameters): phase 13's three 4 x 4,096 prefills (exactly 32 sm90 B7
   launches at D = 96, each held to its plain version), layer 0's B7 call
   (4, 4,096, 32 on 32, 96) causal timed against its plain version and
   SDPA with the useful work in the bound and the padded work (D = 96
   runs as 128) printed beside it (``phi3_shape``), the serve loop;
21. MoE smoke — the qwen2-moe and moonshot smoke configs in float32 (TF32
   off) through ``make_prefill_step`` and 3 decode steps on the card and
   on the CPU: logits within 1e-4, every MoE call's ``top_e`` equal;
21a. falcon-mamba-7b — ``get_config("falcon_mamba_7b")`` at full width
   and depth (64 mamba layers, d_inner 8,192, d_state 16; 7,006,326,784
   parameters, 13.05 GiB bf16) from a seeded generator: ``make_prefill_step``
   on ``SSM_PREFILL_BATCH`` x 4,096 tokens counted (no kernel of the
   package: the products and the log-depth scan are PyTorch ops, as the
   reference's are outside Pallas), unprofiled (wall, tokens/s, peak
   memory and the shape taken) and profiled (idle share, top kernels);
   layer 0's ``ssm_block`` in float32 on the card against the same call on
   the CPU (rtol 1e-4, atol 1e-4 of the output's scale); the serve loop
   with the reference's defaults and 8 decode steps profiled;
21b. recurrentgemma-2b — ``get_config("recurrentgemma_2b")`` at full width
   and depth (18 rglru + 8 swa layers, 10 query heads on one KV head of
   256, window 2,048; 2,894,481,920 parameters): prefill 4 x 4,096 counted
   and tapped (exactly 8 sm90 B7 launches, each held to its plain
   version), unprofiled and profiled; layer 2's B7 call timed against its
   plain version with the bound counted inside the band (6,292,480
   query-key pairs a head) and SDPA with a boolean band mask as yardstick
   (``hybrid_shape`` in the kernels line); the serve loop (its ring KV
   cache of min(max_len, 2,048) slots does not wrap in 63 steps, as a line
   says) and 8 decode steps profiled;
21c. seamless-m4t-large-v2 — ``get_config("seamless_m4t_large_v2")`` at
   full width and depth (24 encoder and 24 decoder layers, d_model 1,024,
   16 heads of 64; 1,772,431,360 parameters, 3.30 GiB bf16) from a seeded
   generator: ``make_prefill_step`` on 4 x 4,096 tokens with
   4 x 1,024 x 1,024 frames of ``synth_embeddings``' distribution drawn on
   the card,
   counted and checked (exactly 72 sm90 B7 launches: 24 encoder calls,
   non-causal 1,024 x 1,024; 24 decoder calls, causal 4,096 x 4,096; 24
   cross calls, non-causal 4,096 on 1,024; each held to its plain version
   as it runs), unprofiled (wall, tokens/s, peak memory) and profiled (idle
   share, B7's share); then layer 0's call of each kind timed against its
   plain version with SDPA beside it (``encdec_shapes``);
21d. internvl2-26b — ``get_config("internvl2_26b")`` at full width and
   depth (48 layers, d_model 6,144, GQA 48 on 8 at D = 128; 19,292,657,664
   parameters, 35.94 GiB bf16): the same on 4 x 4,096 tokens behind 4 x 256
   vision prefix embeddings (exactly 48 sm90 launches at 4,352 x 4,352,
   causal), layer 0's call timed (``vlm_shape``);
21e. qwen3-4b training — ``launch.train.build``'s model and AdamW (float32
   moments, remat on, lr 3e-3) at full width, 4 ``make_train_step`` steps
   on ``host_batch``'s 1 x 4,096 tokens: exactly 36 sm90 B7 launches in
   each step's forward pass and 36 more in remat's recompute (the backward
   differentiates ``mha_chunked``), losses and gradient norms finite, every
   parameter leaf changed, every B7 call of the forward and the recompute
   held to its plain version as it runs; three more steps unchecked (step
   wall, tokens/s, peak memory); an eighth step profiled (idle share, top
   kernels, attention's device time read from the kernels launched under
   ``models.attention.PROFILE_RANGES`` and B7's own: the forward and
   recompute, and the ``mha_chunked`` backward); then layer 0's attention
   block in float32 (the general B7 route, one launch) on 256 tokens:
   every gradient within 1e-4 (of its largest entry) of the CPU's,
   ``wq`` / ``wk`` / ``wv``'s nonzero;
21e'. qwen3-4b training under ``remat_policy="dots"`` (the products with
   no batch dimension saved): phase 21e's steps (no profile, no layer-0
   gradient) from the same seeded parameters and batches, its checks
   (36 + 36 B7 launches a step, every B7 call of the 4 checked steps held
   to its plain version); the losses and gradient norms of all 7 steps
   equal to phase 21e's bit for bit (the backward reads the saved products
   where 21e recomputes them), more memory allocated when the forward ends
   than phase 21e's (the saved products); median wall and peak memory
   beside phase 21e's;
21f. ``launch.train.run`` at smoke size on the card with the reference
   end-to-end test's arguments, in temporary checkpoint directories: a
   clean 24-step run whose loss falls, and one failing at step 16 that
   restores step 8, its 16 losses within the reference test's 0.05 band
   of the clean run's; one general-route B7 launch a layer a step (112),
   each held to its plain version as it runs;
22. capture study — ``benchmarks/fig_capture.py:48``'s fleet (the three
   captured families and their synthetic analogues: ``capture/kv_serve``,
   ``capture/moe_experts``, ``capture/lazy_embed``, ``htap_stream``,
   ``mtmix-enron``, ``pagerank-enron``) with all six mechanisms on both
   engines, counted (B1–B6 launched; 2 / 2 / 1 B3 / B2 / B4 launches a
   LazyPIM window) and tapped (every B5 / B6 call held to its plain
   version); batch == sequential == one ``device="cpu"`` run of the port
   on every field; then ``capture/moe_experts``'s trace on the card against
   its CPU trace, field for field;
22a. dry run read — the process of phase 2a: every cell traced with its
   per-device FLOPs, bytes accessed, argument / temp bytes and collective
   bytes by kind printed, the roofline's three terms, and the card's
   training cell: its argument bytes equal to the bytes of phase 21e's
   live parameters, moments, step counter and batch exactly, its
   predicted peak (argument + temp bytes) printed beside phase 21e's
   ``torch.cuda.max_memory_allocated`` with their ratio;
23. the ``kernels`` JSON line (ten kernels, launches by path including the
   extended fleet's, the M = 64 Study's, the study service's legs, the
   examples', the MoE paths' (moonshot's too), phi3's, the lane mesh's, the SSM / hybrid paths', the enc-dec / VLM
   prefills', the training paths' and the capture study's; B7-sm90 also
   carries its MoE-shape timing as ``moe_shape``, recurrentgemma's as
   ``hybrid_shape``, seamless's three as ``encdec_shapes``, internvl2's
   as ``vlm_shape`` and phi3's as ``phi3_shape``: B7 once a route, as
   ``flash_attention_general`` — its forced bf16 timing, the float32 one as
   ``float32`` — and ``flash_attention_sm90``; the seven redesigned Bloom
   kernels also carry the launch floor, ``h3_hash`` (timed at 262,144
   lines) its timing at LazySync's ids as ``lazysync_ids``, ``bloom_detect_conflicts`` (timed
   at qwen3-4b width) the capture's shape under ``other_shapes``, the queries their old bound,
   ``bloom_query`` its two-bitmap timing as ``pair``, ``bloom_insert`` its
   pair, bank and bank pair timings, ``bloom_insert_onehot`` its pair and
   ``bloom_intersect`` (timed per row) its pair-and-any timing as ``pair``;
   every number in the line but the bounds measured in this run), then the
   result line.

float32 matmuls run in full float32 (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` are set False) wherever float32
results are compared.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "golden"
GOLDEN_WORKLOADS = ("pagerank-arxiv", "htap128")
RATIO_KEYS = ("speedup", "traffic", "energy")
EVENT_KEYS = ("commits", "conflicts_sig", "conflicts_exact", "rollbacks",
              "flush_lines", "dbi_writebacks")
RATIO_RTOL, RAW_RTOL = 1e-6, 1e-4
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, the float32
# rate outside the tensor cores used as the integer-ALU ceiling, and the
# dense bf16 tensor-core rate (the attention products' ceiling).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
ROTATE_BYTES = 2 * 50 * 2**20  # twice the H100's L2
SPIN_CYCLES_PER_S = 2.0e9      # above the H100's top SM clock, 1.98 GHz
TPU_KERNEL = {
    "h3_hash": "src/repro/kernels/bloom/bloom.py:62",
    "bloom_insert": "src/repro/kernels/bloom/bloom.py:135",
    "bloom_query": "src/repro/kernels/bloom/bloom.py:205",
    "bloom_intersect": "src/repro/kernels/bloom/bloom.py:316",
    "bloom_detect_conflicts": "src/repro/kernels/bloom/bloom.py:266",
    "lazy_merge": "src/repro/kernels/lazy_merge/lazy_merge.py:30",
    "flash_attention_general": "src/repro/kernels/flash_attention/flash_attention.py:82",
    "bloom_insert_onehot": "src/repro/kernels/bloom/bloom.py:367",
    "bloom_query_onehot": "src/repro/kernels/bloom/bloom.py:420",
    "flash_attention_sm90": "src/repro/kernels/flash_attention/flash_attention.py:82",
}
SOURCE = {name: "src/repro_torch/csrc/bloom.cu" for name in TPU_KERNEL}
SOURCE["lazy_merge"] = "src/repro_torch/csrc/lazy_merge.cu"
SOURCE["flash_attention_general"] = "src/repro_torch/csrc/flash_attention.cu"
SOURCE["flash_attention_sm90"] = "src/repro_torch/csrc/flash_attention_sm90.cu"
# B7's two routes under their kernel names in the counts and the kernels line
# (the package's one ``flash_attention`` count is their sum)
FA_ROUTE_KERNEL = {"general": "flash_attention_general", "sm90": "flash_attention_sm90"}
SEED_KERNELS = ("bloom_insert_onehot", "bloom_query_onehot")
for _name in SEED_KERNELS:
    SOURCE[_name] = "src/repro_torch/csrc/bloom_onehot.cu"
SEED_ABLATION_WORKLOADS = ("pagerank-arxiv", "htap128")
# The seed path makes ~860,000 kernel launches; the profiler's bookkeeping
# of them all would take minutes, so the idle share is read on these two.
SEED_PROFILE_WORKLOADS = SEED_ABLATION_WORKLOADS
XORFOLD_OPS = 3  # a shift-and bit test, a select and an XOR per round
PARITY_OPS = 3   # an AND, a POPC and a bit insert per column mask
# The LazyPIM window asks each signature image once for two bitmaps: two
# bloom_query launches a window of each LazyPIM dispatch; it builds its two
# images from one bloom_insert launch and its two CPUWriteSet banks from
# another; the seed window builds its two images from one B8a launch.
QUERIES_PER_WINDOW = 2
INSERTS_PER_WINDOW = 2
# ...and answers both conflict checks (its two banks against the read
# image, any register) from one bloom_intersect launch.
INTERSECTS_PER_WINDOW = 1
# The previous designs' per-call readings at the shapes timed here (PERF.md
# §6): the insert's id list (3 x 256), the bank of one bitmap with the zero
# fill it needed, B8a at (1, 256); the staged-table B1 at 262,144 lines and
# B5 at G = 4 with N = 16,384 and 192.  Printed beside this run's timings
# for comparison, never reported as this run's.
PREVIOUS_MS = {"bloom_insert": 0.00574, "bloom_insert bank": 0.00911,
               "bloom_insert_onehot": 0.00642, "h3_hash": 0.01413,
               "bloom_detect_conflicts": 0.00670,
               "bloom_detect_conflicts capture": 0.00637}
PREVIOUS_CARD = "PERF.md §6, NVIDIA H100 80GB HBM3, 700.00 W"
SIG_HASH_BATCH, SIG_KERNEL_BATCH, SIG_LINES = 4096, 1024, 65_536
SIG_GROUPS, SIG_IDS_PER_GROUP = 4, 256
FIG7_KERNELS = ("h3_hash", "bloom_insert", "bloom_query", "bloom_intersect")
CAPTURE_KERNELS = FIG7_KERNELS + ("bloom_detect_conflicts", "lazy_merge")
MERGE_RTOL = 1e-6
CAPTURE_APP = "capture/lazy_embed"
KV_APP = "capture/kv_serve"
# Flash attention against its plain version, element by element:
# |kernel - plain| <= rtol |plain| + row_tol rms(plain row), the RMS taken
# over each output row's head dim; (rtol, row_tol) by dtype.  In bf16, rtol
# covers the two outputs' bf16 roundings landing one ulp apart and row_tol
# the tensor-core sums' other order (the kernels feed P to the PV product
# as two bf16 parts, ~2^-17 of P: a single bf16 P, 2^-9, strayed past this
# tolerance on a training step's activations, whose V has channels far
# above the output row's RMS); a row missing
# one KV tile of 64 keys in 4,096 moves by ~0.13 of its RMS, ~8x this
# tolerance.  In float32 both sides compute in float32 (the on-card tests'
# pair).
FA_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -6), "float32": (1e-5, 1e-3)}
PREFILL_BATCH, PREFILL_LEN = 4, 4096   # the train_4k sequence length
SMOKE_PREFILL_LEN = 150
SERVE_ARGS = dict(arch="qwen3-4b", smoke=False, requests=8, batch=4, max_new=16,
                  max_len=64, seed=0, study=None)  # the reference serve loop's defaults
TEACHER_LEN = 64
MOE_ARCH = "qwen2_moe_a2_7b"
MOE_SERVE_ARGS = dict(SERVE_ARGS, arch="qwen2-moe-a2.7b")
MOE_SMOKE_ARCHS = ("qwen2_moe_a2_7b", "moonshot_v1_16b_a3b")
MOONSHOT_ARCH = "moonshot_v1_16b_a3b"
MOONSHOT_SERVE_ARGS = dict(SERVE_ARGS, arch="moonshot-v1-16b-a3b")
PHI3_ARCH = "phi3_mini_3_8b"
PHI3_SERVE_ARGS = dict(SERVE_ARGS, arch="phi3-mini-3.8b")
MOE_SMOKE_LEN, MOE_SMOKE_DECODE = 32, 3
MOE_DISPATCHES = ("sort", "cumsum", "ep")
MOE_DISPATCH_TOL = 3e-2  # the reference's EP-against-sort tolerance (tests/test_moe_ep.py:43)
MOE_DROP_CAPACITY_FACTOR = 1.0  # capacity 1,024 a padded expert at T = 16,384: hot experts drop
SSM_ARCH = "falcon_mamba_7b"
HYBRID_ARCH = "recurrentgemma_2b"
SSM_SERVE_ARGS = dict(SERVE_ARGS, arch="falcon-mamba-7b")
HYBRID_SERVE_ARGS = dict(SERVE_ARGS, arch="recurrentgemma-2b")
# falcon-mamba's prefill: 4 x 4,096 tokens.  Each (B, S, 8,192, 16) float32
# scan term is 8.6 GB there; the scan keeps dA, dBx and its half-length
# levels (~2x more) beside the 13.05 GiB of bf16 weights, ~50 GB in all.
SSM_PREFILL_BATCH = 4
SSM_CHECK_LEN = 256   # tokens of layer 0's card-against-CPU ssm_block check
# float32, TF32 off: rtol, and atol as a share of the output's largest
# magnitude (the reference's init scales a stacked leaf by its fan-in over
# the layer axis too, so full-width activations are ~1e-3)
SSM_CHECK_TOL = 1e-4
ENCDEC_ARCH = "seamless_m4t_large_v2"
VLM_ARCH = "internvl2_26b"
FRONTEND_SEED = 0        # the seed of the synthetic frontend embeddings
TRAIN_ARCH = "qwen3-4b"
TRAIN_STEPS = 4          # make_train_step steps at full width, every B7 call checked
TRAIN_TIMED_STEPS = 3    # further steps, unchecked, for the step wall
TRAIN_BATCH, TRAIN_LEN = 1, 4096
TRAIN_LR = 3e-3          # launch/train.py's default
TRAIN_CHECK_LEN = 256    # tokens of layer 0's card-against-CPU attention gradient
TRAIN_GRAD_TOL = 1e-4    # float32, TF32 off: rtol, and atol as a share of the largest entry
# tests/test_train_e2e.py's run, on the card
TRAIN_SMOKE_ARGS = dict(arch="qwen3-4b", smoke=True, steps=24, batch=2, seq=64, lr=5e-3,
                        seed=0, log_every=100, ckpt_every=8)
TRAIN_FAIL_AT, TRAIN_RESTORED, TRAIN_BAND = 16, 8, 0.05
# The dry run (repro_torch.launch.dryrun) runs in a process of its own from
# the start, beside the card phases (the fake process group it starts is
# global to its process); its result is read at the end.
DRYRUN_ARCH = "qwen3_4b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k")
DRYRUN_TIMEOUT_S = 900
DRYRUN_SCRIPT = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.roofline import analysis as RA
arch, shapes, batch, seq = sys.argv[1], sys.argv[2].split(","), int(sys.argv[3]), int(sys.argv[4])
out = {"cells": []}
for multi_pod in (False, True):
    for shape in shapes:
        t0 = time.perf_counter()
        res, _ = D.lower_cell(arch, shape, multi_pod=multi_pod)
        res["wall_s"] = time.perf_counter() - t0
        out["cells"].append(res)
t0 = time.perf_counter()
out["analysis"] = RA.analyze_cell(arch, shapes[0])
out["analysis"]["wall_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
mesh = D.fake_mesh((1, 1), ("data", "model"))
card = D.lower_shape(get_config(arch), ShapeSpec("card_train", seq, batch, "train"), mesh,
                     M.LOGICAL_RULES_SINGLE)
card["wall_s"] = time.perf_counter() - t0
out["card_cell"] = card
print(json.dumps(out))
"""
FIG7_PROFILE_WORKLOADS = ("pagerank-arxiv", "htap128")
# benchmarks/fig_capture.py:48: the three captured families, then the
# synthetic analogue of each
CAPTURE_STUDY = ("capture/kv_serve", "capture/moe_experts", "capture/lazy_embed",
                 "htap_stream", "mtmix-enron", "pagerank-enron")
LAZY_STEPS = 24          # qwen3-4b-width sync_steps (commit fires at 16)
LAZY_PROFILE_STEPS = 8   # steps timed twice for the idle share
LAZY_TOUCHED = 4096      # touched ids per group per step
LAZY_ZIPF = 3.0

# Main-path shapes: the HTAP geometry bucket (3 lanes of 262,144 lines,
# 72 windows of 256 PIM slots), the paper's 2048-bit / 4-segment signature.
HTAP_BUCKET = ("htap128", "htap192", "htap256")
LINES = 262_144
LANES = 3
WINDOWS = 72
SLOTS = 256


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (t+{time.perf_counter() - _START:.1f} s)", flush=True)


def environment() -> str:
    import torch

    phase("environment")
    check(torch.cuda.is_available(), "no CUDA device visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return card


def launch_counts() -> dict[str, int]:
    """Every kernel's launches since the last reset, B7's split by route:
    ``flash_attention_general`` and ``flash_attention_sm90`` in place of the
    package's ``flash_attention`` (their sum)."""
    from repro_torch import kernels as KS

    FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    counts = KS.launch_counts()
    del counts["flash_attention"]
    for route, n in FA.route_counts().items():
        counts[FA_ROUTE_KERNEL[route]] = n
    return counts


def build():
    import torch

    phase("build")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.bloom import bloom as K
    from repro_torch.kernels.bloom import onehot as K8

    LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
    FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    t0 = time.perf_counter()
    libs = _build.build_all()
    K._lib()
    K8._lib()
    LM._lib()
    FA._lib()
    FA._lib_sm90()
    print(f"built {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} "
          f"in {time.perf_counter() - t0:.2f} s (one nvcc per source, in "
          f"parallel)", flush=True)
    attributes = [("bloom_query", K.query_attributes()),
                  ("bloom_query_onehot", K8.query_attributes()),
                  ("bloom_insert_onehot", K8.insert_attributes())]
    attributes += [(f"bloom_insert {form} form", builds)
                   for form, builds in K.insert_attributes().items()]
    attributes += [("h3_hash", K.hash_attributes()),
                   ("bloom_detect_conflicts", K.detect_attributes())]
    for name, builds in attributes:
        for build_of, a in builds.items():
            print(f"{name} ({build_of} geometry): {a['registers']} registers and "
                  f"{a['local_bytes']} bytes of local memory a thread, "
                  f"{a['static_smem_bytes']} bytes of static shared memory a block",
                  flush=True)
            check(a["local_bytes"] == 0,
                  f"{name} ({build_of}): {a['local_bytes']} bytes of local memory "
                  f"(no build may spill or index a local array)")
    for dtype in (torch.bfloat16, torch.float32):
        for d in FA.general_bands(dtype):
            a = FA.general_attributes(dtype, d)
            print(f"flash_attention_general {str(dtype).removeprefix('torch.')} band to "
                  f"D = {d}: {a['registers']} "
                  f"registers and {a['local_bytes']} bytes of local memory (spills, stack) "
                  f"a thread; {a['static_smem_bytes']} static + {a['dynamic_smem_bytes']} "
                  f"dynamic bytes of shared memory a block at that D; {a['threads']} threads, "
                  f"{a['block_q']} query rows and {a['block_k']} keys a tile", flush=True)
    for d in sorted(FA.SM90_HEAD_DIMS):
        a = FA.sm90_attributes(d)
        print(f"flash_attention_sm90 D = {d}: {a['registers']} registers and "
              f"{a['local_bytes']} bytes of local memory (spills, stack) a thread; "
              f"{a['static_smem_bytes']} static + {a['dynamic_smem_bytes']} dynamic bytes "
              f"of shared memory a block", flush=True)
    return K


def rotations(args: tuple, iters: int) -> list[tuple]:
    """``args`` and copies of its tensors: enough sets (at most ``iters``)
    that one pass through them reads ``ROTATE_BYTES``, so a timed loop that
    cycles through them reads its inputs from HBM and not from the 50 MB
    L2, as a caller with fresh data does."""
    import torch

    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = max(1, min(iters, math.ceil(ROTATE_BYTES / max(nbytes, 1))))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]


def event_ms(fn, sets: list[tuple], iters: int) -> float:
    """Mean time per call of ``fn(*sets[i % len(sets)])`` between CUDA
    events over ``iters`` back-to-back calls, after a warm-up.  A spin
    kernel holds the stream while the host enqueues the calls, so the
    events time the device running them back to back, not the host's
    launch rate (a call that synchronizes inside still shows its gap)."""
    import torch

    for args in sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * enqueue_s, 2.0) * SPIN_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_floor_ms() -> float:
    """The card's launch floor: a one-element PyTorch elementwise op timed
    as the kernels are (CUDA events over back-to-back calls, a spin kernel
    ahead).  No launch takes less, so a kernel whose bound is far below it
    is read against this floor."""
    import torch

    x = torch.zeros(1, device="cuda")
    ms = event_ms(lambda t: t.add_(1), [(x,)], 200)
    print(f"launch floor: {ms:.5f} ms a call (one-element add_, CUDA events over "
          f"200 back-to-back calls)", flush=True)
    return ms


def lazypim_windows(study, rs, engine: str) -> int:
    """The windows the LazyPIM dispatches of a run walk: one dispatch a
    geometry bucket (its padded windows) in the batch engine, one a point
    in the sequential one."""
    check("lazypim" in study.mechanisms, "no LazyPIM dispatch")
    if engine == "batch":
        return sum(b["num_windows"] for b in study.plan().buckets)
    per_trace = {tt.name: tt.num_windows for tt in study.traces()}
    return sum(per_trace[p.workload] for p in rs)


def _check_per_window(kernel: str, per_window: int, label: str, study, rs, engine: str,
                      counts: dict) -> int:
    windows = lazypim_windows(study, rs, engine)
    want = per_window * windows
    check(counts[kernel] == want,
          f"{label}: {counts[kernel]} {kernel} launches, want {want} ({per_window} a "
          f"window over {windows} LazyPIM windows)")
    return want


def check_query_launches(label: str, study, rs, engine: str, counts: dict) -> int:
    """``bloom_query`` must launch exactly ``QUERIES_PER_WINDOW`` times a
    window of each LazyPIM dispatch.  Returns the expected count."""
    return _check_per_window("bloom_query", QUERIES_PER_WINDOW, label, study, rs, engine,
                             counts)


def check_insert_launches(label: str, study, rs, engine: str, counts: dict) -> int:
    """``bloom_insert`` must launch exactly ``INSERTS_PER_WINDOW`` times a
    window of each LazyPIM dispatch: the read and write images from one
    launch, the ``cpuws`` and ``conc`` banks from another.  Returns the
    expected count."""
    return _check_per_window("bloom_insert", INSERTS_PER_WINDOW, label, study, rs, engine,
                             counts)


def check_intersect_launches(label: str, study, rs, engine: str, counts: dict) -> int:
    """``bloom_intersect`` must launch exactly ``INTERSECTS_PER_WINDOW`` times
    a window of each LazyPIM dispatch: both conflict checks from one
    pair-and-any launch.  Returns the expected count."""
    return _check_per_window("bloom_intersect", INTERSECTS_PER_WINDOW, label, study, rs,
                             engine, counts)


def measure(label: str, err: float, fn, plain, args: tuple, nbytes: float,
            ops: float, iters: int = 200, plain_iters: int = 10,
            ops_per_s: float = PEAK_OPS_PER_S, library=None,
            library_args: tuple | None = None) -> dict:
    """Time ``fn(*args)`` and its plain version on the same inputs, rotated
    out of L2 (:func:`rotations`), with CUDA events; the kernel's bound
    from the bytes and operations the call needs (operations at
    ``ops_per_s``).  ``library`` (one PyTorch call computing the same
    function, on ``library_args``) is timed the same way as a yardstick.  A
    time under the bound is a fault of the timing and fails the phase."""
    sets = rotations(args, iters)
    ms = event_ms(fn, sets, iters)
    plain_ms = event_ms(plain, sets, plain_iters)
    library_ms = (None if library is None
                  else event_ms(library, rotations(library_args, iters), iters))
    b, by = bound_ms(nbytes, ops, ops_per_s)
    lib = "" if library_ms is None else f", library {library_ms:.5f} ms"
    print(f"{label}: max |err| {err}; per call (CUDA events, {len(sets)} input "
          f"sets) kernel {ms:.5f} ms, plain {plain_ms:.5f} ms{lib}; bound "
          f"{b:.6f} ms ({by}, {b / ms:.3f} of it reached)", flush=True)
    check(ms >= b, f"{label}: {ms:.6f} ms is under the bound {b:.6f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=library_ms, timing="events",
                input_sets=len(sets))


def kernel_phases(K, floor_ms: float) -> dict[str, dict]:
    """Each kernel against its plain version on the main path's data: the
    HTAP geometry bucket (htap128/192/256 padded to 262,144 lines, 72
    windows of 256 PIM slots).  Exactness is checked on every window of
    every lane; times are taken at the per-window call shape (3 lanes)."""
    import torch

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.lazy_sync import LazySyncConfig
    from repro_torch.core.signatures import default_spec, packed_tables, unpack_words
    from repro_torch.sim.engine import stack_traces
    from repro_torch.sim.prep import pad_trace, popcount_words, prepare, scatter_set
    from repro_torch.sim.trace import make_trace

    dev = torch.device("cuda", 0)
    spec = default_spec()
    S, M, NW = spec.num_byte_slices, spec.num_segments, spec.num_words
    st = stack_traces([pad_trace(prepare(make_trace(app, device=dev), device=dev),
                                 num_lines=LINES) for app in HTAP_BUCKET])
    L, W = st.pim_reads.shape[:2]
    check((L, W, st.pim_reads.shape[2], st.num_lines) == (LANES, WINDOWS, SLOTS, LINES),
          f"HTAP bucket shape {tuple(st.pim_reads.shape)} x {st.num_lines} lines")
    # Per-lane line bitmaps as the window loop sees them: everything the
    # processor dirties over the run, and everything it caches.
    zeros = torch.zeros((L, st.num_line_words), dtype=torch.int32, device=dev)
    pre = st.pre_writes_words[:, 0]
    for k in range(1, st.num_kernels):
        pre = pre | st.pre_writes_words[:, k]
    dirty = scatter_set(pre, st.cpu_writes.reshape(L, -1),
                        st.cpu_w_valid.reshape(L, -1), LINES)
    present = scatter_set(dirty, st.cpu_reads.reshape(L, -1),
                          st.cpu_r_valid.reshape(L, -1), LINES)
    check(bool((present != zeros).any()), "empty line bitmaps")
    n_dirty, n_present = int(popcount_words(dirty).sum()), int(popcount_words(present).sum())
    out = {}

    def exact(name, got, want):
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name}: kernel {got.dtype}{tuple(got.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = int(diff.max()) if diff.numel() else 0
        check(err == 0, f"{name}: kernel disagrees with plain version "
                        f"(max |diff| {err}, {int((diff != 0).sum())} elements)")
        return err

    def record(name, err, fn, plain, args, nbytes, ops):
        out[name] = measure(name, err, fn, plain, args, nbytes, ops)

    phase("kernel h3_hash")
    lines = torch.arange(LINES, dtype=torch.int32, device=dev)
    err = exact("h3_hash", K.h3_hash(spec, lines), K.h3_hash_plain(spec, lines))
    full = torch.randint(-2**31, 2**31 - 1, (LINES,), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(0))
    exact("h3_hash (32-bit addresses)", K.h3_hash(spec, full), K.h3_hash_plain(spec, full))
    # LazySync's shape: the first step's 4 x 4,096 touched ids at qwen3-4b width
    touched = torch.from_numpy(_lazy_touched(
        np.random.default_rng([1, 0]), get_config("qwen3_4b").vocab,
        LazySyncConfig().num_groups, LAZY_TOUCHED).reshape(-1)).to(dev)
    err_ids = exact("h3_hash (LazySync ids)", K.h3_hash(spec, touched),
                    K.h3_hash_plain(spec, touched))
    ptab_bytes = packed_tables(spec).nbytes

    def hash_bound(n):
        """Each address read once, its M positions written once, the packed
        table read once; per address S gathers, S - 1 XORs and a shift, mask
        and OR a segment."""
        return dict(nbytes=n * 4 + n * M * 4 + ptab_bytes, ops=n * (2 * S - 1 + 3 * M))

    def hash_timed(label, n_err, args):
        st_ = measure(label, n_err, lambda a: K.h3_hash(spec, a),
                      lambda a: K.h3_hash_plain(spec, a), args, **hash_bound(args[0].numel()))
        print(f"{label}: launch floor {floor_ms:.5f} ms ({st_['ms'] / floor_ms:.2f}x it)",
              flush=True)
        return st_

    prev = PREVIOUS_MS["h3_hash"]
    print(f"h3_hash: previous design's reading {prev:.5f} ms at {LINES} lines "
          f"({PREVIOUS_CARD})", flush=True)
    out["h3_hash"] = dict(hash_timed(f"h3_hash ({LINES} lines)", err, (lines,)),
                          lazysync_ids=hash_timed(f"h3_hash ({touched.numel()} LazySync ids)",
                                                  err_ids, (touched,)))

    phase("kernel bloom_insert")
    log_seg = spec.seg_bits.bit_length() - 1
    hash_ops = M * log_seg * PARITY_OPS  # the parity form's operations a line
    all_ids = st.pim_reads.reshape(L * W, SLOTS)  # every window of every lane
    all_valid = st.pim_r_valid.reshape(L * W, SLOTS)
    all_wids = st.pim_writes.reshape(L * W, SLOTS)
    all_wvalid = st.pim_w_valid.reshape(L * W, SLOTS)
    sigs = K.bloom_insert(spec, ids=all_ids, valid=all_valid)
    err = exact("bloom_insert", sigs, K.bloom_insert_plain(spec, ids=all_ids, valid=all_valid))
    got = K.bloom_insert(spec, ids=all_ids, valid=all_valid, ids_b=all_wids,
                         valid_b=all_wvalid)
    want = K.bloom_insert_plain(spec, ids=all_ids, valid=all_valid, ids_b=all_wids,
                                valid_b=all_wvalid)
    err_pair = max(exact("bloom_insert (id pair, reads)", got[0], want[0]),
                   exact("bloom_insert (id pair, writes)", got[1], want[1]))
    # a window's conc bitmap: the lines the processor writes in window 0
    conc = scatter_set(zeros, st.cpu_writes[:, 0], st.cpu_w_valid[:, 0], LINES)
    n_conc = int(popcount_words(conc).sum())
    bank = K.bloom_insert(spec, bitmap=dirty, num_lines=LINES, num_regs=16)
    err_bank = exact("bloom_insert (bank mode)", bank, K.bloom_insert_plain(
        spec, bitmap=dirty, num_lines=LINES, num_regs=16))
    got = K.bloom_insert(spec, bitmap=dirty, bitmap_b=conc, num_lines=LINES, num_regs=16)
    want = K.bloom_insert_plain(spec, bitmap=dirty, bitmap_b=conc, num_lines=LINES,
                                num_regs=16)
    err_bank_pair = max(exact("bloom_insert (bank pair, dirty)", got[0], want[0]),
                        exact("bloom_insert (bank pair, conc)", got[1], want[1]))
    bank_conc = got[1]  # the window's conc bank, for bloom_intersect's pair form
    ids, valid = st.pim_reads[:, 0].contiguous(), st.pim_r_valid[:, 0].contiguous()
    wids, wvalid = st.pim_writes[:, 0].contiguous(), st.pim_w_valid[:, 0].contiguous()
    n_valid, n_wvalid = int(valid.sum()), int(wvalid.sum())
    img_bytes, bank_bytes = L * NW * 4, L * 16 * NW * 4
    old_tab_bytes = S * 256 * M * 4  # the uint32 tables the old designs staged

    def timed(label, err, fn, plain, args, nbytes, ops, previous=None):
        st_ = measure(label, err, fn, plain, args, nbytes, ops)
        prev = "" if previous is None else (f"; {previous} ({PREVIOUS_CARD})")
        print(f"{label}: launch floor {floor_ms:.5f} ms ({st_['ms'] / floor_ms:.2f}x "
              f"it){prev}", flush=True)
        return st_

    prev = PREVIOUS_MS["bloom_insert"]
    single = timed(f"bloom_insert ({L} x {SLOTS} ids, {n_valid} valid)", err,
                   lambda i, v: K.bloom_insert(spec, ids=i, valid=v),
                   lambda i, v: K.bloom_insert_plain(spec, ids=i, valid=v), (ids, valid),
                   nbytes=ids.numel() * 5 + img_bytes, ops=n_valid * hash_ops,
                   previous=f"previous design's reading {prev:.5f} ms")
    old_bound, old_by = bound_ms(ids.numel() * 5 + img_bytes + old_tab_bytes,
                                 n_valid * M * (2 * S + 2))
    print(f"bloom_insert: old bound {old_bound:.7f} ms ({old_by}; the staged tables "
          f"counted)", flush=True)
    pair = timed(f"bloom_insert id pair ({L} x {SLOTS} ids twice, {n_valid} and "
                 f"{n_wvalid} valid)", err_pair,
                 lambda i, v, j, w: K.bloom_insert(spec, ids=i, valid=v, ids_b=j, valid_b=w),
                 lambda i, v, j, w: K.bloom_insert_plain(spec, ids=i, valid=v, ids_b=j,
                                                         valid_b=w),
                 (ids, valid, wids, wvalid), nbytes=2 * ids.numel() * 5 + 2 * img_bytes,
                 ops=(n_valid + n_wvalid) * hash_ops,
                 previous=f"previous design's reading for one list {prev:.5f} ms")
    prev = PREVIOUS_MS["bloom_insert bank"]
    bank_one = timed(f"bloom_insert bank ({L} x {LINES} lines, {n_dirty} set, 16 "
                     f"registers, no fill)", err_bank,
                     lambda d: K.bloom_insert(spec, bitmap=d, num_lines=LINES, num_regs=16),
                     lambda d: K.bloom_insert_plain(spec, bitmap=d, num_lines=LINES,
                                                    num_regs=16),
                     (dirty,), nbytes=dirty.numel() * 4 + bank_bytes,
                     ops=n_dirty * hash_ops,
                     previous=f"previous design's reading {prev:.5f} ms with its fill")
    bank_pair = timed(f"bloom_insert bank pair ({L} x {LINES} lines twice, {n_dirty} and "
                      f"{n_conc} set, no fill)", err_bank_pair,
                      lambda d, c: K.bloom_insert(spec, bitmap=d, bitmap_b=c,
                                                  num_lines=LINES, num_regs=16),
                      lambda d, c: K.bloom_insert_plain(spec, bitmap=d, bitmap_b=c,
                                                        num_lines=LINES, num_regs=16),
                      (dirty, conc), nbytes=2 * dirty.numel() * 4 + 2 * bank_bytes,
                      ops=(n_dirty + n_conc) * hash_ops,
                      previous=f"previous design's reading {prev:.5f} ms for one bank "
                               f"with its fill, two such calls a window")
    out["bloom_insert"] = dict(single, old_bound_ms=old_bound, pair=pair, bank=bank_one,
                               bank_pair=bank_pair,
                               shape=dict(L=L, slots=SLOTS, valid=n_valid,
                                          write_valid=n_wvalid, num_lines=LINES,
                                          dirty_lines=n_dirty, conc_lines=n_conc))

    phase("kernel bloom_query")
    sigs = sigs[:, 0].contiguous()                          # (L * W, NW)
    words_all = present.repeat_interleave(W, dim=0)         # lane-major, as sigs
    dirty_all = dirty.repeat_interleave(W, dim=0)
    err = exact("bloom_query", K.bloom_query(spec, sigs, words_all, LINES),
                K.bloom_query_plain(spec, sigs, words_all, LINES))
    got = K.bloom_query(spec, sigs, words_all, LINES, words_b=dirty_all)
    want = K.bloom_query_plain(spec, sigs, words_all, LINES, words_b=dirty_all)
    exact("bloom_query (pair, first bitmap)", got[0], want[0])
    exact("bloom_query (pair, second bitmap)", got[1], want[1])
    read_sig = sigs.reshape(L, W, NW)[:, 0].contiguous()

    def query_ops(words):
        """Parity operations the lines set in ``words`` need: every column
        of each segment hashed, up to the first clear bit."""
        lane, line = torch.nonzero(unpack_words(words, LINES), as_tuple=True)
        pos = K.h3_hash(spec, line.to(torch.int32)).to(torch.int64)
        looked = ((read_sig[lane[:, None], pos >> 5] >> (pos & 31)) & 1)
        hashed = int((looked.cumprod(-1).sum(-1) + 1).clamp(max=M).sum())
        return hashed * log_seg * PARITY_OPS, hashed

    sig_bytes = read_sig.numel() * 4
    ops, hashed = query_ops(present)
    old_bound, old_by = bound_ms(2 * present.numel() * 4 + sig_bytes + old_tab_bytes,
                                 present.numel() * 2 + n_present * M * (2 * S + 2))
    st = measure(f"bloom_query ({L} x {LINES} lines, {n_present} set, {hashed} "
                 f"segments hashed)", err,
                 lambda sg, w: K.bloom_query(spec, sg, w, LINES),
                 lambda sg, w: K.bloom_query_plain(spec, sg, w, LINES), (read_sig, present),
                 nbytes=2 * present.numel() * 4 + sig_bytes, ops=ops)
    print(f"bloom_query: old bound {old_bound:.7f} ms ({old_by}; tables staged and "
          f"every word's bytes counted as work)", flush=True)
    ops_pair, hashed_pair = query_ops(present | dirty)
    pair = measure(f"bloom_query pair ({L} x {LINES} lines, {n_present} and {n_dirty} "
                   f"set, {hashed_pair} segments hashed)", err,
                   lambda sg, w, d: K.bloom_query(spec, sg, w, LINES, words_b=d),
                   lambda sg, w, d: K.bloom_query_plain(spec, sg, w, LINES, words_b=d),
                   (read_sig, present, dirty),
                   nbytes=4 * present.numel() * 4 + sig_bytes, ops=ops_pair)
    out["bloom_query"] = dict(st, old_bound_ms=old_bound, segments_hashed=hashed,
                              pair=dict(pair, segments_hashed=hashed_pair),
                              shape=dict(L=L, num_lines=LINES, set_lines=n_present,
                                         pair_set_lines=n_dirty))

    phase("kernel bloom_intersect")
    bank_all = bank.repeat_interleave(W, dim=0).reshape(L * W * 16, NW)
    conc_all = bank_conc.repeat_interleave(W, dim=0).reshape(L * W * 16, NW)
    err_row = exact("bloom_intersect", K.bloom_intersect(bank_all, sigs, M),
                    K.bloom_intersect_plain(bank_all, sigs, M))
    # the pair-and-any form on every window of every lane: against its plain
    # version and against two per-row calls and their .any over registers
    got = K.bloom_intersect(bank_all, sigs, M, a_b=conc_all)
    err = exact("bloom_intersect (pair)", got,
                K.bloom_intersect_plain(bank_all, sigs, M, a_b=conc_all))
    two = torch.stack([K.bloom_intersect(x, sigs, M).reshape(L * W, 16).any(1)
                       for x in (bank_all, conc_all)])
    exact("bloom_intersect (pair vs two per-row calls)", got, two)
    n_hits = [int(x.sum()) for x in got]
    flat_bank, flat_conc = bank.reshape(L * 16, NW), bank_conc.reshape(L * 16, NW)
    bank_bytes = flat_bank.numel() * 4
    pair = measure(f"bloom_intersect pair ({L} lanes x 16 registers x {NW} words, two "
                   f"banks, any register)", err,
                   lambda a, c, b: K.bloom_intersect(a, b, M, a_b=c),
                   lambda a, c, b: K.bloom_intersect_plain(a, b, M, a_b=c),
                   (flat_bank, flat_conc, read_sig),
                   nbytes=2 * bank_bytes + read_sig.numel() * 4 + 2 * L,
                   ops=2 * flat_bank.numel() * 2)
    per_row = measure(f"bloom_intersect per row ({L * 16} rows x {NW} words)", err_row,
                      lambda a, b: K.bloom_intersect(a, b, M),
                      lambda a, b: K.bloom_intersect_plain(a, b, M), (flat_bank, read_sig),
                      nbytes=bank_bytes + read_sig.numel() * 4 + L * 16,
                      ops=flat_bank.numel() * 2)
    two_ms = event_ms(lambda a, c, b: (K.bloom_intersect(a, b, M).reshape(L, 16).any(1),
                                       K.bloom_intersect(c, b, M).reshape(L, 16).any(1)),
                      rotations((flat_bank, flat_conc, read_sig), 200), 200)
    print(f"bloom_intersect: a window's two checks as two per-row calls and their .any "
          f"(the previous path) {two_ms:.5f} ms against the pair's {pair['ms']:.5f} ms; "
          f"launch floor {floor_ms:.5f} ms ({pair['ms'] / floor_ms:.2f}x it); "
          f"{n_hits} lane-windows hit in the two banks", flush=True)
    out["bloom_intersect"] = dict(per_row, pair=pair, two_per_row_calls_ms=two_ms,
                                  shape=dict(L=L, registers=16, words=NW, hits=n_hits))
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def check_golden(rs, golden: dict, label: str) -> float:
    """Hold a ResultSet's golden workloads to the golden JSON; returns the
    worst relative gap seen."""
    from repro_torch.api import summarize

    worst = 0.0
    got = {p.workload: (p.results, summarize(p.results, p.hw)) for p in rs}
    for name in GOLDEN_WORKLOADS:
        results, summary = got[name]
        check(set(summary) == set(golden[name]),
              f"{label}/{name}: mechanisms {sorted(summary)}")
        for mech, vals in golden[name].items():
            for key, want in vals.items():
                have = summary[mech][key]
                gap = _rel(have, want)
                worst = max(worst, gap)
                tol = RATIO_RTOL if key in RATIO_KEYS else RAW_RTOL
                check(gap < tol, f"{label}/{name}/{mech}/{key}: {have!r} vs "
                                 f"golden {want!r} (rel {gap:.3g} > {tol})")
            for key in EVENT_KEYS:
                if key in vals:
                    check(summary[mech][key] == vals[key],
                          f"{label}/{name}/{mech}/{key} not exact")
    return worst


def main_path(K) -> dict[str, dict[str, int]]:
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import MECHANISMS, Study, all_workloads
    from repro_torch.sim.engine import sequential_cache_sizes, sweep_cache_sizes

    golden = json.loads((GOLDEN_DIR / "fig7_golden.json").read_text())
    golden_batch = json.loads((GOLDEN_DIR / "fig7_batched_golden.json").read_text())
    runs, counts, walls = {}, {}, {}
    shape_counts = {"batch": sweep_cache_sizes, "sequential": sequential_cache_sizes}
    for engine in ("batch", "sequential"):
        phase(f"Fig. 7 path, engine={engine}")
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        study = Study(all_workloads())
        before = shape_counts[engine]()
        t0 = time.perf_counter()
        rs = study.run(engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = shape_counts[engine]()
        counts[engine] = launch_counts()
        runs[engine], walls[engine] = rs, wall
        shapes = {m: after[m] - before[m] for m in MECHANISMS}
        print(f"{engine}: {len(rs)} workloads x {len(MECHANISMS)} mechanisms "
              f"in {wall:.2f} s wall; launches {counts[engine]}; new dispatch shapes "
              f"{shapes}", flush=True)
        if engine == "batch":
            plan = study.plan().compiles_per_mechanism
            check(shapes == plan, f"Fig. 7/batch: {shapes} new dispatch shapes "
                                  f"(sweep_cache_sizes deltas), plan {plan}")
            print(f"batch: the sweep_cache_sizes deltas equal plan().compiles_per_mechanism "
                  f"{plan}", flush=True)
        for name in FIG7_KERNELS:
            check(counts[engine][name] > 0,
                  f"{engine}: kernel {name} was never launched")
        check_query_launches(f"Fig. 7/{engine}", study, rs, engine, counts[engine])
        check_insert_launches(f"Fig. 7/{engine}", study, rs, engine, counts[engine])
        check_intersect_launches(f"Fig. 7/{engine}", study, rs, engine, counts[engine])
        check(len(rs) == 12, f"{engine}: {len(rs)} points, want 12")
        for p in rs:
            for m, r in p.results.items():
                for k, v in dataclasses.asdict(r).items():
                    if isinstance(v, float):
                        check(math.isfinite(v) and v >= 0.0,
                              f"{engine}/{p.workload}/{m}/{k} = {v}")
        worst = check_golden(rs, golden if engine == "sequential" else golden_batch,
                             engine)
        print(f"{engine}: goldens {GOLDEN_WORKLOADS} hold (worst rel gap "
              f"{worst:.3g})", flush=True)
    phase("batch == sequential")
    for a, b in zip(runs["batch"].points, runs["sequential"].points):
        check(a.workload == b.workload, "point order differs between engines")
        for m in a.results:
            da, db = dataclasses.asdict(a.results[m]), dataclasses.asdict(b.results[m])
            diff = {k: (da[k], db[k]) for k in da if da[k] != db[k]}
            check(not diff, f"{a.workload}/{m}: batch != sequential {diff}")
    print("batch and sequential agree on every field of 12 x 6 results",
          flush=True)
    return counts, walls, runs


def exact_points(got, want, label: str) -> None:
    """Hold StudyPoints to others of the same workloads on every SimResult
    field, exactly."""
    check([p.workload for p in got] == [p.workload for p in want],
          f"{label}: workloads {[p.workload for p in got]} vs {[p.workload for p in want]}")
    for a, b in zip(got, want):
        check(set(a.results) == set(b.results), f"{label}/{a.workload}: mechanisms differ")
        for m in a.results:
            da, db = dataclasses.asdict(a.results[m]), dataclasses.asdict(b.results[m])
            diff = {k: (da[k], db[k]) for k in da if da[k] != db[k]}
            check(not diff, f"{label}/{a.workload}/{m}: {diff}")


def extended_fleet_path(paper_sequential, card: str) -> tuple[dict, dict]:
    """``Study(all_workloads(extended=True))`` -- the reference's Fig. 7
    driver's 22 workloads -- on both engines: the Bloom launches a LazyPIM
    window, batch == sequential on every field, the goldens and the Fig. 7
    phase's 12 paper results held, and the 10 new workloads against one CPU
    run of the port, every field exact."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import MECHANISMS, Study, all_workloads

    golden = json.loads((GOLDEN_DIR / "fig7_golden.json").read_text())
    golden_batch = json.loads((GOLDEN_DIR / "fig7_batched_golden.json").read_text())
    fleet, paper = all_workloads(extended=True), all_workloads()
    check(fleet[:len(paper)] == paper and len(fleet) == 22, f"extended fleet {fleet}")
    runs, counts, walls = {}, {}, {}
    for engine in ("batch", "sequential"):
        phase(f"extended Fig. 7 fleet, engine={engine}")
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        study = Study(fleet)
        t0 = time.perf_counter()
        rs = study.run(engine=engine)
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        counts[engine], runs[engine] = launch_counts(), rs
        print(f"{engine}: {len(rs)} workloads x {len(MECHANISMS)} mechanisms in "
              f"{walls[engine]:.2f} s wall on {card}; launches {counts[engine]}", flush=True)
        for name in FIG7_KERNELS:
            check(counts[engine][name] > 0, f"extended/{engine}: {name} never launched")
        label = f"extended Fig. 7/{engine}"
        check_query_launches(label, study, rs, engine, counts[engine])
        check_insert_launches(label, study, rs, engine, counts[engine])
        check_intersect_launches(label, study, rs, engine, counts[engine])
        check(len(rs) == 22, f"{engine}: {len(rs)} points, want 22")
        for p in rs:
            for m, r in p.results.items():
                for k, v in dataclasses.asdict(r).items():
                    if isinstance(v, float):
                        check(math.isfinite(v) and v >= 0.0,
                              f"extended/{engine}/{p.workload}/{m}/{k} = {v}")
        worst = check_golden(rs, golden if engine == "sequential" else golden_batch,
                             f"extended/{engine}")
        print(f"{engine}: goldens {GOLDEN_WORKLOADS} hold (worst rel gap {worst:.3g})",
              flush=True)
    phase("extended fleet: batch == sequential, paper 12 == Fig. 7 phase, new 10 == CPU")
    exact_points(runs["batch"].points, runs["sequential"].points, "extended batch vs sequential")
    exact_points(runs["sequential"].points[:12], paper_sequential.points,
                 "extended fleet's paper 12 vs the Fig. 7 phase")
    t0 = time.perf_counter()
    cpu = Study(fleet[12:], device="cpu").run(engine="sequential")
    cpu_wall = time.perf_counter() - t0
    exact_points(runs["sequential"].points[12:], cpu.points, "extended new 10 vs CPU")
    print(f"batch == sequential on every field of 22 x 6 results; the paper 12 equal "
          f"the Fig. 7 phase's; the new 10 ({', '.join(p.workload for p in cpu)}) equal "
          f"the CPU run ({cpu_wall:.2f} s) on every field", flush=True)
    walls["cpu_new10_sequential"] = cpu_wall
    return counts, walls


# The study service (repro_torch.serve): a burst of paper-scale requests,
# each one of the 12 workloads at default scale with every mechanism on two
# hw points (2 lanes in one bucket); a chaos storm on the reference chaos
# tests' two small specs (tests/test_serve_chaos.py:32-39).  Seed 0 at
# fault rate 0.3 over every fault class draws each class and variant by
# rid 169 (the first NaN poison_result), so the storm has 170 requests;
# its coalesced leg caps a group at 8 lanes, so a poison bisects in 3 steps.
SERVE_BURST = 16
SERVE_BURST_HW = {"offchip_bw_gbs": [32.0, 64.0]}
STORM_SEED, STORM_RATE, STORM_REQUESTS, STORM_BATCH_LANES = 0, 0.3, 170, 8
_STORM_SMALL = dict(num_kernels=3, windows_per_kernel=2)
STORM_BASE_SPECS = [
    {"workloads": [{"app": "pagerank", "graph": "arxiv", "scale": 0.4, **_STORM_SMALL}],
     "mechanisms": ["cpu", "lazypim"], "threads": 16},
    {"workloads": [{"app": "htap128", "scale": 0.004, **_STORM_SMALL}],
     "mechanisms": ["cpu", "lazypim"], "threads": 16},
]
SERVE_TIMEOUT_S = 300  # each fresh-process serve of the warm-restart check


class WindowTap:
    """Counts the LazyPIM windows every dispatch walks — the engine's
    ``_lazypim_acc`` wrapped while the tap is open — so the Bloom launches
    of any path (coalesced, bisected, audited, degraded) can be held to
    their counts a window."""

    def __init__(self):
        self.engine = importlib.import_module("repro_torch.sim.engine")
        self.inner, self.windows = self.engine._lazypim_acc, 0

    def __enter__(self):
        def counted(stt, shw, scfg):
            self.windows += stt.num_windows
            return self.inner(stt, shw, scfg)
        self.engine._lazypim_acc = counted
        return self

    def __exit__(self, *exc):
        self.engine._lazypim_acc = self.inner


def check_window_launches(label: str, counts: dict, windows: int) -> None:
    """Two ``bloom_query``, two ``bloom_insert`` and one ``bloom_intersect``
    launches a LazyPIM window walked."""
    check(windows > 0, f"{label}: no LazyPIM window walked")
    for name, per in (("bloom_query", QUERIES_PER_WINDOW),
                      ("bloom_insert", INSERTS_PER_WINDOW),
                      ("bloom_intersect", INTERSECTS_PER_WINDOW)):
        check(counts[name] == per * windows,
              f"{label}: {counts[name]} {name} launches, want {per} a window over "
              f"{windows} LazyPIM windows")


def _serve_leg(label: str, server, specs: list) -> tuple[list, dict, int, float]:
    """Submit every spec, drain, and return (responses in rid order, launch
    counts, LazyPIM windows walked, wall seconds); counts set to 0 just
    before."""
    import torch

    from repro_torch import kernels as KS

    torch.cuda.synchronize()
    KS.reset_launch_counts()
    with WindowTap() as tap:
        t0 = time.perf_counter()
        for spec in specs:
            out = server.submit(spec)
            check(isinstance(out, int), f"{label}: refused at admission: {out}")
        resps = server.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    check_window_launches(label, counts, tap.windows)
    return sorted(resps, key=lambda r: r.rid), counts, tap.windows, wall


def _storm_expected(monkey, rid: int, coalesce: bool) -> tuple[str, ...]:
    """The statuses ROADMAP's contract table allows request ``rid`` of the
    storm: admission classes reject on both legs; the one-at-a-time leg
    resolves the runtime classes (transient -> ok after a retry, persistent
    -> ok_degraded, hang -> timeout, crash -> ok after a restart); the
    coalesced leg the poison classes (poison_lane and NaN -> quarantined,
    finite -> served by the audit's degrade).  A class the leg's dispatch
    boundary does not inject is served like a fault-free request."""
    kind = monkey.fault_for(rid)
    if kind == "malformed_spec":
        return ("rejected_malformed",)
    if kind == "oversized":
        return ("rejected_oversized",)
    if not coalesce and kind == "engine_exception":
        return ("ok",) if monkey.is_transient(rid) else ("ok_degraded",)
    if not coalesce and kind == "hang":
        return ("timeout",)
    if coalesce and (kind == "poison_lane"
                     or (kind == "poison_result" and monkey.variant(rid, 2) == 0)):
        return ("quarantined",)
    return ("ok",) if not coalesce else ("ok", "ok_degraded")


def storm_phase(card: str) -> tuple[dict, dict]:
    """The reference's ``make_storm`` (seed 0, rate 0.3, every fault class)
    on the card, on a virtual clock, served twice: one request at a time
    (the runtime classes fire; a crash goes through ``restart_server``)
    and coalesced (the poison classes fire).  Every rid resolves as the
    contract table says, none is lost, and every served answer equals the
    fault-free run."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.serve import (ALL_FAULT_CLASSES, ChaosConfig, ChaosMonkey,
                                   ServeConfig, StudyServer, VirtualClock, build_study,
                                   make_storm, restart_server)

    phase(f"study service: chaos storm ({STORM_REQUESTS} requests, seed {STORM_SEED}, "
          f"rate {STORM_RATE}, every fault class)")
    want = [build_study(s).run("sequential").to_rows() for s in STORM_BASE_SPECS]
    chaos_cfg = ChaosConfig(seed=STORM_SEED, fault_rate=STORM_RATE,
                            classes=ALL_FAULT_CLASSES, hang_s=60.0)
    # the oracle: the restart exempts the rids it replays from the serving
    # monkey's draws, never from this one's
    oracle = ChaosMonkey(chaos_cfg)
    storm = make_storm(oracle, STORM_REQUESTS, STORM_BASE_SPECS)
    out, walls = {}, {}
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    with WindowTap() as tap, tempfile.TemporaryDirectory() as tmp:
        for coalesce in (False, True):
            leg = "coalesced" if coalesce else "one at a time"
            clock = VirtualClock()
            monkey = ChaosMonkey(chaos_cfg, clock=clock)
            cfg = ServeConfig(default_deadline_s=1e9, heartbeat_timeout_s=20.0,
                              backoff_base_s=0.01, max_queue=STORM_REQUESTS, max_lanes=64,
                              coalesce=coalesce, max_batch_lanes=STORM_BATCH_LANES,
                              cache_dir=str(pathlib.Path(tmp) / leg.replace(" ", "_")))
            server, final, restarts = StudyServer(cfg, clock=clock, chaos=monkey), {}, 0
            t0 = time.perf_counter()

            def collect(resps):
                for r in resps:
                    final[r.rid] = r

            # one at a time: submit, drain; coalesced: the whole storm queued
            for batch in ([[s] for s in storm] if not coalesce else [storm]):
                for spec in batch:
                    r = server.submit(spec)
                    if not isinstance(r, int):
                        collect([r])
                collect(server.drain())
                while server.crashed:
                    restarts += 1
                    check(restarts <= STORM_REQUESTS, f"storm/{leg}: restarts do not converge")
                    server, replayed = restart_server(cfg, clock=clock, chaos=monkey)
                    check(all(r.restarted for r in replayed), f"storm/{leg}: replay unmarked")
                    collect(replayed)
                    collect(server.drain())
            torch.cuda.synchronize()
            walls[leg] = time.perf_counter() - t0
            check(sorted(final) == list(range(STORM_REQUESTS)),
                  f"storm/{leg}: rids lost: {sorted(set(range(STORM_REQUESTS)) - set(final))}")
            by_class: dict[str, dict[str, int]] = {}
            for rid, r in final.items():
                kind = oracle.fault_for(rid)
                if kind == "engine_exception":
                    kind += ":transient" if oracle.is_transient(rid) else ":persistent"
                if kind == "poison_result":
                    kind += ":nan" if oracle.variant(rid, 2) == 0 else ":finite"
                allowed = _storm_expected(oracle, rid, coalesce)
                check(r.status in allowed,
                      f"storm/{leg}: rid {rid} ({kind}) {r.status}, want {allowed}: {r.error}")
                if kind == "crash" and not coalesce:
                    check(r.restarted, f"storm/{leg}: crashed rid {rid} not restarted")
                if r.status in ("ok", "ok_degraded"):
                    check(r.results.to_rows() == want[rid % len(want)],
                          f"storm/{leg}: rid {rid} ({kind}) differs from the fault-free run")
                cls = by_class.setdefault(kind or "none", {})
                cls[r.status] = cls.get(r.status, 0) + 1
            out[leg] = {"by_class": by_class, "restarts": restarts,
                        "quarantined": len(server.quarantine),
                        "virtual_s": clock.now(), "wall_s": walls[leg]}
            print(f"storm, {leg}: {STORM_REQUESTS} rids resolved in {walls[leg]:.2f} s wall "
                  f"({clock.now():.1f} virtual s) on {card}; {restarts} restarts; "
                  f"by fault class: {json.dumps(by_class, sort_keys=True)}", flush=True)
    counts = launch_counts()
    check_window_launches("storm", counts, tap.windows)
    for kind in ("malformed_spec", "oversized", "engine_exception:transient",
                 "engine_exception:persistent", "hang", "crash", "poison_lane",
                 "poison_result:nan", "poison_result:finite"):
        check(kind in out["coalesced"]["by_class"], f"storm: fault class {kind} never drawn")
    return out, counts


def warm_restart_phase(specs: list, card: str) -> dict:
    """``python -m repro_torch.launch.serve --study ... --cache-dir ...``
    twice, each a fresh process: the second warms from the first one's
    manifest and must then answer the repeat study with no nvcc build and
    no new library bind."""
    phase("study service: warm restart in a fresh process (twice)")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = pathlib.Path(tmp) / "specs.json"
        spec_path.write_text(json.dumps(specs))
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        for i in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve", "--study", str(spec_path),
                 "--cache-dir", str(pathlib.Path(tmp) / "cache"), "--coalesce"],
                cwd=ROOT, env=env, capture_output=True, text=True, timeout=SERVE_TIMEOUT_S)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"serve --study run {i + 1}: rc {proc.returncode}\n"
                  f"{proc.stderr[-2000:]}")
            summary = json.loads(proc.stdout.strip().splitlines()[-1])["serve_study"]
            check(summary["statuses"] == {"ok": len(specs)},
                  f"serve --study run {i + 1}: {summary['statuses']}")
            bb = summary["builds_binds"]
            after = {k: bb["at_end"][k] - bb["after_warm"][k] for k in ("builds", "binds")}
            print(f"serve --study run {i + 1} (fresh process, {wall:.2f} s wall): "
                  f"{summary['warmed_entries']} manifest entries replayed in "
                  f"{summary['warm_wall_s']:.3f} s; first request {summary['first_latency_s']:.3f} "
                  f"s; builds / binds at start {bb['at_start']}, after the warm replay "
                  f"{bb['after_warm']}, new after it {after}; on {card}", flush=True)
            runs.append({**summary, "process_wall_s": wall, "new_after_warm": after})
    check(runs[0]["warmed_entries"] == 0, "the first process found a manifest")
    check(runs[1]["warmed_entries"] > 0, "the second process warmed nothing")
    check(runs[1]["new_after_warm"] == {"builds": 0, "binds": 0},
          f"the warmed process built or bound after its warm replay: "
          f"{runs[1]['new_after_warm']}")
    return {"first": runs[0], "second": runs[1]}


def study_service_path(paper_points, card: str) -> tuple[dict, dict]:
    """The resident study service on the card (``repro_torch.serve``,
    ``device=None``): the Fig. 7 fleet as one request, held to the main
    path's direct run; a burst of 16 paper-scale requests served coalesced
    (adaptive) and one at a time, every answer held to its spec's direct
    ``Study.run()``; the chaos storm; the warm restart in fresh processes.
    Every LazyPIM window walked asks two ``bloom_query``, two
    ``bloom_insert`` and one ``bloom_intersect``.  Returns (summary, launch
    counts by leg)."""
    from repro_torch.api import MECHANISMS, all_workloads
    from repro_torch.serve import ServeConfig, StudyServer, build_study

    counts, summary = {}, {}
    phase("study service: the Fig. 7 fleet as one request")
    fig7 = {"workloads": [list(w) for w in all_workloads()], "mechanisms": list(MECHANISMS)}
    server = StudyServer(ServeConfig(coalesce=True))
    (resp,), counts["serve_fig7"], windows, wall = _serve_leg("served Fig. 7", server, [fig7])
    check(resp.status == "ok" and resp.engine == "batch",
          f"served Fig. 7: {resp.status} on {resp.engine} ({resp.error})")
    exact_points(resp.results.points, paper_points, "served Fig. 7 vs the main path")
    print(f"Fig. 7 request: ok on the batch engine (3 buckets: not coalescible) in "
          f"{wall:.2f} s wall on {card}; {windows} LazyPIM windows; every field of 12 x 6 "
          f"results equals the main path's; launches {counts['serve_fig7']}", flush=True)
    summary["fig7_wall_s"] = wall

    phase(f"study service: a burst of {SERVE_BURST} paper-scale requests")
    paper = all_workloads()
    burst = [{"workloads": [list(paper[i % len(paper)])], "mechanisms": list(MECHANISMS),
              "threads": 16, "hw_grid": SERVE_BURST_HW} for i in range(SERVE_BURST)]
    legs = {}
    for name, cfg in (("coalesced", ServeConfig(coalesce=True, adaptive=True)),
                      ("one_at_a_time", ServeConfig())):
        server = StudyServer(cfg)
        resps, counts[f"serve_burst_{name}"], windows, wall = _serve_leg(
            f"burst/{name}", server, burst)
        check([r.status for r in resps] == ["ok"] * SERVE_BURST,
              f"burst/{name}: {[(r.rid, r.status, r.error) for r in resps]}")
        lat = server.telemetry.latency_percentiles()["ok"]
        legs[name] = dict(resps=resps, wall_s=wall, studies_per_s=SERVE_BURST / wall,
                          p50_s=lat["p50_s"], p99_s=lat["p99_s"], windows=windows,
                          engines=sorted({r.engine for r in resps}),
                          dispatch_widths=list(server.telemetry.dispatch_widths),
                          coalesced_dispatches=server.stats["coalesced_dispatches"],
                          audit_lanes=server.stats["audit_lanes"],
                          launches={k: counts[f"serve_burst_{name}"][k] for k in FIG7_KERNELS})
    check(legs["coalesced"]["engines"] == ["coalesced"], f"burst: {legs['coalesced']['engines']}")
    check(legs["one_at_a_time"]["engines"] == ["batch"], f"burst: {legs['one_at_a_time']['engines']}")
    t0 = time.perf_counter()
    direct = {}
    for i, spec in enumerate(burst[:len(paper)]):
        direct[i] = build_study(spec).run()
    direct_wall = time.perf_counter() - t0
    for name, leg in legs.items():
        for r in leg.pop("resps"):
            exact_points(r.results.points, direct[r.rid % len(paper)].points,
                         f"burst/{name}/rid {r.rid} vs its spec's direct run")
        print(f"burst, {name}: {SERVE_BURST} studies in {leg['wall_s']:.2f} s wall "
              f"({leg['studies_per_s']:.3f} studies/s), latency p50 {leg['p50_s']:.3f} s, "
              f"p99 {leg['p99_s']:.3f} s; {leg['coalesced_dispatches']} coalesced dispatches "
              f"of widths {leg['dispatch_widths']}, {leg['audit_lanes']} audited lanes; "
              f"{leg['windows']} LazyPIM windows; Bloom launches {leg['launches']}; on {card}",
              flush=True)
    print(f"every answer of both legs equals its spec's direct Study.run() on every field "
          f"({len(direct)} direct runs, {direct_wall:.2f} s on {card})", flush=True)
    summary["burst"] = legs
    summary["burst_direct_wall_s"] = direct_wall
    summary["storm"], counts["serve_storm"] = storm_phase(card)
    summary["warm_restart"] = warm_restart_phase(burst[:2], card)
    return summary, counts


C3_SPEC_BITS = (4096, 2048)  # the M = 64 Study's specs
C3_LANES = 70_000            # past gridDim.y's 65,535


def signature_caps_phase(K, K8) -> dict:
    """§C3b on the card: the M = 64 Study of tests/test_torch_signature_caps.py
    on both engines against its CPU run (exact, counted a LazyPIM window);
    every parity-form kernel at a spec of 640 column masks (two passes) and
    every bitmap kernel at 70,000 lanes of a small bitmap, one launch, each
    against its plain version, exact."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import SignatureSpec, Study, workload
    from repro_torch.core.signatures import default_spec, pack_words, unpack_words

    counts = {}
    for sig_bits in C3_SPEC_BITS:
        spec = SignatureSpec(sig_bits=sig_bits, num_segments=64)
        phase(f"signature caps: Study at {spec}")
        wl = [workload("htap128"), workload("pagerank", "arxiv")]
        t0 = time.perf_counter()
        cpu = Study(wl, spec=spec, device="cpu").run(engine="sequential")
        cpu_wall = time.perf_counter() - t0
        for engine in ("batch", "sequential"):
            torch.cuda.synchronize()
            KS.reset_launch_counts()
            study = Study(wl, spec=spec)
            t0 = time.perf_counter()
            rs = study.run(engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = launch_counts()
            label = f"M=64 {sig_bits}/{engine}"
            for name in FIG7_KERNELS:
                check(c[name] > 0, f"{label}: {name} never launched")
            check_query_launches(label, study, rs, engine, c)
            check_insert_launches(label, study, rs, engine, c)
            check_intersect_launches(label, study, rs, engine, c)
            exact_points(rs.points, cpu.points, f"{label} vs CPU")
            counts[f"{sig_bits}_{engine}"] = c
            print(f"{label}: 2 workloads x 6 mechanisms in {wall:.2f} s (CPU {cpu_wall:.2f} "
                  f"s), equal to the CPU run on every field; launches {c}", flush=True)

    phase("signature caps: a spec of 640 column masks (two passes)")
    g = torch.Generator(device="cuda").manual_seed(21)
    spec = SignatureSpec(sig_bits=4096, num_segments=128)
    passes = len(K._passes(spec)[0])
    check(passes == 2, f"{spec}: {passes} passes, want 2")

    def words(shape, density):
        return pack_words(torch.rand((*shape[:-1], shape[-1] * 32), generator=g,
                                     device="cuda") < density)

    def held(name, got, want, launched, want_launches):
        got, want = (got if isinstance(got, tuple) else (got,)), \
            (want if isinstance(want, tuple) else (want,))
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{name}: kernel != plain")
        check(launched == want_launches, f"{name}: {launched} launches, want {want_launches}")
        print(f"{name}: equal to the plain version, {launched} launch(es)", flush=True)

    ids = torch.randint(-2**31, 2**31 - 1, (3, 256), generator=g, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand((3, 256), generator=g, device="cuda") < 0.8
    bitmap = words((3, 205), 0.01)
    sig = words((3, spec.num_words), 1 - 0.5 / spec.num_segments)
    bits = unpack_words(sig, spec.sig_bits).contiguous()

    def run(name, fn, plain, kernel, mod=K):
        mod.reset_launch_counts()
        got = fn()
        launched = mod.launch_counts()[kernel]
        held(name, got, plain(), launched, passes)

    run("bloom_insert ids pair", lambda: K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids,
                                                        valid_b=valid),
        lambda: K.bloom_insert_plain(spec, ids=ids, valid=valid, ids_b=ids, valid_b=valid),
        "bloom_insert")
    run("bloom_insert bank pair", lambda: K.bloom_insert(spec, bitmap=bitmap, bitmap_b=bitmap,
                                                         num_lines=6550, num_regs=16),
        lambda: K.bloom_insert_plain(spec, bitmap=bitmap, bitmap_b=bitmap, num_lines=6550,
                                     num_regs=16), "bloom_insert")
    run("bloom_query pair", lambda: K.bloom_query(spec, sig, bitmap, 6550, words_b=bitmap),
        lambda: K.bloom_query_plain(spec, sig, bitmap, 6550, bitmap), "bloom_query")
    run("bloom_insert_onehot pair", lambda: K8.bloom_insert_onehot(spec, sig, ids, valid,
                                                                   addrs_b=ids),
        lambda: K8.bloom_insert_onehot_plain(spec, sig, ids, valid, addrs_b=ids),
        "bloom_insert_onehot", K8)
    run("bloom_query_onehot", lambda: K8.bloom_query_onehot(spec, bits, ids),
        lambda: K8.bloom_query_onehot_plain(spec, bits, ids), "bloom_query_onehot", K8)
    # registers that meet all 128 segments of their lane's image about half
    # the time, so the runs of 32 segments past the first decide
    a = words((48, spec.num_words), 0.15)
    for name, fn, plain in (
            ("bloom_intersect rows (128 segments)", lambda: K.bloom_intersect(a, sig, 128),
             lambda: K.bloom_intersect_plain(a, sig, 128)),
            ("bloom_intersect pair (128 segments)",
             lambda: K.bloom_intersect(a, sig, 128, a_b=a.flip(0)),
             lambda: K.bloom_intersect_plain(a, sig, 128, a.flip(0))),
            ("h3_hash (128 segments)", lambda: K.h3_hash(spec, ids[0]),
             lambda: K.h3_hash_plain(spec, ids[0]))):
        K.reset_launch_counts()
        got = fn()
        held(name, got, plain(), sum(K.launch_counts().values()), 1)
    rows = K.bloom_intersect_plain(a, sig, 128)
    check(0 < int(rows.sum()) < rows.numel(), f"intersect rows all {bool(rows[0])}")

    phase(f"signature caps: {C3_LANES:,} lanes, one launch a kernel")
    spec, lanes = default_spec(), C3_LANES
    ids = torch.randint(-2**31, 2**31 - 1, (lanes, 8), generator=g, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand((lanes, 8), generator=g, device="cuda") < 0.7
    bitmap = words((lanes, 2), 0.3)
    sig = words((lanes, spec.num_words), 0.8)
    bits = unpack_words(sig, spec.sig_bits).contiguous()
    passes = 1
    run("bloom_insert ids, 70,000 lanes", lambda: K.bloom_insert(spec, ids=ids, valid=valid),
        lambda: K.bloom_insert_plain(spec, ids=ids, valid=valid), "bloom_insert")
    run("bloom_insert bank pair (4 registers), 70,000 lanes",
        lambda: K.bloom_insert(spec, bitmap=bitmap, bitmap_b=bitmap.flip(0), num_lines=60,
                               num_regs=4),
        lambda: K.bloom_insert_plain(spec, bitmap=bitmap, bitmap_b=bitmap.flip(0),
                                     num_lines=60, num_regs=4), "bloom_insert")
    run("bloom_query pair, 70,000 lanes",
        lambda: K.bloom_query(spec, sig, bitmap, 60, words_b=bitmap.flip(0)),
        lambda: K.bloom_query_plain(spec, sig, bitmap, 60, bitmap.flip(0)), "bloom_query")
    run("bloom_insert_onehot, 70,000 lanes",
        lambda: K8.bloom_insert_onehot(spec, None, ids, valid),
        lambda: K8.bloom_insert_onehot_plain(spec, None, ids, valid),
        "bloom_insert_onehot", K8)
    run("bloom_query_onehot, 70,000 lanes", lambda: K8.bloom_query_onehot(spec, bits, ids),
        lambda: K8.bloom_query_onehot_plain(spec, bits, ids), "bloom_query_onehot", K8)
    K.reset_launch_counts()
    K8.reset_launch_counts()
    return counts


def _kernels_by_name(prof, top: int | None) -> tuple[float, int, list]:
    """(device s, kernels, the ``top`` kernels by name largest first) of a
    profile; the device's spans of ``record_function`` ranges are no
    kernels and are left out."""
    from torch.autograd import DeviceType

    by_name = sorted(((e.self_device_time_total / 1e6, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)), reverse=True)
    return sum(t for t, _, _ in by_name), sum(c for _, c, _ in by_name), by_name[:top]


def device_busy_s(fn, top: int | None = 8) -> tuple[float, int, list]:
    """Device time of all kernels ``fn()`` runs (``torch.profiler``), their
    number, and the ``top`` by name (all of them for None), largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _kernels_by_name(prof, top)


def device_busy_by_range_s(fn, ranges: tuple, top: int | None = 8) -> tuple:
    """:func:`device_busy_s` with host ops recorded too, and a fourth item:
    for each name in ``ranges``, the device time of the kernels launched
    under the ``record_function`` ranges of that name (the outermost of
    them only), in s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_range = dict.fromkeys(ranges, 0.0)
    stack = [(e, False) for e in prof.events()
             if e.device_type == DeviceType.CPU and e.cpu_parent is None]
    while stack:
        e, inside = stack.pop()
        if e.name in by_range and not inside:
            by_range[e.name] += e.device_time_total / 1e6
            inside = True
        stack.extend((c, inside) for c in e.cpu_children)
    return (*_kernels_by_name(prof, top), by_range)


def time_and_profile(fn) -> tuple[float, int, float, int, list, float]:
    """``fn()`` once unprofiled (wall, peak memory) and once under the
    profiler: (wall s, peak bytes, device busy s, kernels, every kernel by
    name largest first, B7's device s); prints the top 8."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    busy, n_kernels, by_name = device_busy_s(fn, top=None)
    for t, c, name in by_name[:8]:
        print(f"  {t:9.4f} s {c:5d}x  {name[:100]}")
    b7_s = sum(t for t, _, name in by_name if "flash_attention" in name)
    return wall, peak, busy, n_kernels, by_name, b7_s


def main_path_profile() -> dict:
    """Device time of one profiled batch run of ``FIG7_PROFILE_WORKLOADS``
    (two of the fleet's 12, all six mechanisms), by kernel, against the
    wall time of an unprofiled batch run of the same study just before it:
    the device's busy and idle shares."""
    import torch

    from repro_torch.api import Study

    phase(f"Fig. 7 path profile, engine=batch ({', '.join(FIG7_PROFILE_WORKLOADS)})")
    t0 = time.perf_counter()
    Study(list(FIG7_PROFILE_WORKLOADS)).run(engine="batch")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    busy_s, launches, top = device_busy_s(
        lambda: Study(list(FIG7_PROFILE_WORKLOADS)).run(engine="batch"))
    summary = dict(workloads=list(FIG7_PROFILE_WORKLOADS), device_busy_s=busy_s,
                   batch_wall_s=wall_s, idle_share=1.0 - busy_s / wall_s,
                   launches=launches,
                   top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in top])
    for t, c, k in top:
        print(f"  {t:9.4f} s {c:7d}x  {k[:100]}")
    print(f"device busy {busy_s:.3f} s of {wall_s:.3f} s batch wall "
          f"(idle share {summary['idle_share']:.3f})", flush=True)
    return summary


class OnehotTap:
    """While active, records every ``bloom_insert_onehot`` and
    ``bloom_query_onehot`` call the seed primitives make — inputs and
    result — by wrapping the two names :mod:`repro_torch.sim.prep` calls;
    the wrapped calls launch exactly what they would have.  :meth:`check`
    then holds each result against the kernel's plain version on the same
    inputs (those calls launch nothing, so nothing is counted)."""

    def __init__(self):
        self.inserts, self.queries = [], []

    def __enter__(self):
        import repro_torch.sim.prep as P

        self._mod = P
        self._orig = (P.bloom_insert_onehot, P.bloom_query_onehot)
        insert, query = self._orig

        def tapped_insert(spec, sig, addrs, mask=None, **pair):
            out = insert(spec, sig, addrs, mask, **pair)
            self.inserts.append((spec, sig, addrs, mask, pair, out))
            return out

        def tapped_query(spec, bits, addrs):
            out = query(spec, bits, addrs)
            self.queries.append((spec, bits, addrs, out))
            return out

        P.bloom_insert_onehot, P.bloom_query_onehot = tapped_insert, tapped_query
        return self

    def __exit__(self, *exc):
        self._mod.bloom_insert_onehot, self._mod.bloom_query_onehot = self._orig
        return False

    def check(self, label: str) -> int:
        """Hold every recorded call to its plain version (exact); returns
        the largest |diff| seen (0)."""
        import torch

        from repro_torch.kernels.bloom import onehot as K8

        err = 0
        for spec, sig, addrs, mask, pair, out in self.inserts:
            want = K8.bloom_insert_onehot_plain(spec, sig, addrs, mask, **pair)
            for got, ref in zip(out, want) if pair else ((out, want),):
                err = max(err, int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()))
        for spec, bits, addrs, out in self.queries:
            want = K8.bloom_query_onehot_plain(spec, bits, addrs)
            err = max(err, int((out != want).sum()))
        check(err == 0, f"{label}: a seed one-hot kernel call disagrees with its "
                        f"plain version (max |diff| {err})")
        return err


def seed_path(sequential) -> tuple[dict, dict, OnehotTap]:
    """The seed reference engine (``run_all_bool``) over the Fig. 7 fleet on
    the card, one trace at a time, tapped: every B8 call is held to its
    plain version, every SimResult field to the packed sequential engine's
    (exact), the goldens at their tolerances; then the full-commit and
    no-DBI ablations on two workloads against the packed engine, and a
    profiled run for the idle share.  Returns (launch counts, summary, the
    tap)."""
    import types

    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import HWParams, LazyPIMConfig, all_workloads, run_all
    from repro_torch.core._boolref import run_all_bool, simulate_lazypim_bool
    from repro_torch.sim.prep import prepare
    from repro_torch.sim.trace import make_trace

    phase("seed path (run_all_bool), Fig. 7 fleet")
    dev = torch.device("cuda", 0)
    golden = json.loads((GOLDEN_DIR / "fig7_golden.json").read_text())
    t0 = time.perf_counter()
    traces = [prepare(make_trace(a, g, device=dev), device=dev)
              for a, g in all_workloads()]
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    packed = {p.workload: p for p in sequential}
    check(sorted(packed) == sorted(tt.name for tt in traces),
          f"seed fleet {[tt.name for tt in traces]} vs {sorted(packed)}")
    tap = OnehotTap()
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    walls = {}
    with tap:
        results = []
        for tt in traces:
            t1 = time.perf_counter()
            results.append(run_all_bool(tt))
            torch.cuda.synchronize()
            walls[tt.name] = time.perf_counter() - t1
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        ablations = {(tt.name, label): simulate_lazypim_bool(tt, HWParams(), cfg)
                     for tt in traces if tt.name in SEED_ABLATION_WORKLOADS
                     for label, cfg in (("full_commit", LazyPIMConfig(partial_commits=False)),
                                        ("no_dbi", LazyPIMConfig(use_dbi=False)))}
        torch.cuda.synchronize()
        ablation_wall = time.perf_counter() - t1
    counts = launch_counts()
    print(f"seed: {len(results)} workloads x 6 mechanisms in {wall:.2f} s wall "
          f"(traces staged beforehand in {prep_s:.2f} s), {len(ablations)} "
          f"ablation runs in {ablation_wall:.2f} s; launches {counts}", flush=True)
    for name in SEED_KERNELS:
        check(counts[name] > 0, f"seed: kernel {name} was never launched")
    # one LazyPIM run a trace in run_all_bool, two an ablation workload
    windows = sum(tt.num_windows * (1 + 2 * (tt.name in SEED_ABLATION_WORKLOADS))
                  for tt in traces)
    check(counts["bloom_insert_onehot"] == windows,
          f"seed: {counts['bloom_insert_onehot']} bloom_insert_onehot launches, want "
          f"{windows} (one a LazyPIM window)")
    n_fields = 0
    for tt, res in zip(traces, results):
        want = packed[tt.name].results
        check(set(res) == set(want), f"seed/{tt.name}: mechanisms {sorted(res)}")
        for m, r in res.items():
            da, db = dataclasses.asdict(r), dataclasses.asdict(want[m])
            diff = {k: (da[k], db[k]) for k in da if da[k] != db[k]}
            check(not diff, f"seed/{tt.name}/{m}: seed != packed {diff}")
            n_fields += len(da)
    for (name, label), r in ablations.items():
        tt = next(t for t in traces if t.name == name)
        cfg = (LazyPIMConfig(partial_commits=False) if label == "full_commit"
               else LazyPIMConfig(use_dbi=False))
        want = run_all(tt, HWParams(), ("lazypim",), cfg)["lazypim"]
        check(dataclasses.asdict(r) == dataclasses.asdict(want),
              f"seed/{name}/lazypim {label}: seed != packed")
    worst = check_golden([types.SimpleNamespace(workload=tt.name, results=res,
                                                hw=packed[tt.name].hw)
                          for tt, res in zip(traces, results)], golden, "seed")
    err = tap.check("seed")
    print(f"seed: equals the packed sequential engine on all {n_fields} fields of "
          f"{len(results)} x 6 results and on the {len(ablations)} ablation runs "
          f"({', '.join(SEED_ABLATION_WORKLOADS)}: partial_commits=False, "
          f"use_dbi=False); goldens {GOLDEN_WORKLOADS} hold (worst rel gap "
          f"{worst:.3g}); bloom_insert_onehot launched once a LazyPIM window "
          f"({windows} windows); {len(tap.inserts)} bloom_insert_onehot and "
          f"{len(tap.queries)} bloom_query_onehot calls equal their plain "
          f"versions", flush=True)

    phase(f"seed path profile ({', '.join(SEED_PROFILE_WORKLOADS)})")
    profiled = [tt for tt in traces if tt.name in SEED_PROFILE_WORKLOADS]
    profiled_wall = sum(walls[tt.name] for tt in profiled)
    busy_s, launches, top = device_busy_s(lambda: [run_all_bool(tt) for tt in profiled])
    for t, c, k in top:
        print(f"  {t:9.4f} s {c:7d}x  {k[:100]}")
    idle = 1.0 - busy_s / profiled_wall
    print(f"device busy {busy_s:.3f} s of their {profiled_wall:.3f} s seed wall (idle "
          f"share {idle:.3f}); {launches} kernels", flush=True)
    summary = dict(wall_s=wall, wall_s_by_workload=walls, prepare_s=prep_s,
                   ablation_wall_s=ablation_wall,
                   ablations=[f"{n}/{lab}" for n, lab in ablations],
                   profiled=list(SEED_PROFILE_WORKLOADS), profiled_wall_s=profiled_wall,
                   device_busy_s=busy_s, idle_share=idle, kernels=launches,
                   golden_worst_rel_gap=worst, tapped_inserts=len(tap.inserts),
                   tapped_queries=len(tap.queries), max_abs_err=err,
                   top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in top])
    return counts, summary, tap


def onehot_kernel_phases(tap: OnehotTap, floor_ms: float) -> dict[str, dict]:
    """B8 timed at the seed path's shapes, on inputs it gave the kernels:
    the insert call with the most valid slots in its first list (alone, and
    as the window's pair of lists) and the query over the most lines.
    Bound: bytes over 3.35 TB/s or the parity hash's operations over 67
    Top/s, the larger: ``log2 seg_bits`` columns of ``PARITY_OPS`` for
    every segment of a valid address for the insert, for each segment up
    to an address's first clear bit (where the kernel stops) for the query,
    with the query's xor-fold bound of earlier runs printed beside it."""
    import torch

    from repro_torch.core.signatures import hash_positions_xorfold
    from repro_torch.kernels.bloom import onehot as K8

    out = {}
    phase("kernel bloom_insert_onehot")
    spec, _, addrs, mask, pair, _ = max(tap.inserts, key=lambda r: int(r[3].sum()))
    addrs_b, mask_b = pair["addrs_b"], pair["mask_b"]

    def max_err(got, want):
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    err = max_err(K8.bloom_insert_onehot(spec, None, addrs, mask),
                  K8.bloom_insert_onehot_plain(spec, None, addrs, mask))
    check(err == 0, "bloom_insert_onehot: kernel disagrees with plain version")
    got = K8.bloom_insert_onehot(spec, None, addrs, mask, addrs_b=addrs_b, mask_b=mask_b)
    want = K8.bloom_insert_onehot_plain(spec, None, addrs, mask, addrs_b=addrs_b,
                                        mask_b=mask_b)
    err_pair = max(max_err(g, w) for g, w in zip(got, want))
    check(err_pair == 0, "bloom_insert_onehot pair: kernel disagrees with plain version")
    lanes, n = addrs.shape
    n_valid, n_valid_b = int(mask.sum()), int(mask_b.sum())
    m, nw = spec.num_segments, spec.num_words
    hash_ops = m * (spec.seg_bits.bit_length() - 1) * PARITY_OPS
    previous = PREVIOUS_MS["bloom_insert_onehot"]
    st = measure(f"bloom_insert_onehot (L={lanes}, N={n}, {n_valid} valid, "
                 f"{spec.sig_bits} bits, M={m})", err,
                 lambda a, k: K8.bloom_insert_onehot(spec, None, a, k),
                 lambda a, k: K8.bloom_insert_onehot_plain(spec, None, a, k),
                 (addrs, mask), nbytes=lanes * n * 5 + lanes * nw * 4,
                 ops=n_valid * hash_ops)
    pair_st = measure(f"bloom_insert_onehot pair (L={lanes}, N={n} twice, {n_valid} and "
                      f"{n_valid_b} valid)", err_pair,
                      lambda a, k, b, j: K8.bloom_insert_onehot(spec, None, a, k, addrs_b=b,
                                                                mask_b=j),
                      lambda a, k, b, j: K8.bloom_insert_onehot_plain(
                          spec, None, a, k, addrs_b=b, mask_b=j),
                      (addrs, mask, addrs_b, mask_b),
                      nbytes=lanes * (n + addrs_b.shape[1]) * 5 + 2 * lanes * nw * 4,
                      ops=(n_valid + n_valid_b) * hash_ops)
    print(f"bloom_insert_onehot: launch floor {floor_ms:.5f} ms ({st['ms'] / floor_ms:.2f}x "
          f"it, the pair {pair_st['ms'] / floor_ms:.2f}x); previous design's reading "
          f"{previous:.5f} ms a single call ({PREVIOUS_CARD})", flush=True)
    out["bloom_insert_onehot"] = dict(st, pair=pair_st,
                                      shape=dict(L=lanes, N=n, valid=n_valid,
                                                 pair_valid=n_valid_b,
                                                 sig_bits=spec.sig_bits, M=m))

    phase("kernel bloom_query_onehot")
    spec, bits, addrs, _ = max(tap.queries, key=lambda r: r[2].shape[1])
    got = K8.bloom_query_onehot(spec, bits, addrs)
    want = K8.bloom_query_onehot_plain(spec, bits, addrs)
    err = int((got != want).sum())
    check(err == 0, "bloom_query_onehot: kernel disagrees with plain version")
    lanes, n = addrs.shape
    m, ab = spec.num_segments, spec.addr_bits
    pos = hash_positions_xorfold(spec, addrs.reshape(-1)).to(torch.int64)
    looked = bits.gather(1, pos.reshape(lanes, -1)).reshape(lanes, n, m)
    hashed = int((looked.to(torch.int64).cumprod(-1).sum(-1) + 1).clamp(max=m).sum())
    log_seg = spec.seg_bits.bit_length() - 1
    old_bound, old_by = bound_ms(n * 4 + lanes * spec.sig_bits + n + m * ab * 4,
                                 hashed * ab * XORFOLD_OPS)
    st = measure(f"bloom_query_onehot (L={lanes}, N={n}, {spec.sig_bits} bits, M={m}, "
                 f"{int(want.sum())} members, {hashed} segments hashed)", err,
                 lambda b, a: K8.bloom_query_onehot(spec, b, a),
                 lambda b, a: K8.bloom_query_onehot_plain(spec, b, a), (bits, addrs),
                 nbytes=lanes * n * 5 + lanes * spec.sig_bits,
                 ops=hashed * log_seg * PARITY_OPS)
    print(f"bloom_query_onehot: old bound {old_bound:.7f} ms ({old_by}, the "
          f"xor-fold's rounds)", flush=True)
    out["bloom_query_onehot"] = dict(st, old_bound_ms=old_bound,
                                     shape=dict(L=lanes, N=n, sig_bits=spec.sig_bits,
                                                M=m, segments_hashed=hashed))
    return out


def signatures_phase(K, card: str) -> dict:
    """``benchmarks/bench_signatures.py`` on the card: the byte-sliced hash
    (B1) against the seed xor-fold at batch 4,096; the seed one-hot insert
    and query (B8) against the word-level kernels (B2, B3) at batch 1,024;
    the fused conflict detector (B5) against the two-pass PyTorch path
    (hash, unpack, gather, sum) at G = 4, 256 ids a group, 1,024 probes.
    Every pair must agree bit for bit.  Prints one ``{"signatures": ...}``
    line and writes no file."""
    import numpy as np
    import torch

    from repro_torch.core import signatures as S
    from repro_torch.kernels.bloom import onehot as K8

    phase("signatures (bench_signatures on the card)")
    dev = torch.device("cuda", 0)
    spec = S.default_spec()
    nw, iters = spec.num_words, 200

    def ms(fn, *args, n=iters):
        return event_ms(fn, rotations(args, n), n)

    def pair(label, a_name, a_ms, b_name, b_ms, **extra):
        row = {a_name: a_ms, b_name: b_ms, "speedup": a_ms / b_ms, "exact": True, **extra}
        print(f"{label}: {a_name} {a_ms:.5f} ms, {b_name} {b_ms:.5f} ms "
              f"({row['speedup']:.2f}x), bit-exact", flush=True)
        return row

    def u32(rng, n, high=2**32):
        return torch.from_numpy(rng.integers(0, high, size=(n,), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)

    out = {"card": card, "spec": dict(sig_bits=spec.sig_bits, num_segments=spec.num_segments,
                                      addr_bits=spec.addr_bits)}
    addrs = u32(np.random.default_rng(0), SIG_HASH_BATCH)
    got = K.h3_hash(spec, addrs)
    check(torch.equal(got, S.hash_positions_xorfold(spec, addrs)),
          "signatures: byte-sliced H3 != xor-fold")
    out["hash_positions"] = pair(
        f"hash_positions (batch {SIG_HASH_BATCH})", "xorfold_ms",
        ms(lambda a: S.hash_positions_xorfold(spec, a), addrs, n=20),
        "bytesliced_ms", ms(lambda a: K.h3_hash(spec, a), addrs), batch=SIG_HASH_BATCH)

    # Line ids, so the word-level query (B3, over a line bitmap) can take
    # the same probes: half of them inserted, half fresh.
    rng = np.random.default_rng(1)
    ids = u32(rng, SIG_KERNEL_BATCH, SIG_LINES)[None]
    valid = torch.ones_like(ids, dtype=torch.bool)
    sig0 = torch.zeros((1, nw), dtype=torch.int32, device=dev)
    onehot_sig = K8.bloom_insert_onehot(spec, sig0, ids, valid)
    word_sig = K.bloom_insert(spec, ids=ids, valid=valid)[:, 0]
    check(torch.equal(onehot_sig, word_sig) and torch.equal(
        onehot_sig, K8.bloom_insert_onehot_plain(spec, sig0, ids, valid)),
        "signatures: one-hot insert != word-level insert / plain")
    out["insert"] = pair(
        f"insert (batch {SIG_KERNEL_BATCH})", "onehot_ms",
        ms(lambda s, a, v: K8.bloom_insert_onehot(spec, s, a, v), sig0, ids, valid),
        "word_ms", ms(lambda a, v: K.bloom_insert(spec, ids=a, valid=v), ids, valid),
        batch=SIG_KERNEL_BATCH, ids_below=SIG_LINES)

    probes = torch.cat([ids[0, :SIG_KERNEL_BATCH // 2],
                        u32(rng, SIG_KERNEL_BATCH // 2, SIG_LINES)])[None]
    bits = S.unpack_words(onehot_sig, spec.sig_bits)
    member = K8.bloom_query_onehot(spec, bits, probes)
    line_bm = torch.zeros((1, SIG_LINES), dtype=torch.bool, device=dev)
    line_bm[0, probes[0].to(torch.int64)] = True
    words = S.pack_words(line_bm)
    word_member = S.unpack_words(K.bloom_query(spec, word_sig, words, SIG_LINES),
                                 SIG_LINES)[0, probes[0].to(torch.int64)]
    check(torch.equal(member[0], word_member) and torch.equal(
        member, K8.bloom_query_onehot_plain(spec, bits, probes)),
        "signatures: one-hot query != word-level query / plain")
    n_member = int(member.sum())
    check(0 < n_member < SIG_KERNEL_BATCH, f"signatures: {n_member} members")
    out["query"] = pair(
        f"query (batch {SIG_KERNEL_BATCH}, {n_member} members)", "onehot_ms",
        ms(lambda b, a: K8.bloom_query_onehot(spec, b, a), bits, probes),
        "word_ms", ms(lambda s, w: K.bloom_query(spec, s, w, SIG_LINES), word_sig, words),
        batch=SIG_KERNEL_BATCH, members=n_member, word_bitmap_lines=SIG_LINES)

    rng = np.random.default_rng(2)
    group_ids = [u32(rng, SIG_IDS_PER_GROUP, 50_000) for _ in range(SIG_GROUPS)]
    sigs = torch.stack([S.insert(spec, S.empty_signature(spec, dev), a)
                        for a in group_ids]).contiguous()
    probes = u32(rng, SIG_KERNEL_BATCH, 50_000)

    def two_pass(sg, a):
        pos = S.hash_positions(spec, a).to(torch.int64)
        return S.unpack_bits(spec, sg)[:, pos].all(-1).sum(0, dtype=torch.int32)

    fused = K.bloom_detect_conflicts(spec, sigs, probes)
    check(torch.equal(fused, two_pass(sigs, probes)),
          "signatures: fused conflict detector != two-pass path")
    out["conflict"] = pair(
        f"conflict (G={SIG_GROUPS}, {SIG_IDS_PER_GROUP} ids a group, "
        f"{SIG_KERNEL_BATCH} probes)", "two_pass_ms", ms(two_pass, sigs, probes),
        "fused_ms", ms(lambda sg, a: K.bloom_detect_conflicts(spec, sg, a), sigs, probes),
        batch=SIG_KERNEL_BATCH, num_groups=SIG_GROUPS,
        hit_counts=torch.bincount(fused.to(torch.int64),
                                  minlength=SIG_GROUPS + 1).tolist())
    print(json.dumps({"signatures": out}), flush=True)
    return out


class KernelTap:
    """While active, records every ``bloom_detect_conflicts`` and
    ``lazy_merge`` call the LazySync module makes — inputs and result —
    by wrapping the two names it calls; the wrapped calls launch exactly
    what they would have, and the tap itself launches nothing.
    :meth:`check` then holds each recorded result against the kernel's
    plain version on the same inputs (those launches are not counted)."""

    def __init__(self):
        self.b5, self.b6 = [], []

    def __enter__(self):
        import repro_torch.core.lazy_sync as LS

        self._mod = LS
        self._orig = (LS.bloom_detect_conflicts, LS.lazy_merge)
        detect, merge = self._orig

        def tapped_detect(spec, sigs, addrs):
            out = detect(spec, sigs, addrs)
            self.b5.append((spec, sigs, addrs, out))
            return out

        def tapped_merge(rows, base, valid):
            out = merge(rows, base, valid)
            self.b6.append((rows, base, valid, out))
            return out

        LS.bloom_detect_conflicts, LS.lazy_merge = tapped_detect, tapped_merge
        return self

    def __exit__(self, *exc):
        self._mod.bloom_detect_conflicts, self._mod.lazy_merge = self._orig
        return False

    def clear(self) -> None:
        self.b5.clear()
        self.b6.clear()

    def check(self, label: str) -> tuple[int, float]:
        """(max |diff| of the B5 counts, max relative diff of the B6 merges)
        over every recorded call; fails past exact / ``MERGE_RTOL``."""
        import torch

        from repro_torch.core.signatures import to_addr_i32
        from repro_torch.kernels.bloom import bloom as K

        LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
        err5, err6 = 0, 0.0
        for spec, sigs, addrs, out in self.b5:
            want = K.bloom_detect_conflicts_plain(spec, sigs.contiguous(), to_addr_i32(addrs))
            err5 = max(err5, int((out.to(torch.int64) - want).abs().max())
                       if out.numel() else 0)
        for rows, base, valid, out in self.b6:
            want = LM.lazy_merge_plain(rows, base, valid)
            err6 = max(err6, merge_rel_err(out, want))
        check(err5 == 0, f"{label}: bloom_detect_conflicts disagrees with its "
                         f"plain version (max |diff| {err5})")
        check(err6 <= MERGE_RTOL, f"{label}: lazy_merge disagrees with its plain "
                                  f"version (max rel diff {err6:.3g})")
        return err5, err6


def merge_rel_err(got, want) -> float:
    if not got.numel():
        return 0.0
    diff = (got - want).abs()
    return float((diff / want.abs().clamp_min(1e-30)).max())


def compare_results(a, b, label: str) -> float:
    """Hold one ResultSet's SimResults to another's: event counts exact,
    raw accumulators 1e-4 relative, the summary ratios 1e-6; returns the
    worst relative gap seen."""
    from repro_torch.api import summarize

    worst = 0.0
    check([p.workload for p in a] == [p.workload for p in b],
          f"{label}: workloads differ")
    for pa, pb in zip(a.points, b.points):
        check(set(pa.results) == set(pb.results), f"{label}: mechanisms differ")
        for m in pa.results:
            da, db = dataclasses.asdict(pa.results[m]), dataclasses.asdict(pb.results[m])
            for k, want in db.items():
                have = da[k]
                if isinstance(want, str):
                    check(have == want, f"{label}/{m}/{k}: {have!r} vs {want!r}")
                elif k in EVENT_KEYS:
                    check(have == want, f"{label}/{m}/{k}: {have} vs {want} (exact)")
                else:
                    gap = _rel(have, want)
                    worst = max(worst, gap)
                    check(gap < RAW_RTOL, f"{label}/{m}/{k}: {have!r} vs {want!r}")
        sa, sb = summarize(pa.results, pa.hw), summarize(pb.results, pb.hw)
        for m in sb:
            for k in RATIO_KEYS:
                gap = _rel(sa[m][k], sb[m][k])
                worst = max(worst, gap)
                check(gap < RATIO_RTOL, f"{label}/{m}/{k}: {sa[m][k]!r} vs {sb[m][k]!r}")
    return worst


def capture_path() -> tuple[dict, dict, KernelTap]:
    """``Study(["capture/lazy_embed"])`` on both engines against the port's
    CPU run of the same study; every B5/B6 call held against its plain
    version.  Returns (launch counts, wall s, the tap of the batch run)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import MECHANISMS, Study

    counts, walls, taps = {}, {}, {}
    for engine in ("batch", "sequential"):
        phase(f"capture path, engine={engine}")
        tap = KernelTap()
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        study = Study([CAPTURE_APP])
        with tap:
            rs = study.run(engine=engine)
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        counts[engine] = launch_counts()
        print(f"{engine}: {CAPTURE_APP} x {len(MECHANISMS)} mechanisms in "
              f"{walls[engine]:.2f} s wall; launches {counts[engine]}", flush=True)
        for name in CAPTURE_KERNELS:
            check(counts[engine][name] > 0,
                  f"capture/{engine}: kernel {name} was never launched")
        check_query_launches(f"capture/{engine}", study, rs, engine, counts[engine])
        check_insert_launches(f"capture/{engine}", study, rs, engine, counts[engine])
        check_intersect_launches(f"capture/{engine}", study, rs, engine, counts[engine])
        t0 = time.perf_counter()
        cpu = Study([CAPTURE_APP], device="cpu").run(engine=engine)
        cpu_wall = time.perf_counter() - t0
        worst = compare_results(rs, cpu, f"capture/{engine}")
        err5, err6 = tap.check(f"capture/{engine}")
        print(f"{engine}: equals the port's CPU run ({cpu_wall:.2f} s) on every "
              f"field (worst rel gap {worst:.3g}); {len(tap.b5)} "
              f"bloom_detect_conflicts calls exact, {len(tap.b6)} lazy_merge "
              f"calls within {err6:.3g} of their plain versions", flush=True)
        taps[engine] = tap
    return counts, walls, taps["batch"]


def _lazy_touched(rng, vocab: int, groups: int, per_group: int):
    """(G, per_group) int32 touched ids drawn as ``capture_lazy_embed``
    draws them: zipf ranks with a small per-group shift through a fixed
    hot-set permutation."""
    import numpy as np

    base_rng = np.random.default_rng(0)
    order = base_rng.permutation(vocab)
    shifts = base_rng.integers(0, vocab // 64, size=groups)
    u = rng.random((groups, per_group))
    ranks = np.minimum((vocab * u ** LAZY_ZIPF).astype(np.int64), vocab - 1)
    return order[np.minimum(ranks + shifts[:, None], vocab - 1)].astype(np.int32)


def _lazy_batch(step: int, vocab: int, d: int, groups: int, dev):
    """One step's inputs at full width, from numpy seeds: (G, T) touched
    ids (:func:`_lazy_touched`) and a dense (G, V, d) float32 gradient that
    is nonzero on exactly those rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng([1, step])
    touched = _lazy_touched(rng, vocab, groups, LAZY_TOUCHED)
    grads = torch.zeros((groups, vocab, d), dtype=torch.float32, device=dev)
    for g in range(groups):
        rows = np.unique(touched[g])
        vals = rng.standard_normal((rows.size, d), dtype=np.float32) * np.float32(0.01)
        grads[g, torch.from_numpy(rows).to(dev)] = torch.from_numpy(vals).to(dev)
    return torch.from_numpy(touched).to(dev), grads


def lazysync_path() -> dict:
    """24 ``sync_step``s of LazySync at qwen3-4b width on the card, each
    step's kernel calls held against their plain versions; then the idle
    share from 8 more steps run twice from one snapshot."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.core.lazy_sync import LazyEmbed, LazySyncConfig, init_state

    phase("LazySync at qwen3-4b width")
    dev = torch.device("cuda", 0)
    mcfg, cfg = get_config("qwen3_4b"), LazySyncConfig()
    emb = LazyEmbed(mcfg, cfg)
    vocab, d, groups = mcfg.vocab, mcfg.d_model, cfg.num_groups
    print(f"{mcfg.name}: vocab {vocab}, d_model {d}, {groups} groups, "
          f"{cfg.sig_bits}-bit signatures / {cfg.num_segments} segments, budget "
          f"{cfg.max_reconcile_rows}, commit every {cfg.commit_interval}, "
          f"{mcfg.param_dtype}; {LAZY_TOUCHED} touched ids per group", flush=True)
    params = emb.init(torch.Generator(device=dev).manual_seed(0))
    state = init_state(cfg, vocab, dev)
    counts = {name: 0 for name in TPU_KERNEL}
    steps, keep = [], {}
    tap = KernelTap()
    for step in range(LAZY_STEPS):
        touched, grads = _lazy_batch(step, vocab, d, groups, dev)
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        with tap:
            params, state, m = emb.sync_step(params, state, touched, grads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, n in launch_counts().items():
            counts[name] += n
        del grads
        err5, err6 = tap.check(f"qwen3 step {step + 1}")
        if "detect" not in keep:
            keep["detect"] = tap.b5[0]
            keep["reconcile"] = tap.b6[0]
        row = dict(step=step + 1, wall_s=wall,
                   lazy_conflict_rows=int(m["lazy_conflict_rows"]),
                   lazy_pinned=int(m["lazy_pinned"]),
                   lazy_commit=bool(m["lazy_commit"]),
                   lazy_bytes=int(m["lazy_bytes"]), dense_bytes=int(m["dense_bytes"]),
                   b5_err=err5, b6_rel_err=err6)
        if row["lazy_commit"]:
            keep["commit"] = tap.b6[-1]
            table, base = params["table"], params["base"]
            for g in range(groups):
                check(torch.equal(table[g], base),
                      f"qwen3 step {step + 1}: replica {g} != base after the commit")
            row["replicas_equal_base"] = True
        tap.clear()
        steps.append(row)
        print(f"step {row['step']:2d}: {wall * 1e3:9.3f} ms; conflict rows "
              f"{row['lazy_conflict_rows']}, pinned {row['lazy_pinned']}, commit "
              f"{row['lazy_commit']}, lazy {row['lazy_bytes']} B vs dense "
              f"{row['dense_bytes']} B; B5 exact, B6 rel err {err6:.3g}", flush=True)
    check(sum(r["lazy_commit"] for r in steps) >= 1, "qwen3: no commit fired")
    check("commit" in keep, "qwen3: the commit's merge was not seen")
    for name in ("h3_hash", "bloom_detect_conflicts", "lazy_merge"):
        check(counts[name] > 0, f"qwen3: kernel {name} was never launched")

    # idle share: the same 8 steps from one snapshot, unprofiled then
    # profiled, on one step's inputs reused (bounded memory)
    snap_p = {k: v.clone() for k, v in params.items()}
    snap_s = {k: v.clone() for k, v in state.items()}
    del params, state
    window_inputs = _lazy_batch(LAZY_STEPS, vocab, d, groups, dev)

    def run_window():
        p, st = snap_p, snap_s
        for _ in range(LAZY_PROFILE_STEPS):
            p, st, _ = emb.sync_step(p, st, *window_inputs)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_window()
    window_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    busy, _, by_name = device_busy_s(run_window)
    for t, c, k in by_name:
        print(f"  {t:9.4f} s {c:5d}x  {k[:100]}")
    idle = 1.0 - busy / window_wall
    walls = [r["wall_s"] for r in steps]
    plain_walls = [r["wall_s"] for r in steps if not r["lazy_commit"]]
    summary = dict(steps=steps, launches=counts,
                   step_wall_s_median=sorted(plain_walls)[len(plain_walls) // 2],
                   commit_step_wall_s=[r["wall_s"] for r in steps if r["lazy_commit"]],
                   total_wall_s=sum(walls), idle_window_steps=LAZY_PROFILE_STEPS,
                   idle_window_wall_s=window_wall, idle_window_busy_s=busy,
                   idle_share=idle, peak_mem_window_bytes=peak,
                   top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in by_name])
    print(f"24 steps: {sum(walls):.3f} s; median non-commit step "
          f"{summary['step_wall_s_median'] * 1e3:.3f} ms; commit step(s) "
          f"{[round(w * 1e3, 3) for w in summary['commit_step_wall_s']]} ms; "
          f"launches {counts}", flush=True)
    print(f"idle share: device busy {busy:.4f} s of {window_wall:.4f} s over "
          f"{LAZY_PROFILE_STEPS} steps (idle share {idle:.3f}); peak memory "
          f"allocated over those steps {peak / 2**30:.2f} GiB (a 3.9 GB "
          f"snapshot of the params included)", flush=True)
    summary["keep"] = keep
    return summary


def unsaturated_checks(keep: dict) -> dict:
    """B5 and B6 against their plain versions at qwen3-4b width where their
    outputs vary.  At the path's load the 2,048-bit signatures saturate and
    every touched id tests as a member of all G groups, and every budget
    row is valid; so B5 also runs on a draw of a quarter the size (1,024
    ids a group) at vocab 151,936, whose hit counts must take at least
    three values, and B6 on the path's reconcile rows with about half the
    valid flags cleared."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.lazy_sync import LazyEmbed, LazySyncConfig
    from repro_torch.core.signatures import pack_words, to_addr_i32
    from repro_torch.kernels.bloom import bloom as K

    LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
    dev = torch.device("cuda", 0)
    mcfg, cfg = get_config("qwen3_4b"), LazySyncConfig()
    emb = LazyEmbed(mcfg, cfg)
    touched = torch.from_numpy(_lazy_touched(np.random.default_rng(2), mcfg.vocab,
                                             cfg.num_groups, 1024)).to(dev)
    sigs = pack_words(emb.signatures(touched)).contiguous()
    ids = to_addr_i32(touched.reshape(-1))
    got = K.bloom_detect_conflicts(emb.spec, sigs, ids)
    want = K.bloom_detect_conflicts_plain(emb.spec, sigs, ids)
    err5 = int((got.to(torch.int64) - want).abs().max())
    check(err5 == 0, f"B5 off saturation: kernel disagrees with plain version "
                     f"(max |diff| {err5})")
    hist = torch.bincount(want.to(torch.int64), minlength=cfg.num_groups + 1).tolist()
    check(sum(1 for c in hist if c) >= 3,
          f"B5 off saturation: hit counts {hist} do not vary")
    print(f"bloom_detect_conflicts (G={cfg.num_groups}, N={ids.numel()}, vocab "
          f"{mcfg.vocab}): exact; ids by hit-group count 0..{cfg.num_groups}: "
          f"{hist}", flush=True)

    rows, base, _, _ = keep["reconcile"]
    r = rows.shape[1]
    gen = torch.Generator(device=dev).manual_seed(3)
    valid = torch.rand((r,), generator=gen, device=dev) < 0.5
    n_valid = int(valid.sum())
    check(0 < n_valid < r, f"B6 mixed flags: {n_valid} of {r} valid")
    got = LM.lazy_merge(rows, base, valid)
    want = LM.lazy_merge_plain(rows, base, valid)
    err6 = merge_rel_err(got, want)
    check(err6 <= MERGE_RTOL, f"B6 mixed flags: kernel disagrees with plain "
                              f"version (rel {err6:.3g})")
    check(torch.equal(got[~valid], base[~valid].to(torch.float32)),
          "B6 mixed flags: an invalid row is not its base row")
    print(f"lazy_merge {tuple(rows.shape)} {rows.dtype}, {n_valid} of {r} rows "
          f"valid: max rel diff {err6:.3g}, invalid rows equal base", flush=True)
    return dict(b5=dict(G=cfg.num_groups, N=ids.numel(), vocab=mcfg.vocab,
                        hit_count_histogram=hist, max_abs_err=err5),
                b6=dict(shape=list(rows.shape), dtype=str(rows.dtype),
                        valid=n_valid, max_rel_err=err6))


def lazysync_kernel_phases(capture_tap: KernelTap, keep: dict,
                           floor_ms: float) -> dict[str, dict]:
    """B5 and B6 against their plain versions, timed, on inputs the two
    paths gave them: B5 at the capture's shape and at qwen3-4b width, B6
    at the qwen3 reconcile and commit shapes (and the capture's, printed)."""
    import torch

    from repro_torch.core.signatures import packed_tables, to_addr_i32
    from repro_torch.kernels.bloom import bloom as K

    LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
    out = {}

    def b5(label, rec, previous):
        spec, sigs, addrs, _ = rec
        sigs = sigs.contiguous()
        ids = to_addr_i32(addrs)
        got = K.bloom_detect_conflicts(spec, sigs, ids)
        want = K.bloom_detect_conflicts_plain(spec, sigs, ids)
        err = int((got.to(torch.int64) - want).abs().max())
        check(err == 0, f"{label}: kernel disagrees with plain version")
        check(K.detect_route(spec) == "transposed", f"{label}: not the transposed route")
        g, nw = sigs.shape
        n = ids.numel()
        m, s = spec.num_segments, spec.num_byte_slices
        # each address in and its count out, the signatures and the packed
        # table read once; the hash, one mask lookup a segment and a
        # popcount an address, and the G x sig_bits mask bits built once
        st = measure(f"{label} (G={g}, N={n})", err,
                     lambda sg, a: K.bloom_detect_conflicts(spec, sg, a),
                     lambda sg, a: K.bloom_detect_conflicts_plain(spec, sg, a), (sigs, ids),
                     nbytes=n * 4 + n * 4 + g * nw * 4 + packed_tables(spec).nbytes,
                     ops=n * (2 * s - 1 + 4 * m + 1) + 3 * g * spec.sig_bits)
        print(f"{label}: launch floor {floor_ms:.5f} ms ({st['ms'] / floor_ms:.2f}x it); "
              f"previous design's reading {previous:.5f} ms ({PREVIOUS_CARD})", flush=True)
        return dict(st, shape=dict(G=g, N=n), launch_floor_ms=floor_ms)

    def b6(label, rec, iters=200):
        rows, base, valid, _ = rec
        got = LM.lazy_merge(rows, base, valid)
        want = LM.lazy_merge_plain(rows, base, valid)
        err = merge_rel_err(got, want)
        check(err <= MERGE_RTOL, f"{label}: kernel disagrees with plain version "
                                 f"(rel {err:.3g})")
        abs_err = float((got - want).abs().max()) if got.numel() else 0.0
        g, r, dd = rows.shape
        n_valid = int(valid.sum())
        es = rows.element_size()
        st = measure(f"{label} (G={g}, R={r}, D={dd}, {rows.dtype}, {n_valid} valid)",
                     abs_err, LM.lazy_merge, LM.lazy_merge_plain, (rows, base, valid),
                     nbytes=g * n_valid * dd * es + r * dd * es + r + r * dd * 4,
                     ops=(2 * g + 1) * n_valid * dd, iters=iters)
        return dict(st, shape=dict(G=g, R=r, D=dd, dtype=str(rows.dtype),
                                   valid=n_valid), max_rel_err=err)

    phase("LazySync kernels off saturation, qwen3-4b width")
    off = unsaturated_checks(keep)
    phase("kernel bloom_detect_conflicts")
    cap = b5("bloom_detect_conflicts, capture", capture_tap.b5[0],
             PREVIOUS_MS["bloom_detect_conflicts capture"])
    full = b5("bloom_detect_conflicts, qwen3-4b width", keep["detect"],
              PREVIOUS_MS["bloom_detect_conflicts"])
    out["bloom_detect_conflicts"] = dict(full, other_shapes=[cap],
                                         unsaturated_check=off["b5"])
    phase("kernel lazy_merge")
    cap_rec = b6("lazy_merge, capture reconcile", capture_tap.b6[0])
    commits = [r for r in capture_tap.b6 if r[2].all()]
    cap_commit = b6("lazy_merge, capture commit", commits[0]) if commits else None
    rec = b6("lazy_merge, qwen3-4b reconcile", keep["reconcile"])
    com = b6("lazy_merge, qwen3-4b commit", keep["commit"], iters=50)
    out["lazy_merge"] = dict(rec, other_shapes=[com, cap_rec]
                             + ([cap_commit] if cap_commit else []),
                             mixed_valid_check=off["b6"])
    return out


def kv_serve_path() -> tuple[dict, dict]:
    """``Study(["capture/kv_serve"])`` on both engines, each held to one run
    of the port on the CPU (the engines agree bit for bit, so one CPU run
    is the reference of both); B1–B4 must launch.  Returns (launch counts,
    wall s)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import MECHANISMS, Study

    t0 = time.perf_counter()
    cpu = Study([KV_APP], device="cpu").run(engine="sequential")
    cpu_wall = time.perf_counter() - t0
    counts, walls = {}, {}
    for engine in ("batch", "sequential"):
        phase(f"capture/kv_serve, engine={engine}")
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        study = Study([KV_APP])
        t0 = time.perf_counter()
        rs = study.run(engine=engine)
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        counts[engine] = launch_counts()
        for name in FIG7_KERNELS:
            check(counts[engine][name] > 0,
                  f"kv_serve/{engine}: kernel {name} was never launched")
        check_query_launches(f"kv_serve/{engine}", study, rs, engine, counts[engine])
        check_insert_launches(f"kv_serve/{engine}", study, rs, engine, counts[engine])
        check_intersect_launches(f"kv_serve/{engine}", study, rs, engine, counts[engine])
        worst = compare_results(rs, cpu, f"kv_serve/{engine}")
        print(f"{engine}: {KV_APP} x {len(MECHANISMS)} mechanisms in "
              f"{walls[engine]:.2f} s wall; launches {counts[engine]}; equals the "
              f"port's CPU run ({cpu_wall:.2f} s) on every field (worst rel gap "
              f"{worst:.3g})", flush=True)
    return counts, walls


def fa_excess(got, want) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / (rtol |want| + row_tol
    rms(want row))), the pair ``FA_TOL`` gives ``want``'s dtype: the second
    is <= 1 when the kernel is within tolerance.  An exact match counts 0
    (a fully masked row is 0 in both)."""
    import torch

    rtol, row_tol = FA_TOL[str(want.dtype).removeprefix("torch.")]
    got, want = got.to(torch.float32), want.to(torch.float32)
    diff = (got - want).abs()
    allowed = rtol * want.abs() + row_tol * want.pow(2).mean(-1, keepdim=True).sqrt()
    ratio = torch.where(diff == 0, 0.0, diff / allowed)
    return float(diff.max()), float(ratio.max())


class FlashTap:
    """While active, records every ``ops.mha`` call the model zoo makes —
    inputs and result — by wrapping the name :mod:`repro_torch.models.
    attention` calls; the wrapped call launches exactly what it would have.
    :meth:`check` then holds each result against the kernel's plain version
    on the same inputs (no launch of the kernel, so nothing counted)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        self._ops, self._orig = ops, ops.mha

        def tapped(q, k, v, *, causal=True, window=0):
            out = self._orig(q, k, v, causal=causal, window=window)
            self.calls.append((q, k, v, causal, window, out))
            return out

        ops.mha = tapped
        return self

    def __exit__(self, *exc):
        self._ops.mha = self._orig
        return False

    def check(self, label: str) -> tuple[float, float]:
        """Hold every tapped call to its plain version; returns the largest
        |diff| and the largest ``fa_excess`` over the calls."""
        FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
        err = excess = 0.0
        for i, (q, k, v, causal, window, out) in enumerate(self.calls):
            want = FA.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                            causal=causal, window=window)
            e, x = fa_excess(out, want)
            err, excess = max(err, e), max(excess, x)
            check(x <= 1.0, f"{label}: flash_attention call {i} disagrees with its "
                            f"plain version (max |diff| {e:.4g}, {x:.3g} of the "
                            f"tolerance)")
        return err, excess


def prefill_path(arch: str = "qwen3_4b") -> tuple[dict, dict, dict, tuple]:
    """A dense ``arch`` (qwen3-4b, phi3-mini-3.8b) at full width and depth
    on the card: three prefill steps of 4 x 4,096 tokens (counted and
    tapped: exactly one sm90 B7 launch a layer; unprofiled; profiled).
    Returns (summary, launch counts of the counted run, params, layer 0's
    B7 inputs)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model

    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    phase(f"{cfg.name} prefill")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads / {cfg.num_kv_heads} kv heads x {cfg.head_dim}, vocab {cfg.vocab}; "
          f"{n_params} parameters ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated) initialised in {time.perf_counter() - t0:.2f} s", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    step = make_prefill_step(model)
    batch = {"tokens": tokens}
    step(params, {"tokens": tokens[:, :256]})  # warm-up: cuBLAS handles, kernels
    torch.cuda.synchronize()

    tap = FlashTap()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    with tap:
        last = step(params, batch)
    torch.cuda.synchronize()
    tapped_wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["flash_attention_sm90"] == cfg.num_layers
          and counts["flash_attention_general"] == 0,
          f"{cfg.name} prefill: {counts['flash_attention_sm90']} flash_attention launches on "
          f"the sm90 route and {counts['flash_attention_general']} on the general one, want "
          f"exactly {cfg.num_layers} (one per layer), all sm90 (bf16, D = {cfg.head_dim})")
    check(len(tap.calls) == cfg.num_layers,
          f"{cfg.name} prefill: {len(tap.calls)} ops.mha calls")
    check(tuple(last.shape) == (PREFILL_BATCH, cfg.vocab) and
          bool(last.to(torch.float32).isfinite().all()),
          f"{cfg.name} prefill: last-position logits {tuple(last.shape)} not finite")
    err, excess = tap.check(f"{cfg.name} prefill")
    q, k, v, _, _, _ = tap.calls[0]
    layer0 = (q, k, v)
    print(f"{cfg.name} prefill (counted): {tapped_wall:.3f} s wall; launches {counts}; all "
          f"{len(tap.calls)} flash_attention calls (sm90 route, D = {cfg.head_dim}) within "
          f"tolerance of their plain versions (max |diff| {err:.4g}, at most {excess:.3g} of "
          f"the tolerance)", flush=True)
    del tap, last
    gc.collect()

    wall, peak, busy, n_kernels, by_name, b7_s = time_and_profile(lambda: step(params, batch))
    top = by_name[:8]
    tokens_per_s = PREFILL_BATCH * PREFILL_LEN / wall
    print(f"{cfg.name} prefill: {wall:.4f} s wall ({tokens_per_s:.0f} tokens/s); device "
          f"busy {busy:.4f} s in {n_kernels} kernels (idle share {1.0 - busy / wall:.3f}), "
          f"B7 {b7_s:.4f} s of it ({b7_s / busy:.3f}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB (the {n_params * 2 / 2**30:.2f} GiB of weights "
          f"included)", flush=True)
    summary = dict(batch=PREFILL_BATCH, seq=PREFILL_LEN, layers=cfg.num_layers,
                   params=n_params, wall_s=wall, counted_wall_s=tapped_wall,
                   tokens_per_s=tokens_per_s, device_busy_s=busy, kernels=n_kernels,
                   flash_device_s=b7_s, flash_share=b7_s / busy,
                   idle_share=1.0 - busy / wall, peak_mem_bytes=peak,
                   flash_calls=cfg.num_layers, flash_max_abs_err=err,
                   flash_max_tolerance_share=excess,
                   top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in top])
    return summary, counts, params, layer0


def flash_kernel_phase(layer0: tuple) -> dict[str, dict]:
    """B7 at the prefill path's shape on layer 0's inputs: the sm90 kernel
    the bf16 path takes, and the general kernel in float32 (the dtype of
    the float32 prefill, which runs it at full width) and in bfloat16
    (forced): each against its plain version, timed, with its bound in
    operations (bf16 at the tensor-core rate, float32 at the FFMA rate:
    no TF32) and one ``scaled_dot_product_attention`` call on the same
    inputs as yardstick (float32 with TF32 off).  Returns the stats by
    kernel name; the general kernel's record is its forced bf16 timing, as
    before the float32 path existed, with the float32 one as ``float32``."""
    import torch
    import torch.nn.functional as F

    FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    phase("kernel flash_attention (sm90 bf16; general float32 and bf16)")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 attention")
    bf = tuple(t.contiguous() for t in layer0)
    b, s, hq, d = bf[0].shape
    hkv = bf[1].shape[2]
    check(FA._route_for(bf[0].dtype, d) == "sm90", f"layer 0's B7 call ({bf[0].dtype}, "
                                                   f"D = {d}) does not take the sm90 route")
    useful = 4 * d * (s * (s + 1) // 2) * b * hq  # QK^T and PV over the causal triangle
    runs = {}
    for label, route, dtype, iters, peak in (
            ("sm90", "sm90", torch.bfloat16, 200, PEAK_BF16_FLOP_PER_S),
            ("general", "general", torch.float32, 20, PEAK_OPS_PER_S),
            ("general bf16", "general", torch.bfloat16, 50, PEAK_BF16_FLOP_PER_S)):
        q, k, v = bf if dtype == torch.bfloat16 else tuple(t.to(dtype) for t in bf)
        name = FA_ROUTE_KERNEL[route]
        tname = str(dtype).removeprefix("torch.")
        want = FA.flash_attention_plain(q, k, v, causal=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = float((lib.transpose(1, 2).to(torch.float32)
                         - want.to(torch.float32)).abs().max())
        del lib
        got = FA._flash_attention(q, k, v, causal=True, route=route)
        err, excess = fa_excess(got, want)
        del got, want
        check(excess <= 1.0, f"{name} {tname}: kernel disagrees with plain version (max "
                             f"|diff| {err:.4g}, {excess:.3g} of the tolerance)")
        print(f"{name} ({route} route) q {tuple(q.shape)} k/v {tuple(k.shape)} {tname} "
              f"causal: max |kernel - plain| {err:.4g} ({excess:.3g} of the tolerance); "
              f"SDPA against plain {lib_err:.4g}", flush=True)
        st = measure(f"{name} (B={b}, S={s}, Hq={hq}, Hkv={hkv}, D={d}, {tname}, causal)",
                     err, lambda *a, r=route: FA._flash_attention(*a, causal=True, route=r),
                     lambda *a: FA.flash_attention_plain(*a, causal=True), (q, k, v),
                     nbytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(), ops=useful,
                     iters=iters, plain_iters=3, ops_per_s=peak,
                     library=lambda *a: F.scaled_dot_product_attention(
                         *a, is_causal=True, enable_gqa=True),
                     library_args=(qt, kt, vt))
        runs[label] = dict(st, shape=dict(B=b, S=s, Hq=hq, Hkv=hkv, D=d, dtype=tname,
                                          causal=True), b7_route=route, useful_flop=useful,
                           tolerance_share=excess,
                           library_call="torch.nn.functional.scaled_dot_product_attention"
                                        "(is_causal=True, enable_gqa=True)",
                           library_max_abs_diff_vs_plain=lib_err)
        del q, k, v, qt, kt, vt
        gc.collect()
        torch.cuda.empty_cache()
    sm90, general, general_bf16 = runs["sm90"], runs["general"], runs["general bf16"]
    sm90["kernel_attributes"] = FA.sm90_attributes(d)
    general["kernel_attributes"] = FA.general_attributes(torch.float32, d)
    general_bf16["kernel_attributes"] = FA.general_attributes(torch.bfloat16, d)
    print(f"flash_attention bf16: sm90 route {sm90['ms']:.5f} ms, general route "
          f"{general_bf16['ms']:.5f} ms ({general_bf16['ms'] / sm90['ms']:.2f}x), SDPA "
          f"{sm90['library_ms']:.5f} ms, bound {sm90['bound_ms']:.5f} ms; float32: general "
          f"route {general['ms']:.5f} ms, SDPA {general['library_ms']:.5f} ms, bound "
          f"{general['bound_ms']:.5f} ms (FFMA, {general['bound_ms'] / general['ms']:.3f} "
          f"of it reached)", flush=True)
    return {"flash_attention_sm90": sm90,
            "flash_attention_general": dict(general_bf16, float32=general)}


def prefill_f32_path(params: dict) -> tuple[dict, dict]:
    """qwen3-4b at full width and depth in float32 on the card: ``params``
    (the float32 cast of the bf16 phases' weights, ~16 GB) through
    ``make_prefill_step`` on 1 x 4,096 seeded tokens, with TF32 off;
    counted and tapped (exactly 36 B7 launches, all on the general route,
    each held to its plain version at ``FA_TOL``'s float32 pair),
    unprofiled (wall time, peak memory) and profiled (idle share, top
    kernels, B7's share of device time).  Returns (summary, launch counts
    of the counted run)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import Model

    phase("qwen3-4b prefill, float32 (general B7 route, full width)")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the float32 prefill")
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("qwen3_4b"), param_dtype=torch.float32)
    model = Model(cfg)
    check(all(t.dtype == torch.float32 for t in tree_leaves(params)),
          "prefill f32: weights not float32")
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    step = make_prefill_step(model)
    batch = {"tokens": tokens}
    step(params, {"tokens": tokens[:, :256]})  # warm-up: cuBLAS handles, kernels
    torch.cuda.synchronize()

    tap = FlashTap()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    with tap:
        last = step(params, batch)
    torch.cuda.synchronize()
    tapped_wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["flash_attention_general"] == cfg.num_layers
          and counts["flash_attention_sm90"] == 0,
          f"prefill f32: {counts['flash_attention_general']} general and "
          f"{counts['flash_attention_sm90']} sm90 B7 launches, want exactly "
          f"{cfg.num_layers} general (one per layer)")
    check(len(tap.calls) == cfg.num_layers, f"prefill f32: {len(tap.calls)} ops.mha calls")
    check(tuple(last.shape) == (1, cfg.vocab) and last.dtype == torch.float32
          and bool(last.isfinite().all()),
          f"prefill f32: last-position logits {last.dtype}{tuple(last.shape)} not finite")
    err, excess = tap.check("prefill f32")
    print(f"prefill f32 (counted): {tapped_wall:.3f} s wall; launches {counts}; all "
          f"{len(tap.calls)} flash_attention calls (general route) within tolerance of "
          f"their plain versions (max |diff| {err:.4g}, at most {excess:.3g} of the "
          f"tolerance)", flush=True)
    del tap, last
    gc.collect()

    wall, peak, busy, n_kernels, by_name, b7_s = time_and_profile(
        lambda: step(params, batch))
    tokens_per_s = PREFILL_LEN / wall
    n_params = model.param_count()
    print(f"prefill f32: {wall:.4f} s wall ({tokens_per_s:.0f} tokens/s); device busy "
          f"{busy:.4f} s in {n_kernels} kernels (idle share {1.0 - busy / wall:.3f}), B7 "
          f"{b7_s:.4f} s of it ({b7_s / busy:.3f}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB (the {n_params * 4 / 2**30:.2f} GiB of weights "
          f"included)", flush=True)
    return dict(batch=1, seq=PREFILL_LEN, layers=cfg.num_layers, dtype="float32",
                wall_s=wall, counted_wall_s=tapped_wall, tokens_per_s=tokens_per_s,
                device_busy_s=busy, idle_share=1.0 - busy / wall, kernels=n_kernels,
                flash_device_s=b7_s, flash_share=b7_s / busy, peak_mem_bytes=peak,
                flash_calls=cfg.num_layers, flash_max_abs_err=err,
                flash_max_tolerance_share=excess,
                top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in by_name[:8]]), counts


def smoke_prefill_path() -> dict[str, int]:
    """The general B7 route on a path of its own: the qwen3-4b smoke config
    (2 layers, D = 16) in float32 through ``make_prefill_step`` on the card,
    counted (one general launch a layer, none on the sm90 route) and tapped
    (each call held to the plain version at ``FA_TOL``'s float32 pair), its
    last-position logits held to the CPU run's."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import Model

    phase("qwen3-4b smoke prefill, float32 (general B7 route)")
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_smoke_config("qwen3_4b"), param_dtype=torch.float32)
    model = Model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    gpu = tree_map(lambda t: t.to(dev), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, SMOKE_PREFILL_LEN),
                         generator=torch.Generator().manual_seed(1))
    step = make_prefill_step(model)
    tap = FlashTap()
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    with tap:
        got = step(gpu, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["flash_attention_general"] == cfg.num_layers
          and counts["flash_attention_sm90"] == 0,
          f"smoke prefill: {counts['flash_attention_general']} general and "
          f"{counts['flash_attention_sm90']} sm90 B7 launches, want {cfg.num_layers} general")
    check(len(tap.calls) == cfg.num_layers, f"smoke prefill: {len(tap.calls)} ops.mha calls")
    err, excess = tap.check("smoke prefill")
    want = step(cpu, {"tokens": toks})
    diff = float((got.cpu() - want).abs().max())
    check(bool(torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)),
          f"smoke prefill: card logits differ from the CPU run's by {diff:.3g}")
    print(f"smoke prefill (float32, {cfg.num_layers} layers, D = {cfg.head_dim}, 2 x "
          f"{SMOKE_PREFILL_LEN} tokens): launches {counts}; all {len(tap.calls)} "
          f"flash_attention calls (general route) within tolerance of their plain versions "
          f"(max |diff| {err:.4g}, at most {excess:.3g} of the tolerance); last-position "
          f"logits equal the CPU run's within 1e-4 (max |diff| {diff:.3g})", flush=True)
    return counts


def serve_path(params: dict) -> tuple[dict, dict]:
    """The port's serve loop at full width with the reference loop's
    defaults on ``params``; then one teacher-forced 64-token prompt through
    decode against the full forward.  Returns (summary, launch counts of
    the serve run)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model

    phase("qwen3-4b serve")
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen3_4b")
    model = Model(cfg)
    summary, counts = serve_and_decode("serve", model, params, SERVE_ARGS)

    phase("qwen3-4b decode against prefill (teacher-forced)")
    prompt = torch.randint(0, cfg.vocab_size, (1, TEACHER_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    full, _ = model.apply(params, prompt)
    last = make_prefill_step(model)(params, {"tokens": prompt})
    cache = model.init_cache(1, TEACHER_LEN, dev)
    steps = []
    for i in range(TEACHER_LEN):
        logits, cache = model.decode(params, prompt[:, i:i + 1], cache)
        steps.append(logits[:, 0])
    dec = torch.stack(steps, dim=1).to(torch.float32)
    full = full.to(torch.float32)
    check(bool(dec.isfinite().all()) and bool(full.isfinite().all()),
          "teacher-forced decode: non-finite logits")
    agree = float((dec.argmax(-1) == full.argmax(-1)).to(torch.float32).mean())
    max_d = float((dec - full).abs().max())
    last_d = float((dec[:, -1] - last.to(torch.float32)).abs().max())
    last_agree = bool(dec[0, -1].argmax() == last[0].argmax())
    print(f"teacher-forced {TEACHER_LEN}-token prompt, bf16, {cfg.num_layers} layers: "
          f"decode vs full forward top-1 agreement {agree:.4f} over {TEACHER_LEN} positions, max "
          f"|diff| {max_d:.4g}; last position vs the prefill step: top-1 equal "
          f"{last_agree}, max |diff| {last_d:.4g} (recorded, not gated)", flush=True)
    summary["teacher_forced"] = dict(len=TEACHER_LEN, top1_agreement=agree,
                                     max_abs_diff=max_d, last_top1_equal=last_agree,
                                     last_max_abs_diff=last_d)
    return summary, counts


def serve_and_decode(label: str, model, params: dict, serve_args: dict) -> tuple[dict, dict]:
    """``launch.serve.serve`` with ``serve_args`` on ``params`` (counted:
    every request served, in range); then 8 decode steps at the serve
    loop's batch, timed unprofiled and then under the profiler from the
    same cache.  Returns (summary, launch counts of the serve run)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.launch.serve import serve

    dev = torch.device("cuda", 0)
    cfg = model.cfg
    args = argparse.Namespace(device=str(dev), **serve_args)
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    served = serve(args, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_req = serve_args["requests"]
    check(len(served) == n_req, f"{label}: {len(served)} of {n_req} requests served")
    check(sorted(r.rid for r in served) == list(range(n_req)), f"{label}: request ids")
    for r in served:
        check(r.done and len(r.out) > len(r.prompt)
              and all(0 <= t < cfg.vocab_size for t in r.out),
              f"{label}: request {r.rid} out of range or unfinished")
    total = sum(len(r.out) for r in served)
    new = sum(len(r.out) - len(r.prompt) for r in served)
    print(f"{label}: {len(served)} requests, {total} tokens ({new} generated) in "
          f"{wall:.3f} s wall: {total / wall:.1f} tokens/s ({new / wall:.1f} "
          f"generated/s); launches {counts}", flush=True)

    tok = torch.zeros((serve_args["batch"], 1), dtype=torch.int64, device=dev)
    cache0 = model.init_cache(serve_args["batch"], serve_args["max_len"], dev)

    def decode_window():
        c = cache0
        for _ in range(8):
            _, c = model.decode(params, tok, c)
        torch.cuda.synchronize()

    decode_window()
    t0 = time.perf_counter()
    decode_window()
    step_wall = (time.perf_counter() - t0) / 8
    busy, n_kernels, top = device_busy_s(decode_window)
    for t, c, name in top:
        print(f"  {t:9.4f} s {c:5d}x  {name[:100]}")
    decode_idle = 1.0 - busy / 8 / step_wall
    print(f"decode step (batch {serve_args['batch']}, {cfg.num_layers} layers): "
          f"{step_wall * 1e3:.3f} ms wall, {busy / 8 * 1e3:.3f} ms device busy in "
          f"{n_kernels / 8:.0f} kernels (idle share {decode_idle:.3f})", flush=True)
    summary = dict(requests=len(served), tokens=total, generated=new, wall_s=wall,
                   tokens_per_s=total / wall, generated_per_s=new / wall,
                   decode_step_wall_s=step_wall, decode_step_busy_s=busy / 8,
                   decode_idle_share=decode_idle, decode_step_kernels=n_kernels / 8,
                   decode_top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in top])
    return summary, counts


class MoETap:
    """While active, records each ``moe_block`` call the model zoo makes:
    its routing (``top_e``, kept on the host), the pairs it dropped past
    capacity and, for the first call, its inputs.  The wrapped call runs as
    it would have; the tap recomputes the routing with ``moe.route`` and
    ``moe.dispatch_plan``, which launch no kernel of the package."""

    def __init__(self):
        self.top_e, self.dropped, self.first = [], [], None

    def __enter__(self):
        M = importlib.import_module("repro_torch.models.moe")
        self._M, self._orig = M, M.moe_block

        def tapped(p, x, cfg):
            out = self._orig(p, x, cfg)
            *_, top_e = M.route(p, x, cfg)
            _, _, rank, _, _ = M.dispatch_plan(top_e, cfg.moe.num_routed_padded,
                                               cfg.moe_dispatch)
            self.top_e.append(top_e.cpu())
            self.dropped.append(int((rank >= M.capacity(cfg.moe, top_e.shape[0])).sum()))
            if self.first is None:
                self.first = (p, x)
            return out

        M.moe_block = tapped
        return self

    def __exit__(self, *exc):
        self._M.moe_block = self._orig
        return False


def moe_prefill_path(arch: str = MOE_ARCH) -> tuple[dict, dict, dict, tuple]:
    """An MoE ``arch`` (qwen2-moe-a2.7b, moonshot-v1-16b-a3b) at full width
    and depth on the card: three prefill steps of 4 x 4,096 tokens —
    counted and tapped (exactly one B7 launch a layer, all on the sm90
    route, each held to its plain version; each layer's dropped pairs),
    unprofiled (wall, peak memory), profiled (idle share, top kernels, B7's
    share of device time).  Returns (summary, launch counts of the counted
    run, params, layer 0's MoE inputs and B7 inputs)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe as M
    from repro_torch.models.model import Model

    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    phase(f"{cfg.name} prefill")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    n_params = model.param_count()
    moe = cfg.moe
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads / {cfg.num_kv_heads} kv heads x {cfg.head_dim}, {moe.num_experts} routed "
          f"experts padded to {moe.num_routed_padded}, top-{moe.top_k}, {moe.num_shared} "
          f"shared, d_expert {moe.d_expert}; {n_params} parameters "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated) initialised in "
          f"{init_s:.2f} s (peak {init_peak / 2**30:.2f} GiB)", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    step = make_prefill_step(model)
    batch = {"tokens": tokens}
    step(params, {"tokens": tokens[:, :256]})  # warm-up: cuBLAS handles, kernels
    torch.cuda.synchronize()

    tap, moe_tap = FlashTap(), MoETap()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    with tap, moe_tap:
        last = step(params, batch)
    torch.cuda.synchronize()
    tapped_wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["flash_attention_sm90"] == cfg.num_layers
          and counts["flash_attention_general"] == 0,
          f"{cfg.name} prefill: {counts['flash_attention_sm90']} flash_attention launches on the "
          f"sm90 route and {counts['flash_attention_general']} on the general one, want "
          f"exactly {cfg.num_layers} (one per layer), all sm90 (bf16, D = {cfg.head_dim})")
    check(len(tap.calls) == cfg.num_layers, f"{cfg.name} prefill: {len(tap.calls)} ops.mha calls")
    check(len(moe_tap.dropped) == cfg.num_layers,
          f"{cfg.name} prefill: {len(moe_tap.dropped)} moe_block calls")
    check(tuple(last.shape) == (PREFILL_BATCH, cfg.vocab) and
          bool(last.to(torch.float32).isfinite().all()),
          f"{cfg.name} prefill: last-position logits {tuple(last.shape)} not finite")
    err, excess = tap.check(f"{cfg.name} prefill")
    t = PREFILL_BATCH * PREFILL_LEN
    cap, pairs = M.capacity(moe, t), t * moe.top_k
    print(f"{cfg.name} prefill (counted): {tapped_wall:.3f} s wall; launches {counts}; all "
          f"{len(tap.calls)} flash_attention calls (sm90 route, Hq = Hkv = {cfg.num_heads}) "
          f"within tolerance of their plain versions (max |diff| {err:.4g}, at most "
          f"{excess:.3g} of the tolerance)", flush=True)
    print(f"{cfg.name} prefill: capacity {cap} a padded expert ({pairs} pairs, mean "
          f"{pairs / moe.num_experts:.0f} a real expert); pairs dropped past capacity by "
          f"layer: {moe_tap.dropped} ({sum(moe_tap.dropped)} of {pairs * cfg.num_layers}, "
          f"{sum(moe_tap.dropped) / (pairs * cfg.num_layers):.4%})", flush=True)
    loads = torch.bincount(moe_tap.top_e[0].reshape(-1), minlength=moe.num_routed_padded)
    print(f"layer 0 expert loads: min {int(loads[:moe.num_experts].min())}, max "
          f"{int(loads.max())}, padded experts {int(loads[moe.num_experts:].sum())}",
          flush=True)
    check(int(loads[moe.num_experts:].sum()) == 0,
          f"{cfg.name} prefill: a padded expert was routed")
    layer0 = moe_tap.first, tap.calls[0][:3]
    dropped = list(moe_tap.dropped)
    del tap, moe_tap, last
    gc.collect()

    wall, peak, busy, n_kernels, by_name, b7_s = time_and_profile(
        lambda: step(params, batch))
    tokens_per_s = t / wall
    print(f"{cfg.name} prefill: {wall:.4f} s wall ({tokens_per_s:.0f} tokens/s); device busy "
          f"{busy:.4f} s in {n_kernels} kernels (idle share {1.0 - busy / wall:.3f}), B7 "
          f"{b7_s:.4f} s of it ({b7_s / busy:.3f}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB (the {n_params * 2 / 2**30:.2f} GiB of weights "
          f"included)", flush=True)
    summary = dict(batch=PREFILL_BATCH, seq=PREFILL_LEN, layers=cfg.num_layers,
                   params=n_params, init_s=init_s, init_peak_mem_bytes=init_peak,
                   wall_s=wall, counted_wall_s=tapped_wall, tokens_per_s=tokens_per_s,
                   device_busy_s=busy, idle_share=1.0 - busy / wall, kernels=n_kernels,
                   flash_device_s=b7_s, flash_share=b7_s / busy, peak_mem_bytes=peak,
                   flash_calls=cfg.num_layers, flash_max_abs_err=err,
                   flash_max_tolerance_share=excess, capacity=cap, pairs_per_layer=pairs,
                   dropped_by_layer=dropped,
                   top=[dict(kernel=k[:80], s=tt, count=c) for tt, c, k in by_name[:8]])
    return summary, counts, params, layer0


def moe_dispatch_phase(layer0: tuple, arch: str = MOE_ARCH) -> dict:
    """Layer 0's MoE block at full width on the prefill's own layer-0
    input under each dispatch, at the model's capacity factor and at 1.0
    (where the hot experts drop): the same kept (token, expert, rank) set,
    outputs within ``MOE_DISPATCH_TOL`` of ``sort``'s, and ``sort`` run
    twice giving the same bits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    base = get_config(arch)
    phase(f"{base.name} dispatch check (layer 0, full width)")
    p, x = layer0
    e, k = base.moe.num_routed_padded, base.moe.top_k
    t = x.shape[0] * x.shape[1]
    out = {}
    for cf in (base.moe.capacity_factor, MOE_DROP_CAPACITY_FACTOR):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
        cap = M.capacity(cfg.moe, t)
        outs, kept, walls = {}, {}, {}
        for disp in MOE_DISPATCHES:
            c = dataclasses.replace(cfg, moe_dispatch=disp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[disp], _ = M.moe_block(p, x, c)
            torch.cuda.synchronize()
            walls[disp] = time.perf_counter() - t0
            *_, top_e = M.route(p, x, c)
            tok, exp, rank, _, _ = M.dispatch_plan(top_e, e, disp)
            keep = rank < cap
            key = (tok * e + exp)[keep]  # a token never picks one expert twice
            order = torch.argsort(key)
            kept[disp] = torch.stack([key[order], rank[keep][order]])
        again, _ = M.moe_block(p, x, dataclasses.replace(cfg, moe_dispatch="sort"))
        check(torch.equal(again, outs["sort"]),
              f"{base.name} dispatch (cf {cf}): sort run twice differs")
        diffs = {}
        for disp in MOE_DISPATCHES[1:]:
            check(torch.equal(kept[disp], kept["sort"]),
                  f"{base.name} dispatch (cf {cf}): {disp} keeps another (token, expert, rank) set "
                  f"than sort")
            a, b = outs[disp].to(torch.float32), outs["sort"].to(torch.float32)
            diffs[disp] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, rtol=MOE_DISPATCH_TOL, atol=MOE_DISPATCH_TOL)),
                  f"{base.name} dispatch (cf {cf}): {disp} output differs from sort's by "
                  f"{diffs[disp]:.4g}")
        n_kept = kept["sort"].shape[1]
        ep_equal = torch.equal(outs["ep"], outs["sort"])
        print(f"{base.name} layer 0, T = {t}, capacity factor {cf} (capacity {cap}): sort, "
              f"cumsum and ep "
              f"keep the same {n_kept} (token, expert, rank) triples ({t * k - n_kept} of "
              f"{t * k} pairs dropped); outputs against sort's: max |diff| cumsum "
              f"{diffs['cumsum']:.4g}, ep {diffs['ep']:.4g} (ep bit-equal: {ep_equal}); sort "
              f"twice bit-equal; walls { {d: round(w, 4) for d, w in walls.items()} } s",
              flush=True)
        out[f"cf{cf}"] = dict(tokens=t, capacity=cap, kept=n_kept, dropped=t * k - n_kept,
                              max_abs_diff_vs_sort=diffs, ep_bit_equal=ep_equal,
                              sort_deterministic=True, wall_s=walls)
    check(out[f"cf{MOE_DROP_CAPACITY_FACTOR}"]["dropped"] > 0,
          f"{base.name} dispatch: nothing dropped at capacity factor {MOE_DROP_CAPACITY_FACTOR}")
    return out


def flash_timing(where: str, qkv: tuple, causal: bool = True) -> dict:
    """B7's sm90 kernel at a path's shape on the inputs of one of its calls,
    against its plain version, timed as :func:`flash_kernel_phase` times it
    (the bound counts the causal triangle or the full Sq x Sk rectangle),
    with one SDPA call on the same inputs as yardstick."""
    import torch.nn.functional as F

    FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    phase(f"kernel flash_attention (sm90 bf16) at the {where}'s shape")
    q, k, v = (a.contiguous() for a in qkv)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    check(FA._route_for(q.dtype, d) == "sm90", f"the {where}'s B7 call is not sm90")
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    got = FA._flash_attention(q, k, v, causal=causal, route="sm90")
    err, excess = fa_excess(got, want)
    del got, want
    check(excess <= 1.0, f"flash_attention_sm90 at the {where}'s shape: {excess:.3g} of the "
                         f"tolerance")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    pairs = sq * (sq + 1) // 2 if causal else sq * sk  # query-key pairs a head
    useful = 4 * d * pairs * b * hq
    # the kernel runs D as whole 64-column boxes (D = 96 as 128, the rest zero)
    padded = 4 * -(-d // 64) * 64 * pairs * b * hq
    if padded != useful:
        print(f"B7-sm90 at D = {d} runs as D = {-(-d // 64) * 64}: useful work {useful:.4g} "
              f"FLOP (the bound's), padded work {padded:.4g} FLOP "
              f"({padded / PEAK_BF16_FLOP_PER_S * 1e3:.4f} ms at the bf16 peak)", flush=True)
    kind = "causal" if causal else "non-causal"
    st = measure(f"flash_attention_sm90 (B={b}, Sq={sq}, Sk={sk}, Hq={hq}, Hkv={hkv}, D={d}, "
                 f"bfloat16, {kind})", err,
                 lambda *a: FA._flash_attention(*a, causal=causal, route="sm90"),
                 lambda *a: FA.flash_attention_plain(*a, causal=causal), (q, k, v),
                 nbytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(), ops=useful,
                 iters=200, plain_iters=3, ops_per_s=PEAK_BF16_FLOP_PER_S,
                 library=lambda *a: F.scaled_dot_product_attention(
                     *a, is_causal=causal, enable_gqa=hq != hkv),
                 library_args=(qt, kt, vt))
    return dict(st, shape=dict(B=b, Sq=sq, Sk=sk, Hq=hq, Hkv=hkv, D=d, dtype="bfloat16",
                               causal=causal), tolerance_share=excess, useful_flop=useful,
                padded_flop=padded)


def moe_smoke_path() -> dict[str, int]:
    """The MoE smoke configs in float32 (TF32 off) through
    ``make_prefill_step`` and three decode steps on the card and on the
    port's CPU: logits within 1e-4, every MoE call's ``top_e`` equal."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import Model

    phase("MoE smoke configs, float32, card against CPU")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the MoE smoke phase")
    dev = torch.device("cuda", 0)
    total = None
    for arch in MOE_SMOKE_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=torch.float32)
        model = Model(cfg)
        cpu = model.init(torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (2, MOE_SMOKE_LEN),
                             generator=torch.Generator().manual_seed(1))
        step = make_prefill_step(model)
        runs = {}
        for where, params in (("card", tree_map(lambda a: a.to(dev), cpu)), ("cpu", cpu)):
            d = dev if where == "card" else torch.device("cpu")
            if where == "card":
                torch.cuda.synchronize()
                KS.reset_launch_counts()
            tap = MoETap()
            with tap:
                logits = [step(params, {"tokens": toks.to(d)})]
                cache = model.init_cache(2, MOE_SMOKE_DECODE + 1, d)
                for i in range(MOE_SMOKE_DECODE):
                    out, cache = model.decode(params, toks[:, i:i + 1].to(d), cache)
                    logits.append(out[:, 0])
            if where == "card":
                torch.cuda.synchronize()
                counts = launch_counts()
                total = counts if total is None else {n: total[n] + c for n, c in counts.items()}
            runs[where] = ([t.cpu() for t in logits], tap.top_e)
        (got, got_e), (want, want_e) = runs["card"], runs["cpu"]
        diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-4) for a, b in zip(got, want)),
              f"moe smoke {arch}: card logits differ from the CPU run's by {diff:.3g}")
        check(len(got_e) == len(want_e) == cfg.num_layers * (1 + MOE_SMOKE_DECODE)
              and all(torch.equal(a, b) for a, b in zip(got_e, want_e)),
              f"moe smoke {arch}: the card routes differently from the CPU")
        print(f"{cfg.name} (float32): prefill 2 x {MOE_SMOKE_LEN} + {MOE_SMOKE_DECODE} decode "
              f"steps: logits equal the CPU run's within 1e-4 (max |diff| {diff:.3g}); "
              f"top_e of all {len(got_e)} MoE calls equal", flush=True)
    print(f"moe smoke launches (card): {total}", flush=True)
    return total


class LaunchDeviceTap:
    """While active, counts every kernel launch by (entry point, device) by
    wrapping ``_build.launch``, which every launcher calls with the device
    of its tensors; the wrapped call launches exactly what it would have."""

    def __enter__(self):
        from repro_torch.kernels import _build

        self._b, self._orig = _build, _build.launch
        self.launches = collections.Counter()

        def tapped(lib, name, *args, device):
            if device is not None:
                self.launches[(name, str(device))] += 1
            return self._orig(lib, name, *args, device=device)

        _build.launch = tapped
        return self

    def __exit__(self, *exc):
        self._b.launch = self._orig
        return False


def mesh_path(batch_rs) -> tuple[dict, dict]:
    """The lane mesh on the card: the Fig. 7 study at ``devices=1`` (counted;
    no shard call; every field equal to the batch run of phase 4), a count
    past the visible cards refused naming it, and — where two or more cards
    are visible — the study at ``devices=2`` equal to ``devices=1`` with the
    window loop's Bloom kernels launched on both cards.  Returns (summary,
    launch counts by leg)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import Study, all_workloads
    from repro_torch.sim import mesh as M

    phase("lane mesh: the Fig. 7 study at devices=1")
    n_cards = torch.cuda.device_count()
    shard_calls = []
    orig = M.shard_lanes

    def spy(fn, devices, device=None):
        shard_calls.append(devices)
        return orig(fn, devices, device)

    study = Study(all_workloads())
    M.shard_lanes = spy
    try:
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        rs = study.run(devices=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        M.shard_lanes = orig
    counts = {"mesh_fig7_devices1": launch_counts()}
    check(not shard_calls, f"devices=1 made {len(shard_calls)} shard calls")
    for name in FIG7_KERNELS:
        check(counts["mesh_fig7_devices1"][name] > 0, f"mesh devices=1: {name} never launched")
    exact_points(rs.points, batch_rs.points, "lane mesh devices=1 against the batch run")
    print(f"devices=1: {len(rs)} workloads in {wall:.2f} s wall, no shard call; every "
          f"SimResult field equals the batch run's; launches {counts['mesh_fig7_devices1']}",
          flush=True)
    try:
        study.run(devices=n_cards + 1)
    except ValueError as e:
        check(f"only {n_cards} visible" in str(e), f"devices={n_cards + 1}: {e}")
        print(f"devices={n_cards + 1} refused: {e}", flush=True)
    else:
        check(False, f"devices={n_cards + 1} ran on {n_cards} visible cards")
    summary = dict(cards=n_cards, devices1_wall_s=wall, shard_calls=0)
    if n_cards < 2:
        print(f"lane mesh: the devices=2 leg did not run: {n_cards} CUDA device visible, "
              f"it needs two", flush=True)
        summary["devices2"] = f"not run: {n_cards} card visible"
        return summary, counts
    phase("lane mesh: the Fig. 7 study at devices=2")
    with LaunchDeviceTap() as tap:
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        rs2 = study.run(devices=2)
        for i in range(2):
            torch.cuda.synchronize(i)
        wall2 = time.perf_counter() - t0
    counts["mesh_fig7_devices2"] = launch_counts()
    exact_points(rs2.points, rs.points, "lane mesh devices=2 against devices=1")
    by_card = {f"cuda:{i}": sorted(n for n, d in tap.launches if d == f"cuda:{i}")
               for i in range(2)}
    for card_name, names in by_card.items():
        for entry in ("bloom_insert", "bloom_query", "bloom_intersect"):
            check(any(n.startswith(entry) for n in names),
                  f"devices=2: no {entry} launch on {card_name} ({names})")
    print(f"devices=2: {wall2:.2f} s wall; every SimResult field equals devices=1; "
          f"launches by (entry point, card) {dict(tap.launches)}", flush=True)
    summary.update(devices2_wall_s=wall2,
                   devices2_launches={f"{n}@{d}": c for (n, d), c in tap.launches.items()})
    return summary, counts


def ssm_prefill_path() -> tuple[dict, dict, dict]:
    """falcon-mamba-7b at full width and depth on the card: prefill steps of
    ``SSM_PREFILL_BATCH`` x 4,096 tokens, counted (the model runs no kernel
    of the package: its products and scan are PyTorch ops, as the
    reference's are outside Pallas), unprofiled (wall, peak memory) and
    profiled (idle share, top kernels).  Returns (summary, launch counts of
    the counted run, params)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model

    phase("falcon-mamba-7b prefill")
    dev = torch.device("cuda", 0)
    cfg = get_config(SSM_ARCH)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.param_count()
    di = cfg.ssm.expand * cfg.d_model
    print(f"{cfg.name}: {cfg.num_layers} mamba layers, d_model {cfg.d_model}, d_inner {di}, "
          f"d_state {cfg.ssm.d_state}, vocab {cfg.vocab}; {n_params} parameters "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated) initialised in "
          f"{init_s:.2f} s", flush=True)
    shape = (SSM_PREFILL_BATCH, PREFILL_LEN)
    tokens = torch.randint(0, cfg.vocab_size, shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    step = make_prefill_step(model)
    batch = {"tokens": tokens}
    step(params, {"tokens": tokens[:, :256]})  # warm-up: cuBLAS handles
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = step(params, batch)
    torch.cuda.synchronize()
    counted_wall = time.perf_counter() - t0
    counts = launch_counts()
    check(sum(counts.values()) == 0,
          f"mamba prefill: the SSM stack launched kernels of the package: {counts}")
    check(tuple(last.shape) == (shape[0], cfg.vocab) and
          bool(last.to(torch.float32).isfinite().all()),
          f"mamba prefill: last-position logits {tuple(last.shape)} not finite")
    del last
    term_gb = shape[0] * shape[1] * di * cfg.ssm.d_state * 4 / 1e9
    print(f"mamba prefill (counted) {shape[0]} x {shape[1]}: {counted_wall:.3f} s wall; "
          f"no kernel of the package launched; each (B, S, d_inner, d_state) float32 scan "
          f"term {term_gb:.2f} GB", flush=True)
    wall, peak, busy, n_kernels, by_name, _ = time_and_profile(lambda: step(params, batch))
    t = shape[0] * shape[1]
    print(f"mamba prefill: {wall:.4f} s wall ({t / wall:.0f} tokens/s); device busy "
          f"{busy:.4f} s in {n_kernels} kernels (idle share {1.0 - busy / wall:.3f}); peak "
          f"memory allocated {peak / 2**30:.2f} GiB (the {n_params * 2 / 2**30:.2f} GiB of "
          f"weights included) at {shape[0]} x {shape[1]} tokens", flush=True)
    summary = dict(batch=shape[0], seq=shape[1], layers=cfg.num_layers, params=n_params,
                   init_s=init_s, wall_s=wall, counted_wall_s=counted_wall,
                   tokens_per_s=t / wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
                   kernels=n_kernels, peak_mem_bytes=peak, scan_term_bytes=term_gb * 1e9,
                   top=[dict(kernel=k[:80], s=tt, count=c) for tt, c, k in by_name[:8]])
    return summary, counts, params


def ssm_block_check(params: dict) -> dict:
    """Layer 0's ``ssm_block`` at full width in float32 (TF32 off) on the card
    against the same call on the CPU: the weights cast to float32, the
    input the embeddings of ``SSM_CHECK_LEN`` seeded tokens; within rtol
    ``SSM_CHECK_TOL`` and an atol of ``SSM_CHECK_TOL`` times the output's
    largest magnitude."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map

    phase("falcon-mamba-7b layer 0 ssm_block, float32, card against CPU")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the ssm_block check")
    cfg = dataclasses.replace(get_config(SSM_ARCH), param_dtype=torch.float32)
    p = tree_map(lambda a: a.to(torch.float32), T._index(params["stack"]["period"][0], 0))
    p = p["mixer"]
    toks = torch.randint(0, cfg.vocab_size, (1, SSM_CHECK_LEN),
                         generator=torch.Generator().manual_seed(3))
    x = params["embed"][toks.to(params["embed"].device)].to(torch.float32) * cfg.d_model ** 0.5
    t0 = time.perf_counter()
    got = SSM.ssm_block(p, x, cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = SSM.ssm_block(tree_map(lambda a: a.cpu(), p), x.cpu(), cfg)
    cpu_s = time.perf_counter() - t0
    got = got.cpu()
    diff, scale = float((got - want).abs().max()), float(want.abs().max())
    check(scale > 0 and bool(torch.allclose(got, want, rtol=SSM_CHECK_TOL,
                                            atol=SSM_CHECK_TOL * scale)),
          f"ssm_block layer 0: card differs from the CPU by {diff:.3g} (max |out| {scale:.3g})")
    print(f"ssm_block layer 0 (float32, 1 x {SSM_CHECK_LEN} tokens, d_inner "
          f"{cfg.ssm.expand * cfg.d_model}): card equals the CPU within rtol {SSM_CHECK_TOL}, "
          f"atol {SSM_CHECK_TOL} x max |out| (max |diff| {diff:.3g}, max |out| {scale:.4g}, "
          f"{diff / scale:.3g} of it); card {card_s:.3f} s, CPU {cpu_s:.3f} s", flush=True)
    return dict(tokens=SSM_CHECK_LEN, max_abs_diff=diff, rtol=SSM_CHECK_TOL,
                atol=SSM_CHECK_TOL * scale, max_abs_out=scale)


def hybrid_prefill_path() -> tuple[dict, dict, dict, tuple]:
    """recurrentgemma-2b at full width and depth on the card: prefill steps
    of 4 x 4,096 tokens — counted and tapped (exactly one sm90 B7 launch a
    ``swa`` layer, 8, each held to its plain version), unprofiled (wall,
    peak memory) and profiled (idle share, B7's share).  Returns (summary,
    launch counts of the counted run, params, layer 2's B7 inputs)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model

    phase("recurrentgemma-2b prefill")
    dev = torch.device("cuda", 0)
    cfg = get_config(HYBRID_ARCH)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.param_count()
    n_swa = cfg.pattern.count("swa")
    print(f"{cfg.name}: {cfg.num_layers} layers ({cfg.pattern.count('rglru')} rglru, {n_swa} "
          f"swa at window {cfg.window_size}), d_model {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} kv head x {cfg.head_dim}, lru width "
          f"{cfg.recurrent.lru_width}, vocab {cfg.vocab}; {n_params} parameters "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated) initialised in "
          f"{init_s:.2f} s", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    step = make_prefill_step(model)
    batch = {"tokens": tokens}
    step(params, {"tokens": tokens[:, :256]})  # warm-up: cuBLAS handles, kernels
    torch.cuda.synchronize()
    tap = FlashTap()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    with tap:
        last = step(params, batch)
    torch.cuda.synchronize()
    counted_wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["flash_attention_sm90"] == n_swa and counts["flash_attention_general"] == 0,
          f"hybrid prefill: {counts['flash_attention_sm90']} flash_attention launches on the "
          f"sm90 route and {counts['flash_attention_general']} on the general one, want "
          f"exactly {n_swa} (one a swa layer), all sm90 (bf16, D = {cfg.head_dim})")
    check(len(tap.calls) == n_swa and all(c[4] == cfg.window_size for c in tap.calls),
          f"hybrid prefill: {len(tap.calls)} ops.mha calls, windows "
          f"{[c[4] for c in tap.calls]}")
    check(tuple(last.shape) == (PREFILL_BATCH, cfg.vocab) and
          bool(last.to(torch.float32).isfinite().all()),
          f"hybrid prefill: last-position logits {tuple(last.shape)} not finite")
    err, excess = tap.check("hybrid prefill")
    print(f"hybrid prefill (counted): {counted_wall:.3f} s wall; launches {counts}; all "
          f"{len(tap.calls)} flash_attention calls (sm90 route, Hq {cfg.num_heads} on Hkv "
          f"{cfg.num_kv_heads}, D {cfg.head_dim}, window {cfg.window_size}) within tolerance "
          f"of their plain versions (max |diff| {err:.4g}, at most {excess:.3g} of the "
          f"tolerance)", flush=True)
    qkv = tap.calls[0][:3]
    del tap, last
    gc.collect()
    wall, peak, busy, n_kernels, by_name, b7_s = time_and_profile(
        lambda: step(params, batch))
    t = PREFILL_BATCH * PREFILL_LEN
    print(f"hybrid prefill: {wall:.4f} s wall ({t / wall:.0f} tokens/s); device busy "
          f"{busy:.4f} s in {n_kernels} kernels (idle share {1.0 - busy / wall:.3f}), B7 "
          f"{b7_s:.4f} s of it ({b7_s / busy:.3f}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB (the {n_params * 2 / 2**30:.2f} GiB of weights "
          f"included)", flush=True)
    summary = dict(batch=PREFILL_BATCH, seq=PREFILL_LEN, layers=cfg.num_layers,
                   params=n_params, init_s=init_s, wall_s=wall,
                   counted_wall_s=counted_wall, tokens_per_s=t / wall, device_busy_s=busy,
                   idle_share=1.0 - busy / wall, kernels=n_kernels, flash_device_s=b7_s,
                   flash_share=b7_s / busy, peak_mem_bytes=peak, flash_calls=n_swa,
                   flash_max_abs_err=err, flash_max_tolerance_share=excess,
                   top=[dict(kernel=k[:80], s=tt, count=c) for tt, c, k in by_name[:8]])
    return summary, counts, params, qkv


def hybrid_flash_timing(qkv: tuple, window: int) -> dict:
    """B7's sm90 kernel at recurrentgemma's shape (GQA 10 on 1, D = 256,
    causal under a ``window``-token band) on layer 2's inputs, against its
    plain version, timed as :func:`flash_kernel_phase` times it; its bound
    counts the FLOPs inside the band only.  SDPA with an explicit boolean
    band mask is the yardstick (a mask takes it off its flash backend)."""
    import torch
    import torch.nn.functional as F

    FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    phase("kernel flash_attention (sm90 bf16) at the hybrid prefill's shape (window)")
    q, k, v = (a.contiguous() for a in qkv)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    check(FA._route_for(q.dtype, d) == "sm90", "the hybrid prefill's B7 call is not sm90")
    want = FA.flash_attention_plain(q, k, v, causal=True, window=window)
    got = FA._flash_attention(q, k, v, causal=True, window=window, route="sm90")
    err, excess = fa_excess(got, want)
    check(excess <= 1.0, f"flash_attention_sm90 at the hybrid shape: {excess:.3g} of the "
                         f"tolerance (max |diff| {err:.4g})")
    pos = torch.arange(s, device=q.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)
    lib_err = float((lib.transpose(1, 2).to(torch.float32)
                     - want.to(torch.float32)).abs().max())
    del got, want, lib
    pairs = sum(min(i + 1, window) for i in range(s))  # query-key pairs in the band, a head
    useful = 4 * d * pairs * b * hq
    st = measure(f"flash_attention_sm90 (B={b}, S={s}, Hq={hq}, Hkv={hkv}, D={d}, bfloat16, "
                 f"causal, window {window}; library: SDPA with a boolean band mask)", err,
                 lambda *a: FA._flash_attention(*a, causal=True, window=window, route="sm90"),
                 lambda *a: FA.flash_attention_plain(*a, causal=True, window=window),
                 (q, k, v), nbytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(),
                 ops=useful, iters=200, plain_iters=3, ops_per_s=PEAK_BF16_FLOP_PER_S,
                 library=lambda *a: F.scaled_dot_product_attention(
                     *a, attn_mask=band, enable_gqa=True),
                 library_args=(qt, kt, vt))
    print(f"hybrid shape: {pairs} query-key pairs a head inside the band "
          f"({useful:.4g} FLOP); SDPA (band mask) against plain {lib_err:.4g}", flush=True)
    return dict(st, shape=dict(B=b, S=s, Hq=hq, Hkv=hkv, D=d, dtype="bfloat16", causal=True,
                               window=window),
                tolerance_share=excess, useful_flop=useful, band_pairs_per_head=pairs,
                library_call="torch.nn.functional.scaled_dot_product_attention"
                             "(attn_mask=<bool band>, enable_gqa=True)",
                library_max_abs_diff_vs_plain=lib_err)


def arch_serve_path(arch: str, serve_args: dict, params: dict) -> tuple[dict, dict]:
    """The port's serve loop at full width for ``arch`` with the reference
    loop's defaults on ``params``, and its decode step profiled.  The cache
    is the reference's: one per loop, shared by the slots, the SSM / RG-LRU
    states included.  Returns (summary, launch counts)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    phase(f"{cfg.name} serve")
    if T._ring_cache(cfg):
        slots = min(serve_args["max_len"], cfg.window_size)
        print(f"ring KV cache of {slots} slots (min(max_len {serve_args['max_len']}, window "
              f"{cfg.window_size})); the loop stops after max_len - 1 = "
              f"{serve_args['max_len'] - 1} steps, so the ring does not wrap in this run "
              f"(it would past {slots} positions)", flush=True)
    return serve_and_decode(f"{cfg.name} serve", Model(cfg), params, serve_args)


class CheckedFlashTap:
    """While active, holds every ``ops.mha`` call the model zoo makes to the
    kernel's plain version as it happens (:func:`fa_excess`; the plain
    version launches nothing, so nothing is counted) and keeps only the
    inputs of the first call of each kind — (causal, Sq, Sk) — so a path
    whose calls would not all fit on the card beside it is checked whole."""

    def __init__(self, label: str):
        self.label, self.kinds, self.first = label, collections.Counter(), {}
        self.err = self.excess = 0.0

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
        self._ops, self._orig = ops, ops.mha

        def tapped(q, k, v, *, causal=True, window=0):
            out = self._orig(q, k, v, causal=causal, window=window)
            want = FA.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                            causal=causal, window=window)
            e, x = fa_excess(out, want)
            del want
            kind = (causal, q.shape[1], k.shape[1])
            check(x <= 1.0, f"{self.label}: flash_attention call {sum(self.kinds.values())} "
                            f"{kind} disagrees with its plain version (max |diff| {e:.4g}, "
                            f"{x:.3g} of the tolerance)")
            self.err, self.excess = max(self.err, e), max(self.excess, x)
            self.kinds[kind] += 1
            self.first.setdefault(kind, (q, k, v))
            return out

        ops.mha = tapped
        return self

    def __exit__(self, *exc):
        self._ops.mha = self._orig
        return False


def frontend_prefill_path(arch: str, want_kinds: dict) -> tuple[dict, dict, dict]:
    """An enc-dec or VLM arch at full width and depth on the card, bf16
    weights from a seeded generator: ``make_prefill_step`` on 4 x 4,096
    tokens plus frontend embeddings of ``synth_embeddings``' shape and
    distribution (N(0, 0.02) in bf16: the encoder's frames or the vision
    prefix) drawn on the card from ``FRONTEND_SEED`` (the reference's bits,
    which ``synth_embeddings`` draws on the host in ~17 s, are what the
    CPU tests hold; no check here reads them),
    three times — counted and checked (exactly ``want_kinds`` sm90 B7
    launches by (causal, Sq, Sk), every one held to its plain version as
    it happens), unprofiled (wall, tokens/s, peak memory) and profiled
    (idle share, B7's share).  Returns (summary, launch counts of the
    counted run, the first call's inputs of each kind)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.frontends import frontend_tokens
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    phase(f"{cfg.name} prefill ({cfg.family})")
    dev = torch.device("cuda", 0)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.param_count()
    t0 = time.perf_counter()
    emb = (torch.randn((PREFILL_BATCH, frontend_tokens(cfg, PREFILL_LEN), cfg.d_model),
                       generator=torch.Generator(device=dev).manual_seed(FRONTEND_SEED),
                       device=dev) * 0.02).to(torch.bfloat16)
    torch.cuda.synchronize()
    emb_s = time.perf_counter() - t0
    key = "frames" if cfg.encoder_layers > 0 else "prefix_embeds"
    print(f"{cfg.name}: {cfg.num_layers} decoder layers, {cfg.encoder_layers} encoder layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv heads x "
          f"{cfg.head_dim}, vocab {cfg.vocab}; {n_params} parameters "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated) initialised in "
          f"{init_s:.2f} s; {key} {tuple(emb.shape)} {emb.dtype} drawn in {emb_s:.2f} s",
          flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    step = make_prefill_step(model)
    batch = {"tokens": tokens, key: emb}
    step(params, {"tokens": tokens[:, :256], key: emb[:, :64]})  # warm-up
    torch.cuda.synchronize()
    n_calls = sum(want_kinds.values())
    tap = CheckedFlashTap(f"{cfg.name} prefill")
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    with tap:
        last = step(params, batch)
    torch.cuda.synchronize()
    counted_wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["flash_attention_sm90"] == n_calls and counts["flash_attention_general"] == 0,
          f"{cfg.name} prefill: {counts['flash_attention_sm90']} flash_attention launches on "
          f"the sm90 route and {counts['flash_attention_general']} on the general one, want "
          f"exactly {n_calls}, all sm90 (bf16, D = {cfg.head_dim})")
    check(dict(tap.kinds) == want_kinds, f"{cfg.name} prefill: B7 calls by (causal, Sq, Sk) "
                                         f"{dict(tap.kinds)}, want {want_kinds}")
    check(tuple(last.shape) == (PREFILL_BATCH, cfg.vocab) and
          bool(last.to(torch.float32).isfinite().all()),
          f"{cfg.name} prefill: last-position logits {tuple(last.shape)} not finite")
    print(f"{cfg.name} prefill (counted, each B7 call checked as it ran): {counted_wall:.3f} s "
          f"wall; launches {counts}; calls by (causal, Sq, Sk) {dict(tap.kinds)}, all within "
          f"tolerance of their plain versions (max |diff| {tap.err:.4g}, at most "
          f"{tap.excess:.3g} of the tolerance)", flush=True)
    first, err, excess = tap.first, tap.err, tap.excess
    del tap, last
    gc.collect()
    wall, peak, busy, n_kernels, by_name, b7_s = time_and_profile(lambda: step(params, batch))
    t = PREFILL_BATCH * PREFILL_LEN
    print(f"{cfg.name} prefill: {wall:.4f} s wall ({t / wall:.0f} tokens/s); device busy "
          f"{busy:.4f} s in {n_kernels} kernels (idle share {1.0 - busy / wall:.3f}), B7 "
          f"{b7_s:.4f} s of it ({b7_s / busy:.3f}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB (the {n_params * 2 / 2**30:.2f} GiB of weights included)",
          flush=True)
    summary = dict(batch=PREFILL_BATCH, seq=PREFILL_LEN, frontend=list(emb.shape),
                   layers=cfg.num_layers, encoder_layers=cfg.encoder_layers, params=n_params,
                   init_s=init_s, frontend_draw_s=emb_s, wall_s=wall,
                   counted_wall_s=counted_wall, tokens_per_s=t / wall, device_busy_s=busy,
                   idle_share=1.0 - busy / wall, kernels=n_kernels, flash_device_s=b7_s,
                   flash_share=b7_s / busy, peak_mem_bytes=peak,
                   flash_calls={str(k): n for k, n in want_kinds.items()},
                   flash_max_abs_err=err, flash_max_tolerance_share=excess,
                   top=[dict(kernel=k[:80], s=tt, count=c) for tt, c, k in by_name[:8]])
    del params, batch, emb
    return summary, counts, first


def _sum_counts(runs: list[dict]) -> dict:
    out = collections.Counter()
    for c in runs:
        out.update(c)
    return dict(out)


def start_dryrun() -> subprocess.Popen:
    """Start the dry-run process (:data:`DRYRUN_SCRIPT`): no CUDA device
    visible to it, one thread, lowered priority, so the card phases beside
    it keep their host; its output and errors to temporary files
    (``proc.out`` and ``proc.err``), which nothing has to drain while it
    runs."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    phase(f"dry run started in its own process ({DRYRUN_ARCH} "
          f"{', '.join(DRYRUN_SHAPES)} on the 16 x 16 and 2 x 16 x 16 fake meshes, the "
          f"roofline of {DRYRUN_SHAPES[0]}, the card's training cell on one rank)")
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_SCRIPT, DRYRUN_ARCH, ",".join(DRYRUN_SHAPES),
         str(TRAIN_BATCH), str(TRAIN_LEN)],
        env=env, cwd=str(ROOT), stdout=out, stderr=err, text=True,
        preexec_fn=lambda: os.nice(10))
    proc.out, proc.err = out, err
    return proc


def _read_dryrun(proc: subprocess.Popen) -> tuple[str, str]:
    """The dry-run process's output and errors, its files closed."""
    texts = []
    for f in (proc.out, proc.err):
        f.seek(0)
        texts.append(f.read())
        f.close()
    return texts[0], texts[1]


def dryrun_phase(proc: subprocess.Popen, training: dict) -> dict:
    """Read the dry-run process: every cell traced, with per-device FLOPs,
    bytes and memory; the roofline's three terms; and the card's own
    training cell on a one-rank mesh, whose argument bytes must equal the
    bytes of the training phase's live parameters, moments, step counter
    and batch exactly.  Its predicted peak (argument + temp bytes) is
    printed beside the training phase's ``torch.cuda.max_memory_allocated``."""
    phase("dry run (read)")
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        _read_dryrun(proc)
        raise SmokeFailure(f"dry run: no result in {DRYRUN_TIMEOUT_S} s")
    out, err = _read_dryrun(proc)
    check(proc.returncode == 0, f"dry run failed (exit {proc.returncode}): {err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    for c in res["cells"]:
        m = c["memory"]
        check(c["flops"] > 0 and c["bytes_accessed"] > 0 and m["argument_size_in_bytes"] > 0,
              f"dry run {c['shape']} on {c['mesh']}: {c}")
        print(f"dry run {c['arch']} {c['shape']} {c['mesh']}: {c['wall_s']:.1f} s; per device "
              f"{c['flops']:.4e} FLOP, {c['bytes_accessed']:.4e} bytes accessed, arguments "
              f"{m['argument_size_in_bytes'] / 2**30:.3f} GiB, temp "
              f"{m['temp_size_in_bytes'] / 2**30:.3f} GiB, collectives "
              f"{c['collectives']['total'] / 2**30:.3f} GiB "
              f"({', '.join(k for k in c['collectives'] if k != 'total')})", flush=True)
    a = res["analysis"]
    print(f"roofline {a['arch']} {a['shape']} {a['mesh']} ({a['wall_s']:.1f} s): compute "
          f"{a['t_compute_s'] * 1e3:.2f} ms, memory {a['t_memory_s'] * 1e3:.2f} ms, collective "
          f"{a['t_collective_s'] * 1e3:.2f} ms (dominant {a['dominant']}); useful "
          f"{a['useful_ratio']:.3f}, roofline fraction {a['roofline_fraction']:.3f}", flush=True)
    card = res["card_cell"]
    m = card["memory"]
    check(m["argument_size_in_bytes"] == training["argument_bytes"],
          f"dry run of the card's training cell: {m['argument_size_in_bytes']} argument bytes, "
          f"the training phase's live parameters, moments and batch hold "
          f"{training['argument_bytes']}")
    predicted = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
    measured = training["peak_mem_bytes"]
    print(f"dry run of the card's training cell ({TRAIN_BATCH} x {TRAIN_LEN}, one rank, "
          f"{card['wall_s']:.1f} s): argument bytes {m['argument_size_in_bytes']} = the live "
          f"tensors' exactly; predicted peak {predicted / 2**30:.2f} GiB (arguments + "
          f"{m['temp_size_in_bytes'] / 2**30:.2f} GiB temp) against "
          f"torch.cuda.max_memory_allocated {measured / 2**30:.2f} GiB, ratio "
          f"{predicted / measured:.3f}; {card['flops']:.4e} FLOP", flush=True)
    return dict(cells=res["cells"], analysis=a, card_cell=card,
                card_predicted_peak_bytes=predicted, card_measured_peak_bytes=measured,
                card_peak_ratio=predicted / measured)


def _tensor_bytes(*trees) -> int:
    from repro_torch.models.common import tree_leaves

    return sum(t.numel() * t.element_size() for tree in trees for t in tree_leaves(tree))


def train_path(policy: str = "nothing") -> tuple[dict, dict]:
    """qwen3-4b trained at full width and depth on the card: ``launch.train
    .build``'s model and AdamW (float32 moments, remat on, under
    ``remat_policy=policy``), seeded bf16
    weights, ``TRAIN_STEPS`` steps of ``make_train_step`` on
    ``data.pipeline.host_batch``'s 1 x 4,096 tokens.  Each step: exactly one
    sm90 B7 launch a layer in the forward pass and one more a layer in
    remat's recompute (the backward differentiates ``mha_chunked``, no B7),
    every one held to its plain version as it runs (:class:`CheckedFlashTap`);
    the loss and gradient norm finite.  After the steps every parameter
    leaf has changed; ``TRAIN_TIMED_STEPS`` more run unchecked (step wall,
    tokens/s, peak memory, memory allocated when the forward ends).  Under
    ``"nothing"`` only: one more step under the profiler: device busy,
    top kernels, and attention's device time, the kernels launched under
    ``models.attention.PROFILE_RANGES`` and B7's own (the forward and
    recompute; the ``mha_chunked`` backward).  Then layer 0's attention block in float32 (the
    general B7 route; its backward the autograd function's), its gradient
    on ``TRAIN_CHECK_LEN`` tokens against the CPU's.  Returns (summary,
    launch counts of the steps)."""
    import argparse

    import numpy as np
    import torch

    from repro_torch import kernels as KS
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.launch import train as TR
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import attention as A
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    phase(f"{TRAIN_ARCH} training, remat_policy={policy!r} ({TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_LEN} tokens)")
    dev = torch.device("cuda", 0)
    cfg, model, opt_cfg, _ = TR.build(argparse.Namespace(
        arch=TRAIN_ARCH, smoke=False, lr=TRAIN_LR,
        steps=TRAIN_STEPS + TRAIN_TIMED_STEPS + 1))
    if policy != cfg.remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=policy)
        model = Model(cfg)
    check(cfg.remat and cfg.remat_policy == policy and opt_cfg.moment_dtype ==
          torch.float32, f"{cfg.name}: remat {cfg.remat} ({cfg.remat_policy}), moments "
                         f"{opt_cfg.moment_dtype}")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    before = [t.cpu() for t in tree_leaves(params)]
    forward_counts, forward_mem = [], []

    class Counted:
        """``model`` whose ``loss`` notes the launches of the forward pass
        and the memory allocated when it ends (what the backward holds)."""
        @staticmethod
        def loss(p, batch):
            out = model.loss(p, batch)
            forward_counts.append(launch_counts())
            forward_mem.append(torch.cuda.memory_allocated())
            return out

    train_step = make_train_step(Counted, opt_cfg)
    opt_state = adamw.init(params, opt_cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_LEN, global_batch=TRAIN_BATCH)
    # what the step takes: parameters, moments, step counter and one batch
    argument_bytes = _tensor_bytes(params, opt_state, host_batch(data, 0, dev))
    n = cfg.num_layers
    tap = CheckedFlashTap(f"{cfg.name} training, remat {policy!r}")
    losses, norms, step_counts = [], [], []

    def one_step(i):
        metrics = train_step(params, opt_state, host_batch(data, i, dev))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"train ({policy}) step {i}: loss {loss}, grad norm {gnorm}")
        losses.append(loss)
        norms.append(gnorm)
        return float(metrics["lr"])

    for i in range(TRAIN_STEPS):
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        with tap:
            lr = one_step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        step_counts.append(counts)
        fwd = forward_counts[-1]
        check(fwd["flash_attention_sm90"] == n and fwd["flash_attention_general"] == 0,
              f"train ({policy}) step {i}: {fwd['flash_attention_sm90']} sm90 / "
              f"{fwd['flash_attention_general']} general B7 launches in the forward pass, "
              f"want exactly {n} sm90 (one a layer)")
        check(counts["flash_attention_sm90"] == 2 * n and counts["flash_attention_general"] == 0,
              f"train ({policy}) step {i}: {counts['flash_attention_sm90']} sm90 B7 launches a "
              f"step, want {2 * n} ({n} forward, {n} in remat's recompute)")
        print(f"train ({policy}) step {i}: loss {losses[-1]:.4f}, grad norm {norms[-1]:.4f}, "
              f"lr {lr:.3e}, {wall:.3f} s with every B7 call checked; B7 {n} forward + "
              f"{counts['flash_attention_sm90'] - n} recompute launches", flush=True)
    kind = (True, TRAIN_LEN, TRAIN_LEN)
    check(dict(tap.kinds) == {kind: 2 * n * TRAIN_STEPS},
          f"train ({policy}): B7 calls held to plain by kind {dict(tap.kinds)}, want "
          f"{{{kind}: {2 * n * TRAIN_STEPS}}}")
    tap.first.clear()
    unchanged = [i for i, (a, b) in enumerate(zip(tree_leaves(params), before))
                 if torch.equal(a.cpu(), b)]
    check(not unchanged, f"train ({policy}): parameter leaves {unchanged} unchanged after "
                         f"{TRAIN_STEPS} steps")
    print(f"train ({policy}): all {len(tree_leaves(params))} parameter leaves changed; "
          f"{sum(tap.kinds.values())} B7 calls within {tap.excess:.3g} of the tolerance of "
          f"their plain version (max |diff| {tap.err:.4g})", flush=True)
    del before
    # unchecked steps: the step's wall, tokens/s and peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(walls))
    print(f"train ({policy}): median step {step_s:.4f} s of {TRAIN_TIMED_STEPS} unchecked "
          f"({TRAIN_BATCH * TRAIN_LEN / step_s:.0f} tokens/s); peak memory allocated "
          f"{peak / 2**30:.2f} GiB; allocated when the forward ends "
          f"{forward_mem[-1] / 2**30:.2f} GiB", flush=True)
    summary = dict(arch=cfg.name, policy=policy, steps=TRAIN_STEPS,
                   timed_steps=TRAIN_TIMED_STEPS, batch=TRAIN_BATCH, seq=TRAIN_LEN, lr=TRAIN_LR,
                   remat=cfg.remat, argument_bytes=argument_bytes,
                   forward_end_mem_bytes=forward_mem[-1], moment_dtype="float32",
                   step_walls_s=walls, median_step_s=step_s,
                   tokens_per_s=TRAIN_BATCH * TRAIN_LEN / step_s,
                   peak_mem_bytes=peak, losses=losses, grad_norms=norms,
                   flash_launches_per_step=dict(forward=n, recompute=n),
                   flash_checked=dict(calls=sum(tap.kinds.values()), max_abs_err=tap.err,
                                      tolerance_share=tap.excess))
    if policy != "nothing":
        del params, opt_state
        gc.collect()
        torch.cuda.empty_cache()
        return summary, _sum_counts(step_counts)
    # one more step under the profiler (not counted): device busy time, top
    # kernels, and attention's part: the kernels launched under its ranges
    step_i = TRAIN_STEPS + TRAIN_TIMED_STEPS
    busy, n_kernels, top, by_range = device_busy_by_range_s(
        lambda: one_step(step_i), A.PROFILE_RANGES, top=None)
    for t, c, name in top[:8]:
        print(f"  {t:9.4f} s {c:5d}x  {name[:100]}")
    # the profiler ties no kernel of a ctypes library to a host range: B7's
    # own kernels, counted by name, all launch inside the forward range
    b7 = [(t, c) for t, c, name in top if "flash_attention" in name]
    b7_s, b7_n = sum(t for t, _ in b7), sum(c for _, c in b7)
    fwd_s, bwd_s = (by_range[r] for r in A.PROFILE_RANGES)
    check(b7_n == 2 * n and bwd_s > 0, f"train: the profiled step launched B7 {b7_n} times "
                                       f"(want {2 * n}); ranges {by_range}")
    fwd_s += b7_s
    attn_s = fwd_s + bwd_s
    print(f"train step profiled: device busy {busy:.4f} s in {n_kernels} kernels (idle share "
          f"{1.0 - busy / step_s:.3f} of the median step); attention {attn_s:.4f} s of it "
          f"({attn_s / busy:.3f}): B7 forward + recompute {fwd_s:.4f} s (B7's kernels "
          f"{b7_s:.4f} s), mha_chunked backward {bwd_s:.4f} s", flush=True)
    del opt_state
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"{TRAIN_ARCH} layer 0 attention gradient, float32, card against CPU")
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
    layer0 = {k: v[0].detach().to(torch.float32).cpu()
              for k, v in params["stack"]["period"][0]["mixer"].items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, TRAIN_CHECK_LEN, cfg.d_model), generator=gen)
    g = torch.randn((1, TRAIN_CHECK_LEN, cfg.d_model), generator=gen)

    def grads(where):
        p = {k: v.to(where).requires_grad_() for k, v in layer0.items()}
        xx = x.to(where).requires_grad_()
        out = A.attn_block(p, xx, cfg32)
        names = list(p) + ["x"]
        return dict(zip(names, torch.autograd.grad(out, list(p.values()) + [xx], g.to(where))))

    KS.reset_launch_counts()
    card = grads(dev)
    torch.cuda.synchronize()
    check(launch_counts()["flash_attention_general"] == 1, "the float32 attention block did "
                                                           "not launch B7 once (general route)")
    cpu = grads("cpu")
    worst = 0.0
    for name, want in cpu.items():
        got = card[name].cpu()
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        check(torch.allclose(got, want, rtol=TRAIN_GRAD_TOL, atol=TRAIN_GRAD_TOL * scale),
              f"train: layer 0's {name} gradient on the card is {rel:.3g} (of its largest "
              f"entry) from the CPU's")
    for name in ("wq", "wk", "wv"):
        check(bool((card[name] != 0).any()), f"train: the card's {name} gradient is zero")
    print(f"layer 0 attention block, float32, {TRAIN_CHECK_LEN} tokens: every gradient "
          f"({', '.join(cpu)}) within {worst:.3g} (of its largest entry) of the CPU's; wq / wk "
          f"/ wv gradients nonzero on the card", flush=True)
    summary.update(profiled_device_busy_s=busy, profiled_kernels=n_kernels,
                   idle_share=1.0 - busy / step_s,
                   top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in top[:8]],
                   attention_device_s=dict(forward=fwd_s, backward=bwd_s, b7_kernels=b7_s),
                   attention_share_of_busy=attn_s / busy,
                   layer0_grad_check=dict(tokens=TRAIN_CHECK_LEN, max_rel=worst,
                                          tol=TRAIN_GRAD_TOL))
    return summary, _sum_counts(step_counts)


def train_dots_path(nothing: dict) -> tuple[dict, dict]:
    """:func:`train_path` under ``remat_policy="dots"`` (the products with no
    batch dimension saved, everything else recomputed), beside the
    ``"nothing"`` phase's summary: from the same seeded parameters and the
    same batches, every step's loss and gradient norm (the checked steps'
    and the unchecked ones') equal ``"nothing"``'s bit for bit (the
    gradient flows through the saved products where ``"nothing"``
    recomputes them), and more memory is held when the forward ends (the
    saved products).  Prints both policies' median step and peak memory."""
    dots, counts = train_path("dots")
    k = len(dots["losses"])
    for key in ("losses", "grad_norms"):
        got, want = dots[key], nothing[key][:k]
        check(got == want, f"train, remat 'dots': {key} {got!r}, 'nothing''s {want!r} (same "
                           f"parameters and batches): not bit for bit")
    fwd, nothing_fwd = dots["forward_end_mem_bytes"], nothing["forward_end_mem_bytes"]
    check(fwd > nothing_fwd, f"train, remat 'dots': {fwd} bytes held when the forward ends, "
                             f"'nothing' holds {nothing_fwd}: no product was saved")
    print(f"train, remat 'dots': the losses and gradient norms of all {k} steps equal "
          f"'nothing''s bit for bit; median step {dots['median_step_s']:.4f} s against "
          f"{nothing['median_step_s']:.4f} s, peak memory {dots['peak_mem_bytes'] / 2**30:.2f} "
          f"against {nothing['peak_mem_bytes'] / 2**30:.2f} GiB, held when the forward ends "
          f"{fwd / 2**30:.2f} against {nothing_fwd / 2**30:.2f} GiB", flush=True)
    return dots, counts


def train_run_path() -> tuple[dict, dict]:
    """``launch.train.run`` at smoke size on the card with the reference
    end-to-end test's arguments: a clean 24-step run, then one that fails at
    step ``TRAIN_FAIL_AT`` and restarts from its latest checkpoint (step
    ``TRAIN_RESTORED``) in temporary checkpoint directories, every B7 call
    held to its plain version as it runs.  The clean
    run's loss falls, and the restarted run's 16 losses lie within the
    reference test's band of the clean run's.  Returns (summary, launch
    counts of both runs)."""
    import argparse

    import numpy as np
    import torch

    from repro_torch import kernels as KS
    from repro_torch.launch.train import run

    phase(f"launch.train.run at smoke size on the card, --fail-at {TRAIN_FAIL_AT}")
    KS.reset_launch_counts()
    tap = CheckedFlashTap("train run")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, tap:
        clean = run(argparse.Namespace(**TRAIN_SMOKE_ARGS, ckpt_dir=f"{tmp}/clean",
                                       fail_at=None, device="cuda"))
        failed = run(argparse.Namespace(**TRAIN_SMOKE_ARGS, ckpt_dir=f"{tmp}/failed",
                                        fail_at=TRAIN_FAIL_AT, device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    steps = TRAIN_SMOKE_ARGS["steps"]
    check(clean["restored_step"] is None and clean["last_loss"] < clean["first_loss"],
          f"train run: clean loss {clean['first_loss']:.4f} -> {clean['last_loss']:.4f}")
    check(failed["restored_step"] == TRAIN_RESTORED and
          len(failed["losses"]) == steps - TRAIN_RESTORED,
          f"train run: restored step {failed['restored_step']}, {len(failed['losses'])} "
          f"losses after it")
    gap = np.abs(np.asarray(failed["losses"]) - np.asarray(clean["losses"][TRAIN_RESTORED:]))
    band = TRAIN_BAND + TRAIN_BAND * np.abs(np.asarray(clean["losses"][TRAIN_RESTORED:]))
    check(bool((gap <= band).all()), f"train run: the restarted losses leave the band "
                                     f"(largest gap {gap.max():.4f})")
    layers = 2  # the smoke config's; one general-route B7 launch a layer a step (no remat)
    want = layers * (steps + TRAIN_FAIL_AT + steps - TRAIN_RESTORED)
    check(counts["flash_attention_general"] == want and counts["flash_attention_sm90"] == 0,
          f"train run: {counts['flash_attention_general']} general / "
          f"{counts['flash_attention_sm90']} sm90 B7 launches, want {want} general")
    seq = TRAIN_SMOKE_ARGS["seq"]
    check(dict(tap.kinds) == {(True, seq, seq): want},
          f"train run: B7 calls held to plain by kind {dict(tap.kinds)}, want {want}")
    print(f"train run: clean loss {clean['first_loss']:.4f} -> {clean['last_loss']:.4f}; "
          f"failed at {TRAIN_FAIL_AT}, restored step {failed['restored_step']}, largest gap "
          f"to the clean run {gap.max():.4f}; {wall:.2f} s for both, every call checked; "
          f"B7 launches {want}, within {tap.excess:.3g} of the tolerance of their plain "
          f"version", flush=True)
    return dict(clean_losses=clean["losses"], restarted_losses=failed["losses"],
                restored_step=failed["restored_step"], max_gap=float(gap.max()),
                flash_checked=dict(calls=want, max_abs_err=tap.err,
                                   tolerance_share=tap.excess),
                wall_s=wall), counts


def capture_study_path() -> tuple[dict, dict]:
    """``benchmarks/fig_capture.py``'s study — the three captured families
    and their synthetic analogues, all six mechanisms — on both engines:
    2 / 2 / 1 Bloom launches a LazyPIM window, every B5 / B6 call held to
    its plain version, batch == sequential and both == one CPU run of the
    port on every field; then ``capture/moe_experts``'s trace on the card
    against its CPU trace, field for field.  Returns (launch counts, walls)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import MECHANISMS, Study
    from repro_torch.sim.trace import make_trace

    phase(f"capture study ({len(CAPTURE_STUDY)} workloads), CPU run")
    t0 = time.perf_counter()
    cpu = Study(list(CAPTURE_STUDY), device="cpu").run(engine="sequential")
    walls = {"cpu_sequential": time.perf_counter() - t0}
    print(f"cpu: {walls['cpu_sequential']:.2f} s wall", flush=True)
    counts, runs = {}, {}
    for engine in ("batch", "sequential"):
        phase(f"capture study, engine={engine}")
        tap = KernelTap()
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        study = Study(list(CAPTURE_STUDY))
        t0 = time.perf_counter()
        with tap:
            rs = study.run(engine=engine)
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        counts[engine], runs[engine] = launch_counts(), rs
        label = f"capture study/{engine}"
        for name in CAPTURE_KERNELS:
            check(counts[engine][name] > 0, f"{label}: kernel {name} was never launched")
        windows = check_query_launches(label, study, rs, engine,
                                       counts[engine]) // QUERIES_PER_WINDOW
        check_insert_launches(label, study, rs, engine, counts[engine])
        check_intersect_launches(label, study, rs, engine, counts[engine])
        err5, err6 = tap.check(label)
        print(f"{engine}: {len(rs)} workloads x {len(MECHANISMS)} mechanisms in "
              f"{walls[engine]:.2f} s wall; {windows} LazyPIM windows, 2 / 2 / 1 launches "
              f"each; launches {counts[engine]}; {len(tap.b5)} bloom_detect_conflicts calls "
              f"exact, {len(tap.b6)} lazy_merge calls within {err6:.3g}", flush=True)
    exact_points(runs["batch"].points, runs["sequential"].points,
                 "capture study batch vs sequential")
    exact_points(runs["sequential"].points, cpu.points, "capture study card vs CPU")
    phase("capture/moe_experts trace, card against CPU")
    t0 = time.perf_counter()
    card = make_trace("capture/moe_experts")
    torch.cuda.synchronize()
    walls["moe_experts_trace"] = time.perf_counter() - t0
    host = make_trace("capture/moe_experts", device="cpu")
    for f in dataclasses.fields(card):
        a, b = getattr(card, f.name), getattr(host, f.name)
        if isinstance(a, torch.Tensor):
            check(a.device.type == "cuda" and torch.equal(a.cpu(), b),
                  f"capture/moe_experts trace field {f.name}: card differs from CPU")
        else:
            check(a == b, f"capture/moe_experts trace field {f.name}: {a!r} vs {b!r}")
    print(f"batch == sequential == the CPU run on every field of {len(cpu)} x "
          f"{len(MECHANISMS)} results; capture/moe_experts's trace on the card "
          f"({walls['moe_experts_trace']:.2f} s, {card.num_windows} windows) equals its CPU "
          f"trace field for field", flush=True)
    return counts, walls


GENERATOR_FAMILIES = (("pagerank", "arxiv"), ("bfs", "enron"), ("htap128", None),
                      ("htap_stream", None), ("mtmix", "enron"))  # one plan a family
EXAMPLES_DIR = ROOT / "examples"
# The 100M trainer's steps on the card.  Up to 100 the failure (at half the
# steps) comes before the first checkpoint (step 50), so the run restarts
# from scratch and its first loss is the initial one, ~0.8 above where 60
# steps end (the reference example at 60 steps: 10.616 -> 9.819 on the
# CPU).  At the reference's 200 the run restores step 50, and on this data
# the loss rises for ~150 steps before it falls, so step 199 beats step 50
# about as often as not (on the card 9.288 -> 10.029, a fail; at 600 steps
# 9.541 -> 9.389, a pass by 0.15).
TRAIN_100M_STEPS = 60


def generator_phase() -> dict:
    """``sim.synth.generator`` for one plan of each synthesized family at
    its default size: ``fn(*args)`` on the card against the same plan's CPU
    run, field by field, exactly; each card call timed (host clock around a
    synchronized call, after a warm one)."""
    import torch

    from repro_torch.sim import synth
    from repro_torch.sim.trace import build_plan

    phase("sim.synth.generator: one plan a family, card against CPU")
    dev = torch.device("cuda", 0)
    out = {}
    for app, graph in GENERATOR_FAMILIES:
        plan, edges, name = build_plan(app, graph)
        fn, args = synth.generator(plan, seed=0, edges=edges, device=dev)
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*args)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        cpu_fn, cpu_args = synth.generator(plan, seed=0, edges=edges, device="cpu")
        t0 = time.perf_counter()
        want = cpu_fn(*cpu_args)
        cpu_s = time.perf_counter() - t0
        check(got.keys() == want.keys(), f"generator {name}: fields differ")
        for k, w in want.items():
            check(got[k].device.type == "cuda" and torch.equal(got[k].cpu(), w),
                  f"generator {name}: field {k} on the card differs from the CPU's")
        print(f"generator {name} ({type(plan).__name__}, {plan.total_lines} lines, "
              f"{plan.num_windows} windows): {len(want)} fields equal the CPU run's; "
              f"card {card_s * 1e3:.2f} ms, CPU {cpu_s * 1e3:.2f} ms", flush=True)
        out[name] = dict(plan=type(plan).__name__, card_ms=card_s * 1e3, cpu_ms=cpu_s * 1e3)
    return out


def load_example(name: str):
    """``examples/<name>.py`` as a module (the folder is not a package)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(paper_points) -> tuple[dict, dict]:
    """Four of the torch examples through their ``main`` on the card, each
    counted: the quickstart and the study grid at their defaults, every
    shared point equal to phase 4's results on every field (the
    quickstart's two workloads; the grid's default-hardware,
    default-LazyPIM point); the LazySync demo equal to its CPU run exactly;
    the 100M trainer at ``TRAIN_100M_STEPS``, its loss falling as the
    reference example asserts.
    Returns (summary, launch counts by example)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import HWParams, LazyPIMConfig

    paper = {p.workload: p for p in paper_points}
    summary, counts = {}, {}

    def run(name, argv):
        phase(f"example {name} on the card")
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        out = load_example(name).main(argv)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
        summary[name] = {"wall_s": time.perf_counter() - t0}
        return out

    def same(points, label):
        """``points`` against phase 4's points of their workloads, on
        their mechanisms."""
        exact_points(points, [dataclasses.replace(paper[p.workload], results={
            m: paper[p.workload].results[m] for m in p.results}) for p in points], label)

    out = run("torch_quickstart", [])
    same(out["results"].points, "torch_quickstart")
    check(out["conflict_overlapping"] and not out["conflict_disjoint"],
          "torch_quickstart: signature verdicts")
    print(f"torch_quickstart: {len(out['results'].points)} workloads x 6 mechanisms equal "
          f"phase 4's on every field; launches {counts['torch_quickstart']}", flush=True)

    out = run("torch_study_grid", [])
    study = out["study"]
    shared = [p for p in out["results"].points
              if study.hw_points()[p.hw_index] == HWParams()
              and study.lazy_points()[p.lazy_index] == LazyPIMConfig()]
    check(len(shared) == 1, f"torch_study_grid: {len(shared)} points at the default hardware "
                            f"and LazyPIM config")
    same(shared, "torch_study_grid")
    summary["torch_study_grid"]["dbi_writebacks"] = list(out["dbi_writebacks"])
    print(f"torch_study_grid: the default-hardware, default-LazyPIM point equals phase 4's "
          f"on every field; DBI writebacks at 16 GB/s {out['dbi_writebacks']}; launches "
          f"{counts['torch_study_grid']}", flush=True)

    out = run("torch_lazy_coherence_demo", [])
    want = load_example("torch_lazy_coherence_demo").main(["--device", "cpu"])
    check(out == want, "torch_lazy_coherence_demo: the card's counts differ from the CPU's")
    summary["torch_lazy_coherence_demo"].update(lazy_bytes=out["lazy_bytes"],
                                                dense_bytes=out["dense_bytes"])
    print(f"torch_lazy_coherence_demo: {len(out['steps'])} steps' conflicts and bytes equal "
          f"the CPU run's; launches {counts['torch_lazy_coherence_demo']}", flush=True)

    out = run("torch_train_100m", ["--steps", str(TRAIN_100M_STEPS)])
    check(out["last_loss"] < out["first_loss"]
          and all(math.isfinite(x) for x in out["losses"]),
          f"torch_train_100m: loss {out['first_loss']} -> {out['last_loss']}")
    losses = out["losses"]
    means = [round(sum(losses[i:i + 50]) / len(losses[i:i + 50]), 4)
             for i in range(0, len(losses), 50)]
    summary["torch_train_100m"].update(params=out["params"], first_loss=out["first_loss"],
                                       last_loss=out["last_loss"],
                                       restored_step=out["restored_step"],
                                       loss_means_50=means)
    print(f"torch_train_100m: {out['params']} parameters, loss {out['first_loss']:.4f} -> "
          f"{out['last_loss']:.4f} (50-step means from step {out['restored_step'] or 0}: "
          f"{means}), restored step {out['restored_step']}; launches "
          f"{counts['torch_train_100m']}; {summary['torch_train_100m']['wall_s']:.1f} s",
          flush=True)
    return summary, counts


def main() -> int:
    dryrun = None
    try:
        card = environment()
        K = build()
        dryrun = start_dryrun()
        import torch

        from repro_torch.configs import get_config
        from repro_torch.models.common import tree_map

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
              f"{torch.backends.cudnn.allow_tf32}", flush=True)
        floor_ms = launch_floor_ms()
        stats = kernel_phases(K, floor_ms)
        counts, walls, fig7_runs = main_path(K)
        sequential = fig7_runs["sequential"]
        profile = main_path_profile()
        mesh_summary, mesh_counts = mesh_path(fig7_runs["batch"])
        del fig7_runs
        fig7x_counts, fig7x_walls = extended_fleet_path(sequential, card)
        examples, example_counts = examples_phase(sequential.points)
        generator = generator_phase()
        service_summary, service_counts = study_service_path(sequential.points, card)
        caps_counts = signature_caps_phase(K, importlib.import_module(
            "repro_torch.kernels.bloom.onehot"))
        seed_counts, seed, seed_tap = seed_path(sequential)
        stats.update(onehot_kernel_phases(seed_tap, floor_ms))
        del seed_tap, sequential
        signatures = signatures_phase(K, card)
        cap_counts, cap_walls, cap_tap = capture_path()
        lazy = lazysync_path()
        keep = lazy.pop("keep")
        stats.update(lazysync_kernel_phases(cap_tap, keep, floor_ms))
        del keep, cap_tap
        gc.collect()
        torch.cuda.empty_cache()
        kv_counts, kv_walls = kv_serve_path()
        prefill, prefill_counts, params, layer0 = prefill_path()
        stats.update(flash_kernel_phase(layer0))
        del layer0
        gc.collect()
        torch.cuda.empty_cache()
        serving, serve_counts = serve_path(params)
        # the bf16 weights are dropped once cast: the float32 phase holds ~16 GB
        params = tree_map(lambda t: t.to(torch.float32), params)
        gc.collect()
        torch.cuda.empty_cache()
        prefill32, prefill32_counts = prefill_f32_path(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        smoke_counts = smoke_prefill_path()
        moe_prefill, moe_prefill_counts, params, (layer0, qkv0) = moe_prefill_path()
        moe_dispatch = moe_dispatch_phase(layer0)
        stats["flash_attention_sm90"]["moe_shape"] = flash_timing("MoE prefill", qkv0)
        del layer0, qkv0
        gc.collect()
        torch.cuda.empty_cache()
        moe_serving, moe_serve_counts = arch_serve_path(MOE_ARCH, MOE_SERVE_ARGS, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        moon_prefill, moon_prefill_counts, params, (layer0, _) = moe_prefill_path(
            MOONSHOT_ARCH)
        moon_dispatch = moe_dispatch_phase(layer0, MOONSHOT_ARCH)
        del layer0
        gc.collect()
        torch.cuda.empty_cache()
        moon_serving, moon_serve_counts = arch_serve_path(MOONSHOT_ARCH, MOONSHOT_SERVE_ARGS,
                                                          params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        phi3_prefill, phi3_prefill_counts, params, layer0 = prefill_path(PHI3_ARCH)
        stats["flash_attention_sm90"]["phi3_shape"] = flash_timing("phi3 prefill", layer0)
        del layer0
        gc.collect()
        torch.cuda.empty_cache()
        phi3_serving, phi3_serve_counts = arch_serve_path(PHI3_ARCH, PHI3_SERVE_ARGS, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        moe_smoke_counts = moe_smoke_path()
        mamba_prefill, mamba_prefill_counts, params = ssm_prefill_path()
        mamba_block = ssm_block_check(params)
        mamba_serving, mamba_serve_counts = arch_serve_path(SSM_ARCH, SSM_SERVE_ARGS,
                                                                  params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_prefill, hybrid_prefill_counts, params, qkv2 = hybrid_prefill_path()
        stats["flash_attention_sm90"]["hybrid_shape"] = hybrid_flash_timing(
            qkv2, get_config(HYBRID_ARCH).window_size)
        del qkv2
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_serving, hybrid_serve_counts = arch_serve_path(HYBRID_ARCH,
                                                                    HYBRID_SERVE_ARGS, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        enc_cfg = get_config(ENCDEC_ARCH)
        enc_frames = PREFILL_LEN // enc_cfg.audio_downsample
        encdec_prefill, encdec_counts, first = frontend_prefill_path(ENCDEC_ARCH, {
            (False, enc_frames, enc_frames): enc_cfg.encoder_layers,
            (True, PREFILL_LEN, PREFILL_LEN): enc_cfg.num_layers,
            (False, PREFILL_LEN, enc_frames): enc_cfg.num_layers})
        stats["flash_attention_sm90"]["encdec_shapes"] = {
            "encoder": flash_timing("enc-dec encoder", first[(False, enc_frames, enc_frames)],
                                    causal=False),
            "decoder": flash_timing("enc-dec decoder", first[(True, PREFILL_LEN, PREFILL_LEN)]),
            "cross": flash_timing("enc-dec cross attention",
                                  first[(False, PREFILL_LEN, enc_frames)], causal=False)}
        del first
        gc.collect()
        torch.cuda.empty_cache()
        vlm_cfg = get_config(VLM_ARCH)
        vlm_len = PREFILL_LEN + vlm_cfg.vision_tokens
        vlm_prefill, vlm_counts, first = frontend_prefill_path(
            VLM_ARCH, {(True, vlm_len, vlm_len): vlm_cfg.num_layers})
        stats["flash_attention_sm90"]["vlm_shape"] = flash_timing(
            "VLM prefill", first[(True, vlm_len, vlm_len)])
        del first
        gc.collect()
        torch.cuda.empty_cache()
        training, train_counts = train_path()
        gc.collect()
        torch.cuda.empty_cache()
        training_dots, train_dots_counts = train_dots_path(training)
        train_run, train_run_counts = train_run_path()
        capstudy_counts, capstudy_walls = capture_study_path()
        dry = dryrun_phase(dryrun, training)
        for name in ("h3_hash", "bloom_query", "bloom_query_onehot", "bloom_insert",
                     "bloom_insert_onehot", "bloom_intersect"):
            stats[name]["launch_floor_ms"] = floor_ms
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        if dryrun is not None and dryrun.poll() is None:
            dryrun.kill()
            dryrun.wait()
            _read_dryrun(dryrun)
    by_path = {"fig7_batch": counts["batch"], "fig7_sequential": counts["sequential"],
               "fig7x_batch": fig7x_counts["batch"],
               "fig7x_sequential": fig7x_counts["sequential"],
               **service_counts,
               **{f"m64_study_{k}": c for k, c in caps_counts.items()},
               "seed_fig7": seed_counts,
               "capture_batch": cap_counts["batch"],
               "capture_sequential": cap_counts["sequential"],
               "qwen3_lazysync": lazy["launches"],
               "kv_serve_batch": kv_counts["batch"],
               "kv_serve_sequential": kv_counts["sequential"],
               "qwen3_prefill": prefill_counts, "qwen3_serve": serve_counts,
               "qwen3_prefill_f32": prefill32_counts,
               "smoke_prefill_f32": smoke_counts,
               "moe_prefill": moe_prefill_counts, "moe_serve": moe_serve_counts,
               "moe_smoke_f32": moe_smoke_counts,
               "moonshot_prefill": moon_prefill_counts, "moonshot_serve": moon_serve_counts,
               "phi3_prefill": phi3_prefill_counts, "phi3_serve": phi3_serve_counts,
               **{f"example_{k.removeprefix('torch_')}": c for k, c in example_counts.items()},
               **mesh_counts,
               "mamba_prefill": mamba_prefill_counts, "mamba_serve": mamba_serve_counts,
               "hybrid_prefill": hybrid_prefill_counts, "hybrid_serve": hybrid_serve_counts,
               "encdec_prefill": encdec_counts, "vlm_prefill": vlm_counts,
               "qwen3_train": train_counts, "qwen3_train_dots": train_dots_counts,
               "train_run_smoke": train_run_counts,
               "capture_study_batch": capstudy_counts["batch"],
               "capture_study_sequential": capstudy_counts["sequential"]}
    kernels = [dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=TPU_KERNEL[name],
                    launches=sum(c[name] for c in by_path.values()),
                    launches_by_path={p: c[name] for p, c in by_path.items()},
                    **stats[name]) for name in TPU_KERNEL]
    print(json.dumps({"profile": profile, "fig7_wall_s": walls,
                      "fig7x_wall_s": fig7x_walls, "study_service": service_summary,
                      "seed_fig7": seed,
                      "signatures": signatures,
                      "capture_wall_s": cap_walls, "lazysync": lazy,
                      "kv_serve_wall_s": kv_walls, "qwen3_prefill": prefill,
                      "qwen3_serve": serving, "qwen3_prefill_f32": prefill32,
                      "moe_prefill": moe_prefill, "moe_dispatch": moe_dispatch,
                      "moe_serve": moe_serving, "lane_mesh": mesh_summary,
                      "moonshot_prefill": moon_prefill, "moonshot_dispatch": moon_dispatch,
                      "moonshot_serve": moon_serving, "phi3_prefill": phi3_prefill,
                      "phi3_serve": phi3_serving, "examples": examples,
                      "generator": generator,
                      "mamba_prefill": mamba_prefill, "mamba_block_check": mamba_block,
                      "mamba_serve": mamba_serving, "hybrid_prefill": hybrid_prefill,
                      "hybrid_serve": hybrid_serving, "encdec_prefill": encdec_prefill,
                      "vlm_prefill": vlm_prefill, "qwen3_train": training,
                      "qwen3_train_dots": training_dots, "dryrun": dry,
                      "train_run_smoke": train_run,
                      "capture_study_wall_s": capstudy_walls}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

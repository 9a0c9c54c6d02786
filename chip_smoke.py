#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--n POINTS]

Phases (any failure raises and exits non-zero; nothing is caught):

  build  compile every CUDA kernel of ``src/repro_torch/csrc`` with nvcc
         (sm_90a) into ``build/repro_torch/``, one nvcc per source in
         parallel;
  (b)    ``KNNIndex.build`` + self-join of the paper's SuSy-sized cloud
         (5,000,000 × 18 by default, ``pointclouds.load("susy")``) with
         ``HybridConfig(k=25, m=6, gamma=0.4, rho=0.2,
         online_rebalance=False)``; ε is not pinned, so ε selection runs
         the ``bin_hist`` kernel.  2048 sampled rows are held against a
         float64 oracle computed on the card;
  (c)    R≠S serving: a 65,536-query foreign batch against the same
         index, twice; a sample is held against float64 and the second
         call must add no engine bucket.  Then the index's engine records
         (``cache_info()``, ``memory_analysis()``): each kind that ran
         holds the four fields with temp > 0; a first-bucket query of 100
         rows leaves the peak memory counter as it was, its records'
         argument and output bytes equal the hand count, their code bytes
         those of the libraries each record's call launched;
  (d)    the brute baseline (GPU-JOINLINEAR) on 4096 sampled queries over
         the full corpus, through the ``knn_topk`` kernel;
  (e)    the cell-tiled ``pallas`` backend at full width: a second index on
         the same points with the fused index's ε pinned (same grid),
         self-join (2048 rows against float64) and the R≠S batch twice;
         the ``pairwise_sq_l2`` kernel must launch;
  (g)    metrics: a cosine index over ``normalize_rows`` of the points and
         an ip index over the raw points, each serving the R≠S batch, 2048
         rows held against float64 in that metric (1 − cos; signed −q·c);
         every ip query must end in the brute lane;
  (h)    bf16: a fused index with ``distance_dtype="bf16"`` at K = 16
         (the bf16 streaming kernel; exact after the fp32 rescore), then
         one R≠S call at K = 25 (k + 8 > 32: the gathered fp32 route, the
         ``knn_stream_topk_padded`` kernel, launched once per chunk of
         tiles: the count must be the route's ⌈tiles / tiles-per-chunk⌉);
  (i)    FMA end to end at its published 107,000 × 518
         (``pointclouds.load("fma", n_override=107_000)``): ε selected on
         the card (the ``bin_hist`` kernel at 518 dims), the fused self-join
         (``knn_stream`` at 518 dims, the brute lane's ``knn_topk``) and the
         ``pallas`` self-join on the same grid (``pairwise_sq_l2``), 2048
         rows of each held against float64, each row to its own fp32
         expansion-form bound (``check_exact(fp32_bound=True)``); the
         fused self-join also on the rows a draw of (j)'s queries first
         would give;
  (j)    the brute lane past the kernel's k: ``brute_knn`` at K = 40 for
         1,024 sampled queries over the SuSy corpus, streamed in
         ``corpus_chunk`` = 4,096 pieces (each ``knn_topk`` call rerouted
         to the plain version, counted: one per chunk; no kernel runs),
         every row held against float64; wall time and peak memory;
  (f)    ``dense_join`` with ``backend="pallas"`` against ``"fused"`` on the
         first dense batch of the 5M index, and on 16,384 sparse-split
         queries at budgets growing until at least half their tiles fit
         in both engines: totals equal, overflow patterns nested, found /
         failed / ids / distances equal up to ε² flips, distance ties and
         the expansion form's rounding bound;
  (a)    each kernel and variant against its plain PyTorch version on the
         card, on the inputs its path gave it: max |Δd|, id / found / bin
         mismatches (each explained by an ε²- or bin-edge flip or a
         distance tie, recomputed in float64; at 518 dims within the
         expansion form's fp32 bound, which grows with the width; a bin
         within the fp32 error measured on its own sample, a check that
         must also fail the kernel's counts one bin up and with 1 % of the
         pairs moved), kernel /
         plain / library times from CUDA events, and the bound from bytes
         and FLOPs.  The inputs of the ip brute call of (g), of the first
         batched gathered-route launch of (h) and of (i)'s ε selection and
         brute-lane call are kept as those paths make them, and (k) holds
         the kernel on its delta buffer's call.  The pairwise kernel is
         also held on R≠S tiles of a second FMA cloud, where SHORTC must
         skip tiles.
  (k)    the mutable, durable index: (b)'s index takes 4,096 inserts and
         16 + 16 deletes (base ids (c) returned, inserted ids), serves the
         R≠S batch at K = 16 through the delta buffer (``knn_tile_topk``)
         and the merge-time fold (exact against float64 over the net
         corpus), is saved and loaded on the card (bit-identical answers)
         and compacted (bit-identical to ``KNNIndex.build`` on
         ``net_points()``); step times, save size and peak memory;
  (l)    ``refimpl_knn`` on the FMA cloud at four ranks (ε selection, the
         sparse engine and the ``knn_tile_topk`` backstop), exact at 518
         dims; rank times and Σ t / max t;
  (m)    the projection front stage on FMA: the first 102,904 rows indexed
         through a 6-dim PCA (``projection_dim=6``, K = 10), the last 4,096
         foreign queries that calibration never sees; l2 at
         ``recall_target`` 0.9 and 1.0, ip over the MIPS fit at 0.9, and the
         l2 self-join at 0.9.  Each run prints the calibrated rung (or the
         full-dimension brute fallback), the estimate, recall@10 against a
         float64 oracle in the index's metric, ``t_wall`` and the rescore
         time; where a rung served, recall ≥ target − 0.01, where the
         fallback served, exact; every distance is its id's float64 score;
         a repeat adds no bucket; the l2 index survives save / load with
         bit-identical answers.  Plain versions run only through the
         counted k > 32 reroute (k_cand = 40 and 80 rungs);
  (n)    the grid lean pass on SuSy: (b)'s points with (b)'s ε pinned and
         ``recall_target=0.9`` serve (c)'s batch: the calibrated ε scale (or
         the exact fallback, then bit-identical to (c)), the estimate and
         recall on 2,048 rows against float64; an index at
         ``recall_target=1.0`` answers bit-identically to (c);
  (o)    the serving front end (``KNNServer``) on SuSy: a clean index over
         (b)'s points with (b)'s ε pinned; the arrivals are (c)'s first 2,048
         rows.  Capacity as ``benchmarks/overload.py`` measures it: the 128-
         and 256-row buckets warmed, each bucket's ``per_row`` the best of
         three probes, the 128 bucket's the unit; deadline 4 × ``per_row`` ×
         128, ``max_wait`` half a 128-row batch.  Open-loop Poisson traces
         (seed 11) at 0.5×, 1× and 2× of 1 / ``per_row`` on a ``VirtualClock``
         under the service model ``per_row`` × padded rows, checked exactly:
         every ticket resolved, served + shed = 2,048, shed reasons and level
         occupancy recounted from the tickets equal ``metrics()``, and at 2×
         something shed, no deadline miss and the served p99 within the
         deadline.  Every non-degraded batch of the 1× run replays bit for bit
         through ``index.query``; 256 of its served rows are held against
         float64; a second 1× run adds no engine bucket.  Then three 2× traces
         advanced by each batch's measured service time on the card: QPS,
         response percentiles, shed counts, levels, batches, seconds per batch
         by bucket (printed, not gated);
  (p)    the crash-mid-checkpoint drill on (o)'s index through
         ``CrashingCheckpointManager`` and ``ScriptedFaults``: a durable save,
         then at ``pre-latest`` (the last of the three crash points;
         ``pre-arrays`` and ``pre-manifest`` run in the CPU tests) 5 base ids
         deleted (the generation stays dirty), the save crashed,
         ``KNNIndex.load`` on the card answering 4,096 of (c)'s queries at
         K = 16 bit-identically to the last acknowledged generation, with its
         tombstones (the complete step directory exists while ``LATEST``
         names the acknowledged one), and the retried save landing and
         loading bit-identically to the live index; save / load times and
         bytes on disk;
  (q)    the mesh on the one card: one process drives P logical slots, all on
         ``cuda:0`` (``make_serving_mesh``).  (q1) a 4 × 1 ``ShardedKNNIndex``
         over (b)'s 5M points, ε selected once globally (``bin_hist``): (c)'s
         batch twice (the second adds no bucket, ``"merge"`` included), held
         against float64 and against (c)'s single-device answers (distances
         within 2e-6, ids equal except float64 ties); the tree merge against
         the all-gather fold on that call's shard blocks; a sharded self-join
         of the first 524,288 rows.  (q2) a 2 × 2 replica × shard index (ε
         pinned) on 4,096 of (c)'s rows: healthy, with replica 0 killed
         (bit-identical, retries counted), with shard 1 lost (coverage column
         false, exact over shard 0's points), and behind ``KNNServer``'s
         partial rung on a 1,024-arrival trace at 2× (partial responses flag
         the skipped shard, full-rung ones replay bit for bit).  (q3) 4,096
         inserts and 5 deletes on the 2 × 2 index at K = 16, exact over the
         net corpus; save, load onto 2 × 2 (bit-identical), no mesh and 4 × 1;
         ``compact()`` bit-identical to a fresh sharded build.  (q4)
         ``ring_self_join`` over 524,288 rows on 4 slots (exact), its bf16
         wire variant, and ``hybrid_join_spmd`` over 262,144 rows (resolved
         rows exact, ``n_unresolved`` printed).  (a) holds the per-shard
         brute and dense calls and a ring hop's chunk against their plain
         versions.
  (r)    the kNN-LM serving path at olmo_1b's full width
         (``repro_torch.configs.get_config("olmo_1b")``: 16 layers, d_model
         2,048, vocab 50,304, bf16 activations; 1.18 B parameters drawn from
         seed 7 on the card) with ``examples/knn_lm_serve.py``'s head (k = 8,
         λ = 0.9, T = 1).  The datastore: ``collect_pairs`` over 64 seeded
         sequences of 1,025 tokens (flash attention, 2 × 2 chunks of 1,024),
         65,536 keys × 2,048 dims, ``RetrievalConfig``'s own size.  (r1) an
         ip ``IndexRetriever`` over ``make_serving_mesh(4)`` behind
         ``KNNServer(deadline=5.0)``: ``generate`` 32 tokens for
         ``corpus[:8, :256]`` with retrieval on and off; retrieval must beat
         the bare LM on the memorized continuations with nothing shed; the
         first decode step's answer equals a direct query, is exact against
         float64 over all keys (ids equal where no float64 tie) and equal
         through an unsharded retriever.  (r2) ``build_datastore`` (REORDER,
         no truncation) and ``generate`` with the in-step l2 ``lookup``,
         exact on the first decode step.  (r3) ``sharded_lookup`` over 4
         slots on every step's queries against (r2)'s ``lookup``.  Decode
         matches forward: the prefill and 4 decode steps' logits stray from
         a float32 forward at most twice as far as the bf16 forward does,
         the argmax agreeing away from ties.  Printed:
         the collect and index-build times, prefill, each decode step's LM
         and retrieval times, tokens/s, peak memory.  (a) holds the
         per-shard ip call, the lookup's call and the ε selection's
         histogram at D = 2,048.

  (s)    the dense training path at olmo_1b's full width (no kernel of
         ``csrc/`` runs on it).  (s1) the published config (16 layers,
         d_model 2,048, vocab 50,304, ``attn_chunk`` 1,024, remat "full", bf16
         activations, float32 masters and moments; 1,176,764,416 parameters
         from seed 0 on the card): ``TokenPipeline(cfg, SHAPES["train_4k"],
         batch_override=4)``, 16,384 tokens a step, 6 steps of
         ``make_train_step`` under ``OptConfig(total_steps=6,
         warmup_steps=1)``: every loss finite, the last three's mean below
         the first three's, ``grad_norm`` > 0, step 1 within
         ``TRAIN_LOSS_TOL`` / ``TRAIN_GNORM_RTOL`` of a float32 step of the
         same masters and batch; step times, tokens/s, peak memory, the
         state's bytes, and one more step under ``torch.profiler``.  (s2)
         ``launch/train.py``'s ``main`` at that width with ``n_layers`` cut to
         2 (237,240,320 parameters), seq 1,024, batch 4, 10 steps, a
         checkpoint every 5, under ``torch.use_deterministic_algorithms``: a
         clean run (saving only its final state); a run with ``--inject-fault 7`` (exactly one restart, the
         injected fault's; its losses and final parameters bit-identical to
         the clean run's); ``--resume`` after the step-10 checkpoint and
         ``LATEST`` are removed (steps 5–9 again, bit-identical); save and
         restore seconds and bytes.
  (t)    the sharded train step on a 2 × 4 mesh of logical slots, all on
         ``cuda:0`` (``make_host_mesh(4, slots=8)``; no kernel of ``csrc/``
         runs on it).  (t1) olmo_1b's width (d_model 2,048, 16 heads, d_ff
         8,192, vocab 50,304) at depth 4 (cut from 16 for the time limit)
         from seed 0, placed by ``build_train``'s shardings (every weight
         split four ways over "model", replicated over the two data slots;
         each slot's bytes of masters and moments checked against the spec's
         share), batch 4 × seq 4,096, 6 steps: every loss finite and falling, step 1 against
         the one-device step of the same weights and batch (|Δloss|,
         grad_norm gap, and the masters after it within two learning-rate
         steps, at most ``SPMD_FLIP_SHARE`` of them apart by more than one);
         step times and tokens/s beside (s1)'s, peak memory, and one step
         under ``torch.profiler`` with the device time of the
         ``spmd.collective`` ranges apart.  (t2) ``launch/train.py`` with
         ``--model-axis 4 --slots 8`` at (s2)'s depth and sizes under
         deterministic algorithms: a clean run (saving only its final state)
         and one with ``--inject-fault
         7`` (one restart, losses bit-identical); the latest save restored
         with ``shardings=`` onto a 4 × 2 mesh and onto one device, bit for
         bit; two more steps on 4 × 2 within (s1)'s tolerances of the same
         steps on 2 × 4.
  (u)    the sharded serving steps on the same 2 × 4 slots at olmo_1b's full
         width with bf16 weights from seed 0 (no kernel of ``csrc/`` runs on
         it).  (u1) ``build_prefill``'s step on a 2 × 8,192 prompt
         (``prefill_32k``, batch cut 32 → 2, prompt 32,768 → 8,192), once,
         timed: its last logits and cache (each layer gathered) held to the one-device
         ``transformer.prefill`` of the same weights (``SERVE_LOGIT_ATOL``,
         ``SERVE_KV_RTOL``).  (u2) ``build_decode``'s step
         (``decode_32k``, batch cut 128 → 4) over a seeded cache of 32,768
         positions placed by ``cache_shapes_and_shardings``, 8 steps from
         pos 32,760, each step's logits and written K/V held to the
         one-device ``decode_step`` on the global copy of the cache; step
         times and tokens/s, the last step under ``torch.profiler`` (busy
         share, ``spmd.collective`` device time).  (u3) ``dryrun``'s records
         of the two cells on a 2 × 4 mesh of ``meta`` slots: per-slot argument
         and output bytes equal to the card's blocks, the analytic FLOPs and
         HBM bytes, the counted collectives, and the roofline of eight slots
         on one card beside the measured times.
  (v)    the recurrent presets on one card (``repro_torch.models.{rwkv6,
         rglru}``: the scans are Python loops over tokens, as the reference's
         ``lax.scan``; no kernel of ``csrc/`` but the lookup's).  (v1)
         ``rwkv6_3b`` at its published config (32 layers, d_model 2,560, 40
         heads × 64, d_ff 8,960, vocab 65,536; bf16 activations, f32 masters,
         ~3.07 B parameters from seed 3) with the kNN-LM head as in (r) (k =
         8, λ = 0.9): ``build_datastore`` over 32 seeded sequences of 513
         tokens (16,384 keys × 2,560), ``generate`` 16 tokens for 2 prompts of
         512 with the in-step l2 ``lookup`` (one ``knn_tile_topk`` launch a
         lookup, 17 counted); the prefill's last logits and each decode step's
         held to ``forward_seq`` over the same tokens by (r)'s bf16 criterion
         (at most twice the bf16 forward's gap to a float32 forward, argmax
         equal away from ties); the same tokens in two chunks through
         ``forward_seq(states=)``: every layer's state within twice the bf16
         forward's gap to float32 of the whole forward's, the second chunk's
         logits by the same criterion.  (v2) ``recurrentgemma_9b`` at its
         published config (38 layers = 12 × (rglru, rglru, local) + 2, d_model
         4,096, MQA, d_ff 12,288, vocab 256,000, window 2,048; bf16 weights,
         ~9.57 B parameters), prompts of 2,560 (the local ring wraps), the
         same checks, the chunked states held on the two RG-LRU layers before
         the first local layer (the reference's ``states=`` carries no KV: a
         local layer sees its own chunk).  Prefill s, decode ms a step (LM and
         lookup), tokens/s, peak memory, one profiled decode step.  (v3)
         two ``make_train_step`` steps at ``rwkv6_3b``'s width with
         ``n_layers`` cut to 2, batch 2 × seq 1,024 (a checkpoint per 512-token
         chunk of the scan): finite, step 1's loss within ``TRAIN_LOSS_TOL``
         of the float32 loss of the same masters and batch.  (a)
         holds each lookup's first call at D = 2,560 and D = 4,096.
  (w)    the recurrent presets in the slot program (``models/spmd.py``'s
         ``rwkv``, ``rglru`` and ``local`` layers; no kernel of ``csrc/``
         runs on it), at their published widths with the depth cut to 8,
         bf16 weights from seed 3.  (w1) ``rwkv6_3b`` on 2 × 4 slots of the
         card (10 heads a slot): ``build_prefill``'s step on 2 × 512 tokens,
         then 8 ``build_decode`` steps; (w1s) the same weights on 1 × 16
         slots (160 channels, 2.5 heads a slot: every slot scans all 40
         heads), a 2 × 128 prefill and 4 steps; (w2) ``recurrentgemma_9b``
         on 2 × 4 (8 layers: two (rglru, rglru, local) groups and the
         2-layer tail), a 2 × 2,560 prefill that wraps the position-sharded
         ring, then 8 steps.  Each prefill's and step's logits (gathered)
         held to the one-device ``transformer.prefill`` / ``decode_step`` by
         (r)'s bf16 criterion against a float32 run of the same weights;
         every layer's state (gathered) within ``W_STATE_RATIO`` times the
         one-device bf16 state's own gap to float32.  (w3) one sharded train
         step on 2 × 4 slots, batch 2 × 256, of ``rwkv6_3b`` at depth 2 (in
         float32: its bf16 gradient is dominated by rounding) and
         ``recurrentgemma_9b`` at depth 3 (bf16), loss and grad_norm within
         (s1)'s tolerances of the one-device step.  (w4) ``dryrun``'s
         records of (w1)'s and (w2)'s decode cells on 2 × 4 ``meta`` slots:
         per-slot argument and output bytes equal to the card's.  Prefill
         s, decode ms a step and tokens/s beside the one-device times, peak
         memory, one profiled decode step of (w1) and (w2).
  (x)    the MoE presets on one card (``models/layers.apply_moe``: the
         sort-based, capacity-bounded top-k dispatch, plain tensor code; no
         kernel of ``csrc/`` but the lookup's), seed-3 weights.  (x1)
         ``granite_moe_1b_a400m`` at its published config (24 layers,
         d_model 1,024, 16/8 heads, 32 experts top-8 × d_expert 512,
         capacity factor 1.25, vocab 49,155 tied; f32 masters, bf16
         activations, ~1.33 B parameters) with the kNN-LM head as in (v):
         16,384 keys from 32 × 513 tokens, ``generate`` 16 tokens for 2
         prompts of 512 with the in-step lookup (17 ``knn_tile_topk``
         launches counted).  (x2) ``qwen3_moe_235b_a22b`` at its published
         widths (d_model 4,096, 64/4 heads × 128, qk-norm, 128 experts
         top-8 × 1,536, vocab 151,936 untied, bf16 weights) with the depth
         cut 94 → 2 (~6.2 B parameters), 2 × 512 prompts, 8 decode steps, no
         retrieval.  Each: prefill s, decode ms a step (LM and lookup), peak
         memory, the prefill's dropped share of the top-8 assignments and
         aux per layer at capacity 1.25, and, at capacity 16 on the same
         weights (where neither path drops), the prefill and decode steps'
         logits held to ``forward_seq`` over the same tokens: the relative
         RMS gap to a float32 forward within ``X_RMS_RATIO`` times the bf16
         forward's, the argmax equal away from ties, the share of (token,
         layer) top-8 sets that differ printed; one profiled decode step.
         (x3) two ``make_train_step`` steps at granite's width, depth 24 →
         4, batch 2 × 1,024: finite, ``moe_aux`` above 0, step 1's loss
         within ``TRAIN_LOSS_TOL`` of the float32 loss.  (a) holds the
         lookup's first call at D = 1,024.
  (y)    the MoE presets in the slot program (``models/spmd.py``'s MoE
         sublayer: expert parallelism, the global dispatch across the data
         groups, the per-data-shard dispatch; no kernel of ``csrc/``) on
         ``make_host_mesh(4, slots=8)``'s 2 × 4 slots on ``cuda:0``, seed 3.
         (y1) ``granite_moe_1b_a400m`` at its widths, depth 24 → 8, float32
         activations and weights, capacity 1.25: ``build_prefill`` on 2 ×
         512 tokens and 4 ``build_decode`` steps against the one-device
         ``transformer.prefill`` / ``decode_step``; every layer's count of
         dropped assignments equal to one device's up to the first top-8
         set that differs (none is expected; one must sit at a tie within
         ``Y_TIE``), the logits within ``Y_F32_ATOL``; the prefill again with
         ``moe_sharded_dispatch`` against the one-device prefill given the
         mesh's ``ShardingCtx``.  (y2) ``qwen3_moe_235b_a22b`` at its widths,
         depth 94 → 2, bf16 with FSDP, capacity 16: prefill and 4 steps by
         (x)'s relative RMS criterion.  Each: prefill s, decode step ms,
         launches, busy share and ``spmd.collective`` device time of a
         profiled step beside the one-device step's, peak memory.  (y3) one
         sharded train step of granite at depth 4, 2 × 1,024 tokens, with
         each dispatch, against the one-device step by (t1)'s bounds,
         ``moe_aux`` finite and above 0.  (y4) the dry run of (y1)'s and
         (y2)'s decode cells on 2 × 4 ``meta`` slots: per-slot argument and
         output bytes equal to the card's.
  (z)    the encoder-decoder on one card (``models/transformer.encode``, the
         ``enc-attn`` layers, cross-attention and its cache, plain tensor
         code; no kernel of ``csrc/`` but the lookup's), seed 3.  (z1)
         ``whisper_large_v3`` at its published config (32 encoder + 32
         decoder layers, d_model 1,280, 20/20 heads × 64, d_ff 5,120,
         LayerNorm + GELU, vocab 51,866, encoder_seq 1,500 in the flash loop
         at attn_chunk 1,024; f32 masters, bf16 activations, 1,600,783,360
         parameters by ``n_params()``) with the kNN-LM head as in (v): 16,384
         keys from 32 × 513 tokens (the decoder without frames), seeded
         standard normal frames (2, 1,500, 1,280), ``prefill(frames=)`` of 2 ×
         256 tokens, then 8 greedy ``decode_step_retrieval`` steps (8
         ``knn_tile_topk`` launches counted: the prefill's logits are bare).
         Held: (a) each decoder layer's prefill cross cache equals
         ``init_cross_cache`` of ``encode(frames)`` bit for bit; (b) the
         serving loop's LM logits and ``forward_seq(frames=)``'s over the
         same 264 tokens against a float32 forward by (r)'s criterion; (c)
         the prefill's last logits with and without the frames differ by
         more than ``Z_FRAMES_RATIO`` times the bf16 forward's relative RMS
         gap to float32.  ``encode`` ms alone, prefill s, decode ms a step
         (LM and lookup), tokens/s after the prefill, peak memory, one
         profiled decode step.  (a) holds the lookup's first call at D =
         1,280.
  (za)   the VLM on one card (``models/transformer``'s ``mm_projector``,
         ``forward_seq(patches=)``, ``prefill(patches=)``, plain tensor code;
         no kernel of ``csrc/`` but the lookup's), seed 3.  (za1)
         ``llava_next_mistral_7b`` at its published config (32 layers,
         d_model 4,096, 32/8 heads × 128, d_ff 14,336, vocab 32,000, rope θ
         1e6, attn_chunk 1,024; 2,880 patches of 1,024 CLIP features through
         the projector; f32 masters, bf16 activations, 7,262,703,616
         parameters) with the kNN-LM head as in (v): 16,384 keys from 32 × 513
         tokens (the decoder without patches), seeded standard normal patches
         (2, 2,880, 1,024), ``prefill(patches=)`` of 2 × 256 tokens, then 8
         greedy ``decode_step_retrieval`` steps from position 2,880 + 256 (8
         ``knn_tile_topk`` launches counted).  Held: (a) a prefill of other
         prompts after the same patches leaves every layer's K/V at the 2,880
         patch positions bit for bit the same; (b) the serving loop's LM
         logits and ``forward_seq(patches=)``'s over the same 2,880 + 264
         positions against a float32 forward by (r)'s criterion; (c) the
         prefill's last logits with and without the patches differ by more
         than ``ZA_PATCHES_RATIO`` times the bf16 forward's relative RMS gap
         to float32.  The projector's ms alone, prefill s, decode ms a step
         (LM and lookup), tokens/s after the prefill, peak memory, one
         profiled decode step.  (a) holds the lookup's first call at D =
         4,096.
  (zb)   frames and patches in the slot program (``models/spmd.py``'s
         encoder per data group, cross-attention and its cache, the
         projector; no kernel of ``csrc/``) on ``make_host_mesh(4,
         slots=8)``'s 2 × 4 slots on ``cuda:0``, bf16 weights from seed 3,
         at the published widths.  (zb1) ``whisper_large_v3`` with 8 encoder
         and 8 decoder layers (5 heads a slot; the cross K/V split by
         heads): seeded frames (2, 1,500, 1,280), ``build_prefill``'s step
         on 2 × 256 tokens (1 row a data group), then 4 ``build_decode``
         steps.  (zb2) ``llava_next_mistral_7b`` with 8 layers: seeded
         patches (2, 2,880, 1,024), the prefill of 2 × 256 text tokens, 4
         steps from position 2,880 + 256.  Each prefill's and step's logits
         (gathered) held to the one-device ``transformer.prefill`` /
         ``decode_step`` by (w)'s criteria against a float32 run of the same
         weights; (zb1) every layer's gathered cross K/V within
         ``W_STATE_RATIO`` times the one-device bf16 cross cache's gap to
         float32, and other frames move the sharded prefill's logits by
         more than ``Z_FRAMES_RATIO`` times the bf16 gap; (zb2) a sharded
         prefill of other prompts leaves every layer's K/V at the 2,880
         patch positions bit for bit, and other patches move the logits by
         more than ``ZA_PATCHES_RATIO`` times the bf16 gap.  Prefill s,
         decode ms a step and the card's kernels a step beside the
         one-device functions', one profiled decode step of each (busy
         share, ``spmd.collective`` device time).  (zb3) one sharded train
         step of each against the one-device ``make_train_step`` by (t1)'s
         bounds: whisper at 4 + 4 layers on 2 × 256 tokens with frames (bf16
         activations), llava at 2 layers on 2 × (2,880 patches + 256 tokens)
         in float32; step s, peak memory.  (zb4) the dry run of (zb1)'s
         decode cell (the cross K/V among its arguments) and of (zb2)'s
         prefill cell (the patches among them) on 2 × 4 ``meta`` slots:
         per-slot argument and output bytes equal to the card's.

(a) also holds the kernel shapes (m) first launched:
``knn_stream_topk_prefetch`` and ``knn_tile_topk`` at the projected 6 dims,
``distance_bin_histogram`` over the projected corpus, ``knn_tile_topk[ip]`` at
518 dims; and the shapes of (o)'s first 128-row micro-batch: its dense call and
its brute call over the 5M corpus.

Each path — (b)–(d), (e), (g), (h), (i), (j), (k), (l), (m), (n), (o), (p),
(q1), (q2)–(q3), the ring of (q4), the rest of (q4), (r1), (r2), (r3), (s1),
(s2), (t1), (t2), (u1), (u2), (v1), (v2), (v3), the prefill and the decode
steps of (w1), (w1s) and (w2), each step of (w3), (x1), (x2), (x3), the
prefill and decode of (y1) and (y2), each step of (y3), (z1), (za1), the prefill
and the decode steps of (zb1) and (zb2), and each step of (zb3) —
sets the kernel launch counters to 0 just before it and reads them just
after; the ``kernels`` line's
main ``knn_stream_topk_prefetch`` and ``knn_tile_topk`` rows count the launches
of (b)–(d); (o)'s are on its own ``(serving micro-batch)`` rows, (q1)'s on the
``(sharded, per shard)`` rows, the ring's on ``(ring hop chunk)``, (r1)'s
and (r2)'s, (v1)'s, (v2)'s, (x1)'s, (z1)'s and (za1)'s on the ``(kNN-LM ...)`` rows.  The last lines are the card's name and power
limit, one JSON line with every kernel's numbers, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# (s2) replays training under torch.use_deterministic_algorithms(True),
# which needs cuBLAS's workspace pinned before the first cuBLAS call of the
# process (":4096:8" is PyTorch's own default size on Hopper).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores.  The kernels run fp32 FMA, so that is their peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12            # dense tensor-core bf16: (s)'s projections
FP32_U = 2.0 ** -24                 # unit roundoff of float32

K = 25
K_BF16 = 16                         # k + 8 ≤ 32: the bf16 streaming kernel runs
ORACLE_ROWS = 2048
FOREIGN_QUERIES = 65_536
BRUTE_QUERIES = 4096
RECORD_PROBE = 100                  # (c): a first-bucket query, one query block
K_PAST = 40                         # > MAX_UNROLLED_K: the brute lane's streamed route
PAST_QUERIES = 1024
PAST_CHUNK = 4096                   # the reference's corpus_chunk
FMA_POINTS = 107_000                # FMA's published |D| (data/pointclouds.py)
K_MUT = 16                          # (k): k_main = 16 + 16 headroom stays on the kernels
N_INSERT = 4096
N_DELETE = 16                       # base ids, and as many inserted ids
REFIMPL_RANKS = 4
K_PROJ = 10                         # the paper's FMA K (benchmarks/common.py)
PROJ_QUERIES = 4096                 # (m): FMA's last rows, foreign to the corpus
PROJ_DIM = 6
SERVE_REQUESTS = 2048              # (o): benchmarks/overload.py's trace length
SERVE_MAX_BATCH = 256              # two pad buckets: 128 and 256 rows
SERVE_LOADS = (0.5, 1.0, 2.0)      # offered load, × the measured 128-bucket rate
SERVE_SEED = 11                    # Poisson arrival gaps (overload.py's TRACE_SEED)
DEADLINE_BUCKETS = 4.0             # deadline = 4 × a 128-row batch's service
MAX_WAIT_BUCKETS = 0.5             # micro-batch wait cap, same units
SERVE_EXACT_ROWS = 256
SERVE_MEASURED_RUNS = 3           # (o)'s 2× run timed on the card, repeated
CRASH_QUERIES = 4096               # (p)
CRASH_DELETE = 5                   # per phase: at most 15 tombstones, headroom 16 at K_MUT
CRASH_PHASES = ("pre-latest",)     # (p): the crash points driven on the card (pre-arrays
                                   # and pre-manifest too, until the script neared its time
                                   # limit)
MESH_SHARDS = 4                    # (q1): four logical slots, all on cuda:0
MESH_SELF_ROWS = 524_288           # (q1) sharded self-join, (q4) ring joins (1,048,576 until
                                   # the script neared its time limit)
MESH_QUERIES = 4096                # (q2), (q3): the first rows of (c)'s batch
MESH_SERVE_REQUESTS = 1024         # (q2): KNNServer trace over the 2 × 2 index
MESH_DELETE = 5                    # (q3): base ids deleted on the 2 × 2 index
RING_CHUNK = 4096                  # (q4): the ring's corpus chunk
SPMD_ROWS = 262_144                # (q4): hybrid_join_spmd's corpus = queries
TIE = 1e-5                         # float64 distance gap of two ids that tie
LM_SEQS = 64                       # (r): corpus of 64 seeded sequences of 1,025 tokens,
LM_SEQ_LEN = 1025                  # 64 × 1,024 (hidden, next-token) pairs = 65,536 keys
LM_BATCH = 8                       # sequences per forward while collecting the pairs
LM_PROMPTS = 8                     # prompts corpus[:8, :256], 32 tokens generated
LM_PROMPT_LEN = 256
LM_GEN = 32
LM_SHARDS = 4                      # the IndexRetriever's 4 × 1 mesh and the ring
LM_SEED = 7                        # weights and corpus
LM_CHECK_STEPS = 4                 # decode steps held against the forward
TRAIN_SEED = 0                     # (s): launch/train.py's init seed
TRAIN_BATCH = 4                    # (s1): 4 × train_4k's 4,096 tokens a step
TRAIN_STEPS = 6                    # (s1): steps at the published config, cut twice for the
                                   # script's time limit (12, then 8)
# (s1) step 1 in bf16 activations against a float32 step of the same masters
# and batch: |Δloss| ≤ TRAIN_LOSS_TOL (0.2 % of the ~10.8 nats at init) and a
# relative grad_norm gap ≤ TRAIN_GNORM_RTOL.  The bf16 path rounds the
# residual stream to bf16 (unit roundoff 2^-8) some 5 times a layer over 16
# layers, so a token's logits may stray ~2 % of their unit scale; that part
# is random across the 16,384 tokens the loss and the gradient average
# over, and the bounds leave ~100× its averaged size for a systematic part.
TRAIN_LOSS_TOL = 0.02
TRAIN_GNORM_RTOL = 0.05
DRILL_LAYERS = 2                   # (s2): olmo_1b's width, depth cut to 2 layers
DRILL_SEQ = 1024
DRILL_BATCH = 4
DRILL_STEPS = 10
DRILL_EVERY = 5                    # --checkpoint-every
DRILL_FAULT = 7                    # --inject-fault
SPMD_MODEL = 4                     # (t): make_host_mesh(model=4, slots=8), 2 × 4 slots on cuda:0
SPMD_SLOTS = 8
SPMD_LAYERS = 4                    # (t1): olmo_1b's width, depth cut 16 → 4 (8 before the
                                   # script neared its time limit)
SPMD_STEPS = 6
SPMD_MORE = 2                      # (t2): steps after the elastic restore, 4 × 2 against 2 × 4
# (t1) step 1 on the 2 × 4 slots against the one-device step, both in bf16
# activations from the same masters and batch.  The slot program rounds in
# other places (each row-parallel partial rounded to bf16, then summed in
# float32; the vocab-parallel logsumexp), a subset of the roundings by which
# (s1)'s bf16 step differs from float32, so (s1)'s bounds apply to the loss
# and grad_norm.  Adam's first step moves a weight by lr·g/(|g| + eps) plus
# the decay, so two runs' masters differ by at most 2·lr where a gradient
# element sits within the rounding noise of 0 and flips sign:
# max gap ≤ 2·lr₁ + SPMD_MASTER_ATOL (float32 rounding of the masters), and
# at most SPMD_FLIP_SHARE of all elements apart by more than lr₁ — a block
# whose gradient were lost or taken from another shard would move all of it.
SPMD_MASTER_ATOL = 1e-6
SPMD_FLIP_SHARE = 0.05
SERVE_SEED = 0                     # (u): bf16 weights, prompt, cache and tokens
SERVE_PROMPT = 8192                # (u1): prefill_32k's prompt cut 32,768 → 8,192: uncut, (u)
                                   # took 299.6 s alone on an H100, past its 150 s; 16,384
                                   # until the script neared its time limit
SERVE_PREFILL_BATCH = 2            # (u1): prefill_32k's global batch 32 cut to 2 (one card)
SERVE_PREFILL_RUNS = 1             # (u1): timed sharded prefills (the first one checked)
SERVE_CACHE = 32_768               # (u2): decode_32k's cache, uncut
SERVE_DECODE_BATCH = 4             # (u2): decode_32k's global batch 128 cut to 4
SERVE_STEPS = 8                    # (u2): decode steps from pos = SERVE_CACHE − SERVE_STEPS (16
                                   # until the script neared its time limit)
# (u) the sharded serving steps against the one-device functions, both in
# bf16 from the same bf16 weights.  As in (t1), the slot program rounds in
# other places than the one-device step (each row-parallel partial rounded
# to bf16 and summed in float32; its per-head GEMMs), a subset of the
# roundings by which a bf16 forward differs from a float32 one.  At this
# width (r) measured that difference at 0.10 in the logits (max |Δ| over
# 40 logit rows, |logit| ≤ 4.9; two bf16 orders 0.07 apart): the logits stay
# within SERVE_LOGIT_ATOL, 5× that, and the argmax agrees wherever the
# reference's top two are further apart than twice the gap.  Cached K/V: the
# gap grows with depth (a CPU rehearsal at width 128 and 4 layers: relative
# RMS 0.7 % at layer 1, 1.2 % at layer 3; √depth to 16 layers ≈ 3 %), so a
# layer's relative RMS gap stays within SERVE_KV_RTOL (4× that); the first
# layer's within SERVE_KV0_RTOL (one projection of the same embedding: a
# GEMM's summation order at most).  A misplaced block, head or vocab slice
# moves its values by their own scale (relative gap ~1.4).
SERVE_LOGIT_ATOL = 0.5
SERVE_KV_RTOL = 2.0 ** -3
SERVE_KV0_RTOL = 2.0 ** -7
REC_SEED = 3                       # (v): weights, datastore corpus and prompts
REC_KEY_SEQS = 32                  # (v1), (v2): 32 seeded sequences of 513 tokens,
REC_KEY_LEN = 513                  # 32 × 512 (hidden, next-token) pairs = 16,384 keys
REC_BATCH = 2                      # prompts a generate call
REC_STEPS = 16                     # decode steps, each with the in-step lookup
W1_STEPS = 8                       # (w1)'s decode steps in the slot program (REC_STEPS until
                                   # the script neared its time limit)
W2_STEPS = 8                       # (w2)'s, 16 (REC_STEPS) before (zb) was paid for
RWKV_PROMPT = 512                  # (v1): rwkv6_3b's prefill, 2 × 512 tokens
RG_PROMPT = 2560                   # (v2): recurrentgemma_9b's, past its 2,048-token window
REC_TRAIN_LAYERS = 2               # (v3): rwkv6_3b's width, depth cut 32 → 2
REC_TRAIN_BATCH = 2
REC_TRAIN_SEQ = 1024
REC_TRAIN_STEPS = 2
W_LAYERS = 8                       # (w1), (w2): rwkv6_3b's 32 and recurrentgemma_9b's 38 layers
                                   # cut to 8 (recurrentgemma: 2 scanned groups + the 2-layer tail)
W_STRADDLE_MODEL = 16              # (w1s): make_host_mesh(16, slots=16), 160 channels a slot
W_STRADDLE_PROMPT = 128            # (w1s): 2 × 128 tokens, 4 decode steps
W_STRADDLE_STEPS = 4
# (w3): one step each, (depth, activation dtype, weight and moment dtype).
# rwkv6_3b's step runs in float32: in bf16 its gradient is dominated by
# rounding, so two bf16 steps agree on their loss, not on their gradient
# (on the CPU at width 256, 2 layers, 2 × 512 tokens, the bf16 gradient
# norm 6.350 one-device and 6.342 on 2 × 4 slots against 5.131 in float32,
# the embedding's and wk's twice their float32 norms; on an H100 at full
# width, depth 2, bf16 weights: 35.91 one-device and 21.99 on 2 × 4 slots,
# the losses 3.2e-4 apart, where the float32 step's norm is 217.2).
# recurrentgemma_9b's bf16 gradient holds (4.5619 one-device, 4.5618
# sharded against 4.5594 in float32 at width 512), and its float32 masters
# and moments would not fit twice on the card.
W_TRAIN = {"rwkv6_3b": (2, "float32", "float32"),
           "recurrentgemma_9b": (3, "bfloat16", "bfloat16")}
W_TRAIN_BATCH = 2                  # (w3): batch 2 × 256 (train_4k's 256 × 4,096 cut)
W_TRAIN_SEQ = 256
# (w) the recurrent layers in the slot program against the one-device
# functions, both in bf16 from the same bf16 weights: two bf16 runs of one
# function, the slot program rounding in other places (each row-parallel
# partial rounded to bf16, then summed in float32; GEMMs over a slot's
# columns), so each strays from a float32 run of the same weights about as
# far as the other.  Fixed bounds as (u)'s do not carry across widths here:
# CPU rehearsals (8 layers, bf16, 2 × 64 prompts, 4 decode steps; rwkv6_3b
# at widths 128, 512 and 1,024) measured the sharded logits' largest gap to
# the one-device logits at 0.13, 0.57 and 0.15 (SERVE_LOGIT_ATOL is 0.5),
# and a layer state's largest relative RMS gap at 4.6 %, 14.9 % and 4.3 %,
# as the one-device bf16 state's own gap to float32 moved (5.4 %, 17.4 %,
# 5.0 %).  So (w) holds the logits by (u)'s criterion and by (r)'s bf16
# criterion too (``logit_check``: at most twice the one-device bf16 logits'
# gap to the float32 run's, argmax equal away from ties), and each layer's
# state to W_STATE_RATIO times the one-device bf16 state's gap to its
# float32 run (the rehearsals' largest ratio 0.97), as (v) holds a chunked
# prefill.  A misplaced block, head or
# channel slice moves its values by their own scale (relative gap ~1.4).
W_STATE_RATIO = 2.0
X_PROMPT = 512                     # (x1), (x2): prompts of 2 × 512 tokens
X_QWEN_LAYERS = 2                  # (x2): qwen3_moe_235b_a22b's 94 layers cut to 2 (6.2 B
                                   # parameters; all 94 in bf16 are ~470 GB, past one card)
X_QWEN_STEPS = 8
X_CHECK_CAPACITY = 16.0            # decode against forward: a forward over the whole
                                   # sequence drops at 1.25 what a one-token decode keeps
X_TRAIN_LAYERS = 4                 # (x3): granite's width, depth cut 24 → 4
X_TRAIN_BATCH = 2
X_TRAIN_SEQ = 1024
X_TRAIN_STEPS = 2
# (x) decode against forward at capacity 16, both bf16, each against a
# float32 forward of the same weights.  A bf16 rounding that flips a token's
# 8th and 9th expert moves its output by a whole expert's share, and which
# tokens flip differs between two bf16 runs (the decode's products and
# attention have other shapes than the forward's), so the largest logit gap
# is set by a few flipped tokens, not by rounding alone.  CPU rehearsals of
# (x1) and (x2) at d_model 128, 256, 512 (granite 6 layers) and 1,024 (4),
# 2 × 96 prompts: 1.1–14.3 % of the (token, layer) top-8 sets differed
# between decode and forward; the largest logit gap reached 2.10 × the bf16
# forward's (granite at 128: (r)'s max-based bound of 2 does not carry),
# while the relative RMS gap stayed at 0.77–1.41 × the bf16 forward's.  So
# (x) holds the decode's relative RMS gap to the float32 logits to
# X_RMS_RATIO times the bf16 forward's own, and prints the max-based ratio.
X_RMS_RATIO = 2.0
Y_LAYERS = 8                       # (y1): granite_moe_1b_a400m's 24 layers cut to 8, float32
Y_PROMPT = 512                     # (y1), (y2): prompts of 2 × 512 tokens (1 row a data group)
Y_STEPS = 4                        # decode steps after each prefill
Y_QWEN_LAYERS = 2                  # (y2): qwen3_moe_235b_a22b's 94 layers cut to 2, as (x2)
Y_QWEN_CAPACITY = 16.0             # (y2): nothing dropped, (x)'s criterion applies
Y_TRAIN_LAYERS = 4                 # (y3): granite's width, depth cut 24 → 4, as (x3)
Y_TRAIN_BATCH = 2                  # (y3): 2 × 1,024 tokens (1 row a data group)
Y_TRAIN_SEQ = 1024
# (y1) in float32 the slot program differs from the one-device functions by
# the order of sums alone (GEMMs over a slot's router columns or experts,
# the row-parallel sums in float32), so where no token's top-8 set flips the
# kept assignments are the same and the logits agree to float32 rounding
# grown over 8 layers.  CPU rehearsals (8 layers, capacity 1.25, float32,
# 4 decode steps; d_model 256 on 2 × 96 tokens, granite's full width on
# 2 × 512): the logits within 3.1e-6 and 4.5e-6 of the one-device run's,
# the dropped counts equal in every layer; Y_F32_ATOL is ~40× that.  A
# flip happens only where a token's 8th and 9th probabilities tie within the
# rounding (Y_TIE): the layers up to the first flip are held, the rest
# printed.  A kept set taken from the wrong group's offsets moves whole
# experts' shares (the logits by their own scale).
Y_F32_ATOL = 2e-4
Y_TIE = 1e-5
Z_PARAMS = 1_600_783_360           # (z1): whisper_large_v3's n_params() (norms left out)
Z_PROMPT = 256                     # (z1): prompts of 2 × 256 tokens and 8 decode steps (16
Z_STEPS = 8                        # before (zb) was paid for): inside whisper's 448-token context
# (z1) check (c): the prefill's last logits with the frames and without them
# differ, by relative RMS, by more than Z_FRAMES_RATIO times the bf16
# forward's own relative RMS gap to float32, so a cross-attention that adds
# nothing fails.  CPU rehearsal (whisper at 4 + 4 layers, d_model 256, 4
# heads, d_ff 1,024, vocab 2,048, encoder_seq 1,500, 2 × 64 prompts, seed
# 3): with / without frames 1.1104 apart against a bf16 gap of 8.1991e-3, a
# ratio of 135.4.
Z_FRAMES_RATIO = 10.0
ZA_PARAMS = 7_262_703_616          # (za1): llava_next_mistral_7b's parameters: n_params()
                                   # 7,241,465,856 + the projector + the norm scales
ZA_PROMPT = 256                    # (za1): 2 × 256 text tokens after the 2,880 patches,
ZA_STEPS = 8                       # then 8 decode steps from position 2,880 + 256 (16 before
                                   # (zb) was paid for)
# (za1) check (c): the prefill's last logits with the patches and without
# them differ, by relative RMS, by more than ZA_PATCHES_RATIO times the bf16
# forward's own relative RMS gap to float32, so a projector that adds
# nothing fails.  (z)'s ratio.  CPU rehearsal (llava at 4 layers, d_model
# 256, 8/2 heads, d_ff 512, vocab 2,048, 2,880 patches of 1,024 features,
# 2 × 64 prompts, seed 3): with / without patches 1.3858 apart against a
# bf16 gap of 1.0535e-2, a ratio of 131.5.
ZA_PATCHES_RATIO = 10.0
ZB_LAYERS = 8                      # (zb1), (zb2): whisper_large_v3's 32 + 32 layers cut to 8 + 8,
                                   # llava_next_mistral_7b's 32 to 8, for the time limit
ZB_PROMPT = 256                    # (zb1), (zb2): 2 × 256 tokens (1 row a data group)
ZB_STEPS = 4                       # decode steps after each prefill
# (zb3): one step each, (depth — whisper's encoder too —, activation dtype).
# llava's 7.26 B float32 masters with AdamW would need ~116 GB; at depth 2
# its 0.72 B parameters hold ~11.5 GB of state a replica.
ZB_TRAIN = {"whisper_large_v3": (4, "bfloat16"), "llava_next_mistral_7b": (2, "float32")}
ZB_TRAIN_TEXT = 256                # (zb3): 2 × 256 text tokens (after llava's 2,880 patches)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synced(fn):
    """(fn(), its seconds on the host clock, the card synchronised before
    and after)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed(fn):
    """(fn(), milliseconds of that one call from CUDA events)."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, flops: float):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / FP32_FLOP_PER_S * 1e3
    return (max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations")


def score64(q, c, metric: str):
    """float64 scores of query rows ``q`` against rows ``c``: squared L2,
    −q·c (ip) or 1 − q·c (cosine, rows already unit-normalized)."""
    import torch
    if metric == "ip":
        return -(q @ c.T)
    if metric == "cosine":
        return 1.0 - q @ c.T
    return torch.clamp((q * q).sum(1, keepdim=True) + (c * c).sum(1)[None, :]
                       - 2.0 * q @ c.T, min=0.0)


def oracle64(points, queries, query_ids, k: int, metric: str = "l2",
             chunk: int = 262_144):
    """Exact float64 k best (scores, ids) of ``queries`` over ``points`` on
    the card; ``query_ids`` (or None) are excluded."""
    import torch
    q = queries.double()
    best_d = best_i = None
    for c0 in range(0, points.shape[0], chunk):
        d2 = score64(q, points[c0:c0 + chunk].double(), metric)
        if query_ids is not None:
            local = query_ids.long() - c0
            hit = (local >= 0) & (local < d2.shape[1])
            d2[hit.nonzero()[:, 0], local[hit]] = float("inf")
        vd, vi = torch.topk(d2, k, dim=1, largest=False)
        vi = vi + c0
        if best_d is None:
            best_d, best_i = vd, vi
        else:
            best_d, sel = torch.topk(torch.cat([best_d, vd], 1), k, dim=1, largest=False)
            best_i = torch.cat([best_i, vi], 1).gather(1, sel)
    return best_d, best_i


def check_exact(points, queries, query_ids, got_d, got_i, what: str, metric: str = "l2",
                fp32_bound: bool = False):
    """Reported distances and ids against the float64 oracle: the returned
    set's float64 scores equal the true k best (up to fp32 rounding of
    near-ties) and each reported distance is its id's (Euclidean for l2,
    1 − cos for cosine, −q·c for ip).

    Tolerances: the set's scores within 1e-5 · scale, scale = max(1,
    largest oracle score), and reported distances within 1e-4 · scale.  With ``fp32_bound`` (rows
    wider than 32 dims, where the brute lane's expansion form
    |q|² + |c|² − 2q·c errs by up to ``expansion_bound``, which grows with
    the width) each row r is held to its own: the set to
    e_r = max over c of expansion_bound(|q_r|, |c|, D), c over the row's
    returned and oracle ids, and each reported distance d to that bound
    carried to d, min(e_r / d, √e_r) — or the fixed tolerance where that is
    larger.  Prints how many rows exceeded the fixed tolerance and the
    largest ratio of a row's error to its bound."""
    import torch
    k = got_i.shape[1]
    od2, oi = oracle64(points, queries, query_ids, k, metric)
    gi = torch.as_tensor(got_i, device=points.device).long()
    assert (gi >= 0).all(), f"{what}: missing neighbors"
    if query_ids is not None:
        assert not (gi == query_ids.long()[:, None]).any(), f"{what}: self pair returned"
    q = queries.double()
    c = points[gi].double()
    if metric == "l2":
        realized = ((c - q[:, None, :]) ** 2).sum(-1)
        want_d = torch.sqrt(od2)
    else:
        dot = (c * q[:, None, :]).sum(-1)
        realized = -dot if metric == "ip" else 1.0 - dot
        want_d = od2
    rd2 = torch.sort(realized, dim=1).values
    scale = max(1.0, od2.abs().max().item())
    gd = torch.as_tensor(got_d, device=points.device).double()
    set_err = (rd2 - od2).abs()                                    # (Q, k)
    dist_err = (gd - want_d).abs()
    set_tol = torch.full_like(set_err, 1e-5 * scale)
    dist_tol = torch.full_like(dist_err, 1e-4 * scale)
    past_old = ((set_err > set_tol) | (dist_err > dist_tol)).any(1)
    if fp32_bound:
        cn = torch.maximum(c.norm(dim=-1).max(1).values,
                           points[oi].double().norm(dim=-1).max(1).values)
        e = expansion_bound(q.norm(dim=1), cn, q.shape[1])[:, None]   # (Q, 1)
        set_tol = torch.maximum(set_tol, e.expand_as(set_err))
        carried = torch.minimum(e / want_d.clamp(min=1e-300), torch.sqrt(e))
        dist_tol = torch.maximum(dist_tol, carried)
    ratio = torch.maximum(set_err / set_tol, dist_err / dist_tol).max(1).values
    log(f"  {what}: {len(gi)} rows vs float64 ({metric}): max |score(ids) − score_oracle| "
        f"{set_err.max().item():.3e}, max |d − d_oracle| {dist_err.max().item():.3e}; rows past "
        f"the fixed tolerance {int(past_old.sum())}, largest row error / bound "
        f"{ratio.max().item():.3f}" + (" (fp32 expansion bound per row)" if fp32_bound else ""))
    assert (set_err <= set_tol).all(), f"{what}: returned ids are not the exact k best"
    assert (dist_err <= dist_tol).all(), f"{what}: reported distances disagree with float64"


def expansion_sq_fp32(queries, points_t):
    """(Q, P) float32 d² in the kernels' own arithmetic (``score_tile.cuh``):
    the dot and both squared norms each a chain of multiply-adds over the
    dims in ascending order, then |q|² + |p|² − 2q·p.  ``points_t`` is the
    points transposed, (D, P).  ``addcmul_`` may round its multiply apart
    from the add where the kernel's ``fmaf`` does not: the same form and
    order, not the same last bits."""
    import torch
    q = queries.float()
    acc = torch.zeros(q.shape[0], points_t.shape[1], device=q.device)
    qq = torch.zeros(q.shape[0], 1, device=q.device)
    pp = torch.zeros(1, points_t.shape[1], device=q.device)
    for j in range(q.shape[1]):
        qj, pj = q[:, j:j + 1], points_t[j:j + 1]
        acc.addcmul_(qj, pj)
        qq.addcmul_(qj, qj)
        pp.addcmul_(pj, pj)
    return qq + pp - 2.0 * acc


def hist_windows(queries, points, qidx, bw, n_bins: int, chunk: int = 262_144):
    """Per-edge counts, (n_bins + 1,) each, of the pairs whose float64
    distance d lies so near a bin edge e·bw (1 ≤ e ≤ n_bins) that the kernel
    and the plain version may bin them apart, under two windows.

    The bound window: the kernel's expansion errs by at most
    e2 = (D+4)·u·(|q|+|p|)² in d², so by min(e2 / d, √e2) in d, and the
    plain difference form, the root and the divide by a few u·d; twice
    their sum.  At wide rows it covers much of a bin.

    The measured window, used to hold the kernel: one pass over the sample
    measures E2, the largest |d² − d²₆₄| of ``expansion_sq_fp32`` over the
    pairs that are not a query's own row, and R, the largest relative
    error in d of the plain version's difference form (``ref.py``'s
    arithmetic); the window is 2·(min(E2 / d, √E2) + R·d) + 4u·d (the root
    and the divide), never wider than the bound window.  The factor 2
    covers the kernel's last bits, which ``expansion_sq_fp32`` does not
    copy.  Returns (near under the bound window, near under the measured
    window, {"e2": E2, "e2_bound": the largest e2, "rel_plain": R})."""
    import math

    import torch
    dim = queries.shape[1]
    q32 = queries.float()
    q = q32.double()
    qq, qn = (q * q).sum(1)[:, None], q.norm(dim=1)[:, None]
    qid = qidx.long()[:, None]
    bw64 = bw.double()
    n_pts = points.shape[0]

    def chunk_d2(c0):
        p32 = points[c0:c0 + chunk].float()
        p = p32.double()
        d2 = torch.clamp(qq + (p * p).sum(1)[None, :] - 2.0 * q @ p.T, min=0.0)
        other = qid != c0 + torch.arange(p.shape[0], device=q.device)[None, :]
        return p32, p, d2, other

    e2k = rel_p = e2_bound = 0.0
    sub = max(1, (1 << 26) // max(1, q32.numel()))   # points a (Q, sub, D) difference holds
    for c0 in range(0, n_pts, chunk):
        p32, p, d2, other = chunk_d2(c0)
        d2k = expansion_sq_fp32(q32, p32.T.contiguous()).double()
        e2k = max(e2k, torch.where(other, (d2k - d2).abs(), 0.0).max().item())
        e2_bound = max(e2_bound, ((dim + 4) * FP32_U * (qn + p.norm(dim=1)[None, :]) ** 2)
                       .max().item())
        for s0 in range(0, p32.shape[0], sub):
            diff = q32[:, None, :] - p32[None, s0:s0 + sub, :]
            dp = torch.sqrt((diff * diff).sum(-1).double())
            d = torch.sqrt(d2[:, s0:s0 + sub])
            ok = other[:, s0:s0 + sub] & (d > 0)
            rel = torch.where(ok, (dp - d).abs() / torch.where(ok, d, 1.0), 0.0)
            rel_p = max(rel_p, rel.max().item())
    near_b = torch.zeros(n_bins + 1, dtype=torch.int64, device=q.device)
    near_m = torch.zeros_like(near_b)
    for c0 in range(0, n_pts, chunk):
        _, p, d2, _ = chunk_d2(c0)
        d = torch.sqrt(d2)
        e2 = (dim + 4) * FP32_U * (qn + p.norm(dim=1)[None, :]) ** 2
        w_bound = 2.0 * (torch.minimum(e2 / d, torch.sqrt(e2)) + (dim + 8) * FP32_U * d)
        w_meas = torch.minimum(w_bound, 2.0 * (torch.clamp(e2k / d, max=math.sqrt(e2k))
                                               + rel_p * d) + 4.0 * FP32_U * d)
        edge = torch.round(d / bw64)
        off = (d - edge * bw64).abs()
        on_edge = (edge >= 1) & (edge <= n_bins)
        for near, w in ((near_b, w_bound), (near_m, w_meas)):
            hit = (off < w) & on_edge
            near += torch.bincount(edge[hit].long(), minlength=n_bins + 1)
    return near_b, near_m, {"e2": e2k, "e2_bound": e2_bound, "rel_plain": rel_p}


def hold_hist(what, kc, rc, queries, points, qidx, bw, n_bins: int) -> float:
    """Hold a histogram kernel's counts ``kc`` against its plain version's
    ``rc`` on the same sample: bin b may differ by at most the pairs within
    ``hist_windows``'s measured window of its two edges.  Then the check's
    own test: the kernel's histogram shifted one bin up, and with 1% of its
    pairs (or the whole fullest bin, if less) moved from its fullest bin to
    the next, must both fail it; the log says whether the bound window
    would have failed them too.  Returns max |Δ|."""
    import math

    import torch
    near_b, near_m, st = hist_windows(queries, points, qidx, bw, n_bins)
    allow = (near_m[:-1] + near_m[1:]).to(kc.dtype)
    allow_b = (near_b[:-1] + near_b[1:]).to(kc.dtype)
    delta = (kc - rc).abs()
    err = delta.max().item()
    log(f"{what}: {tuple(queries.shape)} × {tuple(points.shape)} bin-count |Δ| max={err:.0f} "
        f"sum={delta.sum().item():.0f}; total kernel={kc.sum().item():.0f} "
        f"plain={rc.sum().item():.0f}; measured fp32 error: d² {st['e2']:.3e} (the bound "
        f"{st['e2_bound']:.3e}), plain form's relative {st['rel_plain']:.3e}; pairs near an "
        f"edge: measured window {int(near_m.sum())}, bound window {int(near_b.sum())}; per-bin "
        f"allowance max {allow.max().item():.0f} (bound window {allow_b.max().item():.0f}), "
        f"largest |Δ|/allowance {(delta / allow.clamp(min=1)).max().item():.3f}")
    bad = (delta > allow).nonzero()[:, 0].tolist()
    assert not bad, f"{what}: bins {bad[:8]} differ beyond their edge pairs"
    shifted = torch.cat([kc.new_zeros(1), kc[:-1]])
    moved = kc.clone()
    b = int(kc.argmax())
    m = min(float(math.ceil(0.01 * kc.sum().item())), kc[b].item())
    moved[b] -= m
    moved[b + 1 if b + 1 < n_bins else b - 1] += m
    for name, wrong in (("shifted one bin up", shifted),
                        (f"{m / kc.sum().item():.2%} of the pairs moved a bin", moved)):
        dw = (wrong - rc).abs()
        caught, caught_b = bool((dw > allow).any()), bool((dw > allow_b).any())
        log(f"{what} self-test, the kernel's counts {name}: caught={caught} (largest "
            f"|Δ|/allowance {(dw / allow.clamp(min=1)).max().item():.3f}); the bound window "
            f"would catch it: {caught_b}")
        assert caught, f"{what}: the check passes a histogram {name}"
    return err


def stats_line(res, n_q: int) -> str:
    s = res.stats
    return (f"n_dense={s.n_dense} n_sparse={s.n_sparse} n_failed={s.n_failed} "
            f"n_uncertified={s.n_uncertified} t_wall={s.t_wall:.3f}s t_dense={s.t_dense:.3f}s "
            f"t_sparse={s.t_sparse:.3f}s t_brute={s.t_brute:.3f}s "
            f"queries/s={n_q / s.t_wall:.1f} n_engine_compiles={s.n_engine_compiles}")


def pair64(c, q, metric: str):
    """float64 score of candidate rows ``c`` against query rows ``q``
    (broadcast): squared L2, or −q·c under ip."""
    c, q = c.double(), q.double()
    return -(c * q).sum(-1) if metric == "ip" else ((c - q) ** 2).sum(-1)


def expansion_bound(qn, cn, dim: int):
    """Twice the fp32 error bound of the expansion form |q|² + |c|² − 2q·c
    (and of −q·c), 2·(D+4)·u·(|q|+|c|)², from float64 row norms."""
    return 2.0 * (dim + 4) * FP32_U * (qn + cn) ** 2


def hold_topk(what, pr, qpts, kd, ki, rd, ri, kf=None, rf=None, scored=None, eps2=None,
              metric="l2", fp32_bound=False):
    """Hold a kernel's top-k against its plain version on the same inputs.
    ``found`` flips must have a scored pair within 1e-4 of the ε² threshold
    in float64; on the other rows the inf pattern must agree, |Δd| ≤ 1e-4
    and every id mismatch must be a score tie within 1e-5 in float64
    (``pr[id]`` is candidate ``id``).  With ``fp32_bound`` (wide rows, where
    the expansion form's rounding grows with the width) each of those three
    tolerances is the pair's ``expansion_bound`` instead.  Returns
    (max |Δd|, id mismatches, found mismatches)."""
    import torch
    dim = qpts.shape[1]
    qn = qpts.double().norm(dim=1)
    cn = pr.double().norm(dim=1) if fp32_bound else None
    flips = ((kf != rf).nonzero()[:, 0] if kf is not None
             else torch.zeros((0,), dtype=torch.long, device=kd.device))
    flip_gap = tie_gap = 0.0
    for r in flips.tolist():
        c = scored(r)
        gap = (pair64(c, qpts[r], metric) - eps2.double()).abs()
        tol = expansion_bound(qn[r], c.double().norm(dim=1), dim) if fp32_bound else 1e-4
        assert (gap < tol).any(), f"{what}: row {r} found flip is {gap.min().item():.2e} off ε²"
        flip_gap = max(flip_gap, gap.min().item())
    ok = torch.ones(kd.shape[0], dtype=torch.bool, device=kd.device)
    ok[flips] = False
    assert (torch.isfinite(kd) == torch.isfinite(rd))[ok].all(), f"{what}: inf pattern"
    fin = torch.isfinite(rd) & ok[:, None]
    delta = (kd - rd).abs()
    err = delta[fin].max().item() if fin.any() else 0.0
    worst = 0.0
    if fp32_bound and fin.any():
        allow = expansion_bound(qn[:, None], cn[ri.clamp(min=0).long()], dim)
        worst = (delta.double() / allow)[fin].max().item()
    bad = ((ki != ri) & ok[:, None]).nonzero()
    tie_ok = True
    if len(bad):
        r, c = bad[:, 0], bad[:, 1]
        dk = pair64(pr[ki[r, c].long()], qpts[r], metric)
        dr = pair64(pr[ri[r, c].long()], qpts[r], metric)
        gaps = (dk - dr).abs()
        tie_gap = gaps.max().item()
        tol = expansion_bound(qn[r], cn[ri[r, c].long()], dim) if fp32_bound else 1e-5
        tie_ok = bool((gaps < tol).all())
    note = f" (largest |Δd|/bound {worst:.3f})" if fp32_bound else ""
    log(f"[a] {what}: max|Δd|={err:.3e}{note} id mismatches={len(bad)} (float64 "
        f"|Δd²| ≤ {tie_gap:.2e}) found mismatches={len(flips)} (float64 "
        f"|d² − ε²| ≤ {flip_gap:.2e})")
    assert tie_ok, f"{what}: an id mismatch is not a distance tie ({tie_gap:.2e})"
    assert (worst <= 1.0) if fp32_bound else (err <= 1e-4), \
        f"{what}: distances disagree with the plain version"
    return err, len(bad), len(flips)


def hold_pairwise(what, got, want, qpts, cpts, chunks_k, chunks_r, eps2, block_q, block_c):
    """Hold the pairwise kernel's (T, Q, C) tiles against its plain version:
    the tiles' SHORTC decisions (chunks accumulated) are identical; every
    entry of a tile agrees within twice the expansion form's fp32 bound
    (D+4)·u·(|q|+|c|)²; a skipped tile's entries exceed ε² on both sides.
    Returns (max |Δ|, tiles skipped)."""
    import torch
    assert torch.equal(chunks_k, chunks_r), \
        f"{what}: SHORTC skipped other tiles than the plain version"
    dim = qpts.shape[-1]
    qn = qpts.double().norm(dim=-1)
    cn = cpts.double().norm(dim=-1)
    allow = expansion_bound(qn[:, :, None], cn[:, None, :], dim)
    delta = (got.double() - want.double()).abs()
    err = delta.max().item()
    worst = (delta / allow).max().item()
    n_chunks = -(-dim // 128)
    t, nq, nc = got.shape
    skipped = (chunks_k < n_chunks)
    entry_skipped = skipped.repeat_interleave(block_q, 1).repeat_interleave(block_c, 2)
    if eps2 is not None and skipped.any():
        assert (got[entry_skipped] > eps2).all() and (want[entry_skipped] > eps2).all(), \
            f"{what}: a skipped tile holds an entry within ε²"
    log(f"[a] {what}: {tuple(got.shape)} max|Δ|={err:.3e} (largest Δ/allowance "
        f"{worst:.3f}); tiles skipped by SHORTC {int(skipped.sum())} of {skipped.numel()}")
    assert worst <= 1.0, f"{what}: distances disagree with the plain version"
    return err, int(skipped.sum())


def pairwise_bound(qpts, cpts, chunks, block_q, block_c, block_d=128):
    """(ms, by) for one pairwise call: inputs read once and the tiles written
    once; FLOPs of the chunks each tile actually accumulated."""
    t, nq, dim = qpts.shape
    nc = cpts.shape[1]
    d_done = (chunks.double() * block_d).clamp(max=dim)
    per_tile = (2.0 * block_q * block_c * d_done + 2.0 * (block_q + block_c) * d_done
                + 3.0 * block_q * block_c * chunks.double())
    nbytes = (qpts.numel() + cpts.numel() + t * nq * nc) * 4
    return bound(nbytes, per_tile.sum().item())


class FirstCall:
    """Within ``with``, keep the arguments of the first call of
    ``module.name`` that ``want(*args, **kwargs)`` accepts, and
    ``note(*args, **kwargs)`` of every call in ``notes``; with ``count`` (a
    counter read before and after each call) sum what the calls added in
    ``counted``.  Every call goes through unchanged, so the launch counters
    stay the callee's own."""

    def __init__(self, module, name, want=lambda *a, **kw: True, note=None, count=None):
        self.module, self.name, self.want, self.note = module, name, want, note
        self.count = count
        self.args = None
        self.notes = []
        self.counted = 0

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def spy(*a, **kw):
            if self.args is None and self.want(*a, **kw):
                self.args = (a, kw)
            if self.note is not None:
                self.notes.append(self.note(*a, **kw))
            if self.count is None:
                return fn(*a, **kw)
            n0 = self.count()
            out = fn(*a, **kw)
            self.counted += self.count() - n0
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class Spy:
    """Within ``with``, time every call of ``module.name`` (``module`` may be
    an instance) on the host clock with the card synchronised before and
    after, and keep each call's (args, kwargs, result) when ``keep``."""

    def __init__(self, module, name, keep=True):
        self.module, self.name, self.keep = module, name, keep
        self.times, self.calls = [], []

    def __enter__(self):
        import torch
        fn = self.orig = getattr(self.module, self.name)

        def spy(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            if self.keep:
                self.calls.append((a, kw, out))
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, b, lib_ms):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


STREAM_CU = "src/repro_torch/csrc/knn_stream.cu"
TOPK_CU = "src/repro_torch/csrc/knn_topk.cu"
PAIRWISE_CU = "src/repro_torch/csrc/pairwise_l2.cu"


def clear_of_ties(scores, allow):
    """(Q, k) mask of the ranks whose score lies farther than ``allow`` (per
    row, (Q, 1)) from both neighbouring ranks' scores; ``scores`` is (Q, k + 1)
    ascending, its last column closing the k-th rank."""
    step = (scores[:, 1:] - scores[:, :-1]).abs() > allow     # rank r to r + 1
    clear = step.clone()
    clear[:, 1:] &= step[:, :-1]
    return clear


def rel_rms(a, b):
    """‖a − b‖ / ‖b‖ over every element, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp(min=1e-300)).item()


def logit_check(what, got, fwd, f32):
    """(r)'s bf16 criterion: ``got`` (a path of the port in bf16) may stray
    from the float32 forward's logits ``f32`` at most twice as far as the
    bf16 forward ``fwd`` does, and its argmax must agree wherever the
    float32 top two are further apart than four times that."""
    noise, stray = (fwd - f32).abs().max().item(), (got - f32).abs().max().item()
    top2 = f32.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 4.0 * noise
    agree = got.argmax(-1) == f32.argmax(-1)
    log(f"  {what}: max |logit − float32 forward's| {stray:.4f} (≤ 2 × the bf16 forward's "
        f"{noise:.4f}); against the bf16 forward {(got - fwd).abs().max().item():.4f} (largest "
        f"|float32 logit| {f32.abs().max().item():.3f}); argmax agrees at {int(agree.sum())} of "
        f"{agree.numel()} ({int(sure.sum())} clear of a bf16 tie)")
    assert stray <= 2.0 * noise, f"{what}: strays from the forward beyond bf16 rounding"
    assert agree[sure].all(), f"{what}: an argmax differs from the forward's away from a tie"


def lm_phase(dev, kernels, reset_counts, read_counts, topk_check, hist_check):
    """(r) the kNN-LM serving path at olmo_1b's full width on the card;
    appends (a)'s three D = 2048 rows to ``kernels``."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import RetrievalConfig, get_config
    from repro_torch.core import HybridConfig
    from repro_torch.core import brute as brute_lib
    from repro_torch.kernels.bin_hist import ops as hist_ops
    from repro_torch.kernels.knn_topk import ops as topk_ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import knn_lm
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as lm
    from repro_torch.runtime import KNNIndex, ServerConfig

    t_r = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # examples/knn_lm_serve.py's retrieval head on the full model
    lm_cfg = dataclasses.replace(get_config("olmo_1b"), retrieval=RetrievalConfig(
        enabled=True, k=8, lam=0.9, temperature=1.0))
    kr = lm_cfg.retrieval.k
    model, init_ms = timed(lambda: lm.init_params(LM_SEED, lm_cfg, device=dev))
    n_par = sum(p.numel() for p in model.parameters())
    assert n_par == lm_cfg.n_params(), "(r) the model's parameter count is not the config's"
    log(f"[r] {lm_cfg.name}: {lm_cfg.n_layers} layers, d_model {lm_cfg.d_model}, {lm_cfg.n_heads} "
        f"heads, d_ff {lm_cfg.d_ff}, vocab {lm_cfg.vocab_size}, {lm_cfg.dtype} activations; "
        f"{n_par} parameters ({n_par * 4 / 2**30:.2f} GiB in f32) initialised on the card "
        f"from seed {LM_SEED} in {init_ms / 1e3:.3f}s")
    corpus = np.random.default_rng(LM_SEED).integers(0, lm_cfg.vocab_size, (LM_SEQS, LM_SEQ_LEN))
    batches = [corpus[i:i + LM_BATCH] for i in range(0, LM_SEQS, LM_BATCH)]
    prompts = corpus[:LM_PROMPTS, :LM_PROMPT_LEN]
    want = corpus[:LM_PROMPTS, LM_PROMPT_LEN:LM_PROMPT_LEN + LM_GEN]
    n_keys = LM_SEQS * (LM_SEQ_LEN - 1)

    def serve_run(ds, what, look=None):
        """``generate`` LM_GEN tokens for the prompts: wall time, prefill time,
        and each decode step's LM (``decode_step_hidden``) and retrieval
        (``look``) times apart.  Returns (tokens, accuracy, the lookup spy,
        the LM's mean ms a step)."""
        spies = [Spy(lm, "prefill_hidden", keep=False), Spy(lm, "prefill", keep=False),
                 Spy(lm, "decode_step_hidden", keep=False)]
        spies += [Spy(*look)] if look is not None else []
        with contextlib.ExitStack() as stack:
            for sp in spies:
                stack.enter_context(sp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = serve.generate(model, lm_cfg, prompts, LM_GEN, ds=ds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        assert tuple(out.shape) == (LM_PROMPTS, LM_GEN)
        acc = float((out.cpu().numpy() == want).mean())
        lm_t = np.array(spies[2].times) * 1e3
        ret_t = np.array(spies[3].times[1:]) * 1e3 if look is not None else np.zeros(1)
        rest = wall * 1e3 - sum(sp_.times[0] * 1e3 for sp_ in spies[:2] if sp_.times) \
            - lm_t.sum() - (np.array(spies[3].times).sum() * 1e3 if look is not None else 0.0)
        log(f"[r] generate, {what}: {LM_PROMPTS} × {LM_GEN} tokens in {wall:.3f}s "
            f"({LM_PROMPTS * LM_GEN / wall:.1f} tokens/s); prefill of {LM_PROMPTS} × "
            f"{LM_PROMPT_LEN} {sum(sp_.times[0] for sp_ in spies[:2] if sp_.times) * 1e3:.2f} ms; "
            f"per decode step: LM {lm_t.mean():.3f} ms [{lm_t.min():.3f}–{lm_t.max():.3f}], "
            f"retrieval {ret_t.mean():.3f} ms [{ret_t.min():.3f}–{ret_t.max():.3f}], the rest "
            f"(unembed, mixing, sampling) {rest / LM_GEN:.3f} ms; continuation accuracy {acc:.4f}")
        return out, acc, (spies[3] if look is not None else None), lm_t.mean()

    # (r1) examples/knn_lm_serve.py's path: an IndexRetriever over a 4 × 1 mesh
    # of slots on the card, metric="ip", behind KNNServer; retrieval on and off.
    reset_counts()
    hcfg = HybridConfig(k=kr, metric="ip")
    with Spy(knn_lm, "collect_pairs") as collect, \
            FirstCall(hist_ops, "distance_bin_histogram") as r_hist:
        t0 = time.perf_counter()
        ret = knn_lm.IndexRetriever.build(model, lm_cfg, batches,
                                          mesh=make_serving_mesh(LM_SHARDS, device=dev),
                                          hybrid_config=hcfg,
                                          server_config=ServerConfig(deadline=5.0))
        t_build = time.perf_counter() - t0
    keys, vals = collect.calls[0][2]
    assert keys.shape == (n_keys, lm_cfg.d_model) and n_keys == lm_cfg.retrieval.datastore_size
    log(f"[r1] datastore of {n_keys} keys × {keys.shape[1]} dims ({keys.nbytes / 2**20:.0f} MiB): "
        f"collect_pairs over {LM_SEQS} × {LM_SEQ_LEN} tokens in batches of {LM_BATCH} "
        f"{collect.times[0]:.3f}s, then the index build {t_build - collect.times[0]:.3f}s "
        f"({ret.index.n_shards} shards, eps={ret.index.eps:.6g}, metric=ip)")
    with FirstCall(topk_ops, "knn_topk", lambda *a, **kw: kw.get("metric") == "ip") as r1_call:
        out_ret, acc_ret, look_ret, _ = serve_run(
            ret, "retrieval on (IndexRetriever, 4 × 1 mesh, KNNServer)", (ret, "lookup"))
    m = ret.server.metrics()
    log(f"[r1] server: {m['n_served']} served / {m['n_shed_total']} shed over {m['n_batches']} "
        f"batches, p50 {m['p50_response_s'] * 1e3:.3f} ms")
    _, acc_base, _, lm_ms = serve_run(None, "retrieval off")
    launches_r1 = read_counts("(r1) kNN-LM, IndexRetriever on a 4 × 1 mesh")
    log(f"[r1] continuation accuracy on memorized prompts: retrieval on (λ="
        f"{lm_cfg.retrieval.lam}) {acc_ret:.4f}, off {acc_base:.4f}")
    assert acc_ret > acc_base, "(r1) retrieval should help on memorized text"
    assert m["n_shed_total"] == 0, "(r1) a retrieval request was shed"
    for name in ("knn_tile_topk[ip]", "distance_bin_histogram"):
        assert launches_r1.get(name, 0) > 0, f"(r1) never launched {name}"
    # The first decode step's retrieval: the same as a direct query, exact
    # against float64 over all keys, and the same through an unsharded index.
    (q1,), _, (d_srv, v_srv) = look_ret.calls[1]
    direct = ret.index.query(q1, k=kr)
    assert np.array_equal(direct.dists, d_srv), "(r1) the server's answer is not the index's"
    assert np.array_equal(vals[direct.ids], v_srv)
    keys_d = torch.as_tensor(keys, device=dev)
    q1_d = torch.as_tensor(q1, device=dev)
    check_exact(keys_d, q1_d, None, direct.dists, direct.ids,
                "(r1) first decode step's retrieval, 4 shards", metric="ip", fp32_bound=True)
    od, oi = oracle64(keys_d, q1_d, None, kr + 1, "ip")
    e1 = expansion_bound(q1_d.double().norm(dim=1), keys_d.double().norm(dim=1).max(),
                         keys.shape[1])[:, None]
    clear1 = clear_of_ties(od, e1)
    assert torch.equal(torch.as_tensor(direct.ids, device=dev).long()[clear1],
                       oi[:, :kr][clear1]), "(r1) an id differs from float64's away from a tie"
    flat = knn_lm.IndexRetriever(KNNIndex.build(keys, hcfg, device=dev), vals)
    d_flat, v_flat = flat.lookup(q1, k=kr)
    dd = np.abs(d_flat.astype(np.float64) - d_srv)
    same = "bit-identical" if np.array_equal(d_flat, d_srv) else "not bit-identical"
    log(f"[r1] ids equal to float64's at the {int(clear1.sum())} of {direct.ids.size} ranks clear "
        f"of ties; an unsharded IndexRetriever: {same} scores (max |Δ| {dd.max():.3e}), values "
        f"equal at {int((v_flat == v_srv).sum())} of {v_srv.size}")
    clear1 = clear1.cpu().numpy()
    assert (dd <= e1.cpu().numpy()).all() and (v_flat[clear1] == v_srv[clear1]).all(), \
        "(r1) the unsharded retriever's answer differs"
    del flat, keys_d, ret

    # (r2) the in-step path: a Datastore (REORDER, no truncation) and the
    # l2 lookup inside each decode step.
    reset_counts()
    t0 = time.perf_counter()
    ds = knn_lm.build_datastore(model, lm_cfg, batches)
    torch.cuda.synchronize()
    log(f"[r2] build_datastore {time.perf_counter() - t0:.3f}s: keys {tuple(ds.keys.shape)}")
    assert tuple(ds.keys.shape) == (n_keys, lm_cfg.d_model)
    with FirstCall(topk_ops, "knn_topk") as r2_call:
        _, acc_ds, look_ds, _ = serve_run(ds, "retrieval on (Datastore, l2 lookup in each step)",
                                       (knn_lm, "lookup"))
    launches_r2 = read_counts("(r2) kNN-LM, Datastore lookup")
    assert launches_r2.get("knn_tile_topk", 0) > 0, "(r2) never launched knn_tile_topk"
    assert acc_ds > acc_base, "(r2) in-step retrieval should help on memorized text"
    (_, h1), _, (d2_1, v_1) = look_ds.calls[1]
    qp = knn_lm._project(ds, h1)
    qids = ds.size + torch.arange(qp.shape[0], dtype=torch.int32, device=dev)
    bd, bi = brute_lib.brute_knn(ds.keys, qp, qids, k=kr)
    assert torch.equal(bd, d2_1) and torch.equal(ds.values[bi.long()], v_1), \
        "(r2) the lookup is not the brute lane's answer"
    check_exact(ds.keys, qp, None, torch.sqrt(bd.clamp(min=0)).cpu().numpy(), bi.cpu().numpy(),
                "(r2) first decode step's lookup (l2)", fp32_bound=True)

    # (r3) the ring: the datastore sharded over 4 slots on the card, every
    # step's queries at once, against (r2)'s lookup on the same queries.
    reset_counts()
    hs = torch.cat([c[0][1] for c in look_ds.calls])
    ring = knn_lm.sharded_lookup(make_serving_mesh(LM_SHARDS, device=dev), "shard", k=kr)
    (rd, rv), ring_ms = timed(lambda: ring(knn_lm._project(ds, hs), ds.keys, ds.values))
    launches_r3 = read_counts("(r3) sharded_lookup ring")
    assert launches_r3.get("knn_tile_topk", 0) == LM_SHARDS, "(r3) one launch a ring step"
    fd, fv = knn_lm.lookup(ds, hs, k=kr + 1)
    qh = knn_lm._project(ds, hs).double()
    e3 = expansion_bound(qh.norm(dim=1), ds.keys.double().norm(dim=1).max(), qh.shape[1])[:, None]
    clear3 = clear_of_ties(fd.double(), e3)
    fd, fv = fd[:, :kr], fv[:, :kr]
    delta = (rd.double() - fd.double()).abs()
    same = "bit-identical" if torch.equal(rd, fd) else "not bit-identical"
    log(f"[r3] ring over {LM_SHARDS} slots, {hs.shape[0]} queries × {ds.size} keys: "
        f"{ring_ms:.3f} ms; against lookup: {same} distances (max |Δd²| "
        f"{delta.max().item():.3e}), values equal at {int((rv == fv).sum())} of {rv.numel()} "
        f"({int(clear3.sum())} ranks clear of ties)")
    assert (delta <= e3).all() and torch.equal(rv[clear3], fv[clear3]), \
        "(r3) the ring differs from the unsharded lookup"

    # Decode matches forward at full width (tests/test_models.py's check, in
    # bf16): logits of the prefill's last position and LM_CHECK_STEPS decode
    # steps against forward_seq over the same tokens.  The bf16 paths round
    # in different places, so each is held to the float32 forward of the
    # same master weights: the decode may stray from it at most twice as far
    # as the bf16 forward does, and its argmax must agree wherever the float32
    # top two are further apart than twice that.
    cfg32 = dataclasses.replace(lm_cfg, dtype="float32")
    toks = corpus[:LM_PROMPTS, :LM_PROMPT_LEN + LM_CHECK_STEPS]
    with torch.no_grad():
        last = slice(LM_PROMPT_LEN - 1, LM_PROMPT_LEN + LM_CHECK_STEPS)
        fwd, f32 = (lm_layers.unembed(model.embed, c, lm.forward_seq(model, c, toks)[0][:, last])
                    for c in (lm_cfg, cfg32))
        lg, cache = lm.prefill(model, lm_cfg, prompts, LM_PROMPT_LEN + LM_CHECK_STEPS)
        dec = [lg]
        for t in range(LM_PROMPT_LEN, LM_PROMPT_LEN + LM_CHECK_STEPS):
            lg, cache = lm.decode_step(model, lm_cfg, toks[:, t], cache, t)
            dec.append(lg)
        dec = torch.stack(dec, 1).float()
    del cache
    log(f"[r] decode matches forward over {dec.shape[1]} positions × {LM_PROMPTS} rows:")
    logit_check("(r) prefill + decode", dec, fwd.float(), f32)

    # One decode step under torch.profiler (printed, not gated): the device
    # events the LM's step makes and how long the card is busy in them,
    # against the step's unprofiled time in (r1)'s bare run.
    _, cache = lm.prefill(model, lm_cfg, prompts, LM_PROMPT_LEN + 1)
    tok = torch.as_tensor(want[:, 0], device=dev)
    lm.decode_step_hidden(model, lm_cfg, tok, cache, LM_PROMPT_LEN)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        lm.decode_step_hidden(model, lm_cfg, tok, cache, LM_PROMPT_LEN)
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    log(f"[r] one LM decode step under torch.profiler: {len(dev_ev)} device events, the card "
        f"busy {busy:.3f} ms of the step's {lm_ms:.3f} ms unprofiled (busy share "
        f"{busy / lm_ms:.3f})" if dev_ev else
        "[r] one LM decode step under torch.profiler: no device events recorded")
    del cache

    # -- (a) the D = 2048 kernel calls (r) made ---------------------------------
    (q3r, c3r, qid3r, cid3r), kw3r = r1_call.args
    kernels.append(topk_check("knn_tile_topk[ip] (kNN-LM, D=2048)", q3r, c3r, qid3r, cid3r, "ip",
                              launches_r1["knn_tile_topk[ip]"], fp32_bound=True, k=kw3r["k"]))
    (q3l, c3l, qid3l, cid3l), kw3l = r2_call.args
    kernels.append(topk_check("knn_tile_topk (kNN-LM lookup, D=2048)", q3l, c3l, qid3l, cid3l,
                              "l2", launches_r2["knn_tile_topk"], fp32_bound=True, k=kw3l["k"]))
    (q4r, p4r, bwr, nbr), kw4r = r_hist.args
    kernels.append(hist_check("distance_bin_histogram (kNN-LM datastore, D=2048)", q4r, p4r,
                              kw4r["self_indices"], bwr, nbr,
                              launches_r1["distance_bin_histogram"]))
    log(f"[r] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_r:.2f}s")
    del model, ds, r1_call, r2_call, r_hist, q3r, c3r, q3l, c3l, q4r, p4r


def train_phase(dev, reset_counts, read_counts):
    """(s) the dense training path at olmo_1b's full width on the card:
    (s1) TRAIN_STEPS steps of ``make_train_step`` at the published config,
    (s2) ``launch/train.py`` end to end at depth DRILL_LAYERS with a fault
    drill and a resume."""
    import dataclasses
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as lm
    from repro_torch.optim import OptConfig, global_norm, init_opt_state
    from repro_torch.utils import tree_leaves

    card = torch.device("cuda", 0)
    t_s = time.perf_counter()

    def on_card(tensors, what):
        assert all(t.device == card for t in tensors), f"(s) {what} not all on cuda:0"

    # -- (s1) the published config, 12 steps ------------------------------------
    cfg = get_config("olmo_1b")
    shape = SHAPES["train_4k"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) == \
        (16, 2048, 16, 8192, 50304) and cfg.tie_embeddings and cfg.nonparam_norm
    assert cfg.remat and cfg.attn_chunk == 1024 and cfg.dtype == "bfloat16" \
        and cfg.param_dtype == cfg.opt_state_dtype == "float32"
    model = lm.init_params(TRAIN_SEED, cfg, device=dev)
    masters = list(model.parameters())
    n_par = sum(p.numel() for p in masters)
    assert n_par == cfg.n_params() == 1_176_764_416, "(s1) parameter count"
    opt_cfg = OptConfig(total_steps=TRAIN_STEPS, warmup_steps=1, moment_dtype=cfg.opt_state_dtype)
    state = {"params": model, "opt": init_opt_state(model.tree(), opt_cfg)}
    pipe = TokenPipeline(cfg, shape, batch_override=TRAIN_BATCH)
    tokens = TRAIN_BATCH * pipe.seq
    assert pipe.seq == 4096
    step = steps.make_train_step(cfg, opt_cfg)
    batch0 = pipe.next_batch(dev)
    on_card(masters, "masters")
    on_card(batch0.values(), "the batch")
    on_card(tree_leaves(state["opt"]), "the moments")
    b_master = sum(p.numel() * p.element_size() for p in masters)
    b_moment = sum(t.numel() * t.element_size() for t in tree_leaves(state["opt"]["mu"])) * 2
    b_cast = sum(p.numel() for p in masters) * cfg.activation_dtype().itemsize
    log(f"[s1] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype} activations, attn_chunk {cfg.attn_chunk}, remat {cfg.remat_policy}; "
        f"{n_par} parameters from seed {TRAIN_SEED}; batch {TRAIN_BATCH} × seq {pipe.seq} = "
        f"{tokens} tokens a step; state: masters {b_master / 2**30:.3f} GiB, grads "
        f"{b_master / 2**30:.3f} GiB, moments {b_moment / 2**30:.3f} GiB, cast copy "
        f"{b_cast / 2**30:.3f} GiB")

    # The float32 yardstick: the same masters and batch, float32 activations
    # (TF32 is off for the whole script).
    torch.cuda.reset_peak_memory_stats()
    (l32, _, g32), f32_s = synced(lambda: steps.loss_and_grads(
        model, dataclasses.replace(cfg, dtype="float32"), batch0))
    gn32 = global_norm(g32).item()
    peak32 = torch.cuda.max_memory_allocated()
    del g32
    log(f"[s1] float32 loss and gradient of step 1: loss {l32.item():.6f}, grad_norm "
        f"{gn32:.6f}, {f32_s:.3f}s, peak {peak32 / 2**30:.2f} GiB")

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, secs = [], [], []
    for i in range(TRAIN_STEPS):
        batch = batch0 if i == 0 else pipe.next_batch(dev)
        (state, m), sec = synced(lambda: step(state, batch))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        secs.append(sec)
        log(f"[s1] step {i + 1:2d}: loss {losses[-1]:.6f}, grad_norm {gnorms[-1]:.6f}, "
            f"lr {m['lr'].item():.3e}, {sec:.3f}s")
    peak = torch.cuda.max_memory_allocated()
    read_counts("(s1) train steps (no custom kernel on this path)")
    med = float(np.median(secs[1:]))
    d_loss, d_gn = abs(losses[0] - l32.item()), abs(gnorms[0] - gn32) / gn32
    log(f"[s1] {TRAIN_STEPS} steps: median step {med:.3f}s over steps 2–{TRAIN_STEPS} "
        f"[{min(secs[1:]):.3f}–{max(secs[1:]):.3f}], the first {secs[0]:.3f}s; "
        f"{tokens / med:.1f} tokens/s; peak device memory {peak / 2**30:.2f} GiB; loss mean of "
        f"the first 3 {np.mean(losses[:3]):.6f}, of the last 3 {np.mean(losses[-3:]):.6f}; "
        f"step 1 against float32: |Δloss| {d_loss:.3e} (≤ {TRAIN_LOSS_TOL}), grad_norm gap "
        f"{d_gn:.3e} (≤ {TRAIN_GNORM_RTOL})")
    assert np.isfinite(losses).all() and np.isfinite(gnorms).all(), "(s1) a non-finite loss"
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), f"(s1) the loss did not fall: {losses}"
    assert min(gnorms) > 0, "(s1) a zero gradient"
    assert d_loss <= TRAIN_LOSS_TOL, "(s1) step 1's loss strays from the float32 step's"
    assert d_gn <= TRAIN_GNORM_RTOL, "(s1) step 1's grad_norm strays from the float32 step's"
    on_card(tree_leaves(state["opt"]), "the moments after the steps")

    # One more step under torch.profiler (printed, not gated): how long the
    # card is busy in the step, and in what.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    batch = pipe.next_batch(dev)
    with torch.profiler.profile(activities=acts) as prof:
        (state, _), sec = synced(lambda: step(state, batch))
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[s1] one step under torch.profiler: the card busy {busy:.1f} ms of the step's "
        f"{sec * 1e3:.1f} ms (busy share {busy / (sec * 1e3):.3f}); by kernel: " +
        "; ".join(f"{name[:70]} {ms:.1f} ms" for name, ms in top) if by_name else
        "[s1] one step under torch.profiler: no device events recorded")

    def kind(name):
        # cuBLAS and CUTLASS name their float32 GEMMs sgemm / f32f32; the
        # step's only other matmuls are the bf16 products (cuBLAS's nvjet
        # kernels on this card).
        n = name.lower()
        if not any(w in n for w in ("gemm", "xmma", "cutlass", "nvjet")):
            return "the rest (elementwise, reductions, copies)"
        return "float32 GEMMs" if ("sgemm" in n or "f32f32" in n) else "other GEMMs"

    by_kind = {}
    for name, ms in by_name.items():
        by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + ms
    # The step's arithmetic from its shapes: the bf16 projections and MLPs
    # (every non-embedding weight, 2 FLOPs a token each), the float32 tied
    # unembedding, and the flash loop's float32 QKᵀ and PV over every
    # (query, key) chunk pair (olmo_1b has no causal skip); each run in the
    # forward, the remat recompute and the backward (twice the forward).
    d, h, hd, s_len = cfg.d_model, cfg.n_heads, cfg.hd, pipe.seq
    f_bf16 = 4 * 2 * (n_par - cfg.vocab_size * d) * tokens
    f_unembed = 4 * 2 * d * cfg.vocab_size * tokens
    f_flash = 4 * cfg.n_layers * 2 * 2 * TRAIN_BATCH * h * s_len * s_len * hd
    t_bf16, t_f32 = f_bf16 / BF16_FLOP_PER_S, (f_unembed + f_flash) / FP32_FLOP_PER_S
    log("[s1] device time by class: " + "; ".join(
        f"{k} {v:.1f} ms" for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])) +
        f".  The step's arithmetic at the published peaks: bf16 {f_bf16 / 1e12:.1f} TFLOP in "
        f"{t_bf16 * 1e3:.1f} ms; float32 {(f_unembed + f_flash) / 1e12:.1f} TFLOP (unembedding "
        f"{f_unembed / 1e12:.1f}, flash loop {f_flash / 1e12:.1f}) in {t_f32 * 1e3:.1f} ms; "
        f"together {(t_bf16 + t_f32) * 1e3:.1f} ms; the profiled step takes "
        f"{sec / (t_bf16 + t_f32):.2f}× that")
    del state, model, masters, batch0, batch, pipe, step, prof
    torch.cuda.empty_cache()

    # -- (s2) launch/train.py end to end, the fault drill and --resume -----------
    cut = dataclasses.replace(cfg, n_layers=DRILL_LAYERS)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    flags = ["--arch", "olmo_1b", "--steps", str(DRILL_STEPS), "--batch", str(DRILL_BATCH),
             "--seq", str(DRILL_SEQ), "--checkpoint-every", str(DRILL_EVERY), "--device", "cuda"]
    log(f"[s2] launch/train.py at olmo_1b's width with n_layers cut {cfg.n_layers} → "
        f"{DRILL_LAYERS} ({cut.n_params()} parameters), seq {DRILL_SEQ}, batch {DRILL_BATCH}, "
        f"{DRILL_STEPS} steps, a checkpoint every {DRILL_EVERY}, deterministic algorithms on")
    saves = Spy(CheckpointManager, "save", keep=False)
    writes = Spy(CheckpointManager, "_write", keep=False)
    loads = Spy(CheckpointManager, "restore", keep=False)
    torch.use_deterministic_algorithms(True)
    try:
        with mock.patch.object(train, "get_config", lambda arch: cut), saves, writes, loads:
            reset_counts()
            # The clean run's saves are never read: it saves its final state alone.
            t0 = time.perf_counter()
            clean = train.main(flags + ["--checkpoint-every", str(DRILL_STEPS),
                                        "--ckpt-dir", os.path.join(root, "clean")])
            run_s = [time.perf_counter() - t0]
            clean_report, clean_loss = clean.report, dict(clean.losses)
            final = [p.detach().clone() for p in clean.state["params"].parameters()]
            del clean
            shutil.rmtree(os.path.join(root, "clean"))
            drill_dir = os.path.join(root, "drill")
            t0 = time.perf_counter()
            drill = train.main(flags + ["--ckpt-dir", drill_dir,
                                        "--inject-fault", str(DRILL_FAULT)])
            run_s.append(time.perf_counter() - t0)
            on_card(list(drill.state["params"].parameters()) +
                    tree_leaves(drill.state["opt"]), "the drilled run's state")
            report, drill_losses = drill.report, drill.losses
            same_par = all(torch.equal(a, b) for a, b in
                           zip(final, drill.state["params"].parameters()))
            del drill
            step_dir = os.path.join(drill_dir, f"step-{DRILL_EVERY:09d}")
            n_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
            shutil.rmtree(os.path.join(drill_dir, f"step-{DRILL_STEPS:09d}"))
            os.remove(os.path.join(drill_dir, "LATEST"))
            t0 = time.perf_counter()
            resumed = train.main(flags + ["--ckpt-dir", drill_dir, "--resume"])
            run_s.append(time.perf_counter() - t0)
            read_counts("(s2) launch/train.py: clean, drilled and resumed runs")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    replayed = [st for st, _ in drill_losses]
    same_loss = all(clean_loss[st] == l for st, l in drill_losses)
    res_loss = all(clean_loss[st] == l for st, l in resumed.losses)
    res_par = all(torch.equal(a, b) for a, b in zip(final, resumed.state["params"].parameters()))
    log(f"[s2] clean run: losses {[round(clean_loss[k], 6) for k in sorted(clean_loss)]}")
    log(f"[s2] drilled run: completed={report.completed}, restarts {report.restarts}, failures "
        f"{report.failures}; steps executed {replayed}; losses bit-identical to the clean run's: "
        f"{same_loss}; final parameters bit-identical: {same_par}")
    log(f"[s2] --resume after the step-{DRILL_STEPS} checkpoint and LATEST were removed: steps "
        f"{[st for st, _ in resumed.losses]}, losses bit-identical: {res_loss}, final parameters "
        f"bit-identical: {res_par}")
    log(f"[s2] checkpoints: {n_bytes} bytes a save ({n_bytes / 2**30:.3f} GiB); save() "
        f"blocking (the snapshot to host memory, and waiting for the previous write) "
        f"{', '.join(f'{t:.3f}' for t in saves.times)} s; background write "
        f"{', '.join(f'{t:.3f}' for t in writes.times)} s; restore "
        f"{', '.join(f'{t:.3f}' for t in loads.times)} s; the runs' last saves wait in main; "
        f"the clean, drilled and resumed runs {', '.join(f'{t:.2f}' for t in run_s)} s")
    assert clean_report.completed and clean_report.restarts == 0, "(s2) the clean run failed"
    assert report.completed and report.restarts == 1, "(s2) the drill did not restart exactly once"
    assert report.failures == [
        (DRILL_FAULT, f"RuntimeError('injected fault at step {DRILL_FAULT}')")], \
        "(s2) a failure other than the injected fault"
    assert replayed == list(range(DRILL_FAULT)) + list(range(DRILL_EVERY, DRILL_STEPS))
    assert same_loss and same_par, "(s2) the replay differs from the uninterrupted run"
    assert resumed.report.completed and resumed.report.restarts == 0
    assert [st for st, _ in resumed.losses] == list(range(DRILL_EVERY, DRILL_STEPS)), \
        "(s2) --resume did not continue from the latest durable step"
    assert res_loss and res_par, "(s2) the resumed run differs from the uninterrupted run"
    log(f"[s] phase {time.perf_counter() - t_s:.2f}s")
    return {"median_s": med, "tokens_per_s": tokens / med, "peak": peak}


def device_time(prof, skip=()):
    """(ms by kernel name of the card's events, names in ``skip`` left
    out) from a ``torch.profiler`` run."""
    import torch
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in skip:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def profiled(fn):
    """One call of ``fn`` under ``torch.profiler``: (fn(), seconds on the host
    clock, the card's busy ms, the device ms under the outermost
    ``spmd.collective`` ranges, the number of ranges, the six largest
    kernels by device ms, the number of kernels the card ran)."""
    import torch
    from repro_torch.models import spmd

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out, sec = synced(fn)
    by_name = device_time(prof, skip=(spmd.COLLECTIVE,))
    launches = sum(e.device_type == torch.autograd.DeviceType.CUDA and
                   e.name != spmd.COLLECTIVE for e in prof.events())

    def nested(e):
        p = e.cpu_parent
        while p is not None:
            if p.name == spmd.COLLECTIVE:
                return True
            p = p.cpu_parent
        return False

    ranges = [e for e in prof.events()
              if e.name == spmd.COLLECTIVE and e.device_type == torch.autograd.DeviceType.CPU]
    coll = sum(e.device_time_total for e in ranges if not nested(e)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return out, sec, sum(by_name.values()), coll, len(ranges), top, launches


def profile_line(sec, busy, coll, n_ranges, top, launches) -> str:
    return (f"the card busy {busy:.1f} ms of the step's {sec * 1e3:.1f} ms (busy share "
            f"{busy / (sec * 1e3):.3f}, {launches} kernels); collectives ({n_ranges} "
            f"spmd.collective ranges) " +
            (f"{coll:.1f} ms of device time ({coll / busy:.4f} of busy)" if coll > 0 else
             "not measured (no device time under the ranges)") + "; by kernel: " +
            "; ".join(f"{name[:60]} {ms:.1f} ms" for name, ms in top))


def sharded_train_phase(dev, reset_counts, read_counts, s1):
    """(t) the sharded train step at olmo_1b's full width on a 2 × 4 mesh of
    logical slots on cuda:0: (t1) SPMD_STEPS steps of ``build_train``'s step
    at depth SPMD_LAYERS from seed TRAIN_SEED, step 1 held to the one-device
    step; (t2)
    ``launch/train.py`` on the 2 × 4 slots at depth DRILL_LAYERS with a
    fault drill, the latest save restored onto 4 × 2 and onto one device."""
    import dataclasses
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.sharding import NamedSharding, PartitionSpec
    from repro_torch.utils import tree_leaves

    t_t = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[t] device memory held from earlier phases: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # -- (t1) olmo_1b's width at depth SPMD_LAYERS on 2 × 4 slots -----------------
    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=SPMD_LAYERS)
    shape = SHAPES["train_4k"]
    mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device=dev)
    assert mesh.sizes == (SPMD_SLOTS // SPMD_MODEL, SPMD_MODEL)
    assert set(mesh.slot_devices) == {"cuda:0"}, "(t1) every slot on cuda:0"
    opt_cfg = OptConfig(total_steps=SPMD_STEPS, warmup_steps=1, moment_dtype=cfg.opt_state_dtype)
    step, _, (st_sh, _) = steps.build_train(cfg, shape, mesh, opt_cfg)
    pipe = TokenPipeline(cfg, shape, batch_override=TRAIN_BATCH)
    tokens = TRAIN_BATCH * pipe.seq
    batch0 = pipe.next_batch(dev)

    # The yardstick: the one-device step 1 on the same weights and batch.
    ref = lm.init_params(TRAIN_SEED, cfg, device=dev)
    fingerprint = ref.embed["tok"][:4096].clone()
    ref_state = {"params": ref, "opt": init_opt_state(ref.tree(), opt_cfg)}
    torch.cuda.reset_peak_memory_stats()
    (ref_state, ref_m), ref_s = synced(
        lambda: steps.make_train_step(cfg, opt_cfg)(ref_state, batch0))
    ref_peak = torch.cuda.max_memory_allocated()
    ref_loss, ref_gn, lr1 = (ref_m[k].item() for k in ("loss", "grad_norm", "lr"))
    del ref_state
    torch.cuda.empty_cache()
    log(f"[t1] the one-device step 1 (make_train_step on a Transformer): loss {ref_loss:.6f}, "
        f"grad_norm {ref_gn:.6f}, lr {lr1:.3e}, {ref_s:.3f}s, peak {ref_peak / 2**30:.2f} GiB")

    model = lm.init_params(TRAIN_SEED, cfg, device=dev)
    assert torch.equal(model.embed["tok"][:4096], fingerprint), "(t1) the seed drew other weights"
    state = steps.init_placed_state(model.tree(), opt_cfg, st_sh)
    del model, fingerprint
    torch.cuda.empty_cache()

    # Layout: each slot's bytes against the global bytes over the shard factor.
    def slot_bytes(tree):
        arrs = tree_leaves(tree)
        got = [sum(a.slot_nbytes(s) for a in arrs) for s in range(SPMD_SLOTS)]
        want = sum(int(np.prod(a.shape)) * a.blocks[0].element_size() // a.sharding.shard_factor
                   for a in arrs)
        glob = sum(int(np.prod(a.shape)) * a.blocks[0].element_size() for a in arrs)
        return got, want, glob

    b_master, w_master, g_master = slot_bytes(state["params"])
    b_mom, w_mom, g_mom = slot_bytes([state["opt"]["mu"], state["opt"]["nu"]])
    specs = sorted({str(a.sharding.spec) for a in tree_leaves(state["params"])})
    log(f"[t1] {cfg.name} (depth cut 16 → {cfg.n_layers} layers, width kept) on a "
        f"{mesh.sizes[0]} × {mesh.sizes[1]} mesh of {SPMD_SLOTS} slots "
        f"({dict(mesh.shape)}), batch {TRAIN_BATCH} × seq {pipe.seq} = {tokens} tokens a step, "
        f"{pipe.seq} tokens × {TRAIN_BATCH // mesh.sizes[0]} rows a data group; "
        f"specs {specs}; per slot: masters {b_master[0]} B (global {g_master} B / shard factor "
        f"= {w_master}), moments {b_mom[0]} B (global {g_mom} / factor = {w_mom}); all slots: "
        f"masters {sum(b_master) / 2**30:.3f} GiB, moments {sum(b_mom) / 2**30:.3f} GiB")
    assert b_master == [w_master] * SPMD_SLOTS and b_mom == [w_mom] * SPMD_SLOTS, \
        "(t1) a slot holds other bytes than its spec's share"

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, secs = [], [], []
    for i in range(SPMD_STEPS):
        batch = batch0 if i == 0 else pipe.next_batch(dev)
        (state, m), sec = synced(lambda: step(state, batch))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        secs.append(sec)
        log(f"[t1] step {i + 1}: loss {losses[-1]:.6f}, grad_norm {gnorms[-1]:.6f}, "
            f"lr {m['lr'].item():.3e}, {sec:.3f}s")
        if i == 0:
            gap, n_far, n_all = 0.0, 0, 0
            with torch.no_grad():
                for a, r in zip(tree_leaves(state["params"]), tree_leaves(ref.tree())):
                    d = (a.gather() - r).abs()
                    gap = max(gap, d.max().item())
                    n_far += int((d > lr1).sum().item())
                    n_all += d.numel()
            del ref, d
            torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    read_counts("(t1) sharded train steps (no custom kernel on this path)")
    med = float(np.median(secs[1:]))
    d_loss, d_gn = abs(losses[0] - ref_loss), abs(gnorms[0] - ref_gn) / ref_gn
    log(f"[t1] {SPMD_STEPS} steps: median step {med:.3f}s over steps 2–{SPMD_STEPS} "
        f"[{min(secs[1:]):.3f}–{max(secs[1:]):.3f}], the first {secs[0]:.3f}s; "
        f"{tokens / med:.1f} tokens/s ((s1) on one device: {s1['median_s']:.3f}s, "
        f"{s1['tokens_per_s']:.1f} tokens/s, peak {s1['peak'] / 2**30:.2f} GiB); peak device "
        f"memory {peak / 2**30:.2f} GiB; loss mean of the first 3 {np.mean(losses[:3]):.6f}, of "
        f"the last 3 {np.mean(losses[-3:]):.6f}")
    log(f"[t1] step 1 against the one-device step: |Δloss| {d_loss:.3e} (≤ {TRAIN_LOSS_TOL}), "
        f"grad_norm gap {d_gn:.3e} (≤ {TRAIN_GNORM_RTOL}), max |Δmaster| {gap:.3e} (≤ 2·lr₁ + "
        f"{SPMD_MASTER_ATOL} = {2 * lr1 + SPMD_MASTER_ATOL:.3e}), {n_far} of {n_all} masters "
        f"({n_far / n_all:.3e}) apart by more than lr₁ (≤ {SPMD_FLIP_SHARE})")
    assert np.isfinite(losses).all() and np.isfinite(gnorms).all(), "(t1) a non-finite loss"
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), f"(t1) the loss did not fall: {losses}"
    assert d_loss <= TRAIN_LOSS_TOL, "(t1) step 1's loss strays from the one-device step's"
    assert d_gn <= TRAIN_GNORM_RTOL, "(t1) step 1's grad_norm strays from the one-device step's"
    assert gap <= 2 * lr1 + SPMD_MASTER_ATOL, "(t1) a master strays past two steps"
    assert n_far <= SPMD_FLIP_SHARE * n_all, "(t1) too many masters off the one-device step"

    # One more step under torch.profiler (printed, not gated): busy share and
    # the device time of the collectives (spmd.collective ranges: the
    # broadcasts, row-parallel sums, vocab-parallel combines, their
    # backwards and the gradient sum over replicas).
    batch = pipe.next_batch(dev)
    (state, _), *prof = profiled(lambda: step(state, batch))
    log(f"[t1] one step under torch.profiler: {profile_line(*prof)}")
    del state, batch0, batch, pipe, step, prof
    torch.cuda.empty_cache()

    # -- (t2) launch/train.py on 2 × 4 slots, the fault drill, the elastic restore --
    cut = dataclasses.replace(cfg, n_layers=DRILL_LAYERS)
    root = tempfile.mkdtemp(prefix="chip_smoke_spmd_")
    flags = ["--arch", "olmo_1b", "--steps", str(DRILL_STEPS), "--batch", str(DRILL_BATCH),
             "--seq", str(DRILL_SEQ), "--checkpoint-every", str(DRILL_EVERY), "--device", "cuda",
             "--model-axis", str(SPMD_MODEL), "--slots", str(SPMD_SLOTS)]
    log(f"[t2] launch/train.py on {SPMD_SLOTS} slots (--model-axis {SPMD_MODEL}) at olmo_1b's "
        f"width with n_layers cut to {DRILL_LAYERS}, seq {DRILL_SEQ}, batch "
        f"{DRILL_BATCH}, {DRILL_STEPS} steps, a checkpoint every {DRILL_EVERY}, deterministic "
        f"algorithms on")
    loads = Spy(CheckpointManager, "restore", keep=False)
    torch.use_deterministic_algorithms(True)
    try:
        with mock.patch.object(train, "get_config", lambda arch: cut), loads:
            reset_counts()
            # As in (s2), the clean run saves its final state alone.
            t0 = time.perf_counter()
            clean = train.main(flags + ["--checkpoint-every", str(DRILL_STEPS),
                                        "--ckpt-dir", os.path.join(root, "clean")])
            run_s = [time.perf_counter() - t0]
            clean_report, clean_loss = clean.report, dict(clean.losses)
            del clean
            drill_dir = os.path.join(root, "drill")
            t0 = time.perf_counter()
            drill = train.main(flags + ["--ckpt-dir", drill_dir,
                                        "--inject-fault", str(DRILL_FAULT)])
            run_s.append(time.perf_counter() - t0)
            read_counts("(t2) launch/train.py on slots: clean and drilled runs")
            report, drill_losses = drill.report, drill.losses
            state = drill.state
            del drill
            # The latest save, laid onto 4 × 2 and onto one device, each held
            # to the live final state.
            mgr = CheckpointManager(drill_dir)
            template = train.state_tree(state)
            _, _, (sh42, _) = steps.build_train(
                cut, shape, make_host_mesh(SPMD_SLOTS // SPMD_MODEL, slots=SPMD_SLOTS, device=dev),
                OptConfig(total_steps=DRILL_STEPS, warmup_steps=max(DRILL_STEPS // 10, 1),
                          moment_dtype=cut.opt_state_dtype))
            on42, extra, at = mgr.restore(template, shardings=sh42)
            one = NamedSharding(make_host_mesh(device=dev), PartitionSpec())
            on1, _, _ = mgr.restore(template, shardings=one)
            same42 = same1 = True
            for a42, a1, live in zip(tree_leaves(on42), tree_leaves(on1), tree_leaves(template)):
                want = live.gather()
                same42 &= a42.sharding.mesh.sizes == (SPMD_MODEL, SPMD_SLOTS // SPMD_MODEL) and \
                    torch.equal(a42.gather(), want)
                same1 &= a1.blocks[0].device == one.device(0) and torch.equal(a1.blocks[0], want)
            del on1
            # A few more steps from the restore: 4 × 2 against the live 2 × 4 state.
            opt_more = OptConfig(total_steps=DRILL_STEPS, warmup_steps=max(DRILL_STEPS // 10, 1),
                                 moment_dtype=cut.opt_state_dtype)
            step24 = steps.make_train_step(cut, opt_more)
            more = TokenPipeline(cut, shape, batch_override=DRILL_BATCH, seq_override=DRILL_SEQ)
            more.load_state_dict(extra)
            more_24, more_42 = [], []
            for _ in range(SPMD_MORE):
                b = more.next_batch(dev)
                state, m24 = step24(state, b)
                on42, m42 = step24(on42, b)
                more_24.append((m24["loss"].item(), m24["grad_norm"].item()))
                more_42.append((m42["loss"].item(), m42["grad_norm"].item()))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    replayed = [st for st, _ in drill_losses]
    same_loss = all(clean_loss[st] == l for st, l in drill_losses)
    log(f"[t2] clean run: losses {[round(clean_loss[k], 6) for k in sorted(clean_loss)]}")
    log(f"[t2] drilled run: completed={report.completed}, restarts {report.restarts}; steps "
        f"executed {replayed}; losses bit-identical to the clean run's: {same_loss}")
    log(f"[t2] the step-{at} save restored with shardings= onto 4 × 2 "
        f"({sh42['params']['embed']['tok'].spec} for embed/tok) and onto one device (P()), "
        f"bit-identical to the final state: {same42}, {same1}; restore "
        f"{', '.join(f'{t:.3f}' for t in loads.times)} s; the clean and drilled runs "
        f"{', '.join(f'{t:.2f}' for t in run_s)} s")
    log(f"[t2] {SPMD_MORE} more steps (loss, grad_norm): 2 × 4 {more_24}, 4 × 2 {more_42}")
    assert clean_report.completed and clean_report.restarts == 0, "(t2) the clean run failed"
    assert report.completed and report.restarts == 1, "(t2) the drill did not restart exactly once"
    assert replayed == list(range(DRILL_FAULT)) + list(range(DRILL_EVERY, DRILL_STEPS))
    assert same_loss, "(t2) the replay differs from the uninterrupted run"
    assert at == DRILL_STEPS, "(t2) the latest save is not the final step's"
    assert same42 and same1, "(t2) an elastic restore differs from the final state"
    for (l24, g24), (l42, g42) in zip(more_24, more_42):
        assert np.isfinite([l24, l42]).all()
        assert abs(l24 - l42) <= TRAIN_LOSS_TOL and abs(g24 - g42) <= TRAIN_GNORM_RTOL * g24, \
            "(t2) the 4 × 2 steps stray from the 2 × 4 steps"
    del state, on42
    torch.cuda.empty_cache()
    log(f"[t] phase {time.perf_counter() - t_t:.2f}s")


def hold_logits(what, got, want):
    """(u)'s criterion for a sharded step's logits (..., vocab) against the
    one-device function's: within SERVE_LOGIT_ATOL, argmax equal wherever
    the top two are further apart than twice the gap.  Returns (gap, rows
    whose argmax agrees, rows clear of a tie)."""
    gap = (got.float() - want.float()).abs().max().item()
    top2 = want.float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * gap
    agree = (got.float().argmax(-1) == want.float().argmax(-1))
    assert gap <= SERVE_LOGIT_ATOL, f"{what}: logits {gap} from the one-device function's"
    assert bool(agree[clear].all()), f"{what}: an argmax differs away from a tie"
    return gap, int(agree.sum()), int(clear.sum())


def sharded_serve_phase(dev, reset_counts, read_counts):
    """(u) olmo_1b's sharded serving steps at full width on a 2 × 4 mesh of
    logical slots on cuda:0, bf16 weights from seed SERVE_SEED: (u1)
    ``build_prefill``'s step on a SERVE_PREFILL_BATCH × SERVE_PROMPT prompt,
    (u2) ``build_decode``'s step for SERVE_STEPS steps over a seeded cache of
    SERVE_CACHE positions, each held to the one-device function; (u3) the
    dry run's records of the two cells on the same mesh, traced on ``meta``,
    beside what the card holds and takes.  Returns the phase's numbers."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.hlo_analysis import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.utils import tree_leaves

    t_u = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[u] device memory held from earlier phases: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    cfg = dataclasses.replace(get_config("olmo_1b"), param_dtype="bfloat16")
    mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device=dev)
    assert set(mesh.slot_devices) == {str(dev) if dev.type == "cpu" else "cuda:0"}
    n = SPMD_SLOTS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    model = lm.init_params(gen, cfg, device=dev)

    def rel_rms(got, want):
        d = (got.float() - want.float()).pow(2).mean().sqrt()
        return (d / want.float().pow(2).mean().sqrt()).item()

    # -- (u1) the sharded prefill ----------------------------------------------------
    p_shape = ShapeConfig("prefill_32k", "prefill", SERVE_PROMPT, SERVE_PREFILL_BATCH)
    prefill, _, (p_sh, b_sh) = steps.build_prefill(cfg, p_shape, mesh)
    params = steps.place(model.tree(), p_sh)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_PREFILL_BATCH, SERVE_PROMPT),
                           generator=gen, device=dev)
    batch = steps.place({"tokens": tokens}, b_sh)
    card_p = per_slot_bytes(n, params, batch)
    log(f"[u1] olmo_1b's full width (16 layers, d_model 2048, vocab 50304, bf16 weights and "
        f"activations, attn_chunk 1024) on {mesh.sizes[0]} × {mesh.sizes[1]} slots; prompt "
        f"{SERVE_PREFILL_BATCH} × {SERVE_PROMPT} (prefill_32k, batch cut 32 → "
        f"{SERVE_PREFILL_BATCH}, prompt 32768 → {SERVE_PROMPT}); per slot {card_p[0]} B of "
        f"weights and tokens")
    torch.cuda.reset_peak_memory_stats()
    (ref_logits, ref_cache), ref_s = synced(lambda: lm.prefill(model, cfg, tokens, SERVE_PROMPT))
    reset_counts()
    secs = []
    for i in range(SERVE_PREFILL_RUNS):
        out, sec = synced(lambda: prefill(params, batch))
        secs.append(sec)
        if i == 0:
            logits, cache = out
            card_out_p = [logits.slot_nbytes(s) + sum(
                a.slot_nbytes(s) for layer in cache for a in layer["kv"].values())
                for s in range(n)]
            gap, agree, clear = hold_logits("(u1)", logits.gather(), ref_logits)
            kv_gaps = [max(rel_rms(c["kv"][k].gather(), r["kv"][k]) for k in ("k", "v"))
                       for c, r in zip(cache, ref_cache)]
            del logits, cache
        del out
    read_counts("(u1) sharded prefill (no custom kernel on this path)")
    peak_p = torch.cuda.max_memory_allocated()
    med_p = float(np.median(secs))
    log(f"[u1] prefill: sharded {', '.join(f'{t:.3f}' for t in secs)} s (median {med_p:.3f} s, "
        f"{SERVE_PREFILL_BATCH * SERVE_PROMPT / med_p:.1f} tokens/s), one-device {ref_s:.3f} s; "
        f"last logits max |Δ| {gap:.4f} (≤ {SERVE_LOGIT_ATOL}), argmax equal in {agree} of "
        f"{SERVE_PREFILL_BATCH} rows ({clear} clear of a tie); cache relative RMS gap by layer "
        f"{', '.join(f'{g:.2e}' for g in kv_gaps)} (layer 0 ≤ {SERVE_KV0_RTOL:.2e}, all ≤ "
        f"{SERVE_KV_RTOL:.2e}); peak device memory {peak_p / 2**30:.2f} GiB")
    assert kv_gaps[0] <= SERVE_KV0_RTOL and max(kv_gaps) <= SERVE_KV_RTOL, \
        "(u1) the sharded cache strays from the one-device prefill's"
    del ref_logits, ref_cache, batch, tokens
    torch.cuda.empty_cache()

    # -- (u2) the sharded decode over a seeded cache ----------------------------------
    d_shape = ShapeConfig("decode_32k", "decode", SERVE_CACHE, SERVE_DECODE_BATCH)
    step, _, (p_sh2, tok_sh, c_sh, pos_sh) = steps.build_decode(cfg, d_shape, mesh)
    assert [a.spec for a in tree_leaves(p_sh2)] == [a.spec for a in tree_leaves(p_sh)]
    ref_cache = [{"kv": {k: torch.randn(v.shape, generator=gen, device=dev, dtype=v.dtype)
                         for k, v in layer["kv"].items()}}
                 for layer in lm.cache_shapes(cfg, SERVE_DECODE_BATCH, SERVE_CACHE)]
    placed = steps.place(ref_cache, c_sh)
    pos0 = SERVE_CACHE - SERVE_STEPS
    cache_gb = sum(x.numel() * x.element_size() for x in tree_leaves(ref_cache)) / 1e9
    log(f"[u2] decode_32k (batch cut 128 → {SERVE_DECODE_BATCH}): a seeded cache of "
        f"{SERVE_CACHE} positions, {cache_gb:.2f} GB, placed as {c_sh[0]['kv']['k'].spec}, beside "
        f"the one-device copy: 2 × {cache_gb:.2f} GB of caches + "
        f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB of "
        f"weights on one device + {sum(per_slot_bytes(n, params)) / 1e9:.2f} GB placed (one copy a "
        f"data group) < 80 GB; {SERVE_STEPS} steps from pos {pos0}")
    toks = torch.randint(0, cfg.vocab_size, (SERVE_STEPS, SERVE_DECODE_BATCH), generator=gen,
                         device=dev)

    def kv_at(arr, at):
        out = torch.empty((arr.shape[0],) + tuple(arr.shape[2:]), dtype=arr.dtype, device=dev)
        for s, b in enumerate(arr.blocks):
            sl = arr.sharding.slices(s, arr.shape)
            if sl[1].start <= at < sl[1].stop:
                out[sl[0], sl[2]] = b[:, at - sl[1].start]
        return out

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    d_secs, ref_secs, gaps, kv_step = [], [], [], []
    prof = None
    for i in range(SERVE_STEPS):
        pos = pos0 + i
        tok = tok_sh.place(toks[i])
        pos_t = pos_sh.place(torch.tensor(pos, dtype=torch.int32))
        if i == 0:
            card_d = per_slot_bytes(n, params, tok, placed, pos_t)
        if i == SERVE_STEPS - 1:
            (logits, placed), *prof = profiled(lambda: step(params, tok, placed, pos_t))
        else:
            (logits, placed), sec = synced(lambda: step(params, tok, placed, pos_t))
            d_secs.append(sec)
        (want, ref_cache), rsec = synced(lambda: lm.decode_step(model, cfg, toks[i], ref_cache,
                                                                pos))
        ref_secs.append(rsec)
        gaps.append(hold_logits(f"(u2) step {i + 1}", logits.gather(), want)[0])
        kv_step.append(max(rel_rms(kv_at(c["kv"][k], pos), r["kv"][k][:, pos])
                           for c, r in zip(placed, ref_cache) for k in ("k", "v")))
    card_out_d = [logits.slot_nbytes(s) + sum(a.slot_nbytes(s) for layer in placed
                                              for a in layer["kv"].values()) for s in range(n)]
    read_counts("(u2) sharded decode (no custom kernel on this path)")
    peak_d = torch.cuda.max_memory_allocated()
    med_d = float(np.median(d_secs[1:]))
    log(f"[u2] decode: sharded step median {med_d * 1e3:.3f} ms over steps 2–"
        f"{SERVE_STEPS - 1} [{min(d_secs[1:]) * 1e3:.3f}–{max(d_secs[1:]) * 1e3:.3f}], the "
        f"first {d_secs[0] * 1e3:.3f} ms, {SERVE_DECODE_BATCH / med_d:.1f} tokens/s; one-device "
        f"step median {float(np.median(ref_secs[1:])) * 1e3:.3f} ms; logits max |Δ| by step "
        f"{', '.join(f'{g:.4f}' for g in gaps)} (≤ {SERVE_LOGIT_ATOL}); the written K/V's "
        f"largest relative RMS gap {max(kv_step):.2e} (≤ {SERVE_KV_RTOL:.2e}); peak device "
        f"memory {peak_d / 2**30:.2f} GiB")
    log(f"[u2] step {SERVE_STEPS} under torch.profiler: {profile_line(*prof)}")
    assert max(kv_step) <= SERVE_KV_RTOL, "(u2) a written K/V strays from the one-device step's"
    del placed, ref_cache, params, model, logits, want
    torch.cuda.empty_cache()

    # -- (u3) the dry run's records of the two cells beside the card ---------------
    meta_mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device="meta")
    recs = {}
    for name, shape, card_in, card_out in (("prefill", p_shape, card_p, card_out_p),
                                           ("decode", d_shape, card_d, card_out_d)):
        rec = dryrun.record_cell("olmo_1b", shape, meta_mesh, cfg=cfg, verbose=False)
        assert rec["ok"], rec.get("traceback")
        ma, an, rl = rec["memory_analysis"], rec["analytic"], rec["roofline"]
        t_card = n * max(rl["t_compute_s"], rl["t_memory_s"])
        t_coll = n * rec["collective_bytes_weighted"]["total"] / HBM_BW
        log(f"[u3] {name}: dry run traced in {rec['t_lower_s']:.2f} s (depths "
            f"{rec['trace']['depths']}); per slot: arguments {ma['argument_size_in_bytes']} B "
            f"(on the card {card_in[0]}), outputs {ma['output_size_in_bytes']} B (on the card "
            f"{card_out[0]}); analytic per slot {an['flops_per_device']:.4e} FLOP, "
            f"{an['hbm_bytes_per_device']:.4e} HBM B; collectives per slot "
            f"{rec['collective_bytes_weighted']} ({rec['collective_counts']} once); roofline "
            f"per slot {rl['t_compute_s']:.4e} s compute, {rl['t_memory_s']:.4e} s memory, "
            f"{rl['t_collective_s']:.4e} s NVLink ({rl['dominant']}-bound); {n} slots on one "
            f"card: {t_card * 1e3:.3f} ms at {PEAK_FLOPS / 1e12:.0f} TFLOP/s and "
            f"{HBM_BW / 1e12:.2f} TB/s (+ {t_coll * 1e3:.3f} ms if the collectives' bytes were "
            f"HBM copies)")
        assert card_in == [ma["argument_size_in_bytes"]] * n, \
            f"(u3) the {name} cell's per-slot argument bytes differ from the card's"
        assert card_out == [ma["output_size_in_bytes"]] * n, \
            f"(u3) the {name} cell's per-slot output bytes differ from the card's"
        recs[name] = t_card
    log(f"[u3] measured beside the bound of 8 slots on one card: prefill {med_p:.3f} s against "
        f"{recs['prefill']:.4f} s ({med_p / recs['prefill']:.1f}×), a decode step "
        f"{med_d * 1e3:.3f} ms against {recs['decode'] * 1e3:.3f} ms "
        f"({med_d / recs['decode']:.1f}×), {SERVE_DECODE_BATCH / med_d:.1f} tokens/s; decode "
        f"busy share {prof[1] / (prof[0] * 1e3):.3f}, spmd.collective {prof[2]:.1f} ms")
    log(f"[u] phase {time.perf_counter() - t_u:.2f}s")


def recurrent_serve(dev, tag, arch, prompt_len, reset_counts, read_counts, topk_check,
                    param_dtype=None):
    """(v1) / (v2): ``arch`` at its published config on the card with the
    kNN-LM head; returns the lookup's ``knn_tile_topk`` kernel row."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import RetrievalConfig, get_config
    from repro_torch.kernels.knn_topk import ops as topk_ops
    from repro_torch.launch import serve
    from repro_torch.models import knn_lm
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as lm
    from repro_torch.utils import tree_leaves

    t_v = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), retrieval=RetrievalConfig(
        enabled=True, k=8, lam=0.9, temperature=1.0))
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    kr = cfg.retrieval.k
    plan = lm.layer_plan(cfg)
    model, init_ms = timed(lambda: lm.init_params(REC_SEED, cfg, device=dev))
    n_par = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert n_par == sum(t.numel() for t in tree_leaves(lm.param_shapes(cfg))), \
        f"({tag}) the model's parameter count is not its tables'"
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers ({plan.n_groups} groups of "
        f"{plan.pattern} + {plan.rem_kinds}), d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype} activations, {cfg.param_dtype} weights, rnn_chunk "
        f"{cfg.rnn_chunk}; {n_par} parameters ({n_bytes / 2**30:.2f} GiB; n_params() "
        f"{cfg.n_params()}) from seed {REC_SEED} in {init_ms / 1e3:.3f}s")
    rng = np.random.default_rng(REC_SEED)
    corpus = rng.integers(0, cfg.vocab_size, (REC_KEY_SEQS, REC_KEY_LEN))
    prompts = rng.integers(0, cfg.vocab_size, (REC_BATCH, prompt_len))

    (ds, ds_s) = synced(lambda: knn_lm.build_datastore(model, cfg, [corpus]))
    n_keys = REC_KEY_SEQS * (REC_KEY_LEN - 1)
    assert tuple(ds.keys.shape) == (n_keys, cfg.d_model)
    log(f"[{tag}] build_datastore over {REC_KEY_SEQS} × {REC_KEY_LEN} tokens: {n_keys} keys × "
        f"{cfg.d_model} dims ({ds.keys.numel() * 4 / 2**20:.0f} MiB) in {ds_s:.3f}s")

    # generate: the prefill, then REC_STEPS decode steps, each with the
    # in-step l2 lookup (one knn_tile_topk launch over the datastore).
    spies = [Spy(lm, "prefill_hidden"), Spy(lm, "decode_step_hidden"), Spy(knn_lm, "lookup")]
    reset_counts()
    with contextlib.ExitStack() as stack, FirstCall(topk_ops, "knn_topk") as call:
        for sp in spies:
            stack.enter_context(sp)
        out, wall = synced(lambda: serve.generate(model, cfg, prompts, REC_STEPS, ds=ds))
    launches = read_counts(f"({tag}) {arch}: generate with the in-step lookup")
    assert tuple(out.shape) == (REC_BATCH, REC_STEPS)
    assert launches.get("knn_tile_topk", 0) == REC_STEPS + 1, \
        f"({tag}) expected one knn_tile_topk launch a lookup"
    pre_s = spies[0].times[0]
    lm_t, ret_t = np.array(spies[1].times) * 1e3, np.array(spies[2].times) * 1e3
    tok_s = REC_BATCH * REC_STEPS / (wall - pre_s)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] generate: prefill of {REC_BATCH} × {prompt_len} {pre_s:.3f}s "
        f"({REC_BATCH * prompt_len / pre_s:.1f} tokens/s); per decode step: LM "
        f"{lm_t.mean():.3f} ms [{lm_t.min():.3f}–{lm_t.max():.3f}], lookup {ret_t.mean():.3f} "
        f"ms [{ret_t.min():.3f}–{ret_t.max():.3f}]; {REC_BATCH} × {REC_STEPS} tokens in "
        f"{wall:.3f}s, {tok_s:.1f} tokens/s after the prefill; peak {peak / 2**30:.2f} GiB")

    # Decode matches forward: the prefill's last position and each decode
    # step against forward_seq over the prompt and the generated tokens.
    seq = np.concatenate([prompts, out.cpu().numpy()], axis=1)
    total = seq.shape[1]
    cut = prompt_len // 2
    span = slice(prompt_len - REC_STEPS, total)          # chunk-two and decode positions
    dec_h = torch.stack([spies[0].calls[0][2][1]] + [c[2][0] for c in spies[1].calls], 1)
    with torch.no_grad():
        unemb = lambda c, h: lm_layers.unembed(model.embed, c, h).float()
        hid, _, st_w = lm.forward_seq(model, cfg, seq, collect=True, cache_len=total)
        fwd = unemb(cfg, hid[:, span])
        del hid
        # the same tokens in two chunks, the second carrying the first's states
        _, _, st_a = lm.forward_seq(model, cfg, seq[:, :cut], collect=True, cache_len=total)
        hid_b, _, st_c = lm.forward_seq(model, cfg, seq[:, cut:], states=st_a, collect=True,
                                        cache_len=total)
        chunk = unemb(cfg, hid_b[:, span.start - cut:])
        del hid_b, st_a
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        hid32, _, st_32 = lm.forward_seq(model, cfg32, seq, collect=True, cache_len=total)
        f32 = unemb(cfg32, hid32[:, span])
        del hid32
        model._compute = None                  # the float32 copy of bf16 weights
        dec = unemb(cfg, dec_h)
    n_dec = dec.shape[1]
    log(f"[{tag}] decode matches forward over {n_dec} positions × {REC_BATCH} rows:")
    logit_check(f"({tag}) prefill + {REC_STEPS} decode steps", dec, fwd[:, -n_dec:],
                f32[:, -n_dec:])
    kinds = plan.kinds
    carried = len(kinds) if "local" not in kinds else kinds.index("local")
    gaps = [max(rel_rms(a, b) for a, b in zip(tree_leaves(c), tree_leaves(w)))
            for c, w in zip(st_c, st_w)]
    noise_st = [max(rel_rms(a, b) for a, b in zip(tree_leaves(w), tree_leaves(f)))
                for w, f in zip(st_w, st_32)]
    log(f"[{tag}] forward_seq(states=) in two chunks of {cut} and {total - cut} tokens against "
        f"the whole: the layers' states, relative RMS gap (largest leaf) to the whole "
        f"forward's {', '.join(f'{g:.2e}' for g in gaps[:carried])} (the bf16 forward's to "
        f"the float32 one {', '.join(f'{g:.2e}' for g in noise_st[:carried])}) over the "
        f"{carried} layers the states carry exactly")
    assert all(g <= 2.0 * n for g, n in zip(gaps[:carried], noise_st[:carried])), \
        f"({tag}) a carried state strays from the whole forward's beyond bf16 rounding"
    if carried == len(kinds):
        logit_check(f"({tag}) the second chunk's last {fwd.shape[1]} positions", chunk, fwd,
                    f32)
    else:
        # The reference's forward_seq(states=) carries recurrent states only:
        # a local attention layer sees its own chunk, so past the first one
        # the chunked run is another function of the tokens (printed).
        log(f"  ({tag}) past layer {carried} (local attention, no carried KV, as the "
            f"reference): the second chunk's last {fwd.shape[1]} logits differ from the whole "
            f"forward's by up to {(chunk - fwd).abs().max().item():.4f} (the bf16 forward's "
            f"gap to float32 {(fwd - f32).abs().max().item():.4f})")
    del st_c, st_32, fwd, f32, chunk, dec

    # One decode step under torch.profiler (printed, not gated), from the
    # whole forward's states: a cache of all `total` positions.
    tok = torch.as_tensor(seq[:, -1], device=dev)
    lm.decode_step_hidden(model, cfg, tok, st_w, total)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        (_, step_s) = synced(lambda: lm.decode_step_hidden(model, cfg, tok, st_w, total + 1))
    dev_ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    log(f"[{tag}] one LM decode step under torch.profiler: {len(dev_ev)} device events, the "
        f"card busy {busy:.3f} ms of {step_s * 1e3:.3f} ms (busy share "
        f"{busy / (step_s * 1e3):.3f}; "
        f"{lm_t.mean():.3f} ms unprofiled)" if dev_ev else
        f"[{tag}] one LM decode step under torch.profiler: no device events recorded")
    del st_w, model
    torch.cuda.empty_cache()

    (q, c, qid, cid), kw = call.args
    row = topk_check(f"knn_tile_topk (kNN-LM lookup, {arch}, D={cfg.d_model})", q, c, qid, cid,
                     "l2", launches["knn_tile_topk"], fp32_bound=True, k=kw["k"])
    del ds, call, q, c
    log(f"[{tag}] phase {time.perf_counter() - t_v:.2f}s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the float32 check included)")
    return row


def recurrent_train(dev, reset_counts, read_counts):
    """(v3) two AdamW steps at rwkv6_3b's width, depth cut to
    REC_TRAIN_LAYERS; step 1's loss held to the float32 loss.  The
    gradient norm is printed, not held: the reference's own bf16 gradient
    norm strays from its float32 one (5.8 % at d_model 512, 4 layers, seq
    256 on the CPU), most of it the bonus ``u``'s gradient."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer as lm
    from repro_torch.optim import OptConfig, init_opt_state

    t_v3 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config("rwkv6_3b")
    cfg = dataclasses.replace(full, n_layers=REC_TRAIN_LAYERS)
    model = lm.init_params(REC_SEED, cfg, device=dev)
    n_par = sum(p.numel() for p in model.parameters())
    opt_cfg = OptConfig(total_steps=REC_TRAIN_STEPS, warmup_steps=1,
                        moment_dtype=cfg.opt_state_dtype)
    state = {"params": model, "opt": init_opt_state(model.tree(), opt_cfg)}
    pipe = TokenPipeline(cfg, SHAPES["train_4k"], batch_override=REC_TRAIN_BATCH,
                         seq_override=REC_TRAIN_SEQ)
    step = steps.make_train_step(cfg, opt_cfg)
    batch0 = pipe.next_batch(dev)
    log(f"[v3] rwkv6_3b's width (d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}) with n_layers cut {full.n_layers} → {cfg.n_layers}: {n_par} "
        f"parameters from seed {REC_SEED}; batch {REC_TRAIN_BATCH} × seq {pipe.seq}, "
        f"{cfg.dtype} activations, remat {cfg.remat_policy}, a checkpoint per {cfg.rnn_chunk}-"
        f"token chunk of the scan")
    with torch.no_grad():
        (l32, _), f32_s = synced(lambda: lm.loss_fn(
            model, dataclasses.replace(cfg, dtype="float32"), batch0))
    reset_counts()
    losses, gnorms, secs = [], [], []
    for i in range(REC_TRAIN_STEPS):
        batch = batch0 if i == 0 else pipe.next_batch(dev)
        (state, m), sec = synced(lambda: step(state, batch))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        secs.append(sec)
    read_counts("(v3) rwkv6_3b train steps (no custom kernel on this path)")
    peak = torch.cuda.max_memory_allocated()
    d_loss = abs(losses[0] - l32.item())
    tokens = REC_TRAIN_BATCH * pipe.seq
    log(f"[v3] steps: losses {[round(x, 6) for x in losses]}, grad_norm "
        f"{[round(x, 6) for x in gnorms]}, {', '.join(f'{s:.3f}' for s in secs)} s "
        f"({tokens / secs[-1]:.1f} tokens/s at the last); step 1's loss against the float32 "
        f"loss of the same masters and batch ({f32_s:.3f} s): {l32.item():.6f}, |Δloss| "
        f"{d_loss:.3e} (≤ {TRAIN_LOSS_TOL}); peak {peak / 2**30:.2f} GiB")
    assert np.isfinite(losses).all() and np.isfinite(gnorms).all() and min(gnorms) > 0, \
        "(v3) a non-finite loss or a zero gradient"
    assert d_loss <= TRAIN_LOSS_TOL, "(v3) step 1's loss strays from the float32 loss"
    del state, model, batch0, batch, step
    torch.cuda.empty_cache()
    log(f"[v3] phase {time.perf_counter() - t_v3:.2f}s")


def recurrent_phase(dev, kernels, reset_counts, read_counts, topk_check):
    """(v) the recurrent presets on the card: (v1) rwkv6_3b and (v2)
    recurrentgemma_9b served with the kNN-LM head at their published
    configs, (v3) rwkv6_3b's train step; appends (a)'s D = 2,560 and
    D = 4,096 ``knn_tile_topk`` rows to ``kernels``."""
    t_v = time.perf_counter()
    kernels.append(recurrent_serve(dev, "v1", "rwkv6_3b", RWKV_PROMPT, reset_counts,
                                   read_counts, topk_check))
    kernels.append(recurrent_serve(dev, "v2", "recurrentgemma_9b", RG_PROMPT, reset_counts,
                                   read_counts, topk_check, param_dtype="bfloat16"))
    recurrent_train(dev, reset_counts, read_counts)
    log(f"[v] phase {time.perf_counter() - t_v:.2f}s")


def per_slot_bytes(n, *trees):
    """Each of ``n`` slots' bytes of the ``SlotArray`` leaves of ``trees``."""
    from repro_torch.utils import tree_leaves
    arrs = tree_leaves(list(trees))
    return [sum(a.slot_nbytes(s) for a in arrs) for s in range(n)]


def state_gaps(got, ref):
    """Per layer, the largest relative RMS gap of a decode-state leaf (a
    placed one gathered from its blocks) to ``ref``'s."""
    from repro_torch.sharding import SlotArray
    whole = lambda a: a.gather() if isinstance(a, SlotArray) else a
    return [max(rel_rms(whole(p[g][k]), r[g][k]) for g in p for k in p[g])
            for p, r in zip(got, ref)]


def hold_states(what, got, ref, ref32):
    """Each layer's decode state (placed) against the one-device bf16
    state ``ref``: within W_STATE_RATIO times ``ref``'s own gap to the
    float32 run's ``ref32``.  Returns the line that says so."""
    gaps, noise = state_gaps(got, ref), state_gaps(ref, ref32)
    ratio = max(g / n for g, n in zip(gaps, noise))
    assert ratio <= W_STATE_RATIO, f"{what}: a layer's state strays beyond bf16 rounding"
    return (f"the state's relative RMS gap by layer {', '.join(f'{g:.2e}' for g in gaps)}; the "
            f"one-device bf16 state's to float32 {', '.join(f'{n:.2e}' for n in noise)}; largest "
            f"ratio {ratio:.3f} (≤ {W_STATE_RATIO})")


def recurrent_model(dev, arch):
    """``arch`` at its published width with W_LAYERS layers, bf16 weights
    from seed REC_SEED."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as lm

    cfg = dataclasses.replace(get_config(arch), n_layers=W_LAYERS, param_dtype="bfloat16")
    return lm.init_params(REC_SEED, cfg, device=dev)


def sharded_recurrent_serve(dev, tag, model, model_axis, slots, prompt, n_steps, reset_counts,
                            read_counts, profile=True):
    """(w1) / (w1s) / (w2): ``model`` (``recurrent_model``'s) on a (slots /
    model_axis) × model_axis mesh of logical slots on the card:
    ``build_prefill``'s step on REC_BATCH × ``prompt`` tokens, then
    ``n_steps`` of ``build_decode``'s step, each held to the one-device
    ``transformer.prefill`` / ``decode_step``; the last step under
    ``torch.profiler`` where ``profile``.  Returns (decode cell, per-slot
    argument and output bytes of a decode step on the card)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.utils import tree_leaves

    t_w = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.cfg
    arch, full = cfg.name, get_config(cfg.name)
    plan = lm.layer_plan(cfg)
    mesh = make_host_mesh(model_axis, slots=slots, device=dev)
    assert set(mesh.slot_devices) == {str(dev) if dev.type == "cpu" else "cuda:0"}
    rng = np.random.default_rng(REC_SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (REC_BATCH, prompt)), device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (n_steps, REC_BATCH)), device=dev)

    p_shape = ShapeConfig(f"prefill_{tag}", "prefill", prompt, REC_BATCH)
    d_shape = ShapeConfig(f"decode_{tag}", "decode", prompt, REC_BATCH)
    prefill, _, (p_sh, b_sh) = steps.build_prefill(cfg, p_shape, mesh)
    step, _, (_, tok_sh, c_sh, pos_sh) = steps.build_decode(cfg, d_shape, mesh)
    params = steps.place(model.tree(), p_sh)
    batch = steps.place({"tokens": tokens}, b_sh)
    specs = sorted({str(a.sharding.spec) for a in tree_leaves(params["layers"][0])})
    log(f"[{tag}] {arch}'s width (d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}) with n_layers cut {full.n_layers} → {cfg.n_layers} ({plan.n_groups} "
        f"groups of {plan.pattern} + {plan.rem_kinds}), bf16 weights and activations from seed "
        f"{REC_SEED}, on {mesh.sizes[0]} × {mesh.sizes[1]} slots; layer 0's specs {specs}; "
        f"prompt {REC_BATCH} × {prompt}, {n_steps} decode steps")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    l32, ref32 = lm.prefill(model, cfg32, tokens, prompt)
    model._compute = None                          # the float32 copy of the bf16 weights
    (ref_logits, ref_cache), ref_pre = synced(lambda: lm.prefill(model, cfg, tokens, prompt))
    reset_counts()
    (logits, cache), pre_s = synced(lambda: prefill(params, batch))
    read_counts(f"({tag}) sharded prefill (no custom kernel on this path)")
    gap, agree, clear = hold_logits(f"({tag}) prefill", logits.gather(), ref_logits)
    log(f"[{tag}] prefill: sharded {pre_s:.3f} s ({REC_BATCH * prompt / pre_s:.1f} tokens/s), "
        f"one-device {ref_pre:.3f} s; last logits max |Δ| {gap:.4f} (≤ {SERVE_LOGIT_ATOL}), "
        f"argmax equal in {agree} of {REC_BATCH} rows ({clear} clear of a tie); "
        f"{hold_states(f'({tag}) prefill', cache, ref_cache, ref32)}")
    logit_check(f"({tag}) prefill's last logits", logits.gather().float(), ref_logits.float(),
                l32.float())
    assert [a.sharding.spec for a in tree_leaves(cache)] == \
        [sh.spec for sh in tree_leaves(c_sh)], f"({tag}) the prefill's state is not decode's"
    del logits, batch

    n = len(mesh.slot_devices)
    reset_counts()
    secs, ref_secs, got_l, want_l, prof = [], [], [], [], None
    for i in range(n_steps):
        pos = prompt + i
        tok = tok_sh.place(toks[i])
        pos_t = pos_sh.place(torch.tensor(pos, dtype=torch.int32))
        if i == 0:
            card_in = per_slot_bytes(n, params, tok, cache, pos_t)
        if i == n_steps - 1 and profile:
            (logits, cache), *prof = profiled(lambda: step(params, tok, cache, pos_t))
        else:
            (logits, cache), sec = synced(lambda: step(params, tok, cache, pos_t))
            secs.append(sec)
        (want, ref_cache), rsec = synced(lambda: lm.decode_step(model, cfg, toks[i], ref_cache,
                                                                pos))
        ref_secs.append(rsec)
        got_l.append(logits.gather().float())
        want_l.append(want.float())
    read_counts(f"({tag}) sharded decode (no custom kernel on this path)")
    card_out = [logits.slot_nbytes(s) + sum(a.slot_nbytes(s) for a in tree_leaves(cache))
                for s in range(n)]
    peak = torch.cuda.max_memory_allocated()
    l32 = []
    for i in range(n_steps):
        l32.append(lm.decode_step(model, cfg32, toks[i], ref32, prompt + i)[0].float())
    model._compute = None
    gap, agree, clear = hold_logits(f"({tag}) decode", torch.stack(got_l, 1),
                                    torch.stack(want_l, 1))
    med = float(np.median(secs[1:] if len(secs) > 2 else secs))
    log(f"[{tag}] decode: sharded step median {med * 1e3:.3f} ms [{min(secs) * 1e3:.3f}–"
        f"{max(secs) * 1e3:.3f}], {REC_BATCH / med:.1f} tokens/s; one-device step median "
        f"{float(np.median(ref_secs)) * 1e3:.3f} ms; logits max |Δ| {gap:.4f} (≤ "
        f"{SERVE_LOGIT_ATOL}), argmax equal in {agree} of {REC_BATCH * n_steps} ({clear} clear of "
        f"a tie); after step {n_steps}, "
        f"{hold_states(f'({tag}) decode', cache, ref_cache, ref32)}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    logit_check(f"({tag}) {n_steps} decode steps' logits", torch.stack(got_l, 1),
                torch.stack(want_l, 1), torch.stack(l32, 1))
    if profile:
        log(f"[{tag}] step {n_steps} under torch.profiler: {profile_line(*prof)}")
    del cache, ref_cache, ref32, params, logits, want
    torch.cuda.empty_cache()
    log(f"[{tag}] phase {time.perf_counter() - t_w:.2f}s")
    return d_shape, card_in, card_out


def sharded_recurrent_train(dev, reset_counts, read_counts):
    """(w3) one sharded train step of each recurrent preset at its published
    width, depth and dtypes from W_TRAIN, weights from seed REC_SEED, batch
    W_TRAIN_BATCH × W_TRAIN_SEQ on SPMD_MODEL × 2 slots; the loss and
    grad_norm held to the one-device step's."""
    import dataclasses

    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.optim import OptConfig, init_opt_state

    mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device=dev)
    for arch, (layers, act, weights) in W_TRAIN.items():
        t_w3 = time.perf_counter()
        torch.cuda.empty_cache()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers, dtype=act, param_dtype=weights,
                                  opt_state_dtype=weights)
        opt_cfg = OptConfig(total_steps=2, warmup_steps=1, moment_dtype=cfg.opt_state_dtype)
        pipe = TokenPipeline(cfg, SHAPES["train_4k"], batch_override=W_TRAIN_BATCH,
                             seq_override=W_TRAIN_SEQ)
        batch = pipe.next_batch(dev)
        ref = lm.init_params(REC_SEED, cfg, device=dev)
        fingerprint = ref.embed["tok"][:1024].clone()
        torch.cuda.reset_peak_memory_stats()
        (_, ref_m), ref_s = synced(lambda: steps.make_train_step(cfg, opt_cfg)(
            {"params": ref, "opt": init_opt_state(ref.tree(), opt_cfg)}, batch))
        ref_peak = torch.cuda.max_memory_allocated()
        ref_loss, ref_gn = ref_m["loss"].item(), ref_m["grad_norm"].item()
        del ref, ref_m
        torch.cuda.empty_cache()
        model = lm.init_params(REC_SEED, cfg, device=dev)
        assert torch.equal(model.embed["tok"][:1024], fingerprint), "(w3) another draw"
        step, _, (st_sh, _) = steps.build_train(cfg, SHAPES["train_4k"], mesh, opt_cfg)
        state = steps.init_placed_state(model.tree(), opt_cfg, st_sh)
        del model, fingerprint
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (state, m), sec = synced(lambda: step(state, batch))
        read_counts(f"(w3) {arch} sharded train step (no custom kernel on this path)")
        peak = torch.cuda.max_memory_allocated()
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        d_loss, d_gn = abs(loss - ref_loss), abs(gn - ref_gn) / ref_gn
        log(f"[w3] {arch}'s width, n_layers cut {full.n_layers} → {layers}, {act} "
            f"activations, {weights} weights and moments, batch {W_TRAIN_BATCH} × {pipe.seq} on {mesh.sizes[0]} × {mesh.sizes[1]} "
            f"slots: step 1 loss {loss:.6f}, grad_norm {gn:.6f} in {sec:.3f} s "
            f"({W_TRAIN_BATCH * pipe.seq / sec:.1f} tokens/s), peak {peak / 2**30:.2f} GiB; the "
            f"one-device step: loss {ref_loss:.6f}, grad_norm {ref_gn:.6f} in {ref_s:.3f} s, peak "
            f"{ref_peak / 2**30:.2f} GiB; |Δloss| {d_loss:.3e} (≤ {TRAIN_LOSS_TOL}), grad_norm "
            f"gap {d_gn:.3e} (≤ {TRAIN_GNORM_RTOL}); {time.perf_counter() - t_w3:.2f} s")
        assert d_loss <= TRAIN_LOSS_TOL, f"(w3) {arch}: the loss strays from the one-device step's"
        assert d_gn <= TRAIN_GNORM_RTOL, \
            f"(w3) {arch}: the grad_norm strays from the one-device step's"
        del state, batch, step, m
        torch.cuda.empty_cache()


def recurrent_sharded_phase(dev, reset_counts, read_counts):
    """(w) the recurrent presets in the slot program on the card: (w1)
    rwkv6_3b on 2 × 4 slots (heads whole a slot), (w1s) on 1 × 16 (the
    heads straddle slots), (w2) recurrentgemma_9b on 2 × 4 (the local ring
    sharded by position, wrapped), (w3) one sharded train step of each,
    (w4) the dry run's records of (w1)'s and (w2)'s decode cells on 2 × 4
    ``meta`` slots beside the card's blocks."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    t_w = time.perf_counter()
    model = recurrent_model(dev, "rwkv6_3b")
    cells = [(model.cfg,) + sharded_recurrent_serve(dev, "w1", model, SPMD_MODEL, SPMD_SLOTS,
                                                    RWKV_PROMPT, W1_STEPS, reset_counts,
                                                    read_counts)]
    sharded_recurrent_serve(dev, "w1s", model, W_STRADDLE_MODEL, W_STRADDLE_MODEL,
                            W_STRADDLE_PROMPT, W_STRADDLE_STEPS, reset_counts, read_counts,
                            profile=False)
    model = recurrent_model(dev, "recurrentgemma_9b")
    cells.append((model.cfg,) + sharded_recurrent_serve(dev, "w2", model, SPMD_MODEL, SPMD_SLOTS,
                                                        RG_PROMPT, W2_STEPS, reset_counts,
                                                        read_counts))
    del model
    sharded_recurrent_train(dev, reset_counts, read_counts)
    meta_mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device="meta")
    for tag, (cfg, shape, card_in, card_out) in zip(("w1", "w2"), cells):
        rec = dryrun.record_cell(cfg.name, shape, meta_mesh, cfg=cfg, verbose=False)
        assert rec["ok"], rec.get("traceback")
        ma = rec["memory_analysis"]
        log(f"[w4] ({tag})'s decode cell: dry run traced in {rec['t_lower_s']:.2f} s (depths "
            f"{rec['trace']['depths']}); per slot: arguments {ma['argument_size_in_bytes']} B (on "
            f"the card {card_in[0]}), outputs {ma['output_size_in_bytes']} B (on the card "
            f"{card_out[0]}); collectives per slot {rec['collective_bytes_weighted']} "
            f"({rec['collective_counts']} once)")
        assert card_in == [ma["argument_size_in_bytes"]] * SPMD_SLOTS, \
            f"(w4) ({tag})'s per-slot argument bytes differ from the card's"
        assert card_out == [ma["output_size_in_bytes"]] * SPMD_SLOTS, \
            f"(w4) ({tag})'s per-slot output bytes differ from the card's"
    log(f"[w] phase {time.perf_counter() - t_w:.2f}s")


class RoutingProbe:
    """Within ``with``, record for every ``layers._moe_dispatch`` call (one
    an MoE layer, in execution order) its token block's top-k expert sets,
    each sorted ((T, K) on the card), the share of its assignments the
    capacity dropped and its aux.  The router is run again for the record;
    the call itself goes through unchanged."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers = layers
        self.sets, self.dropped, self.aux = [], [], []

    def __enter__(self):
        import torch
        lay = self.layers
        fn = self.orig = lay._moe_dispatch

        def probe(params, cfg, xt, cap):
            out, aux = fn(params, cfg, xt, cap)
            eidx = lay._top_k(lay._router_probs(params, xt), cfg.moe.top_k)[1]
            counts = torch.bincount(eidx.reshape(-1), minlength=cfg.moe.n_experts)
            self.dropped.append((counts - cap).clamp(min=0).sum().item() / eidx.numel())
            self.aux.append(aux.item())
            self.sets.append(eidx.sort(dim=1).values)
            return out, aux

        lay._moe_dispatch = probe
        return self

    def __exit__(self, *exc):
        self.layers._moe_dispatch = self.orig


def moe_decode_check(dev, tag, model, cfg, seq, prompt_len):
    """Decode against forward at capacity X_CHECK_CAPACITY on ``model``'s
    weights: the prefill of ``seq[:, :prompt_len]`` and a decode step for
    each later token of ``seq`` but the last, their logits against
    ``forward_seq`` over the same tokens (both bf16) and a float32 forward;
    the share of (token, layer) top-k sets that differ between the decode and
    the forward.  Returns (the cache, its next position) for a profiled
    step."""
    import dataclasses

    import torch

    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as lm

    cfg16 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=X_CHECK_CAPACITY))
    seq = torch.as_tensor(seq, device=dev)
    total = seq.shape[1]
    n_layers = cfg.n_layers
    with torch.no_grad(), RoutingProbe() as r_dec:
        logits, cache = lm.prefill(model, cfg16, seq[:, :prompt_len], total + 2)
        dec = [logits.float()]
        for t in range(prompt_len, total - 1):
            logits, cache = lm.decode_step(model, cfg16, seq[:, t], cache, t)
            dec.append(logits.float())
    dec = torch.stack(dec, 1)
    unemb = lambda c, h: lm_layers.unembed(model.embed, c, h).float()
    with torch.no_grad(), RoutingProbe() as r_fwd:
        hid, _, _ = lm.forward_seq(model, cfg16, seq[:, :total - 1])
        fwd = unemb(cfg16, hid[:, prompt_len - 1:])
    del hid
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    with torch.no_grad():
        hid32, _, _ = lm.forward_seq(model, cfg32, seq[:, :total - 1])
        f32 = unemb(cfg32, hid32[:, prompt_len - 1:])
    del hid32
    model._compute = None                      # the float32 compute copy
    assert max(r_dec.dropped + r_fwd.dropped) == 0.0, \
        f"({tag}) capacity {X_CHECK_CAPACITY} dropped an assignment"
    b = seq.shape[0]
    differ = []
    for j, t in enumerate(range(prompt_len, total - 1)):
        for layer in range(n_layers):
            got = r_dec.sets[n_layers * (j + 1) + layer]
            want = r_fwd.sets[layer].reshape(b, total - 1, -1)[:, t]
            differ.append((got != want).any(-1).float().mean().item())
    share = sum(differ) / len(differ)
    gap, noise = rel_rms(dec, f32), rel_rms(fwd, f32)
    log(f"[{tag}] decode matches forward at capacity {X_CHECK_CAPACITY:g} over {dec.shape[1]} "
        f"positions × {b} rows: top-{cfg.moe.top_k} sets differing between the decode and the "
        f"forward {share:.4f} of (token, layer) pairs; relative RMS gap to the float32 "
        f"forward's logits {gap:.4e} (the bf16 forward's {noise:.4e}; ≤ {X_RMS_RATIO:g} ×), "
        f"against the bf16 forward {rel_rms(dec, fwd):.4e}")
    noise_max, stray = (fwd - f32).abs().max().item(), (dec - f32).abs().max().item()
    log(f"  ({tag}) max |logit − float32 forward's| {stray:.4f} (the bf16 forward's "
        f"{noise_max:.4f}, ratio {stray / noise_max:.3f}; printed, not held)")
    assert gap <= X_RMS_RATIO * noise, \
        f"({tag}) the decode strays from the forward beyond bf16 rounding"
    top2 = f32.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 4.0 * noise_max
    assert (dec.argmax(-1) == f32.argmax(-1))[sure].all(), \
        f"({tag}) an argmax differs from the forward's away from a tie"
    return cache, total - 1


def moe_serve(dev, tag, cfg, n_steps, reset_counts, read_counts, topk_check=None):
    """(x1) / (x2): an MoE preset on the card, served by ``generate`` (with
    the kNN-LM head's in-step lookup when ``topk_check`` is given: returns the
    lookup's ``knn_tile_topk`` kernel row); the routing of the prefill; decode
    against forward; one profiled decode step."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.kernels.knn_topk import ops as topk_ops
    from repro_torch.launch import serve
    from repro_torch.models import knn_lm
    from repro_torch.models import transformer as lm
    from repro_torch.utils import tree_leaves

    t_x = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = timed(lambda: lm.init_params(REC_SEED, cfg, device=dev))
    n_par = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert n_par == sum(t.numel() for t in tree_leaves(lm.param_shapes(cfg))), \
        f"({tag}) the model's parameter count is not its tables'"
    moe = cfg.moe
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads × {cfg.hd}, {moe.n_experts} experts top-{moe.top_k} × d_expert "
        f"{moe.d_expert}, capacity factor {moe.capacity_factor}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype} activations, {cfg.param_dtype} weights; {n_par} parameters "
        f"({n_bytes / 2**30:.2f} GiB; n_params() {cfg.n_params()} without the norm scales) "
        f"from seed {REC_SEED} in {init_ms / 1e3:.3f}s")
    rng = np.random.default_rng(REC_SEED)
    corpus = rng.integers(0, cfg.vocab_size, (REC_KEY_SEQS, REC_KEY_LEN))
    prompts = rng.integers(0, cfg.vocab_size, (REC_BATCH, X_PROMPT))
    ds = None
    if topk_check is not None:
        (ds, ds_s) = synced(lambda: knn_lm.build_datastore(model, cfg, [corpus]))
        n_keys = REC_KEY_SEQS * (REC_KEY_LEN - 1)
        assert tuple(ds.keys.shape) == (n_keys, cfg.d_model)
        log(f"[{tag}] build_datastore over {REC_KEY_SEQS} × {REC_KEY_LEN} tokens: {n_keys} keys "
            f"× {cfg.d_model} dims in {ds_s:.3f}s")

    spies = [Spy(lm, "prefill_hidden", keep=False), Spy(lm, "prefill", keep=False),
             Spy(lm, "decode_step_hidden", keep=False), Spy(knn_lm, "lookup", keep=False)]
    reset_counts()
    with contextlib.ExitStack() as stack, FirstCall(topk_ops, "knn_topk") as call:
        for sp in spies:
            stack.enter_context(sp)
        out, wall = synced(lambda: serve.generate(model, cfg, prompts, n_steps, ds=ds))
    launches = read_counts(f"({tag}) {cfg.name}: generate"
                           + (" with the in-step lookup" if ds is not None else ""))
    assert tuple(out.shape) == (REC_BATCH, n_steps)
    if ds is not None:
        assert launches.get("knn_tile_topk", 0) == n_steps + 1, \
            f"({tag}) expected one knn_tile_topk launch a lookup"
    pre_s = sum(sp.times[0] for sp in spies[:2] if sp.times)
    lm_t = np.array(spies[2].times) * 1e3
    ret_t = np.array(spies[3].times or [0.0]) * 1e3
    tok_s = REC_BATCH * n_steps / (wall - pre_s)
    log(f"[{tag}] generate: prefill of {REC_BATCH} × {X_PROMPT} {pre_s:.3f}s "
        f"({REC_BATCH * X_PROMPT / pre_s:.1f} tokens/s); per decode step: LM "
        f"{lm_t.mean():.3f} ms [{lm_t.min():.3f}–{lm_t.max():.3f}], lookup {ret_t.mean():.3f} ms "
        f"[{ret_t.min():.3f}–{ret_t.max():.3f}]; {REC_BATCH} × {n_steps} tokens in {wall:.3f}s, "
        f"{tok_s:.1f} tokens/s after the prefill; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # The prefill's routing at the published capacity, layer by layer.
    with torch.no_grad(), RoutingProbe() as rp:
        lm.forward_seq(model, cfg, prompts)
    assert len(rp.aux) == cfg.n_layers and np.isfinite(rp.aux).all()
    log(f"[{tag}] the prefill's routing at capacity {moe.capacity_factor}: dropped share of the "
        f"top-{moe.top_k} assignments per layer min {min(rp.dropped):.4f}, max "
        f"{max(rp.dropped):.4f}, mean {sum(rp.dropped) / len(rp.dropped):.4f}; aux per layer "
        f"{[round(a, 4) for a in rp.aux]}")
    del rp

    seq = np.concatenate([prompts, out.cpu().numpy()], axis=1)
    cache, pos = moe_decode_check(dev, tag, model, cfg, seq, X_PROMPT)

    # One decode step under torch.profiler (printed, not gated).
    tok = torch.as_tensor(seq[:, -1], device=dev)
    lm.decode_step_hidden(model, cfg, tok, cache, pos)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        (_, step_s) = synced(lambda: lm.decode_step_hidden(model, cfg, tok, cache, pos + 1))
    dev_ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    log(f"[{tag}] one LM decode step under torch.profiler: {len(dev_ev)} device events, the "
        f"card busy {busy:.3f} ms of {step_s * 1e3:.3f} ms (busy share "
        f"{busy / (step_s * 1e3):.3f}; {lm_t.mean():.3f} ms unprofiled)" if dev_ev else
        f"[{tag}] one LM decode step under torch.profiler: no device events recorded")
    del cache, model
    torch.cuda.empty_cache()
    row = None
    if ds is not None:
        (q, c, qid, cid), kw = call.args
        row = topk_check(f"knn_tile_topk (kNN-LM lookup, {cfg.name}, D={cfg.d_model})", q, c,
                         qid, cid, "l2", launches["knn_tile_topk"], fp32_bound=True, k=kw["k"])
        del ds, call, q, c
    log(f"[{tag}] phase {time.perf_counter() - t_x:.2f}s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the float32 check included)")
    return row


def moe_train(dev, reset_counts, read_counts):
    """(x3) two AdamW steps at granite_moe_1b_a400m's width, depth cut to
    X_TRAIN_LAYERS (every layer under a per-layer checkpoint that returns
    the aux beside x); step 1's loss held to the float32 loss, ``moe_aux``
    finite and above 0; the gradient norm printed."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer as lm
    from repro_torch.optim import OptConfig, init_opt_state

    t_x3 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config("granite_moe_1b_a400m")
    cfg = dataclasses.replace(full, n_layers=X_TRAIN_LAYERS)
    model = lm.init_params(REC_SEED, cfg, device=dev)
    n_par = sum(p.numel() for p in model.parameters())
    opt_cfg = OptConfig(total_steps=X_TRAIN_STEPS, warmup_steps=1,
                        moment_dtype=cfg.opt_state_dtype)
    state = {"params": model, "opt": init_opt_state(model.tree(), opt_cfg)}
    pipe = TokenPipeline(cfg, SHAPES["train_4k"], batch_override=X_TRAIN_BATCH,
                         seq_override=X_TRAIN_SEQ)
    step = steps.make_train_step(cfg, opt_cfg)
    batch0 = pipe.next_batch(dev)
    log(f"[x3] granite_moe_1b_a400m's width (d_model {cfg.d_model}, {cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k} × {cfg.moe.d_expert}, vocab {cfg.vocab_size}) with n_layers cut "
        f"{full.n_layers} → {cfg.n_layers}: {n_par} parameters from seed {REC_SEED}; batch "
        f"{X_TRAIN_BATCH} × seq {pipe.seq}, {cfg.dtype} activations, remat {cfg.remat_policy}")
    with torch.no_grad():
        (l32, m32), f32_s = synced(lambda: lm.loss_fn(
            model, dataclasses.replace(cfg, dtype="float32"), batch0))
    reset_counts()
    losses, gnorms, auxes, secs = [], [], [], []
    for i in range(X_TRAIN_STEPS):
        batch = batch0 if i == 0 else pipe.next_batch(dev)
        (state, m), sec = synced(lambda: step(state, batch))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        auxes.append(m["moe_aux"].item())
        secs.append(sec)
    read_counts("(x3) granite_moe_1b_a400m train steps (no custom kernel on this path)")
    peak = torch.cuda.max_memory_allocated()
    d_loss = abs(losses[0] - l32.item())
    tokens = X_TRAIN_BATCH * pipe.seq
    log(f"[x3] steps: losses {[round(x, 6) for x in losses]}, moe_aux "
        f"{[round(x, 6) for x in auxes]} (float32: {m32['moe_aux'].item():.6f}), grad_norm "
        f"{[round(x, 6) for x in gnorms]} (printed, not held), "
        f"{', '.join(f'{s:.3f}' for s in secs)} s ({tokens / secs[-1]:.1f} tokens/s at the "
        f"last); step 1's loss against the float32 loss of the same masters and batch "
        f"({f32_s:.3f} s): {l32.item():.6f}, |Δloss| {d_loss:.3e} (≤ {TRAIN_LOSS_TOL}); peak "
        f"{peak / 2**30:.2f} GiB")
    assert np.isfinite(losses).all() and np.isfinite(gnorms).all() and min(gnorms) > 0, \
        "(x3) a non-finite loss or a zero gradient"
    assert np.isfinite(auxes).all() and min(auxes) > 0, "(x3) moe_aux is not finite and positive"
    assert d_loss <= TRAIN_LOSS_TOL, "(x3) step 1's loss strays from the float32 loss"
    del state, model, batch0, batch, step
    torch.cuda.empty_cache()
    log(f"[x3] phase {time.perf_counter() - t_x3:.2f}s")


def moe_phase(dev, kernels, reset_counts, read_counts, topk_check):
    """(x) the MoE presets on one card: (x1) granite_moe_1b_a400m at its
    published config with the kNN-LM head, (x2) qwen3_moe_235b_a22b at its
    published widths, depth cut to X_QWEN_LAYERS, (x3) granite's train step;
    appends (a)'s D = 1,024 ``knn_tile_topk`` row to ``kernels``."""
    import dataclasses

    from repro_torch.configs import RetrievalConfig, get_config

    t_x = time.perf_counter()
    granite = dataclasses.replace(get_config("granite_moe_1b_a400m"), retrieval=RetrievalConfig(
        enabled=True, k=8, lam=0.9, temperature=1.0))
    kernels.append(moe_serve(dev, "x1", granite, REC_STEPS, reset_counts, read_counts,
                             topk_check))
    qwen = dataclasses.replace(get_config("qwen3_moe_235b_a22b"), n_layers=X_QWEN_LAYERS)
    moe_serve(dev, "x2", qwen, X_QWEN_STEPS, reset_counts, read_counts)
    moe_train(dev, reset_counts, read_counts)
    log(f"[x] phase {time.perf_counter() - t_x:.2f}s")


class KeepProbe:
    """Within ``with``, record every ``layers._route`` call's expert ids and
    probabilities and every ``layers._keep`` call's count of dropped
    assignments, in call order (the one-device layer calls each once a
    layer; the slot program once a slot of each data group)."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers = layers
        self.routes, self.drops = [], []

    def __enter__(self):
        lay = self.layers
        route, keep = self.orig = lay._route, lay._keep

        def probe_route(cfg, probs):
            gates, eidx = route(cfg, probs)
            self.routes.append((eidx.detach(), probs.detach()))
            return gates, eidx

        def probe_keep(cfg, *args, **kw):
            out = keep(cfg, *args, **kw)
            self.drops.append(int((~out[0]).sum().item()))
            return out

        lay._route, lay._keep = probe_route, probe_keep
        return self

    def __exit__(self, *exc):
        self.layers._route, self.layers._keep = self.orig

    def by_layer(self, n_layers, n_groups=1, per=1):
        """Per layer (the calls in layer order, ``per`` slots of each of
        ``n_groups`` data groups a layer): (dropped assignments summed over
        the data groups, the ids of the groups' first slots joined in token
        order, the probabilities likewise); the slots of a group must agree."""
        import torch
        calls = n_groups * per
        assert len(self.drops) == n_layers * calls == len(self.routes), \
            (len(self.drops), len(self.routes), n_layers, calls)
        out = []
        for i in range(n_layers):
            drops = self.drops[i * calls:(i + 1) * calls]
            routes = self.routes[i * calls:(i + 1) * calls]
            firsts = list(range(0, calls, per))
            for f in firsts:
                assert len(set(drops[f:f + per])) == 1, "the slots of a group keep differently"
                assert all(bool((routes[f][0] == r[0].to(routes[f][0].device)).all())
                           for r in routes[f:f + per]), "the slots of a group route differently"
            join = lambda j: torch.cat([routes[f][j].to(routes[0][j].device) for f in firsts])
            out.append((sum(drops[f] for f in firsts), join(0), join(1)))
        return out


def hold_routing(tag, got, want, k, hold=True):
    """The slot program's routing by layer (``KeepProbe.by_layer``) against
    the one-device run's; with ``hold``: up to the first layer where a
    token's top-k set differs, the same dropped count; at that layer every
    differing token at a tie within Y_TIE (its 8th and 9th one-device
    probabilities).  Returns (the first such layer or None, a line that
    says what was compared)."""
    first, flips, worst = None, [], 0.0
    for i, ((d_g, e_g, _), (d_w, e_w, p_w)) in enumerate(zip(got, want)):
        differ = (e_g.sort(1).values != e_w.sort(1).values).any(1)
        flips.append(int(differ.sum()))
        if first is None and flips[-1]:
            first = i
            top = p_w[differ].sort(1, descending=True).values
            worst = float((top[:, k - 1] - top[:, k]).max())
            assert worst <= Y_TIE or not hold, \
                f"({tag}) layer {i}: a top-{k} set differs away from a tie"
        if hold and (first is None or i < first):
            assert d_g == d_w, f"({tag}) layer {i}: dropped {d_g} assignments, one device {d_w}"
    line = (f"dropped by layer {[g[0] for g in got]} (one device {[w[0] for w in want]}); "
            f"tokens whose top-{k} set differs from one device's by layer {flips}" +
            ("" if first is None else f" (first at layer {first}, its largest 8th-to-9th "
             f"probability gap {worst:.2e}" + (f" ≤ {Y_TIE}; layers past it printed, not held)"
                                               if hold else ")")))
    return first, line


def moe_sharded_serve(dev, tag, model, cfg, reset_counts, read_counts, f32=False, shd_cfg=None):
    """(y1) / (y2): ``model`` on 2 × 4 slots on the card: ``build_prefill``'s
    step on REC_BATCH × Y_PROMPT tokens and Y_STEPS of ``build_decode``'s,
    against the one-device ``transformer.prefill`` / ``decode_step`` on the
    same weights; with ``f32`` held by the routing and Y_F32_ATOL, else by
    (x)'s relative RMS criterion against a float32 run; the last step of
    each under ``torch.profiler``.  With ``shd_cfg`` the prefill runs again
    with the per-data-shard dispatch against the one-device prefill given
    the mesh's ``ShardingCtx``.  Returns (decode cell, per-slot argument
    and output bytes of a decode step on the card)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.models import transformer as lm
    from repro_torch.sharding import ShardingCtx
    from repro_torch.utils import tree_leaves

    t_y = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device=dev)
    assert set(mesh.slot_devices) == {str(dev) if dev.type == "cpu" else "cuda:0"}
    n = len(mesh.slot_devices)
    cache_len = Y_PROMPT + Y_STEPS
    rng = np.random.default_rng(REC_SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (REC_BATCH, Y_PROMPT)), device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (Y_STEPS, REC_BATCH)), device=dev)
    p_shape = ShapeConfig(f"prefill_{tag}", "prefill", cache_len, REC_BATCH)
    d_shape = ShapeConfig(f"decode_{tag}", "decode", cache_len, REC_BATCH)
    k = cfg.moe.top_k

    def one_device(c):
        logits, cache = lm.prefill(model, c, tokens, cache_len)
        out = [logits.float()]
        for i in range(Y_STEPS):
            logits, cache = lm.decode_step(model, c, toks[i], cache, Y_PROMPT + i)
            out.append(logits.float())
        return torch.stack(out, 1), cache

    l32 = None
    if not f32:
        l32, _ = one_device(dataclasses.replace(cfg, dtype="float32"))
        model._compute = None                      # the float32 copy of the weights
    with KeepProbe() as ref_probe:
        (ref, ref_cache), ref_s = synced(lambda: one_device(cfg))
    pre_d = ref_probe.drops[:cfg.n_layers]
    (_, ref_c), ref_pre_s = synced(lambda: lm.prefill(model, cfg, tokens, cache_len))
    ref_secs = []
    for i in range(Y_STEPS):
        _, sec = synced(lambda: lm.decode_step(model, cfg, toks[i], ref_c, Y_PROMPT + i))
        ref_secs.append(sec)
    ref_prof = profiled(lambda: lm.decode_step(model, cfg, toks[0], ref_c, Y_PROMPT))
    del ref_c

    prefill, _, (p_sh, b_sh) = steps.build_prefill(cfg, p_shape, mesh)
    step, _, (_, tok_sh, c_sh, pos_sh) = steps.build_decode(cfg, d_shape, mesh)
    params = steps.place(model.tree(), p_sh)
    batch = steps.place({"tokens": tokens}, b_sh)
    specs = sorted({str(a.sharding.spec) for a in tree_leaves(params["layers"][0]["moe"])})
    log(f"[{tag}] {cfg.name}'s width (d_model {cfg.d_model}, {cfg.moe.n_experts} experts "
        f"top-{k} × d_expert {cfg.moe.d_expert}, capacity {cfg.moe.capacity_factor}, vocab "
        f"{cfg.vocab_size}) with n_layers cut to {cfg.n_layers}, {cfg.dtype} activations, "
        f"{cfg.param_dtype} weights{', fsdp' if cfg.fsdp else ''} from seed {REC_SEED}, on "
        f"{mesh.sizes[0]} × {mesh.sizes[1]} slots; the MoE layer's specs {specs}; prompt "
        f"{REC_BATCH} × {Y_PROMPT}, {Y_STEPS} decode steps")
    reset_counts()
    with KeepProbe() as probe:
        (logits, cache), _ = synced(lambda: prefill(params, batch))
        got = [logits.gather().float()]
        for i in range(Y_STEPS):
            logits, cache = step(params, tok_sh.place(toks[i]), cache,
                                 pos_sh.place(torch.tensor(Y_PROMPT + i, dtype=torch.int32)))
            got.append(logits.gather().float())
    read_counts(f"({tag}) sharded prefill and decode (no custom kernel on this path)")
    got = torch.stack(got, 1)
    sp = probe.by_layer(cfg.n_layers * (1 + Y_STEPS), *mesh.sizes)
    ref_all = ref_probe.by_layer(cfg.n_layers * (1 + Y_STEPS))
    first, line = hold_routing(f"{tag} prefill", sp[:cfg.n_layers], ref_all[:cfg.n_layers], k,
                               f32)
    d_first, d_line = hold_routing(f"{tag} decode", sp[cfg.n_layers:], ref_all[cfg.n_layers:], k,
                                   f32)
    gap = (got - ref).abs().max().item()
    if f32:
        log(f"[{tag}] the prefill's routing at capacity {cfg.moe.capacity_factor}: dropped share "
            f"by layer {[round(x / (REC_BATCH * Y_PROMPT * k), 4) for x in pre_d]}; {line}")
        log(f"[{tag}] decode's routing: {d_line}")
        log(f"[{tag}] logits (prefill's last and {Y_STEPS} decode steps) max |Δ| {gap:.3e} from "
            f"the one-device run's (≤ {Y_F32_ATOL} where no top-{k} set differs)")
        if first is None and d_first is None:
            assert gap <= Y_F32_ATOL, f"({tag}) the float32 logits stray from one device's"
    else:
        g, noise = rel_rms(got, l32), rel_rms(ref, l32)
        log(f"[{tag}] prefill and decode at capacity {cfg.moe.capacity_factor}: relative RMS "
            f"gap to the float32 logits {g:.4e} (the one-device bf16 run's {noise:.4e}; ≤ "
            f"{X_RMS_RATIO:g} ×), max |Δ| to the bf16 run's {gap:.4f}; {line}; decode: {d_line}")
        assert g <= X_RMS_RATIO * noise, f"({tag}) the logits stray beyond bf16 rounding"
    del got, ref, l32

    # Timed: the sharded prefill and decode steps from a fresh prefill.
    (_, cache), pre_s = synced(lambda: prefill(params, batch))
    secs = []
    for i in range(Y_STEPS):
        tok = tok_sh.place(toks[i])
        pos_t = pos_sh.place(torch.tensor(Y_PROMPT + i, dtype=torch.int32))
        if i == 0:
            card_in = per_slot_bytes(n, params, tok, cache, pos_t)
        (logits, cache), sec = synced(lambda: step(params, tok, cache, pos_t))
        secs.append(sec)
    card_out = [logits.slot_nbytes(s) + sum(a.slot_nbytes(s) for a in tree_leaves(cache))
                for s in range(n)]
    prof = profiled(lambda: step(params, tok_sh.place(toks[0]), cache,
                                 pos_sh.place(torch.tensor(Y_PROMPT, dtype=torch.int32))))
    med, ref_med = float(np.median(secs)), float(np.median(ref_secs))
    log(f"[{tag}] prefill: sharded {pre_s:.3f} s ({REC_BATCH * Y_PROMPT / pre_s:.1f} tokens/s), "
        f"one-device {ref_pre_s:.3f} s; decode step median: sharded {med * 1e3:.3f} ms "
        f"[{min(secs) * 1e3:.3f}–{max(secs) * 1e3:.3f}], one-device {ref_med * 1e3:.3f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[{tag}] a sharded decode step under torch.profiler: {profile_line(*prof[1:])}")
    log(f"[{tag}] a one-device decode step under torch.profiler: {profile_line(*ref_prof[1:])}")

    if shd_cfg is not None:
        fn, _, (ps_sh, bs_sh) = steps.build_prefill(shd_cfg, p_shape, mesh)
        shd = ShardingCtx.for_mesh(mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard)
        with KeepProbe() as ref_sd:
            want, _ = lm.prefill(model, shd_cfg, tokens, cache_len, shd)
        with KeepProbe() as sd:
            (lg, _), sd_s = synced(lambda: fn(params, batch))
        sd_gap = (lg.gather().float() - want.float()).abs().max().item()
        chunks = [sum(ref_sd.drops[i * 2:i * 2 + 2]) for i in range(cfg.n_layers)]
        slots_ = [sum(sd.drops[i * n + g * SPMD_MODEL] for g in range(2))
                  for i in range(cfg.n_layers)]
        log(f"[{tag}] the per-data-shard dispatch (moe_sharded_dispatch, a buffer a data group "
            f"of cap {layers._moe_cap(shd_cfg, REC_BATCH * Y_PROMPT // 2)}): sharded prefill "
            f"{sd_s:.3f} s, "
            f"last logits max |Δ| {sd_gap:.3e} from the one-device prefill with the mesh's "
            f"ShardingCtx (≤ {Y_F32_ATOL}); dropped by layer {slots_} (one device's chunks "
            f"{chunks})")
        if slots_ == chunks:
            assert sd_gap <= Y_F32_ATOL, f"({tag}) the per-data-shard prefill strays"
        assert max(abs(a - b) for a, b in zip(slots_, chunks)) <= k, \
            f"({tag}) the per-data-shard dispatch drops other assignments than one device's"
    del cache, params, batch, logits, ref_cache
    torch.cuda.empty_cache()
    log(f"[{tag}] phase {time.perf_counter() - t_y:.2f}s")
    return d_shape, card_in, card_out



def moe_sharded_train(dev, reset_counts, read_counts):
    """(y3) one sharded train step at granite_moe_1b_a400m's width, depth
    Y_TRAIN_LAYERS, on 2 × 4 slots, once with each dispatch, from seed
    REC_SEED weights; step 1 held to the one-device ``make_train_step`` (the
    per-data-shard one given the mesh's ``ShardingCtx``) by (t1)'s bounds;
    ``moe_aux`` finite and above 0."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.sharding import ShardingCtx
    from repro_torch.utils import tree_leaves

    mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device=dev)
    full = get_config("granite_moe_1b_a400m")
    for sharded in (False, True):
        t_y3 = time.perf_counter()
        cfg = dataclasses.replace(full, n_layers=Y_TRAIN_LAYERS, moe_sharded_dispatch=sharded)
        opt_cfg = OptConfig(total_steps=2, warmup_steps=1, moment_dtype=cfg.opt_state_dtype)
        pipe = TokenPipeline(cfg, SHAPES["train_4k"], batch_override=Y_TRAIN_BATCH,
                             seq_override=Y_TRAIN_SEQ)
        batch = pipe.next_batch(dev)
        shd = ShardingCtx.for_mesh(mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard) if sharded \
            else None
        ref = lm.init_params(REC_SEED, cfg, device=dev)
        (ref_state, ref_m), ref_s = synced(lambda: steps.make_train_step(cfg, opt_cfg, shd)(
            {"params": ref, "opt": init_opt_state(ref.tree(), opt_cfg)}, batch))
        ref_loss, ref_aux, lr1 = (ref_m[k].item() for k in ("loss", "moe_aux", "lr"))
        model = lm.init_params(REC_SEED, cfg, device=dev)
        step, _, (st_sh, _) = steps.build_train(cfg, SHAPES["train_4k"], mesh, opt_cfg)
        state = steps.init_placed_state(model.tree(), opt_cfg, st_sh)
        del model
        reset_counts()
        (state, m), sec = synced(lambda: step(state, batch))
        read_counts(f"(y3) granite sharded train step (no custom kernel on this path)")
        loss, aux = m["loss"].item(), m["moe_aux"].item()
        gap, n_far, n_all = 0.0, 0, 0
        with torch.no_grad():
            for a, r in zip(tree_leaves(state["params"]), tree_leaves(ref.tree())):
                d = (a.gather() - r).abs()
                gap = max(gap, d.max().item())
                n_far += int((d > lr1).sum().item())
                n_all += d.numel()
        what = "per-data-shard" if sharded else "global"
        log(f"[y3] {what} dispatch: granite's width, n_layers cut {full.n_layers} → "
            f"{cfg.n_layers}, batch {Y_TRAIN_BATCH} × {pipe.seq} on {mesh.sizes[0]} × "
            f"{mesh.sizes[1]} slots: step 1 loss {loss:.6f}, moe_aux {aux:.6f} in {sec:.3f} s; the "
            f"one-device step: loss {ref_loss:.6f}, moe_aux {ref_aux:.6f} in {ref_s:.3f} s; "
            f"|Δloss| {abs(loss - ref_loss):.3e}, |Δmoe_aux| {abs(aux - ref_aux):.3e} (≤ "
            f"{TRAIN_LOSS_TOL}); max |Δmaster| {gap:.3e} (≤ 2·lr₁ + {SPMD_MASTER_ATOL}), "
            f"{n_far} of {n_all} ({n_far / n_all:.3e}) apart by more than lr₁ (≤ "
            f"{SPMD_FLIP_SHARE}); {time.perf_counter() - t_y3:.2f} s")
        assert np.isfinite([loss, aux]).all() and aux > 0, "(y3) moe_aux is not finite and positive"
        assert abs(loss - ref_loss) <= TRAIN_LOSS_TOL, "(y3) the loss strays from one device's"
        assert abs(aux - ref_aux) <= TRAIN_LOSS_TOL, "(y3) moe_aux strays from one device's"
        assert gap <= 2 * lr1 + SPMD_MASTER_ATOL, "(y3) a master strays past two steps"
        assert n_far <= SPMD_FLIP_SHARE * n_all, "(y3) too many masters off the one-device step"
        del state, ref, ref_state, batch, step, m
        torch.cuda.empty_cache()


def moe_sharded_phase(dev, reset_counts, read_counts):
    """(y) the MoE presets in the slot program on 2 × 4 slots on the card:
    (y1) granite_moe_1b_a400m at its widths, depth Y_LAYERS, float32, the
    published capacity (the global dispatch across the data groups held
    by its dropped counts), and its prefill with the per-data-shard
    dispatch; (y2) qwen3_moe_235b_a22b at its widths, depth Y_QWEN_LAYERS,
    bf16 and FSDP, capacity Y_QWEN_CAPACITY; (y3) granite's sharded train
    step with each dispatch; (y4) the dry run's records of (y1)'s and (y2)'s
    decode cells on 2 × 4 ``meta`` slots beside the card's blocks."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as lm

    t_y = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[y] device memory held from earlier phases: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m"), n_layers=Y_LAYERS,
                              dtype="float32")
    model = lm.init_params(REC_SEED, cfg, device=dev)
    cells = [(cfg,) + moe_sharded_serve(dev, "y1", model, cfg, reset_counts, read_counts,
                                        f32=True, shd_cfg=dataclasses.replace(
                                            cfg, moe_sharded_dispatch=True))]
    del model
    q = get_config("qwen3_moe_235b_a22b")
    cfg = dataclasses.replace(q, n_layers=Y_QWEN_LAYERS, moe=dataclasses.replace(
        q.moe, capacity_factor=Y_QWEN_CAPACITY))
    model = lm.init_params(REC_SEED, cfg, device=dev)
    cells.append((cfg,) + moe_sharded_serve(dev, "y2", model, cfg, reset_counts, read_counts))
    del model
    torch.cuda.empty_cache()
    moe_sharded_train(dev, reset_counts, read_counts)
    meta_mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device="meta")
    for tag, (cfg, shape, card_in, card_out) in zip(("y1", "y2"), cells):
        rec = dryrun.record_cell(cfg.name, shape, meta_mesh, cfg=cfg, verbose=False)
        assert rec["ok"], rec.get("traceback")
        ma = rec["memory_analysis"]
        log(f"[y4] ({tag})'s decode cell: dry run traced in {rec['t_lower_s']:.2f} s (depths "
            f"{rec['trace']['depths']}); per slot: arguments {ma['argument_size_in_bytes']} B (on "
            f"the card {card_in[0]}), outputs {ma['output_size_in_bytes']} B (on the card "
            f"{card_out[0]}); collectives per slot {rec['collective_bytes_weighted']} "
            f"({rec['collective_counts']} once)")
        assert card_in == [ma["argument_size_in_bytes"]] * SPMD_SLOTS, \
            f"(y4) ({tag})'s per-slot argument bytes differ from the card's"
        assert card_out == [ma["output_size_in_bytes"]] * SPMD_SLOTS, \
            f"(y4) ({tag})'s per-slot output bytes differ from the card's"
    log(f"[y] phase {time.perf_counter() - t_y:.2f}s")


def lookup_model(dev, tag, arch):
    """(z1) / (za1): ``arch``'s published config with the kNN-LM head as in
    (v), its seeded masters on ``dev`` (seed REC_SEED), the parameter count
    held to its tables'.  Returns (cfg, model, count, init ms)."""
    import dataclasses

    import torch

    from repro_torch.configs import RetrievalConfig, get_config
    from repro_torch.models import transformer as lm
    from repro_torch.utils import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[{tag}] device memory held from earlier phases: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    cfg = dataclasses.replace(get_config(arch), retrieval=RetrievalConfig(
        enabled=True, k=8, lam=0.9, temperature=1.0))
    model, init_ms = timed(lambda: lm.init_params(REC_SEED, cfg, device=dev))
    n_par = sum(p.numel() for p in model.parameters())
    assert n_par == sum(t.numel() for t in tree_leaves(lm.param_shapes(cfg))), \
        f"({tag}1) the model's parameter count is not its tables'"
    return cfg, model, n_par, init_ms


def lookup_datastore(tag, model, cfg, corpus, without):
    """(z1) / (za1): the kNN-LM datastore over ``corpus``, built by the
    decoder run without ``without`` (frames, patches), as the reference
    builds it."""
    from repro_torch.models import knn_lm

    ds, ds_s = synced(lambda: knn_lm.build_datastore(model, cfg, [corpus]))
    n_keys = corpus.shape[0] * (corpus.shape[1] - 1)
    assert tuple(ds.keys.shape) == (n_keys, cfg.d_model)
    log(f"[{tag}1] build_datastore over {corpus.shape[0]} × {corpus.shape[1]} tokens (the "
        f"decoder without {without}, as the reference builds it): {n_keys} keys × "
        f"{cfg.d_model} dims in {ds_s:.3f}s")
    return ds


def serve_lookup(tag, model, cfg, prompts, ds, start, n_steps, cache_len, reset_counts,
                 read_counts, **inputs):
    """(z1) / (za1): ``serve.generate``'s loop with the prefill given
    ``inputs`` (``frames=`` or ``patches=``), then ``n_steps`` greedy
    ``decode_step_retrieval`` steps from position ``start``, the prefill,
    each LM step and each lookup timed; one ``knn_tile_topk`` launch a step
    (the prefill's logits are bare).  Returns (tokens (B, n_steps + 1), the
    cache, the prefill's logits, the steps' final-norm hidden states (B,
    n_steps, D), the lookup's first ``knn_topk`` call, the launch counts,
    the LM's ms a step, the wall seconds after the prefill)."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.kernels.knn_topk import ops as topk_ops
    from repro_torch.models import knn_lm
    from repro_torch.models import transformer as lm

    def serve():
        logits, cache = lm.prefill(model, cfg, prompts, cache_len, **inputs)
        toks = [torch.argmax(logits, dim=-1)]
        for t in range(n_steps):
            logits, cache = knn_lm.decode_step_retrieval(model, cfg, toks[-1], cache,
                                                         start + t, ds)
            toks.append(torch.argmax(logits, dim=-1))
        return torch.stack(toks, dim=1), cache

    what = ", ".join(inputs)
    spies = [Spy(lm, "prefill"), Spy(lm, "decode_step_hidden"), Spy(knn_lm, "lookup", keep=False)]
    reset_counts()
    with contextlib.ExitStack() as stack, FirstCall(topk_ops, "knn_topk") as call:
        for sp in spies:
            stack.enter_context(sp)
        (out, cache), wall = synced(serve)
    launches = read_counts(f"({tag}1) {cfg.name}: prefill({what}=) + {n_steps} decode steps "
                           f"with the in-step lookup")
    assert tuple(out.shape) == (prompts.shape[0], n_steps + 1)
    assert launches.get("knn_tile_topk", 0) == n_steps, \
        f"({tag}1) expected one knn_tile_topk launch a decode step"
    lm_t = np.array(spies[1].times) * 1e3
    ret_t = np.array(spies[2].times) * 1e3
    after = wall - spies[0].times[0]
    log(f"[{tag}1] serving: prefill of {prompts.shape[0]} × {prompts.shape[1]} tokens with the "
        f"{what} {spies[0].times[0]:.3f}s; per decode step: LM {lm_t.mean():.3f} ms "
        f"[{lm_t.min():.3f}–{lm_t.max():.3f}], lookup {ret_t.mean():.3f} ms [{ret_t.min():.3f}–"
        f"{ret_t.max():.3f}]; {prompts.shape[0]} × {n_steps} tokens in {wall:.3f}s, "
        f"{prompts.shape[0] * n_steps / after:.1f} tokens/s after the prefill; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    hid = torch.stack([c[2][0] for c in spies[1].calls], 1)
    return out, cache, spies[0].calls[0][2][0], hid, call, launches, lm_t


def hold_lookup_serving(tag, model, cfg, prompts, out, pre_logits, hid, start, ratio, **inputs):
    """(z1) / (za1) checks (b) and (c).  (b) decode against forward: the
    serving loop's LM logits (the prefill's, then each step's unembedded
    hidden state) and ``forward_seq(**inputs)``'s over the same tokens, from
    position ``start`` − 1 on, each against a float32 forward of the same
    masters, by (r)'s criterion.  (c) the prefill's last logits with
    ``inputs`` and without them differ, by relative RMS, by more than
    ``ratio`` times the bf16 forward's own gap to float32."""
    import dataclasses

    import torch

    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as lm

    n_steps = hid.shape[1]
    what = ", ".join(inputs)
    with torch.no_grad():
        dec = torch.cat([pre_logits[:, None],
                         lm_layers.unembed(model.embed, cfg, hid)], 1).float()
        seq = torch.cat([prompts, out[:, :n_steps]], 1)
        last = slice(start - 1, start + n_steps)
        fwd = lm_layers.unembed(model.embed, cfg, lm.forward_seq(
            model, cfg, seq, **inputs)[0][:, last]).float()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        f32 = lm_layers.unembed(model.embed, cfg32, lm.forward_seq(
            model, cfg32, seq, **inputs)[0][:, last]).float()
        model._compute = None                  # the float32 compute tree
        bare, _ = lm.prefill(model, cfg, prompts, prompts.shape[1])
    noise = rel_rms(fwd, f32)
    log(f"[{tag}1] (b) decode matches forward over {dec.shape[1]} positions × {dec.shape[0]} "
        f"rows (the bf16 forward's relative RMS gap to float32 {noise:.4e}, the decode's "
        f"{rel_rms(dec, f32):.4e}):")
    logit_check(f"({tag}1) prefill({what}=) + decode steps", dec, fwd, f32)
    moved = rel_rms(bare.float(), pre_logits.float())
    log(f"[{tag}1] (c) the prefill's last logits with the {what} and without them: relative RMS "
        f"{moved:.4e}, {moved / noise:.1f} × the bf16 forward's gap to float32 (> {ratio:g} ×)")
    assert moved > ratio * noise, f"({tag}1) the {what} do not move the logits"


def profile_decode_step(tag, model, cfg, tok, cache, pos, lm_t):
    """(z1) / (za1): one LM decode step at ``pos`` + 1 under
    ``torch.profiler`` after a warm one at ``pos`` (printed, not gated)."""
    import torch

    from repro_torch.models import transformer as lm

    lm.decode_step_hidden(model, cfg, tok, cache, pos)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        (_, step_s) = synced(lambda: lm.decode_step_hidden(model, cfg, tok, cache, pos + 1))
    dev_ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    log(f"[{tag}1] one LM decode step under torch.profiler: {len(dev_ev)} device events, the "
        f"card busy {busy:.3f} ms of {step_s * 1e3:.3f} ms (busy share "
        f"{busy / (step_s * 1e3):.3f}; {lm_t.mean():.3f} ms unprofiled)" if dev_ev else
        f"[{tag}1] one LM decode step under torch.profiler: no device events recorded")


def encdec_phase(dev, kernels, reset_counts, read_counts, topk_check):
    """(z) the encoder-decoder on one card: (z1) ``whisper_large_v3`` at its
    published config served with the kNN-LM head's in-step lookup — the
    prefill given the frames, then ``decode_step_retrieval`` greedily —
    with four checks: (a) each decoder layer's cross cache is
    ``init_cross_cache`` of ``encode(frames)`` bit for bit; (b) the
    decode's logits and ``forward_seq(frames=)``'s, each in bf16, against a
    float32 forward by (r)'s criterion; (c) the frames move the prefill's
    logits (``Z_FRAMES_RATIO``); (d) the lookup's ``knn_tile_topk`` against
    its plain version, its row appended to ``kernels``.  One profiled
    decode step."""
    import numpy as np
    import torch

    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as lm

    t_z = time.perf_counter()
    cfg, model, n_par, init_ms = lookup_model(dev, "z", "whisper_large_v3")
    assert cfg.n_params() == Z_PARAMS
    log(f"[z1] {cfg.name}: {cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads × {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, encoder_seq {cfg.encoder_seq}, attn_chunk "
        f"{cfg.attn_chunk}, LayerNorm + GELU, {cfg.dtype} activations, {cfg.param_dtype} "
        f"weights; {n_par} parameters (n_params() {cfg.n_params()} without the norms) from "
        f"seed {REC_SEED} in {init_ms / 1e3:.3f}s")
    rng = np.random.default_rng(REC_SEED)
    corpus = rng.integers(0, cfg.vocab_size, (REC_KEY_SEQS, REC_KEY_LEN))
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (REC_BATCH, Z_PROMPT)),
                              device=dev)
    # The reference pipeline's stub frontend: seeded standard normal frames.
    frames = torch.as_tensor(rng.standard_normal(
        (REC_BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32), device=dev)
    ds = lookup_datastore("z", model, cfg, corpus, "frames")

    cache_len = Z_PROMPT + Z_STEPS + 2           # two more for the profiled step
    out, cache, pre_logits, hid, call, launches, lm_t = serve_lookup(
        "z", model, cfg, prompts, ds, Z_PROMPT, Z_STEPS, cache_len, reset_counts, read_counts,
        frames=frames)
    with torch.no_grad():
        eo, enc_ms = timed(lambda: lm.encode(model, cfg, frames))
    log(f"[z1] encode of {REC_BATCH} × {cfg.encoder_seq} frames {enc_ms:.3f} ms alone")

    # (a) the cross cache, bit for bit.
    p = lm._cast_params(model, cfg)
    for i, (lp, st) in enumerate(zip(p["layers"], cache)):
        want = lm_layers.init_cross_cache(lp["xattn"], cfg, eo)
        assert torch.equal(st["cross"]["k"], want["k"]) and \
            torch.equal(st["cross"]["v"], want["v"]), \
            f"(z1) layer {i}'s cross cache is not init_cross_cache(encode(frames))"
    log(f"[z1] (a) every one of the {cfg.n_layers} layers' prefill cross cache "
        f"({tuple(cache[0]['cross']['k'].shape)} K and V) equals init_cross_cache of "
        f"encode(frames) bit for bit")
    del p, eo, cache

    hold_lookup_serving("z", model, cfg, prompts, out, pre_logits, hid, Z_PROMPT,
                        Z_FRAMES_RATIO, frames=frames)
    del pre_logits, hid
    with torch.no_grad():
        _, cache = lm.prefill(model, cfg, prompts, cache_len, frames=frames)
    profile_decode_step("z", model, cfg, out[:, -1], cache, Z_PROMPT, lm_t)
    del cache, model
    torch.cuda.empty_cache()

    # (d) the lookup's kernel against its plain version.
    (q, c, qid, cid), kw = call.args
    kernels.append(topk_check(f"knn_tile_topk (kNN-LM lookup, {cfg.name}, D={cfg.d_model})",
                              q, c, qid, cid, "l2", launches["knn_tile_topk"], fp32_bound=True,
                              k=kw["k"]))
    del ds, call, q, c
    torch.cuda.empty_cache()
    log(f"[z] phase {time.perf_counter() - t_z:.2f}s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the float32 check included)")


def vlm_phase(dev, kernels, reset_counts, read_counts, topk_check):
    """(za) the VLM on one card: (za1) ``llava_next_mistral_7b`` at its
    published config served with the kNN-LM head's in-step lookup — the
    prefill given the patches, then ``decode_step_retrieval`` greedily from
    position P + S — with four checks: (a) the patches sit first and see no
    text: a prefill of other prompts after the same patches leaves every
    layer's K/V at the patch positions bit for bit the same; (b) the
    decode's logits and ``forward_seq(patches=)``'s, each in bf16, against a
    float32 forward by (r)'s criterion; (c) the patches move the prefill's
    logits (``ZA_PATCHES_RATIO``); (d) the lookup's ``knn_tile_topk`` against
    its plain version, its row appended to ``kernels``.  One profiled
    decode step."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as lm

    t_za = time.perf_counter()
    cfg, model, n_par, init_ms = lookup_model(dev, "za", "llava_next_mistral_7b")
    d, n_p = cfg.d_model, cfg.n_patches
    n_proj, n_norm = cfg.patch_dim * d + d * d, d * (2 * cfg.n_layers + 1)
    assert n_par == cfg.n_params() + n_proj + n_norm == ZA_PARAMS, \
        "(za1) the parameter count is not n_params() and the projector's and norms'"
    log(f"[za1] {cfg.name}: {cfg.n_layers} layers, d_model {d}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads × {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, rope θ "
        f"{cfg.rope_theta:g}, {n_p} patches of {cfg.patch_dim} features, attn_chunk "
        f"{cfg.attn_chunk}, {cfg.dtype} activations, {cfg.param_dtype} weights; {n_par} "
        f"parameters (n_params() {cfg.n_params()}, the projector {n_proj}, norm scales "
        f"{n_norm}) from seed {REC_SEED} in {init_ms / 1e3:.3f}s")
    rng = np.random.default_rng(REC_SEED)
    corpus = rng.integers(0, cfg.vocab_size, (REC_KEY_SEQS, REC_KEY_LEN))
    prompts, other = (torch.as_tensor(rng.integers(0, cfg.vocab_size, (REC_BATCH, ZA_PROMPT)),
                                      device=dev) for _ in range(2))
    # The reference pipeline's stub vision tower: seeded standard normal
    # CLIP features.
    patches = torch.as_tensor(rng.standard_normal(
        (REC_BATCH, n_p, cfg.patch_dim)).astype(np.float32), device=dev)
    ds = lookup_datastore("za", model, cfg, corpus, "patches")

    # The cache holds the patches' positions, and decode continues after them.
    start = n_p + ZA_PROMPT
    cache_len = start + ZA_STEPS + 2             # two more for the profiled step
    out, cache, pre_logits, hid, call, launches, lm_t = serve_lookup(
        "za", model, cfg, prompts, ds, start, ZA_STEPS, cache_len, reset_counts, read_counts,
        patches=patches)
    with torch.no_grad():
        _, proj_ms = timed(lambda: lm.project_patches(model, cfg, patches))
    log(f"[za1] the projector over {REC_BATCH} × {n_p} patches {proj_ms:.3f} ms alone")

    # (a) the patches sit first and see no text: other prompts after the same
    # patches leave their K/V bit for bit (decode wrote only from `start`).
    _, cache2 = lm.prefill(model, cfg, other, cache_len, patches=patches)
    for i, (st, st2) in enumerate(zip(cache, cache2)):
        for n in ("k", "v"):
            assert torch.equal(st["kv"][n][:, :n_p], st2["kv"][n][:, :n_p]), \
                f"(za1) layer {i}'s {n} at the patch positions moved with the text"
    assert not torch.equal(cache[0]["kv"]["k"][:, n_p:start], cache2[0]["kv"]["k"][:, n_p:start])
    log(f"[za1] (a) every one of the {cfg.n_layers} layers' K and V at the {n_p} patch positions "
        f"equal bit for bit after two different prompts; the text positions differ")
    del cache

    hold_lookup_serving("za", model, cfg, prompts, out, pre_logits, hid, start,
                        ZA_PATCHES_RATIO, patches=patches)
    del pre_logits, hid
    profile_decode_step("za", model, cfg, out[:, -1], cache2, start, lm_t)
    del cache2, model
    torch.cuda.empty_cache()

    # (d) the lookup's kernel against its plain version.
    (q, c, qid, cid), kw = call.args
    kernels.append(topk_check(f"knn_tile_topk (kNN-LM lookup, {cfg.name}, D={d})",
                              q, c, qid, cid, "l2", launches["knn_tile_topk"], fp32_bound=True,
                              k=kw["k"]))
    del ds, call, q, c
    torch.cuda.empty_cache()
    log(f"[za] phase {time.perf_counter() - t_za:.2f}s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the float32 check included)")


def cross_only(cache):
    """Each layer's cross K/V of a decode state."""
    return [{"cross": st["cross"]} for st in cache]


def sharded_side_serve(dev, tag, model, side, other, reset_counts, read_counts):
    """(zb1) / (zb2): ``model`` on 2 × 4 slots on the card with ``side``
    (``{"frames": ...}`` or ``{"patches": ...}``): ``build_prefill``'s step
    on REC_BATCH × ZB_PROMPT tokens after them, then ZB_STEPS of
    ``build_decode``'s, each held to the one-device ``transformer.prefill``
    / ``decode_step`` of the same weights by (w)'s criteria against a
    float32 run; the last step under ``torch.profiler`` beside a one-device
    step's.  ``other`` (other frames or patches) must move the sharded
    prefill's logits.  (zb1) holds every layer's cross K/V by
    W_STATE_RATIO; (zb2) a sharded prefill of other prompts (the prefill
    cell, cache of P + S positions) must leave the patches' K/V bit for
    bit.  Returns (the dry-run cell, its per-slot argument and output bytes
    on the card): (zb1)'s decode cell, (zb2)'s prefill cell."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.utils import tree_leaves

    t_zb = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.cfg
    full = get_config(cfg.name)
    (what, inputs), = side.items()
    n_p = cfg.n_patches if what == "patches" else 0
    start = n_p + ZB_PROMPT
    cache_len = start + ZB_STEPS
    mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device=dev)
    assert set(mesh.slot_devices) == {str(dev) if dev.type == "cpu" else "cuda:0"}
    n = len(mesh.slot_devices)
    rng = np.random.default_rng(REC_SEED)
    tokens, prompts2 = (torch.as_tensor(rng.integers(0, cfg.vocab_size, (REC_BATCH, ZB_PROMPT)),
                                        device=dev) for _ in range(2))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (ZB_STEPS, REC_BATCH)), device=dev)
    p_shape = ShapeConfig(f"prefill_{tag}", "prefill", cache_len, REC_BATCH)
    d_shape = ShapeConfig(f"decode_{tag}", "decode", cache_len, REC_BATCH)

    def one_device(c):
        (logits, cache), pre_s = synced(lambda: lm.prefill(model, c, tokens, cache_len, **side))
        out, secs = [logits.float()], []
        for i in range(ZB_STEPS):
            (logits, cache), sec = synced(lambda: lm.decode_step(model, c, toks[i], cache,
                                                                 start + i))
            out.append(logits.float())
            secs.append(sec)
        return torch.stack(out, 1), cache, pre_s, secs

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    l32, ref32, _, _ = one_device(cfg32)
    model._compute = None                          # the float32 copy of the bf16 weights
    ref, ref_cache, ref_pre, ref_secs = one_device(cfg)
    ref_prof = profiled(lambda: lm.decode_step(model, cfg, toks[0], ref_cache, start))
    noise = rel_rms(ref[:, 0], l32[:, 0])          # the bf16 prefill's gap to float32

    prefill, _, (p_sh, b_sh) = steps.build_prefill(cfg, p_shape, mesh)
    step, _, (_, tok_sh, c_sh, pos_sh) = steps.build_decode(cfg, d_shape, mesh)
    params = steps.place(model.tree(), p_sh)
    batch = steps.place({"tokens": tokens, **side}, b_sh)
    depth = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers (cut from "
             f"{full.n_encoder_layers} + {full.n_layers})" if cfg.n_encoder_layers else
             f"{cfg.n_layers} layers (cut from {full.n_layers})")
    log(f"[{tag}] {cfg.name}'s width (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
        f"× {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) with {depth}, bf16 weights and "
        f"activations from seed {REC_SEED}, on {mesh.sizes[0]} × {mesh.sizes[1]} slots; "
        f"{what} {tuple(inputs.shape)}, prompt {REC_BATCH} × {ZB_PROMPT}, {ZB_STEPS} decode steps "
        f"from position {start}; layer 0's attention specs "
        f"{sorted({str(a.sharding.spec) for a in tree_leaves(params['layers'][0]['attn'])})}")
    reset_counts()
    (logits, cache), pre_s = synced(lambda: prefill(params, batch))
    read_counts(f"({tag}) sharded prefill with the {what} (no custom kernel on this path)")
    got = [logits.gather().float()]
    gap, agree, clear = hold_logits(f"({tag}) prefill", got[0], ref[:, 0])
    log(f"[{tag}] prefill: sharded {pre_s:.3f} s ({REC_BATCH * ZB_PROMPT / pre_s:.1f} text "
        f"tokens/s), one-device {ref_pre:.3f} s; last logits max |Δ| {gap:.4f} (≤ "
        f"{SERVE_LOGIT_ATOL}), argmax equal in {agree} of {REC_BATCH} rows ({clear} clear of a "
        f"tie)")
    logit_check(f"({tag}) the sharded prefill's last logits", got[0], ref[:, 0], l32[:, 0])
    assert [a.sharding.spec for a in tree_leaves(cache)] == \
        [sh.spec for sh in tree_leaves(c_sh)], f"({tag}) the prefill's cache is not decode's"
    if what == "frames":
        held = hold_states(f"({tag}) cross K/V", cross_only(cache), cross_only(ref_cache),
                           cross_only(ref32))
        log(f"[{tag}] the cross K/V ({tuple(cache[0]['cross']['k'].shape)} a layer, spec "
            f"{cache[0]['cross']['k'].sharding.spec}): {held}")

    reset_counts()
    secs, prof = [], None
    for i in range(ZB_STEPS):
        tok = tok_sh.place(toks[i])
        pos_t = pos_sh.place(torch.tensor(start + i, dtype=torch.int32))
        if i == 0:
            card_in = per_slot_bytes(n, params, tok, cache, pos_t)
        if i == ZB_STEPS - 1:
            (logits, cache), *prof = profiled(lambda: step(params, tok, cache, pos_t))
        else:
            (logits, cache), sec = synced(lambda: step(params, tok, cache, pos_t))
            secs.append(sec)
        got.append(logits.gather().float())
    read_counts(f"({tag}) sharded decode (no custom kernel on this path)")
    card_out = [logits.slot_nbytes(s) + sum(a.slot_nbytes(s) for a in tree_leaves(cache))
                for s in range(n)]
    got = torch.stack(got, 1)
    gap, agree, clear = hold_logits(f"({tag}) decode", got[:, 1:], ref[:, 1:])
    med = float(np.median(secs))
    log(f"[{tag}] decode: sharded step median {med * 1e3:.3f} ms [{min(secs) * 1e3:.3f}–"
        f"{max(secs) * 1e3:.3f}], one-device {float(np.median(ref_secs)) * 1e3:.3f} ms; logits "
        f"max |Δ| {gap:.4f} (≤ {SERVE_LOGIT_ATOL}), argmax equal in {agree} of "
        f"{REC_BATCH * ZB_STEPS} ({clear} clear of a tie); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    logit_check(f"({tag}) {ZB_STEPS} sharded decode steps' logits", got[:, 1:], ref[:, 1:],
                l32[:, 1:])
    log(f"[{tag}] sharded decode step {ZB_STEPS} under torch.profiler: {profile_line(*prof)}")
    log(f"[{tag}] a one-device decode step under torch.profiler: {profile_line(*ref_prof[1:])}")
    del ref_cache, ref32

    # The side input matters: other frames / patches move the sharded logits.
    moved_in = steps.place({"tokens": tokens, what: other}, b_sh)
    moved = rel_rms(prefill(params, moved_in)[0].gather().float(), got[:, 0])
    ratio = Z_FRAMES_RATIO if what == "frames" else ZA_PATCHES_RATIO
    log(f"[{tag}] other {what}: the sharded prefill's last logits move by relative RMS "
        f"{moved:.4e}, {moved / noise:.1f} × the one-device bf16 prefill's gap to float32 "
        f"{noise:.4e} (> {ratio:g} ×)")
    assert moved > ratio * noise, f"({tag}) the {what} do not move the sharded logits"
    del moved_in, logits

    cell = (d_shape, card_in, card_out)
    if what == "patches":
        # The prefill cell: other prompts after the same patches, a cache of
        # P + S positions; the patches' K/V bit for bit the first prefill's
        # (decode wrote from position P + S on).
        cell_shape = ShapeConfig(f"prefill_{tag}", "prefill", start, REC_BATCH)
        fn2, _, (_, b2_sh) = steps.build_prefill(cfg, cell_shape, mesh)
        batch2 = steps.place({"tokens": prompts2, **side}, b2_sh)
        (logits2, cache2), pre2_s = synced(lambda: fn2(params, batch2))
        for i, (st, st2) in enumerate(zip(cache, cache2)):
            for k in ("k", "v"):
                assert torch.equal(st["kv"][k].gather()[:, :n_p], st2["kv"][k].gather()[:, :n_p]), \
                    f"({tag}) layer {i}'s {k} at the patch positions moved with the text"
        assert not torch.equal(cache[0]["kv"]["k"].gather()[:, n_p:start],
                               cache2[0]["kv"]["k"].gather()[:, n_p:start])
        log(f"[{tag}] every one of the {cfg.n_layers} layers' K and V at the {n_p} patch "
            f"positions equal bit for bit after another prompt ({pre2_s:.3f} s); the text "
            f"positions differ")
        cell = (cell_shape, per_slot_bytes(n, params, batch2),
                [logits2.slot_nbytes(s) + sum(a.slot_nbytes(s) for a in tree_leaves(cache2))
                 for s in range(n)])
        del cache2, batch2, logits2
    del params, batch, cache
    torch.cuda.empty_cache()
    log(f"[{tag}] phase {time.perf_counter() - t_zb:.2f}s")
    return cell


def sharded_side_train(dev, reset_counts, read_counts):
    """(zb3) one sharded train step of each preset in ZB_TRAIN (depth and
    activation dtype; float32 masters and moments) on 2 × 4 slots, batch
    REC_BATCH × ZB_TRAIN_TEXT tokens with the pipeline's frames or patches,
    from seed REC_SEED weights; step 1 held to the one-device
    ``make_train_step`` by (t1)'s bounds."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.utils import tree_leaves

    mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device=dev)
    for arch, (layers, act) in ZB_TRAIN.items():
        t_zb3 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers, dtype=act, n_encoder_layers=(
            layers if full.n_encoder_layers else 0))
        opt_cfg = OptConfig(total_steps=2, warmup_steps=1, moment_dtype=cfg.opt_state_dtype)
        pipe = TokenPipeline(cfg, SHAPES["train_4k"], batch_override=REC_BATCH,
                             seq_override=ZB_TRAIN_TEXT + cfg.n_patches)
        batch = pipe.next_batch(dev)
        side = {k: tuple(v.shape) for k, v in batch.items() if k in ("frames", "patches")}
        ref = lm.init_params(REC_SEED, cfg, device=dev)
        opt = init_opt_state(ref.tree(), opt_cfg)
        (_, ref_m), ref_s = synced(lambda: steps.make_train_step(cfg, opt_cfg)(
            {"params": ref, "opt": opt}, batch))
        del opt
        ref_loss, lr1 = ref_m["loss"].item(), ref_m["lr"].item()
        model = lm.init_params(REC_SEED, cfg, device=dev)
        step, _, (st_sh, _) = steps.build_train(cfg, SHAPES["train_4k"], mesh, opt_cfg)
        state = steps.init_placed_state(model.tree(), opt_cfg, st_sh)
        del model
        torch.cuda.empty_cache()
        reset_counts()
        (state, m), sec = synced(lambda: step(state, batch))
        read_counts(f"(zb3) {arch} sharded train step (no custom kernel on this path)")
        loss = m["loss"].item()
        gap, n_far, n_all = 0.0, 0, 0
        with torch.no_grad():
            for a, r in zip(tree_leaves(state["params"]), tree_leaves(ref.tree())):
                d = (a.gather() - r).abs()
                gap = max(gap, d.max().item())
                n_far += int((d > lr1).sum().item())
                n_all += d.numel()
        n_par = sum(p.numel() for p in ref.parameters())
        log(f"[zb3] {arch}'s width, n_layers cut {full.n_layers} → {cfg.n_layers}"
            f"{f' (the encoder too)' if cfg.n_encoder_layers else ''}, {n_par} parameters, "
            f"{act} activations, batch {REC_BATCH} × {batch['tokens'].shape[1]} tokens with "
            f"{side} on {mesh.sizes[0]} × {mesh.sizes[1]} slots: step 1 loss {loss:.6f} in "
            f"{sec:.3f} s; the one-device step: loss {ref_loss:.6f} in {ref_s:.3f} s; |Δloss| "
            f"{abs(loss - ref_loss):.3e} (≤ {TRAIN_LOSS_TOL}); max |Δmaster| {gap:.3e} (≤ "
            f"2·lr₁ + {SPMD_MASTER_ATOL}), {n_far} of {n_all} ({n_far / n_all:.3e}) apart by "
            f"more than lr₁ (≤ {SPMD_FLIP_SHARE}); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"{time.perf_counter() - t_zb3:.2f} s")
        assert np.isfinite(loss), f"(zb3) {arch}: the loss is not finite"
        assert abs(loss - ref_loss) <= TRAIN_LOSS_TOL, f"(zb3) {arch}: the loss strays"
        assert gap <= 2 * lr1 + SPMD_MASTER_ATOL, f"(zb3) {arch}: a master strays past two steps"
        assert n_far <= SPMD_FLIP_SHARE * n_all, f"(zb3) {arch}: too many masters off one device's"
        del state, ref, batch, step, m
        torch.cuda.empty_cache()


def sharded_side_phase(dev, reset_counts, read_counts):
    """(zb) frames and patches in the slot program on 2 × 4 slots on the
    card: (zb1) whisper_large_v3 at its widths with ZB_LAYERS encoder and
    decoder layers, (zb2) llava_next_mistral_7b with ZB_LAYERS layers, both
    bf16; (zb3) one sharded train step of each; (zb4) the dry run's records
    of (zb1)'s decode cell and (zb2)'s prefill cell on 2 × 4 ``meta`` slots
    beside the card's blocks."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as lm

    t_zb = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[zb] device memory held from earlier phases: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(REC_SEED)
    cells = []
    for tag, arch in (("zb1", "whisper_large_v3"), ("zb2", "llava_next_mistral_7b")):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=ZB_LAYERS, param_dtype="bfloat16",
                                  n_encoder_layers=ZB_LAYERS if full.n_encoder_layers else 0)
        # The reference pipeline's stubs: seeded standard normal frames or
        # CLIP features, and other ones.
        what, shape = (("frames", (REC_BATCH, cfg.encoder_seq, cfg.d_model))
                       if cfg.n_encoder_layers else
                       ("patches", (REC_BATCH, cfg.n_patches, cfg.patch_dim)))
        side, other = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)
                       for _ in range(2))
        model = lm.init_params(REC_SEED, cfg, device=dev)
        cells.append((cfg,) + sharded_side_serve(dev, tag, model, {what: side}, other,
                                                 reset_counts, read_counts))
        del model, side, other
        torch.cuda.empty_cache()
    sharded_side_train(dev, reset_counts, read_counts)
    meta_mesh = make_host_mesh(SPMD_MODEL, slots=SPMD_SLOTS, device="meta")
    for tag, (cfg, shape, card_in, card_out) in zip(("zb1", "zb2"), cells):
        rec = dryrun.record_cell(cfg.name, shape, meta_mesh, cfg=cfg, verbose=False)
        assert rec["ok"], rec.get("traceback")
        ma = rec["memory_analysis"]
        log(f"[zb4] ({tag})'s {shape.kind} cell: dry run traced in {rec['t_lower_s']:.2f} s "
            f"(depths {rec['trace']['depths']}, encoder {rec['trace'].get('encoder_depths')}); "
            f"per slot: arguments {ma['argument_size_in_bytes']} B (on the card {card_in[0]}), "
            f"outputs {ma['output_size_in_bytes']} B (on the card {card_out[0]}); collectives per "
            f"slot {rec['collective_bytes_weighted']} ({rec['collective_counts']} once)")
        assert card_in == [ma["argument_size_in_bytes"]] * SPMD_SLOTS, \
            f"(zb4) ({tag})'s per-slot argument bytes differ from the card's"
        assert card_out == [ma["output_size_in_bytes"]] * SPMD_SLOTS, \
            f"(zb4) ({tag})'s per-slot output bytes differ from the card's"
    log(f"[zb] phase {time.perf_counter() - t_zb:.2f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=5_000_000,
                    help="corpus size |D| (18 dims are never cut)")
    args = ap.parse_args(argv)

    import dataclasses
    import re

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 1

    from repro_torch.core import HybridConfig, refimpl_knn
    from repro_torch.core import brute as brute_lib
    from repro_torch.core import dense_join as dense_lib
    from repro_torch.core import epsilon as eps_lib
    from repro_torch.core import grid as grid_lib
    from repro_torch.core import splitter as split_lib
    from repro_torch.core.hybrid import _pad_ids
    from repro_torch.core.queue import WorkQueue
    from repro_torch.data import pointclouds
    from repro_torch.kernels import _build
    from repro_torch.kernels.bin_hist import kernel as hist_kernel
    from repro_torch.kernels.bin_hist import ops as hist_ops
    from repro_torch.kernels.bin_hist import ref as hist_ref
    from repro_torch.kernels.knn_stream import kernel as stream_kernel
    from repro_torch.kernels.knn_stream import ops as stream_ops
    from repro_torch.kernels.knn_stream import ref as stream_ref
    from repro_torch.kernels.knn_topk import kernel as topk_kernel
    from repro_torch.kernels.knn_topk import ops as topk_ops
    from repro_torch.kernels.knn_topk import ref as topk_ref
    from repro_torch.kernels.pairwise_l2 import kernel as pair_kernel
    from repro_torch.kernels.pairwise_l2 import ref as pair_ref
    from repro_torch.retrieval import normalize_rows
    from repro_torch.retrieval.calibrate import recall_at_k
    from repro_torch.core import distributed
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.runtime import (CheckpointCrash, CrashingCheckpointManager,
                                     DegradationLevel, FaultInjector, KNNIndex, KNNServer,
                                     Rejected, ScriptedFaults, Served, ServerConfig,
                                     ServingConfig, ShardedKNNIndex, VirtualClock,
                                     open_loop_trace)
    from repro_torch.runtime import knn_index as knn_index_mod
    from repro_torch.runtime.knn_index import select_epsilon
    from repro_torch.runtime import mutation as mut_lib
    from repro_torch.utils import pow2_bucket

    torch.backends.cuda.matmul.allow_tf32 = False   # float64 oracle / yardsticks
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    def clock(before):
        """The script's seconds so far, where ``before`` starts: where the
        time limit goes."""
        log(f"[clock] {time.perf_counter() - t_start:.1f}s, {before} next")

    def reset_counts():
        for counter in (stream_kernel.launches, topk_kernel.launches, pair_kernel.launches):
            counter.clear()
        hist_kernel.launches = 0
        stream_ops.oversized_k_reroutes = topk_ops.oversized_k_reroutes = 0

    def read_counts(what, topk_reroutes=0, stream_reroutes=0):
        counts = {**stream_kernel.launches, **topk_kernel.launches,
                  **pair_kernel.launches, "distance_bin_histogram": hist_kernel.launches}
        reroutes = {"knn_stream": stream_ops.oversized_k_reroutes,
                    "knn_topk": topk_ops.oversized_k_reroutes}
        log(json.dumps({"path": what, "launch_counters": counts,
                        "oversized_k_reroutes": reroutes}))
        want = {"knn_stream": stream_reroutes, "knn_topk": topk_reroutes}
        assert reroutes == want, f"{what}: oversized-k reroutes {reroutes}, expected {want}"
        return counts

    def lib_launches():
        """Kernel launches so far per CUDA library (``csrc/<name>.cu``)."""
        return {"knn_stream": sum(stream_kernel.launches.values()),
                "knn_topk": sum(topk_kernel.launches.values()),
                "pairwise_l2": sum(pair_kernel.launches.values()),
                "bin_hist": hist_kernel.launches}

    def kinds_ran(*stats):
        """The engine kinds that queries with these stats ran."""
        return {kind for s in stats for kind, n in (
            ("dense", s.n_dense), ("sparse", s.n_sparse + s.n_failed),
            ("brute", s.n_uncertified)) if n}

    def hold_records(index, ran, queries):
        """The engine buckets' memory records of a clean l2 index
        (``cache_info`` / ``memory_analysis``): each kind that ran holds all
        four fields with temp > 0 and the code bytes of some of the built
        libraries (none for the sparse engine's plain tensor code); then a
        first-bucket query of RECORD_PROBE rows (every operand padded to one
        query block) must leave the caller's peak counter as it was, and
        its records must equal the hand count, their code bytes those of
        the libraries each record's call launched, counted around it."""
        lib = {name: _build._lib_path(name).stat().st_size for name in _build.SOURCES}
        sums = {sum(lib[n] for i, n in enumerate(sorted(lib)) if mask >> i & 1)
                for mask in range(1 << len(lib))}

        def held(mem, kinds):
            assert set(mem) <= ran, f"records {sorted(mem)} for kinds {sorted(ran)} ran"
            for kind in kinds:
                rec = mem[kind]
                assert set(rec) == {"temp_size_in_bytes", "argument_size_in_bytes",
                                    "output_size_in_bytes",
                                    "generated_code_size_in_bytes"}, (kind, rec)
                assert rec["temp_size_in_bytes"] > 0, (kind, rec)
                assert rec["generated_code_size_in_bytes"] in sums, (kind, rec)

        mem = index.memory_analysis()
        log(f"[c] cache_info {json.dumps(index.cache_info())}")
        log(f"[c] memory_analysis {json.dumps(mem)}")
        log(f"[c] seconds the records took, by kind: {json.dumps(index.t_record)}")
        held(mem, set(mem))

        launched_by = {}                 # id(record) -> libraries its call launched
        real_record = knn_index_mod._recorded_call

        def spy(fn, args, kwargs):
            before = lib_launches()
            out, rec, seconds = real_record(fn, args, kwargs)
            after = lib_launches()
            launched_by[id(rec)] = sorted(n for n in after if after[n] != before[n])
            return out, rec, seconds

        qb = index.config.query_block
        peak = torch.cuda.max_memory_allocated()
        knn_index_mod._recorded_call = spy
        try:
            rp = index.query(queries[:RECORD_PROBE])
        finally:
            knn_index_mod._recorded_call = real_record
        assert rp.stats.n_engine_compiles > 0, "the probe opened no engine bucket"
        assert torch.cuda.max_memory_allocated() == peak, \
            "a first-bucket query moved the caller's peak memory counter"
        probe = kinds_ran(rp.stats)
        ran = ran | probe
        mem = index.memory_analysis()
        libs = {kind: launched_by[id(index.executables[kind])] for kind in probe}
        log(f"[c] first-bucket probe ({RECORD_PROBE} rows, libraries by kind {libs}): peak "
            f"counter {peak} B unchanged; records {json.dumps(mem)}")
        held(mem, probe)
        for kind in probe:
            assert mem[kind]["generated_code_size_in_bytes"] == sum(lib[n] for n in libs[kind]), \
                (kind, mem[kind], libs[kind])
        n, d = index.points_r.shape
        m, levels = index.grid.m, len(index.pyramid.levels)
        # A GridIndex holds 2 scalars, 4 (m,), 5 (n,) and one (n, m) 4-byte
        # arrays, the dense grid also the (n, d) sorted points; every engine
        # reads the padded query rows and ids.
        grid = 4 * (2 + 4 * m + 5 * n + n * m)
        rows = qb * d * 4 + qb * 4
        want = {"dense": (grid + n * d * 4 + n * d * 4 + rows + 4, qb * (K * 8 + 9)),
                "sparse": (levels * grid + 4 * levels + n * d * 4 + rows, qb * (K * 8 + 9)),
                "brute": (n * d * 4 + rows, rp.stats.n_uncertified * K * 8)}
        for kind in probe:
            got = (mem[kind]["argument_size_in_bytes"], mem[kind]["output_size_in_bytes"])
            assert got == want[kind], f"{kind} record {got}, hand count {want[kind]}"

    def past_k_calls():
        """Spies that note the k of every knn_topk and gathered-route call:
        each call past the kernels' k must be one counted reroute."""
        return (FirstCall(topk_ops, "knn_topk", note=lambda *a, **kw: kw["k"]),
                FirstCall(stream_ops, "knn_stream_topk_tiles", note=lambda *a, **kw: kw["k"]))

    def past_k(spy):
        return sum(k > topk_kernel.MAX_UNROLLED_K for k in spy.notes)

    def same_as(got, want, queries, corpus, what):
        """Two placements' answers to the same query rows.  A row certified by
        another engine in each placement may carry its distances in another
        fp32 form, so each entry is held to the larger of 2e-6 · (1 + d) (the
        reference's sharded parity bound, on its unit-scale test data) and
        the expansion form's fp32 bound carried to d (``expansion_bound``
        of the query's and the neighbour's norms, min(e / d, √e)); ids are
        equal except where the two ids' float64 distances lie within that
        same allowance or TIE.  ``queries`` holds the query rows, ``corpus``
        every global id's row.  Prints how many rows are bit-identical."""
        n, k = got.ids.shape
        q = queries[:n].double()
        c = corpus[torch.as_tensor(want.ids, device=dev).long()].double()
        e = expansion_bound(q.norm(dim=1)[:, None], c.norm(dim=-1), q.shape[1])
        wd = torch.as_tensor(want.dists, device=dev).double()
        allow = torch.maximum(torch.minimum(e / wd.clamp(min=1e-300), e.sqrt()),
                              2e-6 * (1.0 + wd)).cpu().numpy()
        delta = np.abs(got.dists.astype(np.float64) - want.dists)
        diff = got.ids != want.ids
        bit_rows = int(((~diff) & (got.dists == want.dists)).all(1).sum())
        r, cc = np.nonzero(diff)
        gap = 0.0
        if len(r):
            rt = torch.as_tensor(r, device=dev)
            qa = queries[rt].double()
            a = corpus[torch.as_tensor(got.ids[r, cc], device=dev).long()].double()
            b = corpus[torch.as_tensor(want.ids[r, cc], device=dev).long()].double()
            gaps = ((qa - a).norm(dim=1) - (qa - b).norm(dim=1)).abs().cpu().numpy()
            gap = gaps.max()
            assert (gaps <= np.maximum(allow[r, cc], TIE)).all(), \
                f"{what}: an id differs that is not a distance tie"
        log(f"  {what}: {bit_rows} of {n} rows bit-identical; {len(r)} ids differ (float64 "
            f"distance gap ≤ {gap:.2e}); max |Δd| {delta.max():.3e} (largest |Δd| / allowance "
            f"{(delta / allow).max():.3f}; entries past 2e-6: {int((delta > 2e-6).sum())})")
        assert (delta <= allow).all(), f"{what}: distances differ beyond the allowance"

    # The kernel checks of (a).  topk_check: one knn_topk call against its
    # plain version, which takes the corpus in chunks merged with
    # merge_running_topk as the CPU brute lane does; the library yardstick
    # too, in chunks of 2^30 scores, since the full (Q, |D|) matrix may not
    # fit.  hist_check: one histogram call on the ε selection's own sample
    # and bin width.
    def topk_check(name, q3, c3, qid3, cids, metric, launch_n, fp32_bound=False, k=K):
        kd, ki = topk_ops.knn_topk(q3, c3, qid3, cids, k=k, metric=metric)

        def chunked(topk_of_chunk, chunk):
            run_d = torch.full((q3.shape[0], k), float("inf"), device=dev)
            run_i = torch.full((q3.shape[0], k), -1, dtype=torch.int32, device=dev)
            for c0 in range(0, c3.shape[0], chunk):
                nd, ni = topk_of_chunk(c3[c0:c0 + chunk], cids[c0:c0 + chunk])
                run_d, run_i = topk_ops.merge_running_topk(run_d, run_i, nd, ni, k=k)
            return run_d, run_i

        def library_topk(c, cid):
            score = -(q3 @ c.T) if metric == "ip" else torch.cdist(q3, c)
            vd, vi = torch.topk(score, k, dim=1, largest=False)
            return vd, cid[vi]

        (rd, ri_), plain_ms = timed(lambda: chunked(
            lambda c, cid: topk_ref.knn_topk_ref(q3, c, qid3, cid, k=k, metric=metric), 8192))
        err, _, _ = hold_topk(f"{name} {tuple(q3.shape)} x {tuple(c3.shape)}",
                              c3, q3, kd, ki, rd, ri_, metric=metric, fp32_bound=fp32_bound)
        del kd, ki, rd, ri_
        ms = cuda_ms(lambda: topk_ops.knn_topk(q3, c3, qid3, cids, k=k, metric=metric), reps=3)
        lib_ms = cuda_ms(lambda: chunked(library_topk, (1 << 30) // q3.shape[0]), reps=1)
        d3 = q3.shape[1]
        nbytes = (q3.numel() + c3.numel()) * 4 + (qid3.numel() + cids.numel()) * 4 + q3.shape[0] * k * 8
        b = bound(nbytes, q3.shape[0] * c3.shape[0] * (2 * d3 + (3 if metric == "l2" else 1)))
        log(f"[a] {name}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, library {lib_ms:.3f} ms, "
            f"bound {b[0]:.3f} ms ({b[1]})")
        return kernel_entry(name, TOPK_CU, "src/repro/kernels/knn_topk/kernel.py:119",
                            launch_n, err, ms, plain_ms, b, lib_ms)

    def hist_check(name, q4, p4, qidx, bw, n_bins, launch_n):
        d4 = q4.shape[1]
        kc = hist_ops.distance_bin_histogram(q4, p4, bw, n_bins, self_indices=qidx)
        pid = torch.arange(p4.shape[0], dtype=torch.int32, device=dev)
        rc, plain_ms = timed(lambda: hist_ref.distance_bin_histogram_ref(
            q4, p4, qidx.to(torch.int32), pid, bw, n_bins=n_bins))
        err = hold_hist(f"[a] {name}", kc, rc, q4, p4, qidx, bw, n_bins)
        # Self pairs sit at d = 0: without the exclusion exactly S more in bin 0.
        extra = hist_ops.distance_bin_histogram(q4, p4, bw, n_bins) - kc
        n_self = int((qidx >= 0).sum())
        log(f"[a] {name} self exclusion: bin 0 +{extra[0].item():.0f} "
            f"without it (S={n_self}), other bins +{extra[1:].abs().sum().item():.0f}")
        assert extra[0].item() == n_self and not extra[1:].any(), \
            f"{name}: the self pairs are not excluded from bin 0"
        ms = cuda_ms(lambda: hist_ops.distance_bin_histogram(q4, p4, bw, n_bins,
                                                             self_indices=qidx))
        hi = float(bw) * n_bins
        lib_ms = cuda_ms(lambda: torch.histc(torch.cdist(q4, p4), bins=n_bins, min=0.0, max=hi),
                         reps=3)
        nbytes = (q4.numel() + p4.numel()) * 4 + qidx.numel() * 4 + n_bins * 8
        b = bound(nbytes, q4.shape[0] * p4.shape[0] * (2 * d4 + 5))
        log(f"[a] {name}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, library {lib_ms:.3f} ms, "
            f"bound {b[0]:.3f} ms ({b[1]})")
        return kernel_entry(name, "src/repro_torch/csrc/bin_hist.cu",
                            "src/repro/kernels/bin_hist/kernel.py:80", launch_n, err, ms,
                            plain_ms, b, lib_ms)

    kernels = []

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] nvcc sm_90a, {len(logs)} sources in parallel: "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in sorted(logs.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"  {name}: {len(regs)} kernels, registers {min(regs, default=0)}–"
            f"{max(regs, default=0)}, largest spill store {max(spills, default=0)} B")

    # -- data -------------------------------------------------------------
    t0 = time.perf_counter()
    pts = pointclouds.load("susy", n_override=args.n)
    log(f"[data] susy {pts.shape} in {time.perf_counter() - t0:.1f}s")
    cfg = HybridConfig(k=K, m=6, gamma=0.4, rho=0.2, online_rebalance=False)
    rng = np.random.default_rng(1)
    pts_d = torch.as_tensor(pts, device=dev)
    rows = torch.as_tensor(rng.choice(len(pts), ORACLE_ROWS, replace=False), device=dev)
    rows_np = rows.cpu().numpy()
    foreign = pointclouds.load("susy", n_override=FOREIGN_QUERIES)
    foreign = (foreign + rng.normal(0, 0.01, foreign.shape)).astype(np.float32)
    fq = torch.as_tensor(foreign, device=dev)
    sub = rng.choice(FOREIGN_QUERIES, ORACLE_ROWS, replace=False)

    # -- path 1: (b) build + self-join, (c) R≠S, (d) brute -----------------
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = KNNIndex.build(pts, cfg, device="cuda")
    eps_b = index.eps
    log(f"[b] build {time.perf_counter() - t0:.2f}s: eps={index.eps:.6g} "
        f"t_select_eps={index.t_select_eps:.3f}s t_build={index.t_build:.3f}s "
        f"backend={index.backend}")
    res = index.query(exclude_self=True)
    log(f"[b] self-join: {stats_line(res, len(pts))} sources={np.bincount(res.source, minlength=3).tolist()}")
    check_exact(pts_d, pts_d[rows], rows, res.dists[rows_np], res.ids[rows_np], "self-join")
    self_stats = res.stats
    del res

    r1 = index.query(foreign)
    log(f"[c] R≠S #1: {stats_line(r1, FOREIGN_QUERIES)}")
    r2 = index.query(foreign)
    log(f"[c] R≠S #2: {stats_line(r2, FOREIGN_QUERIES)}")
    assert r2.stats.n_engine_compiles == 0, "steady-state R≠S query added engine buckets"
    check_exact(pts_d, fq[sub], None, r2.dists[sub], r2.ids[sub], "R≠S")
    hold_records(index, kinds_ran(self_stats, r1.stats, r2.stats), foreign)

    brute_rows = torch.cat([rows, torch.as_tensor(
        rng.choice(len(pts), BRUTE_QUERIES - ORACLE_ROWS), device=dev)])
    pr = index.points_r
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bd, bi = brute_lib.brute_knn(pr, pr[brute_rows], brute_rows.to(torch.int32), k=K)
    torch.cuda.synchronize()
    t_brute = time.perf_counter() - t0
    log(f"[d] brute baseline: {BRUTE_QUERIES} queries × {len(pts)} in {t_brute:.2f}s "
        f"({BRUTE_QUERIES / t_brute:.1f} queries/s)")
    check_exact(pts_d, pts_d[rows], rows, torch.sqrt(bd[:ORACLE_ROWS]).cpu().numpy(),
                bi[:ORACLE_ROWS].cpu().numpy(), "brute")
    launches = read_counts("(b)-(d) fused l2")
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("knn_stream_topk_prefetch", "knn_tile_topk", "distance_bin_histogram"):
        assert launches.get(name, 0) > 0, f"main path never launched {name}"

    clock("(e)")

    # -- path 2: (e) the tiled pallas backend on the same points and grid ---
    reset_counts()
    t0 = time.perf_counter()
    index_p = KNNIndex.build(pts, dataclasses.replace(cfg, backend="pallas"), index.eps,
                             device="cuda")
    log(f"[e] build {time.perf_counter() - t0:.2f}s (ε pinned to {index_p.eps:.6g}) "
        f"backend={index_p.backend}")
    res = index_p.query(exclude_self=True)
    log(f"[e] self-join: {stats_line(res, len(pts))} sources={np.bincount(res.source, minlength=3).tolist()}")
    check_exact(pts_d, pts_d[rows], rows, res.dists[rows_np], res.ids[rows_np],
                "pallas self-join")
    del res
    p1 = index_p.query(foreign)
    log(f"[e] R≠S #1: {stats_line(p1, FOREIGN_QUERIES)}")
    p2 = index_p.query(foreign)
    log(f"[e] R≠S #2: {stats_line(p2, FOREIGN_QUERIES)}")
    assert p2.stats.n_engine_compiles == 0, "steady-state pallas R≠S added engine buckets"
    check_exact(pts_d, fq[sub], None, p2.dists[sub], p2.ids[sub], "pallas R≠S")
    launches_p = read_counts("(e) pallas")
    log(f"[e] pairwise_sq_l2 launches: {launches_p.get('pairwise_sq_l2', 0)}")
    assert launches_p.get("pairwise_sq_l2", 0) > 0, "the pallas path never launched pairwise_sq_l2"
    del index_p, p1, p2

    # -- path 3: (g) cosine and ip indexes --------------------------------------
    reset_counts()
    pts_unit = normalize_rows(pts)
    fq_unit = normalize_rows(foreign)
    t0 = time.perf_counter()
    cos_index = KNNIndex.build(pts_unit, dataclasses.replace(cfg, metric="cosine"),
                               device="cuda")
    rc = cos_index.query(fq_unit)
    log(f"[g] cosine build+R≠S {time.perf_counter() - t0:.2f}s eps={cos_index.eps:.6g}: "
        f"{stats_line(rc, FOREIGN_QUERIES)}")
    check_exact(torch.as_tensor(pts_unit, device=dev), torch.as_tensor(fq_unit[sub], device=dev),
                None, rc.dists[sub], rc.ids[sub], "cosine R≠S", "cosine")
    del cos_index, rc, pts_unit
    t0 = time.perf_counter()
    ip_index = KNNIndex.build(pts, dataclasses.replace(cfg, metric="ip"), device="cuda")
    with FirstCall(topk_ops, "knn_topk", lambda *a, **kw: kw.get("metric") == "ip") as ip_call:
        ri = ip_index.query(foreign)
    log(f"[g] ip build+R≠S {time.perf_counter() - t0:.2f}s: t_brute={ri.stats.t_brute:.3f}s "
        f"queries/s={FOREIGN_QUERIES / ri.stats.t_wall:.1f} sources="
        f"{np.bincount(ri.source, minlength=3).tolist()}")
    assert (ri.source == 2).all(), "an ip query left the brute lane"
    check_exact(pts_d, fq[sub], None, ri.dists[sub], ri.ids[sub], "ip R≠S", "ip")
    assert (ri.dists < 0).any(), "ip scores were clamped"
    del ip_index, ri
    launches_g = read_counts("(g) metrics")
    assert launches_g.get("knn_tile_topk[ip]", 0) > 0, "the ip path never launched knn_tile_topk[ip]"

    # -- path 4: (h) bf16 distances ----------------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    bf_cfg = dataclasses.replace(cfg, k=K_BF16, distance_dtype="bf16")
    bf_index = KNNIndex.build(pts, bf_cfg, device="cuda")
    rb = bf_index.query(foreign)
    log(f"[h] bf16 K={K_BF16} build+R≠S {time.perf_counter() - t0:.2f}s eps={bf_index.eps:.6g}: "
        f"{stats_line(rb, FOREIGN_QUERIES)}")
    check_exact(pts_d, fq[sub], None, rb.dists[sub], rb.ids[sub], f"bf16 R≠S K={K_BF16}")
    bf_pr = bf_index.points_r

    def plan(grid, pr_, qids, eps2, k, budget, qb, bc, *route):
        """(tiles, launches at the route's chunk plan) of one gathered-route call."""
        n_t = qids.shape[0] // qb
        return n_t, -(-n_t // dense_lib.tiles_per_chunk(grid, pr_.shape[1], qb, budget, bc))

    with FirstCall(stream_ops, "knn_stream_topk_tiles") as padded_call, \
            FirstCall(dense_lib, "_gathered_join", note=plan) as gathered:
        rb = bf_index.query(foreign, k=K)
    log(f"[h] bf16 K={K} R≠S (gathered fp32 route): {stats_line(rb, FOREIGN_QUERIES)}")
    check_exact(pts_d, fq[sub], None, rb.dists[sub], rb.ids[sub], f"bf16 R≠S K={K}")
    t_dense_h = rb.stats.t_dense
    del rb
    launches_h = read_counts("(h) bf16")
    assert launches_h.get("knn_stream_topk_prefetch[bf16]", 0) > 0, "bf16 kernel never launched"
    n_tiles_h = sum(n for n, _ in gathered.notes)
    n_planned = sum(m for _, m in gathered.notes)
    log(f"[h] K={K} gathered route: t_dense={t_dense_h:.3f}s, {len(gathered.notes)} dense "
        f"calls, {n_tiles_h} tiles, knn_stream_topk_padded launches="
        f"{launches_h.get('knn_stream_topk_padded', 0)} (⌈tiles / tiles-per-chunk⌉ = "
        f"{n_planned})")
    assert launches_h.get("knn_stream_topk_padded", 0) == n_planned > 0, \
        "K=25 bf16 did not launch the padded kernel once per chunk of tiles"

    clock("(i)")

    # -- path 5: (i) FMA end to end at 518 dims ---------------------------------
    # The paper's FMA workload at its published 107,000 × 518: ε selected on
    # the card (the bin_hist kernel at 518 dims), the fused self-join
    # (knn_stream at 518 dims, the brute lane's knn_topk) and the pallas
    # self-join on the same grid (pairwise_sq_l2), each held against float64.
    reset_counts()
    fma = pointclouds.load("fma", n_override=FMA_POINTS)
    fma_d = torch.as_tensor(fma, device=dev)
    # The rows a development draw gave (i) when (j)'s queries were drawn
    # first: a copy of the generator draws (j)'s, then (i)'s, so no other
    # phase's draws move.
    rng_alt = copy.deepcopy(rng)
    rng_alt.choice(len(pts), PAST_QUERIES, replace=False)
    frows_alt = torch.as_tensor(rng_alt.choice(len(fma), ORACLE_ROWS, replace=False), device=dev)
    frows = torch.as_tensor(rng.choice(len(fma), ORACLE_ROWS, replace=False), device=dev)
    frows_np = frows.cpu().numpy()
    t0 = time.perf_counter()
    with FirstCall(hist_ops, "distance_bin_histogram") as fma_hist_call:
        fidx = KNNIndex.build(fma, cfg, device="cuda")
    log(f"[i] FMA {fma.shape} build {time.perf_counter() - t0:.2f}s: eps={fidx.eps:.6g} "
        f"t_select_eps={fidx.t_select_eps:.3f}s t_build={fidx.t_build:.3f}s "
        f"backend={fidx.backend}")
    with FirstCall(topk_ops, "knn_topk") as fma_brute_call:
        res = fidx.query(exclude_self=True)
    log(f"[i] FMA fused self-join: {stats_line(res, len(fma))} "
        f"sources={np.bincount(res.source, minlength=3).tolist()}")
    check_exact(fma_d, fma_d[frows], frows, res.dists[frows_np], res.ids[frows_np],
                "FMA self-join", fp32_bound=True)
    alt_np = frows_alt.cpu().numpy()
    check_exact(fma_d, fma_d[frows_alt], frows_alt, res.dists[alt_np], res.ids[alt_np],
                "FMA self-join, rows of the (j)-first draw", fp32_bound=True)
    t0 = time.perf_counter()
    fidx_p = KNNIndex.build(fma, dataclasses.replace(cfg, backend="pallas"), fidx.eps,
                            device="cuda")
    res = fidx_p.query(exclude_self=True)
    log(f"[i] FMA pallas build+self-join {time.perf_counter() - t0:.2f}s: "
        f"{stats_line(res, len(fma))} sources={np.bincount(res.source, minlength=3).tolist()}")
    check_exact(fma_d, fma_d[frows], frows, res.dists[frows_np], res.ids[frows_np],
                "FMA pallas self-join", fp32_bound=True)
    del res
    launches_i = read_counts("(i) FMA")
    for name in ("distance_bin_histogram", "knn_stream_topk_prefetch", "knn_tile_topk",
                 "pairwise_sq_l2"):
        assert launches_i.get(name, 0) > 0, f"the FMA path never launched {name}"

    # -- path 6: (j) the brute lane at K = 40 > MAX_UNROLLED_K ---------------
    # The corpus streams in corpus_chunk pieces, as the reference streams it;
    # each piece's knn_topk call reroutes to the plain version (as the JAX
    # ops reroute it), so the path launches no kernel.  Its queries are drawn
    # after every other path's rows, which stay as they were before it.
    reset_counts()
    prows = torch.as_tensor(rng.choice(len(pts), PAST_QUERIES, replace=False), device=dev)
    pq, pqid = pts_d[prows].contiguous(), prows.to(torch.int32)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    jd, ji = brute_lib.brute_knn(pts_d, pq, pqid, k=K_PAST, corpus_chunk=PAST_CHUNK)
    torch.cuda.synchronize()
    t_past = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_chunks = -(-len(pts) // PAST_CHUNK)
    log(f"[j] brute K={K_PAST}: {PAST_QUERIES} queries × {len(pts)} in {t_past:.3f}s "
        f"({PAST_QUERIES / t_past:.1f} queries/s), corpus_chunk={PAST_CHUNK} "
        f"({n_chunks} chunks); peak device memory {peak / 2**30:.3f} GiB, "
        f"{(peak - mem0) / 2**20:.1f} MiB above the {mem0 / 2**30:.3f} GiB held before")
    check_exact(pts_d, pq, prows, torch.sqrt(jd), ji, f"brute K={K_PAST}")
    launches_j = read_counts(f"(j) brute K={K_PAST}", topk_reroutes=n_chunks)
    assert not any(launches_j.values()), f"(j) launched a kernel at K={K_PAST}: {launches_j}"
    del jd, ji, pq, pqid

    bq, bc = cfg.query_block, cfg.block_c
    lanes = torch.arange(bc, device=dev)

    def split_ids(idx, k):
        split = split_lib.split_from_counts(torch.as_tensor(idx.home_counts), k,
                                            idx.grid.m, cfg.gamma, cfg.rho)
        to_dense = split.to_dense.numpy()
        return np.nonzero(to_dense)[0], np.nonzero(~to_dense)[0]

    def first_dense_batch(idx, k):
        ids = split_ids(idx, k)[0]
        return WorkQueue(ids, idx.home_counts, cfg.n_batches).next_batch()

    def stream_check(what, ops_in, eps2, k, metric, pr_check, qpts_check, fp32_bound=False):
        """One knn_stream_topk_prefetch variant against its plain version."""
        q_in, corpus, blk, excl, cand = ops_in
        kw = dict(k=k, block_q=bq, block_c=bc, metric=metric)
        kd, ki, kf = stream_kernel.knn_stream_topk_prefetch(*ops_in, eps2, **kw)
        rd, ri_, rf = stream_ref.knn_stream_topk_prefetch_ref(*ops_in, eps2, **kw)
        torch.cuda.synchronize()

        def scored(r):
            t = r // bq
            rr = (blk[t].long()[:, None] * bc + lanes).reshape(-1)
            return corpus[rr][cand[t] >= 0]

        err, _, _ = hold_topk(what, pr_check, qpts_check, kd, ki, rd, ri_, kf, rf, scored,
                              eps2, metric, fp32_bound)
        ms = cuda_ms(lambda: stream_kernel.knn_stream_topk_prefetch(*ops_in, eps2, **kw))
        plain_ms = cuda_ms(lambda: stream_ref.knn_stream_topk_prefetch_ref(*ops_in, eps2, **kw),
                           reps=1, warmup=0)
        n_tiles, nblk = blk.shape
        dim, esize = q_in.shape[1], q_in.element_size()
        touched = torch.unique(blk[(cand.reshape(n_tiles, nblk, -1) >= 0).any(-1)]).numel()
        nbytes = (q_in.numel() * esize + touched * bc * dim * esize + blk.numel() * 4
                  + excl.numel() * 4 + cand.numel() * 4 + kd.numel() * 8 + kf.numel() * 4)
        b = bound(nbytes, int((cand >= 0).sum()) * bq * (2 * dim + 3))
        log(f"[a] {what}: tiles={n_tiles} nblk={nblk} kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
            f"bound {b[0]:.3f} ms ({b[1]})")
        return err, ms, plain_ms, b

    # #1 bf16: the bf16 index's first dense batch, as its engine calls it.
    batch = first_dense_batch(bf_index, K_BF16)
    qp = _pad_ids(batch, bq, dev)
    ops_in, _, _, _ = dense_lib.fused_prefetch_operands(
        bf_index.grid, bf_index.points_r, qp, cfg.dense_budget, bq, bc)
    ops_bf = tuple(x.to(torch.bfloat16) for x in ops_in[:2]) + ops_in[2:]
    eps2 = torch.tensor(bf_index.eps, dtype=torch.float32, device=dev) ** 2
    eps_keep = eps2 + dense_lib.BF16_EPS_SLACK * eps2.abs()
    err, ms, plain_ms, b = stream_check(
        "knn_stream_topk_prefetch[bf16]", ops_bf, eps_keep, K_BF16 + dense_lib.BF16_OVERFETCH,
        "l2", bf_index.points_r.to(torch.bfloat16), ops_bf[0])
    # fp32 operands of the same batch, at the same ε² and k — as they are,
    # and holding the bf16-rounded values — are the yardsticks of the bf16
    # variant's time: the second differs from it only in the loads.

    def fp32_ms(operands):
        return cuda_ms(lambda: stream_kernel.knn_stream_topk_prefetch(
            *operands, eps_keep, k=K_BF16 + dense_lib.BF16_OVERFETCH, block_q=bq, block_c=bc))
    ms32 = fp32_ms(ops_in)
    ms32_rounded = fp32_ms(tuple(x.float() for x in ops_bf[:2]) + ops_bf[2:])
    log(f"[a] knn_stream_topk_prefetch[bf16] vs fp32 operands of the same batch, ε² and k: "
        f"{ms:.3f} ms vs {ms32:.3f} ms (fp32 holding the bf16 values: {ms32_rounded:.3f} ms)")
    kernels.append(kernel_entry("knn_stream_topk_prefetch[bf16]", STREAM_CU,
                                "src/repro/kernels/knn_stream/kernel.py:220",
                                launches_h.get("knn_stream_topk_prefetch[bf16]", 0),
                                err, ms, plain_ms, b, None))
    del bf_index, ops_in, ops_bf

    # -- (f) pallas against fused: on the first dense batch of the 5M index at
    # its ε and budget (the main path's tiles, which all overflow), then on
    # 16,384 sparse-split queries at growing budgets until at least half
    # their tiles fit in both engines, so that found, ids and distances are
    # compared in full on real tiles.
    dim = pr.shape[1]

    def engines_agree(grid, eps, label, ids_np, budget):
        n_b = len(ids_np)
        qp = _pad_ids(ids_np, bq, dev)
        qrows = pr[qp[:n_b].long()]
        kw = dict(k=K, budget=budget, query_block=bq, block_c=bc)
        e = torch.tensor(eps, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        rf_ = dense_lib.dense_join(grid, pr, qp, e, backend="fused", **kw)
        torch.cuda.synchronize()
        t_f = time.perf_counter() - t0
        t0 = time.perf_counter()
        rp_ = dense_lib.dense_join(grid, pr, qp, e, backend="pallas", **kw)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        rf_, rp_ = (type(r)(*(x[:n_b] for x in r)) for r in (rf_, rp_))
        _, _, ovf_f_tile, perm = dense_lib.fused_prefetch_operands(
            grid, pr, qp, budget, bq, bc)
        tiles, perm_p = grid_lib.group_queries_by_cell(grid, qp, bq)
        assert torch.equal(perm, perm_p)
        chunk = dense_lib.tiles_per_chunk(grid, dim, bq, budget, bc)
        ovf_p_tile = torch.cat([
            dense_lib.tiled_candidates(grid, pr, tiles[t0:t0 + chunk], budget, bc)[4]
            for t0 in range(0, tiles.shape[0], chunk)])
        inv = torch.empty_like(perm, dtype=torch.long)
        inv[perm.long()] = torch.arange(perm.numel(), device=dev)
        row_tile = (inv // bq)[:n_b]
        ovf_f, ovf_p = ovf_f_tile[row_tile], ovf_p_tile[row_tile]
        assert torch.equal(rf_.total_candidates, rp_.total_candidates), f"(f) {label}: totals"
        assert not (ovf_p & ~ovf_f).any(), f"(f) {label}: a tiled overflow the fused engine missed"
        frag = ovf_f & ~ovf_p        # block-table fragmentation: fused only
        fit = ~ovf_f
        flips = 0
        if fit.any():
            sel = fit.nonzero()[:, 0]

            def scored(r):
                t = int(row_tile[sel[r]])
                _, cid, cpts, _, _ = dense_lib.tiled_candidates(
                    grid, pr, tiles[t:t + 1], budget, bc)
                return cpts[0][cid[0] >= 0]

            _, _, flips = hold_topk(f"(f) pallas vs fused at {label}", pr, qrows[sel],
                                    rp_.dists[sel], rp_.ids[sel], rf_.dists[sel], rf_.ids[sel],
                                    rp_.found[sel], rf_.found[sel], scored, e ** 2)
            same = (rp_.ids[sel] == rf_.ids[sel]) & torch.isfinite(rf_.dists[sel])
            c = pr[rf_.ids[sel].clamp(min=0).long()].double()
            allow = expansion_bound(qrows[sel].double().norm(dim=1)[:, None],
                                    c.norm(dim=-1), dim)
            gap = (rp_.dists[sel].double() - rf_.dists[sel].double()).abs()
            assert (gap <= allow)[same].all(), f"(f) {label}: distances beyond the fp32 bound"
        bad = (rf_.failed != rp_.failed) & ~frag & (rf_.found == rp_.found)
        assert not bad.any(), f"(f) {label}: failed differs on {int(bad.sum())} rows"
        real = tiles[:, 0] >= 0
        ovf_f_tile, ovf_p_tile = ovf_f_tile[real], ovf_p_tile[real]
        log(f"[f] {label}: {n_b} queries, {int(real.sum())} tiles; fused {t_f:.2f}s "
            f"pallas {t_p:.2f}s; overflowed tiles fused={int(ovf_f_tile.sum())} "
            f"pallas={int(ovf_p_tile.sum())} (fragmentation only: "
            f"{int((ovf_f_tile & ~ovf_p_tile).sum())}); rows compared in full={int(fit.sum())}; "
            f"failed fused={int(rf_.failed.sum())} pallas={int(rp_.failed.sum())}; found "
            f"flips at ε² {flips}")
        return 1.0 - ovf_f_tile.float().mean().item()

    dense_ids, sparse_ids = split_ids(index, K)
    batch = WorkQueue(dense_ids, index.home_counts, cfg.n_batches).next_batch()
    engines_agree(index.grid, index.eps, "ε, first dense batch", batch, cfg.dense_budget)
    for budget in (cfg.dense_budget, 8192, 32768, 131072, 524288):
        share = engines_agree(index.grid, index.eps,
                              f"ε, 16,384 sparse-split queries, budget {budget}",
                              sparse_ids[:16_384], budget)
        if share >= 0.5:
            break
    assert share > 0, "(f) no tile fit the budget: nothing compared in full"
    qp = _pad_ids(batch, bq, dev)

    # -- (a) every kernel against its plain version, on its path's inputs -----
    # #1 knn_stream_topk_prefetch, l2 and ip: the first dense batch's operands.
    ops_in, _, _, _ = dense_lib.fused_prefetch_operands(index.grid, pr, qp, cfg.dense_budget,
                                                        bq, bc)
    qpts = ops_in[0]
    eps2 = torch.tensor(index.eps, dtype=torch.float32, device=dev) ** 2
    for metric in ("l2", "ip"):
        name = stream_kernel.variant("knn_stream_topk_prefetch", metric)
        err, ms, plain_ms, b = stream_check(name, ops_in, eps2, K, metric, pr, qpts)
        kernels.append(kernel_entry(name, STREAM_CU, "src/repro/kernels/knn_stream/kernel.py:220",
                                    launches.get(name, 0), err, ms, plain_ms, b, None))
    corpus, blk = ops_in[1], ops_in[2]
    nblk = blk.shape[1]

    # #2 knn_stream_topk_padded: (h)'s first batched gathered-route launch at
    # K = 25, a chunk of query tiles, each against its own candidate union.
    (q2, c2, qid2, cid2, e2), kw2 = padded_call.args
    n_t2, tq2, _ = q2.shape
    tc2 = c2.shape[1]
    d2 = q2.shape[-1]
    a2 = (q2.reshape(-1, d2), c2, qid2.reshape(-1).contiguous(), cid2, e2)
    kw2 = dict(k=kw2["k"], block_q=tq2, block_c=kw2["block_c"], metric=kw2["metric"])
    table2 = stream_kernel.identity_block_table(n_t2, tc2 // kw2["block_c"], dev)
    kd, ki, kf = stream_kernel.knn_stream_topk_padded(*a2, **kw2)
    rd, ri_, rf = stream_ref.knn_stream_topk_prefetch_ref(
        a2[0], c2.reshape(-1, d2), table2, *a2[2:], **kw2)
    valid2 = cid2 >= 0
    n_valid = int(valid2.sum())
    err, _, _ = hold_topk(f"knn_stream_topk_padded {n_t2} tiles × {tuple(q2.shape[1:])} x "
                          f"{tuple(c2.shape[1:])} ({n_valid} valid candidates), k={kw2['k']}",
                          bf_pr, a2[0], kd, ki, rd, ri_, kf, rf,
                          lambda r: c2[r // tq2][valid2[r // tq2]], e2)
    ms = cuda_ms(lambda: stream_kernel.knn_stream_topk_padded(*a2, **kw2), reps=20)
    plain_ms = cuda_ms(lambda: stream_ref.knn_stream_topk_prefetch_ref(
        a2[0], c2.reshape(-1, d2), table2, *a2[2:], **kw2), reps=1, warmup=0)
    nbytes = ((q2.numel() + c2.numel()) * 4 + (qid2.numel() + cid2.numel()) * 4
              + kd.numel() * 8 + kf.numel() * 4)
    b = bound(nbytes, tq2 * n_valid * (2 * d2 + 3))
    log(f"[a] knn_stream_topk_padded: kernel {ms:.4f} ms for {n_t2} tiles "
        f"({ms / n_t2:.5f} ms a tile), plain {plain_ms:.3f} ms, bound {b[0]:.5f} ms ({b[1]})")
    kernels.append(kernel_entry("knn_stream_topk_padded", STREAM_CU,
                                "src/repro/kernels/knn_stream/kernel.py:275",
                                launches_h.get("knn_stream_topk_padded", 0), err, ms, plain_ms,
                                b, None))
    del a2, q2, c2, bf_pr, padded_call, table2

    # #3 knn_tile_topk, l2 on the brute baseline's own call (4096 queries),
    # ip on (g)'s own brute-lane call (all 65,536 R≠S queries) and l2 on (i)'s
    # FMA brute-lane call: each against its whole corpus in one launch.
    cid3 = torch.arange(len(pts), dtype=torch.int32, device=dev)
    kernels.append(topk_check("knn_tile_topk", pr[brute_rows].contiguous(),
                              pr, brute_rows.to(torch.int32), cid3, "l2",
                              launches.get("knn_tile_topk", 0)))
    (q3_ip, c3_ip, qid3_ip, cid3_ip), _ = ip_call.args
    kernels.append(topk_check("knn_tile_topk[ip]", q3_ip, c3_ip, qid3_ip, cid3_ip, "ip",
                              launches_g.get("knn_tile_topk[ip]", 0)))
    del q3_ip, c3_ip, qid3_ip, cid3_ip, ip_call, cid3

    # #4 distance_bin_histogram: the ε selection's own sample and bin width.
    n_q = min(cfg.n_query_sample, len(pts))
    ia, ib, qidx = eps_lib.sample_indices(len(pts), cfg.seed, n_pair_sample=cfg.n_pair_sample,
                                          n_query_sample=n_q, device=dev)
    bw = eps_lib.mean_pair_distance(pr, ia, ib) / cfg.n_bins
    kernels.append(hist_check("distance_bin_histogram", pr[qidx].contiguous(), pr, qidx, bw,
                              cfg.n_bins, launches["distance_bin_histogram"]))

    # #5 pairwise_sq_l2: one chunk of phase (e)'s tiles (the same grid, so the
    # same tiles), with the runtime-ε² SHORTC the tiled engine uses; then at
    # FMA width, where 518 dims make 5 d-chunks and SHORTC can skip.
    def pairwise_check(what, qpts5, cpts5, shortc, metric="l2", timing=True):
        t = qpts5.shape[0]
        shape = (t, qpts5.shape[1] // bq, cpts5.shape[1] // bc)
        ck = torch.zeros(shape, dtype=torch.int32, device=dev)
        cr = torch.zeros(shape, dtype=torch.int32, device=dev)
        kw = dict(block_q=bq, block_c=bc, metric=metric)
        got = pair_kernel.pairwise_sq_l2(qpts5, cpts5, shortc, chunks_out=ck, **kw)
        want = pair_ref.pairwise_sq_l2_matmul_ref(qpts5, cpts5, shortc_eps2=shortc,
                                                  chunks_out=cr, **kw)
        torch.cuda.synchronize()
        err, skipped = hold_pairwise(what, got, want, qpts5, cpts5, ck, cr, shortc, bq, bc)
        del got, want
        if not timing:
            return err, skipped
        ms = cuda_ms(lambda: pair_kernel.pairwise_sq_l2(qpts5, cpts5, shortc, **kw))
        plain_ms = cuda_ms(lambda: pair_ref.pairwise_sq_l2_matmul_ref(
            qpts5, cpts5, shortc_eps2=shortc, **kw), reps=1, warmup=0)
        if metric == "ip":
            lib_ms = cuda_ms(lambda: -torch.bmm(qpts5, cpts5.transpose(1, 2)))
        else:
            lib_ms = cuda_ms(lambda: torch.cdist(qpts5, cpts5).square())
        b = pairwise_bound(qpts5, cpts5, ck, bq, bc)
        log(f"[a] {what}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, "
            f"bound {b[0]:.3f} ms ({b[1]})")
        return err, skipped, ms, plain_ms, lib_ms, b

    tiles, _ = grid_lib.group_queries_by_cell(index.grid, qp, bq)
    chunk = dense_lib.tiles_per_chunk(index.grid, dim, bq, cfg.dense_budget, bc)
    qpts5, _, cpts5, _, _ = dense_lib.tiled_candidates(index.grid, pr, tiles[:chunk],
                                                      cfg.dense_budget, bc)
    err, _, ms, plain_ms, lib_ms, b = pairwise_check(
        f"pairwise_sq_l2 (e) tiles, D={dim}", qpts5, cpts5, eps2)
    kernels.append(kernel_entry("pairwise_sq_l2", PAIRWISE_CU,
                                "src/repro/kernels/pairwise_l2/kernel.py:151",
                                launches_p.get("pairwise_sq_l2", 0), err, ms, plain_ms, b, lib_ms))
    del qpts5, cpts5, tiles, pr

    # -- (a) at FMA width, on (i)'s own inputs ----------------------------------
    fpr = fidx.points_r
    fdim = fpr.shape[1]
    # knn_stream_topk_prefetch at 518 dims: the fused index's first dense batch.
    fb = first_dense_batch(fidx, K)
    fops, _, _, _ = dense_lib.fused_prefetch_operands(
        fidx.grid, fpr, _pad_ids(fb, bq, dev), cfg.dense_budget, bq, bc)
    eps2_f = torch.tensor(fidx.eps, dtype=torch.float32, device=dev) ** 2
    err, ms, plain_ms, b = stream_check(
        f"knn_stream_topk_prefetch FMA first dense batch, D={fdim}", fops, eps2_f, K, "l2",
        fpr, fops[0], fp32_bound=True)
    kernels.append(kernel_entry("knn_stream_topk_prefetch (FMA width)", STREAM_CU,
                                "src/repro/kernels/knn_stream/kernel.py:220",
                                launches_i.get("knn_stream_topk_prefetch", 0), err, ms,
                                plain_ms, b, None))
    del fops
    # knn_tile_topk at 518 dims: (i)'s brute-lane call.
    (q3f, c3f, qid3f, cid3f), _ = fma_brute_call.args
    kernels.append(topk_check("knn_tile_topk (FMA width)", q3f, c3f, qid3f, cid3f, "l2",
                              launches_i.get("knn_tile_topk", 0), fp32_bound=True))
    del q3f, c3f, qid3f, cid3f, fma_brute_call
    # distance_bin_histogram at 518 dims: (i)'s ε selection call.
    (q4f, p4f, bwf, nbf), kw4f = fma_hist_call.args
    kernels.append(hist_check("distance_bin_histogram (FMA width)", q4f, p4f,
                              kw4f["self_indices"], bwf, nbf,
                              launches_i["distance_bin_histogram"]))
    del q4f, p4f, fma_hist_call

    # pairwise_sq_l2 at 518 dims: one chunk of the pallas index's first dense
    # batch (5 d-chunks).
    fb = first_dense_batch(fidx_p, K)
    ftiles, _ = grid_lib.group_queries_by_cell(fidx_p.grid, _pad_ids(fb, bq, dev), bq)
    chunk = dense_lib.tiles_per_chunk(fidx_p.grid, fdim, bq, cfg.dense_budget, bc)
    log(f"[a] FMA first dense batch: {len(fb)} queries, {ftiles.shape[0]} tiles; "
        f"{chunk} tiles per launch at this width")
    fq5, _, fc5, _, _ = dense_lib.tiled_candidates(fidx_p.grid, fidx_p.points_r, ftiles[:chunk],
                                                  cfg.dense_budget, bc)
    err, skipped, ms, plain_ms, lib_ms, b = pairwise_check(
        f"pairwise_sq_l2 FMA self-join tiles, D={fdim}, ε²={eps2_f.item():.6g}",
        fq5, fc5, eps2_f)
    kernels.append(kernel_entry("pairwise_sq_l2 (FMA width)", PAIRWISE_CU,
                                "src/repro/kernels/pairwise_l2/kernel.py:151",
                                launches_i.get("pairwise_sq_l2", 0), err, ms, plain_ms, b,
                                lib_ms))
    err, _, ms, plain_ms, lib_ms, b = pairwise_check(
        f"pairwise_sq_l2[ip] FMA self-join tiles, D={fdim}", fq5, fc5, None, "ip")
    kernels.append(kernel_entry("pairwise_sq_l2[ip]", PAIRWISE_CU,
                                "src/repro/kernels/pairwise_l2/kernel.py:151",
                                launches_p.get("pairwise_sq_l2[ip]", 0), err, ms, plain_ms, b,
                                lib_ms))
    # R≠S tiles of an FMA cloud drawn with another seed: its queries lie far
    # from the indexed clusters, so whole tiles exceed ε² after a chunk.
    fma_q = pointclouds.load("fma", seed=1, n_override=FMA_POINTS)
    qr = torch.as_tensor(fma_q, device=dev)[:, fidx_p.dim_perm].contiguous()
    qcoords = grid_lib.compute_cell_coords(fidx_p.grid, qr[:, : fidx_p.grid.m])
    qids = _pad_ids(np.arange(len(fma_q), dtype=np.int32), bq, dev)
    rtiles, _ = grid_lib.group_queries_by_cell(fidx_p.grid, qids, bq, qcoords)
    rq5, _, rc5, _, _ = dense_lib.tiled_candidates(fidx_p.grid, fidx_p.points_r, rtiles[:chunk],
                                                  cfg.dense_budget, bc, qr, qcoords)
    scale = 1.0
    while True:
        e2 = eps2_f * scale
        _, skip_r = pairwise_check(
            f"pairwise_sq_l2 FMA R≠S tiles, ε²={e2.item():.6g} (FMA ε² × {scale:g})",
            rq5, rc5, e2, timing=False)
        if skipped + skip_r > 0 or scale < 4.0 ** -6:
            break
        scale /= 4
    assert skipped + skip_r > 0, "SHORTC never skipped a tile at FMA width"

    clock("(k)")

    # -- path 7: (k) the mutable, durable SuSy index -------------------------
    # (b)'s fused index (ε selected, so compact() selects it anew on the net
    # corpus): inserts, deletes of base and inserted ids, the R≠S batch at
    # K_MUT through the delta buffer and the fold, a save / load round trip
    # and a compaction, each held bit-identical to what it must equal.
    del fidx_p
    reset_counts()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_k = time.perf_counter()
    n_base = len(pts)
    ins = (pointclouds.load("susy", n_override=N_INSERT)
           + rng.normal(0, 0.01, (N_INSERT, pts.shape[1]))).astype(np.float32)
    t0 = time.perf_counter()
    gids = index.insert(ins)
    t_ins = time.perf_counter() - t0
    # The base ids deleted are nearest neighbours (c) returned, so the fold
    # must mask them; the inserted ids are the first inserted rows.
    base_del = np.unique(r2.ids[sub, 0])[:N_DELETE]
    t0 = time.perf_counter()
    deleted = np.concatenate([base_del, gids[:N_DELETE]])
    index.delete(deleted)
    t_del = time.perf_counter() - t0
    assert index.n_points == n_base + N_INSERT - 2 * N_DELETE and not index.is_clean
    with FirstCall(mut_lib, "delta_topk",
                   count=lambda: topk_kernel.launches["knn_tile_topk"]) as delta_call:
        t0 = time.perf_counter()
        rk = index.query(foreign, k=K_MUT)
        t_q = time.perf_counter() - t0
        k_main = K_MUT + mut_lib.headroom_bucket(N_DELETE, False)
        log(f"[k] mutated R≠S K={K_MUT} (k_main={k_main}): {stats_line(rk, FOREIGN_QUERIES)} "
            f"t_delta={rk.stats.t_delta:.3f}s in {t_q:.3f}s; engine buckets "
            f"{index.compile_counts}; entries from the delta buffer "
            f"{int((rk.ids >= n_base).sum())}")
        assert "delta" in index.compile_counts and "merge" in index.compile_counts, \
            "(k) the delta and merge engines did not run"
        # The net corpus, built here from what was inserted and deleted.
        live = np.ones(n_base + N_INSERT, bool)
        live[deleted] = False
        net_gids = np.flatnonzero(live)
        net_d = torch.cat([pts_d, torch.as_tensor(ins, device=dev)])[torch.as_tensor(live, device=dev)]
        pos = np.searchsorted(net_gids, rk.ids[sub])
        assert (net_gids[np.clip(pos, 0, len(net_gids) - 1)] == rk.ids[sub]).all(), \
            "(k) a returned id is not live"
        check_exact(net_d, fq[sub], None, rk.dists[sub], pos, f"mutated R≠S K={K_MUT}")
        del net_d
        with tempfile.TemporaryDirectory() as ckpt:
            t0 = time.perf_counter()
            step = index.save(ckpt)
            t_save = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(ckpt) for f in fs)
            t0 = time.perf_counter()
            loaded = KNNIndex.load(ckpt, device="cuda")
            t_load = time.perf_counter() - t0
        rl = loaded.query(foreign, k=K_MUT)
        assert not loaded.is_clean and np.array_equal(rl.ids, rk.ids) \
            and np.array_equal(rl.dists, rk.dists), "(k) the loaded index answers differently"
        del loaded, rl
    log(f"[k] insert {N_INSERT} {t_ins:.3f}s, delete {2 * N_DELETE} {t_del:.3f}s, save step "
        f"{step} {t_save:.3f}s ({size / 2**20:.1f} MiB on disk), load {t_load:.3f}s; the loaded "
        f"index's answers are bit-identical")
    net_pts = index.net_points()
    t0 = time.perf_counter()
    remap = index.compact()
    t_compact = time.perf_counter() - t0
    assert index.is_clean and (remap[base_del] == -1).all()
    rc = index.query(foreign, k=K_MUT)
    fresh = KNNIndex.build(net_pts, cfg, None, device="cuda")
    rf = fresh.query(foreign, k=K_MUT)
    assert np.array_equal(rc.ids, rf.ids) and np.array_equal(rc.dists, rf.dists), \
        "(k) the compacted index differs from a fresh build on net_points()"
    moved = int((rc.ids != remap[rk.ids]).sum())
    peak = torch.cuda.max_memory_allocated()
    log(f"[k] compact {t_compact:.3f}s (ε selected anew: {index.eps:.6g}, "
        f"t_select_eps={index.t_select_eps:.3f}s t_build={index.t_build:.3f}s); the compacted "
        f"index's answers equal a fresh build's bit for bit ({moved} of {rc.ids.size} entries "
        f"name another id than the remapped dirty answer); phase {time.perf_counter() - t_k:.2f}s, "
        f"peak device memory {peak / 2**30:.3f} GiB ({(peak - mem0) / 2**20:.1f} MiB above the "
        f"{mem0 / 2**30:.3f} GiB held before)")
    del fresh, rc, rf, net_pts
    launches_k = read_counts("(k) mutable index")
    log(f"[k] knn_tile_topk launches inside delta_topk: {delta_call.counted}")
    assert delta_call.counted > 0, "(k) the delta buffer never launched knn_tile_topk"
    for name in ("knn_tile_topk", "distance_bin_histogram"):
        assert launches_k.get(name, 0) > 0, f"(k) never launched {name}"
    (q6, c6, excl6, gid6), kw6 = delta_call.args
    local6 = torch.where(gid6 >= 0, torch.arange(len(gid6), device=dev, dtype=torch.int32),
                         gid6)
    kernels.append(topk_check("knn_tile_topk (delta buffer)", q6, c6, excl6, local6, "l2",
                              delta_call.counted, k=kw6["k"]))
    del q6, c6, excl6, gid6, local6, delta_call, index

    # -- path 8: (l) refimpl_knn on FMA, four simulated ranks ------------------
    reset_counts()
    t0 = time.perf_counter()
    rres, rank_times = refimpl_knn(fma, K, cfg, n_ranks=REFIMPL_RANKS, device="cuda")
    t_ref = time.perf_counter() - t0
    log(f"[l] refimpl FMA {fma.shape}, {REFIMPL_RANKS} ranks in {t_ref:.3f}s: eps="
        f"{rres.stats.epsilon:.6g}, rank times {[round(t, 4) for t in rank_times]} s, "
        f"Σt / max t = {sum(rank_times) / max(rank_times):.3f}")
    check_exact(fma_d, fma_d[frows], frows, rres.dists[frows_np], rres.ids[frows_np],
                "refimpl FMA", fp32_bound=True)
    launches_l = read_counts("(l) refimpl")
    for name in ("knn_tile_topk", "distance_bin_histogram"):
        assert launches_l.get(name, 0) > 0, f"(l) never launched {name}"
    del rres

    # -- path 9: (m) the projection front stage on FMA -----------------------
    # The first 102,904 rows are the corpus; the last 4,096 are foreign
    # queries that calibration never samples.  Each run serves its rung, or
    # exact full-dimension brute where no rung met the target on the
    # held-out sample (the reference's contract).
    del fidx
    n_corpus = FMA_POINTS - PROJ_QUERIES
    corpus_m, fq_m = fma[:n_corpus], fma[n_corpus:]
    corpus_md, fq_md = fma_d[:n_corpus], fma_d[n_corpus:]
    mrows = torch.as_tensor(rng.choice(n_corpus, ORACLE_ROWS, replace=False), device=dev)
    mrows_np = mrows.cpu().numpy()
    cfg_m = HybridConfig(k=K_PROJ, m=6, gamma=0.4, rho=0.2, online_rebalance=False,
                         projection_dim=PROJ_DIM, projection_kind="pca", recall_target=0.9)

    def check_scores(points, queries, ids, dists, metric, what):
        """Each reported distance against the float64 true-metric score of
        its returned id: within 1e-4 · scale, or the expansion form's fp32
        bound carried to the distance where that is larger (the
        full-dimension brute scores through knn_tile_topk)."""
        gi = torch.as_tensor(ids, device=dev).long()
        assert (gi >= 0).all(), f"{what}: missing neighbours"
        q, c = queries.double(), points[gi].double()
        if metric == "ip":
            want = -(c * q[:, None, :]).sum(-1)
        else:
            want = ((c - q[:, None, :]) ** 2).sum(-1).sqrt()
        e = expansion_bound(q.norm(dim=1)[:, None], c.norm(dim=-1), q.shape[1])
        carried = e if metric == "ip" else torch.minimum(e / want.clamp(min=1e-300), e.sqrt())
        tol = torch.maximum(carried, torch.full_like(e, 1e-4 * max(1.0, want.abs().max().item())))
        err = (torch.as_tensor(dists, device=dev).double() - want).abs()
        log(f"  {what}: {gi.shape[0]} rows, max |d − score64(id)| {err.max().item():.3e}, "
            f"largest error / tolerance {(err / tol).max().item():.3f}")
        assert (err <= tol).all(), f"{what}: a distance is not its id's score"

    def serve_projected(what, idx, queries, q_d, metric, target, exclude_self=False):
        """One projected run: serve, measure recall against float64, check
        the served branch, repeat (no new bucket, same answer)."""
        t0 = time.perf_counter()
        res = idx.query(queries, exclude_self=exclude_self)
        t_call = time.perf_counter() - t0
        cm, est = idx._live[0].calib[("proj", K_PROJ, target)]
        if exclude_self:
            sel, qids, q_rows = mrows_np, mrows, corpus_md[mrows]
        else:
            sel, qids, q_rows = np.arange(len(queries)), None, q_d
        _, oi = oracle64(corpus_md, q_rows, qids, K_PROJ, metric)
        rec = recall_at_k(res.ids[sel], oi.cpu().numpy())
        branch = (f"cand_mult={cm} (k_cand={cm * K_PROJ})" if cm is not None
                  else "full-dim brute (no rung met the target)")
        s = res.stats
        log(f"[m] {what}: {branch}; recall_estimate={res.recall_estimate:.4f}; recall@{K_PROJ} "
            f"vs float64 over {len(sel)} queries {rec:.4f}; t_wall={s.t_wall:.3f}s "
            f"t_merge (rescore)={s.t_merge:.4f}s in {t_call:.3f}s; n_dense={s.n_dense} "
            f"n_sparse={s.n_sparse} n_failed={s.n_failed} n_uncertified={s.n_uncertified} "
            f"sources={np.bincount(res.source, minlength=3).tolist()} "
            f"n_engine_compiles={s.n_engine_compiles}")
        if cm is None:
            assert res.recall_estimate == 1.0
            check_exact(corpus_md, q_rows, qids, res.dists[sel], res.ids[sel], f"(m) {what}",
                        metric, fp32_bound=True)
        else:
            assert rec >= target - 0.01, f"(m) {what}: recall {rec:.4f} below {target} − 0.01"
            check_scores(corpus_md, q_rows, res.ids[sel], res.dists[sel], metric, f"(m) {what}")
        counts = dict(idx.compile_counts)
        again = idx.query(queries, exclude_self=exclude_self)
        assert again.stats.n_engine_compiles == 0 and idx.compile_counts == counts, \
            f"(m) {what}: the repeat added engine buckets"
        assert again.recall_estimate == res.recall_estimate
        assert np.array_equal(again.ids, res.ids) and np.array_equal(again.dists, res.dists)
        return res

    reset_counts()
    t_m = time.perf_counter()
    topk_k, tiles_k = past_k_calls()
    with topk_k, tiles_k, \
            FirstCall(hist_ops, "distance_bin_histogram") as m_hist_call, \
            FirstCall(stream_ops, "knn_stream_topk_prefetch",
                      lambda *a, **kw: a[0].shape[1] == PROJ_DIM) as m_stream_call, \
            FirstCall(topk_ops, "knn_topk", lambda *a, **kw: a[0].shape[1] == PROJ_DIM
                      and kw["k"] <= topk_kernel.MAX_UNROLLED_K) as m_topk6_call, \
            FirstCall(topk_ops, "knn_topk", lambda *a, **kw: kw.get("metric") == "ip"
                      and a[0].shape[0] >= PROJ_QUERIES) as m_ip_call:
        t0 = time.perf_counter()
        pidx = KNNIndex.build(corpus_m, cfg_m, device="cuda")
        log(f"[m] FMA {corpus_m.shape} projected build {time.perf_counter() - t0:.2f}s: PCA fit + "
            f"projection {pidx.t_project:.3f}s, projected eps={pidx.eps:.6g} "
            f"t_select_eps={pidx.t_select_eps:.3f}s t_build={pidx.t_build:.3f}s, "
            f"grid m={pidx.grid.m}")
        rm = serve_projected("l2 R≠S, recall_target=0.9", pidx, fq_m, fq_md, "l2", 0.9)
        with tempfile.TemporaryDirectory() as ckpt:
            t0 = time.perf_counter()
            pidx.save(ckpt)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            ploaded = KNNIndex.load(ckpt, device="cuda")
            t_load = time.perf_counter() - t0
        rl = ploaded.query(fq_m)
        assert np.array_equal(ploaded.projection.matrix, pidx.projection.matrix)
        assert np.array_equal(rl.ids, rm.ids) and np.array_equal(rl.dists, rm.dists) \
            and rl.recall_estimate == rm.recall_estimate, "(m) the loaded index answers differently"
        log(f"[m] save {t_save:.3f}s, load {t_load:.3f}s: the loaded projected index's answers "
            f"are bit-identical")
        del ploaded, rl
        pidx1 = KNNIndex.build(corpus_m, dataclasses.replace(cfg_m, recall_target=1.0), pidx.eps,
                               device="cuda")
        serve_projected("l2 R≠S, recall_target=1.0", pidx1, fq_m, fq_md, "l2", 1.0)
        del pidx1
        t0 = time.perf_counter()
        pidx_ip = KNNIndex.build(corpus_m, dataclasses.replace(cfg_m, metric="ip"), device="cuda")
        log(f"[m] ip (MIPS fit, mips_m={pidx_ip.projection.mips_m:.6g}) build "
            f"{time.perf_counter() - t0:.2f}s: projected eps={pidx_ip.eps:.6g}")
        serve_projected("ip R≠S, recall_target=0.9", pidx_ip, fq_m, fq_md, "ip", 0.9)
        del pidx_ip
        serve_projected("l2 self-join, recall_target=0.9", pidx, None, None, "l2", 0.9,
                        exclude_self=True)
    launches_m = read_counts("(m) projection front stage", topk_reroutes=past_k(topk_k),
                             stream_reroutes=past_k(tiles_k))
    log(f"[m] phase {time.perf_counter() - t_m:.2f}s; knn_topk calls at k > "
        f"{topk_kernel.MAX_UNROLLED_K}: {past_k(topk_k)}, gathered-route calls: {past_k(tiles_k)}")
    for name in ("knn_stream_topk_prefetch", "knn_tile_topk", "knn_tile_topk[ip]",
                 "distance_bin_histogram"):
        assert launches_m.get(name, 0) > 0, f"(m) never launched {name}"

    # -- (a) the shapes (m) launched -------------------------------------------
    (q1m, c1m, blk1m, qid1m, cand1m, e1m), kw1m = m_stream_call.args
    err, ms, plain_ms, b = stream_check(
        f"knn_stream_topk_prefetch projected FMA, D={PROJ_DIM}, k={kw1m['k']}",
        (q1m, c1m, blk1m, qid1m, cand1m), e1m, kw1m["k"], "l2", pidx.points_r, q1m)
    kernels.append(kernel_entry("knn_stream_topk_prefetch (projected, D=6)", STREAM_CU,
                                "src/repro/kernels/knn_stream/kernel.py:220",
                                launches_m.get("knn_stream_topk_prefetch", 0), err, ms,
                                plain_ms, b, None))
    (q3m, c3m, qid3m, cid3m), kw3m = m_topk6_call.args
    kernels.append(topk_check(f"knn_tile_topk projected brute lane, D={PROJ_DIM}", q3m, c3m,
                              qid3m, cid3m, "l2", launches_m.get("knn_tile_topk", 0),
                              k=kw3m["k"]))
    (q3i, c3i, qid3i, cid3i), kw3i = m_ip_call.args
    kernels.append(topk_check("knn_tile_topk[ip] (FMA width, projected index's full-dim brute)",
                              q3i, c3i, qid3i, cid3i, "ip",
                              launches_m.get("knn_tile_topk[ip]", 0), fp32_bound=True,
                              k=kw3i["k"]))
    (q4m, p4m, bwm, nbm), kw4m = m_hist_call.args
    kernels.append(hist_check(f"distance_bin_histogram projected FMA, D={PROJ_DIM}", q4m, p4m,
                              kw4m["self_indices"], bwm, nbm,
                              launches_m["distance_bin_histogram"]))
    del pidx, m_stream_call, m_topk6_call, m_ip_call, m_hist_call, q1m, c1m, q3m, c3m, q3i, c3i
    del q4m, p4m

    # -- path 10: (n) the grid lean pass on SuSy ---------------------------------
    # (b)'s points with (b)'s ε pinned (the same grid) at recall_target=0.9
    # serve (c)'s batch; an index at recall_target=1.0 must answer as (c).
    reset_counts()
    t_n = time.perf_counter()
    topk_k, tiles_k = past_k_calls()
    with topk_k, tiles_k:
        t0 = time.perf_counter()
        lean = KNNIndex.build(pts, dataclasses.replace(cfg, recall_target=0.9), eps_b,
                              device="cuda")
        t_lean_build = time.perf_counter() - t0
        rn = lean.query(foreign)
        scale, est = lean._live[0].calib[("grid", K, 0.9)]
        _, oi = oracle64(pts_d, fq[sub], None, K)
        rec = recall_at_k(rn.ids[sub], oi.cpu().numpy())
        log(f"[n] lean index build {t_lean_build:.2f}s (ε pinned to (b)'s {eps_b:.6g}); R≠S "
            f"{FOREIGN_QUERIES} queries: "
            + (f"eps_scale={scale}" if scale is not None
               else "exact fallback (no lean tier met 0.9)")
            + f", recall_estimate={rn.recall_estimate:.4f}, recall@{K} on {ORACLE_ROWS} rows vs "
            f"float64 {rec:.4f}; {stats_line(rn, FOREIGN_QUERIES)} (c): t_wall="
            f"{r2.stats.t_wall:.3f}s")
        if scale is None:
            assert np.array_equal(rn.ids, r2.ids) and np.array_equal(rn.dists, r2.dists), \
                "(n) the exact fallback differs from (c)"
        else:
            assert rec >= 0.9 - 0.01, f"(n) lean recall {rec:.4f} below 0.89"
            check_scores(pts_d, fq[sub], rn.ids[sub], rn.dists[sub], "l2", "(n) lean R≠S")
        again = lean.query(foreign)
        assert again.stats.n_engine_compiles == 0 and again.recall_estimate == rn.recall_estimate
        assert np.array_equal(again.ids, rn.ids) and np.array_equal(again.dists, rn.dists)
        del lean, rn, again
        exact1 = KNNIndex.build(pts, dataclasses.replace(cfg, recall_target=1.0), eps_b,
                                device="cuda")
        re1 = exact1.query(foreign)
        assert np.array_equal(re1.ids, r2.ids) and np.array_equal(re1.dists, r2.dists) \
            and re1.recall_estimate == 1.0, "(n) recall_target=1.0 differs from (c)"
        log(f"[n] recall_target=1.0 index: bit-identical to (c); t_wall={re1.stats.t_wall:.3f}s")
        del exact1, re1
    read_counts("(n) lean pass", topk_reroutes=past_k(topk_k), stream_reroutes=past_k(tiles_k))
    log(f"[n] phase {time.perf_counter() - t_n:.2f}s")

    clock("(o)")

    # -- path 11: (o) the serving front end on SuSy ------------------------------
    # A clean index over (b)'s points with (b)'s ε pinned ((k) mutated and
    # compacted (b)'s index); single-query arrivals are (c)'s first 2,048
    # rows.  Capacity is measured as benchmarks/overload.py measures it: the
    # 128- and 256-row buckets warmed, each one's best of three probes.
    reset_counts()
    t_o = time.perf_counter()
    t0 = time.perf_counter()
    sidx = KNNIndex.build(pts, cfg, eps_b, device="cuda")
    log(f"[o] clean index build {time.perf_counter() - t0:.2f}s (ε pinned to (b)'s {eps_b:.6g})")
    qb = cfg.query_block
    arrivals = foreign[:SERVE_REQUESTS]
    spare = foreign[SERVE_REQUESTS:]
    # The 128-row warm-up's brute and dense calls are the micro-batch shapes
    # held against their plain versions after the phase.
    with FirstCall(topk_ops, "knn_topk") as o_topk_call, \
            FirstCall(stream_ops, "knn_stream_topk_prefetch") as o_stream_call:
        sidx.query(spare[:qb])
    sidx.query(spare[:SERVE_MAX_BATCH])
    per_row_by_bucket = {}
    for size in (qb, SERVE_MAX_BATCH):
        probe = spare[SERVE_MAX_BATCH:SERVE_MAX_BATCH + size]
        probes = []
        for _ in range(3):
            t0 = time.perf_counter()
            res_probe = sidx.query(probe.copy())
            probes.append(time.perf_counter() - t0)
        per_row_by_bucket[size] = min(probes) / size
        log(f"[o] {size}-row probes {[round(t, 6) for t in probes]} s: per_row "
            f"{per_row_by_bucket[size] * 1e6:.3f} µs, {1.0 / per_row_by_bucket[size]:.1f} "
            f"queries/s at this bucket; the last probe: {stats_line(res_probe, size)}")
    probe = spare[SERVE_MAX_BATCH:SERVE_MAX_BATCH + qb]
    per_row = per_row_by_bucket[qb]
    deadline = DEADLINE_BUCKETS * per_row * qb
    max_wait = MAX_WAIT_BUCKETS * per_row * qb
    per_row_c = r2.stats.t_wall / FOREIGN_QUERIES
    log(f"[o] per_row (128 bucket) {per_row * 1e6:.3f} µs: the 128-bucket rate "
        f"{1.0 / per_row:.1f} queries/s against (c)'s {FOREIGN_QUERIES}-row batch "
        f"{per_row_c * 1e6:.3f} µs/row ({1.0 / per_row_c:.1f} queries/s), "
        f"{per_row / per_row_c:.2f}× its per-row time; deadline {deadline * 1e3:.3f} ms, "
        f"max_wait {max_wait * 1e3:.3f} ms")

    def serve(factor, model=True):
        """One open-loop Poisson trace of the arrivals at factor × the
        128-bucket rate on a VirtualClock: under the linear service model,
        or (model=False) advanced by each batch's measured service time on
        the card."""
        srv = KNNServer(sidx, ServerConfig(deadline=deadline, max_wait=max_wait,
                                           max_batch=SERVE_MAX_BATCH, record_batches=True),
                        clock=VirtualClock(),
                        service_model=(lambda n: per_row * n) if model else None)
        srv.prime_service_estimate(per_row)
        buckets0 = sidx.total_compiles
        t0 = time.perf_counter()
        tickets = srv.run_trace(open_loop_trace(arrivals, qps=factor / per_row,
                                                seed=SERVE_SEED))
        return srv, tickets, sidx.total_compiles - buckets0, time.perf_counter() - t0

    def serve_line(what, factor, srv, new_buckets, wall):
        m = srv.metrics()
        makespan = srv.clock.now
        log(f"[o] {what} {factor:g}×: offered {factor / per_row:.1f} queries/s, served "
            f"{m['n_served'] / makespan:.1f} queries/s ({m['n_served']} of {m['n_submitted']} "
            f"over {makespan:.4f} s); response p50 {m['p50_response_s'] * 1e3:.3f} ms, p99 "
            f"{m['p99_response_s'] * 1e3:.3f} ms, max {m['max_response_s'] * 1e3:.3f} ms; shed "
            f"{m['n_shed']} (rate {m['shed_rate']:.4f}); deadline misses "
            f"{m['n_deadline_misses']}; levels {m['level_occupancy']}; {m['n_batches']} "
            f"batches, mean {m['mean_batch_rows']:.1f} rows; new engine buckets {new_buckets}; "
            f"wall {wall:.3f} s")
        return m

    for factor in SERVE_LOADS:
        srv, tickets, new_buckets, wall = serve(factor)
        m = serve_line("modelled", factor, srv, new_buckets, wall)
        assert all(t.done for t in tickets), f"(o) {factor}×: a ticket was never resolved"
        assert m["n_submitted"] == SERVE_REQUESTS
        assert m["n_served"] + m["n_shed_total"] == SERVE_REQUESTS, f"(o) {factor}×: accounting"
        shed, occupancy = {}, {}
        for t in tickets:
            if isinstance(t.outcome, Rejected):
                shed[t.outcome.reason] = shed.get(t.outcome.reason, 0) + 1
            else:
                occupancy[t.outcome.level_name] = occupancy.get(t.outcome.level_name, 0) + 1
        assert {r: c for r, c in m["n_shed"].items() if c} == shed, f"(o) {factor}×: shed counts"
        assert {n: c for n, c in m["level_occupancy"].items() if c} == occupancy, \
            f"(o) {factor}×: level occupancy"
        if factor >= 2.0:
            lat = [t.outcome.t_response for t in tickets if isinstance(t.outcome, Served)]
            assert m["n_shed_total"] > 0, f"(o) {factor}×: nothing was shed"
            assert m["n_deadline_misses"] == 0, f"(o) {factor}×: deadline misses"
            assert np.percentile(lat, 99) <= deadline + 1e-9 and max(lat) <= deadline + 1e-9, \
                f"(o) {factor}×: served p99 past the deadline"
        if factor == 1.0:
            srv1, tickets1 = srv, tickets

    # The server's core invariant, and on the card a test that query is
    # deterministic: every non-degraded batch of the 1× run replays bit for bit.
    by_rid = {t.request_id: t.outcome for t in tickets1}
    audited = replayed = 0
    for rec in srv1.batch_log:
        if srv1.cfg.ladder[rec.level].degraded:
            continue
        direct = sidx.query(rec.rows, k=rec.k)
        replayed += 1
        for j, rid in enumerate(rec.request_ids):
            assert np.array_equal(by_rid[rid].dists, direct.dists[j]) and \
                np.array_equal(by_rid[rid].ids, direct.ids[j]), \
                f"(o) request {rid} differs from the replay of batch {rec.seq}"
            audited += 1
    assert audited == srv1.n_served > 0
    log(f"[o] 1× bit-identity: {replayed} non-degraded batches replayed through "
        f"index.query, {audited} served rows equal bit for bit")
    served1 = sorted((t for t in tickets1 if isinstance(t.outcome, Served)),
                     key=lambda t: t.request_id)[:SERVE_EXACT_ROWS]
    rids = np.array([t.request_id for t in served1])
    check_exact(pts_d, fq[torch.as_tensor(rids, device=dev)], None,
                np.stack([t.outcome.dists for t in served1]),
                np.stack([t.outcome.ids for t in served1]), "(o) served rows of the 1× run")
    srv, _, new_buckets, wall = serve(1.0)
    serve_line("warm replay", 1.0, srv, new_buckets, wall)
    assert new_buckets == 0, "(o) the warm replay of the 1× trace added engine buckets"
    # The measured run three times: its service times, and so what it sheds,
    # follow the host's load from run to run.
    for rep in range(SERVE_MEASURED_RUNS):
        srv, tickets, new_buckets, wall = serve(2.0, model=False)
        serve_line(f"measured run {rep + 1}", 2.0, srv, new_buckets, wall)
        assert all(t.done for t in tickets)
        by_bucket = {}
        for rec in srv.batch_log:
            by_bucket.setdefault(pow2_bucket(rec.n_padded, qb), []).append(rec.t_service)
        log(f"[o] measured run {rep + 1} seconds per batch by bucket: " + "; ".join(
            f"{b} rows: n={len(ts)} mean {np.mean(ts) * 1e3:.3f} ms [{min(ts) * 1e3:.3f}–"
            f"{max(ts) * 1e3:.3f}] ({np.mean(ts) / b * 1e6:.3f} µs/row)"
            for b, ts in sorted(by_bucket.items())))
    launches_o = read_counts("(o) serving front end")
    log(f"[o] phase {time.perf_counter() - t_o:.2f}s; launches: knn_tile_topk "
        f"{launches_o.get('knn_tile_topk', 0)}, knn_stream_topk_prefetch "
        f"{launches_o.get('knn_stream_topk_prefetch', 0)}")
    for name in ("knn_stream_topk_prefetch", "knn_tile_topk"):
        assert launches_o.get(name, 0) > 0, f"(o) never launched {name}"
    # -- (a) the micro-batch shapes (o) launched --------------------------------
    (q1o, c1o, blk1o, qid1o, cand1o, e1o), kw1o = o_stream_call.args
    err, ms, plain_ms, b = stream_check(
        f"knn_stream_topk_prefetch serving micro-batch, {blk1o.shape[0]} tiles, k={kw1o['k']}",
        (q1o, c1o, blk1o, qid1o, cand1o), e1o, kw1o["k"], "l2", sidx.points_r, q1o)
    kernels.append(kernel_entry("knn_stream_topk_prefetch (serving micro-batch)", STREAM_CU,
                                "src/repro/kernels/knn_stream/kernel.py:220",
                                launches_o["knn_stream_topk_prefetch"], err, ms, plain_ms, b,
                                None))
    (q3o, c3o, qid3o, cid3o), kw3o = o_topk_call.args
    kernels.append(topk_check("knn_tile_topk (serving micro-batch)", q3o, c3o, qid3o, cid3o,
                              kw3o.get("metric", "l2"), launches_o["knn_tile_topk"],
                              k=kw3o["k"]))
    del o_stream_call, o_topk_call, q1o, c1o, q3o, c3o
    # How much of a 128-row micro-batch is kernel: the brute lane's kernel
    # call alone on the probe's rows (CUDA events; timing launches, made
    # after the phase's counts were read).
    probe_r = torch.as_tensor(probe, device=dev)
    if sidx.dim_perm is not None:
        probe_r = probe_r[:, sidx.dim_perm].contiguous()
    no_excl = torch.full((qb,), -2, dtype=torch.int32, device=dev)
    brute_ms = cuda_ms(lambda: brute_lib.brute_knn(sidx.points_r, probe_r, no_excl, k=K))
    log(f"[o] knn_tile_topk on the probe's {qb} rows × {len(pts)}: {brute_ms:.3f} ms "
        f"(CUDA events), {brute_ms / (per_row * qb * 1e3):.3f} of the best probe's "
        f"{per_row * qb * 1e3:.3f} ms")
    del srv1, tickets1, by_rid, srv, tickets

    # -- path 12: (p) the crash-mid-checkpoint drill on (o)'s index -------------
    # One durable save, then for each crash phase: delete CRASH_DELETE base
    # ids (nearest neighbours the live generation returns), crash the save of
    # that dirty (tombstoned) generation, load on the card (the last
    # acknowledged generation's answers, bit for bit), retry (lands, loads as
    # the live index).  Queries run at K_MUT: with at most 16 tombstones the
    # pipeline's k_main = 16 + 16 headroom stays on the kernels.
    reset_counts()
    t_p = time.perf_counter()
    cq = foreign[:CRASH_QUERIES]
    faults = ScriptedFaults()

    def load_same(ckpt, want, n_tombs, what):
        t0 = time.perf_counter()
        loaded = KNNIndex.load(ckpt, device="cuda")
        t_load = time.perf_counter() - t0
        assert loaded.n_tombstones == n_tombs, \
            f"(p) {what}: {loaded.n_tombstones} tombstones loaded, expected {n_tombs}"
        got = loaded.query(cq, k=K_MUT)
        assert np.array_equal(got.ids, want.ids) and np.array_equal(got.dists, want.dists), \
            f"(p) {what}: the loaded generation answers differently"
        return t_load

    topk_k, tiles_k = past_k_calls()
    with topk_k, tiles_k, tempfile.TemporaryDirectory() as ckpt:
        mgr = CrashingCheckpointManager(ckpt, faults)
        t0 = time.perf_counter()
        acked = sidx.save(ckpt, manager=mgr)
        log(f"[p] durable save step {acked} {time.perf_counter() - t0:.3f}s")
        want = sidx.query(cq, k=K_MUT)
        tombs_acked = 0
        for phase in CRASH_PHASES:
            sidx.delete(np.unique(want.ids[:, 0])[:CRASH_DELETE])
            assert not sidx.is_clean
            faults.crash_checkpoint(phase)
            t0 = time.perf_counter()
            try:
                sidx.save(ckpt, manager=mgr)
                raise AssertionError(f"(p) {phase}: save did not crash")
            except CheckpointCrash:
                t_crash = time.perf_counter() - t0
            with open(os.path.join(ckpt, "LATEST")) as fh:
                assert fh.read().strip() == f"step-{acked:09d}", f"(p) {phase}: LATEST moved"
            unacked = os.path.join(ckpt, f"step-{acked + 1:09d}")
            assert os.path.isdir(unacked) == (phase == "pre-latest"), \
                f"(p) {phase}: unexpected durability of the crashed step"
            t_load_ack = load_same(ckpt, want, tombs_acked, f"{phase} crash")
            live = sidx.query(cq, k=K_MUT)
            t0 = time.perf_counter()
            acked = sidx.save(ckpt, manager=mgr)
            t_save = time.perf_counter() - t0
            tombs_acked = sidx.n_tombstones
            t_load = load_same(ckpt, live, tombs_acked, f"{phase} retry")
            size = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(os.path.join(ckpt, f"step-{acked:09d}"))
                       for f in fs)
            log(f"[p] {phase}: {CRASH_DELETE} deleted ({tombs_acked} tombstones, "
                f"{sidx.n_points} live points); crash after {t_crash:.3f}s; load of the "
                f"acknowledged generation {t_load_ack:.3f}s, bit-identical; retried save step "
                f"{acked} {t_save:.3f}s ({size / 2**20:.1f} MiB on disk), load {t_load:.3f}s, "
                f"bit-identical to the live index")
            want = live
    assert acked == len(CRASH_PHASES) and faults.count("ckpt-crash") == len(CRASH_PHASES)
    assert tombs_acked == len(CRASH_PHASES) * CRASH_DELETE
    assert past_k(topk_k) == 0 and past_k(tiles_k) == 0, \
        "(p) a dirty query left the kernels' k"
    launches_p = read_counts("(p) crash drill")
    assert launches_p.get("knn_tile_topk", 0) > 0, "(p) never launched knn_tile_topk"
    log(f"[p] phase {time.perf_counter() - t_p:.2f}s")
    del sidx, want, live

    clock("(q)")

    # -- path 13: (q) the mesh on the one card -----------------------------------
    # One process drives P logical slots, all on cuda:0.  (q1) a 4 × 1 mesh
    # over the 5M SuSy corpus, ε selected once globally; (q2) a 2 × 2 replica
    # × shard mesh with (q1)'s ε pinned, healthy, under a killed replica, with
    # a lost shard, and behind KNNServer's partial rung; (q3) sharded
    # mutation and durability on the 2 × 2 index; (q4) the SPMD joins.  Each
    # part resets the launch counters before it and reads them after it.
    t_q = time.perf_counter()
    reset_counts()
    t0 = time.perf_counter()
    mesh4 = make_serving_mesh(MESH_SHARDS)
    assert {str(d) for d in mesh4.devices.reshape(-1)} == {"cuda:0"}
    sh = KNNIndex.build(pts, cfg, mesh=mesh4)
    assert isinstance(sh, ShardedKNNIndex) and sh.placement_shape == (1, MESH_SHARDS)
    log(f"[q1] 4 × 1 build {time.perf_counter() - t0:.2f}s: eps={sh.eps:.6g} ((b)'s "
        f"{eps_b:.6g}) t_select_eps={sh.t_select_eps:.3f}s t_build={sh.t_build:.3f}s "
        f"shard_n={sh.shard_n} n_pad={sh.n_pad}")
    assert sh.eps == eps_b, "(q1) the global ε selection differs from the single index's"
    shard_n = sh.shard_n
    with FirstCall(topk_ops, "knn_topk", lambda *a, **kw: a[1].shape[0] == shard_n) as q_topk, \
            FirstCall(stream_ops, "knn_stream_topk_prefetch") as q_stream:
        s1 = sh.query(foreign)
    log(f"[q1] R≠S #1: {stats_line(s1, FOREIGN_QUERIES)} t_merge={s1.stats.t_merge:.4f}s")
    with FirstCall(sh, "_merge") as q_merge:
        s2 = sh.query(foreign)
    log(f"[q1] R≠S #2: {stats_line(s2, FOREIGN_QUERIES)} t_merge={s2.stats.t_merge:.4f}s; "
        f"engine buckets {sh.compile_counts}")
    log(f"[q1] merge time {s2.stats.t_merge * 1e3:.3f} ms of t_wall {s2.stats.t_wall:.3f}s "
        f"((c) single-device t_wall {r2.stats.t_wall:.3f}s)")
    assert s2.stats.n_engine_compiles == 0, "(q1) the steady-state sharded query added buckets"
    assert sh.compile_counts["merge"] == 1
    check_exact(pts_d, fq[sub], None, s2.dists[sub], s2.ids[sub], "(q1) sharded R≠S")
    same_as(s2, r2, fq, pts_d, "(q1) sharded vs (c) single-device")
    # The tree merge against the all-gather fold on the captured shard blocks.
    (k_out, dpad, ipad, epad, n_pad), _ = q_merge.args
    merges = {}
    for strategy in ("allgather", "tree"):
        fn = distributed.collective_topk_merge(mesh4, sh.axes, k=k_out, strategy=strategy,
                                               dedup=n_pad > 0)
        merges[strategy] = fn(dpad, ipad, epad)
        ms_m = cuda_ms(lambda: fn(dpad, ipad, epad))
        log(f"[q1] collective merge {strategy}: {tuple(dpad.shape)} -> k={k_out} "
            f"{ms_m:.3f} ms (CUDA events)")
    (dag, iag), (dtr, itr) = merges["allgather"], merges["tree"]
    assert torch.equal(dag, dtr), "(q1) tree and all-gather merges differ in distances"
    tie_ids = int((iag != itr).sum())
    log(f"[q1] tree == all-gather: distances bit-identical, {tie_ids} ids differ (ties)")
    assert np.array_equal(dag[:FOREIGN_QUERIES].cpu().numpy(), s2.dists)
    del dpad, ipad, epad, merges, q_merge, dag, iag, dtr, itr
    # The sharded self-join over the first MESH_SELF_ROWS rows.
    t0 = time.perf_counter()
    sub_pts = pts[:MESH_SELF_ROWS]
    sh_self = KNNIndex.build(sub_pts, cfg, mesh=mesh4)
    ss = sh_self.query(exclude_self=True)
    rows_s = rng.choice(MESH_SELF_ROWS, ORACLE_ROWS, replace=False)
    rows_st = torch.as_tensor(rows_s, device=dev)
    log(f"[q1] self-join of {MESH_SELF_ROWS} rows on 4 × 1 (eps={sh_self.eps:.6g}) in "
        f"{time.perf_counter() - t0:.2f}s: {stats_line(ss, MESH_SELF_ROWS)} "
        f"t_merge={ss.stats.t_merge:.4f}s")
    check_exact(pts_d[:MESH_SELF_ROWS], pts_d[rows_st], rows_st, ss.dists[rows_s],
                ss.ids[rows_s], "(q1) sharded self-join")
    del sh_self, ss
    launches_q1 = read_counts("(q1) 4 × 1 mesh")
    for name in ("knn_stream_topk_prefetch", "knn_tile_topk", "distance_bin_histogram"):
        assert launches_q1.get(name, 0) > 0, f"(q1) never launched {name}"
    log(f"[q1] phase {time.perf_counter() - t_q:.2f}s")

    # (q2) the 2 × 2 replica × shard mesh, ε pinned to (q1)'s.
    t_q2 = time.perf_counter()
    reset_counts()
    t0 = time.perf_counter()
    mesh22 = make_serving_mesh(2, replicas=2)
    sh22 = KNNIndex.build(pts, cfg, sh.eps, mesh=mesh22)
    assert sh22.placement_shape == (2, 2)
    log(f"[q2] 2 × 2 build {time.perf_counter() - t0:.2f}s (ε pinned)")
    cq = foreign[:MESH_QUERIES]
    cq_rows = np.sort(rng.choice(MESH_QUERIES, ORACLE_ROWS, replace=False))
    healthy = sh22.query(cq)
    log(f"[q2] healthy: {stats_line(healthy, MESH_QUERIES)} retries="
        f"{healthy.stats.n_subquery_retries}")
    assert healthy.coverage.all() and healthy.stats.n_subquery_failures == 0
    s4 = sh.query(cq)
    same_as(healthy, s4, fq, pts_d, "(q2) 2 × 2 vs 4 × 1")
    del s4
    sh22.configure_serving(faults=ScriptedFaults().kill_replica(0, at_step=0))
    killed = sh22.query(cq)
    assert np.array_equal(killed.ids, healthy.ids) and np.array_equal(killed.dists, healthy.dists), \
        "(q2) a killed replica changed the answers"
    assert killed.coverage.all() and killed.stats.n_subquery_retries > 0
    log(f"[q2] replica 0 killed: bit-identical, coverage full, retries "
        f"{killed.stats.n_subquery_retries}, failures {killed.stats.n_subquery_failures}")
    lost = ScriptedFaults()
    for replica in (0, 1):
        lost.fail_subquery(replica, 1, steps=range(sh22._serve_step, sh22._serve_step + 4))
    sh22.configure_serving(ServingConfig(max_attempts=2), faults=lost)
    lr = sh22.query(cq)
    assert lr.stats.shards_lost == (1,)
    assert lr.coverage[:, 0].all() and not lr.coverage[:, 1].any()
    g0 = np.unique(sh22.gids[0])
    pos0 = np.searchsorted(g0, lr.ids[cq_rows])
    assert (g0[np.clip(pos0, 0, len(g0) - 1)] == lr.ids[cq_rows]).all(), \
        "(q2) a lost shard's id was returned"
    check_exact(pts_d[torch.as_tensor(g0, device=dev)], fq[torch.as_tensor(cq_rows, device=dev)],
                None, lr.dists[cq_rows], pos0, "(q2) lost shard 1: exact over shard 0")
    log(f"[q2] shard 1 lost: coverage column 1 false on all {MESH_QUERIES} rows, failures "
        f"{lr.stats.n_subquery_failures}")
    del lr, killed
    sh22.configure_serving(faults=FaultInjector())

    # KNNServer over the 2 × 2 index with the partial rung.
    qb = cfg.query_block
    spare = foreign[SERVE_REQUESTS:]
    sh22.query(spare[:qb])
    sh22.query(spare[:SERVE_MAX_BATCH])
    probes = []
    for _ in range(3):
        t0 = time.perf_counter()
        sh22.query(spare[SERVE_MAX_BATCH:SERVE_MAX_BATCH + qb].copy())
        probes.append(time.perf_counter() - t0)
    per_row22 = min(probes) / qb
    ladder = (DegradationLevel("full"),
              DegradationLevel("partial", enter_pressure=0.3, hedging=False, shard_frac=0.5))
    srv = KNNServer(sh22, ServerConfig(deadline=DEADLINE_BUCKETS * per_row22 * qb,
                                       max_wait=MAX_WAIT_BUCKETS * per_row22 * qb,
                                       max_batch=SERVE_MAX_BATCH, shed_on_admission=False,
                                       max_queue=10 ** 6, ladder=ladder, record_batches=True),
                    clock=VirtualClock(), service_model=lambda n: per_row22 * n)
    srv.prime_service_estimate(per_row22)
    t0 = time.perf_counter()
    tickets = srv.run_trace(open_loop_trace(foreign[:MESH_SERVE_REQUESTS],
                                            qps=2.0 / per_row22, seed=SERVE_SEED))
    m = srv.metrics()
    log(f"[q2] KNNServer 2×: probes {[round(t, 6) for t in probes]} s, per_row "
        f"{per_row22 * 1e6:.3f} µs; served {m['n_served']} of {m['n_submitted']}, shed "
        f"{m['n_shed']}; levels {m['level_occupancy']}; {m['n_batches']} batches; wall "
        f"{time.perf_counter() - t0:.3f}s")
    assert all(t.done for t in tickets) and m["n_submitted"] == MESH_SERVE_REQUESTS
    by_rid = {t.request_id: t.outcome for t in tickets}
    n_partial = n_full = 0
    for rec in srv.batch_log:
        if rec.serve_shards is not None:
            for rid in rec.request_ids:
                cov = by_rid[rid].coverage
                assert by_rid[rid].degraded and cov[list(rec.serve_shards)].all() \
                    and cov.sum() == len(rec.serve_shards), "(q2) partial coverage flags"
                n_partial += 1
            continue
        if srv.cfg.ladder[rec.level].degraded:
            continue
        direct = sh22.query(rec.rows, k=rec.k)
        for j, rid in enumerate(rec.request_ids):
            assert np.array_equal(by_rid[rid].dists, direct.dists[j]) and \
                np.array_equal(by_rid[rid].ids, direct.ids[j]), \
                f"(q2) request {rid} differs from the replay of batch {rec.seq}"
            n_full += 1
    assert n_partial > 0 and n_full > 0, "(q2) the trace never reached both rungs"
    assert sh22.supervisor.cfg.hedging
    log(f"[q2] {n_partial} partial responses flagged with exactly the skipped shard's "
        f"column; {n_full} full-rung responses bit-identical to direct sharded queries")
    del srv, tickets, by_rid

    # (q3) sharded mutation and durability on the 2 × 2 index.
    t0 = time.perf_counter()
    ins = (pointclouds.load("susy", n_override=N_INSERT)
           + rng.normal(0, 0.01, (N_INSERT, pts.shape[1]))).astype(np.float32)
    ins_gids = sh22.insert(ins)
    base_del = np.unique(healthy.ids[:, 0])[:MESH_DELETE]
    sh22.delete(base_del)
    mq = sh22.query(cq, k=K_MUT)
    log(f"[q3] {N_INSERT} inserts, {MESH_DELETE} deletes, R≠S K={K_MUT}: "
        f"{stats_line(mq, MESH_QUERIES)} t_delta={mq.stats.t_delta:.3f}s "
        f"entries from the delta buffer {int((mq.ids >= len(pts)).sum())}")
    live = np.ones(len(pts) + N_INSERT, bool)
    live[base_del] = False
    net_gids = np.flatnonzero(live)
    net_d = torch.cat([pts_d, torch.as_tensor(ins, device=dev)])[torch.as_tensor(live, device=dev)]
    posm = np.searchsorted(net_gids, mq.ids[cq_rows])
    assert (net_gids[np.clip(posm, 0, len(net_gids) - 1)] == mq.ids[cq_rows]).all()
    check_exact(net_d, fq[torch.as_tensor(cq_rows, device=dev)], None, mq.dists[cq_rows], posm,
                f"(q3) mutated sharded R≠S K={K_MUT}")
    del net_d
    full_d = torch.cat([pts_d, torch.as_tensor(ins, device=dev)])
    with tempfile.TemporaryDirectory() as ckpt:
        t1 = time.perf_counter()
        sh22.save(ckpt)
        t_save = time.perf_counter() - t1
        for what, mesh_l in (("the 2 × 2 mesh", mesh22), ("no mesh", None),
                             ("the 4 × 1 mesh", mesh4)):
            t1 = time.perf_counter()
            back = KNNIndex.load(ckpt, device="cuda", mesh=mesh_l)
            t_load = time.perf_counter() - t1
            got = back.query(cq, k=K_MUT)
            identical = np.array_equal(got.ids, mq.ids) and np.array_equal(got.dists, mq.dists)
            log(f"[q3] load onto {what} {t_load:.3f}s ({type(back).__name__}): "
                f"{'bit-identical' if identical else 'not bit-identical'}")
            if mesh_l is mesh22:
                assert identical, "(q3) the reloaded 2 × 2 index answers differently"
            else:
                same_as(got, mq, fq, full_d, f"(q3) loaded onto {what}")
            del back, got
    del full_d
    log(f"[q3] save {t_save:.3f}s")
    net_pts = sh22.net_points()
    t1 = time.perf_counter()
    sh22.compact()
    t_compact = time.perf_counter() - t1
    fresh = KNNIndex.build(net_pts, cfg, sh.eps, mesh=mesh22)
    rc, rf = sh22.query(cq, k=K_MUT), fresh.query(cq, k=K_MUT)
    assert np.array_equal(rc.ids, rf.ids) and np.array_equal(rc.dists, rf.dists), \
        "(q3) compact() differs from a fresh sharded build on net_points()"
    log(f"[q3] compact {t_compact:.3f}s: bit-identical to a fresh 2 × 2 build on net_points(); "
        f"phase (q3) {time.perf_counter() - t0:.2f}s")
    del fresh, rc, rf, net_pts, sh22, healthy, mq
    launches_q23 = read_counts("(q2)-(q3) 2 × 2 mesh")
    assert launches_q23.get("knn_tile_topk", 0) > 0, "(q2)-(q3) never launched knn_tile_topk"
    log(f"[q2]-[q3] phase {time.perf_counter() - t_q2:.2f}s")

    # (q4) the SPMD joins.
    t_q4 = time.perf_counter()
    reset_counts()
    ring_pts = pts_d[:MESH_SELF_ROWS]
    rows_r = torch.as_tensor(rng.choice(MESH_SELF_ROWS, ORACLE_ROWS, replace=False), device=dev)
    rows_r_np = rows_r.cpu().numpy()
    with FirstCall(topk_ops, "knn_topk") as ring_call:
        (rd32, ri32), ring_ms = timed(lambda: distributed.ring_self_join(
            mesh4, ("shard",), k=K, corpus_chunk=RING_CHUNK)(ring_pts))
    launches_ring = read_counts("(q4) ring self-join")
    log(f"[q4] ring self-join {MESH_SELF_ROWS} rows, 4 slots, chunk {RING_CHUNK}: "
        f"{ring_ms / 1e3:.3f}s ({MESH_SELF_ROWS / ring_ms * 1e3:.1f} queries/s), knn_tile_topk "
        f"launches {launches_ring.get('knn_tile_topk', 0)}")
    check_exact(ring_pts, ring_pts[rows_r], rows_r, torch.sqrt(rd32[rows_r]).cpu().numpy(),
                ri32[rows_r].cpu().numpy(), "(q4) ring self-join")
    reset_counts()
    (rd16, ri16), ring16_ms = timed(lambda: distributed.ring_self_join_bf16(
        mesh4, ("shard",), k=K, corpus_chunk=RING_CHUNK)(ring_pts))
    # bf16 precision: a corpus coordinate c_j rounds to c_j (1 + δ_j), |δ_j|
    # ≤ u = 2⁻⁸, which moves d² by at most 2u·d·|c| + u²|c|²; every candidate
    # within a row's k-th distance D has |c| ≤ |q| + D, and the j-th smallest
    # d² moves by no more than the largest such move, plus the fp32
    # expansion bound of either run.
    u16 = 2.0 ** -8
    d_k = torch.maximum(rd16[:, -1], rd32[:, -1]).double().clamp(min=0).sqrt()
    c_max = ring_pts.double().norm(dim=1) + d_k
    allow16 = (2 * u16 * d_k * c_max + u16 ** 2 * c_max ** 2
               + 2 * expansion_bound(ring_pts.double().norm(dim=1), c_max, ring_pts.shape[1]))
    delta16 = (rd16.double() - rd32.double()).abs()
    rel = (delta16 / rd32.double().clamp(min=1e-3)).max().item()
    overlap = (ri16[:, :, None] == ri32[:, None, :]).any(-1).float().mean().item()
    log(f"[q4] bf16 ring {ring16_ms / 1e3:.3f}s: neighbour overlap {overlap:.4f}; max |Δd²| "
        f"{delta16.max().item():.3e}, largest |Δd²| / bf16 bound "
        f"{(delta16 / allow16[:, None]).max().item():.3f}; max relative |Δd²| / d² {rel:.4f}")
    assert (delta16 <= allow16[:, None]).all() and overlap > 0.9, \
        "(q4) the bf16 ring is beyond bf16 precision"
    del rd16, ri16, rd32, ri32
    spmd_pts = pts_d[:SPMD_ROWS]
    eps_s = select_epsilon(spmd_pts, cfg, None, SPMD_ROWS)[0]
    join = distributed.hybrid_join_spmd(mesh4, ("shard",), k=K, m=cfg.m, rho=cfg.rho,
                                        gamma=cfg.gamma, dense_budget=cfg.dense_budget,
                                        sparse_budget=cfg.sparse_budget)
    sres, spmd_ms = timed(lambda: join(spmd_pts, eps_s))
    src = sres.source.cpu().numpy()
    log(f"[q4] hybrid_join_spmd {SPMD_ROWS} rows, 4 query slots, eps={eps_s:.6g}: "
        f"{spmd_ms / 1e3:.3f}s; sources {np.bincount(src, minlength=4).tolist()} "
        f"(0 dense, 1 sparse, 2 fail/brute lane, 3 unresolved); n_unresolved "
        f"{sres.n_unresolved}")
    assert sres.n_unresolved == int((src == 3).sum())
    rows_p = rng.choice(SPMD_ROWS, ORACLE_ROWS, replace=False)
    rows_p = rows_p[src[rows_p] != 3]
    rows_pt = torch.as_tensor(rows_p, device=dev)
    if len(rows_p):
        check_exact(spmd_pts, spmd_pts[rows_pt], rows_pt,
                    torch.sqrt(sres.dists[rows_pt]).cpu().numpy(),
                    sres.ids[rows_pt].cpu().numpy(), "(q4) hybrid_join_spmd resolved rows")
    launches_q4 = read_counts("(q4) bf16 ring + hybrid_join_spmd")
    # The dense lane launches knn_stream only when the split sends it rows.
    log(f"[q4] hybrid_join_spmd's dense lane: {int((src == 0).sum())} rows, "
        f"knn_stream_topk_prefetch launches {launches_q4.get('knn_stream_topk_prefetch', 0)}")
    for name in ("knn_tile_topk", "distance_bin_histogram"):
        assert launches_q4.get(name, 0) > 0, f"(q4) never launched {name}"
    log(f"[q4] phase {time.perf_counter() - t_q4:.2f}s")
    del sres, join

    # -- (a) the shapes (q) launched ------------------------------------------
    (q3s, c3s, qid3s, cid3s), kw3s = q_topk.args
    kernels.append(topk_check("knn_tile_topk (sharded, per shard)", q3s, c3s, qid3s, cid3s,
                              kw3s.get("metric", "l2"), launches_q1["knn_tile_topk"],
                              k=kw3s["k"]))
    (q1s, c1s, blk1s, qid1s, cand1s, e1s), kw1s = q_stream.args
    err, ms, plain_ms, b = stream_check(
        f"knn_stream_topk_prefetch sharded first dense batch, {blk1s.shape[0]} tiles, "
        f"k={kw1s['k']}", (q1s, c1s, blk1s, qid1s, cand1s), e1s, kw1s["k"], "l2", c1s, q1s)
    kernels.append(kernel_entry("knn_stream_topk_prefetch (sharded, per shard)", STREAM_CU,
                                "src/repro/kernels/knn_stream/kernel.py:220",
                                launches_q1["knn_stream_topk_prefetch"], err, ms, plain_ms, b,
                                None))
    (q3r, c3r, qid3r, cid3r), kw3r = ring_call.args
    kernels.append(topk_check("knn_tile_topk (ring hop chunk)", q3r, c3r, qid3r, cid3r, "l2",
                              launches_ring["knn_tile_topk"], k=kw3r["k"]))
    del q_topk, q_stream, ring_call, q3s, c3s, q1s, c1s, q3r, c3r, sh
    log(f"[q] phase {time.perf_counter() - t_q:.2f}s")

    clock("(r)")

    # -- path 14: (r) the kNN-LM at olmo_1b's full width ------------------------
    lm_phase(dev, kernels, reset_counts, read_counts, topk_check, hist_check)

    clock("(s)")

    # -- path 15: (s) the dense training path at olmo_1b's full width -----------
    s1 = train_phase(dev, reset_counts, read_counts)

    clock("(t)")

    # -- path 16: (t) the sharded train step on 2 × 4 slots at olmo_1b's width --
    sharded_train_phase(dev, reset_counts, read_counts, s1)

    clock("(u)")

    # -- path 17: (u) the sharded serving steps and the dry run at olmo_1b's width --
    sharded_serve_phase(dev, reset_counts, read_counts)

    clock("(v)")

    # -- path 18: (v) the recurrent presets at their published widths -----------
    recurrent_phase(dev, kernels, reset_counts, read_counts, topk_check)

    clock("(w)")

    # -- path 19: (w) the recurrent presets in the slot program -------------------
    recurrent_sharded_phase(dev, reset_counts, read_counts)

    clock("(x)")

    # -- path 20: (x) the MoE presets on one card ---------------------------------
    moe_phase(dev, kernels, reset_counts, read_counts, topk_check)

    clock("(y)")

    # -- path 21: (y) the MoE presets in the slot program -------------------------
    moe_sharded_phase(dev, reset_counts, read_counts)

    clock("(z)")

    # -- path 22: (z) the encoder-decoder on one card ------------------------------
    encdec_phase(dev, kernels, reset_counts, read_counts, topk_check)

    clock("(za)")

    # -- path 23: (za) the VLM on one card -----------------------------------------
    vlm_phase(dev, kernels, reset_counts, read_counts, topk_check)

    clock("(zb)")

    # -- path 24: (zb) frames and patches in the slot program ---------------------
    sharded_side_phase(dev, reset_counts, read_counts)

    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

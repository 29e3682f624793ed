#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PLAID (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--passages N] [--seed S]

Phases, one JSON line each, any failure ends the run with a non-zero exit:

1. env         torch / CUDA versions and the card (nvidia-smi line printed
               as it is);
2. build       nvcc builds every kernel of ``src/repro_torch/csrc``;
3. index       a synthetic index built on the card at ColBERTv2's widths
               (d=128, nbits=2, nq=32, K=2^18, 2M passages of 8..180
               tokens) plus a >=1M-token compress/decompress round trip;
4. reference   a small index searched under lossless caps against a brute-
               force exact MaxSim written here, independent of the engine;
5. kernels     K1/K2/K3 held against their plain PyTorch versions at the
               main path's shapes (K1 at stage 2's and at stage 3's, with
               no keep) and at nbits 1/4, ragged nd, nq 20/40, all bit for
               bit; K4 at vanilla's stage-3 block (4096 passages x 180
               rows) and at nbits 1/4, K5/K6 at ``_search``'s k=1000 shapes;
               K2/K3's blocks an SM (the occupancy API);
               median times of launches between CUDA events (``ms``), of
               the same behind a device sleep (``device_ms``: device work
               alone, without the host's submission) and the host's time
               per call (``host_us``);
6. flash       K7 (attention) against its plain version at the encoder's
               two bf16 shapes (B=32 queries of 32 tokens, B=64 passages of
               180; 48 heads over 12 KV heads, dh 64), the reference's f32
               test shapes (causal, MQA), bf16 views at an odd offset
               and transposed, and the LM prefills' causal bf16 shapes
               (yi-34b at S 32,768, 64 padded heads over 8, dh 128;
               granite-34b at S 4,096, 48 heads over 1; granite-moe-1b at
               B 8, S 4,096, dh 64; deepseek-moe-16b, MHA); ``ms``,
               ``device_ms`` and the host's time per call (``host_us``)
               beside SDPA's;
7. search      the ``plaid-cuda`` backend for k in {10, 100, 1000} x fused
               on/off over a warm-up and 4 timed B=32 batches, ranked pids
               identical to the ``plaid`` backend (plain PyTorch, same
               card), launch counts; then, per k, one unfused batch with
               ``with_funnel=True`` through both backends (pids identical
               to each other and to the batch without the funnel, every
               ``FunnelStats`` field identical), each field's mean over the
               batch, and funnel off against on interleaved (p50 of 4
               pairs);
8. live        the live index (``repro_torch.live``) with the main index
               as its base segment: ``live-cuda`` over the bare base equals
               ``plaid-cuda`` (equal scores ordered by pid, as the merge
               orders them); three deltas (4,096, 1,000 and 333 passages)
               through ``add_passages`` and 20,100 tombstones; ``live-cuda``
               (K1-K3 on every segment) and ``live`` identical for k 10 and
               1000 (fused and not) over a warm-up and 4 B=32 batches, with
               the funnel, no tombstoned pid returned; p50 beside
               ``plaid-cuda`` on the bare base (interleaved), launches and
               ``stage1_scores_batched`` calls a batch (one); ``compact()``
               seconds and peak device bytes; after it ``live-cuda`` equals
               ``plaid-cuda`` over the compacted base;
8b. tiered     the tiered index (``repro_torch.core.tiered``) over the main
               index, payloads demoted to host memory: device-tier bytes
               against the resident engine's; ``plaid-tiered-cuda`` equal
               to ``plaid-cuda`` under ``torch.equal`` for k in {10, 100,
               1000}, fused and not, over a warm-up and 4 B=32 batches, to
               ``plaid-tiered`` (plain) on one batch per k and in every
               funnel field; each batch's transfer bytes equal to
               ``tiered_transfer_cost`` of an independent recount; per k
               the batch split (phase A, the finalists to the host, the
               host gather, the copy, phase B), the copy's GB/s, peak
               device bytes, p50 beside ``plaid-cuda`` (4 interleaved
               pairs) and launches a batch; every tiered batch launches
               K1 with K2 (K3 fused) and nothing else, counted around the
               tiered calls alone; two partitions equal to the
               per-partition resident oracle plus ``merge_topk``; and the
               staging ring under a device sleep queued on its copy stream
               (its save / load round trip runs in phase ``quality``);
8c. serve      the serving tier (``repro_torch.serving``) over the main
               index at Table 2's k=10, ``batch_size=32``,
               ``max_wait_ms=2``: (1) ``plaid-cuda`` handed coalesced
               batches of 1 / 3 / 5 / 17 / 32 queries (buckets 1 / 4 / 8 /
               32 / 32) with mixed per-request ``t_cs`` and ``k``, each
               lane equal to a direct ``search_batch`` of the padded
               bucket (``np.array_equal``) and with a direct single-query
               ``search``'s pids; (2) 64 client threads, 2,048 distinct
               queries, cache off, in two rounds each after direct B=32
               batches of the same queries: q/s, p50/p99, the bucket
               histogram and occupancy, the median host ms of each
               ``serve.*`` span, beside the direct p50 and ``32 / p50``;
               K1 = 2 x dispatches and K2 = dispatches; (3) one
               closed-loop client beside direct B=1 searches; (4) the
               cache: hits identical to their misses, hit rate, hit p50;
               (5) ``live-cuda`` served to 8 client threads while a
               mutator adds 333 passages, deletes half and compacts, 3
               times: typed errors only, no hang, then every (query,
               ``t_cs``) served equals a direct search and a cached entry
               goes stale across one more add; (6) ``plaid-tiered-cuda``:
               ``stats()["transfer"]`` equals the engine's totals; (7) a
               ``ReplicaPool`` of two ``live-cuda`` retrievers over one
               ``LiveIndex``: one add bumps the generation once, both
               serve the new corpus.  Launches are counted around the runs
               that have one dispatcher thread (the kernel wrappers'
               counters are plain ints, so the pool's two dispatchers are
               not counted);
8d. sharded    document sharding (``repro_torch.exec.sharded``) with the
               shards sharing the one card through an explicit ``Mesh``:
               (1) ``plaid-sharded`` (``impl="cuda"``) at one shard equal
               to ``plaid-cuda`` under ``torch.equal`` for k in {10, 100,
               1000}, fused and not (scores; pids once ``plaid-cuda``'s
               equal scores are put in pid order, the merge's order); (2) ``shard_index`` of the main index
               into two shards of 1M passages on the card (seconds), the
               two-shard result equal, bit for bit, to the shards run one
               by one through ``plaid-cuda`` with ``local_to_global_pids``
               and a local ``merge_topk``, pids equal to ``impl="ref"``
               (scores to 1e-5), K1 = 4 and K2 = 2 launches a batch (K3 =
               2 fused), p50 of 4 interleaved pairs and device ms beside
               ``plaid-cuda``; (3) ``live-sharded-cuda`` over the live
               phase's base, deltas and tombstones equal to
               ``live-sharded`` and to its per-shard composition under
               ``torch.equal``, and re-sharded after ``compact()``; (4) a
               trained 2^16-passage, K = 2^12 build on a 2-device mesh
               ``torch.equal`` to the 1-device build, array for array; (5)
               two gloo ranks spawned on ``cuda:0`` (kernels built here
               first) whose ``search_batch`` equals the in-process
               2-shard result.  Launches are counted around the sharded
               calls alone;
8e. serve_driver  ``launch.serve`` (the reference's serving driver) at its
               defaults (20,000 documents of ``embedding_corpus``, 256
               queries in batches of 16, k 10) with ``--compare-vanilla
               --sweep-t-cs``, once with ``--backend plaid`` and once with
               ``--pallas`` (``plaid-cuda``): mean / p50 / p99 ms a query,
               success@1, vanilla's speedup and the four ``t_cs`` rows of
               each; the two builds identical, and plaid-cuda's pids (and
               vanilla's) equal to plaid's on all 256 queries;
9. vanilla     the ``vanilla`` backend (ColBERTv2's baseline, K4) at the
               reference's ``vanilla_p4_c8192`` settings for k in {10,
               1000} over a warm-up and 2 timed B=32 batches: pids
               identical to ``VanillaEngine(impl="ref")``, p50 per batch
               beside ``plaid-cuda``'s on the same batches, and
               ``plaid-cuda``'s recall@10 against vanilla's top 10 (the
               paper's Table 3 protocol, as smoke numbers);
10. oracle      8 queries through the single-query ``plaid._search`` with
               ``impl="cuda"`` (K5, K6) for k in {10, 100, 1000}: pids
               identical to the same lanes of ``plaid-cuda``'s batch and to
               ``_search(impl="ref")``;
11. quality    the quality harness (``repro_torch.eval``): (i) an index
               of 2^16 passages of 8..180 tokens from
               ``data.synthetic.embedding_corpus`` (d=128, nbits 2, K by
               ColBERTv2's rule) built on the card and 64 seeded queries of
               32 tokens; ``sweep_quality`` over ``default_grid`` (48
               points) and 8 points whose ndocs caps cut real candidates,
               with ``impl="cuda"`` and with ``impl="ref"``: pids, funnel,
               work and metrics identical at every point; records, the
               frontier, ``n_programs``, per-point latency, the points
               where each cap's mask bound; (ii)
               ``certify_backends`` at lossless caps on 4,096 passages and
               32 queries: every variant (``plaid-cuda``, ``vanilla``,
               fused, bf16 and int8 stage 1, ``live``, ``live-cuda`` and
               ``live-delta``: a frozen-table base over half the corpus
               plus the other half as a delta) within 1e-6 of the exact
               f32 ``plaid`` baseline's recall@10, the PLAID and live
               variants' pids identical to the baseline's (the live ones
               with equal scores ordered by pid) and
               ``vanilla``'s to ``VanillaEngine(impl="ref")``'s, scores
               within 1e-5, with the IVF walk's and the candidate blocks'
               bytes; (iii) a live directory with two deltas and
               tombstones saved and loaded, identical pids; (iv) the sweep's
               index as a tiered directory (``plaid-tiered-cuda``) saved
               and loaded, payloads memory-mapped, identical results;
12. encode     ColBERTv2 at full width (``attn_impl="flash"``, seeded
               weights) encodes a corpus of 8..180-token passages,
               ``build_index`` indexes it on the card (k-means at
               ColBERTv2's centroid count), encoded B=32 query batches are
               searched with ``plaid-cuda`` and ``plaid`` (identical pids)
               and in the main index: encode and tokens -> pids latencies,
               K7 launch counts, one encode held against the CPU;
13. stream_build  the streaming build (``repro_torch.build``): (i) a
               trained build at ColBERTv2's widths (d=128, nbits=2, K=2^17,
               a 2^18 sample, 8 Lloyd iterations) of 250,000 passages of
               8..180 tokens (~23.5M tokens) made chunk by chunk on the
               card: pass 1/pass 2/k-means seconds, tokens/s, peak device
               memory beside the corpus's f32 size, BuildStats, pass 2's
               device time by kernel, and a B=32 batch with identical pids
               through plaid-cuda and plaid; (ii) frozen-table streaming
               builds of the encode phase's corpus at two chunk sizes,
               pruned (0.25) and not, array-identical to ``build_index``;
               (iii) two trained builds of ~1M tokens at chunk_docs 256 and
               4,096, bit-identical; (iv) ``indexer.build_from_encoder``
               over 2,048 passages through the encoder (K7) identical to
               ``build_index`` over the same output, and ``retrieval.build``
               identical to ``build_index_streaming``;
13b. train     ColBERTv2 training (``repro_torch.training``): (i)
               ``colbertv2.full_config()`` (12 layers, d 768, 12 heads
               padded to 48, d_ff 3072, vocab 30528, bf16, f32 weights,
               chunked attention, remat) on ``colbert_batches`` of B = 32
               queries of 32 tokens and 4 passages of 180 each (24,064
               tokens a step), AdamW on the cosine schedule: a warm-up
               step, then 20 timed steps: step p50 ms, tokens/s, peak
               device bytes, device / wall (torch.profiler), the first and
               last loss, ``mfu`` (6 N tokens / step time / 989 TFLOP/s),
               the mean loss over 4 held-out batches lower after the steps
               than before, no port kernel launched; (ii) the
               reduced config in f32 for 3 steps on the card and on the
               CPU from one state, losses within rtol 1e-4; (iii)
               ``n_micro`` 4 against 1 on one batch (in-batch negatives
               off): losses within rtol 1e-5, parameters within rtol 1e-5
               plus a thousandth of the step's lr; (iv) 20 full-width
               steps at B = 8 with
               int8 compression and error feedback: the held-out loss
               falls, the feedback is nonzero; (v) ``run_supervised`` at full width
               (B = 8) with a failure after the checkpoint at step 2: one
               restart, the state restored from that checkpoint bit for
               bit, the run completes; the seconds to save and to restore
               the full-width state (weights, mu, nu); (vi) the
               trained weights served: 4,096 passages and a B=32 query
               batch encoded through K7, ``build_index``, ``plaid-cuda``'s
               pids equal to ``plaid``'s at k 10 and 100 (K1, K2);
13c. train_dp  data-parallel training (``distributed.sharding``,
               ``training.loop`` on a ``("data", "model")`` mesh of 2 x 1):
               ``colbertv2.full_config()`` at B = 32 (24,064 tokens) over
               two gloo ranks spawned once on ``cuda:0``, 16 rows each, from
               the seeded weights: 3 steps in each case (``n_micro`` 1 and
               2, int8), the first step's loss within 1e-3 of the
               single-process step's on the same global batch, the replicas
               bit-identical after every step (checksums of every leaf), the
               held-out loss lower after the steps; step p50, the gradient
               all-reduce's ms and bytes (one a step, f32, through the host:
               gloo) and each rank's peak bytes; ``compressed_psum`` over a
               gradient-sized tensor within 2.5 int8 steps of the mean;
               the state rank 0 wrote restored at world 1 bit for bit
               (``restore(shardings=)``) and stepped on; then those weights
               served through K7, K1 and K2 as in phase train.  Two ranks
               sharing one card measure correctness and host traffic, not a
               speed-up;
14. persist    the main index saved and loaded through the facade: every
               array identical, the same batch gives identical pids;
15. profile    device time of one plaid-cuda batch, one vanilla batch and
               one B=32 query encode by kernel (torch.profiler) and the
               device's busy share of each;
16. lm         serving the LM family (``models.transformer``: ``prefill``
               and ``decode_step`` with a KV cache), the index freed first,
               one ``lm`` line a config (``LM_RUNS``): yi-34b at full width
               with 16 of 60 layers (prefill B 1 x 32,768 through K7, decode
               B 8 on a 32,768-slot cache at cache_len 32,767),
               h2o-danube-3-4b whole (prefill B 1 x 8,192, chunked sliding
               window, no kernel; decode B 1 on a 4,096-slot ring at
               cache_len 524,287), granite-moe-1b-a400m whole (prefill B 8
               x 4,096 through K7 and the MoE dispatch, decode B 32) and
               deepseek-moe-16b at full width with 4 of 28 layers (prefill
               B 1 x 4,096, decode B 32); bf16 weights seeded on the card a
               tensor at a time.  Each: K7 on layer 0's q/k/v against its
               plain version; prefill ms (median of 3 after a warm-up)
               beside the bf16 FLOP bound (the reference's model FLOPs at
               989 TFLOP/s, less the embedding and all but the last
               position's head), K7's launches, peak bytes; the K7 model's
               last-position logits against chunked attention's at S 4,096
               (cosine, error share, equal argmax); decode == prefill at B
               2, S 64; decode-step ms (median of 20) beside (weight +
               cache bytes) / 3.35 TB/s, kernel launches a step, peak
               bytes; bf16 decode attention on layer 0's cache against the
               host's f32 products (scalar and per-row lengths); h2o's ring against the same entries rotated into
               slots by position; MoE expert loads and dropped share;
17. lm_train   LM training on the card, one ``lm_train`` line a run: (1)
               ``launch.train.run`` in-process at the reference's defaults
               for granite-moe-1b-a400m (the full config in f32, B 8 x 64
               tokens, 30 steps, 20 warm-up; every loss finite, the last
               below the first; its final checkpoint written); (2) the
               trained weights served: granite-moe-1b's prefill (B 8 x
               4,096) of them in bf16 through K7 against chunked attention
               with the K7 run's routing replayed, as phase lm checks it;
               (3) the ``train_4k`` cell at full width (seq 4,096; for
               time, the global batch cut 256 -> 4 and ``n_micro`` 8 -> 2,
               2 rows x 4,096 a microbatch; the cell's donating step from
               ``cells._train_pieces``: bf16 products over f32 weights,
               ``_default_optimizer``)
               for granite-moe-1b whole, h2o-danube-3-4b with 12 of 24
               layers and deepseek-moe-16b with 4 of 28 (``LM_TRAIN_RUNS``):
               one warm-up and 3 timed steps, step p50 ms, tokens/s, ``mfu``
               (the reference's model FLOPs at 989 TFLOP/s), peak bytes,
               kernel launches a step (the warm-up under torch.profiler),
               the MoE dropped share, finite losses; (4) card against host
               at reduced width: one ``n_micro`` 2 f32 step of each of the
               five reduced configs from the same weights and batch, losses
               rtol 1e-5, parameters rtol 1e-4 / atol 1e-6 but for a
               thousandth of them, each within 2 lr.  Only (2) launches a
               port kernel (K7); training runs none.
18. lm_tp      the ``"model"`` mesh axis: two gloo ranks sharing
               ``cuda:0`` on a 1 x 2 ``("data", "model")`` mesh (NCCL
               refuses two ranks on one card), each holding its slice of
               every weight.  Each check first runs the one-process port on
               the card with the same seeded weights and inputs, keeps the
               results on the host and frees the card; the ranks then run
               it once: (a) granite-34b at full width, 4 of 88 layers (48
               heads over one KV head: 24 heads a rank, the cache
               sequence-sharded, 4,096 of 8,192 slots a rank), prefill 1 x
               4,096 through K7, 16 decode steps at B 8 from slot 8,176;
               (b) granite-moe-1b-a400m whole (16 experts and 4 of 8 KV
               heads a rank, the cache head-sharded), prefill B 8 x 4,096
               through K7, 16 decode steps at B 32 from slot 4,080, the
               one-process run's expert choices replayed (one bf16 rounding
               flips near-tied choices); every prefill row's logits against
               the one-process run's (cosine >= 0.9999, max |diff| <= 2% of
               the largest |logit|); the decode steps in bf16 (timed) and
               again in f32 from the same bf16 weights and cache on the bf16
               steps' expert choices, every row against the one-process f32
               run's (LM_F32_*: cosine >= 0.99999, max |diff| <= 0.1%); in
               bf16 the one-process port is itself ~0.9999 / 1.6% from its
               own f32 steps on granite-34b, so the ranks' bf16 steps are
               held to at most LM_TP_BF16_SPREAD times that distance from
               the f32 steps (1 - cosine and the |diff| share); layer 0's
               gathered bf16 cache bit for bit, K7 launched on each rank; (c)
               ``launch.train --mesh single --model 2`` for granite-moe-1b
               whole in f32 at the reference's defaults (B 8 x 64), 5
               steps, each loss within 1e-4 of the one-process run's, the
               replicated leaves bit-identical on both ranks (checkpoint
               writes skipped for time on both sides; the CPU tests hold
               them).  Then ColBERTv2 at full width (12 layers, 48 padded
               heads: 24 over 6 a rank): (a) 256 passages of 180 tokens in
               encodes of 64 and 32 queries of 32 through K7, every
               vector within cosine LM_TP_COS_MIN of the one process's
               and, against the one process's f32 twin, within
               LM_TP_BF16_SPREAD of its own bf16 distance; (b) 3
               AdamW steps of the train_triples cell (B 8, nway 4, q 32, d
               180, n_micro 1) in f32, losses within LM_TP_LOSS_RTOL and
               the stepped weights held as phase family_mesh holds them
               (params_agree); (c) one int8 step the same way; (d)
               ``launch.train --arch plaid-colbertv2 --mesh single --model
               2`` (3 steps in bf16, the first loss within DP_LOSS_RTOL
               as phase train_dp holds its bf16 ranks).  Step ms, encode
               ms, the
               collectives' ms and bytes (host traffic under gloo) and peak
               bytes a rank.
19. recsys     the recsys family, PLAID as an item index and SchNet, one
               ``recsys`` line a run: (a) wide-deep, xDeepFM, BST and
               BERT4Rec at full width, each through ``launch.train``'s
               weights, batches and donating AdamW step (``data_for``; the
               ``train_batch`` cell's B 65,536 in 4 microbatches, one
               warm-up and RECSYS_TRAIN_TIMED timed steps): step p50,
               examples/s, peak bytes; then ``serve_p99`` (B 512),
               ``serve_bulk`` (B 262,144) and ``retrieval_cand`` (1M
               candidates, top 100) through their cells' callables on the
               trained weights, p50 ms, the top-k positions identical to a
               stable sort of the same scores.  Cuts, each with its bytes
               (RECSYS_CUTS, ``recsys_cut_bytes``): BERT4Rec's train batch
               64 (its (B, 60, 1,000,002) f32 logits take 240 MB a row) and
               serve_bulk 32,768 (its attention scores, 320 KB a row);
               xDeepFM's serve_bulk and retrieval_cand 65,536 (the CIN's
               (B, 200, 39, 10) product, 312 KB a row).  Then each reduced
               config's step on the card against the host's.  (b) PLAID as
               an item index over BERT4Rec's 1,000,002 x 64 item table
               (``core.item_retrieval``): build seconds and K; 32 user
               states (the encoder's last position) at k 100 with the
               reference's settings and at nprobe 64: ``impl="cuda"`` (K1,
               K2) pids and scores identical to ``impl="ref"``, recall@100
               against brute force over the reconstructed and the exact
               rows, p50 ms, K1/K2 launches a batch; K1 and K2 at these
               shapes (nq 1, d 64, one-token documents) bit for bit against
               their plain versions.  (c) SchNet at full width through its
               cells' donating step: ``molecule`` (128 molecules of 30
               atoms), ``full_graph_sm`` (2,708 nodes, 10,556 edges, d_feat
               1,433) and ``minibatch_lg`` (the host sampler's fanout (15,
               10) block of the 232,965-node, 114.6M-edge graph, drawn in a
               process of its own from the script's start): step ms, peak
               bytes; ``ogb_products`` is skipped with its reckoning (its
               (61.9M, 300) f32 radial basis alone is 74.2 GB).
20. cells      the retrieval family's cells (``launch.cells.
               retrieval_cell``) at full width, one ``cells`` line each:
               ``train_triples`` (B 256 in 8 microbatches, a warm-up and 2
               timed steps: step ms, tokens/s, ``mfu``, peak bytes, finite
               losses); ``encode_corpus`` (4,096 x 180 tokens through K7:
               p50, tokens/s, K7's launches an encode, then K7 at this
               shape against its plain version, FLASH_TOL); ``search_9m``
               and ``search_140m`` (one shard each: the index built as the
               reference builds it, ``search_140m``'s corpus drawn in a
               process of its own from the script's start; 32 queries x 32
               tokens at k 100 through ``impl="cuda"`` and ``"ref"`` on the
               card, pids and scores identical; build s, p50, K1 / K2
               launches a batch, K1 and K2 at these shapes bit for bit
               against their plain versions).  Then the dry sweep:
               ``launch.dryrun --all --both-meshes`` in a subprocess that
               sees no card, within 60 s; one ``dry_sweep`` line (the ok /
               skip / fail tally, each fail with its ROADMAP item, the LM
               train cells' per-rank bytes beside the rules' plan); every
               LM, recsys, SchNet and search record ``ok``, every fail an
               item-named ``NotImplementedError``.
21. family_mesh the recsys family and SchNet over processes: two gloo
               ranks sharing ``cuda:0`` on a 1 x 2 ``("data", "model")``
               mesh (NCCL refuses two ranks on one card), each holding its
               piece of every split leaf (the tables by rows, BERT4Rec's
               1,000,002 items too; the dense layers by ``"mlp"``).  Each
               check first runs the one-process port on the card from the
               same seeded weights and inputs, keeps its results on the
               host (the stepped weights as .npy files) and frees the
               card; the ranks then run it once, through the cells' own
               callables (``recsys_cell`` / ``gnn_cell`` with ``mesh=``):
               (a) the four recsys archs at full width: ``train_batch``
               (n_micro 4; one warm-up and FAMILY_MESH_TIMED timed steps of
               one batch), each loss within LM_TP_LOSS_RTOL of the one
               process's, the replicated leaves bit-identical on both
               ranks, the stepped weights within FAMILY_MESH_PARAM_TOL of
               the one process's but for at most FAMILY_MESH_OUTLIER_SHARE
               of them, each within ``adam_flip_bound`` (AdamW turns
               where a gradient element is within a few eps of 0);
               ``serve_p99`` (B 512) scores and ``retrieval_cand`` top-100
               scores within FAMILY_MESH_SCORE_RTOL, its positions
               identical wherever neighbouring scores differ by more than
               that (``topk_agree``).  Cuts (values only, never a width),
               each listed in its line: RECSYS_CUTS' for memory (BERT4Rec
               train B 64) and FAMILY_MESH_CUTS' for time (the ranks'
               collectives cross the host: wide-deep, xDeepFM and BST
               train B 16,384, wide-deep and BST 65,536 candidates) and
               memory (xDeepFM 32,768 candidates: each rank builds the
               whole CIN product, 312 KB a row, beside the other rank).  (b) SchNet's ``molecule``, ``full_graph_sm``
               and ``minibatch_lg`` (phase recsys's sampled block): one
               step each, the edges split in two, loss and weights held as
               in (a).  (c) Each ``family_mesh`` line: step ms a rank,
               examples/s, peak bytes a rank beside the one process's, and
               the collectives' calls, bytes and ms (host traffic under
               gloo).  Launches no port kernel; budget 150 s.

Then the ``{"kernels": [...]}`` line, the card's nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))
# Copied out of the repository, the script stops here (no package).
from repro_torch import build, configs, ieee_f32_matmul, live, retrieval, serving  # noqa: E402
from repro_torch.configs import colbertv2 as colbert_cfg  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.core import engine_sharded, indexer, item_retrieval  # noqa: E402
from repro_torch.core import kmeans, pipeline, plaid, scoring, vanilla  # noqa: E402
from repro_torch.core import residual_codec as rc  # noqa: E402
from repro_torch.core import tiered as tiered_mod  # noqa: E402
from repro_torch.data import graphs, synthetic  # noqa: E402
from repro_torch.distributed import compression as dist_comp  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.topk import local_to_global_pids, merge_topk  # noqa: E402
from repro_torch.eval import qrels as eval_qrels, sweep as eval_sweep  # noqa: E402
from repro_torch.exec import segments as seg_exec  # noqa: E402
from repro_torch.exec.segments import pow2_bucket  # noqa: E402
from repro_torch.exec.sharded import clamp_to_shard, place_shards  # noqa: E402
from repro_torch.exec.tiered import partition_tiered  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import costs as kcosts  # noqa: E402
from repro_torch.kernels.costs import tiered_transfer_cost  # noqa: E402
from repro_torch.launch import cells as cells_mod  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import colbert, recsys, schnet, transformer  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.obs.funnel import FunnelStats  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serving import buckets as serve_buckets_mod  # noqa: E402
from repro_torch.serving import server as serve_server  # noqa: E402
from repro_torch.training import checkpoint as train_ckpt  # noqa: E402
from repro_torch.training import fault_tolerance as ft  # noqa: E402
from repro_torch.training import loop as train_loop  # noqa: E402
from repro_torch.training import optimizer as train_opt  # noqa: E402
from repro_torch.training import tree as train_tree  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense

NBITS, DIM, NQ, BATCH = 2, 128, 32, 32
TIMED_BATCHES = 4  # per (k, fused), after one warm-up batch
SEARCH_KERNELS = ("centroid_interaction_batched", "decompress_and_score_batched",
                  "gather_decompress_maxsim")
VANILLA_BATCHES = 3  # one warm-up, two timed
ORACLE_QUERIES = 8
#: the reference's vanilla_p4_c8192 (benchmarks/table3_endtoend.py:25-31)
VANILLA_SETTINGS = dict(nprobe=4, candidate_cap=2**13, ndocs=4096)
#: kernels held bit for bit against their plain versions
BIT_EXACT = ("centroid_interaction_batched", "decompress_residuals",
             "decompress_and_score_batched", "gather_decompress_maxsim",
             "centroid_interaction", "decompress_and_score")
#: kernel -> (its CUDA source, the TPU kernel it replaces)
REPLACES = {
    "centroid_interaction_batched": ("src/repro_torch/csrc/maxsim.cu", "src/repro/kernels/maxsim.py:110"),
    "decompress_and_score_batched": ("src/repro_torch/csrc/decompress.cu", "src/repro/kernels/decompress.py:205"),
    "gather_decompress_maxsim": ("src/repro_torch/csrc/fused_score.cu", "src/repro/kernels/fused_score.py:79"),
    "decompress_residuals": ("src/repro_torch/csrc/decompress.cu", "src/repro/kernels/decompress.py:54"),
    "centroid_interaction": ("src/repro_torch/csrc/maxsim.cu", "src/repro/kernels/maxsim.py:48"),
    "decompress_and_score": ("src/repro_torch/csrc/decompress.cu", "src/repro/kernels/decompress.py:119"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:86"),
}
#: substrings of the port's kernel names in a profile (profile_batch's "port")
PORT_KERNEL_KEYS = ("interaction", "score_kernel", "decompress_residuals", "flash_attention")
ENCODE_PASSAGES, DOC_MAXLEN, ENCODE_BATCH = 8192, 180, 64
#: the streaming build: one LoTTE topic's corpus (250k passages, ~23.5M
#: tokens) in chunks of 16,384 passages; ~1M tokens for the determinism
#: check; 2,048 encoded passages for build_from_encoder
STREAM_PASSAGES, STREAM_CHUNK_DOCS = 250_000, 16_384
DETERMINISM_PASSAGES, ENCODER_BUILD_PASSAGES = 10_640, 2048
#: phase quality: the sweep's corpus and queries (embedding_corpus, 8..180
#: tokens), the certification's.  16 passages a topic (the reference's
#: 96-passage harness has 12): at the default 32 topics a query would judge
#: 2,048 passages relevant and recall@10 could not pass ~0.005
QUALITY_PASSAGES, QUALITY_QUERIES = 1 << 16, 64
CERT_PASSAGES, CERT_QUERIES = 4096, 32
PASSAGES_PER_TOPIC = 16
#: phase quality: sweep points past ``default_grid`` whose ndocs sit below
#: the stage-1 candidates a query of that corpus gathers (~640 at nprobe 3,
#: ~1,850 at 8) and below their pow2 bucket, so that the ndocs_t / n3_t
#: masks cut real candidates; default_grid's ndocs (n/8 and up) exceed them
CAP_GRID_NPROBES, CAP_GRID_NDOCS = (3, 8), (12, 40, 100, 300)
#: phase quality: certification scores, a variant against the baseline and
#: vanilla against its plain version
CERT_SCORE_ATOL = 1e-5
FUNNEL_PAIRS = 4  # funnel off/on timing pairs per k, interleaved
#: phase live: three delta segments of unequal sizes (the delta group's
#: clamp basis is the largest), 1% of the base and 100 of the first delta
#: tombstoned, live-cuda vs plaid-cuda timing pairs per k
LIVE_DELTAS = (4096, 1000, 333)
LIVE_BASE_DELETES, LIVE_DELTA_DELETES = 20_000, 100
LIVE_PAIRS = 4
#: phase tiered: Table 2's k, plaid-tiered-cuda vs plaid-cuda timing pairs
#: per k, batch splits per k, and the device sleep (~0.1 s) queued on the
#: copy stream before each copy of the ring check
TIERED_KS = (10, 100, 1000)
TIERED_PAIRS, TIERED_SPLITS = 4, 3
RING_SLEEP_CYCLES = 200_000_000
#: phase serve: the server's cap and wait, coalesced batches of these sizes
#: (buckets 1 / 4 / 8 / 32 / 32) with per-request t_cs and k from these
#: grids; the load (client threads, distinct seeded queries, requests,
#: rounds), the lone client's requests, the cache's queries, the live
#: stress (client threads, their query pool, the least requests a client
#: makes, mutator cycles) and the tiered requests
SERVE_BATCH, SERVE_WAIT_MS = 32, 2.0
SERVE_BUCKET_NS = (1, 3, 5, 17, 32)
SERVE_T_CS, SERVE_KS = (0.4, 0.5, 0.6), (1, 5, 10)
SERVE_CLIENTS, SERVE_POOL, SERVE_REQUESTS, SERVE_ROUNDS = 64, 2048, 2048, 2
SERVE_LONE, SERVE_CACHE = 64, 256
SERVE_LIVE_CLIENTS, SERVE_LIVE_QUERIES, SERVE_LIVE_MIN, SERVE_LIVE_CYCLES = 8, 16, 8, 3
SERVE_TIERED = 40
#: phase sharded: plaid-sharded vs plaid-cuda timing pairs, the reduced
#: build (passages, centroids, chunk), the gloo ranks and their join limit
SHARD_PAIRS = 4
SHARD_BUILD_PASSAGES, SHARD_BUILD_K, SHARD_BUILD_CHUNK = 1 << 16, 1 << 12, 8192
GLOO_RANKS, GLOO_JOIN_S = 2, 300
#: phase train: ColBERTv2's training batch (B queries of NQ = 32 tokens and
#: nway = 4 passages of DOC_MAXLEN = 180 a query: ColBERTv2's query and
#: document max lengths) for one warm-up and TRAIN_STEPS timed steps on the
#: cosine schedule (TRAIN_LR peak, 2 warm-up steps: at launch/train.py's
#: 3e-4 the loss of this temperature-free MaxSim objective climbed far
#: above its start before it settled); the int8 and restart runs' smaller batch and
#: the int8 run's steps; the corpus the trained weights encode and serve
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 32, 20, 1e-5
TRAIN_SMALL_BATCH, INT8_STEPS = 8, 20
HELD_OUT_BATCHES = 4  # fixed B=32 batches the loss is judged on, before and after
TRAIN_SERVE_PASSAGES = 4096
#: (k, nprobe) of the train phase's wide probes, and the share of result
#: slots that must hold a pid there: the paper's nprobe (1, 2) fills few
#: slots on these weights (see train_phase), so plaid-cuda is held to plaid
#: on probes wide enough that stage 1 yields k passages a query
WIDE_PROBES, WIDE_FILLED_MIN = ((10, 64), (100, 256)), 0.9
#: phase serve_driver: launch.serve's flags beyond its defaults (20,000
#: documents, 256 queries in batches of 16, k 10, d 128, nbits 2)
SERVE_DRIVER_FLAGS = ["--compare-vanilla", "--sweep-t-cs", "--device", "cuda"]
#: phase train_dp: the global batch (TRAIN_BATCH) over GLOO_RANKS ranks on
#: the card, DP_STEPS steps a case at phase train's peak lr, the cases
#: (n_micro, compression), and the bar of the first step's loss against the
#: single-process step (bf16 products over half the rows round apart)
DP_STEPS = 3
DP_CASES = {"plain": (1, None), "micro2": (2, None), "int8": (1, "int8")}
DP_LOSS_RTOL = 1e-3
SLEEP_CYCLES = 2_000_000  # queued before each call device_time_ms times
#: K7 vs plain: f32 sums in another order (64-key tiles vs one tile); bf16
#: outputs one bf16 ulp apart (both round an f32 result once)
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2.0**-7, atol=1e-6)}
#: K7 at the LM prefills (phase lm): B, S, H (padded), Hkv, dh, causal: yi-34b
#: at prefill_32k's length (batch 32 -> 1), granite-34b (MQA, 48 heads over
#: 1), granite-moe-1b (B 8) and deepseek-moe-16b (MHA); fewer timing reps
#: (a 32k call takes tens of ms, its plain version seconds)
LM_FLASH_CASES = [("yi-34b", 1, 32768, 64, 8, 128), ("granite-34b", 1, 4096, 48, 1, 128),
                  ("granite-moe-1b-a400m", 8, 4096, 16, 8, 64),
                  ("deepseek-moe-16b", 1, 4096, 16, 16, 128),
                  # phase lm_tp's per-rank shapes: half the heads a rank
                  ("granite-34b-tp2", 1, 4096, 24, 1, 128),
                  ("granite-moe-1b-a400m-tp2", 8, 4096, 8, 4, 64)]
#: K7 at phase lm_tp's ColBERT rank shape: an encode of ENCODE_BATCH
#: passages, 24 of the 48 padded heads over 6 of the 12 KV heads, not causal
COLBERT_FLASH_CASE = ("colbert-tp2", ENCODE_BATCH, DOC_MAXLEN, 24, 6, 64, False, torch.bfloat16)
LM_FLASH_REPS = 5
#: phase lm: (arch, layers kept or None for all, prefill (B, S), decode (B,
#: the cell's seq_len, cache_len)).  Cuts: yi-34b keeps 16 of 60 layers
#: (bf16 weights: 20.2 GB of 70.5), prefill_32k's batch 32 -> 1, decode_32k's
#: 128 -> 8; deepseek-moe-16b keeps 4 of 28 (the dense first + 3 MoE);
#: h2o-danube-3-4b's prefill is 8,192 tokens (its 4,096 window binds) and
#: its decode long_500k unreduced (a 4,096-slot ring at cache_len 524,287)
LM_RUNS = (
    ("yi-34b", 16, (1, 32768), (8, 32768, 32767)),
    ("h2o-danube-3-4b", None, (1, 8192), (1, 524288, 524287)),
    ("granite-moe-1b-a400m", None, (8, 4096), (32, 4096, 4095)),
    ("deepseek-moe-16b", 4, (1, 4096), (32, 4096, 4095)),
)
LM_CHECK_S = 4096  # K7 model vs chunked attention (32k is too slow in plain torch)
LM_MATCH_B, LM_MATCH_S = 2, 64  # decode == prefill, the reference's own check
LM_PREFILL_REPS, LM_DECODE_REPS = 3, 20
#: a second ring position: its window does not start at slot 0
LM_RING_OFFSET = 1234
#: bf16 logits of K7's model against chunked attention's (two paths that
#: round in different places): per row cosine >= 0.999 and max |diff| <= 2%
#: of the row's largest |logit|
LM_COS_MIN, LM_ERR_SHARE = 0.999, 0.02
#: decode against prefill, and a ring against its rotation, computed in f32
#: from the same bf16 weights (the same values summed in another order):
#: cosine >= 0.99999 and max |diff| <= 0.1% of the row's largest |logit|.
#: In bf16 one rounding flipped by the order grows through the layers (on
#: an H100: yi's 16, 1.3% of the largest logit; h2o's 24 over a rotated
#: ring, 3.1%)
LM_F32_COS_MIN, LM_F32_ERR_SHARE = 0.99999, 1e-3
#: decode attention over a bf16 cache on the card against the host's f32
#: products, both with f32 outputs: max |diff| <= 0.1% of the largest
#: |output|.  In plain torch on a CPU at yi-34b's head layout (32,768 slots,
#: dh 128), f32 against f64 is 1e-4 of it; scores or the output rounded to
#: bf16 before the softmax or the return put it 4.7e-3 and 3.3e-3 away
LM_DECODE_ATTN_ERR_SHARE = 1e-3
#: phase lm_train: (1) launch.train's flags beyond the reference's defaults
#: (its full config in f32, B 8 x 64 tokens, lr 3e-4, 20 warm-up steps);
#: (3) the train_4k cell at full width (seq 4,096) with, for time, the
#: global batch cut 256 -> 4 and n_micro 8 -> 2 (2 rows x 4,096 a
#: microbatch), one warm-up and
#: LM_TRAIN_TIMED timed steps for each (arch, layers kept or None for all):
#: h2o-danube-3-4b keeps 12 of 24 layers and deepseek-moe-16b 4 of 28 (the
#: dense first + 3 MoE), their f32 weights, moments and gradients at ~20
#: bytes a parameter; (4) the card-against-host step's batch and bars
LM_ARCH_IDS = ("h2o-danube-3-4b", "yi-34b", "granite-34b", "granite-moe-1b-a400m",
               "deepseek-moe-16b")
LM_TRAIN_ARGV = ["--arch", "granite-moe-1b-a400m", "--steps", "30"]
LM_TRAIN_RUNS = (("granite-moe-1b-a400m", None), ("h2o-danube-3-4b", 12),
                 ("deepseek-moe-16b", 4))
LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_MICRO, LM_TRAIN_TIMED = 4096, 4, 2, 3
LM_SERVE_BS = (8, 4096)  # the trained granite-moe-1b weights' prefill
LM_HOST_B, LM_HOST_S = 4, 24
LM_HOST_SCHED = dict(peak_lr=1e-3, warmup=2, total=10)
LM_HOST_LOSS_RTOL, LM_HOST_RTOL, LM_HOST_ATOL, LM_HOST_OUTLIERS = 1e-5, 1e-4, 1e-6, 1e-3
#: phase lm_tp: the ranks (a 1 x 2 mesh on cuda:0); (arch, layers kept,
#: prefill (B, S), decode (B, the cache's slots, the first cache_len)),
#: LM_TP_STEPS decode steps each; the bars of the bf16 prefill and (c)'s
#: losses against the one-process run (the decode's are LM_F32_* in f32,
#: and in bf16 LM_TP_BF16_SPREAD: the ranks' distance from the one
#: process's f32 steps at most this multiple of its own bf16 one);
#: launch.train's flags (its defaults: f32, B 8 x 64) for (c)
LM_TP_MODEL = 2
LM_TP_RUNS = (
    ("granite-34b", 4, (1, 4096), (8, 8192, 8176)),
    ("granite-moe-1b-a400m", None, (8, 4096), (32, 4096, 4080)),
)
LM_TP_STEPS = 16
LM_TP_COS_MIN, LM_TP_ERR_SHARE, LM_TP_LOSS_RTOL = 0.9999, 0.02, 1e-4
LM_TP_BF16_SPREAD = 2.0
LM_TP_TRAIN_ARGV = ["--arch", "granite-moe-1b-a400m", "--steps", "5"]
#: phase lm_tp's ColBERT runs at the full config's widths (12 layers, d 768,
#: 48 padded heads: 24 over 6 KV heads a rank; the vocabulary split in two),
#: cut for time (each layer's two all-reduces cross the host): (a)
#: COLBERT_TP_PASSAGES passages of DOC_MAXLEN tokens (encode_corpus' 4,096
#: -> 256) in encodes of ENCODE_BATCH, and COLBERT_TP_QUERIES queries of NQ
#: tokens, through K7; (b) COLBERT_TP_STEPS AdamW steps of train_triples
#: (nway 4, q NQ, d DOC_MAXLEN; the batch 256 -> 8, n_micro 8 -> 1) in f32,
#: the precision of the LM_TP_LOSS_RTOL bar; (c) one int8 step of the same
#: batch from the seeded weights; (d) launch.train's flags: the full config
#: in its bf16 compute dtype, so its first loss is held at DP_LOSS_RTOL, as
#: phase train_dp holds its bf16 ranks' first losses (later ones follow
#: AdamW steps taken on bf16 gradients rounded in other places: on an H100
#: the second loss of 3 moved 1.3e-3 apart).  (a)'s vectors are held to the one
#: process's by cosine (LM_TP_COS_MIN) and to its f32 twin by the spread
#: (LM_TP_BF16_SPREAD, cosine gap and |diff| share): a unit vector's
#: largest |diff| share is not LM_TP_ERR_SHARE's, made for logit rows (on
#: an H100 the one process's own bf16 vectors are 2.6% of the largest
#: element from its f32 twin's)
COLBERT_TP_PASSAGES, COLBERT_TP_QUERIES = 256, 32
COLBERT_TP_TRAIN = dict(global_batch=8, q_len=NQ, d_len=DOC_MAXLEN, nway=4, n_micro=1)
COLBERT_TP_STEPS = 3
COLBERT_TP_TRAIN_ARGV = ["--arch", "plaid-colbertv2", "--steps", "3"]
#: the reference's flash test shapes (tests/test_flash_attention.py:10-18):
#: B, S, H, Hkv, dh, causal
JAX_FLASH_SHAPES = [(2, 64, 4, 2, 16, True), (1, 128, 8, 1, 32, True),
                    (2, 64, 4, 4, 16, False), (1, 96, 6, 2, 8, True)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times a phase and prints its JSON line when the block ends cleanly."""

    def __init__(self, name: str):
        self.name, self.info = name, {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self.info

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name, "seconds": time.perf_counter() - self.t0, **self.info})
        return False


# --------------------------------------------------------------------------
# synthetic corpus
# --------------------------------------------------------------------------
def synth_index(*, passages, seed, n_centroids=None, maxlen=180):
    """Topic-structured corpus on the card: each passage draws its codes
    from its topic's pool of centroids; residual bytes are uniform (valid
    at any nbits); the codec tables are normal quantiles at
    sigma = 0.35 / sqrt(d).  K follows ColBERTv2's rule unless
    ``n_centroids`` is given.  No k-means (that is the build slice's)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    lens = torch.normal(70.0, 40.0, (passages,), generator=g, device=dev)
    lens = lens.round().clamp(8, maxlen).to(torch.int32)
    lens[0] = maxlen
    nt = int(lens.long().sum())
    K = n_centroids or kmeans.num_centroids_for(nt)
    cents = torch.randn(K, DIM, generator=g, device=dev)
    cents = cents / cents.norm(dim=1, keepdim=True)
    n_topics, pool = max(K // 32, 4), 64
    pools = torch.randint(0, K, (n_topics, pool), generator=g, device=dev)
    doc_topic = torch.randint(0, n_topics, (passages,), generator=g, device=dev)
    tok_topic = torch.repeat_interleave(doc_topic, lens.long())
    pick = torch.randint(0, pool, (nt,), generator=g, device=dev)
    codes = pools[tok_topic, pick].to(torch.int32)
    del tok_topic, pick
    residuals = torch.randint(
        0, 256, (nt, DIM * NBITS // 8), generator=g, device=dev, dtype=torch.uint8
    )
    nb = 2**NBITS
    sigma = 0.35 / math.sqrt(DIM)
    cut_q = torch.arange(1, nb, device=dev, dtype=torch.float64) / nb
    w_q = (torch.arange(nb, device=dev, dtype=torch.float64) + 0.5) / nb
    index = index_mod.assemble_index(
        cents, codes, residuals, lens,
        cutoffs=(sigma * torch.special.ndtri(cut_q)).float(),
        weights=(sigma * torch.special.ndtri(w_q)).float(),
        nbits=NBITS, device=dev,
    )
    return index


def synth_queries(index, n, seed):
    """Noisy, renormalized reconstructions of NQ tokens of a chosen passage
    each; returns (queries (n, NQ, d), source pids (n,))."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    src = torch.randint(0, index.num_passages, (n,), generator=g, device="cuda")
    lens = index.doc_lens[src].long()
    pos = (torch.rand(n, NQ, generator=g, device="cuda") * lens[:, None]).long()
    tok = index.doc_offsets[src].long()[:, None] + pos
    q = index.reconstruct_tokens(tok)
    q = q + 0.1 / math.sqrt(DIM) * torch.randn(q.shape, generator=g, device="cuda")
    return q / q.norm(dim=-1, keepdim=True), src.to(torch.int32)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------
def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` calls, each between two CUDA events: the call's
    device time plus whatever part of its host work the device waits for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """As ``time_ms``, with a device sleep of ~1 ms (``SLEEP_CYCLES``)
    queued before the start event: the device is still asleep while the
    host submits the call, so the events time the call's device work
    alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, reps: int, warmup: int = 2) -> float:
    """Median host time of one call on an idle device, from entry to return
    (argument checks, launch set-up and submission; no synchronize)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def n_unique(x) -> int:
    return int(torch.unique(x).numel())


def k1_bound(s_cq, codes, keep):
    """K1/K5 (``costs.centroid_interaction_batched_cost``): every code slot
    (pads too), each distinct kept score row and each distinct keep flag
    (none for a null keep) once, q_mask and the output; one max per (kept
    token, query) and the query sum."""
    B, K, nq = s_cq.shape
    nd, L = codes.shape[1:]
    valid = codes >= 0
    lane = torch.arange(B, device=codes.device)[:, None, None]
    safe = torch.where(valid, codes, 0).long()
    kept = valid if keep is None else valid & keep[lane, safe]
    c = kcosts.centroid_interaction_batched_cost(
        B=B, nd=nd, L=L, K=K, nq=nq,
        rows=n_unique((lane * K + safe)[kept]),  # distinct score rows read
        flags=0 if keep is None else n_unique((lane * K + safe)[valid]),  # keep flags read
        kept=int(kept.sum()))
    return bound(c["hbm_bytes"], c["bound_ops"])


def k1_stage3_check(s_cq, codes3, qm) -> dict:
    """K1 at stage 3's shape (the ndocs survivors, keep null), bit for bit
    against its plain version, timed as the kernels phase times.  Its rows
    are gathered for every valid token, so beside the bound (distinct bytes
    at the memory rate) it reports the bytes of those gathers, which the
    SMs take in from L1/L2."""
    def kern():
        return ops.centroid_interaction_batched(s_cq, codes3, qm, None)

    def plain():
        return ref.centroid_interaction_batched_ref(s_cq, codes3, None, qm)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    valid = int((codes3 >= 0).sum())
    bound_ms, bound_by = k1_bound(s_cq, codes3, None)
    row = dict(equal=torch.equal(got, want), max_abs_err=float((got - want).abs().max()),
               ms=time_ms(kern, reps=25), device_ms=device_time_ms(kern, reps=25),
               host_us=host_us(kern, reps=25), plain_ms=time_ms(plain, reps=3),
               bound_ms=bound_ms, bound_by=bound_by, valid_tokens=valid, gathered_row_bytes=valid * NQ * 4,
               shape=dict(B=codes3.shape[0], nd=codes3.shape[1], L=codes3.shape[2],
                          K=s_cq.shape[1], nq=NQ))
    emit({"kernel_check": "centroid_interaction_batched", "case": "stage3", **row})
    assert row["equal"], "K1 stage-3 shape"
    return row


def k4_bound(n_bytes, nbits):
    """K4 (``costs.decompress_residuals_cost``): each packed byte read once,
    its 8/nbits f32 fields written once; no arithmetic (a lookup)."""
    return bound(kcosts.decompress_residuals_cost(n=n_bytes, pd=1, nbits=nbits)["hbm_bytes"], 0.0)


def k2_bound(codes4, valid4, nq, d, pd, K):
    """K2/K6 (``costs.decompress_and_score_batched_cost``) over (B, nd, L)
    blocks: the valid tokens' codes and payload bytes, each distinct
    centroid row once, the queries, every slot's validity flag and the
    output; 2*nq*d + nq operations a valid token."""
    B, nd, L = codes4.shape
    c = kcosts.decompress_and_score_batched_cost(
        B=B, nd=nd, L=L, pd=pd, K=K, d=d, nq=nq, nbits=8 * pd // d,
        tokens=int(valid4.sum()), rows=n_unique(codes4[valid4]))
    return bound(c["hbm_bytes"], c["bound_ops"])


def k3_bound(final_pids, codes_valid, nq, d, pd, K):
    """K3 (``costs.gather_decompress_maxsim_cost``): K2's bytes read from
    the CSR arrays, plus each finalist's pid, start and length."""
    B, n3 = final_pids.shape
    c = kcosts.gather_decompress_maxsim_cost(
        B=B, n3=n3, L=1, pd=pd, K=K, d=d, nq=nq, nbits=8 * pd // d,
        tokens=codes_valid.numel(), rows=n_unique(codes_valid))
    return bound(c["hbm_bytes"], c["bound_ops"])


def contract_bound_ms(n_tokens, nq, d) -> float:
    """K2/K3/K6 under the shared-order contract: no FMA, so each of the
    nq*d terms of a token is a rounded multiply and a rounded add, two
    instructions on the FP32 pipes, each at half the 67 TFLOP/s (which
    counts an FMA as two operations): twice the operations bound."""
    return 2.0 * n_tokens * nq * d / (F32_FLOPS / 2) * 1e3


def score_occupancy(nq, d, L) -> dict:
    """Blocks of K2's and K3's nbits-2 body an SM holds at the G the main
    path picks (the occupancy API, through the kernels' libraries)."""
    from repro_torch.kernels import decompress as dec

    g2, g3 = dec.passages_per_block(BATCH, 1024, L), dec.passages_per_block(BATCH, 1024)
    return dict(
        G_k2=g2, k2=_build.load("decompress").plaid_decompress_score_blocks_per_sm(nq, d, g2, L),
        G_k3=g3, k3=_build.load("fused_score").plaid_gather_maxsim_blocks_per_sm(nq, d, g3, 0))


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passages", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a GPU")

    torch.manual_seed(args.seed)
    dev = torch.device("cuda", 0)

    # ---- 1. environment ---------------------------------------------------
    with Phase("env") as info:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        info.update(
            python=sys.version.split()[0], torch=torch.__version__,
            cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
            device_count=torch.cuda.device_count(), nvidia_smi=smi,
            allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        )
    assert not torch.backends.cuda.matmul.allow_tf32

    # ---- 2. build ---------------------------------------------------------
    with Phase("build") as info:
        libs = _build.build_all()
        info["libraries"] = {k: str(v.relative_to(SRC.parent)) for k, v in libs.items()}
        info["ptxas"] = {
            k: [ln.strip() for ln in log.splitlines()
                if any(t in ln for t in ("entry function", "registers", "spill"))]
            for k, log in _build.BUILD_LOGS.items()
        }

    # phase recsys's minibatch_lg block: the host sampler over a 114.6M-edge
    # graph runs in a process of its own while the earlier phases run
    gnn_job = start_gnn_block()
    # phase cells' search_140m corpus: ~9.8M tokens of per-passage numpy draws
    corpus_job = start_search_corpus()

    # ---- 3. index ---------------------------------------------------------
    with Phase("index") as info:
        index = synth_index(passages=args.passages, seed=args.seed)
        torch.cuda.synchronize()
        info.update(
            passages=index.num_passages, tokens=index.num_tokens,
            centroids=index.num_centroids, dim=index.dim, nbits=index.nbits,
            doc_maxlen=index.doc_maxlen, ivf_list_cap=index.ivf_list_cap,
            mean_doc_len=index.num_tokens / index.num_passages,
            bytes=index.nbytes(), total_bytes=sum(index.nbytes().values()),
        )
    with Phase("codec_roundtrip") as info:
        n = min(1 << 20, index.num_tokens)
        codec = index.codec
        x = rc.decompress(codec, index.codes[:n], index.residuals[:n], index.centroids)
        codes2, packed2 = [], []
        for c0 in range(0, n, 2048):
            c, p = rc.compress(codec, x[c0 : c0 + 2048], index.centroids)
            codes2.append(c)
            packed2.append(p)
        codes2, packed2 = torch.cat(codes2), torch.cat(packed2)
        same = codes2 == index.codes[:n]
        exact = (packed2 == index.residuals[:n]).all(dim=1) & same
        info.update(tokens=n, codes_match=float(same.float().mean()),
                    payload_match=float(exact.float().mean()))
        assert info["codes_match"] >= 0.99 and info["payload_match"] >= 0.99, info
        del x, codes2, packed2

    qs_all, src_all = synth_queries(index, BATCH * (TIMED_BATCHES + 1), args.seed)
    batches = [
        (qs_all[i * BATCH : (i + 1) * BATCH], src_all[i * BATCH : (i + 1) * BATCH])
        for i in range(TIMED_BATCHES + 1)
    ]
    qm = torch.ones(BATCH, NQ, device=dev)

    # ---- 4. independent reference on a small index ------------------------
    with Phase("reference") as info:
        small = synth_index(passages=3000, n_centroids=1024, seed=args.seed + 7)
        sq, _ = synth_queries(small, 8, args.seed + 7)
        lossless = retrieval.SearchParams(
            k=10, nprobe=small.num_centroids, ndocs=small.num_passages,
            candidate_cap=small.num_passages, t_cs=-1e9,
        )
        got = retrieval.from_index(small, backend="plaid-cuda", params=lossless).search_batch(sq)
        # brute force: every passage decompressed, exact MaxSim, plain einsum
        L = small.doc_maxlen
        allp = torch.arange(small.num_passages, device=dev, dtype=torch.int32)
        cb, valid = scoring.gather_doc_tokens(small.codes, small.doc_offsets, small.doc_lens, allp, L, -1)
        rb, _ = scoring.gather_doc_tokens(small.residuals, small.doc_offsets, small.doc_lens, allp, L, 0)
        emb = rc.decompress(small.codec, cb.clamp(min=0), rb, small.centroids)
        exact = torch.stack([scoring.maxsim(q, emb, d_mask=valid) for q in sq])
        want_s, want_p = torch.topk(exact, 10, dim=1)
        recall = float((got.pids[:, :, None] == want_p[:, None, :]).any(-1).float().mean())
        info.update(recall_at_10=recall,
                    max_abs_score_err=float((got.scores - want_s).abs().max()))
        assert recall >= 0.99 and info["max_abs_score_err"] < 1e-3, info

    # ---- 5. kernels against their plain versions --------------------------
    kernels = {}
    p1000 = plaid.clamp_params(plaid.params_for_k(1000), index.num_passages)
    with Phase("kernels") as info:
        qb = batches[0][0].contiguous()
        s_cq = pipeline.stage1_scores_batched(index, qb)
        cands = pipeline.candidate_generation_batched(index, s_cq, p1000.nprobe, p1000.candidate_cap)
        keep = scoring.prune_mask(s_cq, p1000.t_cs)
        codes_blk, _ = pipeline.gather_candidate_tokens_shared(index, cands)
        final_pids, codes4, valid4, _ = pipeline.select_finalists_impl(
            index, qb, qm, p1000.t_cs, params=p1000
        )
        res4, _ = scoring.gather_doc_tokens(
            index.residuals, index.doc_offsets, index.doc_lens,
            final_pids.reshape(-1), index.doc_maxlen, fill=0,
        )
        res4 = res4.reshape(*codes4.shape, -1)
        shape = dict(B=BATCH, nq=NQ, d=DIM, pd=res4.shape[-1])
        cases = {
            "centroid_interaction_batched": (
                lambda: ops.centroid_interaction_batched(s_cq, codes_blk, qm, keep),
                lambda: ref.centroid_interaction_batched_ref(s_cq, codes_blk, keep, qm),
                k1_bound(s_cq, codes_blk, keep),
                dict(shape, nd=codes_blk.shape[1], L=codes_blk.shape[2], K=s_cq.shape[1]),
            ),
            "decompress_and_score_batched": (
                lambda: ops.decompress_and_score_batched(
                    qb, qm, codes4, res4, valid4, index.centroids, index.weights, nbits=NBITS),
                lambda: ref.decompress_and_score_batched_ref(
                    qb, qm, codes4, res4, valid4, index.centroids, index.weights, nbits=NBITS),
                k2_bound(codes4, valid4, NQ, DIM, res4.shape[-1], index.num_centroids),
                dict(shape, nd=codes4.shape[1], L=codes4.shape[2]),
            ),
        }
        codes3f, valid3f = scoring.gather_doc_tokens(
            index.codes, index.doc_offsets, index.doc_lens, final_pids.reshape(-1),
            index.doc_maxlen, fill=-1,
        )
        cases["gather_decompress_maxsim"] = (
            lambda: ops.gather_decompress_maxsim(
                qb, qm, final_pids, index.codes, index.residuals, index.doc_offsets,
                index.doc_lens, index.centroids, index.weights, nbits=NBITS,
                doc_maxlen=index.doc_maxlen),
            lambda: ref.gather_decompress_maxsim_ref(
                qb, qm, final_pids, index.codes, index.residuals, index.doc_offsets,
                index.doc_lens, index.centroids, index.weights, nbits=NBITS,
                doc_maxlen=index.doc_maxlen),
            k3_bound(final_pids, codes3f[valid3f], NQ, DIM, index.residuals.shape[1],
                     index.num_centroids),
            dict(shape, n3=final_pids.shape[1]),
        )
        # K4 at vanilla's stage-3 block: 4096 passages' padded rows
        res_v, _ = scoring.gather_doc_tokens(
            index.residuals, index.doc_offsets, index.doc_lens, cands[0, :4096],
            index.doc_maxlen, fill=0,
        )
        cases["decompress_residuals"] = (
            lambda: ops.decompress_residuals(res_v, index.weights, nbits=NBITS),
            lambda: ref.decompress_residuals_ref(res_v, index.weights, nbits=NBITS),
            k4_bound(res_v.numel(), NBITS),
            dict(n=res_v.shape[0] * res_v.shape[1], pd=res_v.shape[2], nbits=NBITS,
                 passages=res_v.shape[0], L=res_v.shape[1]),
        )
        # K5 / K6 at _search's k=1000 shapes: lane 0's stage-2 block over
        # all K centroids, and its stage-4 finalists
        s1, c1, k1, m1 = s_cq[0], codes_blk[0], keep[0], qm[0]
        cases["centroid_interaction"] = (
            lambda: ops.centroid_interaction(s1, c1, m1, k1),
            lambda: ref.centroid_interaction_ref(s1, c1, k1, m1),
            k1_bound(s_cq[:1], codes_blk[:1], keep[:1]),
            dict(nd=c1.shape[0], L=c1.shape[1], K=s1.shape[0], nq=NQ),
        )
        q6, c6, r6, v6 = qb[0], codes4[0], res4[0], valid4[0]
        cases["decompress_and_score"] = (
            lambda: ops.decompress_and_score(q6, m1, c6, r6, v6, index.centroids,
                                             index.weights, nbits=NBITS),
            lambda: ref.decompress_and_score_ref(q6, m1, c6, r6, v6, index.centroids,
                                                 index.weights, nbits=NBITS),
            k2_bound(c6[None], v6[None], NQ, DIM, r6.shape[-1], index.num_centroids),
            dict(nd=c6.shape[0], L=c6.shape[1], pd=r6.shape[-1], nq=NQ, d=DIM),
        )
        contract = {  # K2/K3/K6: valid tokens under the no-FMA contract
            "decompress_and_score_batched": contract_bound_ms(int(valid4.sum()), NQ, DIM),
            "gather_decompress_maxsim": contract_bound_ms(int(valid3f.sum()), NQ, DIM),
            "decompress_and_score": contract_bound_ms(int(v6.sum()), NQ, DIM),
        }
        for name, (kern, plain, (bound_ms, bound_by), shp) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs()
            rel = err / want.abs().clamp(min=1e-30)
            # K4 does no arithmetic, K1/K5 take an exact max, and all keep
            # their plain versions' f32 order (the shared-order contract):
            # bit for bit
            ok = (torch.equal(got, want) if name in BIT_EXACT
                  else torch.allclose(got, want, rtol=1e-5, atol=1e-5))
            kernels[name] = dict(
                max_abs_err=float(err.max()), max_rel_err=float(rel.max()),
                ms=time_ms(kern, reps=25), device_ms=device_time_ms(kern, reps=25),
                host_us=host_us(kern, reps=25), plain_ms=time_ms(plain, reps=5, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, shape=shp,
            )
            if name in contract:
                kernels[name]["contract_bound_ms"] = contract[name]
            emit({"kernel_check": name, "ok": ok, **kernels[name]})
            assert ok, name
        # K1 at stage 3's shape (no keep: a null pointer), then small
        # ragged cases
        info["k1_stage3"] = k1_stage3_check(s_cq, codes_blk[:, : p1000.ndocs].contiguous(), qm)
        info["extra_cases"] = extra_kernel_cases(dev)
        info["score_blocks_per_sm"] = score_occupancy(NQ, DIM, index.doc_maxlen)
        assert min(info["score_blocks_per_sm"]["k2"], info["score_blocks_per_sm"]["k3"]) >= 1
        info["k4_nbits_cases"] = k4_nbits_cases(dev, res_v.shape[0] * res_v.shape[1])
        del s_cq, cands, codes_blk, res4, res_v

    # ---- 6. K7 against its plain version ----------------------------------
    with Phase("flash") as info:
        info["cases"] = flash_cases(dev)
        kernels["flash_attention"] = dict(
            next(c for c in info["cases"] if c["case"] == "passages"),
            per_rank_shapes=[{k: c[k] for k in ("case", "shape", "max_abs_err", "ms", "plain_ms",
                                                 "bound_ms", "bound_by", "library_ms")}
                             for c in info["cases"] if c["case"].endswith("-tp2")])

    # ---- 7. the search path: plaid-cuda vs plaid --------------------------
    ops.reset_launch_counts()
    with Phase("search") as info:
        runs = []
        for k in (10, 100, 1000):
            for fused in (False, True):
                p = retrieval.params_for_k(k).replace(fused=fused)
                cuda_r = retrieval.from_index(index, backend="plaid-cuda", params=p)
                plain_r = retrieval.from_index(index, backend="plaid", params=p)
                lat = {"plaid-cuda": [], "plaid": []}
                hits = 0
                for i, (qb, src) in enumerate(batches):
                    rc_ = cuda_r.search_batch(qb)
                    rp_ = plain_r.search_batch(qb)
                    assert rc_.pids.shape == (BATCH, k) and torch.isfinite(rc_.scores).all()
                    assert bool((rc_.pids >= 0).all()), "fewer than k results"
                    assert bool((rc_.scores[:, :-1] >= rc_.scores[:, 1:]).all())
                    assert torch.equal(rc_.pids, rp_.pids), f"pids differ k={k} fused={fused}"
                    assert torch.allclose(rc_.scores, rp_.scores, rtol=1e-5, atol=1e-5)
                    hits += int((rc_.pids == src[:, None]).any(1).sum())
                    if i:  # batch 0 warms up
                        lat["plaid-cuda"].append(rc_.latency_ms)
                        lat["plaid"].append(rp_.latency_ms)
                row = dict(k=k, fused=fused, batch=BATCH, batches=len(batches) - 1,
                           success_at_k=hits / (BATCH * len(batches)))
                for name, xs in lat.items():
                    p50 = statistics.median(xs)
                    row[name] = dict(p50_ms=p50, qps=BATCH / p50 * 1e3)
                emit({"search": row})
                runs.append(row)
        info["funnel"] = funnel_rows(index, batches)
        search_counts = ops.launch_counts()
        info.update(configs=len(runs), launches=search_counts)
        assert all(search_counts[name] > 0 for name in SEARCH_KERNELS), search_counts

    # ---- 8. the live index: deltas, tombstones, compaction -----------------
    ops.reset_launch_counts()
    with Phase("live") as info:
        live_phase(index, batches, args.seed, info)
        live_counts = ops.launch_counts()
        info["launches"] = live_counts
        assert all(live_counts[name] > 0 for name in SEARCH_KERNELS), live_counts

    # ---- 8b. the tiered index: payloads in host memory ---------------------
    with Phase("tiered") as info:
        # counted around the tiered calls alone (the phase also runs
        # plaid-cuda as its oracle)
        tiered_counts = tiered_phase(index, batches, info)
        info["launches"] = tiered_counts
        assert all(tiered_counts[name] > 0 for name in SEARCH_KERNELS), tiered_counts

    # ---- 8c. the serving tier over plaid-cuda, live-cuda, plaid-tiered-cuda -
    with Phase("serve") as info:
        # counted around the served runs with one dispatcher thread
        serve_counts = serve_phase(index, args.seed, info)
        info["launches"] = serve_counts
        assert all(serve_counts[name] > 0 for name in SEARCH_KERNELS[:2]), serve_counts

    # ---- 8d. document sharding: shards sharing the card, gloo ranks -------
    with Phase("sharded") as info:
        # counted around the sharded calls alone (the phase also runs
        # plaid-cuda and live-cuda as its oracles)
        info["card"] = smi  # beside every number of the phase's lines
        sharded_counts = sharded_phase(index, batches, args.seed, info)
        info["launches"] = sharded_counts
        assert all(sharded_counts[name] > 0 for name in SEARCH_KERNELS), sharded_counts

    # ---- 8e. launch.serve, the reference's serving driver ------------------
    with Phase("serve_driver") as info:
        # counted around the two driver runs (plaid, then --pallas)
        info["card"] = smi  # beside every number of the phase's lines
        driver_counts = serve_driver_phase(info)
        info["launches"] = driver_counts

    # ---- 9. the vanilla ColBERTv2 baseline (K4) ---------------------------
    ops.reset_launch_counts()
    with Phase("vanilla") as info:
        info["configs"] = vanilla_phase(index, batches[:VANILLA_BATCHES])
        vanilla_counts = ops.launch_counts()
        info["launches"] = vanilla_counts
        assert vanilla_counts["decompress_residuals"] > 0, vanilla_counts

    # ---- 10. the single-query _search oracle (K5, K6) ----------------------
    ops.reset_launch_counts()
    with Phase("oracle") as info:
        info["configs"] = oracle_phase(index, batches[1][0])
        oracle_counts = ops.launch_counts()
        info["launches"] = oracle_counts
        assert oracle_counts["centroid_interaction"] > 0, oracle_counts
        assert oracle_counts["decompress_and_score"] > 0, oracle_counts

    # ---- 11. the quality harness: sweep and certification -----------------
    ops.reset_launch_counts()
    with Phase("quality") as info:
        quality_phase(args.seed, dev, info)
        info["launches"] = ops.launch_counts()

    # ---- 12. the encoder path: tokens -> vectors -> index -> pids ---------
    with Phase("encode") as info:
        model, encode_counts, q_toks, enc_corpus = encode_phase(index, args.seed, dev, info)

    # ---- 13. the streaming build --------------------------------------------
    ops.reset_launch_counts()
    with Phase("stream_build") as info:
        stream_build_phase(model, enc_corpus, args.seed, dev, info)
        stream_counts = ops.launch_counts()
        info["launches"] = stream_counts
        assert stream_counts["flash_attention"] > 0, stream_counts
    del enc_corpus

    # ---- 13b. ColBERTv2 training on the card, then its weights served ------
    with Phase("train") as info:
        info["card"] = smi  # beside every number of the phase's lines
        train_counts = train_phase(args.seed, dev, info)
        info["launches"] = train_counts
    torch.cuda.empty_cache()

    # ---- 13c. data-parallel training over two gloo ranks, then served -------
    with Phase("train_dp") as info:
        info["card"] = smi  # beside every number of the phase's lines
        dp_counts = train_dp_phase(args.seed, dev, info)
        info["launches"] = dp_counts
    torch.cuda.empty_cache()

    # ---- 14. persistence of the main index --------------------------------
    with Phase("persist") as info:
        r = retrieval.from_index(index, backend="plaid-cuda", params=retrieval.params_for_k(10))
        qb = batches[1][0]
        before = r.search_batch(qb)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            r.save(tmp)
            t1 = time.perf_counter()
            r2 = retrieval.load(tmp, device="cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            disk_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        loaded = r2.index
        same = {f: torch.equal(getattr(index, f), getattr(loaded, f))
                for f in index_mod.ARRAY_FIELDS}
        after = r2.search_batch(qb)
        info.update(backend=r2.backend_name, passages=loaded.num_passages,
                    tokens=loaded.num_tokens, disk_bytes=disk_bytes,
                    save_s=t1 - t0, load_s=t2 - t1, arrays_identical=same)
        assert r2.backend_name == "plaid-cuda"
        assert all(same.values()), same
        assert torch.equal(before.pids, after.pids)
        assert torch.equal(before.scores, after.scores)
        del r, r2, loaded

    # ---- 15. where a plaid-cuda batch and a query encode spend device time -
    with Phase("profile") as info:
        info["configs"] = [
            dict(k=k, fused=False, **profile_batch(
                retrieval.from_index(index, backend="plaid-cuda",
                                            params=retrieval.params_for_k(k)),
                batches[1][0]))
            for k in (10, 1000)
        ]
        info["vanilla"] = dict(k=10, **profile_batch(
            retrieval.from_index(index, backend="vanilla",
                                 params=retrieval.SearchParams(k=10, **VANILLA_SETTINGS)),
            batches[1][0]))
        info["encode"] = dict(batch=BATCH, seq=NQ, **profile_encode(model, q_toks[:BATCH]))

    # ---- 16. serving the LM family: prefill through K7, KV-cache decode ---
    # the index and the encoder are not needed past here: phase lm holds up
    # to ~45 GB (yi-34b's 16 layers and a 17 GB cache)
    del index, batches, qs_all, src_all, qm, model, q_toks
    torch.cuda.empty_cache()
    with Phase("lm") as info:
        info["card"] = smi  # beside every number of the phase's lines
        info["resident_bytes"] = torch.cuda.memory_allocated()  # earlier phases' leftovers
        # counted around each config's warm-up and timed prefills (the
        # checks' K7 runs not)
        lm_counts = lm_phase(args.seed, dev, info)

    # ---- 17. LM training: the entry point, train_4k at full width, served ---
    torch.cuda.empty_cache()
    with Phase("lm_train") as info:
        info["card"] = smi  # beside every number of the phase's lines
        # K7's launches counted around the trained weights' prefill alone
        lm_train_counts = lm_train_phase(args.seed, dev, info)

    # ---- 18. the "model" axis: two gloo ranks on a 1 x 2 mesh --------------
    torch.cuda.empty_cache()
    with Phase("lm_tp") as info:
        info["card"] = smi  # beside every number of the phase's lines
        # K7's launches: the ranks' prefills and ColBERT encodes (each rank
        # counts its own)
        lm_tp_counts = lm_tp_phase(args.seed, dev, info)

    # ---- 19. the recsys family, PLAID as an item index, SchNet -------------
    torch.cuda.empty_cache()
    with Phase("recsys") as info:
        info["card"] = smi  # beside every number of the phase's lines
        # K1/K2's launches: the item index's cuda batches (their checks at
        # the item shapes not)
        recsys_counts, item_checks = recsys_phase(args.seed, dev, info, gnn_job)
    for name, row in item_checks.items():
        kernels[name]["item_index_shapes"] = row

    # ---- 20. the retrieval family's cells at full width; the dry sweep ------
    torch.cuda.empty_cache()
    with Phase("cells") as info:
        info["card"] = smi  # beside every number of the phase's lines
        # K1/K2's launches: the search cells' cuda batches; K7's: the
        # encode_corpus cell's encodes (the checks at these shapes not)
        cells_counts, cell_checks = cells_phase(args.seed, dev, info, corpus_job)
    for name, rows in cell_checks.items():
        kernels[name]["search_cell_shapes" if name != "flash_attention"
                      else "encode_corpus_shape"] = rows

    # ---- 21. the recsys family and SchNet over two processes ----------------
    torch.cuda.empty_cache()
    with Phase("family_mesh") as info:
        info["card"] = smi  # beside every number of the phase's lines
        family_mesh_phase(args.seed, dev, info, gnn_job[1])  # launches no port kernel

    # launches: each kernel's from the paths that run it, its counts zeroed
    # just before each path (tiered: taken around each tiered call; serve:
    # around the served runs with one dispatcher; sharded: around each
    # sharded call; serve_driver: around its two runs; train and train_dp:
    # around the serving of the trained weights): K1-K3 in search, live,
    # tiered, serve and sharded, K1/K2 in serve_driver, train and train_dp
    # too, K4 in vanilla and serve_driver, K5/K6 in oracle, K7 in encode,
    # stream_build, train, train_dp, lm, lm_train, lm_tp and cells; K1/K2 in
    # recsys (the item index's batches) and cells (the search cells' batches)
    launches = {name: search_counts[name] + live_counts[name] + tiered_counts[name]
                + serve_counts[name] + sharded_counts[name] + driver_counts[name]
                + train_counts[name] + dp_counts[name] + recsys_counts.get(name, 0)
                + cells_counts.get(name, 0)
                for name in SEARCH_KERNELS}
    launches["decompress_residuals"] = (vanilla_counts["decompress_residuals"]
                                        + driver_counts["decompress_residuals"])
    for name in ("centroid_interaction", "decompress_and_score"):
        launches[name] = oracle_counts[name]
    launches["flash_attention"] = (encode_counts["flash_attention"]
                                   + stream_counts["flash_attention"]
                                   + train_counts["flash_attention"]
                                   + dp_counts["flash_attention"]
                                   + lm_counts["flash_attention"]
                                   + lm_train_counts["flash_attention"]
                                   + lm_tp_counts["flash_attention"]
                                   + cells_counts["flash_attention"])
    rows = [
        dict(
            name=name, route="cuda", source=REPLACES[name][0], replaces=REPLACES[name][1],
            launches=launches[name], max_abs_err=kv["max_abs_err"], ms=kv["ms"],
            device_ms=kv["device_ms"], host_us=kv.get("host_us"), plain_ms=kv["plain_ms"],
            bound_ms=kv["bound_ms"], bound_by=kv["bound_by"],
            library_ms=kv.get("library_ms"), contract_bound_ms=kv.get("contract_bound_ms"),
            per_rank_shapes=kv.get("per_rank_shapes"),
            item_index_shapes=kv.get("item_index_shapes"),
            search_cell_shapes=kv.get("search_cell_shapes"),
            encode_corpus_shape=kv.get("encode_corpus_shape"),
        )
        for name, kv in kernels.items()
    ]
    assert sorted(r["name"] for r in rows) == sorted(REPLACES), [r["name"] for r in rows]
    assert all(r["launches"] > 0 for r in rows), launches
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def traced_kernels(fn, reps: int = 3, sessions: int = 3):
    """``fn``'s CUDA kernels under ``torch.profiler`` (CUPTI) over ``reps``
    calls, after one untimed call.  CUPTI loses kernel records two ways:
    late in a run a session can miss the first kernels of its first call
    (phase ``profile`` read a ``plaid-cuda`` batch without its stage-1
    GEMM in one of three calls, session after session), which a warm-up
    step that traces one call and discards it prevents; and now and then
    one record anywhere, so a session whose kernel counts are not all
    multiples of ``reps`` is traced again, up to ``sessions`` times.
    Returns the last session's kernels by descending device time, its wall
    ms a call, whether its counts were whole, and how many sessions ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for n in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
            prof.step()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")]  # the schedule's step marks
        kern.sort(key=lambda e: -e.self_device_time_total)
        whole = all(e.count % reps == 0 for e in kern)
        if whole:
            break
    return kern, wall_ms, whole, n


def profile_batch(retriever, qb, reps: int = 3) -> dict:
    """Device time of one ``search_batch`` by kernel over ``reps`` warm
    batches (:func:`traced_kernels`): the top kernels, their total, the
    profiled wall time and the device's busy share of it (one stream, so
    kernel times do not overlap)."""
    kern, wall_ms, whole, n = traced_kernels(lambda: retriever.search_batch(qb), reps)
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3 / reps

    def row(e):
        return dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3 / reps,
                    calls=e.count // reps)

    return dict(
        wall_ms=wall_ms, device_ms=device_ms,
        busy_share=device_ms / wall_ms if device_ms else None,
        launches=sum(e.count for e in kern) // reps, launches_whole=whole, sessions=n,
        top=[row(e) for e in kern[:10]],
        # the port's own kernels (K1: "interaction", K2/K3: "score_kernel",
        # K4, K7), wherever they rank
        port=[row(e) for e in kern if any(t in e.key for t in PORT_KERNEL_KEYS)],
    )


def flash_check(name, B, S, H, Hkv, dh, causal, dtype, g, timed: bool, reps: int = 25) -> dict:
    """K7 against its plain version on one seeded case; at the encoder's
    and the LM prefills' shapes also its time, the plain version's, SDPA's
    and the bound (``reps`` timed calls; the plain version's a fifth)."""
    dev = g.device
    q = torch.randn(B, S, H, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)

    def kern():
        return fa.flash_attention(q, k, v, causal=causal)

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=causal)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    row = dict(case=name, shape=dict(B=B, S=S, H=H, Hkv=Hkv, dh=dh), dtype=str(dtype),
               causal=causal, tol=tol, max_abs_err=float((got.float() - want.float()).abs().max()),
               ok=torch.allclose(got.float(), want.float(), **tol))
    if timed:
        def sdpa():  # the yardstick; the port never calls it
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)

        lib = sdpa().transpose(1, 2)
        c = kcosts.flash_attention_cost(B=B, S=S, H=H, Hkv=Hkv, dh=dh, causal=causal,
                                        itemsize=q.element_size())  # q, o, k, v
        nbytes, flops = c["hbm_bytes"], c["flops"]
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bound_ms, bound_by = bound(nbytes, flops, peak)
        row.update(
            ms=time_ms(kern, reps=reps), device_ms=device_time_ms(kern, reps=reps),
            host_us=host_us(kern, reps=reps),
            plain_ms=time_ms(plain, reps=max(reps // 5, 1), warmup=min(reps // 5, 1)),
            library_ms=time_ms(sdpa, reps=reps), library_device_ms=device_time_ms(sdpa, reps=reps),
            library_host_us=host_us(sdpa, reps=reps),
            library_max_abs_err=float((lib.float() - want.float()).abs().max()),
            bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
        )
    emit({"kernel_check": "flash_attention", **row})
    assert row["ok"], row
    return row


def flash_cases(dev) -> list:
    g = torch.Generator(device=dev).manual_seed(321)
    enc = [("queries", BATCH, NQ, 48, 12, 64, False, torch.bfloat16),
           ("passages", ENCODE_BATCH, DOC_MAXLEN, 48, 12, 64, False, torch.bfloat16)]
    jax_shapes = [(f"reference_test_{i}", *shape, torch.float32)
                  for i, shape in enumerate(JAX_FLASH_SHAPES)]
    lm = [(f"lm_{arch}", B, S, H, Hkv, dh, True, torch.bfloat16)
          for arch, B, S, H, Hkv, dh in LM_FLASH_CASES]
    return ([flash_check(*c, g, timed=True) for c in enc + [COLBERT_FLASH_CASE]]
            + [flash_check(*c, g, timed=False) for c in jax_shapes]
            + flash_view_cases(dev, g)
            + [flash_check(*c, g, timed=True, reps=LM_FLASH_REPS) for c in lm])


def flash_view_cases(dev, g) -> list:
    """K7 on views it cannot read as they stand, at the query shape: bf16 q
    at an odd element offset (TMA needs 16-byte alignment) and transposed
    (not contiguous); the wrapper copies them, and the result is held
    against the plain version within one bf16 ulp and equals K7 on the
    contiguous original."""
    q, k, v = (torch.randn(BATCH, NQ, h, 64, generator=g, device=dev).bfloat16()
               for h in (48, 12, 12))
    flat = torch.empty(q.numel() + 1, device=dev, dtype=torch.bfloat16)
    views = {"offset": flat[1:].view(q.shape).copy_(q),
             "transposed": q.transpose(1, 2).contiguous().transpose(1, 2)}
    base = fa.flash_attention(q, k, v, causal=False)
    rows = []
    for name, view in views.items():
        got = fa.flash_attention(view, k, v, causal=False)
        want = ref.flash_attention_ref(view, k, v, causal=False)
        torch.cuda.synchronize()
        tol = FLASH_TOL[torch.bfloat16]
        row = dict(case=f"view_{name}", aligned=view.data_ptr() % 16 == 0,
                   contiguous=view.is_contiguous(), tol=tol,
                   max_abs_err=float((got.float() - want.float()).abs().max()),
                   ok=torch.allclose(got.float(), want.float(), **tol) and torch.equal(got, base))
        emit({"kernel_check": "flash_attention", **row})
        assert row["ok"], row
        rows.append(row)
    return rows


def check_result(res, k) -> None:
    """(BATCH, k) pids, -1 only in trailing slots, real scores finite and
    in descending order."""
    real = res.pids >= 0
    assert res.pids.shape == (BATCH, k) and bool((res.pids >= -1).all())
    assert bool((real[:, :-1] | ~real[:, 1:]).all()), "a -1 slot before a real pid"
    assert bool(torch.isfinite(res.scores[real]).all())
    s = torch.where(real, res.scores, -torch.inf)
    assert bool((s[:, :-1] >= s[:, 1:]).all())


def encode_phase(index, seed, dev, info: dict):
    """ColBERTv2 at full width on the card: corpus -> build_index -> B=32
    query batches searched with plaid-cuda and plaid (identical pids) and in
    the main index.  Returns the model, the phase's launch counts and the
    query tokens."""
    cfg = colbert_cfg.full_config()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, attn_impl="flash"))
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    model = colbert.init_params(cfg, gen, device=dev)
    vocab, n = cfg.backbone.vocab, ENCODE_PASSAGES
    lens = torch.randint(8, DOC_MAXLEN + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    lens[0] = DOC_MAXLEN
    toks = torch.randint(0, vocab, (n, DOC_MAXLEN), generator=gen, device=dev)
    mask = torch.arange(DOC_MAXLEN, device=dev)[None, :] < lens[:, None]
    n_batches = TIMED_BATCHES + 1
    src = torch.randint(0, n, (BATCH * n_batches,), generator=gen, device=dev)
    q_toks = toks[src, :NQ]  # a query is the head of a passage
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    calls = 0
    t0 = time.perf_counter()
    chunks = []
    for i in range(0, n, ENCODE_BATCH):
        e = colbert.encode(model, toks[i : i + ENCODE_BATCH], mask[i : i + ENCODE_BATCH])
        chunks.append(e[mask[i : i + ENCODE_BATCH]])
        calls += 1
    doc_embs = torch.cat(chunks)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    norms = doc_embs.norm(dim=-1)
    assert torch.isfinite(doc_embs).all() and bool(((norms - 1).abs() < 1e-3).all())

    t0 = time.perf_counter()
    enc_index = index_mod.build_index(doc_embs, lens, seed=seed, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert enc_index.num_centroids == kmeans.num_centroids_for(doc_embs.shape[0])
    t0 = time.perf_counter()  # the k-means step of that build, timed alone
    kmeans.train_centroids(doc_embs, enc_index.num_centroids, seed=seed)
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0

    q_batches, encode_ms = [], []
    for b in range(n_batches):
        t0 = time.perf_counter()
        qe = colbert.encode(model, q_toks[b * BATCH : (b + 1) * BATCH])
        torch.cuda.synchronize()
        calls += 1
        assert qe.shape == (BATCH, NQ, DIM) and torch.isfinite(qe).all()
        if b:
            encode_ms.append((time.perf_counter() - t0) * 1e3)
        q_batches.append(qe)

    searches = []
    for k in (10, 100):
        p = retrieval.params_for_k(k)
        cuda_r = retrieval.from_index(enc_index, backend="plaid-cuda", params=p)
        plain_r = retrieval.from_index(enc_index, backend="plaid", params=p)
        hits, filled, lat = 0, 0, []
        for b, qe in enumerate(q_batches):
            got, want = cuda_r.search_batch(qe), plain_r.search_batch(qe)
            check_result(got, k)
            assert torch.equal(got.pids, want.pids), f"encoded index: pids differ at k={k}"
            assert torch.allclose(got.scores, want.scores, rtol=1e-5, atol=1e-5)
            hits += int((got.pids == src[b * BATCH : (b + 1) * BATCH, None]).any(1).sum())
            filled += int((got.pids >= 0).sum())
            if b:
                lat.append(got.latency_ms)
        # with random weights a passage's tokens sit close together, so the
        # probed centroids' lists can hold fewer than k passages (-1 slots)
        searches.append(dict(k=k, plaid_cuda_p50_ms=statistics.median(lat),
                             success_at_k=hits / (BATCH * n_batches),
                             filled_share=filled / (BATCH * n_batches * k)))

    big = retrieval.from_index(index, backend="plaid-cuda", params=retrieval.params_for_k(10))
    e2e_ms = []
    for b in range(n_batches):
        t0 = time.perf_counter()
        res = big.search_batch(colbert.encode(model, q_toks[b * BATCH : (b + 1) * BATCH]))
        calls += 1
        check_result(res, 10)
        if b:
            e2e_ms.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    layers = cfg.backbone.n_layers
    assert counts["flash_attention"] == layers * calls > 0, (counts, calls)

    # one query batch on the card against the same weights on the CPU (K7's
    # plain version there); bf16 rounds at other places on the two devices,
    # in each of 12 layers, so the bound is looser than one layer's (0.999)
    cpu_model = colbert.params_from_numpy(model.numpy_params(), cfg, device="cpu")
    a = colbert.encode(model, q_toks[:2]).cpu()
    b = colbert.encode(cpu_model, q_toks[:2].cpu())
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    info.update(
        config=dict(n_layers=layers, d_model=cfg.backbone.d_model, heads=cfg.backbone.n_heads,
                    padded_heads=cfg.backbone.padded_heads, d_ff=cfg.backbone.d_ff,
                    vocab=cfg.backbone.vocab, dtype=str(cfg.backbone.dtype),
                    attn_impl=cfg.backbone.attn_impl, out_dim=cfg.out_dim),
        passages=n, tokens=int(doc_embs.shape[0]), corpus_encode_s=corpus_s,
        corpus_tokens_per_s=doc_embs.shape[0] / corpus_s,
        build_s=build_s, kmeans_s=kmeans_s, centroids=enc_index.num_centroids,
        query_batch=BATCH, query_len=NQ, timed_batches=TIMED_BATCHES,
        encode_p50_ms=statistics.median(encode_ms), encoded_index_search=searches,
        main_index_passages=index.num_passages,
        tokens_to_pids_p50_ms=statistics.median(e2e_ms),
        encode_calls=calls, launches=counts, k7_launches_per_encode=layers,
        cpu_check=dict(min_cosine=float(cos.min()), max_abs_err=float((a - b).abs().max())),
    )
    assert info["cpu_check"]["min_cosine"] >= 0.99 and info["cpu_check"]["max_abs_err"] <= 0.1
    del cpu_model, chunks
    corpus = dict(toks=toks, lens=lens, doc_embs=doc_embs, index=enc_index)
    return model, counts, q_toks, corpus


def stream_corpus(passages, seed, chunk_docs):
    """A chunk factory for a topic-structured corpus made on the card from
    the seed, chunk by chunk (never one array): passages of 8..180 tokens,
    each token a term of its passage's topic plus noise, unit norm.
    Returns ``(factory, n_tokens)``."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    n_terms, n_topics, pool = 1 << 16, 1 << 12, 32
    terms = F.normalize(torch.randn(n_terms, DIM, generator=g, device=dev), dim=1)
    pools = torch.randint(0, n_terms, (n_topics, pool), generator=g, device=dev)
    lens = torch.randint(8, DOC_MAXLEN + 1, (passages,), generator=g, device=dev,
                         dtype=torch.int32).cpu().numpy()

    def chunk(i):
        gc = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + i)
        cl = lens[i * chunk_docs : (i + 1) * chunk_docs]
        nt = int(cl.sum())
        topic = torch.randint(0, n_topics, (len(cl),), generator=gc, device=dev)
        tok_topic = torch.repeat_interleave(topic, torch.from_numpy(cl).to(dev).long())
        pick = torch.randint(0, pool, (nt,), generator=gc, device=dev)
        x = terms[pools[tok_topic, pick]]
        x += (0.3 / math.sqrt(DIM)) * torch.randn(nt, DIM, generator=gc, device=dev)
        return F.normalize(x, dim=1), cl

    def factory():
        for i in range(-(-passages // chunk_docs)):
            yield chunk(i)

    return factory, int(lens.sum())


def profile_quantize(index, factory) -> dict:
    """Device time of pass 2's per-chunk work (``quantize_rows``: assign,
    residual, compress) over four 16,384-row windows of the first chunk
    against the built tables, by kernel (torch.profiler)."""
    from repro_torch.build.streaming import quantize_rows

    x = next(factory())[0][: 4 * 16384]
    kern, wall_ms, *_ = traced_kernels(lambda: quantize_rows(x, index.centroids, index.codec), 1)
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    flops = 2.0 * x.shape[0] * index.num_centroids * DIM
    return dict(rows=x.shape[0], wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if device_ms else None,
                gemm_bound_ms=flops / F32_FLOPS * 1e3,
                distance_bytes_bound_ms=2 * 4 * x.shape[0] * index.num_centroids
                / HBM_BYTES_PER_S * 1e3,
                top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3, calls=e.count)
                     for e in kern[:8]])


def same_index(a, b) -> dict:
    """Every array field and static field of two indexes, compared bit for
    bit; returns the fields that differ."""
    diff = [f for f in index_mod.ARRAY_FIELDS
            if getattr(a, f).dtype != getattr(b, f).dtype
            or not torch.equal(getattr(a, f), getattr(b, f))]
    diff += [f for f in index_mod.STATIC_FIELDS if getattr(a, f) != getattr(b, f)]
    return diff


def stream_build_phase(model, enc, seed, dev, info: dict):
    """The streaming build on the card: (i) a trained build at ColBERTv2's
    widths from a corpus made chunk by chunk, searched with plaid-cuda and
    plaid (identical pids); (ii) frozen-table builds of the encode phase's
    corpus at two chunk sizes, pruned and not, array-identical to
    ``build_index``; (iii) two trained builds of a ~1M-token corpus at two
    chunk sizes, bit-identical; (iv) ``build_from_encoder`` through the
    encoder (K7) against ``build_index`` over the same encoder output, and
    ``retrieval.build`` against ``build_index_streaming``."""
    # (i) trained, at scale
    factory, nt = stream_corpus(STREAM_PASSAGES, seed, STREAM_CHUNK_DOCS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    big, st = build.build_index_streaming(
        build.iterator_stream(factory), seed=seed, return_stats=True, device=dev
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    assert big.num_tokens == nt == st.n_tokens and big.num_passages == STREAM_PASSAGES
    assert big.num_centroids == kmeans.num_centroids_for(nt) and st.trained
    assert torch.isfinite(big.centroids).all()
    info["trained"] = dict(
        passages=STREAM_PASSAGES, tokens=nt, chunk_docs=STREAM_CHUNK_DOCS, dim=DIM,
        nbits=big.nbits, centroids=big.num_centroids, sample=build.DEFAULT_SAMPLE_SIZE,
        kmeans_iters=8, build_s=build_s, pass1_s=st.pass1_s, pass2_s=st.pass2_s,
        kmeans_s=st.kmeans_s, tokens_per_s=nt / build_s, pass2_tokens_per_s=nt / st.pass2_s,
        peak_device_bytes=peak, monolithic_corpus_bytes=nt * DIM * 4,
        index_bytes=sum(big.nbytes().values()), stats=dataclasses.asdict(st),
    )
    emit({"stream_build": info["trained"]})
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    emb0, lens0 = next(factory())
    offs0 = torch.from_numpy(lens0).to(dev).long().cumsum(0) - torch.from_numpy(lens0).to(dev).long()
    src = torch.randint(0, len(lens0), (BATCH,), generator=g, device=dev)
    pos = (torch.rand(BATCH, NQ, generator=g, device=dev)
           * torch.from_numpy(lens0).to(dev)[src, None]).long()
    qb = emb0[offs0[src, None] + pos]
    qb = F.normalize(qb + 0.02 * torch.randn(qb.shape, generator=g, device=dev), dim=-1)
    del emb0
    p = retrieval.params_for_k(10)
    got = retrieval.from_index(big, backend="plaid-cuda", params=p).search_batch(qb)
    want = retrieval.from_index(big, backend="plaid", params=p).search_batch(qb)
    check_result(got, 10)
    assert torch.equal(got.pids, want.pids), "streamed index: plaid-cuda pids differ from plaid"
    assert torch.allclose(got.scores, want.scores, rtol=1e-5, atol=1e-5)
    info["trained"]["search"] = dict(
        k=10, batch=BATCH, pids_identical=True,
        success_at_10=float((got.pids == src[:, None]).any(1).float().mean()))
    info["trained"]["pass2_profile"] = profile_quantize(big, factory)
    del big, got, want

    # (ii) frozen tables: streaming == monolithic, pruned and not
    emb, lens, tables = enc["doc_embs"], enc["lens"], enc["index"]
    frozen = dict(centroids=tables.centroids, codec=tables.codec)
    rows = []
    for frac in (0.0, 0.25):
        mono = index_mod.build_index(emb, lens, prune_fraction=frac, device=dev, **frozen)
        for cd in (256, 4096):
            t0 = time.perf_counter()
            streamed = build.build_index_streaming(emb, lens, chunk_docs=cd, prune_fraction=frac,
                                                   device=dev, **frozen)
            torch.cuda.synchronize()
            diff = same_index(streamed, mono)
            rows.append(dict(prune_fraction=frac, chunk_docs=cd, tokens=streamed.num_tokens,
                             seconds=time.perf_counter() - t0, differing_fields=diff))
            assert not diff, rows[-1]
    info["frozen_identity"] = rows

    # (iii) trained builds at two chunkings: bit for bit
    f3, nt3 = stream_corpus(DETERMINISM_PASSAGES, seed + 1, 4096)
    parts = list(f3())
    packed = torch.cat([e for e, _ in parts])
    lens3 = np.concatenate([cl for _, cl in parts])
    del parts
    a = build.build_index_streaming(packed, lens3, chunk_docs=256, seed=seed, device=dev)
    b = build.build_index_streaming(packed, lens3, chunk_docs=4096, seed=seed, device=dev)
    diff = same_index(a, b)
    info["determinism"] = dict(tokens=nt3, passages=DETERMINISM_PASSAGES, chunk_docs=[256, 4096],
                               centroids=a.num_centroids, differing_fields=diff)
    assert not diff, info["determinism"]
    del packed, a, b

    # (iv) the encoder path (K7) under frozen tables, then retrieval.build
    toks = enc["toks"][:ENCODER_BUILD_PASSAGES]
    n, L = toks.shape
    t0 = time.perf_counter()
    streamed, st4 = indexer.build_from_encoder(
        lambda t: colbert.encode(model, t), toks, chunk=ENCODE_BATCH, return_stats=True,
        device=dev, **frozen)
    torch.cuda.synchronize()
    enc_build_s = time.perf_counter() - t0
    out = torch.cat([colbert.encode(model, toks[i : i + ENCODE_BATCH]).reshape(-1, DIM)
                     for i in range(0, n, ENCODE_BATCH)])
    full_lens = torch.full((n,), L, dtype=torch.int32)
    mono = index_mod.build_index(out, full_lens, device=dev, **frozen)
    diff = same_index(streamed, mono)
    assert st4.peak_host_f32_bytes == 0 and not st4.trained, st4
    cfg_index = dict(num_centroids=4096, kmeans_iters=4, chunk_docs=512, seed=seed)
    r = retrieval.build(out, doc_lens=full_lens, backend="plaid-cuda", index=cfg_index,
                        device=dev)
    direct = build.build_index_streaming(out, full_lens, device=dev, **cfg_index)
    diff_facade = same_index(r.index, direct)
    check_result(r.search_batch(out.reshape(n, L, DIM)[:BATCH, :NQ]), 10)
    info["encoder"] = dict(
        passages=n, rows_per_passage=L, tokens=streamed.num_tokens, chunk=ENCODE_BATCH,
        build_s=enc_build_s, tokens_per_s=streamed.num_tokens / enc_build_s,
        stats=dataclasses.asdict(st4), differing_fields=diff,
        facade=dict(backend=r.backend_name, index=cfg_index, differing_fields=diff_facade))
    assert not diff, info["encoder"]
    assert not diff_facade, info["encoder"]


def model_flops_params(cfg) -> int:
    """N of the 6 N tokens rule: the parameters a token multiplies at the
    published widths (12 heads, not the 48 padded ones; no embedding
    table, whose lookup is no product), i.e. each layer's attention and
    SwiGLU weights and the projection."""
    bb = cfg.backbone
    attn = 2 * bb.d_model * bb.n_heads * bb.d_head + 2 * bb.d_model * bb.n_kv_heads * bb.d_head
    return bb.n_layers * (attn + 3 * bb.d_model * bb.d_ff) + bb.d_model * cfg.out_dim


def train_batches(cfg, n, batch, seed, dev) -> list:
    """``n`` ``colbert_batches`` batches of queries of NQ tokens and
    passages of DOC_MAXLEN, moved to ``dev`` before any step is timed."""
    it = synthetic.colbert_batches(cfg.backbone.vocab, batch, q_len=NQ, d_len=DOC_MAXLEN,
                                   nway=cfg.nway, seed=seed)
    return [{k: torch.as_tensor(v, device=dev) for k, v in next(it).items()} for _ in range(n)]


def held_out_loss(judge, params, batches) -> float:
    """The mean ``train_loss`` of ``params`` over fixed batches no step
    trained on, without a graph (``params`` copied into ``judge`` first).
    Each step's own loss is on a new batch and swings by +-1 between
    batches (in-batch negatives, scores up to 32), so whether training
    lowered the loss is read here."""
    colbert.assign_params(judge, params)
    with torch.no_grad():
        return statistics.mean(float(colbert.train_loss(judge, judge.cfg, b)[0]) for b in batches)


def run_steps(step, params, opt_state, batches) -> tuple:
    """``step`` over ``batches``, the card synchronised after each; returns
    the state, the losses and each step's wall ms."""
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    return params, opt_state, [float(x) for x in losses], ms


def reduced_steps(cfg, dev, steps, n_micro=1, batch=4) -> tuple:
    """The reduced config trained from one seeded state (made on the host,
    so both devices start from the same bits): losses and parameters."""
    init = colbert.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    tree = colbert.numpy_train_state({"params": colbert.train_params(init)})
    model, state = colbert.train_state_from_numpy(tree, cfg, device=dev)
    opt = train_opt.adamw(train_opt.AdamWConfig(schedule=train_opt.cosine_schedule(1e-3, 1, 10)))
    step = train_loop.make_train_step(colbert.loss_fn(model), opt, n_micro=n_micro)
    p, o = state["params"], train_loop.init_opt_state(opt, state["params"])
    it = synthetic.colbert_batches(cfg.backbone.vocab, batch, q_len=8, d_len=16, nway=cfg.nway,
                                   seed=6)
    losses = []
    for _ in range(steps):
        p, o, m = step(p, o, next(it))
        losses.append(float(m["loss"]))
    return losses, p


def train_phase(seed, dev, info: dict) -> dict:
    """ColBERTv2 training on the card: the full-width step's time, memory
    and loss; card against CPU and microbatches at reduced width; int8
    compression; a supervised restart; then the trained weights served
    through K7, K1 and K2.  Returns the launch counts of the serving part
    (the training steps launch none of the port's kernels)."""
    cfg = colbert_cfg.full_config()
    bb = cfg.backbone
    model = colbert.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 31), device=dev)
    params0 = colbert.train_params(model)
    opt = train_opt.adamw(train_opt.AdamWConfig(
        schedule=train_opt.cosine_schedule(TRAIN_LR, 2, TRAIN_STEPS + 1)))
    step = train_loop.make_train_step(colbert.loss_fn(model), opt)
    tokens = TRAIN_BATCH * (NQ + cfg.nway * DOC_MAXLEN)
    n_model = model_flops_params(cfg)

    # (1) full width: one warm-up step, then TRAIN_STEPS timed
    batches = train_batches(cfg, TRAIN_STEPS + 1, TRAIN_BATCH, seed, dev)
    held_out = train_batches(cfg, HELD_OUT_BATCHES, TRAIN_BATCH, seed + 7, dev)
    judge = colbert.ColBERT(cfg, transformer.Transformer(bb, dev))
    before = held_out_loss(judge, params0, held_out)
    ops.reset_launch_counts()
    p, o = params0, train_loop.init_opt_state(opt, params0)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()  # earlier phases' index and models
    torch.cuda.reset_peak_memory_stats()
    p, o, losses, ms = run_steps(step, p, o, batches)
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in losses), losses
    assert not any(ops.launch_counts().values()), ops.launch_counts()  # no kernel trains
    after = held_out_loss(judge, p, held_out)
    p50 = statistics.median(ms[1:])
    kern, wall_ms, whole, sessions = traced_kernels(lambda: step(p, o, batches[0]), reps=2)
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3 / 2
    gemm_ms = sum(e.self_device_time_total for e in kern
                  if any(t in e.key.lower() for t in ("gemm", "xmma", "nvjet", "cutlass"))) / 1e3 / 2
    info["full_width"] = dict(
        config=dict(n_layers=bb.n_layers, d_model=bb.d_model, heads=bb.n_heads,
                    padded_heads=bb.padded_heads, d_ff=bb.d_ff, vocab=bb.vocab,
                    dtype=str(bb.dtype), attn_impl=bb.attn_impl, remat=bb.remat,
                    out_dim=cfg.out_dim, nway=cfg.nway),
        batch=TRAIN_BATCH, q_len=NQ, d_len=DOC_MAXLEN, tokens_per_step=tokens,
        params=sum(x.numel() for x in train_tree.leaves(params0)), model_flops_params=n_model,
        steps=TRAIN_STEPS, warmup_step_ms=ms[0], step_p50_ms=p50,
        step_ms_min_max=[min(ms[1:]), max(ms[1:])], tokens_per_s=tokens / p50 * 1e3,
        peak_device_bytes=peak, resident_bytes=resident, peak_over_resident_bytes=peak - resident,
        mfu=6 * n_model * tokens / (p50 / 1e3) / BF16_FLOPS,
        first_loss=losses[0], last_loss=losses[-1], losses=losses,
        held_out_loss_before=before, held_out_loss_after=after,
        profiled=dict(wall_ms=wall_ms, device_ms=device_ms, device_over_wall=device_ms / wall_ms,
                      gemm_ms=gemm_ms, launches=sum(e.count for e in kern) // 2,
                      launches_whole=whole, sessions=sessions,
                      top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3 / 2,
                                calls=e.count // 2) for e in kern[:8]]),
    )
    emit({"train_full_width": info["full_width"]})
    assert after < before, (before, after)

    # (2) card against CPU: the reduced config in f32, 3 steps from one state
    rcfg = colbert_cfg.reduced_config()
    on_card, _ = reduced_steps(rcfg, dev, 3)
    on_cpu, _ = reduced_steps(rcfg, "cpu", 3)
    rel = max(abs(a / b - 1) for a, b in zip(on_card, on_cpu))
    info["card_vs_cpu"] = dict(losses_card=on_card, losses_cpu=on_cpu, max_rel=rel)
    assert rel <= 1e-4, info["card_vs_cpu"]

    # (3) microbatches: 4 against 1 on one batch; in-batch negatives off (a
    # microbatch's loss would see only its own passages)
    mcfg = dataclasses.replace(rcfg, use_ib_negatives=False)
    (l1,), p1 = reduced_steps(mcfg, dev, 1, n_micro=1, batch=8)
    (l4,), p4 = reduced_steps(mcfg, dev, 1, n_micro=4, batch=8)
    diff = max(float((a - b).abs().max()) for a, b in zip(train_tree.leaves(p4), train_tree.leaves(p1)))
    info["microbatches"] = dict(n_micro=(1, 4), loss=(l1, l4), loss_rel=abs(l4 / l1 - 1),
                                max_param_abs_diff=diff)
    assert abs(l4 / l1 - 1) <= 1e-5, info["microbatches"]
    # a first AdamW step moves a weight by ~lr (1e-3) times g / (|g| + eps):
    # where g is near 0 that ratio follows g's last bits, so the weights
    # agree to a thousandth of a step
    for a, b in zip(train_tree.leaves(p4), train_tree.leaves(p1)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    # (4) int8 compression with error feedback at full width
    small = train_batches(cfg, max(INT8_STEPS, 3), TRAIN_SMALL_BATCH, seed + 1, dev)
    int8_opt = train_opt.adamw(train_opt.AdamWConfig(
        schedule=train_opt.cosine_schedule(TRAIN_LR, 2, INT8_STEPS)))
    int8_step = train_loop.make_train_step(colbert.loss_fn(model), int8_opt, compression="int8")
    p8, o8, l8, ms8 = run_steps(int8_step, params0,
                               train_loop.init_opt_state(int8_opt, params0, "int8"),
                               small[:INT8_STEPS])
    ef_max = max(float(e.abs().max()) for e in train_tree.leaves(o8["ef"]))
    info["int8"] = dict(batch=TRAIN_SMALL_BATCH, steps=INT8_STEPS, step_p50_ms=statistics.median(ms8[1:]),
                        first_loss=l8[0], last_loss=l8[-1], ef_max_abs=ef_max,
                        held_out_loss_before=before,
                        held_out_loss_after=held_out_loss(judge, p8, held_out))
    assert info["int8"]["held_out_loss_after"] < before and ef_max > 0, info["int8"]
    del p8, o8, judge

    # (5) restart at full width: run_supervised over 3 steps at B = 8 with a
    # checkpoint after step 2 and a failure injected as step 3 starts; the
    # seconds of that save and of the restore come from the run's timeline
    marks: dict = {"stepped": []}
    restored, kept = [], {}

    def step_fn(s, b):
        p_, o_, _ = step(s["params"], s["opt"], b)
        torch.cuda.synchronize()
        marks["stepped"].append(time.perf_counter())
        if int(o_["step"]) == 2:
            kept["state"] = {"params": p_, "opt": o_}
        return {"params": p_, "opt": o_}

    def inject(n):
        if n == 2 and not restored:
            marks["failed"] = time.perf_counter()
            raise RuntimeError("injected failure after the checkpoint at step 2")

    def on_restore(s, st):
        torch.cuda.synchronize()
        marks["restored"] = time.perf_counter()
        same = all(torch.equal(a, b) for a, b in zip(train_tree.leaves(s),
                                                      train_tree.leaves(kept["state"])))
        restored.append((st, int(s["opt"]["step"]), same))

    with tempfile.TemporaryDirectory() as tmp:
        final, n_steps, restarts = ft.run_supervised(
            step_fn, {"params": params0, "opt": train_loop.init_opt_state(opt, params0)},
            small[:3], ckpt_dir=tmp, ckpt_every=2, failure_injector=inject,
            on_restore=on_restore)
        on_disk = sorted(os.listdir(tmp))
        ckpt_bytes = sum(f.stat().st_size for f in Path(tmp, on_disk[0]).rglob("*") if f.is_file())
    info["restart"] = dict(save_s=marks["failed"] - marks["stepped"][1],
                           restore_s=marks["restored"] - marks["failed"],
                           checkpoint_bytes=ckpt_bytes, steps=n_steps, restarts=restarts,
                           restored=restored, final_opt_step=int(final["opt"]["step"]),
                           checkpoints=on_disk)
    assert (n_steps, restarts, restored) == (3, 1, [(2, 2, True)]), info["restart"]
    assert int(final["opt"]["step"]) == 2 and on_disk == ["step_00000002", "step_00000003"]
    del final, kept, small

    # (6) train, then serve: the trained weights through K7, K1 and K2
    counts, info["serve"] = serve_trained(cfg, model, p, seed, dev)
    # training moved the output further than the choice of attention does
    assert (info["serve"]["mean_cos_trained_vs_untrained"]
            < info["serve"]["min_cos_k7_vs_chunked"]), info["serve"]
    return counts


def serve_trained(cfg, model, p, seed, dev) -> tuple[dict, dict]:
    """The trained weights ``p`` served: TRAIN_SERVE_PASSAGES passages and a
    B=32 query batch encoded through K7 (``attn_impl="flash"``),
    ``build_index``, ``plaid-cuda``'s pids equal to ``plaid``'s at the
    paper's probes and at WIDE_PROBES (K1, K2), the served weights ``p``
    bit for bit.  ``model`` holds the untrained weights (it is given ``p``
    here).  Returns the kernels' launches, counted around the serving
    alone, and the phase's record."""
    bb = cfg.backbone
    flash = dataclasses.replace(cfg, backbone=dataclasses.replace(bb, attn_impl="flash"))
    served = colbert.assign_params(
        colbert.ColBERT(flash, transformer.Transformer(flash.backbone, dev)), p)
    g = torch.Generator(device=dev).manual_seed(seed + 32)
    n = TRAIN_SERVE_PASSAGES
    lens = torch.randint(8, DOC_MAXLEN + 1, (n,), generator=g, device=dev, dtype=torch.int32)
    lens[0] = DOC_MAXLEN
    toks = torch.randint(0, bb.vocab, (n, DOC_MAXLEN), generator=g, device=dev)
    mask = torch.arange(DOC_MAXLEN, device=dev)[None, :] < lens[:, None]
    src = torch.randint(0, n, (BATCH,), generator=g, device=dev)
    q_toks = toks[src, :NQ]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    calls, chunks = 0, []
    for i in range(0, n, ENCODE_BATCH):
        e = colbert.encode(served, toks[i : i + ENCODE_BATCH], mask[i : i + ENCODE_BATCH])
        chunks.append(e[mask[i : i + ENCODE_BATCH]])
        calls += 1
    doc_embs = torch.cat(chunks)
    enc_index = index_mod.build_index(doc_embs, lens, seed=seed, device=dev)
    qe = colbert.encode(served, q_toks)
    calls += 1
    # the paper's probes (nprobe 1 and 2) fill few result slots here: a
    # random-weight encoder's token vectors sit together by sequence (the
    # encode phase's untrained weights fill as few), so each probed
    # centroid's list holds few passages.  The wide probes fill the slots,
    # and there plaid-cuda's pids must equal plaid's on nearly every slot.
    pids = {}
    for k, nprobe in [(10, None), (100, None), *WIDE_PROBES]:
        p_k = retrieval.params_for_k(k)
        if nprobe is not None:
            p_k = p_k.replace(nprobe=nprobe)
        got = retrieval.from_index(enc_index, backend="plaid-cuda", params=p_k).search_batch(qe)
        want = retrieval.from_index(enc_index, backend="plaid", params=p_k).search_batch(qe)
        check_result(got, k)
        assert torch.equal(got.pids, want.pids), f"trained weights: pids differ at k={k}"
        assert torch.allclose(got.scores, want.scores, rtol=1e-5, atol=1e-5)
        pids[f"k{k}_nprobe{p_k.nprobe}"] = dict(
            success_at_k=float((got.pids == src[:, None]).any(1).float().mean()),
            filled_share=float((got.pids >= 0).float().mean()))
    counts = ops.launch_counts()
    assert counts["flash_attention"] == bb.n_layers * calls, (counts, calls)
    assert all(counts[name] > 0 for name in SEARCH_KERNELS[:2]), counts
    # the served model computes the trained function: the same weights
    # through the chunked attention, and unlike the untrained weights
    untrained = colbert.encode(model, q_toks)
    colbert.assign_params(model, p)
    trained = colbert.encode(model, q_toks)
    cos = lambda a, b: (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp(min=1e-12)
    served_info = dict(passages=n, tokens=int(doc_embs.shape[0]), centroids=enc_index.num_centroids,
                       encode_calls=calls, launches=counts, search=pids,
                       min_cos_k7_vs_chunked=float(cos(qe, trained).min()),
                       mean_cos_trained_vs_untrained=float(cos(trained, untrained).mean()))
    assert served_info["min_cos_k7_vs_chunked"] >= 0.99, served_info
    assert all(pids[f"k{k}_nprobe{nprobe}"]["filled_share"] >= WIDE_FILLED_MIN
               for k, nprobe in WIDE_PROBES), served_info
    served_info["served_weights_are_trained"] = torch.equal(
        train_loop.replica_checksums(colbert.train_params(served)),
        train_loop.replica_checksums(p))
    assert served_info["served_weights_are_trained"]
    return counts, served_info


def profile_encode(model, toks, reps: int = 3) -> dict:
    """Device time of one warm query encode, grouped: cuBLAS GEMMs, K7 and
    everything else (elementwise ops, norms, reductions, copies)."""
    kern, wall_ms, whole, n = traced_kernels(lambda: colbert.encode(model, toks), reps)
    groups = {"gemm": 0.0, "flash_attention": 0.0, "other": 0.0}
    for e in kern:
        name = e.key.lower()
        grp = ("flash_attention" if "flash_attention_kernel" in name
               else "gemm" if any(t in name for t in ("gemm", "xmma", "nvjet", "cutlass"))
               else "other")
        groups[grp] += e.self_device_time_total / 1e3 / reps
    device_ms = sum(groups.values())
    return dict(
        wall_ms=wall_ms, device_ms=device_ms, device_ms_by_group=groups,
        busy_share=device_ms / wall_ms if device_ms else None,
        launches=sum(e.count for e in kern) // reps, launches_whole=whole, sessions=n,
        top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3 / reps,
                  calls=e.count // reps) for e in kern[:12]],
    )


def k4_nbits_cases(dev, n) -> list:
    """K4 at nbits 1 and 4 on random bytes, as many rows as the stage-3
    block: bit for bit against its plain version."""
    g = torch.Generator(device="cuda").manual_seed(77)
    out = []
    for nbits in (1, 4):
        packed = torch.randint(0, 256, (n, DIM * nbits // 8), generator=g, device=dev,
                               dtype=torch.uint8)
        w = torch.sort(torch.randn(2**nbits, generator=g, device=dev)).values
        got = ops.decompress_residuals(packed, w, nbits=nbits)
        want = ref.decompress_residuals_ref(packed, w, nbits=nbits)
        torch.cuda.synchronize()
        row = dict(nbits=nbits, n=n, pd=packed.shape[1], equal=torch.equal(got, want),
                   max_abs_err=float((got - want).abs().max()),
                   ms=time_ms(lambda: ops.decompress_residuals(packed, w, nbits=nbits), reps=10),
                   bound_ms=k4_bound(packed.numel(), nbits)[0])
        out.append(row)
        assert row["equal"], row
        del packed, got, want
    return out


def vanilla_phase(index, batches) -> list:
    """The ``vanilla`` backend at the reference's vanilla_p4_c8192 settings
    against ``VanillaEngine(impl="ref")`` on the same card (identical pids,
    scores within 1e-5), and against ``plaid-cuda`` at paper Table 2
    settings on the same batches: p50 per batch of each and the ratio, and
    ``plaid-cuda``'s recall@10 against vanilla's top 10 (batch 0 warms up);
    success@k is the share of queries whose source passage each returns."""
    rows = []
    for k in (10, 1000):
        van = retrieval.from_index(index, backend="vanilla",
                                   params=retrieval.SearchParams(k=k, **VANILLA_SETTINGS))
        plain = vanilla.VanillaEngine(index, vanilla.VanillaParams(
            k=k, nprobe=VANILLA_SETTINGS["nprobe"], ncandidates=VANILLA_SETTINGS["candidate_cap"],
            ndocs_cap=VANILLA_SETTINGS["ndocs"], impl="ref"))
        pc = retrieval.from_index(index, backend="plaid-cuda", params=retrieval.params_for_k(k))
        lat = {"vanilla": [], "plaid-cuda": []}
        hits, found = 0, {"vanilla": 0, "plaid-cuda": 0}
        for i, (qb, src) in enumerate(batches):
            got = van.search_batch(qb)
            want_s, want_p = plain.search_batch(qb)
            check_result(got, k)
            assert torch.equal(got.pids, want_p), f"vanilla pids differ from impl='ref' at k={k}"
            assert torch.allclose(got.scores, want_s, rtol=1e-5, atol=1e-5)
            res = pc.search_batch(qb)
            top_v, top_p = got.pids[:, :10], res.pids[:, :10]
            hits += int(((top_p[:, :, None] == top_v[:, None, :]) & (top_v[:, None, :] >= 0))
                        .any(-1).sum())
            for name, r in (("vanilla", got), ("plaid-cuda", res)):
                found[name] += int((r.pids == src[:, None]).any(1).sum())
            if i:
                lat["vanilla"].append(got.latency_ms)
                lat["plaid-cuda"].append(res.latency_ms)
        p50 = {name: statistics.median(xs) for name, xs in lat.items()}
        row = dict(k=k, batch=BATCH, batches=len(batches) - 1, settings=VANILLA_SETTINGS,
                   vanilla_p50_ms=p50["vanilla"], plaid_cuda_p50_ms=p50["plaid-cuda"],
                   vanilla_over_plaid_cuda=p50["vanilla"] / p50["plaid-cuda"],
                   plaid_cuda_recall_at_10_vs_vanilla=hits / (BATCH * len(batches) * 10),
                   success_at_k={name: n / (BATCH * len(batches)) for name, n in found.items()})
        emit({"vanilla": row})
        rows.append(row)
    return rows


def oracle_phase(index, qb) -> list:
    """``plaid._search`` one query at a time, ``impl="cuda"`` (K5, K6) and
    ``"ref"``, against the lanes of one ``plaid-cuda`` batch, for k in
    {10, 100, 1000} at paper Table 2 settings."""
    rows = []
    qm = torch.ones(NQ, device=qb.device)
    s1_all = pipeline.stage1_scores_batched(index, qb)  # the batch's C.Q^T
    for k in (10, 100, 1000):
        eng = plaid.PlaidEngine(index, plaid.params_for_k(k, impl="cuda"))
        kw, t_cs = eng._kwargs(), eng.params.t_cs
        batch = retrieval.from_index(index, backend="plaid-cuda",
                                     params=retrieval.params_for_k(k)).search_batch(qb)
        batch_s, batch_p = batch.scores, batch.pids
        same_s1, ms = 0, []
        for i in range(ORACLE_QUERIES):
            same_s1 += int(torch.equal(scoring.centroid_scores(qb[i], index.centroids), s1_all[i]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_c, p_c = plaid._search(index, qb[i], qm, t_cs=t_cs, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            s_r, p_r = plaid._search(index, qb[i], qm, t_cs=t_cs, **dict(kw, impl="ref"))
            msg = f"k={k} query {i}: stage-1 identical to the batch's for {same_s1} of {i + 1}"
            assert torch.equal(p_c, batch_p[i]), "oracle vs plaid-cuda batch: " + msg
            assert torch.equal(p_c, p_r), "oracle cuda vs ref: " + msg
            assert torch.allclose(s_c, batch_s[i], rtol=1e-5, atol=1e-5), msg
            assert torch.equal(s_c, s_r), msg
        row = dict(k=k, queries=ORACLE_QUERIES, pids_identical=True,
                   stage1_identical_to_batch=same_s1, search_ms_p50=statistics.median(ms))
        emit({"oracle": row})
        rows.append(row)
    del s1_all
    return rows


def funnel_rows(index, batches) -> list:
    """Funnel telemetry on the main index, for k in {10, 100, 1000}: one
    unfused batch with ``with_funnel=True`` through ``plaid-cuda`` and
    ``plaid``, pids identical to each other and to the batch without the
    funnel, every ``FunnelStats`` field identical; each field's mean over
    the batch; then ``plaid-cuda`` funnel off against on, interleaved in one
    process (p50 of FUNNEL_PAIRS pairs of the call's wall time, which
    includes the funnel's copy to the host)."""
    rows = []
    qb = batches[1][0]
    for k in (10, 100, 1000):
        p = retrieval.params_for_k(k)
        cuda_r = retrieval.from_index(index, backend="plaid-cuda", params=p)
        plain_r = retrieval.from_index(index, backend="plaid", params=p)
        on = cuda_r.search_batch(qb, with_funnel=True)
        on_plain = plain_r.search_batch(qb, with_funnel=True)
        off = cuda_r.search_batch(qb)
        check_result(on, k)
        assert off.funnel is None and list(on.funnel) == list(FunnelStats._fields)
        assert torch.equal(on.pids, on_plain.pids), f"funnel: plaid-cuda vs plaid pids, k={k}"
        assert torch.equal(on.pids, off.pids), f"funnel on vs off pids, k={k}"
        assert torch.equal(on.scores, off.scores), f"funnel on vs off scores, k={k}"
        fn = on.funnel
        for f, v in fn.items():
            assert v.shape == (BATCH,) and np.array_equal(v, on_plain.funnel[f]), (k, f)
        assert (fn["stage2_survivors"] <= fn["stage1_candidates"]).all()
        assert (fn["stage3_survivors"] <= fn["stage2_survivors"]).all()
        assert (fn["alive_dropped"] == 0).all() and (fn["gathered_tokens"] > 0).all()
        times = {"off": [], "on": []}
        for i in range(FUNNEL_PAIRS):
            for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cuda_r.search_batch(qb, with_funnel=mode == "on")
                times[mode].append((time.perf_counter() - t0) * 1e3)
        p50 = {mode: statistics.median(xs) for mode, xs in times.items()}
        row = dict(k=k, batch=BATCH, funnel_mean={f: float(v.mean()) for f, v in fn.items()},
                   identical_to_plaid=True, pairs=FUNNEL_PAIRS, off_p50_ms=p50["off"],
                   on_p50_ms=p50["on"], on_minus_off_ms=p50["on"] - p50["off"],
                   off_ms=times["off"], on_ms=times["on"])
        emit({"funnel": row})
        rows.append(row)
    return rows


def delta_passages(index, n, seed):
    """``n`` passages drawn like the main corpus (8..180 tokens), as
    embeddings: each takes its tokens' codes from a random source passage
    (its topic's centroids), uniform residual bytes, and is reconstructed
    through the index's codec.  Returns (packed (nt, d) f32, lens (n,))."""
    dev = index.device
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.normal(70.0, 40.0, (n,), generator=g, device=dev)
    lens = lens.round().clamp(8, DOC_MAXLEN).to(torch.int32)
    src = torch.randint(0, index.num_passages, (n,), generator=g, device=dev)
    tok_src = torch.repeat_interleave(src, lens.long())
    pos = (torch.rand(tok_src.shape[0], generator=g, device=dev)
           * index.doc_lens[tok_src]).long()
    codes = index.codes[index.doc_offsets[tok_src].long() + pos]
    residuals = torch.randint(0, 256, (codes.shape[0], DIM * NBITS // 8), generator=g,
                              device=dev, dtype=torch.uint8)
    return rc.decompress(index.codec, codes, residuals, index.centroids), lens


def count_stage1(fn):
    """Calls of ``pipeline.stage1_scores_batched`` (the C·Qᵀ GEMM) made by
    ``fn()``, counted through a wrapper installed for the call."""
    calls = [0]
    real = pipeline.stage1_scores_batched

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    pipeline.stage1_scores_batched = counted
    try:
        fn()
    finally:
        pipeline.stage1_scores_batched = real
    return calls[0]


def same_as_plaid_cuda(live_idx, base, k, qb) -> dict:
    """``live-cuda`` over a one-segment live index against ``plaid-cuda``
    over its base: scores ``torch.equal``, and pids equal once
    ``plaid-cuda``'s are put in the merge's order.  The live search merges
    its partitions with ``merge_topk``, which orders equal scores by pid
    (the reference's ``jax.lax.sort`` does the same), where ``plaid-cuda``'s
    top-k keeps them in finalist order; returns how many slots that
    reordered."""
    p = retrieval.params_for_k(k)
    got = retrieval.from_index(live_idx, backend="live-cuda", params=p).search_batch(qb)
    want = retrieval.from_index(base, backend="plaid-cuda", params=p).search_batch(qb)
    check_result(got, k)
    merged_s, merged_p = merge_topk(want.scores, want.pids, k)
    assert torch.equal(got.scores, want.scores) and torch.equal(merged_s, want.scores), k
    assert torch.equal(got.pids, merged_p), f"live-cuda vs plaid-cuda pids, k={k}"
    return dict(identical=True, tie_slots_reordered=int((merged_p != want.pids).sum()))


def live_phase(index, batches, seed, info: dict) -> None:
    """The live index (``repro_torch.live``, backends ``live-cuda`` and
    ``live``) over the main index as its base segment, shared, not copied.

    Check 0: with no deltas ``live-cuda`` gives ``plaid-cuda``'s pids and
    scores.  Then LIVE_DELTAS passages are added as three delta segments
    (``add_passages``, timed) and LIVE_BASE_DELETES base pids plus
    LIVE_DELTA_DELETES of the first delta tombstoned.  Check 1: for k 10
    and 1000 unfused and 1000 fused, one warm-up and TIMED_BATCHES B=32
    batches: ``live-cuda`` (K1-K3 on every segment) and ``live`` (plain,
    same card) give identical pids and scores, no tombstoned pid; with the
    funnel every field identical and ``alive_dropped > 0`` in some lane.
    Cost of the deltas: ``live-cuda`` against ``plaid-cuda`` on the bare
    base, LIVE_PAIRS interleaved pairs; kernel launches a batch (profiler)
    and ``stage1_scores_batched`` calls a batch (1: stage 1 is shared by
    every segment).  ``compact()`` timed with its peak device bytes; check
    2: ``live-cuda`` over the compacted base equals ``plaid-cuda`` over
    that base, and the pid map drops exactly the tombstones."""
    base_n = index.num_passages
    live_idx = live.LiveIndex(index)
    # ---- check 0: zero deltas
    info["check0_bare_base_equals_plaid_cuda"] = {
        k: same_as_plaid_cuda(live_idx, index, k, batches[1][0]) for k in (10, 1000)}

    # ---- three deltas, then tombstones
    adds = []
    for i, n in enumerate(LIVE_DELTAS):
        emb, lens = delta_passages(index, n, seed + 100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pids = live_idx.add_passages(emb, doc_lens=lens)
        torch.cuda.synchronize()
        adds.append(dict(passages=n, tokens=int(lens.sum()), seconds=time.perf_counter() - t0,
                         first_pid=int(pids[0])))
        del emb
    g = np.random.default_rng(seed + 5)
    dead = np.concatenate([
        g.choice(base_n, LIVE_BASE_DELETES, replace=False),
        base_n + g.choice(LIVE_DELTAS[0], LIVE_DELTA_DELETES, replace=False)])
    assert live_idx.delete(dead) == dead.size
    dead_t = torch.zeros(live_idx.num_passages, dtype=torch.bool, device=index.device)
    dead_t[torch.from_numpy(dead).to(index.device)] = True
    segs = live_idx.snapshot().segments
    info.update(adds=adds, deltas=[s.num_passages for s in segs[1:]],
                delta_tokens=[s.num_tokens for s in segs[1:]], tombstones=int(dead.size),
                generation=live_idx.generation)

    # ---- check 1: live-cuda against live (plain), with deltas + tombstones
    rows = []
    for k, fused in ((10, False), (1000, False), (1000, True)):
        p = retrieval.params_for_k(k).replace(fused=fused)
        cuda_r = retrieval.from_index(live_idx, backend="live-cuda", params=p)
        plain_r = retrieval.from_index(live_idx, backend="live", params=p)
        lat = {"live-cuda": [], "live": []}
        for i, (qb, _) in enumerate(batches):
            rc_, rp_ = cuda_r.search_batch(qb), plain_r.search_batch(qb)
            check_result(rc_, k)
            assert bool((rc_.pids >= 0).all()), "fewer than k results"
            assert torch.equal(rc_.pids, rp_.pids), f"live: pids differ k={k} fused={fused}"
            assert torch.equal(rc_.scores, rp_.scores), f"live: scores differ k={k} fused={fused}"
            assert not bool(dead_t[rc_.pids.long()].any()), "a tombstoned pid came back"
            if i:
                lat["live-cuda"].append(rc_.latency_ms)
                lat["live"].append(rp_.latency_ms)
        fc = cuda_r.search_batch(batches[1][0], with_funnel=True)
        fp = plain_r.search_batch(batches[1][0], with_funnel=True)
        assert torch.equal(fc.pids, fp.pids)
        for f, v in fc.funnel.items():
            assert np.array_equal(v, fp.funnel[f]), f"live funnel {f}, k={k} fused={fused}"
        assert (fc.funnel["alive_dropped"] > 0).any(), "no tombstone met a candidate"
        from_deltas = int((rc_.pids >= base_n).sum())
        row = dict(k=k, fused=fused, batches=len(batches) - 1, identical=True,
                   funnel_mean={f: float(v.mean()) for f, v in fc.funnel.items()},
                   pids_from_deltas_last_batch=from_deltas,
                   **{name: dict(p50_ms=statistics.median(xs)) for name, xs in lat.items()})
        emit({"live": row})
        rows.append(row)
    info["check1_live_cuda_equals_live"] = rows

    # ---- the cost of the deltas: live-cuda vs plaid-cuda on the bare base
    cost = []
    qb = batches[1][0]
    for k in (10, 1000):
        p = retrieval.params_for_k(k)
        live_r = retrieval.from_index(live_idx, backend="live-cuda", params=p)
        bare_r = retrieval.from_index(index, backend="plaid-cuda", params=p)
        times = {"live-cuda": [], "plaid-cuda": []}
        for i in range(LIVE_PAIRS):
            order = (live_r, bare_r) if i % 2 == 0 else (bare_r, live_r)
            for r in order:
                times[r.backend_name].append(r.search_batch(qb).latency_ms)
        before = ops.launch_counts()
        stage1_calls = count_stage1(lambda: live_r.search_batch(qb))
        kernel_launches = {n: c - before[n] for n, c in ops.launch_counts().items()}
        assert stage1_calls == 1, f"stage 1 ran {stage1_calls} times a batch"
        prof_live, prof_bare = profile_batch(live_r, qb), profile_batch(bare_r, qb)
        p50 = {name: statistics.median(xs) for name, xs in times.items()}
        row = dict(k=k, pairs=LIVE_PAIRS, live_cuda_p50_ms=p50["live-cuda"],
                   plaid_cuda_p50_ms=p50["plaid-cuda"],
                   live_minus_plaid_ms=p50["live-cuda"] - p50["plaid-cuda"], ms=times,
                   stage1_calls_a_batch=stage1_calls,
                   port_kernel_launches_a_batch={n: c for n, c in kernel_launches.items() if c},
                   launches_a_batch=dict(live_cuda=prof_live["launches"],
                                         plaid_cuda=prof_bare["launches"]),
                   device_ms=dict(live_cuda=prof_live["device_ms"],
                                  plaid_cuda=prof_bare["device_ms"]))
        emit({"live_cost": row})
        cost.append(row)
    info["cost_of_deltas"] = cost

    # ---- compaction, then check 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pid_map = live_idx.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - resident
    new_base = live_idx.base
    assert live_idx.num_segments == 1 and live_idx.num_deleted == 0
    assert new_base.num_passages == pid_map.shape[0] - dead.size
    assert (pid_map[dead] == -1).all() and (np.delete(pid_map, dead) >= 0).all()
    info.update(compact_s=compact_s, compact_peak_device_bytes=peak,
                compacted_passages=new_base.num_passages, compacted_tokens=new_base.num_tokens,
                check2_compacted_equals_plaid_cuda={
                    k: same_as_plaid_cuda(live_idx, new_base, k, qb) for k in (10, 1000)})


def counted(counts: dict, fn, *a, **kw):
    """``fn(*a, **kw)`` and the port's kernel launches it made (the counts'
    change across the call), added into ``counts``."""
    before = ops.launch_counts()
    out = fn(*a, **kw)
    per = {n: c - before[n] for n, c in ops.launch_counts().items()}
    for n, c in per.items():
        counts[n] = counts.get(n, 0) + c
    return out, per


def assert_tiered_launches(per: dict, fused: bool, where) -> None:
    """A tiered batch's launches: K1 (phase A) and K2 unfused or K3 fused
    (phase B), and no other kernel of the port."""
    k1, k2, k3 = (per[n] for n in SEARCH_KERNELS)
    ok = k1 > 0 and ((k3 > 0 and k2 == 0) if fused else (k2 > 0 and k3 == 0))
    others = {n: c for n, c in per.items() if n not in SEARCH_KERNELS and c}
    assert ok and not others, (where, fused, per)


def tiered_batch_split(eng, qb, counts: dict) -> tuple[dict, tuple]:
    """One batch of ``eng`` (a ``TieredEngine``) with ``time_steps`` set:
    the engine's own step times (``last_steps``: phase A's and phase B's
    device ms, the finalists' copy to the host, the host slice gather, the
    copy's enqueue and its device ms on the copy stream) and the batch's
    wall ms.  Returns the split and the batch's (scores, pids)."""
    eng.time_steps = True
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    out, per = counted(counts, eng.search_batch, qb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    eng.time_steps = False
    assert_tiered_launches(per, eng.params.fused, "split")
    return dict(eng.last_steps(), wall_ms=wall * 1e3,
                staged_bytes=eng.last_transfer.staged_bytes), out


def check_transfer(eng, tiered, index, qb) -> dict:
    """The engine's last ``TransferStats`` against ``tiered_transfer_cost``
    of an independent recount: stages 1-3 in plain torch (no kernel
    launch) on the resident index, the finalists' pool and its CSR token
    count.  Exact, and the slices below the resident payload."""
    ep = plaid.clamp_params(dataclasses.replace(eng.params, impl="ref"), index.num_passages)
    qm = torch.ones(qb.shape[:2], device=qb.device)
    fp, *_ = pipeline.select_finalists_impl(index, qb, qm, ep.t_cs, params=ep,
                                            keep_blocks=False)
    fp = fp.cpu().numpy()
    pool = np.unique(fp[fp >= 0])
    tokens = int(tiered.host_doc_lens[pool].sum())
    model = tiered_transfer_cost(
        pool_docs=pool.size, slice_tokens=tokens, pd=tiered.host_residuals.shape[1],
        n3=fp.shape[1], B=fp.shape[0], p_cap=pow2_bucket(max(pool.size, 1), lo=1),
        t_cap=pow2_bucket(max(tokens, 1), lo=index.doc_maxlen),
    )
    st = eng.last_transfer
    assert (st.pool_docs, st.slice_tokens) == (pool.size, tokens), (st, pool.size, tokens)
    assert st.slice_bytes == model["slice_bytes"], (st, model)
    assert st.staged_bytes == model["staged_bytes"], (st, model)
    assert st.slice_bytes < tiered.resident_payload_nbytes()
    return st.as_dict()


def tiered_roundtrip(index, qb) -> dict:
    """``save`` / ``load`` of ``plaid-tiered-cuda`` over ``index``: the
    directory loads back as ``plaid-tiered-cuda`` with memory-mapped
    payloads, and the same batch gives identical scores and pids."""
    r = retrieval.from_index(index, backend="plaid-cuda",
                             params=retrieval.params_for_k(10).replace(tiered=True))
    before = r.search_batch(qb)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        r.save(tmp)
        t1 = time.perf_counter()
        r2 = retrieval.load(tmp, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        disk_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        assert r2.backend_name == "plaid-tiered-cuda" and r2.params.tiered
        assert isinstance(r2.tiered.host_residuals, np.memmap)
        assert isinstance(r2.tiered.host_codes, np.memmap)
        after = r2.search_batch(qb)
        assert torch.equal(before.pids, after.pids) and torch.equal(before.scores, after.scores)
        out = dict(passages=r2.tiered.num_passages, tokens=r2.tiered.num_tokens,
                   save_s=t1 - t0, load_s=t2 - t1, disk_bytes=disk_bytes, mmapped=True,
                   identical=True)
        del r2
    return out


def tiered_phase(index, batches, info: dict) -> dict:
    """The tiered index (``repro_torch.core.tiered``, backends
    ``plaid-tiered-cuda`` and ``plaid-tiered``) over the main index.

    (1) ``tiered_from_index`` demotes it (the device tensors it keeps are
    shared): device-tier bytes against the resident engine's, the host
    payload bytes.  (2) For k in TIERED_KS, fused and not, a warm-up and
    TIMED_BATCHES B=32 batches: ``plaid-tiered-cuda`` equals ``plaid-cuda``
    under ``torch.equal`` (scores and pids) and launches K1 and K2 (K3
    fused) every batch; per k one batch through ``plaid-tiered`` (plain,
    same card, no kernel launch) equals it too, and with the funnel every
    field equals ``plaid-cuda``'s.  (3) Every batch's
    ``TransferStats`` equals ``tiered_transfer_cost`` of an independent
    recount (:func:`check_transfer`); pool docs, slice tokens and bytes,
    staged bytes, the copy's device ms and GB/s.  (4) Per k (unfused) the
    batch split (:func:`tiered_batch_split`, median of TIERED_SPLITS), the
    peak device bytes of a batch beside ``plaid-cuda``'s, p50 of
    TIERED_PAIRS interleaved pairs and launches a batch (profiler).  (5) ``n_shards=2`` equals each partition's resident
    ``plaid-cuda`` plus ``merge_topk``, bit for bit.  (6) The staging ring:
    a slot handed out again waits for the copy that reads it (queued
    behind a device sleep), and three batches with a device sleep queued
    on the copy stream before each copy equal the resident engine's.  The
    save / load round trip runs in phase ``quality`` on its 2^16-passage
    index (:func:`tiered_roundtrip`): at 2M passages the save alone took
    ~40 s, over this phase's 60 s target.

    Returns the port's kernel launches of the tiered calls alone (each
    taken by :func:`counted`), not those of the resident oracle.
    """
    qb = batches[1][0]
    counts: dict = {}
    # ---- (1) demote
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiered = tiered_mod.tiered_from_index(index)
    demote_s = time.perf_counter() - t0
    assert tiered.device.codes is index.codes and tiered.device.centroids is index.centroids
    dev_b, res_b = tiered.device_nbytes(), tiered.resident_nbytes()
    assert res_b == sum(index.nbytes().values()), (res_b, index.nbytes())
    info["demote"] = dict(
        seconds=demote_s, device_nbytes=dev_b, resident_nbytes=res_b,
        resident_over_device=res_b / dev_b,
        host_payload_bytes=tiered.host_codes.nbytes + tiered.host_residuals.nbytes,
        resident_payload_nbytes=tiered.resident_payload_nbytes(),
    )
    emit({"tiered_demote": info["demote"]})

    # ---- (2) identity and (3) transfer
    rows, unfused = [], {}
    for k in TIERED_KS:
        for fused in (False, True):
            p = retrieval.params_for_k(k).replace(fused=fused)
            tr = retrieval.from_index(tiered, backend="plaid-cuda", params=p.replace(tiered=True))
            rr = retrieval.from_index(index, backend="plaid-cuda", params=p)
            assert tr.backend_name == "plaid-tiered-cuda"
            eng = tr._executor.engines[0]
            lat = {"plaid-tiered-cuda": [], "plaid-cuda": []}
            stats = []
            for i, (qbi, _) in enumerate(batches):
                got, per = counted(counts, tr.search_batch, qbi)
                want = rr.search_batch(qbi)
                assert_tiered_launches(per, fused, ("identity", k, i))
                check_result(got, k)
                assert torch.equal(got.pids, want.pids), f"tiered pids k={k} fused={fused}"
                assert torch.equal(got.scores, want.scores), f"tiered scores k={k} fused={fused}"
                copy_ms = eng.last_copy_ms()
                st = check_transfer(eng, tiered, index, qbi)
                if i:
                    lat["plaid-tiered-cuda"].append(got.latency_ms)
                    lat["plaid-cuda"].append(want.latency_ms)
                    stats.append(dict(st, copy_ms=copy_ms))
            copy = statistics.median(s["copy_ms"] for s in stats)
            row = dict(k=k, fused=fused, batches=len(batches) - 1, identical=True,
                       transfer_exact=True,
                       kernel_launches_a_batch={n: c for n, c in per.items() if c},
                       **{f: statistics.mean(s[f] for s in stats) for f in
                          ("pool_docs", "slice_tokens", "slice_bytes", "staged_bytes")},
                       copy_ms=copy,
                       copy_gb_s=statistics.mean(s["staged_bytes"] for s in stats) / copy / 1e6,
                       **{name: dict(p50_ms=statistics.median(xs)) for name, xs in lat.items()})
            if not fused:
                plain = retrieval.from_index(tiered, backend="plaid", params=p.replace(tiered=True))
                assert plain.backend_name == "plaid-tiered"
                got, per = counted(counts, tr.search_batch, qb)
                other, none = counted({}, plain.search_batch, qb)
                assert_tiered_launches(per, fused, ("plain", k))
                assert not any(none.values()), ("plaid-tiered launched a kernel", none)
                assert torch.equal(got.pids, other.pids) and torch.equal(got.scores, other.scores)
                fg, per = counted(counts, tr.search_batch, qb, with_funnel=True)
                assert_tiered_launches(per, fused, ("funnel", k))
                fw = rr.search_batch(qb, with_funnel=True)
                assert torch.equal(fg.pids, fw.pids)
                for f, v in fg.funnel.items():
                    assert np.array_equal(v, fw.funnel[f]), f"tiered funnel {f}, k={k}"
                row.update(plain_identical=True, funnel_identical=True)
                unfused[k] = (tr, rr)
            emit({"tiered": row})
            rows.append(row)
    info["identity_and_transfer"] = rows

    # ---- (4) where a batch's time goes
    split_rows = []
    for k, (tr, rr) in unfused.items():
        eng = tr._executor.engines[0]
        splits = []
        for _ in range(TIERED_SPLITS):
            sp, (s, pid) = tiered_batch_split(eng, qb, counts)
            want = rr.search_batch(qb)
            assert torch.equal(s, want.scores) and torch.equal(pid, want.pids)
            splits.append(sp)
        split = {f: statistics.median(sp[f] for sp in splits) for f in splits[0]}
        peak = {}
        for r in (tr, rr):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            counted(counts if r is tr else {}, r.search_batch, qb)
            torch.cuda.synchronize()
            peak[r.backend_name] = torch.cuda.max_memory_allocated() - before
        times = {"plaid-tiered-cuda": [], "plaid-cuda": []}
        for i in range(TIERED_PAIRS):
            for r in ((tr, rr) if i % 2 == 0 else (rr, tr)):
                res, _ = counted(counts if r is tr else {}, r.search_batch, qb)
                times[r.backend_name].append(res.latency_ms)
        prof_t, prof_r = profile_batch(tr, qb), profile_batch(rr, qb)
        p50 = {name: statistics.median(xs) for name, xs in times.items()}
        row = dict(k=k, fused=False, splits=TIERED_SPLITS, split_median=split,
                   peak_device_bytes_a_batch=peak, pairs=TIERED_PAIRS,
                   tiered_cuda_p50_ms=p50["plaid-tiered-cuda"], plaid_cuda_p50_ms=p50["plaid-cuda"],
                   tiered_minus_plaid_ms=p50["plaid-tiered-cuda"] - p50["plaid-cuda"], ms=times,
                   launches_a_batch=dict(tiered_cuda=prof_t["launches"],
                                         plaid_cuda=prof_r["launches"]),
                   launches_whole=dict(tiered_cuda=prof_t["launches_whole"],
                                       plaid_cuda=prof_r["launches_whole"]),
                   device_ms=dict(tiered_cuda=prof_t["device_ms"], plaid_cuda=prof_r["device_ms"]),
                   wall_ms_profiled=dict(tiered_cuda=prof_t["wall_ms"],
                                         plaid_cuda=prof_r["wall_ms"]),
                   top_kernels_tiered=prof_t["top"][:6])
        emit({"tiered_split": row})
        split_rows.append(row)
    info["batch_split"] = split_rows
    unfused.clear()

    # ---- (5) two partitions against the per-partition resident oracle
    parts, offs = partition_tiered(tiered, 2)
    part_rows = []
    for k in (10, 1000):
        p = retrieval.params_for_k(k)
        tr2 = retrieval.from_index(tiered, backend="plaid-cuda", params=p.replace(tiered=True),
                                   n_shards=2)
        got, per = counted(counts, tr2.search_batch, qb)
        assert_tiered_launches(per, False, ("partitions", k))
        check_result(got, k)
        ss, pp = [], []
        for part, off in zip(parts, offs):
            t_lo = int(tiered.host_doc_offsets[off])
            dense = dataclasses.replace(
                part.device, residuals=index.residuals[t_lo : t_lo + part.num_tokens])
            res = retrieval.from_index(dense, backend="plaid-cuda", params=p).search_batch(qb)
            ss.append(res.scores)
            pp.append(torch.where(res.pids >= 0, res.pids + off, -1))
        want_s, want_p = merge_topk(torch.cat(ss, 1), torch.cat(pp, 1), k)
        assert torch.equal(got.scores, want_s), f"partitioned scores k={k}"
        assert torch.equal(got.pids, want_p), f"partitioned pids k={k}"
        part_rows.append(dict(k=k, n_partitions=2, identical=True,
                              partition_passages=[q.num_passages for q in parts],
                              transfer=tr2.transfer_totals))
    info["partitions"] = part_rows
    del parts

    # ---- (6) the staging ring under a device sleep on the copy stream
    p = plaid.params_for_k(1000, impl="cuda")
    eng = tiered_mod.TieredEngine(tiered, p)
    ring = eng._staging
    shapes = dict(codes=(1 << 22,), res=(1 << 22, DIM * NBITS // 8), offs=(1 << 15 | 1,),
                  lens=(1 << 15,), pos=(BATCH, 1024))
    slot, staged = ring.take(shapes)
    g = torch.Generator().manual_seed(3)
    for s in staged:
        s.copy_(torch.randint(0, 100, s.shape, generator=g, dtype=s.dtype))
    want = [s.clone() for s in staged]
    with torch.cuda.stream(ring.stream):
        torch.cuda._sleep(RING_SLEEP_CYCLES)
    moved = ring.upload(slot, staged)
    ring.take(shapes)
    again, views = ring.take(shapes)  # the first slot: waits for its copy
    assert again is slot
    for v in views:
        v.zero_()
    torch.cuda.synchronize()
    assert all(torch.equal(m.cpu(), w) for m, w in zip(moved, want)), "ring slot overwritten"
    del moved, want, staged, views
    real = ring.upload

    def delayed(slot, staged):
        with torch.cuda.stream(ring.stream):
            torch.cuda._sleep(RING_SLEEP_CYCLES)
        return real(slot, staged)

    ring.upload = delayed
    resident = plaid.PlaidEngine(index, p)
    for qbi, _ in batches[1:4]:
        got, per = counted(counts, eng.search_batch, qbi)
        want = resident.search_batch(qbi)
        assert_tiered_launches(per, False, "ring")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "ring check"
    info["ring"] = dict(slot_reuse_waits=True, delayed_batches=3, identical=True,
                        sleep_cycles=RING_SLEEP_CYCLES)
    del eng, resident, tiered
    return counts


# --------------------------------------------------------------------------
# phase serve: the serving tier over plaid-cuda, live-cuda, plaid-tiered-cuda
# --------------------------------------------------------------------------
def served_pending(q, t_cs, k):
    return serve_server._Pending(q=q, t_cs=t_cs, k=k, t0=time.perf_counter(), deadline=None,
                                 future=serve_server.ResultFuture(), cache_key=None)


def span_ms(tracer) -> dict:
    """Median host ms of each ``serve.*`` span the tracer holds."""
    names = sorted({s.name for s in tracer.spans() if s.name.startswith("serve.")})
    return {n: statistics.median(tracer.durations_ms(n)) for n in names}


def run_clients(n_threads, fn, timeout_s):
    """``fn(tid)`` on ``n_threads`` threads started together; raises the
    first error any raised, and fails if a thread is still running after
    ``timeout_s``.  Returns the wall seconds."""
    errors, start = [], threading.Barrier(n_threads + 1)

    def body(tid):
        try:
            start.wait(timeout=60)
            fn(tid)
        except BaseException as exc:  # re-raised on the main thread below
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(i,), daemon=True) for i in range(n_threads)]
    for t in threads:
        t.start()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=max(timeout_s - (time.perf_counter() - t0), 1.0))
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "a client thread hung"
    if errors:
        raise errors[0]
    return wall


def assert_served_launches(per: dict, dispatches: int, where) -> None:
    """A ``plaid-cuda`` (or single-partition tiered) batch at k=10 unfused
    launches K1 twice (stages 2 and 3) and K2 once, and nothing else."""
    k1, k2, k3 = (per[n] for n in SEARCH_KERNELS)
    others = {n: c for n, c in per.items() if n not in SEARCH_KERNELS and c}
    assert dispatches > 0 and k1 == 2 * dispatches and k2 == dispatches and k3 == 0, \
        (where, dispatches, per)
    assert not others, (where, others)


def serve_buckets(srv, r, pool, counts) -> list:
    """Check 1: coalesced batches of SERVE_BUCKET_NS distinct queries with
    mixed per-request ``t_cs`` and ``k`` through ``_dispatch``: each lane
    equals the same lane of a direct ``search_batch`` of the padded bucket
    (``np.array_equal``, scores and pids) and has a direct single-query
    ``search``'s pids at its own ``t_cs``, scores within relative 1e-5."""
    rows, at = [], 0
    for n in SERVE_BUCKET_NS:
        knobs = [(SERVE_T_CS[i % 3], SERVE_KS[(i // 3) % 3]) for i in range(n)]
        qs = [pool[at + i] for i in range(n)]
        at += n
        batch = [served_pending(q, t, k) for q, (t, k) in zip(qs, knobs)]
        _, per = counted(counts, srv._dispatch, batch)
        assert_served_launches(per, 1, f"bucket n={n}")
        bucket = serve_buckets_mod.bucket_batch_size(n, SERVE_BATCH)
        pq, pt = serve_buckets_mod.pad_batch(qs, [t for t, _ in knobs], bucket)
        direct = r.search_batch(pq, t_cs=pt)
        d_s, d_p = direct.scores.cpu().numpy(), direct.pids.cpu().numpy()
        for i, (p, (t, k)) in enumerate(zip(batch, knobs)):
            res = p.future.get(timeout=60)
            assert res.k == k and res.t_cs == t and res.pids.shape == (k,)
            assert np.array_equal(res.pids, d_p[i, :k]), (n, i, "pids vs search_batch")
            assert np.array_equal(res.scores, d_s[i, :k]), (n, i, "scores vs search_batch")
            one = r.search(qs[i], t_cs=t)
            assert np.array_equal(res.pids, one.pids.cpu().numpy()[:k]), (n, i, "pids vs search")
            np.testing.assert_allclose(res.scores, one.scores.cpu().numpy()[:k], rtol=1e-5)
        rows.append(dict(n=n, bucket=bucket, lanes_equal_search_batch=True,
                         pids_equal_search=True))
    return rows


def serve_load(r, pool) -> tuple[dict, dict]:
    """Check 2: SERVE_CLIENTS client threads, each submitting single
    queries (closed loop) from ``pool`` with the cache off, in SERVE_ROUNDS
    rounds of SERVE_REQUESTS // SERVE_ROUNDS requests, each round after
    one of direct B=SERVE_BATCH ``search_batch`` calls over the same
    queries.  Launches are counted around the rounds (one dispatcher
    launches): K1 = 2 x dispatches, K2 = dispatches.  Returns the row and
    the launches."""
    tracer = Tracer(capacity=4 * SERVE_REQUESTS)
    srv = serving.BatchingServer(r, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                 cache_size=None, latency_window=SERVE_REQUESTS,
                                 tracer=tracer, registry=MetricsRegistry())
    per_round = SERVE_REQUESTS // SERVE_ROUNDS
    counts: dict = {}
    direct_ms, load_s, qps = [], 0.0, []
    try:
        # the server's first dispatch, outside the counts; the latency
        # window (SERVE_REQUESTS long) rotates it out
        srv.search(pool[0], timeout=60)
        d0 = srv.stats()["dispatches"]
        tracer.clear()
        for rnd in range(SERVE_ROUNDS):
            lo = rnd * per_round
            for b in range(lo, lo + per_round, SERVE_BATCH):
                direct_ms.append(r.search_batch(pool[b:b + SERVE_BATCH]).latency_ms)

            def client(tid, lo=lo):
                for j in range(tid, per_round, SERVE_CLIENTS):
                    res = srv.search(pool[lo + j], timeout=120)
                    assert res.pids.shape == (10,) and not res.cached

            wall, _ = counted(counts, run_clients, SERVE_CLIENTS, client, 300)
            load_s += wall
            qps.append(per_round / wall)
        st = srv.stats()
    finally:
        srv.shutdown()
    dispatches = st["dispatches"] - d0
    assert_served_launches(counts, dispatches, "load")
    assert st["completed"] == SERVE_REQUESTS + 1 and st["errors"] == 0, st
    spans = tracer.spans("serve.dispatch")
    assert len(spans) == dispatches and sum(s.attrs["n"] for s in spans) == SERVE_REQUESTS
    p50_direct = statistics.median(direct_ms)
    row = dict(
        clients=SERVE_CLIENTS, requests=SERVE_REQUESTS, rounds=SERVE_ROUNDS,
        qps=SERVE_REQUESTS / load_s, qps_rounds=qps, p50_ms=st["p50_ms"], p99_ms=st["p99_ms"],
        mean_ms=st["mean_ms"], dispatches=dispatches,
        buckets=dict(collections.Counter(s.attrs["bucket"] for s in spans)),
        mean_requests_a_dispatch=SERVE_REQUESTS / dispatches,
        mean_occupancy=statistics.mean(s.attrs["n"] / s.attrs["bucket"] for s in spans),
        direct_b32_p50_ms=p50_direct, direct_b32_qps=SERVE_BATCH / p50_direct * 1e3,
        direct_batches=len(direct_ms),
        served_over_direct_qps=SERVE_REQUESTS / load_s / (SERVE_BATCH / p50_direct * 1e3),
        span_median_ms=span_ms(tracer), launches=counts,
    )
    return row, counts


def serve_lone_and_cache(r, pool) -> tuple[dict, dict]:
    """Check 3: one closed-loop client (bucket 1 every time), its p50
    beside a direct B=1 ``search``, interleaved.  Check 4: SERVE_CACHE
    queries submitted twice through a cached server: every hit equals the
    miss it repeats (``np.array_equal``), hit_rate, p50 of a hit."""
    srv = serving.BatchingServer(r, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                 cache_size=None, tracer=Tracer(), registry=MetricsRegistry())
    served, direct = [], []
    try:
        for i in range(SERVE_LONE):
            served.append(srv.search(pool[i], timeout=60).latency_ms)
            direct.append(r.search(pool[i]).latency_ms)
        lone_st = srv.stats()
    finally:
        srv.shutdown()
    assert set(lone_st["buckets"]) == {1}, lone_st["buckets"]
    lone = dict(requests=SERVE_LONE, served_p50_ms=statistics.median(served),
                direct_b1_p50_ms=statistics.median(direct), buckets=lone_st["buckets"])

    srv = serving.BatchingServer(r, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                 cache_size=2 * SERVE_CACHE, tracer=Tracer(),
                                 registry=MetricsRegistry())
    try:
        misses = [f.get(timeout=120) for f in [srv.submit(pool[i]) for i in range(SERVE_CACHE)]]
        hits = [f.get(timeout=120) for f in [srv.submit(pool[i]) for i in range(SERVE_CACHE)]]
        cache = srv.stats()["cache"]
    finally:
        srv.shutdown()
    for m, h in zip(misses, hits):
        assert not m.cached and h.cached
        assert np.array_equal(m.pids, h.pids) and np.array_equal(m.scores, h.scores)
    assert cache["hits"] == SERVE_CACHE and cache["hit_rate"] == 0.5, cache
    return lone, dict(queries=SERVE_CACHE, hit_rate=cache["hit_rate"], hits=cache["hits"],
                      hit_p50_ms=statistics.median(h.latency_ms for h in hits),
                      miss_p50_ms=statistics.median(m.latency_ms for m in misses),
                      hits_identical=True)


def serve_live(index, pool, seed, counts) -> dict:
    """Check 5: ``live-cuda`` over the main index (shared as its base)
    served to SERVE_LIVE_CLIENTS threads while a mutator thread runs
    SERVE_LIVE_CYCLES cycles of ``add_passages`` (LIVE_DELTAS[-1]
    passages), a delete of half of them and ``compact()``.  Only typed
    errors are allowed and no thread may hang; once quiet every (query,
    t_cs) served equals a direct ``live-cuda`` search (pids identical,
    scores within relative 1e-5); then an entry goes stale across one more
    ``add_passages`` and ``invalidations`` rises by one."""
    live_idx = live.LiveIndex(index)
    lr = retrieval.from_index(live_idx, backend="live-cuda", params=retrieval.params_for_k(10))
    srv = serving.BatchingServer(lr, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                 cache_size=1024, tracer=Tracer(), registry=MetricsRegistry())
    queries = [pool[i] for i in range(SERVE_LIVE_QUERIES)]
    done, mutations = threading.Event(), []
    delta = [delta_passages(index, LIVE_DELTAS[-1], seed + 300 + c)
             for c in range(SERVE_LIVE_CYCLES + 1)]
    torch.cuda.synchronize()

    def timed(op, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        mutations.append(dict(op=op, seconds=time.perf_counter() - t0))
        return out

    def mutator():
        try:
            for c in range(SERVE_LIVE_CYCLES):
                emb, lens = delta[c]
                added = timed("add_passages", srv.add_passages, emb, doc_lens=lens)
                timed("delete_passages", srv.delete_passages, added[: added.size // 2])
                timed("compact", srv.compact)
        finally:
            done.set()

    def client(tid):
        if tid == SERVE_LIVE_CLIENTS:
            return mutator()
        rng = np.random.default_rng(seed + tid)
        i = 0
        while not done.is_set() or i < SERVE_LIVE_MIN:
            i += 1
            q = queries[rng.integers(len(queries))]
            t = SERVE_T_CS[rng.integers(len(SERVE_T_CS))]
            try:
                res = srv.search(q, t_cs=t, timeout=120)
            except (serving.QueueFull, serving.DeadlineExceeded):
                continue  # typed shedding is allowed
            assert res.pids.shape == (10,)

    try:
        _, per = counted(counts, run_clients, SERVE_LIVE_CLIENTS + 1, client, 300)
        assert per["centroid_interaction_batched"] > 0 and per["decompress_and_score_batched"] > 0
        st = srv.stats()
        assert st["errors"] == 0 and st["completed"] > 0, st
        assert live_idx.num_deltas == 0 and live_idx.generation == 3 * SERVE_LIVE_CYCLES
        for q in queries:
            for t in SERVE_T_CS:
                served = srv.search(q, t_cs=t, timeout=120)
                direct = lr.search(q, t_cs=t)
                assert np.array_equal(served.pids, direct.pids.cpu().numpy()), "live served pids"
                np.testing.assert_allclose(served.scores, direct.scores.cpu().numpy(), rtol=1e-5)
        assert srv.search(queries[0], t_cs=SERVE_T_CS[0], timeout=120).cached
        inval0 = srv.cache.stats()["invalidations"]
        emb, lens = delta[-1]
        srv.add_passages(emb, doc_lens=lens)
        assert not srv.search(queries[0], t_cs=SERVE_T_CS[0], timeout=120).cached
        assert srv.cache.stats()["invalidations"] == inval0 + 1
    finally:
        srv.shutdown()
    by_op = {op: [m["seconds"] for m in mutations if m["op"] == op]
             for op in ("add_passages", "delete_passages", "compact")}
    return dict(clients=SERVE_LIVE_CLIENTS, cycles=SERVE_LIVE_CYCLES,
                completed=st["completed"], p50_ms=st["p50_ms"], p99_ms=st["p99_ms"],
                buckets=st["buckets"], shed=st["shed"], expired=st["expired"],
                mutation_seconds=by_op, quiet_identical=True, stale_invalidated=True)


def serve_tiered(index, pool, counts) -> dict:
    """Check 6: ``plaid-tiered-cuda`` served: ``stats()["transfer"]`` equals
    the engine's ``transfer_totals`` after the requests, one transfer batch
    a dispatch, K1 twice and K2 once a dispatch, and each lane's pids equal
    a direct ``plaid-cuda`` search of its query."""
    p = retrieval.params_for_k(10)
    tr = retrieval.from_index(index, backend="plaid-cuda", params=p.replace(tiered=True))
    assert tr.backend_name == "plaid-tiered-cuda"
    r = retrieval.from_index(index, backend="plaid-cuda", params=p)
    srv = serving.BatchingServer(tr, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                 cache_size=None, tracer=Tracer(), registry=MetricsRegistry())
    try:
        futs, per = counted(counts, lambda: [f.get(timeout=120) for f in
                                             [srv.submit(pool[i]) for i in range(SERVE_TIERED)]])
        st = srv.stats()
    finally:
        srv.shutdown()
    assert_served_launches(per, st["dispatches"], "tiered")
    assert st["transfer"] == tr.transfer_totals, (st["transfer"], tr.transfer_totals)
    assert st["transfer"]["batches"] == st["dispatches"]
    want = r.search_batch(pool[:SERVE_TIERED]).pids.cpu().numpy()
    for i, res in enumerate(futs):
        assert np.array_equal(res.pids, want[i]), ("tiered served pids", i)
    return dict(requests=SERVE_TIERED, dispatches=st["dispatches"], buckets=st["buckets"],
                transfer=st["transfer"], transfer_equals_engine=True,
                pids_equal_plaid_cuda=True)


def serve_replicas(index, pool, seed) -> dict:
    """Check 7: a ``ReplicaPool`` of two ``live-cuda`` retrievers over one
    ``LiveIndex``: one ``add_passages`` bumps the generation once, and both
    replicas serve the mutated corpus (each equal to a direct search, an
    added passage found by a query made of its own tokens)."""
    live_idx = live.LiveIndex(index)
    p = retrieval.params_for_k(10)
    reps = [retrieval.from_index(live_idx, backend="live-cuda", params=p) for _ in range(2)]
    rpool = serving.ReplicaPool(reps, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                tracer=Tracer(), registry=MetricsRegistry())
    try:
        emb, lens = delta_passages(index, LIVE_DELTAS[-1], seed + 400)
        gen0 = live_idx.generation
        pids = rpool.add_passages(emb, doc_lens=lens)
        assert live_idx.generation == gen0 + 1 and pids.size == LIVE_DELTAS[-1]
        # a query of the first added passage's tokens, cycled to NQ rows
        probe = emb[np.arange(NQ) % int(lens[0])].cpu().numpy()
        for s in rpool.servers:
            for q in (pool[0], probe):
                got, want = s.search(q, timeout=120), reps[0].search(q)
                assert np.array_equal(got.pids, want.pids.cpu().numpy()), "replica pids"
        assert int(pids[0]) in s.search(probe, timeout=120).pids.tolist()
        st = rpool.stats()
    finally:
        rpool.shutdown()
    assert st["n_replicas"] == 2 and all(r["completed"] > 0 for r in st["replicas"])
    return dict(replicas=2, generation_bumps=1, served_by_each=[r["completed"] for r in st["replicas"]],
                added_found=True)


def serve_phase(index, seed, info: dict) -> dict:
    """Phase ``serve`` (see the module docstring).  Returns the kernel
    launches of the served batches, counted around the runs that have one
    dispatcher thread (the replica pool's two are not counted: the
    wrappers' counters are plain ints)."""
    pool_t, _ = synth_queries(index, SERVE_POOL, seed + 11)
    pool = pool_t.cpu().numpy()
    del pool_t
    counts: dict = {n: 0 for n in ops.launch_counts()}
    r = retrieval.from_index(index, backend="plaid-cuda", params=retrieval.params_for_k(10))
    srv = serving.BatchingServer(r, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                 cache_size=None, tracer=Tracer(), registry=MetricsRegistry())
    try:
        info["buckets"] = serve_buckets(srv, r, pool, counts)
    finally:
        srv.shutdown()
    info["load"], load_counts = serve_load(r, pool)
    for n, c in load_counts.items():
        counts[n] += c
    emit({"serve_load": info["load"]})
    info["lone"], info["cache"] = serve_lone_and_cache(r, pool)
    info["live"] = serve_live(index, pool, seed, counts)
    emit({"serve_live": info["live"]})
    info["tiered"] = serve_tiered(index, pool, counts)
    info["replicas"] = serve_replicas(index, pool, seed)
    return counts

# --------------------------------------------------------------------------
# phase serve_driver: launch.serve, the reference's serving driver
# --------------------------------------------------------------------------
def serve_driver_phase(info: dict) -> dict:
    """``launch.serve`` at its defaults with ``--compare-vanilla
    --sweep-t-cs``: ``--backend plaid``, then ``--pallas``
    (``plaid-cuda``).  Both build the same index (the build is
    deterministic), so the pids must be equal on every query.  Returns the
    kernels' launches of the two runs (K1 / K2 from plaid-cuda, K4 from
    each vanilla comparison)."""
    runs = {}
    ops.reset_launch_counts()
    for name, flags in (("plaid", ["--backend", "plaid"]), ("plaid-cuda", ["--pallas"])):
        out = serve_cli.run(serve_cli.parse_args(SERVE_DRIVER_FLAGS + flags),
                            log=lambda line: print(f"serve_driver| {line}", flush=True))
        runs[name] = out
        row = dict(backend=out["backend"], queries=len(out["pids"]), k=out["k"],
                   passages=out["num_passages"], tokens=out["num_tokens"],
                   centroids=out["num_centroids"], build_s=out["build_s"],
                   mean_ms_per_query=out["mean_ms"], p50_ms_per_query=out["p50_ms"],
                   p99_ms_per_query=out["p99_ms"], success_at_1=out["success_at_1"],
                   vanilla=dict(mean_ms_per_query=out["vanilla"]["mean_ms"],
                                success_at_1=out["vanilla"]["success_at_1"],
                                speedup=out["vanilla"]["speedup"]),
                   sweep=out["sweep"], sweep_trace_count=out["sweep_trace_count"])
        emit({"serve_driver": row, "card": info["card"]})
        info[name] = row
    counts = ops.launch_counts()
    a, b = runs["plaid"], runs["plaid-cuda"]
    diff = same_index(a["index"], b["index"])
    assert not diff, f"the two builds differ: {diff}"
    assert np.array_equal(a["pids"], b["pids"]), "plaid-cuda vs plaid pids"
    assert np.array_equal(a["vanilla"]["pids"], b["vanilla"]["pids"]), "vanilla pids"
    assert len(a["pids"]) == 256 and a["sweep_trace_count"] == 0
    info["pids_identical_queries"] = len(a["pids"])
    assert all(counts[name] > 0 for name in (*SEARCH_KERNELS[:2], "decompress_residuals")), counts
    return counts


# --------------------------------------------------------------------------
# phase train_dp: data-parallel ColBERTv2 training over gloo ranks
# --------------------------------------------------------------------------
def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_optimizer():
    return train_opt.adamw(train_opt.AdamWConfig(
        schedule=train_opt.cosine_schedule(TRAIN_LR, 2, DP_STEPS + 1)))


def dp_state_axes(cfg):
    axes = colbert.param_axes(cfg)
    return {"params": axes, "opt": train_opt.opt_state_axes(axes)}


def train_dp_rank(rank: int, tmp: str, seed: int, cfg, device: str) -> None:
    """One of GLOO_RANKS data-parallel ranks sharing ``device`` over gloo.
    From the seeded initial weights, DP_STEPS steps on the global batches
    in each of DP_CASES (the replicas compared after every step); rank 0
    judges each case's held-out loss and writes the plain case's state;
    then ``compressed_psum`` over a gradient-sized tensor.  Writes its
    record to ``{tmp}/rank{rank}.pt``."""
    mesh_mod.init_distributed(f"file://{tmp}/rendezvous", GLOO_RANKS, rank, backend="gloo")
    try:
        dev = torch.device(device)
        mesh = mesh_mod.make_production_mesh(device=device)
        assert mesh.shape == {"data": GLOO_RANKS, "model": 1} and mesh.devices == (dev,)
        reduced, plain_all_reduce = [], mesh_mod.all_reduce_sum

        def timed_all_reduce(m, t):  # every all-reduce of the steps, timed
            _sync(dev)
            t0 = time.perf_counter()
            out = plain_all_reduce(m, t)
            _sync(dev)
            reduced.append((t.numel() * t.element_size(), (time.perf_counter() - t0) * 1e3))
            return out

        mesh_mod.all_reduce_sum = timed_all_reduce
        model = colbert.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 41),
                                    device=dev)
        params0 = colbert.train_params(model)
        batches = train_batches(cfg, DP_STEPS, TRAIN_BATCH, seed + 43, dev)
        held_out = train_batches(cfg, HELD_OUT_BATCHES, TRAIN_BATCH, seed + 7, dev)
        judge = colbert.ColBERT(cfg, transformer.Transformer(cfg.backbone, dev)) if rank == 0 else None
        out = {"checksums0": train_loop.replica_checksums(params0).cpu()}
        if rank == 0:
            out["held_out_before"] = held_out_loss(judge, params0, held_out)
        for case, (n_micro, comp) in DP_CASES.items():
            opt = dp_optimizer()
            step = train_loop.make_train_step(colbert.loss_fn(model), opt, n_micro=n_micro,
                                              compression=comp, param_axes=colbert.param_axes(cfg))
            p, o = params0, train_loop.init_opt_state(opt, params0, comp)
            losses, ms, n_reduced = [], [], len(reduced)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            with sharding.use_mesh(mesh):
                train_loop.assert_replicas_agree(p, mesh)
                for b in batches:
                    _sync(dev)
                    t0 = time.perf_counter()
                    p, o, m = step(p, o, b)
                    _sync(dev)
                    ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(float(m["loss"]))
                    train_loop.assert_replicas_agree(p, mesh)  # raises if they parted
            rec = dict(losses=losses, step_ms=ms, all_reduces=reduced[n_reduced:],
                       checksums=train_loop.replica_checksums(p).cpu(), replicas_identical=True)
            if dev.type == "cuda":
                rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            if comp:
                rec["ef_max_abs"] = max(float(e.abs().max()) for e in train_tree.leaves(o["ef"]))
            if rank == 0:
                rec["held_out_after"] = held_out_loss(judge, p, held_out)
                if case == "plain":
                    t0 = time.perf_counter()
                    train_ckpt.save(f"{tmp}/world2", DP_STEPS, {"params": p, "opt": o})
                    rec["save_s"] = time.perf_counter() - t0
            out[case] = rec
            del p, o
        # compressed_psum over a gradient-sized tensor against the mean
        n = sum(x.numel() for x in train_tree.leaves(params0))
        xs = [torch.randn(n, generator=torch.Generator(device=dev).manual_seed(seed + 50 + r),
                          device=dev) for r in range(GLOO_RANKS)]
        mean = torch.stack(xs).mean(0)
        times = []
        for _ in range(2):  # the first call warms the collectives up
            _sync(dev)
            t0 = time.perf_counter()
            got = dist_comp.compressed_psum(xs[rank], mesh)
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        _sync(dev)
        t0 = time.perf_counter()
        plain_all_reduce(mesh, xs[rank])
        _sync(dev)
        scale = float(torch.stack(xs).abs().max()) / 127
        out["psum"] = dict(values=n, ms=times[-1], f32_all_reduce_ms=(time.perf_counter() - t0) * 1e3,
                           max_abs_err=float((got - mean).abs().max()), int8_step=scale,
                           wire_bytes=2 * n, f32_bytes=4 * n)
        torch.save(out, f"{tmp}/rank{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def train_dp_phase(seed, dev, info: dict, cfg=None) -> dict:
    """Data-parallel training at full width: GLOO_RANKS gloo ranks sharing
    the card, held against the single-process step on the same state and
    global batches; the state the ranks wrote restored at world 1 and
    stepped on; then those weights served through K7, K1 and K2.  Returns
    the serving's launch counts (the training steps launch no kernel of
    the port)."""
    cfg = cfg or colbert_cfg.full_config()
    model = colbert.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 41), device=dev)
    params0 = colbert.train_params(model)
    batches = train_batches(cfg, DP_STEPS, TRAIN_BATCH, seed + 43, dev)
    single = {}  # the one-process step's losses: every step of the plain case
    for case, (n_micro, comp) in DP_CASES.items():
        opt = dp_optimizer()
        step = train_loop.make_train_step(colbert.loss_fn(model), opt, n_micro=n_micro,
                                          compression=comp)
        p, o = params0, train_loop.init_opt_state(opt, params0, comp)
        single[case] = []
        for b in batches if case == "plain" else batches[:1]:
            p, o, m = step(p, o, b)
            single[case].append(float(m["loss"]))
        del p, o
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn_gloo_ranks(tmp, train_dp_rank, seed, cfg, str(dev))
        gloo_s = time.perf_counter() - t0
        want0 = train_loop.replica_checksums(params0).cpu()
        assert all(torch.equal(r["checksums0"], want0) for r in ranks), "initial replicas"
        lead = ranks[0]
        rows = {}
        for case in DP_CASES:
            recs = [r[case] for r in ranks]
            assert all(torch.equal(r["checksums"], recs[0]["checksums"]) for r in recs)
            assert all(r["losses"] == recs[0]["losses"] for r in recs)
            rels = [abs(a / b - 1) for a, b in zip(recs[0]["losses"], single[case])]
            # the step's one gradient all-reduce is the largest; the others
            # are the passage gather's backward, one a microbatch
            reduces = [x for r in recs for x in r["all_reduces"]]
            grad_bytes = max(b for b, _ in reduces)
            rows[case] = dict(
                n_micro=DP_CASES[case][0], compression=DP_CASES[case][1],
                losses=recs[0]["losses"], single_process_losses=single[case],
                first_loss_rel=rels[0], max_loss_rel=max(rels), replicas_identical_every_step=True,
                held_out_before=lead["held_out_before"], held_out_after=recs[0]["held_out_after"],
                step_ms=[r["step_ms"] for r in recs],
                step_p50_ms=statistics.median(x for r in recs for x in r["step_ms"]),
                grad_all_reduce_ms=statistics.median(ms for b, ms in reduces if b == grad_bytes),
                grad_all_reduce_bytes=grad_bytes,
                gather_all_reduce_ms=statistics.median(ms for b, ms in reduces if b < grad_bytes),
                gather_all_reduce_bytes=max(b for b, _ in reduces if b < grad_bytes),
                all_reduces_a_step=len(recs[0]["all_reduces"]) / DP_STEPS,
                peak_bytes=[r.get("peak_bytes") for r in recs])
            if "ef_max_abs" in recs[0]:
                rows[case]["ef_max_abs"] = recs[0]["ef_max_abs"]
            emit({"train_dp": dict(case=case, **rows[case]), "card": info["card"]})
            assert rels[0] <= DP_LOSS_RTOL, rows[case]
            assert rows[case]["held_out_after"] < rows[case]["held_out_before"], rows[case]
        info["cases"] = rows
        info["psum"] = [r["psum"] for r in ranks]
        for ps in info["psum"]:
            assert ps["max_abs_err"] <= 2.5 * ps["int8_step"] + 1e-6, ps
        # the state written at world 2, restored at world 1 (a re-mesh)
        opt = dp_optimizer()
        template = {"params": params0, "opt": train_loop.init_opt_state(opt, params0)}
        t0 = time.perf_counter()
        with sharding.use_mesh(mesh_mod.make_local_mesh(dev)):
            state, at = train_ckpt.restore(f"{tmp}/world2", template, shardings=sharding.tree_shardings(
                dp_state_axes(cfg)))
        _sync(dev)
        restore_s = time.perf_counter() - t0
    assert at == DP_STEPS and torch.equal(train_loop.replica_checksums(state["params"]).cpu(),
                                          lead["plain"]["checksums"]), "restored at world 1"
    step = train_loop.make_train_step(colbert.loss_fn(model), opt)
    p, o, m = step(state["params"], state["opt"], train_batches(cfg, 1, TRAIN_BATCH, seed + 44, dev)[0])
    info["restart_world_1"] = dict(step=at, bit_identical=True, save_s=lead["plain"]["save_s"],
                                   restore_s=restore_s, next_loss=float(m["loss"]),
                                   next_step=int(o["step"]))
    assert math.isfinite(info["restart_world_1"]["next_loss"]) and int(o["step"]) == DP_STEPS + 1
    info["gloo"] = dict(ranks=GLOO_RANKS, seconds=gloo_s, backend="gloo", device=str(dev),
                        note="two ranks sharing one card over gloo measure correctness and "
                             "host traffic, not a speed-up; NCCL and several cards not reached")
    emit({"train_dp_restart": info["restart_world_1"], "psum": info["psum"], "card": info["card"]})
    del state, o, template
    counts, info["serve"] = serve_trained(cfg, model, p, seed, dev)
    return counts


# --------------------------------------------------------------------------
# phase sharded: document shards sharing the card, and gloo ranks
# --------------------------------------------------------------------------
def card_mesh(n: int):
    """``n`` shards sharing ``cuda:0``: an explicit Mesh may repeat a device."""
    return mesh_mod.Mesh(("cuda:0",) * n)


def sharded_retriever(shards, params, mesh, impl="cuda"):
    """``plaid-sharded`` over a ``shard_index`` output ``(dict, meta, per)``."""
    d, meta, per = shards
    return retrieval.get_backend("plaid-sharded")(
        d, meta, docs_per_shard=per, n_shards=mesh.n_shards, params=params, mesh=mesh,
        impl=impl)


def assert_sharded_launches(per: dict, n_shards: int, fused: bool, where) -> None:
    """A sharded batch's launches: K1 twice a shard (stages 2 and 3), K2 once
    a shard, or K3 once a shard fused, and no other kernel of the port."""
    want = dict(centroid_interaction_batched=2 * n_shards,
                decompress_and_score_batched=0 if fused else n_shards,
                gather_decompress_maxsim=n_shards if fused else 0)
    got = {n: c for n, c in per.items() if c}
    assert got == {n: c for n, c in want.items() if c}, (where, per)


def composed(shards, qb, p, k):
    """The oracle of a sharded batch: every shard searched alone through
    ``plaid-cuda`` at the per-shard cap, its pids offset, one local merge."""
    d, meta, per = shards
    pc = clamp_to_shard(p, per)
    parts = [retrieval.from_index(s, backend="plaid-cuda", params=pc).search_batch(qb)
             for s in place_shards(card_mesh(2), d, meta)]
    return merge_topk(torch.cat([o.scores for o in parts], 1),
                      torch.cat([local_to_global_pids(o.pids, s, per)
                                 for s, o in enumerate(parts)], 1), k)


def timed_shard_index(index, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine_sharded.shard_index(index, n)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sharded_live_composition(live_idx, shards, qb, p):
    """``live-sharded-cuda``'s oracle: each base shard through the pipeline
    (K1-K3) with its slice of the padded tombstones, the deltas through
    the stacked group, one local merge of every tuple."""
    d, meta, per = shards
    snap = live_idx.snapshot()
    ep = clamp_to_shard(retrieval.backends.to_engine_params(p, "cuda"), per)
    qm = torch.ones(qb.shape[:2], device=qb.device)
    alive = torch.zeros(2 * per, dtype=torch.bool, device=qb.device)
    alive[: snap.alive[0].shape[0]] = snap.alive[0]
    scores, pids = [], []
    for s, shard in enumerate(place_shards(card_mesh(2), d, meta)):
        sc, pid = pipeline.run_pipeline(shard, qb, qm, p.t_cs, ep,
                                        alive=alive[s * per : (s + 1) * per])
        scores.append(sc)
        pids.append(local_to_global_pids(pid, s, per))
    deltas = list(snap.segments[1:])
    bucket = seg_exec.bucket_for(deltas)
    dp = retrieval.backends.to_engine_params(p, "cuda")
    ds, dpid = seg_exec.make_stacked_search(dp, bucket)(
        deltas, qb, qm, p.t_cs, seg_exec.pack_offsets(snap.offsets[1:], bucket, qb.device),
        snap.alive[1:])
    return merge_topk(torch.cat([*scores, ds], 1), torch.cat([*pids, dpid], 1), p.k)


def gloo_rank(rank: int, tmp: str) -> None:
    """One of GLOO_RANKS processes sharing ``cuda:0`` over gloo: loads its
    own shard of the saved index and searches the saved batch."""
    mesh_mod.init_distributed(f"file://{tmp}/rendezvous", GLOO_RANKS, rank, backend="gloo")
    try:
        qb = torch.load(f"{tmp}/queries.pt").cuda()
        r = retrieval.load(f"{tmp}/index", params=retrieval.params_for_k(10), device="cuda")
        assert r.impl == "cuda", r.impl  # the kernels by default on the card
        assert list(r.mesh.shard_ids()) == [rank], r.mesh
        res = r.search_batch(qb)
        torch.save(dict(scores=res.scores.cpu(), pids=res.pids.cpu()), f"{tmp}/rank{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def spawn_gloo_ranks(tmp: str, target=gloo_rank, *args, n: int = GLOO_RANKS) -> list:
    """``n`` spawned ranks running ``target(rank, tmp, *args)``, joined
    within GLOO_JOIN_S; none outlives the call.  Returns each rank's result
    (``{tmp}/rank{r}.pt``)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, tmp, *args)) for r in range(n)]
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(GLOO_JOIN_S)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.terminate()
                pr.join(10)
    codes = [pr.exitcode for pr in procs]
    assert codes == [0] * n, f"gloo ranks exited {codes}"
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(n)]


def sharded_phase(index, batches, seed, info: dict) -> dict:
    """Phase ``sharded`` (see the module docstring, 8d).  Returns the port's
    kernel launches of the sharded calls."""
    counts = {}
    qb = batches[1][0]
    # ---- (1) one shard: plaid-cuda's results
    one, info["shard_index_1_s"] = timed_shard_index(index, 1)
    rows = []
    for k in (10, 100, 1000):
        for fused in (False, True):
            p = retrieval.params_for_k(k).replace(fused=fused)
            got, per = counted(counts, sharded_retriever(one, p, card_mesh(1)).search_batch, qb)
            want = retrieval.from_index(index, backend="plaid-cuda", params=p).search_batch(qb)
            check_result(got, k)
            # the shard merge orders equal scores by pid (the reference's
            # jax.lax.sort does too); plaid-cuda's top-k keeps them in
            # finalist order: its pids are compared in the merge's order
            merged_s, merged_p = merge_topk(want.scores, want.pids, k)
            assert torch.equal(got.scores, want.scores), f"one shard vs plaid-cuda k={k}"
            assert torch.equal(merged_s, want.scores)
            assert torch.equal(got.pids, merged_p), f"one shard vs plaid-cuda pids k={k}"
            assert_sharded_launches(per, 1, fused, ("one shard", k))
            rows.append(dict(k=k, fused=fused, identical=True,
                             tie_slots_reordered=int((merged_p != want.pids).sum())))
    info["one_shard_equals_plaid_cuda"] = rows
    del one

    # ---- (2) two shards of 1M passages sharing the card
    two, info["shard_index_2_s"] = timed_shard_index(index, 2)
    info["docs_per_shard"] = two[2]
    rows = []
    for k, fused in ((10, False), (1000, False), (1000, True)):
        p = retrieval.params_for_k(k).replace(fused=fused)
        r2 = sharded_retriever(two, p, card_mesh(2))
        got, per = counted(counts, r2.search_batch, qb)
        check_result(got, k)
        ws, wp = composed(two, qb, p, k)
        assert torch.equal(got.pids, wp) and torch.equal(got.scores, ws), f"2 shards k={k}"
        assert_sharded_launches(per, 2, fused, ("two shards", k))
        ref_res = sharded_retriever(two, p, card_mesh(2), impl="ref").search_batch(qb)
        assert torch.equal(got.pids, ref_res.pids), f"2 shards vs impl=ref k={k}"
        assert torch.allclose(got.scores, ref_res.scores, rtol=1e-5, atol=1e-5)
        row = dict(k=k, fused=fused, composition_identical=True, ref_pids_identical=True,
                   launches_a_batch={n: c for n, c in per.items() if c})
        if not fused:
            bare = retrieval.from_index(index, backend="plaid-cuda", params=p)
            times = {"plaid-sharded": [], "plaid-cuda": []}
            for i in range(SHARD_PAIRS):
                for r in ((r2, bare) if i % 2 == 0 else (bare, r2)):
                    if r is r2:
                        res, _ = counted(counts, r.search_batch, qb)
                    else:
                        res = r.search_batch(qb)
                    times[r.backend_name].append(res.latency_ms)
            prof_s, _ = counted(counts, profile_batch, r2, qb)
            prof_b = profile_batch(bare, qb)
            p50 = {n: statistics.median(xs) for n, xs in times.items()}
            row.update(pairs=SHARD_PAIRS, sharded_p50_ms=p50["plaid-sharded"],
                       plaid_cuda_p50_ms=p50["plaid-cuda"],
                       p50_ratio=p50["plaid-sharded"] / p50["plaid-cuda"], ms=times,
                       device_ms=dict(sharded=prof_s["device_ms"], plaid_cuda=prof_b["device_ms"]),
                       launches_profiled=dict(sharded=prof_s["launches"],
                                              plaid_cuda=prof_b["launches"]),
                       launches_whole=prof_s["launches_whole"] and prof_b["launches_whole"],
                       busy_share=dict(sharded=prof_s["busy_share"],
                                       plaid_cuda=prof_b["busy_share"]))
        emit({"sharded": row, "card": info["card"]})
        rows.append(row)
    info["two_shards"] = rows

    # ---- (3) live-sharded-cuda over the live phase's base, deltas, tombstones
    live_idx = live.LiveIndex(index)
    for i, n in enumerate(LIVE_DELTAS):
        emb, lens = delta_passages(index, n, seed + 100 + i)
        live_idx.add_passages(emb, doc_lens=lens)
        del emb
    g = np.random.default_rng(seed + 5)
    dead = np.concatenate([
        g.choice(index.num_passages, LIVE_BASE_DELETES, replace=False),
        index.num_passages + g.choice(LIVE_DELTAS[0], LIVE_DELTA_DELETES, replace=False)])
    assert live_idx.delete(dead) == dead.size
    dead_t = torch.zeros(live_idx.num_passages, dtype=torch.bool, device=index.device)
    dead_t[torch.from_numpy(dead).to(index.device)] = True
    LiveSharded = retrieval.get_backend("live-sharded")
    LiveShardedCuda = retrieval.get_backend("live-sharded-cuda")
    rows = []
    for k, fused in ((10, False), (1000, True)):
        p = retrieval.params_for_k(k).replace(fused=fused)
        lc = LiveShardedCuda(live_idx, p, mesh=card_mesh(2))
        got, per = counted(counts, lc.search_batch, qb)
        want = LiveSharded(live_idx, p, mesh=card_mesh(2)).search_batch(qb)
        check_result(got, k)
        assert torch.equal(got.pids, want.pids), f"live-sharded-cuda vs live-sharded k={k}"
        assert torch.equal(got.scores, want.scores), f"live-sharded-cuda vs live-sharded k={k}"
        assert not bool(dead_t[got.pids.long()].any()), "a tombstoned pid came back"
        ws, wp = sharded_live_composition(live_idx, two, qb, p)
        assert torch.equal(got.pids, wp) and torch.equal(got.scores, ws), f"live composition k={k}"
        rows.append(dict(k=k, fused=fused, identical=True, composition_identical=True,
                         launches_a_batch={n: c for n, c in per.items() if c},
                         pids_from_deltas=int((got.pids >= index.num_passages).sum())))
        emit({"sharded_live": rows[-1], "card": info["card"]})
    del two
    p = retrieval.params_for_k(10)
    lc = LiveShardedCuda(live_idx, p, mesh=card_mesh(2))
    counted(counts, lc.search_batch, qb)
    sid = lc._engine._base_shards["sid"]
    live_idx.compact()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = counted(counts, lc.search_batch, qb)  # re-shards the compacted base
    reshard_batch_s = time.perf_counter() - t0
    assert lc._engine._base_shards["sid"] != sid, "no re-shard after compact()"
    new_two, _ = timed_shard_index(live_idx.base, 2)
    want, _ = counted(counts, sharded_retriever(new_two, p, card_mesh(2)).search_batch, qb)
    assert torch.equal(got.pids, want.pids) and torch.equal(got.scores, want.scores)
    info.update(live=rows, live_tombstones=int(dead.size),
                compacted_resharded=True, reshard_first_batch_s=reshard_batch_s)
    del lc, live_idx, new_two

    # ---- (4) the build on a 2-device mesh at reduced depth
    factory, n_tok = stream_corpus(SHARD_BUILD_PASSAGES, seed + 40, SHARD_BUILD_CHUNK)
    builds, stats = [], []
    for mesh in (card_mesh(1), card_mesh(2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b, st = build.build_index_streaming(
            factory, num_centroids=SHARD_BUILD_K, chunk_docs=SHARD_BUILD_CHUNK, mesh=mesh,
            return_stats=True, device="cuda")
        torch.cuda.synchronize()
        builds.append(b)
        stats.append(dict(n_devices=st.n_devices, seconds=time.perf_counter() - t0,
                          pass1_s=st.pass1_s, pass2_s=st.pass2_s, kmeans_s=st.kmeans_s))
    diff = same_index(*builds)
    assert not diff, f"2-device build differs from the 1-device build: {diff}"
    info["build"] = dict(passages=SHARD_BUILD_PASSAGES, tokens=n_tok, centroids=SHARD_BUILD_K,
                         identical=True, runs=stats)

    # ---- (5) two gloo ranks on the card against the in-process 2 shards
    small = builds[0]
    del builds
    qs_small, _ = synth_queries(small, BATCH, seed + 41)
    p = retrieval.params_for_k(10)
    with tempfile.TemporaryDirectory() as tmp:
        r2 = retrieval.get_backend("plaid-sharded").from_index(
            small, retrieval.RetrieverConfig(params=p, n_shards=2), mesh=card_mesh(2), impl="cuda")
        want, _ = counted(counts, r2.search_batch, qs_small)
        r2.save(f"{tmp}/index")
        torch.save(qs_small.cpu(), f"{tmp}/queries.pt")
        _build.build_all()  # built already: the ranks only load the libraries
        t0 = time.perf_counter()
        ranks = spawn_gloo_ranks(tmp)
        gloo_s = time.perf_counter() - t0
    for got in ranks:
        assert torch.equal(got["pids"], want.pids.cpu()), "gloo rank pids"
        assert torch.equal(got["scores"], want.scores.cpu()), "gloo rank scores"
    info["gloo"] = dict(ranks=GLOO_RANKS, identical=True, seconds=gloo_s,
                        backend="gloo", device="cuda:0")
    return {name: counts.get(name, 0) for name in ops.launch_counts()}


def quality_phase(seed, dev, info: dict) -> None:
    """The quality harness (``repro_torch.eval``) on the card.

    (i) An index of QUALITY_PASSAGES passages of 8..180 tokens from
    ``data.synthetic.embedding_corpus`` (d=128, nbits 2, K by ColBERTv2's
    rule) built on the card, QUALITY_QUERIES seeded queries of NQ tokens:
    ``sweep_quality`` over ``default_grid`` (48 points) and the
    CAP_GRID points with ``impl="cuda"``, then with ``impl="ref"`` on the
    same card; every point's pids, funnel, work and metrics identical, and
    the ndocs mask cuts real candidates at every CAP_GRID point.  (ii)
    ``certify_backends`` at lossless caps on a CERT_PASSAGES-passage index
    of the same widths, CERT_QUERIES queries: every variant's recall@10
    within 1e-6 of the exact f32 ``plaid`` baseline; the PLAID variants'
    pids identical to the baseline's and ``vanilla``'s to its plain
    version's on the same batches, scores within CERT_SCORE_ATOL.  At nprobe = K the IVF
    walk holds B x nq x K x ivf_list_cap pids, so certification searches
    a few queries at a time (``eval.sweep.lossless_query_batch``)."""
    # ---- (i) the sweep
    t0 = time.perf_counter()
    docs, topics = synthetic.embedding_corpus(
        QUALITY_PASSAGES, dim=DIM, min_len=8, max_len=DOC_MAXLEN, seed=seed,
        n_topics=QUALITY_PASSAGES // PASSAGES_PER_TOPIC, n_concepts=QUALITY_PASSAGES)
    qset = eval_qrels.synthetic_query_set(docs, topics, QUALITY_QUERIES, q_len=NQ,
                                          seed=seed + 1)
    corpus_s = time.perf_counter() - t0
    n_tok = sum(len(d) for d in docs)
    t0 = time.perf_counter()
    index = build.build_index_streaming(
        docs, num_centroids=kmeans.num_centroids_for(n_tok), nbits=NBITS, seed=seed,
        chunk_docs=STREAM_CHUNK_DOCS, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del docs
    grid = eval_sweep.default_grid(index)
    assert len(grid) == 48
    grid += [eval_sweep.GridPoint(eval_sweep.T_CS_OFF, p, d)
             for p in CAP_GRID_NPROBES for d in CAP_GRID_NDOCS]
    t0 = time.perf_counter()
    rec_c, eng = eval_sweep.sweep_quality(index, qset, grid=grid, impl="cuda")
    cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec_r, _ = eval_sweep.sweep_quality(index, qset, grid=grid, impl="ref",
                                        measure_latency=False)
    ref_s = time.perf_counter() - t0
    assert len(rec_c) == len(rec_r) == len(grid)
    for c, r in zip(rec_c, rec_r):
        assert np.array_equal(c.pids, r.pids), f"sweep pids, cuda vs ref, at {c.case}"
        for f, v in r.funnel.items():
            assert np.array_equal(c.funnel[f], v), f"sweep funnel {f}, cuda vs ref, at {c.case}"
        assert c.work == r.work and c.metrics == r.metrics, c.case
        assert math.isfinite(c.work) and 0.0 <= c.metrics["recall@10"] <= 1.0, c.case
    # a cap's mask binds where it sits below its bucket and cut a real
    # candidate (ndocs_t at stage 2, n3_t at stage 3) in some query
    def cut(r, kept, had):
        return bool((r.funnel[kept] < r.funnel[had]).any())

    ndocs_binds = [r.case for r in rec_c if r.ndocs < r.bucket_ndocs
                   and cut(r, "stage2_survivors", "stage1_candidates")]
    n3_binds = [r.case for r in rec_c if r.ndocs < r.bucket_ndocs
                and cut(r, "stage3_survivors", "stage2_survivors")]
    nprobe_masked = [r.case for r in rec_c if r.nprobe < r.bucket_nprobe]
    cap_cases = {r.case for r in rec_c[48:]}
    assert cap_cases <= set(ndocs_binds), f"ndocs mask cut nothing at {cap_cases - set(ndocs_binds)}"
    frontier = eval_sweep.pareto_frontier(rec_c)
    emit({"sweep": [
        dict(case=r.case, bucket=[r.bucket_nprobe, r.bucket_ndocs], work=r.work,
             recall_at_10=r.metrics["recall@10"], mrr_at_10=r.metrics["mrr@10"],
             latency_ms_per_query=r.latency_ms, on_frontier=r.on_frontier,
             stage1_candidates_mean=float(r.funnel["stage1_candidates"].mean()),
             stage2_survivors_mean=float(r.funnel["stage2_survivors"].mean()),
             stage3_survivors_mean=float(r.funnel["stage3_survivors"].mean()))
        for r in rec_c]})
    recalls = [r.metrics["recall@10"] for r in rec_c]
    info["sweep"] = dict(
        passages=index.num_passages, tokens=index.num_tokens, centroids=index.num_centroids,
        ivf_list_cap=index.ivf_list_cap, queries=QUALITY_QUERIES, points=len(rec_c),
        default_grid_points=48, cap_grid_points=len(rec_c) - 48,
        identical_cuda_vs_ref=True, ndocs_mask_binds=len(ndocs_binds),
        n3_mask_binds=len(n3_binds), nprobe_mask_points=len(nprobe_masked),
        ndocs_mask_binds_in_default_grid=len(set(ndocs_binds) - cap_cases),
        frontier=len(frontier),
        frontier_cases=[r.case for r in frontier], n_programs=eng.n_programs,
        recall_at_10_min=min(recalls), recall_at_10_max=max(recalls),
        latency_ms_per_query_p50=statistics.median(r.latency_ms for r in rec_c),
        corpus_s=corpus_s, build_s=build_s, cuda_sweep_s=cuda_s, ref_sweep_s=ref_s)
    # phase tiered's save / load round trip, on this index
    info["tiered_roundtrip"] = tiered_roundtrip(index, synth_queries(index, BATCH, seed)[0])
    del index, rec_c, rec_r

    # ---- (ii) lossless-caps certification
    t0 = time.perf_counter()
    docs_c, topics_c = synthetic.embedding_corpus(
        CERT_PASSAGES, dim=DIM, min_len=8, max_len=DOC_MAXLEN, seed=seed + 2,
        n_topics=CERT_PASSAGES // PASSAGES_PER_TOPIC, n_concepts=CERT_PASSAGES)
    qset_c = eval_qrels.synthetic_query_set(docs_c, topics_c, CERT_QUERIES, q_len=NQ,
                                            seed=seed + 3)
    idx_c = build.build_index_streaming(docs_c, nbits=NBITS, seed=seed, device=dev)
    n, K, L = idx_c.num_passages, idx_c.num_centroids, idx_c.doc_maxlen
    walk_slots = NQ * K * idx_c.ivf_list_cap  # one query's IVF walk at nprobe = K
    qbatch = eval_sweep.lossless_query_batch(idx_c, NQ, CERT_QUERIES)
    n3 = max(n // 4, 10)
    sizes = dict(
        passages=n, tokens=idx_c.num_tokens, centroids=K, ivf_list_cap=idx_c.ivf_list_cap,
        queries=CERT_QUERIES, query_batch=qbatch,
        walk_pids_bytes_all_queries=CERT_QUERIES * walk_slots * 4,
        walk_pids_bytes_a_batch=qbatch * walk_slots * 4,
        stage2_blocks_bytes_a_batch=qbatch * n * L * 5,  # codes i32 + valid
        stage4_blocks_bytes_a_batch=qbatch * n3 * L * (idx_c.residuals.shape[1] + 5))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    records, failures = eval_sweep.certify_backends(idx_c, qset_c, docs=docs_c)
    torch.cuda.synchronize()
    sizes["peak_device_bytes_above_resident"] = torch.cuda.max_memory_allocated() - base
    emit({"certify": [dict(variant=r["variant"], backend=r["backend"],
                           recall_at_10=r["metrics"]["recall@10"], delta=r["delta"],
                           passed=r["passed"]) for r in records]})
    assert not failures, failures
    variants = {r["variant"] for r in records}
    ranked_as_baseline = ("plaid-cuda", "plaid-fused", "plaid-stage1-bf16",
                          "plaid-stage1-int8", "live", "live-cuda", "live-delta")
    want = {"baseline-exact-f32", "vanilla", *ranked_as_baseline}
    assert want <= variants, variants
    assert all(abs(r["delta"]) <= eval_sweep.CERT_TOLERANCE for r in records), records
    # recall@10 alone would pass a kernel that reorders the top 10 or gets a
    # score wrong: at lossless caps every PLAID variant ranks as the exact
    # baseline does, and vanilla as its plain version on the same batches
    by = {r["variant"]: r for r in records}
    base, score_err = by["baseline-exact-f32"], {}
    # the live variants merge their partitions by (-score, pid): the
    # baseline's pids in that order (equal scores ordered by pid)
    merged = merge_topk(torch.from_numpy(base["scores"]), torch.from_numpy(base["pids"]), 10)
    base_merged = merged[1].numpy()
    for v in ranked_as_baseline:
        want_p = base_merged if v.startswith("live") else base["pids"]
        assert np.array_equal(by[v]["pids"], want_p), f"certify: {v} pids differ from the baseline's"
        score_err[v] = float(np.abs(by[v]["scores"] - base["scores"]).max())
    lossless = eval_sweep.lossless_params(idx_c)
    plain = vanilla.VanillaEngine(idx_c, vanilla.VanillaParams(
        k=lossless.k, nprobe=lossless.nprobe, ncandidates=idx_c.num_tokens,
        ndocs_cap=lossless.ndocs, impl="ref"))
    qs_c = np.asarray(qset_c.queries, np.float32)
    want = [plain.search_batch(qs_c[i:i + qbatch]) for i in range(0, CERT_QUERIES, qbatch)]
    want_p = np.concatenate([p.cpu().numpy() for _, p in want])
    want_s = np.concatenate([s.cpu().numpy() for s, _ in want])
    assert np.array_equal(by["vanilla"]["pids"], want_p), "certify: vanilla pids differ from impl='ref'"
    score_err["vanilla_vs_ref"] = float(np.abs(by["vanilla"]["scores"] - want_s).max())
    assert all(e <= CERT_SCORE_ATOL for e in score_err.values()), score_err
    info["certify"] = dict(sizes, variants=len(records), passed=True,
                           pids_identical=True, max_abs_score_err=score_err,
                           seconds=time.perf_counter() - t0)

    # ---- (iii) a live directory with deltas and tombstones, saved and loaded
    t0 = time.perf_counter()
    half, three_q = len(docs_c) // 2, 3 * len(docs_c) // 4
    live_base = index_mod.build_index(docs_c[:half], centroids=idx_c.centroids,
                                      codec=idx_c.codec, device=dev)
    lr = retrieval.from_index(live_base, backend="live-cuda", params=retrieval.params_for_k(10))
    lr.add_passages(docs_c[half:three_q])
    lr.add_passages(docs_c[three_q:])
    lr.delete_passages(np.arange(0, len(docs_c), 7))
    del docs_c
    before = lr.search_batch(qs_c[:BATCH])
    with tempfile.TemporaryDirectory() as tmp:
        lr.save(tmp)
        back = retrieval.load(tmp, device=dev)
        after = back.search_batch(qs_c[:BATCH])
    assert back.backend_name == "live-cuda" and back.index.num_segments == 3
    assert np.array_equal(back.index.tombstones(), lr.index.tombstones())
    assert torch.equal(before.pids, after.pids) and torch.equal(before.scores, after.scores)
    info["live_roundtrip"] = dict(segments=back.index.num_segments,
                                  tombstones=back.index.num_deleted, identical=True,
                                  seconds=time.perf_counter() - t0)


def extra_kernel_cases(dev) -> list:
    """Small random cases off the main path's shapes: nbits 1/2/4, ragged
    nd, nq not a multiple of 32 (20) and above it (40), scattered -1 pads,
    pruned centroids, scattered invalid tokens and pid == -1 lanes."""
    g = torch.Generator(device="cuda").manual_seed(123)
    out = []
    for nbits, nq, d in ((1, 20, 128), (2, 40, 64), (4, 32, 128)):
        B, nd, L, K, nt_docs = 3, 37, 45, 512, 300
        pd = d * nbits // 8
        s_cq = torch.randn(B, K, nq, generator=g, device=dev)
        codes = torch.randint(-1, K, (B, nd, L), generator=g, device=dev, dtype=torch.int32)
        keep = torch.rand(B, K, generator=g, device=dev) > 0.3
        qm = (torch.rand(B, nq, generator=g, device=dev) > 0.1).float()
        q = torch.randn(B, nq, d, generator=g, device=dev)
        packed = torch.randint(0, 256, (B, nd, L, pd), generator=g, device=dev, dtype=torch.uint8)
        valid = torch.rand(B, nd, L, generator=g, device=dev) > 0.4
        cents = torch.randn(K, d, generator=g, device=dev)
        w = torch.sort(torch.randn(2**nbits, generator=g, device=dev)).values
        lens = torch.randint(1, L + 1, (nt_docs,), generator=g, device=dev, dtype=torch.int32)
        offs = torch.zeros(nt_docs + 1, dtype=torch.int32, device=dev)
        offs[1:] = torch.cumsum(lens, 0)
        nt = int(offs[-1])
        codes_tok = torch.randint(0, K, (nt,), generator=g, device=dev, dtype=torch.int32)
        res_tok = torch.randint(0, 256, (nt, pd), generator=g, device=dev, dtype=torch.uint8)
        pids = torch.randint(-1, nt_docs, (B, nd), generator=g, device=dev, dtype=torch.int32)
        pairs = [
            (ops.centroid_interaction_batched(s_cq, codes, qm, keep),
             ref.centroid_interaction_batched_ref(s_cq, codes, keep, qm)),
            (ops.decompress_and_score_batched(q, qm, codes, packed, valid, cents, w, nbits=nbits),
             ref.decompress_and_score_batched_ref(q, qm, codes, packed, valid, cents, w, nbits=nbits)),
            (ops.gather_decompress_maxsim(q, qm, pids, codes_tok, res_tok, offs, lens, cents, w,
                                          nbits=nbits, doc_maxlen=L),
             ref.gather_decompress_maxsim_ref(q, qm, pids, codes_tok, res_tok, offs, lens, cents, w,
                                              nbits=nbits, doc_maxlen=L)),
        ]
        errs = [float((a - b).abs().max()) for a, b in pairs]
        out.append(dict(nbits=nbits, nq=nq, d=d, nd=nd, max_abs_err=errs))
        for (a, b), name in zip(pairs, ("K1", "K2", "K3")):  # the shared-order contract
            assert torch.equal(a, b), (name, nbits, nq)
    return out


# --------------------------------------------------------------------------
# phase lm: serving the LM family (prefill through K7, KV-cache decode)
# --------------------------------------------------------------------------
def lm_logits_agree(got, want, vocab: int, cos_min=LM_COS_MIN, err_share=LM_ERR_SHARE) -> dict:
    """Two logit rows per batch row against each other over the real vocab
    (cosine, largest |diff| over the row's largest |logit|), and whether
    their argmaxes agree."""
    g, w = got[:, :vocab].float(), want[:, :vocab].float()
    diff = (g - w).abs().amax(dim=-1)
    row = dict(min_cos=float(F.cosine_similarity(g, w, dim=-1).min()),
               max_abs_err=float(diff.max()),
               max_err_share=float((diff / w.abs().amax(dim=-1)).max()),
               argmax_equal=bool(torch.equal(g.argmax(-1), w.argmax(-1))))
    row["ok"] = row["min_cos"] >= cos_min and row["max_err_share"] <= err_share
    return row


def lm_exact_agree(got, want, vocab: int) -> dict:
    return lm_logits_agree(got, want, vocab, LM_F32_COS_MIN, LM_F32_ERR_SHARE)


def lm_twin(model, dtype=None, **changes):
    """A model whose config is ``model``'s with ``changes``, holding
    ``model``'s parameter tensors, or with ``dtype`` one copy of them cast
    to it (its compute dtype then): a check's variant of the served model,
    which stays as it is."""
    if dtype is not None:
        changes["dtype"] = dtype
    cfg = dataclasses.replace(model.cfg, **changes)
    twin = transformer.Transformer(cfg, "meta", head=model.head,
                                   param_dtype=dtype or model.embed.dtype)
    state = model.state_dict(keep_vars=True)
    if dtype is not None:
        state = {n: t.to(dtype) for n, t in state.items()}
    twin.load_state_dict(state, assign=True)
    return twin


def lm_config(arch: str, layers, reduced: bool = False):
    """The arch's full config (``reduced``: its reduced one, for a CPU
    rehearsal) cut to ``layers``, with K7 as its prefill attention."""
    mod = configs.get(arch)
    cfg = mod.reduced_config() if reduced else mod.full_config()
    if layers and not reduced:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, attn_impl="flash")


def lm_k7_layer0(model, toks) -> dict:
    """K7 against its plain version on layer 0's q, k, v of the prefill
    input, within FLASH_TOL[bf16]; the launch is not the main path's."""
    lay = model.layers[0]
    w = {n: getattr(lay, n) for n in lay.names}
    pos = torch.arange(toks.shape[1], device=toks.device, dtype=torch.int32)[None, :]
    x = lm_layers.rmsnorm(w["ln1_g"], model.embed[toks.long()])
    with torch.no_grad():
        q, k, v = lay.project_qkv(x, pos, model.cast, w)
        got = fa.flash_attention(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, causal=True)
    tol = FLASH_TOL[q.dtype]
    row = dict(shape=dict(B=q.shape[0], S=q.shape[1], H=q.shape[2], Hkv=k.shape[2], dh=q.shape[3]),
               dtype=str(q.dtype), tol=tol,
               max_abs_err=float((got.float() - want.float()).abs().max()),
               ok=torch.allclose(got.float(), want.float(), **tol))
    assert row["ok"], row
    return row


class MoeStats:
    """Records each ``moe_route`` call (expert ids, keep masks) while
    active: the port's router, wrapped here to read what it keeps
    internal.  ``replay`` (the ``calls`` of an earlier run of the same
    model and input) makes this run take those choices, with its own
    probabilities as their gates, and counts the tokens whose own choices
    differ (``flipped``)."""

    def __init__(self, replay=None):
        self.calls, self.replay, self.flipped = [], replay, 0

    def __enter__(self):
        self.orig = transformer.moe_route

        def spy(router, xg, cfg, cap):
            out = self.orig(router, xg, cfg, cap)
            if self.replay is not None:
                probs, ids = out[0], self.replay[len(self.calls)][0]
                self.flipped += int((ids != out[2]).any(-1).sum())
                gates = probs.gather(-1, ids)
                gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
                slots = transformer.moe_slots(ids, cfg.n_experts)
                out = (probs, gates, ids, slots, slots < cap)
            self.calls.append((out[2], out[4], cfg.n_experts))
            return out

        transformer.moe_route = spy
        return self

    def __exit__(self, *exc):
        transformer.moe_route = self.orig
        return False

    def summary(self) -> dict:
        loads = [torch.bincount(ids[keep], minlength=E) for ids, keep, E in self.calls]
        dropped = [1.0 - float(keep.float().mean()) for _, keep, _ in self.calls]
        return dict(layers=len(self.calls), dropped_share=dropped,
                    load_min_max=[[int(x.min()), int(x.max())] for x in loads],
                    first_layer_loads=loads[0].tolist() if loads else [])


def lm_ring_check(model, cfg, dev, g, cache_len: int) -> dict:
    """A sliding-window decode at ``cache_len`` on a random ring cache
    against the full-attention decode over the same entries rotated into
    slots 0..Sc-1 by position (the newest last), both in f32 (one f32 copy
    of the weights, shared by the two): the logits agree (LM_F32_*;
    identical where the rotation is none), and the updated caches, rotated
    back, are identical in layer 0 (its new k and v come from the
    embedding alone; a later layer's carry the attention's sums, taken over
    the slots in another order)."""
    Sc = cfg.window
    ring = lm_twin(model, torch.float32)
    full = lm_twin(ring, window=None)
    cache = transformer.init_cache(ring.cfg, 1, Sc, dev)
    for t in cache.values():
        t.normal_(generator=g)
    tok = torch.randint(0, cfg.vocab, (1,), generator=g, device=dev)
    shift = (cache_len + 1) % Sc  # the slot of the oldest entry after the write
    rolled = {n: torch.roll(t, -shift, dims=2) for n, t in cache.items()}
    ring_logits, cache = transformer.decode_step(ring, cache, tok, cache_len)
    full_logits, rolled = transformer.decode_step(full, rolled, tok, cache_len)
    del ring, full
    back = {n: torch.roll(cache[n], -shift, dims=2) for n in cache}
    row = dict(cache_len=cache_len, slot=cache_len % Sc, shift=shift,
               logits_identical=torch.equal(ring_logits, full_logits),
               layer0_identical=all(torch.equal(back[n][0], rolled[n][0]) for n in cache),
               cache_max_abs_err=max(float((back[n] - rolled[n]).abs().max()) for n in cache),
               **lm_exact_agree(ring_logits, full_logits, cfg.vocab))
    assert row["ok"] and row["layer0_identical"] and (shift or row["logits_identical"]), row
    return row


def lm_decode_attention_check(cache, cfg, n_valid: int, g) -> list[dict]:
    """``decode_attention`` on layer 0's bf16 cache at the cell's shape (on
    the card: the ``out_dtype=float32`` products over strided cache views)
    against the same call on the host, whose products run on f32 copies of
    the cache.  q holds bf16 values in f32, so the output is the f32
    accumulator's; it must lie within LM_DECODE_ATTN_ERR_SHARE of its
    largest |value|, with the valid length a scalar and per row."""
    k, v = cache["k"][0], cache["v"][0]
    B, _, _, dh = k.shape
    q = torch.randn(B, 1, cfg.padded_heads, dh, generator=g, device=k.device).to(k.dtype).float()
    lens = torch.randint(1, n_valid + 1, (B,), generator=g, device=k.device)
    lens[0] = n_valid
    host = [t.cpu() for t in (q, k[:, :n_valid], v[:, :n_valid])]
    out = []
    for name, n, n_host in (("scalar", n_valid, n_valid), ("per_row", lens, lens.cpu())):
        got = lm_layers.decode_attention(q, k, v, n)
        want = lm_layers.decode_attention(*host, n_host)
        err = float((got.cpu() - want).abs().max())
        out.append(dict(lens=name, B=B, n_valid=n_valid, kv_dtype=str(k.dtype), out_dtype=str(got.dtype),
                        max_abs_err=err, err_share=err / float(want.abs().max())))
    assert all(r["err_share"] <= LM_DECODE_ATTN_ERR_SHARE and r["out_dtype"] == "torch.float32"
               for r in out), out
    return out


def lm_run(arch, layers, prefill_bs, decode_bs, seed, dev, reduced=False) -> tuple[dict, int]:
    """One LM config on the card: K7 at layer 0 against plain; prefill time
    (median of LM_PREFILL_REPS after a warm-up) against the bf16 FLOP
    bound, K7's launches, peak bytes; the K7 model's last-position logits
    against chunked attention's at LM_CHECK_S; decode == prefill at
    (LM_MATCH_B, LM_MATCH_S); decode-step time (median of LM_DECODE_REPS)
    against (weight + cache bytes) over the memory rate, launches a step,
    peak bytes; bf16 decode attention at the cell's cache against the
    host's f32 products; the ring (sliding window); MoE loads and drops.
    Returns the config's line and K7's launches on its main path (the
    warm-up and timed prefills alone; the checks' are in the line)."""
    cfg = lm_config(arch, layers, reduced)
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, g, dev, head=True, param_dtype=cfg.dtype)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    row = dict(arch=arch, layers=cfg.n_layers, cut=dict(layers=layers, prefill=prefill_bs,
               decode=decode_bs), d_model=cfg.d_model, heads=cfg.n_heads,
               padded_heads=cfg.padded_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
               experts=cfg.n_experts, top_k=cfg.top_k, window=cfg.window, dtype=str(cfg.dtype),
               weight_bytes=weight_bytes, init_s=time.perf_counter() - t0)
    uses_k7 = cfg.window is None
    B, S = prefill_bs
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    if uses_k7:
        row["k7_layer0"] = lm_k7_layer0(model, toks)

    # (1) prefill: the main path; K7's launches counted around it alone
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    stats = MoeStats()
    with stats:
        out = transformer.prefill(model, toks)  # the warm-up, its routing recorded
    prefill_ms = time_ms(lambda: transformer.prefill(model, toks), reps=LM_PREFILL_REPS, warmup=0)
    launches = fa.launches
    assert out.shape == (B, cfg.padded_vocab) and bool(torch.isfinite(out[:, :cfg.vocab]).all())
    flops = cells_mod.lm_model_flops(cfg, "prefill", S, B)
    # the bound's work: the reference's model FLOPs, less its 2 N a token
    # for the embedding (a lookup) and the head, plus the head at the B
    # last positions (the only logits prefill makes)
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tied_embeddings else 2)
    bound_flops = flops - 2.0 * B * S * emb + 2.0 * B * cfg.d_model * cfg.vocab
    row["prefill"] = dict(B=B, S=S, ms=prefill_ms, model_flops=flops, bound_flops=bound_flops,
                          bound_ms=bound_flops / BF16_FLOPS * 1e3,
                          tokens_per_s=B * S / prefill_ms * 1e3,
                          k7_launches=launches, peak_device_bytes=torch.cuda.max_memory_allocated())
    assert launches == (LM_PREFILL_REPS + 1) * cfg.n_layers * uses_k7, (launches, cfg.n_layers)
    if cfg.n_experts:
        row["moe"] = stats.summary()
        assert row["moe"]["layers"] == cfg.n_moe_layers, row["moe"]
    del out

    # (2) K7 against chunked attention through the whole model.  An MoE
    # model's chunked run takes the K7 run's expert choices: top-k routing
    # is discontinuous, and a near-tie that the two attentions' roundings
    # settle apart moves a token to another expert (and, with drops, every
    # later token of its group to other slots): granite-moe-1b's 24 layers
    # ended 12% (capacity 1.25) and 7% (no drops) of the largest logit
    # apart with free routing on an H100.  The tokens whose own choices differ are
    # counted (``flipped``)
    if uses_k7:
        tc = toks[:, : min(S, LM_CHECK_S)]
        fa.launches = 0
        with MoeStats() as k7_routes:
            k7 = transformer.prefill(model, tc)
        check_launches = fa.launches  # a check's, not the main path's
        with MoeStats(replay=k7_routes.calls) as replayed:
            chunked = transformer.prefill(lm_twin(model, attn_impl="chunked"), tc)
        row["k7_vs_chunked"] = dict(S=tc.shape[1], routing_replayed=bool(cfg.n_experts),
                                    flipped_tokens=replayed.flipped, k7_launches=check_launches,
                                    **lm_logits_agree(k7, chunked, cfg.vocab))
        del k7_routes, replayed
        assert row["k7_vs_chunked"]["ok"] and row["k7_vs_chunked"]["argmax_equal"], row

    # (3) decode == prefill, in f32 (no expert drops a choice: capacity E / k)
    mt = torch.randint(0, cfg.vocab, (LM_MATCH_B, LM_MATCH_S), generator=g, device=dev)
    no_drop = dict(capacity_factor=cfg.n_experts / cfg.top_k) if cfg.n_experts else {}
    m32 = lm_twin(model, torch.float32, **no_drop)
    fa.launches = 0
    want = transformer.prefill(m32, mt)
    check_launches = fa.launches  # K7's f32 body, a check's
    cache = transformer.init_cache(m32.cfg, LM_MATCH_B, LM_MATCH_S, dev)
    for t in range(LM_MATCH_S):
        got, cache = transformer.decode_step(m32, cache, mt[:, t], t)
    del cache, m32
    row["decode_vs_prefill"] = dict(B=LM_MATCH_B, S=LM_MATCH_S, dtype="torch.float32",
                                    k7_launches=check_launches,
                                    **lm_exact_agree(got, want, cfg.vocab))
    assert row["decode_vs_prefill"]["ok"], row

    # (4) decode at the cell's cache length
    Bd, seq_len, cache_len = decode_bs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = transformer.init_cache(cfg, Bd, seq_len, dev)
    for t in cache.values():
        for layer in t:
            layer.normal_(generator=g)
    dt = torch.randint(0, cfg.vocab, (Bd,), generator=g, device=dev)

    def step():
        return transformer.decode_step(model, cache, dt, cache_len)

    step_ms = time_ms(step, reps=LM_DECODE_REPS)
    logits, _ = step()
    assert bool(torch.isfinite(logits[:, : cfg.vocab]).all())
    kern, wall_ms, whole, sessions = traced_kernels(step, reps=3)
    Sc = cache["k"].shape[2]
    n_valid = min(cache_len + 1, Sc)
    read = (weight_bytes - model.embed.numel() * model.embed.element_size()
            + Bd * cfg.d_model * model.embed.element_size())  # embed: B rows
    cache_bytes = 2 * cfg.n_layers * Bd * n_valid * cfg.n_kv_heads * cfg.d_head * cache["k"].element_size()
    row["decode"] = dict(
        B=Bd, seq_len=seq_len, cache_slots=Sc, cache_len=cache_len, ms=step_ms,
        weight_bytes_read=read, cache_bytes_read=cache_bytes,
        bound_ms=(read + cache_bytes) / HBM_BYTES_PER_S * 1e3,
        tokens_per_s=Bd / step_ms * 1e3,
        model_flops=cells_mod.lm_model_flops(cfg, "decode", seq_len, Bd),
        launches_per_step=sum(e.count for e in kern) // 3, launches_whole=whole, sessions=sessions,
        profiled_device_ms=sum(e.self_device_time_total for e in kern) / 1e3 / 3,
        profiled_wall_ms=wall_ms, peak_device_bytes=torch.cuda.max_memory_allocated(),
        top=[dict(kernel=e.key[:80], ms=e.self_device_time_total / 1e3 / 3, calls=e.count // 3)
             for e in kern[:6]],
        bf16_attention=lm_decode_attention_check(cache, cfg, n_valid, g))
    del cache

    # (5) the ring: at the cell's cache_len and at one whose window does
    # not start at slot 0
    if cfg.window:
        row["ring"] = [lm_ring_check(model, cfg, dev, g, n)
                       for n in (cache_len, cache_len - LM_RING_OFFSET)]
    del model
    torch.cuda.empty_cache()
    return row, launches


def lm_phase(seed, dev, info: dict, runs=LM_RUNS, reduced=False) -> dict:
    """Phase lm: each of LM_RUNS through ``lm_run`` (one ``lm`` line each).
    Returns K7's launches on the LM main path."""
    total = 0
    info["configs"] = []
    for i, (arch, layers, prefill_bs, decode_bs) in enumerate(runs):
        row, launches = lm_run(arch, layers, prefill_bs, decode_bs, seed + 41 + i, dev, reduced)
        emit({"lm": row})
        info["configs"].append(arch)
        total += launches
    return {"flash_attention": total}


# --------------------------------------------------------------------------
# phase lm_train: LM training on the card
# --------------------------------------------------------------------------
def step_launches(fn, dev) -> dict:
    """The kernels one call of ``fn`` launches, under torch.profiler: one
    session whose discarded warm-up traces a tiny kernel (CUPTI loses
    records at a session's start), then the call; its wall ms, device ms,
    the top kernels, and the seconds the profiler took to read its
    records.  The records are read raw (``kineto_results.events()``):
    ``key_averages()`` spent 0.25 ms an event on a training step's ~10^5
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    calls, ns = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.name().startswith("ProfilerStep"):
            calls[e.name()] += 1
            ns[e.name()] += e.end_ns() - e.start_ns()
    device_ms = sum(ns.values()) / 1e6
    return dict(launches=sum(calls.values()), wall_ms=wall_ms, device_ms=device_ms,
                device_over_wall=device_ms / wall_ms,
                read_s=time.perf_counter() - t_all - wall_ms / 1e3,
                top=[dict(kernel=k[:80], ms=v / 1e6, calls=calls[k]) for k, v in ns.most_common(6)])


def lm_train_entry(dev, reduced=False) -> tuple[dict, dict]:
    """(1) ``launch.train.run`` at the reference's defaults, checkpointing
    into a temporary directory.  Returns its line and its result."""
    argv = LM_TRAIN_ARGV + ["--device", str(dev)] + (["--reduced"] if reduced else [])
    torch.cuda.reset_peak_memory_stats()
    saves = []
    manager_save = train_ckpt.CheckpointManager.save

    def timed_save(self, step, tree):  # the checkpoint's host copy and write
        t0 = time.perf_counter()
        manager_save(self, step, tree)
        saves.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        train_ckpt.CheckpointManager.save = timed_save
        try:
            t0 = time.perf_counter()
            out = train_cli.run(argv + ["--ckpt-dir", tmp])
            wall_s = time.perf_counter() - t0
        finally:
            train_ckpt.CheckpointManager.save = manager_save
        on_disk = sorted(os.listdir(tmp))
        ckpt_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
    cfg, losses = out["cfg"], out["losses"]
    row = dict(run="entry_point", argv=argv, arch=cfg.name, layers=cfg.n_layers,
               dtype=str(cfg.dtype), batch=8, seq=64,
               params=sum(p.numel() for p in train_tree.leaves(out["state"]["params"])),
               steps=out["steps"], restarts=out["restarts"], run_s=out["seconds"], wall_s=wall_s,
               checkpoint_save_s=saves,
               ms_a_step=(out["seconds"] - sum(saves)) / out["steps"] * 1e3, first_loss=losses[0],
               last_loss=losses[-1], losses=losses, checkpoints=on_disk,
               checkpoint_bytes=ckpt_bytes, peak_device_bytes=torch.cuda.max_memory_allocated())
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], row
    assert on_disk == [f"step_{out['steps']:08d}"] and out["restarts"] == 0, row
    return row, out


def lm_train_serve(out, dev, g, reduced=False) -> tuple[dict, int]:
    """(2) The entry point's trained weights served: a bf16 copy with K7 as
    its prefill attention, B x S tokens through it (the main path, K7's
    launches counted around it alone) against chunked attention with the
    K7 run's expert choices replayed (phase lm's check)."""
    cfg = dataclasses.replace(out["cfg"], dtype=torch.bfloat16, attn_impl="flash")
    served = transformer.Transformer(cfg, dev, head=True, param_dtype=torch.bfloat16)
    transformer.assign_params(served, transformer.param_paths(cfg, True), train_tree.tree_map(
        lambda t: t.to(torch.bfloat16), out["state"]["params"]))
    B, S = (2, 64) if reduced else LM_SERVE_BS
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    fa.launches = 0
    with MoeStats() as routes:
        k7 = transformer.prefill(served, toks)
    launches = fa.launches
    assert launches == cfg.n_layers, (launches, cfg.n_layers)
    assert bool(torch.isfinite(k7[:, :cfg.vocab]).all())
    with MoeStats(replay=routes.calls) as replayed:
        chunked = transformer.prefill(lm_twin(served, attn_impl="chunked"), toks)
    row = dict(run="served", arch=cfg.name, B=B, S=S, dtype=str(cfg.dtype), k7_launches=launches,
               flipped_tokens=replayed.flipped, moe=routes.summary(),
               **lm_logits_agree(k7, chunked, cfg.vocab))
    assert row["ok"] and row["argmax_equal"], row
    return row, launches


def lm_train_run(arch, layers, seed, dev, reduced=False) -> dict:
    """(3) The train_4k cell at full width (``reduced``: the reduced config
    at the cell's reduced shape, for a CPU rehearsal): f32 weights drawn on
    the card, and the cell's step and state (``cells._train_pieces``: bf16
    products, ``_default_optimizer``, donating its parameters and state)."""
    mod = configs.get(arch)
    cfg = mod.reduced_config() if reduced else mod.full_config()
    cut = []
    if layers and not reduced:
        cut.append(f"n_layers {cfg.n_layers} -> {layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cell = configs.cells_of(arch)["train_4k"]
    if reduced:
        S, Bg, n_micro = cell.reduced["seq_len"], cell.reduced["global_batch"], cell.reduced["n_micro"]
    else:
        S, Bg, n_micro = LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_MICRO
        assert S == cell.full["seq_len"]
        cut += [f"global_batch {cell.full['global_batch']} -> {Bg}",
                f"n_micro {cell.full['n_micro']} -> {n_micro}"]
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                                    head=True)
    step, (params, opt_state, _) = cells_mod._train_pieces(
        transformer.loss_fn(model), transformer.train_params(model), n_micro, None,
        cast_dtype=cfg.dtype)
    rng = np.random.default_rng(seed)
    batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab, (Bg, S)), dtype=torch.int32,
                                   device=dev) for k in ("tokens", "targets")}
               for _ in range(1 + LM_TRAIN_TIMED)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the warm-up step under the profiler (its launches) and the router spy
    first = {}

    def warm_up():
        first["out"] = step(params, opt_state, batches[0])

    with MoeStats() as stats:
        prof = step_launches(warm_up, dev)
    params, opt_state, m = first.pop("out")
    moe = stats.summary() if cfg.n_experts else None
    del stats
    losses, ms = [float(m["loss"])], []
    for b in batches[1:]:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(ms)
    flops = cells_mod.lm_model_flops(cfg, "train", S, Bg)
    row = dict(run="train_4k", arch=arch, layers=cfg.n_layers, reduced=cut, seq=S,
               global_batch=Bg, n_micro=n_micro, dtype=str(cfg.dtype), param_dtype="torch.float32",
               attn_impl=cfg.attn_impl, remat=cfg.remat,
               params=sum(p.numel() for p in train_tree.leaves(params)),
               active_params=cfg.active_params(), init_s=init_s, step_ms=ms, step_p50_ms=p50, tokens_per_s=Bg * S / p50 * 1e3,
               model_flops=flops, mfu=flops / (p50 / 1e3) / BF16_FLOPS, losses=losses,
               resident_bytes=resident, peak_device_bytes=peak,
               launches_a_step=prof.pop("launches"), profiled_warmup_step=prof)
    if moe is not None:
        shares = moe["dropped_share"]
        row["moe"] = dict(calls=len(shares), dropped_share_mean=statistics.mean(shares),
                          dropped_share_min_max=[min(shares), max(shares)],
                          first_layer_loads=moe["first_layer_loads"])
    assert all(math.isfinite(x) for x in losses), row
    del model, params, opt_state, batches
    torch.cuda.empty_cache()
    return row


def lm_host_step(arch, dev, seed) -> tuple[float, list]:
    """One ``n_micro`` 2 AdamW step of the arch's reduced config in f32 on
    ``dev``, from weights drawn on the host: the loss and the parameters."""
    cfg = configs.get(arch).reduced_config()
    init = transformer.init_params(cfg, torch.Generator().manual_seed(seed), "cpu", head=True)
    model, state = transformer.train_state_from_numpy({"params": init.numpy_params()}, cfg, dev)
    opt = train_opt.adamw(train_opt.AdamWConfig(schedule=train_opt.cosine_schedule(**LM_HOST_SCHED)))
    step = train_loop.make_train_step(transformer.loss_fn(model), opt, n_micro=2)
    b = next(synthetic.lm_batches(cfg.vocab, LM_HOST_B, LM_HOST_S, seed=seed))
    p, _, m = step(state["params"], train_loop.init_opt_state(opt, state["params"]), b)
    return float(m["loss"]), train_tree.leaves(train_tree.to_numpy(p))


def lm_card_vs_host(seed, dev) -> list[dict]:
    """(4) Each reduced LM config's step on the card against the host's."""
    rows = []
    lr = float(train_opt.cosine_schedule(**LM_HOST_SCHED)(1))
    for i, arch in enumerate(LM_ARCH_IDS):
        (card_loss, card_p), (host_loss, host_p) = (lm_host_step(arch, d, seed + i)
                                                    for d in (dev, "cpu"))
        d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(card_p, host_p)])
        w = np.concatenate([np.abs(b).ravel() for b in host_p])
        row = dict(arch=arch, loss_card=card_loss, loss_host=host_loss,
                   loss_rel=abs(card_loss / host_loss - 1), max_param_abs_diff=float(d.max()),
                   outside=int((d > LM_HOST_ATOL + LM_HOST_RTOL * w).sum()), params=int(d.size))
        row["ok"] = bool(math.isfinite(card_loss) and row["loss_rel"] <= LM_HOST_LOSS_RTOL
                         and row["outside"] <= LM_HOST_OUTLIERS * d.size and d.max() <= 2 * lr)
        rows.append(row)
    assert all(r["ok"] for r in rows), rows
    return rows


def lm_train_phase(seed, dev, info: dict, runs=LM_TRAIN_RUNS, reduced=False) -> dict:
    """Phase lm_train (one ``lm_train`` line a run).  Returns K7's launches
    on its main path, the trained weights' prefill."""
    info["resident_bytes"] = torch.cuda.memory_allocated()  # earlier phases' leftovers
    row, out = lm_train_entry(dev, reduced)
    emit({"lm_train": row})
    g = torch.Generator(device=dev).manual_seed(seed + 61)
    row, launches = lm_train_serve(out, dev, g, reduced)
    emit({"lm_train": row})
    del out
    torch.cuda.empty_cache()
    info["runs"] = ["entry_point", "served"]
    for i, (arch, layers) in enumerate(runs):
        emit({"lm_train": lm_train_run(arch, layers, seed + 71 + i, dev, reduced)})
        info["runs"].append(f"train_4k {arch}")
    info["card_vs_host"] = lm_card_vs_host(seed + 81, dev)
    return {"flash_attention": launches}


# --------------------------------------------------------------------------
# phase lm_tp: the "model" mesh axis, two gloo ranks sharing the card
# --------------------------------------------------------------------------
def lm_tp_serve(arch, layers, prefill_bs, decode_bs, seed, dev, reduced=False,
                replay=None) -> dict:
    """One LM config served by this process under the active mesh, from
    weights, tokens and a cache drawn from ``seed`` on ``dev`` (the same on
    one process and on each rank, which keeps its piece): the prefill's
    logits, LM_TP_STEPS decode steps' logits, layer 0's whole cache after
    them, the MoE layers' choices (``replay``: an earlier run's, taken),
    K7's launches and the times, on the host."""
    cfg = lm_config(arch, layers, reduced)
    resident = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = transformer.init_params(cfg, g, dev, head=True, param_dtype=cfg.dtype)
    B, S = (2, 32) if reduced else prefill_bs
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    fa.launches = 0
    with MoeStats(replay=replay and replay["prefill"]) as routes:
        _sync(dev)
        t0 = time.perf_counter()
        logits = transformer.prefill(model, toks)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = fa.launches
    Bd, slots, start = (4, 32, 32 - LM_TP_STEPS) if reduced else decode_bs
    shape = (cfg.n_layers, Bd, transformer.cache_seq_len(cfg, slots), cfg.n_kv_heads, cfg.d_head)
    cache = transformer.init_cache(cfg, Bd, slots, dev)  # this process's piece
    for name in cache:  # the whole cache drawn, its piece kept
        whole = torch.empty(shape, dtype=cfg.dtype, device=dev).normal_(generator=g)
        cache[name].copy_(_piece(model, whole, cache[name].shape))
        del whole
    dtok = torch.randint(0, cfg.vocab, (LM_TP_STEPS, Bd), generator=g, device=dev)
    cache32 = cache.map(torch.Tensor.float)  # the f32 check's start
    steps, step_ms = [], []
    with MoeStats(replay=replay and replay["decode"]) as droutes:
        for t in range(LM_TP_STEPS):
            _sync(dev)
            t0 = time.perf_counter()
            out, cache = transformer.decode_step(model, cache, dtok[t], start + t)
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(out.cpu())
    layer0 = transformer.gather_cache(model, cache.map(lambda c: c[:1]))
    cache_local = tuple(cache["k"].shape)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    del cache
    # the same steps in f32 from the same bf16 weights and cache: two sum
    # orders agree to f32's rounding here, where bf16 amplifies one
    # rounding through the layers (see LM_F32_COS_MIN).  They take the bf16
    # steps' expert choices (on the ranks, the one process's replayed), so
    # bf16 and f32 differ in their rounding alone (LM_TP_BF16_SPREAD)
    m32, steps32 = lm_twin(model, torch.float32), []
    replay32 = replay["decode32"] if replay else droutes.calls
    with MoeStats(replay=replay32 or None) as routes32:
        for t in range(LM_TP_STEPS):
            out, cache32 = transformer.decode_step(m32, cache32, dtok[t], start + t)
            steps32.append(out.cpu())
    del m32, cache32
    rec = dict(prefill=logits.cpu(), decode=steps, decode32=steps32,
               layer0={n: c.cpu() for n, c in layer0.items()},
               routes={k: [(i.cpu(), kp.cpu(), e) for i, kp, e in r.calls]
                       for k, r in (("prefill", routes), ("decode", droutes), ("decode32", routes32))},
               flipped=routes.flipped + droutes.flipped + routes32.flipped, k7_launches=launches,
               prefill_ms=prefill_ms, decode_ms=step_ms, cache_local=cache_local,
               peak_device_bytes=peak, resident_bytes=resident,
               weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
               vocab=cfg.vocab, layers=cfg.n_layers)
    del model, layer0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _piece(model, whole, local_shape):
    """This process's piece of a whole cache tensor: its KV heads (dim 3)
    or its run of slots (dim 2), whichever ``local_shape`` has fewer of;
    the whole tensor when ``local_shape`` is its shape."""
    dims = [i for i, (n, w) in enumerate(zip(local_shape, whole.shape)) if n != w]
    if not dims:
        return whole
    dim = dims[0]
    n, r = local_shape[dim], model.tp.rank
    return whole.narrow(dim, r * n, n)


def lm_tp_train(argv, dev, tmp) -> dict:
    """(c) ``launch.train.run`` (checkpoint writes skipped): its losses,
    step ms, peak bytes, and the replicated leaves' checksums."""
    skipped, step_s = [], []
    manager_save, gather = train_ckpt.CheckpointManager.save, train_ckpt.gather
    observe = ft.StepWatchdog.observe
    train_ckpt.CheckpointManager.save = lambda self, step, tree: skipped.append(step)
    train_ckpt.gather = lambda tree, shardings=None: tree

    def timed_observe(self, step, seconds):  # each step's seconds, as the watchdog sees them
        step_s.append(seconds)
        return observe(self, step, seconds)

    ft.StepWatchdog.observe = timed_observe
    resident = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        out = train_cli.run(argv + ["--device", str(dev), "--ckpt-dir", tmp])
    finally:
        train_ckpt.CheckpointManager.save, train_ckpt.gather = manager_save, gather
        ft.StepWatchdog.observe = observe
    params = out["state"]["params"]
    place = out["placements"]
    whole = params if place is None else [
        p for p, pl in zip(train_tree.leaves(params), train_tree.leaves(place)) if not pl.split]
    return dict(losses=out["losses"], steps=out["steps"], seconds=out["seconds"],
                step_ms=[x * 1e3 for x in step_s],
                step_p50_ms=statistics.median(step_s[1:] or step_s) * 1e3,  # past the first
                checkpoints_skipped=skipped,
                replicated_checksums=train_loop.replica_checksums(whole).cpu(),
                peak_device_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
                resident_bytes=resident)


def spy_collectives(dev) -> list:
    """Time every collective of this process from here on (each between two
    device synchronizes) and count its bytes on the wire (a bf16 or f16 sum
    crosses gloo in f32); returns the list each one's ``(kind, bytes, ms)``
    is appended to."""
    wire = []
    reduce_, gather_ = mesh_mod._all_reduce, mesh_mod._all_gather_list

    def timed(kind, fn, t, *a):
        _sync(dev)
        t0 = time.perf_counter()
        res = fn(*a)
        _sync(dev)
        n = t.numel() * (4 if t.dtype in (torch.bfloat16, torch.float16) else t.element_size())
        wire.append((kind, n, (time.perf_counter() - t0) * 1e3))
        return res

    mesh_mod._all_reduce = lambda m, t, op, axis: timed("all_reduce", reduce_, t, m, t, op, axis)
    mesh_mod._all_gather_list = lambda m, t: timed("all_gather", gather_, t, m, t)
    return wire


def lm_tp_rank(rank: int, tmp: str, seed: int, device: str, reduced: bool) -> None:
    """One of the LM_TP_MODEL ranks sharing ``device`` over gloo on a 1 x
    LM_TP_MODEL mesh: each of LM_TP_RUNS served (the one-process run's
    expert choices replayed from ``{tmp}/routes{i}.pt``), then (c), then
    ColBERT's runs (colbert_tp_*; the one process's stepped weights read
    from ``tmp``); every collective timed and its bytes counted.  Writes
    ``{tmp}/rank{r}.pt``."""
    mesh_mod.init_distributed(f"file://{tmp}/rendezvous", LM_TP_MODEL, rank, backend="gloo")
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # this process's CUDA context, before its counters
        else:  # a CPU rehearsal: count K7's plain calls as launches
            def on_card(t, name):
                fa.launches += name == "flash_attention"
                return False
            _build.on_card = on_card
        mesh = mesh_mod.make_production_mesh(device=device, model=LM_TP_MODEL)
        assert mesh.shape == {"data": 1, "model": LM_TP_MODEL} and mesh.devices == (dev,)
        wire = spy_collectives(dev)
        out = {}
        with sharding.use_mesh(mesh):
            for i, (arch, layers, pbs, dbs) in enumerate(LM_TP_RUNS):
                replay = torch.load(f"{tmp}/routes{i}.pt")
                replay = {k: [(ids.to(dev), keep.to(dev), e) for ids, keep, e in v]
                          for k, v in replay.items()}
                n = len(wire)
                rec = lm_tp_serve(arch, layers, pbs, dbs, seed + 91 + i, dev, reduced, replay)
                rec["wire"] = wire[n:]
                out[arch] = rec
            red = ["--reduced"] if reduced else []
            on_mesh = ["--mesh", "single", "--model", str(LM_TP_MODEL)]
            runs = {
                "train": lambda: lm_tp_train(LM_TP_TRAIN_ARGV + on_mesh + red, dev, f"{tmp}/ckpt"),
                "colbert_encode": lambda: colbert_tp_encode(seed + 95, dev, reduced),
                "colbert_train": lambda: colbert_tp_train(dev, tmp, reduced, mesh),
                "colbert_int8": lambda: colbert_tp_int8(dev, tmp, reduced, mesh),
                "colbert_cli": lambda: lm_tp_train(COLBERT_TP_TRAIN_ARGV + on_mesh + red, dev,
                                                   f"{tmp}/ckpt_colbert"),
            }
            for key, run in runs.items():
                n, t0 = len(wire), time.perf_counter()
                out[key] = run()
                out[key].update(wire=wire[n:], run_s=time.perf_counter() - t0)
        torch.save(out, f"{tmp}/rank{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def bf16_spread(ranks: dict, one: dict) -> dict:
    """The ranks' bf16 decode against the one process's f32 steps beside
    the one process's own bf16 decode against them: 1 - cosine and the
    largest |diff| share, each allowed LM_TP_BF16_SPREAD times the one
    process's, or the f32 bars (LM_F32_*) where that is less (a model
    whose compute dtype is f32 has no bf16 spread)."""
    row = dict(cos_gap=1 - ranks["min_cos"], err_share=ranks["max_err_share"],
               allowed_cos_gap=max(LM_TP_BF16_SPREAD * (1 - one["min_cos"]), 1 - LM_F32_COS_MIN),
               allowed_err_share=max(LM_TP_BF16_SPREAD * one["max_err_share"], LM_F32_ERR_SHARE))
    row["ratio"] = [row["cos_gap"] / max(1 - one["min_cos"], 1e-12),
                    row["err_share"] / max(one["max_err_share"], 1e-12)]
    row["ok"] = (row["cos_gap"] <= row["allowed_cos_gap"]
                 and row["err_share"] <= row["allowed_err_share"])
    return row


def _wire_summary(wire, steps: int) -> dict:
    kinds = sorted({k for k, _, _ in wire})
    return {k: dict(calls=sum(1 for kk, _, _ in wire if kk == k) / steps,
                    bytes=sum(b for kk, b, _ in wire if kk == k) / steps,
                    ms=sum(ms for kk, _, ms in wire if kk == k) / steps) for k in kinds}


def colbert_tp_values(reduced: bool) -> tuple:
    """ColBERT's config and phase lm_tp's cut values: (cfg, passages, their
    tokens, queries, their tokens, an encode's passages, train_triples'
    values); a CPU rehearsal's at the reduced config."""
    if reduced:
        return (colbert_cfg.reduced_config(), 8, 16, 4, 8, 4,
                dict(global_batch=4, q_len=8, d_len=16, nway=2, n_micro=1))
    return (colbert_cfg.full_config(), COLBERT_TP_PASSAGES, DOC_MAXLEN, COLBERT_TP_QUERIES, NQ,
            ENCODE_BATCH, COLBERT_TP_TRAIN)


def colbert_f32_twin(model):
    """``model``'s weights in an f32 encoder with plain (chunked) attention:
    the yardstick of the bf16 encodes' distance."""
    bb = lm_twin(model.backbone, torch.float32, attn_impl="chunked")
    twin = colbert.ColBERT(dataclasses.replace(model.cfg, backbone=bb.cfg), bb)
    with torch.no_grad():
        twin.proj.copy_(model.proj)
    return twin


def colbert_tp_encode(seed, dev, reduced=False, twin=False) -> dict:
    """(a) The encoder through K7 under the active mesh, from weights and
    tokens drawn from ``seed`` (whole on every process, each keeping its
    piece): the valid passage vectors and the query vectors (host), each
    encode's ms, K7's launches and the peak bytes; with ``twin`` the same
    vectors from the f32 twin too."""
    cfg, P, L, Q, Lq, chunk, _ = colbert_tp_values(reduced)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, attn_impl="flash"))
    _peak_reset(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = colbert.init_params(cfg, g, device=dev)
    lens = torch.randint(Lq, L + 1, (P,), generator=g, device=dev)
    toks = torch.randint(0, cfg.backbone.vocab, (P, L), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]).float()
    calls = [(toks[i : i + chunk], mask[i : i + chunk]) for i in range(0, P, chunk)]
    calls.append((toks[:Q, :Lq], None))  # the queries: a passage's head

    def vectors(m, ms=None):
        out = []
        for t, msk in calls:
            _sync(dev)
            t0 = time.perf_counter()
            e = colbert.encode(m, t, msk)
            _sync(dev)
            if ms is not None:
                ms.append((time.perf_counter() - t0) * 1e3)
            out.append((e if msk is None else e[msk.bool()]).reshape(-1, e.shape[-1]).cpu())
        return torch.cat(out)

    fa.launches = 0
    ms = []
    rec = dict(vectors=vectors(model, ms), k7_launches=fa.launches, calls=len(calls),
               layers=cfg.backbone.n_layers, passages=P, doc_len=L, queries=Q, q_len=Lq,
               chunk=chunk, encode_ms=ms[:-1], query_ms=ms[-1], peak_device_bytes=_peak(dev),
               weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))
    if twin:
        rec["vectors32"] = vectors(colbert_f32_twin(model))
    del model
    return rec


def colbert_tp_train(dev, tmp: str, reduced=False, mesh=None) -> dict:
    """(b) COLBERT_TP_STEPS steps of the train_triples cell
    (``cells.retrieval_cell``, its seeded weights, batch and donating
    AdamW step) in f32 at the cut values, under ``mesh`` (None: one
    process): losses, step ms, peak bytes; the stepped weights saved by
    the one process and held by each rank (:func:`hold_to_saved`)."""
    cfg, *_, p = colbert_tp_values(reduced)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, dtype=torch.float32))
    _peak_reset(dev)
    built = cells_mod.retrieval_cell(CELLS_ARCH, cfg, configs.cells_of(CELLS_ARCH)["train_triples"],
                                     p, dev, mesh=mesh)
    params, opt_state, batch = built.args
    losses, ms = [], []
    for _ in range(COLBERT_TP_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = built.fn(params, opt_state, batch)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    rec = dict(values=p, dtype="float32", losses=losses, step_ms=ms,
               step_p50_ms=statistics.median(ms[1:]), peak_device_bytes=_peak(dev))
    rec.update(hold_to_saved(train_tree.leaves(params), Path(tmp) / "colbert_train",
                             colbert_placements(cfg, mesh), dev))
    return rec


def colbert_tp_int8(dev, tmp: str, reduced=False, mesh=None) -> dict:
    """(c) One int8 step (error feedback from zero) of (b)'s weights, batch
    and optimizer as drawn, under ``mesh`` (each split gradient quantized
    whole: ``training.loop``): the loss, step ms, the error feedback's
    largest |value|, the stepped weights as in (b)."""
    cfg, *_, p = colbert_tp_values(reduced)
    cfg = dataclasses.replace(cfg, nway=p["nway"], backbone=dataclasses.replace(
        cfg.backbone, dtype=torch.float32))
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(sharding.use_mesh(mesh))
        model = colbert.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        place = model.placement_tree()
        opt = cells_mod._default_optimizer()
        step = train_loop.make_train_step(colbert.loss_fn(model), opt, compression="int8",
                                          donate=True, placements=place)
        params = colbert.train_params(model)
        state = train_loop.init_opt_state(opt, params, "int8")
        batch = next(synthetic.colbert_batches(cfg.backbone.vocab, p["global_batch"],
                                               q_len=p["q_len"], d_len=p["d_len"], nway=p["nway"]))
        _sync(dev)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
    rec = dict(values=p, dtype="float32", loss=float(m["loss"]), step_ms=ms,
               ef_max=max(float(e.abs().max()) for e in train_tree.leaves(state["ef"])))
    rec.update(hold_to_saved(train_tree.leaves(params), Path(tmp) / "colbert_int8",
                             place and train_tree.leaves(place), dev))
    del model, params, state
    return rec


def colbert_placements(cfg, mesh):
    """The leaves' placements of a ColBERT training tree (no ``lm_head``)
    under ``mesh``, in ``training.tree.leaves`` order; None without one."""
    if mesh is None:
        return None
    with sharding.use_mesh(mesh):
        place = colbert.ColBERT(cfg, transformer.Transformer(cfg.backbone, "meta")).placement_tree()
    return place and train_tree.leaves(place)


def colbert_tp_lines(ranks: list, one: dict, info: dict) -> int:
    """Phase lm_tp's ColBERT checks, one ``lm_tp`` line for each of (a)-(c)
    (``lm_tp_phase`` prints (d)'s).  Returns K7's launches on the ranks'
    encodes."""
    mesh_shape = {"data": 1, "model": LM_TP_MODEL}
    recs = [r["colbert_encode"] for r in ranks]
    enc = one["colbert_encode"]
    dim = enc["vectors"].shape[-1]
    rows = [lm_logits_agree(r["vectors"], enc["vectors"], dim) for r in recs]
    for row in rows:  # the |diff| share is held by the spread (COLBERT_TP_PASSAGES' note)
        row["ok"] = row["min_cos"] >= LM_TP_COS_MIN
    line = dict(
        run="colbert_encode", layers=enc["layers"], mesh=mesh_shape,
        cut=dict(passages=enc["passages"], encode_corpus_batch=4096, doc_len=enc["doc_len"],
                 queries=enc["queries"], q_len=enc["q_len"], encode_batch=enc["chunk"]),
        vectors=int(enc["vectors"].shape[0]), against_one_process=rows,
        one_process_bf16_vs_f32=lm_logits_agree(enc["vectors"], enc["vectors32"], dim),
        ranks_bf16_vs_f32=lm_logits_agree(recs[0]["vectors"], enc["vectors32"], dim),
        k7_launches=[r["k7_launches"] for r in recs], one_process_k7_launches=enc["k7_launches"],
        encode_p50_ms=[statistics.median(r["encode_ms"]) for r in recs],
        one_process_encode_p50_ms=statistics.median(enc["encode_ms"]),
        query_ms=[r["query_ms"] for r in recs], one_process_query_ms=enc["query_ms"],
        weight_bytes=[r["weight_bytes"] for r in recs], one_process_weight_bytes=enc["weight_bytes"],
        peak_device_bytes=[r["peak_device_bytes"] for r in recs],
        one_process_peak_device_bytes=enc["peak_device_bytes"],
        collectives=[_wire_summary(r["wire"], 1) for r in recs],
        run_s=[r["run_s"] for r in recs], one_process_run_s=enc["run_s"])
    line["bf16_spread"] = bf16_spread(line["ranks_bf16_vs_f32"], line["one_process_bf16_vs_f32"])
    emit({"lm_tp": line, "card": info["card"]})
    assert all(x["ok"] for x in rows) and line["bf16_spread"]["ok"], line
    assert all(bool(torch.isfinite(r["vectors"]).all()) for r in recs), line
    assert all(torch.equal(recs[0]["vectors"], r["vectors"]) for r in recs), "ranks' vectors"
    assert all(r["k7_launches"] == r["layers"] * r["calls"] for r in recs), line

    for key, steps in (("colbert_train", COLBERT_TP_STEPS), ("colbert_int8", 1)):
        recs, want = [r[key] for r in ranks], one[key]
        got, ref_losses = ((recs[0]["losses"], want["losses"]) if key == "colbert_train"
                           else ([recs[0]["loss"]], [want["loss"]]))
        line = dict(run=key, mesh=mesh_shape, steps=steps, losses=got,
                    one_process_losses=ref_losses,
                    max_loss_rel=max(abs(a / b - 1) for a, b in zip(got, ref_losses)),
                    params_outside=[r["params_outside"] for r in recs],
                    params_held=[r["params_held"] for r in recs],
                    max_param_abs_diff=[r["max_param_abs_diff"] for r in recs],
                    adam_flip_bound=adam_flip_bound(steps),
                    split_leaves=recs[0]["split_leaves"], whole_leaves=recs[0]["whole_leaves"],
                    replicated_identical=all(torch.equal(r["replicated_checksums"],
                                                         recs[0]["replicated_checksums"])
                                             for r in recs),
                    collectives_a_step=[_wire_summary(r["wire"], steps) for r in recs],
                    run_s=[r["run_s"] for r in recs], one_process_run_s=want["run_s"])
        line["cut"] = dict(want["values"], full_batch=256, full_n_micro=8, dtype=want["dtype"])
        if key == "colbert_train":
            line.update(step_ms=[r["step_ms"] for r in recs],
                        step_p50_ms=[r["step_p50_ms"] for r in recs],
                        one_process_step_ms=want["step_ms"],
                        one_process_step_p50_ms=want["step_p50_ms"],
                        peak_device_bytes=[r["peak_device_bytes"] for r in recs],
                        one_process_peak_device_bytes=want["peak_device_bytes"])
        else:
            line.update(step_ms=[r["step_ms"] for r in recs], one_process_step_ms=want["step_ms"],
                        ef_max=[r["ef_max"] for r in recs], one_process_ef_max=want["ef_max"])
        emit({"lm_tp": line, "card": info["card"]})
        assert all(r.get("losses", [r.get("loss")]) == recs[0].get("losses", [recs[0].get("loss")])
                   for r in recs), "ranks' losses"
        assert line["max_loss_rel"] <= LM_TP_LOSS_RTOL and line["replicated_identical"], line
        assert all(params_agree(r["params_outside"], r["params_held"], r["max_param_abs_diff"],
                                steps) for r in recs), line
        assert all(r.get("ef_max", 1.0) > 0 for r in recs), line
    return sum(r["colbert_encode"]["k7_launches"] for r in ranks)


def hold_to_saved(leaves: list, out_dir: Path, place, dev) -> dict:
    """The one process's stepped weights (``place`` None) saved whole to
    ``out_dir`` (.npy a leaf); a rank's pieces (``place``: the leaves'
    placements, in order) held to them: the weights outside
    FAMILY_MESH_PARAM_TOL, the largest difference, the weights held, the
    split and whole leaves, and the whole leaves' checksums."""
    if place is None:
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, x in enumerate(leaves):
            np.save(out_dir / f"{i}.npy", x.cpu().numpy())
        return {}
    outside, worst, split, held = 0, 0.0, [], 0
    for i, (x, pl) in enumerate(zip(leaves, place)):
        want = torch.from_numpy(np.array(pl.piece(np.load(out_dir / f"{i}.npy",
                                                          mmap_mode="r")))).to(dev)
        n, d = _within(x, want, **FAMILY_MESH_PARAM_TOL)
        outside, worst, held = outside + n, max(worst, d), held + x.numel()
        split.append(pl.split)
        del want
    return dict(params_outside=outside, max_param_abs_diff=worst, params_held=held,
                split_leaves=sum(split), whole_leaves=len(split) - sum(split),
                replicated_checksums=train_loop.replica_checksums(
                    [x for x, s in zip(leaves, split) if not s]).cpu())


def lm_tp_phase(seed, dev, info: dict, reduced=False) -> dict:
    """Phase lm_tp (see the module docstring, 18): the one-process runs,
    then the ranks, then the checks; one ``lm_tp`` line a run.  Returns
    K7's launches on the ranks' main path (their prefills and ColBERT
    encodes)."""
    single, t_phase = [], time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for i, (arch, layers, pbs, dbs) in enumerate(LM_TP_RUNS):
            rec = lm_tp_serve(arch, layers, pbs, dbs, seed + 91 + i, dev, reduced)
            torch.save(rec["routes"], f"{tmp}/routes{i}.pt")
            single.append(rec)
        red = ["--reduced"] if reduced else []
        train_one = lm_tp_train(LM_TP_TRAIN_ARGV + red, dev, f"{tmp}/ckpt_one")
        colbert_one = {}
        for key, run in (
                ("colbert_encode", lambda: colbert_tp_encode(seed + 95, dev, reduced, twin=True)),
                ("colbert_train", lambda: colbert_tp_train(dev, tmp, reduced)),
                ("colbert_int8", lambda: colbert_tp_int8(dev, tmp, reduced)),
                ("colbert_cli", lambda: lm_tp_train(COLBERT_TP_TRAIN_ARGV + red, dev,
                                                    f"{tmp}/ckpt_colbert_one"))):
            t0 = time.perf_counter()
            colbert_one[key] = dict(run(), run_s=time.perf_counter() - t0)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        info["one_process_s"] = t0 - t_phase
        ranks = spawn_gloo_ranks(tmp, lm_tp_rank, seed, str(dev), reduced, n=LM_TP_MODEL)
        info["ranks_s"] = time.perf_counter() - t0
    launches = colbert_tp_lines(ranks, colbert_one, info)
    for (arch, layers, pbs, dbs), one in zip(LM_TP_RUNS, single):
        recs = [r[arch] for r in ranks]
        rows = {"prefill": [lm_logits_agree(r["prefill"], one["prefill"], one["vocab"],
                                            LM_TP_COS_MIN, LM_TP_ERR_SHARE) for r in recs]}
        rows["decode"] = [lm_logits_agree(torch.cat(r["decode"]), torch.cat(one["decode"]),
                                          one["vocab"], LM_TP_COS_MIN, LM_TP_ERR_SHARE)
                          for r in recs]
        rows["decode_f32"] = [lm_exact_agree(torch.cat(r["decode32"]), torch.cat(one["decode32"]),
                                             one["vocab"]) for r in recs]
        layer0 = [all(torch.equal(r["layer0"][n], one["layer0"][n]) for n in ("k", "v"))
                  for r in recs]
        line = dict(
            arch=arch, layers=one["layers"], cut=dict(layers=layers, prefill=pbs, decode=dbs),
            mesh={"data": 1, "model": LM_TP_MODEL}, steps=LM_TP_STEPS,
            prefill=rows["prefill"], decode_bf16=rows["decode"], decode_f32=rows["decode_f32"],
            layer0_cache_identical=layer0,
            k7_launches=[r["k7_launches"] for r in recs], one_process_k7_launches=one["k7_launches"],
            cache_local=[r["cache_local"] for r in recs], cache_whole=tuple(one["layer0"]["k"].shape),
            flipped_tokens=[r["flipped"] for r in recs],
            prefill_ms=[r["prefill_ms"] for r in recs], one_process_prefill_ms=one["prefill_ms"],
            decode_p50_ms=[statistics.median(r["decode_ms"]) for r in recs],
            one_process_decode_p50_ms=statistics.median(one["decode_ms"]),
            weight_bytes=[r["weight_bytes"] for r in recs], one_process_weight_bytes=one["weight_bytes"],
            peak_device_bytes=[r["peak_device_bytes"] for r in recs],
            one_process_peak_device_bytes=one["peak_device_bytes"],
            one_process_resident_bytes=one["resident_bytes"],
            # bf16 against the f32 steps on the same expert choices: the one
            # process's own rounding beside the ranks' (LM_TP_BF16_SPREAD)
            one_process_bf16_vs_f32=lm_logits_agree(torch.cat(one["decode"]),
                                                    torch.cat(one["decode32"]), one["vocab"]),
            ranks_bf16_vs_f32=lm_logits_agree(torch.cat(recs[0]["decode"]),
                                              torch.cat(one["decode32"]), one["vocab"]),
            collectives=[_wire_summary(r["wire"], 1) for r in recs])
        line["bf16_spread"] = bf16_spread(line["ranks_bf16_vs_f32"],
                                          line["one_process_bf16_vs_f32"])
        emit({"lm_tp": line, "card": info["card"]})
        assert all(x["ok"] for x in rows["prefill"] + rows["decode_f32"]), line
        assert line["bf16_spread"]["ok"], line
        assert all(bool(torch.isfinite(torch.cat(r["decode"])[:, :one["vocab"]]).all())
                   for r in recs), line
        assert all(layer0) and all(r["k7_launches"] == one["layers"] for r in recs), line
        assert all(torch.equal(recs[0]["prefill"], r["prefill"]) for r in recs), "ranks' logits"
        launches += sum(r["k7_launches"] for r in recs)
    # (c) and (d): launch.train over the ranks; ColBERT's full config runs
    # in its bf16 compute dtype (COLBERT_TP_TRAIN_ARGV)
    for key, argv, one, rtol, held in (
            ("train", LM_TP_TRAIN_ARGV, train_one, LM_TP_LOSS_RTOL, None),
            ("colbert_cli", COLBERT_TP_TRAIN_ARGV, colbert_one["colbert_cli"], DP_LOSS_RTOL, 1)):
        recs = [r[key] for r in ranks]
        rels = [abs(a / b - 1) for a, b in zip(recs[0]["losses"], one["losses"])]
        line = dict(run=key, argv=argv, mesh={"data": 1, "model": LM_TP_MODEL},
                    losses=recs[0]["losses"], one_process_losses=one["losses"],
                    loss_rel=rels, held_losses=held or len(rels), loss_rtol=rtol,
                    step_ms=[r["step_ms"] for r in recs],
                    step_p50_ms=[r["step_p50_ms"] for r in recs],
                    one_process_step_ms=one["step_ms"],
                    one_process_step_p50_ms=one["step_p50_ms"],
                    replicated_leaves=int(recs[0]["replicated_checksums"].numel()),
                    replicated_identical=all(torch.equal(r["replicated_checksums"],
                                                         recs[0]["replicated_checksums"])
                                             for r in recs),
                    peak_device_bytes=[r["peak_device_bytes"] for r in recs],
                    one_process_peak_device_bytes=one["peak_device_bytes"],
                    one_process_resident_bytes=one["resident_bytes"],
                    collectives_a_step=[_wire_summary(r["wire"], r["steps"]) for r in recs],
                    run_s=[r["run_s"] for r in recs], one_process_run_s=one.get("run_s"),
                    checkpoints="writes skipped on both sides (tests/test_torch_tensor_parallel.py "
                                "and tests/test_torch_colbert_mesh.py hold the gathered state)")
        emit({"lm_tp": line, "card": info["card"]})
        assert all(r["losses"] == recs[0]["losses"] for r in recs), "ranks' losses"
        assert max(rels[:held]) <= rtol and line["replicated_identical"], line
        assert all(math.isfinite(x) for x in recs[0]["losses"]), line
    info["runs"] = [a for a, *_ in LM_TP_RUNS] + ["train", "colbert_encode", "colbert_train",
                                                  "colbert_int8", "colbert_cli"]
    return {"flash_attention": launches}


# --------------------------------------------------------------------------
# phase recsys: the recsys family, PLAID as an item index, SchNet
# --------------------------------------------------------------------------
#: phase recsys: the four recsys archs (BERT4Rec last: its item table feeds
#: the item index); a cell's values cut where the full ones do not fit the
#: card (recsys_cut_bytes reckons each); timed steps after one warm-up
#: step, timed calls after one warm-up call; the card-against-host step's
#: batch; the item index's users, k and a wider probe beside the
#: reference's defaults (nprobe 8, candidate_cap 4,096); SchNet's cells run
#: (ogb_products does not fit: SCHNET_SKIP) and their timed steps
RECSYS_ARCHS = ("wide-deep", "xdeepfm", "bst", "bert4rec")
RECSYS_CUTS = {
    ("bert4rec", "train_batch"): dict(batch=64),
    ("bert4rec", "serve_bulk"): dict(batch=32768),
    ("xdeepfm", "serve_bulk"): dict(batch=65536),
    ("xdeepfm", "retrieval_cand"): dict(n_candidates=65536),
}
RECSYS_TRAIN_TIMED, RECSYS_CALL_REPS, RECSYS_HOST_B = 2, 5, 16
ITEM_USERS, ITEM_K, ITEM_WIDE = 32, 100, dict(nprobe=64, candidate_cap=16384)
GNN_RUNS, GNN_TIMED = ("molecule", "full_graph_sm", "minibatch_lg"), 5
SCHNET_SKIP = "ogb_products"


def _peak_reset(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def wall_ms(fn, dev, reps: int, warmup: int = 1) -> tuple[float, list, object]:
    """Median host ms of ``reps`` calls of ``fn`` each ended by a device
    synchronize, after ``warmup`` calls; the times and the last result."""
    out = None
    for _ in range(warmup):
        out = fn()
    _sync(dev)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), ms, out


def recsys_cut_bytes(arch: str, cell: str, cfg, full: dict, cut: dict) -> dict:
    """The tensor that rules out a cell's full value, its bytes a row and at
    the full and the cut value: BERT4Rec's masked-position logits (B, M,
    V + 2) and its attention scores (B, heads, S, S); xDeepFM's CIN outer
    product (B, H, m, D); all f32."""
    if arch == "bert4rec" and cell == "train_batch":
        m = max(int(2 * cfg.mask_frac * cfg.seq_len), 1)
        what, row = f"(B, {m}, {cfg.item_vocab + 2}) f32 logits", m * (cfg.item_vocab + 2) * 4
    elif arch == "bert4rec":
        what = f"(B, {cfg.n_heads}, {cfg.seq_len}, {cfg.seq_len}) f32 attention scores"
        row = cfg.n_heads * cfg.seq_len**2 * 4
    else:
        h = max(cfg.cin_layers)
        what, row = f"(B, {h}, {cfg.n_sparse}, {cfg.embed_dim}) f32 CIN product", h * cfg.n_sparse * cfg.embed_dim * 4
    (key, full_n), = ((k, full[k]) for k in cut)
    return dict(value=key, full=full_n, cut=cut[key], tensor=what, bytes_a_row=row,
                full_bytes=row * full_n, cut_bytes=row * cut[key])


def recsys_arch_run(arch: str, seed: int, dev, reduced=False) -> tuple[dict, dict]:
    """(a) One recsys arch at full width (``reduced``: its reduced config and
    cells, for a CPU rehearsal): ``launch.train``'s weights, batches and
    donating AdamW step (``data_for``; one warm-up and RECSYS_TRAIN_TIMED
    timed steps at the ``train_batch`` cell's batch and ``n_micro``), then
    the trained weights through ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` (the cells' callables), the top-k positions against
    a stable sort of the same scores.  Returns the line and the weights."""
    mod = configs.get(arch)
    cfg = mod.reduced_config() if reduced else mod.full_config()
    cells = configs.cells_of(arch)
    row = dict(arch=arch, params=cfg.num_params(), cuts=[])

    def values(name):
        c = cells[name]
        cut = {} if reduced else RECSYS_CUTS.get((arch, name), {})
        if cut:
            row["cuts"].append(dict(cell=name, **recsys_cut_bytes(arch, name, cfg, c.full, cut)))
        return c, dict(c.reduced if reduced else c.full, **cut)

    _peak_reset(dev)
    cell, p = values("train_batch")
    B, n_micro = p["batch"], p.get("n_micro", 1)
    t0 = time.perf_counter()
    it, loss_fn, params, _ = train_cli.data_for(cfg, B, mod.FAMILY, dev)
    _sync(dev)
    row["init_s"] = time.perf_counter() - t0
    row["param_bytes"] = sum(x.numel() * x.element_size() for x in train_tree.leaves(params))
    opt = train_opt.adamw(train_opt.AdamWConfig(
        schedule=train_opt.cosine_schedule(3e-4, 20, 1 + RECSYS_TRAIN_TIMED)))
    step = train_loop.make_train_step(loss_fn, opt, n_micro=n_micro, donate=True)
    opt_state = train_loop.init_opt_state(opt, params)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
               for _ in range(1 + RECSYS_TRAIN_TIMED)]
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    p50 = statistics.median(ms[1:])
    flops = cells_mod.recsys_flops(cfg, "train", p)
    row["train"] = dict(batch=B, n_micro=n_micro, warmup_ms=ms[0], step_ms=ms[1:],
                        step_p50_ms=p50, examples_per_s=B / p50 * 1e3, losses=losses,
                        model_flops=flops, model_tflops_per_s=flops / p50 / 1e9,
                        peak_device_bytes=_peak(dev))
    assert all(math.isfinite(x) for x in losses), row
    del opt_state, batches, step
    with torch.no_grad():
        for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
            _peak_reset(dev)
            cell, p = values(name)
            built = cells_mod.recsys_cell(arch, cfg, cell, p, dev, params=params)
            p50, times, out = wall_ms(lambda: built.fn(*built.args), dev, RECSYS_CALL_REPS)
            line = dict(values=p, p50_ms=p50, ms=times, peak_device_bytes=_peak(dev),
                        model_flops=built.model_flops)
            if cell.kind == "serve":
                assert out.shape == (p["batch"],) and bool(torch.isfinite(out).all()), name
                line["examples_per_s"] = p["batch"] / p50 * 1e3
            else:
                # the cell's top-k (stable_topk) against a stable sort of
                # one set of scores: on the card the wide part's segment
                # sums are atomic, so two passes differ in the last bits
                full = recsys.candidate_scores(params, cfg, built.args[1])
                scores, idx = scoring.stable_topk(full, p["top_k"])
                plain = torch.sort(full, descending=True, stable=True).indices[: p["top_k"]]
                line["topk_ids_identical"] = torch.equal(idx, plain)
                line["topk_scores_identical"] = torch.equal(scores, full[plain])
                assert line["topk_ids_identical"] and line["topk_scores_identical"], name
                assert out[1].shape == (p["top_k"],) and bool(torch.isfinite(out[0]).all()), name
                del full, plain, scores, idx
            row[name] = line
            del built, out
    return row, params


def recsys_card_vs_host(seed: int, dev) -> list[dict]:
    """One AdamW step (2 microbatches, f32) of each reduced recsys config
    on ``dev`` and on the host from the same weights and batch: the losses
    rtol 1e-5, the parameters rtol 1e-4 / atol 1e-6 (the card's gathers'
    backward and segment sums add with atomics, in no fixed order)."""
    rows = []
    for i, arch in enumerate(RECSYS_ARCHS):
        cfg = configs.get(arch).reduced_config()
        tree = recsys.numpy_params(recsys.init_params(cfg, torch.Generator().manual_seed(seed + i)))
        b = next(synthetic.recsys_batches(cfg, RECSYS_HOST_B, seed=seed + i))
        out = {}
        for d in (dev, torch.device("cpu")):
            opt = train_opt.adamw(train_opt.AdamWConfig(
                schedule=train_opt.cosine_schedule(1e-3, 2, 10)))
            prm = recsys.params_from_numpy(tree, d)
            step = train_loop.make_train_step(lambda p, bb: recsys.train_loss(p, cfg, bb), opt,
                                              n_micro=2)
            new, _, m = step(prm, train_loop.init_opt_state(opt, prm),
                             {k: torch.as_tensor(v, device=d) for k, v in b.items()})
            out[d.type] = (float(m["loss"]), train_tree.leaves(train_tree.to_numpy(new)))
        (card_loss, card_p), (host_loss, host_p) = out[dev.type], out["cpu"]
        d = np.concatenate([np.abs(a - w).ravel() for a, w in zip(card_p, host_p)])
        w = np.concatenate([np.abs(x).ravel() for x in host_p])
        row = dict(arch=arch, loss_card=card_loss, loss_host=host_loss,
                   loss_rel=abs(card_loss / host_loss - 1), max_param_abs_diff=float(d.max()),
                   outside=int((d > 1e-6 + 1e-4 * w).sum()), params=int(d.size))
        row["ok"] = bool(math.isfinite(card_loss) and row["loss_rel"] <= 1e-5
                         and row["outside"] == 0)
        rows.append(row)
    assert all(r["ok"] for r in rows), rows
    return rows


def _recall(got: torch.Tensor, want: torch.Tensor) -> float:
    """Mean share of each row of ``want`` (B, k) found in ``got``'s row."""
    return float((got[:, :, None] == want[:, None, :]).any(-1).float().mean())


def item_kernel_checks(index, qn, dev) -> dict:
    """K1 at stage 2's shape and K2 at stage 4's for one item-index batch
    (nq = 1, d = 64, one token a document), bit for bit against their
    plain versions, timed as phase kernels times them (these launches are
    not counted)."""
    p = plaid.clamp_params(item_retrieval.item_search_params(ITEM_K, 8, 4096, "cuda"),
                           index.num_passages)
    qb = qn[:, None, :].contiguous()
    return path_kernel_checks(index, qb, torch.ones(qb.shape[:2], device=dev), p, dev)


def path_kernel_checks(index, qb, qm, p, dev) -> dict:
    """K1 at stage 2's shape and K2 at stage 4's for one batch of the
    unfused path at params ``p``, bit for bit against their plain
    versions, with their bounds (``kernels.costs``) and, on the card, their
    times (these launches are not counted)."""
    s_cq = pipeline.stage1_scores_batched(index, qb)
    cands = pipeline.candidate_generation_batched(index, s_cq, p.nprobe, p.candidate_cap)
    keep = scoring.prune_mask(s_cq, p.t_cs)
    codes_blk, _ = pipeline.gather_candidate_tokens_shared(index, cands)
    final_pids, codes4, valid4, _ = pipeline.select_finalists_impl(index, qb, qm, p.t_cs,
                                                                   params=p)
    res4, _ = scoring.gather_doc_tokens(index.residuals, index.doc_offsets, index.doc_lens,
                                        final_pids.reshape(-1), index.doc_maxlen, fill=0)
    res4 = res4.reshape(*codes4.shape, -1)
    nbits, d, nq = index.nbits, index.dim, qb.shape[1]
    cases = {
        "centroid_interaction_batched": (
            lambda: ops.centroid_interaction_batched(s_cq, codes_blk, qm, keep),
            lambda: ref.centroid_interaction_batched_ref(s_cq, codes_blk, keep, qm),
            k1_bound(s_cq, codes_blk, keep),
            dict(B=qb.shape[0], nq=nq, nd=codes_blk.shape[1], L=codes_blk.shape[2],
                 K=s_cq.shape[1])),
        "decompress_and_score_batched": (
            lambda: ops.decompress_and_score_batched(qb, qm, codes4, res4, valid4,
                                                     index.centroids, index.weights, nbits=nbits),
            lambda: ref.decompress_and_score_batched_ref(qb, qm, codes4, res4, valid4,
                                                         index.centroids, index.weights,
                                                         nbits=nbits),
            k2_bound(codes4, valid4, nq, d, res4.shape[-1], index.num_centroids),
            dict(B=qb.shape[0], nq=nq, d=d, nd=codes4.shape[1], L=codes4.shape[2],
                 pd=res4.shape[-1])),
    }
    out = {}
    for name, (kern, plain, (bound_ms, bound_by), shp) in cases.items():
        got, want = kern(), plain()
        _sync(dev)
        out[name] = dict(equal=torch.equal(got, want),
                         max_abs_err=float((got - want).abs().max()), bound_ms=bound_ms,
                         bound_by=bound_by, shape=shp)
        if dev.type == "cuda":
            out[name].update(ms=time_ms(kern, reps=25), device_ms=device_time_ms(kern, reps=25),
                             plain_ms=time_ms(plain, reps=3, warmup=1))
        assert out[name]["equal"], (name, out[name])
    return out


def item_index_run(params, cfg, seed: int, dev) -> tuple[dict, dict, dict]:
    """(b) PLAID as an item index over BERT4Rec's item table (V + 2 rows):
    the build, ITEM_USERS user states (the encoder's last position over
    seeded sequences) at k = ITEM_K, ``impl="cuda"`` against ``"ref"``
    (pids and scores identical), recall@k against brute force over the
    reconstructed and the exact embeddings, p50 ms and K1 / K2's launches a
    batch.  Returns the line, the K1/K2 launches of its cuda batches and
    the kernels' checks at these shapes."""
    items = params["items"]
    _peak_reset(dev)
    t0 = time.perf_counter()
    index = item_retrieval.build_item_index(items, seed=seed, device=dev)
    _sync(dev)
    row = dict(items=index.num_passages, dim=index.dim, nbits=index.nbits,
               centroids=index.num_centroids, build_s=time.perf_counter() - t0,
               index_bytes=sum(index.nbytes().values()), build_peak_device_bytes=_peak(dev))
    b = next(synthetic.recsys_batches(cfg, ITEM_USERS, seed=seed))
    with torch.no_grad():
        users = recsys.seq_encode(params, cfg, torch.as_tensor(b["seq_ids"], device=dev))[:, -1]
    users = users.contiguous()
    search = lambda impl, **kw: item_retrieval.retrieve_items(  # noqa: E731
        index, users, k=ITEM_K, impl=impl, **kw)
    ops.reset_launch_counts()
    got_s, got_p = search("cuda")
    _sync(dev)
    row["launches_a_batch"] = {k: v for k, v in ops.launch_counts().items() if v}
    p50, times, _ = wall_ms(lambda: search("cuda"), dev, RECSYS_CALL_REPS)
    wide_s, wide_p = search("cuda", **ITEM_WIDE)
    _sync(dev)
    counts = ops.launch_counts()
    ref_p50, _, (want_s, want_p) = wall_ms(lambda: search("ref"), dev, 2)
    wide_ref = search("ref", **ITEM_WIDE)
    row.update(users=ITEM_USERS, k=ITEM_K, nprobe=8, candidate_cap=4096, p50_ms=p50, ms=times,
               ref_p50_ms=ref_p50,
               pids_identical=torch.equal(got_p, want_p), scores_identical=torch.equal(got_s, want_s),
               wide=dict(ITEM_WIDE, pids_identical=torch.equal(wide_p, wide_ref[1]),
                         scores_identical=torch.equal(wide_s, wide_ref[0])))
    qn = users / users.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    with ieee_f32_matmul():
        recon = index.reconstruct_tokens(torch.arange(index.num_tokens, device=dev))
        brute_c = torch.topk(qn @ recon.t(), ITEM_K, dim=1).indices
        del recon
        exact = items / items.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        brute_x = torch.topk(qn @ exact.t(), ITEM_K, dim=1).indices
        del exact
    row["recall_at_k"] = dict(reconstructed=_recall(got_p, brute_c), exact=_recall(got_p, brute_x))
    row["wide"]["recall_at_k"] = dict(reconstructed=_recall(wide_p, brute_c),
                                      exact=_recall(wide_p, brute_x))
    row["peak_device_bytes"] = _peak(dev)
    assert row["pids_identical"] and row["scores_identical"], row
    assert row["wide"]["pids_identical"] and row["wide"]["scores_identical"], row
    assert got_p.shape == (ITEM_USERS, ITEM_K) and bool(torch.isfinite(got_s).all()), row
    checks = item_kernel_checks(index, qn, dev)
    row["kernel_checks"] = checks
    del index
    return row, {k: counts[k] for k in SEARCH_KERNELS[:2]}, checks


def gnn_block_job(path: str, reduced: bool) -> None:
    """The ``minibatch_lg`` cell's host sampler, run in a process of its own
    from the start of the script: the seeded graph (``random_graph``), the
    fanout block around nodes 0..batch_nodes-1 (``neighbor_sample``) and
    the cell's batch (``cells.gnn_batch``), saved to ``path`` (.npz) with
    the generator's and the sampler's seconds."""
    cell = configs.cells_of("schnet")["minibatch_lg"]
    p = cell.reduced if reduced else cell.full
    t0 = time.perf_counter()
    g = graphs.random_graph(p["n_nodes"], p["n_edges"], p["d_feat"], p["n_classes"])
    t1 = time.perf_counter()
    blk = graphs.neighbor_sample(g, np.arange(p["batch_nodes"]), tuple(p["fanout"]))
    t2 = time.perf_counter()
    batch = cells_mod.gnn_batch("minibatch", p, graph=g, block=blk)
    np.savez(path, **batch, _graph_s=t1 - t0, _sample_s=t2 - t1,
             _real_nodes=blk["n_real_nodes"], _real_edges=blk["n_real_edges"])


def start_gnn_block(reduced: bool = False):
    """Start :func:`gnn_block_job` in a spawned process; returns (process,
    path).  Its directory is removed when the script exits."""
    import atexit
    import multiprocessing
    import shutil

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gnn_")
    atexit.register(shutil.rmtree, tmp, True)
    path = os.path.join(tmp, "minibatch_lg.npz")
    proc = multiprocessing.get_context("spawn").Process(target=gnn_block_job,
                                                        args=(path, reduced), daemon=True)
    proc.start()
    return proc, path


def schnet_run(name: str, dev, batch=None, reduced=False) -> dict:
    """(c) One SchNet cell at full width (``reduced``: its reduced values):
    the cell's donating AdamW step on its seeded weights, one warm-up and
    GNN_TIMED timed steps, step ms, model FLOPs and peak bytes."""
    cell = configs.cells_of("schnet")[name]
    base = configs.get("schnet").reduced_config() if reduced else configs.get("schnet").full_config()
    p = cell.reduced if reduced else cell.full
    cfg, N, E = cells_mod.gnn_shape(base, cell.kind, p)
    _peak_reset(dev)
    built = cells_mod.gnn_cell("schnet", base, cell, p, dev, batch=batch)
    params, opt_state, b = built.args
    losses, ms = [], []
    for _ in range(1 + GNN_TIMED):
        t0 = time.perf_counter()
        params, opt_state, m = built.fn(params, opt_state, b)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    p50 = statistics.median(ms[1:])
    row = dict(cell=name, kind=cell.kind, values=p, nodes=N, edges=E, params=cfg.num_params(),
               warmup_ms=ms[0], step_ms=ms[1:], step_p50_ms=p50, losses=losses,
               model_flops=built.model_flops, model_tflops_per_s=built.model_flops / p50 / 1e9,
               peak_device_bytes=_peak(dev))
    assert all(math.isfinite(x) for x in losses), row
    return row


def schnet_skip_line(reduced=False) -> dict:
    """Why ``ogb_products`` does not run on one card: its (E, n_rbf) f32
    radial basis alone, before the filter MLP's (E, d) activations."""
    cfg = configs.get("schnet").full_config()
    p = configs.cells_of("schnet")[SCHNET_SKIP].full
    rbf = p["n_edges"] * cfg.n_rbf * 4
    return dict(cell=SCHNET_SKIP, skipped=True, edges=p["n_edges"], n_rbf=cfg.n_rbf,
                rbf_bytes=rbf, per_edge_activation_bytes=p["n_edges"] * cfg.d_hidden * 4,
                card_bytes=80e9, reason=f"the (E, n_rbf) f32 radial basis alone is "
                f"{p['n_edges']:,} x {cfg.n_rbf} x 4 = {rbf / 1e9:.1f} GB")


def recsys_phase(seed, dev, info: dict, gnn_job, reduced=False) -> tuple[dict, dict]:
    """Phase recsys (see the module docstring, 19): (a) the four recsys
    archs and card against host, (b) the item index over BERT4Rec's table,
    (c) SchNet's cells; one ``recsys`` line a run.  Returns K1/K2's
    launches on (b)'s path and their checks at its shapes."""
    t_phase = time.perf_counter()
    params = None
    for i, arch in enumerate(RECSYS_ARCHS):
        del params
        t0 = time.perf_counter()
        row, params = recsys_arch_run(arch, seed + 101 + i, dev, reduced)
        row["seconds"] = time.perf_counter() - t0
        emit({"recsys": row, "card": info["card"]})
    t0 = time.perf_counter()
    info["card_vs_host"] = recsys_card_vs_host(seed + 111, dev)
    info["card_vs_host_s"] = time.perf_counter() - t0
    cfg = configs.get("bert4rec").reduced_config() if reduced else configs.get(
        "bert4rec").full_config()
    t0 = time.perf_counter()
    row, launches, checks = item_index_run(params, cfg, seed + 121, dev)
    row["seconds"] = time.perf_counter() - t0
    emit({"recsys": dict(run="item_index", **row), "card": info["card"]})
    del params
    proc, path = gnn_job
    t0 = time.perf_counter()
    proc.join(timeout=600)
    info["gnn_block_wait_s"] = time.perf_counter() - t0
    assert proc.exitcode == 0, f"the minibatch_lg sampler exited with {proc.exitcode}"
    with np.load(path) as z:
        block = {k: z[k] for k in z.files if not k.startswith("_")}
        sampler = {k[1:]: z[k].item() for k in z.files if k.startswith("_")}
    for name in GNN_RUNS:
        t0 = time.perf_counter()
        row = schnet_run(name, dev, block if name == "minibatch_lg" else None, reduced)
        if name == "minibatch_lg":
            row["host_sampler"] = sampler
        row["seconds"] = time.perf_counter() - t0
        emit({"recsys": dict(run="schnet", **row), "card": info["card"]})
    emit({"recsys": dict(run="schnet", **schnet_skip_line()), "card": info["card"]})
    info["runs"] = list(RECSYS_ARCHS) + ["card_vs_host", "item_index"] + list(GNN_RUNS)
    info["launches"] = launches
    info["in_phase_s"] = time.perf_counter() - t_phase
    if dev.type == "cuda":
        assert all(v > 0 for v in launches.values()), launches
    return launches, checks


# --------------------------------------------------------------------------
# phase cells: the retrieval family's cells at full width, the dry sweep
# --------------------------------------------------------------------------
CELLS_ARCH = "plaid-colbertv2"
CELLS_TRAIN_TIMED, CELLS_ENCODE_REPS, CELLS_SEARCH_REPS = 2, 3, 5
#: the dry sweep's processes and its time limit
DRYRUN_JOBS, DRYRUN_LIMIT_S = 8, 60.0


def cells_values(name: str, reduced: bool) -> tuple:
    """A retrieval cell, its config (full, or reduced for a CPU rehearsal)
    and its values."""
    mod = configs.get(CELLS_ARCH)
    cell = configs.cells_of(CELLS_ARCH)[name]
    if reduced:
        return cell, mod.reduced_config(), cell.reduced
    return cell, mod.full_config(), cell.full


def cells_train_run(dev, reduced=False) -> dict:
    """``train_triples`` through its cell's donating step: a warm-up and
    CELLS_TRAIN_TIMED timed steps on the cell's batch (B 256 = 8
    microbatches of 32 triples, 24,064 tokens each); step ms, tokens/s, mfu
    against the bf16 peak with the cell's model FLOPs, peak bytes."""
    cell, cfg, p = cells_values("train_triples", reduced)
    _peak_reset(dev)
    t0 = time.perf_counter()
    built = cells_mod.retrieval_cell(CELLS_ARCH, cfg, cell, p, dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    params, opt_state, batch = built.args
    ms, losses = [], []
    for _ in range(1 + CELLS_TRAIN_TIMED):
        t0 = time.perf_counter()
        params, opt_state, m = built.fn(params, opt_state, batch)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    p50 = statistics.median(ms[1:])
    tokens = p["global_batch"] * (p["q_len"] + p["nway"] * p["d_len"])
    row = dict(cell="train_triples", values=p, init_s=init_s, warmup_ms=ms[0], step_ms=ms[1:],
               step_p50_ms=p50, tokens_a_step=tokens, tokens_per_s=tokens / p50 * 1e3,
               model_flops=built.model_flops,
               mfu=built.model_flops / (p50 / 1e3) / BF16_FLOPS, losses=losses,
               peak_device_bytes=_peak(dev))
    assert all(math.isfinite(x) for x in losses), row
    return row


def cells_encode_run(dev, g, reduced=False) -> tuple[dict, int, dict]:
    """``encode_corpus`` through its cell (K7, bf16): p50 of
    CELLS_ENCODE_REPS encodes after a warm-up, tokens/s, peak bytes, K7's
    launches an encode; then K7 at this shape against its plain version
    (``flash_check``, FLASH_TOL).  Returns the line, K7's launches on the
    cell's path and the check."""
    cell, cfg, p = cells_values("encode_corpus", reduced)
    _peak_reset(dev)
    built = cells_mod.retrieval_cell(CELLS_ARCH, cfg, cell, p, dev)
    ops.reset_launch_counts()
    p50, times, out = wall_ms(lambda: built.fn(*built.args), dev, CELLS_ENCODE_REPS)
    launches = ops.launch_counts()["flash_attention"]
    B, S = p["batch"], p["d_len"]
    assert out.shape == (B, S, cfg.out_dim) and bool(torch.isfinite(out).all())
    row = dict(cell="encode_corpus", values=p, p50_ms=p50, ms=times,
               tokens_per_s=B * S / p50 * 1e3, model_flops=built.model_flops,
               mfu=built.model_flops / (p50 / 1e3) / BF16_FLOPS,
               k7_launches_an_encode=launches / (1 + CELLS_ENCODE_REPS),
               peak_device_bytes=_peak(dev))
    del built, out
    bb = cfg.backbone
    check = flash_check("encode_corpus", B, S, bb.padded_heads, bb.n_kv_heads, bb.d_head,
                        bb.causal, bb.dtype, g, timed=dev.type == "cuda", reps=5)
    row["k7_check"] = {k: check[k] for k in ("max_abs_err", "ok", "tol") if k in check}
    return row, launches, check


def search_corpus_job(path: str, reduced: bool) -> None:
    """The ``search_140m`` cell's corpus and queries (``cells.
    search_corpus``: 273,438 passages, ~9.8M tokens of the reference's
    per-passage numpy draws, ~55 s on one host core), drawn in a process of
    its own from the script's start and saved under ``path`` (.npy) with
    the draw's seconds."""
    _, _, p = cells_values("search_140m", reduced)
    t0 = time.perf_counter()
    for name, a in zip(("packed", "lens", "qs"), cells_mod.search_corpus(p)):
        np.save(os.path.join(path, f"{name}.npy"), a)
    np.save(os.path.join(path, "seconds.npy"), np.float64(time.perf_counter() - t0))


def start_search_corpus(reduced: bool = False):
    """Start :func:`search_corpus_job` in a spawned process; returns
    (process, directory).  The directory is removed when the script
    exits."""
    import atexit
    import multiprocessing
    import shutil

    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    atexit.register(shutil.rmtree, tmp, True)
    proc = multiprocessing.get_context("spawn").Process(target=search_corpus_job,
                                                        args=(tmp, reduced), daemon=True)
    proc.start()
    return proc, tmp


def load_search_corpus(job) -> tuple[tuple, dict]:
    """Wait for :func:`start_search_corpus`'s process; its arrays and
    (wait, draw) seconds."""
    proc, path = job
    t0 = time.perf_counter()
    proc.join(timeout=900)
    wait = time.perf_counter() - t0
    assert proc.exitcode == 0, f"the search corpus process exited with {proc.exitcode}"
    arrays = tuple(np.load(os.path.join(path, f"{n}.npy")) for n in ("packed", "lens", "qs"))
    return arrays, dict(wait_s=wait, draw_s=float(np.load(os.path.join(path, "seconds.npy"))))


def cells_search_run(name: str, dev, reduced=False, corpus_job=None) -> tuple[dict, dict, dict]:
    """One search cell at the cell's widths: its index built as the
    reference builds it (one shard), its queries through the cell's
    ``impl="cuda"`` search (K1 at stages 2 and 3, K2 at stage 4) and
    through ``impl="ref"`` on the same card, pids and scores identical;
    build s, p50 ms, launches a batch; K1 and K2 at these shapes against
    their plain versions.  ``corpus_job``: the cell's corpus drawn in a
    process of its own (:func:`start_search_corpus`), else drawn here.
    Returns the line, K1/K2's launches on the cell's path and the checks."""
    cell, cfg, p = cells_values(name, reduced)
    corpus, corpus_s = (None, None) if corpus_job is None else load_search_corpus(corpus_job)
    _peak_reset(dev)
    t0 = time.perf_counter()
    index, qs = cells_mod.search_index(p, dev, corpus=corpus)
    del corpus
    _sync(dev)
    build_s = time.perf_counter() - t0
    got_cell = cells_mod.retrieval_cell(CELLS_ARCH, cfg, cell, p, dev, index=(index, qs))
    want_cell = cells_mod.retrieval_cell(CELLS_ARCH, cfg, cell, p, dev, index=(index, qs),
                                         impl="ref")
    ops.reset_launch_counts()
    got_s, got_p = got_cell.fn(*got_cell.args)
    _sync(dev)
    per_batch = {k: v for k, v in ops.launch_counts().items() if v}
    p50, times, _ = wall_ms(lambda: got_cell.fn(*got_cell.args), dev, CELLS_SEARCH_REPS,
                            warmup=0)
    counts = ops.launch_counts()
    ref_p50, _, (want_s, want_p) = wall_ms(lambda: want_cell.fn(*want_cell.args), dev, 2)
    qs, qm = got_cell.args[1:]
    row = dict(cell=name, values=p, passages=index.num_passages, tokens=index.num_tokens,
               centroids=index.num_centroids, nbits=index.nbits,
               index_bytes=sum(index.nbytes().values()), build_s=build_s,
               corpus_process=corpus_s,
               queries=qs.shape[0], q_len=qs.shape[1], p50_ms=p50, ms=times, ref_p50_ms=ref_p50,
               launches_a_batch=per_batch, pids_identical=torch.equal(got_p, want_p),
               scores_identical=torch.equal(got_s, want_s), model_flops=got_cell.model_flops,
               peak_device_bytes=_peak(dev))
    assert row["pids_identical"] and row["scores_identical"], row
    assert got_p.shape == (p["n_queries"], p["k"]) and bool(torch.isfinite(got_s).all()), row
    sp = cells_mod.clamped_search_params(p, "cuda", index.num_passages)
    checks = path_kernel_checks(index, qs, qm, sp, dev)
    row["kernel_checks"] = checks
    del index, got_cell, want_cell
    return row, {k: counts[k] for k in SEARCH_KERNELS[:2]}, checks


def cells_dry_sweep(info: dict) -> dict:
    """(b) ``launch.dryrun --all --both-meshes`` in a subprocess that sees
    no card, within DRYRUN_LIMIT_S: the tally of ok / skip / fail, each
    fail with its ROADMAP item, and yi-34b train_4k's per-rank bytes (what
    the port's rank holds beside the rules' plan).  Fails when a record
    is neither ok nor skip."""
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dry_")) / "dry.jsonl"
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    jobs = min(DRYRUN_JOBS, os.cpu_count() or 1)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                           "--both-meshes", "--jobs", str(jobs), "--out", str(out)],
                          env=env, capture_output=True, text=True, timeout=4 * DRYRUN_LIMIT_S)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    out.unlink()
    out.parent.rmdir()
    tally = collections.Counter(r["status"] for r in recs)
    fails = [dict(arch=r["arch"], shape=r["shape"], mesh=r["mesh"], item=r["item"],
                  error=r["error"][:160]) for r in recs if r["status"] == "fail"]
    yi = {r["mesh"]: dict(mem_args=r["mem_args"], mem_args_plan=r["mem_args_plan"],
                          mem_temp=r["mem_temp"], dominant=r["dominant"])
          for r in recs if r["arch"] == "yi-34b" and r["shape"] == "train_4k"}
    line = dict(records=len(recs), jobs=jobs, seconds=seconds, tally=dict(tally), fails=fails,
                yi_34b_train_4k=yi,
                lm_train_bytes={f"{r['arch']}|{r['mesh']}": [r.get("mem_args"),
                                                             r.get("mem_args_plan")]
                                for r in recs if r["kind"] == "train" and r["status"] == "ok"})
    emit({"dry_sweep": line, "card": info["card"]})
    assert not fails, fails
    assert len(recs) == 2 * sum(len(configs.cells_of(a)) for a in configs.ARCH_IDS), len(recs)
    assert seconds <= DRYRUN_LIMIT_S, seconds
    return line


def cells_phase(seed, dev, info: dict, corpus_job, reduced=False) -> tuple[dict, dict]:
    """Phase cells (see the module docstring, 20): (a) the retrieval
    family's four cells at full width on the card, one ``cells`` line
    each; (b) the dry sweep.  Returns the launches of K1, K2 and K7 on the
    cells' paths, and the kernels' checks at the cells' shapes."""
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 131)
    row = cells_train_run(dev, reduced)
    emit({"cells": row, "card": info["card"]})
    row, k7, k7_check = cells_encode_run(dev, g, reduced)
    emit({"cells": row, "card": info["card"]})
    launches = {"flash_attention": k7}
    checks = {}
    for name, job in (("search_9m", None), ("search_140m", corpus_job)):
        row, counts, chk = cells_search_run(name, dev, reduced, job)
        emit({"cells": row, "card": info["card"]})
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        for k, v in chk.items():
            checks.setdefault(k, {})[name] = v
    info["a_s"] = time.perf_counter() - t_phase
    info["dry_sweep"] = cells_dry_sweep(info)
    info["launches"] = launches
    info["in_phase_s"] = time.perf_counter() - t_phase
    if dev.type == "cuda":
        assert all(v > 0 for v in launches.values()), launches
    checks["flash_attention"] = {"encode_corpus": {
        k: k7_check.get(k) for k in ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by")}}
    return launches, checks


# --------------------------------------------------------------------------
# phase family_mesh: the recsys family and SchNet over two processes
# --------------------------------------------------------------------------
#: two gloo ranks on one card, a 1 x FAMILY_MESH_MODEL ("data", "model")
#: mesh; the values the ranks and the one-process run take beside the
#: recsys phase's memory cuts (RECSYS_CUTS): FAMILY_MESH_CUTS, each with
#: its reason (every collective crosses the host under gloo; two ranks
#: share the card's memory); one warm-up and
#: FAMILY_MESH_TIMED timed train steps; the bars: losses LM_TP_LOSS_RTOL,
#: the stepped weights FAMILY_MESH_PARAM_TOL, scores FAMILY_MESH_SCORE_RTOL
FAMILY_MESH_MODEL = 2
_HOST = "time: the ranks' collectives cross the host (gloo)"
FAMILY_MESH_CUTS = {
    ("wide-deep", "train_batch"): (dict(batch=16384), _HOST),
    ("xdeepfm", "train_batch"): (dict(batch=16384), _HOST),
    ("bst", "train_batch"): (dict(batch=16384), _HOST),
    ("wide-deep", "retrieval_cand"): (dict(n_candidates=65536), _HOST),
    ("bst", "retrieval_cand"): (dict(n_candidates=65536), _HOST),
    # each rank builds the whole (B, 200, 39, 10) f32 CIN product: 20 GB a
    # rank at 65,536, beside the other rank's on the same card
    ("xdeepfm", "retrieval_cand"): (dict(n_candidates=32768), "memory: two ranks on one card"),
}
FAMILY_MESH_TIMED, FAMILY_MESH_CALL_REPS = 2, 2
FAMILY_MESH_PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
#: the share of a run's weights allowed outside FAMILY_MESH_PARAM_TOL, each
#: within adam_flip_bound (where a gradient element is within a few eps of
#: 0, the last bits of the ranks' partial sums turn AdamW's step), as
#: tests/test_torch_tensor_parallel.py holds the LM ranks
FAMILY_MESH_OUTLIER_SHARE = 1e-3
FAMILY_MESH_SCORE_RTOL = 1e-5
FAMILY_MESH_CELLS = ("train_batch", "serve_p99", "retrieval_cand")


def family_values(arch: str, name: str, reduced: bool) -> tuple:
    """A recsys cell, its values (reduced, or full with the memory cut and
    then the time cut where they bind: the smaller value wins) and the
    cuts applied ``[(value, full, cut, reason)]``."""
    cell = configs.cells_of(arch)[name]
    if reduced:
        return cell, dict(cell.reduced), []
    p, cuts = dict(cell.full), []
    for cut, what in ((RECSYS_CUTS.get((arch, name), {}), "memory (RECSYS_CUTS)"),
                      FAMILY_MESH_CUTS.get((arch, name), ({}, None))):
        for k, v in cut.items():
            if v < p[k]:
                cuts.append((k, cell.full[k], v, what))
                p[k] = v
    return cell, p, cuts


def _within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> tuple[int, float]:
    """(elements outside ``atol + rtol |want|``, max |got - want|)."""
    d = (got.float() - want.float()).abs()
    return int((d > atol + rtol * want.float().abs()).sum()), float(d.max()) if d.numel() else 0.0


def adam_flip_bound(steps: int) -> float:
    """The most ``steps`` AdamW steps of a cell (``cells.DEFAULT_SCHEDULE``,
    AdamWConfig's b1 / b2) can move one weight apart in two runs whose
    gradients for it differ near 0: twice each step's lr times the largest
    |m^ / sqrt(v^)| that step can give (Cauchy-Schwarz over the moments'
    weights; 1 at the first step, 1.0012 by the third)."""
    cfg, lr = train_opt.AdamWConfig(), train_opt.cosine_schedule(*cells_mod.DEFAULT_SCHEDULE)
    b1, b2 = cfg.b1, cfg.b2
    out = 0.0
    for t in range(1, steps + 1):
        s = sum((b1 * b1 / b2) ** k for k in range(t))
        r = (1 - b1) / math.sqrt(1 - b2) * math.sqrt(s * (1 - b2**t)) / (1 - b1**t)
        out += 2 * float(lr(torch.tensor(t))) * r
    return out


def params_agree(outside: int, held: int, worst: float, steps: int) -> bool:
    """At most FAMILY_MESH_OUTLIER_SHARE of ``held`` weights outside
    FAMILY_MESH_PARAM_TOL, and none further than ``adam_flip_bound``."""
    return (outside <= FAMILY_MESH_OUTLIER_SHARE * held
            and worst <= adam_flip_bound(steps) + FAMILY_MESH_PARAM_TOL["atol"])


def family_recsys_run(arch: str, seed: int, dev, tmp: str, reduced: bool, mesh=None) -> dict:
    """(a) One recsys arch: the cells' own callables (``cells.recsys_cell``)
    on seeded weights drawn whole on ``dev``: ``train_batch`` (one warm-up
    and FAMILY_MESH_TIMED timed steps of the same batch), ``serve_p99`` and
    ``retrieval_cand`` (these two on the weights as drawn).  Without
    ``mesh`` (the one-process run) the stepped weights are saved whole to
    ``{tmp}/{arch}/`` (.npy a leaf); with it each process holds its pieces
    and holds them to those files."""
    mod = configs.get(arch)
    cfg = mod.reduced_config() if reduced else mod.full_config()
    rec = dict(arch=arch, cuts=[])
    _peak_reset(dev)
    whole = recsys.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    rec["param_bytes"] = sum(x.numel() * x.element_size() for x in train_tree.leaves(whole))
    built = {}
    for name in FAMILY_MESH_CELLS:
        cell, p, cuts = family_values(arch, name, reduced)
        rec["cuts"] += [dict(cell=name, value=k, full=f, cut=c, reason=r) for k, f, c, r in cuts]
        # the train step donates its weights: it would step the leaves the
        # serving cells share with it (every leaf that is not split)
        prm = train_tree.tree_map(torch.clone, whole) if name == "train_batch" else whole
        built[name] = (cells_mod.recsys_cell(arch, cfg, cell, p, dev, params=prm, mesh=mesh), p)
        del prm
    del whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    train, p = built.pop("train_batch")
    params, opt_state, batch = train.args
    rec["held_param_bytes"] = sum(x.numel() * x.element_size() for x in train_tree.leaves(params))
    losses, ms = [], []
    for _ in range(1 + FAMILY_MESH_TIMED):
        t0 = time.perf_counter()
        params, opt_state, m = train.fn(params, opt_state, batch)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    p50 = statistics.median(ms[1:])
    rec["train"] = dict(batch=p["batch"], n_micro=p.get("n_micro", 1), losses=losses,
                        warmup_ms=ms[0], step_ms=ms[1:], step_p50_ms=p50,
                        examples_per_s=p["batch"] / p50 * 1e3, peak_device_bytes=_peak(dev))
    assert all(math.isfinite(x) for x in losses), rec
    place = None
    if mesh is not None:
        with sharding.use_mesh(mesh):
            place = train_tree.leaves(recsys.placements(cfg))
    rec["train"].update(hold_to_saved(train_tree.leaves(params), Path(tmp) / arch, place, dev))
    del params, opt_state, batch, train
    with torch.no_grad():
        for name, (b, p) in built.items():
            _peak_reset(dev)
            p50, times, out = wall_ms(lambda: b.fn(*b.args), dev, FAMILY_MESH_CALL_REPS)
            row = dict(values=p, p50_ms=p50, ms=times, peak_device_bytes=_peak(dev))
            if name == "serve_p99":
                row["scores"] = out.cpu()
                row["examples_per_s"] = p["batch"] / p50 * 1e3
            else:
                row["topk_scores"], row["topk_ids"] = out[0].cpu(), out[1].cpu()
            rec[name] = row
            del out
    del built
    return rec


def family_gnn_run(name: str, dev, block, reduced: bool, mesh=None) -> dict:
    """(b) One SchNet cell through its own donating step (``cells.gnn_cell``)
    on seeded weights: one step, its loss and the stepped weights (host),
    step ms and peak bytes; with ``mesh`` the edges split over it."""
    cell = configs.cells_of("schnet")[name]
    base = configs.get("schnet").reduced_config() if reduced else configs.get("schnet").full_config()
    p = cell.reduced if reduced else cell.full
    _peak_reset(dev)
    built = cells_mod.gnn_cell("schnet", base, cell, p, dev,
                               batch=block if name == "minibatch_lg" else None, mesh=mesh)
    t0 = time.perf_counter()
    params, _, m = built.fn(*built.args)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    _, N, E = cells_mod.gnn_shape(base, cell.kind, p)
    rec = dict(cell=name, nodes=N, edges=E, loss=float(m["loss"]), step_ms=ms,
               params=[x.cpu() for x in train_tree.leaves(params)], peak_device_bytes=_peak(dev))
    if mesh is not None:
        with sharding.use_mesh(mesh):
            rec["edge_shards"] = schnet.edge_mesh().world_size
    assert math.isfinite(rec["loss"]), rec
    del built, params
    return rec


def family_mesh_rank(rank: int, tmp: str, seed: int, device: str, block_path, reduced: bool) -> None:
    """One of two ranks sharing ``device`` over gloo on a 1 x
    FAMILY_MESH_MODEL mesh: (a) and (b) as the one-process run ran them,
    every collective timed; writes ``{tmp}/rank{r}.pt``."""
    mesh_mod.init_distributed(f"file://{tmp}/rendezvous", FAMILY_MESH_MODEL, rank, backend="gloo")
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = mesh_mod.make_production_mesh(device=device, model=FAMILY_MESH_MODEL)
        assert mesh.shape == {"data": 1, "model": FAMILY_MESH_MODEL} and mesh.devices == (dev,)
        wire = spy_collectives(dev)
        block = None
        if block_path is not None:
            with np.load(block_path) as z:
                block = {k: z[k] for k in z.files if not k.startswith("_")}
        out = {}
        runs = [(arch, lambda arch=arch, i=i: family_recsys_run(arch, seed + 141 + i, dev, tmp,
                                                                 reduced, mesh))
                for i, arch in enumerate(RECSYS_ARCHS)]
        runs += [(name, lambda name=name: family_gnn_run(name, dev, block, reduced, mesh))
                 for name in GNN_RUNS]
        for name, run in runs:
            n, t0 = len(wire), time.perf_counter()
            out[name] = dict(run(), wire=wire[n:], seconds=time.perf_counter() - t0)
            print(json.dumps({"family_mesh_rank": rank, "run": name,
                              "seconds": out[name]["seconds"]}), flush=True)
        torch.save(out, f"{tmp}/rank{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def topk_agree(got_ids, want_ids, want_scores, rtol: float) -> bool:
    """Top-k positions identical wherever the one-process run's neighbouring
    scores differ by more than ``rtol`` relative (a near tie may swap)."""
    gap = (want_scores[1:] - want_scores[:-1]).abs() > rtol * want_scores[:-1].abs()
    firm = torch.ones_like(want_ids, dtype=torch.bool)
    firm[1:] &= gap
    firm[:-1] &= gap
    return bool(torch.equal(got_ids[firm], want_ids[firm]))


def family_mesh_phase(seed, dev, info: dict, block_path, reduced=False) -> None:
    """Phase family_mesh (see the module docstring, 21): the one-process
    runs, then the two ranks, then the checks; one ``family_mesh`` line a
    run.  Launches no port kernel."""
    t_phase = time.perf_counter()
    block = None
    if block_path is not None:
        with np.load(block_path) as z:
            block = {k: z[k] for k in z.files if not k.startswith("_")}
    with tempfile.TemporaryDirectory() as tmp:
        one = {}
        for i, arch in enumerate(RECSYS_ARCHS):
            t0 = time.perf_counter()
            one[arch] = family_recsys_run(arch, seed + 141 + i, dev, tmp, reduced)
            one[arch]["seconds"] = time.perf_counter() - t0
        for name in GNN_RUNS:
            t0 = time.perf_counter()
            one[name] = family_gnn_run(name, dev, block, reduced)
            one[name]["seconds"] = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        info["one_process_s"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        ranks = spawn_gloo_ranks(tmp, family_mesh_rank, seed, str(dev), block_path, reduced,
                                 n=FAMILY_MESH_MODEL)
        info["ranks_s"] = time.perf_counter() - t0
    mesh = {"data": 1, "model": FAMILY_MESH_MODEL}
    for arch in RECSYS_ARCHS:
        o, recs = one[arch], [r[arch] for r in ranks]
        rels = [max(abs(a / b - 1) for a, b in zip(r["train"]["losses"], o["train"]["losses"]))
                for r in recs]
        serve = [_within(r["serve_p99"]["scores"], o["serve_p99"]["scores"],
                         FAMILY_MESH_SCORE_RTOL, 0.0) for r in recs]
        ret = [dict(ids=topk_agree(r["retrieval_cand"]["topk_ids"], o["retrieval_cand"]["topk_ids"],
                                   o["retrieval_cand"]["topk_scores"], FAMILY_MESH_SCORE_RTOL),
                    scores=_within(r["retrieval_cand"]["topk_scores"],
                                   o["retrieval_cand"]["topk_scores"], FAMILY_MESH_SCORE_RTOL,
                                   0.0)) for r in recs]
        line = dict(
            arch=arch, mesh=mesh, cuts=o["cuts"], param_bytes=o["param_bytes"],
            held_param_bytes=[r["held_param_bytes"] for r in recs],
            train=dict(batch=o["train"]["batch"], n_micro=o["train"]["n_micro"],
                       losses=recs[0]["train"]["losses"], one_process_losses=o["train"]["losses"],
                       max_loss_rel=max(rels),
                       params_outside=[r["train"]["params_outside"] for r in recs],
                       params_held=[r["train"]["params_held"] for r in recs],
                       max_param_abs_diff=[r["train"]["max_param_abs_diff"] for r in recs],
                       adam_flip_bound=adam_flip_bound(1 + FAMILY_MESH_TIMED),
                       split_leaves=recs[0]["train"]["split_leaves"],
                       whole_leaves=recs[0]["train"]["whole_leaves"],
                       replicated_identical=all(torch.equal(
                           r["train"]["replicated_checksums"],
                           recs[0]["train"]["replicated_checksums"]) for r in recs),
                       step_p50_ms=[r["train"]["step_p50_ms"] for r in recs],
                       one_process_step_p50_ms=o["train"]["step_p50_ms"],
                       examples_per_s=[r["train"]["examples_per_s"] for r in recs],
                       one_process_examples_per_s=o["train"]["examples_per_s"],
                       peak_device_bytes=[r["train"]["peak_device_bytes"] for r in recs],
                       one_process_peak_device_bytes=o["train"]["peak_device_bytes"]),
            serve_p99=dict(batch=o["serve_p99"]["values"]["batch"],
                           outside=[n for n, _ in serve], max_abs_diff=[d for _, d in serve],
                           p50_ms=[r["serve_p99"]["p50_ms"] for r in recs],
                           one_process_p50_ms=o["serve_p99"]["p50_ms"]),
            retrieval_cand=dict(n_candidates=o["retrieval_cand"]["values"]["n_candidates"],
                                top_k=o["retrieval_cand"]["values"]["top_k"],
                                ids_agree=[x["ids"] for x in ret],
                                scores_outside=[x["scores"][0] for x in ret],
                                p50_ms=[r["retrieval_cand"]["p50_ms"] for r in recs],
                                one_process_p50_ms=o["retrieval_cand"]["p50_ms"]),
            collectives=[_wire_summary(r["wire"], 1) for r in recs],
            collectives_note="gloo through the host: NCCL refuses two ranks on one card",
            seconds=[r["seconds"] for r in recs], one_process_seconds=o["seconds"])
        emit({"family_mesh": line, "card": info["card"]})
        t = line["train"]
        assert t["max_loss_rel"] <= LM_TP_LOSS_RTOL and t["replicated_identical"], line
        assert t["split_leaves"] > 0 and all(
            params_agree(n, h, d, 1 + FAMILY_MESH_TIMED)
            for n, h, d in zip(t["params_outside"], t["params_held"], t["max_param_abs_diff"])), line
        assert line["serve_p99"]["outside"] == [0] * FAMILY_MESH_MODEL, line
        assert all(x["ids"] and x["scores"][0] == 0 for x in ret), line
    for name in GNN_RUNS:
        o, recs = one[name], [r[name] for r in ranks]
        diffs = [[_within(a, b, **FAMILY_MESH_PARAM_TOL) for a, b in zip(r["params"], o["params"])]
                 for r in recs]
        line = dict(run="schnet", cell=name, mesh=mesh, nodes=o["nodes"], edges=o["edges"],
                    edge_shards=[r["edge_shards"] for r in recs],
                    loss=[r["loss"] for r in recs], one_process_loss=o["loss"],
                    max_loss_rel=max(abs(r["loss"] / o["loss"] - 1) for r in recs),
                    params_outside=[sum(n for n, _ in d) for d in diffs],
                    params_held=sum(x.numel() for x in o["params"]),
                    max_param_abs_diff=[max(x for _, x in d) for d in diffs],
                    adam_flip_bound=adam_flip_bound(1),
                    step_ms=[r["step_ms"] for r in recs], one_process_step_ms=o["step_ms"],
                    peak_device_bytes=[r["peak_device_bytes"] for r in recs],
                    one_process_peak_device_bytes=o["peak_device_bytes"],
                    collectives=[_wire_summary(r["wire"], 1) for r in recs],
                    collectives_note="gloo through the host: NCCL refuses two ranks on one card",
                    seconds=[r["seconds"] for r in recs], one_process_seconds=o["seconds"])
        emit({"family_mesh": line, "card": info["card"]})
        assert line["max_loss_rel"] <= LM_TP_LOSS_RTOL, line
        assert all(params_agree(n, line["params_held"], d, 1)
                   for n, d in zip(line["params_outside"], line["max_param_abs_diff"])), line
        assert line["edge_shards"] == [FAMILY_MESH_MODEL] * FAMILY_MESH_MODEL, line
    info["runs"] = list(RECSYS_ARCHS) + list(GNN_RUNS)
    info["in_phase_s"] = time.perf_counter() - t_phase


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of graphlearn_tpu_torch: sampled GraphSAGE inference
on one CUDA GPU, on the tree path and on the merge (exact-dedup) path,
GraphSAGE embedding serving (full-graph materializer + engine),
GraphSAGE training on both paths (per-step loop; ScanTrainer captured as
CUDA graphs and eager; checkpointed, crashed and resumed; RunTrainer with
and without an early stop; OverlappedTrainer), the products example's
other modes (block, padded-window and weighted hops, node_budget, bf16),
link prediction (the unsupervised example's LinkNeighborLoader and link
train step), induced subgraphs, the legacy dedup engines, typed
sampling and the IGBH RGNN (inference and training), HGT, the
homogeneous GAT (forwards, training, a captured epoch, serving) and the
SEAL DGCNN, typed link prediction (the bipartite two-tower example),
typed RGNN serving and the tiered typed loader, partitioning with
sample_prob, the partitioned (distributed) sampling path over 4 shards
on the one card, the multiprocess and server-client sampling stack
(sampling workers on the card, a server child and this process its
client), the chunk-staged remote scan (K-batch block frames from a
server child, a captured RemoteScanTrainer; a typed epoch), the hot/cold
feature store (the papers-scale and table examples), the out-of-core
tiered store (TieredScanTrainer, the papers example's three-tier mode,
the spilled serving stores), the two probe suites, the port's static
analyzer, and the several-card path (a DeviceGroup store sharded over
every card, one card named twice where there is one, and a
DistScanTrainer captured under an NCCL group of one rank per card).

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):

1. Set-up: the card's name and power limit (nvidia-smi), TF32 off, and
   the CUDA kernels built with nvcc from ``graphlearn_tpu_torch/csrc``
   (one nvcc per source, started together, while numpy builds the graph).
2. Kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (exact equality), with the kernel's, the plain
   version's and (where one exists) one library call's median device
   time (and, beside it, the time of a call including its host launch
   cost), and the bound computed from the inputs: bytes over the memory
   rate, or the kernel's instructions (its unit's SASS, read with
   ``cuobjdump -sass`` from the libraries just built, times the units
   the inputs need) over the card's issue (what only the ALU pipe runs
   and what only the FMA pipe runs at 64 a clock per SM each, all
   instructions at 128, the 2-input adds on either pipe and each 3-input
   add as one ALU instruction or two IMADs, over 132 SMs at the SM clock
   nvidia-smi reads), whichever is larger; beside each, the
   fill floor (``fill_(0)`` of the output's bytes, timed alike) and the
   yardstick's share of the kernel's time (the yardstick: the larger of
   the bound and the fill). The fused hop (one launch: seed rows, threefry
   draw, pick) runs at hops 0-2 of a products batch, hop 2 with 1% hub
   seeds whose rows in a fabricated row table point at long segments,
   against the plain hop on the same device key and beside
   ``indices[epos]``. The fused level (three launches) runs at the three
   levels of one full-width merge batch, from the arguments, states and
   scratch the sampler produced, and once more at S > 32,768 with hubs,
   duplicates, all-found and all-masked seeds, against the plain level
   (the draw and the merge inducer). The chunk's hop keys (one launch of
   the step-keys kernel: 8 steps x 3 hops, counts crossing 2**32) against
   ``random.step_keys_plain`` on the same device words. The draw kernel
   of the sampling backends (one launch) against ``random.uniform`` on
   the same device key, bit for bit, at hop 2 ([153600, 5]), hop 1
   ([15360, 10]) and one word per edge (the padded table's build). The
   negative sampling kernel (one launch: the key's four subkeys, two
   randint draws per candidate with JAX's uint32 wraps, the search of
   the row-sorted CSR) against its plain version on the same device key,
   exact (rows, cols, valid and the taken negatives), at a link batch's
   2,560 candidates and at 163,840, over the 1M-node span.
3. Slices, at full width (``bench.py``'s recipe: 1M nodes, average
   degree 25, half uniform and half zipf(1.5) targets, [1M, 100] f32
   features, 47 classes; fanouts [15, 10, 5] at batch 1024; GraphSAGE
   hidden 256, 3 layers, weights from a fixed seed):
   - tree: ``dedup='tree'``, the layered tree-dense forward;
   - merge: ``dedup='auto'`` with ``frontier_caps='auto'`` (calibrated
     in the loader) under ``overflow_policy='raise'``, the layered
     ``merge_dense`` forward.
   Before each, the launch counters are set to 0, and they are read just
   after: every hop (tree: one launch) or level (merge: three, plus one
   per batch) must have gone through its kernel and every feature gather
   through the row-gather kernel. No merge batch may overflow its caps.
   Outputs must be finite, and the last batch is recomputed on the CPU
   from the same sampler state (plain versions): ids, masks and features
   exact, logits within rtol=1e-3, atol=1e-4 (TF32 off; the two devices
   sum in other orders). Then torch.profiler over one more sampled batch
   gives its device ops and busy and wall time.
4. Serving, on the same graph and width: ``GraphSAGE(100, 256, 47)``,
   3 layers, the plain segment forward, weights from seed 0.
   ``EmbeddingMaterializer(block_size=2048, chunk_size=8).materialize()``
   (ms per layer pass by CUDA events), the table against one direct
   full-graph forward on the card and 512 rows of every layer pass
   recomputed on the CPU from the card's own input store; then
   ``mat.embedding_store()`` routed through gather v2
   (``set_kernel_routing(use_pallas_v2=True, block_rows=256,
   run_span=8)``) behind ``ServingEngine(buckets=(16, 64, 256))``: eight
   client threads send 64 requests each (a synthetic mix: lengths 1-300;
   ids 3/4 zipf(1.5), 1/4 contiguous ranges), every answer equal to the table,
   one gather-v2 launch per engine batch; then 16 poisoned rows marked
   stale must come back as the CPU's final-layer recompute. The launch
   counters are set to 0 before the materializer and read after the
   engine. Then the gather-v2 kernel against its plain version at the
   engine's caps over the served table and at the JAX probe shape
   (131,072 ids over [1M, 128] f32, presorted chunks and four id
   distributions), with K1 and ``index_select`` on the same ids, the
   share of slots that runs copy in the JAX plan and in the kernel's own
   in-tile plan, and the kernel's plan (read back from the card) equal to
   ``plan_runs_in_tiles``.
5. Training, on the same graph and width (``GraphSAGE(100, 256, 47)``,
   3 layers, Adam at 3e-3, TF32 off), for tree and for merge: 16 steps of
   the products example's per-step loop (loader -> batch_to_dict ->
   train_step) over a 16,384-seed pool in order, split into
   sample+collate and train by CUDA events, with the peak memory of the
   steps; the last step recomputed on the CPU from the same state and
   batch (ReLU inputs within rtol=1e-4, atol=1e-5, the CPU following the
   card's side of 0 at each; loss within rtol=1e-4; gradients within
   rtol=1e-3 and 1e-4 of each tensor's largest; the CPU's Adam step on
   the card's gradients within rtol=1e-6, atol=1e-7 of the card's
   parameters; the parameters of the two full steps recorded); then two
   ScanTrainers over the same pool from the same start, chunks of 8:
   captured (the default on a card: an eager warm-up chunk, then one
   CUDA graph per chunk length, replayed) and eager, two epochs each (the
   first epoch's seed matrix equal to the loop's and its losses within
   rtol=1e-4 of the loop's; each epoch's seed matrices equal,
   losses within rtol=1e-4 and launch counts equal between the two, the
   eager trainer taking up the captured one's weights and Adam state
   before the second epoch and at each of its chunk starts; the graphs'
   hop keys exact against ``step_keys_plain``; parameters and Adam state
   after each chunk of the second epoch apart by less than PARAMS_LIMIT,
   which a control, the eager second epoch without its last step, must
   exceed), with
   ms/step, capture ms and peak memory (allocated and reserved); then
   the host syncs per step of the loop and of both trainers under
   ``torch.cuda.set_sync_debug_mode('warn')`` (the loop: none; the
   captured trainer: none, but for the calibrated merge guard's one per
   epoch), and torch.profiler
   over one more epoch of each trainer (device ops and busy per step; the
   port's kernels the profiler saw must equal the launch counters, and
   are the captured trainer's launches in the result line). The launch
   counters are set to 0 before the loop and before every epoch and read
   after each: every step's hops (tree) or levels (merge), its feature
   gather and every chunk's hop keys must have gone through their kernels.
   No merge batch may overflow. Then torch.profiler over one more loop
   step gives its device ops. Then the rest of the epoch as a program
   (merge training on the card is chaotic: the backward's scatter atomics
   sum in no fixed order and Adam turns a flipped gradient sign near 0
   into a step of the rate, so parameters are compared from one state
   over a few steps): a captured ScanTrainer A (K = 4) for two epochs
   without and two with ``ChunkCheckpointer(every=2)`` (ms/step of each,
   recovery_overhead_pct of the second epoch with it against the second
   without, snapshot bytes, save and capture ms p50/p99, host syncs per
   step with it: 0, or the merge guard's 1; save errors and torn skips
   0); a third trainer from other weights advanced by ``resume_epoch``
   to A's state after its third epoch (the completed-epoch snapshot),
   crashed from its stage_hook at chunk 3 of the fourth, and
   ``resume_epoch`` into a fresh trainer from other weights under
   torch.profiler (the prefix exact, the replayed losses within rtol 1e-4
   of A's fourth epoch, the state after the first replayed chunk within
   PARAMS_LIMIT of the crashed trainer's after the same chunk, the
   replayed hop keys exact, the profiler's kernels equal to the
   counters); a captured RunTrainer over 3 epochs at K = 6 (chunks across
   both epoch boundaries) from A's state after two epochs, held chunk by
   chunk to a captured ScanTrainer at K = 2 from the same state (the seed
   matrix equal to its three prologues, losses within rtol 1e-4, the
   state after each chunk within PARAMS_LIMIT of the reference's, launches
   per step equal, step keys once per chunk and exact), then a run of
   replays timed with 0 host syncs (or the guard's 1); an early-stopped
   RunTrainer (K = 8, patience 1, min_delta 1.0: two epochs run, the
   third's losses and accuracies 0, the parameters and Adam state taken
   at step 32 equal to the final ones, ms per step of the active and the
   stopped chunks by CUDA events); OverlappedTrainer held step by step to
   the per-step loop from A's state after two epochs (losses within rtol
   1e-4, the state after each step within PARAMS_LIMIT), then timed beside
   an unsynchronised loop epoch and profiled over one more epoch (device
   busy as the union over both streams, the kernels' summed time, their
   difference the overlap, the streams seen, the idle share).
   Then the tuner (``tune_phase``, after the observability phase):
   ``graphlearn_tpu_torch.tune`` at this width over the slice pool (the
   default field plus the retrace probe: captures per candidate in the
   compile phase and the steady epoch, ms per step, peak MB; the probe
   rejected with a chunk-length diff), ``ScanTrainer(config=art)`` over
   two epochs (the second captures nothing), the serving engine routed
   through K2 by the artifact (one launch per engine batch, answers
   equal to the table), ``GLT_STRICT=1`` over captured tree and merge
   epochs (no raise; a ``.item()`` in a stage_hook raises only under
   it), and ``recovery.save`` / ``serving.rotate`` armed once each; after
   the dist_scan phase, ``tune(topology='dist')`` over its 4 shards
   (``tune_dist_phase``).
6. Modes: the products example's other modes on the same graph and width
   (its flags --strategy block, --padded-window auto (W = 16), weights
   made from a seed, --node-budget 100000 on tree (the layered segment
   forward) and merge, and --bf16-features --bf16-model), each through a
   captured ScanTrainer (K = 8) and an eager one from the same weights:
   a warm-up epoch each, then a timed epoch each from the captured one's
   state (losses within rtol 1e-4, BF16_TOL for bf16; with the launch
   counters set to 0 before and read after: 2 draw launches per block
   hop, 1 per padded or weighted hop and 1 per padded-table build, the
   hop kernel once per uniform tree hop, the level kernel 3 per level +
   1 per batch, K1 once per step), a profiled third epoch (device busy
   per step, the profiler's kernels equal to the counters) and one
   sampled batch recomputed on the CPU from the same sampler state (ids,
   masks, features exact; logits within rtol 1e-3, atol 1e-4, or
   BF16_TOL of the largest bf16 logit). The padded mode's reseeded table
   must differ from the first epoch's and equal a CPU rebuild from the
   same key. Before it, the padded table's build and the padded hop at
   hop 2 timed at W = 16, 32 and 64.
7. Link prediction, the unsupervised example's width
   (``examples/graph_sage_unsup.py:84-96``) on the same graph and
   features: ``LinkNeighborLoader([10, 5], pool,
   neg_sampling=NegativeSampling('binary', 1), batch_size=512,
   shuffle=True, drop_last=True)`` over a seeded 8,192-edge pool of the
   graph's own edges, ``GraphSAGE(100, 128, 128)``, 2 layers, the plain
   segment forward, Adam 3e-3, the link train step, 16 loop steps (one
   epoch) under the merge engine, the tree engine and calibrated caps
   (``frontier_caps='auto'`` at the link seed width). Launch counters set
   to 0 before each run and read after: one negative-sampling launch, the
   hops (K3) or levels (K4) and one K1 gather per step. Every batch's
   ``node[edge_label_index]`` equals its positive and negative pairs,
   every negative is absent from the graph and every positive present
   (host check against the CSR), no batch overflows, and the last step is
   recomputed on the CPU from the same state and batch (as the training
   phase's). Reported: ms/step split into sample+collate and train by
   CUDA events, peak memory, host syncs per step of 4 more loop steps,
   and one more step under torch.profiler (device busy and ops, the
   port's kernels equal to the counters).
8. Induced subgraphs: ``SubGraphLoader([10, 5], batch_size=256,
   with_edge=True)`` on the same graph with a seeded ``[25M, 4]`` f32
   edge-feature table, two exact and two bucketed batches: nodes, edges,
   edge mask, edge ids, edge features, features and mapping equal to a
   CPU loader's from the same stream, every kept edge the COO edge its id
   names; ms per batch. Then one products-width batch ([15, 10, 5] at
   1024) of each legacy engine (``map_table``, ``sort_legacy``; K3, K1),
   equal to a CPU recompute.
9. The typed path, at the IGBH example's width
   (``examples/igbh/train_rgnn.py``: its IGBH-shaped synthetic of
   100,000 papers and 50,000 authors with 64-wide f32 features, built by
   the port's ``train_rgnn.make_igbh_like``; cites [10, 5], writes
   [5, 3], rev_writes [3, 2] at batch 512, edge_dir 'out'; caps from
   ``estimate_hetero_frontier_caps`` over the example's 10,000 train
   seeds). Typed tree and calibrated merge batches of the example's
   loader (a warm-up batch, then 4 timed by CUDA events; the launch
   counters set to 0 before and read after: K3 once per (hop, edge
   type) plan item, K1 once per featured type; the last batch equal to
   the CPU's from the same sampler state, ids, masks, counts, features
   and labels bit for bit; one more batch under torch.profiler, its
   kernels equal to the counters; the epoch drained, 0 truncated
   batches); one block (tree) and one weighted (merge) typed batch on a
   copy of the graph with dyadic edge weights, equal to the CPU's, the
   draw kernel 2 / 1 times a plan item. ``RGNN`` rsage and rgat (4
   heads, hidden 128, 2 layers, 16 classes) from one set of weights in
   the segment, hierarchical and tree-dense forwards over the tree
   batches and the segment and merge-dense forwards over the merge
   batches: forward ms per batch, logits finite and within rtol 1e-3,
   atol 1e-4 of the CPU's (TF32 off), the dense forwards' seed logits
   within the same of the segment forward's and the hierarchical ones
   within rtol 1e-5, atol 1e-6 of the full forward's. Training, the
   example's loop with Adam at 3e-3: 16 steps each of rsage tree-dense,
   rgat tree-dense and rgat merge-dense (ms/step split into
   sample+collate and train, peak memory, launches per step as planned;
   the last step recomputed on the CPU from the card's state before it,
   as the training phase's; host syncs per step of 4 more steps; one
   more step under torch.profiler: device ops, busy and idle share, its
   kernels equal to the counters). The phase's wall time is printed.
10. Models: the rest of the model zoo on its paths. (a) HGT at the MAG
   example's width (``examples/hetero/train_hgt_mag.py``: its MAG-shaped
   synthetic of 60,000 papers and 7 edge types, built by the port's
   ``train_hgt_mag.build_dataset``; [10, 10] at batch 512, hidden 64, 4
   heads, 2 layers): typed tree and calibrated merge batches as in phase
   9 (K3 once per plan item, K1 once per featured type, bit-equal to the
   CPU's, the profiler's kernels equal to the counters), the segment,
   hierarchical, tree-dense and merge-dense forwards from one set of
   weights (each within rtol 1e-3, atol 1e-4 of the CPU's, TF32 off; the
   dense ones' seed logits within the same of the segment forward's, the
   hierarchical ones within rtol 1e-4, atol 1e-5 of the full forward's),
   and 16 tree-dense and 16 merge-dense train steps (``loop_train``: the
   last step held by ``cpu_step_check`` from the card's state before it,
   0 host syncs a step, a profiled step). (b) The homogeneous GAT at
   ``benchmarks/prof_gat_merge.py:3,28``'s configuration on the script's
   graph (``GAT(100, 128, 47)``, 3 layers of 2 heads, f32, [15, 10, 5] at
   1024): tree-dense on tree batches (K3 3 and K1 1 a batch) and
   merge-dense on calibrated merge batches (K4 10 a batch), each against
   the segment forward and a CPU recompute (rtol 1e-3, atol 1e-4); 16
   loop steps of each, the last held as in (a), with 0 host syncs a step; two
   captured ScanTrainer epochs of the tree-dense GAT (K = 4) equal to
   two eager ones (losses within rtol 1e-4, parameters within
   PARAMS_LIMIT, launches equal; the second epochs timed, with 0 host
   syncs a step). (c) GAT serving:
   the serving phase's materializer with a segment ``GAT(100, 128, 47)``
   of 2 layers of 2 heads, each layer pass's 512 rows recomputed on the
   CPU, then 64 engine lookups through the gather-v2 route, equal to the
   table, one K2 launch per engine batch. (d) SEAL at the example's
   defaults (``examples/seal_link_pred.py``): the train links' enclosing
   subgraphs extracted on the card (K4 per subgraph; the first 16 equal to
   a CPU sampler's), 4 DGCNN train steps each recomputed on the CPU from
   the card's state before it (the CPU following the card's sort order,
   max pool choices and ReLU sides), and a forward against the CPU's. The
   phase's wall time is printed.
11. Typed link prediction and typed serving. (a) The bipartite example
   (``examples/hetero/bipartite_sage_unsup.py``) at its defaults: 32
   steps of its loop (typed link batches of 512 clicks and 512 binary
   negatives, the two-tower model, Adam at 1e-3), launches per step (the
   negative kernel once, K3 once per plan item, no K1), the last step
   recomputed on the CPU, 0 host syncs a step, a profiled step. (b) At
   the IGBH width: one typed link batch each of binary tree (cites),
   triplet and calibrated binary merge (writes), bit-equal to the CPU's
   with its metadata, 0 host syncs. (c) The RGNN served, rsage and 4-head
   rgat: every materialization pass timed with its K1 launches, its rows
   at 4,096 ids a type recomputed by the CPU materializer, the typed
   refresh of 256 papers against the table, a poisoned row served fresh
   through ``mark_stale`` and 64 lookups with p50 / p99. (d) The tiered
   typed loader (per-type TieredFeature, hot 0.25, warm 0.25, disk 0.50):
   tree batches bit-equal to the all-device loader's, hot/cold launches
   and host syncs a batch.
12. Partition: ``sample_prob`` on the card over the script's graph
   ([15, 10, 5], 1,024 seeds) against the CPU, a FrequencyPartitioner of
   it (2 parts from two seed pools' card probabilities, cache 0.1) and a
   random partition of the IGBH graph, each read back exactly from a
   temporary directory removed afterwards, with the seconds of each.
   Then the partitioned path (the ``dist`` phase): the script's graph
   split into 4 shards by RandomPartitioner's rule and stacked on the
   card (a one-process ``ShardMesh``; features with a 10% hot cache by
   in-degree); a ``DistNeighborLoader`` at [15, 10, 5] and 1,024 seeds a
   shard, dedup tree and sort, each at bucket_frac 2.0 and None: 3
   batches timed (K3 4 x 3 and K1 12 a batch asserted: the launch
   counters set to 0 before and read after), the first held against the
   CPU sampler on the same partitions and keys (ids, masks, counts and
   edges exact; ``x`` and ``y`` the rows and labels of its ids), one
   more under sync counting (exactly the counted verdict reads: one per
   exchange whose fractional capacity is below its full width, none at
   None), the exchanges' device ms and one profiled batch; 3
   data-parallel steps of ``examples/dist_train_sage_supervised.py``
   (hidden 256, 3 layers) with the last recomputed on the CPU; and a
   world-size-1 NCCL process group's batch against the one-process mesh.
   Then the distributed trainers (``dist_scan``) and the rest of the
   distributed core (``dist_more``), and the remote stack (``remote``):
   ``MpDistNeighborLoader`` with 2 workers sampling on the card over the
   script's graph ([15, 10, 5] at 1,024, merge uncalibrated; the ring
   sized to two messages reckoned from the CPU's batch) and 4 products
   steps (``GraphSAGE(100, 256, 47)``, merge-dense); the typed mp loader
   at ``train_hgt_mag_mp``'s defaults (60k papers, [10, 10] at 512) and
   3 HGT steps (64 hidden, 4 heads); a ``DistServer`` in a spawned child
   holding the dataset on the card (2 workers a producer, a serving
   engine over a seeded [1M, 64] table routed through gather v2) with
   this process its client over loopback: a ``RemoteDistNeighborLoader``
   (seed 1: worker seeds past 2**32) for 4 products steps, 2 of them
   profiled, and 4 ``serve`` RPCs. Each worker's first batch exact
   against the CPU sampler at its worker seed (ids, masks, edges, ``x``,
   ``y``); the workers' launches (K4 10 and K1 1 a homogeneous batch, K3
   per plan item and K1 per featured type a typed one), read from their
   metric snapshots, and K2 once per ``serve``, read from the server's
   counters before and after; the served rows equal to the table; ms a
   batch by stage (worker sample+gather, device->host, ring write, ring
   read, the server's fetch, the client's fetch RPC, the loopback wire
   of one message, deserialize, upload, train), the message bytes, the
   client's idle share and largest device ops; after shutdown no ring
   open or alive (``shmctl``) and no child process.
   Then the chunk-staged remote scan (``remote_scan``): a server child
   (the same ``remote_server_main``, its stderr kept) and this process
   its client, block frames of K = 2 batches at [15, 10, 5] x 1,024
   (merge uncalibrated, shuffle off, seed 1), 5 products steps an epoch
   (chunks of 2, 2 and 1). The first block fetched directly, f32 and
   bf16: its two steps exact against the CPU sampler at the stream's
   worker seed and against the first two batches of a
   ``RemoteDistNeighborLoader`` (one worker) at the same seed, the bf16
   frame's ``x`` the f32 frame's rounded to nearest even, its other keys
   equal; frame bytes beside ``block_mb_per_chunk``. An eager
   ``RemoteScanTrainer`` epoch (its last step recomputed on the CPU by
   ``cpu_step_check``), a captured one from the same weights taking up
   the eager trainer's parameters and Adam state at each chunk start
   (chunk losses within rtol 1e-4; one upload a chunk, one replay a
   chunk after the eager warm-up), a second captured epoch of replays
   only (0 host syncs counted, one upload and one replay a chunk;
   ms/step; per chunk the server's sample+gather, pack and device->host
   ms from its build log, the fetch RPC, the wait at ``take``, the
   pinned copy, the upload and the chunk's device ms), a profiled epoch
   (the client's idle share and five largest device ops) and a
   bf16-wire epoch; the server's launches read before and after each
   epoch (K4 10 and K1 1 a batch). Then ``train_hgt_mag_mp``'s defaults
   cut to 4 batches at K = 2: a ``DistServer`` in this process over the
   typed dataset on the card, the first block's two batches exact
   against the CPU sampler at the stream's counter, a captured typed
   epoch of HGT (merge-dense), K3 per plan item and K1 per featured type
   a batch. After shutdown no ring, no child process and no report of
   unreleased CUDA IPC handles in the server child's stderr.
13. The hot/cold feature store. The card's pinned host-to-device rate
   (a 256 MB copy), and, read only, where the mapped tail sits: the
   card's NUMA node, this process's CPU affinity and those CPUs' nodes,
   the nodes of the tail's pages (``/proc/self/numa_maps``) and whether
   the read-only mapping was granted. The hot/cold kernel (one call: a
   memset and two kernels; the device prefix from HBM, each distinct
   cold row read once over UVA from the mapped host tail and copied on
   the card to the other slots naming it) on the storage rows of one
   [15, 10, 5] x 1024 tree batch over the script's table reordered by
   in-degree (``sort_by_in_degree``), at split 0.25 and with every row
   on the host, and on as many ids with no duplicate (a permutation of
   the table's rows from the seed) at split 0.25, against its plain
   version, the JAX store's design built in torch on the card (ids to
   the host, the cold rows gathered there, a pinned copy,
   ``index_copy_``), bit for bit; the kernel's fetch counter equal to
   the distinct cold rows (``torch.unique``); three timings in the call
   (each the median of 20); the cold share, the rate on distinct cold
   bytes beside the pinned rate, and the bound: the larger of the HBM
   bytes over 3.35 TB/s and the distinct cold rows' bytes over the
   measured pinned rate. Then the papers-scale example's hot/cold mode
   (``examples/train_sage_papers_scale.py``, cut to 2M nodes with
   ``--hot-gb 0.4``: split ~0.42; block sampling [5, 5] at 256, 8 steps
   after the warm-up step): ms/step split into sample+collate and train,
   one hot/cold launch a step and no row-gather launch, the hot hit
   rate, 0 host syncs in the lookup (``count_syncs``), the peak memory,
   the last step recomputed on the CPU, and the kernel on the last
   batch's rows timed three times with its fetch counter checked. Then
   ``train_from_tables.py`` at
   its size (20,000 nodes, three edge tables, every feature row on the
   host): one epoch, every batch's ``x`` equal to the table's rows, one
   hot/cold and two hop launches a step; and the store rebuilt in this
   process from its IPC handle, exact.
14. The tiered store: the script's table sorted by in-degree in a
   ``storage.TieredFeature`` (hot 0.25 on the card, warm 0.25 mapped on
   the host, the rest as npy chunks in a temporary directory, removed at
   the end), training ``GraphSAGE(100, 256, 47)`` (Adam 3e-3) over a
   16,384-seed pool, 16 steps in chunks of 8, in a captured
   ``TieredScanTrainer`` and in the all-device captured ``ScanTrainer``
   from the same weights, held by C5's rule (the tiered trainer takes up
   the reference's parameters and Adam state at each chunk start and is
   compared at the chunk's end: within PARAMS_LIMIT; losses within rtol
   1e-4; merge's first epoch, a cold start, reported, not held). Tree:
   two healthy epochs, one whose staging worker raises (degraded, its
   prefetch_miss > 0, held all the same), every step's ``x`` of the last
   healthy and the degraded epoch bit-equal to the all-device gather
   (each chunk's slab staged again), a timed epoch of each (ms/step,
   their ratio, the prologue's ms, per chunk the planned, disk rows and
   slab bytes, the worker's stage ms, the wait at ``take``, the slab's
   copy and the chunk's device ms; launches: one K1 a step, the hops of
   the chunks and of the plan's replay, one step-keys launch a chunk and
   one for the plan), a sync-counted epoch (1 host sync: the plan fetch)
   and a profiled epoch (the profiler's kernels equal to the counters).
   Merge (calibrated caps): two epochs, ``x`` bit-equal. Then the papers
   example's three-tier mode through ``run_tiered`` (``--spill-dir``,
   2M nodes, ``--hot-gb 0.4 --warm-gb 0.2``, 16 steps in chunks of 8):
   its JSON fields, per-chunk staging, and its last chunk run again
   eagerly from the state at its start, the last step recomputed on the
   CPU. Then the serving phase's model materialized with
   ``spill_dir``, ``tiered_embedding_store`` and both restarted stores
   (``warm_embedding_store``, tiered and whole) against
   ``embedding_store()`` on the serving mix's buckets: equal rows, lookup
   ms p50 and p99, host syncs per lookup (0 for the tiered stores) and
   one hot/cold launch per tiered lookup.
15. Probes: both suites (``graphlearn_tpu_torch.benchmarks.prof_mem`` and
   ``prof_dedup``) at the JAX suites' sizes, with their kernels' launch
   counters set to 0 before and read after, then the two probe kernels
   against their plain versions (exact) and a library call at the
   probes' shapes (the row gather on both routes: bulk copies on the
   aligned table, the vector route on a copy 4 bytes off, beside K1 and
   ``index_select``, with GB/s, rows/s and bulk copies/s), and the take at
   every cluster size beside ``torch.take``.
16. Lint: the port's static analyzer, its CLI
   (``python -m graphlearn_tpu_torch.analysis.lint --format json
   --timings graphlearn_tpu_torch/``) in a child process over the
   package of this checkout: exit 0, 0 findings, the package's (empty)
   baseline; the files walked, the pragma-suppressed count, the child's
   wall and each rule's seconds on the host's CPU (not a card number).
   The child starts after the set-up and runs beside the phases.
17. Multicard (run right after ``dist_more``): the several-card path.
   First a line with ``torch.cuda.device_count()``, the group (every
   card; ``cuda:0`` named twice on a one-card machine, so one card runs
   the sharded layout and its kernels) and each ordered pair's peer
   access verdict (every pair must reach the other). (a) The script's
   ``[1M, 100]`` f32 table in a ``Feature`` whose ``DeviceGroup`` is
   that group, at split 1.0 (the sharded K1 entry) and 0.25 (the
   sharded hot/cold entry; the tail mapped): the store's lookup of one
   [15, 10, 5] x 1,024 tree batch's 937,984 ids (one sharded launch
   each, its rows the table's), then the kernel on those ids against its
   plain version bit for bit (the sharded hot/cold entry's fetch counter
   equal to the distinct cold rows; three timings), timed beside the
   one-table kernel (K1, or
   the hot/cold kernel of an ungrouped store at the same split) and the
   shards' own ``index_select``, with the bound: the larger of the HBM
   bytes over 3.35 TB/s, the distinct remote rows' bytes over NVLink's
   450 GB/s one way and (a tail) the distinct cold rows' bytes over the
   measured pinned rate. (b) One spawned rank per card (world 1 on one
   card; ``init_multihost`` over NCCL, the script's graph arrays mapped
   from a temporary directory and cut into world shards by
   RandomPartitioner's rule while (a) runs, the card touched after): the
   dist_scan cell's trainer at ``bucket_frac=None`` (tree, [15, 10, 5] x
   1,024 a shard, hidden 256, 8 steps at K = 4), a captured epoch and an
   eager one from the same weights, bit-equal (losses and parameters),
   at world 1 also the one-process mesh at P = 1, captured, bit-equal;
   K3 3 and K1 3 a step and one ``dist_step_keys`` a chunk (each rank's
   counters, read in its process); ms/step of a replayed epoch and the
   idle share of a profiled one. Any failure fails the run.

The line before the last is the ``kernels`` JSON record; the last line
is ``{"ok": true, "device": {...}}``. ``--out FILE`` also writes the
whole report as JSON; ``--profile`` adds a torch.profiler pass over each
phase of both slices, one materialization pass, 50 engine batches (with
the device ops per routed batch), gather v2, K1 and ``index_select`` at
the largest cap and on the probe's random ids, a train step of each
path, and the take at each cluster size beside
``torch.take``.
``--rehearse`` runs every phase on the CPU at a tiny size through the
plain versions (no result line; exit code 3). ``--noise WINDOWS,RUNS``
measures, instead of the phases, the noise two checks must stand: WINDOWS
profiled captured tree epochs with no lead and as many with
PROFILE_LEAD_S (windows whose kernels fall short of the launch counters),
and RUNS merge loops' last steps against the CPU, the homogeneous
GraphSAGE's, then the typed RGAT's (``--noise WINDOWS,RUNS,TYPED``: TYPED
of those; no result line; exit code 3).
"""
import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA's H100 SXM data sheet
# The card's issue, for a kernel bound by its instructions (the draw's
# threefry: integer add, xor and funnel shift). An SM's four schedulers
# issue at most one warp instruction a clock each (128 thread
# instructions); its ALU pipe (logic, shift, compare, select, a 3-input
# add) and the integer side of its FMA pipe (IMAD) take 64 a clock each,
# and float32 add, multiply and FMA 128 (CUDA's throughput table,
# compute capability 9.0), so those bound nothing the issue does not.
# The bound takes what each instruction needs, not the pipe ptxas chose
# for it: a 2-input add or a move runs on either pipe, and a 3-input add
# is one ALU instruction or two IMADs (``issue_quotients`` places them
# where they cost least). The instructions are counted from the built
# libraries' SASS (``cuobjdump -sass``: ``sass_unit_counts``), at the SM
# clock nvidia-smi reads as clocks.max.sm
H100_SMS = 132
SM_ISSUE_PER_CLOCK, SM_ALU_PER_CLOCK, SM_FMA_PER_CLOCK = 128, 64, 64
SM_CLOCK_HZ = 1.98e9   # the H100 SXM's clocks.max.sm; main reads the card's
# the rate the bounds used before the recount: float32 outside the tensor
# cores (an FMA counted as two operations), with an estimate of 85 32-bit
# operations a drawn word; kept for the comparison the report prints
H100_OPS_PER_S = 67e12
DRAW_OPS = 85
# SASS opcodes (before the first '.') by what they need (``sass_need``):
# the ALU pipe alone, the FMA pipe alone (an integer multiply), or either
# (a 2-input add, a shift-add or a move); IADD3 is read from its
# operands. The rest (float32 arithmetic, loads, stores, branches,
# conversions, uniform-datapath instructions) count only against the
# issue rate
ALU_OPCODES = frozenset((
    'LOP3', 'SHF', 'ISETP', 'SEL', 'IMNMX', 'VIMNMX', 'FSETP', 'FMNMX',
    'FSEL', 'PRMT', 'PLOP3', 'IABS', 'BMSK', 'SGXT', 'LOP', 'SHL', 'SHR',
    'P2R', 'R2P'))
FMA_OPCODES = frozenset((
    'IMAD', 'IMUL', 'IDP', 'IDP4A', 'HFMA2', 'HADD2', 'HMUL2', 'FCHK'))
EITHER_OPCODES = frozenset(('MOV', 'VIADD', 'IADD', 'ISCADD'))
# IMAD forms that add, shift or move (no multiply): either pipe
IMAD_EITHER = frozenset(('IADD', 'MOV', 'SHL', 'X'))
ZERO_OPERANDS = frozenset(('RZ', 'URZ', '0x0', '-RZ', '-URZ'))
# where sass_units found each kernel's counted unit, for the report
SASS_UNITS = {}
FANOUTS = [15, 10, 5]
BATCH = 1024
FEAT_DIM = 100
CLASSES = 47
HIDDEN = 256
HUB_DEG = 513   # least degree of the added hub seeds in the K3 check
BATCHES = 6   # counted slice batches (plus one through the loader iterator)
REPS = 20     # timed calls per kernel measurement
SPIN_CYCLES = 2_000_000   # ~1 ms of spin ahead of a device-timed call
SERVE_BLOCK, SERVE_CHUNK = 2048, 8   # materializer block_size, chunk_size
SERVE_BUCKETS = (16, 64, 256)
CLIENTS, REQUESTS = 8, 64            # client threads, requests per thread
RECHECK_ROWS = 512                   # rows recomputed on the CPU per layer
STALE_ROWS = 16
PROBE_ROWS, PROBE_CHUNKS = 1_000_000, 1024   # the JAX gather-v2 probe shape
LR = 3e-3                            # the products example's Adam rate
TRAIN_STEPS, TRAIN_CHUNK = 16, 8     # per-step loop / ScanTrainer epoch
SYNC_STEPS = 4                       # loop steps run under sync counting
CKPT_CHUNK, CKPT_EVERY = 4, 2        # checkpointed ScanTrainer: K, cadence
RUN_EPOCHS, RUN_CHUNK = 3, 6         # RunTrainer: chunks cross 16 and 32
STOP_CHUNK = 8                       # the early-stopped RunTrainer's K
# captured vs eager ScanTrainer parameters after one epoch from one start:
# above the sound readings (up to 2.2e-4 on an H100: the backward's
# scatter atomics sum in no fixed order, and Adam scales a gradient near
# 0 up to a step), below the eager epoch without its last step (~LR)
PARAMS_LIMIT = 1e-3
# torch.profiler on an H100 can lose the device records of what runs in
# its first milliseconds (a ScanTrainer epoch's first copies and step-keys
# launch: `--noise` counts it), so each profiled window idles this long
# before its calls
PROFILE_LEAD_S = 0.05
# ``(label, wall seconds)`` of every profiled window's warm-up call: what
# the warm-up cycles cost the script
PROFILE_WARMUPS_S = []
# the profiled windows recorded again because their trace held no device
# event (``profiled``), and how many times a window may be recorded again
# (for that or for a short count, ``record_window``)
PROFILE_EMPTY_WINDOWS = []
PROFILE_EMPTY_RETRIES = 2
# the windows recorded again because the profiler counted fewer launches
# of a port kernel than its launch counter: label, the kernels short and by
# how many, and where the window's device records sit (``record_window``)
PROFILE_SHORT_WINDOWS = []
# the windows whose first recording loses one record of a port kernel on
# purpose (``drop_one_port_record``; once each, the first time the label
# is recorded): a drill of the re-record on the card at the sites whose
# ``reset`` or ``Batches`` must put state back (a resumed trainer; a
# loader's iterator, there rolled into a new epoch). Their entries in
# PROFILE_SHORT_WINDOWS carry ``drill``; PROFILE_DRILLED lists them
PROFILE_DRILLS = frozenset(('train tree resume_epoch (warm-up, capture, '
                            'replay)', 'hetero merge batch'))
PROFILE_DRILLED = []
# the CPU recompute of the loop's last train step (cpu_step_readings),
# held in parts: the ReLU and leaky_relu inputs within PRE_RTOL /
# PRE_ATOL; the gradients, the CPU following the card's side of 0 at each
# of those inputs, within rtol
# 1e-3 and GRAD_SHARE of each tensor's largest CPU gradient; the CPU's
# Adam step on the card's own gradients within ADAM_RTOL / ADAM_ATOL of
# the card's updated parameters. (Adam divides each element's step by its
# own gradient scale, so an element whose gradients stayed near 0 turns a
# difference far below GRAD_SHARE into a step of up to LR: the parameters
# of the two full steps are recorded, not held.)
PRE_RTOL, PRE_ATOL = 1e-4, 1e-5
GRAD_SHARE = 1e-4
# the band |z| < LEAKY_NEAR0 that estimates the leaky_relu inputs' density
# at 0 (cpu_step_readings' leaky_expected_flips)
LEAKY_NEAR0 = 1e-4
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7
# device ops per sampled batch and per scanned train step measured before
# the sampling kernels drew in-kernel (PERF.md, section 5)
OPS_BEFORE = dict(tree=690, merge=768, train_tree=860, train_merge=1063)
# B6's designs before the persistent bulk ring, timed at the probe shape
# beside it (PERF.md, section 6) and then removed
# the link phase: the JAX unsupervised example's width
# (examples/graph_sage_unsup.py:84-96) on this script's graph
LINK_FANOUTS, LINK_BATCH, LINK_HIDDEN = [10, 5], 512, 128
LINK_STEPS = 16                      # one epoch of the seed-edge pool
NEG_TRIALS = 5                       # random_negative_sample's default
SUB_BATCH = 256                      # the subgraph phase's seeds a batch
EDGE_FEAT_DIM = 4                    # its edge-feature table's width
B6_REMOVED_DESIGNS_MS = {'one 32-thread CTA per row, 16-byte vectors': 0.0978,
                         'one CTA per row, one bulk copy in and out': 0.0979}


def log(*a):
  print(*a, flush=True)


def nvidia_smi_line() -> str:
  proc = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
  if proc.returncode != 0 or not proc.stdout.strip():
    raise RuntimeError(f'nvidia-smi failed: {proc.stderr.strip()}')
  return proc.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
  """The card's highest SM clock (nvidia-smi's clocks.max.sm), in Hz."""
  proc = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=clocks.max.sm',
       '--format=csv,noheader,nounits'], capture_output=True, text=True,
      timeout=60)
  if proc.returncode != 0 or not proc.stdout.strip():
    raise RuntimeError(f'nvidia-smi failed: {proc.stderr.strip()}')
  return float(proc.stdout.strip().splitlines()[0]) * 1e6


GRAPH_FILES = ('edge_index', 'features', 'labels')


def save_graph(directory: str, *arrays):
  """The script's graph arrays (``make_graph``'s) as .npy files in
  ``directory``, for the spawned children to map (``load_graph``)."""
  for name, a in zip(GRAPH_FILES, arrays):
    np.save(os.path.join(directory, f'{name}.npy'), a)


def load_graph(directory: str):
  """``save_graph``'s arrays, mapped read-only."""
  return tuple(np.load(os.path.join(directory, f'{name}.npy'), mmap_mode='r')
               for name in GRAPH_FILES)


def make_graph(num_nodes: int, avg_deg: int, seed: int = 0):
  """bench.py's synthetic graph: half the edges uniform, half into a
  zipf(1.5) head; features and labels from the same stream."""
  rng = np.random.default_rng(seed)
  e = num_nodes * avg_deg
  rows = rng.integers(0, num_nodes, e)
  cols = np.empty(e, np.int64)
  half = e // 2
  cols[:half] = rng.integers(0, num_nodes, half)
  cols[half:] = rng.zipf(1.5, e - half) % num_nodes
  feats = rng.standard_normal((num_nodes, FEAT_DIM), dtype=np.float32)
  labels = rng.integers(0, CLASSES, num_nodes).astype(np.int32)
  return np.stack([rows, cols]), feats, labels


class ShapeTally:
  """Launches of the kernels never redesigned, by kernel and shape, as
  this process makes them (``TALLY_SHAPES``: the library function, its
  ``launch_counts`` name and the shape read from its arguments). A launch
  outside a capture counts once; one made while a CUDA graph is captured
  counts at each replay of that graph; none counts while ``paused`` (the
  measurement loops of ``timed``). ``install`` puts it over
  ``kernels.lib`` and ``torch.cuda.CUDAGraph``'s capture and replay;
  ``shapes()`` reads it as ``{kernel: {shape: launches}}``."""

  def __init__(self):
    self.counts, self.paused = {}, 0
    self.lock, self.local = threading.Lock(), threading.local()

  def add(self, seen):
    if self.paused:
      return
    with self.lock:
      for kernel, shape in seen:
        per = self.counts.setdefault(kernel, {})
        per[shape] = per.get(shape, 0) + 1

  def launched(self, torch, kernel, shape):
    graph = getattr(self.local, 'graph', None)
    if graph is not None and torch.cuda.is_current_stream_capturing():
      graph._glt_tally.append((kernel, shape))
    else:
      self.add([(kernel, shape)])

  def install(self, torch, kernels):
    tally, lib = self, kernels.lib

    class Lib:
      def __init__(self, handle):
        self.handle = handle

      def __getattr__(self, fn):
        f = getattr(self.handle, fn)
        if fn not in TALLY_SHAPES:
          return f
        kernel, shape_of = TALLY_SHAPES[fn]

        def call(*args):
          err = f(*args)
          if err == 0:
            tally.launched(torch, kernel, shape_of(args))
          return err
        return call

    kernels.lib = lambda name: Lib(lib(name))
    cls = torch.cuda.CUDAGraph
    begin, end, replay = cls.capture_begin, cls.capture_end, cls.replay

    def capture_begin(graph, *a, **kw):
      graph._glt_tally = []
      tally.local.graph = graph
      return begin(graph, *a, **kw)

    def capture_end(graph, *a, **kw):
      tally.local.graph = None
      return end(graph, *a, **kw)

    def graph_replay(graph, *a, **kw):
      tally.add(getattr(graph, '_glt_tally', ()))
      return replay(graph, *a, **kw)

    cls.capture_begin, cls.capture_end, cls.replay = (
        capture_begin, capture_end, graph_replay)

  def shapes(self) -> dict:
    with self.lock:
      return {k: {json.dumps(list(sh)): n for sh, n in per.items()}
              for k, per in self.counts.items()}


# the library functions ShapeTally counts: (launch_counts name, the
# launch's shape from the function's arguments)
TALLY_SHAPES = {
    'glt_uniform_draw': ('uniform_draw', lambda a: (a[1],)),
    'glt_step_keys': ('step_keys', lambda a: (a[2], a[3])),
    'glt_dist_step_keys': ('dist_step_keys', lambda a: (a[2], a[3], a[4])),
    'glt_negative_sample': ('negative_sample', lambda a: (a[7],)),
    'glt_negative_sample_local': ('negative_sample_local', lambda a: (a[8],)),
}
TALLY = ShapeTally()


def timed(torch, fn, reps: int, device, setup=None):
  """(result, device ms, call ms): medians over ``reps`` calls after one
  warm-up call. The device ms is taken between CUDA events with the call
  queued behind a spin kernel (``torch.cuda._sleep``), so the host's
  launch cost does not show; the call ms is taken between events around
  a call made on an idle card, so it does. On the CPU both are the host
  clock. ``setup`` (restoring state a call changes) runs before every
  call, outside the timed span."""
  setup = setup or (lambda: None)
  TALLY.paused += 1
  try:
    return _timed(torch, fn, reps, device, setup)
  finally:
    TALLY.paused -= 1


def _timed(torch, fn, reps, device, setup):
  setup()
  out = fn()
  dev_times, call_times = [], []
  for _ in range(reps):
    if device.type == 'cuda':
      for queued, times in ((True, dev_times), (False, call_times)):
        setup()
        if not queued:
          torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
          torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    else:
      setup()
      t0 = time.perf_counter()
      out = fn()
      dev_times.append((time.perf_counter() - t0) * 1e3)
  call_times = call_times or dev_times
  return out, float(np.median(dev_times)), float(np.median(call_times))


def timed3(torch, fn, reps: int, device):
  """:func:`timed` three times in a row: ``(result, [device ms] * 3,
  [call ms] * 3)``, so a spread inside one call shows apart from the
  spread between calls."""
  runs = [timed(torch, fn, reps, device) for _ in range(3)]
  return runs[-1][0], [r[1] for r in runs], [r[2] for r in runs]


def issue_quotients(instr, clock_hz: float = None, sms: int = H100_SMS):
  """The least ms the card's issue takes for ``instr`` (thread
  instructions by need, ``sass_pipes``' keys), by each limit: the ALU
  pipe's and the FMA pipe's 64 a clock per SM and the schedulers' 128 a
  clock per SM, over ``sms`` SMs at ``clock_hz``. The 2-input adds
  (``either``) go where there is room, which the issue limit covers; of
  the 3-input adds, the share ``y`` that runs as two IMADs each is the
  one that makes the largest quotient least (the quotients are linear
  in ``y``, so the least lies where the falling ALU quotient crosses a
  rising one, or at an end)."""
  rate = sms * (clock_hz or SM_CLOCK_HZ) / 1e3     # SM clocks a ms
  alu, fma, add3, total = (instr.get(k, 0) for k in ('alu', 'fma', 'add3',
                                                     'total'))

  def clocks(y):
    return dict(alu=(alu + add3 - y) / SM_ALU_PER_CLOCK,
                fma=(fma + 2 * y) / SM_FMA_PER_CLOCK,
                issue=(total + y) / SM_ISSUE_PER_CLOCK)

  ys = [0, add3] + [min(max(y, 0), add3) for y in (
      (alu + add3 - fma) / 3, (2 * (alu + add3) - total) / 3)]
  best = min((clocks(y) for y in ys), key=lambda c: max(c.values()))
  return {k: v / rate for k, v in best.items()}


def issue_ms(instr, clock_hz: float = None) -> float:
  """The issue model's least time: the largest of its quotients."""
  return max(issue_quotients(instr, clock_hz).values()) if instr else 0.0


def bound_ms(nbytes: int, instr=None) -> float:
  """The least time for the work: the larger of the bytes over the card's
  memory rate and the issue model's time for the thread instructions
  ``instr`` (``issue_ms``)."""
  return max(nbytes / H100_BYTES_PER_S * 1e3, issue_ms(instr))


def bound_by(nbytes: int, instr=None) -> str:
  return ('bytes' if nbytes / H100_BYTES_PER_S * 1e3 >= issue_ms(instr)
          else 'operations')


def instructions(units: dict) -> dict:
  """Thread instructions by need of ``units`` (``{name: count}``:
  SASS_UNITS' unit ``name`` run ``count`` times), as ``issue_quotients``
  takes them; empty where the SASS was not read (a rehearsal)."""
  out = {}
  for name, n in units.items():
    unit = SASS_UNITS.get(name)
    if unit is None:
      continue
    for need, per in unit.items():
      out[need] = out.get(need, 0) + int(n) * per
  return out


SASS_LINE = re.compile(r'/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?'
                       r'([A-Z][A-Z0-9_.]*)([^;]*);')
# the counted unit of each operation-bound kernel: (library, kernel
# function, how its unit is found in the SASS):
#   'loop'   the loop that stores the output, per store (a drawn word);
#   'all'    the whole kernel (one thread a key, no loop);
#   'search' the grid-stride loop of a candidate, its unrolled search
#            split off: per candidate, and per search round (the gap
#            between the search's exits); 'search+count' also the
#            loop without a store (block thread 0's count of owned rows),
#            per round of that count;
#   'draw'   the least region a forward branch skips that holds a
#            threefry block's 20 funnel shifts (a slot's draw)
SASS_UNIT_SPECS = (
    ('uniform_draw.word', 'uniform_draw', 'uniform_draw_kernel', 'loop'),
    ('step_keys.key', 'step_keys', 'step_keys_kernel', 'all'),
    ('dist_step_keys.key', 'step_keys', 'dist_step_keys_kernel', 'all'),
    ('negative_sample', 'negative_sample', 'negative_sample_kernel',
     'search'),
    ('negative_sample_local', 'negative_sample',
     'negative_sample_local_kernel', 'search+count'),
    ('sample_hop.draw', 'sample_hop', 'hop_slot_kernel', 'draw'),
    ('sample_level.draw', 'sample_level', 'pick_kernel', 'draw'),
)


def sass_functions(text: str) -> dict:
  """``cuobjdump -sass`` output as ``{function: [(address, opcode,
  operands)]}``, NOPs and the dead self-branch after the last EXIT (and
  what follows it) dropped."""
  out, cur = {}, None
  for line in text.splitlines():
    m = re.search(r'Function : (\S+)', line)
    if m:
      cur = out.setdefault(m.group(1), [])
      continue
    m = SASS_LINE.search(line)
    if m and cur is not None and m.group(2) != 'NOP':
      cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
  for ins in out.values():
    for j, (addr, op, arg) in enumerate(ins):
      if op == 'BRA' and _sass_target(arg) == addr:
        del ins[j:]
        break
  return out


def _sass_target(arg: str):
  m = re.fullmatch(r'`?\(?0x([0-9a-f]+)\)?`?', arg.strip())
  return int(m.group(1), 16) if m else None


def sass_need(op: str, arg: str):
  """What SASS instruction ``op`` (``arg`` its operands) needs:
  ``'alu'``, ``'fma'``, ``'either'``, ``'add3'`` (a 3-input add: one ALU
  instruction or two IMADs) or None (the issue only). An IADD3 that
  writes a carry predicate stays on the ALU pipe; one with a zero source
  is a 2-input add."""
  base, _, mods = op.partition('.')
  if base == 'IADD3':
    regs = [a.strip() for a in arg.split(',')][1:]
    carry = bool(regs) and re.fullmatch(r'!?P[0-6T]', regs[0]) is not None
    srcs = [a for a in regs if not re.fullmatch(r'!?U?P[0-6T]', a)][:3]
    if carry:
      return 'alu'
    return 'add3' if sum(a not in ZERO_OPERANDS for a in srcs) > 2 \
        else 'either'
  if base == 'IMAD':
    return 'either' if mods.split('.')[0] in IMAD_EITHER else 'fma'
  if base == 'LEA':
    return 'alu' if mods.startswith('HI') else 'either'
  if base in EITHER_OPCODES:
    return 'either'
  if base in ALU_OPCODES:
    return 'alu'
  return 'fma' if base in FMA_OPCODES else None


def sass_pipes(ins) -> dict:
  """Instructions of ``ins`` by need (``sass_need``): ``alu`` and ``fma``
  (that pipe alone), ``either``, ``add3`` and ``total`` (every one
  issues)."""
  out = dict(alu=0, fma=0, either=0, add3=0, total=len(ins))
  for _, op, arg in ins:
    need = sass_need(op, arg)
    if need is not None:
      out[need] += 1
  return out


def _sass_branches(ins):
  """``(index, target index)`` of each branch to a known address."""
  at = {addr: j for j, (addr, _, _) in enumerate(ins)}
  out = []
  for j, (_, op, arg) in enumerate(ins):
    t = _sass_target(arg) if op == 'BRA' else None
    if t in at:
      out.append((j, at[t]))
  return out


def sass_unit(ins, how: str) -> dict:
  """The counted unit(s) of one kernel's instructions (SASS_UNIT_SPECS):
  ``{suffix: {alu, fma, total}}``."""
  def stores(lo, hi):
    return sum(op.startswith('STG') for _, op, _ in ins[lo:hi + 1])

  branches = _sass_branches(ins)
  loops = [(t, j) for j, t in branches if t <= j]      # [head, branch]
  if how == 'all':
    return {'': sass_pipes(ins)}
  if how == 'draw':
    regions = [ins[j + 1:t] for j, t in branches if t > j]
    regions = [r for r in regions
               if sum(op.startswith('SHF.L.W') for _, op, _ in r) >= 20]
    return {'': sass_pipes(min(regions, key=len))}
  lo, hi = max((lp for lp in loops if stores(*lp)),
               key=lambda lp: lp[1] - lp[0])
  whole = sass_pipes(ins[lo:hi + 1])
  if how == 'loop':
    return {'': {k: v / stores(lo, hi) for k, v in whole.items()}}
  # the search's exits: the loop's forward branches that most share one
  # target
  exits = {}
  for j, t in branches:
    if lo <= j <= hi and t > j:
      exits.setdefault(t, []).append(j)
  ex = max(exits.values(), key=len)
  k = len(ex) // 2
  rnd = sass_pipes(ins[ex[k - 1] + 1:ex[k] + 1])
  out = {'.candidate': {p: whole[p] - len(ex) * rnd[p] for p in whole},
         '.round': rnd}
  if how == 'search+count':
    a, b = min((lp for lp in loops if not stores(*lp)),
               key=lambda lp: lp[1] - lp[0])
    out['.count_round'] = sass_pipes(ins[a:b + 1])
  return out


def sass_unit_counts(texts: dict) -> dict:
  """SASS_UNITS from ``{library: cuobjdump -sass text}``: each spec's
  kernel found by its mangled name (``<length><name>E``)."""
  units = {}
  for name, lib, fn, how in SASS_UNIT_SPECS:
    fns = sass_functions(texts[lib])
    mangled = [k for k in fns if f'{len(fn)}{fn}E' in k]
    if len(mangled) != 1:
      raise RuntimeError(f'SASS of {lib}: {fn} found {len(mangled)} times')
    for suffix, counts in sass_unit(fns[mangled[0]], how).items():
      units[name + suffix] = counts
  return units


def read_sass(kernels) -> dict:
  """``cuobjdump -sass`` of each library SASS_UNIT_SPECS reads, from the
  libraries this run built (``kernels``: graphlearn_tpu_torch.ops.kernels)."""
  tool = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin',
                      'cuobjdump')
  if not os.path.exists(tool):
    tool = shutil.which('cuobjdump')
  if tool is None:
    raise RuntimeError('cuobjdump not found (set CUDA_HOME): the operation '
                       'bounds are counted from the kernels\' SASS')
  procs = {lib: subprocess.Popen([tool, '-sass', str(kernels._lib_path(lib))],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
           for lib in sorted({spec[1] for spec in SASS_UNIT_SPECS})}
  texts = {}
  for lib, proc in procs.items():       # all started together
    out, err = proc.communicate(timeout=120)
    if proc.returncode != 0:
      raise RuntimeError(f'cuobjdump -sass {lib}: {err.strip()}')
    texts[lib] = out
  return texts


def bound_record(nbytes: int, instr, fill: float, ms: float) -> dict:
  """A kernel record's bound fields: ``bound_ms`` / ``bound_by`` from its
  ``nbytes`` and SASS instructions ``instr``, the issue model's
  quotients, the fill floor ``fill`` (``fill_ms``), the yardstick (the
  larger of the bound and the fill) and its share of the kernel's
  ``ms``."""
  bound = bound_ms(nbytes, instr)
  yard = max(bound, fill)
  return dict(bound_ms=bound, bound_by=bound_by(nbytes, instr),
              bytes=nbytes, instructions=instr or None,
              issue_ms=issue_quotients(instr) if instr else None,
              fill_ms=fill, yardstick_ms=yard,
              yardstick_share=yard / ms if ms else None)


def bound_text(rec: dict) -> str:
  """A log line's account of ``bound_record``'s fields."""
  text = (f'bound_ms={rec["bound_ms"]:.6f} ({rec["bound_by"]}: '
          f'{rec["bytes"]} B')
  if rec['instructions']:
    i, q = rec['instructions'], rec['issue_ms']
    text += (f'; SASS instructions: ALU only {i["alu"]:.0f}, FMA only '
             f'{i["fma"]:.0f}, either pipe {i["either"]:.0f}, 3-input adds '
             f'{i["add3"]:.0f}, all {i["total"]:.0f}: ALU pipe '
             f'{q["alu"]:.6f} ms, FMA pipe {q["fma"]:.6f}, issue '
             f'{q["issue"]:.6f} at {SM_CLOCK_HZ / 1e6:.0f} MHz')
  return (text + f') fill_ms={rec["fill_ms"]:.4f} yardstick '
          f'{rec["yardstick_ms"]:.6f} ms, '
          f'{(rec["yardstick_share"] or 0):.1%} of the kernel\'s')


def drawing_slots(deg, seed_mask, k: int) -> int:
  """Slots whose in-kernel draw runs: those of a valid seed with deg > k
  (the rest take j)."""
  return int(((deg > k) & seed_mask).sum()) * k


def fill_ms(torch, outs, device, reps: int) -> float:
  """The fill floor of a kernel whose outputs are ``outs``: ``timed``
  device ms of ``fill_(0)`` on one uint8 tensor of their bytes."""
  nbytes = sum(t.numel() * t.element_size() for t in outs)
  buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)
  return timed(torch, lambda: buf.fill_(0), reps, device)[1]


def _event(torch, cuda):
  if not cuda:
    return time.perf_counter()
  ev = torch.cuda.Event(enable_timing=True)
  ev.record()
  return ev


def _span(a, b, cuda):
  return a.elapsed_time(b) if cuda else (b - a) * 1e3


def kernel_phase(torch, gtt, ds, device, gen, reps, pool):
  """Each kernel against its plain version at main-path shapes."""
  from graphlearn_tpu_torch import ops
  records = {}
  n = ds.graph.num_nodes
  # ---- K1 gather_rows: the collate gather of a products batch, on
  # uniform ids over three tables and on one tree batch's ids (those the
  # multicard phase gives the sharded entry)
  slots = BATCH * (1 + FANOUTS[0] + FANOUTS[0] * FANOUTS[1] +
                   FANOUTS[0] * FANOUTS[1] * FANOUTS[2])
  ids = torch.randint(0, n, (slots,), generator=gen, dtype=torch.int64)
  ids[::97] = -1               # FILL slots
  ids[5::211] = n + 5          # out of range above
  ids[7::389] = -12345         # out of range below
  ids[slots // 2:slots // 2 + slots // 8] = ids[:slots // 8].clone()
  ids = ids.to(torch.int32).to(device)
  f32 = ds.node_features.device_table()[0]
  tree = tree_batch_rows(torch, gtt, ds, np.arange(n), pool, device)
  runs = [(f'f32[{n},100]', f32, ids),
          (f'bf16[{n},100]', f32.to(torch.bfloat16), ids),
          (f'f32[{n},128]', torch.randn((n, 128), generator=gen).to(device),
           ids),
          (f'f32[{n},100] tree batch', f32, tree)]
  cases = []
  for name, table, case_ids in runs:
    got, ms, call_ms = timed(
        torch, lambda: ops.gather_rows_hbm(table, case_ids), reps, device)
    ref, plain_ms, plain_call_ms = timed(
        torch, lambda: ops.gather_rows_plain(table, case_ids), reps, device)
    clamped = case_ids.clamp(0, n - 1).long()
    _, lib_ms, lib_call_ms = timed(
        torch, lambda: torch.index_select(table, 0, clamped), reps, device)
    if device.type == 'cuda':
      torch.cuda.synchronize()
    exact = bool(torch.equal(got, ref))
    err = float((got.float() - ref.float()).abs().max())
    row = table.shape[1] * table.element_size()
    b = case_ids.numel()
    uniq = int(torch.unique(clamped).numel())
    nbytes = b * case_ids.element_size() + uniq * row + b * row
    # every slot's row read and written: the floor of a gather that does
    # not dedup
    every = b * case_ids.element_size() + 2 * b * row
    shape = (ops.gather.gather_rows_shape(table, case_ids)
             if device.type == 'cuda' else None)
    cases.append(dict(table=name, ids=b, unique_rows=uniq, exact=exact,
                      max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      library_ms=lib_ms, call_ms=call_ms,
                      plain_call_ms=plain_call_ms, library_call_ms=lib_call_ms,
                      every_slot_ms=bound_ms(every), launch_shape=shape,
                      **bound_record(nbytes, None, fill_ms(
                          torch, [got], device, reps), ms)))
    log(f'kernel gather_rows {name}: ids={b} exact={exact} '
        f'ms={ms:.4f} plain_ms={plain_ms:.4f} index_select_ms={lib_ms:.4f} '
        f'{bound_text(cases[-1])} every_slot_ms={bound_ms(every):.4f}; call '
        f'ms {call_ms:.4f} {plain_call_ms:.4f} {lib_call_ms:.4f}; launch '
        f'shape {shape}')
    assert exact, f'gather_rows {name}: kernel != plain version'
  records['gather_rows'] = cases
  # ---- K3 the fused hop: hops 0-2 of a products batch, hubs at hop 2
  records['sample_hop'] = [hop_case(torch, gtt, ds.graph, device, gen, reps,
                                    hop) for hop in (2, 0, 1)]
  records['step_keys'] = step_keys_case(torch, gtt, device, reps)
  # the draw of the padded, block and weighted hops and of the padded
  # table's build: hop 2, hop 1 and one word per edge
  records['uniform_draw'] = [
      draw_case(torch, gtt, device, reps, shape)
      for shape in ((BATCH * FANOUTS[0] * FANOUTS[1], FANOUTS[2]),
                    (BATCH * FANOUTS[0], FANOUTS[1]),
                    (ds.graph.num_edges,))]
  # negative sampling's draw and CSR test: a link batch of the
  # unsupervised example (512 negatives) and 64 times that
  records['negative_sample'] = [
      negative_case(torch, gtt, ds.graph, device, reps, num)
      for num in (LINK_BATCH, 64 * LINK_BATCH)]
  return records


def negative_case(torch, gtt, g, device, reps, num):
  """The negative kernel (one launch: the draw and the CSR test of
  ``num * NEG_TRIALS`` candidates) against its plain version (randint's
  uint32 emulation and the 32-round search, ~950 torch ops) on the same
  device key and the card's row-sorted indices, exact; then the whole of
  ``random_negative_sample`` (the kernel and the stable partition)
  against its plain version. The span is the graph's node count (past
  65,536: randint's wrap is live). No PyTorch call computes the function:
  library_ms null."""
  from graphlearn_tpu_torch import ops
  n = g.num_nodes
  total = num * NEG_TRIALS
  sorted_idx = ops.sort_csr_rows(g.indptr, g.indices)
  key = gtt.random.to_device(gtt.random.fold_in(gtt.random.PRNGKey(3), num),
                             device)
  before = ops.launch_counts()['negative_sample']
  got = ops.random_negative_sample(g.indptr, sorted_idx, n, n, num, key,
                                   padding=True)
  per_call = ops.launch_counts()['negative_sample'] - before
  want = ops.random_negative_sample_plain(g.indptr, sorted_idx, n, n, num,
                                          key, padding=True)
  cand, ms, call_ms = timed(torch, lambda: ops.negative.negative_candidates(
      g.indptr, sorted_idx, n, n, total, key), reps, device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: ops.negative.negative_candidates_plain(
          g.indptr, sorted_idx, n, n, total, key), reps, device)
  _, full_ms, full_call_ms = timed(torch, lambda: ops.random_negative_sample(
      g.indptr, sorted_idx, n, n, num, key, padding=True), reps, device)
  _, full_plain_ms, full_plain_call_ms = timed(
      torch, lambda: ops.random_negative_sample_plain(
          g.indptr, sorted_idx, n, n, num, key, padding=True), reps, device)
  exact = all(bool(torch.equal(a, b)) for a, b in zip(cand + got,
                                                       ref + want))
  err = max(float((a.long() - b.long()).abs().max()) for a, b in
            zip(cand + got, ref + want))
  # the search rounds this data needs: the bit length of each drawn
  # row's degree (the loop stops at lo >= hi)
  indptr = g.topo.indptr
  rows = cand[0].cpu().numpy().astype(np.int64)
  deg = (indptr[rows + 1] - indptr[rows]).astype(np.float64)
  rounds = int(np.where(deg > 0, np.floor(np.log2(np.maximum(deg, 1))) + 1,
                        0).sum())
  nbytes = 16 + total * (2 * 4 + 4 + 9) + rounds * 4
  ops_n = instructions({'negative_sample.candidate': total,
                        'negative_sample.round': rounds})
  fill = fill_ms(torch, cand, device, reps)
  valid = int(cand[2].sum())
  rec = dict(num_samples=num, candidates=total, span=n, exact=exact,
             max_abs_err=err, valid_candidates=valid,
             search_rounds=rounds, launches_per_call=per_call, ms=ms,
             call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
             full_ms=full_ms, full_call_ms=full_call_ms,
             full_plain_ms=full_plain_ms,
             full_plain_call_ms=full_plain_call_ms, library_ms=None,
             **bound_record(nbytes, ops_n, fill, ms))
  log(f'kernel negative_sample {total} candidates (span {n}): exact={exact} '
      f'valid={valid} launches/call={per_call} ms={ms:.4f} (call '
      f'{call_ms:.4f}) plain_ms={plain_ms:.4f} (call {plain_call_ms:.4f}) '
      f'{bound_text(rec)}, {rounds} search rounds; with the partition: '
      f'ms={full_ms:.4f} (call {full_call_ms:.4f}) plain_ms='
      f'{full_plain_ms:.4f} (call {full_plain_call_ms:.4f}); library_ms '
      'null (no PyTorch call draws jax.random.randint\'s words)')
  assert exact, f'negative_sample {total}: kernel != plain version'
  assert per_call == (1 if device.type == 'cuda' else 0), per_call
  return rec


def draw_case(torch, gtt, device, reps, shape):
  """The draw kernel (one launch) against ``random.uniform`` (~190 torch
  ops) on the same device key, bit for bit; no PyTorch call computes
  jax.random.uniform's words (``torch.rand`` is Philox): library_ms
  null."""
  from graphlearn_tpu_torch import ops
  key = gtt.random.to_device(gtt.random.fold_in(gtt.random.PRNGKey(2), 9),
                             device)
  before = ops.launch_counts()['uniform_draw']
  got = ops.draw.uniform(key, shape, device)
  per_call = ops.launch_counts()['uniform_draw'] - before
  got, ms, call_ms = timed(torch, lambda: ops.draw.uniform(key, shape,
                                                           device),
                           reps, device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: gtt.random.uniform(key, shape, device), reps, device)
  exact = bool(torch.equal(got, ref))
  n = int(np.prod(shape))
  nbytes = 16 + 4 * n
  ops_n = instructions({'uniform_draw.word': n})
  rec = dict(shape=list(shape), words=n, exact=exact,
             max_abs_err=float((got - ref).abs().max()),
             launches_per_call=per_call, ms=ms, call_ms=call_ms,
             plain_ms=plain_ms, plain_call_ms=plain_call_ms, library_ms=None,
             **bound_record(nbytes, ops_n, fill_ms(torch, [got], device,
                                                   reps), ms),
             bound_at_67t_ms=max(nbytes / H100_BYTES_PER_S,
                                 DRAW_OPS * n / H100_OPS_PER_S) * 1e3)
  log(f'kernel uniform_draw {list(shape)}: exact={exact} launches/call='
      f'{per_call} ms={ms:.4f} (call {call_ms:.4f}) plain_ms={plain_ms:.4f} '
      f'(call {plain_call_ms:.4f}) {bound_text(rec)} (before the recount: '
      f'{DRAW_OPS} operations a word over 67 T/s, '
      f'{rec["bound_at_67t_ms"]:.4f} ms); library_ms null (torch.rand is '
      'Philox, not the same function)')
  assert exact, f'uniform_draw {shape}: kernel != plain version'
  assert per_call == (1 if device.type == 'cuda' else 0), per_call
  return rec


def step_keys_case(torch, gtt, device, reps):
  """The chunk's hop keys (one launch: K = TRAIN_CHUNK steps x the
  fanouts' hops) from a device counter, against ``step_keys_plain`` on
  the same device words, exact; the counts cross 2**32."""
  from graphlearn_tpu_torch import ops
  hops = len(FANOUTS)
  base = gtt.random.to_device(
      gtt.random.fold_in(gtt.random.PRNGKey(0), 7), device)
  counter = torch.full((), 2 ** 32 - 3, dtype=torch.int64, device=device)
  steps = torch.arange(TRAIN_CHUNK, dtype=torch.int64, device=device)
  got, ms, call_ms = timed(
      torch, lambda: ops.step_keys(base, counter, TRAIN_CHUNK, hops), reps,
      device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: gtt.random.step_keys_plain(base, counter + steps, hops),
      reps, device)
  exact = bool(torch.equal(got, ref))
  keys = TRAIN_CHUNK * hops
  nbytes = 2 * 8 + 8 + keys * 2 * 8
  ops_n = instructions({'step_keys.key': keys})
  rec = dict(steps=TRAIN_CHUNK, hops=hops, exact=exact,
             max_abs_err=float((got - ref).abs().max()), ms=ms,
             call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
             **bound_record(nbytes, ops_n, fill_ms(torch, [got], device,
                                                   reps), ms))
  log(f'kernel step_keys: [{TRAIN_CHUNK}, {hops}, 2] keys exact={exact} '
      f'ms={ms:.4f} plain_ms={plain_ms:.4f} {bound_text(rec)}; call ms '
      f'{call_ms:.4f} {plain_call_ms:.4f}')
  assert exact, 'step_keys: kernel != plain version'
  return rec


def hop_case(torch, gtt, g, device, gen, reps, hop):
  """The fused hop (one launch) against its plain version on the same
  device key at hop ``hop`` of a products batch; at hop 2 with 1% hub
  seeds, whose rows in a fabricated copy of the row table point at long
  segments. Timed beside ``indices[epos]``, a partial yardstick (no
  PyTorch call draws and picks)."""
  from graphlearn_tpu_torch import ops
  n = g.num_nodes
  b, k = BATCH * int(np.prod(FANOUTS[:hop])), FANOUTS[hop]
  seeds = torch.randint(0, n, (b,), generator=gen, dtype=torch.int32)
  seed_mask = torch.rand((b,), generator=gen) < (0.97 if hop else 1.0)
  meta = g.csr_meta.clone()
  n_hub = b // 100 if hop == 2 else 0
  if n_hub:
    hub_ids = torch.randperm(n, generator=gen)[:n_hub]
    hdeg = torch.randint(HUB_DEG, 8 * HUB_DEG, (n_hub,), generator=gen)
    hstart = (torch.rand((n_hub,), generator=gen) *
              (g.num_edges - hdeg)).to(torch.int64)
    meta[hub_ids.to(device)] = torch.stack([hstart, hdeg], 1).to(
        torch.int32).to(device)
    at = torch.randperm(b, generator=gen)[:n_hub]
    seeds[at] = hub_ids.to(torch.int32)
    seed_mask[at] = True
  seeds, seed_mask = seeds.to(device), seed_mask.to(device)
  key = gtt.random.to_device(gtt.random.fold_in(gtt.random.PRNGKey(0), 1),
                             device)
  args = (g.indptr, g.indices, None, seeds, seed_mask, k, key)
  before = ops.launch_counts()['sample_hop']
  got = ops.sample_hop_fused(*args, meta=meta)
  per_call = ops.launch_counts()['sample_hop'] - before
  got, ms, call_ms = timed(
      torch, lambda: ops.sample_hop_fused(*args, meta=meta), reps, device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: ops.uniform_sample(g.indptr, g.indices, seeds, seed_mask,
                                        k, key, meta=meta), reps, device)
  safe_long = ref[1].long()
  _, lib_ms, lib_call_ms = timed(
      torch, lambda: g.indices[safe_long], reps, device)
  exact = all(bool(torch.equal(a, r)) for a, r in zip(got, ref))
  err = float((got[0] - ref[0]).abs().max())
  safe = torch.where(seed_mask, seeds, 0)
  rows = meta[safe.long()]
  valid = ref[2]
  # seeds and mask read once, each distinct row and each distinct
  # adjacency element a valid slot picks read once; nbrs, epos (4 B) and
  # mask (1 B) written once per slot
  uniq_rows = int(torch.unique(safe).numel())
  uniq_e = int(torch.unique(ref[1][valid]).numel())
  nbytes = b * 5 + uniq_rows * 8 + uniq_e * 4 + b * k * 9
  drawn = drawing_slots(rows[:, 1], seed_mask, k)
  ops_n = instructions({'sample_hop.draw': drawn})
  rec = dict(hop=hop, seeds=b, k=k, hubs=n_hub, valid_picks=int(valid.sum()),
             unique_rows=uniq_rows, unique_elements=uniq_e, exact=exact,
             max_abs_err=err, launches_per_call=per_call, ms=ms,
             call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
             indexing_ms=lib_ms, indexing_call_ms=lib_call_ms,
             library_ms=None, drawn_slots=drawn,
             **bound_record(nbytes, ops_n, fill_ms(torch, got, device, reps),
                            ms))
  log(f'kernel sample_hop (fused) hop {hop}: seeds={b} k={k} hubs={n_hub} '
      f'exact={exact} launches/call={per_call} ms={ms:.4f} '
      f'(call {call_ms:.4f}) plain_ms={plain_ms:.4f} (call '
      f'{plain_call_ms:.4f}) indices[epos]_ms={lib_ms:.4f} '
      f'{bound_text(rec)} (the draw of {drawn} slots); no single PyTorch '
      'call draws and picks: library_ms null')
  assert exact, f'sample_hop hop {hop}: kernel != plain version'
  assert per_call == (1 if device.type == 'cuda' else 0), per_call
  return rec


def level_launch_count(mode: str, batches: int) -> int:
  """Launches of a path's sampling kernel: one per tree hop; three per
  merge level plus one per batch."""
  levels = len(FANOUTS)
  return batches * (levels if mode == 'tree' else 3 * levels + 1)


def time_level(torch, call, reps, device):
  """(record, outputs): the fused level (three launches on the batch's
  scratch, restored before each call to its state at the level's start)
  against its plain version on the same inputs and device key, timed.
  ``call`` holds the level's arguments as the sampler passed them."""
  from graphlearn_tpu_torch import ops
  a = call['args']
  kw = dict(meta=call['meta'], prefix_cap=call['prefix_cap'],
            max_new=call['max_new'], final=call['final'])
  state0 = call['state']
  work = ops.MergeInducerState(*(t.clone() for t in state0))
  scratch = call['scratch']

  def restore_kernel():
    work.nodes.copy_(state0.nodes)
    if scratch is not None:
      scratch.buf.copy_(call['scratch_buf'])

  def kernel():
    return ops.sample_level_fused(*a[:7], work, a[7], **kw, scratch=scratch)

  plain_state = with_sorted_view(torch, ops, state0)
  state0 = ops.MergeInducerState(state0.nodes, state0.num_nodes,
                                 *plain_state[2:])

  def restore_plain():
    for t, t0 in zip(plain_state, state0):
      t.copy_(t0)

  def plain():
    return ops.sample_level_fused_plain(*a[:2], *a[3:7], plain_state, a[7],
                                        **kw)

  restore_kernel()
  before = ops.launch_counts()['sample_level']
  kernel()
  per_call = ops.launch_counts()['sample_level'] - before
  got, ms, call_ms = timed(torch, kernel, reps, device, restore_kernel)
  ref, plain_ms, plain_call_ms = timed(torch, plain, reps, device,
                                       restore_plain)
  names = ['nodes', 'num_nodes'] + sorted(ref[1]) + ['epos', 'mask']
  pairs = [(got[0].nodes, ref[0].nodes), (got[0].num_nodes, ref[0].num_nodes)]
  pairs += [(got[1][n], ref[1][n]) for n in sorted(ref[1])]
  pairs += [(got[2], ref[2]), (got[3], ref[3])]
  diff = [n for n, (x, y) in zip(names, pairs) if not torch.equal(x, y)]
  err = max(float((x.long() - y.long()).abs().max()) if x.numel() else 0.0
            for x, y in pairs)
  seeds, seed_mask, k = a[3], a[4], a[5]
  f = seeds.shape[0]
  size = f * k
  cap = state0.nodes.shape[0]
  c = min(call['prefix_cap'], cap)
  limit = min(size, cap - c, size if call['max_new'] is None
              else call['max_new'])
  safe = torch.where(seed_mask, seeds, 0)
  rows = call['meta'][safe.long()]
  valid = ref[3]
  uniq_rows = int(torch.unique(safe).numel())
  uniq_e = int(torch.unique(ref[2][valid]).numel())
  nn = int(state0.num_nodes)
  # frontier, its mask and locals read once; each distinct row and
  # adjacency element read once; the buffer's nn ids read once; per
  # candidate epos, cols, rows, frontier, frontier_idx (4 B each) and
  # mask, edge_mask, frontier_mask (1 B each) written once; the append
  # block and the two counts
  nbytes = f * 9 + uniq_rows * 8 + uniq_e * 4 + nn * 4 + size * 23 + \
      limit * 4 + 8
  drawn = drawing_slots(rows[:, 1], seed_mask, k)
  ops_n = instructions({'sample_level.draw': drawn})
  outs = [got[0].nodes, got[2], got[3]] + [
      v for v in got[1].values() if torch.is_tensor(v)]
  rec = dict(frontier=f, k=k, candidates=size, prefix=c, num_nodes=nn,
             limit=limit, valid=int(valid.sum()),
             num_new=int(got[1]['num_new']), exact=not diff, differ=diff,
             max_abs_err=err, launches_per_call=per_call, ms=ms,
             call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
             library_ms=None, drawn_slots=drawn,
             **bound_record(nbytes, ops_n, fill_ms(torch, outs, device, reps),
                            ms))
  return rec, got


def with_sorted_view(torch, ops, state):
  """A copy of ``state`` whose sorted view is rebuilt from its node
  buffer: the kernel route leaves the view stale, and the plain route
  merges against it."""
  nodes = state.nodes
  big = torch.iinfo(nodes.dtype).max
  pos = torch.arange(nodes.shape[0], device=nodes.device)
  key = torch.where((pos < state.num_nodes) & (nodes >= 0), nodes, big)
  order = torch.argsort(key, stable=True)
  ids = key[order]
  loc = torch.where(ids != big, order, -1).to(torch.int32)
  return ops.MergeInducerState(nodes.clone(), state.num_nodes.clone(), ids,
                               loc)


def record_levels(sampler, seeds, key):
  """The fused level's arguments at each level of one sampler call, with
  clones of the state and of the batch's scratch as the level found
  them."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  calls = []
  fused = ops.sample_level_fused

  def record(indptr, indices, blocks128, seeds, seed_mask, k, key, state,
             src_idx, meta=None, *, prefix_cap, max_new=None, final=False,
             scratch=None):
    calls.append(dict(
        args=(indptr, indices, blocks128, seeds.clone(), seed_mask.clone(), k,
              key.clone(), src_idx.clone()),
        state=ops.MergeInducerState(*(t.clone() for t in state)), meta=meta,
        prefix_cap=prefix_cap, max_new=max_new, final=final, scratch=scratch,
        scratch_buf=None if scratch is None else scratch.buf.clone()))
    return fused(indptr, indices, blocks128, seeds, seed_mask, k, key, state,
                 src_idx, meta, prefix_cap=prefix_cap, max_new=max_new,
                 final=final, scratch=scratch)

  ops.sample_level_fused = record
  try:
    sampler.sample_from_nodes(NodeSamplerInput(seeds), batch_cap=BATCH,
                              key=key)
  finally:
    ops.sample_level_fused = fused
  return calls


def level_phase(torch, gtt, loader, device, gen, reps):
  """The fused level at the three levels of one full-width merge batch
  (the sampler's own arguments, state and scratch, recorded on the way),
  and at S > 32,768 with hubs, duplicates, all-found and all-masked
  seeds and truncation."""
  from graphlearn_tpu_torch import ops
  g = loader.sampler.graph
  n = g.num_nodes
  cuda = device.type == 'cuda'
  calls = record_levels(loader.sampler, loader.input_seeds[:BATCH],
                        gtt.random.fold_in(gtt.random.PRNGKey(0), 1))
  assert len(calls) == len(FANOUTS), len(calls)
  records = []
  for i, call in enumerate(calls):
    rec, _ = time_level(torch, call, reps, device)
    records.append(dict(rec, level=i))
    log(f'kernel sample_level (fused) level {i}: F={rec["frontier"]} '
        f'k={rec["k"]} S={rec["candidates"]} c={rec["prefix"]} '
        f'num_nodes={rec["num_nodes"]} limit={rec["limit"]} '
        f'num_new={rec["num_new"]} exact={rec["exact"]} '
        f'launches/call={rec["launches_per_call"]} ms={rec["ms"]:.4f} (call '
        f'{rec["call_ms"]:.4f}) plain_ms={rec["plain_ms"]:.4f} (call '
        f'{rec["plain_call_ms"]:.4f}) {bound_text(rec)} (the draw of '
        f'{rec["drawn_slots"]} slots); no single PyTorch call computes this '
        'function: library_ms null')
    assert rec['exact'], f'sample_level level {i}: differs in {rec["differ"]}'
    assert rec['launches_per_call'] == (3 if cuda else 0), rec
  # ---- an extra call: hubs, duplicates, all-found and all-masked seeds
  b, k = 8192, 10
  seeds = torch.randint(0, n, (b,), generator=gen, dtype=torch.int32)
  seed_mask = torch.rand((b,), generator=gen) < 0.95
  seed_mask[:256] = False                      # all-masked seeds
  seed_mask[256:512] = True
  meta = g.csr_meta.cpu().clone()
  hub = torch.arange(512, 512 + b // 100)      # long fabricated segments
  hub_ids = torch.randperm(n, generator=gen)[:hub.numel()].to(torch.int32)
  seeds[hub] = hub_ids
  seed_mask[hub] = True
  hdeg = torch.randint(HUB_DEG, 8 * HUB_DEG, (hub.numel(),), generator=gen)
  meta[hub_ids.long(), 1] = hdeg.to(torch.int32)
  meta[hub_ids.long(), 0] = (torch.rand((hub.numel(),), generator=gen) *
                             (g.num_edges - hdeg)).to(torch.int32)
  # seeds 256..511: every neighbour already in the buffer (all found);
  # the zipf head repeats ids across the other seeds (duplicates)
  ind = g.indices.cpu()
  rows = meta[seeds[256:512].long()]
  found = torch.cat([ind[int(s0):int(s0 + d)] for s0, d in rows.tolist()])
  prefix = torch.unique(torch.cat([
      found, torch.randint(0, n, (n // 50,), generator=gen,
                           dtype=torch.int32)])).to(torch.int32)
  limit = b * k // 8
  cap = prefix.numel() + limit
  state, _, _, _ = ops.init_node_merge(
      prefix, torch.ones(prefix.numel(), dtype=torch.bool), cap)
  state = ops.MergeInducerState(*(t.to(device) for t in state))
  key = gtt.random.to_device(gtt.random.fold_in(gtt.random.PRNGKey(0), 2),
                             device)
  scratch = None
  if cuda:
    scratch = ops.LevelScratch(n, cap, device).begin(state, prefix.numel())
  call = dict(args=(g.indptr, g.indices, None, seeds.to(device),
                    seed_mask.to(device), k, key,
                    torch.arange(b, dtype=torch.int32, device=device)),
              state=state, meta=meta.to(device), prefix_cap=prefix.numel(),
              max_new=limit, final=False, scratch=scratch,
              scratch_buf=None if scratch is None else scratch.buf.clone())
  rec, got = time_level(torch, call, reps, device)
  cols = got[1]['cols'].view(b, k)
  found_ok = bool(((cols[256:512] >= 0) & (cols[256:512] < prefix.numel()) |
                   ~got[3][256:512]).all())
  rec.update(hubs=hub.numel(), all_found_seeds_found=found_ok,
             unique_picks=int(torch.unique(
                 g.indices[got[2][got[3]].long()]).numel()))
  log(f'kernel sample_level (fused) S={rec["candidates"]} (hubs '
      f'{hub.numel()}, 256 all-masked and 256 all-found seeds): '
      f'exact={rec["exact"]} num_new={rec["num_new"]} limit={rec["limit"]} '
      f'unique_picks={rec["unique_picks"]} of {rec["valid"]} valid '
      f'all_found={found_ok} launches/call={rec["launches_per_call"]} '
      f'ms={rec["ms"]:.4f} (call {rec["call_ms"]:.4f}) '
      f'plain_ms={rec["plain_ms"]:.4f} bound_ms={rec["bound_ms"]:.4f}')
  assert rec['exact'] and found_ok and rec['num_new'] > rec['limit'], rec
  assert bool((cols[:256] == -1).all()), 'masked seeds'
  return dict(levels=records, edge_case=rec)


def make_loader(gtt, ds, pool, device, mode, caps='auto'):
  """The slice's loader: the tree engine, or the merge engine with
  calibrated caps ('auto': calibrated in the loader) and the raise
  guard."""
  if mode == 'tree':
    return gtt.loader.NeighborLoader(ds, FANOUTS, pool, batch_size=BATCH,
                                     shuffle=False, seed=0, dedup='tree',
                                     device=device)
  return gtt.loader.NeighborLoader(ds, FANOUTS, pool, batch_size=BATCH,
                                   shuffle=False, seed=0, dedup='auto',
                                   frontier_caps=caps,
                                   overflow_policy='raise', device=device)


def make_model(torch, gtt, loader, device, gen_seed=None):
  """GraphSAGE with the layered forward that matches the loader's
  layout; weights from ``gen_seed`` (None: left for load_state_dict)."""
  from graphlearn_tpu_torch.models import train
  merge = loader.sampler._dedup_mode() == 'merge'
  if merge:
    no, eo = train.merge_hop_offsets(
        BATCH, FANOUTS, frontier_caps=loader.sampler.frontier_caps)
  else:
    no, eo = train.tree_hop_offsets(BATCH, FANOUTS)
  gen = None if gen_seed is None else torch.Generator().manual_seed(gen_seed)
  model = gtt.models.GraphSAGE(
      FEAT_DIM, HIDDEN, CLASSES, num_layers=len(FANOUTS),
      hop_node_offsets=no, hop_edge_offsets=eo, tree_dense=not merge,
      merge_dense=merge, fanouts=FANOUTS, device=device, generator=gen)
  model.eval()
  return model, no


def slice_phase(torch, gtt, loader, device, gen_seed, num_batches, cpu_ds,
                mode):
  """Sampled inference at full width through the port's entry points;
  returns (per-batch timings, launch counts, eval counts, cross-check)."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  model, no = make_model(torch, gtt, loader, device, gen_seed)
  eval_counts = train.make_eval_counts(model)
  forward = train.make_forward_fn(model)
  cuda = device.type == 'cuda'
  guarded = loader._overflow_guarded()
  assert guarded == (mode == 'merge'), (mode, guarded)

  loader._overflow_epoch_start()
  ops.reset_launch_counts()
  per_batch = []
  correct = total = 0
  check = None
  for i, idx in enumerate(loader._batcher):
    seeds = loader.input_seeds[idx]
    if i == num_batches - 1:
      check = (loader.sampler.state_dict(), seeds)
    e0 = _event(torch, cuda)
    out = loader.sampler.sample_from_nodes(NodeSamplerInput(seeds),
                                           batch_cap=BATCH)
    if guarded:
      loader._accumulate_overflow(out)     # the loader's own guard
    e1 = _event(torch, cuda)
    batch = loader._collate_fn(out)
    e2 = _event(torch, cuda)
    d = train.batch_to_dict(batch)
    c, t = eval_counts(d)
    e3 = _event(torch, cuda)
    if cuda:
      e3.synchronize()
    correct += int(c)
    total += int(t)
    per_batch.append(dict(sample_ms=_span(e0, e1, cuda),
                          collate_ms=_span(e1, e2, cuda),
                          forward_ms=_span(e2, e3, cuda)))
    last = (out, batch, d)
  overflow = loader.check_overflow()
  # one more batch through the loader's own iterator (the user's loop),
  # under its overflow guard
  it_batch = next(iter(loader))
  overflow = overflow or loader.check_overflow()
  counts = ops.launch_counts()
  batches = len(per_batch) + 1
  hop_kernel = 'sample_level' if mode == 'merge' else 'sample_hop'
  other = 'sample_hop' if mode == 'merge' else 'sample_level'
  assert counts[hop_kernel] == (level_launch_count(mode, batches) if cuda
                                else 0), counts
  assert counts[other] == 0, counts
  assert counts['gather_rows'] >= (batches if cuda else 0), counts
  assert not overflow, 'a merge batch overflowed its calibrated caps'
  assert total == BATCH * num_batches, total
  out, batch, d = last
  with torch.no_grad():
    logits = forward(d)
  assert torch.isfinite(logits).all(), 'non-finite logits'
  assert torch.isfinite(batch.x).all() and torch.isfinite(it_batch.x).all()
  assert logits.shape == (no[1], CLASSES), logits.shape
  for name, val in (('node', out.node), ('row', out.row), ('col', out.col)):
    assert int(val.min()) >= -1, name
  cross = cross_check(torch, gtt, cpu_ds, check, model, out, batch, logits,
                      mode, loader.sampler.frontier_caps)
  # device ops of one sampled batch, beside OPS_BEFORE
  seeds = loader.input_seeds[:BATCH]
  prof = profiled(torch, lambda: loader.sampler.sample_from_nodes(
      NodeSamplerInput(seeds), batch_cap=BATCH), 1, device,
                  f'{mode} sample, one batch (before: {OPS_BEFORE[mode]} ops)')
  return per_batch, counts, dict(correct=correct, total=total), cross, prof


def cross_check(torch, gtt, cpu_ds, check, model, out, batch, logits, mode,
                caps):
  """Recompute the last batch on the CPU (plain versions) from the same
  sampler state and compare."""
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  state, seeds = check
  cpu_loader = make_loader(gtt, cpu_ds, seeds, 'cpu', mode, caps)
  cpu_loader.sampler.load_state_dict(state)
  cout = cpu_loader.sampler.sample_from_nodes(NodeSamplerInput(seeds),
                                              batch_cap=BATCH)
  cbatch = cpu_loader._collate_fn(cout)
  cmodel, _ = make_model(torch, gtt, cpu_loader, 'cpu')
  cmodel.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
  with torch.no_grad():
    clog = train.make_forward_fn(cmodel)(train.batch_to_dict(cbatch))
  for name in ('node', 'num_nodes', 'row', 'col', 'edge_mask'):
    assert torch.equal(getattr(out, name).cpu(), getattr(cout, name)), name
  assert torch.equal(out.metadata['overflow'].cpu(), cout.metadata['overflow'])
  assert torch.equal(batch.x.cpu(), cbatch.x), 'x'
  assert torch.equal(batch.y.cpu(), cbatch.y), 'y'
  glog = logits.cpu()
  torch.testing.assert_close(glog, clog, rtol=1e-3, atol=1e-4)
  nseed = int(cout.num_sampled_nodes[0])
  top2 = clog[:nseed].topk(2, dim=-1).values
  gap = top2[:, 0] - top2[:, 1]
  tol = 2 * (1e-4 + 1e-3 * top2[:, 0].abs())
  differ = glog[:nseed].argmax(-1) != clog[:nseed].argmax(-1)
  assert not bool((differ & (gap > tol)).any()), 'seed predictions differ'
  return dict(max_abs_logit_diff=float((glog - clog).abs().max()),
              prediction_ties_differing=int(differ.sum()), seeds=nseed,
              num_nodes=int(cout.num_nodes),
              num_sampled_nodes=[int(c) for c in cout.num_sampled_nodes])


def profile_phases(torch, gtt, ds, device, mode, caps, reps: int = 3):
  """:func:`profiled` over ``reps`` batches of each phase of a sampled
  slice alone. The batches use their own sampler stream."""
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  seeds = np.arange(BATCH)
  loader = make_loader(gtt, ds, seeds, device, mode, caps)
  model, _ = make_model(torch, gtt, loader, device, 0)
  out = loader.sampler.sample_from_nodes(NodeSamplerInput(seeds), BATCH)
  batch = train.batch_to_dict(loader._collate_fn(out))
  eval_counts = train.make_eval_counts(model)
  phases = {
      'sample': lambda: loader.sampler.sample_from_nodes(
          NodeSamplerInput(seeds), batch_cap=BATCH),
      'collate': lambda: loader._collate_fn(out),
      'forward': lambda: eval_counts(batch),
  }
  result = {}
  for name, fn in phases.items():
    fn()
    result[name] = profiled(torch, fn, reps, device, f'{mode} {name}')
  return result


class Batches:
  """``next`` of a loader's iterator ``it`` as a call, going on into a new
  epoch of ``loader`` once ``it`` ends: a profiled window recorded again
  takes more batches than the epoch was sized for. ``it`` is the iterator
  in use, ``rolled`` whether it is a new epoch's; ``first(batch)``, where
  given, sees each batch of the first epoch it hands out."""

  def __init__(self, loader, it, first=None):
    self.loader, self.it, self.first = loader, it, first
    self.rolled = False

  def __call__(self):
    try:
      batch = next(self.it)
    except StopIteration:
      self.it, self.rolled = iter(self.loader), True
      return next(self.it)
    if self.first is not None and not self.rolled:
      self.first(batch)
    return batch


def port_launch_counts() -> dict:
  """The launch counters of the port's kernels the profiler names
  (PORT_KERNELS)."""
  from graphlearn_tpu_torch import ops
  return {k: v for k, v in ops.launch_counts().items() if k in PORT_KERNELS}


def count_verdict(seen: dict, want: dict):
  """``(verdict, short)`` of the profiler's kernel counts ``seen`` against
  the launch counters ``want``: 'over' when some kernel was seen more
  often than launched, else 'short' when some was seen less often, else
  'exact'; ``short`` maps each kernel seen less often to how many
  fewer."""
  if any(seen.get(k, 0) > v for k, v in want.items()) or \
      any(k not in want and c for k, c in seen.items()):
    return 'over', {}
  short = {k: v - seen.get(k, 0) for k, v in want.items()
           if seen.get(k, 0) < v}
  return ('short' if short else 'exact'), short


def record_window(record, label, kernels_of, empty=None, expect=None,
                  reset=None, where=None, drop=None):
  """``record() -> (trace, wall)``, recorded again (at most
  PROFILE_EMPTY_RETRIES times) while the profiler plainly lost records:
  when ``empty(trace)`` (no device event at all), or when ``expect()``
  (the launch counters, read after the window) finds the trace's port
  kernels (``kernels_of(trace)``) short of them and none over. A window
  with a kernel over its counter is never recorded again; a window still
  short after the retries is returned as it is. The caller's check on
  the returned window stays exact. ``reset()`` runs before each new
  recording (what the window changed and the next recording needs put
  back); ``where(trace)`` describes where the device records sit, for
  PROFILE_SHORT_WINDOWS. ``drop(trace)``, where given, takes records out
  of the first recording (a drill: ``PROFILE_DRILLS``). Returns
  ``(trace, wall)``."""
  trace, wall = record()
  drilled = drop is not None
  if drilled:
    trace = drop(trace)
  for _ in range(PROFILE_EMPTY_RETRIES):
    if empty is not None and empty(trace):
      PROFILE_EMPTY_WINDOWS.append(label)
      log(f'profile {label}: the trace holds no device event; recording '
          'the window again')
    elif expect is None:
      break
    else:
      verdict, short = count_verdict(kernels_of(trace), expect())
      if verdict != 'short':
        break
      entry = dict(label=label, short=short, **(where(trace) if where
                                                else {}))
      if drilled:
        entry['drill'] = True
      drilled = False
      PROFILE_SHORT_WINDOWS.append(entry)
      log(f'profile {label}: the profiler counted fewer launches than the '
          f'counters ({entry}); recording the window again')
    if reset is not None:
      reset()
    trace, wall = record()
  return trace, wall


def drop_one_port_record(trace):
  """``trace`` (``trace_records``') less its first device record of a
  port kernel (PORT_KERNELS): a window that lost a record, made on
  purpose."""
  dev, window = trace
  for j, (name, _, _, _) in enumerate(dev):
    if any(_names_kernel(name, f) for fns in PORT_KERNELS.values()
           for f in fns):
      return dev[:j] + dev[j + 1:], window
  return trace


def profiled(torch, fn, reps, device, label, lead_s=PROFILE_LEAD_S,
             warmup=None, expect=None, reset=None):
  """torch.profiler over ``reps`` calls of ``fn`` (warmed up by the
  caller): wall ms per call (host clock, synchronised), device-busy ms
  per call (the union of the kernel and copy intervals the profiler saw),
  device ops per call and the top device consumers. The calls start
  ``lead_s`` after the profiler does (see PROFILE_LEAD_S). ``warmup``:
  a call made in the profiler's warm-up cycle (tracing on, its records
  dropped; ``torch.profiler.schedule``), which takes the window's first
  device records where they get lost (see PROFILE_LEAD_S), before the
  recorded calls. ``expect``: a callable giving the launch counters of
  the port's kernels after the window (``port_launch_counts``); a window
  whose port kernels the profiler counted short of them is recorded
  again (``record_window``), after ``reset()`` where the window changed
  state the next recording needs back (a warm-up that sets the counters
  to 0 needs none)."""
  from torch.profiler import ProfilerActivity, profile, schedule
  cuda = device.type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

  def trace_of(p):
    # the profile's records read raw (``trace_records``); the first
    # window is also read through torch's own events(), and the two must
    # agree on its device records
    trace = trace_records(p.profiler.kineto_results.events(), raw=True)
    if not PROFILE_RAW_CHECK:
      slow = trace_records(p.events(), raw=False)
      PROFILE_RAW_CHECK.append(dict(label=label, raw=len(trace[0]),
                                    events=len(slow[0])))
      assert records_agree(trace, slow), (
          'profiler: the raw device records differ from events()\'s',
          PROFILE_RAW_CHECK)
    return trace

  def record():
    ready = []
    kw = {} if warmup is None else dict(
        schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
        on_trace_ready=lambda p: ready.append(trace_of(p)))
    sync()
    with profile(activities=acts, **kw) as prof:
      if warmup is not None:
        tw = time.perf_counter()
        warmup()
        sync()
        PROFILE_WARMUPS_S.append((label, time.perf_counter() - tw))
      time.sleep(lead_s if cuda else 0)
      if warmup is not None:
        prof.step()              # the warm-up cycle ends: recording starts
        # the same lead again after the switch: a link step's window late
        # in the script lost its first device records (the negative
        # kernel among them) with the lead before the switch only
        time.sleep(lead_s if cuda else 0)
      t0 = time.perf_counter()
      for _ in range(reps):
        fn()
      sync()
      wall = (time.perf_counter() - t0) * 1e3 / reps
      if warmup is not None:
        prof.step()
    return (trace_of(prof) if warmup is None else ready[-1]), wall

  def kernels_of(trace):
    counts = {}
    for name, _, _, _ in trace[0]:
      counts[name] = counts.get(name, 0) + 1
    return kernel_counts(counts)

  # a window with a warm-up whose trace holds no device event at all: the
  # profiler lost the whole window (once in a proof run, a GAT train
  # step's: 0 device ops in 43 ms of wall), not a path that ran no
  # kernel. A window whose port kernels fall short of the counters lost
  # part of its records (C9: a captured dist_scan epoch's trace held 92
  # of its 96 K1 launches). Either is recorded again, warm-up included
  # (at most twice), and every check on the recorded window stands as
  # before
  drill = cuda and expect is not None and label in PROFILE_DRILLS and \
      label not in PROFILE_DRILLED
  if drill:
    PROFILE_DRILLED.append(label)
  trace, wall = record_window(
      record, label, kernels_of,
      empty=(lambda tr: not tr[0]) if cuda and warmup is not None else None,
      expect=expect if cuda else None, reset=reset, where=window_placement,
      drop=drop_one_port_record if drill else None)
  spans, per_name, counts, launches = [], {}, {}, 0
  total, streams = 0.0, set()
  for name, start, end, stream in trace[0]:
    launches += 1
    spans.append((start, end))
    total += end - start
    streams.add(stream)
    per_name[name] = per_name.get(name, 0.0) + (end - start) / 1e3 / reps
    counts[name] = counts.get(name, 0) + 1
  busy, end = 0.0, -1.0
  for a, b in sorted(spans):
    if b > end:
      busy += b - max(a, end)
      end = b
  busy_ms = busy / 1e3 / reps
  top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
  log(f'profile {label}: wall_ms={wall:.3f} device_busy_ms={busy_ms:.3f} '
      f'device_ops/call={launches / reps:.0f} top=' +
      '; '.join(f'{k[:60]}={v:.3f}' for k, v in top))
  return dict(wall_ms=wall, device_busy_ms=busy_ms,
              device_sum_ms=total / 1e3 / reps, device_streams=len(streams),
              idle_share=1 - busy_ms / wall if wall else None,
              device_ops_per_call=launches / reps, top_device_ms=dict(top),
              kernels=kernel_counts(counts),
              # every device kernel whose name holds a port kernel's, as
              # the profiler names it (read where a count disagrees)
              port_kernel_names={k: c for k, c in counts.items() if any(
                  f in k for fns in PORT_KERNELS.values() for f in fns)})


# launch_counts() name -> the device kernels the profiler shows for it
PORT_KERNELS = dict(gather_rows=('gather_rows_kernel',),
                    sample_hop=('hop_slot_kernel',),
                    sample_level=('begin_kernel', 'pick_kernel',
                                  'scan_kernel', 'resolve_kernel'),
                    step_keys=('step_keys_kernel',),
                    dist_step_keys=('dist_step_keys_kernel',),
                    uniform_draw=('uniform_draw_kernel',),
                    negative_sample=('negative_sample_kernel',),
                    negative_sample_local=('negative_sample_local_kernel',))


def _names_kernel(device_name: str, fn: str) -> bool:
  """True when the profiler's ``device_name`` is kernel ``fn`` (its name
  whole: ``dist_step_keys_kernel`` is not ``step_keys_kernel``)."""
  for tail in ('(', '<'):
    at = device_name.find(fn + tail)
    while at >= 0:
      if at == 0 or not (device_name[at - 1].isalnum() or
                         device_name[at - 1] == '_'):
        return True
      at = device_name.find(fn + tail, at + 1)
  return False


# the first profiled window's device records counted both ways (raw and
# through events()): ``trace_records``' one check against torch's reading
PROFILE_RAW_CHECK = []


def trace_records(events, raw: bool):
  """A profile's records as ``(device, (first, last))``: ``device`` the
  device records that are device work, ``(name, start us, end us,
  stream)`` (user annotations, such as the optimizer's
  Optimizer.step#Adam.step, are ranges on the device timeline, not
  work), and the window's first start and last end over every record,
  host or device. ``events``: kineto's raw records (``raw``, read as
  they come: torch's events() first builds a tree of every host op) or
  torch's FunctionEvents."""
  from torch.autograd import DeviceType
  device, first, last = [], None, None
  for e in events:
    if raw:
      name, start, end = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
      kind, stream = e.device_type(), e.device_resource_id()
      note = e.is_user_annotation()
    else:
      name, start, end = e.name, e.time_range.start, e.time_range.end
      kind, stream = e.device_type, getattr(e, 'device_resource_id', None)
      note = getattr(e, 'is_user_annotation', False)
    first = start if first is None else min(first, start)
    last = end if last is None else max(last, end)
    if kind == DeviceType.CUDA and not note and \
        not name.startswith('Optimizer.'):
      device.append((name, start, end, stream))
  return device, (first, last)


def records_agree(a, b) -> bool:
  """Two readings of one profile hold the same device records: the same
  names, each name's durations alike to 1 us (one reading may truncate
  to whole us)."""
  def key(tr):
    return sorted((n, e - s) for n, s, e, _ in tr[0])
  ka, kb = key(a), key(b)
  return len(ka) == len(kb) and all(
      n == m and abs(x - y) <= 1.0 + 1e-6 for (n, x), (m, y) in zip(ka, kb))


def window_placement(trace) -> dict:
  """Where a trace's device records sit in its window (ms from the
  window's first record, host or device): the first and last device
  records, the window's span, the device records by stream, and the
  first and last of each port kernel the trace holds."""
  dev, (t0, t1) = trace
  if t0 is None:
    return {}
  span = (t1 - t0) / 1e3
  if not dev:
    return dict(window_ms=span, device_records=0)
  streams, kern = {}, {}
  for name, start, _, stream in dev:
    streams[str(stream)] = streams.get(str(stream), 0) + 1
    for k, fns in PORT_KERNELS.items():
      if any(_names_kernel(name, f) for f in fns):
        at = (start - t0) / 1e3
        lo, hi = kern.get(k, (at, at))
        kern[k] = (min(lo, at), max(hi, at))
  return dict(window_ms=span, device_records=len(dev),
              first_device_ms=(min(r[1] for r in dev) - t0) / 1e3,
              last_device_ms=(max(r[2] for r in dev) - t0) / 1e3,
              streams=streams,
              port_kernels_ms={k: [round(a, 3), round(b, 3)]
                               for k, (a, b) in kern.items()})


def kernel_counts(counts) -> dict:
  """The profiler's device kernels of the port's training path, counted by
  ``launch_counts()`` name (the whole window, not per call)."""
  return {name: sum(c for k, c in counts.items()
                    if any(_names_kernel(k, f) for f in fns))
          for name, fns in PORT_KERNELS.items()}


def recompute_rows(torch, cmodel, layer, x_self, nbr, x_nbr):
  """One conv layer of ``cmodel`` on the CPU over a block of rows:
  ``x_self [b, F]``, their padded neighbour ids ``nbr [b, W]`` and the
  neighbour rows ``x_nbr [b, W, F]`` read from the card's input store."""
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.serving.materialize import _block_edges
  b, w = nbr.shape
  x = torch.cat([x_self, x_nbr.reshape(b * w, -1)])
  with torch.no_grad():
    return train.make_layer_slice_fn(cmodel, layer, layer + 1)(dict(
        x=x, edge_index=torch.as_tensor(_block_edges(b, w)),
        edge_mask=(nbr >= 0).reshape(-1)))[:b]


def materialize_recorded(torch, mat, check_t):
  """``(table, passes)``: ``mat.materialize()`` with each layer pass
  timed by CUDA events, and per pass the ``check_t`` rows' own input,
  padded neighbour ids, neighbour input rows and output, on the CPU (for
  ``recompute_rows``)."""
  cuda = mat.device.type == 'cuda'
  run_pass, passes = mat._layer_pass, []

  def timed_pass(layer, prev):
    a = _event(torch, cuda)
    out = run_pass(layer, prev)
    b = _event(torch, cuda)
    if cuda:
      b.synchronize()
    nbr = mat._nbr[check_t]
    passes.append(dict(
        layer=layer, ms=_span(a, b, cuda), x_self=prev[check_t].cpu(),
        nbr=nbr.cpu(), x_nbr=prev[nbr.clamp(min=0).long()].cpu(),
        out=out[check_t].cpu()))
    return out

  mat._layer_pass = timed_pass
  try:
    return mat.materialize(), passes
  finally:
    del mat._layer_pass


def serve_requests(rng, n):
  """One client's requests, a synthetic smoke mix (no trace behind it):
  lengths uniform in 1-300 (over 256 they split across the largest
  bucket); 3/4 of them ids from zipf(1.5) % N, 1/4 contiguous ranges, so
  gather v2's full runs occur."""
  reqs = []
  for _ in range(REQUESTS):
    length = int(rng.integers(1, 301))
    if rng.random() < 0.75:
      ids = rng.zipf(1.5, length) % n
    else:
      start = int(rng.integers(0, n - length))
      ids = np.arange(start, start + length)
    reqs.append(ids.astype(np.int64))
  return reqs


def serving_phase(torch, gtt, ds, device, topo, smi, profile):
  """The serving tier at full width through its entry points. Launch
  counters are set to 0 before the materializer and read after the
  engine's last request."""
  from graphlearn_tpu_torch import metrics, ops
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.serving import (EmbeddingMaterializer,
                                            ServingEngine)
  n = topo.num_nodes
  layers = len(FANOUTS)
  cuda = device.type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  model = gtt.models.GraphSAGE(
      FEAT_DIM, HIDDEN, CLASSES, num_layers=layers, device=device,
      generator=torch.Generator().manual_seed(0)).eval()
  cmodel = gtt.models.GraphSAGE(FEAT_DIM, HIDDEN, CLASSES,
                                num_layers=layers, device='cpu').eval()
  cmodel.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
  deg = np.diff(topo.indptr)
  rng = np.random.default_rng(2)
  check = np.concatenate([[0, n - 1, int(deg.argmax())], rng.choice(
      np.arange(1, n - 1), RECHECK_ROWS - 3, replace=False)])
  check_t = torch.as_tensor(check).to(device)
  rep = {}

  # ---- 1. materialize, timing each layer pass
  ops.reset_launch_counts()
  t0 = time.perf_counter()
  mat = EmbeddingMaterializer(ds, model, block_size=SERVE_BLOCK,
                              chunk_size=SERVE_CHUNK)
  sync()
  rep['materializer_setup_s'] = time.perf_counter() - t0
  run_pass = mat._layer_pass
  emb, passes = materialize_recorded(torch, mat, check_t)
  w, n_pad = mat._w, mat.n_pad
  rep['W'], rep['n_pad'] = w, n_pad
  rep['pass_ms'] = [p['ms'] for p in passes]
  rep['node_rows_per_s'] = [n_pad / (p['ms'] / 1e3) for p in passes]
  log(f'serving materialize: N={n} N_pad={n_pad} W={w} block={SERVE_BLOCK} '
      f'chunk={SERVE_CHUNK} ({n_pad // SERVE_BLOCK} blocks of '
      f'{SERVE_BLOCK * (w + 1)} rows); set-up '
      f'{rep["materializer_setup_s"]:.1f}s; ms per layer pass ' +
      ' '.join(f'{m:.2f}' for m in rep['pass_ms']) + '; node rows/s ' +
      ' '.join(f'{r:.4g}' for r in rep['node_rows_per_s']) + f' on {smi}')

  # ---- 2. the table against one direct full-graph forward on the card
  key = np.repeat(np.arange(n, dtype=np.int32), deg)
  ei = torch.as_tensor(np.stack([topo.indices, key])).to(device)
  em = torch.ones(ei.shape[1], dtype=torch.bool, device=device)
  x = ds.node_features.device_table()[0]
  if cuda:
    torch.cuda.reset_peak_memory_stats()
  a = _event(torch, cuda)
  with torch.no_grad():
    direct = train.make_forward_fn(model)(dict(x=x, edge_index=ei,
                                               edge_mask=em))
  b = _event(torch, cuda)
  sync()
  rep['direct_forward_ms'] = _span(a, b, cuda)
  rep['direct_peak_bytes'] = torch.cuda.max_memory_allocated() if cuda else None
  rep['direct_max_abs_diff'] = float((emb[:n] - direct).abs().max())
  torch.testing.assert_close(emb[:n], direct, rtol=1e-3, atol=1e-4)
  del direct, ei, em
  log(f'serving direct full-graph forward: {rep["direct_forward_ms"]:.1f} ms, '
      f'max_memory_allocated {rep["direct_peak_bytes"]} B; table vs direct '
      f'max abs diff {rep["direct_max_abs_diff"]:.3g} (rtol 1e-3, atol 1e-4)')

  # ---- 3. every layer pass recomputed on the CPU at RECHECK_ROWS rows
  rep['recheck_max_abs_diff'] = []
  for p in passes:
    ref = recompute_rows(torch, cmodel, p['layer'], p['x_self'], p['nbr'],
                         p['x_nbr'])
    torch.testing.assert_close(p['out'], ref, rtol=1e-3, atol=1e-4)
    rep['recheck_max_abs_diff'].append(float((p['out'] - ref).abs().max()))
  log(f'serving CPU recompute of {RECHECK_ROWS} rows per layer (node 0, '
      f'N-1, the max-degree node {check[2]} of degree {deg.max()}): max abs '
      'diff ' + ' '.join(f'{d:.3g}' for d in rep['recheck_max_abs_diff']))

  # ---- 4./5. the store routed through gather v2, behind the engine
  store = mat.embedding_store()
  store.set_kernel_routing(use_pallas_v2=True, block_rows=256, run_span=8)
  table = store.table[:n].cpu().numpy()
  client_reqs = [serve_requests(np.random.default_rng(100 + c), n)
                 for c in range(CLIENTS)]
  metrics.reset('serving')
  latencies = [[] for _ in range(CLIENTS)]
  bad, errors = [0] * CLIENTS, []
  engine = ServingEngine(store, buckets=SERVE_BUCKETS, max_wait_ms=2.0,
                         refresh_fn=mat.refresh_rows)

  def client(c):
    try:
      for ids in client_reqs[c]:
        t = time.perf_counter()
        rows = engine.lookup(ids, timeout=120)
        latencies[c].append((time.perf_counter() - t) * 1e3)
        bad[c] += not np.array_equal(rows, table[ids])
    except Exception as exc:  # noqa: BLE001 — reported and failed below
      errors.append(f'client {c}: {type(exc).__name__}: {exc}')

  stale = np.concatenate([np.arange(1, 5), rng.choice(
      np.arange(5, n), STALE_ROWS - 4, replace=False)])
  with engine:
    # warm-up, one lookup per bucket (first use of each device function
    # loads its module); counted in the launches, not in the latencies
    for cap in SERVE_BUCKETS:
      engine.lookup(np.arange(cap))
    warm = metrics.snapshot()['counters']
    base = ops.launch_counts()
    metrics.reset('serving')
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(600)
    rep['clients_wall_s'] = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), 'a client hung'
    assert not errors, errors
    snap = metrics.snapshot()
    mid = ops.launch_counts()
    # ---- 6. poison, mark stale, serve the refresh
    store.update_rows(stale, np.full((STALE_ROWS, CLASSES), 1e9, np.float32))
    engine.mark_stale(stale)
    fresh = engine.lookup(stale)
    stale_left = engine.stale_count()
  counts = ops.launch_counts()
  end = metrics.snapshot()
  sent = CLIENTS * REQUESTS
  assert sum(bad) == 0, f'{sum(bad)} responses differ from the table'
  assert snap['counters']['serving.requests'] == sent, snap['counters']
  # one gather-v2 launch per engine batch (none on the CPU: plain version)
  per = 1 if cuda else 0
  assert mid['gather_runs'] - base['gather_runs'] == \
      per * snap['counters']['serving.batches'], (mid, base, snap['counters'])
  assert counts['gather_runs'] == per * (
      warm['serving.batches'] + end['counters']['serving.batches']), (
          counts, warm, end['counters'])
  assert counts['sample_hop'] == counts['sample_level'] == 0, counts
  assert counts['gather_rows'] >= per * len(passes) * (n_pad // SERVE_BLOCK), \
      counts
  assert stale_left == 0 and end['counters']['serving.refreshed'] == \
      STALE_ROWS, (stale_left, end['counters'])
  pen = mat._penultimate
  st = torch.as_tensor(stale).to(device)
  nbr = mat._nbr[st]
  ref = recompute_rows(torch, cmodel, layers - 1, pen[st].cpu(), nbr.cpu(),
                       pen[nbr.clamp(min=0).long()].cpu())
  torch.testing.assert_close(torch.as_tensor(fresh), ref, rtol=1e-3,
                             atol=1e-4)
  assert np.isfinite(fresh).all() and fresh.shape == (STALE_ROWS, CLASSES)
  lat = np.concatenate([np.asarray(v) for v in latencies])
  hist = end['histograms']
  fill = hist['serving.batch_fill']
  rep.update(
      launches=counts, requests=sent, batches=snap['counters'][
          'serving.batches'], refreshed=STALE_ROWS,
      refresh_max_abs_diff=float((torch.as_tensor(fresh) - ref).abs().max()),
      client_p50_ms=float(np.percentile(lat, 50)),
      client_p90_ms=float(np.percentile(lat, 90)),
      client_p99_ms=float(np.percentile(lat, 99)),
      client_max_ms=float(lat.max()), client_latencies_ms=lat.tolist(),
      warmup_batches=warm['serving.batches'],
      total_ms=metrics.histogram('serving.total_ms').percentiles(),
      compute_ms=metrics.histogram('serving.compute_ms').percentiles(),
      queue_wait_ms=metrics.histogram('serving.queue_wait_ms').percentiles(),
      mean_fill=fill['sum'] / fill['count'],
      requests_per_s=sent / rep['clients_wall_s'])
  log(f'serving engine: {sent} requests from {CLIENTS} threads in '
      f'{rep["clients_wall_s"]:.2f}s, all equal to the table; batches '
      f'{rep["batches"]}, mean fill {rep["mean_fill"]:.3f}; launches '
      f'{counts} (gather_runs == batches incl. the refresh lookup); '
      f'refresh of {STALE_ROWS} poisoned rows max abs diff '
      f'{rep["refresh_max_abs_diff"]:.3g} on {smi}')
  log(f'serving latency (ms): client p50 {rep["client_p50_ms"]:.3f} p90 '
      f'{rep["client_p90_ms"]:.3f} p99 {rep["client_p99_ms"]:.3f} max '
      f'{rep["client_max_ms"]:.3f}; serving.total_ms p50 '
      f'{rep["total_ms"]["p50"]:.3f} p99 {rep["total_ms"]["p99"]:.3f}; '
      f'compute_ms p50 {rep["compute_ms"]["p50"]:.3f} p99 '
      f'{rep["compute_ms"]["p99"]:.3f} on {smi}')
  if profile:
    h1 = run_pass(0, mat._x0)
    run_pass(1, h1)
    reqs = [r[:256] for r in client_reqs[0][:50]]
    with ServingEngine(store, buckets=SERVE_BUCKETS,
                       max_wait_ms=2.0) as eng:
      eng.lookup(reqs[0])
      rep['profile'] = dict(layer_pass_1=profiled(
          torch, lambda: run_pass(1, h1), 1, device, 'serving layer pass 1'))
      b0 = metrics.snapshot()['counters']['serving.batches']
      prof = profiled(torch, lambda: [eng.lookup(r) for r in reqs], 1,
                      device, 'serving 50 engine lookups (routed store)')
      nb = metrics.snapshot()['counters']['serving.batches'] - b0
      prof.update(batches=nb,
                  device_ops_per_batch=prof['device_ops_per_call'] / nb)
      rep['profile']['engine_50_batches'] = prof
      log(f'profile serving engine: {nb} batches, '
          f'{prof["device_ops_per_batch"]:.1f} device ops per routed batch')
    del h1
  return rep, store.table


def gather_runs_phase(torch, table, n, device, reps, probe_rows,
                      profile=False):
  """The gather-v2 kernel against its plain version (exact, and against
  index_select), with K1 and index_select on the same ids: at the
  engine's caps over the served table, and at the JAX probe shape.
  Returns (records, profiles): with ``profile``, torch.profiler over 10
  calls of each of the three at the largest cap and on the probe's random
  ids."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.ops import gather
  rng = np.random.default_rng(3)
  records = []

  def case(name, tab, ids_np, presorted=False):
    ids = torch.as_tensor(ids_np.astype(np.int32)).to(device)
    b = ids.numel()
    got, ms, call_ms = timed(torch, lambda: ops.gather_rows_hbm2(
        tab, ids, 256, 8, presorted), reps, device)
    ref, plain_ms, plain_call_ms = timed(torch, lambda: (
        ops.gather_rows_hbm2_plain(tab, ids, 256, 8, presorted)), reps,
                                         device)
    clamped = ids.clamp(0, tab.shape[0] - 1).long()
    lib, lib_ms, lib_call_ms = timed(
        torch, lambda: torch.index_select(tab, 0, clamped), reps, device)
    _, k1_ms, k1_call_ms = timed(
        torch, lambda: ops.gather_rows_hbm(tab, ids), reps, device)
    if device.type == 'cuda':
      torch.cuda.synchronize()
    exact = bool(torch.equal(got, ref)) and bool(torch.equal(got, lib))
    err = float((got.float() - ref.float()).abs().max())
    # the share of slots that runs copy: in the JAX plan (over the sorted
    # ids) and in the kernel's own plan (caller order, inside each tile),
    # whose torch mirror must equal what the kernel planned
    plan, _, span = gather._sorted_plan(tab.shape[0], ids, 256, 8, presorted)
    kind, _ = ops.decode_gather_plan(plan[:b])
    run_share = float((kind != 0).float().mean())
    tiles = ops.plan_runs_in_tiles(ids, tab.shape[0], 256, 8)
    tile_share = float((ops.decode_gather_plan(tiles)[0] != 0).float().mean())
    if device.type == 'cuda':
      own = torch.empty_like(tiles)
      gather._gather_runs_launch(tab, ids, 256, 8, plan_out=own)
      plan_equal = bool(torch.equal(own, tiles))
    else:
      plan_equal = None
    row = tab.shape[1] * tab.element_size()
    uniq = int(torch.unique(clamped).numel())
    # What table[clip(ids)] must move, whatever the design: the ids read
    # once, each distinct row read once, every output row written once.
    # The plan and the sort's perm belong to this kernel, not the function.
    nbytes = b * ids.element_size() + uniq * row + b * row
    rec = dict(case=name, table=f'{tuple(tab.shape)} {tab.dtype}', ids=b,
               presorted=presorted, unique_rows=uniq, run_share=run_share,
               tile_run_share=tile_share, kernel_plan_equal=plan_equal,
               exact=exact, max_abs_err=err, ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, plain_call_ms=plain_call_ms,
               library_ms=lib_ms, library_call_ms=lib_call_ms,
               k1_ms=k1_ms, k1_call_ms=k1_call_ms,
               **bound_record(nbytes, None, fill_ms(torch, [got], device,
                                                    reps), ms))
    records.append(rec)
    log(f'kernel gather_runs {name}: ids={b} table={rec["table"]} '
        f'presorted={presorted} run_share jax_plan={run_share:.3f} '
        f'kernel_tiles={tile_share:.3f} (kernel plan == mirror: '
        f'{plan_equal}) exact={exact} '
        f'ms={ms:.4f} plain_ms={plain_ms:.4f} index_select_ms={lib_ms:.4f} '
        f'k1_ms={k1_ms:.4f} {bound_text(rec)}; call ms '
        f'{call_ms:.4f} {plain_call_ms:.4f} {lib_call_ms:.4f} {k1_call_ms:.4f}')
    assert exact, f'gather_runs {name}: kernel != plain version'
    assert plan_equal is not False, f'gather_runs {name}: kernel plan != mirror'

  def profile_case(name, tab, ids_np):
    ids = torch.as_tensor(ids_np.astype(np.int32)).to(device)
    clamped = ids.clamp(0, tab.shape[0] - 1).long()
    for label, fn in (
        ('gather_runs', lambda: ops.gather_rows_hbm2(tab, ids, 256, 8)),
        ('K1 gather_rows', lambda: ops.gather_rows_hbm(tab, ids)),
        ('index_select', lambda: torch.index_select(tab, 0, clamped))):
      fn()
      profiles.append(dict(case=name, call=label, **profiled(
          torch, lambda: [fn() for _ in range(10)], 1, device,
          f'gather_runs phase {name}: 10 x {label}')))

  profiles = []
  for cap in SERVE_BUCKETS:
    reqs = serve_requests(rng, n)
    ids = np.concatenate(reqs)[:cap]
    case(f'serve cap {cap}', table, ids)
  if profile:
    profile_case(f'serve cap {SERVE_BUCKETS[-1]}', table, ids)
  probe = torch.randn((probe_rows, 128), device=device, generator=(
      torch.Generator(device).manual_seed(5)))
  chunks = min(PROBE_CHUNKS, probe_rows // 128 // 2)
  starts = np.sort(rng.choice(probe_rows // 128, chunks, replace=False)) * 128
  ids = (starts[:, None] + np.arange(128)[None, :]).reshape(-1)
  b = ids.size
  case('probe chunks presorted', probe, ids, presorted=True)
  case('probe chunks', probe, ids)
  c0 = int(rng.integers(0, probe_rows - b))
  for name, dist in (
      ('random', rng.integers(0, probe_rows, b)),
      ('dup', rng.choice(rng.integers(0, probe_rows, b // 16), b)),
      ('runs', np.arange(c0, c0 + b))):
    case(f'probe {name}', probe, dist)
    if profile and name == 'random':
      profile_case('probe random', probe, dist)
  return records, profiles


def count_syncs(torch, fn):
  """(fn's result, synchronising CUDA calls made inside it, {message:
  count}): runs ``fn`` under ``torch.cuda.set_sync_debug_mode('warn')``
  and counts its warnings (the mode sees the synchronising calls PyTorch
  makes, not a wait inside a kernel; the mode's own notice that it is a
  prototype is not a sync). The cyclic garbage collector is off in the
  window: a CUDA graph it freed there (a trainer in a reference cycle)
  would count the synchronising release of its memory pool."""
  import gc
  import warnings
  collecting = gc.isenabled()
  gc.disable()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    torch.cuda.set_sync_debug_mode('warn')
    try:
      out = fn()
    finally:
      torch.cuda.set_sync_debug_mode(0)
      if collecting:
        gc.enable()
  kinds = {}
  for w in caught:
    msg = str(w.message).splitlines()[0][:120]
    if 'synchroniz' in msg.lower() and 'prototype' not in msg:
      kinds[msg] = kinds.get(msg, 0) + 1
  return out, sum(kinds.values()), kinds


class LeakyReluInputs:
  """The handle that stands for a hook on every leaky_relu input (the
  attention logits of the GAT convs, plain and typed): until
  :meth:`remove`, each ``torch.nn.functional.leaky_relu`` call first
  calls ``fn(('leaky', i), input)``, ``i`` counting the calls, and takes
  a returned tensor as its input."""

  def __init__(self, fn):
    import torch.nn.functional as F
    self.functional, self.plain = F, F.leaky_relu
    seen, plain = [0], self.plain

    def leaky_relu(input, negative_slope=0.01, inplace=False):
      r = fn(('leaky', seen[0]), input)
      seen[0] += 1
      return plain(input if r is None else r, negative_slope, inplace)

    F.leaky_relu = leaky_relu

  def remove(self):
    self.functional.leaky_relu = self.plain


def relu_input_hooks(model, fn) -> list:
  """Hooks on the inputs of ``model``'s kinks at 0: :func:`relu_hooks`
  (its ReLU inputs, ``fn(layer, z)``) and :class:`LeakyReluInputs` (its
  leaky_relu inputs, ``fn(('leaky', i), z)``); a returned tensor replaces
  the input. Returns the hook handles."""
  return relu_hooks(model, fn) + [LeakyReluInputs(fn)]


def recorder(pre: dict):
  """A :func:`relu_input_hooks` ``fn`` that keeps a copy of each input in
  ``pre`` under its key."""
  return lambda key, z: pre.__setitem__(key, z.detach().clone())


def relu_hooks(model, fn) -> list:
  """Forward hooks on ``model``'s conv layers whose outputs go through a
  ReLU (all but the last): each calls ``fn(layer, output)``, and a
  returned tensor replaces the output. A typed model's layers
  (``hetero{l}``) give a dict by node type: ``fn`` sees each type's
  tensor in turn (types sorted, layers in order), ``layer`` counting
  them. HGT's ReLU inputs are its input projections (``lin_{t}``), the
  SEAL DGCNN's its ``conv1``, ``conv2`` and ``mlp1``, ``layer`` counting
  the calls; GAT has none (its ELU is smooth at 0; its attention's
  leaky_relu is :class:`LeakyReluInputs`'). Returns the hook handles."""
  kind = type(model).__name__
  if getattr(model, 'relu_hooks_by_call', False):
    # several forwards a step (the distributed example's shards): layer
    # counts the hook calls, across the forwards
    kind = 'by_call'
  if kind in ('HGT', 'DGCNN', 'GAT', 'by_call'):
    seen = [0]

    def counted(o):
      r = fn(seen[0], o)
      seen[0] += 1
      return r

    mods = ([m for n, m in model.named_children() if n.startswith('lin_')]
            if kind == 'HGT' else
            [model.conv1, model.conv2, model.mlp1] if kind == 'DGCNN' else
            [getattr(model, f'conv{l}') for l in range(model.num_layers - 1)]
            if kind == 'by_call' else [])
    return [m.register_forward_hook(lambda m_, i, o: counted(o))
            for m in mods]
  if not hasattr(model, 'conv0'):
    seen = [0]

    def typed(o):
      out = {}
      for t in sorted(o):
        r = fn(seen[0], o[t])
        seen[0] += 1
        out[t] = o[t] if r is None else r
      return out

    return [getattr(model, f'hetero{l}').register_forward_hook(
        lambda m, i, o: typed(o)) for l in range(model.num_layers - 1)]
  return [getattr(model, f'conv{l}').register_forward_hook(
      lambda m, i, o, l=l: fn(l, o)) for l in range(model.num_layers - 1)]


def cpu_step_readings(torch, gtt, loader, model, check, loss,
                      cpu_model=None, make_step=None) -> dict:
  """The card's train step ``check = (params, Adam state, batch, card
  gradients, card ReLU and leaky_relu inputs by relu_input_hooks' key)``
  against the CPU's, which follows the card's side of 0 at every ReLU
  and leaky_relu input (the two devices round in other orders, so an
  input within rounding of 0 can fall on opposite sides, and that one
  unit then moves a whole seed's share of the gradients: a leaky_relu's
  slope is 1 on one side, 0.2 on the other): the inputs (largest abs
  difference, the keys outside PRE_RTOL / PRE_ATOL, the ReLU and the
  leaky_relu inputs on opposite sides and the largest of them), the
  loss, the gradients (largest abs difference as a share of
  each tensor's largest CPU gradient, the tensors outside rtol 1e-3 and
  GRAD_SHARE), the CPU's Adam step on the card's gradients against the
  card's updated ``model`` (largest abs difference, the tensors outside
  ADAM_RTOL / ADAM_ATOL), and, recorded only, the CPU's plain step (its
  own side of 0 everywhere): its gradients' largest share and its
  updated parameters against the card's (largest abs difference).
  ``cpu_model()`` builds the CPU model (default: ``make_model``'s for
  ``loader``) and ``make_step(model)`` its train step (default: the node
  classification step)."""
  import copy

  from graphlearn_tpu_torch.models import train
  msd, osd, cbatch, grads, pre = check
  cpu_model = cpu_model or (lambda: make_model(torch, gtt, loader, 'cpu')[0])
  make_step = make_step or (lambda m: train.make_train_step(m, CLASSES))

  def cpu_state():
    cmodel = cpu_model()
    cmodel.train()
    cmodel.load_state_dict({k: v.cpu() for k, v in msd.items()})
    cstate = train.create_train_state(cmodel, lr=LR)
    # a copy: on the CPU the optimizer would step osd's own tensors
    cstate.optimizer.load_state_dict(copy.deepcopy(osd))
    for group in cstate.optimizer.param_groups:  # the card's was capturable
      group['capturable'] = False
    return cmodel, cstate

  cpu_pre = {}
  tiny = torch.finfo(torch.float32).tiny

  def card_side(key, z):
    # the value z + (t - z), gradient 1: t = z where the devices agree;
    # else t on the card's side, |z| (> 0: z + 2|z| = |z| exactly, where
    # a t near 0 would cancel to 0) or, below, -1 at a ReLU (ReLU 0,
    # gradient 0) and -|z| at a leaky_relu (z - 2z = -z exactly, a value
    # within rounding of the card's)
    cpu_pre[key] = zd = z.detach().clone()
    below = (-zd.abs() if isinstance(key, tuple) else zd.new_tensor(-1.0))
    return z + (torch.where(pre[key] > 0, zd.abs().clamp(min=tiny), below)
                - zd)

  cmodel, cstate = cpu_state()
  hooks = relu_input_hooks(cmodel, card_side)
  cstep, _ = make_step(cmodel)
  cstate, closs, _ = cstep(cstate, cbatch)
  for h in hooks:
    h.remove()
  pmodel, pstate = cpu_state()
  make_step(pmodel)[0](pstate, cbatch)
  amodel, astate = cpu_state()
  for p, g in zip(amodel.parameters(), grads):
    p.grad = None if g is None else g.clone()
  astate.optimizer.step()
  out = dict(loss=float(loss), cpu_loss=float(closs), pre_diff=0.0,
             pre_fail=[], opposite=0, leaky_opposite=0, opposite_max_abs=0.0,
             leaky_inputs=0, leaky_zero=0, leaky_near0=0, leaky_gap=0.0,
             grad_share=0.0, grad_fail=[], adam_diff=0.0, adam_fail=[],
             plain_grad_share=0.0, max_abs_param_diff=0.0)
  assert pre.keys() == cpu_pre.keys(), (list(pre), list(cpu_pre))
  for key, z in pre.items():
    cz = cpu_pre[key]
    assert z.shape == cz.shape, (key, z.shape, cz.shape)
    if isinstance(key, tuple):
      out['leaky_inputs'] += z.numel()
      # 0 on both devices (a zero row's logit) cannot flip
      both0 = (z == 0) & (cz == 0)
      out['leaky_zero'] += int(both0.sum())
      out['leaky_near0'] += int(((z.abs() < LEAKY_NEAR0) & ~both0).sum())
      out['leaky_gap'] += float((z - cz).abs().double().sum())
    if z.numel():     # an empty input (a hierarchical layer's empty part)
      out['pre_diff'] = max(out['pre_diff'], float((z - cz).abs().max()))
    if not torch.allclose(z, cz, rtol=PRE_RTOL, atol=PRE_ATOL):
      out['pre_fail'].append(key)
    opp = (z > 0) != (cz > 0)
    out['leaky_opposite' if isinstance(key, tuple) else 'opposite'] += int(
        opp.sum())
    if opp.any():
      out['opposite_max_abs'] = max(out['opposite_max_abs'], float(
          torch.maximum(z[opp].abs(), cz[opp].abs()).max()))
  # a logit flips where |z| is below its card-CPU gap: expected flips =
  # the density of |z| at 0 (count per unit) times the mean gap
  out['leaky_gap'] /= max(out['leaky_inputs'], 1)
  out['leaky_expected_flips'] = (out['leaky_near0'] / (2 * LEAKY_NEAR0) *
                                 out['leaky_gap'])
  names = [n for n, _ in model.named_parameters()]
  for name, p, g, cp, ap, pp in zip(
      names, model.parameters(), grads, cmodel.parameters(),
      amodel.parameters(), pmodel.parameters()):
    if g is None:
      # a parameter whose output the loss never reads (a typed model's
      # conv of a type the head does not read): no gradient on either
      # device, and no Adam step
      assert cp.grad is None and pp.grad is None, name
      assert torch.equal(p.detach().cpu(), ap.detach()), name
      continue
    cg, p = cp.grad, p.detach().cpu()
    scale = float(cg.abs().max())
    out['grad_share'] = max(out['grad_share'], float(
        (g - cg).abs().max()) / scale if scale else 0.0)
    out['plain_grad_share'] = max(out['plain_grad_share'], float(
        (g - pp.grad).abs().max()) / scale if scale else 0.0)
    if not torch.allclose(g, cg, rtol=1e-3, atol=GRAD_SHARE * scale):
      out['grad_fail'].append(name)
    out['adam_diff'] = max(out['adam_diff'],
                           float((p - ap.detach()).abs().max()))
    if not torch.allclose(p, ap.detach(), rtol=ADAM_RTOL, atol=ADAM_ATOL):
      out['adam_fail'].append(name)
    out['max_abs_param_diff'] = max(out['max_abs_param_diff'], float(
        (p - pp.detach()).abs().max()))
  return out


def cpu_step_check(torch, gtt, loader, model, check, loss, **kw) -> dict:
  """:func:`cpu_step_readings` (``kw``: its model and step), held: the
  ReLU and leaky_relu inputs within their tolerance, the loss within rtol 1e-4, no
  tensor outside its gradient or Adam tolerance."""
  c = cpu_step_readings(torch, gtt, loader, model, check, loss, **kw)
  assert not c['pre_fail'], ('ReLU or leaky_relu inputs differ from the '
                             'CPU\'s', c)
  torch.testing.assert_close(torch.tensor(c['loss']),
                             torch.tensor(c['cpu_loss']), rtol=1e-4, atol=0)
  assert not c['grad_fail'], ('gradients differ from the CPU\'s', c)
  assert not c['adam_fail'], ('the Adam step differs from the CPU\'s', c)
  return c


def train_phase(torch, gtt, ds, device, mode, caps, pool, steps, chunk,
                smi, profile):
  """Training at full width through the port's two entry points: the
  products example's per-step loop (loader -> batch_to_dict ->
  train_step) over ``pool`` in order, then one ScanTrainer epoch over the
  same pool from a copy of the same starting state. Launch counters are
  set to 0 before each and read after."""
  import copy

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  loader = make_loader(gtt, ds, pool, device, mode, caps)
  model, _ = make_model(torch, gtt, loader, device, 0)
  model.train()
  start = copy.deepcopy(model.state_dict())
  state = train.create_train_state(model, lr=LR)
  step_fn, _ = train.make_train_step(model, CLASSES)
  rep = {}

  # ---- 1. the per-step loop, timed by CUDA events
  ops.reset_launch_counts()
  per_step, losses, seeds, check = [], [], [], None
  it = iter(loader)
  for i in range(steps):
    if cuda and i == 1:
      torch.cuda.reset_peak_memory_stats()
    e0 = _event(torch, cuda)
    batch = next(it)
    e1 = _event(torch, cuda)
    d = train.batch_to_dict(batch)
    if i == steps - 1:     # the step recomputed on the CPU below
      check = (copy.deepcopy(model.state_dict()),
               copy.deepcopy(state.optimizer.state_dict()),
               {k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in d.items()})
      pre = {}
      hooks = relu_input_hooks(model, recorder(pre))
    state, loss, acc = step_fn(state, d)
    e2 = _event(torch, cuda)
    if cuda:
      e2.synchronize()
    if i == steps - 1:
      for h in hooks:
        h.remove()
      check += ([p.grad.detach().cpu() for p in model.parameters()],
                {k: z.cpu() for k, z in pre.items()})
    per_step.append(dict(sample_collate_ms=_span(e0, e1, cuda),
                         train_ms=_span(e1, e2, cuda)))
    losses.append(loss)
    seeds.append(batch.batch)
  peak = torch.cuda.max_memory_allocated() if cuda else None
  for _ in it:             # the iterator's end: the overflow guard's check
    raise AssertionError('the pool holds more batches than steps')
  counts = ops.launch_counts()
  losses = torch.stack(losses)
  assert bool(torch.isfinite(losses).all()), 'non-finite loss'
  hop = 'sample_level' if mode == 'merge' else 'sample_hop'
  per = 1 if cuda else 0
  assert counts[hop] == per * level_launch_count(mode, steps), counts
  assert counts['gather_rows'] == per * steps, counts
  assert counts['sample_hop' if mode == 'merge' else 'sample_level'] == 0
  assert not loader.check_overflow(), 'a merge batch overflowed its caps'
  steady = per_step[1:] or per_step
  med = {k: float(np.median([p[k] for p in steady])) for k in steady[0]}
  rep.update(per_step=per_step, median_step_ms=med, peak_step_bytes=peak,
             launches=counts, losses=losses.tolist())
  log(f'train {mode} per-step loop: {steps} steps; launches {counts}; '
      f'median after the first step (ms): ' +
      ' '.join(f'{k}={v:.3f}' for k, v in med.items()) +
      f' total={sum(med.values()):.3f}; max_memory_allocated over steps '
      f'2-{steps} {peak} B; losses {losses[0]:.4f} -> {losses[-1]:.4f} on '
      f'{smi}')

  # ---- 2. the last step once more on the CPU, from the same state
  rep['cpu_check'] = cpu_step_check(torch, gtt, loader, model, check,
                                    losses[-1])
  c = rep['cpu_check']
  log(f'train {mode} CPU recompute of step {steps}: ReLU inputs max abs '
      f'diff {c["pre_diff"]:.3g} (rtol {PRE_RTOL}, atol {PRE_ATOL}), '
      f'{c["opposite"]} on opposite sides of 0 (leaky_relu inputs '
      f'{c["leaky_opposite"]}; largest '
      f'{c["opposite_max_abs"]:.3g}); loss {c["cpu_loss"]:.6f} '
      f'vs {c["loss"]:.6f} (rtol 1e-4); gradients max abs diff '
      f'{c["grad_share"]:.3g} of the tensor\'s largest (limit {GRAD_SHARE}); '
      f'CPU Adam on the card\'s gradients vs the card {c["adam_diff"]:.3g} '
      f'(rtol {ADAM_RTOL}, atol {ADAM_ATOL}); the CPU\'s plain step '
      f'(recorded): gradients {c["plain_grad_share"]:.3g} of the largest, '
      f'updated params max abs diff {c["max_abs_param_diff"]:.3g}')

  # ---- 3. ScanTrainer over the same pool from the same start: captured
  # (the default on a card; the eager warm-up chunk, then one CUDA graph
  # per chunk length) and eager, three epochs each
  chunks = -(-steps // chunk)
  trainers = {}
  # the control (eager, not in ``trainers``): the eager second epoch
  # without its last step, the reading PARAMS_LIMIT must be below
  for name, capture in (('scan', None), ('scan_eager', False),
                        ('control', False)):
    smodel, _ = make_model(torch, gtt, loader, device)
    smodel.load_state_dict(start)
    smodel.train()
    sloader = make_loader(gtt, ds, pool, device, mode, caps)
    trainers[name] = [gtt.loader.ScanTrainer(
        sloader, smodel, CLASSES, chunk_size=chunk, capture=capture),
        train.create_train_state(smodel, lr=LR)]
  control = trainers.pop('control')
  results = {name: {} for name in trainers}

  # the second epoch is held chunk by chunk: the captured trainer keeps
  # its state (parameters, Adam's tensors) after each chunk, the eager one
  # takes it up at each chunk start and is compared at the chunk's end.
  # Over a free-running epoch merge training parts by more than
  # PARAMS_LIMIT now and then (the backward's atomics sum in no fixed
  # order and Adam turns a gradient's sign near 0 into a step of the
  # rate: 1.78e-3 in one run of 16 steps), a chunk rarely does; a skipped
  # or repeated step still shows (the control)
  def chunk_state(trainer):
    opt = trainer._chunk_carry['state'].optimizer
    ps = list(trainer.model.parameters())
    return ps + [v for p in ps for v in opt.state[p].values()
                 if torch.is_tensor(v)]

  held, chunk_diffs = {}, []

  def keep(c, s0, k):
    held[s0 + k] = [t.detach().clone() for t in chunk_state(trainers[
        'scan'][0])]

  @torch.no_grad()
  def take_up(c, s0, k):
    if s0:
      torch._foreach_copy_(chunk_state(trainers['scan_eager'][0]), held[s0])

  def compare(c, s0, k):
    chunk_diffs.append(max(
        float((a.detach() - b).abs().max()) for a, b in zip(
            chunk_state(trainers['scan_eager'][0]), held[s0 + k])))

  for epoch in range(2):
    if epoch:
      # how far the first epoch left the two apart from one start (the
      # drift of free-running training, reported)
      first_epoch_drift = max(
          float((a - b).detach().abs().max()) for a, b in zip(
              trainers['scan'][0].model.parameters(),
              trainers['scan_eager'][0].model.parameters()))
      # the eager trainer takes up the captured one's weights and Adam
      # state, so both epochs compare one step function from one start:
      # the backward's scatter atomics sum in no fixed order, and over
      # epochs two runs drift apart whatever runs them
      for eager in (trainers['scan_eager'], control):
        eager[0].model.load_state_dict(trainers['scan'][0].model.state_dict())
        # (a deep copy: load_state_dict keeps tensors it need not cast, so
        # the two optimizers would share their moments)
        eager[1].optimizer.load_state_dict(copy.deepcopy(
            trainers['scan'][1].optimizer.state_dict()))
      trainers['scan'][0].ack_hook = keep
      trainers['scan_eager'][0].stage_hook = take_up
      trainers['scan_eager'][0].ack_hook = compare
    control[1] = control[0].run_epoch(
        control[1], max_steps=steps - 1 if epoch else None)[0]
    for name, tr in trainers.items():
      trainer, sstate = tr
      ops.reset_launch_counts()
      if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
      count0 = trainer._sampler._call_count + 1
      a = _event(torch, cuda)
      sstate, slosses, saccs = trainer.run_epoch(sstate)
      b = _event(torch, cuda)
      if cuda:
        b.synchronize()
      tr[1] = sstate
      results[name][epoch] = dict(
          ms_per_step=_span(a, b, cuda) / steps, launches=ops.launch_counts(),
          losses=slosses, accs=saccs, count0=count0,
          peak_bytes=torch.cuda.max_memory_allocated() if cuda else None,
          peak_reserved_bytes=(torch.cuda.max_memory_reserved() if cuda
                               else None))
  cap, eag = trainers['scan'][0], trainers['scan_eager'][0]
  for epoch in range(2):
    rc, re = results['scan'][epoch], results['scan_eager'][epoch]
    for r in (rc, re):
      assert r['launches'][hop] == per * level_launch_count(mode, steps) and \
          r['launches']['gather_rows'] == per * steps and \
          r['launches']['step_keys'] == per * chunks, r['launches']
    assert rc['launches'] == re['launches'], (rc['launches'], re['launches'])
    assert rc['losses'].shape == (steps,) and \
        bool(torch.isfinite(rc['losses']).all())
    rel = float(((rc['losses'] - re['losses']).abs() /
                 re['losses'].abs()).max())
    log(f'train {mode} ScanTrainer epoch {epoch + 1}: captured vs eager '
        f'losses max rel diff {rel:.3g}')
    torch.testing.assert_close(rc['losses'], re['losses'], rtol=1e-4, atol=0)
    mats = [t._epoch_seeds(gtt.random.fold_in(t._perm_key, epoch), steps)
            for t in (cap, eag)]
    assert torch.equal(mats[0][0], mats[1][0]) and \
        torch.equal(mats[0][1], mats[1][1]), 'seed matrices differ'
  # epoch 0: the seed matrix and losses against the per-step loop
  seed_mat, mask = cap._epoch_seeds(gtt.random.fold_in(cap._perm_key, 0),
                                    steps)
  assert bool(mask.all()) and torch.equal(seed_mat, torch.stack(seeds)), \
      'ScanTrainer seed matrix != the per-step loop\'s seeds'
  slosses = results['scan'][0]['losses']
  torch.testing.assert_close(slosses, losses, rtol=1e-4, atol=0)
  # the graphs' hop keys: the last chunk of each length, exact
  want = gtt.random.step_keys_plain(
      cap._sampler._key, results['scan'][1]['count0'] +
      torch.arange(steps, dtype=torch.int64), len(FANOUTS))
  for k, g in cap._graphs.items():
    last = max(s0 for s0 in range(0, steps, chunk)
               if min(chunk, steps - s0) == k)
    assert torch.equal(g.keys.cpu(), want[last:last + k]), k
  # parameters: Adam moves each element by about the rate per step
  # whatever its gradient's size, so an element whose gradient is summing
  # noise near 0 may step the other way; a replay that skipped or repeated
  # a step moves elements by about the rate, as the control shows
  def params_apart(m1, m2):
    return max(float((a - b).detach().abs().max())
               for a, b in zip(m1.parameters(), m2.parameters()))

  cap.ack_hook = eag.stage_hook = eag.ack_hook = None
  assert len(chunk_diffs) == chunks, chunk_diffs
  params_diff = max(chunk_diffs)
  control_diff = params_apart(control[0].model, eag.model)
  log(f'train {mode} ScanTrainer params max abs diff: captured vs eager '
      f'{params_diff:.3g} (parameters and Adam state after each chunk of '
      f'the second epoch, the eager trainer at the captured one\'s state at '
      f'each chunk start: {[float(f"{d:.3g}") for d in chunk_diffs]}; '
      f'after the first epoch from the initial weights: '
      f'{first_epoch_drift:.3g}, reported); control (eager without its '
      f'last step) vs eager {control_diff:.3g}; limit {PARAMS_LIMIT}')
  assert control_diff > PARAMS_LIMIT, \
      f'the control is within the limit: {control_diff}'
  assert params_diff < PARAMS_LIMIT, \
      f'captured vs eager params differ by {params_diff}'
  del control

  for name in trainers:
    r0, r1 = results[name][0], results[name][1]
    rep[name] = dict(
        chunk_size=chunk, ms_per_step=r1['ms_per_step'],
        first_epoch_ms_per_step=r0['ms_per_step'], launches=r1['launches'],
        peak_bytes=r1['peak_bytes'],
        peak_reserved_bytes=r1['peak_reserved_bytes'],
        losses=r1['losses'].tolist(),
        capture_ms=trainers[name][0].capture_ms)
  rep['scan']['losses_equal_eager'] = bool(torch.equal(
      results['scan'][1]['losses'], results['scan_eager'][1]['losses']))
  rep['scan']['max_abs_param_diff_eager'] = params_diff
  rep['scan']['max_abs_param_diff_control'] = control_diff
  rep['scan']['max_abs_param_diff_eager_first_epoch'] = first_epoch_drift
  rep['scan']['losses_equal_loop'] = bool(torch.equal(slosses, losses))
  rep['scan']['max_rel_loss_diff_loop'] = float(
      ((slosses - losses).abs() / losses.abs()).max())
  for name in trainers:
    r = rep[name]
    kind = 'captured' if trainers[name][0].capture else 'eager'
    log(f'train {mode} ScanTrainer {kind} ({name}): '
        f'{steps} steps in chunks of {chunk}: epoch 2 {r["ms_per_step"]:.3f} '
        f'ms/step (epoch 1 {r["first_epoch_ms_per_step"]:.3f}, with the '
        f'warm-up and captures); capture ms per chunk length '
        f'{r["capture_ms"]}; max_memory_allocated {r["peak_bytes"]} B, '
        f'max_memory_reserved {r["peak_reserved_bytes"]} B; '
        f'launches {r["launches"]} on {smi}')
  log(f'train {mode} ScanTrainer: seed matrices and hop keys exact; losses '
      f'vs eager (each epoch from one start) bit-equal '
      f'{rep["scan"]["losses_equal_eager"]}, params max abs diff '
      f'{params_diff:.3g} (limit {PARAMS_LIMIT}; control {control_diff:.3g}); '
      f'vs the loop bit-equal '
      f'{rep["scan"]["losses_equal_loop"]}, max rel diff '
      f'{rep["scan"]["max_rel_loss_diff_loop"]:.3g} (rtol 1e-4: the card\'s '
      f'scatter atomics sum in no fixed order)')

  # ---- 4. host syncs per step, on every entry point
  if cuda:
    syncs = {}
    for name, tr in trainers.items():
      (tr[1], _, _), n_sync, kinds = count_syncs(
          torch, lambda tr=tr: tr[0].run_epoch(tr[1]))
      torch.cuda.synchronize()
      syncs[name] = (n_sync, kinds)

    def loop_steps():
      st = state
      for _, batch in zip(range(SYNC_STEPS), loader):
        st, _, _ = step_fn(st, train.batch_to_dict(batch))
      return st

    _, loop_syncs, loop_kinds = count_syncs(torch, loop_steps)
    torch.cuda.synchronize()
    rep['syncs_per_step'] = dict(
        loop=loop_syncs / SYNC_STEPS, scan=syncs['scan'][0] / steps,
        scan_eager=syncs['scan_eager'][0] / steps, loop_kinds=loop_kinds,
        scan_kinds=syncs['scan'][1], scan_eager_kinds=syncs['scan_eager'][1])
    log(f'train {mode} host syncs per step (set_sync_debug_mode): loop '
        f'{loop_syncs}/{SYNC_STEPS} steps {loop_kinds}, ScanTrainer captured '
        f'{syncs["scan"][0]}/{steps} steps {syncs["scan"][1]}, eager '
        f'{syncs["scan_eager"][0]}/{steps} steps {syncs["scan_eager"][1]}')
    allowed = 1 if loader.sampler.clamped_exact else 0   # the epoch's guard
    assert syncs['scan'][0] <= allowed, syncs['scan']
    assert loop_syncs == 0, loop_kinds
    # device ops per step of a captured epoch, and the port's kernels the
    # profiler saw against the launch counters
    for name, tr in trainers.items():
      def epoch(tr=tr):
        tr[1] = tr[0].run_epoch(tr[1])[0]

      # an epoch in the profiler's warm-up cycle, then the counters from
      # 0: a window without one can lose its first device records (C6)
      prof = profiled(torch, epoch, 1, device,
                      f'train {mode} ScanTrainer epoch ({name})',
                      warmup=lambda: (epoch(), ops.reset_launch_counts()),
                      expect=port_launch_counts)
      counted = port_launch_counts()
      prof['per_step'] = dict(device_ops=prof['device_ops_per_call'] / steps,
                              device_busy_ms=prof['device_busy_ms'] / steps,
                              wall_ms=prof['wall_ms'] / steps)
      prof['launch_counters'] = counted
      rep[name]['profile_epoch'] = prof
      log(f'train {mode} ScanTrainer ({name}) per step: device ops '
          f'{prof["per_step"]["device_ops"]:.1f}, busy '
          f'{prof["per_step"]["device_busy_ms"]:.3f} ms, wall '
          f'{prof["per_step"]["wall_ms"]:.3f} ms; profiler kernels '
          f'{prof["kernels"]} vs launch counters {counted}')
      assert prof['kernels'] == counted and all(
          prof['kernels'][k] for k in PORT_KERNELS
          if k not in ('uniform_draw', 'negative_sample', 'dist_step_keys',
                       'negative_sample_local',
                       'sample_level' if mode == 'tree' else 'sample_hop')), \
          (prof['kernels'], counted)
      if name == 'scan':
        # a replay re-adds the counts its capture recorded: the result
        # line takes the captured epoch's launches as the profiler counted
        # them on the device
        rep[name]['launches'] = dict(rep[name]['launches'],
                                     **prof['kernels'])
  # device ops of one loop step, sample + collate + train, beside
  # OPS_BEFORE's scanned-epoch step
  it = iter(loader)
  step_fn(state, train.batch_to_dict(next(it)))
  rep['profile_loop_step'] = profiled(
      torch, lambda: step_fn(state, train.batch_to_dict(next(it))), 1, device,
      f'train {mode} loop step, sample+collate+train (before: '
      f'{OPS_BEFORE["train_" + mode]} ops per scanned step)')
  if profile:
    batch = train.batch_to_dict(next(iter(loader)))
    rep['profile'] = dict(
        step=profiled(torch, lambda: step_fn(state, batch), 3, device,
                      f'train {mode} step (forward+backward+Adam)'))
  del trainers, cap, eag
  t0 = time.perf_counter()
  rep['program'] = program_phase(torch, gtt, ds, device, mode, caps, pool,
                                 steps, smi, start)
  rep['program_s'] = time.perf_counter() - t0
  log(f'train {mode} epoch-as-a-program phase took {rep["program_s"]:.1f} s')
  return rep


def program_phase(torch, gtt, ds, device, mode, caps, pool, steps, smi,
                  start):
  """The rest of the epoch as a program, at the training phase's width.
  Every trainer starts from ``start`` (the loop's weights) with a fresh
  Adam, or from a warmed state of the first trainer below. Merge training
  on the card is chaotic (the backward's scatter atomics sum in no fixed
  order, and Adam turns a flipped sign of a gradient near 0 into a step of
  the rate), so comparisons of parameters run from a common warmed state
  over a few steps: a trainer is set to the reference's state at each of
  its chunk (or step) boundaries and compared at the next.

  (1) A captured ScanTrainer A (K = 4): two epochs without a checkpointer,
  two with one (every 2 chunks); a third trainer advanced to A's state
  after its third epoch (through the completed-epoch snapshot) crashes at
  chunk 3 of the fourth, and a fresh trainer from other weights resumes.
  (2) RunTrainer (E = 3, K = 6) against a captured ScanTrainer (K = 2)
  from A's state after two epochs, held to it chunk by chunk; then timed;
  then an early-stopped run (K = 8, patience 1, min_delta 1.0).
  (3) OverlappedTrainer against the per-step loop from the same state,
  held to it step by step; then timed beside an unsynchronised loop
  epoch, and profiled. Launch counters are set to 0 before each driven
  run and read after it."""
  import copy
  import os
  import shutil

  from graphlearn_tpu_torch import metrics, ops
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer, snapshot
  cuda = device.type == 'cuda'
  per = 1 if cuda else 0
  hop = 'sample_level' if mode == 'merge' else 'sample_hop'
  ck_chunk, run_chunk, stop_chunk = (CKPT_CHUNK, RUN_CHUNK, STOP_CHUNK) \
      if cuda else (1, 3, steps)
  allowed = 1 if mode == 'merge' and caps else 0   # the guard's one per run
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                      'chip_smoke_ckpt', mode)
  shutil.rmtree(root, ignore_errors=True)
  rep = dict(launch_runs=[], rings=[])   # every driven run's launch counts

  def fresh_model(weights=start, warm=None):
    """A loader, a model and a train state: from ``weights`` (None: other
    weights) or the ``(model, optimizer)`` state dicts ``warm``."""
    loader = make_loader(gtt, ds, pool, device, mode, caps)
    model, _ = make_model(torch, gtt, loader, device, 99)
    model.train()
    state = train.create_train_state(model, lr=LR)
    if warm is not None:
      model.load_state_dict(warm[0])
      state.optimizer.load_state_dict(copy.deepcopy(warm[1]))
    elif weights is not None:
      model.load_state_dict(weights)
    return loader, model, state

  def fresh(cls, weights=start, warm=None, **kw):
    loader, model, state = fresh_model(weights, warm)
    return cls(loader, model, CLASSES, **kw), state

  def driven(fn):
    """(fn's result, device ms or CPU ms, the launch counts of fn); the
    counts also go to ``rep['launch_runs']``."""
    ops.reset_launch_counts()
    if cuda:
      torch.cuda.synchronize()
    a = _event(torch, cuda)
    out = fn()
    b = _event(torch, cuda)
    if cuda:
      b.synchronize()
    counts = ops.launch_counts()
    rep['launch_runs'].append(counts)
    return out, _span(a, b, cuda), counts

  def tensors(model, optimizer):
    """What a train step updates in place: parameters, Adam's tensors."""
    ps = list(model.parameters())
    return ps + [v for p in ps for v in optimizer.state[p].values()
                 if torch.is_tensor(v)]

  def snap_of(model, optimizer):
    return [t.detach().clone() for t in tensors(model, optimizer)]

  @torch.no_grad()
  def force(model, optimizer, ref):
    torch._foreach_copy_(tensors(model, optimizer), ref)

  def apart(a, b):
    return max(float((x - y).detach().abs().max()) for x, y in zip(a, b))

  def max_rel(a, b):
    return float(((a - b).abs() / b.abs()).max())

  def hist(name):
    h = metrics.histogram(name)
    return dict(count=h.count, **h.percentiles())

  def syncs_of(fn):
    return count_syncs(torch, fn) if cuda else (fn(), 0, {})

  # ---- 1. checkpoint overhead, crash and resume
  metrics.reset('checkpoint.')
  metrics.reset('recovery.')
  ta, sa = fresh(gtt.loader.ScanTrainer, chunk_size=ck_chunk)
  over_dir = os.path.join(root, 'overhead')
  epochs, ck, ref = [], None, {}
  for epoch in range(4):
    if epoch == 2:
      # keep every snapshot: the resume below starts from epoch 2's last
      ck = ChunkCheckpointer(over_dir, every=CKPT_EVERY, keep=10).attach(ta)
    if epoch < 3:
      (sa, lo, _), ms, counts = driven(lambda: ta.run_epoch(sa))
      syncs = None
    else:   # timed with its host syncs counted, checkpointer attached
      ((sa, lo, _), syncs, kinds), ms, counts = driven(
          lambda: syncs_of(lambda: ta.run_epoch(sa)))
    epochs.append(dict(ms_per_step=ms / steps, launches=counts,
                       checkpointer=ck is not None, host_syncs=syncs))
    ref[epoch] = dict(losses=lo, state=snap_of(ta.model, sa.optimizer))
    if epoch == 1:
      ref['warm'] = (copy.deepcopy(ta.model.state_dict()),
                     copy.deepcopy(sa.optimizer.state_dict()))
  ck.flush()
  counters = metrics.default_registry().counters()
  saves = counters.get('checkpoint.saves', 0)
  assert counters.get('checkpoint.save_errors', 0) == 0, counters
  assert counters.get('checkpoint.torn_skipped', 0) == 0, counters
  assert saves == 2 * 2 and not ck.degraded, counters  # 2 boundaries/epoch
  assert syncs <= allowed, kinds
  last = ck.latest()
  assert last.epoch == 3 and last.next_start == steps, last.meta
  assert all(np.array_equal(last.arrays[f'param:{n}'],
                            p.detach().cpu().numpy())
             for n, p in ta.model.named_parameters()), 'final snapshot'
  ck.close()
  ck.detach()
  overhead = 100.0 * (epochs[3]['ms_per_step'] / epochs[1]['ms_per_step']
                      - 1)
  rep['checkpoint'] = dict(
      chunk_size=ck_chunk, every=CKPT_EVERY, epochs=epochs,
      recovery_overhead_pct=overhead,
      recovery_overhead_pct_first_epoch=100.0 * (
          epochs[2]['ms_per_step'] / epochs[1]['ms_per_step'] - 1),
      snapshot_bytes=counters.get('checkpoint.bytes', 0) / saves,
      save_ms=hist('checkpoint.save_ms'),
      capture_ms=hist('checkpoint.capture_ms'),
      sync_fallback=counters.get('checkpoint.sync_fallback', 0),
      host_syncs_per_step=syncs / steps, sync_kinds=kinds)
  r = rep['checkpoint']
  log(f'train {mode} checkpoint: ScanTrainer K={ck_chunk} ms/step without '
      f'{epochs[0]["ms_per_step"]:.3f} (warm-up, capture) / '
      f'{epochs[1]["ms_per_step"]:.3f}, with ChunkCheckpointer(every='
      f'{CKPT_EVERY}) {epochs[2]["ms_per_step"]:.3f} / '
      f'{epochs[3]["ms_per_step"]:.3f}: recovery_overhead_pct '
      f'{overhead:.2f} (first epoch with it '
      f'{r["recovery_overhead_pct_first_epoch"]:.2f}; the JAX package\'s '
      f'target < 5); snapshot {r["snapshot_bytes"]:.0f} B, save ms p50 '
      f'{r["save_ms"]["p50"]:.3f} p99 {r["save_ms"]["p99"]:.3f}, capture '
      f'ms p50 {r["capture_ms"]["p50"]:.3f} p99 {r["capture_ms"]["p99"]:.3f}'
      f', sync fallbacks {r["sync_fallback"]}; host syncs with it '
      f'{syncs}/{steps} steps {kinds} on {smi}')

  # the third trainer: advanced to A's state after its third epoch (A's
  # completed-epoch snapshot), it runs A's fourth epoch and crashes
  victim, sv = fresh(gtt.loader.ScanTrainer, weights=None,
                     chunk_size=ck_chunk)
  sv, _, _ = ChunkCheckpointer(over_dir).resume_epoch(
      victim, sv, snapshot=snapshot.load_snapshot(
          snapshot.snapshot_path(over_dir, 2, steps)))
  assert victim._epochs == 3 and apart(
      snap_of(victim.model, sv.optimizer), ref[2]['state']) == 0
  crash_dir = os.path.join(root, 'crash')
  ck = ChunkCheckpointer(crash_dir, every=CKPT_EVERY).attach(victim)
  cut = 2 * ck_chunk

  def killer(c, s0, k):
    if c == 3:
      raise RuntimeError('injected crash at chunk 3')

  victim.stage_hook = killer
  try:
    victim.run_epoch(sv)
    raise AssertionError('the injected crash did not fire')
  except RuntimeError as exc:
    assert 'injected crash' in str(exc), exc
  ck.close()
  ck.detach()
  snap = ck.latest()
  assert (snap.epoch, snap.next_start) == (3, cut), snap.meta
  # the victim's chunk 2 ran from the snapshot's state: the reference for
  # the resumed trainer's first chunk
  at_crash = snap_of(victim.model, sv.optimizer)
  del victim, sv
  run, grab, out = {}, {}, {}

  def fresh_resumed():
    # a fresh trainer (an earlier recording's goes, its graphs with it),
    # the counters from 0: what the window below changes
    run.clear()
    grab.clear()
    out.clear()
    tr, template = fresh(gtt.loader.ScanTrainer, weights=None,
                         chunk_size=ck_chunk)

    def ack(c, s0, k):
      if s0 + k == cut + ck_chunk:
        grab['state'] = snap_of(tr.model, tr._chunk_carry['state'].optimizer)

    tr.ack_hook = ack
    run.update(trainer=tr, template=template)
    ops.reset_launch_counts()

  fresh_resumed()
  params = list(run['trainer'].model.parameters())
  assert apart(params, ref[3]['state'][:len(params)]) > PARAMS_LIMIT
  del params
  prof = profiled(torch, lambda: out.update(zip(
      ('state', 'losses', 'accs'), ChunkCheckpointer(crash_dir).resume_epoch(
          run['trainer'], run['template']))), 1, device,
      f'train {mode} resume_epoch (warm-up, capture, replay)',
      expect=port_launch_counts, reset=fresh_resumed)
  resumed = run['trainer']
  launched = ops.launch_counts()
  rep['launch_runs'].append(launched)
  counted = {k: v for k, v in launched.items() if k in PORT_KERNELS}
  losses = torch.as_tensor(out['losses'])
  want = ref[3]['losses'].cpu()
  assert np.array_equal(out['losses'][:cut], snap.arrays['losses']), \
      'resumed prefix != the snapshot\'s'
  rel = max_rel(losses[cut:], want[cut:])
  torch.testing.assert_close(losses[cut:], want[cut:], rtol=1e-4, atol=0)
  diff = apart(grab['state'], at_crash)
  assert diff < PARAMS_LIMIT, f'resumed params apart by {diff}'
  end_diff = apart(snap_of(resumed.model, out['state'].optimizer),
                   ref[3]['state'])
  assert out['state'].step == 4 * steps
  if cuda:
    keys = gtt.random.step_keys_plain(
        resumed._sampler._key, 3 * steps + 1 + torch.arange(
            steps, dtype=torch.int64), len(FANOUTS))
    last_chunk = steps - ck_chunk
    assert torch.equal(resumed._graphs[ck_chunk].keys.cpu(),
                       keys[last_chunk:]), 'replayed hop keys'
  assert prof['kernels'] == counted, (prof['kernels'], counted)
  assert counted[hop] == per * level_launch_count(mode, steps - cut) and \
      counted['gather_rows'] == per * (steps - cut), counted
  rep['resume'] = dict(next_start=cut, replayed_steps=steps - cut,
                       max_rel_loss_diff=rel, max_abs_param_diff=diff,
                       max_abs_param_diff_epoch_end=end_diff,
                       launches=launched, profile=prof,
                       capture_ms=resumed.capture_ms)
  log(f'train {mode} crash at chunk 3 of epoch 4 (a trainer advanced to '
      f'the epoch-3 snapshot) and resume_epoch in a fresh trainer from '
      f'other weights: snapshot next_start {cut}, prefix exact, replayed '
      f'losses max rel diff {rel:.3g} to the uninterrupted epoch (rtol '
      f'1e-4); parameters and Adam state after the first replayed chunk '
      f'{diff:.3g} from the crashed trainer\'s after the same chunk (limit '
      f'{PARAMS_LIMIT}), at the epoch\'s end {end_diff:.3g} from the '
      f'uninterrupted epoch\'s; hop keys exact; profiler kernels '
      f'{prof["kernels"]} == counters')
  del resumed, run

  # ---- 2. RunTrainer against a ScanTrainer from A's state after two
  # epochs, chunk by chunk
  total = RUN_EPOCHS * steps
  chunks = -(-total // run_chunk)
  bounds = set(range(run_chunk, total + 1, run_chunk)) | {total}
  # the reference's chunks end at every RunTrainer boundary and epoch end
  sc, ss = fresh(gtt.loader.ScanTrainer, warm=ref['warm'],
                 chunk_size=math.gcd(run_chunk, steps))
  states, at = {0: snap_of(sc.model, ss.optimizer)}, {'base': 0}

  def keep(c, s0, k):
    g = at['base'] + s0 + k
    if g in bounds:
      states[g] = snap_of(sc.model, sc._chunk_carry['state'].optimizer)

  sc.ack_hook = keep
  slosses, scounts = [], []
  for e in range(RUN_EPOCHS):
    at['base'] = e * steps
    (ss, lo, _), _, counts = driven(lambda: sc.run_epoch(ss))
    slosses.append(lo)
    scounts.append(counts)
  slosses = torch.cat(slosses)
  mats = [sc._epoch_seeds(gtt.random.fold_in(sc._perm_key, e), steps)
          for e in range(RUN_EPOCHS)]
  tr, st = fresh(gtt.loader.RunTrainer, warm=ref['warm'],
                 chunk_size=run_chunk, epochs=RUN_EPOCHS)
  tr._seeds_dev = sc._seeds_dev
  mat, mask = tr._prologue(total)
  assert torch.equal(mat, torch.cat([m for m, _ in mats])) and \
      torch.equal(mask, torch.cat([k for _, k in mats])), \
      'RunTrainer seed matrix != three ScanTrainer prologues'
  diffs = []

  def set_state(c, s0, k):
    if s0:
      force(tr.model, tr._chunk_carry['state'].optimizer, states[s0])

  def check_state(c, s0, k):
    diffs.append(apart(snap_of(tr.model, tr._chunk_carry['state']
                               .optimizer), states[s0 + k]))

  tr.stage_hook, tr.ack_hook = set_state, check_state
  (st, rlosses, _), ms1, counts = driven(lambda: tr.run(st))
  rel = max_rel(rlosses, slosses)
  log(f'train {mode} RunTrainer vs a ScanTrainer from one state, chunk by '
      f'chunk: losses max rel diff {rel:.3g}, parameters and Adam state '
      f'after each chunk max abs diff {max(diffs):.3g}')
  torch.testing.assert_close(rlosses, slosses, rtol=1e-4, atol=0)
  assert max(diffs) < PARAMS_LIMIT, f'RunTrainer state apart by {diffs}'
  assert len(diffs) == chunks
  for k in ('gather_rows', hop):
    assert counts[k] == sum(c[k] for c in scounts), (counts, scounts)
  assert counts['step_keys'] == per * chunks, counts
  if cuda:
    keys = gtt.random.step_keys_plain(
        tr._sampler._key, 1 + torch.arange(total, dtype=torch.int64),
        len(FANOUTS))
    assert torch.equal(tr._graphs[run_chunk].keys.cpu(),
                       keys[total - run_chunk:]), 'RunTrainer hop keys'
  report = {k: v.tolist() for k, v in tr.last_run_report.items()}
  assert report['epochs_run'] == RUN_EPOCHS and not report['stopped']
  # a run of replays only, timed with its host syncs
  tr.stage_hook = tr.ack_hook = None
  ((st, _, _), syncs, kinds), ms2, counts2 = driven(
      lambda: syncs_of(lambda: tr.run(st)))
  assert syncs <= allowed, kinds
  scan_ms = epochs[1]['ms_per_step']
  rep['run'] = dict(
      epochs=RUN_EPOCHS, chunk_size=run_chunk, chunks=chunks,
      first_run_ms_per_step=ms1 / total, ms_per_step=ms2 / total,
      scan_ms_per_step=scan_ms, max_rel_loss_diff_scan=rel,
      max_abs_state_diff_scan=max(diffs), launches=counts,
      launches_second=counts2,
      host_syncs_per_step=syncs / total,
      sync_kinds=kinds, report=report, capture_ms=tr.capture_ms)
  log(f'train {mode} RunTrainer E={RUN_EPOCHS} K={run_chunk} ({chunks} '
      f'chunks): {ms2 / total:.3f} ms/step (the held run '
      f'{ms1 / total:.3f}, with the warm-up, the capture and the held '
      f'state) vs ScanTrainer K={ck_chunk} {scan_ms:.3f}; host syncs '
      f'{syncs}/{total} steps {kinds}; report {report}; launches {counts} '
      f'on {smi}')
  del tr, st, sc, ss, states

  es, se = fresh(gtt.loader.RunTrainer, chunk_size=stop_chunk,
                 epochs=RUN_EPOCHS, patience=1, min_delta=1.0)
  grab, marks = {}, {}

  def mark(name):
    marks[name] = _event(torch, cuda)

  def stage(c, s0, k):
    if s0 in (steps, 2 * steps):
      mark(f'begin{s0}')

  def ack2(c, s0, k):
    if s0 + k in (2 * steps, total):
      mark(f'end{s0 + k}')
    if s0 + k == 2 * steps:
      grab['t'] = [t.clone() for t in es._updated_tensors(
          es._chunk_carry['state'])]

  es.stage_hook, es.ack_hook = stage, ack2
  (se, elosses, eaccs), ms, counts = driven(lambda: es.run(se))
  report = {k: v.tolist() for k, v in es.last_run_report.items()}
  assert report['epochs_run'] == 2 and report['stopped'], report
  assert bool((elosses[2 * steps:] == 0).all()) and \
      bool((eaccs[2 * steps:] == 0).all()) and \
      bool((elosses[:2 * steps] != 0).all()), elosses
  now = es._updated_tensors(se)
  assert len(now) == len(grab['t']) and all(
      torch.equal(a, b) for a, b in zip(now, grab['t'])), \
      'a stopped step changed the parameters or Adam\'s state'
  active_ms = _span(marks[f'begin{steps}'], marks[f'end{2 * steps}'], cuda)
  stopped_ms = _span(marks[f'begin{2 * steps}'], marks[f'end{total}'], cuda)
  rep['early_stop'] = dict(
      chunk_size=stop_chunk, report=report, launches=counts,
      active_ms_per_step=active_ms / steps,
      stopped_ms_per_step=stopped_ms / steps, ms_per_step=ms / total)
  log(f'train {mode} RunTrainer early stop (patience 1, min_delta 1.0, '
      f'K={stop_chunk}): {report}; steps {2 * steps}-{total - 1} zero, '
      f'parameters and Adam state at step {2 * steps} equal to the final '
      f'ones bit for bit; ms per step between CUDA events on the trainer\'s '
      f'stream: epoch 2 (active) {active_ms / steps:.3f}, epoch 3 (stopped,'
      f' masked) {stopped_ms / steps:.3f} on {smi}')
  del es, se, grab

  # ---- 3. OverlappedTrainer against the per-step loop, step by step
  loop_loader, loop_model, loop_st = fresh_model(warm=ref['warm'])
  step_fn, _ = train.make_train_step(loop_model, CLASSES)
  loop_states = [snap_of(loop_model, loop_st.optimizer)]
  loop_losses = []
  for batch in loop_loader:
    loop_st, loss, _ = step_fn(loop_st, train.batch_to_dict(batch))
    loop_losses.append(loss)
    loop_states.append(snap_of(loop_model, loop_st.optimizer))
  ov, so = fresh(gtt.loader.OverlappedTrainer, warm=ref['warm'])
  inner, diffs = ov._train_step, []

  def held_step(state, batch):
    force(ov.model, state.optimizer, loop_states[len(diffs)])
    out = inner(state, batch)
    diffs.append(apart(snap_of(ov.model, state.optimizer),
                       loop_states[len(diffs) + 1]))
    return out

  ov._train_step = held_step
  (so, olosses), _, counts = driven(lambda: ov.run_epoch(so))
  ov._train_step = inner
  olosses, loop_losses = torch.stack(olosses), torch.stack(loop_losses)
  rel = max_rel(olosses, loop_losses)
  log(f'train {mode} OverlappedTrainer vs the loop from one state, step by '
      f'step: losses max rel diff {rel:.3g}, parameters and Adam state '
      f'after each step max abs diff {max(diffs):.3g}')
  torch.testing.assert_close(olosses, loop_losses, rtol=1e-4, atol=0)
  assert max(diffs) < PARAMS_LIMIT and len(diffs) == steps, diffs
  assert counts['gather_rows'] == per * steps and \
      counts[hop] == per * level_launch_count(mode, steps), counts
  (so, _), ms2, _ = driven(lambda: ov.run_epoch(so))

  def loop_epoch():
    st = loop_st
    for batch in loop_loader:
      st, _, _ = step_fn(st, train.batch_to_dict(batch))
    return st

  _, loop_ms, _ = driven(loop_epoch)
  prof = profiled(torch, lambda: ov.run_epoch(so), 1, device,
                  f'train {mode} OverlappedTrainer epoch')
  overlap = prof['device_sum_ms'] - prof['device_busy_ms']
  assert prof['device_streams'] >= 2 * per, prof   # the side stream ran
  rep['overlapped'] = dict(
      launches=counts, ms_per_step=ms2 / steps,
      loop_ms_per_step=loop_ms / steps,
      max_rel_loss_diff_loop=rel, max_abs_state_diff_loop=max(diffs),
      profile=prof, overlap_ms=overlap)
  log(f'train {mode} OverlappedTrainer: {ms2 / steps:.3f} ms/step vs the '
      f'per-step loop {loop_ms / steps:.3f} (one sync per epoch each, same '
      f'call); profiled '
      f'epoch: device busy (union over streams) '
      f'{prof["device_busy_ms"]:.3f} ms, sum of kernel intervals '
      f'{prof["device_sum_ms"]:.3f} ms, overlap {overlap:.3f} ms, over '
      f'{prof["device_streams"]} streams, wall {prof["wall_ms"]:.3f} ms, '
      f'idle share {prof["idle_share"]:.3f} on {smi}')
  shutil.rmtree(root, ignore_errors=True)
  return rep


# the products example's other modes (its flags beyond --dedup and
# --calibrate), each through a captured ScanTrainer and a sampled batch:
# name -> (loader keywords, bf16 table and model, uniform_draw launches per
# hop). The hops of block (two draws from a split key), padded and
# weighted sampling draw through csrc/uniform_draw.cu; node_budget's and
# bf16's uniform hops take the hop (tree) or level (merge) kernel.
OBS_STEPS = 20          # an epoch's steps: chunks of OBS_CHUNK, 8 and a tail
OBS_CHUNK = 8           # K: two chunk lengths (8 and 4), one capture each
OBS_REPS = 3            # timed epochs with recording on, and as many off
# the remote requests, (start, k) blocks: a K = 2 block, the tail block,
# then a block of the tail's size again (its host buffers seen before)
OBS_BLOCKS = ((0, 2), (2, 1), (1, 1))


@contextlib.contextmanager
def env_set(env: dict, on: bool = True):
  """``env``'s variables set (``on``) or unset inside the block, then
  restored."""
  old = {k: os.environ.pop(k, None) for k in env}
  if on:
    os.environ.update(env)
  try:
    yield
  finally:
    for k, v in old.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v


def obs_records(torch, trainer, state, epochs, env):
  """``epochs`` epochs of ``trainer`` with the flight and span logs of
  ``env`` on and a dispatch region open; per epoch the graph replays
  (``torch.cuda.CUDAGraph.replay`` calls) counted beside them. Returns
  ``(state, replays per epoch)``."""
  from graphlearn_tpu_torch.utils import trace
  graph_cls = torch.cuda.CUDAGraph if torch.cuda.is_available() else None
  replays = [0]
  if graph_cls is not None:
    plain = graph_cls.replay

    def counted(self):
      replays[0] += 1
      return plain(self)

    graph_cls.replay = counted
  per_epoch = []
  try:
    with env_set(env), trace.count_dispatches():
      for _ in range(epochs):
        replays[0] = 0
        state = trainer.run_epoch(state)[0]
        per_epoch.append(replays[0])
  finally:
    if graph_cls is not None:
      graph_cls.replay = plain
  return state, per_epoch


def obs_epoch_ms(torch, trainer, state, device, env, on: bool):
  """One epoch's ms on the card (CUDA events), recording on or off."""
  from graphlearn_tpu_torch.utils import trace
  cuda = device.type == 'cuda'
  with env_set(env, on), (trace.count_dispatches() if on
                          else contextlib.nullcontext()):
    a = _event(torch, cuda)
    state = trainer.run_epoch(state)[0]
    b = _event(torch, cuda)
    if cuda:
      b.synchronize()
  return state, _span(a, b, cuda)


def obs_trainer(torch, gtt, ds, device, mode, caps, pool, chunk):
  from graphlearn_tpu_torch.models import train
  loader = make_loader(gtt, ds, pool, device, mode, caps)
  model, _ = make_model(torch, gtt, loader, device, 0)
  model.train()
  state = train.create_train_state(model, lr=LR)
  return gtt.loader.ScanTrainer(loader, model, CLASSES,
                                chunk_size=chunk), state


def obs_profile_chunk(torch, trainer, state, device, tmp, label):
  """``utils.trace.profile_trace`` over one chunk replayed on its own
  (an epoch of one chunk's steps: the prologue and one replay), and
  ``utils.trace.device_op_ms`` over its Chrome trace: the port's kernels
  the trace shows, counted as ``ops.launch_counts()`` counts them in the
  same window. The profiler can lose a window's first device records
  (C6): the window idles PROFILE_LEAD_S first, and one that disagrees is
  recorded again, at most PROFILE_EMPTY_RETRIES times."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.utils import trace
  cuda = device.type == 'cuda'
  for attempt in range(PROFILE_EMPTY_RETRIES + 1):
    out = os.path.join(tmp, f'profile_{label}_{attempt}')
    ops.reset_launch_counts()
    with trace.profile_trace(out):
      time.sleep(PROFILE_LEAD_S if cuda else 0)
      state = trainer.run_epoch(state, max_steps=trainer.chunk_size)[0]
    counted = {k: v for k, v in ops.launch_counts().items()
               if k in PORT_KERNELS}
    op_ms = trace.device_op_ms(out)
    seen = kernel_counts({n: c for n, (_, c) in op_ms.items()})
    if seen == counted or not cuda:
      break
    log(f'observability {label}: profile_trace saw {seen} against the '
        f'counters {counted}; recording the window again')
  top = sorted(op_ms.items(), key=lambda kv: -kv[1][0])[:4]
  return state, dict(kernels=seen, launch_counters=counted,
                     device_ops=sum(c for _, c in op_ms.values()),
                     top_ms={k[:60]: v[0] for k, v in top},
                     attempts=attempt + 1)


def obs_remote_tree(ds, device, pool, env):
  """One remote request a block: a loopback ``DistServer`` in this
  process holds ``ds``; under a fresh trace id the client fetches each of
  OBS_BLOCKS (merge, uncalibrated, [15, 10, 5] x BATCH a batch), and the
  request is read back from ``metrics.scrape_all()`` plus the local ring
  and the span log by its id alone: one tree, rpc.client.request ->
  rpc.server.handle -> remote.block_stage, with the build's phase ms in
  the block span."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.distributed import dist_client
  from graphlearn_tpu_torch.sampler import SamplingConfig, SamplingType
  srv = gdist.DistServer(ds)
  names = ('create_block_producer', 'block_fetch', 'destroy_block_producer',
           'get_metrics', 'heartbeat', 'exit')
  rpc = gdist.RpcServer(handlers={h: getattr(srv, h) for h in names})
  gdist.init_client(1, 1, 0, [(rpc.host, rpc.port)])
  out = []
  try:
    cfg = SamplingConfig(SamplingType.NODE, FANOUTS, BATCH, False, False,
                         False, True, False, False, 'out', 0)
    pid = gdist.request_server(0, 'create_block_producer', pool, cfg,
                               None, idempotent=True)
    for start, k in OBS_BLOCKS:
      with env_set(env):
        out.append(obs_block_request(env, pid, start, k))
    gdist.request_server(0, 'destroy_block_producer', pid)
  finally:
    if dist_client._client is not None:
      dist_client._client.close()
      dist_client._client = None
    srv.exit()
    rpc.shutdown()
  return out


def obs_block_request(env, pid, start, k):
  """One block fetch under a fresh trace id, read back as one span tree
  (see :func:`obs_remote_tree`): its sizes and span durations."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch import metrics
  from graphlearn_tpu_torch.metrics import logcheck, spans
  with spans.new_trace() as req:
    t0 = time.perf_counter()
    frame = gdist.request_server(0, 'block_fetch', pid, 0, start, k,
                                 idempotent=True)
    wall = (time.perf_counter() - t0) * 1e3
  nbytes = sum(int(np.asarray(v).nbytes) for v in frame.values())
  del frame
  scr = metrics.scrape_all(timeout=30.0)
  rows = spans.dedupe(spans.from_scrape(scr, trace=req) +
                      spans.export(trace=req) +
                      [r for r in spans.read_log(env['GLT_SPAN_LOG'])
                       if r['trace'] == req])
  tree = spans.build_tree(rows)
  if tree['orphans'] or len(tree['roots']) != 1:
    raise AssertionError(f'observability: block ({start}, {k}) read '
                         f'back as {tree["roots"]} roots, orphans '
                         f'{tree["orphans"]}')
  root = tree['spans'][tree['roots'][0]]
  kids = [tree['spans'][c] for c in tree['children'].get(root['span'],
                                                           ())]
  handle = [r for r in kids if r['name'] == 'rpc.server.handle']
  stage = ([tree['spans'][c] for c in
            tree['children'].get(handle[0]['span'], ())]
           if len(handle) == 1 else [])
  if root['name'] != 'rpc.client.request' or len(handle) != 1 or \
      [r['name'] for r in stage] != ['remote.block_stage']:
    raise AssertionError(f'observability: the request tree is '
                         f'{[(r["name"], r["parent"]) for r in rows]}')
  for r in rows:
    if logcheck.validate_span(r):
      raise AssertionError(logcheck.validate_span(r))
  a = stage[0]['attrs']
  return dict(start=start, k=k, bytes=nbytes, client_wall_ms=wall,
              client_ms=root['dur_ms'], handle_ms=handle[0]['dur_ms'],
              build_ms=stage[0]['dur_ms'], sample_ms=a['sample_ms'],
              pack_ms=a['pack_ms'], d2h_ms=a['d2h_ms'], scraped=len(scr))


def observability_phase(torch, gtt, ds, device, caps, smi):
  """The observability layer on the card at the train phase's width: the
  captured ``ScanTrainer`` (tree and merge; K1, K3, K4 and the step keys)
  over OBS_STEPS steps of BATCH seeds, K = OBS_CHUNK.

  - Two epochs with ``GLT_RUN_LOG`` and ``GLT_SPAN_LOG`` set to temp
    files, under ``count_dispatches``: every record passes the port's
    logcheck; epoch 1's ``programs`` delta is one capture per chunk
    length (8 and 4), epoch 2's none; each epoch's ``scan_chunk``
    dispatches equal its chunks, and epoch 2's equal its graph replays;
    each epoch's ``epoch.chunk`` spans nest under its ``epoch.run``.
  - A replayed epoch with recording on under
    ``torch.cuda.set_sync_debug_mode('error')``: a host sync raises. The
    merge loader's epoch-end overflow guard reads one flag (its own
    sync, recording off as well): that epoch is counted instead, with
    recording on and off, and the counts must be equal.
  - ms per step with recording on and off (CUDA events; the median of
    OBS_REPS epochs each, alternating). No bound on time.
  - ``profile_trace`` of one replayed chunk: ``device_op_ms`` counts the
    port's kernels as ``ops.launch_counts()`` does.
  - One remote request a block through a loopback ``DistServer``, read
    back from ``scrape_all()`` plus the local ring as one span tree
    (:func:`obs_remote_tree`): where a block's time goes (the build's
    sampling, packing and host copy against the handler and the client's
    round trip: PERF.md §7's tail-block question)."""
  import tempfile

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.metrics import flight, logcheck, spans
  from graphlearn_tpu_torch.utils import trace
  cuda = device.type == 'cuda'
  n = ds.graph.topo.num_nodes
  steps = OBS_STEPS if cuda else 3
  chunk = OBS_CHUNK if cuda else 2
  pool = np.random.default_rng(31).permutation(n)[:BATCH * steps]
  tmp = tempfile.mkdtemp(prefix='glt_obs_')

  def logs(name):
    return dict(GLT_RUN_LOG=os.path.join(tmp, f'run_{name}.jsonl'),
                GLT_SPAN_LOG=os.path.join(tmp, f'spans_{name}.jsonl'))

  lengths = sorted({min(chunk, steps - s) for s in range(0, steps, chunk)})
  n_chunks = -(-steps // chunk)
  rep = dict(steps=steps, chunk=chunk, chunk_lengths=lengths, modes={},
             launch_runs=[])
  for mode in ('tree', 'merge'):
    env = logs(mode)
    trainer, state = obs_trainer(torch, gtt, ds, device, mode, caps, pool,
                                 chunk)
    spans.reset()
    ops.reset_launch_counts()
    state, replays = obs_records(torch, trainer, state, 2, env)
    counts = ops.launch_counts()
    rep['launch_runs'].append(counts)
    recs = [r for r in flight.read_records(env['GLT_RUN_LOG'])
            if r['emitter'] == 'ScanTrainer'][-2:]
    problems = (logcheck.check_file(env['GLT_RUN_LOG']) +
                logcheck.check_file(env['GLT_SPAN_LOG']))
    if problems or len(recs) != 2:
      raise AssertionError(f'observability {mode}: {len(recs)} records, '
                           f'logcheck {problems[:4]}')
    progs = [r['programs'].get('scan_chunk', {}) for r in recs]
    want_caps = len(lengths) if cuda else 0
    if progs[0].get('compiles', 0) != want_caps or \
        progs[1].get('compiles', 0) != 0:
      raise AssertionError(f'observability {mode}: programs deltas '
                           f'{progs}, expected {want_caps} captures then 0')
    for r in recs:
      d = r['dispatch']
      if d['scan_chunk'] != n_chunks or \
          r['programs']['scan_chunk']['dispatches'] != n_chunks:
        raise AssertionError(f'observability {mode}: dispatch {d}, '
                             f'programs {r["programs"]}')
    if cuda and (replays[1] != n_chunks or replays[0] != n_chunks - 1):
      raise AssertionError(f'observability {mode}: graph replays '
                           f'{replays}, expected {n_chunks - 1} then '
                           f'{n_chunks}')
    sp = [s for s in spans.read_log(env['GLT_SPAN_LOG'])
          if s['name'] in ('epoch.run', 'epoch.chunk')]
    tree = spans.build_tree(sp)
    runs = [s for s in sp if s['name'] == 'epoch.run']
    for run in runs:
      kids = [tree['spans'][c]['name']
              for c in tree['children'].get(run['span'], ())]
      if kids != ['epoch.chunk'] * n_chunks:
        raise AssertionError(f'observability {mode}: epoch.run holds '
                             f'{kids}')
    if len(runs) != 2 or tree['orphans']:
      raise AssertionError(f'observability {mode}: {len(runs)} epoch '
                           f'spans, orphans {tree["orphans"]}')
    # per epoch, its chunks' spans: the first epoch's warm-up and
    # captures, the second's replays
    chunk_ms = [[tree['spans'][c]['dur_ms']
                 for c in tree['children'][run['span']]] for run in runs]
    # ---- a replayed epoch with recording on makes no host sync
    guard = bool(trainer.loader.sampler.clamped_exact)
    syncs_on = syncs_off = None
    if cuda and not guard:
      torch.cuda.synchronize()
      torch.cuda.set_sync_debug_mode('error')
      try:
        with env_set(env), trace.count_dispatches():
          state = trainer.run_epoch(state)[0]
      finally:
        torch.cuda.set_sync_debug_mode(0)
      syncs_on = syncs_off = 0
    elif cuda:
      with env_set(env), trace.count_dispatches():
        state, syncs_on, kinds_on = count_syncs(
            torch, lambda: trainer.run_epoch(state)[0])
      state, syncs_off, kinds_off = count_syncs(
          torch, lambda: trainer.run_epoch(state)[0])
      if syncs_on != syncs_off or syncs_on > 1:
        raise AssertionError(
            f'observability {mode}: host syncs with recording on '
            f'{kinds_on}, off {kinds_off}')
    # ---- ms per step, recording on and off
    times = {True: [], False: []}
    for i in range(2 * OBS_REPS):
      on = i % 2 == 1
      state, ms = obs_epoch_ms(torch, trainer, state, device, env, on)
      times[on].append(ms / steps)
    med = {('on' if k else 'off'): float(np.median(v))
           for k, v in times.items()}
    # ---- profile_trace of one replayed chunk
    state, prof = obs_profile_chunk(torch, trainer, state, device, tmp,
                                    mode)
    if cuda and prof['kernels'] != prof['launch_counters']:
      raise AssertionError(f'observability {mode}: device_op_ms counted '
                           f'{prof["kernels"]}, the counters '
                           f'{prof["launch_counters"]}')
    rec = dict(programs=progs, dispatch=[r['dispatch'] for r in recs],
               replays=replays, capture_ms=trainer.capture_ms,
               epoch_chunk_span_ms=chunk_ms, guard_sync=guard,
               syncs_recording_on=syncs_on, syncs_recording_off=syncs_off,
               ms_per_step=med, ms_per_step_runs={
                   ('on' if k else 'off'): v for k, v in times.items()},
               profile_chunk=prof, launches=counts)
    rep['modes'][mode] = rec
    log(f'observability {mode}: programs deltas {progs} (chunk lengths '
        f'{lengths}), dispatch {rec["dispatch"]}, graph replays {replays}; '
        f'epoch.chunk spans (the host\'s enqueue) ms: epoch 1 (warm-up, '
        f'captures) {[round(v, 1) for v in chunk_ms[0]]}, epoch 2 (replays) '
        f'{[round(v, 3) for v in chunk_ms[1]]}; host syncs of a replayed '
        f'epoch with '
        f'recording on {syncs_on} (off {syncs_off}; the overflow guard '
        f'{"reads one flag" if guard else "reads nothing"}); ms/step '
        f'recording on {med["on"]:.3f}, off {med["off"]:.3f} (median of '
        f'{OBS_REPS}); profile_trace of one chunk: device_op_ms kernels '
        f'{prof["kernels"]} = launch counters; {prof["device_ops"]} '
        f'device ops, top {prof["top_ms"]} on {smi}')
    del trainer, state
    if cuda:
      torch.cuda.empty_cache()
  # ---- one remote request a block, read back as one span tree
  rpool = np.random.default_rng(32).permutation(n)[:BATCH * 3]
  ops.reset_launch_counts()
  rep['remote'] = obs_remote_tree(ds, device, rpool, logs('remote'))
  rep['launch_runs'].append(ops.launch_counts())
  for r in rep['remote']:
    log(f'observability remote block ({r["start"]}, k={r["k"]}): '
        f'{r["bytes"]} B; client span {r["client_ms"]:.1f} ms > server '
        f'handle {r["handle_ms"]:.1f} ms > remote.block_stage '
        f'{r["build_ms"]:.1f} ms (sample {r["sample_ms"]:.1f}, pack '
        f'{r["pack_ms"]:.1f}, host copy {r["d2h_ms"]:.1f}); outside the '
        f'build: {r["handle_ms"] - r["build_ms"]:.1f} ms in the handler, '
        f'{r["client_ms"] - r["handle_ms"]:.1f} ms on the wire and in '
        f'pickling; read back from {r["scraped"]} scrape roles on {smi}')
  return rep


TUNE_SERVE_REQUESTS = 24   # sequential engine requests, one batch each
TUNE_SERVE_DIM = 16        # the routed engine's table width
TUNE_ROTATE_ROWS = 100_000  # the rotating store's rows (4 shards)
TUNE_MEM_SLACK_MB = 16     # allocated MB a candidate may leave behind


def counter_value(gtt, name: str) -> int:
  return gtt.metrics.default_registry().counter_value(name)


def tune_candidates_report(recs, cuda) -> list:
  """One row per candidate record of a local tune: qualified, captures in
  the compile phase and the steady epoch (the scan_chunk site), ms per
  step, peak MB; checked: every candidate but the retrace probe
  qualifies with one capture per chunk length in the compile phase and
  none in the steady epoch; on a card the probe is rejected with a diff
  naming the chunk length."""
  rows = []
  for r in recs:
    comp = r.get('compile_epoch_compiles') or {}
    steady = r.get('steady_epoch_compiles') or {}
    row = dict(name=r['name'], qualified=bool(r['qualified']),
               compile_epochs=r.get('compile_epochs'),
               compile_captures=sum(comp.values()),
               steady_captures=sum(steady.values()),
               probe_steps=r.get('probe_steps'),
               ms_per_step=(r['wall_s'] * 1e3 / r['probe_steps']
                            if r.get('probe_steps') else None),
               peak_mb=r.get('peak_mb'), mem_before_mb=r.get('mem_before_mb'),
               mem_after_mb=r.get('mem_after_mb'),
               rejected=r.get('rejected'), retrace_diff=r.get('retrace_diff'))
    rows.append(row)
    probe = r['name'].endswith('retrace_probe')
    if probe and cuda:
      if row['qualified'] or 'static:k=' not in (row['retrace_diff'] or ''):
        raise AssertionError(f'tune: the retrace probe was not rejected with '
                             f'a chunk-length diff: {row}')
    elif not probe:
      if not row['qualified'] or row['steady_captures']:
        raise AssertionError(f'tune: candidate {row["name"]} did not '
                             f'qualify: {row}')
      if cuda and row['compile_captures'] != 1:
        raise AssertionError(f'tune: candidate {row["name"]} captured '
                             f'{row["compile_captures"]} chunk graphs in its '
                             'compile phase, not one per chunk length')
    # the first candidate also places what the dataset and the process
    # keep (the feature table on its first lookup, cuBLAS's workspaces):
    # from the second on, each must hand back what it allocated
    if cuda and len(rows) > 1 and \
        abs(row['mem_after_mb'] - row['mem_before_mb']) > TUNE_MEM_SLACK_MB:
      raise AssertionError(f'tune: candidate {row["name"]} left '
                           f'{row["mem_after_mb"] - row["mem_before_mb"]:.1f}'
                           ' MB allocated')
  return rows


def tune_strict_checks(torch, gtt, ds, device, caps, pool, smi, rep):
  """GLT_STRICT=1 over a captured tree and a captured merge ScanTrainer
  (two epochs each: warm-up and captures, then replays): neither raises
  (the merge guard's epoch-end flag read is outside the region). A
  stage_hook that calls ``.item()`` raises under GLT_STRICT and not
  without it. The tree trainer then takes a ChunkCheckpointer with
  ``recovery.save`` armed once: the epoch completes, the checkpointer
  degrades to synchronous writes and the last snapshot holds the epoch's
  losses."""
  import tempfile

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer
  from graphlearn_tpu_torch.recovery import snapshot as snap_lib
  from graphlearn_tpu_torch.utils import faults
  cuda = device.type == 'cuda'
  strict_env = {'GLT_STRICT': '1'}
  out = {}
  for mode in ('tree', 'merge'):
    ops.reset_launch_counts()
    trainer, state = obs_trainer(torch, gtt, ds, device, mode, caps, pool,
                                 TRAIN_CHUNK if cuda else 2)
    with env_set(strict_env):
      for _ in range(2):
        state = trainer.run_epoch(state)[0]
    probe = torch.ones((), device=device)

    def read_back(c, start, k):
      probe.item()

    trainer.stage_hook = read_back
    raised = None
    with env_set(strict_env):
      try:
        state = trainer.run_epoch(state)[0]
      except RuntimeError as e:
        raised = str(e).splitlines()[0][:160]
    if cuda and raised is None:
      raise AssertionError(f'tune strict {mode}: a .item() in the region did '
                           'not raise under GLT_STRICT')
    state = trainer.run_epoch(state)[0]   # the same hook, strict off
    trainer.stage_hook = None
    rec = dict(strict_epochs_ok=2, item_raised=raised,
               item_without_strict_ok=True, captures=sorted(trainer._graphs))
    if mode == 'tree':
      tmp = tempfile.mkdtemp(prefix='glt_tune_ck_')
      ck = ChunkCheckpointer(tmp, every=1).attach(trainer)
      e0 = counter_value(gtt, 'checkpoint.save_errors')
      with faults.injected('recovery.save', 'raise', times=1):
        state, losses, _ = trainer.run_epoch(state)
        ck.flush()
        _, fired = faults.stats('recovery.save')
      ck.close()
      last = snap_lib.load_snapshot(snap_lib.list_snapshots(tmp)[-1][2])
      same = bool(np.array_equal(last.arrays['losses'],
                                 losses.cpu().numpy()))
      rec['save_fault'] = dict(
          fired=fired, degraded=ck.degraded,
          save_errors=counter_value(gtt, 'checkpoint.save_errors') - e0,
          snapshots=len(snap_lib.list_snapshots(tmp)),
          last_snapshot_losses_equal=same)
      if fired != 1 or not ck.degraded or not same or \
          rec['save_fault']['save_errors'] != 1:
        raise AssertionError(f'tune: recovery.save armed once: '
                             f'{rec["save_fault"]}')
    rec['launches'] = ops.launch_counts()
    rep['launch_runs'].append(rec['launches'])
    out[mode] = rec
    log(f'tune strict {mode}: GLT_STRICT=1 over a warm-up/capture epoch and '
        f'a replayed one: no raise; a stage_hook .item() under GLT_STRICT '
        f'raised: {raised!r}; without GLT_STRICT: no raise'
        + (f'; recovery.save armed once: {rec["save_fault"]}'
           if mode == 'tree' else '') + f' on {smi}')
    del trainer, state
    if cuda:
      torch.cuda.empty_cache()
  return out


def tune_serving_checks(torch, gtt, art, n, device, smi, rep):
  """``ServingEngine(store, config=art')``, ``art'`` the tuned artifact
  with ``use_pallas_v2=True``: the artifact's buckets, every answer equal
  to the table's rows, one K2 (gather_runs) launch per engine batch. Then
  ``serving.rotate`` armed once on a 4-shard ``RotatingShardedStore`` on
  the card: the rotation raises, version 0 keeps serving; the next
  rotation publishes."""
  import tempfile

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch import tune as gtune
  from graphlearn_tpu_torch.serving import RotatingShardedStore
  from graphlearn_tpu_torch.utils import faults
  rng = np.random.default_rng(41)
  table = rng.standard_normal((n, TUNE_SERVE_DIM), dtype=np.float32)
  store = gtt.serving.EmbeddingStore(table, device=device)
  routed = gtune.TuneArtifact(dict(art.choices, use_pallas_v2=True,
                                   gather2_block_rows=256,
                                   gather2_run_span=8), art.dataset)
  ops.reset_launch_counts()
  b0 = counter_value(gtt, 'serving.batches')
  with gtt.serving.ServingEngine(store, config=routed) as eng:
    buckets = eng.buckets
    for _ in range(TUNE_SERVE_REQUESTS):
      ids = rng.integers(0, n, int(rng.integers(1, max(buckets) + 1)))
      got = eng.submit(ids).result(timeout=60)
      if not np.array_equal(got, table[ids]):
        raise AssertionError('tune serving: a K2-routed answer differs from '
                             'the table')
  batches = counter_value(gtt, 'serving.batches') - b0
  launches = ops.launch_counts()
  rep['launch_runs'].append(launches)
  if tuple(buckets) != tuple(art.choices['serving_buckets']) or \
      (device.type == 'cuda' and launches['gather_runs'] != batches):
    raise AssertionError(f'tune serving: buckets {buckets}, K2 launches '
                         f'{launches["gather_runs"]} for {batches} batches')
  out = dict(buckets=list(buckets), requests=TUNE_SERVE_REQUESTS,
             batches=batches, gather_runs_launches=launches['gather_runs'],
             answers_equal=True)
  del store, table
  # ---- serving.rotate armed once
  rows = min(n, TUNE_ROTATE_ROWS)
  base = np.arange(rows, dtype=np.float32)[:, None] * np.ones(
      (1, TUNE_SERVE_DIM), np.float32)
  root = tempfile.mkdtemp(prefix='glt_tune_rot_')
  ops.reset_launch_counts()
  rot = RotatingShardedStore(root, 4, base, warm_rows=1024, device=device)
  ids = rng.integers(0, rows, 512)
  mask = np.ones(ids.shape[0], bool)
  with faults.injected('serving.rotate', 'raise', after=2, times=1):
    try:
      rot.rotate(lambda: base + 7.0)
      raised = False
    except faults.FaultError:
      raised = True
    _, fired = faults.stats('serving.rotate')
  kept = bool(np.array_equal(rot.fetch(rot.lookup(ids, mask)), base[ids]))
  version_after_fault = rot.version
  rot.rotate(lambda: base + 7.0)
  fresh = bool(np.array_equal(rot.fetch(rot.lookup(ids, mask)),
                              base[ids] + 7.0))
  rep['launch_runs'].append(ops.launch_counts())
  out['rotate_fault'] = dict(fired=fired, raised=raised,
                             version_after_fault=version_after_fault,
                             previous_rows_served=kept,
                             next_version=rot.version, next_rows=fresh)
  if not (raised and fired == 1 and version_after_fault == 0 and kept and
          fresh and rot.version == 1):
    raise AssertionError(f'tune: serving.rotate armed once: '
                         f'{out["rotate_fault"]}')
  log(f'tune serving: ServingEngine(config=art + use_pallas_v2) buckets '
      f'{out["buckets"]}, {TUNE_SERVE_REQUESTS} requests in {batches} '
      f'batches, K2 launches {launches["gather_runs"]}, answers equal the '
      f'table; serving.rotate armed once: {out["rotate_fault"]} on {smi}')
  return out


def tune_phase(torch, gtt, ds, device, pool, train_pool, caps, train_rep,
               smi):
  """The one-call tuner on the card at the main path's full width.

  - ``tune(ds, dict(fanouts=FANOUTS, input_nodes=pool,
    batch_size=BATCH))`` over the default field (calibrated exact merge,
    tree, two gather-v2 routes) plus ``retrace_probe_candidate``: per
    candidate qualified, captures in the compile phase (one per chunk
    length) and in the steady epoch (0 for a qualified one), ms per step
    and peak MB, and from the second candidate on the allocated MB back
    within TUNE_MEM_SLACK_MB after each (the first also places what the
    dataset and the process keep); the probe rejected with a diff naming
    the chunk length; the chosen K, caps, split and buckets.
  - ``ScanTrainer(loader, ..., config=art)`` over the train phase's pool,
    two epochs: the tuned K, the second epoch capturing nothing, its ms
    per step beside the train phase's captured reading (no bound, no
    claim).
  - :func:`tune_serving_checks` and :func:`tune_strict_checks`."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch import tune as gtune
  from graphlearn_tpu_torch.metrics import programs
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  rep = dict(launch_runs=[])
  t0 = time.perf_counter()
  cfg = dict(fanouts=FANOUTS, input_nodes=pool, batch_size=BATCH)
  tcaps, _ = gtune.probes.probe_frontier_caps(ds.graph, FANOUTS, BATCH,
                                              input_nodes=pool)
  cands = gtune.default_candidates(tcaps, exact=False)
  cands.append(gtune.retrace_probe_candidate(cands[0]))
  ops.reset_launch_counts()
  art = gtt.tune(ds, cfg, candidates=cands)
  rep['launch_runs'].append(ops.launch_counts())
  rep['tune_s'] = time.perf_counter() - t0
  recs = [e for e in art.evidence if e.get('kind') == 'candidate']
  rep['candidates'] = tune_candidates_report(recs, cuda)
  for row in rep['candidates']:
    ms = row['ms_per_step']
    log(f'tune candidate {row["name"]}: qualified={row["qualified"]} '
        f'compile-phase captures {row["compile_captures"]} '
        f'({row["compile_epochs"]} probe epochs) steady captures '
        f'{row["steady_captures"]} '
        f'ms/step {"n/a" if ms is None else f"{ms:.3f}"} peak MB '
        f'{row["peak_mb"]} allocated MB {row["mem_before_mb"]} -> '
        f'{row["mem_after_mb"]}'
        + (f'; rejected: {row["retrace_diff"]}' if not row['qualified']
           else ''))
  ch = art.choices
  winner = [e for e in art.evidence if e.get('kind') == 'winner'][0]
  rep['choices'] = {k: ch[k] for k in (
      'mode', 'chunk_k', 'frontier_caps', 'split_ratio', 'bucket_frac',
      'slab_cap', 'serving_buckets', 'wire_dtype', 'use_pallas_v2',
      'gather2_block_rows', 'gather2_run_span')}
  rep['winner'] = winner['name']
  rep['fingerprint'] = art.fingerprint
  log(f'tune: {len(recs)} candidates in {rep["tune_s"]:.1f} s, winner '
      f'{winner["name"]} (tie-break {winner["tie_break"]}); chosen '
      f'{rep["choices"]} on {smi}')
  # ---- ScanTrainer(config=art): the tuned K, a second epoch of replays
  mode = 'merge' if ch['mode'] in ('map', 'merge', 'sort', 'auto') else 'tree'
  loader = gtt.loader.NeighborLoader(ds, FANOUTS, train_pool, shuffle=False,
                                     seed=0, device=device,
                                     **art.loader_kwargs())
  model, _ = make_model(torch, gtt, loader, device, 0)
  model.train()
  state = train.create_train_state(model, lr=LR)
  ops.reset_launch_counts()
  trainer = gtt.loader.ScanTrainer(loader, model, CLASSES, config=art)
  epochs = []
  for _ in range(2):
    c0 = programs.compile_count('scan_chunk')
    a = _event(torch, cuda)
    state, losses, _ = trainer.run_epoch(state)
    b = _event(torch, cuda)
    if cuda:
      b.synchronize()
    epochs.append(dict(captures=programs.compile_count('scan_chunk') - c0,
                       ms_per_step=_span(a, b, cuda) / losses.shape[0],
                       finite=bool(torch.isfinite(losses).all())))
  rep['launch_runs'].append(ops.launch_counts())
  hand = train_rep[f'train_{mode}']['scan']['ms_per_step']
  rep['scan'] = dict(mode=mode, chunk_size=trainer.chunk_size, epochs=epochs,
                     hand_picked_chunk=train_rep[f'train_{mode}']['scan'][
                         'chunk_size'], hand_picked_ms_per_step=hand)
  if trainer.chunk_size != ch['chunk_k'] or epochs[1]['captures'] or \
      not all(e['finite'] for e in epochs):
    raise AssertionError(f'tune: ScanTrainer(config=art) {rep["scan"]}')
  log(f'tune: ScanTrainer(config=art) {mode}: K={trainer.chunk_size} '
      f'(tuned), epoch captures {[e["captures"] for e in epochs]}, ms/step '
      f'{epochs[1]["ms_per_step"]:.3f} beside the train phase\'s captured '
      f'{hand:.3f} at K={rep["scan"]["hand_picked_chunk"]} (no claim) on '
      f'{smi}')
  del trainer, model, state, loader
  if cuda:
    torch.cuda.empty_cache()
  rep['serving'] = tune_serving_checks(torch, gtt, art,
                                       ds.graph.topo.num_nodes, device, smi,
                                       rep)
  spool = train_pool[:BATCH * (TRAIN_STEPS if cuda else 4)]
  rep['strict'] = tune_strict_checks(torch, gtt, ds, device, caps, spool, smi,
                                     rep)
  # tune() leaves the dataset routed as its winner ran (JAX's contract);
  # the later phases count their launches on the default routing
  gtune.apply_kernel_routing(ds, {})
  return rep


def tune_dist_phase(torch, gtt, ds, labels, device, smi, built):
  """``tune(topology='dist')`` over DIST_PARTS shards of the one card at
  the dist_scan phase's size (BATCH seeds a shard, DSCAN_STEPS steps, the
  tree GraphSAGE), with two full-width candidates (a captured
  ``DistScanTrainer`` needs full-width exchanges): no cache and the
  DIST_CACHE hot cache. Every candidate qualifies with no steady capture;
  ``DistScanTrainer(config=art)`` takes the winner and trains an epoch; a
  local ``ScanTrainer`` refuses it."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch import tune as gtune
  from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
  from graphlearn_tpu_torch.models import create_train_state
  cuda = device.type == 'cuda'
  t0 = time.perf_counter()
  nparts = DIST_PARTS
  b = BATCH if cuda else 64
  steps = DSCAN_STEPS if cuda else 4
  parts, fparts, pb, hot = (built[k] for k in ('parts', 'fparts', 'pb',
                                               'hot'))
  n = pb.shape[0]
  mesh = gdist.ShardMesh(nparts, device)
  dg = gdist.DistGraph(nparts, 0, parts, pb)
  pool = np.random.default_rng(12).permutation(n)[:nparts * b * steps]

  def dataset(split):
    return gdist.DistDataset(nparts, 0, dg, gdist.DistFeature(
        nparts, fparts, pb, mesh, split_ratio=split, hotness=hot,
        bucket_frac=None), node_labels=labels)

  def make_scenario(knobs, k):
    data = dataset(knobs.get('split_ratio') or 0.0)
    loader = gdist.DistNeighborLoader(
        data, FANOUTS, pool, batch_size=b, shuffle=False, drop_last=True,
        seed=0, mesh=mesh, dedup='tree', bucket_frac=None)
    model = ex.make_model(FEAT_DIM, HIDDEN, CLASSES, FANOUTS, b, device,
                          torch.Generator().manual_seed(0))
    return (gtt.loader.DistScanTrainer(loader, model, CLASSES, chunk_size=k),
            create_train_state(model, lr=LR))

  cands = [gtune.TopologyCandidate('dist_fullwidth',
                                   dict(bucket_frac=None, split_ratio=0.0,
                                        wire_dtype=None)),
           gtune.TopologyCandidate('dist_fullwidth_cached',
                                   dict(bucket_frac=None,
                                        split_ratio=DIST_CACHE,
                                        wire_dtype=None))]
  data0 = dataset(0.0)
  cfg = dict(fanouts=FANOUTS, batch_size=b, epoch_steps=steps,
             make_scenario=make_scenario, feat_dim=FEAT_DIM,
             num_partitions=nparts)
  ops.reset_launch_counts()
  art = gtt.tune(data0, cfg, topology='dist', candidates=cands)
  rep = dict(launch_runs=[ops.launch_counts()], parts=nparts, batch=b,
             steps=steps, tune_s=time.perf_counter() - t0)
  recs = [e for e in art.evidence if e.get('kind') == 'candidate']
  # a record's probe_steps is the count asked for (2 K, JAX's rule); the
  # probe epoch holds at most the epoch's steps
  rep['candidates'] = [dict(
      name=r['name'], qualified=r['qualified'],
      compile_epochs=r.get('compile_epochs'),
      compile_captures=sum((r.get('compile_epoch_compiles') or {}).values()),
      steady_captures=sum((r.get('steady_epoch_compiles') or {}).values()),
      ms_per_step=(r['wall_s'] * 1e3 / min(r['probe_steps'], steps)
                   if r.get('wall_s') is not None else None),
      rejected=r.get('rejected')) for r in recs]
  for row in rep['candidates']:
    if not row['qualified'] or row['steady_captures'] or \
        (cuda and row['compile_captures'] != 1):
      raise AssertionError(f'tune dist: candidate {row}')
  ops.reset_launch_counts()
  loader = gdist.DistNeighborLoader(
      data0, FANOUTS, pool, batch_size=b, shuffle=False, drop_last=True,
      seed=0, mesh=mesh, dedup='tree', bucket_frac=None)
  model = ex.make_model(FEAT_DIM, HIDDEN, CLASSES, FANOUTS, b, device,
                        torch.Generator().manual_seed(0))
  tr = gtt.loader.DistScanTrainer(loader, model, CLASSES, config=art)
  state, losses, _ = tr.run_epoch(create_train_state(model, lr=LR))
  rep['launch_runs'].append(ops.launch_counts())
  finite = bool(torch.isfinite(losses).all())
  local = make_loader(gtt, ds, pool[:BATCH], device, 'tree')
  try:
    gtt.loader.ScanTrainer(local, make_model(torch, gtt, local, device, 0)[0],
                           CLASSES, config=art)
    refused = None
  except ValueError as e:
    refused = str(e)[:120]
  rep.update(chunk_k=art.choices['chunk_k'], accepted_chunk=tr.chunk_size,
             accepted_epoch_finite=finite, local_refusal=refused,
             winner=[e for e in art.evidence
                     if e.get('kind') == 'winner'][0]['name'],
             fingerprint_partitions=art.dataset['num_partitions'])
  if tr.chunk_size != art.choices['chunk_k'] or not finite or \
      refused is None or 'tuned for topology' not in refused:
    raise AssertionError(f'tune dist: {rep}')
  log(f'tune dist: P={nparts} candidates {rep["candidates"]}; winner '
      f'{rep["winner"]}, K={rep["chunk_k"]}; DistScanTrainer(config=art) '
      f'trained an epoch; a local ScanTrainer refused it: {refused!r} on '
      f'{smi}')
  del tr, model, state, loader, data0
  if cuda:
    torch.cuda.empty_cache()
  return rep


MODE_BUDGET = 100_000
MODES = {
    'block': (dict(dedup='tree', strategy='block'), False, 2),
    'padded': (dict(dedup='tree', padded_window='auto'), False, 1),
    'weighted': (dict(dedup='tree', with_weight=True), False, 1),
    'budget_tree': (dict(dedup='tree', node_budget=MODE_BUDGET), False, 0),
    'budget_merge': (dict(dedup='auto', node_budget=MODE_BUDGET), False, 0),
    'bf16': (dict(dedup='tree'), True, 0),
}
MODE_STEPS, MODE_CHUNK = 16, 8
PADDED_WINDOWS = (16, 32, 64)    # the padded hop timed at each, once
# bf16 keeps 8 significant bits, and the card and the CPU sum a product or
# a mean in other orders, each rounding to bf16 after every layer: bf16
# logits are held to this share of the largest logit, bf16 losses to this
# relative difference (the CPU tests measure 0-0.5% against flax)
BF16_TOL = 3e-2


def mode_model(torch, gtt, kw, bf16, device, seed=None):
  """The products example's model for a mode (its ``build_model``): tree
  batches the layered tree-dense forward, or the layered segment forward
  under a node budget; merge batches ``merge_dense``; bf16 compute under
  ``--bf16-model``. Weights from ``seed`` (None: for load_state_dict)."""
  from graphlearn_tpu_torch.examples.train_sage_products import build_model
  args = argparse.Namespace(
      batch_size=BATCH, fanout=FANOUTS, hidden=HIDDEN, dedup=kw['dedup'],
      strategy=kw.get('strategy', 'random'),
      padded_window=kw.get('padded_window'),
      node_budget=kw.get('node_budget'), bf16_model=bf16)
  gen = None if seed is None else torch.Generator().manual_seed(seed)
  return build_model(gtt, args, FEAT_DIM, CLASSES, None, device, gen)


def mode_launches(name, batches, hops, chunks=0, reseeds=0) -> dict:
  """The launches a mode's path makes over ``batches`` sampled batches:
  its draws, its uniform hops' hop or level kernel, one feature gather a
  batch, the trainer's step keys, and one draw per padded-table build."""
  kw, _, draws = MODES[name]
  uniform = draws == 0
  merge = kw['dedup'] != 'tree'
  return dict(
      uniform_draw=batches * hops * draws + reseeds,
      sample_hop=batches * hops if uniform and not merge else 0,
      sample_level=batches * (3 * hops + 1) if uniform and merge else 0,
      gather_rows=batches, step_keys=chunks)


def padded_window_times(torch, gtt, g, device, gen, reps):
  """The padded table's build (one draw, two stable sorts, a scatter) and
  the padded hop at hop 2 of a products batch (153,600 seeds x 5), at each
  of PADDED_WINDOWS, once each on this card."""
  from graphlearn_tpu_torch import ops
  cuda = device.type == 'cuda'
  n = g.num_nodes
  b, k = BATCH * FANOUTS[0] * FANOUTS[1], FANOUTS[2]
  seeds = torch.randint(0, n, (b,), generator=gen,
                        dtype=torch.int32).to(device)
  mask = (torch.rand((b,), generator=gen) < 0.97).to(device)
  key = gtt.random.to_device(gtt.random.fold_in(gtt.random.PRNGKey(0), 3),
                             device)
  out = []
  for w in PADDED_WINDOWS:
    if cuda:
      torch.cuda.synchronize()
    a = _event(torch, cuda)
    tab, deg, _ = ops.build_padded_adjacency_device(g.indptr, g.indices, w,
                                                    key)
    z = _event(torch, cuda)
    if cuda:
      z.synchronize()
    build_ms = _span(a, z, cuda)
    _, ms, call_ms = timed(
        torch, lambda: ops.uniform_sample_padded(tab, deg, seeds, mask, k,
                                                 key), reps, device)
    stats = gtt.ops.padded_table_stats(g.topo.indptr, w)
    rec = dict(window=w, build_ms=build_ms, hop2_ms=ms, hop2_call_ms=call_ms,
               edge_recall=stats['edge_recall'],
               node_recall=stats['node_recall'],
               table_bytes=int(tab.numel() * 4))
    out.append(rec)
    log(f'padded window W={w}: table build {build_ms:.3f} ms '
        f'({rec["table_bytes"]} B), padded hop at hop 2 ({b} seeds x {k}) '
        f'{ms:.4f} ms device (call {call_ms:.4f}); edge recall '
        f'{stats["edge_recall"]:.4f}, node recall {stats["node_recall"]:.4f}')
    del tab, deg
  return out


PADDED_REBUILD_SEED = 1   # the padded table's reseed: the second epoch's
PADDED_REBUILD_THREADS = 2   # the rebuild child's torch threads


def padded_rebuild_main(directory, window, seed, threads):
  """A spawned child: the padded table's CPU rebuild
  (``ops.build_padded_adjacency_device`` on the CPU, from
  ``PRNGKey(seed)``) over the CPU graph's arrays in ``directory``,
  written there as ``tab.npy`` and ``deg.npy`` with its seconds in
  ``rebuild.json``."""
  import torch

  import graphlearn_tpu_torch as gtt
  torch.set_num_threads(threads)
  indptr, indices = (torch.from_numpy(np.load(os.path.join(directory,
                                                           f'{k}.npy')))
                     for k in ('indptr', 'indices'))
  t0 = time.perf_counter()
  tab, deg, _ = gtt.ops.build_padded_adjacency_device(
      indptr, indices, window, gtt.random.PRNGKey(seed))
  took = time.perf_counter() - t0
  for name, t in (('tab', tab), ('deg', deg)):
    np.save(os.path.join(directory, f'{name}.npy'), t.numpy())
  with open(os.path.join(directory, 'rebuild.json'), 'w') as fh:
    json.dump(dict(window=window, seed=seed, threads=threads, seconds=took),
              fh)


def padded_rebuild_start(gtt, graph) -> dict:
  """Starts the modes phase's CPU rebuild of the padded table in a
  spawned child (``padded_rebuild_main``, PADDED_REBUILD_THREADS torch
  threads, no card), at the window ``padded_window='auto'`` picks for
  FANOUTS and the reseed's key, so the phase finds it done."""
  import multiprocessing as mp
  import tempfile
  directory = tempfile.mkdtemp(prefix='glt_padded_')
  np.save(os.path.join(directory, 'indptr.npy'), graph.indptr.numpy())
  np.save(os.path.join(directory, 'indices.npy'), graph.indices.numpy())
  window = gtt.ops.choose_padded_window(FANOUTS)
  proc = mp.get_context('spawn').Process(
      target=padded_rebuild_main,
      args=(directory, window, PADDED_REBUILD_SEED, PADDED_REBUILD_THREADS),
      daemon=True)        # ended with the script if it fails before modes
  proc.start()
  return dict(proc=proc, directory=directory, window=window,
              seed=PADDED_REBUILD_SEED)


def padded_rebuild_take(torch, started, window, seed):
  """``(table, degrees, rebuild seconds)`` of the child
  (``padded_rebuild_start``) once it ends. The child built the window and
  key the phase picks (``window``, ``seed``); where they differ, the
  script's constants have drifted from the sampler's and this fails. The
  child is joined and its directory removed either way."""
  proc = started['proc']
  proc.join(600)
  if proc.is_alive():
    proc.kill()
    proc.join()
  try:
    assert (window, seed) == (started['window'], started['seed']), (
        'the padded rebuild child built another table', (window, seed),
        (started['window'], started['seed']))
    if proc.exitcode != 0:
      raise AssertionError(f'padded rebuild child exited {proc.exitcode}')
    with open(os.path.join(started['directory'], 'rebuild.json')) as fh:
      took = json.load(fh)['seconds']
    return tuple(torch.from_numpy(np.load(os.path.join(
        started['directory'], f'{name}.npy'))) for name in ('tab', 'deg')
                 ) + (took,)
  finally:
    shutil.rmtree(started['directory'], ignore_errors=True)


def modes_phase(torch, gtt, dss, cpu_dss, device, pool, steps, chunk, smi,
                rebuild):
  """The products example's other modes at full width, each: a captured
  ScanTrainer (K = ``chunk``) and an eager one from the same weights, one
  warm-up epoch each, then, from the captured trainer's state, one timed
  epoch each (losses within rtol 1e-4, or BF16_TOL for bf16; the launch
  counters set to 0 before and read after: each hop through its draw,
  hop or level kernel, each feature gather through K1); then one sampled
  batch on the card,
  recomputed on the CPU from the same sampler state (ids, masks and
  features exact; logits within rtol 1e-3, atol 1e-4, or BF16_TOL of the
  largest logit), before a profiled third epoch of the captured trainer
  (device busy per step; the profiler's kernels equal to the counters).
  The padded mode also checks its reseeded table: not the first epoch's,
  and equal to a CPU rebuild from the same key (``rebuild``: the child
  ``padded_rebuild_start`` started, which built it beside the earlier
  phases)."""
  import copy

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  cuda = device.type == 'cuda'
  per = 1 if cuda else 0
  hops = len(FANOUTS)
  chunks = -(-steps // chunk)
  rep = {}
  for name, (kw, bf16, _) in MODES.items():
    t0 = time.perf_counter()
    ds, cpu_ds = dss[bf16], cpu_dss[bf16]
    padded = 'padded_window' in kw

    def loader(d=ds, dev=device, p=pool):
      return gtt.loader.NeighborLoader(d, FANOUTS, p, batch_size=BATCH,
                                       shuffle=False, seed=0, device=dev,
                                       **kw)

    cmodel = mode_model(torch, gtt, kw, bf16, device, 0)
    emodel = mode_model(torch, gtt, kw, bf16, device)
    emodel.load_state_dict(cmodel.state_dict())
    cap = gtt.loader.ScanTrainer(loader(), cmodel, CLASSES, chunk_size=chunk)
    eag = gtt.loader.ScanTrainer(loader(), emodel, CLASSES, chunk_size=chunk,
                                 capture=False)
    cstate = train.create_train_state(cmodel, lr=LR)
    estate = train.create_train_state(emodel, lr=LR)
    a = _event(torch, cuda)
    cstate = cap.run_epoch(cstate)[0]
    z = _event(torch, cuda)
    estate = eag.run_epoch(estate)[0]
    if cuda:
      torch.cuda.synchronize()
    warm_ms = _span(a, z, cuda) / steps
    sampler = cap._sampler
    first_tab = sampler._padded_arrays()['tab'].clone() if padded else None
    # the eager trainer takes up the captured one's state: one step
    # function from one start (merge training on the card is chaotic)
    emodel.load_state_dict(cmodel.state_dict())
    estate.optimizer.load_state_dict(copy.deepcopy(
        cstate.optimizer.state_dict()))
    timed_epochs = {}
    for kind, tr in (('captured', cap), ('eager', eag)):
      st = cstate if kind == 'captured' else estate
      ops.reset_launch_counts()
      if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
      a = _event(torch, cuda)
      st, losses, _ = tr.run_epoch(st)
      z = _event(torch, cuda)
      if cuda:
        z.synchronize()
      timed_epochs[kind] = dict(
          ms_per_step=_span(a, z, cuda) / steps, losses=losses,
          launches=ops.launch_counts(),
          peak_bytes=torch.cuda.max_memory_allocated() if cuda else None)
      if kind == 'captured':
        cstate = st
      else:
        estate = st
    cap_ep, eag_ep = timed_epochs['captured'], timed_epochs['eager']
    want = mode_launches(name, steps, hops, chunks, int(padded))
    for ep in (cap_ep, eag_ep):
      got = {k: ep['launches'][k] for k in want}
      assert got == {k: per * v for k, v in want.items()}, (name, got, want)
    assert bool(torch.isfinite(cap_ep['losses']).all()), name
    rtol = BF16_TOL if bf16 else 1e-4
    torch.testing.assert_close(cap_ep['losses'], eag_ep['losses'], rtol=rtol,
                               atol=0)
    loss_rel = float(((cap_ep['losses'] - eag_ep['losses']).abs() /
                      eag_ep['losses'].abs()).max())
    table = None
    if padded:
      tab = sampler._padded_arrays()['tab']
      assert sampler._padded_seed == 1 and cap.loader._epochs_started == 2
      assert not torch.equal(tab, first_tab), 'the reseed kept the table'
      assert torch.equal(tab, eag._sampler._padded_arrays()['tab'])
      t1 = time.perf_counter()
      cpu_tab, cpu_deg, child_s = padded_rebuild_take(
          torch, rebuild, sampler.padded_window, sampler._padded_seed)
      wait_s = time.perf_counter() - t1
      assert torch.equal(tab.cpu(), cpu_tab), 'card table != CPU rebuild'
      table = dict(window=sampler.padded_window, seed=sampler._padded_seed,
                   changed_rows=int((tab != first_tab).any(1).sum()),
                   cpu_rebuild_s=child_s, child_wait_s=wait_s)
      log(f'modes {name}: reseeded table (seed {table["seed"]}, W='
          f'{table["window"]}) differs from the first in '
          f'{table["changed_rows"]} rows and equals the CPU rebuild from the '
          f'same key ({table["cpu_rebuild_s"]:.1f} s on the CPU in a child '
          f'beside the earlier phases, waited {table["child_wait_s"]:.1f} '
          's)')
    # one sampled batch through the entry points, recomputed on the CPU
    cmodel.eval()
    seeds = pool[:BATCH]
    state = sampler.state_dict()
    ops.reset_launch_counts()
    e0 = _event(torch, cuda)
    out = sampler.sample_from_nodes(NodeSamplerInput(seeds), batch_cap=BATCH)
    batch = cap.loader._collate_fn(out)
    with torch.no_grad():
      logits = train.make_forward_fn(cmodel)(train.batch_to_dict(batch))
    e1 = _event(torch, cuda)
    if cuda:
      e1.synchronize()
    inf_counts = ops.launch_counts()
    want_inf = mode_launches(name, 1, hops)
    assert {k: inf_counts[k] for k in want_inf} == \
        {k: per * v for k, v in want_inf.items()}, (name, inf_counts)
    assert bool(torch.isfinite(logits.float()).all()), name
    assert logits.dtype == (torch.bfloat16 if bf16 else torch.float32)
    cl = loader(cpu_ds, 'cpu', seeds)
    cl.sampler.load_state_dict(state)
    if padded:
      cl.sampler._padded_seed = sampler._padded_seed
      cl.sampler._padded = dict(tab=cpu_tab, deg=cpu_deg)
    cout = cl.sampler.sample_from_nodes(NodeSamplerInput(seeds),
                                        batch_cap=BATCH)
    cbatch = cl._collate_fn(cout)
    cm = mode_model(torch, gtt, kw, bf16, 'cpu')
    cm.load_state_dict({k: v.cpu() for k, v in cmodel.state_dict().items()})
    cm.eval()
    with torch.no_grad():
      clog = train.make_forward_fn(cm)(train.batch_to_dict(cbatch))
    for field in ('node', 'num_nodes', 'row', 'col', 'edge_mask'):
      assert torch.equal(getattr(out, field).cpu(), getattr(cout, field)), \
          (name, field)
    assert torch.equal(out.metadata['overflow'].cpu(),
                       cout.metadata['overflow'])
    assert torch.equal(batch.x.cpu(), cbatch.x), (name, 'x')
    assert torch.equal(batch.y.cpu(), cbatch.y), (name, 'y')
    glog = logits.float().cpu()
    clog = clog.float()
    if bf16:
      torch.testing.assert_close(glog, clog, rtol=0,
                                 atol=BF16_TOL * float(clog.abs().max()))
    else:
      torch.testing.assert_close(glog, clog, rtol=1e-3, atol=1e-4)
    # a profiled third epoch (after the batch: it reseeds a padded table):
    # device busy per step, the profiler's kernels against the counters
    cmodel.train()
    holder = [cstate]

    def epoch():
      holder[0] = cap.run_epoch(holder[0])[0]

    # an epoch in the profiler's warm-up cycle, then the counters from 0
    # (C6)
    prof = profiled(torch, epoch, 1, device,
                    f'modes {name} ScanTrainer epoch (captured)',
                    warmup=lambda: (epoch(), ops.reset_launch_counts()),
                    expect=port_launch_counts)
    cstate = holder[0]
    counted = port_launch_counts()
    assert prof['kernels'] == counted, (name, prof['kernels'], counted)
    rec = dict(
        loader=kw, bf16=bf16, steps=steps, chunk_size=chunk,
        ms_per_step_captured=cap_ep['ms_per_step'],
        ms_per_step_eager=eag_ep['ms_per_step'],
        warmup_epoch_ms_per_step=warm_ms, capture_ms=cap.capture_ms,
        device_busy_ms_per_step=prof['device_busy_ms'] / steps,
        device_ops_per_step=prof['device_ops_per_call'] / steps,
        profiled_wall_ms_per_step=prof['wall_ms'] / steps,
        peak_bytes_captured=cap_ep['peak_bytes'],
        peak_bytes_eager=eag_ep['peak_bytes'],
        launches=cap_ep['launches'], launches_eager=eag_ep['launches'],
        inference_launches=inf_counts,
        inference_ms=_span(e0, e1, cuda),
        max_rel_loss_diff_eager=loss_rel,
        losses=cap_ep['losses'].tolist(),
        overflow=bool(out.metadata['overflow']),
        num_sampled_nodes=[int(c) for c in cout.num_sampled_nodes],
        max_abs_logit_diff=float((glog - clog).abs().max()),
        top_device_ms=prof['top_device_ms'], padded_table=table,
        phase_s=time.perf_counter() - t0)
    rep[name] = rec
    log(f'modes {name}: captured {rec["ms_per_step_captured"]:.3f} ms/step, '
        f'eager {rec["ms_per_step_eager"]:.3f} (warm-up epoch '
        f'{warm_ms:.3f}); device busy {rec["device_busy_ms_per_step"]:.3f} '
        f'ms/step in {rec["device_ops_per_step"]:.1f} ops; peak '
        f'{rec["peak_bytes_captured"]} B captured, {rec["peak_bytes_eager"]} '
        f'B eager; losses {rec["losses"][0]:.4f} -> {rec["losses"][-1]:.4f}, '
        f'vs eager max rel {loss_rel:.3g} (rtol {rtol}); launches '
        f'{ {k: cap_ep["launches"][k] for k in want} }; batch: nodes '
        f'{rec["num_sampled_nodes"]} overflow {rec["overflow"]}, logits vs '
        f'CPU max abs {rec["max_abs_logit_diff"]:.3g}; {rec["phase_s"]:.1f} s '
        f'on {smi}')
    del cap, eag, cmodel, emodel, cstate, estate, out, batch, logits
    if cuda:
      torch.cuda.empty_cache()
  return rep


def noise_phase(torch, gtt, ds, device, n_nodes, windows, runs) -> dict:
  """The noise two checks must stand (``--noise``): ``windows``
  torch.profiler windows over a captured tree ScanTrainer epoch with no
  lead and as many with PROFILE_LEAD_S, counting the windows whose
  kernels fall short of the launch counters and those with fewer device
  ops than the most any window saw; then ``runs`` merge per-step loops
  from one start (the backward's scatter atomics sum in no fixed order,
  so each run's last state differs), each last step's
  :func:`cpu_step_readings`."""
  import collections
  import copy

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.models import train
  pool = np.random.default_rng(4).permutation(n_nodes)[:BATCH * TRAIN_STEPS]
  loader = make_loader(gtt, ds, pool, device, 'tree')
  model, _ = make_model(torch, gtt, loader, device, 0)
  model.train()
  trainer = gtt.loader.ScanTrainer(loader, model, CLASSES,
                                   chunk_size=TRAIN_CHUNK)
  holder = [train.create_train_state(model, lr=LR)]

  def epoch():
    holder[0] = trainer.run_epoch(holder[0])[0]

  epoch()
  epoch()
  rep = {}
  for lead in (0.0, PROFILE_LEAD_S):
    short, n_ops = 0, []
    for _ in range(windows):
      ops.reset_launch_counts()
      prof = profiled(torch, epoch, 1, device, f'noise lead {lead}', lead)
      counted = {k: v for k, v in ops.launch_counts().items()
                 if k in PORT_KERNELS}
      short += prof['kernels'] != counted
      n_ops.append(prof['device_ops_per_call'])
    rep[f'profiler_lead_{lead}'] = dict(
        windows=windows, kernels_short=short,
        fewer_ops=sum(n < max(n_ops, default=0) for n in n_ops),
        device_ops=dict(collections.Counter(n_ops)))
    log(f'noise: profiler lead {lead} s: {windows} windows, kernels short '
        f'of the counters in {short}, fewer device ops than the most in '
        f'{rep[f"profiler_lead_{lead}"]["fewer_ops"]}')
  del trainer, model, holder
  merge = make_loader(gtt, ds, pool, device, 'merge')
  rep['merge_step'] = []
  for r in range(runs):
    model, _ = make_model(torch, gtt, merge, device, 0)
    model.train()
    state = train.create_train_state(model, lr=LR)
    step_fn, _ = train.make_train_step(model, CLASSES)
    it = iter(merge)
    for i in range(TRAIN_STEPS):
      d = train.batch_to_dict(next(it))
      if i == TRAIN_STEPS - 1:
        check = (copy.deepcopy(model.state_dict()),
                 copy.deepcopy(state.optimizer.state_dict()),
                 {k: (v.cpu() if torch.is_tensor(v) else v)
                  for k, v in d.items()})
        pre = {}
        hooks = relu_input_hooks(model, recorder(pre))
      state, loss, _ = step_fn(state, d)
    for h in hooks:
      h.remove()
    for _ in it:
      raise AssertionError('the pool holds more batches than steps')
    check += ([p.grad.detach().cpu() for p in model.parameters()],
              {k: z.cpu() for k, z in pre.items()})
    c = cpu_step_readings(torch, gtt, merge, model, check, loss)
    rep['merge_step'].append(c)
    log(f'noise: merge run {r}: ReLU inputs {c["pre_diff"]:.3g} apart, '
        f'{c["opposite"]} on opposite sides (leaky_relu inputs '
        f'{c["leaky_opposite"]}; largest '
        f'{c["opposite_max_abs"]:.3g}); gradients {c["grad_share"]:.3g} of the '
        f'largest (outside: {c["grad_fail"]}); Adam on the card\'s '
        f'gradients {c["adam_diff"]:.3g} (outside: {c["adam_fail"]}); '
        f'the CPU\'s plain step: gradients {c["plain_grad_share"]:.3g} of '
        f'the largest, params {c["max_abs_param_diff"]:.3g} apart')
  steps = rep['merge_step']
  if steps:
    outside = sum(bool(c['pre_fail'] or c['grad_fail'] or c['adam_fail'])
                  for c in steps)
    log('noise: merge runs: largest readings ' + ', '.join(
        f'{k} {max(c[k] for c in steps):.3g}' for k in (
            'pre_diff', 'grad_share', 'adam_diff', 'plain_grad_share',
            'max_abs_param_diff')) +
        f'; runs with inputs on opposite sides '
        f'{sum(c["opposite"] > 0 for c in steps)}, outside a tolerance '
        f'{outside}, plain params beyond 1e-5 '
        f'{sum(c["max_abs_param_diff"] > 1e-5 for c in steps)} of '
        f'{len(steps)}')
  return rep


def link_pairs_in_graph(topo, rows, cols) -> np.ndarray:
  """Host check against the CSR: is (rows[i], cols[i]) an edge?"""
  indptr, indices = topo.indptr, topo.indices
  return np.array([bool((indices[indptr[r]:indptr[r + 1]] == c).any())
                   for r, c in zip(rows.tolist(), cols.tolist())])


def link_run(torch, gtt, ds, device, pool, steps, name, kw, smi):
  """One run of the link path at the unsupervised example's width:
  ``LinkNeighborLoader`` (binary negatives) -> ``link_batch_to_dict`` ->
  the link train step with Adam, the per-step loop over one epoch of
  ``pool``, launch counters set to 0 before and read after."""
  import copy
  import gc

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import NegativeSampling
  cuda = device.type == 'cuda'
  b = LINK_BATCH

  def loader_on(d, dset):
    return gtt.loader.LinkNeighborLoader(
        dset, LINK_FANOUTS, pool, neg_sampling=NegativeSampling('binary', 1),
        batch_size=b, shuffle=True, drop_last=True, seed=0, device=d, **kw)

  def model_on(d):
    return gtt.models.GraphSAGE(
        FEAT_DIM, LINK_HIDDEN, LINK_HIDDEN, num_layers=len(LINK_FANOUTS),
        device=d, generator=torch.Generator().manual_seed(0))

  loader = loader_on(device, ds)
  model = model_on(device)
  model.train()
  state = train.create_train_state(model, lr=LR)
  step_fn, _ = train.make_link_train_step(model)
  ops.reset_launch_counts()
  per_step, losses, pairs_ok, negs, poss, check = [], [], [], [], [], None
  it = iter(loader)
  for i in range(steps):
    if cuda and i == 1:
      torch.cuda.reset_peak_memory_stats()
    e0 = _event(torch, cuda)
    batch = next(it)
    e1 = _event(torch, cuda)
    d = train.link_batch_to_dict(batch)
    if i == steps - 1:     # the step recomputed on the CPU below
      check = (copy.deepcopy(model.state_dict()),
               copy.deepcopy(state.optimizer.state_dict()),
               {k: v.cpu() for k, v in d.items()})
      pre = {}
      hooks = relu_input_hooks(model, recorder(pre))
    state, loss, _ = step_fn(state, d)
    e2 = _event(torch, cuda)
    if cuda:
      e2.synchronize()
    if i == steps - 1:
      for h in hooks:
        h.remove()
      check += ([p.grad.detach().cpu() for p in model.parameters()],
                {k: z.cpu() for k, z in pre.items()})
    per_step.append(dict(sample_collate_ms=_span(e0, e1, cuda),
                         train_ms=_span(e1, e2, cuda)))
    losses.append(loss)
    # the seed union leads with the positives' and the negatives' ends
    seeds = batch.batch
    src = torch.cat([seeds[:b], seeds[2 * b:3 * b]])
    dst = torch.cat([seeds[b:2 * b], seeds[3 * b:4 * b]])
    eli = batch.metadata['edge_label_index'].long()
    pairs_ok.append(torch.equal(batch.node[eli[0]], src) and
                    torch.equal(batch.node[eli[1]], dst))
    poss.append(seeds[:2 * b])
    negs.append(seeds[2 * b:4 * b])
  peak = torch.cuda.max_memory_allocated() if cuda else None
  for _ in it:             # the iterator's end: the overflow guard's check
    raise AssertionError('the pool holds more batches than steps')
  counts = ops.launch_counts()
  per = 1 if cuda else 0
  merge = loader.sampler._dedup_mode() == 'merge'
  hops = len(LINK_FANOUTS)
  assert counts['negative_sample'] == per * steps, counts
  assert counts['gather_rows'] == per * steps, counts
  if merge:
    assert counts['sample_level'] == per * steps * (3 * hops + 1), counts
    assert counts['sample_hop'] == 0, counts
  else:
    assert counts['sample_hop'] == per * steps * hops, counts
    assert counts['sample_level'] == 0, counts
  assert not loader.check_overflow(), 'a link batch overflowed its caps'
  assert all(pairs_ok), 'node[edge_label_index] is not the batch\'s pairs'
  losses = torch.stack(losses)
  assert bool(torch.isfinite(losses).all()), 'non-finite link loss'
  # every negative is absent from the graph, every positive present
  topo = ds.graph.topo
  neg = torch.stack(negs).cpu().numpy().reshape(steps, 2, b)
  pos = torch.stack(poss).cpu().numpy().reshape(steps, 2, b)
  neg_edges = int(link_pairs_in_graph(topo, neg[:, 0].ravel(),
                                      neg[:, 1].ravel()).sum())
  pos_edges = int(link_pairs_in_graph(topo, pos[:, 0].ravel(),
                                      pos[:, 1].ravel()).sum())
  assert neg_edges == 0, f'{neg_edges} negatives are edges of the graph'
  assert pos_edges == steps * b, pos_edges
  steady = per_step[1:] or per_step
  med = {k: float(np.median([p[k] for p in steady])) for k in steady[0]}
  rep = dict(per_step=per_step, median_step_ms=med, peak_step_bytes=peak,
             launches=counts, losses=losses.tolist(),
             frontier_caps=(list(loader.sampler.frontier_caps)
                            if loader.sampler.frontier_caps else None),
             negatives_checked=steps * b)
  log(f'link {name}: {steps} steps; launches {counts}; median after the '
      'first step (ms): ' + ' '.join(f'{k}={v:.3f}' for k, v in med.items())
      + f' total={sum(med.values()):.3f}; max_memory_allocated over steps '
      f'2-{steps} {peak} B; losses {losses[0]:.4f} -> {losses[-1]:.4f}; '
      f'{steps * b} negatives none an edge; caps {rep["frontier_caps"]} on '
      f'{smi}')
  # the last step once more on the CPU, from the same state and batch
  c = rep['cpu_check'] = cpu_step_check(
      torch, gtt, loader, model, check, losses[-1],
      cpu_model=lambda: model_on('cpu'),
      make_step=train.make_link_train_step)
  log(f'link {name} CPU recompute of step {steps}: ReLU inputs max abs '
      f'diff {c["pre_diff"]:.3g}, {c["opposite"]} on opposite sides of 0 '
      f'(leaky_relu inputs {c["leaky_opposite"]}); '
      f'loss {c["cpu_loss"]:.6f} vs {c["loss"]:.6f}; gradients '
      f'{c["grad_share"]:.3g} of the largest; CPU Adam on the card\'s '
      f'gradients {c["adam_diff"]:.3g}')
  if cuda:
    # host syncs of the loop (loader -> link step), a new epoch's first
    # SYNC_STEPS steps (H5)
    it = iter(loader)

    def loop():
      for _ in range(SYNC_STEPS):
        step_fn(state, train.link_batch_to_dict(next(it)))

    _, syncs, kinds = count_syncs(torch, loop)
    rep['host_syncs_per_step'] = syncs / SYNC_STEPS
    rep['host_sync_kinds'] = kinds
    log(f'link {name}: {syncs / SYNC_STEPS:.2f} host syncs per loop step '
        f'{kinds}')
    # one more step under torch.profiler: device ops and busy, and the
    # port's kernels it saw against the counters (the cyclic collector
    # run first, so no earlier trainer's CUDA graph is freed in the window;
    # late in this script a window without a warm-up cycle lost the link
    # step's first 5 device records, the negative kernel among them, in 2
    # of 2 runs, where a process running the link phase alone lost none)
    gc.collect()

    more = Batches(loader, it)

    def loop_step():
      step_fn(state, train.link_batch_to_dict(more()))

    # a step in the profiler's warm-up cycle, then the counters from 0
    prof = profiled(torch, loop_step, 1, device, f'link {name} loop step',
                    warmup=lambda: (loop_step(), ops.reset_launch_counts()),
                    expect=port_launch_counts)
    counted = port_launch_counts()
    assert prof['kernels'] == counted, (prof['kernels'], counted)
    assert counted['negative_sample'] == 1, counted
    prof['launch_counters'] = counted
    rep['profile_step'] = prof
  return rep


def link_phase(torch, gtt, ds, device, smi):
  """The link path (negatives in one kernel launch a batch, K3 or K4,
  K1) under the merge engine, the tree engine and calibrated caps, over
  a seeded pool of the graph's own edges."""
  cuda = device.type == 'cuda'
  steps = LINK_STEPS if cuda else 4
  topo = ds.graph.topo
  src = np.repeat(np.arange(topo.num_nodes), np.diff(topo.indptr))
  pick = np.random.default_rng(8).choice(topo.num_edges, LINK_BATCH * steps,
                                         replace=False)
  pool = np.stack([src[pick], topo.indices[pick]])
  runs = {}
  for name, kw in (('merge', dict(dedup='auto')),
                   ('tree', dict(dedup='tree')),
                   ('merge_caps', dict(dedup='auto', frontier_caps='auto'))):
    runs[name] = link_run(torch, gtt, ds, device, pool, steps, name, kw, smi)
    if cuda:
      torch.cuda.empty_cache()
  return runs


def subgraph_phase(torch, gtt, ds, cpu_ds, ei, device, smi):
  """``SubGraphLoader([10, 5], batch_size=256, with_edge=True)`` over the
  graph with an edge-feature table: two exact and two bucketed batches,
  each equal to a CPU loader's from the same sampler stream, every kept
  edge the COO edge ``ei[:, id]`` its id names."""
  from graphlearn_tpu_torch import ops
  cuda = device.type == 'cuda'
  topo = ds.graph.topo
  seeds = np.random.default_rng(9).permutation(topo.num_nodes)[
      :2 * SUB_BATCH]
  rep = {}
  for bucketed in (False, True):
    loaders = [gtt.loader.SubGraphLoader(
        d, LINK_FANOUTS, seeds, batch_size=SUB_BATCH, with_edge=True, seed=0,
        bucketed=bucketed, device=dev)
        for d, dev in ((ds, device), (cpu_ds, torch.device('cpu')))]
    ops.reset_launch_counts()
    it, times, batches = iter(loaders[0]), [], []
    for _ in range(2):
      e0 = _event(torch, cuda)
      batches.append(next(it))
      e1 = _event(torch, cuda)
      if cuda:
        e1.synchronize()
      times.append(_span(e0, e1, cuda))
    counts = ops.launch_counts()
    per = 1 if cuda else 0
    assert counts['sample_level'] == per * 2 * (3 * len(LINK_FANOUTS) + 1)
    assert counts['gather_rows'] == per * 2, counts
    kept = 0
    for gb, cb in zip(batches, loaders[1]):
      for f in ('node', 'num_nodes', 'edge_index', 'edge_mask', 'edge_ids',
                'edge_attr', 'x', 'batch'):
        assert torch.equal(getattr(gb, f).cpu(), getattr(cb, f)), f
      for k, v in cb.metadata.items():
        assert torch.equal(gb.metadata[k].cpu(), v), k
      em = cb.edge_mask.numpy()
      eid = cb.edge_ids.numpy()[em]
      node = cb.node.numpy()
      assert (ei[0][eid] == node[cb.edge_index[0].numpy()[em]]).all()
      assert (ei[1][eid] == node[cb.edge_index[1].numpy()[em]]).all()
      assert (cb.metadata['mapping'].numpy() >= 0).all()
      kept += int(em.sum())
    name = 'bucketed' if bucketed else 'exact'
    dropped = (int(batches[-1].metadata['num_dropped_rows'])
               if bucketed else None)
    rep[name] = dict(ms_per_batch=times, launches=counts, edges_kept=kept,
                     edge_slots=int(batches[0].edge_mask.shape[0]),
                     num_dropped_rows=dropped)
    log(f'subgraph {name}: ms per batch {[round(t, 3) for t in times]}; '
        f'{kept} edges kept in 2 batches of '
        f'{rep[name]["edge_slots"]} slots, equal to the CPU\'s; dropped '
        f'rows {dropped}; launches {counts} on {smi}')
    if cuda:
      torch.cuda.empty_cache()
  return rep


def legacy_phase(torch, gtt, ds, cpu_ds, device, pool, smi):
  """One products-width batch of each legacy exact engine (hops through
  K3, the gather through K1), ids equal to a CPU recompute."""
  from graphlearn_tpu_torch import ops
  cuda = device.type == 'cuda'
  rep = {}
  for mode in ('map_table', 'sort_legacy'):
    outs = []
    for d, dev in ((ds, device), (cpu_ds, torch.device('cpu'))):
      loader = gtt.loader.NeighborLoader(d, FANOUTS, pool[:BATCH],
                                         batch_size=BATCH, seed=0,
                                         dedup=mode, device=dev)
      ops.reset_launch_counts()
      e0 = _event(torch, cuda)
      outs.append(next(iter(loader)))
      e1 = _event(torch, cuda)
      if dev == device:            # the card's batch (the first)
        if cuda:
          e1.synchronize()
        ms, counts = _span(e0, e1, cuda), ops.launch_counts()
    per = 1 if cuda else 0
    assert counts['sample_hop'] == per * len(FANOUTS), counts
    assert counts['gather_rows'] == per and counts['sample_level'] == 0
    g, c = outs
    for f in ('node', 'num_nodes', 'edge_index', 'edge_mask', 'x', 'y'):
      assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), (mode, f)
    rep[mode] = dict(ms=ms, launches=counts, num_nodes=int(c.num_nodes))
    log(f'legacy {mode}: one batch of {BATCH} seeds {FANOUTS} in '
        f'{ms:.3f} ms, {int(c.num_nodes)} nodes, equal to the CPU\'s; '
        f'launches {counts} on {smi}')
  return rep


# ---- typed sampling and the IGBH RGNN
HET_PAPER, HET_AUTHOR = 100_000, 50_000   # the IGBH example's synthetic
HET_BATCH = 512                           # its batch
HET_HIDDEN = 128                          # its RGNN width
HET_STEPS = 16                            # train steps per run
HET_BATCHES = 4                           # timed inference batches a loader
HET_SEED_FRACTION = 0.1                   # the example's train seeds


def hetero_fields(torch, out) -> dict:
  """The comparable fields of a typed batch (``HeteroData`` or
  ``HeteroSamplerOutput``), on the CPU: node ids, counts, edge index,
  edge mask and, where the batch has them, features and labels."""
  f = {}
  for t in out.node:
    f[f'node/{t}'] = out.node[t]
    f[f'num_nodes/{t}'] = out.num_nodes[t]
    f[f'num_sampled_nodes/{t}'] = torch.stack(
        [torch.as_tensor(c).to(out.node[t].device)
         for c in out.num_sampled_nodes[t]])
  ei = getattr(out, 'edge_index', None)
  for et in out.edge_mask:
    f[f'edge_index/{et}'] = (ei[et] if ei is not None else
                             torch.stack([out.row[et], out.col[et]]))
    f[f'edge_mask/{et}'] = out.edge_mask[et]
    f[f'num_sampled_edges/{et}'] = torch.stack(
        [torch.as_tensor(c) for c in out.num_sampled_edges[et]])
  for name in ('x', 'y'):
    for t, v in (getattr(out, name, None) or {}).items():
      f[f'{name}/{t}'] = v
  return {k: v.cpu() for k, v in f.items()}


def assert_hetero_equal(torch, got, want, what):
  """Two typed batches equal in every field, bit for bit."""
  fg, fw = hetero_fields(torch, got), hetero_fields(torch, want)
  assert sorted(fg) == sorted(fw), (what, sorted(fg), sorted(fw))
  for k in fw:
    assert torch.equal(fg[k], fw[k]), (what, k)


def to_cpu(torch, v):
  """A batch dict (typed: nested dicts of tensors) on the CPU."""
  if isinstance(v, dict):
    return {k: to_cpu(torch, x) for k, x in v.items()}
  return v.cpu() if torch.is_tensor(v) else v


def hetero_data(torch, gtt, ex, n_paper, n_author):
  """``(dataset(device), weighted_graphs(device))``: the IGBH example's
  synthetic (``train_rgnn.make_igbh_like``, seed 0) as a typed dataset
  on a device, through ``Dataset.init_graph``'s dict form, and the same
  three edge types with dyadic edge weights from a seed (the weighted
  hops), through its ``edge_weights`` dict."""
  rng = np.random.default_rng(0)
  cites, writes, feats, label = ex.make_igbh_like(n_paper, n_author,
                                                  ex.NUM_CLASSES, rng)
  edges = {ex.CITES: cites, ex.WRITES: writes,
           ex.REV_WRITES: writes[::-1].copy()}
  nodes = {ex.CITES: n_paper, ex.WRITES: n_author, ex.REV_WRITES: n_paper}
  wrng = np.random.default_rng(9)
  weights = {et: (wrng.integers(1, 9, ei.shape[1]) / 4).astype(np.float32)
             for et, ei in edges.items()}

  def dataset(dev):
    ds = gtt.data.Dataset(edge_dir='out', device=dev)
    ds.init_graph(edges, num_nodes=nodes)
    ds.init_node_features(feats)
    ds.init_node_labels({'paper': label})
    return ds

  def weighted_graphs(dev):
    return gtt.data.Dataset(edge_dir='out', device=dev).init_graph(
        edges, edge_weights=weights, num_nodes=nodes).graph

  return dataset, weighted_graphs


def hetero_loader(gtt, ex, ds, pool, device, kind, caps, b):
  """The example's typed loader (shuffled, drop_last, seed 0): tree, or
  merge under the calibrated caps with the overflow guard raising."""
  kw = (dict(dedup='tree') if kind == 'tree' else
        dict(dedup='merge', frontier_caps=caps, overflow_policy='raise'))
  return gtt.loader.NeighborLoader(ds, ex.FANOUTS, ('paper', pool),
                                   batch_size=b, shuffle=True,
                                   drop_last=True, seed=0, device=device,
                                   **kw)


def hetero_items(gtt, ex, b, caps=None) -> int:
  """The (hop, edge type) items of the typed plan: one hop each."""
  _, hop_caps, _ = gtt.sampler.hetero_capacity_plan(
      list(ex.FANOUTS), lambda et: ex.FANOUTS[et], {'paper': b}, 'out',
      etype_caps=caps)
  return sum(len(per_et) for per_et in hop_caps)


def hetero_batches(torch, gtt, ex, ds, cpu_ds, pool, device, kind, caps, b,
                   nb, smi):
  """``nb`` typed batches of the example's loader after a warm-up one,
  sample + collate timed by CUDA events, with the launch counters set to
  0 before and read after (the hop kernel once per plan item, the row
  gather once per featured type); the last batch equal to the CPU's from
  the same sampler state, bit for bit; one more batch under
  torch.profiler (its kernels equal to the counters), the epoch drained
  but two batches before it, so a window recorded again goes on into the
  next epoch (``Batches``); no batch of the first epoch truncated
  (merge), every one of them counted."""
  from graphlearn_tpu_torch import ops
  cuda = device.type == 'cuda'
  loader = hetero_loader(gtt, ex, ds, pool, device, kind, caps, b)
  cpu_loader = hetero_loader(gtt, ex, cpu_ds, pool, torch.device('cpu'),
                             kind, caps, b)
  items = hetero_items(gtt, ex, b, caps if kind == 'merge' else None)
  it = iter(loader)
  # the first use of the graphs and tables
  flags = [next(it).metadata['overflow']]
  ops.reset_launch_counts()
  per, batches = [], []
  for i in range(nb):
    if i == nb - 1:
      state = loader.sampler.state_dict()
    e0 = _event(torch, cuda)
    batch = next(it)
    e1 = _event(torch, cuda)
    if cuda:
      e1.synchronize()
    per.append(_span(e0, e1, cuda))
    batches.append(batch)
    flags.append(batch.metadata['overflow'])
  counts = ops.launch_counts()
  per_l = 1 if cuda else 0
  assert counts['sample_hop'] == per_l * nb * items, (kind, counts)
  assert counts['gather_rows'] == per_l * nb * len(ds.node_features), (
      kind, counts)
  assert counts['sample_level'] == counts['uniform_draw'] == 0, counts
  # the last batch on the CPU, from the same sampler state and seeds
  cpu_loader.sampler.load_state_dict(state)
  seeds = batches[-1].batch['paper'].cpu().numpy()
  want = cpu_loader._collate_fn(cpu_loader.sampler.sample_from_nodes(
      gtt.sampler.NodeSamplerInput(seeds, 'paper'), batch_cap=b))
  assert_hetero_equal(torch, batches[-1], want, f'{kind} batch')
  rec = dict(sample_collate_ms=per, launches=counts, items=items,
             nodes={t: int(n) for t, n in want.num_nodes.items()},
             node_caps={t: int(v.shape[0]) for t, v in want.node.items()},
             edges={str(et): int(m.sum())
                    for et, m in want.edge_mask.items()})
  if cuda:
    assert len(loader) >= len(flags) + 2, (len(loader), len(flags))
    for _ in range(len(loader) - len(flags) - 2):
      flags.append(next(it).metadata['overflow'])
    more = Batches(loader, it,
                   first=lambda batch: flags.append(batch.metadata['overflow']))
    prof = profiled(torch, more, 1, device, f'hetero {kind} batch',
                    warmup=lambda: (more(), ops.reset_launch_counts()),
                    expect=port_launch_counts)
    counted = port_launch_counts()
    assert prof['kernels'] == counted, (prof['kernels'], counted)
    rec['profile_batch'] = prof
    rec['profile_rolled_epoch'] = more.rolled
    it = iter(()) if more.rolled else more.it
  for batch in it:              # the epoch's end: the overflow guard's check
    flags.append(batch.metadata['overflow'])
  # every batch of the first epoch, and only those
  assert len(flags) == len(loader), (kind, len(flags), len(loader))
  rec['truncated_batches'] = int(torch.stack(flags).sum())
  assert rec['truncated_batches'] == 0, rec['truncated_batches']
  med = float(np.median(per))
  log(f'hetero {kind}: {nb} batches of {b} paper seeds, sample+collate '
      f'median {med:.3f} ms; {items} hop items a batch; launches {counts}; '
      f'nodes {rec["nodes"]} of {rec["node_caps"]}; edges {rec["edges"]}; '
      f'{rec["truncated_batches"]} truncated; the last batch equal to the '
      f'CPU\'s on {smi}')
  return rec, batches


def hetero_menu_batches(torch, gtt, ex, wgraphs, pool, device, b, smi):
  """One block (tree) and one weighted (merge) typed batch on a copy of
  the graph with edge weights, each equal to the same batch sampled on
  the CPU from the same stream position, with the draw kernel launched
  twice (block) or once (weighted) per plan item and no hop kernel."""
  from graphlearn_tpu_torch import ops
  cuda = device.type == 'cuda'
  cpu = torch.device('cpu')
  items = hetero_items(gtt, ex, b)
  inp = gtt.sampler.NodeSamplerInput(pool[:b], 'paper')
  rep = {}
  for name, kw, draws in (('block', dict(strategy='block', dedup='tree'), 2),
                          ('weighted', dict(with_weight=True,
                                            dedup='merge'), 1)):
    card, host = (gtt.sampler.NeighborSampler(
        wgraphs(d), ex.FANOUTS, seed=2, device=d, edge_dir='out', **kw)
        for d in (device, cpu))
    card.sample_from_nodes(inp, batch_cap=b)    # builds the view / CDF
    host.load_state_dict(card.state_dict())
    ops.reset_launch_counts()
    e0 = _event(torch, cuda)
    out = card.sample_from_nodes(inp, batch_cap=b)
    e1 = _event(torch, cuda)
    if cuda:
      e1.synchronize()
    counts = ops.launch_counts()
    per = 1 if cuda else 0
    assert counts['uniform_draw'] == per * draws * items, (name, counts)
    assert counts['sample_hop'] == counts['sample_level'] == 0, counts
    assert_hetero_equal(torch, out, host.sample_from_nodes(inp, batch_cap=b),
                        f'{name} batch')
    rep[name] = dict(ms=_span(e0, e1, cuda), launches=counts,
                     nodes={t: int(n) for t, n in out.num_nodes.items()})
    log(f'hetero {name}: one typed batch in {rep[name]["ms"]:.3f} ms, '
        f'nodes {rep[name]["nodes"]}, equal to the CPU\'s; launches '
        f'{counts} on {smi}')
  return rep


def hetero_dense_weights(seg_sd, dense):
  """The segment RGNN's weights in ``dense``'s names: each stored edge
  type's ``{lin_self,lin_nbr,lin,att_src,att_dst}_{ename}`` is the conv
  of its message-direction type (``hetero{i}.convs.{reversed}``)."""
  from graphlearn_tpu_torch.typing import (as_str, reverse_edge_type,
                                           to_edge_type)
  sd = {}
  for name in dense.state_dict():
    head, _, rest = name.partition('.')
    if not head.startswith('hetero'):
      sd[name] = seg_sd[name]
      continue
    pname, _, leaf = rest.partition('.')
    for kind in ('lin_self', 'lin_nbr', 'att_src', 'att_dst', 'lin'):
      if pname.startswith(kind + '_'):
        msg = as_str(reverse_edge_type(to_edge_type(pname[len(kind) + 1:])))
        sd[name] = seg_sd['.'.join(
            [head, 'convs', msg, kind] + ([leaf] if leaf else []))]
        break
  return sd


def hetero_inference(torch, gtt, ex, batches, caps, device, b, smi):
  """``RGNN`` rsage and rgat (4 heads) from one set of weights: the
  tree-dense, hierarchical and segment forwards over the tree batches, the
  segment and merge-dense forwards over the calibrated merge batches.
  Forward ms per batch by CUDA events; finite logits of the expected
  shape; the last batch's logits within rtol 1e-3, atol 1e-4 of the CPU's
  (TF32 off); the dense forwards' seed logits within the same of the
  segment forward's and the hierarchical ones within rtol 1e-5, atol 1e-6
  of the full forward's (``tests/test_models.py:424``)."""
  cuda = device.type == 'cuda'
  cpu = torch.device('cpu')
  rep = {}
  depth1 = gtt.sampler.hetero_tree_layout(
      {'paper': b}, tuple(ex.FANOUTS), ex.FANOUTS)[0]['paper'][1]
  runs = (('tree', 'segment'), ('tree', 'hierarchical'),
          ('tree', 'tree_dense'), ('merge', 'segment'),
          ('merge', 'merge_dense'))
  for conv in ('rsage', 'rgat'):
    seg_sd = ex.build_model(conv, b, HET_HIDDEN, cpu, mode='segment',
                            generator=torch.Generator().manual_seed(0)
                            ).state_dict()
    logits = {}
    for kind, mode in runs:
      models = {}
      for d in (device, cpu):
        m = ex.build_model(conv, b, HET_HIDDEN, d, mode=mode,
                           etype_caps=caps if kind == 'merge' else None)
        m.load_state_dict(seg_sd if mode in ('segment', 'hierarchical')
                          else hetero_dense_weights(seg_sd, m))
        m.eval()
        models[d.type] = m
      ms, outs = [], []
      with torch.no_grad():
        for batch in batches[kind]:
          e0 = _event(torch, cuda)
          out = models[device.type](batch.x, batch.edge_index,
                                    batch.edge_mask)
          e1 = _event(torch, cuda)
          if cuda:
            e1.synchronize()
          ms.append(_span(e0, e1, cuda))
          outs.append(out)
        last = batches[kind][-1]
        want = models['cpu'](*(to_cpu(torch, v) for v in (
            last.x, last.edge_index, last.edge_mask)))
      # the segment forward gives every paper slot, the hierarchical one
      # the slots of depth <= 1 (its last layer's input), the dense ones
      # the seed block
      rows = (last.x['paper'].shape[0] if mode == 'segment' else
              depth1 if mode == 'hierarchical' else b)
      for out in outs:
        assert out.shape == (rows, ex.NUM_CLASSES), (mode, out.shape)
        assert bool(torch.isfinite(out).all()), (conv, kind, mode)
      got = outs[-1].cpu()
      diff = float((got - want).abs().max())
      torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
      logits[kind, mode] = got[:b]
      rep[f'{conv}/{kind}/{mode}'] = dict(
          forward_ms=ms, median_forward_ms=float(np.median(ms)),
          cpu_max_abs_diff=diff)
      log(f'hetero {conv} {mode} on {kind} batches: forward median '
          f'{np.median(ms):.3f} ms/batch, logits [{rows}, '
          f'{ex.NUM_CLASSES}] within {diff:.3g} of the CPU\'s on {smi}')
    for kind, mode in runs:
      ref = logits[kind, 'segment']
      if mode == 'hierarchical':
        torch.testing.assert_close(logits[kind, mode], ref, rtol=1e-5,
                                   atol=1e-6)
      elif mode != 'segment':
        torch.testing.assert_close(logits[kind, mode], ref, rtol=1e-3,
                                   atol=1e-4)
  return rep


def loop_train(torch, gtt, loader, model_on, num_classes, steps, expect,
               smi, label, make_step=None, to_dict=None, lr=LR, hold=True):
  """The examples' loop (loader -> batch_to_dict -> train_step, Adam at
  ``lr``; ``make_step(model)`` / ``to_dict(batch)`` another example's
  step and batch dict) for ``steps`` steps of the model
  ``model_on(device)`` builds (weights from a fixed seed): ms/step split into sample+collate and
  train by CUDA events, peak memory, the launch counters (set to 0
  before) equal to ``expect``, no batch over its caps, the last step
  recomputed on the CPU from the card's state before it
  (``cpu_step_check``: a merge path's scatter atomics sum in no fixed
  order, so it is held from that common state, C5's rule; with ``hold``
  false only read, ``cpu_step_readings``), host syncs per
  step of SYNC_STEPS more steps (they must be 0), and one
  more step under torch.profiler (device ops, busy and idle share; its
  kernels equal to the counters)."""
  import copy

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.models import train
  cuda = loader.device.type == 'cuda'
  make_step = make_step or (lambda m: train.make_train_step(m, num_classes))
  to_dict = to_dict or train.batch_to_dict
  model = model_on(loader.device)
  model.train()
  state = train.create_train_state(model, lr=lr)
  step_fn, _ = make_step(model)
  ops.reset_launch_counts()
  per_step, losses, check, held = [], [], None, None
  it = iter(loader)
  for i in range(steps):
    if cuda and i == 1:
      torch.cuda.reset_peak_memory_stats()
      held = torch.cuda.memory_allocated()
    e0 = _event(torch, cuda)
    batch = next(it)
    e1 = _event(torch, cuda)
    d = to_dict(batch)
    if i == steps - 1:       # the step recomputed on the CPU below
      check = (copy.deepcopy(model.state_dict()),
               copy.deepcopy(state.optimizer.state_dict()), to_cpu(torch, d))
      pre = {}
      hooks = relu_input_hooks(model, recorder(pre))
    state, loss, _ = step_fn(state, d)
    e2 = _event(torch, cuda)
    if cuda:
      e2.synchronize()
    if i == steps - 1:
      for h in hooks:
        h.remove()
      check += ([None if p.grad is None else p.grad.detach().cpu()
                 for p in model.parameters()],
                {k: z.cpu() for k, z in pre.items()})
    per_step.append(dict(sample_collate_ms=_span(e0, e1, cuda),
                         train_ms=_span(e1, e2, cuda)))
    losses.append(loss)
  peak = torch.cuda.max_memory_allocated() if cuda else None
  counts = ops.launch_counts()
  for k, v in expect.items():
    assert counts[k] == v, (label, k, counts, expect)
  assert not loader.check_overflow(), f'{label}: a batch overflowed its caps'
  losses = torch.stack(losses)
  assert bool(torch.isfinite(losses).all()), f'{label}: non-finite loss'
  steady = per_step[1:] or per_step
  med = {k: float(np.median([p[k] for p in steady])) for k in steady[0]}
  # the run's own peak: over what the process held when step 2 began
  # (the script's earlier phases keep their graph and tables)
  own = None if peak is None else peak - held
  rep = dict(per_step=per_step, median_step_ms=med, peak_step_bytes=peak,
             peak_over_held_bytes=own, launches=counts,
             losses=losses.tolist())
  log(f'{label}: {steps} steps; launches {counts}; '
      'median after the first step (ms): ' +
      ' '.join(f'{k}={v:.3f}' for k, v in med.items()) +
      f' total={sum(med.values()):.3f}; max_memory_allocated over steps '
      f'2-{steps} {peak} B ({own} B over the {held} B held before); '
      f'losses {losses[0]:.4f} -> {losses[-1]:.4f} on {smi}')
  c = rep['cpu_check'] = (cpu_step_check if hold else cpu_step_readings)(
      torch, gtt, loader, model, check, losses[-1],
      cpu_model=lambda: model_on(torch.device('cpu')),
      make_step=make_step)
  log(f'{label} CPU recompute of step {steps}: ReLU '
      f'inputs max abs diff {c["pre_diff"]:.3g}, {c["opposite"]} on '
      f'opposite sides of 0 (leaky_relu inputs {c["leaky_opposite"]}); loss {c["cpu_loss"]:.6f} vs {c["loss"]:.6f}; '
      f'gradients {c["grad_share"]:.3g} of the largest; CPU Adam on the '
      f'card\'s gradients {c["adam_diff"]:.3g}')
  if cuda:
    it = iter(loader)

    def loop():
      for _ in range(SYNC_STEPS):
        step_fn(state, to_dict(next(it)))

    _, syncs, kinds = count_syncs(torch, loop)
    rep['host_syncs_per_step'] = syncs / SYNC_STEPS
    rep['host_sync_kinds'] = kinds
    assert syncs == 0, (label, kinds)

    more = Batches(loader, it)

    def loop_step():
      step_fn(state, to_dict(more()))

    prof = profiled(torch, loop_step, 1, loader.device, f'{label} step',
                    warmup=lambda: (loop_step(), ops.reset_launch_counts()),
                    expect=port_launch_counts)
    counted = port_launch_counts()
    assert prof['kernels'] == counted, (prof['kernels'], counted)
    prof['launch_counters'] = counted
    rep['profile_step'] = prof
    log(f'{label}: {syncs / SYNC_STEPS:.2f} host syncs per step {kinds}; '
        f'a profiled step: {prof["device_ops_per_call"]:.0f} device ops, '
        f'busy {prof["device_busy_ms"]:.3f} of {prof["wall_ms"]:.3f} ms '
        f'(idle share {prof["idle_share"]:.3f})')
  return rep


def hetero_train(torch, gtt, ex, ds, pool, device, kind, conv, caps, b,
                 steps, smi, hidden=HET_HIDDEN, hold=True):
  """The example's loop (``loop_train``, ``hold`` its) for ``steps`` steps
  of ``conv`` ('rsage' / 'rgat', or the example's own model) in the
  tree-dense (tree
  batches) or merge-dense (calibrated merge batches) forward: the hop
  kernel once per plan item, the row gather once per featured type."""
  mode = 'tree_dense' if kind == 'tree' else 'merge_dense'
  mcaps = caps if kind == 'merge' else None
  loader = hetero_loader(gtt, ex, ds, pool, device, kind, caps, b)
  items = hetero_items(gtt, ex, b, mcaps)
  per = 1 if device.type == 'cuda' else 0
  expect = dict(sample_hop=per * steps * items,
                gather_rows=per * steps * len(ds.node_features),
                sample_level=0, uniform_draw=0)

  def model_on(d):
    return ex.build_model(conv, b, hidden, d, mode=mode, etype_caps=mcaps,
                          generator=torch.Generator().manual_seed(0))

  rep = loop_train(torch, gtt, loader, model_on, ex.NUM_CLASSES, steps,
                   expect, smi, f'hetero train {conv} {mode}', hold=hold)
  rep['items'] = items
  return rep


def hetero_sizes(cuda):
  """The typed path's papers, authors, batch, timed batches a loader and
  train steps: the IGBH example's on the card, a few thousand nodes on
  the CPU."""
  if cuda:
    return HET_PAPER, HET_AUTHOR, HET_BATCH, HET_BATCHES, HET_STEPS
  return 5_000, 2_500, 64, 2, 4


def hetero_pool_caps(gtt, ex, ds, n_paper, b):
  """The example's train seeds and its calibrated merge caps."""
  pool = np.arange(int(n_paper * HET_SEED_FRACTION))
  caps = gtt.sampler.estimate_hetero_frontier_caps(
      ds.graph, ex.FANOUTS, {'paper': b}, input_nodes={'paper': pool})
  return pool, caps


def hetero_noise(torch, gtt, device, runs, smi) -> dict:
  """``runs`` runs of the hetero phase's merge-dense RGAT training from
  one start (``--noise``: the merge backward's scatter atomics sum in no
  fixed order, so each run's last step differs), each last step's
  :func:`cpu_step_readings`, read and not held: the attention logits
  (leaky_relu inputs) on the other side of 0 on the CPU, and the
  gradients with the CPU on the card's side (``grad_share``) and on its
  own (``plain_grad_share``)."""
  from graphlearn_tpu_torch.examples import train_rgnn as ex
  n_paper, n_author, b, _, steps = hetero_sizes(device.type == 'cuda')
  dataset, _ = hetero_data(torch, gtt, ex, n_paper, n_author)
  ds = dataset(device)
  pool, caps = hetero_pool_caps(gtt, ex, ds, n_paper, b)
  reads = []
  for r in range(runs):
    reads.append(hetero_train(torch, gtt, ex, ds, pool, device, 'merge',
                              'rgat', caps, b, steps, smi,
                              hold=False)['cpu_check'])
  flipped = [c for c in reads if c['leaky_opposite']]
  rest = [c for c in reads if not c['leaky_opposite']]

  def most(cs, k):
    return max((c[k] for c in cs), default=None)

  rep = dict(runs=reads, with_leaky_flips=len(flipped),
             expected_flips=sum(c['leaky_expected_flips'] for c in reads),
             outside=sum(bool(c['grad_fail']) for c in reads),
             plain_outside=sum(c['plain_grad_share'] > GRAD_SHARE
                               for c in reads),
             flipped_plain_grad_share=most(flipped, 'plain_grad_share'),
             flipped_grad_share=most(flipped, 'grad_share'),
             rest_plain_grad_share=most(rest, 'plain_grad_share'),
             rest_grad_share=most(rest, 'grad_share'))
  c = reads[-1] if reads else {}
  log(f'noise: hetero rgat merge runs: {len(flipped)} of {runs} with '
      f'leaky_relu inputs on opposite sides ({rep["expected_flips"]} '
      f'expected: a step\'s {c.get("leaky_inputs")} inputs, '
      f'{c.get("leaky_zero")} 0 on both, {c.get("leaky_near0")} more within '
      f'{LEAKY_NEAR0} of 0, a mean card-CPU gap {c.get("leaky_gap")}); '
      f'gradients, CPU on the card\'s '
      f'side / on its own, largest share: those runs '
      f'{rep["flipped_grad_share"]} / {rep["flipped_plain_grad_share"]}, '
      f'the rest {rep["rest_grad_share"]} / {rep["rest_plain_grad_share"]}; '
      f'outside GRAD_SHARE {rep["outside"]} / {rep["plain_outside"]} on '
      f'{smi}')
  return rep


def hetero_phase(torch, gtt, device, smi):
  """The typed path at the IGBH example's width (100,000 papers, 50,000
  authors, 64-wide f32 features; cites [10, 5], writes [5, 3],
  rev_writes [3, 2] at batch 512, edge_dir 'out'): tree and calibrated
  merge batches, a block and a weighted batch, RGNN inference in five
  forwards for rsage and rgat (4 heads), and three training runs."""
  from graphlearn_tpu_torch.examples import train_rgnn as ex
  cuda = device.type == 'cuda'
  t0 = time.perf_counter()
  n_paper, n_author, b, nb, steps = hetero_sizes(cuda)
  dataset, wgraphs = hetero_data(torch, gtt, ex, n_paper, n_author)
  ds, cpu_ds = dataset(device), dataset(torch.device('cpu'))
  pool, caps = hetero_pool_caps(gtt, ex, ds, n_paper, b)
  _, _, full = gtt.sampler.hetero_capacity_plan(
      list(ex.FANOUTS), lambda et: ex.FANOUTS[et], {'paper': b}, 'out')
  _, _, cal = gtt.sampler.hetero_capacity_plan(
      list(ex.FANOUTS), lambda et: ex.FANOUTS[et], {'paper': b}, 'out',
      etype_caps=caps)
  rep = dict(sizes=dict(paper=n_paper, author=n_author, batch=b),
             caps={str(et): v for et, v in caps.items()},
             node_caps=dict(tree=full, merge=cal),
             setup_s=time.perf_counter() - t0)
  log(f'hetero: IGBH-shaped graph ({n_paper} papers, {n_author} authors) '
      f'built in {rep["setup_s"]:.1f} s; calibrated caps {rep["caps"]}; '
      f'node buffers tree {full}, merge {cal}')
  batches = {}
  for kind in ('tree', 'merge'):
    rep[kind], batches[kind] = hetero_batches(
        torch, gtt, ex, ds, cpu_ds, pool, device, kind, caps, b, nb, smi)
  rep['menu'] = hetero_menu_batches(torch, gtt, ex, wgraphs, pool, device,
                                    b, smi)
  rep['inference'] = hetero_inference(torch, gtt, ex, batches, caps, device,
                                      b, smi)
  del batches
  for kind, conv in (('tree', 'rsage'), ('tree', 'rgat'), ('merge', 'rgat')):
    rep[f'train_{conv}_{kind}'] = hetero_train(
        torch, gtt, ex, ds, pool, device, kind, conv, caps, b, steps, smi)
    if cuda:
      torch.cuda.empty_cache()
  rep['phase_s'] = time.perf_counter() - t0
  log(f'hetero phase wall {rep["phase_s"]:.1f} s on {smi}')
  return rep


# ---- the models phase: HGT, the homogeneous GAT family, SEAL
# HGT at examples/hetero/train_hgt_mag.py's defaults (its MAG-shaped
# synthetic: 60,000 papers, 7 edge types, [10, 10] at batch 512, hidden
# 64, 4 heads, 2 layers, 8 classes)
MAG_PAPER, MAG_BATCH, MAG_HIDDEN, MAG_HEADS = 60_000, 512, 64, 4
MAG_BATCHES = 3                    # timed typed batches a loader
MAG_STEPS = 16                     # train steps per run
# GAT at benchmarks/prof_gat_merge.py:3,28's configuration on the
# script's graph: [15, 10, 5] at 1024, hidden 128, 2 heads, 3 layers
# (float32 here, the prof's bf16 aside)
GAT_HIDDEN, GAT_HEADS = 128, 2
GAT_STEPS, GAT_CHUNK = 16, 4       # loop steps; the ScanTrainer's K
GAT_SERVE_LAYERS = 2               # the served GAT's depth
GAT_LOOKUPS = 64                   # engine requests of the GAT store
SEAL_STEPS = 4                     # DGCNN train steps held on the CPU


def mag_example(gtt, n_paper, heads):
  """``(ex, dataset(device))``: the HGT example as the typed helpers
  take an example (``FANOUTS``, ``NUM_CLASSES``, ``build_model``), and
  its MAG-shaped graph on a device (``train_hgt_mag.build_dataset``)."""
  import types

  from graphlearn_tpu_torch.examples import train_hgt_mag as mag

  def build_model(conv, b, hidden, d, mode='tree_dense', etype_caps=None,
                  generator=None):
    del conv    # the example's one model
    return mag.build_model(b, hidden, heads, d, mode=mode,
                           etype_caps=etype_caps, generator=generator)

  ex = types.SimpleNamespace(FANOUTS=mag.FANOUTS,
                             NUM_CLASSES=mag.NUM_CLASSES,
                             build_model=build_model)
  return ex, lambda d: mag.build_dataset(n_paper, d)


def hgt_inference(torch, gtt, ex, batches, caps, device, b, hidden, smi):
  """``HGT`` from one set of weights in its four forwards: segment,
  hierarchical and tree-dense over the tree batches, segment and
  merge-dense over the calibrated merge batches. Forward ms per batch by
  CUDA events; finite logits of the expected shape; the last batch's
  within rtol 1e-3, atol 1e-4 of the CPU's (TF32 off); the dense
  forwards' seed logits within the same of the segment forward's and the
  hierarchical ones within rtol 1e-4, atol 1e-5 of the full forward's."""
  cuda = device.type == 'cuda'
  cpu = torch.device('cpu')
  sd = ex.build_model('hgt', b, hidden, cpu, mode='segment',
                      generator=torch.Generator().manual_seed(0)
                      ).state_dict()
  depth1 = gtt.sampler.hetero_tree_layout(
      {'paper': b}, tuple(ex.FANOUTS), ex.FANOUTS)[0]['paper'][1]
  rep, logits = {}, {}
  for kind, mode in (('tree', 'segment'), ('tree', 'hierarchical'),
                     ('tree', 'tree_dense'), ('merge', 'segment'),
                     ('merge', 'merge_dense')):
    models = {}
    for d in (device, cpu):
      m = ex.build_model('hgt', b, hidden, d, mode=mode,
                         etype_caps=caps if kind == 'merge' else None)
      m.load_state_dict(sd)
      models[d.type] = m.eval()
    ms, outs = [], []
    with torch.no_grad():
      for batch in batches[kind]:
        e0 = _event(torch, cuda)
        out = models[device.type](batch.x, batch.edge_index,
                                  batch.edge_mask)
        e1 = _event(torch, cuda)
        if cuda:
          e1.synchronize()
        ms.append(_span(e0, e1, cuda))
        outs.append(out)
      last = batches[kind][-1]
      want = models['cpu'](*(to_cpu(torch, v) for v in (
          last.x, last.edge_index, last.edge_mask)))
    rows = (last.x['paper'].shape[0] if mode == 'segment' else
            depth1 if mode == 'hierarchical' else b)
    for out in outs:
      assert out.shape == (rows, ex.NUM_CLASSES), (mode, out.shape)
      assert bool(torch.isfinite(out).all()), (kind, mode)
    got = outs[-1].cpu()
    diff = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    logits[kind, mode] = got[:b]
    rep[f'{kind}/{mode}'] = dict(forward_ms=ms,
                                 median_forward_ms=float(np.median(ms)),
                                 cpu_max_abs_diff=diff)
    log(f'models hgt {mode} on {kind} batches: forward median '
        f'{np.median(ms):.3f} ms/batch, logits [{rows}, '
        f'{ex.NUM_CLASSES}] within {diff:.3g} of the CPU\'s on {smi}')
  for (kind, mode), v in logits.items():
    ref = logits[kind, 'segment']
    if mode == 'hierarchical':
      torch.testing.assert_close(v, ref, rtol=1e-4, atol=1e-5)
    elif mode != 'segment':
      torch.testing.assert_close(v, ref, rtol=1e-3, atol=1e-4)
  return rep


def hgt_part(torch, gtt, device, smi):
  """(a): HGT at the MAG example's width: typed tree and calibrated merge
  batches, the four forwards, tree-dense and merge-dense training."""
  cuda = device.type == 'cuda'
  n_paper, b, hidden, heads, nb, steps = (
      (MAG_PAPER, MAG_BATCH, MAG_HIDDEN, MAG_HEADS, MAG_BATCHES, MAG_STEPS)
      if cuda else (3_000, 32, 16, 2, 2, 4))
  t0 = time.perf_counter()
  ex, dataset = mag_example(gtt, n_paper, heads)
  ds, cpu_ds = dataset(device), dataset(torch.device('cpu'))
  pool = np.arange(int(n_paper * 0.2))        # the example's train seeds
  caps = gtt.sampler.estimate_hetero_frontier_caps(
      ds.graph, ex.FANOUTS, {'paper': b}, input_nodes={'paper': pool})
  rep = dict(sizes=dict(paper=n_paper, batch=b, hidden=hidden, heads=heads),
             caps={str(et): v for et, v in caps.items()},
             setup_s=time.perf_counter() - t0)
  log(f'models hgt: MAG-shaped graph ({n_paper} papers, '
      f'{len(ex.FANOUTS)} edge types) built in {rep["setup_s"]:.1f} s; '
      f'calibrated caps {rep["caps"]}')
  batches = {}
  for kind in ('tree', 'merge'):
    rep[kind], batches[kind] = hetero_batches(
        torch, gtt, ex, ds, cpu_ds, pool, device, kind, caps, b, nb, smi)
  rep['inference'] = hgt_inference(torch, gtt, ex, batches, caps, device, b,
                                   hidden, smi)
  del batches
  for kind in ('tree', 'merge'):
    rep[f'train_{kind}'] = hetero_train(
        torch, gtt, ex, ds, pool, device, kind, 'hgt', caps, b, steps, smi,
        hidden=hidden)
    if cuda:
      torch.cuda.empty_cache()
  return rep


def gat_model(torch, gtt, device, kind=None, caps=None, gen_seed=None):
  """``GAT(100, 128, 47)``, 3 layers of 2 heads: tree-dense over the tree
  layout (``kind='tree'``), merge-dense over the calibrated merge layout
  (``'merge'``, the loader's ``caps``) or the segment forward (None);
  weights from ``gen_seed``."""
  from graphlearn_tpu_torch.models import train
  kw = {}
  if kind == 'tree':
    no, eo = train.tree_hop_offsets(BATCH, FANOUTS)
    kw = dict(hop_node_offsets=no, hop_edge_offsets=eo, tree_dense=True,
              fanouts=FANOUTS)
  elif kind == 'merge':
    no, eo = train.merge_hop_offsets(BATCH, FANOUTS, frontier_caps=caps)
    kw = dict(hop_node_offsets=no, hop_edge_offsets=eo, merge_dense=True,
              fanouts=FANOUTS)
  gen = None if gen_seed is None else torch.Generator().manual_seed(gen_seed)
  return gtt.models.GAT(FEAT_DIM, GAT_HIDDEN, CLASSES,
                        num_layers=len(FANOUTS), heads=GAT_HEADS,
                        device=device, generator=gen, **kw)


def gat_launches(kind, steps, cuda) -> dict:
  """The launches ``steps`` tree or merge batches of the script's loader
  make: K3 once per hop or K4 three per level and one per batch, K1 once
  per batch."""
  per = 1 if cuda else 0
  lev = level_launch_count(kind, steps)
  return dict(sample_hop=per * lev if kind == 'tree' else 0,
              sample_level=per * lev if kind == 'merge' else 0,
              gather_rows=per * steps, uniform_draw=0)


def gat_forwards(torch, gtt, ds, pool, device, caps, smi):
  """The tree-dense GAT on tree batches and the merge-dense one on
  calibrated merge batches: two batches each after a warm-up one (the
  launches as planned), forward ms (after an untimed forward of each
  model), the seed logits against the segment
  forward's with the same weights and the last batch's logits against a
  CPU recompute (rtol 1e-3, atol 1e-4)."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  cpu = torch.device('cpu')
  rep = {}
  for kind in ('tree', 'merge'):
    loader = make_loader(gtt, ds, pool, device, kind, caps)
    it = iter(loader)
    next(it)
    ops.reset_launch_counts()
    batches = [next(it) for _ in range(2)]
    counts = ops.launch_counts()
    for k, v in gat_launches(kind, 2, cuda).items():
      assert counts[k] == v, (kind, k, counts)
    dense = gat_model(torch, gtt, device, kind, caps, 0).eval()
    seg = gat_model(torch, gtt, device).eval()
    seg.load_state_dict(dense.state_dict())
    cdense = gat_model(torch, gtt, cpu, kind, caps).eval()
    cdense.load_state_dict({k: v.cpu() for k, v in dense.state_dict().items()})
    ms = {'dense': [], 'segment': []}
    with torch.no_grad():
      d = train.batch_to_dict(batches[0])
      for m in (dense, seg):         # first use of the shapes: untimed
        m(d['x'], d['edge_index'], d['edge_mask'])
      for batch in batches:
        d = train.batch_to_dict(batch)
        for name, m in (('dense', dense), ('segment', seg)):
          e0 = _event(torch, cuda)
          out = m(d['x'], d['edge_index'], d['edge_mask'])
          e1 = _event(torch, cuda)
          if cuda:
            e1.synchronize()
          ms[name].append(_span(e0, e1, cuda))
          # the layered forwards' last layer runs over the depth <= 1
          # prefix, the segment forward over every slot
          rows = (d['x'].shape[0] if name == 'segment' else
                  m.hop_node_offsets[1])
          assert out.shape == (rows, CLASSES), (name, out.shape)
          assert bool(torch.isfinite(out).all()), (kind, name)
          if name == 'dense':
            got = out
      nseed = int(d['num_seed_nodes'])
      seg_diff = float((got[:nseed] - out[:nseed]).abs().max())
      torch.testing.assert_close(got[:nseed], out[:nseed], rtol=1e-3,
                                 atol=1e-4)
      want = cdense(*(to_cpu(torch, d[k])
                      for k in ('x', 'edge_index', 'edge_mask')))
    cpu_diff = float((got.cpu() - want).abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-4)
    rep[kind] = dict(launches=counts, forward_ms=ms, node_slots=int(
        d['x'].shape[0]), seed_diff_vs_segment=seg_diff,
        cpu_max_abs_diff=cpu_diff)
    log(f'models gat {kind}: 2 batches, launches {counts}; {kind}-dense '
        f'forward median {np.median(ms["dense"]):.3f} ms, segment '
        f'{np.median(ms["segment"]):.3f} ms over {d["x"].shape[0]} node '
        f'slots; seed logits within {seg_diff:.3g} of the segment '
        f'forward\'s, logits within {cpu_diff:.3g} of the CPU\'s on {smi}')
  return rep


def gat_scan(torch, gtt, ds, pool, device, chunk, smi):
  """Two ScanTrainer epochs of the tree-dense GAT captured (CUDA graphs:
  in the first an eager warm-up chunk, then the chunk captured and
  replayed; the second all replays) and two eager from the same weights:
  per epoch the launches equal (K3 3 a step), the losses within rtol
  1e-4, the parameters within PARAMS_LIMIT; the second epochs timed and
  sync-counted (0 host syncs a step, both)."""
  import copy

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  model = gat_model(torch, gtt, device, 'tree', gen_seed=0)
  runs = {}
  for name, m, capture in (('captured', model, None),
                           ('eager', copy.deepcopy(model), False)):
    tr = gtt.loader.ScanTrainer(make_loader(gtt, ds, pool, device, 'tree'),
                                m, CLASSES, chunk_size=chunk,
                                capture=capture)
    state = train.create_train_state(m, lr=LR)
    epochs = []
    for epoch in range(2):
      ops.reset_launch_counts()
      e0 = _event(torch, cuda)
      if cuda and epoch:
        (state, losses, _), syncs, kinds = count_syncs(
            torch, lambda: tr.run_epoch(state))
      else:
        (state, losses, _), syncs, kinds = tr.run_epoch(state), 0, {}
      e1 = _event(torch, cuda)
      if cuda:
        e1.synchronize()
      epochs.append(dict(
          losses=losses.cpu(), launches=ops.launch_counts(), syncs=syncs,
          kinds=kinds, params=[p.detach().clone() for p in m.parameters()],
          ms_per_step=_span(e0, e1, cuda) / losses.shape[0]))
    runs[name] = epochs
  diffs = []
  for c, e in zip(runs['captured'], runs['eager']):
    assert c['launches'] == e['launches'], (c['launches'], e['launches'])
    steps = c['losses'].shape[0]
    assert c['launches']['sample_hop'] == (3 if cuda else 0) * steps, \
        c['launches']
    assert c['syncs'] == e['syncs'] == 0, (c['kinds'], e['kinds'])
    torch.testing.assert_close(c['losses'], e['losses'], rtol=1e-4, atol=0)
    diffs.append(max(float((a - b).abs().max())
                     for a, b in zip(c['params'], e['params'])))
    assert diffs[-1] < PARAMS_LIMIT, diffs
  c, e = runs['captured'], runs['eager']
  rep = dict(steps=steps, chunk=chunk, launches=c[1]['launches'],
             launches_first=c[0]['launches'],
             captured_ms_per_step=[r['ms_per_step'] for r in c],
             eager_ms_per_step=[r['ms_per_step'] for r in e],
             host_syncs_per_step=c[1]['syncs'] / steps,
             max_abs_param_diff=diffs, losses=c[1]['losses'].tolist())
  log(f'models gat ScanTrainer (tree-dense, K={chunk}): 2 epochs of '
      f'{steps} steps, captured {c[0]["ms_per_step"]:.3f} (warm-up and '
      f'capture) / {c[1]["ms_per_step"]:.3f} ms/step, eager '
      f'{e[0]["ms_per_step"]:.3f} / {e[1]["ms_per_step"]:.3f}; 0 host syncs '
      f'a step in the second epochs; launches equal {c[1]["launches"]}; '
      f'parameters within {diffs} on {smi}')
  return rep


def gat_serving(torch, gtt, ds, device, topo, smi):
  """(c): the serving phase's materializer with a segment ``GAT(100, 128,
  47)`` of GAT_SERVE_LAYERS layers of 2 heads: ms per layer pass, each
  pass's RECHECK_ROWS rows recomputed on the CPU from the card's own
  input store, then the store routed through gather v2 behind the engine:
  GAT_LOOKUPS requests equal to the table, one K2 launch per engine
  batch. The launch counters are set to 0 before the materializer."""
  from graphlearn_tpu_torch import metrics, ops
  from graphlearn_tpu_torch.serving import (EmbeddingMaterializer,
                                            ServingEngine)
  cuda = device.type == 'cuda'
  n = topo.num_nodes
  model = gtt.models.GAT(FEAT_DIM, GAT_HIDDEN, CLASSES,
                         num_layers=GAT_SERVE_LAYERS, heads=GAT_HEADS,
                         device=device,
                         generator=torch.Generator().manual_seed(0)).eval()
  cmodel = gtt.models.GAT(FEAT_DIM, GAT_HIDDEN, CLASSES,
                          num_layers=GAT_SERVE_LAYERS, heads=GAT_HEADS,
                          device='cpu').eval()
  cmodel.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
  deg = np.diff(topo.indptr)
  rng = np.random.default_rng(12)
  check = np.concatenate([[0, n - 1, int(deg.argmax())], rng.choice(
      np.arange(1, n - 1), RECHECK_ROWS - 3, replace=False)])
  check_t = torch.as_tensor(check).to(device)
  ops.reset_launch_counts()
  mat = EmbeddingMaterializer(ds, model, block_size=SERVE_BLOCK,
                              chunk_size=SERVE_CHUNK)
  _, passes = materialize_recorded(torch, mat, check_t)
  diffs = []
  for p in passes:
    ref = recompute_rows(torch, cmodel, p['layer'], p['x_self'], p['nbr'],
                         p['x_nbr'])
    torch.testing.assert_close(p['out'], ref, rtol=1e-3, atol=1e-4)
    diffs.append(float((p['out'] - ref).abs().max()))
  store = mat.embedding_store()
  store.set_kernel_routing(use_pallas_v2=True, block_rows=256, run_span=8)
  table = store.table[:n].cpu().numpy()
  reqs = serve_requests(np.random.default_rng(300), n)[:GAT_LOOKUPS]
  metrics.reset('serving')
  bad = 0
  with ServingEngine(store, buckets=SERVE_BUCKETS, max_wait_ms=2.0,
                     refresh_fn=mat.refresh_rows) as engine:
    for ids in reqs:
      bad += not np.array_equal(engine.lookup(ids, timeout=120), table[ids])
  batches = metrics.snapshot()['counters']['serving.batches']
  counts = ops.launch_counts()
  per = 1 if cuda else 0
  assert bad == 0, f'{bad} GAT responses differ from the table'
  assert counts['gather_runs'] == per * batches, (counts, batches)
  assert counts['gather_rows'] >= per * len(passes) * (mat.n_pad //
                                                       SERVE_BLOCK), counts
  assert counts['sample_hop'] == counts['sample_level'] == 0, counts
  rep = dict(pass_ms=[p['ms'] for p in passes], recheck_max_abs_diff=diffs,
             W=mat._w, lookups=len(reqs), batches=batches, launches=counts)
  log(f'models gat serving: GAT({FEAT_DIM}, {GAT_HIDDEN}, {CLASSES}) '
      f'{GAT_SERVE_LAYERS} layers x {GAT_HEADS} heads materialized (W='
      f'{mat._w}), ms per layer pass ' +
      ' '.join(f'{p["ms"]:.2f}' for p in passes) + f'; {RECHECK_ROWS} rows '
      'a pass within ' + ' '.join(f'{d:.3g}' for d in diffs) + ' of the '
      f'CPU; {len(reqs)} engine lookups equal to the table in {batches} '
      f'batches; launches {counts} on {smi}')
  return rep


def seal_pins(torch, model, rec=None):
  """The DGCNN's two data-dependent choices (the sort order and the max
  pool's argmax), recorded (``rec`` None: returns the list they are
  appended to, one dict per forward) or imposed from ``rec`` (another
  device's): the CPU then follows the card at every choice it made
  between values within rounding, as it follows its side of 0 at every
  ReLU. Imposed, the card's order is checked to sort the CPU's keys
  and its pooled choices to be maxima of the CPU's inputs (each within
  1e-5), and the CPU's own order is counted where it differs."""
  seen = []
  own_sort = model.sort_order

  def sort_order(h, nmask):
    order = own_sort(h, nmask)
    if rec is None:
      seen.append(dict(order=order.detach()))
      return order
    card = rec['order'].to(h.device)
    key = torch.where(nmask, h[..., -1], float('-inf')).detach()
    ks = key.gather(1, card)
    assert bool((ks[:, :-1] >= ks[:, 1:] - 1e-5).all()), 'card sort order'
    rest = key.scatter(1, card, float('-inf')).amax(1)
    assert bool((ks[:, -1] >= rest - 1e-5).all()), 'card top-k'
    seen.append(dict(order_differs=int((order != card).any(1).sum())))
    return card

  def pool_hook(m, inp, out):
    x = inp[0]
    if rec is None:
      seen[-1]['pool'] = torch.nn.functional.max_pool1d(
          x, 2, 2, return_indices=True)[1].detach()
      return None
    idx = rec['pool'].to(x.device)
    picked = x.flatten(2).gather(2, idx)
    own = torch.nn.functional.max_pool1d(x, 2, 2)
    assert bool((picked >= own - 1e-5).all()), 'card max-pool choice'
    return picked

  model.sort_order = sort_order
  model.pool.register_forward_hook(pool_hook)
  return seen


def seal_part(torch, gtt, device, smi):
  """(d): the SEAL example at its defaults: the enclosing subgraphs of
  its train links extracted on the card (K4 per subgraph; the first 16
  equal to a CPU sampler's from the same stream), the DGCNN's SEAL_STEPS
  train steps, each recomputed on the CPU from the card's state before it
  (``cpu_step_check``, the CPU following the card's sort order and max
  pool choices), and one forward on the next batch against the CPU's."""
  import copy

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.examples import seal_link_pred as seal
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  cpu = torch.device('cpu')
  args = seal.parser().parse_args(
      ['--device', device.type] + ([] if cuda else [
          '--num-nodes', '300', '--num-links', '48', '--batch-size', '16']))
  graph_ei, pos, neg, _, _ = seal.make_graph(args)

  def sampler(d):
    return gtt.sampler.NeighborSampler(
        gtt.data.Graph(gtt.data.Topology(graph_ei,
                                         num_nodes=args.num_nodes),
                       mode='CPU', device=d), args.fanout, seed=0, device=d)

  card = sampler(device)
  ops.reset_launch_counts()
  t0 = time.perf_counter()
  tr = [np.concatenate(p) for p in zip(seal.extract(card, pos, 1, args),
                                       seal.extract(card, neg, 0, args))]
  extract_s = time.perf_counter() - t0
  counts = ops.launch_counts()
  calls = pos.shape[1] + neg.shape[1]
  per = 1 if cuda else 0
  assert counts['sample_level'] == per * calls * (3 * len(args.fanout) + 1), \
      counts
  assert counts['sample_hop'] == 0, counts
  host = seal.extract(sampler(cpu), pos[:, :16], 1, args)
  for a, b in zip(host, tr):
    assert np.array_equal(a, b[:16]), 'a subgraph differs from the CPU\'s'
  order = np.random.default_rng(1).permutation(len(tr[4]))
  bs = args.batch_size
  batches = [{k: torch.as_tensor(v[order[i * bs:(i + 1) * bs]]).to(device)
              for k, v in zip(('z', 'ei', 'em', 'nm', 'y'), tr)}
             for i in range(SEAL_STEPS + 1)]

  def model_on(d):
    return seal.DGCNN(k=args.sortpool_k, device=d,
                      generator=torch.Generator().manual_seed(0))

  model = model_on(device)
  model.train()
  state = train.create_train_state(model, lr=1e-3)
  step = seal.make_step(model, state.optimizer)
  recs = seal_pins(torch, model)
  checks, step_ms = [], []
  for i, b in enumerate(batches[:SEAL_STEPS]):
    check = (copy.deepcopy(model.state_dict()),
             copy.deepcopy(state.optimizer.state_dict()), to_cpu(torch, b))
    pre = {}
    hooks = relu_input_hooks(model, recorder(pre))
    e0 = _event(torch, cuda)
    loss = step(b)
    e1 = _event(torch, cuda)
    if cuda:
      e1.synchronize()
    step_ms.append(_span(e0, e1, cuda))
    for h in hooks:
      h.remove()
    check += ([p.grad.detach().cpu() for p in model.parameters()],
              {k: z.cpu() for k, z in pre.items()})
    rec = {k: v.cpu() for k, v in recs[-1].items()}
    differs = []

    def cpu_model(rec=rec, differs=differs):
      m = model_on(cpu)
      differs.append(seal_pins(torch, m, rec))
      return m

    def make_step(m):
      def st(s, bb):
        return s, seal.make_step(m, s.optimizer)(bb), None
      return st, None

    c = cpu_step_check(torch, gtt, None, model, check, loss,
                       cpu_model=cpu_model, make_step=make_step)
    c['cpu_sort_differs'] = sum(s.get('order_differs', 0)
                                for seen in differs for s in seen)
    checks.append(c)
  model.eval()
  last = batches[SEAL_STEPS]
  with torch.no_grad():
    got = model(last['z'], last['ei'], last['em'], last['nm']).cpu()
    cm = model_on(cpu).eval()
    cm.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pinned = seal_pins(torch, cm, {k: v.cpu() for k, v in recs[-1].items()})
    want = cm(*(last[k].cpu() for k in ('z', 'ei', 'em', 'nm')))
  assert got.shape == (bs,) and bool(torch.isfinite(got).all())
  fwd_diff = float((got - want).abs().max())
  torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
  rep = dict(links=calls, extract_s=extract_s, launches=counts,
             step_ms=step_ms, losses=[c['loss'] for c in checks],
             cpu_checks=[{k: c[k] for k in (
                 'pre_diff', 'opposite', 'leaky_opposite', 'grad_share',
                 'adam_diff', 'cpu_loss', 'cpu_sort_differs')} for c in checks],
             forward_max_abs_diff=fwd_diff,
             forward_cpu_sort_differs=pinned[-1]['order_differs'])
  log(f'models seal: {calls} enclosing subgraphs extracted on the card in '
      f'{extract_s:.2f} s (launches {counts}; the first 16 equal to the '
      f'CPU\'s); {SEAL_STEPS} DGCNN steps '
      + ' '.join(f'{m:.3f}' for m in step_ms) + ' ms, losses '
      + ' '.join(f'{c["loss"]:.4f}' for c in checks) + ', each recomputed '
      'on the CPU (gradients within '
      + ' '.join(f'{c["grad_share"]:.3g}' for c in checks)
      + ' of the largest); a forward within '
      f'{fwd_diff:.3g} of the CPU\'s on {smi}')
  return rep


def models_phase(torch, gtt, ds, topo, device, caps, smi):
  """HGT at the MAG example's width (a), the homogeneous GAT at
  prof_gat_merge's configuration (b), GAT serving (c) and SEAL (d)."""
  cuda = device.type == 'cuda'
  t0 = time.perf_counter()
  rep = {'hgt': hgt_part(torch, gtt, device, smi)}
  if cuda:
    torch.cuda.empty_cache()
  steps = GAT_STEPS if cuda else 4
  pool = np.random.default_rng(11).permutation(topo.num_nodes)[
      :BATCH * steps]
  gat = rep['gat'] = gat_forwards(torch, gtt, ds, pool, device, caps, smi)
  for kind in ('tree', 'merge'):
    gat[f'train_{kind}'] = loop_train(
        torch, gtt, make_loader(gtt, ds, pool, device, kind, caps),
        lambda d, kind=kind: gat_model(torch, gtt, d, kind, caps, 0),
        CLASSES, steps, gat_launches(kind, steps, cuda), smi,
        f'models gat train {kind}-dense')
    if cuda:
      torch.cuda.empty_cache()
  gat['scan'] = gat_scan(torch, gtt, ds, pool, device,
                         GAT_CHUNK if cuda else 2, smi)
  if cuda:
    torch.cuda.empty_cache()
  rep['gat_serving'] = gat_serving(torch, gtt, ds, device, topo, smi)
  if cuda:
    torch.cuda.empty_cache()
  rep['seal'] = seal_part(torch, gtt, device, smi)
  rep['phase_s'] = time.perf_counter() - t0
  log(f'models phase wall {rep["phase_s"]:.1f} s on {smi}')
  return rep


# ---- typed link prediction, typed serving, the hetero tiered loader
# the bipartite example's defaults (examples/hetero/bipartite_sage_unsup.py:
# 20,000 users, 5,000 items, 8 groups, 12 clicks a user; u2i/i2u [8, 4],
# i2i [4, 2] at batch 512; binary 1:1; hidden 64; Adam 1e-3)
BIP_USERS, BIP_ITEMS, BIP_HIDDEN, BIP_BATCH, BIP_LR = 20_000, 5_000, 64, \
    512, 1e-3
BIP_STEPS = 32                      # loop steps, the last held on the CPU
TLINK_BATCH = 512                   # seed edges of the IGBH typed batches
TSERVE_BLOCK, TSERVE_CHUNK = 512, 8  # the typed materializer's B and K
TSERVE_CHECK = 4096                 # rows per type recomputed on the CPU
TSERVE_REFRESH = 256                # ids of the typed refresh check
TIER_HOT, TIER_WARM = 0.25, 0.25    # the tiered loader's split (disk 0.5)
TIER_BATCHES = 4                    # typed tree batches of the tiered loader
# partition: sample_prob over the script's graph at its fanouts from 1,024
# seeds; FrequencyPartitioner over 2 parts from two seed pools' card
# probabilities, caching a tenth of the nodes
PART_SEEDS, PART_CACHE = 1024, 0.1


def link_md(torch, out) -> dict:
  """A typed link batch's supervision metadata, on the CPU."""
  keys = ('edge_label_index', 'edge_label', 'src_index', 'dst_pos_index',
          'dst_neg_index')
  return {k: out.metadata[k].cpu() for k in keys if k in out.metadata}


def typed_link_batches(torch, gtt, ex, ds, cpu_ds, device, smi):
  """One typed link batch each of binary tree (cites seeds: one node
  type), triplet tree and calibrated binary merge (writes seeds:
  author -> paper) on the IGBH-width dataset with features: sampled and
  collated on the card with the launch counters from 0 (the negative
  kernel once, the hop kernel once per plan item, the row gather once
  per featured type), equal to the CPU's from the same sampler state bit
  for bit, metadata included; host syncs of the card's batch counted
  (they must be 0)."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.sampler import EdgeSamplerInput, NegativeSampling
  cuda = device.type == 'cuda'
  cpu = torch.device('cpu')
  b = TLINK_BATCH
  rng = np.random.default_rng(13)
  rep = {}
  for name, et, neg, dedup in (
      ('binary_tree', ex.CITES, NegativeSampling('binary', 1), 'tree'),
      ('triplet_tree', ex.WRITES, NegativeSampling('triplet', 2), 'tree'),
      ('binary_merge', ex.WRITES, NegativeSampling('binary', 1), 'merge')):
    ei = ds.graph[et].topo
    src = np.repeat(np.arange(ei.indptr.shape[0] - 1), np.diff(ei.indptr))
    pick = rng.choice(ei.num_edges, b, replace=False)
    rows, cols = src[pick], ei.indices[pick]
    kw = dict(dedup=dedup)
    if dedup == 'merge':
      nsrc = b + neg.num_negatives(b)
      # probes from each type's whole id range (the negatives are
      # uniform), with room for the positives' denser ends
      kw['frontier_caps'] = gtt.sampler.estimate_hetero_frontier_caps(
          ds.graph, ex.FANOUTS, {et[0]: nsrc, et[2]: nsrc}, slack=2.0)
    loaders = [gtt.loader.LinkNeighborLoader(
        d, ex.FANOUTS, (et, np.stack([rows, cols])), neg_sampling=neg,
        batch_size=b, seed=3, device=d.device, **kw) for d in (ds, cpu_ds)]
    card, host = (ld.sampler for ld in loaders)
    inp = EdgeSamplerInput(rows, cols, None, et, neg)
    loaders[0]._collate_fn(card.sample_from_edges(inp))   # the tables
    host.load_state_dict(card.state_dict())
    ops.reset_launch_counts()
    e0 = _event(torch, cuda)
    out, syncs, kinds = (count_syncs(torch, lambda: loaders[0]._collate_fn(
        card.sample_from_edges(inp))) if cuda else
        (loaders[0]._collate_fn(card.sample_from_edges(inp)), 0, {}))
    e1 = _event(torch, cuda)
    if cuda:
      e1.synchronize()
    counts = ops.launch_counts()
    want = loaders[1]._collate_fn(host.sample_from_edges(inp))
    assert card._call_count == host._call_count
    assert_hetero_equal(torch, out, want, f'typed link {name}')
    got_md, want_md = link_md(torch, out), link_md(torch, want)
    assert sorted(got_md) == sorted(want_md), name
    for k in want_md:
      assert torch.equal(got_md[k], want_md[k]), (name, k)
    _, hop_caps, _ = gtt.sampler.hetero_capacity_plan(
        list(ex.FANOUTS), lambda e: ex.FANOUTS[e],
        {t: v.shape[0] for t, v in out.batch.items()}, 'out',
        etype_caps=kw.get('frontier_caps'))
    items = sum(len(per_et) for per_et in hop_caps)
    per = 1 if cuda else 0
    assert counts['negative_sample'] == per, counts
    assert counts['sample_hop'] == per * items, (counts, items)
    assert counts['gather_rows'] == per * len(ds.node_features), counts
    assert counts['sample_level'] == counts['uniform_draw'] == 0, counts
    assert syncs == 0, (name, kinds)
    assert not bool(out.metadata['overflow']), name
    rep[name] = dict(ms=_span(e0, e1, cuda), launches=counts, items=items,
                     host_syncs=syncs,
                     nodes={t: int(n) for t, n in want.num_nodes.items()})
    log(f'typed link {name}: {b} {et} seed edges, one batch sampled and '
        f'collated in {rep[name]["ms"]:.3f} ms with {syncs} host syncs, '
        f'{items} hop items, nodes {rep[name]["nodes"]}; equal to the '
        f'CPU\'s bit for bit; launches {counts} on {smi}')
  return rep


def bipartite_train(torch, gtt, device, smi):
  """The bipartite example's loop at its defaults (``loop_train`` with
  its step and batch dict): BIP_STEPS steps of the two-tower model over
  the typed link loader, the last recomputed on the CPU (cpu_step_check),
  0 host syncs a step, launches per batch (the negative kernel once, the
  hop kernel once per plan item, no row gather: the towers read ids)."""
  from graphlearn_tpu_torch.examples import bipartite_sage_unsup as ex
  t0 = time.perf_counter()
  cuda = device.type == 'cuda'
  users, items, steps = ((BIP_USERS, BIP_ITEMS, BIP_STEPS) if cuda else
                         (2000, 500, 4))
  edges, num_nodes, train_e, test_e, i2i = ex.make_data(users, items)
  ds = gtt.data.Dataset(edge_dir='out', device=device)
  ds.init_graph(edges, num_nodes=num_nodes)
  loader, _ = ex.loaders(ds, train_e, test_e, BIP_BATCH, device)
  setup = time.perf_counter() - t0
  _, hop_caps, _ = gtt.sampler.hetero_capacity_plan(
      list(ex.FANOUTS), lambda e: ex.FANOUTS[e],
      {'user': 2 * BIP_BATCH, 'item': 2 * BIP_BATCH}, 'out')
  n_items = sum(len(per_et) for per_et in hop_caps)
  per = 1 if cuda else 0
  expect = dict(sample_hop=per * steps * n_items,
                negative_sample=per * steps, gather_rows=0, sample_level=0,
                uniform_draw=0)

  def model_on(d):
    return ex.build_model(users, items, BIP_HIDDEN, d,
                          generator=torch.Generator().manual_seed(0))

  rep = loop_train(torch, gtt, loader, model_on, None, steps, expect, smi,
                   'bipartite two-tower link train', make_step=ex.make_step,
                   to_dict=ex.batch_dict, lr=BIP_LR)
  rep.update(items=n_items, setup_s=setup, i2i_edges=int(i2i.shape[1]),
             train_edges=int(train_e.shape[1]))
  log(f'bipartite: {users} users, {items} items, {train_e.shape[1]} '
      f'training clicks, {i2i.shape[1]} item co-clicks built in '
      f'{setup:.1f} s; {n_items} hop items a batch on {smi}')
  return rep


def hetero_materialize_recorded(torch, mat):
  """``(table, passes)``: ``mat.materialize()`` with each pass timed by
  CUDA events, its label, its blocks, its row-gather launches and its
  output store."""
  from graphlearn_tpu_torch import ops
  cuda = mat.device.type == 'cuda'
  run_pass, spill, passes = mat._pass, mat._spill_pass, []

  def timed_pass(n_pad, block_fn, label):
    k1 = ops.launch_counts()['gather_rows']
    a = _event(torch, cuda)
    out = run_pass(n_pad, block_fn, label)
    b = _event(torch, cuda)
    if cuda:
      b.synchronize()
    passes.append(dict(ms=_span(a, b, cuda), blocks=n_pad // mat.block_size,
                       gather_rows=ops.launch_counts()['gather_rows'] - k1,
                       out=out))
    return out

  def labelled(label, out):
    passes[-1]['label'] = label
    spill(label, out)

  mat._pass, mat._spill_pass = timed_pass, labelled
  try:
    return mat.materialize(), passes
  finally:
    del mat._pass, mat._spill_pass


def hetero_recheck(torch, gtt, mat, cmat, passes, rng):
  """Each pass's rows at a seeded sample of TSERVE_CHECK ids per type,
  recomputed by the CPU materializer ``cmat`` (the same model's weights)
  from the card's own input stores: the embed slice on ``x0``, the conv
  layer's block over the store set before it (its live edge types), the
  head on the last layer's store. Returns the largest abs difference per
  pass (each held within rtol 1e-3, atol 1e-4)."""
  from graphlearn_tpu_torch.models import train
  model, L = cmat.model, cmat.num_layers
  ids = {t: torch.as_tensor(np.sort(rng.choice(
      n, min(TSERVE_CHECK, n), replace=False)).astype(np.int32))
      for t, n in cmat.num_nodes.items()}
  outs = {tuple(p['label'].split('/')): p['out'] for p in passes}
  inputs = {}

  def stores_before(layer):
    """The card's store set a conv layer (``L``: the head) reads, on the
    CPU: the embed passes' outputs, or the layer before's."""
    if layer not in inputs:
      key = 'embed' if layer == 0 else str(layer - 1)
      inputs[layer] = {t: v.cpu() for (k, t), v in outs.items() if k == key}
    return inputs[layer]

  diffs = {}
  with torch.no_grad():
    for p in passes:
      kind, t = p['label'].split('/')
      if kind in ('embed', 'head'):
        src = (mat._x0[t] if kind == 'embed' else outs[(str(L - 1), t)])
        fn = train.make_layer_slice_fn(
            model, *((0, 0) if kind == 'embed' else (L, L)),
            embed=kind == 'embed', head=kind == 'head')
        ref = fn(dict(x={t: src[ids[t].to(src.device).long()].cpu()},
                      edge_index={}, edge_mask={}))
        ref = ref[t] if isinstance(ref, dict) else ref
      else:
        layer = int(kind)
        cur = stores_before(layer)
        live = cmat._hetero_live_for(t, cur)
        fn = train.make_layer_slice_fn(model, layer, layer + 1, embed=False,
                                       head=False)
        nbrs = {et: cmat._nbr[et][ids[t].long()] for et in live}
        ref = fn(cmat._hetero_block(cur, t, live, ids[t], nbrs))[t][
            :ids[t].shape[0]]
      got = p['out'][ids[t].to(p['out'].device).long()].cpu()
      torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4)
      diffs[p['label']] = float((got - ref).abs().max())
  return diffs


def typed_serving(torch, gtt, ex, ds, cpu_ds, device, smi):
  """The RGNN served at the IGBH example's width, rsage and 4-head rgat
  (weights from a seed): the typed materializer with each pass timed and
  its row gathers counted, every pass's rows at TSERVE_CHECK ids a type
  within rtol 1e-3 / atol 1e-4 of the CPU materializer's, the typed
  refresh of TSERVE_REFRESH papers equal to the materialized rows, and
  the head's table behind the engine (gather v2): a poisoned row served
  fresh through ``mark_stale``, GAT_LOOKUPS requests equal to the table
  with their p50 / p99."""
  from graphlearn_tpu_torch import metrics, ops
  from graphlearn_tpu_torch.serving import (EmbeddingMaterializer,
                                            EmbeddingStore, ServingEngine)
  cuda = device.type == 'cuda'
  cpu = torch.device('cpu')
  rep = {}
  n = cpu_ds.node_features['paper'].size
  for conv in ('rsage', 'rgat'):
    model = ex.build_model(conv, 1, HET_HIDDEN, device, mode='segment',
                           generator=torch.Generator().manual_seed(0))
    cmodel = ex.build_model(conv, 1, HET_HIDDEN, cpu, mode='segment')
    cmodel.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    model.eval()
    cmodel.eval()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    mat = EmbeddingMaterializer(ds, model, block_size=TSERVE_BLOCK,
                                chunk_size=TSERVE_CHUNK)
    setup = time.perf_counter() - t0
    table, passes = hetero_materialize_recorded(torch, mat)
    cmat = EmbeddingMaterializer(cpu_ds, cmodel, block_size=TSERVE_BLOCK,
                                 chunk_size=TSERVE_CHUNK)
    diffs = hetero_recheck(torch, gtt, mat, cmat, passes,
                           np.random.default_rng(14))
    per = 1 if cuda else 0
    for p in passes:
      kind, t = p['label'].split('/')
      if kind in ('embed', 'head'):
        assert p['gather_rows'] == 0, p['label']
      else:     # one row gather per result type a block
        live = mat._hetero_live_for(t, {r: None for r in mat._x0})
        res = {mat._res_t[et] for et in live} | {t}
        assert p['gather_rows'] == per * p['blocks'] * len(res), (
            p['label'], p['gather_rows'], p['blocks'], res)
    assert bool(torch.isfinite(table).all()) and table.shape[1] == \
        ex.NUM_CLASSES
    # the typed refresh against the materialized rows
    rids = np.sort(np.random.default_rng(15).choice(n, TSERVE_REFRESH,
                                                    replace=False))
    e0 = _event(torch, cuda)
    fresh = mat.refresh_rows(rids, ntype='paper')
    e1 = _event(torch, cuda)
    refresh_ms = _span(e0, e1, cuda)
    want = table[torch.as_tensor(rids).to(device)].cpu()
    torch.testing.assert_close(torch.as_tensor(fresh), want, rtol=1e-3,
                               atol=1e-4)
    refresh_diff = float((torch.as_tensor(fresh) - want).abs().max())
    # the engine over the head's table: a poisoned row served fresh
    store = EmbeddingStore(table, num_nodes=n)
    store.set_kernel_routing(use_pallas_v2=True, block_rows=256, run_span=8)
    host_table = store.table[:n].cpu().numpy()
    poisoned = int(rids[0])
    reqs = serve_requests(np.random.default_rng(16), n)[:GAT_LOOKUPS]
    metrics.reset('serving')
    lat, bad = [], 0
    with ServingEngine(store, buckets=SERVE_BUCKETS, max_wait_ms=2.0,
                       refresh_fn=lambda i: mat.refresh_rows(
                           i, ntype='paper')) as engine:
      engine.lookup(reqs[0], timeout=120)                # the first use
      store.update_rows(np.array([poisoned]),
                        np.full((1, ex.NUM_CLASSES), 1e9, np.float32))
      engine.mark_stale([poisoned])
      served = engine.lookup(np.array([poisoned, 0]), timeout=120)
      assert engine.stale_count() == 0
      for ids in reqs:
        t1 = time.perf_counter()
        got = engine.lookup(ids, timeout=120)
        lat.append((time.perf_counter() - t1) * 1e3)
        bad += not np.allclose(got, host_table[ids], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(served, host_table[[poisoned, 0]], rtol=1e-3,
                               atol=1e-4)
    assert bad == 0, f'{bad} typed responses differ from the table'
    batches = metrics.snapshot()['counters']['serving.batches']
    counts = ops.launch_counts()
    assert counts['gather_runs'] >= per * len(reqs), counts
    assert counts['sample_hop'] == counts['sample_level'] == 0, counts
    rep[conv] = dict(
        setup_s=setup, W={str(et): w for et, w in mat._w.items()},
        passes=[{k: v for k, v in p.items() if k != 'out'} for p in passes],
        recheck_max_abs_diff=diffs, refresh_ms=refresh_ms,
        refresh_max_abs_diff=refresh_diff, launches=counts,
        lookups=len(reqs), batches=batches,
        lookup_p50_ms=float(np.percentile(lat, 50)),
        lookup_p99_ms=float(np.percentile(lat, 99)))
    log(f'typed serving {conv}: RGNN({HET_HIDDEN}, {ex.NUM_CLASSES}) over '
        f'{n} papers, W {rep[conv]["W"]}, block {TSERVE_BLOCK}; ms per pass '
        + ' '.join(f'{p["label"]}={p["ms"]:.2f}({p["gather_rows"]} K1)'
                   for p in passes) +
        f'; {TSERVE_CHECK} rows a type within '
        f'{max(diffs.values()):.3g} of the CPU materializer; refresh of '
        f'{TSERVE_REFRESH} papers {refresh_ms:.3f} ms within '
        f'{refresh_diff:.3g}; poisoned row served fresh; {len(reqs)} '
        f'lookups p50 {rep[conv]["lookup_p50_ms"]:.3f} p99 '
        f'{rep[conv]["lookup_p99_ms"]:.3f} ms in {batches} batches; '
        f'launches {counts} on {smi}')
    del mat, cmat, passes, table, store
    if cuda:
      torch.cuda.empty_cache()
  return rep


def tiered_typed_loader(torch, gtt, ex, ds, device, spill_dir, smi):
  """The hetero tiered loader: the IGBH-width graph with per-type
  ``TieredFeature`` stores (TIER_HOT of the rows on the card, TIER_WARM
  in pinned host memory, the rest on disk), its typed tree batches equal
  to the all-device loader's bit for bit; the hot/cold kernel's launches
  and the host syncs per batch."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.storage import TieredFeature
  cuda = device.type == 'cuda'
  tds = gtt.data.Dataset(graph=ds.graph, node_labels=ds.node_labels,
                         edge_dir='out', device=device)
  tds.node_features = {}
  for t, f in ds.node_features.items():
    rows = f.cpu_get(np.arange(f.size))
    tds.node_features[t] = TieredFeature(
        rows, hot_rows=int(TIER_HOT * f.size),
        warm_rows=int(TIER_WARM * f.size),
        spill_dir=os.path.join(spill_dir, f'tier_{t}'), device=device)
  pool = np.arange(int(ds.node_features['paper'].size * HET_SEED_FRACTION))
  b = HET_BATCH if cuda else 64
  loaders = [gtt.loader.NeighborLoader(d, ex.FANOUTS, ('paper', pool),
                                       batch_size=b, shuffle=True, seed=0,
                                       dedup='tree', device=device)
             for d in (ds, tds)]
  its = [iter(ld) for ld in loaders]
  for it in its:
    next(it)                          # the first use of the tables
  wants = [next(its[0]) for _ in range(TIER_BATCHES)]
  ops.reset_launch_counts()           # the tiered loader's batches only
  ms, syncs = [], 0
  for want in wants:
    e0 = _event(torch, cuda)
    got, s, _ = (count_syncs(torch, lambda: next(its[1])) if cuda else
                 (next(its[1]), 0, {}))
    e1 = _event(torch, cuda)
    if cuda:
      e1.synchronize()
    ms.append(_span(e0, e1, cuda))
    syncs += s
    assert_hetero_equal(torch, got, want, 'tiered typed batch')
  counts = ops.launch_counts()
  per = 1 if cuda else 0
  assert counts['gather_unified'] == per * TIER_BATCHES * len(
      tds.node_features), counts
  rep = dict(batch_ms=ms, launches=counts,
             host_syncs_per_batch=syncs / TIER_BATCHES,
             split=dict(hot=TIER_HOT, warm=TIER_WARM,
                        disk=1 - TIER_HOT - TIER_WARM))
  log(f'tiered typed loader: {TIER_BATCHES} tree batches of {b} papers over '
      f'per-type TieredFeature (hot {TIER_HOT}, warm {TIER_WARM}), each '
      f'equal to the all-device loader\'s; sample+collate median '
      f'{np.median(ms):.3f} ms, {syncs / TIER_BATCHES:.2f} host syncs a '
      f'batch; launches {counts} on {smi}')
  return rep


def typed_link_phase(torch, gtt, device, smi):
  """Typed link prediction (the bipartite example's loop; typed link
  batches on the IGBH-width dataset), typed (RGNN) serving and the hetero
  tiered loader."""
  import shutil
  import tempfile

  from graphlearn_tpu_torch.examples import train_rgnn as ex
  cuda = device.type == 'cuda'
  t0 = time.perf_counter()
  rep = {'bipartite': bipartite_train(torch, gtt, device, smi)}
  if cuda:
    torch.cuda.empty_cache()
  n_paper, n_author = (HET_PAPER, HET_AUTHOR) if cuda else (5_000, 2_500)
  dataset, _ = hetero_data(torch, gtt, ex, n_paper, n_author)
  ds, cpu_ds = dataset(device), dataset(torch.device('cpu'))
  rep['link_batches'] = typed_link_batches(torch, gtt, ex, ds, cpu_ds,
                                           device, smi)
  rep['serving'] = typed_serving(torch, gtt, ex, ds, cpu_ds, device, smi)
  tmp = tempfile.mkdtemp(prefix='gtt_typed_tier_')
  try:
    rep['tiered_loader'] = tiered_typed_loader(torch, gtt, ex, ds, device,
                                               tmp, smi)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  rep['phase_s'] = time.perf_counter() - t0
  log(f'typed link phase wall {rep["phase_s"]:.1f} s on {smi}')
  return rep


# ---- partition


def partition_round_trip(torch, pkg, root, num_parts, edges, feats,
                         hetero) -> int:
  """Every edge (by its id, with both ends) and every feature row of the
  partition directory ``root``, loaded part by part, equal to the inputs;
  returns the edges seen."""
  seen = 0
  ets = list(edges) if hetero else [None]
  for p in range(num_parts):
    _, graph, nfeat, _, node_pb, edge_pb = pkg.load_partition(root, p)
    for et in ets:
      g = graph[et] if hetero else graph
      ei = edges[et] if hetero else edges
      pb = edge_pb[et] if hetero else edge_pb
      assert np.array_equal(g.edge_index[0], ei[0][g.eids]), (p, et)
      assert np.array_equal(g.edge_index[1], ei[1][g.eids]), (p, et)
      assert (pb[g.eids] == p).all(), (p, et)
      seen += g.eids.shape[0]
    for t in (feats if hetero else [None]):
      f = nfeat[t] if hetero else nfeat
      want = feats[t] if hetero else feats
      assert np.array_equal(f.feats, want[f.ids]), (p, t)
      own = node_pb[t] if hetero else node_pb
      assert (own[f.ids] == p).all(), (p, t)
      if f.cache_ids is not None:
        assert np.array_equal(f.cache_feats, want[f.cache_ids]), (p, t)
        assert (own[f.cache_ids] != p).all(), (p, t)
  total = sum(e.shape[1] for e in edges.values()) if hetero else \
      edges.shape[1]
  assert seen == total, (seen, total)
  return seen


def partition_phase(torch, gtt, ds, cpu_ds, ei, feats, device, smi):
  """``sample_prob`` on the card over the script's graph ([15, 10, 5],
  PART_SEEDS seeds) within rtol 1e-5 / atol 1e-6 of the CPU's; a
  FrequencyPartitioner of that graph (2 parts from two seed pools' card
  probabilities, cache ratio PART_CACHE) and a hetero RandomPartitioner of
  the IGBH-width graph, written to a temporary directory that is removed
  afterwards, each read back by load_partition edge for edge and row for
  row; seconds for each."""
  import shutil
  import tempfile

  from graphlearn_tpu_torch import partition
  from graphlearn_tpu_torch.examples import train_rgnn as ex
  cuda = device.type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  t_phase = time.perf_counter()
  n = ds.graph.num_nodes
  rng = np.random.default_rng(17)
  seeds = rng.choice(n, PART_SEEDS, replace=False)
  card = gtt.sampler.NeighborSampler(ds.graph, FANOUTS, device=device)
  host = gtt.sampler.NeighborSampler(cpu_ds.graph, FANOUTS,
                                     device=torch.device('cpu'))
  card.sample_prob(seeds[:8])                      # the first use
  sync()
  e0 = _event(torch, cuda)
  prob = card.sample_prob(seeds)
  e1 = _event(torch, cuda)
  sync()
  prob_ms = _span(e0, e1, cuda)
  t0 = time.perf_counter()
  want = host.sample_prob(seeds)
  cpu_s = time.perf_counter() - t0
  got = prob.cpu()
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
  diff = float((got - want).abs().max())
  touched = int((got > 0).sum())
  rep = dict(sample_prob_ms=prob_ms, sample_prob_cpu_s=cpu_s,
             sample_prob_max_abs_diff=diff, touched=touched)
  if cuda:     # where its device time goes (plain torch: no port kernel)
    rep['sample_prob_profile'] = profiled(
        torch, lambda: card.sample_prob(seeds), 1, device,
        'partition sample_prob', warmup=lambda: card.sample_prob(seeds))
  log(f'partition sample_prob: {PART_SEEDS} seeds over {n} nodes, '
      f'{FANOUTS}: {prob_ms:.3f} ms on {device} ({cpu_s:.2f} s on the CPU), '
      f'{touched} nodes touched, within {diff:.3g} of the CPU on {smi}')
  tmp = tempfile.mkdtemp(prefix='gtt_partition_')
  try:
    pools = np.array_split(rng.permutation(n)[:2 * PART_SEEDS], 2)
    probs = [card.sample_prob(p).cpu().numpy() for p in pools]
    root = os.path.join(tmp, 'freq')
    t0 = time.perf_counter()
    partition.FrequencyPartitioner(root, 2, n, ei, probs=probs,
                                   node_feat=feats,
                                   cache_ratio=PART_CACHE).partition()
    rep['frequency_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep['frequency_edges'] = partition_round_trip(torch, partition, root, 2,
                                                  ei, feats, False)
    rep['frequency_check_s'] = time.perf_counter() - t0
    shutil.rmtree(root)
    cites, writes, hfeats, _ = ex.make_igbh_like(
        HET_PAPER if cuda else 5_000, HET_AUTHOR if cuda else 2_500,
        ex.NUM_CLASSES, np.random.default_rng(0))
    edges = {ex.CITES: cites, ex.WRITES: writes,
             ex.REV_WRITES: writes[::-1].copy()}
    sizes = {t: v.shape[0] for t, v in hfeats.items()}
    root = os.path.join(tmp, 'hetero')
    t0 = time.perf_counter()
    partition.RandomPartitioner(root, 2, sizes, edges, node_feat=hfeats,
                                seed=0).partition()
    rep['hetero_random_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep['hetero_edges'] = partition_round_trip(torch, partition, root, 2,
                                               edges, hfeats, True)
    rep['hetero_check_s'] = time.perf_counter() - t0
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  assert not os.path.exists(tmp)
  rep['phase_s'] = time.perf_counter() - t_phase
  log(f'partition: FrequencyPartitioner of {n} nodes / {ei.shape[1]} edges '
      f'into 2 parts (cache {PART_CACHE}) in {rep["frequency_s"]:.2f} s, '
      f'read back exactly in {rep["frequency_check_s"]:.2f} s; hetero '
      f'RandomPartitioner of the IGBH-width graph in '
      f'{rep["hetero_random_s"]:.2f} s, read back exactly in '
      f'{rep["hetero_check_s"]:.2f} s; phase {rep["phase_s"]:.1f} s on {smi}')
  return rep


# ---- the partitioned (distributed) sampling path
DIST_PARTS = 4                       # shards stacked on the one card
DIST_BATCHES = 3                     # timed loader batches per mode
DIST_MODES = (('tree', 2.0), ('tree', None), ('sort', 2.0), ('sort', None))
DIST_CACHE = 0.1                     # the features' hot-cache share
DIST_STEPS = 3                       # the example's data-parallel steps


def dist_book(n: int, parts: int, seed: int = 0) -> np.ndarray:
  """RandomPartitioner's node book: a seeded shuffle dealt in equal
  contiguous shares."""
  perm = np.random.default_rng(seed).permutation(n)
  pb = np.empty(n, dtype=np.int32)
  share = (n + parts - 1) // parts
  for p in range(parts):
    pb[perm[p * share:(p + 1) * share]] = p
  return pb


def dist_expected_syncs(gtt, sampler, feature, b: int, frac) -> int:
  """The verdict reads of one loader batch: one per exchange whose
  fractional capacity is below its full width (the hops, the feature
  lookup over the node buffer and the label lookup, all at ``frac``)."""
  from graphlearn_tpu_torch import distributed as gdist
  p = sampler.mesh.num_partitions
  caps = sampler.hop_caps(b)
  n = sum(gtt.ops.exchange_capacity(caps[i], p, frac) < caps[i]
          for i in range(len(FANOUTS)))
  width = sampler._node_cap(caps)
  hit = feature.cache_rows / feature.feature_pb.shape[0]
  n += gdist.miss_capacity(width, p, frac, hit) < width
  n += gdist.miss_capacity(width, p, frac) < width
  return int(n)


def dist_batch_check(torch, host, inp, keys, batch, feats_t, labels_t):
  """One card batch against the CPU sampler's on the same seeds and
  keys: every shard's ids, masks, counts and edges exact, and ``x`` /
  ``y`` exactly the feature rows and labels of its ids (zeros at empty
  slots)."""
  out = host.sample_from_nodes(inp, keys=keys)
  for f, got in (('node', batch.node), ('num_nodes', batch.num_nodes),
                 ('row', batch.edge_index[:, 0]),
                 ('col', batch.edge_index[:, 1]),
                 ('edge_mask', batch.edge_mask),
                 ('num_sampled_nodes', batch.num_sampled_nodes),
                 ('num_sampled_edges', batch.num_sampled_edges)):
    assert torch.equal(got.cpu(), getattr(out, f)), f'dist {f} differs'
  node = batch.node
  valid = node >= 0
  safe = node.clamp(min=0).long()
  want_x = torch.where(valid[..., None], feats_t[safe], 0)
  assert torch.equal(batch.x, want_x), 'dist features differ'
  want_y = torch.where(valid, labels_t[safe], 0)
  assert torch.equal(batch.y, want_y.to(batch.y.dtype)), 'dist labels differ'
  return int(valid.sum())


def dist_exchange_ms(torch, mesh, fn, device):
  """The device ms of one call's exchanges: the ``[L, P, cap, ...]``
  shapes ``mesh.all_to_all`` saw in ``fn()``, each transpose timed alone
  (``timed``: queued behind a spin, median of 5)."""
  seen = []
  orig = mesh.all_to_all

  def record(x):
    seen.append((tuple(x.shape), x.dtype))
    return orig(x)
  mesh.all_to_all = record
  try:
    fn()
  finally:
    mesh.all_to_all = orig
  total = 0.0
  for shape, dtype in seen:
    x = torch.zeros(shape, dtype=dtype, device=device)
    total += timed(torch, lambda: orig(x), 5, device)[1]
    del x
  return total, len(seen)


def to_cpu_data(torch, batch):
  import dataclasses
  return dataclasses.replace(batch, **{
      f.name: getattr(batch, f.name).cpu()
      for f in dataclasses.fields(batch)
      if torch.is_tensor(getattr(batch, f.name))})


def dist_train(torch, gtt, ds, pool, b, device, cuda, smi):
  """DIST_STEPS data-parallel steps of the example (GraphSAGE hidden
  HIDDEN, len(FANOUTS) layers) on tree batches; the last one recomputed
  on the CPU from the card's state (``cpu_step_check``: the four shard
  forwards' ReLU inputs, the loss, the gradients and the Adam step)."""
  import copy

  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
  from graphlearn_tpu_torch.models import create_train_state
  mesh = ds.node_features.mesh
  loader = gdist.DistNeighborLoader(ds, FANOUTS, pool, batch_size=b,
                                    shuffle=True, seed=1, mesh=mesh,
                                    dedup='tree')

  def model_on(d):
    m = ex.make_model(FEAT_DIM, HIDDEN, CLASSES, FANOUTS, b, d,
                      torch.Generator().manual_seed(0))
    m.relu_hooks_by_call = True      # four shard forwards a step
    return m
  model = model_on(device)
  state = create_train_state(model, lr=LR)
  losses, step_ms, check = [], [], None
  it = iter(loader)
  for s in range(DIST_STEPS):
    batch = next(it)
    last = s + 1 == DIST_STEPS
    pre, hooks = {}, []
    if last:
      check = (copy.deepcopy(model.state_dict()),
               copy.deepcopy(state.optimizer.state_dict()),
               to_cpu_data(torch, batch))
      hooks = relu_input_hooks(model, recorder(pre))
    e0 = _event(torch, cuda)
    loss, acc = ex.dp_step(model, state.optimizer, batch, mesh, CLASSES)
    e1 = _event(torch, cuda)
    if cuda:
      e1.synchronize()
    step_ms.append(_span(e0, e1, cuda))
    losses.append(float(loss))
    for h in hooks:
      h.remove()
  assert all(np.isfinite(losses)), losses
  check += ([p.grad.detach().cpu() for p in model.parameters()],
            {k: z.cpu() for k, z in pre.items()})
  cpu_mesh = gdist.ShardMesh(mesh.num_partitions, 'cpu')

  def make_step(m):
    def st(s, bb):
      loss, acc = ex.dp_step(m, s.optimizer, bb, cpu_mesh, CLASSES)
      return s, loss, acc
    return st, None
  c = cpu_step_check(torch, gtt, None, model, check, losses[-1],
                     cpu_model=lambda: model_on(torch.device('cpu')),
                     make_step=make_step)
  log(f'dist train: {DIST_STEPS} data-parallel steps of the example '
      f'(GraphSAGE {FEAT_DIM}-{HIDDEN}-{CLASSES}, {len(FANOUTS)} layers, '
      f'{mesh.num_partitions} shards of {b} seeds): ' +
      ' '.join(f'{m:.2f}' for m in step_ms) + ' ms, losses ' +
      ' '.join(f'{v:.4f}' for v in losses) + '; the last recomputed on the '
      f'CPU (gradients within {c["grad_share"]:.3g} of the largest, Adam '
      f'within {c["adam_diff"]:.3g}) on {smi}')
  return dict(step_ms=step_ms, losses=losses, cpu_check={
      k: c[k] for k in ('pre_diff', 'opposite', 'leaky_opposite',
                        'grad_share', 'adam_diff', 'cpu_loss')})


def dist_nccl(torch, gtt, parts, feats, n, device, smi):
  """One ``init_multihost`` process group of world size 1 (NCCL on the
  card, gloo on the CPU) samples one tree batch of partition 0's graph
  with edge ids and features: equal to the one-process ``ShardMesh`` at
  P = 1."""
  import torch.distributed as dist

  from graphlearn_tpu_torch import distributed as gdist
  pb = np.zeros(n, dtype=np.int32)
  dg = gdist.DistGraph(1, 0, parts[:1], pb)
  own = np.unique(parts[0].edge_index[0])
  seeds = own[np.random.default_rng(3).permutation(own.shape[0])[:BATCH]]
  ids = np.arange(n, dtype=np.int64)

  def batch(mesh):
    s = gdist.DistNeighborSampler(dg, FANOUTS, mesh, seed=0, dedup='tree',
                                  with_edge=True)
    f = gdist.DistFeature(1, [(ids, feats)], pb, mesh)
    out = s.sample_from_nodes(seeds[None])
    return out, f.get(out.node)
  t0 = time.perf_counter()
  port = gtt.utils.get_free_port()
  ctx = gdist.init_multihost(f'localhost:{port}', 1, 0, device=device)
  try:
    backend = dist.get_backend()
    got, gx = batch(ctx.mesh)
    want, wx = batch(gdist.ShardMesh(1, device))
    for f in ('node', 'num_nodes', 'row', 'col', 'edge_mask', 'edge',
              'num_sampled_nodes', 'num_sampled_edges'):
      assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(gx, wx)
  finally:
    dist.destroy_process_group()
  secs = time.perf_counter() - t0
  log(f'dist {backend}: a world-size-1 process group sampled one tree batch '
      f'({BATCH} seeds, {FANOUTS}) with edge ids and features, equal to the '
      f'one-process mesh; {secs:.1f} s on {smi}')
  return dict(backend=backend, seconds=secs,
              nodes=int(got.num_nodes.sum()))


def dist_phase(torch, gtt, ei, feats, labels, device, smi, keep=None):
  """The partitioned path at P = DIST_PARTS on the card: the script's
  graph split by RandomPartitioner's rule (edges by source), stacked on
  one device as a ``DistDataset`` (features with a DIST_CACHE hot cache
  by in-degree); per mode of DIST_MODES a ``DistNeighborLoader`` at
  FANOUTS and BATCH seeds per shard: DIST_BATCHES batches timed (the
  launch counters set to 0 before and read after: K3 P x hops a batch,
  K1 3P: the cache, the local rows, the labels), the first held exactly
  against the CPU sampler on the same partitions and keys; one batch
  more under sync counting (the verdict reads, and nothing else, as
  ``dist_expected_syncs`` says); one profiled; the exchanges' device ms.
  Then the example's data-parallel steps and the NCCL single-rank
  group. ``keep`` (a dict) receives the host partitions for the
  dist_scan phase."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  cuda = device.type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  t_phase = time.perf_counter()
  n = feats.shape[0]
  nparts = DIST_PARTS
  b = BATCH if cuda else 64
  t0 = time.perf_counter()
  pb = dist_book(n, nparts)
  parts, fparts = ex.partition_in_memory(ei, feats, pb, nparts)
  card_mesh = gdist.ShardMesh(nparts, device)
  cpu_mesh = gdist.ShardMesh(nparts, 'cpu')
  dg = gdist.DistGraph(nparts, 0, parts, pb)
  hot = np.bincount(ei[1], minlength=n)
  if keep is not None:
    keep.update(parts=parts, fparts=fparts, pb=pb, hot=hot)
  ds = gdist.DistDataset(nparts, 0, dg, gdist.DistFeature(
      nparts, fparts, pb, card_mesh, split_ratio=DIST_CACHE, hotness=hot),
      node_labels=labels)
  feats_t = torch.as_tensor(feats).to(device)
  labels_t = torch.as_tensor(labels).to(device)
  dev = ds.node_features.device_arrays()
  sync()
  build_s = time.perf_counter() - t0
  # blocks: a first use, the timed batches, one under sync counting;
  # the exchange and profile loader takes at most 7 (retries included)
  pool = np.random.default_rng(11).permutation(n)[
      :nparts * b * max(DIST_BATCHES + 2, 7)]
  hops = len(FANOUTS)
  rep = dict(parts=nparts, batch=b, build_s=build_s, modes={})
  for dedup, frac in DIST_MODES:
    name = f'{dedup}/{frac}'
    loader = gdist.DistNeighborLoader(ds, FANOUTS, pool, batch_size=b,
                                      seed=0, mesh=card_mesh, dedup=dedup,
                                      bucket_frac=frac)
    host = gdist.DistNeighborSampler(dg, FANOUTS, cpu_mesh, seed=0,
                                     dedup=dedup, bucket_frac=frac)
    ds.node_features.bucket_frac = frac     # the features' exchange too
    blocks = list(loader._index_blocks())
    it = iter(loader)
    next(it)                                       # the first use
    sync()
    ops.reset_launch_counts()
    gdist.reset_verdict_syncs()
    ms, wall, batches = [], [], []
    for _ in range(DIST_BATCHES):
      t0 = time.perf_counter()
      e0 = _event(torch, cuda)
      batches.append(next(it))
      e1 = _event(torch, cuda)
      sync()
      wall.append((time.perf_counter() - t0) * 1e3)
      ms.append(_span(e0, e1, cuda))
    counts = ops.launch_counts()
    verdicts = gdist.verdict_syncs() / DIST_BATCHES
    per = 1 if cuda else 0
    assert counts['sample_hop'] == per * nparts * hops * DIST_BATCHES, counts
    assert counts['gather_rows'] == per * 3 * nparts * DIST_BATCHES, counts
    # the first timed batch, every shard, against the CPU sampler (the
    # plain versions) on the same seeds and keys
    t0 = time.perf_counter()
    idx, _ = blocks[1]
    seen = dist_batch_check(
        torch, host, NodeSamplerInput(loader.input_seeds[idx]),
        loader.sampler._keys_for(2), batches[0], feats_t, labels_t)
    check_s = time.perf_counter() - t0
    del batches
    expect = dist_expected_syncs(gtt, loader.sampler, ds.node_features, b,
                                 frac)
    assert verdicts == expect, (verdicts, expect)
    if cuda:
      gdist.reset_verdict_syncs()
      _, syncs, kinds = count_syncs(torch, lambda: next(it))
      assert syncs == gdist.verdict_syncs() == expect, (syncs, kinds, expect)
    else:
      syncs, kinds = None, {}
    extra = iter(gdist.DistNeighborLoader(
        ds, FANOUTS, pool, batch_size=b, seed=5, mesh=card_mesh,
        dedup=dedup, bucket_frac=frac))
    exch_ms, exch_n = dist_exchange_ms(torch, card_mesh, lambda: next(extra),
                                       device)
    prof = profiled(torch, lambda: next(extra), 1, device, f'dist {name}',
                    warmup=lambda: next(extra)) if cuda else None
    busy = prof['device_busy_ms'] if prof else None
    rep['modes'][name] = dict(
        launches=counts, ms=ms, wall_ms=wall, median_ms=float(np.median(ms)),
        verdict_syncs_per_batch=verdicts, host_syncs=syncs,
        sync_kinds=kinds, checked_slots=seen, cpu_check_s=check_s,
        exchange_ms=exch_ms, exchanges=exch_n,
        exchange_share=(exch_ms / busy if busy else None), profile=prof,
        k3_per_batch=counts['sample_hop'] / DIST_BATCHES,
        k1_per_batch=counts['gather_rows'] / DIST_BATCHES)
    log(f'dist {name}: P={nparts} x {b} seeds {FANOUTS}: '
        + ' '.join(f'{m:.2f}' for m in ms) + f' ms a stacked batch (host '
        + ' '.join(f'{w:.1f}' for w in wall) + ' ms); K3 '
        f'{counts["sample_hop"] / DIST_BATCHES:.0f} and K1 '
        f'{counts["gather_rows"] / DIST_BATCHES:.0f} a batch; host syncs '
        f'{syncs} (verdicts {verdicts:.0f}, expected {expect}); exchanges '
        f'{exch_ms:.3f} ms over {exch_n} transposes' +
        (f' = {exch_ms / busy:.1%} of {busy:.3f} busy ms, idle '
         f'{prof["idle_share"]:.1%}' if busy else '') +
        f'; the first exact against the CPU ({seen} slots, '
        f'{check_s:.1f} s) on {smi}')
  del feats_t, labels_t, dev
  if cuda:
    torch.cuda.empty_cache()
  rep['train'] = dist_train(torch, gtt, ds, pool, b, device, cuda, smi)
  del ds
  if cuda:
    torch.cuda.empty_cache()
  rep['nccl'] = dist_nccl(torch, gtt, parts, feats, n, device, smi)
  rep['launches'] = {k: sum(m['launches'][k] for m in rep['modes'].values())
                     for k in rep['modes'][f'tree/2.0']['launches']}
  rep['phase_s'] = time.perf_counter() - t_phase
  log(f'dist phase {rep["phase_s"]:.1f} s (build {build_s:.1f} s) on {smi}')
  return rep


# ---- the scanned distributed epoch (DistScanTrainer, FailoverRunner)
DSCAN_STEPS = 8                      # steps an epoch (P x BATCH seeds each)
DSCAN_CHUNK = 4                      # K
DSCAN_CRASH_CHUNK = 2                # the checkpointed epoch dies here
DSCAN_DEAD_RANK = 2                  # the failover's dead shard
DSCAN_DEAD_CHUNK = 1                 # ... read dead at this boundary
DSCAN_HOT_SHARE = 25                 # % of a partition on the card, tiered


def dist_keys_case(torch, gtt, device, reps, k, nparts, hops):
  """The distributed chunk's keys (one launch: K steps x P shards x the
  hops) from a device counter, against ``dist_step_keys_plain`` on the
  same device words, exact; the counts cross 2**32."""
  from graphlearn_tpu_torch import ops
  base = gtt.random.to_device(
      gtt.random.fold_in(gtt.random.PRNGKey(0), 9), device)
  counter = torch.full((), 2 ** 32 - 2, dtype=torch.int64, device=device)
  steps = torch.arange(k, dtype=torch.int64, device=device)
  got, ms, call_ms = timed(
      torch, lambda: ops.dist_step_keys(base, counter, k, nparts, hops),
      reps, device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: gtt.random.dist_step_keys_plain(
          base, counter + steps, nparts, hops), reps, device)
  exact = bool(torch.equal(got, ref))
  keys = k * nparts * hops
  nbytes = 2 * 8 + 8 + keys * 2 * 8
  ops_n = instructions({'dist_step_keys.key': keys})
  rec = dict(steps=k, parts=nparts, hops=hops, exact=exact,
             max_abs_err=float((got - ref).abs().max()), ms=ms,
             call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
             **bound_record(nbytes, ops_n, fill_ms(torch, [got], device,
                                                   reps), ms))
  log(f'kernel dist_step_keys: [{k}, {nparts}, {hops}, 2] keys exact={exact} '
      f'ms={ms:.4f} plain_ms={plain_ms:.4f} {bound_text(rec)}; call ms '
      f'{call_ms:.4f} {plain_call_ms:.4f}')
  assert exact, 'dist_step_keys: kernel != plain version'
  return rec


def dscan_epoch(torch, trainer, state, cuda, **kw):
  """One ``run_epoch`` with the launch counters set to 0 before it and
  read after: ``(state, losses, accs, ms, launches)``."""
  from graphlearn_tpu_torch import ops
  if cuda:
    torch.cuda.synchronize()
  ops.reset_launch_counts()
  a = _event(torch, cuda)
  state, losses, accs = trainer.run_epoch(state, **kw)
  b = _event(torch, cuda)
  if cuda:
    b.synchronize()
  return state, losses, accs, _span(a, b, cuda), ops.launch_counts()


STAT_KEYS = ('hits', 'misses', 'unique_misses', 'overflow', 'lookups')


class Published:
  """``with Published(stores) as got``: ``got[key]`` sums what store
  ``stores[key]``'s ``publish_stats`` published inside the block. The
  distributed loaders and trainers publish their stores' counters once
  an epoch, at its end (JAX's contract), and clear them: an epoch's
  counters are read here, not from ``stats()`` after it."""

  def __init__(self, stores: dict):
    self.stores = stores
    self.got = {k: dict.fromkeys(STAT_KEYS, 0) for k in stores}

  def __enter__(self):
    for key, store in self.stores.items():
      store.publish_stats = self._wrap(key, store.publish_stats)
    return self.got

  def _wrap(self, key, plain):
    def publish_stats(*a, **kw):
      out = plain(*a, **kw)
      for k in STAT_KEYS:
        self.got[key][k] += out[k]
      return out
    return publish_stats

  def __exit__(self, *exc):
    for store in self.stores.values():
      del store.publish_stats


def let_publish_through(torch, loader) -> list:
  """The loader's epoch-end publish (one host read a store) runs with the
  sync debug mode off, so a counted window sees the epoch's other syncs
  only; returns the list its calls are counted in."""
  calls, publish = [], loader._publish_feature_stats

  def let_through():
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
      publish()
    finally:
      torch.cuda.set_sync_debug_mode(mode)
    calls.append(1)

  loader._publish_feature_stats = let_through
  return calls


def dscan_state(trainer):
  """The tensors a chunk updates in place: the parameters and Adam's."""
  import torch
  opt = trainer._chunk_carry['state'].optimizer
  ps = list(trainer.model.parameters())
  return ps + [v for p in ps for v in opt.state[p].values()
               if torch.is_tensor(v)]


def dscan_last_step(torch, trainer, step_index, mesh_cpu):
  """Wraps ``trainer._dp_step`` so that its ``step_index``-th call of the
  next epoch records what ``cpu_step_check`` needs: the state before the
  step, the CPU shard batches, the card's gradients and ReLU inputs."""
  import copy

  from graphlearn_tpu_torch.loader.pipeline import data_parallel_step
  from graphlearn_tpu_torch.models import train
  calls, out = [0], {}
  inner = trainer._dp_step

  def step(state, shards):
    if calls[0] != step_index:
      calls[0] += 1
      return inner(state, shards)
    calls[0] += 1
    pre = {}
    out['check'] = (copy.deepcopy(trainer.model.state_dict()),
                    copy.deepcopy(state.optimizer.state_dict()),
                    [{k: v.cpu() for k, v in sh.items()} for sh in shards])
    hooks = relu_input_hooks(trainer.model, recorder(pre))
    res = inner(state, shards)
    for h in hooks:
      h.remove()
    out['loss'] = res[1]
    out['check'] += ([p.grad.detach().cpu() for p in
                      trainer.model.parameters()],
                     {k: z.cpu() for k, z in pre.items()})
    return res

  trainer._dp_step = step

  def make_step(m):
    loss_fn = train.make_loss_fn(m, CLASSES)

    def st(s, shards):
      loss, acc = data_parallel_step(s.optimizer, loss_fn, shards, mesh_cpu)
      return s, loss, acc
    return st, None
  return out, make_step


def dscan_release(torch, cuda, *trainers) -> dict:
  """Drop the trainers' captured chunks and the gradients a capture
  allocated in their graphs' pools, so the pools go back to the card;
  the card's allocated and reserved GB after."""
  import gc
  for t in trainers:
    if hasattr(t, '_drop_graphs'):
      t._drop_graphs()
    else:
      t.model.zero_grad(set_to_none=True)
  gc.collect()
  if not cuda:
    return {}
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  return dict(allocated_gb=torch.cuda.memory_allocated() / 2 ** 30,
              reserved_gb=torch.cuda.memory_reserved() / 2 ** 30)


def dist_scan_phase(torch, gtt, ei, feats, labels, device, smi, built=None):
  """The scanned distributed epoch on the dist phase's graph and shards
  (P = DIST_PARTS on the card, FANOUTS at BATCH seeds a shard, a
  DIST_CACHE hot cache, every exchange full width: ``bucket_frac=None``),
  DSCAN_STEPS steps an epoch in chunks of DSCAN_CHUNK. Tree (the example's
  GraphSAGE, hidden HIDDEN): a captured ``DistScanTrainer``, an eager one
  and the per-step loop (``run_epoch_steps``) from one start, equal within
  rtol 1e-4 (the eager chunk's first batch exact against the loader's),
  the eager epoch's last step recomputed on the CPU; launches (K3 P x hops
  and K1 3P a step, one ``dist_step_keys`` a chunk), host syncs of a
  captured epoch (0), the profiler's kernels against the counters. Sort
  (the merge-dense GraphSAGE): captured against eager chunk by chunk from
  a common state. Then a checkpointed captured epoch crashed and resumed,
  and a failover of rank DSCAN_DEAD_RANK at chunk DSCAN_DEAD_CHUNK to
  P - 1 shards on the card, every seed trained once."""
  import copy
  import shutil

  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
  from graphlearn_tpu_torch.models import create_train_state
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer, FailoverRunner
  cuda = device.type == 'cuda'
  t_phase = time.perf_counter()
  n = feats.shape[0]
  nparts = DIST_PARTS
  b = BATCH if cuda else 64
  steps = DSCAN_STEPS if cuda else 4
  chunk = DSCAN_CHUNK if cuda else 2
  chunks = -(-steps // chunk)
  hops = len(FANOUTS)
  per = 1 if cuda else 0
  t0 = time.perf_counter()
  if built:
    parts, fparts, pb, hot = (built[k] for k in ('parts', 'fparts', 'pb',
                                                 'hot'))
  else:
    pb = dist_book(n, nparts)
    parts, fparts = ex.partition_in_memory(ei, feats, pb, nparts)
    hot = np.bincount(ei[1], minlength=n)

  def dataset(p, p_parts, p_fparts, p_pb):
    mesh = gdist.ShardMesh(p, device)
    return gdist.DistDataset(p, 0, gdist.DistGraph(p, 0, p_parts, p_pb),
                             gdist.DistFeature(
                                 p, p_fparts, p_pb, mesh,
                                 split_ratio=DIST_CACHE, hotness=hot,
                                 bucket_frac=None),
                             node_labels=labels)
  ds = dataset(nparts, parts, fparts, pb)
  store = ds.node_features
  build_s = time.perf_counter() - t0
  pool = np.random.default_rng(12).permutation(n)[:nparts * b * steps]

  def loader(dedup='tree', seeds=pool, shuffle=False, data=ds,
             drop_last=True):
    return gdist.DistNeighborLoader(
        data, FANOUTS, seeds, batch_size=b, shuffle=shuffle,
        drop_last=drop_last, seed=0, mesh=data.node_features.mesh,
        dedup=dedup, bucket_frac=None)

  def model_on(d, dedup='tree'):
    gen = torch.Generator().manual_seed(0)
    if dedup == 'tree':
      m = ex.make_model(FEAT_DIM, HIDDEN, CLASSES, FANOUTS, b, d, gen)
    else:   # the layered merge forward over the merge layout
      no, eo = gtt.models.merge_hop_offsets(b, FANOUTS)
      m = gtt.models.GraphSAGE(FEAT_DIM, HIDDEN, CLASSES,
                               num_layers=len(FANOUTS), hop_node_offsets=no,
                               hop_edge_offsets=eo, merge_dense=True,
                               fanouts=FANOUTS, device=d, generator=gen)
    m.relu_hooks_by_call = True      # P shard forwards a step
    return m

  def trainer(dedup='tree', capture=None, model=None, **kw):
    m = model if model is not None else model_on(device, dedup)
    return gtt.loader.DistScanTrainer(loader(dedup, **kw), m, CLASSES,
                                      chunk_size=chunk, capture=capture)

  rep = dict(parts=nparts, batch=b, steps=steps, chunk=chunk,
             build_s=build_s, launch_runs=[])
  rep['kernel'] = dist_keys_case(torch, gtt, device, REPS if cuda else 2,
                                 chunk, nparts, hops)
  want_launch = dict(sample_hop=per * nparts * hops * steps,
                     gather_rows=per * 3 * nparts * steps,
                     dist_step_keys=per * chunks)

  def held(counts, what, replay=False):
    # a tiered epoch's prologue replays the sampler over every step under
    # one more key launch: K3 twice, dist_step_keys once more
    want = dict(want_launch)
    if replay:
      want['sample_hop'] *= 2
      want['dist_step_keys'] += per
    for k, v in want.items():
      assert counts[k] == v, (what, k, counts)
    rep['launch_runs'].append(counts)

  # ---- 1. tree: captured, eager and the per-step loop from one start
  start = model_on(device).state_dict()
  cap = trainer()
  eag = trainer(capture=False)
  loop = gtt.loader.DistFusedEpochTrainer(loader(), model_on(device),
                                          CLASSES)
  for t in (cap, eag, loop):
    t.model.load_state_dict(start)
  assert cap.capture == cuda and not eag.capture
  states = {id(t): create_train_state(t.model, lr=LR)
            for t in (cap, eag, loop)}
  # the eager chunk's first batch, exact against the loader's
  first = {}
  inner = eag._sample_collate

  def keep_first(seeds, smask, keys):
    out = inner(seeds, smask, keys)
    if not first:
      first['batch'] = out[0]
    return out
  eag._sample_collate = keep_first
  mesh_cpu = gdist.ShardMesh(nparts, 'cpu')
  last, make_step = dscan_last_step(torch, eag, steps - 1, mesh_cpu)
  res = {}
  for name, t in (('captured', cap), ('eager', eag)):
    store.reset_stats()
    with Published({0: store}) as got:
      st, losses, accs, ms, counts = dscan_epoch(torch, t, states[id(t)],
                                                 cuda)
    states[id(t)] = st
    held(counts, f'tree {name} epoch 1')
    res[name] = dict(losses=losses, stats=got[0], ms1=ms,
                     capture_ms=t.capture_ms)
  eag._sample_collate = inner
  del eag._dp_step
  store.reset_stats()
  if cuda:
    torch.cuda.synchronize()
  with Published({0: store}) as got:
    a = _event(torch, cuda)
    states[id(loop)], llosses = loop.run_epoch_steps(states[id(loop)])
    bev = _event(torch, cuda)
    if cuda:
      bev.synchronize()
  res['loop'] = dict(losses=torch.stack(llosses), stats=got[0],
                     ms1=_span(a, bev, cuda))
  assert res['captured']['stats']['lookups'] > 0, res['captured']['stats']
  want = next(iter(loader()))
  fb = first['batch']
  for f in ('edge_index', 'edge_mask', 'x', 'y'):
    assert torch.equal(fb[f], getattr(want, f)), f'dist_scan first {f}'
  assert torch.equal(fb['num_seed_nodes'], want.num_sampled_nodes[:, 0])
  del first, want, fb
  for name in ('eager', 'loop'):
    torch.testing.assert_close(res['captured']['losses'],
                               res[name]['losses'], rtol=1e-4, atol=0)
    assert res[name]['stats'] == res['captured']['stats'], name
  equal = {name: bool(torch.equal(res['captured']['losses'],
                                  res[name]['losses']))
           for name in ('eager', 'loop')}
  # the graphs' keys: the epoch's last chunk of each length, exact
  keys_want = gtt.random.dist_step_keys_plain(
      cap._sampler._key, 1 + torch.arange(steps, dtype=torch.int64), nparts,
      hops)
  for k, g in cap._graphs.items():
    s0 = max(s for s in range(0, steps, chunk) if min(chunk, steps - s) == k)
    assert torch.equal(g.keys.cpu(), keys_want[s0:s0 + k]), k
  c = cpu_step_check(torch, gtt, None, eag.model, last['check'],
                     last['loss'], cpu_model=lambda: model_on('cpu'),
                     make_step=make_step)
  rep['cpu_check'] = {k: c[k] for k in ('pre_diff', 'opposite',
                                        'grad_share', 'adam_diff',
                                        'cpu_loss', 'loss')}
  log(f'dist_scan tree epoch 1: captured vs eager vs the per-step loop '
      f'losses within rtol 1e-4 (bit-equal eager {equal["eager"]}, loop '
      f'{equal["loop"]}), feature counters equal '
      f'{res["captured"]["stats"]}; the eager chunk\'s first batch exact; '
      f'the last step on the CPU: gradients within {c["grad_share"]:.3g} '
      f'of the largest, Adam {c["adam_diff"]:.3g}')
  # the timed epoch (replays only), then host syncs and the profile
  timing = {}
  for name, t in (('captured', cap), ('eager', eag)):
    st, _, _, ms, counts = dscan_epoch(torch, t, states[id(t)], cuda)
    states[id(t)] = st
    held(counts, f'tree {name} epoch 2')
    timing[name] = ms / steps
  st, ll = loop.run_epoch_steps(states[id(loop)])
  a = _event(torch, cuda)
  st, ll = loop.run_epoch_steps(st)
  bev = _event(torch, cuda)
  if cuda:
    bev.synchronize()
  states[id(loop)] = st
  timing['loop'] = _span(a, bev, cuda) / steps
  epoch = cap_epoch = None
  rep['tree'] = dict(
      ms_per_step=timing, first_epoch_ms=({k: res[k]['ms1'] for k in res}),
      capture_ms=cap.capture_ms, losses_bit_equal=equal,
      losses=res['captured']['losses'].tolist(),
      feature_stats=res['captured']['stats'])
  if cuda:
    def cap_epoch():
      states[id(cap)] = cap.run_epoch(states[id(cap)])[0]
    # the epoch's end publishes its store's counters (one host read, JAX's
    # contract): let through and counted apart from the chunks' syncs
    published = let_publish_through(torch, cap.loader)
    _, n_sync, kinds = count_syncs(torch, cap_epoch)
    del cap.loader._publish_feature_stats
    torch.cuda.synchronize()
    rep['tree']['host_syncs_per_step'] = n_sync / steps
    rep['tree']['publish_reads'] = len(published)
    assert n_sync == 0 and len(published) == 1, (kinds, published)
    for name, t in (('captured', cap), ('eager', eag)):
      def epoch(t=t):
        states[id(t)] = t.run_epoch(states[id(t)])[0]
      prof = profiled(torch, epoch, 1, device, f'dist_scan tree epoch '
                      f'({name})', warmup=lambda: (epoch(),
                                                   ops.reset_launch_counts()),
                      expect=port_launch_counts)
      counted = port_launch_counts()
      assert prof['kernels'] == counted, (name, prof['kernels'], counted,
                                          prof['port_kernel_names'])
      rep['tree'][f'profile_{name}'] = dict(
          idle_share=prof['idle_share'],
          busy_ms_per_step=prof['device_busy_ms'] / steps,
          wall_ms_per_step=prof['wall_ms'] / steps,
          device_ops_per_step=prof['device_ops_per_call'] / steps,
          top5=dict(list(prof['top_device_ms'].items())[:5]),
          kernels=prof['kernels'])
  log(f'dist_scan tree: {steps} steps of P={nparts} x {b} seeds in chunks '
      f'of {chunk}: captured {timing["captured"]:.2f} ms/step, eager '
      f'{timing["eager"]:.2f}, the per-step loop {timing["loop"]:.2f}; '
      f'capture ms {cap.capture_ms}; ' + (
          f'host syncs a captured step {rep["tree"]["host_syncs_per_step"]}; '
          f'idle share captured '
          f'{rep["tree"]["profile_captured"]["idle_share"]:.1%}, eager '
          f'{rep["tree"]["profile_eager"]["idle_share"]:.1%}; top 5 ops of '
          f'a captured epoch (ms): ' + '; '.join(
              f'{k[:50]}={v:.2f}' for k, v in
              rep['tree']['profile_captured']['top5'].items()) if cuda
          else '') + f' on {smi}')
  if cuda:
    rep['tree']['peak_allocated_gb'] = (torch.cuda.max_memory_allocated() /
                                        2 ** 30)
  rep['tree']['after_release'] = dscan_release(torch, cuda, cap, eag, loop)
  log(f'dist_scan tree: peak allocated {rep["tree"].get("peak_allocated_gb")} '
      f'GB; after release {rep["tree"]["after_release"]}')
  del cap, eag, loop, states, epoch, cap_epoch

  # ---- 2. sort: captured against eager, chunk by chunk from one state.
  # A full-width sort step keeps tens of GB for its backward (P forwards
  # before one backward), so the captured trainer's graph goes before the
  # eager trainer runs: the captured epoch 2 keeps its state after each
  # chunk, then the eager one takes it up at each chunk start
  if cuda:
    torch.cuda.reset_peak_memory_stats()
  scap = trainer('sort')
  sst = create_train_state(scap.model, lr=LR)
  sst, _, _, _, counts = dscan_epoch(torch, scap, sst, cuda)
  held(counts, 'sort captured epoch 1')
  s1 = (copy.deepcopy(scap.model.state_dict()),
        copy.deepcopy(sst.optimizer.state_dict()))
  kept, diffs, loss_runs, sort_ms = {}, [], {}, {}

  def keep(c, s0, k):
    kept[s0 + k] = [x.detach().clone() for x in dscan_state(scap)]
  scap.ack_hook = keep
  sst, losses, _, ms, counts = dscan_epoch(torch, scap, sst, cuda)
  held(counts, 'sort captured epoch 2')
  sort_ms['captured'], loss_runs['captured'] = ms / steps, losses
  sort_capture_ms = scap.capture_ms
  sort_peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
  dscan_release(torch, cuda, scap)
  del scap, sst
  seag = trainer('sort', capture=False)
  est = create_train_state(seag.model, lr=LR)
  est, _, _, _, counts = dscan_epoch(torch, seag, est, cuda)
  held(counts, 'sort eager epoch 1')
  seag.model.load_state_dict(s1[0])
  est.optimizer.load_state_dict(copy.deepcopy(s1[1]))
  for group in est.optimizer.param_groups:
    group['capturable'] = cuda

  @torch.no_grad()
  def take_up(c, s0, k):
    if s0:
      torch._foreach_copy_(dscan_state(seag), kept[s0])

  def compare(c, s0, k):
    diffs.append(max(float((x.detach() - y).abs().max())
                     for x, y in zip(dscan_state(seag), kept[s0 + k])))
  seag.stage_hook, seag.ack_hook = take_up, compare
  est, losses, _, ms, counts = dscan_epoch(torch, seag, est, cuda)
  held(counts, 'sort eager epoch 2')
  sort_ms['eager'], loss_runs['eager'] = ms / steps, losses
  assert len(diffs) == chunks, diffs
  assert max(diffs) < PARAMS_LIMIT, diffs
  rel = float(((loss_runs['captured'] - loss_runs['eager']).abs() /
               loss_runs['eager'].abs()).max())
  rep['sort'] = dict(ms_per_step=sort_ms, chunk_param_diffs=diffs,
                     max_rel_loss_diff=rel, capture_ms=sort_capture_ms,
                     peak_allocated_gb=sort_peak)
  log(f'dist_scan sort: captured {sort_ms["captured"]:.2f} ms/step, eager '
      f'{sort_ms["eager"]:.2f} (peak allocated {sort_peak} GB, capture ms '
      f'{sort_capture_ms}); held chunk by chunk from the captured '
      f'state: params and Adam within {max(diffs):.3g} (limit '
      f'{PARAMS_LIMIT}), losses max rel diff {rel:.3g} on {smi}')
  rep['sort']['after_release'] = dscan_release(torch, cuda, seag)
  del seag, est, kept

  # ---- 3. a checkpointed captured epoch, crashed and resumed
  ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                       'dist_scan_ckpt')
  shutil.rmtree(ckdir, ignore_errors=True)
  ref_t = trainer()
  ref_t.model.load_state_dict(start)
  store.reset_stats()
  with Published({0: store}) as got:
    rs, rlosses, _, _, counts = dscan_epoch(
        torch, ref_t, create_train_state(ref_t.model, lr=LR), cuda)
  held(counts, 'checkpoint reference')
  rstats = got[0]
  dscan_release(torch, cuda, ref_t)
  victim = trainer()
  victim.model.load_state_dict(start)
  # every 2 chunks on the card (a snapshot after chunk 1, the crash at 2);
  # a rehearsal's epoch of 2 chunks takes every chunk
  every = 2 if chunks > 2 else 1
  ck = ChunkCheckpointer(ckdir, every=every).attach(victim)
  crash_chunk = min(DSCAN_CRASH_CHUNK, chunks - 1)

  def crash(c, s0, k):
    if c == crash_chunk:
      raise RuntimeError('dist_scan: the injected crash')
  victim.stage_hook = crash
  store.reset_stats()
  try:
    victim.run_epoch(create_train_state(victim.model, lr=LR))
    raise AssertionError('the checkpointed epoch did not crash')
  except RuntimeError as e:
    assert 'injected crash' in str(e), e
  ck.close()
  dscan_release(torch, cuda, victim)
  del victim
  fresh = trainer()
  t0 = time.perf_counter()
  with Published({0: store}) as got:
    fst, flosses, _ = ChunkCheckpointer(ckdir).resume_epoch(
        fresh, create_train_state(fresh.model, lr=LR))
  resume_s = time.perf_counter() - t0
  torch.testing.assert_close(torch.as_tensor(flosses), rlosses.cpu(),
                             rtol=1e-4, atol=0)
  pdiff = max(float((x - y).detach().abs().max()) for x, y in
              zip(fresh.model.parameters(), ref_t.model.parameters()))
  assert pdiff < PARAMS_LIMIT, pdiff
  assert got[0] == rstats, (got[0], rstats)
  rep['checkpoint'] = dict(
      every=every, crash_chunk=crash_chunk, resume_s=resume_s,
      losses_bit_equal=bool(np.array_equal(flosses, rlosses.cpu().numpy())),
      max_abs_param_diff=pdiff, feature_stats=rstats)
  log(f'dist_scan checkpoint: ChunkCheckpointer(every={every}), crash at '
      f'chunk {crash_chunk}, resumed in a fresh captured trainer in '
      f'{resume_s:.2f} s: losses bit-equal '
      f'{rep["checkpoint"]["losses_bit_equal"]}, params within {pdiff:.3g}, '
      f'feature counters exact on {smi}')
  shutil.rmtree(ckdir, ignore_errors=True)
  rep['checkpoint']['after_release'] = dscan_release(torch, cuda, ref_t,
                                                     fresh)
  del ref_t, fresh

  # ---- 4. the tiered distributed epoch: a quarter of each partition on
  # the card, the rest spilled under build/ and staged per chunk; equal to
  # the all-device epoch
  spill = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                       'dist_scan_spill')
  shutil.rmtree(spill, ignore_errors=True)
  t0 = time.perf_counter()
  tstore = gtt.storage.TieredDistFeature(
      nparts, fparts, pb, mesh=store.mesh, spill_dir=spill,
      hot_prefix_rows=-(-store.n_max * DSCAN_HOT_SHARE // 100),
      split_ratio=DIST_CACHE, hotness=hot, bucket_frac=None)
  spill_s = time.perf_counter() - t0
  tds = gdist.DistDataset(nparts, 0, ds.graph, tstore, node_labels=labels)
  tiered = gtt.storage.TieredDistScanTrainer(loader(data=tds), model_on(
      device), CLASSES, chunk_size=chunk)
  hbm = trainer()
  for t in (tiered, hbm):
    t.model.load_state_dict(start)
  tst = {id(t): create_train_state(t.model, lr=LR) for t in (tiered, hbm)}
  tiered_rep = {}
  for epoch in range(2):
    out = {}
    for name, t in (('tiered', tiered), ('hbm', hbm)):
      t._feat.reset_stats()
      with Published({0: t._feat}) as got:
        tst[id(t)], losses, _, ms, counts = dscan_epoch(torch, t,
                                                        tst[id(t)], cuda)
      held(counts, f'{name} epoch {epoch + 1}', replay=name == 'tiered')
      out[name] = dict(losses=losses, ms=ms, stats=got[0])
    assert torch.equal(out['tiered']['losses'], out['hbm']['losses']), \
        f'tiered epoch {epoch + 1} != the all-device epoch'
    assert all(torch.equal(x, y) for x, y in zip(
        tiered.model.parameters(), hbm.model.parameters())), epoch
    assert out['tiered']['stats'] == out['hbm']['stats']
    tiered_rep[epoch] = {k: v['ms'] / steps for k, v in out.items()}
  timings = tiered.chunk_timings()
  plan = tiered.last_plan.stats()
  rep['tiered'] = dict(
      hot_prefix_rows=tstore.hot_prefix_rows, n_max=tstore.n_max,
      spill_s=spill_s, tier_bytes=tstore.tier_bytes(), plan=plan,
      prologue_ms=tiered.prologue_ms, slab_bytes=tiered.slab_bytes,
      ring_bytes=tiered._stager.ring_bytes,
      ms_per_step={e: r for e, r in tiered_rep.items()},
      chunks=[{k: r[k] for k in ('chunk', 'rows', 'cap', 'stage_ms',
                                 'wait_ms', 'copy_ms', 'device_ms')}
              for r in timings])
  log(f'dist_scan tiered: hot prefix {tstore.hot_prefix_rows} of '
      f'{tstore.n_max} rows a partition ({DSCAN_HOT_SHARE}%), spilled in '
      f'{spill_s:.1f} s; two captured epochs bit-equal to the all-device '
      f'epochs (losses, parameters, counters); epoch 2 '
      f'{tiered_rep[1]["tiered"]:.2f} ms/step against '
      f'{tiered_rep[1]["hbm"]:.2f}; prologue {tiered.prologue_ms:.0f} ms; '
      f'plan {plan}; per chunk (rows, stage ms, wait ms, copy ms, device '
      f'ms): ' + '; '.join(
          f'{r["rows"]} {r["stage_ms"] or 0:.0f} {r["wait_ms"] or 0:.0f} '
          f'{r["copy_ms"] or 0:.1f} {r["device_ms"] or 0:.0f}'
          for r in timings) + f' on {smi}')
  tiered.close()
  dscan_release(torch, cuda, tiered, hbm)
  del tiered, hbm, tst, tds, tstore
  shutil.rmtree(spill, ignore_errors=True)

  # ---- 5. the sharded serving store: the feature table served through
  # DistEmbeddingStore behind the engine, held against the table
  from graphlearn_tpu_torch.serving import DistEmbeddingStore, ServingEngine
  estore = DistEmbeddingStore.build(feats, store.mesh, split_ratio=DIST_CACHE,
                                    hotness=hot, bucket_frac=None)
  rng = np.random.default_rng(21)
  ops.reset_launch_counts()
  engine = ServingEngine(estore, buckets=(256, 1024), max_wait_ms=1.0)
  lookups, served = 0, 0
  with engine:
    for size in (1, 37, 256, 1000, 1024) * 4:
      ids = rng.integers(0, n, size)
      got = engine.lookup(ids)
      assert np.array_equal(got, feats[ids]), 'DistEmbeddingStore rows'
      lookups += 1
      served += size
  scounts = ops.launch_counts()
  t0 = time.perf_counter()
  ids = rng.integers(0, n, 1024)
  rows_ms = timed(torch, lambda: estore.lookup(ids, np.ones(1024, bool)),
                  REPS if cuda else 2, device)[1]
  rep['dist_store'] = dict(lookups=lookups, ids=served,
                           gather_rows=scounts['gather_rows'],
                           stats=estore.publish_stats(),
                           lookup_ms_1024=rows_ms)
  log(f'dist_scan serving: DistEmbeddingStore over {nparts} shards, '
      f'{lookups} engine lookups ({served} ids) equal to the table; K1 '
      f'{scounts["gather_rows"]} launches; one 1,024-id lookup '
      f'{rows_ms:.3f} ms (device, queued) on {smi}')
  rep['launch_runs'].append(scounts)
  del estore, engine

  # ---- 6. failover: rank DSCAN_DEAD_RANK dies at a boundary; the rest
  # of the epoch re-sliced over P - 1 shards on the same card
  class Liveness:
    calls = 0

    def dead_ranks(self):
      # poll 0 is the epoch's start, poll c + 1 chunk c's boundary
      self.calls += 1
      return ({DSCAN_DEAD_RANK: 'probe timeout'}
              if self.calls > DSCAN_DEAD_CHUNK + 1 else {})

  model = model_on(device)
  first_t = trainer(model=model, shuffle=True)
  consumed = {}

  def rebuild(remaining, survivors):
    t0 = time.perf_counter()
    pb2 = dist_book(n, survivors, seed=1)
    p2, f2 = ex.partition_in_memory(ei, feats, pb2, survivors)
    ds2 = dataset(survivors, p2, f2, pb2)
    consumed['rebuild_s'] = time.perf_counter() - t0
    consumed['remaining'] = remaining
    consumed['trainer'] = gtt.loader.DistScanTrainer(
        loader(seeds=remaining, data=ds2, drop_last=False), model, CLASSES,
        chunk_size=chunk)
    return consumed['trainer']
  seed_mat, mask_mat = first_t._seed_fn(
      first_t._seeds_dev if first_t._seeds_dev is not None else
      torch.as_tensor(pool.astype(np.int32)).to(device),
      gtt.random.fold_in(first_t._perm_key, 0), steps)
  runner = FailoverRunner(first_t, rebuild, liveness=Liveness())
  t0 = time.perf_counter()
  _, flosses, _, report = runner.run_epoch(create_train_state(model, lr=LR))
  fo_s = time.perf_counter() - t0
  (fo,) = report['failovers']
  seg0, seg1 = report['segments']
  assert fo['rank'] == DSCAN_DEAD_RANK and fo['survivors'] == nparts - 1
  assert fo['rolled_back_chunk'] == DSCAN_DEAD_CHUNK
  done = seed_mat.transpose(0, 1)[:seg0['steps']]
  done = done[mask_mat.transpose(0, 1)[:seg0['steps']]].cpu().numpy()
  rem = consumed['remaining']
  trained = np.concatenate([done, rem])
  assert trained.shape[0] == pool.shape[0] and np.array_equal(
      np.sort(trained), np.sort(pool)), 'a seed trained twice or never'
  assert seg0['steps'] * nparts * b + rem.shape[0] == pool.shape[0]
  assert seg1['steps'] == -(-rem.shape[0] // ((nparts - 1) * b))
  assert np.isfinite(flosses).all() and flosses.shape[0] == \
      seg0['steps'] + seg1['steps']
  rep['failover'] = dict(report=report, seconds=fo_s,
                         rebuild_s=consumed['rebuild_s'],
                         seeds=int(trained.shape[0]))
  log(f'dist_scan failover: rank {DSCAN_DEAD_RANK} dead at chunk '
      f'{fo["detected_chunk"]}, rolled back to chunk '
      f'{fo["rolled_back_chunk"]}; {seg0["steps"]} steps on {nparts} shards '
      f'+ {seg1["steps"]} on {nparts - 1} (re-partitioned in '
      f'{consumed["rebuild_s"]:.1f} s): {trained.shape[0]} seeds, each '
      f'trained once; {fo_s:.1f} s on {smi}')
  rep['failover']['after_release'] = dscan_release(
      torch, cuda, first_t, consumed.pop('trainer'))
  del first_t, runner, ds, store
  rep['launches'] = {k: sum(c[k] for c in rep['launch_runs'])
                     for k in rep['launch_runs'][0]}
  rep['phase_s'] = time.perf_counter() - t_phase
  log(f'dist_scan phase {rep["phase_s"]:.1f} s (build {build_s:.1f} s) on '
      f'{smi}')
  return rep


# ---- the rest of the distributed core: link, subgraph, typed, 2-axis
DMORE_BATCHES = 2                    # timed link / typed batches a mode
DMORE_STEPS = 3                      # data-parallel link / typed steps
DMORE_SCAN_STEPS = 8                 # the typed scanned epoch's steps
DMORE_SCAN_CHUNK = 4                 # ... in chunks of K
DMORE_MESH = (2, 2)                  # the 2-axis layout of the P shards


def negative_local_case(torch, gtt, garr, sorted_loc, num_dst, num, device,
                        reps):
  """The negative kernel's shard-local entry (one launch: the owned-row
  count, the draw and the CSR test of ``num * NEG_TRIALS`` candidates of
  shard 0) against its plain version on the same device key, exact, and
  the whole of ``random_negative_sample_local`` (the kernel and the
  partition) against its plain version. No PyTorch call computes the
  function: library_ms null."""
  from graphlearn_tpu_torch import ops
  rid, ptr, srt = garr['row_ids'][0], garr['indptr'][0], sorted_loc[0]
  total = num * NEG_TRIALS
  key = gtt.random.to_device(gtt.random.fold_in(gtt.random.PRNGKey(4), num),
                             device)
  before = ops.launch_counts()['negative_sample_local']
  got = ops.random_negative_sample_local(rid, ptr, srt, num_dst, num, key,
                                         strict=True)
  per_call = ops.launch_counts()['negative_sample_local'] - before
  want = ops.random_negative_sample_local_plain(rid, ptr, srt, num_dst, num,
                                                key, strict=True)
  cand, ms, call_ms = timed(torch, lambda: ops.negative.local_candidates(
      rid, ptr, srt, num_dst, total, key), reps, device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: ops.negative.local_candidates_plain(
          rid, ptr, srt, num_dst, total, key), reps, device)
  _, full_ms, _ = timed(torch, lambda: ops.random_negative_sample_local(
      rid, ptr, srt, num_dst, num, key, strict=True), reps, device)
  _, full_plain_ms, _ = timed(
      torch, lambda: ops.random_negative_sample_local_plain(
          rid, ptr, srt, num_dst, num, key, strict=True), reps, device)
  exact = all(bool(torch.equal(a, b)) for a, b in zip(cand + got,
                                                       ref + want))
  err = max(float((a.long() - b.long()).abs().max()) for a, b in
            zip(cand + got, ref + want))
  # the search rounds of this data: each drawn row's degree's bit length,
  # and every block's search of the owned count
  ptr_h = ptr.cpu().numpy().astype(np.int64)
  rows = cand[0].cpu().numpy().astype(np.int64)
  deg = (ptr_h[rows + 1] - ptr_h[rows]).astype(np.float64)
  rounds = int(np.where(deg > 0, np.floor(np.log2(np.maximum(deg, 1))) + 1,
                        0).sum())
  owned = int(cand[3])
  # the count's steps run in one warp a block (32 lanes a step)
  blocks = min(-(-total // 256), 132 * 16)
  count_rounds = blocks * 32 * count_search_steps(rid.shape[0], owned)
  nbytes = 16 + 4 + total * (2 * 4 + 4 + 9) + (rounds + count_rounds) * 4
  ops_n = instructions({'negative_sample_local.candidate': total,
                        'negative_sample_local.round': rounds,
                        'negative_sample_local.count_round': count_rounds})
  rec = dict(num_samples=num, candidates=total, owned_rows=owned,
             span=num_dst, exact=exact, max_abs_err=err,
             valid=int(got[2].sum()), launches_per_call=per_call, ms=ms,
             call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
             full_ms=full_ms, full_plain_ms=full_plain_ms, library_ms=None,
             search_rounds=rounds, count_rounds=count_rounds,
             **bound_record(nbytes, ops_n, fill_ms(torch, cand, device, reps),
                            ms))
  log(f'kernel negative_sample_local {total} candidates of shard 0 '
      f'({owned} owned rows, span {num_dst}): exact={exact} strict-valid='
      f'{rec["valid"]} launches/call={per_call} ms={ms:.4f} (call '
      f'{call_ms:.4f}) plain_ms={plain_ms:.4f} (call {plain_call_ms:.4f}) '
      f'{bound_text(rec)}, {rounds} search rounds; with the '
      f'partition ms={full_ms:.4f} plain_ms={full_plain_ms:.4f}; library_ms '
      'null')
  assert exact, 'negative_sample_local: kernel != plain version'
  assert per_call == (1 if device.type == 'cuda' else 0), per_call
  return rec


def count_search_steps(n: int, owned: int) -> int:
  """Steps of the loop of the local negative kernel's 32-ary count
  search (``csrc/negative_sample.cu``) over ``n`` row ids of which the
  first ``owned`` are not padding."""
  lo, hi, steps = 0, n, 0
  while hi - lo > 32:
    step = -(-(hi - lo) // 32)
    below = min(32, max(owned - lo, 0) // step)
    lo, hi = lo + below * step, min(hi, lo + (below + 1) * step - 1)
    steps += 1
  return steps


def dmore_counted(torch, cuda, fn, n):
  """``n`` calls of ``fn`` with the launch counters set to 0 before and
  read after: ``(results, device ms each, host ms each, counts)``."""
  from graphlearn_tpu_torch import ops
  if cuda:
    torch.cuda.synchronize()
  ops.reset_launch_counts()
  out, ms, wall = [], [], []
  for _ in range(n):
    t0 = time.perf_counter()
    a = _event(torch, cuda)
    out.append(fn())
    b = _event(torch, cuda)
    if cuda:
      b.synchronize()
    wall.append((time.perf_counter() - t0) * 1e3)
    ms.append(_span(a, b, cuda))
  return out, ms, wall, ops.launch_counts()


def dmore_profile(torch, fn, device, label):
  """One call of ``fn`` under torch.profiler (after one in its warm-up
  cycle, the counters set to 0 between): idle share, busy ms, the five
  largest device ops; its kernels equal to the counters."""
  from graphlearn_tpu_torch import ops
  prof = profiled(torch, fn, 1, device, label,
                  warmup=lambda: (fn(), ops.reset_launch_counts()),
                  expect=port_launch_counts)
  counted = port_launch_counts()
  assert prof['kernels'] == counted, (label, prof['kernels'], counted)
  return dict(idle_share=prof['idle_share'], busy_ms=prof['device_busy_ms'],
              wall_ms=prof['wall_ms'], device_ops=prof['device_ops_per_call'],
              top5=dict(list(prof['top_device_ms'].items())[:5]),
              kernels=counted)


def dmore_link_check(torch, host, loader, idx, mask, count, batch, feats_t,
                     mode):
  """One card link batch against the CPU sampler's on the same seed
  edges and keys: every shard's ids, edges, masks, counts and the link
  metadata exact, ``x`` the feature rows of its ids."""
  from graphlearn_tpu_torch.sampler import EdgeSamplerInput
  out = host.sample_from_edges(
      EdgeSamplerInput(loader.seed_rows[idx], loader.seed_cols[idx],
                       neg_sampling=loader.neg_sampling),
      seed_mask=mask, keys=loader.sampler._keys_for(count))
  for f, got in (('node', batch.node), ('num_nodes', batch.num_nodes),
                 ('row', batch.edge_index[:, 0]),
                 ('col', batch.edge_index[:, 1]),
                 ('edge_mask', batch.edge_mask),
                 ('num_sampled_nodes', batch.num_sampled_nodes),
                 ('num_sampled_edges', batch.num_sampled_edges)):
    assert torch.equal(got.cpu(), getattr(out, f)), f'link {mode} {f}'
  for k in ('edge_label_index', 'edge_label', 'src_index', 'dst_pos_index',
            'dst_neg_index', 'seed_mask', 'overflow'):
    if k in out.metadata:
      assert torch.equal(batch.metadata[k].cpu(), out.metadata[k]), \
          f'link {mode} {k}'
  valid = batch.node >= 0
  want = torch.where(valid[..., None], feats_t[batch.node.clamp(min=0).long()],
                     0)
  assert torch.equal(batch.x, want), f'link {mode} features'
  return int(valid.sum())


def dmore_link(torch, gtt, dg, cpu_dg, store, topo, feats_t, device, smi,
               rep):
  """Link: ``DistLinkNeighborLoader`` batches (binary and triplet, tree,
  full-width exchanges, ``neg_strict``) at the link phase's width, each
  timed batch exact against the CPU sampler; every valid binary negative
  a non-edge of the graph; the local negative kernel once per shard a
  batch; no host sync in a batch; then DIST_STEPS data-parallel link
  steps of the example (``dist_sage_unsup``), the last recomputed on the
  CPU."""
  import copy

  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.examples import dist_sage_unsup as ex
  from graphlearn_tpu_torch.sampler import NegativeSampling
  cuda = device.type == 'cuda'
  per = 1 if cuda else 0
  mesh = store.mesh
  nparts = mesh.num_partitions
  b = LINK_BATCH if cuda else 32
  hops = len(LINK_FANOUTS)
  src = np.repeat(np.arange(topo.num_nodes), np.diff(topo.indptr))
  pick = np.random.default_rng(31).choice(
      topo.num_edges, nparts * b * (DMORE_BATCHES + 4 + DMORE_STEPS),
      replace=False)
  pool = np.stack([src[pick], topo.indices[pick]])
  ds = gdist.DistDataset(nparts, 0, dg, store)
  cpu_mesh = gdist.ShardMesh(nparts, 'cpu')
  out = {}
  for mode in ('binary', 'triplet'):
    loader = gdist.DistLinkNeighborLoader(
        ds, LINK_FANOUTS, pool, batch_size=b, seed=0, mesh=mesh,
        neg_sampling=NegativeSampling(mode, 1), dedup='tree',
        bucket_frac=None, neg_strict=True)
    host = gdist.DistNeighborSampler(cpu_dg, LINK_FANOUTS, cpu_mesh, seed=0,
                                     dedup='tree', bucket_frac=None,
                                     neg_strict=True)
    blocks = list(loader._index_blocks())
    it = iter(loader)
    next(it)                                       # the first use
    gdist.reset_verdict_syncs()
    batches, ms, wall, counts = dmore_counted(torch, cuda, lambda: next(it),
                                              DMORE_BATCHES)
    want = dict(negative_sample_local=per * nparts * DMORE_BATCHES,
                sample_hop=per * nparts * hops * DMORE_BATCHES,
                gather_rows=per * 2 * nparts * DMORE_BATCHES,
                negative_sample=0, sample_level=0)
    for k, v in want.items():
      assert counts[k] == v, (mode, k, counts)
    assert gdist.verdict_syncs() == 0
    t0 = time.perf_counter()
    seen = 0
    for j, batch in enumerate(batches):
      idx, mask = blocks[1 + j]
      seen += dmore_link_check(torch, host, loader, idx, mask, 2 + j, batch,
                               feats_t, mode)
    check_s = time.perf_counter() - t0
    neg_pairs = pos_pairs = 0
    if mode == 'binary':
      for batch in batches:
        node = batch.node.cpu()
        eli = batch.metadata['edge_label_index'].cpu().long()
        ok = (eli >= 0).all(1)                     # [L, 2b] valid pairs
        u = node.gather(1, eli[:, 0].clamp(min=0))
        v = node.gather(1, eli[:, 1].clamp(min=0))
        neg = ok[:, b:]
        is_edge = link_pairs_in_graph(topo, u[:, b:][neg].numpy(),
                                      v[:, b:][neg].numpy())
        assert not is_edge.any(), f'{int(is_edge.sum())} negatives are edges'
        neg_pairs += int(neg.sum())
        pos = link_pairs_in_graph(topo, u[:, :b].reshape(-1).numpy(),
                                  v[:, :b].reshape(-1).numpy())
        assert pos.all(), 'a positive is not an edge'
        pos_pairs += pos.shape[0]
    syncs = kinds = prof = None
    if cuda:
      _, syncs, kinds = count_syncs(torch, lambda: next(it))
      assert syncs == 0, (mode, kinds)
      prof = dmore_profile(torch, Batches(loader, it), device,
                           f'dist link {mode} batch')
      assert prof['kernels']['negative_sample_local'] == nparts, prof
    out[mode] = dict(ms=ms, wall_ms=wall, launches=counts, checked_slots=seen,
                     cpu_check_s=check_s, valid_negatives=neg_pairs,
                     positives=pos_pairs, host_syncs=syncs, sync_kinds=kinds,
                     profile=prof)
    rep['launch_runs'].append(counts)
    log(f'dist_more link {mode}: P={nparts} x {b} positives {LINK_FANOUTS}: '
        + ' '.join(f'{m:.2f}' for m in ms) + ' ms a stacked batch (host '
        + ' '.join(f'{w:.1f}' for w in wall) + ' ms); launches a batch: '
        f'negative_sample_local {counts["negative_sample_local"] / DMORE_BATCHES:.0f}'
        f' (want {nparts * per}), K3 {counts["sample_hop"] / DMORE_BATCHES:.0f}'
        f' (want {nparts * hops * per}), K1 '
        f'{counts["gather_rows"] / DMORE_BATCHES:.0f} (want {2 * nparts * per})'
        f'; host syncs {syncs}; exact against the CPU ({seen} slots, '
        f'{check_s:.1f} s)' + (f'; {neg_pairs} valid negatives, none an '
                               f'edge, {pos_pairs} positives all edges'
                               if mode == 'binary' else '') + (
            f'; idle {prof["idle_share"]:.1%} of a batch, top 5 (ms): ' +
            '; '.join(f'{k[:40]}={v:.3f}' for k, v in prof['top5'].items())
            if prof else '') + f' on {smi}')
    if mode == 'binary':
      rep['kernel'] = negative_local_case(
          torch, gtt, loader.sampler._dev, loader.sampler._sorted_loc_dev(),
          dg.num_nodes, b, device, REPS if cuda else 2)
  # the example's data-parallel link steps
  loader = gdist.DistLinkNeighborLoader(
      ds, LINK_FANOUTS, pool, batch_size=b, shuffle=True, seed=2, mesh=mesh,
      neg_sampling=NegativeSampling('binary', 1), bucket_frac=None,
      neg_strict=True)

  def model_on(d):
    m = gtt.models.GraphSAGE(FEAT_DIM, LINK_HIDDEN, LINK_HIDDEN,
                             num_layers=hops, device=d,
                             generator=torch.Generator().manual_seed(0))
    m.relu_hooks_by_call = True     # P shard forwards a step
    return m
  model = model_on(device)
  state = gtt.models.create_train_state(model, lr=LR)
  step = ex.make_step(model, mesh)
  it = iter(loader)
  losses, step_ms, check = [], [], None
  for s in range(DMORE_STEPS):
    batch = next(it)
    last = s + 1 == DMORE_STEPS
    pre, hooks = {}, []
    if last:
      check = (copy.deepcopy(model.state_dict()),
               copy.deepcopy(state.optimizer.state_dict()),
               to_cpu(torch, ex.fields(batch)))
      hooks = relu_input_hooks(model, recorder(pre))
    a = _event(torch, cuda)
    state, loss, _ = step(state, batch)
    bev = _event(torch, cuda)
    if cuda:
      bev.synchronize()
    step_ms.append(_span(a, bev, cuda))
    losses.append(float(loss))
    for h in hooks:
      h.remove()
  assert all(np.isfinite(losses)), losses
  check += ([p.grad.detach().cpu() for p in model.parameters()],
            {k: z.cpu() for k, z in pre.items()})

  def make_step(m):
    from graphlearn_tpu_torch.loader.pipeline import (data_parallel_step,
                                                      shard_batches)
    loss_fn = ex.loss_fn_for(m)

    def st(s, d):
      loss, acc = data_parallel_step(s.optimizer, loss_fn, shard_batches(d),
                                     cpu_mesh)
      return s, loss, acc
    return st, None
  c = cpu_step_check(torch, gtt, None, model, check, losses[-1],
                     cpu_model=lambda: model_on(torch.device('cpu')),
                     make_step=make_step)
  out['train'] = dict(step_ms=step_ms, losses=losses, cpu_check={
      k: c[k] for k in ('pre_diff', 'opposite', 'grad_share', 'adam_diff',
                        'cpu_loss')})
  log(f'dist_more link train: {DMORE_STEPS} data-parallel steps of the '
      f'example (GraphSAGE {FEAT_DIM}-{LINK_HIDDEN}-{LINK_HIDDEN}, BCE on '
      f'binary link batches): ' + ' '.join(f'{m:.2f}' for m in step_ms) +
      ' ms, losses ' + ' '.join(f'{v:.4f}' for v in losses) + '; the last '
      f'recomputed on the CPU (gradients within {c["grad_share"]:.3g} of the '
      f'largest, Adam {c["adam_diff"]:.3g}) on {smi}')
  return out


def dmore_subgraph(torch, gtt, dg, cpu_dg, store, feats_t, device, smi, rep):
  """One ``DistSubGraphLoader`` batch (SUB_BATCH seeds a shard, edge ids,
  the graph's max degree read once on the host) exact against the CPU
  sampler's, ``x`` the feature rows, with the bytes the one-card mesh
  holds for the gathered sets' extraction."""
  from graphlearn_tpu_torch import distributed as gdist
  cuda = device.type == 'cuda'
  mesh = store.mesh
  nparts = mesh.num_partitions
  b = SUB_BATCH if cuda else 32
  ds = gdist.DistDataset(nparts, 0, dg, store)
  pool = np.random.default_rng(33).permutation(dg.num_nodes)[:nparts * b * 2]
  loader = gdist.DistSubGraphLoader(ds, None, pool, batch_size=b, seed=0,
                                    mesh=mesh, with_edge=True,
                                    bucket_frac=None)
  max_deg = loader.sampler._global_max_degree()
  # the [P, P, b * max_degree] extraction: rows, cols (int32), mask,
  # epos and edge ids (int64)
  reckoned = nparts * nparts * b * max_deg * (4 + 4 + 1 + 8 + 8)
  host = gdist.DistNeighborSampler(cpu_dg, None, gdist.ShardMesh(nparts, 'cpu'),
                                   seed=0, with_edge=True)
  idx, mask = next(loader._index_blocks())
  (batch,), ms, wall, counts = dmore_counted(
      torch, cuda, lambda: next(iter(loader)), 1)
  t0 = time.perf_counter()
  want = host.subgraph(loader.input_seeds[idx], seed_mask=mask)
  for f, got in (('node', batch.node), ('num_nodes', batch.num_nodes),
                 ('row', batch.edge_index[:, 0]),
                 ('col', batch.edge_index[:, 1]),
                 ('edge_mask', batch.edge_mask), ('edge', batch.edge_ids)):
    assert torch.equal(got.cpu(), getattr(want, f)), f'subgraph {f}'
  assert torch.equal(batch.metadata['mapping'].cpu(),
                     want.metadata['mapping']), 'subgraph mapping'
  valid = batch.node >= 0
  assert torch.equal(batch.x, torch.where(
      valid[..., None], feats_t[batch.node.clamp(min=0).long()], 0))
  check_s = time.perf_counter() - t0
  edges = int(batch.edge_mask.sum())
  rep['launch_runs'].append(counts)
  log(f'dist_more subgraph: P={nparts} x {b} seeds, max degree {max_deg} '
      f'(read once on the host): {ms[0]:.2f} ms (host {wall[0]:.1f} ms), '
      f'{edges} induced edges; extraction buffers {reckoned / 2 ** 20:.0f} '
      f'MiB reckoned; K1 {counts["gather_rows"]}; exact against the CPU '
      f'({check_s:.1f} s) on {smi}')
  return dict(ms=ms[0], wall_ms=wall[0], launches=counts, max_degree=max_deg,
              reckoned_bytes=reckoned, edges=edges, cpu_check_s=check_s)


def dmore_typed_check(torch, host, loader, block, count, batch, cpu_ds,
                      what):
  """A typed card batch against the CPU sampler's at the same stream
  position (a typed batch takes the stream's next keys): every shard's
  ids, counts, edges and masks exact, ``x`` each type's feature rows and
  ``y`` the seed type's labels (zeros at empty slots). Returns the
  checked node slots."""
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  idx, mask = block
  host._call_count = count - 1
  want = host.sample_from_nodes(NodeSamplerInput(loader.input_seeds[idx],
                                                 loader.input_type),
                                seed_mask=mask)
  assert sorted(batch.node) == sorted(want.node), what
  assert sorted(batch.edge_index) == sorted(want.row), what
  for t in want.node:
    for f in ('node', 'num_nodes', 'num_sampled_nodes'):
      assert torch.equal(getattr(batch, f)[t].cpu(), getattr(want, f)[t]), \
          (what, f, t)
  for et in want.row:
    ei = batch.edge_index[et].cpu()
    for f, got in (('row', ei[:, 0]), ('col', ei[:, 1]),
                   ('edge_mask', batch.edge_mask[et].cpu()),
                   ('num_sampled_edges',
                    batch.num_sampled_edges[et].cpu())):
      assert torch.equal(got, getattr(want, f)[et]), (what, f, et)
  assert torch.equal(batch.metadata['overflow'].cpu(),
                     want.metadata['overflow']), (what, 'overflow')
  seen = 0
  for t, x in batch.x.items():
    node = batch.node[t].cpu()
    valid = node >= 0
    rows = cpu_ds.node_features[t].cpu_get(
        node.clamp(min=0).reshape(-1).numpy()).reshape(*node.shape, -1)
    assert torch.equal(x.cpu(), torch.where(valid[..., None], rows, 0)), \
        (what, 'x', t)
    seen += int(valid.sum())
  node = batch.node['paper'][:, :batch.y['paper'].shape[1]].cpu()
  lab = torch.as_tensor(np.asarray(cpu_ds.node_labels['paper']))
  want_y = torch.where(node >= 0, lab[node.clamp(min=0).long()], 0)
  assert torch.equal(batch.y['paper'].cpu(), want_y.to(batch.y['paper'].dtype)
                     ), (what, 'y')
  return seen


def dmore_typed(torch, gtt, device, smi, rep):
  """Typed: the IGBH example's graph (HET_PAPER papers, HET_AUTHOR
  authors) cut into P shards by ``% P`` (the JAX example's rule), a store
  per type with a DIST_CACHE cache, full-width exchanges; tree and
  calibrated merge batches (the hetero phase's fanouts, HET_BATCH seeds a
  shard) exact against the CPU's; rsage and 4-head rgat data-parallel
  steps, the last recomputed on the CPU; a captured typed
  ``DistScanTrainer`` tree epoch (the example's tree-dense rsage) against
  the eager one and the per-step loop, no host sync in a captured epoch;
  a typed tiered epoch (DSCAN_HOT_SHARE% of each type's rows on the
  card) bit-equal to the all-device one."""
  import copy
  import shutil

  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.examples import dist_train_rgnn as dex
  from graphlearn_tpu_torch.examples import train_rgnn as ex
  cuda = device.type == 'cuda'
  per = 1 if cuda else 0
  nparts = DIST_PARTS
  n_paper, n_author, b, _, _ = hetero_sizes(cuda)
  t0 = time.perf_counter()
  kw = dict(split_ratio=DIST_CACHE, bucket_frac=None)
  mesh = gdist.ShardMesh(nparts, device)
  cpu_mesh = gdist.ShardMesh(nparts, 'cpu')
  ds, _ = dex.build_dataset(n_paper, n_author, mesh,
                            np.random.default_rng(0), **kw)
  cds, _ = dex.build_dataset(n_paper, n_author, cpu_mesh,
                             np.random.default_rng(0), **kw)
  local = hetero_data(torch, gtt, ex, n_paper, n_author)[0](
      torch.device('cpu'))
  steps = DMORE_SCAN_STEPS if cuda else 4
  chunk = DMORE_SCAN_CHUNK if cuda else 2
  pool = np.arange(nparts * b * max(steps, DMORE_BATCHES + 4))
  caps = gtt.sampler.estimate_hetero_frontier_caps(
      local.graph, ex.FANOUTS, {'paper': b}, input_nodes={'paper': pool})
  del local
  setup_s = time.perf_counter() - t0
  out = dict(setup_s=setup_s, caps={str(k): v for k, v in caps.items()})
  feat_types = 2
  k1 = nparts * (2 * feat_types + 1)     # the caches, the rows, the labels
  for kind in ('tree', 'merge'):
    lkw = (dict(dedup='tree') if kind == 'tree' else
           dict(dedup='merge', frontier_caps=caps, overflow_policy='raise'))
    loader = gdist.DistNeighborLoader(ds, ex.FANOUTS, ('paper', pool),
                                      batch_size=b, seed=0, mesh=mesh,
                                      bucket_frac=None, **lkw)
    host = gdist.DistNeighborSampler(
        cds.graph, ex.FANOUTS, cpu_mesh, seed=0, bucket_frac=None,
        **{k: v for k, v in lkw.items() if k != 'overflow_policy'})
    items = sum(len(h) for h in loader.sampler._hetero_plan({'paper': b})[1])
    blocks = list(loader._index_blocks())
    it = iter(loader)
    next(it)
    batches, ms, wall, counts = dmore_counted(torch, cuda, lambda: next(it),
                                              DMORE_BATCHES)
    assert counts['sample_hop'] == per * nparts * items * DMORE_BATCHES, \
        (kind, counts)
    assert counts['gather_rows'] == per * k1 * DMORE_BATCHES, (kind, counts)
    t1 = time.perf_counter()
    seen = sum(dmore_typed_check(torch, host, loader, blocks[1 + j], 2 + j,
                                 batch, cds, f'dist typed {kind} {j}')
               for j, batch in enumerate(batches))
    check_s = time.perf_counter() - t1
    syncs = prof = None
    if cuda:
      _, syncs, kinds = count_syncs(torch, lambda: next(it))
      assert syncs == 0, (kind, kinds)
      more = Batches(loader, it)
      prof = dmore_profile(torch, more, device, f'dist typed {kind} batch')
      it = more.it
    for _ in it:
      pass                                  # the overflow guard's check
    out[kind] = dict(ms=ms, wall_ms=wall, launches=counts, items=items,
                     checked_slots=seen, cpu_check_s=check_s,
                     host_syncs=syncs, profile=prof)
    rep['launch_runs'].append(counts)
    log(f'dist_more typed {kind}: P={nparts} x {b} papers: ' +
        ' '.join(f'{m:.2f}' for m in ms) + ' ms a stacked batch (host ' +
        ' '.join(f'{w:.1f}' for w in wall) + ' ms); K3 '
        f'{counts["sample_hop"] / DMORE_BATCHES:.0f} (want '
        f'{per * nparts * items}), K1 {counts["gather_rows"] / DMORE_BATCHES:.0f}'
        f' (want {per * k1}); host syncs {syncs}; exact against the CPU '
        f'({seen} slots, {check_s:.1f} s)' + (
            f'; idle {prof["idle_share"]:.1%}, top 5 (ms): ' +
            '; '.join(f'{k[:40]}={v:.3f}' for k, v in prof['top5'].items())
            if prof else '') + f' on {smi}')

  def loader_tree(data, seeds=pool, shuffle=True):
    return gdist.DistNeighborLoader(data, ex.FANOUTS, ('paper', seeds),
                                    batch_size=b, shuffle=shuffle, seed=1,
                                    mesh=data.node_features['paper'].mesh,
                                    dedup='tree', bucket_frac=None)

  def model_on(d, conv='sage'):
    return dex.build_model(b, HET_HIDDEN, d, torch.Generator().manual_seed(0),
                           conv=conv, heads=4 if conv == 'gat' else 1,
                           fanouts=ex.FANOUTS)
  # ---- rsage and 4-head rgat data-parallel steps
  for conv in ('sage', 'gat'):
    model = model_on(device, conv)
    state = gtt.models.create_train_state(model, lr=LR)
    step = dex.make_step(model, mesh)
    it = iter(loader_tree(ds))
    losses, step_ms, check = [], [], None
    for s in range(DMORE_STEPS):
      batch = next(it)
      pre, hooks = {}, []
      if s + 1 == DMORE_STEPS:
        check = (copy.deepcopy(model.state_dict()),
                 copy.deepcopy(state.optimizer.state_dict()),
                 to_cpu(torch, dex.fields(batch)))
        hooks = relu_input_hooks(model, recorder(pre))
      a = _event(torch, cuda)
      state, loss, _ = step(state, batch)
      bev = _event(torch, cuda)
      if cuda:
        bev.synchronize()
      step_ms.append(_span(a, bev, cuda))
      losses.append(float(loss))
      for h in hooks:
        h.remove()
    assert all(np.isfinite(losses)), losses
    check += ([None if p.grad is None else p.grad.detach().cpu()
               for p in model.parameters()],
              {k: z.cpu() for k, z in pre.items()})

    def make_step(m):
      from graphlearn_tpu_torch.loader.pipeline import (data_parallel_step,
                                                        shard_batches)
      from graphlearn_tpu_torch.models.train import make_loss_fn
      loss_fn = make_loss_fn(m, ex.NUM_CLASSES)

      def st(s, d):
        loss, acc = data_parallel_step(s.optimizer, loss_fn,
                                       shard_batches(d), cpu_mesh)
        return s, loss, acc
      return st, None
    c = cpu_step_check(torch, gtt, None, model, check, losses[-1],
                       cpu_model=lambda conv=conv: model_on(
                           torch.device('cpu'), conv),
                       make_step=make_step)
    name = 'rgat' if conv == 'gat' else 'rsage'
    out[f'train_{name}'] = dict(step_ms=step_ms, losses=losses, cpu_check={
        k: c[k] for k in ('pre_diff', 'opposite', 'leaky_opposite',
                          'grad_share', 'adam_diff', 'cpu_loss')})
    log(f'dist_more typed train {name}: {DMORE_STEPS} data-parallel steps '
        f'(hidden {HET_HIDDEN}): ' + ' '.join(f'{m:.2f}' for m in step_ms) +
        ' ms, losses ' + ' '.join(f'{v:.4f}' for v in losses) + '; the last '
        f'recomputed on the CPU (gradients within {c["grad_share"]:.3g} of '
        f'the largest, Adam {c["adam_diff"]:.3g}, leaky_relu inputs on '
        f'opposite sides {c["leaky_opposite"]}) on {smi}')
    del model, state, step, it
  # ---- the captured typed DistScanTrainer
  scan_pool = np.arange(nparts * b * steps)
  n_keys = loader.sampler._hetero_key_count()
  items = out['tree']['items']
  chunks = -(-steps // chunk)
  want_launch = dict(sample_hop=per * nparts * items * steps,
                     gather_rows=per * k1 * steps,
                     dist_step_keys=per * chunks)
  # the scanned and tiered epochs train the example's tree-dense rsage
  # (dense k-runs, no atomics: captured, eager, loop and tiered epochs
  # can agree bit for bit)
  def dense_on(d):
    return ex.build_model('rsage', b, HET_HIDDEN, d, mode='tree_dense',
                          generator=torch.Generator().manual_seed(0))
  start = dense_on(device).state_dict()

  def trainer(capture=None, data=ds, cls=None):
    m = dense_on(device)
    m.load_state_dict(start)
    cls = cls or gtt.loader.DistScanTrainer
    return cls(loader_tree(data, scan_pool, shuffle=False), m,
               ex.NUM_CLASSES, chunk_size=chunk, capture=capture)
  cap, eag = trainer(), trainer(capture=False)
  loop = gtt.loader.DistFusedEpochTrainer(loader_tree(ds, scan_pool, False),
                                          dense_on(device), ex.NUM_CLASSES)
  loop.model.load_state_dict(start)
  assert cap.capture == cuda and cap._n_hops == n_keys
  runs = {}
  for name, t in (('captured', cap), ('eager', eag)):
    st = gtt.models.create_train_state(t.model, lr=LR)
    for epoch in range(2):
      st, losses, _, ms, counts = dscan_epoch(torch, t, st, cuda)
      for k, v in want_launch.items():
        assert counts[k] == v, (name, k, counts)
      rep['launch_runs'].append(counts)
      runs.setdefault(name, []).append((losses, ms / steps))
    runs[name + '_state'] = st
  lst = gtt.models.create_train_state(loop.model, lr=LR)
  lst, l1 = loop.run_epoch_steps(lst)
  a = _event(torch, cuda)
  lst, l2 = loop.run_epoch_steps(lst)
  bev = _event(torch, cuda)
  if cuda:
    bev.synchronize()
  runs['loop'] = [(torch.stack(l1), None),
                  (torch.stack(l2), _span(a, bev, cuda) / steps)]
  equal = {}
  for name in ('eager', 'loop'):
    for e in range(2):
      torch.testing.assert_close(runs['captured'][e][0], runs[name][e][0],
                                 rtol=1e-4, atol=0)
    equal[name] = all(bool(torch.equal(runs['captured'][e][0],
                                       runs[name][e][0])) for e in range(2))
  syncs = cprof = None
  if cuda:
    def cap_epoch():
      runs['captured_state'] = cap.run_epoch(runs['captured_state'])[0]
    # the epoch-end publish (one read a featured type's store) apart
    published = let_publish_through(torch, cap.loader)
    _, syncs, kinds = count_syncs(torch, cap_epoch)
    del cap.loader._publish_feature_stats
    assert syncs == 0 and len(published) == 1, (kinds, published)
    cprof = dmore_profile(torch, cap_epoch, device,
                          'dist_more typed captured epoch')
  ms_step = {k: runs[k][1][1] for k in ('captured', 'eager', 'loop')}
  out['scan'] = dict(steps=steps, chunk=chunk, keys_per_shard=n_keys,
                     ms_per_step=ms_step, losses_bit_equal=equal,
                     host_syncs_per_step=(syncs / steps if cuda else None),
                     capture_ms=cap.capture_ms, profile=cprof,
                     losses=runs['captured'][1][0].tolist())
  log(f'dist_more typed scan: {steps} steps of P={nparts} x {b} papers in '
      f'chunks of {chunk}, {n_keys} keys a shard a step: captured '
      f'{ms_step["captured"]:.2f} ms/step, eager {ms_step["eager"]:.2f}, '
      f'the per-step loop {ms_step["loop"]:.2f}; losses within rtol 1e-4 '
      f'(bit-equal {equal}); host syncs a captured epoch {syncs}' + (
          f'; idle {cprof["idle_share"]:.1%}, top 5 (ms): ' +
          '; '.join(f'{k[:40]}={v:.3f}' for k, v in cprof['top5'].items())
          if cprof else '') + f' on {smi}')
  dscan_release(torch, cuda, cap, eag, loop)
  del cap, eag, loop, runs
  # ---- the typed tiered epoch against the all-device one
  spill = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                       'dist_more_spill')
  shutil.rmtree(spill, ignore_errors=True)
  stores = {}
  for t, store in ds.node_features.items():
    ids = [store.feat_ids[p][store.feat_ids[p] != np.iinfo(np.int32).max]
           for p in range(nparts)]
    blocks = [(i, store.cpu_get(i).numpy()) for i in ids]
    stores[t] = gtt.storage.TieredDistFeature(
        nparts, blocks, store.feature_pb, mesh=mesh,
        spill_dir=os.path.join(spill, t),
        hot_prefix_rows=-(-store.n_max * DSCAN_HOT_SHARE // 100), **kw)
  tds = gdist.DistDataset(nparts, 0, ds.graph, stores,
                          node_labels=ds.node_labels)
  tiered = trainer(data=tds, cls=gtt.storage.TieredDistScanTrainer)
  hbm = trainer()
  tres = {}
  for name, t in (('tiered', tiered), ('hbm', hbm)):
    st = gtt.models.create_train_state(t.model, lr=LR)
    for s in t._stores().values():
      s.reset_stats()
    with Published(t._stores()) as got:
      st, losses, _, ms, counts = dscan_epoch(torch, t, st, cuda)
    want = dict(want_launch)
    if name == 'tiered':    # the prologue's id-only replay
      want['sample_hop'] *= 2
      want['dist_step_keys'] += per
    for k, v in want.items():
      assert counts[k] == v, (name, k, counts)
    rep['launch_runs'].append(counts)
    tres[name] = dict(losses=losses, ms=ms / steps, stats=got)
  assert torch.equal(tres['tiered']['losses'], tres['hbm']['losses']), \
      'typed tiered epoch != the all-device epoch'
  assert all(torch.equal(x, y) for x, y in zip(tiered.model.parameters(),
                                               hbm.model.parameters()))
  assert tres['tiered']['stats'] == tres['hbm']['stats']
  plans = {t: p.stats() for t, p in tiered.last_plan.items()}
  out['tiered'] = dict(ms_per_step={k: v['ms'] for k, v in tres.items()},
                       plans=plans, prologue_ms=tiered.prologue_ms,
                       slab_bytes=tiered.slab_bytes,
                       hot_prefix_rows={t: s.hot_prefix_rows
                                        for t, s in stores.items()})
  log(f'dist_more typed tiered: {DSCAN_HOT_SHARE}% of each type\'s rows on '
      f'the card, the rest staged per chunk: an epoch bit-equal to the '
      f'all-device one (losses, parameters, counters); '
      f'{tres["tiered"]["ms"]:.2f} ms/step against {tres["hbm"]["ms"]:.2f}; '
      f'prologue {tiered.prologue_ms:.0f} ms; plans {plans} on {smi}')
  tiered.close()
  dscan_release(torch, cuda, tiered, hbm)
  shutil.rmtree(spill, ignore_errors=True)
  return out


def dmore_hier(torch, gtt, dg, fparts, pb, hot, feats_t, device, smi, rep):
  """The 2-axis mesh: the dist phase's P shards laid out as DMORE_MESH
  (slice, chip); one tree batch at FANOUTS of BATCH seeds a shard through
  the hierarchical exchanges (fractional stage 2, ``bucket_frac`` 2.0)
  and its features, exact against the CPU's on the same layout and keys,
  with the counted verdict reads."""
  from graphlearn_tpu_torch import distributed as gdist
  cuda = device.type == 'cuda'
  nparts = DIST_PARTS
  b = BATCH if cuda else 64
  mesh = gdist.ShardMesh(nparts, device, shape=DMORE_MESH)
  cmesh = gdist.ShardMesh(nparts, 'cpu', shape=DMORE_MESH)
  sampler = gdist.DistNeighborSampler(dg, FANOUTS, mesh, seed=4, dedup='tree')
  host = gdist.DistNeighborSampler(dg, FANOUTS, cmesh, seed=4, dedup='tree')
  store = gdist.DistFeature(nparts, fparts, pb, mesh, split_ratio=DIST_CACHE,
                            hotness=hot)
  seeds = np.random.default_rng(41).permutation(pb.shape[0])[:nparts * b]
  seeds = seeds.reshape(nparts, b)
  keys = sampler._next_keys()
  sampler.sample_from_nodes(seeds, keys=keys)        # the first use
  gdist.reset_verdict_syncs()

  def batch():
    o = sampler.sample_from_nodes(seeds, keys=keys)
    return o, store.get(o.node)
  ((got, x),), ms, wall, counts = dmore_counted(torch, cuda, batch, 1)
  verdicts = gdist.verdict_syncs()
  t0 = time.perf_counter()
  want = host.sample_from_nodes(seeds, keys=keys)
  for f in ('node', 'num_nodes', 'row', 'col', 'edge_mask',
            'num_sampled_nodes', 'num_sampled_edges'):
    assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), \
        f'2-axis {f}'
  valid = got.node >= 0
  assert torch.equal(x, torch.where(valid[..., None],
                                    feats_t[got.node.clamp(min=0).long()], 0))
  check_s = time.perf_counter() - t0
  rep['launch_runs'].append(counts)
  log(f'dist_more 2-axis {DMORE_MESH}: one tree batch of P={nparts} x {b} '
      f'seeds {FANOUTS} and its features through the hierarchical exchanges: '
      f'{ms[0]:.2f} ms (host {wall[0]:.1f} ms); K3 {counts["sample_hop"]}, '
      f'K1 {counts["gather_rows"]}; verdict reads {verdicts}; exact against '
      f'the CPU\'s ({check_s:.1f} s) on {smi}')
  return dict(shape=DMORE_MESH, ms=ms[0], wall_ms=wall[0], launches=counts,
              verdict_syncs=verdicts, cpu_check_s=check_s)


def dist_more_phase(torch, gtt, ei, feats, topo, device, smi, built=None):
  """The rest of the distributed core on the card, over the dist phase's
  P = DIST_PARTS shards of the script's graph and the IGBH example's
  typed graph: link batches and link steps, a subgraph batch, the typed
  engine's batches, steps, captured and tiered epochs, and a 2-axis
  batch (``dmore_link``, ``dmore_subgraph``, ``dmore_typed``,
  ``dmore_hier``). Every launch run's counters go into ``launch_runs``."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
  cuda = device.type == 'cuda'
  t_phase = time.perf_counter()
  n = feats.shape[0]
  nparts = DIST_PARTS
  t0 = time.perf_counter()
  if built:
    parts, fparts, pb, hot = (built[k] for k in ('parts', 'fparts', 'pb',
                                                 'hot'))
  else:
    pb = dist_book(n, nparts)
    parts, fparts = ex.partition_in_memory(ei, feats, pb, nparts)
    hot = np.bincount(ei[1], minlength=n)
  mesh = gdist.ShardMesh(nparts, device)
  dg = gdist.DistGraph(nparts, 0, parts, pb)
  store = gdist.DistFeature(nparts, fparts, pb, mesh, split_ratio=DIST_CACHE,
                            hotness=hot, bucket_frac=None)
  feats_t = torch.as_tensor(feats).to(device)
  build_s = time.perf_counter() - t0
  rep = dict(parts=nparts, build_s=build_s, launch_runs=[])
  rep['link'] = dmore_link(torch, gtt, dg, dg, store, topo, feats_t, device,
                           smi, rep)
  rep['subgraph'] = dmore_subgraph(torch, gtt, dg, dg, store, feats_t,
                                   device, smi, rep)
  rep['hier'] = dmore_hier(torch, gtt, dg, fparts, pb, hot, feats_t,
                           device, smi, rep)
  del store, feats_t
  if cuda:
    torch.cuda.empty_cache()
  rep['typed'] = dmore_typed(torch, gtt, device, smi, rep)
  rep['launches'] = {k: sum(c[k] for c in rep['launch_runs'])
                     for k in rep['launch_runs'][0]}
  rep['phase_s'] = time.perf_counter() - t_phase
  log(f'dist_more phase {rep["phase_s"]:.1f} s (build {build_s:.1f} s); '
      f'launches {rep["launches"]} on {smi}')
  return rep


# ---- the multiprocess and server-client stack (the remote phase)
REMOTE_STEPS = 4                     # products steps of the mp and remote loops
REMOTE_WORKERS = 2                   # sampling workers of each producer
REMOTE_SERVES = (16, 64, 200, 256)   # ids of the four serve RPCs
REMOTE_TABLE_DIM = 64                # the served table's width
MAG_MP_STEPS = 3                     # HGT steps of the typed mp loop
MAG_MP_PAPERS = 60_000               # train_hgt_mag_mp's defaults
MAG_MP_BATCH = 512
READY_S = 600                        # the server child's start-up budget


def rings_alive(shmids) -> list:
  """The SysV segments among ``shmids`` that still exist (``shmctl``
  IPC_STAT answers). A ring is marked for removal when it is made, so it
  is gone once its last process detached."""
  import ctypes
  libc = ctypes.CDLL(None, use_errno=True)
  buf = ctypes.create_string_buffer(512)   # struct shmid_ds fits
  return [i for i in shmids
          if libc.shmctl(ctypes.c_int(i), ctypes.c_int(2), buf) == 0]


def serve_table(torch, n: int):
  """The served table: [n, REMOTE_TABLE_DIM] float32 from seed 5 (drawn on
  the CPU, so the client rebuilds it)."""
  return torch.randn(n, REMOTE_TABLE_DIM,
                     generator=torch.Generator().manual_seed(5))


def remote_server_main(topo, feats, labels, q, device_name):
  """The server child: the script's dataset on the card, an
  ``init_server`` endpoint, and a serving engine over ``serve_table``
  (routed through gather v2) registered for the ``serve`` RPC; it serves
  until the client calls ``exit``."""
  import traceback

  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.distributed import dist_server
  rings = []

  class RecordedRing(dist_server.ShmChannel):
    """The server's producer rings, their shmids kept for the client's
    check that none outlives the server."""

    def __init__(self, *a, **kw):
      super().__init__(*a, **kw)
      rings.append(self.shmid)

  dist_server.ShmChannel = RecordedRing
  try:
    device = torch.device(device_name)
    ds = gtt.data.Dataset(device=device)
    ds.graph = gtt.data.Graph(topo, device=device)
    ds.init_node_features(feats)
    ds.init_node_labels(labels)
    del feats
    store = gtt.serving.EmbeddingStore(serve_table(torch, topo.num_nodes)
                                       .to(device))
    store.set_kernel_routing(use_pallas_v2=True, block_rows=256,
                             run_span=8)
    engine = gtt.serving.ServingEngine(store, buckets=SERVE_BUCKETS).start()
    host, port = gtt.distributed.init_server(1, 1, 0, ds)
    gtt.distributed.get_server().register_serving_engine(engine)
    q.put(('ready', host, port, (os.getpid(), time.time())))
    gtt.distributed.wait_and_shutdown_server()
    engine.stop()
    q.put(('done', rings, None, None))
  except BaseException:
    q.put(('error', traceback.format_exc(), None, None))
    raise


def remote_blocks(pool, workers, batch):
  """Each worker's seed blocks of a shuffle-off producer over ``pool``:
  the static ``np.array_split`` share in order, ``batch`` at a time."""
  shares = np.array_split(pool, workers)
  return [[s[i:i + batch] for i in range(0, s.shape[0], batch)]
          for s in shares]


def remote_key(blocks, ids):
  for w, bl in enumerate(blocks):
    for j, b in enumerate(bl):
      if b.shape[0] and b[0] == ids[0]:
        return w, j
  raise AssertionError(f'seed {ids[0]} in no worker block')


def remote_cpu_batch(gtt, cpu_ds, worker_seed, call_index, block):
  """The CPU sampler's batch at a worker's seed and call index, with the
  CPU store's features and labels: what the card worker must have
  sent."""
  from graphlearn_tpu_torch.distributed.dist_sampling_producer import \
      _batch_message
  s = gtt.sampler.NeighborSampler(cpu_ds.graph, FANOUTS, device='cpu',
                                  seed=worker_seed)
  s._call_count = call_index
  out = s.sample_from_nodes(gtt.sampler.NodeSamplerInput(block),
                            batch_cap=BATCH)
  x, y = _batch_message(cpu_ds, out, True, False)
  return out, x, y


def remote_check(torch, b, out, x, y, what):
  """A card batch exact against the CPU's: ids, counts, masks, edges,
  features and labels."""
  fields = dict(node=(b.node, out.node),
                edge_index=(b.edge_index, torch.stack([out.row, out.col])),
                edge_mask=(b.edge_mask, out.edge_mask), x=(b.x, x),
                y=(b.y, y), batch=(b.batch, out.batch))
  for name, (got, want) in fields.items():
    if not torch.equal(got.cpu(), want.cpu()):
      raise AssertionError(f'{what}: {name} differs from the CPU sampler')
  if b.num_nodes != int(out.num_nodes):
    raise AssertionError(f'{what}: num_nodes differs from the CPU sampler')
  return True


def wait_workers(snap_fn, workers, what, timeout=120):
  """A producer's merged worker snapshot once all ``workers`` published
  it (at their epoch's end)."""
  deadline = time.monotonic() + timeout
  while time.monotonic() < deadline:
    snap = snap_fn()
    if snap is not None and snap.get('workers') == list(range(workers)):
      return snap
    time.sleep(0.05)
  raise AssertionError(f'{what}: the workers\' metric snapshots never '
                       'arrived')


def hist_mean(snap, name):
  h = snap['histograms'].get(name)
  return h['sum'] / h['count'] if h and h['count'] else None


def stage_means(snap) -> dict:
  """Per-batch means (ms) of the workers' stages, and the message
  bytes."""
  return dict(sample_gather_ms=hist_mean(snap, 'producer.sample_gather_ms'),
              d2h_ms=hist_mean(snap, 'producer.d2h_ms'),
              ring_write_ms=hist_mean(snap, 'producer.send_ms'),
              worker_batch_ms=hist_mean(snap, 'producer.sample_ms'),
              message_bytes=snap['gauges'].get('producer.message_bytes'))


def expect_launches(counts, want, what):
  for k, v in want.items():
    if counts[k] != v:
      raise AssertionError(f'{what}: {k} launched {counts[k]} times, '
                           f'expected {v} ({counts})')


class StageTimer:
  """Host-clock totals of wrapped calls (the consumer's ring read, its
  uploads, the client's fetch RPCs): synchronised after each call on a
  card, so a device copy is inside its own stage."""

  def __init__(self, torch, cuda):
    self.sync = torch.cuda.synchronize if cuda else (lambda: None)
    self.ms, self.calls = {}, {}
    self._lock = threading.Lock()

  def wrap(self, name, fn, sync=False):
    def timed_fn(*a, **kw):
      t0 = time.perf_counter()
      out = fn(*a, **kw)
      if sync:
        self.sync()
      dt = (time.perf_counter() - t0) * 1e3
      with self._lock:
        self.ms[name] = self.ms.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + 1
      return out
    return timed_fn

  def mean(self, name):
    return self.ms[name] / self.calls[name] if self.calls.get(name) else None


def remote_train_loop(torch, gtt, loader, model, steps, device, timer, smi,
                      label, profile_steps=0):
  """``steps`` products steps over ``loader`` (one epoch of exactly that
  many batches): ms a step split into the wait for the batch and the
  train step; ``profile_steps`` of them under torch.profiler."""
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  state = train.create_train_state(model, lr=LR)
  train_step, _ = train.make_train_step(model, CLASSES)
  it = iter(loader)
  batches, losses, wait_ms, train_ms = [], [], [], []

  def step():
    t0 = time.perf_counter()
    b = next(it)
    t1 = time.perf_counter()
    nonlocal state
    state, loss, _ = train_step(state, train.batch_to_dict(b))
    sync()
    t2 = time.perf_counter()
    batches.append(b)
    losses.append(loss)
    wait_ms.append((t1 - t0) * 1e3)
    train_ms.append((t2 - t1) * 1e3)

  for _ in range(steps - profile_steps):
    step()
  prof = (profiled(torch, step, profile_steps, device, label)
          if profile_steps else None)
  for _ in it:
    raise AssertionError(f'{label}: the epoch has more than {steps} '
                         'batches')
  losses = [float(v) for v in losses]
  if not all(np.isfinite(losses)):
    raise AssertionError(f'{label}: non-finite loss {losses}')
  log(f'{label}: {steps} steps, losses {[round(v, 4) for v in losses]}, '
      f'ms/step wait {np.median(wait_ms):.1f} train '
      f'{np.median(train_ms):.1f} on {smi}')
  return batches, dict(losses=losses, wait_ms=wait_ms, train_ms=train_ms,
                       profile=prof)


def remote_mp(torch, gtt, ds, cpu_ds, device, smi, rep):
  """``MpDistNeighborLoader`` with two card workers over the script's
  graph at the products width, and four products steps."""
  from graphlearn_tpu_torch.channel import serialize_message
  from graphlearn_tpu_torch.distributed import message
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  n = ds.graph.num_nodes
  pool = np.random.default_rng(11).permutation(n)[:BATCH * REMOTE_STEPS]
  blocks = remote_blocks(pool, REMOTE_WORKERS, BATCH)
  # the ring holds two messages: their size from the CPU's batch of the
  # first block (the padded shapes do not depend on the ids)
  t0 = time.perf_counter()
  ref = {(0, 0): remote_cpu_batch(gtt, cpu_ds, 0, 0, blocks[0][0]),
         (1, 0): remote_cpu_batch(gtt, cpu_ds, 1, 0, blocks[1][0])}
  cpu_s = time.perf_counter() - t0
  msg_bytes = len(serialize_message(message.output_to_message(
      *ref[(0, 0)])))
  channel_size = 2 * msg_bytes + (1 << 20)
  log(f'remote mp: message {msg_bytes / 2**20:.1f} MiB, ring '
      f'{channel_size / 2**20:.1f} MiB; CPU reference batches '
      f'{cpu_s:.1f} s')
  no, eo = train.merge_hop_offsets(BATCH, FANOUTS)
  model = gtt.models.GraphSAGE(
      FEAT_DIM, HIDDEN, CLASSES, num_layers=len(FANOUTS),
      hop_node_offsets=no, hop_edge_offsets=eo, merge_dense=True,
      fanouts=FANOUTS, device=device,
      generator=torch.Generator().manual_seed(3))
  timer = StageTimer(torch, cuda)
  t0 = time.perf_counter()
  loader = gtt.distributed.MpDistNeighborLoader(
      ds, FANOUTS, pool, batch_size=BATCH, num_workers=REMOTE_WORKERS,
      channel_size=channel_size, seed=0)
  pids = [p.pid for p in loader.producer._procs]
  rep['rings'].append(loader.channel.shmid)
  try:
    spawn_s = time.perf_counter() - t0
    loader.channel.recv = timer.wrap('ring_read', loader.channel.recv)
    real_m2d = message.message_to_data
    message.message_to_data = timer.wrap('upload', real_m2d, sync=True)
    try:
      batches, loop = remote_train_loop(
          torch, gtt, loader, model, REMOTE_STEPS, device, timer, smi,
          'remote mp')
    finally:
      message.message_to_data = real_m2d
    snap = wait_workers(loader.worker_metrics, REMOTE_WORKERS, 'remote mp')
  finally:
    loader.shutdown()
  checked = {}
  for b in batches:
    key = remote_key(blocks, b.batch.cpu().numpy()[:b.batch_size])
    if key in ref:
      checked[key] = remote_check(torch, b, *ref[key], f'remote mp {key}')
  if len(checked) != len(ref):
    raise AssertionError(f'remote mp: checked {sorted(checked)} of '
                         f'{sorted(ref)}')
  counts = snap['launches']
  rep['launch_runs'].append(counts)
  if cuda:
    expect_launches(counts, dict(
        sample_level=level_launch_count('merge', REMOTE_STEPS),
        gather_rows=REMOTE_STEPS, sample_hop=0), 'remote mp workers')
  stages = stage_means(snap)
  stages.update(ring_read_ms=timer.mean('ring_read'),
                upload_ms=timer.mean('upload'),
                train_ms=float(np.median(loop['train_ms'])),
                wait_ms=float(np.median(loop['wait_ms'])))
  log(f'remote mp: ms a batch ' + ' '.join(
      f'{k}={v:.2f}' for k, v in stages.items()
      if k != 'message_bytes' and v is not None) +
      f' message_bytes={stages["message_bytes"]:.0f}; workers\' launches '
      f'{counts}; spawn {spawn_s:.1f} s; exact batches {sorted(checked)} '
      f'on {smi}')
  return dict(stages=stages, launches=counts, checked=sorted(checked),
              channel_size=channel_size, spawn_s=spawn_s, worker_pids=pids,
              losses=loop['losses'])


def remote_typed(torch, gtt, device, smi, rep):
  """``train_hgt_mag_mp``'s configuration at its defaults: two card
  workers run the typed engine (K3 per plan item, K1 per featured type),
  three HGT steps (merge-dense), the first batch of each worker exact
  against the CPU."""
  from graphlearn_tpu_torch.channel import serialize_message
  from graphlearn_tpu_torch.distributed import message
  from graphlearn_tpu_torch.distributed.dist_sampling_producer import \
      _batch_message
  from graphlearn_tpu_torch.examples import train_hgt_mag as mag
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  n_paper = MAG_MP_PAPERS if cuda else 6_000
  b = MAG_MP_BATCH if cuda else 64
  t0 = time.perf_counter()
  ds = mag.build_dataset(n_paper, device)
  cpu_ds = mag.build_dataset(n_paper, torch.device('cpu'))
  build_s = time.perf_counter() - t0
  # the example's train seeds, cut to one epoch of MAG_MP_STEPS + 1
  # batches (the last is drawn, not trained on)
  n_tr = int(n_paper * 0.2)
  pool = np.arange(n_tr)[:b * (MAG_MP_STEPS + 1)]
  shares = np.array_split(pool, REMOTE_WORKERS)
  rng = np.random.default_rng(0)       # the producer's, seed 0
  orders = [rng.permutation(s.shape[0]) for s in shares]
  firsts = [s[o][:b] for s, o in zip(shares, orders)]
  ref, items = {}, None
  for w, blk in enumerate(firsts):
    s = gtt.sampler.NeighborSampler(cpu_ds.graph, mag.FANOUTS, device='cpu',
                                    seed=w)
    out = s.sample_from_nodes(gtt.sampler.NodeSamplerInput(blk, 'paper'),
                              batch_cap=b)
    items = s._call_count          # one key per (hop, edge type) item
    ref[w] = (out, *_batch_message(cpu_ds, out, True, True))
  msg_bytes = len(serialize_message(message.hetero_output_to_message(
      *ref[0])))
  channel_size = 2 * msg_bytes + (1 << 20)
  model = mag.build_model(b, 64, 4, device, mode='merge_dense',
                          generator=torch.Generator().manual_seed(0))
  state = train.create_train_state(model, lr=3e-3)
  train_step, _ = train.make_train_step(model, mag.NUM_CLASSES)
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  loader = gtt.distributed.MpDistNeighborLoader(
      ds, mag.FANOUTS, ('paper', pool), batch_size=b, shuffle=True,
      drop_last=True, num_workers=REMOTE_WORKERS, seed=0,
      channel_size=channel_size)
  pids = [p.pid for p in loader.producer._procs]
  rep['rings'].append(loader.channel.shmid)
  try:
    got, losses, step_ms = [], [], []
    for batch in loader:
      got.append(batch)
      if len(losses) < MAG_MP_STEPS:
        t1 = time.perf_counter()
        state, loss, _ = train_step(state, train.batch_to_dict(batch))
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    snap = wait_workers(loader.worker_metrics, REMOTE_WORKERS,
                        'remote typed')
  finally:
    loader.shutdown()
  if len(got) != MAG_MP_STEPS + 1 or not all(np.isfinite(losses)):
    raise AssertionError(f'remote typed: {len(got)} batches, losses '
                         f'{losses}')
  checked = []
  for batch in got:
    ids = batch.batch['paper'].cpu().numpy()[:batch.batch_size]
    for w, blk in enumerate(firsts):
      if np.array_equal(ids, blk):
        out, x_d, y_d = ref[w]
        for t, v in out.node.items():
          if not (torch.equal(batch.node[t].cpu(), v) and
                  torch.equal(batch.x[t].cpu(), x_d[t])):
            raise AssertionError(f'remote typed worker {w}: {t} differs')
        for et in out.row:
          if not (torch.equal(batch.edge_index[et].cpu(),
                              torch.stack([out.row[et], out.col[et]])) and
                  torch.equal(batch.edge_mask[et].cpu(), out.edge_mask[et])):
            raise AssertionError(f'remote typed worker {w}: {et} differs')
        if not torch.equal(batch.y['paper'].cpu(), y_d['paper']):
          raise AssertionError(f'remote typed worker {w}: y differs')
        checked.append(w)
  if sorted(checked) != list(range(REMOTE_WORKERS)):
    raise AssertionError(f'remote typed: checked workers {checked}')
  counts = snap['launches']
  rep['launch_runs'].append(counts)
  n_batches = len(got)
  n_types = len(ref[0][1])
  if cuda:
    expect_launches(counts, dict(sample_hop=n_batches * items,
                                 gather_rows=n_batches * n_types,
                                 sample_level=0), 'remote typed workers')
  stages = stage_means(snap)
  stages['train_ms'] = float(np.median(step_ms))
  log(f'remote typed (HGT mp, {n_paper} papers, batch {b}): losses '
      f'{[round(v, 4) for v in losses]}; ms a batch ' + ' '.join(
          f'{k}={v:.2f}' for k, v in stages.items()
          if k != 'message_bytes' and v is not None) +
      f' message_bytes={stages["message_bytes"]:.0f}; {items} plan items; '
      f'workers\' launches {counts}; build {build_s:.1f} s on {smi}')
  return dict(stages=stages, launches=counts, losses=losses,
              plan_items=items, checked=sorted(checked), worker_pids=pids,
              channel_size=channel_size)


def server_spawn(target, *args) -> dict:
  """A server child (``remote_server_main`` or
  ``remote_scan_server_main``) spawned on ``args``, its queue put
  between the dataset and the rest: ``{server, q, t0}`` (t0 the host's
  wall clock at the spawn, which the child's ready message is read
  against)."""
  import multiprocessing as mp
  ctx = mp.get_context('spawn')
  q = ctx.Queue()
  t0 = time.time()
  server = ctx.Process(target=target, args=args[:3] + (q,) + args[3:])
  server.start()
  return dict(server=server, q=q, t0=t0)


def server_ready(started, what):
  """``(host, port, start-up s)`` once the server child is ready."""
  kind, host, port, spid = started['q'].get(timeout=READY_S)
  if kind != 'ready':
    raise RuntimeError(f'{what} server failed to start:\n{host}')
  return host, port, spid[1] - started['t0']


def remote_server_client(torch, gtt, topo, feats, labels, cpu_ds, device,
                         smi, rep, started):
  """A ``DistServer`` in a child process (``started``: ``server_spawn``
  of ``remote_server_main`` at the phase's start, so its start-up runs
  beside the mp loaders) holds the script's dataset on the card (two
  workers a producer); this process is the client over loopback:
  ``RemoteDistNeighborLoader`` for four products steps (the workers'
  batches exact against the CPU at the server-folded seeds), then four
  ``serve`` RPCs against the registered engine (gather v2)."""
  import pickle

  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.distributed import message
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  n = topo.num_nodes
  server, q = started['server'], started['q']
  out = dict(server_pid=server.pid)
  try:
    host, port, out['server_start_s'] = server_ready(started, 'remote')
    gdist.init_client(1, 1, 0, [(host, port)])
    seed = 1            # folded: (1 * 7919 + 0) * 1000003 + rank > 2**32
    pool = np.random.default_rng(12).permutation(n)[:BATCH * REMOTE_STEPS]
    blocks = remote_blocks(pool, REMOTE_WORKERS, BATCH)
    wseed = [(seed * 7919 + 0) * 1000003 + w for w in range(REMOTE_WORKERS)]
    ref = {(w, 0): remote_cpu_batch(gtt, cpu_ds, wseed[w], 0, blocks[w][0])
           for w in range(REMOTE_WORKERS)}
    msg = message.output_to_message(*ref[(0, 0)])
    from graphlearn_tpu_torch.channel import serialize_message
    msg_bytes = len(serialize_message(msg))
    frame = pickle.dumps({'ok': True, 'result': (msg, False)}, protocol=5)
    t1 = time.perf_counter()
    pickle.loads(frame)
    out['deserialize_ms'] = (time.perf_counter() - t1) * 1e3
    del frame
    # the wire alone: one message-sized fetch answered by an RpcServer of
    # this process over loopback (pickling, TCP, the frame read and the
    # unpickling), the median of three
    echo = gdist.RpcServer()
    echo.register('fetch', lambda: (msg, False))
    cli = gdist.RpcClient()
    cli.add_target(0, echo.host, echo.port)
    try:
      rtt = []
      for _ in range(3):
        t1 = time.perf_counter()
        cli.request_sync(0, 'fetch', timeout=120)
        rtt.append((time.perf_counter() - t1) * 1e3)
    finally:
      cli.close()
      echo.shutdown()
    out['loopback_rpc_ms'] = float(np.median(rtt))
    del msg
    opts = gdist.RemoteDistSamplingWorkerOptions(
        server_rank=0, num_workers=REMOTE_WORKERS, prefetch_size=2,
        buffer_size=2 * msg_bytes + (1 << 20))
    timer = StageTimer(torch, cuda)
    no, eo = train.merge_hop_offsets(BATCH, FANOUTS)
    model = gtt.models.GraphSAGE(
        FEAT_DIM, HIDDEN, CLASSES, num_layers=len(FANOUTS),
        hop_node_offsets=no, hop_edge_offsets=eo, merge_dense=True,
        fanouts=FANOUTS, device=device,
        generator=torch.Generator().manual_seed(4))
    loader = gdist.RemoteDistNeighborLoader(
        FANOUTS, pool, batch_size=BATCH, worker_options=opts, seed=seed,
        device=device)
    try:
      loader.channel._request_fn = timer.wrap('fetch_rpc',
                                              loader.channel._request_fn)
      real_m2d = message.message_to_data
      message.message_to_data = timer.wrap('upload', real_m2d, sync=True)
      try:
        batches, loop = remote_train_loop(
            torch, gtt, loader, model, REMOTE_STEPS, device, timer, smi,
            'remote server-client', profile_steps=2)
      finally:
        message.message_to_data = real_m2d
      (pid,) = loader.producer_ids
      snap = wait_workers(
          lambda: gdist.request_server(0, 'get_metrics', idempotent=True)
          ['producers'].get(pid), REMOTE_WORKERS, 'remote server-client')
    finally:
      loader.shutdown()
    checked = {}
    for b in batches:
      key = remote_key(blocks, b.batch.cpu().numpy()[:b.batch_size])
      if key in ref:
        checked[key] = remote_check(torch, b, *ref[key],
                                    f'remote server-client {key}')
    if len(checked) != len(ref):
      raise AssertionError(f'remote server-client: checked '
                           f'{sorted(checked)} of {sorted(ref)}')
    counts = snap['launches']
    rep['launch_runs'].append(counts)
    if cuda:
      expect_launches(counts, dict(
          sample_level=level_launch_count('merge', REMOTE_STEPS),
          gather_rows=REMOTE_STEPS, sample_hop=0),
          'remote server workers')
    # the serve RPCs: the server's counters read before and after
    table = serve_table(torch, n)
    before = gdist.request_server(0, 'get_metrics',
                                  idempotent=True)['server']['launches']
    rng = np.random.default_rng(13)
    serve_ms = []
    for k in REMOTE_SERVES:
      ids = rng.integers(0, n, k)
      t1 = time.perf_counter()
      rows = gdist.request_server(0, 'serve', ids, idempotent=True)
      serve_ms.append((time.perf_counter() - t1) * 1e3)
      if not np.array_equal(rows, table[ids].numpy()):
        raise AssertionError(f'serve of {k} ids: rows differ from the '
                             'table')
    srv = gdist.request_server(0, 'get_metrics', idempotent=True)['server']
    serve_counts = {k: srv['launches'][k] - before[k] for k in before}
    rep['launch_runs'].append(serve_counts)
    if cuda:
      expect_launches(serve_counts, dict(gather_runs=len(REMOTE_SERVES),
                                         gather_rows=0), 'serve RPCs')
    stages = stage_means(snap)
    stages.update(
        # the server's fetch: its ring read, the wait for the worker's
        # message included
        server_fetch_ms=hist_mean(srv, 'server.fetch_ms'),
        # the client's fetch round trips (two in flight)
        fetch_rpc_ms=timer.mean('fetch_rpc'),
        wire_ms=out['loopback_rpc_ms'] - out['deserialize_ms'],
        deserialize_ms=out['deserialize_ms'],
        upload_ms=timer.mean('upload'),
        train_ms=float(np.median(loop['train_ms'])),
        wait_ms=float(np.median(loop['wait_ms'])))
    gdist.shutdown_client()
    kind, server_rings, _, _ = q.get(timeout=120)
    server.join(timeout=120)
    rep['rings'] += list(server_rings or ())
    if kind != 'done' or server.exitcode != 0:
      raise AssertionError(f'remote server ended {kind}, exit '
                           f'{server.exitcode}')
    prof = loop['profile']
    log(f'remote server-client: ms a batch ' + ' '.join(
        f'{k}={v:.2f}' for k, v in stages.items()
        if k != 'message_bytes' and v is not None) +
        f' message_bytes={stages["message_bytes"]:.0f}; workers\' launches '
        f'{counts}; serve launches {serve_counts}, serve ms '
        f'{[round(v, 2) for v in serve_ms]}; client idle share '
        f'{prof["idle_share"] if prof else None}; exact batches '
        f'{sorted(checked)} on {smi}')
    out.update(stages=stages, launches=counts, serve_launches=serve_counts,
               serve_ms=serve_ms, checked=sorted(checked),
               losses=loop['losses'], profile=prof,
               top5_device_ms=(dict(sorted(
                   prof['top_device_ms'].items(),
                   key=lambda kv: -kv[1])[:5]) if prof else None))
    return out
  finally:
    if gdist.dist_client.get_client() is not None:
      gdist.dist_client._client.close()
      gdist.dist_client._client = None
    if server.is_alive():
      server.terminate()
      server.join(30)


def remote_phase(torch, gtt, ds, cpu_ds, topo, feats, labels, device, smi):
  """The multiprocess and server-client stack on the card: the mp
  loader's products steps, the typed mp loader's HGT steps, and a server
  child's remote loader and serve RPCs. Afterwards no ring and no child
  process is left."""
  import multiprocessing as mp

  from graphlearn_tpu_torch.channel import live_channel_count
  t_phase = time.perf_counter()
  rings = live_channel_count()
  rep = dict(launch_runs=[], rings=[])
  # the server child starts now: its start-up (the import, the dataset
  # on the card) runs while the mp loaders' workers start and run
  started = server_spawn(remote_server_main, topo, feats, labels,
                         str(device))
  try:
    rep['mp'] = remote_mp(torch, gtt, ds, cpu_ds, device, smi, rep)
    rep['typed'] = remote_typed(torch, gtt, device, smi, rep)
  except BaseException:
    started['server'].kill()
    started['server'].join()
    raise
  if device.type == 'cuda':
    torch.cuda.empty_cache()
  rep['server_client'] = remote_server_client(
      torch, gtt, topo, feats, labels, cpu_ds, device, smi, rep, started)
  left = dict(rings_open=live_channel_count() - rings,
              rings_made=len(rep['rings']),
              rings_alive=rings_alive(rep['rings']),
              children=[p.pid for p in mp.active_children()])
  if left['rings_open'] or left['rings_alive'] or left['children'] or \
      left['rings_made'] < 3:
    raise AssertionError(f'remote phase left behind {left}')
  rep['left'] = left
  rep['launches'] = {k: sum(c[k] for c in rep['launch_runs'])
                     for k in rep['launch_runs'][0]}
  rep['phase_s'] = time.perf_counter() - t_phase
  log(f'remote phase {rep["phase_s"]:.1f} s; launches {rep["launches"]}; '
      f'left behind {left} on {smi}')
  return rep


# ---- the chunk-staged remote scan (the remote_scan phase)
RSCAN_STEPS = 5                      # products steps an epoch
RSCAN_CHUNK = 2                      # K: chunks of 2, 2 and a tail of 1
RSCAN_SEED = 1                       # folded: worker seeds past 2**32
RSCAN_TYPED_BATCHES = 4              # the typed epoch's batches, at K
IPC_WARNING = 'shared CUDA tensors released'


def remote_scan_server_main(topo, feats, labels, q, device_name, err_path):
  """``remote_server_main`` with this child's stderr in ``err_path``, so
  the client reads whether torch reported unreleased CUDA IPC handles
  at its exit."""
  fd = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
  os.dup2(fd, 2)
  os.close(fd)
  remote_server_main(topo, feats, labels, q, device_name)


def rscan_model(torch, gtt, device, b):
  """The remote phase's products model: merge-dense GraphSAGE over the
  uncalibrated merge layout, hidden HIDDEN, weights from seed 4."""
  from graphlearn_tpu_torch.models import train
  no, eo = train.merge_hop_offsets(b, FANOUTS)
  return gtt.models.GraphSAGE(
      FEAT_DIM, HIDDEN, CLASSES, num_layers=len(FANOUTS),
      hop_node_offsets=no, hop_edge_offsets=eo, merge_dense=True,
      fanouts=FANOUTS, device=device,
      generator=torch.Generator().manual_seed(4))


def rscan_tensors(trainer, state):
  """The tensors a chunk updates in place: the parameters and Adam's."""
  import torch
  ps = list(trainer.model.parameters())
  return ps + [v for p in ps for v in state.optimizer.state[p].values()
               if torch.is_tensor(v)]


def rscan_cpu_batch(gtt, cpu_ds, worker_seed, call_index, block):
  """:func:`remote_cpu_batch` at the block's own batch width."""
  from graphlearn_tpu_torch.distributed.dist_sampling_producer import \
      _batch_message
  s = gtt.sampler.NeighborSampler(cpu_ds.graph, FANOUTS, device='cpu',
                                  seed=worker_seed)
  s._call_count = call_index
  out = s.sample_from_nodes(gtt.sampler.NodeSamplerInput(block),
                            batch_cap=block.shape[0])
  return (out, *_batch_message(cpu_ds, out, True, False))


def rscan_frame_check(torch, frame, j, out, x, y, what):
  """Step ``j`` of a homogeneous block frame exact against a batch (the
  CPU sampler's ``out`` with its ``x`` and ``y``)."""
  fields = dict(node=(frame['node'][j], out.node),
                row=(frame['row'][j], out.row), col=(frame['col'][j], out.col),
                edge_mask=(frame['edge_mask'][j], out.edge_mask),
                x=(frame['x'][j], x), y=(frame['y'][j], y.to(torch.int32)),
                batch=(frame['batch'][j], out.batch))
  for name, (got, want) in fields.items():
    if not torch.equal(torch.from_numpy(np.ascontiguousarray(got)),
                       want.cpu()):
      raise AssertionError(f'{what}: {name} of step {j} differs')
  if int(frame['num_nodes'][j]) != int(out.num_nodes) or \
      int(frame['num_sampled_nodes'][j][0]) != \
      int(out.num_sampled_nodes[0]):
    raise AssertionError(f'{what}: counts of step {j} differ')


def rscan_epoch(torch, gdist, trainer, state, cuda, what, want,
                syncs=False):
  """One ``run_epoch``, the server's launch counters read before and
  after: ``(state, losses, accs, ms, server launches, host syncs)``, the
  launches held to ``want``; with ``syncs`` the epoch runs under
  :func:`count_syncs` (else its count is None)."""
  before = gdist.request_server(0, 'get_metrics',
                                idempotent=True)['server']['launches']
  if cuda:
    torch.cuda.synchronize()
  a = _event(torch, cuda)
  n_syncs = None
  if syncs and cuda:
    (state, losses, accs), n_syncs, kinds = count_syncs(
        torch, lambda: trainer.run_epoch(state))
    if n_syncs:
      log(f'{what}: host syncs {kinds}')
  else:
    state, losses, accs = trainer.run_epoch(state)
  b = _event(torch, cuda)
  if cuda:
    b.synchronize()
  after = gdist.request_server(0, 'get_metrics',
                               idempotent=True)['server']['launches']
  counts = {k: after[k] - before[k] for k in after}
  if cuda:
    expect_launches(counts, want, what)
  return state, losses, accs, _span(a, b, cuda), counts, n_syncs


def rscan_build_log(gdist, trainer):
  """The server's build log of the trainer's block stream."""
  (st,) = trainer._streams
  return gdist.request_server(st['rank'], 'block_build_log', st['pid'],
                              idempotent=True)


def rscan_typed(torch, gtt, device, smi, rep):
  """``train_hgt_mag_mp``'s defaults cut to RSCAN_TYPED_BATCHES batches at
  K = RSCAN_CHUNK: a ``DistServer`` in this process holds the typed
  dataset on the card (K3 per plan item, K1 per featured type a batch),
  a captured typed ``RemoteScanTrainer`` trains HGT (merge-dense) over
  its shuffled block stream; the first block's two batches exact
  against the CPU sampler at the stream's counter."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.distributed.dist_sampling_producer import \
      _batch_message
  from graphlearn_tpu_torch.examples import train_hgt_mag as mag
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import SamplingConfig, SamplingType
  cuda = device.type == 'cuda'
  n_paper = MAG_MP_PAPERS if cuda else 6_000
  b = MAG_MP_BATCH if cuda else 64
  t0 = time.perf_counter()
  ds = mag.build_dataset(n_paper, device)
  cpu_ds = mag.build_dataset(n_paper, torch.device('cpu'))
  pool = np.arange(int(n_paper * 0.2))[:b * RSCAN_TYPED_BATCHES]
  srv = gdist.DistServer(ds)
  names = ('create_block_producer', 'block_producer_num_batches',
           'block_produce', 'block_fetch', 'destroy_block_producer',
           'block_build_log', 'heartbeat', 'get_metrics', 'exit')
  rpc = gdist.RpcServer(handlers={h: getattr(srv, h) for h in names})
  gdist.init_client(1, 1, 0, [(rpc.host, rpc.port)])
  build_s = time.perf_counter() - t0
  try:
    cfg_seed = 0 * 7919 + 0
    cfg = SamplingConfig(SamplingType.NODE, mag.FANOUTS, b, True, True,
                         False, True, False, False, 'out', cfg_seed)
    pid = gdist.request_server(0, 'create_block_producer',
                               gtt.sampler.NodeSamplerInput(pool, 'paper'),
                               cfg, None)
    frame = gdist.request_server(0, 'block_fetch', pid, 0, 0, RSCAN_CHUNK)
    gdist.request_server(0, 'destroy_block_producer', pid)
    order = np.random.default_rng((cfg_seed + 1) * 2654435761).permutation(
        pool.shape[0])
    s = gtt.sampler.NeighborSampler(cpu_ds.graph, mag.FANOUTS, device='cpu',
                                    seed=cfg_seed * 1000003)
    for j in range(RSCAN_CHUNK):
      out = s.sample_from_nodes(gtt.sampler.NodeSamplerInput(
          pool[order[j * b:(j + 1) * b]], 'paper'), batch_cap=b)
      x_d, y_d = _batch_message(cpu_ds, out, True, True)
      for t, v in out.node.items():
        if not (np.array_equal(frame[f'node.{t}'][j], v.numpy()) and
                (t not in x_d or
                 np.array_equal(frame[f'x.{t}'][j], x_d[t].numpy()))):
          raise AssertionError(f'remote_scan typed: {t} of batch {j}')
      for et in out.row:
        k = '__'.join(et)
        if not (np.array_equal(frame[f'row.{k}'][j], out.row[et].numpy())
                and np.array_equal(frame[f'edge_mask.{k}'][j],
                                   out.edge_mask[et].numpy())):
          raise AssertionError(f'remote_scan typed: {et} of batch {j}')
      if not np.array_equal(frame['y.paper'][j],
                            y_d['paper'].numpy().astype(np.int32)):
        raise AssertionError(f'remote_scan typed: y of batch {j}')
    items = s._call_count // RSCAN_CHUNK
    n_types = len(x_d)
    del frame
    model = mag.build_model(b, 64, 4, device, mode='merge_dense',
                            generator=torch.Generator().manual_seed(0))
    trainer = gdist.RemoteScanTrainer(
        mag.FANOUTS, ('paper', pool), model, mag.NUM_CLASSES, batch_size=b,
        chunk_size=RSCAN_CHUNK, shuffle=True, drop_last=True,
        worker_options=gdist.RemoteDistSamplingWorkerOptions(server_rank=0),
        seed=0, device=device)
    try:
      state = train.create_train_state(model, lr=3e-3)
      ops.reset_launch_counts()
      if cuda:
        torch.cuda.synchronize()
      a = _event(torch, cuda)
      state, losses, _ = trainer.run_epoch(state)
      bev = _event(torch, cuda)
      if cuda:
        bev.synchronize()
      counts = ops.launch_counts()
      ms = _span(a, bev, cuda)
      timings = trainer.chunk_timings()
      blog = rscan_build_log(gdist, trainer)
      uploads, capture_ms = trainer.uploads, trainer.capture_ms
    finally:
      trainer.shutdown()
  finally:
    from graphlearn_tpu_torch.distributed import dist_client
    if dist_client._client is not None:
      dist_client._client.close()
      dist_client._client = None
    srv.exit()
    rpc.shutdown()
  losses = losses.tolist()
  if not all(np.isfinite(losses)) or len(losses) != RSCAN_TYPED_BATCHES:
    raise AssertionError(f'remote_scan typed: losses {losses}')
  rep['launch_runs'].append(counts)
  if cuda:
    expect_launches(counts, dict(
        sample_hop=RSCAN_TYPED_BATCHES * items,
        gather_rows=RSCAN_TYPED_BATCHES * n_types, sample_level=0),
        'remote_scan typed server')
  frame_bytes = [r['bytes'] for r in blog]
  log(f'remote_scan typed (HGT, {n_paper} papers, batch {b}, K = '
      f'{RSCAN_CHUNK}): {RSCAN_TYPED_BATCHES} steps in {ms:.1f} ms, losses '
      f'{[round(v, 4) for v in losses]}; frames {frame_bytes} B; build ms '
      f'{[round(r["build_ms"], 1) for r in blog]}; capture ms {capture_ms}; '
      f'{items} plan items; server launches {counts}; first block exact '
      f'on {smi}')
  return dict(ms_per_step=ms / RSCAN_TYPED_BATCHES, losses=losses,
              frame_bytes=frame_bytes, build_log=blog, chunks=timings,
              capture_ms=capture_ms, uploads=uploads, launches=counts,
              plan_items=items, build_s=build_s)


def remote_scan_phase(torch, gtt, topo, feats, labels, cpu_ds, device, smi):
  """The chunk-staged remote scan on the card. A ``DistServer`` child
  holds the script's dataset (the remote phase's ``remote_server_main``),
  this process its client over loopback: block frames of K =
  RSCAN_CHUNK batches at [15, 10, 5] x 1,024 (merge, uncalibrated),
  RSCAN_STEPS products steps an epoch (chunks 2, 2, 1), shuffle off.
  Frames exact (the first block's two batches against the CPU sampler
  and the per-batch remote loader at the same worker seed; a bf16
  frame's features the f32 frame's rounded to nearest even); an eager
  epoch, the last step recomputed on the CPU; a captured epoch from the
  same start taking up the eager trainer's state at each chunk boundary,
  its chunk losses within rtol 1e-4 of the eager ones; a timed captured
  epoch of replays only (one upload and one replay a chunk, 0 host
  syncs); a profiled one; a bf16-wire epoch; the server's launches a
  block batch (K4 10, K1 1). The typed epoch (:func:`rscan_typed`) runs
  first, while the server child starts.
  Afterwards no ring, no child process and no IPC warning."""
  import multiprocessing as mp
  import tempfile

  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.channel import live_channel_count
  from graphlearn_tpu_torch.distributed import block_producer, message
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import SamplingConfig, SamplingType
  cuda = device.type == 'cuda'
  t_phase = time.perf_counter()
  n = topo.num_nodes
  b = BATCH if cuda else 64
  steps, chunk = RSCAN_STEPS, RSCAN_CHUNK
  chunks = -(-steps // chunk)
  rings0 = live_channel_count()
  rep = dict(steps=steps, chunk=chunk, batch=b, launch_runs=[], rings=[])
  err_path = os.path.join(tempfile.mkdtemp(prefix='rscan_'), 'server.err')
  started = server_spawn(remote_scan_server_main, topo, feats, labels,
                         str(device), err_path)
  server, q = started['server'], started['q']
  try:
    # the typed epoch (a server of its own, in this process) runs while
    # the products server child starts
    rep['typed'] = rscan_typed(torch, gtt, device, smi, rep)
    host, port, rep['server_start_s'] = server_ready(started, 'remote_scan')
    gdist.init_client(1, 1, 0, [(host, port)])
    pool = np.random.default_rng(21).permutation(n)[:b * steps]
    cfg_seed = RSCAN_SEED * 7919 + 0
    wseed = cfg_seed * 1000003
    cfg = SamplingConfig(SamplingType.NODE, FANOUTS, b, False, False,
                         False, True, False, False, 'out', cfg_seed)
    # ---- 1. frames: the first block (f32, bf16) fetched directly
    frames, fetch_ms = {}, {}
    for wire in (None, 'bf16'):
      pid = gdist.request_server(0, 'create_block_producer', pool, cfg,
                                 wire, idempotent=True)
      t1 = time.perf_counter()
      frames[wire] = gdist.request_server(0, 'block_fetch', pid, 0, 0,
                                          chunk, idempotent=True)
      fetch_ms[wire] = (time.perf_counter() - t1) * 1e3
      gdist.request_server(0, 'destroy_block_producer', pid)
    f32, f16 = frames[None], frames['bf16']
    ref = [rscan_cpu_batch(gtt, cpu_ds, wseed, j, pool[j * b:(j + 1) * b])
           for j in range(chunk)]
    for j, (out, x, y) in enumerate(ref):
      rscan_frame_check(torch, f32, j, out, x, y, 'remote_scan frame')
    want16 = torch.from_numpy(f32['x']).to(torch.bfloat16).view(torch.int16)
    if not np.array_equal(f16['x'].view(np.int16), want16.numpy()):
      raise AssertionError('remote_scan: the bf16 frame\'s x is not the f32 '
                           'frame rounded to nearest even')
    for k in f32:
      if k != 'x' and not np.array_equal(f32[k], f16[k]):
        raise AssertionError(f'remote_scan: the bf16 frame\'s {k} differs')
    nbytes = {w: block_producer._frame_nbytes(f) for w, f in frames.items()}
    msg = message.output_to_message(*ref[0])
    msg_bytes = sum(a.nbytes for a in msg.values())
    rep['frames'] = dict(
        bytes_f32=nbytes[None], bytes_bf16=nbytes['bf16'],
        message_bytes=msg_bytes, fetch_ms=fetch_ms,
        mb_per_chunk=block_producer.block_mb_per_chunk(
            chunk, f32['x'].shape[1], f32['row'].shape[1], FEAT_DIM),
        mb_per_chunk_bf16=block_producer.block_mb_per_chunk(
            chunk, f32['x'].shape[1], f32['row'].shape[1], FEAT_DIM, 'bf16'))
    # the per-batch remote path at the same worker seed: its first two
    # messages equal the frame's steps
    from graphlearn_tpu_torch.channel import serialize_message
    opts = gdist.RemoteDistSamplingWorkerOptions(
        server_rank=0, num_workers=1, prefetch_size=1,
        buffer_size=2 * len(serialize_message(msg)) + (1 << 20))
    del msg
    loader = gdist.RemoteDistNeighborLoader(
        FANOUTS, pool, batch_size=b, worker_options=opts, seed=RSCAN_SEED,
        device=device)
    try:
      it = iter(loader)
      for j in range(chunk):
        bt = next(it)
        rscan_frame_check(torch, f32, j, gtt.sampler.SamplerOutput(
            node=bt.node.cpu(), row=bt.edge_index[0].cpu(),
            col=bt.edge_index[1].cpu(), edge_mask=bt.edge_mask.cpu(),
            batch=bt.batch.cpu(), num_nodes=bt.num_nodes,
            num_sampled_nodes=bt.num_sampled_nodes), bt.x.cpu(), bt.y.cpu(),
            'remote_scan frame vs the per-batch path')
      del bt, it
    finally:
      loader.shutdown()
    del frames, f32, f16, want16
    log(f'remote_scan frames: {nbytes[None]} B f32 / {nbytes["bf16"]} B '
        f'bf16 a block of {chunk} (block_mb_per_chunk '
        f'{rep["frames"]["mb_per_chunk"]:.1f} / '
        f'{rep["frames"]["mb_per_chunk_bf16"]:.1f} MB; a message '
        f'{msg_bytes} B); fetch ms {fetch_ms}; steps 0-1 exact against the '
        f'CPU sampler and the per-batch remote path on {smi}')

    # ---- 2. eager, then captured from the same start
    want = dict(sample_level=level_launch_count('merge', steps),
                gather_rows=steps, sample_hop=0)

    def trainer(capture, wire=None):
      m = rscan_model(torch, gtt, device, b)
      m.load_state_dict(start)
      return gdist.RemoteScanTrainer(
          FANOUTS, pool, m, CLASSES, batch_size=b, chunk_size=chunk,
          worker_options=gdist.RemoteDistSamplingWorkerOptions(
              server_rank=0, block_wire_dtype=wire),
          seed=RSCAN_SEED, device=device, capture=capture)

    start = rscan_model(torch, gtt, device, b).state_dict()
    eag = trainer(False)
    boundary = {}
    eag_state = train.create_train_state(eag.model, lr=LR)

    def keep_boundary(c, s, k):
      boundary[c] = [t.detach().clone()
                     for t in rscan_tensors(eag, eag_state)]
    eag.stage_hook = keep_boundary
    # the eager epoch's last step, recorded for the CPU recompute
    last, calls, inner = {}, [0], eag._train_step

    def recorded_step(state, batch):
      calls[0] += 1
      if calls[0] != steps:
        return inner(state, batch)
      import copy
      pre = {}
      last['check'] = (copy.deepcopy(eag.model.state_dict()),
                       copy.deepcopy(state.optimizer.state_dict()),
                       {k: v.cpu() for k, v in batch.items()})
      hooks = relu_input_hooks(eag.model, recorder(pre))
      res = inner(state, batch)
      for h in hooks:
        h.remove()
      last['loss'] = res[1]
      last['check'] += ([p.grad.detach().cpu()
                         for p in eag.model.parameters()],
                        {k: z.cpu() for k, z in pre.items()})
      return res
    eag._train_step = recorded_step
    try:
      eag_state, eag_losses, _, eag_ms, counts, _ = rscan_epoch(
          torch, gdist, eag, eag_state, cuda, 'remote_scan eager', want)
      rep['launch_runs'].append(counts)
      eag_timings = eag.chunk_timings()
    finally:
      eag.shutdown()
    c_check = cpu_step_check(
        torch, gtt, None, eag.model, last['check'], last['loss'],
        cpu_model=lambda: rscan_model(torch, gtt, torch.device('cpu'), b))
    del last, eag
    if cuda:
      torch.cuda.empty_cache()
    cap = trainer(None)
    assert cap.capture == cuda
    cap_state = train.create_train_state(cap.model, lr=LR)
    took = []

    def take_boundary(c, s, k):
      # a common start: the chunk starts from the eager chunk's (Adam's
      # tensors exist from the first step on)
      mine = rscan_tensors(cap, cap_state)
      if c in boundary and len(mine) == len(boundary[c]):
        with torch.no_grad():
          torch._foreach_copy_(mine, boundary[c])
        took.append(c)
    cap.stage_hook = take_boundary
    try:
      cap_state, cap_losses, _, cap_ms1, counts, _ = rscan_epoch(
          torch, gdist, cap, cap_state, cuda, 'remote_scan captured 1',
          want)
      rep['launch_runs'].append(counts)
      if cuda and (cap.uploads, cap.replays) != (chunks, chunks - 1):
        raise AssertionError(f'remote_scan captured epoch 1: '
                             f'{cap.uploads} uploads, {cap.replays} replays')
      torch.testing.assert_close(cap_losses.cpu(), eag_losses.cpu(),
                                 rtol=1e-4, atol=0)
      equal = bool(torch.equal(cap_losses, eag_losses))
      cap.stage_hook = None
      del boundary
      # ---- 3. the timed epoch: replays only, host syncs counted
      cap_state, cap_losses2, _, cap_ms, counts, syncs = rscan_epoch(
          torch, gdist, cap, cap_state, cuda, 'remote_scan captured 2',
          want, syncs=True)
      rep['launch_runs'].append(counts)
      if cuda and (cap.uploads, cap.replays, syncs) != (chunks, chunks, 0):
        raise AssertionError(f'remote_scan captured epoch 2: '
                             f'{cap.uploads} uploads, {cap.replays} replays, '
                             f'{syncs} host syncs')
      timings = cap.chunk_timings()
      blog = rscan_build_log(gdist, cap)
      capture_ms = cap.capture_ms
      # ---- 4. a profiled epoch (the client's device ops)
      prof_state = [cap_state]

      def prof_epoch():
        prof_state[0] = cap.run_epoch(prof_state[0])[0]
      prof = profiled(torch, prof_epoch, 1, device, 'remote_scan epoch')
    finally:
      cap.shutdown()
      cap.drop_graphs()
    del cap
    if cuda:
      torch.cuda.empty_cache()
    # ---- 5. a bf16-wire epoch
    b16 = trainer(None, 'bf16')
    try:
      _, b16_losses, _, b16_ms, counts, _ = rscan_epoch(
          torch, gdist, b16, train.create_train_state(b16.model, lr=LR),
          cuda, 'remote_scan bf16', want)
      rep['launch_runs'].append(counts)
      b16_log = rscan_build_log(gdist, b16)
      b16_timings = b16.chunk_timings()
    finally:
      b16.shutdown()
      b16.drop_graphs()
    del b16
    if cuda:
      torch.cuda.empty_cache()
    if not all(np.isfinite(b16_losses.tolist())):
      raise AssertionError(f'remote_scan bf16: losses {b16_losses}')
    gdist.shutdown_client()
    kind, server_rings, _, _ = q.get(timeout=120)
    server.join(timeout=120)
    rep['rings'] = list(server_rings or ())
    if kind != 'done' or server.exitcode != 0:
      raise AssertionError(f'remote_scan server ended {kind}, exit '
                           f'{server.exitcode}')
  finally:
    from graphlearn_tpu_torch.distributed import dist_client
    if dist_client.get_client() is not None:
      dist_client._client.close()
      dist_client._client = None
    if server.is_alive():
      server.terminate()
      server.join(30)
  with open(err_path) as fh:
    server_err = fh.read()
  if server_err.strip():
    log('remote_scan server stderr (tail): ' + server_err[-2000:])
  left = dict(rings_open=live_channel_count() - rings0,
              rings_made=len(rep['rings']),
              rings_alive=rings_alive(rep['rings']),
              children=[p.pid for p in mp.active_children()],
              ipc_warning=IPC_WARNING in server_err)
  if left['rings_open'] or left['rings_alive'] or left['children'] or \
      left['ipc_warning'] or left['rings_made'] < 1:
    raise AssertionError(f'remote_scan phase left behind {left}')
  per_chunk = []
  for t, r in zip(timings, blog[-chunks:]):
    per_chunk.append(dict(
        k=t['k'], bytes=r['bytes'], server_sample_ms=r['sample_ms'],
        server_pack_ms=r['pack_ms'], server_d2h_ms=r['d2h_ms'],
        server_build_ms=r['build_ms'], fetch_rpc_ms=t['fetch_ms'],
        wait_ms=t['wait_ms'], pin_ms=t['pin_ms'], upload_ms=t['upload_ms'],
        device_ms=t['device_ms']))
  rep.update(
      eager_ms_per_step=eag_ms / steps, captured_first_ms_per_step=cap_ms1
      / steps, captured_ms_per_step=cap_ms / steps,
      bf16_ms_per_step=b16_ms / steps, capture_ms=capture_ms,
      chunks=per_chunk, eager_chunks=eag_timings, bf16_chunks=b16_timings,
      bf16_frame_bytes=[r['bytes'] for r in b16_log[-chunks:]],
      losses=cap_losses2.tolist(), eager_losses=eag_losses.tolist(),
      captured_vs_eager_bit_equal=equal, boundaries_taken=took,
      host_syncs=syncs, profile=prof,
      top5_device_ms=dict(sorted(prof['top_device_ms'].items(),
                                 key=lambda kv: -kv[1])[:5]),
      cpu_check={k: c_check[k] for k in ('pre_diff', 'opposite',
                                         'grad_share', 'adam_diff',
                                         'cpu_loss', 'loss')},
      left=left)
  rep['launches'] = {k: sum(c[k] for c in rep['launch_runs'])
                     for k in rep['launch_runs'][0]}
  rep['phase_s'] = time.perf_counter() - t_phase
  for c in per_chunk:
    log('remote_scan chunk: ' + ' '.join(
        f'{k}={v:.2f}' if isinstance(v, float) else f'{k}={v}'
        for k, v in c.items()))
  log(f'remote_scan: ms/step captured {rep["captured_ms_per_step"]:.1f} '
      f'(first epoch {rep["captured_first_ms_per_step"]:.1f}), eager '
      f'{rep["eager_ms_per_step"]:.1f}, bf16 {rep["bf16_ms_per_step"]:.1f}; '
      f'capture ms {capture_ms}; captured chunks within rtol 1e-4 of the '
      f'eager ones (bit-equal {equal}); host syncs {syncs}; the last eager '
      f'step on the CPU: gradients within {c_check["grad_share"]:.3g}; '
      f'client idle share {prof["idle_share"]}; top ops '
      f'{rep["top5_device_ms"]}; server launches {rep["launches"]}; phase '
      f'{rep["phase_s"]:.1f} s; left behind {left} on {smi}')
  return rep


# ---- the hot/cold feature store
HC_SPLIT = 0.25                      # the kernel case's device share
HC_SEED = 25                         # the no-duplicate case's permutation
HC_PLAIN_REPS = 5                    # its plain version's timed calls
PINNED_BYTES = 256 << 20             # the pinned host-to-device copy
# the papers-scale example cut from its 10M nodes (4.77 GB of features,
# a 2 GB hot budget) to fit the script's time: the host build (draws,
# sorts) grows with N; --hot-gb scaled with it keeps split ~0.42 < 1
PAPERS_NODES, PAPERS_HOT_GB = 2_000_000, 0.4


def pinned_rate(torch, device):
  """The card's pinned host-to-device copy rate (bytes/s) over
  PINNED_BYTES, median of 5 copies between CUDA events."""
  src = torch.empty(PINNED_BYTES // 4, dtype=torch.float32).pin_memory()
  dst = torch.empty_like(src, device=device)
  dst.copy_(src, non_blocking=True)
  times = []
  for _ in range(5):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    dst.copy_(src, non_blocking=True)
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b))
  return PINNED_BYTES / (float(np.median(times)) * 1e-3)


def mapped_tail_placement(torch, gtt, cold, smi):
  """Where the hot/cold kernel's cold rows live, read only (nothing here
  sets an affinity or a memory policy): the card's NUMA node (sysfs, by
  the PCI address nvidia-smi gives, else torch's), this process's CPU
  affinity and the NUMA nodes of those CPUs, the pages of the mapped
  tail per NUMA node (``/proc/self/numa_maps`` over the mappings that
  hold it) and whether the read-only mapping was granted. A field that
  cannot be read is None."""
  rec = {}
  bus = None
  try:
    out = subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=pci.bus_id',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if ':' in out:
      dom, rest = out.lower().split(':', 1)
      bus = f'{dom[-4:]}:{rest}'
  except (OSError, subprocess.SubprocessError):
    pass
  if bus is None and torch.cuda.is_available():
    p = torch.cuda.get_device_properties(0)
    if hasattr(p, 'pci_bus_id'):
      bus = (f'{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:'
             f'{p.pci_device_id:02x}.0')
  rec['pci_bus_id'] = bus

  def read(path):
    try:
      with open(path) as fh:
        return fh.read().strip()
    except OSError:
      return None
  node = read(f'/sys/bus/pci/devices/{bus}/numa_node') if bus else None
  rec['card_numa_node'] = int(node) if node is not None else None
  cpus = sorted(os.sched_getaffinity(0))
  rec['cpu_affinity'] = cpus
  base = '/sys/devices/system/node'
  cpu_nodes = {} if os.path.isdir(base) else None
  for d in (sorted(os.listdir(base)) if cpu_nodes is not None else []):
    if d.startswith('node') and d[4:].isdigit():
      listed = read(f'{base}/{d}/cpulist') or ''
      mine = set()
      for part in filter(None, listed.split(',')):
        lo, _, hi = part.partition('-')
        mine.update(range(int(lo), int(hi or lo) + 1))
      if mine & set(cpus):
        cpu_nodes[int(d[4:])] = len(mine & set(cpus))
  rec['affinity_cpus_per_node'] = cpu_nodes
  pages = None
  numa_maps = read('/proc/self/numa_maps')
  if cold is not None and cold.numel() and numa_maps is not None:
    lo = cold.data_ptr()
    hi = lo + cold.numel() * cold.element_size()
    starts = set()
    for line in (read('/proc/self/maps') or '').splitlines():
      a, b = (int(x, 16) for x in line.split()[0].split('-'))
      if a < hi and lo < b:
        starts.add(a)
    pages = {}
    for line in numa_maps.splitlines():
      f = line.split()
      if f and int(f[0], 16) in starts:
        for tok in f[1:]:
          if tok.startswith('N') and '=' in tok:
            k, v = tok[1:].split('=')
            pages[int(k)] = pages.get(int(k), 0) + int(v)
  rec['tail_pages_per_node'] = pages
  rec['read_only_mapping'] = (gtt.ops.mapped.lookup(cold).read_only
                              if cold is not None and cold.numel() and
                              torch.cuda.is_available() else None)
  log(f'mapped tail placement: card {bus} on NUMA node '
      f'{rec["card_numa_node"]}; CPU affinity {len(cpus)} CPUs '
      f'(per node {cpu_nodes}); the tail\'s pages per node {pages}; '
      f'read-only mapping {rec["read_only_mapping"]} on {smi}')
  return rec


def hot_cold_kernel_case(torch, gtt, re, id2index, rows, split, device,
                         reps, rate, smi, label='tree batch',
                         plain_reps=None, placement=False):
  """The hot/cold kernel on the storage rows ``rows`` (one tree batch's,
  or as many with no duplicate) over the reordered ``[1M, 100]`` table
  at ``split``, against its plain version (the JAX store's design on
  the card: ids to the host, the cold rows gathered there, a pinned
  copy, ``index_copy_``), exact; its fetch counter equal to the distinct
  cold rows; three timings (each the median of ``reps``); the rate on
  distinct cold bytes; the bound the larger of the HBM bytes (ids,
  distinct hot rows, output) over 3.35 TB/s and the distinct cold rows'
  bytes over the measured pinned rate; with ``placement``, where the
  mapped tail sits (:func:`mapped_tail_placement`). No PyTorch call
  reads mapped host memory: library_ms null."""
  import gc

  from graphlearn_tpu_torch import ops
  cuda = device.type == 'cuda'
  store = gtt.data.Feature(re, split, id2index=id2index, device=device)
  store.lazy_init()
  ut = store.unified
  hot, cold = ut._hot(), ut.host_part
  h, n = hot.shape[0], ut.size
  where = mapped_tail_placement(torch, gtt, cold, smi) if placement else None
  t0 = time.perf_counter()
  got, ms_runs, call_runs = timed3(
      torch, lambda: ops.gather_rows_unified(hot, cold, rows), reps, device)
  fetched = int(ops.gather.unified_fetches) if cuda else None
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: ops.gather_rows_unified_plain(hot, cold, rows)[0],
      plain_reps or reps, device)
  if cuda:
    torch.cuda.synchronize()
  exact = bool(torch.equal(got, ref))
  err = float((got.float() - ref.float()).abs().max())
  fill = fill_ms(torch, [got], device, reps)
  uniq = torch.unique(rows.clamp(0, n - 1))
  n_cold_u = int((uniq >= h).sum())
  row = hot.shape[1] * hot.element_size()
  hbm = rows.numel() * rows.element_size() + (uniq.numel() - n_cold_u) * \
      row + rows.numel() * row
  pcie = n_cold_u * row
  bound = max(hbm / H100_BYTES_PER_S, pcie / rate) * 1e3
  ms, call_ms = float(np.median(ms_runs)), float(np.median(call_runs))
  cold_rate = pcie / (ms * 1e-3) if cuda else None
  cold_share = float((rows >= h).float().mean())
  rec = dict(split=split, ids_from=label, hot_rows=h, ids=rows.numel(),
             cold_share=cold_share, distinct_cold_rows=n_cold_u,
             fetched_rows=fetched, exact=exact, max_abs_err=err, ms=ms,
             call_ms=call_ms, ms_runs=ms_runs, call_ms_runs=call_runs,
             plain_ms=plain_ms, plain_call_ms=plain_call_ms,
             jax_design_ms=plain_call_ms, bound_ms=bound, bound_by='bytes',
             fill_ms=fill, hbm_bytes=hbm, cold_bytes=pcie,
             cold_bytes_per_s=cold_rate, pinned_bytes_per_s=rate,
             library_ms=None,
             read_only_mapping=(gtt.ops.mapped.lookup(cold).read_only
                                if cuda and cold is not None else None),
             placement=where, case_s=time.perf_counter() - t0)
  log(f'kernel gather_unified split={split} on the {label} (H={h} of {n}): '
      f'ids={rows.numel()} cold share {cold_share:.4f} ({n_cold_u} '
      f'distinct cold rows, {pcie / 1e6:.1f} MB; fetched {fetched}) '
      f'exact={exact} ms={ms:.4f} (runs '
      + ' '.join(f'{t:.4f}' for t in ms_runs) + ') call_ms='
      f'{call_ms:.4f}; distinct cold bytes at '
      + (f'{cold_rate / 1e9:.2f}' if cuda else '-') +
      f' GB/s beside the pinned {rate / 1e9:.2f} GB/s; plain (the JAX '
      f'design: sync, host gather, pinned copy, index_copy_) ms='
      f'{plain_ms:.4f} call_ms={plain_call_ms:.4f}; bound_ms={bound:.4f} '
      f'(HBM {hbm / 1e6:.1f} MB, PCIe at {rate / 1e9:.2f} GB/s) fill_ms='
      f'{fill:.4f}; read-only '
      f'mapping {rec["read_only_mapping"]} on {smi}')
  assert exact, f'gather_unified split={split}: kernel != plain version'
  assert not cuda or fetched == n_cold_u, (
      'gather_unified fetched', fetched, 'distinct cold rows', n_cold_u)
  del store, ut, hot, cold, got, ref
  gc.collect()
  return rec


def tree_batch_rows(torch, gtt, ds, id2index, pool, device):
  """The storage rows of one [15, 10, 5] x 1024 tree batch's node slots
  (FILL pads read row 0, as ``Feature`` maps them)."""
  loader = make_loader(gtt, ds, pool, device, 'tree')
  node = loader.sampler.sample_from_nodes(
      gtt.sampler.NodeSamplerInput(pool[:BATCH]), batch_cap=BATCH).node
  i2i = torch.as_tensor(id2index).to(device)
  return torch.where(node < 0, 0, i2i[node.clamp(min=0).long()]).contiguous()


class SameDraws:
  """``make_graph`` of the papers example, drawn once for the script's
  two builds of it: the hot/cold phase's ``build`` and the tiered phase's
  ``build_tiered`` draw the same synthetic from ``default_rng(0)``. A
  call with arguments and a generator state in ``kept``
  (``papers_draw_take``'s: the draw a child made) gets copies of those
  arrays, and its generator is left where that draw left it, so every
  later draw is as it was; any other call fails (the child drew another
  synthetic than the builds ask for). ``fn`` is the example's own
  ``make_graph``, put back after the builds."""

  def __init__(self, fn, kept):
    self.fn, self.kept = fn, dict(kept)

  @staticmethod
  def key(args, state) -> str:
    return json.dumps([[int(a) for a in args], state], sort_keys=True)

  def __call__(self, *args):
    *args, rng = args
    key = self.key(args, rng.bit_generator.state)
    if key not in self.kept:
      raise AssertionError(f'papers draw: no draw kept for {args} from '
                           'this generator state')
    out, after = self.kept[key]
    rng.bit_generator.state = after
    return tuple(np.copy(a) for a in out)


def papers_argv(cuda: bool) -> list:
  """The papers example's size in this script (PAPERS_NODES on a card)."""
  return (['--num-nodes', str(PAPERS_NODES), '--hot-gb', str(PAPERS_HOT_GB)]
          if cuda else ['--num-nodes', '20000', '--hot-gb', '0.004'])


PAPERS_DRAW = ('edge_rows', 'edge_cols', 'features', 'labels')


def papers_draw_main(directory, args):
  """A spawned child (no card): the papers example's ``make_graph(*args,
  default_rng(0))``, its arrays and the generator's states before and
  after written to ``directory``."""
  from graphlearn_tpu_torch.examples import train_sage_papers_scale as pex
  rng = np.random.default_rng(0)
  before = rng.bit_generator.state
  out = pex.make_graph(*args, rng)
  for name, a in zip(PAPERS_DRAW, out):
    np.save(os.path.join(directory, f'{name}.npy'), a)
  with open(os.path.join(directory, 'draw.json'), 'w') as fh:
    json.dump(dict(args=list(args), before=before,
                   after=rng.bit_generator.state), fh)


def papers_draw_start(cuda: bool) -> dict:
  """Starts ``papers_draw_main`` at the example's size here (its
  parser's ``avg_deg`` and ``feat_dim``), so the hot/cold and tiered
  builds find the synthetic drawn."""
  import multiprocessing as mp
  import tempfile
  from graphlearn_tpu_torch.examples import train_sage_papers_scale as pex
  a = pex.parser().parse_args(papers_argv(cuda))
  directory = tempfile.mkdtemp(prefix='glt_papers_')
  proc = mp.get_context('spawn').Process(
      target=papers_draw_main,
      args=(directory, (a.num_nodes, a.avg_deg, a.feat_dim)), daemon=True)
  proc.start()
  return dict(proc=proc, directory=directory)


def papers_draw_take(started) -> dict:
  """``SameDraws``' ``kept`` from the child ``papers_draw_start`` started,
  once it ends (joined, its directory removed)."""
  proc = started['proc']
  proc.join(600)
  try:
    if proc.is_alive() or proc.exitcode != 0:
      raise AssertionError(f'papers draw child: exit {proc.exitcode}')
    d = started['directory']
    with open(os.path.join(d, 'draw.json')) as fh:
      meta = json.load(fh)
    out = tuple(np.load(os.path.join(d, f'{name}.npy'))
                for name in PAPERS_DRAW)
    return {SameDraws.key(meta['args'], meta['before']): (out,
                                                          meta['after'])}
  finally:
    if proc.is_alive():
      proc.kill()
      proc.join()
    shutil.rmtree(started['directory'], ignore_errors=True)


def papers_path(torch, gtt, device, smi, rate):
  """The papers-scale example's hot/cold mode through the port's entry
  points (``Dataset.init_node_features(sort_func=sort_by_in_degree,
  split_ratio=split)``, the block ``NeighborLoader``, collate, the
  per-step train step, Adam): the warm-up step, then the timed steps
  split into sample+collate and train by CUDA events, the launch counters
  set to 0 before them and read after (one hot/cold launch a step, no
  row-gather launch), the hot hit rate, 0 host syncs in the lookup, the
  peak memory, and the last step recomputed on the CPU."""
  import copy
  import gc

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.examples import train_sage_papers_scale as papers
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  argv = papers_argv(cuda) + ([] if cuda else ['--steps', '3',
                                               '--batch-size', '32'])
  args = papers.parser().parse_args(argv + ['--device', device.type])
  ds, loader, info = papers.build(args, device)
  log(f'papers: {info["num_nodes"]} nodes, {info["feat_gb"]:.3f} GB of '
      f'features, split {info["split_ratio"]:.4f} ({info["hot_rows"]} hot '
      f'rows), host build {info["build_s"]:.1f} s')
  model = papers.build_model(args, args.feat_dim, device,
                             torch.Generator().manual_seed(0))
  model.train()
  state = train.create_train_state(model, lr=args.lr)
  step_fn, _ = train.make_train_step(model, papers.NUM_CLASSES)
  it = iter(loader)
  state, loss0, _ = step_fn(state, train.batch_to_dict(next(it)))
  steps = args.steps
  if cuda:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
  ops.reset_launch_counts()
  per_step, losses, nodes, check = [], [], [], None
  for i in range(steps):
    e0 = _event(torch, cuda)
    batch = next(it)
    e1 = _event(torch, cuda)
    d = train.batch_to_dict(batch)
    if i == steps - 1:
      check = (copy.deepcopy(model.state_dict()),
               copy.deepcopy(state.optimizer.state_dict()),
               {k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in d.items()})
      pre = {}
      hooks = relu_input_hooks(model, recorder(pre))
    state, loss, _ = step_fn(state, d)
    e2 = _event(torch, cuda)
    if cuda:
      e2.synchronize()
    if i == steps - 1:
      for h in hooks:
        h.remove()
      check += ([p.grad.detach().cpu() for p in model.parameters()],
                {k: z.cpu() for k, z in pre.items()})
    per_step.append(dict(sample_collate_ms=_span(e0, e1, cuda),
                         train_ms=_span(e1, e2, cuda)))
    losses.append(loss)
    nodes.append(batch.node)
  counts = ops.launch_counts()
  peak = torch.cuda.max_memory_allocated() if cuda else None
  per = 1 if cuda else 0
  assert counts['gather_unified'] == per * steps, counts
  assert counts['gather_rows'] == 0, counts
  losses = torch.stack(losses)
  assert bool(torch.isfinite(losses).all()), 'non-finite loss'
  hit = papers.hit_rate(nodes, ds.node_features.id2index, info['hot_rows'])
  rec = dict(info, steps=steps, per_step=per_step, launches=counts,
             peak_step_bytes=peak, hot_hit_rate=hit,
             first_loss=float(loss0), losses=losses.tolist())
  steady = per_step[1:] or per_step
  rec['median_step_ms'] = {k: float(np.median([p[k] for p in steady]))
                           for k in steady[0]}
  # the last step once more on the CPU, from the same state and batch
  # (before any further step moves the card's parameters)
  c = rec['cpu_check'] = cpu_step_check(
      torch, gtt, loader, model, check, losses[-1],
      cpu_model=lambda: papers.build_model(args, args.feat_dim, 'cpu',
                                           torch.Generator()),
      make_step=lambda m: train.make_train_step(m, papers.NUM_CLASSES))
  log(f'papers CPU recompute of step {steps}: loss {c["cpu_loss"]:.6f} vs '
      f'{c["loss"]:.6f}; gradients {c["grad_share"]:.3g} of the largest; '
      f'CPU Adam on the card\'s gradients {c["adam_diff"]:.3g}')
  # the kernel at this path's shape (the last batch's storage rows)
  # against its plain version, exact, and both timed
  feat = ds.node_features
  i2i = torch.as_tensor(feat.id2index).to(device)
  node = nodes[-1]
  rows = torch.where(node < 0, 0, i2i[node.clamp(min=0).long()]).contiguous()
  ut = feat.unified
  got, ms_runs, call_runs = timed3(
      torch, lambda: ops.gather_rows_unified(ut._hot(), ut.host_part, rows),
      REPS if cuda else 2, device)
  fetched = int(ops.gather.unified_fetches) if cuda else None
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: ops.gather_rows_unified_plain(ut._hot(), ut.host_part,
                                                   rows)[0],
      REPS if cuda else 2, device)
  assert torch.equal(got, ref), 'gather_unified != plain at the path shape'
  h = ut._hot().shape[0]
  uniq = torch.unique(rows.clamp(0, ut.size - 1))
  n_cold_u = int((uniq >= h).sum())
  assert not cuda or fetched == n_cold_u, (
      'papers lookup fetched', fetched, 'distinct cold rows', n_cold_u)
  ms, call_ms = float(np.median(ms_runs)), float(np.median(call_runs))
  rec['lookup'] = dict(ids=rows.numel(), ms=ms, call_ms=call_ms,
                       ms_runs=ms_runs, call_ms_runs=call_runs,
                       plain_ms=plain_ms, plain_call_ms=plain_call_ms,
                       distinct_cold_rows=n_cold_u, fetched_rows=fetched,
                       cold_share=float((rows >= h).float().mean()),
                       exact=True)
  log(f'papers lookup of one batch ({rows.numel()} rows, cold share '
      f'{rec["lookup"]["cold_share"]:.4f}, {n_cold_u} distinct cold rows, '
      f'fetched {fetched}): kernel ms={ms:.4f} (runs '
      + ' '.join(f'{t:.4f}' for t in ms_runs) + '; the one-warp-a-slot '
      f'kernel read 0.0096) call_ms={call_ms:.4f}, plain (the JAX design) '
      f'call_ms={plain_call_ms:.4f}, exact')
  if cuda:
    # the lookup of one more batch's nodes under sync counting: 0
    ds.node_features[node]
    torch.cuda.synchronize()
    _, syncs, kinds = count_syncs(torch, lambda: ds.node_features[node])
    assert syncs == 0, ('the hot/cold lookup synchronised', kinds)
    _, step_syncs, step_kinds = count_syncs(
        torch, lambda: step_fn(state, train.batch_to_dict(next(it))))
    rec.update(lookup_host_syncs=syncs, step_host_syncs=step_syncs,
               step_sync_kinds=step_kinds)
  med = rec['median_step_ms']
  log(f'papers path: {steps} steps; launches {counts}; median after the '
      'first step (ms): ' + ' '.join(f'{k}={v:.3f}' for k, v in med.items())
      + f' total={sum(med.values()):.3f}; hot hit rate {hit:.4f}; peak '
      f'{peak} B; host syncs in the lookup {rec.get("lookup_host_syncs")}, '
      f'in a whole step {rec.get("step_host_syncs")} '
      f'{rec.get("step_sync_kinds")}; losses {float(loss0):.4f} -> '
      f'{losses[-1]:.4f} on {smi}')
  del ds, loader, it, model, state
  gc.collect()
  return rec


def tables_path(torch, gtt, device, smi):
  """``examples/train_from_tables.py`` at its size on the card: the
  tables read by ``TableDataset`` (every feature row on the host), one
  epoch of the per-step loop; each batch's ``x`` equal to the table's
  rows, the launch counters set to 0 before the epoch and read after
  (one hot/cold launch and two hop launches a step). Then the store
  rebuilt in this process from its IPC handle, exact."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.examples import train_from_tables as tables
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  ds, n, ncls, load_s = tables.load(device)
  feat = ds.node_features
  assert feat.device_table() is None and feat.unified.device_part is None
  table = feat.unified.host_part.to(device)
  loader = tables.make_loader(ds, n, device)
  model = tables.build_model(table.shape[1], ncls, device,
                             torch.Generator().manual_seed(0))
  model.train()
  state = train.create_train_state(model, lr=3e-3)
  step_fn, _ = train.make_train_step(model, ncls)
  ops.reset_launch_counts()
  e0 = _event(torch, cuda)
  losses, equal = [], []
  for b in loader:
    state, loss, _ = step_fn(state, train.batch_to_dict(b))
    losses.append(loss)
    equal.append(torch.equal(b.x, table[b.node.clamp(min=0).long()]))
  e1 = _event(torch, cuda)
  if cuda:
    e1.synchronize()
  counts = ops.launch_counts()
  steps = len(losses)
  per = 1 if cuda else 0
  assert all(equal), 'a batch\'s x differs from the table\'s rows'
  assert counts['gather_unified'] == per * steps, counts
  assert counts['sample_hop'] == per * steps * len(tables.FANOUTS), counts
  assert counts['gather_rows'] == 0, counts
  losses = torch.stack(losses)
  assert bool(torch.isfinite(losses).all()), 'non-finite loss'
  ids = torch.arange(n, device=device)
  clone = gtt.data.Feature.from_ipc_handle(feat.share_ipc())
  ipc_exact = bool(torch.equal(clone[ids], table))
  assert ipc_exact, 'the store rebuilt from its IPC handle differs'
  rec = dict(num_nodes=n, load_s=load_s, steps=steps, launches=counts,
             epoch_ms=_span(e0, e1, cuda),
             ms_per_step=_span(e0, e1, cuda) / steps,
             losses=losses.tolist(), ipc_exact=ipc_exact)
  log(f'tables path: {n} nodes read in {load_s:.2f} s; one epoch of '
      f'{steps} steps in {rec["epoch_ms"]:.1f} ms ({rec["ms_per_step"]:.3f} '
      f'ms/step); every x equal to the table; launches {counts}; losses '
      f'{losses[0]:.4f} -> {losses[-1]:.4f}; IPC round trip exact on {smi}')
  return rec


def hot_cold_phase(torch, gtt, ds, topo, feats, pool, device, reps, smi):
  """The hot/cold store: the kernel against its plain version at a
  products tree batch (split 0.25 and all on the host), then the
  papers-scale and tables paths."""
  cuda = device.type == 'cuda'
  rep = {}
  rate = pinned_rate(torch, device) if cuda else 1.0
  rep['pinned_h2d_bytes_per_s'] = rate if cuda else None
  if cuda:
    log(f'pinned host-to-device copy of {PINNED_BYTES >> 20} MB: '
        f'{rate / 1e9:.2f} GB/s on {smi}')
  re, id2index = gtt.data.sort_by_in_degree(feats, HC_SPLIT, topo)
  rows = tree_batch_rows(torch, gtt, ds, id2index, pool, device)
  rep['kernel'] = [hot_cold_kernel_case(torch, gtt, re, id2index, rows,
                                        split, device, reps, rate, smi,
                                        placement=split == HC_SPLIT)
                   for split in (HC_SPLIT, 0.0)]
  # as many ids with no duplicate: what the table costs when nothing
  # dedups (the plain version moves ~0.3 GB a call: fewer timed calls)
  distinct = torch.as_tensor(np.random.default_rng(HC_SEED).permutation(
      re.shape[0])[:rows.numel()]).to(device)
  rep['kernel'].append(hot_cold_kernel_case(
      torch, gtt, re, id2index, distinct, HC_SPLIT, device, reps, rate, smi,
      label='permutation (no duplicate)', plain_reps=HC_PLAIN_REPS))
  del re, rows, distinct
  rep['papers'] = papers_path(torch, gtt, device, smi, rate)
  rep['tables'] = tables_path(torch, gtt, device, smi)
  return rep


# the tiered phase: the products table in three tiers (device, mapped
# host RAM, disk), 16 steps in chunks of 8, epochs held by C5's rule to
# the all-device ScanTrainer from one start
TIER_HOT, TIER_WARM = 0.25, 0.25
TIER_STEPS, TIER_CHUNK = 16, 8
# the papers example's three-tier mode at PAPERS_NODES: the shares of its
# 10M default (2 GB hot, 1 GB warm of 4.77 GB: 42%, 21%, 37% on disk)
PAPERS_WARM_GB, PAPERS_TIER_STEPS, PAPERS_TIER_CHUNK = 0.2, 16, 8
SERVE_TIER_SYNC_LOOKUPS = 16         # lookups run under sync counting


def buckets_of(ids):
  """One serving request's engine buckets: pieces of at most the largest
  bucket, each padded (-1) to the smallest bucket that holds it."""
  out = []
  for s in range(0, len(ids), SERVE_BUCKETS[-1]):
    piece = ids[s:s + SERVE_BUCKETS[-1]]
    cap = min(b for b in SERVE_BUCKETS if b >= len(piece))
    padded = np.full((cap,), -1, np.int64)
    padded[:len(piece)] = piece
    out.append((padded, padded >= 0))
  return out


def load_chunk_slab(torch, tr, c):
  """Chunk ``c`` of ``tr``'s last plan staged again (the worker's
  gather, synchronously) into the trainer's static slab."""
  from graphlearn_tpu_torch.storage import pad_slab
  rows_abs = tr.last_plan.chunk_rows[c]
  ids, rows = pad_slab(rows_abs.astype(np.int32),
                       tr._store.stage_gather(rows_abs))
  tr._slab_ids.fill_(np.iinfo(np.int32).max)
  tr._slab_ids[:ids.shape[0]].copy_(torch.from_numpy(ids))
  tr._slab_rows[:rows.shape[0]].copy_(torch.from_numpy(rows))


def chunk_x_equal(torch, gtt, tr, ref, steps, chunk) -> list:
  """Each step of the last epoch's chunk ``chunk``: the tiered body's
  ``x`` (the chunk's slab loaded again) bit-equal to the all-device
  body's, from the same seed rows and hop keys."""
  load_chunk_slab(torch, tr, chunk)
  epoch = tr._epochs - 1
  seeds, mask = tr._epoch_seeds(gtt.random.fold_in(tr._perm_key, epoch),
                                steps)
  count0 = tr._sampler._call_count - steps + 1
  keys = gtt.random.step_keys_plain(
      tr._sampler._key, count0 + torch.arange(steps, dtype=torch.int64),
      len(tr._sampler.num_neighbors)).to(seeds.device)
  out = []
  for s in range(chunk * tr.chunk_size,
                 min((chunk + 1) * tr.chunk_size, steps)):
    a = tr._sample_collate(seeds[s], mask[s], keys[s])[0]['x']
    b = ref._sample_collate(seeds[s], mask[s], keys[s])[0]['x']
    out.append(bool(torch.equal(a, b)))
  return out


def tiered_pair(torch, gtt, ds, tds, pool, device, mode, caps, chunk):
  """``{'ref': [ScanTrainer over ds, state], 'tiered':
  [TieredScanTrainer over tds, state]}`` from the same weights, chunks of
  ``chunk``."""
  from graphlearn_tpu_torch.models import train
  out = {}
  for name, d, cls in (('ref', ds, gtt.loader.ScanTrainer),
                       ('tiered', tds, gtt.storage.TieredScanTrainer)):
    loader = make_loader(gtt, d, pool, device, mode, caps)
    model, _ = make_model(torch, gtt, loader, device, 0)
    model.train()
    out[name] = [cls(loader, model, CLASSES, chunk_size=chunk),
                 train.create_train_state(model, lr=LR)]
  return out


def hold_hooks(torch, pair, steps):
  """C5's rule as hooks: the reference keeps its parameters and Adam
  state after every chunk (by global step), the tiered trainer takes
  them up at each chunk start and is compared at the chunk's end (max
  abs difference, appended to the returned list)."""
  ref, tr = pair['ref'], pair['tiered']
  held, diffs = {}, []

  def tensors(p):
    opt = p[1].optimizer
    ps = list(p[0].model.parameters())
    return ps + [v for q in ps for v in opt.state.get(q, {}).values()
                 if torch.is_tensor(v)]

  def at(p, s):
    return p[0]._epochs * steps + s

  def keep(c, s0, k):
    held[at(ref, s0 + k)] = [t.detach().clone() for t in tensors(ref)]

  @torch.no_grad()
  def take_up(c, s0, k):
    g = at(tr, s0)
    if g in held:
      torch._foreach_copy_(tensors(tr), held[g])

  def compare(c, s0, k):
    diffs.append(max(float((a.detach() - b).abs().max())
                     for a, b in zip(tensors(tr), held[at(tr, s0 + k)])))

  return keep, take_up, compare, diffs


def tiered_training(torch, gtt, ds, tds, pool, device, mode, caps, smi,
                    steps, chunk, epochs):
  """``epochs`` held epochs of the tiered and the all-device trainer
  (C5's rule); for tree also a degraded epoch (held), a timed epoch of
  each, a sync-counted and a profiled tiered epoch. The launch counters
  are set to 0 before each tiered epoch and read after it."""
  from graphlearn_tpu_torch import metrics, ops
  cuda = device.type == 'cuda'
  pair = tiered_pair(torch, gtt, ds, tds, pool, device, mode, caps, chunk)
  ref, tr = pair['ref'][0], pair['tiered'][0]
  keep, take_up, compare, diffs = hold_hooks(torch, pair, steps)
  rep = dict(mode=mode, epochs=[])

  def misses():
    return metrics.default_registry().counters().get(
        'storage.prefetch_miss', 0)

  def held_epoch(label, fault=None, hold=True):
    ref.ack_hook, tr.stage_hook, tr.ack_hook = keep, take_up, compare
    n0, m0 = len(diffs), misses()
    pair['ref'][1], rloss, _ = ref.run_epoch(pair['ref'][1])
    if fault is not None:
      tr._stager._stage_fault = fault
    ops.reset_launch_counts()
    try:
      pair['tiered'][1], tloss, _ = tr.run_epoch(pair['tiered'][1])
    finally:
      tr._stager._stage_fault = lambda: None
    launches = ops.launch_counts()
    ref.ack_hook = tr.stage_hook = tr.ack_hook = None
    if cuda:
      torch.cuda.synchronize()
    rel = float(((tloss - rloss).abs() / rloss.abs()).max())
    rec = dict(label=label, losses=tloss.tolist(), ref_losses=rloss.tolist(),
               losses_equal=bool(torch.equal(tloss, rloss)),
               max_rel_loss_diff=rel, chunk_param_diffs=diffs[n0:],
               degraded=tr._stager.degraded, prefetch_miss=misses() - m0,
               plan=tr.last_plan.stats(), prologue_ms=tr.prologue_ms,
               launches=launches)
    log(f'tiered {mode} {label} epoch: losses vs all-device bit-equal '
        f'{rec["losses_equal"]}, max rel diff {rel:.3g} (rtol 1e-4); '
        f'params and Adam state after each chunk (taken up at its start) '
        f'max abs diff {max(rec["chunk_param_diffs"]):.3g} (limit '
        f'{PARAMS_LIMIT}{"" if hold else ", not held: a cold start"}); '
        f'degraded {rec["degraded"]}, prefetch_miss {rec["prefetch_miss"]}; '
        f'plan {rec["plan"]}; prologue {tr.prologue_ms:.1f} ms')
    torch.testing.assert_close(tloss, rloss, rtol=1e-4, atol=0)
    assert not hold or max(rec['chunk_param_diffs']) < PARAMS_LIMIT, rec
    assert bool(torch.isfinite(tloss).all()), 'non-finite loss'
    rep['epochs'].append(rec)
    return rec

  for e in range(epochs):
    # merge training is chaotic from a cold start (Adam's first steps move
    # every element by about the rate, whatever its gradient's size): its
    # first epoch's state is reported, and the second, which starts from
    # the reference's state, is held
    rec = held_epoch(f'healthy {e + 1}', hold=mode == 'tree' or e > 0)
    assert not rec['degraded'] and rec['prefetch_miss'] == 0, rec
  # every step of both chunks of the last epoch: x bit-equal
  rep['x_equal'] = [chunk_x_equal(torch, gtt, tr, ref, steps, c)
                    for c in range(tr.last_plan.num_chunks)]
  assert all(all(c) for c in rep['x_equal']), rep['x_equal']
  rep['graphs'] = sorted(tr._graphs)
  rep['capture_ms'] = tr.capture_ms
  rep['slab_bytes'] = tr.slab_bytes
  rep['ring_bytes'] = tr.ring_bytes
  per = 1 if cuda else 0
  chunks = tr.last_plan.num_chunks
  hop = 'sample_level' if mode == 'merge' else 'sample_hop'
  for rec in rep['epochs']:
    counts = rec['launches']
    assert counts['gather_rows'] == per * steps, counts
    assert counts[hop] == per * 2 * level_launch_count(mode, steps), counts
    assert counts['step_keys'] == per * (chunks + 1), counts
  if mode != 'tree':
    rep['launches'] = rep['epochs'][-1]['launches']
    log(f'tiered {mode}: every step\'s x of both chunks bit-equal to the '
        f'all-device gather; graphs {rep["graphs"]} on {smi}')
    tr.close()
    return rep

  def boom():
    raise RuntimeError('injected staging fault')

  rec = held_epoch('degraded', fault=boom)
  assert rec['degraded'] and rec['prefetch_miss'] > 0, rec
  rep['x_equal_degraded'] = chunk_x_equal(torch, gtt, tr, ref, steps,
                                          tr.last_plan.num_chunks - 1)
  assert all(rep['x_equal_degraded']), rep['x_equal_degraded']
  # the timed epoch of each, no hooks; the tiered one's launches
  timed = {}
  for name in ('ref', 'tiered'):
    p = pair[name]
    if cuda:
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    m0 = misses()
    a = _event(torch, cuda)
    p[1], losses, _ = p[0].run_epoch(p[1])
    b = _event(torch, cuda)
    if cuda:
      b.synchronize()
    timed[name] = dict(ms_per_step=_span(a, b, cuda) / steps,
                       launches=ops.launch_counts(),
                       peak_bytes=(torch.cuda.max_memory_allocated()
                                   if cuda else None),
                       prefetch_miss=misses() - m0)
  rep['timed'] = timed
  counts = rep['launches'] = timed['tiered']['launches']
  assert counts['gather_rows'] == per * steps, counts
  assert counts['sample_hop'] == per * 2 * steps * len(FANOUTS), counts
  assert counts['step_keys'] == per * (chunks + 1), counts
  assert timed['tiered']['prefetch_miss'] == 0, timed
  rep['chunks'] = tr.chunk_timings()
  rep['prologue_ms'] = tr.prologue_ms
  rep['ratio'] = timed['tiered']['ms_per_step'] / timed['ref']['ms_per_step']
  row = FEAT_DIM * 4
  for c in rep['chunks']:
    c['disk_mb_per_s'] = (c['disk_rows'] * row / 1e6 /
                          (c['stage_ms'] / 1e3) if c['stage_ms'] else None)
    c['staged_mb_per_s'] = (c['rows'] * row / 1e6 / (c['stage_ms'] / 1e3)
                            if c['stage_ms'] else None)
  log(f'tiered tree timed epoch: {timed["tiered"]["ms_per_step"]:.3f} ms/step '
      f'(all-device captured {timed["ref"]["ms_per_step"]:.3f}, ratio '
      f'{rep["ratio"]:.2f}); prologue {tr.prologue_ms:.1f} ms; launches '
      f'{counts}; peak allocated {timed["tiered"]["peak_bytes"]} B (all-'
      f'device {timed["ref"]["peak_bytes"]} B); graphs {rep["graphs"]} '
      f'capture ms {rep["capture_ms"]}; static slab {rep["slab_bytes"]} B, '
      f'pinned ring {rep["ring_bytes"]} B on {smi}')
  for c in rep['chunks']:
    log(f'  chunk {c["chunk"]}: rows {c["rows"]} (disk {c["disk_rows"]}), '
        f'slab {c["slab_bytes"]} B; stage {c["stage_ms"]} ms '
        f'({c["staged_mb_per_s"]} MB/s staged, {c["disk_mb_per_s"]} MB/s '
        f'of disk rows), wait at take {c["wait_ms"]:.3f} ms, copy '
        f'{c["copy_ms"]} ms, device {c["device_ms"]} ms')
  if cuda:
    _, syncs, kinds = count_syncs(
        torch, lambda: pair['tiered'].__setitem__(
            1, tr.run_epoch(pair['tiered'][1])[0]))
    torch.cuda.synchronize()
    rep['syncs_per_epoch'], rep['sync_kinds'] = syncs, kinds
    log(f'tiered tree host syncs in one epoch: {syncs} {kinds} (the plan '
        'fetch; 0 per step)')
    assert syncs == 1, kinds

    def epoch():
      pair['tiered'][1] = tr.run_epoch(pair['tiered'][1])[0]

    # an epoch in the profiler's warm-up cycle, then the counters from 0:
    # this window, late in the script, lost its first step-keys record
    # without one (C6)
    prof = profiled(torch, epoch, 1, device, 'tiered tree epoch (captured)',
                    warmup=lambda: (epoch(), ops.reset_launch_counts()),
                    expect=port_launch_counts)
    counted = port_launch_counts()
    prof['launch_counters'] = counted
    rep['profile_epoch'] = prof
    log(f'tiered tree profiled epoch: profiler kernels {prof["kernels"]} vs '
        f'launch counters {counted}')
    assert prof['kernels'] == counted, (prof['kernels'], counted)
  tr.close()
  return rep


def papers_tiered_path(torch, gtt, device, smi, spill_dir):
  """The papers example's three-tier mode through its entry point
  (``run_tiered``; ``--spill-dir``), its JSON fields; then its last step
  recomputed: the state at the last chunk's start (kept by an ack hook)
  restored, the chunk's steps run eagerly on the card from the same
  batches (the last chunk's slab is still in the static buffers), its
  last loss held to the epoch's, and that last step recomputed on the
  CPU."""
  import copy

  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.examples import train_sage_papers_scale as papers
  from graphlearn_tpu_torch.models import train
  cuda = device.type == 'cuda'
  argv = (['--num-nodes', str(PAPERS_NODES), '--hot-gb', str(PAPERS_HOT_GB),
           '--warm-gb', str(PAPERS_WARM_GB), '--steps',
           str(PAPERS_TIER_STEPS), '--chunk-size', str(PAPERS_TIER_CHUNK)]
          if cuda else ['--num-nodes', '20000', '--hot-gb', '0.004',
                        '--warm-gb', '0.002', '--steps', '6',
                        '--batch-size', '32', '--chunk-size', '2'])
  args = papers.parser().parse_args(
      argv + ['--device', device.type, '--spill-dir', spill_dir])
  got = {}

  def on_trainer(tr):
    got['trainer'] = tr
    last = (args.steps - 1) // tr.chunk_size * tr.chunk_size

    def keep(c, s0, k):
      if s0 + k == last:
        st = tr._chunk_carry['state']
        got['start'] = (copy.deepcopy(tr.model.state_dict()),
                        copy.deepcopy(st.optimizer.state_dict()),
                        st.optimizer, last)

    tr.ack_hook = keep

  t0 = time.perf_counter()
  ops.reset_launch_counts()
  result, losses = papers.run_tiered(args, on_trainer=on_trainer)
  counts = ops.launch_counts()
  rep = dict(result=result, losses=losses, launches=counts,
             path_s=time.perf_counter() - t0)
  tr = got['trainer']
  steps = len(losses)
  assert steps == args.steps and np.isfinite(losses).all(), losses
  per = 1 if cuda else 0
  chunks = tr.last_plan.num_chunks
  # the reactive template batch: one hot/cold launch and its hops
  assert counts['gather_unified'] == per, counts
  assert counts['gather_rows'] == per * steps, counts
  assert counts['step_keys'] == per * (chunks + 1), counts
  assert counts['sample_hop'] == per * (2 * steps + 1) * len(args.fanout), \
      counts
  # the template batch's reactive disk reads count in prefetch_miss; the
  # epoch itself staged every planned row
  assert not tr._stager.degraded, result
  rep['chunks'] = tr.chunk_timings()
  rep['graphs'] = sorted(tr._graphs)
  rep['prologue_ms'] = tr.prologue_ms
  # the last chunk again, eagerly, from its start
  msd, osd, opt, last = got['start']
  model = tr.model
  model.load_state_dict(msd)
  opt.load_state_dict(osd)
  state = train.TrainState(opt, last)
  seeds, mask = tr._epoch_seeds(gtt.random.fold_in(tr._perm_key, 0),
                                tr._epoch_steps())
  count0 = tr._sampler._call_count - steps + 1
  keys = gtt.random.step_keys_plain(
      tr._sampler._key, count0 + torch.arange(steps, dtype=torch.int64),
      len(args.fanout)).to(device)
  for s in range(last, steps):
    batch = tr._sample_collate(seeds[s], mask[s], keys[s])[0]
    if s == steps - 1:
      check = (copy.deepcopy(model.state_dict()),
               copy.deepcopy(opt.state_dict()),
               {k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in batch.items()})
      pre = {}
      hooks = relu_input_hooks(model, recorder(pre))
    state, loss, _ = tr._train_step(state, batch)
  for h in hooks:
    h.remove()
  check += ([p.grad.detach().cpu() for p in model.parameters()],
            {k: z.cpu() for k, z in pre.items()})
  rep['eager_last_loss'] = float(loss)
  torch.testing.assert_close(torch.tensor(float(loss)),
                             torch.tensor(losses[-1]), rtol=1e-4, atol=0)
  c = rep['cpu_check'] = cpu_step_check(
      torch, gtt, tr.loader, model, check, loss,
      cpu_model=lambda: gtt.models.GraphSAGE(
          args.feat_dim, papers.HIDDEN, papers.NUM_CLASSES,
          num_layers=len(args.fanout), device='cpu'),
      make_step=lambda m: train.make_train_step(m, papers.NUM_CLASSES))
  log(f'papers three-tier: {json.dumps(result)}')
  log(f'papers three-tier: {steps} steps in {result["epoch_wall_s"]:.3f} s '
      f'({result["ms_per_step"]:.3f} ms/step, the prologue '
      f'{tr.prologue_ms:.1f} ms included), prefetch hit rate '
      f'{result["prefetch_hit_rate"]}; graphs {rep["graphs"]}; the last '
      f'chunk again eagerly: last loss {rep["eager_last_loss"]:.6f} vs '
      f'{losses[-1]:.6f}; CPU recompute of the last step: loss '
      f'{c["cpu_loss"]:.6f}, gradients {c["grad_share"]:.3g} of the '
      f'largest, Adam {c["adam_diff"]:.3g} on {smi}')
  for ch in rep['chunks']:
    log(f'  chunk {ch["chunk"]}: rows {ch["rows"]} (disk {ch["disk_rows"]}), '
        f'stage {ch["stage_ms"]} ms, wait {ch["wait_ms"]:.3f} ms, copy '
        f'{ch["copy_ms"]} ms, device {ch["device_ms"]} ms')
  return rep


def tiered_serving(torch, gtt, ds, device, topo, smi, spill_dir):
  """The serving phase's model and graph materialized with a spill; the
  tiered store and both restarted stores against ``embedding_store()``
  on the serving mix's ids, bucket by bucket: equal rows, lookup ms
  (host clock, to the fetched rows) p50 and p99, host syncs per lookup
  and one hot/cold launch per tiered lookup."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.serving import (EmbeddingMaterializer,
                                            warm_embedding_store)
  cuda = device.type == 'cuda'
  n = topo.num_nodes
  model = gtt.models.GraphSAGE(
      FEAT_DIM, HIDDEN, CLASSES, num_layers=len(FANOUTS), device=device,
      generator=torch.Generator().manual_seed(0)).eval()
  t0 = time.perf_counter()
  mat = EmbeddingMaterializer(ds, model, block_size=SERVE_BLOCK,
                              chunk_size=SERVE_CHUNK, spill_dir=spill_dir)
  mat.materialize()
  rep = dict(materialize_spill_s=time.perf_counter() - t0,
             spilled=sorted(mat.spilled))
  assert rep['spilled'] == [str(i) for i in range(len(FANOUTS))], rep
  base = mat.embedding_store()
  hot, warm = int(n * TIER_HOT), int(n * TIER_WARM)
  stores = dict(
      tiered=mat.tiered_embedding_store(hot_rows=hot, warm_rows=warm),
      restart_tiered=warm_embedding_store(spill_dir, n, hot_rows=hot,
                                          warm_rows=warm, device=device),
      restart=warm_embedding_store(spill_dir, n, device=device))
  lookups = [b for c in range(CLIENTS)
             for ids in serve_requests(np.random.default_rng(100 + c), n)
             for b in buckets_of(ids)]
  want = [base.fetch(base.lookup(np.maximum(ids, 0), mask))
          for ids, mask in lookups]
  for name, store in stores.items():
    for ids, mask in lookups[:4]:        # warm-up
      store.fetch(store.lookup(ids, mask))
    ops.reset_launch_counts()
    ms, equal = [], 0
    for (ids, mask), w in zip(lookups, want):
      t = time.perf_counter()
      rows = store.fetch(store.lookup(ids, mask))
      ms.append((time.perf_counter() - t) * 1e3)
      equal += bool(np.array_equal(rows, w))
    counts = ops.launch_counts()
    rec = dict(lookups=len(lookups), equal=equal, launches=counts,
               ms_p50=float(np.percentile(ms, 50)),
               ms_p99=float(np.percentile(ms, 99)))
    if cuda:
      def run(store=store):
        return [store.lookup(ids, mask)
                for ids, mask in lookups[:SERVE_TIER_SYNC_LOOKUPS]]
      _, syncs, kinds = count_syncs(torch, run)
      torch.cuda.synchronize()
      rec.update(syncs_per_lookup=syncs / SERVE_TIER_SYNC_LOOKUPS,
                 sync_kinds=kinds)
    rep[name] = rec
    log(f'tiered serving {name}: {equal}/{len(lookups)} lookups equal to '
        f'embedding_store()\'s; lookup+fetch ms p50 {rec["ms_p50"]:.3f} p99 '
        f'{rec["ms_p99"]:.3f}; host syncs per lookup '
        f'{rec.get("syncs_per_lookup")}; launches {counts} on {smi}')
    assert equal == len(lookups), (name, equal)
    if name != 'restart':
      assert counts['gather_unified'] == (1 if cuda else 0) * len(lookups)
      assert rec.get('syncs_per_lookup', 0) == 0, rec
  ms = []
  for ids, mask in lookups:
    t = time.perf_counter()
    base.fetch(base.lookup(np.maximum(ids, 0), mask))
    ms.append((time.perf_counter() - t) * 1e3)
  rep['embedding_store'] = dict(ms_p50=float(np.percentile(ms, 50)),
                                ms_p99=float(np.percentile(ms, 99)))
  log(f'tiered serving: embedding_store() lookup+fetch ms p50 '
      f'{rep["embedding_store"]["ms_p50"]:.3f} p99 '
      f'{rep["embedding_store"]["ms_p99"]:.3f}; materialize with the spill '
      f'{rep["materialize_spill_s"]:.1f} s')
  return rep


def tiered_phase(torch, gtt, ds, topo, feats, device, caps, smi):
  """The out-of-core store: the products table in three tiers under the
  tree (held epochs, degraded, timed, sync-counted, profiled) and merge
  (a free epoch, then a held one) tiered trainers against the
  all-device ScanTrainer;
  the papers example's three-tier mode; the spilled serving stores. Disk
  tiers are written under one temporary directory, removed at the end
  (the page cache is not controlled: the tiers were written by this
  process just before they are read)."""
  import gc
  import shutil
  import tempfile
  cuda = device.type == 'cuda'
  n = topo.num_nodes
  tmp = tempfile.mkdtemp(prefix='gtt_tiered_')
  rep = {}
  try:
    t0 = time.perf_counter()
    re, id2index = gtt.data.sort_by_in_degree(feats, TIER_HOT, topo)
    hot, warm = int(n * TIER_HOT), int(n * TIER_WARM)
    store = gtt.storage.TieredFeature(re, hot_rows=hot, warm_rows=warm,
                                      id2index=id2index,
                                      spill_dir=f'{tmp}/products',
                                      device=device)
    del re
    tds = gtt.data.Dataset(graph=ds.graph, node_features=store,
                           node_labels=ds.node_labels, device=device)
    rep['store'] = dict(tiers=store.tier_occupancy(),
                        build_s=time.perf_counter() - t0,
                        hot_bytes=hot * FEAT_DIM * 4,
                        warm_bytes=warm * FEAT_DIM * 4,
                        disk_bytes=store.disk_rows * FEAT_DIM * 4)
    log(f'tiered store: {rep["store"]["tiers"]} rows ({hot * FEAT_DIM * 4} '
        f'B on the card, {warm * FEAT_DIM * 4} B mapped, '
        f'{store.disk_rows * FEAT_DIM * 4} B of npy chunks) built in '
        f'{rep["store"]["build_s"]:.1f} s')
    steps = TIER_STEPS if cuda else 4
    chunk = TIER_CHUNK if cuda else 2
    pool = np.random.default_rng(11).permutation(n)[:BATCH * steps]
    for mode, epochs in (('tree', 2), ('merge', 2)):
      t0 = time.perf_counter()
      rep[mode] = tiered_training(torch, gtt, ds, tds, pool, device, mode,
                                  caps, smi, steps, chunk, epochs)
      rep[mode]['phase_s'] = time.perf_counter() - t0
      gc.collect()
    del tds, store
    gc.collect()
    t0 = time.perf_counter()
    rep['papers'] = papers_tiered_path(torch, gtt, device, smi,
                                       f'{tmp}/papers')
    rep['papers']['phase_s'] = time.perf_counter() - t0
    gc.collect()
    if cuda:
      torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep['serving'] = tiered_serving(torch, gtt, ds, device, topo, smi,
                                    f'{tmp}/serving')
    rep['serving']['phase_s'] = time.perf_counter() - t0
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  return rep


def probe_phase(torch, device, reps, smi, profile=False):
  """Both probe suites at their sizes (their kernels' launch counters set
  to 0 before and read after), then the two probe kernels against their
  plain versions and a library call at the probes' shapes; the take at
  every cluster size. With ``profile``, torch.profiler over 10 takes at
  each cluster size and 10 ``torch.take`` calls."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.benchmarks import common, prof_dedup, prof_mem
  cuda = device.type == 'cuda'
  shrink = 1 if cuda else 64
  ops.reset_launch_counts()
  rep = dict(prof_mem=prof_mem.run(device, shrink=shrink),
             prof_dedup=prof_dedup.run(device, shrink=shrink))
  rep['launches'] = ops.launch_counts()
  for name in ('prof_mem', 'prof_dedup'):
    common.print_table(rep[name], f'probe suite {name} on {smi}')
  if cuda:
    assert rep['launches']['row_gather_probe_bulk'] > 0 and \
        rep['launches']['smem_take'] > 0, rep['launches']
  # ---- B6 at prof_mem's probe G shape: the bulk route, and the vector
  # route on a copy of the table 4 bytes past a 16-byte boundary
  gen = torch.Generator().manual_seed(6)
  n = prof_mem.N // shrink
  feat = torch.randn((n, prof_mem.WIDTH), generator=gen).to(device)
  ids = torch.randint(0, n, (prof_mem.ROWS // shrink,), generator=gen,
                      dtype=torch.int32).to(device)
  ids64 = ids.long()
  feat_off = torch.empty(feat.numel() + 1, device=device)[1:].view(
      feat.shape)
  feat_off.copy_(feat)
  routes = (ops.row_gather_route(feat), ops.row_gather_route(feat_off))
  before = ops.launch_counts()
  got, ms, call_ms = timed(torch, lambda: ops.row_gather_probe(feat, ids),
                           reps, device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: ops.row_gather_probe_plain(feat, ids), reps, device)
  vgot, vec_ms, vec_call_ms = timed(
      torch, lambda: ops.row_gather_probe(feat_off, ids), reps, device)
  _, lib_ms, lib_call_ms = timed(
      torch, lambda: torch.index_select(feat, 0, ids64), reps, device)
  _, k1_ms, k1_call_ms = timed(torch, lambda: ops.gather_rows_hbm(feat, ids),
                               reps, device)
  after = ops.launch_counts()
  exact = bool(torch.equal(got, ref)) and bool(torch.equal(vgot, ref))
  row = feat.shape[1] * 4
  uniq = int(torch.unique(ids64).numel())
  nbytes = ids.numel() * 4 + uniq * row + ids.numel() * row
  rates = {name: dict(gb_per_s=nbytes / t / 1e6,
                      m_rows_per_s=ids.numel() / t / 1e3)
           for name, t in (('bulk', ms), ('vector', vec_ms), ('k1', k1_ms),
                           ('index_select', lib_ms))}
  # each row is one bulk copy in and one out
  copies_per_s = 2 * ids.numel() / ms * 1e3
  rep['row_gather_probe'] = dict(
      ids=ids.numel(), table=list(feat.shape), unique_rows=uniq, exact=exact,
      routes=dict(aligned=routes[0], offset=routes[1]),
      route_launches={k: after[k] - before[k] for k in
                      ('row_gather_probe_bulk', 'row_gather_probe_vector')},
      max_abs_err=float(max((got - ref).abs().max(), (vgot - ref).abs().max())),
      ms=ms, call_ms=call_ms, vector_ms=vec_ms, vector_call_ms=vec_call_ms,
      plain_ms=plain_ms, plain_call_ms=plain_call_ms, library_ms=lib_ms,
      library_call_ms=lib_call_ms, k1_ms=k1_ms, k1_call_ms=k1_call_ms,
      rates=rates, **bound_record(nbytes, None, fill_ms(torch, [got], device,
                                                        reps), ms),
      bulk_copies_per_s=copies_per_s,
      removed_designs_ms=B6_REMOVED_DESIGNS_MS)
  log(f'kernel row_gather_probe: ids={ids.numel()} table={list(feat.shape)} '
      f'routes {routes} exact={exact} ms={ms:.4f} (bulk) '
      f'vector_ms={vec_ms:.4f} plain_ms={plain_ms:.4f} '
      f'index_select_ms={lib_ms:.4f} k1_ms={k1_ms:.4f} '
      f'{bound_text(rep["row_gather_probe"])}; call ms {call_ms:.4f} '
      f'{vec_call_ms:.4f} {plain_call_ms:.4f} {lib_call_ms:.4f} '
      f'{k1_call_ms:.4f}; launches per route '
      f'{rep["row_gather_probe"]["route_launches"]}')
  log('kernel row_gather_probe rates: ' + '; '.join(
      f'{k} {v["gb_per_s"]:.1f} GB/s {v["m_rows_per_s"]:.1f} M rows/s'
      for k, v in rates.items()) +
      f'; {copies_per_s / 1e9:.3f} G bulk copies/s of {row} B; the designs '
      f'it replaced, measured on an NVIDIA H100 80GB HBM3 at 700 W before '
      f'their removal (ms): {B6_REMOVED_DESIGNS_MS}')
  assert exact, 'row_gather_probe: kernel != plain version'
  if cuda:
    assert routes == ('bulk', 'vector'), routes
  # ---- B5 at prof_dedup's probe shape
  s = prof_dedup.S // shrink // 512 * 512
  table = torch.randint(0, 2 ** 30, (prof_dedup.TN,), generator=gen,
                        dtype=torch.int32).to(device)
  idx = torch.randint(0, prof_dedup.TN, (s // 128, 128), generator=gen,
                      dtype=torch.int32).to(device)
  idx64 = idx.long()
  got, ms, call_ms = timed(torch, lambda: ops.smem_take(table, idx), reps,
                           device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: ops.smem_take_plain(table, idx), reps, device)
  lib, lib_ms, lib_call_ms = timed(torch, lambda: torch.take(table, idx64),
                                   reps, device)
  exact = bool(torch.equal(got, ref)) and bool(torch.equal(got, lib))
  nbytes = 2 * s * 4 + table.numel() * 4
  # every cluster size, each beside torch.take in turn (kernel, take)
  clusters = {}
  for c in ops.probes.SMEM_TAKE_CLUSTERS:
    cgot, c_ms, c_call_ms = timed(
        torch, lambda: ops.smem_take(table, idx, cluster=c), reps, device)
    _, t_ms, t_call_ms = timed(torch, lambda: torch.take(table, idx64), reps,
                               device)
    same = bool(torch.equal(cgot, ref))
    clusters[c] = dict(ms=c_ms, call_ms=c_call_ms, torch_take_ms=t_ms,
                       torch_take_call_ms=t_call_ms, exact=same,
                       staged_bytes=_smem_ctas(torch, device, c) *
                       table.numel() * 4 // c)
    log(f'kernel smem_take cluster={c}: exact={same} ms={c_ms:.4f} '
        f'(call {c_call_ms:.4f}) torch_take_ms={t_ms:.4f} (call '
        f'{t_call_ms:.4f}); table staged over the card '
        f'{clusters[c]["staged_bytes"]} B on {smi}')
    assert same, f'smem_take cluster {c}: kernel != plain version'
  rep['smem_take'] = dict(
      ids=s, table=table.numel(), cluster=ops.probes.SMEM_TAKE_CLUSTER,
      exact=exact, max_abs_err=float((got - ref).abs().max()), ms=ms,
      call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
      library_ms=lib_ms, library_call_ms=lib_call_ms, clusters=clusters,
      **bound_record(nbytes, None, fill_ms(torch, [got], device, reps), ms))
  log(f'kernel smem_take: ids={list(idx.shape)} table={table.numel()} '
      f'cluster={ops.probes.SMEM_TAKE_CLUSTER} '
      f'exact={exact} ms={ms:.4f} plain_ms={plain_ms:.4f} '
      f'torch_take_ms={lib_ms:.4f} {bound_text(rep["smem_take"])}; call ms '
      f'{call_ms:.4f} {plain_call_ms:.4f} {lib_call_ms:.4f}')
  assert exact, 'smem_take: kernel != plain version'
  if profile:
    rep['smem_take']['profiles'] = {
        label: profiled(torch, lambda: [fn() for _ in range(10)], 1, device,
                        f'probe phase: 10 x {label}')
        for label, fn in [
            (f'smem_take cluster {c}',
             lambda c=c: ops.smem_take(table, idx, cluster=c))
            for c in ops.probes.SMEM_TAKE_CLUSTERS] + [
            ('torch.take', lambda: torch.take(table, idx64))]}
  return rep


def _smem_ctas(torch, device, cluster):
  """CTAs the take launches at the probe's size: one per SM, in whole
  clusters (the kernel's own rule; the ids fill every cluster)."""
  if device.type != 'cuda':
    return 0
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  return sms // cluster * cluster


LINT_TIMEOUT_S = 300   # the analyzer's child, a whole-package walk


def lint_start() -> dict:
  """Starts the port's analyzer over the package of this checkout,
  through its CLI in a child process (host CPU only), from a thread that
  waits for it: the phases run meanwhile, and ``lint_phase`` reads it.
  The child is killed at the script's exit if it is still running."""
  import atexit
  root = os.path.dirname(os.path.abspath(__file__))
  run = dict(t0=time.perf_counter())
  proc = subprocess.Popen(
      [sys.executable, '-m', 'graphlearn_tpu_torch.analysis.lint',
       '--format', 'json', '--timings', 'graphlearn_tpu_torch/'],
      cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
  atexit.register(lambda: proc.poll() is None and proc.kill())

  def wait():
    try:
      run['out'] = proc.communicate(timeout=LINT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
      proc.kill()
      run['out'] = proc.communicate()
    run['wall'] = time.perf_counter() - run['t0']

  run['proc'], run['thread'] = proc, threading.Thread(target=wait,
                                                      daemon=True)
  run['thread'].start()
  return run


def lint_phase(smi, run) -> dict:
  """The analyzer's child (``lint_start``) read: exit 0 and 0 findings
  asserted; the files walked, the pragma-suppressed count, the child's
  wall and each rule's host seconds."""
  run['thread'].join()
  proc, wall = run['proc'], run['wall']
  stdout, stderr = run['out']
  if proc.returncode != 0:
    raise AssertionError(f'lint: exit {proc.returncode}\n{stdout}{stderr}')
  doc = json.loads(stdout)
  assert doc['findings'] == [] and doc['baselined'] == 0, doc['findings']
  rule_s = {r: ms / 1e3 for r, ms in doc['timings_ms'].items()}
  rep = dict(rc=proc.returncode, files=doc['files'],
             findings=len(doc['findings']),
             pragma_suppressed=doc['pragma_suppressed'], wall_s=wall,
             rule_s=rule_s)
  log(f'lint: python -m graphlearn_tpu_torch.analysis.lint over '
      f'{doc["files"]} files: exit 0, 0 findings, '
      f'{doc["pragma_suppressed"]} pragma-suppressed, baseline empty; '
      f'{wall:.1f} s wall in a child process (host CPU, not the card; '
      f'run beside the phases since the set-up), rules '
      f'{sum(rule_s.values()):.1f} s on {smi}')
  log('lint per-rule host s: ' + json.dumps(
      {r: round(v, 3) for r, v in sorted(rule_s.items(),
                                         key=lambda kv: -kv[1])}))
  return rep


# the multicard phase: a DeviceGroup store sharded over every card (one
# card named twice where there is one) and a DistScanTrainer captured
# under an NCCL group of one rank per card
MC_SPLITS = (1.0, 0.25)               # a full and a mixed grouped split
NVLINK_BYTES_PER_S = 450e9            # H100 NVLink, one way per card
MC_STEPS, MC_CHUNK = 8, 4             # the captured group epoch: steps, K
MC_TIMEOUT_S = 600                    # the ranks' join limit


def multicard_group(torch, device):
  """``(devices, verdicts)``: the group of every card (``cuda:0`` named
  twice on one card; the CPU twice in a rehearsal) and, for each ordered
  pair of distinct cards, whether one can read the other's memory."""
  if device.type != 'cuda':
    return [device, device], {}
  cards = torch.cuda.device_count()
  if cards == 1:
    return [torch.device('cuda', 0)] * 2, {}
  verdicts = {f'cuda:{a}->cuda:{b}': torch.cuda.can_device_access_peer(a, b)
              for a in range(cards) for b in range(cards) if a != b}
  return [torch.device('cuda', i) for i in range(cards)], verdicts


def sharded_case(torch, gtt, feats, split, group, rows, node, device, reps,
                 rate, smi):
  """One grouped store at ``split`` over ``group``: the store's lookup of
  one tree batch's node ids (counted: one sharded launch), then its
  kernel (the sharded K1 entry, or the sharded hot/cold entry with a
  host tail) on the batch's rows against its plain version, bit for bit,
  timed beside the one-table kernel on the same rows, with the bound:
  the larger of the HBM bytes over 3.35 TB/s, the remote rows' bytes
  over NVLink's one-way rate and (a host tail) the distinct cold rows'
  bytes over the measured pinned rate."""
  import gc

  from graphlearn_tpu_torch import ops
  cuda = device.type == 'cuda'
  t0 = time.perf_counter()
  current = torch.cuda.current_device() if cuda else None
  store = gtt.data.Feature(feats, split, device_group_list=[
      gtt.data.DeviceGroup(0, group)], device=device)
  store.lazy_init()
  ut = store.unified
  part = ut.device_part
  shards, cold = part.shards, ut.host_part
  ops.reset_launch_counts()
  looked = store[node]
  if cuda:
    torch.cuda.synchronize()
    # placing the group (peer access) and its lookup leave the caller's
    # current card as it was: an unindexed 'cuda' still means cuda:0
    assert torch.cuda.current_device() == current, (
        'grouped store moved the current device', current,
        torch.cuda.current_device())
  launches = ops.launch_counts()
  want_x = torch.as_tensor(feats)[node.clamp(min=0).long().cpu()]
  assert torch.equal(looked.cpu(), want_x), f'grouped store {split}: rows'
  name = 'gather_unified_sharded' if ut.host_rows else 'gather_rows_sharded'
  assert launches[name] == (1 if cuda else 0), (split, launches)
  if ut.host_rows:
    def kern():
      return ops.gather_rows_unified_sharded(shards, part.pointers, cold,
                                             rows)

    def plain():
      return ops.gather_rows_unified_sharded_plain(shards, cold, rows)[0]
    one = gtt.data.Feature(feats, split, device=device)
    one.lazy_init()
    hot1, cold1 = one.unified._hot(), one.unified.host_part

    def one_table():
      return ops.gather_rows_unified(hot1, cold1, rows)
  else:
    def kern():
      return ops.gather_rows_sharded(shards, part.pointers, rows)

    def plain():
      return ops.gather_rows_sharded_plain(shards, rows)
    table = torch.as_tensor(feats).to(device)

    def one_table():
      return ops.gather_rows_hbm(table, rows)
  got, ms_runs, call_runs = timed3(torch, kern, reps, device)
  fetched = (int(ops.gather.unified_sharded_fetches)
             if cuda and ut.host_rows else None)
  ms, call_ms = float(np.median(ms_runs)), float(np.median(call_runs))
  ref, plain_ms, plain_call_ms = timed(torch, plain, reps, device)
  _, k1_ms, k1_call_ms = timed(torch, one_table, reps, device)
  # the library yardstick: each shard's index_select of the rows it owns
  # (no placement into the batch's order)
  rps = part.rows_per_shard
  n_hot = rps * len(shards)
  hot_rows = rows[rows < n_hot].long()
  local = [(s, (hot_rows[hot_rows // rps == i] - i * rps).to(s.device))
           for i, s in enumerate(shards)]
  _, lib_ms, _ = timed(torch, lambda: [s.index_select(0, r)
                                       for s, r in local], reps, device)
  if cuda:
    torch.cuda.synchronize()
  exact = bool(torch.equal(got, ref))
  err = float((got.float() - ref.float()).abs().max())
  fill = fill_ms(torch, [got], device, reps)
  row = shards[0].shape[1] * shards[0].element_size()
  uniq = torch.unique(rows.clamp(0, ut.size - 1))
  uhot = uniq[uniq < n_hot]
  n_cold_u = int(uniq.numel() - uhot.numel())
  remote_u = int(sum(int((uhot // rps == i).sum())
                     for i, s in enumerate(shards) if s.device != part.device))
  hbm = rows.numel() * rows.element_size() + uhot.numel() * row + \
      rows.numel() * row
  times = [hbm / H100_BYTES_PER_S, remote_u * row / NVLINK_BYTES_PER_S]
  if n_cold_u:
    times.append(n_cold_u * row / rate)
  bound = max(times) * 1e3
  # every slot's row read and written (no dedup), for the sharded K1 entry
  every = bound_ms(rows.numel() * rows.element_size() +
                   2 * rows.numel() * row)
  rec = dict(split=split, group=[str(d) for d in group], kernel=name,
             hot_rows=n_hot, rows_per_shard=rps, ids=rows.numel(),
             remote_distinct_rows=remote_u, distinct_cold_rows=n_cold_u,
             fetched_rows=fetched, exact=exact, max_abs_err=err, ms=ms,
             call_ms=call_ms, ms_runs=ms_runs, call_ms_runs=call_runs,
             plain_ms=plain_ms, plain_call_ms=plain_call_ms,
             one_table_ms=k1_ms, one_table_call_ms=k1_call_ms,
             bound_ms=bound, bound_by='bytes', every_slot_ms=every,
             fill_ms=fill, library_ms=None if ut.host_rows else lib_ms,
             shard_index_select_ms=lib_ms, lookup_launches=launches,
             case_s=time.perf_counter() - t0)
  log(f'multicard {name} split={split} over {rec["group"]} ({rps} rows a '
      f'shard, {n_hot} hot of {ut.size}): ids={rows.numel()} exact={exact} '
      f'ms={ms:.4f} (runs ' + ' '.join(f'{t:.4f}' for t in ms_runs) +
      f') call_ms={call_ms:.4f}; plain ms={plain_ms:.4f}; '
      f'the one-table kernel ms={k1_ms:.4f}; the shards\' index_select '
      f'ms={lib_ms:.4f}; bound_ms={bound:.4f} (HBM {hbm / 1e6:.1f} MB, '
      f'{remote_u} distinct remote rows, {n_cold_u} distinct cold rows, '
      f'fetched {fetched}); every_slot_ms={every:.4f} fill_ms={fill:.4f}; '
      f'the store\'s lookup '
      f'launched {launches[name]} on {smi}')
  assert exact, f'{name} split={split}: kernel != plain version'
  assert fetched is None or fetched == n_cold_u, (
      name, 'fetched', fetched, 'distinct cold rows', n_cold_u)
  del store, ut, part, shards, cold, got, ref, looked
  gc.collect()
  return rec


def multicard_rank(rank, world, port, n_nodes, device_names, outdir, smi,
                   go=None):
  """One rank of the captured group epoch (a spawned child on
  ``device_names[rank]``): the script's graph (the parent's arrays, read
  from ``outdir``, ``save_graph``) in ``world`` shards, built on the host
  before the card is touched, then, once ``go`` is set, one held here under ``init_multihost`` (NCCL on a
  card), the dist_scan cell's trainer at ``bucket_frac=None`` (FANOUTS at
  BATCH seeds a shard, the example's GraphSAGE at hidden HIDDEN,
  MC_STEPS steps in chunks of MC_CHUNK): a captured epoch and an eager
  one from the same weights, bit-equal (losses and parameters); at world
  1 also the one-process mesh at P = 1, captured, bit-equal; then a
  timed replayed epoch (ms/step) and a profiled one (idle share). Writes
  ``rank{rank}.json`` to ``outdir``."""
  import traceback

  import torch
  try:
    import torch.distributed as dist

    import graphlearn_tpu_torch as gtt
    from graphlearn_tpu_torch import distributed as gdist
    from graphlearn_tpu_torch import ops
    from graphlearn_tpu_torch.examples import (
        dist_train_sage_supervised as ex)
    from graphlearn_tpu_torch.models import create_train_state
    device = torch.device(device_names[rank])
    cuda = device.type == 'cuda'
    if cuda:
      torch.backends.cuda.matmul.allow_tf32 = False
      torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ei, feats, labels = load_graph(outdir)
    n = n_nodes
    b = BATCH if cuda else 64
    steps = MC_STEPS if cuda else 4
    chunk = MC_CHUNK if cuda else 2
    pb = dist_book(n, world)
    parts, fparts = ex.partition_in_memory(ei, feats, pb, world)
    hot = np.bincount(ei[1], minlength=n)
    labels = np.array(labels)
    del ei, feats
    build_s = time.perf_counter() - t0
    if go is not None:
      go.wait()
    ctx = gdist.init_multihost(f'localhost:{port}', world, rank,
                               device=device)
    rep = dict(rank=rank, world=world, device=str(device),
               backend=dist.get_backend(), build_s=build_s,
               go_wait_s=time.perf_counter() - t0 - build_s)
    try:
      pool = np.random.default_rng(12).permutation(n)[:world * b * steps]

      def dataset(mesh):
        return gdist.DistDataset(
            world, 0, gdist.DistGraph(world, 0, parts, pb),
            gdist.DistFeature(world, fparts, pb, mesh, split_ratio=DIST_CACHE,
                              hotness=hot, bucket_frac=None),
            node_labels=labels)

      def trainer(ds, capture):
        loader = gdist.DistNeighborLoader(
            ds, FANOUTS, pool, batch_size=b, shuffle=False, drop_last=True,
            seed=0, mesh=ds.node_features.mesh, dedup='tree',
            bucket_frac=None)
        model = ex.make_model(FEAT_DIM, HIDDEN, CLASSES, FANOUTS, b, device,
                              torch.Generator().manual_seed(0))
        return gtt.loader.DistScanTrainer(loader, model, CLASSES,
                                          chunk_size=chunk, capture=capture)

      ds = dataset(ctx.mesh)
      runs = {'captured': trainer(ds, True if cuda else None),
              'eager': trainer(ds, False)}
      if world == 1:
        runs['one_process'] = trainer(dataset(gdist.ShardMesh(1, device)),
                                      True if cuda else None)
      states, out = {}, {}
      for name, t in runs.items():
        st = create_train_state(t.model, lr=LR)
        st, losses, _, ms, counts = dscan_epoch(torch, t, st, cuda)
        states[name] = st
        out[name] = dict(losses=losses.cpu(), ms=ms, counts=counts,
                         params={k: v.detach().cpu() for k, v in
                                 t.model.state_dict().items()})
      ref = out['captured']
      rep['captured'] = runs['captured'].capture
      rep['launches'] = ref['counts']
      want = dict(sample_hop=len(FANOUTS) * steps if cuda else 0,
                  gather_rows=3 * steps if cuda else 0,
                  dist_step_keys=-(-steps // chunk) if cuda else 0)
      for k, v in want.items():
        assert ref['counts'][k] == v, ('multicard launches', k, ref['counts'])
      rep['equal'] = {}
      for name in out:
        if name == 'captured':
          continue
        diff = max(float((ref['params'][k] - v).abs().max())
                   for k, v in out[name]['params'].items())
        same = (torch.equal(ref['losses'], out[name]['losses']) and
                diff == 0.0)
        rep['equal'][name] = dict(bit_equal=same, max_param_diff=diff)
      rep['losses'] = ref['losses'].tolist()
      cap = runs['captured']
      rep['capture_ms'] = cap.capture_ms
      st, _, _, ms, counts = dscan_epoch(torch, cap, states['captured'],
                                         cuda)
      states['captured'] = st
      rep['ms_per_step'] = ms / steps
      rep['eager_ms_per_step'] = out['eager']['ms'] / steps
      if cuda:
        def epoch():
          states['captured'] = cap.run_epoch(states['captured'])[0]
        prof = profiled(torch, epoch, 1, device, 'multicard captured epoch',
                        warmup=epoch)
        rep['idle_share'] = prof['idle_share']
        rep['busy_ms_per_step'] = prof['device_busy_ms'] / steps
      rep['steps'], rep['chunk'], rep['batch'] = steps, chunk, b
    finally:
      dist.destroy_process_group()
    rep['ok'] = True
  except BaseException:
    rep = dict(rank=rank, ok=False, error=traceback.format_exc())
  with open(os.path.join(outdir, f'rank{rank}.json'), 'w') as fh:
    json.dump(rep, fh)
  if not rep['ok']:
    sys.exit(1)


def multicard_spawn(torch, gtt, graph, device, smi) -> dict:
  """Starts the captured group epoch's ranks: one spawned rank per card
  (world 1 on one card; two CPU ranks over gloo in a rehearsal), each
  running ``multicard_rank`` on ``graph`` (``(ei, feats, labels)``,
  written once to the ranks' temporary directory). They build their
  shards on the host and wait for ``go`` before they touch a card."""
  import multiprocessing as mp
  import tempfile
  cuda = device.type == 'cuda'
  world = torch.cuda.device_count() if cuda else 2
  names = ([f'cuda:{r}' for r in range(world)] if cuda else ['cpu'] * world)
  outdir = tempfile.mkdtemp(prefix='glt_multicard_')
  t0 = time.perf_counter()
  save_graph(outdir, *graph)
  ctx = mp.get_context('spawn')
  go = ctx.Event()
  port = gtt.utils.get_free_port()
  procs = [ctx.Process(target=multicard_rank,
                       args=(r, world, port, graph[1].shape[0], names, outdir,
                             smi, go))
           for r in range(world)]
  for p in procs:
    p.start()
  return dict(world=world, names=names, outdir=outdir, procs=procs, go=go,
              t0=t0)


def multicard_epoch(torch, gtt, device, smi, started):
  """The captured group epoch of the ranks ``multicard_spawn`` started:
  ``go`` set, every rank must finish, bit-equal."""
  import shutil
  world, names, outdir, procs = (started[k] for k in (
      'world', 'names', 'outdir', 'procs'))
  t0 = started['t0']
  try:
    started['go'].set()
    deadline = time.perf_counter() + MC_TIMEOUT_S
    for p in procs:
      p.join(max(1.0, deadline - time.perf_counter()))
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
      if p.is_alive():
        p.kill()
        p.join()
    reps = []
    for r in range(world):
      path = os.path.join(outdir, f'rank{r}.json')
      reps.append(json.load(open(path)) if os.path.exists(path) else
                  dict(rank=r, ok=False, error='no report'))
  finally:
    shutil.rmtree(outdir, ignore_errors=True)
  bad = [r for r in reps if not r.get('ok')]
  assert not alive and not bad, (alive, [r.get('error') for r in bad])
  for r in reps:
    for name, eq in r['equal'].items():
      assert eq['bit_equal'], (r['rank'], name, eq)
  r0 = reps[0]
  log(f'multicard group epoch: {world} rank(s) ({r0["backend"]}) on '
      f'{names}, {r0["steps"]} steps of {r0["batch"]} seeds a shard in '
      f'chunks of {r0["chunk"]}, captured {r0["captured"]}: bit-equal '
      f'{ {k: v["bit_equal"] for k, v in r0["equal"].items()} }; '
      f'{r0["ms_per_step"]:.3f} ms/step captured (eager epoch 1 '
      f'{r0["eager_ms_per_step"]:.3f}), idle share '
      f'{r0.get("idle_share", float("nan")):.1%}; launches '
      f'{ {k: v for k, v in r0["launches"].items() if v} }; phase '
      f'{time.perf_counter() - t0:.1f} s on {smi}')
  return dict(world=world, devices=names, ranks=reps,
              seconds=time.perf_counter() - t0)


def multicard_phase(torch, gtt, graph, ds, pool, device, reps, rate, smi):
  """The several-card path: the group (every card; ``cuda:0`` twice on
  one card) and each pair's peer-access verdict, then (a) the grouped
  store at MC_SPLITS on a tree batch (``sharded_case``) and (b) the
  captured group epoch (``multicard_epoch``), whose ranks start first
  and build their shards on the host while (a) runs. ``rate``: the
  pinned copy rate, measured before the ranks started."""
  cuda = device.type == 'cuda'
  feats = graph[1]
  started = multicard_spawn(torch, gtt, graph, device, smi)
  try:
    group, verdicts = multicard_group(torch, device)
    count = torch.cuda.device_count() if cuda else 0
    log(f'multicard: torch.cuda.device_count()={count}; group '
        f'{[str(d) for d in group]}; peer access '
        f'{verdicts or "none needed (one card named twice)"}')
    assert all(verdicts.values()), verdicts
    rows = tree_batch_rows(torch, gtt, ds, np.arange(feats.shape[0]), pool,
                           device)
    rep = dict(device_count=count, group=[str(d) for d in group],
               peer_access=verdicts, cases=[], pinned_rate=rate)
    log(f'multicard: pinned host-to-device copy {rate / 1e9:.2f} GB/s, '
        f'measured before the ranks started, on {smi}')
    for split in MC_SPLITS:
      rep['cases'].append(sharded_case(torch, gtt, feats, split, group, rows,
                                       rows, device, reps, rate, smi))
    rep['launch_runs'] = [c['lookup_launches'] for c in rep['cases']]
  except BaseException:
    # no rank is left waiting for go
    for p in started['procs']:
      p.kill()
      p.join()
    shutil.rmtree(started['outdir'], ignore_errors=True)
    raise
  rep['epoch'] = multicard_epoch(torch, gtt, device, smi, started)
  rep['launch_runs'] += [r['launches'] for r in rep['epoch']['ranks']]
  rep['across_cards'] = count > 1
  return rep


def never_redesigned_ranking(ktab, dkeys, nloc, shapes) -> dict:
  """The kernels never redesigned at each shape the kernel phase times,
  each with its time, yardstick (the larger of the bound and the fill
  floor), the yardstick's share of the time, and this process's launches
  at that shape after the kernel phase (``shapes``: ``ShapeTally``'s).
  ``ranked``: the shapes the script's paths launched, by launches times
  the gap to the yardstick; ``not_launched``: timed shapes no path
  launched (a stress case); ``untimed``: launches at shapes no case
  times."""
  cases = [('uniform_draw', r['shape'], [r['words']], r)
           for r in ktab['uniform_draw']]
  cases += [('step_keys', [ktab['step_keys']['steps'],
                           ktab['step_keys']['hops']], None,
             ktab['step_keys']),
            ('dist_step_keys', [dkeys['steps'], dkeys['parts'],
                                dkeys['hops']], None, dkeys)]
  cases += [('negative_sample', [r['candidates']], None, r)
            for r in ktab['negative_sample']]
  cases += [('negative_sample_local', [nloc['candidates']], None, nloc)]
  left = {k: dict(v) for k, v in shapes.items()}
  ranked, idle = [], []
  for name, shape, key, r in cases:
    n = left.get(name, {}).pop(json.dumps(key or shape), 0)
    yard = r['yardstick_ms']
    row = dict(kernel=name, shape=shape, launches=n, ms=r['ms'],
               bound_ms=r['bound_ms'], bound_by=r['bound_by'],
               fill_ms=r['fill_ms'], yardstick_ms=yard,
               share=yard / r['ms'],
               launches_x_gap_ms=n * max(r['ms'] - yard, 0.0))
    (ranked if n else idle).append(row)
  return dict(ranked=sorted(ranked, key=lambda r: -r['launches_x_gap_ms']),
              not_launched=idle,
              untimed={k: v for k, v in left.items() if v})


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--out', default=None, help='also write the report here')
  ap.add_argument('--rehearse', action='store_true',
                  help='CPU, tiny size, plain versions; no result line')
  ap.add_argument('--noise', default=None, metavar='WINDOWS,RUNS[,TYPED]',
                  help='measure the profiler windows and the merge step '
                  'noise (TYPED typed RGAT runs, default RUNS) instead of '
                  'the phases; no result line')
  ap.add_argument('--profile', action='store_true',
                  help='also trace each phase with torch.profiler')
  args = ap.parse_args(argv)
  global SM_CLOCK_HZ
  t_start = time.perf_counter()
  import torch
  if not args.rehearse and not torch.cuda.is_available():
    print('chip_smoke: no CUDA device is available', file=sys.stderr)
    return 2
  try:
    import graphlearn_tpu_torch as gtt
    from graphlearn_tpu_torch.ops import kernels
  except ImportError as exc:
    print(f'chip_smoke: graphlearn_tpu_torch not importable ({exc}); run '
          'from the root of a checkout', file=sys.stderr)
    return 2
  report = {}
  if args.rehearse:
    device, n_nodes, reps = torch.device('cpu'), 20_000, 2
    smi = 'rehearsal on the CPU (no card)'
  else:
    device, n_nodes, reps = torch.device('cuda'), 1_000_000, REPS
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  log(f'card: {smi}')
  report['card'] = smi
  report['phase_s'] = {}

  def phase_done(name):
    report['phase_s'][name] = time.perf_counter() - t_start
    log(f'phase {name} done at {report["phase_s"][name]:.1f} s')

  t0 = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    build = (pool.submit(kernels.build_all) if not args.rehearse else None)
    ei, feats, labels = make_graph(n_nodes, 25)
    # dyadic edge weights from a seed, for the weighted mode
    weights = (np.random.default_rng(7).integers(1, 9, ei.shape[1]) /
               4).astype(np.float32)
    topo = gtt.data.Topology(ei, num_nodes=n_nodes, edge_weights=weights)
    t_graph = time.perf_counter() - t0
    built = build.result() if build is not None else {}
  report['build_s'] = built
  report['graph_s'] = t_graph
  log(f'graph: N={n_nodes} E={topo.num_edges} built in {t_graph:.1f}s; '
      f'nvcc wall per kernel (s): {built}')
  for name in built:
    seen = set()
    for line in kernels.build_log(name).splitlines():
      line = line.replace('ptxas info    :', '').strip()
      if ('registers' in line or 'spill' in line) and line not in seen:
        seen.add(line)
        log(f'  ptxas {name}: {line}')
  if not args.rehearse:
    # the operation bounds' instructions, from this run's libraries
    SM_CLOCK_HZ = sm_clock_hz()
    SASS_UNITS.update(sass_unit_counts(read_sass(kernels)))
    report['sass_units'] = dict(SASS_UNITS, sm_clock_hz=SM_CLOCK_HZ)
    for unit, c in SASS_UNITS.items():
      log(f'  SASS {unit}: {c["total"]:g} instructions: ALU only '
          f'{c["alu"]:g}, FMA only {c["fma"]:g}, either pipe '
          f'{c["either"]:g}, 3-input adds {c["add3"]:g} (cuobjdump -sass; '
          f'SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz)')

  def dataset(dev, graph=None, dtype=None):
    ds = gtt.data.Dataset(device=dev)
    ds.graph = gtt.data.Graph(topo, device=dev) if graph is None else graph
    ds.init_node_features(feats, dtype=dtype)
    ds.init_node_labels(labels)
    return ds

  ds = dataset(device)
  cpu_ds = dataset(torch.device('cpu'))
  gen = torch.Generator().manual_seed(0)
  phase_done('setup')
  # the analyzer and the padded table's CPU rebuild need no card: their
  # children run beside the phases
  lint = None if args.noise else lint_start()
  rebuild = None if args.noise else padded_rebuild_start(gtt, cpu_ds.graph)
  if args.noise:
    windows, runs, *typed = (int(v) for v in args.noise.split(','))
    report['noise'] = noise_phase(torch, gtt, ds, device, n_nodes, windows,
                                  runs)
    report['noise']['hetero_rgat'] = hetero_noise(
        torch, gtt, device, typed[0] if typed else runs, smi)
    if args.out:
      with open(args.out, 'w') as fh:
        json.dump(report, fh, indent=1)
    log('noise measured: no result line')
    return 3
  pool = np.random.default_rng(1).permutation(n_nodes)[:BATCH * BATCHES]
  report['kernels'] = kernel_phase(torch, gtt, ds, device, gen, reps, pool)
  t0 = time.perf_counter()
  merge_loader = make_loader(gtt, ds, pool, device, 'merge')
  caps = list(merge_loader.sampler.frontier_caps)
  report['calibrated_caps'] = caps
  log(f'merge: frontier_caps={caps} (calibrated in the loader in '
      f'{time.perf_counter() - t0:.1f}s); node slots {BATCH + sum(caps)} '
      f'vs the tree layout\'s '
      f'{gtt.sampler.tree_layout(BATCH, FANOUTS)[0][-1]}')
  report['kernels']['sample_level'] = level_phase(torch, gtt, merge_loader,
                                                  device, gen, reps)
  phase_done('kernels')
  # from here on, the never-redesigned kernels' launches by shape
  if device.type == 'cuda':
    TALLY.install(torch, kernels)
  for mode, loader in (('tree', make_loader(gtt, ds, pool, device, 'tree')),
                       ('merge', merge_loader)):
    per_batch, counts, acc, cross, prof = slice_phase(
        torch, gtt, loader, device, 0, BATCHES, cpu_ds, mode)
    steady = per_batch[1:] or per_batch
    med = {k: float(np.median([p[k] for p in steady])) for k in steady[0]}
    report[mode] = dict(per_batch=per_batch, launches=counts, eval=acc,
                        cross=cross, median_batch_ms=med,
                        profile_sample_batch=prof)
    log(f'{mode} slice: {len(per_batch)} batches + 1 via the loader '
        f'iterator; launches {counts}; eval {acc}; cross-check {cross}')
    for i, p in enumerate(per_batch):
      log(f'  batch {i}: ' + ' '.join(f'{k}={v:.3f}' for k, v in p.items()))
    log(f'{mode} median after the first batch (ms): ' +
        ' '.join(f'{k}={v:.3f}' for k, v in med.items()) +
        f' total={sum(med.values()):.3f} on {smi}')
  if args.profile:
    report['profile'] = {
        mode: profile_phases(torch, gtt, ds, device, mode, caps)
        for mode in ('tree', 'merge')}
  phase_done('slices')
  report['serving'], table = serving_phase(torch, gtt, ds, device, topo, smi,
                                           args.profile)
  runs, report['gather_runs_profiles'] = gather_runs_phase(
      torch, table, n_nodes, device, reps,
      PROBE_ROWS if device.type == 'cuda' else n_nodes, args.profile)
  report['kernels']['gather_runs'] = runs
  del table
  phase_done('serving')
  cuda = device.type == 'cuda'
  steps = TRAIN_STEPS if cuda else 4
  train_pool = np.random.default_rng(4).permutation(n_nodes)[:BATCH * steps]
  for mode in ('tree', 'merge'):
    report[f'train_{mode}'] = train_phase(
        torch, gtt, ds, device, mode, caps, train_pool, steps,
        TRAIN_CHUNK if cuda else 2, smi, args.profile)
    phase_done(f'train_{mode}')
  report['observability'] = observability_phase(torch, gtt, ds, device, caps,
                                                smi)
  phase_done('observability')
  report['tune'] = tune_phase(torch, gtt, ds, device, pool, train_pool, caps,
                              report, smi)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('tune')
  mode_steps = MODE_STEPS if cuda else 4
  mode_pool = np.random.default_rng(6).permutation(n_nodes)[
      :BATCH * mode_steps]
  report['padded_windows'] = padded_window_times(torch, gtt, ds.graph,
                                                 device, gen, reps)
  cpu = torch.device('cpu')
  report['modes'] = modes_phase(
      torch, gtt, {False: ds, True: dataset(device, ds.graph, torch.bfloat16)},
      {False: cpu_ds, True: dataset(cpu, cpu_ds.graph, torch.bfloat16)},
      device, mode_pool, mode_steps, MODE_CHUNK if cuda else 2, smi,
      rebuild=rebuild)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('modes')
  report['link'] = link_phase(torch, gtt, ds, device, smi)
  phase_done('link')
  efeat = np.random.default_rng(10).standard_normal(
      (topo.num_edges, EDGE_FEAT_DIM), dtype=np.float32)
  edge_dss = [gtt.data.Dataset(graph=d.graph, node_features=d.node_features,
                               node_labels=d.node_labels, device=d.device
                               ).init_edge_features(efeat)
              for d in (ds, cpu_ds)]
  del efeat
  report['subgraph'] = subgraph_phase(torch, gtt, *edge_dss, ei, device,
                                      smi)
  del edge_dss
  report['legacy'] = legacy_phase(torch, gtt, ds, cpu_ds, device, pool, smi)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('menu')
  report['hetero'] = hetero_phase(torch, gtt, device, smi)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('hetero')
  report['models'] = models_phase(torch, gtt, ds, topo, device, caps, smi)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('models')
  report['typed_link'] = typed_link_phase(torch, gtt, device, smi)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('typed_link')
  report['partition'] = partition_phase(torch, gtt, ds, cpu_ds, ei, feats,
                                        device, smi)
  phase_done('partition')
  dist_parts = {}
  report['dist'] = dist_phase(torch, gtt, ei, feats, labels, device, smi,
                              keep=dist_parts)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('dist')
  report['dist_scan'] = dist_scan_phase(torch, gtt, ei, feats, labels, device,
                                        smi, built=dist_parts)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('dist_scan')
  report['tune_dist'] = tune_dist_phase(torch, gtt, ds, labels, device, smi,
                                        dist_parts)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('tune_dist')
  report['dist_more'] = dist_more_phase(torch, gtt, ei, feats, topo, device,
                                        smi, built=dist_parts)
  del dist_parts
  if cuda:
    torch.cuda.empty_cache()
  phase_done('dist_more')
  # the papers example's synthetic (the hot/cold and tiered phases build
  # it twice) is drawn by a child while the multicard ranks run
  # the pinned copy rate bounds the grouped store's cold rows: measured
  # before the multicard ranks and the papers draw child load the host
  rate = pinned_rate(torch, device) if cuda else 1.0
  papers_draw = papers_draw_start(cuda)
  report['multicard'] = multicard_phase(torch, gtt, (ei, feats, labels), ds,
                                        pool, device, reps, rate, smi)
  papers_kept = papers_draw_take(papers_draw)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('multicard')
  report['remote'] = remote_phase(torch, gtt, ds, cpu_ds, topo, feats,
                                  labels, device, smi)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('remote')
  report['remote_scan'] = remote_scan_phase(torch, gtt, topo, feats, labels,
                                            cpu_ds, device, smi)
  if cuda:
    torch.cuda.empty_cache()
  phase_done('remote_scan')
  # the papers example's synthetic, drawn once for its two builds
  from graphlearn_tpu_torch.examples import train_sage_papers_scale as pex
  pex.make_graph = SameDraws(pex.make_graph, papers_kept)
  report['hot_cold'] = hot_cold_phase(torch, gtt, ds, topo, feats, pool,
                                      device, reps, smi)
  report['kernels']['gather_unified'] = report['hot_cold']['kernel']
  if cuda:
    torch.cuda.empty_cache()
  phase_done('hot_cold')
  t0 = time.perf_counter()
  report['tiered'] = tiered_phase(torch, gtt, ds, topo, feats, device, caps,
                                  smi)
  report['tiered']['phase_s'] = time.perf_counter() - t0
  pex.make_graph = pex.make_graph.fn
  log(f'tiered phase wall {report["tiered"]["phase_s"]:.1f} s')
  if cuda:
    torch.cuda.empty_cache()
  phase_done('tiered')
  report['probes'] = probe_phase(torch, device, reps, smi, args.profile)
  phase_done('probes')
  report['lint'] = lint_phase(smi, lint)
  phase_done('lint')
  ktab = report['kernels']
  widest = ktab['sample_level']['levels'][-1]
  serve_cap = ktab['gather_runs'][len(SERVE_BUCKETS) - 1]
  # every path's launches: each path's counters were set to 0 just before
  # it and read just after (the ScanTrainer epochs count beside the loops)
  paths = [report[p]['launches'] for p in (
      'tree', 'merge', 'serving', 'train_tree', 'train_merge', 'probes')]
  paths += [report[p][t]['launches'] for p in ('train_tree', 'train_merge')
            for t in ('scan', 'scan_eager')]
  paths += [m['launches'] for m in report['dist']['modes'].values()]
  paths += report['dist_scan']['launch_runs']
  paths += report['dist_more']['launch_runs']
  # the grouped store's lookups and each rank's captured group epoch (read
  # in its own process)
  paths += report['multicard']['launch_runs']
  # the remote phase's runs: its workers' (in their own processes, read
  # from their metric snapshots) and the server's serve RPCs'
  paths += report['remote']['launch_runs']
  # the remote scan's epochs: the server's counters read before and after
  # each (its RPC threads launch), the typed epoch's in this process
  paths += report['remote_scan']['launch_runs']
  for p in ('train_tree', 'train_merge'):
    paths += report[p]['program']['launch_runs']
  paths += report['observability']['launch_runs']
  paths += report['tune']['launch_runs'] + report['tune_dist']['launch_runs']
  for rec in report['modes'].values():
    paths += [rec['launches'], rec['launches_eager'],
              rec['inference_launches']]
  paths += [report[p][r]['launches'] for p in ('link', 'subgraph', 'legacy')
            for r in report[p]]
  het = report['hetero']
  paths += [het[p]['launches'] for p in (
      'tree', 'merge', 'train_rsage_tree', 'train_rgat_tree',
      'train_rgat_merge')]
  paths += [r['launches'] for r in het['menu'].values()]
  mod = report['models']
  paths += [mod['hgt'][p]['launches'] for p in (
      'tree', 'merge', 'train_tree', 'train_merge')]
  paths += [mod['gat'][p]['launches'] for p in (
      'tree', 'merge', 'train_tree', 'train_merge', 'scan')]
  paths += [mod[p]['launches'] for p in ('gat_serving', 'seal')]
  tl = report['typed_link']
  paths += [tl['bipartite']['launches'], tl['tiered_loader']['launches']]
  paths += [r['launches'] for r in tl['link_batches'].values()]
  paths += [r['launches'] for r in tl['serving'].values()]
  paths += [report['hot_cold'][p]['launches'] for p in ('papers', 'tables')]
  paths += [report['tiered'][p]['launches'] for p in ('tree', 'merge',
                                                       'papers')]
  paths += [report['tiered']['serving'][s]['launches']
            for s in ('tiered', 'restart_tiered', 'restart')]
  launches = {k: sum(c[k] for c in paths) for k in paths[0]}
  launches['row_gather_probe'] = (launches['row_gather_probe_bulk'] +
                                  launches['row_gather_probe_vector'])
  keys_rec = ktab['step_keys']
  dkeys_rec = report['dist_scan']['kernel']
  draw_rec = ktab['uniform_draw'][0]
  neg_rec = ktab['negative_sample'][0]
  nloc_rec = report['dist_more']['kernel']
  hc_rec = ktab['gather_unified'][0]
  mc_rec = {c['kernel']: c for c in report['multicard']['cases']}
  line = {'kernels': [
      dict(name='gather_rows', route='cuda',
           source='graphlearn_tpu_torch/csrc/gather_rows.cu',
           replaces='graphlearn_tpu/ops/gather_pallas.py:47',
           launches=launches['gather_rows'],
           max_abs_err=max(c['max_abs_err'] for c in ktab['gather_rows']),
           ms=ktab['gather_rows'][0]['ms'],
           plain_ms=ktab['gather_rows'][0]['plain_ms'],
           bound_ms=ktab['gather_rows'][0]['bound_ms'], bound_by='bytes',
           library_ms=ktab['gather_rows'][0]['library_ms']),
      dict(name='sample_hop', route='cuda',
           source='graphlearn_tpu_torch/csrc/sample_hop.cu',
           replaces='graphlearn_tpu/ops/sample_fused.py:86',
           launches=launches['sample_hop'],
           max_abs_err=max(c['max_abs_err'] for c in ktab['sample_hop']),
           ms=ktab['sample_hop'][0]['ms'],
           plain_ms=ktab['sample_hop'][0]['plain_ms'],
           bound_ms=ktab['sample_hop'][0]['bound_ms'],
           bound_by=ktab['sample_hop'][0]['bound_by'], library_ms=None),
      dict(name='sample_level', route='cuda',
           source='graphlearn_tpu_torch/csrc/sample_level.cu',
           replaces='graphlearn_tpu/ops/sample_fused.py:269',
           launches=launches['sample_level'],
           max_abs_err=max(r['max_abs_err'] for r in
                           ktab['sample_level']['levels'] +
                           [ktab['sample_level']['edge_case']]),
           ms=widest['ms'], plain_ms=widest['plain_ms'],
           bound_ms=widest['bound_ms'], bound_by=widest['bound_by'],
           library_ms=None),
      dict(name='step_keys', route='cuda',
           source='graphlearn_tpu_torch/csrc/step_keys.cu',
           replaces='graphlearn_tpu/loader/scan_epoch.py:249-254',
           launches=launches['step_keys'],
           max_abs_err=keys_rec['max_abs_err'], ms=keys_rec['ms'],
           plain_ms=keys_rec['plain_ms'], bound_ms=keys_rec['bound_ms'],
           bound_by=keys_rec['bound_by'], library_ms=None),
      dict(name='dist_step_keys', route='cuda',
           source='graphlearn_tpu_torch/csrc/step_keys.cu',
           replaces='graphlearn_tpu/loader/scan_epoch.py:700-706',
           launches=launches['dist_step_keys'],
           max_abs_err=dkeys_rec['max_abs_err'], ms=dkeys_rec['ms'],
           plain_ms=dkeys_rec['plain_ms'], bound_ms=dkeys_rec['bound_ms'],
           bound_by=dkeys_rec['bound_by'], library_ms=None),
      dict(name='uniform_draw', route='cuda',
           source='graphlearn_tpu_torch/csrc/uniform_draw.cu',
           replaces='graphlearn_tpu/ops/neighbor.py:282',
           launches=launches['uniform_draw'],
           max_abs_err=max(r['max_abs_err'] for r in ktab['uniform_draw']),
           ms=draw_rec['ms'], plain_ms=draw_rec['plain_ms'],
           bound_ms=draw_rec['bound_ms'], bound_by=draw_rec['bound_by'],
           library_ms=None),
      dict(name='negative_sample', route='cuda',
           source='graphlearn_tpu_torch/csrc/negative_sample.cu',
           replaces='graphlearn_tpu/ops/negative.py:33',
           launches=launches['negative_sample'],
           max_abs_err=max(r['max_abs_err']
                           for r in ktab['negative_sample']),
           ms=neg_rec['ms'], plain_ms=neg_rec['plain_ms'],
           bound_ms=neg_rec['bound_ms'], bound_by=neg_rec['bound_by'],
           library_ms=None),
      dict(name='negative_sample_local', route='cuda',
           source='graphlearn_tpu_torch/csrc/negative_sample.cu',
           replaces='graphlearn_tpu/ops/negative.py:68',
           launches=launches['negative_sample_local'],
           max_abs_err=nloc_rec['max_abs_err'], ms=nloc_rec['ms'],
           plain_ms=nloc_rec['plain_ms'], bound_ms=nloc_rec['bound_ms'],
           bound_by=nloc_rec['bound_by'], library_ms=None),
      dict(name='gather_unified', route='cuda',
           source='graphlearn_tpu_torch/csrc/gather_unified.cu',
           replaces='graphlearn_tpu/data/unified_tensor.py:131',
           launches=launches['gather_unified'],
           max_abs_err=max(r['max_abs_err']
                           for r in ktab['gather_unified']),
           ms=hc_rec['ms'], plain_ms=hc_rec['plain_ms'],
           bound_ms=hc_rec['bound_ms'], bound_by=hc_rec['bound_by'],
           library_ms=None),
      dict(name='gather_rows_sharded', route='cuda',
           source='graphlearn_tpu_torch/csrc/gather_rows.cu',
           replaces='graphlearn_tpu/ops/gather_pallas.py:47',
           launches=launches['gather_rows_sharded'],
           max_abs_err=mc_rec['gather_rows_sharded']['max_abs_err'],
           ms=mc_rec['gather_rows_sharded']['ms'],
           plain_ms=mc_rec['gather_rows_sharded']['plain_ms'],
           bound_ms=mc_rec['gather_rows_sharded']['bound_ms'],
           bound_by='bytes',
           library_ms=mc_rec['gather_rows_sharded']['library_ms']),
      dict(name='gather_unified_sharded', route='cuda',
           source='graphlearn_tpu_torch/csrc/gather_unified.cu',
           replaces='graphlearn_tpu/data/unified_tensor.py:131',
           launches=launches['gather_unified_sharded'],
           max_abs_err=mc_rec['gather_unified_sharded']['max_abs_err'],
           ms=mc_rec['gather_unified_sharded']['ms'],
           plain_ms=mc_rec['gather_unified_sharded']['plain_ms'],
           bound_ms=mc_rec['gather_unified_sharded']['bound_ms'],
           bound_by='bytes', library_ms=None),
      dict(name='gather_runs', route='cuda',
           source='graphlearn_tpu_torch/csrc/gather_runs.cu',
           replaces='graphlearn_tpu/ops/gather_pallas.py:196',
           launches=launches['gather_runs'],
           max_abs_err=max(c['max_abs_err'] for c in ktab['gather_runs']),
           ms=serve_cap['ms'], plain_ms=serve_cap['plain_ms'],
           bound_ms=serve_cap['bound_ms'], bound_by='bytes',
           library_ms=serve_cap['library_ms']),
  ] + [dict(name=name, route='cuda',
            source=f'graphlearn_tpu_torch/csrc/{name}.cu', replaces=where,
            launches=launches[name],
            max_abs_err=report['probes'][name]['max_abs_err'],
            ms=report['probes'][name]['ms'],
            plain_ms=report['probes'][name]['plain_ms'],
            bound_ms=report['probes'][name]['bound_ms'], bound_by='bytes',
            library_ms=report['probes'][name]['library_ms'])
       for name, where in (('row_gather_probe', 'benchmarks/prof_mem.py:84'),
                           ('smem_take', 'benchmarks/prof_dedup.py:99'))]}
  report['profile_warmups_s'] = PROFILE_WARMUPS_S
  report['profile_empty_windows'] = PROFILE_EMPTY_WINDOWS
  report['profile_short_windows'] = PROFILE_SHORT_WINDOWS
  if cuda:
    # every drill was recorded again, and its site's exact check held
    drilled = [w['label'] for w in PROFILE_SHORT_WINDOWS if 'drill' in w]
    assert sorted(drilled) == sorted(PROFILE_DRILLS) == \
        sorted(PROFILE_DRILLED), (drilled, PROFILE_DRILLED)
  report['launch_shapes'] = TALLY.shapes()
  report['never_redesigned'] = never_redesigned_ranking(
      ktab, report['dist_scan']['kernel'], report['dist_more']['kernel'],
      report['launch_shapes'])
  if args.out:
    with open(args.out, 'w') as fh:
      json.dump(dict(report, kernels_line=line), fh, indent=1)
  if args.rehearse:
    log('rehearsal finished: no result line')
    return 3
  nr = report['never_redesigned']
  for what, rows in (('never redesigned', nr['ranked']),
                     ('never redesigned, not launched by a path',
                      nr['not_launched'])):
    for r in rows:
      log(f'{what}: {r["kernel"]} {r["shape"]}: {r["launches"]} '
          f'launches at this shape, {r["ms"]:.4f} ms against a yardstick of '
          f'{r["yardstick_ms"]:.4f} (bound {r["bound_ms"]:.4f} by '
          f'{r["bound_by"]}, fill {r["fill_ms"]:.4f}): {r["share"]:.1%}, '
          f'launches x gap {r["launches_x_gap_ms"]:.3f} ms on {smi}')
  log('never redesigned, launched at shapes no case times (this process '
      'after the kernel phase; the ranks\' and servers\' processes not '
      f'seen): {json.dumps(nr["untimed"])}; all launches by shape '
      f'{json.dumps(report["launch_shapes"])}')
  log('phase seconds: ' + json.dumps(
      {k: round(v, 1) for k, v in report['phase_s'].items()}))
  log(f'script wall {time.perf_counter() - t_start:.1f} s, the build '
      f'included; {len(PROFILE_WARMUPS_S)} profiled windows\' warm-up '
      f'calls {sum(t for _, t in PROFILE_WARMUPS_S):.2f} s of it; '
      f'windows recorded again for an empty trace: {PROFILE_EMPTY_WINDOWS}; '
      f'for a short count: '
      f'{json.dumps([w for w in PROFILE_SHORT_WINDOWS if "drill" not in w])}'
      f'; drills (one record dropped on purpose, then recorded again): '
      f'{json.dumps([w for w in PROFILE_SHORT_WINDOWS if "drill" in w])}')
  log(smi)
  log(json.dumps(line))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())

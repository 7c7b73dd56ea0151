"""The closed inventory of metric and span names the port emits.

The port's copy of ``graphlearn_tpu/metrics/registry_names.py``: JAX's
80 metric names and 24 span names, unchanged, plus four metric names
only the port emits (marked below). Every name passed as a literal to
``metrics.inc`` / ``observe`` / ``set_gauge`` and to ``spans.span`` /
``begin`` / ``emit`` inside ``graphlearn_tpu_torch`` is registered here
(``tests/test_torch_metrics.py`` parses the package's source to check),
so a record or a scrape from either package names the same events the
same way.

Names are ``<subsystem>.<event>`` (one dot minimum; histograms end in
a unit suffix like ``_ms``). Wildcard entries ``<prefix>.*`` cover
families whose tails are minted at runtime (per-fault-site counters,
the feature stores' published stat keys).
"""

REGISTERED_METRICS = frozenset({
    # resilience events (distributed/resilience.py + consumers)
    'resilience.retry',
    'resilience.server_dead',
    'resilience.failover',
    'resilience.failover_seeds',
    'resilience.worker_restart',
    'resilience.producer_reaped',
    # fault injection: one counter per armed site (utils/faults.py)
    'fault.*',
    # per-epoch feature-store stats published by publish_stats
    # (distributed/dist_feature.py; label stores publish under
    # dist_label so the headline dist_feature parity stays clean)
    'dist_feature.*',
    'dist_label.*',
    # mp sampling workers (distributed/dist_sampling_producer.py)
    'producer.batches',
    'producer.sample_ms',
    # RPC plane latencies (distributed/rpc.py, dist_server.py)
    'rpc.client.request_ms',
    'server.fetch_ms',
    # scrape plumbing (metrics/scrape.py)
    'metrics.scrape_error',
    # online serving endpoint (serving/engine.py) — the end-to-end
    # latency/throughput surface bench.py --gate regression-tracks
    'serving.requests',
    'serving.batches',
    'serving.refreshed',
    'serving.rotations',
    'serving.rotation_swap_ms',
    'serving.rotation_errors',
    'serving.queue_wait_ms',
    'serving.batch_fill',
    'serving.compute_ms',
    'serving.total_ms',
    # program observatory (metrics/programs.py): compiles/retraces at
    # instrumented dispatch sites; per-site detail lives in the
    # ProgramRegistry (flight 'programs' field), not the metric store
    'program.compiles',
    'program.retraces',
    'program.compile_ms',
    'program.retrace_budget_exceeded',
    # out-of-core tiered feature storage (storage/):
    # the chunk-boundary staging pipeline's counters/latencies plus
    # tier-occupancy gauges
    'storage.staged_rows',
    'storage.staged_bytes',
    'storage.dist_staged_rows',
    'storage.prefetch_miss',
    # demand-paged PER-STEP gather on oversubscribed dist stores
    # (storage/dist.py): one demand_pages tick per get() step, staged
    # row count, and the host routing+gather latency
    'storage.demand_pages',
    'storage.demand_paged_rows',
    'storage.demand_page_ms',
    'storage.stage_ms',
    'storage.promote_ms',
    'storage.ring_rows',
    'storage.hot_rows',
    'storage.warm_rows',
    'storage.disk_rows',
    # chunk-staged remote scan (distributed/remote_scan.py +
    # block_producer.py): K-batch block exchange
    # between sampling servers and the scanned client
    'remote.blocks',
    'remote.block_bytes',
    'remote.block_mb_per_chunk',
    'remote.block_fetch_ms',
    'remote.block_stage_ms',
    'remote.prefetch_miss',
    'remote.failover_blocks',
    # chunk-granular recovery (recovery/): async exact
    # checkpointing at chunk boundaries + mid-epoch resume + scanned
    # failover rollback
    # kernel routing (ops/gather.py, ops/sample_fused.py): how often a
    # call routes through a kernel against its plain fallback
    'ops.gather_runs',
    'ops.gather_fallbacks',
    'ops.fused_hop_calls',
    'ops.fused_level_calls',
    'ops.gather_ms',
    'checkpoint.saves',
    'checkpoint.bytes',
    'checkpoint.save_ms',
    'checkpoint.capture_ms',
    'checkpoint.sync_fallback',
    'checkpoint.save_errors',
    'checkpoint.torn_skipped',
    'checkpoint.restore_ms',
    'recovery.resumes',
    'recovery.resume_chunks',
    'recovery.rollbacks',
    # one-call autotuner (tune/): observatory-scored candidate A/Bs
    # behind the config artifact
    'tune.candidates',
    'tune.rejected',
    'tune.probe_ms',
    'tune.artifacts',
    # continuous retuning (tune/retune.py): drift-trigger fires,
    # successful shadow-retune publishes, and the shadow replica's tune
    # wall
    'tune.retunes',
    'tune.drift_triggers',
    'tune.shadow_wall_ms',
    # run-as-a-program (loader/run_epoch.py): whole-run scans with
    # in-carry eval + early stop — host-side schedule counters only
    # (the stop point itself is device state, read from the report)
    'run.runs',
    'run.epochs_scheduled',
    # multi-tenant service fabric (distributed/tenancy.py +
    # dist_server.py): admission rejections,
    # fair-scheduler waits, client-visible backpressure, and the
    # per-tenant reap family (tails minted as tenant.reaped.<tenant>)
    'tenant.admit_rejections',
    'tenant.throttled',
    'tenant.starved',
    'tenant.sched_wait_ms',
    'tenant.backpressure_ms',
    'tenant.rebalanced_blocks',
    'tenant.*',
    # port-only: the mp sampling worker's phases on a card
    # (distributed/dist_sampling_producer.py), where a batch is sampled
    # and gathered on the device, read back, then sent; JAX's worker
    # samples on the host and times only 'producer.sample_ms'
    'producer.sample_gather_ms',   # sample + collate on the card
    'producer.d2h_ms',             # the batch read back to the host
    'producer.send_ms',            # the message into the channel
    'producer.message_bytes',      # gauge: the last message's size
})

# The closed inventory of SPAN names (metrics/spans.py) — the same
# contract as metrics: literal at every spans.span/begin/emit call
# site, registered here.
REGISTERED_SPANS = frozenset({
    # RPC plane (distributed/rpc.py): one client span per round trip,
    # one server span per handled request — the cross-process seam
    'rpc.client.request',
    'rpc.server.handle',
    # epoch drivers (loader/scan_epoch.py, distributed/dist_loader.py)
    'epoch.run',
    'epoch.chunk',
    # remote-loader failover (distributed/dist_loader.py): carries the
    # resilience annotations for the degraded epoch's span tree
    'loader.failover',
    # mp sampling workers (distributed/dist_sampling_producer.py)
    'producer.epoch',
    'producer.batch',
    # online serving (serving/engine.py): the queue→batch→compute→
    # respond tree one request yields
    'serving.request',
    'serving.queue',
    'serving.batch',
    'serving.compute',
    'serving.respond',
    # sharded store rotation (serving/rotation.py): one span per
    # version swap critical section
    'serving.rotate',
    # out-of-core staging pipeline (storage/staging.py): one span per
    # staged chunk on the worker thread
    'storage.stage',
    # demand-paged per-step gather (storage/dist.py): one span per
    # oversubscribed get() step's host routing + tier gather
    'storage.demand_page',
    # chunk-staged remote scan: one span per
    # server-side block build and one per client-side block fetch
    'remote.block_stage',
    'remote.block_fetch',
    # chunk-granular recovery (recovery/): one span per snapshot write
    # (worker thread or sync fallback) and one wrapping each mid-epoch
    # resume; the failover rollback reuses `loader.failover` with the
    # rolled-back chunk index in its attrs
    'checkpoint.save',
    'recovery.resume',
    # one-call autotuner (tune/tuner.py): one span per tune() run, one
    # per candidate A/B (compile + steady epochs inside)
    'tune.run',
    'tune.candidate',
    # continuous retuning (tune/retune.py): one span per shadow
    # retune attempt, carrying the firing drift trigger in its attrs
    'tune.retune',
    # run-as-a-program (loader/run_epoch.py): one span wrapping the
    # whole multi-epoch run; the inherited epoch.run/epoch.chunk spans
    # parent under it
    'run.train',
    # multi-tenant backpressure (distributed/tenancy.py): one span per
    # bounded-backoff throttle wait on the client, parented under the
    # epoch root via the stager's adopted context
    'tenant.throttle',
})

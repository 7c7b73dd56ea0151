#!/usr/bin/env python3
"""Chip smoke test of graphlearn_tpu_torch: sampled GraphSAGE inference
on one CUDA GPU, on the tree path and on the merge (exact-dedup) path.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):

1. Set-up: the card's name and power limit (nvidia-smi), TF32 off, and
   the CUDA kernels built with nvcc from ``graphlearn_tpu_torch/csrc``
   (one nvcc per source, started together, while numpy builds the graph).
2. Kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (exact equality), with the kernel's, the plain
   version's and (where one exists) one library call's median device
   time (and, beside it, the time of a call including its host launch
   cost), and the bound computed from the inputs. The level kernel runs
   at the three levels of one full-width merge batch, from the states
   the sampler produced, and once more at S > 32,768 with hubs,
   duplicates, all-found and all-masked seeds.
3. Slices, at full width (``bench.py``'s recipe: 1M nodes, average
   degree 25, half uniform and half zipf(1.5) targets, [1M, 100] f32
   features, 47 classes; fanouts [15, 10, 5] at batch 1024; GraphSAGE
   hidden 256, 3 layers, weights from a fixed seed):
   - tree: ``dedup='tree'``, the layered tree-dense forward;
   - merge: ``dedup='auto'`` with ``frontier_caps='auto'`` (calibrated
     in the loader) under ``overflow_policy='raise'``, the layered
     ``merge_dense`` forward.
   Before each, the launch counters are set to 0, and they are read just
   after: every hop (tree) or level (merge) must have gone through its
   kernel and every feature gather through the row-gather kernel. No
   merge batch may overflow its caps. Outputs must be finite, and the
   last batch is recomputed on the CPU from the same sampler state
   (plain versions): ids, masks and features exact, logits within
   rtol=1e-3, atol=1e-4 (TF32 off; the two devices sum in other orders).

The line before the last is the ``kernels`` JSON record; the last line
is ``{"ok": true, "device": {...}}``. ``--out FILE`` also writes the
whole report as JSON; ``--profile`` adds a torch.profiler pass over each
phase of both slices. ``--rehearse`` runs every phase on the CPU at a
tiny size through the plain versions (no result line; exit code 3).
"""
import argparse
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA's H100 SXM data sheet
FANOUTS = [15, 10, 5]
BATCH = 1024
FEAT_DIM = 100
CLASSES = 47
HIDDEN = 256
HUB_DEG = 513   # least degree of the added hub seeds in the K3 check
BATCHES = 6   # counted slice batches (plus one through the loader iterator)
REPS = 20     # timed calls per kernel measurement
SPIN_CYCLES = 2_000_000   # ~1 ms of spin ahead of a device-timed call


def log(*a):
  print(*a, flush=True)


def nvidia_smi_line() -> str:
  proc = subprocess.run(
      ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
  if proc.returncode != 0 or not proc.stdout.strip():
    raise RuntimeError(f'nvidia-smi failed: {proc.stderr.strip()}')
  return proc.stdout.strip().splitlines()[0]


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


def timed(torch, fn, reps: int, device):
  """(result, device ms, call ms): medians over ``reps`` calls after one
  warm-up call. The device ms is taken between CUDA events with the call
  queued behind a spin kernel (``torch.cuda._sleep``), so the host's
  launch cost does not show; the call ms is taken between events around
  a call made on an idle card, so it does. On the CPU both are the host
  clock."""
  out = fn()
  dev_times, call_times = [], []
  for _ in range(reps):
    if device.type == 'cuda':
      for queued, times in ((True, dev_times), (False, call_times)):
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
      t0 = time.perf_counter()
      out = fn()
      dev_times.append((time.perf_counter() - t0) * 1e3)
  call_times = call_times or dev_times
  return out, float(np.median(dev_times)), float(np.median(call_times))


def bound_ms(nbytes: int) -> float:
  return nbytes / H100_BYTES_PER_S * 1e3


def kernel_phase(torch, gtt, ds, device, gen, reps):
  """Each kernel against its plain version at main-path shapes."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.ops import sample_fused
  records = {}
  n = ds.graph.num_nodes
  # ---- K1 gather_rows: the collate gather of a products batch
  slots = BATCH * (1 + FANOUTS[0] + FANOUTS[0] * FANOUTS[1] +
                   FANOUTS[0] * FANOUTS[1] * FANOUTS[2])
  ids = torch.randint(0, n, (slots,), generator=gen, dtype=torch.int64)
  ids[::97] = -1               # FILL slots
  ids[5::211] = n + 5          # out of range above
  ids[7::389] = -12345         # out of range below
  ids[slots // 2:slots // 2 + slots // 8] = ids[:slots // 8].clone()
  ids = ids.to(torch.int32).to(device)
  f32 = ds.node_features.device_table()[0]
  tables = {
      f'f32[{n},100]': f32,
      f'bf16[{n},100]': f32.to(torch.bfloat16),
      f'f32[{n},128]': torch.randn((n, 128), generator=gen).to(device),
  }
  clamped = ids.clamp(0, n - 1).long()
  uniq = int(torch.unique(clamped).numel())
  cases = []
  for name, table in tables.items():
    got, ms, call_ms = timed(
        torch, lambda: ops.gather_rows_hbm(table, ids), reps, device)
    ref, plain_ms, plain_call_ms = timed(
        torch, lambda: ops.gather_rows_plain(table, ids), reps, device)
    _, lib_ms, lib_call_ms = timed(
        torch, lambda: torch.index_select(table, 0, clamped), reps, device)
    if device.type == 'cuda':
      torch.cuda.synchronize()
    exact = bool(torch.equal(got, ref))
    err = float((got.float() - ref.float()).abs().max())
    row = table.shape[1] * table.element_size()
    nbytes = slots * 4 + uniq * row + slots * row
    cases.append(dict(table=name, ids=slots, unique_rows=uniq, exact=exact,
                      max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      library_ms=lib_ms, call_ms=call_ms,
                      plain_call_ms=plain_call_ms, library_call_ms=lib_call_ms,
                      bound_ms=bound_ms(nbytes), bytes=nbytes))
    log(f'kernel gather_rows {name}: ids={slots} exact={exact} '
        f'ms={ms:.4f} plain_ms={plain_ms:.4f} index_select_ms={lib_ms:.4f} '
        f'bound_ms={bound_ms(nbytes):.4f}; call ms {call_ms:.4f} '
        f'{plain_call_ms:.4f} {lib_call_ms:.4f}')
    assert exact, f'gather_rows {name}: kernel != plain version'
  records['gather_rows'] = cases
  # ---- K3 sample_hop: hop 2 of a products batch, plus hubs
  g = ds.graph
  b = BATCH * FANOUTS[0] * FANOUTS[1]
  k = FANOUTS[2]
  seeds = torch.randint(0, n, (b,), generator=gen).to(torch.int32).to(device)
  seed_mask = (torch.rand((b,), generator=gen) < 0.97).to(device)
  row = g.csr_meta[torch.where(seed_mask, seeds, 0).long()]
  start, deg = row[:, 0].contiguous(), row[:, 1].contiguous()
  # hub seeds: long segments, whose picks land far apart in indices
  n_hub = b // 100
  hub = torch.randperm(b, generator=gen)[:n_hub].to(device)
  hdeg = torch.randint(HUB_DEG, 8 * HUB_DEG, (n_hub,), generator=gen)
  hstart = (torch.rand((n_hub,), generator=gen) *
            (g.num_edges - hdeg)).to(torch.int64)
  start[hub] = hstart.to(torch.int32).to(device)
  deg[hub] = hdeg.to(torch.int32).to(device)
  seed_mask[hub] = True
  key = gtt.random.fold_in(gtt.random.PRNGKey(0), 1)
  epos, mask = sample_fused._draw(start, deg, seed_mask, k, key)
  safe = torch.where(mask, epos, 0).contiguous()
  safe_long = safe.long()
  got, ms, call_ms = timed(
      torch, lambda: ops.sample_hop(g.indices, safe), reps, device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: ops.sample_hop_plain(g.indices, safe), reps, device)
  _, lib_ms, lib_call_ms = timed(
      torch, lambda: g.indices[safe_long], reps, device)
  exact = bool(torch.equal(got, ref))
  err = float((got - ref).abs().max())
  picks = int(mask.sum())
  # epos read and picked written once each; every distinct adjacency
  # element the picks resolve read once (masked slots all read element 0)
  uniq_e = int(torch.unique(safe).numel())
  nbytes = b * k * 4 * 2 + uniq_e * 4
  records['sample_hop'] = [dict(
      seeds=b, k=k, hubs=n_hub, valid_picks=picks, unique_elements=uniq_e,
      exact=exact, max_abs_err=err, ms=ms, plain_ms=plain_ms,
      library_ms=lib_ms, call_ms=call_ms, plain_call_ms=plain_call_ms,
      library_call_ms=lib_call_ms, bound_ms=bound_ms(nbytes),
      bytes=nbytes)]
  log(f'kernel sample_hop seeds={b} k={k} hubs={n_hub} exact={exact} '
      f'ms={ms:.4f} plain_ms={plain_ms:.4f} indexing_ms={lib_ms:.4f} '
      f'bound_ms={bound_ms(nbytes):.4f}; call ms {call_ms:.4f} '
      f'{plain_call_ms:.4f} {lib_call_ms:.4f}')
  assert exact, 'sample_hop: kernel != plain version'
  # hops 0 and 1 of a products batch: exactness at their shapes too
  for hop in (0, 1):
    bh, kh = BATCH * int(np.prod(FANOUTS[:hop])), FANOUTS[hop]
    sh = torch.randint(0, n, (bh,), generator=gen).to(torch.int32)
    mh = torch.ones(bh, dtype=torch.bool)
    row = g.csr_meta[sh.long().to(device)]
    ep, mk = sample_fused._draw(row[:, 0], row[:, 1], mh.to(device), kh, key)
    sf = torch.where(mk, ep, 0).contiguous()
    same = torch.equal(ops.sample_hop(g.indices, sf),
                       ops.sample_hop_plain(g.indices, sf))
    log(f'kernel sample_hop hop {hop}: seeds={bh} k={kh} exact={same}')
    assert same, f'sample_hop hop {hop}: kernel != plain version'
  return records


def level_bytes(torch, safe, limit, c):
  """Bytes the level function must move: epos (4 B) and mask (1 B) per
  candidate, each distinct adjacency element it resolves once (masked
  slots read element 0), the prefix, num_nodes and num_new, picked and
  cols_raw (4 B each) per candidate, and the block."""
  s = safe.numel()
  uniq_e = int(torch.unique(safe).numel())
  return s * 4 + s + uniq_e * 4 + c * 4 + 8 + s * 8 + limit * 4


def time_level(torch, ops, args, reps, device):
  """(record, got): the level kernel against its plain version on the
  same inputs, timed."""
  got, ms, call_ms = timed(torch, lambda: ops.sample_level(*args), reps,
                           device)
  ref, plain_ms, plain_call_ms = timed(
      torch, lambda: ops.sample_level_plain(*args), reps, device)
  _, safe, mask, prefix, num_nodes, limit, _ = args
  exact = all(bool(torch.equal(a, b)) for a, b in zip(got, ref))
  err = max(float((a - b).abs().max()) if a.numel() else 0.0
            for a, b in zip(got, ref))
  nbytes = level_bytes(torch, safe, limit, prefix.shape[0])
  rec = dict(frontier=safe.shape[0], k=safe.shape[1], candidates=safe.numel(),
             prefix=prefix.shape[0], num_nodes=int(num_nodes), limit=limit,
             valid=int(mask.sum()), num_new=int(got[3]), exact=exact,
             max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
             plain_call_ms=plain_call_ms, library_ms=None,
             bound_ms=bound_ms(nbytes), bytes=nbytes)
  return rec, got


def level_phase(torch, gtt, loader, device, gen, reps):
  """The level kernel at the three levels of one full-width merge batch
  (the sampler's own states, recorded on the way), and at S > 32,768
  with hubs, duplicates, all-found and all-masked seeds."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.ops import sample_fused
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  g = loader.sampler.graph
  n = g.num_nodes
  levels = []
  fused = ops.sample_level_fused

  def record(indptr, indices, blocks128, seeds, seed_mask, k, key, state,
             src_idx, meta=None, *, prefix_cap, max_new=None, final=False):
    start, deg = sample_fused._seed_rows(indptr, meta, seeds, seed_mask)
    epos, mask = sample_fused._draw(start, deg, seed_mask, k, key)
    size, cap = seeds.shape[0] * k, state.nodes.shape[0]
    c = min(prefix_cap, cap)
    limit = min(size, cap - c, size if max_new is None else max_new)
    levels.append((indices, torch.where(mask, epos, 0), mask,
                   state.nodes[:c].clone(), state.num_nodes.clone(), limit,
                   n))
    return fused(indptr, indices, blocks128, seeds, seed_mask, k, key, state,
                 src_idx, meta, prefix_cap=prefix_cap, max_new=max_new,
                 final=final)

  ops.sample_level_fused = record
  try:
    loader.sampler.sample_from_nodes(
        NodeSamplerInput(loader.input_seeds[:BATCH]), batch_cap=BATCH,
        key=gtt.random.fold_in(gtt.random.PRNGKey(0), 1))
  finally:
    ops.sample_level_fused = fused
  assert len(levels) == len(FANOUTS), len(levels)
  records = []
  for i, args in enumerate(levels):
    rec, _ = time_level(torch, ops, args, reps, device)
    records.append(dict(rec, level=i))
    log(f'kernel sample_level level {i}: F={rec["frontier"]} k={rec["k"]} '
        f'S={rec["candidates"]} c={rec["prefix"]} '
        f'num_nodes={rec["num_nodes"]} limit={rec["limit"]} '
        f'num_new={rec["num_new"]} exact={rec["exact"]} ms={rec["ms"]:.4f} '
        f'plain_ms={rec["plain_ms"]:.4f} bound_ms={rec["bound_ms"]:.4f} '
        '(no single PyTorch call computes this function: library_ms null); '
        f'call ms {rec["call_ms"]:.4f} {rec["plain_call_ms"]:.4f}')
    assert rec['exact'], f'sample_level level {i}: kernel != plain version'
  # ---- an extra call: hubs, duplicates, all-found and all-masked seeds
  b, k = 8192, 10
  seeds = torch.randint(0, n, (b,), generator=gen).to(torch.int32)
  seed_mask = torch.rand((b,), generator=gen) < 0.95
  seed_mask[:256] = False                      # all-masked seeds
  hub = torch.arange(512, 512 + b // 100)      # long fabricated segments
  seed_mask[hub] = True
  meta = g.csr_meta.cpu()
  row = meta[torch.where(seed_mask, seeds, 0).long()]
  start, deg = row[:, 0].contiguous(), row[:, 1].contiguous()
  deg[hub] = torch.randint(HUB_DEG, 8 * HUB_DEG, (hub.numel(),),
                           generator=gen).to(torch.int32)
  start[hub] = (torch.rand((hub.numel(),), generator=gen) *
                (g.num_edges - deg[hub])).to(torch.int32)
  key = gtt.random.fold_in(gtt.random.PRNGKey(0), 2)
  epos, mask = sample_fused._draw(start.to(device), deg.to(device),
                                  seed_mask.to(device), k, key)
  safe = torch.where(mask, epos, 0).contiguous()
  # seeds 256..511: every neighbour already in the prefix (all found);
  # the zipf head repeats ids across the other seeds (duplicates)
  ind = g.indices.cpu()
  found = torch.cat([ind[int(start[j]):int(start[j] + deg[j])]
                     for j in range(256, 512)])
  prefix = torch.unique(torch.cat([
      found, torch.randint(0, n, (n // 50,), generator=gen).to(
          torch.int32)])).to(torch.int32)
  num_nodes = torch.tensor(prefix.numel(), dtype=torch.int32)
  prefix = torch.cat([prefix, torch.full((4096,), -1, dtype=torch.int32)])
  args = (g.indices, safe, mask, prefix.to(device), num_nodes.to(device),
          safe.numel() // 8, n)
  rec, got = time_level(torch, ops, args, reps, device)
  cols_raw = got[1].view(b, k)[256:512]
  all_found = bool(((cols_raw >= 0) & (cols_raw < int(num_nodes)) |
                    ~mask[256:512]).all())
  rec.update(hubs=hub.numel(), all_found_seeds_found=all_found,
             unique_picks=int(torch.unique(got[0][mask.reshape(-1)]).numel()))
  log(f'kernel sample_level S={rec["candidates"]} (hubs {hub.numel()}, 256 '
      f'all-masked and 256 all-found seeds): exact={rec["exact"]} '
      f'num_new={rec["num_new"]} limit={rec["limit"]} '
      f'unique_picks={rec["unique_picks"]} of {rec["valid"]} valid '
      f'all_found={all_found} ms={rec["ms"]:.4f} '
      f'plain_ms={rec["plain_ms"]:.4f} bound_ms={rec["bound_ms"]:.4f}')
  assert rec['exact'] and all_found and rec['num_new'] > rec['limit']
  assert bool((got[1].view(b, k)[:256] == -1).all()), 'masked seeds'
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

  def event():
    if not cuda:
      return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev

  def span(a, b):
    return a.elapsed_time(b) if cuda else (b - a) * 1e3

  loader._overflow_epoch_start()
  ops.reset_launch_counts()
  per_batch = []
  correct = total = 0
  check = None
  for i, idx in enumerate(loader._batcher):
    seeds = loader.input_seeds[idx]
    if i == num_batches - 1:
      check = (loader.sampler.state_dict(), seeds)
    e0 = event()
    out = loader.sampler.sample_from_nodes(NodeSamplerInput(seeds),
                                           batch_cap=BATCH)
    if guarded:
      loader._accumulate_overflow(out)     # the loader's own guard
    e1 = event()
    batch = loader._collate_fn(out)
    e2 = event()
    d = train.batch_to_dict(batch)
    c, t = eval_counts(d)
    e3 = event()
    if cuda:
      e3.synchronize()
    correct += int(c)
    total += int(t)
    per_batch.append(dict(sample_ms=span(e0, e1), collate_ms=span(e1, e2),
                          forward_ms=span(e2, e3)))
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
  assert counts[hop_kernel] == (3 * batches if cuda else 0), counts
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
  return per_batch, counts, dict(correct=correct, total=total), cross


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
  """torch.profiler over ``reps`` batches of each phase alone: wall ms
  per batch (host clock, synchronised), device-busy ms per batch (the
  union of the kernel and copy intervals the profiler saw) and the top
  device consumers. The batches use their own sampler stream."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
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
  cuda = device.type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
  result = {}
  for name, fn in phases.items():
    fn()
    sync()
    with profile(activities=acts) as prof:
      t0 = time.perf_counter()
      for _ in range(reps):
        fn()
      sync()
      wall = (time.perf_counter() - t0) * 1e3 / reps
    spans, per_name, launches = [], {}, 0
    for e in prof.events():
      if e.device_type != DeviceType.CUDA:
        continue
      launches += 1
      spans.append((e.time_range.start, e.time_range.end))
      per_name[e.name] = per_name.get(e.name, 0.0) + \
          e.time_range.elapsed_us() / 1e3 / reps
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
      if b > end:
        busy += b - max(a, end)
        end = b
    busy_ms = busy / 1e3 / reps
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    result[name] = dict(wall_ms=wall, device_busy_ms=busy_ms,
                        idle_share=1 - busy_ms / wall if wall else None,
                        device_ops_per_batch=launches / reps,
                        top_device_ms=dict(top))
    log(f'profile {mode} {name}: wall_ms={wall:.3f} '
        f'device_busy_ms={busy_ms:.3f} '
        f'device_ops/batch={launches / reps:.0f} top=' +
        '; '.join(f'{k[:60]}={v:.3f}' for k, v in top))
  return result


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--out', default=None, help='also write the report here')
  ap.add_argument('--rehearse', action='store_true',
                  help='CPU, tiny size, plain versions; no result line')
  ap.add_argument('--profile', action='store_true',
                  help='also trace each phase with torch.profiler')
  args = ap.parse_args(argv)
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
  t0 = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    build = (pool.submit(kernels.build_all) if not args.rehearse else None)
    ei, feats, labels = make_graph(n_nodes, 25)
    topo = gtt.data.Topology(ei, num_nodes=n_nodes)
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

  def dataset(dev):
    ds = gtt.data.Dataset(device=dev)
    ds.graph = gtt.data.Graph(topo, dev)
    ds.init_node_features(feats)
    ds.init_node_labels(labels)
    return ds

  ds = dataset(device)
  cpu_ds = dataset(torch.device('cpu'))
  gen = torch.Generator().manual_seed(0)
  report['kernels'] = kernel_phase(torch, gtt, ds, device, gen, reps)
  pool = np.random.default_rng(1).permutation(n_nodes)[:BATCH * BATCHES]
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
  for mode, loader in (('tree', make_loader(gtt, ds, pool, device, 'tree')),
                       ('merge', merge_loader)):
    per_batch, counts, acc, cross = slice_phase(
        torch, gtt, loader, device, 0, BATCHES, cpu_ds, mode)
    steady = per_batch[1:] or per_batch
    med = {k: float(np.median([p[k] for p in steady])) for k in steady[0]}
    report[mode] = dict(per_batch=per_batch, launches=counts, eval=acc,
                        cross=cross, median_batch_ms=med)
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
  ktab = report['kernels']
  widest = ktab['sample_level']['levels'][-1]
  launches = {k: report['tree']['launches'][k] + report['merge']['launches'][k]
              for k in report['tree']['launches']}
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
           max_abs_err=ktab['sample_hop'][0]['max_abs_err'],
           ms=ktab['sample_hop'][0]['ms'],
           plain_ms=ktab['sample_hop'][0]['plain_ms'],
           bound_ms=ktab['sample_hop'][0]['bound_ms'], bound_by='bytes',
           library_ms=ktab['sample_hop'][0]['library_ms']),
      dict(name='sample_level', route='cuda',
           source='graphlearn_tpu_torch/csrc/sample_level.cu',
           replaces='graphlearn_tpu/ops/sample_fused.py:269',
           launches=launches['sample_level'],
           max_abs_err=max(r['max_abs_err'] for r in
                           ktab['sample_level']['levels'] +
                           [ktab['sample_level']['edge_case']]),
           ms=widest['ms'], plain_ms=widest['plain_ms'],
           bound_ms=widest['bound_ms'], bound_by='bytes', library_ms=None),
  ]}
  if args.out:
    with open(args.out, 'w') as fh:
      json.dump(dict(report, kernels_line=line), fh, indent=1)
  if args.rehearse:
    log('rehearsal finished: no result line')
    return 3
  log(smi)
  log(json.dumps(line))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())

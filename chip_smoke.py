#!/usr/bin/env python3
"""Chip smoke test of graphlearn_tpu_torch: sampled GraphSAGE inference
on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):

1. Set-up: the card's name and power limit (nvidia-smi), TF32 off, and
   the CUDA kernels built with nvcc from ``graphlearn_tpu_torch/csrc``
   (one nvcc per source, started together, while numpy builds the graph).
2. Kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (exact equality), with the kernel's, the plain
   version's and one library call's median device time (and, beside it,
   the time of a call including its host launch cost), and the bound
   computed from the inputs.
3. Slice, at full width (``bench.py``'s recipe: 1M nodes, average degree
   25, half uniform and half zipf(1.5) targets, [1M, 100] f32 features,
   47 classes; fanouts [15, 10, 5] at batch 1024; GraphSAGE hidden 256,
   3 layers, layered tree-dense forward, weights from a fixed seed). The
   launch counters are set to 0 just before the batches and read just
   after: every hop must have gone through the hop kernel and every
   feature gather through the row-gather kernel. Outputs must be finite,
   and one batch is recomputed on the CPU from the same sampler state
   (plain versions): ids, masks and features exact, logits within
   rtol=1e-3, atol=1e-4 (TF32 off; the two devices sum in other orders).

The line before the last is the ``kernels`` JSON record; the last line
is ``{"ok": true, "device": {...}}``. ``--out FILE`` also writes the
whole report as JSON. ``--rehearse`` runs every phase on the CPU at a
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


def slice_phase(torch, gtt, ds, device, gen_seed, num_batches, cpu_ds):
  """Sampled inference at full width through the port's entry points;
  returns (per-batch timings, launch counts, cross-check report)."""
  from graphlearn_tpu_torch import ops
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  n = ds.graph.num_nodes
  rng = np.random.default_rng(1)
  pool = rng.permutation(n)[:BATCH * num_batches]
  loader = gtt.loader.NeighborLoader(ds, FANOUTS, pool, batch_size=BATCH,
                                     shuffle=False, seed=0, device=device)
  no, eo = train.tree_hop_offsets(BATCH, FANOUTS)
  model = gtt.models.GraphSAGE(
      FEAT_DIM, HIDDEN, CLASSES, num_layers=len(FANOUTS),
      hop_node_offsets=no, hop_edge_offsets=eo, tree_dense=True,
      fanouts=FANOUTS, device=device,
      generator=torch.Generator().manual_seed(gen_seed))
  model.eval()
  eval_counts = train.make_eval_counts(model)
  forward = train.make_forward_fn(model)
  cuda = device.type == 'cuda'

  def event():
    if not cuda:
      return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev

  def span(a, b):
    return a.elapsed_time(b) if cuda else (b - a) * 1e3

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
  # one more batch through the loader's own iterator (the user's loop)
  it_batch = next(iter(loader))
  counts = ops.launch_counts()
  batches = len(per_batch) + 1
  assert counts['sample_hop'] == (3 * batches if cuda else 0), counts
  assert counts['gather_rows'] >= (batches if cuda else 0), counts
  assert total == BATCH * num_batches, total
  out, batch, d = last
  with torch.no_grad():
    logits = forward(d)
  assert torch.isfinite(logits).all(), 'non-finite logits'
  assert torch.isfinite(batch.x).all() and torch.isfinite(it_batch.x).all()
  assert logits.shape == (no[1], CLASSES), logits.shape
  for name, val in (('node', out.node), ('row', out.row), ('col', out.col)):
    assert int(val.min()) >= -1, name
  cross = cross_check(torch, gtt, cpu_ds, check, model, out, batch, logits)
  return per_batch, counts, dict(correct=correct, total=total), cross


def cross_check(torch, gtt, cpu_ds, check, model, out, batch, logits):
  """Recompute the last batch on the CPU (plain versions) from the same
  sampler state and compare."""
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  state, seeds = check
  cpu_loader = gtt.loader.NeighborLoader(cpu_ds, FANOUTS, seeds,
                                         batch_size=BATCH, seed=0,
                                         device='cpu')
  cpu_loader.sampler.load_state_dict(state)
  cout = cpu_loader.sampler.sample_from_nodes(NodeSamplerInput(seeds),
                                              batch_cap=BATCH)
  cbatch = cpu_loader._collate_fn(cout)
  no, eo = train.tree_hop_offsets(BATCH, FANOUTS)
  cmodel = gtt.models.GraphSAGE(
      FEAT_DIM, HIDDEN, CLASSES, num_layers=len(FANOUTS),
      hop_node_offsets=no, hop_edge_offsets=eo, tree_dense=True,
      fanouts=FANOUTS, device='cpu')
  cmodel.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
  with torch.no_grad():
    clog = train.make_forward_fn(cmodel)(train.batch_to_dict(cbatch))
  for name in ('node', 'row', 'col', 'edge_mask'):
    assert torch.equal(getattr(out, name).cpu(), getattr(cout, name)), name
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
              prediction_ties_differing=int(differ.sum()), seeds=nseed)


def profile_phases(torch, gtt, ds, device, reps: int = 3):
  """torch.profiler over ``reps`` batches of each phase alone: wall ms
  per batch (host clock, synchronised), device-busy ms per batch (the
  union of the kernel and copy intervals the profiler saw) and the top
  device consumers. The batches use their own sampler stream."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  from graphlearn_tpu_torch.models import train
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  loader = gtt.loader.NeighborLoader(ds, FANOUTS, np.arange(BATCH),
                                     batch_size=BATCH, seed=7, device=device)
  no, eo = train.tree_hop_offsets(BATCH, FANOUTS)
  model = gtt.models.GraphSAGE(
      FEAT_DIM, HIDDEN, CLASSES, num_layers=len(FANOUTS),
      hop_node_offsets=no, hop_edge_offsets=eo, fanouts=FANOUTS,
      device=device, generator=torch.Generator().manual_seed(0))
  seeds = np.arange(BATCH)
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
    log(f'profile {name}: wall_ms={wall:.3f} device_busy_ms={busy_ms:.3f} '
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
  per_batch, counts, acc, cross = slice_phase(
      torch, gtt, ds, device, 0, BATCHES, cpu_ds)
  report.update(per_batch=per_batch, launches=counts, eval=acc, cross=cross)
  if args.profile:
    report['profile'] = profile_phases(torch, gtt, ds, device)
  steady = per_batch[1:] or per_batch
  med = {k: float(np.median([p[k] for p in steady])) for k in steady[0]}
  report['median_batch_ms'] = med
  log(f'slice: {len(per_batch)} batches + 1 via the loader iterator; '
      f'launches {counts}; eval {acc}; cross-check {cross}')
  for i, p in enumerate(per_batch):
    log(f'  batch {i}: ' + ' '.join(f'{k}={v:.3f}' for k, v in p.items()))
  log('median after the first batch (ms): ' +
      ' '.join(f'{k}={v:.3f}' for k, v in med.items()) + f' on {smi}')
  ktab = report['kernels']
  line = {'kernels': [
      dict(name='gather_rows', route='cuda',
           source='graphlearn_tpu_torch/csrc/gather_rows.cu',
           replaces='graphlearn_tpu/ops/gather_pallas.py:47',
           launches=counts['gather_rows'],
           max_abs_err=max(c['max_abs_err'] for c in ktab['gather_rows']),
           ms=ktab['gather_rows'][0]['ms'],
           plain_ms=ktab['gather_rows'][0]['plain_ms'],
           bound_ms=ktab['gather_rows'][0]['bound_ms'], bound_by='bytes',
           library_ms=ktab['gather_rows'][0]['library_ms']),
      dict(name='sample_hop', route='cuda',
           source='graphlearn_tpu_torch/csrc/sample_hop.cu',
           replaces='graphlearn_tpu/ops/sample_fused.py:86',
           launches=counts['sample_hop'],
           max_abs_err=ktab['sample_hop'][0]['max_abs_err'],
           ms=ktab['sample_hop'][0]['ms'],
           plain_ms=ktab['sample_hop'][0]['plain_ms'],
           bound_ms=ktab['sample_hop'][0]['bound_ms'], bound_by='bytes',
           library_ms=ktab['sample_hop'][0]['library_ms']),
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

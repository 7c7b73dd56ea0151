"""Multi-hop neighbor sampler, homogeneous and typed: the tree and merge
engines over the JAX package's four sampling backends.

Counterpart of ``graphlearn_tpu/sampler/neighbor_sampler.py``. The JAX
package compiles the whole multi-hop sample into one program
(``_fused_homo_fn``); PyTorch runs eagerly, so the same program is a
Python loop over hops, over static capacities. Each hop is routed as
``_fused_homo_fn`` routes it:

- ``padded_window`` (an int or 'auto'): ``ops.uniform_sample_padded`` over
  a ``[N, W]`` table of each row's shuffled first W neighbours, built on
  the device (``ops.build_padded_adjacency_device``) from the key of
  ``_padded_seed`` when first needed; the loaders reseed it between
  epochs (``refresh_padded_table``), in place.
- ``strategy='block'``: ``ops.uniform_sample_block`` over the
  FILL-padded ``[E/16, 16]`` view of the indices.
- ``with_weight=True`` (on a graph with edge weights):
  ``ops.weighted_sample`` over the exact row CDF
  (``ops.build_row_cumsum``, built on the host once).
- otherwise uniform: the tree engine takes the fused hop
  (``ops.sample_hop_fused``: one launch of the hop kernel on the card),
  the merge engine the fused level (``ops.sample_level_fused``: three
  launches of the level kernel over a scratch the sampler keeps per node
  capacity, begun once per batch).

The padded, block and weighted hops draw through ``ops.draw.uniform``
(one launch on the card) and are followed by the engine's own inducer:
``induce_next_tree`` or ``induce_next_merge``, as in JAX, which never
routes them through its level kernel.

- ``dedup='tree'`` (alias 'none'): the positional tree inducer; hop i's
  frontier is ``caps[i] = min(caps[i-1] * k, node_budget)`` slots.
- ``dedup='map_table'`` / ``'sort_legacy'``: the legacy exact engines
  (``ops.induce_map``'s direct-address table, ``ops.induce``'s
  searchsorted view), kept for parity and bisection as in JAX; their
  uniform hops take the fused hop (the hop kernel on the card).
- ``dedup='auto'`` (the default; aliases 'map', 'sort', 'merge'): exact
  dedup. ``frontier_caps`` clamps the per-hop frontiers
  (``sampler.calibrate``) and ``node_budget`` every one of them; a batch
  whose new nodes exceed a clamped cap is truncated and raises the
  on-device ``metadata['overflow']`` flag. Only ``frontier_caps`` make
  the loaders' overflow guard watch the flag (``clamped_exact``):
  ``node_budget`` truncation is the caller's stated trade, as in JAX.

The PRNG stream is the JAX package's: one key per batch by ``fold_in``
of a host call counter into the base key, one key per hop by ``split``.
So the port's batches equal the JAX sampler's, id for id. A loader call
derives its key on the host and uploads the hop keys once per batch, as
one ``[n_hops, 2]`` tensor that the kernels read; an epoch trainer hands
``_sample`` hop keys it derived on the device (``ops.step_keys``), the
same words without a host step.

Edge direction: ``row`` is the neighbor (message source) local index and
``col`` the seed (target), as in the JAX package. ``with_edge`` adds each
sampled edge's global id (the graph's ``edge_ids`` at the hop's edge
position, -1 where masked) as ``SamplerOutput.edge``.

Typed graphs (a dict of ``Graph`` by ``EdgeType``, fanouts a list or a
per-edge-type dict) run the typed engine (``_hetero_sample_from_nodes``):
one hop per ``(hop, edge type)`` item of ``hetero_capacity_plan`` (sorted
edge types within a hop), each with one key of the sampler's own stream
in that order, as JAX's ``sample_one_hop`` draws them; uniform hops take
the fused hop (the hop kernel on the card), block and weighted hops the
draw kernel. The merge engine never runs its fused level on typed graphs,
as in JAX. With ``edge_dir='out'`` an edge type ``(u, r, v)`` expands a
``u`` frontier into ``v`` neighbours and is emitted under
``reverse_edge_type`` (row = the ``v`` neighbour, col = the ``u`` seed).

Beside ``sample_from_nodes``: ``sample_from_edges`` (link sampling: the
negatives drawn on the device by ``ops.random_negative_sample``, one
launch on the card, and the seed union sampled without a host round
trip), ``subgraph`` (the induced subgraph of a sampled node set,
``ops.node_subgraph``), ``sample_pyg_v1`` and ``sample_one_hop``.
"""
import copy
from typing import Dict, Optional

import numpy as np
import torch

from .. import metrics, ops
from .. import random as trandom
from ..data import Graph
from ..ops.unique import FILL
from ..typing import EdgeType, NodeType, reverse_edge_type
from .base import (EdgeSamplerInput, HeteroSamplerOutput, NeighborOutput,
                   NodeSamplerInput, SamplerOutput)
from .calibrate import clamp_etype_cap, normalize_hetero_frontier_caps


def _round_up(n: int, multiple: int = 8) -> int:
  return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def capacity_plan(batch_cap: int, fanouts, node_budget=None,
                  frontier_caps=None):
  """Per-hop frontier capacities ``[b, c1, ...]``: ``c_{i+1} = c_i * k_i``
  clamped by ``node_budget`` and by ``frontier_caps[i]`` (the calibrated
  post-dedup caps of ``sampler.calibrate``)."""
  caps = [batch_cap]
  for i, k in enumerate(fanouts):
    nxt = caps[-1] * k
    if node_budget is not None:
      nxt = min(nxt, node_budget)
    if frontier_caps is not None and i < len(frontier_caps) and \
        frontier_caps[i] is not None:
      nxt = min(nxt, frontier_caps[i])
    caps.append(nxt)
  return caps


def tree_layout_from_caps(caps, fanouts):
  """(hop_node_offsets, hop_edge_offsets) of the tree positional layout
  for a capacity plan."""
  node_offs = [caps[0]]
  edge_offs = []
  total_e = 0
  for i, k in enumerate(fanouts):
    seg = caps[i] * k
    total_e += seg
    edge_offs.append(total_e)
    node_offs.append(node_offs[-1] + seg)
  return tuple(node_offs), tuple(edge_offs)


def merge_layout_from_caps(caps, fanouts):
  """(prefix_offsets, edge_offsets) of the merge-engine layout:
  ``prefix_offsets[i]`` is the clamped occupancy bound before hop i (the
  inducer's ``prefix_cap``), the node capacity ``sum(caps)`` last; edge
  block i is ``caps[i] * k`` wide. Shared by the sampler and
  ``models.train.merge_hop_offsets``."""
  node_offs = [caps[0]]
  edge_offs = []
  tot_e = 0
  for i, k in enumerate(fanouts):
    tot_e += caps[i] * k
    edge_offs.append(tot_e)
    node_offs.append(node_offs[-1] + caps[i + 1])
  return tuple(node_offs), tuple(edge_offs)


def tree_layout(batch_cap: int, fanouts, node_budget=None):
  """(hop_node_offsets, hop_edge_offsets): the one layout plan shared by
  the sampler's buffers and the layered model forward."""
  return tree_layout_from_caps(capacity_plan(batch_cap, fanouts,
                                             node_budget), fanouts)


def _tree_node_cap(caps, fanouts) -> int:
  """Positional layout size: seeds block + one full block per hop."""
  return tree_layout_from_caps(caps, fanouts)[0][-1]


def _final_touch_map(items, edge_dir):
  """{result node type -> index of its last induce within a hop's
  ``(edge_type, caps)`` items}: the typed engine passes ``final=True``
  there on the last hop, so the merge engine skips its sorted-view
  rebuild (only nodes / num_nodes are read afterwards)."""
  last = {}
  for j, (et, _) in enumerate(items):
    last[et[2] if edge_dir == 'out' else et[0]] = j
  return last


def hetero_capacity_plan(etypes, fanouts_of, seed_caps, edge_dir,
                         etype_caps=None):
  """Static typed buffer plan shared by the typed engine and the
  hierarchical model layout (``graphlearn_tpu/sampler/neighbor_sampler.py:
  hetero_capacity_plan``).

  Returns ``(ntypes, hop_caps, node_caps)``: ``hop_caps[h]`` maps each
  edge type active at hop ``h`` to ``(source-frontier capacity, fanout,
  new-node cap)``; ``node_caps[t]`` is node type ``t``'s total buffer
  size.

  ``etype_caps`` (``{etype: [per-hop caps]}``,
  calibrate.estimate_hetero_frontier_caps) clamps the NEW unique nodes
  each (hop, etype) may contribute — without it the plan compounds
  worst case across etypes every hop (new-node cap == fcap * k) and a
  reference-shaped 3-hop config statically exceeds the graph itself.
  Calibrated plans stay exact while no batch overflows a cap (the typed
  engine raises the on-device overflow flag when one does).
  """
  # canonical intra-hop order: every consumer of this plan (the typed
  # engine's hop loop, hetero_tree_layout, hetero_tree_blocks) takes its
  # (hop, etype) order from hop_caps's dict order, so building it sorted
  # makes the positional layout independent of the caller's etype order
  etypes = sorted(tuple(et) for et in etypes)
  num_hops = max(len(fanouts_of(et)) for et in etypes)
  ntypes = set()
  for (u, _, v) in etypes:
    ntypes.update((u, v))
  frontier_cap = {t: seed_caps.get(t, 0) for t in ntypes}
  node_caps = dict(frontier_cap)
  hop_caps = []
  for hop in range(num_hops):
    adds = {t: 0 for t in ntypes}
    per_et = {}
    for et in etypes:
      fo = fanouts_of(et)
      if hop >= len(fo):
        continue
      k = fo[hop]
      key_t = et[0] if edge_dir == 'out' else et[2]
      res_t = et[2] if edge_dir == 'out' else et[0]
      fcap = frontier_cap.get(key_t, 0)
      if fcap == 0 or k == 0:
        continue
      cap = clamp_etype_cap(etype_caps, et, hop, fcap * k)
      per_et[et] = (fcap, k, cap)
      adds[res_t] += cap
    hop_caps.append(per_et)
    for t in ntypes:
      frontier_cap[t] = adds[t]
      node_caps[t] += adds[t]
  return ntypes, hop_caps, node_caps


def hetero_tree_layout(seed_caps: Dict[NodeType, int], etypes,
                       num_neighbors, edge_dir: str = 'out',
                       etype_caps=None):
  """(hop_node_offsets, hop_edge_offsets) of the hetero tree-mode
  positional layout — the typed counterpart of ``tree_layout`` consumed
  by the hierarchical (trim-per-layer) hetero model forward.

  ``seed_caps`` must match the engine's seed buffer sizes: for
  single-type seeds that is the loader's ``batch_size`` (its
  ``batch_cap``); multi-type seeds round up to 8.

  Returns ``({ntype: (o_0, ..., o_H)}, {out_etype: (e_1, ..., e_H)})``
  where ``o_h`` is the node-buffer prefix holding every node of depth
  <= h and ``e_h`` the edge-buffer prefix holding hops 1..h; output edge
  types are reversed from the stored etypes when ``edge_dir='out'``
  (the engine emits message-flow orientation).

  ``etype_caps`` (calibrate.estimate_hetero_frontier_caps) gives the
  CALIBRATED layout: node prefixes grow by each (hop, etype)'s clamped
  new-node cap while edge segments keep their ``fcap * k`` emission
  width — matching the clamped typed engine exactly (fcap itself
  shrinks because the previous hop's frontier was clamped).
  """
  etypes = [tuple(et) for et in etypes]
  fanouts_of = ((lambda et: list(num_neighbors[et]))
                if isinstance(num_neighbors, dict)
                else (lambda et: list(num_neighbors)))
  ntypes, hop_caps, _ = hetero_capacity_plan(etypes, fanouts_of,
                                             seed_caps, edge_dir,
                                             etype_caps=etype_caps)
  node_offs = {t: [seed_caps.get(t, 0)] for t in ntypes}
  out_ets = [reverse_edge_type(et) if edge_dir == 'out' else et
             for et in etypes]
  edge_tot = {et: 0 for et in out_ets}
  edge_offs = {et: [] for et in out_ets}
  for per_et in hop_caps:
    adds = {t: 0 for t in ntypes}
    seg = {et: 0 for et in out_ets}
    for et, (fcap, k, cap) in per_et.items():
      res_t = et[2] if edge_dir == 'out' else et[0]
      out_et = reverse_edge_type(et) if edge_dir == 'out' else et
      adds[res_t] += cap          # == fcap * k on unclamped plans
      seg[out_et] += fcap * k     # emission width is never clamped
    for t in ntypes:
      node_offs[t].append(node_offs[t][-1] + adds[t])
    for et in out_ets:
      edge_tot[et] += seg[et]
      edge_offs[et].append(edge_tot[et])
  return ({t: tuple(v) for t, v in node_offs.items()},
          {et: tuple(v) for et, v in edge_offs.items()})


def hetero_tree_blocks(seed_caps: Dict[NodeType, int], etypes,
                       num_neighbors, edge_dir: str = 'out',
                       etype_caps=None):
  """Per-(hop, edge-type) dense-aggregation records for typed tree
  batches — the typed counterpart of the homo dense-run layout
  (models.TreeSAGEConv): within hop ``h``, each edge type's children
  occupy a CONTIGUOUS ``fcap*k`` block of the result type's buffer (the
  engine appends per (hop, etype) in ``hop_caps`` order), their
  targets are the key type's contiguous frontier block, and the edge
  block is the out-etype's hop-``h`` segment. Consumed by
  ``models.TreeHeteroConv``.

  Returns ``(records, node_offs, edge_offs)`` with ``records[h]`` a
  tuple of dicts ``{et, out_et, key_t, res_t, fcap, k, cap, child_base,
  parent_base, edge_base}`` and node_offs/edge_offs the
  hetero_tree_layout offsets (returned so one call serves both the
  records and the hierarchical model layout — paired calls with
  diverging arguments would silently mis-base the layout).

  With ``etype_caps`` (the calibrated merge layout), ``cap`` is the
  clamped new-node cap and ``child_base`` is NOT meaningful — clamped
  merge states pack kept nodes by dynamic valid counts, so the dense
  merge conv gathers children through the edge rows instead of a
  positional slice (models.TreeHeteroConv mode='merge').
  """
  etypes = [tuple(et) for et in etypes]
  fanouts_of = ((lambda et: list(num_neighbors[et]))
                if isinstance(num_neighbors, dict)
                else (lambda et: list(num_neighbors)))
  ntypes, hop_caps, _ = hetero_capacity_plan(etypes, fanouts_of,
                                             seed_caps, edge_dir,
                                             etype_caps=etype_caps)
  node_offs, edge_offs = hetero_tree_layout(seed_caps, etypes,
                                            num_neighbors, edge_dir,
                                            etype_caps=etype_caps)
  records = []
  for h, per_et in enumerate(hop_caps):
    recs = []
    child_off = {t: node_offs[t][h] for t in ntypes}   # hop-h block start
    for et, (fcap, k, cap) in per_et.items():
      key_t = et[0] if edge_dir == 'out' else et[2]
      res_t = et[2] if edge_dir == 'out' else et[0]
      out_et = reverse_edge_type(et) if edge_dir == 'out' else et
      recs.append(dict(
          et=et, out_et=out_et, key_t=key_t, res_t=res_t, fcap=fcap,
          k=k, cap=cap, child_base=child_off[res_t],
          parent_base=0 if h == 0 else node_offs[key_t][h - 1],
          edge_base=(0 if h == 0 else edge_offs[out_et][h - 1])))
      child_off[res_t] += cap
    records.append(tuple(recs))
  return tuple(records), node_offs, edge_offs


def _inducer_for(mode: str, num_graph_nodes: int = 0):
  """``(init(seeds, mask, capacity), init_empty(capacity, device=),
  induce(state, fidx, nbrs, m, offset, compact=True, final=False,
  max_new=None))`` of a dedup engine: one dispatch for the homogeneous
  and typed engines (``graphlearn_tpu/sampler/neighbor_sampler.py:
  _inducer_for``). ``offset`` is the tree's slot base or the merge
  engine's prefix cap; ``compact`` the map engine's compaction; ``final``
  marks the last hop induced on a state (the merge engine skips its view
  rebuild). ``init_empty`` starts the typed engine's states of node types
  first reached mid-hop."""
  if mode == 'merge':
    return ops.init_node_merge, ops.init_empty_merge, \
        lambda st, fi, nb, m, off, compact=True, final=False, \
        max_new=None: \
        ops.induce_next_merge(st, fi, nb, m, prefix_cap=off,
                              max_new=max_new, update_view=not final)
  if mode == 'map_table':
    def _no_empty_map(capacity, device=None):
      raise NotImplementedError(
          'map-table lazy (empty) inducer states are not implemented — '
          'the hetero engines use merge/tree modes; add an '
          'ops.init_empty_map before wiring map_table into a typed path')

    return (lambda s, m, capacity: ops.init_node_map(
        s, m, capacity, num_graph_nodes)), _no_empty_map, \
        lambda st, fi, nb, m, off, compact=True, final=False, \
        max_new=None: \
        ops.induce_next_map(st, fi, nb, m, compact_frontier=compact)
  if mode == 'sort_legacy':
    return ops.init_node, ops.init_empty, \
        lambda st, fi, nb, m, off, compact=True, final=False, \
        max_new=None: \
        ops.induce_next(st, fi, nb, m)
  assert mode == 'tree', f'unknown dedup mode {mode!r}'
  return ops.init_node_tree, ops.init_empty_tree, \
      lambda st, fi, nb, m, off, compact=True, final=False, \
      max_new=None: \
      ops.induce_next_tree(st, fi, nb, m, off)


def _upload(arr, dtype, device):
  """A host array on ``device``: on a card, one copy from pinned memory
  that does not block the host."""
  t = torch.as_tensor(np.ascontiguousarray(arr)).to(dtype)
  if device.type != 'cuda':
    return t.to(device)
  return t.pin_memory().to(device, non_blocking=True)


def _jax_dtype(arr: np.ndarray):
  """The dtype ``jnp.asarray`` gives a host array (64-bit values become
  32-bit: the JAX package runs without x64)."""
  arr = np.asarray(arr)
  if arr.dtype == np.int64:
    return torch.int32
  if arr.dtype == np.float64:
    return torch.float32
  return torch.from_numpy(arr[:0].copy()).dtype


class NeighborSampler:
  """Fanout neighbor sampling over a device CSR.

  Args:
    graph: a ``Graph``, or a dict of them by ``EdgeType`` (typed).
    num_neighbors: per-hop fanouts: a list, or on a typed graph a dict of
      lists by edge type.
    device: torch device (None means the card); must be the graph's,
      unless the graph is a 'CPU'-mode one, which is copied there.
    with_weight: edge-weight-biased sampling (on a graph built with
      ``edge_weights``; without them the hops are uniform, as in JAX).
    strategy: 'random' (uniform) or 'block' (cluster sampling over
      aligned 16-wide CSR blocks; fanouts up to 16).
    seed: PRNG seed (None = 0).
    node_budget: clamp on every hop's frontier capacity (homogeneous).
    dedup: 'auto' (default; also 'map', 'sort', 'merge') runs the merge
      exact-dedup engine, 'tree' (or its alias 'none') the positional
      tree engine, 'map_table' / 'sort_legacy' the legacy exact engines.
    padded_window: sample from a ``[N, W]`` padded table (an int W, or
      'auto': ``ops.choose_padded_window``); homogeneous uniform
      sampling only.
    frontier_caps: calibrated caps for the merge engine only: per-hop
      post-dedup frontier caps (a list, e.g. from
      ``sampler.calibrate.estimate_frontier_caps``), or on a typed graph
      per-(hop, edge type) new-node caps (``{edge_type: [per-hop caps]}``
      from ``estimate_hetero_frontier_caps``).
    with_edge: also emit each sampled edge's global id.
    edge_dir: 'out' (the graph is a CSR of out-edges) or 'in' (a CSC):
      link sampling flips its negatives to (src, dst) under 'in'; the
      typed engine keys each edge type by its src ('out') or dst ('in').
  """

  def __init__(self, graph, num_neighbors=None, device=None,
               with_edge: bool = False, with_weight: bool = False,
               strategy: str = 'random', seed: Optional[int] = None,
               node_budget=None, dedup: str = 'auto', padded_window=None,
               frontier_caps=None, edge_dir: str = 'out'):
    from ..utils import resolve_device
    hetero = isinstance(graph, dict)
    if isinstance(num_neighbors, dict) and not hetero:
      raise ValueError('per-edge-type fanouts need a typed (dict) graph')
    self.dedup = dedup
    self.with_edge = with_edge
    self.edge_dir = edge_dir
    mode = self._dedup_mode()
    if frontier_caps is not None:
      if mode == 'tree':
        # tree frontiers are un-deduped (positional): clamping them with
        # post-dedup caps would silently truncate most samples; budget
        # truncation on tree batches is node_budget's job
        raise ValueError('frontier_caps requires an exact-dedup mode '
                         "(map/sort/merge); use node_budget with "
                         "dedup='tree'")
      if mode in ('map_table', 'sort_legacy'):
        # no clean-truncation contract and no overflow flag: clamping
        # them would bring back the silent bias the merge guard prevents
        raise ValueError(f'frontier_caps is not supported with the legacy '
                         f'{dedup!r} engine (no overflow detection); use '
                         "dedup='merge'")
      if hetero:
        frontier_caps = normalize_hetero_frontier_caps(frontier_caps, graph)
      elif isinstance(frontier_caps, dict):
        raise ValueError('dict-form frontier_caps is hetero-only; pass '
                         'a per-hop list on homogeneous graphs')
      else:
        frontier_caps = tuple(frontier_caps)
    self.frontier_caps = frontier_caps
    fo = (list(num_neighbors) if num_neighbors is not None and
          not isinstance(num_neighbors, dict) else [])
    # the JAX sampler's validation, in its order and words
    if padded_window == 'auto':
      if not fo:
        raise ValueError("padded_window='auto' needs a fanout list")
      padded_window = ops.choose_padded_window(fo)
    if strategy == 'block':
      if with_weight:
        raise ValueError('block sampling does not support weights')
      if padded_window is not None:
        raise ValueError("strategy='block' and padded_window are "
                         'mutually exclusive sampling backends')
      if fo and max(fo) > ops.BLOCK:
        raise ValueError(f'block sampling caps fanouts at {ops.BLOCK}')
    if padded_window is not None:
      if with_weight:
        raise ValueError('padded_window does not support weighted '
                         'sampling')
      if hetero:
        raise ValueError('padded_window is homogeneous-only (the typed '
                         'engine samples the CSR directly)')
      if fo and padded_window < max(fo):
        raise ValueError(
            f'padded_window={padded_window} < max fanout {max(fo)}: '
            'rows with degree > window would silently under-sample '
            '(the table caps per-row candidates at the window)')
    self.with_weight, self.strategy = with_weight, strategy
    self.padded_window = padded_window
    self.node_budget = node_budget
    self.device = resolve_device(device)
    if hetero:
      self.graph = {tuple(et): self._placed(g) for et, g in graph.items()}
      self.num_neighbors = (
          {tuple(et): list(v) for et, v in num_neighbors.items()}
          if isinstance(num_neighbors, dict) else fo)
    else:
      self.graph = self._placed(graph)
      self.num_neighbors = fo
    self._key = trandom.PRNGKey(0 if seed is None else seed)
    self._call_count = 0    # host-side PRNG stream position
    self._padded_seed = 0 if seed is None else seed
    self._scratch = {}      # node capacity -> the level kernel's scratch
    # the backends' device arrays, built at first use: the padded table
    # (reseeded in place), and per edge type (None: the homogeneous
    # graph) the block view, the row CDF and the row-sorted indices of
    # negative sampling (with a typed link batch's id ranges)
    self._padded = None
    self._blocks = {}
    self._cumsum = {}
    self._neg_indices = {}
    self._neg_ranges = {}

  def _placed(self, graph: Graph) -> Graph:
    """``graph`` on the sampler's device: a 'CPU'-mode graph is copied
    there, any other must already lie there."""
    if graph.mode == 'CPU':
      graph = graph.on(self.device)
    if graph.device != self.device:
      raise ValueError(f'graph lives on {graph.device}, sampler asked for '
                       f'{self.device}')
    return graph

  @property
  def is_hetero(self) -> bool:
    return isinstance(self.graph, dict)

  def _get_graph(self, etype: Optional[EdgeType] = None) -> Graph:
    return self.graph[etype] if self.is_hetero else self.graph

  def _dedup_mode(self) -> str:
    """The engine: 'tree' for 'tree'/'none', 'merge' for
    'map'/'sort'/'merge'/'auto', and the legacy 'map_table' /
    'sort_legacy' by name (as in the JAX package)."""
    if self.dedup in ('tree', 'none'):
      return 'tree'
    if self.dedup in ('map_table', 'sort_legacy'):
      return self.dedup
    if self.dedup in ('map', 'sort', 'merge', 'auto'):
      return 'merge'
    raise ValueError(f'unknown dedup mode {self.dedup!r}')

  @property
  def weighted(self) -> bool:
    """Weighted hops: ``with_weight`` on a graph that has edge weights."""
    return self._weighted()

  def _weighted(self, etype=None) -> bool:
    return self.with_weight and \
        self._get_graph(etype).edge_weights is not None

  def _backend(self) -> str:
    """The hop op: 'padded', 'block', 'weighted' or 'fused' (the hop or
    level kernel)."""
    if self.padded_window is not None:
      return 'padded'
    if self.strategy == 'block':
      return 'block'
    return 'weighted' if self.weighted else 'fused'

  def hop_caps(self, batch_cap: int):
    """The resolved per-hop frontier capacities: a batch truncated under
    calibrated caps has ``num_sampled_nodes[i+1] > hop_caps[i+1]``."""
    if self.is_hetero:
      # graftlint: allow[hetero-gate] homo accessor by contract
      raise ValueError('hop_caps is homogeneous-only (the typed engine '
                       'plans capacities per edge type)')
    return capacity_plan(batch_cap, self.num_neighbors, self.node_budget,
                         self.frontier_caps)

  @property
  def clamped_exact(self) -> bool:
    """True when the merge engine runs under calibrated frontier_caps:
    the configuration whose batches can be truncated, which the loaders'
    overflow guard watches."""
    return self.frontier_caps is not None and self._dedup_mode() == 'merge'

  def uncapped_clone(self) -> 'NeighborSampler':
    """A sampler sharing this one's graph, PRNG base and backend arrays,
    without frontier_caps: the full-capacity replay target of the
    overflow guard's 'recompute' policy."""
    clone = copy.copy(self)
    clone.frontier_caps = None
    clone._scratch = {}
    return clone

  def _next_key(self):
    """Per-call key: fold_in of the host counter into the base key."""
    self._call_count += 1
    return trandom.fold_in(self._key, self._call_count)

  def state_dict(self):
    return {'call_count': int(self._call_count),
            'base_key': self._key.tolist()}

  def load_state_dict(self, state):
    if 'call_count' not in state:
      raise ValueError(
          f'checkpoint sampler state {sorted(state)} was written by a '
          'different sampler type; resuming would diverge')
    self._call_count = int(state['call_count'])
    if 'base_key' in state:
      self._key = torch.as_tensor(state['base_key'], dtype=torch.int64)

  # ------------------------------------------------------ backend arrays

  def _build_padded(self):
    g = self.graph
    tab, deg, eptab = ops.build_padded_adjacency_device(
        g.indptr, g.indices, self.padded_window,
        trandom.PRNGKey(self._padded_seed), edge_pos=self.with_edge)
    arrays = dict(tab=tab, deg=deg)
    if eptab is not None:     # with_edge: each slot's edge position
      arrays['eptab'] = eptab
    return arrays

  def _padded_arrays(self):
    """The ``[N, W]`` padded table and its ``[N]`` degrees (and with
    ``with_edge`` the ``[N, W]`` edge positions), built on the device from
    ``PRNGKey(_padded_seed)`` at first use (JAX builds it lazily too). A
    reseed writes into these tensors, so a captured CUDA graph that read
    them samples the new table."""
    if self._padded is None:
      self._padded = self._build_padded()
    return self._padded

  def _reseed_padded(self, seed: int):
    """Set the padded table's seed; a built table is rebuilt from it in
    place (JAX drops its cached table and rebuilds lazily: the same
    table, but a captured graph keeps the old one's address)."""
    self._padded_seed = int(seed)
    if self._padded is not None:
      new = self._build_padded()
      for name, t in self._padded.items():
        t.copy_(new[name])

  def refresh_padded_table(self, seed: Optional[int] = None):
    """A fresh shuffle of the padded table, so rows with deg > window
    sample a new random window-subset: the loaders call it between
    epochs."""
    if self.padded_window is None:
      return
    self._reseed_padded(self._padded_seed + 1 if seed is None else seed)

  def _block_arrays(self, etype=None):
    """(FILL-padded ``[ceil(E/16), 16]`` view of the indices, ``[N, 2]``
    (start, degree) table) of the graph of ``etype``, built on the device
    at first use."""
    if etype not in self._blocks:
      g = self._get_graph(etype)
      ind = g.indices
      pad = (-ind.shape[0]) % ops.BLOCK
      if pad:
        ind = torch.cat([ind, ind.new_full((pad,), FILL)])
      self._blocks[etype] = (ind.reshape(-1, ops.BLOCK), g.csr_meta)
    return self._blocks[etype]

  def _cumsum_for(self, etype=None):
    """The exact float32 row CDF of the edge weights of the graph of
    ``etype`` (built on the host once, ``ops.build_row_cumsum``), on the
    sampler's device."""
    if etype not in self._cumsum:
      g = self._get_graph(etype)
      if g.edge_weights is None:
        raise ValueError('with_weight=True requires edge_weights')
      self._cumsum[etype] = torch.as_tensor(
          ops.build_row_cumsum(g.topo.indptr, g.edge_weights)).to(
              self.device)
    return self._cumsum[etype]

  def _level_scratch(self, state, prefix_len: int):
    """The level kernel's scratch for this batch's node capacity, begun
    from the seeds' state (one launch); None on the CPU."""
    if state.nodes.device.type == 'cpu':
      return None
    cap = state.nodes.shape[0]
    scratch = self._scratch.get(cap)
    if scratch is None:
      scratch = ops.LevelScratch(self.graph.num_nodes, cap,
                                 state.nodes.device)
      self._scratch[cap] = scratch
    return scratch.begin(state, prefix_len)

  # ---------------------------------------------------------------- hops

  def _hop(self, backend, frontier, fmask, k, key, etype=None):
    """``(nbrs, epos, mask)`` of one padded, block, weighted or fused
    hop over the graph of ``etype``."""
    g = self._get_graph(etype)
    if backend == 'padded':
      pa = self._padded_arrays()
      return ops.uniform_sample_padded(pa['tab'], pa['deg'], frontier,
                                       fmask, k, key,
                                       epos_table=pa.get('eptab'))
    if backend == 'block':
      blocks, meta = self._block_arrays(etype)
      return ops.uniform_sample_block(meta, blocks, g.num_edges, frontier,
                                      fmask, k, key)
    if backend == 'weighted':
      return ops.weighted_sample(g.indptr, g.indices,
                                 self._cumsum_for(etype), frontier, fmask,
                                 k, key)
    return ops.sample_hop_fused(g.indptr, g.indices, None, frontier, fmask,
                                k, key, meta=g.csr_meta)

  def _edge_ids(self, epos, emask, etype=None):
    """Global edge ids of flat edge positions: the ``edge_ids`` of the
    graph of ``etype`` at ``epos`` (``epos`` itself without them), -1
    where ``emask`` is False."""
    flat = epos.reshape(-1).to(torch.int64)
    eids = self._get_graph(etype).edge_ids
    if eids is not None:
      if eids.shape[0] == 0:
        return torch.full_like(flat, -1)
      flat = eids[flat.clamp(0, eids.shape[0] - 1)]
    return torch.where(emask.reshape(-1), flat, -1)

  def _one_hop_backend(self, etype=None) -> str:
    """``sample_one_hop``'s route: 'weighted', 'block' or 'fused'."""
    return ('weighted' if self._weighted(etype) else
            'block' if self.strategy == 'block' else 'fused')

  def sample_one_hop(self, srcs, src_mask, k: int, key=None,
                     etype: Optional[EdgeType] = None) -> NeighborOutput:
    """One fanout hop over the graph (of ``etype`` on a typed graph):
    ``[B]`` seeds -> dense ``[B, k]`` neighbours and mask, with their edge
    ids under ``with_edge``; weighted or block (the draw kernel on the
    card) or uniform (the hop kernel on the card), as JAX's
    ``sample_one_hop``. ``key`` defaults to the next of the sampler's
    stream."""
    if key is None:
      key = self._next_key()
    srcs = torch.as_tensor(srcs).to(self.device, torch.int32)
    src_mask = torch.as_tensor(src_mask).to(self.device, torch.bool)
    nbrs, epos, mask = self._hop(self._one_hop_backend(etype), srcs,
                                 src_mask, k, key, etype)
    edges = (self._edge_ids(epos, mask, etype).reshape(mask.shape)
             if self.with_edge else None)
    return NeighborOutput(nbrs=nbrs, mask=mask, edges=edges)

  def _sample(self, seeds, seed_mask, key=None, hop_keys=None):
    """The multi-hop program (``_fused_homo_fn``) under the batch key
    ``key`` (split here into one key per hop) or the ``[n_hops, 2]``
    ``hop_keys`` already on the seeds' device."""
    fanouts = self.num_neighbors
    batch_cap = seeds.shape[0]
    caps = self.hop_caps(batch_cap)
    g = self.graph
    mode = self._dedup_mode()
    merge = mode == 'merge'
    backend = self._backend()
    level = merge and backend == 'fused'    # the fused level kernel
    init_fn, _, induce_fn = _inducer_for(mode, g.num_nodes)
    if mode == 'tree':
      state, frontier, fmask, inv = init_fn(
          seeds, seed_mask, capacity=_tree_node_cap(caps, fanouts))
      node_offs, _ = tree_layout_from_caps(caps, fanouts)
    else:
      state, frontier, fmask, inv = init_fn(seeds, seed_mask,
                                            capacity=sum(caps))
      node_offs, _ = merge_layout_from_caps(caps, fanouts)
    scratch = self._level_scratch(state, batch_cap) if level else None
    fidx = torch.arange(batch_cap, dtype=torch.int32, device=seeds.device)
    rows, cols, emasks, edges = [], [], [], []
    nodes_per_hop = [state.num_nodes]
    edges_per_hop = []
    # on-device truncation flag: True iff a clamped merge hop found more
    # new nodes than its cap kept (constant False on unclamped plans)
    overflow = torch.zeros((), dtype=torch.bool, device=seeds.device)
    if hop_keys is None:
      keys = trandom.split(key, len(fanouts))
      if seeds.device.type == 'cuda':
        keys = trandom.to_device(keys, seeds.device)
    else:
      keys = hop_keys
    for i, k in enumerate(fanouts):
      final = i + 1 == len(fanouts)
      if level:
        state, out, epos, _ = ops.sample_level_fused(
            g.indptr, g.indices, None, frontier, fmask, k, keys[i], state,
            fidx, meta=g.csr_meta, prefix_cap=node_offs[i],
            max_new=caps[i + 1], final=final, scratch=scratch)
      else:
        nbrs, epos, m = self._hop(backend, frontier, fmask, k, keys[i])
        # the map engine emits its frontier positionally when nothing
        # truncates it (JAX's compaction switch)
        state, out = induce_fn(state, fidx, nbrs, m, node_offs[i],
                               caps[i + 1] < caps[i] * k, final,
                               caps[i + 1])
      if merge and caps[i + 1] < caps[i] * k:
        overflow = overflow | (out['num_new'] > caps[i + 1])
      rows.append(out['cols'])     # message direction: neighbor -> seed
      cols.append(out['rows'])
      emasks.append(out['edge_mask'])
      if self.with_edge:
        edges.append(self._edge_ids(epos, out['edge_mask']))
      nodes_per_hop.append(out['num_new'])
      edges_per_hop.append(out['edge_mask'].sum().to(torch.int32))
      nxt = caps[i + 1]
      frontier = out['frontier'][:nxt]
      fidx = out['frontier_idx'][:nxt]
      fmask = out['frontier_mask'][:nxt]
    return dict(node=state.nodes, num_nodes=state.num_nodes,
                row=torch.cat(rows), col=torch.cat(cols),
                edge=torch.cat(edges) if self.with_edge else None,
                edge_mask=torch.cat(emasks), num_sampled_nodes=nodes_per_hop,
                num_sampled_edges=edges_per_hop, seed_inverse=inv,
                overflow=overflow)

  def _sample_seeds(self, seeds, seed_mask, key):
    """:meth:`_sample` of a sampler call, with the reference's
    kernel-path counter: one per call routed through the level kernel
    (merge) or the hop kernel (the other engines)."""
    if self._backend() == 'fused':
      if self._dedup_mode() == 'merge':
        metrics.inc('ops.fused_level_calls')
      else:
        metrics.inc('ops.fused_hop_calls')
    return self._sample(seeds, seed_mask, key)

  def sample_from_nodes(self, inputs: NodeSamplerInput,
                        batch_cap: Optional[int] = None,
                        key=None) -> SamplerOutput:
    """Multi-hop sample from seed nodes; seeds are padded to
    ``batch_cap`` (default: the seed count rounded up to 8).

    ``key``: explicit per-batch key (default: the next key of the
    sampler's own fold_in stream). The overflow guard replays a
    truncated batch at full capacities with the same key. Typed graphs
    draw from the sampler's stream only (``HeteroSamplerOutput``)."""
    if self.is_hetero:
      if key is not None:
        # typed batches draw one key per (hop, edge type) from the
        # sampler's own stream; ignoring an explicit key would let the
        # exact-replay contract degrade unnoticed
        raise NotImplementedError(
            'explicit key is homogeneous-only; hetero sampling uses the '
            "sampler's internal PRNG stream")
      return self._hetero_sample_from_nodes(inputs, batch_cap)
    seeds = np.asarray(inputs.node).reshape(-1)
    n = seeds.shape[0]
    cap = batch_cap or _round_up(n)
    padded = np.zeros((cap,), dtype=np.int32)
    padded[:n] = seeds
    mask = np.arange(cap) < n
    if key is None:
      key = self._next_key()
    seeds_d = _upload(padded, torch.int32, self.device)
    mask_d = _upload(mask, torch.bool, self.device)
    res = self._sample_seeds(seeds_d, mask_d, key)
    return SamplerOutput(
        node=res['node'], num_nodes=res['num_nodes'], row=res['row'],
        col=res['col'], edge=res['edge'], edge_mask=res['edge_mask'],
        batch=seeds_d, batch_size=n,
        num_sampled_nodes=res['num_sampled_nodes'],
        num_sampled_edges=res['num_sampled_edges'],
        input_type=inputs.input_type,
        metadata={'seed_inverse': res['seed_inverse'], 'seed_mask': mask,
                  'overflow': res['overflow']})

  # ----------------------------------------------------------- typed path

  def _etype_fanouts(self, etype: EdgeType):
    nn = self.num_neighbors
    return list(nn[etype]) if isinstance(nn, dict) else list(nn)

  def _hetero_sample_from_nodes(self, inputs, batch_cap=None):
    """The typed engine (``graphlearn_tpu/sampler/neighbor_sampler.py:
    _hetero_sample_from_nodes``): per node type one inducer state, per
    ``(hop, edge type)`` item of ``hetero_capacity_plan`` one hop and one
    induce into the result type's state.

    ``edge_dir='out'``: edge type ``(u, r, v)`` stores u's out-edges;
    the hop expands the u frontier into v neighbours, emitted under
    ``reverse_edge_type`` ``(v, rev_r, u)`` with row = the v neighbour
    and col = the u seed. ``edge_dir='in'``: the CSC by dst expands the
    v frontier into u in-neighbours, emitted under the edge type itself
    (row = u, col = v).

    The batch's keys are the next ``len(items)`` keys of the sampler's
    stream (``fold_in`` of the call counter), drawn on the host and, on
    a card, uploaded as one tensor: the same words as one
    ``sample_one_hop`` call per item. Dict ``inputs`` (``{ntype:
    seeds}``: host arrays, or tensors already on the sampler's device,
    as the typed link path gives) seed several types at once, each
    padded to a multiple of 8. Host seeds go up from pinned memory
    without a host sync."""
    dev = self.device
    if isinstance(inputs, dict):
      seeds_dict = {t: (v.reshape(-1) if torch.is_tensor(v)
                        else np.asarray(v).reshape(-1))
                    for t, v in inputs.items()}
      ntype = next(iter(seeds_dict))
    else:
      ntype = inputs.input_type
      assert ntype is not None, 'hetero sampling requires input_type'
      seeds_dict = {ntype: np.asarray(inputs.node).reshape(-1)}
    caps_in, batch_d, smask_d, dmask_d = {}, {}, {}, {}
    for t, sd in seeds_dict.items():
      n_t = sd.shape[0]
      c = (batch_cap if batch_cap and len(seeds_dict) == 1
           else _round_up(n_t))
      caps_in[t] = c
      smask_d[t] = np.arange(c) < n_t
      if torch.is_tensor(sd):
        # device seeds (the link path's union): padded on the device
        batch_d[t] = torch.cat([sd.to(dev, torch.int32), torch.zeros(
            c - n_t, dtype=torch.int32, device=dev)])
        dmask_d[t] = torch.arange(c, device=dev) < n_t
      else:
        buf = np.zeros((c,), np.int32)
        buf[:n_t] = sd
        batch_d[t] = _upload(buf, torch.int32, dev)
        dmask_d[t] = _upload(smask_d[t], torch.bool, dev)
    n = seeds_dict[ntype].shape[0]
    smask = smask_d[ntype]
    mode = self._dedup_mode()
    if mode == 'map_table':
      raise ValueError("dedup='map_table' is homogeneous-only (no lazy "
                       "empty inducer state); use 'map'/'sort'/'merge' "
                       'or tree for hetero graphs')
    clamped = self.frontier_caps is not None
    ntypes, hop_caps, node_caps = hetero_capacity_plan(
        list(self.graph.keys()), self._etype_fanouts, caps_in,
        self.edge_dir, etype_caps=self.frontier_caps if clamped else None)
    num_hops = len(hop_caps)
    init_seed, init_empty, induce = _inducer_for(mode)

    n_items = sum(len(per_et) for per_et in hop_caps)
    counts = torch.arange(self._call_count + 1,
                          self._call_count + n_items + 1, dtype=torch.int64)
    self._call_count += n_items
    keys = trandom.fold_in(self._key, counts)
    if dev.type == 'cuda':
      keys = trandom.to_device(keys, dev)

    states, frontier, inv_d = {}, {}, {}
    rows: Dict[EdgeType, list] = {}
    cols: Dict[EdgeType, list] = {}
    edges: Dict[EdgeType, list] = {}
    emasks: Dict[EdgeType, list] = {}
    nodes_per_hop: Dict[NodeType, list] = {t: [] for t in ntypes}
    edges_per_hop: Dict[EdgeType, list] = {}
    offsets = {t: caps_in.get(t, 0) for t in ntypes}
    for t in seeds_dict:
      st, uniq, umask, inv_t = init_seed(batch_d[t], dmask_d[t],
                                         capacity=node_caps[t])
      states[t] = st
      frontier[t] = (uniq, torch.arange(caps_in[t], dtype=torch.int32,
                                        device=dev), umask)
      inv_d[t] = inv_t
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for t in ntypes:
      nodes_per_hop[t].append(states[t].num_nodes if t in states else zero)

    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    j_all = 0
    for hop in range(num_hops):
      new_parts: Dict[NodeType, list] = {t: [] for t in ntypes}
      items = list(hop_caps[hop].items())
      last_touch = (_final_touch_map(items, self.edge_dir)
                    if hop + 1 == num_hops else {})
      for j, (et, (fcap, k, ecap)) in enumerate(items):
        key_t = et[0] if self.edge_dir == 'out' else et[2]
        res_t = et[2] if self.edge_dir == 'out' else et[0]
        out_et = reverse_edge_type(et) if self.edge_dir == 'out' else et
        f, fidx, fmask = (v[:fcap] for v in frontier[key_t])
        nbrs, epos, m = self._hop(self._one_hop_backend(et), f, fmask, k,
                                  keys[j_all], et)
        j_all += 1
        if res_t not in states:
          states[res_t] = init_empty(node_caps[res_t], device=dev)
        states[res_t], iout = induce(states[res_t], fidx, nbrs, m,
                                     offsets[res_t],
                                     final=last_touch.get(res_t) == j,
                                     max_new=ecap if clamped else None)
        # the occupancy bound advances by the clamped contribution (the
        # full fcap * k width on unclamped plans)
        offsets[res_t] += ecap
        rows.setdefault(out_et, []).append(iout['cols'])
        cols.setdefault(out_et, []).append(iout['rows'])
        emasks.setdefault(out_et, []).append(iout['edge_mask'])
        if self.with_edge:
          edges.setdefault(out_et, []).append(self._edge_ids(epos, m, et))
        edges_per_hop.setdefault(out_et, []).append(
            iout['edge_mask'].sum().to(torch.int32))
        if clamped and ecap < fcap * k:
          overflow = overflow | (iout['num_new'] > ecap)
        new_parts[res_t].append((iout['frontier'][:ecap],
                                 iout['frontier_idx'][:ecap],
                                 iout['frontier_mask'][:ecap]))
      # each type's next frontier: its parts of this hop, in item order
      for t in ntypes:
        parts = new_parts[t]
        if not parts:
          frontier[t] = (
              torch.zeros((0,), dtype=torch.int32, device=dev),
              torch.zeros((0,), dtype=torch.int32, device=dev),
              torch.zeros((0,), dtype=torch.bool, device=dev))
          nodes_per_hop[t].append(zero)
          continue
        fr = torch.cat([p[0] for p in parts])
        fi = torch.cat([p[1] for p in parts])
        fm = torch.cat([p[2] for p in parts])
        if mode == 'merge' and len(parts) > 1:
          # cross-part compaction: a part may end in invalid slots; a
          # stable valid-first sort restores the arithmetic frontier_idx
          # prefix the dense typed aggregation relies on
          # (models.TreeHeteroConv mode='merge' takes run bases as
          # min(tgt - j))
          order = torch.argsort((~fm).to(torch.int32), stable=True)
          fr, fi, fm = fr[order], fi[order], fm[order]
        frontier[t] = (fr, fi, fm)
        nodes_per_hop[t].append(fm.sum().to(torch.int32))

    return HeteroSamplerOutput(
        node={t: st.nodes for t, st in states.items()},
        num_nodes={t: st.num_nodes for t, st in states.items()},
        row={et: torch.cat(v) for et, v in rows.items()},
        col={et: torch.cat(v) for et, v in cols.items()},
        edge=({et: torch.cat(v) for et, v in edges.items()}
              if self.with_edge else None),
        edge_mask={et: torch.cat(v) for et, v in emasks.items()},
        batch=batch_d, batch_size=n,
        num_sampled_nodes=nodes_per_hop, num_sampled_edges=edges_per_hop,
        input_type=ntype,
        metadata={'seed_inverse': inv_d[ntype], 'seed_inverse_dict': inv_d,
                  'seed_mask': smask, 'overflow': overflow})

  # ---------------------------------------------------------------- link

  def _neg_sorted(self, etype: Optional[EdgeType] = None):
    """The CSR's indices (of ``etype`` on a typed graph) sorted within
    each row, on the device (``ops.sort_csr_rows``): negative sampling's
    membership view, built once per edge type (the graph is static)."""
    if etype not in self._neg_indices:
      g = self._get_graph(etype)
      self._neg_indices[etype] = ops.sort_csr_rows(g.indptr, g.indices)
    return self._neg_indices[etype]

  def _neg_range(self, etype: EdgeType):
    """``(num_key, num_other)`` of a typed link batch's negatives, as
    JAX's ``_hetero_sample_from_edges`` takes them: the CSR's row count
    and the largest neighbour id plus one (not the other type's node
    count). Read once from the host topology: JAX reads the indices
    every batch, which on a card would be a host sync."""
    if etype not in self._neg_ranges:
      topo = self._get_graph(etype).topo
      self._neg_ranges[etype] = (int(topo.indptr.shape[0]) - 1,
                                 int(np.asarray(topo.indices).max()) + 1)
    return self._neg_ranges[etype]

  def sample_from_edges(self, inputs: EdgeSamplerInput, key=None,
                        **kwargs):
    """Link sampling: negatives, the seed union, node sampling and the
    supervision metadata (``graphlearn_tpu/sampler/neighbor_sampler.py:
    sample_from_edges``).

    One key (``key``, or the next of the sampler's stream) splits into
    ``kneg``, which draws the negatives (``ops.random_negative_sample``,
    padding on: one launch on the card), and ``knode``, which samples the
    union of the positives' endpoints and the negatives (seeds padded to
    the union's length rounded up to 8). JAX fetches the negatives to the
    host to build the union; here it is built on the device, with the
    same values and no host round trip. The overflow guard replays a
    truncated batch at full capacities with the same ``key``.

    Metadata (local indices through ``seed_inverse``): binary and none,
    ``edge_label_index [2, b + num_neg]`` and ``edge_label`` (the input
    labels or ones, then zeros); triplet, ``src_index``,
    ``dst_pos_index`` and ``dst_neg_index``.

    Typed graphs take typed seed edges (``inputs.input_type`` the edge
    type) through :meth:`_hetero_sample_from_edges` (``kwargs``: its
    ``num_dst_nodes``); an explicit ``key`` is refused there, as in
    JAX."""
    if self.is_hetero:
      if key is not None:
        raise NotImplementedError(
            'explicit key is homogeneous-only; hetero sampling uses the '
            "sampler's internal PRNG stream")
      return self._hetero_sample_from_edges(inputs, **kwargs)
    if key is None:
      key = self._next_key()
    kneg, knode = trandom.split(key)
    rows = np.asarray(inputs.row).reshape(-1)
    cols = np.asarray(inputs.col).reshape(-1)
    b = rows.shape[0]
    neg = inputs.neg_sampling
    g = self.graph
    dev = self.device
    parts = [_upload(np.concatenate([rows, cols]), torch.int32, dev)]
    num_neg = 0
    if neg is not None:
      num_neg = neg.num_negatives(b)
      nr, nc, _ = ops.random_negative_sample(
          g.indptr, self._neg_sorted(), g.num_nodes, g.num_nodes, num_neg,
          kneg, padding=True)
      if self.edge_dir == 'in':
        # a CSC stores (dst, src): emit (src, dst) pairs
        nr, nc = nc, nr
      parts += [nr, nc] if neg.is_binary() else [nc]
    n = 2 * b + (0 if neg is None else
                 (2 if neg.is_binary() else 1) * num_neg)
    cap = _round_up(n)
    parts.append(torch.zeros(cap - n, dtype=torch.int32, device=dev))
    seeds = torch.cat(parts)
    mask = np.arange(cap) < n
    mask_d = torch.arange(cap, device=dev) < n
    res = self._sample_seeds(seeds, mask_d, knode)
    inv = res['seed_inverse']
    if inputs.label is not None:
      label = _upload(inputs.label, _jax_dtype(inputs.label), dev)
    else:
      label = torch.ones(b, dtype=torch.int32, device=dev)
    if neg is None:
      md = dict(edge_label_index=torch.stack([inv[:b], inv[b:2 * b]]),
                edge_label=label)
    elif neg.is_binary():
      md = dict(
          edge_label_index=torch.stack([
              torch.cat([inv[:b], inv[2 * b:2 * b + num_neg]]),
              torch.cat([inv[b:2 * b],
                         inv[2 * b + num_neg:2 * b + 2 * num_neg]])]),
          edge_label=torch.cat([label, torch.zeros(num_neg,
                                                   dtype=label.dtype,
                                                   device=dev)]))
    else:
      md = dict(src_index=inv[:b], dst_pos_index=inv[b:2 * b],
                dst_neg_index=inv[2 * b:2 * b + num_neg])
    return SamplerOutput(
        node=res['node'], num_nodes=res['num_nodes'], row=res['row'],
        col=res['col'], edge=res['edge'], edge_mask=res['edge_mask'],
        batch=seeds, batch_size=b,
        num_sampled_nodes=res['num_sampled_nodes'],
        num_sampled_edges=res['num_sampled_edges'],
        input_type=inputs.input_type,
        metadata={'seed_inverse': inv, 'seed_mask': mask,
                  'overflow': res['overflow'], **md})

  def _hetero_sample_from_edges(self, inputs: EdgeSamplerInput,
                                num_dst_nodes: Optional[int] = None,
                                **kwargs):
    """Typed link sampling (``graphlearn_tpu/sampler/neighbor_sampler.py:
    _hetero_sample_from_edges``): seed edges of ``inputs.input_type``
    ``(src_t, rel, dst_t)``; the negatives drawn against that edge
    type's CSR (one launch on the card) with the next key of the
    sampler's stream, then the typed engine's keys; each side's seeds
    go into its node type's frontier (one concatenated seed set when
    ``src_t == dst_t``) and the metadata indexes each type's node
    buffer.

    The negatives' ranges are the CSR's row count and, on the other
    side, ``num_dst_nodes`` or the largest neighbour id plus one, as in
    JAX (:meth:`_neg_range`); under ``edge_dir='in'`` the negatives'
    rows and columns swap. The seed union stays on the device: a typed
    link batch makes no host sync."""
    del kwargs
    etype = inputs.input_type
    assert etype is not None, 'hetero link sampling requires input_type'
    etype = tuple(etype)
    src_t, _, dst_t = etype
    dev = self.device
    rows = np.asarray(inputs.row).reshape(-1)
    cols = np.asarray(inputs.col).reshape(-1)
    b = rows.shape[0]
    neg = inputs.neg_sampling
    g = self._get_graph(etype)
    rows_d = _upload(rows, torch.int32, dev)
    cols_d = _upload(cols, torch.int32, dev)
    num_neg = 0
    if neg is not None:
      num_neg = neg.num_negatives(b)
      num_key, num_other = self._neg_range(etype)
      nr, nc, _ = ops.random_negative_sample(
          g.indptr, self._neg_sorted(etype), num_key,
          num_dst_nodes or num_other, num_neg, self._next_key(),
          padding=True)
      if self.edge_dir == 'in':
        nr, nc = nc, nr
    if neg is None:
      src_seeds, dst_seeds = rows_d, cols_d
    elif neg.is_binary():
      src_seeds = torch.cat([rows_d, nr])
      dst_seeds = torch.cat([cols_d, nc])
    else:   # triplet: the negatives are dst candidates
      src_seeds, dst_seeds = rows_d, torch.cat([cols_d, nc])
    n_src = src_seeds.shape[0]
    if src_t == dst_t:
      seeds = {src_t: torch.cat([src_seeds, dst_seeds])}
    else:
      seeds = {src_t: src_seeds, dst_t: dst_seeds}
    out = self._hetero_sample_from_nodes(seeds)
    inv_d = out.metadata['seed_inverse_dict']
    inv_src = inv_d[src_t][:n_src]
    off = n_src if src_t == dst_t else 0
    inv_dst = inv_d[dst_t][off:off + dst_seeds.shape[0]]
    if inputs.label is not None:
      label = _upload(inputs.label, _jax_dtype(inputs.label), dev)
    else:
      label = torch.ones(b, dtype=torch.int32, device=dev)
    if neg is None:
      md = dict(edge_label_index=torch.stack([inv_src[:b], inv_dst[:b]]),
                edge_label=label)
    elif neg.is_binary():
      md = dict(edge_label_index=torch.stack([inv_src[:b + num_neg],
                                              inv_dst[:b + num_neg]]),
                edge_label=torch.cat([label, torch.zeros(
                    num_neg, dtype=label.dtype, device=dev)]))
    else:
      md = dict(src_index=inv_src[:b], dst_pos_index=inv_dst[:b],
                dst_neg_index=inv_dst[b:b + num_neg])
    out.metadata.update(md)
    out.input_type = etype
    out.batch_size = b
    return out

  def sample_pyg_v1(self, seeds, batch_cap: Optional[int] = None):
    """PyG-v1 style sampling: ``(batch_size, n_id, adjs)``, ``adjs`` the
    per-hop ``(edge_index [2, caps[i] * k], edge_mask, e_id, size)`` in
    reverse hop order (deepest first), padded."""
    if self.is_hetero:
      # graftlint: allow[hetero-gate] a homogeneous-only method, as JAX's (no typed path to plan)
      raise ValueError('sample_pyg_v1 is homogeneous-only')
    seeds = np.asarray(seeds).reshape(-1)
    out = self.sample_from_nodes(NodeSamplerInput(seeds),
                                 batch_cap=batch_cap)
    fanouts = list(self.num_neighbors)
    caps = self.hop_caps(out.batch.shape[0])
    adjs = []
    offset = 0
    nodes_so_far = caps[0]
    for i, k in enumerate(fanouts):
      seg = slice(offset, offset + caps[i] * k)
      eid = out.edge[seg] if out.edge is not None else None
      nodes_so_far += caps[i + 1]
      adjs.append((torch.stack([out.row[seg], out.col[seg]]),
                   out.edge_mask[seg], eid, (nodes_so_far, caps[i])))
      offset = seg.stop
    return out.batch_size, out.node, list(reversed(adjs))

  # ------------------------------------------------------------ subgraph

  def subgraph(self, inputs: NodeSamplerInput,
               max_degree: Optional[int] = None, bucketed: bool = False,
               cap_large: Optional[int] = None) -> SamplerOutput:
    """The k-hop induced subgraph: the seeds expanded by the fanouts
    (``sample_from_nodes``), then every edge among the collected nodes
    (``ops.node_subgraph``: rows scanned to ``max_degree``, default the
    graph's largest degree: exact). ``bucketed=True`` scans most rows to
    the graph's ~p90 degree and up to ``cap_large`` (default a node
    capacity's eighth, at least 8) high-degree rows to the largest; the
    high-degree rows beyond the cap lose their edges, counted in
    ``metadata['num_dropped_rows']``. ``metadata['mapping']`` is each
    seed's position in ``node`` (-1 if absent)."""
    if self.is_hetero:
      # graftlint: allow[hetero-gate] a homogeneous-only method, as JAX's (no typed path to plan)
      raise ValueError('subgraph is homogeneous-only')
    g = self.graph
    nodes_out = self.sample_from_nodes(inputs)
    node_buf = nodes_out.node
    nmask = torch.arange(node_buf.shape[0], device=node_buf.device) < \
        nodes_out.num_nodes
    if bucketed:
      deg_small, dmax = self._degree_buckets()
      sub = ops.node_subgraph_bucketed(
          g.indptr, g.indices, node_buf, nmask, deg_small=deg_small,
          cap_large=cap_large or max(8, node_buf.shape[0] // 8),
          max_degree=max_degree or dmax)
    else:
      sub = ops.node_subgraph(g.indptr, g.indices, node_buf, nmask,
                              max_degree=max_degree or g.topo.max_degree)
    eids = (self._edge_ids(sub['epos'], sub['edge_mask'])
            if self.with_edge else None)
    seeds = torch.as_tensor(np.asarray(inputs.node).reshape(-1)).to(
        self.device, torch.int32)
    nodes = sub['nodes']
    skeys = torch.where(
        torch.arange(nodes.shape[0], device=nodes.device) < sub['num_nodes'],
        nodes, torch.iinfo(torch.int32).max)
    pos = torch.searchsorted(skeys, seeds).clamp(0, skeys.shape[0] - 1)
    md = {'mapping': torch.where(skeys[pos] == seeds, pos, -1)}
    if 'num_dropped_rows' in sub:
      md['num_dropped_rows'] = sub['num_dropped_rows']
    return SamplerOutput(
        node=nodes, num_nodes=sub['num_nodes'], row=sub['rows'],
        col=sub['cols'], edge=eids, edge_mask=sub['edge_mask'],
        batch=seeds, batch_size=int(seeds.shape[0]),
        input_type=inputs.input_type, metadata=md)

  def _degree_buckets(self):
    """(the p90 degree rounded up to a multiple of 8, at least 8 and at
    most the largest; the largest degree): the bucket plan of
    ``ops.node_subgraph_bucketed``."""
    if not hasattr(self, '_deg_buckets'):
      deg = self.graph.topo.degrees
      dmax = max(1, int(deg.max())) if deg.size else 1
      p90 = int(np.quantile(deg, 0.9)) if deg.size else 1
      self._deg_buckets = (min(dmax, max(8, -(-p90 // 8) * 8)), dmax)
    return self._deg_buckets

  # ----------------------------------------------- pre-sampling probability

  @torch.no_grad()
  def sample_prob(self, seeds, num_nodes: Optional[int] = None):
    """Per-node probability of being touched by a multi-hop sample from
    ``seeds`` (``graphlearn_tpu/sampler/neighbor_sampler.py:sample_prob``;
    ``FrequencyPartitioner``'s input): the exact dense propagation, per
    hop ``p_v += sum_{u->v} p_u * min(1, k / deg(u))`` over the CSR by
    ``index_add_`` on the sampler's device, clipped to [0, 1]. Returns a
    ``[num_nodes]`` float32 tensor there (default length: the graph's
    node count). On a card the sums add in no fixed order, so they agree
    with the CPU's within float32 rounding, not bit for bit."""
    if self.is_hetero:
      # graftlint: allow[hetero-gate] a homogeneous-only method, as JAX's (no typed path to plan)
      raise ValueError('sample_prob is homogeneous-only')
    g = self.graph
    dev = self.device
    n = num_nodes or g.num_nodes
    counts = (g.indptr[1:] - g.indptr[:-1]).to(torch.int64)
    deg = counts.to(torch.float32)
    edge_src = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts,
        output_size=g.num_edges)
    dst = g.indices.to(torch.int64)
    prob = torch.zeros(n, dtype=torch.float32, device=dev)
    prob[torch.as_tensor(np.asarray(seeds)).to(dev, torch.int64)] = 1.0
    total = prob
    for k in self.num_neighbors:
      rate = torch.clamp(k / torch.clamp(deg, min=1.0), max=1.0)
      contrib = (prob * rate)[edge_src]
      nxt = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
          0, dst, contrib)
      prob = torch.clamp(nxt, 0.0, 1.0)
      total = torch.clamp(total + prob, 0.0, 1.0)
    return total

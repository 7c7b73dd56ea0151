// One fanout level of the exact-dedup (merge) sampler, fused: seed rows,
// the threefry draw, the picks, their relabel against the batch's node
// buffer, and the level's epilogue (edges, node append, next frontier), in
// three launches per level and one per batch.
//
// Replaces: graphlearn_tpu/ops/sample_fused.py `_level_kernel_factory`
// (wrappers `_level_pallas`, `sample_level_fused`). The function is
// ops.uniform_sample followed by ops.induce_next_merge: for candidate
// i = b * k + j of the frontier's [F, k] slots,
//   cols[i]  = -1 where masked; the buffer position of its id when the
//              buffer holds it; else num_nodes + rank(id) when rank < limit,
//              -1 past it (truncation by the plan's cap);
//   rank(v)  = #{distinct new ids < v}   (new = valid, not in the buffer)
//   rows[i]  = src_idx[b] where cols[i] >= 0, else -1; edge_mask = cols >= 0
//   nodes[num_nodes + r] = the new id of rank r for r < min(num_new, limit),
//              FILL (-1) up to limit; frontier the same ids FILL-padded to
//              F * k, frontier_idx / frontier_mask their locals / validity;
//   num_new  = #{distinct new ids}, num_nodes' = num_nodes + min(num_new,
//              limit).
// New nodes take locals in ascending-id order and every duplicate takes
// its winner's local, as in the merge engine.
//
// The TPU kernel stages 128-lane windows, extracts picks by one-hot
// compares and resolves the map with three O(S^2) compare passes in one
// sequential grid step, so it refuses S > 32768. On the products batch
// ([15, 10, 5] x 1024 under calibrated caps) the levels are S = 15,360,
// 89,600 and 188,800.
//
// Bound on the H100: bytes. Per level the function reads the frontier, its
// mask and locals, each distinct (start, deg) row and adjacency element
// once and the buffer's ids once, and writes its outputs once: 5.9 MB at
// the widest level, 1.7 us at 3.35 TB/s. Scattered 4-byte reads, a probe
// chain and three launches bound it in practice.
//
// Design: the batch carries an open-addressing hash table (key = node id,
// value = buffer position; power-of-two size >= 2x the batch's node
// capacity; one 64-bit word per slot, so a probe is one load) and an id
// bitmap over [0, n_nodes), both in scratch the wrapper keeps per batch
// capacity. Launches:
//   begin   (once per batch) clear the table and the bitmap; the last CTA
//           to finish inserts the buffer's occupied prefix;
//   pick    one thread per candidate: seed row, the draw and the pick of
//           csr_pick.cuh, then a probe; a hit writes the candidate's edge,
//           a miss sets the id's bit (atomicOr) and parks -2 - id in cols;
//   scan    one pass over the bitmap in spans of 2048 words: each CTA
//           writes its words' exclusive popcount bases within the span, a
//           copy of the words for resolve, zeroes the words (the bitmap is
//           clear for the next level) and its span's total; the last CTA
//           to finish scans the span totals and writes num_new and
//           num_nodes';
//   resolve rank(v) = span_base + word_base + popc(word & below(v)) for
//           each parked candidate; writes its edge, the node append and
//           the frontier, and inserts each kept new id at num_nodes + rank
//           so the table follows the buffer into the next level (skipped
//           on the final level). Duplicates insert the same key and value.
// Ranks depend on the ids alone and the table holds one position per id,
// so no output depends on the order in which CTAs or atomics run: two
// calls on the same inputs give the same bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_pick.cuh"
#include "device_restore.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 8;
constexpr long long kSpanWords = kThreads * kWordsPerThread;
constexpr u64 kEmpty = ~0ull;   // key -1, value -1
constexpr int kMinLog2Slots = 6;
constexpr unsigned kMaxBeginBlocks = 1024;

struct Plan {
  long long n_words;       // bitmap words, padded to whole spans
  long long n_spans;
  long long n_slots;
  int log2_slots;
  // offsets in 4-byte words of the scratch buffer (the table first, so its
  // 64-bit slots stay 8-byte aligned)
  long long table, bitmap, copy, base, span, done, total;
};

Plan make_plan(long long n_nodes, long long capacity) {
  Plan p;
  const long long words = (n_nodes + 31) / 32;
  p.n_spans = (words + kSpanWords - 1) / kSpanWords;
  p.n_words = p.n_spans * kSpanWords;
  p.log2_slots = kMinLog2Slots;
  while ((1LL << p.log2_slots) < 2 * capacity) ++p.log2_slots;
  p.n_slots = 1LL << p.log2_slots;
  p.table = 0;
  p.bitmap = p.table + 2 * p.n_slots;
  p.copy = p.bitmap + p.n_words;
  p.base = p.copy + p.n_words;
  p.span = p.base + p.n_words;
  p.done = p.span + p.n_spans;   // two counters: begin's and scan's
  p.total = p.done + 2;
  return p;
}

struct Scratch {
  u64* table;
  unsigned* bitmap;
  unsigned* copy;
  int* base;
  int* span;
  unsigned* done;
};

Scratch bind(void* buf, const Plan& p) {
  int* w = static_cast<int*>(buf);
  return Scratch{reinterpret_cast<u64*>(w + p.table),
                 reinterpret_cast<unsigned*>(w + p.bitmap),
                 reinterpret_cast<unsigned*>(w + p.copy), w + p.base,
                 w + p.span, reinterpret_cast<unsigned*>(w + p.done)};
}

__device__ __forceinline__ unsigned slot_of(int v, int log2_slots) {
  return (static_cast<unsigned>(v) * 2654435761u) >> (32 - log2_slots);
}

__device__ __forceinline__ int key_of(u64 e) {
  return static_cast<int>(static_cast<unsigned>(e));
}

__device__ __forceinline__ long long thread_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// Insert (v -> pos); an equal key keeps the larger position.
__device__ void table_insert(u64* table, int log2_slots, int v, int pos) {
  const u64 item = (static_cast<u64>(static_cast<unsigned>(pos)) << 32) |
                   static_cast<unsigned>(v);
  const unsigned mask = (1u << log2_slots) - 1u;
  unsigned h = slot_of(v, log2_slots);
  while (true) {
    const u64 prev = atomicCAS(&table[h], kEmpty, item);
    if (prev == kEmpty) return;
    if (key_of(prev) == v) {
      atomicMax(&table[h], item);
      return;
    }
    h = (h + 1u) & mask;
  }
}

// The buffer position of v, or -1.
__device__ __forceinline__ int table_find(const u64* __restrict__ table,
                                          int log2_slots, int v) {
  const unsigned mask = (1u << log2_slots) - 1u;
  unsigned h = slot_of(v, log2_slots);
  while (true) {
    const u64 e = table[h];
    if (e == kEmpty) return -1;
    if (key_of(e) == v) return static_cast<int>(e >> 32);
    h = (h + 1u) & mask;
  }
}

// True in every thread of the CTA that finished last among the grid's
// CTAs (each thread's earlier writes are visible to it); the last CTA
// resets the counter for the next launch.
__device__ bool last_cta(unsigned* done) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last) {
    __threadfence();
    if (threadIdx.x == 0) *done = 0u;
  }
  return is_last;
}

// Exclusive prefix sum of one int per thread over a CTA of kThreads;
// *total gets the CTA's sum. Every thread of the CTA must call it.
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();   // a previous call's readers are done
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kThreads / 32 ? warp_sums[lane] : 0;
    int wi = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = wi - w;
    if (lane == 31) block_total = wi;
  }
  __syncthreads();
  *total = block_total;
  return warp_sums[warp] + incl - x;
}

__global__ void begin_kernel(Scratch sc, long long n_slots, int log2_slots,
                             long long n_words,
                             const int* __restrict__ nodes,
                             long long prefix_len,
                             const int* __restrict__ num_nodes) {
  const long long n = n_slots > n_words ? n_slots : n_words;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = thread_index(); i < n; i += stride) {
    if (i < n_slots) sc.table[i] = kEmpty;
    if (i < n_words) sc.bitmap[i] = 0u;
  }
  if (!last_cta(&sc.done[0])) return;
  const long long occupied = *num_nodes;
  const long long m = prefix_len < occupied ? prefix_len : occupied;
  for (long long j = threadIdx.x; j < m; j += blockDim.x) {
    const int v = nodes[j];
    if (v >= 0) table_insert(sc.table, log2_slots, v, static_cast<int>(j));
  }
}

__global__ void pick_kernel(Scratch sc, int log2_slots,
                            const int* __restrict__ seeds,
                            const uint8_t* __restrict__ seed_mask,
                            const int* __restrict__ rows, long long n_rows,
                            const int* __restrict__ indices,
                            long long n_edges,
                            const long long* __restrict__ key, int k,
                            const int* __restrict__ src_idx,
                            long long n_cand, long long n_nodes,
                            int* __restrict__ epos_out,
                            uint8_t* __restrict__ mask_out,
                            int* __restrict__ cols, int* __restrict__ erows,
                            uint8_t* __restrict__ emask) {
  const long long i = thread_index();
  if (i >= n_cand) return;
  const long long b = i / k;
  const int j = static_cast<int>(i - b * k);
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const glt::CsrRow row = glt::seed_row(seeds, seed_mask, rows, n_rows, b);
  int e;
  const bool valid =
      glt::draw_slot(k0, k1, i, j, k, seed_mask[b] != 0, row, &e);
  epos_out[i] = valid ? e : 0;
  mask_out[i] = valid;
  int col = -1;
  if (valid) {
    const int v = glt::csr_pick(indices, n_edges, e);
    col = table_find(sc.table, log2_slots, v);
    if (col < 0 && v >= 0 && v < n_nodes) {
      atomicOr(&sc.bitmap[v >> 5], 1u << (v & 31));
      col = -2 - v;   // new: resolve writes the edge
    }
  }
  cols[i] = col;
  erows[i] = col >= 0 ? src_idx[b] : -1;
  emask[i] = col >= 0;
}

__global__ void scan_kernel(Scratch sc, long long n_spans,
                            const int* __restrict__ num_nodes,
                            long long limit, int* __restrict__ counts) {
  const long long w0 =
      blockIdx.x * kSpanWords +
      static_cast<long long>(threadIdx.x) * kWordsPerThread;
  unsigned w[kWordsPerThread];
  const uint4* src = reinterpret_cast<const uint4*>(sc.bitmap + w0);
  const uint4 a = src[0], b = src[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  int s = 0;
#pragma unroll
  for (int t = 0; t < kWordsPerThread; ++t) s += __popc(w[t]);
  int span_total;
  int run = block_exclusive_scan(s, &span_total);
  int4 base[2];
  int* bw = reinterpret_cast<int*>(base);
#pragma unroll
  for (int t = 0; t < kWordsPerThread; ++t) {
    bw[t] = run;
    run += __popc(w[t]);
  }
  reinterpret_cast<int4*>(sc.base + w0)[0] = base[0];
  reinterpret_cast<int4*>(sc.base + w0)[1] = base[1];
  reinterpret_cast<uint4*>(sc.copy + w0)[0] = a;
  reinterpret_cast<uint4*>(sc.copy + w0)[1] = b;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  reinterpret_cast<uint4*>(sc.bitmap + w0)[0] = zero;
  reinterpret_cast<uint4*>(sc.bitmap + w0)[1] = zero;
  if (threadIdx.x == 0) sc.span[blockIdx.x] = span_total;
  if (!last_cta(&sc.done[1])) return;
  // the span totals -> exclusive span bases, in place
  int carry = 0;
  for (long long c0 = 0; c0 < n_spans; c0 += kThreads) {
    const long long c = c0 + threadIdx.x;
    const int x = c < n_spans ? __ldcg(&sc.span[c]) : 0;   // other CTAs'
    int chunk;
    const int ex = block_exclusive_scan(x, &chunk);
    if (c < n_spans) sc.span[c] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) {
    const long long kept = carry < limit ? carry : limit;
    counts[0] = carry;                                       // num_new
    counts[1] = static_cast<int>(*num_nodes + kept);         // num_nodes'
  }
}

__global__ void resolve_kernel(Scratch sc, int log2_slots, int insert,
                               const int* __restrict__ src_idx, int k,
                               long long n_cand, long long limit,
                               long long capacity,
                               const int* __restrict__ num_nodes,
                               const int* __restrict__ counts,
                               int* __restrict__ nodes,
                               int* __restrict__ cols, int* __restrict__ erows,
                               uint8_t* __restrict__ emask,
                               int* __restrict__ frontier,
                               int* __restrict__ frontier_idx,
                               uint8_t* __restrict__ frontier_mask) {
  const long long i = thread_index();
  if (i >= n_cand) return;
  const int nn = *num_nodes;
  const long long num_new = counts[0];
  const long long kept = num_new < limit ? num_new : limit;
  // the append block lands at num_nodes, clamped into the buffer as
  // lax.dynamic_update_slice clamps it
  long long at = nn;
  if (at > capacity - limit) at = capacity - limit;
  if (at < 0) at = 0;
  frontier_idx[i] = i < kept ? static_cast<int>(nn + i) : -1;
  frontier_mask[i] = i < kept;
  if (i >= kept) {
    frontier[i] = -1;
    if (i < limit) nodes[at + i] = -1;
  }
  const int c = cols[i];
  if (c > -2) return;
  const int v = -2 - c;
  const int w = v >> 5;
  const int r = sc.span[w / kSpanWords] + sc.base[w] +
                __popc(sc.copy[w] & ((1u << (v & 31)) - 1u));
  if (r >= limit) {
    cols[i] = -1;
    return;
  }
  cols[i] = nn + r;
  erows[i] = src_idx[i / k];
  emask[i] = 1;
  nodes[at + r] = v;
  frontier[r] = v;
  if (insert) table_insert(sc.table, log2_slots, v, nn + r);
}

unsigned grid_for(long long n) {
  const long long g = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(g > 0 ? g : 1);
}

}  // namespace

// int32 words of scratch for a graph of n_nodes nodes and a batch whose
// node buffer holds `capacity` slots. The buffer must be zeroed once when
// it is made; the kernels leave its counters at zero.
extern "C" long long glt_level_scratch_words(long long n_nodes,
                                             long long capacity) {
  return make_plan(n_nodes, capacity).total;
}

// Once per batch: clear the table and the bitmap, then insert the buffer
// positions j < min(prefix_len, *num_nodes) of nodes (int32). Returns the
// launch error (0 if none).
extern "C" int glt_level_begin(void* scratch, long long n_nodes,
                               long long capacity, const void* nodes,
                               long long prefix_len, const void* num_nodes,
                               int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes <= 0 || n_nodes > 0x7fffffffLL || capacity < 0 ||
      prefix_len < 0 || prefix_len > capacity) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n_nodes, capacity);
  const long long n = p.n_slots > p.n_words ? p.n_slots : p.n_words;
  unsigned blocks = grid_for(n / 4);
  if (blocks > kMaxBeginBlocks) blocks = kMaxBeginBlocks;
  begin_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bind(scratch, p), p.n_slots, p.log2_slots, p.n_words,
      static_cast<const int*>(nodes), prefix_len,
      static_cast<const int*>(num_nodes));
  return static_cast<int>(cudaGetLastError());
}

// One level: pick, scan and resolve (three launches). seeds [n_frontier]
// int32 or null (rows then holds one row per seed), seed_mask [n_frontier]
// bool, rows [n_rows, 2] int32 (start, deg), indices [n_edges] int32, key
// [2] int64 on the device, src_idx [n_frontier] int32; the buffer nodes
// [capacity] int32 and num_nodes (one int32) after the batch's begin and
// the earlier levels. Outputs: epos/cols/erows [n_frontier * k] int32,
// mask/emask [n_frontier * k] bool, frontier/frontier_idx [n_frontier * k]
// int32, frontier_mask bool, counts [2] int32 (num_new, num_nodes'); nodes
// is appended in place. insert = 0 on the final level.
extern "C" int glt_level_run(void* scratch, long long n_nodes,
                             long long capacity, const void* seeds,
                             const void* seed_mask, const void* rows,
                             long long n_rows, const void* indices,
                             long long n_edges, const void* key,
                             long long n_frontier, int k,
                             const void* src_idx, void* nodes,
                             const void* num_nodes, long long limit,
                             int insert, void* epos, void* mask, void* cols,
                             void* erows, void* emask, void* frontier,
                             void* frontier_idx, void* frontier_mask,
                             void* counts, int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_cand = n_frontier * k;
  if (n_nodes <= 0 || n_nodes > 0x7fffffffLL || n_frontier < 0 || k < 0 ||
      n_rows <= 0 || n_edges < 0 || limit < 0 || limit > n_cand ||
      limit > capacity) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n_nodes, capacity);
  const Scratch sc = bind(scratch, p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* nn = static_cast<const int*>(num_nodes);
  pick_kernel<<<grid_for(n_cand), kThreads, 0, s>>>(
      sc, p.log2_slots, static_cast<const int*>(seeds),
      static_cast<const uint8_t*>(seed_mask), static_cast<const int*>(rows),
      n_rows, static_cast<const int*>(indices), n_edges,
      static_cast<const long long*>(key), k > 0 ? k : 1,
      static_cast<const int*>(src_idx), n_cand, n_nodes,
      static_cast<int*>(epos), static_cast<uint8_t*>(mask),
      static_cast<int*>(cols), static_cast<int*>(erows),
      static_cast<uint8_t*>(emask));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<static_cast<unsigned>(p.n_spans), kThreads, 0, s>>>(
      sc, p.n_spans, nn, limit, static_cast<int*>(counts));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  resolve_kernel<<<grid_for(n_cand), kThreads, 0, s>>>(
      sc, p.log2_slots, insert, static_cast<const int*>(src_idx),
      k > 0 ? k : 1, n_cand, limit, capacity, nn,
      static_cast<const int*>(counts), static_cast<int*>(nodes),
      static_cast<int*>(cols), static_cast<int*>(erows),
      static_cast<uint8_t*>(emask), static_cast<int*>(frontier),
      static_cast<int*>(frontier_idx), static_cast<uint8_t*>(frontier_mask));
  return static_cast<int>(cudaGetLastError());
}

// One fanout level of the exact-dedup (merge) sampler: the CSR picks and
// their relabel map against the node buffer, in one call.
//
// Replaces: graphlearn_tpu/ops/sample_fused.py `_level_kernel_factory`
// (wrappers `_level_pallas`, `sample_level_fused`). Given the drawn edge
// positions epos [S] (S = frontier x k), their validity mask, the node
// buffer's prefix nodes[0, c) of which the first num_nodes are occupied,
// and the static append limit, it computes
//   picked[i]   = indices[clamp(epos[i])]
//   cols_raw[i] = -1 where masked; else the buffer position of picked[i]
//                 if the prefix holds it; else num_nodes + rank(picked[i])
//   rank(v)     = #{distinct new ids < v}   (new = valid, not in prefix)
//   block[r]    = the new id of rank r for r < min(num_new, limit), FILL
//                 (-1) past it
//   num_new     = #{distinct new ids}
// which is ops.induce_next_merge's relabel map: new nodes take locals in
// ascending-id order, and every duplicate takes its winner's local.
//
// The TPU kernel stages 128-lane windows, extracts picks by one-hot
// compares and resolves the map with three O(S^2) compare passes in one
// sequential grid step, so it refuses S > 32768. On the products batch
// ([15, 10, 5] x 1024 under calibrated caps) the levels are S = 15,360,
// 99,840 and 209,280: it could take only the first.
//
// Bound on the H100: bytes. Per level the function reads epos (4 B) and
// the mask (1 B) per candidate, each distinct adjacency element once, the
// prefix once, and writes picked and cols_raw (4 B each) per candidate and
// the block: ~4 MB at the widest level, ~1 us at 3.35 TB/s. Its scattered
// 4-byte reads, atomics and six launches make it latency- and launch-bound.
//
// Design: no sort and no compare of candidate pairs. Six launches:
//   1. clear   the scratch: an id bitmap over [0, n_nodes), an open-
//              addressing hash table (key = node id, value = buffer
//              position, power-of-two size >= 2c), and the block to FILL;
//   2. insert  the occupied prefix positions j < num_nodes into the table
//              (GLT's own CUDA inducer keeps a hash table of the same kind);
//   3. pick    one thread per candidate (the hop kernel's csr_pick): probe
//              the table; a prefix hit is the candidate's column, a miss
//              sets the id's bit in the bitmap (atomicOr);
//   4. count   the set bits per 2048-word block of the bitmap;
//   5. prefix  an exclusive prefix sum of the per-word popcounts (each
//              block adds the counts of the blocks before it); the last
//              block writes num_new, the total;
//   6. resolve rank(v) = prefix[v >> 5] + popc(word & ((1 << (v & 31)) - 1))
//              for each new candidate; column num_nodes + rank, and
//              block[rank] = v while rank < limit (duplicates write the
//              same value).
// A rank depends on the id alone, so no output depends on the order in
// which blocks or atomics run: two calls on the same inputs give the same
// bytes. The bitmap costs n_nodes / 8 bytes of scratch (125 KB at 1M
// nodes), cleared once per call. Ids outside [0, n_nodes) break the
// contract (they cannot come from a CSR of n_nodes rows); the kernel stays
// in bounds and gives them column -1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_pick.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 8;
constexpr long long kWordsPerBlock = kThreads * kWordsPerThread;
constexpr int kEmpty = -1;   // hash-table key of a free slot
constexpr int kNew = -2;     // cols_raw of a new candidate before resolve
constexpr int kMinLog2Slots = 6;

struct Plan {
  long long n_words_pad;   // bitmap words, padded to whole scan blocks
  long long n_scan_blocks;
  long long n_slots;
  int log2_slots;
  // offsets into the int32 scratch buffer
  long long bitmap, word_prefix, block_sums, keys, vals, total;
};

Plan make_plan(long long n_nodes, long long prefix_len) {
  Plan p;
  const long long n_words = (n_nodes + 31) / 32;
  p.n_scan_blocks = (n_words + kWordsPerBlock - 1) / kWordsPerBlock;
  p.n_words_pad = p.n_scan_blocks * kWordsPerBlock;
  p.log2_slots = kMinLog2Slots;
  while ((1LL << p.log2_slots) < 2 * prefix_len) ++p.log2_slots;
  p.n_slots = 1LL << p.log2_slots;
  p.bitmap = 0;
  p.word_prefix = p.bitmap + p.n_words_pad;
  p.block_sums = p.word_prefix + p.n_words_pad;
  p.keys = p.block_sums + p.n_scan_blocks;
  p.vals = p.keys + p.n_slots;
  p.total = p.vals + p.n_slots;
  return p;
}

__device__ __forceinline__ unsigned slot_of(int v, int log2_slots) {
  return (static_cast<unsigned>(v) * 2654435761u) >> (32 - log2_slots);
}

__device__ __forceinline__ long long thread_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// Exclusive prefix sum of one int per thread over a block of kThreads;
// *total gets the block's sum. Every thread of the block must call it.
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

__global__ void clear_kernel(unsigned* __restrict__ bitmap,
                             long long n_words, int* __restrict__ keys,
                             int* __restrict__ vals, long long n_slots,
                             int* __restrict__ block, long long limit) {
  const long long n = n_words > n_slots ? n_words : n_slots;
  const long long m = n > limit ? n : limit;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = thread_index(); i < m; i += stride) {
    if (i < n_words) bitmap[i] = 0u;
    if (i < n_slots) {
      keys[i] = kEmpty;
      vals[i] = -1;
    }
    if (i < limit) block[i] = -1;
  }
}

__global__ void insert_kernel(const int* __restrict__ nodes,
                              long long prefix_len,
                              const int* __restrict__ num_nodes,
                              int* __restrict__ keys, int* __restrict__ vals,
                              int log2_slots) {
  const long long j = thread_index();
  if (j >= prefix_len || j >= *num_nodes) return;
  const int v = nodes[j];
  if (v < 0) return;
  const unsigned mask = (1u << log2_slots) - 1u;
  unsigned h = slot_of(v, log2_slots);
  while (true) {
    const int prev = atomicCAS(&keys[h], kEmpty, v);
    if (prev == kEmpty || prev == v) {
      atomicMax(&vals[h], static_cast<int>(j));
      return;
    }
    h = (h + 1u) & mask;
  }
}

__global__ void pick_kernel(const int* __restrict__ indices, long long n_edges,
                            const int* __restrict__ epos,
                            const uint8_t* __restrict__ valid,
                            long long n_cand, const int* __restrict__ keys,
                            const int* __restrict__ vals, int log2_slots,
                            unsigned* __restrict__ bitmap, long long n_nodes,
                            int* __restrict__ picked,
                            int* __restrict__ cols_raw) {
  const long long i = thread_index();
  if (i >= n_cand) return;
  const int v = n_edges > 0 ? csr_pick(indices, n_edges, epos[i]) : 0;
  picked[i] = v;
  if (!valid[i]) {
    cols_raw[i] = -1;
    return;
  }
  const unsigned mask = (1u << log2_slots) - 1u;
  unsigned h = slot_of(v, log2_slots);
  int key;
  while ((key = keys[h]) != kEmpty && key != v) h = (h + 1u) & mask;
  if (key == v) {
    cols_raw[i] = vals[h];
  } else if (v >= 0 && v < n_nodes) {
    atomicOr(&bitmap[v >> 5], 1u << (v & 31));
    cols_raw[i] = kNew;
  } else {
    cols_raw[i] = -1;
  }
}

__global__ void count_kernel(const unsigned* __restrict__ bitmap,
                             int* __restrict__ block_sums) {
  const long long base = blockIdx.x * kWordsPerBlock +
                         static_cast<long long>(threadIdx.x) * kWordsPerThread;
  int s = 0;
  for (int j = 0; j < kWordsPerThread; ++j) s += __popc(bitmap[base + j]);
  int total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

__global__ void prefix_kernel(const unsigned* __restrict__ bitmap,
                              const int* __restrict__ block_sums,
                              int* __restrict__ word_prefix,
                              int* __restrict__ num_new) {
  int part = 0;
  for (unsigned j = threadIdx.x; j < blockIdx.x; j += blockDim.x) {
    part += block_sums[j];
  }
  int offset;
  block_exclusive_scan(part, &offset);
  const long long base = blockIdx.x * kWordsPerBlock +
                         static_cast<long long>(threadIdx.x) * kWordsPerThread;
  unsigned w[kWordsPerThread];
  int s = 0;
  for (int j = 0; j < kWordsPerThread; ++j) {
    w[j] = bitmap[base + j];
    s += __popc(w[j]);
  }
  int total;
  int run = offset + block_exclusive_scan(s, &total);
  for (int j = 0; j < kWordsPerThread; ++j) {
    word_prefix[base + j] = run;
    run += __popc(w[j]);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    *num_new = offset + total;
  }
}

__global__ void resolve_kernel(const int* __restrict__ picked,
                               long long n_cand,
                               const unsigned* __restrict__ bitmap,
                               const int* __restrict__ word_prefix,
                               const int* __restrict__ num_nodes,
                               long long limit, int* __restrict__ cols_raw,
                               int* __restrict__ block) {
  const long long i = thread_index();
  if (i >= n_cand || cols_raw[i] != kNew) return;
  const int v = picked[i];
  const int w = v >> 5;
  const int r = word_prefix[w] +
                __popc(bitmap[w] & ((1u << (v & 31)) - 1u));
  cols_raw[i] = *num_nodes + r;
  if (r < limit) block[r] = v;
}

unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// int32 words of scratch that glt_sample_level needs for a graph of
// n_nodes nodes and a node-buffer prefix of prefix_len slots.
extern "C" long long glt_sample_level_scratch(long long n_nodes,
                                              long long prefix_len) {
  return make_plan(n_nodes, prefix_len).total;
}

// indices [n_edges] int32; epos [n_cand] int32; valid [n_cand] bool (one
// byte each); nodes [prefix_len] int32; num_nodes: one int32 on the device;
// scratch: glt_sample_level_scratch(n_nodes, prefix_len) int32 words.
// Outputs picked/cols_raw [n_cand] int32, block [limit] int32, num_new one
// int32. Launches on `stream` and returns the first launch error (0 if
// none); nothing is synchronised.
extern "C" int glt_sample_level(const void* indices, long long n_edges,
                                const void* epos, const void* valid,
                                long long n_cand, const void* nodes,
                                long long prefix_len, const void* num_nodes,
                                long long n_nodes, long long limit,
                                void* scratch, void* picked, void* cols_raw,
                                void* block, void* num_new, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes <= 0 || n_nodes > 0x7fffffffLL || n_edges < 0 || n_cand < 0 ||
      prefix_len < 0 || prefix_len > (1LL << 29) || limit < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n_nodes, prefix_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* sc = static_cast<int*>(scratch);
  unsigned* bitmap = reinterpret_cast<unsigned*>(sc + p.bitmap);
  int* word_prefix = sc + p.word_prefix;
  int* block_sums = sc + p.block_sums;
  int* keys = sc + p.keys;
  int* vals = sc + p.vals;
  const int* nn = static_cast<const int*>(num_nodes);
  int* cols = static_cast<int*>(cols_raw);
  int* blk = static_cast<int*>(block);

  long long n_clear = p.n_words_pad > p.n_slots ? p.n_words_pad : p.n_slots;
  n_clear = n_clear > limit ? n_clear : limit;
  const long long clear_blocks = (n_clear + kThreads - 1) / kThreads;
  clear_kernel<<<static_cast<unsigned>(clear_blocks < 4096 ? clear_blocks
                                                           : 4096),
                 kThreads, 0, s>>>(bitmap, p.n_words_pad, keys, vals,
                                   p.n_slots, blk, limit);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (prefix_len > 0) {
    insert_kernel<<<grid_for(prefix_len), kThreads, 0, s>>>(
        static_cast<const int*>(nodes), prefix_len, nn, keys, vals,
        p.log2_slots);
    if ((err = cudaGetLastError()) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  if (n_cand > 0) {
    pick_kernel<<<grid_for(n_cand), kThreads, 0, s>>>(
        static_cast<const int*>(indices), n_edges,
        static_cast<const int*>(epos), static_cast<const uint8_t*>(valid),
        n_cand, keys, vals, p.log2_slots, bitmap, n_nodes,
        static_cast<int*>(picked), cols);
    if ((err = cudaGetLastError()) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const unsigned scan_blocks = static_cast<unsigned>(p.n_scan_blocks);
  count_kernel<<<scan_blocks, kThreads, 0, s>>>(bitmap, block_sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  prefix_kernel<<<scan_blocks, kThreads, 0, s>>>(
      bitmap, block_sums, word_prefix, static_cast<int*>(num_new));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_cand > 0) {
    resolve_kernel<<<grid_for(n_cand), kThreads, 0, s>>>(
        static_cast<const int*>(picked), n_cand, bitmap, word_prefix, nn,
        limit, cols, blk);
    if ((err = cudaGetLastError()) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return 0;
}

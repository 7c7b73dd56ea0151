// The candidate draw and CSR membership test of random negative sampling,
// in one launch.
//
// Replaces: the XLA ops of random_negative_sample at
// graphlearn_tpu/ops/negative.py:33 (two jax.random.randint draws and
// edge_in_csr, graphlearn_tpu/ops/neighbor.py:458). That is not a Pallas
// kernel: XLA fuses it on the TPU. In torch the same work as plain ops is
// ~950 launches a link batch (four ~190-op threefry draws, 32 search
// rounds of ~6 ops).
//
// For candidate i < total it writes rows[i], cols[i] and valid[i]:
//   - the key splits into (kr, kc) and each of those into the (higher,
//     lower) keys of jax.random.randint: split(k)[j] = threefry2x32(k, (0,
//     j)), the partitionable layout of random.split;
//   - higher and lower are the words y0 ^ y1 of threefry2x32(key, (hi(i),
//     lo(i))), as random.random_bits draws them;
//   - the value is randint's reduction to [0, span) in uint32 arithmetic,
//     every product and sum wrapping mod 2**32: multiplier = (2**16 %
//     span)**2 % span, ((higher % span) * multiplier + lower % span) %
//     span (random.randint; from span 65,537 on the multiplier is 0);
//   - valid[i] is 1 when (row, col) is no edge of the CSR: a lower-bound
//     binary search for col in row's segment of the row-sorted indices,
//     edge_in_csr's rounds with its clip, stopped once lo >= hi (a later
//     round can move lo only past the segment's end, which the test
//     reads as absent too).
// The key is read from device memory (a [2] int64 tensor of uint32
// words); the block's first thread derives the four subkeys into shared
// memory.
//
// Bound on the H100: per candidate four threefry blocks (~77 32-bit
// operations each), the two reductions and ~6 operations per search
// round; bytes: two indptr words, one indices word per round and 9 bytes
// written. At a link batch's 2,560 candidates both are far below a
// launch; the search rounds are dependent loads, so a thread's time is
// its rounds' latency, not its operations.
//
// Design: one thread per candidate, 256 threads a block, a grid-stride
// loop over at most 132 * 16 blocks.
//
// The second entry, glt_negative_sample_local, is the shard-local draw of
// the distributed engine (graphlearn_tpu/ops/negative.py:68,
// random_negative_sample_local): the row is a LOCAL row index,
// randint(kr, 0, 2**30) % max(num_rows, 1), where num_rows is the count
// of the shard's row_ids that are not INT32_MAX padding. JAX computes that
// count on the device; here each block counts it with a search for the
// first INT32_MAX over the ascending, INT32_MAX-padded row_ids (the
// DistGraph layout), so the link batch reads nothing back on the host. Block 0 writes the count out for the caller's validity
// mask. The span 2**30 makes randint's multiplier (2**16 % span)**2 wrap
// to 0 in uint32, as in JAX. The column draw and the membership test are
// the first entry's.
//
// Its block prologue is latency, not work: at a link batch's 2,560
// candidates the entry took 0.0104-0.0106 ms against a fill floor of
// 0.0052 (49-50% of its yardstick; NVIDIA H100 80GB HBM3, 700.00 W). So
// the first warp derives the subkeys in two dependent threefry blocks
// (lanes 0-1, then 0-3) where one thread ran six, and the second warp
// counts the owned rows beside it with a 32-ary search (a ballot over 32
// probes a step: 4 dependent loads over a million ids, not 20).
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_pick.cuh"
#include "device_restore.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

// jax.random.split(k)[j] for j in {0, 1}: threefry2x32(k, (0, j)).
__device__ __forceinline__ void split_key(uint32_t k0, uint32_t k1, uint32_t j,
                                          uint32_t* out) {
  uint32_t x0 = 0, x1 = j;
  glt::threefry2x32(k0, k1, x0, x1);
  out[0] = x0;
  out[1] = x1;
}

// The 32-bit word of random_bits(key, ...) at flat counter i.
__device__ __forceinline__ uint32_t word(const uint32_t* key, long long i) {
  uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(i) >>
                                      32);
  uint32_t x1 = static_cast<uint32_t>(i);
  glt::threefry2x32(key[0], key[1], x0, x1);
  return x0 ^ x1;
}

// jax.random.randint's reduction of (higher, lower) to [0, span), span >= 1.
__device__ __forceinline__ uint32_t reduce(uint32_t higher, uint32_t lower,
                                           uint32_t span, uint32_t mult) {
  const uint32_t off = (higher % span) * mult + lower % span;
  return off % span;
}

__global__ void negative_sample_kernel(
    const long long* __restrict__ key, const int* __restrict__ indptr,
    long long n_ptr, const int* __restrict__ indices, long long n_edges,
    uint32_t span_r, uint32_t span_c, long long total, int* __restrict__ rows,
    int* __restrict__ cols, uint8_t* __restrict__ valid) {
  // kr_hi, kr_lo, kc_hi, kc_lo: two words each
  __shared__ uint32_t sub[8];
  if (threadIdx.x == 0) {
    const uint32_t k0 = static_cast<uint32_t>(key[0]);
    const uint32_t k1 = static_cast<uint32_t>(key[1]);
    uint32_t kr[2], kc[2];
    split_key(k0, k1, 0, kr);
    split_key(k0, k1, 1, kc);
    split_key(kr[0], kr[1], 0, sub);
    split_key(kr[0], kr[1], 1, sub + 2);
    split_key(kc[0], kc[1], 0, sub + 4);
    split_key(kc[0], kc[1], 1, sub + 6);
  }
  __syncthreads();
  const uint32_t mult_r = (65536u % span_r) * (65536u % span_r) % span_r;
  const uint32_t mult_c = (65536u % span_c) * (65536u % span_c) % span_c;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int r = static_cast<int>(
        reduce(word(sub, i), word(sub + 2, i), span_r, mult_r));
    const int c = static_cast<int>(
        reduce(word(sub + 4, i), word(sub + 6, i), span_c, mult_c));
    // indptr[r] and indptr[r + 1], each index clamped as XLA's gather does
    const long long a = r < n_ptr ? r : n_ptr - 1;
    const long long b = r + 1 < n_ptr ? r + 1 : n_ptr - 1;
    const long long end = indptr[b];
    long long lo = indptr[a], hi = end;
    bool edge = false;
    if (n_edges > 0) {
      for (int round = 0; round < 32 && lo < hi; ++round) {
        const long long mid = (lo + hi) / 2;
        const long long at = mid < 0 ? 0 : (mid >= n_edges ? n_edges - 1 : mid);
        if (indices[at] < c) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const long long at = lo < 0 ? 0 : (lo >= n_edges ? n_edges - 1 : lo);
      edge = lo < end && indices[at] == c;
    }
    rows[i] = r;
    cols[i] = c;
    valid[i] = edge ? 0 : 1;
  }
}

__global__ void negative_sample_local_kernel(
    const long long* __restrict__ key, const int* __restrict__ row_ids,
    long long n_row_ids, const int* __restrict__ indptr, long long n_ptr,
    const int* __restrict__ indices, long long n_edges, uint32_t span_c,
    long long total, int* __restrict__ rows, int* __restrict__ cols,
    uint8_t* __restrict__ valid, int* __restrict__ count_out) {
  __shared__ uint32_t sub[8];
  __shared__ uint32_t num_rows;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    // the four subkeys in two dependent threefry blocks: lanes 0 and 1
    // split the key into kr and kc, lanes 0..3 split those
    const uint32_t k0 = static_cast<uint32_t>(key[0]);
    const uint32_t k1 = static_cast<uint32_t>(key[1]);
    uint32_t half[2] = {0, 0};
    if (lane < 2) split_key(k0, k1, lane, half);
    const uint32_t p0 = __shfl_sync(0xFFFFFFFFu, half[0], lane >> 1);
    const uint32_t p1 = __shfl_sync(0xFFFFFFFFu, half[1], lane >> 1);
    if (lane < 4) split_key(p0, p1, lane & 1, sub + 2 * lane);
  } else if (threadIdx.x < 64) {
    // rows owned: the first INT32_MAX pad of the ascending row ids, the
    // second warp's 32-ary search. It is in [lo, hi]; each step probes
    // 32 points a step apart and keeps the step between the last probe
    // below the pad and the first at it: log32 dependent loads.
    long long lo = 0, hi = n_row_ids;
    while (hi - lo > 32) {
      const long long step = (hi - lo + 31) / 32;
      const long long at = lo + (lane + 1) * step - 1;
      const int below = __popc(__ballot_sync(
          0xFFFFFFFFu, at < hi && row_ids[at] < 0x7FFFFFFF));
      const long long next = lo + (below + 1) * step - 1;
      lo += below * step;
      hi = next < hi ? next : hi;
    }
    const long long at = lo + lane;
    lo += __popc(__ballot_sync(0xFFFFFFFFu,
                               at < hi && row_ids[at] < 0x7FFFFFFF));
    if (lane == 0) {
      if (blockIdx.x == 0) *count_out = static_cast<int>(lo);
      num_rows = lo > 0 ? static_cast<uint32_t>(lo) : 1u;
    }
  }
  __syncthreads();
  const uint32_t span_r = 1u << 30;
  const uint32_t mult_r = (65536u % span_r) * (65536u % span_r) % span_r;
  const uint32_t mult_c = (65536u % span_c) * (65536u % span_c) % span_c;
  const uint32_t nr = num_rows;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int r = static_cast<int>(
        reduce(word(sub, i), word(sub + 2, i), span_r, mult_r) % nr);
    const int c = static_cast<int>(
        reduce(word(sub + 4, i), word(sub + 6, i), span_c, mult_c));
    const long long a = r < n_ptr ? r : n_ptr - 1;
    const long long b = r + 1 < n_ptr ? r + 1 : n_ptr - 1;
    const long long end = indptr[b];
    long long lo = indptr[a], hi = end;
    bool edge = false;
    if (n_edges > 0) {
      for (int round = 0; round < 32 && lo < hi; ++round) {
        const long long mid = (lo + hi) / 2;
        const long long at = mid < 0 ? 0 : (mid >= n_edges ? n_edges - 1 : mid);
        if (indices[at] < c) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const long long at = lo < 0 ? 0 : (lo >= n_edges ? n_edges - 1 : lo);
      edge = lo < end && indices[at] == c;
    }
    rows[i] = r;
    cols[i] = c;
    valid[i] = edge ? 0 : 1;
  }
}

}  // namespace

// key: [2] int64 words on the device; indptr: [n_ptr] int32; indices:
// [n_edges] int32, sorted within each row; span_r / span_c: the randint
// spans of rows and cols (>= 1); rows / cols: [total] int32; valid:
// [total] bool. Launches on `stream` and returns cudaGetLastError() of the
// launch (0 when total == 0).
extern "C" int glt_negative_sample(const void* key, const void* indptr,
                                   long long n_ptr, const void* indices,
                                   long long n_edges, long long span_r,
                                   long long span_c, long long total,
                                   void* rows, void* cols, void* valid,
                                   int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total < 0 || n_ptr < 1 || n_edges < 0 || span_r < 1 || span_c < 1 ||
      span_r > 0xFFFFFFFFll || span_c > 0xFFFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  negative_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), static_cast<const int*>(indptr),
      n_ptr, static_cast<const int*>(indices), n_edges,
      static_cast<uint32_t>(span_r), static_cast<uint32_t>(span_c), total,
      static_cast<int*>(rows), static_cast<int*>(cols),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// The shard-local entry. row_ids: [n_row_ids] int32, ascending with
// INT32_MAX padding at the end; indptr: [n_ptr] int32 local offsets;
// indices: [n_edges] int32, sorted within each row; span_c: the randint
// span of cols (>= 1); rows: [total] int32 LOCAL row indices; cols:
// [total] int32; valid: [total] bool (not an edge); count_out: [1] int32,
// the rows the shard owns. Launches on `stream` and returns
// cudaGetLastError() of the launch. With total == 0 it still launches
// one block, so count_out is always written.
extern "C" int glt_negative_sample_local(
    const void* key, const void* row_ids, long long n_row_ids,
    const void* indptr, long long n_ptr, const void* indices,
    long long n_edges, long long span_c, long long total, void* rows,
    void* cols, void* valid, void* count_out, int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total < 0 || n_row_ids < 0 || n_ptr < 1 || n_edges < 0 ||
      span_c < 1 || span_c > 0xFFFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  negative_sample_local_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), static_cast<const int*>(row_ids),
      n_row_ids, static_cast<const int*>(indptr), n_ptr,
      static_cast<const int*>(indices), n_edges,
      static_cast<uint32_t>(span_c), total, static_cast<int*>(rows),
      static_cast<int*>(cols), static_cast<uint8_t*>(valid),
      static_cast<int*>(count_out));
  return static_cast<int>(cudaGetLastError());
}

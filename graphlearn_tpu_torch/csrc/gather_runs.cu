// Run-segmented row gather (gather v2): out[i, :] = table[clamp(ids[i]), :]
// by way of a per-slot plan over the sorted ids.
//
// Replaces: graphlearn_tpu/ops/gather_pallas.py `_gather2_kernel_factory`
// (wrappers `_gather_rows_hbm2_impl`, `gather_rows_hbm2`), the TPU kernel
// that issues one multi-row DMA per full run of consecutive table rows and
// one single-row DMA per other slot. It is the serving tier's embedding
// lookup (`EmbeddingStore.lookup` with kernel routing on) and the routed
// all-device feature lookup.
//
// Plan contract (ops/gather.py `plan_gather_runs`, bit-exact with the JAX
// plan): plan[j] packs the clamped sorted row in bits 0-29 and the kind in
// bits 30-31; kind 0 copies row `row` to slot j, kind 1 copies rows
// `row .. row + span - 1` to slots j .. j + span - 1, kind 2 is covered by
// the run that starts at most span - 1 slots before it. Every slot is
// written exactly once. Kind 2 rides the int32 sign bit, so the kind is
// read with an unsigned shift.
//
// Bound on the H100: bytes. No arithmetic; the least traffic is the plan
// (and perm) read once, each distinct row read once and each output row
// written once, over 3.35 TB/s.
//
// Design: one warp per plan slot. The TPU's reasons for its design (DMA
// descriptors per row, 128-lane row slices) do not exist here, so only the
// plan contract carries over. A run's source rows are one contiguous range
// of span * row_bytes. With `presorted` (perm == nullptr) the destination is
// contiguous too and the warp copies the whole range as one flat copy, its
// lanes striding over it with the widest vector the two pointers and the
// row width allow (16/8/4/2/1 bytes, as in gather_rows.cu). Otherwise the
// unsort is fused: the warp writes each copied row straight to its caller
// slot out[perm[j]], so the source stays contiguous per run and each
// destination is one coalesced row, and no second [B, F] pass is needed.
// Slots past n_out are the row-0 pad of the last plan block and are not
// written. TMA bulk copies for runs and cp.async staging are left for a
// tuning pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kRowMask = (1u << 30) - 1u;
constexpr uint32_t kKindRun = 1u;
constexpr uint32_t kKindCovered = 2u;
constexpr int kThreads = 256;  // 8 warps = 8 plan slots per block

template <typename V>
__device__ __forceinline__ void warp_copy(const V* __restrict__ src,
                                          V* __restrict__ dst, long long n,
                                          int lane) {
  for (long long c = lane; c < n; c += 32) dst[c] = src[c];
}

template <typename V>
__global__ void gather_runs_kernel(const V* __restrict__ table,
                                   const int* __restrict__ plan,
                                   const long long* __restrict__ perm,
                                   V* __restrict__ out, long long n_out,
                                   long long n_slots, long long vec_per_row,
                                   int span) {
  const long long slot =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (slot >= n_slots || slot >= n_out) return;
  const uint32_t v = static_cast<uint32_t>(plan[slot]);
  const uint32_t kind = (v >> 30) & 3u;
  if (kind == kKindCovered) return;
  const long long row = static_cast<long long>(v & kRowMask);
  const long long count = kind == kKindRun ? span : 1;
  const long long last = slot + count < n_out ? slot + count : n_out;
  const V* src = table + row * vec_per_row;
  if (perm == nullptr) {
    warp_copy(src, out + slot * vec_per_row, (last - slot) * vec_per_row,
              lane);
    return;
  }
  for (long long s = slot; s < last; ++s) {
    warp_copy(src + (s - slot) * vec_per_row, out + perm[s] * vec_per_row,
              vec_per_row, lane);
  }
}

template <typename V>
void launch(const void* table, const void* plan, const void* perm, void* out,
            long long n_out, long long n_slots, long long row_bytes, int span,
            cudaStream_t stream) {
  const long long blocks = (n_slots * 32 + kThreads - 1) / kThreads;
  gather_runs_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(plan),
      static_cast<const long long*>(perm), static_cast<V*>(out), n_out,
      n_slots, row_bytes / static_cast<long long>(sizeof(V)), span);
}

}  // namespace

// table: [n_rows, row_bytes] bytes; plan: [n_slots] int32 (n_slots >= n_out,
// a multiple of the plan block); perm: [n_out] int64 sorted slot -> caller
// slot, or null when the ids were presorted; out: [n_out, row_bytes].
// Launches on `stream` and returns cudaGetLastError() of the launch (0 when
// n_out == 0: nothing launched).
extern "C" int glt_gather_runs(const void* table, const void* plan,
                               const void* perm, void* out, long long n_rows,
                               long long n_out, long long n_slots,
                               long long row_bytes, int span, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0 || span < 1 || n_slots < n_out ||
      n_rows > static_cast<long long>(kRowMask)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0) {
    launch<uint4>(table, plan, perm, out, n_out, n_slots, row_bytes, span, s);
  } else if (a % 8 == 0) {
    launch<uint2>(table, plan, perm, out, n_out, n_slots, row_bytes, span, s);
  } else if (a % 4 == 0) {
    launch<uint32_t>(table, plan, perm, out, n_out, n_slots, row_bytes, span,
                     s);
  } else if (a % 2 == 0) {
    launch<uint16_t>(table, plan, perm, out, n_out, n_slots, row_bytes, span,
                     s);
  } else {
    launch<uint8_t>(table, plan, perm, out, n_out, n_slots, row_bytes, span,
                    s);
  }
  return static_cast<int>(cudaGetLastError());
}

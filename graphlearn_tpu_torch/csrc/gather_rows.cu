// Row gather: out[i, :] = table[clamp(ids[i], 0, N - 1), :].
//
// Replaces: graphlearn_tpu/ops/gather_pallas.py `_gather_kernel` (wrapper
// `gather_rows_hbm`), the TPU kernel that keeps G single-row DMAs in flight
// per grid step. It is the feature lookup of every batch: at the products
// batch (937,984 slots x 100 f32) it moves ~750 MB.
//
// Bound on the H100: bytes. The kernel does no arithmetic; each output row
// is one read of a table row and one write. The least time is the gathered
// rows plus the ids read once and the output written once, over 3.35 TB/s.
//
// Design: one warp per output row, after the reference's warp-per-row UVA
// gather. The id is loaded once per warp and clamped in the kernel (int32 or
// int64 ids); the 32 lanes then copy the row with the widest vector the row
// width and the two base pointers allow (16 bytes for an F=100 f32 row of
// 400 B, 8/4/2/1 bytes otherwise: F=100 bf16 is 200 B, which is 8-byte
// aligned). Neighbouring lanes touch neighbouring addresses, so each row
// read and write is fully coalesced; many warps per SM keep enough rows in
// flight to hide the latency of the random row reads. The copy is agnostic
// of dtype, so f32, bf16 and int32 tables all go through it. cp.async/TMA
// staging is left for a later tuning pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V, typename I>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const I* __restrict__ ids,
                                   V* __restrict__ out, long long n_rows,
                                   long long n_ids, long long vec_per_row) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_ids) return;
  long long r = static_cast<long long>(ids[warp]);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  const V* src = table + r * vec_per_row;
  V* dst = out + warp * vec_per_row;
  for (long long c = lane; c < vec_per_row; c += 32) dst[c] = src[c];
}

constexpr int kThreads = 256;  // 8 warps = 8 rows per block

template <typename V, typename I>
void launch(const void* table, const void* ids, void* out, long long n_rows,
            long long n_ids, long long row_bytes, cudaStream_t stream) {
  const long long blocks = (n_ids * 32 + kThreads - 1) / kThreads;
  gather_rows_kernel<V, I><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      static_cast<const V*>(table), static_cast<const I*>(ids),
      static_cast<V*>(out), n_rows, n_ids,
      row_bytes / static_cast<long long>(sizeof(V)));
}

template <typename I>
void dispatch(const void* table, const void* ids, void* out, long long n_rows,
              long long n_ids, long long row_bytes, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0) {
    launch<uint4, I>(table, ids, out, n_rows, n_ids, row_bytes, stream);
  } else if (a % 8 == 0) {
    launch<uint2, I>(table, ids, out, n_rows, n_ids, row_bytes, stream);
  } else if (a % 4 == 0) {
    launch<uint32_t, I>(table, ids, out, n_rows, n_ids, row_bytes, stream);
  } else if (a % 2 == 0) {
    launch<uint16_t, I>(table, ids, out, n_rows, n_ids, row_bytes, stream);
  } else {
    launch<uint8_t, I>(table, ids, out, n_rows, n_ids, row_bytes, stream);
  }
}

}  // namespace

// table: [n_rows, row_bytes] bytes; ids: [n_ids] int32 (ids_64 == 0) or
// int64; out: [n_ids, row_bytes]. Launches on `stream` and returns
// cudaGetLastError() of the launch (0 when n_ids == 0: nothing launched).
extern "C" int glt_gather_rows(const void* table, const void* ids, int ids_64,
                               void* out, long long n_rows, long long n_ids,
                               long long row_bytes, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_64) {
    dispatch<long long>(table, ids, out, n_rows, n_ids, row_bytes, s);
  } else {
    dispatch<int>(table, ids, out, n_rows, n_ids, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

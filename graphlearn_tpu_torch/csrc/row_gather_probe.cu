// Row gather, one CTA per output row: out[i, :] = table[clamp(ids[i]), :].
//
// Replaces: benchmarks/prof_mem.py `gather_kernel` / `pallas_row_gather`
// (probe G), the TPU probe whose grid has one step per output row, the
// step's table row picked by a scalar-prefetched index through its
// BlockSpec index map. It is a measurement probe: the question it answers
// on this card is what a one-row-per-program gather costs next to the
// port's row-gather kernel (csrc/gather_rows.cu, one warp per row, many
// rows per CTA) and next to `index_select`.
//
// Bound on the H100: bytes. The kernel does no arithmetic; the least time
// is the ids read once, each distinct row read once and each output row
// written once, over 3.35 TB/s.
//
// Design: the grid has one CTA per output row, as the TPU grid has one
// step per row. Every thread of the CTA reads its id (one broadcast load,
// the counterpart of the scalar-prefetched index) and the CTA copies the
// row with the
// widest vector the row width and the base pointers allow (16 bytes for a
// 128-wide f32 row of 512 B: 32 lanes, one vector each). The TPU probe
// leaves an id outside [0, N) undefined; here it is clamped, as the
// row-gather kernel clamps it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V, typename I>
__global__ void row_gather_probe_kernel(const V* __restrict__ table,
                                        const I* __restrict__ ids,
                                        V* __restrict__ out, long long n_rows,
                                        long long vec_per_row) {
  const long long i = blockIdx.x;
  long long r = static_cast<long long>(ids[i]);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  const V* src = table + r * vec_per_row;
  V* dst = out + i * vec_per_row;
  for (long long c = threadIdx.x; c < vec_per_row; c += blockDim.x) {
    dst[c] = src[c];
  }
}

template <typename V, typename I>
void launch(const void* table, const void* ids, void* out, long long n_rows,
            long long n_ids, long long row_bytes, cudaStream_t stream) {
  const long long vec = row_bytes / static_cast<long long>(sizeof(V));
  // one warp for rows up to 32 vectors, up to 8 warps for wider rows
  long long threads = (vec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  row_gather_probe_kernel<V, I><<<static_cast<unsigned>(n_ids),
                                  static_cast<unsigned>(threads), 0, stream>>>(
      static_cast<const V*>(table), static_cast<const I*>(ids),
      static_cast<V*>(out), n_rows, vec);
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
extern "C" int glt_row_gather_probe(const void* table, const void* ids,
                                    int ids_64, void* out, long long n_rows,
                                    long long n_ids, long long row_bytes,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0 || n_ids > 0x7FFFFFFFLL) {
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

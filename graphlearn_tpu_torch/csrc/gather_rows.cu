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
//
// Second entry, glt_gather_rows_sharded: the same gather over a table held
// as S equal row blocks, one per card of a feature store's device group
// (graphlearn_tpu/data/feature.py:122-140 row-shards the hot block over the
// group; the reference reads the other cards' shards by peer pointer,
// unified_tensor.cu:233-269). It has its own kernel, so K1's one-table
// kernel above keeps no branch for it. One launch on the store's card reads
// each row from its owner block through a device array of the S base
// addresses, made once when the store is placed, so a captured step replays
// it. A remote row crosses NVLink (450 GB/s each way per card), so across
// cards the bound is the larger of the HBM bytes over 3.35 TB/s and the
// remote rows' bytes over that rate. The warp-per-row copy is K1's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_restore.cuh"

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
  glt::DeviceRestore restore;
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

namespace {

// Rows are n_rows / rows_per_shard equal blocks; `shards` is a device array
// of their base addresses (on this card or its peers).
template <typename V, typename I>
__global__ void gather_rows_sharded_kernel(const V* const* __restrict__ shards,
                                           long long rows_per_shard,
                                           const I* __restrict__ ids,
                                           V* __restrict__ out,
                                           long long n_rows, long long n_ids,
                                           long long vec_per_row) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_ids) return;
  long long r = static_cast<long long>(ids[warp]);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  const long long s = r / rows_per_shard;
  const V* src = shards[s] + (r - s * rows_per_shard) * vec_per_row;
  V* dst = out + warp * vec_per_row;
  for (long long c = lane; c < vec_per_row; c += 32) dst[c] = src[c];
}

template <typename V, typename I>
void launch_sharded(const void* shards, long long rows_per_shard,
                    const void* ids, void* out, long long n_rows,
                    long long n_ids, long long row_bytes,
                    cudaStream_t stream) {
  const long long blocks = (n_ids * 32 + kThreads - 1) / kThreads;
  gather_rows_sharded_kernel<V, I><<<static_cast<unsigned>(blocks), kThreads,
                                     0, stream>>>(
      static_cast<const V* const*>(shards), rows_per_shard,
      static_cast<const I*>(ids), static_cast<V*>(out), n_rows, n_ids,
      row_bytes / static_cast<long long>(sizeof(V)));
}

// `bases` is the OR of every block's base address: the vector width must
// divide each of them, the output and the row.
template <typename I>
void dispatch_sharded(const void* shards, long long rows_per_shard,
                      uintptr_t bases, const void* ids, void* out,
                      long long n_rows, long long n_ids, long long row_bytes,
                      cudaStream_t stream) {
  const uintptr_t a = bases | reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0) {
    launch_sharded<uint4, I>(shards, rows_per_shard, ids, out, n_rows, n_ids,
                             row_bytes, stream);
  } else if (a % 8 == 0) {
    launch_sharded<uint2, I>(shards, rows_per_shard, ids, out, n_rows, n_ids,
                             row_bytes, stream);
  } else if (a % 4 == 0) {
    launch_sharded<uint32_t, I>(shards, rows_per_shard, ids, out, n_rows,
                                n_ids, row_bytes, stream);
  } else if (a % 2 == 0) {
    launch_sharded<uint16_t, I>(shards, rows_per_shard, ids, out, n_rows,
                                n_ids, row_bytes, stream);
  } else {
    launch_sharded<uint8_t, I>(shards, rows_per_shard, ids, out, n_rows,
                               n_ids, row_bytes, stream);
  }
}

}  // namespace

// The same gather over a row-sharded table: rows [s * rows_per_shard,
// (s + 1) * rows_per_shard) are block s, which may lie on another card.
// shards: a device array (on `device`) of the n_shards blocks' base
// addresses; bases_or: the OR of those addresses (the vector width must
// divide each). Row r is read from block r / rows_per_shard: over NVLink
// when that block is on a peer card, which needs the pair's peer access
// (glt_enable_peer_access) before the launch. One launch on `device`
// writes out there; the caller's current device is left as it was.
extern "C" int glt_gather_rows_sharded(const void* shards, long long n_shards,
                                       long long rows_per_shard,
                                       long long bases_or, const void* ids,
                                       int ids_64, void* out, long long n_ids,
                                       long long row_bytes, int device,
                                       void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0) return 0;
  if (shards == nullptr || n_shards <= 0 || rows_per_shard <= 0 ||
      row_bytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_rows = n_shards * rows_per_shard;
  const uintptr_t bases = static_cast<uintptr_t>(bases_or);
  if (ids_64) {
    dispatch_sharded<long long>(shards, rows_per_shard, bases, ids, out,
                                n_rows, n_ids, row_bytes, s);
  } else {
    dispatch_sharded<int>(shards, rows_per_shard, bases, ids, out, n_rows,
                          n_ids, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Lets kernels on `device` read memory of `peer` (cudaDeviceEnablePeerAccess).
// *can receives cudaDeviceCanAccessPeer's verdict; when it is 0 nothing is
// enabled and 0 is returned (the caller raises, naming the pair). A pair
// enabled before (by this library or by PyTorch's copies) is not an error.
// The caller's current device is left as it was.
extern "C" int glt_enable_peer_access(int device, int peer, int* can) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceCanAccessPeer(can, device, peer);
  if (err != cudaSuccess || !*can) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the (non-sticky) error the call recorded
    return 0;
  }
  return static_cast<int>(err);
}

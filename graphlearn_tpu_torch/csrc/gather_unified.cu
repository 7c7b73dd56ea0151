// Hot/cold row gather: out[i, :] = r < H ? hot[r, :] : cold[r - H, :],
// r = clamp(ids[i], 0, N - 1), N = H + cold rows.
//
// Replaces: graphlearn_tpu/data/unified_tensor.py `UnifiedTensor.__getitem__`
// in its mixed form (lines 131-183). That is not a Pallas kernel: a TPU
// cannot read host memory from a kernel, so the JAX store reads the ids on
// the host (a device-to-host sync), gathers the cold rows with numpy in a
// worker thread, ships them padded to a power of two, and scatters them into
// the hot gather's output. The H100 has UVA, and the reference's own design
// is a warp-per-row gather that reads cold rows straight from pinned host
// memory (reference unified_tensor.cu:48-81). This is that kernel.
//
// `hot` is the device prefix [H, F] in HBM. `cold` is the card's address of
// the host tail [N - H, F]: page-locked, mapped host memory
// (cudaHostRegister + cudaHostGetDevicePointer, done once by
// glt_host_register below), read over PCIe by the loads themselves. Either
// part may be empty (H = 0: all rows on the host; H = N: all on the card).
//
// Bound on the H100: bytes, on two links. Hot rows cost their bytes over HBM
// (3.35 TB/s); cold rows cross PCIe (Gen5 x16, ~50 GB/s each way in
// practice), so at any real cold share the cold bytes over the measured
// host-to-device rate set the time. A mapped read costs about a microsecond,
// not HBM's few hundred nanoseconds.
//
// Design (simple and right first): one warp per output row, after K1
// (csrc/gather_rows.cu) and the reference's UVA gather. The id is loaded
// once per warp and clamped; the branch between the parts is warp-uniform.
// The 32 lanes copy the row with the widest vector that the row width and
// the base pointers of both parts and the output allow (16 bytes for a
// 400-byte or 512-byte f32 row), so a cold row is one run of 16-byte PCIe
// reads. Small blocks (8 warps) and no shared memory let 64 warps reside on
// each SM: ~8,400 rows, so thousands of mapped reads are in flight, which is
// what hides the PCIe latency. The copy is agnostic of dtype (f32, bf16,
// f16, int32). No staging, no host step, no allocation: the launch needs no
// host sync.
//
// Second entry, glt_gather_unified_sharded: a device group's store with a
// host tail (graphlearn_tpu/data/feature.py:122-140, the mixed split), its
// hot part row-sharded over the group's cards and read through a device
// array of the shards' base addresses (as gather_rows.cu's sharded entry),
// the cold rows over UVA as above; still one launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Restores the calling thread's current device when the sharded entry
// returns (gather_rows.cu's DeviceRestore).
struct DeviceRestore {
  int prev = -1;
  DeviceRestore() {
    if (cudaGetDevice(&prev) != cudaSuccess) prev = -1;
  }
  ~DeviceRestore() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// kSharded false: the hot rows are one block, `hot`. True: they are
// n_hot / rows_per_shard equal blocks (a device group's row shards, on this
// card or its peers) and `shards` is a device array of their base
// addresses (glt_gather_unified_sharded); `hot` is unused. The choice is
// made at compile time, so the one-block kernel carries no branch for it.
template <typename V, typename I, bool kSharded>
__global__ void gather_unified_kernel(const V* __restrict__ hot,
                                      const V* const* __restrict__ shards,
                                      long long rows_per_shard,
                                      const V* __restrict__ cold,
                                      const I* __restrict__ ids,
                                      V* __restrict__ out, long long n_hot,
                                      long long n_rows, long long n_ids,
                                      long long vec_per_row) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_ids) return;
  long long r = static_cast<long long>(ids[warp]);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  const V* src;
  if (r >= n_hot) {
    src = cold + (r - n_hot) * vec_per_row;
  } else if (!kSharded) {
    src = hot + r * vec_per_row;
  } else {
    const long long s = r / rows_per_shard;
    src = shards[s] + (r - s * rows_per_shard) * vec_per_row;
  }
  V* dst = out + warp * vec_per_row;
  for (long long c = lane; c < vec_per_row; c += 32) dst[c] = src[c];
}

constexpr int kThreads = 256;  // 8 warps = 8 rows per block

template <typename V, typename I, bool kSharded>
void launch(const void* hot, const void* shards, long long rows_per_shard,
            const void* cold, const void* ids, void* out, long long n_hot,
            long long n_rows, long long n_ids, long long row_bytes,
            cudaStream_t stream) {
  const long long blocks = (n_ids * 32 + kThreads - 1) / kThreads;
  gather_unified_kernel<V, I, kSharded><<<static_cast<unsigned>(blocks),
                                          kThreads, 0, stream>>>(
      static_cast<const V*>(hot), static_cast<const V* const*>(shards),
      rows_per_shard, static_cast<const V*>(cold),
      static_cast<const I*>(ids), static_cast<V*>(out), n_hot, n_rows,
      n_ids, row_bytes / static_cast<long long>(sizeof(V)));
}

// `hot_bases` is the OR of the hot part's base addresses (the block, or
// every shard): the vector width must divide them, the cold base, the
// output and the row.
template <typename I, bool kSharded>
void dispatch(const void* hot, const void* shards, long long rows_per_shard,
              uintptr_t hot_bases, const void* cold, const void* ids,
              void* out, long long n_hot, long long n_rows, long long n_ids,
              long long row_bytes, cudaStream_t stream) {
  const uintptr_t a = hot_bases | reinterpret_cast<uintptr_t>(cold) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0) {
    launch<uint4, I, kSharded>(hot, shards, rows_per_shard, cold, ids,
                               out, n_hot, n_rows, n_ids, row_bytes, stream);
  } else if (a % 8 == 0) {
    launch<uint2, I, kSharded>(hot, shards, rows_per_shard, cold, ids,
                               out, n_hot, n_rows, n_ids, row_bytes, stream);
  } else if (a % 4 == 0) {
    launch<uint32_t, I, kSharded>(hot, shards, rows_per_shard, cold, ids,
                                  out, n_hot, n_rows, n_ids, row_bytes,
                                  stream);
  } else if (a % 2 == 0) {
    launch<uint16_t, I, kSharded>(hot, shards, rows_per_shard, cold, ids,
                                  out, n_hot, n_rows, n_ids, row_bytes,
                                  stream);
  } else {
    launch<uint8_t, I, kSharded>(hot, shards, rows_per_shard, cold, ids,
                                 out, n_hot, n_rows, n_ids, row_bytes, stream);
  }
}

}  // namespace

// hot: [n_hot, row_bytes] bytes on the card (may be null when n_hot == 0);
// cold: the card's address of [n_rows - n_hot, row_bytes] bytes of mapped
// host memory (may be null when n_hot == n_rows); ids: [n_ids] int32
// (ids_64 == 0) or int64 on the card; out: [n_ids, row_bytes] on the card.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 when
// n_ids == 0: nothing launched).
extern "C" int glt_gather_unified(const void* hot, const void* cold,
                                  const void* ids, int ids_64, void* out,
                                  long long n_hot, long long n_rows,
                                  long long n_ids, long long row_bytes,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0 || n_hot < 0 || n_hot > n_rows ||
      (n_hot > 0 && hot == nullptr) ||
      (n_hot < n_rows && cold == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(hot);
  if (ids_64) {
    dispatch<long long, false>(hot, nullptr, 0, bases, cold, ids, out,
                               n_hot, n_rows, n_ids, row_bytes, s);
  } else {
    dispatch<int, false>(hot, nullptr, 0, bases, cold, ids, out, n_hot,
                         n_rows, n_ids, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same gather with a row-sharded hot part (a device group's store with
// a host tail, still one launch): hot rows [s * rows_per_shard, (s + 1) *
// rows_per_shard) are shard s, read through `shards`, a device array (on
// `device`) of the n_shards shards' base addresses, over NVLink for a
// shard on a peer card (peer access enabled before; glt_enable_peer_access
// in the gather_rows library); bases_or is the OR of those addresses.
// n_hot = n_shards * rows_per_shard; the cold rows are read over UVA as
// above. The caller's current device is left as it was.
extern "C" int glt_gather_unified_sharded(const void* shards,
                                          long long n_shards,
                                          long long rows_per_shard,
                                          long long bases_or,
                                          const void* cold, const void* ids,
                                          int ids_64, void* out,
                                          long long n_rows, long long n_ids,
                                          long long row_bytes, int device,
                                          void* stream) {
  DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0) return 0;
  const long long n_hot = n_shards * rows_per_shard;
  if (shards == nullptr || n_shards <= 0 || rows_per_shard <= 0 ||
      row_bytes <= 0 || n_hot > n_rows ||
      (n_hot < n_rows && cold == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = static_cast<uintptr_t>(bases_or);
  if (ids_64) {
    dispatch<long long, true>(nullptr, shards, rows_per_shard, bases, cold,
                              ids, out, n_hot, n_rows, n_ids, row_bytes, s);
  } else {
    dispatch<int, true>(nullptr, shards, rows_per_shard, bases, cold, ids,
                        out, n_hot, n_rows, n_ids, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Page-locks [host, host + nbytes) and maps it into the card's address
// space: cudaHostRegisterMapped, plus cudaHostRegisterReadOnly where the
// card reports support for it (*read_only says which). *device_ptr receives
// cudaHostGetDevicePointer's address of `host`, the one kernels must use.
extern "C" int glt_host_register(void* host, long long nbytes, int device,
                                 void** device_ptr, int* read_only) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int ro = 0;
  err = cudaDeviceGetAttribute(&ro, cudaDevAttrHostRegisterReadOnlySupported,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned flags = cudaHostRegisterMapped;
  if (ro) flags |= cudaHostRegisterReadOnly;
  err = cudaHostRegister(host, static_cast<size_t>(nbytes), flags);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaHostGetDevicePointer(device_ptr, host, 0);
  if (err != cudaSuccess) {
    cudaHostUnregister(host);
    return static_cast<int>(err);
  }
  *read_only = ro;
  return 0;
}

extern "C" int glt_host_unregister(void* host, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaHostUnregister(host));
}

// Row gather: out[i, :] = table[clamp(ids[i], 0, N - 1), :].
//
// Replaces: graphlearn_tpu/ops/gather_pallas.py `_gather_kernel` (wrapper
// `gather_rows_hbm`), the TPU kernel that keeps G single-row DMAs in flight
// per grid step. It is the feature lookup of every batch: at the products
// batch (937,984 slots x 100 f32) it moves ~750 MB.
//
// Bound on the H100: bytes. The kernel does no arithmetic. The least time
// is the ids read once, each distinct row read once and the output written
// once, over 3.35 TB/s. A gather that does not dedup reads every slot's row:
// on uniform ids the duplicates lie too far apart to meet in L2, so its
// floor is the ids plus twice the output's bytes (0.225 ms for the batch
// above, 0.113 in bf16).
//
// What holds a warp-per-row gather back: each warp makes two dependent
// DRAM round trips (its id, then its row) and holds one row in flight, and
// at 200 bytes (bf16) a row in flight a warp the card cannot keep enough
// reads outstanding.
//
// Design: a persistent grid, sized from the kernel's occupancy on the card
// (queried once per card) and capped by the work. Warp w of the grid's n
// copies the groups of U output rows w, w + n, w + 2n, ...: the warps in
// flight share one window of consecutive output rows, so the output is
// written in order (a contiguous run of rows a warp, measured, lost: its
// writes scatter over the whole output). Lanes 0..U-1 load the group's ids
// and resolve their rows' addresses, and the next group's ids are loaded
// before the current rows are copied, so the id round trip hides behind
// the copy. The copy maps the warp's K x 32 lane slots over the group's
// rows, a power of two of slots a row (each row's vectors on neighbouring
// lanes, so one load instruction reads whole rows, never strided pieces of
// several); each lane issues its K loads before any store. K x 32 vectors
// make 1 KB a warp: U = 2 for 400- and 512-byte f32 rows (16-byte
// vectors), 4 for 200-byte bf16 rows (8-byte vectors); rows wider than 32
// vectors go one at a time in K x 32-vector pieces. 1 KB keeps a thread at
// 40-48 registers, 40-48 warps an SM; 2 KB (more registers, fewer warps)
// and 4 KB measured slower. A lane learns a row's address from the lane
// that holds its id (__shfl_sync). The table is read with ld.global.nc
// (L1::no_allocate and an L2::256B prefetch hint measured slower) and the
// output written with st.global.cs (streamed past L2). The vector is the
// widest that divides the row and both base addresses: 16 bytes for a
// 400-byte f32 row, 8 for a 200-byte bf16 row, 4/2/1 otherwise. The copy
// is blind to dtype, so f32, bf16, f16 and int32 tables all go through it.
//
// Second entry, glt_gather_rows_sharded: the same gather over a table held
// as S equal row blocks, one per card of a feature store's device group
// (graphlearn_tpu/data/feature.py:122-140 row-shards the hot block over the
// group; the reference reads the other cards' shards by peer pointer,
// unified_tensor.cu:233-269). One launch on the store's card reads each row
// from its owner block through a device array of the S base addresses, made
// once when the store is placed, so a captured step replays it. A remote
// row crosses NVLink (450 GB/s each way per card), so across cards the bound
// is the larger of the HBM bytes over 3.35 TB/s and the remote rows' bytes
// over that rate. Both entries run one copy routine (copy_groups below);
// they differ only in how a lane turns a row index into its address.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device_restore.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarpsPerBlock = kThreads / 32;
// a row's vectors are counted in 32 bits, with room for a piece
constexpr long long kMaxRowBytes = 1LL << 30;

// Vectors a lane holds in flight: 1 KB a warp for 16- and 8-byte vectors,
// 4 vectors for the narrow routes (unaligned views and odd widths).
template <typename V>
__host__ __device__ constexpr int vectors_per_lane() {
  return sizeof(V) >= 8 ? 1024 / (32 * static_cast<int>(sizeof(V))) : 4;
}

// How a row index (already clamped to [0, n_rows)) becomes its address.
template <typename V>
struct OneTable {
  const V* table;
  long long n_rows, vec_per_row;
  __device__ const V* row(long long r) const {
    return table + r * vec_per_row;
  }
};

// Rows are n_rows / rows_per_shard equal blocks; `shards` is a device array
// of their base addresses (on this card or its peers).
template <typename V>
struct ShardedTable {
  const V* const* shards;
  long long rows_per_shard, n_rows, vec_per_row;
  __device__ const V* row(long long r) const {
    const long long s = r / rows_per_shard;
    return shards[s] + (r - s * rows_per_shard) * vec_per_row;
  }
};

// The copy routine of both kernels. Warp w of the grid's n_warps copies
// the groups of U output rows w, w + n_warps, w + 2 n_warps, ...: the
// warps in flight work on one window of consecutive rows, as a warp-per-row
// grid's would, so the output is written in order. Lanes 0..U-1 load the
// group's ids (the next group's while the current one is copied) and
// resolve their rows' addresses. The copy maps the warp's K x 32 lane
// slots over the group's rows, `piece` slots a row: the power of two at or
// above the row's vectors (32 / piece rows a load instruction, each row's
// vectors on neighbouring lanes), or K x 32 for a row wider than 32
// vectors (U = 1, the row in K x 32-vector pieces). Every lane issues its
// K loads before any store.
template <typename V, typename I, typename Rows>
__device__ __forceinline__ void copy_groups(const Rows& rows,
                                            const I* __restrict__ ids,
                                            V* __restrict__ out,
                                            long long n_ids, int rows_per_group,
                                            int piece_log2) {
  constexpr int K = vectors_per_lane<V>();
  const int lane = threadIdx.x & 31;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const int w = static_cast<int>(rows.vec_per_row);   // <= kMaxRowBytes
  const int piece = 1 << piece_log2;
  long long row0 =
      ((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
      rows_per_group;
  const long long step = n_warps * rows_per_group;
  I next = lane < rows_per_group && row0 + lane < n_ids
               ? __ldg(ids + row0 + lane)
               : I(0);
  for (; row0 < n_ids; row0 += step) {
    long long r = static_cast<long long>(next);
    r = r < 0 ? 0 : (r >= rows.n_rows ? rows.n_rows - 1 : r);
    const unsigned long long src =
        reinterpret_cast<unsigned long long>(rows.row(r));
    if (lane < rows_per_group && row0 + step + lane < n_ids) {
      next = __ldg(ids + row0 + step + lane);
    }
    const int n_rows = n_ids - row0 < rows_per_group
                           ? static_cast<int>(n_ids - row0)
                           : rows_per_group;
    V* dst = out + row0 * w;
    for (int c0 = 0; c0 < w; c0 += piece) {
      V buf[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = 32 * k + lane;
        const int u = e >> piece_log2;
        const int c = c0 + (e & (piece - 1));
        const V* p = reinterpret_cast<const V*>(
            __shfl_sync(0xffffffffu, src, u & 31));
        if (u < n_rows && c < w) buf[k] = __ldg(p + c);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = 32 * k + lane;
        const int u = e >> piece_log2;
        const int c = c0 + (e & (piece - 1));
        // streamed past L2 (evict first): the table's rows may be read again
        if (u < n_rows && c < w) __stcs(dst + (u * w + c), buf[k]);
      }
    }
  }
}

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(OneTable<V> rows, const I* __restrict__ ids,
                       V* __restrict__ out, long long n_ids,
                       int rows_per_group, int piece_log2) {
  copy_groups<V, I>(rows, ids, out, n_ids, rows_per_group, piece_log2);
}

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    gather_rows_sharded_kernel(ShardedTable<V> rows, const I* __restrict__ ids,
                               V* __restrict__ out, long long n_ids,
                               int rows_per_group, int piece_log2) {
  copy_groups<V, I>(rows, ids, out, n_ids, rows_per_group, piece_log2);
}

constexpr int kCachedDevices = 64;
std::atomic<int> g_sms[kCachedDevices];

// Blocks of `kernel` that one SM holds at once on `device`, times the SMs:
// the persistent grid. Queried once per kernel and card (0 when the query
// fails: the launch then reports the error).
template <typename Kernel>
long long grid_blocks(Kernel kernel, int device) {
  static std::atomic<int> cached[kCachedDevices];
  const bool keep = device >= 0 && device < kCachedDevices;
  int per_sm = keep ? cached[device].load(std::memory_order_relaxed) : 0;
  int sms = keep ? g_sms[device].load(std::memory_order_relaxed) : 0;
  if (per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
        cudaSuccess) {
      return 0;
    }
    if (keep) cached[device].store(per_sm, std::memory_order_relaxed);
  }
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess) {
      return 0;
    }
    if (keep) g_sms[device].store(sms, std::memory_order_relaxed);
  }
  return static_cast<long long>(per_sm) * sms;
}

// The launch's shape: U rows a group and the lane slots a row (a power of
// two), the persistent grid's warps and the blocks launched (no more than
// the groups need).
struct Plan {
  int rows_per_group, piece_log2;
  long long full_warps, blocks;
};

template <typename V>
Plan plan(long long grid, long long n_ids, long long row_bytes) {
  constexpr int K = vectors_per_lane<V>();
  const long long w = row_bytes / static_cast<long long>(sizeof(V));
  Plan p;
  p.piece_log2 = 0;
  while ((1LL << p.piece_log2) < w && p.piece_log2 < 5) ++p.piece_log2;
  if (w > 32) {  // one row at a time, in K x 32-vector pieces
    while ((1 << p.piece_log2) < 32 * K) ++p.piece_log2;
    p.rows_per_group = 1;
  } else {
    const int per_load = 32 >> p.piece_log2;
    p.rows_per_group = per_load * K < 32 ? per_load * K : 32;
  }
  p.full_warps = grid * kWarpsPerBlock;
  const long long groups = (n_ids + p.rows_per_group - 1) / p.rows_per_group;
  const long long need = (groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  p.blocks = need < grid ? need : grid;
  return p;
}

template <typename V, typename I, typename Rows, typename Kernel>
int launch(Kernel kernel, const Rows& rows, const void* ids, void* out,
           long long n_ids, long long row_bytes, int device,
           cudaStream_t stream, long long* shape) {
  const long long grid = grid_blocks(kernel, device);
  if (grid == 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorInvalidConfiguration);
  }
  const Plan p = plan<V>(grid, n_ids, row_bytes);
  if (shape != nullptr) {
    shape[0] = p.full_warps;
    shape[1] = p.rows_per_group;
    shape[2] = static_cast<long long>(sizeof(V));
    shape[3] = vectors_per_lane<V>();
    return 0;
  }
  kernel<<<static_cast<unsigned>(p.blocks), kThreads, 0, stream>>>(
      rows, static_cast<const I*>(ids), static_cast<V*>(out), n_ids,
      p.rows_per_group, p.piece_log2);
  return static_cast<int>(cudaGetLastError());
}

// The widest vector that divides `align` (the OR of the row's bytes and
// every base address).
template <typename F>
int by_vector(uintptr_t align, F&& f) {
  if (align % 16 == 0) return f(uint4());
  if (align % 8 == 0) return f(uint2());
  if (align % 4 == 0) return f(uint32_t());
  if (align % 2 == 0) return f(uint16_t());
  return f(uint8_t());
}

template <typename I>
int gather_one(const void* table, const void* ids, void* out,
               long long n_rows, long long n_ids, long long row_bytes,
               int device, cudaStream_t stream, long long* shape) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  return by_vector(a, [&](auto v) {
    using V = decltype(v);
    const OneTable<V> rows{static_cast<const V*>(table), n_rows,
                           row_bytes / static_cast<long long>(sizeof(V))};
    return launch<V, I>(gather_rows_kernel<V, I>, rows, ids, out, n_ids,
                        row_bytes, device, stream, shape);
  });
}

template <typename I>
int gather_sharded(const void* shards, long long rows_per_shard,
                   uintptr_t bases, const void* ids, void* out,
                   long long n_rows, long long n_ids, long long row_bytes,
                   int device, cudaStream_t stream, long long* shape) {
  const uintptr_t a = bases | reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  return by_vector(a, [&](auto v) {
    using V = decltype(v);
    const ShardedTable<V> rows{static_cast<const V* const*>(shards),
                               rows_per_shard, n_rows,
                               row_bytes / static_cast<long long>(sizeof(V))};
    return launch<V, I>(gather_rows_sharded_kernel<V, I>, rows, ids, out,
                        n_ids, row_bytes, device, stream, shape);
  });
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
  if (n_rows <= 0 || row_bytes <= 0 || row_bytes > kMaxRowBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ids_64 ? gather_one<long long>(table, ids, out, n_rows, n_ids,
                                        row_bytes, device, s, nullptr)
                : gather_one<int>(table, ids, out, n_rows, n_ids, row_bytes,
                                  device, s, nullptr);
}

// The launch shape glt_gather_rows (sharded == 0; bases: the table's
// address) or glt_gather_rows_sharded (sharded == 1; bases: the OR of the
// blocks' addresses) would take for an output 16-byte aligned (as torch
// allocates it), with nothing launched: shape[0] the persistent grid's
// warps on `device`, shape[1] the rows a warp copies at once (U), shape[2]
// the vector's bytes, shape[3] the vectors a lane holds in flight. For
// tests and reports.
extern "C" int glt_gather_rows_shape(long long bases, int sharded, int ids_64,
                                     long long n_ids, long long row_bytes,
                                     int device, long long* shape) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids <= 0 || row_bytes <= 0 || row_bytes > kMaxRowBytes ||
      shape == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t a = static_cast<uintptr_t>(bases);
  const void* table = reinterpret_cast<const void*>(a);
  if (sharded) {
    return ids_64 ? gather_sharded<long long>(nullptr, 1, a, nullptr, nullptr,
                                              1, n_ids, row_bytes, device,
                                              nullptr, shape)
                  : gather_sharded<int>(nullptr, 1, a, nullptr, nullptr, 1,
                                        n_ids, row_bytes, device, nullptr,
                                        shape);
  }
  return ids_64 ? gather_one<long long>(table, nullptr, nullptr, 1, n_ids,
                                        row_bytes, device, nullptr, shape)
                : gather_one<int>(table, nullptr, nullptr, 1, n_ids,
                                  row_bytes, device, nullptr, shape);
}

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
      row_bytes <= 0 || row_bytes > kMaxRowBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_rows = n_shards * rows_per_shard;
  const uintptr_t bases = static_cast<uintptr_t>(bases_or);
  return ids_64 ? gather_sharded<long long>(shards, rows_per_shard, bases,
                                            ids, out, n_rows, n_ids,
                                            row_bytes, device, s, nullptr)
                : gather_sharded<int>(shards, rows_per_shard, bases, ids, out,
                                      n_rows, n_ids, row_bytes, device, s,
                                      nullptr);
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

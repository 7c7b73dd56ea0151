// Hot/cold row gather: out[i, :] = r < H ? hot[r, :] : cold[r - H, :],
// r = clamp(ids[i], 0, N - 1), N = H + cold rows.
//
// Replaces: graphlearn_tpu/data/unified_tensor.py `UnifiedTensor.__getitem__`
// in its mixed form (lines 131-183). That is not a Pallas kernel: a TPU
// cannot read host memory from a kernel, so the JAX store reads the ids on
// the host (a device-to-host sync), gathers the cold rows with numpy in a
// worker thread, ships every cold slot padded to a power of two, and
// scatters them into the hot gather's output. The H100 has UVA: the kernel
// reads cold rows straight from pinned, mapped host memory, as the
// reference's warp-per-row UVA gather does (reference unified_tensor.cu:
// 48-81), and needs no host step.
//
// `hot` is the device prefix [H, F] in HBM. `cold` is the card's address of
// the host tail [N - H, F]: page-locked, mapped host memory
// (cudaHostRegister + cudaHostGetDevicePointer, done once by
// glt_host_register below), read over PCIe by the loads themselves. Either
// part may be empty (H = 0: all rows on the host; H = N: all on the card).
//
// Bound on the H100: bytes, on two links. Each distinct cold row must cross
// PCIe once (the copy engine's pinned rate, ~45-55 GB/s, is the
// yardstick); the hot rows, the output, the duplicates' copies and the
// scratch cost their bytes over HBM (3.35 TB/s). At any real cold share the
// distinct cold rows set the time: a products tree batch at split 0.25
// names 88,431 distinct cold rows in ~330,000 cold slots. A kernel's own
// reads of mapped memory travel as 128-byte line requests at a rate that
// depends on the host: graphlearn_tpu_torch/benchmarks/prof_uva.py read
// 400-byte rows at 43.5 and at 17.9 GB/s on two H100 hosts whose copy
// engines ran at 54.7 and 46.8 GB/s, and bulk copies (cp.async.bulk) of
// the same rows no faster (19.2 and 7.3 GB/s), so the warps' 16-byte loads
// stay. Where those reads are slow, nothing dedups repeated reads of a row
// for free: reading the batch's cold slots slot by slot, as the design
// this replaced did, took 3.78x as long as reading its distinct rows once.
//
// Design: each distinct cold row crosses PCIe once. Three device steps on
// the caller's stream, no host sync, no allocation here (the wrapper
// allocates the scratch on the ids' card):
// - A memset clears the scratch's two counters and an open-addressing table
//   of `cap` keys (a power of two, at least twice the cold rows a call can
//   name, so at most half full).
// - Pass 1, one warp per output slot (so a small lookup has every row in
//   flight at once). The warp loads and clamps its id. A hot row is copied
//   from HBM (from its shard through the address array, in the sharded
//   entry) straight into `out`. For a cold row, lane 0 inserts it (+1, 0
//   is empty) with a multiplicative hash and linear probing: a plain read
//   that finds the key settles a duplicate, only an empty entry is claimed
//   by atomicCAS. The warp that inserts the key wins: it records its slot
//   beside the key and reads the row over UVA once into its own slot of
//   `out`. A warp that finds its key already there appends (slot, table
//   position) to the duplicate list and copies nothing. A block counts its
//   winners and reserves its list entries in shared memory, and one thread
//   adds them to the two global counters. The 32 lanes copy a row with the
//   widest vector that the row width and the base pointers of both parts
//   and the output allow (16 bytes for a 400-byte f32 row, so a cold row is
//   one run of 16-byte PCIe reads).
//   Thousands of resident warps keep thousands of mapped reads in flight,
//   which is what hides the PCIe latency.
// - Pass 2, a persistent grid-stride kernel over the duplicate list (its
//   length read from device memory): out[winner] -> out[slot], HBM to HBM.
//   A separate launch on the same stream, so the winners' rows are there.
//   Its first thread also copies the fetch counter out for the caller.
// Which warp wins depends on the atomics' order, but every copy of a row
// has the same bytes: the output is the same bits every run. The copy is
// agnostic of dtype (f32, bf16, f16, int32).
//
// The design this replaced: one warp per output slot reading its
// row wherever it lay, so a cold row crossed PCIe once per slot naming it
// (PERF.md, section 6, keeps its times). A small lookup pays for the table
// with the memset and pass 2's launch: 0.0147 ms for a papers-sized lookup
// of 7,936 ids where that design took 0.0096.
//
// Second entry, glt_gather_unified_sharded: a device group's store with a
// host tail (graphlearn_tpu/data/feature.py:122-140, the mixed split), its
// hot part row-sharded over the group's cards and read through a device
// array of the shards' base addresses (as gather_rows.cu's sharded entry),
// the cold rows over UVA as above; the same three steps.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_restore.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps a block
constexpr int kPass2BlocksPerSm = 8;   // pass 2's persistent grid
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// The scratch, in 32-bit words: [0] the fetch counter, [1] the duplicate
// counter, [2, 2 + cap) the keys (0 empty, else cold row + 1), then the
// winning slot of each key [cap], then the duplicate list [n_ids] of
// (slot, table position) pairs. The memset clears the first 2 + cap words.
struct Scratch {
  unsigned* counts;
  unsigned* keys;
  int* winner;
  uint2* dups;
};

__device__ __forceinline__ unsigned slot_of(unsigned key, int bits) {
  return static_cast<unsigned>(
      (static_cast<unsigned long long>(key) * 0x9E3779B97F4A7C15ull) >>
      (64 - bits));
}

// One warp per output slot, kThreads / 32 slots a block. kSharded false:
// the hot rows are one block, `hot`. True: they are n_hot / rows_per_shard
// equal blocks (a device group's row shards, on this card or its peers) and
// `shards` is a device array of their base addresses; `hot` is unused. The
// choice is made at compile time, so the one-block kernel carries no branch
// for it.
template <typename V, typename I, bool kSharded>
__global__ void __launch_bounds__(kThreads)
    gather_unified_pass1(const V* __restrict__ hot,
                         const V* const* __restrict__ shards,
                         long long rows_per_shard, const V* __restrict__ cold,
                         const I* __restrict__ ids, V* __restrict__ out,
                         long long n_hot, long long n_rows, long long n_ids,
                         long long vec_per_row, Scratch sc, int bits) {
  // the block's winners and duplicates, added to the global counters by
  // one thread: a batch's ~10^5 cold slots would otherwise queue on two
  // addresses
  __shared__ unsigned block_count[2];
  __shared__ unsigned block_first;  // the block's first duplicate entry
  const long long slot =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const bool valid = slot < n_ids;
  if (threadIdx.x == 0) {
    block_count[0] = 0;
    block_count[1] = 0;
  }
  long long r = 0;
  if (valid) {
    r = static_cast<long long>(ids[slot]);
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  }
  const bool is_cold = valid && r >= n_hot;
  __syncthreads();
  // lane 0 inserts the cold row (+1: 0 is an empty key). A key, once in,
  // never changes, so a plain read that finds it settles a duplicate
  // without an atomic; only an empty entry is claimed by atomicCAS.
  int won = 0;
  unsigned pos = 0, mine = 0;
  if (is_cold && lane == 0) {
    const unsigned key = static_cast<unsigned>(r - n_hot) + 1u;
    const unsigned mask = static_cast<unsigned>((1ull << bits) - 1ull);
    pos = slot_of(key, bits);
    while (true) {
      unsigned seen = __ldcg(sc.keys + pos);
      if (seen == 0u) seen = atomicCAS(sc.keys + pos, 0u, key);
      if (seen == 0u) {
        won = 1;
        break;
      }
      if (seen == key) break;
      pos = (pos + 1u) & mask;
    }
    if (won) {
      sc.winner[pos] = static_cast<int>(slot);
      atomicAdd(&block_count[0], 1u);
    } else {
      mine = atomicAdd(&block_count[1], 1u);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_count[0]) atomicAdd(sc.counts, block_count[0]);
    block_first = block_count[1] ? atomicAdd(sc.counts + 1, block_count[1])
                                 : 0u;
  }
  __syncthreads();
  won = __shfl_sync(kFull, won, 0);
  if (is_cold && !won) {  // pass 2 fills this slot
    if (lane == 0) {
      sc.dups[block_first + mine] =
          make_uint2(static_cast<unsigned>(slot), pos);
    }
    return;
  }
  if (!valid) return;
  const V* src;
  if (is_cold) {
    src = cold + (r - n_hot) * vec_per_row;
  } else if (!kSharded) {
    src = hot + r * vec_per_row;
  } else {
    const long long s = r / rows_per_shard;
    src = shards[s] + (r - s * rows_per_shard) * vec_per_row;
  }
  V* dst = out + slot * vec_per_row;
  for (long long c = lane; c < vec_per_row; c += 32) dst[c] = src[c];
}

// Pass 2: every duplicate slot takes its winner's row, HBM to HBM. Each
// warp reads 32 list entries at once, then copies their rows one by one.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_unified_pass2(V* out, long long vec_per_row, Scratch sc,
                         long long* fetches) {
  const unsigned n_dup = sc.counts[1];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *fetches = static_cast<long long>(sc.counts[0]);
  }
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 5;
       w * 32 < n_dup; w += warps) {
    const long long i = w * 32 + lane;
    long long from = 0, to = 0;
    if (i < n_dup) {
      const uint2 e = sc.dups[i];
      to = static_cast<long long>(e.x);
      from = static_cast<long long>(sc.winner[e.y]);
    }
    unsigned todo = __ballot_sync(kFull, i < n_dup);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const V* s = out + __shfl_sync(kFull, from, j) * vec_per_row;
      V* d = out + __shfl_sync(kFull, to, j) * vec_per_row;
      for (long long c = lane; c < vec_per_row; c += 32) d[c] = s[c];
    }
  }
}

std::mutex g_sms_mu;
int g_sms[kMaxDevices];  // 0: not read yet

// The device's SM count, read once per device.
cudaError_t sm_count(int device, int* sms) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_sms_mu);
  if (g_sms[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = g_sms[device];
  return cudaSuccess;
}

struct Call {
  const void* hot;
  const void* shards;
  long long rows_per_shard;
  const void* cold;
  const void* ids;
  void* out;
  long long n_hot, n_rows, n_ids, row_bytes;
  Scratch sc;
  int bits;
  void* fetches;
  int sms;
  cudaStream_t stream;
};

template <typename V, typename I, bool kSharded>
void launch(const Call& c) {
  const long long vpr = c.row_bytes / static_cast<long long>(sizeof(V));
  const long long blocks = (c.n_ids * 32 + kThreads - 1) / kThreads;
  gather_unified_pass1<V, I, kSharded>
      <<<static_cast<unsigned>(blocks), kThreads, 0, c.stream>>>(
          static_cast<const V*>(c.hot),
          static_cast<const V* const*>(c.shards), c.rows_per_shard,
          static_cast<const V*>(c.cold), static_cast<const I*>(c.ids),
          static_cast<V*>(c.out), c.n_hot, c.n_rows, c.n_ids, vpr, c.sc,
          c.bits);
  // enough warps for the most duplicates a call can have (n_ids), at most
  // kPass2BlocksPerSm blocks an SM
  const long long need = (c.n_ids + 32LL * (kThreads / 32) - 1) /
                         (32LL * (kThreads / 32));
  const long long cap = static_cast<long long>(c.sms) * kPass2BlocksPerSm;
  const long long blocks2 = need < cap ? need : cap;
  gather_unified_pass2<V>
      <<<static_cast<unsigned>(blocks2), kThreads, 0, c.stream>>>(
          static_cast<V*>(c.out), vpr, c.sc,
          static_cast<long long*>(c.fetches));
}

// `hot_bases` is the OR of the hot part's base addresses (the block, or
// every shard): the vector width must divide them, the cold base, the
// output and the row.
template <typename I, bool kSharded>
void dispatch(const Call& c, uintptr_t hot_bases) {
  const uintptr_t a = hot_bases | reinterpret_cast<uintptr_t>(c.cold) |
                      reinterpret_cast<uintptr_t>(c.out) |
                      static_cast<uintptr_t>(c.row_bytes);
  if (a % 16 == 0) {
    launch<uint4, I, kSharded>(c);
  } else if (a % 8 == 0) {
    launch<uint2, I, kSharded>(c);
  } else if (a % 4 == 0) {
    launch<uint32_t, I, kSharded>(c);
  } else if (a % 2 == 0) {
    launch<uint16_t, I, kSharded>(c);
  } else {
    launch<uint8_t, I, kSharded>(c);
  }
}

// Checks `cap` and the 32-bit limits, clears the scratch's counters and keys
// on the stream and launches both passes. `cap` is 0 when the table has no
// cold part, else a power of two of at least 2 and at most 2^32.
template <bool kSharded>
int run(Call c, int ids_64, uintptr_t hot_bases, void* scratch,
        long long cap, int device) {
  const bool has_cold = c.n_hot < c.n_rows;
  if (scratch == nullptr || c.fetches == nullptr ||
      c.n_ids > 0x7fffffffLL || c.n_rows - c.n_hot > 0x7fffffffLL ||
      (has_cold && cap < 2) ||
      (!has_cold && cap != 0) || cap > (1LL << 32) || (cap & (cap - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = sm_count(device, &c.sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* words = static_cast<unsigned*>(scratch);
  c.sc.counts = words;
  c.sc.keys = words + 2;
  c.sc.winner = reinterpret_cast<int*>(words + 2 + cap);
  c.sc.dups = reinterpret_cast<uint2*>(words + 2 + 2 * cap);
  c.bits = 0;
  while ((1LL << c.bits) < cap) ++c.bits;
  err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(2 + cap) * 4,
                        c.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ids_64) {
    dispatch<long long, kSharded>(c, hot_bases);
  } else {
    dispatch<int, kSharded>(c, hot_bases);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hot: [n_hot, row_bytes] bytes on the card (may be null when n_hot == 0);
// cold: the card's address of [n_rows - n_hot, row_bytes] bytes of mapped
// host memory (may be null when n_hot == n_rows); ids: [n_ids] int32
// (ids_64 == 0) or int64 on the card; out: [n_ids, row_bytes] on the card.
// scratch: 8-byte aligned, on the card, 2 + 2 * cap + 2 * n_ids 32-bit
// words when the table has a cold part (cap: a power of two of at least
// 2 * min(n_ids, cold rows)), else 2 words with cap 0. fetches: one int64
// on the card that receives the number of distinct cold rows read. Cold
// rows and ids are at most 2^31 - 1 each. Enqueues a memset and two
// kernels on `stream` and returns cudaGetLastError() of the launches (0
// when n_ids == 0: nothing enqueued). The caller's current device is left
// as it was.
extern "C" int glt_gather_unified(const void* hot, const void* cold,
                                  const void* ids, int ids_64, void* out,
                                  long long n_hot, long long n_rows,
                                  long long n_ids, long long row_bytes,
                                  void* scratch, long long cap, void* fetches,
                                  int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0 || n_hot < 0 || n_hot > n_rows ||
      (n_hot > 0 && hot == nullptr) ||
      (n_hot < n_rows && cold == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Call c{};
  c.hot = hot;
  c.cold = cold;
  c.ids = ids;
  c.out = out;
  c.n_hot = n_hot;
  c.n_rows = n_rows;
  c.n_ids = n_ids;
  c.row_bytes = row_bytes;
  c.fetches = fetches;
  c.stream = static_cast<cudaStream_t>(stream);
  return run<false>(c, ids_64, reinterpret_cast<uintptr_t>(hot), scratch,
                    cap, device);
}

// The same gather with a row-sharded hot part (a device group's store with
// a host tail): hot rows [s * rows_per_shard, (s + 1) * rows_per_shard) are
// shard s, read through `shards`, a device array (on `device`) of the
// n_shards shards' base addresses, over NVLink for a shard on a peer card
// (peer access enabled before; glt_enable_peer_access in the gather_rows
// library); bases_or is the OR of those addresses. n_hot = n_shards *
// rows_per_shard; the cold rows, the scratch and `fetches` as above. The
// caller's current device is left as it was.
extern "C" int glt_gather_unified_sharded(
    const void* shards, long long n_shards, long long rows_per_shard,
    long long bases_or, const void* cold, const void* ids, int ids_64,
    void* out, long long n_rows, long long n_ids, long long row_bytes,
    void* scratch, long long cap, void* fetches, int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0) return 0;
  const long long n_hot = n_shards * rows_per_shard;
  if (shards == nullptr || n_shards <= 0 || rows_per_shard <= 0 ||
      row_bytes <= 0 || n_hot > n_rows ||
      (n_hot < n_rows && cold == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Call c{};
  c.shards = shards;
  c.rows_per_shard = rows_per_shard;
  c.cold = cold;
  c.ids = ids;
  c.out = out;
  c.n_hot = n_hot;
  c.n_rows = n_rows;
  c.n_ids = n_ids;
  c.row_bytes = row_bytes;
  c.fetches = fetches;
  c.stream = static_cast<cudaStream_t>(stream);
  return run<true>(c, ids_64, static_cast<uintptr_t>(bases_or), scratch, cap,
                   device);
}

// Page-locks [host, host + nbytes) and maps it into the card's address
// space: cudaHostRegisterMapped, plus cudaHostRegisterReadOnly where the
// card reports support for it (*read_only says which). *device_ptr receives
// cudaHostGetDevicePointer's address of `host`, the one kernels must use.
extern "C" int glt_host_register(void* host, long long nbytes, int device,
                                 void** device_ptr, int* read_only) {
  glt::DeviceRestore restore;
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
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaHostUnregister(host));
}

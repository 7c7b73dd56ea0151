// Run-segmented row gather (gather v2): out[i, :] = table[clamp(ids[i]), :],
// one launch on the caller's ids, with runs of consecutive rows found in
// the kernel.
//
// Replaces: graphlearn_tpu/ops/gather_pallas.py `_gather2_kernel_factory`
// (wrappers `_gather_rows_hbm2_impl`, `gather_rows_hbm2`), the TPU kernel
// that sorts the ids, plans them (`plan_gather_runs`) and issues one
// multi-row DMA per full run of consecutive table rows and one single-row
// DMA per other slot. It is the serving tier's embedding lookup
// (`EmbeddingStore.lookup` with kernel routing on) and the routed
// all-device feature lookup.
//
// Bound on the H100: bytes. No arithmetic; the least traffic is the ids
// read once, each distinct row read once and each output row written
// once, over 3.35 TB/s. What cost the time before was not the copy but
// the work around it: a global key+payload sort and some 40 plan
// launches per call, where this card sorts at 4-10x the cost of a
// random gather of the same size and gathers random 512-byte rows at
// 87% of its copy rate (PERF.md, the card's design rules).
//
// Design: no sort and no plan in device memory. Each CTA plans one tile of
// `block_rows` consecutive caller-order slots (at most kMaxTile at once: a
// longer block is cut into kMaxTile tiles from its start, so runs still
// never cross a block). It loads and clamps the tile's ids into shared
// memory, finds each slot's stretch of +1-step ids (warp ballots for the
// last stretch start at or before each lane, the warps' last starts in
// shared memory for stretches that cross warps, one carry across chunks
// of the CTA's width), and splits every stretch into `span`-slot pieces
// from its first slot, as ops/gather.py `plan_runs_in_tiles` does in
// torch: a piece whose span slots all lie in the stretch is one run,
// copied as one contiguous source range to one contiguous destination
// range with the widest vector both pointers and the length allow
// (16/8/4/2/1 bytes, kUnroll vectors in flight per lane); every other
// slot copies its own row, warp per row as in gather_rows.cu, kUnroll rows
// in flight per warp. The slots that copy (run starts and singles) are
// listed first, in slot order, so warps share the copies evenly whatever
// the run pattern. A call with fewer tiles than two per SM (a serving
// batch is one tile) splits each tile's list over several CTAs, each of
// which plans the whole tile from the same ids and so lists the same
// items: the copies of a small batch run on several SMs. Each slot writes
// its own caller-order row: there is no unsort. A repeated id is not
// deduplicated: its row is an L2 hit on this card. TMA bulk copies for
// long runs are left for a tuning pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_restore.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxTile = 4096;     // slots planned at once (8 B each)
constexpr int kUnroll = 4;         // rows (or vectors) in flight per lane
constexpr unsigned kRowMask = (1u << 30) - 1u;
constexpr unsigned kKindSingle = 0u;
constexpr unsigned kKindRun = 1u;
constexpr unsigned kKindCovered = 2u;

template <typename V>
__device__ __forceinline__ void warp_copy(const char* src, char* dst,
                                          long long bytes, int lane) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const long long n = bytes / static_cast<long long>(sizeof(V));
  long long c = lane;
  for (; c + 32 * (kUnroll - 1) < n; c += 32 * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[c + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[c + 32 * u] = v[u];
  }
  for (; c < n; c += 32) d[c] = s[c];
}

// One run piece: a contiguous range, with the widest vector that the two
// pointers and the length allow.
__device__ __forceinline__ void copy_piece(const char* src, char* dst,
                                           long long bytes, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst) |
                      static_cast<uintptr_t>(bytes);
  if (a % 16 == 0) {
    warp_copy<uint4>(src, dst, bytes, lane);
  } else if (a % 8 == 0) {
    warp_copy<uint2>(src, dst, bytes, lane);
  } else if (a % 4 == 0) {
    warp_copy<uint32_t>(src, dst, bytes, lane);
  } else if (a % 2 == 0) {
    warp_copy<uint16_t>(src, dst, bytes, lane);
  } else {
    warp_copy<uint8_t>(src, dst, bytes, lane);
  }
}

// V: the vector of a single-row copy (chosen on the host from the table,
// the output and the row width); I: the id type.
template <typename V, typename I>
__global__ void __launch_bounds__(1024)
gather_runs_kernel(const V* __restrict__ table, const I* __restrict__ ids,
                   V* __restrict__ out, unsigned* __restrict__ plan_out,
                   long long n_rows, long long n_out, int vec_per_row,
                   long long block, int tile, int tiles_per_block, int span,
                   int shares) {
  extern __shared__ unsigned smem[];
  unsigned* rows = smem;           // [tile] clamped row; kind in bits 30-31
  int* first = reinterpret_cast<int*>(smem + tile);  // [tile] stretch start
  __shared__ int warp_last[32];  // per warp: last stretch start, then count
  __shared__ int carry;
  __shared__ int n_items;
  const int share = blockIdx.x % shares;
  const long long tile_id = blockIdx.x / shares;
  const long long blk = tile_id / tiles_per_block;
  const long long t0 =
      blk * block + static_cast<long long>(tile_id % tiles_per_block) * tile;
  long long t1 = t0 + tile;
  if (t1 > blk * block + block) t1 = blk * block + block;
  if (t1 > n_out) t1 = n_out;
  if (t0 >= t1) return;  // the same for every thread of the CTA
  const int len = static_cast<int>(t1 - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;

  // 1. the tile's ids, clamped to [0, n_rows)
  for (int k = tid; k < len; k += nthreads) {
    long long r = static_cast<long long>(ids[t0 + k]);
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    rows[k] = static_cast<unsigned>(r);
  }
  if (tid == 0) {
    carry = 0;  // slot 0 starts a stretch
    n_items = 0;
  }
  __syncthreads();

  // 2. first[k]: the last slot at or before k that starts a stretch (its
  // id is not the previous slot's + 1, or it opens the tile)
  for (int c0 = 0; c0 < len; c0 += nthreads) {
    const int k = c0 + tid;
    const bool starts = k < len && (k == 0 || rows[k] != rows[k - 1] + 1u);
    const unsigned mask = __ballot_sync(0xffffffffu, starts);
    const unsigned upto = mask & (0xffffffffu >> (31 - lane));
    if (lane == 0) {
      warp_last[warp] = mask ? c0 + warp * 32 + 31 - __clz(mask) : -1;
    }
    __syncthreads();
    int f;
    if (upto) {
      f = c0 + warp * 32 + 31 - __clz(upto);
    } else {
      f = carry;
      for (int w = 0; w < warp; ++w) f = max(f, warp_last[w]);
    }
    if (k < len) first[k] = f;
    __syncthreads();
    if (tid == 0) {
      int m = carry;
      for (int w = 0; w < nwarps; ++w) m = max(m, warp_last[w]);
      carry = m;
    }
    __syncthreads();
  }

  // 3. kinds: a stretch splits into span-slot pieces from its first slot;
  // a piece whose last slot is still in the stretch is a run (its start
  // copies it, the rest are covered), any other slot copies alone
  for (int k = tid; k < len; k += nthreads) {
    const int f = first[k];
    const int r = (k - f) % span;
    const long long e = static_cast<long long>(k) - r + span - 1;
    const bool full = e < len && first[e] == f;
    const unsigned kind =
        full ? (r == 0 ? kKindRun : kKindCovered) : kKindSingle;
    rows[k] |= kind << 30;
    if (plan_out != nullptr && share == 0) plan_out[t0 + k] = rows[k];
  }
  __syncthreads();

  // 4. the slots that copy (singles and run starts), listed in slot order
  // in first[] (no longer needed): the same list in every CTA of the tile
  for (int c0 = 0; c0 < len; c0 += nthreads) {
    const int k = c0 + tid;
    const bool copies = k < len && (rows[k] >> 30) != kKindCovered;
    const unsigned mask = __ballot_sync(0xffffffffu, copies);
    if (lane == 0) warp_last[warp] = __popc(mask);
    __syncthreads();
    int base = n_items;
    for (int w = 0; w < warp; ++w) base += warp_last[w];
    if (copies) first[base + __popc(mask & ((1u << lane) - 1u))] = k;
    __syncthreads();
    if (tid == 0) {
      int m = n_items;
      for (int w = 0; w < nwarps; ++w) m += warp_last[w];
      n_items = m;
    }
    __syncthreads();
  }

  // 5. the copies: the tile's CTAs split its items, warp w of all of them
  // taking items w, w + all warps, ..., kUnroll at once
  const long long row_bytes = static_cast<long long>(vec_per_row) * sizeof(V);
  V* out_tile = out + t0 * vec_per_row;
  const int items = n_items;
  const int all = shares * nwarps;
  for (int i0 = share * nwarps + warp; i0 < items; i0 += all * kUnroll) {
    // 32-bit row and slot per item; the addresses are formed at each use
    unsigned row[kUnroll];
    int slot[kUnroll];
    bool single[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * all;
      slot[u] = i < items ? first[i] : 0;
      const unsigned v = rows[slot[u]];
      single[u] = i < items && (v >> 30) == kKindSingle;
      row[u] = v & kRowMask;
    }
    for (int c = lane; c < vec_per_row; c += 32) {
      V val[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (single[u]) {
          val[u] = table[static_cast<long long>(row[u]) * vec_per_row + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (single[u]) {
          out_tile[static_cast<long long>(slot[u]) * vec_per_row + c] = val[u];
        }
      }
    }
    // the run starts of the batch, one piece at a time (read back from
    // shared memory: the piece copy is not unrolled over the batch)
#pragma unroll 1
    for (int i = i0; i < items && i < i0 + kUnroll * all; i += all) {
      const int k = first[i];
      const unsigned v = rows[k];
      if ((v >> 30) != kKindRun) continue;
      const long long src = (v & kRowMask) * row_bytes;
      copy_piece(reinterpret_cast<const char*>(table) + src,
                 reinterpret_cast<char*>(out_tile) + k * row_bytes,
                 span * row_bytes, lane);
    }
  }
}

template <typename V, typename I>
void launch(const void* table, const void* ids, void* out, void* plan_out,
            long long n_rows, long long n_out, long long row_bytes,
            long long block, int tile, int tiles_per_block, long long grid,
            int threads, int span, int shares, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tile) * 2 * sizeof(unsigned);
  gather_runs_kernel<V, I><<<static_cast<unsigned>(grid), threads, smem,
                             stream>>>(
      static_cast<const V*>(table), static_cast<const I*>(ids),
      static_cast<V*>(out), static_cast<unsigned*>(plan_out), n_rows, n_out,
      static_cast<int>(row_bytes / static_cast<long long>(sizeof(V))), block,
      tile,
      tiles_per_block, span, shares);
}

template <typename I>
void dispatch(const void* table, const void* ids, void* out, void* plan_out,
              long long n_rows, long long n_out, long long row_bytes,
              long long block, int tile, int tiles_per_block, long long grid,
              int threads, int span, int shares, cudaStream_t s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0) {
    launch<uint4, I>(table, ids, out, plan_out, n_rows, n_out, row_bytes,
                     block, tile, tiles_per_block, grid, threads, span,
                     shares, s);
  } else if (a % 8 == 0) {
    launch<uint2, I>(table, ids, out, plan_out, n_rows, n_out, row_bytes,
                     block, tile, tiles_per_block, grid, threads, span,
                     shares, s);
  } else if (a % 4 == 0) {
    launch<uint32_t, I>(table, ids, out, plan_out, n_rows, n_out, row_bytes,
                        block, tile, tiles_per_block, grid, threads, span,
                        shares, s);
  } else if (a % 2 == 0) {
    launch<uint16_t, I>(table, ids, out, plan_out, n_rows, n_out, row_bytes,
                        block, tile, tiles_per_block, grid, threads, span,
                        shares, s);
  } else {
    launch<uint8_t, I>(table, ids, out, plan_out, n_rows, n_out, row_bytes,
                       block, tile, tiles_per_block, grid, threads, span,
                       shares, s);
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

}  // namespace

// table: [n_rows, row_bytes] bytes; ids: [n_out] int32 (ids_64 == 0) or
// int64, in caller order; out: [n_out, row_bytes]; plan_out: null, or
// [n_out] uint32 that receives each slot's clamped row with its kind in
// bits 30-31 (0 copies alone, 1 starts a span-row run, 2 is covered by
// one). Runs never cross a multiple of block_rows. Launches on `stream`
// and returns cudaGetLastError() of the launch (0 when n_out == 0:
// nothing launched).
extern "C" int glt_gather_runs(const void* table, const void* ids, int ids_64,
                               void* out, void* plan_out, long long n_rows,
                               long long n_out, long long row_bytes,
                               long long block_rows, int span, int device,
                               void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0 || row_bytes > 0x7fffffffLL ||
      span < 1 || block_rows < 1 ||
      n_rows > static_cast<long long>(kRowMask)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a block at least as long as the ids is one block of n_out slots
  const long long block = block_rows < n_out ? block_rows : n_out;
  const int tile = static_cast<int>(block < kMaxTile ? block : kMaxTile);
  const long long tiles_per_block = (block + tile - 1) / tile;
  const long long tiles = (n_out + block - 1) / block * tiles_per_block;
  // Fewer tiles than two per SM: split each tile's copies over `shares`
  // CTAs (each plans the whole tile), down to 8 warps of kUnroll items.
  long long shares = 1;
  if (tiles < 2LL * sms) {
    shares = (2LL * sms + tiles - 1) / tiles;
    const long long most = (tile + 8 * kUnroll - 1) / (8 * kUnroll);
    if (shares > most) shares = most;
  }
  // one warp per kUnroll slots of a CTA's share, up to 32 warps
  const long long per_cta = (tile + shares - 1) / shares;
  long long warps = (per_cta + kUnroll - 1) / kUnroll;
  if (warps > 32) warps = 32;
  const int threads = static_cast<int>(warps * 32);
  const long long grid = tiles * shares;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_64) {
    dispatch<long long>(table, ids, out, plan_out, n_rows, n_out, row_bytes,
                        block, tile, static_cast<int>(tiles_per_block), grid,
                        threads, span, static_cast<int>(shares), s);
  } else {
    dispatch<int>(table, ids, out, plan_out, n_rows, n_out, row_bytes, block,
                  tile, static_cast<int>(tiles_per_block), grid, threads,
                  span, static_cast<int>(shares), s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Row gather of the probe suite: out[i, :] = table[clamp(ids[i]), :].
//
// Replaces: benchmarks/prof_mem.py `gather_kernel` / `pallas_row_gather`
// (probe G), the TPU probe whose grid has one step per output row, the
// step's table row picked by a scalar-prefetched index through its
// BlockSpec index map: one row DMA in, one row DMA out, per grid step. It is
// a measurement probe: the question it answers on this card is what a
// gather costs when every row moves as one DMA-engine copy, next to the
// port's row-gather kernel (csrc/gather_rows.cu, one warp per row) and
// next to `index_select`.
//
// Bound on the H100: bytes. The kernel does no arithmetic; the least time
// is the ids read once, each distinct row read once and each output row
// written once, over 3.35 TB/s (the probe shape: 153,600 ids over a
// [1M, 128] f32 table, ~152 MB, 0.045 ms).
//
// Design. The Hopper form of the TPU's per-row DMA is a bulk copy
// (cp.async.bulk, the TMA engine without a tensor map): one instruction
// moves a whole row, global -> shared with its completion counted on an
// mbarrier, and shared -> global in a bulk group. What a gather of 512-byte
// rows needs is many rows in flight per SM, because each row is one
// dependent id -> row -> store chain of device-memory latency. So:
// - Persistent CTAs, each owning a contiguous range of output rows. The
//   CTA first stages its ids into shared memory, clamped into [0, N) (the
//   counterpart of the scalar prefetch); the TPU probe leaves an id
//   outside [0, N) undefined, the port clamps it as the row-gather kernel
//   does.
// - Bulk route (row bytes and both base pointers 16-byte aligned): two CTAs
//   of 8 warps per SM; lane 0 of every warp runs its own ring of `stages`
//   row buffers in shared memory (as many as the CTA's half of the SM's
//   shared memory holds: 25 of 512 B, at least 6 of kMaxPiece) with
//   `stages - kLag` row loads in flight: it waits for the oldest load's
//   mbarrier, issues that row's bulk store, and refills the stage of the
//   store issued kLag rows earlier once `wait_group.read` says that store
//   has read it. One thread per warp issues the copies; no thread touches
//   the row's bytes. A row wider than kMaxPiece moves as several copies.
// - Vector route (anything else: 2-, 4- or 8-byte aligned rows): the same
//   persistent CTAs and staged ids; each warp copies kUnroll rows at a
//   time with the widest vector the row width and pointers allow, all
//   kUnroll loads in flight before the stores.
// The wrapper (ops/probes.py) picks the route by shape and counts each.
// Measured on the H100 at the probe shape (PERF.md, section 6): the bulk
// route 0.064-0.067 ms over every ring depth, lag (1 to 16; kLag is
// fixed at 2) and issuer count that kept 16 or more issuing warps per SM
// busy, the vector route 0.064, the
// one-warp-per-row K1 0.065: the three meet at the card's rate for random
// 512-byte rows. The designs this replaced, one CTA per row with a vector
// copy or with one bulk copy each way, took 0.098.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_restore.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kTileIds = 1024;           // ids staged per tile of a CTA
constexpr int kBulkCtasPerSm = 2;        // persistent CTAs of the bulk route
constexpr int kBulkWarps = 8;            // its warps per CTA, lane 0 issuing
constexpr long long kMaxPiece = 2048;    // bytes of one bulk copy
constexpr int kLag = 2;                  // stores in flight at a refill
constexpr long long kSmemPerSm = 233472;     // 228 KB on an H100 SM
constexpr long long kSmemReserved = 1024;    // the system's share per CTA
constexpr long long kMaxSmemPerCta = 232448;  // 227 KB
constexpr int kVecThreads = 256;
constexpr int kVecCtasPerSm = 4;
constexpr int kUnroll = 4;

__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// shared-memory layout of the bulk route: mbarriers, staged rows, ring
__host__ __device__ constexpr long long bars_bytes(int warps, int stages) {
  return round_up(8LL * warps * stages, 16);
}
__host__ __device__ constexpr long long ring_offset(int warps, int stages) {
  return round_up(bars_bytes(warps, stages) + 8LL * kTileIds, 128);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

template <typename I>
__device__ __forceinline__ void stage_rows(long long* rows,
                                           const I* __restrict__ ids,
                                           long long base, int n,
                                           long long n_rows) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    long long r = static_cast<long long>(ids[base + t]);
    rows[t] = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  }
}

template <typename I>
__global__ void row_gather_bulk_kernel(const char* __restrict__ table,
                                       const I* __restrict__ ids,
                                       char* __restrict__ out,
                                       long long n_rows, long long n_ids,
                                       long long row_bytes, long long per_cta,
                                       int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int issuers = blockDim.x >> 5;   // lane 0 of every warp
  const int w = threadIdx.x >> 5;
  const bool issuer = (threadIdx.x & 31) == 0;
  long long* rows =
      reinterpret_cast<long long*>(smem + bars_bytes(issuers, stages));
  const long long piece = row_bytes < kMaxPiece ? row_bytes : kMaxPiece;
  const long long ppr = (row_bytes + piece - 1) / piece;
  const uint32_t bar0 =
      smem_addr(smem) + 8u * static_cast<uint32_t>(w * stages);
  const uint32_t ring0 = smem_addr(smem + ring_offset(issuers, stages)) +
                         static_cast<uint32_t>(w * stages * piece);
  if (issuer) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8u * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const long long lo = static_cast<long long>(blockIdx.x) * per_cta;
  const long long hi = lo + per_cta < n_ids ? lo + per_cta : n_ids;
  long long g = 0;  // this issuer's copies so far: stage g % stages
  for (long long base = lo; base < hi; base += kTileIds) {
    const int n = static_cast<int>(hi - base < kTileIds ? hi - base
                                                         : kTileIds);
    __syncthreads();  // the last tile's rows are read (and the bars made)
    stage_rows(rows, ids, base, n, n_rows);
    __syncthreads();
    if (issuer) {
      const long long mine = w < n ? (n - w + issuers - 1) / issuers : 0;
      const long long m = mine * ppr;  // copies of this tile
      const long long ahead = stages - kLag;
      // copy q of the tile: row t = w + (q / ppr) * issuers, piece q % ppr
      auto piece_of = [&](long long q, long long* t, long long* off) {
        *t = w + (q / ppr) * issuers;
        *off = (q % ppr) * piece;
        return static_cast<uint32_t>(row_bytes - *off < piece
                                         ? row_bytes - *off
                                         : piece);
      };
      auto load = [&](long long q) {
        long long t, off;
        const uint32_t bytes = piece_of(q, &t, &off);
        const uint32_t s = static_cast<uint32_t>((g + q) % stages);
        mbar_expect_tx(bar0 + 8u * s, bytes);
        bulk_load(ring0 + s * static_cast<uint32_t>(piece),
                  table + rows[t] * row_bytes + off, bytes, bar0 + 8u * s);
      };
      for (long long q = 0; q < m && q < ahead; ++q) load(q);
      for (long long q = 0; q < m; ++q) {
        long long t, off;
        const uint32_t bytes = piece_of(q, &t, &off);
        const uint32_t s = static_cast<uint32_t>((g + q) % stages);
        mbar_wait(bar0 + 8u * s,
                  static_cast<uint32_t>(((g + q) / stages) & 1));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_store(out + (base + t) * row_bytes + off,
                   ring0 + s * static_cast<uint32_t>(piece), bytes);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (q + ahead < m) {
          // the refilled stage held copy q - kLag: its store has read it
          asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kLag)
                       : "memory");
          load(q + ahead);
        }
      }
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      g += m;
    }
    __syncwarp();
  }
  if (issuer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename V, typename I>
__global__ void __launch_bounds__(kVecThreads, kVecCtasPerSm)
    row_gather_vector_kernel(const V* __restrict__ table,
                             const I* __restrict__ ids, V* __restrict__ out,
                             long long n_rows, long long n_ids, long long vec,
                             long long per_cta) {
  __shared__ long long rows[kTileIds];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long lo = static_cast<long long>(blockIdx.x) * per_cta;
  const long long hi = lo + per_cta < n_ids ? lo + per_cta : n_ids;
  for (long long base = lo; base < hi; base += kTileIds) {
    const int n = static_cast<int>(hi - base < kTileIds ? hi - base
                                                         : kTileIds);
    __syncthreads();
    stage_rows(rows, ids, base, n, n_rows);
    __syncthreads();
    for (long long t0 = w; t0 < n; t0 += static_cast<long long>(warps) *
                                          kUnroll) {
      const V* src[kUnroll];
      V* dst[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long t = t0 + static_cast<long long>(u) * warps;
        ok[u] = t < n;
        src[u] = table + rows[ok[u] ? t : t0] * vec;
        dst[u] = out + (base + (ok[u] ? t : t0)) * vec;
      }
      for (long long c = lane; c < vec; c += 32) {
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (ok[u]) v[u] = src[u][c];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (ok[u]) dst[u][c] = v[u];
        }
      }
    }
  }
}

std::mutex g_setup_mu;
bool g_ready[kMaxDevices];
int g_sms[kMaxDevices];

// Once per device: the bulk kernel's dynamic shared-memory limit and
// carve-out, and the SM count.
cudaError_t setup(int device, int* sms) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_setup_mu);
  if (!g_ready[device]) {
    const void* kernels[] = {
        reinterpret_cast<const void*>(&row_gather_bulk_kernel<int>),
        reinterpret_cast<const void*>(&row_gather_bulk_kernel<long long>)};
    for (const void* k : kernels) {
      cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kMaxSmemPerCta));
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(k,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
    }
    cudaError_t err = cudaDeviceGetAttribute(
        &g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    g_ready[device] = true;
  }
  *sms = g_sms[device];
  return cudaSuccess;
}

// (grid, rows per CTA) for `ctas` persistent CTAs over n_ids rows
void persistent_grid(long long n_ids, long long ctas, long long* grid,
                     long long* per_cta) {
  *per_cta = (n_ids + ctas - 1) / ctas;
  *grid = (n_ids + *per_cta - 1) / *per_cta;
}

template <typename I>
cudaError_t launch_bulk(const void* table, const void* ids, void* out,
                        long long n_rows, long long n_ids, long long row_bytes,
                        int sms, cudaStream_t stream) {
  const long long piece = row_bytes < kMaxPiece ? row_bytes : kMaxPiece;
  const long long budget = kSmemPerSm / kBulkCtasPerSm - kSmemReserved;
  // stages per warp: what is left after the staged ids and the padding
  const long long stages =
      (budget - 8LL * kTileIds - 256) / (kBulkWarps * (piece + 8));
  if (stages <= kLag) return cudaErrorInvalidValue;
  const long long smem = ring_offset(kBulkWarps, static_cast<int>(stages)) +
                         kBulkWarps * stages * piece;
  if (smem > budget) return cudaErrorInvalidValue;
  long long grid, per_cta;
  persistent_grid(n_ids, static_cast<long long>(sms) * kBulkCtasPerSm, &grid,
                  &per_cta);
  row_gather_bulk_kernel<I>
      <<<static_cast<unsigned>(grid), kBulkWarps * 32,
         static_cast<size_t>(smem), stream>>>(
          static_cast<const char*>(table), static_cast<const I*>(ids),
          static_cast<char*>(out), n_rows, n_ids, row_bytes, per_cta,
          static_cast<int>(stages));
  return cudaGetLastError();
}

template <typename V, typename I>
cudaError_t launch_vector(const void* table, const void* ids, void* out,
                          long long n_rows, long long n_ids,
                          long long row_bytes, int sms, cudaStream_t stream) {
  long long grid, per_cta;
  persistent_grid(n_ids, static_cast<long long>(sms) * kVecCtasPerSm, &grid,
                  &per_cta);
  row_gather_vector_kernel<V, I>
      <<<static_cast<unsigned>(grid), kVecThreads, 0, stream>>>(
          static_cast<const V*>(table), static_cast<const I*>(ids),
          static_cast<V*>(out), n_rows, n_ids,
          row_bytes / static_cast<long long>(sizeof(V)), per_cta);
  return cudaGetLastError();
}

template <typename I>
cudaError_t dispatch(const void* table, const void* ids, void* out,
                     long long n_rows, long long n_ids, long long row_bytes,
                     int bulk, int sms, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (bulk) {
    if (a % 16 != 0) return cudaErrorInvalidValue;
    return launch_bulk<I>(table, ids, out, n_rows, n_ids, row_bytes, sms,
                          stream);
  }
  if (a % 16 == 0) {
    return launch_vector<uint4, I>(table, ids, out, n_rows, n_ids, row_bytes,
                                   sms, stream);
  } else if (a % 8 == 0) {
    return launch_vector<uint2, I>(table, ids, out, n_rows, n_ids, row_bytes,
                                   sms, stream);
  } else if (a % 4 == 0) {
    return launch_vector<uint32_t, I>(table, ids, out, n_rows, n_ids,
                                      row_bytes, sms, stream);
  } else if (a % 2 == 0) {
    return launch_vector<uint16_t, I>(table, ids, out, n_rows, n_ids,
                                      row_bytes, sms, stream);
  }
  return launch_vector<uint8_t, I>(table, ids, out, n_rows, n_ids, row_bytes,
                                   sms, stream);
}

}  // namespace

// table: [n_rows, row_bytes] bytes; ids: [n_ids] int32 (ids_64 == 0) or
// int64; out: [n_ids, row_bytes]. bulk = 1 takes the bulk route (row_bytes
// and both pointers 16-byte aligned, else cudaErrorInvalidValue), bulk = 0
// the vector route. Launches on `stream` and returns the launch's error (0
// when n_ids == 0: nothing launched).
extern "C" int glt_row_gather_probe(const void* table, const void* ids,
                                    int ids_64, void* out, long long n_rows,
                                    long long n_ids, long long row_bytes,
                                    int bulk, int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0) return 0;
  if (n_rows <= 0 || row_bytes <= 0 || n_ids < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = setup(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = ids_64 ? dispatch<long long>(table, ids, out, n_rows, n_ids,
                                     row_bytes, bulk, sms, s)
               : dispatch<int>(table, ids, out, n_rows, n_ids, row_bytes,
                               bulk, sms, s);
  return static_cast<int>(err);
}

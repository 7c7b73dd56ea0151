// Probe: how fast can the card read rows of mapped host memory?
//
// The hot/cold gather (csrc/gather_unified.cu) reads its cold rows from a
// page-locked, mapped host tail over PCIe. This probe times the ways a
// kernel can move the same distinct rows, on the same kind of memory
// (cudaHostRegister, mapped, read-only where the card offers it):
// - copy_engine: cudaMemcpyAsync of as many contiguous bytes (the copy
//   engine's pinned rate, the yardstick a kernel's bound is taken over);
// - warp_rows: one warp per row, 16-byte loads (the gather's own route);
// - warp_slots: the same loads, one warp per slot of a lookup that names
//   each row several times (SLOTS slots in shuffled order, every row at
//   least once, the rest drawn with weights falling as rank^-0.6): the
//   read pattern of a gather that reads a row once per slot naming it;
// - bulk_rows: each row one bulk copy (cp.async.bulk on an mbarrier) into
//   shared memory and one bulk store out, a ring of kStages rows in flight
//   per issuing lane (row_gather_probe.cu's pattern);
// - warp_stream: the same bytes read contiguously with 16-byte loads.
// Every route's output is checked against the host rows byte for byte.
// Each time is the median of `reps` runs between CUDA events.
//
// Usage: uva_read_probe ROWS SLOTS COLD_ROWS ROW_BYTES... (ROW_BYTES
// multiples of 16); prints one JSON object per row width. Built and run by
// graphlearn_tpu_torch/benchmarks/prof_uva.py.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <cmath>
#include <numeric>
#include <random>
#include <vector>

namespace {

constexpr int kStages = 8;      // bulk copies in flight per issuing lane
constexpr int kRowsPerWarp = 16;
constexpr int kBulkWarps = 8;
constexpr int kReps = 10;

void check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    fprintf(stderr, "%s: %s\n", what, cudaGetErrorString(e));
    exit(1);
  }
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

__global__ void warp_rows(const uint4* __restrict__ cold,
                          const int* __restrict__ rows, uint4* __restrict__ out,
                          int n, int vpr) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;
  const uint4* s = cold + static_cast<long long>(rows[w]) * vpr;
  uint4* d = out + w * vpr;
  for (int c = lane; c < vpr; c += 32) d[c] = s[c];
}

// Lane 0 of each warp copies kRowsPerWarp rows, kStages loads in flight.
__global__ void bulk_rows(const char* __restrict__ cold,
                          const int* __restrict__ rows, char* __restrict__ out,
                          int n, int row_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  if ((threadIdx.x & 31) != 0) return;
  const int w = threadIdx.x >> 5;
  const uint32_t bar0 = smem_addr(smem) + 8u * (w * kStages);
  const uint32_t ring0 = smem_addr(smem + 8 * kBulkWarps * kStages) +
                         static_cast<uint32_t>(w * kStages * row_bytes);
  for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8u * s);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long lo =
      (static_cast<long long>(blockIdx.x) * kBulkWarps + w) * kRowsPerWarp;
  const long long m = n - lo < kRowsPerWarp ? n - lo : kRowsPerWarp;
  auto load = [&](long long q) {
    const uint32_t s = static_cast<uint32_t>(q % kStages);
    mbar_expect_tx(bar0 + 8u * s, row_bytes);
    bulk_load(ring0 + s * row_bytes,
              cold + static_cast<long long>(rows[lo + q]) * row_bytes,
              row_bytes, bar0 + 8u * s);
  };
  for (long long q = 0; q < m && q < kStages; ++q) load(q);
  for (long long q = 0; q < m; ++q) {
    const uint32_t s = static_cast<uint32_t>(q % kStages);
    mbar_wait(bar0 + 8u * s, static_cast<uint32_t>((q / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(out + (lo + q) * row_bytes, ring0 + s * row_bytes, row_bytes);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (q + kStages < m) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      load(q + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void warp_stream(const uint4* __restrict__ src,
                            uint4* __restrict__ dst, long long nvec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < nvec; i += stride) {
    dst[i] = src[i];
  }
}

template <typename F>
double median_ms(F launch) {
  cudaEvent_t a, b;
  check(cudaEventCreate(&a), "event");
  check(cudaEventCreate(&b), "event");
  launch();
  check(cudaDeviceSynchronize(), "warm-up");
  std::vector<float> t;
  for (int i = 0; i < kReps; ++i) {
    cudaEventRecord(a);
    launch();
    cudaEventRecord(b);
    check(cudaEventSynchronize(b), "run");
    float ms = 0;
    cudaEventElapsedTime(&ms, a, b);
    t.push_back(ms);
  }
  check(cudaGetLastError(), "launch");
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  std::sort(t.begin(), t.end());
  return t[t.size() / 2];
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 5) {
    fprintf(stderr, "usage: %s ROWS SLOTS COLD_ROWS ROW_BYTES...\n",
            argv[0]);
    return 2;
  }
  const int n = atoi(argv[1]);
  const int n_slots = atoi(argv[2]);
  const long long n_cold = atoll(argv[3]);
  int sms = 0, ro = 0;
  check(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0),
        "attribute");
  check(cudaDeviceGetAttribute(&ro, cudaDevAttrHostRegisterReadOnlySupported,
                               0),
        "attribute");
  std::vector<int> perm(n_cold);
  std::iota(perm.begin(), perm.end(), 0);
  std::shuffle(perm.begin(), perm.end(), std::mt19937(0));
  std::vector<int> rows(perm.begin(), perm.begin() + n);
  std::mt19937 gen(1);
  std::vector<double> weight(n);
  for (int i = 0; i < n; ++i) weight[i] = 1.0 / std::pow(i + 1.0, 0.6);
  std::discrete_distribution<int> pick(weight.begin(), weight.end());
  std::vector<int> slots(rows);
  while (static_cast<int>(slots.size()) < n_slots) {
    slots.push_back(rows[pick(gen)]);
  }
  std::shuffle(slots.begin(), slots.end(), gen);
  int* d_rows = nullptr;
  int* d_slots = nullptr;
  check(cudaMalloc(&d_rows, n * sizeof(int)), "malloc");
  check(cudaMalloc(&d_slots, slots.size() * sizeof(int)), "malloc");
  check(cudaMemcpy(d_rows, rows.data(), n * sizeof(int),
                   cudaMemcpyHostToDevice),
        "copy");
  check(cudaMemcpy(d_slots, slots.data(), slots.size() * sizeof(int),
                   cudaMemcpyHostToDevice),
        "copy");
  for (int arg = 4; arg < argc; ++arg) {
    const int row_bytes = atoi(argv[arg]);
    const size_t bytes = static_cast<size_t>(n_cold) * row_bytes;
    const size_t moved = static_cast<size_t>(n) * row_bytes;
    const size_t pages = (bytes + 4095) / 4096 * 4096;
    char* host = static_cast<char*>(aligned_alloc(4096, pages));
    for (size_t i = 0; i + 4 <= bytes; i += 4) {
      const uint32_t v = static_cast<uint32_t>(i * 2654435761u);
      memcpy(host + i, &v, 4);
    }
    check(cudaHostRegister(host, bytes,
                           cudaHostRegisterMapped |
                               (ro ? cudaHostRegisterReadOnly : 0)),
          "register");
    char* cold = nullptr;
    check(cudaHostGetDevicePointer(reinterpret_cast<void**>(&cold), host, 0),
          "device pointer");
    char* out = nullptr;
    char* slot_out = nullptr;
    check(cudaMalloc(&out, moved), "malloc");
    check(cudaMalloc(&slot_out, slots.size() * row_bytes), "malloc");
    std::vector<char> back(moved);
    auto exact = [&]() {
      check(cudaMemcpy(back.data(), out, moved, cudaMemcpyDeviceToHost),
            "copy back");
      bool ok = true;
      for (int i = 0; i < n && ok; ++i) {
        ok = memcmp(back.data() + static_cast<size_t>(i) * row_bytes,
                    host + static_cast<size_t>(rows[i]) * row_bytes,
                    row_bytes) == 0;
      }
      check(cudaMemset(out, 0, moved), "memset");
      return ok;
    };
    const int vpr = row_bytes / 16;
    const double copy_ms = median_ms([&] {
      cudaMemcpyAsync(out, host, moved, cudaMemcpyHostToDevice);
    });
    check(cudaMemset(out, 0, moved), "memset");
    const double warp_ms = median_ms([&] {
      warp_rows<<<(n * 32 + 255) / 256, 256>>>(
          reinterpret_cast<const uint4*>(cold), d_rows,
          reinterpret_cast<uint4*>(out), n, vpr);
    });
    const bool warp_ok = exact();
    const int ns = static_cast<int>(slots.size());
    const double slots_ms = median_ms([&] {
      warp_rows<<<(ns * 32 + 255) / 256, 256>>>(
          reinterpret_cast<const uint4*>(cold), d_slots,
          reinterpret_cast<uint4*>(slot_out), ns, vpr);
    });
    const size_t smem = 8 * kBulkWarps * kStages +
                        static_cast<size_t>(kBulkWarps) * kStages * row_bytes;
    check(cudaFuncSetAttribute(bulk_rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem)),
          "smem attribute");
    const int bulk_blocks =
        (n + kBulkWarps * kRowsPerWarp - 1) / (kBulkWarps * kRowsPerWarp);
    const double bulk_ms = median_ms([&] {
      bulk_rows<<<bulk_blocks, kBulkWarps * 32, smem>>>(cold, d_rows, out, n,
                                                         row_bytes);
    });
    const bool bulk_ok = exact();
    const double stream_ms = median_ms([&] {
      warp_stream<<<sms * 16, 256>>>(reinterpret_cast<const uint4*>(cold),
                                     reinterpret_cast<uint4*>(out),
                                     static_cast<long long>(moved / 16));
    });
    // 128-byte lines a row touches: its span from the line it starts in
    long long lines = 0;
    for (int i = 0; i < n; ++i) {
      const long long a = static_cast<long long>(rows[i]) * row_bytes;
      lines += (a + row_bytes + 127) / 128 - a / 128;
    }
    printf("{\"row_bytes\": %d, \"rows\": %d, \"slots\": %d, "
           "\"cold_rows\": %lld, \"read_only_mapping\": %d, "
           "\"bytes\": %zu, \"lines\": %lld, \"copy_engine_ms\": %.6f, "
           "\"warp_rows_ms\": %.6f, \"warp_rows_exact\": %s, "
           "\"warp_slots_ms\": %.6f, \"bulk_rows_ms\": %.6f, "
           "\"bulk_rows_exact\": %s, \"warp_stream_ms\": %.6f}\n",
           row_bytes, n, ns, n_cold, ro, moved, lines, copy_ms, warp_ms,
           warp_ok ? "true" : "false", slots_ms, bulk_ms,
           bulk_ok ? "true" : "false", stream_ms);
    fflush(stdout);
    cudaFree(out);
    cudaFree(slot_out);
    cudaHostUnregister(host);
    free(host);
  }
  cudaFree(d_rows);
  cudaFree(d_slots);
  return 0;
}

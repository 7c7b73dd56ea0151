// Take from a table held in on-chip memory: out[j] = take(table, idx[j]),
// in jnp.take's default "fill" mode: an id in [-TN, 0) counts from the
// end (NumPy's negative indexing), any other id outside [0, TN) gives
// INT32_MIN.
//
// Replaces: benchmarks/prof_dedup.py `pk` (probe `pallas_vmem_take`), the
// TPU probe that holds a 65,536-entry int32 table (256 KB) in VMEM and
// takes [S/128, 128] ids from it. On the TPU that probe never lowered; on
// this card it answers what a lookup into a table held on chip costs.
//
// Bound on the H100: bytes (ids and output, 4 B each, plus the table read
// once), about 2 us at S = 786,432. What held the first version back was
// set-up, not lookups: the host set the shared-memory attribute and read
// the SM count on every call, 66 two-CTA clusters each staged a 128 KB
// half with scalar loads (17 MB pulled from the L2 before the first
// lookup), and ids moved 4 bytes a thread; half of the lookups read the
// partner CTA's half through distributed shared memory, one 4-byte
// remote read each, and those reads set the time: with 4- and 8-CTA
// clusters (3/4 and 7/8 of the lookups remote) the take got slower, not
// faster, though it staged 2 and 4 times less.
//
// Design: a thread-block cluster of `cluster` CTAs (2, 4 or 8) holds the
// table, each CTA one part of ceil(TN / cluster) entries (rounded up to 4)
// in its dynamic shared memory. No lookup leaves its own SM: every CTA of
// a cluster reads the cluster's ids and answers only those that fall in
// its part, from its own shared memory; rank 0 also writes the fill of
// ids outside the table. Each id is read `cluster` times, from the L2,
// which costs less here than a remote read per lookup; no lookup reads
// the table from global memory. The CTAs are launched as a cluster so
// that the parts of one table run together and read each tile of ids
// from the L2 at about the same time. One CTA per SM over 132 SMs stages
// 17, 8.4 or 4.2 MB at cluster 2, 4 or 8. A CTA stages its part with
// 16-byte asynchronous copies (cp.async, all of a thread's in flight at
// once; scalar loads where the table is not 16-byte aligned), after
// issuing the load of its first ids, so the two overlap. Ids are read as
// int4 where the ids and the output are 16-byte aligned (the next int4
// loaded while the current one is looked up), with a scalar tail;
// otherwise one id a thread. Outputs are written one id at a time: each
// CTA writes only the ids of its part. The host raises the kernel's shared-memory
// limit and reads the SM count once per device, not on every call.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_restore.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kFill = -2147483647 - 1;  // INT32_MIN
constexpr int kMaxSmem = 232448;        // 227 KB, the most one CTA may hold
constexpr int kMaxDevices = 64;

// out[k] = take(table, i) if this CTA holds it (its part is entries
// [lo, lo + rows)); the fill of an id outside the table is rank 0's.
__device__ __forceinline__ void put(int i, long long k, int tn, int lo,
                                    int rows, unsigned rank, const int* mine,
                                    int* __restrict__ out) {
  if (i < 0) i += tn;
  if (i < 0 || i >= tn) {
    if (rank == 0) out[k] = kFill;
    return;
  }
  const int local = i - lo;
  if (static_cast<unsigned>(local) < static_cast<unsigned>(rows)) {
    out[k] = mine[local];
  }
}

__global__ void __launch_bounds__(kThreads)
smem_take_kernel(const int* __restrict__ table, int tn, int part,
                 int vec_table, const int* __restrict__ idx,
                 int* __restrict__ out, long long n, int vec_ids) {
  extern __shared__ int4 smem4[];
  int* mine = reinterpret_cast<int*>(smem4);
  const cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned size = cluster.num_blocks();
  // the cluster's share of the ids: every CTA of it walks the same ones
  const long long stride =
      static_cast<long long>(gridDim.x / size) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x / size) * blockDim.x + threadIdx.x;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  const long long nv = vec_ids ? n / 4 : n;  // int4s, or single ids
  // the first ids, loaded before the staging so that the two overlap
  long long j = first;
  int4 v = make_int4(0, 0, 0, 0);
  if (j < nv) {
    if (vec_ids) {
      v = idx4[j];
    } else {
      v.x = idx[j];
    }
  }
  // stage this CTA's part: entries [lo, lo + rows), rows <= part
  const int lo = static_cast<int>(rank) * part;
  int rows = tn - lo;
  if (rows > part) rows = part;
  if (rows < 0) rows = 0;
  int staged = 0;
  if (vec_table) {
    // asynchronous 16-byte copies (cp.async): every one of the thread's
    // copies is in flight at once, and none passes through registers
    const int4* src = reinterpret_cast<const int4*>(table + lo);
    for (int q = threadIdx.x; q < rows / 4; q += blockDim.x) {
      __pipeline_memcpy_async(&smem4[q], &src[q], sizeof(int4));
    }
    __pipeline_commit();
    staged = rows / 4 * 4;
  }
  for (int q = staged + threadIdx.x; q < rows; q += blockDim.x) {
    mine[q] = table[lo + q];
  }
  if (vec_table) __pipeline_wait_prior(0);
  __syncthreads();
  if (vec_ids) {
    for (; j < nv; j += stride) {
      int4 next = make_int4(0, 0, 0, 0);
      if (j + stride < nv) next = idx4[j + stride];
      put(v.x, 4 * j, tn, lo, rows, rank, mine, out);
      put(v.y, 4 * j + 1, tn, lo, rows, rank, mine, out);
      put(v.z, 4 * j + 2, tn, lo, rows, rank, mine, out);
      put(v.w, 4 * j + 3, tn, lo, rows, rank, mine, out);
      v = next;
    }
    // the scalar tail: the last n % 4 ids
    const long long t = nv * 4 + first;
    if (t < n) put(idx[t], t, tn, lo, rows, rank, mine, out);
  } else {
    for (; j < nv; j += stride) {
      int next = 0;
      if (j + stride < nv) next = idx[j + stride];
      put(v.x, j, tn, lo, rows, rank, mine, out);
      v.x = next;
    }
  }
}

std::mutex g_setup_mu;
bool g_ready[kMaxDevices];
int g_sms[kMaxDevices];

// Once per device: raise the kernel's dynamic shared memory limit to the
// most any table needs, and read the SM count.
cudaError_t setup(int device, int* sms) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_setup_mu);
  if (!g_ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        smem_take_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&g_sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    g_ready[device] = true;
  }
  *sms = g_sms[device];
  return cudaSuccess;
}

}  // namespace

// table: [tn] int32; idx, out: [n] int32; cluster: 2, 4 or 8 CTAs holding
// the table, one part each. Launches on `stream` and returns the launch's error (0 when
// n == 0: nothing launched).
extern "C" int glt_smem_take(const void* table, long long tn, const void* idx,
                             void* out, long long n, int cluster, int device,
                             void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  if (tn <= 0 || (cluster != 2 && cluster != 4 && cluster != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long part = (tn + cluster - 1) / cluster;
  part = (part + 3) / 4 * 4;
  const long long smem = part * static_cast<long long>(sizeof(int));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = setup(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_table = reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const int vec_ids = (reinterpret_cast<uintptr_t>(idx) |
                       reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // one CTA per SM at most, no more clusters than the ids need (every CTA
  // of a cluster walks the same kThreads ids, or int4s of ids, at a time)
  const long long units = vec_ids ? n / 4 : n;
  long long clusters = sms / cluster;
  const long long need = (units + kThreads - 1) / kThreads;
  if (need < clusters) clusters = need;
  if (clusters < 1) clusters = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, smem_take_kernel,
                           static_cast<const int*>(table),
                           static_cast<int>(tn), static_cast<int>(part),
                           vec_table, static_cast<const int*>(idx),
                           static_cast<int*>(out), n, vec_ids);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

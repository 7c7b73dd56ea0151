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
// once), which at S = 786,432 is a few microseconds: the call is
// launch-bound at this size.
//
// Design: the 256 KB table does not fit the 227 KB of shared memory one
// CTA may hold, so a 2-CTA thread-block cluster holds it: each CTA stages
// one half (128 KB) in its dynamic shared memory, and a lookup into the
// other half reads the partner's shared memory through distributed shared
// memory (cooperative_groups::this_cluster().map_shared_rank). The table
// never goes back to the L2 for a lookup. Clusters stride over the ids;
// the two CTAs of a cluster take alternate 1,024-id tiles of the
// cluster's share. A cluster.sync() after staging makes both halves
// visible, and one before exit keeps a CTA's shared memory alive while
// its partner may still read it. The launch sets the cluster dimension
// with cudaLaunchKernelEx; the C entry point returns the launch error.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCluster = 2;
constexpr int kFill = -2147483647 - 1;  // INT32_MIN

__global__ void smem_take_kernel(const int* __restrict__ table, long long tn,
                                 long long half, const int* __restrict__ idx,
                                 int* __restrict__ out, long long n) {
  extern __shared__ int part[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  // stage this CTA's half: rows [rank * half, min(tn, (rank + 1) * half))
  const long long base = static_cast<long long>(rank) * half;
  const long long rows = tn - base < half ? tn - base : half;
  for (long long j = threadIdx.x; j < rows; j += blockDim.x) {
    part[j] = table[base + j];
  }
  cluster.sync();
  // the partner's half, through distributed shared memory
  const int* other = cluster.map_shared_rank(part, rank ^ 1u);
  const long long clusters = gridDim.x / kCluster;
  const long long cid = blockIdx.x / kCluster;
  const long long stride = clusters * kCluster * kThreads;
  for (long long j = (cid * kCluster + rank) * kThreads + threadIdx.x; j < n;
       j += stride) {
    long long i = idx[j];
    if (i < 0) i += tn;
    int v = kFill;
    if (i >= 0 && i < tn) {
      const bool hi = i >= half;
      const long long local = hi ? i - half : i;
      v = hi == (rank == 1) ? part[local] : other[local];
    }
    out[j] = v;
  }
  cluster.sync();
}

}  // namespace

// table: [tn] int32; idx, out: [n] int32. Launches on `stream` and
// returns the launch's error (0 when n == 0: nothing launched).
extern "C" int glt_smem_take(const void* table, long long tn, const void* idx,
                             void* out, long long n, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  if (tn <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long half = (tn + kCluster - 1) / kCluster;
  const size_t smem = static_cast<size_t>(half) * sizeof(int);
  err = cudaFuncSetAttribute(smem_take_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one CTA per SM (the half-table fills its shared memory), no more
  // clusters than the ids need
  long long clusters = sms / kCluster;
  const long long per_cluster = static_cast<long long>(kCluster) * kThreads;
  const long long need = (n + per_cluster - 1) / per_cluster;
  if (need < clusters) clusters = need;
  if (clusters < 1) clusters = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, smem_take_kernel,
                           static_cast<const int*>(table), tn, half,
                           static_cast<const int*>(idx),
                           static_cast<int*>(out), n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

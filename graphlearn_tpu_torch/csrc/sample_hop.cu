// One uniform CSR hop's adjacency gather: picked[i] = indices[epos[i]].
//
// Replaces: graphlearn_tpu/ops/sample_fused.py `_hop_kernel_factory`
// (wrappers `_gather_epos_pallas`, `sample_hop_fused`). The draw of the
// offsets stays outside the kernel (plain torch, the JAX package's threefry
// stream bit for bit); the kernel only resolves the picks. It runs every hop
// of the tree engine: three launches per batch, the widest at the products
// width being hop 2 with 153,600 seeds x k = 5.
//
// Bound on the H100: bytes. The function reads epos and writes picked once
// (4 B each per pick) and reads each adjacency element it resolves once,
// about 6 MB at hop 2, i.e. a few microseconds at 3.35 TB/s. The picks are
// scattered 4-byte reads, so in practice the kernel is bound by the latency
// of those reads and by how many are in flight.
//
// Design: one thread per pick, over the flat [n_picks] view of epos, so
// every lane of every warp carries a read and the epos loads and picked
// stores are coalesced. The TPU kernel stages each seed's segment in VMEM to
// turn k DMA descriptors into one; on the GPU a scattered 4-byte read costs
// one 32-byte sector either way, and a warp per seed would leave 27 of 32
// lanes idle at k = 5, so nothing is staged. The position is clamped to
// [0, n_edges) (csr_pick.cuh), so no value of epos reads outside indices.
#include <cuda_runtime.h>

#include "csr_pick.cuh"

namespace {

__global__ void sample_hop_kernel(const int* __restrict__ indices,
                                  long long n_edges,
                                  const int* __restrict__ epos,
                                  int* __restrict__ picked,
                                  long long n_picks) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_picks) return;
  picked[i] = csr_pick(indices, n_edges, epos[i]);
}

constexpr int kThreads = 256;

}  // namespace

// indices: [n_edges] int32; epos/picked: [n_picks] int32. Returns
// cudaGetLastError() of the launch (0 when there is nothing to launch).
extern "C" int glt_sample_hop(const void* indices, long long n_edges,
                              const void* epos, void* picked,
                              long long n_picks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_picks == 0) return 0;
  if (n_edges <= 0 || n_picks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n_picks + kThreads - 1) / kThreads;
  sample_hop_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indices), n_edges,
      static_cast<const int*>(epos), static_cast<int*>(picked), n_picks);
  return static_cast<int>(cudaGetLastError());
}

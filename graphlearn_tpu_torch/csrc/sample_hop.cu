// One uniform CSR hop, fused: seed rows, the threefry draw, the pick and
// the mask, in one launch.
//
// Replaces: graphlearn_tpu/ops/sample_fused.py `_hop_kernel_factory`
// (wrappers `_gather_epos_pallas`, `sample_hop_fused`). The TPU program
// reads the seed rows, draws the offsets (`_draw`) and picks
// indices[epos] in the Pallas kernel; here all of it is this kernel, with
// the draw of csr_pick.cuh, bit for bit the JAX package's threefry stream.
// It writes the three outputs of `sample_hop_fused`: nbrs (FILL = -1 where
// masked), safe_epos (0 where masked) and mask. It runs every hop of the
// tree engine: three launches per batch, the widest at the products width
// being hop 2 with 153,600 seeds x k = 5.
//
// Bound on the H100: bytes. The function reads the seeds and their mask,
// each distinct (start, deg) row and each distinct adjacency element it
// resolves once, and writes 9 B per slot: 11.5 MB at hop 2, 3.4 us at
// 3.35 TB/s. The draw is ~110 integer operations per slot of a seed with
// deg > k, held in registers (~1 us of the card's 32-bit rate at hop 2).
// In practice the kernel waits on a chain of dependent loads: seed ->
// (start, deg) row -> indices.
//
// Design: one thread per slot over the flat [B * k] view, so every lane
// carries a load and the output stores are coalesced; the k threads of a
// seed read its row from the same sectors. One thread per seed, with up to
// 8 of its picks as independent loads in flight, was 1.3-2.5x slower at
// hops 0-2 on the H100 (PERF.md, section 6): the slot design has enough
// warps in flight to hide the chain. The TPU kernel stages each seed's
// segment in VMEM to turn k DMA descriptors into one; on the GPU a
// scattered 4-byte read costs one 32-byte sector either way, so nothing is
// staged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_pick.cuh"
#include "device_restore.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void hop_slot_kernel(const int* __restrict__ seeds,
                                const uint8_t* __restrict__ seed_mask,
                                const int* __restrict__ rows, long long n_rows,
                                const int* __restrict__ indices,
                                long long n_edges,
                                const long long* __restrict__ key,
                                long long n_slots, int k,
                                int* __restrict__ nbrs,
                                int* __restrict__ epos_out,
                                uint8_t* __restrict__ mask_out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const long long b = i / k;
  const int j = static_cast<int>(i - b * k);
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const bool seed_ok = seed_mask[b] != 0;
  const glt::CsrRow row = glt::seed_row(seeds, seed_mask, rows, n_rows, b);
  int e;
  const bool valid = glt::draw_slot(k0, k1, i, j, k, seed_ok, row, &e);
  nbrs[i] = valid ? glt::csr_pick(indices, n_edges, e) : -1;
  epos_out[i] = valid ? e : 0;
  mask_out[i] = valid;
}

}  // namespace

// seeds: [n_seeds] int32, or null when `rows` holds one row per seed;
// seed_mask: [n_seeds] bool; rows: [n_rows, 2] int32 (start, deg);
// indices: [n_edges] int32; key: [2] int64 on the device. Outputs nbrs,
// epos: [n_seeds, k] int32; mask: [n_seeds, k] bool. Returns
// cudaGetLastError() of the launch.
extern "C" int glt_sample_hop_fused(const void* seeds, const void* seed_mask,
                                    const void* rows, long long n_rows,
                                    const void* indices, long long n_edges,
                                    const void* key, long long n_seeds, int k,
                                    void* nbrs, void* epos, void* mask,
                                    int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_seeds == 0 || k == 0) return 0;
  if (n_seeds < 0 || k < 0 || n_rows <= 0 || n_edges < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_slots = n_seeds * k;
  const long long blocks = (n_slots + kThreads - 1) / kThreads;
  hop_slot_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seeds), static_cast<const uint8_t*>(seed_mask),
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(indices),
      n_edges, static_cast<const long long*>(key), n_slots, k,
      static_cast<int*>(nbrs), static_cast<int*>(epos),
      static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

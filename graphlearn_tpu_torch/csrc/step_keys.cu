// The hop keys of a chunk of training steps, derived on the device.
//
// Replaces: graphlearn_tpu/loader/scan_epoch.py `scan_epoch_chunk`, lines
// 249-254 (`counts_k = count0 + start + lax.iota(int32, k)` and, per scanned
// step, `key = jax.random.fold_in(base_key, count)`, which the sampler then
// splits into one key per hop). In the JAX program the counts are traced
// device values; this kernel is their counterpart for a captured CUDA graph:
// it reads the base key and the chunk's first count through pointers, so a
// replay with new counts in the same buffers draws new keys, and nothing is
// frozen into the graph by value.
//
// For step j < K and hop h < n_hops it writes out[j, h] = split(fold_in(
// base_key, c + j), n_hops)[h]: fold_in is threefry2x32(base_key, (0,
// (c + j) mod 2**32)), the mod being the wrap of JAX's int32 count, and split
// is threefry2x32(folded, (0, h)), the partitionable counter layout of
// jax.random (h < 2**32, so its high word is 0). Words are stored as int64
// values in [0, 2**32), as the port's keys are. random.step_keys_plain is
// the same function in torch ops.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): both bounds are far
// below a launch. The call reads 24 bytes and writes 16 per key; a key's
// thread runs 184 instructions (two threefry blocks; cuobjdump -sass of
// this file, sm_90a): 91 that only the ALU pipe runs, 47 adds and moves
// either pipe runs, 19 3-input adds and 8 multiplies. At K = 8 and 3 hops:
// 408 bytes (0.12 ns at 3.35 TB/s) and 1.53 SM clocks a key on the ALU
// pipe with the 3-input adds on IMAD (0.14 ns at 64 a clock per SM over
// 132 SMs at 1,980 MHz): operations, by a little. What it costs is one
// launch; what it removes is the host's fold_in, split and key upload of
// every step.
//
// The distributed chunk (graphlearn_tpu/loader/scan_epoch.py, lines
// 692-706 of DistScanTrainer's chunk) draws per scanned step and shard
// keys = split(fold_in(base_key, count), P)[shard], and the shard's hop
// loop splits that key once per hop (distributed/dist_neighbor_sampler.py
// _homo_hop_loop). glt_dist_step_keys writes the whole chunk's keys at
// once: out[j, p, h] = split(split(fold_in(base_key, c + j), P)[p],
// n_hops)[h], three threefry blocks per key. At K = 4, P = 4 and 3 hops
// that is 48 keys: 1,152 bytes and 48 threads of 286 instructions (141
// on the ALU pipe alone and 28 3-input adds: 0.44 ns), again one launch.
//
// Design: one thread per (step, hop) key, or per (step, shard, hop) key,
// 128 threads a block: one block for any chunk of at most 128 keys.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_pick.cuh"
#include "device_restore.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void step_keys_kernel(const long long* __restrict__ base_key,
                                 const long long* __restrict__ counter,
                                 int n_steps, int n_hops,
                                 long long* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_steps * n_hops) return;
  const int j = i / n_hops;
  const int h = i - j * n_hops;
  uint32_t x0 = 0;
  uint32_t x1 = static_cast<uint32_t>(
      static_cast<unsigned long long>(counter[0]) +
      static_cast<unsigned long long>(j));
  glt::threefry2x32(static_cast<uint32_t>(base_key[0]),
                    static_cast<uint32_t>(base_key[1]), x0, x1);
  uint32_t y0 = 0;
  uint32_t y1 = static_cast<uint32_t>(h);
  glt::threefry2x32(x0, x1, y0, y1);
  out[2 * i] = static_cast<long long>(y0);
  out[2 * i + 1] = static_cast<long long>(y1);
}

__global__ void dist_step_keys_kernel(const long long* __restrict__ base_key,
                                      const long long* __restrict__ counter,
                                      int n_steps, int n_parts, int n_hops,
                                      long long* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_steps * n_parts * n_hops) return;
  const int j = i / (n_parts * n_hops);
  const int r = i - j * (n_parts * n_hops);
  const int p = r / n_hops;
  const int h = r - p * n_hops;
  uint32_t x0 = 0;
  uint32_t x1 = static_cast<uint32_t>(
      static_cast<unsigned long long>(counter[0]) +
      static_cast<unsigned long long>(j));
  glt::threefry2x32(static_cast<uint32_t>(base_key[0]),
                    static_cast<uint32_t>(base_key[1]), x0, x1);
  uint32_t s0 = 0;
  uint32_t s1 = static_cast<uint32_t>(p);
  glt::threefry2x32(x0, x1, s0, s1);
  uint32_t y0 = 0;
  uint32_t y1 = static_cast<uint32_t>(h);
  glt::threefry2x32(s0, s1, y0, y1);
  out[2 * i] = static_cast<long long>(y0);
  out[2 * i + 1] = static_cast<long long>(y1);
}

}  // namespace

// base_key: [2] int64 words; counter: [1] int64, the count of step 0; out:
// [n_steps, n_hops, 2] int64. Launches on `stream` and returns
// cudaGetLastError() of the launch (0 when there is no key to write).
extern "C" int glt_step_keys(const void* base_key, const void* counter,
                             int n_steps, int n_hops, void* out, int device,
                             void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_steps < 0 || n_hops < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(n_steps) * n_hops;
  if (n == 0) return 0;
  if (n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  step_keys_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(base_key),
      static_cast<const long long*>(counter), n_steps, n_hops,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The distributed chunk's keys. base_key: [2] int64 words; counter: [1]
// int64, the count of step 0; out: [n_steps, n_parts, n_hops, 2] int64.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 when
// there is no key to write).
extern "C" int glt_dist_step_keys(const void* base_key, const void* counter,
                                  int n_steps, int n_parts, int n_hops,
                                  void* out, int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_steps < 0 || n_parts < 0 || n_hops < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(n_steps) * n_parts * n_hops;
  if (n == 0) return 0;
  if (n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  dist_step_keys_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(base_key),
      static_cast<const long long*>(counter), n_steps, n_parts, n_hops,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

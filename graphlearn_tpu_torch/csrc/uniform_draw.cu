// jax.random.uniform(key, shape) as float32, bit for bit, in one launch.
//
// Replaces: the XLA draws of the sampling backends that have no Pallas
// kernel, `jax.random.uniform` at graphlearn_tpu/ops/neighbor.py:102
// (weighted_sample), :282 (uniform_sample_padded), :343 and :357
// (uniform_sample_block, one draw from each half of a split key) and :251
// (build_padded_adjacency_device, one word per edge). In the JAX program
// XLA fuses the threefry into the consumer; in torch the plain draw
// (random.uniform) is ~190 int64 ops per call, which at a hop's width
// costs the card a millisecond of launches and passes.
//
// For the flat index i < n it writes u[i] = float((bits >> 9) | 0x3F800000)
// - 1, bits = y0 ^ y1, (y0, y1) = threefry2x32(key, (hi(i), lo(i))): the
// partitionable counter layout of jax.random (random.random_bits), with
// threefry2x32 and the rounding of csr_pick.cuh (no fast math). The key is
// read from device memory (a [2] int64 tensor of uint32 words), so a
// captured CUDA graph draws from whatever key the buffer holds at replay.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W), counted from this
// file's SASS (cuobjdump -sass, sm_90a): a word's loop iteration is 78
// instructions. 46 run on the ALU pipe alone (threefry's 20 SHF and 21
// LOP3, compares, address highs), 19 are 2-input adds or moves either
// pipe runs (ptxas puts 17 on IMAD), and 10 are 3-input IADD3s, one ALU
// instruction or two IMADs each. The ALU and FMA pipes take 64 a clock
// per SM and the schedulers issue 128: with the 3-input adds on IMAD, the
// ALU-only instructions bound it at 0.719 SM clocks a word, 2.75 ps over
// 132 SMs at the 1,980 MHz SM clock, against 4 bytes written (1.19 ps at
// 3.35 TB/s). It is not the float32 rate (67 T/s counts an FMA twice; an
// integer add, xor or shift is one instruction). A hop's width is far
// below a launch (768,000 words at hop 2 of a products batch: 2.1 us);
// the table build's 25M words take at least 69 us.
//
// Design: one thread per word, 256 threads a block, a grid-stride loop
// over at most 132 * 16 blocks, so a warp's stores are one coalesced
// 128-byte line.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_pick.cuh"
#include "device_restore.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__global__ void uniform_draw_kernel(const long long* __restrict__ key,
                                    long long n, float* __restrict__ out) {
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(i) >>
                                        32);
    uint32_t x1 = static_cast<uint32_t>(i);
    glt::threefry2x32(k0, k1, x0, x1);
    out[i] = __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
  }
}

}  // namespace

// key: [2] int64 words on the device; out: [n] float32. Launches on
// `stream` and returns cudaGetLastError() of the launch (0 when n == 0).
extern "C" int glt_uniform_draw(const void* key, long long n, void* out,
                                int device, void* stream) {
  glt::DeviceRestore restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  uniform_draw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

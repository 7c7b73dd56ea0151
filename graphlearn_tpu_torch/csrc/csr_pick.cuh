// The per-slot arithmetic of one uniform CSR hop: the seed's row, the
// threefry draw of the slot's offset, and the pick.
//
// Shared by the hop kernel (sample_hop.cu) and the pick phase of the level
// kernel (sample_level.cu). The key is read from device memory (a [2] int64
// tensor of uint32 words), never passed by value, so a captured launch does
// not freeze one key.
//
// The draw (tests/test_torch_draw.py holds a numpy copy of these steps):
//   slot (b, j) of a [B, k] hop takes the flat counter i = b * k + j as the
//   two words (hi, lo) = (i >> 32, i & 0xFFFFFFFF), the partitionable layout
//   of jax.random; (y0, y1) = threefry2x32(key, (hi, lo)), 20 rounds, and
//   bits = y0 ^ y1; u = float_from_bits((bits >> 9) | 0x3F800000) - 1.0f;
//   rand_off = floor(u * float(deg)), clamped to deg - 1; the offset is
//   rand_off when deg > k and j otherwise; the slot is valid when its seed
//   is and offset < deg, and its edge position is start + offset.
//   float(deg) rounds to nearest even (__int2float_rn), and so do the
//   product (__fmul_rn) and the subtraction (__fsub_rn): no fast math.
//
// Only slots of seeds with deg > k run threefry; the others take j.
#pragma once

#include <stdint.h>

namespace glt {

struct CsrRow {
  int start;
  int deg;
};

// Row of seed b in the [n_rows, 2] (start, deg) table: masked seeds read
// row 0, as the JAX hop does; with seeds == nullptr the table holds one row
// per seed. Row ids are clamped into the table.
__device__ __forceinline__ CsrRow seed_row(const int* __restrict__ seeds,
                                           const uint8_t* __restrict__ mask,
                                           const int* __restrict__ rows,
                                           long long n_rows, long long b) {
  long long r = b;
  if (seeds != nullptr) {
    r = mask[b] ? seeds[b] : 0;
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  }
  return CsrRow{rows[2 * r], rows[2 * r + 1]};
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Rotation r of round group g (jax's _threefry2x32_lowering schedule).
__device__ __forceinline__ int threefry_rot(int g, int r) {
  return (g & 1) ? (r == 0 ? 17 : r == 1 ? 29 : r == 2 ? 16 : 24)
                 : (r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : 6);
}

// threefry2x32 with 20 rounds of the count words (x0, x1) under (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, threefry_rot(g, r));
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
}

// floor(u * float(deg)) clamped to max(deg - 1, 0), u from the slot's bits.
__device__ __forceinline__ int uniform_offset(uint32_t bits, int deg) {
  const float u =
      __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const int off = static_cast<int>(floorf(__fmul_rn(u, __int2float_rn(deg))));
  const int top = deg > 1 ? deg - 1 : 0;
  return off < top ? off : top;
}

// The edge position of slot (i = b * k + j); returns its validity.
__device__ __forceinline__ bool draw_slot(uint32_t k0, uint32_t k1,
                                          long long i, int j, int k,
                                          bool seed_ok, CsrRow row,
                                          int* epos) {
  if (!seed_ok) {
    *epos = 0;
    return false;
  }
  int off = j;
  if (row.deg > k) {
    uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(i) >>
                                        32);
    uint32_t x1 = static_cast<uint32_t>(i);
    threefry2x32(k0, k1, x0, x1);
    off = uniform_offset(x0 ^ x1, row.deg);
  }
  *epos = row.start + off;
  return off < row.deg;
}

// indices[clamp(p, 0, n_edges - 1)]; n_edges > 0.
__device__ __forceinline__ int csr_pick(const int* __restrict__ indices,
                                        long long n_edges, long long p) {
  p = p < 0 ? 0 : (p >= n_edges ? n_edges - 1 : p);
  return indices[p];
}

}  // namespace glt

// One pick of a CSR hop: indices[clamp(p, 0, n_edges - 1)].
//
// Shared by the hop kernel (sample_hop.cu) and the gather phase of the
// level kernel (sample_level.cu): one thread per pick, the position
// clamped so that no value of epos reads outside indices. n_edges > 0.
#pragma once

__device__ __forceinline__ int csr_pick(const int* __restrict__ indices,
                                        long long n_edges, long long p) {
  p = p < 0 ? 0 : (p >= n_edges ? n_edges - 1 : p);
  return indices[p];
}

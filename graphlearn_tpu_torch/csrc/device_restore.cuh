// The guard every C entry declares before it sets the card it launches on
// or configures (cudaSetDevice): it restores the calling thread's current
// device when the entry returns. PyTorch's unindexed 'cuda' device is the
// thread's current one, so an entry that switched cards and left them
// switched would make the caller's next 'cuda' tensor on the entry's card
// (a fault that only shows with two cards or more). The cost is one
// cudaGetDevice / cudaSetDevice pair on the host; the card waits for
// nothing. tests/test_torch_csrc_entries.py checks every entry declares it
// before its first cudaSetDevice.
#pragma once

#include <cuda_runtime.h>

namespace glt {

struct DeviceRestore {
  int prev = -1;
  DeviceRestore() {
    if (cudaGetDevice(&prev) != cudaSuccess) prev = -1;
  }
  ~DeviceRestore() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceRestore(const DeviceRestore&) = delete;
  DeviceRestore& operator=(const DeviceRestore&) = delete;
};

}  // namespace glt

// What the GF kernel sources share: the alignment test that picks a
// row's widest load, and the launcher's device handling.  Each source
// tiles its own rows and masks; neither bounds K.
// Each source that includes it builds into its own library
// (kernels/build.py hashes this header with it).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gf {

// Largest of 16, 8, 4 and 1 that divides both a row's address and its
// stride: the widest load every row of the matrix can take.
inline int row_alignment(const void* p, long long ld) {
  const auto a = reinterpret_cast<uintptr_t>(p);
  for (int w = 16; w > 1; w /= 2) {
    if (w != 2 && a % w == 0 && ld % w == 0) return w;
  }
  return 1;
}

// Run `launch` (which launches on the current device) on `device`,
// then give the calling thread back its own device.  Returns
// cudaGetLastError() after the launch: a refused launch never runs,
// and a later synchronize would not report it.
template <typename F>
int on_device(int device, F&& launch) {
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err == cudaSuccess && caller != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch();
  err = cudaGetLastError();
  if (caller != device) {
    const cudaError_t back = cudaSetDevice(caller);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace gf

// The launchers' device check (step_kernel.cu, rebin.cu,
// rebin_incremental.cu, pairwise.cu).
//
// A launch goes to the current device, on the stream handle it is given
// (the legacy default stream 0 is the current device's).  With tiles on
// several cards (parallel/tile2d.py) a tensor may live on another card than
// the current one; its kernels would then run on the current card, through
// pointers into the other's memory.  The Python wrappers make the tensor's
// card current around each launch (``with torch.cuda.device(...)``); every
// launcher first asks the CUDA runtime where its grid's memory lies and refuses
// the launch unless that is the current device.
#pragma once

#include <cuda_runtime.h>

// Returned by a launcher whose grid does not lie in the current device's
// memory (ops/kernels/_build.py::check_launch names it).
#define PEDONI_WRONG_DEVICE (-2)

// 0 if p points into the current device's memory, else PEDONI_WRONG_DEVICE.
inline int pedoni_on_current_device(const void* p) {
  cudaPointerAttributes a;
  int cur = -1;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it so the next launch reads its own
    return PEDONI_WRONG_DEVICE;
  }
  if (cudaGetDevice(&cur) != cudaSuccess) return PEDONI_WRONG_DEVICE;
  return a.type == cudaMemoryTypeDevice && a.device == cur ? 0
                                                           : PEDONI_WRONG_DEVICE;
}

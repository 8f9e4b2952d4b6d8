// What every kernel library of video_gcp_torch/csrc shares: the card's
// limits and the per-device opt-in to more than 48 KiB of dynamic shared
// memory. The Python side of the seam is video_gcp_torch/ops/cuda_build.py,
// whose SMEM_LIMIT is kSmemLimit; it keys every library on this header too.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use (H100)
constexpr int kMaxDevices = 64;  // cards one process can launch on

// Lets kKernel launch with `smem` bytes of dynamic shared memory on the
// current device. The attribute is the device's: one cache per kernel and
// device, so cudaFuncSetAttribute runs only when a launch needs more than the
// last one allowed. Returns the CUDA error code (0 on success).
template <auto kKernel>
int allow_smem(int smem) {
  static int allowed[kMaxDevices] = {};  // 0: the default 48 KiB
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > (allowed[dev] ? allowed[dev] : 48 * 1024)) {
    e = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = smem;
  }
  return 0;
}

}  // namespace

// Shared pieces of the ViT block kernels: the tile constants, shared-memory
// limit and activations that the int8 GELU-MLP kernel (#9, `vit_int8.cu`)
// still uses, and what the tiled pieces of all the other ViT kernels
// (`vit_tiles.cuh`) share with it (head_dim, the LayerNorm epsilon, the
// activations, warp sums, the dynamic shared-memory opt-in). The design notes
// are at the top of `vit_fused.cu` and `vit_int8.cu`.
#pragma once

#include "flash_common.cuh"

namespace paths_cuda {
namespace vit {

constexpr int kThreads = 256;   // #9: threads of a block
constexpr int kBM = 16;         // #9: activation rows a block multiplies at a time
constexpr int kBK = 32;         // #9: contraction depth of one staged chunk
constexpr int kHC = 256;        // #9: hidden columns per MLP chunk
constexpr int kHD = 64;         // head_dim
constexpr float kLnEps = 1e-6f;
constexpr size_t kMaxSmem = 232448;   // 227 KB: most a block may ask for

// Shared-memory regions start on 128-byte boundaries.
__host__ __device__ constexpr size_t align_up(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

enum Act { kGeluExact = 0, kGeluTanh = 1, kSwiglu = 2 };

template <int ACT>
__device__ __forceinline__ float gelu(float h) {
  if (ACT == kGeluExact)
    return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  const float u = 0.7978845608028654f * (h + 0.044715f * h * h * h);
  return 0.5f * h * (1.f + tanhf(u));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace vit
}  // namespace paths_cuda

// Shared pieces of the masked flash-attention kernels (forward and backward):
// the masking constants of the TPU kernels and 16-byte row moves between
// global memory (f32 or bf16) and f32 registers or shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paths_cuda {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows move in 16-byte pieces: 4 f32 or 8 bf16 values each.
template <typename T>
struct Piece {
  static constexpr int kLen = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kLen; ++i) dst[i] = to_float(e[i]);
  }
  __device__ __forceinline__ static void store(const float* src, T* dst) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < kLen; ++i) e[i] = from_float<T>(src[i]);
    *reinterpret_cast<uint4*>(dst) = raw;
  }
};

}  // namespace paths_cuda

// Masked flash-attention forward for Hopper (sm_90a), f32 or bf16.
//
// Replaces the TPU kernel `paths_tpu/kernels/flash_attention.py::_flash_forward`
// (body `_flash_kernel`): out = softmax(q k^T / sqrt(d), keys k < lengths[b]) v
// and the per-row log-sum-exp, for q (B, H, Nq, D), k/v (B, H, Nk, D), all
// contiguous and of one type (f32 or bf16; the math runs in f32), D 32 or
// 64; Nq and Nk may differ.
//
// Design. The TPU kernel walks key blocks on the innermost, sequential grid
// axis and carries the online-softmax state in VMEM scratch. Blocks of a CUDA
// grid run in no order, so here one block owns (b, h, a tile of BLOCK_Q query
// rows) and loops over the keys itself: each step stages BLOCK_K rows of K and
// V in shared memory, and each thread keeps one query row, its running max,
// sum and accumulator in registers. The loop stops at lengths[b], so masked
// key tiles are never read. Every thread reads the same shared-memory word at
// a time (a broadcast), so there are no bank conflicts.
//
// Bound on the card: at the serving shapes (D = 32, N <= 257) the work is
// about N / 4 operations per byte moved, so the f32 rate of the CUDA cores
// (TF32 tensor cores are off for parity) bounds it rather than memory. This
// first version runs on the CUDA cores with one thread per query row; tensor
// cores (wgmma), TMA and pipelining are later work.
//
// Masking semantics match the TPU kernel exactly: NEG_INF = -1e30 for masked
// scores, l floored at 1e-30, query rows at or past the length still produce
// outputs normalised over the valid keys.
//
// C interface (loaded through ctypes): every entry returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr int kBlockQ = 64;  // query rows per block = threads per block
constexpr int kBlockK = 32;  // keys staged in shared memory per step

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

// q/k/v/out in T (f32 or bf16); scores, softmax state and accumulators in
// f32; K/V tiles are converted to f32 as they are staged.
template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Nq,
                 int Nk, float sm_scale) {
  using P = Piece<T>;
  static_assert(D % P::kLen == 0, "rows move in 16-byte pieces");
  constexpr int kPieces = D / P::kLen;
  __shared__ __align__(16) float k_s[kBlockK][D];
  __shared__ __align__(16) float v_s[kBlockK][D];

  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < Nq;
  const T* kb = k + bh * Nk * D;
  const T* vb = v + bh * Nk * D;
  const int len = max(0, min(lengths[b], Nk));

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (active) {
    const T* src = q + (bh * Nq + row) * D;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) P::load(src + i * P::kLen, qr + i * P::kLen);
  }
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    const int rows = min(kBlockK, len - k0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < kBlockK * kPieces; i += kBlockQ) {
      const int r = i / kPieces;
      const int c = (i % kPieces) * P::kLen;
      if (r < rows) {
        const size_t off = static_cast<size_t>(k0 + r) * D + c;
        P::load(kb + off, &k_s[r][c]);
        P::load(vb + off, &v_s[r][c]);
      } else {
#pragma unroll
        for (int j = 0; j < P::kLen; ++j) k_s[r][c + j] = v_s[r][c + j] = 0.f;
      }
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], k_s[j][d], dot);
      s[j] = j < rows ? dot * sm_scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);
      p_sum += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_s[j][d], acc[d]);
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (active) {
    const float l_safe = fmaxf(l, kLFloor);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] /= l_safe;
    T* dst = out + (bh * Nq + row) * D;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) P::store(acc + i * P::kLen, dst + i * P::kLen);
    lse[bh * Nq + row] = m + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* lse, int B, int H, int Nq, int Nk,
           float sm_scale, cudaStream_t stream) {
  const dim3 grid((Nq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), lse, H, Nq, Nk,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(const void* q, const void* k, const void* v,
                      const int* lengths, void* out, float* lse, int B, int H,
                      int Nq, int Nk, int D, float sm_scale,
                      cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, lse, B, H, Nq, Nk, sm_scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, lse, B, H, Nq, Nk, sm_scale,
                           stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out share it; lse is f32).
extern "C" int paths_flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, float* lse, int B, int H, int Nq, int Nk, int D, int dtype,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<float>(q, k, v, lengths, out, lse, B, H, Nq, Nk,
                                      D, sm_scale, s);
    case 1:
      return dispatch_head_dim<__nv_bfloat16>(q, k, v, lengths, out, lse, B, H,
                                              Nq, Nk, D, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paths_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared pieces of the ViT block kernels: the int8 block kernels'
// (`vit_int8.cu`) tile constants and per-(image, head) attention core, and
// what the tiled pieces of the fused kernels (`vit_tiles.cuh`) share with
// them (head_dim, the LayerNorm epsilon, the activations, warp sums). The
// design notes are at the top of `vit_fused.cu` and `vit_int8.cu`.
#pragma once

#include "flash_common.cuh"

namespace paths_cuda {
namespace vit {

constexpr int kThreads = 256;
constexpr int kBM = 16;         // activation rows a block multiplies at a time
constexpr int kBK = 32;         // contraction depth of one staged chunk
constexpr int kHC = 256;        // hidden columns per MLP chunk
constexpr int kHD = 64;         // head_dim
constexpr int kLDQ = kHD + 4;   // row stride of the q tile (f32)
constexpr float kLnEps = 1e-6f;
constexpr size_t kMaxSmem = 232448;   // 227 KB: most a block may ask for

// Shared-memory regions start on 128-byte boundaries.
__host__ __device__ constexpr size_t align_up(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Row stride (in elements of T) of K/V rows in shared memory: one 16-byte
// piece of padding keeps 16-byte reads of neighbouring rows on different
// banks.
template <typename T>
constexpr int kLDK = kHD + Piece<T>::kLen;

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

// ---------------------------------------------------- attention, per head
// Elements of T that one head's K and V take for N tokens.
template <typename T>
__host__ __device__ inline size_t attn_kv_elems(int N) {
  return 2 * ((static_cast<size_t>(N) + 3) / 4 * 4) * kLDK<T>;
}

// Shared memory of the attention core itself for N tokens, with K and V in
// it or in device memory.
template <typename T>
__host__ __device__ inline size_t attn_core_bytes(int N, bool kv_in_smem) {
  const size_t np = (static_cast<size_t>(N) + 3) / 4 * 4;
  return align_up((kBM * (np + 4) + kBM * kLDQ + kBM) * sizeof(float) +
                  (kv_in_smem ? attn_kv_elems<T>(N) * sizeof(T) : 0));
}

// cb[:, h 64 : (h + 1) 64] = softmax(q k^T / 8) v of head h of one image,
// with q, k, v from `qkv` rounded to T. One block: K and V of every token go
// to shared memory or, with KV_DEVICE, to `kv_dev` (`attn_kv_elems<T>(N)`
// elements of device memory of this block's own, read back through the
// caches), then the queries are walked 16 rows at a time against all keys:
// the scores of 16 rows stay in shared memory, so the softmax takes the
// row's final max. P is rounded to T, the context is divided by the row sum
// of the unrounded P afterwards and then stored as CT. `smem` holds
// `attn_core_bytes<T>(N, !KV_DEVICE)`. Ends with a barrier.
template <typename T, typename CT, bool KV_DEVICE, typename Qkv>
__device__ __forceinline__ void attn_head(Qkv& qkv, CT* cb, int h, int N, int D,
                                          unsigned char* smem, T* kv_dev) {
  constexpr int LDK = kLDK<T>;
  constexpr int PL = Piece<T>::kLen;
  const int Np = (N + 3) / 4 * 4;
  const int LDS = Np + 4;
  float* S = reinterpret_cast<float*>(smem);       // kBM x LDS
  float* Qs = S + kBM * LDS;                       // kBM x kLDQ
  float* l_s = Qs + kBM * kLDQ;
  T* Ks;                                           // Np x LDK
  if constexpr (KV_DEVICE)
    Ks = kv_dev;
  else
    Ks = reinterpret_cast<T*>(l_s + kBM);
  T* Vs = Ks + Np * LDK;                           // Np x LDK
  const int t = threadIdx.x;

  // rows N .. Np - 1 of K and V are read by the P V loop against p = 0
  for (int i = t; i < (Np - N) * kHD; i += kThreads) {
    const int at = (N + i / kHD) * LDK + i % kHD;
    Ks[at] = from_float<T>(0.f);
    Vs[at] = from_float<T>(0.f);
  }

  // K and V of every token
  for (int r0 = 0; r0 < N; r0 += kBM) {
    qkv.prepare(r0);
    float kv[kBM / 2];
    qkv.template product<128>(kv, [&](int n) {
      return (1 + n / kHD) * D + h * kHD + n % kHD;
    });
    const int c = t % 128, g = t / 128;
    T* dst = c < kHD ? Ks : Vs;
#pragma unroll
    for (int r = 0; r < kBM / 2; ++r) {
      const int row = r0 + g * (kBM / 2) + r;
      if (row < N) dst[row * LDK + c % kHD] = from_float<T>(kv[r]);
    }
  }

  // queries, 16 rows at a time
  for (int r0 = 0; r0 < N; r0 += kBM) {
    qkv.prepare(r0);
    const int c = t % kHD, g = t / kHD;
    {
      float qa[kBM / 4];
      qkv.template product<kHD>(qa, [&](int n) { return h * kHD + n; });
#pragma unroll
      for (int r = 0; r < kBM / 4; ++r)
        Qs[(g * (kBM / 4) + r) * kLDQ + c] = round_to<T>(qa[r]);
    }
    __syncthreads();   // q tile, and (first tile) all of K and V, are complete

    // scores: each thread owns keys t, t + 256, ... for all 16 query rows
    for (int j = t; j < N; j += kThreads) {
      float s[kBM];
#pragma unroll
      for (int m = 0; m < kBM; ++m) s[m] = 0.f;
      const T* kp = Ks + j * LDK;
#pragma unroll
      for (int kk = 0; kk < kHD; kk += PL) {
        float kf[PL];
        Piece<T>::load(kp + kk, kf);
#pragma unroll
        for (int m = 0; m < kBM; ++m) {
#pragma unroll
          for (int q = 0; q < PL; q += 4) {
            const float4 a =
                *reinterpret_cast<const float4*>(Qs + m * kLDQ + kk + q);
            s[m] = fmaf(a.x, kf[q], s[m]);
            s[m] = fmaf(a.y, kf[q + 1], s[m]);
            s[m] = fmaf(a.z, kf[q + 2], s[m]);
            s[m] = fmaf(a.w, kf[q + 3], s[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kBM; ++m) S[m * LDS + j] = s[m] * 0.125f;
    }
    __syncthreads();

    // softmax numerators and their row sum
    {
      const int warp = t / 32, lane = t % 32;
      for (int m = warp; m < kBM; m += kThreads / 32) {
        float* sr = S + m * LDS;
        float mx = kNegInf;
        for (int j = lane; j < N; j += 32) mx = fmaxf(mx, sr[j]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int j = lane; j < N; j += 32) {
          const float p = expf(sr[j] - mx);
          sum += p;
          sr[j] = round_to<T>(p);
        }
        for (int j = N + lane; j < Np; j += 32) sr[j] = 0.f;   // padded keys
        sum = warp_sum(sum);
        if (lane == 0) l_s[m] = sum;
      }
    }
    __syncthreads();

    // context = P V: thread owns head column c for 4 rows
    {
      float o[kBM / 4];
#pragma unroll
      for (int r = 0; r < kBM / 4; ++r) o[r] = 0.f;
      const float* pr = S + g * (kBM / 4) * LDS;
      for (int j0 = 0; j0 < Np; j0 += 4) {
        float vf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) vf[i] = to_float(Vs[(j0 + i) * LDK + c]);
#pragma unroll
        for (int r = 0; r < kBM / 4; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(pr + r * LDS + j0);
          o[r] = fmaf(p.x, vf[0], o[r]);
          o[r] = fmaf(p.y, vf[1], o[r]);
          o[r] = fmaf(p.z, vf[2], o[r]);
          o[r] = fmaf(p.w, vf[3], o[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kBM / 4; ++r) {
        const int m = g * (kBM / 4) + r;
        const int row = r0 + m;
        if (row < N)
          cb[static_cast<size_t>(row) * D + h * kHD + c] =
              from_float<CT>(o[r] / l_s[m]);
      }
    }
    __syncthreads();   // S, Qs and l_s are free for the next tile
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace vit
}  // namespace paths_cuda

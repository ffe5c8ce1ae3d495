// Shared pieces of the fused ViT MLP kernels (`vit_fused.cu`) and the int8
// block kernels (`vit_int8.cu`): tile constants, the LayerNorm statistics,
// the staged 16-row product `gemm_tile` (f32 FMAs or bf16 tensor cores), the
// MLP half of a block for 16 rows, and the per-(image, head) attention core
// of the int8 attention kernel. The design notes are at the top of
// `vit_fused.cu` and `vit_int8.cu`; the attention block and the whole block
// are built from `vit_tiles.cuh`.
#pragma once

#include <mma.h>

#include <type_traits>

#include "flash_common.cuh"

namespace paths_cuda {
namespace vit {

constexpr int kThreads = 256;
constexpr int kBM = 16;         // activation rows a block multiplies at a time
constexpr int kBK = 32;         // contraction depth of one staged chunk
constexpr int kLDA = kBK + 4;   // row stride of the staged left operand (f32)
constexpr int kHC = 256;        // hidden columns per MLP chunk
constexpr int kLDH = kHC + 8;   // row stride of the hidden chunk (in T)
constexpr int kHD = 64;         // head_dim
constexpr int kLDQ = kHD + 4;   // row stride of the q tile (f32)
constexpr float kLnEps = 1e-6f;
constexpr size_t kMaxSmem = 232448;   // 227 KB: most a block may ask for

// Blocks per SM that shared memory leaves the two-kernel route's kernels at
// the encoders' widths (an f32 tile takes twice a bf16 one's): given to
// `__launch_bounds__`, it tells the compiler how many registers it may spend.
// Without it the f32 instantiations' schedule depends on unrelated code
// around them (times in PERF.md).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 1 : 2;

// Shared-memory regions start on 128-byte boundaries.
__host__ __device__ constexpr size_t align_up(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Row strides (in elements of T) of weight chunks and of K/V rows in shared
// memory: one 16-byte piece of padding keeps 16-byte reads of neighbouring
// rows on different banks.
template <typename T>
struct Strides {
  static constexpr int kLDW = kBK + Piece<T>::kLen;
  static constexpr int kLDK = kHD + Piece<T>::kLen;
};

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

// Mean and 1/sqrt(var + eps) of the first `valid` of the 16 rows that start
// at xt (row stride D, in global or shared memory), one warp per row in
// turn; the other rows get 0. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void ln_stats(const T* xt, int valid, int D,
                                         float* mu_s, float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < kBM; m += kThreads / 32) {
    float mu = 0.f, rstd = 0.f;
    if (m < valid) {
      const T* xr = xt + static_cast<size_t>(m) * D;
      float s = 0.f;
      for (int k = lane; k < D; k += 32) s += to_float(xr[k]);
      mu = warp_sum(s) / D;
      float v = 0.f;
      for (int k = lane; k < D; k += 32) {
        const float d = to_float(xr[k]) - mu;
        v = fmaf(d, d, v);
      }
      rstd = rsqrtf(warp_sum(v) / D + kLnEps);
    }
    if (lane == 0) {
      mu_s[m] = mu;
      rstd_s[m] = rstd;
    }
  }
  __syncthreads();
}

// acc[r] += sum over k < K of A(g RM + r, k) * W(c)[k], where thread t owns
// output column c = t % NCOLS and the RM = 16 NCOLS / 256 rows of group
// g = t / NCOLS. `a_at(m, k)` gives the left operand as f32 (already rounded
// to T) for m < 16; `w_row(n)` gives the start of weight row n < NCOLS (K
// contiguous values of T, 16-byte aligned) or nullptr for a row of zeros.
// K % 32 == 0. As (16 x kLDA f32) and Ws (NCOLS x kLDW of T, at least 128
// rows) are the staging buffers. Whatever `a_at` reads from shared memory
// must be complete (a barrier) before the call; the routine ends without a
// barrier.
//
// f32: each thread multiplies its column with FMAs. bf16: the tensor cores
// (`wmma` 16x16x16, f32 accumulation): the left operand is staged as bf16,
// warp w owns the 16-column fragments of columns [w NCOLS / 8, ...), and at
// the end the accumulator fragments pass through shared memory (the weight
// buffer, free by then) so that each thread picks up its own column as in
// the f32 path.
template <typename T, int NCOLS, typename ALoad, typename WRow>
__device__ __forceinline__ void gemm_tile(float (&acc)[kBM * NCOLS / kThreads],
                                          int K, ALoad a_at, WRow w_row,
                                          float* As, T* Ws) {
  namespace wmma = nvcuda::wmma;
  constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;
  constexpr int RM = kBM * NCOLS / kThreads;
  constexpr int PL = Piece<T>::kLen;
  constexpr int PPR = kBK / PL;                  // 16-byte pieces per staged row
  constexpr int WPT = NCOLS * PPR / kThreads;    // pieces each thread moves
  constexpr int APT = kBM * kBK / kThreads;      // A values each thread moves
  constexpr int LDW = Strides<T>::kLDW;
  constexpr int LDAB = kBK + 8;                  // bf16 left operand row stride
  constexpr int FR = NCOLS >= 128 ? NCOLS / 128 : 1;   // fragments per warp
  constexpr int LDC = NCOLS + 8;                 // accumulator tile row stride
  static_assert(WPT >= 1 && RM >= 1 && APT >= 1, "tile does not fill the block");
  static_assert(kBM * LDC * sizeof(float) <=
                    (NCOLS < 128 ? 128 : NCOLS) * LDW * sizeof(T) || !kTensor,
                "the accumulator tile must fit the weight buffer");
  const int t = threadIdx.x;
  const int c = t % NCOLS, g = t / NCOLS;
  const int n0 = (t / 32) * 16 * FR;             // this warp's first column
  const bool warp_active = n0 < NCOLS;

  uint4 wreg[WPT];
  float areg[APT];
  const T* wsrc[WPT];
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const int e = t + i * kThreads;
    const T* base = w_row(e / PPR);
    wsrc[i] = base ? base + (e % PPR) * PL : nullptr;
  }
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < WPT; ++i)
      wreg[i] = wsrc[i] ? *reinterpret_cast<const uint4*>(wsrc[i] + k0)
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int e = t + i * kThreads;
      areg[i] = a_at(e / kBK, k0 + e % kBK);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cfrag[FR];
  if (kTensor) {
#pragma unroll
    for (int f = 0; f < FR; ++f) wmma::fill_fragment(cfrag[f], 0.f);
  }
  __nv_bfloat16* Ab = reinterpret_cast<__nv_bfloat16*>(As);

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();   // the previous chunk has been multiplied
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int e = t + i * kThreads;
      *reinterpret_cast<uint4*>(Ws + (e / PPR) * LDW + (e % PPR) * PL) = wreg[i];
    }
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int e = t + i * kThreads;
      if (kTensor)
        Ab[(e / kBK) * LDAB + e % kBK] = __float2bfloat16(areg[i]);
      else
        As[(e / kBK) * kLDA + e % kBK] = areg[i];
    }
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);

    if constexpr (kTensor) {
      if (warp_active) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::load_matrix_sync(af, Ab + kk, LDAB);
#pragma unroll
          for (int f = 0; f < FR; ++f) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> bf;
            wmma::load_matrix_sync(bf, Ws + (n0 + 16 * f) * LDW + kk, LDW);
            wmma::mma_sync(cfrag[f], af, bf, cfrag[f]);
          }
        }
      }
    } else {
      const T* wp = Ws + c * LDW;
      const float* ap = As + g * RM * kLDA;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += PL) {
        float w[PL];
        Piece<T>::load(wp + kk, w);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
#pragma unroll
          for (int q = 0; q < PL; q += 4) {
            const float4 a =
                *reinterpret_cast<const float4*>(ap + r * kLDA + kk + q);
            acc[r] = fmaf(a.x, w[q], acc[r]);
            acc[r] = fmaf(a.y, w[q + 1], acc[r]);
            acc[r] = fmaf(a.z, w[q + 2], acc[r]);
            acc[r] = fmaf(a.w, w[q + 3], acc[r]);
          }
        }
      }
    }
  }
  if constexpr (kTensor) {
    __syncthreads();   // every warp is done with the weight buffer
    float* Cs = reinterpret_cast<float*>(Ws);
    if (warp_active) {
#pragma unroll
      for (int f = 0; f < FR; ++f)
        wmma::store_matrix_sync(Cs + n0 + 16 * f, cfrag[f], LDC,
                                wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] += Cs[(g * RM + r) * LDC + c];
  }
}

// LN(x) of row m of the tile that starts at xt, at column k, rounded to T;
// 0 for rows past `valid`.
template <typename T>
struct LnRows {
  const T* xt;
  const float* scale;
  const float* bias;
  const float* mu_s;
  const float* rstd_s;
  int valid, D;
  __device__ __forceinline__ float operator()(int m, int k) const {
    if (m >= valid) return 0.f;
    const float xv = to_float(xt[static_cast<size_t>(m) * D + k]);
    return round_to<T>((xv - mu_s[m]) * rstd_s[m] * scale[k] + bias[k]);
  }
};

enum Act { kGeluExact = 0, kGeluTanh = 1, kSwiglu = 2 };

template <int ACT>
__device__ __forceinline__ float gelu(float h) {
  if (ACT == kGeluExact)
    return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  const float u = 0.7978845608028654f * (h + 0.044715f * h * h * h);
  return 0.5f * h * (1.f + tanhf(u));
}

// ------------------------------------------------ MLP half, for 16 rows
// acc_s (16 x D f32, zeroed by the caller) += act(A W1^T + b1) W2^T, where
// `a_ln(m, k)` gives the normalised left operand. w1: (H, D), or for SwiGLU
// the packed (2H, D) with the gate rows first; w2: (D, H). Whatever `a_ln`
// reads from shared memory must be complete before the call; ends with a
// barrier, after which acc_s is complete.
template <typename T, int ACT, typename ALoad>
__device__ __forceinline__ void mlp_rows(ALoad a_ln, const T* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const T* __restrict__ w2, int D, int H,
                                         float* acc_s, float* As, T* Ws, T* Hs) {
  const int t = threadIdx.x;
  for (int hc = 0; hc < H; hc += kHC) {
    const int j = hc + t;              // this thread's hidden index
    const bool valid = j < H;
    float h1[kBM];
#pragma unroll
    for (int r = 0; r < kBM; ++r) h1[r] = 0.f;
    gemm_tile<T, kHC>(h1, D, a_ln, [&](int n) -> const T* {
      return hc + n < H ? w1 + static_cast<size_t>(hc + n) * D : nullptr;
    }, As, Ws);
    if (ACT == kSwiglu) {
      float h2[kBM];
#pragma unroll
      for (int r = 0; r < kBM; ++r) h2[r] = 0.f;
      gemm_tile<T, kHC>(h2, D, a_ln, [&](int n) -> const T* {
        return hc + n < H ? w1 + static_cast<size_t>(H + hc + n) * D : nullptr;
      }, As, Ws);
      const float bg = valid ? b1[j] : 0.f, bv = valid ? b1[H + j] : 0.f;
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        const float gate = h1[r] + bg, val = h2[r] + bv;
        const float hv = gate / (1.f + expf(-gate)) * val;
        Hs[r * kLDH + t] = from_float<T>(valid ? hv : 0.f);
      }
    } else {
      const float bj = valid ? b1[j] : 0.f;
#pragma unroll
      for (int r = 0; r < kBM; ++r)
        Hs[r * kLDH + t] = from_float<T>(valid ? gelu<ACT>(h1[r] + bj) : 0.f);
    }
    __syncthreads();   // the hidden chunk is complete

    const int kc = min(kHC, H - hc);
    for (int d0 = 0; d0 < D; d0 += kHC) {
      float o[kBM];
#pragma unroll
      for (int r = 0; r < kBM; ++r) o[r] = 0.f;
      gemm_tile<T, kHC>(o, kc,
                        [&](int m, int k) { return to_float(Hs[m * kLDH + k]); },
                        [&](int n) -> const T* {
        return d0 + n < D ? w2 + static_cast<size_t>(d0 + n) * H + hc : nullptr;
      }, As, Ws);
      if (d0 + t < D) {
#pragma unroll
        for (int r = 0; r < kBM; ++r) acc_s[r * D + d0 + t] += o[r];
      }
    }
  }
  __syncthreads();
}

// Shared memory of `mlp_rows` and of the kernels built on it: the
// accumulator, the staging buffers, the LayerNorm statistics and the hidden
// chunk, in this order.
template <typename T>
struct MlpSmem {
  float* acc_s;    // kBM x D
  float* As;       // kBM x kLDA
  float* mu_s;
  float* rstd_s;
  T* Ws;           // kHC x kLDW
  T* Hs;           // kBM x kLDH
  __device__ MlpSmem(unsigned char* base, int D) {
    acc_s = reinterpret_cast<float*>(base);
    As = acc_s + kBM * D;
    mu_s = As + kBM * kLDA;
    rstd_s = mu_s + kBM;
    Ws = reinterpret_cast<T*>(rstd_s + kBM);
    Hs = Ws + kHC * Strides<T>::kLDW;
  }
  __host__ __device__ static size_t bytes(int D) {
    return align_up((static_cast<size_t>(kBM) * D + kBM * kLDA + 2 * kBM) *
                        sizeof(float) +
                    (kHC * Strides<T>::kLDW + kBM * kLDH) * sizeof(T));
  }
};

// ---------------------------------------------------- attention, per head
// Elements of T that one head's K and V take for N tokens.
template <typename T>
__host__ __device__ inline size_t attn_kv_elems(int N) {
  return 2 * ((static_cast<size_t>(N) + 3) / 4 * 4) * Strides<T>::kLDK;
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
  constexpr int LDK = Strides<T>::kLDK;
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

// Fused ViT encoder-block kernels for Hopper (sm_90a), f32 or bf16, forward
// only (the patch encoders are frozen).
//
// Replaces the TPU kernels of `paths_tpu/kernels/vit_fused.py`:
//   fused_attn_block        (body `_attn_kernel`):   vit_attn_kernel + vit_proj_kernel
//   fused_mlp_block         (body `_mlp_kernel`):    vit_mlp_kernel<T, gelu>
//   fused_swiglu_mlp_block  (body `_swiglu_kernel`): vit_mlp_kernel<T, swiglu>
// for x (B, N, D) contiguous in T (f32 or bf16), weights in T in PyTorch's
// (out, in) layout, so that both operands of every product run along their
// contiguous axis; LayerNorm scale/bias, biases and LayerScale in f32.
// Accumulation is f32 throughout. f32 operands are multiplied with FMAs on
// the CUDA cores (no TF32); bf16 operands of the projections (qkv, out
// projection, fc1, fc2) go through the tensor cores (`wmma`, f32
// accumulation), the attention's own two products (q k^T, P V) run on the
// CUDA cores in both types.
//
// Rounding points, as in the TPU kernels: to T after the LayerNorm, after
// qkv + bias, P before P V, each head's context after the deferred divide,
// the hidden activation before fc2, and the output; everything else is f32.
//
// Design. The TPU kernels keep one image's activation and the block's whole
// weights in VMEM. A CUDA block has 227 KB of shared memory, so:
//  * Every product goes through one routine, `gemm_tile`: 16 rows of the
//    left operand against NCOLS weight rows, each thread owning one output
//    column for 16 / (256 / NCOLS) rows. Both operands pass through shared
//    memory in chunks of 32 along the contraction, the next chunk's global
//    loads being issued into registers before the current one is multiplied.
//    The left operand is staged already rounded to T (as f32 for the FMA
//    path, as bf16 for the tensor cores), the weights stay in T.
//  * The LayerNorm is applied while the left operand is staged (mean and
//    1/std of the 16 rows are computed first), so LN(x) never takes shared
//    memory of its own.
//  * MLP (row-wise independent): a block owns 16 rows of the flattened
//    (B N, D) activation and loops over the hidden dimension in chunks of
//    256, which takes the place of the TPU kernel's sequential `num_chunks`
//    grid axis: fc1 chunk -> activation in registers -> rounded chunk in
//    shared memory -> its fc2 contribution added to a (16, D) f32
//    accumulator in shared memory. The hidden activation never reaches
//    device memory. For SwiGLU the thread that owns hidden index j computes
//    both the gate column j and the value column H + j of the packed fc1.
//  * Attention couples all tokens of an image per head, and the out
//    projection sums over heads. One block per (image, head) computes that
//    head's K and V for all tokens into shared memory, then walks the
//    queries 16 rows at a time: q tile, scores against all keys (the ragged
//    edge is handled by loop bounds, padded probabilities are written as
//    exact zeros), softmax with the division deferred past P V, context.
//    The context (B, N, D) in T is the one intermediate that goes through
//    device memory, because the out projection needs all heads of a row: a
//    second kernel (`vit_proj_kernel`) computes proj + bias, LayerScale and
//    the residual. No atomics, so two calls are bitwise equal. Neither the
//    (B, H, N, N) scores nor the (B, N, 3D) qkv reach device memory.
//    K and V of one head must fit shared memory: N <= 340 in f32 and
//    608 in bf16 (`paths_vit_attn_smem_bytes` tells; the wrapper refuses
//    more).
//
// Bound on the card: at the encoder's shapes (UNI: 12,608 rows, D 1024,
// hidden 4096) every kernel does hundreds of operations per byte of x and
// weights, so the operation rate bounds it: the bf16 tensor-core rate for
// bf16, the f32 CUDA-core rate for f32. This version reaches neither: a
// block restreams the weights from L2 for every 16 rows, and a 16-row tile
// uses each weight fragment for one `mma` only. Larger row tiles, `wgmma`
// and TMA are later work.
//
// Requirements (checked by the Python wrapper): head_dim 64, D % 64 == 0,
// hidden % 32 == 0, 16-byte aligned contiguous tensors.
//
// C interface (loaded through ctypes): the launch entries return the
// cudaError_t of the launch (0 on success).

#include <mma.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace paths_cuda;

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

// Mean and 1/sqrt(var + eps) of rows r0 .. r0 + 15 of x (R rows of D), one
// warp per row in turn; rows past R get 0. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void ln_stats(const T* __restrict__ x, int r0, int R,
                                         int D, float* mu_s, float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < kBM; m += kThreads / 32) {
    const int row = r0 + m;
    float mu = 0.f, rstd = 0.f;
    if (row < R) {
      const T* xr = x + static_cast<size_t>(row) * D;
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

// LN(x) of row r0 + m at column k, rounded to T; 0 for rows past R.
template <typename T>
struct LnRows {
  const T* x;
  const float* scale;
  const float* bias;
  const float* mu_s;
  const float* rstd_s;
  int r0, R, D;
  __device__ __forceinline__ float operator()(int m, int k) const {
    const int row = r0 + m;
    if (row >= R) return 0.f;
    const float xv = to_float(x[static_cast<size_t>(row) * D + k]);
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

// ---------------------------------------------------------------- MLP block
// out = x + ls * (act(LN(x) W1^T + b1) W2^T + b2) for rows r0 .. r0 + 15 of
// the flattened (R, D) activation. w1: (H, D), or for SwiGLU the packed
// (2H, D) with the gate rows first; w2: (D, H).
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
vit_mlp_kernel(const T* __restrict__ x, const float* __restrict__ ns,
               const float* __restrict__ nb, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ ls,
               T* __restrict__ out, int R, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* acc_s = reinterpret_cast<float*>(smem_raw);   // kBM x D
  float* As = acc_s + kBM * D;                         // kBM x kLDA
  float* mu_s = As + kBM * kLDA;
  float* rstd_s = mu_s + kBM;
  T* Ws = reinterpret_cast<T*>(rstd_s + kBM);          // kHC x kLDW
  T* Hs = Ws + kHC * Strides<T>::kLDW;                 // kBM x kLDH

  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kBM;
  for (int i = t; i < kBM * D; i += kThreads) acc_s[i] = 0.f;
  ln_stats<T>(x, r0, R, D, mu_s, rstd_s);
  const LnRows<T> a_ln{x, ns, nb, mu_s, rstd_s, r0, R, D};

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
  for (int i = t; i < kBM * D; i += kThreads) {
    const int m = i / D, d = i % D;
    const int row = r0 + m;
    if (row < R) {
      const size_t at = static_cast<size_t>(row) * D + d;
      out[at] = from_float<T>(to_float(x[at]) + (acc_s[i] + b2[d]) * ls[d]);
    }
  }
}

// ---------------------------------------------------- attention, per head
// ctx[b, :, h 64 : (h + 1) 64] = softmax(q k^T / 8) v of head h of image b,
// with q, k, v = LN(x_b) Wqkv^T + bqkv rounded to T. wqkv: (3D, D), rows
// [q | k | v], each split by head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
vit_attn_kernel(const T* __restrict__ x, const float* __restrict__ ns,
                const float* __restrict__ nb, const T* __restrict__ wqkv,
                const float* __restrict__ bqkv, T* __restrict__ ctx, int N,
                int D) {
  constexpr int LDW = Strides<T>::kLDW;
  constexpr int LDK = Strides<T>::kLDK;
  constexpr int PL = Piece<T>::kLen;
  const int Np = (N + 3) / 4 * 4;
  const int LDS = Np + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);   // kBM x LDS
  float* Qs = S + kBM * LDS;                       // kBM x kLDQ
  float* As = Qs + kBM * kLDQ;                     // kBM x kLDA
  float* mu_s = As + kBM * kLDA;
  float* rstd_s = mu_s + kBM;
  float* l_s = rstd_s + kBM;
  T* Ws = reinterpret_cast<T*>(l_s + kBM);         // 128 x LDW
  T* Ks = Ws + 128 * LDW;                          // Np x LDK
  T* Vs = Ks + Np * LDK;                           // Np x LDK

  const int t = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* xb = x + static_cast<size_t>(b) * N * D;
  T* cb = ctx + static_cast<size_t>(b) * N * D;

  // rows N .. Np - 1 of K and V are read by the P V loop against p = 0
  for (int i = t; i < (Np - N) * kHD; i += kThreads) {
    const int at = (N + i / kHD) * LDK + i % kHD;
    Ks[at] = from_float<T>(0.f);
    Vs[at] = from_float<T>(0.f);
  }

  // K and V of every token
  for (int r0 = 0; r0 < N; r0 += kBM) {
    ln_stats<T>(xb, r0, N, D, mu_s, rstd_s);
    const LnRows<T> a_ln{xb, ns, nb, mu_s, rstd_s, r0, N, D};
    float kv[kBM / 2];
#pragma unroll
    for (int r = 0; r < kBM / 2; ++r) kv[r] = 0.f;
    gemm_tile<T, 128>(kv, D, a_ln, [&](int n) -> const T* {
      return wqkv + (static_cast<size_t>(1 + n / kHD) * D + h * kHD + n % kHD) * D;
    }, As, Ws);
    const int c = t % 128, g = t / 128;
    const int d = c % kHD;
    const float bias = bqkv[(1 + c / kHD) * D + h * kHD + d];
    T* dst = c < kHD ? Ks : Vs;
#pragma unroll
    for (int r = 0; r < kBM / 2; ++r) {
      const int row = r0 + g * (kBM / 2) + r;
      if (row < N) dst[row * LDK + d] = from_float<T>(kv[r] + bias);
    }
  }

  // queries, 16 rows at a time
  for (int r0 = 0; r0 < N; r0 += kBM) {
    ln_stats<T>(xb, r0, N, D, mu_s, rstd_s);
    const LnRows<T> a_ln{xb, ns, nb, mu_s, rstd_s, r0, N, D};
    const int c = t % kHD, g = t / kHD;
    {
      float qa[kBM / 4];
#pragma unroll
      for (int r = 0; r < kBM / 4; ++r) qa[r] = 0.f;
      gemm_tile<T, kHD>(qa, D, a_ln, [&](int n) -> const T* {
        return wqkv + static_cast<size_t>(h * kHD + n) * D;
      }, As, Ws);
      const float bias = bqkv[h * kHD + c];
#pragma unroll
      for (int r = 0; r < kBM / 4; ++r)
        Qs[(g * (kBM / 4) + r) * kLDQ + c] = round_to<T>(qa[r] + bias);
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

    // softmax numerators, rounded to T; the row sum of the unrounded ones
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

    // context = P V / l: thread owns head column c for 4 rows
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
              from_float<T>(o[r] / l_s[m]);
      }
    }
    __syncthreads();   // S, Qs and l_s are free for the next tile
  }
}

// out = x + ls * (ctx Wp^T + bp) for rows r0 .. r0 + 15 of (R, D).
template <typename T>
__global__ void __launch_bounds__(kThreads)
vit_proj_kernel(const T* __restrict__ ctx, const T* __restrict__ x,
                const T* __restrict__ wp, const float* __restrict__ bp,
                const float* __restrict__ ls, T* __restrict__ out, int R,
                int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);   // kBM x kLDA
  T* Ws = reinterpret_cast<T*>(As + kBM * kLDA);    // 256 x kLDW
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kBM;
  for (int d0 = 0; d0 < D; d0 += kThreads) {
    float o[kBM];
#pragma unroll
    for (int r = 0; r < kBM; ++r) o[r] = 0.f;
    gemm_tile<T, kThreads>(o, D, [&](int m, int k) {
      const int row = r0 + m;
      return row < R ? to_float(ctx[static_cast<size_t>(row) * D + k]) : 0.f;
    }, [&](int n) -> const T* {
      return d0 + n < D ? wp + static_cast<size_t>(d0 + n) * D : nullptr;
    }, As, Ws);
    const int n = d0 + t;
    if (n < D) {
      const float bias = bp[n], scale = ls[n];
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        const int row = r0 + r;
        if (row < R) {
          const size_t at = static_cast<size_t>(row) * D + n;
          out[at] = from_float<T>(to_float(x[at]) + (o[r] + bias) * scale);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename T>
size_t attn_smem(int N) {
  const size_t np = (static_cast<size_t>(N) + 3) / 4 * 4;
  return (kBM * (np + 4) + kBM * kLDQ + kBM * kLDA + 3 * kBM) * sizeof(float) +
         (128 * Strides<T>::kLDW + 2 * np * Strides<T>::kLDK) * sizeof(T);
}

template <typename T>
size_t proj_smem() {
  return kBM * kLDA * sizeof(float) + kThreads * Strides<T>::kLDW * sizeof(T);
}

template <typename T>
size_t mlp_smem(int D) {
  return (static_cast<size_t>(kBM) * D + kBM * kLDA + 2 * kBM) * sizeof(float) +
         (kHC * Strides<T>::kLDW + kBM * kLDH) * sizeof(T);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_attn(const void* x, const float* ns, const float* nb,
                const void* wqkv, const float* bqkv, const void* wp,
                const float* bp, const float* ls, void* ctx, void* out, int B,
                int N, int D, int heads, cudaStream_t stream) {
  if (heads * kHD != D || D % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_a = attn_smem<T>(N), smem_p = proj_smem<T>();
  if (smem_a > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = allow_smem(vit_attn_kernel<T>, smem_a);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = allow_smem(vit_proj_kernel<T>, smem_p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  vit_attn_kernel<T><<<dim3(heads, B), kThreads, smem_a, stream>>>(
      static_cast<const T*>(x), ns, nb, static_cast<const T*>(wqkv), bqkv,
      static_cast<T*>(ctx), N, D);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int R = B * N;
  vit_proj_kernel<T><<<(R + kBM - 1) / kBM, kThreads, smem_p, stream>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(x),
      static_cast<const T*>(wp), bp, ls, static_cast<T*>(out), R, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT>
int launch_mlp(const void* x, const float* ns, const float* nb, const void* w1,
               const float* b1, const void* w2, const float* b2,
               const float* ls, void* out, int R, int D, int H,
               cudaStream_t stream) {
  if (D % kBK != 0 || H % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mlp_smem<T>(D);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = allow_smem(vit_mlp_kernel<T, ACT>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  vit_mlp_kernel<T, ACT><<<(R + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ns, nb, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, ls, static_cast<T*>(out), R, D, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_mlp(int act, const void* x, const float* ns, const float* nb,
                 const void* w1, const float* b1, const void* w2,
                 const float* b2, const float* ls, void* out, int R, int D,
                 int H, cudaStream_t s) {
  switch (act) {
    case kGeluExact:
      return launch_mlp<T, kGeluExact>(x, ns, nb, w1, b1, w2, b2, ls, out, R, D, H, s);
    case kGeluTanh:
      return launch_mlp<T, kGeluTanh>(x, ns, nb, w1, b1, w2, b2, ls, out, R, D, H, s);
    case kSwiglu:
      return launch_mlp<T, kSwiglu>(x, ns, nb, w1, b1, w2, b2, ls, out, R, D, H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, the weights, ctx and out share it; norm
// scale/bias, biases and LayerScale are f32). ctx is scratch of x's shape.
extern "C" int paths_vit_attn_block(
    const void* x, const float* norm_scale, const float* norm_bias,
    const void* qkv_w, const float* qkv_b, const void* proj_w,
    const float* proj_b, const float* ls, void* ctx, void* out, int B, int N,
    int D, int heads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_attn<float>(x, norm_scale, norm_bias, qkv_w, qkv_b, proj_w,
                                proj_b, ls, ctx, out, B, N, D, heads, s);
    case 1:
      return launch_attn<__nv_bfloat16>(x, norm_scale, norm_bias, qkv_w, qkv_b,
                                        proj_w, proj_b, ls, ctx, out, B, N, D,
                                        heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// act: 0 = exact (erf) GELU, 1 = tanh GELU, 2 = packed SwiGLU (fc1_w is
// (2H, D), gate rows first). x is (R, D), R = B N.
extern "C" int paths_vit_mlp_block(
    const void* x, const float* norm_scale, const float* norm_bias,
    const void* fc1_w, const float* fc1_b, const void* fc2_w,
    const float* fc2_b, const float* ls, void* out, int R, int D, int H,
    int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_mlp<float>(act, x, norm_scale, norm_bias, fc1_w, fc1_b,
                                 fc2_w, fc2_b, ls, out, R, D, H, s);
    case 1:
      return dispatch_mlp<__nv_bfloat16>(act, x, norm_scale, norm_bias, fc1_w,
                                         fc1_b, fc2_w, fc2_b, ls, out, R, D, H,
                                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory the attention kernel needs for N tokens, and the MLP
// kernel for width D; the most a block may have.
extern "C" long long paths_vit_attn_smem_bytes(int N, int dtype) {
  return static_cast<long long>(dtype == 0 ? attn_smem<float>(N)
                                           : attn_smem<__nv_bfloat16>(N));
}

extern "C" long long paths_vit_mlp_smem_bytes(int D, int dtype) {
  return static_cast<long long>(dtype == 0 ? mlp_smem<float>(D)
                                           : mlp_smem<__nv_bfloat16>(D));
}

extern "C" long long paths_vit_max_smem_bytes() {
  return static_cast<long long>(kMaxSmem);
}

extern "C" const char* paths_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Int8 fused ViT encoder-block kernels for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernels of `paths_tpu/kernels/vit_int8.py`:
//   fused_attn_block_i8        (body `_attn_kernel_i8`):   vit_attn_i8_kernel + vit_proj_i8_kernel
//   fused_mlp_block_i8         (body `_mlp_kernel_i8`):    vit_mlp_i8_kernel<T, gelu>
//   fused_swiglu_mlp_block_i8  (body `_swiglu_kernel_i8`): vit_mlp_i8_kernel<T, swiglu>
// for x (B, N, D) contiguous in T (f32 or bf16). The four projections (qkv,
// out, fc1, fc2) multiply int8 activations with int8 weights into int32 on
// the tensor cores (`wmma` 16x16x16, `signed char`); weights are (out, in)
// int8 with one f32 scale per output channel, quantised once on the host;
// LayerNorm scale/bias, biases and LayerScale are f32. The attention itself
// (q k^T, softmax, P V) runs in T on the CUDA cores (`attn_head`,
// `vit_common.cuh`).
//
// Arithmetic, as in the TPU kernels. Activations are quantised per row:
// s = max|y| * (1/127), s = 1 for a row of zeros, code = clip(rint(y / s),
// -127, 127), with a true division and round-half-even. What is quantised is
// f32: the LayerNorm output (not rounded to T), each row of the context
// c_h / l (not rounded), and the hidden activation. A product is rescaled as
// float(acc) * row scale * channel scale + bias, every operation rounded on
// its own (no fused multiply-add), so that a plain PyTorch version can repeat
// it to the bit. The fc2 sum of one hidden chunk is converted to f32 once.
// GELU is the rational erf of the TPU kernels (Abramowitz-Stegun 7.1.26), not
// `erff`; SwiGLU is gate / (1 + exp(-gate)) * value.
//
// Quantisation is discontinuous, so a LayerNorm summed in another order could
// move an activation across a rounding boundary and with it a whole output
// row. The LayerNorm before a quantisation is therefore evaluated in f64 and
// rounded to f32 once: two implementations then agree on every code unless a
// value lies within 1e-16 of a boundary.
//
// Design.
//  * `gemm_tile_i8` multiplies 16 rows of codes (one byte per element)
//    against NCOLS weight rows, staged through shared memory in chunks
//    of 32 along the contraction, the next chunk prefetched into registers.
//    A chunk is stored as two slabs of 16 columns with a row stride of 48
//    bytes, so that every `wmma` tile starts on a 32-byte boundary and the
//    fragment loads are free of bank conflicts. Integer sums are exact in any
//    order.
//  * The codes of a 16-row tile (16 x D bytes) and its row scales are made
//    once per tile and kept in shared memory.
//  * `num_chunks` is part of the function here, not a tuning knob: the hidden
//    activation's row scale is the abs-max over one chunk of H / num_chunks
//    columns. The kernel streams the hidden dimension in pieces of 256
//    columns and cannot know that scale before the chunk's last piece, and
//    16 rows of a whole chunk do not fit shared memory in f32. So fc1 runs
//    twice per chunk: a first pass finds each row's abs-max, a second
//    recomputes the same values (integer sums and a fixed f32 epilogue: bit
//    for bit the same), quantises them and feeds fc2. That is 1.5 times the
//    operations of the GELU block and 5/3 of the SwiGLU block. The fc2 sum of
//    a chunk stays in an int32 (16, D) tile in shared memory; with more than
//    one chunk an f32 tile beside it takes the rescaled sums.
//  * Attention: one block per (image, head) (`attn_head` in
//    `vit_common.cuh`) computes that head's K and V for all tokens, then
//    walks the queries 16 rows at a time, the scores of 16 rows against all
//    keys in shared memory (so P is taken against the row's final max). K and
//    V stay in shared memory where they fit (N up to about 300 in f32, 510 in
//    bf16 at the encoders' widths); beyond that (the patch-8 Kaiko models' 785 tokens)
//    they go to a device-memory scratch of the block's own, from which the
//    score and P V loops read them back through L1/L2. The per-head context
//    leaves in f32 (B, N, D) through device memory, and a second kernel
//    quantises each row of it and computes the out projection, LayerScale
//    and the residual.
//
// Bound on the card: the projections at the int8 tensor-core rate, the
// attention's two products at T's rate. This version is far from it: 16-row
// tiles restream the weights from L2, the f64 LayerNorm and quantisation of a
// row are redone for each of its heads, and q k^T and P V run on the CUDA
// cores. The attention block of `vit_fused.cu` shows the way out (one
// LayerNorm pass, GEMMs over all rows, tensor-core attention).
//
// Requirements (checked by the Python wrapper): head_dim 64, D % 64 == 0,
// H / num_chunks a multiple of 64, 16-byte aligned contiguous tensors.

#include <mma.h>

#include "vit_common.cuh"

namespace {

using namespace paths_cuda;
using namespace paths_cuda::vit;

constexpr int kLD8 = 48;        // bytes per staged row of one 16-column slab
constexpr int kLDHQ = kHC + 16; // row stride of the quantised hidden piece

__device__ __forceinline__ double warp_sum64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Mean and 1/sqrt(var + eps) in f64 of the first `valid` of 16 rows at xt.
// Ends with a barrier.
template <typename T>
__device__ __forceinline__ void ln_stats64(const T* xt, int valid, int D,
                                           double* mu_s, double* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < kBM; m += kThreads / 32) {
    double mu = 0.0, rstd = 0.0;
    if (m < valid) {
      const T* xr = xt + static_cast<size_t>(m) * D;
      double s = 0.0;
      for (int k = lane; k < D; k += 32) s += static_cast<double>(to_float(xr[k]));
      mu = warp_sum64(s) / D;
      double v = 0.0;
      for (int k = lane; k < D; k += 32) {
        const double d = static_cast<double>(to_float(xr[k])) - mu;
        v += d * d;
      }
      rstd = 1.0 / sqrt(warp_sum64(v) / D + 1e-6);
    }
    if (lane == 0) {
      mu_s[m] = mu;
      rstd_s[m] = rstd;
    }
  }
  __syncthreads();
}

// LN(x) of row m at column k: f64 arithmetic, rounded to f32 once.
template <typename T>
struct LnRows64 {
  const T* xt;
  const float* scale;
  const float* bias;
  const double* mu_s;
  const double* rstd_s;
  int D;
  __device__ __forceinline__ float operator()(int m, int k) const {
    const double xv = to_float(xt[static_cast<size_t>(m) * D + k]);
    return static_cast<float>((xv - mu_s[m]) * rstd_s[m] *
                                  static_cast<double>(scale[k]) +
                              static_cast<double>(bias[k]));
  }
};

__device__ __forceinline__ float quant_scale(float amax) {
  const float s = __fmul_rn(amax, 0.007874015748031496f);   // max|y| * (1/127)
  return s > 0.f ? s : 1.f;
}

__device__ __forceinline__ int quant_code(float y, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f));
}

// Codes (16 x D bytes) and row scales of 16 rows, one warp per row in turn:
// `val(m, k)` gives the f32 value of row m < valid; the other rows become
// zeros with scale 1. D % 4 == 0. Ends with a barrier.
template <typename Val>
__device__ __forceinline__ void quant_rows(Val val, int valid, int D,
                                           signed char* yq, float* ys) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < kBM; m += kThreads / 32) {
    int* row = reinterpret_cast<int*>(yq + static_cast<size_t>(m) * D);
    float s = 1.f;
    if (m < valid) {
      float amax = 0.f;
      for (int k = lane; k < D; k += 32) amax = fmaxf(amax, fabsf(val(m, k)));
      s = quant_scale(warp_max(amax));
      for (int k = 4 * lane; k < D; k += 128) {
        int word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          word |= (quant_code(val(m, k + i), s) & 0xff) << (8 * i);
        row[k / 4] = word;
      }
    } else {
      for (int k = 4 * lane; k < D; k += 128) row[k / 4] = 0;
    }
    if (lane == 0) ys[m] = s;
  }
  __syncthreads();
}

// acc[r] += sum over k < K of A(g RM + r, k) * W(c)[k] in int32, where
// thread t owns output column c = t % NCOLS and the RM = 16 NCOLS / 256 rows
// of group g = t / NCOLS. `a_word(m, k)` gives the four codes of
// row m at columns k .. k + 3 (k % 4 == 0) packed into an int; `w_row(n)`
// gives weight row n (K contiguous codes, 16-byte aligned) or nullptr for a
// row of zeros. K % 32 == 0. As8 holds 2 x 16 x kLD8 bytes, Ws8 2 x NCOLS x
// kLD8 (at least 2 x 128 x kLD8), both 32-byte aligned. Ends without a
// barrier; the caller's reads of shared memory must be complete before.
template <int NCOLS, typename ALoad, typename WRow>
__device__ __forceinline__ void gemm_tile_i8(int (&acc)[kBM * NCOLS / kThreads],
                                             int K, ALoad a_word, WRow w_row,
                                             signed char* As8, signed char* Ws8) {
  namespace wmma = nvcuda::wmma;
  constexpr int RM = kBM * NCOLS / kThreads;
  constexpr int PIECES = NCOLS * 2;              // 16-byte pieces of a W chunk
  constexpr int WPT = (PIECES + kThreads - 1) / kThreads;
  constexpr int FR = NCOLS >= 128 ? NCOLS / 128 : 1;   // fragments per warp
  constexpr int LDC = NCOLS + 8;                 // accumulator tile row stride
  static_assert(kBM * LDC * sizeof(int) <= 2 * NCOLS * kLD8,
                "the accumulator tile must fit the weight buffer");
  const int t = threadIdx.x;
  const int c = t % NCOLS, g = t / NCOLS;
  const int n0 = (t / 32) * 16 * FR;             // this warp's first column
  const bool warp_active = n0 < NCOLS;
  const bool moves_a = t < kBM * kBK / 4;        // one word of A per thread
  const int am = t / (kBK / 4), ak = (t % (kBK / 4)) * 4;

  uint4 wreg[WPT];
  int areg = 0;
  const signed char* wsrc[WPT];
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const int e = t + i * kThreads;
    const signed char* base = e < PIECES ? w_row(e / 2) : nullptr;
    wsrc[i] = base ? base + (e % 2) * 16 : nullptr;
  }
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < WPT; ++i)
      wreg[i] = wsrc[i] ? *reinterpret_cast<const uint4*>(wsrc[i] + k0)
                        : make_uint4(0u, 0u, 0u, 0u);
    if (moves_a) areg = a_word(am, k0 + ak);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> cfrag[FR];
#pragma unroll
  for (int f = 0; f < FR; ++f) wmma::fill_fragment(cfrag[f], 0);

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();   // the previous chunk has been multiplied
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int e = t + i * kThreads;
      if (e < PIECES)
        *reinterpret_cast<uint4*>(Ws8 + ((e % 2) * NCOLS + e / 2) * kLD8) = wreg[i];
    }
    if (moves_a)
      *reinterpret_cast<int*>(As8 + ((ak / 16) * kBM + am) * kLD8 + ak % 16) = areg;
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);

    if (warp_active) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af;
        wmma::load_matrix_sync(af, As8 + s * kBM * kLD8, kLD8);
#pragma unroll
        for (int f = 0; f < FR; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, Ws8 + (s * NCOLS + n0 + 16 * f) * kLD8, kLD8);
          wmma::mma_sync(cfrag[f], af, bf, cfrag[f]);
        }
      }
    }
  }
  __syncthreads();   // every warp is done with the weight buffer
  int* Cs = reinterpret_cast<int*>(Ws8);
  if (warp_active) {
#pragma unroll
    for (int f = 0; f < FR; ++f)
      wmma::store_matrix_sync(Cs + n0 + 16 * f, cfrag[f], LDC, wmma::mem_row_major);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] += Cs[(g * RM + r) * LDC + c];
}

// float(acc) * row scale * channel scale + bias, each operation rounded.
__device__ __forceinline__ float rescale(int acc, float row_s, float chan_s,
                                         float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc), row_s), chan_s),
                   bias);
}

// Shared memory every int8 product needs: the codes of a 16-row tile and
// their scales, f64 LayerNorm statistics, and the two staging buffers.
struct QuantSmem {
  signed char* yq;    // kBM x D
  float* ys;          // kBM
  double* mu_s;       // kBM
  double* rstd_s;     // kBM
  signed char* As8;   // 2 x kBM x kLD8
  signed char* Ws8;   // 2 x 256 x kLD8
  __device__ QuantSmem(unsigned char* base, int D) {
    mu_s = reinterpret_cast<double*>(base);
    rstd_s = mu_s + kBM;
    ys = reinterpret_cast<float*>(rstd_s + kBM);
    As8 = reinterpret_cast<signed char*>(base + 384);
    Ws8 = As8 + 2 * kBM * kLD8;
    yq = Ws8 + 2 * kThreads * kLD8;
  }
  __host__ __device__ static size_t bytes(int D) {
    return align_up(384 + 2 * kBM * kLD8 + 2 * kThreads * kLD8 +
                    static_cast<size_t>(kBM) * D);
  }
};

// ---------------------------------------------------- attention, per head
// The q, k, v projection of 16 token rows through int8: codes of the f32
// LayerNorm output against the int8 weight, rescaled in f32.
template <typename T>
struct QkvInt8 {
  const T* xb;
  const float* ns;
  const float* nb;
  const signed char* wq;   // (3D, D)
  const float* ws;         // (3D,)
  const float* bias;       // (3D,)
  int N, D;
  QuantSmem sm;

  __device__ QkvInt8(const T* xb_, const float* ns_, const float* nb_,
                     const signed char* wq_, const float* ws_,
                     const float* bias_, int N_, int D_, unsigned char* smem)
      : xb(xb_), ns(ns_), nb(nb_), wq(wq_), ws(ws_), bias(bias_), N(N_), D(D_),
        sm(smem, D_) {}

  __device__ __forceinline__ void prepare(int r0) {
    const T* xt = xb + static_cast<size_t>(r0) * D;
    __syncthreads();   // the previous tile's codes are no longer read
    ln_stats64<T>(xt, N - r0, D, sm.mu_s, sm.rstd_s);
    quant_rows(LnRows64<T>{xt, ns, nb, sm.mu_s, sm.rstd_s, D}, N - r0, D, sm.yq,
               sm.ys);
  }
  template <int NCOLS, typename RowOf>
  __device__ __forceinline__ void product(float (&out)[kBM * NCOLS / kThreads],
                                          RowOf row_of) {
    constexpr int RM = kBM * NCOLS / kThreads;
    int acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = 0;
    const signed char* yq = sm.yq;
    const int d = D;
    gemm_tile_i8<NCOLS>(acc, D, [&](int m, int k) {
      return *reinterpret_cast<const int*>(yq + m * d + k);
    }, [&](int n) -> const signed char* {
      return wq + static_cast<size_t>(row_of(n)) * d;
    }, sm.As8, sm.Ws8);
    const int col = row_of(threadIdx.x % NCOLS), g = threadIdx.x / NCOLS;
    const float cs = ws[col], b = bias[col];
#pragma unroll
    for (int r = 0; r < RM; ++r) out[r] = rescale(acc[r], sm.ys[g * RM + r], cs, b);
  }
};

// ctx[b, :, h 64 : (h + 1) 64] of head h = blockIdx.x of image b =
// blockIdx.y. KV_DEVICE: K and V go to the block's own part of `kv`
// (`attn_kv_elems<T>(N)` elements per (image, head)) instead of shared memory.
template <typename T, bool KV_DEVICE>
__global__ void __launch_bounds__(kThreads)
vit_attn_i8_kernel(const T* __restrict__ x, const float* __restrict__ ns,
                   const float* __restrict__ nb,
                   const signed char* __restrict__ wq,
                   const float* __restrict__ ws, const float* __restrict__ bqkv,
                   float* __restrict__ ctx, T* kv, int N, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t image = static_cast<size_t>(b) * N * D;
  T* kv_head = KV_DEVICE ? kv + (static_cast<size_t>(b) * gridDim.x + h) *
                                    attn_kv_elems<T>(N)
                         : nullptr;
  QkvInt8<T> qkv(x + image, ns, nb, wq, ws, bqkv, N, D,
                 smem_raw + attn_core_bytes<T>(N, !KV_DEVICE));
  attn_head<T, float, KV_DEVICE>(qkv, ctx + image, h, N, D, smem_raw, kv_head);
}

// out = x + ls * (quant(ctx) Wp^T * scales + bp) for rows r0 .. r0 + 15.
template <typename T>
__global__ void __launch_bounds__(kThreads)
vit_proj_i8_kernel(const float* __restrict__ ctx, const T* __restrict__ x,
                   const signed char* __restrict__ wq,
                   const float* __restrict__ ws, const float* __restrict__ bp,
                   const float* __restrict__ ls, T* __restrict__ out, int R,
                   int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const QuantSmem sm(smem_raw, D);
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kBM, valid = min(kBM, R - r0);
  const float* ct = ctx + static_cast<size_t>(r0) * D;
  quant_rows([&](int m, int k) { return ct[static_cast<size_t>(m) * D + k]; },
             valid, D, sm.yq, sm.ys);
  for (int d0 = 0; d0 < D; d0 += kThreads) {
    int o[kBM];
#pragma unroll
    for (int r = 0; r < kBM; ++r) o[r] = 0;
    gemm_tile_i8<kThreads>(o, D, [&](int m, int k) {
      return *reinterpret_cast<const int*>(sm.yq + m * D + k);
    }, [&](int n) -> const signed char* {
      return d0 + n < D ? wq + static_cast<size_t>(d0 + n) * D : nullptr;
    }, sm.As8, sm.Ws8);
    const int n = d0 + t;
    if (n < D) {
      const float cs = ws[n], bias = bp[n], scale = ls[n];
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        if (r < valid) {
          const size_t at = static_cast<size_t>(r0 + r) * D + n;
          const float proj = __fmul_rn(rescale(o[r], sm.ys[r], cs, bias), scale);
          out[at] = from_float<T>(__fadd_rn(to_float(x[at]), proj));
        }
      }
    }
  }
}

// ---------------------------------------------------------------- MLP block
// 0.5 h (1 + erf(h / sqrt 2)) with the rational erf of the TPU kernels, or
// the tanh form; every operation rounded on its own.
template <int ACT>
__device__ __forceinline__ float gelu_i8(float h) {
  if (ACT == kGeluExact) {
    const float z = __fmul_rn(h, 0.7071067811865475f);
    const float ax = fabsf(z);
    const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, ax)));
    float poly = __fmul_rn(t, 1.061405429f);
    poly = __fmul_rn(t, __fadd_rn(-1.453152027f, poly));
    poly = __fmul_rn(t, __fadd_rn(1.421413741f, poly));
    poly = __fmul_rn(t, __fadd_rn(-0.284496736f, poly));
    poly = __fmul_rn(t, __fadd_rn(0.254829592f, poly));
    const float e = expf(-__fmul_rn(ax, ax));
    const float mag = __fsub_rn(1.f, __fmul_rn(poly, e));
    const float erf = z > 0.f ? mag : (z < 0.f ? -mag : 0.f);
    return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, erf));
  }
  const float cube = __fmul_rn(__fmul_rn(h, h), h);
  const float u = __fmul_rn(0.7978845608028654f,
                            __fadd_rn(h, __fmul_rn(0.044715f, cube)));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(u)));
  return __fmul_rn(h, cdf);
}

__device__ __forceinline__ float swiglu_i8(float gate, float val) {
  const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gate)));
  return __fmul_rn(__fmul_rn(gate, sig), val);
}

// out = x + ls * (fc2(quant(act(fc1(quant(LN(x)))))) + b2) for rows r0 ..
// r0 + 15 of the flattened (R, D) activation, the hidden activation quantised
// per row over each of `chunks` spans of H / chunks columns. w1: (H, D) codes
// or the packed (2H, D) for SwiGLU, gate rows first; w2: (D, H).
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
vit_mlp_i8_kernel(const T* __restrict__ x, const float* __restrict__ ns,
                  const float* __restrict__ nb,
                  const signed char* __restrict__ w1q,
                  const float* __restrict__ w1s, const float* __restrict__ b1,
                  const signed char* __restrict__ w2q,
                  const float* __restrict__ w2s, const float* __restrict__ b2,
                  const float* __restrict__ ls, T* __restrict__ out, int R,
                  int D, int H, int chunks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const QuantSmem sm(smem_raw, D);
  unsigned char* rest = smem_raw + QuantSmem::bytes(D);
  float* hs = reinterpret_cast<float*>(rest);                   // kBM
  unsigned* hmax = reinterpret_cast<unsigned*>(hs + kBM);       // kBM
  signed char* Hq = reinterpret_cast<signed char*>(rest + 128); // kBM x kLDHQ
  int* acc_i = reinterpret_cast<int*>(rest + 128 + align_up(kBM * kLDHQ));
  float* acc_f = reinterpret_cast<float*>(acc_i + kBM * D);     // if chunks > 1

  const int t = threadIdx.x, lane = t % 32;
  const int r0 = blockIdx.x * kBM, valid = min(kBM, R - r0);
  const T* xt = x + static_cast<size_t>(r0) * D;
  ln_stats64<T>(xt, valid, D, sm.mu_s, sm.rstd_s);
  quant_rows(LnRows64<T>{xt, ns, nb, sm.mu_s, sm.rstd_s, D}, valid, D, sm.yq,
             sm.ys);
  if (chunks > 1)
    for (int i = t; i < kBM * D; i += kThreads) acc_f[i] = 0.f;

  auto y_word = [&](int m, int k) {
    return *reinterpret_cast<const int*>(sm.yq + m * D + k);
  };
  // the activation of hidden column j for the 16 rows
  auto hidden = [&](int j, bool live, float (&hv)[kBM]) {
    int a1[kBM];
#pragma unroll
    for (int r = 0; r < kBM; ++r) a1[r] = 0;
    const int j0 = j - t;
    gemm_tile_i8<kHC>(a1, D, y_word, [&](int n) -> const signed char* {
      return j0 + n < H ? w1q + static_cast<size_t>(j0 + n) * D : nullptr;
    }, sm.As8, sm.Ws8);
    if (ACT == kSwiglu) {
      int a2[kBM];
#pragma unroll
      for (int r = 0; r < kBM; ++r) a2[r] = 0;
      gemm_tile_i8<kHC>(a2, D, y_word, [&](int n) -> const signed char* {
        return j0 + n < H ? w1q + static_cast<size_t>(H + j0 + n) * D : nullptr;
      }, sm.As8, sm.Ws8);
      const float sg = live ? w1s[j] : 0.f, bg = live ? b1[j] : 0.f;
      const float sv = live ? w1s[H + j] : 0.f, bv = live ? b1[H + j] : 0.f;
#pragma unroll
      for (int r = 0; r < kBM; ++r)
        hv[r] = live ? swiglu_i8(rescale(a1[r], sm.ys[r], sg, bg),
                                 rescale(a2[r], sm.ys[r], sv, bv)) : 0.f;
    } else {
      const float s1 = live ? w1s[j] : 0.f, bj = live ? b1[j] : 0.f;
#pragma unroll
      for (int r = 0; r < kBM; ++r)
        hv[r] = live ? gelu_i8<ACT>(rescale(a1[r], sm.ys[r], s1, bj)) : 0.f;
    }
  };

  const int span = H / chunks;
  for (int c0 = 0; c0 < H; c0 += span) {
    for (int i = t; i < kBM * D; i += kThreads) acc_i[i] = 0;
    if (t < kBM) hmax[t] = 0u;
    __syncthreads();
    // pass 1: each row's abs-max over the chunk (a max of non-negative
    // floats is a max of their bit patterns, in any order)
    for (int hc = c0; hc < c0 + span; hc += kHC) {
      float hv[kBM];
      hidden(hc + t, hc + t < c0 + span, hv);
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        const float m = warp_max(fabsf(hv[r]));
        if (lane == 0) atomicMax(&hmax[r], __float_as_uint(m));
      }
    }
    __syncthreads();
    if (t < kBM) hs[t] = quant_scale(__uint_as_float(hmax[t]));
    __syncthreads();
    // pass 2: the same values again, quantised, into fc2
    for (int hc = c0; hc < c0 + span; hc += kHC) {
      float hv[kBM];
      hidden(hc + t, hc + t < c0 + span, hv);
#pragma unroll
      for (int r = 0; r < kBM; ++r)
        Hq[r * kLDHQ + t] = static_cast<signed char>(quant_code(hv[r], hs[r]));
      __syncthreads();   // the quantised piece is complete
      const int kc = min(kHC, c0 + span - hc);
      for (int d0 = 0; d0 < D; d0 += kHC) {
        int o[kBM];
#pragma unroll
        for (int r = 0; r < kBM; ++r) o[r] = 0;
        gemm_tile_i8<kHC>(o, kc, [&](int m, int k) {
          return *reinterpret_cast<const int*>(Hq + m * kLDHQ + k);
        }, [&](int n) -> const signed char* {
          return d0 + n < D ? w2q + static_cast<size_t>(d0 + n) * H + hc : nullptr;
        }, sm.As8, sm.Ws8);
        if (d0 + t < D) {
#pragma unroll
          for (int r = 0; r < kBM; ++r) acc_i[r * D + d0 + t] += o[r];
        }
      }
    }
    __syncthreads();
    if (chunks > 1) {
      for (int i = t; i < kBM * D; i += kThreads) {
        const float f2 = __fmul_rn(__fmul_rn(static_cast<float>(acc_i[i]),
                                             hs[i / D]), w2s[i % D]);
        acc_f[i] = __fadd_rn(acc_f[i], f2);
      }
      __syncthreads();
    }
  }
  for (int i = t; i < valid * D; i += kThreads) {
    const int m = i / D, d = i % D;
    const float sum = chunks > 1 ? acc_f[i] : __fmul_rn(
        __fmul_rn(static_cast<float>(acc_i[i]), hs[m]), w2s[d]);
    const float branch = __fmul_rn(__fadd_rn(sum, b2[d]), ls[d]);
    const size_t at = static_cast<size_t>(r0) * D + i;
    out[at] = from_float<T>(__fadd_rn(to_float(x[at]), branch));
  }
}

// ------------------------------------------------------------------ launch
template <typename T>
size_t attn_i8_smem(int N, int D, bool kv_in_smem) {
  return attn_core_bytes<T>(N, kv_in_smem) + QuantSmem::bytes(D);
}

// K and V stay in shared memory where they fit beside the rest.
template <typename T>
bool kv_in_smem(int N, int D) {
  return attn_i8_smem<T>(N, D, true) <= kMaxSmem;
}

template <typename T>
size_t attn_i8_kv_bytes(int B, int N, int D, int heads) {
  return kv_in_smem<T>(N, D) ? 0
                             : static_cast<size_t>(B) * heads *
                                   attn_kv_elems<T>(N) * sizeof(T);
}

size_t mlp_i8_smem(int D, int chunks) {
  return QuantSmem::bytes(D) + 128 + align_up(kBM * kLDHQ) +
         static_cast<size_t>(chunks > 1 ? 2 : 1) * kBM * D * sizeof(int);
}

template <typename T, bool KV_DEVICE>
cudaError_t launch_attn_core(const void* x, const float* ns, const float* nb,
                             const signed char* wq, const float* ws,
                             const float* bqkv, float* ctx, void* kv, int B,
                             int N, int D, int heads, size_t smem,
                             cudaStream_t stream) {
  const cudaError_t rc = allow_smem(vit_attn_i8_kernel<T, KV_DEVICE>, smem);
  if (rc != cudaSuccess) return rc;
  vit_attn_i8_kernel<T, KV_DEVICE><<<dim3(heads, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), ns, nb, wq, ws, bqkv, ctx, static_cast<T*>(kv), N, D);
  return cudaGetLastError();
}

template <typename T>
int launch_attn_i8(const void* x, const float* ns, const float* nb,
                   const signed char* wq, const float* ws, const float* bqkv,
                   const signed char* pq, const float* ps, const float* bp,
                   const float* ls, float* ctx, void* kv, void* out, int B,
                   int N, int D, int heads, cudaStream_t stream) {
  if (heads * kHD != D || D % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = kv_in_smem<T>(N, D);
  const size_t smem_a = attn_i8_smem<T>(N, D, in_smem), smem_p = QuantSmem::bytes(D);
  if (smem_a > kMaxSmem || (!in_smem && kv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = allow_smem(vit_proj_i8_kernel<T>, smem_p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = in_smem ? launch_attn_core<T, false>(x, ns, nb, wq, ws, bqkv, ctx, kv, B,
                                            N, D, heads, smem_a, stream)
               : launch_attn_core<T, true>(x, ns, nb, wq, ws, bqkv, ctx, kv, B,
                                           N, D, heads, smem_a, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int R = B * N;
  vit_proj_i8_kernel<T><<<(R + kBM - 1) / kBM, kThreads, smem_p, stream>>>(
      ctx, static_cast<const T*>(x), pq, ps, bp, ls, static_cast<T*>(out), R, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT>
int launch_mlp_i8(const void* x, const float* ns, const float* nb,
                  const signed char* w1q, const float* w1s, const float* b1,
                  const signed char* w2q, const float* w2s, const float* b2,
                  const float* ls, void* out, int R, int D, int H, int chunks,
                  cudaStream_t stream) {
  if (D % kBK != 0 || chunks < 1 || H % chunks != 0 || (H / chunks) % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mlp_i8_smem(D, chunks);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = allow_smem(vit_mlp_i8_kernel<T, ACT>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  vit_mlp_i8_kernel<T, ACT><<<(R + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ns, nb, w1q, w1s, b1, w2q, w2s, b2, ls,
      static_cast<T*>(out), R, D, H, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_mlp_i8(int act, const void* x, const float* ns, const float* nb,
                    const signed char* w1q, const float* w1s, const float* b1,
                    const signed char* w2q, const float* w2s, const float* b2,
                    const float* ls, void* out, int R, int D, int H, int chunks,
                    cudaStream_t s) {
  switch (act) {
    case kGeluExact:
      return launch_mlp_i8<T, kGeluExact>(x, ns, nb, w1q, w1s, b1, w2q, w2s, b2,
                                          ls, out, R, D, H, chunks, s);
    case kGeluTanh:
      return launch_mlp_i8<T, kGeluTanh>(x, ns, nb, w1q, w1s, b1, w2q, w2s, b2,
                                         ls, out, R, D, H, chunks, s);
    case kSwiglu:
      return launch_mlp_i8<T, kSwiglu>(x, ns, nb, w1q, w1s, b1, w2q, w2s, b2,
                                       ls, out, R, D, H, chunks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x and out). Weight codes are int8 (out, in),
// weight scales, norm scale/bias, biases and LayerScale f32. ctx is f32
// scratch of x's shape; kv is scratch of `paths_vit_attn_i8_kv_bytes` bytes
// (none when that is 0: K and V fit shared memory).
extern "C" int paths_vit_attn_block_i8(
    const void* x, const float* norm_scale, const float* norm_bias,
    const signed char* qkv_q, const float* qkv_s, const float* qkv_b,
    const signed char* proj_q, const float* proj_s, const float* proj_b,
    const float* ls, float* ctx, void* kv, void* out, int B, int N, int D,
    int heads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_attn_i8<float>(x, norm_scale, norm_bias, qkv_q, qkv_s, qkv_b,
                                   proj_q, proj_s, proj_b, ls, ctx, kv, out, B,
                                   N, D, heads, s);
    case 1:
      return launch_attn_i8<__nv_bfloat16>(x, norm_scale, norm_bias, qkv_q,
                                           qkv_s, qkv_b, proj_q, proj_s, proj_b,
                                           ls, ctx, kv, out, B, N, D, heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// act: 0 = exact (rational erf) GELU, 1 = tanh GELU, 2 = packed SwiGLU
// (fc1 is (2H, D), gate rows first). x is (R, D), R = B N; the hidden
// activation is quantised over `chunks` spans of H / chunks columns.
extern "C" int paths_vit_mlp_block_i8(
    const void* x, const float* norm_scale, const float* norm_bias,
    const signed char* fc1_q, const float* fc1_s, const float* fc1_b,
    const signed char* fc2_q, const float* fc2_s, const float* fc2_b,
    const float* ls, void* out, int R, int D, int H, int act, int chunks,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_mlp_i8<float>(act, x, norm_scale, norm_bias, fc1_q, fc1_s,
                                    fc1_b, fc2_q, fc2_s, fc2_b, ls, out, R, D,
                                    H, chunks, s);
    case 1:
      return dispatch_mlp_i8<__nv_bfloat16>(act, x, norm_scale, norm_bias, fc1_q,
                                            fc1_s, fc1_b, fc2_q, fc2_s, fc2_b,
                                            ls, out, R, D, H, chunks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory of the attention kernel for N tokens at width D: with K and
// V in it where they fit, else without them.
extern "C" long long paths_vit_attn_i8_smem_bytes(int N, int D, int dtype) {
  return static_cast<long long>(
      dtype == 0 ? attn_i8_smem<float>(N, D, kv_in_smem<float>(N, D))
                 : attn_i8_smem<__nv_bfloat16>(N, D, kv_in_smem<__nv_bfloat16>(N, D)));
}

// Bytes of device memory K and V of every (image, head) need when they do
// not fit shared memory, else 0.
extern "C" long long paths_vit_attn_i8_kv_bytes(int B, int N, int D, int heads,
                                                int dtype) {
  return static_cast<long long>(
      dtype == 0 ? attn_i8_kv_bytes<float>(B, N, D, heads)
                 : attn_i8_kv_bytes<__nv_bfloat16>(B, N, D, heads));
}

extern "C" long long paths_vit_mlp_i8_smem_bytes(int D, int chunks) {
  return static_cast<long long>(mlp_i8_smem(D, chunks));
}

extern "C" long long paths_vit_max_smem_bytes() {
  return static_cast<long long>(kMaxSmem);
}

extern "C" const char* paths_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

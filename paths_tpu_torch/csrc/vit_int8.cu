// Int8 fused ViT encoder-block kernels for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernels of `paths_tpu/kernels/vit_int8.py`:
//   fused_attn_block_i8        (body `_attn_kernel_i8`):   LN-quant, qkv s8 GEMM,
//                                                          streamed attention,
//                                                          quantise, proj s8 GEMM
//   fused_mlp_block_i8         (body `_mlp_kernel_i8`):    LN-quant, per row slab
//                                                          s8 fc1 GEMM + GELU
//                                                          and quantise, fc2 s8
//                                                          GEMM + residual
//   fused_swiglu_mlp_block_i8  (body `_swiglu_kernel_i8`): the same with the
//                                                          gated fc1 GEMM +
//                                                          SwiGLU
// for x (B, N, D) contiguous in T (f32 or bf16). The four projections (qkv,
// out, fc1, fc2) multiply int8 activations with int8 weights into int32 on
// the tensor cores; weights are (out, in) int8 with one f32 scale per output
// channel, quantised once on the host; LayerNorm scale/bias, biases and
// LayerScale are f32. The attention itself (q k^T, softmax, P V) runs in T.
//
// Arithmetic, as in the TPU kernels. Activations are quantised per row:
// s = max|y| * (1/127), s = 1 for a row of zeros, code = clip(rint(y / s),
// -127, 127), with a true division and round-half-even. What is quantised is
// f32: the LayerNorm output (not rounded to T), each row of the context
// c_h / l (not rounded), and the hidden activation, per row and per chunk of
// H / num_chunks columns. A product is rescaled as float(acc) * row scale *
// channel scale + bias, every operation rounded on its own (no fused
// multiply-add), so that a plain PyTorch version can repeat it to the bit;
// with several chunks the fc2 sums of the chunks are added in f32, chunk by
// chunk. GELU is the rational erf of the TPU kernels (Abramowitz-Stegun
// 7.1.26), not `erff`; SwiGLU is gate / (1 + exp(-gate)) * value.
//
// Quantisation is discontinuous, so a LayerNorm summed in another order could
// move an activation across a rounding boundary and with it a whole output
// row. The LayerNorm before a quantisation is therefore evaluated in f64 and
// rounded to f32 once: two implementations then agree on every code unless a
// value lies within 1e-16 of a boundary.
//
// Design (pieces in `vit_tiles.cuh`). The work is cut as the
// bf16 blocks of `vit_fused.cu` cut it, with int8 operands:
//  * LN-quant once per row (`ln_quant_rows_kernel`, one warp per row, the row
//    read once into registers): the f64 LayerNorm, the row's abs-max and its
//    codes, (M, D) int8 plus one scale per row, so that every GEMM reads a
//    plain operand. `quant_rows_kernel` (a warp or a block per row span, the
//    span read once into registers) does the same for f32 rows.
//  * Projections as s8 GEMMs over all B N rows in 128 x 128 output tiles
//    (`tiles::gemm_tma<signed char>`): TMA brings slabs of 128 codes, two
//    consumer warpgroups multiply them with `wgmma` m64n128k32 into s32, and
//    each staged weight byte feeds 128 rows. The epilogues rescale from the
//    accumulators: qkv + bias rounded to T into a (B, N, 3D) scratch;
//    out / fc2 + bias, LayerScale and the residual into out; fc1 + bias into
//    its GELU in f32 (#9), or the packed fc1 (#10: gate rows first, gated
//    tile: 64 gate rows above the same 64 value rows) into silu(gate) value
//    in f32.
//  * Attention: #4's streamed-key tiles read q, k, v from the qkv scratch
//    (any N, so the patch-8 Kaiko models' 785 tokens), with the context
//    stored in f32, unrounded; `quant_rows_kernel` then quantises it.
//  * The MLP's hidden activation goes through device memory in f32 (its row
//    scale is the abs-max over a chunk, known only once the chunk is
//    complete), a slab of at most `slab` rows (the wrapper's choice) at a
//    time: per slab fc1 (GELU or gated SwiGLU) writes h (slab, H) f32 and
//    `quant_rows_kernel` turns it into codes and a scale per row and chunk.
//    fc2 then runs once over all rows (per slab its D / 128 column tiles
//    would leave most of the card idle). That bounds the f32 scratch at
//    slab x H x 4 bytes; the codes take one byte per hidden value of every
//    row. With more than one chunk, fc2 is the CHUNKED GEMM: its consumers
//    add each chunk's rescaled sum to an f32 total at the chunk's boundary.
//  * No split-K; the abs-maxes are plain reductions within a warp: two calls
//    are bitwise equal.
//
// Bound on the card: the projections at the int8 tensor-core rate, the
// attention's two products at T's rate (bf16 tensor cores; f32 FMAs). Each
// staged weight byte feeds 128 rows, so the weights cross from L2 once per
// 128-row tile; the f32 hidden activation crosses device memory twice
// (written by fc1, read by the quantiser) and its codes twice.
//
// Requirements (checked by the Python wrapper): head_dim 64, D % 64 == 0,
// H / num_chunks a multiple of 64, 16-byte aligned contiguous tensors.
//
// C interface (loaded through ctypes): the launch entries return the
// cudaError_t of the first launch that failed (0 on success).

#include <algorithm>

#include "vit_tiles.cuh"

namespace {

using namespace paths_cuda;
using namespace paths_cuda::vit;

__device__ __forceinline__ double warp_sum64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quant_scale(float amax) {
  const float s = __fmul_rn(amax, 0.007874015748031496f);   // max|y| * (1/127)
  return s > 0.f ? s : 1.f;
}

__device__ __forceinline__ int quant_code(float y, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f));
}

// ------------------------------------------------------------- activations
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

// ----------------------------------------------------------- row quantisers
constexpr int kRowThreads = 256;
constexpr int kRowsPerBlock = kRowThreads / 32;   // with one warp per row
constexpr int kLnPieces = 12;   // 4-value pieces a lane keeps: rows up to 1536
constexpr int kQuantPieces = 12; // 4-value pieces a thread keeps

// Four values of row p.. as f32 (8 bytes of bf16, 16 of f32).
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&o)[4]) {
  if constexpr (sizeof(T) == 2) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = to_float(e[i]);
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
}

__device__ __forceinline__ int pack_codes(const float (&v)[4], float s) {
  return (quant_code(v[0], s) & 0xff) | (quant_code(v[1], s) & 0xff) << 8 |
         (quant_code(v[2], s) & 0xff) << 16 | (quant_code(v[3], s) & 0xff) << 24;
}

// codes q (R, D) int8 and scales qs (R) of LN(x), one warp per row: the
// LayerNorm in f64 (mean, then 1/sqrt(var + eps)), each of its operations
// rounded on its own, then rounded to f32 once. A row of up to 128 kLnPieces values is
// read once into registers (lane l keeps columns 4 l + 128 j ..+ 3); a
// longer one is read again for each pass. D % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, signed char* __restrict__ q,
                     float* __restrict__ qs, int R, int D) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= R) return;
  const T* xr = x + static_cast<size_t>(row) * D;
  int* qr = reinterpret_cast<int*>(q + static_cast<size_t>(row) * D);
  // LN(x) at column k of value xv, rounded to f32 once
  double mu = 0.0, rstd = 0.0;
  auto ln = [&](float xv, int k) {
    const double y = __dmul_rn(__dsub_rn(static_cast<double>(xv), mu), rstd);
    return static_cast<float>(__dadd_rn(__dmul_rn(y, static_cast<double>(scale[k])),
                                        static_cast<double>(bias[k])));
  };
  float amax = 0.f;
  if (D <= 128 * kLnPieces) {
    float v[kLnPieces][4];
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < kLnPieces; ++j) {
      if (4 * lane + 128 * j < D) {
        load4(xr + 4 * lane + 128 * j, v[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) s += static_cast<double>(v[j][i]);
      }
    }
    mu = warp_sum64(s) / D;
    double var = 0.0;
#pragma unroll
    for (int j = 0; j < kLnPieces; ++j)
      if (4 * lane + 128 * j < D) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double d = static_cast<double>(v[j][i]) - mu;
          var += d * d;
        }
      }
    rstd = 1.0 / sqrt(warp_sum64(var) / D + 1e-6);
#pragma unroll
    for (int j = 0; j < kLnPieces; ++j)
      if (4 * lane + 128 * j < D) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[j][i] = ln(v[j][i], 4 * lane + 128 * j + i);
          amax = fmaxf(amax, fabsf(v[j][i]));
        }
      }
    const float sc = quant_scale(warp_max(amax));
#pragma unroll
    for (int j = 0; j < kLnPieces; ++j)
      if (4 * lane + 128 * j < D) qr[lane + 32 * j] = pack_codes(v[j], sc);
    if (lane == 0) qs[row] = sc;
    return;
  }
  double s = 0.0;
  for (int k = 4 * lane; k < D; k += 128) {
    float v[4];
    load4(xr + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) s += static_cast<double>(v[i]);
  }
  mu = warp_sum64(s) / D;
  double var = 0.0;
  for (int k = 4 * lane; k < D; k += 128) {
    float v[4];
    load4(xr + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double d = static_cast<double>(v[i]) - mu;
      var += d * d;
    }
  }
  rstd = 1.0 / sqrt(warp_sum64(var) / D + 1e-6);
  for (int k = 4 * lane; k < D; k += 128) {
    float v[4];
    load4(xr + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(ln(v[i], k + i)));
  }
  const float sc = quant_scale(warp_max(amax));
  for (int k = 4 * lane; k < D; k += 128) {
    float v[4];
    load4(xr + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = ln(v[i], k + i);
    qr[k / 4] = pack_codes(v, sc);
  }
  if (lane == 0) qs[row] = sc;
}

// codes q (R, D) int8 of the f32 rows y (R, D), quantised per row over each
// span of `span` columns, with the scales qs (R, D / span) row-major; TPS
// threads per row span (a warp, or the whole block for a long span). A span
// of up to 4 TPS kQuantPieces values is read once into registers (thread t
// keeps columns 4 t + 4 TPS j .. + 3); a longer one is read twice.
// span % 4 == 0, 16-byte aligned rows.
template <int TPS>
__global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const float* __restrict__ y, signed char* __restrict__ q,
                  float* __restrict__ qs, long long segs, int D, int span) {
  constexpr int STEP = 4 * TPS;
  __shared__ float part[kRowThreads / 32];
  const int t = threadIdx.x % TPS, spans = D / span;
  const long long seg =
      static_cast<long long>(blockIdx.x) * (kRowThreads / TPS) + threadIdx.x / TPS;
  if (seg >= segs) return;   // whole warps: TPS is 32 or the block
  const size_t at = static_cast<size_t>(seg / spans) * D + seg % spans * span;
  const float* yr = y + at;
  int* qr = reinterpret_cast<int*>(q + at);
  const bool cached = span <= STEP * kQuantPieces;
  float v[kQuantPieces][4];
  float amax = 0.f;
  if (cached) {
#pragma unroll
    for (int j = 0; j < kQuantPieces; ++j)
      if (4 * t + STEP * j < span) {
        load4(yr + 4 * t + STEP * j, v[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(v[j][i]));
      }
  } else {
    for (int k = 4 * t; k < span; k += STEP) {
      float u[4];
      load4(yr + k, u);
#pragma unroll
      for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(u[i]));
    }
  }
  amax = warp_max(amax);
  if constexpr (TPS > 32) {
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < TPS / 32; ++w) amax = fmaxf(amax, part[w]);
  }
  const float sc = quant_scale(amax);
  if (cached) {
#pragma unroll
    for (int j = 0; j < kQuantPieces; ++j)
      if (4 * t + STEP * j < span) qr[t + TPS * j] = pack_codes(v[j], sc);
  } else {
    for (int k = 4 * t; k < span; k += STEP) {
      float u[4];
      load4(yr + k, u);
      qr[k / 4] = pack_codes(u, sc);
    }
  }
  if (t == 0) qs[seg] = sc;
}

// ------------------------------------------------------------ GEMM epilogues
// float(acc) * row scale * channel scale, each product rounded: the int32 sum
// converts to the nearest float, as the plain version's exact sum does.
__device__ __forceinline__ float dequant(int acc, float row_s, float chan_s) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), row_s), chan_s);
}

// qkv: dequant + bias (the GEMM rounds it to T)
struct EpiQkvI8 {
  const float* rs;     // (M) row scales
  const float* cs;     // (N) channel scales
  const float* bias;   // (N)
  __device__ __forceinline__ float operator()(int row, int col, int acc) const {
    return __fadd_rn(dequant(acc, rs[row], cs[col]), bias[col]);
  }
};

// out projection and fc2: resid + (sum + bias) ls, where sum is the dequantised
// product, or with `chunks` > 1 (the CHUNKED GEMM) the f32 sum of the
// products of the chunks of `span` columns, each with its own row scale
template <typename T>
struct EpiResidualI8 {
  const T* resid;      // (M, ld)
  const float* rs;     // (M, chunks) row scales
  const float* cs;     // (N) channel scales
  const float* bias;   // (N)
  const float* ls;     // (N)
  int ld, chunks, span;
  __device__ __forceinline__ float chunk(int row, int col, int c, int acc) const {
    return dequant(acc, rs[static_cast<size_t>(row) * chunks + c], cs[col]);
  }
  __device__ __forceinline__ float finish(int row, int col, float sum) const {
    return __fadd_rn(to_float(resid[static_cast<size_t>(row) * ld + col]),
                     __fmul_rn(__fadd_rn(sum, bias[col]), ls[col]));
  }
  __device__ __forceinline__ float operator()(int row, int col, int acc) const {
    return finish(row, col, chunk(row, col, 0, acc));
  }
};

// fc1 (H, D): gelu_i8 of the dequantised product + bias
template <int ACT>
struct EpiGeluI8 {
  const float* rs;     // (M) row scales
  const float* cs;     // (H) channel scales
  const float* bias;   // (H)
  __device__ __forceinline__ float operator()(int row, int col, int acc) const {
    return gelu_i8<ACT>(__fadd_rn(dequant(acc, rs[row], cs[col]), bias[col]));
  }
};

// packed fc1 (2H, D), gate rows first: swiglu_i8 of the dequantised gate
// (column col) and value (column H + col), each with its bias
struct EpiSwigluI8 {
  static constexpr bool kGated = true;
  const float* rs;     // (M) row scales
  const float* cs;     // (2H) channel scales
  const float* bias;   // (2H)
  int H;
  __device__ __forceinline__ float operator()(int row, int col, int gate,
                                              int val) const {
    const float r = rs[row];
    return swiglu_i8(__fadd_rn(dequant(gate, r, cs[col]), bias[col]),
                     __fadd_rn(dequant(val, r, cs[H + col]), bias[H + col]));
  }
};

// ------------------------------------------------- #8: streamed attention
// #4's attention tiles, the context stored in f32; blockIdx = (query tile,
// head, image)
__global__ void __launch_bounds__(tiles::kAttnThreadsBf16)
attn_i8_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, float* __restrict__ ctx,
                    int N, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tiles::attn_tile_bf16<false, float>(qkv, ctx, blockIdx.z, blockIdx.y,
                                      blockIdx.x * tiles::kQTBf16, N, D, smem_raw);
}

__global__ void __launch_bounds__(tiles::kAttnThreadsF32)
attn_i8_f32_kernel(const float* __restrict__ qkv, float* __restrict__ ctx, int N,
                   int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tiles::attn_tile_f32<false>(qkv, ctx, blockIdx.z, blockIdx.y,
                              blockIdx.x * tiles::kQT, N, D, smem_raw);
}

// ------------------------------------------------------------------ launch
template <typename T>
cudaError_t ln_quant(const T* x, const float* ns, const float* nb, signed char* q,
                     float* qs, int R, int D, cudaStream_t s) {
  ln_quant_rows_kernel<T><<<(R + kRowsPerBlock - 1) / kRowsPerBlock, kRowThreads, 0,
                            s>>>(x, ns, nb, q, qs, R, D);
  return cudaGetLastError();
}

// a warp per span where a warp's registers hold it (the context's D), the
// block per span for the hidden activation's longer spans
cudaError_t quant(const float* y, signed char* q, float* qs, int R, int D, int span,
                  cudaStream_t s) {
  const long long segs = static_cast<long long>(R) * (D / span);
  if (span <= 4 * 32 * kQuantPieces)
    quant_rows_kernel<32><<<static_cast<unsigned>((segs + kRowsPerBlock - 1) / kRowsPerBlock),
                            kRowThreads, 0, s>>>(y, q, qs, segs, D, span);
  else
    quant_rows_kernel<kRowThreads><<<static_cast<unsigned>(segs), kRowThreads, 0, s>>>(
        y, q, qs, segs, D, span);
  return cudaGetLastError();
}

// ctx (B, N, D) f32 from qkv (B, N, 3D) in T, every head
template <typename T>
cudaError_t attention_f32_ctx(const T* qkv, float* ctx, int B, int N, int D,
                              int heads, cudaStream_t s) {
  constexpr int QT = tiles::kTensor<T> ? tiles::kQTBf16 : tiles::kQT;
  const dim3 grid((N + QT - 1) / QT, heads, B);
  cudaError_t rc;
  if constexpr (tiles::kTensor<T>) {
    if ((rc = allow_smem(attn_i8_bf16_kernel, tiles::kAttnSmemBf16)) != cudaSuccess)
      return rc;
    attn_i8_bf16_kernel<<<grid, tiles::kAttnThreadsBf16, tiles::kAttnSmemBf16, s>>>(
        qkv, ctx, N, D);
  } else {
    if ((rc = allow_smem(attn_i8_f32_kernel, tiles::kAttnSmemF32)) != cudaSuccess)
      return rc;
    attn_i8_f32_kernel<<<grid, tiles::kAttnThreadsF32, tiles::kAttnSmemF32, s>>>(
        qkv, ctx, N, D);
  }
  return cudaGetLastError();
}

// The tensors of one int8 block call, in the order of its C entry. Scratch:
// codes (B N, D) int8 and scales (B N) f32 (the LayerNorm's, then the
// context's); #8: qkv (B, N, 3D) in T and ctx (B, N, D) f32; #9 and #10:
// hidden (slab, H) f32, and the hidden codes (B N, H) int8 and scales
// (B N, chunks) f32.
struct I8Args {
  const void* x;
  const float *ns, *nb;
  const signed char* w1q;   // qkv or fc1
  const float *w1s, *b1;
  const signed char* w2q;   // proj or fc2
  const float *w2s, *b2, *ls;
  signed char* codes;
  float* scales;
  void* qkv;
  float* ctx;
  float* hidden;
  signed char* hcodes;
  float* hscales;
  void* out;
  int B, N, D, heads, H, chunks, slab;
};

// #8: LN-quant, qkv GEMM, attention, quantise the context, out-projection
// GEMM with LayerScale and the residual: five launches
template <typename T>
int launch_attn_i8(const I8Args& a, cudaStream_t s) {
  const int R = a.B * a.N, D = a.D;
  if (a.heads * kHD != D || D % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  cudaError_t rc;
  if ((rc = ln_quant<T>(x, a.ns, a.nb, a.codes, a.scales, R, D, s)) != cudaSuccess)
    return static_cast<int>(rc);
  if ((rc = tiles::gemm_tma<signed char>(a.codes, a.w1q, qkv, R, 3 * D, D,
                                         EpiQkvI8{a.scales, a.w1s, a.b1}, s)) != cudaSuccess)
    return static_cast<int>(rc);
  if ((rc = attention_f32_ctx<T>(qkv, a.ctx, a.B, a.N, D, a.heads, s)) != cudaSuccess)
    return static_cast<int>(rc);
  if ((rc = quant(a.ctx, a.codes, a.scales, R, D, D, s)) != cudaSuccess)
    return static_cast<int>(rc);
  return static_cast<int>(tiles::gemm_tma<signed char>(
      a.codes, a.w2q, static_cast<T*>(a.out), R, D, D,
      EpiResidualI8<T>{x, a.scales, a.w2s, a.b2, a.ls, D, 1, D}, s));
}

// #9 and #10: LN-quant over all rows; per slab of a.slab rows the fc1 GEMM
// (`fc1`: the GELU epilogue over W (H, D), or the gated SwiGLU one over the
// packed W (2H, D); hidden in f32) and the hidden activation's codes per row
// and chunk; then one fc2 GEMM over all rows with LayerScale and the
// residual (CHUNKED where there is more than one chunk): 2 + 2 launches per
// slab. fc2 has only D / 128 column tiles, so it runs over all rows at once:
// per slab it would fill a fraction of the card's blocks.
template <typename T, typename Fc1>
int launch_mlp_i8(const I8Args& a, Fc1 fc1, cudaStream_t s) {
  const int R = a.B * a.N, D = a.D, H = a.H;
  if (D % 64 != 0 || a.chunks < 1 || H % a.chunks != 0 || (H / a.chunks) % 64 != 0 ||
      a.slab < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int span = H / a.chunks;
  const T* x = static_cast<const T*>(a.x);
  cudaError_t rc;
  if ((rc = ln_quant<T>(x, a.ns, a.nb, a.codes, a.scales, R, D, s)) != cudaSuccess)
    return static_cast<int>(rc);
  for (int r0 = 0; r0 < R; r0 += a.slab) {
    const int rows = std::min(a.slab, R - r0);
    fc1.rs = a.scales + r0;
    if ((rc = tiles::gemm_tma<signed char>(a.codes + static_cast<size_t>(r0) * D,
                                           a.w1q, a.hidden, rows, H, D, fc1, s)) !=
        cudaSuccess)
      return static_cast<int>(rc);
    if ((rc = quant(a.hidden, a.hcodes + static_cast<size_t>(r0) * H,
                    a.hscales + static_cast<size_t>(r0) * a.chunks, rows, H, span,
                    s)) != cudaSuccess)
      return static_cast<int>(rc);
  }
  const EpiResidualI8<T> epi{x, a.hscales, a.w2s, a.b2, a.ls, D, a.chunks, span};
  T* out = static_cast<T*>(a.out);
  rc = a.chunks > 1
           ? tiles::gemm_tma<signed char, true>(a.hcodes, a.w2q, out, R, D, H, epi, s)
           : tiles::gemm_tma<signed char>(a.hcodes, a.w2q, out, R, D, H, epi, s);
  return static_cast<int>(rc);
}

// #9 with the GELU of `act` (0 exact, 1 tanh)
template <typename T>
int launch_gelu_mlp_i8(const I8Args& a, int act, cudaStream_t s) {
  switch (act) {
    case kGeluExact:
      return launch_mlp_i8<T>(a, EpiGeluI8<kGeluExact>{nullptr, a.w1s, a.b1}, s);
    case kGeluTanh:
      return launch_mlp_i8<T>(a, EpiGeluI8<kGeluTanh>{nullptr, a.w1s, a.b1}, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The MLP blocks' tensors in the order of their C entries (fc1 (H, D) for
// #9, packed (2H, D) for #10); x is (R, D), R = B N.
I8Args mlp_args(const void* x, const float* ns, const float* nb,
                const signed char* fc1_q, const float* fc1_s, const float* fc1_b,
                const signed char* fc2_q, const float* fc2_s, const float* fc2_b,
                const float* ls, signed char* codes, float* scales, float* hidden,
                signed char* hcodes, float* hscales, void* out, int R, int D,
                int H, int chunks, int slab) {
  I8Args a{};
  a.x = x;
  a.ns = ns;
  a.nb = nb;
  a.w1q = fc1_q;
  a.w1s = fc1_s;
  a.b1 = fc1_b;
  a.w2q = fc2_q;
  a.w2s = fc2_s;
  a.b2 = fc2_b;
  a.ls = ls;
  a.codes = codes;
  a.scales = scales;
  a.hidden = hidden;
  a.hcodes = hcodes;
  a.hscales = hscales;
  a.out = out;
  a.B = 1;
  a.N = R;
  a.D = D;
  a.H = H;
  a.chunks = chunks;
  a.slab = slab;
  return a;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, qkv and out). Weight codes are int8 (out,
// in), weight scales, norm scale/bias, biases and LayerScale f32. Scratch:
// codes (B N, D) int8, scales (B N) f32, qkv (B, N, 3D) in x's dtype, ctx
// (B, N, D) f32.
extern "C" int paths_vit_attn_block_i8(
    const void* x, const float* norm_scale, const float* norm_bias,
    const signed char* qkv_q, const float* qkv_s, const float* qkv_b,
    const signed char* proj_q, const float* proj_s, const float* proj_b,
    const float* ls, signed char* codes, float* scales, void* qkv, float* ctx,
    void* out, int B, int N, int D, int heads, int dtype, void* stream) {
  I8Args a{};
  a.x = x;
  a.ns = norm_scale;
  a.nb = norm_bias;
  a.w1q = qkv_q;
  a.w1s = qkv_s;
  a.b1 = qkv_b;
  a.w2q = proj_q;
  a.w2s = proj_s;
  a.b2 = proj_b;
  a.ls = ls;
  a.codes = codes;
  a.scales = scales;
  a.qkv = qkv;
  a.ctx = ctx;
  a.out = out;
  a.B = B;
  a.N = N;
  a.D = D;
  a.heads = heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_attn_i8<float>(a, s);
    case 1:
      return launch_attn_i8<__nv_bfloat16>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The int8 GELU MLP block, act: 0 = exact (rational erf) GELU, 1 = tanh GELU;
// and the packed SwiGLU MLP block (fc1 (2H, D), gate rows first). Both make
// their f32 hidden activation a slab of `slab` rows at a time; x is (R, D),
// R = B N, the hidden activation quantised over `chunks` spans of H / chunks
// columns. Scratch: codes (R, D) int8, scales (R) f32, hidden (min(slab, R),
// H) f32, hcodes (R, H) int8, hscales (R, chunks) f32.
extern "C" int paths_vit_mlp_block_i8(
    const void* x, const float* norm_scale, const float* norm_bias,
    const signed char* fc1_q, const float* fc1_s, const float* fc1_b,
    const signed char* fc2_q, const float* fc2_s, const float* fc2_b,
    const float* ls, signed char* codes, float* scales, float* hidden,
    signed char* hcodes, float* hscales, void* out, int R, int D, int H, int act,
    int chunks, int slab, int dtype, void* stream) {
  const I8Args a = mlp_args(x, norm_scale, norm_bias, fc1_q, fc1_s, fc1_b, fc2_q,
                            fc2_s, fc2_b, ls, codes, scales, hidden, hcodes,
                            hscales, out, R, D, H, chunks, slab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_gelu_mlp_i8<float>(a, act, s);
    case 1:
      return launch_gelu_mlp_i8<__nv_bfloat16>(a, act, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int paths_vit_swiglu_mlp_block_i8(
    const void* x, const float* norm_scale, const float* norm_bias,
    const signed char* fc1_q, const float* fc1_s, const float* fc1_b,
    const signed char* fc2_q, const float* fc2_s, const float* fc2_b,
    const float* ls, signed char* codes, float* scales, float* hidden,
    signed char* hcodes, float* hscales, void* out, int R, int D, int H,
    int chunks, int slab, int dtype, void* stream) {
  const I8Args a = mlp_args(x, norm_scale, norm_bias, fc1_q, fc1_s, fc1_b, fc2_q,
                            fc2_s, fc2_b, ls, codes, scales, hidden, hcodes,
                            hscales, out, R, D, H, chunks, slab);
  const EpiSwigluI8 fc1{nullptr, fc1_s, fc1_b, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_mlp_i8<float>(a, fc1, s);
    case 1:
      return launch_mlp_i8<__nv_bfloat16>(a, fc1, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paths_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

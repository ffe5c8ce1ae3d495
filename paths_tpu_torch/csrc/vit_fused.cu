// Fused ViT encoder-block kernels for Hopper (sm_90a), f32 or bf16, forward
// only (the patch encoders are frozen).
//
// Replaces the TPU kernels of `paths_tpu/kernels/vit_fused.py`:
//   fused_attn_block        (body `_attn_kernel`):   LN pre-pass, qkv GEMM,
//                                                    streamed attention, proj GEMM
//   fused_mlp_block         (body `_mlp_kernel`):    LN pre-pass, fc1 GEMM +
//                                                    GELU, fc2 GEMM + residual
//   fused_swiglu_mlp_block  (body `_swiglu_kernel`): LN pre-pass, fc1 GEMM over
//                                                    the packed weight + SwiGLU,
//                                                    fc2 GEMM + residual
//   fused_block             (body `_block_kernel`):  the attention block's
//                                                    launches, then the MLP's
// for x (B, N, D) contiguous in T (f32 or bf16), weights in T in PyTorch's
// (out, in) layout, so that both operands of every product run along their
// contiguous axis; LayerNorm scale/bias, biases and LayerScale in f32.
// Accumulation is f32 throughout. f32 operands are multiplied with FMAs on
// the CUDA cores (no TF32); in bf16 every product (qkv, q k^T, P V, out
// projection, fc1, fc2) runs on the tensor cores.
//
// Rounding points, as in the TPU kernels: to T after the LayerNorm, after
// qkv + bias, P before P V (taken against the row's final max), each head's
// context after the deferred divide, the hidden activation (after the GELU,
// or silu(gate) value) before fc2, and the output; everything else is f32.
// The whole block rounds where its TPU kernel does: P is divided by its row
// sum before it is rounded, each head's P V is rounded, and x after the
// attention half is rounded to T before the second LayerNorm. The TPU MLP
// kernels' `num_chunks` has no counterpart: fc2 sums over the whole hidden
// width in f32, so only the summation order differs.
//
// Design (pieces in `vit_tiles.cuh`). The TPU kernels keep one image's
// activation and the block's weights in VMEM; a CUDA block has 227 KB of
// shared memory and 132 of them run at once, so the work is cut by what each
// product reuses:
//  * LayerNorm once per row: a pre-pass writes LN(x) rounded to T, the value
//    the TPU kernel rounds, so that the GEMMs read a plain operand.
//  * Projections as GEMMs over all B N rows in 128 x 128 output tiles: each
//    staged weight byte feeds 128 rows. bf16: a producer warp streams
//    64-column slabs of both operands by TMA into a 3-stage ring guarded by
//    mbarriers, two consumer warpgroups multiply them with `wgmma`, two
//    blocks share an SM so that one's epilogue overlaps the other's
//    products. f32: a 4-stage `cp.async` ring feeds 8 x 8 FMA blocks per
//    thread. The epilogue adds the bias and rounds (qkv, into a (B, N, 3D)
//    scratch), applies bias and GELU (fc1, into a (B, N, H) scratch), or
//    bias, LayerScale and the residual (out projection, fc2).
//  * The packed SwiGLU fc1 (2H, D), gate rows first: hidden unit j needs
//    output columns j and H + j of the product, which a plain tiling puts in
//    different blocks. Its tiles span 64 hidden units, and each W stage takes
//    64 gate rows above the same 64 value rows (two TMA boxes from two maps,
//    one per half, each zero past row H; f32: the row loads do the same), so
//    the two columns of one unit land in one thread's accumulators, 64
//    columns apart, and the epilogue writes silu(gate) value in T from
//    registers. Same products, same shared-memory traffic per operation, no
//    copy of the weight.
//  * Attention per (image, head, query tile), q, k, v read from the qkv
//    scratch: K and V stream through shared memory in tiles of 64 keys, so
//    any N works (the patch-8 Kaiko models' 785 tokens among them). Two
//    passes over the keys keep the TPU kernel's rounding point of P: the
//    first finds the row max, the second takes P = exp(s - m), rounds it and
//    multiplies it into V; the extra q k^T is a third of the attention's
//    products. In bf16 both products are tensor-core `mma.sync`s with S kept
//    in registers, whose accumulator layout is the A operand of P V; a block
//    takes 128 query rows, so each K and V tile read from L2 serves 128
//    rows. The attention block takes head_dim 64 and 80 (Virchow2's 16
//    heads of 80: q k^T over 5 k-slabs of 16, P V over 10 n-tiles of 8, in
//    `vit_attn_hd80_*_kernel`, so that the head_dim-64 kernels keep their
//    code and names); the whole block takes 64.
//  * Each wrapper call is a fixed sequence of launches on the caller's
//    stream (`attn_half`, `mlp_half`): the whole block writes x after the
//    attention half (x1, rounded to T) to device memory and runs the MLP
//    half on it. The TPU kernels keep x1 and the hidden activation out of
//    HBM; here they cost about 0.1 ms of bytes per UNI block, where
//    restreaming the MLP weights for small row tiles cost far more.
//  * No atomics and no split-K: two calls are bitwise equal.
//
// Bound on the card: at the encoders' shapes (UNI: 12,608 rows, D 1024,
// hidden 4096) every kernel does hundreds of operations per byte of x and
// weights, so the operation rate bounds it: the bf16 tensor-core rate for
// bf16, the f32 CUDA-core rate for f32.
//
// Requirements (checked by the Python wrapper): head_dim 64 (80 also for the
// attention block), D % 64 == 0, hidden % 32 == 0, 16-byte aligned
// contiguous tensors.
//
// C interface (loaded through ctypes): the launch entries return the
// cudaError_t of the first launch that failed (0 on success).

#include "vit_tiles.cuh"

namespace {

using namespace paths_cuda;
using namespace paths_cuda::vit;

// ------------------------------------------------------------------ kernels
// The pieces of `vit_tiles.cuh` as kernels: LayerNorm pre-pass, GEMM with an
// epilogue, attention over streamed keys.
template <typename T>
__global__ void __launch_bounds__(tiles::kLnThreads, 3)
vit_ln_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, int R, int D) {
  tiles::layernorm_rows<T>(x, scale, bias, y, R, D);
}

static_assert(tiles::kWBN == tiles::kTN, "both GEMMs tile N alike");

template <typename Epi>
__global__ void __launch_bounds__(tiles::kF32Threads, 2)
vit_gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    float* __restrict__ out, int M, int N, int K, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tiles::gemm_f32_block(a, w, M, N, K, blockIdx.y * tiles::kTM,
                        blockIdx.x * tiles::kTileN<Epi>, out, epi, smem_raw);
}

// blockIdx = (query tile, head, image); head_dim 64
template <bool NORM_FIRST>
__global__ void __launch_bounds__(tiles::kAttnThreadsBf16)
vit_attn_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ ctx, int N, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tiles::attn_tile_bf16<NORM_FIRST>(qkv, ctx, blockIdx.z, blockIdx.y,
                                    blockIdx.x * tiles::kQTBf16, N, D, smem_raw);
}

template <bool NORM_FIRST>
__global__ void __launch_bounds__(tiles::kAttnThreadsF32)
vit_attn_f32_kernel(const float* __restrict__ qkv, float* __restrict__ ctx,
                    int N, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tiles::attn_tile_f32<NORM_FIRST>(qkv, ctx, blockIdx.z, blockIdx.y,
                                   blockIdx.x * tiles::kQT, N, D, smem_raw);
}

// the same at head_dim 80
template <bool NORM_FIRST>
__global__ void __launch_bounds__(tiles::kAttnThreadsBf16)
vit_attn_hd80_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                          __nv_bfloat16* __restrict__ ctx, int N, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tiles::attn_tile_bf16<NORM_FIRST, __nv_bfloat16, kHD80>(
      qkv, ctx, blockIdx.z, blockIdx.y, blockIdx.x * tiles::kQTBf16, N, D, smem_raw);
}

template <bool NORM_FIRST>
__global__ void __launch_bounds__(tiles::kAttnThreadsF32)
vit_attn_hd80_f32_kernel(const float* __restrict__ qkv, float* __restrict__ ctx,
                         int N, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tiles::attn_tile_f32<NORM_FIRST, kHD80>(qkv, ctx, blockIdx.z, blockIdx.y,
                                          blockIdx.x * tiles::kQT, N, D, smem_raw);
}

// The attention kernel of a head_dim and type, with its shared memory
template <typename T, bool NORM_FIRST, int HD>
struct AttnKernel {
  static constexpr bool kBf16 = tiles::kTensor<T>;
  static constexpr int kThreads =
      kBf16 ? tiles::kAttnThreadsBf16 : tiles::kAttnThreadsF32;
  static constexpr size_t kSmem = kBf16 ? tiles::kAttnSmemBf16Of<HD>
                                        : tiles::kAttnSmemF32Of<HD>;
  static auto get() {
    if constexpr (kBf16 && HD == kHD)
      return vit_attn_bf16_kernel<NORM_FIRST>;
    else if constexpr (kBf16)
      return vit_attn_hd80_bf16_kernel<NORM_FIRST>;
    else if constexpr (HD == kHD)
      return vit_attn_f32_kernel<NORM_FIRST>;
    else
      return vit_attn_hd80_f32_kernel<NORM_FIRST>;
  }
};

// ------------------------------------------------------------------ launch
template <typename T>
cudaError_t layernorm(const T* x, const float* scale, const float* bias, T* y,
                      int R, int D, cudaStream_t s) {
  vit_ln_kernel<T><<<(R + tiles::kLnRows - 1) / tiles::kLnRows,
                     tiles::kLnThreads, 0, s>>>(x, scale, bias, y, R, D);
  return cudaGetLastError();
}

// out (M, N) = epi(a (M, K) w (N, K)^T); with a gated epilogue w is (2N, K),
// gate rows first, and out (M, N) = epi(a w[:N]^T, a w[N:]^T)
template <typename T, typename Epi>
cudaError_t gemm(const T* a, const T* w, T* out, int M, int N, int K, Epi epi,
                 cudaStream_t s) {
  if constexpr (tiles::kTensor<T>) {
    return tiles::gemm_tma<T>(a, w, out, M, N, K, epi, s);
  } else {
    constexpr int BN = tiles::kTileN<Epi>;
    const dim3 grid((N + BN - 1) / BN, (M + tiles::kTM - 1) / tiles::kTM);
    const cudaError_t rc = allow_smem(vit_gemm_f32_kernel<Epi>, tiles::kF32Smem);
    if (rc != cudaSuccess) return rc;
    vit_gemm_f32_kernel<Epi><<<grid, tiles::kF32Threads, tiles::kF32Smem, s>>>(
        a, w, out, M, N, K, epi);
    return cudaGetLastError();
  }
}

// ctx (B, N, D) from qkv (B, N, 3D), every head of width HD
template <typename T, bool NORM_FIRST, int HD>
cudaError_t attention(const T* qkv, T* ctx, int B, int N, int D, int heads,
                      cudaStream_t s) {
  using K = AttnKernel<T, NORM_FIRST, HD>;
  constexpr int QT = tiles::kTensor<T> ? tiles::kQTBf16 : tiles::kQT;
  const dim3 grid((N + QT - 1) / QT, heads, B);
  const auto kernel = K::get();
  const cudaError_t rc = allow_smem(kernel, K::kSmem);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid, K::kThreads, K::kSmem, s>>>(qkv, ctx, N, D);
  return cudaGetLastError();
}

// The tensors of one block, in the order of `paths_vit_block`. `act`
// (B, N, D) holds LN(x), then the context, then LN(x1); `qkv` is (B, N, 3D);
// the whole block also has `x1` (B, N, D), and it and the MLP block have
// `hidden` (B, N, H). All in T. The MLP block fills the norm2, fc1, fc2 and
// ls2 fields.
struct BlockArgs {
  const void* x;
  const float *n1s, *n1b;
  const void* wqkv;
  const float* bqkv;
  const void* wp;
  const float *bp, *ls1, *n2s, *n2b;
  const void* w1;
  const float* b1;
  const void* w2;
  const float *b2, *ls2;
  void *act, *qkv, *x1, *hidden, *out;
  int B, N, D, heads, H;
};

// The attention half: out = x + ls1 (attn(LN1(x)) Wp^T + bp), NORM_FIRST as
// in `attn_tile_bf16`, heads of width HD.
template <typename T, bool NORM_FIRST, int HD>
cudaError_t attn_half(const BlockArgs& a, T* out, cudaStream_t s) {
  const int R = a.B * a.N, D = a.D;
  const T* x = static_cast<const T*>(a.x);
  T* act = static_cast<T*>(a.act);
  T* qkv = static_cast<T*>(a.qkv);
  cudaError_t rc;
  if ((rc = layernorm<T>(x, a.n1s, a.n1b, act, R, D, s)) != cudaSuccess) return rc;
  if ((rc = gemm<T>(act, static_cast<const T*>(a.wqkv), qkv, R, 3 * D, D,
                    tiles::EpiBias{a.bqkv}, s)) != cudaSuccess)
    return rc;
  if ((rc = attention<T, NORM_FIRST, HD>(qkv, act, a.B, a.N, D, a.heads, s)) !=
      cudaSuccess)
    return rc;
  return gemm<T>(act, static_cast<const T*>(a.wp), out, R, D, D,
                 tiles::EpiResidual<T>{x, a.bp, a.ls1, D}, s);
}

template <typename T>
int launch_attn(const BlockArgs& a, cudaStream_t s) {
  T* out = static_cast<T*>(a.out);
  if (a.heads * kHD == a.D)
    return static_cast<int>(attn_half<T, false, kHD>(a, out, s));
  if (a.heads * kHD80 == a.D)
    return static_cast<int>(attn_half<T, false, kHD80>(a, out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The MLP half: out = x + ls2 (act(LN2(x) W1^T + b1) W2^T + b2) as a
// LayerNorm pre-pass into `act`, fc1 with the activation's epilogue into
// `hidden` (B N, H), and fc2 with bias, LayerScale and the residual. SwiGLU
// reads the packed fc1 (2H, D), gate rows first, through the gated GEMM.
template <typename T, int ACT>
cudaError_t mlp_half(const BlockArgs& a, const T* x, T* out, cudaStream_t s) {
  const int R = a.B * a.N, D = a.D;
  T* act = static_cast<T*>(a.act);
  T* hidden = static_cast<T*>(a.hidden);
  const T* w1 = static_cast<const T*>(a.w1);
  cudaError_t rc;
  if ((rc = layernorm<T>(x, a.n2s, a.n2b, act, R, D, s)) != cudaSuccess) return rc;
  if constexpr (ACT == kSwiglu)
    rc = gemm<T>(act, w1, hidden, R, a.H, D, tiles::EpiSwiglu{a.b1, a.H}, s);
  else
    rc = gemm<T>(act, w1, hidden, R, a.H, D, tiles::EpiGelu<ACT>{a.b1}, s);
  if (rc != cudaSuccess) return rc;
  return gemm<T>(hidden, static_cast<const T*>(a.w2), out, R, D, a.H,
                 tiles::EpiResidual<T>{x, a.b2, a.ls2, D}, s);
}

template <typename T>
int dispatch_mlp(int kind, const BlockArgs& a, cudaStream_t s) {
  if (a.H % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  switch (kind) {
    case kGeluExact:
      return static_cast<int>(mlp_half<T, kGeluExact>(a, x, out, s));
    case kGeluTanh:
      return static_cast<int>(mlp_half<T, kGeluTanh>(a, x, out, s));
    case kSwiglu:
      return static_cast<int>(mlp_half<T, kSwiglu>(a, x, out, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The whole block: the attention half into x1, then the MLP half on x1.
template <typename T, int ACT>
int launch_block(const BlockArgs& a, cudaStream_t s) {
  if (a.heads * kHD != a.D || a.H % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  T* x1 = static_cast<T*>(a.x1);
  const cudaError_t rc = attn_half<T, true, kHD>(a, x1, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(mlp_half<T, ACT>(a, x1, static_cast<T*>(a.out), s));
}

template <typename T>
int dispatch_block(int act, const BlockArgs& a, cudaStream_t s) {
  switch (act) {
    case kGeluExact:
      return launch_block<T, kGeluExact>(a, s);
    case kGeluTanh:
      return launch_block<T, kGeluTanh>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, the weights, the scratch and out share it;
// norm scale/bias, biases and LayerScale are f32). act: scratch of x's
// shape; qkv: scratch of (B, N, 3D).
extern "C" int paths_vit_attn_block(
    const void* x, const float* norm_scale, const float* norm_bias,
    const void* qkv_w, const float* qkv_b, const void* proj_w,
    const float* proj_b, const float* ls, void* act, void* qkv, void* out,
    int B, int N, int D, int heads, int dtype, void* stream) {
  BlockArgs a{};
  a.x = x;
  a.n1s = norm_scale;
  a.n1b = norm_bias;
  a.wqkv = qkv_w;
  a.bqkv = qkv_b;
  a.wp = proj_w;
  a.bp = proj_b;
  a.ls1 = ls;
  a.act = act;
  a.qkv = qkv;
  a.out = out;
  a.B = B;
  a.N = N;
  a.D = D;
  a.heads = heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_attn<float>(a, s);
    case 1:
      return launch_attn<__nv_bfloat16>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kind: 0 = exact (erf) GELU, 1 = tanh GELU, 2 = packed SwiGLU (fc1_w is
// (2H, D), gate rows first). Scratch: act of x's shape, hidden (B, N, H).
extern "C" int paths_vit_mlp_block(
    const void* x, const float* norm_scale, const float* norm_bias,
    const void* fc1_w, const float* fc1_b, const void* fc2_w,
    const float* fc2_b, const float* ls, void* act, void* hidden, void* out,
    int B, int N, int D, int H, int kind, int dtype, void* stream) {
  BlockArgs a{};
  a.x = x;
  a.n2s = norm_scale;
  a.n2b = norm_bias;
  a.w1 = fc1_w;
  a.b1 = fc1_b;
  a.w2 = fc2_w;
  a.b2 = fc2_b;
  a.ls2 = ls;
  a.act = act;
  a.hidden = hidden;
  a.out = out;
  a.B = B;
  a.N = N;
  a.D = D;
  a.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_mlp<float>(kind, a, s);
    case 1:
      return dispatch_mlp<__nv_bfloat16>(kind, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The whole block (attention half, then the GELU MLP half). gelu: 0 = exact,
// 1 = tanh. Scratch: act and x1 of x's shape, qkv (B, N, 3D), hidden
// (B, N, H).
extern "C" int paths_vit_block(
    const void* x, const float* norm1_scale, const float* norm1_bias,
    const void* qkv_w, const float* qkv_b, const void* proj_w,
    const float* proj_b, const float* ls1, const float* norm2_scale,
    const float* norm2_bias, const void* fc1_w, const float* fc1_b,
    const void* fc2_w, const float* fc2_b, const float* ls2, void* act,
    void* qkv, void* x1, void* hidden, void* out, int B, int N, int D,
    int heads, int H, int gelu, int dtype, void* stream) {
  const BlockArgs a{x, norm1_scale, norm1_bias, qkv_w, qkv_b, proj_w, proj_b,
                    ls1, norm2_scale, norm2_bias, fc1_w, fc1_b, fc2_w, fc2_b,
                    ls2, act, qkv, x1, hidden, out, B, N, D, heads, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_block<float>(gelu, a, s);
    case 1:
      return dispatch_block<__nv_bfloat16>(gelu, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paths_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

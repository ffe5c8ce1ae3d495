// Fused ViT encoder-block kernels for Hopper (sm_90a), f32 or bf16, forward
// only (the patch encoders are frozen).
//
// Replaces the TPU kernels of `paths_tpu/kernels/vit_fused.py`:
//   fused_attn_block        (body `_attn_kernel`):   vit_attn_kernel + vit_proj_kernel
//   fused_mlp_block         (body `_mlp_kernel`):    vit_mlp_kernel<T, gelu>
//   fused_swiglu_mlp_block  (body `_swiglu_kernel`): vit_mlp_kernel<T, swiglu>
//   fused_block             (body `_block_kernel`):  vit_block_kernel
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
// The whole-block kernel rounds where its TPU kernel does: P is divided by
// its row sum before it is rounded, each head's P V is rounded, and x after
// the attention half is rounded to T before the second LayerNorm.
//
// Design (the shared pieces are in `vit_common.cuh`). The TPU kernels keep
// one image's activation and the block's whole weights in VMEM. A CUDA block
// has 227 KB of shared memory, so:
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
//  * The whole block in one launch (`vit_block_kernel`). The TPU kernel's
//    point is that x after the attention half never reaches device memory.
//    An image's (N, D) activation does not fit a block's shared memory here,
//    and only the attention couples rows, so the kernel has two phases with
//    a grid-wide barrier between them (a cooperative launch of as many
//    blocks as the card keeps resident; each block walks its share of the
//    work): (1) per (image, head) the attention core writes the context to
//    device memory, as above; (2) per 16-row tile: out projection,
//    LayerScale and residual into a (16, D) tile of x1 in shared memory,
//    rounded to T; the second LayerNorm reads it from there; fc1, GELU, fc2
//    as in the MLP kernel; the output adds the x1 tile. x1 never reaches
//    device memory.
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

#include <cooperative_groups.h>

#include "vit_common.cuh"

namespace {

using namespace paths_cuda;
using namespace paths_cuda::vit;

// ---------------------------------------------------------------- MLP block
// out = x + ls * (act(LN(x) W1^T + b1) W2^T + b2) for rows r0 .. r0 + 15 of
// the flattened (R, D) activation.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
vit_mlp_kernel(const T* __restrict__ x, const float* __restrict__ ns,
               const float* __restrict__ nb, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ ls,
               T* __restrict__ out, int R, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const MlpSmem<T> sm(smem_raw, D);
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kBM;
  const T* xt = x + static_cast<size_t>(r0) * D;
  for (int i = t; i < kBM * D; i += kThreads) sm.acc_s[i] = 0.f;
  ln_stats<T>(xt, R - r0, D, sm.mu_s, sm.rstd_s);
  const LnRows<T> a_ln{xt, ns, nb, sm.mu_s, sm.rstd_s, R - r0, D};
  mlp_rows<T, ACT>(a_ln, w1, b1, w2, D, H, sm.acc_s, sm.As, sm.Ws, sm.Hs);
  for (int i = t; i < kBM * D; i += kThreads) {
    const int m = i / D, d = i % D;
    if (r0 + m < R) {
      const size_t at = static_cast<size_t>(r0 + m) * D + d;
      out[at] = from_float<T>(to_float(x[at]) + (sm.acc_s[i] + b2[d]) * ls[d]);
    }
  }
}

// ---------------------------------------------------- attention, per head
// ctx[b, :, h 64 : (h + 1) 64] of head h = blockIdx.x of image b = blockIdx.y;
// wqkv: (3D, D), rows [q | k | v], each split by head.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
vit_attn_kernel(const T* __restrict__ x, const float* __restrict__ ns,
                const float* __restrict__ nb, const T* __restrict__ wqkv,
                const float* __restrict__ bqkv, T* __restrict__ ctx, int N,
                int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t image = static_cast<size_t>(b) * N * D;
  QkvFloat<T> qkv(x + image, ns, nb, wqkv, bqkv, N, D,
                  smem_raw + attn_core_bytes<T>(N));
  attn_head<T, T, false>(qkv, ctx + image, h, N, D, smem_raw);
}

// out = x + ls * (ctx Wp^T + bp) for rows r0 .. r0 + 15 of (R, D).
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
vit_proj_kernel(const T* __restrict__ ctx, const T* __restrict__ x,
                const T* __restrict__ wp, const float* __restrict__ bp,
                const float* __restrict__ ls, T* __restrict__ out, int R,
                int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);   // kBM x kLDA
  T* Ws = reinterpret_cast<T*>(As + kBM * kLDA);    // 256 x kLDW
  const int r0 = blockIdx.x * kBM;
  const size_t tile = static_cast<size_t>(r0) * D;
  T* ot = out + tile;
  proj_rows<T>(ctx + tile, x + tile, wp, bp, ls, R - r0, D, As, Ws,
               [&](int m, int n, float v) {
                 ot[static_cast<size_t>(m) * D + n] = from_float<T>(v);
               });
}

// ------------------------------------------------- whole block, one launch
// Phase 1: the attention core for every (image, head); grid barrier; phase
// 2: for every 16-row tile the out projection into x1 (shared memory), then
// the GELU MLP on it. ctx (B, N, D) in T is scratch in device memory. Every
// block walks items blockIdx.x, blockIdx.x + gridDim.x, ...
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
vit_block_kernel(const T* __restrict__ x, const float* __restrict__ n1s,
                 const float* __restrict__ n1b, const T* __restrict__ wqkv,
                 const float* __restrict__ bqkv, const T* __restrict__ wp,
                 const float* __restrict__ bp, const float* __restrict__ ls1,
                 const float* __restrict__ n2s, const float* __restrict__ n2b,
                 const T* __restrict__ w1, const float* __restrict__ b1,
                 const T* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ ls2, T* ctx, T* __restrict__ out,
                 int B, int N, int D, int heads, int H) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int t = threadIdx.x;
  for (int item = blockIdx.x; item < B * heads; item += gridDim.x) {
    const int b = item / heads, h = item % heads;
    const size_t image = static_cast<size_t>(b) * N * D;
    QkvFloat<T> qkv(x + image, n1s, n1b, wqkv, bqkv, N, D,
                    smem_raw + attn_core_bytes<T>(N));
    attn_head<T, T, true>(qkv, ctx + image, h, N, D, smem_raw);
  }
  cooperative_groups::this_grid().sync();   // every head's context is written

  const MlpSmem<T> sm(smem_raw, D);
  T* x1_s = reinterpret_cast<T*>(smem_raw + MlpSmem<T>::bytes(D));   // kBM x D
  const int R = B * N;
  for (int tile = blockIdx.x; tile * kBM < R; tile += gridDim.x) {
    const int r0 = tile * kBM, valid = min(kBM, R - r0);
    const size_t at0 = static_cast<size_t>(r0) * D;
    // the staging buffer holds 256 weight rows of 32: the out projection's
    // tile has the MLP's shape
    proj_rows<T>(ctx + at0, x + at0, wp, bp, ls1, valid, D, sm.As, sm.Ws,
                 [&](int m, int n, float v) {
                   x1_s[m * D + n] = from_float<T>(v);
                 });
    for (int i = t; i < kBM * D; i += kThreads) sm.acc_s[i] = 0.f;
    __syncthreads();   // the x1 tile is complete
    ln_stats<T>(x1_s, valid, D, sm.mu_s, sm.rstd_s);
    const LnRows<T> a_ln{x1_s, n2s, n2b, sm.mu_s, sm.rstd_s, valid, D};
    mlp_rows<T, ACT>(a_ln, w1, b1, w2, D, H, sm.acc_s, sm.As, sm.Ws, sm.Hs);
    for (int i = t; i < valid * D; i += kThreads) {
      const int d = i % D;
      out[at0 + i] = from_float<T>(to_float(x1_s[i]) +
                                   (sm.acc_s[i] + b2[d]) * ls2[d]);
    }
    __syncthreads();   // x1 and the accumulator are free for the next tile
  }
}

// ------------------------------------------------------------------ launch
template <typename T>
size_t attn_smem(int N) {
  return attn_core_bytes<T>(N) + QkvFloat<T>::bytes(0);
}

template <typename T>
size_t proj_smem() {
  return kBM * kLDA * sizeof(float) + kThreads * Strides<T>::kLDW * sizeof(T);
}

template <typename T>
size_t block_smem(int N, int D) {
  const size_t mlp = MlpSmem<T>::bytes(D) + static_cast<size_t>(kBM) * D * sizeof(T);
  return attn_smem<T>(N) > mlp ? attn_smem<T>(N) : mlp;
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
  const size_t smem = MlpSmem<T>::bytes(D);
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

// The tensors of one whole block, in the kernel's argument order.
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
  void *ctx, *out;
  int B, N, D, heads, H;
};

// One cooperative launch of as many blocks as the card keeps resident (at
// most one per item of the larger phase); refused when not even one fits.
template <typename T, int ACT>
int launch_block(BlockArgs a, cudaStream_t stream) {
  if (a.heads * kHD != a.D || a.D % kBK != 0 || a.H % kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = block_smem<T>(a.N, a.D);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vit_block_kernel<T, ACT>;
  cudaError_t rc = allow_smem(kernel, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int device = 0, sms = 0, per_sm = 0, cooperative = 0;
  if ((rc = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(rc);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!cooperative || per_sm < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int tiles = (a.B * a.N + kBM - 1) / kBM, items = a.B * a.heads;
  const int work = tiles > items ? tiles : items;
  const int grid = per_sm * sms < work ? per_sm * sms : work;
  const T* x = static_cast<const T*>(a.x);
  const T* wqkv = static_cast<const T*>(a.wqkv);
  const T* wp = static_cast<const T*>(a.wp);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  T* ctx = static_cast<T*>(a.ctx);
  T* out = static_cast<T*>(a.out);
  void* args[] = {&x, &a.n1s, &a.n1b, &wqkv, &a.bqkv, &wp, &a.bp, &a.ls1,
                  &a.n2s, &a.n2b, &w1, &a.b1, &w2, &a.b2, &a.ls2, &ctx, &out,
                  &a.B, &a.N, &a.D, &a.heads, &a.H};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                   dim3(kThreads), args, smem, stream);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
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

// The whole block (attention half, then the GELU MLP half) in one launch.
// act: 0 = exact GELU, 1 = tanh GELU. ctx is scratch of x's shape.
extern "C" int paths_vit_block(
    const void* x, const float* norm1_scale, const float* norm1_bias,
    const void* qkv_w, const float* qkv_b, const void* proj_w,
    const float* proj_b, const float* ls1, const float* norm2_scale,
    const float* norm2_bias, const void* fc1_w, const float* fc1_b,
    const void* fc2_w, const float* fc2_b, const float* ls2, void* ctx,
    void* out, int B, int N, int D, int heads, int H, int act, int dtype,
    void* stream) {
  const BlockArgs a{x, norm1_scale, norm1_bias, qkv_w, qkv_b, proj_w, proj_b,
                    ls1, norm2_scale, norm2_bias, fc1_w, fc1_b, fc2_w, fc2_b,
                    ls2, ctx, out, B, N, D, heads, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_block<float>(act, a, s);
    case 1:
      return dispatch_block<__nv_bfloat16>(act, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory the attention kernel needs for N tokens, the MLP
// kernel for width D and the whole-block kernel for both; the most a block
// may have.
extern "C" long long paths_vit_attn_smem_bytes(int N, int dtype) {
  return static_cast<long long>(dtype == 0 ? attn_smem<float>(N)
                                           : attn_smem<__nv_bfloat16>(N));
}

extern "C" long long paths_vit_mlp_smem_bytes(int D, int dtype) {
  return static_cast<long long>(dtype == 0 ? MlpSmem<float>::bytes(D)
                                           : MlpSmem<__nv_bfloat16>::bytes(D));
}

extern "C" long long paths_vit_block_smem_bytes(int N, int D, int dtype) {
  return static_cast<long long>(dtype == 0 ? block_smem<float>(N, D)
                                           : block_smem<__nv_bfloat16>(N, D));
}

extern "C" long long paths_vit_max_smem_bytes() {
  return static_cast<long long>(kMaxSmem);
}

extern "C" const char* paths_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

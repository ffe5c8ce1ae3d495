// Masked flash-attention forward for Hopper (sm_90a), f32 or bf16.
//
// Replaces the TPU kernel `paths_tpu/kernels/flash_attention.py::_flash_forward`
// (body `_flash_kernel`): out = softmax(q k^T / sqrt(d), keys k < lengths[b]) v
// and the per-row log-sum-exp, for q (B, H, Nq, D), k/v (B, H, Nk, D), all
// contiguous and of one type (f32 or bf16), D 32 or 64; Nq and Nk may differ.
//
// Design. The TPU kernel walks key blocks on the innermost, sequential grid
// axis and carries the online-softmax state in VMEM scratch. Blocks of a CUDA
// grid run in no order, so here one block owns (b, h, a tile of query rows)
// and loops over the keys itself, K and V tiles double-buffered in shared
// memory by `cp.async`. The loop stops at lengths[b], so masked key tiles are
// never read.
//  * bf16: 64 query rows per block, 4 warps of 16 rows; both products on the
//    tensor cores (`mma.sync` m16n8k16, f32 accumulation) over 64-key tiles,
//    Q fragments kept in registers, S kept in registers as accumulator
//    fragments whose layout is that of P V's A operand once packed to bf16.
//    The TPU kernel rounds P = exp(s - m) to bf16 against m, the running max
//    at the end of each `block_k`-key block; so per block a first pass over
//    its key tiles finds the row max (q k^T only), the running state is
//    rescaled to it, and a second pass forms P against it, rounds it and
//    multiplies it into V (the tiles divide the block). l sums P unrounded,
//    as the TPU kernel's does.
//  * f32 (the parity mode, TF32 off): 32 query rows per block on the CUDA
//    cores, 8 x 16 threads: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and,
//    of each 32-key tile, keys tx and tx + 16 for S, head dims D / 16 tx ..
//    for P V; P passes through shared memory, the row max by shuffles across
//    the 16 threads of a row group. One pass with the online rescaling per
//    tile: rounding to f32 is none, so `block_k` cannot matter. Every sum
//    runs in order, as a plain loop over one row would take it (q k^T over
//    the head dims, P V and each tile's row sum over its keys, rescaled per
//    32-key tile): the backward rebuilds P from the lse, and a row of length
//    1 or 2 gathers all of its gradient on its keys, where an lse one ulp
//    off shows in the weight gradients.
//    Rows are 4 floats longer than D in shared memory, so the float4 reads
//    of 8 neighbouring key rows fall on distinct banks.
// A warp whose rows all lie past Nq only loads tiles. In bf16, exp is the
// fast `__expf` (within 2 + 1.2 |x| f32 ulps, far below the bf16 rounding of
// P); in f32 it is the accurate `expf`.
//
// Bound on the card: the flagship's serving and training shapes (f32, D 32,
// N <= 257) do about N / 4 operations per byte, so the f32 rate of the CUDA
// cores bounds them; the ViT flash route (bf16, D 64, N 197-785) does about
// N / 2 per byte against the tensor cores' 295: its bytes bound it at 197
// and 261 tokens, its products at 785.
//
// Masking semantics match the TPU kernel exactly: NEG_INF = -1e30 for masked
// scores, l floored at 1e-30, query rows at or past the length still produce
// outputs normalised over the valid keys.
//
// C interface (loaded through ctypes): every entry returns the
// cudaError_t of the launch (0 on success).

#include "flash_common.cuh"

namespace {

using namespace paths_cuda;
using bf16 = __nv_bfloat16;
constexpr unsigned kAll = 0xffffffffu;

// ------------------------------------------------------------------ bf16
constexpr int kQB = 64;        // query rows per block
constexpr int kKB = 64;        // keys per tile (block_k is a multiple of it)
constexpr int kThreadsB = 128;

// rows [row0, row0 + 64) of a (rows, D) bf16 matrix into dst (pitch P); rows
// at or past `rows` are zeros
template <int D, int P>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int row0, int rows) {
  constexpr int PR = D / 8;   // 16-byte pieces per row
#pragma unroll
  for (int i = 0; i < kKB * PR / kThreadsB; ++i) {
    const int c = threadIdx.x + i * kThreadsB;
    const int r = c / PR, col = (c % PR) * 8, row = row0 + r;
    cp_async16(dst + r * P + col,
               src + static_cast<size_t>(row < rows ? row : 0) * D + col,
               row < rows);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsB, 4)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ lengths,
                      bf16* __restrict__ out, float* __restrict__ lse, int H,
                      int Nq, int Nk, int block_k, float sm_scale) {
  constexpr int P = D + 8;   // row pitch in elements: ldmatrix conflict-free
  __shared__ __align__(16) bf16 Qs[kQB * P];
  __shared__ __align__(16) bf16 Ks[2][kKB * P];
  __shared__ __align__(16) bf16 Vs[2][kKB * P];

  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const bool busy = q0 + warp * 16 < Nq;
  const int len = max(0, min(lengths[b], Nk));
  const bf16* kb = k + bh * Nk * D;
  const bf16* vb = v + bh * Nk * D;

  // s[nt][e]: row 16 warp + g (e 0, 1) or + 8 (e 2, 3), key key0 + 8 nt +
  // 2 tq + e % 2
  unsigned qf[D / 16][4];
  auto scores = [&](float (&s)[kKB / 8][4], const bf16* K, int key0) {
#pragma unroll
    for (int nt = 0; nt < kKB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int np = 0; np < kKB / 16; ++np) {
        unsigned kf[4];
        ldmatrix_x4(kf, K + (np * 16 + lane % 8 + (lane / 16) * 8) * P + kc * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kf[2], kf[3]);
      }
#pragma unroll
    for (int nt = 0; nt < kKB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = key0 + nt * 8 + tq * 2 + e % 2 < len ? s[nt][e] * sm_scale
                                                        : kNegInf;
  };

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's keys

  load_tile_bf16<D, P>(Qs, q + bh * Nq * D, q0, Nq);
  cp_async_commit();
  bool have_q = false;
  for (int kb0 = 0; kb0 < len; kb0 += block_k) {
    const int kend = min(kb0 + block_k, len);
    // ---- pass 1: the running max at the end of this key block
    float mx[2] = {m[0], m[1]};
    load_tile_bf16<D, P>(Ks[0], kb, kb0, Nk);
    cp_async_commit();
    for (int j = 0, key0 = kb0; key0 < kend; ++j, key0 += kKB) {
      if (key0 + kKB < kend) load_tile_bf16<D, P>(Ks[(j + 1) & 1], kb, key0 + kKB, Nk);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (busy) {
        if (!have_q) {
#pragma unroll
          for (int kc = 0; kc < D / 16; ++kc)
            ldmatrix_x4(qf[kc], Qs + (warp * 16 + lane % 16) * P + kc * 16 +
                                    (lane / 16) * 8);
        }
        float s[kKB / 8][4];
        scores(s, Ks[j & 1], key0);
#pragma unroll
        for (int nt = 0; nt < kKB / 8; ++nt) {
          mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
        }
      }
      have_q = true;
      __syncthreads();   // every warp is done with this K tile
    }
    // ---- the state rescaled to the new max
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 2));
      const float alpha = __expf(m[r] - mx[r]);
      l[r] *= alpha;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][2 * r] *= alpha;
        o[dt][2 * r + 1] *= alpha;
      }
      m[r] = mx[r];
    }
    // ---- pass 2: P against it, rounded to bf16, into P V
    load_tile_bf16<D, P>(Ks[0], kb, kb0, Nk);
    load_tile_bf16<D, P>(Vs[0], vb, kb0, Nk);
    cp_async_commit();
    for (int j = 0, key0 = kb0; key0 < kend; ++j, key0 += kKB) {
      if (key0 + kKB < kend) {
        load_tile_bf16<D, P>(Ks[(j + 1) & 1], kb, key0 + kKB, Nk);
        load_tile_bf16<D, P>(Vs[(j + 1) & 1], vb, key0 + kKB, Nk);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (busy) {
        float s[kKB / 8][4];
        scores(s, Ks[j & 1], key0);
        const bf16* V = Vs[j & 1];
#pragma unroll
        for (int kc = 0; kc < kKB / 16; ++kc) {   // keys 16 kc .. 16 kc + 15
          unsigned pf[4];   // their P as an A operand
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) p[e] = __expf(s[2 * kc + half][e] - m[e / 2]);
            l[0] += p[0] + p[1];
            l[1] += p[2] + p[3];
            pf[half * 2] = pack_bf16(p[0], p[1]);
            pf[half * 2 + 1] = pack_bf16(p[2], p[3]);
          }
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            unsigned vf[4];
            ldmatrix_x4_trans(vf, V + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * P +
                                      dp * 16 + (lane / 16) * 8);
            mma_bf16(o[2 * dp], pf, vf[0], vf[1]);
            mma_bf16(o[2 * dp + 1], pf, vf[2], vf[3]);
          }
        }
      }
      __syncthreads();   // every warp is done with this K and V tile
    }
  }
  cp_async_wait<0>();
  if (!busy) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kAll, l[r], 1);
    l[r] += __shfl_xor_sync(kAll, l[r], 2);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Nq) continue;
    const float l_safe = fmaxf(l[r], kLFloor);
    bf16* dst = out + (bh * Nq + row) * D + tq * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(dst + dt * 8, o[dt][2 * r] / l_safe, o[dt][2 * r + 1] / l_safe);
    if (tq == 0) lse[bh * Nq + row] = m[r] + logf(l_safe);
  }
}

// ------------------------------------------------------------------- f32
constexpr int kQF = 32;        // query rows per block
constexpr int kKF = 32;        // keys per tile
constexpr int kThreadsF = 128; // 8 row groups x 16

// rows [row0, row0 + 32) of a (rows, D) f32 matrix into dst (pitch D + 4);
// rows at or past `rows` are zeros
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int rows) {
  constexpr int PR = D / 4;
#pragma unroll
  for (int i = 0; i < kKF * PR / kThreadsF; ++i) {
    const int c = threadIdx.x + i * kThreadsF;
    const int r = c / PR, col = (c % PR) * 4, row = row0 + r;
    cp_async16(dst + r * (D + 4) + col,
               src + static_cast<size_t>(row < rows ? row : 0) * D + col,
               row < rows);
  }
}

// DT consecutive floats of a shared-memory row as one 8- or 16-byte read
template <int DT>
__device__ __forceinline__ void load_dims(const float* p, float (&v)[DT]) {
  if constexpr (DT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ lengths,
                     float* __restrict__ out, float* __restrict__ lse, int H,
                     int Nq, int Nk, float sm_scale) {
  constexpr int PD = D + 4;      // row pitch of the Q, K, V tiles
  constexpr int PP = kKF + 4;    // row pitch of P
  constexpr int DT = D / 16;     // head dims per thread in P V
  __shared__ __align__(16) float Qs[kQF * PD];
  __shared__ __align__(16) float Ks[2][kKF * PD];
  __shared__ __align__(16) float Vs[2][kKF * PD];
  __shared__ __align__(16) float Ps[kQF * PP];

  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int q0 = blockIdx.x * kQF;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool busy = q0 + (threadIdx.x / 32) * 8 < Nq;   // the warp's 8 rows
  const int len = max(0, min(lengths[b], Nk));
  const float* kb = k + bh * Nk * D;
  const float* vb = v + bh * Nk * D;

  // max over the 16 threads of a row group (one half warp)
  auto group_max = [](float x) {
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(kAll, x, s));
    return x;
  };

  float o[4][DT], m[4], l[4], alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) o[i][c] = 0.f;
  }

  load_tile_f32<D>(Qs, q + bh * Nq * D, q0, Nq);
  if (len > 0) {
    load_tile_f32<D>(Ks[0], kb, 0, Nk);
    load_tile_f32<D>(Vs[0], vb, 0, Nk);
  }
  cp_async_commit();
  for (int j = 0, key0 = 0; key0 < len; ++j, key0 += kKF) {
    if (key0 + kKF < len) {
      load_tile_f32<D>(Ks[(j + 1) & 1], kb, key0 + kKF, Nk);
      load_tile_f32<D>(Vs[(j + 1) & 1], vb, key0 + kKF, Nk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* K = Ks[j & 1];
    const float* V = Vs[j & 1];
    if (busy) {
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(K + tx * PD + d);
        const float4 k1 = *reinterpret_cast<const float4*>(K + (tx + 16) * PD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * PD + d);
          // head dims in order, one fused multiply-add each
          s[i][0] = fmaf(qv.w, k0.w, fmaf(qv.z, k0.z, fmaf(qv.y, k0.y, fmaf(qv.x, k0.x, s[i][0]))));
          s[i][1] = fmaf(qv.w, k1.w, fmaf(qv.z, k1.z, fmaf(qv.y, k1.y, fmaf(qv.x, k1.x, s[i][1]))));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          s[i][jj] = key0 + tx + 16 * jj < len ? s[i][jj] * sm_scale : kNegInf;
        const float m_new = fmaxf(m[i], group_max(fmaxf(s[i][0], s[i][1])));
        alpha[i] = expf(m[i] - m_new);
#pragma unroll
        for (int c = 0; c < DT; ++c) o[i][c] *= alpha[i];
        m[i] = m_new;
        Ps[(ty * 4 + i) * PP + tx] = expf(s[i][0] - m_new);
        Ps[(ty * 4 + i) * PP + tx + 16] = expf(s[i][1] - m_new);
      }
    }
    __syncthreads();   // P is complete
    if (busy) {
      float p_sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int kk = 0; kk < kKF; kk += 4) {
        float4 p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PP + kk);
          p_sum[i] += p[i].x;
          p_sum[i] += p[i].y;
          p_sum[i] += p[i].z;
          p_sum[i] += p[i].w;
        }
        float vr[4][DT];
#pragma unroll
        for (int u = 0; u < 4; ++u) load_dims<DT>(V + (kk + u) * PD + tx * DT, vr[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DT; ++c)
            o[i][c] = fmaf(p[i].w, vr[3][c], fmaf(p[i].z, vr[2][c],
                           fmaf(p[i].y, vr[1][c], fmaf(p[i].x, vr[0][c], o[i][c]))));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) l[i] = l[i] * alpha[i] + p_sum[i];
    }
    __syncthreads();   // K, V and P are free
  }
  cp_async_wait<0>();
  if (!busy) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_safe = fmaxf(l[i], kLFloor);
    const int row = q0 + ty * 4 + i;
    if (row >= Nq) continue;
    float* dst = out + (bh * Nq + row) * D + tx * DT;
#pragma unroll
    for (int c = 0; c < DT; ++c) dst[c] = o[i][c] / l_safe;
    if (tx == 0) lse[bh * Nq + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------- launch
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* lengths, void* out, float* lse, int B, int H, int Nq,
           int Nk, int block_k, float sm_scale, cudaStream_t stream) {
  if (dtype == 1) {
    if (block_k < kKB || block_k % kKB) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((Nq + kQB - 1) / kQB, H, B);
    flash_fwd_bf16_kernel<D><<<grid, kThreadsB, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), lengths, static_cast<bf16*>(out), lse, H, Nq,
        Nk, block_k, sm_scale);
  } else if (dtype == 0) {
    const dim3 grid((Nq + kQF - 1) / kQF, H, B);
    flash_fwd_f32_kernel<D><<<grid, kThreadsF, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lengths, static_cast<float*>(out), lse, H,
        Nq, Nk, sm_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out share it; lse is f32). block_k:
// the key block whose running max P is rounded against in bf16, a multiple
// of 64 (unused in f32).
extern "C" int paths_flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, float* lse, int B, int H, int Nq, int Nk, int D, int dtype,
    int block_k, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(dtype, q, k, v, lengths, out, lse, B, H, Nq, Nk, block_k,
                        sm_scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, lengths, out, lse, B, H, Nq, Nk, block_k,
                        sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paths_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

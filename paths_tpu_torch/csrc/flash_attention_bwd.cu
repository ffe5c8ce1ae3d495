// Masked flash-attention backward for Hopper (sm_90a), f32 or bf16 I/O.
//
// Replaces the two TPU kernels of
// `paths_tpu/kernels/flash_attention.py::_flash_backward`:
//   * the dq pass (`pallas_call` at :283, body `_flash_bwd_dq_kernel`):
//       dq = scale * sum_k P o (dO v^T - delta) k,
//   * the dk/dv pass (`pallas_call` at :305, body `_flash_bwd_dkv_kernel`):
//       dv = P^T dO,  dk = scale * (P o (dO v^T - delta))^T q,
// with P = exp(scale * q k^T - lse) rebuilt from the forward's per-row
// log-sum-exp, keys k >= lengths[b] masked, and delta = rowsum(dO o O). As
// the TPU kernels do, dS = P o (dP - delta) is rounded to the input type
// before dS k and dS^T q (in bf16; in f32 that is no rounding), while dv
// takes P unrounded.
// q/out/dout (B, H, Nq, D), k/v (B, H, Nk, D), all contiguous and of one type
// (f32 or bf16; the math runs in f32), D 32 or 64, lse/delta (B, H, Nq) f32.
//
// Design. The TPU kernels carry their accumulators in VMEM scratch across a
// sequential grid axis; here each block owns (b, h, 32 rows) and loops over
// the streamed operand itself, with 128 threads as 8 row groups x 16 (the
// layout of the forward's f32 kernel, `flash_attention.cu`):
//   * dq: a block owns 32 query rows, their q and dO staged in shared
//     memory. Key and value tiles of 32 keys are double-buffered by
//     `cp.async` and the loop stops at lengths[b]: keys past it are
//     zero-filled, never read. Thread (ty, tx) computes S and dP for rows
//     4 ty .. 4 ty + 3 against keys tx and tx + 16 of the tile (16
//     independent chains), forms dS, and passes it through a padded shared
//     tile; then it owns rows 4 ty .. 4 ty + 3 x head dims D / 16 tx ..
//     D / 16 tx + D / 16 - 1 of dq and multiplies dS into K. The same kernel
//     writes delta = rowsum(dO o O) for its rows (the TPU code computes it
//     in XLA before the kernels), so the dk/dv kernel, launched after it on
//     the same stream, reads it.
//   * dk/dv: a block owns 32 keys, their k and v staged once. Q, dO, lse
//     and delta tiles of 32 query rows stream through shared memory over
//     ALL Nq query rows (padded query rows are real rows: they attend over
//     the valid keys in the forward). Thread (ty, tx) computes S and dP for
//     keys 4 ty .. 4 ty + 3 against query rows tx and tx + 16, passes P and
//     dS through shared memory, then owns keys 4 ty .. 4 ty + 3 x D / 16
//     head dims of dk and dv. A block whose keys all lie past the length
//     only writes zeros.
// No atomics: each output row has one owner, so results are deterministic.
// bf16 rows are widened to f32 on their way into shared memory (no
// cp.async for them); all the math is f32.
//
// The results are bit for bit those of the earlier one-thread-per-row
// kernels, because every sum keeps their order: S, dP and delta
// over the head dims in order (at D 64 in two 32-dim halves, then added, as
// the two lanes that shared a row added them), each dq, dk and dv element a
// chain of fmaf over keys (or query rows) in increasing order, scaled by
// sm_scale at the end, and the accurate expf. A tile row past the length
// (dq: a key) or past Nq (dk/dv: a query row) is zero-filled, which gives
// s = 0 and so a P that is not 0: its P and dS are set to exactly 0, and
// fmaf(0, 0, acc) leaves the accumulator's bits as they were.
//
// Masking as in the TPU kernels: keys at or past the length get exactly zero
// dk/dv, written out even for blocks wholly past the length; with length 0
// every gradient is zero (the forward's lse is then about -1e30, and no P is
// ever formed from it).
//
// Bound on the card: at the training shapes (D = 32, N <= 257) the work is
// about N / 4 operations per byte moved, so the f32 rate of the CUDA cores
// (TF32 tensor cores stay off for parity) bounds it rather than memory.
// Shared-memory rows are 4 floats longer than D, so the float4 reads of 8
// neighbouring rows fall on distinct banks; a row group's 16 threads read
// their own rows' values as broadcasts. On the H100 a layout of 8 x 8
// threads with 4 x 4 register tiles, which halves the shared-memory reads
// per FMA, and blocks of 64 or 128 rows, which stage each K / V (or Q / dO)
// tile for more rows, measured within 6% of this layout over the flagship's
// train step, up to 16% faster at a 4096-key bag and slower at D 64
// (`PERF.md`, Findings).
//
// C interface (loaded through ctypes): every entry returns the
// cudaError_t of the launch (0 on success).

#include "flash_common.cuh"

namespace {

using namespace paths_cuda;

constexpr int kRows = 32;       // rows owned by a block (query rows / keys)
constexpr int kTile = 32;       // rows of the streamed operand per tile
constexpr int kThreads = 128;   // 8 row groups x 16
constexpr int kHalf = 32;       // head dims of one in-order partial sum
constexpr int kPP = kTile + 4;  // row pitch of the P and dS tiles

// floats of one staged tile (pitch D + 4)
template <int D>
constexpr int kTileFloats = kTile * (D + 4);

// Rows [row0, row0 + 32) of a row-major (N, D) matrix into an f32 tile of
// pitch D + 4; rows at or past `rows` are zero-filled and never read. f32
// rows go by cp.async, bf16 rows are read, widened and stored.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rows) {
  constexpr int PR = D / 4;   // 16-byte pieces per row
#pragma unroll
  for (int i = 0; i < kTile * PR / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / PR, col = (c % PR) * 4, row = row0 + r;
    cp_async16(dst + r * (D + 4) + col,
               src + static_cast<size_t>(row < rows ? row : 0) * D + col,
               row < rows);
  }
}

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src,
                                          int row0, int rows) {
  constexpr int PR = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * PR / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / PR, col = (c % PR) * 8, row = row0 + r;
    float x[8];
    if (row < rows) {
      Piece<__nv_bfloat16>::load(src + static_cast<size_t>(row) * D + col, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * (D + 4) + col);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// Entry row0 + t of an f32 vector into dst[t] by thread t of 32; zero past
// `rows`.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int rows, int t) {
  const int row = row0 + t;
  cp_async4(dst + t, src + (row < rows ? row : 0), row < rows);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + a . b over four dims, in order
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// S and dP of the thread's own rows 4 ty + i (of tiles X, Y) against rows
// tx + 16 j of the streamed tiles U, W:
//   s[i][j] = X[4 ty + i] . U[tx + 16 j],  dp[i][j] = Y[4 ty + i] . W[tx + 16 j],
// each over the head dims in order, in 32-dim halves that are then added.
template <int D>
__device__ __forceinline__ void dots(const float* X, const float* Y,
                                     const float* U, const float* W, int ty,
                                     int tx, float (&s)[4][2],
                                     float (&dp)[4][2]) {
  constexpr int PD = D + 4;
#pragma unroll
  for (int h = 0; h < D; h += kHalf) {
    float hs[4][2], hp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) hs[i][0] = hs[i][1] = hp[i][0] = hp[i][1] = 0.f;
#pragma unroll
    for (int d = h; d < h + kHalf; d += 4) {
      const float4 u0 = ld4(U + tx * PD + d), u1 = ld4(U + (tx + 16) * PD + d);
      const float4 w0 = ld4(W + tx * PD + d), w1 = ld4(W + (tx + 16) * PD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = ld4(X + (4 * ty + i) * PD + d);
        const float4 y = ld4(Y + (4 * ty + i) * PD + d);
        hs[i][0] = dot4(x, u0, hs[i][0]);
        hs[i][1] = dot4(x, u1, hs[i][1]);
        hp[i][0] = dot4(y, w0, hp[i][0]);
        hp[i][1] = dot4(y, w1, hp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = h == 0 ? hs[i][j] : s[i][j] + hs[i][j];
        dp[i][j] = h == 0 ? hp[i][j] : dp[i][j] + hp[i][j];
      }
  }
}

// DT consecutive floats of a shared-memory row as one 8- or 16-byte read
template <int DT>
__device__ __forceinline__ void load_dims(const float* p, float (&v)[DT]) {
  if constexpr (DT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    const float4 t = ld4(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
}

// For each pair n: acc[n][i][c] += sum over the tile's rows r, in order, of
// A[n][4 ty + i][r] * B[n][r][DT tx + c] (A of pitch kPP, B of pitch D + 4).
template <int D, int N>
__device__ __forceinline__ void accumulate(const float* const (&A)[N],
                                           const float* const (&B)[N], int ty,
                                           int tx, float (&acc)[N][4][D / 16]) {
  constexpr int PD = D + 4, DT = D / 16;
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(A[n] + (4 * ty + i) * kPP + r);
      float b[4][DT];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_dims<DT>(B[n] + (r + u) * PD + tx * DT, b[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DT; ++c)
          acc[n][i][c] = fmaf(a[i].w, b[3][c], fmaf(a[i].z, b[2][c],
                         fmaf(a[i].y, b[1][c], fmaf(a[i].x, b[0][c], acc[n][i][c]))));
    }
  }
}

// DT f32 values rounded to T, stored as pairs
template <typename T, int DT>
__device__ __forceinline__ void store_dims(T* dst, const float (&v)[DT]) {
#pragma unroll
  for (int c = 0; c < DT; c += 2) store2(dst + c, v[c], v[c + 1]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const int* __restrict__ lengths, T* __restrict__ dq,
                    float* __restrict__ delta, int H, int Nq, int Nk,
                    float sm_scale) {
  constexpr int kSplit = D / kHalf, DT = D / 16, TF = kTileFloats<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // the block's q rows
  float* DOs = Qs + TF;            // and their dO
  float* Ks = DOs + TF;            // [2] key tiles
  float* Vs = Ks + 2 * TF;         // [2] value tiles
  float* DSs = Vs + 2 * TF;        // dS of one tile: (query row, key)
  float* lse_s = DSs + kRows * kPP;
  float* delta_s = lse_s + kRows;

  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int len = max(0, min(lengths[b], Nk));
  const T* kb = k + bh * Nk * D;
  const T* vb = v + bh * Nk * D;

  load_tile<D>(Qs, q + bh * Nq * D, q0, Nq);
  load_tile<D>(DOs, dout + bh * Nq * D, q0, Nq);
  if (threadIdx.x < kRows) load_vec(lse_s, lse + bh * Nq, q0, Nq, threadIdx.x);
  if (len > 0) {
    load_tile<D>(Ks, kb, 0, len);
    load_tile<D>(Vs, vb, 0, len);
  }
  cp_async_commit();

  // delta of row r by thread r (at D 64, threads 2 r and 2 r + 1, a half
  // each, added)
  if (threadIdx.x < kRows * kSplit) {
    const int r = threadIdx.x / kSplit, row = q0 + r;
    float o_dot = 0.f;
    if (row < Nq) {
      const size_t off = (bh * Nq + row) * D + (threadIdx.x % kSplit) * kHalf;
      using P = Piece<T>;
#pragma unroll
      for (int c = 0; c < kHalf; c += P::kLen) {
        float o[P::kLen], g[P::kLen];
        P::load(out + off + c, o);
        P::load(dout + off + c, g);
#pragma unroll
        for (int e = 0; e < P::kLen; ++e) o_dot = fmaf(g[e], o[e], o_dot);
      }
    }
    if constexpr (kSplit == 2) o_dot += __shfl_xor_sync(0xffffffffu, o_dot, 1);
    if (threadIdx.x % kSplit == 0) {
      delta_s[r] = o_dot;
      if (row < Nq) delta[bh * Nq + row] = o_dot;
    }
  }

  float acc[1][4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[0][i][c] = 0.f;

  for (int j = 0, key0 = 0; key0 < len; ++j, key0 += kTile) {
    if (key0 + kTile < len) {
      load_tile<D>(Ks + ((j + 1) & 1) * TF, kb, key0 + kTile, len);
      load_tile<D>(Vs + ((j + 1) & 1) * TF, vb, key0 + kTile, len);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* K = Ks + (j & 1) * TF;
    const float* V = Vs + (j & 1) * TF;
    float s[4][2], dp[4][2];
    dots<D>(Qs, DOs, K, V, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float row_lse = lse_s[r], row_delta = delta_s[r];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float ds = 0.f;
        if (key0 + tx + 16 * jj < len) {
          const float p = expf(s[i][jj] * sm_scale - row_lse);
          ds = round_to<T>(p * (dp[i][jj] - row_delta));
        }
        DSs[r * kPP + tx + 16 * jj] = ds;
      }
    }
    __syncthreads();   // dS is complete
    const float* const A[1] = {DSs};
    const float* const B[1] = {K};
    accumulate<D, 1>(A, B, ty, tx, acc);
    __syncthreads();   // K, V and dS are free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Nq) continue;
    float g[DT];
#pragma unroll
    for (int c = 0; c < DT; ++c) g[c] = acc[0][i][c] * sm_scale;
    store_dims<T, DT>(dq + (bh * Nq + row) * D + tx * DT, g);
  }
}

// Query rows [q0, q0 + 32) for the dk/dv kernel: their q, dO, lse and
// delta; past Nq zeros.
template <int D, typename T>
__device__ __forceinline__ void load_query_tile(
    float* Qs, float* DOs, float* lse_s, float* delta_s, const T* qb,
    const T* dob, const float* lseb, const float* deltab, int q0, int Nq) {
  load_tile<D>(Qs, qb, q0, Nq);
  load_tile<D>(DOs, dob, q0, Nq);
  if (threadIdx.x < kTile)
    load_vec(lse_s, lseb, q0, Nq, threadIdx.x);
  else if (threadIdx.x < 2 * kTile)
    load_vec(delta_s, deltab, q0, Nq, threadIdx.x - kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lengths, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Nq, int Nk,
                     float sm_scale) {
  constexpr int DT = D / 16, TF = kTileFloats<D>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // the block's keys
  float* Vs = Ks + TF;              // and values
  float* Qs = Vs + TF;              // [2] query tiles
  float* DOs = Qs + 2 * TF;         // [2] dO tiles
  float* Ps = DOs + 2 * TF;         // P of one tile: (key, query row)
  float* DSs = Ps + kRows * kPP;    // dS likewise
  float* lse_s = DSs + kRows * kPP; // [2] x 32
  float* delta_s = lse_s + 2 * kTile;

  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int key_base = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int len = max(0, min(lengths[b], Nk));

  // acc[0]: dv, acc[1]: dk (unscaled)
  float acc[2][4][DT];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[n][i][c] = 0.f;

  // A block whose keys all lie past the length only writes zeros.
  if (key_base < len && Nq > 0) {
    const T* qb = q + bh * Nq * D;
    const T* dob = dout + bh * Nq * D;
    const float* lseb = lse + bh * Nq;
    const float* deltab = delta + bh * Nq;
    load_tile<D>(Ks, k + bh * Nk * D, key_base, len);
    load_tile<D>(Vs, v + bh * Nk * D, key_base, len);
    load_query_tile<D>(Qs, DOs, lse_s, delta_s, qb, dob, lseb, deltab, 0, Nq);
    cp_async_commit();

    for (int j = 0, q0 = 0; q0 < Nq; ++j, q0 += kTile) {
      if (q0 + kTile < Nq) {
        const int buf = (j + 1) & 1;
        load_query_tile<D>(Qs + buf * TF, DOs + buf * TF, lse_s + buf * kTile,
                           delta_s + buf * kTile, qb, dob, lseb, deltab,
                           q0 + kTile, Nq);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* Q = Qs + (j & 1) * TF;
      const float* DO = DOs + (j & 1) * TF;
      const float* tile_lse = lse_s + (j & 1) * kTile;
      const float* tile_delta = delta_s + (j & 1) * kTile;
      float s[4][2], dp[4][2];
      dots<D>(Ks, Vs, Q, DO, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool valid = key_base + 4 * ty + i < len;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = tx + 16 * jj;
          float p = 0.f, ds = 0.f;
          if (valid && q0 + r < Nq) {
            p = expf(s[i][jj] * sm_scale - tile_lse[r]);
            ds = round_to<T>(p * (dp[i][jj] - tile_delta[r]));
          }
          Ps[(4 * ty + i) * kPP + r] = p;
          DSs[(4 * ty + i) * kPP + r] = ds;
        }
      }
      __syncthreads();   // P and dS are complete
      const float* const A[2] = {Ps, DSs};
      const float* const B[2] = {DO, Q};
      accumulate<D, 2>(A, B, ty, tx, acc);
      __syncthreads();   // the tile, P and dS are free
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key_base + 4 * ty + i;
    if (key >= Nk) continue;
    const bool valid = key < len;
    float gk[DT], gv[DT];
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      gk[c] = valid ? acc[1][i][c] * sm_scale : 0.f;
      gv[c] = valid ? acc[0][i][c] : 0.f;
    }
    const size_t off = (bh * Nk + key) * D + tx * DT;
    store_dims<T, DT>(dk + off, gk);
    store_dims<T, DT>(dv + off, gv);
  }
}

// dynamic shared memory of each kernel, in bytes
template <int D>
constexpr int dq_smem() {
  return (6 * kTileFloats<D> + kRows * kPP + 2 * kRows) * 4;
}
template <int D>
constexpr int dkv_smem() {
  return (6 * kTileFloats<D> + 2 * kRows * kPP + 4 * kTile) * 4;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, const int* lengths,
              void* dq, float* delta, int B, int H, int Nq, int Nk,
              float sm_scale, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Nq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), lse, lengths, static_cast<T*>(dq), delta,
      H, Nq, Nk, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* lengths,
               void* dk, void* dv, int B, int H, int Nq, int Nk,
               float sm_scale, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Nk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, dkv_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lengths, static_cast<T*>(dk), static_cast<T*>(dv), H, Nq, Nk, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, const int* lengths,
                void* dq, float* delta, int B, int H, int Nq, int Nk, int D,
                float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_dq<T, 32>(q, k, v, out, dout, lse, lengths, dq, delta, B,
                              H, Nq, Nk, sm_scale, stream);
    case 64:
      return launch_dq<T, 64>(q, k, v, out, dout, lse, lengths, dq, delta, B,
                              H, Nq, Nk, sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* lengths, void* dk, void* dv, int B, int H, int Nq,
                 int Nk, int D, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, dout, lse, delta, lengths, dk, dv, B,
                               H, Nq, Nk, sm_scale, stream);
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, lengths, dk, dv, B,
                               H, Nq, Nk, sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, out, dout and the gradients share it;
// lse and delta are f32). Writes dq and delta.
extern "C" int paths_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const int* lengths, void* dq,
    float* delta, int B, int H, int Nq, int Nk, int D, int dtype,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dq<float>(q, k, v, out, dout, lse, lengths, dq, delta, B,
                                H, Nq, Nk, D, sm_scale, s);
    case 1:
      return dispatch_dq<__nv_bfloat16>(q, k, v, out, dout, lse, lengths, dq,
                                        delta, B, H, Nq, Nk, D, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Reads the delta written by paths_flash_attention_bwd_dq; writes dk and dv.
extern "C" int paths_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* lengths, void* dk,
    void* dv, int B, int H, int Nq, int Nk, int D, int dtype, float sm_scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dkv<float>(q, k, v, dout, lse, delta, lengths, dk, dv, B,
                                 H, Nq, Nk, D, sm_scale, s);
    case 1:
      return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, lengths,
                                         dk, dv, B, H, Nq, Nk, D, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paths_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

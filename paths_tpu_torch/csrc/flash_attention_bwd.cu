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
// sequential grid axis; here each block owns (b, h, 64 rows) and loops over
// the streamed operand itself:
//   * dq: a thread keeps its query row's q, dO and dq accumulator in
//     registers; K and V tiles of 32 keys are staged in shared memory, and
//     the loop stops at lengths[b], so masked key tiles are never read. The
//     same kernel writes delta = rowsum(dO o O) for its rows (the TPU code
//     computes it in XLA before the kernels), so the dk/dv kernel, launched
//     after it on the same stream, reads it.
//   * dk/dv: a thread keeps its key row's k, v and both accumulators in
//     registers; Q, dO, lse and delta tiles of 32 query rows stream through
//     shared memory over ALL Nq query rows (padded query rows are real rows:
//     they attend over the valid keys in the forward). No atomics: each
//     output row has one owner, so results are deterministic.
// A thread holds 32 head dims; at D = 64 two neighbouring lanes share a row
// and add their partial dot products with one shuffle. That keeps dk/dv at
// 4 x 32 f32 accumulators a thread (4 x 64 would not fit in 255 registers).
//
// Masking as in the TPU kernels: keys at or past the length get exactly zero
// dk/dv, written out even for blocks wholly past the length; with length 0
// every gradient is zero (the forward's lse is then about -1e30, and no P is
// ever formed from it).
//
// Bound on the card: at the training shapes (D = 32, N <= 257) the work is
// about N / 4 operations per byte moved, so the f32 rate of the CUDA cores
// (TF32 tensor cores stay off for parity) bounds it rather than memory. This
// first version runs on the CUDA cores; shared-memory reads are broadcasts
// (every lane of a warp reads one address, or two at D = 64, which costs a
// two-way bank conflict). Tensor cores (wgmma), TMA and pipelining are later
// work.
//
// C interface (loaded through ctypes): every entry returns the
// cudaError_t of the launch (0 on success).

#include "flash_common.cuh"

namespace {

using namespace paths_cuda;

constexpr int kSlice = 32;  // head dims held by one thread
constexpr int kRows = 64;   // rows owned by a block (query rows / key rows)
constexpr int kTile = 32;   // rows of the streamed operand staged per step

template <typename T>
__device__ __forceinline__ void load_slice(const T* src, float* dst) {
  using P = Piece<T>;
#pragma unroll
  for (int i = 0; i < kSlice / P::kLen; ++i)
    P::load(src + i * P::kLen, dst + i * P::kLen);
}

template <typename T>
__device__ __forceinline__ void store_slice(const float* src, T* dst) {
  using P = Piece<T>;
#pragma unroll
  for (int i = 0; i < kSlice / P::kLen; ++i)
    P::store(src + i * P::kLen, dst + i * P::kLen);
}

// Sum over the kSplit neighbouring lanes that share one row.
template <int kSplit>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [r0, r0 + rows) of a row-major (N, D) matrix into an f32
// (kTile, D) tile; rows past `rows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* src, int r0, int rows,
                                      float (*tile)[D], int tid, int nthreads) {
  using P = Piece<T>;
  constexpr int kPieces = D / P::kLen;
  for (int i = tid; i < kTile * kPieces; i += nthreads) {
    const int r = i / kPieces;
    const int c = (i % kPieces) * P::kLen;
    if (r < rows) {
      P::load(src + static_cast<size_t>(r0 + r) * D + c, &tile[r][c]);
    } else {
#pragma unroll
      for (int j = 0; j < P::kLen; ++j) tile[r][c + j] = 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kSlice))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const int* __restrict__ lengths, T* __restrict__ dq,
                    float* __restrict__ delta, int H, int Nq, int Nk,
                    float sm_scale) {
  constexpr int kSplit = D / kSlice;
  constexpr int kThreads = kRows * kSplit;
  __shared__ __align__(16) float k_s[kTile][D];
  __shared__ __align__(16) float v_s[kTile][D];

  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * kRows + threadIdx.x / kSplit;
  const bool active = row < Nq;
  const int len = max(0, min(lengths[b], Nk));
  const T* kb = k + bh * Nk * D;
  const T* vb = v + bh * Nk * D;
  const size_t off = (bh * Nq + row) * D + part * kSlice;

  float qr[kSlice];
  float dor[kSlice];
  float acc[kSlice];
  float row_lse = 0.f;
  float o_dot = 0.f;
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    qr[d] = 0.f;
    dor[d] = 0.f;
    acc[d] = 0.f;
  }
  if (active) {
    float o[kSlice];
    load_slice(q + off, qr);
    load_slice(dout + off, dor);
    load_slice(out + off, o);
#pragma unroll
    for (int d = 0; d < kSlice; ++d) o_dot = fmaf(dor[d], o[d], o_dot);
    row_lse = lse[bh * Nq + row];
  }
  const float row_delta = row_sum<kSplit>(o_dot);
  if (active && part == 0) delta[bh * Nq + row] = row_delta;

  for (int k0 = 0; k0 < len; k0 += kTile) {
    const int rows = min(kTile, len - k0);
    __syncthreads();  // the previous tile has been consumed
    stage<T, D>(kb, k0, rows, k_s, threadIdx.x, kThreads);
    stage<T, D>(vb, k0, rows, v_s, threadIdx.x, kThreads);
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float* kj = &k_s[j][part * kSlice];
      const float* vj = &v_s[j][part * kSlice];
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < kSlice; ++d) {
        s = fmaf(qr[d], kj[d], s);
        dp = fmaf(dor[d], vj[d], dp);
      }
      s = row_sum<kSplit>(s);
      dp = row_sum<kSplit>(dp);
      const float p = expf(s * sm_scale - row_lse);
      const float ds = round_to<T>(p * (dp - row_delta));
#pragma unroll
      for (int d = 0; d < kSlice; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < kSlice; ++d) acc[d] *= sm_scale;
    store_slice(acc, dq + off);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kSlice))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lengths, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Nq, int Nk,
                     float sm_scale) {
  constexpr int kSplit = D / kSlice;
  constexpr int kThreads = kRows * kSplit;
  __shared__ __align__(16) float q_s[kTile][D];
  __shared__ __align__(16) float do_s[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int part = threadIdx.x % kSplit;
  const int key = blockIdx.x * kRows + threadIdx.x / kSplit;
  const bool active = key < Nk;
  const int len = max(0, min(lengths[b], Nk));
  const bool valid = key < len;
  const size_t off = (bh * Nk + key) * D + part * kSlice;

  float acc_k[kSlice];
  float acc_v[kSlice];
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    acc_k[d] = 0.f;
    acc_v[d] = 0.f;
  }

  // A block whose keys all lie past the length only writes zeros.
  if (static_cast<int>(blockIdx.x) * kRows < len) {
    float kr[kSlice];
    float vr[kSlice];
#pragma unroll
    for (int d = 0; d < kSlice; ++d) {
      kr[d] = 0.f;
      vr[d] = 0.f;
    }
    if (valid) {
      load_slice(k + off, kr);
      load_slice(v + off, vr);
    }
    const T* qb = q + bh * Nq * D;
    const T* dob = dout + bh * Nq * D;
    const float* lseb = lse + bh * Nq;
    const float* deltab = delta + bh * Nq;

    for (int q0 = 0; q0 < Nq; q0 += kTile) {
      const int rows = min(kTile, Nq - q0);
      __syncthreads();  // the previous tile has been consumed
      stage<T, D>(qb, q0, rows, q_s, threadIdx.x, kThreads);
      stage<T, D>(dob, q0, rows, do_s, threadIdx.x, kThreads);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        lse_s[i] = i < rows ? lseb[q0 + i] : 0.f;
        delta_s[i] = i < rows ? deltab[q0 + i] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < rows; ++i) {
        const float* qi = &q_s[i][part * kSlice];
        const float* doi = &do_s[i][part * kSlice];
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < kSlice; ++d) {
          s = fmaf(qi[d], kr[d], s);
          dp = fmaf(doi[d], vr[d], dp);
        }
        s = row_sum<kSplit>(s);
        dp = row_sum<kSplit>(dp);
        const float p = valid ? expf(s * sm_scale - lse_s[i]) : 0.f;
        const float ds = round_to<T>(p * (dp - delta_s[i]));
#pragma unroll
        for (int d = 0; d < kSlice; ++d) {
          acc_v[d] = fmaf(p, doi[d], acc_v[d]);
          acc_k[d] = fmaf(ds, qi[d], acc_k[d]);
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < kSlice; ++d) {
      acc_k[d] = valid ? acc_k[d] * sm_scale : 0.f;
      acc_v[d] = valid ? acc_v[d] : 0.f;
    }
    store_slice(acc_k, dk + off);
    store_slice(acc_v, dv + off);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, const int* lengths,
              void* dq, float* delta, int B, int H, int Nq, int Nk,
              float sm_scale, cudaStream_t stream) {
  const dim3 grid((Nq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kRows * (D / kSlice), 0, stream>>>(
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
  const dim3 grid((Nk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kRows * (D / kSlice), 0, stream>>>(
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

// Tiled pieces of the ViT block kernels (`vit_fused.cu`: `fused_attn_block`,
// `fused_mlp_block`, `fused_swiglu_mlp_block`, `fused_block`; `vit_int8.cu`:
// `fused_attn_block_i8`, `fused_mlp_block_i8`, `fused_swiglu_mlp_block_i8`):
// head_dim, the LayerNorm epsilon, warp sums and the activations; the
// LayerNorm pre-pass, the GEMMs with their epilogue hooks (a gated one for
// the packed SwiGLU), and the attention core that streams K and V in key
// tiles. The design notes are at the top of `vit_fused.cu` and
// `vit_int8.cu`.
//
// Tensor cores. The bf16 projections use `wgmma` (m64n128k16, f32
// accumulation) and the int8 ones `wgmma` on s8 codes (m64n128k32, s32
// accumulation) on tiles that TMA brings in, with a producer warp and
// mbarriers in place of block-wide barriers (an `mma.sync` GEMM over the same
// tiles, fed by `cp.async`, reached about half its rate on the H100). The
// attention's q k^T and P V use `mma.sync.m16n8k16` fed by `ldmatrix` from a
// `cp.async` double buffer: per head its products are 64 keys wide, and its
// score fragments become P V's A operand in registers without passing
// through shared memory. f32 (the parity mode) multiplies with FMAs on the
// CUDA cores, no TF32.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "flash_common.cuh"

namespace paths_cuda {
namespace vit {

constexpr int kHD = 64;         // head_dim of the block kernels
constexpr int kHD80 = 80;       // the attention tiles' other head_dim (Virchow2)
constexpr float kLnEps = 1e-6f;

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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace vit

namespace tiles {

using vit::kHD;
using vit::kHD80;

template <typename T>
constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;

// ------------------------------------------------------- LayerNorm pre-pass
constexpr int kLnThreads = 256;
constexpr int kLnRows = kLnThreads / 32;

// y = LN(x) rounded to T, one warp per row of (R, D); D % (16 / sizeof T)
// == 0. The statistics are taken once per row, in two passes over it. A row
// of up to kLnPieces 16-byte pieces per lane (1280 bf16, 640 f32 values) is
// read once into registers, all its loads in flight together; a longer row
// is read again from the caches for each pass.
constexpr int kLnPieces = 5;

template <typename T>
__device__ __forceinline__ void layernorm_rows(const T* __restrict__ x,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias,
                                               T* __restrict__ y, int R, int D) {
  constexpr int PL = Piece<T>::kLen;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRows + threadIdx.x / 32;
  if (row >= R) return;
  const T* xr = x + static_cast<size_t>(row) * D;
  T* yr = y + static_cast<size_t>(row) * D;
  auto normalise = [&](int k, float (&v)[PL], float mu, float rstd) {
#pragma unroll
    for (int i = 0; i < PL; i += 4) {
      const float4 sc = *reinterpret_cast<const float4*>(scale + k + i);
      const float4 bi = *reinterpret_cast<const float4*>(bias + k + i);
      v[i] = (v[i] - mu) * rstd * sc.x + bi.x;
      v[i + 1] = (v[i + 1] - mu) * rstd * sc.y + bi.y;
      v[i + 2] = (v[i + 2] - mu) * rstd * sc.z + bi.z;
      v[i + 3] = (v[i + 3] - mu) * rstd * sc.w + bi.w;
    }
    Piece<T>::store(v, yr + k);
  };
  if (D <= 32 * PL * kLnPieces) {
    float v[kLnPieces][PL];
#pragma unroll
    for (int j = 0; j < kLnPieces; ++j) {
      const int k = (lane + 32 * j) * PL;
      if (k < D) Piece<T>::load(xr + k, v[j]);
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kLnPieces; ++j)
      if ((lane + 32 * j) * PL < D) {
#pragma unroll
        for (int i = 0; i < PL; ++i) s += v[j][i];
      }
    const float mu = vit::warp_sum(s) / D;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < kLnPieces; ++j)
      if ((lane + 32 * j) * PL < D) {
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          const float d = v[j][i] - mu;
          var = fmaf(d, d, var);
        }
      }
    const float rstd = rsqrtf(vit::warp_sum(var) / D + vit::kLnEps);
#pragma unroll
    for (int j = 0; j < kLnPieces; ++j) {
      const int k = (lane + 32 * j) * PL;
      if (k < D) normalise(k, v[j], mu, rstd);
    }
    return;
  }
  float s = 0.f;
  for (int k = lane * PL; k < D; k += 32 * PL) {
    float v[PL];
    Piece<T>::load(xr + k, v);
#pragma unroll
    for (int i = 0; i < PL; ++i) s += v[i];
  }
  const float mu = vit::warp_sum(s) / D;
  float var = 0.f;
  for (int k = lane * PL; k < D; k += 32 * PL) {
    float v[PL];
    Piece<T>::load(xr + k, v);
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const float d = v[i] - mu;
      var = fmaf(d, d, var);
    }
  }
  const float rstd = rsqrtf(vit::warp_sum(var) / D + vit::kLnEps);
  for (int k = lane * PL; k < D; k += 32 * PL) {
    float v[PL];
    Piece<T>::load(xr + k, v);
    normalise(k, v, mu, rstd);
  }
}

// ----------------------------------------------------------- GEMM epilogues
// The f32 value stored at (row, col) of out (M, N) for the accumulator `acc`
// (f32, or s32 for the int8 GEMM); the caller rounds it to the output type.
// A gated epilogue has `static constexpr bool kGated = true` and takes two
// accumulators.
struct EpiBias {              // acc + bias
  const float* bias;
  __device__ __forceinline__ float operator()(int, int col, float acc) const {
    return acc + bias[col];
  }
};

template <int ACT>
struct EpiGelu {              // gelu(acc + bias)
  const float* bias;
  __device__ __forceinline__ float operator()(int, int col, float acc) const {
    return vit::gelu<ACT>(acc + bias[col]);
  }
};

template <typename T>
struct EpiResidual {          // resid + (acc + bias) ls
  const T* resid;             // (M, ld)
  const float* bias;
  const float* ls;
  int ld;
  __device__ __forceinline__ float operator()(int row, int col, float acc) const {
    return to_float(resid[static_cast<size_t>(row) * ld + col]) +
           (acc + bias[col]) * ls[col];
  }
};

// silu(gate + bg) (value + bv) at hidden column col of fc1 over the packed
// (2H, K) weight, gate rows first: `gate` is the product with W row col,
// `val` with W row H + col.
struct EpiSwiglu {
  static constexpr bool kGated = true;
  const float* bias;          // (2H): the gate biases, then the value biases
  int H;
  __device__ __forceinline__ float operator()(int, int col, float gate,
                                              float val) const {
    const float g = gate + bias[col];
    return g / (1.f + expf(-g)) * (val + bias[H + col]);
  }
};

// A GEMM with a gated epilogue computes out (M, N) from W (2N, K): a tile
// covers half as many output columns, and its W stage holds rows
// [n0, n0 + BN / 2) of the gate half above the same rows of the value half,
// so that output column c and its value partner c + BN / 2 of the tile land
// in one thread's accumulators; the epilogue pairs them there.
template <typename Epi, typename = void>
struct IsGated : std::false_type {};
template <typename Epi>
struct IsGated<Epi, std::void_t<decltype(Epi::kGated)>>
    : std::bool_constant<Epi::kGated> {};
template <typename Epi>
constexpr bool kGlu = IsGated<Epi>::value;

// ------------------------------------------- GEMM: TMA + wgmma, bf16 or int8
// out = epi(A W^T), A (M, K) and W (N, K) row-major, both bf16 or both int8
// codes, as 128 x 128 output tiles. A block is 2 consumer warpgroups and one
// producer warp. One thread of the producer streams slabs of one 128-byte
// swizzle row -- 64 columns of bf16, 128 of int8 -- of A (128 rows) and W
// (128 rows) by TMA into a ring of kWStages stages (128-byte swizzle; zeros
// past the edges of M, N and K: code 0 for int8), each stage guarded by a
// "full" and an "empty" mbarrier. Each consumer warpgroup multiplies 64 rows
// of the tile with `wgmma` (bf16: m64n128k16 into f32; int8: m64n128k32
// into s32), 4 per slab of 32 bytes of K each, operands read from shared
// memory through descriptors; it keeps one group of products in flight,
// releases a stage once its products are done, and applies the epilogue from
// registers. Two blocks fit an SM (registers and shared memory), so one
// block's epilogue runs beside the other's products: the epilogue (GELU of
// fc1 above all) costs as much as a slab's products and would otherwise
// idle the tensor cores. With a gated epilogue (`kGlu`) the W slab comes as
// two 64-row boxes, one from the map `mw` of the gate half and one from the
// map `mv` of the value half, each with zeros past row N; both land where
// one 128-row box would (64 rows of 128 bytes are whole 1024-byte swizzle
// atoms), so the stage's bytes and the operand descriptors do not change.
//
// CHUNKED (int8): the contraction is cut into spans of `epi.span` columns,
// each with a row scale of A of its own (the int8 MLP's hidden activation is
// quantised per chunk). At each span boundary -- a multiple of 32 columns,
// so between two k32 steps, possibly inside a slab -- a consumer waits for
// its products, adds `epi.chunk(row, col, c, acc)` to an f32 sum per output
// and clears the accumulators; the epilogue then stores
// `epi.finish(row, col, sum)`. The sums double the accumulator registers, so
// a chunked block has an SM to itself.
constexpr int kWBM = 128, kWBN = 128;
constexpr int kWStages = 3;
constexpr int kWThreads = 288;   // warpgroups 0, 1: consumers; warp 8: producer
constexpr int kWABytes = kWBM * 128;
constexpr int kWStageBytes = kWABytes + kWBN * 128;
// the ring (1024-byte aligned, as the swizzle wants), then 2 kWStages barriers
constexpr size_t kWSmem = 1024 + kWStages * kWStageBytes + 2 * kWStages * 8;

// Columns of K in one slab: one 128-byte swizzle row.
template <typename In>
constexpr int kSlabCols = 128 / static_cast<int>(sizeof(In));

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// The box of `map` at (column c0, row c1) into dst; completion counted on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            unsigned long long* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(c1)
      : "memory");
}

// Descriptor of a K-major operand (bf16 or int8) in shared memory written by
// TMA with the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes
// apart. One wgmma step along K (16 bf16 or 32 int8 columns) adds 32 bytes
// to the start address.
__device__ __forceinline__ unsigned long long sw128_desc(const void* p) {
  const unsigned long long addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128), both bf16 in shared memory
// behind the descriptors da and db.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                unsigned long long da,
                                                unsigned long long db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

// d (64 x 128, s32) += A (64 x 32) B (32 x 128), both s8 codes in shared
// memory behind the descriptors da and db. The s8 form has no transpose or
// operand-scale immediates: both operands are K-major, as the codes and the
// weights (rows, K) are. int32 sums of codes are exact in any order.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64],
                                                   unsigned long long da,
                                                   unsigned long long db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

// The wgmma of an operand type: bf16 into f32 (k16) or int8 codes into s32
// (k32); either takes 32 bytes of K.
template <typename In>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16> {
  using Acc = float;
  __device__ __forceinline__ static void mma(float (&d)[64], unsigned long long da,
                                             unsigned long long db) {
    wgmma_m64n128k16(d, da, db);
  }
};

template <>
struct Wgmma<signed char> {
  using Acc = int;
  __device__ __forceinline__ static void mma(int (&d)[64], unsigned long long da,
                                             unsigned long long db) {
    wgmma_m64n128k32_s8(d, da, db);
  }
};

// Pins the accumulators at this point of the instruction stream: the
// compiler may not move their reads or writes across it (an async wgmma
// writes them behind its back).
template <typename Acc>
__device__ __forceinline__ void fence_acc(Acc (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if constexpr (std::is_same<Acc, int>::value)
      asm volatile("" : "+r"(acc[i])::"memory");
    else
      asm volatile("" : "+f"(acc[i])::"memory");
  }
}

template <typename In, bool CHUNKED = false, typename Out, typename Epi>
__device__ __forceinline__ void gemm_tma_block(const CUtensorMap* ma,
                                               const CUtensorMap* mw,
                                               const CUtensorMap* mv,
                                               Out* __restrict__ out, int M,
                                               int N, int K, int m0, int n0,
                                               Epi epi, unsigned char* smem_raw) {
  static_assert(!(CHUNKED && kGlu<Epi>), "a chunked GEMM has no gated epilogue");
  using Acc = typename Wgmma<In>::Acc;
  constexpr int BK = kSlabCols<In>;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) / 1024 * 1024);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + kWStages * kWStageBytes);
  unsigned long long* empty = full + kWStages;
  const int t = threadIdx.x, wg = t / 128, tw = t % 128;
  const int KT = (K + BK - 1) / BK;
  if (t == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {   // producer
    if (t == 256) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kWStages;
        if (kt >= kWStages) mbar_wait(&empty[s], ((kt / kWStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kWStageBytes);
        unsigned char* sa = ring + s * kWStageBytes;
        tma_load_2d(sa, ma, &full[s], kt * BK, m0);
        tma_load_2d(sa + kWABytes, mw, &full[s], kt * BK, n0);
        if constexpr (kGlu<Epi>)
          tma_load_2d(sa + kWABytes + kWBN / 2 * 128, mv, &full[s], kt * BK, n0);
      }
    }
    return;
  }

  const int c = wg;   // rows 64 c .. 64 c + 63 of the tile
  // acc[4 j + e]: row 16 w + g (e 0, 1) or + 8 (e 2, 3), column 8 j + 2 tq
  // + e % 2, as an `mma.sync` accumulator fragment per 8 columns; gated, the
  // value partner of column 8 j + .. (j < 8) is acc[4 (j + 8) + e]
  const int w = tw / 32, lane = tw % 32, g = lane / 4, tq = lane % 4;
  Acc acc[kWBN / 2];
#pragma unroll
  for (int i = 0; i < kWBN / 2; ++i) acc[i] = 0;
  float sum[CHUNKED ? kWBN / 2 : 1];
  int chunk = 0;
  // CHUNKED: the finished chunk's products into the sums; accumulators cleared
  auto flush = [&] {
    if constexpr (CHUNKED) {
      fence_acc(acc);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + c * 64 + w * 16 + g + half * 8;
#pragma unroll
        for (int j = 0; j < kWBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e, col = n0 + j * 8 + tq * 2 + e;
            if (row < M && col < N)
              sum[i] = __fadd_rn(sum[i], epi.chunk(row, col, chunk, acc[i]));
            acc[i] = 0;
          }
      }
      fence_acc(acc);   // the zeros are written before the next wgmma.fence
      ++chunk;
    }
  };
  if constexpr (CHUNKED) {
#pragma unroll
    for (int i = 0; i < kWBN / 2; ++i) sum[i] = 0.f;
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kWStages;
    mbar_wait(&full[s], (kt / kWStages) & 1);
    const unsigned char* sa = ring + s * kWStageBytes + c * 64 * 128;
    const unsigned char* sw = ring + s * kWStageBytes + kWABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (CHUNKED) {
        const int k = kt * BK + kk * (BK / 4);
        if (k > 0 && k < K && k % epi.span == 0) {   // a chunk ends here
          wgmma_commit();
          wgmma_wait<0>();
          flush();
          wgmma_fence();
        }
      }
      Wgmma<In>::mma(acc, sw128_desc(sa + kk * 32), sw128_desc(sw + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();   // the products of slab kt - 1 are done: release it
    if (kt > 0 && tw == 0) mbar_arrive(&empty[(kt - 1) % kWStages]);
  }
  wgmma_wait<0>();
  flush();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + c * 64 + w * 16 + g + half * 8;
    if (row >= M) continue;
    Out* orow = out + static_cast<size_t>(row) * N;
    if constexpr (kGlu<Epi>) {
#pragma unroll
      for (int j = 0; j < kWBN / 16; ++j) {
        const int col = n0 + j * 8 + tq * 2, e = 4 * j + 2 * half;
        if (col < N)
          store2(orow + col, epi(row, col, acc[e], acc[e + kWBN / 4]),
                 epi(row, col + 1, acc[e + 1], acc[e + 1 + kWBN / 4]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kWBN / 8; ++j) {
        const int col = n0 + j * 8 + tq * 2, e = 4 * j + 2 * half;
        if (col < N) {
          if constexpr (CHUNKED)
            store2(orow + col, epi.finish(row, col, sum[e]),
                   epi.finish(row, col + 1, sum[e + 1]));
          else
            store2(orow + col, epi(row, col, acc[e]), epi(row, col + 1, acc[e + 1]));
        }
      }
    }
  }
}

// Output columns of one GEMM tile: half the tile for a gated epilogue.
template <typename Epi>
constexpr int kTileN = kWBN / (kGlu<Epi> ? 2 : 1);

// ma, mw: TMA maps of A (M, K) and W (N, K); gated, mw and mv map the gate
// and the value half of W (2N, K), else mv is unused
template <typename In, bool CHUNKED, typename Out, typename Epi>
__global__ void __launch_bounds__(kWThreads, CHUNKED ? 1 : 2)
gemm_tma_kernel(const __grid_constant__ CUtensorMap ma,
                const __grid_constant__ CUtensorMap mw,
                const __grid_constant__ CUtensorMap mv, Out* __restrict__ out,
                int M, int N, int K, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  gemm_tma_block<In, CHUNKED>(&ma, &mw, &mv, out, M, N, K, blockIdx.y * kWBM,
                              blockIdx.x * kTileN<Epi>, epi, smem_raw);
}

// A TMA map of a (rows, K) row-major matrix of bf16 or int8 codes, read in
// boxes of one slab (kSlabCols<In> columns) x box_rows rows with the 128-byte
// swizzle; zeros past its edges. K * sizeof(In) % 16 == 0.
// `cuTensorMapEncodeTiled` is found through the runtime's entry-point query,
// so the libraries link no libcuda.
template <typename In>
inline cudaError_t tensor_map(CUtensorMap* map, const In* ptr, int rows, int K,
                              int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (rc != cudaSuccess) return rc;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr)
      return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(In)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlabCols<In>),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(In) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<In*>(ptr), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// out (M, N) = epi(a (M, K) w (N, K)^T) on stream s; with a gated epilogue w
// is (2N, K), gate rows first, and out (M, N) = epi(a w[:N]^T, a w[N:]^T)
template <typename In, bool CHUNKED = false, typename Out, typename Epi>
cudaError_t gemm_tma(const In* a, const In* w, Out* out, int M, int N, int K,
                     Epi epi, cudaStream_t s) {
  constexpr int BN = kTileN<Epi>;
  const dim3 grid((N + BN - 1) / BN, (M + kWBM - 1) / kWBM);
  CUtensorMap ma, mw, mv;
  cudaError_t rc;
  if ((rc = tensor_map(&ma, a, M, K, kWBM)) != cudaSuccess) return rc;
  if ((rc = tensor_map(&mw, w, N, K, BN)) != cudaSuccess) return rc;
  if constexpr (kGlu<Epi>) {
    if ((rc = tensor_map(&mv, w + static_cast<size_t>(N) * K, N, K, BN)) != cudaSuccess)
      return rc;
  } else {
    mv = mw;
  }
  rc = vit::allow_smem(gemm_tma_kernel<In, CHUNKED, Out, Epi>, kWSmem);
  if (rc != cudaSuccess) return rc;
  gemm_tma_kernel<In, CHUNKED, Out, Epi><<<grid, kWThreads, kWSmem, s>>>(
      ma, mw, mv, out, M, N, K, epi);
  return cudaGetLastError();
}

// --------------------------------------------------- f32 GEMM: CUDA cores
// out = epi(A W^T) in f32 for one 128 x 128 tile, 16 x 16 threads of 8 x 8
// outputs (rows ty 8 + i, columns tx + 16 j; a quarter warp reads one A row,
// a broadcast, and 8 neighbouring W rows). Both operands stream in 64-byte
// rows (16 values of the contraction) through a ring of kStages `cp.async`
// stages; rows are 80 bytes apart in shared memory, so that float4 reads of 8
// neighbouring rows fall on distinct banks. Rows past M or N are read as
// zeros; K % 16 == 0. Gated (`kGlu`), the tile covers 64 output columns: W
// tile rows r < 64 are gate rows n0 + r, rows r >= 64 value rows
// N + n0 + r - 64, so a thread's columns j and j + 4 are partners.
constexpr int kTM = 128, kTN = 128;
constexpr int kBK = 16;
constexpr int kPitch = 80;
constexpr int kStages = 4;
constexpr int kF32Threads = 256;
constexpr int kStageBytes = (kTM + kTN) * kPitch;
constexpr size_t kF32Smem = static_cast<size_t>(kStages) * kStageBytes;

template <typename Epi>
__device__ __forceinline__ void gemm_f32_block(const float* __restrict__ A,
                                               const float* __restrict__ W,
                                               int M, int N, int K, int m0,
                                               int n0, float* __restrict__ out,
                                               Epi epi, unsigned char* smem) {
  const int t = threadIdx.x;
  // stage s <- contraction columns [kt 16, kt 16 + 16) of both tiles: 128
  // rows x 4 pieces of 16 bytes each
  auto load = [&](int s, int kt) {
    unsigned char* sa = smem + s * kStageBytes;
    unsigned char* sw = sa + kTM * kPitch;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kTM * 4 / kF32Threads; ++i) {
      const int c = t + i * kF32Threads;
      const int r = c / 4, piece = c % 4;
      const int ar = m0 + r;
      int wr = n0 + r;
      bool w_in = wr < N;
      if constexpr (kGlu<Epi>) {
        const int hr = n0 + r % (kTN / 2);
        w_in = hr < N;
        wr = r < kTN / 2 ? hr : N + hr;
      }
      cp_async16(sa + r * kPitch + piece * 16,
                 A + static_cast<size_t>(ar < M ? ar : 0) * K + k0 + piece * 4,
                 ar < M);
      cp_async16(sw + r * kPitch + piece * 16,
                 W + static_cast<size_t>(w_in ? wr : 0) * K + k0 + piece * 4,
                 w_in);
    }
  };

  const int KT = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  const int ty = t / 16, tx = t % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage kt has landed; stage kt - 1 is free
    if (kt + kStages - 1 < KT) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const unsigned char* sa = smem + (kt % kStages) * kStageBytes;
    const unsigned char* sw = sa + kTM * kPitch;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = *reinterpret_cast<const float4*>(sw + (tx + 16 * j) * kPitch + kk * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(sa + (ty * 8 + i) * kPitch + kk * 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a.x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, w[j].w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= M) continue;
    float* orow = out + static_cast<size_t>(row) * N;
    if constexpr (kGlu<Epi>) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < N) orow[col] = epi(row, col, acc[i][j], acc[i][j + 4]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < N) orow[col] = epi(row, col, acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------- attention, streamed keys
// ctx[b, q0 .. q0 + 63, h 64 : (h + 1) 64] = softmax(q k^T / 8) v for head h
// of image b, with q, k, v read from the (B, N, 3D) qkv scratch (columns
// [q | k | v], each split by head). K and V stream through shared memory in
// tiles of 64 keys, so any N works. Two passes over the keys: the first finds
// each row's max (and, for NORM_FIRST, its row sum, rescaled as the max
// grows); the second takes P = exp(s - m) against that final max, so P is
// rounded to T where the TPU kernel rounds it. NORM_FIRST false: P rounded,
// the context divided afterwards by the row sum of the unrounded P, then
// rounded. NORM_FIRST true: P times the reciprocal of its row sum, rounded,
// and P V rounded. exp is the fast `__expf` (within 2 + 1.2 |x| f32 ulps of
// exp(x), far below a bf16 rounding where P matters) and the divide by the
// row sum a multiply by its reciprocal: the accurate forms cost more than the
// products. Keys past N get a score of
// -1e30 (P = 0) and zero rows of V; rows past N are computed and not stored.
//
// Head dims: HD 64 (every encoder but Virchow2) and 80 (Virchow2: q k^T over
// k = 5 x 16, P V over n = 10 x 8). A row of a tile is HD + 8 bf16 or HD + 4
// f32 wide (64: 144 / 272 bytes; 80: 176 / 336): 16-byte aligned, and the 8
// rows of an `ldmatrix` or a quarter warp's float4 reads fall on 8 distinct
// groups of 4 banks.
constexpr int kQT = 64;    // query rows per block (f32)
constexpr int kQTBf16 = 128;   // query rows per block (bf16)
constexpr int kKT = 64;    // keys per streamed tile
constexpr int kAttnThreadsBf16 = 128;   // 4 warps of 32 query rows
constexpr int kAttnThreadsF32 = 256;    // 16 x 16 threads
template <int HD>
constexpr int kAPOf = HD + 8;           // row pitch of a bf16 tile
template <int HD>
constexpr int kAPFOf = HD + 4;          // row pitch of an f32 tile
template <int HD>   // 2 K, 2 V
constexpr size_t kAttnSmemBf16Of = 4 * kKT * kAPOf<HD> * sizeof(__nv_bfloat16);
template <int HD>   // Q, K, V, P
constexpr size_t kAttnSmemF32Of = 4 * kQT * kAPFOf<HD> * sizeof(float);
constexpr size_t kAttnSmemBf16 = kAttnSmemBf16Of<kHD>;
constexpr size_t kAttnSmemF32 = kAttnSmemF32Of<kHD>;
// 1 / sqrt(HD), the scale of the scores
template <int HD>
constexpr float kScoreScale = HD == kHD ? 0.125f : 0.111803398874989485f;
template <int HD>
constexpr bool kAttnHeadDim = HD == kHD || HD == kHD80;

// 64 rows x HD columns of T from qkv rows row0.. of image b, column col, into
// dst (row pitch `pitch` elements); rows past N are zeros.
template <typename T, int THREADS, int HD = kHD>
__device__ __forceinline__ void load_head_tile(T* dst, int pitch,
                                               const T* __restrict__ qkv,
                                               int b, int N, int ld, int row0,
                                               int col) {
  constexpr int PE = 16 / static_cast<int>(sizeof(T));
  constexpr int PIECES = kKT * HD / PE;
  static_assert(PIECES % THREADS == 0, "whole pieces per thread");
#pragma unroll
  for (int i = 0; i < PIECES / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / (HD / PE), p = c % (HD / PE);
    const int row = row0 + r;
    cp_async16(dst + r * pitch + p * PE,
               qkv + (static_cast<size_t>(b) * N + (row < N ? row : 0)) * ld +
                   col + p * PE,
               row < N);
  }
}

// bf16 on the tensor cores: 128 query rows per block, 4 warps, warp w owning
// rows 32 w + 16 mi .. + 15 (mi < 2) of the tile, so that every K or V
// fragment read from shared memory feeds two `mma`s and every K and V tile
// brought in from L2 serves 128 rows. S (32 x 64 keys per warp) stays in
// registers as accumulator fragments, whose layout is that of the A operand
// of P V once packed to bf16 pairs. Shared memory: K tiles 0 and 1, V tiles
// 0 and 1; Q passes through the V tiles before the first pass. The context
// is stored as CT: rounded to bf16, or unrounded in f32 (the int8 block
// quantises the f32 context). A head is HD wide: q fragments over HD / 16
// slabs of k, context fragments over HD / 8 tiles of n.
template <bool NORM_FIRST, typename CT = __nv_bfloat16, int HD = kHD>
__device__ __forceinline__ void attn_tile_bf16(
    const __nv_bfloat16* __restrict__ qkv, CT* __restrict__ ctx,
    int b, int h, int q0, int N, int D, unsigned char* smem) {
  static_assert(kAttnHeadDim<HD>, "head_dim 64 or 80");
  using bf16 = __nv_bfloat16;
  constexpr int TH = kAttnThreadsBf16;
  constexpr int AP = kAPOf<HD>;
  constexpr int KC = HD / 16, DT = HD / 8;
  bf16* base = reinterpret_cast<bf16*>(smem);
  auto Ks = [&](int j) { return base + (j & 1) * kKT * AP; };
  auto Vs = [&](int j) { return base + (2 + (j & 1)) * kKT * AP; };
  bf16* Qs = Vs(0);   // 128 rows: V tiles 0 and 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int ld = 3 * D, kcol = D + h * HD, vcol = 2 * D + h * HD;
  const int KT = (N + kKT - 1) / kKT;
  constexpr unsigned kAll = 0xffffffffu;

  // s[mi][nt][e]: rows 32 warp + 16 mi + g (e 0, 1) or + 8 (e 2, 3), keys
  // key0 + 8 nt + 2 tq + e % 2
  auto scores = [&](float (&s)[2][8][4], const unsigned (&qf)[2][KC][4],
                    const bf16* K, int key0) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kf[4];
        ldmatrix_x4(kf, K + (np * 16 + lane % 8 + (lane / 16) * 8) * AP + kc * 16 +
                            ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(s[mi][2 * np], qf[mi][kc], kf[0], kf[1]);
          mma_bf16(s[mi][2 * np + 1], qf[mi][kc], kf[2], kf[3]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][nt][e] *= kScoreScale<HD>;
    if (key0 + kKT > N) {   // the ragged last tile
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + nt * 8 + tq * 2 + e % 2 >= N) s[mi][nt][e] = kNegInf;
    }
  };

  // ---- pass 1: row max (and row sum)
  unsigned qf[2][KC][4];
  float m[2][2], l[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mi][r] = kNegInf;
      l[mi][r] = 0.f;
    }
  load_head_tile<bf16, TH, HD>(Qs, AP, qkv, b, N, ld, q0, h * HD);
  load_head_tile<bf16, TH, HD>(Qs + kKT * AP, AP, qkv, b, N, ld, q0 + kKT, h * HD);
  load_head_tile<bf16, TH, HD>(Ks(0), AP, qkv, b, N, ld, 0, kcol);
  cp_async_commit();
  for (int j = 0; j < KT; ++j) {
    if (j + 1 < KT)
      load_head_tile<bf16, TH, HD>(Ks(j + 1), AP, qkv, b, N, ld, (j + 1) * kKT, kcol);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          ldmatrix_x4(qf[mi][kc], Qs + (warp * 32 + mi * 16 + lane % 16) * AP +
                                      kc * 16 + (lane / 16) * 8);
    }
    float s[2][8][4];
    scores(s, qf, Ks(j), j * kKT);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float mx[2] = {m[mi][0], m[mi][1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mi][nt][0], s[mi][nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mi][nt][2], s[mi][nt][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 2));
      }
      if (NORM_FIRST) {
#pragma unroll
        for (int r = 0; r < 2; ++r) l[mi][r] *= __expf(m[mi][r] - mx[r]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          l[mi][0] += __expf(s[mi][nt][0] - mx[0]) + __expf(s[mi][nt][1] - mx[0]);
          l[mi][1] += __expf(s[mi][nt][2] - mx[1]) + __expf(s[mi][nt][3] - mx[1]);
        }
      }
      m[mi][0] = mx[0];
      m[mi][1] = mx[1];
    }
    __syncthreads();   // every warp is done with this K tile (and Q)
  }
  if (NORM_FIRST) {   // l becomes 1 / the row sum
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[mi][r] += __shfl_xor_sync(kAll, l[mi][r], 1);
        l[mi][r] += __shfl_xor_sync(kAll, l[mi][r], 2);
        l[mi][r] = 1.f / l[mi][r];
      }
  }

  // ---- pass 2: P against the final max, P V
  float o[2][DT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][dt][e] = 0.f;
  float lsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  load_head_tile<bf16, TH, HD>(Ks(0), AP, qkv, b, N, ld, 0, kcol);
  load_head_tile<bf16, TH, HD>(Vs(0), AP, qkv, b, N, ld, 0, vcol);
  cp_async_commit();
  for (int j = 0; j < KT; ++j) {
    if (j + 1 < KT) {
      load_head_tile<bf16, TH, HD>(Ks(j + 1), AP, qkv, b, N, ld, (j + 1) * kKT, kcol);
      load_head_tile<bf16, TH, HD>(Vs(j + 1), AP, qkv, b, N, ld, (j + 1) * kKT, vcol);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[2][8][4];
    scores(s, qf, Ks(j), j * kKT);
    const bf16* V = Vs(j);
#pragma unroll
    for (int kc = 0; kc < kKT / 16; ++kc) {   // keys 16 kc .. 16 kc + 15
      unsigned pf[2][4];   // their P as an A operand
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * kc + half;
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = __expf(s[mi][nt][e] - m[mi][e / 2]);
          if (NORM_FIRST) {
#pragma unroll
            for (int e = 0; e < 4; ++e) p[e] *= l[mi][e / 2];
          } else {
            lsum[mi][0] += p[0] + p[1];
            lsum[mi][1] += p[2] + p[3];
          }
          pf[mi][half * 2] = pack_bf16(p[0], p[1]);
          pf[mi][half * 2 + 1] = pack_bf16(p[2], p[3]);
        }
#pragma unroll
      for (int dp = 0; dp < KC; ++dp) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, V + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * AP +
                                  dp * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(o[mi][2 * dp], pf[mi], vf[0], vf[1]);
          mma_bf16(o[mi][2 * dp + 1], pf[mi], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this K and V tile
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!NORM_FIRST) {
        lsum[mi][r] += __shfl_xor_sync(kAll, lsum[mi][r], 1);
        lsum[mi][r] += __shfl_xor_sync(kAll, lsum[mi][r], 2);
      }
      const int row = q0 + warp * 32 + mi * 16 + g + r * 8;
      if (row >= N) continue;
      CT* dst = ctx + (static_cast<size_t>(b) * N + row) * D + h * HD + tq * 2;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        float v0 = o[mi][dt][2 * r], v1 = o[mi][dt][2 * r + 1];
        if (!NORM_FIRST) {
          v0 = v0 / lsum[mi][r];
          v1 = v1 / lsum[mi][r];
        }
        store2(dst + dt * 8, v0, v1);
      }
    }
}

// f32 on the CUDA cores: 16 x 16 threads; thread (ty, tx) owns query rows
// 4 ty .. 4 ty + 3 and, of each 64-key tile, keys tx + 16 j, j < 4 (scores)
// or, of the head, columns tx + 16 j, j < HD / 16 (context). P passes
// through shared memory. Same two passes as the bf16 version; rounding to f32
// is no rounding, so the two NORM_FIRST orders differ only in where the
// divide is.
template <bool NORM_FIRST, int HD = kHD>
__device__ __forceinline__ void attn_tile_f32(const float* __restrict__ qkv,
                                              float* __restrict__ ctx, int b,
                                              int h, int q0, int N, int D,
                                              unsigned char* smem) {
  static_assert(kAttnHeadDim<HD>, "head_dim 64 or 80");
  constexpr int APF = kAPFOf<HD>;
  constexpr int CJ = HD / 16;
  constexpr int TH = kAttnThreadsF32;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kQT * APF;
  float* Vs = Ks + kKT * APF;
  float* Ps = Vs + kKT * APF;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int ld = 3 * D, kcol = D + h * HD, vcol = 2 * D + h * HD;
  const int KT = (N + kKT - 1) / kKT;
  constexpr unsigned kAll = 0xffffffffu;

  auto scores = [&](float (&s)[4][4], int key0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * APF + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * APF + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(q.x, k[j].x, s[i][j]);
          s[i][j] = fmaf(q.y, k[j].y, s[i][j]);
          s[i][j] = fmaf(q.z, k[j].z, s[i][j]);
          s[i][j] = fmaf(q.w, k[j].w, s[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = key0 + tx + 16 * j < N ? s[i][j] * kScoreScale<HD> : kNegInf;
  };
  // max or sum over the 16 threads of a row group (one half warp)
  auto row_max = [&](float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
    return v;
  };
  auto row_sum = [&](float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
    return v;
  };

  // ---- pass 1
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  load_head_tile<float, TH, HD>(Qs, APF, qkv, b, N, ld, q0, h * HD);
  for (int j = 0; j < KT; ++j) {
    load_head_tile<float, TH, HD>(Ks, APF, qkv, b, N, ld, j * kKT, kcol);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[4][4];
    scores(s, j * kKT);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = fmaxf(m[i], row_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                                 fmaxf(s[i][2], s[i][3]))));
      if (NORM_FIRST) {
        l[i] *= __expf(m[i] - mx);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) l[i] += __expf(s[i][jj] - mx);
      }
      m[i] = mx;
    }
    __syncthreads();   // the K tile is free
  }
  if (NORM_FIRST) {   // l becomes 1 / the row sum
#pragma unroll
    for (int i = 0; i < 4; ++i) l[i] = 1.f / row_sum(l[i]);
  }

  // ---- pass 2
  float o[4][CJ], lsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) o[i][j] = 0.f;
  }
  for (int j = 0; j < KT; ++j) {
    load_head_tile<float, TH, HD>(Ks, APF, qkv, b, N, ld, j * kKT, kcol);
    load_head_tile<float, TH, HD>(Vs, APF, qkv, b, N, ld, j * kKT, vcol);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[4][4];
    scores(s, j * kKT);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float p = __expf(s[i][jj] - m[i]);
        if (NORM_FIRST)
          p *= l[i];
        else
          lsum[i] += p;
        Ps[(ty * 4 + i) * APF + tx + 16 * jj] = p;
      }
    __syncthreads();   // P is complete
#pragma unroll 4
    for (int kk = 0; kk < kKT; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * APF + kk);
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const int c = tx + 16 * jj;
        const float v0 = Vs[kk * APF + c], v1 = Vs[(kk + 1) * APF + c];
        const float v2 = Vs[(kk + 2) * APF + c], v3 = Vs[(kk + 3) * APF + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][jj] = fmaf(p[i].x, v0, o[i][jj]);
          o[i][jj] = fmaf(p[i].y, v1, o[i][jj]);
          o[i][jj] = fmaf(p[i].z, v2, o[i][jj]);
          o[i][jj] = fmaf(p[i].w, v3, o[i][jj]);
        }
      }
    }
    __syncthreads();   // K, V and P are free
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float sum = NORM_FIRST ? 1.f : row_sum(lsum[i]);
    if (row >= N) continue;
    float* dst = ctx + (static_cast<size_t>(b) * N + row) * D + h * HD;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
      dst[tx + 16 * jj] = NORM_FIRST ? o[i][jj] : o[i][jj] / sum;
  }
}

}  // namespace tiles
}  // namespace paths_cuda

// Warp-level tensor-core building blocks for sm_90a: 16-byte cp.async tile
// loads into padded shared memory, ldmatrix fragment loads and the bf16
// mma.sync.m16n8k16 product with fp32 accumulation.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4,
// t = lane % 4:
//   A 16x16 row-major, 4 regs of 2 bf16: a0 (g, 2t..2t+1), a1 (g+8, 2t..),
//     a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8 "col", 2 regs: b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C 16x8 fp32, 4 floats: c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// so the C fragments of two neighbouring 8-column tiles, packed to bf16,
// are the A fragment of the next product (P -> PV) without touching
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mmdti {

using bf16 = __nv_bfloat16;

constexpr int kMmaTile = 64;     // rows of a tile: query rows or keys
constexpr int kMmaWarps = 4;     // 16 rows per warp
constexpr int kMmaThreads = kMmaWarps * 32;

// A tile of 64 rows of one head: D bf16 values each, padded to DP >= 16 (the
// mma depth; D = 8 is zero-padded) and to a row stride of DP + 8, so the 8
// rows an ldmatrix reads fall in 8 distinct 16-byte bank groups.
template <int D>
struct MmaGeom {
  static constexpr int DP = D < 16 ? 16 : D;
  static constexpr int S = DP + 8;
  static constexpr int kTile = kMmaTile * S;  // bf16 elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + 64) of a head whose row r starts at g + r * E; rows at
// or past n are zero-filled.  Called by all kMmaThreads threads.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* g, int row0, int n, int E) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int S = MmaGeom<D>::S;
#pragma unroll
  for (int idx = threadIdx.x; idx < kMmaTile * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    const bool ok = row < n;
    cp_async16(s + r * S + c * 8, g + (size_t)(ok ? row : 0) * E + c * 8, ok);
  }
}

// D = 8 only: zero the 8 padding columns of `tiles` consecutive tiles once;
// the async loads never write them.
template <int D>
__device__ __forceinline__ void zero_tile_padding(bf16* s, int tiles) {
  if constexpr (D < 16) {
    constexpr int S = MmaGeom<D>::S;
    for (int r = threadIdx.x; r < tiles * kMmaTile; r += kMmaThreads)
      *reinterpret_cast<uint4*>(s + r * S + D) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a b (16x8x16, bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments (16 rows x 16 depth) of rows [r0, r0+16), columns [c0, c0+16)
// of a row-major tile with stride S.
template <int S>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (r0 + (lane & 15)) * S + c0 + (lane >> 4) * 8);
}

// B fragments for two 8-column tiles of B = T^T, T a row-major tile whose
// rows are B's columns: rows [n0, n0+16) of T, depth [c0, c0+16).  b[0..1]
// are the first n-tile's, b[2..3] the second's.
template <int S>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int n0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * S + c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of B = T itself (depth along T's rows [k0, k0+16)), columns
// [n0, n0 + 16): two n-tiles, as load_b.
template <int S>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + n0 + (lane >> 4) * 8);
}

// A fragments of A = T^T (16 x 16): A[m][k] = T[k0 + k][m0 + m], T a
// row-major tile with stride S, read transposed by ldmatrix: dk += dS^T Q
// with dS staged row-major in shared memory.
template <int S>
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* tile, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(a, tile + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * S + m0 + ((lane >> 3) & 1) * 8);
}

// One 8-column tile of load_b_t (head dim 8).
template <int S>
__device__ __forceinline__ void load_b_t8(uint32_t (&b)[2], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x2_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + n0);
}

// acc[n] += A (16 x DP, fragments a[DP/16]) . T^T over rows [n0, n0 + 8*NT)
// of T (NT n-tiles of 8): scores S = Q K^T, dP = dO V^T and their transposes.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const uint32_t (&a)[MmaGeom<D>::DP / 16][4],
                                        const bf16* tile, int n0) {
  constexpr int S = MmaGeom<D>::S;
#pragma unroll
  for (int kk = 0; kk < MmaGeom<D>::DP / 16; ++kk)
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t b[4];
      load_b<S>(b, tile, n0 + p * 16, kk * 16);
      mma_bf16(acc[2 * p], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[kk], b[2], b[3]);
    }
}

// out[dt] += A . T over rows [k0, k0 + 16) of T, A a 16 x 16 fragment and
// T a tile of D columns (B = T itself).
template <int D>
__device__ __forceinline__ void mma_at(float (&out)[D / 8][4], const uint32_t (&a)[4],
                                       const bf16* tile, int k0) {
  constexpr int S = MmaGeom<D>::S;
  if constexpr (D == 8) {
    uint32_t b[2];
    load_b_t8<S>(b, tile, k0, 0);
    mma_bf16(out[0], a, b[0], b[1]);
  } else {
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      uint32_t b[4];
      load_b_t<S>(b, tile, k0, p * 16);
      mma_bf16(out[2 * p], a, b[0], b[1]);
      mma_bf16(out[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// out[dt] += X . T over rows [k0, k0 + 8*NT) of T, X the 16 x 8NT fp32
// accumulator x[NT][4] rounded to bf16 (its C fragments reused as A
// fragments), T a tile of D columns: O += P V, dq += dS K, dv += P^T dO,
// dk += dS^T Q.
template <int D, int NT>
__device__ __forceinline__ void mma_xt(float (&out)[D / 8][4], const float (&x)[NT][4],
                                       const bf16* tile, int k0) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    mma_at<D>(out, a, tile, k0 + kk * 16);
  }
}

// A fragments of a warp's 16 rows [r0, r0 + 16) of a tile, all DP columns.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[MmaGeom<D>::DP / 16][4],
                                            const bf16* tile, int r0) {
#pragma unroll
  for (int kk = 0; kk < MmaGeom<D>::DP / 16; ++kk) load_a<MmaGeom<D>::S>(a[kk], tile, r0, kk * 16);
}

// 2^(x log2 e): one MUFU.EX2; exp(-inf) = 0
__device__ __forceinline__ float fast_exp(float x) { return exp2f(x * 1.4426950408889634f); }

constexpr float kLog2e = 1.4426950408889634f;

// 2^x as the bare MUFU.EX2 (results below 2^-126 flush to 0); 2^-inf = 0.
// exp(x - m) = ex2_ftz(fmaf(x, kLog2e, -m * kLog2e)): one FFMA and one MUFU.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores a 16 x D accumulator (rows r and r + 8 of this lane, scaled by
// row_scale[0/1]) as bf16 into rows row_i[0/1] (skipped when >= n) of a head
// whose row i starts at g + i * E.
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, int E, const float (&acc)[D / 8][4],
                                           const int (&row_i)[2], int n,
                                           const float (&row_scale)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_i[r] >= n) continue;
    bf16* dst = g + (size_t)row_i[r] * E + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * r] * row_scale[r], acc[dt][2 * r + 1] * row_scale[r]);
  }
}

// Calls f(std::integral_constant<int, D>{}) for a head dim the kernels take.
template <class F>
cudaError_t dispatch_dim(int D, F&& f) {
  switch (D) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
  }
  return cudaErrorInvalidValue;
}

// Sets the dynamic shared memory limit of `kernel` once per instantiation.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = e == cudaSuccess;
  return e;
}

}  // namespace mmdti

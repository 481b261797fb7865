// Row-block attention forward shared by pair_bias_attention.cu and
// masked_attention.cu.
//
// One block per (query-row tile, head, batch).  The block stages K (then V)
// in tiles of kTileK keys in shared memory, each warp owns kRowsPerWarp query
// rows and keeps their whole fp32 score rows in shared memory, so the softmax
// sees the full key row at once (the same max / sum as the TPU kernels, with
// their guard for fully-masked rows) and nothing but the inputs and the
// outputs touches device memory.  Products run on the FMA units in fp32:
// head dims of 8..64 leave the tensor cores little to do at these shapes and
// the kernels are bound by the bytes they move (see each .cu file).
//
// q/out are token-major [B, Nq, H*D], k/v [B, Nk, H*D], heads contiguous on
// the last dim — the layout the encoders produce, so no head transpose ever
// reaches device memory.  The epilogue functor Epi adds the per-score bias
// (pair bias or key mask) and may store the logits.  Attention dropout
// (dropout.cuh) zeroes dropped probabilities after the row sum is taken and
// folds 1/(1 - rate) into the row constant, as the TPU kernels'
// _softmax_factored does; the stored logits stay pre-dropout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout.cuh"

namespace mmdti {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTileK = 64;                    // keys staged per tile
constexpr int kMaxSmemBytes = 227 * 1024;

// floats: K/V tile (padded rows) + scaled q rows + score rows + 1/rowsum
inline size_t attention_smem_bytes(int D, int Nk) {
  return sizeof(float) *
         ((size_t)kTileK * (D + 1) + (size_t)kRows * D + (size_t)kRows * Nk + kRows);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// At most 51 registers a thread, so that 5 blocks fit an SM: at N=280 shared
// memory also allows 5, and the dropout branch would otherwise push the D=8
// variant to 56 registers and 4 blocks.
template <typename T, int D, class Epi>
__global__ void __launch_bounds__(kWarps * 32, 5)
attention_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, Epi epi,
                      DropoutArgs drop, int Nq, int Nk, int H, float scale) {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64, "head dim");
  // pass 2 lane layout: for D < 32 the warp splits into G groups of D lanes,
  // group g sums keys g, g+G, ...; for D >= 32 each lane owns D/32 dims
  constexpr int G = D >= 32 ? 1 : 32 / D;
  constexpr int DPL = D >= 32 ? D / 32 : 1;

  extern __shared__ float smem[];
  float* kv_s = smem;                     // [kTileK][D+1]
  float* q_s = kv_s + kTileK * (D + 1);   // [kRows][D], pre-scaled
  float* s_s = q_s + kRows * D;           // [kRows][Nk] scores, then probs
  float* inv_s = s_s + (size_t)kRows * Nk;  // [kRows]

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int E = H * D;
  const size_t q_base = (size_t)b * Nq * E + (size_t)h * D;
  const size_t kv_base = (size_t)b * Nk * E + (size_t)h * D;

  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, i = row0 + r;
    q_s[idx] = i < Nq ? to_f(q[q_base + (size_t)i * E + d]) * scale : 0.f;
  }

  // ---- pass 1: scores = (q * scale) k^T + epilogue bias --------------------
  for (int t0 = 0; t0 < Nk; t0 += kTileK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTileK * D; idx += blockDim.x) {
      const int jj = idx / D, d = idx % D, j = t0 + jj;
      kv_s[jj * (D + 1) + d] = j < Nk ? to_f(k[kv_base + (size_t)j * E + d]) : 0.f;
    }
    __syncthreads();
    for (int jj = lane; jj < kTileK && t0 + jj < Nk; jj += 32) {
      const int j = t0 + jj;
      float acc[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = kv_s[jj * (D + 1) + d];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r] = fmaf(q_s[(warp * kRowsPerWarp + r) * D + d], kd, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int rr = warp * kRowsPerWarp + r, i = row0 + rr;
        s_s[(size_t)rr * Nk + j] = i < Nq ? epi.score(b, h, i, j, acc[r]) : 0.f;
      }
    }
  }
  __syncwarp();

  // ---- softmax over each full row (warp-local), then dropout ---------------
  const bool dropping = drop.seed != nullptr;
  const uint32_t key = dropping ? dropout_key(drop, b, h) : 0u;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = warp * kRowsPerWarp + r;
    float* row = s_s + (size_t)rr * Nk;
    float m = -INFINITY;
    for (int j = lane; j < Nk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    if (!isfinite(m)) m = 0.f;  // fully-masked row guard (as the TPU kernel)
    float sum = 0.f;
    if (dropping) {  // block-uniform: the loop without dropout hashes nothing
      const uint32_t ij0 = (uint32_t)(row0 + rr) * (uint32_t)Nk;
      for (int j = lane; j < Nk; j += 32) {
        const float p = expf(row[j] - m);
        sum += p;
        row[j] = dropout_keep(key, ij0 + j, drop.threshold) ? p : 0.f;
      }
    } else {
      for (int j = lane; j < Nk; j += 32) {
        const float p = expf(row[j] - m);
        row[j] = p;
        sum += p;
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) inv_s[rr] = (1.f / fmaxf(sum, 1e-30f)) * (dropping ? drop.scale : 1.f);
  }

  // ---- pass 2: out = (p v) / rowsum -----------------------------------------
  const int g = D >= 32 ? 0 : lane / D;
  const int d0 = D >= 32 ? lane : lane % D;
  float acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;

  for (int t0 = 0; t0 < Nk; t0 += kTileK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTileK * D; idx += blockDim.x) {
      const int jj = idx / D, d = idx % D, j = t0 + jj;
      kv_s[jj * (D + 1) + d] = j < Nk ? to_f(v[kv_base + (size_t)j * E + d]) : 0.f;
    }
    __syncthreads();
    const int tn = min(kTileK, Nk - t0);
    for (int jj = g; jj < tn; jj += G) {
      float vd[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vd[c] = kv_s[jj * (D + 1) + d0 + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = s_s[(size_t)(warp * kRowsPerWarp + r) * Nk + t0 + jj];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(p, vd[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int off = D; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);

  if (g == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rr = warp * kRowsPerWarp + r, i = row0 + rr;
      if (i >= Nq) continue;
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        out[q_base + (size_t)i * E + d0 + 32 * c] = from_f<T>(acc[r][c] * inv_s[rr]);
    }
  }
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
template <typename T, int D, class Epi>
cudaError_t launch_attention_rows(const void* q, const void* k, const void* v, void* out,
                                  Epi epi, DropoutArgs drop, int B, int Nq, int Nk, int H,
                                  float scale, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(D, Nk);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = attention_rows_kernel<T, D, Epi>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((Nq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), epi, drop, Nq, Nk, H, scale);
  return cudaGetLastError();
}

// Calls f(T{}, std::integral_constant<int, D>{}) for the runtime (bf16, D);
// returns cudaErrorInvalidValue for a head dim the kernel does not take.
template <class F>
cudaError_t dispatch_type_dim(int is_bf16, int D, F&& f) {
  if (is_bf16) {
    switch (D) {
      case 8: return f(__nv_bfloat16{}, std::integral_constant<int, 8>{});
      case 16: return f(__nv_bfloat16{}, std::integral_constant<int, 16>{});
      case 32: return f(__nv_bfloat16{}, std::integral_constant<int, 32>{});
      case 64: return f(__nv_bfloat16{}, std::integral_constant<int, 64>{});
    }
  } else {
    switch (D) {
      case 8: return f(float{}, std::integral_constant<int, 8>{});
      case 16: return f(float{}, std::integral_constant<int, 16>{});
      case 32: return f(float{}, std::integral_constant<int, 32>{});
      case 64: return f(float{}, std::integral_constant<int, 64>{});
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace mmdti

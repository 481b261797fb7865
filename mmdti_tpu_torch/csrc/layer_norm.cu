// Fused LayerNorm forward and backward (Hopper, sm_90a).
//
// Forward: replaces the TPU kernel mmdti_tpu/ops/pallas_ln.py::_fwd_kernel
// (reached through _layer_norm_fwd's pl.pallas_call).  Per row of x [T, E]:
//
//     mu = mean(x), var = max(mean(x^2) - mu^2, 0), rstd = rsqrt(var + eps)
//     y  = (x - mu) * (rstd * scale) + bias
//
// in fp32 from the fp32 cast of x, written in y's dtype.  Neither mu nor rstd
// reaches device memory: the backward recomputes them.
//
// Backward: replaces _bwd_kernel (reached through _layer_norm_bwd).  The row
// kernel recomputes mu/rstd with the same code and summation order as the
// forward (bit-identical statistics), writes
//
//     dx = (w*gy - xhat * mean(w*gy*xhat) - mean(w*gy)) * rstd
//
// in x's dtype, and sums gy*xhat and gy over the rows it owns into one fp32
// partial row per block, in a fixed order.  A second launch adds the
// partial rows in block order.  No atomics anywhere: repeated calls give
// bit-equal dscale/dbias.
//
// Layout: one warp per row, kWarps rows per block.  Lane l keeps the
// 8-element chunks l, l+32, ... of its row in registers (one 16-byte load
// per chunk for bf16, two for fp32; x, y, gy and dx must be 16-byte
// aligned, scale and bias only 4-byte).  E must be a multiple of 8 and at most
// 1024; T is any positive count (rows past T are skipped).
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once (forward: x in, y out; backward: x and gy in, dx out) for about ten
// FLOP.  At [2048, 512] bf16 the forward moves 4.2 MB (1.25 us at 3.35 TB/s)
// and the backward 6.3 MB (1.9 us); the partial rows add 4 KB per block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mmdti_ln {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxE = 1024;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// scale and bias: scalar loads, since a parameter may be a view at any
// float offset into the optimizer's flat buffer
__device__ __forceinline__ void load8_param(const float* p, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __ldg(p + i);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// butterfly sum: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ int chunk_col(int lane, int c) { return (lane + 32 * c) * 8; }

// Loads one row's chunks (zeros past E) in fp32.
template <typename T, int kC>
__device__ __forceinline__ void load_row(const T* row, int lane, int E, float (&v)[kC][8]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = chunk_col(lane, c);
    if (col < E) {
      load8(row + col, v[c]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[c][i] = 0.0f;
    }
  }
}

// mean and rstd of one row, the fast variance of the TPU kernel; the
// forward and the backward call this one function, so both get the same bits
template <int kC>
__device__ __forceinline__ void row_stats(const float (&v)[kC][8], int E, float eps, float& mu,
                                          float& rstd) {
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[c][i];
      s2 += v[c][i] * v[c][i];
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float n = (float)E;
  mu = s / n;
  const float var = fmaxf(s2 / n - mu * mu, 0.0f);
  rstd = rsqrtf(var + eps);
}

template <typename Tx, typename Ty, int kC>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd_kernel(const Tx* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, Ty* __restrict__ y, int T, int E,
                          float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;
  float v[kC][8];
  load_row<Tx, kC>(x + (size_t)row * E, lane, E, v);
  float mu, rstd;
  row_stats<kC>(v, E, eps, mu, rstd);
  Ty* yr = y + (size_t)row * E;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = chunk_col(lane, c);
    if (col >= E) continue;
    float g[8], b[8], o[8];
    load8_param(scale + col, g);
    load8_param(bias + col, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = (v[c][i] - mu) * (rstd * g[i]) + b[i];
    store8(yr + col, o);
  }
}

// Grid-stride over rows: warp w of block b owns rows (b*kWarps + w) +
// k*gridDim.x*kWarps.  partials [gridDim.x, 2E]: dscale then dbias.
template <typename Tx, typename Ty, int kC>
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd_kernel(const Tx* __restrict__ x, const float* __restrict__ scale,
                          const Ty* __restrict__ gy, Tx* __restrict__ dx,
                          float* __restrict__ partials, int T, int E, float eps) {
  extern __shared__ float s_acc[];  // [2E]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc_g[kC][8], acc_b[kC][8];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_g[c][i] = acc_b[c][i] = 0.0f;
  }
  for (int row = blockIdx.x * kWarps + warp; row < T; row += gridDim.x * kWarps) {
    float v[kC][8], g[kC][8];
    load_row<Tx, kC>(x + (size_t)row * E, lane, E, v);
    load_row<Ty, kC>(gy + (size_t)row * E, lane, E, g);
    float mu, rstd;
    row_stats<kC>(v, E, eps, mu, rstd);
    float s1 = 0.0f, s0 = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = chunk_col(lane, c);
      float w[8];
      if (col < E) {
        load8_param(scale + col, w);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xh = (v[c][i] - mu) * rstd;
        const float wd = g[c][i] * w[i];
        s1 += wd * xh;
        s0 += wd;
        acc_g[c][i] += g[c][i] * xh;
        acc_b[c][i] += g[c][i];
        v[c][i] = xh;          // keep xhat
        g[c][i] = wd;          // keep w*gy
      }
    }
    const float c1 = warp_sum(s1) / (float)E;
    const float c2 = warp_sum(s0) / (float)E;
    Tx* dxr = dx + (size_t)row * E;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = chunk_col(lane, c);
      if (col >= E) continue;
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = (g[c][i] - v[c][i] * c1 - c2) * rstd;
      store8(dxr + col, o);
    }
  }
  // the block's warps add into shared memory in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = chunk_col(lane, c);
        if (col >= E) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (w == 0) {
            s_acc[col + i] = acc_g[c][i];
            s_acc[E + col + i] = acc_b[c][i];
          } else {
            s_acc[col + i] += acc_g[c][i];
            s_acc[E + col + i] += acc_b[c][i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = partials + (size_t)blockIdx.x * 2 * E;
  for (int j = threadIdx.x; j < 2 * E; j += kThreads) out[j] = s_acc[j];
}

// out[j] = sum over b of partials[b, j], in a fixed order: 8 thread groups
// take the rows b = g, g+8, ... in turn, then group sums add in group order.
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                 int nblocks, int width) {
  __shared__ float s[kWarps][33];
  const int c = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + c;
  float acc = 0.0f;
  if (col < width) {
    for (int b = g; b < nblocks; b += kWarps) acc += partials[(size_t)b * width + col];
  }
  s[g][c] = acc;
  __syncthreads();
  if (g == 0 && col < width) {
    float t = s[0][c];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) t += s[k][c];
    out[col] = t;
  }
}

template <typename F>
cudaError_t dispatch(int x_bf16, int y_bf16, int E, F&& run) {
  if (E <= 0 || E % 8 != 0 || E > kMaxE) return cudaErrorInvalidValue;
  auto by_width = [&](auto tx, auto ty) -> cudaError_t {
    if (E <= 256) return run(tx, ty, std::integral_constant<int, 1>{});
    if (E <= 512) return run(tx, ty, std::integral_constant<int, 2>{});
    return run(tx, ty, std::integral_constant<int, 4>{});
  };
  const __nv_bfloat16 h{};
  const float f = 0.0f;
  if (x_bf16 && y_bf16) return by_width(h, h);
  if (x_bf16) return by_width(h, f);
  if (y_bf16) return by_width(f, h);
  return by_width(f, f);
}

}  // namespace mmdti_ln

// x/y [T, E] (bf16 if x_bf16 / y_bf16, else fp32), scale/bias [E] fp32.
// Returns a cudaError_t.
extern "C" int mmdti_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                    int T, int E, float eps, int x_bf16, int y_bf16,
                                    void* stream) {
  using namespace mmdti_ln;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  auto run = [&](auto tx, auto ty, auto kc) -> cudaError_t {
    using Tx = decltype(tx);
    using Ty = decltype(ty);
    constexpr int kC = decltype(kc)::value;
    const int grid = (T + kWarps - 1) / kWarps;
    layer_norm_fwd_kernel<Tx, Ty, kC><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Tx*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<Ty*>(y), T, E, eps);
    return cudaGetLastError();
  };
  return (int)dispatch(x_bf16, y_bf16, E, run);
}

// x/dx [T, E] in x's dtype, gy [T, E] in y's dtype, scale [E] fp32;
// partials [nblocks, 2E] fp32 scratch, filled by nblocks blocks.
extern "C" int mmdti_layer_norm_bwd(const void* x, const void* scale, const void* gy, void* dx,
                                    void* partials, int nblocks, int T, int E, float eps,
                                    int x_bf16, int y_bf16, void* stream) {
  using namespace mmdti_ln;
  if (T <= 0 || nblocks <= 0) return (int)cudaErrorInvalidValue;
  auto run = [&](auto tx, auto ty, auto kc) -> cudaError_t {
    using Tx = decltype(tx);
    using Ty = decltype(ty);
    constexpr int kC = decltype(kc)::value;
    layer_norm_bwd_kernel<Tx, Ty, kC>
        <<<nblocks, kThreads, 2 * E * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
            static_cast<const Tx*>(x), static_cast<const float*>(scale),
            static_cast<const Ty*>(gy), static_cast<Tx*>(dx), static_cast<float*>(partials), T,
            E, eps);
    return cudaGetLastError();
  };
  return (int)dispatch(x_bf16, y_bf16, E, run);
}

// out [2E] fp32 = the column sums of partials [nblocks, 2E], in block order.
extern "C" int mmdti_layer_norm_bwd_reduce(const void* partials, void* out, int nblocks, int E,
                                           void* stream) {
  using namespace mmdti_ln;
  if (nblocks <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  const int width = 2 * E;
  layer_norm_bwd_reduce_kernel<<<(width + 31) / 32, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), nblocks, width);
  return (int)cudaGetLastError();
}

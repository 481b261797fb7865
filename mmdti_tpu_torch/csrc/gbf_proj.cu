// Fused Gaussian expansion + gbf_proj MLP forward (Hopper, sm_90a).
//
// Replaces the TPU kernel mmdti_tpu/ops/pallas_gbf.py::_fwd_kernel (reached
// through _run_fwd's pl.pallas_call).  Per atom pair (b, i, j), with
// u = mul*dist + bias already selected by the caller:
//
//     G_k  = exp(-((u - mean_k) / std_k)^2 / 2) / (sqrt(2*pi) * std_k)   k < K
//     h    = act(G W1 + b1)                                              [Kh]
//     o    = h W2 + b2                                                   [H]
//
// and o is written straight into the attention layout [B, H, N, N] in the
// pair dtype, with -inf at padded keys (the encoder's padding merge) — the TPU
// kernel's i-major [B, N, H, N] output was a layout choice for its compiler.
// G and h live in shared memory only; nothing of size [B, N, N, K] reaches
// device memory.  The GEMM operands are rounded to the compute dtype (bf16 on
// the serving path) and accumulated in fp32, as on the TPU.
//
// What bounds it on the H100: 2*(K*Kh + Kh*H) = 49 kFLOP per pair at the
// flagship K=Kh=128, H=64 against 4 bytes read and 2*H bytes written, so it
// is compute-bound.  This first version runs both GEMMs on the FMA units
// from shared memory (64 pairs per tile, a 4x8 / 4x4 register tile per
// thread) with W1/W2 resident in shared memory for a grid-stride loop over
// tiles; moving the GEMMs to wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPairs = 64;     // pairs per tile
constexpr int kThreads = 256;  // 16 pair groups x 16 column groups
constexpr int kMaxSmemBytes = 227 * 1024;

template <bool kBf16>
__device__ __forceinline__ float round_c(float x) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16(x));
  return x;
}

template <int ACT>  // 0: tanh-approximated gelu, 1: erf gelu
__device__ __forceinline__ float activation(float x) {
  if constexpr (ACT == 0)
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

template <typename P> __device__ __forceinline__ P store_p(float x);
template <> __device__ __forceinline__ float store_p<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store_p<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t gbf_smem_bytes(int K, int Kh, int H) {
  const int a = K > Kh ? K : Kh;
  return sizeof(float) *
         ((size_t)K * Kh + (size_t)Kh * H + 2 * K + Kh + H + (size_t)a * kPairs + kPairs);
}

// NPT1 = Kh / 16 hidden columns and NPT2 = H / 16 heads per thread.
template <typename P, bool kBf16, int ACT, int NPT1, int NPT2>
__global__ void __launch_bounds__(kThreads)
gbf_proj_kernel(const float* __restrict__ u, const float* __restrict__ means,
                const float* __restrict__ stds, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const uint8_t* __restrict__ pad,
                P* __restrict__ out, int B, int N, int K, float sqrt_2pi) {
  constexpr int Kh = NPT1 * 16, H = NPT2 * 16;
  extern __shared__ float sm[];
  float* w1_s = sm;                  // [K][Kh]
  float* w2_s = w1_s + K * Kh;       // [Kh][H]
  float* mu_s = w2_s + Kh * H;       // [K]
  float* sd_s = mu_s + K;            // [K]
  float* b1_s = sd_s + K;            // [Kh]
  float* b2_s = b1_s + Kh;           // [H]
  float* u_s = b2_s + H;             // [kPairs]
  float* a_s = u_s + kPairs;         // [max(K,Kh)][kPairs]: G^T, then h^T

  const int tid = threadIdx.x, pg = tid & 15, cg = tid >> 4;
  // weights arrive in torch.nn.Linear layout ([out, in]) and are staged
  // transposed, rounded to the compute dtype
  for (int idx = tid; idx < K * Kh; idx += kThreads)
    w1_s[idx] = round_c<kBf16>(w1[(idx % Kh) * K + idx / Kh]);
  for (int idx = tid; idx < Kh * H; idx += kThreads)
    w2_s[idx] = round_c<kBf16>(w2[(idx % H) * Kh + idx / H]);
  for (int idx = tid; idx < K; idx += kThreads) {
    mu_s[idx] = means[idx];
    sd_s[idx] = stds[idx];
  }
  for (int idx = tid; idx < Kh; idx += kThreads) b1_s[idx] = b1[idx];
  for (int idx = tid; idx < H; idx += kThreads) b2_s[idx] = b2[idx];

  const long long NN = (long long)N * N, total = (long long)B * NN;
  const long long ntiles = (total + kPairs - 1) / kPairs;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * kPairs;
    __syncthreads();  // previous tile done with u_s / a_s (and weights staged)
    if (tid < kPairs) u_s[tid] = p0 + tid < total ? u[p0 + tid] : 0.f;
    __syncthreads();
    for (int idx = tid; idx < K * kPairs; idx += kThreads) {
      const int kk = idx / kPairs, p = idx % kPairs;
      const float s = sd_s[kk], z = (u_s[p] - mu_s[kk]) / s;
      a_s[idx] = round_c<kBf16>(expf(-0.5f * z * z) / (sqrt_2pi * s));
    }
    __syncthreads();

    float acc[4][NPT1];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NPT1; ++c) acc[r][c] = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      float a[4], w[NPT1];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = a_s[kk * kPairs + pg + 16 * r];
#pragma unroll
      for (int c = 0; c < NPT1; ++c) w[c] = w1_s[kk * Kh + cg * NPT1 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NPT1; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
    __syncthreads();  // all of G read: a_s now takes h^T
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NPT1; ++c) {
        const int n = cg * NPT1 + c;
        a_s[n * kPairs + pg + 16 * r] = round_c<kBf16>(activation<ACT>(acc[r][c] + b1_s[n]));
      }
    __syncthreads();

    float o[4][NPT2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NPT2; ++c) o[r][c] = 0.f;
    for (int n = 0; n < Kh; ++n) {
      float a[4], w[NPT2];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = a_s[n * kPairs + pg + 16 * r];
#pragma unroll
      for (int c = 0; c < NPT2; ++c) w[c] = w2_s[n * H + cg * NPT2 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NPT2; ++c) o[r][c] = fmaf(a[r], w[c], o[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long gp = p0 + pg + 16 * r;
      if (gp >= total) continue;
      const int b = (int)(gp / NN);
      const long long rem = gp - (long long)b * NN;
      const int i = (int)(rem / N), j = (int)(rem - (long long)i * N);
      const bool masked = pad != nullptr && pad[(size_t)b * N + j];
#pragma unroll
      for (int c = 0; c < NPT2; ++c) {
        const int hh = cg * NPT2 + c;
        const float val = masked ? -INFINITY : o[r][c] + b2_s[hh];
        out[(((size_t)b * H + hh) * N + i) * N + j] = store_p<P>(val);
      }
    }
  }
}

template <typename P, bool kBf16, int ACT, int NPT1, int NPT2>
cudaError_t launch(const float* u, const float* means, const float* stds, const float* w1,
                   const float* b1, const float* w2, const float* b2, const uint8_t* pad,
                   void* out, int B, int N, int K, float sqrt_2pi, cudaStream_t stream) {
  auto kernel = gbf_proj_kernel<P, kBf16, ACT, NPT1, NPT2>;
  const size_t smem = gbf_smem_bytes(K, NPT1 * 16, NPT2 * 16);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  static int grid_cap = 0;
  if (grid_cap == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
        cudaSuccess)
      return e;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long ntiles = ((long long)B * N * N + kPairs - 1) / kPairs;
  const int grid = (int)(ntiles < grid_cap ? ntiles : grid_cap);
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(u, means, stds, w1, b1, w2, b2, pad,
                                           static_cast<P*>(out), B, N, K, sqrt_2pi);
  return cudaGetLastError();
}

template <typename P, bool kBf16, int ACT>
cudaError_t dispatch_widths(int Kh, int H, const float* u, const float* means,
                            const float* stds, const float* w1, const float* b1,
                            const float* w2, const float* b2, const uint8_t* pad, void* out,
                            int B, int N, int K, float sqrt_2pi, cudaStream_t stream) {
  if (Kh == 128 && H == 64)
    return launch<P, kBf16, ACT, 8, 4>(u, means, stds, w1, b1, w2, b2, pad, out, B, N, K,
                                       sqrt_2pi, stream);
  if (Kh == 128 && H == 96)
    return launch<P, kBf16, ACT, 8, 6>(u, means, stds, w1, b1, w2, b2, pad, out, B, N, K,
                                       sqrt_2pi, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// u [B, N, N] fp32; means/stds [K] (stds already |.| + 1e-5); w1 [Kh, K],
// b1 [Kh], w2 [H, Kh], b2 [H] fp32 (nn.Linear layout); pad [B, N] uint8 or null; out
// [B, H, N, N] (bf16 if pair_bf16 else fp32).  compute_bf16 rounds the GEMM
// operands to bf16; act 0 = gelu_tanh, 1 = gelu (erf).  Returns a cudaError_t.
extern "C" int mmdti_gbf_proj_fwd(const void* u, const void* means, const void* stds,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, const void* pad, void* out, int B, int N,
                                  int K, int Kh, int H, int compute_bf16, int pair_bf16,
                                  int act, float sqrt_2pi, void* stream) {
  auto f = static_cast<const float*>(u);
  auto mu = static_cast<const float*>(means);
  auto sd = static_cast<const float*>(stds);
  auto a1 = static_cast<const float*>(w1);
  auto c1 = static_cast<const float*>(b1);
  auto a2 = static_cast<const float*>(w2);
  auto c2 = static_cast<const float*>(b2);
  auto pm = static_cast<const uint8_t*>(pad);
  auto st = static_cast<cudaStream_t>(stream);
#define MMDTI_GBF_CASE(P, BF, A)                                                          \
  return (int)dispatch_widths<P, BF, A>(Kh, H, f, mu, sd, a1, c1, a2, c2, pm, out, B, N, K, \
                                        sqrt_2pi, st)
  if (act != 0 && act != 1) return (int)cudaErrorInvalidValue;
  if (pair_bf16) {
    if (compute_bf16) {
      if (act == 0) MMDTI_GBF_CASE(__nv_bfloat16, true, 0);
      MMDTI_GBF_CASE(__nv_bfloat16, true, 1);
    }
    if (act == 0) MMDTI_GBF_CASE(__nv_bfloat16, false, 0);
    MMDTI_GBF_CASE(__nv_bfloat16, false, 1);
  }
  if (compute_bf16) {
    if (act == 0) MMDTI_GBF_CASE(float, true, 0);
    MMDTI_GBF_CASE(float, true, 1);
  }
  if (act == 0) MMDTI_GBF_CASE(float, false, 0);
  MMDTI_GBF_CASE(float, false, 1);
#undef MMDTI_GBF_CASE
}

// Fused Gaussian expansion + gbf_proj MLP, forward and backward (Hopper, sm_90a).
//
// Forward: replaces the TPU kernel mmdti_tpu/ops/pallas_gbf.py::_fwd_kernel
// (reached through _run_fwd's pl.pallas_call).  Per atom pair (b, i, j), with
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
// Backward: replaces _bwd_kernel (reached through _bwd_rule).  It recomputes
// G and h per 64-pair tile, zeroes the cotangent at padded keys (the merge's
// where has zero gradient there), and returns du per pair and dmeans, dstd,
// dW1, db1, dW2, db2 reduced over all B*N^2 pairs, rounding the GEMM operands
// where the TPU kernel does.  The TPU kernel summed the parameter grads over
// its sequential grid; here a persistent block per SM keeps its partial sums
// in registers, writes them to a workspace, and a second launch adds the
// partials in block order: deterministic, with no atomics.
//
// What bounds it on the H100: 2*(K*Kh + Kh*H) = 49 kFLOP per pair forward and
// about 131 kFLOP backward (the first GEMM recomputed, then dh, dW2, dg and
// dW1) at the flagship K=Kh=128, H=64, against 4 bytes read and 2*H bytes
// written (read) per pair, so both are compute-bound.  This first version runs
// every GEMM on the FMA units from shared memory with W1/W2 resident for a
// grid-stride loop over tiles; moving the GEMMs to wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdK = 128;        // K == Kh == 128 (the instantiated width)
constexpr int kTP = kPairs + 1;   // padded pair stride of the [X][64] tiles

template <int ACT>  // derivative of activation<ACT>
__device__ __forceinline__ float activation_grad(float x) {
  if constexpr (ACT == 0) {
    const float a = 0.7978845608028654f, c = 0.044715f;
    const float t = tanhf(a * (x + c * x * x * x));
    return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * a * (1.f + 3.f * c * x * x);
  }
  const float phi = 0.5f * (1.f + erff(x * 0.7071067811865476f));
  return phi + x * 0.3989422804014327f * expf(-0.5f * x * x);
}

template <typename P> __device__ __forceinline__ float load_p(P x);
template <> __device__ __forceinline__ float load_p<float>(float x) { return x; }
template <> __device__ __forceinline__ float load_p<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t gbf_bwd_smem_bytes(int H) {
  const size_t K = kBwdK, Kh = kBwdK;
  return sizeof(float) * (K * Kh + (size_t)H * Kh + 2 * K + Kh + kPairs + K * kTP + Kh * kTP +
                          (size_t)H * kTP + 16 * kPairs);
}

// per-block partial sums: dW1 [Kh][K], dW2 [H][Kh], db1 [Kh], db2 [H],
// dmeans [K], dstd [K] (nn.Linear layouts)
size_t gbf_bwd_partial_floats(int H) {
  const size_t K = kBwdK, Kh = kBwdK;
  return Kh * K + (size_t)H * Kh + Kh + H + 2 * K;
}

template <typename P, bool kBf16, int ACT, int NPT2>
__global__ void __launch_bounds__(kThreads, 1)
gbf_proj_bwd_kernel(const float* __restrict__ u, const float* __restrict__ means,
                    const float* __restrict__ stds, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const uint8_t* __restrict__ pad, const P* __restrict__ g,
                    float* __restrict__ du, float* __restrict__ partials, int B, int N,
                    float sqrt_2pi) {
  constexpr int K = kBwdK, Kh = kBwdK, H = NPT2 * 16, NC = 8;
  extern __shared__ float sm[];
  float* w1_s = sm;                  // [K][Kh]  rounded W1^T
  float* w2_s = w1_s + K * Kh;       // [H][Kh]  rounded W2
  float* mu_s = w2_s + H * Kh;       // [K]
  float* sd_s = mu_s + K;            // [K]
  float* b1_s = sd_s + K;            // [Kh]
  float* u_s = b1_s + Kh;            // [kPairs]
  float* a_s = u_s + kPairs;         // [K][kTP]  rounded G
  float* h_s = a_s + K * kTP;        // [Kh][kTP] rounded act(h_pre), then rounded dpre
  float* go_s = h_s + Kh * kTP;      // [H][kTP]  cotangent, 0 at padded keys
  float* red_s = go_s + H * kTP;     // [16][kPairs] du partials

  // (pg, cg): 4 pairs pg + 16r x 8 columns cg*8 + c, for the per-pair GEMMs;
  // the same split of tid indexes the weight-grad tiles (rows cg*8 + c,
  // columns pg + 16e)
  const int tid = threadIdx.x, pg = tid & 15, cg = tid >> 4;
  for (int idx = tid; idx < K * Kh; idx += kThreads)
    w1_s[idx] = round_c<kBf16>(w1[(idx % Kh) * K + idx / Kh]);
  for (int idx = tid; idx < H * Kh; idx += kThreads) w2_s[idx] = round_c<kBf16>(w2[idx]);
  for (int idx = tid; idx < K; idx += kThreads) {
    mu_s[idx] = means[idx];
    sd_s[idx] = stds[idx];
  }
  for (int idx = tid; idx < Kh; idx += kThreads) b1_s[idx] = b1[idx];

  float dw1[NC][NC], dw2[NPT2][NC], db1[NC], dmu[NC], dsd[NC], db2 = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    db1[c] = dmu[c] = dsd[c] = 0.f;
#pragma unroll
    for (int e = 0; e < NC; ++e) dw1[c][e] = 0.f;
#pragma unroll
    for (int a = 0; a < NPT2; ++a) dw2[a][c] = 0.f;
  }

  const long long NN = (long long)N * N, total = (long long)B * NN;
  const long long ntiles = (total + kPairs - 1) / kPairs;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * kPairs;
    __syncthreads();  // previous tile done with every tile buffer
    if (tid < kPairs) u_s[tid] = p0 + tid < total ? u[p0 + tid] : 0.f;
    for (int idx = tid; idx < H * kPairs; idx += kThreads) {
      const int hh = idx / kPairs, p = idx % kPairs;
      const long long gp = p0 + p;
      float val = 0.f;
      if (gp < total) {
        const int b = (int)(gp / NN);
        const long long rem = gp - (long long)b * NN;
        const int i = (int)(rem / N), j = (int)(rem - (long long)i * N);
        if (pad == nullptr || !pad[(size_t)b * N + j])
          val = load_p<P>(g[(((size_t)b * H + hh) * N + i) * N + j]);
      }
      go_s[hh * kTP + p] = val;
    }
    __syncthreads();
    for (int idx = tid; idx < K * kPairs; idx += kThreads) {
      const int kk = idx / kPairs, p = idx % kPairs;
      const float s = sd_s[kk], z = (u_s[p] - mu_s[kk]) / s;
      a_s[kk * kTP + p] = round_c<kBf16>(expf(-0.5f * z * z) / (sqrt_2pi * s));
    }
    __syncthreads();

    // h_pre = G W1 + b1; keep act'(h_pre), store rounded act(h_pre)
    float hp[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) hp[r][c] = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      float a[4], w[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = a_s[kk * kTP + pg + 16 * r];
#pragma unroll
      for (int c = 0; c < NC; ++c) w[c] = w1_s[kk * Kh + cg * NC + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) hp[r][c] = fmaf(a[r], w[c], hp[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = cg * NC + c;
        const float x = hp[r][c] + b1_s[n];
        h_s[n * kTP + pg + 16 * r] = round_c<kBf16>(activation<ACT>(x));
        hp[r][c] = activation_grad<ACT>(x);
      }
    __syncthreads();

    // dW2 += go^T act(h_pre); db2 += sum go
    for (int p = 0; p < kPairs; ++p) {
      float gv[NPT2], hv[NC];
#pragma unroll
      for (int a = 0; a < NPT2; ++a) gv[a] = round_c<kBf16>(go_s[(pg + 16 * a) * kTP + p]);
#pragma unroll
      for (int c = 0; c < NC; ++c) hv[c] = h_s[(cg * NC + c) * kTP + p];
#pragma unroll
      for (int a = 0; a < NPT2; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) dw2[a][c] = fmaf(gv[a], hv[c], dw2[a][c]);
    }
    if (tid < H)
      for (int p = 0; p < kPairs; ++p) db2 += go_s[tid * kTP + p];

    // dpre = (go W2) * act'(h_pre); db1 += sum dpre
    float dh[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) dh[r][c] = 0.f;
    for (int hh = 0; hh < H; ++hh) {
      float gv[4], w[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) gv[r] = round_c<kBf16>(go_s[hh * kTP + pg + 16 * r]);
#pragma unroll
      for (int c = 0; c < NC; ++c) w[c] = w2_s[hh * Kh + cg * NC + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) dh[r][c] = fmaf(gv[r], w[c], dh[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dh[r][c] *= hp[r][c];
        db1[c] += dh[r][c];
      }
    __syncthreads();  // every read of act(h_pre) done: h_s takes dpre
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) h_s[(cg * NC + c) * kTP + pg + 16 * r] = round_c<kBf16>(dh[r][c]);
    __syncthreads();

    // dG = dpre W1^T, then the Gaussian's grads (with the unrounded G)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) dh[r][c] = 0.f;
    for (int n = 0; n < Kh; ++n) {
      float a[4], w[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = h_s[n * kTP + pg + 16 * r];
#pragma unroll
      for (int c = 0; c < NC; ++c) w[c] = w1_s[(cg * NC + c) * Kh + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) dh[r][c] = fmaf(a[r], w[c], dh[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = pg + 16 * r;
      float dup = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int kk = cg * NC + c;
        const float s = sd_s[kk], z = (u_s[p] - mu_s[kk]) / s;
        const float dgz = dh[r][c] * (expf(-0.5f * z * z) / (sqrt_2pi * s));
        const float zs = z / s;
        dmu[c] = fmaf(dgz, zs, dmu[c]);
        dsd[c] += dgz * (z * z - 1.f) / s;
        dup -= dgz * zs;
      }
      red_s[cg * kPairs + p] = dup;
    }

    // dW1 += dpre^T G
    for (int p = 0; p < kPairs; ++p) {
      float dv[NC], gv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) dv[c] = h_s[(cg * NC + c) * kTP + p];
#pragma unroll
      for (int e = 0; e < NC; ++e) gv[e] = a_s[(pg + 16 * e) * kTP + p];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < NC; ++e) dw1[c][e] = fmaf(dv[c], gv[e], dw1[c][e]);
    }
    __syncthreads();
    if (tid < kPairs && p0 + tid < total) {
      float s = 0.f;
      for (int q = 0; q < 16; ++q) s += red_s[q * kPairs + tid];
      du[p0 + tid] = s;
    }
  }

  // this block's partial sums -> partials[blockIdx.x]
  __syncthreads();
  float* red3 = a_s;  // [3][16][Kh] per-pg column partials of db1, dmeans, dstd
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    red3[(0 * 16 + pg) * Kh + cg * NC + c] = db1[c];
    red3[(1 * 16 + pg) * Kh + cg * NC + c] = dmu[c];
    red3[(2 * 16 + pg) * Kh + cg * NC + c] = dsd[c];
  }
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * ((size_t)Kh * K + (size_t)H * Kh + Kh + H + 2 * K);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < NC; ++e) out[(cg * NC + c) * K + pg + 16 * e] = dw1[c][e];
  float* o2 = out + Kh * K;
#pragma unroll
  for (int a = 0; a < NPT2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) o2[(pg + 16 * a) * Kh + cg * NC + c] = dw2[a][c];
  float* o_db1 = o2 + H * Kh;
  float* o_db2 = o_db1 + Kh;
  float* o_dmu = o_db2 + H;
  float* o_dsd = o_dmu + K;
  if (tid < Kh) {
    float s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int q = 0; q < 16; ++q) {
      s1 += red3[(0 * 16 + q) * Kh + tid];
      s2 += red3[(1 * 16 + q) * Kh + tid];
      s3 += red3[(2 * 16 + q) * Kh + tid];
    }
    o_db1[tid] = s1;
    o_dmu[tid] = s2;
    o_dsd[tid] = s3;
  }
  if (tid < H) o_db2[tid] = db2;
}

// out[e] = sum over blocks b (in order) of partials[b][e]
__global__ void gbf_bwd_reduce_kernel(const float* __restrict__ partials,
                                      float* __restrict__ out, int nblocks, int stride) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < stride; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * stride + e];
    out[e] = s;
  }
}

template <typename P, bool kBf16, int ACT, int NPT2>
cudaError_t launch_bwd(const float* u, const float* means, const float* stds, const float* w1,
                       const float* b1, const float* w2, const uint8_t* pad, const void* g,
                       float* du, float* grads, float* partials, int max_blocks, int B, int N,
                       float sqrt_2pi, cudaStream_t stream) {
  constexpr int H = NPT2 * 16;
  auto kernel = gbf_proj_bwd_kernel<P, kBf16, ACT, NPT2>;
  const size_t smem = gbf_bwd_smem_bytes(H);
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
  long long grid = ntiles < grid_cap ? ntiles : grid_cap;
  if (grid > max_blocks) grid = max_blocks;
  if (grid == 0) return cudaSuccess;
  kernel<<<(int)grid, kThreads, smem, stream>>>(u, means, stds, w1, b1, w2, pad,
                                                static_cast<const P*>(g), du, partials, B, N,
                                                sqrt_2pi);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int stride = (int)gbf_bwd_partial_floats(H);
  gbf_bwd_reduce_kernel<<<(stride + 255) / 256, 256, 0, stream>>>(partials, grads, (int)grid,
                                                                  stride);
  return cudaGetLastError();
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

// u [B, N, N] fp32; means/stds [K] (stds already |.| + 1e-5); w1 [Kh, K],
// b1 [Kh], w2 [H, Kh] fp32; pad [B, N] uint8 or null; g [B, H, N, N] (bf16
// if pair_bf16 else fp32), the cotangent of the forward's output.  Writes
// du [B, N, N] and grads = dW1 [Kh,K] | dW2 [H,Kh] | db1 [Kh] | db2 [H] |
// dmeans [K] | dstd [K], all fp32; partials is a workspace of max_blocks
// times that many floats.  Takes K = Kh = 128.  Returns a cudaError_t.
extern "C" int mmdti_gbf_proj_bwd(const void* u, const void* means, const void* stds,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* pad, const void* g, void* du, void* grads,
                                  void* partials, int max_blocks, int B, int N, int K, int Kh,
                                  int H, int compute_bf16, int pair_bf16, int act,
                                  float sqrt_2pi, void* stream) {
  if (K != kBwdK || Kh != kBwdK || (H != 64 && H != 96) || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  auto f = static_cast<const float*>(u);
  auto mu = static_cast<const float*>(means);
  auto sd = static_cast<const float*>(stds);
  auto a1 = static_cast<const float*>(w1);
  auto c1 = static_cast<const float*>(b1);
  auto a2 = static_cast<const float*>(w2);
  auto pm = static_cast<const uint8_t*>(pad);
  auto d = static_cast<float*>(du);
  auto gr = static_cast<float*>(grads);
  auto ws = static_cast<float*>(partials);
  auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto p, auto bf, auto a, auto npt) -> cudaError_t {
    return launch_bwd<decltype(p), decltype(bf)::value, decltype(a)::value,
                      decltype(npt)::value>(f, mu, sd, a1, c1, a2, pm, g, d, gr, ws, max_blocks,
                                            B, N, sqrt_2pi, st);
  };
  auto by_width = [&](auto p, auto bf, auto a) -> cudaError_t {
    return H == 64 ? run(p, bf, a, std::integral_constant<int, 4>{})
                   : run(p, bf, a, std::integral_constant<int, 6>{});
  };
  auto by_act = [&](auto p, auto bf) -> cudaError_t {
    return act == 0 ? by_width(p, bf, std::integral_constant<int, 0>{})
                    : by_width(p, bf, std::integral_constant<int, 1>{});
  };
  auto by_compute = [&](auto p) -> cudaError_t {
    return compute_bf16 ? by_act(p, std::true_type{}) : by_act(p, std::false_type{});
  };
  return (int)(pair_bf16 ? by_compute(__nv_bfloat16{}) : by_compute(float{}));
}

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
// written (read) per pair, so both are compute-bound; beside that bound, K
// exp and Kh tanh a pair on the special-function units (16 a clock an SM).
//
// Two routes (ops/hopper_gbf.py::gbf_route):
// The head counts H instantiated are 64 and 96 (a whole flagship or
// scale-arch layer) and 16, 32 and 48 (a tensor-parallel rank's share of
// them: 64/4, 64/2, 96/2).
// * "fma" (fp32 compute, and any width but K = Kh = 128): the
//   first kernels, every GEMM on the FMA units from shared memory, with
//   W1/W2 resident for a grid-stride loop over 64-pair tiles.
// * "mma" (bf16 compute at K = Kh = 128, the model's path): every
//   GEMM on mma.sync m16n8k16 (bf16 operands, fp32 sums), W1/W2 staged once
//   per persistent block as bf16 in their nn.Linear layout, which is
//   already the "col" B operand of x W^T.
//   - Forward: 4 warps a block, persistent, with no block barrier after the
//     weights are staged.  Each warp takes 16 consecutive flat pairs
//     p = (b N + i) N + j at a time:
//     G's A fragments are built in registers (one FMA, two multiplies and
//     one ex2.approx a value), the hidden layer is made 16 columns at a time
//     and its C fragments, packed to bf16, are the A fragments of the second
//     GEMM at once.  The output tile goes through a per-warp [H][16] buffer
//     and leaves as 16-byte runs of each head's pairs (element stores where
//     a run crosses a batch row or N*N is not a multiple of the run
//     alignment, e.g. N = 65).  65 KB of shared memory at H=64 with a
//     bf16 pair: 3 blocks an SM.
//   - Backward: 8 warps a block, one block an SM, 64-pair block tiles.
//     Warp w takes the tile's pairs [16 (w % 4), +16) and half w / 4 of the
//     K and Kh columns for G (its ex2 once: fp32 kept lane-private in shared
//     memory, bf16 in the tile), h_pre, dh = go W2, dpre and dG = dpre W1;
//     then, with the tile's pairs as depth, it owns a 32 x 64 tile of dW1
//     and up to 3 16 x 32 units of dW2 (none for the last warps at H = 16
//     or 48), accumulated in registers over the
//     whole loop (96 or 112 fp32 a thread; 254-255 registers, no spills;
//     166 KB of shared memory at H=64 with a bf16 pair).  The next tile's
//     cotangent is fetched with cp.async while this one is computed, as it
//     lies (head-major), with its padded keys as bits; ldmatrix .trans gives
//     go as an A operand.  db2 sums the unrounded cotangent per (head,
//     16-pair run); db1, dmeans and dstd are reduce-scattered over a warp's
//     lanes and kept per warp in shared memory.
//   Both keep the per-block partials and the ordered reduce: no atomics,
//   repeated calls bit-equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

// The library is built in parts (ops/_build.py PARTS), one nvcc each, all
// at once, then linked: MMDTI_PART selects the one entry point a part
// defines (0 the FMA forward, 1 the FMA backward, 2 the tensor-core
// forward, 3 its backward), so each part instantiates only its own
// kernels; without MMDTI_PART one compile defines all four.

namespace {

constexpr int kPairs = 64;     // pairs per tile
constexpr int kThreads = 256;  // 16 pair groups x 16 column groups
constexpr int kMaxSmemBytes = 227 * 1024;

// the head counts H the kernels are instantiated at
bool gbf_width(int H) { return H == 16 || H == 32 || H == 48 || H == 64 || H == 96; }

// Grid of at most (blocks an SM) x SMs persistent blocks, found once per
// instantiation from the first call's shared memory; the kernel's shared
// memory limit is raised to the card's the first time, since the FMA
// forward's smem grows with the K of each call.
template <class Kern>
cudaError_t persistent_grid(Kern kernel, int threads, size_t smem, int& cap) {
  if (cap > 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kMaxSmemBytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  cap = sms * per_sm;
  return cudaSuccess;
}

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
  cudaError_t e = persistent_grid(kernel, kThreads, smem, grid_cap);
  if (e != cudaSuccess) return e;
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
  if (Kh != 128) return cudaErrorInvalidValue;
  auto run = [&](auto npt2) {
    return launch<P, kBf16, ACT, 8, decltype(npt2)::value>(u, means, stds, w1, b1, w2, b2, pad,
                                                           out, B, N, K, sqrt_2pi, stream);
  };
  switch (H) {  // a tensor-parallel rank's heads (16, 32, 48) and the whole layer's (64, 96)
    case 16: return run(std::integral_constant<int, 1>{});
    case 32: return run(std::integral_constant<int, 2>{});
    case 48: return run(std::integral_constant<int, 3>{});
    case 64: return run(std::integral_constant<int, 4>{});
    case 96: return run(std::integral_constant<int, 6>{});
    default: return cudaErrorInvalidValue;
  }
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
  cudaError_t e = persistent_grid(kernel, kThreads, smem, grid_cap);
  if (e != cudaSuccess) return e;
  const long long ntiles = ((long long)B * N * N + kPairs - 1) / kPairs;
  long long grid = ntiles < grid_cap ? ntiles : grid_cap;
  if (grid > max_blocks) grid = max_blocks;
  if (grid == 0) return cudaSuccess;
  kernel<<<(int)grid, kThreads, smem, stream>>>(u, means, stds, w1, b1, w2, pad,
                                                static_cast<const P*>(g), du, partials, B, N,
                                                sqrt_2pi);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int stride = (int)gbf_bwd_partial_floats(H);
  gbf_bwd_reduce_kernel<<<(stride + 255) / 256, 256, 0, stream>>>(partials, grads, (int)grid,
                                                                  stride);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route ("mma"): every GEMM on the tensor cores, K = Kh = 128, H 16-96
// ---------------------------------------------------------------------------

using mmdti::bf16;
using mmdti::mma_bf16;
using mmdti::pack_bf16;

constexpr int kMK = 128;          // K = Kh on this route
constexpr int kMS = kMK + 8;      // row stride (bf16) of the weight and [pair][128] tiles
constexpr int kChunk = 32;        // backward: columns of a half taken at once (4 n-tiles)

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// act(x), and act'(x) into d when kGrad; tanh.approx for the tanh gelu
template <int ACT, bool kGrad>
__device__ __forceinline__ float act_mma(float x, float& d) {
  if constexpr (ACT == 0) {
    const float a = 0.7978845608028654f, c = 0.044715f;
    const float t = tanh_approx(a * (x + c * x * x * x));
    if constexpr (kGrad)
      d = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * a * (1.f + 3.f * c * x * x);
    return 0.5f * x * (1.f + t);
  } else {
    const float phi = 0.5f * (1.f + erff(x * 0.7071067811865476f));
    if constexpr (kGrad) d = phi + x * 0.3989422804014327f * expf(-0.5f * x * x);
    return x * phi;
  }
}

// gk = [1/std | -mean/std | 1/(sqrt(2 pi) std)], K floats each:
// G(u, k) = coef_k 2^(-log2(e)/2 z^2), z = u/std_k - mean_k/std_k
__device__ __forceinline__ float gauss(float u, float a, float c, float coef) {
  const float z = fmaf(u, a, c);
  return coef * mmdti::ex2_ftz(z * z * (-0.5f * mmdti::kLog2e));
}

__device__ __forceinline__ void stage_gauss(float* gk, const float* means, const float* stds,
                                            float sqrt_2pi, int tid, int nthreads) {
  for (int k = tid; k < kMK; k += nthreads) {
    const float s = stds[k], inv = 1.f / s;
    gk[k] = inv;
    gk[kMK + k] = -means[k] * inv;
    gk[2 * kMK + k] = 1.f / (sqrt_2pi * s);
  }
}

// The A fragment of G over one 16-deep step at k0 for this lane's pairs g
// (u0) and g + 8 (u1), columns k0 + 2t, 2t+1, 2t+8, 2t+9, rounded to bf16
// (RNE); gv[4h + 2r + e] gets the fp32 value of pair r, column
// k0 + 2t + 8h + e: element 2r + e of the C fragment of n-tile k0/8 + h.
__device__ __forceinline__ void gauss_frag(uint32_t (&a)[4], float (&gv)[8], float u0, float u1,
                                           const float* gk, int k0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + 2 * t + 8 * h;
    const float2 A = *reinterpret_cast<const float2*>(gk + k);
    const float2 C = *reinterpret_cast<const float2*>(gk + kMK + k);
    const float2 F = *reinterpret_cast<const float2*>(gk + 2 * kMK + k);
    gv[4 * h + 0] = gauss(u0, A.x, C.x, F.x);
    gv[4 * h + 1] = gauss(u0, A.y, C.y, F.y);
    gv[4 * h + 2] = gauss(u1, A.x, C.x, F.x);
    gv[4 * h + 3] = gauss(u1, A.y, C.y, F.y);
  }
  a[0] = pack_bf16(gv[0], gv[1]);
  a[1] = pack_bf16(gv[2], gv[3]);
  a[2] = pack_bf16(gv[4], gv[5]);
  a[3] = pack_bf16(gv[6], gv[7]);
}

__device__ __forceinline__ void stage_bf16(bf16* dst, const float* src, int rows, int tid,
                                           int nthreads) {
  for (int idx = tid; idx < rows * kMK; idx += nthreads)
    dst[(idx / kMK) * kMS + idx % kMK] = __float2bfloat16(src[idx]);
}

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdPairs = 16;            // flat pairs a warp takes at a time (one m-tile)
constexpr int kFwdChunk = 16;            // hidden columns made and consumed at once

template <typename P>
__host__ __device__ constexpr int stage_stride() {  // the pairs + padding, rows 16-byte aligned
  return std::is_same<P, float>::value ? kFwdPairs + 4 : kFwdPairs + 8;
}

template <typename P>
size_t gbf_mma_fwd_smem(int H) {
  return sizeof(bf16) * (size_t)(kMK + H) * kMS +
         sizeof(P) * (size_t)kFwdWarps * H * stage_stride<P>() + sizeof(float) * (4 * kMK + H);
}

// Writes a warp's staged [H][kFwdPairs] tile to out [B, H, N, N] at flat
// pairs p0 .. p0 + kFwdPairs - 1: 16-byte runs of each head's pairs when they lie in
// one batch row and N*N keeps them aligned, else one element a lane.
template <typename P, int H>
__device__ __forceinline__ void store_tile(P* out, const P* stg, unsigned p0, unsigned total,
                                           unsigned NN) {
  constexpr int SS = stage_stride<P>(), V = 16 / sizeof(P), C = kFwdPairs / V;
  const int lane = threadIdx.x & 31;
  const unsigned b0 = p0 / NN, rem0 = p0 - b0 * NN;
  if (p0 + kFwdPairs <= total && rem0 + kFwdPairs <= NN && NN % V == 0) {
    P* base = out + (size_t)b0 * H * NN + rem0;
#pragma unroll
    for (int idx = lane; idx < H * C; idx += 32) {
      const int head = idx / C, q = idx % C;
      *reinterpret_cast<uint4*>(base + (size_t)head * NN + q * V) =
          *reinterpret_cast<const uint4*>(stg + head * SS + q * V);
    }
  } else {
    const int r = lane % kFwdPairs;
    const unsigned p = p0 + r;
    if (p < total) {
      const unsigned b = p / NN;
      P* dst = out + (size_t)b * H * NN + (p - b * NN);
      for (int head = lane / kFwdPairs; head < H; head += 32 / kFwdPairs)
        dst[(size_t)head * NN] = stg[head * SS + r];
    }
  }
}

// Forward: persistent blocks of 4 warps; each warp takes kFwdPairs
// consecutive flat pairs at a time and needs no block barrier after staging
// the weights.
template <typename P, int ACT, int H>
__global__ void __launch_bounds__(kFwdThreads, 3)
gbf_mma_fwd_kernel(const float* __restrict__ u, const float* __restrict__ means,
                   const float* __restrict__ stds, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const uint8_t* __restrict__ pad,
                   P* __restrict__ out, int B, int N, float sqrt_2pi) {
  constexpr int SS = stage_stride<P>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w1_s = reinterpret_cast<bf16*>(smem_raw);   // [Kh][kMS]  W1 as nn.Linear: "col" B of G W1^T
  bf16* w2_s = w1_s + kMK * kMS;                     // [H][kMS]   W2: "col" B of h W2^T
  P* stage = reinterpret_cast<P*>(w2_s + H * kMS);   // per warp [H][SS] output tile
  float* gk = reinterpret_cast<float*>(stage + kFwdWarps * H * SS);  // [3][K]
  float* b1_s = gk + 3 * kMK;                        // [Kh]
  float* b2_s = b1_s + kMK;                          // [H]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  stage_bf16(w1_s, w1, kMK, tid, kFwdThreads);
  stage_bf16(w2_s, w2, H, tid, kFwdThreads);
  stage_gauss(gk, means, stds, sqrt_2pi, tid, kFwdThreads);
  for (int k = tid; k < kMK; k += kFwdThreads) b1_s[k] = b1[k];
  for (int k = tid; k < H; k += kFwdThreads) b2_s[k] = b2[k];
  __syncthreads();

  P* stg = stage + warp * H * SS;
  const unsigned NN = (unsigned)N * N, total = (unsigned)B * NN;
  const unsigned ntiles = (total + kFwdPairs - 1) / kFwdPairs;
  for (unsigned tile = blockIdx.x * kFwdWarps + warp; tile < ntiles;
       tile += gridDim.x * kFwdWarps) {
    const unsigned p0 = tile * kFwdPairs, pa = p0 + g, pb = pa + 8;
    uint32_t ga[kMK / 16][4];
    {
      const float u0 = pa < total ? u[pa] : 0.f, u1 = pb < total ? u[pb] : 0.f;
#pragma unroll
      for (int ks = 0; ks < kMK / 16; ++ks) {
        float gv[8];
        gauss_frag(ga[ks], gv, u0, u1, gk, ks * 16);
      }
    }
    float o[H / 8][4];
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

#pragma unroll 2
    for (int c = 0; c < kMK / kFwdChunk; ++c) {
      // h_pre for hidden columns [16 c, 16 c + 16) = G W1^T
      float hp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) hp[nt][0] = hp[nt][1] = hp[nt][2] = hp[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kMK / 16; ++ks) {
        uint32_t b[4];
        mmdti::load_b<kMS>(b, w1_s, c * kFwdChunk, ks * 16);
        mma_bf16(hp[0], ga[ks], b[0], b[1]);
        mma_bf16(hp[1], ga[ks], b[2], b[3]);
      }
      // h = act(h_pre + b1), packed to bf16: its C fragments are the A
      // fragments of h W2^T over these 16 hidden columns
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 bb = *reinterpret_cast<const float2*>(b1_s + c * kFwdChunk + nt * 8 + 2 * t);
        float d;
        hp[nt][0] = act_mma<ACT, false>(hp[nt][0] + bb.x, d);
        hp[nt][1] = act_mma<ACT, false>(hp[nt][1] + bb.y, d);
        hp[nt][2] = act_mma<ACT, false>(hp[nt][2] + bb.x, d);
        hp[nt][3] = act_mma<ACT, false>(hp[nt][3] + bb.y, d);
      }
      const uint32_t a[4] = {pack_bf16(hp[0][0], hp[0][1]), pack_bf16(hp[0][2], hp[0][3]),
                             pack_bf16(hp[1][0], hp[1][1]), pack_bf16(hp[1][2], hp[1][3])};
#pragma unroll
      for (int q = 0; q < H / 16; ++q) {
        uint32_t b[4];
        mmdti::load_b<kMS>(b, w2_s, q * 16, c * kFwdChunk);
        mma_bf16(o[2 * q], a, b[0], b[1]);
        mma_bf16(o[2 * q + 1], a, b[2], b[3]);
      }
    }

    // + b2, -inf at padded keys, through the warp's staging tile
    bool masked[2] = {false, false};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const unsigned p = r ? pb : pa;
      if (pad != nullptr && p < total) {
        const unsigned b = p / NN;
        masked[r] = pad[(size_t)b * N + (p - b * NN) % N] != 0;
      }
    }
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      const int head = nt * 8 + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(b2_s + head);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = g + 8 * r;
        stg[head * SS + col] = store_p<P>(masked[r] ? -INFINITY : o[nt][2 * r] + bb.x);
        stg[(head + 1) * SS + col] = store_p<P>(masked[r] ? -INFINITY : o[nt][2 * r + 1] + bb.y);
      }
    }
    __syncwarp();
    store_tile<P, H>(out, stg, p0, total, NN);
    __syncwarp();
  }
}

template <typename P, int ACT, int H>
cudaError_t launch_mma_fwd(const float* u, const float* means, const float* stds,
                           const float* w1, const float* b1, const float* w2, const float* b2,
                           const uint8_t* pad, void* out, int B, int N, float sqrt_2pi,
                           cudaStream_t stream) {
  auto kernel = gbf_mma_fwd_kernel<P, ACT, H>;
  const size_t smem = gbf_mma_fwd_smem<P>(H);
  static int grid_cap = 0;
  cudaError_t e = persistent_grid(kernel, kFwdThreads, smem, grid_cap);
  if (e != cudaSuccess) return e;
  const unsigned long long total = (unsigned long long)B * N * N;
  if (total >= (1ull << 31)) return cudaErrorInvalidValue;
  const long long blocks =
      ((long long)(total + kFwdPairs - 1) / kFwdPairs + kFwdWarps - 1) / kFwdWarps;
  const int grid = (int)(blocks < grid_cap ? blocks : grid_cap);
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kFwdThreads, smem, stream>>>(u, means, stds, w1, b1, w2, b2, pad,
                                              static_cast<P*>(out), B, N, sqrt_2pi);
  return cudaGetLastError();
}

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBT = 64;          // pairs per block tile
constexpr int kGS = kBT + 8;     // pair stride (bf16) of the head-major cotangent tile

template <typename P, int H>
size_t gbf_mma_bwd_smem() {
  return sizeof(bf16) * ((size_t)(kMK + H) * kMS + 3 * (size_t)kBT * kMS + (size_t)H * kGS) +
         sizeof(P) * (size_t)H * kBT +
         sizeof(float) * ((size_t)kBwdWarps * 32 * 32 + 4 * kMK + 2 * kBT +
                          (size_t)kBwdWarps * 3 * kMK) +
         sizeof(uint32_t) * 2;
}

template <typename P>
__device__ __forceinline__ void unpack16(const uint4& x, float* v);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& x, float* v) {
  v[0] = __uint_as_float(x.x);
  v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z);
  v[3] = __uint_as_float(x.w);
}
template <>
__device__ __forceinline__ void unpack16<bf16>(const uint4& x, float* v) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float2 f = __bfloat1622float2(h2[w]);
    v[2 * w] = f.x;
    v[2 * w + 1] = f.y;
  }
}

// A block tile's cotangent in two halves, both by thread task (h, q): the
// 16 pairs q*16 .. q*16 + 15 of head h, as they lie in g [B, H, N, N].
// issue_cotangent starts copying them into go_raw[h][q*16 ..] (cp.async
// 16-byte pieces where the run lies in one batch row and is aligned, else
// plain loads, zeros past the end); take_cotangent, called by the same
// thread a tile later, waits for its copies, zeroes padded keys (tile_pad_bits
// of the tile), adds the fp32 values in order to db2[it] (heads tid/4 and
// 64 + tid/4) and writes them as bf16 to go_s[h][q*16 ..].  No other thread
// touches a task's run of go_raw, so no barrier is needed between the two.
template <typename P, int H>
__device__ __forceinline__ void issue_cotangent(P* go_raw, const P* __restrict__ g, unsigned p0,
                                                unsigned total, unsigned NN) {
  constexpr int V = 16 / sizeof(P);
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int task = threadIdx.x + it * kBwdThreads;
    if (task >= H * 4) break;
    const int head = task >> 2, q = task & 3;
    const unsigned s = p0 + q * 16;
    P* dst = go_raw + head * kBT + q * 16;
    const unsigned b = s / NN, rem = s - b * NN;
    if (s + 16 <= total && rem + 16 <= NN && NN % V == 0 &&
        (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const P* src = g + ((size_t)b * H + head) * NN + rem;
#pragma unroll
      for (int c = 0; c < 16 / V; ++c) mmdti::cp_async16(dst + c * V, src + c * V, true);
    } else {
      unsigned bb = b, rr = rem;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        dst[e] = s + e < total ? g[((size_t)bb * H + head) * NN + rr] : store_p<P>(0.f);
        if (++rr == NN) rr = 0, ++bb;
      }
    }
  }
  mmdti::cp_async_commit();
}

// The padded keys among a block tile's 64 pairs as bits (pair p of the tile
// is bit p % 32 of tm_s[p / 32]), by warps 0 and 1.
__device__ __forceinline__ void tile_pad_bits(uint32_t* tm_s, const uint8_t* __restrict__ pad,
                                              unsigned p0, unsigned total, unsigned NN, int N) {
  const int tid = threadIdx.x;
  if (tid >= kBT) return;  // whole warps
  const unsigned p = p0 + tid;
  bool padded = false;
  if (pad != nullptr && p < total) {
    const unsigned b = p / NN;
    padded = pad[(size_t)b * N + (p - b * NN) % N] != 0;
  }
  const uint32_t bits = __ballot_sync(0xffffffffu, padded);
  if ((tid & 31) == 0) tm_s[tid >> 5] = bits;
}

template <typename P, int H>
__device__ __forceinline__ void take_cotangent(bf16* go_s, const P* go_raw, const uint32_t* tm_s,
                                               float (&db2)[2]) {
  constexpr int V = 16 / sizeof(P);
  mmdti::cp_async_wait<0>();
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int task = threadIdx.x + it * kBwdThreads;
    if (task >= H * 4) break;
    const int head = task >> 2, q = task & 3;
    float v[16];
#pragma unroll
    for (int c = 0; c < 16 / V; ++c)
      unpack16<P>(*reinterpret_cast<const uint4*>(go_raw + head * kBT + q * 16 + c * V),
                  v + c * V);
    const uint32_t bits = tm_s[q >> 1] >> (16 * (q & 1));
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if ((bits >> e) & 1u) v[e] = 0.f;
      sum += v[e];
    }
    db2[it] += sum;
    uint4 lo, hi;
    lo.x = pack_bf16(v[0], v[1]);
    lo.y = pack_bf16(v[2], v[3]);
    lo.z = pack_bf16(v[4], v[5]);
    lo.w = pack_bf16(v[6], v[7]);
    hi.x = pack_bf16(v[8], v[9]);
    hi.y = pack_bf16(v[10], v[11]);
    hi.z = pack_bf16(v[12], v[13]);
    hi.w = pack_bf16(v[14], v[15]);
    *reinterpret_cast<uint4*>(go_s + head * kGS + q * 16) = lo;
    *reinterpret_cast<uint4*>(go_s + head * kGS + q * 16 + 8) = hi;
  }
}

// v[i] summed over the warp's 8 lane groups g (lanes t, t+4, ..., t+28) in a
// fixed order, as a reduce-scatter: lane (g, t) gets the total of v[g], for
// 7 shuffles where 8 separate sums take 24.
__device__ __forceinline__ float reduce_scatter_g(const float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w[4], x[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (b4 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    x[i] = (b3 ? w[i + 2] : w[i]) + __shfl_xor_sync(0xffffffffu, b3 ? w[i] : w[i + 2], 8);
  return (b2 ? x[1] : x[0]) + __shfl_xor_sync(0xffffffffu, b2 ? x[0] : x[1], 4);
}

// Backward: persistent blocks of 8 warps over 64-pair block tiles.  Warp w
// takes the tile's pairs [16 (w % 4), +16) and the half w / 4 of the K (and
// Kh) columns for the per-pair work; for the weight gradients, with the
// tile's pairs as depth, it owns a 32 x 64 tile of dW1 and 16 x 32 units of
// dW2, held in registers over the whole loop.
template <typename P, int ACT, int H>
__global__ void __launch_bounds__(kBwdThreads, 1)
gbf_mma_bwd_kernel(const float* __restrict__ u, const float* __restrict__ means,
                   const float* __restrict__ stds, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const uint8_t* __restrict__ pad, const P* __restrict__ g,
                   float* __restrict__ du, float* __restrict__ partials, int B, int N,
                   float sqrt_2pi) {
  // dW2 in units of 16 heads x 32 hidden columns, U2 a warp in warp order; at
  // H = 16 or 48 the last warps hold none (kUnits < U2 * kBwdWarps)
  static_assert(H % 16 == 0, "the heads come in tiles of 16");
  constexpr int kUnits = (H / 16) * 4;
  constexpr int U2 = (kUnits + kBwdWarps - 1) / kBwdWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w1_s = reinterpret_cast<bf16*>(smem_raw);  // [Kh][kMS] W1
  bf16* w2_s = w1_s + kMK * kMS;                    // [H][kMS]  W2
  bf16* gb_s = w2_s + H * kMS;                      // [kBT][kMS] bf16 G
  bf16* h_s = gb_s + kBT * kMS;                     // [kBT][kMS] bf16 act(h_pre)
  bf16* dp_s = h_s + kBT * kMS;                     // [kBT][kMS] bf16 dpre
  bf16* go_s = dp_s + kBT * kMS;                    // [H][kGS]   bf16 cotangent
  P* go_raw = reinterpret_cast<P*>(go_s + H * kGS);  // [H][kBT]   the next tile's, as stored
  float* gf_s = reinterpret_cast<float*>(go_raw + H * kBT);  // per warp [32][32 lanes] fp32 G
  float* gk = gf_s + kBwdWarps * 32 * 32;           // [3][K]
  float* b1_s = gk + 3 * kMK;                       // [Kh]
  float* du_s = b1_s + kMK;                         // [2][kBT] du over each K half
  float* wp_s = du_s + 2 * kBT;                     // per warp [3][128]: db1, dmeans, dstd
  uint32_t* tm_s = reinterpret_cast<uint32_t*>(wp_s + kBwdWarps * 3 * kMK);  // [2] pad bits

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), hf = warp >> 2;
  stage_bf16(w1_s, w1, kMK, tid, kBwdThreads);
  stage_bf16(w2_s, w2, H, tid, kBwdThreads);
  stage_gauss(gk, means, stds, sqrt_2pi, tid, kBwdThreads);
  for (int k = tid; k < kMK; k += kBwdThreads) b1_s[k] = b1[k];
  for (int k = tid; k < kBwdWarps * 3 * kMK; k += kBwdThreads) wp_s[k] = 0.f;
  float* gf = gf_s + warp * 32 * 32;
  float* wp_db1 = wp_s + warp * 3 * kMK;
  float* wp_dmu = wp_db1 + kMK;
  float* wp_dsd = wp_dmu + kMK;

  float dw1[16][4], dw2[U2][4][4], db2[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) dw1[nt][0] = dw1[nt][1] = dw1[nt][2] = dw1[nt][3] = 0.f;
#pragma unroll
  for (int un = 0; un < U2; ++un)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      dw2[un][nt][0] = dw2[un][nt][1] = dw2[un][nt][2] = dw2[un][nt][3] = 0.f;

  const unsigned NN = (unsigned)N * N, total = (unsigned)B * NN;
  const unsigned ntiles = (total + kBT - 1) / kBT;
  issue_cotangent<P, H>(go_raw, g, blockIdx.x * kBT, total, NN);
  tile_pad_bits(tm_s, pad, blockIdx.x * kBT, total, NN, N);
  for (unsigned tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const unsigned p0 = tile * kBT;
    __syncthreads();  // the previous tile is done with every tile buffer (and staging is done)
    take_cotangent<P, H>(go_s, go_raw, tm_s, db2);

    // G of this warp's 16 pairs and K half: fp32 into gf (lane-private),
    // bf16 into gb_s
    const unsigned pa = p0 + r0 + g8, pb = pa + 8;
    const float u0 = pa < total ? u[pa] : 0.f, u1 = pb < total ? u[pb] : 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k0 = 64 * hf + 16 * ks;
      uint32_t a[4];
      float gv[8];
      gauss_frag(a, gv, u0, u1, gk, k0);
#pragma unroll
      for (int i = 0; i < 8; ++i) gf[(ks * 8 + i) * 32 + lane] = gv[i];
      bf16* row = gb_s + (r0 + g8) * kMS + k0 + 2 * t;
      *reinterpret_cast<uint32_t*>(row) = a[0];
      *reinterpret_cast<uint32_t*>(row + 8 * kMS) = a[1];
      *reinterpret_cast<uint32_t*>(row + 8) = a[2];
      *reinterpret_cast<uint32_t*>(row + 8 * kMS + 8) = a[3];
    }
    __syncthreads();  // G and the cotangent of the whole tile are in shared memory
    if (tile + gridDim.x < ntiles) {  // the next tile's cotangent, taken a tile from now
      issue_cotangent<P, H>(go_raw, g, (tile + gridDim.x) * kBT, total, NN);
      tile_pad_bits(tm_s, pad, (tile + gridDim.x) * kBT, total, NN, N);
    }

    // per 32 hidden columns of this warp's half: dh = go W2, h_pre = G W1^T,
    // h -> h_s, dpre = dh act'(h_pre) -> dp_s, db1 += column sums of dpre
#pragma unroll
    for (int c = 0; c < 64 / kChunk; ++c) {
      const int n0 = 64 * hf + c * kChunk;
      float dh[4][4], hp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dh[nt][i] = hp[nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        uint32_t a[4];
        mmdti::load_a_t<kGS>(a, go_s, r0, ks * 16);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t b[4];
          mmdti::load_b_t<kMS>(b, w2_s, ks * 16, n0 + pp * 16);
          mma_bf16(dh[2 * pp], a, b[0], b[1]);
          mma_bf16(dh[2 * pp + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < kMK / 16; ++ks) {
        uint32_t a[4];
        mmdti::load_a<kMS>(a, gb_s, r0, ks * 16);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t b[4];
          mmdti::load_b<kMS>(b, w1_s, n0 + pp * 16, ks * 16);
          mma_bf16(hp[2 * pp], a, b[0], b[1]);
          mma_bf16(hp[2 * pp + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + nt * 8 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(b1_s + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float d;
          hp[nt][i] = act_mma<ACT, true>(hp[nt][i] + ((i & 1) ? bb.y : bb.x), d);
          dh[nt][i] *= d;
        }
        bf16* hrow = h_s + (r0 + g8) * kMS + col;
        bf16* drow = dp_s + (r0 + g8) * kMS + col;
        *reinterpret_cast<uint32_t*>(hrow) = pack_bf16(hp[nt][0], hp[nt][1]);
        *reinterpret_cast<uint32_t*>(hrow + 8 * kMS) = pack_bf16(hp[nt][2], hp[nt][3]);
        *reinterpret_cast<uint32_t*>(drow) = pack_bf16(dh[nt][0], dh[nt][1]);
        *reinterpret_cast<uint32_t*>(drow + 8 * kMS) = pack_bf16(dh[nt][2], dh[nt][3]);
      }
      // db1: column sums of dpre; lane (g, t) adds column n0 + 8 (g/2) + 2t + g%2
      float cs[8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        cs[2 * nt] = dh[nt][0] + dh[nt][2];
        cs[2 * nt + 1] = dh[nt][1] + dh[nt][3];
      }
      wp_db1[n0 + 8 * (g8 >> 1) + 2 * t + (g8 & 1)] += reduce_scatter_g(cs);
    }
    __syncthreads();  // h and dpre of the whole tile are in shared memory

    // dG = dpre W1 for this warp's 16 pairs and K half; with the unrounded
    // G: dmeans, dstd (column sums) and this half's du
    float dup[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 64 / kChunk; ++c) {
      const int k0 = 64 * hf + c * kChunk;
      float dg[4][4], mu[8], sd[8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) dg[nt][0] = dg[nt][1] = dg[nt][2] = dg[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kMK / 16; ++ks) {
        uint32_t a[4];
        mmdti::load_a<kMS>(a, dp_s, r0, ks * 16);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t b[4];
          mmdti::load_b_t<kMS>(b, w1_s, ks * 16, k0 + pp * 16);
          mma_bf16(dg[2 * pp], a, b[0], b[1]);
          mma_bf16(dg[2 * pp + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = k0 + nt * 8 + 2 * t;
        const float2 A = *reinterpret_cast<const float2*>(gk + col);
        const float2 C = *reinterpret_cast<const float2*>(gk + kMK + col);
        // the fragment step and half that gauss_frag gave this column
        const int base = ((col - 64 * hf) / 16) * 8 + (nt & 1) * 4;
#pragma unroll
        for (int e = 0; e < 2; ++e) mu[2 * nt + e] = sd[2 * nt + e] = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = e ? A.y : A.x, cc = e ? C.y : C.x;
            const float z = fmaf(r ? u1 : u0, a, cc), zs = z * a;
            const float dgz = dg[nt][2 * r + e] * gf[(base + 2 * r + e) * 32 + lane];
            mu[2 * nt + e] = fmaf(dgz, zs, mu[2 * nt + e]);
            sd[2 * nt + e] = fmaf(dgz * (z * z - 1.f), a, sd[2 * nt + e]);
            dup[r] = fmaf(-dgz, zs, dup[r]);
          }
      }
      // column sums; lane (g, t) adds column k0 + 8 (g/2) + 2t + g%2
      const int col = k0 + 8 * (g8 >> 1) + 2 * t + (g8 & 1);
      wp_dmu[col] += reduce_scatter_g(mu);
      wp_dsd[col] += reduce_scatter_g(sd);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) dup[r] = mmdti::quad_sum(dup[r]);
    if (t == 0) {
      du_s[hf * kBT + r0 + g8] = dup[0];
      du_s[hf * kBT + r0 + g8 + 8] = dup[1];
    }

    // dW1 rows [32 (w / 2), +32) x columns [64 (w % 2), +64) += dpre^T G and
    // this warp's dW2 units += go^T h, the tile's 64 pairs as the depth
    const int m1 = 32 * (warp >> 1), c1 = 64 * (warp & 1);
#pragma unroll
    for (int ks = 0; ks < kBT / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mmdti::load_a_t<kMS>(a[mi], dp_s, m1 + 16 * mi, ks * 16);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t b[4];
        mmdti::load_b_t<kMS>(b, gb_s, ks * 16, c1 + pp * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(dw1[8 * mi + 2 * pp], a[mi], b[0], b[1]);
          mma_bf16(dw1[8 * mi + 2 * pp + 1], a[mi], b[2], b[3]);
        }
      }
      uint32_t a2[4];
#pragma unroll
      for (int un = 0; un < U2; ++un) {
        const int unit = warp * U2 + un, mt = unit / 4, nq = unit % 4;
        if (unit >= kUnits) break;  // warp-uniform
        if (un == 0 || nq == 0) mmdti::load_a<kGS>(a2, go_s, mt * 16, ks * 16);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t b[4];
          mmdti::load_b_t<kMS>(b, h_s, ks * 16, nq * 32 + pp * 16);
          mma_bf16(dw2[un][2 * pp], a2, b[0], b[1]);
          mma_bf16(dw2[un][2 * pp + 1], a2, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // both halves of du are in du_s
    if (tid < kBT && p0 + tid < total) du[p0 + tid] = du_s[tid] + du_s[kBT + tid];
  }

  // this block's partial sums -> partials[blockIdx.x], the layout of
  // gbf_bwd_partial_floats: dW1 [Kh][K] | dW2 [H][Kh] | db1 | db2 | dmeans | dstd
  __syncthreads();
  constexpr size_t kStride = (size_t)kMK * kMK + (size_t)H * kMK + kMK + H + 2 * kMK;
  float* o1 = partials + (size_t)blockIdx.x * kStride;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int mi = i / 8, nt = i % 8;
    float* row = o1 + (32 * (warp >> 1) + 16 * mi + g8) * kMK + 64 * (warp & 1) + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(row) = make_float2(dw1[i][0], dw1[i][1]);
    *reinterpret_cast<float2*>(row + 8 * kMK) = make_float2(dw1[i][2], dw1[i][3]);
  }
  float* o2 = o1 + kMK * kMK;
#pragma unroll
  for (int un = 0; un < U2; ++un) {
    const int unit = warp * U2 + un, mt = unit / 4, nq = unit % 4;
    if (unit >= kUnits) break;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* row = o2 + (mt * 16 + g8) * kMK + nq * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(row) = make_float2(dw2[un][nt][0], dw2[un][nt][1]);
      *reinterpret_cast<float2*>(row + 8 * kMK) = make_float2(dw2[un][nt][2], dw2[un][nt][3]);
    }
  }
  float* o_db1 = o2 + H * kMK;
  float* o_db2 = o_db1 + kMK;
  float* o_dmu = o_db2 + H;
  float* o_dsd = o_dmu + kMK;
  if (tid < kMK) {  // the warps' partials in warp order
    float s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) {
      s1 += wp_s[w * 3 * kMK + tid];
      s2 += wp_s[w * 3 * kMK + kMK + tid];
      s3 += wp_s[w * 3 * kMK + 2 * kMK + tid];
    }
    o_db1[tid] = s1;
    o_dmu[tid] = s2;
    o_dsd[tid] = s3;
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {  // the 4 lanes of a head's runs, in lane order
    float v = db2[it];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int task = tid + it * kBwdThreads;
    if ((tid & 3) == 0 && task < H * 4) o_db2[task >> 2] = v;
  }
}

template <typename P, int ACT, int H>
cudaError_t launch_mma_bwd(const float* u, const float* means, const float* stds,
                           const float* w1, const float* b1, const float* w2, const uint8_t* pad,
                           const void* g, float* du, float* grads, float* partials,
                           int max_blocks, int B, int N, float sqrt_2pi, cudaStream_t stream) {
  auto kernel = gbf_mma_bwd_kernel<P, ACT, H>;
  const size_t smem = gbf_mma_bwd_smem<P, H>();
  static int grid_cap = 0;
  cudaError_t e = persistent_grid(kernel, kBwdThreads, smem, grid_cap);
  if (e != cudaSuccess) return e;
  const unsigned long long total = (unsigned long long)B * N * N;
  if (total >= (1ull << 31)) return cudaErrorInvalidValue;
  long long grid = (long long)(total + kBT - 1) / kBT;
  if (grid > grid_cap) grid = grid_cap;
  if (grid > max_blocks) grid = max_blocks;
  if (grid == 0) return cudaSuccess;
  kernel<<<(int)grid, kBwdThreads, smem, stream>>>(u, means, stds, w1, b1, w2, pad,
                                                   static_cast<const P*>(g), du, partials, B, N,
                                                   sqrt_2pi);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int stride = (int)gbf_bwd_partial_floats(H);
  gbf_bwd_reduce_kernel<<<(stride + 255) / 256, 256, 0, stream>>>(partials, grads, (int)grid,
                                                                  stride);
  return cudaGetLastError();
}

}  // namespace

#if !defined(MMDTI_PART) || MMDTI_PART == 0
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
#endif

#if !defined(MMDTI_PART) || MMDTI_PART == 1
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
  if (K != kBwdK || Kh != kBwdK || !gbf_width(H) || (act != 0 && act != 1))
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
    switch (H) {
      case 16: return run(p, bf, a, std::integral_constant<int, 1>{});
      case 32: return run(p, bf, a, std::integral_constant<int, 2>{});
      case 48: return run(p, bf, a, std::integral_constant<int, 3>{});
      case 64: return run(p, bf, a, std::integral_constant<int, 4>{});
      default: return run(p, bf, a, std::integral_constant<int, 6>{});
    }
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
#endif

#if !defined(MMDTI_PART) || MMDTI_PART == 2
// The bf16 route ("mma"): K = Kh = 128, H 16, 32, 48, 64 or 96, every GEMM on the tensor
// cores.  Arguments as mmdti_gbf_proj_fwd's, less K, Kh and compute_bf16.
extern "C" int mmdti_gbf_proj_mma_fwd(const void* u, const void* means, const void* stds,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* pad, void* out, int B, int N,
                                      int H, int pair_bf16, int act, float sqrt_2pi,
                                      void* stream) {
  if (!gbf_width(H) || (act != 0 && act != 1)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto p, auto a, auto h) -> cudaError_t {
    return launch_mma_fwd<decltype(p), decltype(a)::value, decltype(h)::value>(
        static_cast<const float*>(u), static_cast<const float*>(means),
        static_cast<const float*>(stds), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const uint8_t*>(pad), out, B, N, sqrt_2pi,
        static_cast<cudaStream_t>(stream));
  };
  auto by_width = [&](auto p, auto a) -> cudaError_t {
    switch (H) {
      case 16: return run(p, a, std::integral_constant<int, 16>{});
      case 32: return run(p, a, std::integral_constant<int, 32>{});
      case 48: return run(p, a, std::integral_constant<int, 48>{});
      case 64: return run(p, a, std::integral_constant<int, 64>{});
      default: return run(p, a, std::integral_constant<int, 96>{});
    }
  };
  auto by_act = [&](auto p) -> cudaError_t {
    return act == 0 ? by_width(p, std::integral_constant<int, 0>{})
                    : by_width(p, std::integral_constant<int, 1>{});
  };
  return (int)(pair_bf16 ? by_act(bf16{}) : by_act(float{}));
}
#endif

#if !defined(MMDTI_PART) || MMDTI_PART == 3
// The bf16 route's backward.  Arguments as mmdti_gbf_proj_bwd's, less K, Kh
// and compute_bf16; the same outputs and partials layout.
extern "C" int mmdti_gbf_proj_mma_bwd(const void* u, const void* means, const void* stds,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* pad, const void* g, void* du, void* grads,
                                      void* partials, int max_blocks, int B, int N, int H,
                                      int pair_bf16, int act, float sqrt_2pi, void* stream) {
  if (!gbf_width(H) || (act != 0 && act != 1)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto p, auto a, auto h) -> cudaError_t {
    return launch_mma_bwd<decltype(p), decltype(a)::value, decltype(h)::value>(
        static_cast<const float*>(u), static_cast<const float*>(means),
        static_cast<const float*>(stds), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const uint8_t*>(pad), g, static_cast<float*>(du),
        static_cast<float*>(grads), static_cast<float*>(partials), max_blocks, B, N, sqrt_2pi,
        static_cast<cudaStream_t>(stream));
  };
  auto by_width = [&](auto p, auto a) -> cudaError_t {
    switch (H) {
      case 16: return run(p, a, std::integral_constant<int, 16>{});
      case 32: return run(p, a, std::integral_constant<int, 32>{});
      case 48: return run(p, a, std::integral_constant<int, 48>{});
      case 64: return run(p, a, std::integral_constant<int, 64>{});
      default: return run(p, a, std::integral_constant<int, 96>{});
    }
  };
  auto by_act = [&](auto p) -> cudaError_t {
    return act == 0 ? by_width(p, std::integral_constant<int, 0>{})
                    : by_width(p, std::integral_constant<int, 1>{});
  };
  return (int)(pair_bf16 ? by_act(bf16{}) : by_act(float{}));
}
#endif

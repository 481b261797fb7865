// Masked (BERT-style) attention forward and backward for ChemBERTa and the
// cross-modal layers (Hopper, sm_90a).
//
// Forward: replaces the TPU kernel
// mmdti_tpu/ops/pallas_attention.py::_masked_fwd_kernel (reached through
// _masked_fwd_rule's pl.pallas_call).  Per (b, h):
//
//     out = dropout(softmax((q * D^-1/2) k^T + mask[b, key])) v
//
// with an additive per-key mask [B, Nk] fp32 (finfo(float32).min for
// ChemBERTa, -10000 for cross-modal).  The TPU wrapper broadcast the mask to
// [B, Nq, Nk] only to please its compiler; these kernels read the [B, Nk] row.
// Nq != Nk is allowed (cross-modal: atoms <= 280 against SMILES <= 512).
// Backward: replaces _masked_bwd_kernel (reached through _masked_bwd_rule).
// The mask gets no gradient.
//
// Two routes, chosen by the dtype of q/k/v:
//
// * bf16 (the model's compute dtype): flash-style kernels on the tensor
//   cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; mma_tiles.cuh).
//   What bounds them on the H100: nothing of size [B,H,Nq,Nk] reaches device
//   memory, so the bytes are q/k/v/out/g_out and the gradients, and the
//   operations 4*Nq*Nk*D per (b, h) forward and 10*Nq*Nk*D backward: at
//   ChemBERTa L=512 (B=32) the least time is 0.020 ms forward (operations)
//   and 0.043 ms backward.  They run at 0.12 and 0.39 ms (NVIDIA H100 80GB
//   HBM3, 700 W; PERF.md), held back by the latency of each warp's chain of
//   mma -> softmax -> mma with at most 16 warps an SM, not by a unit's rate.
//   - forward: a block owns 64 query rows of one (b, h), 4 warps of 16 rows;
//     K/V tiles of 64 keys are double-buffered in shared memory with
//     cp.async; S = Q K^T on the tensor cores, scaled in fp32, mask added,
//     keys past Nk at -inf; online softmax in registers with the TPU
//     kernel's guard applied to the running max (a non-finite max counts as
//     0, so an all -inf prefix adds nothing and an all -inf row gives 0);
//     each p enters the row sum before dropout zeroes it, 1/(1-rate) is
//     folded into the final row constant (_softmax_factored); P is rounded
//     to bf16 in registers as the A operand of P V.  Writes out and the row
//     statistics (guarded max m, 1/rowsum) [B,H,Nq,2] fp32.
//   - backward, two launches, each output owned by one block (no atomics,
//     deterministic): (1) per 64 query rows, r = rowsum(dO * O) (equal to
//     the TPU kernel's rowsum(dp_eff * P): O carries the keep mask and
//     1/(1-rate)), written to a workspace, then per key tile S and P from
//     the saved statistics, dP = dO V^T, dS = P * (keep*c*dP - r),
//     dq += dS K; (2) per 64 keys, over query tiles, S^T = K Q^T and
//     dP^T = V dO^T, dv += (keep*c*P)^T dO, dk += dS^T Q.
// * fp32: the row kernels of attention_rows.cuh / attention_bwd.cuh (FMA
//   units, whole score rows in shared memory; the backward recomputes the
//   logits), which keep fp32 parity with the plain version at 1e-4.
#include "attention_bwd.cuh"
#include "attention_rows.cuh"
#include "mma_tiles.cuh"

namespace mmdti {

struct KeyMaskEpilogue {
  const float* mask;
  int Nk;
  __device__ __forceinline__ float score(int b, int, int, int j, float acc) const {
    return acc + mask[(size_t)b * Nk + j];
  }
};

// ---------------------------------------------------------------------------
// bf16 route: tensor-core kernels
// ---------------------------------------------------------------------------

struct MmaAttentionArgs {
  const bf16* q;       // [B, Nq, H*D]
  const bf16* k;       // [B, Nk, H*D]
  const bf16* v;
  const float* mask;   // [B, Nk]
  bf16* out;           // [B, Nq, H*D]: written by the forward, read by the backward
  const bf16* gout;    // [B, Nq, H*D]
  float* stats;        // [B, H, Nq, 2]: guarded row max m, 1/rowsum
  float* rsum;         // [B, H, Nq]: rowsum(dO * O), backward workspace
  bf16* dq;
  bf16* dk;
  bf16* dv;
  DropoutArgs drop;
  int Nq, Nk, H;
  float scale;         // D^-1/2
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
masked_mma_fwd_kernel(MmaAttentionArgs a) {
  using G = MmaGeom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + G::kTile;      // two buffers
  bf16* v_s = k_s + 2 * G::kTile;  // two buffers

  const int Nq = a.Nq, Nk = a.Nk, E = a.H * D;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kMmaTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const bf16* qg = a.q + (size_t)b * Nq * E + h * D;
  const bf16* kg = a.k + (size_t)b * Nk * E + h * D;
  const bf16* vg = a.v + (size_t)b * Nk * E + h * D;
  const float* mrow = a.mask + (size_t)b * Nk;

  zero_tile_padding<D>(q_s, 5);
  load_tile_async<D>(q_s, qg, row0, Nq, E);
  load_tile_async<D>(k_s, kg, 0, Nk, E);
  load_tile_async<D>(v_s, vg, 0, Nk, E);
  cp_async_commit();

  const int rows[2] = {row0 + warp * 16 + (lane >> 2), row0 + warp * 16 + (lane >> 2) + 8};
  const bool dropping = a.drop.seed != nullptr;
  const uint32_t key = dropping ? dropout_key(a.drop, b, h) : 0u;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[D / 8][4] = {};
  uint32_t qf[G::DP / 16][4];

  const int tiles = (Nk + kMmaTile - 1) / kMmaTile;
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < tiles) {
      load_tile_async<D>(k_s + (cur ^ 1) * G::kTile, kg, (it + 1) * kMmaTile, Nk, E);
      load_tile_async<D>(v_s + (cur ^ 1) * G::kTile, vg, (it + 1) * kMmaTile, Nk, E);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) load_a_rows<D>(qf, q_s, warp * 16);

    float s[8][4] = {};
    mma_abt<D, 8>(s, qf, k_s + cur * G::kTile, 0);

    const int j0 = it * kMmaTile + 2 * t;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + n * 8 + e;
        const bool in = j < Nk;
        const float mk = in ? __ldg(mrow + j) : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x = in ? fmaf(s[n][2 * r + e], a.scale, mk) : -INFINITY;
          s[n][2 * r + e] = x;
          tmax[r] = fmaxf(tmax[r], x);
        }
      }

    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(tmax[r]));
      const float alpha = m_run[r] == -INFINITY ? 0.f : fast_exp(m_run[r] - m_new);
      m_run[r] = m_new;
      m_use[r] = isfinite(m_new) ? m_new : 0.f;  // the TPU kernel's guard
      l_run[r] *= alpha;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][2 * r] *= alpha;
        o[dt][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = fast_exp(s[n][2 * r + e] - m_use[r]);
          l_run[r] += p;  // the row sum counts dropped probabilities
          if (dropping && !dropout_keep(key, (uint32_t)rows[r] * (uint32_t)Nk +
                                                 (uint32_t)(j0 + n * 8 + e),
                                        a.drop.threshold))
            p = 0.f;
          s[n][2 * r + e] = p;
        }
    mma_xt<D, 8>(o, s, v_s + cur * G::kTile, 0);
    __syncthreads();
  }

  float osc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / fmaxf(quad_sum(l_run[r]), 1e-30f);
    osc[r] = dropping ? inv * a.drop.scale : inv;
    if (t == 0 && rows[r] < Nq) {
      float* st = a.stats + ((size_t)(b * a.H + h) * Nq + rows[r]) * 2;
      st[0] = isfinite(m_run[r]) ? m_run[r] : 0.f;
      st[1] = inv;
    }
  }
  store_rows<D>(a.out + (size_t)b * Nq * E + h * D, E, o, rows, Nq, osc);
}

// The backward kernels walk each 64-row tile in steps of kBwdStep rows and
// reload the warp's A fragments (Q and dO, or K and V) from shared memory
// at each step, so that a thread needs at most 128 registers and 4 blocks
// (16 warps) share an SM: with 64-row steps and the fragments held in
// registers the dk/dv kernel needed 240 registers, 2 blocks an SM, and ran
// slower on the H100.  The step does not change the order of any sum.
constexpr int kBwdStep = 32;
constexpr int kBwdNT = kBwdStep / 8;
constexpr int kBwdMinBlocks = 4;

// Backward launch 1: r, then dq, per 64 query rows.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBwdMinBlocks)
masked_mma_bwd_dq_kernel(MmaAttentionArgs a) {
  using G = MmaGeom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + G::kTile;
  bf16* k_s = g_s + G::kTile;      // two buffers
  bf16* v_s = k_s + 2 * G::kTile;  // two buffers

  const int Nq = a.Nq, Nk = a.Nk, E = a.H * D;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kMmaTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const size_t q_base = (size_t)b * Nq * E + h * D;
  const bf16* kg = a.k + (size_t)b * Nk * E + h * D;
  const bf16* vg = a.v + (size_t)b * Nk * E + h * D;
  const float* mrow = a.mask + (size_t)b * Nk;

  zero_tile_padding<D>(q_s, 6);
  load_tile_async<D>(q_s, a.q + q_base, row0, Nq, E);
  load_tile_async<D>(g_s, a.gout + q_base, row0, Nq, E);
  load_tile_async<D>(k_s, kg, 0, Nk, E);
  load_tile_async<D>(v_s, vg, 0, Nk, E);
  cp_async_commit();

  // r = rowsum(dO * O) in fp32 (quad-split rows), and the forward's stats
  const int rows[2] = {row0 + warp * 16 + (lane >> 2), row0 + warp * 16 + (lane >> 2) + 8};
  const size_t st_base = (size_t)(b * a.H + h) * Nq;
  float rr[2], m[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < Nq;
    float acc = 0.f;
    if (ok) {
      const bf16* orow = a.out + q_base + (size_t)rows[r] * E;
      const bf16* grow = a.gout + q_base + (size_t)rows[r] * E;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float2 ov = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + 2 * (t + 4 * c)));
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(grow + 2 * (t + 4 * c)));
        acc = fmaf(ov.x, gv.x, fmaf(ov.y, gv.y, acc));
      }
    }
    rr[r] = quad_sum(acc);
    m[r] = ok ? a.stats[(st_base + rows[r]) * 2] : 0.f;
    inv[r] = ok ? a.stats[(st_base + rows[r]) * 2 + 1] : 0.f;
    if (ok && t == 0) a.rsum[st_base + rows[r]] = rr[r];
  }

  const bool dropping = a.drop.seed != nullptr;
  const uint32_t key = dropping ? dropout_key(a.drop, b, h) : 0u;
  float dqa[D / 8][4] = {};
  uint32_t qf[G::DP / 16][4], gf[G::DP / 16][4];

  const int tiles = (Nk + kMmaTile - 1) / kMmaTile;
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < tiles) {
      load_tile_async<D>(k_s + (cur ^ 1) * G::kTile, kg, (it + 1) * kMmaTile, Nk, E);
      load_tile_async<D>(v_s + (cur ^ 1) * G::kTile, vg, (it + 1) * kMmaTile, Nk, E);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = k_s + cur * G::kTile;
    const bf16* vt = v_s + cur * G::kTile;
#pragma unroll
    for (int sub = 0; sub < kMmaTile; sub += kBwdStep) {
      float s[kBwdNT][4] = {}, dp[kBwdNT][4] = {};
      load_a_rows<D>(qf, q_s, warp * 16);
      mma_abt<D, kBwdNT>(s, qf, kt, sub);
      load_a_rows<D>(gf, g_s, warp * 16);
      mma_abt<D, kBwdNT>(dp, gf, vt, sub);

      const int j0 = it * kMmaTile + sub + 2 * t;
#pragma unroll
      for (int n = 0; n < kBwdNT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + n * 8 + e;
          const bool in = j < Nk;
          const float mk = in ? __ldg(mrow + j) : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 2 * r + e;
            const float p = in ? fast_exp(fmaf(s[n][x], a.scale, mk) - m[r]) * inv[r] : 0.f;
            float dpe = dp[n][x];
            if (dropping)
              dpe = dropout_keep(key, (uint32_t)rows[r] * (uint32_t)Nk + (uint32_t)j,
                                 a.drop.threshold) ? dpe * a.drop.scale : 0.f;
            s[n][x] = p * (dpe - rr[r]);  // dS
          }
        }
      mma_xt<D, kBwdNT>(dqa, s, kt, sub);
    }
    __syncthreads();
  }
  const float sc[2] = {a.scale, a.scale};
  store_rows<D>(a.dq + q_base, E, dqa, rows, Nq, sc);
}

// Backward launch 2: dk and dv, per 64 keys, over query tiles.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBwdMinBlocks)
masked_mma_bwd_dkdv_kernel(MmaAttentionArgs a) {
  using G = MmaGeom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + G::kTile;
  bf16* q_s = v_s + G::kTile;      // two buffers
  bf16* g_s = q_s + 2 * G::kTile;  // two buffers
  float* st_s = reinterpret_cast<float*>(g_s + 2 * G::kTile);  // [2][3][64]: m, inv, r

  const int Nq = a.Nq, Nk = a.Nk, E = a.H * D;
  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kMmaTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const bf16* qg = a.q + (size_t)b * Nq * E + h * D;
  const bf16* gg = a.gout + (size_t)b * Nq * E + h * D;
  const size_t kv_base = (size_t)b * Nk * E + h * D;
  const size_t st_base = (size_t)(b * a.H + h) * Nq;

  auto load_stats = [&](float* dst, int i0) {
    for (int c = threadIdx.x; c < kMmaTile; c += kMmaThreads) {
      const int i = i0 + c;
      const bool ok = i < Nq;
      dst[c] = ok ? a.stats[(st_base + i) * 2] : 0.f;
      dst[kMmaTile + c] = ok ? a.stats[(st_base + i) * 2 + 1] : 0.f;
      dst[2 * kMmaTile + c] = ok ? a.rsum[st_base + i] : 0.f;
    }
  };

  zero_tile_padding<D>(k_s, 6);
  load_tile_async<D>(k_s, a.k + kv_base, key0, Nk, E);
  load_tile_async<D>(v_s, a.v + kv_base, key0, Nk, E);
  load_tile_async<D>(q_s, qg, 0, Nq, E);
  load_tile_async<D>(g_s, gg, 0, Nq, E);
  cp_async_commit();
  load_stats(st_s, 0);

  const int keys[2] = {key0 + warp * 16 + (lane >> 2), key0 + warp * 16 + (lane >> 2) + 8};
  float mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mk[r] = keys[r] < Nk ? a.mask[(size_t)b * Nk + keys[r]] : -INFINITY;
  const bool dropping = a.drop.seed != nullptr;
  const uint32_t key = dropping ? dropout_key(a.drop, b, h) : 0u;
  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  uint32_t kf[G::DP / 16][4], vf[G::DP / 16][4];

  const int tiles = (Nq + kMmaTile - 1) / kMmaTile;
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < tiles) {
      load_tile_async<D>(q_s + (cur ^ 1) * G::kTile, qg, (it + 1) * kMmaTile, Nq, E);
      load_tile_async<D>(g_s + (cur ^ 1) * G::kTile, gg, (it + 1) * kMmaTile, Nq, E);
      load_stats(st_s + (cur ^ 1) * 3 * kMmaTile, (it + 1) * kMmaTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = q_s + cur * G::kTile;
    const bf16* gt = g_s + cur * G::kTile;
    const float* st = st_s + cur * 3 * kMmaTile;
#pragma unroll
    for (int sub = 0; sub < kMmaTile; sub += kBwdStep) {
      float s[kBwdNT][4] = {}, dp[kBwdNT][4] = {}, pd[kBwdNT][4];
      load_a_rows<D>(kf, k_s, warp * 16);
      mma_abt<D, kBwdNT>(s, kf, qt, sub);   // S^T = K Q^T
      load_a_rows<D>(vf, v_s, warp * 16);
      mma_abt<D, kBwdNT>(dp, vf, gt, sub);  // dP^T = V dO^T

#pragma unroll
      for (int n = 0; n < kBwdNT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = sub + n * 8 + 2 * t + e, i = it * kMmaTile + c;
          const float mi = st[c], invi = st[kMmaTile + c], ri = st[2 * kMmaTile + c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 2 * r + e;
            const float p =
                i < Nq ? fast_exp(fmaf(s[n][x], a.scale, mk[r]) - mi) * invi : 0.f;
            float dpe = dp[n][x], pk = p;
            if (dropping) {
              const bool kept = dropout_keep(
                  key, (uint32_t)i * (uint32_t)Nk + (uint32_t)keys[r], a.drop.threshold);
              dpe = kept ? dpe * a.drop.scale : 0.f;
              pk = kept ? p * a.drop.scale : 0.f;
            }
            pd[n][x] = pk;
            s[n][x] = p * (dpe - ri);  // dS^T
          }
        }
      mma_xt<D, kBwdNT>(dva, pd, gt, sub);  // dv += (keep c P)^T dO
      mma_xt<D, kBwdNT>(dka, s, qt, sub);   // dk += dS^T Q
    }
    __syncthreads();
  }
  const float sk[2] = {a.scale, a.scale}, sv[2] = {1.f, 1.f};
  store_rows<D>(a.dk + kv_base, E, dka, keys, Nk, sk);
  store_rows<D>(a.dv + kv_base, E, dva, keys, Nk, sv);
}

template <int D>
constexpr size_t mma_smem_bytes(int tiles, int floats) {
  return sizeof(bf16) * (size_t)tiles * MmaGeom<D>::kTile + sizeof(float) * (size_t)floats;
}

template <int D>
cudaError_t launch_masked_mma_fwd(const MmaAttentionArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>(5, 0);
  static bool ready = false;
  cudaError_t e = allow_smem(masked_mma_fwd_kernel<D>, smem, ready);
  if (e != cudaSuccess) return e;
  masked_mma_fwd_kernel<D><<<dim3((a.Nq + kMmaTile - 1) / kMmaTile, a.H, B), kMmaThreads, smem,
                             stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_masked_mma_bwd(const MmaAttentionArgs& a, int B, cudaStream_t stream) {
  constexpr size_t dq_smem = mma_smem_bytes<D>(6, 0);
  constexpr size_t kv_smem = mma_smem_bytes<D>(6, 2 * 3 * kMmaTile);
  static bool dq_ready = false, kv_ready = false;
  cudaError_t e = allow_smem(masked_mma_bwd_dq_kernel<D>, dq_smem, dq_ready);
  if (e != cudaSuccess) return e;
  e = allow_smem(masked_mma_bwd_dkdv_kernel<D>, kv_smem, kv_ready);
  if (e != cudaSuccess) return e;
  masked_mma_bwd_dq_kernel<D><<<dim3((a.Nq + kMmaTile - 1) / kMmaTile, a.H, B), kMmaThreads,
                                dq_smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  masked_mma_bwd_dkdv_kernel<D><<<dim3((a.Nk + kMmaTile - 1) / kMmaTile, a.H, B), kMmaThreads,
                                  kv_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mmdti

// ---- bf16 route -------------------------------------------------------------

// q/out [B, Nq, H*D], k/v [B, Nk, H*D] bf16, 16-byte aligned; mask [B, Nk]
// fp32; stats [B, H, Nq, 2] fp32 (written); seed: one int32 on the device,
// or null for no dropout.  Returns a cudaError_t.
extern "C" int mmdti_masked_attention_mma_fwd(const void* q, const void* k, const void* v,
                                              const void* mask, void* out, void* stats,
                                              const void* seed, unsigned int threshold,
                                              float drop_scale, int drop_h0, int drop_heads,
                                              int B, int Nq, int Nk, int H,
                                              int D, void* stream) {
  using namespace mmdti;
  if (Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  MmaAttentionArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const float*>(mask),
                     static_cast<bf16*>(out), nullptr, static_cast<float*>(stats), nullptr,
                     nullptr, nullptr, nullptr,
                     DropoutArgs{static_cast<const int*>(seed), threshold, drop_scale,
                         drop_h0, drop_heads},
                     Nq, Nk, H, 1.0f / sqrtf((float)D)};
  return (int)dispatch_dim(D, [&](auto d) {
    return launch_masked_mma_fwd<decltype(d)::value>(a, B, static_cast<cudaStream_t>(stream));
  });
}

// The forward's q, k, v, mask, out and stats, and g_out [B, Nq, H*D] bf16;
// rsum is an fp32 workspace of B*H*Nq floats; dq [B, Nq, H*D], dk/dv
// [B, Nk, H*D] bf16 (written).  Returns a cudaError_t.
extern "C" int mmdti_masked_attention_mma_bwd(const void* q, const void* k, const void* v,
                                              const void* mask, const void* out,
                                              const void* gout, const void* stats, void* rsum,
                                              void* dq, void* dk, void* dv, const void* seed,
                                              unsigned int threshold,
                                              float drop_scale, int drop_h0, int drop_heads, int B,
                                              int Nq, int Nk, int H, int D, void* stream) {
  using namespace mmdti;
  if (Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  MmaAttentionArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const float*>(mask),
                     static_cast<bf16*>(const_cast<void*>(out)), static_cast<const bf16*>(gout),
                     static_cast<float*>(const_cast<void*>(stats)), static_cast<float*>(rsum),
                     static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                     DropoutArgs{static_cast<const int*>(seed), threshold, drop_scale,
                         drop_h0, drop_heads},
                     Nq, Nk, H, 1.0f / sqrtf((float)D)};
  return (int)dispatch_dim(D, [&](auto d) {
    return launch_masked_mma_bwd<decltype(d)::value>(a, B, static_cast<cudaStream_t>(stream));
  });
}

// ---- fp32 route ---------------------------------------------------------------

// q/out [B, Nq, H*D], k/v [B, Nk, H*D] fp32; mask [B, Nk] fp32; seed: one
// int32 on the device, or null for no dropout.  Returns a cudaError_t.
extern "C" int mmdti_masked_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, const void* seed,
                                          unsigned int threshold,
                                          float drop_scale, int drop_h0, int drop_heads, int B,
                                          int Nq, int Nk, int H, int D, void* stream) {
  using namespace mmdti;
  const float scale = 1.0f / sqrtf((float)D);
  const DropoutArgs drop{static_cast<const int*>(seed), threshold, drop_scale,
                         drop_h0, drop_heads};
  KeyMaskEpilogue epi{static_cast<const float*>(mask), Nk};
  return (int)dispatch_dim(D, [&](auto d) {
    return launch_attention_rows<float, decltype(d)::value>(
        q, k, v, out, epi, drop, B, Nq, Nk, H, scale, static_cast<cudaStream_t>(stream));
  });
}

// q, g_out, dq [B, Nq, H*D]; k/v, dk/dv [B, Nk, H*D] fp32; mask [B, Nk]
// fp32; g_out may be null.  stats is an fp32 workspace of B*H*Nq*3 floats.
// Logits are recomputed from q, k and the mask.  Returns a cudaError_t.
extern "C" int mmdti_masked_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* mask, const void* gout, void* dq,
                                          void* dk, void* dv, void* stats, const void* seed,
                                          unsigned int threshold,
                                          float drop_scale, int drop_h0, int drop_heads, int B,
                                          int Nq, int Nk, int H, int D, void* stream) {
  using namespace mmdti;
  const DropoutArgs drop{static_cast<const int*>(seed), threshold, drop_scale,
                         drop_h0, drop_heads};
  return (int)dispatch_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    AttentionBwdArgs<float, float> a{
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(gout), nullptr, nullptr,
        static_cast<const float*>(mask), static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), nullptr, static_cast<float*>(stats), drop, Nq, Nk, H,
        1.0f / sqrtf((float)kD)};
    return launch_attention_bwd<float, float, kD, false>(a, B,
                                                         static_cast<cudaStream_t>(stream));
  });
}

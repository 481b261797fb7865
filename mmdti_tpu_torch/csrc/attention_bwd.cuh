// Row-block attention backward shared by pair_bias_attention.cu and
// masked_attention.cu.  Per (b, h), with P_un = exp(S - m), inv_s = 1/rowsum
// (the forward's guarded softmax), the replayed dropout mask keep and
// c = 1/(1 - rate):
//
//   dp_eff = keep ? (g_out v^T) * c : 0
//   r      = rowsum(dp_eff * P_un) * inv_s
//   dL     = P_un * (dp_eff - r) * inv_s  (+ g_logits for pair-bias)
//   dq = scale * dL k,   dk = scale * dL^T q,   dv = (keep ? P_un*inv_s*c : 0)^T g_out
//
// as the TPU kernels' _attention_bwd_core.  S is read back from the stored
// logits (pair-bias) or recomputed from q, k and the key mask (masked).
//
// The TPU kernels sum dk/dv over a sequential grid.  Blocks here run in no
// order, so the work is split into two launches and each output is owned by
// one block, with no atomics — the result is deterministic:
//
//   1. rows: one block per (32 query rows, h, b) holds its whole score rows in
//      shared memory (as the forward), writes dq (and dbias), and writes the
//      row statistics (m, inv_s, r) to a small fp32 workspace [B,H,Nq,3];
//   2. cols: one block per (32 keys, h, b) walks all query rows in tiles of
//      32, recomputes P_un and dL for its keys from the row statistics, and
//      accumulates dk/dv in registers.
//
// Either cotangent may be absent (a null pointer): a missing g_out makes
// dp_eff and dv zero, a missing g_logits adds nothing; neither is read.
#pragma once

#include "attention_rows.cuh"
#include "dropout.cuh"

namespace mmdti {

constexpr int kStats = 3;          // per query row: guarded max m, inv_s, r
constexpr int kCols = 32;          // keys per block in the cols launch
constexpr int kColThreads = 256;

template <typename T, typename P>
struct AttentionBwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* gout;        // [B,Nq,E] or nullptr
  const P* logits;      // pair-bias: stored logits [B,H,Nq,Nk]; masked: nullptr
  const P* glog;        // pair-bias: logits cotangent [B,H,Nq,Nk] or nullptr
  const float* mask;    // masked: additive key mask [B,Nk]; pair-bias: nullptr
  T* dq;
  T* dk;
  T* dv;
  P* dbias;             // pair-bias only
  float* stats;         // [B,H,Nq,kStats] workspace
  DropoutArgs drop;
  int Nq, Nk, H;
  float scale;          // D^-1/2
};

inline size_t bwd_rows_smem_bytes(int D, int Nk) {
  return sizeof(float) * ((size_t)kTileK * (D + 1) + 2 * (size_t)kRows * D +
                          2 * (size_t)kRows * Nk + 2 * kRows);
}

inline size_t bwd_cols_smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)kCols * (D + 1) + 2 * (size_t)kRows * D +
                          (size_t)kRows * kStats + 2 * (size_t)kRows * (kCols + 1));
}

template <typename T, typename P, int D, bool kPair>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_rows_kernel(AttentionBwdArgs<T, P> a) {
  constexpr int G = D >= 32 ? 1 : 32 / D;
  constexpr int DPL = D >= 32 ? D / 32 : 1;
  extern __shared__ float smem[];
  const int Nq = a.Nq, Nk = a.Nk, H = a.H;
  float* kv_s = smem;                        // [kTileK][D+1]
  float* g_s = kv_s + kTileK * (D + 1);      // [kRows][D] g_out rows
  float* q_s = g_s + kRows * D;              // [kRows][D] scaled q rows (masked)
  float* s_s = q_s + kRows * D;              // [kRows][Nk] scores, then P_un
  float* d_s = s_s + (size_t)kRows * Nk;     // [kRows][Nk] dp_eff, then dL
  float* inv_s = d_s + (size_t)kRows * Nk;   // [kRows]
  float* m_s = inv_s + kRows;                // [kRows]

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int E = H * D;
  const size_t q_base = (size_t)b * Nq * E + (size_t)h * D;
  const size_t kv_base = (size_t)b * Nk * E + (size_t)h * D;
  const size_t pair_base = ((size_t)b * H + h) * Nq * Nk;
  const bool has_g = a.gout != nullptr;

  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, i = row0 + r;
    g_s[idx] = i < Nq && has_g ? to_f(a.gout[q_base + (size_t)i * E + d]) : 0.f;
    if (!kPair) q_s[idx] = i < Nq ? to_f(a.q[q_base + (size_t)i * E + d]) * a.scale : 0.f;
  }

  // ---- scores S: the stored logits, or (q * scale) k^T + mask ---------------
  if constexpr (kPair) {
    for (int idx = threadIdx.x; idx < kRows * Nk; idx += blockDim.x) {
      const int r = idx / Nk, j = idx % Nk, i = row0 + r;
      s_s[idx] = i < Nq ? to_f(a.logits[pair_base + (size_t)i * Nk + j]) : 0.f;
    }
  } else {
    for (int t0 = 0; t0 < Nk; t0 += kTileK) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < kTileK * D; idx += blockDim.x) {
        const int jj = idx / D, d = idx % D, j = t0 + jj;
        kv_s[jj * (D + 1) + d] = j < Nk ? to_f(a.k[kv_base + (size_t)j * E + d]) : 0.f;
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
          const int rr = warp * kRowsPerWarp + r;
          s_s[(size_t)rr * Nk + j] = row0 + rr < Nq ? acc[r] + a.mask[(size_t)b * Nk + j] : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // ---- P_un and the row constants (warp-local rows) ------------------------
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = warp * kRowsPerWarp + r;
    float* row = s_s + (size_t)rr * Nk;
    float m = -INFINITY;
    for (int j = lane; j < Nk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    if (!isfinite(m)) m = 0.f;  // fully-masked row guard (as the forward)
    float sum = 0.f;
    for (int j = lane; j < Nk; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      inv_s[rr] = 1.f / fmaxf(sum, 1e-30f);
      m_s[rr] = m;
    }
  }

  // ---- dp_eff = keep ? (g_out v^T) * c : 0 ---------------------------------
  const bool dropping = a.drop.seed != nullptr;
  const uint32_t key = dropping ? dropout_key(a.drop, b * H + h) : 0u;
  if (has_g) {
    for (int t0 = 0; t0 < Nk; t0 += kTileK) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < kTileK * D; idx += blockDim.x) {
        const int jj = idx / D, d = idx % D, j = t0 + jj;
        kv_s[jj * (D + 1) + d] = j < Nk ? to_f(a.v[kv_base + (size_t)j * E + d]) : 0.f;
      }
      __syncthreads();
      for (int jj = lane; jj < kTileK && t0 + jj < Nk; jj += 32) {
        const int j = t0 + jj;
        float acc[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float vd = kv_s[jj * (D + 1) + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r] = fmaf(g_s[(warp * kRowsPerWarp + r) * D + d], vd, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int rr = warp * kRowsPerWarp + r;
          float dp = acc[r];
          if (dropping)
            dp = dropout_keep(key, (uint32_t)(row0 + rr) * (uint32_t)Nk + j, a.drop.threshold)
                     ? dp * a.drop.scale : 0.f;
          d_s[(size_t)rr * Nk + j] = dp;
        }
      }
    }
  }
  __syncwarp();

  // ---- dL, dbias and the row statistics -------------------------------------
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = warp * kRowsPerWarp + r, i = row0 + rr;
    const float* prow = s_s + (size_t)rr * Nk;
    float* drow = d_s + (size_t)rr * Nk;
    const float inv = inv_s[rr];
    float rsum = 0.f;
    if (has_g) {
      for (int j = lane; j < Nk; j += 32) rsum += drow[j] * prow[j];
      rsum = warp_sum(rsum) * inv;
    }
    for (int j = lane; j < Nk; j += 32) {
      float dl = has_g ? prow[j] * ((drow[j] - rsum) * inv) : 0.f;
      if constexpr (kPair) {
        if (i < Nq) {
          const size_t idx = pair_base + (size_t)i * Nk + j;
          if (a.glog != nullptr) dl += to_f(a.glog[idx]);
          a.dbias[idx] = from_f<P>(dl);
        }
      }
      drow[j] = dl;
    }
    if (lane == 0 && i < Nq) {
      float* st = a.stats + (((size_t)b * H + h) * Nq + i) * kStats;
      st[0] = m_s[rr];
      st[1] = inv;
      st[2] = rsum;
    }
  }

  // ---- dq = scale * dL k ------------------------------------------------------
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
      kv_s[jj * (D + 1) + d] = j < Nk ? to_f(a.k[kv_base + (size_t)j * E + d]) : 0.f;
    }
    __syncthreads();
    const int tn = min(kTileK, Nk - t0);
    for (int jj = g; jj < tn; jj += G) {
      float kd[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) kd[c] = kv_s[jj * (D + 1) + d0 + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dl = d_s[(size_t)(warp * kRowsPerWarp + r) * Nk + t0 + jj];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(dl, kd[c], acc[r][c]);
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
      const int i = row0 + warp * kRowsPerWarp + r;
      if (i >= Nq) continue;
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        a.dq[q_base + (size_t)i * E + d0 + 32 * c] = from_f<T>(acc[r][c] * a.scale);
    }
  }
}

template <typename T, typename P, int D, bool kPair>
__global__ void __launch_bounds__(kColThreads)
attention_bwd_cols_kernel(AttentionBwdArgs<T, P> a) {
  constexpr int NO = kCols * D / kColThreads;  // dk and dv outputs per thread
  constexpr int CP = kCols + 1;
  extern __shared__ float smem[];
  const int Nq = a.Nq, Nk = a.Nk, H = a.H;
  float* k_s = smem;                          // [kCols][D+1]
  float* v_s = k_s + kCols * (D + 1);         // [kCols][D+1]
  float* q_s = v_s + kCols * (D + 1);         // [kRows][D] unscaled q rows
  float* g_s = q_s + kRows * D;               // [kRows][D] g_out rows
  float* st_s = g_s + kRows * D;              // [kRows][kStats]
  float* dl_s = st_s + kRows * kStats;        // [kRows][kCols+1]
  float* pd_s = dl_s + kRows * CP;            // [kRows][kCols+1]

  const int b = blockIdx.z, h = blockIdx.y;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int E = H * D;
  const size_t q_base = (size_t)b * Nq * E + (size_t)h * D;
  const size_t kv_base = (size_t)b * Nk * E + (size_t)h * D;
  const size_t pair_base = ((size_t)b * H + h) * Nq * Nk;
  const float* stats = a.stats + ((size_t)b * H + h) * Nq * kStats;
  const bool has_g = a.gout != nullptr;
  const bool dropping = a.drop.seed != nullptr;
  const uint32_t key = dropping ? dropout_key(a.drop, b * H + h) : 0u;
  const float c_drop = dropping ? a.drop.scale : 1.f;

  for (int idx = tid; idx < kCols * D; idx += kColThreads) {
    const int jj = idx / D, d = idx % D, j = col0 + jj;
    k_s[jj * (D + 1) + d] = j < Nk ? to_f(a.k[kv_base + (size_t)j * E + d]) : 0.f;
    v_s[jj * (D + 1) + d] = j < Nk ? to_f(a.v[kv_base + (size_t)j * E + d]) : 0.f;
  }

  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int c = 0; c < NO; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int i0 = 0; i0 < Nq; i0 += kRows) {
    __syncthreads();
    for (int idx = tid; idx < kRows * D; idx += kColThreads) {
      const int r = idx / D, d = idx % D, i = i0 + r;
      q_s[idx] = i < Nq ? to_f(a.q[q_base + (size_t)i * E + d]) : 0.f;
      g_s[idx] = i < Nq && has_g ? to_f(a.gout[q_base + (size_t)i * E + d]) : 0.f;
    }
    for (int idx = tid; idx < kRows * kStats; idx += kColThreads)
      st_s[idx] = i0 + idx / kStats < Nq ? stats[(size_t)i0 * kStats + idx] : 0.f;
    __syncthreads();

    for (int e = tid; e < kRows * kCols; e += kColThreads) {
      const int r = e / kCols, jj = e % kCols, i = i0 + r, j = col0 + jj;
      float dl = 0.f, pd = 0.f;
      if (i < Nq && j < Nk) {
        float s;
        if constexpr (kPair) {
          s = to_f(a.logits[pair_base + (size_t)i * Nk + j]);
        } else {
          s = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d)
            s = fmaf(q_s[r * D + d] * a.scale, k_s[jj * (D + 1) + d], s);
          s += a.mask[(size_t)b * Nk + j];
        }
        const float m = st_s[r * kStats], inv = st_s[r * kStats + 1];
        const float p_un = expf(s - m);
        float dp = 0.f;
        if (has_g) {
#pragma unroll 8
          for (int d = 0; d < D; ++d) dp = fmaf(g_s[r * D + d], v_s[jj * (D + 1) + d], dp);
        }
        const bool kept =
            !dropping || dropout_keep(key, (uint32_t)i * (uint32_t)Nk + j, a.drop.threshold);
        const float dpe = kept ? dp * c_drop : 0.f;
        if (has_g) dl = p_un * ((dpe - st_s[r * kStats + 2]) * inv);
        if constexpr (kPair) {
          if (a.glog != nullptr) dl += to_f(a.glog[pair_base + (size_t)i * Nk + j]);
        }
        pd = kept ? p_un * (inv * c_drop) : 0.f;
      }
      dl_s[r * CP + jj] = dl;
      pd_s[r * CP + jj] = pd;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < NO; ++c) {
      const int o = tid + kColThreads * c, jj = o / D, d = o % D;
      float sk = dk_acc[c], sv = dv_acc[c];
      for (int r = 0; r < kRows; ++r) {
        sk = fmaf(dl_s[r * CP + jj], q_s[r * D + d], sk);
        sv = fmaf(pd_s[r * CP + jj], g_s[r * D + d], sv);
      }
      dk_acc[c] = sk;
      dv_acc[c] = sv;
    }
  }

#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int o = tid + kColThreads * c, jj = o / D, d = o % D, j = col0 + jj;
    if (j >= Nk) continue;
    a.dk[kv_base + (size_t)j * E + d] = from_f<T>(dk_acc[c] * a.scale);
    a.dv[kv_base + (size_t)j * E + d] = from_f<T>(dv_acc[c]);
  }
}

// Both launches on `stream`; returns the first failing cudaError_t (0 = ok).
template <typename T, typename P, int D, bool kPair>
cudaError_t launch_attention_bwd(const AttentionBwdArgs<T, P>& a, int B, cudaStream_t stream) {
  const size_t rows_smem = bwd_rows_smem_bytes(D, a.Nk);
  if (rows_smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  auto rows = attention_bwd_rows_kernel<T, P, D, kPair>;
  auto cols = attention_bwd_cols_kernel<T, P, D, kPair>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  rows<<<dim3((a.Nq + kRows - 1) / kRows, a.H, B), kWarps * 32, rows_smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cols<<<dim3((a.Nk + kCols - 1) / kCols, a.H, B), kColThreads, bwd_cols_smem_bytes(D),
         stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mmdti

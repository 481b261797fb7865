// Pair-bias self-attention forward and backward for the Uni-Mol encoder
// (Hopper, sm_90a).
//
// Forward: replaces the TPU kernel
// mmdti_tpu/ops/pallas_attention.py::_fwd_kernel (reached through _run_fwd's
// pl.pallas_call).  Per (b, h):
//
//     logits = (q * D^-1/2) k^T + bias      fp32; bias carries -inf at pad keys
//     out    = dropout(softmax(logits)) v   (the TPU kernels' guarded softmax)
//
// and the pre-dropout logits are stored in the pair dtype as the next
// layer's bias.  Backward: replaces _bwd_kernel (reached through _bwd_rule).
// From the stored logits and the replayed dropout mask (dropout.cuh), with P
// the softmax of the stored logits, c = 1/(1 - rate),
// dp_eff = keep ? (g_out v^T) c : 0 and r = rowsum(dp_eff * P):
//
//     dL = P * (dp_eff - r) + g_logits = dbias
//     dq = D^-1/2 dL k,  dk = D^-1/2 dL^T q,  dv = (keep ? P c : 0)^T g_out
//
// What bounds it on the H100: with H=64 heads of D=8 the products are tiny
// (2*N*D FLOP per score and product) and both directions live on the
// [B,H,N,N] tensors.  The forward must read the bias and write the logits,
// 2 bytes each per score in bf16; the backward must read the logits and
// g_logits and write dbias, 6 bytes a score.  At B=32 that is 0.0125 /
// 0.0194 ms at N=64 and 0.203 / 0.307 ms at N=280: bytes bound both.
//
// Two routes, chosen by dtype:
//
// * bf16 q/k/v with a bf16 pair (the model's path on the card): tensor-core
//   kernels (mma.sync m16n8k16, bf16 in, fp32 accumulate; mma_tiles.cuh).
//   The pair tensors move as 64 x 64 tiles: 16-byte cp.async loads one tile
//   ahead into padded shared memory (row stride 72, so fragment reads and
//   ldmatrix hit no bank twice) and coalesced 16-byte stores out of it; when
//   N % 8 != 0 the rows are not 16-byte aligned and 2-byte accesses are used.
//   A tile's keys past N are filled with -inf as it is loaded, and work that
//   lies wholly past N (a warp's rows, 32 keys of the backward) is skipped.
//   Dropout is a template flag, so the score loops have no branch.
//   - forward: one block of 4 warps per (64 query rows, h, b), 16 rows a
//     warp.  Per 64-key tile: S = Q K^T on the tensor cores, scaled in fp32,
//     the bias tile added to the C fragments; the logits overwrite the
//     bias tile in shared memory and leave from there; an online softmax
//     over the tiles with the TPU kernel's guard on the running max (as
//     masked_attention.cu), each p summed before dropout drops it and
//     1/(1-rate) folded into the final row constant; P packed to bf16 in
//     registers as the A operand of P V.  It writes out and the
//     row stats [B,H,N,2] fp32: the guarded max m and 1/rowsum of
//     exp(l~ - m) over the STORED (rounded) logits l~, the ones the backward
//     reads, so that the backward's P = exp(l~ - m) / rowsum is the softmax
//     of the stored logits, as the TPU backward recomputes it.
//   - backward: ONE launch, one block of 4 warps per (b, h).  It walks the
//     key tiles of 64 and, inside each, the query tiles of 64 (stage s =
//     kt * T + qt); each stage's logits and g_logits tiles, with its Q,
//     g_out, K and V tiles, arrive by cp.async one stage ahead.  First each
//     warp owns 16 query rows of the stage: dP = g_out V^T on the tensor
//     cores, P = exp(l - m) * inv from the forward's stats, the dropout hash
//     replayed once a score, dL = P * (dp_eff - r) + g_logits, and
//     dq += dL K (mma; the lane that owns a dq entry keeps its running sum
//     in shared memory, ordered by key tile); dL overwrites the logits tile
//     and (keep ? P c : 0) the g_logits tile.  Then each warp owns 16 keys
//     of the tile and adds dk += dL^T Q and dv += (keep P c)^T g_out (mma,
//     the A operand read transposed by ldmatrix) into registers, summed over
//     the query tiles in order and written once when the key tile ends,
//     while the block stores dL as dbias with 16-byte stores.  dq is written
//     once at the end.  Every sum runs in a fixed order and every output
//     has one owner: no float atomics, no workspace, and the result is
//     bit-equal from run to run.  The logits and g_logits are read once and
//     dbias is written once: 6 bytes a score.  The stage loop is not
//     unrolled and holds only the current key tile's dk/dv: holding every
//     key tile's (query tiles outermost) needs the loop unrolled T times and
//     more registers than 3 blocks an SM leave, and ran several times
//     slower.  What key tiles outermost costs: where a row is not a multiple
//     of 32 bytes (N=280: 560), the sector that two neighbouring key tiles
//     share is read and written T stages apart and leaves L2 in between
//     (scripts/pair_bias_variants.py measures it; PERF.md).
//     r = rowsum(g_out * out), equal to rowsum(dp_eff * P) in exact
//     arithmetic (out carries keep and c), costs D products a row instead of
//     a second pass over the row; it carries the bf16 rounding of the stored
//     out and the difference between the softmax of the fp32 and of the
//     stored logits, each about 2^-9 of |r| (the bf16 tolerance covers it).
//     Shared memory grows with N by 4 (D + 3) bytes a padded row (dq and
//     the row stats): at D=8 about 75 KB at N=280, 3 blocks an SM.  One
//     block per (b, h) fills the card only when B*H is a few blocks per SM
//     (2048 at B=32, H=64).
// * fp32 q/k/v or an fp32 pair: the row kernels of attention_rows.cuh and
//   attention_bwd.cuh (FMA units, whole score rows in shared memory; a row
//   launch for dq/dbias and a key-column launch for dk/dv, the logits and
//   g_logits read twice), which keep fp32 parity with the plain version.
#include "attention_bwd.cuh"
#include "attention_rows.cuh"
#include "mma_tiles.cuh"

namespace mmdti {

template <typename P>
struct PairBiasEpilogue {
  const P* bias;
  P* logits;
  int H, N;
  __device__ __forceinline__ float score(int b, int h, int i, int j, float acc) const {
    const size_t idx = (((size_t)b * H + h) * N + i) * N + j;
    const float l = acc + to_f(bias[idx]);
    logits[idx] = from_f<P>(l);
    return l;
  }
};


// ---------------------------------------------------------------------------
// bf16 route: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kPairS = kMmaTile + 8;          // bf16 row stride of a 64 x 64 pair tile
constexpr int kPairTile = kMmaTile * kPairS;  // bf16 elements
constexpr int kPairStep = 32;                 // keys per step of the backward's dL pass

struct PairMmaArgs {
  const bf16* q;        // [B, N, H*D]
  const bf16* k;
  const bf16* v;
  const bf16* bias;     // forward: [B, H, N, N]
  bf16* logits;         // forward: written; backward: read
  bf16* out;            // [B, N, H*D]: forward writes, backward reads
  float* stats;         // [B, H, N, 2]: guarded max m, 1/rowsum of exp(stored logit - m)
  const bf16* gout;     // backward: [B, N, H*D] or nullptr
  const bf16* glog;     // backward: [B, H, N, N] or nullptr
  bf16* dq;
  bf16* dk;
  bf16* dv;
  bf16* dbias;
  DropoutArgs drop;
  int N, H;
  float scale;          // D^-1/2
};

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// Rows [i0, i0 + 64) x columns [j0, j0 + 64) of one (b, h) N x N matrix g
// into a pair tile: in rows inside N the columns past N hold `past` (-inf
// for the bias and the logits, so that a key past N scores -inf and its
// probability is 0 with no test per score); rows past N hold 0, which the
// backward's products over rows may read.  vec (N % 8 == 0): 16-byte
// cp.async chunks of 8 columns, each wholly inside or outside the matrix;
// otherwise 2-byte loads.  Called by all kMmaThreads threads.
__device__ __forceinline__ void load_pair_tile(bf16* s, const bf16* g, int i0, int j0, int N,
                                               bool vec, bf16 past) {
  for (int idx = threadIdx.x; idx < kMmaTile * 8; idx += kMmaThreads) {
    const int r = idx >> 3, c = (idx & 7) * 8, i = i0 + r, j = j0 + c;
    bf16* dst = s + r * kPairS + c;
    if (vec && j >= N) {
      const bf16 f = i < N ? past : __float2bfloat16(0.f);
      const __nv_bfloat162 p2 = __halves2bfloat162(f, f);
      const uint32_t w = *reinterpret_cast<const uint32_t*>(&p2);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w, w, w, w);
    } else if (vec) {
      cp_async16(dst, g + (i < N ? (size_t)i * N + j : 0), i < N);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = i >= N ? __float2bfloat16(0.f) : j + e >= N ? past : g[(size_t)i * N + j + e];
    }
  }
}

// The entries of a pair tile that lie inside the N x N matrix g, back to g.
__device__ __forceinline__ void store_pair_tile(bf16* g, const bf16* s, int i0, int j0, int N,
                                                bool vec) {
  for (int idx = threadIdx.x; idx < kMmaTile * 8; idx += kMmaThreads) {
    const int r = idx >> 3, c = (idx & 7) * 8, i = i0 + r, j = j0 + c;
    if (i >= N || j >= N) continue;
    const bf16* src = s + r * kPairS + c;
    bf16* dst = g + (size_t)i * N + j;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && j + e < N; ++e) dst[e] = src[e];
    }
  }
}

// Shared memory of the forward: the Q tile, then one buffer (two when N
// spans more than one key tile) of K and V tiles and of the bias tile that
// the logits overwrite.
template <int D>
size_t pair_fwd_smem_bytes(int N) {
  const size_t bufs = N > kMmaTile ? 2 : 1;
  return sizeof(bf16) * ((1 + 2 * bufs) * (size_t)MmaGeom<D>::kTile + bufs * (size_t)kPairTile);
}

// kDrop: dropout on (a.drop.seed set).  A compile-time flag keeps the score
// loops free of branches, so the compiler interleaves the dropout hash
// chains of a thread's scores; a run-time test there compiled to a branch
// around each score's hash and ran each 18-instruction chain at full
// latency.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kMmaThreads, D <= 16 ? 7 : 4)
pair_mma_fwd_kernel(PairMmaArgs a) {
  using G = MmaGeom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, E = a.H * D, bufs = N > kMmaTile ? 2 : 1;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + G::kTile;         // `bufs` buffers
  bf16* v_s = k_s + bufs * G::kTile;  // `bufs` buffers
  bf16* p_s = v_s + bufs * G::kTile;  // `bufs` pair tiles: the bias in, the logits out

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kMmaTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const size_t tok = (size_t)b * N * E + h * D;
  const size_t pair = (size_t)(b * a.H + h) * N * N;
  const bool vec = (N & 7) == 0;

  zero_tile_padding<D>(q_s, 1 + 2 * bufs);
  load_tile_async<D>(q_s, a.q + tok, row0, N, E);
  load_tile_async<D>(k_s, a.k + tok, 0, N, E);
  load_tile_async<D>(v_s, a.v + tok, 0, N, E);
  const bf16 neg_inf = __float2bfloat16(-INFINITY);
  load_pair_tile(p_s, a.bias + pair, row0, 0, N, vec, neg_inf);
  cp_async_commit();

  const int lr[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};  // tile rows
  const int rows[2] = {row0 + lr[0], row0 + lr[1]};
  const uint32_t key = kDrop ? dropout_key(a.drop, b, h) : 0u;
  // running max, row sum of exp(l - m) (the softmax) and of exp(l~ - m)
  // over the stored logits l~ (the backward's normaliser)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, ls_run[2] = {0.f, 0.f};
  float o[D / 8][4] = {};
  uint32_t qf[G::DP / 16][4];

  const int tiles = (N + kMmaTile - 1) / kMmaTile;
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; iteration it - 1 is done with buffer cur ^ 1
    if (it + 1 < tiles) {
      const int nxt = (it + 1) * kMmaTile;
      load_tile_async<D>(k_s + (cur ^ 1) * G::kTile, a.k + tok, nxt, N, E);
      load_tile_async<D>(v_s + (cur ^ 1) * G::kTile, a.v + tok, nxt, N, E);
      load_pair_tile(p_s + (cur ^ 1) * kPairTile, a.bias + pair, row0, nxt, N, vec, neg_inf);
    }
    cp_async_commit();
    if (it == 0) load_a_rows<D>(qf, q_s, warp * 16);
    bf16* pt = p_s + cur * kPairTile;
    if (row0 + warp * 16 < N) {  // a warp whose rows are all past N has nothing to do
      float s[8][4] = {};
      mma_abt<D, 8>(s, qf, k_s + cur * G::kTile, 0);

      const int j0 = it * kMmaTile + 2 * t;
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bf16* cell = pt + lr[r] * kPairS + n * 8 + 2 * t;
          const float2 bias = ld_bf16x2(cell);  // -inf past N
          const float x0 = fmaf(s[n][2 * r], a.scale, bias.x);
          const float x1 = fmaf(s[n][2 * r + 1], a.scale, bias.y);
          st_bf16x2(cell, x0, x1);  // the logits, over the bias
          s[n][2 * r] = x0;
          s[n][2 * r + 1] = x1;
          tmax[r] = fmaxf(tmax[r], fmaxf(x0, x1));
        }

      float ml2[2];  // the guarded running max, times log2 e
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(tmax[r]));
        const float alpha = m_run[r] == -INFINITY ? 0.f : fast_exp(m_run[r] - m_new);
        m_run[r] = m_new;
        ml2[r] = isfinite(m_new) ? m_new * kLog2e : 0.f;  // the TPU kernel's guard
        l_run[r] *= alpha;
        ls_run[r] *= alpha;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          o[dt][2 * r] *= alpha;
          o[dt][2 * r + 1] *= alpha;
        }
      }

#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 stored = ld_bf16x2(pt + lr[r] * kPairS + n * 8 + 2 * t);
          ls_run[r] += ex2_ftz(fmaf(stored.x, kLog2e, -ml2[r])) +
                       ex2_ftz(fmaf(stored.y, kLog2e, -ml2[r]));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = ex2_ftz(fmaf(s[n][2 * r + e], kLog2e, -ml2[r]));
            l_run[r] += p;  // the row sum counts dropped probabilities
            if constexpr (kDrop)
              p = dropout_keep(key, (uint32_t)rows[r] * (uint32_t)N + (uint32_t)(j0 + n * 8 + e),
                               a.drop.threshold) ? p : 0.f;
            s[n][2 * r + e] = p;
          }
        }
      mma_xt<D, 8>(o, s, v_s + cur * G::kTile, 0);
    }
    __syncthreads();  // the logits tile is whole
    store_pair_tile(a.logits + pair, pt, row0, it * kMmaTile, N, vec);
  }

  float osc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / fmaxf(quad_sum(l_run[r]), 1e-30f);
    const float inv_stored = 1.f / fmaxf(quad_sum(ls_run[r]), 1e-30f);
    osc[r] = kDrop ? inv * a.drop.scale : inv;
    if (t == 0 && rows[r] < N) {
      float* st = a.stats + ((size_t)(b * a.H + h) * N + rows[r]) * 2;
      st[0] = isfinite(m_run[r]) ? m_run[r] : 0.f;
      st[1] = inv_stored;
    }
  }
  store_rows<D>(a.out + tok, E, o, rows, N, osc);
}

// Shared memory of the backward: one stage buffer (two when the block has
// more than one stage) of Q, g_out, K and V tiles and the logits and
// g_logits pair tiles; then dq [T*64][D] and the row stats m, 1/rowsum and
// r [3][T*64], fp32.  T = ceil(N/64).
template <int D>
constexpr size_t kPairBwdStage = 4 * (size_t)MmaGeom<D>::kTile + 2 * (size_t)kPairTile;

template <int D>
size_t pair_bwd_smem_bytes(int N) {
  const size_t T = (N + kMmaTile - 1) / kMmaTile;
  return sizeof(bf16) * (T > 1 ? 2 : 1) * kPairBwdStage<D> + sizeof(float) * T * kMmaTile * (D + 3);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kMmaThreads, D <= 16 ? 4 : 2)
pair_mma_bwd_kernel(PairMmaArgs a) {
  using G = MmaGeom<D>;
  constexpr int NT = kPairStep / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, E = a.H * D;
  const int T = (N + kMmaTile - 1) / kMmaTile, stages = T * T, NP = T * kMmaTile;
  bf16* stage_s = reinterpret_cast<bf16*>(smem_raw);
  float* dq_s = reinterpret_cast<float*>(stage_s + (stages > 1 ? 2 : 1) * kPairBwdStage<D>);
  float* m_s = dq_s + (size_t)NP * D;
  float* inv_s = m_s + NP;
  float* r_s = inv_s + NP;

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const size_t tok = (size_t)b * N * E + h * D;
  const size_t pair = (size_t)(b * a.H + h) * N * N;
  const size_t st_base = (size_t)(b * a.H + h) * N;
  const bool vec = (N & 7) == 0, has_g = a.gout != nullptr, has_gl = a.glog != nullptr;
  const uint32_t key = kDrop ? dropout_key(a.drop, b, h) : 0u;
  const bf16 neg_inf = __float2bfloat16(-INFINITY), zero = __float2bfloat16(0.f);

  // Stage s = kt * T + qt (query tiles fastest) into buffer `par`: its Q,
  // g_out, K and V tiles and its logits and g_logits tiles.  An absent
  // cotangent is never read; without g_out nothing reads V either.
  auto buf = [&](int par) { return stage_s + par * kPairBwdStage<D>; };
  auto load_stage = [&](int s, int par) {
    const int kt = s / T, qt = s - kt * T;
    bf16* bs = buf(par);
    load_tile_async<D>(bs, a.q + tok, qt * kMmaTile, N, E);
    if (has_g) load_tile_async<D>(bs + G::kTile, a.gout + tok, qt * kMmaTile, N, E);
    load_tile_async<D>(bs + 2 * G::kTile, a.k + tok, kt * kMmaTile, N, E);
    if (has_g) load_tile_async<D>(bs + 3 * G::kTile, a.v + tok, kt * kMmaTile, N, E);
    bf16* ps = bs + 4 * G::kTile;
    load_pair_tile(ps, a.logits + pair, qt * kMmaTile, kt * kMmaTile, N, vec, neg_inf);
    if (has_gl)
      load_pair_tile(ps + kPairTile, a.glog + pair, qt * kMmaTile, kt * kMmaTile, N, vec, zero);
  };

  for (int par = 0; par < (stages > 1 ? 2 : 1); ++par) zero_tile_padding<D>(buf(par), 4);
  load_stage(0, 0);
  cp_async_commit();
  // the forward's stats and r = rowsum(g_out * out) in fp32 per query row;
  // rows past N get inv = 0 and add nothing
  for (int i = threadIdx.x; i < NP; i += kMmaThreads) {
    float m = 0.f, inv = 0.f, r = 0.f;
    if (i < N) {
      const float2 st = *reinterpret_cast<const float2*>(a.stats + (st_base + i) * 2);
      m = st.x;
      inv = st.y;
      if (has_g) {
        const bf16* orow = a.out + tok + (size_t)i * E;
        const bf16* grow = a.gout + tok + (size_t)i * E;
#pragma unroll
        for (int c = 0; c < D; c += 2) {
          const float2 ov = ld_bf16x2(orow + c), gv = ld_bf16x2(grow + c);
          r = fmaf(ov.x, gv.x, fmaf(ov.y, gv.y, r));
        }
      }
    }
    m_s[i] = m;
    inv_s[i] = inv;
    r_s[i] = r;
  }
  for (int i = threadIdx.x; i < NP * D; i += kMmaThreads) dq_s[i] = 0.f;

  const int lr[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};  // tile rows
  float dka[D / 8][4], dva[D / 8][4];  // this warp's 16 keys of the current key tile

#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    const int kt = s / T, qt = s - kt * T, par = s & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage s landed; stage s - 1 is done with buffer par ^ 1
    if (s + 1 < stages) load_stage(s + 1, par ^ 1);
    cp_async_commit();
    if (qt == 0) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int x = 0; x < 4; ++x) dka[dt][x] = dva[dt][x] = 0.f;
    }
    const bf16* qs = buf(par);
    const bf16* gs = qs + G::kTile;
    const bf16* ks = qs + 2 * G::kTile;
    const bf16* vs = qs + 3 * G::kTile;
    bf16* ls = const_cast<bf16*>(qs) + 4 * G::kTile;
    bf16* gls = ls + kPairTile;
    const int rows[2] = {qt * kMmaTile + lr[0], qt * kMmaTile + lr[1]};
    float ml2[2], inv[2], rr[2], dqa[D / 8][4];  // ml2: the row max times log2 e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ml2[r] = m_s[rows[r]] * kLog2e;
      inv[r] = inv_s[rows[r]];
      rr[r] = r_s[rows[r]];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float2 d = *reinterpret_cast<const float2*>(dq_s + rows[r] * D + dt * 8 + 2 * t);
        dqa[dt][2 * r] = d.x;
        dqa[dt][2 * r + 1] = d.y;
      }
    }

    // this warp's 16 query rows: dL into the logits tile, keep P c into
    // the g_logits tile, dq += dL K (the running sum kept in shared memory
    // by the lane that owns it)
    // work wholly past N (a warp's rows, a step's keys) is skipped: those
    // logits tile entries stay 0 (rows) or -inf (keys), and nothing of them
    // is stored
    const bool rows_in = qt * kMmaTile + warp * 16 < N;
#pragma unroll
    for (int sub = 0; sub < kMmaTile; sub += kPairStep) {
      if (!rows_in || kt * kMmaTile + sub >= N) continue;
      float dp[NT][4] = {};
      if (has_g) {
        uint32_t gf[G::DP / 16][4];
        load_a_rows<D>(gf, gs, warp * 16);
        mma_abt<D, NT>(dp, gf, vs, sub);
      }
      float dl[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int cell = lr[r] * kPairS + sub + n * 8 + 2 * t;
          const float2 l = ld_bf16x2(ls + cell);
          const float2 gl = has_gl ? ld_bf16x2(gls + cell) : make_float2(0.f, 0.f);
          float pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = kt * kMmaTile + sub + n * 8 + 2 * t + e, x = 2 * r + e;
            // 0 past N (the logit is -inf there) and in rows past N (inv = 0)
            const float p = ex2_ftz(fmaf(e ? l.y : l.x, kLog2e, -ml2[r])) * inv[r];
            float dpe = dp[n][x];
            pd[e] = p;
            if constexpr (kDrop) {
              const bool kept = dropout_keep(key, (uint32_t)rows[r] * (uint32_t)N + (uint32_t)j,
                                             a.drop.threshold);
              dpe = kept ? dpe * a.drop.scale : 0.f;
              pd[e] = kept ? p * a.drop.scale : 0.f;
            }
            dl[n][x] = fmaf(p, dpe - rr[r], e ? gl.y : gl.x);
          }
          st_bf16x2(ls + cell, dl[n][2 * r], dl[n][2 * r + 1]);
          st_bf16x2(gls + cell, pd[0], pd[1]);
        }
      mma_xt<D, NT>(dqa, dl, ks, sub);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(dq_s + rows[r] * D + dt * 8 + 2 * t) =
            make_float2(dqa[dt][2 * r], dqa[dt][2 * r + 1]);
    __syncthreads();  // dL and keep P c are whole

    // this warp's 16 keys of the tile: dk += dL^T Q, dv += (keep P c)^T g_out
#pragma unroll
    for (int kk = 0; kk < kMmaTile; kk += 16) {
      if (kt * kMmaTile + warp * 16 >= N || qt * kMmaTile + kk >= N) continue;
      uint32_t af[4];
      load_a_t<kPairS>(af, ls, warp * 16, kk);
      mma_at<D>(dka, af, qs, kk);
      if (has_g) {
        load_a_t<kPairS>(af, gls, warp * 16, kk);
        mma_at<D>(dva, af, gs, kk);
      }
    }
    store_pair_tile(a.dbias + pair, ls, qt * kMmaTile, kt * kMmaTile, N, vec);
    if (qt == T - 1) {  // the key tile's sums over every query tile, written once
      const int keys[2] = {kt * kMmaTile + lr[0], kt * kMmaTile + lr[1]};
      const float sk[2] = {a.scale, a.scale}, sv[2] = {1.f, 1.f};
      store_rows<D>(a.dk + tok, E, dka, keys, N, sk);
      store_rows<D>(a.dv + tok, E, dva, keys, N, sv);
    }
  }

  __syncthreads();  // every lane's dq sums are in shared memory
  for (int idx = threadIdx.x; idx < N * (D / 2); idx += kMmaThreads) {
    const int i = idx / (D / 2), c = 2 * (idx - i * (D / 2));
    st_bf16x2(a.dq + tok + (size_t)i * E + c, dq_s[i * D + c] * a.scale,
              dq_s[i * D + c + 1] * a.scale);
  }
}

template <int D, bool kDrop>
cudaError_t launch_pair_mma_fwd(const PairMmaArgs& a, int B, cudaStream_t stream) {
  const size_t smem = pair_fwd_smem_bytes<D>(a.N);
  static bool ready = false;  // sized for two buffers, the most the kernel takes
  cudaError_t e =
      allow_smem(pair_mma_fwd_kernel<D, kDrop>, pair_fwd_smem_bytes<D>(2 * kMmaTile), ready);
  if (e != cudaSuccess) return e;
  pair_mma_fwd_kernel<D, kDrop><<<dim3((a.N + kMmaTile - 1) / kMmaTile, a.H, B), kMmaThreads,
                                  smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kDrop>
cudaError_t launch_pair_mma_bwd(const PairMmaArgs& a, int B, cudaStream_t stream) {
  const size_t smem = pair_bwd_smem_bytes<D>(a.N);
  static size_t allowed = 0;  // the dynamic shared memory limit set so far
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(pair_mma_bwd_kernel<D, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  pair_mma_bwd_kernel<D, kDrop><<<dim3(a.H, B), kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mmdti

// ---- bf16 route -------------------------------------------------------------

// q/k/v/out [B, N, H*D] and bias/logits [B, H, N, N] bf16, 16-byte aligned;
// stats [B, H, N, 2] fp32 (written); seed: one int32 on the device, or null
// for no dropout.  Returns a cudaError_t.
extern "C" int mmdti_pair_bias_attention_mma_fwd(const void* q, const void* k, const void* v,
                                                 const void* bias, void* out, void* logits,
                                                 void* stats, const void* seed,
                                                 unsigned int threshold,
                                                 float drop_scale, int drop_h0, int drop_heads,
                                                 int B, int N, int H, int D, void* stream) {
  using namespace mmdti;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  PairMmaArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  a.logits = static_cast<bf16*>(logits);
  a.stats = static_cast<float*>(stats);
  a.drop = DropoutArgs{static_cast<const int*>(seed), threshold, drop_scale,
                         drop_h0, drop_heads};
  a.N = N;
  a.H = H;
  a.scale = 1.0f / sqrtf((float)D);
  return (int)dispatch_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return seed ? launch_pair_mma_fwd<kD, true>(a, B, st)
                : launch_pair_mma_fwd<kD, false>(a, B, st);
  });
}

// The forward's q, k, v, logits, out and stats; g_out [B, N, H*D] and
// g_logits [B, H, N, N] bf16, each may be null; dq/dk/dv [B, N, H*D] and
// dbias [B, H, N, N] bf16 (written).  The kernel's shared memory,
// pair_bwd_smem_bytes<D>(N), must fit in the 227 KB a block can have.
// Returns a cudaError_t.
extern "C" int mmdti_pair_bias_attention_mma_bwd(const void* q, const void* k, const void* v,
                                                 const void* logits, const void* out,
                                                 const void* stats, const void* gout,
                                                 const void* glog, void* dq, void* dk, void* dv,
                                                 void* dbias, const void* seed,
                                                 unsigned int threshold,
                                                 float drop_scale, int drop_h0, int drop_heads,
                                                 int B, int N, int H, int D, void* stream) {
  using namespace mmdti;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  PairMmaArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.logits = static_cast<bf16*>(const_cast<void*>(logits));
  a.out = static_cast<bf16*>(const_cast<void*>(out));
  a.stats = static_cast<float*>(const_cast<void*>(stats));
  a.gout = static_cast<const bf16*>(gout);
  a.glog = static_cast<const bf16*>(glog);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dbias = static_cast<bf16*>(dbias);
  a.drop = DropoutArgs{static_cast<const int*>(seed), threshold, drop_scale,
                         drop_h0, drop_heads};
  a.N = N;
  a.H = H;
  a.scale = 1.0f / sqrtf((float)D);
  return (int)dispatch_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return seed ? launch_pair_mma_bwd<kD, true>(a, B, st)
                : launch_pair_mma_bwd<kD, false>(a, B, st);
  });
}

// ---- fp32 route (row kernels; also takes bf16 q/k/v or a bf16 pair) ---------

// q/k/v/out [B, N, H*D] (bf16 if qkv_bf16 else fp32); bias/logits
// [B, H, N, N] (bf16 if pair_bf16 else fp32); seed: one int32 on the device,
// or null for no dropout.  Returns a cudaError_t.
extern "C" int mmdti_pair_bias_attention_fwd(const void* q, const void* k, const void* v,
                                             const void* bias, void* out, void* logits,
                                             const void* seed, unsigned int threshold,
                                             float drop_scale, int drop_h0, int drop_heads,
                                             int B, int N, int H, int D,
                                             int qkv_bf16, int pair_bf16, void* stream) {
  using namespace mmdti;
  const float scale = 1.0f / sqrtf((float)D);
  const DropoutArgs drop{static_cast<const int*>(seed), threshold, drop_scale,
                         drop_h0, drop_heads};
  auto run = [&](auto t, auto d) -> cudaError_t {
    using T = decltype(t);
    constexpr int kD = decltype(d)::value;
    if (pair_bf16) {
      PairBiasEpilogue<__nv_bfloat16> epi{static_cast<const __nv_bfloat16*>(bias),
                                          static_cast<__nv_bfloat16*>(logits), H, N};
      return launch_attention_rows<T, kD>(q, k, v, out, epi, drop, B, N, N, H, scale,
                                          static_cast<cudaStream_t>(stream));
    }
    PairBiasEpilogue<float> epi{static_cast<const float*>(bias),
                                static_cast<float*>(logits), H, N};
    return launch_attention_rows<T, kD>(q, k, v, out, epi, drop, B, N, N, H, scale,
                                        static_cast<cudaStream_t>(stream));
  };
  return (int)dispatch_type_dim(qkv_bf16, D, run);
}

// q/k/v, g_out, dq/dk/dv [B, N, H*D] (qkv dtype); logits, g_logits, dbias
// [B, H, N, N] (pair dtype); g_out and g_logits may be null.  stats is an
// fp32 workspace of B*H*N*3 floats.  seed/threshold/drop_scale as the
// forward's.  Returns a cudaError_t.
extern "C" int mmdti_pair_bias_attention_bwd(const void* q, const void* k, const void* v,
                                             const void* logits, const void* gout,
                                             const void* glog, void* dq, void* dk, void* dv,
                                             void* dbias, void* stats, const void* seed,
                                             unsigned int threshold,
                                             float drop_scale, int drop_h0, int drop_heads, int B,
                                             int N, int H, int D, int qkv_bf16, int pair_bf16,
                                             void* stream) {
  using namespace mmdti;
  const DropoutArgs drop{static_cast<const int*>(seed), threshold, drop_scale,
                         drop_h0, drop_heads};
  auto run = [&](auto t, auto d) -> cudaError_t {
    using T = decltype(t);
    constexpr int kD = decltype(d)::value;
    auto go = [&](auto p) -> cudaError_t {
      using P = decltype(p);
      AttentionBwdArgs<T, P> a{static_cast<const T*>(q), static_cast<const T*>(k),
                               static_cast<const T*>(v), static_cast<const T*>(gout),
                               static_cast<const P*>(logits), static_cast<const P*>(glog),
                               nullptr, static_cast<T*>(dq), static_cast<T*>(dk),
                               static_cast<T*>(dv), static_cast<P*>(dbias),
                               static_cast<float*>(stats), drop, N, N, H,
                               1.0f / sqrtf((float)kD)};
      return launch_attention_bwd<T, P, kD, true>(a, B, static_cast<cudaStream_t>(stream));
    };
    return pair_bf16 ? go(__nv_bfloat16{}) : go(float{});
  };
  return (int)dispatch_type_dim(qkv_bf16, D, run);
}

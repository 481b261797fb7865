// Fused LayerNorm forward and backward (Hopper, sm_90a).
//
// Replaces the TPU kernels mmdti_tpu/ops/pallas_ln.py::_fwd_kernel (reached
// through _layer_norm_fwd's pl.pallas_call) and ::_bwd_kernel (through
// _layer_norm_bwd).  Per row of x [T, E], in fp32 from the fp32 cast of x:
//
//     mu = mean(x), var = max(mean(x^2) - mu^2, 0), rstd = rsqrt(var + eps)
//     y  = (x - mu) * (rstd * scale) + bias                     (y's dtype)
//     dx = (w*gy - xhat * mean(w*gy*xhat) - mean(w*gy)) * rstd  (x's dtype)
//     dscale = sum over rows of gy*xhat, dbias = sum of gy      (fp32)
//
// Neither mu nor rstd reaches device memory: the forward saves only x and
// scale, and the backward recomputes them.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once (forward: x in, y out; backward: x and gy in, dx out) for about ten
// FLOP.  bf16, E=512: the forward moves 4.2 MB at [2048, 512] (1.25 us at
// 3.35 TB/s) and 18.4 MB at [8960, 512] (5.48 us); the backward 6.3 MB
// (1.88 us) and 27.5 MB (8.22 us).  At [2048, 512] a launch's fixed cost is
// most of the pass, so the design cuts serial latency and launches:
//
// * Persistent blocks.  The grid is sized to the card (resident blocks, from
//   the occupancy query, which the wrapper makes once per width and dtypes;
//   the forward takes at most 2 blocks a SM) and each warp walks rows row0,
//   row0 + grid*8, ...  A warp keeps a ring of kStages rows in shared
//   memory: the rows after the current one are already in flight (16-byte
//   cp.async, each lane copying the 16-byte runs it reads itself, so no
//   barrier guards the ring) while it normalises the current row.
// * scale and bias are staged once per block in shared memory with
//   coalesced 4-byte loads (a parameter may be a view at any float offset
//   into the optimizer's flat buffer) and read back as 16-byte loads.
// * The backward is one launch, deterministic, with no float atomics.  Each
//   warp keeps its columns' dscale/dbias sums in registers over its rows;
//   the block's 8 warp rows combine in a fixed tree through shared memory
//   (3 steps: w += w+4, w += w+2, w += w+1, one thread a column, one
//   barrier).  Rank q of a cluster of kCluster blocks owns slice q of the
//   2E columns: every block pushes its row's slices into the owners'
//   shared memory (distributed shared memory), one cluster barrier, and
//   each owner adds the 8 rows of its slice in rank order into the
//   cluster's row.  An integer ticket per rank finds the last block of
//   that rank to finish, which adds its slice of the cluster rows in
//   cluster order into dscale/dbias and sets the ticket back to 0 (so a
//   replayed launch, as in a CUDA graph, starts from 0 too).  The
//   cluster rows cost 8E bytes a cluster, written and read once: 2 % of the
//   function's bytes at [2048, 512] with the wrapper's grid (16 clusters).
//   Repeated calls give bit-equal results: the grid, and with it every
//   row's warp and every sum's order, depends only on T and the card.
//
// The forward's and the backward's statistics are the same bits: both
// kernels read a row through the same ring layout into the same registers
// (lane l holds the 8-element chunks l, l+32, ... of its row), and call the
// one row_stats, written with explicit round-to-nearest intrinsics so that
// the compiler cannot contract its adds and multiplies differently in the
// two kernels; the butterfly sums give every lane the same bits.
//
// Limits: E % 8 == 0 and E <= 1024; any T >= 1 (rows past T are skipped);
// x, y, gy and dx 16-byte aligned, scale and bias only 4-byte aligned.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace mmdti_ln {

using mmdti::cp_async16;
using mmdti::cp_async_commit;
using mmdti::cp_async_wait;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxE = 1024;
constexpr int kStages = 3;     // ring rows per warp: the current one and two in flight
constexpr int kCluster = 8;    // blocks of a backward cluster
constexpr int kMaxSmemBytes = 227 * 1024;
// forward blocks a SM at most: each warp then walks 3 rows at [8960, 512]
// with two in flight, 6.90 us against 7.67 at the 6 blocks a SM that fit
// (scripts/ln_variants.py, H100 80GB HBM3, 700 W)
constexpr int kFwdBlocksPerSm = 2;

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
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

__device__ __forceinline__ int chunk_col(int lane, int c) { return (lane + 32 * c) * 8; }

// Starts copying the lane's chunks of one row into a ring slot (nothing
// when the row is past the end).
template <typename T, int kC>
__device__ __forceinline__ void issue_row(T* slot, const T* row, int lane, int E, bool valid) {
  constexpr int kRun = 16 / sizeof(T);  // elements per 16-byte copy
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = chunk_col(lane, c);
    if (valid && col < E) {
#pragma unroll
      for (int p = 0; p < 8; p += kRun) cp_async16(slot + col + p, row + col + p, true);
    }
  }
}

// The lane's chunks of a row in fp32 (zeros past E).
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

// mean and rstd of one row, the fast variance of the TPU kernel; both
// kernels call this one function on the same registers
template <int kC>
__device__ __forceinline__ void row_stats(const float (&v)[kC][8], int E, float eps, float& mu,
                                          float& rstd) {
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s = __fadd_rn(s, v[c][i]);
      s2 = __fadd_rn(s2, __fmul_rn(v[c][i], v[c][i]));
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float n = (float)E;
  mu = __fdiv_rn(s, n);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mu, mu)), 0.0f);
  rstd = rsqrtf(__fadd_rn(var, eps));
}

// Coalesced 4-byte loads of a parameter at any float offset into shared memory.
__device__ __forceinline__ void stage_param(const float* __restrict__ p, float* s, int E) {
  for (int j = threadIdx.x; j < E; j += kThreads) s[j] = __ldg(p + j);
}

// Shared memory, with kW = 256 * kC (the widest E of the instantiation):
//   forward:  scale [kW], bias [kW] fp32, then per warp kStages x rows
//             [kW] of x
//   backward: scale [kW] fp32, the inbox [kCluster][2E / kCluster] fp32
//             (the cluster's block rows, for this rank's slice), then per
//             warp kStages x (x [kW], gy [kW]); after the row loop the ring
//             holds the warps' partial rows [kWarps][2E] fp32 (dscale then
//             dbias)
template <typename Tx, typename Ty, int kC>
struct Smem {
  static constexpr int kW = 256 * kC;
  static constexpr size_t kFwd = 2 * kW * sizeof(float) + kWarps * kStages * kW * sizeof(Tx);
  static constexpr size_t kSlot = kW * (sizeof(Tx) + sizeof(Ty));
  static constexpr size_t kBwd = 3 * kW * sizeof(float) + kWarps * kStages * kSlot;
  static_assert(kWarps * 2 * kW * sizeof(float) <= kWarps * kStages * kSlot,
                "the warps' partial rows must fit in the ring they replace");
  static_assert(kBwd <= kMaxSmemBytes, "backward ring too large");
};

template <typename Tx, typename Ty, int kC>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd_kernel(const Tx* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, Ty* __restrict__ y, int T, int E,
                          float eps) {
  constexpr int kW = Smem<Tx, Ty, kC>::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_scale = reinterpret_cast<float*>(smem);
  float* s_bias = s_scale + kW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Tx* ring = reinterpret_cast<Tx*>(s_bias + kW) + warp * kStages * kW;
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int r = row + s * stride;
    issue_row<Tx, kC>(ring + s * kW, x + (size_t)r * E, lane, E, r < T);
    cp_async_commit();
  }
  stage_param(scale, s_scale, E);
  stage_param(bias, s_bias, E);
  __syncthreads();
  int cur = 0;   // ring slot of `row`
  for (; row < T; row += stride) {
    const int ahead = row + (kStages - 1) * stride;
    const int next = cur == 0 ? kStages - 1 : cur - 1;   // (cur + kStages - 1) % kStages
    issue_row<Tx, kC>(ring + next * kW, x + (size_t)ahead * E, lane, E, ahead < T);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    float v[kC][8];
    load_row<Tx, kC>(ring + cur * kW, lane, E, v);
    float mu, rstd;
    row_stats<kC>(v, E, eps, mu, rstd);
    Ty* yr = y + (size_t)row * E;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = chunk_col(lane, c);
      if (col >= E) continue;
      float g[8], b[8], o[8];
      load8(s_scale + col, g);
      load8(s_bias + col, b);
      // rounded op by op as the plain version is (no fused multiply-add)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[c][i], mu), __fmul_rn(rstd, g[i])), b[i]);
      store8(yr + col, o);
    }
    cur = cur == kStages - 1 ? 0 : cur + 1;
  }
  cp_async_wait<0>();
}

// grads [2E] fp32: dscale then dbias.  cluster_rows [gridDim.x / kCluster,
// 2E] fp32 scratch; ticket: kCluster unsigned ints (one a rank, counting
// that rank's blocks) that are 0 at the launch and 0 again after it.
// gridDim.x is a multiple of kCluster.
template <typename Tx, typename Ty, int kC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    layer_norm_bwd_kernel(const Tx* __restrict__ x, const float* __restrict__ scale,
                          const Ty* __restrict__ gy, Tx* __restrict__ dx,
                          float* __restrict__ grads, float* __restrict__ cluster_rows,
                          unsigned int* __restrict__ ticket, int T, int E, float eps) {
  using S = Smem<Tx, Ty, kC>;
  constexpr int kW = S::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  float* s_scale = reinterpret_cast<float*>(smem);
  float* inbox = s_scale + kW;
  unsigned char* ring0 = smem + 3 * kW * sizeof(float);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* ring = ring0 + (size_t)warp * kStages * S::kSlot;
  auto slot_x = [&](int s) { return reinterpret_cast<Tx*>(ring + s * S::kSlot); };
  auto slot_g = [&](int s) {
    return reinterpret_cast<Ty*>(ring + s * S::kSlot + kW * sizeof(Tx));
  };
  auto issue = [&](int s, int r) {
    issue_row<Tx, kC>(slot_x(s), x + (size_t)r * E, lane, E, r < T);
    issue_row<Ty, kC>(slot_g(s), gy + (size_t)r * E, lane, E, r < T);
    cp_async_commit();
  };

  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s, row + s * stride);
  // a block may write into a peer's shared memory only once the peer has
  // started: arrive here, wait before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  stage_param(scale, s_scale, E);
  __syncthreads();

  float acc_g[kC][8], acc_b[kC][8];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_g[c][i] = acc_b[c][i] = 0.0f;
  }
  int cur = 0;
  for (; row < T; row += stride) {
    issue(cur == 0 ? kStages - 1 : cur - 1, row + (kStages - 1) * stride);
    cp_async_wait<kStages - 1>();
    float v[kC][8], g[kC][8];
    load_row<Tx, kC>(slot_x(cur), lane, E, v);
    load_row<Ty, kC>(slot_g(cur), lane, E, g);
    float mu, rstd;
    row_stats<kC>(v, E, eps, mu, rstd);
    float s1 = 0.0f, s0 = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = chunk_col(lane, c);
      float w[8];
      if (col < E) {
        load8(s_scale + col, w);
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
    cur = cur == kStages - 1 ? 0 : cur + 1;
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring

  // the warps' rows [kWarps][2E] over the ring; the block's row in a fixed
  // tree, one thread a column (w += w+4, w += w+2, w += w+1), pushed to the
  // inbox of the rank that owns the column's slice, at this block's rank
  const int width = 2 * E;
  const int slice = width / kCluster;
  float* part = reinterpret_cast<float*>(ring0);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = chunk_col(lane, c);
    if (col >= E) continue;
    store8(part + warp * width + col, acc_g[c]);
    store8(part + warp * width + E + col, acc_b[c]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every peer has started
  for (int j = threadIdx.x; j < width; j += kThreads) {
    float p[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) p[w] = part[w * width + j];
#pragma unroll
    for (int half = kWarps / 2; half > 0; half >>= 1) {
#pragma unroll
      for (int w = 0; w < half; ++w) p[w] += p[w + half];
    }
    const int owner = j / slice;
    *cluster.map_shared_rank(inbox + rank * slice + (j - owner * slice), owner) = p[0];
  }
  // after this barrier no block touches another's shared memory
  cluster.sync();

  // this rank's slice of the cluster's row: the blocks' rows in rank order
  float* out_row = cluster_rows + (size_t)(blockIdx.x / kCluster) * width + rank * slice;
  for (int j = threadIdx.x; j < slice; j += kThreads) {
    float s = inbox[j];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) s += inbox[q * slice + j];
    out_row[j] = s;
  }

  // Thread 0 takes a ticket of this rank once the block's slice is out (its
  // fence releases what the barrier showed it).  The last block of a rank
  // to take one sets that ticket back to 0 (so a replayed launch, as in a
  // CUDA graph, starts from 0 too) and adds the slice's cluster rows in
  // cluster order into grads.
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int nclusters = gridDim.x / kCluster;
    __threadfence();
    s_last = atomicAdd(ticket + rank, 1u) == nclusters - 1;
    if (s_last) {
      atomicExch(ticket + rank, 0u);   // every other block of this rank has taken its ticket
      __threadfence();
    }
  }
  __syncthreads();
  if (!s_last) return;
  const int nclusters = gridDim.x / kCluster;
  const float* rows = cluster_rows + rank * slice;
  for (int j = threadIdx.x; j < slice; j += kThreads) {
    constexpr int kBatch = 16;   // loads in flight a thread: 16 clusters at [2048, 512]
    float sum = 0.0f;
    int k = 0;
    for (; k + kBatch <= nclusters; k += kBatch) {
      float t[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) t[i] = __ldcg(rows + (size_t)(k + i) * width + j);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) sum += t[i];
    }
    for (; k < nclusters; ++k) sum += __ldcg(rows + (size_t)k * width + j);
    grads[rank * slice + j] = sum;
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

// Blocks of one launch that the card runs at once: SMs x blocks per SM (at
// most kFwdBlocksPerSm) for the forward, active clusters x kCluster for the
// backward.  Also raises
// the kernel's dynamic shared-memory limit, so call it once per device and
// configuration before the first launch.
extern "C" int mmdti_layer_norm_resident(int backward, int E, int x_bf16, int y_bf16,
                                         int* blocks) {
  using namespace mmdti_ln;
  auto run = [&](auto tx, auto ty, auto kc) -> cudaError_t {
    using Tx = decltype(tx);
    using Ty = decltype(ty);
    constexpr int kC = decltype(kc)::value;
    using S = Smem<Tx, Ty, kC>;
    cudaError_t e;
    if (backward) {
      auto kernel = layer_norm_bwd_kernel<Tx, Ty, kC>;
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBwd);
      if (e != cudaSuccess) return e;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(kCluster);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = S::kBwd;
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters == 0) return cudaErrorInvalidConfiguration;
      *blocks = clusters * kCluster;
      return cudaSuccess;
    }
    auto kernel = layer_norm_fwd_kernel<Tx, Ty, kC>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kFwd);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, S::kFwd);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    *blocks = sms * (per_sm < kFwdBlocksPerSm ? per_sm : kFwdBlocksPerSm);
    return cudaSuccess;
  };
  return (int)dispatch(x_bf16, y_bf16, E, run);
}

// x/y [T, E] (bf16 if x_bf16 / y_bf16, else fp32), scale/bias [E] fp32;
// grid blocks (the wrapper's forward_grid).  Returns a cudaError_t.
extern "C" int mmdti_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                    int T, int E, float eps, int x_bf16, int y_bf16, int grid,
                                    void* stream) {
  using namespace mmdti_ln;
  if (T <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  auto run = [&](auto tx, auto ty, auto kc) -> cudaError_t {
    using Tx = decltype(tx);
    using Ty = decltype(ty);
    constexpr int kC = decltype(kc)::value;
    layer_norm_fwd_kernel<Tx, Ty, kC>
        <<<grid, kThreads, Smem<Tx, Ty, kC>::kFwd, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const Tx*>(x), static_cast<const float*>(scale),
            static_cast<const float*>(bias), static_cast<Ty*>(y), T, E, eps);
    return cudaGetLastError();
  };
  return (int)dispatch(x_bf16, y_bf16, E, run);
}

// x/dx [T, E] in x's dtype, gy [T, E] in y's dtype, scale [E] fp32; grads
// [2E] fp32 (dscale, dbias); cluster_rows [grid / 8, 2E] fp32 scratch and
// ticket (8 unsigned ints, 0 between launches) reused across calls on one
// stream; grid a multiple of 8 (the wrapper's backward_grid).
extern "C" int mmdti_layer_norm_bwd(const void* x, const void* scale, const void* gy, void* dx,
                                    void* grads, void* cluster_rows, void* ticket, int T, int E,
                                    float eps, int x_bf16, int y_bf16, int grid, void* stream) {
  using namespace mmdti_ln;
  if (T <= 0 || grid <= 0 || grid % kCluster) return (int)cudaErrorInvalidValue;
  auto run = [&](auto tx, auto ty, auto kc) -> cudaError_t {
    using Tx = decltype(tx);
    using Ty = decltype(ty);
    constexpr int kC = decltype(kc)::value;
    layer_norm_bwd_kernel<Tx, Ty, kC>
        <<<grid, kThreads, Smem<Tx, Ty, kC>::kBwd, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const Tx*>(x), static_cast<const float*>(scale),
            static_cast<const Ty*>(gy), static_cast<Tx*>(dx), static_cast<float*>(grads),
            static_cast<float*>(cluster_rows), static_cast<unsigned int*>(ticket), T, E, eps);
    return cudaGetLastError();
  };
  return (int)dispatch(x_bf16, y_bf16, E, run);
}

// Pair-bias self-attention forward and backward for the Uni-Mol encoder
// (Hopper, sm_90a).
//
// Forward: replaces the TPU kernel
// mmdti_tpu/ops/pallas_attention.py::_fwd_kernel (reached through _run_fwd's
// pl.pallas_call).  Per (b, h):
//
//     logits = (q * D^-1/2) k^T + bias      fp32; bias carries -inf at pad keys
//     out    = dropout(softmax(logits)) v   (guarded softmax, see the .cuh)
//
// and the pre-dropout logits are stored in the pair dtype as the next
// layer's bias.
//
// Backward: replaces _bwd_kernel (reached through _bwd_rule).  It reads the
// stored logits back, replays the dropout mask (dropout.cuh) and returns dq,
// dk, dv and dbias = dL (attention_bwd.cuh): a row launch for dq/dbias and a
// key-column launch for dk/dv, deterministic, with no atomics.
//
// What bounds it on the H100: with H=64 heads of D=8 the products are tiny
// (2*N*D FLOP per score) and both passes live on the [B,H,N,N] tensors.  The
// forward reads bias and writes logits, 2 bytes each per score in bf16 —
// 0.64 GB per layer at B=32, N=280.  The backward must read logits and
// g_logits and write dbias (6 bytes a score, 0.96 GB); this first version
// reads logits and g_logits a second time in the key-column launch (10 bytes
// a score).  All pair tensors are streamed coalesced along the key axis.
#include "attention_bwd.cuh"
#include "attention_rows.cuh"

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

}  // namespace mmdti

// q/k/v/out [B, N, H*D] (bf16 if qkv_bf16 else fp32); bias/logits
// [B, H, N, N] (bf16 if pair_bf16 else fp32); seed: one int32 on the device,
// or null for no dropout.  Returns a cudaError_t.
extern "C" int mmdti_pair_bias_attention_fwd(const void* q, const void* k, const void* v,
                                             const void* bias, void* out, void* logits,
                                             const void* seed, unsigned int threshold,
                                             float drop_scale, int B, int N, int H, int D,
                                             int qkv_bf16, int pair_bf16, void* stream) {
  using namespace mmdti;
  const float scale = 1.0f / sqrtf((float)D);
  const DropoutArgs drop{static_cast<const int*>(seed), threshold, drop_scale};
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
                                             unsigned int threshold, float drop_scale, int B,
                                             int N, int H, int D, int qkv_bf16, int pair_bf16,
                                             void* stream) {
  using namespace mmdti;
  const DropoutArgs drop{static_cast<const int*>(seed), threshold, drop_scale};
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

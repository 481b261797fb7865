// Pair-bias self-attention forward for the Uni-Mol encoder (Hopper, sm_90a).
//
// Replaces the TPU kernel mmdti_tpu/ops/pallas_attention.py::_fwd_kernel
// (reached through _run_fwd's pl.pallas_call).  Per (b, h):
//
//     logits = (q * D^-1/2) k^T + bias      fp32; bias carries -inf at pad keys
//     out    = softmax(logits) v            (guarded softmax, see the .cuh)
//
// and the logits are stored in the pair dtype as the next layer's bias.
// Deterministic only: the attention dropout of training comes with the
// backward kernel.
//
// What bounds it on the H100: with H=64 heads of D=8 the products are tiny
// (2*N*D FLOP per score) and the kernel lives on the [B,H,N,N] bias read and
// logits write, 2 bytes each per score in bf16 — 0.64 GB per layer at B=32,
// N=280.  Both are streamed once, coalesced along the key axis, and the
// softmax row stays in shared memory; K/V for the (b, h) pair are restaged
// per 32-row block from L2.
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
// [B, H, N, N] (bf16 if pair_bf16 else fp32).  Returns a cudaError_t.
extern "C" int mmdti_pair_bias_attention_fwd(const void* q, const void* k, const void* v,
                                             const void* bias, void* out, void* logits,
                                             int B, int N, int H, int D, int qkv_bf16,
                                             int pair_bf16, void* stream) {
  using namespace mmdti;
  const float scale = 1.0f / sqrtf((float)D);
  auto run = [&](auto t, auto d) -> cudaError_t {
    using T = decltype(t);
    constexpr int kD = decltype(d)::value;
    if (pair_bf16) {
      PairBiasEpilogue<__nv_bfloat16> epi{static_cast<const __nv_bfloat16*>(bias),
                                          static_cast<__nv_bfloat16*>(logits), H, N};
      return launch_attention_rows<T, kD>(q, k, v, out, epi, B, N, N, H, scale,
                                          static_cast<cudaStream_t>(stream));
    }
    PairBiasEpilogue<float> epi{static_cast<const float*>(bias),
                                static_cast<float*>(logits), H, N};
    return launch_attention_rows<T, kD>(q, k, v, out, epi, B, N, N, H, scale,
                                        static_cast<cudaStream_t>(stream));
  };
  return (int)dispatch_type_dim(qkv_bf16, D, run);
}

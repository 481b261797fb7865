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
//
// Backward: replaces _masked_bwd_kernel (reached through _masked_bwd_rule).
// Nothing is stored between the passes: the logits are recomputed from q, k
// and the mask, the dropout mask is replayed (dropout.cuh), and dq, dk, dv
// come from a row launch and a key-column launch (attention_bwd.cuh),
// deterministic, with no atomics.  The mask gets no gradient.
//
// What bounds it on the H100: nothing of size [B,H,Nq,Nk] reaches device
// memory, so the bytes are q/k/v/out (and g_out, dq/dk/dv) only; the work is
// 4*Nq*Nk*D FLOP per (b, h) forward and about 10*Nq*Nk*D backward (the
// logits are recomputed in both backward launches), on the FMA units fed
// from shared memory.
#include "attention_bwd.cuh"
#include "attention_rows.cuh"

namespace mmdti {

struct KeyMaskEpilogue {
  const float* mask;
  int Nk;
  __device__ __forceinline__ float score(int b, int, int, int j, float acc) const {
    return acc + mask[(size_t)b * Nk + j];
  }
};

}  // namespace mmdti

// q/out [B, Nq, H*D], k/v [B, Nk, H*D] (bf16 if qkv_bf16 else fp32);
// mask [B, Nk] fp32; seed: one int32 on the device, or null for no dropout.
// Returns a cudaError_t.
extern "C" int mmdti_masked_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, const void* seed,
                                          unsigned int threshold, float drop_scale, int B,
                                          int Nq, int Nk, int H, int D, int qkv_bf16,
                                          void* stream) {
  using namespace mmdti;
  const float scale = 1.0f / sqrtf((float)D);
  const DropoutArgs drop{static_cast<const int*>(seed), threshold, drop_scale};
  KeyMaskEpilogue epi{static_cast<const float*>(mask), Nk};
  auto run = [&](auto t, auto d) -> cudaError_t {
    using T = decltype(t);
    constexpr int kD = decltype(d)::value;
    return launch_attention_rows<T, kD>(q, k, v, out, epi, drop, B, Nq, Nk, H, scale,
                                        static_cast<cudaStream_t>(stream));
  };
  return (int)dispatch_type_dim(qkv_bf16, D, run);
}

// q, g_out, dq [B, Nq, H*D]; k/v, dk/dv [B, Nk, H*D] (qkv dtype); mask
// [B, Nk] fp32; g_out may be null.  stats is an fp32 workspace of
// B*H*Nq*3 floats.  Returns a cudaError_t.
extern "C" int mmdti_masked_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* mask, const void* gout, void* dq,
                                          void* dk, void* dv, void* stats, const void* seed,
                                          unsigned int threshold, float drop_scale, int B,
                                          int Nq, int Nk, int H, int D, int qkv_bf16,
                                          void* stream) {
  using namespace mmdti;
  const DropoutArgs drop{static_cast<const int*>(seed), threshold, drop_scale};
  auto run = [&](auto t, auto d) -> cudaError_t {
    using T = decltype(t);
    constexpr int kD = decltype(d)::value;
    AttentionBwdArgs<T, float> a{static_cast<const T*>(q), static_cast<const T*>(k),
                                 static_cast<const T*>(v), static_cast<const T*>(gout),
                                 nullptr, nullptr, static_cast<const float*>(mask),
                                 static_cast<T*>(dq), static_cast<T*>(dk),
                                 static_cast<T*>(dv), nullptr, static_cast<float*>(stats),
                                 drop, Nq, Nk, H, 1.0f / sqrtf((float)kD)};
    return launch_attention_bwd<T, float, kD, false>(a, B, static_cast<cudaStream_t>(stream));
  };
  return (int)dispatch_type_dim(qkv_bf16, D, run);
}

// Masked (BERT-style) attention forward for ChemBERTa and the cross-modal
// layers (Hopper, sm_90a).
//
// Replaces the TPU kernel mmdti_tpu/ops/pallas_attention.py::_masked_fwd_kernel
// (reached through _masked_fwd_rule's pl.pallas_call).  Per (b, h):
//
//     out = softmax((q * D^-1/2) k^T + mask[b, key]) v
//
// with an additive per-key mask [B, Nk] fp32 (finfo(float32).min for
// ChemBERTa, -10000 for cross-modal).  The TPU wrapper broadcast the mask to
// [B, Nq, Nk] only to please its compiler; this kernel reads the [B, Nk] row.
// Nq != Nk is allowed (cross-modal: atoms <= 280 against SMILES <= 512).
// Deterministic only: attention dropout comes with the backward kernel.
//
// What bounds it on the H100: nothing of size [B,H,Nq,Nk] reaches device
// memory, so the bytes are q/k/v/out only; the work is 4*Nq*Nk*D FLOP per
// (b, h) on the FMA units, fed from shared memory, with K and V restaged from
// L2 once per 32-row block.
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
// mask [B, Nk] fp32.  Returns a cudaError_t.
extern "C" int mmdti_masked_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, int B, int Nq,
                                          int Nk, int H, int D, int qkv_bf16, void* stream) {
  using namespace mmdti;
  const float scale = 1.0f / sqrtf((float)D);
  KeyMaskEpilogue epi{static_cast<const float*>(mask), Nk};
  auto run = [&](auto t, auto d) -> cudaError_t {
    using T = decltype(t);
    constexpr int kD = decltype(d)::value;
    return launch_attention_rows<T, kD>(q, k, v, out, epi, B, Nq, Nk, H, scale,
                                        static_cast<cudaStream_t>(stream));
  };
  return (int)dispatch_type_dim(qkv_bf16, D, run);
}

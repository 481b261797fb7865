// Attention-dropout keep mask as a pure function of (seed, b, h, i, j).
//
// The TPU kernels seed the on-core PRNG per grid program
// (mmdti_tpu/ops/pallas_attention.py::_keep_mask), so their mask follows the
// tiling.  Here every score draws its own bits from a counter-based hash of
// its coordinates, so the forward kernels, the backward kernels that replay
// the mask, and the plain torch version (mmdti_tpu_torch/ops/dropout.py,
// which documents the hash) agree bit for bit whatever their tiling:
//
//   key  = fmix32(seed ^ fmix32(b*H + h + 0x9E3779B9))      once per (b, h)
//   keep = fmix32(key ^ fmix32(i*Nk + j + 0x7F4A7C15)) >= threshold
//
// A kept probability is scaled by `scale` = 1/(1 - rate); a dropped one is 0.
//
// Under tensor parallelism a launch holds heads h0 .. h0 + H - 1 of a layer
// with `heads` heads in all, and hashes b*heads + h0 + h for its local head
// h: the bits a one-process launch over every head draws for that head.
// With h0 = 0 and heads = H the hash is b*H + h.
#pragma once

#include <stdint.h>

namespace mmdti {

struct DropoutArgs {
  const int* seed;     // one int32 on the device; nullptr = no dropout
  uint32_t threshold;  // min(rate * 2^32, 2^32 - 1), computed by the caller
  float scale;         // 1 / (1 - rate)
  int h0;              // the launch's first head among the layer's
  int heads;           // the layer's heads in all (H_total)
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// the key of the launch's local head h of batch row b
__device__ __forceinline__ uint32_t dropout_key(const DropoutArgs& d, int b, int h) {
  const uint32_t bh = static_cast<uint32_t>(b) * static_cast<uint32_t>(d.heads) +
                      static_cast<uint32_t>(d.h0 + h);
  return fmix32(static_cast<uint32_t>(*d.seed) ^ fmix32(bh + 0x9E3779B9u));
}

__device__ __forceinline__ bool dropout_keep(uint32_t key, uint32_t ij, uint32_t threshold) {
  return fmix32(key ^ fmix32(ij + 0x7F4A7C15u)) >= threshold;
}

}  // namespace mmdti

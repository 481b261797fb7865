// Section marks of a train step: one null kernel per mark, each one thread
// that does no work, under an unmangled name (trace_mark_<mark>), so that a
// device trace names the point in the stream where each section of the
// step begins.  A mark launched while a CUDA graph is captured becomes a
// node of the graph, so every replay emits it on the device clock, in stream
// order; nothing runs on the host inside a replay.
//
// Replaces no TPU kernel: it exists because no host code runs inside a
// replayed graph, so nothing outside the stream can say which part of the
// model issued a kernel.  Each mark costs one launch and no memory traffic.
//
// mmdti_trace_mark(which, stream) launches mark ``which`` (its index in
// train/profiler.py MARKS, then the marks DOCKING_MARKS adds) on ``stream`` and returns the launch's
// cudaError_t; an index past the last mark returns cudaErrorInvalidValue.

#include <cuda_runtime.h>

#define MMDTI_MARKS(X) \
  X(step) X(unimol) X(smiles) X(head) X(head_bwd) X(smiles_bwd) X(unimol_bwd) \
  X(optimizer) X(end) X(pocket) X(decoder) X(dock_head) X(dock_head_bwd) \
  X(decoder_bwd) X(pocket_bwd)

#define MMDTI_DEFINE_MARK(name) extern "C" __global__ void trace_mark_##name() {}
MMDTI_MARKS(MMDTI_DEFINE_MARK)
#undef MMDTI_DEFINE_MARK

typedef void (*MarkKernel)();

#define MMDTI_MARK_ENTRY(name) trace_mark_##name,
static const MarkKernel kMarks[] = {MMDTI_MARKS(MMDTI_MARK_ENTRY)};
#undef MMDTI_MARK_ENTRY

extern "C" int mmdti_trace_mark(int which, void* stream) {
  if (which < 0 || which >= static_cast<int>(sizeof(kMarks) / sizeof(kMarks[0]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kMarks[which]),
                                           dim3(1), dim3(1), nullptr, 0,
                                           static_cast<cudaStream_t>(stream)));
}

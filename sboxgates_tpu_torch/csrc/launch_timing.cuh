// Timing events of one kernel launch.
//
// Each timed entry point takes a pair of CUDA events from its Python
// wrapper (telemetry/attribution.py, or two nulls when the launch is not
// timed) and records the first on the launch's stream immediately before
// the <<<>>> launch and the second immediately after it.  The pair then
// spans the kernel and the stream's start-up latency, not the host's path
// into the entry point (ctypes, argument checks, attribute queries).  An
// entry point with no work records the pair back to back, so the caller's
// events always hold this call's times.

#pragma once

#include <cuda_runtime.h>

inline cudaError_t sbgt_record(void* ev, cudaStream_t stream) {
  return ev ? cudaEventRecord((cudaEvent_t)ev, stream) : cudaSuccess;
}

inline int sbgt_no_launch(void* ev0, void* ev1, cudaStream_t stream) {
  cudaError_t e = sbgt_record(ev0, stream);
  if (e == cudaSuccess) e = sbgt_record(ev1, stream);
  return (int)e;
}

// The launch's error, else the end event's record.
inline int sbgt_launched(void* ev1, cudaStream_t stream) {
  const cudaError_t e = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : sbgt_record(ev1, stream));
}

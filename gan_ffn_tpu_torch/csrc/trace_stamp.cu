// The port's trace stamp (utils/profiling.py): one thread appends one entry,
// (tag, %globaltimer ns), to a fixed-size log in device memory.
//
// No TPU kernel is replaced: the JAX package has no device-side tracing.
//
// A stamp launched on a stream runs after the work enqueued before it and
// before the work enqueued after it, so two stamps bracket a region of the
// stream on the device's clock.  A stamp that a CUDA graph records is a node
// of the graph: every replay appends its own entry.  The slot comes from an
// atomicAdd on the log's cursor, which keeps counting past the capacity: an
// entry whose slot lies past it is dropped, and cursor - capacity says how
// many were.  The tag is the region's id times two, plus 1 for its end.
//
// What bounds it: launch latency.  It reads the clock, does one atomic and
// writes 16 bytes.

#include <cuda_runtime.h>

namespace {

__global__ void trace_stamp_kernel(unsigned long long* log, unsigned long long* cursor,
                                   unsigned long long capacity, unsigned long long tag) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(cursor, 1ull);
  if (slot < capacity) {
    log[2 * slot] = tag;
    log[2 * slot + 1] = now;
  }
}

}  // namespace

extern "C" {

// log: (capacity, 2) 64-bit words on the current device; cursor: one
// 64-bit word there.  Launches on `stream`; returns cudaGetLastError() after
// the launch.
int gan_trace_stamp(unsigned long long* log, unsigned long long* cursor,
                    unsigned long long capacity, unsigned long long tag, cudaStream_t stream) {
  if (log == nullptr || cursor == nullptr || capacity == 0) return (int)cudaErrorInvalidValue;
  trace_stamp_kernel<<<1, 1, 0, stream>>>(log, cursor, capacity, tag);
  return (int)cudaGetLastError();
}

const char* gan_trace_stamp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

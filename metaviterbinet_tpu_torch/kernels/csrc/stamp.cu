// The device's time stamps for utils/profiling.py::Tracer. It is no port of a
// TPU kernel: the JAX package traces with the XLA profiler, which sees inside
// its compiled programs; here a span that the engine opens inside a CUDA graph
// (online/engine.py's block graph) or inside a graph's IF node (online/
// graphs.py::when) becomes this kernel as a node of the graph, so that every
// replay stamps again. A CUDA timing event captured into a graph is
// overwritten at each replay, and torch.profiler does not run through a whole
// by-word run (PERF.md), so neither gives the time of every replay.
//
// One thread reads %globaltimer (ns, the device's clock) and writes it with
// the caller's code into a row of a preallocated int64 buffer [rows, 2]: a
// fixed row where `fixed` >= 0 (the tracer's calibrations and the window's
// end), else the next row after kFixed fixed rows, taken from a cursor that
// row 0 holds (atomicAdd), so that the rows follow the order in which the
// device ran the stamps and no replay overwrites another's. A stamp past the
// buffer's `capacity` rows is dropped; the cursor keeps counting, so the
// reader knows how many. Bounded by its launch (~2-3 us on the host, a few
// hundred ns on the device), never by its 16 bytes.
#include <cuda_runtime.h>

namespace {

constexpr long long kFixed = 16;

__global__ void stamp_kernel(unsigned long long* buf, long long capacity, long long code,
                             int fixed) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long row;
  if (fixed >= 0) {
    row = 1 + fixed;
  } else {
    unsigned long long slot = atomicAdd(buf, 1ULL);
    if (slot >= static_cast<unsigned long long>(capacity)) return;
    row = 1 + kFixed + static_cast<long long>(slot);
  }
  buf[2 * row] = now;
  buf[2 * row + 1] = static_cast<unsigned long long>(code);
}

}  // namespace

// Enqueue one stamp on `stream` (into the graph it captures, if it captures):
// `buf` is int64 [1 + 16 + capacity, 2] on the device, its first row zero at
// the start (the cursor). Returns the CUDA error of the launch.
extern "C" int stamp(void* buf, long long capacity, long long code, int fixed,
                     cudaStream_t stream) {
  if (fixed >= kFixed) return static_cast<int>(cudaErrorInvalidValue);
  stamp_kernel<<<1, 1, 0, stream>>>(static_cast<unsigned long long*>(buf), capacity, code, fixed);
  return static_cast<int>(cudaGetLastError());
}

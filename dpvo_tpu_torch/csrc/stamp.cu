// Device timestamps of the engine's tracing (dpvo_tpu_torch/utils/timing.py).
//
// Replaces no TPU kernel: the JAX engine times its programs from the host.
// On the card a program is a CUDA graph replay that returns before the
// device runs it, so a host clock cannot split it; these kernels let the
// card write its own %globaltimer (nanoseconds) at chosen points of the
// stream, with no fence anywhere.
//
// ring: (rows + 1, cols, 2) int64, each cell (time, tag); row `rows` is the
// discard row. cur: one int64, the slot the in-graph stamps write to.
//
//   stamp_set_kernel   (launched eagerly, never captured): cur = slot; with
//                      col >= 0 also stamps (slot, col). slot -1 parks cur,
//                      so that the graphs' stamps of untraced frames go to
//                      the discard row.
//   stamp_graph_kernel (captured into the programs' graphs): stamps
//                      (cur, col), whatever cur holds at replay.
//
// Cell of slot s: row s % rows (the discard row for s < 0), tag s, so the
// reader can tell a cell the slot wrote from one a later slot overwrote.
//
// Bound: one thread writes 16 bytes; a launch costs its scheduling (a few
// microseconds of device time inside a graph, measured in PERF.md), which
// is why one frame has only the stamps its metrics need.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void write_cell(long long* ring, long long slot,
                                           int col, int rows, int cols) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  long long row = slot < 0 ? rows : slot % rows;
  long long* cell = ring + (row * cols + col) * 2;
  cell[0] = static_cast<long long>(t);
  cell[1] = slot;
}

__global__ void stamp_set_kernel(long long* ring, long long* cur,
                                 long long slot, int col, int rows,
                                 int cols) {
  *cur = slot;
  if (col >= 0) write_cell(ring, slot, col, rows, cols);
}

__global__ void stamp_graph_kernel(long long* ring, const long long* cur,
                                   int col, int rows, int cols) {
  write_cell(ring, *cur, col, rows, cols);
}

}  // namespace

extern "C" {

// slot >= 0: the slot of a program replay about to start; -1: park.
// Returns cudaGetLastError() of the launch.
int dpvo_stamp_set(void* ring, void* cur, long long slot, int col, int rows,
                   int cols, void* stream) {
  stamp_set_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(cur), slot, col,
      rows, cols);
  return static_cast<int>(cudaGetLastError());
}

int dpvo_stamp_graph(void* ring, const void* cur, int col, int rows, int cols,
                     void* stream) {
  stamp_graph_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<const long long*>(cur), col,
      rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Compact per-group sums of group-sorted rows.
//
// Replaces dpvo_tpu/ops/agg_pallas.py:segment_softmax_sums (_kernel) and
// dpvo_tpu/ops/agg_pallas.py:segment_sums (_kernel_sum).
//   K3:  out[g, :D]  = sum_{r in g} exp(x[r] - shift)
//        out[g, D:]  = sum_{r in g} exp(x[r] - shift) * val[r]
//   K4:  out[g, :]   = sum_{r in g} x[r]
// Rows arrive sorted by dense group rank gid (nondecreasing, step <= 1).
// Output rows g in [0, G) are written for every g: groups with no rows get
// zeros, and rows whose rank is >= G are ignored.
//
// What bounds them on an H100: each input row is read once and the (G, D)
// or (G, 2D) table written once, so bytes (about 57 MB for the SoftAgg sums
// at E = 14336, D = 384: ~17 us at 3.35 TB/s; 7.3 MB for the BA coupling
// sums at D = 98: ~2.2 us). At that size the BA sums are bound by latency:
// each dependent round of global loads costs about as much as the bytes.
//
// segment_sums_kernel (the SoftAgg sums, K3; the first version's EXP
// instance, its code unchanged): one block per (group, 128-column tile).
// Threads 0 and 1 binary-search the group's [start, end) in gid; each
// thread then adds its column down the run in row order.
// Neighbouring threads read neighbouring columns of one row, so every row
// read is coalesced. Long runs serialise on one thread per column.
//
// segment_sums_sliced_kernel (the BA coupling sums, K4): blocks own row
// slices, not groups, so nothing is searched. A block stages gid for its
// SLICE rows, the row before them and TAIL rows after them in shared memory
// in one round of loads. A row is a run head when it is row 0 or its rank
// differs from the row before; the block sums every run whose head lies in
// its slice, reading on past the slice end (from the staged TAIL rows, and
// past them from global memory only for a run longer than TAIL), so each
// group has exactly one writer. Work items are (run, column unit) pairs
// spread over the block's threads; a unit is two columns (float2 loads,
// D = 98: 49 units a row) where D is even, else one. Each thread issues up
// to 16 row loads of its run at once and adds them in row order from 0.f,
// the order of the first version of this kernel (one block per group), so
// the result is bitwise that version's and the row-order reference's (no
// multiplies, so no FMA contraction). Extra blocks of the same grid write
// the zero rows [gid[E-1] + 1, G) (all G rows when E = 0) with 16-byte
// stores: no second launch, no memset. Dense ranks start at 0 and leave no
// gap, so no other group is empty. No atomics: the results are
// deterministic, as on the TPU.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 128;   // columns per block

__device__ __forceinline__ int lower_bound(const int* __restrict__ gid,
                                           int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (gid[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(NT)
segment_sums_kernel(const float* __restrict__ x,
                    const float* __restrict__ val,
                    const float* __restrict__ shift,
                    const int* __restrict__ gid, float* __restrict__ out,
                    int E, int D) {
  __shared__ int bounds[2];
  const int g = blockIdx.x;
  if (threadIdx.x < 2) bounds[threadIdx.x] = lower_bound(gid, E, g + threadIdx.x);
  __syncthreads();
  const int c = blockIdx.y * NT + threadIdx.x;
  if (c >= D) return;
  const int start = bounds[0];
  const int end = bounds[1];
  float s1 = 0.f, s2 = 0.f;
  const float sh = shift[c];
  for (int r = start; r < end; ++r) {
    const float e = expf(x[(size_t)r * D + c] - sh);
    s1 += e;
    s2 += e * val[(size_t)r * D + c];
  }
  out[(size_t)g * 2 * D + c] = s1;
  out[(size_t)g * 2 * D + D + c] = s2;
}

int launch(const void* x, const void* val, const void* shift,
           const void* gid, void* out, int E, int D, int G, void* stream) {
  if (G > 0 && D > 0) {
    const dim3 grid(G, (D + NT - 1) / NT);
    segment_sums_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)val, (const float*)shift,
        (const int*)gid, (float*)out, E, D);
  }
  return (int)cudaGetLastError();
}

// --- K4: row slices --------------------------------------------------------

constexpr int SLICE = 32;       // rows per slice block
constexpr int TAIL = 32;        // rows staged past the slice
constexpr int NT_S = 128;       // threads per block
constexpr int UNROLL = 16;      // row loads in flight per thread
constexpr int ZERO_F = NT_S * 16;   // floats one zero block writes (16 KB)

template <int VW> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& a, T b) { a += b; }
};
template <> struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static void add(T& a, T b) { a.x += b.x; a.y += b.y; }
};

// Zeroes out[lo, hi) (floats), 16-byte stores where aligned; out is 16-byte
// aligned, so float index i is aligned when i % 4 == 0.
__device__ __forceinline__ void zero_range(float* out, long long lo,
                                           long long hi, int t, int nt) {
  if (lo >= hi) return;
  const long long a = (lo + 3) & ~3LL;
  const long long b = hi & ~3LL;
  if (a >= b) {
    for (long long i = lo + t; i < hi; i += nt) out[i] = 0.f;
    return;
  }
  for (long long i = lo + t; i < a; i += nt) out[i] = 0.f;
  float4* o4 = reinterpret_cast<float4*>(out + a);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = t; i < (b - a) / 4; i += nt) o4[i] = z;
  for (long long i = b + t; i < hi; i += nt) out[i] = 0.f;
}

template <int VW>
__global__ void __launch_bounds__(NT_S)
segment_sums_sliced_kernel(const float* __restrict__ x,
                           const int* __restrict__ gid,
                           float* __restrict__ out, int E, int D, int G,
                           int n_slices) {
  using V = Vec<VW>;
  using T = typename V::T;
  const int t = threadIdx.x;
  if ((int)blockIdx.x >= n_slices) {       // the zero tail
    const long long first = E > 0 ? (long long)gid[E - 1] + 1 : 0;
    const long long lo = (long long)(blockIdx.x - n_slices) * ZERO_F;
    const long long end = (long long)G * D;
    zero_range(out, max(lo, min(first, (long long)G) * D),
               min(lo + ZERO_F, end), t, NT_S);
    return;
  }

  __shared__ int g_s[SLICE + TAIL + 1];   // gid[r0 - 1 .. r0 + SLICE + TAIL)
  __shared__ int head[SLICE + 1];         // slice rows of the run heads, then
                                          // the last run's end
  __shared__ int n_heads;
  const int r0 = blockIdx.x * SLICE;
  const int n = min(SLICE, E - r0);
  for (int i = t; i < SLICE + TAIL + 1; i += NT_S) {
    const int r = r0 - 1 + i;
    g_s[i] = r < 0 ? -1 : (r < E ? gid[r] : INT32_MAX);
  }
  __syncthreads();
  static_assert(SLICE == 32, "one warp's ballot finds the slice's heads");
  if (t < 32) {
    const bool is_head = t < n && g_s[t + 1] != g_s[t];
    const unsigned m = __ballot_sync(0xffffffffu, is_head);
    if (is_head) head[__popc(m & ((1u << t) - 1))] = t;
    if (t == 0) n_heads = __popc(m);
  }
  __syncthreads();
  const int nh = n_heads;
  if (nh == 0) return;
  if (t < 32) {
    // the last run's end: the first row past its head with another rank,
    // from the staged rows, then (a run longer than TAIL) from gid
    const int g_last = g_s[head[nh - 1] + 1];
    int end = -1;
    for (int i = head[nh - 1] + 1; i < SLICE + TAIL && end < 0; i += 32) {
      const int k = i + t;
      const bool other = k < SLICE + TAIL && g_s[k + 1] != g_last;
      const unsigned m = __ballot_sync(0xffffffffu, other);
      if (m) end = r0 + i + __ffs(m) - 1;
    }
    for (int base = r0 + SLICE + TAIL; end < 0; base += 32) {
      const int r = base + t;
      const bool other = r >= E || gid[r] != g_last;
      const unsigned m = __ballot_sync(0xffffffffu, other);
      if (m) end = base + __ffs(m) - 1;
    }
    if (t == 0) head[nh] = min(end, E) - r0;
  }
  __syncthreads();

  const int U = D / VW;                   // column units per row
  const T* xv = reinterpret_cast<const T*>(x);
  T* ov = reinterpret_cast<T*>(out);
  for (int i = t; i < nh * U; i += NT_S) {
    const int h = i / U;
    const int u = i % U;
    const int g = g_s[head[h] + 1];
    if (g >= G) continue;
    const int end = r0 + head[h + 1];
    T acc = V::zero();
    for (int r = r0 + head[h]; r < end; r += UNROLL) {
      T v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        v[k] = r + k < end ? xv[(size_t)(r + k) * U + u] : V::zero();
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        if (r + k < end) V::add(acc, v[k]);
    }
    ov[(size_t)g * U + u] = acc;
  }
}

int launch_sliced(const void* x, const void* gid, void* out, int E, int D,
                  int G, void* stream) {
  if (G <= 0 || D <= 0) return (int)cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorInvalidValue;
  const int n_slices = (E + SLICE - 1) / SLICE;
  const long long n_zero = ((long long)G * D + ZERO_F - 1) / ZERO_F;
  const dim3 grid((unsigned)(n_slices + n_zero));
  const cudaStream_t st = (cudaStream_t)stream;
  if (D % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0) {
    segment_sums_sliced_kernel<2><<<grid, NT_S, 0, st>>>(
        (const float*)x, (const int*)gid, (float*)out, E, D, G, n_slices);
  } else {
    segment_sums_sliced_kernel<1><<<grid, NT_S, 0, st>>>(
        (const float*)x, (const int*)gid, (float*)out, E, D, G, n_slices);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gate, val (E, D) fp32; shift (D,) fp32; gid (E,) int32 sorted dense
// ranks; out (G, 2D) fp32. Returns cudaGetLastError() of the launch.
int dpvo_segment_softmax_sums(const void* gate, const void* val,
                              const void* shift, const void* gid, void* out,
                              int E, int D, int G, void* stream) {
  return launch(gate, val, shift, gid, out, E, D, G, stream);
}

// vals (E, D) fp32; gid (E,) int32 sorted dense ranks; out (G, D) fp32,
// 16-byte aligned (cudaErrorInvalidValue otherwise).
int dpvo_segment_sums(const void* vals, const void* gid, void* out, int E,
                      int D, int G, void* stream) {
  return launch_sliced(vals, gid, out, E, D, G, stream);
}

}  // extern "C"

// Patch correlation at one or two pyramid levels, written in a feature
// layout with no product after it.
//
// Replaces dpvo_tpu/ops/corr_pallas.py:corr_pallas_fused (K1: bodies
// _kernel_fused v4, _kernel_fused_v5, _v9, _v10, _v12; two levels) and
// corr_pallas.py:corr_pallas (K5: bodies _kernel v1 and _kernel_v3; one
// level). For every edge e and each of its 9 patch pixels p, at each level:
//   - dot the patch feature row g_pre[e, p] (128 channels) with the 8x8 tap
//     window of the zero-padded feature map fmap_l[ff[e]] starting at
//     clamp(floor(c_l) + PAD - R) (level 2 uses c / 4);
//   - bilinear-blend the 8x8 taps to 7x7 with the fractional part of c_l,
//     y then x, in fp32, rounded once to the output type.
// Each blended value goes straight to its lane of the output layout:
//   RAW (E, NL, 9, 7, 7)  (level, p, dy, dx)
//   V10 (E, 9, 128)       lanes level*64 + dy*8 + dx   (NL = 2)
//   V12 (E, 9, 256)       lanes level*128 + dy*16 + dx (NL = 2)
//   REF (E, 7, 7, 3, 3)   (dx, dy, py, px)             (NL = 1)
// Dead lanes (dy or dx >= 7) are written as zeros, and so are rows at or
// past n_live (the TPU's dead tail tiles). Rows past E are not touched.
//
// What bounds it on an H100: bytes. It does 64 * 128 * 2 = 16 kFLOP per
// (edge, level, pixel), 0.3 MFLOP per two-level edge, against 2.3 kB of g
// rows and 1.8 kB (raw) to 4.6 kB (v12) of output per edge in bf16, plus
// the window pixels the coordinates touch, each read once (most of the
// target frames' rings; the windows of neighbouring pixels overlap). At
// 6144 edges over 8 frames that is about 76 MB, 23 us at 3.35 TB/s,
// against 1.8 GFLOP, 2 us on the bf16 tensor cores. This first version does
// the taps as fp32 FMAs on the CUDA cores (67 TFLOP/s: 27 us at 6144 edges)
// and rereads each window row from L2 once for every pixel whose window
// covers it, so L2 traffic bounds it, well above both (times in PERF.md).
// What the design does about it: the window stage of K2 (corr_window.cuh):
// one block owns EB edges, each warp reads whole 8x128 window rows with
// 16-byte loads and reduces the channel products with half-warp shuffles;
// the taps stay in shared memory, and the write pass walks each output row
// in order, so consecutive threads store consecutive lanes.
//
// Non-finite coordinates are clamped in float before the int conversion, so
// they read a window inside the padded map (never out of bounds); their
// fractional part is NaN, and so are their output values.
//
// corr_probe_kernel<PROBE> replaces scripts/dev/corr_variants.py:
// probe_variant (D3): K1's window stage on bf16 rings, stopped after one
// phase (corr_window.cuh probe_row), one template instance per probe. Like
// the TPU probe's constant output block, only the last 16 edges (the last
// TPU tile) are stored, fp32 (16, 2, 9, 8, 128) as (edge, level, pixel,
// window row, lane); every other row's values feed a store guarded by
// value == never, with never a NaN passed at run time, so no phase is dead
// code and almost no output traffic is added. What bounds a probe: the
// bytes of the window pixels it reads (one pixel column per row for load
// and shift, 16 for convert, 8 for multiply and dot), as for K1.
#include "corr_window.cuh"

namespace {

using namespace corr;

constexpr int EB = 8;             // edges per block
constexpr int NT = 256;           // threads per block

enum Layout { RAW = 0, V10 = 1, V12 = 2, REF = 3 };

struct Args {
  const void* g_pre;              // (E, 9, 128) Tin
  const int* ff;                  // (E,) ring slot of each edge's frame
  const void* fmap1;              // (F, Hp1, Wp1, 128) Tin
  const void* fmap2;              // (F, Hp2, Wp2, 128) Tin (NL = 2)
  const float* coords;            // (E, 2, 3, 3) level-1 coords
  void* out;                      // Tout, layout above
  int E, n_live, layout, Hp1, Wp1, Hp2, Wp2;
};

__device__ __forceinline__ int row_len(int layout, int nl) {
  switch (layout) {
    case V10: return P2 * 128;
    case V12: return P2 * 256;
    default: return nl * P2 * DB * DB;    // RAW, REF
  }
}

// Output lane o of a row -> (level * 9 + p, dy, dx); false for a dead lane.
__device__ __forceinline__ bool decode(int layout, int o, int& lp, int& dy,
                                       int& dx) {
  switch (layout) {
    case V10: {
      const int lane = o & 127;
      lp = (lane >> 6) * P2 + (o >> 7);
      dy = (lane >> 3) & 7;
      dx = lane & 7;
      return dy < DB && dx < DB;
    }
    case V12: {
      const int lane = o & 255;
      lp = (lane >> 7) * P2 + (o >> 8);
      dy = (lane >> 4) & 7;
      dx = lane & 15;
      return dy < DB && dx < DB;
    }
    case REF:
      dx = o / (DB * P2);
      dy = (o / P2) % DB;
      lp = o % P2;
      return true;
    default: {                            // RAW
      lp = o / (DB * DB);
      const int r = o % (DB * DB);
      dy = r / DB;
      dx = r % DB;
      return true;
    }
  }
}

template <int NL>
struct Shared {
  float taps[EB][NL * P2 * D * D];  // (level, p, ty, tx) per edge
  long long win[EB][NL * P2];       // element offset of each window origin
  float fx[EB][NL * P2];            // fractional x per (level, p)
  float fy[EB][NL * P2];
  long long grow[EB];               // element offset of g_pre[e]
};

template <int NL, typename Tin, typename Tout>
__global__ void __launch_bounds__(NT) corr_raw_kernel(Args a) {
  __shared__ __align__(16) Shared<NL> s;
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * EB;
  const int n_here = min(a.E, a.n_live) - e0;   // computed rows here

  window_meta<NL, EB, NT>(a.coords, a.ff, e0, n_here, a.Hp1, a.Wp1, a.Hp2,
                          a.Wp2, s.win, s.fx, s.fy);
  if (tid < EB) s.grow[tid] = (long long)(e0 + tid) * P2 * C;
  __syncthreads();

  window_taps<Tin, NL, EB, NT>(
      static_cast<const Tin*>(a.g_pre), s.grow,
      static_cast<const Tin*>(a.fmap1), static_cast<const Tin*>(a.fmap2),
      a.Wp1, a.Wp2, n_here, s.win, s.taps);
  __syncthreads();

  const int row = row_len(a.layout, NL);
  Tout* out = static_cast<Tout*>(a.out);
  for (int i = tid; i < EB * row; i += NT) {
    const int e = i / row;
    const int o = i % row;
    if (e0 + e >= a.E) break;
    int lp, dy, dx;
    float v = 0.f;
    if (decode(a.layout, o, lp, dy, dx) && e < n_here)
      v = blend(&s.taps[e][lp * D * D], s.fx[e][lp], s.fy[e][lp], dy, dx);
    out[(size_t)(e0 + e) * row + o] = from_f<Tout>(v);
  }
}

template <int NL, typename Tin, typename Tout>
int launch(const Args& a, cudaStream_t stream) {
  if (a.E > 0) {
    corr_raw_kernel<NL, Tin, Tout><<<(a.E + EB - 1) / EB, NT, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int NL, typename Tin>
int launch_out(int out_bf16, const Args& a, cudaStream_t stream) {
  return out_bf16 ? launch<NL, Tin, __nv_bfloat16>(a, stream)
                  : launch<NL, Tin, float>(a, stream);
}

template <int NL>
int launch_in(int in_bf16, int out_bf16, const Args& a,
              cudaStream_t stream) {
  return in_bf16 ? launch_out<NL, __nv_bfloat16>(out_bf16, a, stream)
                 : launch_out<NL, float>(out_bf16, a, stream);
}

constexpr int PROBE_TILE = 16;    // edges of the TPU probe's output block

struct ProbeArgs {
  const __nv_bfloat16* g_pre;     // (E, 9, 128)
  const int* ff;                  // (E,) ring slot of each edge's frame
  const __nv_bfloat16* fmap1;     // (F, Hp1, Wp1, 128)
  const __nv_bfloat16* fmap2;     // (F, Hp2, Wp2, 128)
  const float* coords;            // (E, 2, 3, 3) level-1 coords
  float* out;                     // (16, 2, 9, 8, 128) fp32
  float never;                    // a NaN: no value equals it
  int E, Hp1, Wp1, Hp2, Wp2;
};

template <int PROBE>
__global__ void __launch_bounds__(NT) corr_probe_kernel(ProbeArgs a) {
  __shared__ long long win[EB][2 * P2];   // element offset of origin bx
  __shared__ int shift[EB][2 * P2];       // bx - x0, x0 the aligned origin
  const int e0 = blockIdx.x * EB;
  const int n_here = min(EB, a.E - e0);
  for (int i = threadIdx.x; i < EB * 2 * P2; i += NT) {
    const int e = i / (2 * P2);
    const int lp = i % (2 * P2);
    const int l = lp / P2;
    const int p = lp % P2;
    long long off = 0;
    int r = 0;
    if (e < n_here) {
      const int edge = e0 + e;
      float cx = a.coords[(size_t)edge * 2 * P2 + p];
      float cy = a.coords[(size_t)edge * 2 * P2 + P2 + p];
      if (l == 1) { cx *= 0.25f; cy *= 0.25f; }
      const int Hp = l == 0 ? a.Hp1 : a.Hp2;
      const int Wp = l == 0 ? a.Wp1 : a.Wp2;
      int bx, by;
      float fx, fy;
      window_origin(cx, cy, Hp, Wp, bx, by, fx, fy);
      r = bx - min((bx / 8) * 8, Wp - DW);
      off = (((long long)a.ff[edge] * Hp + by) * Wp + bx) * C;
    }
    win[e][lp] = off;
    shift[e][lp] = r;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int first_stored = a.E - PROBE_TILE;
  for (int task = threadIdx.x >> 5; task < n_here * 2 * P2 * D;
       task += NT / 32) {
    const int e = task / (2 * P2 * D);
    const int lp = (task / D) % (2 * P2);
    const int y = task % D;
    const int l = lp / P2;
    const int p = lp % P2;
    const int edge = e0 + e;
    const __nv_bfloat16* row = (l == 0 ? a.fmap1 : a.fmap2) + win[e][lp]
                               + (long long)y * (l == 0 ? a.Wp1 : a.Wp2) * C;
    float v[8];
    probe_row<PROBE>(row - (long long)shift[e][lp] * C, row,
                     a.g_pre + ((size_t)edge * P2 + p) * C, lane, v);
    if (lane >= 16) continue;
    if (edge >= first_stored) {
      float4* o = reinterpret_cast<float4*>(
          a.out + (((size_t)(edge - first_stored) * 2 * P2 + lp) * D + y) * C
          + 8 * lane);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      bool hit = false;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        hit |= v[i] == a.never;
        s += v[i];
      }
      if (hit) a.out[8 * lane] = s;
    }
  }
}

template <int PROBE>
int launch_probe(const ProbeArgs& a, cudaStream_t stream) {
  corr_probe_kernel<PROBE><<<(a.E + EB - 1) / EB, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous tensors (see Args);
// levels 1 (K5: layouts RAW, REF; fmap2 unused) or 2 (K1: RAW, V10, V12);
// in_bf16 / out_bf16 select bf16 over fp32. Returns the cudaGetLastError()
// code of the launch (0 on success), cudaErrorInvalidValue for a level and
// layout pair that does not exist.
int dpvo_corr_raw(int levels, int in_bf16, int out_bf16, int layout,
                  const void* g_pre, const void* ff, const void* fmap1,
                  const void* fmap2, const void* coords, void* out, int E,
                  int n_live, int Hp1, int Wp1, int Hp2, int Wp2,
                  void* stream) {
  const Args a{g_pre, static_cast<const int*>(ff), fmap1, fmap2,
               static_cast<const float*>(coords), out, E, n_live, layout,
               Hp1, Wp1, Hp2, Wp2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (levels == 2 && (layout == RAW || layout == V10 || layout == V12))
    return launch_in<2>(in_bf16, out_bf16, a, st);
  if (levels == 1 && (layout == RAW || layout == REF))
    return launch_in<1>(in_bf16, out_bf16, a, st);
  return (int)cudaErrorInvalidValue;
}

// D3: probe (a Probe of corr_window.cuh) over E edges, E a positive
// multiple of 16, on bf16 rings; writes out (16, 2, 9, 8, 128) fp32.
// Returns the cudaGetLastError() code of the launch, cudaErrorInvalidValue
// for an unknown probe or a bad E.
int dpvo_corr_probe(int probe, const void* g_pre, const void* ff,
                    const void* fmap1, const void* fmap2, const void* coords,
                    void* out, float never, int E, int Hp1, int Wp1, int Hp2,
                    int Wp2, void* stream) {
  const ProbeArgs a{static_cast<const __nv_bfloat16*>(g_pre),
                    static_cast<const int*>(ff),
                    static_cast<const __nv_bfloat16*>(fmap1),
                    static_cast<const __nv_bfloat16*>(fmap2),
                    static_cast<const float*>(coords),
                    static_cast<float*>(out), never, E, Hp1, Wp1, Hp2, Wp2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < PROBE_TILE || E % PROBE_TILE) return (int)cudaErrorInvalidValue;
  switch (probe) {
    case P_LOAD: return launch_probe<P_LOAD>(a, st);
    case P_CONVERT: return launch_probe<P_CONVERT>(a, st);
    case P_ROLL: return launch_probe<P_ROLL>(a, st);
    case P_MULT_SUBL: return launch_probe<P_MULT_SUBL>(a, st);
    case P_FULL_DOT: return launch_probe<P_FULL_DOT>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

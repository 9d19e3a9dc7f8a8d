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

}  // extern "C"

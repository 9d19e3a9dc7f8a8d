// The window stage shared by the correlation kernels (corr_enc.cu, K2, and
// corr_raw.cu, K1/K5): per (edge, level, patch pixel), the origin and
// fractional offsets of the 8x8 tap window in a zero-padded feature ring,
// the 64 taps g . fmap over 128 channels, and the bilinear 8x8 -> 7x7 blend.
//
// Taps: one warp task is one window row (8 taps x 128 channels, 1024
// contiguous values). Lane l reads the 16-byte chunks j = l + 32k (k < 4),
// which are tap (l >> 4) + 2k, channels 8 * (l & 15) .. + 8, and half-warp
// shuffles reduce the per-channel products. Accumulation is fp32.
//
// probe_row is a probe build of the same stage (the TPU kernel's phase
// probes, scripts/dev/corr_variants.py): it stops the pipeline after one
// phase (load, convert, shift, multiply, dot) of one window row.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace corr {

constexpr int PAD = 8;            // zero border of the feature rings
constexpr int R = 3;              // correlation radius
constexpr int D = 2 * R + 2;      // tap window side (8)
constexpr int P2 = 9;             // patch pixels (3 x 3)
constexpr int C = 128;            // feature channels
constexpr int DB = D - 1;         // blended side (7)
constexpr int DW = 16;            // the TPU kernels' 8-aligned window width

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive values (16-byte aligned) -> fp32 registers
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Origin (bx, by) of the 8x8 tap window of one level coordinate (cx, cy)
// in a zero-padded Hp x Wp map, clamp(floor(c) + PAD - R), and the
// fractional offsets. Clamped in float first: NaN and huge values land
// inside the map.
__device__ __forceinline__ void window_origin(float cx, float cy, int Hp,
                                              int Wp, int& bx, int& by,
                                              float& fx, float& fy) {
  const float bxf = floorf(cx);
  const float byf = floorf(cy);
  fx = cx - bxf;
  fy = cy - byf;
  bx = (int)fminf(fmaxf(bxf + (float)(PAD - R), 0.f), (float)(Wp - D));
  by = (int)fminf(fmaxf(byf + (float)(PAD - R), 0.f), (float)(Hp - D));
}

// Window metadata of a block's EB edges, NL levels and 9 pixels: element
// offset of each window origin and the fractional x / y. Level 1 samples
// coords / 4 in the second ring. Edges at or past n_here (block-relative)
// get a zero origin and zero fractions; their taps are not computed.
template <int NL, int EB, int NT>
__device__ __forceinline__ void window_meta(
    const float* __restrict__ coords, const int* __restrict__ ff, int e0,
    int n_here, int Hp1, int Wp1, int Hp2, int Wp2,
    long long (*win)[NL * P2], float (*fxs)[NL * P2],
    float (*fys)[NL * P2]) {
  for (int i = threadIdx.x; i < EB * NL * P2; i += NT) {
    const int e = i / (NL * P2);
    const int lp = i % (NL * P2);
    const int l = lp / P2;
    const int p = lp % P2;
    const int edge = e0 + e;
    long long off = 0;
    float fx = 0.f, fy = 0.f;
    if (e < n_here) {
      // coords (E, 2, 3, 3): [x | y] planes of the 3x3 patch
      float cx = coords[(size_t)edge * 2 * P2 + p];
      float cy = coords[(size_t)edge * 2 * P2 + P2 + p];
      if (l == 1) { cx *= 0.25f; cy *= 0.25f; }
      const int Hp = l == 0 ? Hp1 : Hp2;
      const int Wp = l == 0 ? Wp1 : Wp2;
      int bx, by;
      window_origin(cx, cy, Hp, Wp, bx, by, fx, fy);
      const long long f = ff[edge];
      off = ((f * Hp + by) * Wp + bx) * C;
    }
    win[e][lp] = off;
    fxs[e][lp] = fx;
    fys[e][lp] = fy;
  }
}

// The 64 taps of every (edge, level, pixel) window of the block:
// taps[e][(lp * D + ty) * D + tx]. g rows are g + grow[e] + p * C. Edges at
// or past n_here get zero taps.
template <typename T, int NL, int EB, int NT>
__device__ __forceinline__ void window_taps(
    const T* __restrict__ g, const long long* grow,
    const T* __restrict__ fmap1, const T* __restrict__ fmap2, int Wp1,
    int Wp2, int n_here, long long (*win)[NL * P2],
    float (*taps)[NL * P2 * D * D]) {
  const int lane = threadIdx.x & 31;
  const int cbase = 8 * (lane & 15);
  for (int task = threadIdx.x >> 5; task < EB * NL * P2 * D;
       task += NT / 32) {
    const int e = task / (NL * P2 * D);
    const int rem = task % (NL * P2 * D);
    const int lp = rem / D;
    const int row = rem % D;
    const int l = lp / P2;
    const int p = lp % P2;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (e < n_here) {
      float gv[8];
      load8(g + grow[e] + p * C + cbase, gv);
      const T* fm = l == 0 ? fmap1 : fmap2;
      const int Wp = l == 0 ? Wp1 : Wp2;
      const T* rowp = fm + win[e][lp] + (long long)row * Wp * C;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[8];
        load8(rowp + 8 * (lane + 32 * k), v);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[k] = fmaf(gv[c], v[c], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    }
    if ((lane & 15) == 0) {
      float* t = &taps[e][(lp * D + row) * D];
#pragma unroll
      for (int k = 0; k < 4; ++k) t[(lane >> 4) + 2 * k] = acc[k];
    }
  }
}

// Bilinear blend of one window's 8x8 taps t at blended position (dy, dx):
// y first, then x, in fp32.
__device__ __forceinline__ float blend(const float* t, float fx, float fy,
                                       int dy, int dx) {
  const float ty0 = (1.f - fy) * t[dy * D + dx] + fy * t[(dy + 1) * D + dx];
  const float ty1 = (1.f - fy) * t[dy * D + dx + 1]
                    + fy * t[(dy + 1) * D + dx + 1];
  return (1.f - fx) * ty0 + fx * ty1;
}

// The phase probes, in pipeline order.
enum Probe { P_LOAD = 0, P_CONVERT = 1, P_ROLL = 2, P_MULT_SUBL = 3,
             P_FULL_DOT = 4, N_PROBES = 5 };

// One window row of one probe, computed by a whole warp: ``aligned`` points
// at the row's pixel at the 8-aligned origin x0 = min(8 * (bx / 8), Wp - DW)
// that the TPU loads from, ``row`` at the true origin bx, ``g`` at the patch
// pixel's 128 features. Lane l < 16 gets v = the row's outputs 8 * l .. + 8
// (fp32; 128 per row):
//   P_LOAD       pixel x0, one 16-byte chunk per lane;
//   P_CONVERT    the sum over the 16 aligned pixels, in fp32;
//   P_ROLL       pixel bx: the TPU's roll is only another address here;
//   P_MULT_SUBL  the sum over the window's 8 pixels of pixel x g;
//   P_FULL_DOT   the 8 taps g . pixel (no blend), then zeros.
// Columns split between the half-warps (pixel h + 2k in half h), which one
// shuffle adds; the dot reduces channels with half-warp shuffles as
// window_taps does.
template <int PROBE, typename T>
__device__ __forceinline__ void probe_row(const T* aligned, const T* row,
                                          const T* g, int lane, float v[8]) {
  const int h = lane >> 4;
  const int cb = 8 * (lane & 15);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
  if constexpr (PROBE == P_LOAD || PROBE == P_ROLL) {
    if (h == 0) load8((PROBE == P_LOAD ? aligned : row) + cb, v);
  } else if constexpr (PROBE == P_CONVERT) {
#pragma unroll
    for (int k = 0; k < DW / 2; ++k) {
      float x[8];
      load8(aligned + (h + 2 * k) * C + cb, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += x[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 16);
  } else if constexpr (PROBE == P_MULT_SUBL) {
    float gv[8];
    load8(g + cb, gv);
#pragma unroll
    for (int k = 0; k < D / 2; ++k) {
      float x[8];
      load8(row + (h + 2 * k) * C + cb, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = fmaf(x[i], gv[i], v[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 16);
  } else {                                  // P_FULL_DOT
    float gv[8];
    load8(g + cb, gv);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float x[8];
      load8(row + 8 * (lane + 32 * k), x);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[k] = fmaf(gv[c], x[c], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    }
    // half h holds taps h + 2k; lane 0 gathers all 8
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float odd = __shfl_xor_sync(0xffffffffu, acc[k], 16);
      if (lane == 0) {
        v[2 * k] = acc[k];
        v[2 * k + 1] = odd;
      }
    }
  }
}

}  // namespace corr

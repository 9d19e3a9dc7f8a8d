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
// the window pixels the coordinates touch, each read once. At 45312
// retain edges that is 82 MB (raw) to 120 MB (v12), 0.08-0.12 ms at
// 3.35 TB/s, against 13.4 GFLOP, 14 us on the bf16 tensor cores
// (chip_smoke.py's bound, NVIDIA H100 80GB HBM3 at 700 W).
// What the design does about it: on bf16 rings, corr_window.cuh's box
// stage. One block owns EB_BOX = 4 edges, one warp each, and three blocks
// share an SM, so one block's write pass overlaps the others' loads; a
// warp keeps two box rows in flight (three row buffers). A warp reads each
// patch's box of ring rows once per level with cp.async (45-48 KB per edge
// from L2 on the engine's coordinates, instead of about 295 KB of window
// rows reread for every pixel whose window covers them), takes the taps on
// the tensor cores and blends into shared memory; then the write pass
// copies the raw layout's rows flat and the v10 / v12 rows in 16-byte
// chunks, consecutive threads on consecutive addresses. What bounds it
// now: the latency and L2 traffic of those box rows, 4-7x the byte bound
// (PERF.md). On fp32 rings (MIXED_PRECISION=False) the taps stay fp32
// FMAs on the CUDA cores (window_taps: one warp per 8x128 window row,
// half-warp shuffle reductions), since tensor cores would take fp32 as
// TF32.
//
// Non-finite coordinates are clamped in float before the int conversion, so
// they read a window inside the padded map (never out of bounds); their
// fractional part is NaN, and so are their output values.
//
// corr_probe_kernel<PROBE> replaces scripts/dev/corr_variants.py:
// probe_variant (D3): the box stage stopped after one phase (corr_window.cuh
// probe_level), one template instance per probe. Like the TPU probe's
// constant output block, only the last 16 edges (the last TPU tile) are
// stored, fp32 (16, 2, 9, 8, 128) as (edge, level, pixel, window row,
// lane); every other row's values feed a store guarded by value == never,
// with never a NaN passed at run time, so no phase is dead code and almost
// no output traffic is added. What bounds a probe: the bytes of the window
// pixels it reads (one pixel column per row for load and shift, 16 for
// convert, 8 for multiply and dot), as for K1. What the design does about
// it: one warp per edge, EB_PROBE = 4 a block, as K1; each (edge, level)
// streams the probe's box rows (K1's box for shift, multiply and dot; for
// load and convert a box of up to 24 columns from the 8-aligned origin)
// through a ring of 2-4 cp.async entries, then the rows of the windows that
// do not fit back to back, several rows an entry (all 8 rows of a one-pixel
// window), so a scattered patch keeps 2-5 entries in flight instead of
// K1's 2 rows. The copies go through L1 (cp.async.ca, where K1's box stage
// uses .cg): scattered windows of nearby patches overlap, and L1 serves
// that overlap (PERF.md). The rings are small enough for 16 warps an
// SM (12 for mult_subl).

#include <type_traits>

#include "corr_window.cuh"

namespace {

using namespace corr;

constexpr int EB = 8;             // edges per block (fp32 rings)
constexpr int NT = 256;           // threads per block (fp32 rings)
constexpr int EB_BOX = 4;         // edges per block (bf16 rings), a warp
                                  // each: three blocks share an SM, so one's
                                  // write pass overlaps the others' loads
constexpr int NS = 3;             // box row buffers per warp

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

// fp32 rings: the per-window-row stage's taps and metadata
template <int NL>
struct Shared {
  float taps[EB][NL * P2 * D * D];  // (level, p, ty, tx) per edge
  long long win[EB][NL * P2];       // element offset of each window origin
  float fx[EB][NL * P2];            // fractional x per (level, p)
  float fy[EB][NL * P2];
  long long grow[EB];               // element offset of g_pre[e]
};

// bf16 rings: one box stage per warp and the blended features
template <int NL>
struct BoxShared {
  BoxWarp<NS> warp[EB_BOX];
  float feat[EB_BOX][NL * P2 * DB * DB];  // (level, p, dy, dx) per edge
};

// Edges, threads and blocks per SM for input type Tin.
template <typename Tin>
struct Tiling {
  static constexpr bool box = std::is_same<Tin, __nv_bfloat16>::value;
  static constexpr int eb = box ? EB_BOX : EB;
  static constexpr int nt = box ? 32 * EB_BOX : NT;
  static constexpr int per_sm = box ? 3 : 1;
};

// The write pass: each output row in order, dead lanes and rows at or past
// n_here zero; value(e, lp, dy, dx) gives a live lane's blended value.
template <int NL, typename Tout, int EBK, int NTK, typename Value>
__device__ __forceinline__ void write_rows(const Args& a, int e0,
                                           int n_here, Value value) {
  const int row = row_len(a.layout, NL);
  Tout* out = static_cast<Tout*>(a.out);
  for (int i = threadIdx.x; i < EBK * row; i += NTK) {
    const int e = i / row;
    const int o = i % row;
    if (e0 + e >= a.E) break;
    int lp, dy, dx;
    float v = 0.f;
    if (decode(a.layout, o, lp, dy, dx) && e < n_here)
      v = value(e, lp, dy, dx);
    out[(size_t)(e0 + e) * row + o] = from_f<Tout>(v);
  }
}

// 8 consecutive output values, one 16-byte (bf16) or two (fp32) stores.
__device__ __forceinline__ void store8(__nv_bfloat16* o, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(o) = u;
}
__device__ __forceinline__ void store8(float* o, const float v[8]) {
  reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The write pass of the box path from the blended features feat (EBK rows
// of NL * 441 in raw order): RAW is a flat copy of the block's rows; V10
// and V12 go out in 16-byte chunks, each one (p, level, dy) window row of
// 8 lanes (dx < 7 live) or a dead chunk; REF decodes every lane.
template <int NL, typename Tout, int EBK, int NTK>
__device__ __forceinline__ void write_feat(const Args& a, int e0,
                                           int n_here, const float* feat) {
  constexpr int NF = NL * P2 * DB * DB;
  const int row = row_len(a.layout, NL);
  const int n_rows = min(EBK, a.E - e0);
  const int n_live = max(min(n_here, n_rows), 0);
  Tout* out = static_cast<Tout*>(a.out) + (size_t)e0 * row;
  if (a.layout == RAW) {
    for (int i = threadIdx.x; i < n_rows * NF; i += NTK)
      out[i] = from_f<Tout>(i < n_live * NF ? feat[i] : 0.f);
  } else if (a.layout == V10 || a.layout == V12) {
    const int w = a.layout == V12 ? DW : D;       // lanes per window row
    const int chunks = row / 8;
    for (int i = threadIdx.x; i < n_rows * chunks; i += NTK) {
      const int e = i / chunks;
      const int lane0 = 8 * (i % chunks);
      const int p = lane0 / (2 * D * w);
      const int lane = lane0 % (2 * D * w);       // level*8w + dy*w + dx0
      const int dy = (lane / w) % D;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (e < n_live && dy < DB && lane % w == 0) {
        const float* f = feat + e * NF
                         + ((lane / (D * w) * P2 + p) * DB + dy) * DB;
#pragma unroll
        for (int dx = 0; dx < DB; ++dx) v[dx] = f[dx];
      }
      store8(out + (size_t)e * row + lane0, v);
    }
  } else {
    write_rows<NL, Tout, EBK, NTK>(a, e0, n_here,
                                   [&](int e, int lp, int dy, int dx) {
      return feat[e * NF + (lp * DB + dy) * DB + dx];
    });
  }
}

template <int NL, typename Tin, typename Tout>
__global__ void __launch_bounds__(Tiling<Tin>::nt, Tiling<Tin>::per_sm)
    corr_raw_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int eb = Tiling<Tin>::eb;
  constexpr int nt = Tiling<Tin>::nt;
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * eb;
  const int n_here = min(a.E, a.n_live) - e0;   // computed rows here

  if constexpr (Tiling<Tin>::box) {
    BoxShared<NL>& s = *reinterpret_cast<BoxShared<NL>*>(smem_raw);
    const int we = tid >> 5;        // this warp's edge
    if (we < n_here) {
      const int edge = e0 + we;
      box_taps<NL, NS>(
          static_cast<const Tin*>(a.g_pre) + (size_t)edge * P2 * C,
          static_cast<const Tin*>(a.fmap1), static_cast<const Tin*>(a.fmap2),
          a.ff[edge], a.coords + (size_t)edge * 2 * P2, a.Hp1, a.Wp1, a.Hp2,
          a.Wp2, s.warp[we], [&](int k, float v) { s.feat[we][k] = v; });
    }
    __syncthreads();
    write_feat<NL, Tout, eb, nt>(a, e0, n_here, &s.feat[0][0]);
  } else {
    Shared<NL>& s = *reinterpret_cast<Shared<NL>*>(smem_raw);
    window_meta<NL, EB, NT>(a.coords, a.ff, e0, n_here, a.Hp1, a.Wp1,
                            a.Hp2, a.Wp2, s.win, s.fx, s.fy);
    if (tid < EB) s.grow[tid] = (long long)(e0 + tid) * P2 * C;
    __syncthreads();

    window_taps<Tin, NL, EB, NT>(
        static_cast<const Tin*>(a.g_pre), s.grow,
        static_cast<const Tin*>(a.fmap1), static_cast<const Tin*>(a.fmap2),
        a.Wp1, a.Wp2, n_here, s.win, s.taps);
    __syncthreads();
    write_rows<NL, Tout, eb, nt>(a, e0, n_here,
                                 [&](int e, int lp, int dy, int dx) {
      return blend(&s.taps[e][lp * D * D], D, s.fx[e][lp], s.fy[e][lp], dy,
                   dx);
    });
  }
}

template <int NL, typename Tin, typename Tout>
int launch(const Args& a, cudaStream_t stream) {
  using Tl = Tiling<Tin>;
  constexpr bool box = Tl::box;
  if (box && (a.Wp1 < BOX_W || (NL == 2 && a.Wp2 < BOX_W)))
    return (int)cudaErrorInvalidValue;
  const int smem = box ? (int)sizeof(BoxShared<NL>) : (int)sizeof(Shared<NL>);
  const cudaError_t err = cudaFuncSetAttribute(
      corr_raw_kernel<NL, Tin, Tout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (a.E > 0) {
    corr_raw_kernel<NL, Tin, Tout>
        <<<(a.E + Tl::eb - 1) / Tl::eb, Tl::nt, smem, stream>>>(a);
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
constexpr int EB_PROBE = 4;       // edges per probe block, a warp each

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
__global__ void __launch_bounds__(32 * EB_PROBE,
                                  ProbePlan<PROBE>::blocks_per_sm)
    corr_probe_kernel(ProbeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int we = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int edge = blockIdx.x * EB_PROBE + we;
  if (edge >= a.E) return;                // the block syncs no more
  ProbeWarp<PROBE>& w = reinterpret_cast<ProbeWarp<PROBE>*>(smem_raw)[we];
  const int first_stored = a.E - PROBE_TILE;
  ProbeSink sink{edge >= first_stored
                     ? a.out + (size_t)(edge - first_stored) * 2 * P2 * D * C
                     : nullptr,
                 a.never, false};
  const __nv_bfloat16* g = a.g_pre + (size_t)edge * P2 * C;
  unsigned af[C / 16][4];
  float4 gv[P2];
  if constexpr (PROBE == P_FULL_DOT) {
    patch_frags(g, af);
    if (sink.out) {                       // lanes 8 .. 127 of every row
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = lane; i < 2 * P2 * D * (C / 4 - 2); i += 32)
        reinterpret_cast<float4*>(sink.out)
            [(i / (C / 4 - 2)) * (C / 4) + 2 + i % (C / 4 - 2)] = z;
    }
  }
  if constexpr (PROBE == P_MULT_SUBL) {
#pragma unroll
    for (int p = 0; p < P2; ++p) {
      const uint2 u = *reinterpret_cast<const uint2*>(g + p * C + 4 * lane);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      gv[p] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
  const int f = a.ff[edge];
  const float* c = a.coords + (size_t)edge * 2 * P2;
  probe_level<PROBE>(af, gv, a.fmap1 + (long long)f * a.Hp1 * a.Wp1 * C, c,
                     1.f, a.Hp1, a.Wp1, 0, w, sink);
  probe_level<PROBE>(af, gv, a.fmap2 + (long long)f * a.Hp2 * a.Wp2 * C, c,
                     0.25f, a.Hp2, a.Wp2, 1, w, sink);
  if (sink.hit) a.out[lane] = 0.f;
}

template <int PROBE>
int launch_probe(const ProbeArgs& a, cudaStream_t stream) {
  constexpr int smem = EB_PROBE * sizeof(ProbeWarp<PROBE>);
  if (a.Wp1 < DW || a.Wp2 < DW) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      corr_probe_kernel<PROBE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  corr_probe_kernel<PROBE>
      <<<(a.E + EB_PROBE - 1) / EB_PROBE, 32 * EB_PROBE, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous tensors (see Args);
// levels 1 (K5: layouts RAW, REF; fmap2 unused) or 2 (K1: RAW, V10, V12);
// in_bf16 / out_bf16 select bf16 over fp32 (bf16 rings: 16-byte aligned,
// at least 16 columns). Returns the cudaGetLastError() code of the launch
// (0 on success), cudaErrorInvalidValue for a level and layout pair that
// does not exist or a ring too narrow for the box stage.
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
// multiple of 16, on bf16 rings (16-byte aligned, at least 16 columns);
// writes out (16, 2, 9, 8, 128) fp32. Returns the cudaGetLastError() code
// of the launch, cudaErrorInvalidValue for an unknown probe, a bad E or a
// ring too narrow.
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

// The window stage shared by the correlation kernels (corr_enc.cu, K2, and
// corr_raw.cu, K1/K5): per (edge, level, patch pixel), the origin and
// fractional offsets of the 8x8 tap window in a zero-padded feature ring,
// the 64 taps g . fmap over 128 channels, and the bilinear 8x8 -> 7x7 blend.
//
// bf16 rings: the box stage (box_taps). One warp owns one edge. The 9
// windows of a 3x3 patch at one level overlap almost entirely, so the warp
// reads their union once: a box of up to 16 ring rows of up to 16 pixels
// (level_taps plans it; ops/corr_cuda.py window_boxes is the same plan in
// Python). Each box row (only the pixels the windows read, 128 channels
// each, contiguous) is copied with cp.async into a ring of XOR-swizzled
// shared row buffers (K2 two, K1 three), so the next rows load while row r
// multiplies and ldmatrix reads without bank conflicts (pixels lie 256 B
// apart: unswizzled, 8-way conflicts). The tensor cores take the taps: A
// is the edge's 9 patch rows (rows 9-15 zero) held in registers for both
// levels, B the box row's 16 pixels, 16 mma.sync m16n8k16 (bf16 in, fp32
// accumulation) per box row (8 when its pixels fit one n-tile). Each
// product goes straight to the window that reads it: box row r, pixel px
// is tap (r - oy_p, px - ox_p) of window p, where (oy_p, ox_p) =
// (by_p - y0, bx_p - x0) is the window's origin in the box; the 9
// windows' 8x8 fp32 taps stay in shared memory. A window that does
// not fit the box (an extreme scale change, a strong rotation, clamped or
// NaN coordinates mixed in one patch) is read from a box of its own, its
// 8 rows from its origin: every window is exact whatever the coordinates.
// The products are exact bf16 products summed in fp32, as in the plain
// version up to summation order (and as the TPU's MXU dot).
//
// fp32 rings: the per-window-row stage (window_taps), CUDA-core FMAs.
// Tensor cores would take fp32 as TF32 and break the fp32 engine's
// agreement with the CPU engine; fp32 serves MIXED_PRECISION=False only.
// One warp task is one window row (8 taps x 128 channels, 1024 contiguous
// values). Lane l reads the 16-byte chunks j = l + 32k (k < 4), which are
// tap (l >> 4) + 2k, channels 8 * (l & 15) .. + 8, and half-warp shuffles
// reduce the per-channel products.
//
// probe_level is a box stage of the phase probes' own (the TPU kernel's
// probes, scripts/dev/corr_variants.py), beside box_pass, not a prefix of
// it: one warp per edge streams the probe's box rows, then the rows of the
// windows that do not fit, through a ring of cp.async entries 4-8 deep
// (through L1), and stops each row after one phase (load, convert, shift,
// multiply on the CUDA cores, or the tap dot on the tensor cores as
// box_pass takes it).
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

// Bilinear blend of one window's 8x8 taps t (row stride ld) at blended
// position (dy, dx): y first, then x, in fp32.
__device__ __forceinline__ float blend(const float* t, int ld, float fx,
                                       float fy, int dy, int dx) {
  const float ty0 = (1.f - fy) * t[dy * ld + dx] + fy * t[(dy + 1) * ld + dx];
  const float ty1 = (1.f - fy) * t[dy * ld + dx + 1]
                    + fy * t[(dy + 1) * ld + dx + 1];
  return (1.f - fx) * ty0 + fx * ty1;
}

// --- the box stage (bf16) ---------------------------------------------------

constexpr int BOX_W = 16;         // box columns: two mma n-tiles of pixels
constexpr int BOX_H = 2 * D;      // most box rows
constexpr int TAP_LD = D * D + 4; // floats per window's taps; the pad
                                  // spreads one store's lanes over the banks

// One warp's shared memory for box_taps, with NS box row buffers (NS - 1
// rows in flight while one multiplies); 16-byte aligned, so the row
// buffers of every warp in an array are (cp.async, ldmatrix).
template <int NS>
struct __align__(16) BoxWarp {
  __nv_bfloat16 row[NS][BOX_W * C]; // box row buffers, 16-byte chunks
                                    // swizzled (swz)
  float taps[P2 * TAP_LD];          // window p's taps (ty, tx) at p * TAP_LD
  float fx[P2], fy[P2];             // fractional offsets per window
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes < 16 zero-fills.
// cp_async16 goes through L2 only; cp_async16_l1 is cached in L1 too.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l & 7 of matrix l >> 3. .trans transposes each matrix.
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// Element offset of 16-byte chunk ``chunk`` of row ``row`` in a buffer of
// ``chunks`` (a multiple of 8) chunks per row, the chunk index XORed with
// row & 7: ldmatrix's 8 rows at one chunk land in 8 different bank groups.
__device__ __forceinline__ int swz(int row, int chunk, int chunks) {
  return (row * chunks + (chunk ^ (row & 7))) * 8;
}

// The mma A fragments of one edge's 9 patch rows g (9 x C, rows 9-15
// zero) for the 8 k-steps of 16 channels.
__device__ __forceinline__ void patch_frags(const __nv_bfloat16* g,
                                            unsigned a[C / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const unsigned* r0 = reinterpret_cast<const unsigned*>(g + gr * C);
  const unsigned* r8 = reinterpret_cast<const unsigned*>(g + 8 * C);
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    const int w = ks * 8 + (lane & 3);      // channel pair 16 ks + 2 (l & 3)
    a[ks][0] = r0[w];
    a[ks][1] = gr == 0 ? r8[w] : 0u;
    a[ks][2] = r0[w + 4];
    a[ks][3] = gr == 0 ? r8[w + 4] : 0u;
  }
}

// One box pass: the products of the 9 patch rows with box rows
// [0, nrows) x columns [0, ncols) from ``box`` (ring row stride Wp pixels),
// each stored as tap (r - oy, px - ox) of window p where that lies in the
// window; lane p < 9 holds window p's (oy, ox) in this box. only_p < 0
// stores every window's taps, otherwise only that one's. Only the ncols
// (<= 16) pixels the windows read are loaded. Every step commits one
// cp.async group, empty past the last row, so one wait depth serves every
// step.
template <int NS>
__device__ __forceinline__ void box_pass(const unsigned a[C / 16][4],
                                         const __nv_bfloat16* box, int Wp,
                                         int nrows, int ncols, int only_p,
                                         int oy, int ox, BoxWarp<NS>& w) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int t = lane & 3;
  // this lane's accumulator rows are windows gr and (lane < 4) 8
  const int oy_g = __shfl_sync(0xffffffffu, oy, gr);
  const int ox_g = __shfl_sync(0xffffffffu, ox, gr);
  const int oy_8 = __shfl_sync(0xffffffffu, oy, 8);
  const int ox_8 = __shfl_sync(0xffffffffu, ox, 8);
  const bool st_g = only_p < 0 || only_p == gr;
  const bool st_8 = gr == 0 && (only_p < 0 || only_p == 8);
  auto load_row = [&](int r) {
    if (r < nrows) {
      const __nv_bfloat16* src = box + (long long)r * Wp * C;
      __nv_bfloat16* dst = w.row[r % NS];
#pragma unroll
      for (int i = 0; i < BOX_W * C / 8 / 32; ++i) {
        const int j = lane + 32 * i;        // 16-byte chunk of the row
        if ((j >> 4) < ncols)               // its pixel
          cp_async16(dst + swz(j >> 4, j & 15, C / 8), src + 8 * j);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int r = 0; r < NS - 1; ++r) load_row(r);
  for (int r = 0; r < nrows; ++r) {
    load_row(r + NS - 1);           // into the buffer row r - 1 used
    cp_async_wait<NS - 1>();        // row r has landed
    __syncwarp();
    const __nv_bfloat16* buf = w.row[r % NS];
    // lane l addresses pixel (l & 7) + 8 (l >> 4), chunk 2 ks + (l >> 3 & 1)
    const int px = (lane & 7) + 8 * (lane >> 4);
    const int half = (lane >> 3) & 1;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      unsigned b[4];
      ldmatrix_x4(b, buf + swz(px, 2 * ks + half, C / 8));
      mma_bf16(acc[0], a[ks], b[0], b[1]);
      if (ncols > 8) mma_bf16(acc[1], a[ks], b[2], b[3]);
    }
    const int ty_g = r - oy_g;
    const int ty_8 = r - oy_8;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = nt * 8 + 2 * t + h;
        if (st_g && (unsigned)ty_g < D && (unsigned)(col - ox_g) < D)
          w.taps[gr * TAP_LD + ty_g * D + col - ox_g] = acc[nt][h];
        if (st_8 && (unsigned)ty_8 < D && (unsigned)(col - ox_8) < D)
          w.taps[8 * TAP_LD + ty_8 * D + col - ox_8] = acc[nt][2 + h];
      }
    }
    __syncwarp();                   // the buffer is refilled next step
  }
}

// The taps of the 9 windows of one edge at one level into w.taps, and
// their fractions (w.fx, w.fy). fm is the edge's frame in the ring
// (Hp x Wp x C), c its coords (2, 9), scaled by ``scale`` for this level.
//
// The plan (window_boxes in ops/corr_cuda.py): y0 = min by, x0 =
// min(min bx, Wp - 16), nrows = min(max by - y0 + 8, 16), ncols =
// min(max bx - x0 + 8, 16); window p fits when bx_p - x0 <= 8 and
// by_p - y0 <= 8. The box lies inside the map: by <= Hp - 8, bx <= Wp - 8
// and Wp >= 16. A window that does not fit gets its own box: rows
// [by_p, by_p + 8), columns [px0, bx_p + 8) with px0 = min(bx_p, Wp - 16).
template <int NS>
__device__ __forceinline__ void level_taps(const unsigned a[C / 16][4],
                                           const __nv_bfloat16* fm,
                                           const float* c, float scale,
                                           int Hp, int Wp, BoxWarp<NS>& w) {
  const int lane = threadIdx.x & 31;
  const bool pix = lane < P2;
  int bx = 0, by = 0;
  if (pix) {
    float fx, fy;
    window_origin(c[lane] * scale, c[P2 + lane] * scale, Hp, Wp, bx, by,
                  fx, fy);
    w.fx[lane] = fx;
    w.fy[lane] = fy;
  }
  int x0 = pix ? bx : Wp, y0 = pix ? by : Hp;
  int xmax = pix ? bx : 0, ymax = pix ? by : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    xmax = max(xmax, __shfl_xor_sync(0xffffffffu, xmax, o));
    ymax = max(ymax, __shfl_xor_sync(0xffffffffu, ymax, o));
  }
  x0 = min(x0, Wp - BOX_W);
  const int nrows = min(ymax - y0 + D, BOX_H);
  const int ncols = min(xmax - x0 + D, BOX_W);
  const bool fits = bx - x0 <= D && by - y0 <= D;
  const unsigned own = __ballot_sync(0xffffffffu, pix && !fits);
  if (own != (1u << P2) - 1)        // a window left out stores no tap
    box_pass(a, fm + ((long long)y0 * Wp + x0) * C, Wp, nrows, ncols, -1,
             fits ? by - y0 : BOX_H, bx - x0, w);
  for (unsigned m = own; m; m &= m - 1) {
    const int p = __ffs(m) - 1;
    const int pbx = __shfl_sync(0xffffffffu, bx, p);
    const int pby = __shfl_sync(0xffffffffu, by, p);
    const int px0 = min(pbx, Wp - BOX_W);
    box_pass(a, fm + ((long long)pby * Wp + px0) * C, Wp, D,
             pbx - px0 + D, p, 0, pbx - px0, w);
  }
  __syncwarp();
}

// box_taps: one warp's edge at NL levels (level 1 samples c / 4 in the
// second ring). g is the edge's 9 patch rows (9 x C), f its ring slot, c
// its coords (2, 9). sink(k, v) takes each blended feature v in the raw
// (level, p, dy, dx) order, k < NL * 441, each from one lane.
template <int NL, int NS, typename Sink>
__device__ __forceinline__ void box_taps(
    const __nv_bfloat16* g, const __nv_bfloat16* fmap1,
    const __nv_bfloat16* fmap2, int f, const float* c, int Hp1, int Wp1,
    int Hp2, int Wp2, BoxWarp<NS>& w, Sink sink) {
  const int lane = threadIdx.x & 31;
  unsigned a[C / 16][4];
  patch_frags(g, a);
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const int Hp = l == 0 ? Hp1 : Hp2;
    const int Wp = l == 0 ? Wp1 : Wp2;
    const __nv_bfloat16* fm =
        (l == 0 ? fmap1 : fmap2) + (long long)f * Hp * Wp * C;
    level_taps(a, fm, c, l == 0 ? 1.f : 0.25f, Hp, Wp, w);
    for (int i = lane; i < P2 * DB * DB; i += 32) {
      const int p = i / (DB * DB);
      const int dy = (i % (DB * DB)) / DB;
      const int dx = i % DB;
      sink(l * P2 * DB * DB + i,
           blend(&w.taps[p * TAP_LD], D, w.fx[p], w.fy[p], dy, dx));
    }
    __syncwarp();                   // the next level rewrites the taps
  }
}

// --- the phase probes (D3) on the box stage ------------------------------

// The phase probes, in pipeline order.
enum Probe { P_LOAD = 0, P_CONVERT = 1, P_ROLL = 2, P_MULT_SUBL = 3,
             P_FULL_DOT = 4, N_PROBES = 5 };

// A probe's box plan and ring. load and convert read each window row from
// its 8-aligned origin xa = min(8 * (bx / 8), Wp - DW), DW pixels wide: their
// box starts at the smallest xa and spans up to 24 columns, and a window
// fits when xa - x0 is 0 or 8 (rows as in K1's plan). roll, mult_subl and
// full_dot read from bx, 8 pixels wide: K1's plan (level_taps). A box is
// read only when at least PROBE_MIN_FIT of the 9 windows fit it; otherwise
// (scattered pixels) every window is read on its own, since a box read for
// one or two windows costs more than their own rows. A window read on its
// own gives ring entries of own_rows rows of own_w pixels from xa (the
// pixels its probe reads: 1 for load and roll, 16 for convert, 8 for the
// products), so a window's 8 rows take 1 (load, roll), 8 (convert) or 4
// entries, and 2-5 entries stay in flight across windows.
// ops/corr_cuda.py window_boxes(aligned=..., min_fit=...) and PROBE_PLAN
// are the same plan in Python.
constexpr int PROBE_MIN_FIT = 5;

template <int PROBE>
struct ProbePlan {
  static constexpr bool aligned = PROBE == P_LOAD || PROBE == P_CONVERT;
  static constexpr int width = aligned ? DW : D;      // pixels read from xa
  static constexpr int box_w = aligned ? DW + D : BOX_W;
  static constexpr int own_w = PROBE == P_CONVERT ? DW
                               : (PROBE == P_LOAD || PROBE == P_ROLL) ? 1 : D;
  static constexpr int own_rows = own_w == 1 ? D : (own_w == D ? 2 : 1);
  // box rows buffered: a ring of 48 pixels a warp, so 4 blocks (16 warps)
  // share an SM; mult_subl's registers allow 3 blocks, and it buffers 64
  static constexpr int box_depth =
      aligned ? 2 : (PROBE == P_MULT_SUBL ? 4 : 3);
  static constexpr int blocks_per_sm = PROBE == P_MULT_SUBL ? 3 : 4;
  static constexpr int ring_px = box_depth * box_w;   // pixels per warp
  static constexpr int own_depth_max = ring_px / (own_rows * own_w);
  static constexpr int own_depth = own_depth_max < 8 ? own_depth_max : 8;
};

// A window read on its own: its probe index and the element offset of its
// first pixel (row by, column xa) in the level's ring map.
struct OwnWindow {
  long long off;
  int p;
  int pad;
};

// One warp's shared memory for a probe.
template <int PROBE>
struct __align__(16) ProbeWarp {
  __nv_bfloat16 ring[ProbePlan<PROBE>::ring_px * C];  // swizzled entries
  OwnWindow own[P2];
};

// Channels 4 lane .. +3 of pixel px of a ring entry (16-byte chunks
// swizzled by swz, 16 a pixel), in fp32: a warp reads one pixel's 256 bytes.
__device__ __forceinline__ float4 pix4(const __nv_bfloat16* e, int px) {
  const int lane = threadIdx.x & 31;
  const uint2 u = *reinterpret_cast<const uint2*>(
      e + swz(px, lane >> 1, C / 8) + 4 * (lane & 1));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The sum of pixels px0 .. px0 + 7 of a ring entry, in order.
__device__ __forceinline__ float4 sum8(const __nv_bfloat16* e, int px0) {
  float4 s = pix4(e, px0);
#pragma unroll
  for (int k = 1; k < D; ++k) s = add4(s, pix4(e, px0 + k));
  return s;
}

// Sum over pixels px0 .. px0 + 7 of pixel x g (fmaf, in order).
__device__ __forceinline__ float4 mult8(const __nv_bfloat16* e, int px0,
                                        float4 g) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float4 x = pix4(e, px0 + k);
    s.x = fmaf(x.x, g.x, s.x);
    s.y = fmaf(x.y, g.y, s.y);
    s.z = fmaf(x.z, g.z, s.z);
    s.w = fmaf(x.w, g.w, s.w);
  }
  return s;
}

// Entries [0, n) through a warp's ring of DEPTH entries, DEPTH - 1 in
// flight while one is used, copied through L1 (cp.async.ca): windows of
// nearby patches overlap, most of all at level 2, and L1 serves the
// overlap. An entry is ROWS ring rows ``stride`` elements
// apart, NPX pixels each from its first pixel (with ROWS = 1 the row may
// hold fewer: npx), stored as pixels r * NPX + x. src(i, ptr, npx) names
// entry i; use(i, entry) reads it. Every step commits one cp.async group,
// empty past the last entry, so one wait depth serves every step.
template <int DEPTH, int ROWS, int NPX, typename Src, typename Use>
__device__ __forceinline__ void stream_entries(__nv_bfloat16* ring, int n,
                                               long long stride, Src src,
                                               Use use) {
  constexpr int CH = C / 8;                   // 16-byte chunks a pixel
  const int lane = threadIdx.x & 31;
  auto load = [&](int i) {
    if (i < n) {
      const __nv_bfloat16* p;
      int npx = NPX;
      src(i, p, npx);
      __nv_bfloat16* dst = ring + (i % DEPTH) * ROWS * NPX * C;
#pragma unroll
      for (int k = 0; k < (ROWS * NPX * CH + 31) / 32; ++k) {
        const int j = lane + 32 * k;          // chunk of the entry
        const int r = j / (NPX * CH);
        const int c = j % (NPX * CH);
        if (ROWS > 1 ? r < ROWS : c < npx * CH)
          cp_async16_l1(dst + swz(r * NPX + c / CH, c % CH, CH),
                        p + r * stride + 8 * c);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < DEPTH - 1; ++i) load(i);
  for (int i = 0; i < n; ++i) {
    load(i + DEPTH - 1);              // into the entry i - 1 used
    cp_async_wait<DEPTH - 1>();       // entry i has landed
    __syncwarp();
    use(i, ring + (i % DEPTH) * ROWS * NPX * C);
    __syncwarp();                     // the entry is refilled next step
  }
}

// Where a probe's values go: the edge's (2, 9, 8, 128) output block, or
// (out == nullptr) a comparison with never, a NaN, so that every value is
// computed and almost none is stored (the TPU probe's constant block).
struct ProbeSink {
  float* out;
  float never;
  bool hit;
  __device__ __forceinline__ void put4(int l, int p, int ty, float4 v) {
    if (out) {
      reinterpret_cast<float4*>(out + ((l * P2 + p) * D + ty) * C)
          [threadIdx.x & 31] = v;
    } else {
      hit |= (v.x == never) | (v.y == never) | (v.z == never)
             | (v.w == never);
    }
  }
  __device__ __forceinline__ void put1(int l, int p, int ty, int tx,
                                       float v) {
    if (out) out[((l * P2 + p) * D + ty) * C + tx] = v;
    else hit |= v == never;
  }
};

// The tap products of ring entry e's pixels 0 .. 15 (0 .. 7 when !WIDE)
// with the 9 patch rows: acc[nt][0..1] for window gr = lane >> 2,
// acc[nt][2..3] for window 8 (lanes 0-3), pixel nt * 8 + 2 (lane & 3) + h,
// as in box_pass. The two n-tiles are independent chains.
template <bool WIDE>
__device__ __forceinline__ void row_mma(const unsigned a[C / 16][4],
                                        const __nv_bfloat16* e,
                                        float acc[2][4]) {
  const int lane = threadIdx.x & 31;
  const int px = (lane & 7) + (WIDE ? 8 * (lane >> 4) : 0);
  const int half = (lane >> 3) & 1;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[nt][k] = 0.f;
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    unsigned b[4];
    ldmatrix_x4(b, e + swz(px, 2 * ks + half, C / 8));
    mma_bf16(acc[0], a[ks], b[0], b[1]);
    if (WIDE) mma_bf16(acc[1], a[ks], b[2], b[3]);
  }
}

// One probe at one level of one edge (the warp's): window origins as
// window_origin gives them (c scaled by ``scale``), the probe's box plan,
// then its box rows and its other windows' own rows streamed through the
// ring, each row taken up to the probe's phase:
//   P_LOAD       pixel xa of each window row;
//   P_CONVERT    the sum of its 16 pixels from xa, fp32 (two 8-pixel sums:
//                the box's 8-pixel blocks are shared by its windows);
//   P_ROLL       pixel bx;
//   P_MULT_SUBL  the sum over its 8 pixels from bx of pixel x g (CUDA
//                cores);
//   P_FULL_DOT   the 8 taps g . pixel on the tensor cores (box_pass's mma;
//                a window read on its own takes two of its rows a step,
//                one per n-tile).
// a: the patch rows' mma fragments (P_FULL_DOT), gv: lane's 4 channels of
// each patch row (P_MULT_SUBL).
template <int PROBE>
__device__ __forceinline__ void probe_level(
    const unsigned a[C / 16][4], const float4 gv[P2],
    const __nv_bfloat16* fm, const float* c, float scale, int Hp, int Wp,
    int l, ProbeWarp<PROBE>& w, ProbeSink& sink) {
  using PP = ProbePlan<PROBE>;
  const int lane = threadIdx.x & 31;
  const bool pix = lane < P2;
  int bx = 0, by = 0;
  if (pix) {
    float fx, fy;
    window_origin(c[lane] * scale, c[P2 + lane] * scale, Hp, Wp, bx, by,
                  fx, fy);
  }
  const int xa = PP::aligned ? min((bx / 8) * 8, Wp - DW) : bx;
  int x0 = pix ? xa : Wp, y0 = pix ? by : Hp;
  int xmax = pix ? xa : 0, ymax = pix ? by : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    xmax = max(xmax, __shfl_xor_sync(0xffffffffu, xmax, o));
    ymax = max(ymax, __shfl_xor_sync(0xffffffffu, ymax, o));
  }
  if (!PP::aligned) x0 = min(x0, Wp - BOX_W);
  const int nrows = min(ymax - y0 + D, BOX_H);
  const int ncols = min(xmax - x0 + PP::width, PP::box_w);
  const int dx = xa - x0;
  const bool fits = (PP::aligned ? (dx == 0 || dx == D) : dx <= D)
                    && by - y0 <= D;
  unsigned own = __ballot_sync(0xffffffffu, pix && !fits) & 0x1ffu;
  if (P2 - __popc(own) < PROBE_MIN_FIT) own = (1u << P2) - 1;
  // each window's origin in the box (rows past every box row when it is
  // read on its own), in every lane
  int oy[P2], ox[P2];
#pragma unroll
  for (int p = 0; p < P2; ++p) {
    oy[p] = __shfl_sync(0xffffffffu, by - y0, p);
    if (own >> p & 1) oy[p] = 1 << 20;
    ox[p] = __shfl_sync(0xffffffffu, dx, p);
  }
  const int gr = lane >> 2;         // full_dot: the windows of this lane's
  int oy_g = oy[0], ox_g = ox[0];   // accumulator rows, gr (0 .. 7) and 8
#pragma unroll
  for (int p = 1; p < P2 - 1; ++p)
    if (gr == p) { oy_g = oy[p]; ox_g = ox[p]; }
  const int oy_8 = oy[8], ox_8 = ox[8];
  const long long stride = (long long)Wp * C;

  if (own != (1u << P2) - 1) {
    const __nv_bfloat16* box = fm + ((long long)y0 * Wp + x0) * C;
    stream_entries<PP::box_depth, 1, PP::box_w>(
        w.ring, nrows, stride,
        [&](int i, const __nv_bfloat16*& src, int& npx) {
          src = box + i * stride;
          npx = ncols;
        },
        [&](int r, const __nv_bfloat16* e) {
          if constexpr (PROBE == P_FULL_DOT) {
            float acc[2][4];
            if (ncols > 8) row_mma<true>(a, e, acc);
            else row_mma<false>(a, e, acc);
            const int ty_g = r - oy_g;
            const int ty_8 = r - oy_8;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int col = nt * 8 + 2 * (lane & 3) + h;
                if ((unsigned)ty_g < D && (unsigned)(col - ox_g) < D)
                  sink.put1(l, gr, ty_g, col - ox_g, acc[nt][h]);
                if (gr == 0 && (unsigned)ty_8 < D
                    && (unsigned)(col - ox_8) < D)
                  sink.put1(l, 8, ty_8, col - ox_8, acc[nt][2 + h]);
              }
          } else if constexpr (PROBE == P_CONVERT) {
            const float4 b0 = sum8(e, 0);
            const float4 b1 = sum8(e, D);
            const float4 b2 = ncols > DW ? sum8(e, DW)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 s0 = add4(b0, b1);
            const float4 s1 = add4(b1, b2);
#pragma unroll
            for (int p = 0; p < P2; ++p) {
              const int ty = r - oy[p];
              if ((unsigned)ty < D) sink.put4(l, p, ty, ox[p] ? s1 : s0);
            }
          } else {
#pragma unroll
            for (int p = 0; p < P2; ++p) {
              const int ty = r - oy[p];
              if ((unsigned)ty >= D) continue;
              if constexpr (PROBE == P_MULT_SUBL)
                sink.put4(l, p, ty, mult8(e, ox[p], gv[p]));
              else
                sink.put4(l, p, ty, pix4(e, ox[p]));
            }
          }
        });
  }

  // the windows read on their own: their table, then their entries back to
  // back, DEPTH - 1 entries in flight across windows
  if (pix && (own >> lane & 1))
    w.own[__popc(own & ((1u << lane) - 1))] =
        OwnWindow{(long long)by * Wp * C + (long long)xa * C, lane, 0};
  __syncwarp();
  constexpr int EPW = D / PP::own_rows;             // entries a window
  stream_entries<PP::own_depth, PP::own_rows, PP::own_w>(
      w.ring, __popc(own) * EPW, stride,
      [&](int i, const __nv_bfloat16*& src, int& npx) {
        src = fm + w.own[i / EPW].off + (i % EPW) * PP::own_rows * stride;
      },
      [&](int i, const __nv_bfloat16* e) {
        const int p = w.own[i / EPW].p;
        const int ty0 = (i % EPW) * PP::own_rows;
        if constexpr (PROBE == P_FULL_DOT) {
          float acc[2][4];                  // n-tile t: row ty0 + t
          row_mma<true>(a, e, acc);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int tx = 2 * (lane & 3) + h;
              if (gr == p) sink.put1(l, p, ty0 + nt, tx, acc[nt][h]);
              if (p == 8 && gr == 0)
                sink.put1(l, p, ty0 + nt, tx, acc[nt][2 + h]);
            }
        } else if constexpr (PROBE == P_CONVERT) {
          sink.put4(l, p, ty0, add4(sum8(e, 0), sum8(e, D)));
        } else if constexpr (PROBE == P_MULT_SUBL) {
          float4 g = gv[0];
#pragma unroll
          for (int q = 1; q < P2; ++q)
            if (q == p) g = gv[q];
#pragma unroll
          for (int r = 0; r < PP::own_rows; ++r)
            sink.put4(l, p, ty0 + r, mult8(e, r * D, g));
        } else {                            // load, roll: 8 rows of 1 pixel
#pragma unroll
          for (int r = 0; r < D; ++r) sink.put4(l, p, r, pix4(e, r));
        }
      });
  __syncwarp();                     // the next level rewrites the table
}

}  // namespace corr

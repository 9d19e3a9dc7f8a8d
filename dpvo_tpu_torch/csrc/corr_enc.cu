// Two-level patch correlation fused with the corr encoder's first matmul.
//
// Replaces dpvo_tpu/ops/corr_pallas.py:corr_pallas_enc (_kernel_fused_v13).
// For every edge e and each of its 9 patch pixels p, at both pyramid levels:
//   - take the patch feature row g = g_all[kk[e], p] (C = 128 channels);
//   - dot it with the 8x8 tap window of the zero-padded feature map
//     fmap_l[ff[e]] starting at clamp(floor(c_l) + PAD - R) (level 2 uses
//     c / 4 against fmap2's own padding);
//   - bilinear-blend the 8x8 taps to 7x7 with the fractional part of c_l.
// The 882 blended features of an edge, rounded once to the compute type,
// are contracted in-kernel with the (882, DIMo) corr1 kernel whose rows are
// in the raw (level, p, dy, dx) order (corr1 rows permuted by
// raw_to_ref_perm). Output: (E, DIMo) pre-bias activations in the compute
// type, fp32 accumulation, one rounding at the store.
//
// What bounds it on an H100: bytes. Each touched window pixel, g row and
// weight read once, and the output written once, come to 118 MB at the
// lagged merge's 14336 edges: 0.0354 ms at 3.35 TB/s. Its 13.9 GFLOP (taps
// 0.3 and the 882 -> 384 product 0.68 MFLOP per edge) take 14 us on the
// bf16 tensor cores (989 TFLOP/s). (chip_smoke.py's bound, NVIDIA H100
// 80GB HBM3 at 700 W.)
//
// What the bf16 design does about it (corr_enc_bf16_kernel):
//   - one block owns EB = 64 edges (four m16 tiles), 8 warps;
//   - the window stage is corr_window.cuh's box stage: one warp per edge
//     reads each patch's box of ring rows once per level (45-48 KB per
//     edge from L2, against about 295 KB when every window row was reread
//     for every pixel whose window covers it) and takes the taps on the
//     tensor cores;
//   - the blended features, rounded to bf16, stay in shared memory as
//     feat[64][896] (columns 882-895 zero, rows past E zero), swizzled for
//     ldmatrix;
//   - the product runs on the tensor cores (mma.sync m16n8k16, fp32
//     accumulation): the weights stream through shared memory in k-chunks
//     of 32 rows, a ring of 3 cp.async stages in the shared memory the
//     window stage used, one block barrier per chunk (rows past 882 read
//     as zero), read with ldmatrix.trans; each warp owns 48 of the 384
//     output columns for the four m-tiles. The weights are read from L2
//     once per 64 edges: 0.15 GB at 14336 edges against 1.2 GB at 8 edges
//     a block. DIMo is taken in passes of 384 columns and must be a
//     multiple of 16.
// What bounds it now: L2 traffic and latency. The window stage moves
// about 0.7 GB at 14336 edges and the product 0.15 GB, one after the
// other within a block (the 115 KB feature tile leaves room for one block
// an SM), so the two phases do not overlap (PERF.md).
//
// fp32 (corr_enc_kernel<float>, MIXED_PRECISION=False): the per-window-row
// stage and CUDA-core FMAs for the taps and the product, 8 edges a block.
// Tensor cores would take fp32 as TF32 and break the fp32 card engine's
// agreement with the CPU engine.
//
// Rows past E are skipped. Every row below E is computed as given: the
// engine runs at an edge bucket, whose rows past the live count carry
// patch 0, ring slot 0 and finite coordinates, and masks their outputs
// after the update (engine/kernels.py:update_step_dev). Non-finite
// coordinates are clamped in float before the int conversion, so they read
// a window inside the padded map (never out of bounds); their fractional
// part is NaN, and so is their output row.
#include "corr_window.cuh"

namespace {

using namespace corr;

constexpr int NL = 2;             // pyramid levels
constexpr int FEAT = NL * P2 * DB * DB;   // 882 features per edge
constexpr int TAPS = NL * P2 * D * D;     // 1152 taps per edge
constexpr int EB = 8;             // edges per block (fp32)
constexpr int NT = 192;           // threads per block (fp32)

struct Shared {
  float taps[EB][TAPS];          // (level, p, ty, tx) per edge
  float feat[FEAT][EB];          // blended features, edge-minor
  long long win[EB][NL * P2];    // element offset of each window's origin
  float fx[EB][NL * P2];         // fractional x per (level, p)
  float fy[EB][NL * P2];
  long long grow[EB];            // element offset of g_all[kk[e]]
};

template <typename T>
__global__ void __launch_bounds__(NT)
corr_enc_kernel(const T* __restrict__ g_all, const int* __restrict__ kk,
                const int* __restrict__ ff, const T* __restrict__ w,
                const T* __restrict__ fmap1, const T* __restrict__ fmap2,
                const float* __restrict__ coords, T* __restrict__ out,
                int E, int Hp1, int Wp1, int Hp2, int Wp2, int DIMo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& s = *reinterpret_cast<Shared*>(smem_raw);
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * EB;
  const int n_here = E - e0;

  window_meta<NL, EB, NT>(coords, ff, e0, n_here, Hp1, Wp1, Hp2, Wp2,
                          s.win, s.fx, s.fy);
  if (tid < EB) {
    const int edge = e0 + tid;
    s.grow[tid] = edge < E ? (long long)kk[edge] * P2 * C : 0;
  }
  __syncthreads();

  window_taps<T, NL, EB, NT>(g_all, s.grow, fmap1, fmap2, Wp1, Wp2, n_here,
                             s.win, s.taps);
  __syncthreads();

  // --- bilinear blend 8x8 -> 7x7, rounded to the compute type ---
  for (int i = tid; i < EB * FEAT; i += NT) {
    const int e = i / FEAT;
    const int r = i % FEAT;            // raw (level, p, dy, dx) index
    const int lp = r / (DB * DB);
    const int dy = (r % (DB * DB)) / DB;
    const int dx = r % DB;
    const float v = blend(&s.taps[e][lp * D * D], D, s.fx[e][lp],
                          s.fy[e][lp], dy, dx);
    s.feat[r][e] = to_f(from_f<T>(v));
  }
  __syncthreads();

  // --- encoder product: out[e, o] = sum_r feat[r, e] * w[r, o] ---
  for (int o0 = 0; o0 < DIMo; o0 += 2 * NT) {
    const int oa = o0 + tid;
    const int ob = o0 + tid + NT;
    const bool va = oa < DIMo;
    const bool vb = ob < DIMo;
    float acc_a[EB], acc_b[EB];
#pragma unroll
    for (int e = 0; e < EB; ++e) { acc_a[e] = 0.f; acc_b[e] = 0.f; }
#pragma unroll 2
    for (int r = 0; r < FEAT; ++r) {
      const float wa = va ? to_f(w[(size_t)r * DIMo + oa]) : 0.f;
      const float wb = vb ? to_f(w[(size_t)r * DIMo + ob]) : 0.f;
      const float4 f0 = reinterpret_cast<const float4*>(s.feat[r])[0];
      const float4 f1 = reinterpret_cast<const float4*>(s.feat[r])[1];
      const float f[EB] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        acc_a[e] = fmaf(f[e], wa, acc_a[e]);
        acc_b[e] = fmaf(f[e], wb, acc_b[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int edge = e0 + e;
      if (edge >= E) continue;
      if (va) out[(size_t)edge * DIMo + oa] = from_f<T>(acc_a[e]);
      if (vb) out[(size_t)edge * DIMo + ob] = from_f<T>(acc_b[e]);
    }
  }
}

// --- bf16: box window stage and the product on the tensor cores ----------

constexpr int EB_BOX = 64;        // edges per block: four m16 tiles
constexpr int MT = EB_BOX / 16;   // m16 tiles
constexpr int NW_BOX = 8;           // warps per block
constexpr int FEAT_K = 896;       // feature columns, 882 padded to 28 * 32
constexpr int KC = 32;            // weight rows per cp.async stage
constexpr int NP = 384;           // output columns per pass
constexpr int PAIRS = NP / 16 / NW_BOX;   // n-tile pairs per warp and pass (3)
constexpr int NS = 2;             // box row buffers per warp
constexpr int WS = 3;             // weight stages: 2 chunks in flight

struct SharedBf16 {
  __nv_bfloat16 feat[EB_BOX * FEAT_K];    // (edge, k), swizzled (swz)
  union {
    BoxWarp<NS> warp[NW_BOX];             // window stage, one per warp
    __nv_bfloat16 w[WS][KC * NP];       // weight stages (k, n), swizzled
  } u;
};
static_assert(sizeof(SharedBf16) <= 232448, "a block's shared memory");

__global__ void __launch_bounds__(NW_BOX * 32, 1)
corr_enc_bf16_kernel(const __nv_bfloat16* __restrict__ g_all,
                     const int* __restrict__ kk, const int* __restrict__ ff,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ fmap1,
                     const __nv_bfloat16* __restrict__ fmap2,
                     const float* __restrict__ coords,
                     __nv_bfloat16* __restrict__ out, int E, int Hp1,
                     int Wp1, int Hp2, int Wp2, int DIMo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SharedBf16& s = *reinterpret_cast<SharedBf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int e0 = blockIdx.x * EB_BOX;
  const int n_here = min(EB_BOX, E - e0);

  // the pad columns and the rows past E stay zero
  for (int i = tid; i < EB_BOX * FEAT_K / 8; i += NW_BOX * 32)
    reinterpret_cast<uint4*>(s.feat)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // --- window stage: one warp per edge, features rounded to bf16 ---
  for (int e = warp; e < n_here; e += NW_BOX) {
    const int edge = e0 + e;
    box_taps<NL, NS>(g_all + (size_t)kk[edge] * P2 * C, fmap1, fmap2,
                     ff[edge], coords + (size_t)edge * 2 * P2, Hp1, Wp1, Hp2,
                     Wp2, s.u.warp[warp], [&](int k, float v) {
                       s.feat[swz(e, k >> 3, FEAT_K / 8) + (k & 7)] =
                           __float2bfloat16_rn(v);
                     });
  }
  __syncthreads();

  // --- encoder product: out[e, n] = sum_k feat[e, k] * w[k, n] ---
  const int gr = lane >> 2;
  const int t = lane & 3;
  for (int n0 = 0; n0 < DIMo; n0 += NP) {
    const int nchunks = min(NP, DIMo - n0) / 8;   // 16-byte column chunks
    const int npairs = nchunks / 2;               // n-tile pairs
    // one cp.async group per chunk, empty past the last
    auto load_w = [&](int kc) {
      __nv_bfloat16* dst = s.u.w[kc % WS];
      for (int i = tid; kc < FEAT_K / KC && i < KC * (NP / 8);
           i += NW_BOX * 32) {
        const int r = i / (NP / 8);
        const int ch = i % (NP / 8);
        const int k = kc * KC + r;
        const bool live = k < FEAT;
        if (ch < nchunks)
          cp_async16(dst + swz(r, ch, NP / 8),
                     w + (size_t)(live ? k : 0) * DIMo + n0 + 8 * ch,
                     live ? 16 : 0);
      }
      cp_async_commit();
    };
    float acc[MT][2 * PAIRS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2 * PAIRS; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
    for (int kc = 0; kc < WS - 1; ++kc) load_w(kc);
    for (int kc = 0; kc < FEAT_K / KC; ++kc) {
      cp_async_wait<WS - 2>();        // chunk kc has landed
      __syncthreads();                // for every thread; chunk kc - 1 done
      load_w(kc + WS - 1);            // into the stage chunk kc - 1 used
      const __nv_bfloat16* ws = s.u.w[kc % WS];
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        const int k = kc * KC + ks * 16;
        unsigned af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)  // rows mt*16 + (l & 15), k half l>>4
          ldmatrix_x4(af[mt], s.feat + swz(mt * 16 + (lane & 15),
                                           (k >> 3) + (lane >> 4),
                                           FEAT_K / 8));
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) {
          const int q = warp + NW_BOX * j;        // this warp's n-tile pair
          if (q < npairs) {
            // k row ks*16 + (l & 7) + 8 (l >> 3 & 1), column chunk
            // 2q + (l >> 4): b0, b1 of n-tiles 2q and 2q + 1
            unsigned b[4];
            ldmatrix_x4_trans(b, ws + swz(ks * 16 + (lane & 7)
                                              + 8 * ((lane >> 3) & 1),
                                          2 * q + (lane >> 4), NP / 8));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][2 * j], af[mt], b[0], b[1]);
              mma_bf16(acc[mt][2 * j + 1], af[mt], b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();                    // the next pass refills the stages
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      const int q = warp + NW_BOX * j;
      if (q >= npairs) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 16 * q + 8 * h + 2 * t;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int m = e0 + mt * 16 + gr;
          if (m < E)
            *reinterpret_cast<__nv_bfloat162*>(&out[(size_t)m * DIMo + col])
                = __floats2bfloat162_rn(acc[mt][2 * j + h][0],
                                        acc[mt][2 * j + h][1]);
          if (m + 8 < E)
            *reinterpret_cast<__nv_bfloat162*>(
                &out[(size_t)(m + 8) * DIMo + col])
                = __floats2bfloat162_rn(acc[mt][2 * j + h][2],
                                        acc[mt][2 * j + h][3]);
        }
      }
    }
  }
}

int launch_f32(const void* g_all, const void* kk, const void* ff,
               const void* w, const void* fmap1, const void* fmap2,
               const void* coords, void* out, int E, int Hp1, int Wp1,
               int Hp2, int Wp2, int DIMo, void* stream) {
  const int smem = (int)sizeof(Shared);
  cudaError_t err = cudaFuncSetAttribute(
      corr_enc_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (E > 0) {
    const int blocks = (E + EB - 1) / EB;
    corr_enc_kernel<float><<<blocks, NT, smem, (cudaStream_t)stream>>>(
        (const float*)g_all, (const int*)kk, (const int*)ff,
        (const float*)w, (const float*)fmap1, (const float*)fmap2,
        (const float*)coords, (float*)out, E, Hp1, Wp1, Hp2, Wp2, DIMo);
  }
  return (int)cudaGetLastError();
}

int launch_bf16(const void* g_all, const void* kk, const void* ff,
                const void* w, const void* fmap1, const void* fmap2,
                const void* coords, void* out, int E, int Hp1, int Wp1,
                int Hp2, int Wp2, int DIMo, void* stream) {
  if (DIMo <= 0 || DIMo % 16 || min(Wp1, Wp2) < BOX_W)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(SharedBf16);
  cudaError_t err = cudaFuncSetAttribute(
      corr_enc_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (E > 0) {
    const int blocks = (E + EB_BOX - 1) / EB_BOX;
    corr_enc_bf16_kernel<<<blocks, NW_BOX * 32, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)g_all, (const int*)kk, (const int*)ff,
        (const __nv_bfloat16*)w, (const __nv_bfloat16*)fmap1,
        (const __nv_bfloat16*)fmap2, (const float*)coords,
        (__nv_bfloat16*)out, E, Hp1, Wp1, Hp2, Wp2, DIMo);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous tensors:
//   g_all (K, 9, 128), kk (E,) int32, ff (E,) int32 ring slots,
//   w (882, DIMo) raw-row-ordered corr1 kernel, fmap1 (F, Hp1, Wp1, 128),
//   fmap2 (F, Hp2, Wp2, 128), coords (E, 2, 3, 3) fp32, out (E, DIMo).
// bf16 pointers 16-byte aligned, DIMo a multiple of 16, Wp1, Wp2 >= 16.
// Returns the cudaGetLastError() code of the launch (0 on success),
// cudaErrorInvalidValue for a bf16 shape the kernel does not take.
int dpvo_corr_enc_f32(const void* g_all, const void* kk, const void* ff,
                      const void* w, const void* fmap1, const void* fmap2,
                      const void* coords, void* out, int E, int Hp1, int Wp1,
                      int Hp2, int Wp2, int DIMo, void* stream) {
  return launch_f32(g_all, kk, ff, w, fmap1, fmap2, coords, out, E, Hp1,
                    Wp1, Hp2, Wp2, DIMo, stream);
}

int dpvo_corr_enc_bf16(const void* g_all, const void* kk, const void* ff,
                       const void* w, const void* fmap1, const void* fmap2,
                       const void* coords, void* out, int E, int Hp1, int Wp1,
                       int Hp2, int Wp2, int DIMo, void* stream) {
  return launch_bf16(g_all, kk, ff, w, fmap1, fmap2, coords, out, E, Hp1,
                     Wp1, Hp2, Wp2, DIMo, stream);
}

}  // extern "C"

// Two-level patch correlation fused with the corr encoder's first matmul.
//
// Replaces dpvo_tpu/ops/corr_pallas.py:corr_pallas_enc (_kernel_fused_v13).
// For every edge e and each of its 9 patch pixels p, at both pyramid levels:
//   - take the patch feature row g = g_all[kk[e], p] (C = 128 channels);
//   - dot it with the 8x8 tap window of the zero-padded feature map
//     fmap_l[ff[e]] starting at clamp(floor(c_l) + PAD - R) (level 2 uses
//     c / 4 against fmap2's own padding);
//   - bilinear-blend the 8x8 taps to 7x7 with the fractional part of c_l.
// The 882 blended features of an edge, rounded to the compute type, are
// contracted in-kernel with the (882, DIMo) corr1 kernel whose rows are in
// the raw (level, p, dy, dx) order (corr1 rows permuted by raw_to_ref_perm).
// Output: (E, DIMo) pre-bias activations in the compute type.
//
// What bounds it on an H100: the bytes it must move are few. Neighbouring
// patch pixels' windows overlap, and the feature rings and the gmap ring
// (about 8 MB at 3456 patches) fit the 50 MB L2, so each touched window
// pixel, g row and weight is read from device memory about once: ~58 MB at
// 6144 edges, 17 us at 3.35 TB/s. The work is ~1 MFLOP per edge (taps 0.3,
// the 882 -> 384 product 0.68), 6 GFLOP at 6144 edges: 6 us on the bf16
// tensor cores. This first version does all of it as fp32 FMAs on the CUDA
// cores (67 TFLOP/s) and rereads overlapping windows from L2, so FMA rate
// and L2 traffic bound it, far above the bound (times in PERF.md).
// What the design does about it: one block owns EB = 8 edges. Each warp
// reads one window row (8 taps x 128 channels, 1024 contiguous values) with
// fully coalesced 16-byte loads and reduces the per-channel products with
// half-warp shuffles. The taps, then the blended features, stay in shared
// memory; the encoder product streams the weight rows once per block and
// reuses each weight for all EB edges from registers, so the weight traffic
// is 1/EB of a per-edge product. Accumulation is fp32 throughout.
//
// Rows past E are skipped. Every row below E is computed as given: the
// engine runs at its live edge count, so all rows are live. Non-finite
// coordinates are clamped in float before the int conversion, so they read
// a window inside the padded map (never out of bounds); their fractional
// part is NaN, and so is their output row.
#include "corr_window.cuh"

namespace {

using namespace corr;

constexpr int NL = 2;             // pyramid levels
constexpr int FEAT = NL * P2 * DB * DB;   // 882 features per edge
constexpr int TAPS = NL * P2 * D * D;     // 1152 taps per edge
constexpr int EB = 8;             // edges per block
constexpr int NT = 192;           // threads per block

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
    const float v = blend(&s.taps[e][lp * D * D], s.fx[e][lp], s.fy[e][lp],
                          dy, dx);
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

template <typename T>
int launch(const void* g_all, const void* kk, const void* ff, const void* w,
           const void* fmap1, const void* fmap2, const void* coords,
           void* out, int E, int Hp1, int Wp1, int Hp2, int Wp2, int DIMo,
           void* stream) {
  const int smem = (int)sizeof(Shared);
  cudaError_t err = cudaFuncSetAttribute(
      corr_enc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (E > 0) {
    const int blocks = (E + EB - 1) / EB;
    corr_enc_kernel<T><<<blocks, NT, smem, (cudaStream_t)stream>>>(
        (const T*)g_all, (const int*)kk, (const int*)ff, (const T*)w,
        (const T*)fmap1, (const T*)fmap2, (const float*)coords, (T*)out, E,
        Hp1, Wp1, Hp2, Wp2, DIMo);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous tensors:
//   g_all (K, 9, 128), kk (E,) int32, ff (E,) int32 ring slots,
//   w (882, DIMo) raw-row-ordered corr1 kernel, fmap1 (F, Hp1, Wp1, 128),
//   fmap2 (F, Hp2, Wp2, 128), coords (E, 2, 3, 3) fp32, out (E, DIMo).
// Returns the cudaGetLastError() code of the launch (0 on success).
int dpvo_corr_enc_f32(const void* g_all, const void* kk, const void* ff,
                      const void* w, const void* fmap1, const void* fmap2,
                      const void* coords, void* out, int E, int Hp1, int Wp1,
                      int Hp2, int Wp2, int DIMo, void* stream) {
  return launch<float>(g_all, kk, ff, w, fmap1, fmap2, coords, out, E, Hp1,
                       Wp1, Hp2, Wp2, DIMo, stream);
}

int dpvo_corr_enc_bf16(const void* g_all, const void* kk, const void* ff,
                       const void* w, const void* fmap1, const void* fmap2,
                       const void* coords, void* out, int E, int Hp1, int Wp1,
                       int Hp2, int Wp2, int DIMo, void* stream) {
  return launch<__nv_bfloat16>(g_all, kk, ff, w, fmap1, fmap2, coords, out,
                               E, Hp1, Wp1, Hp2, Wp2, DIMo, stream);
}

}  // extern "C"

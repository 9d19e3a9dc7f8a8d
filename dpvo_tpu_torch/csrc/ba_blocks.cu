// Local BA's normal equations from per-edge 6-wide blocks
// (dpvo_tpu_torch/ops/ba_cuda.py, called by ops/ba.py:ba_iterative once per
// Gauss-Newton iteration).
//
// Replaces no TPU kernel: the JAX package's ba_iterative (dpvo_tpu/ops/ba.py)
// builds the effective pose Jacobian over the whole window as dense one-hot
// blocks, (E, 2, 6 n_cap), and leaves the sums to XLA's einsums, one GEMM and
// the coupling segment sums (agg_pallas.segment_sums). Ported as written, that
// form moved ~0.55 GB of fp32 per iteration at the retain bucket (E = 49152,
// n_cap = 16) for outputs of under 2 MB, and its edge terms took some 40
// small launches. Each edge only touches two 6-wide pose blocks and one
// depth, so this kernel computes an edge's terms in registers (what
// ops/ba.py:_edge_terms_center computes: the relative pose of its frame pair,
// residual, robust mask, Ji, Jj, Jz at the patch centre) and sums them into
// the two tables the Schur solve needs, nothing per edge written back:
//
//   ecu (k_cap, 6 n_cap + 2): per patch rank g, the coupling row
//       sum_e w Jz^T (-Ji) at pose block a_e, + w Jz^T Jj at block b_e
//       (added one after the other, so a self-edge a == b sums both), then
//       C = sum w Jz^2 and u = sum w r Jz;
//   blocks ((n_cap + 1)^2, 120): per window frame pair (a, b), the index
//       n_cap standing for every frame outside the window:
//       [Hii (36) | gi (6) | Hjj (36) | gj (6) | Hij (36)] with Ai = -Ji,
//       Aj = Jj, Hii = sum w Ai^T Ai, Hij = sum w Ai^T Aj, Hjj = sum w Aj^T Aj,
//       gi = sum w Ai^T r, gj = sum w Aj^T r; the Ai parts are zero where a is
//       outside the window, the Aj parts where b is. ops/ba_cuda.assemble adds
//       them into B and v. The pair (n_cap, n_cap) and the masked rows are
//       dropped (written as zeros).
//
// edges (E, 4) int32 in kk order: ii, jj, kk, pair = a * (n_cap + 1) + b
// (a = ii - t0 inside [0, n_cap), else n_cap; b likewise for jj), or
// (n_cap + 1)^2 on a masked row; tw (E, 4) fp32: target x, y, weight x, y;
// pstart (k_cap + 1): each patch rank's rows [pstart[g], pstart[g + 1]);
// kperm (E) the rows sorted by pair, kstart ((n_cap + 1)^2 + 1) each pair's
// run in kperm.
//
// What bounds it: the inputs are ~48 bytes an edge (edges, tw, its pair
// index, the patch centre; the poses stay in L1/L2) and the outputs
// (k_cap + 289) rows, so at 45312 live edges ~3.4 MB: ~1 us at 3.35 TB/s.
// The sums are ~420 fp32 operations an edge and its terms ~260, formed once
// for each table: ~0.8 us at 67 TFLOP/s. So it is bound by latency: a
// block's dependent global loads (starts, then the rows, then the poses and
// the centre) and the sums in a fixed order, which have to run serially
// somewhere. The design keeps both short: every block reads its run bounds
// from a table made once per BA call, the pair blocks (one per frame pair,
// ~96 edges each in the retain traffic, ~1000 for the pairs with a frame
// outside the window) spread a run over 128 threads and reduce with a fixed
// shuffle tree, and the patch warps (~21 edges a patch) compute one edge a
// lane and add the lanes' 14 values into a shared-memory row in lane order.
// No atomics: two launches on the same inputs give the same bits.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 128;                 // threads per block
constexpr int WARPS = NT / 32;
constexpr int MAX_N = 32;               // largest n_cap
constexpr int ROW = 6 * MAX_N + 2;      // longest coupling row
constexpr int PATCHES_PER_WARP = 4;     // patch ranks a warp walks, at most
constexpr int PAIR_COLS = 120;          // floats of a pair's row
constexpr int ACC = 90;                 // a pair's distinct sums

// upper-triangle index of (k, l), k <= l, in a row-major 21-entry list
__host__ __device__ constexpr int tri(int k, int l) {
  return k * 6 - k * (k - 1) / 2 + (l - k);
}
constexpr int A_HII = 0, A_HIJ = 21, A_HJJ = 57, A_GI = 78, A_GJ = 84;

struct Terms {
  float r[2], w[2], jz[2];
  float ai[2][6];     // -Ji
  float aj[2][6];     // Jj
};

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// lie.quat_rotate: v + 2 (w (q x v) + q x (q x v)), q = [x, y, z, w]
__device__ __forceinline__ void rotate(const float q[4], const float v[3],
                                       float o[3]) {
  float uv[3], uuv[3];
  cross(q, v, uv);
  cross(q, uv, uuv);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.f * (q[3] * uv[k] + uuv[k]);
}

// lie.quat_mul (Hamilton, scalar last)
__device__ __forceinline__ void quat_mul(const float a[4], const float b[4],
                                         float o[4]) {
  o[0] = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  o[1] = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  o[2] = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  o[3] = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
}

// ops/ba.py:_edge_terms_center for one edge, its relative pose
// Gij = pose_jj * pose_ii^-1 formed here (the same value for every edge of
// a frame pair); w = mask * weight * valid.
__device__ __forceinline__ void edge_terms(const float* __restrict__ poses,
                                           const float* __restrict__ ctr,
                                           const float in[4], int4 e,
                                           float4 tw, float valid, Terms& o) {
  const float fx = in[0], fy = in[1], cx = in[2], cy = in[3];
  const float* pi = poses + 7 * (size_t)e.x;
  const float* pj = poses + 7 * (size_t)e.y;
  const float qi[4] = {-pi[3], -pi[4], -pi[5], pi[6]};
  const float ti[3] = {pi[0], pi[1], pi[2]};
  const float qj[4] = {pj[3], pj[4], pj[5], pj[6]};
  float ti_inv[3], q[4], t[3];
  rotate(qi, ti, ti_inv);
#pragma unroll
  for (int k = 0; k < 3; ++k) ti_inv[k] = -ti_inv[k];
  quat_mul(qj, qi, q);
  rotate(qj, ti_inv, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pj[k] + t[k];

  const float* c = ctr + 3 * (size_t)e.z;
  const float p[3] = {(c[0] - cx) / fx, (c[1] - cy) / fy, 1.f};
  const float W = c[2];
  float xyz[3];
  rotate(q, p, xyz);
  const float X = xyz[0] + W * t[0];
  const float Y = xyz[1] + W * t[1];
  const float Z = xyz[2] + W * t[2];

  const float d = Z >= 0.2f ? 1.f / Z : 0.f;
  const float d2 = d * d;
  const float Zs = fabsf(Z) > 1e-6f ? Z : 1e-6f;
  const float x1 = fx * (X / Zs) + cx;
  const float y1 = fy * (Y / Zs) + cy;
  o.r[0] = tw.x - x1;
  o.r[1] = tw.y - y1;
  const bool in_bounds =
      sqrtf(o.r[0] * o.r[0] + o.r[1] * o.r[1]) < 128.f && Z > 0.2f &&
      x1 > -64.f && y1 > -64.f && x1 < 2.f * cx + 64.f && y1 < 2.f * cy + 64.f;
  const float m = in_bounds ? 1.f : 0.f;
  o.w[0] = m * tw.z * valid;
  o.w[1] = m * tw.w * valid;
  o.jz[0] = fx * (t[0] * d - t[2] * (X * d2));
  o.jz[1] = fy * (t[1] * d - t[2] * (Y * d2));

  const float jj[2][6] = {
      {fx * W * d, 0.f, fx * -X * W * d2, fx * -X * Y * d2,
       fx * (1.f + X * X * d2), fx * -Y * d},
      {0.f, fy * W * d, fy * -Y * W * d2, fy * (-1.f - Y * Y * d2),
       fy * (X * Y * d2), fy * X * d}};
  // lie.quat_to_matrix(q);
  // Ji = Adj(Gij)^T Jj = [R^T tau; R^T (phi + tau x t)]
  const float xx = q[0] * q[0], yy = q[1] * q[1], zz = q[2] * q[2];
  const float xy = q[0] * q[1], xz = q[0] * q[2], yz = q[1] * q[2];
  const float wx = q[3] * q[0], wy = q[3] * q[1], wz = q[3] * q[2];
  const float R[3][3] = {
      {1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy)},
      {2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx)},
      {2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)}};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float tau[3] = {jj[r][0], jj[r][1], jj[r][2]};
    float tx[3];
    cross(tau, t, tx);
    const float phi[3] = {jj[r][3] + tx[0], jj[r][4] + tx[1],
                          jj[r][5] + tx[2]};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o.ai[r][k] = -(R[0][k] * tau[0] + R[1][k] * tau[1] + R[2][k] * tau[2]);
      o.ai[r][3 + k] =
          -(R[0][k] * phi[0] + R[1][k] * phi[1] + R[2][k] * phi[2]);
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) o.aj[r][k] = jj[r][k];
  }
}

__device__ __forceinline__ void load_terms(
    const float* __restrict__ poses, const float* __restrict__ ctr,
    const float in[4], const int4* __restrict__ edges,
    const float4* __restrict__ tws, int row, int n1, Terms& o, int& a,
    int& b) {
  const int4 e = edges[row];
  const bool valid = e.w < n1 * n1;
  a = valid ? e.w / n1 : n1 - 1;
  b = valid ? e.w % n1 : n1 - 1;
  edge_terms(poses, ctr, in, e, tws[row], valid ? 1.f : 0.f, o);
}

// One frame pair (a, b): its run of kperm spread over the block's threads,
// each thread's sums in row order, then a fixed shuffle tree and the warps
// in order.
__device__ void pair_block(int g, int n1, const float* __restrict__ poses,
                           const float* __restrict__ ctr, const float in[4],
                           const int4* __restrict__ edges,
                           const float4* __restrict__ tws,
                           const int* __restrict__ kperm,
                           const int* __restrict__ kstart,
                           float* __restrict__ out) {
  __shared__ float red[WARPS][ACC];
  const int S = n1 - 1;
  const bool do_i = g / n1 < S, do_j = g % n1 < S;
  float* o = out + (size_t)g * PAIR_COLS;
  if (!do_i && !do_j) {               // the dropped pair and the masked rows
    for (int c = threadIdx.x; c < PAIR_COLS; c += NT) o[c] = 0.f;
    return;
  }
  float acc[ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.f;
  const int end = kstart[g + 1];
  for (int i = kstart[g] + threadIdx.x; i < end; i += NT) {
    Terms t;
    int a, b;
    load_terms(poses, ctr, in, edges, tws, kperm[i], n1, t, a, b);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (do_i) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float wa = t.w[r] * t.ai[r][k];
          acc[A_GI + k] += wa * t.r[r];
#pragma unroll
          for (int l = k; l < 6; ++l) acc[A_HII + tri(k, l)] += wa * t.ai[r][l];
          if (do_j) {
#pragma unroll
            for (int l = 0; l < 6; ++l)
              acc[A_HIJ + 6 * k + l] += wa * t.aj[r][l];
          }
        }
      }
      if (do_j) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float wb = t.w[r] * t.aj[r][k];
          acc[A_GJ + k] += wb * t.r[r];
#pragma unroll
          for (int l = k; l < 6; ++l) acc[A_HJJ + tri(k, l)] += wb * t.aj[r][l];
        }
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k >= ACC) return;
  float s = red[0][k];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s += red[w][k];
  if (k < A_HIJ || (k >= A_HJJ && k < A_GI)) {   // Hii, Hjj: mirror
    const int base = k < A_HIJ ? 0 : 42;
    int u = k < A_HIJ ? k : k - A_HJJ, r = 0;
    while (u >= 6 - r) { u -= 6 - r; ++r; }
    const int l = r + u;
    o[base + 6 * r + l] = s;
    o[base + 6 * l + r] = s;
  } else if (k < A_HJJ) {
    o[84 + (k - A_HIJ)] = s;
  } else if (k < A_GJ) {
    o[36 + (k - A_GI)] = s;
  } else {
    o[78 + (k - A_GJ)] = s;
  }
}

// Patch ranks g = first, first + stride, ...: one warp a rank, one edge a
// lane; the lanes' values are staged and added into the row in lane order
// (lanes 0-5 the pose blocks' six columns, 6 and 7 C and u).
__device__ void patch_warps(int first, int stride, int k_cap, int n_cap,
                            const float* __restrict__ poses,
                            const float* __restrict__ ctr, const float in[4],
                            const int4* __restrict__ edges,
                            const float4* __restrict__ tws,
                            const int* __restrict__ pstart,
                            float* __restrict__ out) {
  __shared__ float rows[WARPS][ROW];
  __shared__ float stage[WARPS][32][15];
  __shared__ int ab[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = n_cap, D = 6 * n_cap;
  float* row = rows[warp];
  for (int g = first; g < k_cap; g += stride) {
    for (int c = lane; c < D + 2; c += 32) row[c] = 0.f;
    const int end = pstart[g + 1];
    for (int base = pstart[g]; base < end; base += 32) {
      float* st = stage[warp][lane];
      int a = S, b = S;
      if (base + lane < end) {
        Terms t;
        load_terms(poses, ctr, in, edges, tws, base + lane, S + 1, t, a, b);
        const float z0 = t.w[0] * t.jz[0], z1 = t.w[1] * t.jz[1];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          st[k] = z0 * t.ai[0][k] + z1 * t.ai[1][k];
          st[6 + k] = z0 * t.aj[0][k] + z1 * t.aj[1][k];
        }
        st[12] = z0 * t.jz[0] + z1 * t.jz[1];
        st[13] = (t.w[0] * t.r[0]) * t.jz[0] + (t.w[1] * t.r[1]) * t.jz[1];
      } else {
#pragma unroll
        for (int k = 0; k < 14; ++k) st[k] = 0.f;
      }
      ab[warp][lane] = a | (b << 8);
      __syncwarp();
      const int n = min(32, end - base);
      if (lane < 6) {
        for (int j = 0; j < n; ++j) {
          const int aj = ab[warp][j] & 0xff, bj = ab[warp][j] >> 8;
          if (aj < S) row[6 * aj + lane] += stage[warp][j][lane];
          if (bj < S) row[6 * bj + lane] += stage[warp][j][6 + lane];
        }
      } else if (lane < 8) {
        for (int j = 0; j < n; ++j)
          row[D + lane - 6] += stage[warp][j][6 + lane];
      }
      __syncwarp();
    }
    float* o = out + (size_t)g * (D + 2);
    for (int c = lane; c < D + 2; c += 32) o[c] = row[c];
    __syncwarp();
  }
}

__global__ void __launch_bounds__(NT)
ba_blocks_kernel(const float* __restrict__ poses,
                 const float* __restrict__ ctr,
                 const float* __restrict__ intr,
                 const int4* __restrict__ edges,
                 const float4* __restrict__ tws,
                 const int* __restrict__ pstart,
                 const int* __restrict__ kperm,
                 const int* __restrict__ kstart, float* __restrict__ ecu,
                 float* __restrict__ blocks, int n_cap, int k_cap) {
  const float in[4] = {intr[0], intr[1], intr[2], intr[3]};
  const int n1 = n_cap + 1, G = n1 * n1;
  if ((int)blockIdx.x < G) {
    pair_block(blockIdx.x, n1, poses, ctr, in, edges, tws, kperm, kstart,
               blocks);
  } else {
    const int warp = threadIdx.x >> 5;
    patch_warps((blockIdx.x - G) * WARPS + warp, (gridDim.x - G) * WARPS,
                k_cap, n_cap, poses, ctr, in, edges, tws, pstart, ecu);
  }
}

}  // namespace

extern "C" {

// poses (Np, 7), ctr (K, 3), intr (4) fp32; edges (E, 4) int32 and tw
// (E, 4) fp32, 16-byte aligned; pstart (k_cap + 1), kperm (E), kstart
// ((n_cap + 1)^2 + 1) int32; ecu (k_cap, 6 n_cap + 2) and blocks
// ((n_cap + 1)^2, 120) fp32, written whole. n_cap in [1, 32]
// (cudaErrorInvalidValue otherwise). Returns cudaGetLastError().
int dpvo_ba_blocks(const void* poses, const void* ctr, const void* intr,
                   const void* edges, const void* tw, const void* pstart,
                   const void* kperm, const void* kstart, void* ecu,
                   void* blocks, int n_cap, int k_cap, void* stream) {
  if (n_cap < 1 || n_cap > MAX_N || k_cap < 0)
    return (int)cudaErrorInvalidValue;
  const int G = (n_cap + 1) * (n_cap + 1);
  const int per_block = WARPS * PATCHES_PER_WARP;
  const int patch_blocks = (k_cap + per_block - 1) / per_block;
  ba_blocks_kernel<<<G + patch_blocks, NT, 0, (cudaStream_t)stream>>>(
      (const float*)poses, (const float*)ctr, (const float*)intr,
      (const int4*)edges, (const float4*)tw, (const int*)pstart,
      (const int*)kperm, (const int*)kstart, (float*)ecu, (float*)blocks,
      n_cap, k_cap);
  return (int)cudaGetLastError();
}

}  // extern "C"

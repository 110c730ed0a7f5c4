// Whole-solve entropic Gromov-Wasserstein — kernel K1, two routes: one
// thread-block cluster per label in shared memory (cap <= 128, the cluster
// route), or one persistent cooperative launch over all labels with the
// label's matrices in device memory (any cap, the device route; described
// after the cluster kernel below).
//
// Replaces the Pallas TPU kernel `gw_solve_pallas`
// (otfusion_tpu/experimental/gw_kernel.py:149, body `_gw_kernel` :48-141),
// which mirrors the production loop `ops.gromov._egw_warm_loop`
// (otfusion_tpu/ops/gromov.py:43-124). Per label it forms
// constC = (Cx^2 p) 1^T + 1 (q^T Cy^2), starts from T = p q^T, and per
// convergence check runs 8 micro-iterations of
//   M = constC - 2 Cx (T Cy^T)          (1e30 on pairs with a padded side)
//   10 warm-started log-domain Sinkhorn sweeps on K = -M / eps
//   T = exp((f + g - M) / eps)          (0 on padded pairs)
// then updates the relative Frobenius change of T, the best error (0.999
// improvement factor) and the stall count (patience 25), under a cap on
// iterations.
//
// What bounds it on an H100: not bytes (the inputs are read once, the plan
// written once) and not FLOPs (~90 MFLOP per label at cap 64), but the chain
// of dependent phases: per micro-step two cap^3 products and 10 sweeps, each
// sweep a row logsumexp and a column logsumexp across the whole label.
//
// Design.
//  * A cluster of `cluster` blocks per label (cudaLaunchKernelEx with a
//    cluster dimension). Block `rank` owns rows [rank*rows, (rank+1)*rows)
//    of Cx, T, T Cy^T and M; a block past the last row owns none and still
//    takes part in every barrier. Each block keeps a whole transposed copy
//    of Cy and a whole copy of T Cy^T: it computes its own rows of T Cy^T,
//    and after one cluster barrier copies the other blocks' rows from their
//    shared memory (distributed shared memory) before forming its rows of M.
//    At cap 128 a block needs at most ~214 KB, so every cap <= 128 runs in
//    shared memory; larger caps are refused.
//  * Thread (warp w, lane l) owns the elements (w + 16 a, l + 32 b) of its
//    block's rows, a < A, b < B (template parameters). Both products are
//    register-tiled on that map: per k a thread loads A broadcast values of
//    its rows and B values of its columns and issues A*B FMAs. M, K = -M/eps
//    and the T of the last check stay in registers for the whole
//    micro-step; no sweep divides: g/eps is formed once per column per
//    sweep and f/eps once per row.
//  * Row sweep (f): a warp owns whole rows, so it is a warp reduction.
//    Column sweep (g): each block merges its rows into a per-column
//    (max, sum) partial in a double-buffered slot (a group of lanes per
//    column, each merging every group-th warp, then a butterfly), one
//    cluster barrier, then every block merges the cluster's partials the
//    same fixed way, so all blocks hold bit-identical g. One cluster barrier
//    per sweep.
//  * The exit: each block sums its part of ||dT||^2 and ||T||^2 in a fixed
//    order, and after a cluster barrier every block sums the cluster's parts
//    in rank order, so every block computes the same err, best and stall
//    and leaves the loop at the same check (a block that left alone would
//    deadlock the cluster barrier).
//  * No atomics: a solve is bitwise repeatable.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCap = 128;
constexpr int kMaxRowsPerWarp = 4;
constexpr int kOuterUnroll = 8;
constexpr int kStallPatience = 25;
constexpr int kSmemLimit = 232448;
constexpr float kBig = 1e30f;
// Cluster size per cap class (cap <= 64, 64 < cap <= 128), the fastest of
// the sizes measured on an H100 (see PERF.md, K1 cluster sizes).
constexpr int kClusterSmallCap = 4;
constexpr int kClusterLargeCap = 8;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Offsets (in floats) of the regions of a block's dynamic shared memory.
// ops/gw_kernel.py:gw_layout computes the same sizes.
struct Layout {
  int rows;                      // rows per block
  int cyt, tcy, cx, t;           // cap x cap, cap x cap, rows x cap, rows x cap
  int wm, ws;                    // per-warp column partials, kWarps x cap
  int bm, bs;                    // per-block column partials, 2 x cap
  int p, q, logq, g, gs, cy2q;   // cap each
  int logp, cx2p;                // rows each
  int red;                       // 2 kWarps + 2
  int floats;
};

__host__ __device__ inline Layout gw_layout(int cap, int cluster) {
  Layout o;
  o.rows = (cap + cluster - 1) / cluster;
  int at = 0;
  o.cyt = at; at += round4(cap * cap);
  o.tcy = at; at += round4(cap * cap);
  o.cx = at; at += round4(o.rows * cap);
  o.t = at; at += round4(o.rows * cap);
  o.wm = at; at += round4(kWarps * cap);
  o.ws = at; at += round4(kWarps * cap);
  o.bm = at; at += round4(2 * cap);
  o.bs = at; at += round4(2 * cap);
  o.p = at; at += round4(cap);
  o.q = at; at += round4(cap);
  o.logq = at; at += round4(cap);
  o.g = at; at += round4(cap);
  o.gs = at; at += round4(cap);
  o.cy2q = at; at += round4(cap);
  o.logp = at; at += round4(o.rows);
  o.cx2p = at; at += round4(o.rows);
  o.red = at; at += round4(2 * kWarps + 2);
  o.floats = at;
  return o;
}

struct Lse {
  float m;
  float s;
};

// Merge of two (max, sum) partials; an empty partial is (-inf, 0). The
// result does not depend on the order of the two arguments.
__device__ __forceinline__ Lse lse_merge(Lse a, Lse b) {
  if (b.m == -INFINITY) return a;
  if (a.m == -INFINITY) return b;
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

// Butterfly reductions: every lane ends with the same bits.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Merge across each aligned group of `group` lanes (a power of two up to
// 16); every lane of a group ends with the same bits.
__device__ __forceinline__ Lse group_lse(Lse a, int group) {
  for (int off = group >> 1; off > 0; off >>= 1) {
    Lse o{__shfl_xor_sync(0xffffffffu, a.m, off),
          __shfl_xor_sync(0xffffffffu, a.s, off)};
    a = lse_merge(a, o);
  }
  return a;
}

template <int A, int B>
__global__ void __launch_bounds__(kThreads, 1)
gw_cluster_kernel(const float* __restrict__ cx_in,
                  const float* __restrict__ cy_in,
                  const float* __restrict__ logp_in,
                  const float* __restrict__ logq_in,
                  const float* __restrict__ p_in,
                  const float* __restrict__ q_in, float* __restrict__ t_out,
                  int* __restrict__ iters_out, float* __restrict__ err_out,
                  int cap, int cluster, float eps, int max_iterations,
                  float threshold, int inner_sweeps) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int l = blockIdx.x / cluster;
  const Layout lay = gw_layout(cap, cluster);
  const int row0 = rank * lay.rows;
  const int nrows = max(0, min(lay.rows, cap - row0));
  float* cyt = sm + lay.cyt;
  float* tcy = sm + lay.tcy;
  float* cxs = sm + lay.cx;
  float* ts = sm + lay.t;
  float* wm = sm + lay.wm;
  float* ws = sm + lay.ws;
  float* bm = sm + lay.bm;
  float* bs = sm + lay.bs;
  float* p = sm + lay.p;
  float* q = sm + lay.q;
  float* logq = sm + lay.logq;
  float* g = sm + lay.g;
  float* gs = sm + lay.gs;
  float* cy2q = sm + lay.cy2q;
  float* logp = sm + lay.logp;
  float* cx2p = sm + lay.cx2p;
  float* red = sm + lay.red;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cc = (size_t)cap * cap;
  const float* cxg = cx_in + l * cc;
  const float* cyg = cy_in + l * cc;

  // Load: Cy transposed (cyt[k][j] = Cy[j][k], as the plain T @ Cy^T reads
  // it), this block's rows of Cx, the marginals.
  for (int j = warp; j < cap; j += kWarps)
    for (int k = lane; k < cap; k += 32) cyt[k * cap + j] = cyg[j * cap + k];
  for (int r = warp; r < nrows; r += kWarps)
    for (int k = lane; k < cap; k += 32)
      cxs[r * cap + k] = cxg[(row0 + r) * cap + k];
  for (int i = tid; i < cap; i += kThreads) {
    p[i] = p_in[(size_t)l * cap + i];
    q[i] = q_in[(size_t)l * cap + i];
    logq[i] = logq_in[(size_t)l * cap + i];
    g[i] = 0.0f;
    gs[i] = 0.0f;
  }
  for (int r = tid; r < nrows; r += kThreads)
    logp[r] = logp_in[(size_t)l * cap + row0 + r];
  __syncthreads();
  for (int j = tid; j < cap; j += kThreads) {
    float b = 0.0f;
    for (int k = 0; k < cap; ++k) {
      const float y = cyt[k * cap + j];
      b += y * y * q[k];
    }
    cy2q[j] = b;
  }
  for (int r = tid; r < nrows; r += kThreads) {
    float a = 0.0f;
    for (int k = 0; k < cap; ++k) {
      const float x = cxs[r * cap + k];
      a += x * x * p[k];
    }
    cx2p[r] = a;
  }

  // This thread's elements: rows ra[a] (block-local), columns jb[b];
  // rc/jc are clamped copies for loads, so product loops need no branch.
  int ra[A], rc[A], jb[B], jc[B];
  bool rv[A], cv[B];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    ra[a] = warp + kWarps * a;
    rv[a] = ra[a] < nrows;
    rc[a] = rv[a] ? ra[a] : 0;
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    jb[b] = lane + 32 * b;
    cv[b] = jb[b] < cap;
    jc[b] = cv[b] ? jb[b] : cap - 1;
  }
  const bool has_rows = warp < nrows;  // warp-uniform: rv[0]
  // Column merges: `group` consecutive lanes per column (a power of two
  // dividing 32), thread tid takes column tid / group.
  int group = 16;
  while (group > 1 && group * cap > kThreads) group >>= 1;
  const int col = tid / group, sub = tid & (group - 1);
  const int nw = min(kWarps, nrows);
  bool pair[A][B];
  float kk[A][B], mm[A][B], t_old[A][B], fr[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    fr[a] = 0.0f;
    const float pa = rv[a] ? p[row0 + ra[a]] : 0.0f;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      pair[a][b] = rv[a] && cv[b] && pa > 0.0f && q[jc[b]] > 0.0f;
      const float t0 = pa * q[jc[b]];
      t_old[a][b] = t0;
      kk[a][b] = 0.0f;
      mm[a][b] = 0.0f;
      if (rv[a] && cv[b]) ts[ra[a] * cap + jb[b]] = t0;
    }
  }
  // Every block of the cluster has started before any reads another's
  // shared memory.
  cl.sync();

  float err = INFINITY, best = INFINITY;
  int it = 0, stall = 0;
  while (it < max_iterations && err > threshold && stall < kStallPatience) {
    for (int u = 0; u < kOuterUnroll; ++u) {
      __syncthreads();  // T written by the plan step
      // This block's rows of T Cy^T, into its slot of the whole copy.
      if (has_rows) {
        float acc[A][B];
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int b = 0; b < B; ++b) acc[a][b] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < cap; ++k) {
          float tv[A], yv[B];
#pragma unroll
          for (int a = 0; a < A; ++a) tv[a] = ts[rc[a] * cap + k];
#pragma unroll
          for (int b = 0; b < B; ++b) yv[b] = cyt[k * cap + jc[b]];
#pragma unroll
          for (int a = 0; a < A; ++a)
#pragma unroll
            for (int b = 0; b < B; ++b)
              acc[a][b] = fmaf(tv[a], yv[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int b = 0; b < B; ++b)
            if (rv[a] && cv[b]) tcy[(row0 + ra[a]) * cap + jb[b]] = acc[a][b];
      }
      cl.sync();
      // The other blocks' rows of T Cy^T, from their shared memory.
      for (int r = 0; r < cluster; ++r) {
        const int first = r * lay.rows;
        const int count = min(lay.rows, cap - first) * cap;
        if (r == rank || count <= 0) continue;
        const float* src = cl.map_shared_rank(tcy, r) + first * cap;
        float* dst = tcy + first * cap;
        if (((first * cap) & 3) == 0 && (count & 3) == 0) {
          const float4* s4 = reinterpret_cast<const float4*>(src);
          float4* d4 = reinterpret_cast<float4*>(dst);
          for (int e = tid; e < (count >> 2); e += kThreads) d4[e] = s4[e];
        } else {
          for (int e = tid; e < count; e += kThreads) dst[e] = src[e];
        }
      }
      __syncthreads();
      // This block's rows of M = constC - 2 Cx (T Cy^T), masked, and K.
      if (has_rows) {
        float acc[A][B];
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int b = 0; b < B; ++b) acc[a][b] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < cap; ++k) {
          float xv[A], yv[B];
#pragma unroll
          for (int a = 0; a < A; ++a) xv[a] = cxs[rc[a] * cap + k];
#pragma unroll
          for (int b = 0; b < B; ++b) yv[b] = tcy[k * cap + jc[b]];
#pragma unroll
          for (int a = 0; a < A; ++a)
#pragma unroll
            for (int b = 0; b < B; ++b)
              acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const float v = (cx2p[rc[a]] + cy2q[jc[b]]) - 2.0f * acc[a][b];
            mm[a][b] = pair[a][b] ? v : kBig;
            kk[a][b] = -mm[a][b] / eps;
          }
      }
      // (With no sweep, the next T Cy^T must not overwrite a slot another
      // block is still copying.)
      if (inner_sweeps == 0) cl.sync();

      for (int s = 0; s < inner_sweeps; ++s) {
        const int buf = (s & 1) * cap;
        if (has_rows) {
          float fs[A];
          // f: row logsumexp of K + g/eps, one warp per row.
#pragma unroll
          for (int a = 0; a < A; ++a) {
            fs[a] = 0.0f;
            if (rv[a]) {
              float x[B];
              float mx = -INFINITY;
#pragma unroll
              for (int b = 0; b < B; ++b) {
                x[b] = kk[a][b] + gs[jc[b]];
                if (cv[b]) mx = fmaxf(mx, x[b]);
              }
              mx = warp_max(mx);
              float sum = 0.0f;
#pragma unroll
              for (int b = 0; b < B; ++b)
                if (cv[b]) sum += expf(x[b] - mx);
              sum = warp_sum(sum);
              fr[a] = eps * (logp[ra[a]] - (mx + logf(sum)));
              fs[a] = fr[a] / eps;
            }
          }
          // g, first half: this thread's rows of each of its columns.
#pragma unroll
          for (int b = 0; b < B; ++b) {
            float y[A];
            float mx = -INFINITY;
#pragma unroll
            for (int a = 0; a < A; ++a) {
              y[a] = kk[a][b] + fs[a];
              if (rv[a]) mx = fmaxf(mx, y[a]);
            }
            float sum = 0.0f;
#pragma unroll
            for (int a = 0; a < A; ++a)
              if (rv[a]) sum += expf(y[a] - mx);
            if (cv[b]) {
              wm[warp * cap + jb[b]] = mx;
              ws[warp * cap + jb[b]] = sum;
            }
          }
        }
        __syncthreads();
        // The block's partial per column: `group` lanes per column each
        // merge every group-th warp in order, then a butterfly.
        {
          Lse acc{-INFINITY, 0.0f};
          if (col < cap)
            for (int w = sub; w < nw; w += group)
              acc = lse_merge(acc, Lse{wm[w * cap + col], ws[w * cap + col]});
          acc = group_lse(acc, group);
          if (col < cap && sub == 0) {
            bm[buf + col] = acc.m;
            bs[buf + col] = acc.s;
          }
        }
        cl.sync();
        // The cluster's partials, the same way: the same g in every block.
        {
          Lse acc{-INFINITY, 0.0f};
          if (col < cap)
            for (int r = sub; r < cluster; r += group) {
              const float* rm = cl.map_shared_rank(bm, r);
              const float* rs = cl.map_shared_rank(bs, r);
              acc = lse_merge(acc, Lse{rm[buf + col], rs[buf + col]});
            }
          acc = group_lse(acc, group);
          if (col < cap && sub == 0) {
            const float gj = eps * (logq[col] - (acc.m + logf(acc.s)));
            g[col] = gj;
            gs[col] = gj / eps;
          }
        }
        __syncthreads();
      }

      // T = exp((f + g - M) / eps), 0 on padded pairs.
      if (has_rows) {
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int b = 0; b < B; ++b)
            if (rv[a] && cv[b])
              ts[ra[a] * cap + jb[b]] =
                  pair[a][b] ? expf(((fr[a] + g[jb[b]]) - mm[a][b]) / eps)
                             : 0.0f;
      }
    }
    __syncthreads();
    // Relative ||T - T_old||_F: thread, warp, block, then cluster, each in a
    // fixed order.
    float d2 = 0.0f, n2 = 0.0f;
    if (has_rows) {
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (rv[a] && cv[b]) {
            const float tn = ts[ra[a] * cap + jb[b]];
            const float d = tn - t_old[a][b];
            d2 += d * d;
            n2 += tn * tn;
            t_old[a][b] = tn;
          }
    }
    d2 = warp_sum(d2);
    n2 = warp_sum(n2);
    if (lane == 0) {
      red[warp] = d2;
      red[kWarps + warp] = n2;
    }
    __syncthreads();
    if (tid == 0) {
      float bd = 0.0f, bn = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        bd += red[w];
        bn += red[kWarps + w];
      }
      red[2 * kWarps] = bd;
      red[2 * kWarps + 1] = bn;
    }
    cl.sync();
    d2 = 0.0f;
    n2 = 0.0f;
    for (int r = 0; r < cluster; ++r) {
      const float* rr = cl.map_shared_rank(red, r);
      d2 += rr[2 * kWarps];
      n2 += rr[2 * kWarps + 1];
    }
    err = sqrtf(d2) / fmaxf(sqrtf(n2), 1e-30f);
    const bool improved = err < 0.999f * best;
    best = fminf(best, err);
    stall = improved ? 0 : stall + 1;
    it += kOuterUnroll;
  }

  float* tg = t_out + l * cc;
  for (int r = warp; r < nrows; r += kWarps)
    for (int j = lane; j < cap; j += 32)
      tg[(row0 + r) * cap + j] = ts[r * cap + j];
  if (rank == 0 && tid == 0) {
    iters_out[l] = it;
    err_out[l] = err;
  }
  // No block leaves while another may still read its shared memory.
  cl.sync();
}

template <int A, int B>
cudaError_t launch(const float* cx, const float* cy, const float* log_p,
                   const float* log_q, const float* p, const float* q,
                   float* t_out, int* iters_out, float* err_out, int L,
                   int cap, int cluster, float eps, int max_iterations,
                   float threshold, int inner_sweeps, size_t smem,
                   cudaStream_t stream) {
  auto kernel = gw_cluster_kernel<A, B>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, cx, cy, log_p, log_q, p, q, t_out,
                            iters_out, err_out, cap, cluster, eps,
                            max_iterations, threshold, inner_sweeps);
}

// Register tile rounded up to 1, 2 or 4.
int tile(int x) { return x <= 1 ? 1 : (x <= 2 ? 2 : 4); }


// ---------------------------------------------------------------------------
// The device route: caps above kMaxCap.
//
// A label of cap > 128 does not fit one cluster's shared memory, so this
// route keeps, per label, Cx and Cy (the inputs), T (the output buffer), the
// T of the last check, U = T Cy^T, M and K = -M / eps in device memory (at
// cap 960 each is 3.7 MB, so one label's set stays in the H100's 50 MB L2),
// with constC kept as its two vectors Cx^2 p and Cy^2 q (constC[i][j] =
// cx2p[i] + cy2q[j], as the cluster route forms it) and the duals f, g as
// vectors. It computes exactly what gw_solve_plain (ops/gw_kernel.py) and
// the cluster route compute: per linearisation M = constC - 2 Cx (T Cy^T)
// (1e30 on padded pairs), `inner_sweeps` warm-started log-domain sweeps
// (row logsumexp for f, then column logsumexp for g), T = exp((f + g - M) /
// eps) (0 on padded pairs); every 8 linearisations the relative Frobenius
// change, the best error and the stall count per label. Each label freezes
// on its own: a label whose condition fails is skipped by every later phase.
//
// What bounds it: at cap 960 a linearisation is two cap^3 products (1.8
// GFLOP) and 21 passes over cap^2 entries; every phase depends on the one
// before, so a solve is a chain of grid-wide phases.
//
// Design (simple first; tensor cores, TMA and fusion of phases wait for a
// later change):
//  * One persistent cooperative launch per solve: grid = 2 blocks per SM at
//    most (fewer where the problem has fewer work items), 256 threads a
//    block. Blocks walk the work items of each phase with a grid stride and
//    meet at a grid barrier between phases (the counter barrier of
//    sinkhorn.cu, copied).
//  * The two products are tiled in shared memory in the kernel's own body:
//    64 x 64 output tiles over (label, row tile, column tile), depth 16 a
//    stage, a 4 x 4 register tile per thread, fp32 FMA (no TF32). U = T Cy^T
//    reads both operands along their rows; M = constC - 2 Cx U reads U down
//    its columns, and its epilogue writes M (masked) and K = -M / eps.
//  * Row pass (f): a warp per (label, row), chunks of 8 terms with a running
//    (max, sum), then a butterfly. Column pass (g): a block per (label, strip
//    of 32 columns), a lane per column and a warp per 8th row, the 8 warps'
//    partials merged in order. Plan: a warp per row; on the 8th
//    linearisation of a check it also sums the row's ||dT||^2 and ||T||^2 and
//    writes the new T into the last check's copy.
//  * The exit: block 0 sums each label's row partials in a fixed order,
//    updates err / best / stall / it and the label's flag in device memory,
//    then a grid barrier; every block reads the same flags. Each (max, sum)
//    and each norm is formed by exactly one warp or block in a fixed order:
//    a rerun gives the same bits.
//  * Data written during the solve is read with __ldcg (L2, past the SM's
//    L1) and written with __stcg; the inputs are read with __ldg.

constexpr int kDevThreads = 256;
constexpr int kDevWarps = kDevThreads / 32;
constexpr int kDevBlocksPerSm = 2;
constexpr int kTile = 64;      // product output tile, kTile x kTile
constexpr int kTileK = 16;     // product depth per shared-memory stage
constexpr int kTileLd = kTile + 4;
constexpr int kStrip = 32;     // columns of one block in the column pass
constexpr int kChunk = 8;      // terms per rescale of a running (max, sum)

// Floats of static shared memory: the two product stages and the column
// pass's per-warp partials. ops/gw_kernel.py:gw_device_layout computes the
// same.
constexpr int kDevSmemFloats = 2 * kTileK * kTileLd + 2 * kDevWarps * kStrip;

struct DevLayout {
  int tiles;   // product tiles per side
  int strips;  // column strips per label
  int grid;
};

__host__ __device__ inline long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

__host__ __device__ inline DevLayout gw_device_layout(int L, int cap,
                                                      int sms) {
  DevLayout o;
  o.tiles = (cap + kTile - 1) / kTile;
  o.strips = (cap + kStrip - 1) / kStrip;
  const long long tiles = (long long)L * o.tiles * o.tiles;
  const long long rows = ((long long)L * cap + kDevWarps - 1) / kDevWarps;
  const long long strips = (long long)L * o.strips;
  const long long most = lmax(tiles, lmax(rows, strips));
  const long long full = (long long)sms * kDevBlocksPerSm;
  o.grid = (int)(most < full ? most : full);
  return o;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// All blocks of the grid meet here (sinkhorn.cu's barrier); `target` counts
// arrivals so far. Thread 0 arrives with a release and waits with acquires,
// so the block's reads after the barrier see every write before it.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(bar), "r"(1u)
                 : "memory");
    while (ld_acquire(bar) < target) {
    }
  }
  __syncthreads();
}

__device__ __forceinline__ Lse warp_lse(Lse a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Lse o{__shfl_xor_sync(0xffffffffu, a.m, off),
          __shfl_xor_sync(0xffffffffu, a.s, off)};
    a = lse_merge(a, o);
  }
  return a;
}

// Merge a chunk of kChunk terms (x[u] = -inf where absent, the first term
// present) into a running (max, sum).
__device__ __forceinline__ Lse lse_chunk(Lse acc, const float* x) {
  float cm = -INFINITY;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) cm = fmaxf(cm, x[u]);
  const float nm = fmaxf(acc.m, cm);
  float s = acc.m == -INFINITY ? 0.0f : acc.s * expf(acc.m - nm);
#pragma unroll
  for (int u = 0; u < kChunk; ++u)
    if (x[u] != -INFINITY) s += expf(x[u] - nm);
  return {nm, s};
}

struct DevArgs {
  const float* cx;
  const float* cy;
  const float* logp;
  const float* logq;
  const float* p;
  const float* q;
  float* t;       // (L, cap, cap): the plan, the output
  float* tprev;   // (L, cap, cap): T at the last check
  float* u;       // (L, cap, cap): T Cy^T
  float* mcost;   // (L, cap, cap): M, 1e30 on padded pairs
  float* kneg;    // (L, cap, cap): -M / eps
  float* f;       // (L, cap) each
  float* fs;      // f / eps
  float* g;
  float* gs;      // g / eps
  float* cx2p;
  float* cy2q;
  float* d2;      // per row: ||dT||^2 and ||T||^2 of the row
  float* n2;
  float* err;     // (L) each
  float* best;
  int* stall;
  int* it;
  int* act;       // label still running
  int* any;       // any label running
  unsigned* bar;
  int* iters_out;
  float* err_out;
  int L, cap;
  float eps;
  int max_iterations;
  float threshold;
  int inner_sweeps;
};

// Loads rows r0.. (kTile) and columns k0.. (kTileK) of the row-major
// (cap, cap) matrix `a` into s[k][r] (zeros past the edge).
template <bool kInput>
__device__ __forceinline__ void load_rows(float* s, const float* a, int cap,
                                          int r0, int k0) {
  for (int e = threadIdx.x; e < kTile * kTileK; e += kDevThreads) {
    const int r = e / kTileK, k = e % kTileK;
    const int gr = r0 + r, gk = k0 + k;
    float v = 0.0f;
    if (gr < cap && gk < cap) {
      const float* src = a + (size_t)gr * cap + gk;
      v = kInput ? __ldg(src) : __ldcg(src);
    }
    s[k * kTileLd + r] = v;
  }
}

// Loads rows k0.. (kTileK) and columns c0.. (kTile) of `b` into s[k][c].
__device__ __forceinline__ void load_cols(float* s, const float* b, int cap,
                                          int k0, int c0) {
  for (int e = threadIdx.x; e < kTile * kTileK; e += kDevThreads) {
    const int k = e / kTile, c = e % kTile;
    const int gk = k0 + k, gc = c0 + c;
    s[k * kTileLd + c] =
        (gk < cap && gc < cap) ? __ldcg(b + (size_t)gk * cap + gc) : 0.0f;
  }
}

// One product phase over every active label's tiles. kNN = false: U = T
// Cy^T; kNN = true: M = constC - 2 Cx U, masked, and K = -M / eps.
template <bool kNN>
__device__ void product_phase(const DevArgs& a, const DevLayout& lay,
                              float* sa, float* sb) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int cap = a.cap;
  const size_t cc = (size_t)cap * cap;
  const int per_label = lay.tiles * lay.tiles;
  for (int w = blockIdx.x; w < a.L * per_label; w += gridDim.x) {
    const int l = w / per_label;
    if (!__ldcg(a.act + l)) continue;  // the same in every thread
    const int i0 = ((w % per_label) / lay.tiles) * kTile;
    const int j0 = ((w % per_label) % lay.tiles) * kTile;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
    for (int k0 = 0; k0 < cap; k0 += kTileK) {
      __syncthreads();  // the last stage (or tile) has been consumed
      if (kNN) {
        load_rows<true>(sa, a.cx + l * cc, cap, i0, k0);
        load_cols(sb, a.u + l * cc, cap, k0, j0);
      } else {
        load_rows<false>(sa, a.t + l * cc, cap, i0, k0);
        load_rows<true>(sb, a.cy + l * cc, cap, j0, k0);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTileK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(sa + k * kTileLd +
                                                           ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(sb + k * kTileLd +
                                                           tx * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(ar[x], br[y], acc[x][y]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + ty * 4 + x;
      if (i >= cap) continue;
      const size_t row = l * cc + (size_t)i * cap;
      const float pi = kNN ? __ldg(a.p + (size_t)l * cap + i) : 0.0f;
      const float ci = kNN ? __ldcg(a.cx2p + (size_t)l * cap + i) : 0.0f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int j = j0 + tx * 4 + y;
        if (j >= cap) continue;
        if (kNN) {
          const bool pair = pi > 0.0f && __ldg(a.q + (size_t)l * cap + j) > 0.0f;
          const float v =
              (ci + __ldcg(a.cy2q + (size_t)l * cap + j)) - 2.0f * acc[x][y];
          const float mm = pair ? v : kBig;
          __stcg(a.mcost + row + j, mm);
          __stcg(a.kneg + row + j, -mm / a.eps);
        } else {
          __stcg(a.u + row + j, acc[x][y]);
        }
      }
    }
  }
}

// f: f_i = eps (log p_i - lse_j(K_ij + g_j / eps)), a warp per row.
__device__ void row_phase(const DevArgs& a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cap = a.cap;
  for (long long w = (long long)blockIdx.x * kDevWarps + warp;
       w < (long long)a.L * cap; w += (long long)gridDim.x * kDevWarps) {
    const int l = (int)(w / cap);
    if (!__ldcg(a.act + l)) continue;
    const float* kr = a.kneg + (size_t)w * cap;
    const float* gs = a.gs + (size_t)l * cap;
    Lse acc{-INFINITY, 0.0f};
    for (int j0 = lane; j0 < cap; j0 += 32 * kChunk) {
      float x[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = j0 + 32 * u;
        x[u] = j < cap ? __ldcg(kr + j) + __ldcg(gs + j) : -INFINITY;
      }
      acc = lse_chunk(acc, x);
    }
    acc = warp_lse(acc);
    if (lane == 0) {
      const float f = a.eps * (__ldg(a.logp + w) - (acc.m + logf(acc.s)));
      __stcg(a.f + w, f);
      __stcg(a.fs + w, f / a.eps);
    }
  }
}

// g: g_j = eps (log q_j - lse_i(K_ij + f_i / eps)), a block per (label,
// strip of kStrip columns): lane = column, warp = every kDevWarps-th row.
__device__ void col_phase(const DevArgs& a, const DevLayout& lay, float* wm,
                          float* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cap = a.cap;
  const size_t cc = (size_t)cap * cap;
  for (int w = blockIdx.x; w < a.L * lay.strips; w += gridDim.x) {
    const int l = w / lay.strips;
    if (!__ldcg(a.act + l)) continue;
    const int j = (w % lay.strips) * kStrip + lane;
    const float* kl = a.kneg + l * cc;
    const float* fs = a.fs + (size_t)l * cap;
    Lse acc{-INFINITY, 0.0f};
    if (j < cap) {
      for (int i0 = warp; i0 < cap; i0 += kDevWarps * kChunk) {
        float x[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int i = i0 + kDevWarps * u;
          x[u] = i < cap ? __ldcg(kl + (size_t)i * cap + j) + __ldcg(fs + i)
                         : -INFINITY;
        }
        acc = lse_chunk(acc, x);
      }
    }
    __syncthreads();  // the last strip's partials have been merged
    wm[warp * kStrip + lane] = acc.m;
    ws[warp * kStrip + lane] = acc.s;
    __syncthreads();
    if (warp == 0 && j < cap) {
      Lse t{-INFINITY, 0.0f};
      for (int v = 0; v < kDevWarps; ++v)
        t = lse_merge(t, Lse{wm[v * kStrip + lane], ws[v * kStrip + lane]});
      const size_t o = (size_t)l * cap + j;
      const float g = a.eps * (__ldg(a.logq + o) - (t.m + logf(t.s)));
      __stcg(a.g + o, g);
      __stcg(a.gs + o, g / a.eps);
    }
  }
}

// T = exp((f + g - M) / eps), 0 on padded pairs, a warp per row; on the
// last linearisation of a check also the row's ||dT||^2 and ||T||^2, and T
// into the last check's copy.
__device__ void plan_phase(const DevArgs& a, bool last) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cap = a.cap;
  for (long long w = (long long)blockIdx.x * kDevWarps + warp;
       w < (long long)a.L * cap; w += (long long)gridDim.x * kDevWarps) {
    const int l = (int)(w / cap);
    if (!__ldcg(a.act + l)) continue;
    const float fi = __ldcg(a.f + w);
    const bool pi = __ldg(a.p + w) > 0.0f;
    const size_t row = (size_t)w * cap;
    const float* gl = a.g + (size_t)l * cap;
    const float* ql = a.q + (size_t)l * cap;
    float d2 = 0.0f, n2 = 0.0f;
    for (int j = lane; j < cap; j += 32) {
      const bool pair = pi && __ldg(ql + j) > 0.0f;
      const float tn =
          pair ? expf(((fi + __ldcg(gl + j)) - __ldcg(a.mcost + row + j)) /
                      a.eps)
               : 0.0f;
      __stcg(a.t + row + j, tn);
      if (last) {
        const float d = tn - __ldcg(a.tprev + row + j);
        d2 += d * d;
        n2 += tn * tn;
        __stcg(a.tprev + row + j, tn);
      }
    }
    if (last) {
      d2 = warp_sum(d2);
      n2 = warp_sum(n2);
      if (lane == 0) {
        __stcg(a.d2 + w, d2);
        __stcg(a.n2 + w, n2);
      }
    }
  }
}

__global__ void __launch_bounds__(kDevThreads, kDevBlocksPerSm)
gw_device_kernel(DevArgs a, int sms) {
  __shared__ __align__(16) float sm[kDevSmemFloats];
  float* sa = sm;
  float* sb = sa + kTileK * kTileLd;
  float* wm = sb + kTileK * kTileLd;
  float* ws = wm + kDevWarps * kStrip;
  const DevLayout lay = gw_device_layout(a.L, a.cap, sms);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cap = a.cap;
  unsigned target = 0;

  // Start: Cx^2 p and Cy^2 q, T = T_prev = p q^T, f = g = 0 (a warp per
  // row); block 0 the per-label state.
  for (long long w = (long long)blockIdx.x * kDevWarps + warp;
       w < (long long)a.L * cap; w += (long long)gridDim.x * kDevWarps) {
    const int l = (int)(w / cap);
    const size_t row = (size_t)w * cap;
    const float* pl = a.p + (size_t)l * cap;
    const float* ql = a.q + (size_t)l * cap;
    float sx = 0.0f, sy = 0.0f;
    for (int k = lane; k < cap; k += 32) {
      const float x = __ldg(a.cx + row + k), y = __ldg(a.cy + row + k);
      sx += x * x * __ldg(pl + k);
      sy += y * y * __ldg(ql + k);
    }
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    const float pi = __ldg(a.p + w);
    for (int j = lane; j < cap; j += 32) {
      const float t0 = pi * __ldg(ql + j);
      __stcg(a.t + row + j, t0);
      __stcg(a.tprev + row + j, t0);
    }
    if (lane == 0) {
      __stcg(a.cx2p + w, sx);
      __stcg(a.cy2q + w, sy);
      __stcg(a.f + w, 0.0f);
      __stcg(a.fs + w, 0.0f);
      __stcg(a.g + w, 0.0f);
      __stcg(a.gs + w, 0.0f);
    }
  }
  if (blockIdx.x == 0) {
    for (int l = threadIdx.x; l < a.L; l += kDevThreads) {
      a.err[l] = INFINITY;
      a.best[l] = INFINITY;
      a.stall[l] = 0;
      a.it[l] = 0;
      __stcg(a.act + l, a.max_iterations > 0 ? 1 : 0);
    }
    if (threadIdx.x == 0) __stcg(a.any, a.max_iterations > 0 ? 1 : 0);
  }
  grid_sync(a.bar, target);

  while (__ldcg(a.any)) {
    for (int u = 0; u < kOuterUnroll; ++u) {
      product_phase<false>(a, lay, sa, sb);
      grid_sync(a.bar, target);
      product_phase<true>(a, lay, sa, sb);
      grid_sync(a.bar, target);
      for (int s = 0; s < a.inner_sweeps; ++s) {
        row_phase(a);
        grid_sync(a.bar, target);
        col_phase(a, lay, wm, ws);
        grid_sync(a.bar, target);
      }
      plan_phase(a, u == kOuterUnroll - 1);
      grid_sync(a.bar, target);
    }
    // The check, in block 0: a warp per label sums its rows' partials in a
    // fixed order; every block reads the flags after the barrier.
    if (blockIdx.x == 0) {
      for (int l = warp; l < a.L; l += kDevWarps) {
        if (!__ldcg(a.act + l)) continue;
        float d2 = 0.0f, n2 = 0.0f;
        for (int i = lane; i < cap; i += 32) {
          d2 += __ldcg(a.d2 + (size_t)l * cap + i);
          n2 += __ldcg(a.n2 + (size_t)l * cap + i);
        }
        d2 = warp_sum(d2);
        n2 = warp_sum(n2);
        if (lane == 0) {
          const float e = sqrtf(d2) / fmaxf(sqrtf(n2), 1e-30f);
          const float best = a.best[l];
          const bool improved = e < 0.999f * best;
          const int stall = improved ? 0 : a.stall[l] + 1;
          const int it = a.it[l] + kOuterUnroll;
          a.err[l] = e;
          a.best[l] = fminf(best, e);
          a.stall[l] = stall;
          a.it[l] = it;
          __stcg(a.act + l, (it < a.max_iterations && e > a.threshold &&
                             stall < kStallPatience) ? 1 : 0);
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int any = 0;
        for (int l = 0; l < a.L; ++l) any |= __ldcg(a.act + l);
        __stcg(a.any, any);
      }
    }
    grid_sync(a.bar, target);
  }
  if (blockIdx.x == 0)
    for (int l = threadIdx.x; l < a.L; l += kDevThreads) {
      a.iters_out[l] = a.it[l];
      a.err_out[l] = a.err[l];
    }
}

}  // namespace

extern "C" {

const char* otf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int otf_gw_max_cap() { return kMaxCap; }

int otf_gw_cluster_for_cap(int cap) {
  return cap <= 64 ? kClusterSmallCap : kClusterLargeCap;
}

// Dynamic shared memory of one block, in bytes.
int otf_gw_smem_bytes(int cap, int cluster) {
  return gw_layout(cap, cluster).floats * (int)sizeof(float);
}

// L labels of cap x cap; `cluster` blocks per label (the wrapper passes
// otf_gw_cluster_for_cap(cap); a measurement may pass another size).
int otf_gw_solve(const float* cx, const float* cy, const float* log_p,
                 const float* log_q, const float* p, const float* q,
                 float* t_out, int* iters_out, float* err_out, int L, int cap,
                 int cluster, float eps, int max_iterations, float threshold,
                 int inner_sweeps, void* stream) {
  if (cap < 1 || cap > kMaxCap || L < 1 || inner_sweeps < 0 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return (int)cudaErrorInvalidValue;
  const Layout lay = gw_layout(cap, cluster);
  const int a = (lay.rows + kWarps - 1) / kWarps;
  const size_t smem = (size_t)lay.floats * sizeof(float);
  if (a > kMaxRowsPerWarp || smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int b = (cap + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
#define OTF_GW_LAUNCH(A_, B_)                                                 \
  if (tile(a) == A_ && tile(b) == B_)                                         \
    return (int)launch<A_, B_>(cx, cy, log_p, log_q, p, q, t_out, iters_out, \
                               err_out, L, cap, cluster, eps,                 \
                               max_iterations, threshold, inner_sweeps, smem, \
                               st);
  OTF_GW_LAUNCH(1, 1) OTF_GW_LAUNCH(1, 2) OTF_GW_LAUNCH(1, 4)
  OTF_GW_LAUNCH(2, 1) OTF_GW_LAUNCH(2, 2) OTF_GW_LAUNCH(2, 4)
  OTF_GW_LAUNCH(4, 1) OTF_GW_LAUNCH(4, 2) OTF_GW_LAUNCH(4, 4)
#undef OTF_GW_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// --- the device route ---

int otf_gw_device_grid(int L, int cap, int sms) {
  return gw_device_layout(L, cap, sms).grid;
}

// Static shared memory of one device-route block, in bytes.
int otf_gw_device_smem_bytes() { return kDevSmemFloats * (int)sizeof(float); }

// L labels of cap x cap (any cap >= 1) in one cooperative launch on the
// caller's stream. `scratch` holds 4 L cap^2 + 8 L cap + 2 L floats,
// `istate` 3 L + 2 ints zeroed by the caller (its last int is the grid
// barrier); `sms` is the device's SM count (the grid follows from it).
int otf_gw_device_solve(const float* cx, const float* cy, const float* log_p,
                        const float* log_q, const float* p, const float* q,
                        float* t_out, int* iters_out, float* err_out,
                        float* scratch, int* istate, int L, int cap, int sms,
                        float eps, int max_iterations, float threshold,
                        int inner_sweeps, void* stream) {
  if (cap < 1 || L < 1 || sms < 1 || inner_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gw_device_kernel, kDevThreads, 0);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < kDevBlocksPerSm) return (int)cudaErrorCooperativeLaunchTooLarge;
  const size_t cc = (size_t)L * cap * cap, v = (size_t)L * cap;
  DevArgs a;
  a.cx = cx;
  a.cy = cy;
  a.logp = log_p;
  a.logq = log_q;
  a.p = p;
  a.q = q;
  a.t = t_out;
  a.tprev = scratch;
  a.u = a.tprev + cc;
  a.mcost = a.u + cc;
  a.kneg = a.mcost + cc;
  a.f = a.kneg + cc;
  a.fs = a.f + v;
  a.g = a.fs + v;
  a.gs = a.g + v;
  a.cx2p = a.gs + v;
  a.cy2q = a.cx2p + v;
  a.d2 = a.cy2q + v;
  a.n2 = a.d2 + v;
  a.err = a.n2 + v;
  a.best = a.err + L;
  a.stall = istate;
  a.it = a.stall + L;
  a.act = a.it + L;
  a.any = a.act + L;
  a.bar = reinterpret_cast<unsigned*>(a.any + 1);
  a.iters_out = iters_out;
  a.err_out = err_out;
  a.L = L;
  a.cap = cap;
  a.eps = eps;
  a.max_iterations = max_iterations;
  a.threshold = threshold;
  a.inner_sweeps = inner_sweeps;
  const int grid = gw_device_layout(L, cap, sms).grid;
  void* args[] = {&a, &sms};
  return (int)cudaLaunchCooperativeKernel((const void*)gw_device_kernel,
                                          dim3(grid), dim3(kDevThreads), args,
                                          0, (cudaStream_t)stream);
}

}  // extern "C"

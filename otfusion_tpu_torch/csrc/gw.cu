// Whole-solve entropic Gromov-Wasserstein, one thread-block cluster per
// label — kernel K1.
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

}  // extern "C"

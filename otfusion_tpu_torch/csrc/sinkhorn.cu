// Whole log-domain Sinkhorn solve for one dense (n, m) problem in one
// persistent cooperative launch — kernel K2.
//
// Replaces the Pallas TPU kernel `sinkhorn_pallas`
// (otfusion_tpu/experimental/sinkhorn_kernel.py:131, body `_kernel` :48-124),
// and runs inside the kernel the production exit of
// otfusion_tpu/ops/sinkhorn.py: f0, g0 and the L1 row-marginal error, then
// `check_every` iterations per check while the error is above the threshold
// and the count below `max_iterations`. With the check off it runs a fixed
// number of iterations, as `sinkhorn_pallas` does.
//
// What bounds it on an H100: every iteration touches the whole cost twice
// (a row and a column logsumexp) with one exp per entry and pass. At the
// main-path shape (2048 x 2048 fp32, the FOT feature cost) that is 4.2 M
// exps per pass, and the 16 MB cost itself is read from HBM once.
//
// Design. The kernel takes `neg_c = -C / eps` (fp32; masked pairs carry
// -1e30/eps), the tensor the plain version builds, so both evaluate the same
// expressions in the same order.
//  * One block per SM at most (cudaLaunchCooperativeKernel, co-residency
//    checked with the occupancy API). Block b owns the contiguous band of
//    rows [b*rows, (b+1)*rows) and the column slice [b*cols, (b+1)*cols).
//    On the shared route the band and g/eps live in dynamic shared memory:
//    the band is loaded once per solve with cp.async (at 2048^2, 16 rows x
//    8 KB = 128 KB per block). Where a band does not fit, the same code reads
//    its band and g/eps from device memory (L2) instead.
//  * f: a warp per row, K + g/eps in chunks with a running (max, sum), g/eps
//    formed once per column per iteration and f/eps once per row. Each pass
//    is bound by fp32 issue, not by bytes; the terms of its sums take the
//    hardware exp (`sum_exp`), about a quarter of expf's instructions.
//  * g: each block writes per-column (max, sum) partials over its band to a
//    (grid, 2, m) buffer; grid barrier; each block merges the partials of its
//    column slice in a fixed order (each warp every 16th block in order,
//    then a butterfly over the warps) and writes g and g/eps; grid barrier.
//  * The exit: each block sums its rows' |row marginal - p| in order; grid
//    barrier; every block sums the grid's parts in the same order, so every
//    block takes the same decision (one that differed would deadlock the next
//    barrier). n_iters and err land in a device buffer that the wrapper
//    returns unread, so a solve inside a train step never stalls the host.
//  * The grid barrier is a counter in device memory that the wrapper zeroes;
//    no -rdc build. No atomics touch a sum: a rerun gives the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;
constexpr int kLoads = 9;     // 16 warps x 9 >= 132 blocks: one round
constexpr int kRegRows = 16;  // band rows held in registers per column
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Floats of dynamic shared memory: per-row f and f/eps, per-row errors, the
// warps' column partials, a broadcast slot; on the shared route also g/eps
// and the band. ops/sinkhorn_kernel.py:sinkhorn_layout computes the same.
__host__ __device__ inline long long small_floats(int rows) {
  return 3LL * round4(rows) + 2LL * kWarps * 32 + 4;
}

__host__ __device__ inline long long smem_floats(int m, int rows, int shared) {
  return small_floats(rows) +
         (shared ? (long long)round4(m) + (long long)rows * m : 0LL);
}

// exp of a term of a logsumexp, whose argument is <= 0 (each term is
// shifted by the running max): one multiply and MUFU.EX2, a few ulp from
// expf. The sums are dominated by the terms near the max, where the error is
// smallest, so a logsumexp moves by a few ulp, as much as another summation
// order moves it. Everything else (the plan, the merges of partials, the
// row marginal) uses expf.
__device__ __forceinline__ float sum_exp(float x) { return __expf(x); }

struct Lse {
  float m;
  float s;
};

__device__ __forceinline__ Lse lse_merge(Lse a, Lse b) {
  if (b.m == -INFINITY) return a;
  if (a.m == -INFINITY) return b;
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

// Butterfly merge: every lane ends with the same bits.
__device__ __forceinline__ Lse warp_lse(Lse a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Lse o{__shfl_xor_sync(0xffffffffu, a.m, off),
          __shfl_xor_sync(0xffffffffu, a.s, off)};
    a = lse_merge(a, o);
  }
  return a;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// All blocks of the grid meet here; `target` counts arrivals so far. Thread
// 0 arrives with a release (ordered after its block's writes by the
// __syncthreads) and waits with acquires, so the block's reads after the
// barrier see every write before it.
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

template <bool kShared>
__device__ __forceinline__ float ld_k(const float* p) {
  return kShared ? *p : __ldg(p);
}

// g/eps is written by other blocks during the solve: on the device route
// read it from L2, past this SM's L1.
template <bool kShared>
__device__ __forceinline__ float ld_gs(const float* p) {
  return kShared ? *p : __ldcg(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_solve_kernel(const float* __restrict__ neg_c,
                      const float* __restrict__ log_p,
                      const float* __restrict__ log_q,
                      const float* __restrict__ p_w, float* __restrict__ f_out,
                      float* __restrict__ g_out, float* __restrict__ plan,
                      int* __restrict__ stats, float* __restrict__ part,
                      float* __restrict__ gs_glob,
                      float* __restrict__ err_part, unsigned* __restrict__ bar,
                      int n, int m, int rows, float eps, int max_iterations,
                      float threshold, int check_every, int check) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, grid = gridDim.x;
  const int row0 = blk * rows;
  const int nr = min(rows, n - row0);
  const int cols = (m + grid - 1) / grid;
  const int col0 = blk * cols;
  const int nc = max(0, min(cols, m - col0));

  float* sf = sm;                       // f, per band row
  float* sfs = sf + round4(rows);       // f / eps
  float* rerr = sfs + round4(rows);     // |row marginal - p|
  float* wm = rerr + round4(rows);      // kWarps x 32 column partials
  float* ws = wm + kWarps * 32;
  float* bcast = ws + kWarps * 32;      // 4 floats
  float* sgs = bcast + 4;               // shared route: g / eps (m)
  float* sband = sgs + round4(m);       // shared route: band (rows x m)
  // (Offsets inside a band fit an int: the wrapper keeps rows * m < 2^31.)
  const float* band = kShared ? sband : neg_c + (size_t)row0 * m;
  const float* gsv = kShared ? sgs : gs_glob;
  unsigned target = 0;

  if (kShared) {
    const float* src = neg_c + (size_t)row0 * m;
    const size_t count = (size_t)nr * m;
    if ((((uintptr_t)src) & 15) == 0 && (count & 3) == 0) {
      for (size_t e = (size_t)tid * 4; e < count; e += (size_t)kThreads * 4)
        cp_async16(sband + e, src + e);
    } else {
      for (size_t e = tid; e < count; e += kThreads)
        cp_async4(sband + e, src + e);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    for (int j = tid; j < m; j += kThreads) sgs[j] = 0.0f;
  }
  for (int j = col0 + tid; j < col0 + nc; j += kThreads)
    __stcg(gs_glob + j, 0.0f);
  if (kShared) asm volatile("cp.async.wait_all;" ::: "memory");
  grid_sync(bar, target);

  // lse_j((K_rj [+ f_r/eps]) + g_j/eps) over band row r; one warp.
  auto row_lse = [&](int r, bool with_f, float fsr) -> float {
    const float* kr = band + r * m;
    float mx = -INFINITY, s = 0.0f;
    for (int j0 = lane; j0 < m; j0 += 32 * kChunk) {
      float x[kChunk];
      float cm = -INFINITY;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = j0 + 32 * u;
        if (j < m) {
          const float k = ld_k<kShared>(kr + j);
          const float gj = ld_gs<kShared>(gsv + j);
          x[u] = with_f ? (k + fsr) + gj : k + gj;
          cm = fmaxf(cm, x[u]);
        } else {
          x[u] = -INFINITY;
        }
      }
      const float nm = fmaxf(mx, cm);  // finite: element u = 0 exists
      s *= sum_exp(mx - nm);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) s += sum_exp(x[u] - nm);
      mx = nm;
    }
    const Lse a = warp_lse(Lse{mx, s});
    return a.m + logf(a.s);
  };

  // One iteration: f from g, then g from f.
  auto iterate = [&]() {
    for (int r = warp; r < nr; r += kWarps) {
      const float lse = row_lse(r, false, 0.0f);
      const float f = eps * (__ldg(log_p + row0 + r) - lse);
      if (lane == 0) {
        sf[r] = f;
        sfs[r] = f / eps;
      }
    }
    __syncthreads();
    if (nr <= kRegRows) {
      // The band's columns in registers, two columns a thread at a time.
      float fsr[kRegRows];
#pragma unroll
      for (int r = 0; r < kRegRows; ++r) fsr[r] = r < nr ? sfs[r] : 0.0f;
      for (int j = tid; j < m; j += 2 * kThreads) {
        const int j2 = j + kThreads;
        const bool two = j2 < m;
        float x[kRegRows], y[kRegRows];
        float mx = -INFINITY, my = -INFINITY;
#pragma unroll
        for (int r = 0; r < kRegRows; ++r)
          if (r < nr) {
            x[r] = ld_k<kShared>(band + r * m + j) + fsr[r];
            mx = fmaxf(mx, x[r]);
            if (two) {
              y[r] = ld_k<kShared>(band + r * m + j2) + fsr[r];
              my = fmaxf(my, y[r]);
            }
          }
        float sx = 0.0f, sy = 0.0f;
#pragma unroll
        for (int r = 0; r < kRegRows; ++r)
          if (r < nr) {
            sx += sum_exp(x[r] - mx);
            if (two) sy += sum_exp(y[r] - my);
          }
        __stcg(part + (size_t)(2 * blk) * m + j, mx);
        __stcg(part + (size_t)(2 * blk + 1) * m + j, sx);
        if (two) {
          __stcg(part + (size_t)(2 * blk) * m + j2, my);
          __stcg(part + (size_t)(2 * blk + 1) * m + j2, sy);
        }
      }
    } else {
      for (int j = tid; j < m; j += kThreads) {
        float mx = -INFINITY, sx = 0.0f;
        for (int r = 0; r < nr; ++r)
          mx = fmaxf(mx, ld_k<kShared>(band + r * m + j) + sfs[r]);
        for (int r = 0; r < nr; ++r)
          sx += sum_exp((ld_k<kShared>(band + r * m + j) + sfs[r]) - mx);
        __stcg(part + (size_t)(2 * blk) * m + j, mx);
        __stcg(part + (size_t)(2 * blk + 1) * m + j, sx);
      }
    }
    grid_sync(bar, target);
    for (int c = 0; c < nc; c += 32) {
      const int j = col0 + c + lane;
      const bool ok = c + lane < nc;
      Lse acc{-INFINITY, 0.0f};
      // Blocks warp, warp + 16, ... in order, kLoads loads in flight.
      for (int k0 = warp; k0 < grid; k0 += kLoads * kWarps) {
        Lse v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int k = k0 + u * kWarps;
          v[u] = (ok && k < grid)
                     ? Lse{__ldcg(part + (size_t)(2 * k) * m + j),
                           __ldcg(part + (size_t)(2 * k + 1) * m + j)}
                     : Lse{-INFINITY, 0.0f};
        }
        // One merge of the batch: its max first, then the rescaled sums
        // in order.
        float mx = acc.m;
#pragma unroll
        for (int u = 0; u < kLoads; ++u) mx = fmaxf(mx, v[u].m);
        if (mx != -INFINITY) {
          float sum = acc.m == -INFINITY ? 0.0f : acc.s * expf(acc.m - mx);
#pragma unroll
          for (int u = 0; u < kLoads; ++u)
            if (v[u].m != -INFINITY) sum += v[u].s * expf(v[u].m - mx);
          acc = Lse{mx, sum};
        }
      }
      wm[warp * 32 + lane] = acc.m;
      ws[warp * 32 + lane] = acc.s;
      __syncthreads();
      // The 16 warps' partials of column c + (tid >> 4): a butterfly over
      // 16 lanes, warp (tid & 15) each.
      {
        const int cl = tid >> 4, w = tid & 15;
        Lse t{wm[w * 32 + cl], ws[w * 32 + cl]};
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          Lse o{__shfl_xor_sync(0xffffffffu, t.m, off),
                __shfl_xor_sync(0xffffffffu, t.s, off)};
          t = lse_merge(t, o);
        }
        if (w == 0 && c + cl < nc) {
          const int jj = col0 + c + cl;
          const float g = eps * (__ldg(log_q + jj) - (t.m + logf(t.s)));
          __stcg(g_out + jj, g);
          __stcg(gs_glob + jj, g / eps);
        }
      }
      __syncthreads();
    }
    grid_sync(bar, target);
    if (kShared) {
      for (int j = tid; j < m; j += kThreads) sgs[j] = __ldcg(gs_glob + j);
      __syncthreads();
    }
  };

  // L1 row-marginal error sum_i |exp(lse_j(K_ij + f_i/eps + g_j/eps)) - p_i|,
  // the same value in every block.
  auto marginal_err = [&]() -> float {
    for (int r = warp; r < nr; r += kWarps) {
      const float lse = row_lse(r, true, sfs[r]);
      if (lane == 0) rerr[r] = fabsf(expf(lse) - __ldg(p_w + row0 + r));
    }
    __syncthreads();
    if (tid == 0) {
      float e = 0.0f;
      for (int r = 0; r < nr; ++r) e += rerr[r];
      __stcg(err_part + blk, e);
    }
    grid_sync(bar, target);
    if (warp == 0) {
      float e = 0.0f;
      for (int k = lane; k < grid; k += 32) e += __ldcg(err_part + k);
      e = warp_sum(e);
      if (lane == 0) bcast[0] = e;
    }
    __syncthreads();
    return bcast[0];
  };

  iterate();
  float err = check ? marginal_err() : NAN;
  int n_iters = 1;
  while (n_iters < max_iterations && (!check || err > threshold)) {
    for (int s = 0; s < check_every; ++s) iterate();
    if (check) err = marginal_err();
    n_iters += check_every;
  }

  for (int r = 0; r < nr; ++r) {
    const float* kr = band + (size_t)r * m;
    float* out = plan + (size_t)(row0 + r) * m;
    const float fsr = sfs[r];
    for (int j = tid; j < m; j += kThreads)
      out[j] = expf((ld_k<kShared>(kr + j) + fsr) + ld_gs<kShared>(gsv + j));
  }
  for (int r = tid; r < nr; r += kThreads) f_out[row0 + r] = sf[r];
  if (blk == 0 && tid == 0) {
    stats[0] = n_iters;
    stats[1] = __float_as_int(err);
  }
}

template <bool kShared>
cudaError_t launch(const float* neg_c, const float* log_p, const float* log_q,
                   const float* p_w, float* f_out, float* g_out, float* plan,
                   int* stats, float* scratch, unsigned* bar, int n, int m,
                   int rows, float eps, int max_iterations, float threshold,
                   int check_every, int check, size_t smem,
                   cudaStream_t stream) {
  auto kernel = sinkhorn_solve_kernel<kShared>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                     kThreads, smem);
  if (rc != cudaSuccess) return rc;
  const int grid = (n + rows - 1) / rows;
  if (per_sm < 1 || grid > sms) return cudaErrorCooperativeLaunchTooLarge;
  float* part = scratch;
  float* gs_glob = part + (size_t)grid * 2 * m;
  float* err_part = gs_glob + m;
  void* args[] = {&neg_c, &log_p, &log_q, &p_w, &f_out, &g_out,
                  &plan, &stats, &part, &gs_glob, &err_part, &bar,
                  &n, &m, &rows, &eps, &max_iterations, &threshold,
                  &check_every, &check};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                     dim3(kThreads), args, smem, stream);
}

}  // namespace

extern "C" {

const char* otf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one block, in bytes.
long long otf_sinkhorn_smem_bytes(int m, int rows, int shared) {
  return smem_floats(m, rows, shared) * (long long)sizeof(float);
}

// One solve on the caller's stream. `rows` is the band height
// (grid = ceil(n / rows) blocks); `scratch` holds grid * 2 * m + m + grid
// floats; `bar` is one zeroed 32-bit counter; `stats` receives n_iters and
// the bits of err. check = 0 runs max_iterations iterations with no check.
int otf_sinkhorn_solve(const float* neg_c, const float* log_p,
                       const float* log_q, const float* p_w, float* f_out,
                       float* g_out, float* plan, int* stats, float* scratch,
                       unsigned* bar, int n, int m, int rows, int shared,
                       float eps, int max_iterations, float threshold,
                       int check_every, int check, void* stream) {
  if (n < 1 || m < 1 || rows < 1 || check_every < 1 ||
      (long long)rows * m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long bytes = otf_sinkhorn_smem_bytes(m, rows, shared);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (shared)
    return (int)launch<true>(neg_c, log_p, log_q, p_w, f_out, g_out, plan,
                             stats, scratch, bar, n, m, rows, eps,
                             max_iterations, threshold, check_every, check,
                             (size_t)bytes, st);
  return (int)launch<false>(neg_c, log_p, log_q, p_w, f_out, g_out, plan,
                            stats, scratch, bar, n, m, rows, eps,
                            max_iterations, threshold, check_every, check,
                            (size_t)bytes, st);
}

}  // extern "C"

// Whole-solve entropic Gromov-Wasserstein, one thread block per label — kernel K1.
//
// Replaces the Pallas TPU kernel `gw_solve_pallas`
// (otfusion_tpu/experimental/gw_kernel.py:149, body `_gw_kernel` :48-141),
// which mirrors the production loop `ops.gromov._egw_warm_loop`
// (otfusion_tpu/ops/gromov.py:43-124). Per label it forms
// constC = (Cx^2 p) 1^T + 1 (q^T Cy^2), starts from T = p q^T, and per
// convergence check runs 8 micro-iterations of
//   M = constC - 2 Cx (T Cy^T)          (1e30 on pairs with a padded side)
//   10 warm-started log-domain Sinkhorn sweeps on M
//   T = exp((f + g - M) / eps)          (0 on padded pairs)
// then updates the relative Frobenius change of T, the best error (0.999
// improvement factor) and the stall count (patience 25), under a cap on
// iterations.
//
// What bounds it on an H100: not bytes — the inputs are read once and the
// plan written once — but the chain of ~20 dependent block-wide reductions
// per micro-iteration (each sweep is a row and a column logsumexp) and the two
// cap^3 products, all on one SM per label. At the main-path shape (2 labels,
// cap 64) only two SMs work; the solve is latency-bound.
//
// Design. The Pallas grid ran the labels one after another; here each label
// is its own block, so labels run concurrently and each stops on its own
// condition (the vmap-over-while_loop semantics of the XLA solver). The whole
// solve — init, loop, sweeps, bookkeeping — stays inside the block. Cx, Cy,
// T, the T snapshot, T Cy^T and M are six cap x (cap + 1) fp32 matrices: the
// padded leading dimension makes both the row sweeps (warp per row) and the
// column sweeps (warp per column, lane = row) free of shared-memory bank
// conflicts. At cap <= 64 they take at most 6 x 16.6 KB of dynamic shared
// memory (above the 48 KB default, so the launcher raises the limit with
// cudaFuncSetAttribute). At 64 < cap <= 128 they would take up to 396 KB,
// more than a block's 227 KB, so the same code runs on a device-memory
// scratch the wrapper allocates (L2 holds it). All reductions run in a fixed
// order, so a solve is bitwise repeatable.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCap = 128;
constexpr int kSmemMaxCap = 64;
constexpr int kOuterUnroll = 8;
constexpr int kStallPatience = 25;
constexpr float kBig = 1e30f;

struct Lse {
  float m;
  float s;
};

__device__ __forceinline__ void lse_push(Lse& a, float x) {
  if (x > a.m) {
    a.s = a.s * expf(a.m - x) + 1.0f;
    a.m = x;
  } else {
    a.s += expf(x - a.m);
  }
}

__device__ __forceinline__ Lse lse_merge(Lse a, Lse b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

__device__ __forceinline__ float warp_lse(Lse a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Lse o{__shfl_xor_sync(0xffffffffu, a.m, off),
          __shfl_xor_sync(0xffffffffu, a.s, off)};
    a = lse_merge(a, o);
  }
  return a.m + logf(a.s);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
gw_solve_kernel(const float* __restrict__ cx_in,
                const float* __restrict__ cy_in,
                const float* __restrict__ logp_in,
                const float* __restrict__ logq_in,
                const float* __restrict__ p_in, const float* __restrict__ q_in,
                float* __restrict__ t_out, int* __restrict__ iters_out,
                float* __restrict__ err_out, float* __restrict__ scratch,
                int cap, float eps, int max_iterations, float threshold,
                int inner_sweeps, int use_smem) {
  extern __shared__ float dyn[];
  __shared__ float f[kMaxCap], g[kMaxCap], logp[kMaxCap], logq[kMaxCap];
  __shared__ float p[kMaxCap], q[kMaxCap], cx2p[kMaxCap], cy2q[kMaxCap];
  __shared__ float red_a[kWarps], red_b[kWarps];

  const int l = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = cap + 1;
  const size_t mat = (size_t)cap * ld;
  float* base = use_smem ? dyn : scratch + (size_t)l * 6 * mat;
  float* cx = base;
  float* cy = base + mat;
  float* t = base + 2 * mat;
  float* t_old = base + 3 * mat;
  float* tcy = base + 4 * mat;
  float* mm = base + 5 * mat;
  const int cc = cap * cap;

  const float* cxg = cx_in + (size_t)l * cc;
  const float* cyg = cy_in + (size_t)l * cc;
  for (int e = tid; e < cc; e += kThreads) {
    const int i = e / cap, j = e % cap;
    cx[i * ld + j] = cxg[e];
    cy[i * ld + j] = cyg[e];
  }
  for (int i = tid; i < cap; i += kThreads) {
    logp[i] = logp_in[(size_t)l * cap + i];
    logq[i] = logq_in[(size_t)l * cap + i];
    p[i] = p_in[(size_t)l * cap + i];
    q[i] = q_in[(size_t)l * cap + i];
    f[i] = 0.0f;
    g[i] = 0.0f;
  }
  __syncthreads();

  // constC = (Cx^2 p) 1^T + 1 (q^T Cy^2), kept as its row and column parts.
  for (int i = tid; i < cap; i += kThreads) {
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < cap; ++k) {
      const float x = cx[i * ld + k], y = cy[i * ld + k];
      a += x * x * p[k];
      b += y * y * q[k];
    }
    cx2p[i] = a;
    cy2q[i] = b;
  }
  for (int e = tid; e < cc; e += kThreads) {
    const int i = e / cap, j = e % cap;
    t[i * ld + j] = p[i] * q[j];
  }
  __syncthreads();

  float err = INFINITY, best = INFINITY;
  int it = 0, stall = 0;
  while (it < max_iterations && err > threshold && stall < kStallPatience) {
    for (int e = tid; e < cc; e += kThreads) {
      const int i = e / cap, j = e % cap;
      t_old[i * ld + j] = t[i * ld + j];
    }
    // (t_old is only read after the barriers inside the first micro-step.)
    for (int u = 0; u < kOuterUnroll; ++u) {
      __syncthreads();
      // T Cy^T
      for (int e = tid; e < cc; e += kThreads) {
        const int i = e / cap, j = e % cap;
        float acc = 0.0f;
        for (int k = 0; k < cap; ++k) acc += t[i * ld + k] * cy[j * ld + k];
        tcy[i * ld + j] = acc;
      }
      __syncthreads();
      // M = constC - 2 Cx (T Cy^T), masked
      for (int e = tid; e < cc; e += kThreads) {
        const int i = e / cap, j = e % cap;
        float acc = 0.0f;
        for (int k = 0; k < cap; ++k) acc += cx[i * ld + k] * tcy[k * ld + j];
        const float v = (cx2p[i] + cy2q[j]) - 2.0f * acc;
        mm[i * ld + j] = (p[i] > 0.0f && q[j] > 0.0f) ? v : kBig;
      }
      __syncthreads();
      for (int s = 0; s < inner_sweeps; ++s) {
        for (int i = warp; i < cap; i += kWarps) {
          Lse acc{-INFINITY, 0.0f};
          for (int j = lane; j < cap; j += 32)
            lse_push(acc, -mm[i * ld + j] / eps + g[j] / eps);
          const float lse = warp_lse(acc);
          if (lane == 0) f[i] = eps * (logp[i] - lse);
        }
        __syncthreads();
        for (int j = warp; j < cap; j += kWarps) {
          Lse acc{-INFINITY, 0.0f};
          for (int i = lane; i < cap; i += 32)
            lse_push(acc, -mm[i * ld + j] / eps + f[i] / eps);
          const float lse = warp_lse(acc);
          if (lane == 0) g[j] = eps * (logq[j] - lse);
        }
        __syncthreads();
      }
      for (int e = tid; e < cc; e += kThreads) {
        const int i = e / cap, j = e % cap;
        const bool valid = p[i] > 0.0f && q[j] > 0.0f;
        t[i * ld + j] = valid ? expf((f[i] + g[j] - mm[i * ld + j]) / eps)
                              : 0.0f;
      }
    }
    __syncthreads();
    float d2 = 0.0f, n2 = 0.0f;
    for (int e = tid; e < cc; e += kThreads) {
      const int i = e / cap, j = e % cap;
      const float tn = t[i * ld + j], d = tn - t_old[i * ld + j];
      d2 += d * d;
      n2 += tn * tn;
    }
    d2 = warp_sum(d2);
    n2 = warp_sum(n2);
    if (lane == 0) {
      red_a[warp] = d2;
      red_b[warp] = n2;
    }
    __syncthreads();
    d2 = 0.0f;
    n2 = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      d2 += red_a[w];
      n2 += red_b[w];
    }
    __syncthreads();  // red_a/red_b are rewritten by the next check
    err = sqrtf(d2) / fmaxf(sqrtf(n2), 1e-30f);
    const bool improved = err < 0.999f * best;
    best = fminf(best, err);
    stall = improved ? 0 : stall + 1;
    it += kOuterUnroll;
  }

  float* tg = t_out + (size_t)l * cc;
  for (int e = tid; e < cc; e += kThreads) {
    const int i = e / cap, j = e % cap;
    tg[e] = t[i * ld + j];
  }
  if (tid == 0) {
    iters_out[l] = it;
    err_out[l] = err;
  }
}

}  // namespace

extern "C" {

const char* otf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int otf_gw_max_cap() { return kMaxCap; }

int otf_gw_smem_max_cap() { return kSmemMaxCap; }

// L labels of cap x cap. `scratch` holds 6 * L * cap * (cap + 1) floats when
// cap > otf_gw_smem_max_cap() and may be null otherwise.
int otf_gw_solve(const float* cx, const float* cy, const float* log_p,
                 const float* log_q, const float* p, const float* q,
                 float* t_out, int* iters_out, float* err_out, float* scratch,
                 int L, int cap, float eps, int max_iterations,
                 float threshold, int inner_sweeps, void* stream) {
  if (cap < 1 || cap > kMaxCap || L < 1) return (int)cudaErrorInvalidValue;
  const int use_smem = cap <= kSmemMaxCap;
  if (!use_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  if (use_smem) {
    smem = (size_t)6 * cap * (cap + 1) * sizeof(float);
    cudaError_t rc = cudaFuncSetAttribute(
        gw_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  gw_solve_kernel<<<L, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, log_p, log_q, p, q, t_out, iters_out, err_out, scratch, cap, eps,
      max_iterations, threshold, inner_sweeps, use_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"

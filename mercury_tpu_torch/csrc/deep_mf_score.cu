// Noncoherent matched-filter scores of a template bank at every lag, and the
// same scores max-reduced over the bank.
//
// deep_mf_score_kernel replaces mercury_tpu/dsp/pallas_kernels.py:
// deep_mf_score (_deep_mf_kernel), and deep_mf_max_kernel replaces
// deep_mf_max (_deep_mf_max_kernel). The TPU kernels correlate in the
// frequency domain and take the inverse DFT inside the kernel. These compute
// the same scores as a direct time-domain correlation:
//   c[b,a,l,d] = | sum_k seg[b, d + l*S + k] * conj(t[a, l, k]) |
//   e_l        = ce[b, d + l*S + S] - ce[b, d + l*S]   (prefix sums of |seg|^2)
//   score[b,a,d] = sum_l [e_l > ef[b]] * c * rsqrt(max(e_l, ef[b]))
// with t normalized per (a, l) by the wrapper (as the JAX wrapper pre-divides
// its template spectra). deep_mf_max writes smax[b,d] = max_a score[b,a,d]
// and sarg[b,d] = the first a that reaches it (strict >, as the TPU kernel).
//
// Bound: arithmetic. Lp*S complex multiply-adds per lag and hypothesis (544
// at the receive shapes), ~14x the flops of the FFT form; both kernels read
// their operands from shared memory (template reads are warp broadcasts),
// and one thread accumulates one lag in registers. deep_mf_score runs one
// block per (lag tile, a, b) and stages the [Lp, S] template of row a and the
// segment window its lags need. deep_mf_max exists so that the [B, A, 2w+1]
// surface never reaches device memory (0.9 GB at the CONFIG_0 coherent
// scan): the TPU kernel carries its running max across a sequential grid
// axis, which Hopper's unordered blocks cannot do, so here the loop over a
// runs inside one block per (lag tile, b). The block stages the segment
// window and each lag's energy gate once (neither depends on a), then per a
// stages one template row and keeps (max, argmax) in registers. Moving the
// correlation onto the tensor cores or an in-kernel FFT is later work.

#include <cuda_runtime.h>

#define DMF_TILE 128

// sum_k x[k] * conj(t[k]) over the S samples of one template symbol: the
// per-lag correlation both kernels are built on
__device__ __forceinline__ float2 dmf_corr(const float2* x, const float2* t,
                                           int s) {
  float re = 0.f, im = 0.f;
  for (int k = 0; k < s; ++k) {
    const float2 xv = x[k];
    const float2 tv = t[k];
    re = fmaf(xv.x, tv.x, fmaf(xv.y, tv.y, re));
    im = fmaf(xv.y, tv.x, fmaf(-xv.x, tv.y, im));
  }
  return make_float2(re, im);
}

// seg[b, d0 : d0 + n] into shared memory, zero past the segment's end
__device__ __forceinline__ void dmf_stage_window(float2* dst,
                                                 const float2* x_b, int d0,
                                                 int n, int seg_len) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = d0 + i;
    dst[i] = g < seg_len ? x_b[g] : make_float2(0.f, 0.f);
  }
}

__global__ void deep_mf_score_kernel(const float2* __restrict__ seg,
                                     const float2* __restrict__ tmpl,
                                     const float* __restrict__ ce,
                                     const float* __restrict__ ef,
                                     float* __restrict__ out,
                                     int num_a, int seg_len, int lp, int s,
                                     int n_cand) {
  extern __shared__ float2 smem[];
  const int span = lp * s;
  float2* s_t = smem;               // [Lp*S] template of row a
  float2* s_x = smem + span;        // [TILE + Lp*S - 1] segment window

  const int d0 = blockIdx.x * DMF_TILE;
  const int a = blockIdx.y;
  const int b = blockIdx.z;
  const float2* t_a = tmpl + (size_t)a * span;
  for (int i = threadIdx.x; i < span; i += blockDim.x) s_t[i] = t_a[i];
  dmf_stage_window(s_x, seg + (size_t)b * seg_len, d0, DMF_TILE + span - 1,
                   seg_len);
  __syncthreads();

  const int d = d0 + threadIdx.x;
  if (d >= n_cand) return;
  const float* ce_b = ce + (size_t)b * (seg_len + 1);
  const float floor_e = ef[b];
  float acc = 0.f;
  for (int l = 0; l < lp; ++l) {
    const float2 c = dmf_corr(s_x + threadIdx.x + l * s, s_t + l * s, s);
    const float c_abs = sqrtf(c.x * c.x + c.y * c.y);
    const float e_l = ce_b[d + l * s + s] - ce_b[d + l * s];
    if (e_l > floor_e) acc += c_abs * rsqrtf(fmaxf(e_l, floor_e));
  }
  out[((size_t)b * num_a + a) * n_cand + d] = acc;
}

__global__ void deep_mf_max_kernel(const float2* __restrict__ seg,
                                   const float2* __restrict__ tmpl,
                                   const float* __restrict__ ce,
                                   const float* __restrict__ ef,
                                   float* __restrict__ smax,
                                   long long* __restrict__ sarg,
                                   int num_a, int seg_len, int lp, int s,
                                   int n_cand) {
  extern __shared__ float2 smem[];
  const int span = lp * s;
  float2* s_t = smem;               // [Lp*S] template of the current row a
  float2* s_x = smem + span;        // [TILE + Lp*S - 1] segment window
  // [Lp][TILE] per-lag weight: rsqrt(max(e_l, ef)) where e_l > ef, else 0
  float* s_w = reinterpret_cast<float*>(s_x + DMF_TILE + span - 1);

  const int d0 = blockIdx.x * DMF_TILE;
  const int b = blockIdx.y;
  const int d = d0 + threadIdx.x;
  const bool live = d < n_cand;
  dmf_stage_window(s_x, seg + (size_t)b * seg_len, d0, DMF_TILE + span - 1,
                   seg_len);
  if (live) {
    const float* ce_b = ce + (size_t)b * (seg_len + 1);
    const float floor_e = ef[b];
    for (int l = 0; l < lp; ++l) {
      const float e_l = ce_b[d + l * s + s] - ce_b[d + l * s];
      s_w[l * DMF_TILE + threadIdx.x] =
          e_l > floor_e ? rsqrtf(fmaxf(e_l, floor_e)) : 0.f;
    }
  }

  float best = 0.f;
  long long arg = 0;
  for (int a = 0; a < num_a; ++a) {
    __syncthreads();                // every thread is done with row a - 1
    const float2* t_a = tmpl + (size_t)a * span;
    for (int i = threadIdx.x; i < span; i += blockDim.x) s_t[i] = t_a[i];
    __syncthreads();
    if (!live) continue;
    float acc = 0.f;
    for (int l = 0; l < lp; ++l) {
      const float w = s_w[l * DMF_TILE + threadIdx.x];
      if (w > 0.f) {
        const float2 c = dmf_corr(s_x + threadIdx.x + l * s, s_t + l * s, s);
        acc += sqrtf(c.x * c.x + c.y * c.y) * w;
      }
    }
    if (a == 0 || acc > best) {
      best = acc;
      arg = a;
    }
  }
  if (live) {
    smax[(size_t)b * n_cand + d] = best;
    sarg[(size_t)b * n_cand + d] = arg;
  }
}

static cudaError_t dmf_smem_attr(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

extern "C" int dmf_launch(const float2* seg, const float2* tmpl,
                          const float* ce, const float* ef, float* out,
                          int batch, int num_a, int seg_len, int lp, int s,
                          int n_cand, void* stream) {
  if (batch > 65535 || num_a > 65535) return (int)cudaErrorInvalidValue;
  if (batch == 0 || num_a == 0 || n_cand == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float2) * (size_t)(2 * lp * s + DMF_TILE - 1);
  cudaError_t err = dmf_smem_attr((const void*)deep_mf_score_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_cand + DMF_TILE - 1) / DMF_TILE, num_a, batch);
  deep_mf_score_kernel<<<grid, DMF_TILE, smem, (cudaStream_t)stream>>>(
      seg, tmpl, ce, ef, out, num_a, seg_len, lp, s, n_cand);
  return (int)cudaGetLastError();
}

extern "C" int dmf_max_launch(const float2* seg, const float2* tmpl,
                              const float* ce, const float* ef, float* smax,
                              long long* sarg, int batch, int num_a,
                              int seg_len, int lp, int s, int n_cand,
                              void* stream) {
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  if (batch == 0 || num_a == 0 || n_cand == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float2) * (size_t)(2 * lp * s + DMF_TILE - 1)
                      + sizeof(float) * (size_t)lp * DMF_TILE;
  cudaError_t err = dmf_smem_attr((const void*)deep_mf_max_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_cand + DMF_TILE - 1) / DMF_TILE, batch);
  deep_mf_max_kernel<<<grid, DMF_TILE, smem, (cudaStream_t)stream>>>(
      seg, tmpl, ce, ef, smax, sarg, num_a, seg_len, lp, s, n_cand);
  return (int)cudaGetLastError();
}

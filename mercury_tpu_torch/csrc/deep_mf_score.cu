// Noncoherent matched-filter scores of a template bank at every lag.
//
// Replaces mercury_tpu/dsp/pallas_kernels.py:deep_mf_score
// (_deep_mf_kernel), which correlates in the frequency domain and takes the
// inverse DFT inside the kernel. This kernel computes the same scores as a
// direct time-domain correlation:
//   c[b,a,l,d] = | sum_k seg[b, d + l*S + k] * conj(t[a, l, k]) |
//   e_l        = ce[b, d + l*S + S] - ce[b, d + l*S]   (prefix sums of |seg|^2)
//   score[b,a,d] = sum_l [e_l > ef[b]] * c * rsqrt(max(e_l, ef[b]))
// with t normalized per (a, l) by the wrapper (as the JAX wrapper pre-divides
// its template spectra).
//
// Bound: arithmetic. Lp*S complex multiply-adds per lag (544 at the receive
// shapes), ~14x the flops of the FFT form. One block per (lag tile, a, b):
// the block stages the [Lp, S] template of row a and the segment window its
// lags need in shared memory, so every product reads shared memory (template
// reads are warp broadcasts) and each thread accumulates one lag in
// registers. Moving the correlation onto the tensor cores or an in-kernel FFT
// is later work.

#include <cuda_runtime.h>

#define DMF_TILE 128

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
  const float2* x_b = seg + (size_t)b * seg_len;
  for (int i = threadIdx.x; i < span; i += blockDim.x) s_t[i] = t_a[i];
  const int win = DMF_TILE + span - 1;
  for (int i = threadIdx.x; i < win; i += blockDim.x) {
    const int g = d0 + i;
    s_x[i] = g < seg_len ? x_b[g] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  const int d = d0 + threadIdx.x;
  if (d >= n_cand) return;
  const float* ce_b = ce + (size_t)b * (seg_len + 1);
  const float floor_e = ef[b];
  float acc = 0.f;
  for (int l = 0; l < lp; ++l) {
    const float2* x = s_x + threadIdx.x + l * s;
    const float2* t = s_t + l * s;
    float re = 0.f, im = 0.f;
    for (int k = 0; k < s; ++k) {
      const float2 xv = x[k];
      const float2 tv = t[k];
      // x * conj(t)
      re = fmaf(xv.x, tv.x, fmaf(xv.y, tv.y, re));
      im = fmaf(xv.y, tv.x, fmaf(-xv.x, tv.y, im));
    }
    const float c = sqrtf(re * re + im * im);
    const float e_l = ce_b[d + l * s + s] - ce_b[d + l * s];
    if (e_l > floor_e) acc += c * rsqrtf(fmaxf(e_l, floor_e));
  }
  out[((size_t)b * num_a + a) * n_cand + d] = acc;
}

extern "C" int dmf_launch(const float2* seg, const float2* tmpl,
                          const float* ce, const float* ef, float* out,
                          int batch, int num_a, int seg_len, int lp, int s,
                          int n_cand, void* stream) {
  if (batch > 65535 || num_a > 65535) return (int)cudaErrorInvalidValue;
  if (batch == 0 || num_a == 0 || n_cand == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float2) * (size_t)(2 * lp * s + DMF_TILE - 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        deep_mf_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_cand + DMF_TILE - 1) / DMF_TILE, num_a, batch);
  deep_mf_score_kernel<<<grid, DMF_TILE, smem, (cudaStream_t)stream>>>(
      seg, tmpl, ce, ef, out, num_a, seg_len, lp, s, n_cand);
  return (int)cudaGetLastError();
}

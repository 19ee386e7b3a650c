// Fused mixer + decimating FIR for the receive front end.
//
// Replaces mercury_tpu/dsp/pallas_kernels.py:mix_fir_decimate
// (_mix_fir_decimate_kernel), which computes mix() -> fir_same() -> [::stride]
// in one pass over the real passband. This kernel adds a per-row start so the
// same code serves both front-end FIRs of the receiver:
//   out[b, m] = sum_j taps[j] * x[b, start[b] + m*stride + offset - j]
//   x[b, i]   = pb[b, i] * osc[i]   for 0 <= i < n, else 0
// where osc is the float64-phase oscillator table rounded to complex64.
// Time-sync FIR: start = 0, offset = (T-1)//2 ("same" alignment).
// Data FIR: start = clipped frame delay, offset = T-1-(T-1)//2 (segment
// alignment of fir_decimate_segment).
//
// Bound: bytes. Each output reads `stride` new passband floats and writes one
// complex64, so the kernel moves ~(4*stride + 8) bytes per output against
// 4*T flops. One thread per output; neighbouring threads read neighbouring
// windows, so the T-tap overlap is served from L1/L2 rather than HBM, and the
// taps sit in shared memory (broadcast reads).

#include <cuda_runtime.h>
#include <stdint.h>

#define MFD_MAX_TAPS 256
#define MFD_THREADS 256

__global__ void mix_fir_decimate_kernel(const float* __restrict__ pb,
                                        const float2* __restrict__ osc,
                                        const float* __restrict__ taps,
                                        const int64_t* __restrict__ start,
                                        float2* __restrict__ out,
                                        int n, int n_out, int stride,
                                        int offset, int ntaps) {
  __shared__ float s_taps[MFD_MAX_TAPS];
  for (int j = threadIdx.x; j < ntaps; j += blockDim.x) s_taps[j] = taps[j];
  __syncthreads();

  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (m >= n_out) return;
  const float* row = pb + (size_t)b * n;
  const long long base = start[b] + (long long)m * stride + offset;
  float re = 0.f, im = 0.f;
  for (int j = 0; j < ntaps; ++j) {
    const long long i = base - j;
    if (i >= 0 && i < n) {
      const float p = __ldg(row + i);
      const float2 o = __ldg(osc + i);
      re = fmaf(s_taps[j], p * o.x, re);
      im = fmaf(s_taps[j], p * o.y, im);
    }
  }
  out[(size_t)b * n_out + m] = make_float2(re, im);
}

extern "C" int mfd_launch(const float* pb, const float2* osc,
                          const float* taps, const int64_t* start,
                          float2* out, int batch, int n, int n_out,
                          int stride, int offset, int ntaps, void* stream) {
  if (ntaps > MFD_MAX_TAPS || batch > 65535) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_out == 0) return (int)cudaSuccess;
  dim3 grid((n_out + MFD_THREADS - 1) / MFD_THREADS, batch);
  mix_fir_decimate_kernel<<<grid, MFD_THREADS, 0, (cudaStream_t)stream>>>(
      pb, osc, taps, start, out, n, n_out, stride, offset, ntaps);
  return (int)cudaGetLastError();
}

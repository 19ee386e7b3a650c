// Pilot-lattice scores of candidate frame starts.
//
// Replaces mercury_tpu/dsp/pallas_kernels.py:pilot_cand_score
// (_pilot_score_kernel). For each row b and candidate m, the segment of the
// decimated baseband at idx0[b,m], Nsym symbols of S samples, is correlated
// per symbol with pilot-template row fidx[b,m] (conjugated by the wrapper):
//   c[b,m,n]  = sum_k x[b, idx0[b,m] + n*S + k] * tc[fidx[b,m], n, k]
//   es[b,m,n] = sum_k |x[b, idx0[b,m] + n*S + k]|^2
//   floor[b]  = 1e-4 * mean_{m,n} es[b,m,n] + 1e-20
//   out[b,m]  = sum_n [es > floor] * |c| / sqrt(max(es * et[n], 1e-30))
// with et[n] the energy of template symbol n of row 0. The floor follows the
// XLA path of sync.pilot_rescore (mercury_tpu/modem/sync.py:478), the mean of
// the energies actually scored; the TPU kernel takes it from the whole row.
//
// Bound: latency. At CONFIG_0 a call is 256 x 32 x 48 x 136 ~ 53 M complex
// multiply-adds and reads ~30 MB, a few microseconds of either peak. The
// floor needs every candidate of a row before any score can finish, so one
// block owns one row: each warp takes (candidate, symbol) pairs, its lanes
// stride over the S samples (neighbouring lanes, neighbouring addresses) and
// a shuffle reduction leaves |c| and es in shared memory; one block-wide sum
// gives the floor, then one thread per candidate gates and sums its symbols.
// The row is read straight from device memory: a candidate's segment is
// contiguous and overlapping candidates hit in L1/L2, so rows of any length
// need no staging (the TPU kernel's 128-aligned slice and roll were Mosaic
// workarounds and have no counterpart here).

#include <cuda_runtime.h>

#define PCS_THREADS 256

__device__ __forceinline__ float pcs_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void pilot_cand_score_kernel(const float2* __restrict__ bb,
                                        const long long* __restrict__ idx0,
                                        const long long* __restrict__ fidx,
                                        const float2* __restrict__ bank_c,
                                        const float* __restrict__ et,
                                        float* __restrict__ out,
                                        int n_dec, int m, int nsym, int s) {
  extern __shared__ float pcs_smem[];
  __shared__ float s_red[PCS_THREADS / 32];
  const int pairs = m * nsym;
  float* s_c = pcs_smem;            // [M*Nsym] |c|
  float* s_e = pcs_smem + pairs;    // [M*Nsym] es

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float2* row = bb + (size_t)b * n_dec;
  const long long* idx_b = idx0 + (size_t)b * m;
  const long long* fid_b = fidx + (size_t)b * m;
  const size_t span = (size_t)nsym * s;

  for (int p = warp; p < pairs; p += n_warps) {
    const int cm = p / nsym;
    const int n = p - cm * nsym;
    const float2* x = row + idx_b[cm] + (size_t)n * s;
    const float2* t = bank_c + (size_t)fid_b[cm] * span + (size_t)n * s;
    float re = 0.f, im = 0.f, e = 0.f;
    for (int k = lane; k < s; k += 32) {
      const float2 xv = __ldg(x + k);
      const float2 tv = __ldg(t + k);
      re = fmaf(xv.x, tv.x, fmaf(-xv.y, tv.y, re));
      im = fmaf(xv.x, tv.y, fmaf(xv.y, tv.x, im));
      e = fmaf(xv.x, xv.x, fmaf(xv.y, xv.y, e));
    }
    re = pcs_warp_sum(re);
    im = pcs_warp_sum(im);
    e = pcs_warp_sum(e);
    if (lane == 0) {
      s_c[p] = sqrtf(re * re + im * im);
      s_e[p] = e;
    }
  }
  __syncthreads();

  float part = 0.f;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) part += s_e[p];
  part = pcs_warp_sum(part);
  if (lane == 0) s_red[warp] = part;
  __syncthreads();
  if (warp == 0) {
    float v = lane < n_warps ? s_red[lane] : 0.f;
    v = pcs_warp_sum(v);
    if (lane == 0) s_red[0] = v;
  }
  __syncthreads();
  const float floor_e = 1e-4f * (s_red[0] / (float)pairs) + 1e-20f;

  for (int cm = threadIdx.x; cm < m; cm += blockDim.x) {
    float acc = 0.f;
    for (int n = 0; n < nsym; ++n) {
      const float e = s_e[cm * nsym + n];
      if (e > floor_e)
        acc += s_c[cm * nsym + n] / sqrtf(fmaxf(e * et[n], 1e-30f));
    }
    out[(size_t)b * m + cm] = acc;
  }
}

extern "C" int pcs_launch(const float2* bb, const long long* idx0,
                          const long long* fidx, const float2* bank_c,
                          const float* et, float* out, int batch, int n_dec,
                          int m, int nsym, int s, void* stream) {
  if (batch == 0 || m == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * 2 * (size_t)m * nsym;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pilot_cand_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pilot_cand_score_kernel<<<batch, PCS_THREADS, smem, (cudaStream_t)stream>>>(
      bb, idx0, fidx, bank_c, et, out, n_dec, m, nsym, s);
  return (int)cudaGetLastError();
}

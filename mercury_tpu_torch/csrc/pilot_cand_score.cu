// Pilot-lattice scores of candidate frame starts.
//
// Replaces mercury_tpu/dsp/pallas_kernels.py:pilot_cand_score
// (_pilot_score_kernel). For each row b and candidate m, the segment of the
// decimated baseband at idx0[b,m], Nsym symbols of S samples, is correlated
// per symbol with pilot-template row fidx[b,m] of the bank:
//   c[b,m,n]  = sum_k x[b, idx0[b,m] + n*S + k] * conj(t[fidx[b,m], n, k])
//   es[b,m,n] = sum_k |x[b, idx0[b,m] + n*S + k]|^2
//   floor[b]  = 1e-4 * mean_{m,n} es[b,m,n] + 1e-20
//   out[b,m]  = sum_n [es > floor] * |c| / sqrt(max(es * et[n], 1e-30))
// with et[n] the energy of template symbol n of row 0. The caller prepares
// the bank once (kernels.pilot_bank): transposed to [F, S, Nsym], symbols
// innermost, with et beside it; the kernel conjugates as it reads. The
// floor follows the XLA path of sync.pilot_rescore
// (mercury_tpu/modem/sync.py:478), the mean of the energies actually scored;
// the TPU kernel takes it from the whole row. Starts are clipped to
// [0, n_dec - Nsym*S] and template rows to the bank, as the TPU kernel
// clips them. Row b's sample i is bb[b*row_stride + i*step], so the receive
// path hands in its decimated view of the time-sync baseband without a copy.
//
// Bound: at CONFIG_0 a call is 256 x 32 x 48 x 136 ~ 53 M complex
// multiply-adds on ~34 MB of compulsory traffic (the rows and the bank),
// ~0.01 ms at either peak. What a kernel cannot avoid beyond that is reading
// each candidate's template, 52 KB, once per (row, candidate): 0.43 GB per
// call from L2, since candidates of a row rarely share a template and a row
// and a template are all one block's shared memory holds.
//
// Design (Hopper). A thread-block cluster of PCS_CLUSTER blocks owns a row;
// block r takes the symbols [r*NL, (r+1)*NL) of every candidate, NL =
// ceil(Nsym / PCS_CLUSTER). It stages the part of the row those symbols
// cover, [min idx0 + r*NL*S, max idx0 + (r+1)*NL*S), into shared memory
// with cp.async, one pad slot after every S samples (at CONFIG_0 at most
// 11560 samples, 92 KB: two blocks fit on an SM). Each thread then owns one
// (candidate, symbol) and walks its S samples alone, so no cross-lane
// reduction is needed: at CONFIG_0 a block's 24 warps hold its 32 x 24
// pairs. Neighbouring lanes take neighbouring symbols of one candidate: they
// read the template at [f, k, n], one coalesced run, and the segment S+1
// slots apart, which lands on distinct banks wherever the candidate starts.
// A warp-per-symbol layout (lanes over the S samples, then a shuffle
// reduction) spent more instruction slots on loads and shuffles than on the
// multiply-adds. The silence floor needs every symbol of every candidate:
// each block sums its energies, the cluster synchronises, and every block
// adds the PCS_CLUSTER partial sums in rank order through distributed shared
// memory, so all blocks of a row gate with the same floor. Each block then
// sums its gated terms per candidate, and rank 0 adds the ranks' partial
// scores and writes the row. One launch, no global atomics, no scratch in
// device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace cg = cooperative_groups;

#define PCS_CLUSTER 2
#define PCS_THREADS 768
#define PCS_WARPS (PCS_THREADS / 32)
#define PCS_MAX_SMEM (227 * 1024)

__device__ __forceinline__ float pcs_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void pcs_cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(s),
               "l"(src));
}

// x * conj(t) and |x|^2 accumulated into (cr, ci, e)
__device__ __forceinline__ void pcs_mac(float2 x, float2 t, float& cr,
                                        float& ci, float& e) {
  cr = fmaf(x.x, t.x, fmaf(x.y, t.y, cr));
  ci = fmaf(x.y, t.x, fmaf(-x.x, t.y, ci));
  e = fmaf(x.x, x.x, fmaf(x.y, x.y, e));
}

__global__ void __cluster_dims__(PCS_CLUSTER, 1, 1)
__launch_bounds__(PCS_THREADS, 2)
pilot_cand_score_kernel(const float2* __restrict__ bb,
                        const long long* __restrict__ idx0,
                        const long long* __restrict__ fidx,
                        const float2* __restrict__ bank_t,
                        const float* __restrict__ et,
                        float* __restrict__ out, int n_dec,
                        long long row_stride, int step, int m, int f_n,
                        int nsym, int s, int nl_max, int xs_len) {
  extern __shared__ float2 xs[];      // [xs_len] row part, one pad per S
  float* s_c = reinterpret_cast<float*>(xs + xs_len);     // [M, NL] |c|
  float* s_e = s_c + m * nl_max;                    // [M, NL] es
  float* s_part = s_e + m * nl_max;                 // [M] partial scores
  int* s_idx = reinterpret_cast<int*>(s_part + m);  // [M] starts
  int* s_fid = s_idx + m;                           // [M] template rows
  __shared__ float s_red[PCS_WARPS];
  __shared__ float s_sum;
  __shared__ int s_lo, s_hi;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / PCS_CLUSTER;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_lo = min(rank * nl_max, nsym);
  const int nl = min(nsym, n_lo + nl_max) - n_lo;   // this block's symbols

  // candidates (clipped), and the part of the row their symbols
  // [n_lo, n_lo+nl) span
  if (warp == 0) {
    const long long last = n_dec - nsym * s;
    int lo = INT_MAX, hi = 0;
    for (int i = lane; i < m; i += 32) {
      const int st = (int)min(max(idx0[(size_t)b * m + i], 0LL), last);
      s_idx[i] = st;
      s_fid[i] = (int)min(max(fidx[(size_t)b * m + i], 0LL),
                          (long long)f_n - 1);
      lo = min(lo, st);
      hi = max(hi, st);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      s_lo = lo + n_lo * s;
      s_hi = hi + (n_lo + nl) * s;
    }
  }
  __syncthreads();
  const int lo = s_lo;
  const int len = nl > 0 ? s_hi - lo : 0;
  const float2* row = bb + b * row_stride + (long long)lo * step;
  for (int i = threadIdx.x; i < len; i += PCS_THREADS)
    pcs_cp_async8(xs + i + i / s, row + (long long)i * step);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // one (candidate, symbol) per thread, no reduction: lanes of a candidate
  // read its symbols' samples S+1 slots apart (distinct banks) and the
  // template at [f, k, n..] (one coalesced run)
  for (int p = threadIdx.x; p < m * nl; p += PCS_THREADS) {
    const int cm = p / nl;
    const int l = p - cm * nl;
    const int q0 = s_idx[cm] + (n_lo + l) * s - lo;   // sample k at q0 + k
    const float2* x = xs + q0 + q0 / s;
    const int brk = s - q0 % s;      // from k = brk on, one pad further
    const float2* t = bank_t + (size_t)s_fid[cm] * s * nsym + n_lo + l;
    float cr = 0.f, ci = 0.f, e = 0.f;
#pragma unroll 4
    for (int k = 0; k < brk; ++k)
      pcs_mac(x[k], __ldg(t + (size_t)k * nsym), cr, ci, e);
#pragma unroll 4
    for (int k = brk; k < s; ++k)
      pcs_mac(x[k + 1], __ldg(t + (size_t)k * nsym), cr, ci, e);
    s_c[cm * nl_max + l] = sqrtf(cr * cr + ci * ci);
    s_e[cm * nl_max + l] = e;
  }
  __syncthreads();

  // this block's energy sum, then the row's floor across the cluster
  float part = 0.f;
  for (int p = threadIdx.x; p < m * nl; p += PCS_THREADS)
    part += s_e[(p / nl) * nl_max + p % nl];
  part = pcs_warp_sum(part);
  if (lane == 0) s_red[warp] = part;
  __syncthreads();
  if (warp == 0) {
    float v = lane < PCS_WARPS ? s_red[lane] : 0.f;
    v = pcs_warp_sum(v);
    if (lane == 0) s_sum = v;
  }
  cluster.sync();
  float total = 0.f;
  for (int r = 0; r < PCS_CLUSTER; ++r) total += *cluster.map_shared_rank(&s_sum, r);
  const float floor_e = 1e-4f * (total / (float)(m * nsym)) + 1e-20f;

  // gated terms of this block's symbols, summed per candidate
  for (int cm = warp; cm < m; cm += PCS_WARPS) {
    float acc = 0.f;
    for (int l = lane; l < nl; l += 32) {
      const float e = s_e[cm * nl_max + l];
      if (e > floor_e)
        acc += s_c[cm * nl_max + l] / sqrtf(fmaxf(e * et[n_lo + l], 1e-30f));
    }
    acc = pcs_warp_sum(acc);
    if (lane == 0) s_part[cm] = acc;
  }
  cluster.sync();
  if (rank == 0) {
    for (int cm = threadIdx.x; cm < m; cm += PCS_THREADS) {
      float acc = 0.f;
      for (int r = 0; r < PCS_CLUSTER; ++r)
        acc += cluster.map_shared_rank(s_part, r)[cm];
      out[(size_t)b * m + cm] = acc;
    }
  }
  cluster.sync();     // no block leaves while rank 0 reads its shared memory
}

extern "C" int pcs_launch(const float2* bb, const long long* idx0,
                          const long long* fidx, const float2* bank_t,
                          const float* et, float* out, int batch, int n_dec,
                          long long row_stride, int step, int m, int f_n,
                          int nsym, int s, void* stream) {
  if (batch == 0 || m == 0) return (int)cudaSuccess;
  if (nsym < 1 || s < 1 || f_n < 1 || step < 1 || n_dec < nsym * s)
    return (int)cudaErrorInvalidValue;
  const int nl_max = (nsym + PCS_CLUSTER - 1) / PCS_CLUSTER;
  // starts lie in [0, n_dec - nsym*s]: a block's part of the row is at most
  // that range plus its own symbols
  const int span_max = n_dec - nsym * s + nl_max * s;
  const int xs_len = span_max + span_max / s + 1;
  const size_t smem = sizeof(float2) * (size_t)xs_len
                      + sizeof(float) * ((size_t)2 * m * nl_max + m)
                      + sizeof(int) * (size_t)2 * m;
  if (smem > PCS_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pilot_cand_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pilot_cand_score_kernel<<<batch * PCS_CLUSTER, PCS_THREADS, smem,
                            (cudaStream_t)stream>>>(
      bb, idx0, fidx, bank_t, et, out, n_dec, row_stride, step, m, f_n, nsym, s,
      nl_max, xs_len);
  return (int)cudaGetLastError();
}

// Layered LDPC belief propagation, a whole decode in one launch.
//
// Replaces mercury_tpu/fec/ldpc.py:decode_mm, an XLA program written for
// the TPU's matrix unit: a lax.while_loop over sweeps around a lax.scan over
// the layers, the messages moved by one-hot incidence matmuls with bfloat16
// data operands. Its arithmetic, as dsp/kernels.py:layered_decode_ref
// states it in torch, for each layer l of a sweep and each edge e = (check
// c, variable v) of the layer:
//   q      = bf16(llr[v]) - r[e]
//   r_new  = SPA:     2 atanh(clamp(prod_{e' != e in c} tanh(q'/2),
//                                   +-0.9999999))
//            min-sum: sign_excl * clamp(alpha * max(min_excl - beta, 0),
//                                       0, 8.7)
//   llr[v] += bf16(r_new - r[e]);  r[e] = r_new
// then, after the sweep, the syndrome of the hard decisions over every
// check: a row whose decisions satisfy them all is frozen with iters = the
// sweep count (0 before the first sweep), one that never does ends after
// max_iter sweeps with iters = max_iter + 1.
//
// Bound: a sweep does ~24 (SPA) or ~10 (min-sum) operations an edge over
// 3574-6604 edges, and a decode reads 6.4 KB of LLRs and writes 12.8 KB of
// decisions a row: at batch 256 about 0.6 us of FP32 operations a sweep
// and 1.5 us of bytes a decode. What holds a kernel far above that is the
// chain of dependent steps: every layer reads what the previous one wrote,
// so the layers of a sweep, and the sweeps, run in order, with a barrier
// between layers (9-39 a sweep).
//
// Design (Hopper). One block owns one row (codeword) for the whole decode,
// so the dependency chain never leaves the SM: the posterior (N floats) and
// the check messages of the real edges only (E floats, <= 26.4 KB), and for
// a layering that is not variable-disjoint a layer's deltas, live in shared
// memory; the plan's tables (CSR by layer and check, int32) are read through
// the read-only cache, where the blocks of a batch share them. The checks of
// a layer are spread over groups of `group` lanes (a power of two <= 32
// chosen from the largest check degree), each lane holding up to LDPC_KMAX
// consecutive edges of its check in registers: the exclusive product (SPA)
// is a segmented prefix and suffix product over the group's lanes with
// warp shuffles, the min-sum triple (min1, first argmin, min2) and sign
// parity a shuffle butterfly, so min-sum is bit-exact with the plain
// version. The syndrome is a segmented XOR over the same groups and one
// __syncthreads_or. A variable-disjoint layer (the receive chain's default
// for every rate) adds each delta to the posterior directly; a grouped
// layer first stores its deltas, then adds each variable's in edge order,
// as the plain version's index_add_ does on the CPU. No atomics, no scratch
// in device memory, no host synchronisation; tensor cores have nothing to
// do here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#define LDPC_KMAX 4
#define LDPC_THREADS_MAX 512
#define LDPC_MAX_SMEM (227 * 1024)
#define LDPC_BIG 3.0e38f
#define LDPC_FULL 0xffffffffu

struct LdpcPlan {
  const int* layer_ptr;     // [n_layers + 1] checks of a layer
  const int* check_ptr;     // [n_checks + 1] edges of a check
  const int* edge_var;      // [n_edges] variable of an edge
  const int* var_ptr;       // [n_layers + 1] variables a layer touches
  const int* var_id;        // their indices
  const int* var_edge_ptr;  // edges of each such variable
  const int* var_edge;      // in ascending order
  int n, n_layers, n_checks, n_edges, layer_scratch, group;
};

// float32 -> bfloat16 (round to nearest even) -> float32
__device__ __forceinline__ float ldpc_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// True when the hard decisions of L satisfy every check. Every thread of
// the block calls it (a barrier inside).
__device__ bool ldpc_syndrome_ok(const float* L, const LdpcPlan& p, int lg,
                                 int gid, int ng) {
  const int G = p.group;
  int bad = 0;
  for (int base = 0; base < p.n_checks; base += ng) {
    const int c = base + gid;
    int par = 0;
    if (c < p.n_checks) {
      const int e1 = __ldg(p.check_ptr + c + 1);
      for (int e = __ldg(p.check_ptr + c) + lg; e < e1; e += G)
        par ^= L[__ldg(p.edge_var + e)] < 0.f;
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      par ^= __shfl_xor_sync(LDPC_FULL, par, off, G);
    bad |= par;
  }
  return __syncthreads_or(bad) == 0;
}

// One layer: every check of it updates its edges' messages from the
// posterior and adds the bf16 deltas to it. Every thread of the block
// calls it; it ends in a barrier.
__device__ void ldpc_layer(float* L, float* R, float* D, const LdpcPlan& p,
                           int l, int lg, int gid, int ng, int minsum,
                           float alpha, float beta) {
  const int G = p.group;
  const int c0 = __ldg(p.layer_ptr + l), c1 = __ldg(p.layer_ptr + l + 1);
  const int le0 = __ldg(p.check_ptr + c0);
  const bool grouped = p.layer_scratch > 0;
  for (int base = c0; base < c1; base += ng) {
    const int c = base + gid;
    int e0 = 0, deg = 0;
    if (c < c1) {
      e0 = __ldg(p.check_ptr + c);
      deg = __ldg(p.check_ptr + c + 1) - e0;
    }
    const int kc = (deg + G - 1) / G;   // this check's edges a lane
    int v[LDPC_KMAX];
    float q[LDPC_KMAX], r_old[LDPC_KMAX], r_new[LDPC_KMAX];
    bool has[LDPC_KMAX];
#pragma unroll
    for (int k = 0; k < LDPC_KMAX; ++k) {
      const int pos = lg * kc + k;
      has[k] = k < kc && pos < deg;
      v[k] = 0;
      q[k] = 0.f;
      r_old[k] = 0.f;
      if (has[k]) {
        v[k] = __ldg(p.edge_var + e0 + pos);
        r_old[k] = R[e0 + pos];
        q[k] = ldpc_bf16(L[v[k]]) - r_old[k];
      }
    }
    if (minsum) {
      float m1 = LDPC_BIG, m2 = LDPC_BIG;
      int i1 = INT_MAX, par = 0;
#pragma unroll
      for (int k = 0; k < LDPC_KMAX; ++k) {
        if (!has[k]) continue;
        const float a = fabsf(q[k]);
        if (a < m1) {
          m2 = m1;
          m1 = a;
          i1 = lg * kc + k;
        } else {
          m2 = fminf(m2, a);
        }
        par ^= q[k] < 0.f;
      }
      // butterfly over the group: the smallest (value, position) wins,
      // the loser's min1 competes for min2
      for (int off = G >> 1; off > 0; off >>= 1) {
        const float om1 = __shfl_xor_sync(LDPC_FULL, m1, off, G);
        const float om2 = __shfl_xor_sync(LDPC_FULL, m2, off, G);
        const int oi = __shfl_xor_sync(LDPC_FULL, i1, off, G);
        par ^= __shfl_xor_sync(LDPC_FULL, par, off, G);
        if (om1 < m1 || (om1 == m1 && oi < i1)) {
          m2 = fminf(om2, m1);
          m1 = om1;
          i1 = oi;
        } else {
          m2 = fminf(m2, om1);
        }
      }
#pragma unroll
      for (int k = 0; k < LDPC_KMAX; ++k) {
        const float ex = (lg * kc + k == i1) ? m2 : m1;
        const float mag = fminf(
            fmaxf(__fmul_rn(alpha, fmaxf(ex - beta, 0.f)), 0.f), 8.7f);
        r_new[k] = (par ^ (q[k] < 0.f)) ? -mag : mag;
      }
    } else {
      float t[LDPC_KMAX], pre[LDPC_KMAX], suf[LDPC_KMAX];
#pragma unroll
      for (int k = 0; k < LDPC_KMAX; ++k)
        t[k] = has[k] ? tanhf(__fmul_rn(0.5f, q[k])) : 1.f;
      pre[0] = 1.f;
#pragma unroll
      for (int k = 1; k < LDPC_KMAX; ++k) pre[k] = pre[k - 1] * t[k - 1];
      suf[LDPC_KMAX - 1] = 1.f;
#pragma unroll
      for (int k = LDPC_KMAX - 2; k >= 0; --k) suf[k] = suf[k + 1] * t[k + 1];
      const float tot = pre[LDPC_KMAX - 1] * t[LDPC_KMAX - 1];
      // products of the lanes before and after this one in the group
      float inc = tot, sinc = tot;
      for (int d = 1; d < G; d <<= 1) {
        const float up = __shfl_up_sync(LDPC_FULL, inc, d, G);
        const float dn = __shfl_down_sync(LDPC_FULL, sinc, d, G);
        if (lg >= d) inc = up * inc;
        if (lg + d < G) sinc = sinc * dn;
      }
      float before = __shfl_up_sync(LDPC_FULL, inc, 1, G);
      float after = __shfl_down_sync(LDPC_FULL, sinc, 1, G);
      if (lg == 0) before = 1.f;
      if (lg == G - 1) after = 1.f;
#pragma unroll
      for (int k = 0; k < LDPC_KMAX; ++k) {
        const float prod = fminf(fmaxf((before * pre[k]) * (suf[k] * after),
                                       -0.9999999f), 0.9999999f);
        r_new[k] = __fmul_rn(2.f, atanhf(prod));
      }
    }
#pragma unroll
    for (int k = 0; k < LDPC_KMAX; ++k) {
      if (!has[k]) continue;
      const int e = e0 + lg * kc + k;
      const float delta = ldpc_bf16(r_new[k] - r_old[k]);
      R[e] = r_new[k];
      if (grouped)
        D[e - le0] = delta;
      else
        L[v[k]] += delta;   // no other check of the layer has v
    }
  }
  __syncthreads();
  if (grouped) {
    const int j1 = __ldg(p.var_ptr + l + 1);
    for (int j = __ldg(p.var_ptr + l) + threadIdx.x; j < j1; j += blockDim.x) {
      float upd = 0.f;
      const int f1 = __ldg(p.var_edge_ptr + j + 1);
      for (int f = __ldg(p.var_edge_ptr + j); f < f1; ++f)
        upd += D[__ldg(p.var_edge + f) - le0];
      L[__ldg(p.var_id + j)] += upd;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(LDPC_THREADS_MAX)
ldpc_layered_kernel(const float* __restrict__ llr, LdpcPlan p,
                    long long* __restrict__ bits,
                    long long* __restrict__ iters, bool* __restrict__ ok,
                    float* __restrict__ post, int max_iter, int minsum,
                    float alpha, float beta) {
  extern __shared__ float smem[];
  float* L = smem;                 // posterior [n]
  float* R = L + p.n;              // check messages [n_edges]
  float* D = R + p.n_edges;        // a grouped layer's deltas
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row = blockIdx.x;
  const float* in = llr + row * p.n;
  for (int i = tid; i < p.n; i += nt) L[i] = in[i];
  for (int e = tid; e < p.n_edges; e += nt) R[e] = 0.f;
  __syncthreads();
  const int lg = tid & (p.group - 1), gid = tid / p.group,
            ng = nt / p.group;
  bool done = ldpc_syndrome_ok(L, p, lg, gid, ng);
  long long it_out = done ? 0 : (long long)max_iter + 1;
  for (int it = 0; !done && it < max_iter; ++it) {
    for (int l = 0; l < p.n_layers; ++l)
      ldpc_layer(L, R, D, p, l, lg, gid, ng, minsum, alpha, beta);
    done = ldpc_syndrome_ok(L, p, lg, gid, ng);
    if (done) it_out = it + 1;
  }
  for (int i = tid; i < p.n; i += nt) {
    const float x = L[i];
    bits[row * p.n + i] = x < 0.f;
    if (post != nullptr) post[row * p.n + i] = x;
  }
  if (tid == 0) {
    iters[row] = it_out;
    ok[row] = done;
  }
}

extern "C" int ldpc_launch(const float* llr, const int* layer_ptr,
                           const int* check_ptr, const int* edge_var,
                           const int* var_ptr, const int* var_id,
                           const int* var_edge_ptr, const int* var_edge,
                           long long* bits, long long* iters, bool* ok,
                           float* post, int batch, int n, int n_layers,
                           int n_checks, int n_edges, int layer_scratch,
                           int group, int threads, int max_iter, int minsum,
                           float alpha, float beta, void* stream) {
  if (batch == 0) return (int)cudaSuccess;
  if (n < 1 || n_layers < 1 || n_checks < 1 || n_edges < 1 || max_iter < 0 ||
      layer_scratch < 0 || group < 1 || group > 32 ||
      (group & (group - 1)) != 0 || threads < 32 ||
      threads > LDPC_THREADS_MAX || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)n + n_edges + layer_scratch);
  if (smem > LDPC_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ldpc_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  LdpcPlan p{layer_ptr, check_ptr,   edge_var, var_ptr,  var_id,
             var_edge_ptr, var_edge, n,        n_layers, n_checks,
             n_edges,   layer_scratch, group};
  ldpc_layered_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      llr, p, bits, iters, ok, post, max_iter, minsum, alpha, beta);
  return (int)cudaGetLastError();
}

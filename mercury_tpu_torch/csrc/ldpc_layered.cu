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
// between layers (9-39 a sweep). A row's time is that chain's length
// times the instructions each step issues on its SM: on the card a layer's
// time follows the instructions its lanes issue (a tanh and an atanh an
// edge slot, empty or not) and the syndrome's serial passes far more than
// the dependent index loads that reach the posterior (PERF.md §6).
//
// Design (Hopper). One block owns one row (codeword) for the whole decode,
// so the dependency chain never leaves the SM and a block retires as soon
// as its row converges (on the card that beat blocks of several rows, whose
// rows hold each other's place until the last converges): the row's
// posterior (N floats), its check messages (E floats, <= 26.4 KB) and, for
// a layering that is not variable-disjoint, a layer's deltas live in shared
// memory. The block first stages the plan there in lane order: a word a
// (layer, check slot) holding the check's first edge and degree (16 bits
// each), and the variable of every edge as 16 bits, so a lane reaches L[v]
// through two shared loads and no global one. The geometry
// (LdpcPlan.geometry, from the plan's shape) sets the block's threads: the
// checks of a layer are spread over groups of `group` lanes (a power of two
// <= 32 chosen from the largest check degree), each lane holding K (the
// plan's edge slots a lane, 1 or 2) consecutive edges of a check and P (1 or
// 2) checks in registers, both compile-time, so a layer takes the fewest
// passes 512 threads allow (one at every rate but 4/16 and 5/16) in the
// fewest warps that do, no lane computes a tanh or atanh for
// an edge it does not have, and a warp whose groups hold no check in a pass
// skips it. The exclusive product (SPA) is a segmented prefix and suffix
// product over the group's lanes with warp shuffles, the min-sum triple
// (min1, first argmin, min2) and sign parity a shuffle butterfly; an empty
// slot's 1 (or its absence) leaves every product and comparison exact, so
// the outputs do not depend on K, P or the threads, and min-sum is
// bit-exact with the plain version. The syndrome walks the same slots: each
// lane gathers its edges' hard decisions into one bit a check slot, the
// group XORs the words once (a shuffle butterfly over 64 slots at a time),
// and a shared flag and one barrier end it. A variable-disjoint layer (the
// receive chain's default for every rate) adds each delta to the posterior
// directly; a grouped layer first stores its deltas, then adds each
// variable's in edge order, as the plain version's index_add_ does on the
// CPU (those lists are read from global memory: no receive runs a grouped
// layering). No atomics, no scratch in device memory, no host
// synchronisation; tensor cores have nothing to do here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#define LDPC_THREADS_MAX 512
#define LDPC_MAX_SMEM (227 * 1024)
#define LDPC_BIG 3.0e38f
#define LDPC_FULL 0xffffffffu

struct LdpcPlan {
  const int* lane_check;         // [n_layers * layer_slots] e0 | deg << 16
  const unsigned short* lane_var;  // [n_edges] variable of an edge
  const int* var_ptr;            // [n_layers + 1] variables a layer touches
  const int* var_id;             // their indices
  const int* var_edge_ptr;       // edges of each such variable
  const int* var_edge;           // in ascending order
  int n, n_layers, n_edges, layer_slots, layer_scratch, group;
};

// float32 -> bfloat16 (round to nearest even) -> float32
__device__ __forceinline__ float ldpc_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The check in slot i of a layer's words: its first edge and degree (0 past
// the layer's checks or the table).
__device__ __forceinline__ void ldpc_slot(const int* words, int slots, int i,
                                          int& e0, int& deg) {
  const int w = i < slots ? words[i] : 0;
  e0 = w & 0xffff;
  deg = (unsigned)w >> 16;
}

// True in some thread when a check fails on the hard decisions of L. Every
// thread of the block calls it; the group of lanes of a check agrees.
template <int K, int P>
__device__ bool ldpc_row_bad(const float* L, const int* words,
                             const unsigned short* ev, const LdpcPlan& p,
                             int lg, int g, int ng, int gshift) {
  const int G = p.group;
  unsigned long long par = 0ull;  // one bit a check slot
  int bit = 0;
  bool bad = false;
  for (int l = 0; l < p.n_layers; ++l) {
    const int* w = words + l * p.layer_slots;
    for (int base = 0; base < p.layer_slots; base += ng * P) {
#pragma unroll
      for (int c = 0; c < P; ++c) {
        int e0, deg;
        ldpc_slot(w, p.layer_slots, base + c * ng + g, e0, deg);
        const int kc = (deg + G - 1) >> gshift;
        unsigned s = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int pos = lg * kc + k;
          if (k < kc && pos < deg) s ^= L[ev[e0 + pos]] < 0.f;
        }
        par |= (unsigned long long)s << bit;
        if (++bit == 64) {
          for (int off = G >> 1; off > 0; off >>= 1)
            par ^= __shfl_xor_sync(LDPC_FULL, par, off, G);
          bad |= par != 0ull;
          par = 0ull;
          bit = 0;
        }
      }
    }
  }
  for (int off = G >> 1; off > 0; off >>= 1)
    par ^= __shfl_xor_sync(LDPC_FULL, par, off, G);
  return bad || par != 0ull;
}

// One layer: every check of it updates its edges' messages from the
// posterior and adds the bf16 deltas to it. Every thread of the block calls
// it.
template <int K, int P>
__device__ void ldpc_layer(float* L, float* R, float* D, const int* words,
                           const unsigned short* ev, const LdpcPlan& p,
                           int lg, int g, int ng, int gshift, int minsum,
                           float alpha, float beta) {
  const int G = p.group;
  const int le0 = words[0] & 0xffff;  // the layer's first edge
  const bool grouped = p.layer_scratch > 0;
  for (int base = 0; base < p.layer_slots; base += ng * P) {
    int e0[P], kc[P], v[P][K];
    float q[P][K], r_old[P][K], r_new[P][K];
    bool has[P][K];
    bool any = false;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      int deg;
      ldpc_slot(words, p.layer_slots, base + c * ng + g, e0[c], deg);
      kc[c] = (deg + G - 1) >> gshift;   // this check's edges a lane
      any |= deg > 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int pos = lg * kc[c] + k;
        has[c][k] = k < kc[c] && pos < deg;
        v[c][k] = 0;
        q[c][k] = 0.f;
        r_old[c][k] = 0.f;
        if (has[c][k]) {
          v[c][k] = ev[e0[c] + pos];
          r_old[c][k] = R[e0[c] + pos];
          q[c][k] = ldpc_bf16(L[v[c][k]]) - r_old[c][k];
        }
      }
    }
    // a warp whose groups hold no check here has nothing to do
    if (!__any_sync(LDPC_FULL, any)) continue;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      if (minsum) {
        float m1 = LDPC_BIG, m2 = LDPC_BIG;
        int i1 = INT_MAX, par = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!has[c][k]) continue;
          const float a = fabsf(q[c][k]);
          if (a < m1) {
            m2 = m1;
            m1 = a;
            i1 = lg * kc[c] + k;
          } else {
            m2 = fminf(m2, a);
          }
          par ^= q[c][k] < 0.f;
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
        for (int k = 0; k < K; ++k) {
          const float ex = (lg * kc[c] + k == i1) ? m2 : m1;
          const float mag = fminf(
              fmaxf(__fmul_rn(alpha, fmaxf(ex - beta, 0.f)), 0.f), 8.7f);
          r_new[c][k] = (par ^ (q[c][k] < 0.f)) ? -mag : mag;
        }
      } else {
        float t[K], pre[K], suf[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          t[k] = has[c][k] ? tanhf(__fmul_rn(0.5f, q[c][k])) : 1.f;
        pre[0] = 1.f;
#pragma unroll
        for (int k = 1; k < K; ++k) pre[k] = pre[k - 1] * t[k - 1];
        suf[K - 1] = 1.f;
#pragma unroll
        for (int k = K - 2; k >= 0; --k) suf[k] = suf[k + 1] * t[k + 1];
        const float tot = pre[K - 1] * t[K - 1];
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
        for (int k = 0; k < K; ++k) {
          r_new[c][k] = 0.f;
          if (!has[c][k]) continue;
          const float prod = fminf(fmaxf((before * pre[k]) * (suf[k] * after),
                                         -0.9999999f), 0.9999999f);
          r_new[c][k] = __fmul_rn(2.f, atanhf(prod));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < P; ++c) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!has[c][k]) continue;
        const int e = e0[c] + lg * kc[c] + k;
        const float delta = ldpc_bf16(r_new[c][k] - r_old[c][k]);
        R[e] = r_new[c][k];
        if (grouped)
          D[e - le0] = delta;
        else
          L[v[c][k]] += delta;   // no other check of the layer has v
      }
    }
  }
}

// A grouped layer's second half: each variable adds its edges' deltas in
// edge order. Every thread of the block calls it.
__device__ void ldpc_grouped_add(float* L, const float* D, int le0,
                                 const LdpcPlan& p, int l) {
  const int j1 = __ldg(p.var_ptr + l + 1);
  for (int j = __ldg(p.var_ptr + l) + threadIdx.x; j < j1; j += blockDim.x) {
    float upd = 0.f;
    const int f1 = __ldg(p.var_edge_ptr + j + 1);
    for (int f = __ldg(p.var_edge_ptr + j); f < f1; ++f)
      upd += D[__ldg(p.var_edge + f) - le0];
    L[__ldg(p.var_id + j)] += upd;
  }
}

// The shared memory a block takes: the row's posterior, messages and
// deltas, the check words, two syndrome flags and the 16-bit variables.
__host__ __device__ inline size_t ldpc_smem(int n, int n_edges,
                                            int layer_scratch, int n_layers,
                                            int layer_slots) {
  return sizeof(float) * ((size_t)n + n_edges + layer_scratch) +
         sizeof(int) * ((size_t)n_layers * layer_slots + 2) +
         sizeof(unsigned short) * (size_t)n_edges;
}

// Registers: a lane of one edge slot decodes in 32 (so that an SM holds
// four blocks of 512 threads), a wider one in 64 (two).
template <int K, int P>
__global__ void __launch_bounds__(LDPC_THREADS_MAX, K == 1 ? 4 : 2)
ldpc_layered_kernel(const float* __restrict__ llr, LdpcPlan p,
                    long long* __restrict__ bits,
                    long long* __restrict__ iters, bool* __restrict__ ok,
                    float* __restrict__ post, int max_iter, int minsum,
                    float alpha, float beta) {
  extern __shared__ float smem[];
  float* L = smem;                 // posterior [n]
  float* R = L + p.n;              // check messages [n_edges]
  float* D = R + p.n_edges;        // a grouped layer's deltas
  int* words = (int*)(D + p.layer_scratch);   // [n_layers][layer_slots]
  int* bad = words + p.n_layers * p.layer_slots;  // [2] a check failed
  unsigned short* ev = (unsigned short*)(bad + 2);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row = blockIdx.x;
  const float* in = llr + row * p.n;
  for (int i = tid; i < p.n_layers * p.layer_slots; i += nt)
    words[i] = __ldg(p.lane_check + i);
  for (int e = tid; e < p.n_edges; e += nt) {
    ev[e] = __ldg(p.lane_var + e);
    R[e] = 0.f;
  }
  for (int i = tid; i < p.n; i += nt) L[i] = in[i];
  if (tid < 2) bad[tid] = 0;
  __syncthreads();
  const int G = p.group, gshift = __ffs(G) - 1;
  const int lg = tid & (G - 1), g = tid >> gshift, ng = nt >> gshift;
  // bad[s & 1]: the syndrome after s sweeps (0: the input's); each flag is
  // cleared a sweep after it was read, behind the layers' barriers
  if (ldpc_row_bad<K, P>(L, words, ev, p, lg, g, ng, gshift)) bad[0] = 1;
  __syncthreads();
  bool done = bad[0] == 0;
  long long it_out = done ? 0 : (long long)max_iter + 1;
  for (int it = 0; !done && it < max_iter; ++it) {
    for (int l = 0; l < p.n_layers; ++l) {
      const int* w = words + l * p.layer_slots;
      ldpc_layer<K, P>(L, R, D, w, ev, p, lg, g, ng, gshift, minsum, alpha,
                       beta);
      __syncthreads();
      if (p.layer_scratch > 0) {
        ldpc_grouped_add(L, D, w[0] & 0xffff, p, l);
        __syncthreads();
      }
    }
    if (tid == 0) bad[it & 1] = 0;
    if (ldpc_row_bad<K, P>(L, words, ev, p, lg, g, ng, gshift))
      bad[(it + 1) & 1] = 1;
    __syncthreads();
    done = bad[(it + 1) & 1] == 0;
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

// The kernel of a plan's slots a lane and checks a lane; nullptr for a pair
// it does not take.
typedef void (*LdpcKernel)(const float*, LdpcPlan, long long*, long long*,
                           bool*, float*, int, int, float, float);

static LdpcKernel ldpc_kernel(int slots_lane, int checks_lane) {
  switch (slots_lane * 4 + checks_lane) {
    case 1 * 4 + 1: return ldpc_layered_kernel<1, 1>;
    case 1 * 4 + 2: return ldpc_layered_kernel<1, 2>;
    case 2 * 4 + 1: return ldpc_layered_kernel<2, 1>;
    case 2 * 4 + 2: return ldpc_layered_kernel<2, 2>;
    default: return nullptr;
  }
}

static cudaError_t ldpc_prepare(LdpcKernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A block a row, of row_threads threads (LdpcPlan.geometry).
extern "C" int ldpc_launch(const float* llr, const int* lane_check,
                           const short* lane_var, const int* var_ptr,
                           const int* var_id, const int* var_edge_ptr,
                           const int* var_edge, long long* bits,
                           long long* iters, bool* ok, float* post,
                           int batch, int n, int n_layers, int n_edges,
                           int layer_slots, int layer_scratch, int group,
                           int slots_lane, int checks_lane, int row_threads,
                           int max_iter, int minsum, float alpha, float beta,
                           void* stream) {
  if (batch == 0) return (int)cudaSuccess;
  const LdpcKernel kernel = ldpc_kernel(slots_lane, checks_lane);
  if (kernel == nullptr || n < 1 || n > 65536 || n_layers < 1 ||
      n_edges < 1 || n_edges > 65536 || layer_slots < 1 || max_iter < 0 ||
      layer_scratch < 0 || group < 1 || group > 32 ||
      (group & (group - 1)) != 0 || row_threads < 32 ||
      row_threads > LDPC_THREADS_MAX || row_threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ldpc_smem(n, n_edges, layer_scratch, n_layers, layer_slots);
  if (smem > LDPC_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = ldpc_prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  LdpcPlan p{lane_check, (const unsigned short*)lane_var, var_ptr,  var_id,
             var_edge_ptr, var_edge, n, n_layers, n_edges, layer_slots,
             layer_scratch, group};
  kernel<<<batch, row_threads, smem, (cudaStream_t)stream>>>(
      llr, p, bits, iters, ok, post, max_iter, minsum, alpha, beta);
  return (int)cudaGetLastError();
}

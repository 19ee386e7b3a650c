// Noncoherent matched-filter scores of a template bank at every lag, and the
// same scores max-reduced over the bank, as a Toeplitz GEMM on the tensor
// cores.
//
// dmf_launch replaces mercury_tpu/dsp/pallas_kernels.py:deep_mf_score
// (_deep_mf_kernel) and dmf_max_launch replaces deep_mf_max
// (_deep_mf_max_kernel). The TPU kernels correlate in the frequency domain
// and take the inverse DFT inside the kernel as two MXU matmuls. These
// compute the same scores as a time-domain correlation:
//   c[b,a,l,d] = | sum_k seg[b, d + l*S + k] * conj(t[a, l, k]) |
//   e_l        = ce[b, d + l*S + S] - ce[b, d + l*S]   (prefix sums of |seg|^2)
//   score[b,a,d] = sum_l [e_l > ef[b]] * c * rsqrt(max(e_l, ef[b]))
// with t normalized per (a, l) by the wrapper (as the JAX wrapper pre-divides
// its template spectra). dmf_max_launch writes smax[b,d] = max_a score[b,a,d]
// and sarg[b,d] = the first a that reaches it (strict >, as the TPU kernel),
// so the [B, A, 2w+1] surface never reaches device memory.
//
// The correlation is a GEMM in disguise. In real form, with K = (k, re/im)
// interleaved, part l is X_l @ B_l: X_l[d, 2k + r] = (Re, Im)[r] of
// seg[d + l*S + k] is a Toeplitz matrix, and B_l [2S, N] is the packed
// conjugate bank (dsp/kernels.py:dmf_pack_bank) whose columns 2a and 2a+1
// give Re and Im of hypothesis a. X_l needs no im2col: row d of it is the
// segment window read from sample d + l*S on, so the A operand of a warpgroup
// MMA (wgmma, A from registers) is read straight from the window staged in
// shared memory. Inside one k8 step the order of K is free, so physical
// column c (c < 4) takes Re and column c + 4 takes Im of the same sample: a
// thread's a0/a2 (and a1/a3) are one complex sample, one 8-byte load. B is
// read by the tensor cores from shared memory through a wgmma descriptor, in
// K-major 8 x 16-byte core matrices without swizzle; the wrapper lays the
// bank out that way ([Lp, S/4, N/8, 2, 8, 4]), so a ring stage is one
// contiguous copy. The accumulator gives each thread C[g][2t] and
// C[g][2t+1]: Re and Im of one hypothesis, so |c| and the energy gate apply
// in registers.
//
// Numerics: wgmma m64nNk8 in TF32, one pass, float32 accumulation. The
// window is rounded with cvt.rna.tf32.f32 when staged, the bank by the
// wrapper with the same rounding; the gate and its weights are float32 from
// the prefix sums, so gated windows still score exactly 0.
//
// Blocks: one per (lag tile, row b), WG warpgroups of R m64 tiles each; all
// hypotheses of the tile in the block (N in chunks of 128 columns if 2A is
// wider). The block stages its segment window (tile + (Lp-1)*S + S samples)
// and the gate weights once, then streams the bank in chunks of CH samples
// through a cp.async ring, so the bank is read from L2 once per block (at
// CONFIG_0 a block is 256 lags x 128 columns: ~8 GB of L2 reads a call).
// Per chunk each warpgroup loads its A fragments, issues CH/4 wgmmas per
// m64 tile and waits for them before the ring slot is reused. Parts l are
// folded as |c| * w_l after each part's K loop. deep_mf_max reduces (max,
// first argmax) in registers over a thread's hypotheses and across a quad by
// shuffles with an explicit index compare (one warpgroup holds a row's whole
// N chunk), then over N chunks in registers, in order of a; padded columns
// never win. deep_mf_score stages each N chunk's [A, tile] scores in shared
// memory and stores them coalesced along d.
//
// Bound: the tensor cores' TF32 rate, reached in part (~280 of 495 TFLOP/s
// at CONFIG_0's shape): each warpgroup waits for a chunk's wgmmas before it
// reads the next chunk's A fragments, so its fragment loads and epilogue do
// not overlap its own MMAs; other warpgroups on the SM fill some of the gap.
// Keeping two chunks in flight per warpgroup is the next step.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

struct DmfArgs {
  const float2* seg;          // [B, seg_len]
  const float* bank;          // [Lp, S4, n_cols / 8, 2, 8, 4] packed, TF32
  const float* ce;            // [B, seg_len + 1] energy prefix sums
  const float* ef;            // [B] silence floor
  float* out;                 // [B, A, n_cand] (deep_mf_score)
  float* smax;                // [B, n_cand] (deep_mf_max)
  long long* sarg;            // [B, n_cand] (deep_mf_max)
  int num_a, seg_len, lp, s, n_cand, n_cols;
};

// Block geometry: WG warpgroups along M with R m64 tiles each, NT n8-tiles
// (the whole N chunk) per wgmma; the bank streams in chunks of CH complex
// rows through a ring of STAGES slots.
template <int WG_, int R_, int NT_, int CH_, int STAGES_>
struct Tile {
  static constexpr int WG = WG_, R = R_, NT = NT_, CH = CH_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = 128 * WG;
  static constexpr int M = WG * R * 64;       // lags per block
  static constexpr int N = NT * 8;            // real columns per N chunk
  static constexpr int HYP = N / 2;           // hypotheses per N chunk
  static constexpr int KS = CH / 4;           // k8 steps per chunk
  static constexpr int SLOT = KS * NT * 64;   // floats per ring slot
  static constexpr int OS = M + 8;            // score staging row stride
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// wgmma descriptor of a K-major k8 slab without swizzle: 8 x 16-byte core
// matrices, the two K halves 128 bytes apart (leading byte offset), the
// 8-column groups 256 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t wg_desc(const float* slab) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(slab));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int NV>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < NV; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d[64 x 8*NT] += a[64 x 8] (registers) * b[8 x 8*NT] (descriptor), TF32
#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc) {
  if constexpr (NT == 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : D4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (NT == 2) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : D4(0), D4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (NT == 3) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (NT == 4) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8), D4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else {
    static_assert(NT == 16, "wgmma widths: 8, 16, 24, 32 or 128 columns");
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
        D4(32), D4(36), D4(40), D4(44), D4(48), D4(52), D4(56), D4(60)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
}
#undef D4

template <class T>
__host__ __device__ constexpr int dmf_window(int lp, int s) {
  // lags of the tile + the parts' offsets + S rounded up to whole chunks
  return T::M + (lp - 1) * s + (s + T::CH - 1) / T::CH * T::CH;
}

template <bool MAX, class T>
__host__ __device__ constexpr size_t dmf_smem(int lp, int s) {
  return sizeof(float) * T::STAGES * T::SLOT
         + sizeof(float2) * dmf_window<T>(lp, s)
         + sizeof(float) * lp * T::M
         + (MAX ? 0 : sizeof(float) * T::HYP * T::OS);  // score staging
}

// MAX: deep_mf_max, else deep_mf_score. ONE: Lp == 1, so a part's |c| * w is
// the score and no second set of per-hypothesis registers is needed.
template <bool MAX, class T, bool ONE>
__global__ void __launch_bounds__(T::THREADS)
dmf_wgmma_kernel(const DmfArgs p) {
  constexpr int R = T::R, NT = T::NT, KS = T::KS, CH = T::CH;
  constexpr int STAGES = T::STAGES;
  extern __shared__ float4 smem4[];
  float* s_ring = reinterpret_cast<float*>(smem4);
  float2* s_x = reinterpret_cast<float2*>(s_ring + STAGES * T::SLOT);
  const int win = dmf_window<T>(p.lp, p.s);
  float* s_w = reinterpret_cast<float*>(s_x + win);       // [Lp][M]
  float* s_o = s_w + p.lp * T::M;                         // [HYP][OS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * T::M;
  const int s = p.s, lp = p.lp;
  const int s4 = (s + 3) / 4;                             // k8 steps of S
  const int ng = p.n_cols / 8;                            // 8-column groups
  const int kch = (s + CH - 1) / CH;                      // chunks per part
  const int nch = (ng + NT - 1) / NT;                     // N chunks
  const int n_q = nch * lp * kch;

  // chunks go in order (N chunk, part, CH rows); the producer copies the
  // next one into its ring slot, k8 steps past S and groups past n_cols as
  // zeros
  int ld_kc = 0, ld_l = 0, ld_nc = 0, ld_slot = 0;
  auto load_next = [&]() {
    float* slot = s_ring + ld_slot * T::SLOT;
    for (int e = tid; e < KS * NT * 16; e += T::THREADS) {
      const int c = e & 15;                 // 16 bytes of a core-matrix pair
      const int grp = (e >> 4) % NT;
      const int ks = (e >> 4) / NT;
      const int k4 = ld_kc * KS + ks;
      const int gg = ld_nc * NT + grp;
      const bool ok = k4 < s4 && gg < ng;
      const float* src =
          ok ? p.bank + ((size_t)((ld_l * s4 + k4) * ng + gg) * 64 + c * 4)
             : p.bank;
      cp_async16(slot + (ks * NT + grp) * 64 + c * 4, src, ok ? 16 : 0);
    }
    if (++ld_slot == STAGES) ld_slot = 0;
    if (++ld_kc == kch) {
      ld_kc = 0;
      if (++ld_l == lp) {
        ld_l = 0;
        ++ld_nc;
      }
    }
  };

  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < n_q) load_next();
    cp_async_commit();
  }

  // the segment window (TF32) and the per-(part, lag) gate weights
  const float2* seg_b = p.seg + (size_t)b * p.seg_len;
  for (int i = tid; i < win; i += T::THREADS) {
    const int gi = d0 + i;
    const float2 v = gi < p.seg_len ? seg_b[gi] : make_float2(0.f, 0.f);
    s_x[i] = make_float2(__uint_as_float(to_tf32(v.x)),
                         __uint_as_float(to_tf32(v.y)));
  }
  const float* ce_b = p.ce + (size_t)b * (p.seg_len + 1);
  const float floor_e = p.ef[b];
  for (int i = tid; i < lp * T::M; i += T::THREADS) {
    const int l = i / T::M;
    const int d = d0 + i - l * T::M;
    float w = 0.f;
    if (d < p.n_cand) {
      const float e_l = ce_b[d + l * s + s] - ce_b[d + l * s];
      if (e_l > floor_e) w = rsqrtf(fmaxf(e_l, floor_e));
    }
    s_w[i] = w;
  }

  float acc[R][NT][4];                      // acc[i][j] = d[4j .. 4j+3]
  float sc[ONE ? 1 : R][ONE ? 1 : NT][2];   // score so far, rows g and g+8
  float best[MAX ? R : 1][2];               // deep_mf_max over N chunks
  int arg[MAX ? R : 1][2];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
      if constexpr (!ONE) sc[i][j][0] = sc[i][j][1] = 0.f;
    }
  // row of (i, h): row0 + i*64 + h*8 (warp w of its warpgroup: 16 rows)
  const int row0 = (warp >> 2) * R * 64 + (warp & 3) * 16 + g;

  int kc = 0, l = 0, nc = 0, slot = 0;   // the consumer's chunk
  for (int q = 0; q < n_q; ++q) {
    cp_async_wait<STAGES - 2>();
    // the copies are generic-proxy writes; wgmma reads in the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                 // chunk q landed; slot q-1 is free
    if (q + STAGES - 1 < n_q) load_next();
    cp_async_commit();

    uint32_t af[R][KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2* xw = s_x + l * s + kc * CH + ks * 4 + t + row0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float2 lo = xw[i * 64];
        const float2 hi = xw[i * 64 + 8];
        af[i][ks][0] = __float_as_uint(lo.x);     // (g,   t):   Re, row g
        af[i][ks][1] = __float_as_uint(hi.x);     // (g+8, t):   Re, row g+8
        af[i][ks][2] = __float_as_uint(lo.y);     // (g,   t+4): Im, row g
        af[i][ks][3] = __float_as_uint(hi.y);     // (g+8, t+4): Im, row g+8
      }
    }
    const float* sb = s_ring + slot * T::SLOT;
#pragma unroll
    for (int i = 0; i < R; ++i) reg_fence<NT * 4>(&acc[i][0][0]);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t desc = wg_desc(sb + ks * NT * 64);
#pragma unroll
      for (int i = 0; i < R; ++i)
        wgmma_tf32<NT>(&acc[i][0][0], af[i][ks], desc);
    }
    wg_commit_wait();
#pragma unroll
    for (int i = 0; i < R; ++i) reg_fence<NT * 4>(&acc[i][0][0]);

    const bool part_end = kc == kch - 1;
    const int l_done = l, nc_done = nc;
    if (++slot == STAGES) slot = 0;
    if (++kc == kch) {
      kc = 0;
      if (++l == lp) {
        l = 0;
        ++nc;
      }
    }
    if (!part_end) continue;

    // end of a part: fold |c| * w_l; the score of (row, hypothesis) lands in
    // acc[i][j][0] (row g) and acc[i][j][2] (row g+8) at the last part
    const float* w_l = s_w + l_done * T::M + row0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float w0 = w_l[i * 64], w1 = w_l[i * 64 + 8];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float* c = acc[i][j];
        float v0 = sqrtf(c[0] * c[0] + c[1] * c[1]) * w0;
        float v1 = sqrtf(c[2] * c[2] + c[3] * c[3]) * w1;
        if constexpr (!ONE) {
          v0 = (sc[i][j][0] += v0);
          v1 = (sc[i][j][1] += v1);
        }
        c[0] = v0;
        c[1] = 0.f;
        c[2] = v1;
        c[3] = 0.f;
      }
    }
    if (l_done != lp - 1) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][2] = 0.f;
      continue;
    }

    // end of an N chunk: hypothesis of (thread, j) is a0 + j*4 + t
    const int a0 = nc_done * T::HYP;
    if constexpr (MAX) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float bv = -CUDART_INF_F;
          int ba = 0x7fffffff;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int a = a0 + j * 4 + t;
            const float v = acc[i][j][2 * h];
            if (a < p.num_a && v > bv) {
              bv = v;
              ba = a;
            }
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, bv, off);
            const int oa = __shfl_xor_sync(0xffffffffu, ba, off);
            if (ob > bv || (ob == bv && oa < ba)) {
              bv = ob;
              ba = oa;
            }
          }
          // earlier N chunks hold lower a: strict >
          if (nc_done == 0 || bv > best[i][h]) {
            best[i][h] = bv;
            arg[i][h] = ba;
          }
          const int d = d0 + row0 + i * 64 + h * 8;
          if (nc_done == nch - 1 && t == 0 && d < p.n_cand) {
            p.smax[(size_t)b * p.n_cand + d] = best[i][h];
            p.sarg[(size_t)b * p.n_cand + d] = arg[i][h];
          }
        }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int ha = j * 4 + t;
          s_o[ha * T::OS + row0 + i * 64] = acc[i][j][0];
          s_o[ha * T::OS + row0 + i * 64 + 8] = acc[i][j][2];
        }
      __syncthreads();
      for (int e = tid; e < T::HYP * T::M; e += T::THREADS) {
        const int ha = e / T::M;
        const int m = e - ha * T::M;
        const int a = a0 + ha;
        const int d = d0 + m;
        if (a < p.num_a && d < p.n_cand)
          p.out[((size_t)b * p.num_a + a) * p.n_cand + d] =
              s_o[ha * T::OS + m];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[i][j][0] = acc[i][j][2] = 0.f;
        if constexpr (!ONE) sc[i][j][0] = sc[i][j][1] = 0.f;
      }
  }
  cp_async_wait<0>();
}

cudaError_t dmf_smem_attr(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool MAX, class T, bool ONE>
cudaError_t dmf_run(const DmfArgs& p, int batch, cudaStream_t stream) {
  const size_t smem = dmf_smem<MAX, T>(p.lp, p.s);
  const void* kernel = (const void*)dmf_wgmma_kernel<MAX, T, ONE>;
  cudaError_t err = dmf_smem_attr(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_cand + T::M - 1) / T::M, batch);
  dmf_wgmma_kernel<MAX, T, ONE><<<grid, T::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tiles by the bank's width, tuned on the H100 at the receive shapes: up to
// 16 hypotheses (n_cols <= 32) one warpgroup of four m64 tiles (256 lags)
// and 16-row chunks; wider banks N chunks of 128 columns, 64-row chunks in a
// 2-slot ring and four warpgroups of one m64 tile (Lp 1), or 32-row chunks,
// 3 slots and two warpgroups (Lp > 1: the per-part scores take registers).
template <int NT>
using Narrow = Tile<1, 4, NT, 16, 4>;
using Wide1 = Tile<4, 1, 16, 64, 2>;
using WideP = Tile<2, 1, 16, 32, 3>;

template <bool MAX>
cudaError_t dmf_dispatch(const DmfArgs& p, int batch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.n_cols / 8) {
    case 1: return dmf_run<MAX, Narrow<1>, false>(p, batch, st);
    case 2: return dmf_run<MAX, Narrow<2>, false>(p, batch, st);
    case 3: return dmf_run<MAX, Narrow<3>, false>(p, batch, st);
    case 4: return dmf_run<MAX, Narrow<4>, false>(p, batch, st);
    default:
      if (p.lp == 1) return dmf_run<MAX, Wide1, true>(p, batch, st);
      return dmf_run<MAX, WideP, false>(p, batch, st);
  }
}

}  // namespace

// tmpl: the packed bank [Lp, ceil(S/4), n_cols / 8, 2, 8, 4] float32
// (TF32-rounded), n_cols = 2A rounded up to a multiple of 8
extern "C" int dmf_launch(const float2* seg, const float* tmpl,
                          const float* ce, const float* ef, float* out,
                          int batch, int num_a, int seg_len, int lp, int s,
                          int n_cand, int n_cols, void* stream) {
  if (batch > 65535 || n_cols % 8 != 0 || n_cols < 2 * num_a)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || num_a == 0 || n_cand == 0) return (int)cudaSuccess;
  const DmfArgs p{seg, tmpl, ce, ef, out, nullptr, nullptr,
                  num_a, seg_len, lp, s, n_cand, n_cols};
  return (int)dmf_dispatch<false>(p, batch, stream);
}

extern "C" int dmf_max_launch(const float2* seg, const float* tmpl,
                              const float* ce, const float* ef, float* smax,
                              long long* sarg, int batch, int num_a,
                              int seg_len, int lp, int s, int n_cand,
                              int n_cols, void* stream) {
  if (batch > 65535 || n_cols % 8 != 0 || n_cols < 2 * num_a)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || num_a == 0 || n_cand == 0) return (int)cudaSuccess;
  const DmfArgs p{seg, tmpl, ce, ef, nullptr, smax, sarg,
                  num_a, seg_len, lp, s, n_cand, n_cols};
  return (int)dmf_dispatch<true>(p, batch, stream);
}

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
//
// dmf_best_launch (deep_mf_best) writes only the best lag and score of each
// (row, hypothesis), the first lag reaching it, as torch.argmax and gather
// take them from deep_mf_score's surface; it replaces that surface and its
// argmax in mercury_tpu/modem/sync.py:matched_filter_refine_bank for banks
// of up to 16 hypotheses where the rows fill the card (dmf_best_rows: the
// pool's scan and refines; a link's few rows keep the surface). Its
// design, for the narrow banks where the surface kernel above is bound by
// shared memory (each lag's A fragments read once a part, m64n24 MMAs at
// CONFIG_3's scan with 18 of 24 columns real) and writes a surface nobody
// keeps:
// - the parts side by side in N (column l*2A + 2a + r): Toeplitz row r of
//   the segment is multiplied once by every part's templates, and part l of
//   lag d is row d + l*S. At CONFIG_3's scan one m64n72k8 a k8 step, every
//   column real; a row's A fragments and their shared-memory reads are
//   taken once, not Lp times;
// - a block is up to four workers, each a warpgroup walking whole rows
//   (persistent, as many blocks as fit), 128 Toeplitz rows a tile, around
//   one copy of the bank in shared memory; a worker's next window lands by
//   cp.async under its MMAs, and its epilogue runs under the others' MMAs;
// - two chunks in flight a worker (wait_group 1): the next k8 step's A
//   fragments load while the last one multiplies;
// - |c| * w(r) of row r, part l goes to lag r - l*S in a ring of partial
//   scores in shared memory ([M + (Lp-1)*S][A]): part 0 stores, the later
//   parts add in order of l (tiles run in order of r, and a tile no taller
//   than S gives a lag at most one part; a taller one adds the parts in
//   passes), so each score is the surface kernel's, bit for bit: the same
//   TF32 products over K in the same order, the same fold. A lag whose last
//   part has landed joins the running best of its thread (strict >, lags in
//   increasing order), and at a row's end the threads' bests reduce with
//   ties to the lower lag: one store a (row, hypothesis).
// Bound: shared memory's bandwidth as much as the tensor cores. At
// CONFIG_3's scan each m64n72k8 (36 clocks of TF32 math) reads 2.3 KB of
// bank and 2 KB of A fragments from shared memory (~34 clocks), and
// without its epilogue the kernel runs at ~42% of the TF32 rate.

#include <cuda_runtime.h>
#include <algorithm>
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

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// 8 bytes global -> shared; src_bytes 0 fills them with zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
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
  } else if constexpr (NT == 5) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (NT == 9) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
        D4(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else {
    static_assert(NT == 16,
                  "wgmma widths: 8, 16, 24, 32, 40, 72 or 128 columns");
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
  void (*kernel)(DmfArgs) = dmf_wgmma_kernel<MAX, T, ONE>;
  cudaError_t err = dmf_smem_attr((const void*)kernel, smem);
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

// ---------------------------------------------------------------------------
// deep_mf_best: the best lag and score of each (row, hypothesis)
// ---------------------------------------------------------------------------

struct DmfBestArgs {
  const float2* seg;          // [B, seg_len]
  const float* bank;          // [ceil(S/4), ng, 2, 8, 4] packed, TF32
  const float* ce;            // [B, seg_len + 1] energy prefix sums
  const float* ef;            // [B] silence floor
  float* score;               // [B, A] best score
  long long* lag;             // [B, A] the first lag reaching it
  int batch, num_a, seg_len, lp, s, n_cand, ng;
};

// A worker is one warpgroup walking whole rows, R m64 tiles of Toeplitz rows
// a tile, chunks of KS k8 steps; every (part, hypothesis) column pair in the
// NT n8 tiles of one wgmma. A block is up to W workers around one copy of
// the bank, each with its own windows, ring and barrier, so one worker's
// epilogue runs under another's MMAs. Tuned on the H100 at CONFIG_3's scan
// and refine: four workers of one k8 step a chunk (128 registers) beat
// one to three workers and two or four steps a chunk; the widest bank (16
// tiles) takes two, for its accumulators.
constexpr int kBestR = 2, kBestKS = 1;
constexpr int kBestM = kBestR * 64;
constexpr int kBestMaxA = 16;

template <int NT_>
struct Best {
  static constexpr int NT = NT_, R = kBestR, KS = kBestKS, M = kBestM;
  static constexpr int W = NT > 9 ? 2 : 4, THREADS = 128 * W;
};

// the n8 tiles a bank of ng 8-column groups takes: the wgmma widths built
__host__ __device__ constexpr int best_nt(int ng) {
  return ng <= 5 ? ng : ng <= 9 ? 9 : ng <= 16 ? 16 : 0;
}

// shared memory of deep_mf_best, as float offsets: the bank (k8 steps
// rounded up to whole chunks), then a region a worker: two segment windows
// (float2), two tiles' gate weights, the ring of partial scores [rs][A],
// and the reduction's score and lag a thread
struct BestSmem {
  int s4p, win, rs;
  size_t bank, x, w, p, red, worker;    // worker: floats a worker's region
  __host__ __device__ BestSmem(int nt, int num_a, int lp, int s) {
    s4p = ((s + 3) / 4 + kBestKS - 1) / kBestKS * kBestKS;
    win = kBestM + 4 * s4p;
    rs = kBestM + (lp - 1) * s;
    bank = (size_t)s4p * nt * 64;
    x = 0;
    w = 4 * (size_t)win;
    p = w + 2 * kBestM;
    red = p + (size_t)rs * num_a;
    worker = (red + 2 * 128 + 3) / 4 * 4;
  }
  __host__ __device__ size_t bytes(int workers) const {
    return sizeof(float) * (bank + workers * worker);
  }
};

template <int R, int KS>
__device__ __forceinline__ void best_frags(uint32_t (&f)[R][KS][4],
                                           const float2* x) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float2 lo = x[k * 4 + i * 64];
      const float2 hi = x[k * 4 + i * 64 + 8];
      f[i][k][0] = __float_as_uint(lo.x);
      f[i][k][1] = __float_as_uint(hi.x);
      f[i][k][2] = __float_as_uint(lo.y);
      f[i][k][3] = __float_as_uint(hi.y);
    }
}

// one chunk's wgmmas, committed as a group; the fence orders the A
// fragments just loaded before them
template <int R, int NT, int KS>
__device__ __forceinline__ void best_mma(float (&acc)[R][NT][4],
                                         const uint32_t (&f)[R][KS][4],
                                         const float* b) {
  wg_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint64_t desc = wg_desc(b + k * NT * 64);
#pragma unroll
    for (int i = 0; i < R; ++i) wgmma_tf32<NT>(&acc[i][0][0], f[i][k], desc);
  }
  wg_commit();
}

// the 128 threads of worker wk (named barrier 1 + wk)
__device__ __forceinline__ void worker_sync(int wk) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wk) : "memory");
}

// deep_mf_best's kernel: the name of deep_mf_score's (MAX false), its own
// arguments. With W = blockDim.x / 128 workers a block, worker gw =
// blockIdx.x * W + wk walks rows gw, gw + W * gridDim.x, ... tile by tile;
// its item q is tile q % n_tiles of its row q / n_tiles.
template <bool MAX, class T, bool ONE>
__global__ void __launch_bounds__(T::THREADS)
dmf_wgmma_kernel(const DmfBestArgs p) {
  constexpr int R = T::R, NT = T::NT, KS = T::KS, M = T::M;
  static_assert(!MAX && !ONE && M == 128,
                "a thread a Toeplitz row of the tile for its gate weight");
  extern __shared__ float4 smem4[];
  const BestSmem L(NT, p.num_a, p.lp, p.s);
  const int wk = threadIdx.x >> 7;
  float* s_bank = reinterpret_cast<float*>(smem4);          // [s4p][NT][64]
  float* sm = s_bank + L.bank + wk * L.worker;
  float2* s_x = reinterpret_cast<float2*>(sm + L.x);        // [2][win]
  float* s_w = sm + L.w;                                    // [2][M]
  float* s_p = sm + L.p;                                    // [rs][A]
  float* s_rv = sm + L.red;                                 // [128]
  int* s_ra = reinterpret_cast<int*>(s_rv + 128);           // [128]

  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s = p.s, lp = p.lp, na = p.num_a, rs = L.rs, win = L.win;
  const int s4 = (s + 3) / 4;
  const int n_rows = p.n_cand + (lp - 1) * s;   // Toeplitz rows a segment
  const int n_tiles = (n_rows + M - 1) / M;
  const int n_wk = blockDim.x >> 7;
  const int gw = blockIdx.x * n_wk + wk, n_w = gridDim.x * n_wk;
  const int n_items = gw < p.batch ? ((p.batch - 1 - gw) / n_w + 1) * n_tiles
                                   : 0;

  // the bank, once a block; k8 steps past S and groups past ng as zeros
  for (int e = threadIdx.x; e < L.s4p * NT * 16; e += blockDim.x) {
    const int c = e & 15, grp = (e >> 4) % NT, ks = (e >> 4) / NT;
    const bool ok = ks < s4 && grp < p.ng;
    cp_async16(s_bank + (ks * NT + grp) * 64 + c * 4,
               ok ? p.bank + ((size_t)(ks * p.ng + grp) * 64 + c * 4)
                  : p.bank,
               ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  // the bank's copies are generic-proxy writes; wgmma reads in the async
  // proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (n_items == 0) return;

  // staging of item q into buffer bf: the window (TF32) by cp.async, and
  // the gate weight of the thread's row from its prefix sums, loaded
  // before the tile in flight and finished after it
  auto row_of = [&](int q) { return gw + q / n_tiles * n_w; };
  auto stage_window = [&](int q, int bf) {
    const float2* src = p.seg + (size_t)row_of(q) * p.seg_len;
    const int r0 = q % n_tiles * M;
    for (int i = tid; i < win; i += 128) {
      const bool ok = r0 + i < p.seg_len;
      cp_async8(s_x + bf * win + i, ok ? src + r0 + i : src, ok ? 8 : 0);
    }
    cp_async_commit();
  };
  float ce_hi = 0.f, ce_lo = 0.f, floor_e = 0.f;
  auto load_energy = [&](int q) {
    const int b = row_of(q), r = q % n_tiles * M + tid;
    const float* ce_b = p.ce + (size_t)b * (p.seg_len + 1);
    floor_e = p.ef[b];
    if (r < n_rows) {
      ce_hi = ce_b[r + s];
      ce_lo = ce_b[r];
    }
  };
  auto finish_stage = [&](int q, int bf) {
    cp_async_wait<0>();
    for (int i = tid; i < win; i += 128) {
      const float2 v = s_x[bf * win + i];
      s_x[bf * win + i] = make_float2(__uint_as_float(to_tf32(v.x)),
                                      __uint_as_float(to_tf32(v.y)));
    }
    float w = 0.f;
    if (q % n_tiles * M + tid < n_rows) {
      const float e_l = ce_hi - ce_lo;
      if (e_l > floor_e) w = rsqrtf(fmaxf(e_l, floor_e));
    }
    s_w[bf * M + tid] = w;
  };

  stage_window(0, 0);
  load_energy(0);
  finish_stage(0, 0);
  worker_sync(wk);

  // column pair 4j + t of the thread is (part, hypothesis) = divmod(., A)
  const int l_t = t / na, a_t = t % na;
  // the reduction's part: hypothesis ra over lag group rq of qc
  const int qc = 128 / na;
  const int ra = tid % na, rq = tid / na;
  // the thread's Toeplitz row in an m64 tile (rows of the four warps)
  const int row0 = warp * 16 + g;
  // a tile no taller than S adds at most one part to a lag, so the parts
  // of one tile need no order among them
  const bool one_pass = M <= s;
  float best = -1.f;
  int arg = 0, done = 0;
  // ring slots (lag mod rs) of the tile's first row and of `done`
  int r0_slot = 0, done_slot = 0;

  for (int q = 0; q < n_items; ++q) {
    const int bf = q & 1;
    const int tile = q % n_tiles;
    const int r0 = tile * M;
    if (q + 1 < n_items) {
      stage_window(q + 1, bf ^ 1);
      load_energy(q + 1);
    }

    // X (the window's Toeplitz rows) @ the bank, two chunks in flight: the
    // A fragments of the next chunk load while the last one multiplies
    float acc[R][NT][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    const float2* xr = s_x + bf * win + row0 + t;
    const int n_chunks = L.s4p / KS;
    uint32_t f0[R][KS][4], f1[R][KS][4];
    best_frags<R, KS>(f0, xr);
    for (int c = 0; c < n_chunks; c += 2) {
      best_mma<R, NT, KS>(acc, f0, s_bank + c * KS * NT * 64);
      wg_wait<1>();
      if (c + 1 < n_chunks) {
        best_frags<R, KS>(f1, xr + (c + 1) * KS * 4);
        best_mma<R, NT, KS>(acc, f1, s_bank + (c + 1) * KS * NT * 64);
        wg_wait<1>();
      }
      if (c + 2 < n_chunks) best_frags<R, KS>(f0, xr + (c + 2) * KS * 4);
    }
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < R; ++i) reg_fence<NT * 4>(&acc[i][0][0]);

    if (q + 1 < n_items) finish_stage(q + 1, bf ^ 1);

    // |c| * w of row r, part l goes to lag r - l*S: the first part stores,
    // the later ones add in order of l, as deep_mf_score folds its parts
    // (one rounding: its sum and product contract to an fma)
    const float* w_t = s_w + bf * M;
    for (int pass = 0; pass < (one_pass ? 1 : lp); ++pass) {
      int l = l_t, a = a_t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j > 0) {
          a += 4;
          while (a >= na) {
            a -= na;
            ++l;
          }
        }
        if (l >= lp || (!one_pass && l != pass)) continue;
        int base = r0_slot - l * s;            // l * s < rs
        if (base < 0) base += rs;
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = row0 + i * 64 + h * 8;
            const int d = r0 + m - l * s;
            if (d < 0 || d >= p.n_cand) continue;
            int slot = base + m;
            if (slot >= rs) slot -= rs;
            const float* c = &acc[i][j][2 * h];
            float* cell = s_p + slot * na + a;
            *cell = __fmaf_rn(sqrtf(c[0] * c[0] + c[1] * c[1]), w_t[m],
                              l == 0 ? 0.f : *cell);
          }
      }
      if (!one_pass) worker_sync(wk);
    }
    if (one_pass) worker_sync(wk);

    // lags whose last part this tile added: the running best, strict >
    // over each thread's increasing lags
    const int hi = min(p.n_cand, r0 + M - (lp - 1) * s);
    if (rq < qc && done + rq < hi) {
      int slot = done_slot + rq;
      if (slot >= rs) slot -= rs;
      for (int d = done + rq; d < hi; d += qc) {
        const float v = s_p[slot * na + ra];
        if (v > best) {
          best = v;
          arg = d;
        }
        slot += qc;
        if (slot >= rs) slot -= rs;
      }
    }
    if (hi > done) {                         // hi - done <= M <= rs
      done_slot += hi - done;
      if (done_slot >= rs) done_slot -= rs;
      done = hi;
    }
    r0_slot += M;
    if (r0_slot >= rs) r0_slot -= rs;

    if (tile == n_tiles - 1) {
      // the row's end: over the lag groups, ties to the lower lag
      s_rv[tid] = best;
      s_ra[tid] = arg;
      worker_sync(wk);
      if (tid < na) {
        float bv = s_rv[tid];
        int ba = s_ra[tid];
        for (int k = 1; k < qc; ++k) {
          const float v = s_rv[k * na + tid];
          const int d = s_ra[k * na + tid];
          if (v > bv || (v == bv && d < ba)) {
            bv = v;
            ba = d;
          }
        }
        const size_t o = (size_t)row_of(q) * na + tid;
        p.score[o] = bv;
        p.lag[o] = ba;
      }
      best = -1.f;
      arg = 0;
      done = done_slot = r0_slot = 0;
    }
    worker_sync(wk);
  }
}

// a launch of deep_mf_best's kernel for a bank on the current device: its
// workers a block (up to the tile's W, as many as the shared memory holds;
// 0 where not one fits), that shared memory, and the workers the card holds
// at once
struct BestPlan {
  int workers = 0, held = 0;
  size_t smem = 0;
};

template <class T>
cudaError_t best_plan(int num_a, int lp, int s, BestPlan* plan) {
  *plan = BestPlan{};
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const BestSmem L(T::NT, num_a, lp, s);
  int w = T::W;
  while (w > 0 && L.bytes(w) > (size_t)optin) --w;
  if (w == 0) return cudaSuccess;
  const size_t smem = L.bytes(w);
  void (*kernel)(DmfBestArgs) = dmf_wgmma_kernel<false, T, false>;
  if ((err = dmf_smem_attr((const void*)kernel, smem)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      128 * w, smem);
  if (err != cudaSuccess) return err;
  *plan = BestPlan{w, w * std::max(per_sm, 1) * sms, smem};
  return cudaSuccess;
}

// f(Best<NT>{}) with the tile of the bank's width: the parts side by side,
// 2*Lp*A columns in NT n8 tiles; cudaErrorInvalidValue for a bank wider
// than 16 tiles or of more than kBestMaxA hypotheses
template <class F>
cudaError_t best_by_width(int num_a, int lp, F&& f) {
  if (num_a < 1 || num_a > kBestMaxA || lp < 1) return cudaErrorInvalidValue;
  switch (best_nt((2 * lp * num_a + 7) / 8)) {
    case 1: return f(Best<1>{});
    case 2: return f(Best<2>{});
    case 3: return f(Best<3>{});
    case 4: return f(Best<4>{});
    case 5: return f(Best<5>{});
    case 9: return f(Best<9>{});
    case 16: return f(Best<16>{});
    default: return cudaErrorInvalidValue;
  }
}

// the share of the workers deep_mf_best's kernel holds at once that the
// rows must fill before it takes the place of the surface (dmf_best_rows)
constexpr int kBestFillNum = 7, kBestFillDen = 16;

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

// tmpl: deep_mf_best's packed bank [ceil(S/4), ng, 2, 8, 4] float32
// (TF32-rounded), its columns l*2A + 2a + r for part l, ng = 2*Lp*A / 8
// rounded up; score and lag [batch, num_a]. Runs any batch of a bank the
// kernel takes; dmf_best_rows says where that pays
extern "C" int dmf_best_launch(const float2* seg, const float* tmpl,
                               const float* ce, const float* ef, float* score,
                               long long* lag, int batch, int num_a,
                               int seg_len, int lp, int s, int n_cand,
                               void* stream) {
  const DmfBestArgs p{seg, tmpl, ce, ef, score, lag, batch, num_a, seg_len,
                      lp, s, n_cand, (2 * lp * num_a + 7) / 8};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)best_by_width(num_a, lp, [&](auto tile) {
    using T = decltype(tile);
    BestPlan plan;
    cudaError_t err = best_plan<T>(num_a, lp, s, &plan);
    if (err != cudaSuccess) return err;
    if (plan.workers == 0) return cudaErrorInvalidValue;
    if (batch == 0 || n_cand == 0) return cudaSuccess;
    // as many blocks as the card holds at once, each worker walking rows
    const int grid = std::min((batch + plan.workers - 1) / plan.workers,
                              plan.held / plan.workers);
    dmf_wgmma_kernel<false, T, false>
        <<<grid, 128 * plan.workers, plan.smem, st>>>(p);
    return cudaGetLastError();
  });
}

// The fewest rows at which deep_mf_best's kernel takes the place of
// deep_mf_score's surface and its argmax, for a bank of num_a hypotheses
// of lp parts of s samples at n_cand lags on the current device; 0 where
// it never does. A worker walks a whole row alone, multiplying each of the
// row's n_cand + (Lp-1)*S Toeplitz rows by every part. So it takes
// - only banks whose parts add no more Toeplitz rows than there are lags,
//   (Lp-1)*S <= n_cand: on the H100 the kernel lost at every batch at
//   refine_decode's [*, 4864]x[1,4,1088] (513 lags, 3264 rows more; 0.81
//   against 0.36 ms at 256 rows, 3.25 against 2.50 at 2048) and won from
//   a few hundred rows at the receive's other banks;
// - from 7/16 of the workers the card holds at once (231 rows where a
//   block of four workers fills an SM): below, the surface kernel spreads
//   each row over its lag tiles while the fused kernel's one wave leaves
//   SMs idle. The H100's crossovers: c3's scan [*, 14824]x[9,4,136]
//   between 192 and 256 rows (1.50 against 1.17 ms, 1.40 against 1.54),
//   the refines [*, 1088]x[3|5,4,136] between 128 and 192.
extern "C" int dmf_best_rows(int num_a, int lp, int s, int n_cand) {
  if (s < 1 || n_cand < 1 || (long long)(lp - 1) * s > n_cand) return 0;
  int rows = 0;
  best_by_width(num_a, lp, [&](auto tile) {
    BestPlan plan;
    const cudaError_t err = best_plan<decltype(tile)>(num_a, lp, s, &plan);
    if (err == cudaSuccess && plan.workers > 0)
      rows = std::max(1, plan.held * kBestFillNum / kBestFillDen);
    return err;
  });
  return rows;
}

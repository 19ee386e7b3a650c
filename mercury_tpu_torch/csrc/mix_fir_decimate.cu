// Fused mixer + decimating FIR for the receive front end.
//
// Replaces mercury_tpu/dsp/pallas_kernels.py:mix_fir_decimate
// (_mix_fir_decimate_kernel), which computes mix() -> fir_same() -> [::stride]
// in one pass over the real passband. This kernel adds a per-row start so the
// same code serves both front-end FIRs of the receiver:
//   out[b, m] = sum_j taps[j] * x[b, start[b] + m*stride + offset - j]
//   x[b, i]   = pb[b, i] * osc[i] * rot[b, i]   for 0 <= i < n, else 0
// where osc is the float64-phase oscillator table rounded to complex64 and
// rot[b, i] = e^{j w[b] i} an optional per-row frequency offset (freq[b] Hz
// at sample rate fs, w[b] = 2 pi freq[b] / fs in float64; NULL for none,
// rot = 1): the JAX chain mixes a row at fc + f[b] where it decodes at a
// known offset.
// Time-sync FIR: start = 0 for every row (a NULL start), offset = (T-1)//2
// ("same" alignment). Data FIR: start = clipped frame delay, offset =
// T-1-(T-1)//2 (segment alignment of fir_decimate_segment).
//
// Bound: bytes. Each output reads `stride` new passband floats and writes one
// complex64: ~(4*stride + 8) bytes against 4*T flops (T = 33 on every mode).
//
// Design. A direct kernel (one thread per output, two global loads per tap)
// loads and mixes every passband sample T/stride times and is held back by
// its load instructions, not by HBM. Here a block owns MFD_TILE outputs of
// MFD_ROWS rows (one row when rows start at different places). It stages the
// tile's input window, (tile-1)*stride + T samples, reading each sample and
// its oscillator value once, coalesced, and mixing it once into shared
// memory; rows that share a start share the oscillator read. Where the rows
// and the oscillator are 16-byte aligned (the receive path) a thread loads 4
// samples at once, so more bytes are in flight per load; a block's staging
// is latency-bound, and blocks on an SM overlap one's staging with another's
// arithmetic. The window is
// kept in polyphase order, sample q at phase q % stride, index q / stride,
// so tap j of output m reads phase (T-1-j) % stride at index
// m + (T-1-j) / stride. A thread computes MFD_U consecutive outputs. For
// each phase it holds a window of MFD_U samples in registers; the next tap of
// the same phase needs the window one sample earlier, so it shifts the
// window and loads one new sample: one shared load per tap for MFD_U
// outputs. A phase is skewed by one pad slot every 16 samples, so lanes
// MFD_U samples apart read distinct banks. With the receive path's T and
// stride known at compile time the tap loop unrolls, the shifts become
// register renames and the tap reads fixed offsets; other strides and
// lengths take a generic instantiation that reloads the window per tap.
//
// The per-row rotation is computed where a sample is staged: w in float64,
// a float64 anchor w*lo at the block's first window sample, reduced to
// [-pi, pi], then the float32 phase anchor + w*q of window sample q (|w*q|
// stays below ~40 rad for offsets up to 150 Hz, so the phase error is
// ~1e-6 rad) and one sincosf. At w = 0 the rotation is exactly 1 and osc * rot is osc bit for
// bit. With offsets a block takes one row in either form: two rows sharing
// each oscillator read, each turning it by its own rotation, were slower at
// stride 1 on an H100 and no faster at stride 4.
//
// Every output keeps the direct form's arithmetic: taps in order j = 0..T-1,
// acc = fmaf(tap, p*o, acc) with the same float32 product p*o, and a sample
// outside [0, n) contributes fmaf(tap, 0, acc) == acc. So the result is
// bit-equal to the direct per-output loop.

#include <cuda_runtime.h>
#include <stdint.h>

#define MFD_MAX_TAPS 256
#define MFD_RECV_TAPS 33            // the receive path's FIR length
#define MFD_THREADS 128
#define MFD_U 4                     // consecutive outputs per thread
#define MFD_TILE (MFD_THREADS * MFD_U)
// rows per block when all start at 0 and have no per-row offset
#define MFD_ROWS 2
#define MFD_MAX_SMEM (227 * 1024)
#define MFD_MIN_BLOCKS 2            // resident blocks an SM must fit

// index inside a phase, one pad slot after every 16
__device__ __forceinline__ int mfd_skew(int i) { return i + (i >> 4); }

// A row's rotation over a block's window: w = freq * (2 pi / fs) and
// a0 = w*lo reduced to [-pi, pi] in float64, then float32 steps w.
struct MfdRot {
  float a0, w;
};

__device__ __forceinline__ MfdRot mfd_rot(float freq, double w_hz,
                                          long long lo) {
  const double w = (double)freq * w_hz;
  double a = w * (double)lo;
  a -= 6.283185307179586 * rint(a * 0.15915494309189535);
  return {(float)a, (float)w};
}

// o * e^{j (a0 + w q)}
__device__ __forceinline__ float2 mfd_turn(float2 o, MfdRot r, int q) {
  float sn, cs;
  sincosf(fmaf(r.w, (float)q, r.a0), &sn, &cs);
  return make_float2(o.x * cs - o.y * sn, o.x * sn + o.y * cs);
}

// The taps jg .. jg+NW-1 (one per phase when the stride is compiled in;
// NW = 1 and a full window reload per tap otherwise) applied to a thread's
// MFD_U outputs. w[rr] is the window of the phase of taps j == rr (mod NW).
template <int S, int NW>
__device__ __forceinline__ void mfd_taps(const float2* x, const float* taps,
                                         int jg, int ntaps, int stride,
                                         int plen, int base,
                                         float2 (&w)[NW][MFD_U],
                                         float (&ar)[MFD_U],
                                         float (&ai)[MFD_U]) {
#pragma unroll
  for (int rr = 0; rr < NW; ++rr) {
    const int j = jg + rr;
    if (j < ntaps) {
      const int d = ntaps - 1 - j;
      const float2* ph = x + (d % stride) * plen;
      const int a = d / stride;
      if (S == 0 || jg == 0) {
#pragma unroll
        for (int u = 0; u < MFD_U; ++u) w[rr][u] = ph[mfd_skew(base + a + u)];
      } else {
#pragma unroll
        for (int u = MFD_U - 1; u > 0; --u) w[rr][u] = w[rr][u - 1];
        w[rr][0] = ph[mfd_skew(base + a)];
      }
      const float t = taps[j];
#pragma unroll
      for (int u = 0; u < MFD_U; ++u) {
        ar[u] = fmaf(t, w[rr][u].x, ar[u]);
        ai[u] = fmaf(t, w[rr][u].y, ai[u]);
      }
    }
  }
}

// S, T: stride and taps, both compiled in (the receive path's) or both 0
// (the runtime arguments); R: rows per block, all starting at 0 when R > 1;
// F: per-row frequency offsets are given (then R == 1).
template <int S, int T, int R, bool F>
__global__ void __launch_bounds__(MFD_THREADS, MFD_MIN_BLOCKS)
mix_fir_decimate_kernel(const float* __restrict__ pb,
                        const float2* __restrict__ osc,
                        const float* __restrict__ taps,
                        const int64_t* __restrict__ start,
                        const float* __restrict__ freq, double w_hz,
                        float2* __restrict__ out, int batch, int n,
                        int n_out, int stride_rt, int offset, int ntaps_rt,
                        int plen, bool vec) {
  extern __shared__ float2 xs[];          // [R][stride][plen] mixed window
  __shared__ float s_taps[MFD_MAX_TAPS];
  constexpr int NW = S > 0 ? S : 1;
  static_assert(!F || R == 1, "a per-row offset takes one row a block");
  const int stride = S > 0 ? S : stride_rt;
  const int ntaps = T > 0 ? T : ntaps_rt;
  const int b0 = blockIdx.y * R;
  const int m0 = blockIdx.x * MFD_TILE;
  const int tile = min(MFD_TILE, n_out - m0);
  const int win = (tile - 1) * stride + ntaps;

  for (int j = threadIdx.x; j < ntaps; j += MFD_THREADS) s_taps[j] = taps[j];

  // stage: window sample q is input index lo + q of each of the R rows
  const long long lo = (start != nullptr ? start[b0] : 0)
                       + (long long)m0 * stride + offset - (ntaps - 1);
  MfdRot rot{0.f, 0.f};
  if constexpr (F) rot = mfd_rot(freq[b0], w_hz, lo);
  if (vec) {
    // 16-byte loads: chunk c holds input indices a0 + 4c .. a0 + 4c + 3
    const long long a0 = lo & ~3LL;
    const int chunks = (int)((lo + win - a0 + 3) >> 2);
#pragma unroll 1
    for (int c = threadIdx.x; c < chunks; c += MFD_THREADS) {
      const long long i0 = a0 + 4LL * c;
      float2 o[4];
      float p[R][4];
      if (i0 >= 0 && i0 + 3 < n) {
        const float4 o01 = __ldg(reinterpret_cast<const float4*>(osc + i0));
        const float4 o23 =
            __ldg(reinterpret_cast<const float4*>(osc + i0 + 2));
        o[0] = make_float2(o01.x, o01.y);
        o[1] = make_float2(o01.z, o01.w);
        o[2] = make_float2(o23.x, o23.y);
        o[3] = make_float2(o23.z, o23.w);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 v = b0 + r < batch
              ? __ldg(reinterpret_cast<const float4*>(
                    pb + (size_t)(b0 + r) * n + i0))
              : make_float4(0.f, 0.f, 0.f, 0.f);
          p[r][0] = v.x;
          p[r][1] = v.y;
          p[r][2] = v.z;
          p[r][3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long i = i0 + e;
          const bool inside = i >= 0 && i < n;
          o[e] = inside ? __ldg(osc + i) : make_float2(0.f, 0.f);
#pragma unroll
          for (int r = 0; r < R; ++r)
            p[r][e] = inside && b0 + r < batch
                ? __ldg(pb + (size_t)(b0 + r) * n + i) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = (int)(i0 + e - lo);
        if (q >= 0 && q < win) {
          const int slot = (q % stride) * plen + mfd_skew(q / stride);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float2 oe = F ? mfd_turn(o[e], rot, q) : o[e];
            xs[r * stride * plen + slot] = make_float2(
                __fmul_rn(p[r][e], oe.x), __fmul_rn(p[r][e], oe.y));
          }
        }
      }
    }
  } else {
#pragma unroll 2
    for (int q = threadIdx.x; q < win; q += MFD_THREADS) {
      const long long i = lo + q;
      const bool inside = i >= 0 && i < n;
      const int slot = (q % stride) * plen + mfd_skew(q / stride);
      const float2 o = inside ? __ldg(osc + i) : make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float xr = 0.f, xi = 0.f;
        if (inside && b0 + r < batch) {
          const float p = __ldg(pb + (size_t)(b0 + r) * n + i);
          const float2 oe = F ? mfd_turn(o, rot, q) : o;
          xr = __fmul_rn(p, oe.x);
          xi = __fmul_rn(p, oe.y);
        }
        xs[r * stride * plen + slot] = make_float2(xr, xi);
      }
    }
  }
  __syncthreads();

  const int base = threadIdx.x * MFD_U;   // this thread's first output
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    if (b0 + r >= batch) break;
    const float2* x = xs + r * stride * plen;
    float ar[MFD_U], ai[MFD_U];
    float2 w[NW][MFD_U];
#pragma unroll
    for (int u = 0; u < MFD_U; ++u) ar[u] = ai[u] = 0.f;
    if constexpr (T > 0) {
#pragma unroll
      for (int jg = 0; jg < T; jg += NW)
        mfd_taps<S, NW>(x, s_taps, jg, T, stride, plen, base, w, ar, ai);
    } else {
      for (int jg = 0; jg < ntaps; jg += NW)
        mfd_taps<S, NW>(x, s_taps, jg, ntaps, stride, plen, base, w, ar, ai);
    }
    float2* orow = out + (size_t)(b0 + r) * n_out + m0;
#pragma unroll
    for (int u = 0; u < MFD_U; ++u)
      if (base + u < tile) orow[base + u] = make_float2(ar[u], ai[u]);
  }
}

template <int S, int T, int R, bool F>
static int mfd_run(const float* pb, const float2* osc, const float* taps,
                   const int64_t* start, const float* freq, double w_hz,
                   float2* out, int batch, int n, int n_out, int stride,
                   int offset, int ntaps, cudaStream_t stream) {
  // a phase holds the largest tile's window, (MFD_TILE-1)*stride + ntaps
  // samples over `stride` phases, plus its skew
  const int len = MFD_TILE - 1 + (ntaps + stride - 1) / stride;
  const int plen = len + ((len - 1) >> 4);
  const size_t smem = sizeof(float2) * (size_t)R * stride * plen;
  if (smem > MFD_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mix_fir_decimate_kernel<S, T, R, F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte staging loads where every row and the oscillator are aligned
  const bool vec = (uintptr_t)pb % 16 == 0 && (uintptr_t)osc % 16 == 0
                   && n % 4 == 0;
  dim3 grid((n_out + MFD_TILE - 1) / MFD_TILE, (batch + R - 1) / R);
  mix_fir_decimate_kernel<S, T, R, F><<<grid, MFD_THREADS, smem, stream>>>(
      pb, osc, taps, start, freq, w_hz, out, batch, n, n_out, stride, offset,
      ntaps, plen, vec);
  return (int)cudaGetLastError();
}

// rows per block: MFD_ROWS when every row starts at 0 (start == NULL) and
// has no offset (freq == NULL), else one
template <int S, int T>
static int mfd_rows(const float* pb, const float2* osc, const float* taps,
                    const int64_t* start, const float* freq, double w_hz,
                    float2* out, int batch, int n, int n_out, int stride,
                    int offset, int ntaps, cudaStream_t s) {
  if (freq != nullptr)
    return mfd_run<S, T, 1, true>(pb, osc, taps, start, freq, w_hz, out,
                                  batch, n, n_out, stride, offset, ntaps, s);
  if (start == nullptr)
    return mfd_run<S, T, MFD_ROWS, false>(pb, osc, taps, start, freq, w_hz,
                                          out, batch, n, n_out, stride,
                                          offset, ntaps, s);
  return mfd_run<S, T, 1, false>(pb, osc, taps, start, freq, w_hz, out,
                                 batch, n, n_out, stride, offset, ntaps, s);
}

// start: int64 [batch], or NULL for a start of 0 on every row; freq: float32
// [batch] per-row offsets in Hz at sample rate fs, or NULL for none
extern "C" int mfd_launch(const float* pb, const float2* osc,
                          const float* taps, const int64_t* start,
                          const float* freq, double fs, float2* out,
                          int batch, int n, int n_out, int stride, int offset,
                          int ntaps, void* stream) {
  if (ntaps < 1 || ntaps > MFD_MAX_TAPS || stride < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (freq != nullptr && !(fs > 0.0)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_out == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  // radians a sample per Hz, as the plain version forms it
  const double w_hz = freq != nullptr ? 6.283185307179586 / fs : 0.0;
  // the receive path's FIR length compiled in at its strides (4: the
  // decimating FIRs; 1: to_baseband and the signal-strength meter); any
  // other at run time
  if (stride == 4 && ntaps == MFD_RECV_TAPS)
    return mfd_rows<4, MFD_RECV_TAPS>(pb, osc, taps, start, freq, w_hz, out,
                                      batch, n, n_out, stride, offset, ntaps,
                                      s);
  if (stride == 1 && ntaps == MFD_RECV_TAPS)
    return mfd_rows<1, MFD_RECV_TAPS>(pb, osc, taps, start, freq, w_hz, out,
                                      batch, n, n_out, stride, offset, ntaps,
                                      s);
  return mfd_rows<0, 0>(pb, osc, taps, start, freq, w_hz, out, batch, n,
                        n_out, stride, offset, ntaps, s);
}

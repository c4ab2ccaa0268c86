// septail_step.cu — one full-resolution step of the phase-major 'fused'
// refinement engine, one kernel, for Hopper (sm_90a).
//
// Carries the XLA fusion of iterative_inference_segm_tpu/inference/fused.py:
// septail_phase_logits (:98-149) and the softmax and blend of
// fused_refinement_scan's step (:179-181). It replaces no pl.pallas_call: on
// the TPU the step was ~600 elementwise ops that XLA fused. The carry is
// phase-major and channel-leading, y_ph (B, 2, 2, C, Hh, Wh) with
// y_ph[b, ph, pw, c, j, u] = y[b, 2j + ph, 2u + pw, c]; s is the DAE core's
// half-resolution score map, read as (B, Hh, Wh, C) through its own strides
// (the NHWC map dae_core returns, or a channel-leading one seen through
// NHWC strides: the transpose the JAX step writes out, :178, is never
// materialized), in the carry's dtype. Per full-resolution pixel (b, ph, pw, j, u) and class c:
//     a[c]  = sum of the 2x2 taps  w_up[kh, kw, c] * s[b, j + dh, u + dw, c]
//                                                  (k4/s2 depthwise deconv)
//           + sum of the 3x3 taps  w_si[1 + dr, 1 + dc, c] * y[b, 2j + ph + dr, 2u + pw + dc, c]
//                                                  (depthwise 3x3 of the iterate)
//     l[co] = sum over ci of a[ci] * mix[ci, co] + bias[co]
//     r     = softmax(l)
//     y'    = y - eps * (y - r)                    (y the pixel's own value)
// with zero fill past every edge, all in f32, y' rounded once to the
// carry's dtype. w_up is the JAX package's (4, 4, C) kernel, unflipped.
//
// The deconv's taps per output phase (conv_transpose2d's symmetric padding,
// pad_lo = 2; _DECONV_TAPS at :95): phase 0 reads kernel rows 0 and 2 at
// source shifts -1 and 0, phase 1 rows 1 and 3 at 0 and +1, i.e. kernel
// index ph + 2t at shift t - 1 + ph for t = 0, 1 (columns alike).
// A full-resolution neighbour at row offset dr lies in phase plane
// (ph + dr) mod 2, at half-resolution shift floor((ph + dr) / 2), floor and
// mod taken as Python takes them (:133-139):
//     ph + dr :  -1   0   1   2
//     plane   :   1   0   1   0
//     shift   :  -1   0   0  +1
// C++'s / and % truncate toward zero (-1 / 2 == 0, -1 % 2 == -1), so the
// kernel reads the table as q = ph + dr + 2 (1..4): plane q & 1, shift
// (q >> 1) - 1. Columns alike.
//
// What bounds it: device-memory bytes. One launch reads y_ph and s and
// writes y_ph' once; at the bench step (B = 128, C = 11, 360x480) that is
// 243.3 M + 60.8 M values read and 243.3 M written: 1.095 GB in bf16,
// ~0.33 ms at 3.35 TB/s (an f32 carry: 2.19 GB, ~0.65 ms). A
// pixel does 13 C tap multiply-adds, C^2 mix multiply-adds and the softmax:
// ~860 operations at C = 11, ~0.28 ms at 67 TFLOP/s f32, under the byte time.
//
// The design is the simple one: one thread per full-resolution pixel,
// neighbouring threads on neighbouring u, so that every read of a class
// plane of y_ph (and every store of y_ph') is coalesced; the 9 y taps and 4
// s taps a class are loaded straight from device memory, their reuse left to
// L1 and L2; the weights (f32, 26 C + C^2 values) are read with __ldg at
// addresses uniform across a warp. Up to 16 classes a pixel's values live in
// registers (C = 11, CamVid's, unrolled exactly; 2..16, the EM and polyp
// sets' 2 among them, a loop of 16 tested against the run-time C); 17..128
// take loops against the run-time C over arrays the compiler keeps in local
// memory. Above 128 the launch is refused, the cap of the repo's other
// kernels. Staging the halo in shared memory and
// 16-byte accesses are left to a later change.
//
// Plain C interface (loaded with ctypes by ops/septail_step.py); the launch
// returns the CUDA error of its set-up or launch so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegClasses = 16;   // the most classes a pixel holds in registers
constexpr int kMaxClasses = 128;  // the most any instance takes

struct Params {
  const void* y;
  long long y_b, y_ph, y_pw, y_c, y_j, y_u;  // y_ph's strides, in elements
  const void* s;
  long long s_b, s_h, s_w, s_c;  // s's strides as (B, Hh, Wh, C), in elements
  const float* w_up;  // (4, 4, C)
  const float* w_si;  // (3, 3, C)
  const float* mix;   // (C, C), [ci][co]
  const float* bias;  // (C,)
  float eps;
  void* out;  // contiguous (B, 2, 2, C, Hh, Wh), y's dtype
  int C, Hh, Wh;
  long long pixels;  // B * 4 * Hh * Wh
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// One thread a full-resolution pixel. kExact: C == CMAX, so the class loops
// unroll with no test of c < C. Up to kRegClasses the trip counts are the
// constant CMAX (unrolled, registers); above, the run-time C.
template <typename T, int CMAX, bool kExact>
__global__ void __launch_bounds__(kThreads) septail_step_kernel(const Params p) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= p.pixels) return;
  const int C = kExact ? CMAX : p.C;
  const int n = CMAX <= kRegClasses ? CMAX : C;
  const int Hh = p.Hh, Wh = p.Wh;
  const int u = (int)(t % Wh);
  long long rest = t / Wh;
  const int j = (int)(rest % Hh);
  rest /= Hh;
  const int pw = (int)(rest & 1), ph = (int)((rest >> 1) & 1);
  const long long b = rest >> 2;

  const T* y = static_cast<const T*>(p.y) + b * p.y_b;
  const T* s = static_cast<const T*>(p.s) + b * p.s_b;

  // the 2x2 deconv taps: offset in s (-1 past an edge) and kernel index
  long long s_off[4];
  int k_up[4];
#pragma unroll
  for (int ti = 0; ti < 2; ++ti) {
#pragma unroll
    for (int tj = 0; tj < 2; ++tj) {
      const int sh = j + ti - 1 + ph, sw = u + tj - 1 + pw;
      const bool in = sh >= 0 && sh < Hh && sw >= 0 && sw < Wh;
      s_off[2 * ti + tj] = in ? sh * p.s_h + sw * p.s_w : -1;
      k_up[2 * ti + tj] = (ph + 2 * ti) * 4 + (pw + 2 * tj);
    }
  }
  // the 3x3 taps: offset in y_ph (-1 past an edge), through the table above
  long long y_off[9];
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr) {
    const int qh = ph + dr + 2;
    const int jj = j + (qh >> 1) - 1;
#pragma unroll
    for (int dc = -1; dc <= 1; ++dc) {
      const int qw = pw + dc + 2;
      const int uu = u + (qw >> 1) - 1;
      const bool in = jj >= 0 && jj < Hh && uu >= 0 && uu < Wh;
      y_off[3 * (dr + 1) + dc + 1] = in ? (qh & 1) * p.y_ph + (qw & 1) * p.y_pw + jj * p.y_j + uu * p.y_u : -1;
    }
  }

  float acc[CMAX];  // the deconv + 3x3 sum a class, the mix's input
  float yc[CMAX];   // the pixel's own value a class
  float lg[CMAX];   // the logits, then their exponentials
#pragma unroll
  for (int c = 0; c < n; ++c) {
    if (c < C) {
      // the JAX step's order: the deconv's four taps, then the nine of the 3x3
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = s_off[k] >= 0 ? widen(s[s_off[k] + c * p.s_c]) : 0.f;
        a = k == 0 ? __ldg(p.w_up + k_up[k] * C + c) * v : fmaf(__ldg(p.w_up + k_up[k] * C + c), v, a);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float v = y_off[k] >= 0 ? widen(y[y_off[k] + c * p.y_c]) : 0.f;
        if (k == 4) yc[c] = v;  // the centre tap is the pixel itself
        a = fmaf(__ldg(p.w_si + k * C + c), v, a);
      }
      acc[c] = a;
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int co = 0; co < n; ++co) {
    if (co < C) {
      float l = 0.f;
#pragma unroll
      for (int ci = 0; ci < n; ++ci)
        if (ci < C) l = fmaf(acc[ci], __ldg(p.mix + ci * C + co), l);
      l += __ldg(p.bias + co);
      lg[co] = l;
      m = fmaxf(m, l);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < n; ++c) {
    if (c < C) {
      lg[c] = expf(lg[c] - m);
      sum += lg[c];
    }
  }

  const long long plane = (long long)Hh * Wh;
  T* out = static_cast<T*>(p.out) + (b * 4 + ph * 2 + pw) * C * plane + (long long)j * Wh + u;
#pragma unroll
  for (int c = 0; c < n; ++c) {
    if (c < C) {
      const float r = lg[c] / sum;
      store(out + c * plane, yc[c] - p.eps * (yc[c] - r));
    }
  }
}

template <typename T, int CMAX, bool kExact = false>
cudaError_t run(const Params& p, cudaStream_t stream) {
  const long long blocks = (p.pixels + kThreads - 1) / kThreads;
  septail_step_kernel<T, CMAX, kExact><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_c(const Params& p, cudaStream_t stream) {
  // CamVid's 11 classes unroll exactly; other counts run loops tested
  // against the run-time C
  if (p.C == 11) return run<T, 11, true>(p, stream);
  if (p.C <= kRegClasses) return run<T, kRegClasses>(p, stream);
  return run<T, kMaxClasses>(p, stream);
}

}  // namespace

// dtype (y_ph, s and out): 0 = float32, 1 = bfloat16. y_ph's six and s's
// four strides are in elements; the weights are contiguous float32 on the
// card; out is a contiguous (B, 2, 2, C, Hh, Wh) tensor of y's dtype.
// 1 <= C <= 128 and B * 4 * Hh * Wh < 2^31.
extern "C" int septail_step_launch(
    int dtype, int B, int C, int Hh, int Wh,
    const void* y, long long y_b, long long y_ph, long long y_pw, long long y_c, long long y_j, long long y_u,
    const void* s, long long s_b, long long s_h, long long s_w, long long s_c,
    const void* w_up, const void* w_si, const void* mix, const void* bias, float eps,
    void* out, void* stream) {
  if (C < 1 || C > kMaxClasses || B < 1 || Hh < 1 || Wh < 1) return (int)cudaErrorInvalidValue;
  const long long pixels = 4LL * B * Hh * Wh;
  if (pixels >= 0x80000000LL) return (int)cudaErrorInvalidValue;
  Params p{};
  p.y = y;
  p.y_b = y_b;
  p.y_ph = y_ph;
  p.y_pw = y_pw;
  p.y_c = y_c;
  p.y_j = y_j;
  p.y_u = y_u;
  p.s = s;
  p.s_b = s_b;
  p.s_h = s_h;
  p.s_w = s_w;
  p.s_c = s_c;
  p.w_up = static_cast<const float*>(w_up);
  p.w_si = static_cast<const float*>(w_si);
  p.mix = static_cast<const float*>(mix);
  p.bias = static_cast<const float*>(bias);
  p.eps = eps;
  p.out = out;
  p.C = C;
  p.Hh = Hh;
  p.Wh = Wh;
  p.pixels = pixels;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_c<float>(p, st);
  if (dtype == 1) return (int)run_c<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

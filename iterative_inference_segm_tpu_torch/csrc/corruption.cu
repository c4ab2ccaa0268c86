// corruption.cu — the DAE's training-time corruption, one pass, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of
// iterative_inference_segm_tpu/ops/pallas/corruption_kernel.py:
//   K1 _corrupt_kernel        out = softmax(one_hot(labels) + sigma * N(0,1))
//   K2 _corrupt_probs_kernel  out = softmax(probs + sigma * N(0,1))
// over the C classes of each pixel. Void labels (outside [0, C)) get an
// all-zero one-hot. Output is a contiguous (pixels, C) f32 map.
//
// Same bits as the TPU kernels. The noise is their counter-based hash, not
// a Philox stream: element (pixel p, class c) has the counter
//     ctr = uint32(p * 128 + c)        (128 = the TPU lane padding, kept so
//                                       the bits match; wraps mod 2^32)
//     b1  = fmix32(ctr * 0x9E3779B9 + seed)
//     b2  = fmix32(ctr * 0x85EBCA77 + (seed ^ 0xDEADBEEF))
//     u   = ((b >> 8) + 1) / 2^24      in (0, 1], exact in f32
//     n   = sqrt(-2 log u1) * cos(2 pi u2)
// all in unsigned 32-bit arithmetic. The TPU kernels computed 128 lanes and
// masked the padding lanes to -inf; those contribute exactly 0 to the
// softmax, so only the C real classes are computed and stored here.
// Arithmetic is f32 with the accurate logf/cosf/sqrtf/expf (the build has no
// --use_fast_math) and explicit __fmul_rn/__fadd_rn where the TPU kernel
// rounds twice, so that no multiply-add is contracted and the result agrees
// with the plain version (ops/corruption_kernel.py) to a few ulps.
//
// What bounds it: at the training shape (32 x 224 x 224 pixels, C = 11) the
// kernel writes 71 MB of f32 (21 us at 3.35 TB/s) and computes, for each of
// 17.7 M elements, two murmur3 finalizers, a logf, a cosf, a sqrtf and an
// expf: about 100 instructions per element, most of them in the
// special-function polynomials. The special functions, not the stores, are
// expected to bound it; chip_smoke.py prints its time beside that of a
// plain fill of the same output (the store floor).
//
// What the design does about it: one pass, nothing but the labels (or the
// clean map) read and the result written once; no one-hot, noise or logits
// tensor in device memory. One thread per pixel keeps its C logits and
// exponentials in registers (unrolled to 16 or 32 classes, predicated on C).
// It is the simple, correct form: each thread stores C floats at a stride of
// 4C bytes; staging the stores through shared memory so a warp writes one
// contiguous span is later work.
//
// Plain C interface (loaded with ctypes by ops/corruption_kernel.py); each
// launch returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kLanes = 128;  // the TPU kernels' padded class width
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi), as JAX rounds it

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Top 24 bits -> (0, 1]: exact, and strictly positive for the log.
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __fmul_rn((float)(bits >> 8) + 1.0f, 1.0f / 16777216.0f);
}

__device__ __forceinline__ float gauss(uint32_t ctr, uint32_t seed, uint32_t seed2) {
  const float u1 = uniform(fmix32(ctr * 0x9E3779B9u + seed));
  const float u2 = uniform(fmix32(ctr * 0x85EBCA77u + seed2));
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, u2)));
}

// kOneHot: the clean signal is one_hot(labels[p]); otherwise probs[p, :].
template <bool kOneHot, int CMAX>
__global__ void __launch_bounds__(256) corrupt_kernel(
    const int* __restrict__ labels, const float* __restrict__ probs, long long n, int C,
    uint32_t seed, float sigma, float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t base = (uint32_t)p * kLanes;  // mod 2^32, as the TPU kernel's counter
  const uint32_t seed2 = seed ^ 0xDEADBEEFu;
  const int lab = kOneHot ? __ldg(labels + p) : 0;
  const float* pp = kOneHot ? nullptr : probs + p * C;

  float lg[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      const float clean = kOneHot ? (lab == c ? 1.0f : 0.0f) : __ldg(pp + c);
      lg[c] = __fadd_rn(clean, __fmul_rn(sigma, gauss(base + (uint32_t)c, seed, seed2)));
    }
  }
  float m = lg[0];
#pragma unroll
  for (int c = 1; c < CMAX; ++c)
    if (c < C) m = fmaxf(m, lg[c]);
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      lg[c] = expf(lg[c] - m);
      s += lg[c];
    }
  }
  float* op = out + p * C;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) op[c] = lg[c] / s;
}

template <bool kOneHot>
int launch(const int* labels, const float* probs, long long n, int C, unsigned seed,
           float sigma, float* out, void* stream) {
  if (n < 1 || C < 1 || C > 32) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 16)
    corrupt_kernel<kOneHot, 16><<<(unsigned)blocks, threads, 0, st>>>(
        labels, probs, n, C, seed, sigma, out);
  else
    corrupt_kernel<kOneHot, 32><<<(unsigned)blocks, threads, 0, st>>>(
        labels, probs, n, C, seed, sigma, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. labels: n contiguous int32; out: contiguous (n, C) float32.
extern "C" int corrupt_onehot_launch(const void* labels, long long n, int C, unsigned seed,
                                     float sigma, void* out, void* stream) {
  return launch<true>(static_cast<const int*>(labels), nullptr, n, C, seed, sigma,
                      static_cast<float*>(out), stream);
}

// K2. probs: contiguous (n, C) float32; out: contiguous (n, C) float32.
extern "C" int corrupt_probs_launch(const void* probs, long long n, int C, unsigned seed,
                                    float sigma, void* out, void* stream) {
  return launch<false>(nullptr, static_cast<const float*>(probs), n, C, seed, sigma,
                       static_cast<float*>(out), stream);
}

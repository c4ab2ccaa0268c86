// vpu_probe.cu — the two throughput probes of the fused-tail design, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of tools/vpu_probe.py:
//   K4 fma_kernel      acc = x; acc = acc + x * w[i % 8] for i < n_fma;
//                      out = acc rounded to x's dtype
//   K5 pattern_kernel  on (N, R, C, W) maps, per (n, r, w) and class c:
//                        a    = x[r, c, w] * k[c]
//                        s    = ((a + a[w-1]/2) + a[w+1]/4) + a[r+1]/8
//                               (zeros outside the map)
//                        s'_c = s_c + 0.01 * s_3   (s_3 from BEFORE the update)
//                        out  = softmax over c of s'
// On the TPU the pair measured a vector-register FMA against Mosaic's lane
// shifts and cross-sublane reductions. Here they measure what the card does
// per element: an FP32 fused multiply-add chain, and the separable tail's
// neighbour reads plus an accurate softmax over the class axis.
//
// Instruction control, the reason both are CUDA and not Triton:
// - K4 chains fmaf (one rounding per step). The TPU kernel's `acc + x * w`
//   is contracted into a multiply-add by XLA, so fmaf is the same function
//   bit for bit; the plain version (ops/vpu_probe.py) is a torch.addcmul
//   chain. n_fma is a runtime argument, so nothing is folded; the eight
//   weights come by value, as the TPU kernel read them from SMEM.
// - K5 keeps the TPU kernel's order of operations with __fmul_rn/__fadd_rn,
//   so nvcc contracts nothing, and uses the accurate expf (no
//   --use_fast_math) and a division, summing the exponentials class by class.
//
// What bounds them: K4 moves 2 x 4 (f32) or 2 x 2 (bf16) bytes per element
// and does n_fma multiply-adds; the probe tool times it over a range of n to
// find where the chain's time starts to rise above the memory-bound time
// (the crossover; tools/vpu_probe.py in the port). K5 reads each element about four times (neighbours come from L1/L2)
// and writes it once, with ~25 instructions per element, an expf and a
// division: memory-bound on this card.
//
// Design: one thread per element (K4) or per (n, r, w) pixel column (K5,
// the C classes in registers, C <= 16). Neighbouring threads own neighbouring
// w, so every load and store of a warp is one contiguous span. The simple,
// correct form: no vector loads or shared-memory staging.
//
// Plain C interface (loaded with ctypes by ops/vpu_probe.py); each launch
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Weights {
  float v[8];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(256) fma_chain_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long n, int n_fma, Weights w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xv = load(x + i);
  float acc = xv;
  int k = 0;
  for (; k + 8 <= n_fma; k += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(xv, w.v[j], acc);
  }
  // k is a multiple of 8 here, so step k + j takes weight j
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (k + j < n_fma) acc = fmaf(xv, w.v[j], acc);
  store(out + i, acc);
}

constexpr int kCMax = 16;

template <typename T>
__global__ void __launch_bounds__(256) pattern_softmax_kernel(
    const T* __restrict__ x, const float* __restrict__ kc, T* __restrict__ out,
    int N, int R, int C, int W) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * R * W) return;
  const int w = (int)(t % W);
  const long long nr = t / W;  // n * R + r
  const int r = (int)(nr % R);
  const long long row = nr * C * W + w;  // element (n, r, 0, w)
  const long long cw = (long long)C * W;

  float s[kCMax];
#pragma unroll
  for (int c = 0; c < kCMax; ++c) {
    if (c < C) {
      const float k = __ldg(kc + c);
      const T* p = x + row + (long long)c * W;
      const float a = __fmul_rn(load(p), k);
      const float left = w > 0 ? __fmul_rn(load(p - 1), k) : 0.0f;
      const float right = w < W - 1 ? __fmul_rn(load(p + 1), k) : 0.0f;
      const float up = r < R - 1 ? __fmul_rn(load(p + cw), k) : 0.0f;
      float v = __fadd_rn(a, __fmul_rn(0.5f, left));
      v = __fadd_rn(v, __fmul_rn(0.25f, right));
      s[c] = __fadd_rn(v, __fmul_rn(0.125f, up));
    }
  }
  const float s3 = s[3];  // the value before the update, for every class
#pragma unroll
  for (int c = 0; c < kCMax; ++c)
    if (c < C) s[c] = __fadd_rn(s[c], __fmul_rn(s3, 0.01f));
  float m = s[0];
#pragma unroll
  for (int c = 1; c < kCMax; ++c)
    if (c < C) m = fmaxf(m, s[c]);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kCMax; ++c) {
    if (c < C) {
      s[c] = expf(__fadd_rn(s[c], -m));
      sum = __fadd_rn(sum, s[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kCMax; ++c)
    if (c < C) store(out + row + (long long)c * W, __fdiv_rn(s[c], sum));
}

unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// K4. dtype: 0 = float32, 1 = bfloat16. x, out: n contiguous elements.
extern "C" int fma_chain_launch(int dtype, const void* x, void* out, long long n, int n_fma,
                                float w0, float w1, float w2, float w3, float w4, float w5,
                                float w6, float w7, void* stream) {
  const int threads = 256;
  if (n < 1 || n_fma < 0 || (dtype != 0 && dtype != 1) ||
      (n + threads - 1) / threads > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const Weights w{{w0, w1, w2, w3, w4, w5, w6, w7}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    fma_chain_kernel<float><<<blocks_for(n, threads), threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, n_fma, w);
  else
    fma_chain_kernel<__nv_bfloat16><<<blocks_for(n, threads), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n, n_fma, w);
  return (int)cudaGetLastError();
}

// K5. x, out: contiguous (N, R, C, W) of the dtype; kc: C float32 on the card.
extern "C" int pattern_softmax_launch(int dtype, const void* x, const void* kc, void* out,
                                      int N, int R, int C, int W, void* stream) {
  const int threads = 256;
  const long long pixels = (long long)N * R * W;
  if (N < 1 || R < 1 || W < 1 || C < 4 || C > kCMax || (dtype != 0 && dtype != 1) ||
      (pixels + threads - 1) / threads > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(kc);
  if (dtype == 0)
    pattern_softmax_kernel<float><<<blocks_for(pixels, threads), threads, 0, st>>>(
        static_cast<const float*>(x), k, static_cast<float*>(out), N, R, C, W);
  else
    pattern_softmax_kernel<__nv_bfloat16><<<blocks_for(pixels, threads), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), k, static_cast<__nv_bfloat16*>(out), N, R, C, W);
  return (int)cudaGetLastError();
}

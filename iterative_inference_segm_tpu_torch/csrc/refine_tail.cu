// refine_tail.cu — the refinement step's class-width epilogue, fused, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels tools/tail_kernel_proto.py::kernel_unroll and
// ::kernel_dot (the prototype "K3"), which compute, row-wise over pixels,
//     logits = u + y.W + b;  r = softmax(logits);  y' = (1 - eps) y + eps r.
// This kernel computes the same function, extended for the half engine's main
// path (inference/fused.py):
//     logits = crop(u) + v + y.W + b      (v, W, b each optional)
//     r      = softmax(logits)            over C <= 32 classes
//     y'     = (1 - eps) y + eps r        one rounding, on the store
//     labels = argmax(y')                 optional; on the stored (rounded)
//                                          values, first maximum wins
// u is read through its own strides at crop_to's centre offsets, so the
// cropped sum crop(u) + v is never materialized. Inputs and outputs are f32
// or bf16; all arithmetic is f32.
//
// What bounds it: device-memory bytes. At C = 11 the class axis is far too
// narrow for tensor cores, and a pixel needs ~6 flops per byte moved. In bf16
// a refinement step moves about 88 B/pixel (u, v and y read at 22 B each, y'
// written at 22 B); the rectification moves more (labels add 4 B/pixel, and
// u carries the uncropped border). The composition in plain PyTorch makes
// about eight full passes (crop-add, add, softmax read+write, the blend's
// three elementwise ops) over the same maps.
//
// What the design does about it: one pass. Each thread owns one pixel, loads
// its C logits' addends and its C probabilities once, keeps logits,
// exponentials and the blend in registers (CMAX-unrolled, predicated on C),
// and writes y' (and the label) once. Neighbouring threads own neighbouring
// pixels, so a warp's loads cover one contiguous span of each map and are
// served from the same cache lines. It is the simple, correct form: 16-byte
// vector loads, a warp-cooperative pixel layout and a persistent grid are
// later work.
//
// Plain C interface (loaded with ctypes by ops/refine_tail.py); the launch
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Strides {
  long long b, h, w, c;  // in elements
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float store(float* p, float x) {
  *p = x;
  return x;
}
__device__ __forceinline__ float store(__nv_bfloat16* p, float x) {
  __nv_bfloat16 q = __float2bfloat16_rn(x);
  *p = q;
  return __bfloat162float(q);
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(256) refine_tail_kernel(
    const T* __restrict__ u, Strides su, int off_h, int off_w,
    const T* __restrict__ v, Strides sv,
    const T* __restrict__ y, Strides sy,
    const float* __restrict__ wmat, const float* __restrict__ bias,
    float eps, float one_minus_eps,
    T* __restrict__ out, int* __restrict__ labels,
    int B, int H, int W, int C) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)B * H * W;
  if (n >= total) return;
  const int w = (int)(n % W);
  const long long t = n / W;
  const int h = (int)(t % H);
  const int b = (int)(t / H);

  const T* up = u + b * su.b + (long long)(h + off_h) * su.h + (long long)(w + off_w) * su.w;
  const T* yp = y + b * sy.b + (long long)h * sy.h + (long long)w * sy.w;

  float yv[CMAX];
  float lg[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      yv[c] = load(yp + c * sy.c);
      lg[c] = load(up + c * su.c);
    }
  }
  if (v != nullptr) {
    const T* vp = v + b * sv.b + (long long)h * sv.h + (long long)w * sv.w;
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) lg[c] += load(vp + c * sv.c);
  }
  if (wmat != nullptr) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < CMAX; ++k)
          if (k < C) acc = fmaf(yv[k], __ldg(wmat + k * C + c), acc);
        lg[c] += acc;
      }
    }
  }
  if (bias != nullptr) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) lg[c] += __ldg(bias + c);
  }

  float m = lg[0];
#pragma unroll
  for (int c = 1; c < CMAX; ++c)
    if (c < C) m = fmaxf(m, lg[c]);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      lg[c] = expf(lg[c] - m);
      s += lg[c];
    }
  }

  T* op = out + n * C;
  float best = 0.f;
  int arg = 0;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      const float r = lg[c] / s;
      const float q = store(op + c, one_minus_eps * yv[c] + eps * r);
      if (c == 0 || q > best) {
        best = q;
        arg = c;
      }
    }
  }
  if (labels != nullptr) labels[n] = arg;
}

template <typename T, int CMAX>
void launch(const void* u, Strides su, int off_h, int off_w, const void* v, Strides sv,
            const void* y, Strides sy, const float* wmat, const float* bias, float eps,
            float one_minus_eps, void* out, int* labels, int B, int H, int W, int C,
            cudaStream_t stream) {
  const long long total = (long long)B * H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  refine_tail_kernel<T, CMAX><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(u), su, off_h, off_w, static_cast<const T*>(v), sv,
      static_cast<const T*>(y), sy, wmat, bias, eps, one_minus_eps, static_cast<T*>(out),
      labels, B, H, W, C);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. v, wmat, bias and labels may be null.
// out is a contiguous (B, H, W, C) tensor of the same dtype as u, v and y.
extern "C" int refine_tail_launch(
    int dtype, int B, int H, int W, int C,
    const void* u, long long su_b, long long su_h, long long su_w, long long su_c,
    int off_h, int off_w,
    const void* v, long long sv_b, long long sv_h, long long sv_w, long long sv_c,
    const void* y, long long sy_b, long long sy_h, long long sy_w, long long sy_c,
    const void* wmat, const void* bias, float eps, float one_minus_eps,
    void* out, void* labels, void* stream) {
  if (C < 1 || C > 32 || B < 1 || H < 1 || W < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides su{su_b, su_h, su_w, su_c};
  const Strides sv{sv_b, sv_h, sv_w, sv_c};
  const Strides sy{sy_b, sy_h, sy_w, sy_c};
  const float* wm = static_cast<const float*>(wmat);
  const float* bs = static_cast<const float*>(bias);
  int* lab = static_cast<int*>(labels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (C <= 16)
      launch<float, 16>(u, su, off_h, off_w, v, sv, y, sy, wm, bs, eps, one_minus_eps, out,
                        lab, B, H, W, C, st);
    else
      launch<float, 32>(u, su, off_h, off_w, v, sv, y, sy, wm, bs, eps, one_minus_eps, out,
                        lab, B, H, W, C, st);
  } else {
    if (C <= 16)
      launch<__nv_bfloat16, 16>(u, su, off_h, off_w, v, sv, y, sy, wm, bs, eps,
                                one_minus_eps, out, lab, B, H, W, C, st);
    else
      launch<__nv_bfloat16, 32>(u, su, off_h, off_w, v, sv, y, sy, wm, bs, eps,
                                one_minus_eps, out, lab, B, H, W, C, st);
  }
  return (int)cudaGetLastError();
}

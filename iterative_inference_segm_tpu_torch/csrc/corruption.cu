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
// Arithmetic is f32 with the accurate logf/cosf/sqrtf/expf and the IEEE
// divide (the build has no --use_fast_math) and explicit __fmul_rn/__fadd_rn
// where the TPU kernel rounds twice, so that no multiply-add is contracted;
// the softmax denominator is summed in class order. The plain version
// (ops/corruption_kernel.py) computes the same on the card bit for bit.
//
// What bounds it: the instructions it issues. At the training crop (32 x
// 224 x 224 pixels, C = 11) K1 writes 70.6 MB of f32 (21 us at an H100
// SXM's 3.35 TB/s), but each of its 17.7 M elements takes two murmur3
// finalizers and the fast paths of logf, sqrtf, cosf, expf and the IEEE
// divide: 135 operations (chip_smoke.py's CORRUPT_OPS, read off this
// kernel's SASS, a multiply-add counted as 2), 36 us at the card's f32 rate,
// issued as about 118 instructions an element (the special functions' slow
// paths, replicated for each class, are almost never taken). K2 reads 70.6
// MB more and is bound by its bytes as much as by its operations.
//
// What the design does about it. The first form (one thread a pixel, loops
// unrolled to 16 classes and tested against a run-time C, each thread
// storing its C floats at a stride of 4C bytes) split each warp's stores
// over 11 times the L2 transactions of a contiguous write, and took 2.5
// times as long as this one. Here a block takes a tile of kTile pixels, one
// a thread. Each thread writes its results to the tile in shared memory (at
// a stride of C words: conflict-free for an odd C), and the block stores the
// tile, one contiguous span of the output, with 16-byte stores and a scalar
// tail at the ragged end. K2 stages its tile of probs in the same way, with
// 16-byte cp.async copies (element loads where the caller's probs are not
// 16-byte aligned). CamVid's 11 classes have an exact instance: its class
// loops unroll with no test of c < C, so every issued instruction serves a
// real class, and it is held to 32 registers, so that 16 blocks (all 64
// warps) fit on an SM, a pixel's 11 independent noise chains covering each
// other's latency. Every other C up to 32 takes a general instance, right
// but not tuned. From 33 to 128 classes (the TPU kernels' own cap: one lane
// a class) a pixel's logits would spill from registers, so a wide instance
// keeps them in the tile in shared memory (64 pixels a block, the tile's
// size following C) and loops over them against the run-time C, each
// operation as in the register instances: the same bits. Measured on an
// H100 at the training crop (PERF.md), against the
// first form's time: the staging alone, with the general instance at
// C = 11, 0.68 (K1) and 0.76 (K2); the exact instance alone 0.96 and 0.98;
// both 0.39 and 0.40. One element a thread over the flat n * C index, which
// keeps every lane on a live element for any C but takes each pixel's max
// and sum through shared memory, took 0.54 and 0.52, and was dropped.
//
// Plain C interface (loaded with ctypes by ops/corruption_kernel.py); each
// launch returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kLanes = 128;  // the TPU kernels' padded class width
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi), as JAX rounds it
constexpr int kTile = 128;        // pixels a block, one a thread
constexpr int kRegClasses = 32;   // the most classes a pixel holds in registers
constexpr int kMaxClasses = 128;  // the most the wide instance takes: kLanes
constexpr int kWideTile = 64;     // pixels a block of the wide instance: 32 KB of tile at C = 128
constexpr int kExactClasses = 11;  // CamVid
constexpr int kExactBlocks = 16;   // resident blocks an SM the exact instance is held to

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Copy ne floats of src into the tile: 16-byte cp.async copies where src
// is 16-byte aligned (the tail element by element), else element loads.
__device__ __forceinline__ void stage_in(float* tile, const float* __restrict__ src, int ne) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = ne >> 2;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x) cp_async16(tile + 4 * k, src + 4 * k);
    for (int i = 4 * chunks + threadIdx.x; i < ne; i += blockDim.x) tile[i] = __ldg(src + i);
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < ne; i += blockDim.x) tile[i] = __ldg(src + i);
  }
}

// Store the tile's ne floats to dst (16-byte aligned): 16-byte stores, the
// tail element by element.
__device__ __forceinline__ void store_out(float* __restrict__ dst, const float* tile, int ne) {
  const int chunks = ne >> 2;
  for (int k = threadIdx.x; k < chunks; k += blockDim.x)
    reinterpret_cast<float4*>(dst)[k] = reinterpret_cast<const float4*>(tile)[k];
  for (int i = 4 * chunks + threadIdx.x; i < ne; i += blockDim.x) dst[i] = tile[i];
}

// kOneHot: the clean signal is one_hot(labels[p]); otherwise probs[p, :].
// kExact: C == CMAX, so the class loops unroll with no test of c < C.
template <bool kOneHot, int CMAX, bool kExact>
__global__ void __launch_bounds__(kTile, kExact ? kExactBlocks : 1) corrupt_kernel(
    const int* __restrict__ labels, const float* __restrict__ probs, long long n, int n_classes,
    uint32_t seed, float sigma, float* __restrict__ out) {
  __shared__ __align__(16) float tile[kTile * CMAX];
  const int C = kExact ? CMAX : n_classes;
  const long long p0 = (long long)blockIdx.x * kTile;  // the tile's first pixel
  const int np = (int)min((long long)kTile, n - p0);
  const int ne = np * C;
  const long long e0 = p0 * C;  // its first element: 16-byte aligned (kTile * 4 = 512 bytes)
  if (!kOneHot) {
    stage_in(tile, probs + e0, ne);
    __syncthreads();
  }

  const int px = threadIdx.x;
  if (px < np) {
    const long long p = p0 + px;
    const uint32_t base = (uint32_t)p * kLanes;  // mod 2^32, as the TPU kernel's counter
    const uint32_t seed2 = seed ^ 0xDEADBEEFu;
    const int lab = kOneHot ? __ldg(labels + p) : 0;
    float* row = tile + px * C;
    float lg[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        const float clean = kOneHot ? (lab == c ? 1.0f : 0.0f) : row[c];
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
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) row[c] = lg[c] / s;
  }
  __syncthreads();  // the tile is staged
  store_out(out + e0, tile, ne);
}

// The wide instance, 32 < C <= 128: a pixel's classes stay in its row of the
// tile (dynamic shared memory, np * C floats). Rows lie C words apart, so
// threads that walk their classes in step hit one bank whenever C is a
// multiple of 32: the passes whose order is free start at class px mod C,
// each thread on another bank; only the denominator is summed in class
// order, as in the register instances.
template <bool kOneHot>
__global__ void __launch_bounds__(kWideTile) corrupt_wide_kernel(
    const int* __restrict__ labels, const float* __restrict__ probs, long long n, int C,
    uint32_t seed, float sigma, float* __restrict__ out) {
  extern __shared__ __align__(16) float wide_tile[];
  const long long p0 = (long long)blockIdx.x * kWideTile;  // the tile's first pixel
  const int np = (int)min((long long)kWideTile, n - p0);
  const int ne = np * C;
  const long long e0 = p0 * C;  // its first element: 16-byte aligned (kWideTile * 4 = 256 bytes)
  if (!kOneHot) {
    stage_in(wide_tile, probs + e0, ne);
    __syncthreads();
  }

  const int px = threadIdx.x;
  if (px < np) {
    const long long p = p0 + px;
    const uint32_t base = (uint32_t)p * kLanes;
    const uint32_t seed2 = seed ^ 0xDEADBEEFu;
    const int lab = kOneHot ? __ldg(labels + p) : 0;
    float* row = wide_tile + px * C;
    const int first = px % C;
    auto turned = [&](int i) { return first + i < C ? first + i : first + i - C; };
    float m = -INFINITY;
    for (int i = 0; i < C; ++i) {
      const int c = turned(i);
      const float clean = kOneHot ? (lab == c ? 1.0f : 0.0f) : row[c];
      row[c] = __fadd_rn(clean, __fmul_rn(sigma, gauss(base + (uint32_t)c, seed, seed2)));
      m = fmaxf(m, row[c]);
    }
    for (int i = 0; i < C; ++i) {
      const int c = turned(i);
      row[c] = expf(row[c] - m);
    }
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s += row[c];
    for (int i = 0; i < C; ++i) {
      const int c = turned(i);
      row[c] = row[c] / s;
    }
  }
  __syncthreads();  // the tile is staged
  store_out(out + e0, wide_tile, ne);
}

template <bool kOneHot>
int launch(const int* labels, const float* probs, long long n, int C, unsigned seed,
           float sigma, float* out, void* stream) {
  if (n < 1 || C < 1 || C > kMaxClasses) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) & 15) return (int)cudaErrorMisalignedAddress;
  const int tile = C > kRegClasses ? kWideTile : kTile;
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > kRegClasses)
    corrupt_wide_kernel<kOneHot><<<(unsigned)blocks, kWideTile, kWideTile * C * sizeof(float), st>>>(
        labels, probs, n, C, seed, sigma, out);
  else if (C == kExactClasses)
    corrupt_kernel<kOneHot, kExactClasses, true><<<(unsigned)blocks, kTile, 0, st>>>(
        labels, probs, n, C, seed, sigma, out);
  else
    corrupt_kernel<kOneHot, kRegClasses, false><<<(unsigned)blocks, kTile, 0, st>>>(
        labels, probs, n, C, seed, sigma, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. labels: n contiguous int32; out: contiguous (n, C) float32, 16-byte
// aligned.
extern "C" int corrupt_onehot_launch(const void* labels, long long n, int C, unsigned seed,
                                     float sigma, void* out, void* stream) {
  return launch<true>(static_cast<const int*>(labels), nullptr, n, C, seed, sigma,
                      static_cast<float*>(out), stream);
}

// K2. probs: contiguous (n, C) float32; out: contiguous (n, C) float32,
// 16-byte aligned.
extern "C" int corrupt_probs_launch(const void* probs, long long n, int C, unsigned seed,
                                    float sigma, void* out, void* stream) {
  return launch<false>(nullptr, static_cast<const float*>(probs), n, C, seed, sigma,
                       static_cast<float*>(out), stream);
}

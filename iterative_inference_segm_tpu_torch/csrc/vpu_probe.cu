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
// What bounds them. K4 moves 2 x 4 (f32) or 2 x 2 (bf16) bytes an element
// and does n_fma multiply-adds: bound by bytes up to n ~ 20, by the FP32
// rate above. K5 reads and writes each element once for ~35 instructions (an
// expf and a division among them): bound by bytes, and at the probe's
// (32, 36, 11, 240) so short (7.3 us of traffic in f32, 3.6 in bf16) that an
// empty kernel's own few microseconds are a large share of its time.
//
// What held the first forms back (one element a thread in K4; one (n, r, w)
// pixel column a thread in K5, with 4 C scalar loads): the number of
// accesses and threads, not the bytes. bf16 took the same time as f32 in
// both. K4's chain also carried a loop test every 8 multiply-adds, on one
// chain a thread.
//
// What the design does about it.
// - K4: a thread takes 16 bytes (4 f32 or 8 bf16) with one vector load and
//   one vector store, and holds those 4 or 8 independent chains, the n_fma
//   loop unrolled by kFmaUnroll steps (then by 8, then the remainder). The
//   wrapper allocates out at x's offset within a 16-byte chunk, so that one
//   split serves both: a scalar head up to the first 16-byte boundary, the
//   vectors, a scalar tail; the ends are done by the first threads of the
//   grid.
// - K5, on the template of refine_tail.cu: a block takes a tile of kPatRows
//   rows r of one n, all C, all W, plus the one row below, which is one
//   contiguous span of the (N, R, C, W) map. It stages the span into shared
//   memory with 16-byte cp.async copies from the 16-byte-aligned address at
//   or below it (a span that starts off a boundary carries its head), so
//   every element is read from device memory once and the row below is
//   shared by the tile's rows. Threads compute from shared memory, 4
//   consecutive w of one row and all C classes each (one vector read of the
//   row and one of the row below a class; of the four neighbours along w
//   two are already in registers), write the result to a second region, and
//   the block stores it 16 bytes at a time (element stores at a span's
//   unaligned ends). C = 11 has an exact instance whose class loops unroll
//   with no test. Maps whose rows do not start on a 4-element boundary
//   (W % 4 != 0, or a view at an odd offset) are staged and stored the same
//   way and computed one w a thread. The tile loses rows where kPatRows do
//   not fit the card's shared memory; a map whose single row does not fit
//   is refused.
//   At the probe's (32, 36, 11, 240) three rows a tile and 256 threads put
//   all 384 blocks on the card at once, three an SM (74 KB each in f32);
//   tiles of one or two rows need a second round of blocks in f32 and were
//   14% slower or more. Loading 4 w a thread straight from device memory,
//   with no shared memory, measured 12% (f32) and 6% (bf16) faster than
//   this, with 8-byte accesses in bf16 (PERF.md has both side by side).
//
// The constants below are what was fastest cold on an H100 (PERF.md).
//
// Plain C interface (loaded with ctypes by ops/vpu_probe.py); each launch
// returns the CUDA error of its set-up or launch so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

struct Weights {
  float v[8];
};

constexpr int kFmaThreads = 256;
constexpr int kFmaBlocks = 8;   // resident blocks an SM the kernel is held to
constexpr int kFmaUnroll = 32;  // a multiple of 8
static_assert(kFmaUnroll % 8 == 0, "step k + j takes weight j & 7 only from a multiple of 8");

// V elements of T as one word of V * sizeof(T) bytes (Raw), and as f32 values.
template <typename T, int V>
struct Pack;
template <>
struct Pack<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(const Raw& q, float (&v)[1]) { v[0] = q; }
  static __device__ __forceinline__ Raw pack(const float (&v)[1]) { return v[0]; }
};
template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& q, float (&v)[4]) {
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[4]) { return make_float4(v[0], v[1], v[2], v[3]); }
};
template <>
struct Pack<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(const Raw& q, float (&v)[1]) { v[0] = __bfloat162float(q); }
  static __device__ __forceinline__ Raw pack(const float (&v)[1]) { return __float2bfloat16_rn(v[0]); }
};
template <>
struct Pack<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ void unpack(const Raw& q, float (&v)[4]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[4]) {
    Raw q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return q;
  }
};
template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& q, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[8]) {
    Raw q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return q;
  }
};

// V elements at p (aligned to their word): from device memory through the
// read-only path, from any memory, and to any memory.
template <typename T, int V>
__device__ __forceinline__ void load_global(const T* p, float (&v)[V]) {
  Pack<T, V>::unpack(__ldg(reinterpret_cast<const typename Pack<T, V>::Raw*>(p)), v);
}
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  Pack<T, V>::unpack(*reinterpret_cast<const typename Pack<T, V>::Raw*>(p), v);
}
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  *reinterpret_cast<typename Pack<T, V>::Raw*>(p) = Pack<T, V>::pack(v);
}

// V independent chains: acc[v] = fmaf(x[v], w[i & 7], acc[v]) for i < n_fma.
template <int V>
__device__ __forceinline__ void chain(float (&acc)[V], const float (&x)[V], int n_fma, const Weights& w) {
  int k = 0;
  for (; k + kFmaUnroll <= n_fma; k += kFmaUnroll) {
#pragma unroll
    for (int j = 0; j < kFmaUnroll; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(x[v], w.v[j & 7], acc[v]);
    }
  }
  // k stays a multiple of 8, so step k + j takes weight j
  for (; k + 8 <= n_fma; k += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(x[v], w.v[j], acc[v]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (k + j < n_fma) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(x[v], w.v[j], acc[v]);
    }
  }
}

// x and out share their offset within a 16-byte chunk. Elements [0, head)
// lie before the first boundary, then n_vec vectors, then the tail up to n.
template <typename T>
__global__ void __launch_bounds__(kFmaThreads, kFmaBlocks) fma_chain_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long n, int head, long long n_vec, int n_fma,
    const Weights w) {
  constexpr int V = 16 / (int)sizeof(T);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_vec) {
    float xv[V], acc[V];
    load_global<T, V>(x + head + i * V, xv);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = xv[v];
    chain<V>(acc, xv, n_fma, w);
    store<T, V>(out + head + i * V, acc);
  }
  const long long tail = head + n_vec * V;  // the first element after the vectors
  if (i < head + (n - tail)) {              // the two ends: fewer than 2 V elements
    const long long e = i < head ? i : tail + (i - head);
    float xs[1], as[1];
    load_global<T, 1>(x + e, xs);
    as[0] = xs[0];
    chain<1>(as, xs, n_fma, w);
    store<T, 1>(out + e, as);
  }
}

constexpr int kCMax = 16;
constexpr int kPatThreads = 256;
constexpr int kPatRows = 3;  // rows r of a tile, before the one below
constexpr int kPatVec = 4;   // consecutive w a thread takes where rows start on that boundary
constexpr int kPatSharedMost = 227 * 1024;  // the card's shared memory a block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Stage the n elements at src into dst with 16-byte cp.async copies from the
// 16-byte-aligned address at or below src. Returns the byte in dst at which
// the span starts (its head).
template <typename T>
__device__ __forceinline__ int stage(unsigned char* dst, const T* src, int n) {
  const int head = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  const unsigned char* a = reinterpret_cast<const unsigned char*>(src) - head;
  const int chunks = (head + n * (int)sizeof(T) + 15) >> 4;
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) cp_async16(dst + 16 * k, a + 16 * k);
  return head;
}

// Store n elements to dst from src, which holds them from byte (dst & 15):
// 16-byte stores for the whole chunks, element stores at the two ends (the
// chunks there are shared with the neighbouring tiles).
template <typename T>
__device__ __forceinline__ void store_span(T* dst, const unsigned char* src, int n) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const int head = (int)(d & 15);
  unsigned char* base = reinterpret_cast<unsigned char*>(d - head);
  const int end = head + n * (int)sizeof(T);
  const int a = (head + 15) & ~15, e = end & ~15;
  for (int k = (a >> 4) + threadIdx.x; k < (e >> 4); k += blockDim.x)
    reinterpret_cast<uint4*>(base)[k] = reinterpret_cast<const uint4*>(src)[k];
  const int lo_end = min(a, end), hi_start = max(lo_end, e);  // a span inside one chunk: all "lo"
  const int n_lo = (lo_end - head) / (int)sizeof(T), n_hi = (end - hi_start) / (int)sizeof(T);
  for (int i = threadIdx.x; i < n_lo + n_hi; i += blockDim.x) {
    const int byte = i < n_lo ? head + i * (int)sizeof(T) : hi_start + (i - n_lo) * (int)sizeof(T);
    *reinterpret_cast<T*>(base + byte) = *reinterpret_cast<const T*>(src + byte);
  }
}

// One block a tile: rows [r0, r0 + rows) of one n, all C, all W, and the row
// below the last where the map has one. A thread takes V consecutive w of
// one row and all classes at a time; V > 1 needs every row of both regions
// on a V-element boundary (W % V == 0, x and out aligned to V elements).
// kExact: C == CMAX, so the class loops unroll with no test of c < C.
// reg_in: the shared bytes of the staged input, a multiple of 16.
template <typename T, int V, int CMAX, bool kExact>
__global__ void __launch_bounds__(kPatThreads) pattern_softmax_kernel(
    const T* __restrict__ x, const float* __restrict__ kc, T* __restrict__ out,
    int R, int C_, int W, int rows, int tiles, int reg_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = kExact ? CMAX : C_;
  const int n = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - n * tiles) * rows;
  const int n_rows = min(rows, R - r0);
  const int in_rows = min(n_rows + 1, R - r0);
  const int slab = C * W;  // elements of one (n, r)
  const long long first = ((long long)n * R + r0) * slab;
  const int head = stage(smem, x + first, in_rows * slab);
  T* dst = out + first;
  unsigned char* s_out = smem + reg_in;
  cp_async_wait_all();
  __syncthreads();

  const T* xi = reinterpret_cast<const T*>(smem + head);
  T* so = reinterpret_cast<T*>(s_out + (reinterpret_cast<uintptr_t>(dst) & 15));
  const int wv = W / V;  // items a row
  for (int item = threadIdx.x; item < n_rows * wv; item += kPatThreads) {
    const int rr = item / wv, w0 = (item - rr * wv) * V;
    const int at = rr * slab + w0;  // element (rr, 0, w0) of the tile
    const bool has_left = w0 > 0, has_right = w0 + V < W, has_up = rr + 1 < in_rows;

    float s[CMAX][V];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        const float k = __ldg(kc + c);
        const T* p = xi + at + c * W;
        float a[V], up[V], left[1] = {0.0f}, right[1] = {0.0f};
        load<T, V>(p, a);
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] = __fmul_rn(a[i], k);
        if (has_up) {
          load<T, V>(p + slab, up);
#pragma unroll
          for (int i = 0; i < V; ++i) up[i] = __fmul_rn(up[i], k);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) up[i] = 0.0f;
        }
        if (has_left) {
          load<T, 1>(p - 1, left);
          left[0] = __fmul_rn(left[0], k);
        }
        if (has_right) {
          load<T, 1>(p + V, right);
          right[0] = __fmul_rn(right[0], k);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float v = __fadd_rn(a[i], __fmul_rn(0.5f, i > 0 ? a[i - 1] : left[0]));
          v = __fadd_rn(v, __fmul_rn(0.25f, i < V - 1 ? a[i + 1] : right[0]));
          s[c][i] = __fadd_rn(v, __fmul_rn(0.125f, up[i]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float s3 = s[3][i];  // the value before the update, for every class
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) s[c][i] = __fadd_rn(s[c][i], __fmul_rn(s3, 0.01f));
      float m = s[0][i];
#pragma unroll
      for (int c = 1; c < CMAX; ++c)
        if (c < C) m = fmaxf(m, s[c][i]);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          s[c][i] = expf(__fadd_rn(s[c][i], -m));
          sum = __fadd_rn(sum, s[c][i]);
        }
      }
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) s[c][i] = __fdiv_rn(s[c][i], sum);
    }
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) store<T, V>(so + at + c * W, s[c]);
  }
  __syncthreads();  // the tile's output is staged

  store_span(dst, s_out, n_rows * slab);
}

__global__ void empty_kernel() {}

int round16(int n) { return (n + 15) & ~15; }

// Once an instance (one `configured` word each) a device: allow the most
// shared memory a launch may ask for, and give the unified L1/shared memory
// to shared memory first (the copies bypass L1, cp.async.cg).
template <typename K>
cudaError_t configure_once(K kernel, std::atomic<unsigned long long>& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);  // one bit a device
  if (configured.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPatSharedMost);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  configured.fetch_or(bit);
  return cudaSuccess;
}

template <typename T, int V, int CMAX, bool kExact>
cudaError_t launch_pattern(const T* x, const float* kc, T* out, int N, int R, int C, int W,
                           cudaStream_t stream) {
  auto kernel = pattern_softmax_kernel<T, V, CMAX, kExact>;
  static std::atomic<unsigned long long> configured{0};
  const cudaError_t err = configure_once(kernel, configured);
  if (err != cudaSuccess) return err;
  // shared bytes of a tile: rows + 1 rows in and rows out, each with the
  // up-to-15-byte head its span starts at
  const long long slab = (long long)C * W * (long long)sizeof(T);
  int rows = kPatRows < R ? kPatRows : R;
  while (rows > 1 && (2 * rows + 1) * slab + 64 > kPatSharedMost) --rows;
  if ((2 * rows + 1) * slab + 64 > kPatSharedMost) return cudaErrorInvalidValue;
  const int reg_in = round16((rows + 1) * (int)slab) + 16;
  const int smem = reg_in + round16(rows * (int)slab) + 16;
  const int tiles = (R + rows - 1) / rows;
  const long long blocks = (long long)N * tiles;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kPatThreads, smem, stream>>>(x, kc, out, R, C, W, rows, tiles, reg_in);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_pattern(const void* x_, const float* kc, void* out_, int N, int R, int C, int W,
                        cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  constexpr int kAlign = kPatVec * (int)sizeof(T) - 1;
  const bool vec =
      W % kPatVec == 0 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & kAlign) == 0;
  // the probe's 11 classes unroll exactly; other counts run loops tested
  // against a run-time C
  if (vec && C == 11) return launch_pattern<T, kPatVec, 11, true>(x, kc, out, N, R, C, W, stream);
  if (vec) return launch_pattern<T, kPatVec, kCMax, false>(x, kc, out, N, R, C, W, stream);
  return launch_pattern<T, 1, kCMax, false>(x, kc, out, N, R, C, W, stream);
}

template <typename T>
cudaError_t run_fma(const void* x, void* out, long long n, int n_fma, const Weights& w,
                    cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  if ((a ^ reinterpret_cast<uintptr_t>(out)) & 15) return cudaErrorMisalignedAddress;
  long long head = (long long)((16 - (a & 15)) & 15) / (long long)sizeof(T);
  if (head > n) head = n;
  const long long n_vec = (n - head) / V;
  const long long blocks = n_vec > 0 ? (n_vec + kFmaThreads - 1) / kFmaThreads : 1;  // the ends need one
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  fma_chain_kernel<T><<<(unsigned)blocks, kFmaThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, (int)head, n_vec, n_fma, w);
  return cudaGetLastError();
}

}  // namespace

// K4. dtype: 0 = float32, 1 = bfloat16. x, out: n contiguous elements, at
// the same offset within a 16-byte chunk.
extern "C" int fma_chain_launch(int dtype, const void* x, void* out, long long n, int n_fma,
                                float w0, float w1, float w2, float w3, float w4, float w5,
                                float w6, float w7, void* stream) {
  if (n < 1 || n_fma < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Weights w{{w0, w1, w2, w3, w4, w5, w6, w7}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_fma<float>(x, out, n, n_fma, w, st);
  return (int)run_fma<__nv_bfloat16>(x, out, n, n_fma, w, st);
}

// K5. x, out: contiguous (N, R, C, W) of the dtype; kc: C float32 on the
// card. Three C x W rows of the dtype (two staged, one of results) must fit
// a block's shared memory.
extern "C" int pattern_softmax_launch(int dtype, const void* x, const void* kc, void* out,
                                      int N, int R, int C, int W, void* stream) {
  if (N < 1 || R < 1 || W < 1 || C < 4 || C > kCMax || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* k = static_cast<const float*>(kc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_pattern<float>(x, k, out, N, R, C, W, st);
  return (int)run_pattern<__nv_bfloat16>(x, k, out, N, R, C, W, st);
}

// An empty kernel through the same route: what a launch and its two events
// cost on the device, the floor under a kernel of a few microseconds.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

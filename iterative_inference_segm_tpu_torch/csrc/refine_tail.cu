// refine_tail.cu — the refinement step's class-width epilogue, fused, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels tools/tail_kernel_proto.py::kernel_unroll and
// ::kernel_dot (the prototype "K3"), which compute, row-wise over pixels,
//     logits = u + y.W + b;  r = softmax(logits);  y' = (1 - eps) y + eps r.
// This kernel computes the same function, extended for the refinement
// engines' main paths (inference/fused.py, inference/iterative.py):
//     logits = crop(u) + v + y.W + b      (v, W, b each optional)
//     r      = softmax(logits)            over C <= 128 classes
//     y'     = (1 - eps) y + eps r        one rounding, on the store
//     labels = argmax(y')                 optional; on the stored (rounded)
//                                          values, first maximum wins
// u is read through its own strides at crop_to's centre offsets, so the
// cropped sum crop(u) + v is never materialized. y, v and y' are f32 or
// bf16; u has y's dtype, or is bf16 beside an f32 y (the general engine's
// bf16 logits, widened in registers instead of by a cast pass). All
// arithmetic is f32.
//
// What bounds it: device-memory bytes. At C = 11 the class axis is far too
// narrow for tensor cores, and a pixel needs ~6 flops per byte moved. In bf16
// a refinement step moves 88 B/pixel (u, v and y read at 22 B each, y'
// written at 22 B). What held the first, one-pixel-a-thread form of this
// kernel at 16-29% of the bandwidth was the number of accesses, not bytes:
// C scalar 2- or 4-byte loads per map at a 22- or 44-byte stride.
//
// What the design does about it. A block works on one tile of up to kTile
// pixels of one (b, h) row (tiles balanced along the row), and the grid
// covers every tile: 16 blocks resident on an SM overlap one another's
// copies and arithmetic (a persistent grid with a ring of two to four tiles
// in flight a block measured slower). Where a map is row-packed (class
// stride 1, pixel stride C, as the NHWC views of channels_last convolution
// outputs are), a tile's span of it is contiguous: the block copies it to
// shared memory in 16-byte cp.async copies, neighbouring threads on
// neighbouring words, from the 16-byte-aligned address at or below the span
// (a crop offset or an odd row pitch leaves the span 2-byte aligned; the
// head offset is carried). Each thread then computes one pixel from shared
// memory exactly as the first form did (same f32 operations, same order),
// writes y' (and its label) to shared memory, and the block stores the
// tile's output span with 16-byte stores, with element stores only at its
// unaligned ends. A map that is not row-packed is staged element by element
// in the same kernel (the wrapper counts those launches apart). A 16-byte
// chunk holding at least one byte of a map lies in the same page as that
// byte, so reading the whole chunk cannot fault.
//
// Up to 32 classes a pixel's classes live in registers (C = 11 exactly
// unrolled, else loops against a run-time C over 16 or 32). From 33 to 128
// (the cap of the JAX package's own Pallas kernels) they would spill, so a
// wide instance keeps them in shared memory, where the tile is staged
// anyway: the same staging and stores, the same f32 operations, the softmax
// in the same class order, the logits held in a scratch row of shared
// memory between its passes, and a tile that shrinks with C to fit (38
// pixels at C = 128 in f32). It is right, not tuned: no dataset of the repo
// reaches it.
//
// Plain C interface (loaded with ctypes by ops/refine_tail.py); the launch
// returns the CUDA error of its set-up or launch so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 128;  // pixels of a row per block, one a thread
constexpr int kRegClasses = 32;   // the most classes a pixel holds in registers
constexpr int kMaxClasses = 128;  // the most the wide instance takes
constexpr int kWideBytes = 96 * 1024;  // shared memory a tile of the wide instance may fill

struct Map {
  const void* p;             // element (0, 0, 0, 0); null for an absent v
  long long sb, sh, sw, sc;  // strides in elements
  int packed;                // sc == 1 and sw == C: a tile's span is contiguous
};

struct Params {
  Map u, v, y;
  int off_h, off_w;  // u's crop offsets
  const float* wmat;
  const float* bias;
  float eps, one_minus_eps;
  void* out;    // contiguous (B, H, W, C), y's dtype
  int* labels;  // contiguous (B, H, W), or null
  int H, W, C;
  int tile, tiles_per_row;         // a row is cut into tiles_per_row tiles of <= tile pixels
  int reg_u, reg_v, reg_y, reg_o;  // shared bytes of one tile of each map
  int reg_s;                       // and of the wide instance's f32 logits
};

__device__ __forceinline__ long long offset(const Map& m, int b, int h, int w) {
  return b * m.sb + h * m.sh + w * m.sw;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float store(float* p, float x) {
  *p = x;
  return x;
}
__device__ __forceinline__ float store(__nv_bfloat16* p, float x) {
  __nv_bfloat16 q = __float2bfloat16_rn(x);
  *p = q;
  return __bfloat162float(q);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Stage n pixels (n * C elements) of a map, from element off, into dst:
// 16-byte cp.async copies for a row-packed map, from the 16-byte-aligned
// address at or below the span; element loads otherwise. Returns the byte
// in dst at which the span starts (its head offset; 0 for element loads).
template <typename E>
__device__ __forceinline__ int stage(unsigned char* dst, const Map& m, long long off, int n, int C) {
  const E* src = static_cast<const E*>(m.p) + off;
  if (m.packed) {
    const int head = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    const unsigned char* a = reinterpret_cast<const unsigned char*>(src) - head;
    const int chunks = (head + n * C * (int)sizeof(E) + 15) >> 4;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x) cp_async16(dst + 16 * k, a + 16 * k);
    return head;
  }
  E* d = reinterpret_cast<E*>(dst);
  for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
    const int px = i / C, c = i - px * C;
    d[i] = __ldg(src + px * m.sw + c * m.sc);
  }
  return 0;
}

// Store n elements to dst from src, which holds them from byte (dst & 15):
// 16-byte stores for the whole chunks, element stores at the two ends (the
// chunks there are shared with the neighbouring tiles).
template <typename E>
__device__ __forceinline__ void store_span(E* dst, const unsigned char* src, int n) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const int head = (int)(d & 15);
  unsigned char* base = reinterpret_cast<unsigned char*>(d - head);
  const int end = head + n * (int)sizeof(E);
  const int a = (head + 15) & ~15, e = end & ~15;
  for (int k = (a >> 4) + threadIdx.x; k < (e >> 4); k += blockDim.x)
    reinterpret_cast<uint4*>(base)[k] = reinterpret_cast<const uint4*>(src)[k];
  const int lo_end = min(a, end), hi_start = max(lo_end, e);  // a span inside one chunk: all "lo"
  const int n_lo = (lo_end - head) / (int)sizeof(E), n_hi = (end - hi_start) / (int)sizeof(E);
  for (int i = threadIdx.x; i < n_lo + n_hi; i += blockDim.x) {
    const int byte = i < n_lo ? head + i * (int)sizeof(E) : hi_start + (i - n_lo) * (int)sizeof(E);
    *reinterpret_cast<E*>(base + byte) = *reinterpret_cast<const E*>(src + byte);
  }
}

// One block a tile of up to kTile pixels of one (b, h) row. kExact: C ==
// CMAX, so the class loops unroll with no test of c < C; those instances are
// held to 32 registers, so that 16 blocks (all 64 warps) fit on an SM (left
// free, the compiler keeps all of a pixel's loads in flight in several times
// as many registers, and a fraction of the blocks fit; chip_smoke.py's build
// phase prints each instance's registers and spills).
template <typename T, typename TU, int CMAX, bool kExact>
__global__ void __launch_bounds__(kTile, kExact ? 16 : 1) refine_tail_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = kExact ? CMAX : p.C;
  const int row = blockIdx.x / p.tiles_per_row;
  const int b = row / p.H, h = row - b * p.H;
  const int w0 = (blockIdx.x - row * p.tiles_per_row) * p.tile;
  const int n = min(p.tile, p.W - w0);
  const bool has_v = p.v.p != nullptr;

  unsigned char* s_u = smem;
  unsigned char* s_v = s_u + p.reg_u;
  unsigned char* s_y = s_v + p.reg_v;
  unsigned char* s_out = s_y + p.reg_y;
  unsigned char* s_lab = s_out + p.reg_o;
  const int hu = stage<TU>(s_u, p.u, offset(p.u, b, h + p.off_h, w0 + p.off_w), n, C);
  const int hv = has_v ? stage<T>(s_v, p.v, offset(p.v, b, h, w0), n, C) : 0;
  const int hy = stage<T>(s_y, p.y, offset(p.y, b, h, w0), n, C);
  cp_async_wait_all();
  __syncthreads();

  const long long n0 = ((long long)b * p.H + h) * p.W + w0;  // the tile's first output pixel
  T* out = static_cast<T*>(p.out) + n0 * C;
  const int px = threadIdx.x;
  if (px < n) {
    const TU* up = reinterpret_cast<const TU*>(s_u + hu) + px * C;
    const T* yp = reinterpret_cast<const T*>(s_y + hy) + px * C;
    float yv[CMAX];
    float lg[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        yv[c] = widen(yp[c]);
        lg[c] = widen(up[c]);
      }
    }
    if (has_v) {
      const T* vp = reinterpret_cast<const T*>(s_v + hv) + px * C;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) lg[c] += widen(vp[c]);
    }
    if (p.wmat != nullptr) {
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < CMAX; ++k)
            if (k < C) acc = fmaf(yv[k], __ldg(p.wmat + k * C + c), acc);
          lg[c] += acc;
        }
      }
    }
    if (p.bias != nullptr) {
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) lg[c] += __ldg(p.bias + c);
    }

    float m = lg[0];
#pragma unroll
    for (int c = 1; c < CMAX; ++c)
      if (c < C) m = fmaxf(m, lg[c]);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        lg[c] = expf(lg[c] - m);
        sum += lg[c];
      }
    }

    T* op = reinterpret_cast<T*>(s_out + (reinterpret_cast<uintptr_t>(out) & 15)) + px * C;
    float best = 0.f;
    int arg = 0;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        const float r = lg[c] / sum;
        const float q = store(op + c, p.one_minus_eps * yv[c] + p.eps * r);
        if (c == 0 || q > best) {
          best = q;
          arg = c;
        }
      }
    }
    if (p.labels != nullptr)
      reinterpret_cast<int*>(s_lab + (reinterpret_cast<uintptr_t>(p.labels + n0) & 15))[px] = arg;
  }
  __syncthreads();  // the tile's output is staged

  store_span(out, s_out, n * C);
  if (p.labels != nullptr) store_span(p.labels + n0, s_lab, n);
}

// The wide instance, 32 < C <= 128: as refine_tail_kernel, but a pixel's
// classes stay in shared memory. The thread loops over them against the
// run-time C: the logits into its scratch row, their max, exp and sum in
// class order, then blend and argmax, each operation as in the register
// instances.
template <typename T, typename TU>
__global__ void __launch_bounds__(kTile) refine_tail_wide_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C;
  const int row = blockIdx.x / p.tiles_per_row;
  const int b = row / p.H, h = row - b * p.H;
  const int w0 = (blockIdx.x - row * p.tiles_per_row) * p.tile;
  const int n = min(p.tile, p.W - w0);
  const bool has_v = p.v.p != nullptr;

  unsigned char* s_u = smem;
  unsigned char* s_v = s_u + p.reg_u;
  unsigned char* s_y = s_v + p.reg_v;
  unsigned char* s_out = s_y + p.reg_y;
  unsigned char* s_lg = s_out + p.reg_o;
  unsigned char* s_lab = s_lg + p.reg_s;
  const int hu = stage<TU>(s_u, p.u, offset(p.u, b, h + p.off_h, w0 + p.off_w), n, C);
  const int hv = has_v ? stage<T>(s_v, p.v, offset(p.v, b, h, w0), n, C) : 0;
  const int hy = stage<T>(s_y, p.y, offset(p.y, b, h, w0), n, C);
  cp_async_wait_all();
  __syncthreads();

  const long long n0 = ((long long)b * p.H + h) * p.W + w0;  // the tile's first output pixel
  T* out = static_cast<T*>(p.out) + n0 * C;
  const int px = threadIdx.x;
  if (px < n) {
    const TU* up = reinterpret_cast<const TU*>(s_u + hu) + px * C;
    const T* vp = reinterpret_cast<const T*>(s_v + hv) + px * C;
    const T* yp = reinterpret_cast<const T*>(s_y + hy) + px * C;
    // A pixel's classes lie C elements from its neighbour's: threads that
    // walk them in step hit one bank of shared memory whenever C is a
    // multiple of 32. So the passes whose order is free start at class
    // px mod C, each thread on another bank; the scratch row is C + 1 long,
    // so that the softmax's passes, in class order, are conflict-free too.
    float* lg = reinterpret_cast<float*>(s_lg) + px * (C + 1);
    const int first = px % C;
    for (int i = 0; i < C; ++i) {
      const int c = first + i < C ? first + i : first + i - C;
      float l = widen(up[c]);
      if (has_v) l += widen(vp[c]);
      if (p.wmat != nullptr) {
        float acc = 0.f;
        for (int k = 0; k < C; ++k) acc = fmaf(widen(yp[k]), __ldg(p.wmat + k * C + c), acc);
        l += acc;
      }
      if (p.bias != nullptr) l += __ldg(p.bias + c);
      lg[c] = l;
    }
    float m = lg[0];
    for (int c = 1; c < C; ++c) m = fmaxf(m, lg[c]);
    float sum = 0.f;
    for (int c = 0; c < C; ++c) {
      const float e = expf(lg[c] - m);
      lg[c] = e;
      sum += e;
    }
    T* op = reinterpret_cast<T*>(s_out + (reinterpret_cast<uintptr_t>(out) & 15)) + px * C;
    float best = -INFINITY;
    int arg = 0;
    for (int i = 0; i < C; ++i) {
      const int c = first + i < C ? first + i : first + i - C;
      const float r = lg[c] / sum;
      const float q = store(op + c, p.one_minus_eps * widen(yp[c]) + p.eps * r);
      if (q > best || (q == best && c < arg)) {  // the first maximum in class order
        best = q;
        arg = c;
      }
    }
    if (p.labels != nullptr)
      reinterpret_cast<int*>(s_lab + (reinterpret_cast<uintptr_t>(p.labels + n0) & 15))[px] = arg;
  }
  __syncthreads();  // the tile's output is staged

  store_span(out, s_out, n * C);
  if (p.labels != nullptr) store_span(p.labels + n0, s_lab, n);
}

inline int round16(int bytes) { return (bytes + 15) & ~15; }

// Shared bytes of one tile of a map of C classes of E: the span, plus the
// up-to-15-byte head it starts at.
template <typename E>
int region(int tile, int C) { return round16(tile * C * (int)sizeof(E)) + 16; }

// Once an instance (one `configured` word each) a device: allow the most
// shared memory any launch of it asks for, and give the unified L1/shared
// memory to shared memory first (the copies bypass L1, cp.async.cg, and
// more resident blocks hide more latency).
template <typename K>
cudaError_t configure_once(K kernel, int most, std::atomic<unsigned long long>& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);  // one bit a device
  if (configured.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  configured.fetch_or(bit);
  return cudaSuccess;
}

// The shared regions of a launch's tile; returns their sum. kWide adds the
// f32 logits.
template <typename T, typename TU, bool kWide>
int set_regions(Params& p) {
  p.reg_u = region<TU>(p.tile, p.C);
  p.reg_y = region<T>(p.tile, p.C);
  p.reg_v = p.v.p ? p.reg_y : 0;
  p.reg_o = p.reg_y;
  p.reg_s = kWide ? region<float>(p.tile, p.C + 1) : 0;
  const int reg_l = p.labels ? region<int>(p.tile, 1) : 0;
  return p.reg_u + p.reg_v + p.reg_y + p.reg_o + p.reg_s + reg_l;
}

template <typename T, typename TU, int CMAX, bool kExact = false>
cudaError_t run(Params p, int grid, cudaStream_t stream) {
  auto kernel = refine_tail_kernel<T, TU, CMAX, kExact>;
  static std::atomic<unsigned long long> configured{0};
  // the most: every map and labels at CMAX
  const int most = region<TU>(kTile, CMAX) + 3 * region<T>(kTile, CMAX) + region<int>(kTile, 1);
  const cudaError_t err = configure_once(kernel, most, configured);
  if (err != cudaSuccess) return err;
  const int smem = set_regions<T, TU, false>(p);
  kernel<<<grid, kTile, smem, stream>>>(p);
  return cudaGetLastError();
}

// Bytes of shared memory a pixel of the wide instance takes: u, v, y, y',
// the C + 1 f32 logits and a label.
template <typename T, typename TU>
constexpr int wide_pixel_bytes(int C) {
  return C * (int)(sizeof(TU) + 3 * sizeof(T) + sizeof(float)) + (int)(sizeof(float) + sizeof(int));
}

template <typename T, typename TU>
cudaError_t run_wide(Params p, int grid, cudaStream_t stream) {
  auto kernel = refine_tail_wide_kernel<T, TU>;
  static std::atomic<unsigned long long> configured{0};
  // the most: kWideBytes of pixels, and six regions' heads and rounding
  const cudaError_t err = configure_once(kernel, kWideBytes + 6 * 32, configured);
  if (err != cudaSuccess) return err;
  const int smem = set_regions<T, TU, true>(p);
  kernel<<<grid, kTile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TU>
cudaError_t run_c(const Params& p, int grid, cudaStream_t stream) {
  // CamVid's 11 classes unroll exactly; other counts run loops tested
  // against a run-time C, markedly slower
  if (p.C == 11) return run<T, TU, 11, true>(p, grid, stream);
  if (p.C > kRegClasses) return run_wide<T, TU>(p, grid, stream);
  return p.C <= 16 ? run<T, TU, 16>(p, grid, stream) : run<T, TU, 32>(p, grid, stream);
}

// The most pixels a tile holds: kTile, or fewer where the wide instance's
// shared memory sets it.
int most_tile(int C, int dtype, int u_dtype) {
  if (C <= kRegClasses) return kTile;
  const int per = dtype == 1 ? wide_pixel_bytes<__nv_bfloat16, __nv_bfloat16>(C)
                  : u_dtype == 1 ? wide_pixel_bytes<float, __nv_bfloat16>(C)
                                 : wide_pixel_bytes<float, float>(C);
  const int fits = kWideBytes / per;
  return fits < kTile ? fits : kTile;
}

}  // namespace

// dtype (y, v, out) and u_dtype: 0 = float32, 1 = bfloat16; u_dtype equals
// dtype, or is 1 with dtype 0. v, wmat, bias and labels may be null. A map's
// *_packed flag says that its class stride is 1 and its pixel stride C.
// out is a contiguous (B, H, W, C) tensor of y's dtype, labels (B, H, W).
// B * H * W < 2^31.
extern "C" int refine_tail_launch(
    int dtype, int u_dtype, int B, int H, int W, int C,
    const void* u, long long su_b, long long su_h, long long su_w, long long su_c, int u_packed,
    int off_h, int off_w,
    const void* v, long long sv_b, long long sv_h, long long sv_w, long long sv_c, int v_packed,
    const void* y, long long sy_b, long long sy_h, long long sy_w, long long sy_c, int y_packed,
    const void* wmat, const void* bias, float eps, float one_minus_eps,
    void* out, void* labels, void* stream) {
  if (C < 1 || C > kMaxClasses || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Params p{};
  p.u = Map{u, su_b, su_h, su_w, su_c, u_packed};
  p.v = Map{v, sv_b, sv_h, sv_w, sv_c, v_packed};
  p.y = Map{y, sy_b, sy_h, sy_w, sy_c, y_packed};
  p.off_h = off_h;
  p.off_w = off_w;
  p.wmat = static_cast<const float*>(wmat);
  p.bias = static_cast<const float*>(bias);
  p.eps = eps;
  p.one_minus_eps = one_minus_eps;
  p.out = out;
  p.labels = static_cast<int*>(labels);
  p.H = H;
  p.W = W;
  p.C = C;
  const int most = most_tile(C, dtype, u_dtype);
  p.tiles_per_row = (W + most - 1) / most;
  p.tile = (W + p.tiles_per_row - 1) / p.tiles_per_row;  // balanced tiles along the row
  const long long blocks = (long long)B * H * p.tiles_per_row;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && u_dtype == 0) return (int)run_c<float, float>(p, grid, st);
  if (dtype == 1 && u_dtype == 1) return (int)run_c<__nv_bfloat16, __nv_bfloat16>(p, grid, st);
  if (dtype == 0 && u_dtype == 1) return (int)run_c<float, __nv_bfloat16>(p, grid, st);
  return (int)cudaErrorInvalidValue;
}

// septail_step.cu — one full-resolution step of the phase-major 'fused'
// refinement engine, one kernel, for Hopper (sm_90a).
//
// Carries the XLA fusion of iterative_inference_segm_tpu/inference/fused.py:
// septail_phase_logits (:98-149) and the softmax and blend of
// fused_refinement_scan's step (:179-181). It replaces no pl.pallas_call: on
// the TPU the step was ~600 elementwise ops that XLA fused. The carry is
// phase-major and channel-leading, y_ph (B, 2, 2, C, Hh, Wh) with
// y_ph[b, ph, pw, c, j, u] = y[b, 2j + ph, 2u + pw, c]; s is the DAE core's
// half-resolution score map (B, Hh, Wh, C) in the carry's dtype, dense NHWC
// (what dae_core returns) or dense channel-leading seen through NHWC strides
// (the transpose the JAX step writes out, :178, is never materialized). Per
// full-resolution pixel (b, ph, pw, j, u) and class c:
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
// kernels read the table as q = ph + dr + 2 (1..4): plane q & 1, shift
// (q >> 1) - 1. Columns alike.
//
// What bounds it. The bytes: one launch reads y_ph and s and writes y_ph'
// once; at the bench step (B = 128, C = 11, 360x480) that is 243.3 M +
// 60.8 M values read and 243.3 M written: 1.095 GB in bf16, ~0.33 ms at
// 3.35 TB/s (an f32 carry: 2.19 GB, ~0.65 ms). The operations: 13 C tap
// multiply-adds, C^2 mix multiply-adds and the softmax, ~860 a pixel at
// C = 11, ~0.28 ms at 67 TFLOP/s f32. Close behind both comes the issue
// rate: the ~700 instructions a pixel of the design below (four fifths of
// them the taps, the mix, the softmax and the stores; the rest the copies'
// and the stores' addresses) take ~0.5 ms at one instruction a clock on each
// of an SM's four schedulers, and the kernel issues at about half that rate:
// it is bound by what it issues and how many warps cover each other's
// latency (PERF.md §6, table S1), not by its bytes.
//
// The first form (one thread a pixel, every tap and every weight a separate
// load from device memory, 64-bit index divisions) issued ~420 loads a
// pixel, read each y value 9 times and each s value up to 16 times through
// L1, and held 104 registers in bf16: 5.67 ms at the bench step, 5.8% of
// the byte bound. The tiled form, for 1..16 classes:
//   - A tile is kTJ x kTU = 12 x 16 half-resolution positions of one image,
//     all four phases and all classes (the bench's 180 x 240 map in 15 x 15
//     tiles, none ragged). A persistent grid, as many blocks as fit on the
//     card at once, walks the tiles; no index is divided at run time but
//     once a tile.
//   - A block stages a tile's windows in shared memory: the four phase
//     planes of y_ph for all C classes over the tile and a one-position halo
//     (14 x 18 positions, the table above's every full-resolution
//     neighbour), and the window of s (NHWC rows of 18 C values). Both go
//     by 16-byte cp.async copies, each wholly inside the map or zero filled
//     past it, the step's edge fill (Wh a multiple of 8 in bf16, of 4 in
//     f32, Wh C likewise for s, 16-byte aligned maps); s's rows run on into
//     the rows beside the map, so the window's positions past the left and
//     right edges are zeroed after the copies land. Other maps and a
//     channel-leading s are staged a value at a time. TMA's tile copy would
//     issue no instruction a value, but faulted with an illegal
//     instruction on the H100 it was tried on (PERF.md §6).
//   - Two stages: the copies of the block's next tile land in one while it
//     computes the tile in the other (with one tile a block the copies and
//     the arithmetic did not overlap; PERF.md §6).
//     The 26 C + C^2 + C weights are staged once a block as f32 and read at
//     warp-uniform addresses, 16 bytes at a time.
//   - A thread computes the four phases of one half-resolution position, a
//     2x2 block of full-resolution pixels: their four 3x3 stencils share one
//     4x4 window of y (16 shared reads a class for four pixels, not 36), and
//     their deconv taps one 3x3 window of s (9, not 16); each weight read
//     serves four pixels, the mix's too (all four phases a pass).
//   - The mix stays on CUDA cores in f32, in the first form's order; the
//     exponential is ex2.approx of the logit scaled by log2(e) less the
//     scaled maximum (within ~2 ulp), the division one reciprocal a pixel.
//   - Stores are coalesced along u: a warp writes two runs of 16 values.
// CamVid's 11 classes unroll exactly (no test of c < C); 1..16 classes (EM's
// and Polyps' 2 among them) take loops of 16 tested against the run-time C.
// Both are held to 168 registers, two blocks of 192 threads an SM (the four
// phases' sums and logits, 88 values, live through the mix); bf16's two
// stages take 92 KB of shared memory at C = 11 (two blocks an SM), f32's
// 141 KB (one). The launch asks for its dynamic shared memory above 48 KB
// with cudaFuncSetAttribute; a refused attribute or launch returns its CUDA
// error to the wrapper, which raises.
//
// 17..128 classes keep the first form, unchanged: no dataset of the repo has
// more than 11 classes. Its pixel's values live in arrays the compiler keeps
// in local memory, loops against the run-time C. Above 128 the launch is
// refused, the cap of the repo's other kernels.
//
// Plain C interface (loaded with ctypes by ops/septail_step.py); the launch
// returns the CUDA error of its set-up or launch so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------- the first form (17..128 classes)

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


// ---------------------------------------------------------------- the tiled form (1..16 classes)

constexpr int kTJ = 12, kTU = 16;             // half-resolution positions a tile
constexpr int kTileThreads = kTJ * kTU;       // one position (four pixels) a thread
constexpr int kRows = kTJ + 2, kCols = kTU + 2;  // the tile and its one-position halo
constexpr int kTaps = 28;                     // a class's weights: 16 deconv, 9 stencil, 3 zero
constexpr int kTileClasses = 16;              // the most classes the tiled form takes
constexpr float kLog2e = 1.4426950408889634f;

// Values of T in a 16-byte copy.
template <typename T>
__host__ __device__ constexpr int vec_of() { return 16 / (int)sizeof(T); }

// A staged row of y_ph: the 16-byte chunks that cover the window's kCols
// columns u0 - 1 .. u0 + kTU, from u0 - V to u0 + kTU + V; window column w
// sits at staged column kYCol + w.
template <typename T>
struct YRow {
  static constexpr int V = vec_of<T>();
  static constexpr int kChunks = kTU / V + 2;
  static constexpr int kPitch = kChunks * V;
  static constexpr int kYCol = V - 1;
};

// A staged row of s (NHWC, raw): the 16-byte chunks that cover the window's
// kCols positions, C values each; position w, class c at shift + w C + c,
// where shift = (u0 - 1) C mod V is the same for every row and tile when
// Wh C is a multiple of V (0 when staged a value at a time).
template <typename T>
__host__ __device__ inline int s_shift(int C) { return (vec_of<T>() - C % vec_of<T>()) % vec_of<T>(); }
template <typename T>
__host__ __device__ inline int s_pitch(int C) {
  return (s_shift<T>(C) + kCols * C + vec_of<T>() - 1) / vec_of<T>() * vec_of<T>();
}

struct TileParams {
  const void* y;  // contiguous (B, 2, 2, C, Hh, Wh)
  const void* s;  // (B, Hh, Wh, C), dense NHWC (s_nhwc) or dense channel-leading
  int s_nhwc;
  int y_vec;      // y_ph staged by 16-byte cp.async copies (else a value at a time)
  int s_vec;      // s likewise (NHWC only)
  const float* w_up;  // (4, 4, C)
  const float* w_si;  // (3, 3, C)
  const float* mix;   // (C, C), [ci][co]
  const float* bias;  // (C,)
  float eps;
  void* out;          // contiguous (B, 2, 2, C, Hh, Wh), y's dtype
  int B, C, Hh, Wh;
  int y_bytes, s_bytes;                  // a stage's regions
  int off_s, off_w, off_m, off_b;        // byte offsets of the regions
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or (in == false) 16 zero bytes, src not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Waits for all but the newest copy group.
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

struct Tile {
  int b, j0, u0;
};

__device__ __forceinline__ Tile tile_of(int t, int Hh, int Wh) {
  const int tiles_u = (Wh + kTU - 1) / kTU, tiles_j = (Hh + kTJ - 1) / kTJ;
  const int rest = t / tiles_u;
  return Tile{rest / tiles_j, (rest % tiles_j) * kTJ, (t % tiles_u) * kTU};
}

// Starts the copies of tile t's windows of y_ph (all four phase planes and
// C classes) and of s into one stage: 16-byte cp.async copies, each wholly
// inside the map or zero filled, where the layout allows, else loads a
// value at a time (a zero past each edge). Commits one copy group.
template <typename T, int CMAX, bool kExact>
__device__ __forceinline__ void stage_tile(const TileParams& p, int t, T* Y, T* S, int C, int SP) {
  using R = YRow<T>;
  constexpr int V = vec_of<T>();
  const Tile tl = tile_of(t, p.Hh, p.Wh);
  const int Hh = p.Hh, Wh = p.Wh, HW = Hh * Wh;
  const T* y = static_cast<const T*>(p.y) + (long long)tl.b * 4 * C * HW;
  const T* s = static_cast<const T*>(p.s) + (long long)tl.b * HW * C;
  if (p.y_vec) {
    static_assert(kTileThreads % R::kChunks == 0, "a thread keeps its chunk column");
    constexpr int kStep = kTileThreads / R::kChunks;  // rows a pass
    const int ch = threadIdx.x % R::kChunks;
    const int gx = tl.u0 - V + ch * V;
    const bool in_x = (unsigned)gx < (unsigned)Wh;
    int row = threadIdx.x / R::kChunks, r = row % kRows, qc = row / kRows;
    const int rows = 4 * C * kRows;
    for (; row < rows; row += kStep) {
      const int gy = tl.j0 - 1 + r;
      const bool in = in_x && (unsigned)gy < (unsigned)Hh;
      cp_async16(Y + row * R::kPitch + ch * V, in ? y + qc * HW + gy * Wh + gx : y, in);
      r += kStep % kRows, qc += kStep / kRows;
      if (r >= kRows) r -= kRows, ++qc;
    }
  } else {
    const int n = 4 * C * kRows * kCols;
    for (int i = threadIdx.x; i < n; i += kTileThreads) {
      const int col = i % kCols, row = i / kCols;
      const int r = row % kRows, qc = row / kRows;
      const int gy = tl.j0 - 1 + r, gx = tl.u0 - 1 + col;
      const bool in = (unsigned)gy < (unsigned)Hh && (unsigned)gx < (unsigned)Wh;
      Y[row * R::kPitch + R::kYCol + col] = in ? y[qc * HW + gy * Wh + gx] : zero_of<T>();
    }
  }
  if (p.s_vec) {  // rows of kCols C values from (gy Wh + u0 - 1) C, in chunks from shift values before it
    const int chunks = SP / V, n = kRows * chunks, e_end = HW * C;
    for (int i = threadIdx.x; i < n; i += kTileThreads) {
      const int ch = i % chunks, r = i / chunks;
      const int gy = tl.j0 - 1 + r;
      const int e0 = (gy * Wh + tl.u0 - 1) * C - s_shift<T>(C) + ch * V;
      const bool in = (unsigned)gy < (unsigned)Hh && e0 >= 0 && e0 < e_end;
      cp_async16(S + r * SP + ch * V, in ? s + e0 : s, in);
    }
  } else {  // a position a thread, its C values at a stride of 1 (NHWC) or Hh Wh (channel-leading)
    const int cstride = p.s_nhwc ? 1 : HW;
    for (int i = threadIdx.x; i < kRows * kCols; i += kTileThreads) {
      const int col = i % kCols, r = i / kCols;
      const int gy = tl.j0 - 1 + r, gx = tl.u0 - 1 + col;
      const bool in = (unsigned)gy < (unsigned)Hh && (unsigned)gx < (unsigned)Wh;
      const T* sp = s + (p.s_nhwc ? (gy * Wh + gx) * C : gy * Wh + gx);
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (kExact || c < C) S[r * SP + col * C + c] = in ? sp[c * cstride] : zero_of<T>();
    }
  }
  cp_async_commit();
}

// A persistent block: the weights staged once, then tiles t = blockIdx.x,
// + gridDim.x, ... of kTJ x kTU half-resolution positions (all four phases
// and all classes of one image each), in two stages: the copies of the next
// tile land in one while the block computes the tile in the other. kExact:
// C == CMAX, the class loops unroll with no test of c < C. PG phases share a
// pass of the mix. At most 168 registers: two blocks an SM.
template <typename T, int CMAX, bool kExact, int PG>
__global__ void __launch_bounds__(kTileThreads, 2) septail_tile_kernel(const TileParams p) {
  using R = YRow<T>;
  constexpr int YP = R::kPitch, Y0 = R::kYCol;
  constexpr int CSMAX = (CMAX + 3) & ~3;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = kExact ? CMAX : p.C;
  const int CS = kExact ? CSMAX : (p.C + 3) & ~3;  // a row of the mix, padded to 16 bytes
  const int SP = s_pitch<T>(C);
  float* Wt = reinterpret_cast<float*>(smem + p.off_w);  // [C][kTaps]
  float* Mx = reinterpret_cast<float*>(smem + p.off_m);  // [C][CS]
  float* Bi = reinterpret_cast<float*>(smem + p.off_b);  // [CS]
  auto y_stage = [&](int k) { return reinterpret_cast<T*>(smem + k * p.y_bytes); };  // [2 * 2][C][kRows][YP]
  auto s_stage = [&](int k) { return reinterpret_cast<T*>(smem + p.off_s + k * p.s_bytes); };  // [kRows][SP]

  const int tid = threadIdx.x;
  const int tu = tid % kTU, tj = tid / kTU;
  const int Hh = p.Hh, Wh = p.Wh, HW = Hh * Wh;
  const int tiles = p.B * ((Hh + kTJ - 1) / kTJ) * ((Wh + kTU - 1) / kTU);
  const int shift = p.s_vec ? s_shift<T>(C) : 0;

  for (int i = tid; i < C * kTaps; i += kTileThreads) {
    const int c = i / kTaps, k = i % kTaps;
    Wt[i] = k < 16 ? p.w_up[k * C + c] : k < 25 ? p.w_si[(k - 16) * C + c] : 0.f;
  }
  for (int i = tid; i < C * CS; i += kTileThreads) {
    const int ci = i / CS, co = i % CS;
    Mx[i] = co < C ? p.mix[ci * C + co] : 0.f;
  }
  if (tid < CS) Bi[tid] = tid < C ? p.bias[tid] : 0.f;

  int t = blockIdx.x;
  stage_tile<T, CMAX, kExact>(p, t, y_stage(0), s_stage(0), C, SP);
  for (int k = 0; t < tiles; ++k, t += gridDim.x) {
    const int st = k & 1;
    if (t + (int)gridDim.x < tiles)
      stage_tile<T, CMAX, kExact>(p, t + gridDim.x, y_stage(st ^ 1), s_stage(st ^ 1), C, SP);
    else
      cp_async_commit();
    cp_async_wait_prior();  // this tile's copies, not the next one's
    __syncthreads();
    const Tile tl = tile_of(t, Hh, Wh);
    const T* Y = y_stage(st);
    T* S = s_stage(st);
    if (p.s_vec && (tl.u0 == 0 || tl.u0 + kTU + 1 > Wh)) {
      // s's chunks run on into the rows beside the map: zero the window's positions past its edges
      const int lo = tl.u0 == 0 ? 1 : 0, hi = Wh - tl.u0 + 1 < kCols ? Wh - tl.u0 + 1 : kCols;
      const int out_cols = lo + kCols - hi;
      for (int i = tid; i < kRows * out_cols * C; i += kTileThreads) {
        const int c = i % C, rest = i / C;
        const int oc = rest % out_cols, r = rest / out_cols;
        const int col = oc < lo ? 0 : hi + oc - lo;
        S[r * SP + shift + col * C + c] = zero_of<T>();
      }
      __syncthreads();
    }

    // The deconv and the stencil, a class at a time, for the four phases.
    // The window of y: full-resolution rows 2j - 1 + a and columns 2u - 1 + e
    // (a, e = 0..3) lie in plane (a + 1) & 1 at window row tj + ((a + 1) >> 1)
    // (the table above, with the halo's offset of one), columns alike; of s:
    // window rows tj..tj + 2 and positions tu..tu + 2 hold j - 1..j + 1 and
    // u - 1..u + 1.
    float acc[4][CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (kExact || c < C) {
        float w[kTaps];
        const float4* wq = reinterpret_cast<const float4*>(Wt + c * kTaps);
#pragma unroll
        for (int q = 0; q < kTaps / 4; ++q) {
          const float4 v = wq[q];
          w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z, w[4 * q + 3] = v.w;
        }
        float sw[3][3];
        const T* sc = S + tj * SP + shift + tu * C + c;
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int e = 0; e < 3; ++e) sw[r][e] = widen(sc[r * SP + e * C]);
        float yw[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = ((a + 1) & 1) * 2 + ((e + 1) & 1);
            yw[a][e] = widen(Y[((q * C + c) * kRows + tj + ((a + 1) >> 1)) * YP + Y0 + tu + ((e + 1) >> 1)]);
          }
        // the first form's order: the deconv's four taps, then the nine of the 3x3
#pragma unroll
        for (int ph = 0; ph < 2; ++ph)
#pragma unroll
          for (int pw = 0; pw < 2; ++pw) {
            float v = w[ph * 4 + pw] * sw[ph][pw];
            v = fmaf(w[ph * 4 + pw + 2], sw[ph][pw + 1], v);
            v = fmaf(w[(ph + 2) * 4 + pw], sw[ph + 1][pw], v);
            v = fmaf(w[(ph + 2) * 4 + pw + 2], sw[ph + 1][pw + 1], v);
#pragma unroll
            for (int dr = 0; dr < 3; ++dr)
#pragma unroll
              for (int dc = 0; dc < 3; ++dc) v = fmaf(w[16 + 3 * dr + dc], yw[ph + dr][pw + dc], v);
            acc[ph * 2 + pw][c] = v;
          }
      }
    }

    // The mix, PG phases a pass; the softmax; the blend and the store.
    T* out = static_cast<T*>(p.out) + (long long)tl.b * 4 * C * HW;
    const int j = tl.j0 + tj, u = tl.u0 + tu;
    const bool live = j < Hh && u < Wh;
    const int pix = j * Wh + u;
#pragma unroll
    for (int g = 0; g < 4; g += PG) {
      float l[PG][CMAX];
#pragma unroll
      for (int ci = 0; ci < CMAX; ++ci) {
        if (kExact || ci < C) {
          float m[CSMAX];
          const float4* mq = reinterpret_cast<const float4*>(Mx + ci * CS);
#pragma unroll
          for (int q = 0; q < CSMAX / 4; ++q) {
            if (kExact || 4 * q < C) {
              const float4 v = mq[q];
              m[4 * q] = v.x, m[4 * q + 1] = v.y, m[4 * q + 2] = v.z, m[4 * q + 3] = v.w;
            }
          }
#pragma unroll
          for (int pp = 0; pp < PG; ++pp)
#pragma unroll
            for (int co = 0; co < CMAX; ++co)
              if (kExact || co < C)
                l[pp][co] = ci == 0 ? acc[g + pp][0] * m[co] : fmaf(acc[g + pp][ci], m[co], l[pp][co]);
        }
      }
#pragma unroll
      for (int pp = 0; pp < PG; ++pp) {
        const int q = g + pp;
        float mx = -INFINITY;
#pragma unroll
        for (int co = 0; co < CMAX; ++co)
          if (kExact || co < C) {
            l[pp][co] += Bi[co];
            mx = fmaxf(mx, l[pp][co]);
          }
        const float mk = mx * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int co = 0; co < CMAX; ++co)
          if (kExact || co < C) {
            l[pp][co] = ex2(fmaf(l[pp][co], kLog2e, -mk));
            sum += l[pp][co];
          }
        const float inv = __frcp_rn(sum);
        if (live) {
#pragma unroll
          for (int co = 0; co < CMAX; ++co)
            if (kExact || co < C) {
              const float yc = widen(Y[((q * C + co) * kRows + tj + 1) * YP + Y0 + tu + 1]);
              store(out + (q * C + co) * HW + pix, yc - p.eps * (yc - l[pp][co] * inv));
            }
        }
      }
    }
    __syncthreads();  // the stage is free for the copies after the next
  }
}

inline int round_up(int x, int to) { return (x + to - 1) / to * to; }

// The shared regions of a launch of C classes of T (two stages); returns
// their sum.
template <typename T>
int tile_regions(TileParams& p, int C) {
  const int cs = round_up(C, 4);
  p.y_bytes = 4 * C * kRows * YRow<T>::kPitch * (int)sizeof(T);  // a multiple of 16
  p.s_bytes = round_up(kRows * s_pitch<T>(C) * (int)sizeof(T), 16);
  p.off_s = 2 * p.y_bytes;
  p.off_w = p.off_s + 2 * p.s_bytes;
  p.off_m = p.off_w + C * kTaps * 4;
  p.off_b = p.off_m + C * cs * 4;
  return p.off_b + cs * 4;
}

// Once an instance (one `configured` word each) a device: allow the most
// shared memory any launch of it asks for, and give the unified L1/shared
// memory to shared memory first.
template <typename K>
cudaError_t configure_once(K kernel, int most, std::atomic<unsigned long long>& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);  // one bit a device
  if (configured.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  configured.fetch_or(bit);
  return cudaSuccess;
}

// Launches one instance, a persistent grid of as many blocks as fit on the
// card at once (no more than the tiles), or (plan != nullptr) fills plan
// with what a launch would take: {1, threads, dynamic shared bytes, blocks
// an SM, registers, y_ph (16-byte aligned) staged by 16-byte copies for
// this Wh} and launches nothing.
template <typename T, int CMAX, bool kExact, int PG>
cudaError_t tiled(TileParams p, cudaStream_t stream, int* plan) {
  static std::atomic<unsigned long long> configured{0};
  const auto kernel = septail_tile_kernel<T, CMAX, kExact, PG>;
  TileParams most = p;
  cudaError_t err = configure_once(kernel, tile_regions<T>(most, CMAX), configured);
  if (err != cudaSuccess) return err;
  const int bytes = tile_regions<T>(p, p.C);
  constexpr int V = vec_of<T>();
  const auto aligned = [](const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; };
  p.y_vec = aligned(p.y) && p.Wh % V == 0;
  p.s_vec = p.s_nhwc && aligned(p.s) && p.Wh * p.C % V == 0;
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kTileThreads, bytes);
  if (err != cudaSuccess) return err;
  if (plan != nullptr) {
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    plan[0] = 1, plan[1] = kTileThreads, plan[2] = bytes, plan[3] = blocks, plan[4] = attr.numRegs, plan[5] = p.y_vec;
    return cudaSuccess;
  }
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)p.B * ((p.Hh + kTJ - 1) / kTJ) * ((p.Wh + kTU - 1) / kTU);
  const long long grid = tiles < (long long)blocks * sms ? tiles : (long long)blocks * sms;
  if (tiles >= 0x80000000LL || grid < 1) return cudaErrorInvalidValue;
  septail_tile_kernel<T, CMAX, kExact, PG><<<(unsigned)grid, kTileThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// CamVid's 11 classes unroll exactly; 1..16 run loops tested against the
// run-time C.
template <typename T>
cudaError_t tiled_c(const TileParams& p, cudaStream_t stream, int* plan) {
  if (p.C == 11) return tiled<T, 11, true, 4>(p, stream, plan);
  return tiled<T, kTileClasses, false, 1>(p, stream, plan);
}

}  // namespace

// dtype (y_ph, s and out): 0 = float32, 1 = bfloat16. y_ph's six and s's
// four strides are in elements; the weights are contiguous float32 on the
// card; out is a contiguous (B, 2, 2, C, Hh, Wh) tensor of y's dtype.
// 1 <= C <= 128 and B * 4 * Hh * Wh < 2^31. Up to 16 classes (the tiled
// form) y_ph must be contiguous and s dense NHWC or dense channel-leading,
// with the strides of those layouts and an image under 2^31 values; 17..128
// take any strides. Returns 0 or a CUDA error.
extern "C" int septail_step_launch(
    int dtype, int B, int C, int Hh, int Wh,
    const void* y, long long y_b, long long y_ph, long long y_pw, long long y_c, long long y_j, long long y_u,
    const void* s, long long s_b, long long s_h, long long s_w, long long s_c,
    const void* w_up, const void* w_si, const void* mix, const void* bias, float eps,
    void* out, void* stream) {
  if (C < 1 || C > kMaxClasses || B < 1 || Hh < 1 || Wh < 1) return (int)cudaErrorInvalidValue;
  const long long pixels = 4LL * B * Hh * Wh;
  if (pixels >= 0x80000000LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= kTileClasses) {
    const long long hw = (long long)Hh * Wh;
    if (4 * C * hw >= 0x80000000LL) return (int)cudaErrorInvalidValue;  // 32-bit offsets in an image
    if (y_u != 1 || y_j != Wh || y_c != hw || y_pw != C * hw || y_ph != 2 * C * hw || y_b != 4 * C * hw)
      return (int)cudaErrorInvalidValue;
    const bool nhwc = s_c == 1 && s_w == C && s_h == Wh * C && s_b == hw * C;
    const bool cl = s_w == 1 && s_h == Wh && s_c == hw && s_b == C * hw;
    if (!nhwc && !cl) return (int)cudaErrorInvalidValue;
    TileParams p{};
    p.y = y;
    p.s = s;
    p.s_nhwc = nhwc;
    p.w_up = static_cast<const float*>(w_up);
    p.w_si = static_cast<const float*>(w_si);
    p.mix = static_cast<const float*>(mix);
    p.bias = static_cast<const float*>(bias);
    p.eps = eps;
    p.out = out;
    p.B = B;
    p.C = C;
    p.Hh = Hh;
    p.Wh = Wh;
    if (dtype == 0) return (int)tiled_c<float>(p, st, nullptr);
    if (dtype == 1) return (int)tiled_c<__nv_bfloat16>(p, st, nullptr);
    return (int)cudaErrorInvalidValue;
  }
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
  if (dtype == 0) return (int)run<float, kMaxClasses>(p, st);
  if (dtype == 1) return (int)run<__nv_bfloat16, kMaxClasses>(p, st);
  return (int)cudaErrorInvalidValue;
}

// What a launch of C classes of dtype on a map of Wh columns (y_ph at a
// 16-byte aligned address) takes, launching nothing: plan[0..5] = {tiled
// form (1) or first form (0), threads a block, dynamic shared bytes a block,
// resident blocks an SM, registers a thread, y_ph staged by 16-byte copies}.
// Returns 0 or a CUDA error.
extern "C" int septail_step_plan(int dtype, int C, int Wh, int* plan) {
  if (C < 1 || C > kMaxClasses || Wh < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (C <= kTileClasses) {
    TileParams p{};
    p.y = nullptr;  // address 0: 16-byte aligned
    p.B = 1;
    p.C = C;
    p.Hh = 1;
    p.Wh = Wh;
    return (int)(dtype == 0 ? tiled_c<float>(p, nullptr, plan) : tiled_c<__nv_bfloat16>(p, nullptr, plan));
  }
  const auto kernel = dtype == 0 ? (const void*)septail_step_kernel<float, kMaxClasses, false>
                                  : (const void*)septail_step_kernel<__nv_bfloat16, kMaxClasses, false>;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  plan[0] = 0, plan[1] = kThreads, plan[2] = 0, plan[3] = blocks, plan[4] = attr.numRegs, plan[5] = 0;
  return 0;
}

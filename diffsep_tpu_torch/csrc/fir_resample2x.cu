// Factor-2 FIR resampling of NHWC tensors with a separable 4-tap filter:
//   down: decimation, upfirdn2d(x, outer(f, f), down=2, pad=(1, 1))
//   up:   interpolation, upfirdn2d(x, outer(f, f), up=2, pad=(2, 1))
// computed in f32, stored in the input's type. The taps arrive already
// flipped into convolution order.
//
// Replaces the Pallas TPU kernels diffsep_tpu/ops/pallas/upfirdn.py:94
// (_down_kernel) and upfirdn.py:130 (_up_kernel), launched by _resample2x.
// Like them it uses the polyphase form: a down output needs 4 x 4 input
// taps, a 2 x 2 quad of up outputs 3 x 3, and no zero-inserted intermediate
// is built. Unlike them it takes every shape NCSN++ calls it with, C = 6 and
// odd sizes included.
//
// What bounds it on the H100: bytes. It does 8-32 flops per output element
// against 2-4 bytes moved per element, far below the card's balance point,
// so the floor is reading the input once and writing the output once at
// the HBM rate.
//
// What the design does about it (variants chosen per shape by
// ops/fir_resample2x.py:plan_fir2x):
// - Data moves in its own type, 16 bytes per thread access: a thread owns 8
//   channels of bf16 (4 of f32), loads them with ld.global.nc.v4 or reads
//   them from a TMA box, widens them to f32 in registers only, and stores
//   its outputs with st.global.v4. Nothing is staged as f32.
// - Rows are reused in registers. A thread owns one column (down: an output
//   column; up: an input column, whose 2 x 2 output quads it forms) and
//   walks down a strip of rows. Each input row it reads is W-filtered once,
//   and the last two W-filtered rows stay in registers: down takes two new
//   input rows per output row, up one new input row per two output rows.
// - Loads run ahead of the arithmetic: the next rows' loads are issued
//   before the current ones are filtered ("stream"), or a ring of TMA stages
//   runs ahead of the block ("tma").
// - The padding costs no per-element branch: a column outside the image is
//   a predicate decided once per thread, a row outside it one per row, and
//   the predicated load yields zeros; TMA fills a box past the tensor's
//   edge (coordinates -1, H and W) with zeros itself.
// - Every index is decided once per thread from blockIdx and threadIdx, with
//   compile-time vector widths; the row loop only adds strides.
//
// Variants:
// "stream": a thread per (column, 16-byte channel vector, strip of rows),
//   the vector fastest, so a warp's accesses are contiguous.
// "direct": the same kernel one channel wide, for what 16-byte accesses
//   cannot take: C not a multiple of the vector (C = 6, 3), or a base
//   pointer that is not 16-byte aligned.
// "tma": bf16, C % 64 == 0. A block of 8 x TW threads owns TW columns x 64
//   channels (128 bytes) and a strip of rows. One thread issues 4-D TMA
//   boxes (64 channels x the columns with their halo x 2 input rows for
//   down, 1 for up) into a ring of mbarrier-guarded stages; each thread
//   reads its 16-byte vectors from shared memory, so the halo columns that
//   neighbouring threads share cross from L2 once.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

// The C entry point's argument block; mirrors ops/fir_resample2x.py _Args.
// It stays outside the unnamed namespace: a parameter type with internal
// linkage would give the entry point internal linkage too.
struct Args {
  int B, H, W, C, Ho, Wo;
  int up, dtype, variant, rows, cols, stages, threads, smem_bytes;
  int grid[3];
  float ky[4], kx[4];
  int device;
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // a "stream" or "direct" block
constexpr int TMA_C = 64;     // channels of a "tma" block: 128 bytes of bf16
constexpr int SMEM_LIMIT = 232448;

struct Taps {
  float y[4], x[4];
};

struct Shape {
  int B, H, W, C, Ho, Wo;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// V consecutive channels of T: their bits as one load moves them (Raw), and
// their values in f32 registers.
template <typename T, int V> struct Io;

template <> struct Io<bf16, 8> {
  typedef uint4 Raw;
  static __device__ __forceinline__ Raw load(const bf16* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                                              pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
};

template <> struct Io<float, 4> {
  typedef float4 Raw;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <> struct Io<bf16, 1> {
  typedef unsigned short Raw;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) { f[0] = __uint_as_float((uint32_t)r << 16); }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[1]) {
    *reinterpret_cast<unsigned short*>(p) = __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  }
};

template <> struct Io<float, 1> {
  typedef float Raw;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) { f[0] = r; }
  static __device__ __forceinline__ void store(float* p, const float (&f)[1]) { *p = f[0]; }
};

// W pass of one input row. Down: h = sum_q kx[q] x[2j - 1 + q] from the 4
// columns r[0..3]. Up: the quad's even and odd output columns,
// e = kx[0] x[j - 1] + kx[2] x[j], o = kx[1] x[j] + kx[3] x[j + 1], from the
// 3 columns r[0..2].
template <typename T, int V>
__device__ __forceinline__ void w_down(const typename Io<T, V>::Raw (&r)[4], const Taps& k, float (&h)[V]) {
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) h[i] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    Io<T, V>::unpack(r[q], v);
#pragma unroll
    for (int i = 0; i < V; ++i) h[i] = fmaf(k.x[q], v[i], h[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void w_up(const typename Io<T, V>::Raw (&r)[3], const Taps& k, float (&e)[V], float (&o)[V]) {
  float a[V], b[V], c[V];
  Io<T, V>::unpack(r[0], a);
  Io<T, V>::unpack(r[1], b);
  Io<T, V>::unpack(r[2], c);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    e[i] = fmaf(k.x[2], b[i], k.x[0] * a[i]);
    o[i] = fmaf(k.x[3], c[i], k.x[1] * b[i]);
  }
}

// H pass. Down: output row oi from the W-filtered input rows 2 oi - 1 ..
// 2 oi + 2. Up: y = ky[p] h_a + ky[p + 2] h_b, rows 2a (p = 0: h_a, h_b =
// rows a - 1, a) and 2a + 1 (p = 1: rows a, a + 1).
template <int V>
__device__ __forceinline__ void h_down(const float (&h0)[V], const float (&h1)[V], const float (&h2)[V],
                                       const float (&h3)[V], const Taps& k, float (&y)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) y[i] = fmaf(k.y[3], h3[i], fmaf(k.y[2], h2[i], fmaf(k.y[1], h1[i], k.y[0] * h0[i])));
}

template <int V>
__device__ __forceinline__ void h_up(const float (&ha)[V], const float (&hb)[V], float ka, float kb, float (&y)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) y[i] = fmaf(kb, hb[i], ka * ha[i]);
}

template <int V>
__device__ __forceinline__ void assign(float (&dst)[V], const float (&src)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i] = src[i];
}

// Row `row` of a thread's N columns: off[q] is column q's offset in a row and
// inside[q] whether it lies in the image (both decided once per thread). A
// row or column outside the image loads nothing and reads as zeros.
template <typename T, int V, int N>
__device__ __forceinline__ void load_row(typename Io<T, V>::Raw (&r)[N], const T* x_b, size_t row_stride, int row,
                                         int H, const int (&off)[N], const bool (&inside)[N]) {
  const bool row_in = (unsigned)row < (unsigned)H;
  const T* p = x_b + (row_in ? row : 0) * row_stride;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    r[q] = typename Io<T, V>::Raw{};
    if (row_in && inside[q]) r[q] = Io<T, V>::load(p + off[q]);
  }
}

template <typename T, int V, int N>
__device__ __forceinline__ void copy_raw(typename Io<T, V>::Raw (&dst)[N], const typename Io<T, V>::Raw (&src)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) dst[q] = src[q];
}

// "stream" (V = 16 bytes of T) and "direct" (V = 1). Thread t is (batch,
// strip, column, vector), the vector fastest; a strip is `rows` steps:
// output rows for down, input rows (two output rows each) for up.
template <typename T, int V, bool UP>
__global__ void __launch_bounds__(THREADS)
fir2x_stream_kernel(const T* __restrict__ x, T* __restrict__ out, Shape s, Taps k, int rows, int strips) {
  typedef typename Io<T, V>::Raw Raw;
  constexpr int N = UP ? 3 : 4;  // input columns of a thread
  const int groups = s.C / V, cols = UP ? s.W : s.Wo, steps = UP ? s.H : s.Ho;
  unsigned t = blockIdx.x * THREADS + threadIdx.x;
  const int g = t % groups;
  t /= groups;
  const int j = t % cols;
  t /= cols;
  const int strip = t % strips, b = t / strips;
  if (b >= s.B) return;
  const int r0 = strip * rows, r1 = min(r0 + rows, steps);
  const size_t row_stride = (size_t)s.W * s.C, out_row = (size_t)s.Wo * s.C;
  const T* x_b = x + (size_t)b * s.H * row_stride + g * V;
  int off[N];
  bool inside[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int c = UP ? j - 1 + q : 2 * j - 1 + q;
    inside[q] = c >= 0 && c < s.W;
    off[q] = inside[q] ? c * s.C : 0;
  }
  if constexpr (!UP) {
    T* o = out + ((size_t)b * s.Ho + r0) * out_row + (size_t)j * s.C + g * V;
    Raw a[N], c[N], na[N], nc[N];  // the rows being filtered, the next two in flight
    load_row<T, V, N>(a, x_b, row_stride, 2 * r0 - 1, s.H, off, inside);
    load_row<T, V, N>(c, x_b, row_stride, 2 * r0, s.H, off, inside);
    load_row<T, V, N>(na, x_b, row_stride, 2 * r0 + 1, s.H, off, inside);
    load_row<T, V, N>(nc, x_b, row_stride, 2 * r0 + 2, s.H, off, inside);
    float h0[V], h1[V], h2[V], h3[V], y[V];  // W-filtered rows 2 oi - 1 .. 2 oi + 2
    w_down<T, V>(a, k, h0);
    w_down<T, V>(c, k, h1);
    for (int oi = r0; oi < r1; ++oi, o += out_row) {
      copy_raw<T, V, N>(a, na);
      copy_raw<T, V, N>(c, nc);
      if (oi + 1 < r1) {
        load_row<T, V, N>(na, x_b, row_stride, 2 * oi + 3, s.H, off, inside);
        load_row<T, V, N>(nc, x_b, row_stride, 2 * oi + 4, s.H, off, inside);
      }
      w_down<T, V>(a, k, h2);
      w_down<T, V>(c, k, h3);
      h_down<V>(h0, h1, h2, h3, k, y);
      Io<T, V>::store(o, y);
      assign<V>(h0, h2);
      assign<V>(h1, h3);
    }
  } else {
    T* o = out + ((size_t)b * s.Ho + 2 * r0) * out_row + (size_t)2 * j * s.C + g * V;
    Raw a[N], na[N];
    load_row<T, V, N>(a, x_b, row_stride, r0 - 1, s.H, off, inside);
    load_row<T, V, N>(na, x_b, row_stride, r0, s.H, off, inside);
    float e0[V], o0[V], e1[V], o1[V], e2[V], o2[V], y[V];  // W-filtered rows a - 1, a, a + 1
    w_up<T, V>(a, k, e0, o0);
    w_up<T, V>(na, k, e1, o1);
    load_row<T, V, N>(na, x_b, row_stride, r0 + 1, s.H, off, inside);
    for (int r = r0; r < r1; ++r, o += 2 * out_row) {
      copy_raw<T, V, N>(a, na);
      if (r + 1 < r1) load_row<T, V, N>(na, x_b, row_stride, r + 2, s.H, off, inside);
      w_up<T, V>(a, k, e2, o2);
      h_up<V>(e0, e1, k.y[0], k.y[2], y);
      Io<T, V>::store(o, y);
      h_up<V>(o0, o1, k.y[0], k.y[2], y);
      Io<T, V>::store(o + s.C, y);
      h_up<V>(e1, e2, k.y[1], k.y[3], y);
      Io<T, V>::store(o + out_row, y);
      h_up<V>(o1, o2, k.y[1], k.y[3], y);
      Io<T, V>::store(o + out_row + s.C, y);
      assign<V>(e0, e1);
      assign<V>(o0, o1);
      assign<V>(e1, e2);
      assign<V>(o1, o2);
    }
  }
}

// "tma": a box holds 64 channels x box_cols columns x BOX_ROWS rows, one
// 128-byte line per (row, column).
__host__ __device__ constexpr int tma_box_cols(bool up, int tw) { return up ? tw + 2 : 2 * tw + 2; }
__host__ __device__ constexpr int tma_box_bytes(bool up, int tw) { return tma_box_cols(up, tw) * (up ? 1 : 2) * 128; }
// the ring, one mbarrier per stage, and slack to align the ring to 128 bytes
__host__ __device__ constexpr int tma_smem_bytes(bool up, int tw, int stages) {
  return 128 + stages * (tma_box_bytes(up, tw) + 8);
}

// Block (x, y, z) = (TW-column tile, strip, batch x 64-channel chunk); thread
// (jl, g) = (tid / 8, tid % 8) owns column x * TW + jl and channels
// chunk + 8 g .. 8 g + 7. Box i of the strip holds input rows 2 (r0 + i) - 1
// and 2 (r0 + i) (down) or row r0 - 1 + i (up). After every thread has read
// box i from its stage (a block barrier), thread 0 refills that stage with
// box i + stages.
template <bool UP>
__global__ void __launch_bounds__(256)
fir2x_tma_kernel(const __grid_constant__ CUtensorMap x_map, bf16* __restrict__ out, Shape s, Taps k, int rows,
                 int stages) {
  typedef Io<bf16, 8> io;
  constexpr int N = UP ? 3 : 4, BOX_ROWS = UP ? 1 : 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw), base = (raw + 127u) & ~127u;
  const int tid = threadIdx.x, tw = blockDim.x >> 3, g = tid & 7, jl = tid >> 3;
  const int box_cols = tma_box_cols(UP, tw), box_bytes = tma_box_bytes(UP, tw);
  const uint32_t full = base + stages * box_bytes;
  const int chunks = s.C / TMA_C, b = blockIdx.z / chunks, c0 = (blockIdx.z - b * chunks) * TMA_C;
  const int j = blockIdx.x * tw + jl, col0 = UP ? blockIdx.x * tw - 1 : 2 * blockIdx.x * tw - 1;
  const int steps = UP ? s.H : s.Ho, r0 = blockIdx.y * rows, r1 = min(r0 + rows, steps);
  const int boxes = r1 - r0 + (UP ? 2 : 1);
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) hopper::mbarrier_init(full + i * 8, 1);
    hopper::fence_mbarrier_init();
    for (int i = 0; i < stages && i < boxes; ++i) {
      hopper::mbarrier_expect_tx(full + i * 8, box_bytes);
      hopper::tma_load_4d(base + i * box_bytes, &x_map, full + i * 8, c0, col0, UP ? r0 - 1 + i : 2 * (r0 + i) - 1, b);
    }
  }
  __syncthreads();

  // this thread's first vector in a stage: column 2 jl (down) or jl (up) of the box
  const uint8_t* mine = smem_raw + (base - raw) + (UP ? jl : 2 * jl) * 128 + g * 16;
  int st = 0;
  uint32_t parity = 0;
  // Box i into r: wait for its stage, read, then let thread 0 refill the stage.
  auto next_box = [&](int i, uint4 (&r)[BOX_ROWS][N]) {
    hopper::mbarrier_wait(full + st * 8, parity);
    const uint8_t* p = mine + st * box_bytes;
#pragma unroll
    for (int rr = 0; rr < BOX_ROWS; ++rr)
#pragma unroll
      for (int q = 0; q < N; ++q) r[rr][q] = *reinterpret_cast<const uint4*>(p + (rr * box_cols + q) * 128);
    __syncthreads();
    const int refill = i + stages;
    if (tid == 0 && refill < boxes) {
      // The block's reads of this stage went through the generic proxy and
      // the refill writes through the async proxy: the block barrier alone
      // does not order the two (without this fence, large "up" calls read
      // boxes already overwritten by the next refill).
      hopper::fence_proxy_async();
      const uint32_t bar = full + st * 8;
      hopper::mbarrier_expect_tx(bar, box_bytes);
      hopper::tma_load_4d(base + st * box_bytes, &x_map, bar, c0, col0, UP ? r0 - 1 + refill : 2 * (r0 + refill) - 1, b);
    }
    if (++st == stages) {
      st = 0;
      parity ^= 1u;
    }
  };

  const size_t out_row = (size_t)s.Wo * s.C;
  uint4 r[BOX_ROWS][N];
  if constexpr (!UP) {
    const bool valid = j < s.Wo;  // the last tile's columns past the image compute but do not store
    bf16* o = out + ((size_t)b * s.Ho + r0) * out_row + (size_t)j * s.C + c0 + g * 8;
    float h0[8], h1[8], h2[8], h3[8], y[8];
    next_box(0, r);
    w_down<bf16, 8>(r[0], k, h0);
    w_down<bf16, 8>(r[1], k, h1);
    for (int i = 1; i < boxes; ++i, o += out_row) {
      next_box(i, r);
      w_down<bf16, 8>(r[0], k, h2);
      w_down<bf16, 8>(r[1], k, h3);
      h_down<8>(h0, h1, h2, h3, k, y);
      if (valid) io::store(o, y);
      assign<8>(h0, h2);
      assign<8>(h1, h3);
    }
  } else {
    const bool valid = j < s.W;
    bf16* o = out + ((size_t)b * s.Ho + 2 * r0) * out_row + (size_t)2 * j * s.C + c0 + g * 8;
    float e0[8], o0[8], e1[8], o1[8], e2[8], o2[8], y[8];
    next_box(0, r);
    w_up<bf16, 8>(r[0], k, e0, o0);
    next_box(1, r);
    w_up<bf16, 8>(r[0], k, e1, o1);
    for (int i = 2; i < boxes; ++i, o += 2 * out_row) {
      next_box(i, r);
      w_up<bf16, 8>(r[0], k, e2, o2);
      if (valid) {
        h_up<8>(e0, e1, k.y[0], k.y[2], y);
        io::store(o, y);
        h_up<8>(o0, o1, k.y[0], k.y[2], y);
        io::store(o + s.C, y);
        h_up<8>(e1, e2, k.y[1], k.y[3], y);
        io::store(o + out_row, y);
        h_up<8>(o1, o2, k.y[1], k.y[3], y);
        io::store(o + out_row + s.C, y);
      }
      assign<8>(e0, e1);
      assign<8>(o0, o1);
      assign<8>(e1, e2);
      assign<8>(o1, o2);
    }
  }
}

enum Variant { DIRECT = 0, STREAM = 1, TMA = 2 };

template <typename T, int V, bool UP>
cudaError_t launch_stream(const void* x, void* out, const Args& a, const Shape& s, const Taps& k, cudaStream_t stream) {
  const int steps = UP ? s.H : s.Ho, cols = UP ? s.W : s.Wo;
  if (a.rows < 1 || s.C % V || a.threads != THREADS) return cudaErrorInvalidValue;
  const int strips = (steps + a.rows - 1) / a.rows;
  const long long threads = (long long)s.B * strips * cols * (s.C / V);
  if (threads >= (1ll << 31) || (long long)a.grid[0] * THREADS < threads) return cudaErrorInvalidValue;
  fir2x_stream_kernel<T, V, UP><<<a.grid[0], THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), s,
                                                                     k, a.rows, strips);
  return cudaGetLastError();
}

template <bool UP>
cudaError_t launch_tma(const void* x, void* out, const Args& a, const Shape& s, const Taps& k, cudaStream_t stream) {
  auto kernel = fir2x_tma_kernel<UP>;
  if (a.smem_bytes > 48 * 1024) {  // once per instantiation, where a ring needs more than the default
    static const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (attr != cudaSuccess) return attr;
  }
  const int tw = a.cols, steps = UP ? s.H : s.Ho, cols = UP ? s.W : s.Wo;
  if (s.C % TMA_C || tw < 1 || tw > 32 || a.threads != 8 * tw || a.rows < 1 || a.stages < 1 ||
      a.smem_bytes != tma_smem_bytes(UP, tw, a.stages) || a.smem_bytes > SMEM_LIMIT ||
      a.grid[0] != (cols + tw - 1) / tw || a.grid[1] != (steps + a.rows - 1) / a.rows || a.grid[2] != s.B * (s.C / TMA_C))
    return cudaErrorInvalidValue;
  // x as (B, H, W, C), innermost first
  const cuuint64_t dims[4] = {(cuuint64_t)s.C, (cuuint64_t)s.W, (cuuint64_t)s.H, (cuuint64_t)s.B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.C * 2, (cuuint64_t)s.W * s.C * 2, (cuuint64_t)s.H * s.W * s.C * 2};
  const cuuint32_t box[4] = {TMA_C, (cuuint32_t)tma_box_cols(UP, tw), UP ? 1u : 2u, 1};
  CUtensorMap map;
  if (!hopper::encode_bf16_map(&map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE)) return cudaErrorInvalidValue;
  kernel<<<dim3(a.grid[0], a.grid[1], a.grid[2]), a.threads, a.smem_bytes, stream>>>(map, static_cast<bf16*>(out), s, k,
                                                                                       a.rows, a.stages);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, void* out, const Args& a, cudaStream_t stream) {
  const Shape s = {a.B, a.H, a.W, a.C, a.Ho, a.Wo};
  const Taps k = {{a.ky[0], a.ky[1], a.ky[2], a.ky[3]}, {a.kx[0], a.kx[1], a.kx[2], a.kx[3]}};
  const bool up = a.up != 0;
  if (a.Ho != (up ? 2 * a.H : a.H / 2) || a.Wo != (up ? 2 * a.W : a.W / 2)) return cudaErrorInvalidValue;
  if (a.variant != DIRECT && ((uintptr_t)x | (uintptr_t)out) % 16) return cudaErrorMisalignedAddress;
  if (a.variant == TMA && a.dtype == 1)
    return up ? launch_tma<true>(x, out, a, s, k, stream) : launch_tma<false>(x, out, a, s, k, stream);
  if (a.variant == STREAM && a.dtype == 0)
    return up ? launch_stream<float, 4, true>(x, out, a, s, k, stream)
              : launch_stream<float, 4, false>(x, out, a, s, k, stream);
  if (a.variant == STREAM && a.dtype == 1)
    return up ? launch_stream<bf16, 8, true>(x, out, a, s, k, stream)
              : launch_stream<bf16, 8, false>(x, out, a, s, k, stream);
  if (a.variant == DIRECT && a.dtype == 0)
    return up ? launch_stream<float, 1, true>(x, out, a, s, k, stream)
              : launch_stream<float, 1, false>(x, out, a, s, k, stream);
  if (a.variant == DIRECT && a.dtype == 1)
    return up ? launch_stream<bf16, 1, true>(x, out, a, s, k, stream)
              : launch_stream<bf16, 1, false>(x, out, a, s, k, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (B, H, W, C) contiguous; out: (B, Ho, Wo, C). `a` holds the shape, the
// direction (up: 0 = decimate, 1 = interpolate), dtype (0 = float32,
// 1 = bfloat16), the plan of ops/fir_resample2x.py:plan_fir2x and the 4 taps
// per axis in convolution order. Returns the cudaError_t of the launch.
extern "C" int fir_resample2x_nhwc(const void* x, void* out, const Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear an earlier error so the one returned is ours
  return (int)launch(x, out, *a, static_cast<cudaStream_t>(stream));
}

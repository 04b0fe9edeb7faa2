// 3x3 stride-1 SAME convolution, NHWC input x HWIO weight -> NHWC output,
// f32 accumulation, optional bias, output in the input's type.
//
// Replaces the Pallas TPU kernel diffsep_tpu/ops/pallas/conv3x3.py
// (_conv_kernel, "slices", and _conv_kernel_im2col, launched by
// _conv3x3_pallas_jit): both compute this one function, the first as nine
// shifted (rows, Cin) @ (Cin, Cout) products, the second as one product of
// depth K = 9 * Cin. This kernel is the second form as an implicit GEMM:
//   M = B * H * W output pixels, N = Cout, K = 9 * Cin,
//   A[m, k] = x[b, h + k / Cin / 3 - 1, w + k / Cin % 3 - 1, k % Cin]
//   (zero outside the image), B[k, n] = weight[k / Cin][k % Cin][n].
//
// What bounds it on the H100: operations. At the NCSN++ shapes (Cin, Cout
// 128-512) a pixel's 9 * Cin * Cout multiply-adds are ~200-600 per byte of
// activation moved, above the card's ~295 FLOP/byte balance point for bf16,
// so the tensor cores, not HBM, set the floor; the stem (Cin = 6), the
// output convs (Cout = 6) and the narrow models' 32 and 96 channels (nf 32)
// are bound by bytes.
//
// The bf16 designs, chosen per shape by ops/conv3x3.py:plan_conv3x3 and
// dispatched here by (variant, BM, BN, stages). Those of Cin % 64 == 0
// (1-3) walk K as (tap, 64-channel slice), so one A row of a slice is 64
// contiguous channels of one neighbour pixel (128 bytes), and multiply with
// wgmma (m64nBNk16) from operands in the 128-byte swizzle (the weight
// MN-major through the transpose flag, or K-major in the narrow kernels'
// resident copy), f32 accumulators in registers; the epilogue adds the
// bias and rounds once to bf16 from registers.
//
// 1. "tma" (Cin % 64 == 0, Cout % 128 == 0, from 512 output pixels up where
//    the patches waste little: the levels from 32 x 40 up). The tile is a
//    patch of 8 x 16 or 16 x 16 output pixels; a producer warpgroup brings
//    each slice's A as one TMA box at the tap's offset, zero-filled past
//    the image (the SAME padding), and B as 64 x 64 boxes, into a ring of
//    mbarrier-guarded stages that two consumer warpgroups multiply. See
//    conv3x3_tma_kernel.
// 2. "wgmma" (Cin % 64 == 0, Cout % 64 == 0, elsewhere). A row of a slice
//    is eight 16-byte cp.async from every thread, zero-filled by the copy
//    itself (src-size 0) at the halo and past the last pixel; A (BM x 64)
//    and B (64 x BN) go through a ring of STAGES >= 3 buffers, loads
//    running STAGES - 2 slices ahead while one wgmma group is in flight.
// 3. "narrow" (Cout < 64, Cin % 64 == 0: the output convs, Cout = 6). The
//    "wgmma" loop with an 8-wide N tile (wgmma n = 8, padded columns not
//    stored); the block's whole range of the weight is made K-major in
//    shared memory once, so the ring streams A alone. These are bound by
//    bytes. "tma_narrow" serves the large levels: see its kernel.
//
// The float32 design:
//
// 4. "tf32x3" (f32, Cin % 32 == 0, Cout % 64 == 0: every trunk conv; and
//    with an 8-wide N tile, as "narrow", the output convs, Cout < 64). The
//    "wgmma" loop over (tap, 32-channel slice), whose rows are again 128
//    bytes, on the tensor cores in TF32 with split operands, so that the
//    result keeps float32 accuracy: each operand v is hi = tf32(v) plus
//    lo = tf32(v - hi), and the products hi.hi + hi.lo + lo.hi (lo.lo is
//    below 2^-22 of the product) go into f32 accumulators. One TF32 pass
//    alone keeps ~3 decimal digits. tf32 wgmma reads both operands K-major
//    only, so the weight is made K-major, split and laid out for the
//    kernel by a pass of its own (conv3x3_tf32_split_weight, cached by the
//    wrapper per weight version); A comes from registers: each consumer
//    thread loads its rows of the staged slice, splits them and issues
//    three wgmma (m64nBNk8) per k8 step. See conv3x3_tf32x3_kernel. Bound
//    by operations: three TF32 products at 495 TFLOP/s give 165 TFLOP/s of
//    float32 work, against 67 on the CUDA cores; next, the bytes every
//    block takes from L2 (its A rows nine times, the split weight's hi and
//    lo once), which 192-row tiles spread over more rows.
//
// 5. "slice32" (bf16, Cin % 32 == 0 and Cin % 64 != 0: the learning
//    demos' nf 32 NCSN++; Cout a multiple of 32, or < 64). Bound by bytes.
//    K walks (tap, 32-channel slice), rows of 64 bytes in the 64-byte
//    swizzle; the block's Cout tile of the weight stays in shared memory;
//    persistent blocks walk patches of 8 x 16 or 16 x 16 output pixels, fed
//    by TMA (one box per slice and column offset, serving three taps as
//    wgmma operands in shared memory), each consumer warpgroup taking whole
//    patches from a ring of its own; the output leaves by TMA stores. See
//    conv3x3_slice32_kernel.
//
// Split-K (grid z = S > 1, "tma", "wgmma", "narrow" and "tf32x3") serves the
// deep levels, where M-tiles x N-tiles is far below the 132 SMs: split z
// walks its own range of the (tap, slice) walk and writes an f32 partial
// tile; a second pass (conv3x3_splitk_reduce) sums the S partials in a
// fixed order, adds the bias and rounds to the output's type. No atomics,
// so the result is bitwise deterministic.
//
// The float32 backward. dx is this file's forward conv of dy with the
// weight flipped and transposed (conv3x3_tf32_split_weight makes its split
// operand with `flip`). dw, the weight gradient, is a kernel of its own
// (conv3x3_dw_tf32x3_kernel, conv3x3_dw_window_kernel for a side of 8
// channels or fewer, conv3x3_dw_f32_kernel; entry conv3x3_dw): see its note
// below.
//
// "generic" (f32 outside "tf32x3": Cin = 6, Cout = 6, other channel counts;
// bf16 with Cin not a multiple of 32, as the stem's Cin = 6, or with Cout
// >= 64 off the N tiles; operands not 16-byte aligned): each block computes
// a 64 x 64 output tile
// and walks K in slices of 32, gathering A straight from the unpadded input
// with predicated loads (no padded copy). bf16 runs on the tensor cores
// through WMMA (16x16x16 mma.sync tiles, four warps of 2x2 tiles each); f32
// on the CUDA cores with a 4x8 register tile per thread, so that an f32
// call keeps full f32 products. Flattening K over (tap, channel) lets
// Cin = 6 use 54 of each 64 reduction lanes.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;  // output pixels per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 32;  // slice of the reduction K = 9 * Cin
constexpr int THREADS = 128;

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
// Two neighbouring outputs, rounded once to the output's type.
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Shape {
  int B, H, W, Cin, Cout, M, K;
};

// Pixel coordinates of the block's BM output rows; b = -1 past the end.
__device__ __forceinline__ void tile_pixels(const Shape& s, int m0, int* rb, int* rh, int* rw) {
  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    const int m = m0 + i;
    if (m < s.M) {
      rw[i] = m % s.W;
      const int t = m / s.W;
      rh[i] = t % s.H;
      rb[i] = t / s.H;
    } else {
      rb[i] = -1;
      rh[i] = 0;
      rw[i] = 0;
    }
  }
}

// One thread's view of one reduction column k of the A slice: the tap offset
// and the channel, or an invalid column past K.
struct KCol {
  int dy, dx, c;
  bool valid;
};

__device__ __forceinline__ KCol k_column(const Shape& s, int k) {
  KCol col;
  col.valid = k < s.K;
  const int tap = col.valid ? k / s.Cin : 0;
  col.c = k - tap * s.Cin;
  col.dy = tap / 3 - 1;
  col.dx = tap % 3 - 1;
  return col;
}

template <typename T>
__device__ __forceinline__ T gather_a(const T* __restrict__ x, const Shape& s, const KCol& col,
                                      int b, int h, int w) {
  const int hh = h + col.dy, ww = w + col.dx;
  if (!col.valid || b < 0 || hh < 0 || hh >= s.H || ww < 0 || ww >= s.W) return from_f32<T>(0.f);
  return x[((size_t)(b * s.H + hh) * s.W + ww) * s.Cin + col.c];
}

template <typename T>
__device__ __forceinline__ T load_b(const T* __restrict__ w, const Shape& s, int k, int n) {
  if (k >= s.K || n >= s.Cout) return from_f32<T>(0.f);
  return w[(size_t)k * s.Cout + n];
}

// f32: CUDA cores, 16 x 8 threads each holding a 4 x 8 accumulator tile.
__global__ void __launch_bounds__(THREADS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, Shape s) {
  __shared__ float As[BK][BM + 1];  // transposed: As[k][m]
  __shared__ float Bs[BK][BN];
  __shared__ int rb[BM], rh[BM], rw[BM];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  tile_pixels(s, m0, rb, rh, rw);
  __syncthreads();

  const int tx = tid % 8, ty = tid / 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s.K; k0 += BK) {
    const int kl = tid % BK;
    const KCol col = k_column(s, k0 + kl);
#pragma unroll 4
    for (int ml = tid / BK; ml < BM; ml += THREADS / BK)
      As[kl][ml] = gather_a(x, s, col, rb[ml], rh[ml], rw[ml]);
#pragma unroll 4
    for (int e = tid; e < BK * BN; e += THREADS)
      Bs[e / BN][e % BN] = load_b(w, s, k0 + e / BN, n0 + e % BN);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= s.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n < s.Cout) out[(size_t)m * s.Cout + n] = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

// bf16, generic: tensor cores through WMMA. Four warps in a 2 x 2 grid, each owning
// a 32 x 32 quarter of the tile as 2 x 2 fragments of 16 x 16.
__global__ void __launch_bounds__(THREADS)
conv3x3_bf16_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, bf16* __restrict__ out, Shape s) {
  using namespace nvcuda;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  __shared__ __align__(128) bf16 As[BM * LDA];  // row-major [m][k]
  __shared__ __align__(128) bf16 Bs[BK * LDB];  // row-major [k][n]
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ int rb[BM], rh[BM], rw[BM];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  tile_pixels(s, m0, rb, rh, rw);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < s.K; k0 += BK) {
    const int kl = tid % BK;
    const KCol col = k_column(s, k0 + kl);
#pragma unroll 4
    for (int ml = tid / BK; ml < BM; ml += THREADS / BK)
      As[ml * LDA + kl] = gather_a(x, s, col, rb[ml], rh[ml], rw[ml]);
#pragma unroll 4
    for (int e = tid; e < BK * BN; e += THREADS)
      Bs[(e / BN) * LDB + e % BN] = load_b(w, s, k0 + e / BN, n0 + e % BN);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int ml = e / BN, nl = e % BN;
    const int m = m0 + ml, n = n0 + nl;
    if (m < s.M && n < s.Cout)
      out[(size_t)m * s.Cout + n] = __float2bfloat16(Cs[ml * LDC + nl] + (bias ? __bfloat162float(bias[n]) : 0.f));
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: wgmma implicit GEMM over (tap, 64-channel slice).

constexpr int A_ROW_BYTES = 128;   // 64 bf16 channels of one pixel
constexpr int SLICE = 64;          // channels per K slice
constexpr int NB_BYTES = 64 * 128; // one 64-column block of a B slice (64 k-rows)

// Shared memory of one instantiation: the A ring, then the B ring (wgmma)
// or the resident K-major weight of up to `max_slices` slices (narrow), plus
// slack to align the start to 1024 bytes (the swizzle atom).
__host__ __device__ constexpr size_t wgmma_smem_bytes(int nwg, int bn, int stages, bool narrow,
                                                      int max_slices) {
  return 1024 + (size_t)stages * nwg * 64 * A_ROW_BYTES +
         (narrow ? (size_t)max_slices * 1024 : (size_t)stages * bn * 128);
}

// acc (64 x BN) += the warpgroup's A rows of one slice (64 x 64, K-major, at
// a_tile) times the slice's B (64 x BN, MN-major: BN / 64 blocks of 64
// k-rows x 128 bytes, at b_tile), both in the 128-byte swizzle.
template <int BN>
__device__ __forceinline__ void mma_slice(float (&acc)[BN / 2], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < SLICE / 16; ++kk)
    hopper::wgmma_m64k16<1>(acc, hopper::desc_sw128(a_tile + kk * 32, 16, 1024),
                            hopper::desc_sw128(b_tile + kk * 16 * 128, NB_BYTES, 1024));
}

// Epilogue of the wgmma kernels: this thread's accumulators (m64nBN layout:
// register 4 q + 2 h + e is output row rows[h], column n0 + 8 q + 2 (lane %
// 4) + e) to the output, plus bias and rounded to T, or, when split, to
// split blockIdx.z's f32 partial. rows[h] < 0: no such output row.
template <int BN, bool NARROW, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], const int (&rows)[2], int n0, const Shape& s,
                                           const T* __restrict__ bias, T* __restrict__ out,
                                           float* __restrict__ partial, int splits) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = n0 + q * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rows[h];
      if (row < 0) continue;
      const float v0 = acc[q * 4 + h * 2], v1 = acc[q * 4 + h * 2 + 1];
      if (splits > 1) {
        float* dst = partial + ((size_t)blockIdx.z * s.M + row) * s.Cout + col;
        if (NARROW) {
          if (col < s.Cout) dst[0] = v0;
          if (col + 1 < s.Cout) dst[1] = v1;
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        }
      } else {
        T* dst = out + (size_t)row * s.Cout + col;
        const float b0 = bias && col < s.Cout ? to_f32(bias[col]) : 0.f;
        const float b1 = bias && col + 1 < s.Cout ? to_f32(bias[col + 1]) : 0.f;
        if (NARROW) {
          if (col < s.Cout) dst[0] = from_f32<T>(v0 + b0);
          if (col + 1 < s.Cout) dst[1] = from_f32<T>(v1 + b1);
        } else {
          store2(dst, v0 + b0, v1 + b1);
        }
      }
    }
  }
}

template <int NWG, int BN, int STAGES, bool NARROW>
__global__ void __launch_bounds__(NWG * 128, 1)
conv3x3_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ bias, bf16* __restrict__ out,
                     float* __restrict__ partial, Shape s, int splits) {
  static_assert(STAGES >= 3, "loads run STAGES - 2 slices ahead of one wgmma group in flight");
  static_assert(NARROW ? BN == 8 : BN % 64 == 0, "tile width");
  constexpr int THREADS = NWG * 128, BM = NWG * 64;
  constexpr int A_BYTES = BM * A_ROW_BYTES;
  constexpr int B_BYTES = NARROW ? 0 : BN * 128;
  constexpr int ROW_STEP = THREADS / 8;  // A rows between one thread's chunks
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t a_ring = base, b_ring = base + STAGES * A_BYTES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cs = s.Cin / SLICE, k_tiles = 9 * cs;
  const int kt0 = (int)((long long)blockIdx.z * k_tiles / splits);
  const int nk = (int)((long long)(blockIdx.z + 1) * k_tiles / splits) - kt0;

  // This thread's share of every A slice: 16-byte chunk j of rows
  // tid / 8 + i * ROW_STEP, i < 4 (BM * 8 chunks over THREADS threads).
  const int j = tid & 7;
  int pix[4], ph[4], pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / 8 + i * ROW_STEP;
    pix[i] = m < s.M ? m : -1;
    pw[i] = m % s.W;
    ph[i] = (m / s.W) % s.H;
  }

  auto load_a = [&](int stage, int kt) {
    const int tap = kt / cs;
    const int c = (kt - tap * cs) * SLICE + j * 8;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 8 + i * ROW_STEP;
      const bool ok = pix[i] >= 0 && (unsigned)(ph[i] + dy) < (unsigned)s.H &&
                      (unsigned)(pw[i] + dx) < (unsigned)s.W;
      const bf16* src = ok ? x + (size_t)(pix[i] + dy * s.W + dx) * s.Cin + c : x;
      hopper::cp_async16(a_ring + stage * A_BYTES + hopper::swizzle128(r, j), src, ok);
    }
  };
  // B slice kt: weight rows kt * 64 .. + 63 (the HWIO weight seen as
  // (9 Cin, Cout)), columns n0 .. n0 + BN - 1, stored as BN / 64 blocks of
  // 64 k-rows x 128 bytes: the MN-major 128-byte-swizzle layout.
  auto load_b = [&](int stage, int kt) {
    constexpr int CPR = BN / 8;  // 16-byte chunks per k-row
#pragma unroll
    for (int q = tid; q < 64 * CPR; q += THREADS) {
      const int r = q / CPR, cc = q % CPR;
      const bf16* src = w + (size_t)(kt * SLICE + r) * s.Cout + n0 + cc * 8;
      hopper::cp_async16(b_ring + stage * B_BYTES + (cc / 8) * NB_BYTES + hopper::swizzle128(r, cc & 7),
                         src, true);
    }
  };

  if constexpr (NARROW) {
    // The split's weight rows, K-major: slice t is 8 rows (output channels
    // n0 .. n0 + 7, zero past Cout) of 64 k in the 128-byte swizzle.
    uint8_t* wres = smem + (b_ring - base);
    for (int e = tid; e < nk * SLICE * 8; e += THREADS) {
      const int nn = e & 7, kl = e >> 3, n = n0 + nn;
      const bf16 v = n < s.Cout ? w[(size_t)(kt0 * SLICE + kl) * s.Cout + n] : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(wres + (kl / SLICE) * 1024 + hopper::swizzle128(nn, (kl & 63) >> 3) +
                               (kl & 7) * 2) = v;
    }
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int p = 0; p < STAGES - 2; ++p) {
    if (p < nk) {
      load_a(p, kt0 + p);
      if constexpr (!NARROW) load_b(p, kt0 + p);
    }
    hopper::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    // Slice i has landed for this thread; the barrier makes it whole, and
    // (each warpgroup having waited for its wgmma of slice i - 2) frees the
    // buffer refilled below.
    hopper::cp_async_wait<STAGES - 3>();
    hopper::fence_proxy_async();
    __syncthreads();
    const int st = i % STAGES;
    const uint32_t a_tile = a_ring + st * A_BYTES + wg * 64 * A_ROW_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    if constexpr (NARROW) {
#pragma unroll
      for (int kk = 0; kk < SLICE / 16; ++kk)
        hopper::wgmma_m64k16<0>(acc, hopper::desc_sw128(a_tile + kk * 32, 16, 1024),
                                hopper::desc_sw128(b_ring + i * 1024 + kk * 32, 16, 1024));
    } else {
      mma_slice<BN>(acc, a_tile, b_ring + st * B_BYTES);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    hopper::wgmma_wait<1>();
    const int next = i + STAGES - 2;
    if (next < nk) {
      load_a(next % STAGES, kt0 + next);
      if constexpr (!NARROW) load_b(next % STAGES, kt0 + next);
    }
    hopper::cp_async_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // Accumulator layout of m64nN: register 4 q + 2 h + e holds row
  // 16 warp + lane / 4 + 8 h of the warpgroup's 64, column 8 q + 2 (lane % 4) + e.
  const int row0 = m0 + wg * 64 + ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
  const int rows[2] = {row0 < s.M ? row0 : -1, row0 + 8 < s.M ? row0 + 8 : -1};
  store_tile<BN, NARROW>(acc, rows, n0, s, bias, out, partial, splits);
}

// Split-K's second pass: out = T(sum over z in order of partial[z] + bias).
template <typename T>
__device__ __forceinline__ void splitk_reduce(const float* __restrict__ partial, const T* __restrict__ bias,
                                              T* __restrict__ out, int splits, int mn, int cout) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < mn; e += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += partial[(size_t)z * mn + e];
    if (bias) v += to_f32(bias[e % cout]);
    out[e] = from_f32<T>(v);
  }
}

template <typename T>
__global__ void conv3x3_splitk_reduce(const float* __restrict__ partial, const T* __restrict__ bias,
                                      T* __restrict__ out, int splits, int mn, int cout) {
  splitk_reduce<T>(partial, bias, out, splits, mn, cout);
}

// The weight gradient's, under a name of its own (a profile's kernel names
// then tell its time from the forward's).
__global__ void conv3x3_dw_splitk_reduce(const float* __restrict__ partial, float* __restrict__ out, int splits,
                                         int mn) {
  splitk_reduce<float>(partial, nullptr, out, splits, mn, 1);
}

// "tma": the levels from 32 x 40 up. A tile is a patch of 8 MW x TMA_W
// output pixels of one image (128 MW rows of the GEMM) x BN channels over
// its split of the K walk. Warpgroup 0 is the producer: one thread issues,
// per slice, one TMA box of the input (64 channels x the patch at the
// tap's offset; the box's part outside the image arrives as zeros, which
// is the SAME padding) and BN / 64 boxes of the weight, both in the
// 128-byte swizzle, into a ring of STAGES buffers; a `full` mbarrier per
// buffer counts the bytes in. Warpgroups 1 and 2 each multiply 64 MW of the
// rows with wgmma and release a buffer (its `empty` mbarrier, one arrival
// per consumer thread) once the wgmma that read it has completed. No
// block-wide barrier in the loop, and the consumers issue no loads.
constexpr int TMA_W = 16;

__host__ __device__ constexpr size_t tma_smem_bytes(int bm, int bn, int stages) {
  return 1024 + (size_t)stages * (bm * A_ROW_BYTES + bn * 128) + (size_t)stages * 16;
}

template <int MW, int BN, int STAGES>
__global__ void __launch_bounds__(384, 1)
conv3x3_tma_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                   const bf16* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ partial, Shape s,
                   int splits) {
  constexpr int TMA_H = 8 * MW, A_BYTES = 128 * MW * A_ROW_BYTES, STAGE_BYTES = A_BYTES + BN * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * STAGE_BYTES, empty = full + STAGES * 8;
  // warp-uniform to the compiler (a divergent branch around wgmma serializes it)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int tiles_w = (s.W + TMA_W - 1) / TMA_W, tiles_h = (s.H + TMA_H - 1) / TMA_H;
  const int w0 = blockIdx.x % tiles_w * TMA_W, h0 = blockIdx.x / tiles_w % tiles_h * TMA_H;
  const int b = blockIdx.x / (tiles_w * tiles_h), n0 = blockIdx.y * BN;
  const int cs = s.Cin / SLICE, k_tiles = 9 * cs;
  const int kt0 = blockIdx.z * k_tiles / splits, kt1 = (blockIdx.z + 1) * k_tiles / splits;  // this split's slices
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbarrier_init(full + i * 8, 1);
      hopper::mbarrier_init(empty + i * 8, 256);
    }
    hopper::fence_mbarrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, st = i % STAGES;
        if (i >= STAGES) hopper::mbarrier_wait(empty + st * 8, (i / STAGES - 1) & 1);
        const uint32_t a_tile = base + st * STAGE_BYTES, bar = full + st * 8;
        const int tap = kt / cs;
        hopper::mbarrier_expect_tx(bar, STAGE_BYTES);
        hopper::tma_load_4d(a_tile, &x_map, bar, (kt - tap * cs) * SLICE, w0 + tap % 3 - 1, h0 + tap / 3 - 1, b);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(a_tile + A_BYTES + j * NB_BYTES, &w_map, bar, n0 + j * 64, kt * SLICE);
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int cw = wg - 1;  // this warpgroup's rows: cw * 64 MW ..
    float acc[MW][BN / 2];
#pragma unroll
    for (int mb = 0; mb < MW; ++mb)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0.f;
    for (int i = 0; i < kt1 - kt0; ++i) {
      const int st = i % STAGES;
      hopper::mbarrier_wait(full + st * 8, (i / STAGES) & 1);
      const uint32_t a_tile = base + st * STAGE_BYTES;
#pragma unroll
      for (int mb = 0; mb < MW; ++mb) hopper::fence_regs(acc[mb]);
      hopper::wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < MW; ++mb)
        mma_slice<BN>(acc[mb], a_tile + (cw * MW + mb) * 64 * A_ROW_BYTES, a_tile + A_BYTES);
      hopper::wgmma_commit();
#pragma unroll
      for (int mb = 0; mb < MW; ++mb) hopper::fence_regs(acc[mb]);
      hopper::wgmma_wait<1>();  // the previous slice's products are done: free its buffer
      if (i > 0) hopper::mbarrier_arrive(empty + (i - 1) % STAGES * 8);  // every consumer thread, no branch
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MW; ++mb) {
      hopper::fence_regs(acc[mb]);
      // GEMM row r of the patch is pixel (h0 + r / TMA_W, w0 + r % TMA_W).
      int rows[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (cw * MW + mb) * 64 + ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2) + h * 8;
        const int hh = h0 + r / TMA_W, ww = w0 + r % TMA_W;
        rows[h] = hh < s.H && ww < s.W ? (b * s.H + hh) * s.W + ww : -1;
      }
      store_tile<BN, false>(acc[mb], rows, n0, s, bias, out, partial, splits);
    }
  }
}

// "tma_narrow": the narrow N tile for the large output convs (Cout < 64),
// bound by bytes. A patch of 16 x 16 output pixels x 8 channels has the
// layout of "tma" with MW = 2. A tap shifted by dy reads the patch's rows
// moved by 16 dy GEMM rows, a whole number of 8-row swizzle atoms, so one
// TMA box of 18 x 16 pixels per (64-channel slice, dx) serves the three
// taps dy = -1, 0, 1 at row offsets 0, 16 and 32: A crosses from L2 three
// times instead of nine. Each block makes its weight (9 Cin x 8, K-major,
// zero past Cout) resident in shared memory once, then walks patches
// blockIdx.x, blockIdx.x + gridDim.x, ...; the ring runs on across patches,
// so the producer loads the next patch while the consumers store this one.
constexpr int NARROW_H = 16, NARROW_BOX_H = NARROW_H + 2;

__host__ __device__ constexpr size_t tma_narrow_smem_bytes(int stages, int k_tiles) {
  return 1024 + (size_t)stages * (NARROW_BOX_H * TMA_W * A_ROW_BYTES) + (size_t)k_tiles * 1024 + (size_t)stages * 16;
}

template <int STAGES>
__global__ void __launch_bounds__(384, 1)
conv3x3_tma_narrow_kernel(const __grid_constant__ CUtensorMap x_map, const bf16* __restrict__ w,
                          const bf16* __restrict__ bias, bf16* __restrict__ out, Shape s) {
  constexpr int BOX_BYTES = NARROW_BOX_H * TMA_W * A_ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int cs = s.Cin / SLICE, k_tiles = 9 * cs;
  const uint32_t wres = base + STAGES * BOX_BYTES, full = wres + k_tiles * 1024, empty = full + STAGES * 8;
  // warp-uniform to the compiler (a divergent branch around wgmma serializes it)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int tiles_w = (s.W + TMA_W - 1) / TMA_W, tiles_h = (s.H + NARROW_H - 1) / NARROW_H;
  const int patches = s.B * tiles_h * tiles_w, n0 = blockIdx.y * 8;
  // the weight, K-major: slice t holds 8 rows (channels n0 ..) of 64 k
  uint8_t* wres_ptr = smem_raw + (wres - raw);
  for (int e = tid; e < k_tiles * SLICE * 8; e += blockDim.x) {
    const int nn = e & 7, kl = e >> 3, n = n0 + nn;
    const bf16 v = n < s.Cout ? w[(size_t)kl * s.Cout + n] : __float2bfloat16(0.f);
    *reinterpret_cast<bf16*>(wres_ptr + (kl / SLICE) * 1024 + hopper::swizzle128(nn, (kl & 63) >> 3) + (kl & 7) * 2) = v;
  }
  hopper::fence_proxy_async();
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbarrier_init(full + i * 8, 1);
      hopper::mbarrier_init(empty + i * 8, 256);
    }
    hopper::fence_mbarrier_init();
  }
  __syncthreads();

  const int n_loads = 3 * cs;  // boxes per patch: (slice c, dx), dx fastest
  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      int g = 0;  // boxes loaded by this block
      for (int p = blockIdx.x; p < patches; p += gridDim.x) {
        const int w0 = p % tiles_w * TMA_W, h0 = p / tiles_w % tiles_h * NARROW_H, b = p / (tiles_w * tiles_h);
        for (int i = 0; i < n_loads; ++i, ++g) {
          const int st = g % STAGES;
          if (g >= STAGES) hopper::mbarrier_wait(empty + st * 8, (g / STAGES - 1) & 1);
          const uint32_t bar = full + st * 8;
          hopper::mbarrier_expect_tx(bar, BOX_BYTES);
          hopper::tma_load_4d(base + st * BOX_BYTES, &x_map, bar, i / 3 * SLICE, w0 + i % 3 - 1, h0 - 1, b);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int cw = wg - 1;  // this warpgroup's rows: cw * 128 ..
    int g = 0;
    for (int p = blockIdx.x; p < patches; p += gridDim.x) {
      float acc[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mb][i] = 0.f;
      for (int i = 0; i < n_loads; ++i, ++g) {
        const int st = g % STAGES, c = i / 3, dx = i % 3;
        hopper::mbarrier_wait(full + st * 8, (g / STAGES) & 1);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) hopper::fence_regs(acc[mb]);
        hopper::wgmma_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint32_t b_slice = wres + ((dy * 3 + dx) * cs + c) * 1024;
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            const uint32_t a_tile = base + st * BOX_BYTES + (dy * TMA_W + (cw * 2 + mb) * 64) * A_ROW_BYTES;
#pragma unroll
            for (int kk = 0; kk < SLICE / 16; ++kk)
              hopper::wgmma_m64k16<0>(acc[mb], hopper::desc_sw128(a_tile + kk * 32, 16, 1024),
                                      hopper::desc_sw128(b_slice + kk * 32, 16, 1024));
          }
        }
        hopper::wgmma_commit();
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) hopper::fence_regs(acc[mb]);
        hopper::wgmma_wait<1>();  // the previous box's products are done: free its buffer
        if (g > 0) hopper::mbarrier_arrive(empty + (g - 1) % STAGES * 8);  // every consumer thread, no branch
      }
      hopper::wgmma_wait<0>();
      const int w0 = p % tiles_w * TMA_W, h0 = p / tiles_w % tiles_h * NARROW_H, b = p / (tiles_w * tiles_h);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        hopper::fence_regs(acc[mb]);
        int rows[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (cw * 2 + mb) * 64 + ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2) + h * 8;
          const int hh = h0 + r / TMA_W, ww = w0 + r % TMA_W;
          rows[h] = hh < s.H && ww < s.W ? (b * s.H + hh) * s.W + ww : -1;
        }
        store_tile<8, true>(acc[mb], rows, n0, s, bias, out, nullptr, 1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 with 32-channel K slices: "slice32" (Cin % 32 == 0, Cin % 64 != 0:
// 32, 96, 160, ...). Bound by bytes: at Cin = Cout = 32 a pixel's
// 9 * 32 * 32 multiply-adds are ~144 FLOP per byte moved, below the card's
// ~295. So each input pixel crosses from HBM once and each output once, and
// A is read from L2 as few times as the route allows.
//
// K is walked as (tap, 32-channel slice): a row of a slice is one pixel's 32
// channels, 64 bytes, in the 64-byte swizzle. A tile is a patch of PH = 8 MW
// rows x TMA_W = 16 columns of output pixels of one image (128 MW GEMM rows)
// x BN output channels, BN = 32 (Cout % 32 == 0) or 8 (the output convs,
// Cout < 64; columns past Cout are not stored), so A is read once per Cout
// tile and not once per 8 output columns. Each block makes its BN columns
// of the weight (9 Cin x BN, K-major, 64-byte swizzle, zero past Cout)
// resident in shared memory once, then walks patches blockIdx.x, blockIdx.x
// + gridDim.x, ... (one block per SM; the planner sets the grid). Warpgroup
// 0 is the producer: one thread issues the input's TMA boxes (SWIZZLE_64B, zero
// fill past the image: the SAME padding) into two rings of STAGES / 2
// buffers, each with a `full` and an `empty` mbarrier; the rings run on
// across patches, so the producer loads the next patch while the consumers
// store this one. Warpgroups 1 and 2 take the block's patches in turn, each
// a whole patch (2 MW m64 blocks) from its own ring, so that one's loads,
// products and stores overlap the other's instead of running in lockstep
// (one ring shared by both would let one warpgroup wait on a barrier a
// phase ahead of the other's, which its parity cannot tell apart). A
// warpgroup releases a buffer once the wgmma that read it has completed.
// Its epilogue adds the bias and rounds once to bf16 in registers, writes
// the pairs into the warpgroup's output tile in shared memory (swizzled, so
// without bank conflicts), and one thread writes the tile out with a TMA
// store (clipped at the image's edge) while the warpgroup goes on to its
// next patch. (An epilogue that stored 16-byte vectors from registers,
// after an exchange within each lane quad, spent longer in its shuffles
// and selects than the loads took.) BN = 8 stores 2-byte values from
// registers: a row of Cout = 6 is 12 bytes, which TMA cannot address.
//
// A reaches the tensor cores as one box of (PH + 2) x 16 pixels per (slice,
// dx). A tap shifted by dy reads the box's rows moved by 16 dy pixels, 1024
// bytes, which keeps the swizzle's phase, so one box serves the three taps
// dy = -1, 0, 1 as wgmma operands straight from shared memory: A crosses
// from L2 three times. (A halo box of (PH + 2) x 18 pixels per slice, which
// crosses once, leaves a tap's rows unevenly spaced, so they must go
// through registers by ldmatrix; that route timed no faster at the learning
// demo's shapes.)
constexpr int C32 = 32;       // channels per K slice
constexpr int ROW32 = 64;     // bytes of one pixel's slice

// the bytes one box brings, and its ring buffer (rounded up to 1024 bytes)
__host__ __device__ constexpr int slice32_box_tx(int mw) { return (8 * mw + 2) * TMA_W * ROW32; }
__host__ __device__ constexpr int slice32_box_bytes(int mw) { return (slice32_box_tx(mw) + 1023) / 1024 * 1024; }
// each consumer warpgroup's output tile, staged for its TMA store (BN = 32)
__host__ __device__ constexpr int slice32_out_bytes(int mw, int bn) { return bn == 32 ? 128 * mw * bn * 2 : 0; }
__host__ __device__ constexpr size_t slice32_smem_bytes(int mw, int bn, int stages, int k_slices) {
  return 1024 + (size_t)stages * slice32_box_bytes(mw) + 2 * (size_t)slice32_out_bytes(mw, bn) +
         (size_t)k_slices * bn * ROW32 + (size_t)stages * 16;
}

template <int MW, int BN, int STAGES>
__global__ void __launch_bounds__(384, 1)
conv3x3_slice32_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap y_map,
                       const bf16* __restrict__ w, const bf16* __restrict__ bias, bf16* __restrict__ out, Shape s) {
  static_assert(BN == 8 || BN == 32, "tile width");
  static_assert(STAGES % 2 == 0, "a ring of STAGES / 2 buffers per consumer warpgroup");
  constexpr int PH = 8 * MW, NB = 2 * MW;  // patch rows; its m64 blocks
  constexpr int RING = STAGES / 2;
  constexpr int BOX_BYTES = slice32_box_bytes(MW), BOX_TX = slice32_box_tx(MW);
  constexpr int W_SLICE = BN * ROW32;  // one K slice of the resident weight: BN rows of 32 k
  constexpr int OUT_BYTES = slice32_out_bytes(MW, BN);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int cs = s.Cin / C32, k_slices = 9 * cs;
  const uint32_t staged = base + STAGES * BOX_BYTES, wres = staged + 2 * OUT_BYTES;
  const uint32_t full = wres + k_slices * W_SLICE, empty = full + STAGES * 8;
  // warp-uniform to the compiler (a divergent branch around wgmma serializes it)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int tiles_w = (s.W + TMA_W - 1) / TMA_W, tiles_h = (s.H + PH - 1) / PH;
  const int patches = s.B * tiles_h * tiles_w, n0 = blockIdx.y * BN;
  const int n_loads = 3 * cs;  // boxes per patch: slice c, dx (fastest)
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbarrier_init(full + i * 8, 1);
      hopper::mbarrier_init(empty + i * 8, 128);  // the warpgroup that owns the box
    }
    hopper::fence_mbarrier_init();
  }
  __syncthreads();

  // The j-th patch of this block belongs to consumer warpgroup j % 2, and
  // its boxes to that warpgroup's ring: box i is the warpgroup's box
  // g = j / 2 * n_loads + i, in stage (j % 2) RING + g % RING. A barrier is
  // then waited on by one warpgroup only, never more than one phase ahead.
  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      int j = 0;
      for (int p = blockIdx.x; p < patches; p += gridDim.x, ++j) {
        const int w0 = p % tiles_w * TMA_W, h0 = p / tiles_w % tiles_h * PH, b = p / (tiles_w * tiles_h);
        for (int i = 0; i < n_loads; ++i) {
          const int g = j / 2 * n_loads + i, st = (j & 1) * RING + g % RING;
          if (g >= RING) hopper::mbarrier_wait(empty + st * 8, (g / RING - 1) & 1);
          const uint32_t bar = full + st * 8;
          hopper::mbarrier_expect_tx(bar, BOX_TX);
          hopper::tma_load_4d(base + st * BOX_BYTES, &x_map, bar, i / 3 * C32, w0 + i % 3 - 1, h0 - 1, b);
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // this consumer warpgroup takes the block's patches j = cw, cw + 2, ...
  const int lane = tid & 31, warp = (tid & 127) >> 5, t = lane & 3;
  // The weight, K-major: slice kt holds BN rows (channels n0 ..) of 32 k,
  // row n at swizzle64(n, k / 8). 16-byte reads of 8 channels where BN = 32
  // (Cout % 8 == 0 then), else one value at a time, zero past Cout.
  uint8_t* wres_ptr = smem_raw + (wres - raw);
  if constexpr (BN == 8) {
    for (int e = tid - 128; e < 9 * s.Cin * 8; e += 256) {
      const int nn = e & 7, kk = e >> 3, n = n0 + nn;
      const bf16 v = n < s.Cout ? w[(size_t)kk * s.Cout + n] : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(wres_ptr + (kk / C32) * W_SLICE + hopper::swizzle64(nn, (kk & 31) >> 3) +
                               (kk & 7) * 2) = v;
    }
  } else {
    constexpr int VPR = BN / 8;  // 16-byte vectors per weight row
    for (int e = tid - 128; e < 9 * s.Cin * VPR; e += 256) {
      const int kk = e / VPR, v = e % VPR;
      const uint4 q = *reinterpret_cast<const uint4*>(w + (size_t)kk * s.Cout + n0 + 8 * v);
      const bf16* vals = reinterpret_cast<const bf16*>(&q);
      uint8_t* dst = wres_ptr + (kk / C32) * W_SLICE + (kk & 7) * 2;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<bf16*>(dst + hopper::swizzle64(8 * v + j, (kk & 31) >> 3)) = vals[j];
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, 256);
  // this thread's bias (BN = 32): columns n0 + 8 q + 2 t + e of the accumulator layout
  float bsum[BN == 32 ? BN / 4 : 1];
#pragma unroll
  for (int i = 0; i < (BN == 32 ? BN / 4 : 0); ++i) bsum[i] = bias ? to_f32(bias[n0 + 8 * (i / 2) + 2 * t + i % 2]) : 0.f;

  // A box is released (its `empty` barrier, one arrival per thread of the
  // warpgroup) once the wgmma that read it has completed: `held` is that
  // box's ring stage, or -1.
  int held = -1;
  for (int j = cw;; j += 2) {
    const int p = blockIdx.x + j * gridDim.x;
    if (p >= patches) break;
    float acc[NB][BN / 2];
#pragma unroll
    for (int mb = 0; mb < NB; ++mb)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0.f;
    for (int i = 0; i < n_loads; ++i) {
      const int g = j / 2 * n_loads + i, st = cw * RING + g % RING;
      const uint32_t box = base + st * BOX_BYTES;
      hopper::mbarrier_wait(full + st * 8, (g / RING) & 1);
      const int c = i / 3, dx = i % 3;
#pragma unroll
      for (int mb = 0; mb < NB; ++mb) hopper::fence_regs(acc[mb]);
      hopper::wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t b_slice = wres + ((dy * 3 + dx) * cs + c) * W_SLICE;
#pragma unroll
        for (int mb = 0; mb < NB; ++mb) {
          const uint32_t a_tile = box + (dy * TMA_W + mb * 64) * ROW32;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            hopper::wgmma_m64k16<0>(acc[mb], hopper::desc_sw64(a_tile + kk * 32, 16, 512),
                                    hopper::desc_sw64(b_slice + kk * 32, 16, 512));
        }
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int mb = 0; mb < NB; ++mb) hopper::fence_regs(acc[mb]);
      hopper::wgmma_wait<1>();  // the previous box's products are done: free it
      if (held >= 0) hopper::mbarrier_arrive(empty + held * 8);
      held = st;
    }
    hopper::wgmma_wait<0>();
    hopper::mbarrier_arrive(empty + held * 8);  // the patch's last box
    held = -1;
    const int w0 = p % tiles_w * TMA_W, h0 = p / tiles_w % tiles_h * PH, b = p / (tiles_w * tiles_h);
#pragma unroll
    for (int mb = 0; mb < NB; ++mb) hopper::fence_regs(acc[mb]);
    if constexpr (BN == 8) {
#pragma unroll
      for (int mb = 0; mb < NB; ++mb) {
        int rows[2];  // GEMM row r of the patch is pixel (h0 + r / TMA_W, w0 + r % TMA_W)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mb * 64 + warp * 16 + (lane >> 2) + h * 8;
          const int hh = h0 + r / TMA_W, ww = w0 + r % TMA_W;
          rows[h] = hh < s.H && ww < s.W ? (b * s.H + hh) * s.W + ww : -1;
        }
        store_tile<8, true>(acc[mb], rows, n0, s, bias, out, nullptr, 1);
      }
    } else {
      // register 4 q + 2 h + e: GEMM row r = 64 mb + 16 warp + lane / 4 +
      // 8 h, column n0 + 8 q + 2 t + e; staged as the output box (PH x 16
      // pixels x 32 channels, pixel r's row of 64 bytes in the 64-byte
      // swizzle, conflict-free), which one thread then stores with TMA (the
      // part past the image is not written).
      const uint32_t tile = staged + cw * OUT_BYTES;
      const bool issuer = (tid & 127) == 0;
      if (issuer) hopper::bulk_wait_read<0>();  // this warpgroup's previous store has read the tile
      hopper::named_barrier_sync(2 + cw, 128);
#pragma unroll
      for (int mb = 0; mb < NB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mb * 64 + warp * 16 + (lane >> 2) + h * 8;
#pragma unroll
          for (int q = 0; q < BN / 8; ++q) {
            const __nv_bfloat162 v2 = __floats2bfloat162_rn(acc[mb][4 * q + 2 * h] + bsum[2 * q],
                                                            acc[mb][4 * q + 2 * h + 1] + bsum[2 * q + 1]);
            const uint32_t off = hopper::swizzle64(r, q) + 4 * t;
            *reinterpret_cast<__nv_bfloat162*>(smem_raw + (tile - raw) + off) = v2;
          }
        }
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(2 + cw, 128);
      if (issuer) {
        hopper::tma_store_4d(&y_map, tile, n0, w0, h0, b);
        hopper::bulk_commit();
      }
    }
  }
  if (BN != 8 && (tid & 127) == 0) hopper::bulk_wait<0>();  // the last stores are done before the block exits
}

// ---------------------------------------------------------------------------
// float32 on Hopper: "tf32x3", the implicit GEMM on the tensor cores with
// split operands.
//
// K is walked as (tap, 32-channel slice): a row of a staged A slice is 32
// contiguous floats of one neighbour pixel, 128 bytes in the 128-byte
// swizzle, brought by 16-byte cp.async (zero fill at the halo and past the
// last pixel) as in "wgmma". The weight arrives pre-split (hi, then lo) and
// K-major: (2, Cout, 9 Cin), so a B slice is BN rows of 128 bytes per half,
// the layout tf32 wgmma reads. Within each slice the split pass permutes K
// so that A's register fragments come from contiguous channels: logical
// column 8 kk + c of the slice (k8 step kk, column c of the m16n8k8 tf32
// fragment) is channel 8 (c % 4) + 2 kk + c / 4. A thread of lane % 4 = t
// then holds channels 8 t .. 8 t + 7 of its two rows for all four k8 steps:
// two 16-byte shared loads per row, conflict-free under the swizzle.
constexpr int F32_SLICE = 32;  // channels per K slice

__host__ __device__ constexpr size_t tf32x3_smem_bytes(int nwg, int bn, int stages) {
  return 1024 + (size_t)stages * (nwg * 64 * A_ROW_BYTES + 2 * bn * 128);
}

// The K-major split operand: hi at split[n * K + k], lo at split[Cout * K +
// n * K + k], for a row-major (K, Cout) source, its slices permuted as
// above. The source is the HWIO weight seen as (K = 9 Cin, Cout); or dy seen
// as (B H W, Cout), the weight-gradient kernel's B operand, whose rows past
// `rows` (up to K, a multiple of 32) are zero; or, with `flip`, the weight
// of dx = conv(dy, w'), w'[kh][kw][co][ci] = w[2 - kh][2 - kw][ci][co], read
// from the forward's HWIO weight w (3, 3, cout, K / 9). A 32 x 32 tile per
// block, transposed through shared memory so that both the reads and the
// writes are coalesced.
__device__ __forceinline__ void split_operand(const float* __restrict__ w, float* __restrict__ split, int rows,
                                              int K, int cout, int flip) {
  __shared__ float tile[32][33];  // tile[k - k0][n - n0]
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32, tx = threadIdx.x;
  if (flip) {  // w'[k][n] = w[8 - k / cin][n][k % cin]: k contiguous in w
    const int cin = K / 9, k = k0 + tx;
    for (int r = threadIdx.y; r < 32; r += blockDim.y)
      tile[tx][r] = k < K && n0 + r < cout ? w[((size_t)(8 - k / cin) * cout + n0 + r) * cin + k % cin] : 0.f;
  } else {
    for (int r = threadIdx.y; r < 32; r += blockDim.y)
      tile[r][tx] = k0 + r < rows && n0 + tx < cout ? w[(size_t)(k0 + r) * cout + n0 + tx] : 0.f;
  }
  __syncthreads();
  const int kk = tx / 8, c = tx % 8, src = 8 * (c % 4) + 2 * kk + c / 4;  // K slices start at multiples of 32
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int n = n0 + r, k = k0 + tx;
    if (n >= cout || k >= K) continue;
    const float v = tile[src][r];
    const uint32_t hi = hopper::to_tf32(v);
    split[(size_t)n * K + k] = __uint_as_float(hi);
    split[(size_t)cout * K + (size_t)n * K + k] = __uint_as_float(hopper::to_tf32(v - __uint_as_float(hi)));
  }
}

__global__ void conv3x3_tf32_split_weight(const float* __restrict__ w, float* __restrict__ split, int rows, int K,
                                          int cout, int flip) {
  split_operand(w, split, rows, K, cout, flip);
}

// dy's split copy for the weight gradient, under a name of its own.
__global__ void conv3x3_dw_split_dy(const float* __restrict__ dy, float* __restrict__ split, int rows, int K,
                                    int cout) {
  split_operand(dy, split, rows, K, cout, 0);
}

// NWG consumer warpgroups of 64 rows each (BM = 64 NWG), all of whose
// threads also issue the cp.async of the ring. Per slice a thread loads its
// rows row0 and row0 + 8 (the m16n8k8 rows of its warp), waits for its
// previous wgmma group (which still reads the fragment registers), splits
// the rows into them and issues 12 wgmma: per k8 step hi x B_hi, hi x B_lo,
// lo x B_hi. While one warpgroup loads and splits, the other warpgroups'
// groups keep the tensor cores busy; three warpgroups (192 rows) take a
// quarter fewer bytes from L2 per product than two. ptxas notes (C7515)
// that it serializes some of these wgmma; on the H100, waiting for each
// group right after its commit clears the note and runs 5-8% slower, and
// two fragment sets alternating (no note) ran 2-4% slower than this.
template <int NWG, int BN, int STAGES>
__global__ void __launch_bounds__(NWG * 128, 1)
conv3x3_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ wsplit,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ partial, Shape s, int splits) {
  static_assert(STAGES >= 3, "loads run STAGES - 2 slices ahead of the wgmma groups in flight");
  static_assert(BN == 8 || BN == 64 || BN == 128, "tile width");
  constexpr bool NARROW = BN == 8;  // Cout < 64: weight rows past Cout are zero, their columns not stored
  constexpr int THREADS = NWG * 128, BM = NWG * 64;
  constexpr int A_BYTES = BM * A_ROW_BYTES, B_BYTES = BN * 128, STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  constexpr int ROW_STEP = THREADS / 8;  // A rows between one thread's chunks
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cs = s.Cin / F32_SLICE, k_tiles = 9 * cs;
  const int kt0 = (int)((long long)blockIdx.z * k_tiles / splits);
  const int nk = (int)((long long)(blockIdx.z + 1) * k_tiles / splits) - kt0;
  const size_t half = (size_t)s.Cout * s.K;  // lo's offset in the split weight

  // This thread's share of every A slice: 16-byte chunk j of rows
  // tid / 8 + i * ROW_STEP, i < 4 (BM * 8 chunks over THREADS threads).
  const int j = tid & 7;
  int pix[4], ph[4], pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / 8 + i * ROW_STEP;
    pix[i] = m < s.M ? m : -1;
    pw[i] = m % s.W;
    ph[i] = (m / s.W) % s.H;
  }
  auto load = [&](int stage, int kt) {
    const uint32_t st = ring + stage * STAGE_BYTES;
    const int tap = kt / cs;
    const int c = (kt - tap * cs) * F32_SLICE + j * 4;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = pix[i] >= 0 && (unsigned)(ph[i] + dy) < (unsigned)s.H && (unsigned)(pw[i] + dx) < (unsigned)s.W;
      const float* src = ok ? x + (size_t)(pix[i] + dy * s.W + dx) * s.Cin + c : x;
      hopper::cp_async16(st + hopper::swizzle128(tid / 8 + i * ROW_STEP, j), src, ok);
    }
    // B: rows n0 .. n0 + BN - 1 of the split weight, K columns kt * 32 ..
#pragma unroll
    for (int q = tid; q < BN * 8; q += THREADS) {
      const int r = q / 8, cc = q % 8;
      const bool ok = !NARROW || n0 + r < s.Cout;
      const float* src = ok ? wsplit + (size_t)(n0 + r) * s.K + kt * F32_SLICE + cc * 4 : wsplit;
      const uint32_t dst = st + A_BYTES + hopper::swizzle128(r, cc);
      hopper::cp_async16(dst, src, ok);
      hopper::cp_async16(dst + B_BYTES, ok ? src + half : wsplit, ok);
    }
  };

#pragma unroll
  for (int p = 0; p < STAGES - 2; ++p) {
    if (p < nk) load(p, kt0 + p);
    hopper::cp_async_commit();
  }
  // The m16n8k8 rows of this thread (of the block's BM) and its column group.
  const int row0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2), t = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];  // this slice's A fragments: register r of k8 step kk
  for (int i = 0; i < nk; ++i) {
    // Slice i has landed for this thread; the barrier makes it whole, and
    // (each warpgroup having waited for its wgmma of slice i - 2 before it
    // split slice i - 1) frees the buffer refilled below.
    hopper::cp_async_wait<STAGES - 3>();
    hopper::fence_proxy_async();
    __syncthreads();
    const uint32_t st = ring + (i % STAGES) * STAGE_BYTES;
    float v[16];  // v[8 h + e]: channel 8 t + e of row row0 + 8 h
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 p = hopper::lds128(st + hopper::swizzle128(row0 + 8 * h, 2 * t + q));
        v[8 * h + 4 * q] = p.x;
        v[8 * h + 4 * q + 1] = p.y;
        v[8 * h + 4 * q + 2] = p.z;
        v[8 * h + 4 * q + 3] = p.w;
      }
    hopper::wgmma_wait<0>();  // slice i - 1's group has read the fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // register r: row row0 + 8 (r & 1), channel 8 t + 2 kk + (r >> 1)
        const float a = v[8 * (r & 1) + 2 * kk + (r >> 1)];
        hi[kk][r] = hopper::to_tf32(a);
        lo[kk][r] = hopper::to_tf32(a - __uint_as_float(hi[kk][r]));
      }
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    const uint32_t b_hi = st + A_BYTES, b_lo = b_hi + B_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_tf32_m64k8(acc, hi[kk], hopper::desc_sw128(b_lo + kk * 32, 16, 1024));
      hopper::wgmma_tf32_m64k8(acc, lo[kk], hopper::desc_sw128(b_hi + kk * 32, 16, 1024));
      hopper::wgmma_tf32_m64k8(acc, hi[kk], hopper::desc_sw128(b_hi + kk * 32, 16, 1024));
    }
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    const int next = i + STAGES - 2;
    if (next < nk) load(next % STAGES, kt0 + next);
    hopper::cp_async_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int row = m0 + row0;
  const int rows[2] = {row < s.M ? row : -1, row + 8 < s.M ? row + 8 : -1};
  store_tile<BN, NARROW>(acc, rows, n0, s, bias, out, partial, splits);
}

// ---------------------------------------------------------------------------
// The weight gradient, dw[kh][kw][ci][co] = sum over (b, h, w) of
// x[b][h + kh - 1][w + kw - 1][ci] dy[b][h][w][co] (zero outside the image).
//
// Replaces no TPU kernel: the JAX package takes this gradient from XLA's
// VJP of the reference conv (diffsep_tpu/ops/pallas/conv3x3.py:200-206,
// conv3x3_mxu's _bwd). An implicit GEMM with a small output and a long
// reduction:
//   M = 9 Cin rows (tap, channel), N = Cout, K = B H W pixels,
//   A[(tap, ci)][p] = x at pixel p shifted by the tap, B[p][co] = dy[p][co].
// What bounds it: operations, 2 M N K, as the forward's (145 GFLOP against
// 0.5 GB of x and dy at the flagship's top level, 128 -> 128 channels at
// batch 6); next, the bytes that every block takes from L2 (its A rows and
// dy's split copy below). The K walk splits over the SMs (grid z), each
// split writing an f32 partial of its tile; conv3x3_dw_splitk_reduce sums
// the partials in order, so the result is bitwise deterministic (no
// atomics).
//
// "tf32x3" (Cin % 32 == 0, Cout % 32 == 0): the forward's split-operand
// TF32 on wgmma, three products per k8 step. tf32 wgmma reads B K-major
// only, and dy is pixel-major, so a pass of its own (conv3x3_dw_split_dy,
// once per call) writes dy transposed, split into hi and lo and permuted per
// 32-pixel slice as the forward's weight, zero past the last pixel: the main
// loop then streams B through the forward's cp.async ring, and the pass
// costs 12 bytes per dy element (read once, hi and lo written), against a
// transpose and split of every B slice in each of the 9 Cin / BM row tiles
// that read it. A comes from registers: each thread's two rows are
// channels ci and ci + 1 of one tap, and its eight pixels of a slice are
// 8 t .. 8 t + 7 (t = lane % 4), the columns the permutation gives its
// fragments; it loads them as float2 straight from x (L1 and L2 serve the
// taps' overlapping reads; no halo to stage), predicated to zero at the
// SAME padding and past the last pixel, a slice ahead, and splits them in
// registers as the forward splits its A rows.
//
// The tensor cores' f32 accumulation does not round to nearest, so over a
// split's walk of up to ~2 x 10^4 wgmma its error would grow with their
// count, past float32's accuracy: the sum of each DW_CHAIN slices' wgmma
// (a chain of 12 DW_CHAIN on the accumulators, the first from zero) is
// added into f32 registers of the thread's own, rounded to nearest, once it
// has completed. Within a chain the slices' groups follow each other
// without a wait: a thread splits slice i into one of two fragment sets
// while slice i - 1's group, which reads the other, runs (its wait for
// slice i - 2's group frees the set), so that the loads, the split and the
// next slice's addresses run under the products. The chain is unrolled,
// its fragment sets and its waits fixed in the code: a wait or a fragment
// set chosen at run time among the wgmma makes ptxas serialize them (C7515,
// C7517). So a split walks whole chains: dy's split copy is padded with
// zeros to a multiple of 32 DW_CHAIN pixels.
//
// What holds it back (timed on the H100 in variants; PERF.md): the
// bytes every block takes from L2 per slice, 16 KB of A and 32 KB of B's
// hi and lo for 3 MFLOP. Without wgmma the loop's loads and splits alone
// took 45% of its time, without loads its products 66%, and the two barely
// overlap. B unsplit, split by the block in shared memory, cost more
// shared-memory bandwidth than it saved from L2; A in shared memory (both
// operands of wgmma there) too, as tf32 wgmma reads 6 KB of it per 64 x 128
// x 8; the two warpgroups taking turns on named barriers, with a TMA
// producer, ran slower (a thread issuing TMA among the wgmma: ptxas
// serialized them, C7518; a producer warp of its own: 9 warps, 168
// registers a thread, spills).
constexpr int DW_CHAIN = 4;  // slices whose wgmma chain a thread adds into its f32 sum at once
template <int NWG, int BN, int STAGES>
__global__ void __launch_bounds__(NWG * 128, 1)
conv3x3_dw_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ dyt, float* __restrict__ out,
                         float* __restrict__ partial, Shape s, int kp, int splits) {
  static_assert(STAGES >= 4, "B loads run STAGES - 3 slices ahead of the wgmma groups in flight");
  static_assert(BN == 32 || BN == 64 || BN == 128, "tile width");
  static_assert(DW_CHAIN % 2 == 0, "the fragment sets alternate");
  constexpr int THREADS = NWG * 128, BM = NWG * 64, AHEAD = STAGES - 3;
  constexpr int B_BYTES = BN * 128, STAGE_BYTES = 2 * B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chains = kp / (DW_CHAIN * F32_SLICE);
  const int kt0 = DW_CHAIN * (int)((long long)blockIdx.z * chains / splits);
  const int nk = DW_CHAIN * (int)((long long)(blockIdx.z + 1) * chains / splits) - kt0;  // whole chains, >= 1
  const size_t half = (size_t)s.Cout * kp;  // lo's offset in dyt
  Shape o = s;  // the output (9 Cin, Cout), as store_tile indexes it
  o.M = 9 * s.Cin;

  // Fragment rows lane / 4 and lane / 4 + 8 of this thread's warp are rows
  // mrow and mrow + 1 of dw: channels ci, ci + 1 of tap `tap`.
  const int mrow = m0 + (tid >> 5) * 16 + 2 * (lane >> 2);
  const bool row_ok = mrow < o.M;
  const int tap = row_ok ? mrow / s.Cin : 0;
  const int ci = mrow - tap * s.Cin, ddy = tap / 3 - 1, ddx = tap % 3 - 1;

  auto load_b = [&](int stage, int kt) {
    const uint32_t st = ring + stage * STAGE_BYTES;
#pragma unroll
    for (int q = tid; q < BN * 8; q += THREADS) {
      const int r = q / 8, cc = q % 8;
      const float* src = dyt + (size_t)(n0 + r) * kp + kt * F32_SLICE + cc * 4;
      const uint32_t dst = st + hopper::swizzle128(r, cc);
      hopper::cp_async16(dst, src, true);
      hopper::cp_async16(dst + B_BYTES, src + half, true);
    }
  };
  // v[8 h + e]: channel ci + h at pixel 32 kt + 8 t + e, shifted by the tap
  auto load_a = [&](float (&v)[16], int kt) {
    const int p0 = kt * F32_SLICE + 8 * t;
    int w = p0 % s.W, h = (p0 / s.W) % s.H;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool ok = row_ok && p0 + e < s.M && (unsigned)(h + ddy) < (unsigned)s.H &&
                      (unsigned)(w + ddx) < (unsigned)s.W;
      float2 a = make_float2(0.f, 0.f);
      if (ok) a = __ldg(reinterpret_cast<const float2*>(x + (size_t)(p0 + e + ddy * s.W + ddx) * s.Cin + ci));
      v[e] = a.x;
      v[8 + e] = a.y;
      if (++w == s.W) {
        w = 0;
        if (++h == s.H) h = 0;
      }
    }
  };

#pragma unroll
  for (int p = 0; p < AHEAD; ++p) {
    if (p < nk) load_b(p, kt0 + p);
    hopper::cp_async_commit();
  }
  float v[16];
  load_a(v, kt0);
  float acc[BN / 2], sum[BN / 2];  // the chain's wgmma sum; the walk's
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
  uint32_t hi0[4][4], lo0[4][4], hi1[4][4], lo1[4][4];  // A fragments of the even and odd slices
  // Slice i (of this split's walk) with fragment set (hi, lo), register r of
  // k8 step kk; `chain`: onto the accumulators, else from zero.
  auto step = [&](int i, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], bool chain) {
    // Slice i's B has landed for this thread; the barrier makes it whole,
    // and (each thread having waited for slice i - 3's group in the last
    // step) frees the buffer refilled below.
    hopper::cp_async_wait<AHEAD - 1>();
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::wgmma_wait<1>();  // slice i - 2's group has read (hi, lo)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // register r: row h = r & 1, pixel 8 t + 2 kk + (r >> 1)
        const float a = v[8 * (r & 1) + 2 * kk + (r >> 1)];
        hi[kk][r] = hopper::to_tf32(a);
        lo[kk][r] = hopper::to_tf32(a - __uint_as_float(hi[kk][r]));
      }
    if (i + 1 < nk) load_a(v, kt0 + i + 1);  // in flight under the products
    hopper::wgmma_fence();
    const uint32_t b_hi = ring + (i % STAGES) * STAGE_BYTES, b_lo = b_hi + B_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_tf32_m64k8(acc, hi[kk], hopper::desc_sw128(b_lo + kk * 32, 16, 1024), kk > 0 || chain);
      hopper::wgmma_tf32_m64k8(acc, lo[kk], hopper::desc_sw128(b_hi + kk * 32, 16, 1024));
      hopper::wgmma_tf32_m64k8(acc, hi[kk], hopper::desc_sw128(b_hi + kk * 32, 16, 1024));
    }
    hopper::wgmma_commit();
    const int next = i + AHEAD;
    if (next < nk) load_b(next % STAGES, kt0 + next);
    hopper::cp_async_commit();
  };
  for (int i = 0; i < nk; i += DW_CHAIN) {
#pragma unroll
    for (int c = 0; c < DW_CHAIN; c += 2) {
      step(i + c, hi0, lo0, c > 0);
      step(i + c + 1, hi1, lo1, true);
    }
    hopper::wgmma_wait<0>();  // the chain is whole: into the f32 sum
    hopper::fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sum[j] += acc[j];
  }
  const int rows[2] = {row_ok ? mrow : -1, row_ok ? mrow + 1 : -1};  // 9 Cin is even: both or neither
  store_tile<BN, false>(sum, rows, n0, o, static_cast<const float*>(nullptr), out, partial, splits);
}

// "window" weight gradient: one side of the conv has at most 8 channels
// (the output convs' Cout of 2-6, the stem's Cin of 6), so a thread can hold
// the sums of a whole (tap, narrow channel) plane for one channel of the
// other, "wide" side: 9 x NN f32 registers. CUDA cores in full float32. A
// block is 32 wide channels (a thread each, neighbouring lanes on
// neighbouring channels: 128-byte loads) x 8 columns (a warp each) of one
// image, over a strip of rows; each thread walks down its column and keeps
// the 3 x 3 window of the wide side around the pixel in registers, loading
// the one new row of three a step (a row ahead), and the pixel's narrow
// channels (one broadcast load each), and adds the window times them: 3 +
// NN loads for 9 NN FFMA, each input byte read from HBM about once (the
// neighbouring columns' loads meet in L1). (Four rows a step, their loads a
// step ahead, ran 1.2x slower: 166 registers, one block per SM.) Bound by
// FFMA and bytes alike at the output convs. The block's 8 columns are
// summed in order through shared memory, and the blocks' partials by
// conv3x3_dw_splitk_reduce.
//   FLIP = false (Cout <= NN): wide = x (Cin), narrow = dy (Cout); window
//   position (a, b), x at (h + a - 1, w + b - 1), is tap (a, b).
//   FLIP = true (Cin <= NN): wide = dy (Cout), narrow = x (Cin), summed
//   over the pixels q of x: dw[kh][kw][ci][co] = sum_q x[q][ci] dy[q + (1 -
//   kh, 1 - kw)][co], so window position (a, b), dy at (h + a - 1, w + b -
//   1), is tap (2 - a, 2 - b).
constexpr int WIN_COLS = 8, WIN_CH = 32;

template <int NN, bool FLIP>
__global__ void __launch_bounds__(WIN_COLS * WIN_CH)
conv3x3_dw_window_kernel(const float* __restrict__ wide, const float* __restrict__ narrow, float* __restrict__ out,
                         float* __restrict__ partial, Shape s, int strips) {
  __shared__ float red[9 * NN * WIN_CH];  // red[k * 32 + lane]: sum k = 9-window position x NN + narrow channel
  const int cw = FLIP ? s.Cout : s.Cin, cn = FLIP ? s.Cin : s.Cout;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x * WIN_CH + lane;
  const int groups = (s.W + WIN_COLS - 1) / WIN_COLS;
  const int g = blockIdx.y % groups, strip = blockIdx.y / groups % strips, b = blockIdx.y / groups / strips;
  const int col = g * WIN_COLS + warp;
  const int h0 = (int)((long long)strip * s.H / strips), h1 = (int)((long long)(strip + 1) * s.H / strips);
  const size_t img = (size_t)b * s.H;
  const bool c_ok = c < cw;
  auto wide_at = [&](int hh, int ww) {
    const bool ok = c_ok && (unsigned)hh < (unsigned)s.H && (unsigned)ww < (unsigned)s.W;
    return ok ? __ldg(wide + ((img + hh) * s.W + ww) * cw + c) : 0.f;
  };
  auto narrow_at = [&](int hh, float (&n)[NN]) {
    const float* p = narrow + ((img + hh) * s.W + col) * cn;
#pragma unroll
    for (int j = 0; j < NN; ++j) n[j] = hh < h1 && j < cn ? __ldg(p + j) : 0.f;
  };
  float acc[9 * NN];
#pragma unroll
  for (int k = 0; k < 9 * NN; ++k) acc[k] = 0.f;
  if (col < s.W) {
    float win[3][3], nxt[3], cur[NN], next[NN];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) win[a][bb] = wide_at(h0 + a - 1, col + bb - 1);
    narrow_at(h0, cur);
    for (int h = h0; h < h1; ++h) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) nxt[bb] = wide_at(h + 2, col + bb - 1);  // in flight under the products
      narrow_at(h + 1, next);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int bb = 0; bb < 3; ++bb)
#pragma unroll
          for (int j = 0; j < NN; ++j) acc[(3 * a + bb) * NN + j] = fmaf(win[a][bb], cur[j], acc[(3 * a + bb) * NN + j]);
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        win[0][bb] = win[1][bb];
        win[1][bb] = win[2][bb];
        win[2][bb] = nxt[bb];
      }
#pragma unroll
      for (int j = 0; j < NN; ++j) cur[j] = next[j];
    }
  }
  for (int w = 0; w < WIN_COLS; ++w) {  // the columns in order
    if (warp == w)
#pragma unroll
      for (int k = 0; k < 9 * NN; ++k) red[k * WIN_CH + lane] = (w == 0 ? 0.f : red[k * WIN_CH + lane]) + acc[k];
    __syncthreads();
  }
  const int splits = gridDim.y;
  for (int e = tid; e < 9 * NN * WIN_CH; e += WIN_COLS * WIN_CH) {
    const int k = e / WIN_CH, ch = blockIdx.x * WIN_CH + e % WIN_CH, pos = k / NN, j = k % NN;
    if (ch >= cw || j >= cn) continue;
    const int tap_ = FLIP ? 8 - pos : pos;
    const size_t idx = FLIP ? ((size_t)tap_ * s.Cin + j) * s.Cout + ch : ((size_t)tap_ * s.Cin + ch) * s.Cout + j;
    if (splits > 1)
      partial[(size_t)blockIdx.y * 9 * s.Cin * s.Cout + idx] = red[e];
    else
      out[idx] = red[e];
  }
}

// "generic" weight gradient (channels off the tf32x3 grid and above 8 on
// both sides, as Cout 20; x off its alignment): CUDA cores in full float32,
// on 64 x 64 tiles. Each block takes a BM_ x BN_ tile of (9 Cin, Cout)
// over its split of the pixels, staging per 32-pixel slice the shifted x
// (zero at the padding) and dy in shared memory. A thread gathers x for
// fixed rows (its tap's offset and channel worked out once; neighbouring
// threads on neighbouring channels) and holds TM rows (strided by the
// thread rows, so that the row reads are conflict-free) x 8 columns of the
// sum.
__global__ void __launch_bounds__(THREADS)
conv3x3_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ out,
                      float* __restrict__ partial, Shape s, int splits) {
  constexpr int BM_ = BM, BN_ = BN;  // the generic forward's 64 x 64 tile
  constexpr int TX = BN_ / 8, TY = THREADS / TX, TM = BM_ / TY;
  constexpr int GR = BM_ >= THREADS ? BM_ / THREADS : 1;  // rows a thread gathers
  constexpr int GK = BM_ >= THREADS ? 1 : THREADS / BM_;  // threads per gathered row
  static_assert(TM * TY == BM_ && TX * 8 == BN_ && GR * THREADS == BM_ * GK, "thread tile");
  __shared__ float As[BK][BM_ + 1];  // As[p][m]: row m's shifted x at pixel p of the slice
  __shared__ __align__(16) float Bs[BK][BN_];
  __shared__ int ph[BK], pw[BK];  // the slice's pixels; ph < 0 past the last one
  const int rows = 9 * s.Cin;
  const int m0 = blockIdx.x * BM_, n0 = blockIdx.y * BN_;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int k_tiles = (s.M + BK - 1) / BK;
  const int kt0 = (int)((long long)blockIdx.z * k_tiles / splits);
  const int kt1 = (int)((long long)(blockIdx.z + 1) * k_tiles / splits);
  // the gathered rows m0 + tid % BM_ + r * THREADS: tap offset and channel
  int gdy[GR], gdx[GR], goff[GR];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int m = m0 + tid % BM_ + r * THREADS, tap = m < rows ? m / s.Cin : -1;
    gdy[r] = tap < 0 ? -s.H - 2 : tap / 3 - 1;  // a row past 9 Cin is never in range
    gdx[r] = tap % 3 - 1;
    goff[r] = (gdy[r] * s.W + gdx[r]) * s.Cin + (m - tap * s.Cin);
  }
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int p0 = kt * BK;
    if (tid < BK) {
      const int p = p0 + tid;
      ph[tid] = p < s.M ? (p / s.W) % s.H : -s.H - 4;
      pw[tid] = p % s.W;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < GR; ++r)
#pragma unroll
      for (int kl = tid / BM_ % GK; kl < BK; kl += GK) {  // unrolled: the loads in flight together
        const bool ok = (unsigned)(ph[kl] + gdy[r]) < (unsigned)s.H && (unsigned)(pw[kl] + gdx[r]) < (unsigned)s.W;
        As[kl][tid % BM_ + r * THREADS] = ok ? x[(size_t)(p0 + kl) * s.Cin + goff[r]] : 0.f;
      }
    for (int e = tid; e < BK * BN_; e += THREADS) {
      const int nl = e % BN_, kl = e / BN_, n = n0 + nl;
      Bs[kl][nl] = p0 + kl < s.M && n < s.Cout ? dy[(size_t)(p0 + kl) * s.Cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n >= s.Cout) continue;
      if (splits > 1)
        partial[((size_t)blockIdx.z * rows + m) * s.Cout + n] = acc[i][j];
      else
        out[(size_t)m * s.Cout + n] = acc[i][j];
    }
  }
}

struct Args {
  const void *x, *w, *bias;
  void *out, *partial;
};

// Split-K's second pass, after a split plan's kernel.
template <typename T = bf16>
void launch_reduce(const Args& a, const Shape& s, int splits, cudaStream_t stream) {
  if (splits == 1) return;
  const int mn = s.M * s.Cout;
  conv3x3_splitk_reduce<T><<<(mn + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(a.partial), static_cast<const T*>(a.bias), static_cast<T*>(a.out), splits,
      mn, s.Cout);
}

template <int NWG, int BN, int STAGES, bool NARROW>
cudaError_t launch_wgmma(const Args& a, const Shape& s, int splits, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma_kernel<NWG, BN, STAGES, NARROW>;
  // once per instantiation and device: allow the whole 227 KB a block may use
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t attr = hopper::allow_dynamic_smem(kernel, 232448, allowed);
  if (attr != cudaSuccess) return attr;
  const int k_tiles = 9 * s.Cin / SLICE;
  if (splits < 1 || splits > k_tiles || (splits > 1 && a.partial == nullptr)) return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes(NWG, BN, STAGES, NARROW, (k_tiles + splits - 1) / splits);
  if (smem > 232448) return cudaErrorInvalidValue;
  const dim3 grid((s.M + NWG * 64 - 1) / (NWG * 64), (s.Cout + BN - 1) / BN, splits);
  kernel<<<grid, NWG * 128, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w), static_cast<const bf16*>(a.bias),
      static_cast<bf16*>(a.out), static_cast<float*>(a.partial), s, splits);
  launch_reduce(a, s, splits, stream);
  return cudaGetLastError();
}

template <int MW, int BN, int STAGES>
cudaError_t launch_tma(const Args& a, const Shape& s, int splits, cudaStream_t stream) {
  auto kernel = conv3x3_tma_kernel<MW, BN, STAGES>;
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t attr = hopper::allow_dynamic_smem(kernel, 232448, allowed);
  if (attr != cudaSuccess) return attr;
  if (splits < 1 || splits > 9 * s.Cin / SLICE || (splits > 1 && a.partial == nullptr)) return cudaErrorInvalidValue;
  // x as (B, H, W, Cin) and the weight as (9 Cin, Cout), innermost first
  const cuuint64_t x_dims[4] = {(cuuint64_t)s.Cin, (cuuint64_t)s.W, (cuuint64_t)s.H, (cuuint64_t)s.B};
  const cuuint64_t x_strides[3] = {(cuuint64_t)s.Cin * 2, (cuuint64_t)s.W * s.Cin * 2,
                                   (cuuint64_t)s.H * s.W * s.Cin * 2};
  const cuuint32_t x_box[4] = {SLICE, TMA_W, 8 * MW, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)s.Cout, (cuuint64_t)s.K};
  const cuuint64_t w_strides[1] = {(cuuint64_t)s.Cout * 2};
  const cuuint32_t w_box[2] = {64, SLICE};
  CUtensorMap x_map, w_map;
  if (!hopper::encode_bf16_map(&x_map, a.x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_bf16_map(&w_map, a.w, 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const dim3 grid(s.B * ((s.H + 8 * MW - 1) / (8 * MW)) * ((s.W + TMA_W - 1) / TMA_W), s.Cout / BN, splits);
  kernel<<<grid, 384, tma_smem_bytes(128 * MW, BN, STAGES), stream>>>(
      x_map, w_map, static_cast<const bf16*>(a.bias), static_cast<bf16*>(a.out), static_cast<float*>(a.partial), s,
      splits);
  launch_reduce(a, s, splits, stream);
  return cudaGetLastError();
}

// tma_narrow: x as (B, H, W, Cin), boxes of 64 channels x 16 x 18 pixels
template <int STAGES>
cudaError_t launch_tma_narrow(const Args& a, const Shape& s, cudaStream_t stream) {
  auto kernel = conv3x3_tma_narrow_kernel<STAGES>;
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t attr = hopper::allow_dynamic_smem(kernel, 232448, allowed);
  if (attr != cudaSuccess) return attr;
  const size_t smem = tma_narrow_smem_bytes(STAGES, 9 * s.Cin / SLICE);
  if (smem > 232448) return cudaErrorInvalidValue;
  const cuuint64_t x_dims[4] = {(cuuint64_t)s.Cin, (cuuint64_t)s.W, (cuuint64_t)s.H, (cuuint64_t)s.B};
  const cuuint64_t x_strides[3] = {(cuuint64_t)s.Cin * 2, (cuuint64_t)s.W * s.Cin * 2,
                                   (cuuint64_t)s.H * s.W * s.Cin * 2};
  const cuuint32_t x_box[4] = {SLICE, TMA_W, NARROW_BOX_H, 1};
  CUtensorMap x_map;
  if (!hopper::encode_bf16_map(&x_map, a.x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  const cudaError_t got = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (got != cudaSuccess) return got;
  const int patches = s.B * ((s.H + NARROW_H - 1) / NARROW_H) * ((s.W + TMA_W - 1) / TMA_W);
  const dim3 grid(patches < sms ? patches : sms, (s.Cout + 7) / 8);  // one block per SM
  kernel<<<grid, 384, smem, stream>>>(x_map, static_cast<const bf16*>(a.w), static_cast<const bf16*>(a.bias),
                                      static_cast<bf16*>(a.out), s);
  return cudaGetLastError();
}

// slice32: x as (B, H, W, Cin), boxes of 32 channels x 16 x (PH + 2) pixels
// in the 64-byte swizzle; `blocks` persistent blocks (the planner's grid
// width: one per SM) over each Cout tile, each walking patches.
template <int MW, int BN, int STAGES>
cudaError_t launch_slice32(const Args& a, const Shape& s, int blocks, cudaStream_t stream) {
  auto kernel = conv3x3_slice32_kernel<MW, BN, STAGES>;
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t attr = hopper::allow_dynamic_smem(kernel, 232448, allowed);
  if (attr != cudaSuccess) return attr;
  if ((BN == 8 ? s.Cout >= 64 : s.Cout % BN != 0) || blocks < 1) return cudaErrorInvalidValue;
  const size_t smem = slice32_smem_bytes(MW, BN, STAGES, 9 * s.Cin / C32);
  if (smem > 232448) return cudaErrorInvalidValue;
  const cuuint64_t x_dims[4] = {(cuuint64_t)s.Cin, (cuuint64_t)s.W, (cuuint64_t)s.H, (cuuint64_t)s.B};
  const cuuint64_t x_strides[3] = {(cuuint64_t)s.Cin * 2, (cuuint64_t)s.W * s.Cin * 2,
                                   (cuuint64_t)s.H * s.W * s.Cin * 2};
  const cuuint32_t x_box[4] = {C32, TMA_W, 8 * MW + 2, 1};
  // the output as (B, H, W, Cout), boxes of 32 channels x 16 x PH pixels (BN = 32)
  const cuuint64_t y_dims[4] = {(cuuint64_t)s.Cout, (cuuint64_t)s.W, (cuuint64_t)s.H, (cuuint64_t)s.B};
  const cuuint64_t y_strides[3] = {(cuuint64_t)s.Cout * 2, (cuuint64_t)s.W * s.Cout * 2,
                                   (cuuint64_t)s.H * s.W * s.Cout * 2};
  const cuuint32_t y_box[4] = {BN, TMA_W, 8 * MW, 1};
  CUtensorMap x_map, y_map = {};
  if (!hopper::encode_bf16_map(&x_map, a.x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      (BN == 32 && !hopper::encode_bf16_map(&y_map, a.out, 4, y_dims, y_strides, y_box, CU_TENSOR_MAP_SWIZZLE_64B)))
    return cudaErrorInvalidValue;
  kernel<<<dim3(blocks, (s.Cout + BN - 1) / BN), 384, smem, stream>>>(x_map, y_map, static_cast<const bf16*>(a.w), static_cast<const bf16*>(a.bias),
                                      static_cast<bf16*>(a.out), s);
  return cudaGetLastError();
}

template <int NWG, int BN, int STAGES>
cudaError_t launch_tf32x3(const Args& a, const Shape& s, int splits, cudaStream_t stream) {
  auto kernel = conv3x3_tf32x3_kernel<NWG, BN, STAGES>;
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t attr = hopper::allow_dynamic_smem(kernel, 232448, allowed);
  if (attr != cudaSuccess) return attr;
  if (splits < 1 || splits > 9 * s.Cin / F32_SLICE || (splits > 1 && a.partial == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((s.M + NWG * 64 - 1) / (NWG * 64), (s.Cout + BN - 1) / BN, splits);
  kernel<<<grid, NWG * 128, tf32x3_smem_bytes(NWG, BN, STAGES), stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w), static_cast<const float*>(a.bias),
      static_cast<float*>(a.out), static_cast<float*>(a.partial), s, splits);
  launch_reduce<float>(a, s, splits, stream);
  return cudaGetLastError();
}

void launch_split(const float* src, float* split, int rows, int K, int cout, int flip, cudaStream_t stream) {
  conv3x3_tf32_split_weight<<<dim3(K / 32, (cout + 31) / 32), dim3(32, 8), 0, stream>>>(src, split, rows, K, cout,
                                                                                         flip);
}

// The weight gradient's "tf32x3" instances: BM = 128 rows of (9 Cin), BN
// of Cout, a ring of DW_STAGES stages of dy's split slices.
constexpr int DW_NWG = 2, DW_STAGES = 5;

__host__ __device__ constexpr size_t dw_tf32x3_smem_bytes(int bn, int stages) {
  return 1024 + (size_t)stages * 2 * bn * 128;
}

template <int BN>
cudaError_t launch_dw_tf32x3(const float* x, const float* dy, float* dyt, float* out, float* partial, const Shape& s,
                             int kp, int splits, cudaStream_t stream) {
  auto kernel = conv3x3_dw_tf32x3_kernel<DW_NWG, BN, DW_STAGES>;
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t attr = hopper::allow_dynamic_smem(kernel, 232448, allowed);
  if (attr != cudaSuccess) return attr;
  if (s.Cin % F32_SLICE || s.Cout % BN || kp % (DW_CHAIN * F32_SLICE) || kp < s.M || dyt == nullptr || splits < 1 ||
      splits > kp / (DW_CHAIN * F32_SLICE) || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  conv3x3_dw_split_dy<<<dim3(kp / 32, (s.Cout + 31) / 32), dim3(32, 8), 0, stream>>>(dy, dyt, s.M, kp, s.Cout);
  const dim3 grid((9 * s.Cin + DW_NWG * 64 - 1) / (DW_NWG * 64), s.Cout / BN, splits);
  kernel<<<grid, DW_NWG * 128, dw_tf32x3_smem_bytes(BN, DW_STAGES), stream>>>(x, dyt, out, partial, s, kp, splits);
  return cudaSuccess;
}

// "window": NN narrow channels (2, 4, 6 or 8: the narrow side's count
// rounded up to even); `splits` = B x strips x column groups blocks per 32
// wide channels.
template <int NN>
cudaError_t launch_dw_window(const float* x, const float* dy, float* out, float* partial, const Shape& s, int splits,
                             cudaStream_t stream) {
  const bool flip = s.Cin < s.Cout;
  const int cw = flip ? s.Cout : s.Cin, cn = flip ? s.Cin : s.Cout;
  const int per_strip = s.B * ((s.W + WIN_COLS - 1) / WIN_COLS);
  if (cn > NN || cn < NN - 1 || splits < per_strip || splits % per_strip || splits / per_strip > s.H ||
      (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((cw + WIN_CH - 1) / WIN_CH, splits);
  if (flip)
    conv3x3_dw_window_kernel<NN, true><<<grid, WIN_COLS * WIN_CH, 0, stream>>>(dy, x, out, partial, s,
                                                                                splits / per_strip);
  else
    conv3x3_dw_window_kernel<NN, false><<<grid, WIN_COLS * WIN_CH, 0, stream>>>(x, dy, out, partial, s,
                                                                                 splits / per_strip);
  return cudaSuccess;
}

cudaError_t launch_dw_generic(const float* x, const float* dy, float* out, float* partial, const Shape& s, int splits,
                              cudaStream_t stream) {
  if (splits < 1 || splits > (s.M + BK - 1) / BK || (splits > 1 && partial == nullptr)) return cudaErrorInvalidValue;
  const dim3 grid((9 * s.Cin + 63) / 64, (s.Cout + 63) / 64, splits);
  conv3x3_dw_f32_kernel<<<grid, THREADS, 0, stream>>>(x, dy, out, partial, s, splits);
  return cudaSuccess;
}

template <int VARIANT, int NWG, int BN, int STAGES>
cudaError_t launch_plan(const Args& a, const Shape& s, int splits, int blocks, cudaStream_t stream) {
  if constexpr (VARIANT == 3)  // bm = NWG * 64 = 128 MW: MW m64 blocks per consumer warpgroup
    return launch_tma<NWG / 2, BN, STAGES>(a, s, splits, stream);
  else if constexpr (VARIANT == 4)
    return splits == 1 ? launch_tma_narrow<STAGES>(a, s, stream) : cudaErrorInvalidValue;
  else if constexpr (VARIANT == 5)
    return launch_tf32x3<NWG, BN, STAGES>(a, s, splits, stream);
  else if constexpr (VARIANT == 6)  // bm = 128 MW
    return splits == 1 ? launch_slice32<NWG / 2, BN, STAGES>(a, s, blocks, stream) : cudaErrorInvalidValue;
  else
    return launch_wgmma<NWG, BN, STAGES, VARIANT == 2>(a, s, splits, stream);
}

void launch_generic(const Args& a, const Shape& s, int dtype, cudaStream_t stream) {
  const dim3 grid((s.M + BM - 1) / BM, (s.Cout + BN - 1) / BN);
  if (dtype == 0)
    conv3x3_f32_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(a.x), static_cast<const float*>(a.w), static_cast<const float*>(a.bias),
        static_cast<float*>(a.out), s);
  else
    conv3x3_bf16_wmma_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w), static_cast<const bf16*>(a.bias),
        static_cast<bf16*>(a.out), s);
}

}  // namespace

// The instantiated plans, (variant, BM / 64, BN, stages): variant 1 =
// wgmma, 2 = narrow, 3 = tma, 4 = tma_narrow, 5 = tf32x3, 6 = slice32.
// ops/conv3x3.py:INSTANCES lists the same.
#define CONV3X3_INSTANCES(X) \
  X(1, 2, 128, 4)            \
  X(1, 1, 64, 4)             \
  X(2, 2, 8, 5)              \
  X(2, 1, 8, 5)              \
  X(3, 2, 128, 4)            \
  X(3, 2, 256, 4)            \
  X(3, 4, 128, 4)            \
  X(4, 4, 8, 4)              \
  X(5, 3, 128, 4)            \
  X(5, 2, 128, 4)            \
  X(5, 1, 64, 4)             \
  X(5, 1, 8, 4)              \
  X(6, 2, 8, 8)              \
  X(6, 2, 32, 8)             \
  X(6, 4, 8, 6)              \
  X(6, 4, 32, 6)

// x: (B, H, W, Cin) contiguous; w: (3, 3, Cin, Cout) contiguous, or for
// tf32x3 the split weight (2, Cout, 9 Cin) that conv3x3_tf32_split made;
// bias: (Cout,) or null; out: (B, H, W, Cout); partial: f32 (splits, B*H*W,
// Cout) when splits > 1, else unused. dtype: 0 = float32, 1 = bfloat16.
// variant: 0 = generic (bm, bn, stages, splits ignored), 1 = wgmma, 2 =
// narrow, 3 = tma, 4 = tma_narrow (bf16 only; Cin % 64 == 0; wgmma and tma
// also Cout % bn == 0; tma_narrow unsplit), 5 = tf32x3 (f32 only; Cin % 32
// == 0; Cout % bn == 0, or Cout < 64 with bn = 8), 6 = slice32 (bf16
// only; Cin % 32 == 0; Cout % bn == 0, or Cout < 64 with bn = 8; unsplit;
// `blocks` persistent blocks per Cout tile, which the other variants
// ignore). Returns the cudaError_t of the launch (0 on success).
extern "C" int conv3x3_nhwc(const void* x, const void* w, const void* bias, void* out, void* partial,
                            int B, int H, int W, int Cin, int Cout, int dtype, int variant, int bm,
                            int bn, int stages, int splits, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Shape s;
  s.B = B;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.M = B * H * W;
  s.K = 9 * Cin;
  const Args a{x, w, bias, out, partial};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear an earlier error so the one returned is ours
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    launch_generic(a, s, dtype, st);
    return (int)cudaGetLastError();
  }
  if (variant == 5   ? dtype != 0 || Cin % F32_SLICE != 0 || (bn == 8 ? Cout >= 64 : Cout % bn != 0)
      : variant == 6 ? dtype != 1 || Cin % C32 != 0
                     : dtype != 1 || Cin % SLICE != 0 || (variant % 2 == 1 && Cout % bn != 0))
    return (int)cudaErrorInvalidValue;
#define CONV3X3_CASE(V, NWG, BN_, ST)                               \
  if (variant == V && bm == NWG * 64 && bn == BN_ && stages == ST) \
    return (int)launch_plan<V, NWG, BN_, ST>(a, s, splits, blocks, st);
  CONV3X3_INSTANCES(CONV3X3_CASE)
#undef CONV3X3_CASE
  return (int)cudaErrorInvalidValue;
}

// w: the float32 HWIO weight (3, 3, Cin, Cout), contiguous; split: (2, Cout,
// 9 Cin) float32, filled with the tf32x3 kernel's operand (hi, then lo; see
// conv3x3_tf32_split_weight). Cin % 32 == 0. With flip != 0, the operand
// of dx = conv(dy, w') instead: split is (2, Cin, 9 Cout) and Cout % 32 ==
// 0. Returns the cudaError_t of the launch.
extern "C" int conv3x3_tf32_split(const void* w, void* split, int Cin, int Cout, int flip, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();
  const int cin = flip ? Cout : Cin, cout = flip ? Cin : Cout;  // of the conv the operand serves
  if (cin % F32_SLICE != 0) return (int)cudaErrorInvalidValue;
  launch_split(static_cast<const float*>(w), static_cast<float*>(split), 9 * cin, 9 * cin, cout, flip,
               static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The weight gradient of the conv of x (B, H, W, Cin) that gave the output
// gradient dy (B, H, W, Cout), both float32 and contiguous: out (3, 3, Cin,
// Cout) float32. variant 5 = tf32x3 (Cin % 32 == 0, Cout % bn == 0, bn 32,
// 64 or 128; dyt: (2, Cout, kp) float32 scratch for dy's split copy, kp =
// B H W rounded up to a multiple of 32 DW_CHAIN = 128; splits <= kp / 128;
// x 8-byte aligned), 7 = window (min(Cin, Cout) <= 8, bn = that count
// rounded up to even; splits a multiple of B x ceil(W / 8), at most H times
// it), 0 = generic (bn 64: tiles of 64 x 64; dyt, kp unused). partial: f32
// (splits, 9 Cin, Cout) when splits > 1, else unused. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int conv3x3_dw(const void* x, const void* dy, void* dyt, void* out, void* partial, int B, int H, int W,
                          int Cin, int Cout, int variant, int bn, int splits, int kp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Shape s;
  s.B = B;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.M = B * H * W;
  s.K = 9 * Cin;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *dyf = static_cast<const float*>(dy);
  float *dytf = static_cast<float*>(dyt), *outf = static_cast<float*>(out), *pf = static_cast<float*>(partial);
  cudaGetLastError();
  if (variant == 5 && bn == 128)
    err = launch_dw_tf32x3<128>(xf, dyf, dytf, outf, pf, s, kp, splits, st);
  else if (variant == 5 && bn == 64)
    err = launch_dw_tf32x3<64>(xf, dyf, dytf, outf, pf, s, kp, splits, st);
  else if (variant == 5 && bn == 32)
    err = launch_dw_tf32x3<32>(xf, dyf, dytf, outf, pf, s, kp, splits, st);
  else if (variant == 7 && bn == 2)
    err = launch_dw_window<2>(xf, dyf, outf, pf, s, splits, st);
  else if (variant == 7 && bn == 4)
    err = launch_dw_window<4>(xf, dyf, outf, pf, s, splits, st);
  else if (variant == 7 && bn == 6)
    err = launch_dw_window<6>(xf, dyf, outf, pf, s, splits, st);
  else if (variant == 7 && bn == 8)
    err = launch_dw_window<8>(xf, dyf, outf, pf, s, splits, st);
  else if (variant == 0 && bn == 64)
    err = launch_dw_generic(xf, dyf, outf, pf, s, splits, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const int mn = 9 * Cin * Cout;
    conv3x3_dw_splitk_reduce<<<(mn + 255) / 256, 256, 0, st>>>(pf, outf, splits, mn);
  }
  return (int)cudaGetLastError();
}

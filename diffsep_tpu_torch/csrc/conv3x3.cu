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
// so the tensor cores, not HBM, set the floor; only the stem (Cin = 6) and
// the output convs (Cout = 6) are bound by bytes.
//
// The bf16 designs, chosen per shape by ops/conv3x3.py:plan_conv3x3 and
// dispatched here by (variant, BM, BN, stages). All walk K as (tap,
// 64-channel slice), so one A row of a slice is 64 contiguous channels of
// one neighbour pixel (128 bytes), and multiply with wgmma (m64nBNk16) from
// operands in the 128-byte swizzle (the weight MN-major through the
// transpose flag, or K-major in the narrow kernels' resident copy), f32
// accumulators in registers; the epilogue adds the bias and rounds once to
// bf16 from registers.
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
// Split-K (grid z = S > 1, "tma", "wgmma" and "narrow") serves the deep
// levels, where M-tiles x N-tiles is far below the 132 SMs: split z walks
// its own range of the (tap, slice) walk and writes an f32 partial tile; a
// second pass (conv3x3_splitk_reduce) sums the S partials in a fixed order,
// adds the bias and rounds. No atomics, so the result is bitwise
// deterministic.
//
// "generic" (f32, bf16 with Cin % 64 != 0 as the stem's Cin = 6, and
// operands not 16-byte aligned): each block computes a 64 x 64 output tile
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
// 4) + e) to the output, plus bias and rounded to bf16, or, when split, to
// split blockIdx.z's f32 partial. rows[h] < 0: no such output row.
template <int BN, bool NARROW>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], const int (&rows)[2], int n0, const Shape& s,
                                           const bf16* __restrict__ bias, bf16* __restrict__ out,
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
        bf16* dst = out + (size_t)row * s.Cout + col;
        const float b0 = bias && col < s.Cout ? __bfloat162float(bias[col]) : 0.f;
        const float b1 = bias && col + 1 < s.Cout ? __bfloat162float(bias[col + 1]) : 0.f;
        if (NARROW) {
          if (col < s.Cout) dst[0] = __float2bfloat16(v0 + b0);
          if (col + 1 < s.Cout) dst[1] = __float2bfloat16(v1 + b1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0 + b0, v1 + b1);
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

// Split-K's second pass: out = bf16(sum over z in order of partial[z] + bias).
__global__ void conv3x3_splitk_reduce(const float* __restrict__ partial, const bf16* __restrict__ bias,
                                      bf16* __restrict__ out, int splits, int mn, int cout) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < mn; e += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += partial[(size_t)z * mn + e];
    if (bias) v += __bfloat162float(bias[e % cout]);
    out[e] = __float2bfloat16(v);
  }
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

struct Args {
  const void *x, *w, *bias;
  void *out, *partial;
};

// Split-K's second pass, after a split plan's kernel.
void launch_reduce(const Args& a, const Shape& s, int splits, cudaStream_t stream) {
  if (splits == 1) return;
  const int mn = s.M * s.Cout;
  conv3x3_splitk_reduce<<<(mn + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(a.partial), static_cast<const bf16*>(a.bias), static_cast<bf16*>(a.out), splits,
      mn, s.Cout);
}

template <int NWG, int BN, int STAGES, bool NARROW>
cudaError_t launch_wgmma(const Args& a, const Shape& s, int splits, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma_kernel<NWG, BN, STAGES, NARROW>;
  // once per instantiation: allow the whole 227 KB a block may use
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
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
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
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
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
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

template <int VARIANT, int NWG, int BN, int STAGES>
cudaError_t launch_plan(const Args& a, const Shape& s, int splits, cudaStream_t stream) {
  if constexpr (VARIANT == 3)  // bm = NWG * 64 = 128 MW: MW m64 blocks per consumer warpgroup
    return launch_tma<NWG / 2, BN, STAGES>(a, s, splits, stream);
  else if constexpr (VARIANT == 4)
    return splits == 1 ? launch_tma_narrow<STAGES>(a, s, stream) : cudaErrorInvalidValue;
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

// The instantiated plans, (variant, BM, BN, stages): variant 1 = wgmma,
// 2 = narrow, 3 = tma, 4 = tma_narrow. ops/conv3x3.py:INSTANCES lists the
// same.
#define CONV3X3_INSTANCES(X) \
  X(1, 2, 128, 4)            \
  X(1, 1, 64, 4)             \
  X(2, 2, 8, 5)              \
  X(2, 1, 8, 5)              \
  X(3, 2, 128, 4)            \
  X(3, 2, 256, 4)            \
  X(3, 4, 128, 4)            \
  X(4, 4, 8, 4)

// x: (B, H, W, Cin) contiguous; w: (3, 3, Cin, Cout) contiguous; bias:
// (Cout,) or null; out: (B, H, W, Cout); partial: f32 (splits, B*H*W, Cout)
// when splits > 1, else unused. dtype: 0 = float32, 1 = bfloat16. variant:
// 0 = generic (bm, bn, stages, splits ignored), 1 = wgmma, 2 = narrow, 3 =
// tma, 4 = tma_narrow (bf16 only; Cin % 64 == 0; wgmma and tma also
// Cout % bn == 0; tma_narrow unsplit). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int conv3x3_nhwc(const void* x, const void* w, const void* bias, void* out, void* partial,
                            int B, int H, int W, int Cin, int Cout, int dtype, int variant, int bm,
                            int bn, int stages, int splits, int device, void* stream) {
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
  if (dtype != 1 || Cin % SLICE != 0 || (variant % 2 == 1 && Cout % bn != 0)) return (int)cudaErrorInvalidValue;
#define CONV3X3_CASE(V, NWG, BN_, ST)                               \
  if (variant == V && bm == NWG * 64 && bn == BN_ && stages == ST) \
    return (int)launch_plan<V, NWG, BN_, ST>(a, s, splits, st);
  CONV3X3_INSTANCES(CONV3X3_CASE)
#undef CONV3X3_CASE
  return (int)cudaErrorInvalidValue;
}

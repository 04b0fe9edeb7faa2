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
// What the design does about it: each block computes a 64 x 64 output tile
// and walks K in slices of 32. A slice of A is gathered straight from the
// unpadded input with predicated loads (the halo and the ragged edges read as
// zero, no padded copy is made), a slice of the weight is loaded beside it,
// both into shared memory, and the products accumulate in f32 registers.
// bf16 runs on the tensor cores through WMMA (16x16x16 mma.sync tiles, four
// warps of 2x2 tiles each); f32 runs on the CUDA cores with a 4x8 register
// tile per thread, so that an f32 call keeps full f32 products. Flattening
// K over (tap, channel) lets Cin = 6 use 54 of each 64 reduction lanes
// instead of 6 of 32. Not yet done (later work): cp.async/TMA double
// buffering, wgmma, vector loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

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

// bf16: tensor cores through WMMA. Four warps in a 2 x 2 grid, each owning
// a 32 x 32 quarter of the tile as 2 x 2 fragments of 16 x 16.
__global__ void __launch_bounds__(THREADS)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
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

template <typename T>
void launch(const void* x, const void* w, const void* bias, void* out, const Shape& s,
            cudaStream_t stream);

template <>
void launch<float>(const void* x, const void* w, const void* bias, void* out, const Shape& s,
                   cudaStream_t stream) {
  const dim3 grid((s.M + BM - 1) / BM, (s.Cout + BN - 1) / BN);
  conv3x3_f32_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), s);
}

template <>
void launch<bf16>(const void* x, const void* w, const void* bias, void* out, const Shape& s,
                  cudaStream_t stream) {
  const dim3 grid((s.M + BM - 1) / BM, (s.Cout + BN - 1) / BN);
  conv3x3_bf16_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), s);
}

}  // namespace

// x: (B, H, W, Cin) contiguous; w: (3, 3, Cin, Cout) contiguous; bias:
// (Cout,) or null; out: (B, H, W, Cout). dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int conv3x3_nhwc(const void* x, const void* w, const void* bias, void* out, int B,
                            int H, int W, int Cin, int Cout, int dtype, int device,
                            void* stream) {
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
  cudaGetLastError();  // clear an earlier error so the one returned is ours
  if (dtype == 0)
    launch<float>(x, w, bias, out, s, static_cast<cudaStream_t>(stream));
  else if (dtype == 1)
    launch<bf16>(x, w, bias, out, s, static_cast<cudaStream_t>(stream));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

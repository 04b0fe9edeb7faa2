// Factor-2 FIR resampling of NHWC tensors with a separable 4-tap filter:
//   down: decimation, upfirdn2d(x, outer(f, f), down=2, pad=(1, 1))
//   up:   interpolation, upfirdn2d(x, outer(f, f), up=2, pad=(2, 1))
// computed in f32, stored in the input's type. The taps arrive as kernel
// arguments, already flipped into convolution order.
//
// Replaces the Pallas TPU kernels diffsep_tpu/ops/pallas/upfirdn.py
// _down_kernel and _up_kernel (launched by _resample2x). Like them it uses
// the polyphase form: a down output needs 4 x 4 input taps, an up output
// 2 x 2, and no zero-inserted intermediate is ever built. Unlike them it
// takes every shape NCSN++ calls it with, C = 6 and odd widths included.
//
// What bounds it on the H100: bytes. It does 8-32 flops per output element
// against 2-4 bytes moved per element, far below the card's balance point,
// so the floor is reading the input once and writing the output once at
// the HBM rate.
//
// What the design does about it: threads run along C, the contiguous axis
// of NHWC, so every global load and store of a warp is coalesced. A block
// owns a tile of output rows x columns x a chunk of at most 64 channels; it
// stages the input rows and columns that tile needs, halo included, in
// shared memory once (zeros outside the image stand in for the padding),
// then each thread forms its outputs from shared memory with the H taps
// and W taps in registers. Neighbouring tiles re-read only their halos,
// which come from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

struct Taps {
  float y[4], x[4];
};

struct Geometry {
  int B, H, W, C, Ho, Wo;
  int TH, TW, CC;  // output tile: rows, columns, channels
};

template <typename T, bool kUp>
__global__ void __launch_bounds__(THREADS)
fir_resample2x_kernel(const T* __restrict__ x, T* __restrict__ out, Geometry g, Taps k) {
  extern __shared__ float tile[];  // [rows_in][cols_in][cc]
  const int n_chunks = (g.C + g.CC - 1) / g.CC;
  const int b = blockIdx.z / n_chunks;
  const int c0 = (blockIdx.z % n_chunks) * g.CC;
  const int cc = min(g.CC, g.C - c0);
  const int i0 = blockIdx.y * g.TH, j0 = blockIdx.x * g.TW;

  // input window of the tile, halo included (TH, TW, i0, j0 even for up)
  const int r0 = kUp ? i0 / 2 - 1 : 2 * i0 - 1;
  const int q0 = kUp ? j0 / 2 - 1 : 2 * j0 - 1;
  const int rows_in = kUp ? g.TH / 2 + 2 : 2 * g.TH + 2;
  const int cols_in = kUp ? g.TW / 2 + 2 : 2 * g.TW + 2;

  const int n_in = rows_in * cols_in * cc;
  for (int e = threadIdx.x; e < n_in; e += THREADS) {
    const int c = e % cc, t = e / cc;
    const int q = t % cols_in, r = t / cols_in;
    const int hh = r0 + r, ww = q0 + q;
    float v = 0.f;
    if (hh >= 0 && hh < g.H && ww >= 0 && ww < g.W)
      v = to_f32(x[(((size_t)b * g.H + hh) * g.W + ww) * g.C + c0 + c]);
    tile[e] = v;
  }
  __syncthreads();

  const int n_out = g.TH * g.TW * cc;
  for (int e = threadIdx.x; e < n_out; e += THREADS) {
    const int c = e % cc, t = e / cc;
    const int j = t % g.TW, i = t / g.TW;
    const int oi = i0 + i, oj = j0 + j;
    if (oi >= g.Ho || oj >= g.Wo) continue;
    float acc = 0.f;
    if (!kUp) {
      // out[oi] = sum_p fy[p] x[2 oi + p - 1]: tile row 2 i + p
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float* row = tile + ((2 * i + p) * cols_in + 2 * j) * cc + c;
        float hs = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) hs = fmaf(k.x[q], row[q * cc], hs);
        acc = fmaf(k.y[p], hs, acc);
      }
    } else {
      // out[2a + r] = f[r] x[a - 1 + r] + f[r + 2] x[a + r] on each axis
      const int ry = oi & 1, rx = oj & 1;
      const int tr = (oi >> 1) + ry - i0 / 2, tq = (oj >> 1) + rx - j0 / 2;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* row = tile + ((tr + p) * cols_in + tq) * cc + c;
        const float hs = fmaf(k.x[rx], row[0], k.x[rx + 2] * row[cc]);
        acc = fmaf(k.y[ry + 2 * p], hs, acc);
      }
    }
    out[(((size_t)b * g.Ho + oi) * g.Wo + oj) * g.C + c0 + c] = from_f32<T>(acc);
  }
}

// Shared memory of a block: the tile's input window, halo included.
size_t tile_bytes(bool up, int TH, int TW, int CC) {
  const int rows_in = up ? TH / 2 + 2 : 2 * TH + 2;
  const int cols_in = up ? TW / 2 + 2 : 2 * TW + 2;
  return (size_t)rows_in * cols_in * CC * sizeof(float);
}

// The first of these output tiles (rows, columns) whose input window fits
// the 48 KB of shared memory a block gets without opting in: ~2-8k outputs
// per block for any channel chunk of at most 64.
void pick_tile(bool up, Geometry& g) {
  static const int kDown[][2] = {{8, 32}, {4, 16}, {4, 8}, {2, 8}, {1, 8}, {1, 4}, {1, 2}};
  static const int kUp[][2] = {{16, 64}, {8, 16}, {4, 8}, {2, 4}, {2, 2}};
  const int(*tiles)[2] = up ? kUp : kDown;
  const int n = up ? 5 : 7;
  for (int i = 0; i < n; ++i) {
    g.TH = tiles[i][0];
    g.TW = tiles[i][1];
    if (tile_bytes(up, g.TH, g.TW, g.CC) <= 48 * 1024) return;
  }
}

template <typename T, bool kUp>
cudaError_t launch(const void* x, void* out, Geometry g, Taps k, cudaStream_t stream) {
  const size_t smem = tile_bytes(kUp, g.TH, g.TW, g.CC);
  const int n_chunks = (g.C + g.CC - 1) / g.CC;
  const dim3 grid((g.Wo + g.TW - 1) / g.TW, (g.Ho + g.TH - 1) / g.TH, g.B * n_chunks);
  fir_resample2x_kernel<T, kUp><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), g, k);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) contiguous; out: (B, Ho, Wo, C). up: 0 = decimate,
// 1 = interpolate. ky, kx: the 4 taps per axis in convolution order.
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int fir_resample2x_nhwc(const void* x, void* out, int B, int H, int W, int C, int Ho,
                                   int Wo, int up, float ky0, float ky1, float ky2, float ky3,
                                   float kx0, float kx1, float kx2, float kx3, int dtype,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear an earlier error so the one returned is ours
  Geometry g;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Ho = Ho;
  g.Wo = Wo;
  g.CC = C < 64 ? C : 64;
  pick_tile(up != 0, g);
  Taps k = {{ky0, ky1, ky2, ky3}, {kx0, kx1, kx2, kx3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)(up ? launch<float, true>(x, out, g, k, s) : launch<float, false>(x, out, g, k, s));
  if (dtype == 1) return (int)(up ? launch<bf16, true>(x, out, g, k, s) : launch<bf16, false>(x, out, g, k, s));
  return (int)cudaErrorInvalidValue;
}

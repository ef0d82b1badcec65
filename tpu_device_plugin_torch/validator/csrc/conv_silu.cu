// C1's ungated mode, Mamba-2's causal convolution, for Hopper (sm_90a),
// plain C entry points: for x (B, S, D) bf16, whose rows may lie a stride
// apart (a slice of a wider projection, read in place), taps w (K, D) and
// a bias (D) f32,
//
//     y[t] = bf16(silu(w[K-1] x[t] + sum_j<K-1 w[j] x[t-(K-1)+j] + bias))
//
// the sum and the SiLU in f32 (x is 0 before t = 0), and its gradient.
//
// Replaces no TPU kernel: the JAX package has no state-space layer. The
// port's `mamba` mixer (Granite-4.0-H's Mamba-2 layers,
// `short_conv.conv_silu`) brought it. It is C1's walk (csrc/short_conv.cu,
// LFM2's gated convolution) without the gates, in a library of its own so
// that the gated kernels' code stays as it was; the helpers below are
// short_conv.cu's.
//
// What bounds it on this card: bytes. A channel takes some ten FLOPs a
// token against 4 bytes read and written forward and 6 backward. The
// least traffic is x read once and y written once forward; x and dy read
// once and dx written once backward, plus the taps' and the bias's f32
// partials (K + 1 floats a channel a tile).
//
// - A thread owns 8 neighbouring channels (16-byte loads and stores) of a
//   tile of tokens of one sequence and walks it in order, with the last
//   K - 1 inputs (and, backward, the last K - 1 f32 gradients of the sum)
//   in registers; a tile recomputes its halo from x.
// - conv_silu_bwd_kernel recomputes the sum, g = dy silu'(sum) in f32,
//   dx[t] = bf16(sum_j g[t+(K-1)-j] w[j]) written dense, and each tile's
//   f32 sums of g x (the taps) and of g (the bias) to partials (tiles,
//   K + 1, D), which conv_silu_dw_kernel sums over the tiles in a fixed
//   order. No atomics: two runs give the same bits. Built for K = 4.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // a block's threads, each on kVec channels
constexpr int kVec = 8;         // bf16 channels in 16 bytes
constexpr int kRedCols = 32;    // conv_silu_dw_kernel: columns a block
constexpr int kRedRows = 8;     // and the tiles' interleave

// the 8 bf16 values of a 16-byte vector, widened exactly to f32 (the
// element at the lower address is the low half of each word)
__device__ __forceinline__ void widen8(const uint4& v, float (&x)[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float (&x)[kVec]) {
  return make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]),
                    pack2(x[6], x[7]));
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

template <int K>
__device__ __forceinline__ void load_taps(const float* __restrict__ w, int D,
                                          int c, float (&wk)[K][kVec]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < kVec; ++i) wk[j][i] = __ldg(w + j * D + c + i);
}

template <int K>
__device__ __forceinline__ void slide8(float (&win)[K - 1][kVec],
                                       const float (&now)[kVec]) {
#pragma unroll
  for (int j = 0; j < K - 2; ++j)
#pragma unroll
    for (int i = 0; i < kVec; ++i) win[j][i] = win[j + 1][i];
#pragma unroll
  for (int i = 0; i < kVec; ++i) win[K - 2][i] = now[i];
}

// w[K-1] x + sum_j w[j] past[j], in f32 in that order (not rounded)
template <int K>
__device__ __forceinline__ float conv_sum(const float (&wk)[K][kVec],
                                          const float (&past)[K - 1][kVec],
                                          float x, int i) {
  float acc = __fmul_rn(x, wk[K - 1][i]);
#pragma unroll
  for (int j = 0; j < K - 1; ++j) acc = __fmaf_rn(past[j][i], wk[j][i], acc);
  return acc;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// grid (channel blocks, tiles of a sequence, sequences); x rows ldx apart
template <int K>
__global__ void __launch_bounds__(kThreads)
conv_silu_fwd_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int S, int D, int tile) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= D) return;
  const int t0 = blockIdx.y * tile;
  const int t1 = min(t0 + tile, S);
  const long long first = static_cast<long long>(blockIdx.z) * S;
  const __nv_bfloat16* in = x + first * ldx + c;
  __nv_bfloat16* out = y + first * D + c;

  float wk[K][kVec], bk[kVec];
  load_taps<K>(w, D, c, wk);
#pragma unroll
  for (int i = 0; i < kVec; ++i) bk[i] = __ldg(bias + c + i);
  float past[K - 1][kVec] = {};   // x[t-(K-1)+j]; 0 before the sequence
  for (int p = max(t0 - (K - 1), 0); p < t0; ++p) {
    float v[kVec];
    widen8(load16(in + p * ldx), v);
    slide8<K>(past, v);
  }
  for (int t = t0; t < t1; ++t) {
    float v[kVec], o[kVec];
    widen8(load16(in + t * ldx), v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float s = conv_sum<K>(wk, past, v[i], i) + bk[i];
      o[i] = s * sigmoid(s);
    }
    store16(out + static_cast<long long>(t) * D, pack8(o));
    slide8<K>(past, v);
  }
}

// grid (channel blocks, tiles of a sequence, sequences); writes dx rows
// [q0, q1) of the tile and its partials at partials[tile][j][c], j <= K
// (the bias's last)
template <int K>
__global__ void __launch_bounds__(kThreads)
conv_silu_bwd_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ dy,
                     __nv_bfloat16* __restrict__ dx,
                     float* __restrict__ partials, int S, int D, int tile) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= D) return;
  const int q0 = blockIdx.y * tile;
  const int q1 = min(q0 + tile, S);
  const long long first = static_cast<long long>(blockIdx.z) * S;
  const __nv_bfloat16* in = x + first * ldx + c;
  const __nv_bfloat16* grad = dy + first * D + c;
  __nv_bfloat16* out = dx + first * D + c;

  float wk[K][kVec], bk[kVec];
  load_taps<K>(w, D, c, wk);
#pragma unroll
  for (int i = 0; i < kVec; ++i) bk[i] = __ldg(bias + c + i);
  // at step p, j < K - 1: past[j] = x[p-(K-1)+j], gpast[j] = g[same]
  float past[K - 1][kVec] = {}, gpast[K - 1][kVec] = {};
  float dw[K + 1][kVec] = {};

  // p runs over the tile with K - 1 tokens of halo on either side: x
  // before q0, g after q1 (0 past the sequence's end). dx[q] is complete
  // at p = q + K - 1.
  const int p_end = q1 + K - 1;
  for (int p = max(q0 - (K - 1), 0); p < p_end; ++p) {
    float v[kVec] = {}, g[kVec] = {};
    if (p < S) widen8(load16(in + p * ldx), v);
    if (p >= q0 && p < S) {
      float d[kVec];
      widen8(load16(grad + static_cast<long long>(p) * D), d);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float s = conv_sum<K>(wk, past, v[i], i) + bk[i];
        const float sg = sigmoid(s);
        g[i] = d[i] * (sg * (1.f + s * (1.f - sg)));
      }
      if (p < q1) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          dw[K - 1][i] = __fmaf_rn(g[i], v[i], dw[K - 1][i]);
#pragma unroll
          for (int j = 0; j < K - 1; ++j)
            dw[j][i] = __fmaf_rn(g[i], past[j][i], dw[j][i]);
          dw[K][i] += g[i];
        }
      }
    }
    const int q = p - (K - 1);
    if (q >= q0) {
      // dx[q] = sum_j g[q+(K-1)-j] w[j]: g[q+m] is gpast[m] for m < K - 1
      // and g for m = K - 1
      float o[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float acc = __fmul_rn(gpast[0][i], wk[K - 1][i]);
        acc = __fmaf_rn(g[i], wk[0][i], acc);
#pragma unroll
        for (int j = 1; j < K - 1; ++j)
          acc = __fmaf_rn(gpast[K - 1 - j][i], wk[j][i], acc);
        o[i] = acc;
      }
      store16(out + static_cast<long long>(q) * D, pack8(o));
    }
    slide8<K>(past, v);
    slide8<K>(gpast, g);
  }

  float* part =
      partials +
      (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * (K + 1) *
          D +
      c;
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    float4* dst = reinterpret_cast<float4*>(part + j * D);
    dst[0] = make_float4(dw[j][0], dw[j][1], dw[j][2], dw[j][3]);
    dst[1] = make_float4(dw[j][4], dw[j][5], dw[j][6], dw[j][7]);
  }
}

// dw[col] = the sum over tiles n of partials[n][col], col < cols = (K + 1)
// D: the block's kRedRows rows each sum the tiles n = row mod kRedRows in
// order, then row 0 sums the rows in order (short_conv.cu's conv_dw_kernel)
__global__ void __launch_bounds__(kRedCols * kRedRows)
conv_silu_dw_kernel(const float* __restrict__ partials,
                    float* __restrict__ dw, int tiles, int cols) {
  __shared__ float rows[kRedRows][kRedCols];
  const int lane = threadIdx.x % kRedCols, r = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + lane;
  float acc = 0.f;
  if (col < cols) {
#pragma unroll 4
    for (int n = r; n < tiles; n += kRedRows)
      acc += __ldg(partials + static_cast<long long>(n) * cols + col);
  }
  rows[r][lane] = acc;
  __syncthreads();
  if (r == 0 && col < cols) {
    float sum = rows[0][lane];
#pragma unroll
    for (int i = 1; i < kRedRows; ++i) sum += rows[i][lane];
    dw[col] = sum;
  }
}

bool shape_ok(int B, int S, int D, int tile) {
  return B > 0 && S > 0 && D > 0 && D % kVec == 0 && tile > 0 &&
         B <= 65535 && (S + tile - 1) / tile <= 65535 &&
         1LL * B * S * D < (1LL << 31);
}

dim3 grid_of(int B, int S, int D, int tile) {
  return dim3((D / kVec + kThreads - 1) / kThreads, (S + tile - 1) / tile, B);
}

}  // namespace

// x: bf16 rows of D channels, row t of sequence b at x + (b S + t) ldx,
// 16-byte aligned, ldx a multiple of 8; w: f32 (K, D) and bias: f32 (D)
// contiguous; y: bf16 (B, S, D) contiguous, written. K = 4, D a multiple
// of 8. Returns a cudaError_t (0: launched).
extern "C" int conv_silu_fwd(const void* x, long long ldx, const void* w,
                             const void* bias, void* y, int B, int S, int D,
                             int K, int tile, void* stream) {
  if (!shape_ok(B, S, D, tile) || K != 4 || ldx < D || ldx % kVec ||
      (ldx * B * S) >= (1LL << 40))
    return cudaErrorInvalidValue;
  conv_silu_fwd_kernel<4><<<grid_of(B, S, D, tile), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), S, D,
      tile);
  return cudaGetLastError();
}

// As conv_silu_fwd for x, w and bias; dy: bf16 (B, S, D) contiguous,
// 16-byte aligned; dx: bf16 (B, S, D), written whole; partials: f32
// (B ceil(S / tile), K + 1, D), scratch; dwb: f32 (K + 1, D), the taps'
// gradient then the bias's, written.
extern "C" int conv_silu_bwd(const void* x, long long ldx, const void* w,
                             const void* bias, const void* dy, void* dx,
                             void* partials, void* dwb, int B, int S, int D,
                             int K, int tile, void* stream) {
  if (!shape_ok(B, S, D, tile) || K != 4 || ldx < D || ldx % kVec ||
      (ldx * B * S) >= (1LL << 40))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  conv_silu_bwd_kernel<4><<<grid_of(B, S, D, tile), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(partials), S, D,
      tile);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = B * ((S + tile - 1) / tile), cols = (K + 1) * D;
  conv_silu_dw_kernel<<<(cols + kRedCols - 1) / kRedCols,
                        kRedCols * kRedRows, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(dwb), tiles,
      cols);
  return cudaGetLastError();
}

// LFM2's gated short convolution for Hopper (sm_90a), plain C entry points:
// y = C * conv(B * h) from the conv projection's output bch = [B | C | h]
// (b, s, 3d) bf16 and the taps w (K, d) f32, and its gradient.
//
// Replaces no TPU kernel. The JAX package has no short convolution: the
// port's hybrid block (LFM2-8B-A1B, `workload._short_conv`) brought it,
// and ran it as a composition of PyTorch passes (the chunk's strided
// views, the two gates, one f32 `addcmul_` a tap, the casts, and in the
// backward the same again plus a product and a reduction a tap and the
// chunk's concatenation), saving u = B h and mixed = conv(u) for the
// backward: some 4.5 GB of traffic a layer at 2 x 8192 x 2048.
//
// What bounds it on this card: bytes. A channel takes some ten FLOPs a
// token against 8 bytes read and written forward and 14 backward, far under
// the H100's ~295 FLOP/byte ridge. The least traffic is bch read once and
// y written once forward; bch and dy read once and dbch written once
// backward. These kernels move that, plus K - 1 tokens of halo a tile and
// the backward's f32 tap partials (K d floats a tile):
//
// - A thread owns 8 neighbouring channels (16-byte loads and stores,
//   neighbouring threads on neighbouring channels) of one tile of tokens
//   of one sequence, and walks the tile in order, with the last K - 1
//   values of u (and, backward, of dmixed, B and h) in registers. It loads
//   the next kBatch tokens before it computes any of them, to keep bytes in
//   flight. A tile recomputes its halo from bch: u before the tile
//   (forward and backward), dmixed after it (backward). u is 0 before
//   each sequence and dmixed 0 after it: nothing crosses the batch.
// - conv_fwd_kernel: u = bf16(B h); mixed = bf16(w[K-1] u[t] + sum_j
//   w[j] u[t-(K-1)+j]) in f32 in that order; y = bf16(C mixed).
// - conv_bwd_kernel recomputes u and mixed, then dmixed = bf16(dy C), dC =
//   bf16(dy mixed), du[t] = bf16(dmixed[t] w[K-1] + sum_j dmixed[t+(K-1)-j]
//   w[j]), dB = bf16(du h), dh = bf16(du B), written straight into dbch's
//   (b, s, 3d) layout; each tap's f32 sum of the bf16 products
//   dmixed[t+(K-1)-j] u[t] over the tile goes to partials (tiles, K, d).
// - conv_dw_kernel sums the partials over the tiles in a fixed order. No
//   atomics: two runs give the same bits.
//
// The roundings are those of the PyTorch composition; products of two bf16
// values are exact in f32, so only the f32 sums' order differs from it.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // a block's threads, each on kVec channels
constexpr int kVec = 8;         // bf16 channels in 16 bytes
constexpr int kBatch = 4;       // tokens loaded before any is computed
                                // (backward at K 4: 2, to fit registers)
constexpr int kRedCols = 32;    // conv_dw_kernel: columns a block
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// mixed[t] = bf16(w[K-1] u[t] + sum_j w[j] u[t-(K-1)+j]), past[j] holding
// u[t-(K-1)+j]
template <int K>
__device__ __forceinline__ float mix(const float (&wk)[K][kVec],
                                     const float (&past)[K - 1][kVec],
                                     float u, int i) {
  float acc = __fmul_rn(u, wk[K - 1][i]);
#pragma unroll
  for (int j = 0; j < K - 1; ++j) acc = __fmaf_rn(past[j][i], wk[j][i], acc);
  return bf16_round(acc);
}

// Slides a window of the last K - 1 values on by one: win[K-2] = now.
template <int K, typename T>
__device__ __forceinline__ void slide(T (&win)[K - 1], const T& now) {
#pragma unroll
  for (int j = 0; j < K - 2; ++j) win[j] = win[j + 1];
  win[K - 2] = now;
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

// grid (channel blocks, tiles of a sequence, sequences)
template <int K>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const __nv_bfloat16* __restrict__ bch,
                const float* __restrict__ w, __nv_bfloat16* __restrict__ y,
                int S, int D, int tile) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= D) return;
  const long long row = 3LL * D;
  const int t0 = blockIdx.y * tile;
  const int t1 = min(t0 + tile, S);
  const long long first = static_cast<long long>(blockIdx.z) * S;
  const __nv_bfloat16* in = bch + first * row + c;
  __nv_bfloat16* out = y + first * D + c;

  float wk[K][kVec];
  load_taps<K>(w, D, c, wk);
  float past[K - 1][kVec] = {};   // u[t-(K-1)+j]; 0 before the sequence
  for (int p = max(t0 - (K - 1), 0); p < t0; ++p) {
    float b[kVec], h[kVec], u[kVec];
    widen8(load16(in + p * row), b);
    widen8(load16(in + p * row + 2 * D), h);
#pragma unroll
    for (int i = 0; i < kVec; ++i) u[i] = bf16_round(b[i] * h[i]);
    slide8<K>(past, u);
  }

  for (int tb = t0; tb < t1; tb += kBatch) {
    uint4 vb[kBatch], vc[kBatch], vh[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (tb + k < t1) {
        const __nv_bfloat16* r = in + (tb + k) * row;
        vb[k] = load16(r);
        vc[k] = load16(r + D);
        vh[k] = load16(r + 2 * D);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (tb + k < t1) {
        float b[kVec], cg[kVec], h[kVec], u[kVec], o[kVec];
        widen8(vb[k], b);
        widen8(vc[k], cg);
        widen8(vh[k], h);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          u[i] = bf16_round(b[i] * h[i]);
          o[i] = cg[i] * mix<K>(wk, past, u[i], i);
        }
        store16(out + static_cast<long long>(tb + k) * D, pack8(o));
        slide8<K>(past, u);
      }
    }
  }
}

// grid (channel blocks, tiles of a sequence, sequences); writes dbch rows
// [q0, q1) of the tile and its tap partials at partials[tile][j][c]
template <int K>
__global__ void __launch_bounds__(kThreads)
conv_bwd_kernel(const __nv_bfloat16* __restrict__ bch,
                const float* __restrict__ w,
                const __nv_bfloat16* __restrict__ dy,
                __nv_bfloat16* __restrict__ dbch,
                float* __restrict__ partials, int S, int D, int tile) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= D) return;
  const long long row = 3LL * D;
  const int q0 = blockIdx.y * tile;
  const int q1 = min(q0 + tile, S);
  const long long first = static_cast<long long>(blockIdx.z) * S;
  const __nv_bfloat16* in = bch + first * row + c;
  const __nv_bfloat16* grad = dy + first * D + c;
  __nv_bfloat16* out = dbch + first * row + c;

  float wk[K][kVec];
  load_taps<K>(w, D, c, wk);
  // at step p, j < K - 1: past[j] = u[p-(K-1)+j], dpast[j] = dmixed[same],
  // bpast[j], hpast[j] = B, h there (raw); u 0 before the sequence
  float past[K - 1][kVec] = {}, dpast[K - 1][kVec] = {};
  uint4 bpast[K - 1] = {}, hpast[K - 1] = {};
  float dw[K][kVec] = {};

  // p runs over the tile with K - 1 tokens of halo on either side: u
  // before q0, dmixed after q1 (0 past the sequence's end). du[q] is
  // complete at p = q + K - 1.
  constexpr int batch = K < 4 ? kBatch : kBatch / 2;
  const int p_end = q1 + K - 1;
  for (int pb = max(q0 - (K - 1), 0); pb < p_end; pb += batch) {
    uint4 vb[batch], vc[batch], vh[batch], vg[batch];
#pragma unroll
    for (int k = 0; k < batch; ++k) {
      const int p = pb + k;
      const __nv_bfloat16* r = in + p * row;
      vb[k] = vh[k] = vc[k] = vg[k] = make_uint4(0, 0, 0, 0);
      if (p < q1) {
        vb[k] = load16(r);
        vh[k] = load16(r + 2 * D);
      }
      if (p >= q0 && p < min(p_end, S)) {
        vc[k] = load16(r + D);
        vg[k] = load16(grad + static_cast<long long>(p) * D);
      }
    }
#pragma unroll
    for (int k = 0; k < batch; ++k) {
      const int p = pb + k;
      if (p >= p_end) break;
      float b[kVec], cg[kVec], h[kVec], g[kVec], u[kVec], dm[kVec];
      widen8(vb[k], b);
      widen8(vc[k], cg);
      widen8(vh[k], h);
      widen8(vg[k], g);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        u[i] = bf16_round(b[i] * h[i]);   // 0 past q1: B, h not loaded
        dm[i] = bf16_round(g[i] * cg[i]); // 0 before q0 and past S
      }
      if (p >= q0 && p < q1) {
        float dc[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          dc[i] = g[i] * mix<K>(wk, past, u[i], i);
          dw[K - 1][i] += bf16_round(dm[i] * u[i]);
#pragma unroll
          for (int j = 0; j < K - 1; ++j)
            dw[j][i] += bf16_round(dm[i] * past[j][i]);
        }
        store16(out + p * row + D, pack8(dc));
      }
      const int q = p - (K - 1);
      if (q >= q0) {
        // du[q] = dmixed[q] w[K-1] + sum_j dmixed[q+(K-1)-j] w[j], where
        // dmixed[q+m] is dpast[m] for m < K - 1 and dm for m = K - 1
        float hq[kVec], bq[kVec], db[kVec], dh[kVec];
        widen8(hpast[0], hq);
        widen8(bpast[0], bq);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float du = __fmul_rn(dpast[0][i], wk[K - 1][i]);
          du = __fmaf_rn(dm[i], wk[0][i], du);
#pragma unroll
          for (int j = 1; j < K - 1; ++j)
            du = __fmaf_rn(dpast[K - 1 - j][i], wk[j][i], du);
          du = bf16_round(du);
          db[i] = du * hq[i];
          dh[i] = du * bq[i];
        }
        __nv_bfloat16* r = out + static_cast<long long>(q) * row;
        store16(r, pack8(db));
        store16(r + 2 * D, pack8(dh));
      }
      slide8<K>(past, u);
      slide8<K>(dpast, dm);
      slide<K>(bpast, vb[k]);
      slide<K>(hpast, vh[k]);
    }
  }

  float* part = partials
      + (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * K * D
      + c;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float4* dst = reinterpret_cast<float4*>(part + j * D);
    dst[0] = make_float4(dw[j][0], dw[j][1], dw[j][2], dw[j][3]);
    dst[1] = make_float4(dw[j][4], dw[j][5], dw[j][6], dw[j][7]);
  }
}

// dw[col] = the sum over tiles n of partials[n][col], col < cols = K D: the
// block's kRedRows rows each sum the tiles n = row mod kRedRows in order,
// then row 0 sums the rows in order.
__global__ void __launch_bounds__(kRedCols * kRedRows)
conv_dw_kernel(const float* __restrict__ partials, float* __restrict__ dw,
               int tiles, int cols) {
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
         3LL * B * S * D < (1LL << 31);
}

dim3 grid_of(int B, int S, int D, int tile) {
  return dim3((D / kVec + kThreads - 1) / kThreads, (S + tile - 1) / tile, B);
}

template <int K>
void launch_fwd(const void* bch, const void* w, void* y, int B, int S, int D,
                int tile, cudaStream_t stream) {
  conv_fwd_kernel<K><<<grid_of(B, S, D, tile), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(bch), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(y), S, D, tile);
}

template <int K>
void launch_bwd(const void* bch, const void* w, const void* dy, void* dbch,
                void* partials, int B, int S, int D, int tile,
                cudaStream_t stream) {
  conv_bwd_kernel<K><<<grid_of(B, S, D, tile), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(bch), static_cast<const float*>(w),
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dbch), static_cast<float*>(partials), S, D,
      tile);
}

}  // namespace

// bch: bf16 (B, S, 3D) contiguous, 16-byte aligned; w: f32 (K, D)
// contiguous; y: bf16 (B, S, D) contiguous, written. K in 2..4, D a
// multiple of 8. Returns a cudaError_t (0: launched).
extern "C" int conv_fwd(const void* bch, const void* w, void* y, int B,
                        int S, int D, int K, int tile, void* stream) {
  if (!shape_ok(B, S, D, tile)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: launch_fwd<2>(bch, w, y, B, S, D, tile, st); break;
    case 3: launch_fwd<3>(bch, w, y, B, S, D, tile, st); break;
    case 4: launch_fwd<4>(bch, w, y, B, S, D, tile, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// As conv_fwd for bch and w; dy: bf16 (B, S, D) contiguous, 16-byte
// aligned; dbch: bf16 (B, S, 3D), written whole; partials: f32
// (B ceil(S / tile), K, D), scratch; dw: f32 (K, D), written.
extern "C" int conv_bwd(const void* bch, const void* w, const void* dy,
                        void* dbch, void* partials, void* dw, int B, int S,
                        int D, int K, int tile, void* stream) {
  if (!shape_ok(B, S, D, tile)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: launch_bwd<2>(bch, w, dy, dbch, partials, B, S, D, tile, st); break;
    case 3: launch_bwd<3>(bch, w, dy, dbch, partials, B, S, D, tile, st); break;
    case 4: launch_bwd<4>(bch, w, dy, dbch, partials, B, S, D, tile, st); break;
    default: return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = B * ((S + tile - 1) / tile), cols = K * D;
  conv_dw_kernel<<<(cols + kRedCols - 1) / kRedCols, kRedCols * kRedRows, 0,
                   st>>>(static_cast<const float*>(partials),
                         static_cast<float*>(dw), tiles, cols);
  return cudaGetLastError();
}

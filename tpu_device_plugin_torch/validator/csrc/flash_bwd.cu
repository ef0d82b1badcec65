// Flash-attention backward for Hopper (sm_90a), plain C entry point.
//
// Replaces the two Pallas TPU backward kernels of
// tpu_device_plugin/validator/flash_attention.py, launched by
// `_flash_bwd_3d` (:273):
// - `_flash_bwd_dkv_kernel` (:196) -> flash_bwd_dkv_kernel (K2): per key
//   tile, over the query tiles at or below the diagonal,
//   P = exp(Q K^T * scale - lse), dV += P^T dO, dP = dO V^T,
//   dS = P * (dP - D) * scale, dK += dS^T Q;
// - `_flash_bwd_dq_kernel` (:236) -> flash_bwd_dq_kernel (K3): per query
//   tile, over the key tiles up to the diagonal, the same dS, dQ += dS K.
// D = rowsum(dO * O) is computed by the caller, in f32, from the saved
// output, as the TPU version does (:286-290). q, k, v, dO are contiguous
// (hb, seq, d); lse and D are f32 (hb, seq).
//
// What bounds it on this card: at the training shape (hb 128, seq 2048,
// d 128, bf16, causal) K2 does 8 d FLOPs per causal pair (~275 GFLOP)
// against ~0.40 GB of traffic, K3 6 d (~206 GFLOP) against ~0.34 GB: both
// are bound by operations, which only the tensor cores reach. This first
// version is simple and exact, like flash_fwd.cu: f32 tiles in shared
// memory, scalar f32 FMAs, 4 x 4 register tiles per thread. Tensor cores,
// bf16 tiles and pipelining come later.
//
// Design against the TPU version:
// - The TPU grids carry the f32 accumulators across a sequential third
//   axis in VMEM scratch. Here one block owns one (key tile, hb) pair for
//   K2 and one (query tile, hb) pair for K3, loops over the other tiles
//   itself, and keeps its accumulators in registers. The two-pass shape
//   is kept: no atomics on dQ, so the result is deterministic.
// - Pallas pads ragged tails with garbage and the TPU kernel masks P and
//   dS explicitly. Here every load is masked at `seq` (padded rows load as
//   zero, padded lse and D as zero) and P and dS are set to 0 outside the
//   valid (row < seq, col < seq, causal) region, never left to
//   exp(-1e30 - lse); stores are masked at `seq`.
// - The TPU kernel rounds P and dS to the input dtype before the dV, dK
//   and dQ products; here they stay f32.
// - Outputs are written in the input dtype or in f32 (`out_dtype`, a
//   template parameter, so the stores do not branch), so the ring path's
//   f32 partials from bf16 inputs need no other kernel (:277-280).
// - At d = 128 K2's tiles take 170 KB and K3's 153 KB of shared memory:
//   dynamic shared memory, raised with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;         // rows per query or key tile
constexpr int NT = 256;        // threads: a 16 x 16 grid, 4 x 4 outputs each

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename O> __device__ __forceinline__ O from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row strides in floats. D + 4 keeps rows 16-byte aligned for float4 reads
// and spreads a quarter-warp's 8 rows over distinct bank groups.
template <int D> struct Smem {
  static constexpr int LD = D + 4;
  static constexpr int LP = BT + 4;
  // K2: k, v, q, dO tiles; P^T and dS^T tiles; lse and D rows
  static constexpr size_t DKV_BYTES =
      sizeof(float) * (4 * BT * LD + 2 * BT * LP + 2 * BT);
  // K3: q, dO, k, v tiles; the dS tile; lse and D rows
  static constexpr size_t DQ_BYTES =
      sizeof(float) * (4 * BT * LD + BT * LP + 2 * BT);
};

// Copies rows [r0, r0 + BT) of a (seq, D) slab into shared memory as f32
// with row stride `ld`; rows at or past `seq` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int r0, int seq) {
  for (int e = threadIdx.x; e < BT * D; e += NT) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * ld + c] = row < seq ? to_f32(src[(size_t)row * D + c]) : 0.f;
  }
}

// Entries [r0, r0 + BT) of one f32 row vector; zero past `seq`.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int seq) {
  for (int r = threadIdx.x; r < BT; r += NT)
    dst[r] = r0 + r < seq ? src[r0 + r] : 0.f;
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d], both with stride ld
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a,
                                         const float* b, int ld, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * ld + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * ld + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// P and dS of one (query tile q0, key tile k0) pair for query rows
// ty + 16 i and key columns tx + 16 j, zero outside the valid region.
// The returned p and ds alias the S and dP accumulators.
template <int D>
__device__ __forceinline__ void p_ds(float (&p)[4][4], float (&ds)[4][4],
                                     const float* sq, const float* sdo,
                                     const float* sk, const float* sv,
                                     const float* slse, const float* sdi,
                                     int q0, int k0, int seq, int causal,
                                     float scale, int ty, int tx) {
  constexpr int LD = Smem<D>::LD;
  tile_dot<D>(p, sq, sk, LD, ty, tx);    // S
  tile_dot<D>(ds, sdo, sv, LD, ty, tx);  // dP
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool ok = row < seq && col < seq && (!causal || col <= row);
      const float pv = ok ? expf(p[i][j] * scale - slse[r]) : 0.f;
      ds[i][j] = ok ? pv * (ds[i][j] - sdi[r]) * scale : 0.f;
      p[i][j] = pv;
    }
  }
}

template <typename T, typename O, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, O* __restrict__ dk,
                     O* __restrict__ dv, int seq, int causal, float scale) {
  using S = Smem<D>;
  constexpr int LD = S::LD, LP = S::LP, CD = D / 16;
  extern __shared__ float4 smem_f4[];
  float* sk = reinterpret_cast<float*>(smem_f4);   // BT x LD
  float* sv = sk + BT * LD;                         // BT x LD
  float* sq = sv + BT * LD;                         // BT x LD
  float* sdo = sq + BT * LD;                        // BT x LD
  float* spt = sdo + BT * LD;                       // P^T: key rows, BT x LP
  float* sdst = spt + BT * LP;                      // dS^T: BT x LP
  float* slse = sdst + BT * LP;                     // BT
  float* sdi = slse + BT;                           // BT

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BT;   // causal: tile 0 has the most work
  const size_t slab = (size_t)blockIdx.y * seq * D;
  q += slab; k += slab; v += slab; dout += slab;
  lse += (size_t)blockIdx.y * seq;
  di += (size_t)blockIdx.y * seq;

  load_tile<T, D>(sk, LD, k, k0, seq);
  load_tile<T, D>(sv, LD, v, k0, seq);

  // this thread owns key rows ty + 16 i and columns tx + 16 c
  float adk[4][CD], adv[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) adk[i][c] = adv[i][c] = 0.f;

  const int num_q = (seq + BT - 1) / BT;
  for (int qt = causal ? blockIdx.x : 0; qt < num_q; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D>(sq, LD, q, q0, seq);
    load_tile<T, D>(sdo, LD, dout, q0, seq);
    load_vec(slse, lse, q0, seq);
    load_vec(sdi, di, q0, seq);
    __syncthreads();

    float p[4][4], ds[4][4];
    p_ds<D>(p, ds, sq, sdo, sk, sv, slse, sdi, q0, k0, seq, causal, scale,
            ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        spt[(tx + 16 * j) * LP + ty + 16 * i] = p[i][j];
        sdst[(tx + 16 * j) * LP + ty + 16 * i] = ds[i][j];
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's query rows
#pragma unroll 2
    for (int r = 0; r < BT; r += 4) {
      float4 pt[4], dt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = *reinterpret_cast<const float4*>(&spt[(ty + 16 * i) * LP + r]);
        dt[i] = *reinterpret_cast<const float4*>(&sdst[(ty + 16 * i) * LP + r]);
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int col = tx + 16 * c;
        const float o0 = sdo[(r + 0) * LD + col], o1 = sdo[(r + 1) * LD + col];
        const float o2 = sdo[(r + 2) * LD + col], o3 = sdo[(r + 3) * LD + col];
        const float a0 = sq[(r + 0) * LD + col], a1 = sq[(r + 1) * LD + col];
        const float a2 = sq[(r + 2) * LD + col], a3 = sq[(r + 3) * LD + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = adv[i][c];
          x = fmaf(pt[i].x, o0, x);
          x = fmaf(pt[i].y, o1, x);
          x = fmaf(pt[i].z, o2, x);
          x = fmaf(pt[i].w, o3, x);
          adv[i][c] = x;
          float y = adk[i][c];
          y = fmaf(dt[i].x, a0, y);
          y = fmaf(dt[i].y, a1, y);
          y = fmaf(dt[i].z, a2, y);
          y = fmaf(dt[i].w, a3, y);
          adk[i][c] = y;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const size_t idx = slab + (size_t)row * D + tx + 16 * c;
      dk[idx] = from_f32<O>(adk[i][c]);
      dv[idx] = from_f32<O>(adv[i][c]);
    }
  }
}

template <typename T, typename O, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, O* __restrict__ dq, int seq,
                    int causal, float scale) {
  using S = Smem<D>;
  constexpr int LD = S::LD, LP = S::LP, CD = D / 16;
  extern __shared__ float4 smem_f4[];
  float* sq = reinterpret_cast<float*>(smem_f4);   // BT x LD
  float* sdo = sq + BT * LD;                        // BT x LD
  float* sk = sdo + BT * LD;                        // BT x LD
  float* sv = sk + BT * LD;                         // BT x LD
  float* sds = sv + BT * LD;                        // dS: query rows, BT x LP
  float* slse = sds + BT * LP;                      // BT
  float* sdi = slse + BT;                           // BT

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;   // heavy tiles first
  const size_t slab = (size_t)blockIdx.y * seq * D;
  q += slab; k += slab; v += slab; dout += slab;
  lse += (size_t)blockIdx.y * seq;
  di += (size_t)blockIdx.y * seq;

  load_tile<T, D>(sq, LD, q, q0, seq);
  load_tile<T, D>(sdo, LD, dout, q0, seq);
  load_vec(slse, lse, q0, seq);
  load_vec(sdi, di, q0, seq);

  // this thread owns query rows ty + 16 i and columns tx + 16 c
  float adq[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) adq[i][c] = 0.f;

  const int k_end = causal ? min(seq, q0 + BT) : seq;
  const int num_k = (k_end + BT - 1) / BT;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D>(sk, LD, k, k0, seq);
    load_tile<T, D>(sv, LD, v, k0, seq);
    __syncthreads();

    float p[4][4], ds[4][4];
    p_ds<D>(p, ds, sq, sdo, sk, sv, slse, sdi, q0, k0, seq, causal, scale,
            ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sds[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ += dS K over the tile's key rows
#pragma unroll 2
    for (int j = 0; j < BT; j += 4) {
      float4 d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d4[i] = *reinterpret_cast<const float4*>(&sds[(ty + 16 * i) * LP + j]);
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int col = tx + 16 * c;
        const float b0 = sk[(j + 0) * LD + col], b1 = sk[(j + 1) * LD + col];
        const float b2 = sk[(j + 2) * LD + col], b3 = sk[(j + 3) * LD + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = adq[i][c];
          x = fmaf(d4[i].x, b0, x);
          x = fmaf(d4[i].y, b1, x);
          x = fmaf(d4[i].z, b2, x);
          x = fmaf(d4[i].w, b3, x);
          adq[i][c] = x;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      dq[slab + (size_t)row * D + tx + 16 * c] = from_f32<O>(adq[i][c]);
  }
}

template <typename T, typename O, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* di,
                   void* dq, void* dk, void* dv, int hb, int seq, int causal,
                   float scale, cudaStream_t stream) {
  const dim3 grid((seq + BT - 1) / BT, hb);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  cudaError_t err;
  if (dk != nullptr) {
    const size_t bytes = Smem<D>::DKV_BYTES;
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, O, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, O, D><<<grid, NT, bytes, stream>>>(
        tq, tk, tv, tdo, lse, di, static_cast<O*>(dk), static_cast<O*>(dv),
        seq, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dq != nullptr) {
    const size_t bytes = Smem<D>::DQ_BYTES;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, O, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, O, D><<<grid, NT, bytes, stream>>>(
        tq, tk, tv, tdo, lse, di, static_cast<O*>(dq), seq, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, typename O>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dq, void* dk, void* dv, int hb, int seq, int d,
                       int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, O, 16>(q, k, v, dout, lse, di, dq, dk, dv, hb, seq, causal, scale, s);
    case 32: return launch<T, O, 32>(q, k, v, dout, lse, di, dq, dk, dv, hb, seq, causal, scale, s);
    case 64: return launch<T, O, 64>(q, k, v, dout, lse, di, dq, dk, dv, hb, seq, causal, scale, s);
    case 128: return launch<T, O, 128>(q, k, v, dout, lse, di, dq, dk, dv, hb, seq, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of q, k, v, dout) and out_dtype (of dq, dk, dv): 0 = float32,
// 1 = bfloat16; out_dtype is dtype or float32. lse and di are f32 (hb, seq). A null dq skips K3; null dk
// and dv skip K2 (one of them null alone is refused). Returns the first
// launch error (0 on success); the kernels run on `stream`, unsynced.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* di,
                         void* dq, void* dk, void* dv, int hb, int seq, int d,
                         int dtype, int out_dtype, int causal, float scale,
                         void* stream) {
  if (hb <= 0 || hb > 65535 || seq <= 0) return cudaErrorInvalidValue;
  if ((dk == nullptr) != (dv == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* flse = static_cast<const float*>(lse);
  const float* fdi = static_cast<const float*>(di);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && out_dtype == 0)
    return dispatch_d<float, float>(q, k, v, dout, flse, fdi, dq, dk, dv, hb, seq, d, causal, scale, s);
  if (dtype == 1 && out_dtype == 1)
    return dispatch_d<bf16, bf16>(q, k, v, dout, flse, fdi, dq, dk, dv, hb, seq, d, causal, scale, s);
  if (dtype == 1 && out_dtype == 0)
    return dispatch_d<bf16, float>(q, k, v, dout, flse, fdi, dq, dk, dv, hb, seq, d, causal, scale, s);
  return cudaErrorInvalidValue;
}

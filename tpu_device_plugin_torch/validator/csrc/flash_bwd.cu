// Flash-attention backward for Hopper (sm_90a), plain C entry point.
//
// Replaces the two Pallas TPU backward kernels of
// tpu_device_plugin/validator/flash_attention.py, launched by
// `_flash_bwd_3d` (:273):
// - `_flash_bwd_dkv_kernel` (:196) -> K2: per key tile, over the query
//   tiles at or below the diagonal, P = exp(Q K^T * scale - lse),
//   dV += P^T dO, dP = dO V^T, dS = P * (dP - D) * scale, dK += dS^T Q;
// - `_flash_bwd_dq_kernel` (:236) -> K3: per query tile, over the key
//   tiles up to the diagonal, the same dS, dQ += dS K.
// D = rowsum(dO * O) is computed by the caller, in f32, from the saved
// output, as the TPU version does (:286-290). q, k, v, dO are contiguous
// (hb, seq, d); lse and D are f32 (hb, seq).
//
// What bounds it on this card: at the training shape (hb 128, seq 2048,
// d 128, bf16, causal) K2 does 8 d FLOPs per causal pair (~275 GFLOP)
// against ~0.40 GB of traffic, K3 6 d (~206 GFLOP) against ~0.34 GB: both
// are bound by operations, which only the tensor cores reach.
//
// K2 for bf16 inputs (flash_bwd_dkv_wgmma_kernel; bf16 or f32 outputs):
// tensor cores, in the transposed orientation, so that P and dS are born
// in the layout their products need and nothing is staged through shared
// memory.
// - One block per (128-row key tile, hb): two consumer warpgroups of 64
//   key rows each, with K and V resident in shared memory, and one
//   producer warp that streams 64-row Q and dO tiles by TMA, and the
//   tiles' lse and D rows by its lanes, through a three-stage mbarrier
//   ring, starting at the diagonal when causal; the lanes load a stage's
//   rows while its TMA is in flight. setmaxnreg gives the consumers 240
//   registers: dK and dV stay in f32 registers (64 + 64 per thread at d
//   128).
// - Per query tile a warpgroup makes S^T = K Q^T and dP^T = V dO^T (wgmma
//   SS products), then P^T = exp(S^T scale - lse[col]) and dS^T = P^T
//   (dP^T - D[col]) scale on the accumulator fragments, each rounded to
//   bf16 in registers, as the JAX kernel rounds them (:224, :227), and the
//   A operand of the RS products dV += P^T dO and dK += dS^T Q, with dO and
//   Q read MN-major. `flash_bwd_dkv_plain` rounds the same P and dS.
// - What bounds it: the four products take 8 d FLOPs a pair on the tensor
//   cores; P and dS take about ten instructions a pair on the CUDA cores,
//   an exp2 among them: near half the tensor time at d 64. Run in turn
//   within one warpgroup, each side waits on the other. So the two
//   warpgroups take turns on the tensor cores (named barriers, as
//   FlashAttention-3 schedules its softmax): a turn issues the RS pair of
//   the last tile, waits for it, issues the SS pair of the next, hands the
//   tensor cores to the other warpgroup, and computes the next tile's P
//   and dS while the other's products run. The fragments are never live
//   beside S^T and dP^T, and P and dS read lse and D a 16-column slice at
//   a time, with no mask outside edge tiles: at d 128 dK, dV, S^T and dP^T
//   take 192 of the 240 registers and nothing spills (the first design
//   spilled 472 bytes there, and ptxas serialized its wgmmas). Issuing the
//   scores behind the RS pair unwaited, which d 64 has the registers for,
//   gained nothing there; a third ring stage takes 8-16% off the time of
//   two at the training cells' shapes, and loading the rows by TMA
//   instead of the lanes at most 1.5%.
// - Causal, warpgroup 1 skips the block's first 64 query rows (one tile,
//   two at 32 rows), which lie wholly above its keys; only tiles that
//   cross the diagonal or `seq` are masked.
// - Each warpgroup adds its query tiles in order: dK and dV are
//   deterministic, with no atomics.
//
// K3 for bf16 inputs (flash_bwd_dq_wgmma_kernel; bf16 or f32 outputs):
// tensor cores, in K1's orientation: the accumulator rows are queries, so
// they line up with lse and D, and dS is born in the layout dQ += dS K
// needs.
// - One block per (128-row query tile, hb), heavy tiles first: two
//   consumer warpgroups of 64 query rows each, with Q and dO resident in
//   shared memory, and one producer thread that streams K and V tiles by
//   TMA through a three-stage mbarrier ring, from key tile 0 up to the
//   diagonal when causal. Each consumer thread holds the lse (log2 units)
//   and D of its two rows in registers for the whole loop, and dQ in f32
//   registers (64 per thread at d 128); setmaxnreg gives the consumers
//   240.
// - S = Q K^T and dP = dO V^T are wgmma SS products; P = exp(S scale -
//   lse) and dS = P (dP - D) scale run on the accumulator fragments; dS,
//   scaled, is rounded to bf16 in registers, as the JAX kernel rounds it
//   (:262), and is the A operand of the RS product dQ += dS K, with K read
//   MN-major from the bytes S read K-major. `flash_bwd_dq_plain` rounds
//   the same dS.
// - What bounds it: the three products take 6 d FLOPs a pair on the
//   tensor cores, P and dS about ten instructions a pair on the CUDA
//   cores. So the warpgroups take turns on the tensor cores, as K2's do:
//   a turn issues the RS product of the last tile, waits for it, issues
//   the SS pair of the next, hands the tensor cores to the other
//   warpgroup, and computes the next tile's P and dS while the other's
//   products run. The dS fragments are never live beside S and dP, so the
//   key tile is as wide as dQ's registers allow: 128 keys at head dims up
//   to 64 (dQ, S and dP 32 + 64 + 64 registers), 64 at 128 and at (192,
//   128) (64 + 32 + 32, 96 + 32 + 32). Run in turn within one warpgroup
//   (the first design), each side waited on the other: K3 took 0.76 ms at
//   Pythia-1.4B's attention (hb 128, seq 2048, d 128) against 0.42 now
//   (H100 at 700 W), with dQ bit for bit the same (the same k-steps in
//   the same key order, whatever the tile width).
// - Only tiles that cross the diagonal or `seq` are masked (P and dS
//   chosen at compile time); warpgroup 0 skips the products of a causal
//   block's last 64 / BK key tiles, which lie wholly above its rows.
// - Each warpgroup adds its key tiles in order: dQ is deterministic, with
//   no atomics.
//
// Latent attention (MLA) at head dims (192, 128): q, k, dq and dk have
// the query/key head dim (192), v, dO and dv the value head dim (128); K2
// and K3 take them as two template dims, and every other instance is the
// same code at DQK = DV. S^T and dP^T (S and dP in K3) reduce over their
// own dims (12 and 8 k-steps), dK and dQ are m64n192 accumulators (96
// f32 registers a thread, against 64 at d 128), dV m64n128.
// - K2 streams 32 query rows a tile (TC_BQ_WIDE) there: dK, dV, S^T and
//   dP^T take 96 + 64 + 16 + 16 registers, as many as d 128's at 64 rows,
//   and nothing spills. At 64 rows (224 of the 240 registers before any
//   address) ptxas serialized the wgmmas for want of registers, and on an
//   H100 K2 took 3.86 ms against 2.45 at Moonlight-16B-A3B's shape (hb
//   32, seq 8192, causal).
// - Causal, warpgroup 1 so skips two tiles, and starts two tiles ahead of
//   warpgroup 0: K2 takes a four-stage ring there (DkvSmem::STAGES). With
//   three, each of warpgroup 1's tiles was loaded only as its turn came,
//   and K2 took 2.77 ms against 2.59-2.61 skipping one tile (a masked
//   turn of zeros); with four, 2.53-2.59 (H100 at 700 W, median of five).
// - K3 streams 64 key rows a tile there: dQ, S and dP take 96 + 32 + 32
//   registers and nothing spills. Before the turns, dS's fragments were
//   live beside S and dP, and at 64 rows ptxas serialized the wgmmas and
//   spilled 268 bytes (4.93 ms against 3.78 at 32 rows).
// - Shared memory: K2 resident K and V 48 + 32 KB, four stages of Q and
//   dO 12 + 8 KB; K3 resident Q and dO 48 + 32 KB, three stages of K and V
//   24 + 16 KB.
//
// K2 and K3 for f32 inputs: the first, scalar design, exact: f32 tiles in
// shared memory, scalar f32 FMAs, 4 x 4 register tiles per thread. On the
// tensor cores f32 would mean TF32, which the f32 bar refuses.
//
// Shared by both, against the TPU version:
// - The TPU grids carry the f32 accumulators across a sequential third
//   axis in VMEM scratch. Here one block owns one (key tile, hb) pair for
//   K2 and one (query tile, hb) pair for K3, loops over the other tiles
//   itself, and keeps its accumulators in registers. The two-pass shape
//   is kept: no atomics on dQ, so the result is deterministic.
// - Pallas pads ragged tails with garbage and the TPU kernel masks P and
//   dS explicitly. Here padded rows load as zero (TMA fills them; padded
//   lse and D are zero) and P and dS are set to 0 outside the valid
//   (row < seq, col < seq, causal) region, never left to
//   exp(-1e30 - lse); stores are masked at `seq`.
// - Outputs are written in the input dtype or in f32 (`out_dtype`, a
//   template parameter, so the stores do not branch), so the ring path's
//   f32 partials from bf16 inputs need no other kernel (:277-280).
// - At d = 128 the scalar K2's tiles take 170 KB and K3's 153 KB of shared
//   memory, the tensor-core K2's and K3's 163 and 161 KB (bf16): dynamic
//   shared memory, raised with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int BT = 64;         // rows per query or key tile
constexpr int NT = 256;        // threads: a 16 x 16 grid, 4 x 4 outputs each

// --- f32 inputs and outputs: the scalar kernels --------------------------

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

// Copies rows [r0, r0 + BT) of a (seq, D) slab into shared memory with row
// stride `ld`; rows at or past `seq` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int r0, int seq) {
  for (int e = threadIdx.x; e < BT * D; e += NT) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * ld + c] = row < seq ? src[(size_t)row * D + c] : 0.f;
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

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int seq, int causal, float scale) {
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

  load_tile<D>(sk, LD, k, k0, seq);
  load_tile<D>(sv, LD, v, k0, seq);

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
    load_tile<D>(sq, LD, q, q0, seq);
    load_tile<D>(sdo, LD, dout, q0, seq);
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
      dk[idx] = adk[i][c];
      dv[idx] = adv[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int seq, int causal, float scale) {
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

  load_tile<D>(sq, LD, q, q0, seq);
  load_tile<D>(sdo, LD, dout, q0, seq);
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
    load_tile<D>(sk, LD, k, k0, seq);
    load_tile<D>(sv, LD, v, k0, seq);
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
      dq[slab + (size_t)row * D + tx + 16 * c] = adq[i][c];
  }
}

// --- K2 for bf16 inputs: the tensor-core kernel -------------------------

constexpr int TC_BK = 128;              // key rows per block: 64 per consumer warpgroup
constexpr int TC_BQ = 64;               // query rows per streamed tile
constexpr int TC_STAGES = 3;            // Q / dO / lse / D ring depth at TC_BQ
constexpr int TC_THREADS = 384;         // consumer warpgroups 0 and 1, producer 2
constexpr int TC_CONSUMER_WARPS = 8;
constexpr int TC_TURN = 1;              // named barriers TC_TURN + wg: warpgroup wg's turn
constexpr int TC_BQ_WIDE = 32;          // TC_BQ at query/key head dim 192
constexpr float LOG2E = 1.4426950408889634f;

// Query rows per streamed tile of K2 at head dims (DQK, DV): TC_BQ, or
// TC_BQ_WIDE at DQK 192, where dK's accumulator is 1.5 times d 128's
// (the header says why).
template <int DQK> constexpr int dkv_bq() { return DQK > 128 ? TC_BQ_WIDE : TC_BQ; }

// DQK: the query/key head dim, DV: the value head dim (equal but in latent
// attention)
template <int DQK, int DV> struct DkvSmem {
  static constexpr int BQ = dkv_bq<DQK>();
  // Q / dO / lse / D ring depth: causal, warpgroup 1 starts 64 / BQ tiles
  // after warpgroup 0, and each tile of that lead takes a stage, or the
  // loads lose their slack (the header says what that cost)
  static constexpr int STAGES = TC_STAGES + 64 / BQ - 1;
  using KT = sm90::Tile<TC_BK, DQK>;     // K, resident
  using VT = sm90::Tile<TC_BK, DV>;      // V, resident
  using QT = sm90::Tile<BQ, DQK>;        // Q, streamed
  using OT = sm90::Tile<BQ, DV>;         // dO, streamed
  static constexpr int V_OFF = KT::BYTES;
  static constexpr int Q_OFF = KT::BYTES + VT::BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT::BYTES;
  static constexpr int LSE_OFF = DO_OFF + STAGES * OT::BYTES;
  static constexpr int DI_OFF = LSE_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = DI_OFF + STAGES * BQ * 4;
  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + sm90::SMEM_ALIGN;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = sm90::pack_bf16(a, b);
}

// P^T = exp(S^T scale - lse[col]) and dS^T = P^T (dP^T - D[col]) scale on
// one warpgroup's 64 keys x 64 queries, dS from the f32 P as in the JAX
// kernel, each pair rounded to a bf16 A fragment as soon as it is made, so
// the f32 tiles die element by element. A 16-column slice kk takes 4
// columns of lse and D per thread, read as it goes. With EDGE (tiles on
// the diagonal or at `seq`) both are 0 outside the valid region; other
// tiles need no test. slse holds lse in log2 units.
template <bool EDGE, int BQ>
__device__ __forceinline__ void dkv_p_ds(uint32_t (&pa)[BQ / 16][4],
                                         uint32_t (&da)[BQ / 16][4],
                                         const float (&st)[BQ / 2],
                                         const float (&dpt)[BQ / 2],
                                         const float* slse, const float* sdi,
                                         int l, int kr, int q0, int seq,
                                         int causal, float scale_log2,
                                         float scale) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    // accumulator index i = 8 kk + 2 c + x = 4 j + e: column 8 j + 2 (l % 4)
    // + x of row kr + 8 (c % 2), j = 2 kk + c / 2
    float2 lse[2], dcol[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * (2 * kk + h) + 2 * (l % 4);
      lse[h] = *reinterpret_cast<const float2*>(slse + col);
      dcol[h] = *reinterpret_cast<const float2*>(sdi + col);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float p2[2], ds2[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = 8 * kk + 2 * c + x;
        const float lse2 = x ? lse[c / 2].y : lse[c / 2].x;
        const float dq = x ? dcol[c / 2].y : dcol[c / 2].x;
        if constexpr (EDGE) {
          const int key = kr + 8 * (c % 2);
          const int row = q0 + 8 * (2 * kk + c / 2) + 2 * (l % 4) + x;
          const bool ok = row < seq && key < seq && (!causal || key <= row);
          p2[x] = ok ? exp2f(st[i] * scale_log2 - lse2) : 0.f;
          ds2[x] = ok ? p2[x] * (dpt[i] - dq) * scale : 0.f;
        } else {
          p2[x] = exp2f(st[i] * scale_log2 - lse2);
          ds2[x] = p2[x] * (dpt[i] - dq) * scale;
        }
      }
      pa[kk][c] = sm90::pack_bf16(p2[0], p2[1]);
      da[kk][c] = sm90::pack_bf16(ds2[0], ds2[1]);
    }
  }
}

// acc = A B^T over D (SS, both K-major), one committed group: A the
// warpgroup's 64 rows of a resident 128-row tile (`a`, its descriptor: K
// or V in K2, Q or dO in K3), B a streamed tile of N rows (Q or dO in K2,
// K or V in K3)
template <int D, int N>
__device__ __forceinline__ void tile_scores(float (&acc)[N / 2], uint64_t a,
                                            int wg, const uint8_t* b_tile) {
  using TA = sm90::Tile<TC_BK, D>;
  using TB = sm90::Tile<N, D>;
  const uint64_t ad = sm90::opaque(a);
  const uint64_t bd = sm90::opaque(TB::kmajor(b_tile));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::Wgmma<N>::ss(acc, TA::kmajor_at(ad, 64 * wg, kk),
                       TB::kmajor_at(bd, 0, kk), kk > 0);
  sm90::wgmma_commit();
}

template <typename O, int DQK, int DV>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ di, O* __restrict__ dk,
                           O* __restrict__ dv, int seq, int causal,
                           float scale) {
  using L = DkvSmem<DQK, DV>;
  using KT = typename L::KT;
  using VT = typename L::VT;
  using QT = typename L::QT;
  using OT = typename L::OT;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::aligned_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * TC_BK;   // causal: tile 0 has the most work
  const int hb = blockIdx.y;
  const int num_q = (seq + BQ - 1) / BQ;
  const int q_begin = causal ? k0 / BQ : 0;      // the diagonal
  const int n = num_q - q_begin;                 // query tiles streamed
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);     // the producer warp's lanes
      sm90::mbar_init(&empty[s], TC_CONSUMER_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer warp: TMA for the tiles, its lanes copy the lse and D rows
    sm90::regs_dealloc<24>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x % 32;
      const size_t rows = (size_t)hb * seq;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, KT::BYTES + VT::BYTES);
        for (int b = 0; b < KT::BOXES; ++b)
          sm90::tma_load_3d(smem + b * KT::BOX_BYTES, &mk, kv_full, b * KT::W, k0, hb);
        for (int b = 0; b < VT::BOXES; ++b)
          sm90::tma_load_3d(smem + L::V_OFF + b * VT::BOX_BYTES, &mv, kv_full,
                            b * VT::W, k0, hb);
      }
      for (int qt = q_begin; qt < num_q; ++qt) {
        const int i = qt - q_begin, s = i % STAGES, q0 = qt * BQ;
        sm90::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        // the tiles' TMA first, so that the rows' loads run under it; each
        // lane arrives after its own stores
        if (lane == 0) {
          sm90::mbar_expect_tx(&full[s], QT::BYTES + OT::BYTES);
          uint8_t* sq = smem + L::Q_OFF + s * QT::BYTES;
          uint8_t* sdo = smem + L::DO_OFF + s * OT::BYTES;
          for (int b = 0; b < QT::BOXES; ++b)
            sm90::tma_load_3d(sq + b * QT::BOX_BYTES, &mq, &full[s], b * QT::W, q0, hb);
          for (int b = 0; b < OT::BOXES; ++b)
            sm90::tma_load_3d(sdo + b * OT::BOX_BYTES, &mdo, &full[s], b * OT::W, q0, hb);
        }
        float* slse = reinterpret_cast<float*>(smem + L::LSE_OFF) + s * BQ;
        float* sdi = reinterpret_cast<float*>(smem + L::DI_OFF) + s * BQ;
#pragma unroll
        for (int j = 0; j < BQ / 32; ++j) {
          const int r = lane + 32 * j;
          const bool in = q0 + r < seq;
          slse[r] = in ? lse[rows + q0 + r] * LOG2E : 0.f;   // log2 units
          sdi[r] = in ? di[rows + q0 + r] : 0.f;
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
  } else {
    // consumers, transposed: warpgroup cw owns key rows
    // [key_lo, key_lo + 64), this thread rows kr and kr + 8; the
    // accumulator columns are the tile's 64 query rows. cw is wg made
    // warp-uniform (a broadcast), so that ptxas sees every branch below as
    // uniform and keeps the wgmmas asynchronous.
    sm90::regs_alloc<240>();
    const int cw = __shfl_sync(0xffffffffu, wg, 0);
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    const int key_lo = k0 + 64 * cw;
    const int kr = key_lo + 16 * w + l / 4;
    const float scale_log2 = scale * LOG2E;
    const uint64_t k_desc = KT::kmajor(smem);
    const uint64_t v_desc = KT::kmajor(smem + L::V_OFF);
    float adk[DQK / 2], adv[DV / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) adk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) adv[i] = 0.f;
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];

    // Causal, the first 64 / BQ tiles (queries k0 .. k0 + 63) lie wholly
    // above warpgroup 1's keys: it takes the tiles after them. Each
    // warpgroup takes one turn on the tensor cores per tile it takes, and
    // one more. Turn p issues the products of the tile before (dV, dK),
    // waits for them, issues the scores of the next (S^T, dP^T), hands the
    // tensor cores to the other warpgroup, and computes that tile's P and
    // dS while the other's products run. The fragments are never live
    // beside S^T and dP^T, which at d 128 keeps the turn in 240 registers.
    // The turns alternate, warpgroup 0's first, while both have turns
    // left (n + 1 and n + 1 - skip); warpgroup 0 takes the rest alone.
    const int skip = causal ? min(64 / BQ, n) : 0;      // warpgroup 1's
    const int first = cw == 1 ? skip : 0;
    const int m = n - first;                             // tiles taken
    const int handovers = cw == 0 ? n + 1 - skip : min(n + 1 - skip, n);
    const int waits = cw == 0 ? 1 + min(n + 1 - skip, n) : n + 1 - skip;
    const uint8_t* sq0 = smem + L::Q_OFF;
    const uint8_t* sdo0 = smem + L::DO_OFF;
    const float* slse0 = reinterpret_cast<const float*>(smem + L::LSE_OFF);
    const float* sdi0 = reinterpret_cast<const float*>(smem + L::DI_OFF);
    sm90::mbar_wait(kv_full, 0);
    if (l == 0)
      for (int i = 0; i < first; ++i) sm90::mbar_arrive(&empty[i]);  // unread
    __syncwarp();   // converged for the aligned barrier instructions
    if (cw == 1) sm90::bar_arrive(TC_TURN + 0, 256);    // warpgroup 0 first

    for (int p = 0; p <= m; ++p) {
      const int i = first + p;   // the tile whose scores this turn makes
      const int s = i % STAGES, sp = (i + STAGES - 1) % STAGES;
      if (p < waits) sm90::bar_sync(TC_TURN + cw, 256);
      if (p < m) sm90::mbar_wait(&full[s], (i / STAGES) & 1);
      sm90::wgmma_fence();
      if (p > 0) {
        // dV += P^T dO and dK += dS^T Q of the tile before (RS, dO and Q
        // read MN-major); once done, its stage goes back
        const uint64_t dom = sm90::opaque(OT::mnmajor(sdo0 + sp * OT::BYTES));
        const uint64_t qm = sm90::opaque(QT::mnmajor(sq0 + sp * QT::BYTES));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          sm90::Wgmma<DV>::rs(adv, pa[kk], OT::mnmajor_at(dom, kk), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          sm90::Wgmma<DQK>::rs(adk, da[kk], QT::mnmajor_at(qm, kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(adv);
        sm90::fence_regs(adk);
        sm90::fence_regs(pa);
        sm90::fence_regs(da);
        if (l == 0) sm90::mbar_arrive(&empty[sp]);
        __syncwarp();   // converged for the aligned instructions below
        sm90::wgmma_fence();
      }
      if (p < m) {
        // S^T and dP^T of tile i; the tensor cores go to the other
        // warpgroup while P and dS are made from them
        float st[BQ / 2], dpt[BQ / 2];
        tile_scores<DQK, BQ>(st, k_desc, cw, sq0 + s * QT::BYTES);
        tile_scores<DV, BQ>(dpt, v_desc, cw, sdo0 + s * OT::BYTES);
        if (p < handovers) sm90::bar_arrive(TC_TURN + 1 - cw, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        const int q0 = (q_begin + i) * BQ;
        const float* slse = slse0 + s * BQ;
        const float* sdi = sdi0 + s * BQ;
        const bool edge = (causal && q0 < key_lo + 64) || q0 + BQ > seq ||
                          key_lo + 64 > seq;
        if (edge)
          dkv_p_ds<true, BQ>(pa, da, st, dpt, slse, sdi, l, kr, q0, seq,
                             causal, scale_log2, scale);
        else
          dkv_p_ds<false, BQ>(pa, da, st, dpt, slse, sdi, l, kr, q0, seq,
                              causal, scale_log2, scale);
      } else if (p < handovers) {
        sm90::bar_arrive(TC_TURN + 1 - cw, 256);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = kr + 8 * h;
      if (row >= seq) continue;
      const size_t kbase = ((size_t)hb * seq + row) * DQK + 2 * (l % 4);
      const size_t vbase = ((size_t)hb * seq + row) * DV + 2 * (l % 4);
#pragma unroll
      for (int j = 0; j < DQK / 8; ++j)
        store2(dk + kbase + 8 * j, adk[4 * j + 2 * h], adk[4 * j + 2 * h + 1]);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        store2(dv + vbase + 8 * j, adv[4 * j + 2 * h], adv[4 * j + 2 * h + 1]);
    }
  }
}

template <typename O, int DQK, int DV>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* di, void* dk, void* dv, int hb,
                             int seq, int causal, float scale,
                             cudaStream_t stream) {
  constexpr int BQ = DkvSmem<DQK, DV>::BQ;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = sm90::tile_map<BQ, DQK>(&mq, q, hb, seq);
  if (err == cudaSuccess) err = sm90::tile_map<TC_BK, DQK>(&mk, k, hb, seq);
  if (err == cudaSuccess) err = sm90::tile_map<TC_BK, DV>(&mv, v, hb, seq);
  if (err == cudaSuccess) err = sm90::tile_map<BQ, DV>(&mdo, dout, hb, seq);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(dk) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(dv) % 8 != 0)
    return cudaErrorMisalignedAddress;
  const int bytes = DkvSmem<DQK, DV>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<O, DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + TC_BK - 1) / TC_BK, hb);
  flash_bwd_dkv_wgmma_kernel<O, DQK, DV><<<grid, TC_THREADS, bytes, stream>>>(
      mq, mk, mv, mdo, lse, di, static_cast<O*>(dk), static_cast<O*>(dv), seq,
      causal, scale);
  return cudaGetLastError();
}

// --- K3 for bf16 inputs: the tensor-core kernel -------------------------

constexpr int DQ_BQ = 128;              // query rows per block: 64 per consumer warpgroup
constexpr int DQ_STAGES = 3;            // K / V ring depth

// Key rows per streamed tile of K3 at query/key head dim DQK (the header
// says why each)
template <int DQK> constexpr int dq_bk() { return DQK <= 64 ? 128 : 64; }

template <int DQK, int DV> struct DqSmem {
  static constexpr int BK = dq_bk<DQK>();
  static constexpr int STAGES = DQ_STAGES;
  using QT = sm90::Tile<DQ_BQ, DQK>;     // Q, resident
  using OT = sm90::Tile<DQ_BQ, DV>;      // dO, resident
  using KT = sm90::Tile<BK, DQK>;        // K, streamed
  using VT = sm90::Tile<BK, DV>;         // V, streamed
  static constexpr int DO_OFF = QT::BYTES;
  static constexpr int K_OFF = QT::BYTES + OT::BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KT::BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * VT::BYTES;
  // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + sm90::SMEM_ALIGN;
  static_assert(BYTES <= 232448, "K3's tiles exceed a block's shared memory");
  // causal, warpgroup 0 never releases the last 64 / BK tiles' stages: no
  // load may wait on them (see the kernel)
  static_assert(64 / BK <= STAGES, "K3's ring is shallower than the skip");
};
static_assert(DQ_BQ == TC_BK, "K3's resident tiles take tile_scores' A rows");

// P = exp(S scale - lse) and dS = P (dP - D) scale on one warpgroup's 64
// queries x BK keys, dS from the f32 P and scaled before it is rounded, as
// in the JAX kernel, each pair rounded to a bf16 A fragment as soon as it
// is made. lse (log2 units) and D are the thread's two rows, in
// registers. With EDGE (tiles on the diagonal or at `seq`) dS is 0
// outside the valid region; other tiles need no test.
template <bool EDGE, int BK>
__device__ __forceinline__ void dq_ds(uint32_t (&da)[BK / 16][4],
                                      const float (&sc)[BK / 2],
                                      const float (&dp)[BK / 2],
                                      const float (&lse2)[2],
                                      const float (&drow)[2], int l, int r0,
                                      int k0, int seq, int causal,
                                      float scale_log2, float scale) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // accumulator index i = 8 kk + 2 c + x = 4 j + e: row r0 + 8 (c % 2),
      // key 8 j + 2 (l % 4) + x, j = 2 kk + c / 2
      float ds2[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = 8 * kk + 2 * c + x, h = c % 2;
        if constexpr (EDGE) {
          const int key = k0 + 8 * (2 * kk + c / 2) + 2 * (l % 4) + x;
          const int row = r0 + 8 * h;
          const bool ok = row < seq && key < seq && (!causal || key <= row);
          const float p = ok ? exp2f(sc[i] * scale_log2 - lse2[h]) : 0.f;
          ds2[x] = ok ? p * (dp[i] - drow[h]) * scale : 0.f;
        } else {
          const float p = exp2f(sc[i] * scale_log2 - lse2[h]);
          ds2[x] = p * (dp[i] - drow[h]) * scale;
        }
      }
      da[kk][c] = sm90::pack_bf16(ds2[0], ds2[1]);
    }
}

template <typename O, int DQK, int DV>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, O* __restrict__ dq,
                          int seq, int causal, float scale) {
  using L = DqSmem<DQK, DV>;
  using QT = typename L::QT;
  using OT = typename L::OT;
  using KT = typename L::KT;
  using VT = typename L::VT;
  constexpr int BK = L::BK, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BQ;   // heavy tiles first
  const int hb = blockIdx.y;
  const int k_end = causal ? min(seq, q0 + DQ_BQ) : seq;
  const int num_k = (k_end + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], TC_CONSUMER_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      sm90::mbar_arrive_expect_tx(q_full, QT::BYTES + OT::BYTES);
      for (int b = 0; b < QT::BOXES; ++b)
        sm90::tma_load_3d(smem + b * QT::BOX_BYTES, &mq, q_full, b * QT::W, q0, hb);
      for (int b = 0; b < OT::BOXES; ++b)
        sm90::tma_load_3d(smem + L::DO_OFF + b * OT::BOX_BYTES, &mdo, q_full,
                          b * OT::W, q0, hb);
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % STAGES;
        sm90::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], KT::BYTES + VT::BYTES);
        uint8_t* sk = smem + L::K_OFF + s * KT::BYTES;
        uint8_t* sv = smem + L::V_OFF + s * VT::BYTES;
        for (int b = 0; b < KT::BOXES; ++b)
          sm90::tma_load_3d(sk + b * KT::BOX_BYTES, &mk, &full[s], b * KT::W,
                            kt * BK, hb);
        for (int b = 0; b < VT::BOXES; ++b)
          sm90::tma_load_3d(sv + b * VT::BOX_BYTES, &mv, &full[s], b * VT::W,
                            kt * BK, hb);
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows [q_lo, q_lo + 64); this
    // thread rows r0 and r0 + 8 (the accumulator layout, sm90.cuh). cw is
    // wg made warp-uniform (a broadcast), so that ptxas sees every branch
    // below as uniform and keeps the wgmmas asynchronous.
    sm90::regs_alloc<240>();
    const int cw = __shfl_sync(0xffffffffu, wg, 0);
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    const int q_lo = q0 + 64 * cw;
    const int r0 = q_lo + 16 * w + l / 4;
    const float scale_log2 = scale * LOG2E;
    float lse2[2], drow[2];   // lse in log2 units, and D, of rows r0, r0 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const bool in = row < seq;
      lse2[h] = in ? lse[(size_t)hb * seq + row] * LOG2E : 0.f;
      drow[h] = in ? di[(size_t)hb * seq + row] : 0.f;
    }
    float adq[DQK / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) adq[i] = 0.f;
    uint32_t da[BK / 16][4];

    // Causal, the last 64 / BK key tiles (keys q0 + 64 on) lie wholly
    // above warpgroup 0's rows: it takes the m0 tiles before them, and
    // leaves their stages unreleased, which no load waits on (the ring is
    // at least that deep). Each warpgroup takes one turn on the tensor
    // cores per tile it takes, and one more. Turn p issues the product of
    // the tile before (dQ += dS K), waits for it and releases its stage,
    // issues the scores of tile p (S, dP), hands the tensor cores to the
    // other warpgroup, and computes that tile's P and dS while the other's
    // products run. The dS fragments are never live beside S and dP. The
    // turns alternate, warpgroup 0's first, while both have turns left
    // (m0 + 1 of them); warpgroup 1 takes the rest alone.
    const int m0 = causal ? min(num_k, (q0 + 64 + BK - 1) / BK) : num_k;
    const int m = cw == 0 ? m0 : num_k;                  // tiles taken
    const int handovers = cw == 0 ? m0 + 1 : m0;
    const uint64_t q_desc = QT::kmajor(smem);
    const uint64_t do_desc = OT::kmajor(smem + L::DO_OFF);
    const uint8_t* sk0 = smem + L::K_OFF;
    const uint8_t* sv0 = smem + L::V_OFF;
    sm90::mbar_wait(q_full, 0);
    __syncwarp();   // converged for the aligned barrier instructions
    if (cw == 1) sm90::bar_arrive(TC_TURN + 0, 256);    // warpgroup 0 first

    for (int p = 0; p <= m; ++p) {
      const int s = p % STAGES, sp = (p + STAGES - 1) % STAGES;
      if (p <= m0) sm90::bar_sync(TC_TURN + cw, 256);
      if (p < m) sm90::mbar_wait(&full[s], (p / STAGES) & 1);
      sm90::wgmma_fence();
      if (p > 0) {
        // dQ += dS K of the tile before (RS, K read MN-major from the
        // bytes S read K-major); once done, its stage goes back
        const uint64_t km = sm90::opaque(KT::mnmajor(sk0 + sp * KT::BYTES));
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          sm90::Wgmma<DQK>::rs(adq, da[kk], KT::mnmajor_at(km, kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(adq);
        sm90::fence_regs(da);
        if (l == 0) sm90::mbar_arrive(&empty[sp]);
        __syncwarp();   // converged for the aligned instructions below
        sm90::wgmma_fence();
      }
      if (p < m) {
        // S = Q K^T and dP = dO V^T of tile p over this warpgroup's 64
        // rows; the tensor cores go to the other warpgroup while P and dS
        // are made from them
        float sc[BK / 2], dp[BK / 2];
        tile_scores<DQK, BK>(sc, q_desc, cw, sk0 + s * KT::BYTES);
        tile_scores<DV, BK>(dp, do_desc, cw, sv0 + s * VT::BYTES);
        if (p < handovers) sm90::bar_arrive(TC_TURN + 1 - cw, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);
        const int k0 = p * BK;
        const bool edge = (causal && k0 + BK - 1 > q_lo) || k0 + BK > seq ||
                          q_lo + 64 > seq;
        if (edge)
          dq_ds<true, BK>(da, sc, dp, lse2, drow, l, r0, k0, seq, causal,
                          scale_log2, scale);
        else
          dq_ds<false, BK>(da, sc, dp, lse2, drow, l, r0, k0, seq, causal,
                           scale_log2, scale);
      } else if (p < handovers) {
        sm90::bar_arrive(TC_TURN + 1 - cw, 256);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= seq) continue;
      const size_t base = ((size_t)hb * seq + row) * DQK + 2 * (l % 4);
#pragma unroll
      for (int j = 0; j < DQK / 8; ++j)
        store2(dq + base + 8 * j, adq[4 * j + 2 * h], adq[4 * j + 2 * h + 1]);
    }
  }
}

template <typename O, int DQK, int DV>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* di, void* dq, int hb, int seq,
                            int causal, float scale, cudaStream_t stream) {
  constexpr int BK = DqSmem<DQK, DV>::BK;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = sm90::tile_map<DQ_BQ, DQK>(&mq, q, hb, seq);
  if (err == cudaSuccess) err = sm90::tile_map<BK, DQK>(&mk, k, hb, seq);
  if (err == cudaSuccess) err = sm90::tile_map<BK, DV>(&mv, v, hb, seq);
  if (err == cudaSuccess) err = sm90::tile_map<DQ_BQ, DV>(&mdo, dout, hb, seq);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(dq) % 8 != 0) return cudaErrorMisalignedAddress;
  const int bytes = DqSmem<DQK, DV>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<O, DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + DQ_BQ - 1) / DQ_BQ, hb);
  flash_bwd_dq_wgmma_kernel<O, DQK, DV><<<grid, TC_THREADS, bytes, stream>>>(
      mq, mk, mv, mdo, lse, di, static_cast<O*>(dq), seq, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_scalar(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse, const float* di,
                          float* dq, float* dk, float* dv, int hb, int seq,
                          int causal, float scale, cudaStream_t stream) {
  const dim3 grid((seq + BT - 1) / BT, hb);
  cudaError_t err;
  if (dk != nullptr) {
    const size_t bytes = Smem<D>::DKV_BYTES;
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<D><<<grid, NT, bytes, stream>>>(
        q, k, v, dout, lse, di, dk, dv, seq, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dq != nullptr) {
    const size_t bytes = Smem<D>::DQ_BYTES;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<D><<<grid, NT, bytes, stream>>>(
        q, k, v, dout, lse, di, dq, seq, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K2 then K3 on the tensor cores, at head dims (DQK, DV)
template <typename O, int DQK, int DV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* di,
                         void* dq, void* dk, void* dv, int hb, int seq,
                         int causal, float scale, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (dk != nullptr)
    err = launch_dkv_wgmma<O, DQK, DV>(q, k, v, dout, lse, di, dk, dv, hb,
                                       seq, causal, scale, stream);
  if (err == cudaSuccess && dq != nullptr)
    err = launch_dq_wgmma<O, DQK, DV>(q, k, v, dout, lse, di, dq, hb, seq,
                                      causal, scale, stream);
  return err;
}

// bf16 inputs take the tensor-core kernels, f32 inputs (and outputs) the
// scalar ones: chosen by type at compile time
template <typename T, typename O, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* di,
                   void* dq, void* dk, void* dv, int hb, int seq, int causal,
                   float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_wgmma<O, D, D>(q, k, v, dout, lse, di, dq, dk, dv, hb, seq,
                                 causal, scale, stream);
  } else {
    static_assert(std::is_same_v<T, float> && std::is_same_v<O, float>,
                  "f32 inputs take f32 outputs");
    return launch_scalar<D>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
        static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), hb, seq, causal, scale, stream);
  }
}

template <typename T, typename O>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dq, void* dk, void* dv, int hb, int seq, int d,
                       int dv_dim, int causal, float scale, cudaStream_t s) {
  if (dv_dim != d) {
    // latent attention's pair, on the tensor cores only
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      if (d == 192 && dv_dim == 128)
        return launch_wgmma<O, 192, 128>(q, k, v, dout, lse, di, dq, dk, dv,
                                         hb, seq, causal, scale, s);
    return cudaErrorInvalidValue;
  }
  switch (d) {
    case 16: return launch<T, O, 16>(q, k, v, dout, lse, di, dq, dk, dv, hb, seq, causal, scale, s);
    case 32: return launch<T, O, 32>(q, k, v, dout, lse, di, dq, dk, dv, hb, seq, causal, scale, s);
    case 64: return launch<T, O, 64>(q, k, v, dout, lse, di, dq, dk, dv, hb, seq, causal, scale, s);
    case 128: return launch<T, O, 128>(q, k, v, dout, lse, di, dq, dk, dv, hb, seq, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// d: the head dim of q, k, dq and dk; dv_dim: that of v, dout and dv (d,
// or (192, 128) in bf16). dtype (of q, k, v, dout) and out_dtype (of dq,
// dk, dv): 0 = float32, 1 = bfloat16; out_dtype is dtype or float32. lse
// and di are f32 (hb, seq). A null dq skips K3; null dk and dv skip K2
// (one of them null alone is refused). Returns the first launch error (0
// on success); the kernels run on `stream`, unsynced.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* di,
                         void* dq, void* dk, void* dv, int hb, int seq, int d,
                         int dv_dim, int dtype, int out_dtype, int causal,
                         float scale, void* stream) {
  if (hb <= 0 || hb > 65535 || seq <= 0) return cudaErrorInvalidValue;
  if ((dk == nullptr) != (dv == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* flse = static_cast<const float*>(lse);
  const float* fdi = static_cast<const float*>(di);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && out_dtype == 0)
    return dispatch_d<float, float>(q, k, v, dout, flse, fdi, dq, dk, dv, hb, seq, d, dv_dim, causal, scale, s);
  if (dtype == 1 && out_dtype == 1)
    return dispatch_d<bf16, bf16>(q, k, v, dout, flse, fdi, dq, dk, dv, hb, seq, d, dv_dim, causal, scale, s);
  if (dtype == 1 && out_dtype == 0)
    return dispatch_d<bf16, float>(q, k, v, dout, flse, fdi, dq, dk, dv, hb, seq, d, dv_dim, causal, scale, s);
  return cudaErrorInvalidValue;
}

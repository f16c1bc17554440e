// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas TPU backward kernels of
// distkeras_tpu/ops/flash_attention.py:
//   dk_flash_bwd_fused -> _bwd_fused_kernel (launched by _fused_backward_call)
//   dk_flash_bwd_dq    -> _bwd_dq_kernel :185  (the split tier, launched by _backward)
//   dk_flash_bwd_dkv   -> _bwd_dkv_kernel :208 (the split tier, launched by _backward)
// All rebuild the same [q row, key] terms as _recompute_p_ds: s = (q . k) *
// scale from input-dtype operands with f32 accumulation, p = exp(s - lse)
// (masked entries exactly 0), dp = dO . v, ds = p * (dp - delta), where
// delta = rowsum(dO * O) - dlse comes from the wrapper.  Rounding points
// follow the Pallas code: dV takes p rounded to dO's dtype, dK takes ds
// rounded to q's dtype, dQ takes ds rounded to q's dtype (fused) or k's
// dtype (split); the kernels take one dtype for all four, so the rounding
// is the same in both tiers.  dq and dk are scaled by `scale` at the end.
// Query rows that see no key get dq = 0, keys that no row sees dk = dv = 0.
//
// bfloat16 runs on the tensor cores:
//
// flash_bwd_fused_kernel (B2): warpgroup MMA (wgmma) fed by the Tensor
// Memory Accelerator (TMA), through hopper.cuh.  One block per (batch,
// head, 128 keys), three warpgroups.  K and V come in once by TMA.  A
// producer warp (the third warpgroup, registers given back with
// setmaxnreg) streams 64-row tiles of q and dO by TMA, with their lse (times
// log2 e) and delta, through a ring of two stages whose "full" and "empty"
// mbarriers it and the consumers share, skipping the q rows that see none
// of the block's keys; TMA reads the strided [B, L, H, D] operands through
// 4-D maps (D, H, L, B), zero-fills rows past L and writes the 128-byte
// swizzle wgmma reads.  Two consumer warpgroups own 64 keys each and the
// f32 dK and dV accumulators of those keys in registers (128 a thread at
// D = 128, hence setmaxnreg: producer 40, consumers 232; the dQ partial
// reuses S^T's accumulator registers, as a third accumulator beside dK and
// dV makes ptxas serialize the wgmmas and spill).  Per q tile, in
// key-major orientation so that P^T and dS^T come out of the accumulators
// already in A-operand layout:
//   S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major
//   in shared memory);
//   p and ds on the f32 fragments; dV += bf16(P^T) dO and dK += bf16(dS^T) Q
//   (wgmma with A in registers, dO and Q read MN-major);
//   dS^T of the block's 128 keys staged in shared memory as bf16, then
//   dQ_partial = bf16(dS) K over those keys (both operands MN-major), the
//   warpgroups splitting the head dim at D = 128 (the first one alone at
//   D <= 64), staged as f32 and added into the f32 [B, Lq, H, D] workspace
//   by TMA bulk reduce-add (cp.reduce.async.bulk.tensor), one instruction a
//   box in place of per-thread atomics: the GPU form of the Pallas
//   kernel's [Lq, D] scratch.  The wrapper scales and casts it.  The order
//   of the adds varies from run to run, so dQ of the fused tier is not
//   bitwise reproducible.  Block y = 0 (key tile 0, which sees the most q
//   rows under causal masking) launches first.
//
// flash_bwd_dkv_kernel (B3b) is B2 without dQ: the same block body
// (kv_block, WITH_DQ = false), so its dK and dV are B2's to the bit; it
// drops the dS^T staging, the barrier between the consumers, the dQ
// product, the f32 staging and the reduce-add.  The shared memory they
// held is left free: a third q / dO stage did not make it faster at
// D = 128.
//
// flash_bwd_dq_kernel (B3a) is the q-major twin, on the same machinery:
// one block per (batch, head, 128 q rows), two consumer warpgroups of 64
// rows and a producer warp.  Q and dO come in once by TMA and stay; K and
// V stream in 64-key tiles through a ring of three stages (a "full"
// mbarrier per stage, and an "empty" one per stage and consumer, so that
// the warpgroup of the earlier rows, which reads fewer tiles under causal
// masking, never holds the ring).  Each thread reads the lse (times
// log2 e) and delta of its two rows once.  Per key tile:
//   S = Q K^T and dP = dO V^T (wgmma m64n64k16, both operands K-major in
//   shared memory), issued behind the last tile's dQ product;
//   p = exp2(s scale log2 e - lse log2 e), masked to exactly 0 on the
//   tiles that straddle the diagonal or the end of k, and ds = p (dp -
//   delta) on the f32 fragments;
//   dQ += bf16(dS) K (wgmma with A in registers, K read MN-major, one
//   instruction per 64-column box), with the f32 dQ accumulator (D / 2
//   registers a thread) in registers for the whole block.
// Keys past the last one the block's rows can see are never loaded, and a
// warpgroup multiplies no tile past its own rows' last visible key; dQ is
// scaled and written once, by its block.  Blocks are
// numbered so that the longest causal rows (the last q tiles) start first.
// Neither split kernel uses atomics or reduce-adds: every output element
// is written by one block, so the split tier is bitwise reproducible.
//
// float32 inputs run CUDA-core kernels (no TF32 anywhere): a row of the
// block's own tile is shared by D/16 threads, each holding 16 elements of
// it in registers (16-byte vectors interleaved over the lanes, so a row
// read from shared memory is conflict-free), and the dot products reduce
// over those lanes with warp shuffles.
// - flash_bwd_fused_f32_kernel / flash_bwd_dkv_f32_kernel: one block per
//   (batch, head, tile of 64 key rows), holding k, v and the f32 dK, dV
//   accumulators of its rows; it streams 64-row tiles of q and dO (with
//   their lse and delta) through shared memory and skips the q rows that
//   see none of its keys.  The fused one also adds ds . K for each q tile
//   into the f32 dQ workspace with atomicAdd.
// - flash_bwd_dq_f32_kernel: one block per (batch, head, tile of 64 q
//   rows), holding q, dO and the f32 dQ accumulator, streaming 64-row
//   tiles of k and v, stopping at the last key any of its rows can see.
// Inputs are read in the framework's [B, L, H, D] layout through strides;
// the head dim must be contiguous and every row 16-byte aligned.  Outputs
// are contiguous [B, L, H, D].  Shared memory is dynamic (up to 145 KB), so
// each launch first raises the kernel's limit with cudaFuncSetAttribute.
//
// Bound.  At the training shape (B 8, L 2048, H 4, D 128, bf16, causal) the
// fused backward does 10 * D flops per visible score (~86 GFLOP) and moves
// ~118 MB: operations-bound on the tensor cores (~0.087 ms).  The split
// kernels are operations-bound too: B3a does 6 * D flops per visible score
// (S, dP, dQ; ~0.052 ms), B3b 8 * D (S^T, dP^T, dV, dK; ~0.069 ms).  What
// their design does about it: every product is a wgmma fed by TMA (no
// address arithmetic on the consumers, no block-wide barrier a tile), the
// two consumer warpgroups' products and softmax terms interleave on the
// SM, and B3a issues one tile's dQ product and the next tile's S and dP
// together, one wait a tile, with no product in flight across a branch.
// What stays in the way: each warpgroup's wait for its products before p
// and ds (B3b's dK and dV accumulators leave no registers to overlap two
// tiles: ptxas serializes the wgmmas then), and one block an SM (384
// threads of 168 registers; B3a holds 165 KB of shared memory at D = 128,
// B3b 133 KB).  PERF.md records the times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Strides {  // in elements: batch, row and head stride of q, k, v, dO
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, ob, ol, oh;
};

// ------------------------------------------------- float32, CUDA cores

constexpr int kRows = 64;  // rows a block owns: keys (dkv, fused) or queries (dq)
constexpr int kTile = 64;  // rows of each tile streamed through shared memory
constexpr int kSlice = 16; // head-dim elements one thread holds of a row

template <int D> struct Layout {
  static constexpr int kLanes = D / kSlice;  // threads sharing one row
  static constexpr int kThreads = kRows * kLanes;
};

// first element of the c-th float4 a lane holds of a row
template <int D>
__device__ __forceinline__ int vec_col(int c, int part) {
  return (c * Layout<D>::kLanes + part) * 4;
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

template <int LANES> __device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a lane's 16 elements of row `r` of a [rows, D] tile (global or shared)
template <int D>
__device__ __forceinline__ void load_slice(const float* r, int part, float* out) {
#pragma unroll
  for (int c = 0; c < kSlice / 4; ++c) load4(r + vec_col<D>(c, part), out + 4 * c);
}

template <int D>
__device__ __forceinline__ void store_slice(float* r, int part, const float* in) {
#pragma unroll
  for (int c = 0; c < kSlice / 4; ++c)
    *reinterpret_cast<float4*>(r + vec_col<D>(c, part)) =
        make_float4(in[4 * c], in[4 * c + 1], in[4 * c + 2], in[4 * c + 3]);
}

// The shared recompute (_recompute_p_ds): for one (q row, key) pair whose
// q-side row is `a_row` and key-side slices are held by the lanes, the two
// lane-reduced dot products.  `a` and `g` are the q and dO rows (dkv /
// fused) or the k and v rows (dq); `x`, `y` the lane's register slices of
// the other side.
template <int D>
__device__ __forceinline__ void dots(const float* a, const float* g, const float* x,
                                     const float* y, int part, float& s, float& dp) {
  s = 0.f;
  dp = 0.f;
#pragma unroll
  for (int c = 0; c < kSlice / 4; ++c) {
    float af[4], gf[4];
    load4(a + vec_col<D>(c, part), af);
    load4(g + vec_col<D>(c, part), gf);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      s += af[t] * x[c * 4 + t];
      dp += gf[t] * y[c * 4 + t];
    }
  }
  s = lane_sum<Layout<D>::kLanes>(s);
  dp = lane_sum<Layout<D>::kLanes>(dp);
}

// p and ds for one pair: p = exp(s * scale - lse) where visible, else 0
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta,
                                     bool visible, float scale, float& p, float& ds) {
  p = visible ? expf(s * scale - lse) : 0.f;
  ds = p * (dp - delta);
}

// a lane's slice of y += w * row
template <int D>
__device__ __forceinline__ void axpy(const float* row, float w, int part, float* y) {
#pragma unroll
  for (int c = 0; c < kSlice / 4; ++c) {
    float f[4];
    load4(row + vec_col<D>(c, part), f);
#pragma unroll
    for (int t = 0; t < 4; ++t) y[c * 4 + t] += w * f[t];
  }
}

// copy rows [r0, r0 + n) of a strided [B, L, H, D] tensor into a [kTile, D]
// shared tile, zero-filling the rest
template <int D, int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* src, long long rs, int r0,
                                      int n, int tid) {
  for (int idx = tid; idx < kTile * (D / 4); idx += THREADS) {
    const int i = idx / (D / 4), d = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) x = *reinterpret_cast<const float4*>(src + (long long)(r0 + i) * rs + d);
    *reinterpret_cast<float4*>(dst + i * D + d) = x;
  }
}

template <int D, bool FUSED>
size_t kv_smem_bytes() {
  size_t n = 2 * kTile * D * sizeof(float) + 2 * kTile * sizeof(float);
  if (FUSED) n += kRows * D * sizeof(float) + kTile * (kRows + 1) * sizeof(float);
  return n;
}

// dK and dV (and, FUSED, the dQ partial sums) for one tile of key rows:
// the body of the fused and the dkv kernel
template <int D, bool FUSED>
__device__ __forceinline__ void kv_tile(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        float* __restrict__ dq_acc, float* __restrict__ dk,
                                        float* __restrict__ dv, const Strides& st, int H,
                                        int Lq, int Lk, int causal, int q_offset,
                                        int k_offset, float scale) {
  constexpr int LANES = Layout<D>::kLanes;
  constexpr int THREADS = Layout<D>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kTile][D]
  float* dos = qs + kTile * D;                 // [kTile][D]
  float* lse_s = dos + kTile * D;              // [kTile]
  float* delta_s = lse_s + kTile;              // [kTile]
  float* ks = delta_s + kTile;                 // FUSED: [kRows][D]
  float* ds_s = ks + kRows * D;                // FUSED: [kTile][kRows + 1]

  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int part = tid % LANES;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = k0 + row;
  const bool row_valid = kj < Lk;
  const int k_pos = k_offset + kj;

  float kr[kSlice], vr[kSlice], dkr[kSlice], dvr[kSlice];
  {
    const long long kc = min(kj, Lk - 1);
    load_slice<D>(k + b * st.kb + kc * st.kl + h * st.kh, part, kr);
    load_slice<D>(v + b * st.vb + kc * st.vl + h * st.vh, part, vr);
#pragma unroll
    for (int t = 0; t < kSlice; ++t) {
      if (!row_valid) kr[t] = vr[t] = 0.f;
      dkr[t] = 0.f;
      dvr[t] = 0.f;
    }
    if constexpr (FUSED) store_slice<D>(ks + row * D, part, kr);
  }

  // q rows before the first one that sees key k0 contribute nothing
  int q_begin = 0;
  if (causal) q_begin = max(0, min(Lq, k_offset + k0 - q_offset));
  const long long stat0 = ((long long)b * H + h) * Lq;

  for (int q0 = q_begin; q0 < Lq; q0 += kTile) {
    const int nq = min(kTile, Lq - q0);
    __syncthreads();  // previous tile fully consumed
    stage<D, THREADS>(qs, q + b * st.qb + h * st.qh, st.ql, q0, nq, tid);
    stage<D, THREADS>(dos, dout + b * st.ob + h * st.oh, st.ol, q0, nq, tid);
    for (int i = tid; i < kTile; i += THREADS) {
      lse_s[i] = i < nq ? lse[stat0 + q0 + i] : 0.f;
      delta_s[i] = i < nq ? delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();

    for (int i = 0; i < nq; ++i) {
      float s, dp, p, ds;
      dots<D>(qs + i * D, dos + i * D, kr, vr, part, s, dp);
      const bool visible = row_valid && (!causal || q_offset + q0 + i >= k_pos);
      p_ds(s, dp, lse_s[i], delta_s[i], visible, scale, p, ds);
      axpy<D>(dos + i * D, p, part, dvr);
      axpy<D>(qs + i * D, ds, part, dkr);
      if constexpr (FUSED) {
        if (part == 0) ds_s[i * (kRows + 1) + row] = ds;
      }
    }

    if constexpr (FUSED) {
      __syncthreads();
      // dQ[q0 + i, d] += sum_j ds[i, j] * K[j, d] over this block's keys
      for (int idx = tid; idx < nq * D; idx += THREADS) {
        const int i = idx / D, d = idx % D;
        const float* dsrow = ds_s + i * (kRows + 1);
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < kRows; ++j) acc += dsrow[j] * ks[j * D + d];
        atomicAdd(dq_acc + (((long long)b * Lq + q0 + i) * H + h) * D + d, acc);
      }
    }
  }

  if (row_valid) {
    const long long base = (((long long)b * Lk + kj) * H + h) * D;
#pragma unroll
    for (int t = 0; t < kSlice; ++t) dkr[t] *= scale;
    store_slice<D>(dk + base, part, dkr);
    store_slice<D>(dv + base, part, dvr);
  }
}

#define DK_KV_F32_PARAMS                                                                 \
  const float *__restrict__ q, const float *__restrict__ k, const float *__restrict__ v, \
      const float *__restrict__ dout, const float *__restrict__ lse,                      \
      const float *__restrict__ delta, float *__restrict__ dq_acc,                        \
      float *__restrict__ dk, float *__restrict__ dv, Strides st, int H, int Lq, int Lk,  \
      int causal, int q_offset, int k_offset, float scale
#define DK_KV_ARGS q, k, v, dout, lse, delta, dq_acc, dk, dv, st, H, Lq, Lk, causal, \
                   q_offset, k_offset, scale

// B2 for float32: dK, dV and the atomic dQ partial sums
template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_bwd_fused_f32_kernel(DK_KV_F32_PARAMS) {
  kv_tile<D, true>(DK_KV_ARGS);
}

// B3b for float32: dK and dV only
template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_bwd_dkv_f32_kernel(DK_KV_F32_PARAMS) {
  kv_tile<D, false>(DK_KV_ARGS);
}

// B3a for float32: dQ for one tile of q rows
template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, Strides st, int H, int Lq, int Lk,
                        int causal, int q_offset, int k_offset, float scale) {
  constexpr int LANES = Layout<D>::kLanes;
  constexpr int THREADS = Layout<D>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [kTile][D]
  float* vs = ks + kTile * D;                  // [kTile][D]

  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int part = tid % LANES;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = q0 + row;
  const bool row_valid = qi < Lq;
  const int q_pos = q_offset + qi;

  float qr[kSlice], gr[kSlice], dqr[kSlice];
  const long long qc = min(qi, Lq - 1);
  load_slice<D>(q + b * st.qb + qc * st.ql + h * st.qh, part, qr);
  load_slice<D>(dout + b * st.ob + qc * st.ol + h * st.oh, part, gr);
#pragma unroll
  for (int t = 0; t < kSlice; ++t) dqr[t] = 0.f;
  const long long stat = ((long long)b * H + h) * Lq + qc;
  const float lse_i = lse[stat];
  const float delta_i = delta[stat];

  // keys past the block's last visible position are never loaded
  int k_end = Lk;
  if (causal) {
    const int last_q_pos = q_offset + min(q0 + kRows, Lq) - 1;
    k_end = max(0, min(Lk, last_q_pos - k_offset + 1));
  }

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, k_end - k0);
    __syncthreads();  // previous tile fully consumed
    stage<D, THREADS>(ks, k + b * st.kb + h * st.kh, st.kl, k0, nk, tid);
    stage<D, THREADS>(vs, v + b * st.vb + h * st.vh, st.vl, k0, nk, tid);
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      float s, dp, p, ds;
      dots<D>(ks + j * D, vs + j * D, qr, gr, part, s, dp);
      const bool visible = row_valid && (!causal || q_pos >= k_offset + k0 + j);
      p_ds(s, dp, lse_i, delta_i, visible, scale, p, ds);
      axpy<D>(ks + j * D, ds, part, dqr);
    }
  }

  if (row_valid) {
#pragma unroll
    for (int t = 0; t < kSlice; ++t) dqr[t] *= scale;
    store_slice<D>(dq + (((long long)b * Lq + qi) * H + h) * D, part, dqr);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  Strides st;
  int B, H, Lq, Lk, causal, q_offset, k_offset;
  float scale;
  cudaStream_t stream;
};

enum Which { kFused = 0, kDkv = 1, kDq = 2 };

template <int D, bool FUSED>
cudaError_t launch_kv_f32(const Args& a) {
  auto kernel = flash_bwd_dkv_f32_kernel<D>;
  if constexpr (FUSED) kernel = flash_bwd_fused_f32_kernel<D>;
  const size_t smem = kv_smem_bytes<D, FUSED>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lk + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, Layout<D>::kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.st,
      a.H, a.Lq, a.Lk, a.causal, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const Args& a) {
  const size_t smem = 2 * kTile * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + kRows - 1) / kRows, a.H, a.B);
  flash_bwd_dq_f32_kernel<D><<<grid, Layout<D>::kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.st, a.H, a.Lq, a.Lk, a.causal, a.q_offset, a.k_offset,
      a.scale);
  return cudaGetLastError();
}

// -------------------------------------- B2 and B3b: bf16, key-major, wgmma + TMA

namespace hp = hopper;

constexpr int kKvKeys = 128;     // keys per block, 64 per consumer warpgroup
constexpr int kKvQ = 64;         // q rows per streamed tile
constexpr int kKvStages = 2;     // q / dO tiles in flight
constexpr int kKvThreads = 384;  // two consumer warpgroups, then the producer's

template <int D, bool WITH_DQ>
struct KvSmem {  // byte offsets from the 1024-aligned base
  static constexpr int kCols = hp::box_cols<bf16>(D);  // columns in a box
  static constexpr int R = kCols * 2;                  // bytes of a box row
  static constexpr int kBoxes = D / kCols;
  static constexpr int kFCols = hp::box_cols<float>(D);  // f32 columns in a dQ box
  static constexpr uint32_t kKBox = kKvKeys * R;
  static constexpr uint32_t kQBox = kKvQ * R;
  static constexpr uint32_t kQTile = kKvQ * D * 2;     // one q (or dO) tile
  static constexpr uint32_t kDsTile = kKvKeys * kKvQ * 2;  // dS^T: [keys][64 q] bf16
  static constexpr uint32_t kFBox = kKvQ * 128;        // one f32 dQ box: 64 rows x 128 B
  static constexpr uint32_t kDqStage = kKvQ * kCols * 4;  // a warpgroup's dQ partial
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + kKvKeys * D * 2;
  static constexpr uint32_t Q = V + kKvKeys * D * 2;   // kKvStages tiles
  static constexpr uint32_t dO = Q + kKvStages * kQTile;  // kKvStages tiles
  static constexpr uint32_t dS = dO + kKvStages * kQTile;  // WITH_DQ: two tiles
  static constexpr uint32_t dQ = dS + (WITH_DQ ? 2 * kDsTile : 0);  // one stage per warpgroup
  static constexpr uint32_t stats = dQ + (WITH_DQ ? 2 * kDqStage : 0);  // per stage: lse * log2 e [64], delta [64]
  static constexpr uint32_t bars = stats + kKvStages * 2 * kKvQ * 4;  // kv_full, full[], empty[]
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kKvStages) + 1024;  // + alignment
};

// The block of B2 (WITH_DQ) and of B3b: dK and dV of 128 keys and, in B2,
// the dQ partial sums of those keys added into the f32 workspace (tdq).
template <int D, bool WITH_DQ>
__device__ __forceinline__ void kv_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const CUtensorMap* tdo,
                                         const CUtensorMap* tdq, const float* __restrict__ lse,
                                         const float* __restrict__ delta, bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, int H, int Lq, int Lk, int causal,
                                         int q_offset, int k_offset, float scale) {
  using L = KvSmem<D, WITH_DQ>;
  constexpr int R = L::R;
  constexpr int KPB = R / 32;                 // k-steps of 16 columns in a box row
  constexpr int kDqGroups = D / L::kCols;     // warpgroups sharing dQ's columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - hp::smem_u32(smem_raw));  // generic, for stats
  const uint32_t kv_full = base + L::bars;
  auto full = [&](int s) { return base + L::bars + 8 * (1 + s); };
  auto empty = [&](int s) { return base + L::bars + 8 * (1 + kKvStages + s); };
  auto stats = [&](int s) { return reinterpret_cast<float*>(gbase + L::stats) + s * 2 * kKvQ; };

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kKvKeys;
  // q rows before the first one that sees key k0 contribute nothing
  int q_begin = 0;
  if (causal) q_begin = max(0, min(Lq, k_offset + k0 - q_offset));
  const int n_qt = (Lq - q_begin + kKvQ - 1) / kKvQ;

  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      hp::mbar_init(full(s), 32);
      hp::mbar_init(empty(s), 256);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    hp::setmaxnreg_dec<40>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 256 + 32 && n_qt > 0) {
      if (lane == 0) {
        hp::mbar_arrive_expect(kv_full, 2 * kKvKeys * D * 2);
        for (int n = 0; n < L::kBoxes; ++n) {
          hp::tma_load(base + L::K + n * L::kKBox, tk, kv_full, n * L::kCols, h, k0, b);
          hp::tma_load(base + L::V + n * L::kKBox, tv, kv_full, n * L::kCols, h, k0, b);
        }
      }
      const long long stat0 = ((long long)b * H + h) * Lq;
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % kKvStages;
        const int q0 = q_begin + it * kKvQ;
        hp::mbar_wait(empty(s), ((it / kKvStages) & 1) ^ 1);
        float* st = stats(s);
        for (int i = lane; i < kKvQ; i += 32) {
          const bool ok = q0 + i < Lq;
          st[i] = ok ? lse[stat0 + q0 + i] * hp::kLog2e : 0.f;
          st[kKvQ + i] = ok ? delta[stat0 + q0 + i] : 0.f;
        }
        if (lane == 0) {
          hp::mbar_arrive_expect(full(s), 2 * L::kQTile);
          for (int n = 0; n < L::kBoxes; ++n) {
            hp::tma_load(base + L::Q + s * L::kQTile + n * L::kQBox, tq, full(s),
                         n * L::kCols, h, q0, b);
            hp::tma_load(base + L::dO + s * L::kQTile + n * L::kQBox, tdo, full(s),
                         n * L::kCols, h, q0, b);
          }
        } else {
          hp::mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hp::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int krow = 64 * wg + 16 * warp + g;  // block key row of d[4j], d[4j+1]; +8 the others
    const int k0w = k0 + 64 * wg;              // the warpgroup's first key
    const bool with_dq = WITH_DQ && wg < kDqGroups;
    const uint32_t sK = base + L::K + 64 * wg * R;  // the warpgroup's keys in each box
    const uint32_t sV = base + L::V + 64 * wg * R;
    const float scale_l2 = scale * hp::kLog2e;

    float dka[L::kBoxes][L::kCols / 2], dva[L::kBoxes][L::kCols / 2];
#pragma unroll
    for (int n = 0; n < L::kBoxes; ++n) {
#pragma unroll
      for (int i = 0; i < L::kCols / 2; ++i) dka[n][i] = dva[n][i] = 0.f;
    }
    if (n_qt > 0) hp::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % kKvStages;
      const int q0 = q_begin + it * kKvQ;
      const uint32_t sQ = base + L::Q + s * L::kQTile;
      const uint32_t sO = base + L::dO + s * L::kQTile;
      const uint32_t sDs = base + L::dS + (it & 1) * L::kDsTile;
      hp::mbar_wait(full(s), (it / kKvStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: the warpgroup's 64 keys x 64 q rows.
      // In B2 st later holds the dQ partial (its first k-step overwrites),
      // so that no third accumulator is live
      float st[kKvQ / 2], dpt[kKvQ / 2];
#pragma unroll
      for (int i = 0; i < kKvQ / 2; ++i) st[i] = dpt[i] = 0.f;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = (kk / KPB) * L::kKBox + (kk % KPB) * 32;
        const uint32_t qa = (kk / KPB) * L::kQBox + (kk % KPB) * 32;
        hp::Wgmma<kKvQ>::ss<0, 0>(st, hp::desc<R>(sK + ka, L::kKBox),
                                  hp::desc<R>(sQ + qa, L::kQBox), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = (kk / KPB) * L::kKBox + (kk % KPB) * 32;
        const uint32_t qa = (kk / KPB) * L::kQBox + (kk % KPB) * 32;
        hp::Wgmma<kKvQ>::ss<0, 0>(dpt, hp::desc<R>(sV + ka, L::kKBox),
                                  hp::desc<R>(sO + qa, L::kQBox), kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(st);
      hp::fence_regs(dpt);

      // p and ds; element i is key krow + 8 ((i / 2) % 2), q column
      // 8 (i / 4) + 2 c + i % 2 of the tile
      const float* lse_s = stats(s);
      const float* delta_s = lse_s + kKvQ;
      const bool edge = q0 + kKvQ > Lq || k0w + 64 > Lk ||
                        (causal && q_offset + q0 < k_offset + k0w + 63);
#pragma unroll
      for (int i = 0; i < kKvQ / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * c + (i & 1);
        float p = hp::exp2_approx(fmaf(st[i], scale_l2, -lse_s[col]));
        if (edge) {
          const int kj = k0 + krow + 8 * ((i >> 1) & 1);
          const int qi = q0 + col;
          if (kj >= Lk || qi >= Lq || (causal && q_offset + qi < k_offset + kj)) p = 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] - delta_s[col]);
      }
      // bf16(P^T) and bf16(dS^T) as A operands (one k-step per 16 q rows);
      // in B2 dS^T also into shared memory, rows = the block's keys
      uint32_t pa[kKvQ / 16][4], da[kKvQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKvQ / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: row half r % 2, q block 2 kk + r / 2
          const int i = 8 * kk + 4 * (r >> 1) + 2 * (r & 1);
          pa[kk][r] = hp::pack_bf16(st[i], st[i + 1]);
          da[kk][r] = hp::pack_bf16(dpt[i], dpt[i + 1]);
          if constexpr (WITH_DQ)
            hp::st_shared(sDs + hp::swizzled<128>(krow + 8 * (r & 1), 2 * kk + (r >> 1)) + 4 * c,
                          da[kk][r]);
        }
      }

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: dO and Q read MN-major
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKvQ / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < L::kBoxes; ++n) {
          const uint32_t off = n * L::kQBox + kk * 16 * R;
          hp::Wgmma<L::kCols>::template rs<1>(dva[n], pa[kk], hp::desc<R>(sO + off, L::kQBox),
                                              1);
          hp::Wgmma<L::kCols>::template rs<1>(dka[n], da[kk], hp::desc<R>(sQ + off, L::kQBox),
                                              1);
        }
      }
      hp::wgmma_commit();

      float (&dq)[L::kCols / 2] = *reinterpret_cast<float(*)[L::kCols / 2]>(&st);
      if constexpr (WITH_DQ) {
        // dS^T of all 128 keys is in shared memory
        hp::fence_async_shared();
        hp::named_sync(1, 256);
        if (with_dq) {
          // dQ partial = bf16(dS) K over the block's keys, this warpgroup's
          // box of columns: dS^T and K both read MN-major
          hp::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKvKeys / 16; ++kk)
            hp::Wgmma<L::kCols>::template ss<1, 1>(
                dq, hp::desc<128>(sDs + kk * 16 * 128, L::kDsTile),
                hp::desc<R>(base + L::K + wg * L::kKBox + kk * 16 * R, L::kKBox), kk > 0);
          hp::wgmma_commit();
        }
      }
      hp::wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < L::kBoxes; ++n) {
        hp::fence_regs(dka[n]);
        hp::fence_regs(dva[n]);
      }
      if constexpr (WITH_DQ) hp::fence_regs(dq);
      hp::mbar_arrive(empty(s));  // q and dO of this stage are read

      if (with_dq) {
        // stage the f32 partial (64 q rows x kCols, boxes of 32 columns in
        // the 128-byte swizzle) and add it into the workspace by TMA
        const uint32_t stage = base + L::dQ + wg * L::kDqStage;
        if (tid == 0) hp::bulk_wait_read();  // the last tile's reduce has read it
        hp::named_sync(2 + wg, 128);
#pragma unroll
        for (int i = 0; i < L::kCols / 2; i += 2) {
          const int row = 16 * warp + g + 8 * ((i >> 1) & 1);
          const int col = 8 * (i / 4) + 2 * c;
          const int fc = col % L::kFCols;
          hp::st_shared(stage + (col / L::kFCols) * L::kFBox + hp::swizzled<128>(row, fc / 4) +
                            4 * (fc % 4),
                        dq[i], dq[i + 1]);
        }
        hp::fence_async_shared();
        hp::named_sync(2 + wg, 128);
        if (tid == 0) {
          for (int f = 0; f < L::kCols / L::kFCols; ++f)
            hp::tma_reduce_add(tdq, stage + f * L::kFBox, wg * L::kCols + f * L::kFCols, h, q0,
                               b);
          hp::bulk_commit();
        }
      }
    }
    if (with_dq && tid == 0) hp::bulk_wait();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = k0 + krow + 8 * r;
      if (kj >= Lk) continue;
      const long long row = (((long long)b * Lk + kj) * H + h) * D + 2 * c;
#pragma unroll
      for (int n = 0; n < L::kBoxes; ++n) {
#pragma unroll
        for (int j = 0; j < L::kCols / 8; ++j) {
          const int col = n * L::kCols + 8 * j;
          *reinterpret_cast<uint32_t*>(dk + row + col) =
              hp::pack_bf16(dka[n][4 * j + 2 * r] * scale, dka[n][4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + row + col) =
              hp::pack_bf16(dva[n][4 * j + 2 * r], dva[n][4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// B2: dK, dV and the dQ partial sums (the fused tier's one kernel)
template <int D>
__global__ void __launch_bounds__(kKvThreads, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Lq, int Lk, int causal, int q_offset,
                       int k_offset, float scale) {
  kv_block<D, true>(&tq, &tk, &tv, &tdo, &tdq, lse, delta, dk, dv, H, Lq, Lk, causal, q_offset,
                    k_offset, scale);
}

// B3b: dK and dV only (the split tier's second kernel)
template <int D>
__global__ void __launch_bounds__(kKvThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Lq, int Lk, int causal, int q_offset,
                     int k_offset, float scale) {
  kv_block<D, false>(&tq, &tk, &tv, &tdo, nullptr, lse, delta, dk, dv, H, Lq, Lk, causal,
                     q_offset, k_offset, scale);
}

template <int D, bool WITH_DQ>
cudaError_t launch_kv_tma(const Args& a) {
  const Strides& s = a.st;
  CUtensorMap tq, tk, tv, tdo, tdq;
  cudaError_t err = hp::make_map<bf16>(&tq, a.q, a.B, a.Lq, a.H, D, s.qb, s.ql, s.qh, kKvQ);
  if (err == cudaSuccess)
    err = hp::make_map<bf16>(&tk, a.k, a.B, a.Lk, a.H, D, s.kb, s.kl, s.kh, kKvKeys);
  if (err == cudaSuccess)
    err = hp::make_map<bf16>(&tv, a.v, a.B, a.Lk, a.H, D, s.vb, s.vl, s.vh, kKvKeys);
  if (err == cudaSuccess)
    err = hp::make_map<bf16>(&tdo, a.dout, a.B, a.Lq, a.H, D, s.ob, s.ol, s.oh, kKvQ);
  if (WITH_DQ && err == cudaSuccess)  // the f32 workspace, contiguous [B, Lq, H, D]
    err = hp::make_map<float>(&tdq, a.dq, a.B, a.Lq, a.H, D, (long long)a.Lq * a.H * D,
                              (long long)a.H * D, D, kKvQ);
  if (err != cudaSuccess) return err;
  const size_t smem = KvSmem<D, WITH_DQ>::bytes;
  const dim3 grid(a.B * a.H, (a.Lk + kKvKeys - 1) / kKvKeys);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
  if constexpr (WITH_DQ) {
    err = cudaFuncSetAttribute(flash_bwd_fused_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_fused_kernel<D><<<grid, kKvThreads, smem, a.stream>>>(
        tq, tk, tv, tdo, tdq, lse, delta, dk, dv, a.H, a.Lq, a.Lk, a.causal, a.q_offset,
        a.k_offset, a.scale);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<D><<<grid, kKvThreads, smem, a.stream>>>(
        tq, tk, tv, tdo, lse, delta, dk, dv, a.H, a.Lq, a.Lk, a.causal, a.q_offset, a.k_offset,
        a.scale);
  }
  return cudaGetLastError();
}

// ------------------------------------------------ B3a: bf16, q-major, wgmma + TMA

constexpr int kDqRows = 128;    // q rows per block, 64 per consumer warpgroup
constexpr int kDqKeys = 64;     // keys per K / V tile
constexpr int kDqStages = 3;    // K / V tiles in flight
constexpr int kDqThreads = 384; // two consumer warpgroups, then the producer's

template <int D>
struct DqSmem {  // byte offsets from the 1024-aligned base
  static constexpr int kCols = hp::box_cols<bf16>(D);  // columns in a box
  static constexpr int R = kCols * 2;                  // bytes of a box row
  static constexpr int kBoxes = D / kCols;
  static constexpr uint32_t kQBox = kDqRows * R;
  static constexpr uint32_t kKBox = kDqKeys * R;
  static constexpr uint32_t kTile = kDqKeys * D * 2;   // one K (or V) tile
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t dO = Q + kDqRows * D * 2;
  static constexpr uint32_t K = dO + kDqRows * D * 2;  // kDqStages tiles
  static constexpr uint32_t V = K + kDqStages * kTile;  // kDqStages tiles
  static constexpr uint32_t bars = V + kDqStages * kTile;  // q_full, full[], empty[] of each consumer
  static constexpr uint32_t bytes = bars + 8 * (1 + 3 * kDqStages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Lq,
                    int Lk, int causal, int q_offset, int k_offset, float scale) {
  using L = DqSmem<D>;
  constexpr int R = L::R;
  constexpr int KPB = R / 32;  // k-steps of 16 columns in a box row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::bars;
  auto full = [&](int s) { return base + L::bars + 8 * (1 + s); };
  // each consumer warpgroup frees a stage on its own barrier, so that one
  // that reads fewer tiles than the other never holds the ring
  auto empty = [&](int w, int s) { return base + L::bars + 8 * (1 + kDqStages * (1 + w) + s); };

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // longest rows first
  // the key tiles a consumer warpgroup reads: keys past the last one its
  // rows can see are never loaded (none for rows past Lq)
  auto tiles_of = [&](int w) {
    const int r0 = q0 + 64 * w;
    if (r0 >= Lq) return 0;
    int k_end = Lk;
    if (causal) k_end = max(0, min(Lk, q_offset + min(r0 + 64, Lq) - 1 - k_offset + 1));
    return (k_end + kDqKeys - 1) / kDqKeys;
  };
  const int n0 = tiles_of(0), n1 = tiles_of(1);
  const int n_tiles = max(n0, n1);

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hp::mbar_init(full(s), 1);
      hp::mbar_init(empty(0, s), 128);
      hp::mbar_init(empty(1, s), 128);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    hp::setmaxnreg_dec<40>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      hp::mbar_arrive_expect(q_full, 2 * kDqRows * D * 2);
      for (int n = 0; n < L::kBoxes; ++n) {
        hp::tma_load(base + L::Q + n * L::kQBox, &tq, q_full, n * L::kCols, h, q0, b);
        hp::tma_load(base + L::dO + n * L::kQBox, &tdo, q_full, n * L::kCols, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kDqStages;
        if (t >= kDqStages) {  // tile t - kDqStages is read by the warpgroups that read it
          const uint32_t parity = ((t / kDqStages) & 1) ^ 1;
          if (t - kDqStages < n0) hp::mbar_wait(empty(0, s), parity);
          if (t - kDqStages < n1) hp::mbar_wait(empty(1, s), parity);
        }
        hp::mbar_arrive_expect(full(s), 2 * L::kTile);
        for (int n = 0; n < L::kBoxes; ++n) {
          hp::tma_load(base + L::K + s * L::kTile + n * L::kKBox, &tk, full(s), n * L::kCols, h,
                       t * kDqKeys, b);
          hp::tma_load(base + L::V + s * L::kTile + n * L::kKBox, &tv, full(s), n * L::kCols, h,
                       t * kDqKeys, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hp::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int row0 = 64 * wg + 16 * warp + g;  // block row of d[4j], d[4j+1]; +8 the others
    const int n_mine = wg == 0 ? n0 : n1;
    const uint32_t sQ = base + L::Q + 64 * wg * R;  // the warpgroup's rows in each box
    const uint32_t sO = base + L::dO + 64 * wg * R;
    const float scale_l2 = scale * hp::kLog2e;

    // rows row0 and row0 + 8: lse (times log2 e, for ex2) and delta, read once
    const long long stat0 = ((long long)b * H + h) * Lq;
    float lse_l2[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row0 + 8 * r;
      lse_l2[r] = qi < Lq ? lse[stat0 + qi] * hp::kLog2e : 0.f;
      delta_r[r] = qi < Lq ? delta[stat0 + qi] : 0.f;
    }

    float acc[L::kBoxes][L::kCols / 2];
#pragma unroll
    for (int n = 0; n < L::kBoxes; ++n) {
#pragma unroll
      for (int i = 0; i < L::kCols / 2; ++i) acc[n][i] = 0.f;
    }
    // S = Q K^T and dP = dO V^T of the tile in stage s: the warpgroup's 64
    // rows x 64 keys, both operands K-major; issued, not committed
    float st[kDqKeys / 2], dpt[kDqKeys / 2];
    auto issue_sdp = [&](int s) {
      const uint32_t sK = base + L::K + s * L::kTile;
      const uint32_t sV = base + L::V + s * L::kTile;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t a = hp::desc<R>(sQ + (kk / KPB) * L::kQBox + (kk % KPB) * 32, L::kQBox);
        const uint64_t b = hp::desc<R>(sK + (kk / KPB) * L::kKBox + (kk % KPB) * 32, L::kKBox);
        if (kk == 0)
          hp::Wgmma<kDqKeys>::ss0<0, 0>(st, a, b);
        else
          hp::Wgmma<kDqKeys>::ss<0, 0>(st, a, b, 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t a = hp::desc<R>(sO + (kk / KPB) * L::kQBox + (kk % KPB) * 32, L::kQBox);
        const uint64_t b = hp::desc<R>(sV + (kk / KPB) * L::kKBox + (kk % KPB) * 32, L::kKBox);
        if (kk == 0)
          hp::Wgmma<kDqKeys>::ss0<0, 0>(dpt, a, b);
        else
          hp::Wgmma<kDqKeys>::ss<0, 0>(dpt, a, b, 1);
      }
    };
    // ds = p (dp - delta), p = exp(s scale - lse), masked to exactly 0
    // where the tile straddles the diagonal or the end of k (rows past Lq
    // read zeros and are not written), as bf16 A operands of dQ += dS K,
    // one k-step per 16 keys; element i is row row0 + 8 ((i / 2) % 2), key
    // k0 + 8 (i / 4) + 2 c + i % 2
    uint32_t da[kDqKeys / 16][4];
    auto make_ds = [&](int k0) {
      const bool edge = k0 + kDqKeys > Lk ||
                        (causal && q_offset + q0 + 64 * wg < k_offset + k0 + kDqKeys - 1);
#pragma unroll
      for (int i = 0; i < kDqKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = hp::exp2_approx(fmaf(st[i], scale_l2, -lse_l2[r]));
        if (edge) {
          const int kj = k0 + 8 * (i / 4) + 2 * c + (i & 1);
          if (kj >= Lk || (causal && q_offset + q0 + row0 + 8 * r < k_offset + kj)) p = 0.f;
        }
        dpt[i] = p * (dpt[i] - delta_r[r]);
      }
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
        const float* d0 = dpt + 8 * kk;  // key block 2 kk, then 2 kk + 1
        da[kk][0] = hp::pack_bf16(d0[0], d0[1]);
        da[kk][1] = hp::pack_bf16(d0[2], d0[3]);
        da[kk][2] = hp::pack_bf16(d0[4], d0[5]);
        da[kk][3] = hp::pack_bf16(d0[6], d0[7]);
      }
    };
    // dQ += bf16(dS) K of the tile in stage s: K [keys, D] read MN-major,
    // one box of columns an instruction; issued, not committed
    auto issue_dq = [&](int s) {
      const uint32_t sK = base + L::K + s * L::kTile;
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < L::kBoxes; ++n)
          hp::Wgmma<L::kCols>::template rs<1>(
              acc[n], da[kk], hp::desc<R>(sK + n * L::kKBox + kk * 16 * R, L::kKBox), 1);
      }
    };
    auto wait_all = [&] {
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(st);
      hp::fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < L::kBoxes; ++n) hp::fence_regs(acc[n]);
    };

    // Per tile, one wait: tile t's dQ product and tile t + 1's S and dP go
    // to the tensor cores back to back, and ds of tile t + 1 follows.  No
    // product is in flight across a branch (ptxas would serialize them).
    if (n_mine > 0) {
      hp::mbar_wait(q_full, 0);
      hp::mbar_wait(full(0), 0);
      hp::wgmma_fence();
      issue_sdp(0);
      wait_all();
      for (int t = 0; t + 1 < n_mine; ++t) {
        make_ds(t * kDqKeys);
        const int s1 = (t + 1) % kDqStages;
        hp::mbar_wait(full(s1), ((t + 1) / kDqStages) & 1);
        hp::wgmma_fence();
        issue_dq(t % kDqStages);
        issue_sdp(s1);
        wait_all();
        hp::mbar_arrive(empty(wg, t % kDqStages));  // K and V of tile t are read
      }
      make_ds((n_mine - 1) * kDqKeys);
      hp::wgmma_fence();
      issue_dq((n_mine - 1) % kDqStages);
      wait_all();
      hp::mbar_arrive(empty(wg, (n_mine - 1) % kDqStages));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row0 + 8 * r;
      if (qi >= Lq) continue;
      bf16* row = dq + (((long long)b * Lq + qi) * H + h) * D + 2 * c;
#pragma unroll
      for (int n = 0; n < L::kBoxes; ++n) {
#pragma unroll
        for (int j = 0; j < L::kCols / 8; ++j)
          *reinterpret_cast<uint32_t*>(row + n * L::kCols + 8 * j) =
              hp::pack_bf16(acc[n][4 * j + 2 * r] * scale, acc[n][4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

template <int D>
cudaError_t launch_dq_tma(const Args& a) {
  const Strides& s = a.st;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hp::make_map<bf16>(&tq, a.q, a.B, a.Lq, a.H, D, s.qb, s.ql, s.qh, kDqRows);
  if (err == cudaSuccess)
    err = hp::make_map<bf16>(&tk, a.k, a.B, a.Lk, a.H, D, s.kb, s.kl, s.kh, kDqKeys);
  if (err == cudaSuccess)
    err = hp::make_map<bf16>(&tv, a.v, a.B, a.Lk, a.H, D, s.vb, s.vl, s.vh, kDqKeys);
  if (err == cudaSuccess)
    err = hp::make_map<bf16>(&tdo, a.dout, a.B, a.Lq, a.H, D, s.ob, s.ol, s.oh, kDqRows);
  if (err != cudaSuccess) return err;
  const size_t smem = DqSmem<D>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Lq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_kernel<D><<<grid, kDqThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dq), a.H, a.Lq, a.Lk, a.causal, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}


// dtype 0 (float32) takes the CUDA-core kernels, 1 (bfloat16) the tensor-core ones
template <int D>
cudaError_t launch(int dtype, Which which, const Args& a) {
  if (dtype == 0) {
    switch (which) {
      case kFused: return launch_kv_f32<D, true>(a);
      case kDkv: return launch_kv_f32<D, false>(a);
      case kDq: return launch_dq_f32<D>(a);
    }
  } else if (dtype == 1) {
    switch (which) {
      case kFused: return launch_kv_tma<D, true>(a);
      case kDkv: return launch_kv_tma<D, false>(a);
      case kDq: return launch_dq_tma<D>(a);
    }
  }
  return cudaErrorInvalidValue;
}

int run(Which which, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        const long long* s, int B, int H, int Lq, int Lk, int D, int dtype, int causal,
        int q_offset, int k_offset, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv,
               Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]},
               B, H, Lq, Lk, causal, q_offset, k_offset, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(dtype, which, a); break;
    case 64: err = launch<64>(dtype, which, a); break;
    case 128: err = launch<128>(dtype, which, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* dk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The three entry points share one argument list.  dtype: 0 = float32,
// 1 = bfloat16.  Strides are in elements, (batch, row, head) for q, k, v and
// dO in that order.  dq is the f32 workspace (fused, zeroed by the caller)
// or the output (dq); the fused and dkv kernels write dk and dv.
#define DK_FLASH_BWD_ENTRY(NAME, WHICH)                                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* dout,      \
                      const void* lse, const void* delta, void* dq, void* dk, void* dv,   \
                      long long qsb, long long qsl, long long qsh, long long ksb,          \
                      long long ksl, long long ksh, long long vsb, long long vsl,         \
                      long long vsh, long long osb, long long osl, long long osh, int B,  \
                      int H, int Lq, int Lk, int D, int dtype, int causal, int q_offset,  \
                      int k_offset, float scale, void* stream) {                          \
    const long long s[12] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh}; \
    return run(WHICH, q, k, v, dout, lse, delta, dq, dk, dv, s, B, H, Lq, Lk, D, dtype,   \
               causal, q_offset, k_offset, scale, stream);                                \
  }

DK_FLASH_BWD_ENTRY(dk_flash_bwd_fused, kFused)
DK_FLASH_BWD_ENTRY(dk_flash_bwd_dkv, kDkv)
DK_FLASH_BWD_ENTRY(dk_flash_bwd_dq, kDq)

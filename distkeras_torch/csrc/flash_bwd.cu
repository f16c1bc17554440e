// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas TPU backward kernels of
// distkeras_tpu/ops/flash_attention.py:
//   dk_flash_bwd_fused -> _bwd_fused_kernel (launched by _fused_backward_call)
//   dk_flash_bwd_dq    -> _bwd_dq_kernel    (the split tier, launched by _backward)
//   dk_flash_bwd_dkv   -> _bwd_dkv_kernel   (the split tier, launched by _backward)
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
// flash_bwd_dkv_kernel (B3b) runs on mma.sync m16n8k16 (flash_mma.cuh),
// with tiles in XOR-swizzled shared memory that ldmatrix reads without
// bank conflicts and that cp.async fills (zeros past a tensor's end): one
// block per (batch, head, 128 keys), eight warps, each owning 16 key rows
// and the f32 dK and dV accumulators of those rows in registers.  K and V
// stay in shared memory for the whole block (at D = 128 their fragments
// next to both accumulators would pass the 255 registers a thread may
// hold; ldmatrix reads them back per k-step).  The block streams 64-row
// tiles of q and dO, with their lse and delta, double-buffered with
// cp.async, skipping the q rows that see none of its keys, and for each
// tile, in two halves of 32 q rows, runs the products in key-major
// orientation: S^T = K Q^T, dP^T = V dO^T, dV += bf16(P^T) dO,
// dK += bf16(dS^T) Q.  Block y = 0 launches first.
//
// flash_bwd_dq_kernel (B3a) is q-major: one block per (batch, head, 64 q
// rows), four warps, each owning 16 q rows whose Q and dO fragments it
// loads into registers once and whose f32 dQ accumulator it keeps there.
// K and V move in 64-key tiles, double-buffered with cp.async, up to the
// last key any row of the block can see; per tile, in two halves of 32
// keys (registers: at D = 128 the Q and dO fragments and the accumulator
// take 128 of them), S = Q K^T and dP = dO V^T (K and V as the col-major B
// operand), ds on the f32 fragments, bf16(dS) re-packed in registers as
// the A operand of dQ += bf16(dS) K (K read k-major by ldmatrix.trans).
// Only tiles that straddle the diagonal or a ragged end are masked.  dQ is
// scaled and written once, by its block.  Blocks are numbered so that the
// longest causal rows (the last q tiles) start first.
// Neither split kernel uses atomics: the split tier is bitwise
// reproducible.
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
// ~118 MB: operations-bound on the tensor cores (~0.087 ms); B3a does 6 * D
// (~0.052 ms), B3b 8 * D (~0.069 ms).  B2's five products per tile are
// short (64 x 64 scores) with the softmax terms, the dS staging and the dQ
// reduce between them; B3a and B3b are on mma.sync, which reaches a part of
// the rate only.  PERF.md records the times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_mma.cuh"
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

// ---------------------------------------------------- B3b: bf16, key-major mma

using namespace flash_mma;

constexpr int kMmaWarps = 8;
constexpr int kMmaKeys = 16 * kMmaWarps;  // keys per block, 16 per warp
constexpr int kMmaQ = 64;                 // q rows per streamed tile
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
struct MmaSmem {  // byte offsets into the block's dynamic shared memory
  static constexpr uint32_t kTileQ = kMmaQ * D * sizeof(bf16);
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + kMmaKeys * D * sizeof(bf16);
  static constexpr uint32_t Q = V + kMmaKeys * D * sizeof(bf16);  // two tiles
  static constexpr uint32_t dO = Q + 2 * kTileQ;                   // two tiles
  static constexpr uint32_t stats = dO + 2 * kTileQ;
  static constexpr uint32_t bytes = stats + 4 * kMmaQ * sizeof(float);  // lse[2], delta[2]
};

// dK and dV of the block's 128 keys: the body of B3b (flash_bwd_dkv_kernel)
template <int D>
__device__ __forceinline__ void kv_mma_tile(const bf16* __restrict__ q,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const bf16* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta, bf16* __restrict__ dk,
                                            bf16* __restrict__ dv, const Strides& st, int H,
                                            int Lq, int Lk, int causal, int q_offset,
                                            int k_offset, float scale) {
  using Sw = Swizzle<D>;
  using L = MmaSmem<D>;
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int NO = D / 8;   // n-blocks of a [16, D] accumulator
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const float* stats = reinterpret_cast<const float*>(smem + L::stats);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kMmaKeys;
  const int krow = warp * 16;  // the warp's first key row in the block

  // q rows before the first one that sees key k0 contribute nothing
  int q_begin = 0;
  if (causal) q_begin = max(0, min(Lq, k_offset + k0 - q_offset));
  const int n_qt = (Lq - q_begin + kMmaQ - 1) / kMmaQ;
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* ob = dout + b * st.ob + h * st.oh;
  const long long stat0 = ((long long)b * H + h) * Lq;

  auto load_q_tile = [&](int it) {
    const int q0 = q_begin + it * kMmaQ;
    const int n = min(kMmaQ, Lq - q0);
    const uint32_t buf = it & 1;
    load_tile_async<D, kMmaQ, kMmaThreads>(base + L::Q + buf * L::kTileQ, qb + q0 * st.ql,
                                           st.ql, n, tid);
    load_tile_async<D, kMmaQ, kMmaThreads>(base + L::dO + buf * L::kTileQ, ob + q0 * st.ol,
                                           st.ol, n, tid);
    if (tid < 2 * kMmaQ) {
      const int i = tid % kMmaQ;
      const bool ok = i < n;
      const float* src = (tid < kMmaQ ? lse : delta) + stat0 + q0 + (ok ? i : 0);
      const uint32_t slot = (tid < kMmaQ ? buf : 2 + buf) * kMmaQ + i;
      cp_async4(base + L::stats + slot * 4, src, ok ? 4 : 0);
    }
  };

  {
    const int nk = min(kMmaKeys, Lk - k0);
    load_tile_async<D, kMmaKeys, kMmaThreads>(base + L::K, k + b * st.kb + h * st.kh + k0 * st.kl,
                                              st.kl, nk, tid);
    load_tile_async<D, kMmaKeys, kMmaThreads>(base + L::V, v + b * st.vb + h * st.vh + k0 * st.vl,
                                              st.vl, nk, tid);
    if (n_qt > 0) load_q_tile(0);
    cp_async_commit();
  }

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  for (int it = 0; it < n_qt; ++it) {
    const int q0 = q_begin + it * kMmaQ;
    if (it + 1 < n_qt) load_q_tile(it + 1);  // streams in under this tile
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t cQ = base + L::Q + (it & 1) * L::kTileQ;
    const uint32_t cO = base + L::dO + (it & 1) * L::kTileQ;
    const float* lse_s = stats + (it & 1) * kMmaQ;
    const float* delta_s = stats + (2 + (it & 1)) * kMmaQ;
    const bool edge = q0 + kMmaQ > Lq || k0 + kMmaKeys > Lk ||
                      (causal && q_offset + q0 < k_offset + k0 + kMmaKeys - 1);

#pragma unroll 1
    for (int hq = 0; hq < 2; ++hq) {  // q columns hq * 32 .. hq * 32 + 31
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 q rows
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, base + L::K + Sw::chunk(krow + (lane & 15), 2 * kk + (lane >> 4)));
        ldmatrix_x4(va, base + L::V + Sw::chunk(krow + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t off = Sw::chunk(hq * 32 + p * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         2 * kk + ((lane >> 3) & 1));
          uint32_t bq[4], bo[4];
          ldmatrix_x4(bq, cQ + off);
          mma_bf16(s[2 * p], ka, bq[0], bq[1]);
          mma_bf16(s[2 * p + 1], ka, bq[2], bq[3]);
          ldmatrix_x4(bo, cO + off);
          mma_bf16(dp[2 * p], va, bo[0], bo[1]);
          mma_bf16(dp[2 * p + 1], va, bo[2], bo[3]);
        }
      }

      // p and ds; element (j, e) is key krow + g + 8 (e / 2), q column
      // hq * 32 + 8 j + 2 t + e % 2.  bf16(P^T), bf16(dS^T) become A
      // fragments (two k-steps of 16 q).
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = hq * 32 + j * 8 + 2 * t;
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qc + (e & 1);
          float pe = exp_approx(s[j][e] * scale - lse_s[col]);
          if (edge) {
            const int kj = k0 + krow + g + 8 * (e >> 1);
            const int qi = q0 + col;
            if (kj >= Lk || qi >= Lq || (causal && q_offset + qi < k_offset + kj)) pe = 0.f;
          }
          pv[e] = pe;
          dsv[e] = pe * (dp[j][e] - delta_s[col]);
        }
        const int ks = j >> 1, hi = 2 * (j & 1);
        pa[ks][hi] = pack_bf16(pv[0], pv[1]);
        pa[ks][hi + 1] = pack_bf16(pv[2], pv[3]);
        da[ks][hi] = pack_bf16(dsv[0], dsv[1]);
        da[ks][hi + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q over these 32 q rows
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int r = hq * 32 + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          const uint32_t off = Sw::chunk(r, 2 * jp + (lane >> 4));
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, cO + off);
          mma_bf16(dva[2 * jp], pa[ks], bo[0], bo[1]);
          mma_bf16(dva[2 * jp + 1], pa[ks], bo[2], bo[3]);
          ldmatrix_x4_trans(bq, cQ + off);
          mma_bf16(dka[2 * jp], da[ks], bq[0], bq[1]);
          mma_bf16(dka[2 * jp + 1], da[ks], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this q tile (its buffer is free for it + 2)
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + krow + g + 8 * r;
    if (kj >= Lk) continue;
    const long long row = (((long long)b * Lk + kj) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(dk + row + j * 8) =
          pack_bf16(dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + j * 8) = pack_bf16(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

#define DK_KV_MMA_PARAMS                                                                  \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,     \
      const bf16 *__restrict__ dout, const float *__restrict__ lse,                        \
      const float *__restrict__ delta, float *__restrict__ dq_acc, bf16 *__restrict__ dk,  \
      bf16 *__restrict__ dv, Strides st, int H, int Lq, int Lk, int causal, int q_offset,  \
      int k_offset, float scale

// B3b: dK and dV only (the split tier's second kernel)
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkv_kernel(DK_KV_MMA_PARAMS) {
  kv_mma_tile<D>(q, k, v, dout, lse, delta, dk, dv, st, H, Lq, Lk, causal, q_offset, k_offset,
                 scale);
}

template <int D>
cudaError_t launch_dkv_mma(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<D>;
  const size_t smem = MmaSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Lk + kMmaKeys - 1) / kMmaKeys);
  kernel<<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.st,
      a.H, a.Lq, a.Lk, a.causal, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

// ---------------------------------------------------- B3a: bf16, q-major mma

constexpr int kDqRows = 64;  // q rows per block, 16 per warp
constexpr int kDqKeys = 64;  // keys per K / V tile
constexpr int kDqWarps = 4;
constexpr int kDqThreads = 32 * kDqWarps;

template <int D>
struct DqSmem {  // byte offsets into the block's dynamic shared memory
  static constexpr uint32_t kTileK = kDqKeys * D * sizeof(bf16);
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t dO = Q + kDqRows * D * sizeof(bf16);
  static constexpr uint32_t K = dO + kDqRows * D * sizeof(bf16);  // two tiles
  static constexpr uint32_t V = K + 2 * kTileK;                   // two tiles
  static constexpr uint32_t bytes = V + 2 * kTileK;
};

template <int D>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, Strides st, int H, int Lq, int Lk, int causal,
                    int q_offset, int k_offset, float scale) {
  using Sw = Swizzle<D>;
  using L = DqSmem<D>;
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int NO = D / 8;   // n-blocks of the [16, D] dQ accumulator
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // longest rows first
  const int nq = min(kDqRows, Lq - q0);

  // keys past the block's last visible position are never loaded
  int k_end = Lk;
  if (causal) k_end = max(0, min(Lk, q_offset + q0 + nq - 1 - k_offset + 1));
  const int n_tiles = (k_end + kDqKeys - 1) / kDqKeys;

  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  auto load_kv_tile = [&](int tile) {
    const int k0 = tile * kDqKeys;
    const int n = min(kDqKeys, Lk - k0);
    const uint32_t buf = (tile & 1) * L::kTileK;
    load_tile_async<D, kDqKeys, kDqThreads>(base + L::K + buf, kb + k0 * st.kl, st.kl, n, tid);
    load_tile_async<D, kDqKeys, kDqThreads>(base + L::V + buf, vb + k0 * st.vl, st.vl, n, tid);
  };
  load_tile_async<D, kDqRows, kDqThreads>(base + L::Q, q + b * st.qb + h * st.qh + q0 * st.ql,
                                          st.ql, nq, tid);
  load_tile_async<D, kDqRows, kDqThreads>(base + L::dO,
                                          dout + b * st.ob + h * st.oh + q0 * st.ol, st.ol, nq,
                                          tid);
  if (n_tiles > 0) load_kv_tile(0);
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: lse (times log2 e, for ex2) and delta
  const int row0 = warp * 16 + g;
  const long long stat0 = ((long long)b * H + h) * Lq + q0;
  const float scale_l2 = scale * kLog2e;
  float lse_l2[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    lse_l2[r] = i < nq ? lse[stat0 + i] * kLog2e : 0.f;
    delta_r[r] = i < nq ? delta[stat0 + i] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  uint32_t qf[KS][4], of[KS][4];
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kDqKeys;
    cp_async_wait<0>();
    __syncthreads();  // this tile is in, and every warp is done with the last one
    if (tile + 1 < n_tiles) load_kv_tile(tile + 1);  // streams in under this tile
    cp_async_commit();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = Sw::chunk(warp * 16 + (lane & 15), 2 * kk + (lane >> 4));
        ldmatrix_x4(qf[kk], base + L::Q + off);
        ldmatrix_x4(of[kk], base + L::dO + off);
      }
    }
    const uint32_t cK = base + L::K + (tile & 1) * L::kTileK;
    const uint32_t cV = base + L::V + (tile & 1) * L::kTileK;
    const bool edge = k0 + kDqKeys > Lk || q0 + kDqRows > Lq ||
                      (causal && q_offset + q0 < k_offset + k0 + kDqKeys - 1);

#pragma unroll 1
    for (int hk = 0; hk < 2; ++hk) {  // keys hk * 32 .. hk * 32 + 31 of the tile
      // S = Q K^T and dP = dO V^T: the warp's 16 q rows x 32 keys
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t off = Sw::chunk(hk * 32 + p * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         2 * kk + ((lane >> 3) & 1));
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, cK + off);
          mma_bf16(s[2 * p], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * p + 1], qf[kk], bk[2], bk[3]);
          ldmatrix_x4(bv, cV + off);
          mma_bf16(dp[2 * p], of[kk], bv[0], bv[1]);
          mma_bf16(dp[2 * p + 1], of[kk], bv[2], bv[3]);
        }
      }

      // ds; element (j, e) is q row row0 + 8 (e / 2), key hk * 32 + 8 j +
      // 2 t + e % 2 of the tile.  bf16(dS) becomes the A fragments of two
      // k-steps of 16 keys.
      uint32_t da[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pe = exp2_approx(fmaf(s[j][e], scale_l2, -lse_l2[r]));
          if (edge) {
            const int kj = k0 + hk * 32 + j * 8 + 2 * t + (e & 1);
            const int qi = q0 + row0 + 8 * r;
            if (kj >= Lk || qi >= Lq || (causal && q_offset + qi < k_offset + kj)) pe = 0.f;
          }
          dsv[e] = pe * (dp[j][e] - delta_r[r]);
        }
        const int ks = j >> 1, hi = 2 * (j & 1);
        da[ks][hi] = pack_bf16(dsv[0], dsv[1]);
        da[ks][hi + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dQ += bf16(dS) K over these 32 keys
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int r = hk * 32 + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, cK + Sw::chunk(r, 2 * jp + (lane >> 4)));
          mma_bf16(acc[2 * jp], da[ks], bk[0], bk[1]);
          mma_bf16(acc[2 * jp + 1], da[ks], bk[2], bk[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= Lq) continue;
    bf16* row = dq + (((long long)b * Lq + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <int D>
cudaError_t launch_dq_mma(const Args& a) {
  const size_t smem = DqSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Lq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_kernel<D><<<grid, kDqThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dq), a.st, a.H, a.Lq, a.Lk, a.causal, a.q_offset, a.k_offset,
      a.scale);
  return cudaGetLastError();
}

// ------------------------------------------------ B2: bf16, wgmma + TMA

namespace hp = hopper;

constexpr int kB2Keys = 128;      // keys per block, 64 per consumer warpgroup
constexpr int kB2Q = 64;          // q rows per streamed tile
constexpr int kB2Stages = 2;      // q / dO tiles in flight
constexpr int kB2Threads = 384;   // two consumer warpgroups, then the producer's

template <int D>
struct B2Smem {  // byte offsets from the 1024-aligned base
  static constexpr int kCols = hp::box_cols<bf16>(D);  // columns in a box
  static constexpr int R = kCols * 2;                  // bytes of a box row
  static constexpr int kBoxes = D / kCols;
  static constexpr int kFCols = hp::box_cols<float>(D);  // f32 columns in a dQ box
  static constexpr uint32_t kKBox = kB2Keys * R;
  static constexpr uint32_t kQBox = kB2Q * R;
  static constexpr uint32_t kQTile = kB2Q * D * 2;     // one q (or dO) tile
  static constexpr uint32_t kDsTile = kB2Keys * kB2Q * 2;  // dS^T: [keys][64 q] bf16
  static constexpr uint32_t kFBox = kB2Q * 128;        // one f32 dQ box: 64 rows x 128 B
  static constexpr uint32_t kDqStage = kB2Q * kCols * 4;  // a warpgroup's dQ partial
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + kB2Keys * D * 2;
  static constexpr uint32_t Q = V + kB2Keys * D * 2;   // kB2Stages tiles
  static constexpr uint32_t dO = Q + kB2Stages * kQTile;  // kB2Stages tiles
  static constexpr uint32_t dS = dO + kB2Stages * kQTile;  // two tiles
  static constexpr uint32_t dQ = dS + 2 * kDsTile;     // one stage per warpgroup
  static constexpr uint32_t stats = dQ + 2 * kDqStage;  // per stage: lse * log2 e [64], delta [64]
  static constexpr uint32_t bars = stats + kB2Stages * 2 * kB2Q * 4;  // kv_full, full[], empty[]
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kB2Stages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kB2Threads, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Lq, int Lk, int causal, int q_offset,
                       int k_offset, float scale) {
  using L = B2Smem<D>;
  constexpr int R = L::R;
  constexpr int KPB = R / 32;                 // k-steps of 16 columns in a box row
  constexpr int kDqGroups = D / L::kCols;     // warpgroups sharing dQ's columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - hp::smem_u32(smem_raw));  // generic, for stats
  const uint32_t kv_full = base + L::bars;
  auto full = [&](int s) { return base + L::bars + 8 * (1 + s); };
  auto empty = [&](int s) { return base + L::bars + 8 * (1 + kB2Stages + s); };
  auto stats = [&](int s) { return reinterpret_cast<float*>(gbase + L::stats) + s * 2 * kB2Q; };

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kB2Keys;
  // q rows before the first one that sees key k0 contribute nothing
  int q_begin = 0;
  if (causal) q_begin = max(0, min(Lq, k_offset + k0 - q_offset));
  const int n_qt = (Lq - q_begin + kB2Q - 1) / kB2Q;

  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
    for (int s = 0; s < kB2Stages; ++s) {
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
        hp::mbar_arrive_expect(kv_full, 2 * kB2Keys * D * 2);
        for (int n = 0; n < L::kBoxes; ++n) {
          hp::tma_load(base + L::K + n * L::kKBox, &tk, kv_full, n * L::kCols, h, k0, b);
          hp::tma_load(base + L::V + n * L::kKBox, &tv, kv_full, n * L::kCols, h, k0, b);
        }
      }
      const long long stat0 = ((long long)b * H + h) * Lq;
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % kB2Stages;
        const int q0 = q_begin + it * kB2Q;
        hp::mbar_wait(empty(s), ((it / kB2Stages) & 1) ^ 1);
        float* st = stats(s);
        for (int i = lane; i < kB2Q; i += 32) {
          const bool ok = q0 + i < Lq;
          st[i] = ok ? lse[stat0 + q0 + i] * hp::kLog2e : 0.f;
          st[kB2Q + i] = ok ? delta[stat0 + q0 + i] : 0.f;
        }
        if (lane == 0) {
          hp::mbar_arrive_expect(full(s), 2 * L::kQTile);
          for (int n = 0; n < L::kBoxes; ++n) {
            hp::tma_load(base + L::Q + s * L::kQTile + n * L::kQBox, &tq, full(s),
                         n * L::kCols, h, q0, b);
            hp::tma_load(base + L::dO + s * L::kQTile + n * L::kQBox, &tdo, full(s),
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
    const bool with_dq = wg < kDqGroups;
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
      const int s = it % kB2Stages;
      const int q0 = q_begin + it * kB2Q;
      const uint32_t sQ = base + L::Q + s * L::kQTile;
      const uint32_t sO = base + L::dO + s * L::kQTile;
      const uint32_t sDs = base + L::dS + (it & 1) * L::kDsTile;
      hp::mbar_wait(full(s), (it / kB2Stages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: the warpgroup's 64 keys x 64 q rows.
      // st later holds the dQ partial (its first k-step overwrites), so that
      // no third accumulator is live
      float st[kB2Q / 2], dpt[kB2Q / 2];
#pragma unroll
      for (int i = 0; i < kB2Q / 2; ++i) st[i] = dpt[i] = 0.f;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = (kk / KPB) * L::kKBox + (kk % KPB) * 32;
        const uint32_t qa = (kk / KPB) * L::kQBox + (kk % KPB) * 32;
        hp::Wgmma<kB2Q>::ss<0, 0>(st, hp::desc<R>(sK + ka, L::kKBox),
                                  hp::desc<R>(sQ + qa, L::kQBox), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = (kk / KPB) * L::kKBox + (kk % KPB) * 32;
        const uint32_t qa = (kk / KPB) * L::kQBox + (kk % KPB) * 32;
        hp::Wgmma<kB2Q>::ss<0, 0>(dpt, hp::desc<R>(sV + ka, L::kKBox),
                                  hp::desc<R>(sO + qa, L::kQBox), kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(st);
      hp::fence_regs(dpt);

      // p and ds; element i is key krow + 8 ((i / 2) % 2), q column
      // 8 (i / 4) + 2 c + i % 2 of the tile
      const float* lse_s = stats(s);
      const float* delta_s = lse_s + kB2Q;
      const bool edge = q0 + kB2Q > Lq || k0w + 64 > Lk ||
                        (causal && q_offset + q0 < k_offset + k0w + 63);
#pragma unroll
      for (int i = 0; i < kB2Q / 2; ++i) {
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
      // dS^T also into shared memory, rows = the block's keys
      uint32_t pa[kB2Q / 16][4], da[kB2Q / 16][4];
#pragma unroll
      for (int kk = 0; kk < kB2Q / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: row half r % 2, q block 2 kk + r / 2
          const int i = 8 * kk + 4 * (r >> 1) + 2 * (r & 1);
          pa[kk][r] = hp::pack_bf16(st[i], st[i + 1]);
          da[kk][r] = hp::pack_bf16(dpt[i], dpt[i + 1]);
          hp::st_shared(sDs + hp::swizzled<128>(krow + 8 * (r & 1), 2 * kk + (r >> 1)) + 4 * c,
                        da[kk][r]);
        }
      }

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: dO and Q read MN-major
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kB2Q / 16; ++kk) {
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

      // dS^T of all 128 keys is in shared memory
      hp::fence_async_shared();
      hp::named_sync(1, 256);
      float (&dq)[L::kCols / 2] = *reinterpret_cast<float(*)[L::kCols / 2]>(&st);
      if (with_dq) {
        // dQ partial = bf16(dS) K over the block's keys, this warpgroup's
        // box of columns: dS^T and K both read MN-major
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kB2Keys / 16; ++kk)
          hp::Wgmma<L::kCols>::template ss<1, 1>(
              dq, hp::desc<128>(sDs + kk * 16 * 128, L::kDsTile),
              hp::desc<R>(base + L::K + wg * L::kKBox + kk * 16 * R, L::kKBox), kk > 0);
        hp::wgmma_commit();
      }
      hp::wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < L::kBoxes; ++n) {
        hp::fence_regs(dka[n]);
        hp::fence_regs(dva[n]);
      }
      hp::fence_regs(dq);
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
            hp::tma_reduce_add(&tdq, stage + f * L::kFBox, wg * L::kCols + f * L::kFCols, h, q0,
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

template <int D>
cudaError_t launch_fused_tma(const Args& a) {
  const Strides& s = a.st;
  CUtensorMap tq, tk, tv, tdo, tdq;
  cudaError_t err = hp::make_map<bf16>(&tq, a.q, a.B, a.Lq, a.H, D, s.qb, s.ql, s.qh, kB2Q);
  if (err == cudaSuccess)
    err = hp::make_map<bf16>(&tk, a.k, a.B, a.Lk, a.H, D, s.kb, s.kl, s.kh, kB2Keys);
  if (err == cudaSuccess)
    err = hp::make_map<bf16>(&tv, a.v, a.B, a.Lk, a.H, D, s.vb, s.vl, s.vh, kB2Keys);
  if (err == cudaSuccess)
    err = hp::make_map<bf16>(&tdo, a.dout, a.B, a.Lq, a.H, D, s.ob, s.ol, s.oh, kB2Q);
  if (err == cudaSuccess)  // the f32 workspace, contiguous [B, Lq, H, D]
    err = hp::make_map<float>(&tdq, a.dq, a.B, a.Lq, a.H, D, (long long)a.Lq * a.H * D,
                              (long long)a.H * D, D, kB2Q);
  if (err != cudaSuccess) return err;
  const size_t smem = B2Smem<D>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_fused_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Lk + kB2Keys - 1) / kB2Keys);
  flash_bwd_fused_kernel<D><<<grid, kB2Threads, smem, a.stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.H, a.Lq, a.Lk, a.causal, a.q_offset, a.k_offset, a.scale);
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
      case kFused: return launch_fused_tma<D>(a);
      case kDkv: return launch_dkv_mma<D>(a);
      case kDq: return launch_dq_mma<D>(a);
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

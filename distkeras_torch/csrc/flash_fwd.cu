// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel distkeras_tpu/ops/flash_attention.py ::
// _fwd_kernel (launched from _forward).  Same function: causal / offset
// masking by global position, online softmax with f32 running max,
// denominator and accumulator, o written in the input dtype and the per-row
// logsumexp in f32; fully masked rows give o = 0 and lse = 0.  Inputs are
// read in the framework's [B, L, H, D] layout through strides (no transpose
// copy); the head dim must be contiguous and every row 16-byte aligned.
//
// Two kernels, one per input dtype:
//
// flash_fwd_kernel (bfloat16): the tensor cores, through mma.sync m16n8k16
// (flash_mma.cuh).  One block per (batch, head, 64 query rows), four warps,
// each warp owning 16 query rows whose Q fragments it loads into registers
// once with ldmatrix.  K and V move in tiles of 64 keys through dynamic
// shared memory, double-buffered with cp.async so that tile j + 1 loads
// while tile j computes, in an XOR-swizzled layout that ldmatrix reads
// without bank conflicts.  Per tile: S = Q K^T on the tensor cores (K read
// as the col-major B operand), times the f32 scale; the online-softmax
// update on the f32 fragments (row max over the four lanes of a quad);
// P = exp(S - m) stays in registers, where the C fragments of S re-pack as
// the A fragment of P V after rounding to bf16 -- the Pallas kernel's
// `p.astype(v.dtype)` -- while the row sum takes the unrounded f32 p; V is
// read with ldmatrix.trans.  Tiles wholly in the causal future are never
// loaded, and only tiles that straddle the diagonal (or the ragged end of
// q or k) are masked, by global position.  Blocks are numbered so that the
// longest causal rows (the last q tiles) start first.
//
// flash_fwd_f32_kernel (float32): CUDA-core FMAs, so that a float32 product
// is never rounded to TF32 (the JAX package's f32 path is full f32).  Four
// threads share a query row, each holding a quarter of the head dim; K and
// V tiles are staged in static shared memory.
//
// Bound.  Operations: 4 * D flops per visible score on the bf16 tensor
// cores (at [8, 2048, 4, 128] causal, 34.4 GFLOP: 0.035 ms at 989 TFLOP/s);
// at the scoring shape [8, 640, 8, 64] the bytes (~21 MB, 0.006 ms) bound
// it instead.  mma.sync reaches a part of the card's rate only (wgmma is
// the way to the rest); PERF.md records the times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash_mma;

// ---------------------------------------------------------------- bf16, mma

constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per K / V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(kBQ + 4 * kBK) * D * sizeof(bf16);  // Q, K[2], V[2]
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 long long qsb, long long qsl, long long qsh,
                 long long ksb, long long ksl, long long ksh,
                 long long vsb, long long vsl, long long vsh,
                 int H, int Lq, int Lk, int causal, int q_offset, int k_offset, float scale) {
  using Sw = Swizzle<D>;
  constexpr int KS = D / 16;       // k-steps of Q K^T over the head dim
  constexpr int NO = D / 8;        // n-blocks of the output
  constexpr int NS = kBK / 8;      // n-blocks of a score tile
  constexpr uint32_t kTileBytes = kBK * D * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK = sQ + kBQ * D * sizeof(bf16);  // two tiles
  const uint32_t sV = sK + 2 * kTileBytes;          // two tiles

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest rows first
  const int nq = min(kBQ, Lq - q0);

  // keys past the block's last visible position are never loaded
  int k_end = Lk;
  if (causal) k_end = max(0, min(Lk, q_offset + q0 + nq - 1 - k_offset + 1));
  const int n_tiles = (k_end + kBK - 1) / kBK;

  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  load_tile_async<D, kBQ, kThreads>(sQ, q + b * qsb + h * qsh + q0 * qsl, qsl, nq, tid);
  if (n_tiles > 0) {
    const int n = min(kBK, Lk);
    load_tile_async<D, kBK, kThreads>(sK, kb, ksl, n, tid);
    load_tile_async<D, kBK, kThreads>(sV, vb, vsl, n, tid);
  }
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: running max, partial row sum (this
  // lane's columns only; the quad's four partials add up at the end)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int row0 = warp * 16 + g;  // tile row of c0 / c1; c2 / c3 are row0 + 8
  const int q_pos0 = q_offset + q0 + row0;

  uint32_t qf[KS][4];
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    if (tile + 1 < n_tiles) {  // the next tile streams in under this one
      const uint32_t nxt = ((tile + 1) & 1) * kTileBytes;
      const int n = min(kBK, Lk - k0 - kBK);
      load_tile_async<D, kBK, kThreads>(sK + nxt, kb + (k0 + kBK) * ksl, ksl, n, tid);
      load_tile_async<D, kBK, kThreads>(sV + nxt, vb + (k0 + kBK) * vsl, vsl, n, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], sQ + Sw::chunk(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    }
    const uint32_t cK = sK + (tile & 1) * kTileBytes;
    const uint32_t cV = sV + (tile & 1) * kTileBytes;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int p = 0; p < NS / 2; ++p) {
        uint32_t bk[4];
        ldmatrix_x4(bk, cK + Sw::chunk(p * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s[2 * p], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * p + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, then mask where the tile straddles the diagonal or an end
    const bool edge = k0 + kBK > Lk || q0 + kBQ > Lq ||
                      (causal && q_offset + q0 < k_offset + k0 + kBK - 1);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int kj = k0 + j * 8 + 2 * t + (e & 1);
          const int qp = q_pos0 + (e >> 1) * 8;
          if (kj >= Lk || (causal && qp < k_offset + kj)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;  // a row that sees nothing yet
      corr[r] = exp_approx(m[r] - m_use[r]);           // 0 while m is -inf
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // P = exp(S - m) = 2^(S log2 e - m log2 e) in f32 for the row sum, bf16
    // for P V
    const float ml0 = m_use[0] * kLog2e, ml1 = m_use[1] * kLog2e;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sj = s[2 * kk + half];
        const float p0 = exp2_approx(fmaf(sj[0], kLog2e, -ml0));
        const float p1 = exp2_approx(fmaf(sj[1], kLog2e, -ml0));
        const float p2 = exp2_approx(fmaf(sj[2], kLog2e, -ml1));
        const float p3 = exp2_approx(fmaf(sj[3], kLog2e, -ml1));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[2 * half] = pack_bf16(p0, p1);
        pa[2 * half + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int jp = 0; jp < NO / 2; ++jp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, cV + Sw::chunk(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                             2 * jp + (lane >> 4)));
        mma_bf16(acc[2 * jp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * jp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this buffer is free for tile + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / denom;
    bf16* orow = o + (((long long)b * Lq + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    if (t == 0) lse[((long long)b * H + h) * Lq + qi] = (l[r] > 0.f) ? m[r] + logf(denom) : 0.f;
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        const long long* st, int B, int H, int Lq, int Lk, int causal,
                        int q_offset, int k_offset, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], H, Lq, Lk, causal, q_offset, k_offset, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------- float32, CUDA cores

constexpr int kLanesF32 = 4;  // threads per query row
constexpr int kThreadsF32 = kBQ * kLanesF32;

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse,
                     long long qsb, long long qsl, long long qsh,
                     long long ksb, long long ksl, long long ksh,
                     long long vsb, long long vsl, long long vsh,
                     int H, int Lq, int Lk, int causal, int q_offset, int k_offset,
                     float scale) {
  // K and V tiles together stay within 32 KB of static shared memory
  constexpr int BK = (2 * 64 * D * (int)sizeof(float) <= 32768) ? 64 : 32;
  constexpr int DS = D / kLanesF32;  // head-dim slice held by one thread
  static_assert(DS % 4 == 0, "a thread's head-dim slice is whole 16-byte vectors");
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int tid = threadIdx.x;
  const int row = tid / kLanesF32;
  const int part = tid % kLanesF32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = q0 + row;
  const bool row_valid = qi < Lq;
  const int q_pos = q_offset + qi;

  float qr[DS];
  float acc[DS];
  const float* qrow = q + b * qsb + (long long)min(qi, Lq - 1) * qsl + h * qsh + part * DS;
#pragma unroll
  for (int c = 0; c < DS; ++c) {
    qr[c] = qrow[c];
    acc[c] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  int k_end = Lk;
  if (causal) {
    const int last_q_pos = q_offset + min(q0 + kBQ, Lq) - 1;
    k_end = max(0, min(Lk, last_q_pos - k_offset + 1));
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * (D / 4); i += kThreadsF32) {
      const int j = i / (D / 4), d = (i % (D / 4)) * 4;
      const int kj = k0 + j;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kj < Lk) {
        kv = *reinterpret_cast<const float4*>(k + b * ksb + (long long)kj * ksl + h * ksh + d);
        vv = *reinterpret_cast<const float4*>(v + b * vsb + (long long)kj * vsl + h * vsh + d);
      }
      *reinterpret_cast<float4*>(&ks[j][d]) = kv;
      *reinterpret_cast<float4*>(&vs[j][d]) = vv;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DS; c += 4) {
        const float4 kf = *reinterpret_cast<const float4*>(&ks[j][part * DS + c]);
        dot += qr[c] * kf.x;
        dot += qr[c + 1] * kf.y;
        dot += qr[c + 2] * kf.z;
        dot += qr[c + 3] * kf.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kj = k0 + j;
      const bool visible = kj < Lk && (!causal || q_pos >= k_offset + kj);
      s[j] = visible ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {
      const float corr = (m == -INFINITY) ? 0.f : expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < DS; ++c) acc[c] *= corr;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int c = 0; c < DS; c += 4) {
          const float4 vf = *reinterpret_cast<const float4*>(&vs[j][part * DS + c]);
          acc[c] += p * vf.x;
          acc[c + 1] += p * vf.y;
          acc[c + 2] += p * vf.z;
          acc[c + 3] += p * vf.w;
        }
      }
      m = m_new;
    }
  }

  if (row_valid) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + (((long long)b * Lq + qi) * H + h) * D + part * DS;
#pragma unroll
    for (int c = 0; c < DS; ++c) orow[c] = acc[c] / denom;
    if (part == 0) {
      lse[((long long)b * H + h) * Lq + qi] = (l > 0.f) ? m + logf(denom) : 0.f;
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       const long long* st, int B, int H, int Lq, int Lk, int causal,
                       int q_offset, int k_offset, float scale, cudaStream_t stream) {
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, kThreadsF32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], H, Lq, Lk, causal, q_offset,
      k_offset, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                   const long long* st, int B, int H, int Lq, int Lk, int causal, int q_offset,
                   int k_offset, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset, scale,
                         stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset,
                          scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* dk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
extern "C" int dk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, long long qsb, long long qsl, long long qsh,
                            long long ksb, long long ksl, long long ksh,
                            long long vsb, long long vsl, long long vsh,
                            int B, int H, int Lq, int Lk, int D, int dtype,
                            int causal, int q_offset, int k_offset, float scale,
                            void* stream) {
  const long long st[9] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(dtype, q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset, scale, s); break;
    case 64: err = launch<64>(dtype, q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset, scale, s); break;
    case 128: err = launch<128>(dtype, q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

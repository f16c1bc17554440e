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
// flash_fwd_kernel (bfloat16): warpgroup MMA (wgmma) fed by the Tensor
// Memory Accelerator (TMA), through hopper.cuh.  One block per (batch,
// head, 128 query rows), three warpgroups:
//   - a producer warp (the third warpgroup, its registers given back with
//     setmaxnreg) loads the block's Q tile once, then keeps 128-key tiles of
//     K and V in flight through a ring of three stages in shared memory; each
//     stage fills by TMA and completes on its "full" mbarrier, and is
//     refilled once both consumers have arrived on its "empty" one.  TMA
//     reads the strided [B, L, H, D] operand through a 4-D map (D, H, L, B),
//     zero-fills rows past L, and writes the 128-byte swizzle (a row of
//     D = 128 as two boxes of 64 columns) that wgmma reads without bank
//     conflicts;
//   - two consumer warpgroups, 64 query rows each (registers raised with
//     setmaxnreg), run per tile S = Q K^T as wgmma m64n128k16 from shared
//     memory (both operands K-major), the online softmax on the f32
//     accumulator fragments (row max over the four lanes of a quad), and
//     O += P V as wgmma m64nNk16 with P in registers -- the accumulators of
//     S, rounded to bf16 (the Pallas kernel's `p.astype(v.dtype)`), re-pack
//     as the A operand, while the row sum takes the unrounded f32 p -- and V
//     read MN-major by the instruction's transpose flag.  The tiles are
//     software-pipelined: tile t + 1's S = Q K^T is issued with tile t's
//     P V, and its softmax runs while P V is on the tensor cores; and the
//     two consumers take turns issuing (two named barriers), so that one's
//     softmax runs under the other's products.
// Tiles wholly in the causal future are never loaded, and only tiles that
// straddle the diagonal (or the ragged end of k) are masked, by global
// position.  Blocks are numbered so that the longest causal rows (the last
// q tiles) start first.
//
// flash_fwd_f32_kernel (float32): CUDA-core FMAs, so that a float32 product
// is never rounded to TF32 (the JAX package's f32 path is full f32).  Four
// threads share a query row, each holding a quarter of the head dim; K and
// V tiles are staged in static shared memory.
//
// Bound.  Operations: 4 * D flops per visible score on the bf16 tensor
// cores (at [8, 2048, 4, 128] causal, 34.4 GFLOP: 0.035 ms at 989 TFLOP/s);
// at the scoring shape [8, 640, 8, 64] the bytes (~21 MB, 0.006 ms) bound
// it instead.  What stands between the kernel and that bound: the causal
// diagonal tile (half of it masked, wholly so for the first consumer's
// rows; computing the live half alone needs a second instruction shape on
// a runtime path, and ptxas then serializes every wgmma of the kernel),
// the softmax between the two products of a warpgroup, and a block per SM
// (224 KB of shared memory at D = 128), whose prologue (barriers, Q and the
// first tile) and epilogue nothing overlaps.  PERF.md records the times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// ------------------------------------------------------ bf16, wgmma + TMA

constexpr int kBQ = 128;      // query rows per block, 64 per consumer warpgroup
constexpr int kBK = 128;      // keys per K / V tile
constexpr int kStages = 3;    // K / V tiles in flight
constexpr int kThreads = 384; // two consumer warpgroups, then the producer's

template <int D>
struct FwdSmem {  // byte offsets from the 1024-aligned base
  static constexpr int kCols = box_cols<bf16>(D);      // columns in a box
  static constexpr int R = kCols * 2;                  // bytes of a box row
  static constexpr int kBoxes = D / kCols;
  static constexpr uint32_t kQBox = kBQ * R;
  static constexpr uint32_t kKBox = kBK * R;
  static constexpr uint32_t kTile = kBK * D * 2;       // one K (or V) tile
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + kBQ * D * 2;       // kStages tiles
  static constexpr uint32_t V = K + kStages * kTile;   // kStages tiles
  static constexpr uint32_t bars = V + kStages * kTile;  // q_full, full[], empty[]
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Lq, int Lk, int causal, int q_offset,
                 int k_offset, float scale) {
  using L = FwdSmem<D>;
  constexpr int R = L::R;
  constexpr int KPB = R / 32;  // k-steps of 16 columns in a box row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::bars;
  auto full = [&](int s) { return base + L::bars + 8 * (1 + s); };
  auto empty = [&](int s) { return base + L::bars + 8 * (1 + kStages + s); };

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int nq = min(kBQ, Lq - q0);
  // keys past the block's last visible position are never loaded
  int k_end = Lk;
  if (causal) k_end = max(0, min(Lk, q_offset + q0 + nq - 1 - k_offset + 1));
  const int n_tiles = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_arrive_expect(q_full, kBQ * D * 2);
      for (int n = 0; n < L::kBoxes; ++n)
        tma_load(base + L::Q + n * L::kQBox, &tq, q_full, n * L::kCols, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect(full(s), 2 * L::kTile);
        for (int n = 0; n < L::kBoxes; ++n) {
          tma_load(base + L::K + s * L::kTile + n * L::kKBox, &tk, full(s), n * L::kCols, h,
                   t * kBK, b);
          tma_load(base + L::V + s * L::kTile + n * L::kKBox, &tv, full(s), n * L::kCols, h,
                   t * kBK, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int row0 = 64 * wg + 16 * warp + g;  // block row of d[4j], d[4j+1]; +8 for the others
    const int q_pos0 = q_offset + q0 + row0;

    // rows row0 and row0 + 8: running max of the scaled scores, partial row
    // sum (this lane's columns only; the quad's four partials add up at the end)
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[L::kBoxes][L::kCols / 2];
#pragma unroll
    for (int n = 0; n < L::kBoxes; ++n) {
#pragma unroll
      for (int i = 0; i < L::kCols / 2; ++i) acc[n][i] = 0.f;
    }
    const float scale_l2 = scale * kLog2e;

    // S = Q K^T of the tile in stage s: 64 rows x 128 keys, over the head dim
    // in k-steps of 16; issued and committed, not waited for
    auto issue_scores = [&](float (&sa)[kBK / 2], int s) {
      const uint32_t sK = base + L::K + s * L::kTile;
      const uint32_t q_rows = base + L::Q + 64 * wg * R;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t a = desc<R>(q_rows + (kk / KPB) * L::kQBox + (kk % KPB) * 32, L::kQBox);
        const uint64_t b = desc<R>(sK + (kk / KPB) * L::kKBox + (kk % KPB) * 32, L::kKBox);
        if (kk == 0)
          Wgmma<kBK>::ss0<0, 0>(sa, a, b);
        else
          Wgmma<kBK>::ss<0, 0>(sa, a, b, 1);
      }
      wgmma_commit();
    };
    // the online softmax on the scores of keys k0..k0 + 127: mask where the
    // tile straddles the diagonal or the end, update m and l, leave P =
    // exp(S scale - m) = 2^(S scale log2 e - m log2 e) in sa (f32, for the
    // row sum here and bf16 for P V) and the factor for the accumulator
    float corr[2];
    auto softmax = [&](float (&sa)[kBK / 2], int k0) {
      const bool edge = k0 + kBK > Lk ||
                        (causal && q_offset + q0 + 64 * wg < k_offset + k0 + kBK - 1);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        if (edge) {
          const int kj = k0 + 8 * (i / 4) + 2 * c + (i & 1);
          const int qp = q_pos0 + 8 * ((i >> 1) & 1);
          if (kj >= Lk || (causal && qp < k_offset + kj)) sa[i] = -INFINITY;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sa[i]);
      }
      float ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale);
        const float m_use = (m_new == -INFINITY) ? 0.f : m_new;  // a row that sees nothing yet
        corr[r] = exp2_approx((m[r] - m_use) * kLog2e);           // 0 while m is -inf
        ml[r] = m_use * kLog2e;
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float p = exp2_approx(fmaf(sa[i], scale_l2, -ml[(i >> 1) & 1]));
        l[(i >> 1) & 1] += p;
        sa[i] = p;
      }
    };
    // bf16(P) as the A operand of P V, one k-step per 16 keys
    uint32_t pa[kBK / 16][4];
    auto pack_p = [&](const float (&sa)[kBK / 2]) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const float* p0 = sa + 8 * kk;  // key block 2 kk, then 2 kk + 1
        pa[kk][0] = pack_bf16(p0[0], p0[1]);
        pa[kk][1] = pack_bf16(p0[2], p0[3]);
        pa[kk][2] = pack_bf16(p0[4], p0[5]);
        pa[kk][3] = pack_bf16(p0[6], p0[7]);
      }
    };

    // O += P V of the tile in stage s: V [keys, D] read MN-major, one box of
    // columns at a time; issued and committed, not waited for
    auto issue_pv = [&](int s) {
      const uint32_t sV = base + L::V + s * L::kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < L::kBoxes; ++n)
          Wgmma<L::kCols>::template rs<1>(
              acc[n], pa[kk], desc<R>(sV + n * L::kKBox + kk * 16 * R, L::kKBox), 1);
      }
      wgmma_commit();
    };
    // the two consumers take turns on the tensor cores (named barriers 1
    // and 2): turn k of the first follows turn k - 1 of the second, turn k
    // of the second follows turn k of the first, so one warpgroup's softmax
    // runs under the other's products
    auto turn_begin = [&](int k) {
      if (wg == 0) {
        if (k > 0) named_sync(1, 256);
      } else {
        named_sync(2, 256);
      }
    };
    auto turn_end = [&](int k) {
      if (wg == 0) named_arrive(2, 256);
      else if (k < n_tiles) named_arrive(1, 256);
    };
    // Software pipeline: while tile t's P V runs on the tensor cores, tile
    // t + 1's scores are in and its softmax runs on the CUDA cores.
    if (n_tiles > 0) {
      mbar_wait(q_full, 0);
      mbar_wait(full(0), 0);
      float s_acc[kBK / 2];
      turn_begin(0);
      issue_scores(s_acc, 0);
      turn_end(0);
      wgmma_wait<0>();
      fence_regs(s_acc);
      softmax(s_acc, 0);
      pack_p(s_acc);
      for (int t = 0; t + 1 < n_tiles; ++t) {
        const int s = t % kStages, s1 = (t + 1) % kStages;
        mbar_wait(full(s1), ((t + 1) / kStages) & 1);
        turn_begin(t + 1);
        issue_scores(s_acc, s1);
        issue_pv(s);
        turn_end(t + 1);
        wgmma_wait<1>();
        fence_regs(s_acc);
        softmax(s_acc, (t + 1) * kBK);
        wgmma_wait<0>();
#pragma unroll
        for (int n = 0; n < L::kBoxes; ++n) fence_regs(acc[n]);
        mbar_arrive(empty(s));  // this stage may refill
#pragma unroll
        for (int n = 0; n < L::kBoxes; ++n) {
#pragma unroll
          for (int i = 0; i < L::kCols / 2; ++i) acc[n][i] *= corr[(i >> 1) & 1];
        }
        pack_p(s_acc);
      }
      turn_begin(n_tiles);
      issue_pv((n_tiles - 1) % kStages);
      turn_end(n_tiles);
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < L::kBoxes; ++n) fence_regs(acc[n]);
    }

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
      bf16* orow = o + (((long long)b * Lq + qi) * H + h) * D + 2 * c;
#pragma unroll
      for (int n = 0; n < L::kBoxes; ++n) {
#pragma unroll
        for (int j = 0; j < L::kCols / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + n * L::kCols + 8 * j) =
              pack_bf16(acc[n][4 * j + 2 * r] * inv, acc[n][4 * j + 2 * r + 1] * inv);
      }
      if (c == 0) lse[((long long)b * H + h) * Lq + qi] = (l[r] > 0.f) ? m[r] + logf(denom) : 0.f;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        const long long* st, int B, int H, int Lq, int Lk, int causal,
                        int q_offset, int k_offset, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map<bf16>(&tq, q, B, Lq, H, D, st[0], st[1], st[2], kBQ);
  if (err == cudaSuccess) err = make_map<bf16>(&tk, k, B, Lk, H, D, st[3], st[4], st[5], kBK);
  if (err == cudaSuccess) err = make_map<bf16>(&tv, v, B, Lk, H, D, st[6], st[7], st[8], kBK);
  if (err != cudaSuccess) return err;
  const size_t smem = FwdSmem<D>::bytes;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, Lq, Lk, causal, q_offset,
      k_offset, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------- float32, CUDA cores

constexpr int kRowsF32 = 64;  // query rows per block
constexpr int kLanesF32 = 4;  // threads per query row
constexpr int kThreadsF32 = kRowsF32 * kLanesF32;

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
  const int q0 = blockIdx.x * kRowsF32;
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
    const int last_q_pos = q_offset + min(q0 + kRowsF32, Lq) - 1;
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
  dim3 grid((Lq + kRowsF32 - 1) / kRowsF32, H, B);
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
